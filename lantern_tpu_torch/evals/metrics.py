"""Image-quality metrics over feature sets, on the features' device.

Counterpart of ``lantern_tpu/evals/metrics.py`` (numpy there):

- **Frechet distance (FID)** between the Gaussian fits of two feature sets
  (mean and covariance on the device, scipy's ``sqrtm`` on the host, as in
  the JAX package);
- **improved precision / recall**: k-NN-radius manifolds (Kynkäänniemi et
  al. 2019) and the per-sample *realism* score;
- **CLIP-style scores**: the mean cosine similarity of paired embeddings,
  and HPSv2's scaled cosine per pair.

Features are torch tensors (or numpy arrays, taken to the CPU) and every
computation runs on their device in float64.  Distances use the same
expansion ``|x|^2 + |y|^2 - 2 x y^T`` as the JAX code, blocked to bound
memory at ``block**2`` values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float64)


class Manifold(NamedTuple):
    """A feature set plus each feature's k-NN radius (manifold estimate)."""

    features: torch.Tensor  # [N, D] float64
    radii: torch.Tensor  # [N] float64


# ---------------------------------------------------------------------------
# Frechet distance
# ---------------------------------------------------------------------------


def gaussian_stats(features):
    """Mean ``[D]`` and covariance ``[D, D]`` (rows are samples, ddof 1)."""
    feats = _f64(features)
    return feats.mean(dim=0), torch.atleast_2d(torch.cov(feats.T))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FD(N(mu1,S1), N(mu2,S2)) = |mu1-mu2|^2 + Tr(S1 + S2 - 2 (S1 S2)^1/2).

    The matrix square root is scipy's ``sqrtm`` on the host; if the product
    is near-singular, a small diagonal offset is added (the standard FID
    stabilisation)."""
    from scipy import linalg

    def host(a, nd):
        a = np.asarray(torch.as_tensor(a).to(torch.float64).cpu())
        return np.atleast_1d(a) if nd == 1 else np.atleast_2d(a)

    mu1, mu2 = host(mu1, 1), host(mu2, 1)
    sigma1, sigma2 = host(sigma1, 2), host(sigma2, 2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid_from_features(feats_a, feats_b) -> float:
    mu1, s1 = gaussian_stats(feats_a)
    mu2, s2 = gaussian_stats(feats_b)
    return frechet_distance(mu1, s1, mu2, s2)


# ---------------------------------------------------------------------------
# Improved precision / recall (k-NN manifolds)
# ---------------------------------------------------------------------------


def pairwise_distances(x, y=None, block: int = 2048) -> torch.Tensor:
    """Euclidean distance matrix ``[len(x), len(y)]``, blocked over rows."""
    x = _f64(x)
    y = x if y is None else _f64(y).to(x.device)
    y_sq = (y * y).sum(dim=1)
    out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float64,
                      device=x.device)
    for i in range(0, x.shape[0], block):
        xb = x[i: i + block]
        d2 = (xb * xb).sum(dim=1)[:, None] + y_sq[None, :] - 2.0 * xb @ y.T
        out[i: i + block] = torch.sqrt(torch.clamp(d2, min=0.0))
    return out


def knn_radii(features, k: int = 3, block: int = 2048) -> torch.Tensor:
    """Distance to each sample's k-th nearest *other* sample: the self
    distance 0 takes one slot, so it is the (k+1)-th order statistic of the
    full row (``np.partition(d, k)[:, k]`` in the JAX code)."""
    feats = _f64(features)
    n = feats.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < number of samples {n}")
    radii = torch.empty(n, dtype=torch.float64, device=feats.device)
    for i in range(0, n, block):
        d = pairwise_distances(feats[i: i + block], feats, block=block)
        radii[i: i + block] = torch.kthvalue(d, k + 1, dim=1).values
    return radii


def manifold(features, k: int = 3) -> Manifold:
    feats = _f64(features)
    return Manifold(feats, knn_radii(feats, k=k))


def manifold_coverage(ref: Manifold, feats_subject, block: int = 2048
                      ) -> float:
    """Fraction of subject features inside >= 1 reference k-NN ball:
    ``precision = coverage(manifold(real), fake)``, ``recall =
    coverage(manifold(fake), real)``."""
    feats = _f64(feats_subject).to(ref.features.device)
    hits = 0
    for i in range(0, feats.shape[0], block):
        d = pairwise_distances(ref.features, feats[i: i + block], block=block)
        hits += int((d < ref.radii[:, None]).any(dim=0).sum())
    return hits / max(1, feats.shape[0])


class PrecisionRecall(NamedTuple):
    precision: float
    recall: float


def precision_recall(ref_features, fake_features, k: int = 3
                     ) -> PrecisionRecall:
    ref_m = manifold(ref_features, k=k)
    fake_m = manifold(fake_features, k=k)
    return PrecisionRecall(
        precision=manifold_coverage(ref_m, fake_m.features),
        recall=manifold_coverage(fake_m, ref_m.features),
    )


def _median(x: torch.Tensor) -> torch.Tensor:
    """``np.median``: the mean of the two middle values of an even count
    (``torch.median`` returns the lower one)."""
    s, n = torch.sort(x).values, x.shape[0]
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


def realism(ref: Manifold, feat) -> float:
    """Max over reference samples of radius / distance, over the balls
    below the median radius (sparse-outlier balls ignored)."""
    feat = _f64(feat).to(ref.features.device).reshape(1, -1)
    dists = pairwise_distances(ref.features, feat)[:, 0]
    mask = ref.radii < _median(ref.radii)
    if not bool(mask.any()):
        # degenerate manifold (e.g. duplicate refs -> majority-zero radii):
        # fall back to all reference balls
        mask = torch.ones_like(mask)
    ratios = ref.radii[mask] / torch.clamp(dists[mask], min=1e-12)
    return float(ratios.max())


# ---------------------------------------------------------------------------
# CLIP-style scores
# ---------------------------------------------------------------------------


def _cosine(image_embs, text_embs) -> torch.Tensor:
    a, b = _f64(image_embs), _f64(text_embs)
    b = b.to(a.device)
    a = a / torch.linalg.norm(a, dim=1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=1, keepdim=True)
    return (a * b).sum(dim=1)


def clip_score_from_embeddings(image_embs, text_embs) -> float:
    """Mean cosine similarity of paired (image, text) embedding rows."""
    return float(_cosine(image_embs, text_embs).mean())


def hps_from_embeddings(image_embs, text_embs,
                        logit_scale: float = 100.0) -> torch.Tensor:
    """HPSv2's per-pair score: ``logit_scale * cos(img, txt)``."""
    return logit_scale * _cosine(image_embs, text_embs)

