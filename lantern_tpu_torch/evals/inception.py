"""FID Inception-V3 (pool3, 2048-d), the pinned FID backbone, as an
``nn.Module`` in NCHW.

Counterpart of ``lantern_tpu/evals/inception.py``.  The reference measures
FID through clean-fid, whose feature network is the TF
"inception-2015-12-05" graph; its standard PyTorch port is pytorch-fid's
``pt_inception-2015-12-05-6726825d.pth``: the torchvision Inception-V3
layout with the FID deltas (average pools with ``count_include_pad=False``,
and Mixed_7c's pool branch a MAX pool, for TF bug-compatibility).  This
module loads that canonical state dict; ``expected_state_dict_shapes()``
is the exact census of the tensors it reads (no weights ship in the
repository).

Input: float RGB in [0, 255], NHWC, 299 x 299 (``clean_resize`` applies
clean-fid's float bicubic); the network normalises to [-1, 1].
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import pinned_tensors, read_state_dict
from ..device import full_f32, resolve_device
from ..utils.image import resize

# ---------------------------------------------------------------------------
# architecture table: (qualified conv name, in_ch, out_ch, (kh, kw))
# ---------------------------------------------------------------------------


def _inception_a(name: str, inc: int, pool: int) -> List[Tuple[str, int, int, tuple]]:
    return [
        (f"{name}.branch1x1", inc, 64, (1, 1)),
        (f"{name}.branch5x5_1", inc, 48, (1, 1)),
        (f"{name}.branch5x5_2", 48, 64, (5, 5)),
        (f"{name}.branch3x3dbl_1", inc, 64, (1, 1)),
        (f"{name}.branch3x3dbl_2", 64, 96, (3, 3)),
        (f"{name}.branch3x3dbl_3", 96, 96, (3, 3)),
        (f"{name}.branch_pool", inc, pool, (1, 1)),
    ]


def _inception_b(name: str, inc: int):
    return [
        (f"{name}.branch3x3", inc, 384, (3, 3)),
        (f"{name}.branch3x3dbl_1", inc, 64, (1, 1)),
        (f"{name}.branch3x3dbl_2", 64, 96, (3, 3)),
        (f"{name}.branch3x3dbl_3", 96, 96, (3, 3)),
    ]


def _inception_c(name: str, inc: int, c7: int):
    return [
        (f"{name}.branch1x1", inc, 192, (1, 1)),
        (f"{name}.branch7x7_1", inc, c7, (1, 1)),
        (f"{name}.branch7x7_2", c7, c7, (1, 7)),
        (f"{name}.branch7x7_3", c7, 192, (7, 1)),
        (f"{name}.branch7x7dbl_1", inc, c7, (1, 1)),
        (f"{name}.branch7x7dbl_2", c7, c7, (7, 1)),
        (f"{name}.branch7x7dbl_3", c7, c7, (1, 7)),
        (f"{name}.branch7x7dbl_4", c7, c7, (7, 1)),
        (f"{name}.branch7x7dbl_5", c7, 192, (1, 7)),
        (f"{name}.branch_pool", inc, 192, (1, 1)),
    ]


def _inception_d(name: str, inc: int):
    return [
        (f"{name}.branch3x3_1", inc, 192, (1, 1)),
        (f"{name}.branch3x3_2", 192, 320, (3, 3)),
        (f"{name}.branch7x7x3_1", inc, 192, (1, 1)),
        (f"{name}.branch7x7x3_2", 192, 192, (1, 7)),
        (f"{name}.branch7x7x3_3", 192, 192, (7, 1)),
        (f"{name}.branch7x7x3_4", 192, 192, (3, 3)),
    ]


def _inception_e(name: str, inc: int):
    return [
        (f"{name}.branch1x1", inc, 320, (1, 1)),
        (f"{name}.branch3x3_1", inc, 384, (1, 1)),
        (f"{name}.branch3x3_2a", 384, 384, (1, 3)),
        (f"{name}.branch3x3_2b", 384, 384, (3, 1)),
        (f"{name}.branch3x3dbl_1", inc, 448, (1, 1)),
        (f"{name}.branch3x3dbl_2", 448, 384, (3, 3)),
        (f"{name}.branch3x3dbl_3a", 384, 384, (1, 3)),
        (f"{name}.branch3x3dbl_3b", 384, 384, (3, 1)),
        (f"{name}.branch_pool", inc, 192, (1, 1)),
    ]


def conv_table() -> List[Tuple[str, int, int, tuple]]:
    t = [
        ("Conv2d_1a_3x3", 3, 32, (3, 3)),
        ("Conv2d_2a_3x3", 32, 32, (3, 3)),
        ("Conv2d_2b_3x3", 32, 64, (3, 3)),
        ("Conv2d_3b_1x1", 64, 80, (1, 1)),
        ("Conv2d_4a_3x3", 80, 192, (3, 3)),
    ]
    t += _inception_a("Mixed_5b", 192, 32)
    t += _inception_a("Mixed_5c", 256, 64)
    t += _inception_a("Mixed_5d", 288, 64)
    t += _inception_b("Mixed_6a", 288)
    t += _inception_c("Mixed_6b", 768, 128)
    t += _inception_c("Mixed_6c", 768, 160)
    t += _inception_c("Mixed_6d", 768, 160)
    t += _inception_c("Mixed_6e", 768, 192)
    t += _inception_d("Mixed_7a", 768)
    t += _inception_e("Mixed_7b", 1280)
    t += _inception_e("Mixed_7c", 2048)
    return t


def expected_state_dict_shapes() -> Dict[str, tuple]:
    """Exact (name -> shape) census of the canonical pt_inception checkpoint
    tensors this network reads (``fc`` / ``AuxLogits`` are unused)."""
    out: Dict[str, tuple] = {}
    for name, ci, co, (kh, kw) in conv_table():
        out[f"{name}.conv.weight"] = (co, ci, kh, kw)
        for p in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.bn.{p}"] = (co,)
    return out


def random_state_dict(seed: int = 0, rng=None) -> Dict[str, np.ndarray]:
    """The canonical state dict with random weights, drawn as the JAX
    ``init_random_params`` draws them: He-scaled convs, unit BN scales,
    running variance 2 (tests and structural runs).  ``rng``: what draws
    the normals (numpy's ``normal(scale=, size=)``; default
    ``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    sd = {}
    for k, s in expected_state_dict_shapes().items():
        if k.endswith("conv.weight"):
            fan_in = s[1] * s[2] * s[3]
            sd[k] = rng.normal(scale=np.sqrt(2.0 / fan_in),
                               size=s).astype(np.float32)
        elif k.endswith("bn.weight"):
            sd[k] = np.ones(s, np.float32)
        elif k.endswith("running_var"):
            sd[k] = np.full(s, 2.0, np.float32)
        else:
            sd[k] = np.zeros(s, np.float32)
    return sd


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

BN_EPS = 1e-3


class ConvBN(nn.Module):
    """Conv (no bias) -> BatchNorm (running statistics, eps 1e-3) -> ReLU."""

    def __init__(self, cin: int, cout: int, k: tuple, stride: int = 1,
                 padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _pool(x, kind: str, stride: int = 1, pad: int = 1):
    """3x3 pooling; average with ``count_include_pad=False``."""
    if kind == "max":
        return F.max_pool2d(x, 3, stride, pad)
    return F.avg_pool2d(x, 3, stride, pad, count_include_pad=False)


# the stride-2 convs; they and the stem's unpadded 3x3s take no padding,
# every other conv keeps its size ("same" padding)
_STRIDE2 = ("Conv2d_1a_3x3", "Mixed_6a.branch3x3", "Mixed_6a.branch3x3dbl_3",
            "Mixed_7a.branch3x3_2", "Mixed_7a.branch7x7x3_4")
_UNPADDED = _STRIDE2 + ("Conv2d_2a_3x3", "Conv2d_4a_3x3")


class InceptionPool3(nn.Module):
    """``[N, 299, 299, 3]`` float RGB in [0, 255] -> ``[N, 2048]`` pool3
    features.  Submodules carry the canonical state-dict names
    (``Mixed_5b.branch1x1.conv.weight``, ...)."""

    def __init__(self):
        super().__init__()
        groups: Dict[str, nn.ModuleDict] = {}
        for name, ci, co, k in conv_table():
            stride = 2 if name in _STRIDE2 else 1
            pad = (0, 0) if name in _UNPADDED else ((k[0] - 1) // 2,
                                                    (k[1] - 1) // 2)
            layer = ConvBN(ci, co, k, stride, pad)
            if "." in name:
                block, branch = name.split(".")
                groups.setdefault(block, nn.ModuleDict())[branch] = layer
            else:
                self.add_module(name, layer)
        for block, mods in groups.items():
            self.add_module(block, mods)
        # the FID network's Mixed_7c pools by max (torchvision's by average)
        self.mixed_7c_pool = "max"
        self.eval()

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        """Load the canonical pt_inception (or torchvision inception_v3)
        tensors: every pinned tensor must be there at its pinned shape (a
        missing or misshapen one is a ``ValueError``); ``fc.``,
        ``AuxLogits.`` and any other extra keys are ignored."""
        sd = pinned_tensors(state_dict, expected_state_dict_shapes(),
                            "pt_inception")
        return super().load_state_dict(sd, strict=False, assign=assign)

    def _branches(self, n: str, x):
        m = getattr(self, n)
        kind = n[:7]
        if kind == "Mixed_5":
            b1 = m["branch1x1"](x)
            b5 = m["branch5x5_2"](m["branch5x5_1"](x))
            b3 = m["branch3x3dbl_3"](m["branch3x3dbl_2"](m["branch3x3dbl_1"](x)))
            return [b1, b5, b3, m["branch_pool"](_pool(x, "avg"))]
        if n == "Mixed_6a":
            b3 = m["branch3x3"](x)
            bd = m["branch3x3dbl_3"](m["branch3x3dbl_2"](m["branch3x3dbl_1"](x)))
            return [b3, bd, _pool(x, "max", 2, 0)]
        if kind == "Mixed_6":
            b7 = m["branch7x7_3"](m["branch7x7_2"](m["branch7x7_1"](x)))
            bd = x
            for i in range(1, 6):
                bd = m[f"branch7x7dbl_{i}"](bd)
            return [m["branch1x1"](x), b7, bd,
                    m["branch_pool"](_pool(x, "avg"))]
        if n == "Mixed_7a":
            b3 = m["branch3x3_2"](m["branch3x3_1"](x))
            b7 = x
            for i in range(1, 5):
                b7 = m[f"branch7x7x3_{i}"](b7)
            return [b3, b7, _pool(x, "max", 2, 0)]
        b3 = m["branch3x3_1"](x)
        b3 = torch.cat([m["branch3x3_2a"](b3), m["branch3x3_2b"](b3)], 1)
        bd = m["branch3x3dbl_2"](m["branch3x3dbl_1"](x))
        bd = torch.cat([m["branch3x3dbl_3a"](bd), m["branch3x3dbl_3b"](bd)], 1)
        pool = self.mixed_7c_pool if n == "Mixed_7c" else "avg"
        return [m["branch1x1"](x), b3, bd, m["branch_pool"](_pool(x, pool))]

    def pool3(self, images: torch.Tensor) -> torch.Tensor:
        """The network without ``forward``'s full-f32 guard (the chip
        smoke runs it under TF32 to show what the guard prevents)."""
        x = (images.to(torch.float32) - 127.5) / 127.5
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _pool(x, "max", 2, 0)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _pool(x, "max", 2, 0)
        for n in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                  "Mixed_6c", "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b",
                  "Mixed_7c"):
            x = torch.cat(self._branches(n, x), 1)
        return x.mean(dim=(2, 3))

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return self.pool3(images)


def clean_resize(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """clean-fid's "clean" resize: PIL's 'F'-mode bicubic per channel on
    float32 pixels, ``[..., H, W, 3]`` -> ``[..., size, size, 3]``."""
    return resize(images.to(torch.float32), (size, size), "bicubic")


class InceptionExtractor:
    """FID feature extractor on ``device`` (``None``: ``cuda``).
    ``weights``: the canonical pt_inception ``.pth`` or a same-key ``.npz``;
    ``None``: random weights (shape and self tests only)."""

    def __init__(self, weights: str | None = None, device=None):
        self.device = resolve_device(device)
        sd = (random_state_dict() if weights is None
              else read_state_dict(weights))
        self.net = InceptionPool3()
        self.net.load_state_dict(sd)
        self.net.to(self.device)

    def image_features(self, images, batch: int = 32) -> torch.Tensor:
        """uint8 / float ``[N, H, W, 3]`` -> f32 ``[N, 2048]`` on the
        extractor's device."""
        images = torch.as_tensor(images).to(self.device)
        out = [self.net(clean_resize(images[lo: lo + batch]))
               for lo in range(0, len(images), batch)]
        return torch.cat(out) if out else torch.zeros(
            (0, 2048), device=self.device)
