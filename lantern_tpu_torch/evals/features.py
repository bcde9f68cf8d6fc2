"""Image loading and pluggable feature extraction for the offline metrics.

Counterpart of ``lantern_tpu/evals/features.py``.  Images are read,
centre-cropped to the short edge and Lanczos-resized through
``utils/image.py`` (no PIL for PNG); features come back as f32 tensors on
the extractor's device.  Extractor kinds:

- ``fid_inception``: the pinned FID backbone (``evals/inception.py``);
- ``vgg16_jax``: the pinned precision / recall backbone (``evals/vgg.py``;
  the kind keeps the JAX package's name);
- ``clip_b32`` / ``hps_v21``: the pinned CLIP ViT-B/32 and the HPSv2.1
  ViT-H/14 (``evals/clip.py``);
- ``hf_clip``: a local HuggingFace ``CLIPModel`` directory, through
  ``transformers``;
- ``vgg16`` / ``inception``: torchvision's networks, through
  ``torchvision``;
- a precomputed ``.npz`` in place of an image directory (``features``,
  optional ``radii``).

The ``transformers`` and ``torchvision`` wrappers import their package on
first use and raise an ``ImportError`` where it is missing.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..utils.image import load_image


def natural_sort(paths: Sequence[str]) -> List[str]:
    def key(p):
        return [int(c) if c.isdigit() else c.lower()
                for c in re.split(r"([0-9]+)", p)]

    return sorted(paths, key=key)


def list_images(path: str, exts=("png", "jpg", "jpeg")) -> List[str]:
    if os.path.isfile(path):
        return [path]
    files: List[str] = []
    for e in exts:
        files += glob.glob(os.path.join(path, f"*.{e}"))
        files += glob.glob(os.path.join(path, "**", f"*.{e}"), recursive=True)
    return natural_sort(sorted(set(files)))


def load_images(paths: Sequence[str], resize: Optional[int] = None,
                device=None) -> torch.Tensor:
    """``load_image`` of each path, stacked: uint8 ``[N, s, s, 3]``."""
    return torch.stack([load_image(p, resize, device) for p in paths])


def _import(package: str, what: str):
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"{what} needs the {package.split('.')[0]} "
                          f"package, which is not installed") from e


class HFClipExtractor:
    """Features and similarities over a local HF ``CLIPModel`` directory on
    ``device`` (``None``: ``cuda``)."""

    def __init__(self, model_dir: str, device=None,
                 prepend: str = "A photo depicts "):
        tf = _import("transformers", "HFClipExtractor")
        self.device = resolve_device(device)
        self.model = tf.CLIPModel.from_pretrained(model_dir).eval().to(
            self.device)
        self.processor = tf.CLIPProcessor.from_pretrained(model_dir)
        self.prepend = prepend

    def image_features(self, images, batch: int = 64) -> torch.Tensor:
        images = np.asarray(torch.as_tensor(images).cpu())
        outs = []
        with torch.no_grad():
            for i in range(0, len(images), batch):
                inp = self.processor(images=list(images[i: i + batch]),
                                     return_tensors="pt").to(self.device)
                outs.append(self.model.get_image_features(**inp))
        return torch.cat(outs)

    def text_features(self, texts: Sequence[str], batch: int = 64
                      ) -> torch.Tensor:
        # the reference prepends "A photo depicts " (arXiv 2104.08718)
        texts = [self.prepend + t for t in texts]
        outs = []
        with torch.no_grad():
            for i in range(0, len(texts), batch):
                inp = self.processor(text=list(texts[i: i + batch]),
                                     return_tensors="pt", padding=True,
                                     truncation=True).to(self.device)
                outs.append(self.model.get_text_features(**inp))
        return torch.cat(outs)


class TorchvisionExtractor:
    """torchvision's VGG16-fc2 (precision / recall) or InceptionV3-pool
    (FID) features on ``device`` (``None``: ``cuda``)."""

    def __init__(self, arch: str = "vgg16", device=None):
        tvm = _import("torchvision.models", "TorchvisionExtractor")
        self.device = resolve_device(device)
        if arch == "vgg16":
            vgg = tvm.vgg16(weights="IMAGENET1K_V1").eval()
            # fc2 features, as the reference's IPR: classifier[:4] = fc1 ->
            # ReLU -> Dropout -> fc2, no trailing ReLU
            self.net = torch.nn.Sequential(
                vgg.features, vgg.avgpool, torch.nn.Flatten(),
                *list(vgg.classifier.children())[:4]).to(self.device)
            self.size = 224
        elif arch == "inception":
            net = tvm.inception_v3(weights="IMAGENET1K_V1", aux_logits=True)
            net.fc = torch.nn.Identity()
            self.net = net.eval().to(self.device)
            self.size = 299
        else:
            raise ValueError(arch)

    def image_features(self, images, batch: int = 32) -> torch.Tensor:
        mean = torch.tensor([0.485, 0.456, 0.406], device=self.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=self.device)
        images = torch.as_tensor(images).to(self.device)
        outs = []
        with torch.no_grad():
            for i in range(0, len(images), batch):
                x = (images[i: i + batch].to(torch.float32) / 255.0 - mean) / std
                t = torch.nn.functional.interpolate(
                    x.permute(0, 3, 1, 2), size=(self.size, self.size),
                    mode="bilinear", align_corners=False)
                outs.append(self.net(t))
        return torch.cat(outs)


def load_npz_features(path: str):
    """``(features, radii or None)`` as numpy arrays."""
    with np.load(path) as z:
        feats = z["features"] if "features" in z.files else z[z.files[0]]
        radii = z["radii"] if "radii" in z.files else None
    return feats, radii


def extract_dir_features(image_dir: str, extractor,
                         resize: Optional[int] = None,
                         how_many: Optional[int] = None,
                         batch: int = 64) -> torch.Tensor:
    """Features of every image in a directory (on the extractor's device),
    or of a precomputed ``.npz`` (on the CPU)."""
    if image_dir.endswith(".npz"):
        feats = torch.from_numpy(load_npz_features(image_dir)[0])
        return feats[:how_many] if how_many is not None else feats
    paths = list_images(image_dir)
    if how_many is not None:
        paths = paths[:how_many]
    if not paths:
        raise FileNotFoundError(f"no images under {image_dir}")
    feats = []
    for i in range(0, len(paths), batch):
        imgs = load_images(paths[i: i + batch], resize=resize,
                           device=extractor.device)
        feats.append(extractor.image_features(imgs))
    return torch.cat(feats)


def make_extractor(kind: str, model_dir: Optional[str] = None, device=None):
    if kind == "hf_clip":
        if not model_dir:
            raise ValueError("hf_clip extractor needs --clip-model-dir")
        return HFClipExtractor(model_dir, device=device)
    if kind == "fid_inception":
        from .inception import InceptionExtractor

        return InceptionExtractor(weights=model_dir, device=device)
    if kind == "vgg16_jax":
        from .vgg import VGGExtractor

        return VGGExtractor(weights=model_dir, device=device)
    if kind == "clip_b32":
        from .clip import VIT_B32, CLIPExtractor

        return CLIPExtractor(weights=model_dir, geom=VIT_B32, device=device)
    if kind == "hps_v21":
        from .clip import VIT_H14, CLIPExtractor

        return CLIPExtractor(weights=model_dir, geom=VIT_H14, device=device)
    if kind in ("vgg16", "inception"):
        return TorchvisionExtractor(kind, device=device)
    raise ValueError(f"unknown extractor {kind}")
