"""VGG16 fc2 features, the pinned precision / recall backbone.

Counterpart of ``lantern_tpu/evals/vgg.py``.  The reference's improved
precision / recall runs torchvision VGG16 and takes ``classifier[:4]``'s
output (fc2, 4096-d, no ReLU after it) over 224 x 224 images, bilinear
resized and normalised with the ImageNet mean / std.  ``VGG16FC2`` carries
torchvision's module indices, so the canonical ``vgg16`` state dict loads
by name (``classifier.6`` is ignored); ``expected_state_dict_shapes()``
is the census of the tensors it reads.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import pinned_tensors, read_state_dict
from ..device import full_f32, resolve_device
from ..utils.image import resize

# torchvision vgg16 "features" channel plan; "M" = maxpool
_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512, "M"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def conv_layout():
    """[(state-dict index, in_ch, out_ch)] mirroring torchvision vgg16."""
    out, idx, cin = [], 0, 3
    for item in _PLAN:
        if item == "M":
            idx += 1
            continue
        out.append((idx, cin, item))
        cin = item
        idx += 2              # conv + relu
    return out


def expected_state_dict_shapes() -> Dict[str, tuple]:
    exp: Dict[str, tuple] = {}
    for idx, cin, cout in conv_layout():
        exp[f"features.{idx}.weight"] = (cout, cin, 3, 3)
        exp[f"features.{idx}.bias"] = (cout,)
    exp["classifier.0.weight"] = (4096, 512 * 7 * 7)
    exp["classifier.0.bias"] = (4096,)
    exp["classifier.3.weight"] = (4096, 4096)
    exp["classifier.3.bias"] = (4096,)
    return exp


def random_state_dict(seed: int = 0, rng=None) -> Dict[str, np.ndarray]:
    """The canonical state dict with He-scaled random weights and zero
    biases, drawn as the JAX ``init_random_params`` draws them.  ``rng``:
    what draws the normals (numpy's ``normal(scale=, size=)``; default
    ``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    sd = {}
    for k, s in expected_state_dict_shapes().items():
        fan_in = int(np.prod(s[1:])) if len(s) > 1 else s[0]
        sd[k] = (rng.normal(scale=np.sqrt(2.0 / fan_in), size=s)
                 .astype(np.float32) if len(s) > 1
                 else np.zeros(s, np.float32))
    return sd


class VGG16FC2(nn.Module):
    """``[N, 224, 224, 3]`` float RGB in [0, 1] -> ``[N, 4096]`` fc2
    features (pre-ReLU)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for item in _PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            nn.Linear(512 * 7 * 7, 4096), nn.ReLU(), nn.Dropout(),
            nn.Linear(4096, 4096))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN))
        self.register_buffer("std", torch.tensor(IMAGENET_STD))
        self.eval()

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        """Load the torchvision ``vgg16`` tensors of the census; a missing
        or misshapen one is a ``ValueError``, extra keys are ignored."""
        sd = pinned_tensors(state_dict, expected_state_dict_shapes(),
                            "vgg16")
        return super().load_state_dict(sd, strict=False, assign=assign)

    def fc2(self, images: torch.Tensor) -> torch.Tensor:
        """The network without ``forward``'s full-f32 guard."""
        x = (images.to(torch.float32) - self.mean) / self.std
        x = self.features(x.permute(0, 3, 1, 2))
        # torch flattens NCHW: [N, 512, 7, 7] -> 512*7*7
        x = F.relu(self.classifier[0](x.flatten(1)))
        return self.classifier[3](x)

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return self.fc2(images)


class VGGExtractor:
    """Precision / recall feature extractor on ``device`` (``None``:
    ``cuda``).  ``weights``: torchvision's vgg16 ``.pth`` or a same-key
    ``.npz``; ``None``: random weights (tests)."""

    def __init__(self, weights: str | None = None, device=None):
        self.device = resolve_device(device)
        sd = (random_state_dict() if weights is None
              else read_state_dict(weights))
        self.net = VGG16FC2()
        self.net.load_state_dict(sd)
        self.net.to(self.device)

    def image_features(self, images, batch: int = 32) -> torch.Tensor:
        """uint8 ``[N, H, W, 3]`` -> f32 ``[N, 4096]``: PIL's bilinear uint8
        resize to 224 (the reference's ``Resize([224, 224])``), then
        ``/ 255`` (``ToTensor``)."""
        images = torch.as_tensor(images).to(self.device)
        out = []
        for lo in range(0, len(images), batch):
            x = resize(images[lo: lo + batch].to(torch.uint8), (224, 224),
                       "bilinear").to(torch.float32) / 255.0
            out.append(self.net(x))
        return torch.cat(out) if out else torch.zeros(
            (0, 4096), device=self.device)
