"""Image reading, cropping and resampling on tensors, without PIL.

The JAX package reads and resizes every image through PIL; the card
machine has none.  This module is the port's replacement:

- ``read_image(path)``: uint8 ``[H, W, 3]`` with ``Image.convert("RGB")``'s
  semantics (alpha dropped without compositing, palette entries expanded,
  gray copied to all three channels).  PNG is decoded here with ``zlib``
  (8-bit gray, gray + alpha, RGB, RGBA and palette; all five row filters;
  IDAT split over several chunks); an interlaced or a 16-bit PNG raises a
  ``ValueError``.  JPEG and WebP go through PIL where it can be imported,
  and raise where it cannot;
- ``center_crop_square``: PIL's integer box ``((w - s) // 2, (h - s) // 2,
  ...)``;
- ``resize(img, (w, h), filter)``: PIL's separable resampler
  (``ImagingResample``) for ``lanczos``, ``bicubic`` and ``bilinear`` on
  ``[..., H, W, C]`` (a batch of images of one size): horizontal pass,
  then vertical.  uint8 input follows PIL's 22-bit fixed-point
  coefficients, its half-unit rounding and the clip to uint8 between the
  passes; float input (PIL's 'F' mode, clean-fid's resize) keeps the
  coefficients in double and stores float32 between the passes.

Integer work runs in int64 tensors on the input's device, so the card and
the CPU give the same bytes.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from .png import SIGNATURE

# colour type -> samples a pixel (PNG spec, IHDR)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_image(path: str, device=None) -> torch.Tensor:
    """The image at ``path`` as uint8 ``[H, W, 3]`` on ``device`` (``None``:
    the CPU).  A PNG's row filters are undone on ``device``."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(SIGNATURE):
        return decode_png(data, name=path, device=device)
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(
            f"cannot read {path}: it is not a PNG, and JPEG / WebP are read "
            f"through PIL, which is not installed") from None
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8)
    return torch.from_numpy(arr.copy()).to(device or "cpu")


def decode_png(data: bytes, name: str = "<png>", device=None) -> torch.Tensor:
    """The bytes of a PNG file -> uint8 ``[H, W, 3]`` on ``device``."""
    pos, ihdr, plte, idat = len(SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + n]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if ihdr is None or not idat:
        raise ValueError(f"{name}: a PNG without IHDR or IDAT")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not supported")
    if depth != 8:
        raise ValueError(f"{name}: {depth}-bit PNGs are not supported "
                         f"(8 bits a sample only)")
    if ctype not in _CHANNELS:
        raise ValueError(f"{name}: unknown PNG colour type {ctype}")
    if ctype == 3 and plte is None:
        raise ValueError(f"{name}: a palette PNG without PLTE")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{name}: {raw.size} bytes of image data, want "
                         f"{h * (1 + w * c)}")
    raw = torch.from_numpy(raw.reshape(h, 1 + w * c).copy()).to(
        device or "cpu")
    kinds = raw[:, 0]
    if bool((kinds > 4).any()):
        raise ValueError(f"{name}: unknown PNG row filter")
    px = unfilter(raw[:, 1:].reshape(h, w, c), kinds)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        pal = np.frombuffer(plte, np.uint8)[: 768]
        lut[: len(pal) // 3] = pal[: len(pal) // 3 * 3].reshape(-1, 3)
        return torch.from_numpy(lut).to(px.device)[px[..., 0].long()]
    if c <= 2:                                  # gray, gray + alpha
        return px[..., :1].expand(h, w, 3).contiguous()
    return px[..., :3].contiguous()


def unfilter(filt: torch.Tensor, kinds: torch.Tensor) -> torch.Tensor:
    """Undo the PNG row filters: ``filt`` uint8 ``[H, W, C]`` (one byte a
    sample), ``kinds`` ``[H]`` (0 none, 1 sub, 2 up, 3 average, 4 Paeth).

    A pixel depends on its left, upper and upper-left neighbours, so every
    pixel of one anti-diagonal ``x + y = d`` is ready once diagonal
    ``d - 1`` is.  The pixels are stored skewed, ``S[y + 1, d + 2]``, so
    that each diagonal step reads and writes whole columns."""
    h, w, c = filt.shape
    if not bool(kinds.any()):
        return filt
    dev = filt.device
    ys = torch.arange(h, device=dev)[:, None]
    cols = ys + torch.arange(w, device=dev)[None, :]           # d = x + y
    raw = torch.zeros((h, h + w - 1, c), dtype=torch.int32, device=dev)
    raw.scatter_(1, cols[..., None].expand(h, w, c), filt.to(torch.int32))
    valid = torch.zeros((h, h + w - 1, 1), dtype=torch.bool, device=dev)
    valid.scatter_(1, cols[..., None], True)
    k = kinds.to(torch.int32)[:, None]
    is_sub, is_up, is_avg, is_paeth = (k == 1, k == 2, k == 3, k == 4)
    S = torch.zeros((h + 1, h + w + 1, c), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for d in range(h + w - 1):
        a, b, cc = S[1:, d + 1], S[:-1, d + 1], S[:-1, d]    # left, up, up-left
        pa, pb, pc = (b - cc).abs(), (a - cc).abs(), (a + b - 2 * cc).abs()
        paeth = torch.where((pa <= pb) & (pa <= pc), a,
                            torch.where(pb <= pc, b, cc))
        pred = torch.where(is_sub, a, torch.where(
            is_up, b, torch.where(is_avg, (a + b) >> 1,
                                  torch.where(is_paeth, paeth, zero))))
        S[1:, d + 2] = torch.where(valid[:, d], (raw[:, d] + pred) & 255,
                                   zero)
    out = S[1:].gather(1, (cols + 2)[..., None].expand(h, w, c))
    return out.to(torch.uint8)


def center_crop_square(img: torch.Tensor) -> torch.Tensor:
    """``[..., H, W, C]`` -> the centred ``[..., s, s, C]``, ``s = min(H,
    W)``, at PIL's integer box ``((w - s) // 2, (h - s) // 2)``."""
    h, w = img.shape[-3], img.shape[-2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return img[..., top: top + s, left: left + s, :]


# ---------------------------------------------------------------------------
# PIL's separable resampler (libImaging/Resample.c)
# ---------------------------------------------------------------------------

PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: float) -> float:
    x = -x if x < 0.0 else x
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = -x if x < 0.0 else x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0),
           "lanczos": (_lanczos, 3.0)}


def precompute_coeffs(in_size: int, out_size: int, name: str):
    """PIL's ``precompute_coeffs`` for the box ``[0, in_size)``: per output
    sample the first input index and the normalised weights of its window
    (double), as ``(first [out], weights [out][ksize])`` lists."""
    fn, fsupport = FILTERS[name]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = fsupport * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    firsts, weights = [], []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        if ww != 0.0:
            k = [v / ww for v in k]
        firsts.append(xmin)
        weights.append(k + [0.0] * (ksize - xmax))
    return firsts, weights


def _fixed_point(v: float) -> int:
    """``normalize_coeffs_8bpc``: a weight in 22-bit fixed point, rounded
    away from zero."""
    v = v * (1 << PRECISION_BITS)
    return int(v - 0.5) if v < 0 else int(v + 0.5)


def _pass(x: torch.Tensor, axis: int, out_size: int, name: str
          ) -> torch.Tensor:
    """One resampling pass along ``axis`` (-3 rows, -2 columns) of ``x``:
    int64 pixels (uint8 mode) or float64 (float mode)."""
    in_size = x.shape[axis]
    firsts, weights = precompute_coeffs(in_size, out_size, name)
    ksize = len(weights[0])
    integer = not x.is_floating_point()
    idx = torch.tensor([[min(f + j, in_size - 1) for j in range(ksize)]
                        for f in firsts], dtype=torch.long, device=x.device)
    if integer:
        w = torch.tensor([[_fixed_point(v) for v in row] for row in weights],
                         dtype=torch.int64, device=x.device)
    else:
        w = torch.tensor(weights, dtype=torch.float64, device=x.device)
    shape = (out_size, 1, 1) if axis == -3 else (out_size, 1)
    acc = (torch.full((), 1 << (PRECISION_BITS - 1), dtype=torch.int64,
                      device=x.device) if integer else None)
    for j in range(ksize):
        tap = x.index_select(axis, idx[:, j]) * w[:, j].reshape(shape)
        acc = tap if acc is None else acc + tap
    if integer:
        return (acc >> PRECISION_BITS).clamp_(0, 255)
    return acc.to(torch.float32).to(torch.float64)


def resize(img: torch.Tensor, size: Tuple[int, int],
           filter: str = "lanczos") -> torch.Tensor:
    """PIL's ``Image.resize(size, filter)`` on ``[..., H, W, C]`` (``size``
    is ``(w, h)``, as PIL's): uint8 in, uint8 out (PIL's 'L' / 'RGB'
    modes), or float in, float32 out (PIL's 'F' mode)."""
    if filter not in FILTERS:
        raise ValueError(f"unknown filter {filter!r}; one of {list(FILTERS)}")
    out_w, out_h = size
    h, w = img.shape[-3], img.shape[-2]
    integer = img.dtype == torch.uint8
    if not integer and not img.is_floating_point():
        raise ValueError(f"resize takes uint8 or float images, not {img.dtype}")
    x = img.to(torch.int64) if integer else img.to(torch.float32).to(
        torch.float64)
    if out_w != w:
        x = _pass(x, -2, out_w, filter)
    if out_h != h:
        x = _pass(x, -3, out_h, filter)
    return x.to(torch.uint8) if integer else x.to(torch.float32)


def load_image(path: str, resize_to: Optional[int] = None,
               device=None) -> torch.Tensor:
    """Read -> centre-crop to the short edge -> Lanczos to ``resize_to``
    (the JAX ``evals.features.load_image`` and ``extract_code`` pipeline):
    uint8 ``[s, s, 3]`` on ``device``."""
    img = center_crop_square(read_image(path).to(device or "cpu"))
    if resize_to is not None:
        img = resize(img, (resize_to, resize_to), "lanczos")
    return img
