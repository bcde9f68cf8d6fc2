"""The port's PIL-free image reader and resampler (``utils/image.py``)
against PIL and the JAX package on the CPU.

- ``decode_png`` / ``read_image`` equal PIL's ``convert("RGB")`` for
  PIL-written PNGs in modes L, LA, RGB, RGBA and P under every filter
  choice PIL makes (default, ``optimize``, no compression), for PNGs
  written here with all five row filters and the IDAT split over several
  chunks, and for the repository's own ``generated_images``; JPEG goes
  through PIL, and without PIL raises naming the file; interlaced and
  16-bit PNGs raise naming the file;
- ``resize`` equals PIL's ``Image.resize`` at Lanczos, bicubic and
  bilinear on uint8 at odd sizes, down and up (at most one level apart;
  every sample tested is exact), and on float32 ('F' mode) equals
  ``lantern_tpu.evals.inception.clean_resize`` within 1e-4;
- ``models.item_processor.center_crop`` equals the JAX item processor's
  with PIL blocked for the port.

The card test of the reader and the resampler is in
``test_torch_backbones.py``, which imports no PIL (the card machine has
none).
"""

import io
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from lantern_tpu.evals import features as jfeat
from lantern_tpu.evals.inception import clean_resize as jclean_resize
from lantern_tpu.models import item_processor as jip
from lantern_tpu_torch.utils import image as timg
from lantern_tpu_torch.utils.png import SIGNATURE

REPO_IMAGES = "generated_images/coco2017_val/lantern_k_10_lambda_5/slice_0"
PIL_FILTERS = {"lanczos": Image.LANCZOS, "bicubic": Image.BICUBIC,
               "bilinear": Image.BILINEAR}
# (h, w) -> (out_w, out_h): odd sizes, down, up, one axis unchanged
RESIZES = [((37, 53), (20, 29)), ((37, 53), (101, 77)),
           ((64, 64), (256, 256)), ((300, 211), (17, 255)),
           ((256, 256), (224, 224)), ((10, 10), (10, 31)),
           ((299, 1), (5, 7))]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smooth_image(rng, h, w, c):
    """Blocks plus noise, so PIL's adaptive filtering picks several row
    filters."""
    base = rng.integers(0, 256, (h // 4 + 2, w // 4 + 2, c)).astype(float)
    img = np.kron(base, np.ones((4, 4, 1)))[:h, :w] + rng.normal(0, 10,
                                                                  (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_modes_match_pil(mode):
    rng = np.random.default_rng(0)
    if mode == "P":
        im = Image.fromarray(smooth_image(rng, 37, 53, 3)).convert(
            "P", palette=Image.ADAPTIVE, colors=100)
    else:
        c = len(mode)
        a = smooth_image(rng, 37, 53, c)
        im = Image.fromarray(a if c > 1 else a[..., 0], mode)
    for opt in ({}, {"optimize": True}, {"compress_level": 0}):
        buf = io.BytesIO()
        im.save(buf, "PNG", **opt)
        got = timg.decode_png(buf.getvalue())
        assert got.dtype == torch.uint8 and got.shape == (37, 53, 3)
        np.testing.assert_array_equal(got.numpy(), pil_rgb(buf.getvalue()))


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_filtered(img: np.ndarray, ctype: int, kinds, n_idat: int = 3,
                    depth: int = 8, interlace: int = 0) -> bytes:
    """A PNG whose row y uses filter ``kinds[y % len(kinds)]`` (the
    reference filters of the PNG spec, byte by byte), the IDAT stream split
    into ``n_idat`` chunks."""
    h, w, c = img.shape
    px = img.astype(int)
    rows = []
    for y in range(h):
        k = kinds[y % len(kinds)]
        out = [k]
        for x in range(w):
            for ch in range(c):
                a = px[y, x - 1, ch] if x else 0
                b = px[y - 1, x, ch] if y else 0
                cc = px[y - 1, x - 1, ch] if x and y else 0
                pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[k]
                out.append((px[y, x, ch] - pred) % 256)
        rows.append(bytes(out))
    z = zlib.compress(b"".join(rows))
    cut = [len(z) * i // n_idat for i in range(n_idat + 1)]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + b"".join(_chunk(b"IDAT", z[cut[i]:cut[i + 1]])
                       for i in range(n_idat))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,c", [(0, 1), (2, 3), (6, 4)])
def test_png_every_row_filter_split_idat(ctype, c, tmp_path):
    rng = np.random.default_rng(ctype)
    img = rng.integers(0, 256, (11, 9, c)).astype(np.uint8)
    data = encode_filtered(img, ctype, kinds=[0, 1, 2, 3, 4, 4, 3, 2, 1])
    want = pil_rgb(data)
    np.testing.assert_array_equal(want[..., 0], img[..., 0])
    path = tmp_path / "f.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(timg.read_image(str(path)).numpy(), want)


def test_png_errors_name_the_file(tmp_path):
    img = np.zeros((4, 4, 1), np.uint8)
    bad = tmp_path / "interlaced.png"
    bad.write_bytes(encode_filtered(img, 0, [0], interlace=1))
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        timg.read_image(str(bad))
    deep = tmp_path / "deep.png"
    Image.fromarray((np.arange(16).reshape(4, 4) * 4000).astype(np.uint16)
                    ).save(deep)
    with pytest.raises(ValueError, match="deep.png: 16-bit"):
        timg.read_image(str(deep))


def test_repo_pngs_and_jpeg(tmp_path, monkeypatch):
    for i in range(4):
        p = f"{REPO_IMAGES}/prompt_{i}.png"
        np.testing.assert_array_equal(timg.read_image(p).numpy(),
                                      np.asarray(Image.open(p).convert("RGB")))
    rng = np.random.default_rng(3)
    jpg = tmp_path / "a.jpg"
    Image.fromarray(smooth_image(rng, 20, 30, 3)).save(jpg, quality=90)
    np.testing.assert_array_equal(timg.read_image(str(jpg)).numpy(),
                                  np.asarray(Image.open(jpg).convert("RGB")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError, match="a.jpg.*PIL"):
        timg.read_image(str(jpg))
    timg.read_image(f"{REPO_IMAGES}/prompt_0.png")      # PNG needs no PIL


@pytest.mark.parametrize("filt", ["lanczos", "bicubic", "bilinear"])
def test_resize_uint8_matches_pil(filt):
    rng = np.random.default_rng(1)
    exact = total = 0
    for (h, w), size in RESIZES:
        a = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        got = timg.resize(torch.from_numpy(a), size, filt).numpy()
        want = np.asarray(Image.fromarray(a).resize(size, PIL_FILTERS[filt]))
        assert got.shape == want.shape
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1, (size, d.max())
        exact += int((d == 0).sum())
        total += d.size
        # a batch of images of one size resizes as each alone
        batch = torch.from_numpy(np.stack([a, a[::-1].copy()]))
        np.testing.assert_array_equal(
            timg.resize(batch, size, filt)[0].numpy(), got)
    assert exact == total


@pytest.mark.parametrize("filt", ["lanczos", "bicubic", "bilinear"])
def test_resize_float_matches_pil_f_mode(filt):
    rng = np.random.default_rng(2)
    for (h, w), size in RESIZES:
        a = rng.uniform(-3, 300, (h, w)).astype(np.float32)
        got = timg.resize(torch.from_numpy(a)[..., None], size, filt)
        assert got.dtype == torch.float32
        want = np.asarray(Image.fromarray(a, mode="F").resize(
            size, PIL_FILTERS[filt]))
        np.testing.assert_allclose(got[..., 0].numpy(), want, rtol=0,
                                   atol=1e-4)


def test_clean_resize_matches_jax():
    from lantern_tpu_torch.evals.inception import clean_resize

    rng = np.random.default_rng(4)
    for shape in ((17, 23, 3), (256, 256, 3), (300, 299, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        got = clean_resize(torch.from_numpy(img)).numpy()
        np.testing.assert_allclose(got, jclean_resize(img), rtol=0, atol=1e-4)


def test_center_crop_square_and_load_image_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    for h, w in ((37, 53), (64, 30), (33, 33)):
        a = smooth_image(rng, h, w, 3)
        s = min(h, w)
        box = ((w - s) // 2, (h - s) // 2, (w - s) // 2 + s, (h - s) // 2 + s)
        np.testing.assert_array_equal(
            timg.center_crop_square(torch.from_numpy(a)).numpy(),
            np.asarray(Image.fromarray(a).crop(box)))
        p = tmp_path / f"{h}x{w}.png"
        Image.fromarray(a).save(p)
        for size in (None, 24, 80):
            np.testing.assert_array_equal(
                timg.load_image(str(p), size).numpy(),
                jfeat.load_image(str(p), size))


def test_item_processor_center_crop_without_pil(monkeypatch):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (100, 300, 3), np.uint8)
    cases = ((96, 96), (512, 256), (300, 100), (64, 128))
    want = [jip.center_crop(img, cw, ch) for cw, ch in cases]
    from lantern_tpu_torch.models import item_processor as tip

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    for (cw, ch), w in zip(cases, want):
        np.testing.assert_array_equal(tip.center_crop(img, cw, ch), w)
