"""The pinned eval backbones at their published widths against
``lantern_tpu/evals`` on the CPU, from one numpy state dict each.

- Inception-V3 pool3 (clean-fid's network): ``InceptionExtractor`` on 2
  images of odd sizes (the clean bicubic resize to 299 included) within
  ``1e-4 * max|ref|`` of JAX's, and the network on 299 x 299 inputs; a
  Mixed_7c average pool (torchvision's, not the FID network's) must miss;
- VGG16 fc2: ``VGGExtractor`` (the bilinear uint8 resize to 224 included)
  within ``1e-4 * max|ref|``;
- ``cuda``-marked tests: both backbones and CLIP ViT-B/32 on the card
  within ``1e-4 * max|ref|`` of the CPU; the PNG reader's row filters and
  the resampler on the card equal to the CPU (float within 1e-4).  This
  file imports no PIL, so it runs on the card machine.
"""

import numpy as np
import pytest
import torch

from lantern_tpu.evals import inception as jinc
from lantern_tpu.evals import vgg as jvgg
from lantern_tpu_torch.evals import clip as tclip
from lantern_tpu_torch.evals import inception as tinc
from lantern_tpu_torch.evals import vgg as tvgg
from lantern_tpu_torch.utils import image as timg


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def images(seed, n, h, w):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3)).astype(
        np.uint8)


def close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert scale > 0 and err <= tol * scale, (err, scale)
    return err / scale


def test_inception_matches_jax():
    ex = tinc.InceptionExtractor(device="cpu")       # random_state_dict(0)
    jx = jinc.InceptionExtractor()                   # init_random_params(0)
    imgs = images(0, 2, 97, 131)
    close(ex.image_features(imgs).numpy(), jx.image_features(imgs))
    x = np.random.default_rng(1).uniform(0, 255, (2, 299, 299, 3)).astype(
        np.float32)
    want = np.asarray(jx._fwd(jx.params, x))
    close(ex.net(torch.from_numpy(x)).numpy(), want)
    ex.net.mixed_7c_pool = "avg"
    err = np.abs(ex.net(torch.from_numpy(x)).numpy() - want).max()
    assert err > 1e-2 * np.abs(want).max()


def test_vgg_matches_jax():
    ex = tvgg.VGGExtractor(device="cpu")
    jx = jvgg.VGGExtractor()
    imgs = images(2, 2, 97, 131)
    close(ex.image_features(imgs).numpy(), jx.image_features(imgs))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_backbones_cuda_match_cpu(cuda):
    imgs = torch.from_numpy(images(3, 2, 97, 131))
    for mod in (tinc.InceptionExtractor, tvgg.VGGExtractor):
        ref = mod(device="cpu").image_features(imgs)
        close(mod(device=cuda).image_features(imgs.to(cuda)).cpu(), ref)
    sd = tclip.random_state_dict(tclip.VIT_B32)
    x = tclip.preprocess_images(imgs)
    toks = torch.zeros((2, 77), dtype=torch.long)
    toks[:, :4] = torch.tensor([49406, 320, 1125, 49407])
    for dev in ("cpu", cuda):
        p = tclip.params_from_openai(sd, tclip.VIT_B32, dev)
        got = (tclip.encode_image(p, x, tclip.VIT_B32).cpu(),
               tclip.encode_text(p, toks, tclip.VIT_B32).cpu())
        if dev == "cpu":
            ref = got
    close(got[0], ref[0])
    close(got[1], ref[1])


@pytest.mark.cuda
def test_decode_and_resize_cuda_match_cpu(cuda):
    """The decoder's row filters and the resampler on the card give the
    CPU's bytes (float within 1e-4)."""
    import glob

    for p in glob.glob("generated_images/**/prompt_*.png", recursive=True):
        assert torch.equal(timg.read_image(p, device=cuda).cpu(),
                           timg.read_image(p))
    rng = np.random.default_rng(6)
    # (h, w) -> (out_w, out_h): down, up, odd sizes, one axis unchanged
    for (h, w), size in (((37, 53), (20, 29)), ((37, 53), (101, 77)),
                         ((256, 256), (299, 299)), ((300, 211), (17, 255)),
                         ((256, 256), (224, 224)), ((10, 10), (10, 31))):
        a = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3)).astype(
            np.uint8))
        for filt in ("lanczos", "bicubic", "bilinear"):
            assert torch.equal(timg.resize(a.to(cuda), size, filt).cpu(),
                               timg.resize(a, size, filt))
            f = a.to(torch.float32)
            assert (timg.resize(f.to(cuda), size, filt).cpu()
                    - timg.resize(f, size, filt)).abs().max() <= 1e-4
