"""The port's codecs, tokenizer, item processor and checkpoint IO against
``lantern_tpu`` on the CPU.

Inputs come from numpy seeds and run through the JAX function and its
port:

- ``vqgan`` on a tiny VQ config (ch 32, ``ch_mult`` (1, 2), z 16, codebook
  64x8, L2-normalized codes as LlamaGen's) and a taming-style Chameleon
  variant (un-normalized codes, attention at the 8 px level): every layer,
  ``decode_code`` within ``1e-4 * max|ref|``, ``encode`` codes equal except
  where the two nearest distances tie within 1e-5, the weights carried by
  ``convert.convert_vqgan_params``; both torch-checkpoint loaders on
  synthetic state dicts (``random_taming_state_dict``, and its keys renamed
  to LlamaGen's module names);
- ``vq_distance`` save / load, each package reading the other's file;
- ``bpe`` on a tokenizer json written by the test (as
  ``tests/test_bpe.py`` builds it), the rest of ``chameleon`` (image-token
  offsets, vocab tables, the Anole prompt) and ``item_processor`` (crop
  sizes, token spans, malformed spans, ``hash_tokenize``, image encode and
  decode through the codec), all equal to JAX;
- ``checkpoint``: each ``*_params_from_torch`` on a synthetic state dict
  written as ``.pt`` (and ``.safetensors`` where that package imports)
  gives weights equal to the fused ``convert_params`` of the JAX loader's
  output, and the same forward; ``meta_chameleon_to_hf`` and
  ``load_meta_chameleon_dir`` equal to JAX; the native save / restore
  round trip.
"""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu.models import bpe as jbpe
from lantern_tpu.models import chameleon as jcham
from lantern_tpu.models import drafter as jdrf
from lantern_tpu.models import item_processor as jip
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.models import vqgan as jvq
from lantern_tpu.ops import vq_distance as jvd
from lantern_tpu.utils import checkpoint as jck
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch.models import bpe as tbpe
from lantern_tpu_torch.models import chameleon as tcham
from lantern_tpu_torch.models import item_processor as tip
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.models import vqgan as tvq
from lantern_tpu_torch.ops import vq_distance as tvd
from lantern_tpu_torch.utils import checkpoint as tck

from test_bpe import _make_tokenizer_file

VQ_KW = dict(ch=32, ch_mult=(1, 2), z_channels=16, codebook_size=64,
             codebook_dim=8)
# taming-style: attention at the 8 px level of a 16 px image
CHAM_KW = dict(resolution=16, attn_resolutions=(8,), **VQ_KW)
CODECS = ["llamagen", "chameleon"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny and the test workers share the cores: intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def vq_configs(kind):
    if kind == "llamagen":
        return jvq.VQGANConfig(**VQ_KW), tvq.VQGANConfig(**VQ_KW)
    return (jvq.chameleon_vq_config(**CHAM_KW),
            tvq.chameleon_vq_config(**CHAM_KW))


def vq_pair(kind, seed=0):
    """``(jax cfg, port cfg, jax params, port params)`` of one codec."""
    cj, ct = vq_configs(kind)
    pj = jvq.init_vqgan_params(jax.random.key(seed), cj)
    return cj, ct, pj, convert.convert_vqgan_params(
        jax.tree.map(np.asarray, pj), device="cpu")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def close(got, ref, scale=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=scale * np.abs(ref).max())


def tree_equal(a, b):
    """Two port parameter trees hold equal tensors in the same nesting."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            tree_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# ------------------------------------------------------------------ vqgan

def test_vq_configs_match_jax():
    for j, t in ((jvq.vq16_config(), tvq.vq16_config()),
                 (jvq.vq8_config(codebook_size=4096),
                  tvq.vq8_config(codebook_size=4096)),
                 (jvq.chameleon_vq_config(), tvq.chameleon_vq_config()),
                 vq_configs("chameleon")):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.downsample_factor == t.downsample_factor
        assert [j.enc_attn(i) for i in range(len(j.ch_mult))] == \
            [t.enc_attn(i) for i in range(len(t.ch_mult))]
    assert tvq.chameleon_vq_config().attn_levels == (4,)


def test_layers_match_jax():
    """conv2d, group_norm, the ResNet and attention blocks, down- and
    upsampling, one by one on NHWC (JAX) and NCHW (port) inputs."""
    cj, _, pj, pt = vq_pair("chameleon")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    enc_j, enc_t = pj["encoder"], pt["encoder"]
    cases = [
        ("conv2d", jvq.conv2d, tvq.conv2d, enc_j["conv_out"],
         enc_t["conv_out"]),
        ("group_norm", jvq.group_norm, tvq.group_norm, enc_j["norm_out"],
         enc_t["norm_out"]),
        ("resnet_block", jvq.resnet_block, tvq.resnet_block,
         enc_j["mid"][0], enc_t["mid"][0]),
        ("attn_block", jvq.attn_block, tvq.attn_block, enc_j["mid"][1],
         enc_t["mid"][1]),
        ("upsample", jvq.upsample, tvq.upsample,
         pj["decoder"]["blocks"][0]["upsample"],
         pt["decoder"]["blocks"][0]["upsample"])]
    for name, fj, ft, p_j, p_t in cases:
        ref = np.asarray(fj(p_j, jnp.asarray(x)))
        close(nhwc(ft(p_t, nchw(x))), ref, 1e-5)
    x32 = rng.normal(size=(2, 8, 8, 32)).astype(np.float32)
    ref = np.asarray(jvq.downsample(enc_j["blocks"][0]["downsample"],
                                    jnp.asarray(x32)))
    got = nhwc(tvq.downsample(enc_t["blocks"][0]["downsample"], nchw(x32)))
    assert got.shape == ref.shape == (2, 4, 4, 32)
    close(got, ref, 1e-5)


@pytest.mark.parametrize("kind", CODECS)
def test_init_params_tree_matches_jax(kind):
    """The port's random init has the JAX tree's nesting and (OIHW) shapes;
    L2-normalized codebooks come out unit-norm."""
    cj, ct, pj, pt = vq_pair(kind)
    mine = tvq.init_vqgan_params(torch.Generator().manual_seed(0), ct,
                                 device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(mine) == shapes(pt)
    norms = mine["codebook"].norm(dim=-1)
    if ct.l2_norm:
        torch.testing.assert_close(norms, torch.ones_like(norms))


@pytest.mark.parametrize("kind", CODECS)
@pytest.mark.parametrize("grid", [4, (2, 4)], ids=["square", "rect"])
def test_decode_code_matches_jax(kind, grid):
    cj, ct, pj, pt = vq_pair(kind)
    n = 16 if grid == 4 else 8
    codes = np.random.default_rng(1).integers(0, 64, (2, n)).astype(np.int32)
    ref = np.asarray(jvq.decode_code(pj, cj, jnp.asarray(codes), grid))
    got = tvq.decode_code(pt, ct, torch.from_numpy(codes), grid)
    assert got.shape == (2, 3) + ref.shape[1:3]
    close(nhwc(got), ref)


@pytest.mark.parametrize("kind", CODECS)
def test_encode_matches_jax(kind):
    """Codes equal the JAX ones except where the port's two nearest
    codebook distances tie within 1e-5."""
    cj, ct, pj, pt = vq_pair(kind)
    img = np.random.default_rng(2).uniform(-1, 1, (3, 16, 16, 3)).astype(
        np.float32)
    ref = np.asarray(jvq.encode(pj, cj, jnp.asarray(img)))
    got = tvq.encode(pt, ct, nchw(img))
    assert got.dtype == torch.int32 and got.shape == ref.shape == (3, 64)
    got = got.numpy()
    differ = np.argwhere(got != ref)
    if len(differ):
        # the port's latent distances at the differing positions
        enc = pt["encoder"]
        x = nchw(img)
        h = tvq.conv2d(enc["conv_in"], x)
        h = tvq._tower(enc["blocks"], enc["mid"], h, up=False)
        h = tvq.conv2d(enc["conv_out"],
                       tvq.swish(tvq.group_norm(enc["norm_out"], h)))
        z = tvq.conv2d(pt["quant_conv"], h).permute(0, 2, 3, 1).reshape(
            3, 64, -1)
        if ct.l2_norm:
            z = z / z.norm(dim=-1, keepdim=True)
        cb = tvq._norm_codebook(pt, ct)
        for b, i in differ:
            d = ((z[b, i][None] - cb) ** 2).sum(-1)
            assert abs(float(d[got[b, i]] - d[ref[b, i]])) <= 1e-5
    assert len(differ) <= 2


def test_random_taming_state_dict_matches_jax():
    cj, ct = vq_configs("chameleon")
    a, b = jvq.random_taming_state_dict(cj, 5), tvq.random_taming_state_dict(
        ct, 5)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    # a generator passed in draws the same stream as its seed
    c = tvq.random_taming_state_dict(ct, rng=np.random.default_rng(5))
    assert all(np.array_equal(a[k], c[k]) for k in a)


def to_llamagen_names(sd, n_levels):
    """Rename a taming-layout state dict to LlamaGen's ``vq_model.py``
    module names (``conv_blocks``, numbered mids, decoder blocks
    coarse-to-fine)."""
    mid = {"block_1": "0", "attn_1": "1", "block_2": "2"}
    out = {}
    for k, v in sd.items():
        k2 = re.sub(r"encoder\.down\.(\d+)\.block\.", r"encoder.conv_blocks.\1.res.", k)
        k2 = re.sub(r"encoder\.down\.(\d+)\.", r"encoder.conv_blocks.\1.", k2)
        k2 = re.sub(r"\.mid\.(block_1|attn_1|block_2)\.",
                    lambda m: f".mid.{mid[m.group(1)]}.", k2)
        m = re.match(r"decoder\.up\.(\d+)\.(.*)", k2)
        if m:
            b = n_levels - 1 - int(m.group(1))
            rest = m.group(2).replace("block.", "res.", 1)
            k2 = f"decoder.conv_blocks.{b}.{rest}"
        out[k2] = v
    return out


@pytest.mark.parametrize("layout", ["taming", "llamagen"])
@pytest.mark.parametrize("as_tensors", [False, True],
                         ids=["numpy", "tensors"])
def test_loaders_match_jax(layout, as_tensors):
    """``load_taming_state_dict`` / ``load_torch_state_dict`` on synthetic
    state dicts (numpy arrays, or the tensors ``load_torch_file`` gives)
    equal the converted JAX loads; the loaded codec decodes as JAX's."""
    kind = "chameleon" if layout == "taming" else "llamagen"
    cj, ct = vq_configs(kind)
    sd = jvq.random_taming_state_dict(cj, 1)
    if layout == "llamagen":
        sd = to_llamagen_names(sd, len(cj.ch_mult))
        pj = jvq.load_torch_state_dict(sd, cj)
        load = tvq.load_torch_state_dict
    else:
        pj = jvq.load_taming_state_dict(sd, cj)
        load = tvq.load_taming_state_dict
    src = ({k: torch.from_numpy(v) for k, v in sd.items()} if as_tensors
           else sd)
    pt = load(src, ct, device="cpu")
    tree_equal(pt, convert.convert_vqgan_params(
        jax.tree.map(np.asarray, pj), device="cpu"))
    codes = np.random.default_rng(0).integers(0, 64, (1, 16)).astype(np.int32)
    ref = np.asarray(jvq.decode_code(pj, cj, jnp.asarray(codes), 4))
    close(nhwc(tvq.decode_code(pt, ct, torch.from_numpy(codes), 4)), ref)


def test_to_uint8_matches_session_formula():
    x = torch.tensor([[[[-1.5, -1.0, 0.0, 0.999, 1.0, 2.0]]]]).expand(
        1, 3, 1, 6)
    got = tvq.to_uint8(x)
    assert got.shape == (1, 1, 6, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[0, 0, :, 0], [0, 0, 127, 254, 255, 255])


# ----------------------------------------------------------- vq_distance

def test_vq_distance_save_load_roundtrip(tmp_path):
    """uint16 on disk; each package reads the other's file."""
    table = np.random.default_rng(0).integers(0, 8192, (64, 11)).astype(
        np.int32)
    tvd.save_table(str(tmp_path / "port.npy"), table)
    jvd.save_table(str(tmp_path / "jax.npy"), table)
    assert np.load(tmp_path / "port.npy").dtype == np.uint16
    for name in ("port.npy", "jax.npy"):
        for load in (tvd.load_table, jvd.load_table):
            got = load(str(tmp_path / name))
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, table)
    cb = torch.from_numpy(np.random.default_rng(1).normal(
        size=(32, 8)).astype(np.float32))
    tvd.save_table(str(tmp_path / "near.npy"), tvd.nearest_latents(cb, k=5))
    np.testing.assert_array_equal(
        tvd.load_table(str(tmp_path / "near.npy")),
        jvd.nearest_latents(jnp.asarray(cb.numpy()), k=5))


# -------------------------------------------------------- bpe, chameleon

def test_bpe_matches_jax(tmp_path):
    p = str(_make_tokenizer_file(tmp_path))
    a, b = jbpe.ChameleonBPE(p), tbpe.ChameleonBPE(p)
    for text in ("abc ab", "a b c", "bc abc"):
        assert a.encode(text) == b.encode(text) == b(text)
        assert a.encode(text, bos=True) == b.encode(text, bos=True)
        assert a.decode(a.encode(text)) == b.decode(b.encode(text))
    for f in ("bos_id", "eos_id", "boi_id", "eoi_id", "pad_id", "eot_id",
              "newline_id"):
        assert getattr(a, f) == getattr(b, f)
    np.testing.assert_array_equal(a.img2bpe, b.img2bpe)
    np.testing.assert_array_equal(a.bpe2img, b.bpe2img)
    codes = np.array([0, 1, 12, 53])
    np.testing.assert_array_equal(b.img_to_bpe(codes), a.img_to_bpe(codes))
    np.testing.assert_array_equal(b.bpe_to_img(b.img_to_bpe(codes)), codes)
    sub = tmp_path / "ckpt" / "chameleon" / "tokenizer"
    sub.mkdir(parents=True)
    _make_tokenizer_file(sub)
    assert tbpe.load_tokenizer(str(tmp_path / "ckpt")).encode("ab") == [10]
    assert tbpe.load_tokenizer(p).path == p
    assert tbpe.load_tokenizer(None) is None
    with pytest.raises(FileNotFoundError):
        tbpe.ChameleonBPE.from_checkpoint_dir(str(tmp_path / "empty"))


def test_chameleon_rest_matches_jax(tmp_path):
    codes = np.random.default_rng(0).integers(0, 8192, (3, 5))
    np.testing.assert_array_equal(tcham.img_to_bpe(codes),
                                  jcham.img_to_bpe(codes))
    np.testing.assert_array_equal(tcham.bpe_to_img(tcham.img_to_bpe(codes)),
                                  codes)
    vocab = json.load(open(_make_tokenizer_file(tmp_path)))["model"]["vocab"]
    for x, y in zip(tcham.vocab_map_tables(vocab),
                    jcham.vocab_map_tables(vocab)):
        np.testing.assert_array_equal(x, y)
    for name in ("ANOLE_EOT", "IMAGE_START_ID",
                 "IMAGE_END_ID", "LUMINA_NEWLINE_ID"):
        assert getattr(tcham, name) == getattr(jcham, name)
    for text in ([5, 6, 7], [1], list(range(100, 120))):
        a, b = jcham.anole_token_prompt(text), tcham.anole_token_prompt(text)
        for f in ("tokens", "positions", "valid", "pos_diff"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)))


# -------------------------------------------------------- item processor

def test_crop_sizes_match_jax():
    for n in (576, 64, 17):
        assert tip.generate_crop_size_list(n) == jip.generate_crop_size_list(n)
    sizes = tip.generate_crop_size_list(576)
    for w, h in ((1024, 512), (500, 500), (300, 900), (77, 1000)):
        assert tip.var_center_crop_size(w, h, sizes) == \
            jip.var_center_crop_size(w, h, sizes)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (100, 300, 3), np.uint8)
    for cw, ch in ((96, 96), (512, 256), (300, 100)):
        np.testing.assert_array_equal(tip.center_crop(img, cw, ch),
                                      jip.center_crop(img, cw, ch))


def test_token_spans_match_jax():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 8192, (6, 8))
    toks = tip.codes_to_image_tokens(codes)
    assert toks == jip.codes_to_image_tokens(codes)
    back, h, w = tip.image_tokens_to_codes(toks)
    assert (h, w) == (6, 8)
    np.testing.assert_array_equal(back, codes)
    assert tip.grid_token(24) == jip.grid_token(24) == 8828
    bad = [[tcham.IMAGE_START_ID, 5, 5, 7],
           tip.codes_to_image_tokens(np.zeros((2, 2), np.int64))[:-2]]
    for span in bad:
        with pytest.raises(ValueError) as mine:
            tip.image_tokens_to_codes(span)
        with pytest.raises(ValueError) as ref:
            jip.image_tokens_to_codes(span)
        assert str(mine.value) == str(ref.value)
    for text in ("a cat", "a red fox in snow", "", "ünïcode wörds"):
        assert tip.hash_tokenize(text) == jip.hash_tokenize(text)


def test_item_processor_images_match_jax():
    """Encode an image into a Lumina span and decode spans back, through
    the tiny Chameleon codec, against the JAX processor: spans equal up to
    codebook ties, images within one uint8 level; text spans split
    alike."""
    # the processor's grid assumes the Chameleon codec's 16x downsampling:
    # five levels, as in tests/test_item_processor.py
    kw = dict(ch=32, num_res_blocks=1, codebook_size=64, codebook_dim=8,
              z_channels=32)
    cj, ct = jvq.chameleon_vq_config(**kw), tvq.chameleon_vq_config(**kw)
    pj = jvq.init_vqgan_params(jax.random.key(0), cj)
    pt = convert.convert_vqgan_params(jax.tree.map(np.asarray, pj), "cpu")
    a = jip.FlexARItemProcessor(vq_params=pj, vq_cfg=cj, target_size=64)
    b = tip.FlexARItemProcessor(vq_params=pt, vq_cfg=ct, target_size=64)
    assert a.crop_size_list == b.crop_size_list
    img = np.random.default_rng(1).integers(0, 255, (64, 64, 3), np.uint8)
    qas = [["describe <|image|> please", None]]
    ta, tb = a.process_item(qas, images=[img]), b.process_item(qas,
                                                               images=[img])
    assert len(ta) == len(tb)
    assert np.mean(np.asarray(ta) != np.asarray(tb)) <= 0.02
    # decode the same stream on both sides
    (txa, ima), (txb, imb) = a.decode_ids(tb), b.decode_ids(tb)
    assert txa == txb and len(ima) == len(imb) == 1
    assert imb[0].shape == (64, 64, 3) and imb[0].dtype == np.uint8
    assert np.abs(ima[0].astype(int) - imb[0].astype(int)).max() <= 1
    # a truncated span ends the walk as in JAX
    cut = tb[:-3]
    assert a.decode_ids(cut)[0] == b.decode_ids(cut)[0]
    with pytest.raises(ValueError, match="vq_params"):
        tip.FlexARItemProcessor().process_image(img)


# ------------------------------------------------------------ checkpoint

CKPT_KW = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
               block_size=16, max_seq_len=96)
CHAM_CKPT_KW = dict(vocab_size=8832, hidden_size=256, num_layers=2,
                    num_heads=2, rope_kind="1d", cond_kind="none",
                    qk_norm=True, max_seq_len=80)


def hf_state_dict(params, cfg, prefix="model.", qk_rows=None):
    """A published-layout state dict (numpy) of a split JAX params pytree:
    ``[out, in]`` linears, one entry per layer.  ``qk_rows``: store the
    QK-norm params with that many rows (Lumina keeps one per shard)."""
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    lp, sd = p["layers"], {}
    names = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
             "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    for li in range(cfg.num_layers):
        P = f"{prefix}layers.{li}."
        sd[P + "input_layernorm.weight"] = lp["attn_norm"][li]
        sd[P + "post_attention_layernorm.weight"] = lp["ffn_norm"][li]
        for k, n in names.items():
            sd[P + n + ".weight"] = np.ascontiguousarray(lp[k][li].T)
        if "q_norm_w" in lp:
            for k, n in (("q_norm_w", "q_norm.weight"),
                         ("q_norm_b", "q_norm.bias"),
                         ("k_norm_w", "k_norm.weight"),
                         ("k_norm_b", "k_norm.bias")):
                w = lp[k][li]
                sd[P + "self_attn." + n] = w[:qk_rows] if qk_rows else w
    if "embed" in p:
        sd[prefix + "embed_tokens.weight"] = p["embed"]
    if "norm" in p:
        sd[prefix + "norm.weight"] = p["norm"]
    if "lm_head" in p:
        sd["lm_head.weight"] = np.ascontiguousarray(p["lm_head"].T)
    cond = p.get("cond", {})
    if "table" in cond:
        sd[prefix + "cls_embedding.embedding_table.weight"] = cond["table"]
    if "fc1" in cond:
        sd[prefix + "cls_embedding.cap_proj.fc1.weight"] = cond["fc1"].T
        sd[prefix + "cls_embedding.cap_proj.fc2.weight"] = cond["fc2"].T
        sd[prefix + "cls_embedding.uncond_embedding"] = cond["uncond"]
    return sd


def drafter_state_dict(dparams, dcfg):
    """An EAGLE drafter checkpoint's state dict (no layer-0 input norm)."""
    sd = hf_state_dict({"layers": dparams["layers"]}, dcfg.model, prefix="")
    del sd["layers.0.input_layernorm.weight"]
    sd["fc.weight"] = np.ascontiguousarray(np.asarray(dparams["fc_w"]).T)
    sd["fc.bias"] = np.asarray(dparams["fc_b"])
    sd["embed_tokens.weight"] = np.asarray(dparams["embed"])
    return sd


def c_tensors(sd):
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def save_torch(path, sd):
    torch.save(c_tensors(sd), str(path))


def fused_port(params_j):
    """The port's fused layout of a JAX pytree (``convert_params``, then
    ``fuse_params``)."""
    return ttfm.fuse_params(convert.convert_params(
        jax.tree.map(np.asarray, params_j), device="cpu"))


def same_forward(cfg_t, a, b, T=5):
    """The port's forward over the same inputs with params ``a`` and ``b``."""
    from lantern_tpu_torch.kv import KVCache

    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg_t.vocab_size, (2, T)))
    outs = []
    for p in (a, b):
        kv = KVCache.create(cfg_t, 2, device="cpu")
        rope = ttfm.make_rope_tables(cfg_t, "cpu")
        outs.append(ttfm.forward(p, cfg_t, ttfm.token_embed(p, ids), kv,
                                 torch.arange(T), rope).hidden)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


FORMATS = ["pt", "safetensors"]


def write_checkpoint(tmp_path, sd, fmt):
    if fmt == "pt":
        save_torch(tmp_path / "pytorch_model.bin", sd)
    else:
        save_file = pytest.importorskip("safetensors.torch").save_file

        save_file(c_tensors(sd),
                  str(tmp_path / "model.safetensors"))
    return str(tmp_path)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("cond_kind", ["label", "caption"])
def test_llamagen_params_from_torch_matches_jax(tmp_path, fmt, cond_kind):
    cfg_j = jc.tiny_config(cond_kind=cond_kind, **CKPT_KW)
    cfg_t = tc.tiny_config(cond_kind=cond_kind, **CKPT_KW)
    path = write_checkpoint(tmp_path, hf_state_dict(
        jtfm.init_params(jax.random.key(0), cfg_j), cfg_j), fmt)
    ref = fused_port(jck.llamagen_params_from_torch(
        jck.load_torch_dir(path), cfg_j))
    got = tck.llamagen_params_from_torch(tck.load_torch_dir(path), cfg_t,
                                         device="cpu")
    assert "wqkv" in got["layers"] and "w_gu" in got["layers"]
    tree_equal(got, ref)
    if cond_kind == "label":
        same_forward(cfg_t, got, ref)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("qk_rows", [None, 1], ids=["anole", "lumina-mp"])
def test_chameleon_params_from_torch_matches_jax(tmp_path, fmt, qk_rows):
    """Anole's per-head QK-norm rows, and Lumina's one row per shard
    repeated over the heads."""
    cfg_j, cfg_t = jc.tiny_config(**CHAM_CKPT_KW), tc.tiny_config(
        **CHAM_CKPT_KW)
    pj = jtfm.init_params(jax.random.key(1), cfg_j)
    rng = np.random.default_rng(0)
    layers = dict(pj["layers"])
    for k in ("q_norm_w", "q_norm_b", "k_norm_w", "k_norm_b"):
        row = rng.normal(size=layers[k].shape[::2]).astype(np.float32)
        layers[k] = jnp.asarray(np.broadcast_to(row[:, None],
                                                layers[k].shape))
    pj = dict(pj, layers=layers)
    path = write_checkpoint(tmp_path, hf_state_dict(pj, cfg_j,
                                                    qk_rows=qk_rows), fmt)
    ref = fused_port(jck.chameleon_params_from_torch(
        jck.load_torch_dir(path), cfg_j))
    got = tck.chameleon_params_from_torch(tck.load_torch_dir(path), cfg_t,
                                          device="cpu")
    tree_equal(got, ref)
    same_forward(cfg_t, got, ref)


def test_drafter_params_from_torch_matches_jax(tmp_path):
    cfg_j = jc.tiny_config(cond_kind="label", **CKPT_KW)
    cfg_t = tc.tiny_config(cond_kind="label", **CKPT_KW)
    dcfg_j, dcfg_t = jc.drafter_config(cfg_j), tc.drafter_config(cfg_t)
    base = jtfm.init_params(jax.random.key(0), cfg_j)
    dj = jdrf.init_drafter_params(jax.random.key(1), dcfg_j, base["embed"])
    save_torch(tmp_path / "d.pt", drafter_state_dict(dj, dcfg_j))
    ref_j = jck.drafter_params_from_torch(
        jck.load_torch_file(str(tmp_path / "d.pt")), dcfg_j)
    ref = ttfm.fuse_params(convert.convert_drafter_params(
        jax.tree.map(np.asarray, ref_j), device="cpu"))
    sd = tck.load_torch_file(str(tmp_path / "d.pt"))
    tree_equal(tck.drafter_params_from_torch(sd, dcfg_t, device="cpu"), ref)
    embed = torch.zeros_like(ref["embed"])
    shared = tck.drafter_params_from_torch(sd, dcfg_t, embed=embed,
                                           device="cpu")
    assert shared["embed"] is embed


def test_sharded_dir_and_wrapped_files(tmp_path):
    """An index-sharded dir loads as the single file does; a ``state_dict``
    wrapper and non-tensor metadata are handled as in JAX."""
    sd = {f"w{i}": np.full((2, 3), i, np.float32) for i in range(4)}
    save_torch(tmp_path / "a.bin", {k: sd[k] for k in ("w0", "w1")})
    save_torch(tmp_path / "b.bin", {k: sd[k] for k in ("w2", "w3")})
    (tmp_path / "pytorch_model.bin.index.json").write_text(json.dumps(
        {"weight_map": {"w0": "a.bin", "w1": "a.bin", "w2": "b.bin",
                        "w3": "b.bin"}}))
    got = tck.load_torch_dir(str(tmp_path))
    ref = jck.load_torch_dir(str(tmp_path))
    assert set(got) == set(ref) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    torch.save({"state_dict": {"x": torch.ones(2, dtype=torch.bfloat16)},
                "epoch": 3}, str(tmp_path / "wrapped.ckpt"))
    got = tck.load_torch_file(str(tmp_path / "wrapped.ckpt"))
    assert list(got) == ["x"] and got["x"].dtype == torch.float32
    with pytest.raises(FileNotFoundError):
        tck.load_torch_dir(str(tmp_path / "missing"))


L_META, NH_META, DIM_META = 2, 4, 64


def _meta_shards(n):
    from test_meta_converter import _meta_shard

    rng = np.random.default_rng(0)
    return [_meta_shard(rng, frac=1.0 / n) for _ in range(n)]


@pytest.mark.parametrize("n_shards", [1, 2])
def test_meta_chameleon_to_hf_matches_jax(n_shards):
    shards = _meta_shards(n_shards)
    kw = dict(num_layers=L_META, n_heads=NH_META, dim=DIM_META)
    a = jck.meta_chameleon_to_hf(shards, **kw)
    b = tck.meta_chameleon_to_hf(shards, **kw)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_load_meta_chameleon_dir_matches_jax(tmp_path):
    for i, sd in enumerate(_meta_shards(2)):
        save_torch(tmp_path / f"consolidated.{i:02d}.pth", sd)
    (tmp_path / "params.json").write_text(json.dumps(
        {"model": {"dim": DIM_META, "n_layers": L_META,
                   "n_heads": NH_META}}))
    (a, pa), (b, pb) = (jck.load_meta_chameleon_dir(str(tmp_path)),
                        tck.load_meta_chameleon_dir(str(tmp_path)))
    assert pa == pb and list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(FileNotFoundError):
        tck.load_meta_chameleon_dir(str(tmp_path / "none"))


def test_save_restore_roundtrip(tmp_path):
    """``torch.save`` / ``torch.load(weights_only=True)`` of a quantized
    param dict and a codec tree, with ``like`` checking the structure."""
    from lantern_tpu_torch.ops.quant import quantize_params

    cfg = tc.tiny_config(cond_kind="label", **CKPT_KW)
    params = quantize_params(ttfm.fuse_params(ttfm.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu")))
    _, ct = vq_configs("chameleon")
    codec = tvq.init_vqgan_params(torch.Generator().manual_seed(1), ct,
                                  device="cpu")
    for name, tree in (("params", params), ("codec", codec)):
        path = str(tmp_path / "sub" / f"{name}.pt")
        tck.save_pytree(path, tree)
        tree_equal(tck.restore_pytree(path, like=tree, device="cpu"), tree)
    bad = dict(params, norm=params["norm"][:3])
    with pytest.raises(ValueError, match="does not match"):
        tck.restore_pytree(str(tmp_path / "sub" / "params.pt"), like=bad,
                           device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CODECS)
def test_decode_and_encode_cuda_match_cpu(cuda, kind):
    """The codec on the card (full-f32 convolutions) against the CPU on the
    same weights: decoded pixels within one uint8 level, codes equal."""
    _, ct, _, pt = vq_pair(kind)

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)
    pc = to(pt, cuda)
    codes = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (2, 16)).astype(np.int32))
    ref = tvq.to_uint8(tvq.decode_code(pt, ct, codes, 4))
    got = tvq.to_uint8(tvq.decode_code(pc, ct, codes.to(cuda), 4))
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    img = nchw(np.random.default_rng(2).uniform(-1, 1, (2, 16, 16, 3))
               .astype(np.float32))
    assert torch.equal(tvq.encode(pc, ct, img.to(cuda)).cpu(),
                       tvq.encode(pt, ct, img))
