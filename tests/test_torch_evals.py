"""The port's eval library (``lantern_tpu_torch/evals``) against
``lantern_tpu/evals`` on the CPU.

- ``metrics``: every function on the same seeded features within 1e-10
  relative of the JAX package's numpy, precision / recall and the k-NN
  radii exactly;
- ``clip_bpe``: ids equal to JAX's on a synthetic merges table (a list, a
  ``.txt`` and a ``.gz`` file), with and without ``prepend``;
- ``clip``: the census of ``VIT_B32`` and ``VIT_H14`` equal to JAX's,
  ``random_state_dict`` equal to the JAX draws, ``preprocess_images``
  exact, ``encode_image`` / ``encode_text`` on a tiny geometry (QuickGELU
  and exact GELU) within 1e-5 of JAX from one numpy state dict,
  ``load_any`` from ``.npz``, ``.pt`` and an HF directory;
- ``features``: ``HFClipExtractor`` against JAX's on a tiny
  ``CLIPConfig``, ``TorchvisionExtractor`` raising where torchvision is
  missing, the directory / ``.npz`` helpers, and the backbones' census
  checks.
"""

import gzip
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from lantern_tpu.evals import clip as jclip
from lantern_tpu.evals import clip_bpe as jbpe
from lantern_tpu.evals import features as jfeat
from lantern_tpu.evals import inception as jinc
from lantern_tpu.evals import metrics as jm
from lantern_tpu.evals import vgg as jvgg
from lantern_tpu_torch.evals import clip as tclip
from lantern_tpu_torch.evals import clip_bpe as tbpe
from lantern_tpu_torch.evals import features as tfeat
from lantern_tpu_torch.evals import inception as tinc
from lantern_tpu_torch.evals import metrics as tm
from lantern_tpu_torch.evals import vgg as tvgg

MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("t", "h"),
          ("th", "e</w>"), ("hell", "o</w>"), ("c", "a"), ("ca", "t</w>")]
TINY = dict(vision_width=64, vision_layers=2, vision_heads=4, patch=16,
            image_size=64, embed_dim=32, text_width=48, text_layers=2,
            text_heads=4, vocab=522, ctx=16)    # vocab: 512 bytes + MERGES + 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def clouds(seed=0, n=300, m=250, d=16):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, d))
    b = rng.normal(loc=0.3, scale=1.2, size=(m, d))
    b[:40] = rng.normal(loc=4.0, size=(40, d))       # a mode the ref lacks
    return a.astype(np.float32), b.astype(np.float32)


# ---------------------------------------------------------------- metrics

def test_frechet_matches_jax():
    a, b = clouds()
    mu_t, s_t = tm.gaussian_stats(torch.from_numpy(a))
    mu_j, s_j = jm.gaussian_stats(a)
    assert rel(mu_t, mu_j) < 1e-10 and rel(s_t, s_j) < 1e-10
    assert s_t.dtype == torch.float64
    assert rel(tm.fid_from_features(a, b), jm.fid_from_features(a, b)) < 1e-10
    assert abs(tm.fid_from_features(a, a)) < 1e-6
    # the stabilised path (a singular product) and 1-d features
    one = np.ones((5, 3), np.float32)
    assert rel(tm.fid_from_features(one, b[:, :3]),
               jm.fid_from_features(one, b[:, :3])) < 1e-10
    x = np.arange(7, dtype=np.float32)[:, None]
    assert rel(tm.fid_from_features(x, x * 2), jm.fid_from_features(x, x * 2)
               ) < 1e-10


@pytest.mark.parametrize("k", [1, 3, 5])
def test_manifolds_match_jax(k):
    a, b = clouds(k)
    assert rel(tm.pairwise_distances(a, b, block=64),
               jm.pairwise_distances(a, b)) < 1e-10
    rt, rj = tm.knn_radii(a, k=k, block=70), jm.knn_radii(a, k=k)
    assert rel(rt, rj) < 1e-10
    np.testing.assert_array_equal(
        np.argsort(rt.numpy(), kind="stable"), np.argsort(rj, kind="stable"))
    pr_t, pr_j = tm.precision_recall(a, b, k=k), jm.precision_recall(a, b, k=k)
    assert pr_t == pr_j and 0 < pr_t.precision < 1 and 0 < pr_t.recall < 1
    mt, mj = tm.manifold(a, k=k), jm.manifold(a, k=k)
    assert tm.manifold_coverage(mt, b, block=33) == jm.manifold_coverage(mj, b)
    for n in (len(a), len(a) - 1):           # np.median: even and odd counts
        sub_t = tm.Manifold(mt.features[:n], mt.radii[:n])
        sub_j = jm.Manifold(mj.features[:n], mj.radii[:n])
        for f in (b[0], b[-1], a[3] + 0.05):   # off the set
            assert rel(tm.realism(sub_t, f), jm.realism(sub_j, f)) < 1e-10
    # degenerate: duplicates whose distances are exactly 0, so every
    # radius is 0 and no ball is below the median
    dup = np.repeat(np.eye(2, 16, dtype=np.float32), 6, axis=0)
    assert rel(tm.realism(tm.manifold(dup, k=k), b[0]),
               jm.realism(jm.manifold(dup, k=k), b[0])) < 1e-10
    with pytest.raises(ValueError, match="must be <"):
        tm.knn_radii(a[:k], k=k)


def test_scores_match_jax():
    rng = np.random.default_rng(7)
    img, txt = rng.normal(size=(9, 32)), rng.normal(size=(9, 32))
    assert rel(tm.clip_score_from_embeddings(torch.from_numpy(img), txt),
               jm.clip_score_from_embeddings(img, txt)) < 1e-10
    assert rel(tm.hps_from_embeddings(img, txt), jm.hps_from_embeddings(
        img, txt)) < 1e-10


# -------------------------------------------------------------- tokenizer

def test_clip_tokenizer_matches_jax(tmp_path):
    txt = tmp_path / "merges.txt"
    txt.write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES))
    gz = tmp_path / "merges.txt.gz"
    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write(txt.read_text())
    texts = ["hello the hell", "The CAT!", "a b  c", "th th th",
             "it's 2 cats' 99 hats", "émigré café", " " * 3 + "x" * 200]
    for src in (MERGES, str(txt), str(gz)):
        t, j = tbpe.ClipTokenizer(src, ctx=16), jbpe.ClipTokenizer(src, ctx=16)
        assert t.vocab_size == j.vocab_size
        np.testing.assert_array_equal(t(texts), j(texts))
        np.testing.assert_array_equal(t(texts, prepend="A photo depicts "),
                                      j(texts, prepend="A photo depicts "))


# ------------------------------------------------------------------- clip

def test_clip_census_and_random_weights_match_jax():
    for geom in ("VIT_B32", "VIT_H14"):
        assert tclip.expected_state_dict_shapes(getattr(tclip, geom)) == \
            jclip.expected_state_dict_shapes(getattr(jclip, geom))
    tiny_t, tiny_j = tclip.CLIPGeom(**TINY), jclip.CLIPGeom(**TINY)
    sd = tclip.random_state_dict(tiny_t, seed=4)
    pj = jclip.init_random_params(tiny_j, seed=4)
    # a generator passed in draws the same stream as its seed
    again = tclip.random_state_dict(tiny_t, rng=np.random.default_rng(4))
    assert all(np.array_equal(sd[k], again[k]) for k in sd)
    pt = tclip.params_from_openai(sd, tiny_t, device="cpu")
    np.testing.assert_array_equal(pt["visual.proj"].numpy(), pj["v_proj"])
    np.testing.assert_array_equal(
        pt["transformer.resblocks.1.mlp.c_fc.weight"].numpy().T,
        pj["t_blocks"][1]["fc_w"])
    assert float(pt["logit_scale"]) == pytest.approx(pj["logit_scale"])
    with pytest.raises(ValueError, match="missing"):
        tclip.params_from_openai({k: v for k, v in sd.items()
                                  if k != "visual.proj"}, tiny_t, "cpu")
    bad = dict(sd, **{"visual.proj": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="differ"):
        tclip.params_from_openai(bad, tiny_t, "cpu")


@pytest.mark.parametrize("quick", [True, False], ids=["quick_gelu", "gelu"])
def test_clip_towers_match_jax(quick):
    tg, jg = (tclip.CLIPGeom(**TINY, quick_gelu=quick),
              jclip.CLIPGeom(**TINY, quick_gelu=quick))
    sd = tclip.random_state_dict(tg, seed=1)
    pt, pj = tclip.params_from_openai(sd, tg, "cpu"), jclip.params_from_openai(
        sd, jg)
    rng = np.random.default_rng(0)
    for imgs in (rng.integers(0, 256, (3, 70, 90, 3)).astype(np.uint8),
                 rng.integers(0, 256, (2, 101, 64, 3)).astype(np.uint8),
                 rng.random((2, 50, 60, 3)).astype(np.float32)):
        xt = tclip.preprocess_images(torch.from_numpy(imgs), 64)
        xj = jclip.preprocess_images(imgs, 64)
        np.testing.assert_array_equal(xt.numpy(), xj)
        np.testing.assert_allclose(
            tclip.encode_image(pt, xt, tg).numpy(),
            np.asarray(jclip.encode_image(pj, xj, jg)), rtol=0, atol=1e-5)
    toks = np.zeros((3, 16), np.int64)
    toks[0, :5] = [1, 7, 9, 4, 521]
    toks[1, :3] = [1, 20, 521]
    toks[2, :] = np.arange(400, 416)
    np.testing.assert_allclose(
        tclip.encode_text(pt, toks, tg).numpy(),
        np.asarray(jclip.encode_text(pj, toks, jg)), rtol=0, atol=1e-5)
    f = np.random.default_rng(1).normal(size=(4, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tclip.cosine_scores(torch.from_numpy(f), torch.from_numpy(f[::-1].copy())
                            ).numpy(),
        np.asarray(jclip.cosine_scores(f, f[::-1])), rtol=0, atol=1e-6)


def _tiny_hf_clip(tmp_path, save=True):
    from transformers import (CLIPConfig, CLIPModel, CLIPTextConfig,
                              CLIPVisionConfig)

    cfgv = CLIPVisionConfig(hidden_size=64, intermediate_size=256,
                            num_hidden_layers=2, num_attention_heads=4,
                            image_size=64, patch_size=16,
                            hidden_act="quick_gelu")
    # the eos id is the largest, so HF's eos pooling is OpenAI's argmax
    cfgt = CLIPTextConfig(hidden_size=48, intermediate_size=192,
                          num_hidden_layers=2, num_attention_heads=4,
                          vocab_size=522, max_position_embeddings=16,
                          hidden_act="quick_gelu", eos_token_id=521)
    torch.manual_seed(0)
    model = CLIPModel(CLIPConfig(text_config=cfgt.to_dict(),
                                 vision_config=cfgv.to_dict(),
                                 projection_dim=32)).eval()
    if save:
        model.save_pretrained(tmp_path / "hf_clip")
    return model


def test_clip_load_any_matches_jax(tmp_path):
    tg, jg = tclip.CLIPGeom(**TINY), jclip.CLIPGeom(**TINY)
    sd = tclip.random_state_dict(tg, seed=2)
    np.savez(tmp_path / "w.npz", **sd)
    torch.save({"state_dict": {"module." + k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, tmp_path / "w.pt")
    _tiny_hf_clip(tmp_path)
    for src in ("w.npz", "w.pt", "hf_clip"):
        pt = tclip.load_any(str(tmp_path / src), tg, "cpu")
        pj = jclip.load_any(str(tmp_path / src), jg)
        np.testing.assert_array_equal(
            pt["visual.transformer.resblocks.1.attn.in_proj_weight"].numpy().T,
            pj["v_blocks"][1]["qkv_w"])
        np.testing.assert_array_equal(pt["token_embedding.weight"].numpy(),
                                      pj["t_tok"])
    ex = tclip.CLIPExtractor(str(tmp_path / "w.npz"), tg,
                             tokenizer=tbpe.ClipTokenizer(MERGES, ctx=16),
                             device="cpu")
    jx = jclip.CLIPExtractor(str(tmp_path / "w.npz"), jg,
                             tokenizer=jbpe.ClipTokenizer(MERGES, ctx=16))
    imgs = np.random.default_rng(3).integers(0, 256, (3, 48, 40, 3)
                                             ).astype(np.uint8)
    np.testing.assert_allclose(ex.image_features(imgs, batch=2).numpy(),
                               jx.image_features(imgs, batch=2), atol=1e-5)
    np.testing.assert_allclose(ex.text_features(["hello cat", "the"]).numpy(),
                               jx.text_features(["hello cat", "the"]),
                               atol=1e-5)


# --------------------------------------------------------------- features

def test_hf_clip_extractor_matches_jax(tmp_path):
    from transformers import CLIPImageProcessor, CLIPTokenizer

    _tiny_hf_clip(tmp_path)
    tok = tbpe.ClipTokenizer(MERGES)
    vocab = tmp_path / "vocab.json"
    import json

    vocab.write_text(json.dumps(tok.encoder))
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: 0.2\n"
                      + "\n".join(f"{a} {b}" for a, b in MERGES))
    d = tmp_path / "hf_clip"
    CLIPTokenizer(str(vocab), str(merges), model_max_length=16
                  ).save_pretrained(d)
    CLIPImageProcessor(size={"shortest_edge": 64},
                       crop_size={"height": 64, "width": 64}).save_pretrained(d)
    texts = ["hello cat", "the", "a b  c"]
    imgs = np.random.default_rng(4).integers(0, 256, (3, 70, 80, 3)
                                             ).astype(np.uint8)
    t = tfeat.make_extractor("hf_clip", str(d), device="cpu")
    j = jfeat.make_extractor("hf_clip", str(d))
    np.testing.assert_allclose(t.image_features(imgs, batch=2).numpy(),
                               j.image_features(imgs, batch=2), atol=1e-6)
    t.prepend = j.prepend = ""
    np.testing.assert_allclose(t.text_features(texts).numpy(),
                               j.text_features(texts), atol=1e-6)


def test_missing_packages_raise(monkeypatch):
    monkeypatch.setitem(sys.modules, "torchvision", None)
    monkeypatch.setitem(sys.modules, "torchvision.models", None)
    with pytest.raises(ImportError, match="torchvision package"):
        tfeat.make_extractor("vgg16", device="cpu")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers package"):
        tfeat.make_extractor("hf_clip", "somewhere", device="cpu")
    from lantern_tpu_torch.utils.t5 import T5Embedder

    with pytest.raises(ImportError, match="transformers package"):
        T5Embedder("somewhere", device="cpu")


def test_dir_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    (tmp_path / "sub").mkdir()
    names = ["img10.png", "img2.png", "sub/img1.png", "a.jpg", "b.txt"]
    for n in names:
        arr = rng.integers(0, 256, (40, 30, 3)).astype(np.uint8)
        if n.endswith((".png", ".jpg")):
            Image.fromarray(arr).save(tmp_path / n)
        else:
            (tmp_path / n).write_text("x")
    assert tfeat.list_images(str(tmp_path)) == jfeat.list_images(str(tmp_path))
    assert tfeat.natural_sort(["b10", "B2", "a1"]) == \
        jfeat.natural_sort(["b10", "B2", "a1"])
    paths = jfeat.list_images(str(tmp_path))
    np.testing.assert_array_equal(tfeat.load_images(paths, 24).numpy(),
                                  jfeat.load_images(paths, 24))
    feats = rng.normal(size=(7, 5)).astype(np.float32)
    np.savez(tmp_path / "f.npz", features=feats, radii=np.arange(7.0))
    for (ft, rt), (fj, rj) in zip([tfeat.load_npz_features(
            str(tmp_path / "f.npz"))], [jfeat.load_npz_features(
                str(tmp_path / "f.npz"))]):
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(rt, rj)
    got = tfeat.extract_dir_features(str(tmp_path / "f.npz"), None,
                                     how_many=4)
    np.testing.assert_array_equal(got.numpy(), feats[:4])
    with pytest.raises(FileNotFoundError):
        tfeat.extract_dir_features(str(tmp_path / "sub" / "none"),
                                   tclip.CLIPExtractor(None, tclip.CLIPGeom(
                                       **TINY), device="cpu"))


def test_backbone_census_checks():
    assert tinc.expected_state_dict_shapes() == jinc.expected_state_dict_shapes()
    assert tvgg.expected_state_dict_shapes() == jvgg.expected_state_dict_shapes()
    for mod, net, extra in ((tinc, tinc.InceptionPool3(), "fc.weight"),
                            (tvgg, tvgg.VGG16FC2(), "classifier.6.weight")):
        sd = {k: np.zeros(s, np.float32)
              for k, s in mod.expected_state_dict_shapes().items()}
        sd[extra] = np.zeros((3, 3), np.float32)        # ignored
        net.load_state_dict(sd)
        key = next(iter(sd))
        with pytest.raises(ValueError, match="missing"):
            net.load_state_dict({k: v for k, v in sd.items() if k != key})
        with pytest.raises(ValueError, match="differ"):
            net.load_state_dict(dict(sd, **{key: np.zeros(1, np.float32)}))
    # the module's own names are the canonical checkpoint's
    names = {k for k in tinc.InceptionPool3().state_dict()
             if not k.endswith("num_batches_tracked")}
    assert names == set(tinc.expected_state_dict_shapes())
    names = {k for k in tvgg.VGG16FC2().state_dict() if k not in ("mean",
                                                                   "std")}
    assert names == set(tvgg.expected_state_dict_shapes())
