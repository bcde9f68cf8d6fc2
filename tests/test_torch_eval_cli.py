"""The port's ``extract_code`` and eval tasks against ``entrypoints_tpu`` on
the CPU, on the same files.

- ``T5Embedder`` against the JAX one on a tiny T5 written here
  (``T5Config(d_model=32, num_layers=2)`` and a ``tokenizers`` WordLevel
  tokenizer saved as ``PreTrainedTokenizerFast``): embeddings within 1e-6,
  masks equal; ``LlamaGenSession.from_pretrained(t5_dir=...)`` builds it;
- ``extract_code``: the port's task with ``--device cpu`` and the JAX task
  with the same ``--vq-path`` (a VQ-16 at its published width in
  LlamaGen's names, and a Chameleon VQGAN in taming's), captions through
  ``RandomT5`` and through ``--t5-dir``, PNG and JPEG inputs of odd sizes:
  the same ``.npz`` keys, dtypes and values, codes equal;
- ``eval_fid_clip`` (``clip_b32`` with CLIP score, and ``fid_inception``
  on ``.npz`` features), ``eval_prec_recall`` (``vgg16_jax`` at full
  width, and a saved manifold) and ``eval_hpsv2`` (the pinned backbone):
  the printed scores within 1e-6 relative of the JAX tasks', on the same
  images, ``.npz`` weights and merges file; the CLIP geometries are
  replaced by one tiny geometry in both packages;
- the four new tasks without ``--device`` raise on a machine with no card.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from entrypoints_tpu import evals as jev
from entrypoints_tpu import extract_code as jx
from lantern_tpu.evals import clip as jclip
from lantern_tpu.models import vqgan as jvq
from lantern_tpu.utils import t5 as jt5
from lantern_tpu_torch.__main__ import main as launcher
from lantern_tpu_torch.entrypoints import evals as tev
from lantern_tpu_torch.entrypoints import extract_code as tx
from lantern_tpu_torch.evals import clip as tclip
from lantern_tpu_torch.evals import vgg as tvgg
from lantern_tpu_torch.utils import t5 as tt5

from test_torch_codecs import to_llamagen_names

MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("t", "h"),
          ("th", "e</w>"), ("c", "a"), ("ca", "t</w>"), ("o", "x</w>")]
# one tiny CLIP for both packages' pinned geometries (vocab: 512 byte
# symbols + the merges + 2 specials; ctx: the tokenizer's 77)
TINY = dict(vision_width=32, vision_layers=2, vision_heads=2, patch=16,
            image_size=32, embed_dim=16, text_width=32, text_layers=2,
            text_heads=2, vocab=522, ctx=77)
CAPTIONS = ["a red fox in the snow", "two cats on a hat", "hello box",
            "the cat", "an owl", "the end"]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_tiny_t5(path):
    """A 2-layer, 32-wide T5 encoder and a WordLevel tokenizer, saved as a
    ``transformers`` directory."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast, T5Config, T5EncoderModel

    words = sorted({w for c in CAPTIONS for w in c.split()})
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(words)})
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tk, pad_token="<pad>",
                            eos_token="</s>", unk_token="<unk>"
                            ).save_pretrained(path)
    torch.manual_seed(0)
    T5EncoderModel(T5Config(vocab_size=len(vocab), d_model=32, d_kv=8,
                            d_ff=64, num_layers=2, num_heads=4)
                   ).save_pretrained(path)
    return str(path)


def test_t5_embedder_matches_jax(tmp_path):
    d = write_tiny_t5(tmp_path / "t5")
    et, mt = tt5.T5Embedder(d, device="cpu").get_text_embeddings(CAPTIONS)
    ej, mj = jt5.T5Embedder(d).get_text_embeddings(CAPTIONS)
    assert et.shape == (len(CAPTIONS), 120, 32) and et.dtype == np.float32
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mt, mj)
    assert mt.dtype == mj.dtype


def _args(mod, argv):
    import argparse

    p = argparse.ArgumentParser()
    mod.add_args(p)
    return p.parse_args(argv)


def _same_npz_dirs(a, b):
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names and names
    for n in names:
        za, zb = np.load(os.path.join(a, n)), np.load(os.path.join(b, n))
        assert za.files == zb.files
        for k in za.files:
            assert za[k].dtype == zb[k].dtype, (n, k)
            if k == "caption_emb":
                np.testing.assert_allclose(za[k], zb[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(za[k], zb[k])


@pytest.mark.parametrize("model", ["llamagen", "anole"])
def test_extract_code_matches_jax(model, tmp_path):
    rng = np.random.default_rng(0)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i, (h, w) in enumerate([(40, 52), (33, 33), (64, 30), (50, 45),
                                (20, 20)]):
        a = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(a).save(imgs / (f"im{i}.jpg" if i == 3
                                        else f"im{i}.png"))
    (imgs / "notes.txt").write_text("not an image")
    caps = tmp_path / "caps.json"
    caps.write_text(json.dumps({"images": [{"id": 7, "file_name": "im0.png"},
                                           {"id": 9, "file_name": "im3.jpg"}],
                                "annotations": [
                                    {"image_id": 7, "caption": CAPTIONS[0]},
                                    {"image_id": 9, "caption": CAPTIONS[1]}]}))
    if model == "llamagen":
        cfg = jvq.vq16_config()
        sd = to_llamagen_names(jvq.random_taming_state_dict(cfg, 1),
                               len(cfg.ch_mult))
    else:
        sd = jvq.random_taming_state_dict(jvq.chameleon_vq_config(), 1)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "vq.pt")
    argv = ["--model", model, "--images-dir", str(imgs), "--captions-json",
            str(caps), "--vq-path", str(tmp_path / "vq.pt"), "--image-size",
            "32", "--limit", "4"]
    runs = [("rand", [])]
    if model == "llamagen":
        runs.append(("t5", ["--t5-dir", write_tiny_t5(tmp_path / "t5")]))
    for tag, extra in runs:
        tx.run(_args(tx, argv + extra + ["--save-dir", str(tmp_path / f"t{tag}")]),
               device="cpu")
        jx.run(_args(jx, argv + extra + ["--save-dir", str(tmp_path / f"j{tag}")]))
        _same_npz_dirs(str(tmp_path / f"t{tag}"), str(tmp_path / f"j{tag}"))
    z = np.load(tmp_path / "trand" / "im0.npz")
    assert z["codes"].dtype == np.int32 and z["codes"].shape == (4,)
    assert z["caption_emb"].shape == (120, 2048)
    assert z["caption_mask"].dtype == np.int64
    assert "caption_emb" not in np.load(tmp_path / "trand" / "im1.npz").files
    assert sorted(os.listdir(tmp_path / "trand")) == [
        "im0.npz", "im1.npz", "im2.npz", "im3.npz"]


def _images(d, n, seed, size=(40, 36)):
    """``prompt_<i>.png``: noise around a colour of its own, so features
    differ from image to image."""
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        a = rng.normal(rng.uniform(20, 235, 3), 30, size + (3,))
        Image.fromarray(np.clip(a, 0, 255).astype(np.uint8)
                        ).save(d / f"prompt_{i}.png")
    return str(d)


@pytest.fixture
def clip_files(tmp_path, monkeypatch):
    """One tiny CLIP geometry for ``VIT_B32`` and ``VIT_H14`` in both
    packages, its random weights as ``.npz``, and a merges file."""
    for name in ("VIT_B32", "VIT_H14"):
        monkeypatch.setattr(tclip, name, tclip.CLIPGeom(**TINY))
        monkeypatch.setattr(jclip, name, jclip.CLIPGeom(**TINY))
    w = tmp_path / "clip.npz"
    sd = tclip.random_state_dict(tclip.CLIPGeom(**TINY), seed=3)
    # image and text embeddings share a direction, so cosines are well
    # away from 0, as real CLIP scores are: random towers give
    # near-orthogonal embeddings, whose cosine keeps only the f32 noise
    sd["visual.ln_post.bias"] = np.full(32, 1.0, np.float32)
    # and the image embedding is the patches' (a zero class token attends
    # uniformly), not the class token's
    sd["visual.class_embedding"][:] = 0
    sd["visual.positional_embedding"][0] = 0
    sd["ln_final.bias"] = np.full(32, 2.0, np.float32)
    sd["text_projection"] = sd["visual.proj"].copy()
    np.savez(w, **sd)
    merges = tmp_path / "merges.txt"
    merges.write_text("#version: 0.2\n"
                      + "\n".join(f"{a} {b}" for a, b in MERGES))
    caps = tmp_path / "caps.json"
    caps.write_text(json.dumps([[c] for c in CAPTIONS]))
    return str(w), str(merges), str(caps)


def _scores(text):
    out = {}
    for line in text.splitlines():
        if ": " in line and not line.startswith(("writing", "warning",
                                                 "Image Path")):
            k, v = line.rsplit(": ", 1)
            out[k] = float(v)
        else:
            try:
                out["value"] = float(line)
            except ValueError:
                pass
    return out


def _same_scores(t, j):
    assert t.keys() == j.keys() and t, (t, j)
    for k in t:
        assert abs(t[k] - j[k]) <= 1e-6 * max(abs(j[k]), 1e-12), (k, t, j)


def _run_both(task, argv, capsys):
    tev.run(task, argv + ["--device", "cpu"])
    t = _scores(capsys.readouterr().out)
    jev.run(task, argv)
    return t, _scores(capsys.readouterr().out)


def test_eval_fid_clip_matches_jax(tmp_path, clip_files, capsys,
                                   monkeypatch):
    w, merges, caps = clip_files
    fake, ref = _images(tmp_path / "fake", 5, 0), _images(tmp_path / "ref",
                                                          6, 1, (30, 50))
    argv = ["--fake_dir", fake, "--ref_dir", ref, "--caption_path", caps,
            "--eval_res", "48", "--batch_size", "2", "--clip-model-dir", w,
            "--merges", merges]
    t, j = _run_both("eval_fid_clip", argv, capsys)
    assert set(t) == {"CLIP score", "FID_48px"}
    _same_scores(t, j)
    assert open(os.path.join(fake, "score.txt")).read().startswith(
        "CLIP score: ")
    # the pinned FID backbone on precomputed features: no network runs,
    # and the score file goes to the working directory
    monkeypatch.chdir(tmp_path)
    feats = np.random.default_rng(2).normal(size=(2, 9, 12))
    np.savez(tmp_path / "a.npz", features=feats[0])
    np.savez(tmp_path / "b.npz", features=feats[1] + 0.5)
    argv = ["--fake_dir", str(tmp_path / "a.npz"), "--ref_dir",
            str(tmp_path / "b.npz"), "--feature-extractor", "fid_inception"]
    t, j = _run_both("eval_fid_clip", argv, capsys)
    assert set(t) == {"FID_256px"}
    _same_scores(t, j)
    assert (tmp_path / "score.txt").read_text().startswith("FID_256px: ")


def test_eval_prec_recall_matches_jax(tmp_path, capsys):
    w = tmp_path / "vgg.npz"
    np.savez(w, **tvgg.random_state_dict(seed=1))
    fake, ref = _images(tmp_path / "fake", 6, 3), _images(tmp_path / "ref",
                                                          7, 4, (30, 50))
    base = ["--feature-extractor", "vgg16_jax", "--vgg-ckpt", str(w),
            "--eval_res", "32", "--k", "2"]
    t, j = _run_both("eval_prec_recall",
                     base + ["--ref_dir", ref, "--fake_dir", fake], capsys)
    assert set(t) == {"precision", "recall"}
    _same_scores(t, j)
    man = str(tmp_path / "man.npz")
    tev.run("eval_prec_recall", base + ["--ref_dir", ref, "--fname_precalc",
                                        man, "--device", "cpu"])
    t, j = _run_both("eval_prec_recall", base + ["--ref_dir", man,
                                                 "--fake_dir", fake], capsys)
    _same_scores(t, j)


def test_eval_hpsv2_matches_jax(tmp_path, clip_files, capsys):
    w, merges, caps = clip_files
    imgs = _images(tmp_path / "imgs", 4, 5)
    argv = ["--image_path", imgs, "--prompt_path", caps, "--model", w,
            "--merges", merges, "--batch_size", "3"]
    t, j = _run_both("eval_hpsv2", argv, capsys)
    _same_scores(t, j)
    with pytest.raises(SystemExit, match="pinned needs --model"):
        tev.run("eval_hpsv2", ["--image_path", imgs, "--prompt_path", caps,
                               "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["extract_code", "--images-dir", "."],
    ["eval_fid_clip", "--fake_dir", "a.npz", "--ref_dir", "b.npz"],
    ["eval_prec_recall", "--ref_dir", "a.npz"],
    ["eval_hpsv2", "--image_path", ".", "--prompt_path", "p.json"]],
    ids=lambda a: a[0])
def test_new_tasks_default_to_the_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        launcher(argv)
