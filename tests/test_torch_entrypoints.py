"""The port's command-line tasks against ``entrypoints_tpu`` on the CPU.

- ``utils.png``: images written with ``zlib`` alone read back byte for
  byte through ``zlib`` (and through PIL where it is installed);
- ``generate_images``: the same flags and defaults and the same prompt
  sources as the JAX task; ``run(args, device="cpu")`` against
  ``entrypoints_tpu.generate_images.run`` with both packages' configs
  monkeypatched to tiny ones and their random sessions to one set of
  weights (``convert``), under ``--top-k 1``: a single request and
  ``--slots 2``, the eagle and base types, static and dynamic trees,
  LlamaGen (caption and label) and Lumina, ``--lantern`` with the nearest
  table from the codebook, ``--quant int8 --kv-quant``, ``--total-tokens
  -1`` (both autotune timers replaced by one table) and ``--tree-choices``
  a json file written by ``optimize_tree``.  Every prompt's
  ``step_compression`` is the same, the json files have the same keys,
  the images are within one uint8 level, and no path imports PIL;
- ``generate_codebook``: the ``.npy`` table equals JAX's;
- ``generate_train_data``: the same flags; ``--codes-dir`` samples (with
  and without a caption) within 1e-4 of JAX's, and greedy self-generation
  alone and on ``--slots 2`` token-exact, its hiddens within 1e-4;
- ``train_drafter``: the same flags; on JAX's samples, with both
  packages' random base and drafter replaced by one set of weights,
  ``history.json`` within 1e-4 relative at ``--data-noise none``, and
  ``state_N`` written at the save epochs;
- the launcher: ``python -m lantern_tpu_torch generate_codebook --device
  cpu`` in a subprocess; ``--help`` lists the ported tasks, the training
  ones included, and not ``extract_code``.
"""

import argparse
import copy
import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import entrypoints_tpu.generate_codebook as jgc
import entrypoints_tpu.generate_images as jgi
import entrypoints_tpu.generate_train_data as jgt
import entrypoints_tpu.train_drafter as jtd
from lantern_tpu import configs as jc
from lantern_tpu import trees as jt
from lantern_tpu.engine import autotune as jat
from lantern_tpu.engine import session as js
from lantern_tpu.models import drafter as jdrf
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.models import vqgan as jvq
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.engine import autotune as tat
from lantern_tpu_torch.engine import session as ts
from lantern_tpu_torch.entrypoints import generate_codebook as tgc
from lantern_tpu_torch.entrypoints import generate_images as tgi
from lantern_tpu_torch.entrypoints import generate_train_data as tgt
from lantern_tpu_torch.entrypoints import train_drafter as ttd
from lantern_tpu_torch.models import drafter as tdrf
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.models import vqgan as tvq
from lantern_tpu_torch.models.item_processor import hash_tokenize
from lantern_tpu_torch.utils.png import encode_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LG_KW = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
             block_size=16, max_seq_len=96)
CH_KW = dict(vocab_size=8832, hidden_size=256, num_layers=2, num_heads=2,
             rope_kind="1d", cond_kind="none", qk_norm=True, swin_norm=True,
             max_seq_len=160)
VQ_KW = dict(ch=32, ch_mult=(1, 2), z_channels=16, codebook_dim=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny and the test workers share the cores: intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ png

def read_png(data: bytes) -> np.ndarray:
    """An RGB8 PNG of filter-0 rows -> uint8 [H, W, 3], checking every
    chunk's CRC, through ``zlib`` alone."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB",
                                                          chunks[0][1])
    assert (depth, color, comp, filt, inter) == (8, 2, 0, 0, 0)
    rows = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (16, 16), (3, 33)])
def test_png_reads_back(shape, tmp_path):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, size=shape + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(read_png(encode_png(img)), img)
    write_png(str(tmp_path / "a.png"), img)
    data = (tmp_path / "a.png").read_bytes()
    np.testing.assert_array_equal(read_png(data), img)
    with pytest.raises(ValueError):
        encode_png(img[..., :2])
    Image = pytest.importorskip("PIL.Image")
    with Image.open(str(tmp_path / "a.png")) as im:
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), img)


# ------------------------------------------------------------ flags, prompts

def _parser(mod):
    p = argparse.ArgumentParser()
    mod.add_args(p)
    return p


@pytest.mark.parametrize("mods", [(jgi, tgi), (jgc, tgc), (jgt, tgt),
                                  (jtd, ttd)])
def test_flags_match_jax(mods):
    pj, pt = (_parser(m) for m in mods)
    spec = [(a.dest, a.default, a.type, tuple(a.choices or ()), a.nargs,
             tuple(a.option_strings)) for a in pj._actions]
    assert [(a.dest, a.default, a.type, tuple(a.choices or ()), a.nargs,
             tuple(a.option_strings)) for a in pt._actions] == spec


def test_load_prompts_match_jax(tmp_path):
    tsv = tmp_path / "p.tsv"
    tsv.write_text("Prompt\tCategory\na red fox\tAnimals\ntwo owls\tAnimals\n")
    coco = tmp_path / "c.json"
    coco.write_text(json.dumps({"annotations": [{"caption": "a cat"},
                                                {"caption": "a dog"}]}))
    plain = tmp_path / "l.json"
    plain.write_text(json.dumps(["one", "two", "three"]))
    cases = [["--prompts", "a | b|c"], ["--labels", "3,7"],
             ["--prompts-file", str(tsv)], ["--prompts-file", str(coco)],
             ["--prompts-file", str(plain)]]
    for argv in cases:
        aj, at = _parser(jgi).parse_args(argv), _parser(tgi).parse_args(argv)
        assert tgi.load_prompts(at) == jgi.load_prompts(aj), argv


def test_run_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None would run on it")
    args = _parser(tgc).parse_args(["--model", "random", "--codebook-size",
                                    "8", "--codebook-dim", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tgc.run(args)


# ------------------------------------------------------------ generate_images

_PAIRS = {}
# the JAX sessions' own constructors, which the fixture below replaces
_JAX_RANDOM = (js.LlamaGenSession.random, js.ChameleonSession.random)


def _pair(kind):
    """``(jax session, port session)`` from one set of random weights, with
    the hidden-passthrough drafter and a tiny codec: LlamaGen ``label`` /
    ``caption``, or ``lumina``."""
    if kind in _PAIRS:
        return _PAIRS[kind]
    if kind == "lumina":
        cj, ct = jc.tiny_config(**CH_KW), tc.tiny_config(**CH_KW)
        J = _JAX_RANDOM[1](cj, jc.drafter_config(cj), seed=1,
                           family="lumina", grid=(4, 4))
        vq = dict(resolution=16, attn_resolutions=(8,), codebook_size=8192,
                  **VQ_KW)
        vj, vt = jvq.chameleon_vq_config(**vq), tvq.chameleon_vq_config(**vq)
    else:
        cj = jc.tiny_config(cond_kind=kind, **LG_KW)
        ct = tc.tiny_config(cond_kind=kind, **LG_KW)
        J = _JAX_RANDOM[0](cj, jc.drafter_config(cj), seed=0, with_vq=False)
        vq = dict(codebook_size=cj.vocab_size, **VQ_KW)
        vj, vt = jvq.VQGANConfig(**vq), tvq.VQGANConfig(**vq)
    J.vq_cfg, J.vq_params = vj, jvq.init_vqgan_params(jax.random.key(2), vj)
    pt = convert.convert_params(jax.tree.map(np.asarray, J.params),
                                device="cpu")
    dt = convert.convert_drafter_params(jax.tree.map(np.asarray, J.dparams),
                                        device="cpu", embed=pt["embed"])
    vpt = convert.convert_vqgan_params(jax.tree.map(np.asarray, J.vq_params),
                                       device="cpu")
    if kind == "lumina":
        J.tokenizer = tiny_tokenize
        T = ts.ChameleonSession(ct, tc.drafter_config(ct), pt, dt,
                                family="lumina", grid=(4, 4), vq_cfg=vt,
                                vq_params=vpt, tokenizer=tiny_tokenize,
                                passthrough_drafter=J.passthrough_drafter,
                                device="cpu")
    else:
        T = ts.LlamaGenSession(ct, tc.drafter_config(ct), pt, dt, vq_cfg=vt,
                               vq_params=vpt,
                               passthrough_drafter=J.passthrough_drafter,
                               device="cpu")
    _PAIRS[kind] = (J, T)
    return J, T


def tiny_tokenize(text):
    """``hash_tokenize`` folded into the tiny Chameleon vocab."""
    return [4 + t % 8192 for t in hash_tokenize(text)]


def _fake_random(which, kind=None):
    """A ``random`` classmethod that hands out a copy of the shared session
    (of ``kind``, else of the config's conditioning), with the drafter
    config that ``build_session`` asked for."""
    def random(cls, cfg, dcfg=None, seed=0, family=None, grid=None, **kw):
        base = _pair(kind or cfg.cond_kind)[which]
        s = copy.copy(base)
        s.params = dict(base.params)
        s.dcfg = dcfg
        s.dparams = base.dparams if dcfg is not None else None
        s.passthrough_drafter = base.passthrough_drafter and dcfg is not None
        if grid is not None:
            s.grid = grid
        return s
    return classmethod(random)


@pytest.fixture()
def tiny_cli(monkeypatch):
    """Both tasks' configs and random sessions replaced by the tiny shared
    ones; both autotune timers by one table of times."""
    for cfgmod, sessmod, which in ((jc, js, 0), (tc, ts, 1)):
        monkeypatch.setattr(
            cfgmod, "llamagen_config",
            lambda size, task, image_tokens=256, _m=cfgmod: _m.tiny_config(
                cond_kind="label" if task == "c2i" else "caption", **LG_KW))
        monkeypatch.setattr(cfgmod, "chameleon_7b_config",
                            lambda max_seq_len=4096, swin_norm=False, _m=cfgmod:
                            _m.tiny_config(**CH_KW))
        monkeypatch.setattr(sessmod.LlamaGenSession, "random",
                            _fake_random(which))
        monkeypatch.setattr(sessmod.ChameleonSession, "random",
                            _fake_random(which, "lumina"))
    table = dict(zip(tat.CANDIDATES, (1.0, 1.02, 1.1, 1.2, 1.3)))

    def fake_time(params, cfg, length, prefix=128, iters=20, rope=None):
        return table[length]
    monkeypatch.setattr(jat, "time_verify_forward", fake_time)
    monkeypatch.setattr(tat, "time_verify_forward", fake_time)
    return monkeypatch


def _tree_json(tmp_path):
    """A calibrated-shape tree file: ``optimize_tree`` over a 2-D rank
    matrix, written as the calibration scripts write it."""
    probs = np.array([[0.6, 0.2, 0.1, 0.05], [0.5, 0.2, 0.1, 0.05],
                      [0.4, 0.2, 0.1, 0.05]])
    paths = ttr.optimize_tree(probs, num_nodes=12, max_depth=4)
    assert [list(p) for p in paths] == [list(p) for p in
                                        jt.optimize_tree(probs, 12, 4)]
    path = tmp_path / "tree.json"
    path.write_text(json.dumps({"paths": [list(p) for p in paths]}))
    return str(path)


CASES = {
    # a caption, one request at a time, LANTERN from the codebook, int8
    # weights and KV, a tree from optimize_tree
    "caption_single": ["--prompts", "a red fox|two owls", "--lantern",
                       "--lantern-k", "10", "--quant", "int8", "--kv-quant",
                       "--tree-choices", "TREE_JSON"],
    # continuous batching on 2 slots (the native scheduler)
    "caption_slots": ["--prompts", "a red fox|two owls|an old train",
                      "--slots", "2", "--kv-quant"],
    # lockstep batched AR
    "caption_base_slots": ["--prompts", "a red fox|two owls|an old train",
                           "--model-type", "base", "--slots", "2"],
    # class labels, dynamic trees sized by the (stubbed) autotune
    "label_dynamic_autotune": ["--labels", "1,2", "--dynamic-tree",
                               "--total-tokens", "-1"],
    "lumina_single": ["--model", "lumina_mgpt", "--target-size", "64",
                      "--prompts", "a watercolor harbor", "--cfg", "3.0"],
    "lumina_slots": ["--model", "lumina_mgpt", "--target-size", "64",
                     "--prompts", "a cat|a dog", "--slots", "2",
                     "--cfg", "3.0"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_generate_images_matches_jax(tiny_cli, tmp_path, case, capsys):
    pytest.importorskip("PIL.Image")        # the JAX task saves through PIL
    from PIL import Image

    argv = ["--random-weights", "--top-k", "1"] + [
        _tree_json(tmp_path) if a == "TREE_JSON" else a for a in CASES[case]]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    aj = _parser(jgi).parse_args(argv + ["--output-dir", out_j])
    at = _parser(tgi).parse_args(argv + ["--output-dir", out_t])
    assert jgi.run(aj) == 0
    printed_j = capsys.readouterr().out
    with pytest.MonkeyPatch.context() as no_pil:
        # no path of the port's task imports PIL
        no_pil.setitem(sys.modules, "PIL", None)
        no_pil.setitem(sys.modules, "PIL.Image", None)
        assert tgi.run(at, device="cpu") == 0
    printed_t = capsys.readouterr().out
    if "-1" in argv:
        pick = [ln for ln in printed_j.splitlines() if "autotuned" in ln]
        assert pick and pick == [ln for ln in printed_t.splitlines()
                                 if "autotuned" in ln]
        assert pick == ["autotuned total_tokens=48"]

    n = len(tgi.load_prompts(at))
    name = f"global_statistics_0_{n}.json"
    sj = json.load(open(os.path.join(out_j, name)))
    st = json.load(open(os.path.join(out_t, name)))
    assert list(st) == list(sj) == [f"prompt_{i}" for i in range(n)]
    for key in sj:
        assert list(st[key]) == list(sj[key])
        assert st[key]["prompt"] == sj[key]["prompt"]
        assert st[key]["step_compression"] == pytest.approx(
            sj[key]["step_compression"], abs=1e-12)
        assert st[key]["latency"] > 0 and "error" not in st[key]
    gj = json.load(open(os.path.join(out_j, "generation_configs.json")))
    gt = json.load(open(os.path.join(out_t, "generation_configs.json")))
    assert list(gt) == list(gj)
    assert {k: v for k, v in gt.items() if k != "output_dir"} == {
        k: v for k, v in gj.items() if k != "output_dir"}
    for i in range(n):
        data = open(os.path.join(out_t, f"prompt_{i}.png"), "rb").read()
        got = read_png(data)
        with Image.open(os.path.join(out_j, f"prompt_{i}.png")) as im:
            want = np.asarray(im.convert("RGB"))
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, i


def test_generate_images_lantern_table_from_codebook(tiny_cli):
    """``--lantern`` with random weights: the session's nearest table is
    the codebook's, ``lantern_k + 1`` wide."""
    argv = ["--random-weights", "--lantern", "--lantern-k", "10"]
    sj = jgi.build_session(_parser(jgi).parse_args(argv))
    st = tgi.build_session(_parser(tgi).parse_args(argv), device="cpu")
    got = st.params["nearest_latents"]
    assert got.shape == (LG_KW["vocab_size"], 11) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(sj.params["nearest_latents"]))


# ------------------------------------------------------------ codebook

@pytest.mark.parametrize("extra", [[], ["--k", "9"], ["--k", "5",
                                                      "--l2-normalize"]])
def test_generate_codebook_matches_jax(tmp_path, extra):
    argv = ["--model", "random", "--codebook-size", "96", "--codebook-dim",
            "6"] + extra
    aj = _parser(jgc).parse_args(argv + ["--save-path", str(tmp_path / "j")])
    at = _parser(tgc).parse_args(argv + ["--save-path", str(tmp_path / "t")])
    assert jgc.run(aj) == 0 and tgc.run(at, device="cpu") == 0
    k = int(extra[1]) if extra else 95
    name = f"top_{k}_indices.npy"
    got = np.load(str(tmp_path / "t" / name))
    want = np.load(str(tmp_path / "j" / name))
    assert got.dtype == np.uint16 and got.shape == (96, k)
    np.testing.assert_array_equal(got, want)


def test_launcher_generate_codebook(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = tmp_path / "vqd"
    r = subprocess.run(
        [sys.executable, "-m", "lantern_tpu_torch", "generate_codebook",
         "--device", "cpu", "--model", "random", "--codebook-size", "64",
         "--codebook-dim", "4", "--save-path", str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    t = np.load(str(out / "top_63_indices.npy"))
    assert t.shape == (64, 63) and t.dtype == np.uint16
    at = _parser(tgc).parse_args(["--model", "random", "--codebook-size",
                                  "64", "--codebook-dim", "4", "--save-path",
                                  str(tmp_path / "inproc")])
    tgc.run(at, device="cpu")
    np.testing.assert_array_equal(
        t, np.load(str(tmp_path / "inproc" / "top_63_indices.npy")))
    # the launcher registers the ported tasks only
    r = subprocess.run([sys.executable, "-m", "lantern_tpu_torch", "--help"],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0
    for task in ("generate_images", "generate_codebook",
                 "generate_train_data", "train_drafter"):
        assert task in r.stdout, task
    assert "extract_code" not in r.stdout


# ------------------------------------------------------------ training CLI

def _npz(path):
    z = np.load(path)
    return {k: z[k] for k in z.files}


def _same_samples(dir_t, dir_j, n):
    names = sorted(os.listdir(dir_j))
    assert sorted(os.listdir(dir_t)) == names
    assert names == [f"sample_{i:06d}.npz" for i in range(n)]
    for name in names:
        t, j = _npz(os.path.join(dir_t, name)), _npz(os.path.join(dir_j, name))
        assert list(t) == list(j)
        for k in ("tokens", "loss_mask"):
            np.testing.assert_array_equal(t[k], j[k])
            assert t[k].dtype == j[k].dtype
        for k in ("hidden", "target"):
            assert t[k].dtype == j[k].dtype == np.float32
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-4)


def test_generate_train_data_codes_dir_matches_jax(tiny_cli, tmp_path):
    """VQ codes with a caption (valid rows first, as an extractor writes
    them) and without one."""
    rng = np.random.default_rng(0)
    codes = tmp_path / "codes"
    codes.mkdir()
    cfg = jc.tiny_config(cond_kind="caption", **LG_KW)
    for i, n in enumerate((3, 8, None)):
        z = {"codes": rng.integers(0, cfg.vocab_size, (4, 4)).astype(np.int32)}
        if n is not None:
            emb = np.zeros((cfg.cls_token_num, cfg.caption_dim), np.float32)
            emb[:n] = rng.normal(size=(n, cfg.caption_dim)) * 0.5
            mask = np.zeros((cfg.cls_token_num,), np.int64)
            mask[:n] = 1
            z.update(caption_emb=emb, caption_mask=mask)
        np.savez(str(codes / f"c{i}.npz"), **z)
    argv = ["--random-weights", "--codes-dir", str(codes)]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jgt.run(_parser(jgt).parse_args(argv + ["--save-dir", out_j])) == 0
    assert tgt.run(_parser(tgt).parse_args(argv + ["--save-dir", out_t]),
                   device="cpu") == 0
    _same_samples(out_t, out_j, 3)
    s = _npz(os.path.join(out_t, "sample_000000.npz"))
    T = cfg.cls_token_num + cfg.block_size - 1
    assert s["hidden"].shape == (T, cfg.hidden_size)
    assert s["loss_mask"].sum() == cfg.block_size


@pytest.mark.parametrize("slots", ["1", "2"])
def test_generate_train_data_self_generate_matches_jax(tiny_cli, tmp_path,
                                                       slots):
    argv = ["--random-weights", "--self-generate", "--prompts",
            "a red fox|two owls", "--num-samples", "3", "--temperature", "0",
            "--slots", slots]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jgt.run(_parser(jgt).parse_args(argv + ["--save-dir", out_j])) == 0
    assert tgt.run(_parser(tgt).parse_args(argv + ["--save-dir", out_t]),
                   device="cpu") == 0
    _same_samples(out_t, out_j, 3)


@pytest.fixture()
def one_drafter_init(monkeypatch):
    """The port's random base and drafter inits replaced by JAX's, from the
    same keys the JAX task uses, so both tasks train one set of weights."""
    def base(generator, cfg, dtype=None, device=None):
        seed = generator.initial_seed()
        P = jtfm.init_params(jax.random.key(seed),
                             jc.tiny_config(cond_kind="caption", **LG_KW))
        return convert.convert_params(jax.tree.map(np.asarray, P),
                                      device=device)

    def drafter(generator, dcfg, embed):
        cj = jc.tiny_config(cond_kind="caption", **LG_KW)
        D = jdrf.init_drafter_params(
            jax.random.key(generator.initial_seed()), jc.drafter_config(cj),
            jnp.asarray(embed.numpy()))
        return convert.convert_drafter_params(
            jax.tree.map(np.asarray, D), device=embed.device, embed=embed)

    monkeypatch.setattr(ttfm, "init_params", base)
    monkeypatch.setattr(tdrf, "init_drafter_params", drafter)


def test_train_drafter_history_matches_jax(tiny_cli, one_drafter_init,
                                           tmp_path):
    data = str(tmp_path / "data")
    gen = ["--random-weights", "--self-generate", "--prompts",
           "a red fox|two owls|an old train", "--num-samples", "5",
           "--top-k", "8", "--save-dir", data]
    assert jgt.run(_parser(jgt).parse_args(gen)) == 0
    argv = ["--data-dir", data, "--bs", "2", "--num-epochs", "3",
            "--max-len", "24", "--data-noise", "none", "--lr", "3e-3",
            "--warmup-steps-ratio", "0.2", "--save-freq", "2", "--seed", "1"]
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jtd.run(_parser(jtd).parse_args(argv + ["--save-dir", out_j])) == 0
    assert ttd.run(_parser(ttd).parse_args(argv + ["--save-dir", out_t]),
                   device="cpu") == 0
    hj = json.load(open(os.path.join(out_j, "history.json")))
    ht = json.load(open(os.path.join(out_t, "history.json")))
    assert [list(h) for h in ht] == [list(h) for h in hj]
    assert [h["epoch"] for h in ht] == [0, 1, 2]
    for a, b in zip(ht, hj):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["top1"] == pytest.approx(b["top1"], rel=1e-4)
    assert sorted(d for d in os.listdir(out_t) if d.startswith("state_")) == [
        "state_2", "state_3"]
    from lantern_tpu_torch.utils.checkpoint import restore_pytree

    saved = restore_pytree(os.path.join(out_t, "state_3"), device="cpu")
    assert saved["dparams"]["fc_w"].shape == (2 * LG_KW["hidden_size"],
                                              LG_KW["hidden_size"])
