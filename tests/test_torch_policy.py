"""The port's serving policy against ``lantern_tpu`` on the CPU.

- ``engine/policy.serving_plan`` against the JAX rule for slots 0..32 and
  the geometries ``llamagen_xl``, ``lumina_7b`` and an unknown name, once
  under the port's table and once under the JAX table (each patched into
  both modules), so the rule is held apart from the numbers; every entry
  of the port's table names a tree ``trees.get_tree`` builds, or AR;
- ``generate_batch(tree="auto")`` of ``LlamaGenSession`` and
  ``ChameleonSession`` on the tiny configs of
  ``tests/test_torch_sessions.py`` (greedy, 1, 2 or 4 slots) against the
  JAX sessions under one table patched into both policy modules, with a
  ``("spec", tree)`` entry, an ``("ar", None)`` entry and Lumina's
  ``"calibrated"``: tokens equal, and steps in spec mode; the cases that
  never ask the policy (LlamaGen dynamic and AR, Chameleon AR) under a
  table that raises if asked;
- ``engine/sweep``: ``pick_winners`` and ``within_spread`` on synthetic
  rows (medians, a tie, the spread flag), its ``main`` on a tiny XL and a
  tiny Lumina config printing the documented schema, and a failing
  candidate failing the sweep;
- ``generate_images --tree-choices auto --slots 2`` against
  ``entrypoints_tpu`` through the harness of
  ``tests/test_torch_entrypoints.py``.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from lantern_tpu.engine import policy as jpol
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import trees as ttr
from lantern_tpu_torch.engine import policy as tpol
from lantern_tpu_torch.engine import sweep

from test_torch_entrypoints import _parser, jgi, read_png, tgi, tiny_cli  # noqa: F401
from test_torch_sessions import GREEDY, MAX_NEW, chameleon, llamagen
from test_torch_sessions import same_requests

GEOMETRIES = ("llamagen_xl", "lumina_7b", "an_unknown_geometry")
# one table for both packages: a spec entry, an AR entry and "calibrated"
SHARED = {
    "llamagen_xl": {1: ("spec", "chain"), 2: ("ar", None),
                    4: ("spec", "chain_bush_8")},
    "lumina_7b": {1: ("spec", "calibrated"), 2: ("ar", None),
                  4: ("spec", "chain_bush_8")},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny and the test workers share the cores: intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def patch_tables(monkeypatch, table) -> None:
    monkeypatch.setattr(jpol, "MEASURED_BEST", copy.deepcopy(table))
    monkeypatch.setattr(tpol, "MEASURED_BEST", copy.deepcopy(table))


# ------------------------------------------------------------ the rule

@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("table", ["port", "jax"])
def test_serving_plan_matches_jax(monkeypatch, table, geometry):
    patch_tables(monkeypatch, tpol.MEASURED_BEST if table == "port"
                 else jpol.MEASURED_BEST)
    for slots in range(33):
        assert (tpol.serving_plan(slots, geometry)
                == jpol.serving_plan(slots, geometry)), slots
    assert tpol.serving_plan(3) == jpol.serving_plan(3)


def test_measured_best_names_buildable_trees():
    """The sweep's keys, and every entry a library tree, the calibrated
    Lumina tree or lockstep AR."""
    assert sorted(tpol.MEASURED_BEST) == ["llamagen_xl", "lumina_7b"]
    assert sorted(tpol.MEASURED_BEST["llamagen_xl"]) == [1, 4, 8, 16]
    assert sorted(tpol.MEASURED_BEST["lumina_7b"]) == [1, 2, 4]
    for table in tpol.MEASURED_BEST.values():
        for mode, tree in table.values():
            assert (mode, tree) == ("ar", None) or mode == "spec"
            if mode == "spec":
                ttr.get_tree(tpol.resolve_tree(tree))
    assert os.path.exists(tpol.CALIBRATED_LUMINA)
    assert tpol.resolve_tree("calibrated") == tpol.CALIBRATED_LUMINA


# ------------------------------------------------- generate_batch("auto")

def _pair(what):
    return llamagen("label") if what == "label" else chameleon("lumina")


def _prompts(what):
    return ([1, 4, 7, 2, 9] if what == "label"
            else [[12], [12, 33], [12, 33, 7]])


@pytest.mark.parametrize("what, mode, slots", [
    ("label", "static", 1), ("label", "static", 2), ("label", "static", 4),
    ("lumina", "static", 1), ("lumina", "static", 2),
    ("lumina", "dynamic", 4)])
def test_generate_batch_auto_matches_jax(monkeypatch, what, mode, slots):
    """Under one table the sessions take the same plan (the table's tree,
    or lockstep AR) and serve the same requests: tokens equal, and steps
    wherever the plan is speculative."""
    patch_tables(monkeypatch, SHARED)
    J, T = _pair(what)
    kw = dict(slots=slots, max_new=MAX_NEW, mode=mode, tree="auto", seed=40,
              **GREEDY)
    ref = J.generate_batch(_prompts(what), **kw)
    got = T.generate_batch(_prompts(what), **kw)
    plan = tpol.serving_plan(slots, "llamagen_xl" if what == "label"
                             else "lumina_7b")
    same_requests(got, ref, steps=plan[0] == "spec")
    if plan[0] == "ar":
        assert all(r.steps == MAX_NEW for r in got)


@pytest.mark.parametrize("what, mode", [("label", "dynamic"),
                                        ("label", "ar"), ("lumina", "ar")])
def test_generate_batch_auto_without_the_policy(monkeypatch, what, mode):
    """Where the JAX session asks no policy (a LlamaGen session in dynamic
    or AR mode: the slot-count rule; a Chameleon session in AR mode) the
    port asks none either: a table that raises if read, and the JAX
    session's requests."""
    patch_tables(monkeypatch, {})
    J, T = _pair(what)
    kw = dict(slots=2, max_new=MAX_NEW, mode=mode, tree="auto", seed=41,
              **GREEDY)
    same_requests(T.generate_batch(_prompts(what), **kw),
                  J.generate_batch(_prompts(what), **kw),
                  steps=mode != "ar")


# ---------------------------------------------------------------- sweep

def _rows(points):
    """Synthetic sweep rows: ``{(R, config): [tok_s per repeat]}``."""
    return [dict(geom="xl", R=R, config=c, tok_s=v, compression=1.5,
                 repeat=i)
            for (R, c), vs in points.items() for i, v in enumerate(vs)]


def test_pick_winners_medians_ties_and_spread():
    rows = _rows({
        # clear: the winner's minimum above the runner-up's maximum
        (1, "spec:chain"): [30.0, 32.0, 31.0], (1, "ar"): [20.0, 21.0, 22.0],
        # the median wins where the mean would not; within spread
        (4, "spec:chain_bush_8"): [50.0, 52.0, 90.0],
        (4, "ar"): [55.0, 56.0, 57.0],
        # equal medians: the higher minimum wins
        (8, "spec:chain"): [40.0, 60.0, 80.0], (8, "ar"): [59.0, 60.0, 61.0],
        # equal in all: the candidate that came first
        (16, "spec:chain"): [70.0, 70.0, 70.0], (16, "ar"): [70.0] * 3})
    assert sweep.pick_winners(rows) == {1: ("spec", "chain"),
                                        4: ("ar", None),
                                        8: ("ar", None),
                                        16: ("spec", "chain")}
    assert sweep.within_spread(rows) == [4, 8, 16]
    summary = {(p["R"], p["config"]): p for p in sweep.summarize(rows)}
    p = summary[4, "spec:chain_bush_8"]
    assert (p["median_tok_s"], p["min_tok_s"], p["max_tok_s"]) == (
        52.0, 50.0, 90.0)
    assert p["compression"] == 1.5


TINY_XL = dict(cond_kind="caption", vocab_size=256, hidden_size=256,
               num_layers=2, num_heads=4, block_size=16, max_seq_len=96)
TINY_LUMINA = dict(vocab_size=65536, hidden_size=256, num_layers=2,
                   num_heads=2, rope_kind="1d", cond_kind="none",
                   qk_norm=True, swin_norm=True)


@pytest.fixture()
def tiny_geometries(monkeypatch):
    monkeypatch.setattr(tc, "llamagen_config",
                        lambda size, task, image_tokens=256:
                        tc.tiny_config(**TINY_XL))
    monkeypatch.setattr(tc, "chameleon_7b_config",
                        lambda max_seq_len=4096, swin_norm=False:
                        tc.tiny_config(max_seq_len=max_seq_len, **TINY_LUMINA))


@pytest.mark.parametrize("argv", [
    ["--geom", "xl", "--rs", "2", "--trees", "chain_bush_8", "--tokens", "4"],
    ["--geom", "lumina", "--rs", "1", "--trees", "chain", "--grid", "2"]],
    ids=["xl", "lumina"])
def test_sweep_main_prints_its_schema(tiny_geometries, capsys, argv):
    """One JSON line a timed run, then the summary; the winners are
    ``pick_winners`` of those rows."""
    assert sweep.main(argv + ["--repeats", "1", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rows, last = lines[:-1], lines[-1]
    tree = argv[argv.index("--trees") + 1]
    assert [r["config"] for r in rows] == [f"spec:{tree}", "ar"]
    for r in rows:
        assert set(r) == {"geom", "R", "config", "tok_s", "compression",
                          "repeat"}
        assert r["geom"] == argv[1] and r["R"] == int(argv[3])
        assert r["tok_s"] > 0 and r["compression"] >= 1.0
        assert r["repeat"] == 0
    assert rows[1]["compression"] == 1.0
    assert set(last) == {"summary", "winners", "within_spread", "device"}
    assert [p["config"] for p in last["summary"]] == [r["config"]
                                                      for r in rows]
    for p in last["summary"]:
        assert set(p) == {"geom", "R", "config", "median_tok_s", "min_tok_s",
                          "max_tok_s", "compression"}
    assert last["winners"] == {str(R): list(w) for R, w in
                               sweep.pick_winners(rows).items()}
    assert last["device"] == "cpu"


def test_sweep_fails_on_a_failing_candidate(tiny_geometries):
    """No point is caught and noted: a candidate that fails fails the run."""
    with pytest.raises(KeyError):
        sweep.main(["--geom", "xl", "--rs", "1", "--trees", "no_such_tree",
                    "--tokens", "4", "--repeats", "1", "--device", "cpu"])


# -------------------------------------------------------- the image CLI

@pytest.mark.parametrize("model, plan", [
    ("caption", ("spec", "chain_bush_8")), ("caption", ("ar", None)),
    ("lumina", ("spec", "calibrated"))])
def test_generate_images_tree_auto_matches_jax(tiny_cli, tmp_path, model,
                                               plan):
    """``--tree-choices auto --slots 2`` (``run.sh``'s recipe) reaches the
    policy in both tasks: the same step compression per prompt, images
    within one uint8 level."""
    from PIL import Image

    table = copy.deepcopy(SHARED)
    table["llamagen_xl" if model == "caption" else "lumina_7b"][2] = plan
    patch_tables(tiny_cli, table)
    argv = ["--random-weights", "--top-k", "1", "--tree-choices", "auto",
            "--slots", "2", "--kv-quant"]
    argv += (["--prompts", "a red fox|two owls|an old train"]
             if model == "caption" else
             ["--model", "lumina_mgpt", "--target-size", "64", "--prompts",
              "a cat|a dog", "--cfg", "3.0"])
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jgi.run(_parser(jgi).parse_args(argv + ["--output-dir", out_j])) == 0
    assert tgi.run(_parser(tgi).parse_args(argv + ["--output-dir", out_t]),
                   device="cpu") == 0
    n = len(argv[argv.index("--prompts") + 1].split("|"))
    name = f"global_statistics_0_{n}.json"
    sj = json.load(open(os.path.join(out_j, name)))
    st = json.load(open(os.path.join(out_t, name)))
    assert list(st) == list(sj) == [f"prompt_{i}" for i in range(n)]
    for key in sj:
        assert "error" not in st[key] and "error" not in sj[key]
        assert st[key]["step_compression"] == pytest.approx(
            sj[key]["step_compression"], abs=1e-12)
        if plan[0] == "ar":
            assert st[key]["step_compression"] == 1.0
    for i in range(n):
        got = read_png(open(os.path.join(out_t, f"prompt_{i}.png"),
                            "rb").read())
        with Image.open(os.path.join(out_j, f"prompt_{i}.png")) as im:
            want = np.asarray(im.convert("RGB"))
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, i
