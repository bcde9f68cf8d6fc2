"""``BENCHMARK.json`` against the contract, every file it names found by
name, and a new cell, mix and metric added as files and entries alone."""

import json
import re
from pathlib import Path

import pytest

from h100_bench import harness
from h100_bench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                    r"|_dim$|_rank$|expansion|experts_per_tok")


def test_keys_and_shapes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["h100_bench"]
    assert all(isinstance(w, str) and not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51
    cells = len(MAN["workloads"])
    full = 2 + 14 * 24
    assert full * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(MAN["configs"]) <= 24
    assert len(json.dumps(MAN)) <= 64 * 1024
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == cells
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert all(UNIT.match(m["unit"]) for m in MAN["end_to_end"]
               + MAN["per_layer"])
    assert all(m["better"] in ("lower", "higher")
               for m in MAN["end_to_end"] + MAN["per_layer"])


def test_every_file_found_by_name():
    bench = ROOT / "h100_bench"
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    for c in MAN["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("h100_bench/")
        assert cfg["source"] == c["source"] and cfg["reduced"] == []
        assert (bench / "families" / f"{cfg['family']}.py").is_file()
        assert (bench / "reference" / "families" /
                f"{cfg['family']}.py").is_file()
    for w in MAN["workloads"]:
        tr = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                        .read_text())
        assert (bench / "drivers" / f"{tr['driver']}.py").is_file()
        lim = json.loads((bench / "limits" / f"{w['name']}.json").read_text())
        walk = {"walk_flips"} if tr["mode"] != "ar" else set()
        assert set(lim["limits"]) == {"top1_gap", "logit_err", "support_rank",
                                      "grammar", "failed"} | walk
        assert set(lim["floors"]) == {"rows"} | {"walk_coins"} & (
            {"walk_coins"} if walk else set())
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_each_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        mine = [m["name"] for m in harness.metrics_of(MAN, w["name"], False)]
        assert "setup_s" in mine and len(mine) >= 2
        assert harness.metrics_of(MAN, w["name"], True)
    for m in MAN["per_layer"]:
        assert m["moves"] == "image_tokens_per_s" and m["workloads"]
        assert "workloads" not in e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in {w["name"] for w in MAN["workloads"]}


DUMMY_METRIC = '''"""Tokens a traced second: a metric added as a file of its own."""


def read(run):
    return run.tokens / run.window_s if run.window_s else None
'''


def test_new_cell_mix_and_metric_are_files_and_entries(tmp_path):
    """A configuration, a traffic mix, a cell, its limits and a per-layer
    metric added as files and entries only: the run finds them by name
    and reports the new metric."""
    root = tiny.make_root(tmp_path)
    (root / "h100_bench" / "metrics" / "dummy_tokens.py").write_text(
        DUMMY_METRIC)
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append(dict(
        name="dummy_tokens", unit="tokens/s", better="higher",
        source="host_clock", layer="serving loop",
        moves="image_tokens_per_s", workloads=["tiny.lumina"]))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    rc, res = tiny.run_cell(root, "tiny.lumina", trace=1)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["dummy_tokens"]["value"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_result_line(tmp_path, cell):
    """Both kinds of run print the contract's keys, the checks last."""
    root = tiny.make_root(tmp_path)
    for trace in (0, 1):
        rc, res = tiny.run_cell(root, cell, trace=trace)
        assert rc == 0
        assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                                 "device"] and list(res)[-1] == "checks"
        assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
        want = {m["name"] for m in harness.metrics_of(
            json.loads((root / "BENCHMARK.json").read_text()), cell,
            bool(trace))}
        assert set(res["metrics"]) <= want
        if not trace:
            assert {"image_tokens_per_s", "setup_s"} <= set(res["metrics"])
