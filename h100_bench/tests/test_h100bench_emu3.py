"""The Emu3 cell's files on the CPU at a tiny size (``tiny_emu3``): a run
of the deep driver is ``correct``; the control (the reference at int4) and
the ``token`` and ``accept_all`` faults fail it; a slot retired at its last
row end leaves a grammar-clean stream without its end of frame; the two
FSM metrics read nothing where there is nothing to read."""

import argparse
import io
import json

import numpy as np
import pytest
import torch

from h100_bench import check, faults, harness, run
from h100_bench.reference.families import grammar_violations
from h100_bench.tests import tiny_emu3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_emu3.make_root(tmp_path_factory.mktemp("bench_emu3"))


def _run(root, fault=None, seed=2 ** 31 + 11, trace=0):
    line = {}

    def hook(h, w, cap, refs, nums):
        line["program"] = nums
        line["checked"] = h.checked
        ctrl = check.reference_logits(h.cfg, w, cap, h.cfg_scale,
                                      torch.device("cpu"), wbits=4, kvbits=4)
        line["control"] = check.judge(dict(nums, **check.control_numbers(
            refs, ctrl)), check.limits(tiny_emu3.CELL, root))["correct"]

    out = io.StringIO()
    torch.set_num_threads(2)
    ns = argparse.Namespace(workload=tiny_emu3.CELL, seed=seed, seconds=1.0,
                            trace=trace)
    if fault:
        with faults.planted(fault, tiny_emu3.EMU3):
            rc = run.execute(ns, torch.device("cpu"), root=root, out=out,
                             hook=hook)
    else:
        rc = run.execute(ns, torch.device("cpu"), root=root, out=out,
                         hook=hook)
    assert rc == 0
    return json.loads(out.getvalue().splitlines()[-1]), line


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 33 + 5])
def test_program_passes_and_control_fails(root, seed):
    res, line = _run(root, seed=seed)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["checks"]["grammar"]["value"] == 0
    assert not line["control"]


@pytest.mark.parametrize("fault", ["token", "accept_all"])
def test_faults_fail(root, fault):
    res, _ = _run(root, fault=fault)
    assert not res["correct"], res["checks"]


def test_retired_slot_is_grammar_clean(root):
    """Every checked request, the one in flight from two rows in and the
    refills: its prefix and served tokens keep the grammar; one retired
    at its image's last row end serves that row end last and no end of
    frame."""
    _, line = _run(root)
    im = tiny_emu3.EMU3["image"]
    last = im["grid"][0] * (im["grid"][1] + 1)
    done = 0
    for c in line["checked"]:
        prefix = np.asarray(c["desc"]["prefix_ids"], np.int64)
        whole = np.concatenate([prefix, c["served"]])
        assert grammar_violations(tiny_emu3.EMU3, whole) == 0
        assert len(whole) <= last
        if len(whole) == last:
            done += 1
            assert c["served"][-1] == im["row_end_id"]
            assert im["end_id"] not in c["served"]
    assert done >= 1 and any(len(c["desc"]["prefix_ids"])
                             for c in line["checked"])


def test_fsm_metrics_read_nothing_without_a_device_trace(root):
    res, _ = _run(root, trace=1)
    assert res["correct"]
    man = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in harness.metrics_of(man, tiny_emu3.CELL, True)}
    assert {"idle_fsm_share", "fsm_syncs_per_step"} <= want
    # no device trace on the CPU: the FSM's metrics are left out
    assert not {"idle_fsm_share", "fsm_syncs_per_step"} & set(res["metrics"])
