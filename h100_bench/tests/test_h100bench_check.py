"""The comparison that decides ``correct``, on the CPU at tiny sizes: the
plain reference against the port's plain versions through a whole run, the
control (the reference at int4) failing where the program passes, the
planted faults turning ``correct`` false, and the acceptance walk's replay
on hand-made steps."""

import argparse
import io
import json

import numpy as np
import pytest
import torch

from h100_bench import check, faults, run
from h100_bench.reference import lantern
from h100_bench.tests import tiny

# limits for the tiny cells, from their readings (program: top1_gap
# 0.004-0.015, logit_err 0.03-0.06, support_rank 54-65 at top_k 64,
# walk_flips 0-3.7 % (at most one of 27-49 decisions); accepting every
# draft 31-59 %)
TINY = {"limits": {"top1_gap": 0.1, "logit_err": 0.3, "support_rank": 96,
                   "walk_flips": 15.0, "grammar": 0, "failed": 0},
        "floors": {"rows": 10, "walk_coins": 10}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"), limits=TINY)


def _run(root, cell, fault=None, seed=2 ** 31 + 11):
    line = {}

    def hook(h, w, cap, refs, nums):
        line["program"] = nums
        ctrl = check.reference_logits(h.cfg, w, cap, h.cfg_scale,
                                      torch.device("cpu"), wbits=4, kvbits=4)
        line["control"] = check.control_numbers(refs, ctrl)

    out = io.StringIO()
    torch.set_num_threads(2)
    ns = argparse.Namespace(workload=cell, seed=seed, seconds=1.0, trace=0)
    cfg = json.loads((root / "h100_bench" / "configs" / (
        "tiny_chameleon.json" if "lumina" in cell else "tiny_llamagen.json"))
        .read_text())
    if fault:
        with faults.planted(fault, cfg):
            rc = run.execute(ns, torch.device("cpu"), root=root, out=out,
                             hook=hook)
    else:
        rc = run.execute(ns, torch.device("cpu"), root=root, out=out,
                         hook=hook)
    assert rc == 0
    return json.loads(out.getvalue().splitlines()[-1]), line


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_program_passes_and_control_fails(root, cell):
    res, line = _run(root, cell)
    prog, ctrl = line["program"], line["control"]
    assert res["correct"], res["checks"]
    assert prog["rows"] >= TINY["floors"]["rows"]
    assert prog["top1_gap"] < 0.1 and prog["logit_err"] < 0.3
    # the control, put in the program's place, reads at least 3x higher on
    # one number and fails its limit
    assert (ctrl["logit_err"] >= 3 * prog["logit_err"]
            or ctrl["top1_gap"] >= 3 * prog["top1_gap"])
    assert not check.judge(dict(prog, **ctrl), TINY)["correct"]
    assert ("walk_flips" in prog) == (cell in tiny.SPEC)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_altered_token_fails(root, cell):
    res, _ = _run(root, cell, fault="token")
    assert not res["correct"]
    assert res["checks"]["support_rank"]["value"] > TINY["limits"][
        "support_rank"]


def test_stuck_step_fails(root):
    res, _ = _run(root, "tiny.lumina", fault="stuck")
    assert not res["correct"]
    assert res["checks"]["rows"]["value"] < TINY["floors"]["rows"]
    assert res["checks"]["walk_coins"]["value"] < TINY["floors"][
        "walk_coins"]


@pytest.mark.parametrize("cell", sorted(tiny.SPEC))
def test_accepting_every_draft_fails(root, cell):
    """The walk takes every draft, whatever its coins: only the replayed
    walk sees it (the tokens stay image tokens in grammar)."""
    res, line = _run(root, cell, fault="accept_all")
    assert not res["correct"]
    assert line["program"]["walk_flips"] > TINY["limits"]["walk_flips"]
    assert line["program"]["support_rank"] <= TINY["limits"]["support_rank"]


def _walk(p, near, k=1, delta=5.0):
    """A walk over image columns 0..4 of a 5-token vocabulary, no grammar,
    every served index with the same distribution ``p``."""
    P = np.tile(np.asarray(p, float), (4, 1))
    return lantern.Walk(P, np.full(4, -1), np.asarray(near), 0, 5, k, delta)


# a chain of two drafts (tokens 3 then 1) over the root, each of draft
# probability 1
CHAIN = dict(n=0, depth=2, tokens=np.array([0, 3, 1]),
             children=np.array([[1], [2], [-1]]), q=np.ones(3))


def test_walk_replays_the_relaxed_rule():
    p = [0.5, 0.2, 0.1, 0.15, 0.05]
    near = [[1, 2], [2, 0], [1, 0], [2, 0], [3, 0]]
    w = _walk(p, near)
    # p'(3) = 0.15 + p(2) = 0.25 (within 4 x 0.15), p'(1) = 0.2 + p(2) =
    # 0.3
    took_one = dict(CHAIN, alen=1, sel=np.array([0, 1, 0]))
    assert w.step(took_one, np.array([[0.2], [0.9]])) == [False, False]
    # a coin of 0.22 takes token 3 only through its neighbour
    assert w.step(took_one, np.array([[0.22], [0.9]])) == [False, False]
    # coins of 0.3 refuse token 3; 0.25 refuses token 1
    assert w.step(took_one, np.array([[0.3], [0.25]])) == [True, True]
    # taking both drafts: the second coin 0.9 is far above p'(1) = 0.3
    took_both = dict(CHAIN, alen=2, sel=np.array([0, 1, 2]))
    assert w.step(took_both, np.array([[0.2], [0.9]])) == [False, True]
    # refusing the first draft where the coin took it
    refused = dict(CHAIN, alen=0, sel=np.array([0, 0, 0]))
    assert w.step(refused, np.array([[0.05], [0.9]])) == [True]


def test_walk_tries_siblings_on_the_residual():
    """Two drafts of the root with draft probabilities: the second is
    judged on the residual that refusing the first leaves."""
    p = [0.1, 0.6, 0.1, 0.1, 0.1]
    near = [[2], [2], [3], [4], [0]]
    w = _walk(p, near, k=1, delta=1.0 + 1e-9)
    rec = dict(n=0, depth=1, tokens=np.array([0, 1, 2]),
               children=np.array([[1, 2], [-1, -1], [-1, -1]]),
               q=np.array([1.0, 0.6, 0.25]), alen=1, sel=np.array([0, 2]))
    # token 1 (p' = p = 0.6: delta just over 1 relaxes nothing; q 0.6) is
    # taken by the rule on any coin, so refusing it flips; the residual
    # max(p - q', 0) with q' = p removes all mass, so the walk restarts
    # from uniform: p(2) = 0.2, q 0.25, so a coin of 0.5 takes it (0.125 <=
    # 0.2) and 0.9 does not
    assert w.step(rec, np.array([[0.99, 0.5]])) == [True, False]
    assert w.step(rec, np.array([[0.99, 0.9]])) == [True, True]
    assert w.step(dict(rec, alen=0, sel=np.array([0, 0])),
                  np.array([[0.99, 0.9]])) == [True, False]
