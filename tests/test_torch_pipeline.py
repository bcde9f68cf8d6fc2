"""The port's GPipe pipeline (``lantern_tpu_torch/parallel/pipeline.py``)
against ``lantern_tpu``'s, the counterpart of ``tests/test_pipeline.py``.

On ``test_pipeline.py``'s ``nano`` 4-layer config (f32, the same seeded
weights through ``convert.convert_params``) and batch, the stages run as
gloo rank processes (``tests/torch_train_ranks.py``: file stores, a time
limit a rank):

- ``(pp, n_micro)`` in (2, 2), (4, 4), (2, 4) and (dp = 2, pp = 2): loss
  and accuracy against JAX's ``token_loss`` and JAX's pipeline at
  ``test_pipeline.py``'s tolerances, byte-equal on every rank; the merged
  layer gradients and the ``embed`` / ``lm_head`` gradients (summed over
  pp and dp) against ``jax.grad`` of ``token_loss``;
- a per-row and a shared ``[1, T]`` ``attn_valid``;
- two ``make_train_step`` steps against JAX's, parameter for parameter;
- ``split_stages`` / ``merge_stages`` and their ``ValueError``, and a
  ``cond`` batch refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import torch_train_ranks as ranks
from lantern_tpu import configs as jc
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.parallel import pipeline as jpl
from lantern_tpu.train import finetune as jft
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.parallel import pipeline as pl
from lantern_tpu_torch.train import finetune as tft
from lantern_tpu_torch.train.optim import flatten

# tests/test_pipeline.py's tolerances
LOSS_RTOL, ACC_RTOL = 2e-5, 1e-5
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
B, T = 4, 16
CASES = {"m2": (2, 2, 1), "m4": (2, 4, 1), "pp4": (4, 4, 1),
         "dp2pp2": (2, 2, 2)}                  # (pp, n_micro, dp)
FCFG = dict(lr=5e-3, warmup_steps=1, total_steps=50, remat=True)


def nano(m):
    return dataclasses.replace(
        m.llamagen_config("nano", "c2i", image_tokens=16), cond_kind="none",
        num_layers=4, dtype="float32")


def batch_np(cfg, pads=False):
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
         "loss_mask": np.ones((B, T), np.float32)}
    if pads:
        av = np.ones((B, T), np.float32)
        av[1, -3:] = 0
        av[3, -6:] = 0
        b["attn_valid"] = av
        b["loss_mask"] = av.copy()
    return b


def to_torch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The rank jobs, run beside the JAX references."""
    root = tmp_path_factory.mktemp("pipeline")
    cj = nano(jc)
    P = jtfm.init_params(jax.random.key(0), cj, dtype=jnp.float32)
    inp = dict(cfg=nano(tc), fcfg=tft.FinetuneConfig(**FCFG),
               params=convert.convert_params(jax.tree.map(np.asarray, P),
                                             device="cpu"),
               batch=to_torch(batch_np(cj)),
               batch_pads=to_torch(batch_np(cj, pads=True)))
    for job in ("pipe2", "pipe4"):
        torch.save(inp, root / f"{job}.pt")
    procs = {"pipe2": ranks.launch("pipe2", 2, root),
             "pipe4": ranks.launch("pipe4", 4, root)}

    rope = jtfm.make_rope_tables(cj)
    fj = jft.FinetuneConfig(remat=False)
    refs = {"w_down0": np.asarray(P["layers"]["w_down"])}
    for tag, pads in (("plain", False), ("pads", True)):
        bj = to_jax(batch_np(cj, pads))
        (loss, acc), g = jax.value_and_grad(
            lambda p: jft.token_loss(p, cj, rope, bj, fj), has_aux=True)(P)
        refs[tag] = (float(loss), float(acc), jax.tree.map(np.asarray, g))
    bj = to_jax(batch_np(cj))
    for tag, (pp, n, dp) in CASES.items():
        if dp > 1:
            continue
        mesh = Mesh(np.asarray(jax.devices()[:pp]), (jpl.PP,))
        loss_fn = jpl.pipeline_loss_fn(cj, mesh, n, rope, remat=False)
        with mesh:
            loss, acc = jax.jit(loss_fn)(
                P, jpl.split_stages(P["layers"], pp), bj)
        refs[f"jax/{tag}"] = (float(loss), float(acc))
    # two make_train_step steps (pp = 2, 2 microbatches)
    mesh = Mesh(np.asarray(jax.devices()[:2]), (jpl.PP,))
    params = dict(P)
    staged = jpl.split_stages(params.pop("layers"), 2)
    step_fn, init_fn = jpl.make_train_step(cj, mesh, 2, rope,
                                           jft.FinetuneConfig(**FCFG))
    opt = init_fn(params, staged)
    steps = []
    with mesh:
        for _ in range(ranks.TRAIN_STEPS):
            params, staged, opt, m = step_fn(params, staged, opt, bj)
            steps.append({k: float(v) for k, v in m.items()})
    refs["train"] = (steps, jax.tree.map(np.asarray, dict(
        params, layers=jpl.merge_stages(staged))))
    return dict(refs=refs, **{job: ranks.collect(job, p, root)
                              for job, p in procs.items()})


def results(world, job):
    out = world[job]
    if isinstance(out, str):
        pytest.fail(out)
    return out


def run_of(world, tag):
    """``[(rank's result, (dp_rank, stage))]`` of one case."""
    if tag in ("pp4", "dp2pp2"):
        return [(o[tag], o[tag]["coords"]) for o in results(world, "pipe4")]
    return [(o[tag], o["coords"]) for o in results(world, "pipe2")]


def merged_grads(runs):
    """The whole model's gradients from dp row 0's stages."""
    stages = sorted((c[1], r) for r, c in runs if c[0] == 0)
    out = {k: v.numpy() for k, v in stages[0][1]["params"].items()}
    out["layers"] = {k: torch.cat([r["stage"][k] for _, r in stages]).numpy()
                     for k in stages[0][1]["stage"]}
    return out


def check_grads(got, want):
    for k in want["layers"]:
        np.testing.assert_allclose(got["layers"][k], want["layers"][k],
                                   err_msg=f"layers/{k}", **GRAD_TOL)
    for k in ("lm_head", "embed", "norm"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("tag", list(CASES))
def test_pipeline_matches_single_device(world, tag):
    runs = run_of(world, tag)
    loss, acc, g = world["refs"]["plain"]
    for r, _ in runs:
        np.testing.assert_allclose(float(r["loss"]), loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(r["acc"]), acc, rtol=ACC_RTOL)
        # every rank returns the same loss and the same replicated grads
        assert torch.equal(r["loss"], runs[0][0]["loss"])
        for k, v in r["params"].items():
            assert torch.equal(v, runs[0][0]["params"][k]), k
    if f"jax/{tag}" in world["refs"]:
        jl, ja = world["refs"][f"jax/{tag}"]
        np.testing.assert_allclose(float(runs[0][0]["loss"]), jl,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(runs[0][0]["acc"]), ja,
                                   rtol=ACC_RTOL)
    check_grads(merged_grads(runs), g)
    if tag == "dp2pp2":
        # each stage's layer grads are the same on both dp rows
        by = {c: r for r, c in runs}
        for s in range(2):
            for k, v in by[0, s]["stage"].items():
                assert torch.equal(v, by[1, s]["stage"][k]), k


@pytest.mark.parametrize("tag,ref", [("pad_rows", "pads"),
                                     ("shared", "plain")])
def test_pipeline_attn_valid(world, tag, ref):
    """A per-row pad mask, and a shared ``[1, T]`` one (all ones: the plain
    causal loss)."""
    runs = run_of(world, tag)
    loss, acc, g = world["refs"][ref]
    for r, _ in runs:
        np.testing.assert_allclose(float(r["loss"]), loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(r["acc"]), acc, rtol=ACC_RTOL)
    check_grads(merged_grads(runs), g)


def test_pipeline_train_steps_match_jax(world):
    want_steps, want = world["refs"]["train"]
    outs = results(world, "pipe2")
    for o in outs:
        for got, ref in zip(o["steps"], want_steps):
            for k in ("loss", "acc"):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-5,
                                           err_msg=k)
        assert o["steps"][0]["grad_norm"] == outs[0]["steps"][0]["grad_norm"]
    stages = sorted(outs, key=lambda o: o["coords"][1])
    got = dict(stages[0]["trained"]["params"], layers={
        k: torch.cat([o["trained"]["stage"][k] for o in stages])
        for k in stages[0]["trained"]["stage"]})
    paths, ref = flatten(want)
    got = dict(zip(*flatten(got)))
    assert sorted(got) == sorted(paths)
    for p, w in zip(paths, ref):
        ranks.assert_adam_close(got[p].numpy(), w, FCFG["lr"],
                                ranks.TRAIN_STEPS, p)
    # the second step moved the weights (the first runs at lr 0)
    assert not np.array_equal(got["layers/w_down"].numpy(),
                              world["refs"]["w_down0"])


def test_split_merge_roundtrip():
    cfg = nano(tc)
    p = ttfm.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    staged = pl.split_stages(p["layers"], 2)
    assert all(v.shape[:2] == (2, 2) for v in staged.values())
    assert pl.stage_specs(staged)["wq"] == ("pp", None, None, None)
    back = pl.merge_stages(staged)
    for k in back:
        assert torch.equal(back[k], p["layers"][k])
    with pytest.raises(ValueError, match="not divisible"):
        pl.split_stages(p["layers"], 3)


def test_cond_batch_refused():
    cfg = nano(tc)
    p = ttfm.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    loss_fn = pl.pipeline_loss_fn(cfg, pl.PipeMesh(dp=1, pp=1), 1,
                                  ttfm.make_rope_tables(cfg, "cpu"))
    batch = dict(to_torch(batch_np(cfg)), cond=torch.zeros(B, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="cond"):
        loss_fn(p, p["layers"], batch)


def test_one_stage_is_the_finetune_step():
    """pp = 1 and one microbatch, without a process group: the pipeline's
    step is ``finetune.train_step`` bit for bit (the smoke holds the same
    over NCCL on the card)."""
    cfg = nano(tc)
    rope = ttfm.make_rope_tables(cfg, "cpu")
    fcfg = tft.FinetuneConfig(**FCFG)
    p = ttfm.init_params(torch.Generator().manual_seed(2), cfg, device="cpu",
                         dtype=torch.float32)
    batch = to_torch(batch_np(cfg))
    ref = tft.init_state(ranks.copy(p), fcfg)
    params = ranks.copy(p)
    staged = params.pop("layers")
    step_fn, init_fn = pl.make_train_step(cfg, pl.PipeMesh(dp=1, pp=1), 1,
                                          rope, fcfg)
    opt = init_fn(params, staged)
    for _ in range(ranks.TRAIN_STEPS):
        ref, mr = tft.train_step(ref, cfg, fcfg, rope, batch)
        params, staged, opt, m = step_fn(params, staged, opt, batch)
        for k in ("loss", "acc", "grad_norm"):
            assert torch.equal(m[k], mr[k]), k
    got = dict(zip(*flatten(dict(params, layers=staged))))
    for k, v in zip(*flatten(ref.params)):
        assert torch.equal(got[k], v), k
