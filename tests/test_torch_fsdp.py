"""The port's FSDP finetune (``lantern_tpu_torch/train/finetune.py``:
``fsdp_param_specs``, ``init_state(..., mesh=)``, ``train_step(...,
mesh=)``) against ``lantern_tpu``'s.

- ``fsdp_param_specs`` leaf for leaf against the JAX specs, on tiny and
  published configs, split, fused and int8 trees, tp 1-8 (tp = 3 splits
  LlamaGen-XL's 36-layer stacks on the layer axis);
- the sharded step over gloo rank processes (``tests/torch_train_ranks.py``)
  at (dp = 2, tp = 2) and (dp = 1, tp = 4), on ``tests/test_finetune.py``'s
  setup (4 rows with label ``cond``; the same seeded weights through
  ``convert.convert_params``), against JAX's ``train_step`` unsharded and
  under ``fsdp_param_specs``: loss, accuracy and gradient norm of both
  steps within f32 tolerance and equal on every rank, the gathered
  parameters after two steps, and each rank's slices of the spec's shapes;
- with a clip that bites, the right step holds and both known-wrong
  variants miss: the clip by the shard's own norm, and the split leaves'
  gradients not summed over dp;
- the FSDP checkpoint at tp = 2, dp = 1 and dp = 2 (``save_checkpoint`` /
  ``restore_checkpoint`` with ``mesh=``): restored and stepped once,
  bit-equal to three uninterrupted steps and held to three JAX steps under
  ``fsdp_param_specs``; the file (written by world rank 0 alone) restores
  into a one-process state equal to the gathered parameters and AdamW
  moments; without ``mesh=`` the save raises; ``keep_last`` prunes as in
  ``tests/test_finetune.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_train_ranks as ranks
from lantern_tpu import configs as jc
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops import quant as jq
from lantern_tpu.parallel import mesh as jpm
from lantern_tpu.train import finetune as jft
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch.parallel import mesh as pm
from lantern_tpu_torch.train import finetune as tft
from lantern_tpu_torch.train.optim import flatten

KW = dict(cond_kind="label", block_size=16, vocab_size=64, hidden_size=32,
          num_heads=4)
FCFG = dict(lr=5e-3, warmup_steps=2, total_steps=50, remat=True)
# clipped to a norm far below the gradients', so that the clipped
# gradients sit under AdamW's eps and the step scales with the clip
CLIP = 1e-7
SPEC_CFGS = {
    "tiny_label": lambda m: m.tiny_config(**KW),
    "tiny_chameleon": lambda m: m.tiny_config(
        vocab_size=512, hidden_size=512, num_layers=2, num_heads=4,
        rope_kind="1d", cond_kind="none", qk_norm=True, swin_norm=True),
    "lumina_7b": lambda m: m.chameleon_7b_config(swin_norm=True),
    "llamagen_xl": lambda m: m.llamagen_config("XL", "t2i"),
}
SPEC_TPS = (1, 2, 3, 4, 8)
MESHES = {"dp2tp2": 2, "dp1tp4": 1}           # name: dp, over 4 ranks


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SHAPES = {}


def shape_trees(name, layout):
    """The JAX params tree as shapes, and the port's as meta tensors."""
    if (name, layout) not in _SHAPES:
        cfg = SPEC_CFGS[name](jc)

        def build(key):
            p = jtfm.init_params(key, cfg)
            if layout != "split":
                p = jtfm.fuse_params(p)
            if layout == "int8":
                p = jq.quantize_params(p)
            return p

        shapes = jax.eval_shape(build, jax.random.key(0))
        _SHAPES[name, layout] = shapes, jax.tree.map(
            lambda s: torch.empty(s.shape, device="meta"), shapes)
    return _SHAPES[name, layout]


@pytest.mark.parametrize("layout", ["split", "fused", "int8"])
@pytest.mark.parametrize("tp", SPEC_TPS)
@pytest.mark.parametrize("name", list(SPEC_CFGS))
def test_fsdp_param_specs_match_jax(name, tp, layout):
    shapes, meta = shape_trees(name, layout)
    want = jax.tree.map(tuple, jft.fsdp_param_specs(
        shapes, jpm.make_mesh(tp, dp=1)),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = tft.fsdp_param_specs(meta, pm.Mesh(dp=1, tp=tp))
    paths, wl = flatten(want)
    assert flatten(got) == (paths, wl)
    if name == "llamagen_xl" and tp == 3:
        # 36 layers: the stacks split on the layer axis
        down = next(p for p in paths if p.startswith("layers/w_down"))
        assert dict(zip(paths, wl))[down][0] == "tp"


def batch_np(cfg, B=4, T=12):
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "cond": rng.integers(0, cfg.num_classes, (B,)).astype(np.int32),
            "loss_mask": np.ones((B, T), np.float32)}


def jax_run(P, cfg, fcfg, rope, batch, mesh=None, steps=ranks.TRAIN_STEPS):
    """``steps`` JAX ``train_step`` s, unsharded or under
    ``fsdp_param_specs``: ``(metrics a step, params)``."""
    params = jax.tree.map(jnp.copy, P)
    if mesh is not None:
        params = jpm.shard_pytree(params, jft.fsdp_param_specs(params, mesh),
                                  mesh)
    state = jft.init_state(params, fcfg)
    out = []
    for _ in range(steps):
        if mesh is None:
            state, m = jft.train_step(state, cfg, fcfg, rope, batch)
        else:
            with jax.set_mesh(mesh):
                state, m = jft.train_step(state, cfg, fcfg, rope, batch)
        out.append({k: float(v) for k, v in m.items()})
    return out, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank job, run beside the JAX references."""
    root = tmp_path_factory.mktemp("fsdp")
    cj = jc.tiny_config(**KW)
    P = jtfm.init_params(jax.random.key(0), cj)
    batch = batch_np(cj)
    torch.save(dict(
        cfg=tc.tiny_config(**KW), fcfg=tft.FinetuneConfig(**FCFG),
        fcfg_clip=tft.FinetuneConfig(**FCFG, grad_clip_norm=CLIP),
        params=convert.convert_params(jax.tree.map(np.asarray, P),
                                      device="cpu"),
        batch={k: torch.as_tensor(v) for k, v in batch.items()}),
        root / "fsdp.pt")
    procs = ranks.launch("fsdp", 4, root)
    rope = jtfm.make_rope_tables(cj)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    fj = jft.FinetuneConfig(**FCFG)
    refs = {"one": jax_run(P, cj, fj, rope, bj),
            "clip": jax_run(P, cj, jft.FinetuneConfig(
                **FCFG, grad_clip_norm=CLIP), rope, bj)}
    for name, dp in MESHES.items():
        refs[name] = jax_run(P, cj, fj, rope, bj, jpm.make_mesh(4, dp=dp))
    return dict(refs=refs, ranks=ranks.collect("fsdp", procs, root))


def outs_of(world):
    if isinstance(world["ranks"], str):
        pytest.fail(world["ranks"])
    return world["ranks"]


def failures(run, ref, n_steps=ranks.TRAIN_STEPS) -> list:
    """What of one rank's run misses the JAX reference ``(steps,
    params)``: loss, accuracy and grad norm of each step within 1e-5
    relative, the gathered parameters after ``n_steps`` steps by
    ``assert_adam_close``."""
    steps, params = ref
    bad = [f"step {i} {k}" for i, (g, w) in enumerate(zip(run["steps"], steps))
           for k in ("loss", "acc", "grad_norm")
           if not np.isclose(g[k], w[k], rtol=1e-5, atol=0)]
    got = dict(zip(*flatten(run["params"])))
    for p, w in zip(*flatten(params)):
        try:
            ranks.assert_adam_close(got[p].numpy(), w, FCFG["lr"],
                                    n_steps, p)
        except AssertionError:
            bad.append(p)
    return bad


@pytest.mark.parametrize("name", list(MESHES))
def test_fsdp_step_matches_jax(world, name):
    outs = [o[name] for o in outs_of(world)]
    for o in outs:
        assert failures(o, world["refs"]["one"]) == [], o["coords"]
        assert failures(o, world["refs"][name]) == [], o["coords"]
        # every rank returns the same metrics and gathers the same params
        assert o["steps"] == outs[0]["steps"]
        for k, v in zip(*flatten(o["params"])):
            assert torch.equal(v, dict(zip(*flatten(outs[0]["params"])))[k])


@pytest.mark.parametrize("name", list(MESHES))
def test_fsdp_state_holds_slices(world, name):
    """Each rank keeps its slice of every split leaf (and moments of that
    shape); the whole model is never resident on a rank."""
    tp = 4 // MESHES[name]
    outs = [o[name] for o in outs_of(world)]
    full = [tuple(x.shape) for x in flatten(outs[0]["params"])[1]]
    specs = flatten(outs[0]["specs"])[1]
    assert any("tp" in s for s in specs)
    for o in outs:
        for shape, whole, spec in zip(o["shapes"], full, specs):
            want = tuple(n // tp if a == "tp" else n
                         for n, a in zip(whole, spec))
            assert shape == want


def test_fsdp_known_wrong_variants_miss(world):
    """With the clip biting, the right step holds against JAX and the two
    known-wrong variants miss it."""
    ref = world["refs"]["clip"]
    assert ref[0][0]["grad_norm"] > 1e3 * CLIP
    for o in outs_of(world):
        assert failures(o["clip"], ref) == []
        for variant in ("shard_norm", "skip_dp_sum"):
            bad = failures(o[variant], ref)
            assert any(not b.startswith("step") for b in bad), (variant, bad)


CKPT_MESHES = {"dp1tp2": 1, "dp2tp2": 2}      # name: dp, at tp = 2


@pytest.fixture(scope="module", params=list(CKPT_MESHES))
def ckpt_world(request, tmp_path_factory):
    """The checkpoint job at tp = 2 (2 ranks at dp = 1, 4 at dp = 2) on
    the tiny label model, and three JAX steps under ``fsdp_param_specs``
    on the same mesh shape."""
    dp = CKPT_MESHES[request.param]
    root = tmp_path_factory.mktemp(f"fsdp_ckpt_{request.param}")
    cj = jc.tiny_config(**KW)
    P = jtfm.init_params(jax.random.key(0), cj)
    batch = batch_np(cj)
    params = convert.convert_params(jax.tree.map(np.asarray, P),
                                    device="cpu")
    fcfg = tft.FinetuneConfig(**FCFG)
    torch.save(dict(cfg=tc.tiny_config(**KW), fcfg=fcfg, params=params,
                    dp=dp, batch={k: torch.as_tensor(v)
                                  for k, v in batch.items()}),
               root / "fsdp_ckpt.pt")
    procs = ranks.launch("fsdp_ckpt", 2 * dp, root)
    ref = jax_run(P, cj, jft.FinetuneConfig(**FCFG),
                  jtfm.make_rope_tables(cj),
                  {k: jnp.asarray(v) for k, v in batch.items()},
                  jpm.make_mesh(2 * dp, dp=dp), steps=3)
    return dict(outs=ranks.collect("fsdp_ckpt", procs, root), root=root,
                params=params, fcfg=fcfg, ref=ref)


def _bit_equal(a: dict, b: dict) -> bool:
    return (a["count"] == b["count"] and a["step"] == b["step"]
            and all(torch.equal(x, y) for k in ("params", "mu", "nu")
                    for x, y in zip(a[k], b[k])))


def test_fsdp_checkpoint_resume_is_bit_equal(ckpt_world):
    """Two steps saved at tp = 2, restored into a fresh sharded state and
    stepped once equal three uninterrupted steps bit for bit, state and
    metrics, on each rank; without ``mesh=`` the save is refused."""
    outs = ckpt_world["outs"]
    if isinstance(outs, str):
        pytest.fail(outs)
    for o in outs:
        assert o["path"] == "step_00000002"
        assert o["refused"] is not None and "mesh=" in o["refused"]
        assert _bit_equal(o["restored"], o["saved"])
        assert o["restored"]["step"] == 2 and o["restored"]["count"] == 2
        assert _bit_equal(o["resumed"], o["run"])
        assert all(torch.equal(o["resumed_metrics"][k], o["run_metrics"][k])
                   for k in ("loss", "acc", "grad_norm"))
    # the tp ranks hold different slices of the split leaves; the dp
    # replicas of one tp rank hold the same
    by = {o["coords"]: o["run"]["params"] for o in outs}
    assert not all(torch.equal(x, y) for x, y in zip(by[0, 0], by[0, 1]))
    for (_, t), ps in by.items():
        assert all(torch.equal(x, y) for x, y in zip(ps, by[0, t]))


def test_fsdp_checkpoint_resume_matches_jax(ckpt_world):
    """The step taken after the restore (the third) holds to three JAX
    ``train_step`` s under ``fsdp_param_specs``: its metrics, and the
    parameters every rank gathers after it."""
    outs = ckpt_world["outs"]
    if isinstance(outs, str):
        pytest.fail(outs)
    for o in outs:
        run = dict(steps=[{k: float(v) for k, v in
                           o["resumed_metrics"].items()}],
                   params=o["resumed_params"])
        ref = (ckpt_world["ref"][0][-1:], ckpt_world["ref"][1])
        assert failures(run, ref, n_steps=3) == [], o["coords"]


def test_fsdp_checkpoint_restores_into_one_process(ckpt_world):
    """The newest file (step 7, written by world rank 0 of the tp = 2 run)
    restored into a one-process ``like`` equals the gathered parameters
    and moments of the run that wrote it; ``keep_last=2`` kept the newest
    two, as the JAX save prunes."""
    outs = ckpt_world["outs"]
    if isinstance(outs, str):
        pytest.fail(outs)
    assert [o["kept"] for o in outs] == [["step_00000006",
                                          "step_00000007"]] * len(outs)
    like = tft.init_state(ckpt_world["params"], ckpt_world["fcfg"])
    got = tft.restore_checkpoint(str(ckpt_world["root"] / "ckpt"), like)
    assert got.specs is None
    for o in outs:
        w = o["whole"]
        assert _bit_equal(dict(params=flatten(got.params)[1],
                               mu=got.opt_state.mu, nu=got.opt_state.nu,
                               count=got.opt_state.count, step=got.step),
                          dict(w, params=flatten(w["params"])[1]))
    assert got.step == 7
