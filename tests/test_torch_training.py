"""The port's training forward, drafter distillation, optimizer, meters and
kernel autograd guard against ``lantern_tpu`` on the CPU.

- ``transformer.train_mask`` / ``train_layer_block`` / ``forward_train``:
  LlamaGen (label, and caption with pad columns) and Chameleon (1-D rope,
  QK-norm, swin norm), split and fused layouts, with and without remat:
  hidden states within 2e-5, gradients within 1e-4 relative plus 1e-5 of
  the leaf's largest gradient (f32);
  layer slices with their global ``idx0`` equal the whole stack;
- ``drafter_train.loss_and_metrics`` in every mode (plain, ``cfg_loss``,
  ``head_chunk`` at a non-divisor, ``rollout_depth`` 2, ``remat``, the
  ``positions`` override): loss terms within 1e-5 relative, top-k counts
  equal, gradients of every trainable leaf as close to ``jax.grad``;
- five ``train_step`` s under a warmup-then-decay schedule: the loss of
  every step within 1e-5 relative, and every parameter within
  ``1e-3 * lr * steps`` of JAX's (Adam turns a gradient difference near 0
  into a step of about ``lr``; none is seen at these inputs);
- ``train.optim.AdamW`` against the optax chains on identical gradients
  (value clip; global-norm clip both triggered and not, a decay mask,
  an f32 first moment), and both learning-rate schedules at every step;
- ``add_noise`` by distribution (uniform bound, mean and variance at the
  ``512 / T`` scale; gaussian mean and variance);
- ``utils.profiling``: ``trace`` and the meters as JAX's, and
  ``MetricLogger`` summed over two gloo ranks (its spans and counters:
  ``tests/test_torch_tracing.py``);
- ``ops._cuda.no_autograd``: raises on an input that requires grad under
  grad mode and nowhere else; the plain forms of K1 and K2 still
  differentiate.

Tests marked ``cuda`` skip here: on the card K1-K4 refuse inputs that
require grad, and three drafter steps match the CPU's.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from lantern_tpu import configs as jc
from lantern_tpu.models import drafter as jd
from lantern_tpu.models import transformer as jt
from lantern_tpu.train import drafter_train as jdt
from lantern_tpu.utils import profiling as jprof
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch.models import transformer as tt
from lantern_tpu_torch.ops import _cuda
from lantern_tpu_torch.ops import quant as tq
from lantern_tpu_torch.ops import tree_attention as tta
from lantern_tpu_torch.train import drafter_train as tdt
from lantern_tpu_torch.train import optim
from lantern_tpu_torch.utils import profiling as tprof

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAFT_KW = dict(cond_kind="label", block_size=16, vocab_size=64,
                hidden_size=32, num_heads=4)
FWD_KW = {
    "label": dict(cond_kind="label", vocab_size=64, hidden_size=64,
                  num_heads=4, block_size=16),
    "caption": dict(cond_kind="caption", vocab_size=64, hidden_size=64,
                    num_heads=4, block_size=16),
    "chameleon": dict(rope_kind="1d", cond_kind="none", vocab_size=64,
                      hidden_size=64, num_heads=2, qk_norm=True,
                      swin_norm=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny and the test workers share the cores: intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def fuse_jax(params):
    """The JAX pytree with fused ``wqkv`` / ``w_gu`` layer weights."""
    lay = dict(params["layers"])
    lay["wqkv"] = jnp.concatenate([lay.pop("wq"), lay.pop("wk"),
                                   lay.pop("wv")], axis=-1)
    lay["w_gu"] = jnp.concatenate([lay.pop("w_gate"), lay.pop("w_up")],
                                  axis=-1)
    return dict(params, layers=lay)


def port_grads(fn, tree, skip=()):
    """``(value, {path: grad})`` of ``fn(tree)`` over every leaf of the
    port's ``tree`` but ``skip``."""
    paths, leaves = optim.flatten(tree)
    keep = [i for i, p in enumerate(paths) if p not in skip]
    live = [leaves[i].detach().requires_grad_() for i in keep]
    kp = [paths[i] for i in keep]
    val = fn(optim.unflatten(tree, kp, live))
    out = val[0] if isinstance(val, tuple) else val
    gs = torch.autograd.grad(out, live, allow_unused=True)
    return val, {p: (torch.zeros_like(x) if g is None else g).numpy()
                 for p, x, g in zip(kp, live, gs)}


def assert_grads(got: dict, want_tree, rtol=1e-4, scale_tol=1e-5):
    """Every leaf's gradient within ``rtol`` of JAX's, plus ``scale_tol``
    times the leaf's largest JAX gradient (f32 sums over the batch and the
    sequence, in another order)."""
    paths, leaves = optim.flatten(np_tree(want_tree))
    assert sorted(got) == sorted(paths)
    for p, w in zip(paths, leaves):
        np.testing.assert_allclose(got[p], w, rtol=rtol,
                                   atol=scale_tol * float(np.abs(w).max()),
                                   err_msg=p)


# ------------------------------------------------------------ forward_train

def test_train_mask_matches_jax():
    av = np.ones((3, 7), np.float32)
    av[1, 5:] = 0
    av[2, :2] = 0
    for v in (None, av):
        want = np.asarray(jt.train_mask(7, None if v is None
                                        else jnp.asarray(v)))
        got = tt.train_mask(7, None if v is None else torch.as_tensor(v),
                            device="cpu").numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def fwd_models():
    out = {}
    for kind, kw in FWD_KW.items():
        cj, ct = jc.tiny_config(**kw), tc.tiny_config(**kw)
        P = jt.init_params(jax.random.key(3), cj)
        out[kind] = (cj, ct, P, jt.make_rope_tables(cj),
                     tt.make_rope_tables(ct, "cpu"))
    return out


@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("kind", list(FWD_KW))
def test_forward_train_and_grads_match_jax(fwd_models, kind, layout):
    cj, ct, P, rj, rt = fwd_models[kind]
    if layout == "fused":
        P = fuse_jax(P)
    pt = convert.convert_params(np_tree(P), device="cpu")
    rng = np.random.default_rng(7)
    B, T, H = 2, 11, cj.hidden_size
    emb = rng.normal(size=(B, T, H)).astype(np.float32)
    av = np.ones((B, T), np.float32)
    if kind == "caption":
        av[1, :3] = 0          # a left-padded caption's pad columns
    av[0, -2:] = 0             # trailing pads
    wts = rng.normal(size=(B, T, H)).astype(np.float32)
    pos = np.arange(T)

    for remat in (False, True):
        def jloss(p):
            h = jt.forward_train(p, cj, jnp.asarray(emb), jnp.asarray(pos),
                                 rj, attn_valid=jnp.asarray(av), remat=remat)
            return jnp.sum(h * wts), h

        (_, hj), gj = jax.value_and_grad(jloss, has_aux=True)(P)

        def tloss(p):
            h = tt.forward_train(p, ct, torch.as_tensor(emb),
                                 torch.as_tensor(pos), rt,
                                 attn_valid=torch.as_tensor(av), remat=remat)
            return torch.sum(h * torch.as_tensor(wts)), h

        (_, ht), gt = port_grads(tloss, pt)
        np.testing.assert_allclose(ht.detach().numpy(), np.asarray(hj),
                                   rtol=2e-5, atol=2e-5)
        assert_grads(gt, gj)


def test_train_layer_block_slices_match_whole_stack():
    """Layer slices with their global ``idx0`` equal the whole stack, and
    JAX's block on the same slice (a two-layer drafter config, whose layer
    0 skips the input norm)."""
    cj = jc.drafter_config(jc.tiny_config(**DRAFT_KW), num_layers=2).model
    ct = tc.drafter_config(tc.tiny_config(**DRAFT_KW), num_layers=2).model
    P = jt.init_params(jax.random.key(5), cj)
    P["layers"]["attn_norm"] = P["layers"]["attn_norm"] * 3.0
    pt = convert.convert_params(np_tree(P), device="cpu")
    rj, rt = jt.make_rope_tables(cj), tt.make_rope_tables(ct, "cpu")
    x = np.random.default_rng(1).normal(size=(2, 9, 32)).astype(np.float32)
    pos = np.arange(9)[None]
    mj, mt = jt.train_mask(9, None), tt.train_mask(9, None, device="cpu")
    whole = tt.train_layer_block(pt["layers"], ct, torch.as_tensor(x),
                                 torch.as_tensor(pos), rt, mt, remat=False)
    first = {k: v[:1] for k, v in pt["layers"].items()}
    second = {k: v[1:] for k, v in pt["layers"].items()}
    h = tt.train_layer_block(first, ct, torch.as_tensor(x),
                             torch.as_tensor(pos), rt, mt, idx0=0)
    h = tt.train_layer_block(second, ct, h, torch.as_tensor(pos), rt, mt,
                             idx0=1)
    np.testing.assert_allclose(h.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = jt.train_layer_block(
        {k: v[1:] for k, v in P["layers"].items()}, cj,
        jt.train_layer_block({k: v[:1] for k, v in P["layers"].items()}, cj,
                             jnp.asarray(x), jnp.asarray(pos), rj, mj),
        jnp.asarray(pos), rj, mj, idx0=1)
    np.testing.assert_allclose(h.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # idx0 decides the skipped norm: the second slice run as layer 0 differs
    other = tt.train_layer_block(second, ct, torch.as_tensor(x),
                                 torch.as_tensor(pos), rt, mt, idx0=0)
    again = tt.train_layer_block(second, ct, torch.as_tensor(x),
                                 torch.as_tensor(pos), rt, mt, idx0=1)
    assert not torch.allclose(other, again)


# ------------------------------------------------------------ drafter

@pytest.fixture(scope="module")
def drafter():
    cj, ct = jc.tiny_config(**DRAFT_KW), tc.tiny_config(**DRAFT_KW)
    dj, dt_ = jc.drafter_config(cj), tc.drafter_config(ct)
    P = jt.init_params(jax.random.key(0), cj)
    D = jd.init_drafter_params(jax.random.key(1), dj, P["embed"])
    pt = convert.convert_params(np_tree(P), device="cpu")
    return dict(dj=dj, dt=dt_, P=P, D=D, pt=pt,
                rj=jt.make_rope_tables(dj.model),
                rt=tt.make_rope_tables(dt_.model, "cpu"))


def port_dparams(m, D=None):
    return convert.convert_drafter_params(np_tree(m["D"] if D is None else D),
                                          device="cpu",
                                          embed=m["pt"]["embed"])


def synth_batch(B=4, T=12, H=32, seed=0):
    """The JAX tests' learnable task (next hidden a function of the
    current), with masked loss rows and trailing pad columns."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 64, (B, T)).astype(np.int32)
    hid = rng.normal(size=(B, T, H)).astype(np.float32)
    W = np.linalg.qr(rng.normal(size=(H, H)))[0].astype(np.float32)
    lm = np.ones((B, T), np.float32)
    lm[0, -3:] = 0
    av = np.ones((B, T), np.float32)
    av[1, -2:] = 0
    return {"tokens": toks, "hidden": hid, "target": np.tanh(hid @ W),
            "loss_mask": lm, "attn_valid": av}


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            tdt.to_device(batch, "cpu"))


MODES = {
    "plain": {},
    "cfg_loss": {"cfg_loss": True},
    "head_chunk": {"head_chunk": 5},
    "rollout2": {"rollout_depth": 2},
    "remat": {"remat": True, "rollout_depth": 2, "head_chunk": 5},
    "positions": {},
}


@pytest.mark.parametrize("mode", list(MODES))
def test_loss_and_metrics_and_grads_match_jax(drafter, mode):
    m = drafter
    D = m["D"]
    batch = synth_batch(seed=3)
    if mode == "positions":
        # boosted q/k make the rope rotation visible in the output
        D = dict(D, layers=dict(D["layers"]))
        for k in ("wq", "wk"):
            D["layers"][k] = D["layers"][k] * 40.0
        batch["positions"] = np.flip(np.broadcast_to(
            np.arange(12)[None], (4, 12)), axis=1).copy()
    dp = port_dparams(m, D)
    bj, bt = both(batch)
    tj = jdt.TrainConfig(noise="none", **MODES[mode])
    tt_ = tdt.TrainConfig(noise="none", **MODES[mode])
    head_j, head_t = m["P"]["lm_head"], m["pt"]["lm_head"]

    trainable = {k: v for k, v in D.items() if k != "embed"}

    def jloss(tr):
        return jdt.loss_and_metrics(dict(tr, embed=D["embed"]), m["dj"],
                                    m["rj"], head_j, bj, tj)

    (lj, mj), gj = jax.value_and_grad(jloss, has_aux=True)(trainable)
    (lt, mt), gt = port_grads(
        lambda p: tdt.loss_and_metrics(p, m["dt"], m["rt"], head_t, bt, tt_),
        dp, skip=("embed",))
    for name in ("loss", "vloss", "ploss", "total"):
        np.testing.assert_allclose(float(getattr(mt, name).detach()),
                                   float(getattr(mj, name)), rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(mt.top_acc.numpy(), np.asarray(mj.top_acc))
    assert float(mt.correct) == float(mj.correct)
    assert_grads(gt, gj)


def test_five_train_steps_match_jax(drafter):
    m = drafter
    lr, steps = 5e-3, 5
    kw = dict(lr=lr, noise="none", warmup_steps=2, total_steps=steps)
    tj, tt_ = jdt.TrainConfig(**kw), tdt.TrainConfig(**kw)
    bj, bt = both(synth_batch(seed=0))
    sj = jdt.init_train_state(m["D"], tj)
    st = tdt.init_train_state(port_dparams(m), tt_)
    for i in range(steps):
        sj, mj = jdt.train_step(sj, m["dj"], tj, m["rj"], m["P"]["lm_head"],
                                bj, jax.random.key(i))
        st, mt = tdt.train_step(st, m["dt"], tt_, m["rt"], m["pt"]["lm_head"],
                                bt)
        np.testing.assert_allclose(float(mt.loss), float(mj.loss), rtol=1e-5)
        np.testing.assert_array_equal(mt.top_acc.numpy(),
                                      np.asarray(mj.top_acc))
    assert st.step == steps and st.opt_state.count == steps
    paths, want = optim.flatten(np_tree(sj.dparams))
    got = dict(zip(*optim.flatten(st.dparams)))
    for p, w in zip(paths, want):
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0,
                                   atol=1e-3 * lr * steps, err_msg=p)
    # the step leaves no parameter requiring grad, and the embedding frozen
    assert not any(x.requires_grad for x in got.values())
    np.testing.assert_array_equal(got["embed"].numpy(),
                                  np.asarray(m["P"]["embed"]))


def test_eval_step_is_the_loss_without_grad(drafter):
    m = drafter
    tt_ = tdt.TrainConfig(noise="none")
    dp = port_dparams(m)
    _, bt = both(synth_batch(seed=2))
    st = tdt.init_train_state(dp, tt_)
    with torch.enable_grad():
        got = tdt.eval_step(st, m["dt"], tt_, m["rt"], m["pt"]["lm_head"], bt)
    assert got.loss.grad_fn is None
    _, want = tdt.loss_and_metrics(dp, m["dt"], m["rt"], m["pt"]["lm_head"],
                                   bt, tt_)
    assert float(got.loss) == float(want.loss)


# ------------------------------------------------------------ optimizer

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(6, 5)).astype(np.float32),
            "b": {"norm": rng.normal(size=(5,)).astype(np.float32),
                  "w": rng.normal(size=(3, 4, 2)).astype(np.float32)}}


@pytest.mark.parametrize("chain", ["drafter", "finetune_clipped",
                                   "finetune_unclipped"])
def test_adamw_matches_optax(chain):
    params = _tree(0)
    if chain == "drafter":
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, 1e-2, 2),
             optax.linear_schedule(1e-2, 0.0, 4)], [2])
        jopt = optax.chain(optax.clip(0.5), optax.adamw(sched, b1=0.9,
                                                        b2=0.95))
        topt = tdt.build_optimizer(tdt.TrainConfig(
            lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=0.5))
        gscale = 1.0
    else:
        from lantern_tpu.train import finetune as jft
        from lantern_tpu_torch.train import finetune as tft

        fk = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1)
        jopt = jft.build_optimizer(jft.FinetuneConfig(**fk))
        topt = tft.build_optimizer(tft.FinetuneConfig(**fk),
                                   convert_tree(params))
        # the global norm of these gradients is ~5: clipped at 1, not at 1e3
        gscale = 1.0 if chain == "finetune_clipped" else 1e-3
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = convert_tree(params)
    _, leaves = optim.flatten(tp)
    ts = topt.init(leaves)
    for i in range(6):
        g = jax.tree.map(lambda x: x * gscale, _tree(100 + i))
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = topt.update(leaves, [torch.as_tensor(x) for x in
                                  optim.flatten(g)[1]], ts)
    assert ts.count == 6
    for w, x in zip(optim.flatten(np_tree(jp))[1], leaves):
        np.testing.assert_allclose(x.numpy(), w, rtol=1e-6, atol=1e-7)


def convert_tree(tree):
    return {k: (convert_tree(v) if isinstance(v, dict)
                else torch.as_tensor(np.array(v))) for k, v in tree.items()}


def test_lr_schedules_match_optax():
    from lantern_tpu.train import finetune as jft
    from lantern_tpu_torch.train import finetune as tft

    for w, total in ((3, 10), (0, 7), (1, 1)):
        fj = jft.lr_schedule(jft.FinetuneConfig(lr=2e-4, warmup_steps=w,
                                                total_steps=total))
        ft = tft.lr_schedule(tft.FinetuneConfig(lr=2e-4, warmup_steps=w,
                                                total_steps=total))
        for s in range(total + 4):
            np.testing.assert_allclose(ft(s), float(fj(s)), rtol=1e-6,
                                       atol=1e-12, err_msg=(w, total, s))
        # the drafter's rule (drafter_train.py build_optimizer) in optax
        dt_ = tdt.build_optimizer(tdt.TrainConfig(lr=3e-3, warmup_steps=w,
                                                  total_steps=total))
        if w > 0 and total > 0:
            sched = optax.join_schedules(
                [optax.linear_schedule(0.0, 3e-3, w),
                 optax.linear_schedule(3e-3, 0.0, max(total - w, 1))], [w])
        else:
            sched = optax.constant_schedule(3e-3)
        for s in range(total + 4):
            np.testing.assert_allclose(dt_.learning_rate(s), float(sched(s)),
                                       rtol=1e-6, atol=1e-12)


# ------------------------------------------------------------ noise

def test_add_noise_by_distribution():
    h = torch.zeros((2, 256, 256))
    g = torch.Generator().manual_seed(0)
    assert tdt.add_noise(g, h, tdt.TrainConfig(noise="none")) is h
    tu = tdt.TrainConfig(noise="uniform", noise_std=0.2)
    u = tdt.add_noise(g, h, tu).double()
    scale = 0.2 * 512 / 256
    n = u.numel()
    assert float(u.abs().max()) <= scale / 2
    assert abs(float(u.mean())) < 4 * scale / np.sqrt(12 * n)
    np.testing.assert_allclose(float(u.var()), scale ** 2 / 12, rtol=0.02)
    tg = tdt.TrainConfig(noise="gaussian", noise_std=0.2)
    x = tdt.add_noise(g, h, tg).double()
    assert abs(float(x.mean())) < 4 * 0.2 / np.sqrt(n)
    np.testing.assert_allclose(float(x.std()), 0.2, rtol=0.02)
    # JAX's noise has the same scale rule
    xj = np.asarray(jdt.add_noise(jax.random.key(0), jnp.zeros((2, 256, 256)),
                                  jdt.TrainConfig(noise="uniform",
                                                  noise_std=0.2)))
    assert np.abs(xj).max() <= scale / 2
    np.testing.assert_allclose(xj.var(), scale ** 2 / 12, rtol=0.02)


# ------------------------------------------------------------ profiling

def test_profiling_meters_match_jax(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    json.load(open(tmp_path / "tr" / "trace.json"))
    lj, lt = jprof.MetricLogger(), tprof.MetricLogger()
    for i in range(30):
        for lg in (lj, lt):
            lg.update(loss=1.0 / (i + 1), acc=i * 0.01)
    assert str(lt) == str(lj)
    lt.synchronize_between_hosts()        # no process group: a no-op
    assert str(lt) == str(lj)


RANK_SCRIPT = """
import sys, torch, torch.distributed as dist
from lantern_tpu_torch.utils.profiling import MetricLogger
rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method=sys.argv[2], world_size=2,
                        rank=rank)
lg = MetricLogger()
for v in range(rank + 1):
    lg.update(loss=10.0 * (rank + 1) + v)
lg.synchronize_between_hosts()
m = lg.meters["loss"]
print(m.total, m.count)
bad = MetricLogger()
bad.update(**{"loss" if rank == 0 else "acc": 1.0})
try:
    bad.synchronize_between_hosts()
    print("no error")
except ValueError:
    print("disagree")
dist.destroy_process_group()
"""


def test_metric_logger_sums_over_two_ranks(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), f"tcp://localhost:{port}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(out.split())
    # rank 0: 10; rank 1: 20, 21 -> total 51 over 3 values on both ranks
    assert outs[0][:2] == outs[1][:2] == ["51.0", "3"]
    assert outs[0][2] == outs[1][2] == "disagree"


# ------------------------------------------------------------ autograd guard

def test_no_autograd_guard_raises_only_under_grad():
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _cuda.no_autograd("int8_matmul", x, torch.ones(2))
    with torch.no_grad():
        _cuda.no_autograd("int8_matmul", x)
    _cuda.no_autograd("tree_attention", torch.ones(2), None)
    with torch.inference_mode():
        _cuda.no_autograd("kv_write", torch.ones(2))


def test_plain_kernel_forms_still_differentiate():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 32), generator=g, requires_grad=True)
    q = torch.randint(-127, 128, (32, 16), generator=g).to(torch.int8)
    s = torch.rand((1, 16), generator=g)
    y = tq.w8a16_matmul(x, q, s)
    (gx,) = torch.autograd.grad(y.sum(), x)
    torch.testing.assert_close(gx, (q.float() * s).sum(-1).expand(3, 32))
    B, T, nh, hd, S = 1, 3, 2, 64, 8
    qa = torch.randn((B, T, nh, hd), generator=g, requires_grad=True)
    kn, vn = (torch.randn((B, T, nh, hd), generator=g) for _ in range(2))
    kc, vc = (torch.randn((B, 1, S, 128), generator=g) for _ in range(2))
    o = tta.tree_attention(qa, kn, vn, kc, vc, torch.tensor(4, dtype=torch.int32),
                           torch.tril(torch.ones((T, T), dtype=torch.bool)),
                           torch.zeros((B, S)), hd ** -0.5)
    (gq,) = torch.autograd.grad((o * o).sum(), qa)
    assert torch.isfinite(gq).all() and float(gq.abs().sum()) > 0


# ------------------------------------------------------------ on the card

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_refuse_autograd_on_card(cuda):
    from lantern_tpu_torch import kv as tkv

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((2, 256), generator=g, device=cuda).bfloat16()
    q = torch.randint(-127, 128, (256, 128), generator=g, device=cuda,
                      dtype=torch.int8)
    s = torch.rand((1, 128), generator=g, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        tq.w8a16_matmul(x.clone().requires_grad_(), q, s)
    with torch.no_grad():
        tq.w8a16_matmul(x.clone().requires_grad_(), q, s)
    B, T, nh, hd, S = 1, 4, 2, 64, 128
    qa, kn, vn = (torch.randn((B, T, nh, hd), generator=g,
                              device=cuda).bfloat16() for _ in range(3))
    kc, vc = (torch.zeros((B, 1, S, 128), device=cuda).bfloat16()
              for _ in range(2))
    args = (kn, vn, kc, vc, torch.tensor(8, dtype=torch.int32, device=cuda),
            torch.tril(torch.ones((T, T), dtype=torch.bool, device=cuda)),
            torch.zeros((B, S), device=cuda), hd ** -0.5)
    with pytest.raises(RuntimeError, match="no backward"):
        tta.tree_attention(qa.clone().requires_grad_(), *args)
    kb, vb = (torch.zeros((1, B, 1, S, 128), device=cuda).bfloat16()
              for _ in range(2))
    new = torch.randn((1, B, T, nh, hd), generator=g, device=cuda).bfloat16()
    start = torch.tensor(0, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        tkv.write_block(kb, vb, None, None, new.clone().requires_grad_(),
                        new, start)
    with pytest.raises(RuntimeError, match="no backward"):
        tkv.gather_write_block(kb.clone().requires_grad_(), vb, None, None,
                               torch.zeros((2,), dtype=torch.int32,
                                           device=cuda), start, 4)


@pytest.mark.cuda
def test_drafter_train_steps_card_match_cpu(cuda, drafter):
    m = drafter
    torch.backends.cuda.matmul.allow_tf32 = False
    tt_ = tdt.TrainConfig(lr=5e-3, noise="none", warmup_steps=1,
                          total_steps=3)
    batch = synth_batch(seed=4)
    states = {}
    for dev in ("cpu", cuda):
        dp = {k: (v.to(dev) if not isinstance(v, dict) else
                  {a: b.to(dev) for a, b in v.items()})
              for k, v in port_dparams(m).items()}
        st = tdt.init_train_state(dp, tt_)
        losses = []
        for _ in range(3):
            st, mt = tdt.train_step(st, m["dt"], tt_,
                                    tt.make_rope_tables(m["dt"].model, dev),
                                    m["pt"]["lm_head"].to(dev),
                                    tdt.to_device(batch, dev))
            losses.append(float(mt.loss))
        states[str(dev)] = (losses, st)
    np.testing.assert_allclose(states["cuda"][0], states["cpu"][0], rtol=1e-4)
    got = dict(zip(*optim.flatten(states["cuda"][1].dparams)))
    for p, w in zip(*optim.flatten(states["cpu"][1].dparams)):
        np.testing.assert_allclose(got[p].cpu().numpy(), w.numpy(),
                                   atol=1e-3 * 5e-3 * 3, err_msg=p)
