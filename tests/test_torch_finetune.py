"""The port's full-model finetuning against ``lantern_tpu`` on the CPU.

- ``_decay_mask`` equal to JAX's on LlamaGen (label and caption adapters)
  and Chameleon (QK-norm biases) parameter trees;
- ``token_loss`` with a label prefix, a caption prefix and pad columns, a
  z-loss, no prefix, remat on and off: loss and accuracy within 1e-5
  relative, gradients within 1e-4 relative plus 1e-5 of each leaf's
  largest gradient (f32);
- five ``train_step`` s (global-norm clip, f32 first moment, warmup then
  cosine decay, the decay mask): loss, accuracy and grad norm of every
  step within 1e-5 relative, every parameter within ``1e-3 * lr * steps``;
- checkpoints: save, restore (params, optimizer state and step equal),
  resume (the next step equal to the uninterrupted one), keep-last pruning,
  an unfinished ``.tmp`` save ignored, a mismatched ``like`` refused.

Tests marked ``cuda`` skip here: on the card ``forward_train`` and a
finetune step match the CPU's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lantern_tpu import configs as jc
from lantern_tpu.models import transformer as jt
from lantern_tpu.train import finetune as jft
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch.models import transformer as tt
from lantern_tpu_torch.train import finetune as tft
from lantern_tpu_torch.train import optim

from test_torch_training import assert_grads, np_tree, port_grads

KW = {
    "label": dict(cond_kind="label", block_size=16, vocab_size=64,
                  hidden_size=32, num_heads=4),
    "caption": dict(cond_kind="caption", block_size=16, vocab_size=64,
                    hidden_size=32, num_heads=4),
    "chameleon": dict(rope_kind="1d", cond_kind="none", vocab_size=64,
                      hidden_size=64, num_heads=2, qk_norm=True,
                      swin_norm=True),
}
FCFG = dict(lr=5e-3, warmup_steps=2, total_steps=50, remat=True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, kw in KW.items():
        cj, ct = jc.tiny_config(**kw), tc.tiny_config(**kw)
        P = jt.init_params(jax.random.key(0), cj)
        out[kind] = (cj, ct, P, jt.make_rope_tables(cj),
                     tt.make_rope_tables(ct, "cpu"))
    return out


def port_params(P):
    return convert.convert_params(np_tree(P), device="cpu")


def batch_of(cj, kind, seed=0, B=4, T=12, pads=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cj.vocab_size, (B, T)).astype(np.int32),
         "loss_mask": np.ones((B, T), np.float32)}
    b["loss_mask"][0, :2] = 0
    if kind == "label":
        b["cond"] = rng.integers(0, cj.num_classes, (B,)).astype(np.int32)
    elif kind == "caption":
        b["cond"] = rng.normal(size=(B, cj.cls_token_num, cj.caption_dim)
                               ).astype(np.float32)
    if pads:
        av = np.ones((B, T), np.float32)
        av[1, -3:] = 0
        b["attn_valid"] = av
    return b


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def test_decay_mask_matches_jax(models):
    for kind, (cj, ct, P, _, _) in models.items():
        want = optim.flatten(jft._decay_mask(P))
        got = optim.flatten(tft._decay_mask(port_params(P)))
        assert got == (want[0], [bool(x) for x in want[1]]), kind
    # what it decides: kernels and the head decay; norms, biases, the
    # embedding and the caption's uncond rows do not
    names = dict(zip(*optim.flatten(tft._decay_mask(port_params(
        models["caption"][2])))))
    assert names["layers/wq"] and names["lm_head"] and names["cond/fc1"]
    assert not (names["embed"] or names["norm"] or names["layers/attn_norm"]
                or names["cond/uncond"])


CASES = {
    "label": ("label", dict(), False),
    "caption_pads": ("caption", dict(), True),
    "z_loss": ("label", dict(z_loss=1e-2), False),
    "no_prefix": ("chameleon", dict(), True),
    "no_remat": ("caption", dict(remat=False), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_token_loss_and_grads_match_jax(models, case):
    kind, extra, pads = CASES[case]
    cj, ct, P, rj, rt = models[kind]
    batch = batch_of(cj, kind, seed=1, pads=pads)
    if kind == "chameleon":
        batch.pop("cond", None)
    bj, bt = both(batch)
    fj = jft.FinetuneConfig(**dict(FCFG, **extra))
    ft = tft.FinetuneConfig(**dict(FCFG, **extra))
    (lj, aj), gj = jax.value_and_grad(
        lambda p: jft.token_loss(p, cj, rj, bj, fj), has_aux=True)(P)
    (lt, at), gt = port_grads(lambda p: tft.token_loss(p, ct, rt, bt, ft),
                              port_params(P))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)
    assert_grads(gt, gj)


def test_five_train_steps_match_jax(models):
    cj, ct, P, rj, rt = models["caption"]
    bj, bt = both(batch_of(cj, "caption", seed=2, pads=True))
    fj, ft = jft.FinetuneConfig(**FCFG), tft.FinetuneConfig(**FCFG)
    sj, st = jft.init_state(P, fj), tft.init_state(port_params(P), ft)
    steps = 5
    for _ in range(steps):
        sj, mj = jft.train_step(sj, cj, fj, rj, bj)
        st, mt = tft.train_step(st, ct, ft, rt, bt)
        for k in ("loss", "acc", "grad_norm"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5,
                                       err_msg=k)
    assert st.step == steps
    paths, want = optim.flatten(np_tree(sj.params))
    got = dict(zip(*optim.flatten(st.params)))
    for p, w in zip(paths, want):
        np.testing.assert_allclose(got[p].numpy(), w, rtol=0,
                                   atol=1e-3 * FCFG["lr"] * steps, err_msg=p)
    assert not any(x.requires_grad for x in got.values())


def _equal_states(a, b):
    for x, y in zip(optim.flatten(a.params)[1], optim.flatten(b.params)[1]):
        assert torch.equal(x, y)
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for x, y in zip(a.opt_state.mu + a.opt_state.nu,
                    b.opt_state.mu + b.opt_state.nu):
        assert torch.equal(x, y)


def test_checkpoint_roundtrip_prune_and_resume(models, tmp_path):
    cj, ct, P, rj, rt = models["label"]
    ft = tft.FinetuneConfig(**FCFG)
    bt = both(batch_of(cj, "label", seed=3))[1]
    state = tft.init_state(port_params(P), ft)
    assert tft.restore_checkpoint(str(tmp_path), state) is None
    for _ in range(3):
        state, _ = tft.train_step(state, ct, ft, rt, bt)
    path = tft.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "step_00000003"
    # an unfinished save sorts after the finished one and is ignored
    (tmp_path / "step_00000009.tmp").write_bytes(b"partial")
    restored = tft.restore_checkpoint(str(tmp_path),
                                      tft.init_state(port_params(P), ft))
    _equal_states(restored, state)
    # resume: the next step from the restored state equals the live one's
    a, ma = tft.train_step(state, ct, ft, rt, bt)
    b, mb = tft.train_step(restored, ct, ft, rt, bt)
    assert float(ma["loss"]) == float(mb["loss"])
    _equal_states(a, b)
    for _ in range(3):
        b, _ = tft.train_step(b, ct, ft, rt, bt)
        tft.save_checkpoint(str(tmp_path), b, keep_last=2)
    kept = sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_") and not d.endswith(".tmp"))
    assert kept == ["step_00000006", "step_00000007"]
    assert tft.restore_checkpoint(str(tmp_path), b).step == 7
    other = tft.init_state(port_params(models["caption"][2]), ft)
    with pytest.raises(ValueError, match="does not match"):
        tft.restore_checkpoint(str(tmp_path), other)


# ------------------------------------------------------------ on the card

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_finetune_step_card_matches_cpu(cuda, models):
    torch.backends.cuda.matmul.allow_tf32 = False
    cj, ct, P, _, _ = models["caption"]
    batch = batch_of(cj, "caption", seed=4, pads=True)
    ft = tft.FinetuneConfig(**FCFG)
    out = {}
    for dev in ("cpu", cuda):
        params = {k: (v.to(dev) if not isinstance(v, dict) else
                      {a: b.to(dev) for a, b in v.items()})
                  for k, v in port_params(P).items()}
        rope = tt.make_rope_tables(ct, dev)
        bt = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        h = tt.forward_train(params, ct, tt.token_embed(params, bt["tokens"]),
                             torch.arange(12, device=dev), rope)
        st, m = tft.train_step(tft.init_state(params, ft), ct, ft, rope, bt)
        out[str(dev)] = (h.cpu(), m, st)
    np.testing.assert_allclose(out["cuda"][0].numpy(), out["cpu"][0].numpy(),
                               rtol=1e-4, atol=1e-5)
    for k in ("loss", "acc", "grad_norm"):
        np.testing.assert_allclose(float(out["cuda"][1][k]),
                                   float(out["cpu"][1][k]), rtol=1e-4)
    for x, y in zip(optim.flatten(out["cuda"][2].params)[1],
                    optim.flatten(out["cpu"][2].params)[1]):
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(),
                                   atol=1e-3 * FCFG["lr"])
