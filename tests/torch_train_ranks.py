"""The rank processes of ``tests/test_torch_pipeline.py`` and
``tests/test_torch_fsdp.py`` (torch only), and their launcher.

Run as ``python tests/torch_train_ranks.py JOB RANK WORLD DIR``: the ranks
of one job rendezvous through a ``file://`` store in ``DIR`` (no port to
race for), read what the test wrote to ``DIR/JOB.pt`` and write their
results to ``DIR/JOB_RANK.pt``.

- ``pipe2`` (2 ranks, pp = 2): ``pipeline_loss_fn`` loss, accuracy and
  gradients (``value_and_grad``) at 2 and 4 microbatches, with a per-row
  and a shared ``[1, T]`` ``attn_valid``, and two ``make_train_step``
  steps;
- ``pipe4`` (4 ranks): pp = 4 at 4 microbatches, and (dp = 2, pp = 2);
- ``fsdp`` (4 ranks): ``train_step(mesh=)`` for two steps at (dp = 2,
  tp = 2) and (dp = 1, tp = 4), and at (dp = 2, tp = 2) with a clip that
  bites, right and with each known-wrong variant (the clip by the shard's
  own norm, the dp sum of the split leaves' gradients left out);
- ``fsdp_ckpt`` (tp = 2 at the input's dp: 2 or 4 ranks): three
  uninterrupted steps, and two steps saved by ``save_checkpoint(mesh=)``,
  restored into a fresh state and stepped once (its gathered parameters
  kept); ``save_checkpoint`` without ``mesh=``; four more steps saved
  with ``keep_last=2``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from lantern_tpu_torch.models import transformer as tfm  # noqa: E402
from lantern_tpu_torch.parallel import dist  # noqa: E402
from lantern_tpu_torch.parallel import mesh as pm  # noqa: E402
from lantern_tpu_torch.parallel import pipeline as pl  # noqa: E402
from lantern_tpu_torch.train import finetune as ft  # noqa: E402
from lantern_tpu_torch.train.optim import global_norm  # noqa: E402

RANK_TIMEOUT = 240          # seconds a rank process may take
TRAIN_STEPS = 2


def launch(job: str, world: int, root) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         str(root)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]


def collect(job: str, procs: list, root):
    """Every rank's results, or a message: a rank that fails or outlives
    its timeout fails the job (and the others are killed)."""
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
            errs.append(f"{job} rank {r} timed out:\n{err[-3000:]}")
            continue
        if p.returncode != 0:
            errs.append(f"{job} rank {r} exited {p.returncode}:\n{err[-3000:]}")
    if errs:
        return "\n".join(errs)
    return [torch.load(os.path.join(root, f"{job}_{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def assert_adam_close(got, want, lr: float, steps: int, what: str) -> None:
    """Weights after ``steps`` AdamW steps from gradients summed in another
    order: within ``1e-3 * lr * steps``, as one process holds them to JAX,
    but for at most one in 10^3 a leaf (at least one), and every weight
    within ``lr * steps``.  Near ``eps`` (1e-8) AdamW's step is ``lr * g /
    eps``: a gradient that cancels to ~1e-9 moves its weight by a share of
    lr when its summation order changes it by 1e-10 (JAX's own pipeline
    and finetune steps differ so, in fewer weights)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    loose = int((d > 1e-3 * lr * steps).sum())
    assert loose <= max(1, d.size // 10 ** 3), (what, loose, d.size)
    assert d.max() <= lr * steps, (what, float(d.max()))


def copy(tree):
    return {k: copy(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def pipe_grads(inp, mesh, n_micro, batch):
    cfg, p = inp["cfg"], inp["params"]
    rope = tfm.make_rope_tables(cfg, "cpu")
    loss_fn = pl.pipeline_loss_fn(cfg, mesh, n_micro, rope, remat=False)
    (loss, acc), (gp, gs) = pl.value_and_grad(
        loss_fn, mesh, p, pl.stage_layers(p["layers"], mesh), batch)
    return dict(loss=loss, acc=acc, params=gp, stage=gs)


def job_pipe2(rank: int, world: int, root: str, inp: dict) -> dict:
    dist.init_distributed(f"file://{root}/pipe2", world, rank, device="cpu")
    mesh = pl.make_mesh(dp=1)
    out = {"coords": (mesh.dp_rank, mesh.stage)}
    for n in (2, 4):
        out[f"m{n}"] = pipe_grads(inp, mesh, n, inp["batch"])
    out["pad_rows"] = pipe_grads(inp, mesh, 2, inp["batch_pads"])
    shared = dict(inp["batch"], attn_valid=torch.ones((1, 16)))
    out["shared"] = pipe_grads(inp, mesh, 2, shared)
    cfg, fcfg = inp["cfg"], inp["fcfg"]
    params = copy(inp["params"])
    staged = pl.stage_layers(params.pop("layers"), mesh)
    step_fn, init_fn = pl.make_train_step(
        cfg, mesh, 2, tfm.make_rope_tables(cfg, "cpu"), fcfg)
    opt = init_fn(params, staged)
    out["steps"] = []
    for _ in range(TRAIN_STEPS):
        params, staged, opt, m = step_fn(params, staged, opt, inp["batch"])
        out["steps"].append({k: float(v) for k, v in m.items()})
    out["trained"] = dict(params=params, stage=staged)
    return out


def job_pipe4(rank: int, world: int, root: str, inp: dict) -> dict:
    dist.init_distributed(f"file://{root}/pipe4", world, rank, device="cpu")
    out = {}
    for tag, dp, n in (("pp4", 1, 4), ("dp2pp2", 2, 2)):
        mesh = pl.make_mesh(dp=dp)
        out[tag] = dict(pipe_grads(inp, mesh, n, inp["batch"]),
                        coords=(mesh.dp_rank, mesh.stage))
    return out


def skip_dp_sum(grads, sharded, dp_group):
    """Known-wrong: the split leaves' gradients not summed over dp."""
    for g, part in zip(grads, sharded):
        if not part:
            dist.all_reduce(g)


def shard_norm(grads, sharded, group):
    """Known-wrong: the clip by this rank's own gradients' norm."""
    return global_norm(grads)


def fsdp_run(inp, mesh, fcfg):
    cfg = inp["cfg"]
    rope = tfm.make_rope_tables(cfg, "cpu")
    state = ft.init_state(copy(inp["params"]), fcfg, mesh=mesh)
    shapes = [tuple(x.shape) for x in ft.flatten(state.params)[1]]
    steps = []
    for _ in range(TRAIN_STEPS):
        state, m = ft.train_step(state, cfg, fcfg, rope, inp["batch"],
                                 mesh=mesh)
        steps.append({k: float(v) for k, v in m.items()})
    return dict(steps=steps, shapes=shapes, specs=state.specs,
                params=ft.fsdp_gather(state, mesh),
                coords=(mesh.dp_rank, mesh.tp_rank))


def job_fsdp(rank: int, world: int, root: str, inp: dict) -> dict:
    dist.init_distributed(f"file://{root}/fsdp", world, rank, device="cpu")
    m22, m14 = pm.make_mesh(dp=2), pm.make_mesh(dp=1)
    out = {"dp2tp2": fsdp_run(inp, m22, inp["fcfg"]),
           "dp1tp4": fsdp_run(inp, m14, inp["fcfg"]),
           "clip": fsdp_run(inp, m22, inp["fcfg_clip"])}
    for name, attr, fn in (("shard_norm", "sharded_global_norm", shard_norm),
                           ("skip_dp_sum", "sum_grads_", skip_dp_sum)):
        right = getattr(ft, attr)
        setattr(ft, attr, fn)
        try:
            out[name] = fsdp_run(inp, m22, inp["fcfg_clip"])
        finally:
            setattr(ft, attr, right)
    return out


def _sharded(state) -> dict:
    """Copies of a state's own tensors (this rank's slices; a step updates
    them in place), its count and step."""
    opt = state.opt_state
    return dict(params=[x.clone() for x in ft.flatten(state.params)[1]],
                mu=[x.clone() for x in opt.mu],
                nu=[x.clone() for x in opt.nu], count=opt.count,
                step=state.step)


def job_fsdp_ckpt(rank: int, world: int, root: str, inp: dict) -> dict:
    dist.init_distributed(f"file://{root}/fsdp_ckpt", world, rank,
                          device="cpu")
    mesh = pm.make_mesh(dp=inp["dp"])
    cfg, fcfg, batch = inp["cfg"], inp["fcfg"], inp["batch"]
    rope = tfm.make_rope_tables(cfg, "cpu")
    ckdir = os.path.join(root, "ckpt")

    def fresh():
        return ft.init_state(copy(inp["params"]), fcfg, mesh=mesh)

    def step(state):
        return ft.train_step(state, cfg, fcfg, rope, batch, mesh=mesh)

    run, metrics = fresh(), []
    for _ in range(3):
        run, m = step(run)
        metrics.append({k: v.clone() for k, v in m.items()})
    saved = fresh()
    for _ in range(2):
        saved, _ = step(saved)
    try:
        ft.save_checkpoint(ckdir, saved)
        refused = None
    except ValueError as e:
        refused = str(e)
    path = ft.save_checkpoint(ckdir, saved, mesh=mesh)
    resumed = ft.restore_checkpoint(ckdir, fresh(), mesh=mesh)
    restored = _sharded(resumed)
    resumed, m = step(resumed)
    out = dict(run=_sharded(run), saved=_sharded(saved), restored=restored,
               resumed=_sharded(resumed), run_metrics=metrics[-1],
               resumed_metrics=m, refused=refused,
               path=os.path.basename(path),
               # a copy: the steps below update the unsplit leaves in place
               resumed_params=copy(ft.fsdp_gather(resumed, mesh)),
               coords=(mesh.dp_rank, mesh.tp_rank))
    for _ in range(4):
        resumed, _ = step(resumed)
        ft.save_checkpoint(ckdir, resumed, keep_last=2, mesh=mesh)
    whole = ft.fsdp_whole_state(resumed, mesh)
    out.update(kept=sorted(os.listdir(ckdir)), whole=dict(
        params=whole.params, mu=whole.opt_state.mu, nu=whole.opt_state.nu,
        count=whole.opt_state.count, step=whole.step))
    return out


def main(argv) -> None:
    job, rank, world, root = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(root, f"{job}.pt"), weights_only=False)
    out = {"pipe2": job_pipe2, "pipe4": job_pipe4, "fsdp": job_fsdp,
           "fsdp_ckpt": job_fsdp_ckpt}[job](rank, world, root, inp)
    torch.save(out, os.path.join(root, f"{job}_{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
