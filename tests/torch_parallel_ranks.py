"""The rank processes of ``tests/test_torch_parallel.py`` (torch only).

Run as ``python tests/torch_parallel_ranks.py JOB RANK WORLD DIR``: the
ranks of one job rendezvous through ``file://`` stores in ``DIR`` (no
port to race for), read the weights the test wrote to ``DIR/inputs.pt``
and write their results to ``DIR/JOB_RANK.pt``.

- ``dist`` (2 ranks): ``init_distributed`` from ``WORLD_SIZE``/``RANK``,
  from ``SLURM_*``, and from explicit arguments that overrule the
  environment, each with ``host_mean`` and ``shard_requests``; then the
  two-host serving path: each rank serves its ``shard_requests`` share of
  5 label requests through ``Scheduler`` + a ``BatchedEngine`` of its own;
  then one (dp=1, tp=2) row serves the 6 label requests with staggered
  arrival times while the ranks' clocks disagree and one rank alone fails
  a prefill.
- ``mesh`` (4 ranks): a (dp=1, tp=4) and a (dp=2, tp=2) mesh over one
  world; the tiny Chameleon and LlamaGen forwards at tp 2 and 4 in the
  split and fused layouts; the known-wrong variants; greedy
  ``spec.generate`` in three modes and ``BatchedEngine`` + ``Scheduler``
  over (dp=2, tp=2);
- ``gqa`` (2 ranks, from ``tests/test_torch_gqa.py``): a grouped-query
  Chameleon (4 heads over 2 KV heads) at tp 2, fused f32 and int8 logits
  and greedy stale + deferred ``spec.generate``;
- ``card`` (2 ranks, the card only): gloo on one card, the int8 bf16
  LlamaGen lane at tp 2 through the CUDA kernels against one process.
"""

from __future__ import annotations

import os
import sys
import time
import types

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from lantern_tpu_torch import configs as tc  # noqa: E402
from lantern_tpu_torch import trees as ttr  # noqa: E402
from lantern_tpu_torch.engine import scheduler as tsched  # noqa: E402
from lantern_tpu_torch.engine import spec as tspec  # noqa: E402
from lantern_tpu_torch.engine.batch import BatchedEngine  # noqa: E402
from lantern_tpu_torch.engine.scheduler import Request, Scheduler  # noqa: E402
from lantern_tpu_torch.kv import KVCache  # noqa: E402
from lantern_tpu_torch.models import transformer as tfm  # noqa: E402
from lantern_tpu_torch.ops import quant  # noqa: E402
from lantern_tpu_torch.ops.quant import quantize_params  # noqa: E402
from lantern_tpu_torch.ops.sampling import LogitsWarp  # noqa: E402
from lantern_tpu_torch.parallel import dist  # noqa: E402
from lantern_tpu_torch.parallel import mesh as pm  # noqa: E402
from chip_smoke import reduce_after_norm, skip_wo_reduce  # noqa: E402

# the tiny f32 Chameleon config (head_dim 128: G = 4 groups, so tp 2 and 4
# split attention; swin post-norm, QK-norm) and the tiny LlamaGen label
# config (four heads of 64, two a group: G = 2, so tp 4 replicates
# attention and splits the FFN)
CHAM_KW = dict(vocab_size=512, hidden_size=512, num_layers=2, num_heads=4,
               rope_kind="1d", cond_kind="none", qk_norm=True,
               swin_norm=True, max_seq_len=64)
LG_KW = dict(cond_kind="label", vocab_size=256, hidden_size=256,
             num_layers=2, num_heads=4, block_size=16, max_seq_len=96)
FWD_T = 6                                   # rows of the forward block
TREE = "mc_sim_7b_63"
MAX_NEW = 16
MODES = {
    "stale+deferred": dict(stale_draft=True, deferred_commit=True),
    "drafter+rollback": dict(stale_draft=False, deferred_commit=False),
    "dynamic": dict(mode="dynamic"),
}
# the scheduler runs: 6 label requests on 4 slots (slot reuse)
LABELS = [3, 5, 7, 2, 6, 1]
SLOTS = 4
SERVE_NEW = 10
WRONG_LAYER = 1                             # the layer skip_wo_reduce hits
# the tp row's timed run: arrival offsets (seconds) of the 6 requests, and
# the request whose prefill one rank alone fails
ARRIVALS = [0.0, 0.0, 0.15, 0.3, 0.3, 0.45]
FAIL_UID = 2


def spec_config(kw: dict, max_new: int = MAX_NEW, **over):
    return tspec.SpecDecodeConfig(warp=LogitsWarp(temperature=0.0),
                                  cfg_scale=3.0, max_new=max_new,
                                  walk_batch_warp=True, kv_quant=True,
                                  **dict(kw, **over))


def forward_logits(cfg, params, ids, mesh=None):
    """Final hidden and logits of one causal block forward over ``ids``
    (``[2, T]``) into an empty cache, under ``mesh``."""
    dev = ids.device
    rope = tfm.make_rope_tables(cfg, dev)
    with pm.set_mesh(mesh):
        kv = KVCache.create(cfg, 2, device=dev,
                            groups=tfm.cache_groups(cfg, params))
        res = tfm.forward(params, cfg, tfm.token_embed(params, ids), kv,
                          torch.arange(ids.shape[1], device=dev), rope)
        return res.hidden, tfm.logits_head(params, res.hidden), kv.k.shape[2]


def sharded(cfg, params, mesh):
    return pm.shard_pytree(params, pm.base_param_specs(cfg, mesh, params),
                           mesh)


def serve(cfg, dcfg, params, dparams, labels, mesh=None, slots=SLOTS,
          uids=None, native=False):
    """Greedy static requests through ``Scheduler`` (the Python loop, or
    the native queue)."""
    eng = BatchedEngine(spec_config(MODES["drafter+rollback"], SERVE_NEW),
                        cfg, ttr.get_tree(TREE), params, slots,
                        dparams=dparams, dcfg=dcfg, device="cpu", mesh=mesh)
    uids = list(range(len(labels))) if uids is None else uids
    reqs = [Request(uid=u, cond=torch.tensor([lab]),
                    uncond=torch.tensor([cfg.num_classes]), seed=40 + u)
            for u, lab in zip(uids, labels)]
    done = Scheduler(eng, use_native=native).run(reqs)
    return [(r.uid, r.error, None if r.tokens is None else r.tokens.tolist(),
             r.steps) for r in done]


def serve_row(cfg, dcfg, params, dparams, mesh, native):
    """The 6 label requests on one (dp=1, tp=2) row with the arrival times
    ``ARRIVALS``, where the ranks would decide apart: tp rank 1's clock
    runs 1000 times fast (alone, it would admit every request at once),
    and tp rank 1 alone fails request ``FAIL_UID``'s prefill after its
    forward ran."""
    eng = BatchedEngine(spec_config(MODES["drafter+rollback"], SERVE_NEW),
                        cfg, ttr.get_tree(TREE), params, SLOTS,
                        dparams=dparams, dcfg=dcfg, device="cpu", mesh=mesh)
    clock = tsched.time
    if mesh.tp_rank == 1:
        prefill = eng.prefill

        def failing(cond, *a, **k):
            out = prefill(cond, *a, **k)
            if int(cond[0]) == LABELS[FAIL_UID]:
                raise RuntimeError("prefill failed on tp rank 1 alone")
            return out

        eng.prefill = failing
        tsched.time = types.SimpleNamespace(
            perf_counter=lambda: 1000.0 * time.perf_counter(),
            sleep=time.sleep)
    reqs = [Request(uid=u, cond=torch.tensor([lab]),
                    uncond=torch.tensor([cfg.num_classes]), seed=40 + u,
                    arrival_time=ARRIVALS[u])
            for u, lab in enumerate(LABELS)]
    try:
        done = Scheduler(eng, use_native=native).run(reqs)
    finally:
        tsched.time = clock
    return [(r.uid, r.error, None if r.tokens is None else r.tokens.tolist(),
             r.steps) for r in done]


def job_dist(rank: int, world: int, root: str, inp: dict) -> dict:
    out = {}
    env = os.environ
    for var in ("WORLD_SIZE", "RANK", "SLURM_NPROCS", "SLURM_PROCID",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)

    def probe(tag, info):
        out[tag] = dict(
            pid=info["process_id"], n=info["num_processes"],
            n_local=len(info["local_devices"]),
            n_global=len(info["global_devices"]),
            main=dist.is_main_process(),
            mean=dist.host_mean(10.0 + 20.0 * info["process_id"]),
            shard=list(dist.shard_requests(list(range(7)))))

    env.update(WORLD_SIZE=str(world), RANK=str(rank))
    probe("env", dist.init_distributed(f"file://{root}/env", device="cpu"))
    torch.distributed.destroy_process_group()
    env.pop("WORLD_SIZE"), env.pop("RANK")
    env.update(SLURM_NPROCS=str(world), SLURM_PROCID=str(rank))
    probe("slurm", dist.init_distributed(f"file://{root}/slurm",
                                         device="cpu"))
    torch.distributed.destroy_process_group()
    # explicit arguments overrule a contradicting environment
    env.update(SLURM_NPROCS="5", SLURM_PROCID=str(1 - rank))
    probe("explicit", dist.init_distributed(
        f"file://{root}/explicit", num_processes=world, process_id=rank,
        device="cpu"))
    # the two-host serving path: each host serves its share of the
    # requests on an engine of its own; no collective in the decode loop
    lg = inp["lg"]
    mine = list(dist.shard_requests(list(range(5))))
    served = serve(lg["cfg"], lg["dcfg"], lg["q"], lg["dq"],
                   [LABELS[i] for i in mine], slots=2, uids=mine)
    out["serve"] = dict(mine=mine, served=served,
                        total=dist.host_mean(float(len(served))) * world)
    # the same two processes as one tp row
    row = pm.make_mesh(dp=1)
    sp = sharded(lg["cfg"], lg["q"], row)
    for loop in ("python", "native"):
        out[f"serve_row/{loop}"] = serve_row(lg["cfg"], lg["dcfg"], sp,
                                             lg["dq"], row, loop == "native")
    return out


def job_mesh(rank: int, world: int, root: str, inp: dict) -> dict:
    dist.init_distributed(f"file://{root}/mesh", world, rank, device="cpu")
    m4, m22 = pm.make_mesh(dp=1), pm.make_mesh(dp=2)
    out = {"coords": [(m.dp_rank, m.tp_rank) for m in (m4, m22)]}
    # the head's gather: a vocab-split head's logits, gathered on the last
    # dim (the form head_matmul calls)
    for tag, m in (("tp2", m22), ("tp4", m4)):
        x = torch.randn((2, 3, 5),
                        generator=torch.Generator().manual_seed(rank))
        head = quant.VocabShard(torch.eye(5), m.tp_group)
        out[f"gather/{tag}"] = (dist.all_gather(x, -1, m.tp_group),
                                quant.head_matmul(x[0], head), x)
    # the forwards: both families, tp 2 and 4, split and fused layouts
    for name in ("cham", "lg"):
        cfg, p, ids = inp[name]["cfg"], inp[name]["p"], inp[name]["ids"]
        for tag, mesh in (("tp2", m22), ("tp4", m4)):
            for layout in ("split", "fused"):
                q = p if layout == "split" else tfm.fuse_params(p)
                h, lg, groups = forward_logits(cfg, sharded(cfg, q, mesh),
                                               ids, mesh)
                out[f"fwd/{name}/{tag}/{layout}"] = (h, lg, groups)
    # the known-wrong variants, beside the right layout, on int8 weights
    cfg, p, ids = inp["cham"]["cfg"], inp["cham"]["p"], inp["cham"]["ids"]
    dense = tfm.fuse_params(p)
    full = quantize_params(dense)
    right = sharded(cfg, full, m22)
    _, ref, _ = forward_logits(cfg, full, ids)
    _, got, _ = forward_logits(cfg, right, ids, m22)
    wrong = {}
    with skip_wo_reduce(WRONG_LAYER):
        wrong["skip_wo_reduce"] = forward_logits(cfg, right, ids, m22)[1]
    with reduce_after_norm():
        wrong["reduce_after_norm"] = forward_logits(cfg, right, ids, m22)[1]
    per_shard = quantize_params(sharded(cfg, dense, m22))
    wrong["quantize_per_shard"] = forward_logits(cfg, per_shard, ids, m22)[1]
    out["int8"] = dict(ref=ref, got=got, wrong=wrong,
                       wo_s=(right["layers"]["wo_s"], per_shard["layers"]["wo_s"],
                             full["layers"]["wo_s"]))
    # greedy spec decoding over (dp=2, tp=2), int8 weights and KV
    lg = inp["lg"]
    cfg, dcfg = lg["cfg"], lg["dcfg"]
    sp = sharded(cfg, lg["q"], m22)
    for mode, kw in MODES.items():
        static = kw.get("mode", "static") == "static"
        with pm.set_mesh(m22):
            r = tspec.generate(
                sp, spec_config(kw), cfg, ttr.get_tree(TREE) if static
                else None, None, device="cpu", dparams=lg["dq"], dcfg=dcfg,
                cond=torch.tensor([3]), uncond=torch.tensor([cfg.num_classes]))
        out[f"gen/{mode}"] = (r.tokens.tolist(), int(r.steps),
                              int(r.accept_sum), int(r.n_valid))
    # batched serving: slots over dp, weights and KV over tp
    out["serve/python"] = serve(cfg, dcfg, sp, lg["dq"], LABELS, mesh=m22)
    out["serve/native"] = serve(cfg, dcfg, sp, lg["dq"], LABELS, mesh=m22,
                                native=True)
    try:
        BatchedEngine(spec_config(MODES["drafter+rollback"]), cfg,
                      ttr.get_tree(TREE), sp, 3, dparams=lg["dq"], dcfg=dcfg,
                      device="cpu", mesh=m22)
        out["odd_slots"] = None
    except ValueError as e:
        out["odd_slots"] = str(e)
    return out


def job_gqa(rank: int, world: int, root: str, inp: dict) -> dict:
    """Grouped-query attention over a (dp=1, tp=2) mesh: the fused f32 and
    int8 Chameleon forwards' logits, and greedy stale + deferred
    ``spec.generate`` over the 4x4 Lumina prompt (no grid FSM)."""
    from lantern_tpu_torch.models import chameleon as cham

    dist.init_distributed(f"file://{root}/gqa", world, rank, device="cpu")
    mesh = pm.make_mesh(dp=1)
    cfg, ids = inp["cfg"], inp["ids"]
    out = {}
    for name in ("f32", "int8"):
        sp = sharded(cfg, inp["p" if name == "f32" else "q"], mesh)
        _, out[name], out["groups"] = forward_logits(cfg, sp, ids, mesh)
    out["heads"] = tfm.head_counts(cfg, sp["layers"])
    ecfg = spec_config(dict(stale_draft=True, deferred_commit=True), 8)
    tp = cham.lumina_token_prompt([60, 61, 62, 63, 9], grid=(4, 4))
    with pm.set_mesh(mesh):
        r = tspec.generate(sp, ecfg, cfg, ttr.get_tree(
            os.path.join(REPO, "ckpts", "bench_tree_lumina.json")), tp, None,
            device="cpu")
    out["tokens"], out["steps"] = r.tokens.tolist(), int(r.steps)
    return out


def job_card(rank: int, world: int, root: str, inp: dict) -> dict:
    """Two ranks on one card over gloo: the int8 bf16 LlamaGen lane at tp 2
    through the CUDA kernels against one process on the same card."""
    from lantern_tpu_torch.models import drafter as drf
    from lantern_tpu_torch.ops import _cuda

    dist.init_distributed(f"file://{root}/card", world, rank,
                          device="cuda:0", backend="gloo")
    mesh = pm.make_mesh(dp=1)
    cfg = tc.tiny_config(**dict(LG_KW, dtype="bfloat16"))
    dcfg = tc.drafter_config(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = tfm.init_params(gen, cfg, device="cuda")
    d = drf.init_drafter_params(gen, dcfg, p["embed"])
    p, d = quantize_params(tfm.fuse_params(p)), quantize_params(
        tfm.fuse_params(d))
    ids = torch.randint(0, cfg.vocab_size, (2, FWD_T), device="cuda",
                        generator=gen)
    sp = sharded(cfg, p, mesh)
    ecfg = spec_config(MODES["stale+deferred"])
    tree = ttr.get_tree(TREE)

    def run(params, m):
        with pm.set_mesh(m):
            r = tspec.generate(params, ecfg, cfg, tree, None, device="cuda",
                               dparams=d, dcfg=dcfg,
                               cond=torch.tensor([3], device="cuda"),
                               uncond=torch.tensor([cfg.num_classes],
                                                   device="cuda"))
        return r.tokens.tolist()

    out = {"ref": forward_logits(cfg, p, ids)[1].cpu(),
           "ref_tokens": run(p, None)}
    _cuda.reset_launches()
    out["got"] = forward_logits(cfg, sp, ids, mesh)[1].cpu()
    out["tokens"] = run(sp, mesh)
    torch.cuda.synchronize()
    out["launches"] = dict(_cuda.LAUNCHES)
    return out


def main(argv) -> None:
    job, rank, world, root = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    path = os.path.join(root, "inputs.pt")
    inp = (torch.load(path, weights_only=False) if os.path.exists(path)
           else {})
    out = {"dist": job_dist, "mesh": job_mesh, "gqa": job_gqa,
           "card": job_card}[job](rank, world, root, inp)
    torch.save(out, os.path.join(root, f"{job}_{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
