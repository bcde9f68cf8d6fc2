"""The port's tensor- and data-parallel serving against ``lantern_tpu``.

``lantern_tpu_torch/parallel`` runs over ``torch.distributed`` (gloo on
the CPU here); the JAX package's ``parallel`` over a ``jax.sharding`` mesh
of the conftest's 8 virtual devices.  Checked:

- ``dist``: the rendezvous precedence (arguments, then ``WORLD_SIZE`` /
  ``RANK`` / ``MASTER_*``, then ``SLURM_*``) and, over 2 ranks,
  ``host_mean`` and ``shard_requests`` as ``tests/test_dist_multiprocess.py``
  expects them of the JAX module, and its two-host serving path;
- the sharding rules leaf for leaf against the JAX ``PartitionSpec``s
  (tiny and published configs, split, fused and int8 trees, tp 1-8), with
  the port's one documented difference: attention is replicated where the
  cache's head groups do not divide;
- shard / gather round trips, shard-then-fuse, quantize-then-shard;
- the tp 2 and tp 4 forwards within f32 tolerance of the JAX forward,
  every rank's logits equal byte for byte, and each known-wrong variant
  (``chip_smoke.py`` builds them) above the tolerance the right layout
  meets;
- greedy ``spec.generate`` token-exact against JAX single-device and
  sharded at (dp=2, tp=2), static stale + deferred, drafter + rollback and
  dynamic, int8 weights and KV; ``BatchedEngine`` + ``Scheduler`` over
  (dp=2, tp=2) against the JAX scheduler, and over (dp=1, tp=2) with
  staggered arrivals, disagreeing clocks and a prefill failure on one
  rank.

The rank processes (``tests/torch_parallel_ranks.py``) run while the JAX
references are computed, rendezvous through ``file://`` stores (no port),
and each ``communicate`` has a timeout, so a hung rank fails the module's
tests instead of the suite's time limit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from lantern_tpu import configs as jc
from lantern_tpu import kv as jkv
from lantern_tpu import trees as jt
from lantern_tpu.engine import batch as jbatch
from lantern_tpu.engine import scheduler as jsched
from lantern_tpu.engine import spec as jspec
from lantern_tpu.models import drafter as jdrf
from lantern_tpu.models import transformer as jtfm
from lantern_tpu.ops import quant as jq
from lantern_tpu.ops.sampling import LogitsWarp as JWarp
from lantern_tpu.parallel import mesh as jpm
from lantern_tpu_torch import configs as tc
from lantern_tpu_torch import convert
from lantern_tpu_torch.kv import KVCache, group_dims
from lantern_tpu_torch.models import transformer as ttfm
from lantern_tpu_torch.ops.quant import quantize_params
from lantern_tpu_torch.parallel import dist
from lantern_tpu_torch.parallel import mesh as pm

# the tp forwards against JAX's one-device f32 forward: f32 sums in
# another order (per rank, then over ranks)
HIDDEN_TOL = dict(rtol=1e-5, atol=1e-5)
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
# the tp int8 forward against one process on the same weights, relative
# to the logits' scale; every known-wrong variant must land above it
REL_TOL = 1e-4
RANK_TIMEOUT = 240          # seconds a rank process may take
SPEC_TPS = (1, 2, 4, 8)
# attention leaves: replicated by the port where the head groups do not
# divide tp (JAX shards them by head there)
ATTN = ("wq", "wk", "wv", "wo", "wqkv", "q_norm_w", "q_norm_b", "k_norm_w",
        "k_norm_b")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def lg_weights():
    """The tiny LlamaGen label lane: f32 split weights, and int8 fused base
    (with a nearest table) and drafter weights."""
    cfg = jc.tiny_config(**ranks.LG_KW)
    dcfg = jc.drafter_config(cfg)
    p = jtfm.init_params(jax.random.key(0), cfg)
    d = jdrf.init_drafter_params(jax.random.key(1), dcfg, p["embed"])
    q = jq.quantize_params(jtfm.fuse_params(p))
    V = cfg.vocab_size
    q = dict(q, nearest_latents=jnp.asarray(np.random.default_rng(0).integers(
        0, V, size=(V, 11)), jnp.int32))
    dq = jq.quantize_params(jtfm.fuse_params(d))
    return cfg, dcfg, p, q, dq


def jax_forward(cfg, p, ids):
    rope = jtfm.make_rope_tables(cfg)
    res = jtfm.forward(p, cfg, jtfm.token_embed(p, jnp.asarray(ids)),
                       jkv.KVCache.create(cfg, 2), jnp.arange(ids.shape[1]),
                       rope)
    return np.asarray(res.hidden), np.asarray(jtfm.logits_head(p, res.hidden))


def jax_ecfg(kw, max_new=ranks.MAX_NEW):
    return jspec.SpecDecodeConfig(warp=JWarp(temperature=0.0), cfg_scale=3.0,
                                  max_new=max_new, walk_batch_warp=True,
                                  kv_quant=True, **kw)


def launch(job, world, root):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    script = os.path.join(os.path.dirname(__file__), "torch_parallel_ranks.py")
    return [subprocess.Popen(
        [sys.executable, script, job, str(r), str(world), str(root)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def collect(job, procs, root):
    """Every rank's results; a rank that fails or outlives its timeout
    fails the job (and the others are killed)."""
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both rank jobs (2 ranks ``dist``, 4 ranks ``mesh``), run beside the
    JAX references."""
    root = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(5)
    ccfg = jc.tiny_config(**ranks.CHAM_KW)
    cp = jtfm.init_params(jax.random.key(3), ccfg)
    cids = rng.integers(0, ccfg.vocab_size, size=(2, ranks.FWD_T))
    cfg, dcfg, p, q, dq = lg_weights()
    lids = rng.integers(0, cfg.vocab_size, size=(2, ranks.FWD_T))
    tcfg = tc.tiny_config(**ranks.LG_KW)
    tdcfg = tc.drafter_config(tcfg)
    pt_q = convert.convert_params(np_tree(q), device="cpu")
    inputs = {
        "cham": dict(cfg=tc.tiny_config(**ranks.CHAM_KW),
                     p=convert.convert_params(np_tree(cp), device="cpu"),
                     ids=torch.from_numpy(cids)),
        "lg": dict(cfg=tcfg, dcfg=tdcfg,
                   p=convert.convert_params(np_tree(p), device="cpu"),
                   ids=torch.from_numpy(lids), q=pt_q,
                   dq=convert.convert_drafter_params(
                       np_tree(dq), device="cpu", embed=pt_q["embed"])),
    }
    torch.save(inputs, root / "inputs.pt")
    procs = {"dist": launch("dist", 2, root), "mesh": launch("mesh", 4, root)}

    refs = {"fwd/cham": jax_forward(ccfg, cp, cids),
            "fwd/lg": jax_forward(cfg, p, lids)}
    tree = jt.get_tree(ranks.TREE)
    cond, uncond = jnp.asarray([3]), jnp.asarray([cfg.num_classes])
    mesh = jpm.make_mesh(4, dp=2)
    sp = jpm.shard_pytree(q, jpm.base_param_specs(cfg, mesh, q), mesh)
    sd = jpm.shard_pytree(dq, jpm.drafter_param_specs(dq), mesh)
    for mode, kw in ranks.MODES.items():
        t = tree if kw.get("mode", "static") == "static" else None
        one = jspec.generate(q, dq, jax_ecfg(kw), cfg, dcfg, t, cond, uncond,
                             jax.random.key(3))
        with jax.set_mesh(mesh):
            shd = jspec.generate(sp, sd, jax_ecfg(kw), cfg, dcfg, t, cond,
                                 uncond, jax.random.key(3))
        refs[f"gen/{mode}"] = [
            (np.asarray(r.tokens).tolist(), int(r.steps), int(r.accept_sum),
             int(r.n_valid)) for r in (one, shd)]
    eng = jbatch.BatchedEngine(
        jax_ecfg(ranks.MODES["drafter+rollback"], ranks.SERVE_NEW), cfg,
        dcfg, tree, q, dq, num_slots=ranks.SLOTS)
    done = jsched.Scheduler(eng, use_native=False).run([
        jsched.Request(uid=i, cond=jnp.asarray([lab]), uncond=uncond,
                       seed=40 + i) for i, lab in enumerate(ranks.LABELS)])
    refs["serve"] = [(r.uid, r.error, np.asarray(r.tokens).tolist(), r.steps)
                     for r in done]
    return dict(refs=refs, dist=collect("dist", procs["dist"], root),
                mesh=collect("mesh", procs["mesh"], root))


def results(world, job):
    out = world[job]
    if isinstance(out, str):
        pytest.fail(out)
    return out


# ---------------------------------------------------------------------------
# dist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,env,want", [
    ((None, None, None), {}, (None, None, None)),
    ((None, None, None), dict(WORLD_SIZE="4", RANK="2", MASTER_ADDR="h",
                              MASTER_PORT="29500"),
     ("tcp://h:29500", 4, 2)),
    ((None, None, None), dict(WORLD_SIZE="2", MASTER_ADDR="h"),
     ("tcp://h:1234", 2, 0)),
    ((None, None, None), dict(SLURM_NPROCS="8", SLURM_PROCID="5"),
     (None, 8, 5)),
    ((None, None, None), dict(WORLD_SIZE="3", RANK="1", SLURM_NPROCS="8",
                              SLURM_PROCID="5"), (None, 3, 1)),
    (("file:///tmp/x", 2, 1), dict(WORLD_SIZE="4", RANK="3",
                                   MASTER_ADDR="h"),
     ("file:///tmp/x", 2, 1)),
    (("c:7", None, None), dict(WORLD_SIZE="2", RANK="1"), ("tcp://c:7", 2, 1)),
], ids=["alone", "env", "env-default-port", "slurm", "env-over-slurm",
        "explicit-wins", "explicit-coordinator"])
def test_resolve_precedence(args, env, want):
    assert dist.resolve(*args, env=env) == want


def test_single_process_without_env(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "SLURM_NPROCS", "SLURM_PROCID",
                "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    info = dist.init_distributed(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (info["process_id"], info["num_processes"]) == (0, 1)
    assert info["local_devices"] == info["global_devices"] == [
        torch.device("cpu")]
    assert dist.is_main_process()
    assert dist.host_mean(3.5) == 3.5
    assert dist.shard_requests(list(range(7))) == list(range(7))
    assert dist.shard_requests(list(range(7)), 1, 3) == [1, 4]


def test_init_refuses_to_fall_back(monkeypatch, tmp_path):
    """The default is NCCL on a card: with no card it raises instead of
    running gloo on the CPU; NCCL on the CPU raises too."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dist.init_distributed(f"file://{tmp_path}/a", 1, 0)
    with pytest.raises(ValueError, match="NCCL"):
        dist.init_distributed(f"file://{tmp_path}/b", 1, 0, device="cpu",
                              backend="nccl")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("how", ["env", "slurm", "explicit"])
def test_two_ranks_init(world, how):
    """``tests/test_dist_multiprocess.py``'s expectations of the JAX
    module: two processes, rank 0 main, the mean of 10 and 30 is 20, and
    ``shard_requests`` partitions 7 items."""
    outs = [o[how] for o in results(world, "dist")]
    assert [o["pid"] for o in outs] == [0, 1]
    for o in outs:
        assert (o["n"], o["n_local"], o["n_global"]) == (2, 1, 2)
        assert o["mean"] == pytest.approx(20.0)
    assert [o["main"] for o in outs] == [True, False]
    assert outs[0]["shard"] == [0, 2, 4, 6] and outs[1]["shard"] == [1, 3, 5]


def test_two_host_serving(world):
    """Each host serves its ``shard_requests`` share on an engine of its
    own: the shares partition the requests, and every request's tokens are
    the JAX single-process scheduler's."""
    outs = [o["serve"] for o in results(world, "dist")]
    ref = {uid: (toks, steps) for uid, _, toks, steps in world["refs"]["serve"]}
    assert [o["mine"] for o in outs] == [[0, 2, 4], [1, 3]]
    served = [s for o in outs for s in o["served"]]
    assert sorted(s[0] for s in served) == list(range(5))
    for uid, err, toks, steps in served:
        assert err is None
        assert (toks, steps) == ref[uid], uid
    for o in outs:
        assert o["total"] == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

SPEC_CFGS = {
    "tiny_chameleon": lambda m: m.tiny_config(**ranks.CHAM_KW),
    "tiny_llamagen": lambda m: m.tiny_config(**ranks.LG_KW),
    "lumina_7b": lambda m: m.chameleon_7b_config(swin_norm=True),
    "llamagen_xl": lambda m: m.llamagen_config("XL", "t2i"),
}


def shape_trees(cfg_j, layout):
    """The JAX params tree as shapes, and the port's as meta tensors."""
    def build(key):
        p = jtfm.init_params(key, cfg_j)
        if layout != "split":
            p = jtfm.fuse_params(p)
        if layout == "int8":
            p = jq.quantize_params(p)
        return p

    shapes = jax.eval_shape(build, jax.random.key(0))
    return shapes, jax.tree.map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.mark.parametrize("layout", ["split", "fused", "int8"])
@pytest.mark.parametrize("tp", SPEC_TPS)
@pytest.mark.parametrize("name", list(SPEC_CFGS))
def test_param_specs_match_jax(name, tp, layout):
    cfg_j, cfg_t = SPEC_CFGS[name](jc), SPEC_CFGS[name](tc)
    shapes, meta = shape_trees(cfg_j, layout)
    jmesh, mesh = jpm.make_mesh(tp, dp=1), pm.Mesh(dp=1, tp=tp)
    want = flat(jax.tree.map(
        tuple, jpm.base_param_specs(cfg_j, jmesh, shapes),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    got = flat(pm.base_param_specs(cfg_t, mesh, meta))
    assert set(got) == set(want)
    G, _ = group_dims(cfg_t.num_kv_heads, cfg_t.head_dim)
    for path, spec in got.items():
        base = path[-1][:-2] if path[-1].endswith(("_q", "_s")) else path[-1]
        if G % tp and base in ATTN:
            assert all(a is None for a in spec), path
        else:
            assert spec == want[path], path
    # the difference exists only where the groups do not divide
    differs = [p for p in got if got[p] != want[p]]
    assert bool(differs) == bool(G % tp and cfg_t.num_heads % tp == 0)


@pytest.mark.parametrize("tp", SPEC_TPS)
@pytest.mark.parametrize("name", list(SPEC_CFGS))
def test_kv_and_drafter_specs_match_jax(name, tp):
    cfg_j, cfg_t = SPEC_CFGS[name](jc), SPEC_CFGS[name](tc)
    jmesh, mesh = jpm.make_mesh(tp, dp=1), pm.Mesh(dp=1, tp=tp)
    G, _ = group_dims(cfg_t.num_kv_heads, cfg_t.head_dim)
    for quantized in (False, True):
        j = jpm.kv_specs(cfg_j, jmesh, quantized)
        t = pm.kv_specs(cfg_t, mesh, quantized)
        for f in ("k", "v", "k_scale", "v_scale"):
            jv = getattr(j, f)
            want = None if jv is None else tuple(jv)
            if want is not None and G % tp == 0 and cfg_t.num_heads % tp:
                # JAX splits the groups even where the heads do not divide;
                # the port's attention is replicated there
                want = tuple(None for _ in want)
            assert getattr(t, f) == want, (f, quantized)
    dcfg = jc.drafter_config(cfg_j)
    dshapes = jax.eval_shape(lambda k: jtfm.fuse_params(
        jdrf.init_drafter_params(k, dcfg, jnp.zeros(
            (cfg_j.vocab_size, cfg_j.hidden_size), cfg_j.jnp_dtype))),
        jax.random.key(0))
    want = flat(jax.tree.map(tuple, jpm.drafter_param_specs(dshapes),
                             is_leaf=lambda x: isinstance(
                                 x, jax.sharding.PartitionSpec)))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                        dshapes)
    assert flat(pm.drafter_param_specs(meta)) == want


def tiny_port(layout, kw=ranks.CHAM_KW, seed=0):
    cfg = tc.tiny_config(**kw)
    p = ttfm.init_params(torch.Generator().manual_seed(seed), cfg,
                         device="cpu")
    if layout != "split":
        p = ttfm.fuse_params(p)
    if layout == "int8":
        p = quantize_params(p)
    return cfg, p


def tree_equal(a, b):
    fa, fb = flat(a), flat(b)
    return set(fa) == set(fb) and all(torch.equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("layout", ["split", "fused", "int8"])
@pytest.mark.parametrize("kw", [ranks.CHAM_KW, ranks.LG_KW],
                         ids=["chameleon", "llamagen"])
def test_shard_gather_round_trip(kw, layout, tp):
    cfg, p = tiny_port(layout, kw)
    mesh = pm.Mesh(dp=1, tp=tp)
    specs = pm.base_param_specs(cfg, mesh, p)
    shards = [pm.shard_pytree(p, specs, mesh, r) for r in range(tp)]
    assert tree_equal(pm.gather_pytree(shards, specs), p)
    nh = ttfm.local_heads(cfg, shards[0]["layers"])
    assert nh == (cfg.num_heads // tp if pm.heads_split(cfg, mesh)
                  else cfg.num_heads)
    # a KV cache shards by its groups and gathers back
    kv = KVCache.create(cfg, 2, device="cpu")
    kv.k.normal_(generator=torch.Generator().manual_seed(1))
    ks = pm.kv_specs(cfg, mesh)
    kshards = [pm.shard_pytree(kv, ks, mesh, r) for r in range(tp)]
    # as many groups as the rank's weights serve
    assert kshards[0].k.shape[2] == ttfm.cache_groups(cfg, shards[0])
    assert torch.equal(pm.gather_pytree(kshards, ks).k, kv.k)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_split_then_fuse(tp):
    """A fused kernel is sharded part by part: each rank's fused shard is
    the fusion of its split shards, never a contiguous cut of the fused
    columns."""
    cfg, p = tiny_port("split")
    mesh = pm.Mesh(dp=1, tp=tp)
    fused = ttfm.fuse_params(p)
    for r in range(tp):
        a = pm.shard_pytree(fused, pm.base_param_specs(cfg, mesh, fused),
                            mesh, r)
        b = ttfm.fuse_params(pm.shard_pytree(
            p, pm.base_param_specs(cfg, mesh, p), mesh, r))
        assert tree_equal(a, b)
        cut = fused["layers"]["wqkv"].chunk(tp, dim=-1)[r]
        assert not torch.equal(a["layers"]["wqkv"], cut)


def test_quantize_then_shard():
    """A row-split kernel keeps the full-K column scale, replicated; each
    shard quantized alone gets other scales."""
    cfg, dense = tiny_port("fused")
    mesh = pm.Mesh(dp=1, tp=2)
    full = quantize_params(dense)
    right = pm.shard_pytree(full, pm.base_param_specs(cfg, mesh, full), mesh)
    alone = quantize_params(pm.shard_pytree(
        dense, pm.base_param_specs(cfg, mesh, dense), mesh))
    for name in ("wo", "w_down"):
        assert torch.equal(right["layers"][name + "_s"],
                           full["layers"][name + "_s"])
        assert not torch.equal(alone["layers"][name + "_s"],
                               full["layers"][name + "_s"])
    # a column split's scales are per column: the same either way
    assert torch.equal(right["layers"]["wqkv_s"], alone["layers"]["wqkv_s"])


def test_mesh_checks():
    with pytest.raises(ValueError, match="not divisible by dp"):
        pm.make_mesh(3, dp=2)
    m = pm.make_mesh()
    assert (m.dp, m.tp, m.tp_group) == (1, 1, None)
    with pm.set_mesh(pm.Mesh(dp=1, tp=2)):
        with pytest.raises(ValueError, match="no process group"):
            pm.tp_group()
    assert pm.current_mesh() is None


def test_forward_refuses_a_shard_without_mesh():
    cfg, p = tiny_port("fused")
    mesh = pm.Mesh(dp=1, tp=2)
    shard = pm.shard_pytree(p, pm.base_param_specs(cfg, mesh, p), mesh)
    kv = KVCache.create(cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="set_mesh"):
        ttfm.forward(shard, cfg, torch.zeros((2, 3, cfg.hidden_size)), kv,
                     torch.arange(3), ttfm.make_rope_tables(cfg, "cpu"))


def test_kv_cache_takes_the_rank_groups():
    """A cache sized by the weights it serves holds the rank's groups (all
    of them where attention is replicated); one sized otherwise is refused
    by the forward."""
    for kw, tp, want in ((ranks.CHAM_KW, 2, 2), (ranks.CHAM_KW, 4, 1),
                         (ranks.LG_KW, 2, 1), (ranks.LG_KW, 4, 2)):
        cfg, p = tiny_port("fused", kw)
        mesh = pm.Mesh(dp=1, tp=tp)
        shard = pm.shard_pytree(p, pm.base_param_specs(cfg, mesh, p), mesh)
        groups = ttfm.cache_groups(cfg, shard)
        assert groups == want
        assert KVCache.create(cfg, 2, device="cpu",
                              groups=groups).k.shape[2] == want
        G = group_dims(cfg.num_kv_heads, cfg.head_dim)[0]
        assert ttfm.cache_groups(cfg, p) == G
        assert KVCache.create(cfg, 2, device="cpu").k.shape[2] == G
    kv = KVCache.create(cfg, 2, device="cpu", groups=1)
    with pytest.raises(ValueError, match="head groups"):
        ttfm.forward(p, cfg, torch.zeros((2, 3, cfg.hidden_size)), kv,
                     torch.arange(3), ttfm.make_rope_tables(cfg, "cpu"))


# ---------------------------------------------------------------------------
# the rank processes' forwards and decoding
# ---------------------------------------------------------------------------

def test_mesh_coordinates(world):
    outs = results(world, "mesh")
    for r, o in enumerate(outs):
        assert o["coords"] == [(0, r), (r // 2, r % 2)]


@pytest.mark.parametrize("tp", ["tp2", "tp4"])
def test_head_gather(world, tp):
    """The vocab-split head's gather puts every tp rank's columns side by
    side in rank order, and the zero-filled all-reduce that stands in for
    it (gloo on CUDA tensors) gives the same values."""
    outs = [o[f"gather/{tp}"] for o in results(world, "mesh")]
    n = int(tp[2:])
    for r, (got, by_reduce, _) in enumerate(outs):
        group = r // n * n
        want = torch.cat([outs[group + i][2] for i in range(n)], dim=-1)
        assert torch.equal(got, want) and torch.equal(by_reduce, want)


@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("tp", ["tp2", "tp4"])
@pytest.mark.parametrize("name", ["cham", "lg"])
def test_tp_forward_matches_jax(world, name, tp, layout):
    """Every rank's final hidden and gathered logits within f32 tolerance
    of the JAX one-device forward, and equal across ranks byte for byte;
    the cache holds the rank's groups (LlamaGen at tp 4: all of them)."""
    outs = [o[f"fwd/{name}/{tp}/{layout}"] for o in results(world, "mesh")]
    hid, logits = world["refs"][f"fwd/{name}"]
    n = int(tp[2:])
    cfg = tc.tiny_config(**(ranks.CHAM_KW if name == "cham" else ranks.LG_KW))
    G = group_dims(cfg.num_kv_heads, cfg.head_dim)[0]
    for h, lg, groups in outs:
        np.testing.assert_allclose(h.numpy(), hid, **HIDDEN_TOL)
        np.testing.assert_allclose(lg.numpy(), logits, **LOGITS_TOL)
        assert groups == (G if G % n else G // n)
        assert torch.equal(lg, outs[0][1]) and torch.equal(h, outs[0][0])


def rel_err(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def test_tp_int8_forward_within_tolerance(world):
    for o in results(world, "mesh"):
        assert rel_err(o["int8"]["got"], o["int8"]["ref"]) < REL_TOL
        right, alone, full = o["int8"]["wo_s"]
        assert torch.equal(right, full) and not torch.equal(alone, full)


@pytest.mark.parametrize("variant", ["skip_wo_reduce", "reduce_after_norm",
                                     "quantize_per_shard"])
def test_known_wrong_variant_misses(world, variant):
    for o in results(world, "mesh"):
        assert rel_err(o["int8"]["wrong"][variant], o["int8"]["ref"]) \
            > 100 * REL_TOL, variant


@pytest.mark.parametrize("mode", list(ranks.MODES))
def test_tp_generate_token_exact(world, mode):
    """Greedy decoding over (dp=2, tp=2) on every rank equals JAX's
    single-device run and its sharded run at (dp=2, tp=2)."""
    one, shd = world["refs"][f"gen/{mode}"]
    assert one == shd
    for o in results(world, "mesh"):
        assert o[f"gen/{mode}"] == one
    assert one[3] == ranks.MAX_NEW


@pytest.mark.parametrize("loop", ["python", "native"])
def test_mesh_scheduler_matches_jax(world, loop):
    """``BatchedEngine`` + ``Scheduler`` (either run loop) over (dp=2,
    tp=2), 6 requests on 4 slots (2 a dp row): every rank returns every
    request in input order, equal to the JAX single-device scheduler
    run."""
    ref = world["refs"]["serve"]
    assert [r[0] for r in ref] == list(range(len(ranks.LABELS)))
    assert all(r[1] is None and len(r[2]) == ranks.SERVE_NEW for r in ref)
    for o in results(world, "mesh"):
        assert o[f"serve/{loop}"] == ref


@pytest.mark.parametrize("loop", ["python", "native"])
def test_tp_row_admits_together(world, loop):
    """One (dp=1, tp=2) row serving requests with staggered arrival times,
    while its ranks' clocks disagree and one rank alone fails a prefill:
    the ranks admit together (tp rank 0's clock) and fail that request
    together, so both return the same list, and every other request's
    tokens are the JAX single-device scheduler's."""
    ref = {r[0]: r for r in world["refs"]["serve"]}
    outs = [o[f"serve_row/{loop}"] for o in results(world, "dist")]
    assert outs[0] == outs[1]
    assert [r[0] for r in outs[0]] == list(range(len(ranks.LABELS)))
    for uid, err, toks, steps in outs[0]:
        if uid == ranks.FAIL_UID:
            assert err == "RuntimeError: prefill failed on tp rank 1 alone"
            assert toks is None
        else:
            assert (uid, err, toks, steps) == ref[uid]


def test_mesh_slots_must_divide_over_dp(world):
    for o in results(world, "mesh"):
        assert o["odd_slots"] == ("num_slots 3 must be a multiple of the "
                                  "mesh dp size 2")


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tp2_on_the_card(cuda, tmp_path):
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    device): the int8 bf16 LlamaGen lane at tp 2 through the kernels,
    logits within bf16 tolerance of one process on the card and equal
    across the ranks, and the ranks' greedy tokens equal (the tp sums run
    in another order than one process's, so its tokens may differ where
    two logits nearly tie)."""
    procs = launch("card", 2, tmp_path)
    outs = collect("card", procs, tmp_path)
    if isinstance(outs, str):
        pytest.fail(outs)
    for o in outs:
        assert rel_err(o["got"], o["ref"]) < 2e-2
        assert len(o["tokens"]) == len(o["ref_tokens"])
        assert o["launches"]["int8_matmul"] > 0
        assert o["launches"]["tree_attention"] > 0
    assert torch.equal(outs[0]["got"], outs[1]["got"])
    assert outs[0]["tokens"] == outs[1]["tokens"]
