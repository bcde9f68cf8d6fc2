"""Emu3-Gen on the port, on the CPU, against the benchmark's plain reference
(``h100_bench/reference``: float32, a layer at a time, no cache, no port
import).

A tiny Emu3 (``h100_bench/tests/tiny_emu3.EMU3``): 4 query heads of 128 over
1 KV head (4:1), pre-norm, rope at theta 1e6, a vocabulary of 1,054 (14
modulo 16, so the head is stored padded) with its 256 visual ids at the
top, a 4 x 4 grid with row ends (21 tokens an image).  Weights come from
``h100_bench.weights`` (bfloat16, N(0, 0.02)); the port takes them through
``fuse_params`` / ``quantize_params`` as the benchmark does.

- prefill, then decoding through the int8 cache and the bf16 cache, against
  the reference's full forward: CFG-combined logits over the image columns,
  for a caption shorter and longer than the negative prompt, with and
  without a prefix of whole rows;
- the prompt's layout: pads, positions, ``pos_diff``, ``image_start``, and
  the prefix's check;
- the grammar (a row end every 5th token, the end of frame after the last
  row) through ``spec.generate``, ``BatchedEngine`` and ``Scheduler``, each
  batched request equal to its lone run;
- the ``grid_fsm`` span in ``step.accept`` and ``step.draft``, and the
  syncs counted under it;
- the head padded once at load and K5's ragged rows, in their Python parts.

Tests marked ``cuda`` (K1 at Emu3's head, K5 at its vocabulary, the pad
columns, the FSM's real syncs) skip here.
"""

import numpy as np
import pytest
import torch

from h100_bench import weights as bw
from h100_bench.drivers.engine_window_deep import image_rows
from h100_bench.families import emu3 as fam
from h100_bench.reference import model as ref_model
from h100_bench.reference.families import emu3 as ref_emu3
from h100_bench.reference.families import grammar_violations, vocab_cols
from h100_bench.tests.tiny_emu3 import EMU3, TRAFFIC
from lantern_tpu_torch import configs, trees
from lantern_tpu_torch.engine import spec
from lantern_tpu_torch.engine.batch import BatchedEngine
from lantern_tpu_torch.engine.scheduler import Request, Scheduler
from lantern_tpu_torch.kv import KVCache
from lantern_tpu_torch.models import chameleon as cham
from lantern_tpu_torch.models import emu3
from lantern_tpu_torch.models import transformer as tfm
from lantern_tpu_torch.ops import _cuda
from lantern_tpu_torch.ops import acceptance as acc
from lantern_tpu_torch.ops import quant
from lantern_tpu_torch.ops.acceptance import LanternSpec
from lantern_tpu_torch.ops.sampling import LogitsWarp, cfg_combine
from lantern_tpu_torch.utils import profiling as prof

SCALE = 3.0
IDS = fam.ids(EMU3)
GRID = tuple(EMU3["image"]["grid"])
N_IMG = EMU3["image"]["tokens"]
NEG = [11, 12, 13, 14, 15, 16]                 # the negative prompt: 6 ids
TREE = "chain_bush_8"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The shapes are tiny and the test workers share the cores: intra-op
    threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    raw = bw.base_weights(EMU3, 5, "cpu")
    params = quant.quantize_params(tfm.fuse_params(raw))
    params["nearest_latents"] = torch.as_tensor(emu3.nearest_table(
        np.random.default_rng(1).integers(0, IDS.codes, (IDS.codes, 5)),
        IDS))
    return raw, params, fam.model_config(EMU3, TRAFFIC)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def prompt(text, prefix_rows=0, seed=0):
    rng = np.random.default_rng(seed)
    prefix = image_rows(EMU3, rng, prefix_rows)
    return prefix, fam.token_prompt(EMU3, text, "cpu", negative_ids=NEG,
                                    prefix_ids=prefix)


def program_logits(params, mcfg, tp, fed, kv_quant):
    """Prefill the prompt pair, then feed ``fed`` one token at a time
    through the cache: the CFG-combined logits of the prefill's last row
    and of each fed token but the last, [len(fed), V]."""
    kv = KVCache.create(mcfg, 2, quantized=kv_quant, device="cpu",
                        groups=tfm.cache_groups(mcfg, params))
    rope = tfm.make_rope_tables(mcfg, "cpu")
    L = tp.tokens.shape[1]
    block = (torch.tril(torch.ones((L, L), dtype=torch.bool))[None]
             & tp.valid[:, None, :])
    res = tfm.forward(params, mcfg, tfm.token_embed(params, tp.tokens), kv,
                      tp.positions, rope, block_mask=block)
    pv = torch.ones((2, kv.max_len), dtype=torch.bool)
    pv[:, :L] = tp.valid
    offs = torch.stack([torch.zeros((), dtype=torch.int32), tp.pos_diff])
    out = [tfm.logits_head(params, res.hidden[:, -1:])]
    kv = res.kv
    for t in fed[:-1]:
        res = tfm.forward(params, mcfg, tfm.token_embed(
            params, torch.full((2, 1), int(t))), kv,
            (kv.length - offs).reshape(2, 1), rope, prefix_valid=pv)
        kv = res.kv
        out.append(tfm.logits_head(params, res.hidden))
    return cfg_combine(torch.cat(out, dim=1), SCALE)[0]


def reference_logits(raw, text, prefix, fed, kvbits):
    rows, idx = ref_emu3.rows(EMU3, raw, {"text_ids": text,
                                          "negative_ids": NEG,
                                          "prefix_ids": prefix}, fed, "cpu")
    out = ref_model.logits(EMU3, raw, rows, idx, vocab_cols(EMU3),
                           kvbits=kvbits)
    return out[1] + SCALE * (out[0] - out[1])


# the widest distance over the image columns, over the reference row's
# standard deviation.  Readings 0.043-0.049 (int8 cache) and 0.024-0.028
# (bf16 cache): bf16 activations and the int8 cache's per-token scales of
# bf16-rounded keys against the reference's f32; the int4 control reads
# 1.4-1.8.  The bf16 cache is held to the reference at 16 bits (finer than
# bf16: effectively unquantized).
TOL = {True: 0.10, False: 0.06}


@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8kv", "bf16kv"])
@pytest.mark.parametrize("caption", [3, 9], ids=["shorter", "longer"])
@pytest.mark.parametrize("rows", [0, 2], ids=["fresh", "continued"])
def test_prefill_and_decode_match_reference(model, kv_quant, caption, rows):
    raw, params, mcfg = model
    text = list(range(100, 100 + caption))
    prefix, tp = prompt(text, rows, seed=caption + rows)
    fed = np.array(image_rows(EMU3, np.random.default_rng(7), 2))[:8]
    got = program_logits(params, mcfg, tp, fed, kv_quant)[
        :, vocab_cols(EMU3)].float()
    ref = reference_logits(raw, text, prefix, fed, 8 if kv_quant else 16)
    err = ((got - ref).abs().max(-1).values / ref.std(-1)).max()
    assert float(err) <= TOL[kv_quant], float(err)
    # the control one precision step below fails the same tolerance
    ctrl = ref_model.logits(EMU3, raw, *ref_emu3.rows(
        EMU3, raw, {"text_ids": text, "negative_ids": NEG,
                    "prefix_ids": prefix}, fed, "cpu"), vocab_cols(EMU3),
        wbits=4, kvbits=4)
    ctrl = ctrl[1] + SCALE * (ctrl[0] - ctrl[1])
    assert float(((ctrl - ref).abs().max(-1).values
                  / ref.std(-1)).max()) > 5 * TOL[kv_quant]


@pytest.mark.parametrize("caption", [2, 10])
def test_prompt_layout(caption):
    text = list(range(200, 200 + caption))
    prefix, tp = prompt(text, 1)
    cond = [IDS.bos] + text + [IDS.boi, 40, 9, 40, IDS.img] + prefix
    uncond = [IDS.bos] + NEG + [IDS.boi, 40, 9, 40, IDS.img] + prefix
    L = max(len(cond), len(uncond))
    pc, pu = L - len(cond), L - len(uncond)
    assert tp.tokens.tolist() == [[IDS.pad] * pc + cond,
                                  [IDS.pad] * pu + uncond]
    assert tp.valid.tolist() == [[False] * pc + [True] * len(cond),
                                 [False] * pu + [True] * len(uncond)]
    assert tp.positions[0].tolist() == list(range(L))
    assert tp.positions[1].tolist() == [0] * pu + list(range(len(uncond)))
    assert int(tp.pos_diff) == pu
    # the FSM's start: the image's first token (the prefix's) less 3
    assert int(tp.image_start) + 3 == L - len(prefix)
    assert tp.to("cpu").image_start is not None
    for bad in ([IDS.visual_start] * 5, [IDS.visual_start] * 4 + [7],
                image_rows(EMU3, np.random.default_rng(0), GRID[0])):
        with pytest.raises(ValueError):
            emu3.token_prompt(text, NEG, [40, 9, 40], bad, grid=GRID,
                              ids=IDS)


def ecfg(max_new):
    return spec.SpecDecodeConfig(
        warp=LogitsWarp(temperature=1.0, top_k=64), cfg_scale=SCALE,
        lantern=LanternSpec(k=4, delta=5.0), max_new=max_new,
        mode="static", kv_quant=True, stale_draft=True)


def clean(prefix, served):
    """Grammar violations of the whole image so far: the prefix's rows,
    then the served tokens."""
    return grammar_violations(EMU3, np.concatenate(
        [np.asarray(prefix, np.int64), np.asarray(served, np.int64)]))


def lone(params, mcfg, text, rows, seed):
    prefix, tp = prompt(text, rows)
    n = N_IMG - len(prefix)
    res = spec.generate(params, ecfg(n), mcfg, trees.get_tree(TREE), tp,
                        spec.request_generator(seed, "cpu"),
                        logits_fn=fam.grid_fsm(EMU3), device="cpu")
    return prefix, res.tokens[:n].numpy()


@pytest.mark.parametrize("rows", [0, 1, 3])
def test_grammar_spec_generate(model, rows):
    _, params, mcfg = model
    prefix, toks = lone(params, mcfg, [300, 301, 302], rows, 11)
    assert len(toks) == N_IMG - len(prefix)
    assert clean(prefix, toks) == 0
    assert toks[-1] == IDS.eof and toks[-2] == IDS.eol


def test_grammar_batched_engine_and_continuation(model):
    """Two slots, one holding an image in flight (two rows): each slot
    retired at its image's end equals its lone run, grammar-clean."""
    _, params, mcfg = model
    reqs = [([400, 401], 2, 21), ([402, 403, 404, 405, 406, 407, 408], 0,
                                  22)]
    eng = BatchedEngine(ecfg=ecfg(N_IMG), cfg=mcfg,
                        tree=trees.get_tree(TREE), params=params,
                        num_slots=2, logits_fn=fam.grid_fsm(EMU3),
                        device="cpu")
    batch, need = None, []
    for s, (text, rows, seed) in enumerate(reqs):
        prefix, tp = prompt(text, rows)
        pre = eng.prefill(generator=spec.request_generator(seed, "cpu"),
                          token_prompt=tp)
        batch = batch or eng.empty_batch(pre)
        batch = eng.insert(batch, s, pre)
        need.append(N_IMG - len(prefix))
    done = {}
    for _ in range(40):
        batch = eng.step(batch)
        n_new, _, _ = eng.slot_status(batch)
        for s in range(2):
            if s not in done and n_new[s] >= need[s]:
                done[s] = eng.slot_tokens(batch, s)[:need[s]]
        if len(done) == 2:
            break
    assert len(done) == 2
    for s, (text, rows, seed) in enumerate(reqs):
        prefix, alone = lone(params, mcfg, text, rows, seed)
        np.testing.assert_array_equal(done[s], alone)
        assert clean(prefix, done[s]) == 0 and done[s][-1] == IDS.eof


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_grammar_scheduler(model, native):
    """Three requests on two slots through ``Scheduler``: each equals its
    lone ``spec.generate`` and ends its last row, then the end of frame."""
    _, params, mcfg = model
    texts = [[500, 501], list(range(510, 520)), [530, 531, 532, 533]]
    eng = BatchedEngine(ecfg=ecfg(N_IMG), cfg=mcfg,
                        tree=trees.get_tree(TREE), params=params,
                        num_slots=2, logits_fn=fam.grid_fsm(EMU3),
                        device="cpu")
    out = Scheduler(eng, use_native=native).run(
        [Request(uid=i, token_prompt=prompt(t)[1], seed=40 + i)
         for i, t in enumerate(texts)])
    for r, t in zip(out, texts):
        assert r.error is None
        toks = np.asarray(r.tokens)[:N_IMG]
        np.testing.assert_array_equal(toks, lone(params, mcfg, t, 0,
                                                 40 + r.uid)[1])
        assert clean([], toks) == 0 and toks[-1] == IDS.eof


def test_grid_fsm_span_and_syncs(model, monkeypatch):
    """``grid_fsm`` opens once a slot a step in ``step.accept`` and in
    ``step.draft``; a sync the FSM makes counts under it (two synthetic
    sync warnings a call: the CPU makes none, the card two)."""
    import warnings

    _, params, mcfg = model
    constrain = cham.LuminaGridFSM._constrain

    def syncing(self, *a):
        for _ in range(2):
            warnings.warn(prof.SYNC_WARNING + " (synthetic)")
        return constrain(self, *a)

    monkeypatch.setattr(cham.LuminaGridFSM, "_constrain", syncing)
    eng = BatchedEngine(ecfg=ecfg(N_IMG), cfg=mcfg,
                        tree=trees.get_tree(TREE), params=params,
                        num_slots=2, logits_fn=fam.grid_fsm(EMU3),
                        device="cpu")
    batch = None
    for s in range(2):
        pre = eng.prefill(generator=spec.request_generator(s, "cpu"),
                          token_prompt=prompt([600 + s])[1])
        batch = batch or eng.empty_batch(pre)
        batch = eng.insert(batch, s, pre)
    prof.clear()
    with prof.recording():
        for _ in range(2):
            batch = eng.step(batch)
    sp = prof.spans()
    parents = [sp[s.parent].name for s in sp if s.name == "grid_fsm"]
    assert parents.count("step.accept") == 4
    assert parents.count("step.draft") == 4 and len(parents) == 8
    c = prof.counters()
    assert c[("syncs", "step>step.accept>grid_fsm")] == 8
    assert c[("syncs", "step>step.draft>grid_fsm")] == 8
    assert c[("steps", "step")] == 2
    prof.clear()


def test_config_nearest_table_and_ids():
    cfg = configs.emu3_gen_config()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.rope_base, cfg.qk_norm, cfg.swin_norm) == (
        184622, 4096, 14336, 32, 32, 8, 128, 1e6, False, False)
    assert cfg.vocab_size % 16 == 14
    assert emu3.EMU3.visual_end == 184621 and emu3.EMU3.codes == 32768
    table = np.random.default_rng(2).integers(0, 32768, (32768, 3))
    near = emu3.nearest_table(table)
    assert near.shape == (184622, 3)
    assert (near[:151854] == 0).all()
    np.testing.assert_array_equal(near[151854:], table + 151854)


def test_head_padded_once_at_load():
    """A head of 1,054 columns is stored as 1,056 (int8 zeros, unit
    scales) behind a [K, 1054] view: the CPU matmul is unchanged, and K1's
    storage view is found without a copy; a head moved since is padded
    again by a copy."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((512, 1054), generator=g) * 0.02
    p = quant.quantize_params({"layers": {}, "lm_head": w})
    q, s = p["lm_head_q"], p["lm_head_s"]
    assert q.shape == (512, 1054) and q.stride() == (1056, 1)
    assert s.shape == (1, 1054) and s.stride() == (1056, 1)
    q0, s0 = quant.quantize_weight(w)
    assert torch.equal(q, q0) and torch.equal(s, s0)
    x = torch.randn((3, 512), generator=g).bfloat16()
    assert torch.equal(quant.int8_matmul(x, q, s, torch.float32),
                       quant.int8_matmul(x, q0, s0, torch.float32))
    qf, sf = quant._padded_storage(q, s)
    assert qf.shape == (512, 1056) and qf.data_ptr() == q.data_ptr()
    assert sf.shape == (1056,) and sf.data_ptr() == s.data_ptr()
    assert (qf[:, 1054:] == 0).all() and (sf[1054:] == 1).all()
    qc, sc = quant._padded_storage(q.contiguous(), s.contiguous())
    assert qc.shape == (512, 1056) and torch.equal(qc[:, :1054], q0)
    # a multiple of 16 is left as it is
    q16, s16 = q0[:, :1040].contiguous(), s0[:, :1040].contiguous()
    assert quant.pad_columns(q16, s16) == (q16, s16)


def test_k5_ragged_rows_layout():
    """K5's rows for a vocabulary that is no multiple of 4: the values in
    rows 4-aligned apart; a broadcast row copied once and broadcast."""
    V, ld = 1054, 1056
    t = torch.randn((3, V))
    r = acc._ragged_rows(t, ld)
    assert r.shape == (3, V) and r.stride() == (ld, 1) and torch.equal(r, t)
    assert acc._ragged_rows(r, ld) is r
    b = torch.randn((1, V)).expand(5, V)
    rb = acc._ragged_rows(b, ld)
    assert rb.shape == (5, V) and rb.stride() == (0, 1)
    assert torch.equal(rb, b) and _cuda.aligned(rb)


# ----------------------------------------------------- the card (cuda)

def _emu3_walk(seed, multidraft, device):
    """A walk at Emu3's vocabulary on the bench tree: logits that favour
    the drafts, a grammar-masked tail, ties at the top-k threshold, a
    nearest table with high tokens among the drafts' neighbours, and
    (multi-draft) q with zeros and broadcast drafter rows as stale drafting
    makes them."""
    from pathlib import Path

    V, k_top = 184622, 2048
    rng = np.random.default_rng(seed)
    ts = trees.get_tree(str(Path(__file__).resolve().parents[1] / "ckpts"
                            / "bench_tree_lumina.json"))
    children = ts.children.astype(np.int64)
    N1 = children.shape[0]
    toks = rng.integers(151854, V, size=N1).astype(np.int32)
    logits = (rng.normal(size=(N1, V)) * 2).astype(np.float32)
    logits[:, :151854] = torch.finfo(torch.float32).min
    for p in range(N1):
        for s in children[p][children[p] >= 0]:
            logits[p, toks[s]] += rng.choice([0.0, 6.0, 9.0])
        order = np.argsort(-logits[p], kind="stable")
        logits[p, order[k_top - 3:k_top + 3]] = logits[p, order[k_top - 1]]
    nearest = rng.integers(151854, V, size=(V, 11)).astype(np.int32)
    for p in range(N1):
        top = np.argsort(-logits[p])[:12]
        for s in children[p][children[p] >= 0]:
            nearest[toks[s], :6] = rng.permutation(top)[:6]

    def t(a):
        return torch.as_tensor(a, device=device)

    kw = dict(nearest=t(nearest), lantern=LanternSpec(10, 5.0))
    if multidraft:
        q = rng.uniform(0.02, 0.9, size=N1).astype(np.float32)
        q[rng.random(N1) < 0.1] = 0.0
        rows = [1] + [len(lv.child_flat_idx) for lv in ts.levels]
        dists = torch.softmax(t(rng.normal(size=(len(rows), V)) * 3).float(),
                              -1)
        kw.update(node_q=t(q), node_level_row=t(ts.inlevel_rank.astype(
            np.int64)), level_probs=[dists[i: i + 1].expand(r, V)
                                     for i, r in enumerate(rows)])
    return (t(logits), t(toks), t(children), ts.max_depth,
            LogitsWarp(temperature=1.0, top_k=k_top)), kw


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 64])
def test_k1_emu3_head_cuda(cuda, M):
    """K1 at Emu3's head (K 4,096, N 184,622, stored padded) against its
    plain version; a row's result independent of the rows beside it."""
    g = torch.Generator(device=cuda).manual_seed(M)
    w = torch.randn((4096, 184622), generator=g, device=cuda) * 0.02
    q, s = quant.pad_columns(*quant.quantize_weight(w))
    del w
    x = torch.randn((M, 4096), generator=g, device=cuda).bfloat16()
    n0 = _cuda.LAUNCHES["int8_matmul"]
    got = quant.int8_matmul_cuda(x, q, s, torch.float32)
    assert _cuda.LAUNCHES["int8_matmul"] == n0 + 1
    ref = quant.int8_matmul(x, q, s, torch.float32)
    assert got.shape == (M, 184622)
    torch.testing.assert_close(got, ref, rtol=2e-2,
                               atol=2e-2 * ref.abs().max().item())
    one = quant.int8_matmul_cuda(x[:1], q, s, torch.float32)
    assert torch.equal(one, got[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("multidraft", [True, False], ids=["md", "eagle2"])
@pytest.mark.parametrize("coins", ["random", 0.0, 1.0])
def test_k5_emu3_vocab_cuda(cuda, multidraft, coins):
    """K5 at V = 184,622 (ragged rows) against the plain walk under the same
    coins, over three seeds: slots and count equal, the bonus row within
    1e-5 and 0 nowhere but the V columns."""
    for seed in range(3):
        args, kw = _emu3_walk(seed, multidraft, cuda)
        rng = np.random.default_rng(seed + 1000)
        u = torch.as_tensor((rng.random((args[3], args[2].shape[1]))
                             if coins == "random" else
                             np.full((args[3], args[2].shape[1]), coins))
                            .astype(np.float32), device=cuda)
        n0 = _cuda.LAUNCHES["tree_walk"]
        path, alen, dist = acc.stochastic_verify_tree(None, *args,
                                                      uniforms=u, **kw)
        assert _cuda.LAUNCHES["tree_walk"] == n0 + 1
        rp, ra, rd = acc.stochastic_verify_tree_plain(*args, u, **kw)
        a = int(alen)
        assert a == int(ra), (seed, a, int(ra))
        assert torch.equal(path[: a + 1].cpu(), rp[: a + 1].cpu()), seed
        assert dist.shape == (184622,)
        assert float((dist - rd).abs().max()) <= 1e-5, seed


@pytest.mark.cuda
def test_pad_columns_carry_nothing_cuda(cuda, monkeypatch):
    """Large weights and scales in the head's pad columns, and large or NaN
    values in the pads of K5's rows, change no logit, no sample and no
    walk."""
    g = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn((4096, 184622), generator=g, device=cuda) * 0.02
    q, s = quant.pad_columns(*quant.quantize_weight(w))
    del w
    x = torch.randn((33, 4096), generator=g, device=cuda).bfloat16()
    clean_logits = quant.int8_matmul_cuda(x, q, s, torch.float32)
    qf, sf = quant._padded_storage(q, s)
    qf[:, 184622:] = 127
    sf[184622:] = 1e30
    dirty = quant.int8_matmul_cuda(x, q, s, torch.float32)
    assert torch.equal(dirty, clean_logits)
    gen = [torch.Generator(device=cuda).manual_seed(9) for _ in range(2)]
    from lantern_tpu_torch.ops.sampling import sample_token

    warp = LogitsWarp(temperature=1.0, top_k=2048)
    assert int(sample_token(gen[0], clean_logits[0], warp)) == int(
        sample_token(gen[1], dirty[0], warp))
    # K5 with the pads of its ragged rows (logits and drafter rows) filled
    args, kw = _emu3_walk(4, True, cuda)
    u = torch.rand((args[3], args[2].shape[1]), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(5))
    a = acc.stochastic_verify_tree_cuda(*args, u, **kw)
    ragged = acc._ragged_rows
    for fill in (1e30, float("nan")):
        def filled(t, ld, fill=fill):
            r = ragged(t, ld)
            n = 1 if r.stride(0) == 0 else r.shape[0]
            r.as_strided((n, ld), (ld, 1))[:, t.shape[1]:] = fill
            return r

        monkeypatch.setattr(acc, "_ragged_rows", filled)
        b = acc.stochastic_verify_tree_cuda(*args, u, **kw)
        assert torch.equal(a[0], b[0]) and int(a[1]) == int(b[1])
        assert torch.equal(a[2], b[2])
    assert a[2].shape == (184622,) and float(a[2].sum()) == pytest.approx(
        1.0, abs=1e-4)


@pytest.mark.cuda
def test_grid_fsm_syncs_on_card(cuda):
    """The FSM's two blocking writes a call, counted under ``grid_fsm`` on
    the card: four a slot a step (its acceptance and its re-draft), on the
    tiny Emu3 whose head K1 runs padded."""
    raw = bw.base_weights(EMU3, 5, cuda)
    params = quant.quantize_params(tfm.fuse_params(raw))
    params["nearest_latents"] = torch.as_tensor(emu3.nearest_table(
        np.random.default_rng(1).integers(0, IDS.codes, (IDS.codes, 5)),
        IDS), device=cuda)
    eng = BatchedEngine(ecfg=ecfg(N_IMG), cfg=fam.model_config(EMU3,
                                                               TRAFFIC),
                        tree=trees.get_tree(TREE), params=params,
                        num_slots=2, logits_fn=fam.grid_fsm(EMU3),
                        device=cuda)
    batch = None
    for s in range(2):
        pre = eng.prefill(generator=spec.request_generator(s, cuda),
                          token_prompt=prompt([600 + s])[1].to(cuda))
        batch = batch or eng.empty_batch(pre)
        batch = eng.insert(batch, s, pre)
    prof.clear()
    with prof.recording():
        for _ in range(2):
            batch = eng.step(batch)
    c = prof.counters()
    under = sum(v for (k, chain), v in c.items() if k == "syncs" and chain
                and "grid_fsm" in chain.split(">"))
    assert under == 4 * 2 * 2, c
    prof.clear()
