#!/usr/bin/env python3
"""Chip smoke test of the H100 port (``lantern_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # 16x16 image grid (273 tokens)
    python3 chip_smoke.py --grid 48  # the bench lane's 48x48 grid (2353 tokens)
    python3 chip_smoke.py --kernels-only   # phases 1-4: a changed kernel's
                                           # short first run, no result line
    python3 chip_smoke.py --sweep-splits   # K1 and K2 timed over split
                                           # counts, no result line
    python3 chip_smoke.py --tools-only     # the build and the tools phase
                                           # (10 below), no result line
    python3 chip_smoke.py --train-only     # the build and the train phase
                                           # (11 below), no result line
    python3 chip_smoke.py --evals-only     # the build and the evals phase
                                           # (12 below), no result line
    python3 chip_smoke.py --gqa-only       # the build, the self-test and
                                           # the gqa phase (5b below), no
                                           # result line
    python3 chip_smoke.py --parallel-only  # the build and the parallel
                                           # phase (13 below), no result line
    python3 chip_smoke.py --parallel-train-only  # the build, the self-test
                                           # and the parallel phase's
                                           # training parts ((a), (d),
                                           # (e) of 13), no result line

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: compiles the CUDA kernels of ``lantern_tpu_torch/csrc`` through
   ``torch.utils.cpp_extension.load``; then the kernel self-test
   (``ops/selftest.run_kernel_selftest`` on the card: K1-K4 through the
   dispatching ops against dense forms at the JAX module's shapes, and 48
   sampled tokens with deferred commit equal to rollback commit through
   the kernels), whose errors the kernel records carry;
3. kernels: each kernel (K1 W8A16 matmul, K2 tree attention, K3 KV write,
   K4 tree-rollback gather) against its plain PyTorch version at the
   Lumina lane's shapes, with known-wrong variants that the comparison
   must catch, median times (CUDA events, L2 flushed before every launch),
   the bound from bytes and operations, and the PyTorch library yardstick;
   first ``launch_floor_ms``, the time of a trivial launch, against which
   K3's and K4's lines state their share of the bound, rate and multiple.
   K1 at all six weight shapes and every width of its instruction, with
   the rows of 1-, 10- and 22-row launches equal to those of the 64-row
   launch bit for bit; K2 at the decode shapes, at this run's KV
   capacity, at blocks of 96 to 512 rows (a prompt's prefill) and, for the
   drafter, with a bf16 one-layer cache and the provisional window of each
   tree level; K3 and K4 byte-exact at the lane's shapes and at their edge
   cases (T = 7 and 33, the last and a clamped start, zero rows and rounding
   ties; A = 1, A = blk in registers and in shared memory);
4. forward: a tiny head_dim-128 Chameleon forward, and a tiny drafter
   (``extend``, then two tree levels with write offset and window),
   through the kernels on the card against the plain path on the CPU;
5. main paths: Lumina-mGPT-7B geometry (32 layers, full width), random
   int8 weights from a seed, int8 KV cache, 48x48-grid FSM vocabulary, 16
   text tokens and the calibrated tree ``ckpts/bench_tree_lumina.json``,
   LANTERN k=10 delta=5, top-2000, cfg 3.0.  Four paths, each with the
   launch counters reset just before and read just after, and (for the
   stale + deferred path) a profile of a few steps (device time by kernel,
   the four port kernels' rows always among them, device-busy share):
   - the AR twin;
   - the speculative engine with stale drafting and deferred commit (K1,
     K2, K3);
   - the rollback path: the EAGLE drafter (the hidden-passthrough one,
     int8) proposing the tree, provisional tree write and rollback (K1,
     K2, K3, K4); its launch counts must equal the counts derived from
     the tree's levels, K4 exactly once per verify step;
   - the long-prompt path: 200 text tokens (203 prompt rows: one K2 launch
     a layer at T = 203) prefilled through ``forward``, then 8 AR tokens;
     the tokens must be legal under the FSM and the launch counts equal
     the derived ones (32 K2 launches for the prefill);
5b. gqa (``phase_gqa``, after the main paths): ``lumina_gqa8``, the
   Lumina-7B geometry with 8 KV heads of 128 under its 32 query heads
   (grouped-query attention; K2 folds the 4 query heads of a KV head into
   its rows).  (a) Cut to ``GQA_CUT_LAYERS`` layers, the kernels on the
   card against the plain path on the CPU: a prefill, the tree block under
   its ancestor mask, the one-layer drafter's ``extend`` and two levels
   (the second behind its window), ``GQA_GREEDY_STEPS`` greedy T = 1
   steps whose tokens the CPU's argmax repeats, one more step; logits
   within ``2e-2 * max|ref|``.  (b) At full width and depth, pinned
   (``pin = 0.5``) stale + deferred spec and its AR twin, ``GQA_TOKENS``
   tokens each, legal under the grid FSM, with the derived launch counts,
   tok/s, C, steps and peak memory.  (c) K2 at grouped-query heads
   against its plain version with times (G = 8, rep = 4, S = 2560, T = 1
   and the tree's 32 rows; 20 heads of 64 over 4 KV heads at T = 26), the
   known-wrong head mapping (query head n reading KV head n % nkv) beyond
   the tolerance;
6. rollback check: with pinned choices (``pin=0.5``) and stale drafting,
   ``deferred_commit`` False and True must commit the same tokens in the
   same steps (both modes commit the same bytes; K4 only moves them);
7. the XL lane: in phase 3 each kernel at LlamaGen-XL's shapes (K2 with two
   heads of 64 a 128-lane group, which must catch swapped heads and a
   softmax shared by both, every row compared, the caption's pad rows that
   see no key too; K3 and K4 byte-exact at 36 layers and 10
   groups), in phase 4 a tiny LlamaGen forward card vs CPU, and after
   phase 6 LlamaGen-XL t2i at full width and depth (36 layers x 1280, 20
   heads of 64, vocab 16384, a left-padded 120-row ``RandomT5`` caption,
   256 image tokens, the passthrough drafter): the AR twin (bf16 KV),
   static spec over ``ckpts/bench_tree_XL.json`` with deferred commit (bf16
   KV) and dynamic EAGLE-2 spec (59/4/10) with the rollback commit (int8
   KV), each with its launch counts equal to the derived ones (K4 once a
   dynamic verify step) and its tokens in the vocab; then
   the rollback check of step 6 on the XL static path (the drafter over the
   calibrated tree, bf16 KV);
8. batched serving: in phase 3 K2, K3 and K4 with one length or start per
   batch row at the batches' shapes (K2 must catch every row taking row
   0's length, K3 and K4 two slots' starts swapped; byte-exact with a
   clamped start) and K1 at the batched verify's 144 rows; then the
   batched XL path (the XL model cut to its first ``CUT_LAYERS`` layers
   for time; phase 13 holds it batched at full depth against lone
   ``spec.generate`` runs): 12 captioned requests (distinct pad counts and
   seeds)
   through ``Scheduler`` on the native queue into a ``BatchedEngine`` of 8
   slots (``chain_bush_8``, static, rollback, int8 KV, the passthrough
   drafter, LANTERN k=10 delta=5, top-2000, cfg 3.0, ``BATCH_TOKENS``
   tokens each).
   It fails if any request has ``error`` set (a kernel fault would show
   there), if a stream is short or leaves the vocab, if the launch counts
   differ from the derived ones (one K2 a layer, one K3 and one K4 a
   batched step; K1 ``ceil(2R * 9 / 64)`` launches a base matmul; the
   drafter per slot), if a request that refills a slot (``BATCH_ALONE``,
   4 of the 12) differs in tokens or steps from its lone ``spec.generate``
   run of the same seed (sampled) or if a pinned (``pin = 0.5``, 64 tokens)
   batched run of all 12 requests on the 8 slots (first fills and refills)
   differs from their lone runs; ``step_many``
   must run under ``torch.cuda.set_sync_debug_mode("error")``.  It prints
   the aggregate tokens/s over the slots, the refills' lone tokens/s and a
   profile of the batched step.  Last a ragged Lumina
   batch (full width, 4 layers, prompts of 16, 9 and 4 text tokens on 3
   slots under one grid FSM, pinned): each stream must equal its lone run
   under its own FSM, with derived launch counts;
9. sessions (``phase_session``, after the parallel phase): the XL
   ``LlamaGenSession`` around the XL lane's int8 weights (cut to
   ``CUT_LAYERS`` layers, as phase 8) with a VQ-16 codec
   at its published width makes an image from a caption (``generate`` +
   ``decode_ids``; a 256x256 uint8 image within one level of the CPU
   decode of the same codes); K2 with a tree mask per slot at the batched
   dynamic verify's shape against its plain version (every row taking
   row 0's mask must fail), with its times and SDPA's; ``generate_batch``
   over 6 captions on 4 slots in static, dynamic (pinned) and lockstep AR
   mode, each request equal to its lone ``generate``; a Lumina
   ``ChameleonSession`` (4 layers, full width) takes a 16x16 grid through
   ``generate`` and ``decode_generated`` with the Chameleon VQGAN at its
   published config.  Every path's launch counts equal the derived ones.
   Then the serving policy (``phase_policy``): every ``MEASURED_BEST``
   entry builds; ``generate_batch(tree="auto", slots=4)`` on both sessions
   equals a run of the tree or mode ``serving_plan(4)`` names; and
   ``python -m lantern_tpu_torch.engine.sweep`` in a subprocess (XL
   width, ``CUT_LAYERS`` layers, R 1 and 4, ``chain_bush_8`` and AR, one
   repeat of 16 tokens) prints its schema.
   ``--session-only`` runs the build and this phase alone;
10. tools (``phase_tools``, after the sessions): K1 at the autotune
   verify's rows (M = 80-120) and K2 at the autotune and teacher-forcing
   blocks against their plain versions with times; ``autotune_total_tokens``
   on XL (cut to ``CUT_LAYERS`` layers, time) and Lumina-7B (the pick
   equal to the weighted argmin of the times
   it read, derived launch counts a forward); pinned XL static runs with
   ``lantern_rt`` equal to their static counterparts; the XL calibrations
   (``measure_rank_probs`` with derived launch counts,
   ``measure_drafter_accept_probs``), ``optimize_tree`` and a json tree;
   ``measure_rank_probs`` card vs CPU on a tiny bf16 model;
   ``measure_stale_accept_probs`` on Lumina-7B over the 16x16 grid;
   ``generate_codebook`` at 16384x8 against the CPU's distances; and
   ``python -m lantern_tpu_torch generate_images`` as subprocesses (XL
   single over the calibrated tree, ``--slots 2 --total-tokens -1``,
   ``--model-type base --slots 2``; Lumina at 256 px), every PNG and
   statistics file checked.  ``--tools-only`` runs the build and this
   phase alone.
11. train (``phase_train``, after the tools): no kernel runs in training
   (the kernels refuse autograd); a tiny f32 drafter and finetune step card
   vs CPU; at LlamaGen-XL's full width and depth ``generate_train_data``
   (4 self-generated samples on 2 slots with derived K2 and K3 counts, and
   the CLI over their codes in a subprocess), ``train_drafter`` on them
   (the loss must fall), a finetune step of the whole base (save, restore
   and resume equal) and the trained drafter serving static and dynamic
   beside the passthrough drafter (derived launch counts, C printed).
   ``--train-only`` runs the build and this phase alone.
12. evals (``phase_evals``, after the train phase; no kernel runs): the
   PNG reader and the resampler card vs CPU; ``python -m
   lantern_tpu_torch extract_code`` on seeded PNGs with a random VQ-16 at
   its published width (codes equal to a CPU encode on the clear
   latents), its codes fed to ``generate_train_data --codes-dir``;
   Inception-V3 pool3, VGG16 fc2, CLIP ViT-B/32 and OpenCLIP ViT-H/14 at
   their published widths, card vs CPU, each with a known-wrong variant
   that must miss, and their images/s at a batch of 64; FID and precision
   / recall on 5,000 seeded features card vs numpy f64; the three eval
   CLIs as subprocesses.  ``--evals-only`` runs the build and this phase
   alone.
13. parallel (``phase_parallel``, after the batched XL path): rank
   processes of this script (``--parallel-rank``), each with a time limit,
   on the (dp, tp) mesh of ``lantern_tpu_torch/parallel``.  (a) NCCL in a
   world of one (``init_distributed()`` from ``RANK=0 WORLD_SIZE=1
   MASTER_ADDR=127.0.0.1``, ``Mesh(dp=1, tp=1)``): the pinned stale +
   deferred Lumina-7B path at 16x16 (64 tokens) under ``set_mesh``
   equals the run without it bit for bit, with the derived launch counts, and
   ``host_mean(3.0) == 3.0``.  (b) Lumina-7B at full width over tp = 2
   (both (a) and (b) cut to ``PARALLEL_LUMINA_LAYERS`` layers), two ranks on the one card over gloo (NCCL refuses two ranks on
   one device): the prefill's and a tree verify's logits within
   ``PARALLEL_TOL_FACTOR`` of the one-split floor of one process's, equal
   on both ranks, and three known-wrong layouts (the ``wo`` reduce skipped
   on one layer, ``skip_wo_reduce``; the reduce after the swin norm,
   ``reduce_after_norm``; the row split quantized per shard) beyond it;
   the pinned path, 64 tokens, equal on both ranks, with ms a step, the
   collectives' share, peak memory and derived launch counts; K1 at the
   shard shapes and K2 at half the head groups against their plain versions with times (K2 on a
   rank's groups at the whole model's split count equal to those groups of
   the whole launch).  (c) LlamaGen-XL at full width and depth over dp =
   2, two ranks over gloo, the batched configuration of phase 8 (64 tokens
   a request) on 4 of 8 slots a rank through the native ``Scheduler``:
   every request's uid, tokens and steps equal the one-process batched
   run, and that run's (at full depth, where phase 8 runs cut) equal
   ``spec.generate`` alone for ``PARALLEL_ALONE`` of its requests, first
   fills and refills.  (a) also trains a tiny f32 LlamaGen two steps
   through the FSDP step at ``Mesh(dp=1, tp=1)`` and the pipeline at pp =
   1, both bit-equal to ``finetune.train_step`` (their collectives NCCL's
   over groups of one).  (d) and (e) train LlamaGen-XL at full width, cut
   to ``PARALLEL_TRAIN_LAYERS`` layers (bf16 weights, ``TRAIN_ROWS``
   token-only rows of ``TRAIN_T``),
   two ranks over gloo in one spawn: (d) GPipe over pp = 2 with
   ``TRAIN_MICRO`` microbatches, (e) FSDP over tp = 2 with the weights
   and AdamW state sharded and a biting clip.  Loss, gradients (d), grad
   norm (e) and the parameters after two steps lie within
   ``TRAIN_TOL_FACTOR`` of a floor measured in the same run (one process's
   gradients over the sharded run's parts of the batch, summed) of one
   process's, and the known-wrong variants lie beyond it: (d) the
   replicated leaves' gradients not summed over pp, the stages' layer
   slices swapped; (e) the clip by the shard's own norm, and the tp
   reduce-scatter replaced by the rank's own gradient ((e) holds each
   parameter leaf to its own floor).  Each prints ms a
   step, the collectives' share of an instrumented step and peak memory a
   rank.  ``--parallel-only`` runs the build and this phase alone;
   ``--parallel-train-only`` the build, the self-test, (a), (d) and (e).

Each phase prints its seconds.  The line before the last two is
``{"kernels": [...]}`` (``launches`` are the rollback path's, the one Lumina
path that runs all four kernels; every path's counts are under
``launches_by_path``; each kernel's XL record is under ``xl``, its per-row
record at the XL batch under ``batched``, K2's per-slot-mask record
under ``dynamic_batched``, its grouped-query records under ``gqa``, and
K1's and K2's tools-phase records under
``tools``, their tp = 2 shard records under ``parallel_tp2``); then
the ``nvidia-smi`` name/power-limit line; the last line is the device
record.  Each kernel record also carries the self-test's error of its
check (``selftest_max_abs_err``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

K1_SHAPES = {"wqkv": (4096, 12288), "wo": (4096, 4096), "w_gu": (4096, 22016),
             "w_down": (11008, 4096), "lm_head": (4096, 65536),
             "fc_w": (8192, 4096)}          # the drafter's input fusion
K1_SHAPES_XL = {"wqkv": (1280, 3840), "wo": (1280, 1280), "w_gu": (1280, 7168),
                "w_down": (3584, 1280), "lm_head": (1280, 16384),
                "fc_w": (2560, 1280)}
# the port's kernels, and the part of their device names the profile finds
PORT_KERNELS = (("int8_matmul", "int8_matmul_kernel"),
                ("tree_attention", "tree_attention_kernel"),
                ("kv_write", "kv_write_kernel"), ("kv_gather", "kv_gather"))
TEXT = list(range(60000, 60016))          # 16 text tokens, as bench.py
LONG_TEXT = list(range(60000, 60200))     # 200 text tokens: a long prompt
XL_CAPTION = "a photo of a red fox standing in fresh snow at dawn"  # 12 words
# the batched XL path: slots, requests through the scheduler, and their
# captions (of different lengths, so of different left-pad counts)
BATCH_SLOTS = 8
BATCH_CAPTIONS = [
    "two cats", "a sunflower field", "a plate of pancakes",
    "a red fox in snow", "an owl on a tree branch",
    "a city street in the evening rain",
    "an old steam train crossing a stone bridge",
    "a lighthouse on a cliff at night under stars",
    "a snowy mountain lake reflecting pine trees at golden sunset",
    "a watercolor painting of a harbor town in the morning fog",
    "a bowl of ramen with an egg and green onions on top",
    "a photo of a red fox standing in fresh snow at dawn light"]
# the XL layers of the batched and session phases, cut from 36 for time
# (the parallel phase holds batched XL at full depth against lone runs),
# and the batched phase's tokens a request
CUT_LAYERS = 6
# the gqa phase: lumina_gqa8 (Lumina-7B with 8 KV heads of 128 under its 32
# query heads), card vs CPU at GQA_CUT_LAYERS layers over GQA_GREEDY_STEPS
# greedy steps, then at full depth GQA_TOKENS tokens a run
GQA_KV_HEADS = 8
GQA_CUT_LAYERS = 4
GQA_GREEDY_STEPS = 16
GQA_TOKENS = 64
BATCH_TOKENS = 256
# the batched requests also run alone: every request that refills a slot
# (all 12, first fills and refills, are held batched against alone by the
# pinned check)
BATCH_ALONE = tuple(range(BATCH_SLOTS, len(BATCH_CAPTIONS)))
# the ragged Lumina batch: full Lumina width, 4 layers, token prompts of
# three lengths on 3 slots, an 8 x 8 image grid
RAGGED_TEXTS = [list(range(60000, 60016)), list(range(61000, 61009)),
                list(range(62000, 62004))]
RAGGED_LAYERS = 4
RAGGED_GRID = 8
# the session phase: the batched modes serve the first 6 batch captions on
# 4 slots, 32 tokens each; the Lumina session's prompt (hash_tokenize)
SESSION_REQUESTS = 6
SESSION_SLOTS = 4
SESSION_TOKENS = 32
LUMINA_PROMPT = "a watercolor painting of a harbor town in the morning fog"
# the policy phase's sweep subprocess: its time limit
POLICY_SWEEP_TIMEOUT = 240
# the tools phase: the verify rows K1 takes at autotune's candidate tree
# sizes (M = 2L, two launches a matmul past 64 rows); the calibration's
# rollout and tree budget; the tokens of the runtime-point runs and of each
# CLI request (64 tokens: a 128 px image)
AUTOTUNE_M = (80, 96, 100, 112, 120)
CALIB_TOKENS = 256
CALIB_NODES, CALIB_DEPTH = 25, 6
RT_TOKENS = 64
CLI_TOKENS = 64
CLI_CAPTIONS = "a red fox in snow|an owl on a tree branch|a lighthouse at night"
# the train phase: self-generated samples and their slots, the samples the
# CLI recomputes from their codes, the drafter's epochs and learning rate,
# the finetune's steps and learning rate, and the tokens the trained
# drafter serves
TRAIN_SAMPLES, TRAIN_SLOTS, TRAIN_CLI_SAMPLES = 4, 2, 2
TRAIN_EPOCHS, TRAIN_LR = 30, 1e-3
FT_STEPS, FT_LR = 4, 1e-4
TRAIN_SERVE_TOKENS = 64
# the parallel phase: where the rank processes write their logs and
# results, each part's time limit, the tokens of the NCCL, tp = 2 and
# dp = 2 runs, the tp = 2 logits' tolerance, the layer the skipped-reduce variant
# hits, and the steps of the run that times every collective.  The
# tolerance is a multiple of a floor measured in the same run: one
# process's logits with K1 and K2 at one split each (the same products
# summed in another order) against its logits at their usual splits.  A
# bf16 rounding that an order flips moves an int8 KV row's quantization by
# a step, so at 32 random layers any order differs by ~2.5 % RMS; a tp
# rank sums in its own order and must land within PARALLEL_TOL_FACTOR of
# that floor, block by block (RMS difference over the reference's RMS)
PARALLEL_DIR = os.path.join("build", "parallel")
PARALLEL_TIMEOUT = 420
PARALLEL_TOKENS = 64
# (c)'s one-process batched run at full depth against spec.generate alone:
# two requests of the first fill of the 8 slots and two refills
PARALLEL_ALONE = (0, 5, 8, 11)
PARALLEL_TOL_FACTOR = 1.3
PARALLEL_WRONG_LAYER = 8
# (a) and (b) run Lumina-7B at full width cut to this many of its 32 layers
# (the smoke's time limit)
PARALLEL_LUMINA_LAYERS = 16
PARALLEL_PROFILE_STEPS = 8
# the parallel phase's training parts, (d) GPipe at pp = 2 and (e) FSDP at
# tp = 2, on LlamaGen-XL at full width, cut to PARALLEL_TRAIN_LAYERS of its
# 36 layers (the smoke's time limit), with bf16 weights: the
# batch's token-only rows (the pipeline refuses a cond prefix, as JAX's
# does), (d)'s microbatches and learning rate, (e)'s learning rate and
# clip.  (e) clips to a norm far under the gradient's so that the clipped
# gradients sit under AdamW's eps and the step scales with the clip (a
# clip by a shard's own norm then moves the weights another way), with a
# learning rate at which that step moves bf16 weights.  Each check holds
# the sharded run to one process's within TRAIN_TOL_FACTOR of a floor
# measured in the same run: one process's gradients with the batch's rows
# in the parts the sharded run splits them into (4 microbatches; 2 ranks'
# rows), each part's backward alone, summed, against the whole batch's
TRAIN_ROWS, TRAIN_T, TRAIN_MICRO = 4, 256, 4
PARALLEL_TRAIN_LAYERS = 12
PIPE_LR = 1e-3
FSDP_LR, FSDP_CLIP = 1e-1, 1e-5
TRAIN_TOL_FACTOR = 3.0
# (e) holds each parameter leaf to its own floor: the norm weights near
# 1.0, whose update under the biting clip is near half a bf16 ulp, have the
# largest floor by far (PERF.md §6), and one floor for all would let any
# other leaf's update be ~25 % off.  A leaf whose floor is under this
# (every bit equal, say) is held to this.
FSDP_LEAF_FLOOR_MIN = 1e-3
# the evals phase: seeded PNGs for extract_code and as reference images,
# the batch of the backbones' rates, and the metrics' feature count (COCO
# val2017's FID size)
EVAL_PNGS = 8
EVAL_BATCH = 64
METRIC_N = 5000


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of ``fn`` with a cold L2 before each call."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8,
                                 device="cuda")

    def __call__(self, fn, reps: int = 15, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            # the last fill leaves the L2 cold; the ones before it keep the
            # card busy while the host launches fn, so that a slow host does
            # not show up between the two events
            for _ in range(3):
                self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def lane_dims(grid: int) -> tuple[int, int]:
    """(tokens to generate, sequence capacity) of the Lumina lane on a
    ``grid`` x ``grid`` image: ``grid`` rows of ``grid`` tokens and a newline,
    end-of-image, and room for one tree block after the last token."""
    max_new = grid * (grid + 1) + 1
    return max_new, len(TEXT) + 3 + max_new + 74


class KernelPhase:
    """The kernel phase: every kernel against its plain version at the
    lane's shapes, with times.  One method per kernel; each returns the
    record of its representative shape."""

    B, G, W = 2, 32, 128          # CFG pair, head groups, group width

    def __init__(self, torch, timer, card: str):
        from lantern_tpu_torch import trees

        self.torch, self.timer, self.card = torch, timer, card
        self.dev = "cuda"
        self.gen = torch.Generator(device="cuda").manual_seed(1234)
        self.tree = trees.get_tree(os.path.join("ckpts",
                                                "bench_tree_lumina.json"))
        self.level_rows = [len(lv.child_flat_idx) for lv in self.tree.levels]
        self.tree_xl = trees.get_tree(os.path.join("ckpts",
                                                   "bench_tree_XL.json"))
        # the launch floor: a trivial launch, a fill of a one-element CUDA
        # tensor, timed as the kernels are; K3 and K4 lines state their
        # multiple of it
        one = torch.zeros((1,), device="cuda")
        self.floor = timer(lambda: one.fill_(1.0))
        log(f"launch_floor_ms {self.floor:.4f} (a fill of a one-element CUDA "
            f"tensor, median of 15 as every kernel time) [{card}]")

    def randn(self, *shape):
        torch = self.torch
        return torch.randn(shape, generator=self.gen,
                           device=self.dev).to(torch.bfloat16)

    def planes_of(self, L, S, quant, G=None, B=None):
        """Random K/V planes (and scale planes for int8) [L, B, G, S, W]."""
        torch, W = self.torch, self.W
        G, B = G or self.G, B or self.B
        if quant:
            return [torch.randint(-127, 128, (L, B, G, S, W),
                                  generator=self.gen, device=self.dev,
                                  dtype=torch.int8) for _ in range(2)] + [
                torch.rand((L, B, G, S), generator=self.gen, device=self.dev)
                for _ in range(2)]
        return [self.randn(L, B, G, S, W) for _ in range(2)] + [None, None]

    @staticmethod
    def clones(planes):
        return [None if t is None else t.clone() for t in planes]

    def same_bytes(self, a, b):
        torch = self.torch
        return all(x is None or torch.equal(x.view(torch.uint8),
                                            y.view(torch.uint8))
                   for x, y in zip(a, b))

    def k1_shape(self, name: str, K: int, N: int, rows, rep_M, lane: str,
                 out_dt=None):
        """K1 at one weight shape and each row count of ``rows``: error
        against the plain version, a dropped k split caught, times.  The
        output is f32 for the lm_head (or ``out_dt``), else bf16.  Returns
        ``(max error, record at rep_M or None, q, s)``."""
        from lantern_tpu_torch.ops.quant import (K1_STAGE_ROWS, int8_matmul,
                                                 int8_matmul_cuda,
                                                 k1_split_stages, k1_splits)
        from lantern_tpu_torch.ops._cuda import sm_count

        torch, timer, card, dev = self.torch, self.timer, self.card, self.dev
        gen, randn = self.gen, self.randn
        q = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        s = (torch.rand((1, N), generator=gen, device=dev) + 0.5) * 2e-4
        if out_dt is None:
            out_dt = torch.float32 if name == "lm_head" else torch.bfloat16
        nsplit = k1_splits(K, N, sm_count(torch.device(dev, 0)))
        # known-wrong variant: one k split's rows dropped (with one split,
        # one stage's)
        a, b = k1_split_stages(K, nsplit)[nsplit // 2]
        if nsplit == 1:
            b = a + 1
        k1_err, rep = 0.0, None
        for M in rows:
            x = randn(M, K)
            got = int8_matmul_cuda(x, q, s, out_dt)
            ref = int8_matmul(x, q, s, out_dt)
            torch.cuda.synchronize()
            scale_ = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            tol = 1e-2 * scale_ + 1e-6
            if not (err <= tol and torch.isfinite(got.float()).all()):
                fail(f"K1 {lane}{name} M={M}: max err {err} > tol {tol}")
            k1_err = max(k1_err, err)
            x2 = x.clone()
            x2[:, a * K1_STAGE_ROWS:b * K1_STAGE_ROWS] = 0
            werr = (int8_matmul(x2, q, s, out_dt).float()
                    - ref.float()).abs().max().item()
            if werr <= tol:
                fail(f"K1 {lane}{name} M={M}: tol {tol} does not separate a "
                     f"wrong variant (k rows of stages [{a}, {b}) dropped: "
                     f"err {werr})")
            ms = timer(lambda: int8_matmul_cuda(x, q, s, out_dt))
            plain = timer(lambda: int8_matmul(x, q, s, out_dt), reps=5)
            lib = timer(lambda: (x @ q.to(torch.bfloat16)) * s, reps=5)
            nbytes = M * K * 2 + K * N + N * 4 + M * N * (4 if out_dt == torch.float32 else 2)
            b_ms, b_by = bound(nbytes, 2.0 * M * K * N)
            log(f"K1 int8_matmul {lane}{name} M={M} K={K} N={N} splits={nsplit}: "
                f"max_abs_err {err:.3e} (tol {tol:.3e}; a dropped k split "
                f"errs {werr:.3e}) ms {ms:.4f} plain_ms {plain:.4f} "
                f"library_ms {lib:.4f} bound_ms {b_ms:.4f} ({b_by}) [{card}]")
            if M == rep_M:
                rep = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=b_ms, bound_by=b_by,
                           shape=f"{lane}M={M} K={K} N={N} ({name})")
        return k1_err, rep, q, s

    def k1(self) -> dict:
        from lantern_tpu_torch.ops.quant import K1_MAX_ROWS, int8_matmul_cuda

        torch = self.torch
        # rows: AR 2, prefill 38, tree verify 64; the drafter's levels and
        # its extension run 2 x the level's / the path's rows; the long
        # prompt's prefill ends on a launch of 22 rows.  Together they take
        # every width of the kernel's instruction (8, 16, 32, 64 rows)
        k1_rows = sorted({2, 38, 64, 2 * max(self.level_rows),
                          2 * self.tree.path_len,
                          2 * (len(LONG_TEXT) + 3) % K1_MAX_ROWS})
        if {min(w for w in (8, 16, 32, 64) if M <= w)
                for M in k1_rows} != {8, 16, 32, 64}:
            fail(f"K1: the row counts {k1_rows} miss a width of the kernel")
        k1_err, k1_rep = 0.0, None
        for name, (K, N) in K1_SHAPES.items():
            err, rep, q, s = self.k1_shape(name, K, N, k1_rows,
                                           64 if name == "w_gu" else None, "")
            k1_err, k1_rep = max(k1_err, err), rep or k1_rep
            # a row's result depends on neither M nor the other rows: every
            # row of a launch of 1, 10 and 22 rows (the instruction's 8-, 16-
            # and 32-row widths) equals its row of the 64-row launch
            x = self.randn(64, K)
            full = int8_matmul_cuda(x, q, s, torch.float32)
            for M in (1, 10, 22):
                few = int8_matmul_cuda(x[:M], q, s, torch.float32)
                torch.cuda.synchronize()
                if not torch.equal(few, full[:M]):
                    fail(f"K1 {name}: the rows of an M={M} launch differ from "
                         f"those of the M=64 launch (max diff "
                         f"{(few - full[:M]).abs().max().item():.3e})")
            log(f"K1 int8_matmul {name} K={K} N={N}: row 0 at M=64 equals the "
                f"M=1 launch bit for bit, and so do all rows of M=10 and M=22")
        return dict(k1_rep, max_abs_err=k1_err)

    def k1_xl(self) -> dict:
        """K1 at LlamaGen-XL's six weight shapes and the XL paths' rows: 2
        (AR), 52 (the 26-row tree), 118 (a 59-row dynamic tree), 144 (the
        batched verify: 8 slots x CFG 2 x the 9-row tree, three launches),
        240 (the caption prefill).  Returns ``(record at M = 52, record at
        M = 144)``."""
        k1_err, k1_rep, k1_batch = 0.0, None, None
        for name, (K, N) in K1_SHAPES_XL.items():
            err, rep, _, _ = self.k1_shape(name, K, N, (2, 52, 118, 240),
                                           52 if name == "w_gu" else None,
                                           "XL ")
            k1_err, k1_rep = max(k1_err, err), rep or k1_rep
            M = 2 * BATCH_SLOTS * 9
            err, rep, _, _ = self.k1_shape(name, K, N, (M,),
                                           M if name == "w_gu" else None,
                                           "XL batch ")
            k1_err, k1_batch = max(k1_err, err), rep or k1_batch
        return (dict(k1_rep, max_abs_err=k1_err),
                dict(k1_batch, max_abs_err=k1_err))

    def k2(self, grid: int) -> dict:
        import torch.nn.functional as F

        from lantern_tpu_torch.kv import group_blocks, quantize_rows
        from lantern_tpu_torch.ops.tree_attention import (
            NEG_INF, tree_attention_cuda, tree_attention_plain)

        torch, timer, card, dev = self.torch, self.timer, self.card, self.dev
        tree, level_rows, randn = self.tree, self.level_rows, self.randn
        B, G, W = self.B, self.G, self.W
        tmask = torch.as_tensor(tree.attn_mask, device=dev)
        # the bench lane's capacity (4 prefix splits merged in the launch), then
        # this run's grid capacity, so each run checks the split count its own
        # main path uses
        cases = [(2560, 1, 2371), (2560, 19, 0), (2560, 32, 1237)]
        max_new, max_seq_len = lane_dims(grid)
        S_run, prompt = -(-max_seq_len // 128) * 128, len(TEXT) + 3
        if S_run != 2560:
            cases += [(S_run, 1, prompt + max_new - 2),
                      (S_run, 32, (prompt + max_new // 2) | 1)]
        # long blocks: a prompt's prefill (causal mask, rows tiled over the
        # grid), alone and after a prefix; T = 203 is the long-prompt path's
        cases += [(2560, 96, 0), (2560, 200, 0), (2560, 512, 0),
                  (2560, 96, 300), (S_run, len(LONG_TEXT) + 3, 0)]
        k2_err, k2_rep = 0.0, None
        for S, T, length in cases:
            q, kn, vn = randn(B, T, G, W), randn(B, T, G, W), randn(B, T, G, W)
            kc, ks = quantize_rows(randn(B, G, S, W))
            vc, vs = quantize_rows(randn(B, G, S, W))
            if T == 32:
                mask = tmask[None].expand(B, T, T).contiguous()
            else:
                mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                             device=dev))[None].expand(B, T, T)
                mask = mask.contiguous()
            bias = torch.zeros((B, S), device=dev)
            bias[1, :7] = NEG_INF                      # left-padded uncond row
            ln = torch.tensor(length, dtype=torch.int32, device=dev)
            args = (q, kn, vn, kc, vc, ln, mask, bias, W ** -0.5)
            kw = dict(k_scale=ks, v_scale=vs)
            got = tree_attention_cuda(*args, **kw)
            ref = tree_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            tol = 2e-2 * ref.float().abs().max().item()
            if not (err <= tol and torch.isfinite(got.float()).all()):
                fail(f"K2 S={S} T={T} length={length}: max err {err} > tol {tol}")
            k2_err = max(k2_err, err)
            # known-wrong variants of the function must land outside tol
            wrong = {}
            if length:
                wrong["v_scale dropped"] = dict(v_scale=torch.ones_like(vs))
                b2 = bias.clone()
                b2[:, length - 1] = NEG_INF
                wrong["last prefix key dropped"] = dict(bias=b2)
            if length >= 64:
                b2 = bias.clone()
                j0 = length // 2 // 32 * 32
                b2[:, j0:j0 + 32] = NEG_INF
                wrong["a 32-key prefix tile dropped"] = dict(bias=b2)
            if T > 1:
                m2 = mask.clone()
                row = T - 1 if T <= 32 else 1      # a row with few keys
                m2[:, row, 0] = ~m2[:, row, 0]
                wrong["a mask entry flipped"] = dict(mask=m2)
            # one warp's keys dropped: keys 16..31 of every 64-key tile
            warp1 = (torch.arange(max(S, T), device=dev) % 64) // 16 == 1
            if length >= 32:
                b2 = bias.clone()
                b2[:, :length] = torch.where(warp1[:length], NEG_INF,
                                             bias[:, :length])
                wrong["one warp's prefix keys dropped"] = dict(bias=b2)
            if T >= 32:
                wrong["one warp's block keys dropped"] = dict(
                    mask=mask & ~warp1[None, None, :T])
            werr = {}
            for why, over in wrong.items():
                bad = tree_attention_plain(
                    q, kn, vn, kc, vc, ln, over.get("mask", mask),
                    over.get("bias", bias), W ** -0.5, k_scale=ks,
                    v_scale=over.get("v_scale", vs))
                werr[why] = (bad.float() - ref.float()).abs().max().item()
                if werr[why] <= tol:
                    fail(f"K2 S={S} T={T} length={length}: tol {tol} does not "
                         f"separate a wrong variant ({why}: err {werr[why]})")
            ms = timer(lambda: tree_attention_cuda(*args, **kw))
            plain = timer(lambda: tree_attention_plain(*args, **kw), reps=5)
            # library yardstick: SDPA over the dequantized prefix + block
            kd = torch.cat([(kc[:, :, :length].float() * ks[:, :, :length, None]),
                            quantize_rows(group_blocks(kn))[0].float()
                            * quantize_rows(group_blocks(kn))[1][..., None]],
                           dim=2).to(torch.bfloat16)
            vd = torch.cat([(vc[:, :, :length].float() * vs[:, :, :length, None]),
                            quantize_rows(group_blocks(vn))[0].float()
                            * quantize_rows(group_blocks(vn))[1][..., None]],
                           dim=2).to(torch.bfloat16)
            am = torch.cat([(bias[:, None, None, :length] == 0).expand(B, 1, T, length),
                            mask[:, None]], dim=-1)
            qh = q.transpose(1, 2)
            lib = timer(lambda: F.scaled_dot_product_attention(
                qh, kd, vd, attn_mask=am, scale=W ** -0.5))
            nbytes = (4 * B * T * G * W * 2 + 2 * B * G * length * (W + 4)
                      + B * T * T + B * length * 4)
            b_ms, b_by = bound(nbytes, 4.0 * B * G * T * (length + T) * W)
            log(f"K2 tree_attention S={S} T={T} length={length} int8 KV: "
                f"max_abs_err {err:.3e} (tol {tol:.3e} = 2e-2 * max|ref|) ms "
                f"{ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms "
                f"{b_ms:.4f} ({b_by}) [{card}]")
            log("  wrong variants' max err: " + "; ".join(
                f"{why} {e:.3e}" for why, e in werr.items()))
            if (S, T) == (2560, 32):
                k2_rep = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                              bound_by=b_by,
                              shape=f"B=2 T={T} G=32 length={length} int8 KV")
        # the kernel's own quantization of the block's rows: with nothing but
        # itself visible to a row, its output is bf16(v_scale) * v_int8, one
        # term with no sum to reorder, so kernel and plain version must
        # agree bit for bit
        for T in (32, 200):
            q, kn, vn = randn(B, T, G, W), randn(B, T, G, W), randn(B, T, G, W)
            kc, ks = quantize_rows(randn(B, G, 384, W))
            eye = torch.eye(T, dtype=torch.bool, device=dev)[None].expand(
                B, T, T).contiguous()
            args = (q, kn, vn, kc, kc, torch.zeros((), dtype=torch.int32,
                                                  device=dev), eye,
                    torch.zeros((B, 384), device=dev), W ** -0.5)
            got = tree_attention_cuda(*args, k_scale=ks, v_scale=ks)
            ref = tree_attention_plain(*args, k_scale=ks, v_scale=ks)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                fail(f"K2 T={T}: the block's rows are not quantized as "
                     f"kv.quantize_rows stores them (max diff "
                     f"{(got.float() - ref.float()).abs().max().item():.3e})")
            log(f"K2 tree_attention T={T} length=0, identity mask: equals the "
                f"plain version bit for bit (in-kernel row quantization)")
        # K2, the drafter's form: a bf16 one-layer cache, and per tree level its
        # rows, its block mask and the provisional window of the earlier
        # levels' rows (cache rows [length, length + block_offset))
        for S, length in sorted({(2560, 1237), (S_run, prompt - 1)}):
            for lv, T in zip(tree.levels, level_rows):
                off = int(lv.block_offset)
                lmask = torch.as_tensor(lv.attn_mask, device=dev)
                q, kn, vn = randn(B, T, G, W), randn(B, T, G, W), randn(B, T, G, W)
                kc, vc = randn(B, G, S, W), randn(B, G, S, W)
                bias = torch.zeros((B, S), device=dev)
                bias[1, :7] = NEG_INF
                ln = torch.tensor(length, dtype=torch.int32, device=dev)
                args = (q, kn, vn, kc, vc, ln,
                        lmask[None, :, off:].expand(B, T, T).contiguous(), bias,
                        W ** -0.5)
                wm = lmask[:, :off].contiguous() if off else None
                got = tree_attention_cuda(*args, window_mask=wm)
                ref = tree_attention_plain(*args, window_mask=wm)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                tol = 2e-2 * ref.float().abs().max().item()
                what = (f"K2 tree_attention S={S} T={T} length={length} "
                        f"window={off} bf16 KV (drafter level)")
                if not (err <= tol and torch.isfinite(got.float()).all()):
                    fail(f"{what}: max err {err} > tol {tol}")
                k2_err = max(k2_err, err)
                werr = {}
                if off:
                    wrong = {"window mask ignored": None,
                             "whole window visible": torch.ones_like(wm)}
                    for why, m2 in wrong.items():
                        bad = tree_attention_plain(*args, window_mask=m2)
                        werr[why] = (bad.float() - ref.float()).abs().max().item()
                        if werr[why] <= tol:
                            fail(f"{what}: tol {tol} does not separate a wrong "
                                 f"variant ({why}: err {werr[why]})")
                ms = timer(lambda: tree_attention_cuda(*args, window_mask=wm))
                plain = timer(lambda: tree_attention_plain(*args, window_mask=wm),
                              reps=5)
                kd = torch.cat([kc[:, :, :length + off],
                                group_blocks(kn)], dim=2)
                vd = torch.cat([vc[:, :, :length + off],
                                group_blocks(vn)], dim=2)
                am = (bias[:, None, None, :length] == 0).expand(B, 1, T, length)
                if off:
                    am = torch.cat([am, wm[None, None].expand(B, 1, T, off)], -1)
                am = torch.cat([am, args[6][:, None]], dim=-1)
                qh = q.transpose(1, 2)
                lib = timer(lambda: F.scaled_dot_product_attention(
                    qh, kd, vd, attn_mask=am, scale=W ** -0.5))
                nbytes = (4 * B * T * G * W * 2 + 2 * B * G * (length + off) * W * 2
                          + B * T * (T + off) + B * length * 4)
                b_ms, b_by = bound(nbytes, 4.0 * B * G * T * (length + off + T) * W)
                log(f"{what}: max_abs_err {err:.3e} (tol {tol:.3e} = 2e-2 * "
                    f"max|ref|) ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                    f"{lib:.4f} bound_ms {b_ms:.4f} ({b_by}) [{card}]")
                if werr:
                    log("  wrong variants' max err: " + "; ".join(
                        f"{why} {e:.3e}" for why, e in werr.items()))
        return dict(k2_rep, max_abs_err=k2_err)

    def k2_xl(self) -> dict:
        """K2 with two 64-wide heads a 128-lane group (``pk = 2``) at
        LlamaGen-XL's widths: B = 2, 10 groups of two heads, S = 512 (450
        rows rounded up).  T = 1 (AR), 26 (the XL tree), 59 (a dynamic
        tree), 120 (the caption prefill); the drafter's levels of 10 rows
        behind windows of 0 to 30 rows on a bf16 one-layer cache.  Each case
        must catch two known-wrong variants: the heads of a group swapped,
        and one softmax over the 128-wide product shared by both."""
        import torch.nn.functional as F

        from lantern_tpu_torch.kv import group_blocks, quantize_rows
        from lantern_tpu_torch.ops.tree_attention import (
            NEG_INF, tree_attention_cuda, tree_attention_plain)

        torch, timer, card, dev = self.torch, self.timer, self.card, self.dev
        B, G, S, W, hd = 2, 10, 512, 128, 64
        nh, Tc, tree = 2 * G, 120, self.tree_xl
        scale = hd ** -0.5
        # (T, length, int8 KV, block mask, window)
        cases = [(1, Tc + 255, True, "causal", 0),
                 (1, Tc + 255, False, "causal", 0),
                 (tree.num_nodes, 300, False, "tree", 0),
                 (tree.num_nodes, 300, True, "tree", 0),
                 (59, 300, True, "random", 0),
                 (Tc, 0, True, "causal", 0), (Tc, 0, False, "causal", 0),
                 (Tc, 0, True, "left-padded", 0)]
        cases += [(10, 299, False, "random", w) for w in (0, 10, 20, 30)]
        k2_err, k2_rep = 0.0, None
        for T, length, quant, mkind, window in cases:
            q, kn, vn = (self.randn(B, T, nh, hd) for _ in range(3))
            kc, vc = self.randn(B, G, S, W), self.randn(B, G, S, W)
            kw = {}
            if quant:
                (kc, ks), (vc, vs) = quantize_rows(kc), quantize_rows(vc)
                kw = dict(k_scale=ks, v_scale=vs)
            tril = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
            if mkind == "tree":
                mask = torch.as_tensor(tree.attn_mask, device=dev)[None]
            elif mkind == "random":
                mask = ((torch.rand((1, T, T), generator=self.gen, device=dev)
                         < 0.4) | torch.eye(T, dtype=torch.bool, device=dev))
            else:
                mask = tril[None]
            mask = mask.expand(B, T, T).contiguous()
            dead = torch.zeros((B, T), dtype=torch.bool, device=dev)
            if mkind == "left-padded":
                # the cond row's first 108 caption rows are pads (a 10-word
                # caption): a pad row sees no key at all, and both versions
                # give it the mean of the whole cache plane's and the
                # block's value rows
                mask = mask & ~(torch.arange(T, device=dev) < 108)[None, None]
                mask[1] = tril
                dead[0, :108] = True
            if window:
                kw["window_mask"] = (torch.rand((T, window), generator=self.gen,
                                                device=dev) < 0.5)
            bias = torch.zeros((B, S), device=dev)
            bias[1, :7] = NEG_INF
            ln = torch.tensor(length, dtype=torch.int32, device=dev)
            args = (q, kn, vn, kc, vc, ln, mask, bias, scale)
            got = tree_attention_cuda(*args, **kw)
            ref = tree_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            tol = 2e-2 * ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            what = (f"K2 tree_attention XL pk=2 S={S} T={T} length={length} "
                    f"{'int8' if quant else 'bf16'} KV, {mkind} mask"
                    f"{f', window {window}' if window else ''}")
            if not (err <= tol and torch.isfinite(got.float()).all()):
                fail(f"{what}: max err {err} > tol {tol}")
            if bool(dead.any()):
                # the means are small beside the other rows: their own scale
                dtol = 2e-2 * ref[dead].float().abs().max().item()
                derr = (got[dead].float() - ref[dead].float()).abs().max().item()
                if not derr <= dtol:
                    fail(f"{what}: rows that see no key, max err {derr} > tol "
                         f"{dtol}")
                log(f"{what}: the {int(dead.sum())} rows that see no key: "
                    f"max_abs_err {derr:.3e} (tol {dtol:.3e} = 2e-2 * their "
                    f"max|ref|)")
            k2_err = max(k2_err, err)
            swapped = ref.reshape(B, T, G, 2, hd).flip(3).reshape(ref.shape)
            wide = tree_attention_plain(
                q.reshape(B, T, G, W), kn.reshape(B, T, G, W),
                vn.reshape(B, T, G, W), *args[3:], **kw).reshape(ref.shape)
            werr = {}
            for why, bad in (("heads swapped", swapped),
                             ("one softmax for both heads", wide)):
                werr[why] = (bad.float() - ref.float()).abs().max().item()
                if werr[why] <= tol:
                    fail(f"{what}: tol {tol} does not separate a wrong variant "
                         f"({why}: err {werr[why]})")
            ms = timer(lambda: tree_attention_cuda(*args, **kw))
            plain = timer(lambda: tree_attention_plain(*args, **kw), reps=5)
            # library yardstick: SDPA over the dequantized prefix (and
            # window) + block, 20 heads of 64
            vis = length + window

            def heads(x):              # [B, G, n, 128] -> [B, 2G, n, 64]
                return x.reshape(B, G, -1, 2, hd).transpose(2, 3).reshape(
                    B, nh, -1, hd)
            if quant:
                kq, kqs = quantize_rows(group_blocks(kn))
                vq, vqs = quantize_rows(group_blocks(vn))
                kd = torch.cat([kc[:, :, :vis].float() * ks[:, :, :vis, None],
                                kq.float() * kqs[..., None]], 2).bfloat16()
                vd = torch.cat([vc[:, :, :vis].float() * vs[:, :, :vis, None],
                                vq.float() * vqs[..., None]], 2).bfloat16()
            else:
                kd = torch.cat([kc[:, :, :vis], group_blocks(kn)], 2)
                vd = torch.cat([vc[:, :, :vis], group_blocks(vn)], 2)
            kd, vd = heads(kd), heads(vd)
            am = (bias[:, None, None, :length] == 0).expand(B, 1, T, length)
            if window:
                am = torch.cat([am, kw["window_mask"][None, None].expand(
                    B, 1, T, window)], -1)
            am = torch.cat([am, mask[:, None]], dim=-1)
            qh = q.transpose(1, 2)
            lib = timer(lambda: F.scaled_dot_product_attention(
                qh, kd, vd, attn_mask=am, scale=scale))
            row = W * (1 if quant else 2) + (4 if quant else 0)
            nbytes = (4 * B * T * G * W * 2 + 2 * B * G * vis * row
                      + B * T * (T + window) + B * vis * 4)
            b_ms, b_by = bound(nbytes, 4.0 * B * G * T * (vis + T) * W)
            log(f"{what}: max_abs_err {err:.3e} (tol {tol:.3e} = 2e-2 * "
                f"max|ref|) ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                f"{lib:.4f} bound_ms {b_ms:.4f} ({b_by}) [{card}]")
            log("  wrong variants' max err: " + "; ".join(
                f"{why} {e:.3e}" for why, e in werr.items()))
            if (T, quant, window) == (1, True, 0):
                k2_rep = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              bound_ms=b_ms, bound_by=b_by,
                              shape=f"XL pk=2 B=2 T=1 G=10 S=512 length="
                                    f"{length} int8 KV")
        # with nothing but itself visible to a row, its output is
        # bf16(v_scale) * v_int8 of its own head: bit for bit
        T = Tc
        q, kn, vn = (self.randn(B, T, nh, hd) for _ in range(3))
        kc, ks = quantize_rows(self.randn(B, G, S, W))
        eye = torch.eye(T, dtype=torch.bool, device=dev)[None].expand(
            B, T, T).contiguous()
        args = (q, kn, vn, kc, kc, torch.zeros((), dtype=torch.int32,
                                              device=dev), eye,
                torch.zeros((B, S), device=dev), scale)
        got = tree_attention_cuda(*args, k_scale=ks, v_scale=ks)
        ref = tree_attention_plain(*args, k_scale=ks, v_scale=ks)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"K2 XL pk=2 T={T}: identity mask differs from the plain "
                 f"version (max diff "
                 f"{(got.float() - ref.float()).abs().max().item():.3e})")
        log(f"K2 tree_attention XL pk=2 T={T} length=0, identity mask: equals "
            f"the plain version bit for bit")
        return dict(k2_rep, max_abs_err=k2_err)

    def judge(self, ms: float, b_ms: float, nbytes: float) -> str:
        """A K3 or K4 time against its bound, its rate and the launch floor;
        a bound under the floor is said, and the floor judges the time."""
        out = (f"{100 * b_ms / ms:.1f}% of bound, {nbytes / ms / 1e9:.3f} "
               f"TB/s, {ms / self.floor:.2f}x launch floor")
        if b_ms < self.floor:
            out += " (bound under the launch floor: judged against the floor)"
        return out

    def k3_case(self, L, T, start, quant, rows, S, G, lane=""):
        """K3 at one case, byte-exact against its plain version over the
        whole planes, the rows outside the block untouched; timed.  Returns
        ``(max_abs_err, ms, plain_ms, bound_ms, bound_by)``."""
        from lantern_tpu_torch.kv import (group_blocks, write_block_cuda,
                                          write_block_plain)

        torch, timer, card, dev = self.torch, self.timer, self.card, self.dev
        randn, B, W = self.randn, self.B, self.W
        kn, vn = randn(L, B, T, G, W), randn(L, B, T, G, W)
        if rows:
            # t = 0: all-zero rows (scale 1/127); t = 1: amax 127, so
            # scale 1 and every other value a tie k + 0.5; t = 2: amax
            # 63.5, so scale 0.5 and the values (k + 0.5) / 2
            i = torch.arange(W, device=dev, dtype=torch.float32)
            ties = ((i % 126) + 0.5) * (1 - 2 * (i % 2))
            ties[0] = 127.0
            for x, sign in ((kn, 1.0), (vn, -1.0)):
                x[:, :, 0] = 0
                x[:, :, 1] = (sign * ties).to(torch.bfloat16)
                x[:, :, 2] = (sign * ties / 2).to(torch.bfloat16)
        mine = self.planes_of(L, S, quant, G)
        ref, before = self.clones(mine), self.clones(mine)
        st = torch.tensor(start, dtype=torch.int32, device=dev)
        write_block_cuda(*mine, kn, vn, st)
        write_block_plain(*ref, kn, vn, st)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(mine, ref) if a is not None)
        s0 = min(max(start, 0), S - T)
        outside = torch.ones(S, dtype=torch.bool, device=dev)
        outside[s0:s0 + T] = False
        untouched = all(torch.equal(a[..., outside, :] if a.ndim == 5 else a[..., outside],
                                    b[..., outside, :] if b.ndim == 5 else b[..., outside])
                        for a, b in zip(mine, before) if a is not None)
        kind = "int8" if quant else "bf16"
        what = (f"K3 kv_write {lane}L={L} G={G} T={T} start={start}"
                f"{f' (clamped to {s0})' if s0 != start else ''} {kind}"
                f"{f', {rows}' if rows else ''}")
        if err != 0 or not self.same_bytes(mine, ref) or not untouched:
            fail(f"{what}: max err {err}, rows outside [start, start+T) "
                 f"untouched: {untouched}")
        one_127 = (torch.ones((), device=dev)
                   / torch.full((), 127.0, device=dev))
        if rows and not bool((mine[2][..., s0] == one_127).all()):
            fail(f"{what}: an all-zero row's scale is not 1/127")
        ms = timer(lambda: write_block_cuda(*mine, kn, vn, st))
        plain = timer(lambda: write_block_plain(*mine, kn, vn, st), reps=5)
        lib = None
        if not quant:
            # library yardstick of the bf16 write (no quantization to do):
            # index_copy_ of the grouped rows into each plane
            idx = s0 + torch.arange(T, device=dev)
            kg, vg = group_blocks(kn), group_blocks(vn)

            def lib_copy():
                mine[0].index_copy_(3, idx, kg)
                mine[1].index_copy_(3, idx, vg)
            lib = timer(lib_copy, reps=5)
        nbytes = 2 * L * B * T * G * W * 2 + 2 * L * B * T * G * (
            W + 4 if quant else 2 * W)
        b_ms, b_by = bound(nbytes, 0.0)
        log(f"{what}: max_abs_err {err:.3e} (tol 0, byte-exact over the "
            f"whole planes, other rows untouched) ms {ms:.4f} plain_ms "
            f"{plain:.4f} library_ms "
            f"{'null' if lib is None else f'{lib:.4f} (index_copy_ of the grouped rows)'}"
            f" bound_ms {b_ms:.4f} ({b_by}; "
            f"{self.judge(ms, b_ms, nbytes)}) [{card}]")
        return err, ms, plain, b_ms, b_by

    def k3(self) -> dict:
        tree, level_rows = self.tree, self.level_rows
        # the bench lane's planes: the AR twin's row, the deferred commit's
        # accepted path, a prefill, the rollback path's 32-row provisional
        # tree block, the drafter's bf16 one-layer cache written at length +
        # block_offset; then T that is no multiple of a round's rows (7,
        # 33), the last rows (start = S - T), a start past S - T (clamped),
        # and rows of zeros and of exact rounding ties
        S = 2560
        off = 1237 + int(tree.levels[-1].block_offset)
        k3_rep, k3_err = None, 0.0
        k3_cases = [(32, 1, 1301, True, ""), (32, 5, 777, True, ""),
                    (32, 19, 0, True, ""), (32, tree.num_nodes, 1301, True, ""),
                    (1, tree.path_len, 1237, False, ""),
                    (1, level_rows[-1], off, False, ""),
                    (32, level_rows[-1], off, True, ""),
                    (32, 7, 1301, True, ""), (32, 33, 1301, True, ""),
                    (32, 5, S - 5, True, ""), (32, 7, S - 3, True, ""),
                    (32, 5, 777, True, "zero rows and ties")]
        for L, T, start, quant, rows in k3_cases:
            err, ms, plain, b_ms, b_by = self.k3_case(L, T, start, quant,
                                                      rows, S, self.G)
            k3_err = max(k3_err, err)
            if (L, T, start) == (32, 5, 777) and k3_rep is None:
                k3_rep = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                              bound_by=b_by, shape=f"L=32 B=2 T={T} G=32 int8")
        return dict(k3_rep, max_abs_err=k3_err)

    def k3_xl(self) -> dict:
        """K3 at LlamaGen-XL's planes (L = 36, G = 10, S = 512): the caption
        prefill (120 rows, bf16 and int8), the AR row, the static path's
        deferred commit of a path (bf16), the dynamic path's 59-row
        provisional tree (int8), the drafter's bf16 one-layer cache (a
        level of 10 rows behind 30, the extension of a 6-row path)."""
        tree = self.tree_xl
        S, G, rep, k3_err = 512, 10, None, 0.0
        for L, T, start, quant, rows in [
                (36, 120, 0, False, ""), (36, 120, 0, True, ""),
                (36, 1, 375, False, ""), (36, tree.path_len, 300, False, ""),
                (36, 59, 300, True, ""), (36, 59, S - 59, True, ""),
                (36, 59, 300, True, "zero rows and ties"),
                (1, 10, 330, False, ""), (1, 6, 300, False, "")]:
            err, ms, plain, b_ms, b_by = self.k3_case(L, T, start, quant,
                                                      rows, S, G, "XL ")
            k3_err = max(k3_err, err)
            if (L, T, quant, rows) == (36, 59, True, "") and rep is None:
                rep = dict(ms=ms, plain_ms=plain, library_ms=None,
                           bound_ms=b_ms, bound_by=b_by,
                           shape="XL L=36 B=2 T=59 G=10 int8")
        return dict(rep, max_abs_err=k3_err)

    def k4(self, xl: bool = False) -> dict:
        from lantern_tpu_torch.kv import (gather_write_block_cuda,
                                          gather_write_block_plain,
                                          k4_staging)

        torch, timer, card, dev = self.torch, self.timer, self.card, self.dev
        B, W = self.B, self.W
        planes_of, clones, same_bytes = (self.planes_of, self.clones,
                                         self.same_bytes)
        if xl:
            # LlamaGen-XL's base planes (L = 36, G = 10, S = 512) and the
            # dynamic path's rollback: a 59-row provisional tree, paths of at
            # most depth + 2 = 6 nodes
            S, L, G, blk, A, lane = 512, 36, 10, 59, 6, "XL "
            deep = [0, 3, 14, 27, 41, 58]
            k4_cases = [
                ("a tree path", True, [300], [deep]),
                ("identity", True, [375], [list(range(A))]),
                ("pads past blk, start = S - blk", True, [S - blk],
                 [[0, 2, blk + 8, 99, -3, 5]]),
                ("A = 1", True, [300], [[3]]),
                ("a tree path", False, [300], [deep])]
        else:
            # the bench lane's planes, the tree's 32-row block and 5-row
            # paths; then one accepted row (A = 1) and every row of the
            # block moved (A = blk, a permutation without fixed points),
            # whose bf16 rows are more than a warp's registers stage (the
            # shared-memory path); byte-exact over the whole buffers
            tree = self.tree
            S, L, G, lane = 2560, 32, self.G, ""
            blk, A = tree.num_nodes, tree.path_len
            deep = [int(i) for i in tree.retrieve_indices[0]]    # a full path
            short = [max(int(i), 0) for i in tree.retrieve_indices[-1]]
            k4_cases = [
                ("identity", True, [1237], [list(range(A))]),
                ("a tree path", True, [777], [deep]),
                ("pads past blk, start = S - blk", True, [S - blk],
                 [[0, 2, blk + 8, 99, -3][:A]]),
                ("pads below their row, start = 0", True, [0], [[0, 3, 7, 1, 2][:A]]),
                ("R=4 slots", True, [S - blk, 0, 777, 1301],
                 [deep, short, [0, 3, 7, 1, 2][:A], [blk - 1, blk + 8, 0, 0, 0][:A]]),
                ("a tree path", False, [777], [deep]),
                ("R=4 slots", False, [S - blk, 0, 777, 1301],
                 [deep, short, [0, 3, 7, 1, 2][:A], [blk - 1, blk + 8, 0, 0, 0][:A]]),
                ("A = 1", True, [777], [[3]]),
                ("A = blk, every row moved", True, [1301],
                 [[(7 * j + 3) % blk for j in range(blk)]]),
                ("A = blk, every row moved", False, [1301],
                 [[(7 * j + 3) % blk for j in range(blk)]]),
            ]

        def k4_wrong(planes, rel, start, how):
            """Known-wrong forms of the rollback on one slot (host indices)."""
            src = [start + min(max(r, 0), blk - 1) for r in rel]
            for i, buf in enumerate(planes):
                if buf is None:
                    continue
                if how == "rows stored without staging":
                    for j, s_ in enumerate(src):
                        buf[:, :, :, start + j] = buf[:, :, :, s_].clone()
                else:   # scales taken from the unclamped index
                    use = src if i < 2 else [min(start + max(r, 0), S - 1)
                                             for r in rel]
                    idx = torch.tensor(use, device=dev)
                    dst = start + torch.arange(len(rel), device=dev)
                    buf.index_copy_(3, dst, buf.index_select(3, idx))

        k4_rep = None
        for what, quant, starts, rels in k4_cases:
            kind = "int8 + scales" if quant else "bf16"
            # R slots of two batch rows each: a start and a path per row
            # (each slot's repeated for its rows); one slot: the scalar
            # start and the [A] path every row shares
            R = len(starts)
            B = 2 * R
            mine = planes_of(L, S, quant, G, B)
            ref, before = clones(mine), clones(mine)
            st = torch.tensor(starts, dtype=torch.int32,
                              device=dev).repeat_interleave(2)
            rl = torch.tensor(rels, dtype=torch.int32,
                              device=dev).repeat_interleave(2, 0)
            if R == 1:
                st, rl = st[0], rl[0]
            gather_write_block_cuda(*mine, rl, st, blk)
            gather_write_block_plain(*ref, rl, st, blk)
            torch.cuda.synchronize()
            if not same_bytes(mine, ref):
                fail(f"K4 {what} {kind}: kernel and plain version differ")
            caught = {}
            if (what, quant) == ("a tree path", True):
                for how, rel, s0 in (
                        ("rows stored without staging", [0, 3, 7, 1, 2][:A], 0),
                        ("scales from the unclamped index",
                         [0, 2, blk + 8, 99, -3][:A], 300 if xl else 777)):
                    good, bad = clones(ref), clones(ref)
                    gather_write_block_plain(
                        *good, torch.tensor(rel, dtype=torch.int32, device=dev),
                        torch.tensor(s0, dtype=torch.int32, device=dev), blk)
                    k4_wrong(bad, rel, s0, how)
                    caught[how] = not same_bytes(good, bad)
                    if not caught[how]:
                        fail(f"K4: the byte comparison does not catch a wrong "
                             f"variant ({how})")
                    del good, bad
            if R > 1:
                # two slots' starts swapped: a wrong variant the byte
                # comparison must catch
                swapped = st.reshape(R, 2)[[1, 0] + list(range(2, R))]
                gather_write_block_plain(*before, rl, swapped.reshape(-1), blk)
                caught["two slots' starts swapped"] = not same_bytes(ref,
                                                                    before)
                if not caught["two slots' starts swapped"]:
                    fail(f"K4 {what} {kind}: the byte comparison does not "
                         f"catch two slots' starts swapped")
            del before
            n_rows = rl.shape[-1]
            row_bytes = W * mine[0].element_size()
            staging = k4_staging(n_rows, row_bytes)
            ms = timer(lambda: gather_write_block_cuda(*mine, rl, st, blk))
            plain = timer(lambda: gather_write_block_plain(*mine, rl, st, blk),
                          reps=5)
            # library yardstick: index_select + index_copy_ per plane, indices
            # ready (one slot's; the R=4 case times slot 0's indices on all)
            st0, rl0 = st.reshape(-1)[0], rl.reshape(-1, n_rows)[0]
            src = (st0 + torch.clamp(rl0, 0, blk - 1)).long()
            dst = (st0 + torch.arange(n_rows, device=dev)).long()

            def lib_call():
                for buf in mine:
                    if buf is not None:
                        buf.index_copy_(3, dst, buf.index_select(3, src))

            lib = timer(lib_call, reps=5)
            row = row_bytes + (4 if quant else 0)
            nbytes = (2 * 2 * L * B * G * n_rows * row + st.numel() * 4
                      + rl.numel() * 4)
            b_ms, b_by = bound(nbytes, 0.0)
            where = (f"registers, {staging} chunks a lane" if staging
                     else "shared memory")
            log(f"K4 kv_gather {lane}L={L} B={B} G={G} S={S} blk={blk} A={n_rows} R="
                f"{R} {kind}, {what} (staged in {where}): "
                f"max_abs_err 0 (byte-exact over the whole buffers) ms "
                f"{ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms "
                f"{b_ms:.5f} ({b_by}, {nbytes / 1e6:.2f} MB moved; "
                f"{self.judge(ms, b_ms, nbytes)}) [{card}]")
            if caught:
                log("  wrong variants caught: " + "; ".join(caught))
            if (what, quant) == ("a tree path", True):
                k4_rep = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                              bound_by=b_by, max_abs_err=0.0,
                              shape=f"{lane}L={L} B=2 G={G} S={S} blk={blk} "
                                    f"A={A} int8 + scales")
            del mine, ref
        return k4_rep


    def rows(self) -> dict:
        """K2, K3 and K4 with one length or start per batch row, at the
        batched paths' shapes: the XL batch (R = 8 slots, B = 16 rows, 36
        layers, 10 groups of two heads, S = 512, the 9-row chain_bush_8
        tree, int8 KV) and the ragged Lumina batch (3 slots, B = 6, 4 layers,
        32 groups, the 32-row Lumina tree).  K2 must catch every row taking
        row 0's length; K3 and K4 must be byte-exact, with a clamped start,
        and catch two slots' starts swapped.  Returns ``{kernel: record}``
        of the XL batch."""
        import torch.nn.functional as F

        from lantern_tpu_torch.kv import (_rows, gather_write_block_cuda,
                                          gather_write_block_plain,
                                          group_blocks, quantize_rows,
                                          write_block_cuda, write_block_plain)
        from lantern_tpu_torch.ops.tree_attention import (
            NEG_INF, tree_attention_cuda, tree_attention_plain)

        from lantern_tpu_torch import trees

        torch, timer, card, dev = self.torch, self.timer, self.card, self.dev
        randn, W = self.randn, self.W
        xl_tree = trees.get_tree("chain_bush_8")
        S_lum = -(-lane_dims(RAGGED_GRID)[1] // 128) * 128
        lanes = [  # (name, R, L, G, S, head_dim, tree)
            ("XL batch", BATCH_SLOTS, 36, 10, 512, 64, xl_tree),
            ("Lumina ragged batch", len(RAGGED_TEXTS), RAGGED_LAYERS, 32,
             S_lum, 128, self.tree)]
        recs = {}
        for name, R, L, G, S, hd, tree in lanes:
            B, T, nh = 2 * R, tree.num_nodes, G * W // hd
            # K2: a length per row, 0 and S - T among them
            lens = torch.linspace(0, S - T, B, device=dev).round().to(
                torch.int32)
            lens[1] = 3 * S // 4 + 1
            q, kn, vn = (randn(B, T, nh, hd) for _ in range(3))
            kc, ks = quantize_rows(randn(B, G, S, W))
            vc, vs = quantize_rows(randn(B, G, S, W))
            mask = torch.as_tensor(tree.attn_mask, device=dev)[None].expand(
                B, T, T).contiguous()
            bias = torch.zeros((B, S), device=dev)
            bias[1::2, :7] = NEG_INF               # left-padded uncond rows
            kw = dict(k_scale=ks, v_scale=vs)
            args = (q, kn, vn, kc, vc, lens, mask, bias, hd ** -0.5)
            got = tree_attention_cuda(*args, **kw)
            ref = tree_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            tol = 2e-2 * ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            what = (f"K2 tree_attention {name} pk={W // hd} B={B} T={T} "
                    f"G={G} S={S} int8 KV, a length per row "
                    f"({lens.min().item()}..{lens.max().item()})")
            if not (err <= tol and torch.isfinite(got.float()).all()):
                fail(f"{what}: max err {err} > tol {tol}")
            bad = tree_attention_plain(q, kn, vn, kc, vc, lens[0], mask, bias,
                                       hd ** -0.5, **kw)
            werr = (bad.float() - ref.float()).abs().max().item()
            if werr <= tol:
                fail(f"{what}: tol {tol} does not separate every row taking "
                     f"row 0's length (err {werr})")
            ms = timer(lambda: tree_attention_cuda(*args, **kw))
            plain = timer(lambda: tree_attention_plain(*args, **kw), reps=5)

            def heads(x):            # [B, G, n, 128] -> [B, nh, n, hd]
                return x.reshape(B, G, -1, W // hd, hd).transpose(
                    2, 3).reshape(B, nh, -1, hd)
            kq, kqs = quantize_rows(group_blocks(kn))
            vq, vqs = quantize_rows(group_blocks(vn))
            kd = heads(torch.cat([kc.float() * ks[..., None],
                                  kq.float() * kqs[..., None]], 2).bfloat16())
            vd = heads(torch.cat([vc.float() * vs[..., None],
                                  vq.float() * vqs[..., None]], 2).bfloat16())
            vis = ((torch.arange(S, device=dev)[None] < lens[:, None].long())
                   & (bias == 0))
            am = torch.cat([vis[:, None, None].expand(B, 1, T, S),
                            mask[:, None]], -1)
            qh = q.transpose(1, 2)
            lib = timer(lambda: F.scaled_dot_product_attention(
                qh, kd, vd, attn_mask=am, scale=hd ** -0.5))
            live = int(lens.long().sum())
            nbytes = (4 * B * T * G * W * 2 + 2 * G * live * (W + 4)
                      + B * T * T + live * 4 + B * 4)
            b_ms, b_by = bound(nbytes, 4.0 * G * T * (live + B * T) * W)
            log(f"{what}: max_abs_err {err:.3e} (tol {tol:.3e} = 2e-2 * "
                f"max|ref|; every row at row 0's length errs {werr:.3e}) ms "
                f"{ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} (SDPA "
                f"over the whole dequantized plane, masked per row) bound_ms "
                f"{b_ms:.4f} ({b_by}) [{card}]")
            rec2 = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                        bound_by=b_by, max_abs_err=err,
                        shape=f"{name}: B={B} T={T} G={G} S={S} pk="
                              f"{W // hd} int8 KV, a length per row")
            del q, kn, vn, kc, vc, ks, vs, kd, vd, am, got, ref, bad
            # K3 and K4: a start per slot (one clamped), int8 and bf16
            starts = torch.tensor([(37 * r + 120) % (S - 2 * T) for r in
                                   range(R)], dtype=torch.int32, device=dev)
            starts[-1] = S - 3                      # clamped to S - T / S - blk
            st = starts.repeat_interleave(2)
            swapped = starts[[1, 0] + list(range(2, R))].repeat_interleave(2)
            A = tree.path_len
            rels = torch.tensor(
                [[(5 * r + 3 * j) % T if j < 3 else (T + 4 if j == 3 else -2)
                  for j in range(A)] for r in range(R)],
                dtype=torch.int32, device=dev).repeat_interleave(2, 0)
            for quant in (True, False):
                kind = "int8 + scales" if quant else "bf16"
                kn3, vn3 = randn(L, B, T, G, W), randn(L, B, T, G, W)
                mine = self.planes_of(L, S, quant, G, B)
                ref, wrong = self.clones(mine), self.clones(mine)
                write_block_cuda(*mine, kn3, vn3, st)
                write_block_plain(*ref, kn3, vn3, st)
                write_block_plain(*wrong, kn3, vn3, swapped)
                torch.cuda.synchronize()
                w3 = (f"K3 kv_write {name} L={L} B={B} G={G} S={S} T={T} "
                      f"{kind}, a start per slot (the last clamped)")
                if not self.same_bytes(mine, ref):
                    fail(f"{w3}: kernel and plain version differ")
                if self.same_bytes(ref, wrong):
                    fail(f"{w3}: two slots' starts swapped not caught")
                ms3 = timer(lambda: write_block_cuda(*mine, kn3, vn3, st))
                plain3 = timer(lambda: write_block_plain(*mine, kn3, vn3, st),
                               reps=5)
                lib3 = None
                if not quant:
                    s0 = torch.clamp(st.long(), 0, S - T)
                    at = (torch.arange(B, device=dev)[:, None],
                          s0[:, None] + torch.arange(T, device=dev))
                    kg3, vg3 = group_blocks(kn3), group_blocks(vn3)

                    def lib_put():
                        _rows(mine[0])[at] = _rows(kg3)
                        _rows(mine[1])[at] = _rows(vg3)
                    lib3 = timer(lib_put, reps=5)
                nb3 = 2 * L * B * T * G * W * 2 + 2 * L * B * T * G * (
                    W + 4 if quant else 2 * W) + B * 4
                b3, by3 = bound(nb3, 0.0)
                log(f"{w3}: max_abs_err 0 (byte-exact; two slots' starts "
                    f"swapped caught) ms {ms3:.4f} plain_ms {plain3:.4f} "
                    f"library_ms {'null' if lib3 is None else f'{lib3:.4f}'}"
                    f"{'' if quant else ' (index_put_ of the grouped rows)'} "
                    f"bound_ms {b3:.4f} ({by3}; {self.judge(ms3, b3, nb3)}) "
                    f"[{card}]")
                # K4 on the same planes: the path of each slot at its start
                ref4, wrong4 = self.clones(mine), self.clones(mine)
                gather_write_block_cuda(*mine, rels, st, T)
                gather_write_block_plain(*ref4, rels, st, T)
                gather_write_block_plain(*wrong4, rels, swapped, T)
                torch.cuda.synchronize()
                w4 = (f"K4 kv_gather {name} L={L} B={B} G={G} S={S} blk={T} "
                      f"A={A} {kind}, a start and a path per slot (the last "
                      f"start clamped, pads outside the block)")
                if not self.same_bytes(mine, ref4):
                    fail(f"{w4}: kernel and plain version differ")
                if self.same_bytes(ref4, wrong4):
                    fail(f"{w4}: two slots' starts swapped not caught")
                ms4 = timer(lambda: gather_write_block_cuda(*mine, rels, st,
                                                            T))
                plain4 = timer(lambda: gather_write_block_plain(
                    *mine, rels, st, T), reps=5)
                s0 = torch.clamp(st.long(), 0, S - T)[:, None]
                bi = torch.arange(B, device=dev)[:, None]
                src = (bi, s0 + torch.clamp(rels.long(), 0, T - 1))
                dst = (bi, s0 + torch.arange(A, device=dev))

                def lib_gather():
                    for buf in mine:
                        if buf is not None:
                            v = _rows(buf)
                            v[dst] = v[src]
                lib4 = timer(lib_gather, reps=5)
                row = W * mine[0].element_size() + (4 if quant else 0)
                nb4 = 2 * 2 * L * B * G * A * row + B * 4 + B * A * 4
                b4, by4 = bound(nb4, 0.0)
                log(f"{w4}: max_abs_err 0 (byte-exact; two slots' starts "
                    f"swapped caught) ms {ms4:.4f} plain_ms {plain4:.4f} "
                    f"library_ms {lib4:.4f} (index_put_ of index-gathered "
                    f"rows) bound_ms {b4:.5f} ({by4}; "
                    f"{self.judge(ms4, b4, nb4)}) [{card}]")
                if quant and name == "XL batch":
                    recs = {"tree_attention": rec2, "kv_write": dict(
                        ms=ms3, plain_ms=plain3, library_ms=lib3,
                        bound_ms=b3, bound_by=by3, max_abs_err=0.0,
                        shape=f"{name}: L={L} B={B} T={T} G={G} int8, a "
                              f"start per slot"), "kv_gather": dict(
                        ms=ms4, plain_ms=plain4, library_ms=lib4,
                        bound_ms=b4, bound_by=by4, max_abs_err=0.0,
                        shape=f"{name}: L={L} B={B} G={G} blk={T} A={A} "
                              f"int8 + scales, a start per slot")}
                del mine, ref, wrong, ref4, wrong4
        return recs


def phase_kernels(torch, timer, card: str, grid: int):
    """Each kernel against its plain version at the shapes of both lanes'
    main paths.  Returns ``{lane: {kernel: record}}``."""
    from lantern_tpu_torch.ops import _cuda

    phase = KernelPhase(torch, timer, card)
    k1_xl, k1_batch = phase.k1_xl()
    records = {
        "lumina": {
            "int8_matmul": phase.k1(), "tree_attention": phase.k2(grid),
            "kv_write": phase.k3(), "kv_gather": phase.k4()},
        "xl": {
            "int8_matmul": k1_xl, "tree_attention": phase.k2_xl(),
            "kv_write": phase.k3_xl(), "kv_gather": phase.k4(xl=True)},
        "batched": dict(phase.rows(), int8_matmul=k1_batch)}
    _cuda.reset_launches()
    return records


def phase_sweep_splits(torch, timer, card: str) -> None:
    """Times K2 and K1 at split counts other than the ones ``k2_splits`` and
    ``k1_splits`` choose (marked ``*``), at the decode lanes' shapes (K2 also
    at LlamaGen-XL's two heads a group), to hold those rules against a
    card."""
    from lantern_tpu_torch.kv import quantize_rows
    from lantern_tpu_torch.ops import _cuda, quant, tree_attention as tta

    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = _cuda.sm_count(torch.device("cuda", 0))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    def line(what, chosen, counts, run):
        times = [f"{n}{'*' if n == chosen else ''}: {timer(lambda: run(n)):.4f}"
                 for n in counts]
        log(f"{what}, ms by splits (* = the rule's): " + "; ".join(times)
            + f" [{card}]")

    B, W = KernelPhase.B, KernelPhase.W
    # (S, T, length, int8 KV, groups, heads a group): the Lumina lane, then
    # LlamaGen-XL's 10 groups of two heads of 64
    for S, T, length, quantized, G, pk in [
            (2560, 1, 2371, True, 32, 1), (2560, 32, 1237, True, 32, 1),
            (2560, 5, 1237, False, 32, 1), (384, 1, 290, True, 32, 1),
            (384, 32, 155, True, 32, 1), (512, 1, 375, True, 10, 2),
            (512, 26, 300, False, 10, 2), (512, 59, 300, True, 10, 2),
            (512, 10, 299, False, 10, 2), (512, 120, 0, True, 10, 2)]:
        q, kn, vn = (randn(B, T, G * pk, W // pk) for _ in range(3))
        kc, vc = randn(B, G, S, W), randn(B, G, S, W)
        kw = {}
        if quantized:
            (kc, ks), (vc, vs) = quantize_rows(kc), quantize_rows(vc)
            kw = dict(k_scale=ks, v_scale=vs)
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device="cuda"))
        args = (q, kn, vn, kc, vc,
                torch.tensor(length, dtype=torch.int32, device="cuda"),
                mask[None].expand(B, T, T).contiguous(),
                torch.zeros((B, S), device="cuda"), (W // pk) ** -0.5)
        line(f"K2 S={S} T={T} length={length} G={G} pk={pk} "
             f"{'int8' if quantized else 'bf16'} KV",
             tta.k2_splits(B, G, S, T, sms, pk),
             [n for n in (1, 2, 3, 4, 5, 6, 7, 8, 12)
              if n <= S // tta.K2_TILE_KEYS],
             lambda n: tta.tree_attention_launch(*args, n, **kw))
    for name, (K, N) in [*K1_SHAPES.items(),
                         *((f"XL {n}", kn) for n, kn in K1_SHAPES_XL.items())]:
        q = torch.randint(-127, 128, (K, N), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((1, N), generator=gen, device="cuda") * 1e-3
        chosen = quant.k1_splits(K, N, sms)
        # the split count that fills the card when the k range does not cap it
        full = -(-quant.K1_BLOCKS_PER_SM * sms // -(-N // quant.K1_TILE_COLS))
        counts = sorted({1, max(1, chosen // 2), chosen, full, 2 * full})
        for M in (2, 64):
            x = randn(M, K)
            line(f"K1 {name} K={K} N={N} M={M}", chosen,
                 [n for n in counts if n <= K // quant.K1_STAGE_ROWS],
                 lambda n: quant.int8_matmul_launch(x, q, s, n))
    _cuda.reset_launches()


def on_device(params: dict, dev) -> dict:
    """A params dict (one level of nested dicts) moved to ``dev``."""
    return {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                else v.to(dev)) for k, v in params.items()}


def phase_forward(torch):
    """Tiny head_dim-128 Chameleon forward: kernels on the card vs the
    plain path on the CPU, bf16, int8 KV, a tree block after a prefix."""
    from lantern_tpu_torch import configs, trees
    from lantern_tpu_torch.kv import KVCache
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops.quant import quantize_params

    cfg = configs.tiny_config(vocab_size=512, hidden_size=256, num_layers=2,
                              num_heads=2, rope_kind="1d", cond_kind="none",
                              qk_norm=True, swin_norm=True, max_seq_len=256,
                              dtype="bfloat16")
    gen = torch.Generator().manual_seed(5)
    params = quantize_params(tfm.fuse_params(
        tfm.init_params(gen, cfg, device="cpu")))
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_lumina.json"))
    outs = {}
    for dev in ("cpu", "cuda"):
        p = on_device(params, dev)
        rope = tfm.make_rope_tables(cfg, dev)
        kv = KVCache.create(cfg, 2, quantized=True, device=dev)
        g2 = torch.Generator().manual_seed(9)
        ids = torch.randint(0, 512, (2, 19), generator=g2).to(dev)
        res = tfm.forward(p, cfg, tfm.token_embed(p, ids), kv,
                          torch.arange(19, device=dev), rope)
        tids = torch.randint(0, 512, (2, tree.num_nodes), generator=g2).to(dev)
        pos = 19 + torch.as_tensor(tree.depth, device=dev).long()
        res2 = tfm.forward(p, cfg, tfm.token_embed(p, tids), res.kv, pos, rope,
                           block_mask=torch.as_tensor(tree.attn_mask, device=dev),
                           commit=False, defer_block=True)
        outs[dev] = tfm.logits_head(p, res2.hidden).cpu()
    err = (outs["cpu"] - outs["cuda"]).abs().max().item()
    tol = 5e-2 * outs["cpu"].abs().max().item()
    if not (err <= tol and torch.isfinite(outs["cuda"]).all()):
        fail(f"forward: card vs CPU logits max err {err} > tol {tol}")
    log(f"forward: tiny bf16 int8-KV tree forward, card kernels vs CPU plain: "
        f"logits max_abs_err {err:.3e} (tol {tol:.3e})")

    # the drafter: extend over a prompt, then two tree levels written at
    # their block offsets, the second seeing the first through the window
    from lantern_tpu_torch.models import drafter as drf

    dcfg = configs.drafter_config(cfg)
    dparams = drf.init_drafter_params(gen, dcfg, params["embed"])
    dparams["layers"] = {k: (v * 3 if k.startswith("w") else v)
                         for k, v in dparams["layers"].items()}
    dparams = quantize_params(tfm.fuse_params(dparams))
    lv0, lv1 = tree.levels[0], tree.levels[1]
    outs = {}
    for dev in ("cpu", "cuda"):
        p = on_device(dparams, dev)
        head = (params["lm_head_q"].to(dev), params["lm_head_s"].to(dev))
        rope = tfm.make_rope_tables(dcfg.model, dev)
        kv = KVCache.create(dcfg.model, 2, device=dev)
        g2 = torch.Generator().manual_seed(11)
        ids = torch.randint(0, 512, (2, 19), generator=g2).to(dev)
        hid = torch.randn((2, 19, 256), generator=g2).bfloat16().to(dev)
        hidden, kv = drf.extend(p, dcfg, rope, kv, ids, hid, 19)
        got = [hidden]
        parent = hidden[:, -1:]
        for lv in (lv0, lv1):
            n, off = len(lv.child_flat_idx), int(lv.block_offset)
            m = torch.as_tensor(lv.attn_mask, device=dev)
            tok = torch.randint(0, 512, (2, n), generator=g2).to(dev)
            x = drf.fuse_inputs(p, tok, parent.index_select(
                1, torch.as_tensor(lv.parent_row, device=dev).long()))
            res = tfm.forward(p, dcfg.model, x, kv, kv.length.expand(n), rope,
                              block_mask=m[:, off:].contiguous(),
                              window_mask=m[:, :off].contiguous() if off
                              else None, commit=False, write_offset=off)
            kv, parent = res.kv, res.hidden
            got += [res.hidden, drf._head_logits(head, res.hidden, 3.0)]
        outs[dev] = [t.float().cpu() for t in got]
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        err = (a - b).abs().max().item()
        tol = 5e-2 * a.abs().max().item()
        if not (err <= tol and torch.isfinite(b).all()):
            fail(f"forward (drafter) output {i}: card vs CPU max err {err} > "
                 f"tol {tol}")
        log(f"forward: tiny bf16 drafter (extend, level 0, level 1 with a "
            f"{int(lv1.block_offset)}-row window) output {i}: card kernels vs "
            f"CPU plain max_abs_err {err:.3e} (tol {tol:.3e})")


def phase_forward_llamagen(torch):
    """Tiny LlamaGen forward (head_dim 64: two heads a 128-lane group, 2-D
    rope, a left-padded caption prefix): kernels on the card vs the plain
    path on the CPU, bf16, int8 KV, the XL tree after the prefix, then the
    drafter's prefill over the base prefill's hidden states (the pad rows'
    too: the drafter takes no mask) and a dynamic draft level (10 rows
    behind a 20-row window)."""
    from lantern_tpu_torch import configs, trees
    from lantern_tpu_torch.kv import KVCache
    from lantern_tpu_torch.models import drafter as drf
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops.quant import quantize_params

    cfg = configs.tiny_config(vocab_size=512, hidden_size=256, num_layers=2,
                              num_heads=4, cond_kind="caption", block_size=16,
                              max_seq_len=64, dtype="bfloat16")
    dcfg = configs.drafter_config(cfg)
    gen = torch.Generator().manual_seed(6)
    params = quantize_params(tfm.fuse_params(
        tfm.init_params(gen, cfg, device="cpu")))
    dparams = drf.init_drafter_params(gen, dcfg, params["embed"])
    dparams = quantize_params(tfm.fuse_params(dparams))
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_XL.json"))
    Tc = cfg.cls_token_num
    g2 = torch.Generator().manual_seed(12)
    cond = torch.randn((1, Tc, cfg.caption_dim), generator=g2)
    cond[:, :3] = 0
    pv = torch.ones((2, 128), dtype=torch.bool)
    pv[0, :3] = False
    tids = torch.randint(0, 512, (2, tree.num_nodes), generator=g2)
    ids = torch.randint(0, 512, (2, 10), generator=g2)
    wm = torch.rand((10, 20), generator=g2) < 0.5
    outs = {}
    for dev in ("cpu", "cuda"):
        p = on_device(params, dev)
        dp = on_device(dparams, dev)
        rope = tfm.make_rope_tables(cfg, dev)
        kv = KVCache.create(cfg, 2, quantized=True, device=dev)
        emb = tfm.cond_embed(p, cfg, torch.cat(
            [cond, p["cond"]["uncond"][None].float().cpu()]).to(dev))
        block = (torch.tril(torch.ones((Tc, Tc), dtype=torch.bool))[None]
                 & pv[:, None, :Tc]).to(dev)
        res = tfm.forward(p, cfg, emb, kv, torch.arange(Tc, device=dev), rope,
                          block_mask=block)
        pos = Tc + torch.as_tensor(tree.depth, device=dev).long()
        res2 = tfm.forward(p, cfg, tfm.token_embed(p, tids.to(dev)), res.kv,
                           pos, rope, block_mask=torch.as_tensor(
                               tree.attn_mask, device=dev),
                           prefix_valid=pv.to(dev), commit=False)
        got = [tfm.logits_head(p, res.hidden[:, -1:]),
               tfm.logits_head(p, res2.hidden)]
        # the drafter: its prefill over this device's base hidden states,
        # as spec.prefill_request runs it, then a level of 10 rows behind a
        # 20-row window of earlier provisional rows
        drope = tfm.make_rope_tables(dcfg.model, dev)
        hidden, dk = drf.extend(dp, dcfg, drope,
                                KVCache.create(dcfg.model, 2, device=dev),
                                torch.zeros((2, Tc), dtype=torch.int32,
                                            device=dev), res.hidden, Tc)
        x = drf.fuse_inputs(dp, ids.to(dev), hidden[:, -1:].expand(2, 10, -1))
        lvl = tfm.forward(dp, dcfg.model, x, dk, dk.length.expand(10), drope,
                          block_mask=torch.eye(10, dtype=torch.bool,
                                               device=dev),
                          window_mask=wm.to(dev), commit=False,
                          write_offset=20)
        got += [res.hidden, hidden,
                drf._head_logits((p["lm_head_q"], p["lm_head_s"]),
                                 lvl.hidden, 3.0)]
        outs[dev] = [t.float().cpu() for t in got]
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        err = (a - b).abs().max().item()
        tol = 5e-2 * a.abs().max().item()
        if not (err <= tol and torch.isfinite(b).all()):
            fail(f"forward (LlamaGen, pk=2) output {i}: card vs CPU max err "
                 f"{err} > tol {tol}")
        log(f"forward: tiny bf16 LlamaGen (head_dim 64, caption prefix with "
            f"pads, int8 KV; prefix / XL tree / prefill hiddens / drafter "
            f"prefill hiddens / drafter level) output {i}: "
            f"card kernels vs CPU plain max_abs_err {err:.3e} (tol {tol:.3e})")


def spec_launches(layers: int, prompt, steps: int, verify_rows: int,
                  path_rows: int, levels, deferred: bool, slots: int = 1,
                  stale: bool = False):
    """``(totals, per verify step)``: the kernel launches of one spec run
    with the EAGLE drafter, derived from its shapes: a prefill (base forward
    over the ``prompt`` rows, drafter ``extend`` over them, first draft) and
    ``steps`` verify steps (base forward over the ``verify_rows`` tree rows
    + lm_head; a rollback (K4) unless ``deferred``, whose forward instead
    commits the previous rows, one K3 either way; ``extend`` over the
    ``path_rows`` of a path; the next draft).  A draft is a root head, then
    per level of ``levels`` rows fc_w, a one-layer forward and the head.
    K1 takes at most ``K1_MAX_ROWS`` rows a launch; every forward here is
    CFG batch 2.  The batched engine (``slots`` > 1): ``prompt`` lists every
    request's prompt rows (one prefill each), a step's base forward and
    lm_head take the ``slots`` requests' rows together (one K2 a layer, one
    K3, one K4), and the drafter runs per slot (``slots`` times its
    single-request launches).  With ``stale`` drafting there are no
    drafter launches: no ``extend``, and a draft is read off the verify
    forward's logits."""
    from lantern_tpu_torch.ops.quant import K1_MAX_ROWS

    def k1(rows):
        return -(-2 * rows // K1_MAX_ROWS)

    def forward(T, n_layers):            # 4 matmuls a layer, K2 a layer, K3
        return {"int8_matmul": 4 * n_layers * k1(T),
                "tree_attention": n_layers, "kv_write": 1}

    def add(*parts, times=1):
        out = {"int8_matmul": 0, "tree_attention": 0, "kv_write": 0,
               "kv_gather": 0}
        for part in parts:
            for k, n in part.items():
                out[k] += times * n
        return out

    def extend(T):                       # fc_w + a one-layer forward
        return add() if stale else add({"int8_matmul": k1(T)},
                                       forward(T, 1))

    draft = add() if stale else add(
        {"int8_matmul": k1(1)},
        *[add({"int8_matmul": 2 * k1(n)}, forward(n, 1)) for n in levels])
    prefill = add(*[add(forward(p, layers), {"int8_matmul": k1(1)},
                        extend(p), draft)
                    for p in (prompt if isinstance(prompt, list)
                              else [prompt])])
    rows = slots * verify_rows
    step = add(forward(rows, layers),
               {"int8_matmul": k1(rows), "kv_gather": 0 if deferred else 1},
               add(extend(path_rows), draft, times=slots))
    return {k: prefill[k] + steps * step[k] for k in step}, step


def phase_main_path(torch, grid: int, card: str):
    import dataclasses

    from lantern_tpu_torch import configs, trees
    from lantern_tpu_torch.engine import ar, spec
    from lantern_tpu_torch.models import chameleon as cham
    from lantern_tpu_torch.models import drafter as drf
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.ops.acceptance import LanternSpec
    from lantern_tpu_torch.ops.quant import K1_MAX_ROWS, quantize_params
    from lantern_tpu_torch.ops.sampling import LogitsWarp
    from lantern_tpu_torch.ops.vq_distance import nearest_latents

    max_new, max_seq_len = lane_dims(grid)
    cfg = configs.chameleon_7b_config(max_seq_len=max_seq_len, swin_norm=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tfm.init_params(gen, cfg, device="cuda")
    params = quantize_params(tfm.fuse_params(params))
    cb = torch.randn((8192, 8), generator=gen, device="cuda")
    near = cham.shift_nearest_table(nearest_latents(cb, k=11), cfg.vocab_size)
    params["nearest_latents"] = torch.as_tensor(near, device="cuda")
    # the hidden-passthrough drafter (fc_w = [0; I], zeroed layer), fused
    # and int8-quantized like the base
    dcfg = configs.drafter_config(cfg, num_layers=1, total_tokens=59, depth=4,
                                  top_k=10)
    dparams = drf.init_drafter_params(
        torch.Generator(device="cuda").manual_seed(101), dcfg, params["embed"])
    H = cfg.hidden_size
    fc = torch.zeros((2 * H, H), dtype=cfg.torch_dtype, device="cuda")
    fc[H:] = torch.eye(H, dtype=cfg.torch_dtype, device="cuda")
    dparams["fc_w"] = fc
    dparams["layers"] = {k: v * 0 for k, v in dparams["layers"].items()}
    dparams = quantize_params(tfm.fuse_params(dparams))
    torch.cuda.synchronize()
    log(f"main path: Lumina-7B int8 params and the one-layer passthrough "
        f"drafter built on the card in {time.perf_counter() - t0:.1f} s "
        f"(L={cfg.num_layers} H={cfg.hidden_size} V={cfg.vocab_size})")

    warp = LogitsWarp(temperature=1.0, top_k=2000, top_p=1.0)
    tp = cham.lumina_token_prompt(TEXT, grid=(grid, grid))
    fsm = cham.LuminaGridFSM(w=grid, h=grid, image_start_idx=len(TEXT),
                             vocab_size=cfg.vocab_size)
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_lumina.json"))
    stale = spec.SpecDecodeConfig(
        warp=warp, cfg_scale=3.0, lantern=LanternSpec(k=10, delta=5.0),
        max_new=max_new, kv_quant=True, walk_batch_warp=True,
        stale_draft=True, deferred_commit=True)
    rollback = dataclasses.replace(stale, stale_draft=False,
                                   deferred_commit=False)

    def run_spec(ecfg, seed, max_steps=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return spec.generate(params, ecfg, cfg, tree, tp, g,
                             max_steps=max_steps, logits_fn=fsm,
                             dparams=dparams, dcfg=dcfg)

    def run_ar(seed, n):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return ar.generate_tokens(params, cfg, tp, n, 3.0, warp, g,
                                  logits_fn=fsm, kv_quant=True)

    run_spec(stale, 7, max_steps=3)       # warm-up (cuBLAS, allocator)
    run_spec(rollback, 7, max_steps=3)
    run_ar(7, 4)
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, dict(_cuda.LAUNCHES)

    torch.cuda.reset_peak_memory_stats()
    ar_res, t_ar, ar_launch = timed(lambda: run_ar(8, max_new))
    sres, t_spec, spec_launch = timed(lambda: run_spec(stale, 8))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    rres, t_roll, roll_launch = timed(lambda: run_spec(rollback, 8))
    peak_roll = torch.cuda.max_memory_allocated() / 2 ** 30

    def legal(toks):
        toks = [int(t) for t in toks]
        for i, t in enumerate(toks[:-1]):
            if i % (grid + 1) == grid:
                if t != cham.LUMINA_NEWLINE_ID:
                    return f"position {i}: {t} is not the newline token"
            elif not cham.IMAGE_TOKEN_START <= t <= cham.IMAGE_TOKEN_END:
                return f"position {i}: {t} is not an image token"
        if toks[-1] != cham.IMAGE_END_ID:
            return f"last token {toks[-1]} is not end-of-image"
        return None

    if (sres.n_valid != max_new or rres.n_valid != max_new
            or ar_res.tokens.shape[0] != max_new):
        fail(f"spec committed {sres.n_valid}, rollback spec {rres.n_valid}, "
             f"AR {ar_res.tokens.shape[0]}, want {max_new}")
    for name, toks in (("spec", sres.tokens.tolist()),
                       ("rollback spec", rres.tokens.tolist()),
                       ("ar", ar_res.tokens.tolist())):
        why = legal(toks)
        if why:
            fail(f"{name} stream breaks the grid FSM: {why}")
    for name, res in (("spec", sres), ("rollback spec", rres)):
        if res.step_compression < 1.0:
            fail(f"{name}: step compression {res.step_compression} < 1")
    # deferred commit needs no rollback and the AR loop has no tree: K4
    # belongs to the rollback path alone
    for name, launch, path in (
            ("spec", spec_launch, ("int8_matmul", "tree_attention", "kv_write")),
            ("ar", ar_launch, ("int8_matmul", "tree_attention", "kv_write")),
            ("rollback spec", roll_launch, tuple(roll_launch))):
        missing = [k for k in path if launch[k] == 0]
        if missing:
            fail(f"{name} run launched no {missing} kernel: {launch}")
    want, per_step = spec_launches(
        cfg.num_layers, len(TEXT) + 3, rres.steps, tree.num_nodes,
        tree.path_len, [len(lv.child_flat_idx) for lv in tree.levels],
        deferred=False)
    if roll_launch != want:
        fail(f"rollback path launched {roll_launch}, but the tree's levels "
             f"give {want} for {rres.steps} verify steps")
    if roll_launch["kv_gather"] != rres.steps:
        fail(f"K4 ran {roll_launch['kv_gather']} times in {rres.steps} steps")
    sc = sres.step_compression
    log(f"main path [{card}] grid {grid}x{grid} ({max_new} tokens): "
        f"spec {max_new / t_spec:.2f} tok/s ({t_spec:.2f} s, "
        f"{sres.steps} verify steps, {sres.steps / t_spec:.2f} steps/s, "
        f"step compression {sc:.3f}); AR {max_new / t_ar:.2f} tok/s "
        f"({t_ar:.2f} s); spec/AR {t_ar / t_spec:.3f}; peak memory "
        f"{peak:.2f} GiB")
    log(f"rollback path [{card}] grid {grid}x{grid} ({max_new} tokens), "
        f"drafter + provisional write + rollback: {max_new / t_roll:.2f} "
        f"tok/s ({t_roll:.2f} s, {rres.steps} verify steps, "
        f"{rres.steps / t_roll:.2f} steps/s, step compression "
        f"{rres.step_compression:.3f}); rollback/AR {t_ar / t_roll:.3f}; "
        f"rollback/stale+deferred {t_spec / t_roll:.3f}; peak memory "
        f"{peak_roll:.2f} GiB")
    log(f"rollback path vs stale + deferred path, same seed: token streams "
        f"{'equal' if torch.equal(sres.tokens, rres.tokens) else 'differ'} "
        f"(informational: the passthrough drafter proposes what stale "
        f"drafting proposes)")
    log(f"main path launches: spec {spec_launch}; ar {ar_launch}")
    log(f"rollback path launches: {roll_launch} = the derived counts; per "
        f"verify step {per_step}")
    # the long-prompt path: 200 text tokens (203 prompt rows, one K2 launch
    # a layer at T = 203, K1 in launches of 64 rows), then 8 AR tokens
    long_tp = cham.lumina_token_prompt(LONG_TEXT, grid=(grid, grid))
    long_fsm = fsm._replace(image_start_idx=len(LONG_TEXT))
    rows = long_tp.tokens.shape[1]
    n_long = 8

    def run_long(n):
        g = torch.Generator(device="cuda").manual_seed(8)
        return ar.generate_tokens(params, cfg, long_tp, n, 3.0, warp, g,
                                  logits_fn=long_fsm, kv_quant=True)

    _, _, pre_launch = timed(lambda: run_long(0))
    lres, t_long, long_launch = timed(lambda: run_long(n_long))
    k1_pre = 4 * cfg.num_layers * -(-2 * rows // K1_MAX_ROWS) + 1
    want_pre = {"int8_matmul": k1_pre, "tree_attention": cfg.num_layers,
                "kv_write": 1, "kv_gather": 0}
    if pre_launch != want_pre:
        fail(f"long-prompt prefill ({rows} rows) launched {pre_launch}, want "
             f"{want_pre}")
    want_long = {"int8_matmul": k1_pre + n_long * (4 * cfg.num_layers + 1),
                 "tree_attention": (1 + n_long) * cfg.num_layers,
                 "kv_write": 1 + n_long, "kv_gather": 0}
    if long_launch != want_long:
        fail(f"long-prompt path launched {long_launch}, want {want_long}")
    toks = [int(t) for t in lres.tokens.tolist()]
    for i, t in enumerate(toks):
        if i % (grid + 1) == grid:
            ok = t == cham.LUMINA_NEWLINE_ID
        else:
            ok = cham.IMAGE_TOKEN_START <= t <= cham.IMAGE_TOKEN_END
        if not ok:
            fail(f"long-prompt stream breaks the grid FSM at position {i}: {t}")
    log(f"long-prompt path [{card}]: {rows} prompt rows through forward on "
        f"the card, then {n_long} AR tokens in {t_long:.2f} s, legal under "
        f"the FSM; prefill launches {pre_launch}; whole path {long_launch}")

    # a profile costs 6-12 s of the card's host: this path's and the XL
    # batched step's stay, the rollback, AR and XL paths' went for time
    # (PERF.md §6)
    profile("spec (stale + deferred), 6 verify steps",
            lambda: run_spec(stale, 9, max_steps=6), card)

    # end-to-end check of K4: pinned choices make both commit modes
    # deterministic, and both must commit the same bytes
    n_steps = 36
    pinned = dataclasses.replace(stale, pin=0.5)
    runs = {d: run_spec(dataclasses.replace(pinned, deferred_commit=d), 10,
                        max_steps=n_steps) for d in (False, True)}
    a, b = runs[False], runs[True]
    if not (torch.equal(a.tokens, b.tokens) and a.steps == b.steps == n_steps
            and a.accept_sum == b.accept_sum):
        fail(f"pinned rollback and deferred runs differ: steps {a.steps} / "
             f"{b.steps}, accepted {a.accept_sum} / {b.accept_sum}, first "
             f"difference at token "
             f"{int((a.tokens != b.tokens).int().argmax())}")
    log(f"rollback check [{card}]: pinned (pin=0.5) stale runs, "
        f"deferred_commit False vs True: {n_steps} steps, {a.accept_sum} "
        f"tokens, token-exact")
    # the real drafter against stale drafting, pinned: equal in exact
    # arithmetic; the int8 fc_w may move a hidden by a bf16 ulp
    c = run_spec(dataclasses.replace(pinned, stale_draft=False,
                                     deferred_commit=False), 10,
                 max_steps=n_steps)
    n = min(a.accept_sum, c.accept_sum)
    diff = (a.tokens[:n] != c.tokens[:n]).int()
    lead = int(diff.argmax()) if bool(diff.any()) else n
    log(f"rollback check [{card}]: pinned drafter run vs pinned stale run: "
        f"{lead} leading tokens of {n} match (informational)")
    return {"rollback": roll_launch, "stale_deferred": spec_launch,
            "ar": ar_launch, "long_prompt": long_launch}


def k2_gqa_case(torch, timer, card: str, T: int, G: int, pk: int, rep: int,
                S: int, length: int, mask, seed: int) -> dict:
    """K2 at grouped-query heads (``rep`` query heads a KV head, ``pk`` KV
    heads a 128-lane group), int8 KV, B = 2, against its plain version;
    the known-wrong head mapping (query head ``n`` reading KV head ``n %
    nkv``) must miss; times against the plain version, SDPA with
    ``enable_gqa`` over the dequantized K/V and, with one KV head a group,
    K2 over the KV plane repeated per query head (the MHA launch of the
    same work)."""
    import torch.nn.functional as F

    from lantern_tpu_torch.kv import (dequant_cache, group_blocks,
                                      quantize_rows, ungroup_cache)
    from lantern_tpu_torch.ops.tree_attention import (
        NEG_INF, tree_attention_cuda, tree_attention_plain)

    B, W, hd = 2, 128, 128 // pk
    nkv, nh = G * pk, G * pk * rep
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, kn, vn = randn(B, T, nh, hd), randn(B, T, nkv, hd), randn(B, T, nkv, hd)
    (kc, ks), (vc, vs) = quantize_rows(randn(B, G, S, W)), quantize_rows(
        randn(B, G, S, W))
    mask = mask.expand(B, T, T).contiguous()
    bias = torch.zeros((B, S), device="cuda")
    bias[1, :7] = NEG_INF
    ln = torch.tensor(length, dtype=torch.int32, device="cuda")
    args = (q, kn, vn, kc, vc, ln, mask, bias, hd ** -0.5)
    kw = dict(k_scale=ks, v_scale=vs)
    got = tree_attention_cuda(*args, **kw)
    ref = tree_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    tol = 2e-2 * ref.float().abs().max().item()
    what = (f"K2 tree_attention GQA {nh} heads of {hd} over {nkv} KV heads "
            f"(G={G} pk={pk} rep={rep}) S={S} T={T} length={length} int8 KV")
    if not (err <= tol and torch.isfinite(got.float()).all()):
        fail(f"{what}: max err {err} > tol {tol}")
    perm = torch.arange(nh, device="cuda").reshape(rep, nkv).T.reshape(-1)
    bad = tree_attention_plain(q[:, :, perm], *args[1:], **kw)
    bad = bad[:, :, torch.argsort(perm)]
    werr = (bad.float() - ref.float()).abs().max().item()
    if werr <= tol:
        fail(f"{what}: tol {tol} does not separate the known-wrong head "
             f"mapping (query head n reading KV head n % nkv: err {werr})")
    ms = timer(lambda: tree_attention_cuda(*args, **kw))
    plain = timer(lambda: tree_attention_plain(*args, **kw), reps=5)

    def heads(c, s):             # int8 [B, G, n, 128] -> bf16 [B, nkv, n, hd]
        return ungroup_cache(dequant_cache(c, s, torch.bfloat16), nkv,
                             hd).transpose(1, 2)
    kd = torch.cat([heads(kc[:, :, :length], ks[:, :, :length]),
                    heads(*quantize_rows(group_blocks(kn)))], 2)
    vd = torch.cat([heads(vc[:, :, :length], vs[:, :, :length]),
                    heads(*quantize_rows(group_blocks(vn)))], 2)
    am = torch.cat([(bias[:, None, None, :length] == 0).expand(
        B, 1, T, length), mask[:, None]], dim=-1)
    qh = q.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(
            qh, kd, vd, attn_mask=am, scale=hd ** -0.5, enable_gqa=True)
    lib_err = (sdpa().transpose(1, 2).float() - ref.float()).abs().max().item()
    lib = timer(sdpa)
    mha = ""
    if pk == 1:
        # the same function as MHA: the plane repeated for every query head
        kcr, vcr, ksr, vsr = (x.repeat_interleave(rep, dim=1).contiguous()
                              for x in (kc, vc, ks, vs))
        knr, vnr = (x.repeat_interleave(rep, dim=2) for x in (kn, vn))
        margs = (q, knr, vnr, kcr, vcr) + args[5:]
        mkw = dict(k_scale=ksr, v_scale=vsr)
        merr = (tree_attention_cuda(*margs, **mkw).float()
                - ref.float()).abs().max().item()
        mha_ms = timer(lambda: tree_attention_cuda(*margs, **mkw))
        mha = (f"; MHA launch over the plane repeated per query head "
               f"{mha_ms:.4f} ms (max err {merr:.3e}, "
               f"{mha_ms / ms:.2f}x the GQA launch)")
    nbytes = (2 * B * T * nh * hd * 2 + 2 * B * T * nkv * hd * 2
              + 2 * B * G * length * (W + 4) + B * T * T + B * length * 4)
    b_ms, b_by = bound(nbytes, 4.0 * B * nh * T * (length + T) * hd)
    log(f"{what}: max_abs_err {err:.3e} (tol {tol:.3e} = 2e-2 * max|ref|) "
        f"ms {ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} (SDPA "
        f"enable_gqa, max err {lib_err:.3e} against the plain version) bound_ms "
        f"{b_ms:.4f} ({b_by}){mha} [{card}]")
    log(f"  wrong variant's max err: query head n reading KV head n % nkv "
        f"{werr:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib,
                shape=f"B=2 T={T} {nh} heads of {hd} over {nkv} KV heads "
                      f"G={G} pk={pk} rep={rep} S={S} length={length} int8 KV")


def gqa_card_vs_cpu(torch, card: str) -> None:
    """(a) of the gqa phase: ``lumina_gqa8`` cut to ``GQA_CUT_LAYERS``
    layers through the kernels on the card and the plain path on the CPU,
    the same int8 weights: a 19-row prefill, the Lumina tree block under
    its ancestor mask, the one-layer drafter's ``extend`` and two tree
    levels (the second behind its window), ``GQA_GREEDY_STEPS`` greedy T =
    1 steps on the card, whose tokens the CPU's argmax must repeat over
    the same rows (one teacher-forced block), and one more T = 1 step.
    Logits within K2's ``2e-2 * max|ref|``."""
    from lantern_tpu_torch import configs, trees
    from lantern_tpu_torch.kv import KVCache
    from lantern_tpu_torch.models import drafter as drf
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops.quant import quantize_params

    cfg = lumina_cfg(16, GQA_KV_HEADS, GQA_CUT_LAYERS)
    dcfg = configs.drafter_config(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_params(tfm.fuse_params(
        tfm.init_params(gen, cfg, device="cuda")))
    dparams = quantize_params(tfm.fuse_params(drf.init_drafter_params(
        gen, dcfg, params["embed"])))
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_lumina.json"))
    g2 = torch.Generator().manual_seed(9)
    ids = torch.randint(4, 8196, (2, 19), generator=g2)
    tids = torch.randint(4, 8196, (2, tree.num_nodes), generator=g2)
    lv_ids = [torch.randint(4, 8196, (2, len(lv.child_flat_idx)),
                            generator=g2) for lv in tree.levels[:2]]
    n = GQA_GREEDY_STEPS
    outs, toks = {}, None
    for dev in ("cuda", "cpu"):
        p = params if dev == "cuda" else on_device(params, dev)
        dp = dparams if dev == "cuda" else on_device(dparams, dev)
        rope = tfm.make_rope_tables(cfg, dev)
        kv = KVCache.create(cfg, 2, quantized=True, device=dev)
        got = {}
        res = tfm.forward(p, cfg, tfm.token_embed(p, ids.to(dev)), kv,
                          torch.arange(19, device=dev), rope)
        got["prefill"] = tfm.logits_head(p, res.hidden[:, -1:])
        pos = 19 + torch.as_tensor(tree.depth, device=dev).long()
        rt = tfm.forward(p, cfg, tfm.token_embed(p, tids.to(dev)), res.kv,
                         pos, rope, block_mask=torch.as_tensor(
                             tree.attn_mask, device=dev), commit=False)
        got["tree block"] = tfm.logits_head(p, rt.hidden)
        # the drafter: extend over the prefill, then two tree levels
        head = (p["lm_head_q"], p["lm_head_s"])
        drope = tfm.make_rope_tables(dcfg.model, dev)
        dkv = KVCache.create(dcfg.model, 2, device=dev)
        hidden, dkv = drf.extend(dp, dcfg, drope, dkv, ids.to(dev),
                                 res.hidden, 19)
        parent = hidden[:, -1:]
        for i, lv in enumerate(tree.levels[:2]):
            off = int(lv.block_offset)
            m = torch.as_tensor(lv.attn_mask, device=dev)
            x = drf.fuse_inputs(dp, lv_ids[i].to(dev), parent.index_select(
                1, torch.as_tensor(lv.parent_row, device=dev).long()))
            r = tfm.forward(dp, dcfg.model, x, dkv, dkv.length.expand(
                x.shape[1]), drope, block_mask=m[:, off:].contiguous(),
                window_mask=m[:, :off].contiguous() if off else None,
                commit=False, write_offset=off)
            dkv, parent = r.kv, r.hidden
            got[f"drafter level {i} (window {off})"] = drf._head_logits(
                head, r.hidden, 3.0)
        kv = rt.kv
        if dev == "cuda":
            t = int(got["prefill"][0, -1].argmax())
            toks, steps = [t], []
            for i in range(n):
                r = tfm.forward(p, cfg, tfm.token_embed(p, torch.full(
                    (2, 1), t, device=dev)), kv, torch.tensor(
                    [19 + i], device=dev), rope)
                kv = r.kv
                steps.append(tfm.logits_head(p, r.hidden)[:, 0])
                t = int(steps[-1][0].argmax())
                toks.append(t)
            got["greedy steps"] = torch.stack(steps, 1)
        else:
            block = torch.tensor(toks[:n])[None].expand(2, n)
            r = tfm.forward(p, cfg, tfm.token_embed(p, block), kv,
                            torch.arange(19, 19 + n), rope)
            kv = r.kv
            got["greedy steps"] = tfm.logits_head(p, r.hidden)
        r = tfm.forward(p, cfg, tfm.token_embed(p, torch.full(
            (2, 1), toks[n], device=dev)), kv, torch.tensor([19 + n],
                                                            device=dev), rope)
        got["T=1 step"] = tfm.logits_head(p, r.hidden)
        outs[dev] = {k: v.float().cpu() for k, v in got.items()}
    for what, ref in outs["cpu"].items():
        cur = outs["cuda"][what]
        err = (cur - ref).abs().max().item()
        tol = 2e-2 * ref.abs().max().item()
        if not (err <= tol and torch.isfinite(cur).all()):
            fail(f"gqa (a) {what}: card vs CPU logits max err {err} > tol "
                 f"{tol}")
        log(f"gqa (a) lumina_gqa8 at {GQA_CUT_LAYERS} layers, {what}: card "
            f"kernels vs CPU plain logits max_abs_err {err:.3e} (tol "
            f"{tol:.3e} = 2e-2 * max|ref|)")
    ref = outs["cpu"]["greedy steps"][0]
    cpu_toks = [int(outs["cpu"]["prefill"][0, -1].argmax())] + [
        int(t) for t in ref.argmax(-1)]
    top2 = ref.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).min().item()
    if cpu_toks != toks:
        i = next(k for k, (a, b) in enumerate(zip(cpu_toks, toks)) if a != b)
        fail(f"gqa (a): greedy tokens differ at step {i}: card {toks}, CPU "
             f"{cpu_toks} (the CPU's least top-2 gap {gap:.3e})")
    log(f"gqa (a): {n} greedy T = 1 steps on the card, {len(toks)} tokens, "
        f"equal to the CPU's argmax over the same rows (least top-2 logit "
        f"gap on the CPU {gap:.3e})")


def phase_gqa(torch, card: str, timer):
    """Grouped-query attention: (a) ``gqa_card_vs_cpu``; (b) ``lumina_gqa8``
    (Lumina-7B, 32 query heads over 8 KV heads of 128, int8 weights and KV)
    at full width and depth on the 16x16 lane, pinned (``pin = 0.5``)
    stale + deferred spec and its AR twin, ``GQA_TOKENS`` tokens each, with
    the launch counts derived for the path, tok/s, C, steps and peak
    memory; (c) K2 GQA records at ``lumina_gqa8``'s shapes and at an
    XL-width ``pk = 2`` shape.  Returns ``(launches by path, records)``."""
    import dataclasses

    from lantern_tpu_torch.engine import ar, spec
    from lantern_tpu_torch.models import chameleon as cham
    from lantern_tpu_torch.ops import _cuda

    t = time.perf_counter()
    gqa_card_vs_cpu(torch, card)
    log(f"gqa (a): {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    cfg, params, tp, fsm, tree, ecfg, _ = lumina_lane(
        torch, 16, kv_heads=GQA_KV_HEADS)
    ecfg = dataclasses.replace(ecfg, max_new=GQA_TOKENS)
    log(f"gqa (b): lumina_gqa8 int8 params built on the card in "
        f"{time.perf_counter() - t:.1f} s (L={cfg.num_layers} "
        f"H={cfg.hidden_size} heads {cfg.num_heads} over "
        f"{cfg.num_kv_heads} KV heads)")

    def run_spec(n):
        return spec.generate(params, dataclasses.replace(ecfg, max_new=n),
                             cfg, tree, tp, torch.Generator(
                                 device="cuda").manual_seed(8), logits_fn=fsm)

    def run_ar(n):
        return ar.generate_tokens(params, cfg, tp, n, 3.0, ecfg.warp,
                                  torch.Generator(device="cuda").manual_seed(8),
                                  logits_fn=fsm, kv_quant=True)

    def counted(fn):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, dict(_cuda.LAUNCHES)

    run_spec(8)                                   # warm-up
    run_ar(4)
    torch.cuda.reset_peak_memory_stats()
    sres, t_spec, spec_launch = counted(lambda: run_spec(GQA_TOKENS))
    ares, t_ar, ar_launch = counted(lambda: run_ar(GQA_TOKENS))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prompt = len(TEXT) + 3
    want = {"gqa_stale_deferred": stale_launches(cfg, tree, sres.steps),
            "gqa_ar": ar_launches(cfg.num_layers, prompt, GQA_TOKENS, [1])}
    for path, got in (("gqa_stale_deferred", spec_launch),
                      ("gqa_ar", ar_launch)):
        if got != want[path]:
            fail(f"gqa (b) {path} launched {got}, the path gives "
                 f"{want[path]}")
    for name, toks in (("spec", sres.tokens[:GQA_TOKENS].tolist()),
                       ("AR", ares.tokens.tolist())):
        if len(toks) != GQA_TOKENS:
            fail(f"gqa (b) {name}: {len(toks)} tokens, want {GQA_TOKENS}")
        for i, tok in enumerate(toks):
            ok = (tok == cham.LUMINA_NEWLINE_ID if i % 17 == 16 else
                  cham.IMAGE_TOKEN_START <= tok <= cham.IMAGE_TOKEN_END)
            if not ok:
                fail(f"gqa (b) {name} stream breaks the grid FSM at {i}: "
                     f"{tok}")
    if sres.n_valid != GQA_TOKENS or sres.step_compression < 1.0:
        fail(f"gqa (b) spec: {sres.n_valid} tokens, C "
             f"{sres.step_compression}")
    log(f"gqa (b) lumina_gqa8 [{card}] 16x16 lane, {GQA_TOKENS} tokens: "
        f"pinned stale + deferred spec {GQA_TOKENS / t_spec:.2f} tok/s "
        f"({t_spec:.2f} s, {sres.steps} verify steps, step compression "
        f"{sres.step_compression:.3f}); AR {GQA_TOKENS / t_ar:.2f} tok/s "
        f"({t_ar:.2f} s); peak memory {peak:.2f} GiB")
    log(f"gqa (b) launches = the derived counts: spec {spec_launch}; AR "
        f"{ar_launch}")
    del params
    torch.cuda.empty_cache()
    # (c) K2 at grouped-query heads: lumina_gqa8's AR and tree blocks, and
    # 20 heads of 64 over 4 KV heads at XL width
    from lantern_tpu_torch import trees

    dev_mask = torch.as_tensor(tree.attn_mask, device="cuda")[None]
    xl_tree = trees.get_tree(os.path.join("ckpts", "bench_tree_XL.json"))
    one = torch.ones((1, 1, 1), dtype=torch.bool, device="cuda")
    records = [
        k2_gqa_case(torch, timer, card, 1, 8, 1, 4, 2560, 2371, one, 21),
        k2_gqa_case(torch, timer, card, tree.num_nodes, 8, 1, 4, 2560, 1237,
                    dev_mask, 22),
        k2_gqa_case(torch, timer, card, xl_tree.num_nodes, 2, 2, 5, 512, 300,
                    torch.as_tensor(xl_tree.attn_mask, device="cuda")[None],
                    23)]
    return {"gqa_stale_deferred": spec_launch, "gqa_ar": ar_launch}, records


def cut_depth(xl: dict, layers: int) -> dict:
    """The XL lane's model cut to its first ``layers`` layers (views of the
    same weights, the same drafter and captions): the depth cut of a path
    that the smoke's time limit forces."""
    p = xl["params"]
    return dict(xl, cfg=xl["cfg"].replace(num_layers=layers),
                params=dict(p, layers={k: v[:layers]
                                       for k, v in p["layers"].items()}))


def build_xl(torch) -> dict:
    """LlamaGen-XL t2i at full width and depth (36 layers x 1280, 20 heads
    of 64, vocab 16384, 120 caption rows) with random int8 W8A16 weights
    from seed 0, a LANTERN nearest table, and the one-layer
    hidden-passthrough drafter; ``caption(text)`` gives a left-padded
    ``RandomT5`` caption's ``(cond, uncond, prefix_valid)``."""
    from lantern_tpu_torch import configs
    from lantern_tpu_torch.models import drafter as drf
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops.quant import quantize_params
    from lantern_tpu_torch.ops.vq_distance import nearest_latents
    from lantern_tpu_torch.utils.t5 import RandomT5, flip_for_left_padding

    cfg = configs.llamagen_config("XL", "t2i", image_tokens=256)
    dcfg = configs.drafter_config(cfg, num_layers=1, total_tokens=59,
                                  depth=4, top_k=10)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_params(tfm.fuse_params(
        tfm.init_params(gen, cfg, device="cuda")))
    cb = torch.randn((cfg.vocab_size, 8), generator=gen, device="cuda")
    params["nearest_latents"] = torch.as_tensor(nearest_latents(cb, k=11),
                                                device="cuda")
    dparams = drf.init_drafter_params(
        torch.Generator(device="cuda").manual_seed(101), dcfg, params["embed"])
    H = cfg.hidden_size
    fc = torch.zeros((2 * H, H), dtype=cfg.torch_dtype, device="cuda")
    fc[H:] = torch.eye(H, dtype=cfg.torch_dtype, device="cuda")
    dparams["fc_w"] = fc
    dparams["layers"] = {k: v * 0 for k, v in dparams["layers"].items()}
    dparams = quantize_params(tfm.fuse_params(dparams))
    t5 = RandomT5(cfg.caption_dim, cfg.cls_token_num)
    uncond = params["cond"]["uncond"][None].float()

    def caption(text: str):
        emb, mask = flip_for_left_padding(*t5.get_text_embeddings([text]))
        cond = torch.as_tensor(emb, dtype=torch.float32, device="cuda")
        pv = torch.ones((2, cfg.cls_token_num), dtype=torch.bool,
                        device="cuda")
        pv[0] = torch.as_tensor(mask[0], device="cuda").bool()
        return cond, uncond, pv

    n_pads = int((~caption(XL_CAPTION)[2][0]).sum())
    torch.cuda.synchronize()
    log(f"XL: LlamaGen-XL t2i int8 params and the one-layer passthrough "
        f"drafter built on the card in {time.perf_counter() - t0:.1f} s "
        f"(L={cfg.num_layers} H={H} heads={cfg.num_heads}x{cfg.head_dim} "
        f"V={cfg.vocab_size} S={-(-cfg.max_seq_len // 128) * 128}); caption "
        f"{cfg.cls_token_num} rows, {n_pads} of them left pads")
    return dict(cfg=cfg, dcfg=dcfg, params=params, dparams=dparams,
                caption=caption)


def phase_xl(torch, card: str, xl: dict):
    """The LlamaGen-XL t2i lane at full width and depth (36 layers x 1280, 20
    heads of 64, vocab 16384, 120 caption rows): random int8 W8A16 weights
    from a seed, one left-padded ``RandomT5`` caption against the params'
    ``uncond`` features, LANTERN k=10 delta=5, top-2000, cfg 3.0, the
    hidden-passthrough drafter.  Three paths, each with the launch counters
    reset just before and read just after:
    - the AR twin (``ar.generate``), 256 tokens, bf16 KV;
    - static: the drafter proposes ``ckpts/bench_tree_XL.json``, deferred
      commit, bf16 KV (the JAX bench's XL configuration);
    - dynamic: EAGLE-2 with 59 tokens, depth 4, top-10, rollback commit (K4
      once a verify step), int8 KV.
    The launch counts must equal the ones derived from the tree or the
    budgets, and every token must lie in the vocab.  Then the static path
    with pinned choices (``pin=0.5``) must commit the same tokens in the same
    steps with rollback commit as with deferred commit."""
    import dataclasses

    from lantern_tpu_torch import trees
    from lantern_tpu_torch.engine import ar, spec
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.ops.acceptance import LanternSpec
    from lantern_tpu_torch.ops.quant import K1_MAX_ROWS
    from lantern_tpu_torch.ops.sampling import LogitsWarp

    n_img = 256
    cfg, dcfg, params, dparams = xl["cfg"], xl["dcfg"], xl["params"], xl["dparams"]
    cond, uncond, pv = xl["caption"](XL_CAPTION)

    warp = LogitsWarp(temperature=1.0, top_k=2000, top_p=1.0)
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_XL.json"))
    static = spec.SpecDecodeConfig(
        warp=warp, cfg_scale=3.0, lantern=LanternSpec(k=10, delta=5.0),
        max_new=n_img, walk_batch_warp=True, deferred_commit=True)
    dynamic = dataclasses.replace(static, mode="dynamic", kv_quant=True,
                                  deferred_commit=False)
    req = dict(cond=cond, uncond=uncond, prefix_valid=pv)

    def run_spec(ecfg, seed, max_steps=0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return spec.generate(params, ecfg, cfg, tree, None, g,
                             max_steps=max_steps, dparams=dparams, dcfg=dcfg,
                             **req)

    def run_ar(seed, n):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return ar.generate(params, cfg, cond, uncond, n, 3.0, warp, g,
                           prefix_valid=pv)

    run_spec(static, 7, max_steps=2)      # warm-up (cuBLAS, allocator)
    run_spec(dynamic, 7, max_steps=2)
    run_ar(7, 3)
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, dict(_cuda.LAUNCHES)

    torch.cuda.reset_peak_memory_stats()
    ar_res, t_ar, ar_launch = timed(lambda: run_ar(8, n_img))
    sres, t_st, st_launch = timed(lambda: run_spec(static, 8))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    dres, t_dyn, dyn_launch = timed(lambda: run_spec(dynamic, 8))
    peak_dyn = torch.cuda.max_memory_allocated() / 2 ** 30

    for name, toks, n in (("XL AR", ar_res.tokens, n_img),
                          ("XL static", sres.tokens, sres.n_valid),
                          ("XL dynamic", dres.tokens, dres.n_valid)):
        if n != n_img or toks.shape[0] != n_img:
            fail(f"{name} committed {n} of {toks.shape[0]} tokens, want "
                 f"{n_img}")
        if not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{name}: a token outside [0, {cfg.vocab_size})")
    for name, res in (("XL static", sres), ("XL dynamic", dres)):
        if res.step_compression < 1.0:
            fail(f"{name}: step compression {res.step_compression} < 1")
    Tc, L = cfg.cls_token_num, cfg.num_layers

    def k1(rows):
        return -(-2 * rows // K1_MAX_ROWS)
    want_ar = {"int8_matmul": 4 * L * k1(Tc) + 1 + n_img * (4 * L + 1),
               "tree_attention": (1 + n_img) * L, "kv_write": 1 + n_img,
               "kv_gather": 0}
    want_st, step_st = spec_launches(
        L, Tc, sres.steps, tree.num_nodes, tree.path_len,
        [len(lv.child_flat_idx) for lv in tree.levels], deferred=True)
    want_dyn, step_dyn = spec_launches(
        L, Tc, dres.steps, dcfg.total_tokens, dcfg.depth + 2,
        [dcfg.top_k] * dcfg.depth, deferred=False)
    for name, got, want in (("XL AR", ar_launch, want_ar),
                            ("XL static", st_launch, want_st),
                            ("XL dynamic", dyn_launch, want_dyn)):
        if got != want:
            fail(f"{name} launched {got}, but its shapes give {want}")
    if dyn_launch["kv_gather"] != dres.steps:
        fail(f"XL dynamic: K4 ran {dyn_launch['kv_gather']} times in "
             f"{dres.steps} steps")
    log(f"XL AR [{card}] {n_img} tokens, bf16 KV: {n_img / t_ar:.2f} tok/s "
        f"({t_ar:.2f} s); launches {ar_launch} = the derived counts")
    log(f"XL static [{card}] {n_img} tokens, drafter (passthrough) + the "
        f"calibrated {tree.num_nodes}-row tree + deferred commit, bf16 KV: "
        f"{n_img / t_st:.2f} tok/s ({t_st:.2f} s, {sres.steps} verify steps, "
        f"{sres.steps / t_st:.2f} steps/s, step compression "
        f"{sres.step_compression:.3f}); static/AR {t_ar / t_st:.3f}; peak "
        f"memory {peak:.2f} GiB; launches {st_launch} = the derived counts; "
        f"per verify step {step_st}")
    log(f"XL dynamic [{card}] {n_img} tokens, EAGLE-2 {dcfg.total_tokens}/"
        f"{dcfg.depth}/{dcfg.top_k} + rollback, int8 KV: {n_img / t_dyn:.2f} "
        f"tok/s ({t_dyn:.2f} s, {dres.steps} verify steps, "
        f"{dres.steps / t_dyn:.2f} steps/s, step compression "
        f"{dres.step_compression:.3f}); dynamic/AR {t_ar / t_dyn:.3f}; peak "
        f"memory {peak_dyn:.2f} GiB; launches {dyn_launch} = the derived "
        f"counts (K4 once a step); per verify step {step_dyn}")

    # end-to-end check of the XL paths at full depth: pinned choices make
    # the static path deterministic, and its rollback commit (K4 on the 36
    # bf16 planes) must commit what its deferred commit does, step by step
    n_steps = 24
    pinned = dataclasses.replace(static, pin=0.5)
    runs = {d: run_spec(dataclasses.replace(pinned, deferred_commit=d), 10,
                        max_steps=n_steps) for d in (False, True)}
    a, b = runs[False], runs[True]
    if not (torch.equal(a.tokens, b.tokens) and a.steps == b.steps == n_steps
            and a.accept_sum == b.accept_sum):
        fail(f"XL pinned rollback and deferred runs differ: steps {a.steps} / "
             f"{b.steps}, accepted {a.accept_sum} / {b.accept_sum}, first "
             f"difference at token "
             f"{int((a.tokens != b.tokens).int().argmax())}")
    log(f"XL rollback check [{card}]: pinned (pin=0.5) static drafter runs "
        f"over the calibrated tree, deferred_commit False vs True: {n_steps} "
        f"steps, {a.accept_sum} tokens, token-exact")
    return {"xl_ar": ar_launch, "xl_static": st_launch,
            "xl_dynamic": dyn_launch}


def phase_batched(torch, card: str, xl: dict):
    """The batched XL path: ``BatchedEngine`` + ``Scheduler`` on the native
    queue, the JAX bench's batched configuration (``bench.py:357-395``)
    without its policy: LlamaGen-XL at full width, cut to ``CUT_LAYERS``
    layers (time: ``cut_depth``), 8 slots, the
    9-row ``chain_bush_8`` tree, static mode, rollback commit, int8 KV, the
    passthrough drafter, LANTERN k=10 delta=5, top-2000, cfg 3.0,
    ``BATCH_TOKENS`` tokens; 12 requests with
    distinct captions (distinct pad counts) and seeds, so finished slots
    are refilled.  Fails unless every request ends without an error with
    ``BATCH_TOKENS`` tokens in the vocab, the run's launch counts
    equal the derived ones (one K2 a layer, one K3 and one K4 a step for all
    slots; the drafter per slot), the tokens and steps of every request
    that refills a slot (``BATCH_ALONE``) equal ``spec.generate`` alone
    with its seed (sampled), a pinned (``pin = 0.5``, 64 tokens) batched
    run of all 12 requests on the 8 slots equals their lone runs, and
    ``step_many`` synchronizes
    nothing.  Prints the aggregate and the single-request tokens/s and a
    profile of the batched step."""
    import dataclasses

    from lantern_tpu_torch import trees
    from lantern_tpu_torch.engine import spec
    from lantern_tpu_torch.engine.batch import BatchedEngine
    from lantern_tpu_torch.engine.scheduler import Request, Scheduler
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.ops.acceptance import LanternSpec
    from lantern_tpu_torch.ops.quant import K1_MAX_ROWS
    from lantern_tpu_torch.ops.sampling import LogitsWarp

    cfg, dcfg, params, dparams = (xl["cfg"], xl["dcfg"], xl["params"],
                                  xl["dparams"])
    R, n_img, L = BATCH_SLOTS, BATCH_TOKENS, cfg.num_layers
    tree = trees.get_tree("chain_bush_8")
    levels = [len(lv.child_flat_idx) for lv in tree.levels]
    ecfg = spec.SpecDecodeConfig(
        warp=LogitsWarp(temperature=1.0, top_k=2000, top_p=1.0),
        cfg_scale=3.0, lantern=LanternSpec(k=10, delta=5.0), max_new=n_img,
        kv_quant=True, walk_batch_warp=True)
    caps = [xl["caption"](c) for c in BATCH_CAPTIONS]
    pads = [int((~pv[0]).sum()) for _, _, pv in caps]
    if len(set(pads)) != len(pads):
        fail(f"batched XL: the captions' pad counts {pads} are not distinct")

    def requests(n):
        return [Request(uid=i, cond=c, uncond=u, prefix_valid=pv,
                        seed=1000 + i) for i, (c, u, pv) in
                enumerate(caps[:n])]

    def engine(e):
        eng = BatchedEngine(ecfg=e, cfg=cfg, tree=tree, params=params,
                            num_slots=R, dparams=dparams, dcfg=dcfg)
        eng.n_steps = 0
        step = eng.step

        def counted(batch):
            eng.n_steps += 1
            return step(batch)
        eng.step = counted
        return eng

    def alone(e, req):
        return spec.generate(params, e, cfg, tree, None,
                             spec.request_generator(req.seed), dparams=dparams,
                             dcfg=dcfg, cond=req.cond, uncond=req.uncond,
                             prefix_valid=req.prefix_valid)

    # warm-up (allocator, cuBLAS): two requests of 4 tokens
    Scheduler(engine(dataclasses.replace(ecfg, max_new=4))).run(requests(2))
    eng = engine(ecfg)
    reqs = requests(len(caps))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = Scheduler(eng).run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for r in done:
        if r.error is not None:
            fail(f"batched XL: request {r.uid} failed: {r.error}")
        if r.tokens is None or r.tokens.shape != (n_img,) or not (
                (r.tokens >= 0) & (r.tokens < cfg.vocab_size)).all():
            fail(f"batched XL: request {r.uid} returned "
                 f"{None if r.tokens is None else r.tokens.shape} tokens, "
                 f"want {n_img} in [0, {cfg.vocab_size})")
    want, per_step = spec_launches(
        L, [cfg.cls_token_num] * len(reqs), eng.n_steps, tree.num_nodes,
        tree.path_len, levels, deferred=False, slots=R)
    k1_base = -(-2 * R * tree.num_nodes // K1_MAX_ROWS)
    base = {"tree_attention": L, "kv_write": 1, "kv_gather": 1,
            "int8_matmul": (4 * L + 1) * k1_base}
    drafter_step = {k: per_step[k] - base[k] for k in base}
    if launches != want:
        fail(f"batched XL launched {launches}, but its shapes give {want}")
    steps = sum(r.steps for r in done)
    toks = len(done) * n_img
    log(f"batched XL [{card}] ({L} layers) {len(done)} requests x {n_img} "
        f"tokens on {R} "
        f"slots (native queue, slots refilled), chain_bush_8, rollback, int8 "
        f"KV: {eng.n_steps} batched steps in {wall:.2f} s, aggregate "
        f"{toks / wall:.2f} tok/s over the {R} slots; per request "
        f"{steps / len(done):.1f} verify steps, step compression "
        f"{sum(r.accept_sum for r in done) / max(steps, 1):.3f}; peak "
        f"memory {peak:.2f} "
        f"GiB; launches {launches} = the derived counts; a batched step: "
        f"base verify forward {base} (K1 {k1_base} launches a matmul over "
        f"{2 * R * tree.num_nodes} rows), drafter per slot, {R} slots "
        f"{drafter_step}")
    # the requests that refill a slot alone, one after the other: under
    # sampling too a request draws the same numbers batched as alone, so
    # its tokens and steps must match
    by_uid = {r.uid: r for r in done}
    lone = [r for r in requests(len(reqs)) if r.uid in BATCH_ALONE]
    t0 = time.perf_counter()
    singles = [alone(ecfg, r) for r in lone]
    torch.cuda.synchronize()
    t_alone = time.perf_counter() - t0
    for req, a in zip(lone, singles):
        r = by_uid[req.uid]
        if not (np_equal(r.tokens, a.tokens.cpu().numpy())
                and r.steps == a.steps):
            fail(f"batched XL request {r.uid}: batched {r.steps} steps, "
                 f"alone {a.steps}; tokens equal "
                 f"{np_equal(r.tokens, a.tokens.cpu().numpy())}")
    log(f"batched XL [{card}] the {len(singles)} requests that refill a "
        f"slot ({list(BATCH_ALONE)}) alone (spec.generate, same seeds): "
        f"{len(singles) * n_img / t_alone:.2f} tok/s ({t_alone:.2f} s, "
        f"{t_alone / len(singles):.2f} s a request, step compression "
        f"{sum(x.accept_sum for x in singles) / sum(x.steps for x in singles):.3f})"
        f"; batched/alone {toks / wall / (len(singles) * n_img / t_alone):.3f}; "
        f"every one's tokens and steps equal its batched run's")
    # pinned: batched equals alone, tokens and steps, for every request:
    # the 8 first fills and the 4 refills that enter while they run
    pinned = dataclasses.replace(ecfg, pin=0.5, max_new=64)
    t0 = time.perf_counter()
    done_p = Scheduler(engine(pinned)).run(requests(len(caps)))
    for r in done_p:
        a = alone(pinned, r)
        if r.error is not None or not (
                np_equal(r.tokens, a.tokens.cpu().numpy())
                and r.steps == a.steps):
            fail(f"batched XL pinned request {r.uid}: batched {r.steps} "
                 f"steps, alone {a.steps}; error {r.error}; tokens equal "
                 f"{r.error is None and np_equal(r.tokens, a.tokens.cpu().numpy())}")
    log(f"batched XL pinned check [{card}]: {len(done_p)} requests (pin=0.5, "
        f"64 tokens) batched on {R} slots (slots refilled) equal "
        f"spec.generate alone, tokens and steps ({[r.steps for r in done_p]} "
        f"steps; {time.perf_counter() - t0:.2f} s)")
    # a profile of the batched step with every slot busy
    pres = [eng.prefill(r.cond, r.uncond, spec.request_generator(r.seed),
                        prefix_valid=r.prefix_valid) for r in requests(R)]
    batch = eng.empty_batch(pres[0])
    for i, p in enumerate(pres):
        batch = eng.insert(batch, i, p)
    batch = eng.step(batch)
    profile(f"XL batched step, {R} busy slots, 4 steps (step_many)",
            lambda: eng.step_many(batch, 4), card)
    # step_many reads nothing back to the host: any synchronizing call
    # raises in this mode
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step_many(batch, 2)
    except RuntimeError as e:
        fail(f"batched XL: step_many synchronized with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("batched XL: step_many(2) ran under torch.cuda.set_sync_debug_mode("
        "'error'): no host synchronization between steps")
    return {"xl_batched": launches}


def np_equal(a, b) -> bool:
    import numpy as np

    return a.shape == b.shape and bool(np.array_equal(a, b))


def phase_ragged(torch, card: str):
    """A ragged Lumina batch: Lumina-7B width (hidden 4096, 32 heads of 128,
    vocab 65536) at 4 layers, random int8 weights from seed 0, int8 KV, the
    passthrough drafter over the calibrated Lumina tree, rollback commit,
    pinned LANTERN choices (``pin = 0.5``, k=10 delta=5, top-2000, cfg 3.0);
    3 token prompts of 16, 9 and 4 text tokens on 3 slots under one 8 x 8
    grid FSM whose static start is right for the first only (each slot
    binds its own).  K2 runs at pk = 1 with a length per row.  Fails unless
    every stream equals its lone ``spec.generate`` under its own FSM
    (tokens and steps), obeys the grammar, and the launch counts equal the
    derived ones."""
    import dataclasses

    from lantern_tpu_torch import configs, trees
    from lantern_tpu_torch.engine import spec
    from lantern_tpu_torch.engine.batch import BatchedEngine
    from lantern_tpu_torch.engine.scheduler import Request, Scheduler
    from lantern_tpu_torch.models import chameleon as cham
    from lantern_tpu_torch.models import drafter as drf
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.ops.acceptance import LanternSpec
    from lantern_tpu_torch.ops.quant import quantize_params
    from lantern_tpu_torch.ops.sampling import LogitsWarp
    from lantern_tpu_torch.ops.vq_distance import nearest_latents

    grid = RAGGED_GRID
    max_new, max_seq_len = lane_dims(grid)
    cfg = dataclasses.replace(configs.chameleon_7b_config(
        max_seq_len=max_seq_len, swin_norm=True), num_layers=RAGGED_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = quantize_params(tfm.fuse_params(
        tfm.init_params(gen, cfg, device="cuda")))
    cb = torch.randn((8192, 8), generator=gen, device="cuda")
    params["nearest_latents"] = torch.as_tensor(cham.shift_nearest_table(
        nearest_latents(cb, k=11), cfg.vocab_size), device="cuda")
    dcfg = configs.drafter_config(cfg, num_layers=1)
    dparams = drf.init_drafter_params(
        torch.Generator(device="cuda").manual_seed(101), dcfg, params["embed"])
    H = cfg.hidden_size
    fc = torch.zeros((2 * H, H), dtype=cfg.torch_dtype, device="cuda")
    fc[H:] = torch.eye(H, dtype=cfg.torch_dtype, device="cuda")
    dparams["fc_w"] = fc
    dparams["layers"] = {k: v * 0 for k, v in dparams["layers"].items()}
    dparams = quantize_params(tfm.fuse_params(dparams))
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_lumina.json"))
    ecfg = spec.SpecDecodeConfig(
        warp=LogitsWarp(temperature=1.0, top_k=2000, top_p=1.0),
        cfg_scale=3.0, lantern=LanternSpec(k=10, delta=5.0), max_new=max_new,
        kv_quant=True, walk_batch_warp=True, pin=0.5)

    def fsm(start):
        return cham.LuminaGridFSM(w=grid, h=grid, image_start_idx=start,
                                  vocab_size=cfg.vocab_size)

    prompts = [cham.lumina_token_prompt(t, grid=(grid, grid))
               for t in RAGGED_TEXTS]
    eng = BatchedEngine(ecfg=ecfg, cfg=cfg, tree=tree, params=params,
                        num_slots=len(prompts), dparams=dparams, dcfg=dcfg,
                        logits_fn=fsm(len(RAGGED_TEXTS[0])))
    eng.n_steps = 0
    step = eng.step

    def counted(batch):
        eng.n_steps += 1
        return step(batch)
    eng.step = counted
    reqs = [Request(uid=i, token_prompt=tp, seed=500 + i)
            for i, tp in enumerate(prompts)]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    done = Scheduler(eng).run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    want, _ = spec_launches(
        cfg.num_layers, [len(t) + 3 for t in RAGGED_TEXTS], eng.n_steps,
        tree.num_nodes, tree.path_len,
        [len(lv.child_flat_idx) for lv in tree.levels], deferred=False,
        slots=len(prompts))
    if launches != want:
        fail(f"ragged Lumina batch launched {launches}, but its shapes give "
             f"{want}")
    for r, text in zip(done, RAGGED_TEXTS):
        if r.error is not None:
            fail(f"ragged Lumina request {r.uid} failed: {r.error}")
        a = spec.generate(params, ecfg, cfg, tree, prompts[r.uid],
                          spec.request_generator(r.seed), logits_fn=fsm(
                              len(text)), dparams=dparams, dcfg=dcfg)
        if not (np_equal(r.tokens, a.tokens.cpu().numpy())
                and r.steps == a.steps):
            fail(f"ragged Lumina request {r.uid} ({len(text)} text tokens): "
                 f"batched {r.steps} steps, alone {a.steps}; tokens differ")
        body = r.tokens[:max_new - 1].reshape(grid, grid + 1)
        if not ((body[:, grid] == cham.LUMINA_NEWLINE_ID).all()
                and r.tokens[-1] == cham.IMAGE_END_ID):
            fail(f"ragged Lumina request {r.uid}: the grid grammar broke")
    log(f"ragged Lumina batch [{card}] Lumina-7B width at "
        f"{cfg.num_layers} layers, 3 slots, prompts of "
        f"{[len(t) + 3 for t in RAGGED_TEXTS]} rows, {grid}x{grid} grid "
        f"({max_new} tokens), pinned: {eng.n_steps} batched steps in "
        f"{wall:.2f} s; every stream equals its lone run under its own FSM "
        f"(steps {[r.steps for r in done]}) and keeps the grammar; launches "
        f"{launches} = the derived counts")
    return {"lumina_ragged": launches}


class StepCounter:
    """Counts ``BatchedEngine.step`` calls while active: the sessions build
    their engine inside ``generate_batch``."""

    def __enter__(self):
        from lantern_tpu_torch.engine.batch import BatchedEngine

        self.n, self.cls, self.orig = 0, BatchedEngine, BatchedEngine.step

        def counted(eng, batch):
            self.n += 1
            return self.orig(eng, batch)
        BatchedEngine.step = counted
        return self

    def __exit__(self, *exc):
        self.cls.step = self.orig


def ar_launches(layers: int, prompt_rows: int, n_tokens: int, chunks):
    """The kernel launches of lockstep AR (``ar.generate_many``): per chunk
    of ``r`` requests a prefill of ``r`` CFG pairs over ``prompt_rows`` rows
    and the head over their last rows, then ``n_tokens`` one-row forwards of
    the ``r`` pairs and their heads (one K2 a layer and one K3 a forward
    for all rows)."""
    from lantern_tpu_torch.ops.quant import K1_MAX_ROWS

    def k1(rows):
        return -(-2 * rows // K1_MAX_ROWS)

    out = {"int8_matmul": 0, "tree_attention": 0, "kv_write": 0,
           "kv_gather": 0}
    for r in chunks:
        out["int8_matmul"] += (4 * layers * k1(r * prompt_rows) + k1(r)
                               + n_tokens * (4 * layers * k1(r) + k1(r)))
        out["tree_attention"] += (1 + n_tokens) * layers
        out["kv_write"] += 1 + n_tokens
    return out


def random_tree_masks(torch, R: int, T: int, seed: int):
    """R random dynamic-tree ancestor-or-self masks of T nodes ([R, T, T]
    bool on the card; node i's parent drawn from the nodes before it)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(R):
        a = torch.eye(T, dtype=torch.bool)
        for i in range(1, T):
            a[i] |= a[int(torch.randint(0, i, (1,), generator=g))]
        out.append(a)
    return torch.stack(out).cuda()


def k2_row_masks(torch, timer, card: str) -> dict:
    """K2 at the batched dynamic verify's shape: 4 slots (B = 8 rows), T =
    59 (the XL dynamic tree), 10 groups of two heads of 64, S = 512, int8
    KV, a different random tree mask in each slot (repeated to its two
    rows) and a length per row, against its plain version; every row
    taking row 0's mask must fail the tolerance.  Times: median of 15 with
    a cold L2, the plain version, and SDPA over the same masks (the
    dequantized plane), which the port never calls."""
    import torch.nn.functional as F

    from lantern_tpu_torch.kv import group_blocks, quantize_rows
    from lantern_tpu_torch.ops.tree_attention import (
        NEG_INF, tree_attention_cuda, tree_attention_plain)

    R, T, G, S, W, hd = SESSION_SLOTS, 59, 10, 512, 128, 64
    B, nh = 2 * R, G * W // hd
    gen = torch.Generator(device="cuda").manual_seed(59)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    q, kn, vn = (randn(B, T, nh, hd) for _ in range(3))
    kc, ks = quantize_rows(randn(B, G, S, W))
    vc, vs = quantize_rows(randn(B, G, S, W))
    mask = random_tree_masks(torch, R, T, 59).repeat_interleave(2, dim=0)
    if any(torch.equal(mask[0], mask[2 * r]) for r in range(1, R)):
        fail("K2 per-row masks: two slots drew the same tree")
    lens = torch.tensor([300, 300, 0, 0, 211, 211, S - T, S - T],
                        dtype=torch.int32, device="cuda")
    bias = torch.zeros((B, S), device="cuda")
    bias[1::2, :7] = NEG_INF                       # left-padded uncond rows
    kw = dict(k_scale=ks, v_scale=vs)
    args = (q, kn, vn, kc, vc, lens, mask, bias, hd ** -0.5)
    got = tree_attention_cuda(*args, **kw)
    ref = tree_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = 2e-2 * ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    what = (f"K2 tree_attention batched dynamic verify pk=2 B={B} T={T} "
            f"G={G} S={S} int8 KV, a tree mask per slot and a length per "
            f"row")
    if not (err <= tol and torch.isfinite(got.float()).all()):
        fail(f"{what}: max err {err} > tol {tol}")
    bad = tree_attention_plain(q, kn, vn, kc, vc, lens,
                               mask[:1].expand(B, T, T).contiguous(), bias,
                               hd ** -0.5, **kw)
    werr = (bad.float() - ref.float()).abs().max().item()
    if werr <= tol:
        fail(f"{what}: tol {tol} does not separate every row taking row "
             f"0's mask (err {werr})")
    ms = timer(lambda: tree_attention_cuda(*args, **kw))
    plain = timer(lambda: tree_attention_plain(*args, **kw), reps=5)

    def heads(x):                # [B, G, n, 128] -> [B, nh, n, hd]
        return x.reshape(B, G, -1, W // hd, hd).transpose(2, 3).reshape(
            B, nh, -1, hd)
    kq, kqs = quantize_rows(group_blocks(kn))
    vq, vqs = quantize_rows(group_blocks(vn))
    kd = heads(torch.cat([kc.float() * ks[..., None],
                          kq.float() * kqs[..., None]], 2).bfloat16())
    vd = heads(torch.cat([vc.float() * vs[..., None],
                          vq.float() * vqs[..., None]], 2).bfloat16())
    vis = ((torch.arange(S, device="cuda")[None] < lens[:, None].long())
           & (bias == 0))
    am = torch.cat([vis[:, None, None].expand(B, 1, T, S), mask[:, None]], -1)
    qh = q.transpose(1, 2)
    lib = timer(lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=am, scale=hd ** -0.5))
    live = int(lens.long().sum())
    nbytes = (4 * B * T * G * W * 2 + 2 * G * live * (W + 4) + B * T * T
              + live * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4.0 * G * T * (live + B * T) * W)
    log(f"{what}: max_abs_err {err:.3e} (tol {tol:.3e} = 2e-2 * max|ref|; "
        f"every row at row 0's mask errs {werr:.3e}) ms {ms:.4f} plain_ms "
        f"{plain:.4f} library_ms {lib:.4f} (SDPA over the whole dequantized "
        f"plane, the same masks) bound_ms {b_ms:.4f} ({b_by}) [{card}]")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err,
                shape=f"batched dynamic verify: B={B} T={T} G={G} S={S} pk=2 "
                      f"int8 KV, a tree mask per slot")


def phase_session(torch, card: str, xl: dict, timer):
    """The session layer on the card, as users call it (prompt in, image
    out), and the batched modes it reaches:

    - the XL session: ``LlamaGenSession`` around the XL lane's int8 weights
      and passthrough drafter (full width, cut to ``CUT_LAYERS`` layers for
      time: ``cut_depth``) with a VQ-16 codec at
      its published width (codebook 16384x8, ch 128, ``ch_mult`` (1, 1, 2,
      2, 4), z 256; random weights from a seed): one caption through
      ``generate`` (static, ``ckpts/bench_tree_XL.json``, stale drafting,
      rollback commit) and ``decode_ids``: a [1, 256, 256, 3] uint8 image
      that is not constant, equal within one uint8 level to the same codes
      decoded on the CPU; derived launch counts;
    - K2 with a tree mask per slot at the batched dynamic verify's shape
      (``k2_row_masks``);
    - ``generate_batch`` over 6 captions on 4 slots, 32 tokens each, int8
      KV, top-2000 sampling: static (every request's tokens and steps equal
      its lone ``generate`` of seed ``seed + i``), dynamic (EAGLE-2 under
      the batch, pinned at 0.5: equal to the lone pinned runs) and
      lockstep AR (equal to the lone AR runs); no request may fail; derived
      launch counts (a dynamic batched step: one K2 a base layer, one K4);
    - the Lumina session: ``ChameleonSession`` at Lumina-7B width, 4 layers,
      int8 weights and KV, a ``hash_tokenize`` prompt, the 16x16 grid
      through ``generate`` (static, the calibrated Lumina tree) and
      ``decode_generated`` with the Chameleon VQGAN at its published config
      (codebook 8192x256, ch 128, attention at 32 px): a [256, 256, 3]
      uint8 image; the grammar holds; derived launch counts.

    Prints seconds per call, images/s, each codec's decode ms, aggregate
    tok/s of each batched mode against the same requests alone, and
    compression C.  Returns ``(launches by path, the K2 record)``."""
    import dataclasses

    import numpy as np

    from lantern_tpu_torch import configs, trees
    from lantern_tpu_torch.engine.session import (ChameleonSession,
                                                  LlamaGenSession)
    from lantern_tpu_torch.models import chameleon as cham
    from lantern_tpu_torch.models import drafter as drf
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.models import vqgan
    from lantern_tpu_torch.models.item_processor import hash_tokenize
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.ops.quant import quantize_params
    from lantern_tpu_torch.ops.vq_distance import nearest_latents

    cfg, dcfg = xl["cfg"], xl["dcfg"]
    L, Tc = cfg.num_layers, cfg.cls_token_num
    tree_path = os.path.join("ckpts", "bench_tree_XL.json")
    tree = trees.get_tree(tree_path)
    levels = [len(lv.child_flat_idx) for lv in tree.levels]
    vq_cfg = vqgan.vq16_config(codebook_size=cfg.vocab_size)
    vq = vqgan.init_vqgan_params(torch.Generator(device="cuda").manual_seed(2),
                                 vq_cfg, device="cuda")
    sess = LlamaGenSession(cfg, dcfg, xl["params"], xl["dparams"],
                           vq_cfg=vq_cfg, vq_params=vq,
                           passthrough_drafter=True, device="cuda")
    lant = dict(lantern_k=10, lantern_delta=5.0, cfg_scale=3.0, top_k=2000,
                temperature=1.0)
    launches = {}

    def run(name, fn):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = dict(_cuda.LAUNCHES)
        return out, time.perf_counter() - t

    def all_four(name):
        idle = [k for k, n in launches[name].items() if not n]
        if idle:
            fail(f"{name}: kernels {idle} were not launched on the path")

    # warm-up (allocator, cuBLAS, cuDNN's convolution algorithms)
    sess.generate(XL_CAPTION, max_new=8, mode="static", tree=tree_path,
                  seed=1, **lant)
    sess.decode_ids(np.arange(256) % cfg.vocab_size)

    (toks, st), t_gen = run("session_xl", lambda: sess.generate(
        XL_CAPTION, mode="static", tree=tree_path, seed=11, **lant))
    if toks.shape != (256,) or not ((toks >= 0)
                                    & (toks < cfg.vocab_size)).all():
        fail(f"XL session: {toks.shape} tokens, want 256 in the vocab")
    want, _ = spec_launches(L, Tc, st.steps, tree.num_nodes, tree.path_len,
                            levels, deferred=False, stale=True)
    if launches["session_xl"] != want:
        fail(f"XL session launched {launches['session_xl']}, but its shapes "
             f"give {want}")
    all_four("session_xl")
    torch.cuda.synchronize()
    t = time.perf_counter()
    img = sess.decode_ids(toks)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t
    if img.shape != (1, 256, 256, 3) or img.dtype != np.uint8:
        fail(f"XL session: decode_ids gave {img.shape} {img.dtype}, want "
             f"(1, 256, 256, 3) uint8")
    if img.min() == img.max():
        fail("XL session: the decoded image is constant")
    vq_cpu = tree_map(lambda x: x.cpu(), vq)
    t = time.perf_counter()
    ref = vqgan.to_uint8(vqgan.decode_code(vq_cpu, vq_cfg,
                                           torch.as_tensor(toks[None]), 16))
    t_cpu = time.perf_counter() - t
    diff = int(np.abs(img.astype(int) - ref.astype(int)).max())
    if diff > 1:
        fail(f"XL session: the card's image differs from the CPU decode of "
             f"the same codes by {diff} uint8 levels (want <= 1)")
    log(f"XL session [{card}] ({L} layers) LlamaGenSession.generate (static, "
        f"{tree.num_nodes}-row calibrated tree, stale drafting, rollback, "
        f"LANTERN k=10 delta=5, top-2000, cfg 3.0, int8 weights, bf16 KV): "
        f"256 tokens in {t_gen:.3f} s ({256 / t_gen:.2f} tok/s, "
        f"{st.steps} steps, compression C {st.step_compression:.3f}); "
        f"VQ-16 decode_ids (codebook {vq_cfg.codebook_size}x"
        f"{vq_cfg.codebook_dim}, ch {vq_cfg.ch}, z {vq_cfg.z_channels}) "
        f"{t_dec * 1e3:.2f} ms -> {img.shape} uint8, pixel std "
        f"{img.std():.2f}; the CPU decode of the same codes "
        f"({t_cpu:.2f} s) within {diff} uint8 level(s); "
        f"{1.0 / (t_gen + t_dec):.3f} images/s; launches "
        f"{launches['session_xl']} = the derived counts")

    rec = k2_row_masks(torch, timer, card)

    caps = BATCH_CAPTIONS[:SESSION_REQUESTS]
    n_tok = SESSION_TOKENS
    common = dict(max_new=n_tok, kv_quant=True, **lant)
    batch_runs = {}
    for mode, kw in (("static", dict(tree=tree_path)),
                     ("dynamic", dict(pin=0.5)), ("ar", {})):
        name = f"session_{mode}_batch"
        with StepCounter() as steps:
            done, t_b = run(name, lambda: sess.generate_batch(
                caps, slots=SESSION_SLOTS, mode=mode, seed=100, **common,
                **kw))
        batch_runs[mode, kw.get("tree")] = done
        for r in done:
            if r.error is not None:
                fail(f"{name}: request {r.uid} failed: {r.error}")
        t = time.perf_counter()
        singles = [sess.generate(c, mode=mode, seed=100 + i, **common, **kw)
                   for i, c in enumerate(caps)]
        torch.cuda.synchronize()
        t_alone = time.perf_counter() - t
        for r, (a_toks, a_st) in zip(done, singles):
            if not (np_equal(r.tokens, a_toks)
                    and (mode == "ar" or r.steps == a_st.steps)):
                fail(f"{name}: request {r.uid} batched ({r.steps} steps) "
                     f"differs from its lone run ({a_st.steps} steps); "
                     f"tokens equal {np_equal(r.tokens, a_toks)}")
        chunks = [min(SESSION_SLOTS, len(caps) - lo)
                  for lo in range(0, len(caps), SESSION_SLOTS)]
        if mode == "static":
            want, per = spec_launches(
                L, [Tc] * len(caps), steps.n, tree.num_nodes, tree.path_len,
                levels, deferred=False, slots=SESSION_SLOTS, stale=True)
        elif mode == "dynamic":
            want, per = spec_launches(
                L, [Tc] * len(caps), steps.n, dcfg.total_tokens,
                dcfg.depth + 2, [dcfg.top_k] * dcfg.depth, deferred=False,
                slots=SESSION_SLOTS)
        else:
            want, per = ar_launches(L, Tc, n_tok, chunks), None
        if launches[name] != want:
            fail(f"{name} launched {launches[name]}, but its shapes give "
                 f"{want}")
        if mode != "ar":
            all_four(name)
        if mode != "ar" and launches[name]["kv_gather"] != steps.n:
            fail(f"{name}: K4 ran {launches[name]['kv_gather']} times in "
                 f"{steps.n} batched steps")
        toks_all = len(caps) * n_tok
        comp = (sum(r.accept_sum for r in done)
                / max(sum(r.steps for r in done), 1))
        log(f"{name} [{card}] generate_batch({len(caps)} captions, slots="
            f"{SESSION_SLOTS}, mode={mode!r}{', pin=0.5' if kw.get('pin') else ''}"
            f", {n_tok} tokens, int8 KV): {t_b:.3f} s, aggregate "
            f"{toks_all / t_b:.2f} tok/s"
            f"{'' if mode == 'ar' else f' in {steps.n} batched steps'}; "
            f"alone {t_alone:.3f} s, {toks_all / t_alone:.2f} tok/s; "
            f"batched/alone {t_alone / t_b:.3f}; compression C {comp:.3f}; "
            f"every request equals its lone run; launches {launches[name]} "
            f"= the derived counts"
            f"{'' if per is None else f'; a batched step {per}'}")

    # the Lumina session: Lumina-7B width at 4 layers, 16 x 16 grid
    grid = 16
    max_new, max_seq_len = lane_dims(grid)
    lcfg = dataclasses.replace(configs.chameleon_7b_config(
        max_seq_len=max_seq_len, swin_norm=True), num_layers=RAGGED_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lparams = quantize_params(tfm.fuse_params(
        tfm.init_params(gen, lcfg, device="cuda")))
    cb = torch.randn((8192, 8), generator=gen, device="cuda")
    lparams["nearest_latents"] = torch.as_tensor(cham.shift_nearest_table(
        nearest_latents(cb, k=11), lcfg.vocab_size), device="cuda")
    ldcfg = configs.drafter_config(lcfg, num_layers=1)
    ld = drf.init_drafter_params(
        torch.Generator(device="cuda").manual_seed(101), ldcfg,
        lparams["embed"])
    H = lcfg.hidden_size
    fc = torch.zeros((2 * H, H), dtype=lcfg.torch_dtype, device="cuda")
    fc[H:] = torch.eye(H, dtype=lcfg.torch_dtype, device="cuda")
    ld["fc_w"] = fc
    ld["layers"] = {k: v * 0 for k, v in ld["layers"].items()}
    ld = quantize_params(tfm.fuse_params(ld))
    cvq_cfg = vqgan.chameleon_vq_config()
    cvq = vqgan.init_vqgan_params(
        torch.Generator(device="cuda").manual_seed(3), cvq_cfg, device="cuda")
    lsess = ChameleonSession(lcfg, ldcfg, lparams, ld, family="lumina",
                             grid=(grid, grid), vq_cfg=cvq_cfg, vq_params=cvq,
                             tokenizer=hash_tokenize,
                             passthrough_drafter=True, device="cuda")
    ltree_path = os.path.join("ckpts", "bench_tree_lumina.json")
    ltree = trees.get_tree(ltree_path)
    lkw = dict(mode="static", tree=ltree_path, kv_quant=True, **lant)
    lsess.generate(LUMINA_PROMPT, max_new=8, seed=1, **lkw)      # warm-up
    lsess.decode_generated(np.full((max_new,), 4))
    (ltoks, lst), t_lgen = run("session_lumina", lambda: lsess.generate(
        LUMINA_PROMPT, seed=12, **lkw))
    body = ltoks[:max_new - 1].reshape(grid, grid + 1)
    if ltoks.shape != (max_new,) or not (
            (body[:, grid] == cham.LUMINA_NEWLINE_ID).all()
            and ltoks[-1] == cham.IMAGE_END_ID):
        fail(f"Lumina session: {ltoks.shape} tokens break the grid grammar")
    n_prompt = len(hash_tokenize(LUMINA_PROMPT)) + 3
    want, _ = spec_launches(lcfg.num_layers, n_prompt, lst.steps,
                            ltree.num_nodes, ltree.path_len,
                            [len(lv.child_flat_idx) for lv in ltree.levels],
                            deferred=False, stale=True)
    if launches["session_lumina"] != want:
        fail(f"Lumina session launched {launches['session_lumina']}, but its "
             f"shapes give {want}")
    all_four("session_lumina")
    torch.cuda.synchronize()
    t = time.perf_counter()
    limg = lsess.decode_generated(ltoks)
    torch.cuda.synchronize()
    t_ldec = time.perf_counter() - t
    if limg.shape != (256, 256, 3) or limg.dtype != np.uint8:
        fail(f"Lumina session: decode_generated gave {limg.shape} "
             f"{limg.dtype}, want (256, 256, 3) uint8")
    log(f"Lumina session [{card}] ChameleonSession (Lumina-7B width, "
        f"{lcfg.num_layers} layers, int8 weights and KV, a {n_prompt}-row "
        f"hash_tokenize prompt, {grid}x{grid} grid, the calibrated "
        f"{ltree.num_nodes}-row tree, stale drafting, rollback): {max_new} "
        f"tokens in {t_lgen:.3f} s ({max_new / t_lgen:.2f} tok/s, "
        f"{lst.steps} steps, compression C {lst.step_compression:.3f}); "
        f"Chameleon VQGAN decode_generated (codebook "
        f"{cvq_cfg.codebook_size}x{cvq_cfg.codebook_dim}, ch {cvq_cfg.ch}, "
        f"attention at level {cvq_cfg.attn_levels}) {t_ldec * 1e3:.2f} ms -> "
        f"{limg.shape} uint8, pixel std {limg.std():.2f}; "
        f"{1.0 / (t_lgen + t_ldec):.3f} images/s; launches "
        f"{launches['session_lumina']} = the derived counts")
    launches.update(phase_policy(torch, card, sess, lsess, batch_runs, lant))
    return launches, rec


def phase_policy(torch, card: str, sess, lsess, batch_runs: dict,
                 lant: dict) -> dict:
    """The serving policy (``engine/policy.py``) on the card, inside the
    session phase and on its sessions (XL at ``CUT_LAYERS`` layers, Lumina
    at 4): every entry of ``MEASURED_BEST`` names a tree that
    ``trees.get_tree`` builds, or lockstep AR; ``generate_batch(tree=
    "auto", slots=SESSION_SLOTS)`` serves the session phase's captions (XL)
    and 4 Lumina prompts with the tokens (and steps, where speculative) of
    a ``generate_batch`` run of the tree or mode ``serving_plan`` names
    (the session phase's own run where it is the same), with derived launch
    counts; and ``python -m lantern_tpu_torch.engine.sweep`` in a
    subprocess at XL width, ``CUT_LAYERS`` layers, R in {1, 4},
    ``chain_bush_8`` and AR, one repeat of 16 tokens, prints its schema.
    Prints the phase's seconds.  Returns the auto runs' launches."""
    from lantern_tpu_torch import trees
    from lantern_tpu_torch.engine import policy
    from lantern_tpu_torch.models.item_processor import hash_tokenize
    from lantern_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    for geometry, table in policy.MEASURED_BEST.items():
        for R, (mode, name) in table.items():
            if (mode, name) == ("ar", None):
                continue
            if mode != "spec":
                fail(f"policy: {geometry} R={R} holds {(mode, name)}")
            trees.get_tree(policy.resolve_tree(name))
    launches = {}

    def run(name, fn):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = dict(_cuda.LAUNCHES)
        return out, time.perf_counter() - t

    def check(what, s, prompts, kw, rows, geometry, runs):
        """``s.generate_batch(tree="auto")`` against the named plan (the
        run in ``runs`` under its ``(mode, tree)`` key, where it is)."""
        plan = policy.serving_plan(SESSION_SLOTS, geometry=geometry)
        name = f"policy_{what}_auto"
        with StepCounter() as steps:
            auto, t_auto = run(name, lambda: s.generate_batch(
                prompts, slots=SESSION_SLOTS, tree="auto", **kw))
        key = ("ar", None) if plan[0] == "ar" else ("static", plan[1])
        ref, reused = runs.get(key), key in runs
        if ref is None:
            named = (dict(mode="ar") if plan[0] == "ar"
                     else dict(tree=policy.resolve_tree(plan[1])))
            ref = s.generate_batch(prompts, slots=SESSION_SLOTS, **named,
                                   **kw)
        for a, b in zip(auto, ref):
            if a.error is not None or b.error is not None or not (
                    np_equal(a.tokens, b.tokens)
                    and (plan[0] == "ar" or a.steps == b.steps)):
                fail(f"policy {what}: request {a.uid} under tree='auto' "
                     f"(plan {plan}) differs from the named run; errors "
                     f"{a.error} / {b.error}")
        L = s.cfg.num_layers
        if plan[0] == "ar":
            chunks = [min(SESSION_SLOTS, len(prompts) - lo)
                      for lo in range(0, len(prompts), SESSION_SLOTS)]
            want = ar_launches(L, rows, kw["max_new"], chunks)
        else:
            t = trees.get_tree(policy.resolve_tree(plan[1]))
            want, _ = spec_launches(
                L, [rows] * len(prompts), steps.n, t.num_nodes, t.path_len,
                [len(lv.child_flat_idx) for lv in t.levels], deferred=False,
                slots=SESSION_SLOTS, stale=True)
        if launches[name] != want:
            fail(f"{name} launched {launches[name]}, but its shapes give "
                 f"{want}")
        log(f"policy {what} [{card}] serving_plan({SESSION_SLOTS}, "
            f"{geometry!r}) = {plan}: generate_batch({len(prompts)} prompts,"
            f" slots={SESSION_SLOTS}, tree='auto') {t_auto:.3f} s, equal to "
            f"the named run ({'reused' if reused else 'run here'}), tokens{'' if plan[0] == 'ar' else ' and steps'}; launches "
            f"{launches[name]} = the derived counts")

    xcfg = sess.cfg
    check("xl", sess, BATCH_CAPTIONS[:SESSION_REQUESTS],
          dict(seed=100, max_new=SESSION_TOKENS, kv_quant=True, **lant),
          xcfg.cls_token_num, "llamagen_xl", batch_runs)
    check("lumina", lsess, [LUMINA_PROMPT] * SESSION_SLOTS,
          dict(seed=200, max_new=SESSION_TOKENS, kv_quant=True, **lant),
          len(hash_tokenize(LUMINA_PROMPT)) + 3, "lumina_7b", {})

    # the sweep, as an operator runs it, cut to a schema check
    t = time.perf_counter()
    cmd = [sys.executable, "-m", "lantern_tpu_torch.engine.sweep", "--geom",
           "xl", "--layers", str(xcfg.num_layers), "--rs", "1,4", "--trees",
           "chain_bush_8", "--repeats", "1", "--tokens", "16"]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=POLICY_SWEEP_TIMEOUT)
    t_sweep = time.perf_counter() - t
    if proc.returncode:
        fail(f"policy: {' '.join(cmd[1:])} exited {proc.returncode}:\n"
             f"{proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    rows, last = lines[:-1], lines[-1]
    keys = {"geom", "R", "config", "tok_s", "compression", "repeat"}
    got = sorted((r["R"], r["config"]) for r in rows)
    if got != [(1, "ar"), (1, "spec:chain_bush_8"), (4, "ar"),
               (4, "spec:chain_bush_8")] or any(
            set(r) != keys or not r["tok_s"] > 0 for r in rows):
        fail(f"policy: the sweep printed the rows {rows}")
    if (set(last) != {"summary", "winners", "within_spread", "device"}
            or len(last["summary"]) != 4 or sorted(last["winners"])
            != ["1", "4"] or last["device"] != torch.cuda.get_device_name(0)):
        fail(f"policy: the sweep's summary line is {last}")
    log(f"policy sweep [{card}] python -m lantern_tpu_torch.engine.sweep "
        f"(XL width, {xcfg.num_layers} layers, R 1 and 4, chain_bush_8 and "
        f"AR, 1 repeat of 16 tokens) in a subprocess, {t_sweep:.1f} s: "
        + "; ".join(f"R={p['R']} {p['config']} {p['median_tok_s']:.2f} tok/s"
                    f" C {p['compression']:.3f}" for p in last["summary"])
        + f"; winners {last['winners']}")
    log(f"phase policy: {time.perf_counter() - t0:.1f} s (the sweep "
        f"{t_sweep:.1f} s)")
    return launches


def k2_tool_case(torch, timer, card: str, what: str, G: int, hd: int, S: int,
                 T: int, length: int, mask, quant: bool = False) -> dict:
    """K2 at one shape of the tools' forwards (B = 2, no padding in the
    prefix; a bf16 cache, or int8 with scales): against its plain version
    (tol 2e-2 * max|ref|; a mask entry flipped must fail it), times of the
    kernel, the plain version and SDPA (over the dequantized prefix and the
    block as the kernel quantizes it), and the bound from the pairs the
    mask lets through."""
    import torch.nn.functional as F

    from lantern_tpu_torch.kv import group_blocks, quantize_rows
    from lantern_tpu_torch.ops.tree_attention import (tree_attention_cuda,
                                                      tree_attention_plain)

    B, W = 2, 128
    nh = G * W // hd
    gen = torch.Generator(device="cuda").manual_seed(T * 7 + length)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").bfloat16()

    q, kn, vn = (randn(B, T, nh, hd) for _ in range(3))
    kw = {}
    if quant:
        (kc, ks), (vc, vs) = (quantize_rows(randn(B, G, S, W))
                              for _ in range(2))
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = randn(B, G, S, W), randn(B, G, S, W)
    mask = mask.expand(B, T, T).contiguous()
    bias = torch.zeros((B, S), device="cuda")
    ln = torch.tensor(length, dtype=torch.int32, device="cuda")
    args = (q, kn, vn, kc, vc, ln, mask, bias, hd ** -0.5)
    got = tree_attention_cuda(*args, **kw)
    ref = tree_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = 2e-2 * ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    if not (err <= tol and torch.isfinite(got.float()).all()):
        fail(f"{what}: max err {err} > tol {tol}")
    m2 = mask.clone()
    m2[:, 1, 0] = ~m2[:, 1, 0]                    # row 1 sees two keys
    werr = (tree_attention_plain(q, kn, vn, kc, vc, ln, m2, bias, hd ** -0.5,
                                 **kw).float() - ref.float()).abs().max().item()
    if werr <= tol:
        fail(f"{what}: tol {tol} does not separate a flipped mask entry "
             f"(err {werr})")
    ms = timer(lambda: tree_attention_cuda(*args, **kw))
    plain = timer(lambda: tree_attention_plain(*args, **kw), reps=5)

    def heads(x):                # [B, G, n, 128] -> [B, nh, n, hd]
        return x.reshape(B, G, -1, W // hd, hd).transpose(2, 3).reshape(
            B, nh, -1, hd)
    if quant:
        kq, kqs = quantize_rows(group_blocks(kn))
        vq, vqs = quantize_rows(group_blocks(vn))
        kd = heads(torch.cat([kc[:, :, :length].float() * ks[:, :, :length, None],
                              kq.float() * kqs[..., None]], 2).bfloat16())
        vd = heads(torch.cat([vc[:, :, :length].float() * vs[:, :, :length, None],
                              vq.float() * vqs[..., None]], 2).bfloat16())
    else:
        kd = torch.cat([heads(kc[:, :, :length]), kn.transpose(1, 2)], dim=2)
        vd = torch.cat([heads(vc[:, :, :length]), vn.transpose(1, 2)], dim=2)
    am = torch.cat([torch.ones((B, 1, T, length), dtype=torch.bool,
                               device="cuda"), mask[:, None]], dim=-1)
    qh = q.transpose(1, 2)
    lib = timer(lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=am, scale=hd ** -0.5))
    pairs = B * T * length + int(mask.sum())          # visible (row, key)
    row = W + 4 if quant else 2 * W                   # cache bytes a row
    nbytes = 4 * B * T * nh * hd * 2 + 2 * B * G * length * row + B * T * T
    b_ms, b_by = bound(nbytes, 4.0 * nh * hd * pairs)
    log(f"{what}: max_abs_err {err:.3e} (tol {tol:.3e} = 2e-2 * max|ref|; a "
        f"flipped mask entry errs {werr:.3e}) ms {ms:.4f} plain_ms "
        f"{plain:.4f} library_ms {lib:.4f} (SDPA, {nh} heads of {hd}) "
        f"bound_ms {b_ms:.4f} ({b_by}) [{card}]")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, shape=what)


def lumina_int8(torch, num_layers: int = 32):
    """Lumina-7B (Chameleon geometry, swin norm, S = 4096) with random int8
    weights from seed 5 and a shifted nearest table, on the card."""
    from lantern_tpu_torch import configs
    from lantern_tpu_torch.models import chameleon as cham
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops.quant import quantize_params
    from lantern_tpu_torch.ops.vq_distance import nearest_latents

    cfg = configs.chameleon_7b_config(swin_norm=True).replace(
        num_layers=num_layers)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = quantize_params(tfm.fuse_params(
        tfm.init_params(gen, cfg, device="cuda")))
    cb = torch.randn((8192, 8), generator=gen, device="cuda")
    params["nearest_latents"] = torch.as_tensor(cham.shift_nearest_table(
        nearest_latents(cb, k=11), cfg.vocab_size), device="cuda")
    return cfg, params


def phase_tools(torch, card: str, xl: dict, timer):
    """The tuning tools and the CLI on the card:

    - K1 at the autotune verify's rows (M = 2L = 80-120: two launches a
      matmul) for Lumina's and XL's weight shapes, and K2 at the autotune
      blocks (T = 40-60 at length 128; XL pk = 2, Lumina pk = 1, bf16
      cache) and the teacher-forcing blocks (XL T = 376 at length 0; the
      Lumina teacher's 512-row segment holding 19 prompt rows and 273
      tokens), each against its plain version with times, SDPA and bound;
    - ``autotune_total_tokens`` on XL (int8, cut to ``CUT_LAYERS`` layers
      for time, as every XL path of the phase) and Lumina-7B (int8, full
      depth): each candidate's ms, the pick equal to the
      weighted argmin of the times it read, and each candidate's verify
      forward launching the derived K1 / K2 / K3 counts;
    - pinned (0.9) XL static runs: ``lantern_rt`` at the static point, and a
      wide spec (k 10) at a narrowed point (4, 0.3), each token for token
      equal to its static counterpart;
    - ``measure_rank_probs`` (derived launch counts) and
      ``measure_drafter_accept_probs`` on XL at full depth with the
      passthrough drafter, one 256-token rollout; ``optimize_tree`` on the
      accept matrix, written as a json tree;
    - ``measure_rank_probs`` card vs CPU on a tiny bf16 LlamaGen (K2 takes
      bf16 activations only, so no f32 config reaches the card): every
      entry within 2 / n;
    - ``measure_stale_accept_probs`` on Lumina-7B (full depth) over the
      16x16 grid: [8, 10], entries in (0, 1], rows summing to at most 1
      (plus the 1e-4 floor of empty entries);
    - ``generate_codebook`` at 16384x8, k = 1001, against the CPU's f64
      distances on 64 sampled rows (ties allowed: the card's neighbors'
      distances equal the CPU's sorted ones);
    - ``python -m lantern_tpu_torch generate_images`` as subprocesses: XL
      with 3 captions, ``--random-weights --quant int8 --kv-quant --lantern``
      single over the calibrated tree, ``--slots 2 --total-tokens -1``,
      ``--model-type base --slots 2`` (64 tokens a request: 128 px), then
      Lumina ``--target-size 256`` (273 tokens); every PNG and stats file
      is checked.

    Returns ``(launches by path, records for the kernels line)``."""
    import dataclasses

    import numpy as np

    from lantern_tpu_torch import trees
    from lantern_tpu_torch.engine import autotune as at
    from lantern_tpu_torch.engine import calibrate as cal
    from lantern_tpu_torch.engine import spec
    from lantern_tpu_torch.models import chameleon as cham
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.ops.acceptance import LanternSpec
    from lantern_tpu_torch.ops.quant import K1_MAX_ROWS
    from lantern_tpu_torch.ops.sampling import LogitsWarp

    out_root = os.path.join("build", "tools")
    os.makedirs(out_root, exist_ok=True)
    launches, rec = {}, {}

    def k1(rows):
        return -(-2 * rows // K1_MAX_ROWS)

    def counted(fn):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, dict(_cuda.LAUNCHES)

    # --- the new kernel shapes ------------------------------------------
    t_k = time.perf_counter()
    kp = KernelPhase(torch, timer, card)
    k1_err, reps = 0.0, {}
    for lane, shapes in (("Lumina autotune ", K1_SHAPES),
                         ("XL autotune ", K1_SHAPES_XL)):
        for name, (K, N) in shapes.items():
            if name == "fc_w":
                continue
            err, r, _, _ = kp.k1_shape(name, K, N, AUTOTUNE_M,
                                       100 if name == "w_gu" else None, lane)
            k1_err = max(k1_err, err)
            if r:
                reps[lane] = dict(r, max_abs_err=err)
    rec["int8_matmul"] = dict(reps["Lumina autotune "], max_abs_err=k1_err)
    causal = {}

    def tril(T, live=None):
        if (T, live) not in causal:
            m = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                      device="cuda"))
            if live is not None:
                m &= torch.arange(T, device="cuda")[None] < live
            causal[(T, live)] = m[None]
        return causal[(T, live)]
    k2 = []
    for T in at.CANDIDATES:
        k2.append(k2_tool_case(
            torch, timer, card, f"K2 XL autotune verify pk=2 B=2 G=10 S=512 "
            f"T={T} length=128 bf16 KV", 10, 64, 512, T, 128, tril(T)))
        k2.append(k2_tool_case(
            torch, timer, card, f"K2 Lumina autotune verify pk=1 B=2 G=32 "
            f"S=4096 T={T} length=128 bf16 KV", 32, 128, 4096, T, 128,
            tril(T)))
    n_xl = xl["cfg"].cls_token_num + CALIB_TOKENS
    k2.append(k2_tool_case(
        torch, timer, card, f"K2 XL teacher forcing pk=2 B=2 G=10 S=384 "
        f"T={n_xl} length=0 bf16 KV", 10, 64, 384, n_xl, 0, tril(n_xl)))
    n_lum = len(TEXT) + 3 + 16 * 17 + 1
    k2.append(k2_tool_case(
        torch, timer, card, f"K2 Lumina teacher forcing pk=1 B=2 G=32 S=512 "
        f"T=512 ({n_lum} live rows) length=0 int8 KV", 32, 128, 512, 512, 0,
        tril(512, n_lum), quant=True))
    rec["tree_attention"] = dict(k2[4], max_abs_err=max(r["max_abs_err"]
                                                        for r in k2))
    log(f"tools kernels: K1 at M = {AUTOTUNE_M}, K2 at {len(k2)} shapes in "
        f"{time.perf_counter() - t_k:.1f} s")

    # --- autotune ----------------------------------------------------------
    def tune(name, cfg, params):
        seen = {}
        orig = at.time_verify_forward

        def recording(params, cfg, length, prefix=128, iters=20, rope=None):
            seen[length] = orig(params, cfg, length, prefix, iters, rope)
            return seen[length]
        at.time_verify_forward = recording
        try:
            t = time.perf_counter()
            best = at.autotune_total_tokens(params, cfg)
            dt = time.perf_counter() - t
        finally:
            at.time_verify_forward = orig
        score = {c: seen[c] / w for c, w in zip(at.CANDIDATES, at.WEIGHTS)}
        if best != min(score, key=score.get):
            fail(f"autotune {name}: picked {best}, the weighted argmin of "
                 f"{score} is {min(score, key=score.get)}")
        L = cfg.num_layers
        for c in at.CANDIDATES:
            fwd = at.verify_forward(params, cfg, c)
            logits, _, got = counted(fwd)
            want = {"int8_matmul": 4 * L * k1(c) + k1(c),
                    "tree_attention": L, "kv_write": 1, "kv_gather": 0}
            if got != want:
                fail(f"autotune {name} L={c}: the verify forward launched "
                     f"{got}, its shapes give {want}")
            if not bool(torch.isfinite(logits).all()):
                fail(f"autotune {name} L={c}: non-finite logits")
        launches[f"autotune_{name}"] = got
        log(f"autotune {name} [{card}] verify forward [2, L] + head over a "
            f"128-row prefix, 20 timed runs each: " + ", ".join(
                f"L={c} {seen[c] * 1e3:.3f} ms (weighted "
                f"{score[c] * 1e3:.3f})" for c in at.CANDIDATES)
            + f"; picked total_tokens={best} = the weighted argmin; "
            f"{dt:.1f} s; launches a forward at L=60 {got} = the derived "
            f"counts (K1 {k1(60)} launches a matmul)")
        return best

    cfg, params = xl["cfg"], xl["params"]
    rec["autotune_xl"] = tune("XL", cfg, params)
    lcfg, lparams = lumina_int8(torch)
    rec["autotune_lumina"] = tune("Lumina-7B", lcfg, lparams)

    # --- the operating point as device tensors ----------------------------
    cond, uncond, pv = xl["caption"](XL_CAPTION)
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_XL.json"))
    base = spec.SpecDecodeConfig(
        warp=LogitsWarp(temperature=1.0, top_k=2000), cfg_scale=3.0,
        lantern=LanternSpec(k=10, delta=5.0), max_new=RT_TOKENS,
        walk_batch_warp=True, stale_draft=True, deferred_commit=True,
        pin=0.9)

    def run_rt(ecfg, rt):
        g = torch.Generator(device="cuda").manual_seed(10)
        return spec.generate(params, ecfg, cfg, tree, None, g,
                             cond=cond, uncond=uncond, prefix_valid=pv,
                             lantern_rt=rt)
    narrow = LanternSpec(k=4, delta=0.3)
    pairs = {
        "static point": (run_rt(base, None), run_rt(
            base, base.lantern.runtime(device="cuda"))),
        "narrowed point (4, 0.3)": (
            run_rt(dataclasses.replace(base, lantern=narrow), None),
            run_rt(base, base.lantern.runtime(4, 0.3, device="cuda")))}
    for what, (a, b) in pairs.items():
        if not (torch.equal(a.tokens, b.tokens) and a.steps == b.steps
                and a.accept_sum == b.accept_sum):
            fail(f"lantern_rt at the {what}: steps {a.steps} / {b.steps}, "
                 f"accepted {a.accept_sum} / {b.accept_sum}")
    a0, a1 = (pairs[k][0] for k in pairs)
    differ = int((a0.tokens != a1.tokens).sum())
    log(f"lantern_rt [{card}] pinned (0.9) XL static runs (stale + "
        f"deferred, {RT_TOKENS} tokens): the runtime point equals the static "
        f"spec token for token at (10, 5.0) (C {a0.step_compression:.3f}) "
        f"and, from a k=10 spec, at (4, 0.3) (C {a1.step_compression:.3f}); "
        f"the two points' streams differ in {differ} of {RT_TOKENS} tokens")

    # --- calibration on XL ---------------------------------------------------
    dcfg, dparams = xl["dcfg"], xl["dparams"]
    warp = LogitsWarp(temperature=1.0, top_k=2000)
    Tc, L = cfg.cls_token_num, cfg.num_layers
    g = torch.Generator(device="cuda").manual_seed(21)
    rank, t_rank, got = counted(lambda: cal.measure_rank_probs(
        params, dparams, cfg, dcfg, cond, uncond, g,
        num_tokens=CALIB_TOKENS, warp=warp))
    n, Dp = CALIB_TOKENS, Tc - 1 + CALIB_TOKENS
    want = {"int8_matmul": (4 * L * k1(Tc) + 1 + n * (4 * L + 1)
                            + 4 * L * k1(Tc + n) + k1(Dp) + 4 * k1(Dp)
                            + k1(Dp)),
            "tree_attention": (1 + n) * L + L + 1,
            "kv_write": 1 + n + 1 + 1, "kv_gather": 0}
    if got != want:
        fail(f"measure_rank_probs XL launched {got}, its shapes give {want}")
    if rank.shape != (10,) or not ((rank > 0) & (rank <= 1)).all():
        fail(f"measure_rank_probs XL: {rank}")
    launches["calibrate_rank_xl"] = got
    g = torch.Generator(device="cuda").manual_seed(22)
    acc_p, t_acc, got = counted(lambda: cal.measure_drafter_accept_probs(
        params, dparams, cfg, dcfg, cond, uncond, g, params["nearest_latents"],
        LanternSpec(k=10, delta=5.0), num_tokens=CALIB_TOKENS, warp=warp))
    if (acc_p.shape != (6, 10) or not ((acc_p > 0) & (acc_p <= 1)).all()
            or (acc_p.sum(1) > 1 + 10e-4).any()):
        fail(f"measure_drafter_accept_probs XL: {acc_p}")
    if min(got["int8_matmul"], got["tree_attention"], got["kv_write"]) == 0:
        fail(f"measure_drafter_accept_probs XL launched {got}")
    launches["calibrate_accept_xl"] = got
    paths = trees.optimize_tree(acc_p, CALIB_NODES, CALIB_DEPTH)
    tree_json = os.path.join(out_root, "calibrated_tree_XL.json")
    with open(tree_json, "w") as f:
        json.dump({"paths": [list(p) for p in paths]}, f)
    ctree = trees.get_tree(tree_json)
    log(f"calibrate XL [{card}] ({L} layers, int8, passthrough drafter, one "
        f"{CALIB_TOKENS}-token rollout, top-2000, cfg 3.0): "
        f"measure_rank_probs {t_rank:.1f} s -> "
        f"{np.round(rank, 4).tolist()} (launches = the derived counts); "
        f"measure_drafter_accept_probs (LANTERN k=10 delta=5) {t_acc:.1f} s "
        f"-> depth x rank {np.round(acc_p, 4).tolist()}; optimize_tree "
        f"({CALIB_NODES} nodes, depth <= {CALIB_DEPTH}) -> {len(paths)} "
        f"paths, {ctree.num_nodes} rows, depth {ctree.max_depth}, written to "
        f"{tree_json}")
    rec["calibrated_tree"] = dict(paths=[list(p) for p in paths])

    # --- card vs CPU: measure_rank_probs on a tiny bf16 LlamaGen -----------
    from lantern_tpu_torch import configs
    from lantern_tpu_torch.models import drafter as drf
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops.quant import quantize_params

    tcfg = configs.tiny_config(vocab_size=512, hidden_size=256, num_layers=2,
                               num_heads=4, cond_kind="caption",
                               block_size=36, max_seq_len=64,
                               dtype="bfloat16")
    tdcfg = configs.drafter_config(tcfg)
    gen = torch.Generator().manual_seed(8)
    tp_ = tfm.init_params(gen, tcfg, device="cpu")
    tp_["lm_head"] = tp_["lm_head"] * 40          # sharp rows: clear ranks
    tp_ = quantize_params(tfm.fuse_params(tp_))
    td = drf.init_drafter_params(gen, tdcfg, tp_["embed"])
    H = tcfg.hidden_size
    td["fc_w"] = torch.cat([torch.zeros((H, H)), torch.eye(H)]).to(
        tcfg.torch_dtype)
    td["layers"] = {k: v * 0 for k, v in td["layers"].items()}
    td = quantize_params(tfm.fuse_params(td))
    c0 = torch.randn((1, tcfg.cls_token_num, tcfg.caption_dim),
                     generator=torch.Generator().manual_seed(9))
    probs = {}
    for dev in ("cpu", "cuda"):
        p, dp = on_device(tp_, dev), on_device(td, dev)
        u0 = p["cond"]["uncond"][None].float()
        probs[dev] = cal.measure_rank_probs(
            p, dp, tcfg, tdcfg, c0.to(dev), u0, None, max_rank=6,
            warp=LogitsWarp(temperature=0.0))
    n_t = tcfg.block_size - 1
    diff = np.abs(probs["cuda"] - probs["cpu"]).max()
    if diff > 2.0 / n_t:
        fail(f"measure_rank_probs card vs CPU: {probs['cuda']} vs "
             f"{probs['cpu']} (max diff {diff} > 2/{n_t})")
    log(f"measure_rank_probs card vs CPU [{card}] tiny bf16 LlamaGen "
        f"(int8 weights, passthrough drafter, greedy, {n_t + 1} tokens): "
        f"card {np.round(probs['cuda'], 4).tolist()}, CPU "
        f"{np.round(probs['cpu'], 4).tolist()}; max diff {diff:.4f} (tol "
        f"2/{n_t}: two ranks may move with bf16 rounding)")

    # --- measure_stale_accept_probs on Lumina-7B, 16x16 ----------------------
    grid = 16
    ltp = cham.lumina_token_prompt(TEXT, grid=(grid, grid))
    fsm = cham.LuminaGridFSM(w=grid, h=grid, image_start_idx=len(TEXT),
                             vocab_size=lcfg.vocab_size)
    g = torch.Generator(device="cuda").manual_seed(23)
    stale, t_stale, got = counted(lambda: cal.measure_stale_accept_probs(
        lparams, lcfg, ltp, g, grid * (grid + 1) + 1,
        lparams["nearest_latents"], LanternSpec(k=10, delta=5.0),
        warp=warp, logits_fn=fsm, kv_quant=True))
    if (stale.shape != (8, 10) or not ((stale > 0) & (stale <= 1)).all()
            or (stale.sum(1) > 1 + 10e-4).any()):
        fail(f"measure_stale_accept_probs Lumina: {stale}")
    if min(got["int8_matmul"], got["tree_attention"], got["kv_write"]) == 0:
        fail(f"measure_stale_accept_probs Lumina launched {got}")
    launches["calibrate_stale_lumina"] = got
    log(f"calibrate Lumina-7B [{card}] (32 layers, int8 weights and KV, "
        f"16x16 grid, FSM, top-2000, cfg 3.0, LANTERN k=10 delta=5): "
        f"measure_stale_accept_probs {t_stale:.1f} s -> depth x rank "
        f"{np.round(stale, 4).tolist()}; row sums "
        f"{np.round(stale.sum(1), 4).tolist()}; launches {got}")
    del lparams
    torch.cuda.empty_cache()

    # --- generate_codebook at 16384x8, k = 1001 ------------------------------
    from lantern_tpu_torch.entrypoints import generate_codebook as gcb

    ap = argparse.ArgumentParser()
    gcb.add_args(ap)
    cargs = ap.parse_args(["--model", "random", "--k", "1001", "--save-path",
                           os.path.join(out_root, "vq_distances")])
    t = time.perf_counter()
    gcb.run(cargs, device="cuda")
    t_cb = time.perf_counter() - t
    table = np.load(os.path.join(out_root, "vq_distances",
                                 "top_1001_indices.npy"))
    cb = gcb.codebook_of(cargs).astype(np.float64)
    rows = np.random.default_rng(3).choice(cb.shape[0], 64, replace=False)
    worst, same = 0.0, 0
    for r in rows:
        d = ((cb - cb[r]) ** 2).sum(1)
        d[r] = np.inf
        want_d = np.sort(d)[:1001]
        got_d = d[table[r].astype(np.int64)]
        worst = max(worst, float(np.abs(got_d - want_d).max()
                                 / max(want_d[-1], 1e-12)))
        same += int((table[r] == np.argsort(d, kind="stable")[:1001]).sum())
    if table.shape != (16384, 1001) or table.dtype != np.uint16 or worst > 1e-4:
        fail(f"generate_codebook: {table.shape} {table.dtype}; neighbor "
             f"distances off the CPU's by {worst} (relative)")
    log(f"generate_codebook [{card}] 16384x8 random codebook, k=1001: "
        f"{t_cb:.2f} s (nearest_latents on the card + the uint16 .npy); on "
        f"64 sampled rows the neighbors' distances equal the CPU's sorted f64 "
        f"ones within {worst:.1e} (relative), {same / (64 * 1001):.4f} of "
        f"the ids equal (ties and f32 rounding may swap the others)")

    # --- the CLI as users run it ----------------------------------------------
    def cli(tag, *argv, n_prompts=3):
        out = os.path.join(out_root, tag)
        cmd = [sys.executable, "-m", "lantern_tpu_torch", "generate_images",
               "--random-weights", "--output-dir", out, *argv]
        t = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t
        if r.returncode:
            fail(f"CLI {tag}: exit {r.returncode}: {r.stderr[-3000:]}")
        st = json.load(open(os.path.join(
            out, f"global_statistics_0_{n_prompts}.json")))
        if sorted(st) != sorted(f"prompt_{i}" for i in range(n_prompts)):
            fail(f"CLI {tag}: statistics for {sorted(st)}")
        for key, v in st.items():
            if "error" in v or not v["step_compression"] >= 1.0:
                fail(f"CLI {tag}: {key} {v}")
        cfgs = json.load(open(os.path.join(out, "generation_configs.json")))
        shapes = []
        for i in range(n_prompts):
            data = open(os.path.join(out, f"prompt_{i}.png"), "rb").read()
            if data[:8] != b"\x89PNG\r\n\x1a\n":
                fail(f"CLI {tag}: prompt_{i}.png is not a PNG")
            w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(
                data[20:24], "big")
            shapes.append((h, w))
        auto = [ln for ln in r.stdout.splitlines() if "autotuned" in ln]
        log(f"CLI {tag} [{card}] python -m lantern_tpu_torch generate_images "
            f"{' '.join(argv)}: {dt:.1f} s (process included); C "
            + ", ".join(f"{v['step_compression']:.3f}" for v in st.values())
            + f"; latency " + ", ".join(f"{v['latency']:.2f}"
                                        for v in st.values())
            + f" s; PNGs {shapes}; {len(cfgs)} config keys"
            + (f"; {auto[0]}" if auto else ""))
        return st, auto

    common = ["--prompts", CLI_CAPTIONS, "--quant", "int8", "--kv-quant",
              "--lantern", "--lantern-k", "10", "--lantern-delta", "5.0",
              "--cfg", "3.0", "--max-new", str(CLI_TOKENS)]
    st_cal, _ = cli("xl_calibrated", *common, "--tree-choices", tree_json)
    rec["calibrated_tree"]["C"] = [v["step_compression"]
                                   for v in st_cal.values()]
    _, auto = cli("xl_slots_autotune", *common, "--slots", "2",
                  "--total-tokens", "-1")
    if not auto:
        fail("CLI --total-tokens -1 printed no autotuned total_tokens")
    cli("xl_base_slots", *common, "--model-type", "base", "--slots", "2")
    cli("lumina", "--model", "lumina_mgpt", "--target-size", "256",
        "--prompts", LUMINA_PROMPT, "--quant", "int8", "--kv-quant",
        "--cfg", "3.0", n_prompts=1)
    return launches, rec


def _tree_to(tree, dev):
    """A copy on ``dev`` of a nested dict of tensors (a copy on the CPU
    too: the train steps update their parameters in place)."""
    return {k: (_tree_to(v, dev) if isinstance(v, dict)
                else v.to(dev, copy=True)) for k, v in tree.items()}


def _adam_close(got, want, lr_steps: float) -> tuple[float, float]:
    """``(largest difference, share of elements beyond 1e-3 * lr_steps)``
    of two parameter lists after ``lr_steps`` = lr x steps of Adam: a
    gradient near 0 that differs between two runs can turn into a step of
    about lr either way, so those few elements may differ by up to
    2 x lr_steps."""
    worst, n_off, n = 0.0, 0, 0
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        worst = max(worst, float(d.max()))
        n_off += int((d > 1e-3 * lr_steps).sum())
        n += d.numel()
    return worst, n_off / n


def train_card_vs_cpu(torch) -> str:
    """Phase 11a: a tiny f32 LlamaGen (caption prefix, TF32 off, no kernel
    involved): the drafter's ``loss_and_metrics`` and its gradients, three
    drafter ``train_step`` s, ``forward_train`` and one finetune
    ``train_step`` on the card against the CPU."""
    import numpy as np

    from lantern_tpu_torch import configs
    from lantern_tpu_torch.models import drafter as drf
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.train import drafter_train as dt
    from lantern_tpu_torch.train import finetune as ft
    from lantern_tpu_torch.train.optim import flatten, unflatten

    cfg = configs.tiny_config(cond_kind="caption", vocab_size=64,
                              hidden_size=64, num_heads=4, block_size=16)
    dcfg = configs.drafter_config(cfg)
    gen = torch.Generator().manual_seed(0)
    base = tfm.init_params(gen, cfg, device="cpu")
    dparams = drf.init_drafter_params(gen, dcfg, base["embed"])
    rng = np.random.default_rng(0)
    B, T, H = 4, 24, cfg.hidden_size
    hid = rng.normal(size=(B, T, H)).astype(np.float32)
    av = np.ones((B, T), np.float32)
    av[1, -5:] = 0
    batch = {"tokens": rng.integers(0, 64, (B, T)).astype(np.int32),
             "hidden": hid, "target": np.tanh(hid[:, ::-1].copy()),
             "loss_mask": (rng.random((B, T)) > 0.2).astype(np.float32),
             "attn_valid": av}
    fbatch = {"tokens": rng.integers(0, 64, (B, 16)).astype(np.int32),
              "cond": rng.normal(size=(B, cfg.cls_token_num,
                                       cfg.caption_dim)).astype(np.float32),
              "loss_mask": np.ones((B, 16), np.float32)}
    tcfg = dt.TrainConfig(lr=5e-3, noise="none", warmup_steps=1,
                          total_steps=3, head_chunk=7, rollout_depth=2)
    fcfg = ft.FinetuneConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    res = {}
    for dev in ("cpu", "cuda"):
        dp, bp = _tree_to(dparams, dev), _tree_to(base, dev)
        rope = tfm.make_rope_tables(dcfg.model, dev)
        bt = dt.to_device(batch, dev)
        paths, leaves = dt.trainable(dp)
        live = [x.detach().requires_grad_() for x in leaves]
        loss, m = dt.loss_and_metrics(unflatten(dp, paths, live), dcfg, rope,
                                      bp["lm_head"], bt, tcfg)
        grads = [g.cpu() for g in torch.autograd.grad(loss, live,
                                                      allow_unused=True)
                 if g is not None]
        st = dt.init_train_state(dp, tcfg)
        losses = []
        for _ in range(3):
            st, mt = dt.train_step(st, dcfg, tcfg, rope, bp["lm_head"], bt)
            losses.append(float(mt.loss))
        frope = tfm.make_rope_tables(cfg, dev)
        fb = {k: torch.as_tensor(v, device=dev) for k, v in fbatch.items()}
        emb = torch.cat([tfm.cond_embed(bp, cfg, fb["cond"]),
                         tfm.token_embed(bp, fb["tokens"])], dim=1)
        h = tfm.forward_train(bp, cfg, emb, torch.arange(emb.shape[1],
                                                         device=dev), frope)
        fst, fm = ft.train_step(ft.init_state(bp, fcfg), cfg, fcfg, frope, fb)
        res[dev] = dict(loss=float(loss.detach()), top=m.top_acc.cpu(),
                        grads=grads,
                        losses=losses, dparams=[x.cpu() for x in
                                                flatten(st.dparams)[1]],
                        h=h.detach().cpu(), fm={k: float(v)
                                                for k, v in fm.items()},
                        params=[x.cpu() for x in flatten(fst.params)[1]])
    c, g = res["cpu"], res["cuda"]
    worst = {"loss": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
             "grads": max(float((a - b).abs().max()) / max(
                 float(b.abs().max()), 1e-30)
                 for a, b in zip(g["grads"], c["grads"])),
             "losses": max(abs(a - b) / abs(b) for a, b in zip(
                 g["losses"], c["losses"])),
             "dparams": _adam_close(g["dparams"], c["dparams"], 5e-3 * 3),
             "forward_train": float((g["h"] - c["h"]).abs().max()),
             "finetune": max(abs(g["fm"][k] - c["fm"][k]) / abs(c["fm"][k])
                             for k in ("loss", "grad_norm")),
             "ft_params": _adam_close(g["params"], c["params"], 5e-3)}
    # f32 on both sides: reduction orders differ, nothing else; parameters
    # within 2 lr x steps, and all but 0.1 % of them within 1e-3 lr x steps
    tol = {"loss": 1e-5, "grads": 1e-4, "losses": 1e-5,
           "dparams": (2 * 5e-3 * 3, 1e-3), "forward_train": 1e-4,
           "finetune": 1e-5, "ft_params": (2 * 5e-3, 1e-3)}
    if not torch.equal(g["top"], c["top"]):
        fail(f"train (a): top-k counts card {g['top']} vs CPU {c['top']}")
    bad = {k: v for k, v in worst.items()
           if not (v[0] <= tol[k][0] and v[1] <= tol[k][1]
                   if isinstance(v, tuple) else v <= tol[k])}
    if bad:
        fail(f"train (a): card vs CPU beyond tolerance: {bad} (tolerances "
             f"{tol})")
    return (f"loss rel {worst['loss']:.1e}, grads {worst['grads']:.1e} of "
            f"the largest, 3 drafter steps' losses {worst['losses']:.1e} rel "
            f"and params {worst['dparams'][0]:.1e} (share beyond 1e-3 lr x "
            f"steps {worst['dparams'][1]:.1e}), forward_train "
            f"{worst['forward_train']:.1e}, finetune loss/grad_norm "
            f"{worst['finetune']:.1e} rel and params "
            f"{worst['ft_params'][0]:.1e} (share "
            f"{worst['ft_params'][1]:.1e}); tolerances {tol}")


def phase_train(torch, card: str, xl: dict):
    """Phase 11, training on the card at LlamaGen-XL's full width and depth
    (36 layers x 1280, 20 heads of 64, vocab 16384, a 120-row caption, 256
    image tokens):
    (a) ``train_card_vs_cpu``;
    (b) ``generate_train_data`` in process through its ``run``:
        ``TRAIN_SAMPLES`` self-generated samples on ``--slots 2``, random
        bf16 weights (seed 0), ``RandomT5`` captions; its K2 and K3 launch
        counts equal the derived ones (K1 and K4 never run: dense weights,
        no tree), and every ``.npz`` holds 375 rows of 1280 with the loss
        mask over the 256 image rows; then ``python -m lantern_tpu_torch
        generate_train_data --codes-dir`` on the first two samples' codes
        and captions, whose hiddens must equal the in-process ones;
    (c) ``train_drafter`` in process on those samples (one drafter layer,
        the frozen 1280 x 16384 head, ``--bs 2 --max-len 384 --data-noise
        none``): the summed loss of the last epoch must be below the
        first's; then the step's time and peak memory;
    (d) a finetune ``train_step`` of the whole XL base (remat on, bf16
        params, f32 first moment) on two samples' tokens with their caption
        prefix, the caption's pad rows holding the params' ``uncond``
        features (the norm of the gradient with them zero, the inference
        layout, is printed beside): finite losses that fall on the repeated
        batch, grad norm,
        step time, tokens/s and peak memory; then save, restore and resume:
        the restored step and parameters equal, the resumed step's loss the
        live one's;
    (e) the trained drafter (detached, fused and int8 like the lane's)
        serving the lane's int8 base: static (drafter + deferred, the
        calibrated tree) and dynamic (EAGLE-2 + rollback) ``spec.generate``
        of ``TRAIN_SERVE_TOKENS`` tokens, beside the passthrough drafter on
        the same caption and seed; launch counts equal the derived ones,
        and the step compressions are recorded (no threshold: random
        weights).
    Returns the launch counts of (b) and (e)."""
    import dataclasses
    import shutil

    import numpy as np

    from lantern_tpu_torch.engine import spec
    from lantern_tpu_torch.entrypoints import generate_train_data as gtd
    from lantern_tpu_torch.entrypoints import train_drafter as tdr
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.ops.quant import quantize_params
    from lantern_tpu_torch.train import drafter_train as dt
    from lantern_tpu_torch.train import finetune as ft
    from lantern_tpu_torch.train.optim import flatten, global_norm, unflatten
    from lantern_tpu_torch.utils.checkpoint import restore_pytree
    from lantern_tpu_torch.utils.t5 import RandomT5, flip_for_left_padding

    t = time.perf_counter()
    log(f"train (a) [{card}] tiny f32 LlamaGen card vs CPU: "
        f"{train_card_vs_cpu(torch)}; {time.perf_counter() - t:.1f} s")

    cfg, dcfg = xl["cfg"], xl["dcfg"]
    L, Tc, n_img, H = (cfg.num_layers, cfg.cls_token_num, cfg.block_size,
                       cfg.hidden_size)
    root = os.path.join("build", "train")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    captions = BATCH_CAPTIONS[:TRAIN_SAMPLES]

    def parse(mod, argv):
        ap = argparse.ArgumentParser()
        mod.add_args(ap)
        return ap.parse_args(argv)

    # --- (b) generate_train_data ----------------------------------------------
    args = parse(gtd, ["--random-weights", "--self-generate", "--prompts",
                       "|".join(captions), "--num-samples",
                       str(TRAIN_SAMPLES), "--slots", str(TRAIN_SLOTS),
                       "--save-dir", data])
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t = time.perf_counter()
    gtd.run(args, device="cuda")
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t
    gen_launch = dict(_cuda.LAUNCHES)
    # per lockstep call a prefill and one forward a token; then one teacher
    # forward a sample; each forward K2 once a layer and K3 once
    forwards = -(-TRAIN_SAMPLES // TRAIN_SLOTS) * (1 + n_img) + TRAIN_SAMPLES
    want = {"int8_matmul": 0, "tree_attention": L * forwards,
            "kv_write": forwards, "kv_gather": 0}
    if gen_launch != want:
        fail(f"generate_train_data launched {gen_launch}, derived {want}")
    names = sorted(os.listdir(data))
    if names != [f"sample_{i:06d}.npz" for i in range(TRAIN_SAMPLES)]:
        fail(f"generate_train_data wrote {names}")
    samples = [dt.load_sample(os.path.join(data, n)) for n in names]
    rows = Tc + n_img - 1
    for i, s in enumerate(samples):
        lm = s["loss_mask"]
        if (s["tokens"].shape != (rows,) or s["hidden"].shape != (rows, H)
                or s["target"].shape != (rows, H)
                or not np.isfinite(s["hidden"]).all()
                or lm.sum() != n_img or lm[Tc - 1:].min() != 1.0
                or not np.array_equal(s["target"][:-1], s["hidden"][1:])):
            fail(f"sample {i}: tokens {s['tokens'].shape}, hidden "
                 f"{s['hidden'].shape}, loss rows {lm.sum()}")
    log(f"train (b) [{card}] generate_train_data, XL bf16 seed 0, "
        f"{TRAIN_SAMPLES} self-generated samples on --slots {TRAIN_SLOTS} "
        f"(top-2000, cfg 7.5), {n_img} tokens each: {t_gen:.1f} s; every "
        f".npz {rows} rows of {H}, loss mask over the {n_img} image rows; "
        f"launches {gen_launch} = the derived counts")

    # the CLI on the first two samples' codes and captions
    codes = os.path.join(root, "codes")
    os.makedirs(codes)
    t5 = RandomT5(cfg.caption_dim, Tc)
    for i in range(TRAIN_CLI_SAMPLES):
        emb, mask = t5.get_text_embeddings([captions[i]])
        np.savez(os.path.join(codes, f"c{i}.npz"),
                 codes=samples[i]["tokens"][Tc - 1:], caption_emb=emb[0],
                 caption_mask=mask[0])
    cli_out = os.path.join(root, "cli")
    cmd = [sys.executable, "-m", "lantern_tpu_torch", "generate_train_data",
           "--random-weights", "--codes-dir", codes, "--num-samples",
           str(TRAIN_CLI_SAMPLES), "--save-dir", cli_out]
    t = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t
    if r.returncode:
        fail(f"generate_train_data CLI: exit {r.returncode}: "
             f"{r.stderr[-3000:]}")
    worst = 0.0
    for i in range(TRAIN_CLI_SAMPLES):
        got = dt.load_sample(os.path.join(cli_out, f"sample_{i:06d}.npz"))
        if not (np.array_equal(got["tokens"], samples[i]["tokens"])
                and np.array_equal(got["loss_mask"], samples[i]["loss_mask"])):
            fail(f"generate_train_data CLI sample {i}: tokens or mask differ")
        worst = max(worst, float(np.abs(got["hidden"]
                                        - samples[i]["hidden"]).max()))
    if worst > 1e-2:
        fail(f"generate_train_data CLI: teacher hiddens off the in-process "
             f"ones by {worst}")
    log(f"train (b) [{card}] python -m lantern_tpu_torch generate_train_data "
        f"--codes-dir (the first {TRAIN_CLI_SAMPLES} samples' codes and "
        f"captions): {t_cli:.1f} s (process included); tokens and masks "
        f"equal the in-process samples', hiddens within {worst:.1e}")

    # --- (c) train_drafter ----------------------------------------------------
    save = os.path.join(root, "drafter")
    args = parse(tdr, ["--data-dir", data, "--save-dir", save, "--bs", "2",
                       "--max-len", "384", "--data-noise", "none",
                       "--num-epochs", str(TRAIN_EPOCHS), "--lr",
                       str(TRAIN_LR), "--save-freq", str(TRAIN_EPOCHS)])
    t = time.perf_counter()
    tdr.run(args, device="cuda")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t
    hist = json.load(open(os.path.join(save, "history.json")))
    losses = [h["loss"] for h in hist]
    if (len(hist) != TRAIN_EPOCHS or not np.isfinite(losses).all()
            or not losses[-1] < losses[0]):
        fail(f"train_drafter: epoch losses {losses}")

    base = tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, device="cuda")
    rope = tfm.make_rope_tables(dcfg.model, "cuda")
    from lantern_tpu_torch.models import drafter as drf
    tcfg = dt.TrainConfig(lr=TRAIN_LR, noise="none")
    state = dt.init_train_state(drf.init_drafter_params(
        torch.Generator(device="cuda").manual_seed(1), dcfg, base["embed"]),
        tcfg)
    batch = dt.to_device(next(dt.batch_iterator(
        [os.path.join(data, n) for n in names], 2, 384,
        np.random.default_rng(0))), "cuda")
    state, _ = dt.train_step(state, dcfg, tcfg, rope, base["lm_head"], batch)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        state, m = dt.train_step(state, dcfg, tcfg, rope, base["lm_head"],
                                 batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    d_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    d_ms = statistics.median(times) * 1e3
    log(f"train (c) [{card}] train_drafter, 1 drafter layer at XL width, "
        f"frozen {H}x{cfg.vocab_size} head, --bs 2 --max-len 384 --data-noise none "
        f"--lr {TRAIN_LR}, {TRAIN_EPOCHS} epochs of "
        f"{int(TRAIN_SAMPLES * 0.95) // 2} step(s): {t_train:.1f} s (base "
        f"init and saving included); epoch losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; train top-1 first / last epoch {hist[0]['top1']:.3f} / "
        f"{hist[-1]['top1']:.3f}; step {d_ms:.2f} ms (median of 5, host "
        f"clock, synchronized), {2 * 384 / d_ms * 1e3:.0f} rows/s; peak "
        f"memory {d_peak:.2f} GiB ({resident:.2f} GiB resident: the bf16 "
        f"base, the drafter and its optimizer state)")
    profile("drafter train_step, XL width, [2, 384]",
            lambda: dt.train_step(state, dcfg, tcfg, rope, base["lm_head"],
                                  batch), card)
    del state, batch

    # --- (d) finetune of the whole XL base ----------------------------------------
    fcfg = ft.FinetuneConfig(lr=FT_LR, warmup_steps=1, total_steps=100,
                             remat=True)
    frope = tfm.make_rope_tables(cfg, "cuda")
    uncond = base["cond"]["uncond"].float().cpu().numpy()

    def ft_batch(fill_pads: bool) -> dict:
        """Two samples' image tokens after their left-padded captions; the
        pad rows zero (the inference layout) or holding the params'
        ``uncond`` features."""
        conds = []
        for c in captions[:2]:
            emb, mask = flip_for_left_padding(*t5.get_text_embeddings([c]))
            if fill_pads:
                emb[0][mask[0] == 0] = uncond[mask[0] == 0]
            conds.append(emb[0])
        return {"tokens": torch.as_tensor(np.stack(
                    [s["tokens"][Tc - 1:] for s in samples[:2]]),
                    device="cuda"),
                "cond": torch.as_tensor(np.stack(conds), device="cuda"),
                "loss_mask": torch.ones((2, n_img), device="cuda")}

    # token_loss takes every conditioning column as valid (as the JAX
    # finetune does): zero pad rows stay exactly zero through all layers,
    # where each RMSNorm scales the gradient reaching them by
    # 1 / sqrt(eps), and 36 layers of that overflow
    paths, leaves = flatten(base)
    with torch.enable_grad():
        live = [x.detach().requires_grad_() for x in leaves]
        zloss, _ = ft.token_loss(unflatten(base, paths, live), cfg, frope,
                                 ft_batch(False), fcfg)
        zgrads = torch.autograd.grad(zloss, live, allow_unused=True)
    z_norm = float(global_norm([g for g in zgrads if g is not None]))
    del live, zgrads
    fbatch = ft_batch(True)
    fstate = ft.init_state(base, fcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    f_losses, f_norms, f_times = [], [], []
    for _ in range(FT_STEPS):
        t = time.perf_counter()
        fstate, fm = ft.train_step(fstate, cfg, fcfg, frope, fbatch)
        torch.cuda.synchronize()
        f_times.append(time.perf_counter() - t)
        f_losses.append(float(fm["loss"]))
        f_norms.append(float(fm["grad_norm"]))
    f_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the first step runs at lr 0 (warmup from 0); the later ones must fall
    if not (np.isfinite(f_losses).all() and np.isfinite(f_norms).all()
            and all(b < a for a, b in zip(f_losses[1:], f_losses[2:]))):
        fail(f"finetune: losses {f_losses}, grad norms {f_norms}")
    f_ms = statistics.median(f_times[1:]) * 1e3
    n_tok = 2 * (Tc + n_img)
    n_params = sum(x.numel() for x in flatten(fstate.params)[1])
    ckdir = os.path.join(root, "finetune")
    t = time.perf_counter()
    path = ft.save_checkpoint(ckdir, fstate, keep_last=1)
    t_save = time.perf_counter() - t
    size = os.path.getsize(path) / 2 ** 30
    t = time.perf_counter()
    restored = ft.restore_checkpoint(ckdir, fstate)
    t_restore = time.perf_counter() - t
    same = (restored.step == fstate.step == FT_STEPS
            and restored.opt_state.count == fstate.opt_state.count
            and all(torch.equal(a, b) for a, b in zip(
                flatten(restored.params)[1], flatten(fstate.params)[1]))
            and all(torch.equal(a, b) for a, b in zip(
                restored.opt_state.mu + restored.opt_state.nu,
                fstate.opt_state.mu + fstate.opt_state.nu)))
    if not same:
        fail("finetune: the restored state differs from the saved one")
    _, m_live = ft.train_step(fstate, cfg, fcfg, frope, fbatch)
    _, m_back = ft.train_step(restored, cfg, fcfg, frope, fbatch)
    l_live, l_back = float(m_live["loss"]), float(m_back["loss"])
    if not abs(l_back - l_live) <= 1e-5 * abs(l_live):
        fail(f"finetune resume: loss {l_back} after restore, {l_live} live")
    shutil.rmtree(ckdir, ignore_errors=True)

    def fwd_bwd(remat: bool) -> float:
        """ms of one forward + backward of the finetune loss."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.enable_grad():
            live = [x.detach().requires_grad_() for x in leaves]
            loss, _ = ft.token_loss(
                unflatten(base, paths, live), cfg, frope, fbatch,
                dataclasses.replace(fcfg, remat=remat))
            torch.autograd.grad(loss, live, allow_unused=True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    fb = {True: [], False: []}
    for remat in (True, False, False, True, True, False):
        fb[remat].append(fwd_bwd(remat))
    fb = {k: statistics.median(v) for k, v in fb.items()}
    profile(f"finetune train_step, XL base, 2 x {Tc + n_img} rows, remat",
            lambda: ft.train_step(fstate, cfg, fcfg, frope, fbatch), card)
    log(f"train (d) [{card}] finetune of the whole XL base ({n_params / 1e6:.1f}"
        f"M bf16 params, {L} layers, remat on, f32 first moment), batch 2 x "
        f"({Tc} caption + {n_img} image) rows, the caption's pad rows "
        f"holding the params' uncond features (left zero, as inference lays "
        f"them out, the first gradient's norm is {z_norm}), lr {FT_LR}: "
        f"losses "
        + ", ".join(f"{x:.4f}" for x in f_losses)
        + ", grad norms " + ", ".join(f"{x:.3f}" for x in f_norms)
        + f"; step {f_ms:.1f} ms (median of steps 2-{FT_STEPS}, host clock, "
        f"synchronized), {n_tok / f_ms * 1e3:.0f} training tokens/s ({n_tok} "
        f"rows a step); peak memory {f_peak:.2f} GiB; checkpoint "
        f"{size:.2f} GiB saved in {t_save:.1f} s, restored in "
        f"{t_restore:.1f} s: step {restored.step} and every tensor equal; "
        f"the resumed step's loss {l_back:.7f}, the live one's {l_live:.7f}; "
        f"forward + backward {fb[True]:.1f} ms with remat, {fb[False]:.1f} "
        f"ms without (medians of 3, alternating)")
    del fstate, restored, base, fbatch
    torch.cuda.empty_cache()

    # --- (e) the trained drafter serving ---------------------------------------------
    from lantern_tpu_torch import trees
    from lantern_tpu_torch.ops.acceptance import LanternSpec
    from lantern_tpu_torch.ops.sampling import LogitsWarp

    trained = restore_pytree(os.path.join(save, f"state_{TRAIN_EPOCHS}"),
                             device="cuda")["dparams"]
    trained["embed"] = xl["params"]["embed"]     # the same seed-0 embedding
    trained = quantize_params(tfm.fuse_params(trained))
    for x in flatten(trained)[1]:
        x.requires_grad_(False)
    params = xl["params"]
    cond, uncond, pv = xl["caption"](XL_CAPTION)
    warp = LogitsWarp(temperature=1.0, top_k=2000, top_p=1.0)
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_XL.json"))
    static = spec.SpecDecodeConfig(
        warp=warp, cfg_scale=3.0, lantern=LanternSpec(k=10, delta=5.0),
        max_new=TRAIN_SERVE_TOKENS, walk_batch_warp=True,
        deferred_commit=True)
    dynamic = dataclasses.replace(static, mode="dynamic", kv_quant=True,
                                  deferred_commit=False)
    launches, rec = {}, {}
    for dname, dp in (("trained", trained), ("passthrough", xl["dparams"])):
        for mode, ecfg in (("static", static), ("dynamic", dynamic)):
            g = torch.Generator(device="cuda").manual_seed(8)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t = time.perf_counter()
            res = spec.generate(params, ecfg, cfg, tree, None, g,
                                dparams=dp, dcfg=dcfg, cond=cond,
                                uncond=uncond, prefix_valid=pv,
                                device="cuda")
            torch.cuda.synchronize()
            dt_s = time.perf_counter() - t
            got = dict(_cuda.LAUNCHES)
            if mode == "static":
                want, _ = spec_launches(
                    L, Tc, res.steps, tree.num_nodes, tree.path_len,
                    [len(lv.child_flat_idx) for lv in tree.levels],
                    deferred=True)
            else:
                want, _ = spec_launches(
                    L, Tc, res.steps, dcfg.total_tokens, dcfg.depth + 2,
                    [dcfg.top_k] * dcfg.depth, deferred=False)
            toks = res.tokens[:TRAIN_SERVE_TOKENS]
            if (got != want or res.n_valid != TRAIN_SERVE_TOKENS
                    or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
                    or res.step_compression < 1.0):
                fail(f"train (e) {dname} {mode}: launches {got} (derived "
                     f"{want}), {res.n_valid} tokens, C {res.step_compression}")
            rec[(dname, mode)] = (res.step_compression, res.steps,
                                  TRAIN_SERVE_TOKENS / dt_s)
            if dname == "trained":
                launches[f"train_serve_{mode}"] = got
    for mode in ("static", "dynamic"):
        (ct_, st_, rt_), (cp, sp, rp) = (rec[("trained", mode)],
                                         rec[("passthrough", mode)])
        log(f"train (e) [{card}] XL {mode} "
            + ("(drafter + deferred, the calibrated tree, bf16 KV)"
               if mode == "static" else
               f"(EAGLE-2 {dcfg.total_tokens}/{dcfg.depth}/{dcfg.top_k} + "
               f"rollback, int8 KV)")
            + f", int8 base, {TRAIN_SERVE_TOKENS} tokens, seed 8: trained "
            f"drafter C {ct_:.3f} ({st_} steps, {rt_:.2f} tok/s) vs the "
            f"passthrough drafter C {cp:.3f} ({sp} steps, {rp:.2f} tok/s); "
            f"launches = the derived counts")
    launches["train_data"] = gen_launch
    return launches


def llamagen_vq_names(sd: dict, n_levels: int) -> dict:
    """A taming-layout VQGAN state dict renamed to LlamaGen's ``vq_model``
    module names (``conv_blocks``, numbered mids, decoder blocks coarse to
    fine), the names ``extract_code --model llamagen`` loads."""
    import re

    mid = {"block_1": "0", "attn_1": "1", "block_2": "2"}
    out = {}
    for k, v in sd.items():
        k2 = re.sub(r"encoder\.down\.(\d+)\.block\.",
                    r"encoder.conv_blocks.\1.res.", k)
        k2 = re.sub(r"encoder\.down\.(\d+)\.", r"encoder.conv_blocks.\1.", k2)
        k2 = re.sub(r"\.mid\.(block_1|attn_1|block_2)\.",
                    lambda m: f".mid.{mid[m.group(1)]}.", k2)
        m = re.match(r"decoder\.up\.(\d+)\.(.*)", k2)
        if m:
            k2 = (f"decoder.conv_blocks.{n_levels - 1 - int(m.group(1))}."
                  f"{m.group(2).replace('block.', 'res.', 1)}")
        out[k2] = v
    return out


def np_fid(a, b) -> float:
    """FID in numpy float64 on the host: the JAX package's formula, written
    out here (no ``lantern_tpu`` import)."""
    import numpy as np
    from scipy import linalg

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mu1, mu2 = a.mean(0), b.mean(0)
    s1, s2 = np.cov(a, rowvar=False), np.cov(b, rowvar=False)
    covmean = linalg.sqrtm(s1 @ s2)
    if not np.isfinite(covmean).all():
        off = np.eye(s1.shape[0]) * 1e-6
        covmean = linalg.sqrtm((s1 + off) @ (s2 + off))
    covmean = covmean.real
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2.0 * np.trace(covmean))


def np_precision_recall(ref, fake, k: int, block: int = 2048):
    """Improved precision / recall in numpy float64 on the host (k-NN
    radii as the (k+1)-th order statistic of each row)."""
    import numpy as np

    ref, fake = np.asarray(ref, np.float64), np.asarray(fake, np.float64)

    def dist(x, y):
        y_sq = (y * y).sum(1)
        out = np.empty((len(x), len(y)))
        for i in range(0, len(x), block):
            xb = x[i: i + block]
            d2 = (xb * xb).sum(1)[:, None] + y_sq[None] - 2.0 * xb @ y.T
            out[i: i + block] = np.sqrt(np.maximum(d2, 0.0))
        return out

    def radii(x):
        return np.concatenate([np.partition(dist(x[i: i + block], x), k,
                                            axis=1)[:, k]
                               for i in range(0, len(x), block)])

    def coverage(x, r, y):
        hits = 0
        for i in range(0, len(y), block):
            hits += int((dist(x, y[i: i + block]) < r[:, None]).any(0).sum())
        return hits / len(y)

    rr, rf = radii(ref), radii(fake)
    return coverage(ref, rr, fake), coverage(fake, rf, ref)


class CardNormals:
    """Normals from a seeded generator on the card, copied to the host as
    f32 numpy: the ``rng`` argument of the port's random-weight helpers
    (``normal`` / ``standard_normal``).  The weights need a seed, not
    numpy's stream, and ~1.2e9 normals drawn on the host took ~30 s
    (PERF.md §5)."""

    def __init__(self, torch, seed: int):
        self.torch = torch
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def normal(self, loc=0.0, scale=1.0, size=None):
        x = self.torch.randn(size, generator=self.gen, device="cuda")
        return (x * float(scale) + float(loc)).cpu().numpy()

    def standard_normal(self, size=None):
        return self.normal(size=size)


def phase_evals(torch, card: str):
    """Phase 12, ``extract_code`` and the eval harness on the card, outputs
    under ``build/evals/`` (deleted at the end but for the score files):
    (a) the PNG reader and the resampler: PNGs written by ``utils/png.py``
        read back byte-exact on the card, each of the repository's
        ``generated_images/**/prompt_*.png`` decodes to the same pixels on
        the card and the CPU, ``resize`` at Lanczos, bicubic and bilinear
        on uint8 byte-equal card against CPU, on float within 1e-4;
    (b) ``python -m lantern_tpu_torch extract_code --model llamagen`` as a
        subprocess on ``EVAL_PNGS`` seeded 256 px PNGs with a captions
        json (``RandomT5``) and a random VQ-16 at its published width as
        ``--vq-path``: 256 codes in range an image, equal to a CPU encode
        wherever the CPU's best distance beats the second by more than
        1e-4 relative (the share printed), the ``.npz`` files then fed to
        ``generate_train_data --codes-dir``; images/s of the encode;
    (c) each backbone at its published width with random weights from one
        seed (Inception-V3 pool3, VGG16 fc2, CLIP ViT-B/32 and OpenCLIP
        ViT-H/14, image and text): card within ``1e-4 * max|ref|`` of the
        CPU on a few images; a known-wrong variant must miss (Mixed_7c
        pooled by average; a ReLU after fc2; the other GELU); the error
        with TF32 left on is printed; images/s at a batch of 64, f32;
    (d) FID on 5,000 x 2,048 and precision / recall (k = 3) on 5,000 x
        4,096 seeded features, on the card against numpy f64 on the host,
        within 1e-9 relative, with the seconds of each;
    (e) ``eval_fid_clip`` (``clip_b32``; ``fid_inception``),
        ``eval_prec_recall`` (``vgg16_jax``) and ``eval_hpsv2`` (the
        pinned ViT-H/14) as subprocesses on the card over the repository's
        ``generated_images`` and seeded PNGs with the random ``.npz``
        weights and a synthetic BPE merges file: each writes its score
        file or prints its scores, all finite (the two ``eval_fid_clip``
        runs one after the other, the other two beside them)."""
    import contextlib
    import dataclasses
    import glob
    import shutil

    import numpy as np

    from lantern_tpu_torch.evals import clip as C
    from lantern_tpu_torch.evals import metrics as M
    from lantern_tpu_torch.evals.clip_bpe import ClipTokenizer
    from lantern_tpu_torch.evals.inception import InceptionExtractor
    from lantern_tpu_torch.evals.inception import random_state_dict as inc_sd
    from lantern_tpu_torch.evals.vgg import VGGExtractor
    from lantern_tpu_torch.evals.vgg import random_state_dict as vgg_sd
    from lantern_tpu_torch.models import vqgan
    from lantern_tpu_torch.utils import image as I
    from lantern_tpu_torch.utils.checkpoint import load_torch_file
    from lantern_tpu_torch.utils.png import write_png

    dev = torch.device("cuda")
    root = os.path.join("build", "evals")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(0)

    def sync():
        torch.cuda.synchronize()

    def smooth(h, w):
        base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(float)
        img = np.kron(base, np.ones((8, 8, 1)))[:h, :w] + rng.normal(
            0, 12, (h, w, 3))
        return np.clip(img, 0, 255).astype(np.uint8)

    # ---- (a) reader and resampler
    t = time.perf_counter()
    written = os.path.join(root, "written")
    os.makedirs(written)
    for i, (h, w) in enumerate(((37, 53), (256, 256), (300, 211))):
        a = smooth(h, w)
        p = os.path.join(written, f"w{i}.png")
        write_png(p, a)
        for d in ("cpu", dev):
            if not np.array_equal(I.read_image(p, device=d).cpu().numpy(), a):
                fail(f"evals (a): {p} does not read back byte-exact on {d}")
    repo_pngs = sorted(glob.glob("generated_images/**/prompt_*.png",
                                 recursive=True))
    if not repo_pngs:
        fail("evals (a): no generated_images/**/prompt_*.png in the checkout")
    dec = {"cpu": [], "card": []}
    for p in repo_pngs:
        got = {}
        for key, d in (("cpu", "cpu"), ("card", dev)):
            I.read_image(p, device=d)
            sync()
            t0 = time.perf_counter()
            got[key] = I.read_image(p, device=d).cpu()
            dec[key].append(time.perf_counter() - t0)
        if not torch.equal(got["cpu"], got["card"]):
            fail(f"evals (a): {p} decodes to other pixels on the card")
    worst_f = 0.0
    rs_ms = {}
    batch = torch.from_numpy(np.stack([smooth(256, 256) for _ in range(8)]))
    for (h, w), size in (((256, 256), (299, 299)), ((256, 256), (224, 224)),
                         ((37, 53), (101, 77)), ((300, 211), (17, 255))):
        x = batch[:, :h, :w] if h <= 256 else torch.from_numpy(
            np.stack([smooth(h, w) for _ in range(2)]))
        for filt in ("lanczos", "bicubic", "bilinear"):
            ref = I.resize(x, size, filt)
            xc = x.to(dev)
            I.resize(xc, size, filt)
            sync()
            t0 = time.perf_counter()
            got = I.resize(xc, size, filt)
            sync()
            rs_ms[(h, w, size, filt)] = (time.perf_counter() - t0) * 1e3
            if not torch.equal(got.cpu(), ref):
                fail(f"evals (a): uint8 {filt} resize {(h, w)} -> {size} "
                     f"differs card against CPU")
            f = x.to(torch.float32)
            worst_f = max(worst_f, float((I.resize(f.to(dev), size, filt)
                                          .cpu() - I.resize(f, size, filt))
                                         .abs().max()))
    if worst_f > 1e-4:
        fail(f"evals (a): float resize card against CPU off by {worst_f}")
    log(f"evals (a) [{card}] PNG reader: 3 written PNGs byte-exact, "
        f"{len(repo_pngs)} generated_images PNGs equal card vs CPU, decode "
        f"{1e3 * statistics.median(dec['cpu']):.1f} ms (CPU) / "
        f"{1e3 * statistics.median(dec['card']):.1f} ms (card) a 128 px "
        f"image; resize uint8 byte-equal at 3 filters x 4 shapes, float "
        f"within {worst_f:.1e}; 8 x 256^2 uint8 -> 299^2 bicubic "
        f"{rs_ms[(256, 256, (299, 299), 'bicubic')]:.2f} ms, -> 224^2 "
        f"bilinear {rs_ms[(256, 256, (224, 224), 'bilinear')]:.2f} ms on "
        f"the card ({time.perf_counter() - t:.1f} s)")

    # ---- seeded weights (setup, outside every timed window), their
    # normals drawn on the card (CardNormals)
    t = time.perf_counter()
    vq_cfg = vqgan.vq16_config()
    vq_path = os.path.join(root, "vq16.pt")
    torch.save({k: torch.from_numpy(v) for k, v in llamagen_vq_names(
        vqgan.random_taming_state_dict(vq_cfg, rng=CardNormals(torch, 0)),
        len(vq_cfg.ch_mult)).items()}, vq_path)
    sds = {"inception": inc_sd(rng=CardNormals(torch, 0)),
           "vgg16": vgg_sd(rng=CardNormals(torch, 0)),
           "clip_b32": C.random_state_dict(C.VIT_B32,
                                           rng=CardNormals(torch, 0)),
           "hps_v21": C.random_state_dict(C.VIT_H14,
                                          rng=CardNormals(torch, 0))}
    weights = {}
    for name, sd in sds.items():
        weights[name] = os.path.join(root, f"{name}.npz")
        np.savez(weights[name], **sd)
    merges = os.path.join(root, "merges.txt")
    pairs = [("h", "e"), ("l", "l"), ("he", "ll"), ("t", "h"),
             ("th", "e</w>"), ("c", "a"), ("ca", "t</w>"), ("o", "x</w>")]
    with open(merges, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in pairs))
    log(f"evals setup: seeded random weights at published widths (VQ-16, "
        f"Inception-V3, VGG16, ViT-B/32, ViT-H/14; normals drawn on the "
        f"card) written under {root} in {time.perf_counter() - t:.1f} s")

    # ---- (b) extract_code
    t = time.perf_counter()
    imgs = os.path.join(root, "images")
    os.makedirs(imgs)
    captions = {}
    for i in range(EVAL_PNGS):
        h, w = (256, 256) if i % 2 else (280 + 8 * i, 280)
        write_png(os.path.join(imgs, f"img_{i}.png"), smooth(h, w))
        captions[f"img_{i}.png"] = BATCH_CAPTIONS[i]
    caps = os.path.join(root, "captions.json")
    with open(caps, "w") as f:
        json.dump(captions, f)
    codes_dir = os.path.join(root, "codes")
    cmd = [sys.executable, "-m", "lantern_tpu_torch", "extract_code",
           "--model", "llamagen", "--images-dir", imgs, "--captions-json",
           caps, "--vq-path", vq_path, "--save-dir", codes_dir]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    if r.returncode:
        fail(f"extract_code CLI: exit {r.returncode}: {r.stderr[-3000:]}")
    vq_cpu = vqgan.load_torch_state_dict(load_torch_file(vq_path), vq_cfg,
                                         device="cpu")
    vq_card = vqgan.load_torch_state_dict(load_torch_file(vq_path), vq_cfg,
                                          device=dev)
    sure = agree = 0
    for i in range(EVAL_PNGS):
        z = np.load(os.path.join(codes_dir, f"img_{i}.npz"))
        codes = z["codes"]
        if (codes.dtype != np.int32 or codes.shape != (256,)
                or codes.min() < 0 or codes.max() >= vq_cfg.codebook_size):
            fail(f"extract_code: img_{i} codes {codes.dtype} {codes.shape} "
                 f"[{codes.min()}, {codes.max()}]")
        if (z["caption_emb"].shape != (120, 2048)
                or z["caption_emb"].dtype != np.float32
                or z["caption_mask"].dtype != np.int64):
            fail(f"extract_code: img_{i} caption arrays "
                 f"{z['caption_emb'].shape} {z['caption_mask'].dtype}")
        x = (I.load_image(os.path.join(imgs, f"img_{i}.png"), 256)
             .to(torch.float32) / 127.5 - 1.0).permute(2, 0, 1)[None]
        # the CPU's distances: codes must agree where the best beats the
        # second by more than 1e-4 relative
        enc = vq_cpu["encoder"]
        with torch.no_grad():
            h = vqgan.conv2d(enc["conv_in"], x)
            h = vqgan._tower(enc["blocks"], enc["mid"], h, up=False)
            h = vqgan.conv2d(enc["conv_out"],
                             vqgan.swish(vqgan.group_norm(enc["norm_out"], h)))
            zf = vqgan.conv2d(vq_cpu["quant_conv"], h).permute(
                0, 2, 3, 1).reshape(-1, vq_cfg.codebook_dim)
            zf = zf / zf.norm(dim=-1, keepdim=True).clamp(min=1e-12)
            cb = vqgan._norm_codebook(vq_cpu, vq_cfg)
            d2 = (zf * zf).sum(1, keepdim=True) + (cb * cb).sum(1)[None] \
                - 2.0 * zf @ cb.T
        two = d2.topk(2, dim=1, largest=False).values
        clear = ((two[:, 1] - two[:, 0])
                 > 1e-4 * two[:, 1].abs().clamp(min=1e-12)).numpy()
        cpu_codes = vqgan.encode(vq_cpu, vq_cfg, x)[0].numpy()
        if not np.array_equal(codes[clear], cpu_codes[clear]):
            fail(f"extract_code: img_{i} card codes differ from the CPU's "
                 f"at {int((codes != cpu_codes)[clear].sum())} clear latents")
        sure += int(clear.sum())
        agree += int((codes == cpu_codes).sum())
    # the encode's rate in process: read, crop, Lanczos, encode an image
    paths = [os.path.join(imgs, f"img_{i}.png") for i in range(EVAL_PNGS)]
    for p in paths[:2]:
        vqgan.encode(vq_card, vq_cfg, (I.load_image(p, 256, dev).to(
            torch.float32) / 127.5 - 1.0).permute(2, 0, 1)[None])
    sync()
    t0 = time.perf_counter()
    for p in paths:
        vqgan.encode(vq_card, vq_cfg, (I.load_image(p, 256, dev).to(
            torch.float32) / 127.5 - 1.0).permute(2, 0, 1)[None])
    sync()
    t_loop = time.perf_counter() - t0
    xb = torch.stack([I.load_image(p, 256, dev) for p in paths]).to(
        torch.float32).div(127.5).sub(1.0).permute(0, 3, 1, 2)
    vqgan.encode(vq_card, vq_cfg, xb)
    sync()
    t0 = time.perf_counter()
    vqgan.encode(vq_card, vq_cfg, xb)
    sync()
    t_enc = time.perf_counter() - t0
    train_dir = os.path.join(root, "train")
    r = subprocess.run(
        [sys.executable, "-m", "lantern_tpu_torch", "generate_train_data",
         "--random-weights", "--codes-dir", codes_dir, "--num-samples", "2",
         "--save-dir", train_dir], capture_output=True, text=True,
        timeout=600)
    if r.returncode:
        fail(f"generate_train_data --codes-dir on extract_code's output: exit "
             f"{r.returncode}: {r.stderr[-3000:]}")
    if len(glob.glob(os.path.join(train_dir, "sample_*.npz"))) != 2:
        fail("generate_train_data --codes-dir wrote no 2 samples from "
             "extract_code's output")
    log(f"evals (b) [{card}] python -m lantern_tpu_torch extract_code "
        f"--model llamagen, {EVAL_PNGS} seeded PNGs (256 px and 280-328 x "
        f"280, cropped and Lanczos-resized to 256), VQ-16 "
        f"at published width (random, --vq-path), RandomT5 captions: "
        f"{t_cli:.1f} s (process included); 256 codes an image in range; "
        f"equal to the CPU encode on all {sure} clear latents ("
        f"{100 * sure / (256 * EVAL_PNGS):.2f} % of "
        f"{256 * EVAL_PNGS}; {100 * agree / (256 * EVAL_PNGS):.2f} % equal "
        f"overall); in process {EVAL_PNGS / t_loop:.1f} images/s read + "
        f"crop + Lanczos + encode one by one, the encode alone "
        f"{EVAL_PNGS / t_enc:.1f} images/s at a batch of {EVAL_PNGS}; "
        f"generate_train_data --codes-dir on the codes: 2 samples "
        f"({time.perf_counter() - t:.1f} s)")

    # ---- (c) backbones, card against CPU
    t = time.perf_counter()
    few = torch.from_numpy(np.stack([smooth(256, 256) for _ in range(4)]))
    many = torch.from_numpy(np.stack([smooth(256, 256)
                                      for _ in range(EVAL_BATCH)])).to(dev)
    tok = ClipTokenizer(merges)
    texts = ["the cat", "hello box", "a cat on the hat", "the end"]
    toks = torch.as_tensor(tok(texts), dtype=torch.long)
    toks64 = toks.repeat(EVAL_BATCH // len(texts), 1).to(dev)

    def rate(fn, n):
        fn()
        sync()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append(time.perf_counter() - t0)
        return n / statistics.median(times), 1e3 * statistics.median(times)

    def check(name, got, ref, wrong, tf32):
        got, ref = got.float().cpu(), ref.float()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        err_w = float((wrong.float().cpu() - ref).abs().max())
        err_t = float((tf32.float().cpu() - ref).abs().max())
        if not (scale > 0 and err <= 1e-4 * scale):
            fail(f"evals (c) {name}: card off the CPU by {err} "
                 f"(scale {scale})")
        if err_w <= 1e-4 * scale:
            fail(f"evals (c) {name}: the known-wrong variant passed "
                 f"({err_w} <= 1e-4 x {scale})")
        return (f"{name}: {err / scale:.1e} of the scale (known-wrong "
                f"{err_w / scale:.1e}, TF32 on {err_t / scale:.1e})")

    def tf32_on():
        torch.backends.cuda.matmul.allow_tf32 = True
        return torch.backends.cudnn.flags(enabled=True, allow_tf32=True)

    def tf32_off():
        torch.backends.cuda.matmul.allow_tf32 = False

    lines = []
    inc_cpu = InceptionExtractor(weights["inception"], device="cpu")
    inc = InceptionExtractor(weights["inception"], device=dev)
    ref = inc_cpu.image_features(few)
    got = inc.image_features(few.to(dev))
    from lantern_tpu_torch.evals.inception import clean_resize
    xr = clean_resize(few.to(dev))
    inc.net.mixed_7c_pool = "avg"
    wrong = inc.net(xr)
    inc.net.mixed_7c_pool = "max"
    with tf32_on():
        with torch.no_grad():
            tf = inc.net.pool3(xr)
    tf32_off()
    lines.append(check("Inception-V3 pool3", got, ref, wrong, tf))
    xr64 = clean_resize(many)
    ips_inc, ms_inc = rate(lambda: inc.net(xr64), EVAL_BATCH)
    _, ms_cr = rate(lambda: clean_resize(many), EVAL_BATCH)
    del inc_cpu, inc, xr64

    vgg_cpu = VGGExtractor(weights["vgg16"], device="cpu")
    vgg = VGGExtractor(weights["vgg16"], device=dev)
    ref = vgg_cpu.image_features(few)
    got = vgg.image_features(few.to(dev))
    xv = I.resize(few.to(dev), (224, 224), "bilinear").float() / 255.0
    wrong = torch.relu(vgg.net(xv))
    with tf32_on():
        with torch.no_grad():
            tf = vgg.net.fc2(xv)
    tf32_off()
    lines.append(check("VGG16 fc2", got, ref, wrong, tf))
    xv64 = I.resize(many, (224, 224), "bilinear").float() / 255.0
    ips_vgg, ms_vgg = rate(lambda: vgg.net(xv64), EVAL_BATCH)
    del vgg_cpu, vgg, xv64

    rates = {}
    for name, geom, key in (("ViT-B/32", C.VIT_B32, "clip_b32"),
                            ("ViT-H/14", C.VIT_H14, "hps_v21")):
        n = 2 if geom is C.VIT_H14 else 4
        p_cpu = C.params_from_openai(sds[key], geom, "cpu")
        p = C.params_from_openai(sds[key], geom, dev)
        x = C.preprocess_images(few[:n], geom.image_size)
        xc = C.preprocess_images(few[:n].to(dev), geom.image_size)
        # the uint8 resize is byte-equal (a); the card divides by 255 as a
        # multiply by its reciprocal, so the floats may differ by an ulp
        if float((xc.cpu() - x).abs().max()) > 1.2e-7:
            fail(f"evals (c) {name}: preprocess_images differs card vs CPU")
        other = dataclasses.replace(geom, quick_gelu=not geom.quick_gelu)
        for what, fn, arg in (("image", C.encode_image, (x, xc)),
                              ("text", C.encode_text, (toks[:n],
                                                       toks[:n].to(dev)))):
            ref = fn(p_cpu, arg[0], geom)
            got = fn(p, arg[1], geom)
            wrong = fn(p, arg[1], other)
            # TF32 on: the towers without their full-f32 guard
            with tf32_on():
                orig = C.full_f32
                C.full_f32 = contextlib.nullcontext
                try:
                    tf = fn(p, arg[1], geom)
                finally:
                    C.full_f32 = orig
            tf32_off()
            lines.append(check(f"{name} {what}", got, ref, wrong, tf))
        del p_cpu
        x64 = C.preprocess_images(many, geom.image_size)
        rates[name] = (rate(lambda: C.encode_image(p, x64, geom), EVAL_BATCH),
                       rate(lambda: C.encode_text(p, toks64, geom),
                            EVAL_BATCH))
        del p, x64
    torch.cuda.empty_cache()
    log(f"evals (c) [{card}] backbones at published widths, random weights "
        f"(seed 0), card vs CPU on 4 images (ViT-H/14: 2), f32 without "
        f"TF32: " + "; ".join(lines))
    log(f"evals (c) [{card}] at a batch of {EVAL_BATCH}, f32: Inception-V3 "
        f"{ms_inc:.1f} ms ({ips_inc:.0f} images/s; clean_resize 256 -> 299 "
        f"{ms_cr:.1f} ms), VGG16 {ms_vgg:.1f} ms ({ips_vgg:.0f} images/s), "
        + ", ".join(f"{k} image {v[0][1]:.1f} ms ({v[0][0]:.0f} images/s) "
                    f"text {v[1][1]:.1f} ms ({v[1][0]:.0f} texts/s)"
                    for k, v in rates.items())
        + f" ({time.perf_counter() - t:.1f} s)")

    # ---- (d) metrics on the card against numpy f64 on the host
    t = time.perf_counter()
    frng = np.random.default_rng(1)
    n = METRIC_N
    fa = frng.normal(size=(n, 2048)).astype(np.float32)
    fb = (frng.normal(size=(n, 2048)) * 1.1 + 0.05).astype(np.float32)
    t0 = time.perf_counter()
    fid = M.fid_from_features(torch.from_numpy(fa).to(dev),
                              torch.from_numpy(fb).to(dev))
    t_fid = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid_np = np_fid(fa, fb)
    t_fid_np = time.perf_counter() - t0
    if not abs(fid - fid_np) <= 1e-9 * abs(fid_np):
        fail(f"evals (d) FID on the card {fid!r} against numpy {fid_np!r}")
    ra = frng.normal(size=(n, 4096)).astype(np.float32)
    rb = frng.normal(size=(n, 4096)).astype(np.float32)
    rb[: n // 5] += 0.5                     # a shifted fifth
    ra_c, rb_c = torch.from_numpy(ra).to(dev), torch.from_numpy(rb).to(dev)
    M.precision_recall(ra_c[:64], rb_c[:64], k=3)
    sync()
    t0 = time.perf_counter()
    pr = M.precision_recall(ra_c, rb_c, k=3)
    t_pr = time.perf_counter() - t0
    t0 = time.perf_counter()
    pr_np = np_precision_recall(ra, rb, 3)
    t_pr_np = time.perf_counter() - t0
    for got, want in zip(pr, pr_np):
        if not abs(got - want) <= 1e-9 * abs(want):
            fail(f"evals (d) precision / recall {tuple(pr)} on the card "
                 f"against numpy {pr_np}")
    log(f"evals (d) [{card}] FID {n} x 2048: {fid!r} card vs {fid_np!r} "
        f"numpy f64 (rel {abs(fid - fid_np) / abs(fid_np):.1e}), "
        f"{t_fid:.2f} s on the card (scipy sqrtm on the host) vs "
        f"{t_fid_np:.2f} s numpy; precision / recall k=3 {n} x 4096: "
        f"{pr.precision!r} / {pr.recall!r} card, {pr_np[0]!r} / "
        f"{pr_np[1]!r} numpy, {t_pr:.3f} s on the card vs {t_pr_np:.2f} s "
        f"numpy ({time.perf_counter() - t:.1f} s)")

    # ---- (e) the eval CLIs as subprocesses on the card
    t = time.perf_counter()
    fake = os.path.join(root, "fake")
    os.makedirs(fake)
    for p in repo_pngs:
        shutil.copy(p, os.path.join(fake, os.path.basename(p)))
    for i in range(len(repo_pngs), len(repo_pngs) + 4):
        write_png(os.path.join(fake, f"prompt_{i}.png"), smooth(128, 128))
    n_fake = len(os.listdir(fake))
    prompts = os.path.join(root, "prompts.json")
    with open(prompts, "w") as f:
        json.dump([[c] for c in BATCH_CAPTIONS[:n_fake]], f)

    def start(task, *argv):
        return task, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "lantern_tpu_torch", task, *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(job):
        task, t0, p = job
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            fail(f"{task} CLI: no exit within 600 s")
        if p.returncode:
            fail(f"{task} CLI: exit {p.returncode}: {err[-3000:]}")
        return out, time.perf_counter() - t0

    def numbers(out):
        vals = []
        for line in out.splitlines():
            try:
                vals.append(float(line.rsplit(" ", 1)[-1]))
            except ValueError:
                pass
        if not vals or not all(np.isfinite(vals)):
            fail(f"eval CLI printed no finite score: {out[-1000:]}")
        return vals

    # the two eval_fid_clip runs write one score.txt, so they run one
    # after the other; the other two CLIs run beside them
    runs = []
    side = [start("eval_prec_recall", "--ref_dir", imgs, "--fake_dir", fake,
                  "--feature-extractor", "vgg16_jax", "--vgg-ckpt",
                  weights["vgg16"]),
            start("eval_hpsv2", "--image_path", fake, "--prompt_path",
                  prompts, "--model", weights["hps_v21"], "--merges",
                  merges)]
    try:
        out, s = finish(start(
            "eval_fid_clip", "--fake_dir", fake, "--ref_dir", imgs,
            "--caption_path", prompts, "--feature-extractor", "clip_b32",
            "--clip-model-dir", weights["clip_b32"], "--merges", merges))
        with open(os.path.join(fake, "score.txt")) as f:
            score = f.read()
        if not (score.startswith("CLIP score: ") and "FID_256px: " in score):
            fail(f"eval_fid_clip clip_b32 score.txt: {score!r}")
        runs.append(f"eval_fid_clip clip_b32 {numbers(score)} {s:.1f} s")
        out, s = finish(start(
            "eval_fid_clip", "--fake_dir", fake, "--ref_dir", imgs,
            "--feature-extractor", "fid_inception", "--inception-ckpt",
            weights["inception"]))
        with open(os.path.join(fake, "score.txt")) as f:
            score = f.read()
        runs.append(f"eval_fid_clip fid_inception {numbers(score)} {s:.1f} s")
        # collected after the fid runs: done within these seconds
        out, s = finish(side[0])
        runs.append(f"eval_prec_recall vgg16_jax {numbers(out)} within "
                    f"{s:.1f} s")
        out, s = finish(side[1])
        runs.append(f"eval_hpsv2 pinned ViT-H/14 {numbers(out)} within "
                    f"{s:.1f} s")
    finally:
        for _, _, p in side:
            if p.poll() is None:
                p.kill()
                p.wait()
    log(f"evals (e) [{card}] the eval CLIs as subprocesses over {n_fake} "
        f"generated ({len(repo_pngs)} from generated_images) against "
        f"{EVAL_PNGS} seeded images, random .npz weights, synthetic merges "
        f"(process included; eval_prec_recall and eval_hpsv2 beside the two "
        f"eval_fid_clip runs, each time with the others' load): "
        + "; ".join(runs)
        + f" ({time.perf_counter() - t:.1f} s)")
    for name in list(weights.values()) + [vq_path]:
        os.remove(name)


# ---------------------------------------------------------------------------
# parallel: the (dp, tp) mesh on torch.distributed
# ---------------------------------------------------------------------------

def phase_selftest(torch) -> dict:
    """The kernel self-test (``ops/selftest.run_kernel_selftest``) on the
    card: K1-K4 through the dispatching ops against independent dense
    forms, and deferred against rollback commit token for token; raises on
    divergence."""
    from lantern_tpu_torch.ops.selftest import run_kernel_selftest

    errs = run_kernel_selftest(device="cuda")
    log(f"selftest: {errs}")
    return errs


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_spawn(part: str, world: int) -> list:
    """Run ``world`` rank processes of this script (``--parallel-rank
    part``) with ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``
    and ``LOCAL_RANK=0`` (the one card), within ``PARALLEL_TIMEOUT``; fail
    on a non-zero exit or a timeout (every rank killed).  Returns each
    rank's result record."""
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   LOCAL_RANK="0")
        path = os.path.join(PARALLEL_DIR, f"{part}_{r}.json")
        if os.path.exists(path):
            os.remove(path)
        logf = open(os.path.join(PARALLEL_DIR, f"{part}_{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             part], env=env, stdout=logf, stderr=subprocess.STDOUT), logf))
    t0 = time.perf_counter()
    deadline = t0 + PARALLEL_TIMEOUT
    failed = []
    for r, (p, logf) in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            p.wait()
            failed.append(f"rank {r} timed out after {PARALLEL_TIMEOUT} s")
        logf.close()
        if p.returncode:
            with open(logf.name) as f:
                tail = f.read()[-3000:]
            failed.append(f"rank {r} exited {p.returncode}:\n{tail}")
    for p, _ in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    if failed:
        fail(f"parallel {part}: " + "\n".join(failed))
    log(f"  [{part}] {world} rank(s) done in {time.perf_counter() - t0:.1f} s")
    out = []
    for r in range(world):
        with open(os.path.join(PARALLEL_DIR, f"{part}_{r}.log")) as f:
            for line in f:
                if line.startswith("rank "):
                    log(f"  [{part}] {line.rstrip()}")
        with open(os.path.join(PARALLEL_DIR, f"{part}_{r}.json")) as f:
            out.append(json.load(f))
    return out


def write_rank_result(part: str, rank: int, rec: dict) -> None:
    with open(os.path.join(PARALLEL_DIR, f"{part}_{rank}.json"), "w") as f:
        json.dump(rec, f)


def lumina_cfg(grid: int = 16, kv_heads: int | None = None,
               layers: int | None = None):
    """Lumina-7B (Chameleon geometry, swin norm) sized for the main path's
    lane at ``grid``; ``kv_heads``: its grouped-query form with that many
    KV heads (``lumina_gqa8`` at 8); ``layers``: cut to its first
    ``layers`` layers."""
    from lantern_tpu_torch import configs

    cfg = configs.chameleon_7b_config(max_seq_len=lane_dims(grid)[1],
                                      swin_norm=True)
    if kv_heads is not None:
        cfg = cfg.replace(num_kv_heads=kv_heads)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def lumina_lane(torch, grid: int = 16, keep=None, kv_heads=None,
                layers=None):
    """The stale + deferred main path at ``grid``, pinned (``pin = 0.5``):
    Lumina-7B's random int8 weights from seed 0 (the main path's) with the
    shifted nearest table, ``(cfg, params, prompt, fsm, tree, ecfg,
    kept)``; ``keep(dense)`` sees the dense split weights before they are
    fused and quantized, and its value comes back as ``kept``;
    ``kv_heads``, ``layers``: as ``lumina_cfg``'s."""
    from lantern_tpu_torch import trees
    from lantern_tpu_torch.engine import spec
    from lantern_tpu_torch.models import chameleon as cham
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops.acceptance import LanternSpec
    from lantern_tpu_torch.ops.quant import quantize_params
    from lantern_tpu_torch.ops.sampling import LogitsWarp
    from lantern_tpu_torch.ops.vq_distance import nearest_latents

    cfg = lumina_cfg(grid, kv_heads, layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dense = tfm.init_params(gen, cfg, device="cuda")
    kept = keep(dense) if keep is not None else None
    params = quantize_params(tfm.fuse_params(dense))
    del dense
    cb = torch.randn((8192, 8), generator=gen, device="cuda")
    near = cham.shift_nearest_table(nearest_latents(cb, k=11), cfg.vocab_size)
    params["nearest_latents"] = torch.as_tensor(near, device="cuda")
    tp = cham.lumina_token_prompt(TEXT, grid=(grid, grid))
    fsm = cham.LuminaGridFSM(w=grid, h=grid, image_start_idx=len(TEXT),
                             vocab_size=cfg.vocab_size)
    tree = trees.get_tree(os.path.join("ckpts", "bench_tree_lumina.json"))
    ecfg = spec.SpecDecodeConfig(
        warp=LogitsWarp(temperature=1.0, top_k=2000, top_p=1.0),
        cfg_scale=3.0, lantern=LanternSpec(k=10, delta=5.0),
        max_new=lane_dims(grid)[0], kv_quant=True, walk_batch_warp=True,
        stale_draft=True, deferred_commit=True, pin=0.5)
    torch.cuda.synchronize()
    return cfg, params, tp, fsm, tree, ecfg, kept


def stale_launches(cfg, tree, steps: int) -> dict:
    """The derived launches of a stale + deferred Lumina run of ``steps``
    verify steps: no drafter, one K3 a forward (a step's forward commits
    the previous step's rows), no K4."""
    return spec_launches(cfg.num_layers, len(TEXT) + 3, steps, tree.num_nodes,
                         tree.path_len,
                         [len(lv.child_flat_idx) for lv in tree.levels],
                         deferred=True, stale=True)[0]


def rank_nccl(torch) -> None:
    """(a) A world of one on NCCL: ``init_distributed()`` from the
    environment, ``Mesh(dp=1, tp=1)``, and the pinned stale + deferred
    Lumina-7B path at 16x16 (its first ``PARALLEL_TOKENS`` tokens) under
    ``set_mesh`` against the same run without it."""
    import dataclasses

    from lantern_tpu_torch.engine import spec
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.parallel import dist
    from lantern_tpu_torch.parallel import mesh as pm

    info = dist.init_distributed()
    backend = torch.distributed.get_backend()
    mesh = pm.make_mesh()
    cfg, params, tp, fsm, tree, ecfg, _ = lumina_lane(
        torch, layers=PARALLEL_LUMINA_LAYERS)
    ecfg = dataclasses.replace(ecfg, max_new=PARALLEL_TOKENS)

    def run():
        return spec.generate(params, ecfg, cfg, tree, tp,
                             torch.Generator(device="cuda").manual_seed(8),
                             logits_fn=fsm)

    def counted(fn):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, dict(_cuda.LAUNCHES)

    spec.generate(params, dataclasses.replace(ecfg, max_new=8), cfg, tree,
                  tp, torch.Generator(device="cuda").manual_seed(8),
                  logits_fn=fsm)                      # warm-up
    alone, t_alone, alone_launches = counted(run)
    with pm.set_mesh(mesh):
        meshed, t_mesh, launches = counted(run)
    write_rank_result("nccl", 0, dict(
        backend=backend, world=info["num_processes"],
        device=str(info["local_devices"][0]), mesh=[mesh.dp, mesh.tp],
        equal=bool(torch.equal(alone.tokens, meshed.tokens)
                   and alone.steps == meshed.steps),
        n_valid=int(meshed.n_valid), steps=int(meshed.steps), wall=t_mesh,
        wall_alone=t_alone, launches=launches, alone_launches=alone_launches,
        want=stale_launches(cfg, tree, int(meshed.steps)),
        host_mean=dist.host_mean(3.0), train=train_bit_equal(torch)))
    torch.distributed.destroy_process_group()


def _flat(tree) -> dict:
    from lantern_tpu_torch.train.optim import flatten

    return dict(zip(*flatten(tree)))


def train_bit_equal(torch) -> dict:
    """(a)'s training half: on a tiny f32 LlamaGen (token-only rows, two
    steps, the first at lr 0) the FSDP step at ``Mesh(dp=1, tp=1)`` and
    the pipeline at pp = 1 with one microbatch against
    ``finetune.train_step``, metrics and parameters bit for bit; every
    gather, reduce-scatter and all-reduce of theirs is NCCL's, over groups
    of one."""
    from lantern_tpu_torch import configs
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.parallel import mesh as pm
    from lantern_tpu_torch.parallel import pipeline as pl
    from lantern_tpu_torch.train import finetune as ft

    cfg = configs.tiny_config(cond_kind="label", vocab_size=256,
                              hidden_size=256, num_layers=2, num_heads=4)
    gen = torch.Generator(device="cuda").manual_seed(4)
    p0 = tfm.init_params(gen, cfg, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16),
                                     generator=gen, device="cuda"),
             "loss_mask": torch.ones((4, 16), device="cuda")}
    rope = tfm.make_rope_tables(cfg, "cuda")
    fcfg = ft.FinetuneConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    fmesh, pmesh = pm.make_mesh(), pl.make_mesh()
    ref = ft.init_state(_tree_to(p0, "cuda"), fcfg)
    fsdp = ft.init_state(_tree_to(p0, "cuda"), fcfg, mesh=fmesh)
    params = _tree_to(p0, "cuda")
    staged = params.pop("layers")
    step_fn, init_fn = pl.make_train_step(cfg, pmesh, 1, rope, fcfg)
    opt = init_fn(params, staged)
    equal = {"fsdp": True, "pipeline": True}
    for _ in range(2):
        ref, mr = ft.train_step(ref, cfg, fcfg, rope, batch)
        fsdp, mf = ft.train_step(fsdp, cfg, fcfg, rope, batch, mesh=fmesh)
        params, staged, opt, mp = step_fn(params, staged, opt, batch)
        equal["fsdp"] &= all(torch.equal(mf[k], mr[k]) for k in mr)
        equal["pipeline"] &= all(torch.equal(mp[k], mr[k]) for k in mr)
    want = _flat(ref.params)
    for name, got in (("fsdp", _flat(ft.fsdp_gather(fsdp, fmesh))),
                      ("pipeline", _flat(dict(params, layers=staged)))):
        equal[name] &= (got.keys() == want.keys() and all(
            torch.equal(got[k], want[k]) for k in want))
    moved = not torch.equal(want["layers/w_down"], p0["layers"]["w_down"])
    return dict(equal, moved=moved, loss=float(mr["loss"]),
                grad_norm=float(mr["grad_norm"]))


def logit_errors(got, ref) -> dict:
    """Per logits block (the prefill's, the verify's): the largest
    difference over the reference's largest magnitude (``max``) and the
    root-mean-square difference over the reference's (``rms``)."""
    out = {"max": [], "rms": []}
    for g, r in zip(got, ref):
        d, r = g.float() - r.float(), r.float()
        out["max"].append(float(d.abs().max() / r.abs().max()))
        out["rms"].append(float(d.norm() / r.norm()))
    return out


def within(errs, tol) -> bool:
    """Every block's error within its tolerance."""
    return all(e <= t for e, t in zip(errs, tol))


@contextlib.contextmanager
def _patched(module, **attrs):
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


# Known-wrong tensor-parallel forwards: a check of the tp forward is only
# as good as its power to tell a wrong layout from the right one, so (b)
# and tests/test_torch_parallel.py run these beside the real forward and
# require each to land above the tolerance the real one meets.  Each
# patches models/transformer.py for the forwards inside it, on every rank
# alike (a rank that skipped a collective the others ran would hang them).
# The third variant is a layout, not a patch: each rank's shard quantized
# on its own gives a row-split kernel the scales of its rows alone, where
# the right layout keeps the full-K column scale (mesh._match_layout).

def skip_wo_reduce(layer: int):
    """The all-reduce after ``wo`` left out on ``layer`` of the first
    forward inside the block (counting the split ``wo`` products in order):
    that layer adds only this rank's partial sum to the residual."""
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops import quant

    seen = [0]
    row = tfm.mm_row

    def mm_row(x, w, name, group):
        if name == "wo" and group is not None:
            seen[0] += 1
            if seen[0] == layer + 1:
                return quant.mm(x, w, name)
        return row(x, w, name, group)

    return _patched(tfm, mm_row=mm_row)


def reduce_after_norm():
    """Every row-split reduce moved past the norm that follows it (Lumina's
    swin post-norms), where the norm must see the sum."""
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops import quant
    from lantern_tpu_torch.parallel import dist as pdist

    pending = [None]
    row, norm = tfm.mm_row, tfm.rms_norm

    def mm_row(x, w, name, group):
        if group is None:
            return row(x, w, name, group)
        pending[0] = group
        return quant.mm(x, w, name)

    def rms_norm(x, w, eps):
        y = norm(x, w, eps)
        group, pending[0] = pending[0], None
        if group is None:
            return y
        return pdist.all_reduce(y.float(), group).to(y.dtype)

    return _patched(tfm, mm_row=mm_row, rms_norm=rms_norm)


@contextlib.contextmanager
def one_split():
    """K1 and K2 at one split each inside the block: the same products
    summed in another order (the reordering floor of a comparison)."""
    from lantern_tpu_torch.ops import quant
    from lantern_tpu_torch.ops import tree_attention as ta

    k1, k2 = quant.k1_splits, ta.k2_splits
    quant.k1_splits = ta.k2_splits = lambda *a, **k: 1
    try:
        yield
    finally:
        quant.k1_splits, ta.k2_splits = k1, k2


def rank_tp2(torch, timer, tag: str) -> None:
    """(b) Lumina-7B at full width (``PARALLEL_LUMINA_LAYERS`` layers) over
    tp = 2: two processes on
    the one card over gloo.  The logits of the prompt's prefill and of a
    tree-verify block against one process on the same weights, the three
    known-wrong variants, the pinned stale + deferred path (64 tokens)
    timed with its collectives' share and peak memory, and K1 / K2 at the
    shard shapes."""
    import dataclasses

    from lantern_tpu_torch.engine import spec
    from lantern_tpu_torch.kv import KVCache
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.ops import _cuda, quant
    from lantern_tpu_torch.parallel import dist
    from lantern_tpu_torch.parallel import mesh as pm

    dist.init_distributed(backend="gloo")
    mesh = pm.make_mesh(dp=1)
    rank = mesh.rank

    def per_shard(dense):
        # this rank's rows of the dense row-split kernels, quantized on
        # their own: the quantize-per-shard variant
        rows = {"layers": {k: dense["layers"][k] for k in ("wo", "w_down")}}
        return quant.quantize_params(pm.shard_pytree(
            rows, pm.base_param_specs(lumina_cfg(), mesh, rows),
            mesh))["layers"]

    # one rank builds at a time: the dense bf16 weights are 13.5 GB
    t0 = time.perf_counter()
    for r in range(mesh.tp):
        if r == rank:
            cfg, full, tp, fsm, tree, ecfg, requant = lumina_lane(
                torch, keep=per_shard, layers=PARALLEL_LUMINA_LAYERS)
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    build_s = time.perf_counter() - t0
    ecfg = dataclasses.replace(ecfg, max_new=PARALLEL_TOKENS)
    # fixed inputs: the prompt block, then a block of image tokens under the
    # tree's mask at the tree's positions
    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = tp.tokens.to("cuda")
    P = ids.shape[1]
    rope = tfm.make_rope_tables(cfg, "cuda")
    N1 = tree.num_nodes
    blk = torch.randint(4, 8196, (2, N1), generator=gen, device="cuda")
    mask = torch.as_tensor(tree.attn_mask, device="cuda")
    pos = P + torch.as_tensor(tree.depth, device="cuda").long()

    def logits(params, m=None):
        with pm.set_mesh(m):
            kv = KVCache.create(cfg, 2, quantized=True, device="cuda",
                                groups=tfm.cache_groups(cfg, params))
            pre = tfm.forward(params, cfg, tfm.token_embed(params, ids), kv,
                              torch.arange(P, device="cuda"), rope)
            ver = tfm.forward(params, cfg, tfm.token_embed(params, blk),
                              pre.kv, pos, rope, block_mask=mask,
                              commit=False)
            return (tfm.logits_head(params, pre.hidden).float(),
                    tfm.logits_head(params, ver.hidden).float())

    def run(params, m=None, max_steps=0):
        with pm.set_mesh(m):
            return spec.generate(
                params, ecfg, cfg, tree, tp,
                torch.Generator(device="cuda").manual_seed(8),
                max_steps=max_steps, logits_fn=fsm)

    ref = logits(full)
    with one_split():
        floor = logit_errors(logits(full), ref)
    ref_run = run(full)
    sp = pm.shard_pytree(full, pm.base_param_specs(cfg, mesh, full), mesh)
    del full
    torch.cuda.empty_cache()
    got = logits(sp, mesh)
    errs = logit_errors(got, ref)
    # the ranks' logits byte for byte (both are gathered over tp)
    other = [g.clone() for g in got]
    for o in other:
        torch.distributed.broadcast(o, src=0)
    ranks_equal = all(torch.equal(a, b) for a, b in zip(got, other))
    wrong = {}
    with skip_wo_reduce(PARALLEL_WRONG_LAYER):
        wrong["skip_wo_reduce"] = logits(sp, mesh)
    with reduce_after_norm():
        wrong["reduce_after_norm"] = logits(sp, mesh)
    wrong["quantize_per_shard"] = logits(
        dict(sp, layers=dict(sp["layers"], **requant)), mesh)
    del requant
    wrong = {k: logit_errors(v, ref) for k, v in wrong.items()}
    # the path: a warm-up, then the run with the counters reset
    run(sp, mesh, max_steps=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    torch.distributed.barrier()
    t = time.perf_counter()
    res = run(sp, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the collectives' share of a step: a separate run with each collective
    # of parallel/dist.py (the forward's all-reduces, the head's gather)
    # timed on the host from a drained card to its end
    spent = [0.0, 0]
    with clocked_collectives(torch, spent):
        torch.distributed.barrier()
        t = time.perf_counter()
        inst = run(sp, mesh, max_steps=PARALLEL_PROFILE_STEPS)
        torch.cuda.synchronize()
        inst_wall = time.perf_counter() - t
    # K1 at the shard shapes and K2 at G / tp groups, one rank at a time
    kernels = {}
    for r in range(mesh.tp):
        if r == rank:
            kernels = parallel_kernels(torch, timer, tag, cfg, tree, mesh.tp)
        torch.distributed.barrier()
    log(f"rank {rank}: build {build_s:.1f} s; logits errs {errs}; one-split "
        f"floor {floor}; known-wrong "
        f"{wrong}; {int(res.steps)} steps in {wall:.2f} s; collectives "
        f"{spent[0]:.3f} s in {spent[1]} calls of {inst_wall:.2f} s over "
        f"{int(inst.steps)} steps; peak {peak:.2f} GiB")
    write_rank_result("tp2", rank, dict(
        rank=rank, build_s=build_s, errs=errs, wrong=wrong, floor=floor,
        ranks_equal=ranks_equal,
        tokens=res.tokens.tolist(), ref_tokens=ref_run.tokens.tolist(),
        n_valid=int(res.n_valid), steps=int(res.steps), wall=wall,
        ms_step=1e3 * wall / max(int(res.steps), 1),
        coll_share=spent[0] / inst_wall, coll_calls=spent[1],
        inst_steps=int(inst.steps),
        inst_ms_step=1e3 * inst_wall / max(int(inst.steps), 1),
        coll_ms_step=1e3 * spent[0] / max(int(inst.steps), 1),
        peak_gib=peak, launches=launches,
        want=stale_launches(cfg, tree, int(res.steps)), kernels=kernels))
    torch.distributed.destroy_process_group()


def parallel_kernels(torch, timer, tag: str, cfg, tree, tp: int) -> dict:
    """K1 at Lumina-7B's tp-shard weight shapes (the row splits with f32
    partials) at the AR and verify rows, and K2 at ``G / tp`` groups,
    against their plain versions with times, bounds and library times; and
    K2 on ``G / tp`` groups at the split count of ``G`` equal bit for bit
    to those groups of the launch over all ``G``."""
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.ops.tree_attention import (k2_splits,
                                                      tree_attention_launch)

    H, I, V, hd = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.head_dim)
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = {"wqkv": (H, 3 * H // tp, bf16), "wo": (H // tp, H, f32),
              "w_gu": (H, 2 * I // tp, bf16), "w_down": (I // tp, H, f32),
              "lm_head": (H, V // tp, f32)}
    kp = KernelPhase(torch, timer, tag)
    N1 = tree.num_nodes
    rows = (2, 2 * N1)
    k1_err, k1_rec = 0.0, None
    for name, (K, N, dt) in shapes.items():
        err, rec, _, _ = kp.k1_shape(name, K, N, rows,
                                     rows[1] if name == "w_down" else None,
                                     f"tp={tp} shard ", out_dt=dt)
        k1_err, k1_rec = max(k1_err, err), rec or k1_rec
    G = cfg.num_kv_heads * hd // 128 // tp
    S = -(-cfg.max_seq_len // 128) * 128
    mask = torch.as_tensor(tree.attn_mask, device="cuda")[None]
    length = len(TEXT) + 3 + 120
    k2 = k2_tool_case(torch, timer, tag, f"K2 tp={tp} shard B=2 G={G} S={S} "
                      f"T={N1} length={length} int8 KV", G, hd, S, N1,
                      length, mask, quant=True)
    # the split count of the whole model's groups on this rank's: each
    # (row, group) block is independent, so the groups agree bit for bit
    gen = torch.Generator(device="cuda").manual_seed(11)
    Gf = G * tp
    q, kn, vn = (torch.randn((2, N1, Gf, hd), generator=gen,
                             device="cuda").bfloat16() for _ in range(3))
    kc, vc = (torch.randint(-127, 128, (2, Gf, S, 128), generator=gen,
                            device="cuda", dtype=torch.int8)
              for _ in range(2))
    ks, vs = (torch.rand((2, Gf, S), generator=gen, device="cuda") * 0.02
              for _ in range(2))
    ln = torch.tensor(length, dtype=torch.int32, device="cuda")
    bm = mask.expand(2, N1, N1).contiguous()
    bias = torch.zeros((2, S), device="cuda")
    nsplit = k2_splits(2, Gf, S, N1, _cuda.sm_count(q.device))

    def heads(x):                     # [B, T, Gf, hd] -> this rank's G
        return x[:, :, :G].contiguous()

    def groups(x):                    # [B, Gf, S, ...] -> this rank's G
        return x[:, :G].contiguous()

    whole = tree_attention_launch(q, kn, vn, kc, vc, ln, bm, bias,
                                  hd ** -0.5, nsplit, k_scale=ks, v_scale=vs)
    part = tree_attention_launch(
        heads(q), heads(kn), heads(vn), groups(kc), groups(vc), ln, bm, bias,
        hd ** -0.5, nsplit, k_scale=groups(ks), v_scale=groups(vs))
    torch.cuda.synchronize()
    same = bool(torch.equal(whole[:, :, :G], part))
    log(f"K2 tp={tp} shard at the split count of G={Gf} ({nsplit}, where "
        f"k2_splits gives G={G} "
        f"{k2_splits(2, G, S, N1, _cuda.sm_count(q.device))}): "
        f"{'equal' if same else 'NOT equal'} bit for bit to the first {G} "
        f"groups of the launch over all {Gf} [{tag}]")
    return {"int8_matmul": dict(k1_rec, max_abs_err=k1_err),
            "tree_attention": k2, "k2_split_equal": same}


def batched_serving(torch, xl: dict, n_tokens: int):
    """``(serve, alone)``.  ``serve(n, mesh=None, tokens=n_tokens)``: the
    batched XL configuration (``chain_bush_8``, static, rollback, int8 KV,
    LANTERN k=10 delta=5, top-2000, cfg 3.0) on ``BATCH_SLOTS`` slots
    through ``Scheduler`` on the native queue, the first ``n`` captions
    with their seeds; returns ``(requests, batched steps of this rank,
    seconds)``.  ``alone(i)``: request ``i`` through ``spec.generate``
    alone, its ``SpecResult``."""
    import dataclasses

    from lantern_tpu_torch import trees
    from lantern_tpu_torch.engine import spec
    from lantern_tpu_torch.engine.batch import BatchedEngine
    from lantern_tpu_torch.engine.scheduler import Request, Scheduler
    from lantern_tpu_torch.ops.acceptance import LanternSpec
    from lantern_tpu_torch.ops.sampling import LogitsWarp

    ecfg = spec.SpecDecodeConfig(
        warp=LogitsWarp(temperature=1.0, top_k=2000, top_p=1.0),
        cfg_scale=3.0, lantern=LanternSpec(k=10, delta=5.0),
        max_new=n_tokens, kv_quant=True, walk_batch_warp=True)
    caps = [xl["caption"](c) for c in BATCH_CAPTIONS]

    def serve(n, mesh=None, tokens=n_tokens):
        eng = BatchedEngine(ecfg=dataclasses.replace(ecfg, max_new=tokens),
                            cfg=xl["cfg"],
                            tree=trees.get_tree("chain_bush_8"),
                            params=xl["params"], num_slots=BATCH_SLOTS,
                            dparams=xl["dparams"], dcfg=xl["dcfg"], mesh=mesh)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with StepCounter() as steps:
            done = Scheduler(eng).run([
                Request(uid=i, cond=c, uncond=u, prefix_valid=pv,
                        seed=1000 + i)
                for i, (c, u, pv) in enumerate(caps[:n])])
        torch.cuda.synchronize()
        return done, steps.n, time.perf_counter() - t

    def alone(i):
        c, u, pv = caps[i]
        return spec.generate(xl["params"], ecfg, xl["cfg"],
                             trees.get_tree("chain_bush_8"), None,
                             spec.request_generator(1000 + i),
                             dparams=xl["dparams"], dcfg=xl["dcfg"], cond=c,
                             uncond=u, prefix_valid=pv)
    return serve, alone


def results_of(done) -> list:
    return [[r.uid, r.error, None if r.tokens is None else
             [int(t) for t in r.tokens], int(r.steps)] for r in done]


def rank_dp2(torch) -> None:
    """(c) LlamaGen-XL over dp = 2: two processes on the card over gloo,
    each serving its share of the 12 batched requests (request ``i`` on
    rank ``i % 2``) on 4 of the 8 slots through ``Scheduler`` on the native
    queue; every rank gets every result."""
    from lantern_tpu_torch.ops import _cuda
    from lantern_tpu_torch.parallel import dist
    from lantern_tpu_torch.parallel import mesh as pm

    dist.init_distributed(backend="gloo")
    mesh = pm.make_mesh(dp=2)
    xl = build_xl(torch)
    serve, _ = batched_serving(torch, xl, PARALLEL_TOKENS)
    serve(4, mesh, tokens=4)                  # warm-up: two requests a rank
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    torch.distributed.barrier()
    done, n_steps, wall = serve(len(BATCH_CAPTIONS), mesh)
    launches = dict(_cuda.LAUNCHES)
    log(f"rank {mesh.rank}: {n_steps} batched steps in {wall:.2f} s")
    write_rank_result("dp2", mesh.rank, dict(
        rank=mesh.rank, dp_rank=mesh.dp_rank, wall=wall, n_steps=n_steps,
        results=results_of(done),
        mine=list(range(mesh.dp_rank, len(BATCH_CAPTIONS), mesh.dp)),
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        launches=launches))
    torch.distributed.destroy_process_group()


def leaf_err(got, want, scale=None) -> float:
    """``|got - want|`` (RMS) over ``scale`` (default ``|want|``); 0 where
    both are zero."""
    d = float((got.float() - want.float()).norm())
    n = float(want.float().norm()) if scale is None else scale
    return d / n if n else d


def tree_err(got: dict, want: dict, scale: dict | None = None) -> list:
    """``[error, leaf]``: the largest ``leaf_err`` over the leaves of two
    ``{path: tensor}`` dicts (``scale``: each leaf's denominator)."""
    errs = [(leaf_err(got[k], want[k], None if scale is None else scale[k]),
             k) for k in want]
    return list(max(errs))


def xl_dense(torch):
    """LlamaGen-XL t2i (1280 wide, 20 heads of 64, vocab 16384) cut to its
    first ``PARALLEL_TRAIN_LAYERS`` layers, with dense bf16 weights from
    seed 0 on the card."""
    from lantern_tpu_torch import configs
    from lantern_tpu_torch.models import transformer as tfm

    cfg = configs.llamagen_config("XL", "t2i", image_tokens=256).replace(
        num_layers=PARALLEL_TRAIN_LAYERS)
    return cfg, tfm.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg, device="cuda")


def split_grads(torch, params, cfg, rope, batch, fcfg, parts: int):
    """``(loss, {path: grad})`` of one process's finetune loss with the
    batch's rows in ``parts`` equal parts, each part's backward alone
    (its NLL sum over the whole batch's mask count), summed in part order:
    ``parts = 1`` is ``train_step``'s gradient, more the reordering
    floor."""
    from lantern_tpu_torch.train import finetune as ft
    from lantern_tpu_torch.train.optim import flatten, unflatten

    paths, leaves = flatten(params)
    count = torch.sum(batch["loss_mask"][:, 1:])
    b = batch["tokens"].shape[0] // parts
    loss, grads = 0.0, None
    for i in range(parts):
        rows = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        with torch.enable_grad():
            live = [x.detach().requires_grad_() for x in leaves]
            nll = ft.token_sums(unflatten(params, paths, live), cfg, rope,
                                rows, fcfg)[0]
            part = nll / (count + 1e-6)
            g = torch.autograd.grad(part, live, allow_unused=True)
        g = [torch.zeros_like(x) if y is None else y
             for x, y in zip(leaves, g)]
        grads = g if grads is None else [a + c for a, c in zip(grads, g)]
        loss = loss + part.detach()
    return loss, dict(zip(paths, grads))


def split_steps(torch, params, cfg, rope, batch, fcfg, parts: int,
                steps: int = 2, keep_grads: bool = False):
    """``steps`` finetune steps of one process on a copy of ``params``,
    each from ``split_grads`` at ``parts`` (``parts = 1``: ``train_step``'s
    arithmetic): ``(losses, grad norms, {path: params after}, {path: the
    first step's gradients} or None)``."""
    from lantern_tpu_torch.train import finetune as ft
    from lantern_tpu_torch.train.optim import flatten, global_norm

    p = _tree_to(params, "cuda")
    paths, leaves = flatten(p)
    opt = ft.build_optimizer(fcfg, p)
    state = opt.init(leaves)
    losses, norms, first = [], [], None
    for i in range(steps):
        loss, g = split_grads(torch, p, cfg, rope, batch, fcfg, parts)
        if keep_grads and i == 0:
            first = {k: v.clone() for k, v in g.items()}
        grads = [g[k] for k in paths]
        losses.append(float(loss))
        norms.append(float(global_norm(grads)))
        state = opt.update(leaves, grads, state)
    return losses, norms, dict(zip(paths, leaves)), first


def clocked_collectives(torch, spent: list):
    """The collectives of ``parallel/dist.py`` timed on the host from a
    drained card to their end (``spent``: seconds, calls); a pipeline's
    receive includes its wait for the other stage."""
    from lantern_tpu_torch.parallel import dist as pdist

    def clocked(fn):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            spent[1] += 1
            return out
        return inner

    names = ("all_gather", "reduce_scatter", "all_reduce", "send", "recv")
    return _patched(pdist, **{n: clocked(getattr(pdist, n)) for n in names})


def train_part_pipeline(torch, rank: int, batch) -> dict:
    """(d) GPipe over pp = 2 (18 layers a stage), ``TRAIN_MICRO``
    microbatches, LlamaGen-XL's bf16 weights: loss and gradients (both
    ranks' stage gradients gathered) against one process's, the two
    known-wrong variants, then two ``make_train_step`` steps (the first at
    lr 0) against one process's ``train_step`` s, timed, with peak memory;
    a third step with its collectives timed.  Rank 0 holds the one-process
    references and computes the errors; the known-wrong variants are held
    against them on rank 0's own leaves (stage 0's layers, the replicated
    leaves), which a miss needs no more of."""
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.parallel import dist as pdist
    from lantern_tpu_torch.parallel import pipeline as pl
    from lantern_tpu_torch.train import finetune as ft
    from lantern_tpu_torch.train.optim import flatten

    cfg, P = xl_dense(torch)
    rope = tfm.make_rope_tables(cfg, "cuda")
    fcfg = ft.FinetuneConfig(lr=PIPE_LR, warmup_steps=1, total_steps=100,
                             remat=True)
    out, ref = {}, {}
    if rank == 0:
        losses, _, p1, g = split_steps(torch, P, cfg, rope, batch, fcfg, 1,
                                       keep_grads=True)
        flosses, _, pf, fg = split_steps(torch, P, cfg, rope, batch, fcfg,
                                         TRAIN_MICRO, keep_grads=True)
        p0 = _flat(P)
        ref = dict(loss=losses[0], grads=g, delta={
            k: float((p1[k].float() - p0[k].float()).norm()) for k in p1})
        out["floor"] = dict(loss=abs(flosses[0] - losses[0]) / losses[0],
                            grads=tree_err(fg, g),
                            params=tree_err(pf, p1, ref["delta"]))
        ref["params"] = {k: v.cpu() for k, v in p1.items()}
        del p1, pf, p0, fg
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    mesh = pl.make_mesh(dp=1)
    loss_fn = pl.pipeline_loss_fn(cfg, mesh, TRAIN_MICRO, rope, remat=True)
    rest = {k: v for k, v in P.items() if k != "layers"}
    stages = pl.split_stages(P["layers"], mesh.pp)

    def grads(staged, whole=True):
        """The loss, and the whole model's gradients (``whole``: both
        stages' gathered) or this rank's."""
        (loss, _), (gp, gs) = pl.value_and_grad(loss_fn, mesh, rest, staged,
                                                batch)
        g = _flat(gp)
        g.update({f"layers/{k}": pdist.all_gather(v, 0, mesh.pp_group)
                  if whole else v for k, v in gs.items()})
        return loss, g

    def no_pp_sum(grads, sharded, dp_group):
        # known-wrong: the replicated leaves' gradients left on the stage
        # that made them (summed over dp only)
        for x in grads:
            pdist.all_reduce(x, dp_group)

    def stage(s: int) -> dict:
        return {k: v[s].clone() for k, v in stages.items()}

    loss, g = grads(stage(mesh.stage))
    both = pdist.all_gather(loss.reshape(1), 0)
    out["losses_equal"] = bool(both[0] == both[1])
    out["loss"] = float(loss)
    wrong = {}
    with _patched(ft, sum_grads_=no_pp_sum):
        wrong["replicated_not_summed_over_pp"] = grads(stage(mesh.stage),
                                                       whole=False)[1]
    wrong["stages_swapped"] = grads(stage(1 - mesh.stage), whole=False)[1]
    if rank == 0:
        Ls = cfg.num_layers // mesh.pp
        mine = {k: v[:Ls] if k.startswith("layers/") else v
                for k, v in ref["grads"].items()}
        out["err"] = dict(loss=abs(float(loss) - ref["loss"]) / ref["loss"],
                          grads=tree_err(g, ref["grads"]))
        out["wrong"] = {k: tree_err(v, mine) for k, v in wrong.items()}
        del mine
    ref.pop("grads", None)
    del g, wrong, P
    # the steps, from this rank's own leaves only
    params = _tree_to(rest, "cuda")
    staged = stage(mesh.stage)
    del rest, stages
    torch.cuda.empty_cache()
    step_fn, init_fn = pl.make_train_step(cfg, mesh, TRAIN_MICRO, rope, fcfg)
    opt = init_fn(params, staged)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.distributed.barrier()
    times, metrics = [], []
    for _ in range(2):
        t = time.perf_counter()
        params, staged, opt, m = step_fn(params, staged, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    got = _flat(params)
    got.update({f"layers/{k}": pdist.all_gather(v, 0, mesh.pp_group)
                for k, v in staged.items()})
    if rank == 0:
        want = {k: v.to("cuda") for k, v in ref["params"].items()}
        out["err"]["params"] = tree_err(got, want, ref["delta"])
        del want
    del got
    spent = [0.0, 0]
    with clocked_collectives(torch, spent):
        torch.distributed.barrier()
        t = time.perf_counter()
        step_fn(params, staged, opt, batch)
        torch.cuda.synchronize()
        inst = time.perf_counter() - t
    out.update(ms_step=1e3 * times[1], first_ms=1e3 * times[0],
               metrics=metrics, coll_share=spent[0] / inst,
               coll_calls=spent[1], inst_ms=1e3 * inst,
               n_params=sum(x.numel() for x in flatten(params)[1]
                            + flatten(staged)[1]))
    return out


def leaf_errs(got: dict, want: dict, scale: dict) -> dict:
    """``{leaf: leaf_err}`` over the leaves of two ``{path: tensor}``
    dicts, each over its ``scale``."""
    return {k: leaf_err(got[k], want[k], scale[k]) for k in want}


def train_part_fsdp(torch, rank: int, batch) -> dict:
    """(e) FSDP over tp = 2: a whole-base finetune step of LlamaGen-XL's
    bf16 weights with the weights and AdamW state sharded
    (``init_state(mesh=)``, ``train_step(mesh=)``), clipped by ``FSDP_CLIP``
    (biting): two steps (the first at lr 0) timed, with peak memory, their
    loss, grad norm and gathered parameters against one process's, each
    leaf against its own floor; then two known-wrong variants from the
    same weights (rank 0's slices against one process's): the clip by the
    shard's own norm, its second step with the collectives timed (the
    right step's collectives but the tp all-reduce of the squared norms),
    and the tp reduce-scatter replaced by the rank's own gradient."""
    from lantern_tpu_torch.models import transformer as tfm
    from lantern_tpu_torch.parallel import dist as pdist
    from lantern_tpu_torch.parallel import mesh as pm
    from lantern_tpu_torch.train import finetune as ft
    from lantern_tpu_torch.train.optim import flatten, global_norm

    cfg, P = xl_dense(torch)
    rope = tfm.make_rope_tables(cfg, "cuda")
    fcfg = ft.FinetuneConfig(lr=FSDP_LR, warmup_steps=1, total_steps=100,
                             remat=True, grad_clip_norm=FSDP_CLIP)
    out, ref = {}, {}
    if rank == 0:
        losses, norms, p1, _ = split_steps(torch, P, cfg, rope, batch, fcfg,
                                           1)
        flosses, fnorms, pf, _ = split_steps(torch, P, cfg, rope, batch,
                                             fcfg, 2)
        p0 = _flat(P)
        ref = dict(loss=losses[0], grad_norm=norms[0], delta={
            k: float((p1[k].float() - p0[k].float()).norm()) for k in p1})
        out["floor"] = dict(
            loss=abs(flosses[0] - losses[0]) / losses[0],
            grad_norm=abs(fnorms[0] - norms[0]) / norms[0],
            params=leaf_errs(pf, p1, ref["delta"]))
        ref["params"] = {k: v.cpu() for k, v in p1.items()}
        del p1, pf, p0
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    mesh = pm.make_mesh(dp=1)

    def run(spent=None):
        """Two FSDP steps from seed 0's weights, the second with its
        collectives clocked into ``spent`` if given: (metrics, times, peak
        GiB, state)."""
        state = ft.init_state(xl_dense(torch)[1], fcfg, mesh=mesh)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch.distributed.barrier()
        metrics, times = [], []
        for i in range(2):
            clock = (clocked_collectives(torch, spent)
                     if spent is not None and i else contextlib.nullcontext())
            with clock:
                t = time.perf_counter()
                state, m = ft.train_step(state, cfg, fcfg, rope, batch,
                                         mesh=mesh)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            metrics.append({k: float(v) for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return metrics, times, peak, state

    del P
    torch.cuda.empty_cache()
    metrics, times, peak, state = run()
    got = _flat(ft.fsdp_gather(state, mesh))
    out.update(metrics=metrics, ms_step=1e3 * times[1],
               first_ms=1e3 * times[0], peak_gib=peak,
               shard_gib=sum(x.numel() * x.element_size()
                             for x in flatten(state.params)[1]) / 2 ** 30)
    if rank == 0:
        want = {k: v.to("cuda") for k, v in ref["params"].items()}
        out["err"] = dict(
            loss=abs(metrics[0]["loss"] - ref["loss"]) / ref["loss"],
            grad_norm=abs(metrics[0]["grad_norm"] - ref["grad_norm"])
            / ref["grad_norm"], params=leaf_errs(got, want, ref["delta"]))
        del want
    del got, state
    torch.cuda.empty_cache()

    def wrong_errs(wstate) -> dict:
        """Rank 0's slices against the same slices of one process's, over
        the whole leaves' updates: a lower bound of each leaf's error."""
        want = {}
        for k, d in zip(flatten(wstate.specs)[0], ft.split_dims(wstate.specs)):
            x = ref["params"][k].to("cuda")
            want[k] = x if d is None else x.narrow(d, 0, x.shape[d] // mesh.tp)
        return leaf_errs(_flat(wstate.params), want, ref["delta"])

    spent = [0.0, 0]
    with _patched(ft, sharded_global_norm=lambda grads, sharded, group:
                  global_norm(grads)):
        wm, wtimes, _, wstate = run(spent)
    out.update(coll_share=spent[0] / wtimes[1], coll_calls=spent[1],
               inst_ms=1e3 * wtimes[1], wrong={})
    if rank == 0:
        out["wrong"]["shard_norm_clip"] = dict(
            grad_norm=wm[0]["grad_norm"], params=wrong_errs(wstate))
    del wstate
    torch.cuda.empty_cache()

    def own_slice(x, dim, group=None):
        """``dist.reduce_scatter`` without the sum: this rank's slice of
        its own gradient, the other ranks' rows left out."""
        w = x.shape[dim] // torch.distributed.get_world_size(group)
        return x.narrow(dim, torch.distributed.get_rank(group) * w,
                        w).contiguous()

    with _patched(pdist, reduce_scatter=own_slice):
        wm, _, _, wstate = run()
    if rank == 0:
        out["wrong"]["own_gradient"] = dict(
            grad_norm=wm[0]["grad_norm"], params=wrong_errs(wstate))
    return out


def rank_train(torch) -> None:
    """(d) and (e): two processes on the card over gloo, LlamaGen-XL at
    full width (``PARALLEL_TRAIN_LAYERS`` layers), ``TRAIN_ROWS`` token-only
    rows of ``TRAIN_T``
    tokens from seed 1."""
    from lantern_tpu_torch.parallel import dist

    dist.init_distributed(backend="gloo")
    rank = torch.distributed.get_rank()
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, 16384, (TRAIN_ROWS, TRAIN_T),
                                     generator=gen, device="cuda"),
             "loss_mask": torch.ones((TRAIN_ROWS, TRAIN_T), device="cuda")}
    t = time.perf_counter()
    pipe = train_part_pipeline(torch, rank, batch)
    t_pipe = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    fsdp = train_part_fsdp(torch, rank, batch)
    t_fsdp = time.perf_counter() - t
    log(f"rank {rank}: (d) {t_pipe:.1f} s, (e) {t_fsdp:.1f} s")
    write_rank_result("train", rank, dict(rank=rank, pipeline=pipe, fsdp=fsdp,
                                          pipe_s=t_pipe, fsdp_s=t_fsdp))
    torch.distributed.destroy_process_group()


def run_parallel_rank(torch, part: str, card: str, smi: str) -> None:
    """The body of one rank process (``--parallel-rank``)."""
    tag = f"{card}, {smi}"
    if part == "nccl":
        rank_nccl(torch)
    elif part == "tp2":
        rank_tp2(torch, Timer(torch), tag)
    elif part == "dp2":
        rank_dp2(torch)
    else:
        rank_train(torch)


def check_train(outs: list, card: str) -> None:
    """(d) and (e)'s verdicts from both ranks' records (rank 0 holds the
    errors against one process), and their line."""
    k = TRAIN_TOL_FACTOR
    d, e = outs[0]["pipeline"], outs[0]["fsdp"]
    if not all(o["pipeline"]["losses_equal"] for o in outs):
        fail("parallel (d): the two stages' losses differ")
    for part, name in ((d, "d"), (e, "e")):
        if any(o[{"d": "pipeline", "e": "fsdp"}[name]]["metrics"]
               != part["metrics"] for o in outs):
            fail(f"parallel ({name}): the ranks' step metrics differ")
    tol = {"loss": k * max(d["floor"]["loss"], 1e-6),
           "grads": k * d["floor"]["grads"][0],
           "params": k * d["floor"]["params"][0]}
    errs = {"loss": d["err"]["loss"], "grads": d["err"]["grads"][0],
            "params": d["err"]["params"][0]}
    for key, err in errs.items():
        if not err <= tol[key]:
            fail(f"parallel (d): {key} error {err} (vs one process) over "
                 f"{k} x the floor {tol[key] / k}")
    for name, err in d["wrong"].items():
        if err[0] <= tol["grads"]:
            fail(f"parallel (d): the known-wrong variant {name} errs "
                 f"{err}, within the tolerance {tol['grads']}")
    etol = {"loss": k * max(e["floor"]["loss"], 1e-6),
            "grad_norm": k * max(e["floor"]["grad_norm"], 1e-6)}
    eerr = {"loss": e["err"]["loss"], "grad_norm": e["err"]["grad_norm"]}
    for key, err in eerr.items():
        if not err <= etol[key]:
            fail(f"parallel (e): {key} error {err} (vs one process) over "
                 f"{k} x the floor {etol[key] / k}")
    # the parameters leaf by leaf, each within k x its own floor
    ptol = {n: k * max(f, FSDP_LEAF_FLOOR_MIN)
            for n, f in e["floor"]["params"].items()}

    def over(errs: dict) -> list:
        """``[(error / tolerance, leaf)]`` of the leaves over tolerance."""
        return sorted(((v / ptol[n], n) for n, v in errs.items()
                       if not v <= ptol[n]), reverse=True)

    perr = e["err"]["params"]
    if over(perr):
        fail(f"parallel (e): parameters (vs one process) over {k} x their "
             f"leaves' floors: {over(perr)}")
    # the leaf nearest its tolerance; of those as near, the largest error
    pworst = max((v / ptol[n], v, n) for n, v in perr.items())
    pmed = statistics.median(perr.values())
    fmed = statistics.median(e["floor"]["params"].values())
    missed = {}
    for name, w in e["wrong"].items():
        missed[name] = over(w["params"])
        if not missed[name]:
            fail(f"parallel (e): the known-wrong variant {name} errs "
                 f"{w['params']}, every leaf within its tolerance")
    bubble = (2 - 1) / (TRAIN_MICRO + 2 - 1)
    peaks = ", ".join(f"{o['pipeline']['peak_gib']:.2f}" for o in outs)
    log(f"parallel (d) [{card}] GPipe over pp = 2 "
        f"({PARALLEL_TRAIN_LAYERS // 2} of LlamaGen-XL's first "
        f"{PARALLEL_TRAIN_LAYERS} layers a stage, full width, bf16 weights), "
        f"two ranks on the one "
        f"card over gloo, {TRAIN_ROWS} x {TRAIN_T} token-only rows in "
        f"{TRAIN_MICRO} microbatches, remat: loss {d['loss']:.6f}, equal on "
        f"both ranks; against one process (largest relative RMS over the "
        f"leaves): loss {errs['loss']:.2e}, gradients {errs['grads']:.2e} "
        f"({d['err']['grads'][1]}), parameters after two steps (lr 0, then "
        f"{PIPE_LR}; over one process's update) {errs['params']:.2e} "
        f"({d['err']['params'][1]}), within {k} x the floor (one process's "
        f"{TRAIN_MICRO} microbatches' gradients summed against the whole "
        f"batch's) {d['floor']['loss']:.2e} / {d['floor']['grads'][0]:.2e} / "
        f"{d['floor']['params'][0]:.2e}; known-wrong variants "
        + ", ".join(f"{n} {v[0]:.2e} ({v[1]})" for n, v in d["wrong"].items())
        + f"; {d['ms_step']:.1f} ms a step (the first {d['first_ms']:.1f}); "
        f"collectives (send / recv waits included) "
        f"{100 * d['coll_share']:.1f} % of an instrumented step "
        f"({d['inst_ms']:.1f} ms, {d['coll_calls']} calls, each timed from "
        f"a drained card); the bubble's expected share (pp - 1) / (n_micro "
        f"+ pp - 1) = {100 * bubble:.1f} %; peak memory a rank {peaks} GiB "
        f"(one process's XL finetune step: 10.50 GiB, PERF.md §5)")
    peaks = ", ".join(f"{o['fsdp']['peak_gib']:.2f}" for o in outs)
    wrong = "; ".join(
        f"{name} (grad norm {w['grad_norm']:.4f}) over tolerance on "
        f"{len(missed[name])} of {len(w['params'])} leaves, worst "
        f"{missed[name][0][1]} at {missed[name][0][0]:.1f} x (within: "
        f"{sorted(set(w['params']) - {n for _, n in missed[name]})})"
        for name, w in e["wrong"].items())
    log(f"parallel (e) [{card}] FSDP over tp = 2 (weights and AdamW state "
        f"sharded, {e['shard_gib']:.2f} GiB of parameters a rank), a "
        f"LlamaGen-XL ({PARALLEL_TRAIN_LAYERS} layers) finetune step, two "
        f"ranks on the one card "
        f"over gloo, {TRAIN_ROWS // 2} rows a rank, remat, clip "
        f"{FSDP_CLIP} (biting: the gradient's norm is "
        f"{e['metrics'][0]['grad_norm']:.4f}), lr 0 then {FSDP_LR}: loss "
        f"{e['metrics'][0]['loss']:.6f}; against one process: loss "
        f"{eerr['loss']:.2e}, grad norm {eerr['grad_norm']:.2e}, within "
        f"{k} x the floor (the two ranks' rows' gradients summed in one "
        f"process) {e['floor']['loss']:.2e} / "
        f"{e['floor']['grad_norm']:.2e}; parameters after two steps (relative "
        f"RMS over one process's update) each leaf within {k} x its own "
        f"floor (at least {FSDP_LEAF_FLOOR_MIN}): worst {pworst[2]} "
        f"{pworst[1]:.2e} against the floor "
        f"{e['floor']['params'][pworst[2]]:.2e} ({k * pworst[0]:.2f} x), "
        f"median leaf {pmed:.2e} against the median floor {fmed:.2e}; "
        f"known-wrong (rank 0's slices): {wrong}; "
        f"{e['ms_step']:.1f} ms a step (the first {e['first_ms']:.1f}); "
        f"collectives {100 * e['coll_share']:.1f} % of an instrumented step "
        f"(the clip variant's second step, {e['inst_ms']:.1f} ms, "
        f"{e['coll_calls']} calls); peak memory a "
        f"rank {peaks} GiB (one process: 10.50 GiB, PERF.md §5); rank "
        f"seconds "
        + ", ".join(f"{o['pipe_s']:.1f} + {o['fsdp_s']:.1f}" for o in outs))


def phase_parallel(torch, card: str, xl: dict | None, train_only=False):
    """(a) NCCL in a world of one, (b) Lumina-7B over tp = 2, (c)
    LlamaGen-XL over dp = 2, and (d) GPipe over pp = 2 and (e) FSDP over
    tp = 2 training LlamaGen-XL, each in rank processes of this script;
    the two ranks of (b)-(e) share the one card over gloo (NCCL refuses two
    ranks on one device).  ``train_only``: (a), (d) and (e).  Returns the
    paths' launches and the K1 / K2 shard records (None with
    ``train_only``)."""
    from lantern_tpu_torch import trees

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # (a)
    (a,) = parallel_spawn("nccl", 1)
    if a["backend"] != "nccl" or a["world"] != 1 or a["mesh"] != [1, 1]:
        fail(f"parallel (a): backend {a['backend']} world {a['world']} mesh "
             f"{a['mesh']}, want nccl, 1, [1, 1]")
    if not a["equal"] or a["host_mean"] != 3.0:
        fail(f"parallel (a): tokens under set_mesh equal to the run without "
             f"it: {a['equal']}; host_mean(3.0) = {a['host_mean']}")
    if a["launches"] != a["want"] or a["alone_launches"] != a["want"]:
        fail(f"parallel (a) launched {a['launches']} under the mesh and "
             f"{a['alone_launches']} without, its shapes give {a['want']}")
    log(f"parallel (a) [{card}] NCCL world of one on {a['device']} "
        f"(init_distributed() from RANK=0 WORLD_SIZE=1 MASTER_ADDR=127.0.0.1),"
        f" Mesh(dp=1, tp=1): the pinned stale + deferred Lumina-7B path at "
        f"16x16 ({a['n_valid']} tokens, {a['steps']} steps, {a['wall']:.2f} s;"
        f" {a['wall_alone']:.2f} s without the mesh) under set_mesh equals "
        f"the run without it bit for bit; host_mean(3.0) = {a['host_mean']}; "
        f"launches {a['launches']} = the derived counts")
    at = a["train"]
    if not (at["fsdp"] and at["pipeline"] and at["moved"]):
        fail(f"parallel (a): FSDP at Mesh(dp=1, tp=1) bit-equal to "
             f"train_step: {at['fsdp']}; the pipeline at pp = 1: "
             f"{at['pipeline']}; the weights moved: {at['moved']}")
    log(f"parallel (a) [{card}] training over NCCL groups of one: a tiny "
        f"f32 LlamaGen's two steps (loss {at['loss']:.6f}, grad norm "
        f"{at['grad_norm']:.6f}) through the FSDP step at Mesh(dp=1, tp=1) "
        f"and the pipeline at pp = 1 equal finetune.train_step's bit for "
        f"bit (metrics and parameters)")
    launches = {"parallel_nccl": a["launches"]}
    if train_only:
        check_train(parallel_spawn("train", 2), card)
        return launches, None
    # (b)
    outs = parallel_spawn("tp2", 2)
    r0, r1 = outs
    if r0["tokens"] != r1["tokens"]:
        fail("parallel (b): the two tp ranks committed different token "
             "streams")
    for o in outs:
        if not o["ranks_equal"]:
            fail(f"parallel (b) rank {o['rank']}: its logits differ from "
                 f"rank 0's")
        tol = [PARALLEL_TOL_FACTOR * f for f in o["floor"]["rms"]]
        if not within(o["errs"]["rms"], tol):
            fail(f"parallel (b) rank {o['rank']}: prefill / verify logits "
                 f"{o['errs']['rms']} (RMS difference over one process's "
                 f"RMS) over the tolerance {tol} = {PARALLEL_TOL_FACTOR} x "
                 f"the one-split floor")
        for name, e in o["wrong"].items():
            if within(e["rms"], tol):
                fail(f"parallel (b) rank {o['rank']}: the known-wrong variant "
                     f"{name} errs {e['rms']}, within the tolerance {tol}")
        if o["launches"] != o["want"]:
            fail(f"parallel (b) rank {o['rank']} launched {o['launches']}, "
                 f"its shapes give {o['want']}")
        if o["n_valid"] != PARALLEL_TOKENS:
            fail(f"parallel (b) rank {o['rank']} committed {o['n_valid']} of "
                 f"{PARALLEL_TOKENS} tokens")
        if not o["kernels"]["k2_split_equal"]:
            fail("parallel (b): K2 on a rank's groups at the whole model's "
                 "split count differs from those groups of the whole launch")
    n = PARALLEL_TOKENS
    same = sum(int(x == y) for x, y in zip(r0["tokens"][:n],
                                           r0["ref_tokens"][:n]))
    lead = next((i for i, (x, y) in enumerate(zip(r0["tokens"],
                                                  r0["ref_tokens"]))
                 if x != y), n)
    wrong = {k: min(max(o["wrong"][k]["rms"]) for o in outs)
             for k in r0["wrong"]}
    tol = [PARALLEL_TOL_FACTOR * f for f in r0["floor"]["rms"]]
    log(f"parallel (b) [{card}] Lumina-7B ({PARALLEL_LUMINA_LAYERS} of its "
        f"32 layers, full width, int8 "
        f"weights and KV) over tp = 2: two ranks on the one card over gloo "
        f"(NCCL refuses two ranks on one device); prefill / verify logits "
        f"{r0['errs']['rms'][0]:.4f} / {r0['errs']['rms'][1]:.4f} RMS of one "
        f"process's RMS (largest difference {r0['errs']['max'][0]:.4f} / "
        f"{r0['errs']['max'][1]:.4f} of its largest magnitude), within "
        f"{tol[0]:.4f} / {tol[1]:.4f} = {PARALLEL_TOL_FACTOR} x the one-split "
        f"floor {r0['floor']['rms'][0]:.4f} / {r0['floor']['rms'][1]:.4f}; "
        f"the ranks' logits equal byte for byte; the known-wrong variants err "
        f"at least (RMS, the larger block) "
        + ", ".join(f"{k} {v:.3e}" for k, v in wrong.items())
        + f"; the ranks' {n} tokens equal byte for byte, {same} of them equal "
        f"to one process's (the first {lead} in a row); {r0['steps']} steps, "
        f"{r0['ms_step']:.2f} ms a step ({r0['wall']:.2f} s); collectives "
        f"{100 * r0['coll_share']:.1f} % of a step ({r0['coll_ms_step']:.2f} "
        f"of {r0['inst_ms_step']:.2f} ms a step over {r0['inst_steps']} "
        f"steps, {r0['coll_calls']} collectives, each timed from a drained "
        f"card); peak memory a rank {r0['peak_gib']:.2f} / "
        f"{r1['peak_gib']:.2f} GiB; launches {r0['launches']} = the derived "
        f"counts")
    # (c)
    cfg = xl["cfg"]
    serve, alone = batched_serving(torch, xl, PARALLEL_TOKENS)
    serve(2, tokens=4)                         # warm-up
    ref, ref_steps, ref_wall = serve(len(BATCH_CAPTIONS))
    if any(r.error is not None for r in ref):
        fail(f"parallel (c): the one-process run failed a request: "
             f"{[r.error for r in ref]}")
    # phase 8's bar at full depth: batched equals alone, tokens and steps
    for i in PARALLEL_ALONE:
        lone = alone(i)
        if not (np_equal(ref[i].tokens, lone.tokens.cpu().numpy())
                and ref[i].steps == lone.steps):
            fail(f"parallel (c): request {i} batched at full depth took "
                 f"{ref[i].steps} steps, alone {lone.steps}; tokens equal "
                 f"{np_equal(ref[i].tokens, lone.tokens.cpu().numpy())}")
    want_res = results_of(ref)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    outs_c = parallel_spawn("dp2", 2)
    tree = trees.get_tree("chain_bush_8")
    levels = [len(lv.child_flat_idx) for lv in tree.levels]
    for o in outs_c:
        if o["results"] != want_res:
            bad = [w[0] for g, w in zip(o["results"], want_res) if g != w]
            fail(f"parallel (c) rank {o['rank']}: requests {bad} differ from "
                 f"the one-process batched run (uid, error, tokens, steps)")
        want, _ = spec_launches(
            cfg.num_layers, [cfg.cls_token_num] * len(o["mine"]),
            o["n_steps"], tree.num_nodes, tree.path_len, levels,
            deferred=False, slots=BATCH_SLOTS // 2)
        if o["launches"] != want:
            fail(f"parallel (c) rank {o['rank']} launched {o['launches']}, "
                 f"its shapes give {want}")
    toks = len(BATCH_CAPTIONS) * PARALLEL_TOKENS
    wall = max(o["wall"] for o in outs_c)
    log(f"parallel (c) [{card}] LlamaGen-XL (36 layers, full width, int8) "
        f"over dp = 2: two ranks on the one card over gloo, "
        f"{len(BATCH_CAPTIONS)} requests x {PARALLEL_TOKENS} tokens dealt "
        f"i % 2 onto {BATCH_SLOTS // 2} slots a rank (native queue): every "
        f"rank's gathered results equal the one-process batched run on "
        f"{BATCH_SLOTS} slots (uid, tokens, steps), and that run's requests "
        f"{list(PARALLEL_ALONE)} equal spec.generate alone (tokens, steps); "
        f"{toks / wall:.2f} tok/s "
        f"over both ranks ({wall:.2f} s; batched steps "
        f"{[o['n_steps'] for o in outs_c]}) vs {toks / ref_wall:.2f} tok/s "
        f"one process ({ref_wall:.2f} s, {ref_steps} steps); peak memory a "
        f"rank {', '.join(format(o['peak_gib'], '.2f') for o in outs_c)} GiB;"
        f" launches = the derived counts")
    for o in outs:
        launches[f"parallel_tp2_rank{o['rank']}"] = o["launches"]
    for o in outs_c:
        launches[f"parallel_dp2_rank{o['rank']}"] = o["launches"]
    # (d) and (e)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check_train(parallel_spawn("train", 2), card)
    return launches, r0["kernels"]


def tree_map(fn, tree):
    """``fn`` over the tensors of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


PROFILE_SECONDS = [0.0]        # the profiles' cost over the run


def profile(what: str, fn, card: str) -> None:
    """``_profile``, its seconds summed in ``PROFILE_SECONDS``."""
    t = time.perf_counter()
    try:
        _profile(what, fn, card)
    finally:
        PROFILE_SECONDS[0] += time.perf_counter() - t


def _profile(what: str, fn, card: str) -> None:
    """Device time by kernel over one short run (torch.profiler recording
    the device's activity alone: recording the host's too cost the run's
    profiles about 2.5x the seconds on the H100's host, PERF.md §6), and
    the share of the run's wall time the card was busy: the union of the
    device-side events (kernels, copies, fills), so an operator and the
    kernel it launched are counted once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not spans:
        log(f"profile [{card}] {what}: wall {wall / 1e3:.2f} ms, device "
            f"busy not measured (the profiler recorded no device events)")
        return
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    log(f"profile [{card}] {what}: wall {wall / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms ({100 * busy / wall:.1f}% of wall; "
        f"{len(spans)} device events)")
    rows = sorted(((us, n, k) for k, (us, n) in by_name.items()),
                  reverse=True)
    for us, n, key in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  {n:6d}x  {key[:90]}")
    # the port's kernels, also where they fall below the 12 largest
    for name, tag in PORT_KERNELS:
        mine = [r for r in rows if tag in r[2]]
        for us, n, key in mine:
            if (us, n, key) not in rows[:12]:
                log(f"  {us / 1e3:9.3f} ms  {n:6d}x  {key[:90]} (port "
                    f"kernel {name}, below the 12 largest)")
        if not mine:
            log(f"  {0.0:9.3f} ms  {0:6d}x  {name} (port kernel, not "
                f"launched on this path)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=16,
                    help="image latent grid (48 = the bench lane)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the build, kernel and forward phases: "
                         "the short first run of a changed kernel (prints "
                         "no result line)")
    ap.add_argument("--sweep-splits", action="store_true",
                    help="after the build, time K1 and K2 over split counts "
                         "and stop (prints no result line)")
    ap.add_argument("--session-only", action="store_true",
                    help="after the build, run only the session phase "
                         "(prints no result line)")
    ap.add_argument("--tools-only", action="store_true",
                    help="after the build, run only the tools phase "
                         "(prints no result line)")
    ap.add_argument("--train-only", action="store_true",
                    help="after the build, run only the train phase "
                         "(prints no result line)")
    ap.add_argument("--evals-only", action="store_true",
                    help="after the build, run only the evals phase "
                         "(prints no result line)")
    ap.add_argument("--gqa-only", action="store_true",
                    help="after the build, run only the self-test and the "
                         "gqa phase (prints no result line)")
    ap.add_argument("--parallel-only", action="store_true",
                    help="after the build, run only the parallel phase "
                         "(prints no result line)")
    ap.add_argument("--parallel-train-only", action="store_true",
                    help="after the build, run only the self-test and the "
                         "parallel phase's training parts: (a), (d) GPipe "
                         "and (e) FSDP (prints no result line)")
    ap.add_argument("--parallel-rank",
                    choices=("nccl", "tp2", "dp2", "train"),
                    help=argparse.SUPPRESS)   # a rank process of that phase
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this smoke test needs a card")
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    try:
        from lantern_tpu_torch.ops import _cuda
    except ImportError as e:
        fail(f"run from the repository root: {e}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = smi_line()
    if args.parallel_rank:
        run_parallel_rank(torch, args.parallel_rank, card, smi)
        return 0
    log(f"device: {card}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; count {torch.cuda.device_count()}")

    t = time.perf_counter()
    _cuda.library(verbose=True)
    log(f"build: torch.utils.cpp_extension.load of lantern_tpu_torch/csrc "
        f"in {time.perf_counter() - t:.1f} s")

    timer = Timer(torch)
    if args.parallel_train_only:
        t = time.perf_counter()
        phase_selftest(torch)
        log(f"phase selftest: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        phase_parallel(torch, f"{card}, {smi}", None, train_only=True)
        log(f"phase parallel_train: {time.perf_counter() - t:.1f} s")
        log("parallel-train-only run: build, self-test and the parallel "
            "training parts passed")
        return 0
    if args.sweep_splits:
        phase_sweep_splits(torch, timer, f"{card}, {smi}")
        return 0
    tag = f"{card}, {smi}"

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    if args.session_only:
        timed("session", phase_session, torch, tag,
              cut_depth(timed("build_xl", build_xl, torch), CUT_LAYERS),
              timer)
        log("session-only run: build and session phases passed")
        return 0
    if args.tools_only:
        timed("tools", phase_tools, torch, tag,
              cut_depth(timed("build_xl", build_xl, torch), CUT_LAYERS),
              timer)
        log("tools-only run: build and tools phases passed")
        return 0
    if args.train_only:
        timed("train", phase_train, torch, tag,
              timed("build_xl", build_xl, torch))
        log("train-only run: build and train phases passed")
        return 0
    if args.evals_only:
        timed("evals", phase_evals, torch, tag)
        log("evals-only run: build and evals phases passed")
        return 0
    if args.gqa_only:
        timed("selftest", phase_selftest, torch)
        timed("gqa", phase_gqa, torch, tag, timer)
        log("gqa-only run: build, self-test and gqa phases passed")
        return 0
    if args.parallel_only:
        timed("parallel", phase_parallel, torch, tag,
              timed("build_xl", build_xl, torch))
        log("parallel-only run: build and parallel phases passed")
        return 0
    selftest = timed("selftest", phase_selftest, torch)
    records = timed("kernels", phase_kernels, torch, timer, tag, args.grid)
    timed("forward", phase_forward, torch)
    timed("forward_llamagen", phase_forward_llamagen, torch)
    if args.kernels_only:
        log("kernels-only run: build, kernel and forward phases passed")
        return 0
    launches = timed("main_path", phase_main_path, torch, args.grid, tag)
    gqa_launches, gqa = timed("gqa", phase_gqa, torch, tag, timer)
    launches.update(gqa_launches)
    xl = timed("build_xl", build_xl, torch)
    launches.update(timed("xl", phase_xl, torch, tag, xl))
    xl_cut = cut_depth(xl, CUT_LAYERS)
    launches.update(timed("batched_xl", phase_batched, torch, tag, xl_cut))
    parallel_launches, parallel = timed("parallel", phase_parallel, torch,
                                        tag, xl)
    launches.update(parallel_launches)
    session_launches, k2_dynamic = timed("session", phase_session, torch,
                                         tag, xl_cut, timer)
    launches.update(session_launches)
    tools_launches, tools = timed("tools", phase_tools, torch, tag, xl_cut,
                                  timer)
    launches.update(tools_launches)
    launches.update(timed("train", phase_train, torch, tag, xl))
    del xl
    timed("evals", phase_evals, torch, tag)
    launches.update(timed("ragged_lumina", phase_ragged, torch, tag))

    log(f"profiles: {PROFILE_SECONDS[0]:.1f} s")
    kernels = []
    for (name, src, rep), check in zip((
            ("int8_matmul", "lantern_tpu_torch/csrc/int8_matmul.cu",
             "lantern_tpu/ops/quant.py:73"),
            ("tree_attention", "lantern_tpu_torch/csrc/tree_attention.cu",
             "lantern_tpu/ops/pallas/tree_attention.py:181"),
            ("kv_write", "lantern_tpu_torch/csrc/kv_write.cu",
             "lantern_tpu/ops/pallas/kv_update.py:170"),
            ("kv_gather", "lantern_tpu_torch/csrc/kv_gather.cu",
             "lantern_tpu/ops/pallas/kv_update.py:313")),
            ("int8_matmul", "tree_attention", "kv_write", "kv_rollback")):
        r, x, bt = (records["lumina"][name], records["xl"][name],
                    records["batched"][name])
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep,
                        "launches": launches["rollback"][name],
                        "launches_by_path": {
                            path: n[name] for path, n in launches.items()},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        "selftest_max_abs_err": selftest[check],
                        "xl": {k: x[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "shape")},
                        "batched": {k: bt[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "shape")}})
    kernels[1]["dynamic_batched"] = k2_dynamic
    kernels[1]["gqa"] = [dict(r, selftest_max_abs_err=selftest[
        "tree_attention_gqa"]) for r in gqa]
    for k, name in enumerate(("int8_matmul", "tree_attention")):
        for sub, rec in (("tools", tools), ("parallel_tp2", parallel)):
            kernels[k][sub] = {key: rec[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
