"""The traced run's instruments: host spans and shape records from the
benchmark's own wrappers around the calls into each layer of the port, and
the device's kernels from ``torch.profiler`` (CUDA activity alone).

Wrapped where the program looks them up at call time:

- ``BatchedEngine.prefill`` / ``insert`` / ``step`` / ``slot_status`` and
  ``LlamaGenSession.generate_batch`` (class attributes) and
  ``engine.ar.generate_many``: host spans ``prefill``, ``insert``,
  ``step``, ``slot_status``, ``call``, ``ar_chunk``; the times at which
  ``slot_status`` returns; which slots hold a running request (an insert
  starts one, a status at ``max_new`` ends it), so that a step's rows of
  finished slots count as padding;
- ``models.transformer.forward``: a ``forward`` span and the shapes of
  each forward (batch rows, block rows, heads, cache groups and, kept on
  the device until the window closes, each row's cache length, each block
  row's visible block keys and the rows that are not padding);
- ``ops.quant.w8a16_matmul``: every weight matmul's (M, K, N) and output
  width, the calls that K1 serves.

Nothing reads the device inside the window: the device tensors are read
once it has closed.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch


class Tracer:
    def __init__(self):
        self.spans: List[tuple] = []            # (name, t0, t1) host seconds
        self.status_times: List[float] = []
        # (M, K, N, output bytes, forward index or -1, step share or None)
        self.k1: List[tuple] = []
        self.fwd: List[dict] = []
        self.steps = 0
        self.active: Dict[int, bool] = {}
        self.step_frac: Optional[float] = None
        self.deadline = float("inf")
        self.stop = lambda: None
        self._cur_fwd = -1
        self._undo = []
        self.on = False

    # -- wrappers --------------------------------------------------------
    def _span(self, name, fn):
        def wrapped(*a, **k):
            if not self.on:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((name, t0, time.perf_counter()))
        return wrapped

    def _patch(self, owner, attr, new):
        old = getattr(owner, attr)
        setattr(owner, attr, new(old))
        self._undo.append(lambda: setattr(owner, attr, old))

    def install(self):
        from lantern_tpu_torch.engine import ar, batch, session
        from lantern_tpu_torch.models import transformer as tfm
        from lantern_tpu_torch.ops import quant

        BE = batch.BatchedEngine
        self._patch(BE, "prefill", lambda f: self._span("prefill", f))
        self._patch(session.LlamaGenSession, "generate_batch",
                    lambda f: self._span("call", f))
        self._patch(ar, "generate_many", lambda f: self._span("ar_chunk", f))

        def insert(f):
            def wrapped(eng, b, slot, request):
                self.active[slot] = True
                return f(eng, b, slot, request)
            return self._span("insert", wrapped)

        def step(f):
            def wrapped(eng, b):
                if self.on:
                    self.step_frac = (sum(self.active.get(s, False)
                                          for s in range(eng.slots))
                                      / eng.slots)
                    self.steps += 1
                try:
                    return f(eng, b)
                finally:
                    self.step_frac = None
            return self._span("step", wrapped)

        def status(f):
            def wrapped(eng, b):
                out = f(eng, b)
                if self.on:
                    self.status_times.append(time.perf_counter())
                    self._check_deadline()
                for s, n in enumerate(out[0]):
                    self.active[s] = bool(n < eng.ecfg.max_new)
                return out
            return self._span("slot_status", wrapped)

        self._patch(BE, "insert", insert)
        self._patch(BE, "step", step)
        self._patch(BE, "slot_status", status)

        def forward(f):
            def wrapped(params, cfg, embeds, kv, positions, rope,
                        block_mask=None, *a, **k):
                self._check_deadline()
                if not self.on:
                    return f(params, cfg, embeds, kv, positions, rope,
                             block_mask, *a, **k)
                self._record_forward(cfg, embeds, kv, block_mask)
                t0 = time.perf_counter()
                try:
                    return f(params, cfg, embeds, kv, positions, rope,
                             block_mask, *a, **k)
                finally:
                    self.spans.append(("forward", t0, time.perf_counter()))
                    self._cur_fwd = -1
            return wrapped

        self._patch(tfm, "forward", forward)

        def k1(f):
            def wrapped(x, q, s, out_dtype=None):
                if self.on:
                    K, N = q.shape
                    ob = 4 if out_dtype == torch.float32 else x.element_size()
                    self.k1.append((x.numel() // K, K, N, ob, self._cur_fwd,
                                    self.step_frac))
                return f(x, q, s, out_dtype)
            return wrapped

        self._patch(quant, "w8a16_matmul", k1)
        return self

    def uninstall(self):
        while self._undo:
            self._undo.pop()()

    def _check_deadline(self):
        """Between two calls of the program (never inside one), end the
        traced part once its time is up."""
        if self.on and time.perf_counter() >= self.deadline:
            self.stop()

    def _record_forward(self, cfg, embeds, kv, block_mask):
        B, T, _ = embeds.shape
        if block_mask is None:
            bm = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                       device=embeds.device))[None]
        else:
            bm = block_mask.bool()
            if bm.ndim == 2:
                bm = bm[None]
        bm = bm.expand(B, T, T)
        length = kv.length
        self.fwd.append(dict(
            L=cfg.num_layers, B=B, T=T, nh=cfg.num_heads,
            nkv=cfg.num_kv_heads, hd=cfg.head_dim, G=kv.k.shape[2],
            W=kv.k.shape[-1], int8=kv.k.dtype == torch.int8,
            length=(length.clone() if torch.is_tensor(length)
                    else torch.tensor(length)),
            keys=bm.sum(-1).to(torch.int32),          # [B, T] block keys
            useful=torch.diagonal(bm, dim1=1, dim2=2).sum(),
            frac=self.step_frac))
        self._cur_fwd = len(self.fwd) - 1

    # -- after the window ------------------------------------------------
    def resolve(self) -> None:
        """Read the device records (after the window)."""
        for f in self.fwd:
            ln = f["length"].reshape(-1).long().cpu()
            f["length"] = (ln.expand(f["B"]) if ln.numel() == 1 else ln)
            f["keys"] = f["keys"].cpu()
            f["useful"] = int(f["useful"])


def nvidia_smi() -> str:
    """The card's name, power limit and clocks (one line), or why not."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class DeviceTrace:
    """``torch.profiler`` over the window, CUDA activity only; events as
    ``(name, start_us, end_us)`` with the host-clock offset from a marker
    kernel launched after a synchronise."""

    MARK = "spin"

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.mark_host = time.perf_counter()
        torch.cuda._sleep(2000)
        self.t0 = time.perf_counter()
        return self

    def close(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        t = time.perf_counter()
        self.stop_s = t - self.t1
        from torch.autograd import DeviceType

        # the raw kineto records: building the profiler's function-event
        # tree would take minutes over a window's hundreds of thousands
        ev, mark = [], None
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name, a, b = e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3
            if mark is None and self.MARK in name:
                mark = a
                continue
            ev.append((name, a, b))
        ev.sort(key=lambda x: x[1])
        if mark is None:
            mark = ev[0][1] if ev else 0.0
        # device microseconds -> host seconds
        self.offset = self.mark_host - mark * 1e-6
        self.events = ev
        self.read_s = time.perf_counter() - t
        return self
