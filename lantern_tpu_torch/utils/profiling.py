"""Tracing and training meters.

Counterpart of ``lantern_tpu/utils/profiling.py``:

- spans and counters of the program's phases: ``span(name, **attrs)``
  around a phase, ``count(name, n)`` of an event, read back with
  ``spans()`` and ``counters()`` and reset with ``clear()``.  They record
  only while a ``torch.profiler`` session is active (``trace`` below, or
  any other) or inside ``recording()``; otherwise a span is one check and
  a shared no-op context.  Times are ``time.perf_counter()`` seconds, the
  host clock onto which a device trace maps its kernels.  Under a profiler
  each span is also a ``torch.profiler.record_function`` range, so the
  spans show in its trace beside the kernels they launched.  While a
  recorded span is open on a CUDA build, torch's sync debug mode is
  ``"warn"`` (left alone where it is ``"error"``) and each synchronizing
  CUDA operation counts one ``syncs`` under the open spans; the mode is
  set back when the outermost span closes, unless it was changed since;
- ``trace``: ``torch.profiler`` around a block, a Chrome trace written to a
  directory (open it in Perfetto or ``chrome://tracing``);
- ``SmoothedValue`` / ``MetricLogger``: training meters (xllmx
  util/misc.py:21-152 equivalents); ``MetricLogger`` sums its totals over
  ranks with ``torch.distributed.all_reduce`` when a process group is
  initialized, and is a no-op otherwise.

The spans (attributes in brackets) and counters the engines record:

- ``prefill``, ``insert`` [slot], ``step``, ``slot_status``,
  ``slot_tokens``: ``BatchedEngine``; a ``step`` (batched, or one
  request's in ``spec``) holds ``step.block``, ``step.verify``,
  ``step.accept``, ``step.commit``, ``step.advance``, ``step.draft`` and,
  batched, ``step.freeze`` ([slot] on the per-slot phases of a batch);
- ``ar.prefill`` and, a token, ``ar.token``: the AR twin (all four
  entry points of ``engine/ar.py``), each holding ``sample``;
- ``forward`` (all of ``transformer.forward``, the drafter's too) and
  ``head`` (``transformer.logits_head``);
- counters ``steps`` (a speculative step), ``ar_tokens`` (an AR
  token), ``syncs`` and ``spans_dropped`` (spans past the buffer's
  ``MAX_SPANS``).

The records are the process's; the engines run them from one thread.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import hashlib
import os
import time
import warnings
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

MAX_SPANS = 1 << 18
# the text of torch's warning under sync debug mode "warn"
SYNC_WARNING = "called a synchronizing CUDA operation"

_profiler_enabled = torch.autograd._profiler_enabled


class Span(NamedTuple):
    name: str
    t0: float                 # host seconds (``time.perf_counter``)
    t1: Optional[float]       # None while the span is open
    parent: int               # index in ``spans()`` of the enclosing span,
                              # -1 at the top or when it was dropped
    attrs: dict


_spans: List[list] = []       # [name, t0, t1, parent, attrs]
_open: List[tuple] = []       # (record, its index in _spans or -1)
_counts: Dict[Tuple[str, Optional[str]], int] = {}
_forced = 0                   # depth of ``recording()``
_sync_watch = None            # what _watch_syncs changed, while the
                              # outermost recorded span is open
_NULL = contextlib.nullcontext()


def _on() -> bool:
    return bool(_forced) or _profiler_enabled()


def _add(name: str, n: int) -> None:
    key = (name, ">".join(r[0] for r, _ in _open) if _open else None)
    _counts[key] = _counts.get(key, 0) + n


class _Span:
    __slots__ = ("name", "attrs", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs, self.rf = name, attrs, None

    def __enter__(self):
        if not _open:
            _watch_syncs()
        rec = [self.name, 0.0, None, _open[-1][1] if _open else -1,
               self.attrs]
        idx = -1
        if len(_spans) < MAX_SPANS:
            idx = len(_spans)
            _spans.append(rec)
        else:
            _add("spans_dropped", 1)
        _open.append((rec, idx))
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        rec[1] = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = time.perf_counter()
        _open.pop()[0][2] = t
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if not _open and _sync_watch is not None:
            _unwatch_syncs()
        return False


def span(name: str, **attrs):
    """A context that records the phase ``name`` (with small ``attrs``
    such as ``slot``) while recording is on, and does nothing otherwise."""
    if _forced or _profiler_enabled():
        return _Span(name, attrs)
    return _NULL


def spanned(name: str):
    """Decorator: the whole of the function under ``span(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with span(name):
                return fn(*a, **k)
        return wrapped
    return deco


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` under the spans open now, while
    recording is on."""
    if _on():
        _add(name, n)


def spans() -> List[Span]:
    """The recorded spans in the order they began."""
    return [Span(*r) for r in _spans]


def counters() -> Dict[Tuple[str, Optional[str]], int]:
    """``{(counter, the spans open then, "outer>...>innermost", or None):
    total}``."""
    return dict(_counts)


def clear() -> None:
    """Forget the recorded spans and counters (spans still open stay open
    and are no longer recorded)."""
    _spans.clear()
    _counts.clear()
    _open[:] = [(rec, -1) for rec, _ in _open]


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, with or without a
    profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def _watch_syncs() -> None:
    """Sync debug mode "warn", and each of its warnings counted (not
    shown), while the outermost recorded span is open; nothing where the
    mode is "error" (a sync raises there).  Only what this adds is taken
    back when that span closes: the filter, the display hook (where still
    this one) and the mode (where still "warn")."""
    global _sync_watch
    prev = now = None
    if torch.cuda.is_available():
        prev = torch.cuda.get_sync_debug_mode()
        if prev == 2:
            return
        torch.cuda.set_sync_debug_mode("warn")
        now = torch.cuda.get_sync_debug_mode()
    show = warnings.showwarning

    def counted(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message) or not _on():
            return show(message, category, filename, lineno, file, line)
        _add("syncs", 1)

    warnings.filterwarnings("always", message=SYNC_WARNING)
    flt = warnings.filters[0]
    warnings.showwarning = counted
    _sync_watch = (flt, counted, show, prev, now)


def _unwatch_syncs() -> None:
    global _sync_watch
    flt, counted, show, prev, now = _sync_watch
    _sync_watch = None
    if prev is not None and torch.cuda.get_sync_debug_mode() == now:
        torch.cuda.set_sync_debug_mode(prev)
    if flt in warnings.filters:
        warnings.filters.remove(flt)
    if warnings.showwarning is counted:
        warnings.showwarning = show


@contextlib.contextmanager
def trace(logdir: str = "lantern_trace"):
    """Profile the block with ``torch.profiler`` (host ops, and the card's
    kernels when CUDA is available) and write ``logdir/trace.json``, a
    Chrome trace in which the program's spans are ranges of their own.
    Yields the profiler (``key_averages()`` etc.)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class SmoothedValue:
    """Windowed + global averages of a scalar series."""

    def __init__(self, window: int = 20):
        self.deque = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.deque.append(float(value))
        self.total += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_hosts(self):
        """Sum every meter's total and count over the ranks of the default
        process group (a no-op without one, or with one rank).  The ranks
        must hold the same meters."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return
        # NCCL reduces tensors on the card, gloo on the host
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        keys = sorted(self.meters)
        sig = int.from_bytes(hashlib.sha1("|".join(keys).encode()).digest()[:8],
                             "little", signed=True)
        sigs = [torch.zeros((1,), dtype=torch.int64, device=dev)
                for _ in range(dist.get_world_size())]
        dist.all_gather(sigs, torch.tensor([sig], dtype=torch.int64,
                                           device=dev))
        if any(int(s) != sig for s in sigs):
            raise ValueError(
                "MetricLogger.synchronize_between_hosts: ranks disagree on "
                f"meter keys (this rank: {keys})")
        vals = torch.tensor(
            [[self.meters[k].total, self.meters[k].count] for k in keys],
            dtype=torch.float64, device=dev)
        dist.all_reduce(vals)
        for i, k in enumerate(keys):
            self.meters[k].total = float(vals[i, 0])
            self.meters[k].count = int(vals[i, 1])

    def __str__(self):
        return self.delimiter.join(
            f"{k}: {m.avg:.4f} ({m.global_avg:.4f})"
            for k, m in self.meters.items())
