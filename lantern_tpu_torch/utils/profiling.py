"""Tracing, timing and training meters.

Counterpart of ``lantern_tpu/utils/profiling.py``:

- ``DeviceTimer``: wall-clock bracketing that waits for the device's queued
  work on entry and exit (``device.synchronize``), the reference's
  cuda-synchronize Timer (utils.py:23-34);
- ``trace``: ``torch.profiler`` around a block, a Chrome trace written to a
  directory (open it in Perfetto or ``chrome://tracing``);
- ``DecodeStats``: per-request accept-length histogram and throughput
  counters (``step_compression`` is its mean);
- ``SmoothedValue`` / ``MetricLogger``: training meters (xllmx
  util/misc.py:21-152 equivalents); ``MetricLogger`` sums its totals over
  ranks with ``torch.distributed.all_reduce`` when a process group is
  initialized, and is a no-op otherwise.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import os
import time

import numpy as np
import torch

from ..device import synchronize


def _device_of(tree):
    """The device of the first tensor in a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            dev = _device_of(x)
            if dev is not None:
                return dev
    return None


class DeviceTimer:
    """``with DeviceTimer("verify", device): ...`` -> prints the elapsed
    milliseconds, the device's queued work drained on entry (so earlier
    launches are not charged to the block) and on exit (so the block's
    are).  ``device`` None times the host alone until ``set_sync``."""

    def __init__(self, name: str, device=None, quiet: bool = False):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.quiet = quiet
        self.elapsed = 0.0

    def __enter__(self):
        if self.device is not None:
            synchronize(self.device)
        self._t0 = time.perf_counter()
        return self

    def set_sync(self, tree):
        """Sync the exit on the device of output made inside the block (a
        tensor or a nested dict / list of them)."""
        self.device = _device_of(tree)
        return tree

    def __exit__(self, *exc):
        if self.device is not None:
            synchronize(self.device)
        self.elapsed = time.perf_counter() - self._t0
        if not self.quiet:
            print(f"[{self.name}] {self.elapsed * 1e3:.2f} ms")


@contextlib.contextmanager
def trace(logdir: str = "lantern_trace"):
    """Profile the block with ``torch.profiler`` (host ops, and the card's
    kernels when CUDA is available) and write ``logdir/trace.json``, a
    Chrome trace.  Yields the profiler (``key_averages()`` etc.)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class DecodeStats:
    """Accept-length histogram + throughput accounting for spec decoding."""

    def __init__(self):
        self.accept_hist = collections.Counter()
        self.steps = 0
        self.tokens = 0
        self.wall = 0.0

    def record_step(self, accepted: int, wall: float = 0.0):
        self.accept_hist[int(accepted)] += 1
        self.steps += 1
        self.tokens += int(accepted)
        self.wall += wall

    def record_run(self, steps: int, accept_sum: int, wall: float):
        self.steps += int(steps)
        self.tokens += int(accept_sum)
        self.wall += wall

    @property
    def step_compression(self) -> float:
        return self.tokens / max(self.steps, 1)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall if self.wall else 0.0

    def summary(self) -> dict:
        return {
            "steps": self.steps,
            "tokens": self.tokens,
            "step_compression": round(self.step_compression, 4),
            "tokens_per_s": round(self.tokens_per_s, 2),
            "accept_hist": dict(sorted(self.accept_hist.items())),
        }


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
