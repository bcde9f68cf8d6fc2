"""One run of one cell: the manifest, the window, the metrics, the check.

``Harness`` holds what a driver needs (the cell's configuration and
traffic, the seed, the device, the capture and, in a traced run, the
tracer) and what it leaves (tokens, latencies, counters, requests and the
checked requests).  Everything of one configuration, traffic mix or metric
is found by name: ``configs/<config>.json`` (the file ``BENCHMARK.json``
names), ``traffic/<mix>.json`` with its ``driver`` in
``drivers/<driver>.py``, the family's program side in
``families/<family>.py``, the limits in ``limits/<cell>.json``, and each
metric's reader in ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
import zlib
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lantern_tpu")
# the device trace covers at most this much of a traced window: reading the
# profiler's records takes ~2.5 s a traced second, and a traced run must end
# within 360 s
TRACE_SECONDS = 20.0


def forbidden_modules(names=FORBIDDEN) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``names``, compared whole: ``lantern_tpu_torch`` is not
    ``lantern_tpu``."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in names)


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(manifest: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell, its configuration entry and file, its traffic file (under
    the checkout ``root``)."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; cells: "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    return dict(cell=w, config=conf,
                cfg=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((root / HERE.name / "traffic" /
                                    f"{w['traffic']}.json").read_text()))


def metrics_of(manifest: dict, workload: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics (untraced run: those whose
    ``workloads`` list it, or that have none) or per-layer metrics (traced
    run: those whose ``workloads``, which each names, list it)."""
    if not traced:
        return [m for m in manifest["end_to_end"]
                if workload in m.get("workloads", [workload])]
    return [m for m in manifest["per_layer"] if workload in m["workloads"]]


def reader(metric: str, root: Path = ROOT):
    """``read(run)`` of ``metrics/<metric>.py`` under the checkout
    ``root``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Harness:
    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device, t_start: float, root: Path = ROOT):
        self.root = Path(root)
        self.manifest = load_manifest(self.root)
        c = cell_of(self.manifest, workload, self.root)
        self.cell = c["cell"]
        self.cfg, self.traffic = c["cfg"], c["traffic"]
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device, self.t_start = device, t_start
        self.family = importlib.import_module(
            f"h100_bench.families.{self.cfg['family']}")
        self.driver = importlib.import_module(
            f"h100_bench.drivers.{self.traffic['driver']}")
        from .capture import Capture
        from .reference.families import vocab_cols

        self.capture = Capture(vocab_cols(self.cfg))
        self.tracer = None
        if trace:
            from .trace import Tracer

            self.tracer = Tracer()
        self.dtrace = None
        # what the driver leaves
        self.tokens = 0
        self.latencies: List[float] = []
        self.counters: Dict[str, int] = {}
        self.attempted = self.failed = 0
        self.checked: List[dict] = []
        self.cfg_scale = 1.0
        self.window_s = self.setup_s = self.traced_s = 0.0
        self.busy_s: Optional[float] = None
        self.peak_bytes = 0
        self.launches: Dict[str, int] = {}
        self.launches_traced: Dict[str, int] = {}

    def rng(self, tag: str) -> np.random.Generator:
        return np.random.default_rng([self.seed, zlib.crc32(tag.encode())])

    def sample(self, n: int, k: int):
        from .check import served_sample

        return served_sample(n, k, self.seed)

    def note(self, msg: str) -> None:
        print(f"[h100_bench +{time.perf_counter() - self.t_start:7.1f}s] "
              f"{msg}", file=sys.stderr, flush=True)

    # -- the window ----------------------------------------------------
    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> None:
        """Synchronise, reset the peak, start the traced part, and move the
        set-up's objects out of the garbage collector's way."""
        import gc

        import torch

        from lantern_tpu_torch.ops import _cuda

        gc.collect()
        gc.freeze()
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.launches0 = dict(_cuda.LAUNCHES)
        if self.tracer is not None:
            from .trace import DeviceTrace

            if self.device.type == "cuda":
                self.dtrace = DeviceTrace().__enter__()
            self.tracer.on = True
            self.tracer.deadline = time.perf_counter() + TRACE_SECONDS
            self.tracer.stop = self.stop_trace
        self.t_open = time.perf_counter()
        self.setup_s = self.t_open - self.t_start
        self.note(f"window opens after {self.setup_s:.3f} s of set-up")

    def close_window(self) -> None:
        import gc

        import torch

        from lantern_tpu_torch.ops import _cuda

        self._sync()
        self.t_close = time.perf_counter()
        gc.unfreeze()
        self.window_s = self.t_close - self.t_open
        if self.device.type == "cuda":
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device)
        self.launches = {k: v - self.launches0.get(k, 0)
                         for k, v in _cuda.LAUNCHES.items()}
        if self.tracer is not None:
            self.stop_trace()

    def stop_trace(self) -> None:
        """End the traced part of the window: the host records and the
        device trace (at the window's close, or ``TRACE_SECONDS`` in)."""
        from lantern_tpu_torch.ops import _cuda

        if not self.tracer.on:
            return
        self.tracer.on = False
        self.launches_traced = {k: v - self.launches0.get(k, 0)
                                for k, v in _cuda.LAUNCHES.items()}
        if self.dtrace is not None:
            self.dtrace.close()
            self.traced_s = self.dtrace.t1 - self.dtrace.t0
        else:
            self.traced_s = time.perf_counter() - self.t_open

    # -- the traced run's readings ----------------------------------------
    def _intervals(self):
        """Device event intervals in host seconds, clipped to the window,
        merged into their union."""
        d = self.dtrace
        out = []
        for _, a, b in d.events:
            a, b = max(a * 1e-6 + d.offset, d.t0), min(b * 1e-6 + d.offset,
                                                        d.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def resolve_trace(self) -> None:
        self.tracer.resolve()
        if self.dtrace is None:
            return
        self.union = self._intervals()
        self.busy_s = sum(b - a for a, b in self.union)

    def kernel_seconds(self, tag: str) -> float:
        if self.dtrace is None:
            return 0.0
        return sum(b - a for n, a, b in self.dtrace.events if tag in n) * 1e-6

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the idle time
        by what the host was doing (its innermost harness span, with the
        spans around it)."""
        d = self.dtrace
        ops: Dict[str, float] = {}
        for n, a, b in d.events:
            ops[n] = ops.get(n, 0.0) + (b - a) * 1e-6
        gaps, prev = [], d.t0
        for a, b in self.union + [[d.t1, d.t1]]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        idle = label_gaps(self.tracer.spans, gaps)
        top = lambda m: [[k[:160], v] for k, v in sorted(
            m.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def label_gaps(spans, gaps) -> Dict[str, float]:
    """Idle seconds by the chain of host spans (outer>inner) open at each
    gap's midpoint; "host" where none is.  One sweep over the spans' ends
    and the gaps' midpoints in time order."""
    marks = [(a, 0, i) for i, (_, a, _b) in enumerate(spans)]
    marks += [(b, 2, i) for i, (_, _a, b) in enumerate(spans)]
    marks += [(0.5 * (a + b), 1, j) for j, (a, b) in enumerate(gaps)]
    marks.sort(key=lambda x: (x[0], x[1]))
    open_: List[int] = []
    out: Dict[str, float] = {}
    for _, kind, i in marks:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            open_.remove(i)
        else:
            name = ">".join(spans[k][0] for k in open_) or "host"
            a, b = gaps[i]
            out[name] = out.get(name, 0.0) + (b - a)
    return out
