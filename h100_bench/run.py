"""One run of one cell of the port's benchmark on the card it is started on.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  Set-up makes the weights and the
prompts from ``--seed``, builds (first run in a checkout) or loads the
port's kernels under ``build/`` and warms every shape the window uses;
then the cell's driver serves for ``--seconds``.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from the
benchmark's wrappers and ``torch.profiler``.  After the window the plain
reference checks what the timed path produced (``check.py``).  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit; the same numbers
are the last lines of standard error.

Exit codes: 0 a result was printed; 2 bad arguments or an unknown cell;
3 no CUDA card, or fewer than the cell asks for; 4 a JAX module (``jax``,
``jaxlib``, ``flax``, ``lantern_tpu``) was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, no Flax
    behind ``transformers``, and one thread a CPU thread pool: the host
    drives the card, and idle pool threads only compete for its cores."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    from h100_bench import harness

    bad = harness.forbidden_modules()
    if bad:
        stderr(f"h100_bench: JAX modules loaded at start: {bad}")
        return 4
    manifest = harness.load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        stderr(f"h100_bench: unknown workload {args.workload!r}; cells: "
               f"{sorted(cells)}")
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        stderr(f"h100_bench: the cell needs {chips} CUDA card(s); "
               f"available: {torch.cuda.is_available()}, count "
               f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    return execute(args, torch.device("cuda", 0))


def execute(args, device, root: Path = ROOT, t_start: float = T_START,
            out=None, hook=None) -> int:
    """Set-up, window, metrics and check of one run on ``device`` (the
    card, or the CPU in the benchmark's own tests) in the checkout
    ``root``; the result's JSON line goes to ``out`` (stdout).  ``hook(h,
    weights, captured, reference logits, numbers)`` runs after the
    comparison (the control's readings)."""
    import torch

    from h100_bench import check, harness, trace

    h = harness.Harness(args.workload, args.seed, args.seconds,
                        bool(args.trace), device, t_start, root)
    manifest = h.manifest
    card = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if device.type == "cuda":
        h.note(f"nvidia-smi: {trace.nvidia_smi()}")
    h.capture.install()
    if h.tracer is not None:
        h.tracer.install()
    try:
        with torch.no_grad():
            h.driver.run(h)
    finally:
        h.capture.uninstall()
        if h.tracer is not None:
            h.tracer.uninstall()
    bad = harness.forbidden_modules()
    if bad:
        stderr(f"h100_bench: JAX modules loaded by the run: {bad}")
        return 4

    metrics, extra = {}, {}
    c = h.counters
    if c.get("slot_steps"):
        h.note(f"accepted {c['accept_sum']} tokens in {c['slot_steps']} "
               f"slot-steps: {c['accept_sum'] / c['slot_steps']:.4f} a step")
    if h.tracer is not None:
        h.resolve_trace()
    for m in harness.metrics_of(manifest, args.workload, bool(args.trace)):
        v = harness.reader(m["name"], h.root)(h)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": card, "count": h.cell["chips"],
           "memory_peak_bytes": int(h.peak_bytes)}
    if h.tracer is not None:
        dev.update(busy_s=h.busy_s or 0.0, window_s=h.traced_s)
        steps = h.tracer.steps or sum(1 for s in h.tracer.spans
                                      if s[0] == "forward")
        h.note("launches per " + ("step" if h.tracer.steps else "forward")
               + ": " + ", ".join(f"{k} {v / max(steps, 1):.2f}"
                                  for k, v in h.launches_traced.items()))
        t = h.tracer.status_times or [s[2] for s in h.tracer.spans
                                      if s[0] == "forward"]
        each = (t[-1] - t[0]) / (len(t) - 1) * 1e3 if len(t) > 1 else 0.0
        h.note(f"tracing: the first {h.traced_s:.3f} s of a {h.window_s:.3f}"
               f" s window traced, {each:.2f} ms a step or forward there "
               f"(the tracing overhead: set it against the untraced runs' "
               f"rate; the rest of the window includes the profiler's stop)")
        if h.dtrace is not None:
            extra["breakdown"] = h.breakdown()
            h.note(f"profiler: {len(h.dtrace.events)} device events, stop "
                   f"{h.dtrace.stop_s:.1f} s, read {h.dtrace.read_s:.1f} s")
            h.note(f"nvidia-smi: {trace.nvidia_smi()}")

    # the check: the program's state is freed, the reference runs
    check.free_device()
    t = time.perf_counter()
    lim = check.limits(args.workload, h.root)
    cap = [dict(c, **h.capture.rows_of(c["seed"], len(c["served"])))
           for c in h.checked]
    from h100_bench import weights

    w = weights.base_weights(h.cfg, args.seed, device)
    refs = check.reference_logits(h.cfg, w, cap, h.cfg_scale, device)
    tr = h.traffic
    near = (check.neighbours(h.cfg, args.seed, tr["nearest_k"], device)
            if tr["mode"] != "ar" else None)
    nums = check.numbers(h.cfg, tr, cap, refs, h.failed, near)
    if hook is not None:
        hook(h, w, cap, refs, nums)
    verdict = check.judge(nums, lim)
    h.note(f"reference over {nums['rows']} rows of {len(cap)} requests in "
           f"{time.perf_counter() - t:.1f} s")
    result = {"correct": verdict["correct"], "attempted": h.attempted,
              "failed": h.failed, "metrics": metrics, "device": dev}
    result.update(extra)
    result["checks"] = verdict["checks"]
    for k, c in verdict["checks"].items():
        rel = "<=" if k in lim["limits"] else ">="
        stderr(f"check {k}: {c['value']!r} (limit {rel} {c['limit']!r})")
    print(json.dumps(result), file=out or sys.stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
