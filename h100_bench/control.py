"""The check's own readings on the card: the program's numbers, the
control's and a planted fault's, over several seeds in one process.

    python3 -m h100_bench.control --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--fault token|stuck|accept_all]

Each seed is one whole run of the cell (``run.execute``: set-up, window,
comparison; its result line is printed as the benchmark prints it).  After
the comparison the control, the plain reference one precision step below
the configuration (int4 weights and int4 KV cache), is put in the
program's place on the same prompts and served tokens, and its
``top1_gap`` and ``logit_err`` are printed on a line ``{"seed", "program",
"control", "control_correct"}``: the control's numbers with the program's
others, judged by the cell's limits.  With ``--fault`` the run's timed
path carries that fault (``faults.py``) and the line reads ``"fault"``.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from h100_bench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    run.cache_env()
    import contextlib

    import torch

    from h100_bench import check, faults, harness

    dev = torch.device("cuda", 0)
    man = harness.load_manifest()
    cfg = harness.cell_of(man, args.workload)["cfg"]
    for seed in [int(s) for s in args.seeds.split(",")]:
        line = {"seed": seed}

        def hook(h, w, cap, refs, nums):
            line["program"] = nums
            if args.fault:
                return
            ctrl = check.reference_logits(h.cfg, w, cap, h.cfg_scale, dev,
                                          wbits=4, kvbits=4)
            line["control"] = check.control_numbers(refs, ctrl)
            line["control_correct"] = check.judge(
                dict(nums, **line["control"]),
                check.limits(args.workload))["correct"]

        ns = argparse.Namespace(workload=args.workload, seed=seed,
                                seconds=args.seconds, trace=0)
        ctx = (faults.planted(args.fault, cfg) if args.fault
               else contextlib.nullcontext())
        with ctx:
            rc = run.execute(ns, dev, t_start=time.perf_counter(), hook=hook)
        if args.fault:
            line["fault"] = args.fault
        line["rc"] = rc
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
