"""Dispatcher for the offline image-quality eval tasks (counterpart of
``entrypoints_tpu/evals.py``): FID and CLIP score, precision and recall,
HPSv2."""

from __future__ import annotations

import argparse
import importlib

TASKS = ("eval_fid_clip", "eval_prec_recall", "eval_hpsv2")


def run(task: str, extra_args):
    """Parse ``extra_args`` with ``task``'s flags and ``--device`` (default
    ``cuda``), then run it."""
    if task not in TASKS:
        raise SystemExit(f"unknown eval task {task}")
    from . import add_device_arg

    mod = importlib.import_module(f"{__package__}.{task}")
    p = argparse.ArgumentParser(task)
    mod.add_args(p)
    add_device_arg(p)
    args = p.parse_args(extra_args)
    return mod.run(args, device=args.device)
