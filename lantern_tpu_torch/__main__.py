"""The port's CLI: ``python -m lantern_tpu_torch <task> ...`` (the
counterpart of ``main.py`` for the tasks the port has).

Tasks:
  generate_images     text/class-conditional image generation with
                      speculative decoding (the reference's
                      global_statistics_*.json schema)
  generate_codebook   VQ-codebook nearest-latent tables for LANTERN

``--device`` (default ``cuda``) places the run; ``--device cpu`` runs the
plain PyTorch versions of the kernels.
"""

import argparse
import sys


def main(argv=None):
    from .entrypoints import generate_codebook, generate_images

    parser = argparse.ArgumentParser(prog="python -m lantern_tpu_torch",
                                     description="LANTERN on PyTorch / CUDA")
    sub = parser.add_subparsers(dest="task", required=True)
    tasks = {"generate_images": generate_images,
             "generate_codebook": generate_codebook}
    for name, mod in tasks.items():
        p = sub.add_parser(name)
        mod.add_args(p)
        p.add_argument("--device", default="cuda",
                       help="torch device of the run (cuda or cpu)")
    args = parser.parse_args(argv)
    return tasks[args.task].run(args, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
