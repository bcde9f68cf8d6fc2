"""The port's CLI: ``python -m lantern_tpu_torch <task> ...`` (the
counterpart of ``main.py``).

Tasks:
  generate_images     text/class-conditional image generation with
                      speculative decoding (the reference's
                      global_statistics_*.json schema)
  generate_codebook   VQ-codebook nearest-latent tables for LANTERN
  generate_train_data base-model traces -> drafter training samples
  train_drafter       drafter self-distillation training
  extract_code        images (+ captions) -> VQ codes (+ caption
                      embeddings), the input of generate_train_data
  eval_fid_clip       FID and CLIP score of a generated-image directory
  eval_prec_recall    improved precision and recall (k-NN manifolds)
  eval_hpsv2          the HPSv2 human-preference score

``--device`` (default ``cuda``) places the run; ``--device cpu`` runs the
plain PyTorch versions of the kernels.
"""

import argparse
import importlib
import sys


def main(argv=None):
    from .entrypoints import add_device_arg, evals

    parser = argparse.ArgumentParser(prog="python -m lantern_tpu_torch",
                                     description="LANTERN on PyTorch / CUDA")
    sub = parser.add_subparsers(dest="task", required=True)
    tasks = {name: importlib.import_module(f".entrypoints.{name}", __package__)
             for name in ("generate_images", "generate_codebook",
                          "generate_train_data", "train_drafter",
                          "extract_code") + evals.TASKS}
    for name, mod in tasks.items():
        p = sub.add_parser(name)
        mod.add_args(p)
        add_device_arg(p)
    args = parser.parse_args(argv)
    return tasks[args.task].run(args, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
