"""eval_hpsv2 task: the HPSv2 human-preference score of generated images.

Counterpart of ``entrypoints_tpu/eval_hpsv2.py``: it matches each
``prompt_<idx>.png`` / ``image_<idx>.png`` / ``<idx>.png`` to its prompt
row and prints the mean of ``logit_scale * cos(img, txt)``.  Backbones:
the pinned OpenCLIP ViT-H/14 with the HPSv2.1 census (``--model`` and
``--merges``, the default), a local HF CLIP directory (a proxy score), or
the ``hpsv2`` package where it is installed.  Features run on ``--device``.
"""

from __future__ import annotations

import csv
import json
import os
import re


def add_args(p):
    p.add_argument("--image_path", required=True)
    p.add_argument("--prompt_path", required=True,
                   help=".tsv/.csv/.json prompts")
    p.add_argument("--clip-model-dir", default=None,
                   help="(hf_clip backbone) local HF checkpoint of HPSv2 (or "
                        "any CLIP) weights")
    p.add_argument("--model", default=None,
                   help="pinned backbone weights: the HPS_v2.1 .pt release "
                        "(or same-key .npz / HF dir) — OpenCLIP ViT-H/14 "
                        "census, evals/clip.py VIT_H14")
    p.add_argument("--merges", default=None,
                   help="CLIP BPE merges file (bpe_simple_vocab_16e6.txt.gz) "
                        "for the pinned backbone's tokenizer")
    p.add_argument("--backbone", default="pinned",
                   choices=["pinned", "hf_clip"],
                   help="pinned = ViT-H/14 with the HPSv2.1 census "
                        "(default); hf_clip = any local HF CLIP dir (proxy "
                        "score, not comparable to published HPS)")
    p.add_argument("--use-hpsv2-package", action="store_true")
    p.add_argument("--batch_size", type=int, default=32)


def load_prompts(path):
    if path.endswith(".tsv"):
        with open(path) as f:
            return [r["Prompt"] for r in csv.DictReader(f, delimiter="\t")]
    if path.endswith(".csv"):
        with open(path) as f:
            return [r["Prompt"] for r in csv.DictReader(f)]
    if path.endswith(".json"):
        with open(path) as f:
            caps = json.load(f)
        return [c[0] if isinstance(c, list) else c for c in caps]
    raise ValueError("Prompt file should be .tsv, .csv or .json")


def match_index(fname: str):
    # the reference's file name conventions
    m = re.search(r"(?:prompt|image)_(\d{1,4})\.(?:png|jpe?g)", fname)
    if m:
        return int(m.group(1))
    m = re.search(r"(\d{1,6})\.(?:png|jpe?g)", fname)
    return int(m.group(1)) if m else None


def run(args, device=None):
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..evals import features as F
    from ..evals import metrics as M

    dev = resolve_device(device)
    prompts = load_prompts(args.prompt_path)
    paths = F.list_images(args.image_path)
    pairs = [(p, prompts[i]) for p in paths
             if (i := match_index(os.path.basename(p))) is not None
             and i < len(prompts)]
    if not pairs:
        raise SystemExit(f"no scoreable images under {args.image_path}")

    if args.use_hpsv2_package:
        import hpsv2
        from PIL import Image

        scores = [float(np.asarray(
            hpsv2.score(Image.open(p), t, hps_version="v2.1")).reshape(-1)[0])
            for p, t in pairs]
    elif args.backbone == "pinned":
        # HPSv2.1 is an OpenCLIP ViT-H/14 fine-tune; the pinned backbone
        # carries that census (evals/clip.py VIT_H14)
        from ..evals.clip import VIT_H14, CLIPExtractor
        from ..evals.clip_bpe import ClipTokenizer

        if not args.model or not args.merges:
            raise SystemExit(
                "eval_hpsv2 --backbone pinned needs --model (the HPS_v2.1 "
                ".pt / .npz, OpenCLIP ViT-H/14 census) and --merges (the "
                "CLIP BPE merges file); or use --backbone hf_clip / "
                "--use-hpsv2-package")
        tok = ClipTokenizer(args.merges)
        ex = CLIPExtractor(weights=args.model, geom=VIT_H14, tokenizer=tok,
                           batch=args.batch_size, device=dev)
        embs = []
        for i in range(0, len(pairs), args.batch_size):
            chunk = F.load_images([p for p, _ in pairs[i:i + args.batch_size]],
                                  device=dev)
            embs.append(ex.image_features(chunk))
        img_embs = torch.cat(embs)
        txt_embs = ex.text_features([t for _, t in pairs])
        scores = M.hps_from_embeddings(img_embs, txt_embs).tolist()
    else:
        if not args.clip_model_dir:
            raise SystemExit(
                "eval_hpsv2 --backbone hf_clip needs --clip-model-dir "
                "(local HPSv2/CLIP HF checkpoint)")
        ex = F.HFClipExtractor(args.clip_model_dir, device=dev, prepend="")
        # load per batch: a whole directory up front would hold N x 224 x
        # 224 x 3 pixels for nothing
        embs = []
        for i in range(0, len(pairs), args.batch_size):
            chunk = F.load_images([p for p, _ in pairs[i:i + args.batch_size]],
                                  resize=224, device=dev)
            embs.append(ex.image_features(chunk, batch=args.batch_size))
        img_embs = torch.cat(embs)
        txt_embs = ex.text_features([t for _, t in pairs],
                                    batch=args.batch_size)
        scores = M.hps_from_embeddings(img_embs, txt_embs).tolist()

    print("Image Path:", args.image_path)
    print(float(np.mean(scores)))
    return 0
