"""eval_fid_clip task: FID and CLIP score over a generated-image directory.

Counterpart of ``entrypoints_tpu/eval_fid_clip.py``: the same flags
(``--fake_dir --ref_dir --caption_path --how_many --eval_res``, the
feature extractor and its weights), branches and warnings; it writes
``<fake_dir>/score.txt`` with ``CLIP score: ...`` and ``FID_<res>px: ...``
lines and prints them.  Features and metrics run on ``--device``.
"""

from __future__ import annotations

import json
import os


def add_args(p):
    p.add_argument("--fake_dir", required=True)
    p.add_argument("--ref_dir", required=True,
                   help="reference image dir or precomputed features .npz")
    p.add_argument("--caption_path",
                   default="data/prompts/captions_val2017_longest.json")
    p.add_argument("--how_many", type=int, default=5000)
    p.add_argument("--eval_res", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--feature-extractor", default="clip_b32",
                   choices=["clip_b32", "hf_clip", "inception",
                            "fid_inception"],
                   help="FID feature space: clip_b32 = the pinned CLIP "
                        "ViT-B/32 (evals/clip.py, the reference's "
                        "clip_vit_b_32 / CLIP-score model) / hf_clip = any "
                        "local HF CLIP dir / torchvision inception / "
                        "fid_inception = the pinned clean-fid pool3 network "
                        "with the clean bicubic resize")
    p.add_argument("--merges", default=None,
                   help="CLIP BPE merges file (bpe_simple_vocab_16e6.txt.gz) "
                        "— needed for clip_b32 CLIP scoring")
    p.add_argument("--clip-model-dir", default=None,
                   help="local HF CLIP checkpoint dir, or the OpenAI "
                        "ViT-B/32 .pt / .npz for clip_b32")
    p.add_argument("--inception-ckpt", default=None,
                   help="path to the canonical pt_inception-2015-12-05 .pth "
                        "(or same-key .npz) for --feature-extractor "
                        "fid_inception")
    p.add_argument("--skip-clip-score", action="store_true")


def load_captions(path, n):
    with open(path, encoding="utf-8") as f:
        caps = json.load(f)
    return [c[0] if isinstance(c, list) else c for c in caps[:n]]


def run(args, device=None):
    from ..device import resolve_device
    from ..evals import features as F
    from ..evals import metrics as M
    from ..evals.clip import CLIPExtractor

    dev = resolve_device(device)
    # CLIP scoring only works off CLIP embeddings; with the inception
    # extractors it is skipped loudly, not silently
    want_clip = not args.skip_clip_score
    if want_clip and args.feature_extractor in ("inception", "fid_inception"):
        print("warning: CLIP score needs --feature-extractor hf_clip; "
              "skipping it")
        want_clip = False
    needs_net = (not args.fake_dir.endswith(".npz")
                 or not args.ref_dir.endswith(".npz")
                 or want_clip)
    extractor = None
    if needs_net:
        kind = args.feature_extractor
        if kind == "fid_inception" and args.inception_ckpt is None:
            raise SystemExit(
                "fid_inception needs --inception-ckpt (the canonical "
                "pt_inception-2015-12-05-6726825d.pth; random weights are "
                "test-only)")
        if kind == "clip_b32" and args.clip_model_dir is None:
            raise SystemExit(
                "clip_b32 needs --clip-model-dir (the OpenAI ViT-B/32 .pt "
                "/ .npz / HF CLIPModel dir; random weights are test-only)")
        extractor = F.make_extractor(
            kind,
            model_dir=(args.inception_ckpt if kind == "fid_inception"
                       else args.clip_model_dir),
            device=dev)
        if kind == "clip_b32" and want_clip:
            if args.merges is None:
                print("warning: CLIP score with clip_b32 needs --merges "
                      "(CLIP BPE file); skipping the score, keeping FID")
                want_clip = False
            else:
                from ..evals.clip_bpe import ClipTokenizer

                # the reference prepends "A photo depicts " to every caption
                tok = ClipTokenizer(args.merges)
                extractor.tokenizer = (
                    lambda texts: tok(texts, prepend="A photo depicts "))

    fake_feats = F.extract_dir_features(
        args.fake_dir, extractor, resize=args.eval_res,
        how_many=args.how_many, batch=args.batch_size).to(dev)
    ref_feats = F.extract_dir_features(
        args.ref_dir, extractor, resize=args.eval_res,
        how_many=args.how_many, batch=args.batch_size).to(dev)
    fid = M.fid_from_features(ref_feats, fake_feats)

    clip_score = None
    if want_clip and isinstance(extractor, (F.HFClipExtractor,
                                            CLIPExtractor)):
        captions = load_captions(args.caption_path, args.how_many)
        if args.fake_dir.endswith(".npz"):
            # precomputed CLIP features are the image embeddings
            img_embs = fake_feats
            n = min(len(img_embs), len(captions))
        else:
            paths = F.list_images(args.fake_dir)[: args.how_many]
            n = min(len(paths), len(captions))
            img_embs = fake_feats[:n]
        txt_embs = extractor.text_features(captions[:n], batch=args.batch_size)
        clip_score = M.clip_score_from_embeddings(img_embs[:n], txt_embs)

    lines = []
    if clip_score is not None:
        lines.append(f"CLIP score: {clip_score}")
    lines.append(f"FID_{args.eval_res}px: {fid}")
    out_path = os.path.join(args.fake_dir, "score.txt") \
        if os.path.isdir(args.fake_dir) else "score.txt"
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    for ln in lines:
        print(ln)
    print(f"writing to {out_path}")
    return 0
