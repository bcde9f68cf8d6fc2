"""eval_prec_recall task: improved precision and recall through k-NN
manifolds.

Counterpart of ``entrypoints_tpu/eval_prec_recall.py``: the same flags
(``--ref_dir --fake_dir --k --num_samples --fname_precalc``, the feature
extractor and its weights); ``--fname_precalc`` saves the reference
manifold as an ``.npz`` and exits.  Features and distances run on
``--device``.
"""

from __future__ import annotations


def add_args(p):
    p.add_argument("--ref_dir", required=True,
                   help="real images dir, or manifold/features .npz")
    p.add_argument("--fake_dir", default=None,
                   help="generated images dir or features .npz "
                        "(omit with --fname_precalc to only save the manifold)")
    p.add_argument("--k", type=int, default=3)
    p.add_argument("--num_samples", type=int, default=100000)
    p.add_argument("--batch_size", type=int, default=50)
    p.add_argument("--fname_precalc", default="",
                   help="save the reference manifold to this .npz and exit")
    p.add_argument("--feature-extractor", default="vgg16",
                   choices=["vgg16", "vgg16_jax", "hf_clip"],
                   help="vgg16_jax = the pinned backbone (torchvision vgg16 "
                        "fc2, evals/vgg.py; the name is the JAX package's); "
                        "pass the canonical vgg16 .pth via --vgg-ckpt")
    p.add_argument("--clip-model-dir", default=None)
    p.add_argument("--vgg-ckpt", default=None,
                   help="torchvision vgg16 .pth for --feature-extractor "
                        "vgg16_jax")
    p.add_argument("--eval_res", type=int, default=224)


def _manifold_from(path, args, extractor, dev):
    import torch

    from ..evals import features as F
    from ..evals import metrics as M

    if path.endswith(".npz"):
        feats, radii = F.load_npz_features(path)
        feats = feats[: args.num_samples]
        if radii is not None and len(radii) >= len(feats):
            return M.Manifold(
                torch.as_tensor(feats, dtype=torch.float64, device=dev),
                torch.as_tensor(radii[: len(feats)], dtype=torch.float64,
                                device=dev))
        return M.manifold(torch.as_tensor(feats).to(dev), k=args.k)
    feats = F.extract_dir_features(path, extractor, resize=args.eval_res,
                                   how_many=args.num_samples,
                                   batch=args.batch_size)
    return M.manifold(feats.to(dev), k=args.k)


def run(args, device=None):
    import numpy as np

    from ..device import resolve_device
    from ..evals import features as F
    from ..evals import metrics as M

    dev = resolve_device(device)
    extractor = None
    needs_net = not args.ref_dir.endswith(".npz") or (
        args.fake_dir is not None and not args.fake_dir.endswith(".npz"))
    if needs_net:
        if args.feature_extractor == "vgg16_jax" and args.vgg_ckpt is None:
            raise SystemExit("vgg16_jax needs --vgg-ckpt (the canonical "
                             "torchvision vgg16 .pth; random weights are "
                             "test-only)")
        extractor = F.make_extractor(
            args.feature_extractor,
            model_dir=(args.vgg_ckpt
                       if args.feature_extractor == "vgg16_jax"
                       else args.clip_model_dir),
            device=dev)

    ref_m = _manifold_from(args.ref_dir, args, extractor, dev)
    if args.fname_precalc:
        np.savez_compressed(args.fname_precalc,
                            features=ref_m.features.cpu().numpy(),
                            radii=ref_m.radii.cpu().numpy())
        print(f"manifold saved to {args.fname_precalc}")
        return 0

    if not args.fake_dir:
        raise SystemExit("--fake_dir required (or use --fname_precalc)")
    fake_m = _manifold_from(args.fake_dir, args, extractor, dev)
    precision = M.manifold_coverage(ref_m, fake_m.features)
    recall = M.manifold_coverage(fake_m, ref_m.features)
    print(f"precision: {precision}")
    print(f"recall: {recall}")
    return 0
