"""generate_codebook task: VQ-codebook nearest-latent distance tables.

Counterpart of ``entrypoints_tpu/generate_codebook.py``: loads the model
family's VQ codebook (or a random one from seed 0), computes the all-pairs
L2 nearest code ids on ``device`` and saves them as uint16
``top_{k}_indices.npy`` under the save path.
"""

from __future__ import annotations

import os


def add_args(p):
    p.add_argument("--model", default="llamagen",
                   choices=["llamagen", "anole", "lumina_mgpt", "random"])
    p.add_argument("--vq-path", default=None, help="VQ checkpoint (.pt)")
    p.add_argument("--save-path", default="vq_distances")
    p.add_argument("--codebook-size", type=int, default=16384)
    p.add_argument("--codebook-dim", type=int, default=8)
    p.add_argument("--k", type=int, default=None,
                   help="neighbors to keep (default V-1)")
    p.add_argument("--l2-normalize", action="store_true",
                   help="measure distances in the l2-normalized codebook "
                        "space.  The reference uses the RAW embedding matrix "
                        "for every family (generate_codebook.py:54-56) even "
                        "though LlamaGen's runtime VQ quantizes normalized "
                        "codes — default stays reference-faithful; this "
                        "flag matches the runtime metric instead")


def codebook_of(args):
    """The codebook as a numpy or torch [V, d] array: a random one from
    seed 0 (``--model random`` or no ``--vq-path``), else the checkpoint's
    embedding matrix."""
    import numpy as np

    if args.model == "random" or args.vq_path is None:
        rng = np.random.default_rng(0)
        return rng.normal(size=(args.codebook_size, args.codebook_dim)
                          ).astype(np.float32)
    from ..utils.checkpoint import load_torch_file

    sd = load_torch_file(args.vq_path)
    key = "quantize.embedding.weight"
    if key not in sd:
        cands = [k for k in sd if k.endswith("embedding.weight")]
        if not cands:
            raise KeyError(f"no codebook in {args.vq_path}; keys: {list(sd)[:5]}")
        key = cands[0]
    return sd[key]


def run(args, device=None):
    import torch

    from ..device import resolve_device
    from ..ops.vq_distance import nearest_latents, save_table

    dev = resolve_device(device)
    codebook = torch.as_tensor(codebook_of(args)).to(dev)
    table = nearest_latents(codebook, k=args.k,
                            l2_normalize=getattr(args, "l2_normalize", False))
    os.makedirs(args.save_path, exist_ok=True)
    out = os.path.join(args.save_path, f"top_{table.shape[1]}_indices.npy")
    save_table(out, table)
    print(f"saved {out} shape={table.shape}")
    return 0
