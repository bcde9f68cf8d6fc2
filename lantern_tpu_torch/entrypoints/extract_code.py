"""extract_code task: images (and captions) -> VQ codes (and caption
embeddings).

Counterpart of ``entrypoints_tpu/extract_code.py``: each image of
``--images-dir`` (sorted, at most ``--limit``) is read through
``utils/image.py``, centre-cropped to its short edge, Lanczos-resized to
``--image-size`` (PIL's filter, no PIL for PNG), scaled to [-1, 1] and
encoded through the family VQ-GAN on ``--device``.  With captions, each
image's caption is embedded by ``T5Embedder`` (``--t5-dir``) or
``RandomT5``.  One ``.npz`` per image: ``codes`` int32 ``[T]``, and with a
caption ``caption_emb`` f32 ``[120, 2048]`` and ``caption_mask`` int64,
the input of ``generate_train_data --codes-dir``.

Without ``--vq-path`` the VQ weights are random from ``torch.Generator``
seed 0: not the JAX task's ``jax.random.key(0)`` draws.
"""

from __future__ import annotations

import json
import os


def add_args(p):
    p.add_argument("--model", default="llamagen",
                   choices=["llamagen", "anole", "lumina_mgpt"])
    p.add_argument("--images-dir", required=True)
    p.add_argument("--captions-json", default=None,
                   help="MSCOCO-style {file_name -> caption} or annotations json")
    p.add_argument("--vq-path", default=None)
    p.add_argument("--t5-dir", default=None)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--save-dir", default="data/extracted_codes")
    p.add_argument("--limit", type=int, default=10 ** 9)


def load_captions(path):
    if path is None:
        return {}
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and "annotations" in data:
        images = {im["id"]: im["file_name"] for im in data.get("images", [])}
        return {images.get(a["image_id"], str(a["image_id"])): a["caption"]
                for a in data["annotations"]}
    return dict(data)


def run(args, device=None):
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..models import vqgan
    from ..utils.image import load_image

    dev = resolve_device(device)
    if args.model == "llamagen":
        vq_cfg = vqgan.vq16_config()
    else:
        vq_cfg = vqgan.chameleon_vq_config()
    if args.vq_path:
        from ..utils.checkpoint import load_torch_file

        loader = (vqgan.load_torch_state_dict if args.model == "llamagen"
                  else vqgan.load_taming_state_dict)
        vq_params = loader(load_torch_file(args.vq_path), vq_cfg, device=dev)
    else:
        vq_params = vqgan.init_vqgan_params(
            torch.Generator(device=dev).manual_seed(0), vq_cfg, device=dev)
        print("warning: random VQ weights (no --vq-path)")

    captions = load_captions(args.captions_json)
    t5 = None
    if captions:
        if args.t5_dir:
            from ..utils.t5 import T5Embedder

            t5 = T5Embedder(args.t5_dir, device=dev)
        else:
            from ..utils.t5 import RandomT5

            t5 = RandomT5()

    os.makedirs(args.save_dir, exist_ok=True)
    names = sorted(
        f for f in os.listdir(args.images_dir)
        if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp"))
    )[: args.limit]
    for name in names:
        img = load_image(os.path.join(args.images_dir, name),
                         args.image_size, dev)
        x = (img.to(torch.float32) / 127.5 - 1.0).permute(2, 0, 1)[None]
        codes = vqgan.encode(vq_params, vq_cfg, x)
        out = {"codes": codes[0].cpu().numpy().astype(np.int32)}
        if name in captions and t5 is not None:
            emb, mask = t5.get_text_embeddings([captions[name]])
            out["caption_emb"] = np.asarray(emb[0], np.float32)
            out["caption_mask"] = np.asarray(mask[0], np.int64)
        np.savez_compressed(
            os.path.join(args.save_dir, os.path.splitext(name)[0] + ".npz"),
            **out)
    print(f"extracted {len(names)} images to {args.save_dir}")
    return 0
