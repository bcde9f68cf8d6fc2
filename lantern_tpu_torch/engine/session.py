"""Generation sessions: model + drafter + codec + prompts -> images.

Counterpart of ``lantern_tpu/engine/session.py``, the layer users call.  A
session owns the parameter dicts (base model, EAGLE drafter, VQ codec) on
one ``device`` (``None`` is ``cuda``) and exposes:

- ``generate(prompt, ...)`` -> ``(tokens numpy, GenStats)`` for one request
  (speculative in ``static`` or ``dynamic`` mode, or ``ar``);
- ``generate_batch(prompts, ...)`` -> the scheduler's ``Request`` list:
  continuous batching through ``BatchedEngine`` + ``Scheduler`` (static or
  dynamic trees), or lockstep batched AR (``ar.generate_many``,
  ``ar.generate_tokens_many``);
- ``decode_ids`` / ``decode_generated`` -> uint8 images through the port's
  VQGAN.

Every request draws from ``spec.request_generator(seed)`` on the session's
device, so under sampling a request's tokens are the same alone and
batched.  Latency is read after ``torch.cuda.synchronize()``.

``tree="auto"`` in ``generate_batch`` is where the JAX sessions consult
``engine/policy.serving_plan``, a table measured on TPU v5e; the port has
no such table yet (ROADMAP item 12's policy, to be measured on the H100
once the port bench exists, item 20), so there it raises.  ``pin`` (the
engines' ``SpecDecodeConfig.pin``) is the port's hook for deterministic
checks; the JAX sessions do not take it.  ``T5Embedder`` needs downloaded
T5 weights and is not ported: a caption session embeds with
``utils.t5.RandomT5`` unless ``t5`` is set to an embedder of the same
interface.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import trees
from ..configs import DrafterConfig, ModelConfig
from ..device import resolve_device, synchronize
from ..models import chameleon as cham
from ..models import drafter as drf
from ..models import transformer as tfm
from ..models import vqgan
from ..ops.acceptance import LanternSpec
from ..ops.sampling import LogitsWarp
from . import ar, spec
from .spec import request_generator

POLICY_MESSAGE = (
    "tree='auto' in generate_batch is the JAX serving policy "
    "(engine/policy.serving_plan), whose table holds TPU v5e measurements; "
    "the port has none until the policy is measured on the H100 (ROADMAP "
    "item 12's policy, after the port bench of item 20): name a tree or a "
    ".json tree file")


@dataclasses.dataclass
class GenStats:
    step_compression: float
    latency: float
    steps: int
    tokens: int


def _passthrough(dparams: dict, cfg: ModelConfig) -> dict:
    """The hidden-passthrough drafter: ``fc_w = [0; I]``, zeroed layers."""
    H = cfg.hidden_size
    fc = torch.zeros((2 * H, H), dtype=dparams["fc_w"].dtype,
                     device=dparams["fc_w"].device)
    fc[H:] = torch.eye(H, dtype=fc.dtype, device=fc.device)
    return dict(dparams, fc_w=fc,
                layers={k: v * 0 for k, v in dparams["layers"].items()})


def _random_weights(cfg: ModelConfig, dcfg: Optional[DrafterConfig],
                    seed: int, aligned_drafter: bool, device):
    """Random base (and drafter) params from generators seeded ``seed`` and
    ``seed + 1`` on ``device``."""
    params = tfm.init_params(torch.Generator(device=device).manual_seed(seed),
                             cfg, device=device)
    dparams = None
    if dcfg is not None:
        dparams = drf.init_drafter_params(
            torch.Generator(device=device).manual_seed(seed + 1), dcfg,
            params["embed"])
        if aligned_drafter:
            dparams = _passthrough(dparams, cfg)
    return params, dparams


def _resolve_stale(passthrough_drafter: bool, stale_draft, mode: str) -> bool:
    if stale_draft == "auto":
        return mode == "static" and passthrough_drafter
    return bool(stale_draft) and mode == "static"


def _ecfg(warp, drafter_top_k, cfg_scale, lantern_k, lantern_delta, max_new,
          mode, kv_quant, stale, pin, stop_ids=()):
    dwarp = (None if drafter_top_k is None else
             dataclasses.replace(warp, top_k=drafter_top_k))
    return spec.SpecDecodeConfig(
        warp=warp, cfg_scale=cfg_scale,
        lantern=LanternSpec(k=lantern_k, delta=lantern_delta),
        max_new=max_new, mode=mode, kv_quant=kv_quant, drafter_warp=dwarp,
        stop_ids=stop_ids, stale_draft=stale, pin=pin)


def _failed(uid, seed, e: Exception):
    from .scheduler import Request

    return Request(uid=uid, seed=seed, error=f"{type(e).__name__}: {e}")


@dataclasses.dataclass
class LlamaGenSession:
    """LlamaGen class-to-image or caption-to-image session."""

    cfg: ModelConfig
    dcfg: Optional[DrafterConfig]
    params: dict
    dparams: Optional[dict]
    vq_cfg: Optional[vqgan.VQGANConfig] = None
    vq_params: Optional[dict] = None
    t5: object = None
    # the drafter is the hidden-passthrough: static steps run drafter-free
    # stale-distribution drafting (the same tokens, no drafter forwards)
    passthrough_drafter: bool = False
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def from_pretrained(cls, base_path: str, cfg: ModelConfig,
                        drafter_path: Optional[str] = None,
                        dcfg: Optional[DrafterConfig] = None,
                        vq_path: Optional[str] = None,
                        nearest_path: Optional[str] = None,
                        t5_dir: Optional[str] = None,
                        device=None) -> "LlamaGenSession":
        """Load a LlamaGen checkpoint (dir or file), an optional EAGLE
        drafter, VQ-16 codec and LANTERN nearest table onto ``device``."""
        from ..ops.vq_distance import load_table
        from ..utils import checkpoint as ckpt

        if t5_dir is not None:
            raise ValueError("T5Embedder is not ported (it needs downloaded "
                             "T5 weights): set session.t5 to an embedder "
                             "with RandomT5's get_text_embeddings interface")
        dev = resolve_device(device)
        params = ckpt.llamagen_params_from_torch(ckpt.load_torch_dir(base_path),
                                                 cfg, device=dev)
        dparams = None
        if drafter_path is not None:
            if dcfg is None:
                dcfg = DrafterConfig(model=cfg)
            dparams = ckpt.drafter_params_from_torch(
                ckpt.load_torch_dir(drafter_path), dcfg,
                embed=params["embed"], device=dev)
        vq_cfg = vq_params = None
        if vq_path is not None:
            vq_cfg = vqgan.vq16_config(codebook_size=cfg.vocab_size)
            vq_params = vqgan.load_torch_state_dict(
                ckpt.load_torch_file(vq_path), vq_cfg, device=dev)
        if nearest_path is not None:
            params["nearest_latents"] = torch.as_tensor(
                load_table(nearest_path), device=dev)
        return cls(cfg=cfg, dcfg=dcfg, params=params, dparams=dparams,
                   vq_cfg=vq_cfg, vq_params=vq_params, device=dev)

    @classmethod
    def random(cls, cfg: ModelConfig, dcfg: Optional[DrafterConfig] = None,
               seed: int = 0, with_vq: bool = True,
               aligned_drafter: bool = True,
               device=None) -> "LlamaGenSession":
        """Random-weight session (no published checkpoint is needed)."""
        dev = resolve_device(device)
        params, dparams = _random_weights(cfg, dcfg, seed, aligned_drafter,
                                          dev)
        vq_cfg = vq_params = None
        if with_vq:
            vq_cfg = vqgan.vq16_config(codebook_size=cfg.vocab_size)
            vq_params = vqgan.init_vqgan_params(
                torch.Generator(device=dev).manual_seed(seed + 2), vq_cfg,
                device=dev)
        return cls(cfg=cfg, dcfg=dcfg, params=params, dparams=dparams,
                   vq_cfg=vq_cfg, vq_params=vq_params,
                   passthrough_drafter=aligned_drafter and dcfg is not None,
                   device=dev)

    def _resolve_stale(self, stale_draft, mode: str) -> bool:
        return _resolve_stale(self.passthrough_drafter, stale_draft, mode)

    # ------------------------------------------------------------------
    def _cond_pair(self, prompt):
        """``(cond, uncond, prefix_valid)`` on the device: a class label
        against the uncond class, or the caption's features (left-padded,
        pad rows zeroed) against the params' uncond features, with the
        caption's pad mask on both rows."""
        cfg, dev = self.cfg, self.device
        if cfg.cond_kind == "label":
            return (torch.tensor([int(prompt)], device=dev),
                    torch.tensor([cfg.num_classes], device=dev), None)
        from ..utils.t5 import RandomT5, flip_for_left_padding

        t5 = self.t5 or RandomT5(dim=cfg.caption_dim,
                                 model_max_length=cfg.cls_token_num)
        emb, mask = flip_for_left_padding(*t5.get_text_embeddings(
            [str(prompt)]))
        cond = torch.as_tensor(emb, device=dev)
        uncond = self.params["cond"]["uncond"][None].to(cond.dtype)
        pv = torch.ones((2, cfg.max_seq_len), dtype=torch.bool, device=dev)
        pv[:, : cfg.cls_token_num] = torch.as_tensor(mask, device=dev).bool()
        return cond, uncond, pv

    @torch.no_grad()
    def generate(self, prompt, max_new: Optional[int] = None,
                 temperature: float = 1.0, top_k: int = 2000,
                 top_p: float = 1.0, drafter_top_k: Optional[int] = None,
                 cfg_scale: float = 7.5, mode: str = "static",
                 tree: str = "naive_extend_57", lantern_k: int = 0,
                 lantern_delta: float = 0.0, seed: int = 0,
                 kv_quant: bool = False, warp_order: str = "hf",
                 stale_draft="auto", pin: Optional[float] = None):
        """One image's tokens: ``(tokens [max_new] numpy, GenStats)``.
        ``mode``: "static" | "dynamic" | "ar" (also taken without a
        drafter); ``tree``: a library name or a ``.json`` file ("auto" is
        the default tree)."""
        cfg = self.cfg
        max_new = max_new or cfg.block_size
        warp = LogitsWarp(temperature=temperature, top_k=top_k, top_p=top_p,
                          warp_order=warp_order)
        cond, uncond, pv = self._cond_pair(prompt)
        gen = request_generator(seed, self.device)
        t0 = time.perf_counter()
        if mode == "ar" or self.dparams is None:
            res = ar.generate(self.params, cfg, cond, uncond, max_new,
                              cfg_scale, warp, gen, prefix_valid=pv,
                              kv_quant=kv_quant, device=self.device)
            toks = res.tokens.cpu().numpy()
            synchronize(self.device)
            return toks, GenStats(1.0, time.perf_counter() - t0, max_new,
                                  max_new)
        ecfg = _ecfg(warp, drafter_top_k, cfg_scale, lantern_k, lantern_delta,
                     max_new, mode, kv_quant,
                     self._resolve_stale(stale_draft, mode), pin)
        if tree == "auto":
            tree = "naive_extend_57"
        tspec = trees.get_tree(tree) if mode == "static" else None
        res = spec.generate(self.params, ecfg, cfg, tspec, None, gen,
                            device=self.device, dparams=self.dparams,
                            dcfg=self.dcfg, cond=cond, uncond=uncond,
                            prefix_valid=pv)
        toks = res.tokens.cpu().numpy()[:max_new]
        synchronize(self.device)
        dt = time.perf_counter() - t0
        return toks, GenStats(res.step_compression, dt, int(res.steps),
                              max_new)

    @torch.no_grad()
    def generate_batch(self, prompts, slots: int = 8,
                       max_new: Optional[int] = None,
                       temperature: float = 1.0, top_k: int = 2000,
                       top_p: float = 1.0,
                       drafter_top_k: Optional[int] = None,
                       cfg_scale: float = 7.5, mode: str = "static",
                       tree: str = "naive_extend_57", lantern_k: int = 0,
                       lantern_delta: float = 0.0, seed: int = 0,
                       kv_quant: bool = False, warp_order: str = "hf",
                       progress: bool = False, stale_draft="auto",
                       pin: Optional[float] = None):
        """Continuous-batching generation over many prompts on ``slots``
        slots: the scheduler's ``Request`` list in input order (tokens,
        steps, accept_sum, latency; a failed prompt carries ``error`` and
        the batch keeps serving).  Request ``i`` draws from seed ``seed +
        i``.  ``mode="ar"`` runs lockstep batched AR; ``tree="auto"``
        raises with a drafter in static mode (no H100 policy yet) and is
        else the slot-count rule of the JAX session."""
        from .batch import BatchedEngine
        from .scheduler import Request, Scheduler

        cfg = self.cfg
        max_new = max_new or cfg.block_size
        warp = LogitsWarp(temperature=temperature, top_k=top_k, top_p=top_p,
                          warp_order=warp_order)
        if tree == "auto" and mode == "static" and self.dparams is not None:
            raise ValueError(POLICY_MESSAGE)
        if tree == "auto":
            tree = "naive_extend_57" if slots < 4 else "chain_bush_8"
        if mode == "ar" or self.dparams is None:
            return self._generate_batch_ar(prompts, slots, max_new,
                                           cfg_scale, warp, seed, kv_quant)
        if not prompts:
            return []
        ecfg = _ecfg(warp, drafter_top_k, cfg_scale, lantern_k, lantern_delta,
                     max_new, mode, kv_quant,
                     self._resolve_stale(stale_draft, mode), pin)
        tspec = trees.get_tree(tree) if mode == "static" else None
        engine = BatchedEngine(ecfg=ecfg, cfg=cfg, tree=tspec,
                               params=self.params,
                               num_slots=min(slots, len(prompts)),
                               dparams=self.dparams, dcfg=self.dcfg,
                               device=self.device)
        reqs = []
        for i, p in enumerate(prompts):
            try:
                cond, uncond, pv = self._cond_pair(p)
                reqs.append(Request(uid=i, cond=cond, uncond=uncond,
                                    prefix_valid=pv, seed=seed + i))
            except Exception as e:  # noqa: BLE001 -- bad prompt, keep serving
                reqs.append(_failed(i, seed + i, e))
        return Scheduler(engine).run(reqs, progress=progress)

    def _generate_batch_ar(self, prompts, slots, max_new, cfg_scale, warp,
                           seed, kv_quant):
        """Lockstep batched AR over chunks of ``slots`` prompts
        (``ar.generate_many``)."""
        from .scheduler import Request

        out = []
        for lo in range(0, len(prompts), max(1, slots)):
            chunk = list(range(lo, min(lo + slots, len(prompts))))
            good, conds, pvs, uncond = [], [], [], None
            for i in chunk:
                try:
                    c, uncond, pv = self._cond_pair(prompts[i])
                    good.append(i)
                    conds.append(c)
                    pvs.append(pv)
                except Exception as e:  # noqa: BLE001
                    out.append(_failed(i, seed + i, e))
            if not good:
                continue
            t0 = time.perf_counter()
            toks = ar.generate_many(
                self.params, self.cfg, torch.stack(conds), uncond, max_new,
                cfg_scale, warp,
                [request_generator(seed + i, self.device) for i in good],
                prefix_valid=None if pvs[0] is None else torch.stack(pvs),
                kv_quant=kv_quant, device=self.device).cpu().numpy()
            synchronize(self.device)
            dt = time.perf_counter() - t0
            for row, i in enumerate(good):
                out.append(Request(uid=i, seed=seed + i, tokens=toks[row],
                                   steps=max_new, accept_sum=max_new,
                                   latency=dt))
        out.sort(key=lambda r: r.uid)
        return out

    def decode_ids(self, tokens) -> np.ndarray:
        """VQ codes [T] or [B, T] (a square grid) -> uint8 [B, H, W, 3]."""
        if self.vq_params is None:
            raise ValueError("session has no VQ codec loaded")
        codes = torch.as_tensor(np.atleast_2d(np.asarray(tokens)),
                                device=self.vq_params["codebook"].device)
        grid = int(round(codes.shape[1] ** 0.5))
        return vqgan.to_uint8(vqgan.decode_code(self.vq_params, self.vq_cfg,
                                                codes, grid))


@dataclasses.dataclass
class ChameleonSession:
    """Anole / Lumina-mGPT generation session.

    Prompts are raw text (tokenized by ``tokenizer``: a ``ChameleonBPE`` or
    any ``str -> List[int]``) or BPE id lists.  Generated image tokens
    translate to VQ codes by the image-token offset."""

    cfg: ModelConfig
    dcfg: Optional[DrafterConfig]
    params: dict
    dparams: Optional[dict]
    family: str = "anole"            # "anole" | "lumina"
    grid: tuple = (32, 32)           # (h, w) latent grid
    vq_cfg: Optional[vqgan.VQGANConfig] = None   # Chameleon (taming) VQGAN
    vq_params: Optional[dict] = None
    fsm_overrides: Optional[dict] = None  # LuminaGridFSM id overrides
    tokenizer: object = None
    passthrough_drafter: bool = False
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _resolve_stale(self, stale_draft, mode: str) -> bool:
        return _resolve_stale(self.passthrough_drafter, stale_draft, mode)

    @classmethod
    def from_pretrained(cls, base_path: str, cfg: ModelConfig,
                        drafter_path: Optional[str] = None,
                        dcfg: Optional[DrafterConfig] = None,
                        vq_path: Optional[str] = None,
                        nearest_path: Optional[str] = None,
                        family: str = "anole", grid=(32, 32),
                        tokenizer_path: Optional[str] = None,
                        device=None) -> "ChameleonSession":
        """Load an HF Chameleon-family checkpoint (Anole-7b / Lumina-mGPT),
        an optional EAGLE drafter, taming VQGAN and LANTERN nearest table,
        and the checkpoint's BPE tokenizer (searched under ``base_path``
        when ``tokenizer_path`` is not given; without one, raw-text
        prompts are refused)."""
        from ..models.bpe import ChameleonBPE, load_tokenizer
        from ..ops.vq_distance import load_table
        from ..utils import checkpoint as ckpt

        dev = resolve_device(device)
        params = ckpt.chameleon_params_from_torch(
            ckpt.load_torch_dir(base_path), cfg, device=dev)
        if tokenizer_path is not None:
            tokenizer = load_tokenizer(tokenizer_path)
        else:
            try:
                tokenizer = ChameleonBPE.from_checkpoint_dir(base_path)
            except FileNotFoundError:
                tokenizer = None
        dparams = None
        if drafter_path is not None:
            if dcfg is None:
                dcfg = DrafterConfig(model=cfg)
            dparams = ckpt.drafter_params_from_torch(
                ckpt.load_torch_dir(drafter_path), dcfg,
                embed=params["embed"], device=dev)
        sess = cls(cfg=cfg, dcfg=dcfg, params=params, dparams=dparams,
                   family=family, grid=grid, tokenizer=tokenizer, device=dev)
        if vq_path is not None:
            sess.vq_cfg = vqgan.chameleon_vq_config()
            sess.vq_params = vqgan.load_taming_state_dict(
                ckpt.load_torch_file(vq_path), sess.vq_cfg, device=dev)
        if nearest_path is not None:
            params["nearest_latents"] = torch.as_tensor(
                cham.shift_nearest_table(load_table(nearest_path),
                                         cfg.vocab_size), device=dev)
        return sess

    @classmethod
    def random(cls, cfg: ModelConfig, dcfg: Optional[DrafterConfig] = None,
               seed: int = 0, family: str = "anole", grid=(8, 8),
               aligned_drafter: bool = True,
               device=None) -> "ChameleonSession":
        """Random-weight session with the ``hash_tokenize`` tokenizer and no
        codec (set ``vq_cfg`` / ``vq_params`` to decode)."""
        from ..models.item_processor import hash_tokenize

        dev = resolve_device(device)
        params, dparams = _random_weights(cfg, dcfg, seed, aligned_drafter,
                                          dev)
        return cls(cfg=cfg, dcfg=dcfg, params=params, dparams=dparams,
                   family=family, grid=grid, tokenizer=hash_tokenize,
                   passthrough_drafter=aligned_drafter and dcfg is not None,
                   device=dev)

    @property
    def item_processor(self):
        from ..models.item_processor import FlexARItemProcessor

        return FlexARItemProcessor(vq_params=self.vq_params,
                                   vq_cfg=self.vq_cfg,
                                   tokenizer=self.tokenizer)

    def decode_ids(self, tokens):
        """A generated stream -> (text token spans, decoded uint8 images)."""
        return self.item_processor.decode_ids(list(np.asarray(tokens)))

    def decode_generated(self, tokens, grid=None) -> np.ndarray:
        """Raw ``generate()`` output (no image start/end wrappers) -> one
        uint8 image [H, W, 3].  Anole emits h*w image BPE ids; Lumina emits
        grid rows with a newline token each and a trailing image-end."""
        if self.vq_params is None:
            raise ValueError("session has no VQ codec loaded")
        h, w = grid or self.grid
        toks = np.asarray(tokens).reshape(-1)
        if self.family == "lumina":
            body = toks[: h * (w + 1)].reshape(h, w + 1)[:, :w]
        else:
            body = toks[: h * w].reshape(h, w)
        codes = torch.as_tensor(cham.bpe_to_img(body).reshape(1, -1),
                                device=self.vq_params["codebook"].device)
        return vqgan.to_uint8(vqgan.decode_code(
            self.vq_params, self.vq_cfg, codes, grid=(h, w)))[0]

    def _prompt(self, text_or_tokens, grid=None):
        if isinstance(text_or_tokens, str):
            if self.tokenizer is None:
                raise ValueError(
                    "raw-text prompts need a tokenizer: pass tokenizer_path "
                    "to from_pretrained (the tokenizer json ships inside "
                    "every Anole/Lumina checkpoint) or set .tokenizer")
            text_tokens = list(self.tokenizer(text_or_tokens))
        else:
            text_tokens = [int(t) for t in text_or_tokens]
        if self.family == "anole":
            return cham.anole_token_prompt(text_tokens)
        return cham.lumina_token_prompt(text_tokens, grid=grid or self.grid)

    def _max_new(self, max_new, grid):
        h, w = grid or self.grid
        if max_new is None:
            max_new = h * w if self.family == "anole" else h * (w + 1) + 1
        return max_new

    def _image_mask(self) -> torch.Tensor:
        return torch.from_numpy(cham.non_image_token_mask(
            self.cfg.vocab_size)).to(self.device)

    def _fsm(self, grid, image_start_idx: int):
        h, w = grid or self.grid
        return cham.LuminaGridFSM(w=w, h=h, image_start_idx=image_start_idx,
                                  vocab_size=self.cfg.vocab_size,
                                  **(self.fsm_overrides or {}))

    @torch.no_grad()
    def generate(self, text_tokens, max_new: Optional[int] = None,
                 temperature: float = 1.0, top_k: int = 2000,
                 top_p: float = 1.0, drafter_top_k: Optional[int] = None,
                 cfg_scale: float = 3.0, mode: str = "static",
                 tree: str = "mc_sim_7b_63", lantern_k: int = 0,
                 lantern_delta: float = 0.0, seed: int = 0,
                 kv_quant: bool = False, warp_order: str = "hf",
                 stop_ids=None, logits_fn="auto", stale_draft="auto",
                 grid=None, pin: Optional[float] = None):
        """One stream: ``(tokens numpy, GenStats)``.  By default fixed-budget
        image generation (non-image tokens suppressed, or the Lumina grid
        FSM).  ``stop_ids`` switches to end-of-turn terminated generation:
        logits run unconstrained, the engine stops once a stop id commits,
        and the stream is cut one past it (feed it to ``decode_ids``).
        ``logits_fn``: a custom logits processor, or "auto" (the family's);
        ``grid``: a per-call (h, w) latent grid."""
        cfg = self.cfg
        max_new = self._max_new(max_new, grid)
        warp = LogitsWarp(temperature=temperature, top_k=top_k, top_p=top_p,
                          warp_order=warp_order)
        tp = self._prompt(text_tokens, grid=grid)
        stop_ids = tuple(stop_ids) if stop_ids else ()
        mask = None if stop_ids else self._image_mask()
        if logits_fn == "auto":
            logits_fn = None
            if self.family == "lumina" and not stop_ids:
                logits_fn = self._fsm(grid, int(tp.pos_diff))
        if logits_fn is not None:
            mask = None      # the processor subsumes the static mask
        gen = request_generator(seed, self.device)
        t0 = time.perf_counter()
        if mode == "ar" or self.dparams is None:
            res = ar.generate_tokens(
                self.params, cfg, tp, max_new, cfg_scale, warp, gen,
                logits_mask=mask, logits_fn=logits_fn, kv_quant=kv_quant,
                stop_ids=stop_ids, device=self.device)
            toks = res.tokens.cpu().numpy()
            synchronize(self.device)
            dt = time.perf_counter() - t0
            if stop_ids:
                toks = toks[: int(res.n_valid)]
            return toks, GenStats(1.0, dt, len(toks), len(toks))
        ecfg = _ecfg(warp, drafter_top_k, cfg_scale, lantern_k, lantern_delta,
                     max_new, mode, kv_quant,
                     self._resolve_stale(stale_draft, mode), pin, stop_ids)
        if tree == "auto":
            tree = "mc_sim_7b_63"
        tspec = trees.get_tree(tree) if mode == "static" else None
        res = spec.generate(self.params, ecfg, cfg, tspec, tp, gen,
                            logits_mask=mask, logits_fn=logits_fn,
                            device=self.device, dparams=self.dparams,
                            dcfg=self.dcfg)
        n_out = int(res.n_valid) if stop_ids else max_new
        toks = res.tokens.cpu().numpy()[:n_out]
        synchronize(self.device)
        dt = time.perf_counter() - t0
        return toks, GenStats(res.step_compression, dt, int(res.steps), n_out)

    @torch.no_grad()
    def generate_batch(self, prompts, slots: int = 8,
                       max_new: Optional[int] = None,
                       temperature: float = 1.0, top_k: int = 2000,
                       top_p: float = 1.0,
                       drafter_top_k: Optional[int] = None,
                       cfg_scale: float = 3.0, mode: str = "static",
                       tree: str = "mc_sim_7b_63", lantern_k: int = 0,
                       lantern_delta: float = 0.0, seed: int = 0,
                       kv_quant: bool = False, warp_order: str = "hf",
                       progress: bool = False, grid=None,
                       stale_draft="auto", pin: Optional[float] = None):
        """Continuous-batching generation over token or text prompts of any
        lengths (each slot binds its own grid start into the Lumina FSM):
        the scheduler's ``Request`` list in input order.  ``mode="ar"``
        runs lockstep batched AR bucketed by prompt length; ``tree="auto"``
        raises (no H100 policy yet)."""
        from .batch import BatchedEngine
        from .scheduler import Request, Scheduler

        warp = LogitsWarp(temperature=temperature, top_k=top_k, top_p=top_p,
                          warp_order=warp_order)
        if mode == "ar" or self.dparams is None:
            return self._generate_batch_ar_tokens(
                prompts, slots, max_new, cfg_scale, warp, seed, kv_quant,
                grid)
        max_new = self._max_new(max_new, grid)
        reqs, lens = [], set()
        for i, p in enumerate(prompts):
            try:
                tp = self._prompt(p, grid=grid)
                lens.add(int(tp.tokens.shape[1]))
                reqs.append(Request(uid=i, token_prompt=tp, seed=seed + i))
            except Exception as e:  # noqa: BLE001
                reqs.append(_failed(i, seed + i, e))
        if tree == "auto":
            raise ValueError(POLICY_MESSAGE)
        if not prompts:
            return []
        mask, logits_fn = self._image_mask(), None
        if self.family == "lumina" and lens:
            # each slot binds its own image-start index (its uncond position
            # offset) into the FSM; the static start is only a default
            logits_fn = self._fsm(grid, max(lens) - 3)
            mask = None
        ecfg = _ecfg(warp, drafter_top_k, cfg_scale, lantern_k, lantern_delta,
                     max_new, mode, kv_quant,
                     self._resolve_stale(stale_draft, mode), pin)
        tspec = trees.get_tree(tree) if mode == "static" else None
        engine = BatchedEngine(ecfg=ecfg, cfg=self.cfg, tree=tspec,
                               params=self.params,
                               num_slots=min(slots, len(prompts)),
                               dparams=self.dparams, dcfg=self.dcfg,
                               logits_mask=mask, logits_fn=logits_fn,
                               device=self.device)
        return Scheduler(engine).run(reqs, progress=progress)

    def _generate_batch_ar_tokens(self, prompts, slots, max_new, cfg_scale,
                                  warp, seed, kv_quant, grid=None):
        """Lockstep batched AR over token prompts, bucketed by prompt length
        (``ar.generate_tokens_many``)."""
        from .scheduler import Request

        max_new = self._max_new(max_new, grid)
        out, by_len = [], {}
        for i, p in enumerate(prompts):
            try:
                tp = self._prompt(p, grid=grid)
                by_len.setdefault(int(tp.tokens.shape[1]), []).append((i, tp))
            except Exception as e:  # noqa: BLE001
                out.append(_failed(i, seed + i, e))
        for L, group in sorted(by_len.items()):
            mask, logits_fn = self._image_mask(), None
            if self.family == "lumina":
                logits_fn = self._fsm(grid, L - 3)
                mask = None
            for lo in range(0, len(group), max(1, slots)):
                chunk = group[lo: lo + max(1, slots)]
                tpb = cham.TokenPrompt(*(torch.stack([getattr(tp, f) for _, tp
                                                      in chunk])
                                         for f in cham.TokenPrompt._fields))
                t0 = time.perf_counter()
                toks, _ = ar.generate_tokens_many(
                    self.params, self.cfg, tpb, max_new, cfg_scale, warp,
                    [request_generator(seed + i, self.device)
                     for i, _ in chunk],
                    logits_mask=mask, logits_fn=logits_fn, kv_quant=kv_quant,
                    device=self.device)
                toks = toks.cpu().numpy()
                synchronize(self.device)
                dt = time.perf_counter() - t0
                for row, (i, _) in enumerate(chunk):
                    out.append(Request(uid=i, seed=seed + i,
                                       tokens=toks[row], steps=max_new,
                                       accept_sum=max_new, latency=dt))
        out.sort(key=lambda r: r.uid)
        return out
