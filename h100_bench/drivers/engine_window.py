"""Batched speculative decoding of token prompts, stepped in a window.

A frozen copy of ``Scheduler``'s protocol (one ``BatchedEngine.step``, then
``slot_status``; a finished slot's tokens are read before the slot is
refilled from the queue), which a window can stop mid-image:
``Scheduler.run`` returns only when every request has finished.

Traffic keys: ``slots``; ``queue`` prompts of random text ids from
``text_id_range``, their lengths spread evenly over ``prompt_tokens`` in
each block of ``slots`` (in a seeded order), each with a random stream of
its own; the
static ``tree_file``, ``stale_draft`` drafting and rollback commit;
sampling (``temperature``, ``top_k``), ``cfg_scale``, LANTERN
(``lantern_k``, ``lantern_delta``, ``nearest_k``); ``kv_quant``;
``tree_room`` (cache rows past the image); ``warm_steps`` taken in set-up
after the first prefills; ``check.requests`` drawn for the comparison.
"""

from __future__ import annotations

import time

import numpy as np

from lantern_tpu_torch import trees
from lantern_tpu_torch.engine import spec
from lantern_tpu_torch.engine.batch import BatchedEngine
from lantern_tpu_torch.ops.acceptance import LanternSpec
from lantern_tpu_torch.ops.sampling import LogitsWarp


def spread_sizes(rng, n: int, lo: int, hi: int, block: int):
    """``n`` sizes: each block of ``block`` spreads evenly over [lo, hi],
    in an order drawn from ``rng``; every seed serves the same sizes."""
    base = np.rint(np.linspace(lo, hi, block)).astype(int)
    return np.concatenate([rng.permutation(base)
                           for _ in range(-(-n // block))])[:n]


def prompts(h):
    """The queue's prompts and request seeds, drawn from the run's seed."""
    tr = h.traffic
    rng = h.rng("prompts")
    a, b = tr["text_id_range"]
    sizes = spread_sizes(rng, tr["queue"], *tr["prompt_tokens"], tr["slots"])
    texts = [rng.integers(a, b, size=int(n)).tolist() for n in sizes]
    seeds = rng.choice(2 ** 40, size=tr["queue"], replace=False) + 1
    return texts, [int(s) for s in seeds]


def run(h) -> None:
    cfg, tr, dev = h.cfg, h.traffic, h.device
    fam = h.family
    texts, seeds = prompts(h)
    mcfg = fam.model_config(cfg, tr)
    params, _, _ = fam.program_params(cfg, tr, h.seed, dev)
    n_img = cfg["image"]["tokens"]
    ecfg = spec.SpecDecodeConfig(
        warp=LogitsWarp(temperature=tr["temperature"], top_k=tr["top_k"]),
        cfg_scale=tr["cfg_scale"],
        lantern=LanternSpec(k=tr["lantern_k"], delta=tr["lantern_delta"]),
        max_new=n_img, mode=tr["mode"], kv_quant=tr["kv_quant"],
        stale_draft=tr["stale_draft"])
    fsm = fam.grid_fsm(cfg, max(len(t) for t in texts))
    tree = (str(h.root / tr["tree_file"]) if "tree_file" in tr
            else tr["tree"])
    eng = BatchedEngine(ecfg=ecfg, cfg=mcfg, tree=trees.get_tree(tree),
                        params=params, num_slots=tr["slots"], logits_fn=fsm,
                        device=dev)
    h.cfg_scale = tr["cfg_scale"]
    h.capture.watch(seeds)

    queue = list(range(len(texts)))
    slot_req = [None] * tr["slots"]
    info = {}            # request -> dict(n0, s0, a0, t0, served, error)
    batch = None

    def admit(slot):
        """Prefill the next prompt into ``slot`` (a failure is recorded
        and the next prompt tried)."""
        nonlocal batch
        while queue:
            i = queue.pop(0)
            info[i] = dict(n0=0, s0=0, a0=0, t0=time.perf_counter(),
                           error=None, served=None)
            try:
                pre = eng.prefill(generator=spec.request_generator(
                    seeds[i], dev), token_prompt=fam.token_prompt(
                        cfg, texts[i], dev))
            except Exception as e:  # noqa: BLE001 -- keep serving
                info[i]["error"] = f"{type(e).__name__}: {e}"
                continue
            if batch is None:
                batch = eng.empty_batch(pre)
            batch = eng.insert(batch, slot, pre)
            slot_req[slot] = i
            return

    def retire(n_new, steps, acc):
        for s, i in enumerate(slot_req):
            if i is not None and n_new[s] >= n_img:
                info[i].update(served=eng.slot_tokens(batch, s)[:n_img],
                               n1=n_img, s1=int(steps[s]), a1=int(acc[s]),
                               t1=time.perf_counter())
                slot_req[s] = None
                admit(s)

    for s in range(tr["slots"]):
        admit(s)
    for _ in range(tr["warm_steps"]):
        batch = eng.step(batch)
        retire(*eng.slot_status(batch))

    n_new, steps, acc = eng.slot_status(batch)
    for s, i in enumerate(slot_req):
        if i is not None:
            info[i].update(n0=int(n_new[s]), s0=int(steps[s]),
                           a0=int(acc[s]))
    at_open = set(i for i in slot_req if i is not None)
    h.open_window()
    t_open = time.perf_counter()
    while True:
        batch = eng.step(batch)
        n_new, steps, acc = eng.slot_status(batch)
        retire(n_new, steps, acc)
        if time.perf_counter() - t_open >= h.seconds:
            break
    for s, i in enumerate(slot_req):
        if i is not None:
            info[i].update(n1=int(n_new[s]), s1=int(steps[s]),
                           a1=int(acc[s]), served=eng.slot_tokens(
                               batch, s)[: int(n_new[s])])
    h.close_window()

    served = [i for i in info if i in at_open or info[i]["t0"] >= t_open]
    h.attempted = len(served)
    h.failed = sum(info[i]["error"] is not None for i in served)
    ok = [i for i in served if info[i]["error"] is None]
    h.tokens = sum(min(info[i]["n1"], n_img) - info[i]["n0"] for i in ok)
    h.counters = {"accept_sum": sum(info[i]["a1"] - info[i]["a0"]
                                    for i in ok),
                  "slot_steps": sum(info[i]["s1"] - info[i]["s0"]
                                    for i in ok)}
    h.latencies = [info[i]["t1"] - info[i]["t0"] for i in ok
                   if "t1" in info[i]]
    pick = [ok[k] for k in h.sample(len(ok), tr["check"]["requests"])]
    h.checked = [dict(desc={"text_ids": texts[i]},
                      served=np.asarray(info[i]["served"], np.int64),
                      seed=seeds[i]) for i in pick]
