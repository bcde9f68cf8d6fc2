"""Batched speculative decoding of images already in flight, stepped in a
window: the state of a server that refills slots as images finish, built
in set-up.

Each of the first ``slots`` requests holds an image in flight: its prompt
carries a seeded, grammar-correct prefix of whole rows (``w`` visual ids,
then the row end), ``depth_rows`` of them, one depth a slot in a seeded
order.  A slot whose image completes is retired at its last row end (its
end of frame is not served) and refilled with a fresh request, no prefix,
as a server admits a new arrival.  The protocol is ``engine_window``'s
(one ``BatchedEngine.step``, then ``slot_status``; a finished slot's
tokens read before it is refilled).

Traffic keys, besides ``engine_window``'s (``slots``, ``queue``,
``prompt_tokens``, ``text_id_range``, the tree and sampling keys,
``warm_steps``, ``check.requests``): ``negative_tokens``, the length of the
negative prompt drawn once from the run's seed for every request's
unconditional row, and ``depth_rows``.
"""

from __future__ import annotations

import time

import numpy as np

from lantern_tpu_torch import trees
from lantern_tpu_torch.engine import spec
from lantern_tpu_torch.engine.batch import BatchedEngine
from lantern_tpu_torch.ops.acceptance import LanternSpec
from lantern_tpu_torch.ops.sampling import LogitsWarp

from .engine_window import spread_sizes


def image_rows(cfg: dict, rng, n: int) -> list:
    """``n`` whole rows of the image grammar: ``w`` random visual ids, then
    the row end."""
    im = cfg["image"]
    w = im["grid"][1]
    lo, hi = im["image_token_ids"]
    rows = np.empty((n, w + 1), np.int64)
    rows[:, :w] = rng.integers(lo, hi + 1, size=(n, w))
    rows[:, w] = im["row_end_id"]
    return rows.reshape(-1).tolist()


def requests(h):
    """The queue's captions, the negative prompt, each request's image
    prefix and its random stream's seed, drawn from the run's seed."""
    tr = h.traffic
    rng = h.rng("prompts")
    a, b = tr["text_id_range"]
    sizes = spread_sizes(rng, tr["queue"], *tr["prompt_tokens"], tr["slots"])
    texts = [rng.integers(a, b, size=int(n)).tolist() for n in sizes]
    seeds = rng.choice(2 ** 40, size=tr["queue"], replace=False) + 1
    negative = h.rng("negative").integers(a, b, size=tr["negative_tokens"])
    deep = h.rng("depth")
    depths = deep.permutation(tr["depth_rows"])[: tr["slots"]]
    prefixes = [image_rows(h.cfg, deep, int(r)) for r in depths]
    prefixes += [[]] * (tr["queue"] - len(prefixes))
    return texts, negative.tolist(), prefixes, [int(s) for s in seeds]


def run(h) -> None:
    cfg, tr, dev = h.cfg, h.traffic, h.device
    fam = h.family
    texts, negative, prefixes, seeds = requests(h)
    mcfg = fam.model_config(cfg, tr)
    params, _, _ = fam.program_params(cfg, tr, h.seed, dev)
    gh, gw = cfg["image"]["grid"]
    last = gh * (gw + 1)                 # tokens through the last row end
    ecfg = spec.SpecDecodeConfig(
        warp=LogitsWarp(temperature=tr["temperature"], top_k=tr["top_k"]),
        cfg_scale=tr["cfg_scale"],
        lantern=LanternSpec(k=tr["lantern_k"], delta=tr["lantern_delta"]),
        max_new=last, mode=tr["mode"], kv_quant=tr["kv_quant"],
        stale_draft=tr["stale_draft"])
    tree = (str(h.root / tr["tree_file"]) if "tree_file" in tr
            else tr["tree"])
    eng = BatchedEngine(ecfg=ecfg, cfg=mcfg, tree=trees.get_tree(tree),
                        params=params, num_slots=tr["slots"],
                        logits_fn=fam.grid_fsm(cfg), device=dev)
    h.cfg_scale = tr["cfg_scale"]
    h.capture.watch(seeds)
    need = [last - len(p) for p in prefixes]   # tokens a request serves

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
                pre = eng.prefill(
                    generator=spec.request_generator(seeds[i], dev),
                    token_prompt=fam.token_prompt(
                        cfg, texts[i], dev, negative_ids=negative,
                        prefix_ids=prefixes[i]))
            except Exception as e:  # noqa: BLE001 -- keep serving
                info[i]["error"] = f"{type(e).__name__}: {e}"
                continue
            if batch is None:
                batch = eng.empty_batch(pre)
            batch = eng.insert(batch, slot, pre)
            slot_req[slot] = i
            return

    def retire(n_new, steps, acc):
        """A slot past its image's last row end: its tokens to there, then
        the next request."""
        for s, i in enumerate(slot_req):
            if i is not None and n_new[s] >= need[i]:
                info[i].update(served=eng.slot_tokens(batch, s)[:need[i]],
                               n1=need[i], s1=int(steps[s]), a1=int(acc[s]),
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
    h.tokens = sum(min(info[i]["n1"], need[i]) - info[i]["n0"] for i in ok)
    h.counters = {"accept_sum": sum(info[i]["a1"] - info[i]["a0"]
                                    for i in ok),
                  "slot_steps": sum(info[i]["s1"] - info[i]["s0"]
                                    for i in ok)}
    h.latencies = [info[i]["t1"] - info[i]["t0"] for i in ok
                   if "t1" in info[i]]
    pick = [ok[k] for k in h.sample(len(ok), tr["check"]["requests"])]
    h.checked = [dict(desc={"text_ids": texts[i], "negative_ids": negative,
                            "prefix_ids": prefixes[i]},
                      served=np.asarray(info[i]["served"], np.int64),
                      seed=seeds[i]) for i in pick]
