"""Caption-to-image serving through ``LlamaGenSession.generate_batch``, in
calls made back to back.

Each call serves ``captions_per_call`` captions on ``slots`` slots
(``mode`` "static": ``BatchedEngine`` over ``tree`` through ``Scheduler`` on
the native queue, the passthrough drafter drafting stale; "ar": lockstep
batched AR in chunks of ``slots``).  A call starts only while the time left
in the window is at least the last call's duration, and the first call
always starts: the window is the span of the calls made.  Captions have
word counts spread evenly over ``caption_words`` (a seeded order) of
random words of ``word_letters`` letters; call ``c``'s
request ``i`` draws from the seed ``base_c + i``.  Set-up makes one short
call (``warm_tokens`` tokens a request) on as many slots, so every shape of
the window is built before it opens.  The requests checked are drawn from
the first call, which always runs to its end.
"""

from __future__ import annotations

import time

import numpy as np

from lantern_tpu_torch.device import synchronize
from lantern_tpu_torch.engine.session import LlamaGenSession

from .engine_window import spread_sizes

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def captions(rng, n: int, words, letters):
    """``n`` captions whose word counts spread evenly over ``words`` (in a
    seeded order: every seed serves the same prefix lengths) of random
    words of ``letters`` letters."""
    out = []
    for k in spread_sizes(rng, n, words[0], words[1], n):
        out.append(" ".join(
            "".join(rng.choice(LETTERS, size=int(rng.integers(
                letters[0], letters[1] + 1)))) for _ in range(int(k))))
    return out


def run(h) -> None:
    cfg, tr, dev = h.cfg, h.traffic, h.device
    fam = h.family
    rng = h.rng("captions")
    n = tr["captions_per_call"]
    mcfg = fam.model_config(cfg, tr)
    params, dparams, dcfg = fam.program_params(cfg, tr, h.seed, dev)
    sess = LlamaGenSession(cfg=mcfg, dcfg=dcfg, params=params,
                           dparams=dparams, passthrough_drafter=True,
                           device=dev)
    kw = dict(slots=tr["slots"], temperature=tr["temperature"],
              top_k=tr["top_k"], cfg_scale=tr["cfg_scale"], mode=tr["mode"],
              tree=tr["tree"], lantern_k=tr["lantern_k"],
              lantern_delta=tr["lantern_delta"], kv_quant=tr["kv_quant"])
    h.cfg_scale = tr["cfg_scale"]
    words, letters = tr["caption_words"], tr["word_letters"]
    warm = captions(rng, tr["slots"], words, letters)
    sess.generate_batch(warm, max_new=tr["warm_tokens"],
                        seed=int(rng.integers(1, 2 ** 40)), **kw)
    synchronize(dev)

    first = captions(rng, n, words, letters)
    base0 = int(rng.integers(1, 2 ** 40)) * 1024
    pick = h.sample(n, tr["check"]["requests"])
    h.capture.watch(base0 + int(i) for i in pick)
    calls = []
    h.open_window()
    t_open = last = time.perf_counter()
    while True:
        caps = first if not calls else captions(rng, n, words, letters)
        base = base0 if not calls else int(rng.integers(1, 2 ** 40)) * 1024
        reqs = sess.generate_batch(caps, max_new=cfg["image"]["tokens"],
                                   seed=base, **kw)
        synchronize(dev)
        now = time.perf_counter()
        calls.append((caps, reqs))
        dt, last = now - last, now
        if h.seconds - (now - t_open) < dt:
            break
    h.close_window()

    allreq = [r for _, rs in calls for r in rs]
    ok = [r for r in allreq if r.error is None]
    h.attempted, h.failed = len(allreq), len(allreq) - len(ok)
    h.tokens = sum(len(r.tokens) for r in ok)
    h.latencies = [r.latency for r in ok]
    if tr["mode"] != "ar":
        h.counters = {"accept_sum": sum(r.accept_sum for r in ok),
                      "slot_steps": sum(r.steps for r in ok)}
    caps, reqs = calls[0]
    h.checked = [dict(desc={"caption": caps[int(i)]},
                      served=np.asarray(reqs[int(i)].tokens, np.int64),
                      seed=base0 + int(i))
                 for i in pick if reqs[int(i)].error is None]
