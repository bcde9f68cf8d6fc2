"""Continuous-batching request scheduler (host side).

Counterpart of ``lantern_tpu/engine/scheduler.py``: drives a
``BatchedEngine``, keeps its R slots busy by refilling finished slots from a
queue between steps, and collects per-request outputs and stats in the
input order.  Two run loops:

- the native loop (the default): the request queue and slot table live in
  the C++ runtime of ``native/scheduler.cc`` (``lantern_tpu_torch.native``;
  a build failure raises);
- the Python loop (``use_native=False``), the same lifecycle in plain
  Python.

Both fill EVERY free slot from the arrived queue at the top of every
iteration, the idle one included.  (The JAX Python loop refills a slot only
when another one completes, so after a drain two requests that arrive
together run one after the other; that fault is not carried over.  A
request's tokens do not depend on its slot, so no result changes.)

Failure capture: a request whose prefill raises (or that arrives with
``error`` set) is recorded with its error and the batch keeps serving.  On
the card a kernel fault would then look like a failed request, and CUDA
errors are sticky, so callers that test the card check every ``error``.

Each request draws from ``spec.request_generator(seed)``, the stream a
lone ``spec.generate`` of the same seed draws from.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Optional

import numpy as np

from .batch import BatchedEngine
from .spec import request_generator


@dataclasses.dataclass
class Request:
    uid: Any
    cond: Any = None
    uncond: Any = None
    token_prompt: Any = None
    prefix_valid: Any = None       # [2, S] pad mask (left-padded captions)
    seed: int = 0
    # open-loop arrival offset in seconds from Scheduler.run() start; None =
    # available immediately.  A request is admitted once its time passes.
    arrival_time: Optional[float] = None
    # results
    tokens: Optional[np.ndarray] = None
    steps: int = 0
    accept_sum: int = 0
    latency: float = 0.0           # completion - service start (prefill)
    e2e_latency: float = 0.0       # completion - arrival (includes queueing)
    error: Optional[str] = None    # set when the request failed at prefill
    _t0: float = 0.0

    @property
    def step_compression(self) -> float:
        return self.accept_sum / max(self.steps, 1)


class Scheduler:
    """Drives a ``BatchedEngine`` over a request list, on the native queue
    (``use_native=True``, the default) or the Python loop."""

    def __init__(self, engine: BatchedEngine, use_native: bool = True):
        self.engine = engine
        self.use_native = use_native

    def run(self, requests: List[Request],
            progress: bool = False) -> List[Request]:
        self._t_run0 = time.perf_counter()
        done = (self._run_native(requests, progress) if self.use_native
                else self._run_python(requests, progress))
        order = {id(r): i for i, r in enumerate(requests)}
        done.sort(key=lambda r: order[id(r)])
        return done

    # ------------------------------------------------------------------
    def _arrived(self, req: Request) -> bool:
        return (req.arrival_time is None
                or time.perf_counter() - self._t_run0 >= req.arrival_time)

    def _wait_for(self, req: Request) -> None:
        """Sleep (in slices of at most 50 ms) until ``req`` arrives."""
        nxt = self._t_run0 + (req.arrival_time or 0.0)
        time.sleep(max(0.0, min(0.05, nxt - time.perf_counter())))

    def _finish(self, req: Request) -> None:
        now = time.perf_counter()
        req.latency = now - req._t0
        req.e2e_latency = now - (self._t_run0 + (req.arrival_time or 0.0))

    def _prefill(self, req: Request):
        """Prefill ``req``, or record its failure and return None."""
        req._t0 = time.perf_counter()
        try:
            if req.error is not None:
                # failed upstream (prompt or cond construction)
                raise RuntimeError(req.error)
            eng = self.engine
            return eng.prefill(req.cond, req.uncond,
                               request_generator(req.seed, eng.device),
                               token_prompt=req.token_prompt,
                               prefix_valid=req.prefix_valid)
        except Exception as e:  # noqa: BLE001 — keep the batch serving
            if req.error is None:
                req.error = f"{type(e).__name__}: {e}"
            self._finish(req)
            return None

    def _complete(self, req: Request, batch, slot: int, steps, acc,
                  progress: bool) -> None:
        req.tokens = self.engine.slot_tokens(batch, slot)
        req.steps = int(steps)
        req.accept_sum = int(acc)
        self._finish(req)
        if progress:
            print(f"request {req.uid}: steps={req.steps} "
                  f"compression={req.step_compression:.3f}")

    @staticmethod
    def _failed(req: Request, progress: bool) -> None:
        if progress:
            print(f"request {req.uid} FAILED: {req.error}")

    # ------------------------------------------------------------------
    def _run_native(self, requests: List[Request],
                    progress: bool) -> List[Request]:
        from ..native import NativeScheduler

        eng = self.engine
        sched = NativeScheduler(eng.num_slots)
        by_uid = {}
        # requests enter the native queue once their arrival time passes
        pending = deque(sorted(requests, key=lambda r: r.arrival_time or 0.0))
        batch = None
        slot_uid = [0] * eng.num_slots
        done: List[Request] = []
        while sched.num_active or sched.num_waiting or pending:
            while pending and self._arrived(pending[0]):
                uid = len(by_uid) + 1
                by_uid[uid] = pending.popleft()
                sched.enqueue(uid, prompt_len=0, max_new=eng.ecfg.max_new)
            # every free slot, until the arrived queue is empty (a failed
            # prefill frees its slot for the next request at once)
            while True:
                pairs = sched.fill_slots()
                if not pairs:
                    break
                for slot, uid in pairs:
                    req = by_uid[uid]
                    pre = self._prefill(req)
                    if pre is None:
                        sched.fail(uid)
                        done.append(req)
                        self._failed(req, progress)
                        continue
                    if batch is None:
                        batch = eng.empty_batch(pre)
                    batch = eng.insert(batch, slot, pre)
                    slot_uid[slot] = uid
            if not sched.num_active:
                if pending and not sched.num_waiting:
                    self._wait_for(pending[0])
                continue
            batch = eng.step(batch)
            n_new, steps, acc = eng.slot_status(batch)
            # capture finished slots' tokens before the queue refills them
            before = list(slot_uid)
            newly = sched.report_step(n_new, steps, acc)
            drained = []
            while len(drained) < newly:
                got = sched.drain()
                if not got:
                    break
                drained.extend(got)
            for uid, st, ac in drained:
                req = by_uid[uid]
                self._complete(req, batch, before.index(uid), st, ac,
                               progress)
                done.append(req)
        return done

    def _run_python(self, requests: List[Request],
                    progress: bool) -> List[Request]:
        eng = self.engine
        queue = deque(sorted(requests, key=lambda r: r.arrival_time or 0.0))
        done: List[Request] = []
        slots: List[Optional[Request]] = [None] * eng.num_slots
        batch = None

        def next_prefilled():
            """Pop ARRIVED requests until one prefills cleanly; failed ones
            are recorded and the batch keeps serving."""
            while queue and self._arrived(queue[0]):
                req = queue.popleft()
                pre = self._prefill(req)
                if pre is not None:
                    return req, pre
                done.append(req)
                self._failed(req, progress)
            return None, None

        while queue or any(r is not None for r in slots):
            for s in range(eng.num_slots):
                if slots[s] is None:
                    req, pre = next_prefilled()
                    if req is None:
                        break
                    if batch is None:
                        batch = eng.empty_batch(pre)
                    batch = eng.insert(batch, s, pre)
                    slots[s] = req
            if all(r is None for r in slots):
                if queue:
                    self._wait_for(queue[0])
                continue
            batch = eng.step(batch)
            n_new, steps, acc = eng.slot_status(batch)
            for s, req in enumerate(slots):
                if req is not None and n_new[s] >= eng.ecfg.max_new:
                    self._complete(req, batch, s, steps[s], acc[s], progress)
                    done.append(req)
                    slots[s] = None
        return done
