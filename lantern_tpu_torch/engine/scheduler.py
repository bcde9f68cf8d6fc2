"""Continuous-batching request scheduler (host side).

Counterpart of ``lantern_tpu/engine/scheduler.py``: drives a
``BatchedEngine``, keeps its R slots busy by refilling finished slots from a
queue between steps, and collects per-request outputs and stats in the
input order.  One run loop over either of two slot tables (the request
queue, which request holds which slot, and each one's progress):

- the native table (the default): the C++ runtime of
  ``native/scheduler.cc`` (``lantern_tpu_torch.native``; a build failure
  raises);
- the Python table (``use_native=False``), ``SlotTable``, whose members
  answer the loop's calls as the native table's do.

The loop fills EVERY free slot from the arrived queue at the top of every
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

Over a (dp, tp) mesh (the engine's ``mesh``) request ``i`` goes to dp row
``i % dp`` (``parallel.dist.shard_requests``' deal), each row serves its
share on its own slots, and the results are gathered over dp
(``all_gather_object``) into every rank's list in the input order.  A
request's tokens do not depend on its slot, so the list equals one
process's.  The tp ranks of a dp row run in lockstep: the device values
they read back are the same bytes, and the two decisions that each would
take on its own take them together, since each process has its own clock
and its own faults: how many requests have arrived (tp rank 0's clock,
broadcast over the row) and whether a prefill failed (on any rank of the
row: then on all of them).  Without that, one rank could prefill while its
peer steps, and their collectives would pair up across different shapes.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as tdist

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


class SlotTable:
    """The Python slot table: the members of ``native.NativeScheduler``
    that the run loop calls.  Waiting uids take the free slots in slot
    order; a request finishes when its slot reports ``max_new`` tokens."""

    def __init__(self, num_slots: int):
        self.queue: deque = deque()              # waiting uids
        self.slots: List[Optional[int]] = [None] * num_slots
        self.max_new = {}                        # live uid -> max_new
        self.finished: deque = deque()           # (uid, steps, accept_sum)

    def enqueue(self, uid: int, prompt_len: int, max_new: int) -> None:
        if uid not in self.max_new:              # a live uid is dropped
            self.max_new[uid] = max_new
            self.queue.append(uid)

    def fill_slots(self) -> List[tuple]:
        free = [i for i, u in enumerate(self.slots) if u is None]
        pairs = [(i, self.queue.popleft()) for i in free[:len(self.queue)]]
        for i, uid in pairs:
            self.slots[i] = uid
        return pairs

    def report_step(self, n_new, steps, accept_sum) -> int:
        done = [i for i, u in enumerate(self.slots)
                if u is not None and n_new[i] >= self.max_new[u]]
        for i in done:
            uid, self.slots[i] = self.slots[i], None
            del self.max_new[uid]
            self.finished.append((uid, int(steps[i]), int(accept_sum[i])))
        return len(done)

    def drain(self, cap: int = 64) -> List[tuple]:
        return [self.finished.popleft()
                for _ in range(min(cap, len(self.finished)))]

    def fail(self, uid: int) -> bool:
        if self.max_new.pop(uid, None) is None:
            return False
        self.slots = [None if u == uid else u for u in self.slots]
        if uid in self.queue:
            self.queue.remove(uid)
        return True

    @property
    def num_active(self) -> int:
        return sum(u is not None for u in self.slots)

    @property
    def num_waiting(self) -> int:
        return len(self.queue)


class Scheduler:
    """Drives a ``BatchedEngine`` over a request list, on the native slot
    table (``use_native=True``, the default) or ``SlotTable``."""

    def __init__(self, engine: BatchedEngine, use_native: bool = True):
        self.engine = engine
        self.use_native = use_native

    @torch.no_grad()
    def run(self, requests: List[Request],
            progress: bool = False) -> List[Request]:
        mesh = self.engine.mesh
        dp = 1 if mesh is None else mesh.dp
        mine = requests[mesh.dp_rank::dp] if dp > 1 else requests
        # the tp row that decides admission together, and its rank 0
        self._tp = None if mesh is None or mesh.tp == 1 else mesh.tp_group
        self._tp_root = 0 if mesh is None else mesh.dp_rank * mesh.tp
        self._t_run0 = time.perf_counter()
        done = self._run(mine, progress)
        if dp > 1:
            done = self._gather(requests, done, mesh)
        order = {id(r): i for i, r in enumerate(requests)}
        done.sort(key=lambda r: order[id(r)])
        return done

    # results a dp row sends the others
    _RESULTS = ("tokens", "steps", "accept_sum", "latency", "e2e_latency",
                "error")

    def _gather(self, requests: List[Request], done: List[Request],
                mesh) -> List[Request]:
        """Every dp row's results, written into ``requests`` (by input
        index) on every rank."""
        index = {id(r): i for i, r in enumerate(requests)}
        mine = [(index[id(r)], {k: getattr(r, k) for k in self._RESULTS})
                for r in done]
        rows = [None] * mesh.dp
        tdist.all_gather_object(rows, mine, group=mesh.dp_group)
        for row in rows:
            for i, res in row:
                for k, v in res.items():
                    setattr(requests[i], k, v)
        return list(requests)

    # ------------------------------------------------------------------
    def _arrived(self, req: Request) -> bool:
        return (req.arrival_time is None
                or time.perf_counter() - self._t_run0 >= req.arrival_time)

    def _arrivals(self, pending) -> int:
        """How many of ``pending`` (sorted by arrival) have arrived: by tp
        rank 0's clock on every rank of its row."""
        n = 0
        while n < len(pending) and self._arrived(pending[n]):
            n += 1
        if self._tp is None or all(r.arrival_time is None for r in pending):
            return n
        box = [n]
        tdist.broadcast_object_list(box, src=self._tp_root, group=self._tp)
        return box[0]

    def _row_error(self, err: Optional[str]) -> Optional[str]:
        """The first tp rank's prefill error (in rank order), on every rank
        of the row: a request fails on all of them or on none."""
        if self._tp is None:
            return err
        errs = [None] * tdist.get_world_size(self._tp)
        tdist.all_gather_object(errs, err, group=self._tp)
        return next((e for e in errs if e is not None), None)

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
        pre = err = None
        try:
            if req.error is not None:
                # failed upstream (prompt or cond construction)
                raise RuntimeError(req.error)
            eng = self.engine
            pre = eng.prefill(req.cond, req.uncond,
                              request_generator(req.seed, eng.device),
                              token_prompt=req.token_prompt,
                              prefix_valid=req.prefix_valid)
        except Exception as e:  # noqa: BLE001 — keep the batch serving
            err = f"{type(e).__name__}: {e}"
        err = self._row_error(err)
        if err is None:
            return pre
        if req.error is None:
            req.error = err
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
    def _run(self, requests: List[Request],
             progress: bool) -> List[Request]:
        eng = self.engine
        if self.use_native:
            from ..native import NativeScheduler
            sched = NativeScheduler(eng.slots)
        else:
            sched = SlotTable(eng.slots)
        by_uid = {}
        # requests enter the queue once their arrival time passes
        pending = deque(sorted(requests, key=lambda r: r.arrival_time or 0.0))
        batch = None
        slot_uid = [0] * eng.slots
        done: List[Request] = []
        while sched.num_active or sched.num_waiting or pending:
            for _ in range(self._arrivals(pending)):
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
