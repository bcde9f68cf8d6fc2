"""ctypes bindings for the native request queue (``native/scheduler.cc``).

Counterpart of ``lantern_tpu/native.py``.  The C++ source is the
repository's own, outside either package and importing nothing, so the
port reads it rather than keeping a second copy.  At first use ``g++``
compiles it into ``build/lantern_sched/liblantern_sched.so`` at the
repository root (listed in ``.gitignore``), again whenever the source is
newer than the library; nothing is written into ``native/``.  A build or
load failure raises: the scheduler's Python run loop is chosen explicitly
(``Scheduler(engine, use_native=False)``), never as a fallback.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Tuple

SOURCE = Path(__file__).resolve().parents[1] / "native" / "scheduler.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "lantern_sched"
LIB_PATH = BUILD_DIR / "liblantern_sched.so"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()
_lib = None


def _build() -> None:
    """Compile the queue into ``LIB_PATH`` (through a temporary file, so a
    concurrent loader never sees a half-written library)."""
    if not SOURCE.is_file():
        raise RuntimeError(f"native scheduler source missing: {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".{time.monotonic_ns()}.tmp")
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native scheduler build failed: {e}") from e
    if out.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native scheduler build failed:\n{out.stderr}")
    tmp.replace(LIB_PATH)


def library():
    """The queue's shared library, built at first call."""
    global _lib
    with _lock:
        if _lib is None:
            if (not LIB_PATH.exists()
                    or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime):
                _build()
            _lib = _bind(ctypes.CDLL(str(LIB_PATH)))
        return _lib


def _bind(lib):
    u64, i32, vp = ctypes.c_uint64, ctypes.c_int32, ctypes.c_void_p
    p_i32, p_u64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(u64)
    sigs = {
        "lantern_sched_create": (vp, [i32]),
        "lantern_sched_destroy": (None, [vp]),
        "lantern_sched_enqueue": (None, [vp, u64, i32, i32, u64]),
        "lantern_sched_fill_slots": (i32, [vp, p_i32, p_u64]),
        "lantern_sched_report_step": (i32, [vp, p_i32, p_i32, p_i32]),
        "lantern_sched_drain": (i32, [vp, i32, p_u64, p_i32, p_i32]),
        "lantern_sched_fail": (i32, [vp, u64]),
        "lantern_sched_num_failed": (i32, [vp]),
        "lantern_sched_num_waiting": (i32, [vp]),
        "lantern_sched_num_active": (i32, [vp]),
        "lantern_sched_totals": (None, [vp, p_u64]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


class NativeScheduler:
    """Request queue + slot table backed by the C++ runtime."""

    def __init__(self, num_slots: int):
        self._lib = library()
        self.num_slots = num_slots
        self._h = self._lib.lantern_sched_create(num_slots)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lantern_sched_destroy(self._h)
            self._h = None

    def enqueue(self, uid: int, prompt_len: int, max_new: int) -> None:
        """Admit a request; a uid already live, or >= 2**63, is dropped."""
        self._lib.lantern_sched_enqueue(self._h, uid, prompt_len, max_new,
                                        time.monotonic_ns())

    def fill_slots(self) -> List[Tuple[int, int]]:
        """Assign waiting requests to free slots: ``[(slot, uid)]``."""
        n = self.num_slots
        slots = (ctypes.c_int32 * n)()
        uids = (ctypes.c_uint64 * n)()
        k = self._lib.lantern_sched_fill_slots(self._h, slots, uids)
        return [(slots[i], uids[i]) for i in range(k)]

    def report_step(self, n_new, steps, accept_sum) -> int:
        """Per-slot progress after a step; returns how many requests
        finished (and freed their slots)."""
        n = self.num_slots
        a = (ctypes.c_int32 * n)(*[int(x) for x in n_new])
        b = (ctypes.c_int32 * n)(*[int(x) for x in steps])
        c = (ctypes.c_int32 * n)(*[int(x) for x in accept_sum])
        return self._lib.lantern_sched_report_step(self._h, a, b, c)

    def drain(self, cap: int = 64) -> List[Tuple[int, int, int]]:
        """Pop finished requests: ``[(uid, steps, accept_sum)]``."""
        uids = (ctypes.c_uint64 * cap)()
        steps = (ctypes.c_int32 * cap)()
        acc = (ctypes.c_int32 * cap)()
        k = self._lib.lantern_sched_drain(self._h, cap, uids, steps, acc)
        return [(uids[i], steps[i], acc[i]) for i in range(k)]

    def fail(self, uid: int) -> bool:
        """Drop a live request whose prefill failed; frees its slot."""
        return bool(self._lib.lantern_sched_fail(self._h, uid))

    @property
    def num_failed(self) -> int:
        return self._lib.lantern_sched_num_failed(self._h)

    @property
    def num_waiting(self) -> int:
        return self._lib.lantern_sched_num_waiting(self._h)

    @property
    def num_active(self) -> int:
        return self._lib.lantern_sched_num_active(self._h)

    def totals(self) -> dict:
        out = (ctypes.c_uint64 * 4)()
        self._lib.lantern_sched_totals(self._h, out)
        return {"enqueued": out[0], "completed": out[1],
                "tokens": out[2], "device_steps": out[3]}
