"""ctypes bindings for the native real-time runtime (native/ocs2rt.cpp).

The native layer re-implements the reference's host-side runtime primitives
(BufferedValue.h:46 / Synchronized.h:111 double buffering, ExecuteAndSleep.h
rate loops, SetThreadPriority.h) — see native/ocs2rt.cpp.  The library is
built by native/Makefile; this module runs `make -C native` before the
first load, which rebuilds the shared object whenever the tracked source is
newer (the lazy-compile-and-cache pattern the reference uses for CppAD
generated models, CppAdInterface.cpp:98-108).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "build", "libocs2rt.so"))

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> None:
    subprocess.run(
        ["make", "-C", os.path.abspath(_NATIVE_DIR)],
        check=True,
        capture_output=True,
    )


def load_library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        _build_library()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.ocs2rt_store_create.restype = ctypes.c_void_p
        lib.ocs2rt_store_create.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.ocs2rt_store_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ocs2rt_store_write.restype = ctypes.c_int
        lib.ocs2rt_store_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.ocs2rt_store_read.restype = ctypes.c_int64
        lib.ocs2rt_store_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.ocs2rt_store_seq.restype = ctypes.c_uint64
        lib.ocs2rt_store_seq.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_store_capacity.restype = ctypes.c_uint64
        lib.ocs2rt_store_capacity.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_rate_create.restype = ctypes.c_void_p
        lib.ocs2rt_rate_create.argtypes = [ctypes.c_double]
        lib.ocs2rt_rate_wait.restype = ctypes.c_int
        lib.ocs2rt_rate_wait.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_rate_ticks.restype = ctypes.c_uint64
        lib.ocs2rt_rate_ticks.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_rate_missed.restype = ctypes.c_uint64
        lib.ocs2rt_rate_missed.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_rate_destroy.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_monotonic_time.restype = ctypes.c_double
        lib.ocs2rt_set_realtime_priority.restype = ctypes.c_int
        lib.ocs2rt_set_realtime_priority.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


class PolicyStore:
    """Seqlock blob store for MPC -> MRT policy handoff.

    In-process (name=None) or cross-process via POSIX shared memory
    (name='/ocs2_policy').  Single writer (the MPC side), any readers (the
    MRT side) — the native analogue of MRT_BASE's buffered policy +
    updatePolicy() swap (MRT_BASE.h:148)."""

    def __init__(self, capacity: int, name: Optional[str] = None,
                 create: bool = True):
        self._lib = load_library()
        self.capacity = capacity
        self.name = name
        self._h = self._lib.ocs2rt_store_create(
            name.encode() if name else None, capacity, 1 if create else 0
        )
        if not self._h:
            raise OSError(f"failed to create policy store (name={name!r})")
        # On attach the native layer adopts the CREATOR's capacity (it
        # validates the shm header before mapping the payload, so a
        # mismatched caller capacity can neither SIGBUS nor truncate).
        self.capacity = int(self._lib.ocs2rt_store_capacity(self._h))
        self._owner = create
        self._last_seq = 0
        self._buf = ctypes.create_string_buffer(self.capacity)

    def write(self, blob: bytes) -> None:
        rc = self._lib.ocs2rt_store_write(self._h, blob, len(blob))
        if rc != 0:
            raise ValueError(
                f"blob of {len(blob)} bytes exceeds capacity {self.capacity}"
            )

    def read(self, only_new: bool = True) -> Optional[bytes]:
        """Latest blob, or None when empty / unchanged (only_new)."""
        seq = ctypes.c_uint64(0)
        size = self._lib.ocs2rt_store_read(
            self._h, self._buf, self.capacity,
            self._last_seq if only_new else 0,
            ctypes.byref(seq),
        )
        if size in (0, -2):
            return None
        if size < 0:
            raise OSError("policy store read failed")
        self._last_seq = seq.value
        return self._buf.raw[:size]

    def close(self, unlink: bool = False) -> None:
        if self._h:
            self._lib.ocs2rt_store_close(self._h, 1 if unlink else 0)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RateLoop:
    """Deadline-accurate rate loop (ExecuteAndSleep analogue)."""

    def __init__(self, frequency_hz: float):
        self._lib = load_library()
        self._h = self._lib.ocs2rt_rate_create(1.0 / frequency_hz)

    def wait(self) -> int:
        """Sleep to the next tick; returns missed deadlines skipped."""
        return self._lib.ocs2rt_rate_wait(self._h)

    @property
    def ticks(self) -> int:
        return self._lib.ocs2rt_rate_ticks(self._h)

    @property
    def missed(self) -> int:
        return self._lib.ocs2rt_rate_missed(self._h)

    def __del__(self):
        try:
            if self._h:
                self._lib.ocs2rt_rate_destroy(self._h)
        except Exception:
            pass


def monotonic_time() -> float:
    return load_library().ocs2rt_monotonic_time()


def set_realtime_priority(priority: int = 50) -> bool:
    """Best-effort SCHED_FIFO (SetThreadPriority.h); False when lacking
    CAP_SYS_NICE."""
    return load_library().ocs2rt_set_realtime_priority(priority) == 0
