"""ctypes bindings for the native host runtime (native/blah2_host.cpp).

Provides native-speed implementations of the host-side hot paths — the IQ
ring buffer coupling capture and process threads, the int16-quad replay
reader/recorder, and the chunked TCP sender — mirroring the reference's C++
host components (src/data/IqData.cpp, src/capture/rspduo/RspDuo.cpp:150-179,
src/process/utility/Socket.cpp). Falls back transparently: callers use
:func:`available` / the factory helpers and get the pure-Python versions
when the shared library is absent.

Build once with ``make -C native``; the wrapper also attempts a one-shot
build on import if a compiler is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libblah2host.so")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _try_build() -> None:
    if not os.path.isfile(os.path.join(_NATIVE_DIR, "Makefile")):
        return
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if not os.path.isfile(_LIB_PATH):
        _try_build()
    if not os.path.isfile(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        _bind(lib)
    except OSError:
        return None
    except AttributeError:
        # Stale prebuilt library missing newly added symbols: rebuild once
        # and retry; fall back to the pure-Python implementations otherwise.
        _try_build()
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            _bind(lib)
        except (OSError, AttributeError):
            return None
    _lib = lib
    return _lib


def _bind(lib) -> None:
    c_i64 = ctypes.c_int64
    c_fp = ctypes.POINTER(ctypes.c_float)
    lib.b2_ring_create.restype = ctypes.c_void_p
    lib.b2_ring_create.argtypes = [c_i64]
    lib.b2_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.b2_ring_close.argtypes = [ctypes.c_void_p]
    lib.b2_ring_len.restype = c_i64
    lib.b2_ring_len.argtypes = [ctypes.c_void_p]
    lib.b2_ring_dropped.restype = c_i64
    lib.b2_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.b2_ring_wait_len.restype = ctypes.c_int
    lib.b2_ring_wait_len.argtypes = [ctypes.c_void_p, c_i64, ctypes.c_double]
    lib.b2_ring_push.argtypes = [ctypes.c_void_p, c_fp, c_i64]
    lib.b2_ring_push_wait.restype = ctypes.c_int
    lib.b2_ring_push_wait.argtypes = [ctypes.c_void_p, c_fp, c_i64,
                                      ctypes.c_double]
    lib.b2_ring_pop.restype = ctypes.c_int
    lib.b2_ring_pop.argtypes = [ctypes.c_void_p, c_fp, c_i64,
                                ctypes.c_double]

    lib.b2_replay_open.restype = ctypes.c_void_p
    lib.b2_replay_open.argtypes = [ctypes.c_char_p]
    lib.b2_replay_close.argtypes = [ctypes.c_void_p]
    lib.b2_replay_rewind.argtypes = [ctypes.c_void_p]
    lib.b2_replay_read.restype = c_i64
    lib.b2_replay_read.argtypes = [ctypes.c_void_p, c_fp, c_fp, c_i64]
    lib.b2_record_append.restype = ctypes.c_int
    lib.b2_record_append.argtypes = [ctypes.c_char_p, c_fp, c_fp, c_i64]

    lib.b2_json_f32_matrix.restype = c_i64
    lib.b2_json_f32_matrix.argtypes = [c_fp, c_i64, c_i64,
                                       ctypes.c_char_p, c_i64]
    lib.b2_json_f64_vector.restype = c_i64
    lib.b2_json_f64_vector.argtypes = [ctypes.POINTER(ctypes.c_double),
                                       c_i64, ctypes.c_char_p, c_i64]

    lib.b2_tcp_connect.restype = ctypes.c_int
    lib.b2_tcp_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.b2_tcp_send_chunked.restype = ctypes.c_int
    lib.b2_tcp_send_chunked.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                        c_i64, ctypes.c_int]
    lib.b2_tcp_close.argtypes = [ctypes.c_int]


def available() -> bool:
    return _load() is not None


def _as_float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeIqRingBuffer:
    """Drop-in for :class:`blah2_tpu_torch.data.iq.IqRingBuffer` backed by C++."""

    def __init__(self, capacity: int, dtype=np.complex64):
        if dtype != np.complex64:
            raise ValueError("native ring buffer is complex64 only")
        lib = _load()
        if lib is None:
            raise RuntimeError("libblah2host.so not available")
        self._lib = lib
        self.capacity = int(capacity)
        self._h = lib.b2_ring_create(self.capacity)
        self.closed = False

    def __len__(self) -> int:
        return int(self._lib.b2_ring_len(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.b2_ring_dropped(self._h))

    def wait_for(self, n: int, timeout=None) -> bool:
        t = -1.0 if timeout is None else float(timeout)
        return bool(self._lib.b2_ring_wait_len(self._h, int(n), t))

    def close(self) -> None:
        self.closed = True
        self._lib.b2_ring_close(self._h)

    def __del__(self):
        try:
            if self._h:
                self._lib.b2_ring_destroy(self._h)
                self._h = None
        except Exception:
            pass

    @staticmethod
    def _prep(block: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(block, dtype=np.complex64)

    def push(self, block: np.ndarray) -> None:
        block = self._prep(block)
        self._lib.b2_ring_push(
            self._h, _as_float_ptr(block.view(np.float32)), len(block))

    def push_wait(self, block: np.ndarray,
                  timeout: Optional[float] = None) -> bool:
        block = self._prep(block)
        t = -1.0 if timeout is None else float(timeout)
        return bool(self._lib.b2_ring_push_wait(
            self._h, _as_float_ptr(block.view(np.float32)), len(block), t))

    def pop(self, n: int, timeout: Optional[float] = None
            ) -> Optional[np.ndarray]:
        out = np.empty(n, dtype=np.complex64)
        t = -1.0 if timeout is None else float(timeout)
        ok = self._lib.b2_ring_pop(
            self._h, _as_float_ptr(out.view(np.float32)), n, t)
        return out if ok else None


def make_ring_buffer(capacity: int, dtype=np.complex64, prefer_native=True):
    """Factory: native ring when built, Python ring otherwise."""
    if prefer_native and dtype == np.complex64 and available():
        return NativeIqRingBuffer(capacity)
    from blah2_tpu_torch.data.iq import IqRingBuffer

    return IqRingBuffer(capacity, dtype=dtype)


class NativeReplayReader:
    """Block reader for int16-quad IQ record files."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("libblah2host.so not available")
        self._lib = lib
        self._h = lib.b2_replay_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)

    def read(self, max_samples: int):
        """Returns (ch1, ch2) complex64 arrays; empty at EOF."""
        ch1 = np.empty(max_samples, dtype=np.complex64)
        ch2 = np.empty(max_samples, dtype=np.complex64)
        n = int(self._lib.b2_replay_read(
            self._h, _as_float_ptr(ch1.view(np.float32)),
            _as_float_ptr(ch2.view(np.float32)), max_samples))
        return ch1[:n], ch2[:n]

    def rewind(self) -> None:
        self._lib.b2_replay_rewind(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.b2_replay_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def record_append(path: str, ch1: np.ndarray, ch2: np.ndarray) -> bool:
    """Append both channels to an int16-quad record file natively."""
    lib = _load()
    if lib is None:
        return False
    ch1 = np.ascontiguousarray(ch1, dtype=np.complex64)
    ch2 = np.ascontiguousarray(ch2, dtype=np.complex64)
    n = min(len(ch1), len(ch2))
    return bool(lib.b2_record_append(
        path.encode(), _as_float_ptr(ch1.view(np.float32)),
        _as_float_ptr(ch2.view(np.float32)), n))


def json_f32_matrix(arr: np.ndarray) -> Optional[str]:
    """2-D float array → JSON "[[…],[…]]" with 2-decimal wire formatting.

    Returns None when the native library is unavailable (callers fall back
    to Python serialization).
    """
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.float32)
    rows, cols = a.shape
    cap = 16 * rows * cols + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.b2_json_f32_matrix(_as_float_ptr(a), rows, cols, buf, cap)
    if n < 0:
        return None
    return buf.raw[:n].decode()


def json_f64_vector(arr: np.ndarray) -> Optional[str]:
    """1-D float array → JSON "[…]" with 2-decimal wire formatting."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr, dtype=np.float64)
    cap = 24 * len(a) + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.b2_json_f64_vector(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(a), buf, cap)
    if n < 0:
        return None
    return buf.raw[:n].decode()


class NativeTcpSender:
    """Chunked JSON/TCP egress (Socket.cpp contract, 1024-byte chunks)."""

    def __init__(self, ip: str, port: int, chunk: int = 1024):
        lib = _load()
        if lib is None:
            raise RuntimeError("libblah2host.so not available")
        self._lib = lib
        self.ip, self.port, self.chunk = ip, int(port), int(chunk)
        self._fd = -1

    def _connect(self) -> bool:
        if self._fd >= 0:
            return True
        self._fd = int(self._lib.b2_tcp_connect(self.ip.encode(), self.port))
        return self._fd >= 0

    def send_data(self, payload: str) -> bool:
        data = payload.encode()
        if not self._connect():
            return False
        ok = self._lib.b2_tcp_send_chunked(self._fd, data, len(data),
                                           self.chunk)
        if not ok:
            self._lib.b2_tcp_close(self._fd)
            self._fd = -1
            if not self._connect():
                return False
            ok = self._lib.b2_tcp_send_chunked(self._fd, data, len(data),
                                               self.chunk)
        return bool(ok)

    def close(self) -> None:
        if self._fd >= 0:
            self._lib.b2_tcp_close(self._fd)
            self._fd = -1
