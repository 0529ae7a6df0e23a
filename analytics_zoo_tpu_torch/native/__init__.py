"""ctypes bindings for the native serving runtime (port of
``analytics_zoo_tpu/native/__init__.py``).

The C++ sources under ``native/src/`` are copies of the JAX package's
(``host_arena.cpp``, ``serving_queue.cpp``, ``serving_http.cpp``): host
code with a plain C interface, no CUDA. They build with ``g++`` at first
use into ``analytics_zoo_tpu_torch/build/``, under a file name that
hashes the sources and the flags (an edited source rebuilds), to a
temporary name first and then ``os.replace``-d into place, so processes
that build at once each see a whole library. The build is host code, not
a device program, so the recompile monitor (``common/diagnostics.py``)
never hears of it.

:func:`make_serving_queue` falls back to the Python queue where the
library cannot be built, with one logged warning; :func:`load_native`
returns None then and :func:`load_error` says why.
:class:`HostArena`, :class:`ServingQueue` and :class:`NativeHttpServer`
raise ``RuntimeError`` carrying that reason.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.common.nncontext import logger

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build")
SOURCES = ("host_arena.cpp", "serving_queue.cpp", "serving_http.cpp")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_lib = None
_lib_lock = threading.Lock()
_error: Optional[str] = None
_warned = False


def library_path() -> str:
    """Where the sources build to; the name hashes the sources and the
    flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for fname in SOURCES:
        with open(os.path.join(_SRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libzoo_native-{h.hexdigest()[:12]}.so")


def _build(out: str) -> None:
    """``g++`` the sources into ``out``: to a name of this process and
    thread, then renamed into place (atomic: a concurrent loader never
    sees a half-written library). Raises with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = (["g++", *CXX_FLAGS, "-o", tmp]
           + [os.path.join(_SRC_DIR, f) for f in SOURCES] + ["-lpthread"])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exit {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The C signatures (the JAX package's)."""
    P, S, L, I, C = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_long,
                     ctypes.c_int, ctypes.c_char_p)
    sigs = {
        "arena_create": (P, [S]),
        "arena_destroy": (None, [P]),
        "arena_alloc": (S, [P, S, S]),
        "arena_base": (P, [P]),
        "arena_used": (S, [P]),
        "arena_capacity": (S, [P]),
        "arena_reset": (None, [P]),
        "arena_copy": (None, [P, S, P, S]),
        "squeue_create": (P, []),
        "squeue_destroy": (None, [P]),
        "squeue_put": (None, [P, I]),
        "squeue_take": (I, [P, L]),
        "squeue_size": (I, [P]),
        "zoo_http_create": (P, [I, L]),
        "zoo_http_port": (I, [P]),
        "zoo_http_set_health": (None, [P, C]),
        "zoo_http_next": (L, [P, C, L, L, ctypes.POINTER(L), C, L]),
        "zoo_http_respond": (I, [P, L, I, C, L]),
        "zoo_http_respond_hdr": (I, [P, L, I, C, L, C]),
        "zoo_http_destroy": (None, [P]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be
    built or loaded (:func:`load_error` says why; the failure is kept,
    so a process tries once)."""
    global _lib, _error
    with _lib_lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            out = library_path()
            if not os.path.exists(out):
                _build(out)
            _lib = _bind(ctypes.CDLL(out))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
        return _lib


def load_error() -> Optional[str]:
    """Why :func:`load_native` returned None (None before a failure)."""
    return _error


def _require() -> ctypes.CDLL:
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native library unavailable ({_error})")
    return lib


class HostArena:
    """Bump-arena sample cache: ``put(array) -> offset``;
    ``view(offset, shape, dtype)`` is a zero-copy numpy view into the
    arena."""

    def __init__(self, capacity_bytes: int):
        self._lib = _require()
        self._handle = self._lib.arena_create(capacity_bytes)
        if not self._handle:
            raise MemoryError(f"arena_create({capacity_bytes}) failed")
        self.capacity = capacity_bytes

    def put(self, arr: np.ndarray) -> int:
        arr = np.ascontiguousarray(arr)
        off = self._lib.arena_alloc(self._handle, arr.nbytes, 64)
        if off == ctypes.c_size_t(-1).value:
            raise MemoryError("arena full")
        self._lib.arena_copy(self._handle, off,
                             arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
        return off

    def view(self, offset: int, shape, dtype) -> np.ndarray:
        base = self._lib.arena_base(self._handle)
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        buf = (ctypes.c_char * nbytes).from_address(base + offset)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    @property
    def used(self) -> int:
        return self._lib.arena_used(self._handle)

    def reset(self):
        self._lib.arena_reset(self._handle)

    def close(self):
        if self._handle:
            self._lib.arena_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ServingQueue:
    """Blocking pool of slot ids (``serving_queue.cpp``): ``take``
    returns -1 on timeout."""

    def __init__(self):
        self._lib = _require()
        self._handle = self._lib.squeue_create()

    def put(self, slot: int):
        self._lib.squeue_put(self._handle, slot)

    def take(self, timeout_ms: int = -1) -> int:
        return self._lib.squeue_take(self._handle, timeout_ms)

    def size(self) -> int:
        return self._lib.squeue_size(self._handle)

    def close(self):
        if self._handle:
            self._lib.squeue_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PyServingQueue:
    """The Python queue with :class:`ServingQueue`'s surface."""

    def __init__(self):
        self._q: "queue.Queue[int]" = queue.Queue()

    def put(self, slot: int):
        self._q.put(slot)

    def take(self, timeout_ms: int = -1) -> int:
        try:
            return self._q.get(
                timeout=None if timeout_ms < 0 else timeout_ms / 1000.0)
        except queue.Empty:
            return -1

    def size(self) -> int:
        return self._q.qsize()

    def close(self):
        pass


def make_serving_queue():
    """A :class:`ServingQueue`, or a :class:`PyServingQueue` where the
    library cannot be built (one warning per process)."""
    global _warned
    try:
        return ServingQueue()
    except RuntimeError as e:
        if not _warned:
            _warned = True
            logger.warning("native serving queue unavailable, using the "
                           "Python queue: %s", e)
        return PyServingQueue()


class NativeHttpServer:
    """The C++ HTTP front end (``src/serving_http.cpp``): accept, parse,
    queue and ``GET /health`` run native, off the GIL; Python pulls
    request bytes and posts response bytes."""

    def __init__(self, port: int = 0, max_body: int = 16 << 20):
        self._lib = _require()
        self._max_body = max_body
        self._handle = self._lib.zoo_http_create(port, max_body)
        if not self._handle:
            raise OSError(f"zoo_http_create({port}) failed")
        self._port = self._lib.zoo_http_port(self._handle)
        self._tls = threading.local()  # per-thread request buffers

    @property
    def port(self) -> int:
        return self._port

    def set_health(self, payload_json: str):
        if self._handle:
            self._lib.zoo_http_set_health(self._handle,
                                          payload_json.encode())

    def next_request(self, timeout_ms: int = -1):
        """``(req_id, path, body_bytes, trace_id or None)``, or None on
        timeout; raises ``StopIteration`` after :meth:`close`. The trace
        id is the request's ``X-Zoo-Trace-Id`` header, which the C++ side
        appends to the path after a ``\\n``. Buffers are per thread
        (reused across polls), so concurrent workers never share one."""
        if not self._handle:
            raise StopIteration
        if not hasattr(self._tls, "buf"):
            self._tls.buf = ctypes.create_string_buffer(self._max_body)
            self._tls.path = ctypes.create_string_buffer(1024)
        buf, path = self._tls.buf, self._tls.path
        rid = ctypes.c_long()
        n = self._lib.zoo_http_next(self._handle, buf, len(buf), timeout_ms,
                                    ctypes.byref(rid), path, len(path))
        if n == -1:
            return None
        if n == -2:
            raise StopIteration
        route, _, trace = path.value.decode().partition("\n")
        return rid.value, route, buf.raw[:n], trace or None

    def respond(self, req_id: int, status: int, body: bytes,
                trace_id: Optional[str] = None) -> bool:
        if not self._handle:
            return False
        if trace_id:
            return self._lib.zoo_http_respond_hdr(
                self._handle, req_id, status, body, len(body),
                trace_id.encode()) == 0
        return self._lib.zoo_http_respond(self._handle, req_id, status,
                                          body, len(body)) == 0

    def close(self):
        if self._handle:
            self._lib.zoo_http_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


__all__ = ["load_native", "load_error", "library_path", "HostArena",
           "ServingQueue", "PyServingQueue", "make_serving_queue",
           "NativeHttpServer"]
