"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The library's file name carries a hash of its sources and
flags, so an edited source rebuilds and an unchanged one loads from
``analytics_zoo_tpu_torch/build/``. :func:`build` starts one ``nvcc``
per source, all at once. Nothing here runs at import: the CPU tests
import every module on machines without ``nvcc``.

These are the port's compiles, so each is announced to the recompile
monitor (``common/diagnostics.py``): ``cuda_build/build`` for a library
compiled, inside :func:`build`'s ``expected_compiles`` bracket (a
build is asked for), and ``cuda_build/load`` for a library loaded into
the process at first use, which is watched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

from analytics_zoo_tpu_torch.common import diagnostics

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "compiled at first use with the CUDA toolkit")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to; the name hashes the source,
    the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Sequence[str]) -> Dict[str, float]:
    """Compile every library of ``names`` not built yet, one ``nvcc``
    per source, all started together. Returns the seconds each build
    took (0 for one found built). Raises with the compiler's output if
    any build fails. ``nvcc -Xptxas=-v``'s report (registers, shared
    memory, spills) is kept beside each library as ``<lib>.log``."""
    with diagnostics.expected_compiles():
        return _build(names)


def _build(names: Sequence[str]) -> Dict[str, float]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    started = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                            f"{log}")
            continue
        with open(out + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, out)   # atomic: a concurrent loader never sees
        # a half-written library
        diagnostics.compile_event("cuda_build/build", seconds[name])
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            t0 = time.perf_counter()
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
            diagnostics.compile_event("cuda_build/load",
                                      time.perf_counter() - t0)
        return lib


def loaded() -> "tuple[str, ...]":
    """The names of the libraries this process has loaded (and built
    where they were missing), in order: a serving warm-up that did its
    work leaves none for the first request to load."""
    with _lock:
        return tuple(_libs)


def last_kernel(name: str) -> str:
    """The kernel instance ``csrc/<name>.cu``'s library launched last on
    the calling thread, as the profiler names it without namespace and
    parameters (``"matmul_bn_sm90_kernel<64, true>"``; ``""`` before the
    first launch). The library keeps this record itself
    (``csrc/last_launch.cuh``): a check of which route a call took that
    does not rest on a profiler window. Libraries without the record
    raise ``AttributeError``."""
    fn = getattr(load(name), name + "_last_kernel")
    fn.argtypes = []
    fn.restype = ctypes.c_char_p
    return fn().decode()
