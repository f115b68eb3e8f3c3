"""Builds the hand-written CUDA kernels in ``ops/csrc`` at first use.

Each ``.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds, not minutes). Libraries go to
``ops/_kernels/`` (listed in ``.gitignore``) under a name keyed by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_kernels")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

# source -> extra nvcc flags. nms.cu keeps its IoU test free of FMA
# contraction so that `IoU > thres` decides exactly as the plain version;
# qgemm.cu writes its epilogue with round-to-nearest intrinsics instead.
# stem.cu (cp.async, wgmma) and nms.cu (clusters, distributed shared memory)
# need sm_90a and nothing beyond the CUDA runtime: no flag of their own.
SOURCES = {"decode.cu": [], "nms.cu": ["--fmad=false"], "stem.cu": [],
           "qgemm.cu": []}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

# Launch counts by kernel name. Each wrapper adds one where it launches its
# kernel and nowhere else; a caller clears it before a run and reads it
# after, to show that the run went through the kernels. (K1, whose launch
# decodes several heads, also counts those heads, as "decode_heads_decoded".)
launches: collections.Counter = collections.Counter()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return nvcc


def _target(source: str) -> tuple[str, list]:
    flags = ARCH + BASE_FLAGS + SOURCES[source]
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem = os.path.splitext(source)[0]
    return (os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so"),
            flags)


def _start(source: str):
    """Start nvcc for ``source`` unless its library exists. Returns
    (library path, process or None, temporary output path)."""
    path, flags = _target(source)
    if os.path.exists(path):
        return path, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", tmp, os.path.join(CSRC, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return path, proc, tmp


def build_all(sources=None) -> dict:
    """Build (in parallel, one nvcc per source) and load every kernel
    library not loaded yet. Returns {source: ctypes.CDLL}."""
    sources = list(SOURCES) if sources is None else list(sources)
    with _lock:
        todo = [s for s in sources if s not in _libs]
        started = [(s, *_start(s)) for s in todo]
        errors = []
        for source, path, proc, tmp in started:
            if proc is None:
                continue
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {source} "
                              f"(exit {proc.returncode}):\n{out}")
                if os.path.exists(tmp):
                    os.remove(tmp)
            else:
                os.replace(tmp, path)     # atomic: readers never see a part
        if errors:
            raise RuntimeError("\n".join(errors))
        for source, path, _, _ in started:
            _libs[source] = ctypes.CDLL(path)
        return {s: _libs[s] for s in sources}


def library(source: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    lib = _libs.get(source)
    return lib if lib is not None else build_all([source])[source]


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel's C entry (its
    ``cudaGetLastError()`` right after the launch)."""
    if status != 0:
        lib.dyk_error_string.restype = ctypes.c_char_p
        lib.dyk_error_string.argtypes = [ctypes.c_int]
        msg = lib.dyk_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg}) at launch")
