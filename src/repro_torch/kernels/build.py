"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``kernels/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` process per source, all started together), the
objects are linked into one shared library with a plain C interface, and
the library is loaded with ``ctypes``.  Nothing here includes PyTorch's
headers, so a build takes seconds.  The build happens at the first
kernel launch, never at import; its output goes to ``kernels/build/``
(listed in ``.gitignore``), named by a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is reused.  A failed
build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds the last build in this process took (0.0 when a cached library
# was loaded) and what ptxas said about registers, shared memory, spills
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources():
    cu = sorted(CSRC.glob("*.cu"))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return cu, sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_kernels-{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile and link the kernels unless the library is already built."""
    global build_seconds, build_log
    out = library_path()
    if out.is_file():
        build_seconds = 0.0
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="tmp-"))
    try:
        procs = []
        for src in cu:
            obj = tmp / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib_tmp = tmp / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp),
             *[str(tmp / (s.stem + ".o")) for s in cu]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, out)          # atomic: concurrent builders agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    build_log = log
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.flash_attention_fwd.argtypes = [p] * 6 + [i] * 10 + [p]
            lib.flash_attention_fwd.restype = i
            lib.paged_decode_attention_fwd.argtypes = \
                [p] * 11 + [i] * 11 + [p]
            lib.paged_decode_attention_fwd.restype = i
            lib.decode_attention_fwd.argtypes = [p] * 9 + [i] * 8 + [p]
            lib.decode_attention_fwd.restype = i
            lib.linear_scan_fwd.argtypes = [p] * 3 + [i] * 3 + [p]
            lib.linear_scan_fwd.restype = i
            lib.prefix_attention_fwd.argtypes = [p] * 13 + [i] * 8 + [p]
            lib.prefix_attention_fwd.restype = i
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
