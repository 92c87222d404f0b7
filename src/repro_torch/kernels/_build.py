"""Build and load the port's hand-written CUDA kernels.

At first use every ``csrc/*.cu`` source is compiled by its own ``nvcc``
process (all started together) for ``sm_90a``, the objects are linked
into ``build/repro_torch/libceaz_kernels.so`` and the library is loaded
with ``ctypes``. The sources have a plain C interface: pointers and the
CUDA stream travel as ``c_void_p``, and every entry returns
``cudaGetLastError()`` so a refused launch raises here instead of
passing unnoticed. A stamp of the sources and flags lets a later
process reuse the library; a file lock keeps concurrent processes from
building over each other.

Numerics: no ``--use_fast_math`` and ``-fmad=false`` — the dual-quant
kernel must round each f32 step exactly as the reference does, so no
multiply-add may be contracted into an FMA.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "libceaz_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, ctypes._CFuncPtr] = {}
build_seconds: Optional[float] = None      # wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (put nvcc on PATH or set CUDA_HOME)")


def _stamp(sources: Sequence[Path]) -> str:
    h = hashlib.sha1(" ".join(ARCH + FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _compile(sources: Sequence[Path]) -> None:
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    log, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out.decode(errors='replace')}")
        if p.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "ptxas.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    objs = [str(BUILD_DIR / (s.stem + ".o")) for s in sources]
    tmp = BUILD_DIR / (LIB_NAME + ".tmp")
    res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *objs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    os.replace(tmp, BUILD_DIR / LIB_NAME)


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(CSRC.glob("*.cu"))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stamp = _stamp(sources)
        stamp_file = BUILD_DIR / "stamp"
        with open(BUILD_DIR / "lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if (not (BUILD_DIR / LIB_NAME).exists()
                        or not stamp_file.exists()
                        or stamp_file.read_text() != stamp):
                    t0 = time.perf_counter()
                    _compile(sources)
                    stamp_file.write_text(stamp)
                    build_seconds = time.perf_counter() - t0
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
        lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
        lib.ceaz_error_string.argtypes = [ctypes.c_int]
        lib.ceaz_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry `name` with its argument types declared (pointers and
    the stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise when a C entry reports a CUDA error for its launch."""
    if rc != 0:
        msg = library().ceaz_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"error {rc} ({msg})")


def ptxas_log() -> str:
    """What ptxas reported per kernel (registers, shared memory, spills)
    for the last build, or '' when this process reused a build."""
    path = BUILD_DIR / "ptxas.log"
    return path.read_text() if path.exists() else ""
