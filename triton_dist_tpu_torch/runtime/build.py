"""Kernel builder: nvcc into shared libraries with a plain C interface.

Each ``csrc/<name>.cu`` compiles on first use into
``csrc/build/<name>-<hash>.so`` (the directory is git-ignored), keyed by a
hash of the sources, the shared headers and the flags, so an edited source
rebuilds and an unchanged one is reused within a checkout. The library is
loaded with ctypes; the kernel modules declare each C function's argument
types (pointers and the stream as ``c_void_p``) and raise when the C
function returns a non-zero ``cudaError_t``.

Nothing here runs at import time: ``nvcc`` exists only on the machine with
the card, and the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_LOADED: dict[str, ctypes.CDLL] = {}   # name -> library, per process


def all_sources() -> list[str]:
    """Every ``csrc/<name>.cu`` of the port. A program that starts one
    process per rank builds them all in the parent first (``build``); the
    ranks then only load the libraries, instead of running one nvcc per
    rank on the same sources."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then the
    toolkit's default prefix. Raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only where the toolkit is")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to for the current sources."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, str]:
    """Compile every named source whose library is missing, one nvcc
    process per source, all started together. Returns {name: compiler
    output} for the sources built now (ptxas' register/smem report, also
    kept beside each library as ``<name>-<hash>.ptxas``); raises with the
    compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
    jobs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        try:
            text, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += f"\n(nvcc killed after {NVCC_TIMEOUT_S} s)"
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc={proc.returncode}) ---\n{text}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".ptxas").write_text(text)
        reports[name] = text
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C function ``symbol`` of ``csrc/<name>.cu`` with its argument types
    declared and an int (cudaError_t) result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
