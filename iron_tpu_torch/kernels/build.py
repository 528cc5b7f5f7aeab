"""Build and load the port's CUDA kernels.

Each source in `csrc/*.cu` is compiled by `nvcc` for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes.  The build runs
at the first CUDA call (never at import: the CPU tests import every module),
from the sources in the checkout alone, into `kernels/build/`, which git
ignores.  Libraries are named by a hash of their sources and flags, so an
edited source is rebuilt and an unchanged one is reused.  All sources that
need building are compiled in parallel, one nvcc process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
SOURCES = ("fused_sdf", "fused_sdf_grad")
# No --use_fast_math: the PE angles reach 2^5 |x|, where __sinf/__cosf lose
# accuracy, and the tracer's thresholds depend on these values.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA "
                       "toolkit's nvcc (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(stem: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name == f"{stem}.cu" or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all at once; returns
    {stem: seconds} for the sources built in this call.  Raises with nvcc's
    output when a build fails.  The ptxas report (registers, shared memory,
    spills) of each build is kept beside its library as `<lib>.log`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = []
    for stem in SOURCES:
        out = _lib_path(stem)
        if os.path.exists(out):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{stem}.cu")]
        procs.append((stem, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    times, errors = {}, []
    for stem, out, tmp, t0, p in procs:
        log, _ = p.communicate()
        times[stem] = time.perf_counter() - t0
        with open(f"{out}.log", "w") as f:
            f.write(log)
        if p.returncode != 0:
            errors.append(f"nvcc failed for {stem}.cu (exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu`, built first if needed."""
    if stem not in _LIBS:
        path = _lib_path(stem)
        if not os.path.exists(path):
            build_all()
        _LIBS[stem] = ctypes.CDLL(path)
    return _LIBS[stem]


def ptxas_reports() -> List[str]:
    """The ptxas report of the current builds, one line a kernel: its
    (mangled) name, registers, shared memory and spills."""
    lines = []
    for stem in SOURCES:
        log = f"{_lib_path(stem)}.log"
        if not os.path.exists(log):
            continue
        name, parts = None, []
        with open(log) as f:
            for ln in f:
                if "Compiling entry function" in ln:
                    if name:
                        lines.append(f"{stem}: {name}: " + "; ".join(parts))
                    name, parts = ln.split("'")[1], []
                elif name and ("registers" in ln or "spill" in ln):
                    parts.append(ln.split(":", 1)[-1].strip())
        if name:
            lines.append(f"{stem}: {name}: " + "; ".join(parts))
    return lines


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (cudaGetLastError)."""
    if code != 0:
        lib.iron_error_string.restype = ctypes.c_char_p
        lib.iron_error_string.argtypes = [ctypes.c_int]
        msg = lib.iron_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
