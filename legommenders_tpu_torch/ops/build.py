"""Builds a CUDA source of the port (csrc/<name>.cu) and loads it with ctypes.

The source is compiled by `nvcc` into a shared library with a plain C
interface, in `_build/` beside this package (listed in .gitignore):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

A library is rebuilt when its source, or a header of csrc/ that it
includes (`#include "x.cuh"`, followed through headers), is newer. The
tensor-map encoder the attention kernels need comes from the driver
through the runtime (`cudaGetDriverEntryPointByVersion`), so nothing links
libcuda. `library(name)` builds on
first use and loads; `build(name)` only builds and returns nvcc's output;
`build_all(names)` runs one nvcc for each source, all at once.
Nothing is compiled or loaded at import time. `launch_range(name)` marks
a wrapper's launch for a profiler's trace.
"""
import contextlib
import ctypes
import os
import re
import shutil
import subprocess
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list:
    """csrc/<name>.cu and every csrc/ header it includes, directly or
    through another header."""
    todo, seen = [source(name)], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path) as f:
            for inc in _INCLUDE.findall(f.read()):
                dep = os.path.join(os.path.dirname(path), inc)
                if os.path.isfile(dep):
                    todo.append(dep)
    return seen


def _stale(name: str) -> bool:
    lib = lib_path(name)
    return (not os.path.isfile(lib)
            or os.path.getmtime(lib) < max(os.path.getmtime(p)
                                           for p in sources(name)))


def _start(name: str):
    """Starts nvcc on csrc/<name>.cu if its library is missing or stale:
    (process, temporary output) or None."""
    if not _stale(name):
        return None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
    proc = subprocess.Popen([nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp = started
    out, _ = proc.communicate()
    if proc.returncode:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    os.replace(tmp, lib_path(name))
    return out


def build_all(names) -> Dict[str, str]:
    """Compiles every stale csrc/<name>.cu, all nvcc processes started
    together. Returns each compiler's output ('' when nothing was
    compiled); raises with it if nvcc fails."""
    started = {name: _start(name) for name in names}
    return {name: _finish(name, s) for name, s in started.items()}


def build(name: str) -> str:
    """Compile csrc/<name>.cu if its library is missing or stale. Returns
    the compiler's output ('' when nothing was compiled); raises with it if
    nvcc fails."""
    return build_all([name])[name]


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(lib_path(name))
    return _loaded[name]


def launch_range(name: str):
    """A profiler range named `name` around a wrapper's kernel launch while
    a profiler runs (nothing otherwise), so that a trace ties the
    runtime's launch call to the wrapper that made it.

    It is the program's one profiler range: readers of a trace find the
    wrappers' kernels by these names, and leave the ranges' device-side
    annotations out of the device's work. Every other interval the
    program marks is a span of `utils/spans.py`, kept in memory on the
    trace's clock, which adds nothing to the trace."""
    import torch

    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()
