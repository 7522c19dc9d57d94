"""Build and load the CUDA C++ kernels under ``csrc/``.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers).  A source
is split into build units (``-DSTAGED_PIPE_UNIT=u`` for
``staged_pipe.cu``: the entry point and one unit per layout, plane type and
tile; ``-DFUSED_MM1_UNIT=u`` for ``fused_mm1.cu``: the entry points and one
unit per tile; ``-DFUSED_SPLIT_UNIT=u`` for ``fused_split.cu``: the entry
points and one unit per digit layout and tile; ``wkv.cu`` and
``rowinv.cu`` are one unit each);
each unit compiles to one object and the objects are linked into the
library.
Without the macro the same source compiles whole (``kernels.compare``
builds another checkout's source so).  Libraries go to ``build/kernels/`` at the root of
the checkout, named by a digest of the source and flags, so an edited source
rebuilds and an unchanged one is reused.  Builds happen at first use, never
at import; :func:`build` starts one ``nvcc`` per unit of every missing
library, all at once.  A failed build raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# name -> source file under csrc/
SOURCES = {"fused_mm1": "fused_mm1.cu", "fused_split": "fused_split.cu",
           "staged_pipe": "staged_pipe.cu", "wkv": "wkv.cu",
           "rowinv": "rowinv.cu"}
# name -> (unit macro, number of units), one nvcc per unit
UNITS = {"fused_mm1": ("FUSED_MM1_UNIT", 3),
         "fused_split": ("FUSED_SPLIT_UNIT", 7),
         "staged_pipe": ("STAGED_PIPE_UNIT", 11),
         "wkv": ("WKV_UNIT", 1), "rowinv": ("ROWINV_UNIT", 1)}

# --fmad=false keeps every fp32 add and multiply separately rounded, so the
# epilogue reproduces the reference's operation order bit for bit (the
# sources also spell the order out with __fadd_rn / __fmul_rn).  These build
# a whole source into a library in one call; a unit drops -shared for -c.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas=-v")
UNIT_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)

# What nvcc printed for each library built by this process (ptxas register
# and spill counts); empty for a library that was already built.
BUILD_LOG: Dict[str, str] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    flags = " ".join(NVCC_FLAGS) + repr(UNITS[name])
    digest = hashlib.sha1(src.read_bytes() + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile_jobs(name: str, tmp: Path):
    """(object, command) pairs that compile library ``name``, one per build
    unit."""
    src = str(CSRC / SOURCES[name])
    macro, n_units = UNITS[name]
    return [(tmp.with_name(f"{tmp.name}.{u}.o"),
             [nvcc(), *UNIT_FLAGS, f"-D{macro}={u}", "-o",
              str(tmp.with_name(f"{tmp.name}.{u}.o")), src])
            for u in range(n_units)]


def _run_all(cmds):
    """Run the commands together; their (exit code, output) in order."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    results = []
    for proc in procs:
        log, _ = proc.communicate()
        results.append((proc.returncode, log))
    return results


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named library not built yet — every unit of every
    library in its own nvcc, all started together, then one link per
    library; returns name -> library path."""
    out: Dict[str, Path] = {}
    todo = []
    for name in names:
        lib = library_path(name)
        out[name] = lib
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        todo.append((name, lib, tmp, _compile_jobs(name, tmp)))
    results = iter(_run_all([cmd for *_, jobs in todo for _, cmd in jobs]))
    failed = []
    for name, lib, tmp, jobs in todo:
        logs, ok = [], True
        for _ in jobs:
            code, log = next(results)
            logs.append(log)
            ok = ok and code == 0
        objs = [obj for obj, _ in jobs]
        if ok:
            code, log = _run_all([[nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   *map(str, objs)]])[0]
            logs.append(log)
            ok = code == 0
        for obj in objs:
            obj.unlink(missing_ok=True)
        BUILD_LOG[name] = "".join(logs)
        if not ok:
            failed.append(f"nvcc failed for {name}:\n{BUILD_LOG[name]}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib


@functools.cache
def entry(name: str, fn: str, n_ptr: int, n_int: int):
    """C entry point ``fn`` of library ``name`` taking ``n_ptr`` pointers,
    ``n_int`` ints and the stream, and returning an int (a CUDA error
    code, 0 on success)."""
    func = getattr(load(name), fn)
    func.restype = ctypes.c_int
    func.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                     + [ctypes.c_void_p])
    return func
