"""Build the CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C entry
point, built for Hopper (``sm_90a``) into ``build/repro_torch_kernels/``
at the root of the checkout (``REPRO_TORCH_BUILD_DIR`` overrides it).  A
library's file name carries a hash of its flags, its source and every
header of ``csrc/`` that the source includes, so an edited source or header
is rebuilt and an unchanged one is reused.  All missing libraries
are compiled at once, one ``nvcc`` each, in parallel.  They are loaded with
``ctypes``: pointers and the stream go over as ``c_void_p``, and every
entry point returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("fused_select_agg", "grouped_select_agg", "grouped_join_agg", "kmeans_step",
           "segsum", "flash_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: C entry point and argument types of each library
ENTRY = {
    "fused_select_agg": ("fsa_launch", [
        _P, _I, _I, _P, _P, _P, _I, _P, _L, _P, _I, _P, _P, _I, _P, _P, _P]),
    "grouped_select_agg": ("gsa_launch", [
        _P, _I, _I, _P, _P, _P, _I, _P, _L, _P, _P, _P, _I, _P, _I, _L, _P, _P,
        _P]),
    "grouped_join_agg": ("gja_launch", [
        _P, _I, _I, _P, _P, _P, _I, _P, _L, _P, _P, _P, _I, _P, _P, _P, _P, _I,
        _P, _I, _L, _P, _P, _P]),
    "kmeans_step": ("kms_launch", [_P, _P, _L, _I, _I, _P, _P, _P, _P, _I, _P]),
    "segsum": ("seg_launch", [_P, _P, _L, _I, _I, _P, _P]),
    "flash_attention": ("fa_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
}

#: other C functions a library exports: name → (argument types, result type)
HELPERS = {
    "kmeans_step": {"kms_route": ([_I, _I], _I), "kms_tc_tile_points": ([_I], _I),
                    "kms_tc_grid": ([_L, _I, _I, _I], _I), "kms_scratch_bytes": ([_I, _I, _I], _L)},
}

#: where the CUDA toolkit installs nvcc by default
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_LOADED: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path(DEFAULT_NVCC).exists():
        return DEFAULT_NVCC
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def local_headers(source: Path) -> List[Path]:
    """The headers of ``csrc/`` that ``source`` includes with ``#include
    "…"``, directly or through another such header, in the order met."""
    found: List[Path] = []
    todo = [source]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop().read_bytes()):
            header = CSRC / name.decode()
            if header.exists() and header not in found:
                found.append(header)
                todo.append(header)
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the flags, its source and the
    local headers it includes."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    src = CSRC / f"{name}.cu"
    for header in local_headers(src):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the libraries that are not built yet, all in parallel; the
    compiler's report (registers, shared memory, spills) goes to a ``.log``
    beside each library.  Raises with nvcc's output if one fails."""
    names = tuple(names or KERNELS)
    out = {n: library_path(n) for n in names}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".so.tmp{os.getpid()}")
        cmd = [compiler, *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        todo[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building every missing one
    first, in parallel)."""
    if name not in _LOADED:
        paths = build()
        for n, p in paths.items():
            if n in _LOADED:
                continue
            lib = ctypes.CDLL(str(p))
            fn_name, argtypes = ENTRY[n]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            for helper, (args, result) in HELPERS.get(n, {}).items():
                getattr(lib, helper).argtypes = args
                getattr(lib, helper).restype = result
            _LOADED[n] = lib
    return _LOADED[name]


def entry(name: str):
    """The C entry point of kernel ``name``."""
    return getattr(library(name), ENTRY[name][0])


def constant(name: str, symbol: str) -> int:
    """An ``int`` constant that library ``name`` exports as ``symbol``."""
    return ctypes.c_int.in_dll(library(name), symbol).value
