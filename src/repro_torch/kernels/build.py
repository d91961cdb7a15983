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

``fused_select_agg``, ``grouped_select_agg`` and ``grouped_join_agg`` are
generated per query (``codegen``): ``build_generated`` compiles the text of
one query's kernel
(its row functions, then the template ``csrc/<family>.cu``) at its first
use into ``gen/<family>-<hash>.so`` under the same directory, named by a
hash of the flags, the text and every header of ``csrc/`` it includes,
and reuses a library that exists.  Each family has one fixed C entry
point (``GEN_ENTRY``), so the ctypes signatures stay static.  Several
threads may build distinct texts at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from ..errors import KernelBuildError, card_fault

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("kmeans_step", "segsum", "flash_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: C entry point and argument types of each library
ENTRY = {
    "kmeans_step": ("kms_launch", [_P, _P, _L, _I, _I, _P, _P, _P, _P, _I, _P]),
    "segsum": ("seg_launch", [_P, _P, _L, _I, _I, _P, _P, _P, _I, _P]),
    "flash_attention": ("fa_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
}

#: other C functions a library exports: name → (argument types, result type)
HELPERS = {
    "kmeans_step": {"kms_route": ([_I, _I], _I), "kms_tc_tile_points": ([_I], _I),
                    "kms_tc_grid": ([_L, _I, _I, _I], _I),
                    "kms_scratch_bytes": ([_L, _I, _I, _I], _L)},
    "segsum": {"seg_route": ([_I, _I], _I), "seg_scratch_bytes": ([_I, _I, _I], _L)},
}

#: the generated kernels' fixed C entry point per family (the templates
#: ``csrc/<family>.cu`` define them) and the other functions they export
GEN_ENTRY = {
    "fused_select_agg": ("fsa_gen_launch", [_P, _P, _L, _P, _P, _P, _P, _P]),
    "grouped_select_agg": ("gsa_gen_launch", [_P, _P, _L, _P, _P, _P, _P, _P]),
    "grouped_join_agg": ("gja_gen_launch", [_P, _P, _L, _L, _P, _P, _P, _P, _P]),
}
GEN_HELPERS = {
    "fused_select_agg": {"fsa_gen_scratch_bytes": ([_L], _L)},
    "grouped_select_agg": {"gsa_gen_scratch_bytes": ([_L], _L), "gsa_gen_route": ([], _I)},
    "grouped_join_agg": {"gja_gen_scratch_bytes": ([_L], _L), "gja_gen_route": ([], _I),
                         "gja_gen_build": ([_P, _P, _L, _P, _P], _I)},
}

#: generated libraries compiled and reused by this process, and the
#: seconds spent in nvcc for them
GEN_STATS: Dict[str, float] = {"built": 0, "reused": 0, "nvcc_s": 0.0, "nvcc_max_s": 0.0}
_GEN_STATS_LOCK = threading.Lock()

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
    raise KernelBuildError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def local_headers(source: Path) -> List[Path]:
    """The files of ``csrc/`` that ``source`` includes with ``#include
    "…"``, directly or through another such file, in the order met."""
    return _includes(source.read_bytes())


def _includes(text: bytes) -> List[Path]:
    found: List[Path] = []
    todo = [text]
    while todo:
        for name in _LOCAL_INCLUDE.findall(todo.pop()):
            header = CSRC / name.decode()
            if header.exists() and header not in found:
                found.append(header)
                todo.append(header.read_bytes())
    return found


def _digest(text: bytes, headers: List[Path]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for header in headers:
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(text)
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the flags, its source and the
    local headers it includes."""
    src = CSRC / f"{name}.cu"
    return build_dir() / f"{name}-{_digest(src.read_bytes(), local_headers(src))}.so"


def generated_path(family: str, text: str) -> Path:
    """Where the generated kernel ``text`` of ``family`` is built: named by
    a hash of the flags, the text and the headers of ``csrc/`` it includes
    (the family's template among them)."""
    data = text.encode()
    return build_dir() / "gen" / f"{family}-{_digest(data, _includes(data))}.so"


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
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building every missing one
    first, in parallel)."""
    if name not in _LOADED:
        with card_fault(KernelBuildError, f"kernel library {name}"):
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


def build_generated(family: str, text: str) -> ctypes.CDLL:
    """The loaded library of one generated kernel of ``family``: compiled
    by one nvcc for sm_90a if it is not built yet (the compiler's report in
    a ``.log`` beside it), reused otherwise.  Raises ``KernelBuildError``
    (with nvcc's output) if it cannot be built or loaded."""
    with card_fault(KernelBuildError, f"generated {family} kernel"):
        path = generated_path(family, text)
        if path.exists():
            with _GEN_STATS_LOCK:
                GEN_STATS["reused"] += 1
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            src = path.with_suffix(".cu")
            src.write_text(text)
            tmp = path.with_suffix(f".so.tmp{os.getpid()}")
            t0 = time.perf_counter()
            proc = subprocess.run([nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            took = time.perf_counter() - t0
            with _GEN_STATS_LOCK:
                GEN_STATS["nvcc_s"] += took
                GEN_STATS["nvcc_max_s"] = max(GEN_STATS["nvcc_max_s"], took)
            path.with_suffix(".log").write_text(proc.stdout)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise KernelBuildError(f"generated {family} kernel build failed (nvcc "
                                       f"exit {proc.returncode}, source {src}):\n{proc.stdout}")
            os.replace(tmp, path)
            with _GEN_STATS_LOCK:
                GEN_STATS["built"] += 1
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = GEN_ENTRY[family]
        getattr(lib, fn_name).argtypes = argtypes
        getattr(lib, fn_name).restype = ctypes.c_int
        for helper, (args, result) in GEN_HELPERS[family].items():
            getattr(lib, helper).argtypes = args
            getattr(lib, helper).restype = result
        return lib


def entry(name: str):
    """The C entry point of kernel ``name``."""
    return getattr(library(name), ENTRY[name][0])


def constant(name: str, symbol: str) -> int:
    """An ``int`` constant that library ``name`` exports as ``symbol``."""
    return ctypes.c_int.in_dll(library(name), symbol).value
