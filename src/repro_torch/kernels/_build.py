"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` file is compiled for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, into ``_build/``
beside this file (listed in ``.gitignore``). The library's name carries a
hash of its source and of every ``csrc`` header it includes, so an edited
source or header is rebuilt and a stale build is never loaded.
:func:`build_all` starts one ``nvcc`` per source at once. Nothing is built
or imported when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
#: every kernel source in ``csrc`` (one library each)
KERNELS = ("count_batch", "track_batch", "track_level", "flash_attention",
           "wkv_chunk")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_LOADED: Dict[str, ctypes.CDLL] = {}
#: ``nvcc``'s own report (registers, shared memory, spills) per source.
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes with
    quotes, transitively, in a fixed order."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc
                 for inc in _INCLUDE.findall(path.read_text())]
    return seen


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives (hash of its sources)."""
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` that has no up-to-date build, one
    ``nvcc`` process per source, all started together."""
    outs = {name: library_path(name) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {name}.cu "
                              f"({proc.returncode}):\n{log}")
                continue
            BUILD_LOG[name] = log
            os.replace(tmp, todo[name])   # atomic: a loader sees all or nothing
        if failed:
            raise RuntimeError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def call(name: str, argtypes: Sequence, *args) -> None:
    """Call ``repro_<name>`` of ``csrc/<name>.cu``, whose ctypes argument
    types are ``argtypes`` (the stream last), and raise if it returns a
    CUDA error (a refused launch never runs, and a later synchronize does
    not report it)."""
    lib = load(name)
    fn = getattr(lib, f"repro_{name}")
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{lib.repro_cuda_error_string(err).decode()} ({err})")
