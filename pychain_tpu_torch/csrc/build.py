"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``<name>.cu`` in this directory is compiled on its own, for Hopper
(``sm_90a``), into ``build/lib<name>-<hash>.so`` with a plain C interface
(no PyTorch headers, so a build takes seconds).  The hash covers the
source, every shared header (``*.cuh``) of this directory and the flags,
so an edited source or header builds anew.  Nothing is built
when this module is imported: ``load`` builds at first use, and
``build`` compiles several sources at once, one nvcc each, in parallel.
No ``--use_fast_math``: the recurrences need IEEE float32 and no
flush-to-zero of small values.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC / "build"
SOURCES = ("fact_fwd", "fact_bwd", "stream_fwd", "stream_bwd",
           "semiring_fwd", "semiring_bwd", "viterbi", "xl_roofline")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, all at once.
    Returns {name: seconds}; raises with nvcc's output on a failure.
    nvcc's resource report (-Xptxas -v) lands in build/<name>.log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp)
    seconds, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc rc={proc.returncode}):\n{out}")
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    log = BUILD_DIR / f"{name}.log"
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library of ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
