"""ctypes bindings for the port's native host runtime
(``pychain_native.cc``: FST I/O at ark offsets, FST->tensor compilation,
leaky priors, the CPU forward-backward oracles and Kaldi feature
decoding).

The port's counterpart of ``pychain_tpu/csrc/native.py``.  The library
is built the way ``build.py`` builds the CUDA sources: at first use,
with ``g++ -O2 -shared -fPIC``, into ``build/libpychain_native-<hash>.so``
where the hash covers the source and the flags, so an edited source
builds anew.  Nothing is built when this module is imported; a build
that fails raises with g++'s output.  Every entry point has a Python
twin (``graphs/fst.py``, ``graphs/compiler.py``,
``data/kaldi_features.py``, the plain engines of ``ops/``), and
tests/test_torch_native.py holds the two to the same results.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from ctypes import POINTER, c_char_p, c_float, c_int, c_int32, c_int64, \
    c_long, c_void_p
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent
SOURCE = CSRC / "pychain_native.cc"
BUILD_DIR = CSRC / "build"
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lib = None

_F32 = POINTER(c_float)
_I32 = POINTER(c_int32)
_I64 = POINTER(c_int64)
_SIGNATURES = {
    "pc_fst_read": (c_void_p, [c_char_p, c_long]),
    "pc_fst_free": (None, [c_void_p]),
    "pc_fst_num_states": (c_int, [c_void_p]),
    "pc_fst_num_arcs": (c_int, [c_void_p]),
    "pc_fst_start": (c_int, [c_void_p]),
    "pc_fst_fields": (None, [c_void_p, _F32, _I64, _I32, _I32, _F32,
                             _I32]),
    "pc_fst_write": (c_int, [c_char_p, c_int32, c_int32, c_int64, _F32,
                             _I64, _I32, _I32, _F32, _I32]),
    "pc_fst_compile": (c_int, [c_void_p, c_int, _I32, _F32, _I32, _I32,
                               _F32, _I32, _F32]),
    "pc_fst_leaky": (c_int, [c_void_p, c_int, _F32]),
    "pc_fwdbwd_prob": (c_int, [c_int, c_int, c_int, c_int, c_int64, _I32,
                               _F32, _I32, _F32, _F32, _F32, _F32, c_float,
                               _F32, _I32, _F32, _F32]),
    "pc_fwdbwd_log": (c_int, [c_int, c_int, c_int, c_int, c_int64, _I32,
                              _F32, _I32, _F32, _F32, _F32, _F32, _I32,
                              _F32, _F32]),
    "pc_feats_probe": (c_int, [c_char_p, c_long, _I32, _I32]),
    "pc_feats_read": (c_int, [c_char_p, c_long, _F32]),
    "pc_feats_scan": (c_long, [c_char_p, c_long, _I64, c_char_p, c_long]),
}


def compiler() -> str | None:
    return shutil.which("g++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpychain_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises RuntimeError with g++'s output on a failure.  The library is
    written under a temporary name and renamed, so processes that build
    at once never load a half-written file."""
    path = library_path()
    if path.exists():
        return path
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native host "
                           "library cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libpychain_native.{os.getpid()}.so"
    out = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed (g++ rc="
                           f"{out.returncode}):\n{out.stdout}{out.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built first if needed, with every entry point's
    argument and result types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def available() -> bool:
    """True when the library is built or can be (its source is there and
    so is g++): the readers of ``data/kaldi_features.py`` then take the
    native path, else their numpy twins."""
    if _lib is not None:
        return True
    if not SOURCE.exists():
        return False
    return library_path().exists() or compiler() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(POINTER(ctype))


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype)


def read_fst(path: str, offset: int = -1):
    """Read an OpenFST binary (or an ark entry at ``offset``) into the
    port's FST."""
    from ..graphs.fst import FST

    lib = load()
    h = lib.pc_fst_read(path.encode(), offset)
    if not h:
        raise ValueError(f"failed to read FST from {path!r} @ {offset}")
    try:
        S = lib.pc_fst_num_states(h)
        K = lib.pc_fst_num_arcs(h)
        start = lib.pc_fst_start(h)
        final = np.empty(S, np.float32)
        offsets = np.empty(S + 1, np.int64)
        il = np.empty(K, np.int32)
        ol = np.empty(K, np.int32)
        w = np.empty(K, np.float32)
        ns = np.empty(K, np.int32)
        if S:
            lib.pc_fst_fields(h, _ptr(final, c_float), _ptr(offsets, c_int64),
                              _ptr(il, c_int32), _ptr(ol, c_int32),
                              _ptr(w, c_float), _ptr(ns, c_int32))
        return FST(start=start, final=final, arc_offsets=offsets,
                   ilabels=il, olabels=ol, weights=w, nextstates=ns)
    finally:
        lib.pc_fst_free(h)


def write_fst(fst, path: str) -> None:
    lib = load()
    final = _c(fst.final, np.float32)
    offsets = _c(fst.arc_offsets, np.int64)
    il, ol = _c(fst.ilabels, np.int32), _c(fst.olabels, np.int32)
    w, ns = _c(fst.weights, np.float32), _c(fst.nextstates, np.int32)
    rc = lib.pc_fst_write(path.encode(), fst.start, fst.num_states,
                          fst.num_arcs, _ptr(final, c_float),
                          _ptr(offsets, c_int64), _ptr(il, c_int32),
                          _ptr(ol, c_int32), _ptr(w, c_float),
                          _ptr(ns, c_int32))
    if rc != 0:
        raise IOError(f"failed to write FST to {path!r}")


def _fst_handle(fst):
    """A native handle of a Python FST, through a temporary file."""
    lib = load()
    fd, tmp = tempfile.mkstemp(suffix=".fst")
    os.close(fd)
    try:
        fst.write(tmp)
        h = lib.pc_fst_read(tmp.encode(), -1)
        if not h:
            raise ValueError("native reload failed")
        return h
    finally:
        os.unlink(tmp)


def compile_fst(fst, log_domain: bool = False):
    """Native FST->tensor compilation: the CompiledGraph that
    ``graphs.compiler.compile_fst`` builds."""
    from ..graphs.compiler import CompiledGraph

    lib = load()
    h = _fst_handle(fst)
    try:
        S = lib.pc_fst_num_states(h)
        K = lib.pc_fst_num_arcs(h)
        fwd_t = np.empty((K, 3), np.int32)
        fwd_p = np.empty(K, np.float32)
        fwd_i = np.empty((S, 2), np.int32)
        bwd_t = np.empty((K, 3), np.int32)
        bwd_p = np.empty(K, np.float32)
        bwd_i = np.empty((S, 2), np.int32)
        final = np.empty(S, np.float32)
        rc = lib.pc_fst_compile(
            h, int(log_domain), _ptr(fwd_t, c_int32), _ptr(fwd_p, c_float),
            _ptr(fwd_i, c_int32), _ptr(bwd_t, c_int32), _ptr(bwd_p, c_float),
            _ptr(bwd_i, c_int32), _ptr(final, c_float))
        if rc != 0:
            raise ValueError("FST has epsilon (ilabel=0) arcs")
        return CompiledGraph(
            num_states=S, start_state=lib.pc_fst_start(h),
            log_domain=log_domain,
            forward_transitions=fwd_t, forward_transition_probs=fwd_p,
            forward_transition_indices=fwd_i,
            backward_transitions=bwd_t, backward_transition_probs=bwd_p,
            backward_transition_indices=bwd_i, final_probs=final)
    finally:
        lib.pc_fst_free(h)


def leaky_probs(fst, num_iters: int = 100) -> np.ndarray:
    lib = load()
    h = _fst_handle(fst)
    try:
        out = np.empty(lib.pc_fst_num_states(h), np.float32)
        if lib.pc_fst_leaky(h, num_iters, _ptr(out, c_float)) != 0:
            raise ValueError("state probability mass out of range")
        return out
    finally:
        lib.pc_fst_free(h)


def fwdbwd_prob(px, lengths, fwd_trans, fwd_probs, bwd_trans, bwd_probs,
                init, final, leaky, leaky_coeff=1e-5):
    """Native CPU forward-backward, prob domain, one graph shared by the
    batch.  px (B, T, P) float32 = exp(clamped nnet output); returns
    (objf (B,), gamma (B, T, P), ok)."""
    lib = load()
    px = _c(px, np.float32)
    B, T, P = px.shape
    S, K = int(np.shape(init)[0]), int(np.shape(fwd_probs)[0])
    arrs = [_c(fwd_trans, np.int32), _c(fwd_probs, np.float32),
            _c(bwd_trans, np.int32), _c(bwd_probs, np.float32),
            _c(init, np.float32), _c(final, np.float32),
            _c(leaky, np.float32)]
    lens = _c(lengths, np.int32)
    objf = np.zeros(B, np.float32)
    gamma = np.zeros((B, T, P), np.float32)
    types = (c_int32, c_float, c_int32, c_float, c_float, c_float, c_float)
    rc = lib.pc_fwdbwd_prob(
        B, T, P, S, K, *(_ptr(a, t) for a, t in zip(arrs, types)),
        leaky_coeff, _ptr(px, c_float), _ptr(lens, c_int32),
        _ptr(objf, c_float), _ptr(gamma, c_float))
    return objf, gamma, rc == 0


def fwdbwd_log(x, lengths, fwd_trans, fwd_probs, bwd_trans, bwd_probs,
               init, final):
    """Native CPU forward-backward, log domain, one graph per sequence
    (B leading on the graph arrays, padded as ChainGraphBatch pads a
    list).  Returns (objf (B,), gamma (B, T, P), ok)."""
    lib = load()
    x = _c(x, np.float32)
    B, T, P = x.shape
    S, K = int(np.shape(init)[1]), int(np.shape(fwd_probs)[1])
    arrs = [_c(fwd_trans, np.int32), _c(fwd_probs, np.float32),
            _c(bwd_trans, np.int32), _c(bwd_probs, np.float32),
            _c(init, np.float32), _c(final, np.float32)]
    lens = _c(lengths, np.int32)
    objf = np.zeros(B, np.float32)
    gamma = np.zeros((B, T, P), np.float32)
    types = (c_int32, c_float, c_int32, c_float, c_float, c_float)
    rc = lib.pc_fwdbwd_log(
        B, T, P, S, K, *(_ptr(a, t) for a, t in zip(arrs, types)),
        _ptr(x, c_float), _ptr(lens, c_int32), _ptr(objf, c_float),
        _ptr(gamma, c_float))
    return objf, gamma, rc == 0


def read_feats(path: str, offset: int) -> np.ndarray:
    """Decode one Kaldi feature matrix (FM/DM/CM/CM2/CM3) at an scp
    offset (pointing at the \\0B marker): the native path of
    ``data.kaldi_features.load_scp_entry``."""
    lib = load()
    rows, cols = c_int32(), c_int32()
    if lib.pc_feats_probe(path.encode(), offset, ctypes.byref(rows),
                          ctypes.byref(cols)) != 0:
        raise ValueError(f"bad feature matrix at {path!r}:{offset}")
    out = np.empty((rows.value, cols.value), np.float32)
    if lib.pc_feats_read(path.encode(), offset, _ptr(out, c_float)) != 0:
        raise ValueError(f"failed to decode matrix at {path!r}:{offset}")
    return out


def scan_feats_ark(path: str, _initial_keys_cap: int = 1 << 22):
    """(key, offset) pairs of a feature ark, payloads not decoded (the
    native path of ``data.kaldi_features.scan_feats_ark``).  The key
    buffer grows until every key fits: the C++ side returns -2 rather
    than drop a key, which would misalign keys and offsets."""
    lib = load()
    n = lib.pc_feats_scan(path.encode(), 0, None, None, 0)
    if n < 0:
        raise ValueError(f"malformed feature ark {path!r}")
    if n == 0:
        return []
    offsets = np.empty(n, np.int64)
    keys_cap = _initial_keys_cap
    while True:
        keys = ctypes.create_string_buffer(keys_cap)
        n2 = lib.pc_feats_scan(path.encode(), n, _ptr(offsets, c_int64),
                               keys, keys_cap)
        if n2 != -2:
            break
        keys_cap *= 2
    if n2 != n:
        raise ValueError(f"feature ark changed while scanning {path!r}")
    out, pos = [], 0
    for i in range(n):
        end = keys.raw.index(b"\x00", pos)
        out.append((keys.raw[pos:end].decode(), int(offsets[i])))
        pos = end + 1
    return out
