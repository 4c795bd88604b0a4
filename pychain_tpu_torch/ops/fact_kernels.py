"""The factorized denominator forward-backward on hand-written CUDA kernels.

The port's counterpart of ``pychain_tpu/ops/pallas_fact.py``.  Two
kernels, built from ``csrc/fact_fwd.cu`` and ``csrc/fact_bwd.cu`` for
Hopper (``sm_90a``) and loaded with ctypes (``csrc/build.py``):

* ``fact_fwd`` — the alpha sweep (replaces ``_fwd_kernel_factory``):
  emits the alpha' stream, W1 alpha' and the emission rows x_dst
  (x_src), the per-frame sums s_t and alpha' at each column's last frame;
* ``fact_bwd`` — the beta sweep (replaces ``_bwd_kernel_factory``):
  gamma (B, T, P) and the alpha*beta / sum-gamma invariant traces.

Between them the objective is reduced here (``_objf``, as
``_objf_pallas``).  The kernels take the graph as sparse rows over its
arcs (``KernelGraph``: sliced ELL, built once per graph from the
stratified parts) and pdf -> states lists for the posterior scatter.

A wrapper given CPU tensors computes its kernel's plain PyTorch version
(``ops/factorized.py``); given CUDA tensors it launches the kernel or
raises.  Each launch adds one to ``LAUNCHES[name]``.

Covered: both precisions of the Pallas kernels, float32 ("parity")
and the fast mode of bfloat16 tiles (``precision="fast"``: bfloat16
operands and streams, float32 accumulation and carries; a
second entry point of each source, counted as ``fact_fwd_bf16`` and
``fact_bwd_bf16``), in the "full" stream mode.  Its plain version is
``ops/factorized.forward_backward_prob_fast``.  The "lean"/"ckpt"
stream modes raise ``NotImplementedError`` on CUDA (ROADMAP.md queues
them); a graph whose state vectors exceed a block's shared memory raises
here and is the cluster kernels' (``ops/stream_kernels.py``, B3/B4).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import weakref

import numpy as np
import torch

from ..utils.device import host_to
from ..utils.diagnostics import get_verbose_level
from .factorized import (FactorizedArrays, WArrays,
                         forward_backward_prob_fact,
                         forward_backward_prob_fast, initial_alpha, is_fast)
from .fwdbwd import FwdBwdResult, _ok_flags

TILE = 128
# A block's shared memory on Hopper: 227 KB (232,448 bytes) of dynamic
# shared memory after cudaFuncSetAttribute.
MAX_SMEM = 232448
FACT_WARPS = 32                       # FACT_THREADS / 32 in fact_common.cuh
# "full" stream mode keeps three (T, S_pad, B) fwd->bwd streams (four
# outside identity mode); the other modes are not ported yet.  The JAX
# package's fixed budget (pallas_fact.py:794-795, STREAM_BUDGET and
# LEAN_BUDGET both 4 GiB, sized for a 16 GB TPU) is select_stream_mode's
# default; the wrappers pass the card's own (stream_budget).
STREAM_BUDGET = 4 * 1024 * 1024 * 1024

LAUNCHES = {"fact_fwd": 0, "fact_bwd": 0, "fact_fwd_bf16": 0,
            "fact_bwd_bf16": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supports(fa: FactorizedArrays) -> bool:
    """The kernels handle fully-factorized graphs (no residual arcs)."""
    return int(fa.res_src.shape[0]) == 0


def stream_dtype(fa) -> torch.dtype:
    """The type of the fwd->bwd streams: bfloat16 in the fast mode,
    else float32 (also for a shape stub without ``w1``)."""
    fast = getattr(fa, "w1", None) is not None and is_fast(fa)
    return torch.bfloat16 if fast else torch.float32


def _bwd_smem_bytes(s_pad: int, identity: bool, stages: int,
                    entry: int = 4) -> int:
    rows = 3 if identity else 4            # stream rows a frame
    return (((4 if identity else 5) * s_pad + 3 * FACT_WARPS + 3) * 4
            + stages * (rows * s_pad * entry + 8))


def ring_stages(fa: FactorizedArrays) -> int:
    """fact_bwd's ring depth for this graph: the frames whose stream rows
    it holds in shared memory, fetched ahead by TMA (csrc/fact_bwd.cu).
    Two stages where they fit a block's shared memory, one where only one
    fits, none past that; a row is 2 S_pad bytes in the fast mode."""
    identity = fa.xsrc_mode == "identity"
    entry = stream_dtype(fa).itemsize
    for stages in (2, 1):
        if _bwd_smem_bytes(fa.s_pad, identity, stages, entry) <= MAX_SMEM:
            return stages
    return 0


def smem_bytes(fa: FactorizedArrays, stages: int | None = None) -> dict:
    """Dynamic shared memory of each kernel for this graph, fact_bwd's
    with a ring of ``stages`` (default :func:`ring_stages`); must equal
    fact_fwd_smem_bytes / fact_bwd_smem_bytes in the sources.  In the
    fast mode outside identity mode fact_fwd holds a fifth vector."""
    identity = fa.xsrc_mode == "identity"
    entry = stream_dtype(fa).itemsize
    if stages is None:
        stages = ring_stages(fa)
    vectors = 5 if entry == 2 and not identity else 4
    return {"fact_fwd": (vectors * fa.s_pad + FACT_WARPS + 1) * 4,
            "fact_bwd": _bwd_smem_bytes(fa.s_pad, identity, stages, entry)}


def fits_on_chip(fa: FactorizedArrays) -> bool:
    """Whether both kernels' per-column working set fits one block's
    shared memory, fact_bwd's without a ring (replaces
    pallas_fact.fits_vmem)."""
    return max(smem_bytes(fa, stages=0).values()) <= MAX_SMEM


def select_stream_mode(T: int, s_pad: int, B: int, itemsize: int,
                       n_streams: int, budget: int = STREAM_BUDGET) -> str:
    """Cheapest stream mode whose fwd->bwd streams fit the device-memory
    budget (pallas_fact.select_stream_mode :798): all n_streams, else
    one ("lean"), else checkpoints."""
    row_bytes = T * s_pad * B * itemsize
    if n_streams * row_bytes <= budget:
        return "full"
    if row_bytes <= budget:
        return "lean"
    return "ckpt"


def stream_budget(device) -> int:
    """Bytes the fwd->bwd streams of one call may take on a CUDA card:
    40% of its memory (the rule of pallas_stream.stream_hbm_budget), the
    rest being for x, its exp, gamma, the gradient and the graph."""
    device = torch.device(device)
    _require(device.type == "cuda", f"stream_budget: {device} is no CUDA "
             "device (the CPU path keeps no streams)")
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * 0.40)


def require_full_mode(T: int, fa: FactorizedArrays, B: int, budget: int):
    """Raise unless the "full" stream mode's streams, at the stream
    type's size (pallas_fact.py:871), fit ``budget``: the other modes
    have no CUDA kernel yet."""
    n_streams = 3 if fa.xsrc_mode == "identity" else 4
    sd = stream_dtype(fa)
    mode = select_stream_mode(T, fa.s_pad, B, sd.itemsize, n_streams,
                              budget)
    if mode != "full":
        raise NotImplementedError(
            f"stream mode {mode!r}: {n_streams} {str(sd)[6:]} streams of "
            f"(T={T}, S_pad={fa.s_pad}, B={B}) exceed the card's budget of "
            f"{budget} bytes, and only \"full\" has a CUDA kernel yet "
            "(ROADMAP.md, deferred modules)")


# ----------------------------------------------------------------------
# The graph as the kernels read it
# ----------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class KernelGraph:
    """Sparse operators in the permuted state numbering, as sliced ELL
    (``_sell``).  W1/W2 by destination row (alpha sweep), W1^T/W2^T by
    source row (beta sweep); values and column ids from diag + the dense
    block's nonzeros + the tiles' nonzeros, each row in ascending column
    order: the cluster kernels' form.  ``resident`` holds the same four
    operators as B1/B2 read them (each row's entries permuted among its
    slots by :func:`bank_order`), built only for a graph that B1/B2 run;
    in the fast mode (bfloat16 tiles) without the diagonal, whose float32
    values are ``diag`` (W1's, W2's: a transpose has the same diagonal),
    the Pallas kernels' strata (the off-diagonal values are bfloat16
    values, held in float32: see sell_row_dot).  ``off`` holds, in the
    fast mode, the four operators' off-diagonal entries in ascending
    order: what the cluster pair reads in that mode (for every graph, as
    ``diag``).  The one-hot E matrices become gathers through f_dst/g_src
    and, for
    the posterior scatter, pdf -> states lists: E_f^T's over all S_pad
    states (padded states map to pdf 0 with zero mass), E_g^T's over the
    states with a W2 out-arc only (any other state's E_g^T mass is
    exactly 0: its W2^T row is empty; keeping them would put most
    states in pdf 0's list, one thread's serial loop)."""
    w1: tuple            # (slice_ptr, col, val)
    w2: tuple
    w1t: tuple
    w2t: tuple
    f_dst: torch.Tensor  # (S_pad,) int32
    g_src: torch.Tensor | None
    f_lists: tuple       # (ptr (P_pad+1,), states)
    g_lists: tuple | None
    n_pdf_lists: int
    nnz: int             # arcs in W1 + W2 (the products' work)
    max_pdf: int         # largest pdf the emission gathers read
    resident: tuple | None = None   # B1/B2's (w1, w2, w1t, w2t)
    diag: tuple | None = None       # fast mode: (W1's, W2's) (S_pad,) f32
    off: tuple | None = None        # fast mode: the four, off-diagonal

    def to(self, device) -> "KernelGraph":
        mv = lambda x: None if x is None else tuple(t.to(device) for t in x)
        return dataclasses.replace(
            self, w1=mv(self.w1), w2=mv(self.w2), w1t=mv(self.w1t),
            w2t=mv(self.w2t), diag=mv(self.diag),
            off=None if self.off is None else tuple(mv(op) for op in self.off),
            f_dst=self.f_dst.to(device),
            g_src=None if self.g_src is None else self.g_src.to(device),
            f_lists=mv(self.f_lists), g_lists=mv(self.g_lists),
            resident=None if self.resident is None else tuple(
                mv(op) for op in self.resident))


def _coo(w: WArrays, diag: bool = True):
    """(rows, cols, vals) of every nonzero of a stratified matrix, or
    with ``diag=False`` of its dense block and tiles alone."""
    rows, cols, vals = [], [], []
    if diag and w.diag is not None:
        d = w.diag.float().cpu().numpy()
        nz = np.nonzero(d)[0]
        rows.append(nz), cols.append(nz), vals.append(d[nz])
    if w.dense is not None:
        dense = w.dense.float().cpu().numpy()
        r, c = np.nonzero(dense)
        rows.append(r + w.dense_r0), cols.append(c + w.dense_c0)
        vals.append(dense[r, c])
    if w.tiles.shape[0]:
        tiles = w.tiles.float().cpu().numpy()
        n, i, j = np.nonzero(tiles)
        rows.append(w.rows.cpu().numpy()[n] * TILE + i)
        cols.append(w.cols.cpu().numpy()[n] * TILE + j)
        vals.append(tiles[n, i, j])
    if not rows:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.float32),)
    return (np.concatenate(rows).astype(np.int64),
            np.concatenate(cols).astype(np.int64),
            np.concatenate(vals).astype(np.float32))


def _csr(rows, cols, vals, n_rows):
    order = np.lexsort((cols, rows))
    ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=ptr[1:])
    return (torch.from_numpy(ptr.astype(np.int32)),
            torch.from_numpy(cols[order].astype(np.int32)),
            torch.from_numpy(vals[order].astype(np.float32)))


SLICE = 32   # rows per sliced-ELL slice: one warp's rows


def _sell(rows, cols, vals, n_rows):
    """Sliced ELL (see sell_row_dot in csrc/fact_common.cuh): returns
    (slice_ptr (n_rows/32 + 1,), col, val) with entry k of row
    32 i + l at 32 k + l, zero-padded to each slice's longest row."""
    ptr, col, val = (t.numpy() for t in _csr(rows, cols, vals, n_rows))
    lens = np.diff(ptr).astype(np.int64)
    slen = lens.reshape(-1, SLICE).max(axis=1)
    sptr = np.zeros(len(slen) + 1, np.int64)
    np.cumsum(slen, out=sptr[1:])
    row = np.repeat(np.arange(n_rows), lens)
    k = np.arange(len(col)) - ptr[row]
    at = (sptr[row // SLICE] + k) * SLICE + row % SLICE
    scol = np.zeros(sptr[-1] * SLICE, np.int32)
    sval = np.zeros(sptr[-1] * SLICE, np.float32)
    scol[at], sval[at] = col, val
    return (torch.from_numpy(sptr.astype(np.int32)),
            torch.from_numpy(scol), torch.from_numpy(sval))


def _pdf_lists(pdf_of_state, n_pdfs, states=None):
    """pdf -> ascending states lists over ``states`` (default all)."""
    s = (np.arange(len(pdf_of_state), dtype=np.int64) if states is None
         else np.asarray(states, np.int64))
    ptr, states, _ = _csr(pdf_of_state[s], s, np.zeros(len(s), np.float32),
                          n_pdfs)
    return ptr, states


# ----------------------------------------------------------------------
# B1/B2's slot order: bank-conflict-free gathers
# ----------------------------------------------------------------------
#
# A warp's lanes own the 32 rows of a slice and step through its slots
# together; at slot k lane l reads v[col[32 k + l]] from shared memory,
# whose 32 banks hold word c in bank c mod 32.  The SM serves a warp's
# load in as many wavefronts as the fullest bank has distinct words
# (lanes reading one word share it).  A row's sum may take its entries
# in any fixed order, so the order of each row's entries among its
# slots is chosen to keep each slot's lanes in distinct banks.

BANKS = 32


def gather_wavefronts(sell) -> np.ndarray:
    """Shared-memory wavefronts of each slot's gather v[col] for a warp
    (one per slot of every slice, in slot order): the most distinct
    column ids any bank receives.  Padding reads word 0."""
    sptr, col = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
                 for t in sell[:2])
    n = int(sptr[-1])
    col = col.astype(np.int64)
    c = np.sort(col[:n * SLICE].reshape(n, SLICE), axis=1)
    first = np.ones(c.shape, bool)
    first[:, 1:] = c[:, 1:] != c[:, :-1]
    counts = np.zeros((n, BANKS + 1), np.int64)
    np.add.at(counts, (np.repeat(np.arange(n), SLICE),
                       np.where(first, c % BANKS, BANKS).ravel()), 1)
    return counts[:, :BANKS].max(axis=1)


def _order_slice(cols, real):
    """The slot order of one slice.  cols, real: (K, 32), entry k of lane
    l and whether it is an arc (else padding).  Returns src (K, 32): the
    slot whose entry lane l takes at slot k, or -1 for padding.

    Greedy slot by slot: the lanes with the most entries left choose
    first, each the entry whose column some lane of this slot already
    reads, else one in a bank no lane reads yet (of the banks with the
    most entries left), else padding if the lane can still afford it
    (word 0), else the least bad entry."""
    K = cols.shape[0]
    uniq, loc = np.unique(np.where(real, cols, 0), return_inverse=True)
    loc = loc.reshape(K, SLICE)
    if uniq[0] != 0:                 # padding reads column 0
        uniq, loc = np.concatenate([[0], uniq]), loc + 1
    bank = [int(c) % BANKS for c in uniq]
    left_of = [[(int(loc[k, l]), k) for k in range(K) if real[k, l]]
               for l in range(SLICE)]
    src = [[-1] * K for _ in range(SLICE)]
    for k in range(K):
        slots_left = K - k
        word = {}                                # bank -> column read
        load = [0] * BANKS
        for items in left_of:
            for c, _ in items:
                load[bank[c]] += 1
        for l in sorted(range(SLICE), key=lambda l: -len(left_of[l])):
            items = left_of[l]
            pick, key = -1, None
            for i, (c, _) in enumerate(items):
                w = word.get(bank[c])
                kk = ((0, 0) if w == c else (1, -load[bank[c]]) if w is None
                      else (3, 0))
                if key is None or kk < key:
                    pick, key = i, kk
            if len(items) < slots_left:
                w = word.get(0)
                kk = (0, 1) if w == 0 else (2, 0) if w is None else (4, 0)
                if key is None or kk < key:
                    pick = -1
            if pick < 0:
                word.setdefault(0, 0)
            else:
                c, s = items.pop(pick)
                word.setdefault(bank[c], c)
                src[l][k] = s
    return np.array(src, np.int64).T


_orders: dict = {}


def bank_order(sell):
    """``sell`` (a ``_sell`` triple) with each row's entries permuted among
    its slots so that each slot's gathers hit as few words in one bank as
    a greedy pass finds (:func:`_order_slice`): the same slice pointers, each
    row the same (col, val) entries, padding (0, 0).  Memoized by
    content: the batches of one graph share its order."""
    sptr, col, val = (np.asarray(t) for t in sell)
    key = hashlib.sha1(b"".join(np.ascontiguousarray(a).tobytes()
                                for a in (sptr, col, val))).hexdigest()
    if key not in _orders:
        col2, val2 = col.copy(), val.copy()
        lane = np.arange(SLICE)[None, :]
        for i in range(len(sptr) - 1):
            lo, hi = int(sptr[i]) * SLICE, int(sptr[i + 1]) * SLICE
            if hi - lo <= SLICE:           # one slot: nothing to order
                continue
            c = col[lo:hi].reshape(-1, SLICE)
            v = val[lo:hi].reshape(-1, SLICE)
            s = _order_slice(c, v != 0)
            at = np.maximum(s, 0)
            col2[lo:hi] = np.where(s < 0, 0, c[at, lane]).ravel()
            val2[lo:hi] = np.where(s < 0, 0, v[at, lane]).ravel()
        if len(_orders) >= 8:
            _orders.pop(next(iter(_orders)))
        _orders[key] = (col2, val2)
    col2, val2 = _orders[key]
    return (torch.from_numpy(sptr.copy()), torch.from_numpy(col2.copy()),
            torch.from_numpy(val2.copy()))


def _operators(w1, w2, s_pad):
    """W1, W2 by destination row and W1^T, W2^T by source row, each
    sliced ELL, from (rows, cols, vals) triples."""
    (r1, c1, v1), (r2, c2, v2) = w1, w2
    return (_sell(r1, c1, v1, s_pad), _sell(r2, c2, v2, s_pad),
            _sell(c1, r1, v1, s_pad), _sell(c2, r2, v2, s_pad))


def kernel_graph(fa: FactorizedArrays) -> KernelGraph:
    """Host-built sparse form of ``fa`` (CPU tensors), with B1/B2's
    operators in bank order (:func:`bank_order`) when the graph fits them
    (:func:`fits_on_chip`).  In the fast mode the operators' off-diagonal
    entries alone (bfloat16 values), ascending (``off``, the cluster
    pair's) and, for B1/B2, in bank order, and the diagonals apart."""
    s_pad, p_pad = fa.s_pad, fa.p_pad
    identity = fa.xsrc_mode == "identity"
    r1, c1, v1 = _coo(fa.w1)
    r2, c2, v2 = _coo(fa.w2)
    f = fa.f_dst.cpu().numpy().astype(np.int64)
    g = fa.g_src.cpu().numpy().astype(np.int64)
    ops = _operators((r1, c1, v1), (r2, c2, v2), s_pad)
    resident = diag = off = None
    if is_fast(fa):
        off = _operators(_coo(fa.w1, diag=False), _coo(fa.w2, diag=False),
                         s_pad)
        diag = tuple(w.diag.float().cpu().contiguous()
                     for w in (fa.w1, fa.w2))
    if fits_on_chip(fa):
        resident = tuple(map(bank_order, off or ops))
    return KernelGraph(
        *ops, f_dst=torch.from_numpy(f.astype(np.int32)),
        g_src=None if identity else torch.from_numpy(g.astype(np.int32)),
        f_lists=_pdf_lists(f, p_pad),
        g_lists=None if identity else _pdf_lists(g, p_pad, np.unique(c2)),
        n_pdf_lists=p_pad, nnz=len(v1) + len(v2),
        max_pdf=int(max(f.max(), 0 if identity else g.max())),
        resident=resident, diag=diag, off=off)


_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def graph_for(fa: FactorizedArrays) -> KernelGraph:
    """``kernel_graph(fa)`` on fa's device, built once per graph."""
    kg = _graphs.get(fa)
    if kg is None:
        kg = kernel_graph(fa).to(fa.device)
        _graphs[fa] = kg
    return kg


def fast_operators(fa: FactorizedArrays, ascending: bool = False):
    """The fast mode's operators on fa's device: ((w1, w2, w1t, w2t), (W1's
    diagonal, W2's)), each operator its off-diagonal entries as sliced
    ELL.  B1/B2's (bank order) when the graph fits them, else (or with
    ``ascending``) the same entries in ascending order, the cluster
    pair's: the rows the plain fast version
    (``factorized.forward_backward_prob_fast``) sums."""
    kg = graph_for(fa)
    if kg.resident is not None and not ascending:
        return kg.resident, kg.diag
    return kg.off, kg.diag


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _lib(name):
    """The launch function ``name`` (fact_fwd, fact_bwd or their _bf16
    forms, two entry points of one source each)."""
    from ..csrc import build
    fast = name.endswith("_bf16")
    lib = build.load(name[:-5] if fast else name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        # the fast forms take W1's and W2's diagonals after the operators
        n_ptr_in = {"fact_fwd": 13, "fact_bwd": 21}[name[:8]] + 2 * fast
        if name.startswith("fact_fwd"):
            fn.argtypes = [_P] * n_ptr_in + [_F, _I, _I, _I, _I] \
                + [_P] * 6 + [_P]
        else:
            fn.argtypes = [_P] * n_ptr_in + [_I, _F] + [_I] * 6 \
                + [_P] * 3 + [_P]
        fn.restype = ctypes.c_int
    return fn


def _check(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           "(cudaGetLastError)")


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def fact_fwd(px, lengths, fa: FactorizedArrays, leaky_coefficient):
    """Launch the alpha sweep on CUDA tensors: ``fact_fwd``, or
    ``fact_fwd_bf16`` for a graph with bfloat16 tiles (the fast mode).
    px (B, T, P) float32, lengths (B,) int32 in [1, T].  Returns (ad_ys,
    w1ad_ys, xdst_ys, xsrc_ys or None: (B, T, S_pad) in
    :func:`stream_dtype`; s_ys (B, T), ad_last (B, S_pad), ad0, s0:
    float32)."""
    _check_cuda_inputs(px, lengths, fa)
    _require(fits_on_chip(fa),
             f"graph with S_pad={fa.s_pad} needs {smem_bytes(fa)} bytes "
             f"of shared memory per block, over the {MAX_SMEM} a Hopper "
             "block has; the cluster kernels serve it (engine=\"stream\", "
             "ops/stream_kernels.py)")
    kg = graph_for(fa)
    w1, w2 = kg.resident[:2]
    B, T, P = px.shape
    _require(kg.max_pdf < P, f"graph reads pdf {kg.max_pdf} but px has "
             f"only {P} columns")
    s_pad = fa.s_pad
    ad0, s0 = initial_alpha(fa, leaky_coefficient)
    sd = stream_dtype(fa)
    new = lambda *shape: torch.empty(shape, dtype=sd, device=px.device)
    ad_ys, w1ad_ys, xdst_ys = (new(B, T, s_pad) for _ in range(3))
    xsrc_ys = None if kg.g_src is None else new(B, T, s_pad)
    s_ys = torch.empty((B, T), dtype=torch.float32, device=px.device)
    ad_last = torch.empty((B, s_pad), dtype=torch.float32, device=px.device)
    name = "fact_fwd_bf16" if kg.diag else "fact_fwd"
    rc = _lib(name)(
        _ptr(px), _ptr(lengths), _ptr(kg.f_dst), _ptr(kg.g_src),
        *map(_ptr, w1), *map(_ptr, w2), *map(_ptr, kg.diag or ()),
        _ptr(ad0), _ptr(s0), _ptr(fa.leaky), float(leaky_coefficient), B,
        T, P, s_pad, _ptr(ad_ys), _ptr(w1ad_ys), _ptr(xdst_ys),
        _ptr(xsrc_ys), _ptr(s_ys), _ptr(ad_last), _stream())
    _check(rc, name)
    LAUNCHES[name] += 1
    return ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad_last, ad0, s0


def fact_bwd(lengths, fa: FactorizedArrays, leaky_coefficient, ad_ys,
             w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad0, s0, tot_prob, P,
             debug=True, stages=None):
    """Launch the beta sweep on the streams of :func:`fact_fwd`
    (``fact_bwd``, or ``fact_bwd_bf16`` in the fast mode), its ring
    ``stages`` deep (default :func:`ring_stages`).  Returns (gamma
    (B, T, P) float32, alpha_beta (B, T), gamma_sum (B, T))."""
    kg = graph_for(fa)
    _require(kg.resident is not None, f"graph with S_pad={fa.s_pad} does "
             "not fit B1/B2 (fits_on_chip)")
    w1t, w2t = kg.resident[2:]
    if stages is None:
        stages = ring_stages(fa)
    _require(stages in (0, 1, 2) and smem_bytes(fa, stages)["fact_bwd"]
             <= MAX_SMEM, f"fact_bwd: a ring of {stages} stages does not "
             f"fit a block at S_pad={fa.s_pad}")
    B, T, s_pad = ad_ys.shape
    sd = stream_dtype(fa)
    for t in (ad_ys, w1ad_ys, xdst_ys, xsrc_ys):
        _require(t is None or (t.is_cuda and t.dtype == sd
                               and t.is_contiguous()),
                 f"fact_bwd: streams must be contiguous {sd} on CUDA")
    for t in (s_ys, tot_prob):
        _require(t.is_cuda and t.dtype == torch.float32
                 and t.is_contiguous(),
                 "fact_bwd: s_ys and tot_prob must be contiguous float32 "
                 "on CUDA")
    _require((xsrc_ys is None) == (kg.g_src is None),
             "fact_bwd: x_src stream present iff the graph is not identity")
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=ad_ys.device)
    gamma, ab, gs = new(B, T, P), new(B, T), new(B, T)
    g_lists = kg.g_lists or (None, None)
    name = "fact_bwd_bf16" if kg.diag else "fact_bwd"
    rc = _lib(name)(
        _ptr(lengths), _ptr(ad_ys), _ptr(w1ad_ys), _ptr(xdst_ys),
        _ptr(xsrc_ys), _ptr(s_ys), _ptr(s0), _ptr(ad0), _ptr(fa.final),
        _ptr(tot_prob), _ptr(fa.leaky), *map(_ptr, w1t),
        *map(_ptr, w2t), *map(_ptr, kg.diag or ()), *map(_ptr, kg.f_lists),
        *map(_ptr, g_lists), kg.n_pdf_lists, float(leaky_coefficient), B, T,
        P, s_pad, int(bool(debug)), stages, _ptr(gamma), _ptr(ab), _ptr(gs),
        _stream())
    _check(rc, name)
    LAUNCHES[name] += 1
    return gamma, ab, gs


def _check_cuda_inputs(px, lengths, fa: FactorizedArrays):
    _require(px.is_cuda and px.dtype == torch.float32
             and px.is_contiguous() and px.dim() == 3,
             "px must be a contiguous (B, T, P) float32 CUDA tensor")
    _require(lengths.is_cuda and lengths.dtype == torch.int32
             and lengths.shape == (px.shape[0],),
             "lengths must be a (B,) int32 CUDA tensor")
    _require(fa.device == px.device,
             f"graph on {fa.device} but px on {px.device}")
    _require(fa.w1.operand_dtype in (torch.float32, torch.bfloat16),
             f"transition tiles of {fa.w1.operand_dtype}: the kernels take "
             "float32 or bfloat16 (precision='fast')")
    _require(supports(fa), "the kernels require a fully factorized graph "
             "(no residual arcs)")


# ----------------------------------------------------------------------
# Objective and the fused fwd+bwd
# ----------------------------------------------------------------------

def _objf(s_ys, ad_last, lengths, fa: FactorizedArrays, s0):
    """objf = sum_{u < T_b} log s_u + log(sum alpha'(T_b) * final), with
    s_0 = sum(initial) (pallas_fact._objf_pallas).  s_ys (B, T) holds
    s_1 .. s_T.  Returns (objf (B,), tot_prob (B,))."""
    B, T = s_ys.shape
    s_all = torch.cat([s0.expand(B, 1), s_ys], dim=1)     # (B, T+1)
    us = torch.arange(T + 1, device=s_ys.device)
    loglike = torch.where(us[None, :] < lengths[:, None].long(),
                          torch.log(torch.clamp(s_all, min=1e-30)),
                          0.0).sum(1)
    tot_prob = (ad_last * fa.final[None, :]).sum(dim=1)
    return loglike + torch.log(tot_prob), tot_prob


def _package_result(objf, gamma, alpha_beta, gamma_sum) -> FwdBwdResult:
    return FwdBwdResult(objf, gamma, _ok_flags(objf, alpha_beta, gamma_sum),
                        alpha_beta, gamma_sum)


def _frame0_traces(res: FwdBwdResult) -> FwdBwdResult:
    """The debug=False trace contract: frame 0 as computed, 1.0 elsewhere."""
    ab, gs = res.alpha_beta.clone(), res.gamma_sum.clone()
    ab[:, 1:] = 1.0
    gs[:, 1:] = 1.0
    return res._replace(alpha_beta=ab, gamma_sum=gs)


def fused_fwd_bwd(px, lengths, fa: FactorizedArrays, leaky_coefficient,
                  debug, fwd, bwd, plain=None) -> FwdBwdResult:
    """The glue of a kernel pair: CPU tensors take the plain version
    (``plain``, default the precision's: the fast one for bfloat16
    tiles); CUDA tensors run ``fwd``, the objective and ``bwd`` (the
    signatures of :func:`fact_fwd` / :func:`fact_bwd`), the streams' bytes
    held to the card's :func:`stream_budget`."""
    debug = debug or get_verbose_level() >= 1
    if not supports(fa):
        raise ValueError("the factorized kernels require a fully "
                         "factorized graph (no residual arcs)")
    if not px.is_cuda:
        plain = plain or (forward_backward_prob_fast if is_fast(fa)
                          else forward_backward_prob_fact)
        res = plain(px, lengths, fa, leaky_coefficient)
        return res if debug else _frame0_traces(res)

    B, T, P = px.shape
    require_full_mode(T, fa, B, stream_budget(px.device))
    # checked on a host copy: lengths given on the host cost no wait
    lens_host = torch.as_tensor(lengths).cpu().to(torch.int32)
    _require(bool(((lens_host >= 1) & (lens_host <= T)).all()),
             f"lengths must lie in [1, T={T}]")
    lens = host_to(lens_host.contiguous(), px.device)
    px = px.float().contiguous()
    with torch.no_grad():
        ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad_last, ad0, s0 = \
            fwd(px, lens, fa, leaky_coefficient)
        objf, tot_prob = _objf(s_ys, ad_last, lens, fa, s0)
        gamma, ab, gs = bwd(lens, fa, leaky_coefficient, ad_ys, w1ad_ys,
                            xdst_ys, xsrc_ys, s_ys, ad0, s0,
                            tot_prob.contiguous(), P, debug=debug)
    return _package_result(objf, gamma, ab, gs)


def forward_backward_prob_kernel(px, lengths, fa: FactorizedArrays,
                                 leaky_coefficient=1e-5,
                                 debug: bool = True,
                                 stages: int | None = None) -> FwdBwdResult:
    """Fused fwd+bwd on a fully-factorized graph (the resident tier,
    engine "pallas").

    px: (B, T, P) exp'd clamped nnet output (float32).  On CUDA this
    launches ``fact_fwd`` then ``fact_bwd`` (their fast forms for a graph
    with bfloat16 tiles); on the CPU it computes the plain version
    (``forward_backward_prob_fast`` for bfloat16 tiles).  debug: with True the alpha*beta and sum-gamma traces
    cover every frame; with False only frame 0 (the reference's default,
    chain-computation.cc:337-338), the other frames reading exactly
    1.0.  Verbose level >= 1 forces the full traces.  stages: fact_bwd's
    ring depth (default :func:`ring_stages`; the tests force each)."""
    bwd = fact_bwd if stages is None else functools.partial(fact_bwd,
                                                            stages=stages)
    return fused_fwd_bwd(px, lengths, fa, leaky_coefficient, debug,
                         fact_fwd, bwd)
