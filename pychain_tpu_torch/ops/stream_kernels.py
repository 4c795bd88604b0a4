"""The denominator forward-backward for graphs past one SM: cluster kernels.

The port's counterpart of ``pychain_tpu/ops/pallas_stream.py`` (B3/B4).
On the TPU those kernels serve graphs whose weights do not fit VMEM: W1's
128x128 tiles stream from HBM in double-buffered chunks over a third grid
axis (``_WKStream``, ``CHUNK_TILES``, ``auto_chunk_tiles``).  None of
that plan is ported: the port never holds W1 on chip (its kernels read
W1/W2 as sliced-ELL rows through L2 every frame, ``fact_kernels``).
What outgrows one SM here is the column's working set, which the
resident kernels B1/B2 keep in one block's shared memory (4-5 S_pad
floats, :func:`fact_kernels.smem_bytes`).  So the same "full"-mode sweep
runs on one thread-block cluster per batch column: CTA r of C owns the
32-row state slices r, r + C, ... (R rows), keeps whole only the two
vectors its products gather (copying its peers' rows of them each frame
through distributed shared memory) and the rest on its own rows:

* ``stream_fwd`` (``csrc/stream_fwd.cu``, replaces
  ``pallas_stream._fwd_kernel_factory``): the alpha sweep, the same
  streams and sums as ``fact_fwd``;
* ``stream_bwd`` (``csrc/stream_bwd.cu``, replaces
  ``pallas_stream._bwd_kernel_factory``): the beta sweep, gamma and the
  traces, as ``fact_bwd``.

The kernels read the graph of ``fact_kernels.graph_for`` (the same
device arrays as B1/B2) except the pdf -> states lists of the posterior,
whose state ids are packed as (owner rank, local row) for the cluster
size C (:func:`cluster_graph`): CTA r sums the pdf columns
[r ceil(P / C), (r + 1) ceil(P / C)) from the CTAs that own the states.

A wrapper given CPU tensors computes the plain version
(``ops/factorized.py``); given CUDA tensors it launches its kernel or
raises.  Each launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import torch

from . import fact_kernels as fk
from .factorized import FactorizedArrays
from .fwdbwd import FwdBwdResult

CLUSTERS = (1, 2, 4, 8)      # portable cluster sizes, smallest first
LOCAL_BITS = 16              # CLUSTER_LOCAL_BITS in fact_common.cuh

LAUNCHES = {"stream_fwd": 0, "stream_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rows_per_cta(s_pad: int, cluster: int) -> int:
    """R: the rows of the CTA that owns the most 32-row slices when slice
    k belongs to CTA k mod C."""
    return -(-(s_pad // fk.SLICE) // cluster) * fk.SLICE


def smem_bytes(fa: FactorizedArrays, cluster: int) -> dict:
    """Dynamic shared memory of each CTA for cluster size ``cluster``
    (must equal stream_fwd_smem_bytes / stream_bwd_smem_bytes in the
    sources): two whole vectors and two (fwd) or three (bwd; two in
    identity mode) of the CTA's rows, plus the reductions' scratch."""
    s_pad, rows = fa.s_pad, rows_per_cta(fa.s_pad, cluster)
    identity = fa.xsrc_mode == "identity"
    return {"stream_fwd": (2 * s_pad + 2 * rows + fk.FACT_WARPS + 2) * 4,
            "stream_bwd": (2 * s_pad + (2 if identity else 3) * rows
                           + 3 * fk.FACT_WARPS + 6) * 4}


def cluster_size(fa: FactorizedArrays):
    """The smallest C in CLUSTERS whose per-CTA share of both kernels'
    working set fits a Hopper block's shared memory (the port's
    counterpart of pallas_stream.fits_stream's VMEM estimate), or None."""
    for c in CLUSTERS:
        if max(smem_bytes(fa, c).values()) <= fk.MAX_SMEM:
            return c
    return None


def fits_stream(fa: FactorizedArrays) -> bool:
    """Can the cluster kernels run this graph?  A fully factorized graph
    whose state vectors fit the shared memory of a cluster of at most
    max(CLUSTERS) CTAs."""
    return fk.supports(fa) and cluster_size(fa) is not None


# ----------------------------------------------------------------------
# The graph as the cluster kernels read it
# ----------------------------------------------------------------------

def pack_ids(ids, cluster: int):
    """State ids as (owner rank << LOCAL_BITS) | local row in the owner,
    slice k of 32 rows belonging to rank k mod C (cluster_row and
    cluster_load in fact_common.cuh)."""
    ids = ids.to(torch.int64)
    slice_, lane = ids // fk.SLICE, ids % fk.SLICE
    local = slice_ // cluster * fk.SLICE + lane
    return ((slice_ % cluster) << LOCAL_BITS | local).to(torch.int32)


def cluster_graph(kg: fk.KernelGraph, cluster: int) -> fk.KernelGraph:
    """The kernel graph ``kg`` with the pdf -> states lists' state ids
    packed for a cluster of ``cluster`` CTAs; every other array is
    ``kg``'s own (on its device)."""
    lists = lambda m: None if m is None else (m[0], pack_ids(m[1], cluster))
    return dataclasses.replace(kg, f_lists=lists(kg.f_lists),
                               g_lists=lists(kg.g_lists))


_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def graph_for(fa: FactorizedArrays, cluster: int) -> fk.KernelGraph:
    """``cluster_graph`` of ``fact_kernels.graph_for(fa)``, built once per
    graph and cluster size."""
    per = _graphs.setdefault(fa, {})
    if cluster not in per:
        per[cluster] = cluster_graph(fk.graph_for(fa), cluster)
    return per[cluster]


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ptr, _require, _stream = fk._ptr, fk._require, fk._stream


def _lib(name):
    from ..csrc import build
    fn = getattr(build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        if name == "stream_fwd":
            fn.argtypes = [_P] * 13 + [_F] + [_I] * 6 + [_P] * 7
        else:
            fn.argtypes = [_P] * 21 + [_I, _F] + [_I] * 7 + [_P] * 4
        fn.restype = ctypes.c_int
    return fn


def _check(rc, name, fa, cluster):
    if rc == -1:
        raise RuntimeError(
            f"{name}: cudaOccupancyMaxActiveClusters reports that no "
            f"cluster of {cluster} CTAs with {smem_bytes(fa, cluster)[name]} "
            "bytes of shared memory each can be resident on this card")
    fk._check(rc, name)


def _cluster(fa: FactorizedArrays, cluster):
    """The cluster size to launch: the caller's, else cluster_size(fa);
    raises if the graph's rows do not fit it."""
    c = cluster_size(fa) if cluster is None else int(cluster)
    if c is None or c not in CLUSTERS or \
            max(smem_bytes(fa, c).values()) > fk.MAX_SMEM:
        raise NotImplementedError(
            f"graph with S_pad={fa.s_pad} needs "
            f"{smem_bytes(fa, max(CLUSTERS))} bytes of shared memory per "
            f"CTA even on a cluster of {max(CLUSTERS)} CTAs (cluster "
            f"{cluster!r} asked), over the {fk.MAX_SMEM} a Hopper block "
            "has: no CUDA kernel serves it")
    return c


def stream_fwd(px, lengths, fa: FactorizedArrays, leaky_coefficient,
               cluster=None):
    """Launch the cluster alpha sweep on CUDA tensors; the arguments and
    results of :func:`fact_kernels.fact_fwd`."""
    fk._check_cuda_inputs(px, lengths, fa)
    c = _cluster(fa, cluster)
    kg = graph_for(fa, c)
    B, T, P = px.shape
    _require(kg.max_pdf < P, f"graph reads pdf {kg.max_pdf} but px has "
             f"only {P} columns")
    s_pad = fa.s_pad
    s0 = fa.initial.sum().reshape(1)
    ad0 = (fa.initial + leaky_coefficient * s0 * fa.leaky).contiguous()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=px.device)
    ad_ys, w1ad_ys, xdst_ys = (new(B, T, s_pad) for _ in range(3))
    xsrc_ys = None if kg.g_src is None else new(B, T, s_pad)
    s_ys, ad_last = new(B, T), new(B, s_pad)
    rc = _lib("stream_fwd")(
        _ptr(px), _ptr(lengths), _ptr(kg.f_dst), _ptr(kg.g_src),
        *map(_ptr, kg.w1), *map(_ptr, kg.w2), _ptr(ad0), _ptr(s0),
        _ptr(fa.leaky), float(leaky_coefficient), B, T, P, s_pad, c,
        rows_per_cta(s_pad, c), _ptr(ad_ys), _ptr(w1ad_ys), _ptr(xdst_ys),
        _ptr(xsrc_ys), _ptr(s_ys), _ptr(ad_last), _stream())
    _check(rc, "stream_fwd", fa, c)
    LAUNCHES["stream_fwd"] += 1
    return ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad_last, ad0, s0


def stream_bwd(lengths, fa: FactorizedArrays, leaky_coefficient, ad_ys,
               w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad0, s0, tot_prob, P,
               debug=True, cluster=None):
    """Launch the cluster beta sweep on the streams of :func:`stream_fwd`
    (or ``fact_fwd``).  Returns (gamma (B, T, P), alpha_beta (B, T),
    gamma_sum (B, T))."""
    c = _cluster(fa, cluster)
    kg = graph_for(fa, c)
    B, T, s_pad = ad_ys.shape
    for t in (ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, tot_prob):
        _require(t is None or (t.is_cuda and t.dtype == torch.float32
                               and t.is_contiguous()),
                 "stream_bwd: streams must be contiguous float32 on CUDA")
    _require((xsrc_ys is None) == (kg.g_src is None),
             "stream_bwd: x_src stream present iff the graph is not "
             "identity")
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=ad_ys.device)
    gamma, ab, gs = new(B, T, P), new(B, T), new(B, T)
    g_lists = kg.g_lists or (None, None)
    rc = _lib("stream_bwd")(
        _ptr(lengths), _ptr(ad_ys), _ptr(w1ad_ys), _ptr(xdst_ys),
        _ptr(xsrc_ys), _ptr(s_ys), _ptr(s0), _ptr(ad0), _ptr(fa.final),
        _ptr(tot_prob), _ptr(fa.leaky), *map(_ptr, kg.w1t),
        *map(_ptr, kg.w2t), *map(_ptr, kg.f_lists), *map(_ptr, g_lists),
        kg.n_pdf_lists, float(leaky_coefficient), B, T, P, s_pad, c,
        rows_per_cta(s_pad, c), int(bool(debug)), _ptr(gamma), _ptr(ab),
        _ptr(gs), _stream())
    _check(rc, "stream_bwd", fa, c)
    LAUNCHES["stream_bwd"] += 1
    return gamma, ab, gs


def forward_backward_prob_stream(px, lengths, fa: FactorizedArrays,
                                 leaky_coefficient=1e-5, debug: bool = True,
                                 cluster=None) -> FwdBwdResult:
    """Fused fwd+bwd on the cluster kernels (engine "stream").

    The arguments and results of
    :func:`fact_kernels.forward_backward_prob_kernel`; ``cluster`` forces
    the cluster size (default :func:`cluster_size`).  On the CPU this
    computes the plain version."""
    return fk.fused_fwd_bwd(
        px, lengths, fa, leaky_coefficient, debug,
        functools.partial(stream_fwd, cluster=cluster),
        functools.partial(stream_bwd, cluster=cluster))
