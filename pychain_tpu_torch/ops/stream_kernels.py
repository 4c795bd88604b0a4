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
runs on thread-block clusters: a cluster of C CTAs serves a group of G
batch columns, CTA r owns the 32-row state slices r, r + C, ... (R rows)
in all G columns, every vector holds the G columns interleaved, and a CTA
keeps whole only the vector its W1 (W1^T) product gathers, copying its
peers' rows of it each frame through distributed shared memory, so that
each sparse entry read from L2 feeds G columns:

* ``stream_fwd`` (``csrc/stream_fwd.cu``, replaces
  ``pallas_stream._fwd_kernel_factory``): the alpha sweep, the same
  streams and sums as ``fact_fwd``, one cluster barrier a frame;
* ``stream_bwd`` (``csrc/stream_bwd.cu``, replaces
  ``pallas_stream._bwd_kernel_factory``): the beta sweep, gamma and the
  traces, as ``fact_bwd``, two cluster barriers a frame.

:func:`plan` picks (C, G) for each kernel from the card's properties by
a written rule; ``cluster=`` / ``columns=`` override it.  The kernels
read the graph of ``fact_kernels.graph_for`` (its ascending rows,
:func:`operators`) plus, for stream_fwd, the x_src pdf at each W2
entry's source (:func:`w2_source_pdfs`), and the pdf -> states lists of
the posterior with state ids packed as (owner rank, local row) for the
cluster size C (:func:`cluster_graph`): CTA r sums the pdf columns
[r ceil(P / C), (r + 1) ceil(P / C)) from the CTAs that own the states.

Both precisions of the Pallas kernels: float32 ("parity") and the fast
mode of bfloat16 tiles (``precision="fast"``: bfloat16 operands and
streams, float32 sums and carries; a second entry point of each source,
``stream_fwd_bf16`` / ``stream_bwd_bf16``, reading the graph's fast form:
``KernelGraph.off`` and ``diag``).  Its plain version is
``factorized.forward_backward_prob_fast(..., cluster=C)``, which takes
every sum in the order these kernels take it at C CTAs a cluster (for
any G and either layout), so that the kernels give its numbers bit for
bit.

The fast forms run in one of two layouts (:data:`LAYOUTS`), which the
plan picks: "float", the float32 pair's (the whole vector a CTA gathers
from held as float32, each slot a column id and a float value read from
L2, 8 bytes), and "packed" (G = 2 or 4: the slots packed a word each as
``fact_kernels.pack_slots`` packs them, :func:`packed_operators`, 4
bytes a slot; the whole vector held rounded to bfloat16 and packed two
columns a word, so that a CTA holds G = 4 columns where the float layout
holds 2).  On an H100 the products of both wait on the operator's reads
from L2 per SM, not on L2's bandwidth; at main path 4 the packed layout
runs at (C, G) = (2, 2), 12-13% below the float layout there, and (4,
4) takes two waves (PERF.md).

A wrapper given CPU tensors computes the plain version
(``ops/factorized.py``; the fast one for bfloat16 tiles, in the cluster
order when the caller names C); given CUDA tensors it launches its
kernel or raises.  Each launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref

import torch

from . import fact_kernels as fk
from .factorized import (FactorizedArrays, forward_backward_prob_fast,
                         initial_alpha, is_fast)
from .fwdbwd import FwdBwdResult

CLUSTERS = (1, 2, 4, 8)      # portable cluster sizes, smallest first
COLUMNS = (1, 2, 4)          # batch columns a CTA serves (G), as compiled
THREADS = 32 * fk.FACT_WARPS   # FACT_THREADS in fact_common.cuh
# __launch_bounds__(FACT_THREADS, 1) lets a thread hold 64 registers, so
# the plan counts 64 a thread when it fits CTAs on an SM.
REGS_PER_THREAD = 64
RESERVED_SMEM = 1024         # shared memory the runtime keeps per block
LOCAL_BITS = 16              # CLUSTER_LOCAL_BITS in fact_common.cuh

KERNELS = ("stream_fwd", "stream_bwd")   # the plan's names, both precisions
LAYOUTS = ("packed", "float")   # the fast forms' layouts; float32: "float"
SLOT_BYTES = {"packed": 4, "float": 8}   # L2 bytes a slot read
LAUNCHES = {"stream_fwd": 0, "stream_bwd": 0, "stream_fwd_bf16": 0,
            "stream_bwd_bf16": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rows_per_cta(s_pad: int, cluster: int) -> int:
    """R: the rows of the CTA that owns the most 32-row slices when slice
    k belongs to CTA k mod C."""
    return -(-(s_pad // fk.SLICE) // cluster) * fk.SLICE


def smem_bytes(fa: FactorizedArrays, cluster: int, columns: int = 1,
               layout: str = "float") -> dict:
    """Dynamic shared memory of each CTA for C = ``cluster`` CTAs serving
    G = ``columns`` columns (must equal stream_fwd_smem_bytes /
    stream_bwd_smem_bytes in the sources), every vector holding the G
    columns, in 4-byte words.  The float layout (both precisions; the fast
    products gather bfloat16-rounded values from float32 copies):
    stream_fwd keeps alpha' whole (S_pad G) and alpha on its R rows (two
    buffers by frame parity when C > 1), stream_bwd x_dst * b whole and
    c1, c2 on its rows (no c2 in identity mode; b and the beta' carry live
    in device memory); plus the reductions' scratch and slots.  The packed
    layout (the fast forms at G = 2 or 4): the whole vector rounded and
    packed (S_pad G / 2 words), stream_fwd's two alpha buffers at every C
    (W2's operand and the diagonal read alpha'(t) from them), stream_bwd's
    own rows' unrounded x_dst * b (R G) and its masses packed (R G / 2
    each)."""
    s_pad, rows, G = fa.s_pad, rows_per_cta(fa.s_pad, cluster), columns
    identity = fa.xsrc_mode == "identity"
    packed = layout == "packed"
    W = G // 2 if packed else G
    nbuf = 2 if cluster > 1 or packed else 1
    return {"stream_fwd": (s_pad * W + nbuf * rows * G + fk.FACT_WARPS * G
                           + 3 * G) * 4,
            "stream_bwd": (s_pad * W + (rows * G if packed else 0)
                           + (1 if identity else 2) * rows * W
                           + 2 * fk.FACT_WARPS * G + 5 * G) * 4}


def _fast(fa) -> bool:
    """Whether ``fa`` has bfloat16 tiles (a graph's sizes alone, with no
    operators, count as float32)."""
    return getattr(fa, "w1", None) is not None and is_fast(fa)


def layouts(fa) -> tuple:
    """The layouts the cluster pair can run ``fa`` in: both for a fast
    graph (packed first), the float layout alone for float32."""
    return LAYOUTS if _fast(fa) else ("float",)


def fits(fa: FactorizedArrays, name: str, cluster: int, columns: int,
         limit: int = fk.MAX_SMEM, layout: str = "float") -> bool:
    """Whether kernel ``name``'s shared memory at (C, G) in ``layout`` is
    within ``limit`` (the packed layout exists at G = 2 and 4 alone)."""
    if layout == "packed" and columns not in (2, 4):
        return False
    return smem_bytes(fa, cluster, columns, layout)[
        name.removesuffix("_bf16")] <= limit


def fits_stream(fa: FactorizedArrays) -> bool:
    """Can the cluster kernels run this graph?  A fully factorized graph
    whose per-CTA share fits a Hopper block at one column a CTA on a
    cluster of at most max(CLUSTERS) CTAs (the port's counterpart of
    pallas_stream.fits_stream's VMEM estimate)."""
    return fk.supports(fa) and any(
        all(fits(fa, k, c, 1) for k in KERNELS) for c in CLUSTERS)


# ----------------------------------------------------------------------
# The launch plan
# ----------------------------------------------------------------------

# The plan's cost of one CTA's frame, in units of one row in one column
# (its emissions, stream entries and arithmetic): each row also reads its
# sparse entries from L2 once for all G columns, GRAPH_ROW for a row of
# 8-byte slots (the float layout's) and in proportion to the bytes a slot
# reads (SLOT_BYTES: half in the packed layout), and each 4 bytes copied
# from a peer cost COPY_FLOAT (16-byte DSMEM loads; stream_bwd's packed
# x_dst * b copies 2 bytes a value, stream_fwd copies float32 alpha in
# both layouts).  The weights are set by hand, not fitted: on an H100 the
# cheapest plan was the fastest one chip_smoke.py times at its three
# graphs, but the order below it is rough (equal costs can differ 2x in
# time).
GRAPH_ROW = 1.0
COPY_FLOAT = 0.25


@dataclasses.dataclass(frozen=True)
class Plan:
    """One kernel's launch: C CTAs a cluster, G columns a CTA, in one of
    :data:`LAYOUTS`."""
    kernel: str
    cluster: int
    columns: int
    layout: str
    threads: int
    ctas: int            # C * ceil(B / G)
    ctas_per_sm: int     # resident at once, by threads, smem, registers
    waves: int           # ceil(ctas / (SMs * ctas_per_sm))
    smem: int            # bytes a CTA
    cost: float          # waves * the busiest SM's work a frame


def _plan_of(fa, name, B, C, G, props, layout="float", active=None) -> Plan:
    rows = rows_per_cta(fa.s_pad, C)
    smem = smem_bytes(fa, C, G, layout)[name]
    ctas = C * -(-B // G)
    per_sm = min(props.max_threads_per_multi_processor // THREADS,
                 props.shared_memory_per_multiprocessor
                 // (smem + RESERVED_SMEM),
                 props.regs_per_multiprocessor // (THREADS * REGS_PER_THREAD))
    sms = props.multi_processor_count
    waves = -(-ctas // (sms * per_sm)) if per_sm else 0
    if active is not None and _fast(fa) and per_sm:
        # the fast forms: as many waves as the clusters of this shape the
        # card holds at once ask (an H100 holds 30 clusters of 4 CTAs of
        # one an SM, not 132 / 4)
        at_once = active(name, C, G, layout)
        waves = -(-(ctas // C) // at_once) if at_once > 0 else 0
        per_sm = per_sm if at_once > 0 else 0
    copied = fa.s_pad * G * (C - 1) / C          # values from the peers
    if layout == "packed" and name == "stream_bwd":
        copied /= 2
    frame = rows * (G + GRAPH_ROW * SLOT_BYTES[layout] / 8) \
        + COPY_FLOAT * copied
    busiest = min(per_sm, -(-ctas // sms))
    return Plan(name, C, G, layout, THREADS, ctas, per_sm, waves, smem,
                waves * busiest * frame)


def candidates(fa: FactorizedArrays, name: str, B: int, props,
               cluster=None, columns=None, layout=None, active=None) -> list:
    """Every plan of kernel ``name`` for B columns that fits the card
    (``props``: torch.cuda.get_device_properties), restricted to the
    given C, G and layout, cheapest first: by cost, then smaller C (fewer
    peers, copies and cluster barriers), then larger G, then the packed
    layout.  ``active(name, C, G, layout)``: the clusters of that shape
    the card holds at once (:func:`card_active`), which set the fast
    forms' waves; without it (and for the float32 pair) the waves are
    the CTAs over the SMs."""
    out = []
    for lay in layouts(fa) if layout is None else (layout,):
        if lay not in layouts(fa):
            continue            # not this precision's: a forced one raises
        for C in CLUSTERS if cluster is None else (int(cluster),):
            for G in COLUMNS if columns is None else (int(columns),):
                if C not in CLUSTERS or G not in COLUMNS:
                    continue    # not compiled: a forced C or G raises
                if columns is None and G > B:
                    continue    # a group wider than the batch
                if not fits(fa, name, C, G,
                            props.shared_memory_per_block_optin, lay):
                    continue
                p = _plan_of(fa, name, B, C, G, props, lay, active)
                if p.ctas_per_sm >= 1:
                    out.append(p)
    return sorted(out, key=lambda p: (p.cost, p.cluster, -p.columns,
                                      p.layout != "packed"))


def plan_kernel(fa: FactorizedArrays, name: str, B: int, props,
                cluster=None, columns=None, layout=None,
                active=None) -> Plan:
    """Kernel ``name``'s launch plan: the cheapest of :func:`candidates`.
    Raises NotImplementedError when no plan fits."""
    cand = candidates(fa, name, B, props, cluster, columns, layout, active)
    if not cand:
        raise NotImplementedError(
            f"{name}: graph with S_pad={fa.s_pad} fits no cluster of "
            f"{CLUSTERS} CTAs at {COLUMNS} columns a CTA in the layouts "
            f"{layouts(fa)} (cluster {cluster!r}, columns {columns!r}, "
            f"layout {layout!r} asked) within the "
            f"{props.shared_memory_per_block_optin} bytes of shared "
            "memory a block has on this card: no CUDA kernel serves it")
    return cand[0]


def plan(fa: FactorizedArrays, B: int, props, cluster=None,
         columns=None, layout=None, active=None) -> dict:
    """The launch plan of each cluster kernel: {"stream_fwd": Plan,
    "stream_bwd": Plan} (the two may differ: the streams' layout does not
    depend on C, G or the layout).  The rule, from the card's SM count,
    shared memory and registers (``props``:
    torch.cuda.get_device_properties): a CTA's frame costs R (G +
    GRAPH_ROW x the slot's bytes / 8) for its rows plus COPY_FLOAT for
    each 4 bytes it copies from its peers; the busiest SM runs min(CTAs
    per SM, ceil(CTAs / SMs)) CTAs a wave; the plan with the fewest waves
    times that wins, then the smaller C, then the larger G, then the
    packed layout.  The fast forms' waves count the clusters the card
    holds at once (``active``, :func:`card_active`; the wrappers pass
    the card's), which the float32 pair's rule does not (its plans stay
    as they were).  A fast graph's plans span both layouts, so that a
    graph the packed layout does not fit keeps the float layout's (every
    graph :func:`fits_stream` admits runs at G = 1).  ``cluster`` /
    ``columns`` / ``layout`` restrict the choice (tests, chip_smoke.py);
    one that does not fit raises."""
    return {name: plan_kernel(fa, name, B, props, cluster, columns, layout,
                              active)
            for name in KERNELS}


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


def operators(kg: fk.KernelGraph) -> tuple:
    """The four operators (W1, W2, W1^T, W2^T) the cluster pair reads, in
    ascending order: in the fast mode their off-diagonal entries alone
    (``kg.off``; the diagonals are ``kg.diag``), else the whole rows."""
    return kg.off or (kg.w1, kg.w2, kg.w1t, kg.w2t)


def w2_source_pdfs(kg: fk.KernelGraph) -> torch.Tensor:
    """x_src's pdf at each W2 entry's source state, in the sliced-ELL
    layout of the W2 the cluster pair reads (:func:`operators`; a padding
    entry names state 0): stream_fwd's W2 product reads x_src * alpha' at
    the source from px and its whole alpha'."""
    src = kg.f_dst if kg.g_src is None else kg.g_src
    return src[operators(kg)[1][1].long()].contiguous()


_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def graph_for(fa: FactorizedArrays, cluster: int) -> fk.KernelGraph:
    """``cluster_graph`` of ``fact_kernels.graph_for(fa)``, built once per
    graph and cluster size."""
    per = _graphs.setdefault(fa, {})
    if cluster not in per:
        per[cluster] = cluster_graph(fk.graph_for(fa), cluster)
    return per[cluster]


def packed_operators(kg: fk.KernelGraph) -> tuple:
    """The fast operators (W1, W2, W1^T, W2^T: :func:`operators`' slots,
    off-diagonal, ascending) packed a word a slot as
    ``fact_kernels.pack_slots`` packs them (the column id in the low 16
    bits, the bfloat16 value's bits in the high 16): what the packed
    layout reads, at the slots' own positions (the operators' slice
    pointers index them), on the graph's device."""
    return tuple(fk.pack_slots(op[1].cpu(), op[2].cpu()).to(op[1].device)
                 for op in operators(kg))


def packed_for(fa: FactorizedArrays) -> tuple:
    """``packed_operators`` of ``fact_kernels.graph_for(fa)``, built once
    per graph."""
    per = _graphs.setdefault(fa, {})
    if "pack" not in per:
        per["pack"] = packed_operators(fk.graph_for(fa))
    return per["pack"]


def w2_pdfs_for(fa: FactorizedArrays) -> torch.Tensor:
    """``w2_source_pdfs`` of ``fact_kernels.graph_for(fa)``, built once per
    graph."""
    per = _graphs.setdefault(fa, {})
    if "w2_pdf" not in per:
        per["w2_pdf"] = w2_source_pdfs(fk.graph_for(fa))
    return per["w2_pdf"]


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ptr, _require, _stream = fk._ptr, fk._require, fk._stream


def _lib(name):
    """The launch function ``name`` (stream_fwd, stream_bwd or their _bf16
    forms, two entry points of one source each)."""
    from ..csrc import build
    fast = name.endswith("_bf16")
    fn = getattr(build.load(name.removesuffix("_bf16")), f"{name}_launch")
    if fn.argtypes is None:
        # the fast forms take W1's and W2's packed slots with their
        # operators, the diagonals after them and the layout after rows
        if name.startswith("stream_fwd"):
            fn.argtypes = [_P] * (14 + 4 * fast) + [_F] + [_I] * (7 + fast) \
                + [_P] * 7
        else:
            fn.argtypes = [_P] * (21 + 4 * fast) + [_I, _F] \
                + [_I] * (8 + fast) + [_P] * 5
        fn.restype = ctypes.c_int
    return fn


def _name(kernel: str, fa: FactorizedArrays) -> str:
    """The entry point of ``kernel`` for this graph: its _bf16 form for
    bfloat16 tiles."""
    return kernel + "_bf16" if is_fast(fa) else kernel


@functools.lru_cache(maxsize=None)
def _active(kernel, s_pad, identity, C, G, fast, packed, device) -> int:
    from ..csrc import build
    fn = getattr(build.load(kernel), f"{kernel}_active_clusters")
    fn.restype = ctypes.c_int
    rows = rows_per_cta(s_pad, C)
    with torch.cuda.device(device):
        if kernel == "stream_fwd":
            n = fn(s_pad, rows, C, G, fast, packed)
        else:
            n = fn(s_pad, rows, identity, C, G, fast, packed)
    fk._check(max(-n, 0), f"{kernel}_active_clusters")
    return n


def card_active(fa: FactorizedArrays, device=None):
    """``active`` for :func:`plan` on the card of ``device`` (default the
    current one): cudaOccupancyMaxActiveClusters of each kernel, shape and
    layout for ``fa``'s precision, asked once each."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    identity, fast = int(fa.xsrc_mode == "identity"), int(is_fast(fa))
    return lambda name, C, G, layout: _active(
        name, fa.s_pad, identity, C, G, fast, int(layout == "packed"), dev)


def active_clusters(fa: FactorizedArrays, p: Plan) -> int:
    """cudaOccupancyMaxActiveClusters for plan ``p`` on the current card,
    for the kernel of the graph's precision: the clusters of its shape
    that can be resident at once."""
    return card_active(fa)(p.kernel, p.cluster, p.columns, p.layout)


def _check(rc, p: Plan):
    if rc == -1:
        raise RuntimeError(
            f"{p.kernel}: cudaOccupancyMaxActiveClusters reports that no "
            f"cluster of {p.cluster} CTAs with {p.smem} bytes of shared "
            "memory each can be resident on this card")
    fk._check(rc, p.kernel)


def _plan(fa: FactorizedArrays, B: int, device, name: str, cluster,
          columns, layout) -> Plan:
    """The plan to launch ``name`` with on this card, restricted to the
    caller's C, G and layout."""
    return plan_kernel(fa, name, B, torch.cuda.get_device_properties(device),
                       cluster, columns, layout, card_active(fa, device))


def stream_fwd(px, lengths, fa: FactorizedArrays, leaky_coefficient,
               cluster=None, columns=None, layout=None):
    """Launch the cluster alpha sweep on CUDA tensors: ``stream_fwd``, or
    ``stream_fwd_bf16`` for a graph with bfloat16 tiles (the fast mode);
    the arguments and results of :func:`fact_kernels.fact_fwd` (streams
    in ``fact_kernels.stream_dtype``).  ``cluster`` / ``columns`` /
    ``layout`` force C / G / the layout (default: :func:`plan`)."""
    fk._check_cuda_inputs(px, lengths, fa)
    B, T, P = px.shape
    p = _plan(fa, B, px.device, "stream_fwd", cluster, columns, layout)
    kg = graph_for(fa, p.cluster)
    _require(kg.max_pdf < P, f"graph reads pdf {kg.max_pdf} but px has "
             f"only {P} columns")
    s_pad = fa.s_pad
    ad0, s0 = initial_alpha(fa, leaky_coefficient)
    sd = fk.stream_dtype(fa)
    new = lambda *shape: torch.empty(shape, dtype=sd, device=px.device)
    ad_ys, w1ad_ys, xdst_ys = (new(B, T, s_pad) for _ in range(3))
    xsrc_ys = None if kg.g_src is None else new(B, T, s_pad)
    s_ys = torch.empty((B, T), dtype=torch.float32, device=px.device)
    ad_last = torch.empty((B, s_pad), dtype=torch.float32, device=px.device)
    w1, w2 = operators(kg)[:2]
    name = _name("stream_fwd", fa)
    fast = is_fast(fa)
    if fast:     # each operator's packed slots after it, the diagonals last
        pk1, pk2 = packed_for(fa)[:2]
        ops = [*map(_ptr, w1), _ptr(pk1), *map(_ptr, w2), _ptr(pk2),
               _ptr(w2_pdfs_for(fa)), *map(_ptr, kg.diag)]
    else:
        ops = [*map(_ptr, w1), *map(_ptr, w2), _ptr(w2_pdfs_for(fa))]
    rc = _lib(name)(
        _ptr(px), _ptr(lengths), _ptr(kg.f_dst), _ptr(kg.g_src), *ops,
        _ptr(ad0), _ptr(s0), _ptr(fa.leaky),
        float(leaky_coefficient), B, T, P, s_pad, p.cluster, p.columns,
        rows_per_cta(s_pad, p.cluster),
        *([int(p.layout == "packed")] if fast else []), _ptr(ad_ys),
        _ptr(w1ad_ys), _ptr(xdst_ys), _ptr(xsrc_ys), _ptr(s_ys),
        _ptr(ad_last), _stream())
    _check(rc, p)
    LAUNCHES[name] += 1
    return ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad_last, ad0, s0


def stream_bwd(lengths, fa: FactorizedArrays, leaky_coefficient, ad_ys,
               w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad0, s0, tot_prob, P,
               debug=True, cluster=None, columns=None, layout=None):
    """Launch the cluster beta sweep (``stream_bwd``, or
    ``stream_bwd_bf16`` in the fast mode) on the streams of
    :func:`stream_fwd` (or ``fact_fwd``).  Returns (gamma (B, T, P)
    float32, alpha_beta (B, T), gamma_sum (B, T))."""
    B, T, s_pad = ad_ys.shape
    sd = fk.stream_dtype(fa)
    for t in (ad_ys, w1ad_ys, xdst_ys, xsrc_ys):
        _require(t is None or (t.is_cuda and t.dtype == sd
                               and t.is_contiguous()),
                 f"stream_bwd: streams must be contiguous {sd} on CUDA")
    for t in (s_ys, tot_prob):
        _require(t.is_cuda and t.dtype == torch.float32
                 and t.is_contiguous(),
                 "stream_bwd: s_ys and tot_prob must be contiguous float32 "
                 "on CUDA")
    p = _plan(fa, B, ad_ys.device, "stream_bwd", cluster, columns, layout)
    kg = graph_for(fa, p.cluster)
    _require((xsrc_ys is None) == (kg.g_src is None),
             "stream_bwd: x_src stream present iff the graph is not "
             "identity")
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=ad_ys.device)
    gamma, ab, gs = new(B, T, P), new(B, T), new(B, T)
    carry = new(2, -(-B // p.columns) * p.columns, s_pad)
    g_lists = kg.g_lists or (None, None)
    w1t, w2t = operators(kg)[2:]
    name = _name("stream_bwd", fa)
    fast = is_fast(fa)
    if fast:     # each operator's packed slots after it, the diagonals last
        pk1, pk2 = packed_for(fa)[2:]
        ops = [*map(_ptr, w1t), _ptr(pk1), *map(_ptr, w2t), _ptr(pk2),
               *map(_ptr, kg.diag)]
    else:
        ops = [*map(_ptr, w1t), *map(_ptr, w2t)]
    rc = _lib(name)(
        _ptr(lengths), _ptr(ad_ys), _ptr(w1ad_ys), _ptr(xdst_ys),
        _ptr(xsrc_ys), _ptr(s_ys), _ptr(s0), _ptr(ad0), _ptr(fa.final),
        _ptr(tot_prob), _ptr(fa.leaky), *ops, *map(_ptr, kg.f_lists),
        *map(_ptr, g_lists), kg.n_pdf_lists, float(leaky_coefficient), B, T,
        P, s_pad, p.cluster, p.columns, rows_per_cta(s_pad, p.cluster),
        *([int(p.layout == "packed")] if fast else []), int(bool(debug)),
        _ptr(carry), _ptr(gamma), _ptr(ab), _ptr(gs), _stream())
    _check(rc, p)
    LAUNCHES[name] += 1
    return gamma, ab, gs


def forward_backward_prob_stream(px, lengths, fa: FactorizedArrays,
                                 leaky_coefficient=1e-5, debug: bool = True,
                                 cluster=None, columns=None,
                                 layout=None) -> FwdBwdResult:
    """Fused fwd+bwd on the cluster kernels (engine "stream"), in the fast
    mode for a graph with bfloat16 tiles.

    The arguments and results of
    :func:`fact_kernels.forward_backward_prob_kernel`; ``cluster``,
    ``columns`` and ``layout`` force C, G and the layout for both kernels
    (default :func:`plan`, per kernel).  On the CPU this computes the
    plain version; in the fast mode with the caller's ``cluster``, the
    sums in the order of the kernels at that C."""
    if px.is_cuda:
        # the "full" stream mode alone: its streams must fit the card
        fk.require_full_mode(px.shape[1], fa, px.shape[0],
                             fk.stream_budget(px.device))
    plain = None
    if is_fast(fa) and cluster is not None:
        plain = functools.partial(forward_backward_prob_fast,
                                  cluster=int(cluster))
    return fk.fused_fwd_bwd(
        px, lengths, fa, leaky_coefficient, debug,
        functools.partial(stream_fwd, cluster=cluster, columns=columns,
                          layout=layout),
        functools.partial(stream_bwd, cluster=cluster, columns=columns,
                          layout=layout),
        plain)
