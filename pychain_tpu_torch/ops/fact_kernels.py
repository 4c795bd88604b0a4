"""The factorized denominator forward-backward on hand-written CUDA kernels.

The port's counterpart of ``pychain_tpu/ops/pallas_fact.py``.  Its two
kernels, each in the three stream modes of the Pallas kernels, built
from ``csrc/fact_fwd.cu`` and ``csrc/fact_bwd.cu`` for Hopper
(``sm_90a``) and loaded with ctypes (``csrc/build.py``):

* B1, the alpha sweep (replaces ``_fwd_kernel_factory``): ``fact_fwd``
  emits the alpha' stream, W1 alpha' and the emission rows x_dst
  (x_src), the per-frame sums s_t and alpha' at each column's last frame
  ("full" mode); ``fact_fwd_snap`` alpha' alone at every C-th frame
  (C = 1: the "lean" mode's stream; C > 1: the "ckpt" mode's snapshots);
  ``fact_fwd_init`` one chunk's full-mode streams from a snapshot (the
  ckpt mode's replay);
* B2, the beta sweep (replaces ``_bwd_kernel_factory``): gamma (B, T, P)
  and the alpha*beta / sum-gamma invariant traces, from the full mode's
  streams (``fact_bwd``), from the alpha' stream and px (``fact_bwd_lean``:
  it forms W1 alpha' and the emission rows itself), or one chunk at a
  time with the beta' carry (``fact_bwd_chunk``).

Between them the objective is reduced here (``_objf``, as
``_objf_pallas``).  The kernels take the graph as sparse rows over its
arcs (``KernelGraph``: sliced ELL, built once per graph from the
stratified parts) and pdf -> states lists for the posterior scatter.
:func:`forward_backward_prob_kernel` picks the stream mode as
``forward_backward_prob_pallas`` does (``stream_mode="auto"``: the
cheapest whose streams fit the card's :func:`stream_budget`).

A wrapper given CPU tensors computes its kernel's plain PyTorch version
(``ops/factorized.py``); given CUDA tensors it launches the kernel or
raises.  Each launch adds one to ``LAUNCHES[name]``.

Covered: both precisions of the Pallas kernels, float32 ("parity")
and the fast mode of bfloat16 tiles (``precision="fast"``: bfloat16
operands and streams, float32 accumulation and carries; a second entry
point of each form, counted as ``<name>_bf16``), in every stream mode.
Their plain version is ``ops/factorized.forward_backward_prob_fact`` /
``forward_backward_prob_fast`` (``lean=True`` for the lean mode's
roundings) and ``forward_backward_prob_ckpt``.

Every form runs a column on a thread-block cluster of C CTAs
(``cluster=``; C = 1 is one block a column): CTA r computes its share of
the state rows and every sum is taken in the one-block kernel's order, so
the results do not depend on C.  :func:`cluster_size` picks C from the
card: the largest with B C CTAs on its SMs among those that run the form
faster than one block a column, so that a batch too small to fill the
card is spread over it.  The fast mode's full pair has a group form
(:func:`group_size`): G columns a cluster of C CTAs, each CTA's rows of
its two operators in shared memory for the whole launch
(:func:`pack_slots`), so that no frame reads the operator from device
memory, with the one-block kernels' bits; both forms take it past the
cluster forms' reach, and below it too, one column a cluster (G = 1).

A graph whose state vectors exceed a block's shared memory raises here
and is the cluster kernels' (``ops/stream_kernels.py``, B3/B4), which
have the "full" mode alone, as the JAX package's cluster tier does.
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
                         forward_backward_prob_fast,
                         forward_backward_prob_mode, initial_alpha, is_fast)
from .fwdbwd import FwdBwdResult, _ok_flags

TILE = 128
# A block's shared memory on Hopper: 227 KB (232,448 bytes) of dynamic
# shared memory after cudaFuncSetAttribute.
MAX_SMEM = 232448
FACT_WARPS = 32                       # FACT_THREADS / 32 in fact_common.cuh
# The cluster sizes built for every form (C = 1: one block a column), and
# a cluster CTA's least shared memory (LEAN_CLUSTER_MIN_SMEM in
# fact_common.cuh: two such CTAs do not fit one SM's 233,472 bytes).
LEAN_CLUSTERS = (1, 2, 4)
LEAN_CLUSTER_MIN_SMEM = 118784
# The cluster sizes the fast pair's group form is built for.
GROUP_CLUSTERS = (2, 4)
# fact_bwd and fact_bwd_chunk's cluster form: its exchange mbarriers
# (3 with FACT_BWD_ASYNC in csrc/fact_bwd.cu, else 0).
CLUSTER_XBARS = 3
# The stream modes (pallas_fact.py:786-807): "full" keeps three (T, S_pad,
# B) fwd->bwd streams (four outside identity mode), "lean" the alpha'
# stream alone, "ckpt" alpha' at each chunk's last frame.  The JAX
# package's fixed budget (pallas_fact.py:794-795, STREAM_BUDGET and
# LEAN_BUDGET both 4 GiB, sized for a 16 GB TPU) is select_stream_mode's
# default and the plain version's on the CPU; on a card the wrappers pass
# the card's own (stream_budget).
STREAM_BUDGET = 4 * 1024 * 1024 * 1024
STREAM_MODES = ("full", "lean", "ckpt")
FWD_FORMS = ("fact_fwd", "fact_fwd_snap", "fact_fwd_init")
BWD_FORMS = ("fact_bwd", "fact_bwd_lean", "fact_bwd_chunk")
# The forms each stream mode launches, all at one cluster size.
MODE_FORMS = {"full": ("fact_fwd", "fact_bwd"),
              "lean": ("fact_fwd_snap", "fact_bwd_lean"),
              "ckpt": ("fact_fwd_snap", "fact_fwd_init", "fact_bwd_chunk")}

# The ckpt mode's pair kernel (csrc/fact_ckpt.cu): one grid running a
# chunk's backward beside the replay of the chunk below (:func:`_ckpt`).
PAIR = "fact_ckpt_pair"
PAIR_ROLES = ("fact_fwd_init", "fact_bwd_chunk")

LAUNCHES = {f"{form}{suffix}": 0 for form in FWD_FORMS + BWD_FORMS + (PAIR,)
            for suffix in ("", "_bf16")}
# Each role's runs in the pair's launches, by the role's form (a launch
# with both roles adds one to each): a pair launch is counted in LAUNCHES
# alone.
ROLE_LAUNCHES = {f"{form}{suffix}": 0 for form in PAIR_ROLES
                 for suffix in ("", "_bf16")}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROLE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def launched() -> dict:
    """The kernels launched since the counts were last reset, with their
    counts."""
    return {k: v for k, v in LAUNCHES.items() if v}


def roles_launched() -> dict:
    """The pair kernel's roles run since the counts were last reset, with
    their counts (:data:`ROLE_LAUNCHES`)."""
    return {k: v for k, v in ROLE_LAUNCHES.items() if v}


def supports(fa: FactorizedArrays) -> bool:
    """The kernels handle fully-factorized graphs (no residual arcs)."""
    return int(fa.res_src.shape[0]) == 0


def stream_dtype(fa) -> torch.dtype:
    """The type of the fwd->bwd streams: bfloat16 in the fast mode,
    else float32 (also for a shape stub without ``w1``)."""
    fast = getattr(fa, "w1", None) is not None and is_fast(fa)
    return torch.bfloat16 if fast else torch.float32


def _bwd_smem_bytes(s_pad: int, identity: bool, stages: int,
                    entry: int = 4, lean: bool = False) -> int:
    rows = 1 if lean else 3 if identity else 4     # stream rows a frame
    # lean: alpha'(u), x_dst(u) and x_src(u) as float32 vectors besides
    vectors = (4 if identity else 5) + ((2 if identity else 3) if lean
                                         else 0)
    return ((vectors * s_pad + 3 * FACT_WARPS + 3) * 4
            + stages * (rows * s_pad * entry + 8))


def _full_cluster_smem(fa: FactorizedArrays, stages: int) -> int:
    """fact_bwd_full_cluster_kernel's request (fact_bwd_cluster_smem_bytes
    with lean 0): beta' and the masses in two buffers, b and x_dst * b,
    the totals in two buffers and the trace's, the ring and its mbarriers
    with the exchange's, padded to 16 bytes."""
    identity = fa.xsrc_mode == "identity"
    rows = 3 if identity else 4
    vectors = 6 if identity else 8
    bars = (stages + CLUSTER_XBARS + 1) & ~1
    need = (stages * rows * fa.s_pad * stream_dtype(fa).itemsize + bars * 8
            + (vectors * fa.s_pad + 2 * (2 * FACT_WARPS + 2) + FACT_WARPS
               + 1) * 4)
    return max(need, LEAN_CLUSTER_MIN_SMEM)


def ring_stages(fa: FactorizedArrays, lean: bool = False,
                cluster: int = 1) -> int:
    """fact_bwd's ring depth for this graph (fact_bwd_lean's with
    ``lean``) on ``cluster`` CTAs a column: the frames whose stream rows
    it holds in shared memory, fetched ahead by TMA (csrc/fact_bwd.cu).
    Two stages where they fit a block's shared memory, one where only one
    fits, none past that; a row is 2 S_pad bytes in the fast mode.  The
    lean form's cluster form keeps C = 1's depth; fact_bwd's and
    fact_bwd_chunk's takes what fits beside its layout
    (:func:`cluster_smem_bytes`)."""
    identity = fa.xsrc_mode == "identity"
    entry = stream_dtype(fa).itemsize
    for stages in (2, 1):
        need = (_full_cluster_smem(fa, stages) if cluster > 1 and not lean
                else _bwd_smem_bytes(fa.s_pad, identity, stages, entry,
                                     lean))
        if need <= MAX_SMEM:
            return stages
    return 0


def smem_bytes(fa: FactorizedArrays, stages: int | None = None,
               lean: bool = False) -> dict:
    """Dynamic shared memory of each kernel for this graph, fact_bwd's
    (with ``lean`` fact_bwd_lean's) with a ring of ``stages`` (default
    :func:`ring_stages`); must equal fact_fwd_smem_bytes /
    fact_bwd_smem_bytes in the sources.  In the fast mode outside
    identity mode fact_fwd holds a fifth vector.  Every forward form
    takes fact_fwd's, fact_bwd_chunk fact_bwd's."""
    identity = fa.xsrc_mode == "identity"
    entry = stream_dtype(fa).itemsize
    if stages is None:
        stages = ring_stages(fa, lean)
    vectors = 5 if entry == 2 and not identity else 4
    return {"fact_fwd": (vectors * fa.s_pad + FACT_WARPS + 1) * 4,
            "fact_bwd": _bwd_smem_bytes(fa.s_pad, identity, stages, entry,
                                        lean)}


def lean_px_ring(fa: FactorizedArrays, stages: int, P: int) -> bool:
    """Whether fact_bwd_lean's cluster form (C > 1) also fetches each
    frame's px row (P floats) into its ring by TMA (fact_bwd_lean_px_ring
    in the source): a ring at all, P a multiple of 4 (16-byte copies) and
    the request with them within a block.  The ring's depth and the
    limits are chosen without them."""
    identity = fa.xsrc_mode == "identity"
    return (stages > 0 and P > 0 and P % 4 == 0
            and _bwd_smem_bytes(fa.s_pad, identity, stages,
                                stream_dtype(fa).itemsize, lean=True)
            + stages * 4 * P <= MAX_SMEM)


def cluster_smem_bytes(fa: FactorizedArrays, cluster: int,
                       stages: int | None = None, P: int = 0) -> dict:
    """Dynamic shared memory a CTA of each form asks for on a cluster of
    ``cluster`` CTAs (the backward forms' with a ring of ``stages``,
    default :func:`ring_stages` of the form, for P pdfs); must equal the
    sources' fact_fwd_cluster_smem_bytes / fact_bwd_cluster_smem_bytes.
    At C = 1 :func:`smem_bytes`'.  At C > 1 every forward form also keeps
    x_src on its rows outside identity mode in float32 (frame t + 1's
    emissions are gathered before its carry exists) and two mbarriers
    (the full and init forms' exchanges), fact_bwd_lean a px
    row a stage where :func:`lean_px_ring` allows, fact_bwd and
    fact_bwd_chunk :func:`_full_cluster_smem`'s layout, and every form
    asks for at least LEAN_CLUSTER_MIN_SMEM, so that one CTA runs an
    SM."""
    lean_stages = ring_stages(fa, lean=True) if stages is None else stages
    full_stages = (ring_stages(fa, cluster=cluster) if stages is None
                   else stages)
    lean = smem_bytes(fa, lean_stages, lean=True)
    if cluster == 1:
        full = smem_bytes(fa, full_stages)["fact_bwd"]
        out = {form: lean["fact_fwd"] for form in FWD_FORMS}
        out.update({"fact_bwd": full, "fact_bwd_lean": lean["fact_bwd"],
                    "fact_bwd_chunk": full})
        return out
    vectors = 4 if fa.xsrc_mode == "identity" else 5
    # the vectors, the scratch padded to 16 bytes and two mbarriers
    fwd = max((vectors * fa.s_pad + FACT_WARPS + 8) * 4,
              LEAN_CLUSTER_MIN_SMEM)
    px = lean_stages * 4 * P if lean_px_ring(fa, lean_stages, P) else 0
    full = _full_cluster_smem(fa, full_stages)
    out = {form: fwd for form in FWD_FORMS}
    out.update({"fact_bwd": full, "fact_bwd_lean": max(
        lean["fact_bwd"] + px, LEAN_CLUSTER_MIN_SMEM),
        "fact_bwd_chunk": full})
    return out


# The cluster sizes the plan takes for each form (:func:`cluster_size`),
# from the card's times at main path 7 (B = 64) and bench.py --long
# (B = 32) in PERF.md.  C = 4 is built but planned for no form: at B = 32
# every form ran slower at C = 4 than at C = 1, its four-CTA exchange
# costing more than the products it splits.  fact_bwd and fact_bwd_chunk
# keep C = 1: their cluster form ran no faster than C = 1 at B = 64 and
# slower at B = 32 (its exchange and its serial stages take what its
# halved products save).
PLAN_CLUSTERS = {"fact_fwd": (1, 2), "fact_fwd_snap": (1, 2),
                 "fact_fwd_init": (1, 2), "fact_bwd": (1,),
                 "fact_bwd_lean": (1, 2), "fact_bwd_chunk": (1,)}


def cluster_fits(fa: FactorizedArrays, cluster: int, form: str,
                 limit: int = MAX_SMEM) -> bool:
    """Whether ``form``'s CTA fits a block on a cluster of ``cluster``
    CTAs (a backward form without a ring)."""
    return cluster_smem_bytes(fa, cluster, stages=0)[form] <= limit


def cluster_size(B: int, props, fa: FactorizedArrays, form: str,
                 cluster: int | None = None) -> int:
    """The cluster size C at which ``form`` runs B columns on the card
    (``props``: torch.cuda.get_device_properties): the largest C of
    :data:`PLAN_CLUSTERS` for the form with B C <= the card's SMs whose
    CTA fits its shared memory (on an H100's 132 SMs, for the forward
    forms and fact_bwd_lean: C = 1 at B = 128, 2 at B <= 66), else 1;
    C = 1 where S_pad <= 1024: a thread of the one-block kernel then has
    one row, so a split shortens no thread's rows and only adds the
    exchange (main path 6 (c)'s 128 states, PERF.md).
    ``cluster`` forces C; a C that is not built or whose CTA does not fit
    raises NotImplementedError (C = 1 is the one-block kernels', which
    check their own shared memory).  fact_bwd and fact_bwd_chunk's
    cluster form holds 2-3 vectors more than C = 1 (S_pad 9,600 in
    identity mode, else 7,168)."""
    limit = props.shared_memory_per_block_optin
    if cluster is not None:
        if cluster not in LEAN_CLUSTERS:
            raise NotImplementedError(
                f"{form} on a cluster of {cluster!r} CTAs: the kernels are "
                f"built for C in {LEAN_CLUSTERS}")
        if cluster > 1 and not cluster_fits(fa, cluster, form, limit):
            raise NotImplementedError(
                f"{form} on a cluster of {cluster} CTAs: a CTA asks for "
                f"{cluster_smem_bytes(fa, cluster, 0)[form]} bytes at "
                f"S_pad={fa.s_pad}, over the {limit} a block has on this "
                "card")
        return cluster
    if fa.s_pad <= 32 * FACT_WARPS:
        return 1
    for C in sorted(PLAN_CLUSTERS[form], reverse=True):
        if (B * C <= props.multi_processor_count
                and cluster_fits(fa, C, form, limit)):
            return C
    return 1


# The ckpt mode's chunk scan, paired (csrc/fact_ckpt.cu): one launch runs
# chunk k's backward (fact_bwd_chunk's body) in blocks 0 .. B - 1 and chunk
# k - 1's replay (fact_fwd_init's) in blocks B .. 2 B - 1, each one block a
# column, the chunk streams in two sets (chunk k in set k mod 2).  It
# serves B with 2 B <= the card's SMs (B <= 66 on an H100), where every
# block has an SM of its own and a launch takes about the slower role's
# time: at main path 7 (B = 64) and bench.py --long (B = 32) the paired
# scan ran faster than the unpaired one at its plan (PERF.md).  Past that
# reach one role alone fills the card, and the scan stays unpaired.

def pair_smem_bytes(fa: FactorizedArrays, stages: int | None = None) -> int:
    """fact_ckpt_pair's shared memory for this graph (the source's
    fact_ckpt_pair_smem_bytes): the larger of the two roles' one-block
    requests, the backward's ring ``stages`` deep (default
    :func:`ring_stages`)."""
    sm = smem_bytes(fa, stages)
    return max(sm["fact_fwd"], sm["fact_bwd"])


def pair_schedule(n_chunks: int) -> list:
    """The paired scan's launches over ``n_chunks`` chunks, in order: one
    (backward chunk, replay chunk) a launch, either None: the last chunk's
    replay alone, then chunk k's backward beside chunk k - 1's replay,
    then chunk 0's backward alone (n_chunks + 1 launches).  Chunk k's
    streams live in set k % 2, so a launch's replay writes the set its
    backward does not read, and the next launch's backward reads it."""
    return [(k + 1 if k + 1 < n_chunks else None, k if k >= 0 else None)
            for k in range(n_chunks - 1, -2, -1)]


def ckpt_paired(B: int, props, fa: FactorizedArrays,
                cluster: int | None = None, paired: bool | None = None,
                stages: int | None = None) -> bool:
    """Whether the ckpt mode runs its chunk scan paired
    (:func:`fact_ckpt_pair`) for B columns on the card (``props``): where
    2 B <= its SMs and the pair's CTA (:func:`pair_smem_bytes`) fits its
    shared memory, and no ``cluster`` is forced (a forced C runs every
    form at C, unpaired).  ``paired`` forces the choice: True where the
    pair does not fit (or with a cluster of more than one CTA) raises
    NotImplementedError."""
    limit = props.shared_memory_per_block_optin
    need = pair_smem_bytes(fa, stages)
    fits = 2 * B <= props.multi_processor_count and need <= limit
    if paired is None:
        return cluster is None and fits
    if paired and (not fits or cluster not in (None, 1)):
        raise NotImplementedError(
            f"the paired ckpt scan at B={B}, cluster={cluster!r}: it runs "
            f"2 B one-block CTAs ({2 * B} on {props.multi_processor_count} "
            f"SMs) of {need} bytes of shared memory ({limit} a block)")
    return bool(paired)


# The fast pair's group form (fact_fwd_bf16, fact_bwd_bf16 in the full
# mode): G columns a cluster of C CTAs, each CTA's rows of its operators
# in shared memory for the whole launch (csrc/fact_fwd.cu,
# csrc/fact_bwd.cu: fact_*_group_kernel).  GROUPS lists the (G, C) of
# two or more columns a cluster, FORM_GROUPS each form's: both also run
# one column a cluster (G = 1).  PLAN_GROUPS gives the (G, C) the plan takes
# for each form, in order, from the card's times at the headline graph in
# PERF.md.  Past the cluster forms' reach (B 2 > the card's SMs: B > 66 on
# an H100), where every form's cluster plan is one block a column, (2, 2)
# took 3.5 / 4.5 ms at B = 128 where one block a column took 5.0 / 5.2;
# (4, 4) is built, not planned (6.2-10.9 ms at B = 128, and at B = 67
# slower than (2, 2); ROADMAP.md queues its removal).  Within that reach
# both take (1, 2): B clusters of 2 CTAs, one a SM, in one wave (66
# clusters of 2 at once on an H100, cudaOccupancyMaxActiveClusters).  At
# the headline graph fact_bwd took 3.339 / 3.313 / 3.381 / 3.399 ms at B
# = 8 / 16 / 32 / 64 (T = 500) where one block a column took 5.022 /
# 4.981 / 5.055 / 5.040, and fact_fwd 2.538 / 2.574 / 2.560 / 2.545 where
# its cluster form (C = 2) took 3.710 / 3.743 / 3.732 / 3.834, so the
# plan takes it from B = 1; (1, 4) is not built: at bench.py --long (B =
# 32) the card holds 30 clusters of 4 at once, and fact_bwd took 23.257
# ms there against (1, 2)'s 16.557.
GROUP_FORMS = ("fact_fwd", "fact_bwd")
GROUPS = ((2, 2), (4, 4))
FORM_GROUPS = {f: ((1, 2),) + GROUPS for f in GROUP_FORMS}
PLAN_GROUPS = {f: ((1, 2), (2, 2)) for f in GROUP_FORMS}
# The least operator bytes (its slots at 8 bytes: what one block a column
# reads from L2 at every frame) at which the plan takes the group form:
# below them the one-block kernel's L1 holds enough of the operator that
# the group form's exchanges cost more than they save.  From the card's
# times at B = 128 on bench.py's graph family (PERF.md): the
# forward's group form won at 172 KB of W1 and W2 (3.1 against 3.5 ms)
# and lost at 95 KB (3.0 against 2.7); the backward's won at 364 KB of W1^T
# and W2^T (4.4 against 5.2), tied at 247 KB and lost at 130 KB (4.1
# against 3.8).
GROUP_MIN_OPERATOR_BYTES = {"fact_fwd": 128 * 1024, "fact_bwd": 300 * 1024}
# The same at G = 1, where the form it replaces (one block a column, or
# fact_fwd's cluster form) reads its rows of the operator from L2 at
# every frame: at B = 64 (T = 500) fact_bwd's (1, 2) won at 373 KB of
# W1^T and W2^T (3.399 against 5.040 ms), at about 250 KB (3.231 against
# 4.206) and at 130 KB (3.134 against 3.889); fact_fwd's at 454 KB of W1
# and W2 (2.545 against C = 2's 3.834), 344 KB (2.439 against 3.539),
# 177 KB (2.294 against 3.142), 133 KB (2.278 against 2.990), 113 KB
# (2.252 against 3.054) and 97,024 bytes (2.272 against 2.997).  The
# forward's least is the smallest operator measured, the backward's just
# under its; smaller ones were not measured.
GROUP_ONE_MIN_OPERATOR_BYTES = {"fact_fwd": 97_024, "fact_bwd": 128 * 1024}


def _packed_words(G):
    return G // 2 if G > 1 else 1      # packed_words in fact_common.cuh


def _group_red_words(nv):
    return (33 * nv + 3) & ~3          # group_red_words in the source


def _group_lp_words(s_pad, C):
    return ((s_pad // 32 + C - 1) // C + 1 + 3) & ~3    # group_lp_words


def group_smem_bytes(fa: FactorizedArrays, G: int, C: int,
                     words: dict | None = None) -> dict:
    """Dynamic shared memory of a group-form CTA at (G, C), {form: bytes};
    must equal fact_fwd_group_smem_bytes / fact_bwd_group_smem_bytes in
    the sources.  The vectors the products gather whole, packed (S_pad G
    / 2 words each, S_pad at G = 1: fact_fwd's alpha' and u, fact_bwd's
    b, x_dst * b and one or two
    mass vectors), the per-row vectors on rank 0's rows
    (fact_fwd's carry, x_dst and, outside identity mode, x_src, G floats
    a row, the last two in two buffers; fact_bwd's beta', G floats a row,
    and its stage of x_dst, W1 alpha', alpha' and x_src in two buffers,
    G bfloat16 entries a row), the totals' scratch, the mbarriers, two
    sets of local slice pointers and the operators' slots (``words``:
    {(form, C): words}, default the graph's :func:`group_op_words`), at
    least LEAN_CLUSTER_MIN_SMEM."""
    identity = fa.xsrc_mode == "identity"
    s_pad = fa.s_pad
    own_max = 32 * -(-(s_pad // 32) // C)
    words = words if words is not None else graph_for(fa).group_words
    lp = 2 * _group_lp_words(s_pad, C)
    fwd = (2 * s_pad * _packed_words(G)
           + (3 if identity else 5) * own_max * G
           + _group_red_words(G) + 4 + lp + words[("fact_fwd", C)])
    bwd = ((4 if identity else 6) * s_pad * _packed_words(G)
           + own_max * G + (3 if identity else 4) * own_max * G
           + _group_red_words(2 * G)
           + _group_red_words(G) + 8 + lp + words[("fact_bwd", C)])
    return {"fact_fwd": max(4 * fwd, LEAN_CLUSTER_MIN_SMEM),
            "fact_bwd": max(4 * bwd, LEAN_CLUSTER_MIN_SMEM)}


def _group_words(fa):
    """The graph's group-form slot words, or None where the form does not
    run (float32 tiles, or a graph past B1/B2's shared memory)."""
    if not is_fast(fa) or not fits_on_chip(fa):
        return None
    return graph_for(fa).group_words


def group_size(B: int, props, fa: FactorizedArrays, form: str,
               cluster: tuple | None = None):
    """The group form's (G, C) at which ``form`` runs B columns on the card
    (``props`` as :func:`cluster_size`), or None for the form of
    :func:`cluster_size`.  The plan takes it for the forms of
    :data:`PLAN_GROUPS` with bfloat16 tiles past 1,024 states where the
    form's operator takes at least :data:`GROUP_MIN_OPERATOR_BYTES`: the
    first (G, C) of the form's PLAN_GROUPS with ceil(B / G) C CTAs on the
    SMs whose CTA fits its shared memory, G > 1 only past the cluster
    forms' reach (B 2 > the SMs; below it a column has a cluster of its
    own), G = 1 where the operator takes at least
    :data:`GROUP_ONE_MIN_OPERATOR_BYTES`.  On an H100 at the headline
    graph both forms take (1, 2) to B = 66 and (2, 2) from 67 to 132.
    ``cluster`` = (G, C) forces one; a
    (G, C) that is not built for the form (:data:`FORM_GROUPS`), a form
    or a graph the group form does not run, or a CTA that does not fit
    raises NotImplementedError (nothing falls back to another form)."""
    limit = props.shared_memory_per_block_optin
    if cluster is not None:
        G, C = cluster
        if form not in GROUP_FORMS or (G, C) not in FORM_GROUPS[form]:
            raise NotImplementedError(
                f"{form} as a group of {G} columns on {C} CTAs: the group "
                f"form is built for (G, C) in {FORM_GROUPS}")
        words = _group_words(fa)
        if words is None:
            raise NotImplementedError(
                f"{form}'s group form runs bfloat16 tiles on a graph whose "
                f"state vectors fit a block (S_pad={fa.s_pad})")
        need = group_smem_bytes(fa, G, C, words)[form]
        if need > limit:
            raise NotImplementedError(
                f"{form} as a group of {G} columns on {C} CTAs: a CTA asks "
                f"for {need} bytes at S_pad={fa.s_pad}, over the {limit} a "
                "block has on this card")
        return G, C
    sms = props.multi_processor_count
    if form not in PLAN_GROUPS or fa.s_pad <= 32 * FACT_WARPS:
        return None
    words = _group_words(fa)
    if words is None:
        return None
    for G, C in PLAN_GROUPS[form]:
        least = (GROUP_ONE_MIN_OPERATOR_BYTES if G == 1
                 else GROUP_MIN_OPERATOR_BYTES)[form]
        if 8 * words[(form, 1)] < least or (G > 1 and 2 * B <= sms):
            continue
        if (-(-B // G) * C <= sms
                and group_smem_bytes(fa, G, C, words)[form] <= limit):
            return G, C
    return None


def group_active_clusters(fa: FactorizedArrays, form: str, group: tuple,
                          device=None) -> int:
    """The clusters of ``form``'s group form (fact_fwd or fact_bwd, bfloat16
    tiles) at ``group`` = (G, C) that the card of ``device`` holds at once
    for this graph (cudaOccupancyMaxActiveClusters,
    fact_*_group_active_clusters in csrc/fact_*.cu)."""
    from ..csrc import build
    _require(form in GROUP_FORMS, f"{form} has no group form")
    name = f"{form}_group_active_clusters"
    fn = getattr(build.load(form), name)
    fn.restype = ctypes.c_int
    G, C = group
    with torch.cuda.device(device or torch.cuda.current_device()):
        n = fn(fa.s_pad, int(fa.xsrc_mode == "identity"), G, C,
               graph_for(fa).group_words.get((form, C), 0))
    _check(max(-n, 0), name)
    return n


def _card_props(device):
    return torch.cuda.get_device_properties(device)


def fits_on_chip(fa: FactorizedArrays, lean: bool = False) -> bool:
    """Whether both kernels' per-column working set fits one block's
    shared memory, fact_bwd's (with ``lean`` fact_bwd_lean's) without a
    ring (replaces pallas_fact.fits_vmem)."""
    return max(smem_bytes(fa, stages=0, lean=lean).values()) <= MAX_SMEM


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


def _auto_mode(T: int, fa: FactorizedArrays, B: int, budget: int) -> str:
    """select_stream_mode on the streams of this graph, at the stream
    type's size (pallas_fact.py:869-871)."""
    n_streams = 3 if fa.xsrc_mode == "identity" else 4
    return select_stream_mode(T, fa.s_pad, B, stream_dtype(fa).itemsize,
                              n_streams, budget)


def require_full_mode(T: int, fa: FactorizedArrays, B: int, budget: int):
    """Raise unless the "full" stream mode's streams fit ``budget``: the
    cluster kernels (B3/B4) have that mode alone, as the JAX package's
    cluster tier has (pallas_stream.py:790-803, where it falls back to
    its XLA engine instead)."""
    mode = _auto_mode(T, fa, B, budget)
    if mode != "full":
        n_streams = 3 if fa.xsrc_mode == "identity" else 4
        raise NotImplementedError(
            f"stream mode {mode!r}: {n_streams} "
            f"{str(stream_dtype(fa))[6:]} streams of (T={T}, "
            f"S_pad={fa.s_pad}, B={B}) exceed the card's budget of {budget} "
            "bytes, and the cluster kernels (B3/B4, ops/stream_kernels.py) "
            "have the \"full\" mode alone, as the JAX package's cluster "
            "tier does")


def ckpt_chunk_length(T: int, ckpt_chunk: int | None = None) -> int:
    """The ckpt mode's chunk C (pallas_fact.py:952-954): ``ckpt_chunk``,
    default about sqrt(T) rounded up to a multiple of 8 (at least 8), at
    most T."""
    C = (ckpt_chunk if ckpt_chunk is not None
         else max(8, -8 * (-int(T ** 0.5) // 8)))
    return min(C, T)


def resolve_stream_mode(T: int, B: int, fa: FactorizedArrays,
                        stream_mode: str = "auto",
                        ckpt_chunk: int | None = None,
                        budget: int = STREAM_BUDGET,
                        on_card: bool = False) -> str:
    """The stream mode a call runs in, with forward_backward_prob_pallas's
    checks (pallas_fact.py:862-881): ValueError for a ``ckpt_chunk``
    that is no positive int or an unknown mode; "auto" the cheapest mode
    whose streams fit ``budget`` (:func:`select_stream_mode`).  On the
    card (``on_card``) "auto" takes "ckpt" where the lean mode's
    fact_bwd_lean would not fit a block (:func:`fits_on_chip`)."""
    if ckpt_chunk is not None and (not isinstance(ckpt_chunk, int)
                                   or ckpt_chunk <= 0):
        raise ValueError(f"ckpt_chunk must be a positive int, got "
                         f"{ckpt_chunk!r}")
    if stream_mode == "auto":
        mode = _auto_mode(T, fa, B, budget)
        if mode == "lean" and on_card and not fits_on_chip(fa, lean=True):
            mode = "ckpt"
        if get_verbose_level() >= 1:
            import sys as _sys
            print(f"pychain_tpu_torch: stream_mode auto -> {mode} (T={T}, "
                  f"s_pad={fa.s_pad}, B={B})", file=_sys.stderr)
        return mode
    if stream_mode not in STREAM_MODES:
        raise ValueError(f"unknown stream_mode {stream_mode!r}")
    return stream_mode


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
    ``diag``).  ``packed``, for a fast graph that B1/B2 run, holds
    ``resident``'s slots packed 4 bytes each (:func:`pack_slots`): the
    fast pair's group form loads them into shared memory; ``group_words``
    the most slot words a CTA of that form holds at each cluster size
    (:func:`group_op_words`), ``group_lists`` its E_f^T lists: ``f_lists``
    without the states whose mass is always exactly 0 (no W1 entry into
    the state and, in identity mode, no W2 entry out of it: the padded
    states, 72 of pdf 0's 73 at the headline graph), whose sums are
    ``f_lists``' bit for bit (adding +0 to a sum of terms >= +0).  The
    one-hot E matrices become gathers through f_dst/g_src and, for
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
    packed: tuple | None = None     # fast resident: the four's slots packed
    group_words: dict | None = None   # {(form, C): slot words a CTA}
    group_lists: tuple | None = None  # the group form's E_f^T lists

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
                mv(op) for op in self.resident),
            packed=None if self.packed is None else tuple(
                t.to(device) for t in self.packed),
            group_lists=mv(self.group_lists))


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


# ----------------------------------------------------------------------
# The fast pair's group form: slots packed 4 bytes each
# ----------------------------------------------------------------------
#
# fact_fwd_bf16 and fact_bwd_bf16's group form (csrc/fact_common.cuh,
# group_row_dot) holds each CTA's rows of its two operators in shared
# memory for the whole launch, a slot one 32-bit word: the column id in
# the low 16 bits (S_pad <= 14,464 < 65,536) and the bfloat16 value's bits
# in the high 16.  The fast mode's off-diagonal values are bfloat16 values
# (see sell_row_dot), so the packing is exact.

def pack_slots(col, val) -> torch.Tensor:
    """A sliced-ELL operator's (col, val) slots (int32, float32; CPU) as
    the group form's words (int32): col | bits(val) << 16.  Raises
    ValueError for a column id past 16 bits or a value that is not a
    bfloat16 value."""
    col = torch.as_tensor(col).to(torch.int64)
    val = torch.as_tensor(val).to(torch.float32)
    _require(bool(((col >= 0) & (col < 1 << 16)).all()),
             "pack_slots: a column id past 16 bits")
    _require(torch.equal(val.to(torch.bfloat16).float(), val),
             "pack_slots: a value that is not a bfloat16 value")
    hi = (val.view(torch.int32).to(torch.int64) >> 16) & 0xFFFF
    words = (col | hi << 16).numpy().astype(np.uint32).view(np.int32)
    return torch.from_numpy(words.copy())


def unpack_slots(words) -> tuple:
    """:func:`pack_slots`'s words back to (col int32, val float32), as the
    kernels read them (slot_col, slot_val)."""
    w = torch.as_tensor(words).to(torch.int32)
    col = (w & 0xFFFF).to(torch.int32)
    val = (w & ~0xFFFF).view(torch.float32)
    return col, val


def group_op_words(ops) -> dict:
    """The most slot words a CTA of the group form holds, {(form, C):
    words} for C in :data:`GROUP_CLUSTERS`, and at C = 1 all of them:
    fact_fwd's of W1 and W2 together, fact_bwd's of W1^T and W2^T
    (``ops``: the four operators in B1/B2's order), CTA r holding the
    slices k = r (mod C) (32 words a slot)."""
    slen = [np.diff(np.asarray(op[0].cpu()).astype(np.int64)) for op in ops]
    out = {}
    for C in (1,) + GROUP_CLUSTERS:
        for form, (a, b) in (("fact_fwd", (0, 1)), ("fact_bwd", (2, 3))):
            out[(form, C)] = 32 * max(
                int(slen[a][r::C].sum() + slen[b][r::C].sum())
                for r in range(C))
    return out


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
    packed = words = lists = None
    if fits_on_chip(fa):
        resident = tuple(map(bank_order, off or ops))
        if off is not None:
            packed = tuple(pack_slots(op[1], op[2]) for op in resident)
            words = group_op_words(resident)
            live = np.unique(r1)
            if identity:
                live = np.union1d(live, np.unique(c2))
            lists = _pdf_lists(f, p_pad, live)
    return KernelGraph(
        *ops, f_dst=torch.from_numpy(f.astype(np.int32)),
        g_src=None if identity else torch.from_numpy(g.astype(np.int32)),
        f_lists=_pdf_lists(f, p_pad),
        g_lists=None if identity else _pdf_lists(g, p_pad, np.unique(c2)),
        n_pdf_lists=p_pad, nnz=len(v1) + len(v2),
        max_pdf=int(max(f.max(), 0 if identity else g.max())),
        resident=resident, diag=diag, off=off, packed=packed,
        group_words=words, group_lists=lists)


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
    """The launch function ``name`` (a form of FWD_FORMS or BWD_FORMS, or
    its _bf16 entry point): every entry point of a source takes the same
    arguments (csrc/fact_fwd.cu, csrc/fact_bwd.cu)."""
    from ..csrc import build
    source = name[:8]
    fn = getattr(build.load(source), f"{name}_launch")
    if fn.argtypes is None:
        if source == "fact_fwd":
            fn.argtypes = [_P] * 17 + [_F] + [_I] * 11 + [_P] * 8
        else:
            fn.argtypes = [_P] * 30 + [_I, _F] + [_I] * 11 + [_P] * 7
        fn.restype = ctypes.c_int
    return fn


def _check(rc, name):
    if rc == -1:
        raise RuntimeError(f"{name}: cudaOccupancyMaxActiveClusters reports "
                           "that no cluster of the asked shape fits the card")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           "(cudaGetLastError)")


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _name(form, fa):
    return f"{form}_bf16" if is_fast(fa) else form


def _resident_graph(fa: FactorizedArrays) -> KernelGraph:
    kg = graph_for(fa)
    _require(kg.resident is not None,
             f"graph with S_pad={fa.s_pad} needs {smem_bytes(fa, 0)} bytes "
             f"of shared memory per block, over the {MAX_SMEM} a Hopper "
             "block has; the cluster kernels serve it (engine=\"stream\", "
             "ops/stream_kernels.py)")
    return kg


def _cluster_args(form, B, cluster, smid):
    """Check a launch's (cluster, smid): C in LEAN_CLUSTERS, smid a (B C,)
    int32 CUDA tensor or None."""
    _require(cluster in LEAN_CLUSTERS,
             f"{form}: cluster {cluster} is not built (C in "
             f"{LEAN_CLUSTERS})")
    _require(smid is None or (cluster > 1 and smid.is_cuda
                              and smid.dtype == torch.int32
                              and smid.shape == (B * cluster,)),
             f"{form}: smid must be a ({B * cluster},) int32 CUDA tensor, "
             "for a cluster launch")


def _fwd_launch(form, px, lengths, fa, leaky_coefficient, outs, t0=0,
                n_frames=None, snap=1, ad_rows=None, ad_init=None,
                s_init=None, s_ys=None, ad_last=None, cluster=1, smid=None):
    """Launch one forward form on CUDA tensors.  outs: (ad_ys, w1ad_ys,
    xdst_ys, xsrc_ys), each (B, ad_rows, S_pad) or None; ad_init (B,
    S_pad) and s_init (B,) may be strided views (a snapshot's rows, the
    s_ys column before the chunk, or one row expanded); cluster: CTAs a
    column; smid: each CTA's SM, written by a cluster launch."""
    name, args, ad0, s0 = _fwd_args(
        form, px, lengths, fa, leaky_coefficient, outs, t0, n_frames, snap,
        ad_rows, ad_init, s_init, s_ys, ad_last, cluster, smid)
    _check(_lib(name)(*args, _ptr(smid), _stream()), name)
    LAUNCHES[name] += 1
    return ad0, s0


def _fwd_args(form, px, lengths, fa, leaky_coefficient, outs, t0=0,
              n_frames=None, snap=1, ad_rows=None, ad_init=None, s_init=None,
              s_ys=None, ad_last=None, cluster=1, smid=None):
    """:func:`_fwd_launch`'s checks: (its entry point's name, the entry
    point's arguments up to ad_last, ad0, s0)."""
    _check_cuda_inputs(px, lengths, fa)
    kg = _resident_graph(fa)
    w1, w2 = kg.resident[:2]
    B, T, P = px.shape
    _require(kg.max_pdf < P, f"graph reads pdf {kg.max_pdf} but px has "
             f"only {P} columns")
    _cluster_args(form, B, cluster, smid)
    ad0, s0 = initial_alpha(fa, leaky_coefficient)
    sd = stream_dtype(fa)
    n_frames = T if n_frames is None else n_frames
    ad_rows = T if ad_rows is None else ad_rows
    _require(0 <= t0 and n_frames >= 1 and t0 + n_frames <= T and snap >= 1
             and ad_rows >= -(-(t0 + n_frames) // snap) - t0 // snap,
             f"{form}: frames {t0} .. {t0 + n_frames - 1} at snap {snap} "
             f"into {ad_rows} rows do not fit T={T}")
    for t in outs:
        _require(t is None or (t.is_cuda and t.dtype == sd
                               and t.is_contiguous()
                               and t.shape == (B, ad_rows, fa.s_pad)),
                 f"{form}: streams must be contiguous ({B}, {ad_rows}, "
                 f"{fa.s_pad}) {sd} CUDA tensors")
    if ad_init is not None:
        _require(ad_init.is_cuda and ad_init.dtype == sd
                 and ad_init.shape == (B, fa.s_pad)
                 and ad_init.stride(1) == 1 and s_init.is_cuda
                 and s_init.dtype == torch.float32 and s_init.shape == (B,),
                 f"{form}: ad_init must be ({B}, {fa.s_pad}) {sd} rows, "
                 f"s_init ({B},) float32, on CUDA")
    args = (_ptr(px), _ptr(lengths), _ptr(kg.f_dst), _ptr(kg.g_src),
            *map(_ptr, w1), *map(_ptr, w2),
            *map(_ptr, kg.diag or (None, None)), _ptr(ad0), _ptr(s0),
            _ptr(ad_init), _ptr(s_init), _ptr(fa.leaky),
            float(leaky_coefficient), B, T, P, fa.s_pad, t0, n_frames, snap,
            ad_rows, 0 if ad_init is None else ad_init.stride(0),
            0 if s_init is None else s_init.stride(0), cluster,
            *map(_ptr, outs), _ptr(s_ys), _ptr(ad_last))
    return _name(form, fa), args, ad0, s0


def _group_lib(source):
    """The group form's launch function of ``source`` ("fact_fwd" or
    "fact_bwd"): fact_*_group_launch in csrc/fact_*.cu."""
    from ..csrc import build
    fn = getattr(build.load(source), f"{source}_group_launch")
    if fn.argtypes is None:
        if source == "fact_fwd":
            fn.argtypes = [_P] * 13 + [_F] + [_I] * 7 + [_P] * 8
        else:
            fn.argtypes = [_P] * 21 + [_I, _F] + [_I] * 8 + [_P] * 5
        fn.restype = ctypes.c_int
    return fn


def _group_args(form, B, fa, group, smid):
    """Check a group launch's (G, C) and smid: built, the fast mode, a
    (ceil(B / G) C,) int32 CUDA smid or None."""
    _require(group in FORM_GROUPS[form], f"{form}: group {group} is not "
             f"built ((G, C) in {FORM_GROUPS[form]})")
    _require(is_fast(fa), f"{form}: the group form runs bfloat16 tiles")
    G, C = group
    n = -(-B // G) * C
    _require(smid is None or (smid.is_cuda and smid.dtype == torch.int32
                              and smid.shape == (n,)),
             f"{form}: smid must be a ({n},) int32 CUDA tensor")


def _fwd_group_launch(px, lengths, fa, leaky_coefficient, outs, s_ys,
                      ad_last, group, smid=None):
    """Launch fact_fwd_bf16's group form on CUDA tensors (counted as
    fact_fwd_bf16): G columns a cluster of C CTAs, ``group`` = (G, C).
    outs: (ad_ys, w1ad_ys, xdst_ys, xsrc_ys or None), (B, T, S_pad)
    bfloat16; s_ys (B, T), ad_last (B, S_pad) float32."""
    _check_cuda_inputs(px, lengths, fa)
    kg = _resident_graph(fa)
    B, T, P = px.shape
    _require(kg.max_pdf < P, f"graph reads pdf {kg.max_pdf} but px has "
             f"only {P} columns")
    _group_args("fact_fwd", B, fa, group, smid)
    for t in outs:
        _require(t is None or (t.is_cuda and t.dtype == torch.bfloat16
                               and t.is_contiguous()
                               and t.shape == (B, T, fa.s_pad)),
                 f"fact_fwd: streams must be contiguous ({B}, {T}, "
                 f"{fa.s_pad}) bfloat16 CUDA tensors")
    G, C = group
    ad0, s0 = initial_alpha(fa, leaky_coefficient)
    w1_ptr, w2_ptr = kg.resident[0][0], kg.resident[1][0]
    rc = _group_lib("fact_fwd")(
        _ptr(px), _ptr(lengths), _ptr(kg.f_dst), _ptr(kg.g_src),
        _ptr(w1_ptr), _ptr(kg.packed[0]), _ptr(w2_ptr), _ptr(kg.packed[1]),
        *map(_ptr, kg.diag), _ptr(ad0), _ptr(s0), _ptr(fa.leaky),
        float(leaky_coefficient), B, T, P, fa.s_pad, G, C,
        kg.group_words[("fact_fwd", C)], *map(_ptr, outs), _ptr(s_ys),
        _ptr(ad_last), _ptr(smid), _stream())
    _check(rc, "fact_fwd_bf16")
    LAUNCHES["fact_fwd_bf16"] += 1
    return ad0, s0


def _bwd_group_launch(lengths, fa, leaky_coefficient, streams, s_ys, ad0, s0,
                      tot_prob, outs, debug, group, smid=None):
    """Launch fact_bwd_bf16's group form (counted as fact_bwd_bf16) on
    fact_fwd's bfloat16 streams, ``group`` = (G, C).  outs: (gamma (B, T,
    P), ab, gs (B, T)) float32."""
    kg = _resident_graph(fa)
    ad_ys = streams[0]
    B, T, s_pad = ad_ys.shape
    _group_args("fact_bwd", B, fa, group, smid)
    for t in streams:
        _require(t is None or (t.is_cuda and t.dtype == torch.bfloat16
                               and t.is_contiguous()
                               and t.shape == ad_ys.shape),
                 "fact_bwd: streams must be contiguous bfloat16 on CUDA, of "
                 "one shape")
    _require((streams[3] is None) == (kg.g_src is None),
             "fact_bwd: x_src stream present iff the graph is not identity")
    gamma, ab, gs = outs
    P = gamma.shape[2]
    _require(s_pad == fa.s_pad and s_ys.shape == (B, T)
             and tot_prob.shape == (B,) and gamma.shape == (B, T, P)
             and ab.shape == gs.shape == (B, T)
             and all(t.is_cuda and t.dtype == torch.float32
                     and t.is_contiguous() for t in (s_ys, tot_prob, *outs)),
             f"fact_bwd: streams {tuple(ad_ys.shape)}, s_ys "
             f"{tuple(s_ys.shape)}, gamma {tuple(gamma.shape)}: shapes or "
             "types disagree")
    G, C = group
    w1t_ptr, w2t_ptr = kg.resident[2][0], kg.resident[3][0]
    g_lists = kg.g_lists or (None, None)
    rc = _group_lib("fact_bwd")(
        _ptr(lengths), *map(_ptr, streams), _ptr(s_ys), _ptr(s0), _ptr(ad0),
        _ptr(fa.final), _ptr(tot_prob), _ptr(fa.leaky), _ptr(w1t_ptr),
        _ptr(kg.packed[2]), _ptr(w2t_ptr), _ptr(kg.packed[3]),
        *map(_ptr, kg.diag), *map(_ptr, kg.group_lists),
        *map(_ptr, g_lists), kg.n_pdf_lists, float(leaky_coefficient), B, T,
        P, s_pad, int(bool(debug)), G, C, kg.group_words[("fact_bwd", C)],
        _ptr(gamma), _ptr(ab), _ptr(gs), _ptr(smid), _stream())
    _check(rc, "fact_bwd_bf16")
    LAUNCHES["fact_bwd_bf16"] += 1
    return gamma, ab, gs


def _new(fa, device, *shape, dtype=None):
    return torch.empty(shape, dtype=dtype or stream_dtype(fa), device=device)


def _plan(form, B, device, fa, cluster):
    """A wrapper's plan on ``device``'s card: the group form's (G, C)
    (:func:`group_size`; ``cluster`` = (G, C) forces it), else the
    cluster size C (:func:`cluster_size`; an int ``cluster`` forces it)."""
    return _form_plan(form, B, _card_props(device), fa, cluster)


def _form_plan(form, B, props, fa, cluster):
    if cluster is None or isinstance(cluster, tuple):
        group = group_size(B, props, fa, form, cluster)
        if group is not None:
            return group
    return cluster_size(B, props, fa, form, cluster)


def fact_fwd(px, lengths, fa: FactorizedArrays, leaky_coefficient,
             cluster: int | tuple | None = None, smid=None):
    """Launch the alpha sweep on CUDA tensors: ``fact_fwd``, or
    ``fact_fwd_bf16`` for a graph with bfloat16 tiles (the fast mode).
    px (B, T, P) float32, lengths (B,) int32 in [1, T].  A column runs on
    ``cluster`` CTAs, or with ``cluster`` = (G, C) a group of G columns on
    C CTAs (the fast mode's group form; default :func:`_plan` on px's
    card); ``smid`` (B C, or ceil(B / G) C) int32 receives each CTA's
    SM.  Returns (ad_ys, w1ad_ys, xdst_ys, xsrc_ys or None: (B, T, S_pad)
    in :func:`stream_dtype`; s_ys (B, T), ad_last (B, S_pad), ad0, s0:
    float32)."""
    B, T, _ = px.shape
    cluster = _plan("fact_fwd", B, px.device, fa, cluster)
    s_pad = fa.s_pad
    streams = [_new(fa, px.device, B, T, s_pad) for _ in range(3)]
    streams.append(None if fa.xsrc_mode == "identity"
                   else _new(fa, px.device, B, T, s_pad))
    s_ys = _new(fa, px.device, B, T, dtype=torch.float32)
    ad_last = _new(fa, px.device, B, s_pad, dtype=torch.float32)
    if isinstance(cluster, tuple):
        ad0, s0 = _fwd_group_launch(px, lengths, fa, leaky_coefficient,
                                    streams, s_ys, ad_last, cluster, smid)
    else:
        ad0, s0 = _fwd_launch("fact_fwd", px, lengths, fa,
                              leaky_coefficient, streams, s_ys=s_ys,
                              ad_last=ad_last, cluster=cluster, smid=smid)
    return (*streams, s_ys, ad_last, ad0, s0)


def fact_fwd_snap(px, lengths, fa: FactorizedArrays, leaky_coefficient,
                  snap: int = 1, cluster: int | None = None, smid=None):
    """Launch the alpha sweep without the auxiliary streams
    (``fact_fwd_snap`` or its _bf16 form): alpha' at the frames t with
    (t + 1) % snap == 0, at row (t + 1) // snap - 1 (pallas_fact.py
    :419-431: snap 1 is the lean mode's stream, snap C the ckpt mode's
    snapshots, alpha' at each chunk's last frame).  A column runs on
    ``cluster`` CTAs, ``smid`` as :func:`fact_fwd`.  Returns (ad_ys (B,
    ceil(T / snap), S_pad) in :func:`stream_dtype`, s_ys (B, T), ad_last
    (B, S_pad), ad0, s0)."""
    B, T, _ = px.shape
    cluster = _plan("fact_fwd_snap", B, px.device, fa, cluster)
    rows = -(-T // snap)
    ad_ys = _new(fa, px.device, B, rows, fa.s_pad)
    s_ys = _new(fa, px.device, B, T, dtype=torch.float32)
    ad_last = _new(fa, px.device, B, fa.s_pad, dtype=torch.float32)
    ad0, s0 = _fwd_launch("fact_fwd_snap", px, lengths, fa,
                          leaky_coefficient, (ad_ys, None, None, None),
                          snap=snap, ad_rows=rows, s_ys=s_ys,
                          ad_last=ad_last, cluster=cluster, smid=smid)
    return ad_ys, s_ys, ad_last, ad0, s0


def fact_fwd_init(px, lengths, fa: FactorizedArrays, leaky_coefficient,
                  t0: int, ad_init, s_init, streams,
                  cluster: int | None = None, smid=None):
    """Launch the ckpt mode's replay of frames t0 .. t0 + n - 1
    (``fact_fwd_init`` or its _bf16 form; n = streams[0].shape[1], cut at
    each column's length) from alpha'(t0) = ad_init (B, S_pad) and
    s_{t0} = s_init (B,), into ``streams`` (alpha', W1 alpha', x_dst,
    x_src or None: (B, n, S_pad), local rows t - t0), a column on
    ``cluster`` CTAs (``smid`` as :func:`fact_fwd`)."""
    n = streams[0].shape[1]
    cluster = _plan("fact_fwd_init", px.shape[0], px.device, fa, cluster)
    _fwd_launch("fact_fwd_init", px, lengths, fa, leaky_coefficient,
                streams, t0=t0, n_frames=n, ad_rows=n, ad_init=ad_init,
                s_init=s_init, cluster=cluster, smid=smid)
    return streams


def _bwd_launch(form, lengths, fa, leaky_coefficient, streams, s_ys, ad0, s0,
                tot_prob, outs, debug, stages, px=None, t0=0, n_frames=None,
                ad_init=None, carry=(None, None), cluster=1, smid=None):
    """Launch one backward form.  streams: (ad_ys, w1ad_ys, xdst_ys,
    xsrc_ys), any None; outs: (gamma (B, T, P), ab (B, T), gs (B, T));
    carry: (bd (B, S_pad), leak (B,)) or Nones; cluster, smid as
    :func:`_fwd_launch`."""
    name, args = _bwd_args(form, lengths, fa, leaky_coefficient, streams,
                           s_ys, ad0, s0, tot_prob, outs, debug, stages, px,
                           t0, n_frames, ad_init, carry, cluster, smid)
    _check(_lib(name)(*args, _ptr(smid), _stream()), name)
    LAUNCHES[name] += 1
    return outs


def _bwd_args(form, lengths, fa, leaky_coefficient, streams, s_ys, ad0, s0,
              tot_prob, outs, debug, stages, px=None, t0=0, n_frames=None,
              ad_init=None, carry=(None, None), cluster=1, smid=None,
              words=False):
    """:func:`_bwd_launch`'s checks: (its entry point's name, the entry
    point's arguments up to leak_io).  ``words``: W1^T's and W2^T's
    column ids replaced by their packed slots (KernelGraph.packed), as the
    pair kernel's fast chunk role reads them (FACT_PAIR_WORDS in
    csrc/fact_ckpt.cu; the values are passed too, and not read)."""
    lean = form == "fact_bwd_lean"
    kg = _resident_graph(fa)
    w1t, w2t = kg.resident[2:]
    if words:
        _require(kg.packed is not None, f"{form}: packed slots exist for a "
                 "fast graph alone")
        w1t, w2t = ((w1t[0], kg.packed[2], w1t[2]),
                    (w2t[0], kg.packed[3], w2t[2]))
    ad_ys = streams[0]
    B, rows, s_pad = ad_ys.shape
    _cluster_args(form, B, cluster, smid)
    if stages is None:
        stages = ring_stages(fa, lean, cluster)
    P = outs[0].shape[2]
    _require(stages in (0, 1, 2)
             and cluster_smem_bytes(fa, cluster, stages, P)[form]
             <= MAX_SMEM,
             f"{form}: a ring of {stages} stages does not fit a block at "
             f"S_pad={fa.s_pad}")
    T = s_ys.shape[1]
    n_frames = T if n_frames is None else n_frames
    sd = stream_dtype(fa)
    for t in streams:
        _require(t is None or (t.is_cuda and t.dtype == sd
                               and t.is_contiguous()
                               and t.shape == ad_ys.shape),
                 f"{form}: streams must be contiguous {sd} on CUDA, of one "
                 "shape")
    for t in (s_ys, tot_prob):
        _require(t.is_cuda and t.dtype == torch.float32
                 and t.is_contiguous(),
                 f"{form}: s_ys and tot_prob must be contiguous float32 on "
                 "CUDA")
    gamma, ab, gs = outs
    _require(s_pad == fa.s_pad and s_ys.shape == (B, T)
             and tot_prob.shape == (B,) and rows == n_frames
             and 0 <= t0 and t0 + n_frames <= T
             and gamma.shape == (B, T, P) and ab.shape == gs.shape == (B, T)
             and all(o.is_cuda and o.dtype == torch.float32
                     and o.is_contiguous() for o in outs),
             f"{form}: streams of {rows} frames from {t0}, s_ys "
             f"{tuple(s_ys.shape)}, gamma {tuple(gamma.shape)}: shapes "
             "disagree")
    if lean:
        _require(px.is_cuda and px.dtype == torch.float32
                 and px.is_contiguous(), f"{form}: px must be a contiguous "
                 "float32 CUDA tensor")
    else:
        _require((streams[3] is None) == (kg.g_src is None),
                 f"{form}: x_src stream present iff the graph is not "
                 "identity")
    if ad_init is not None:
        bd, leak = carry
        _require(ad_init.is_cuda and ad_init.dtype == sd
                 and ad_init.shape == (B, s_pad) and ad_init.stride(1) == 1
                 and bd.is_cuda and bd.dtype == torch.float32
                 and bd.is_contiguous() and bd.shape == (B, s_pad)
                 and leak.is_cuda and leak.dtype == torch.float32
                 and leak.shape == (B,),
                 f"{form}: ad_init ({B}, {s_pad}) {sd} rows, carry ({B}, "
                 f"{s_pad}) and ({B},) float32, on CUDA")
    g_lists = kg.g_lists or (None, None)
    w1 = kg.resident[0] if lean else (None, None, None)
    args = (_ptr(lengths), *map(_ptr, streams), _ptr(px), _ptr(s_ys),
            _ptr(s0), _ptr(ad0), _ptr(ad_init), _ptr(fa.final),
            _ptr(tot_prob), _ptr(fa.leaky), *map(_ptr, w1t), *map(_ptr, w2t),
            *map(_ptr, w1), _ptr(kg.f_dst if lean else None),
            _ptr(kg.g_src if lean else None),
            *map(_ptr, kg.diag or (None, None)), *map(_ptr, kg.f_lists),
            *map(_ptr, g_lists), kg.n_pdf_lists, float(leaky_coefficient),
            B, T, P, s_pad, int(bool(debug)), stages, t0, n_frames, rows,
            0 if ad_init is None else ad_init.stride(0), cluster,
            _ptr(gamma), _ptr(ab), _ptr(gs), *map(_ptr, carry))
    return _name(form, fa), args


def _outputs(B, T, P, device):
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=device)
    return new(B, T, P), new(B, T), new(B, T)


def fact_bwd(lengths, fa: FactorizedArrays, leaky_coefficient, ad_ys,
             w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad0, s0, tot_prob, P,
             debug=True, stages=None, cluster: int | tuple | None = None,
             smid=None):
    """Launch the beta sweep on the streams of :func:`fact_fwd`
    (``fact_bwd``, or ``fact_bwd_bf16`` in the fast mode), its ring
    ``stages`` deep (default :func:`ring_stages`), a column on
    ``cluster`` CTAs or a group on (G, C) (the group form has no ring;
    ``smid`` as :func:`fact_fwd`).  Returns (gamma (B, T, P) float32,
    alpha_beta (B, T), gamma_sum (B, T))."""
    B, T, _ = ad_ys.shape
    cluster = _plan("fact_bwd", B, ad_ys.device, fa, cluster)
    if isinstance(cluster, tuple):
        _require(stages is None, "fact_bwd: the group form has no ring "
                 f"(stages={stages})")
        return _bwd_group_launch(lengths, fa, leaky_coefficient,
                                 (ad_ys, w1ad_ys, xdst_ys, xsrc_ys), s_ys,
                                 ad0, s0, tot_prob,
                                 _outputs(B, T, P, ad_ys.device), debug,
                                 cluster, smid)
    return _bwd_launch("fact_bwd", lengths, fa, leaky_coefficient,
                       (ad_ys, w1ad_ys, xdst_ys, xsrc_ys), s_ys, ad0, s0,
                       tot_prob, _outputs(B, T, P, ad_ys.device), debug,
                       stages, cluster=cluster, smid=smid)


def fact_bwd_lean(lengths, fa: FactorizedArrays, leaky_coefficient, ad_ys,
                  px, s_ys, ad0, s0, tot_prob, debug=True, stages=None,
                  cluster: int | None = None, smid=None):
    """Launch the lean mode's beta sweep (``fact_bwd_lean`` or its _bf16
    form) on the alpha' stream of ``fact_fwd_snap(..., snap=1)`` and px
    (B, T, P) float32, its ring ``stages`` deep (default
    ``ring_stages(fa, lean=True)``), a column on ``cluster`` CTAs (as
    :func:`fact_fwd_snap`).  Returns (gamma, alpha_beta, gamma_sum) as
    :func:`fact_bwd`."""
    B, T, P = px.shape
    cluster = _plan("fact_bwd_lean", B, px.device, fa, cluster)
    return _bwd_launch("fact_bwd_lean", lengths, fa, leaky_coefficient,
                       (ad_ys, None, None, None), s_ys, ad0, s0, tot_prob,
                       _outputs(B, T, P, px.device), debug, stages, px=px,
                       cluster=cluster, smid=smid)


def fact_bwd_chunk(lengths, fa: FactorizedArrays, leaky_coefficient,
                   streams, s_ys, ad0, s0, tot_prob, t0, ad_init, outs,
                   carry, debug=True, stages=None,
                   cluster: int | None = None, smid=None):
    """Launch the beta sweep of one ckpt chunk, frames t0 .. t0 + n - 1
    (``fact_bwd_chunk`` or its _bf16 form; n = streams[0].shape[1]), on
    :func:`fact_fwd_init`'s streams for it, alpha'(t0) = ad_init (B,
    S_pad): the chunk's gamma and traces into its frames of ``outs``
    (gamma (B, T, P), ab, gs (B, T)); beta' and its leaky sum from
    ``carry`` (bd (B, S_pad), leak (B,) float32) unless a column ends in
    the chunk, and back into it for the chunk below (t0 > 0); a column on
    ``cluster`` CTAs (``smid`` as :func:`fact_fwd`)."""
    cluster = _plan("fact_bwd_chunk", streams[0].shape[0],
                    streams[0].device, fa, cluster)
    return _bwd_launch("fact_bwd_chunk", lengths, fa, leaky_coefficient,
                       streams, s_ys, ad0, s0, tot_prob, outs, debug,
                       stages, t0=t0, n_frames=streams[0].shape[1],
                       ad_init=ad_init, carry=carry, cluster=cluster,
                       smid=smid)


def _pair_lib(name):
    """fact_ckpt_pair's launch function ``name`` (or its _bf16 entry
    point): fact_fwd_init's arguments up to ad_last, then fact_bwd_chunk's
    up to leak_io, smid and the stream (csrc/fact_ckpt.cu)."""
    from ..csrc import build
    fn = getattr(build.load("fact_ckpt"), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 17 + [_F] + [_I] * 11 + [_P] * 6
                       + [_P] * 30 + [_I, _F] + [_I] * 11 + [_P] * 5
                       + [_P] * 2)
        fn.restype = ctypes.c_int
    return fn


# An absent role's arguments: no columns (B = 0).
_NO_REPLAY = (None,) * 17 + (0.0,) + (0,) * 11 + (None,) * 6
_NO_BACKWARD = (None,) * 30 + (0, 0.0) + (0,) * 11 + (None,) * 5


def _pair_launch(fa, replay, backward, smid=None):
    """Launch fact_ckpt_pair (fact_ckpt_pair_bf16 in the fast mode): its
    first blocks run ``backward`` (:func:`_bwd_launch`'s keyword arguments
    for fact_bwd_chunk), the rest ``replay`` (:func:`_fwd_launch`'s for
    fact_fwd_init), one block a column; either may be None, not both.
    smid: a (blocks,) int32 CUDA tensor receiving each block's SM, or
    None.  Counts one launch of the pair and one of each role it ran."""
    _require(replay is not None or backward is not None,
             "fact_ckpt_pair: a launch runs a replay, a backward or both")
    fwd = bwd = None
    if replay is not None:
        fwd = _fwd_args(**replay)
    if backward is not None:
        # the fast chunk role reads W1^T and W2^T as packed words
        bwd = _bwd_args(**backward, words=is_fast(fa))
    blocks = sum(role["lengths"].shape[0] for role in (replay, backward)
                 if role is not None)
    if replay is not None and backward is not None:
        r_px, b_st = replay["px"], backward["streams"][0]
        _require(replay["lengths"] is backward["lengths"]
                 and r_px.shape[0] == b_st.shape[0]
                 and r_px.shape[1] == backward["s_ys"].shape[1]
                 and r_px.shape[2] == backward["outs"][0].shape[2],
                 "fact_ckpt_pair: the roles' lengths and shapes differ")
        spans = lambda ts: [(t.data_ptr(), t.data_ptr()
                             + t.numel() * t.element_size())
                            for t in ts if t is not None]
        _require(not any(a < d and c < b
                         for a, b in spans(replay["outs"])
                         for c, d in spans(backward["streams"])),
                 "fact_ckpt_pair: the replay writes streams its backward "
                 "reads")
    _require(smid is None or (smid.is_cuda and smid.dtype == torch.int32
                              and smid.shape == (blocks,)),
             f"fact_ckpt_pair: smid must be a ({blocks},) int32 CUDA tensor")
    name = _name(PAIR, fa)
    rc = _pair_lib(name)(*(fwd[1] if fwd else _NO_REPLAY),
                         *(bwd[1] if bwd else _NO_BACKWARD), _ptr(smid),
                         _stream())
    _check(rc, name)
    LAUNCHES[name] += 1
    for role in (fwd, bwd):
        if role is not None:
            ROLE_LAUNCHES[role[0]] += 1


def fact_ckpt_pair(px, lengths, fa: FactorizedArrays, leaky_coefficient,
                   replay, backward, s_ys, ad0, s0, tot_prob, outs, carry,
                   debug=True, stages=None, smid=None):
    """Launch the ckpt mode's pair kernel (``fact_ckpt_pair`` or its _bf16
    form, csrc/fact_ckpt.cu): ``backward`` = (t0, ad_init, streams) runs
    that chunk's backward as :func:`fact_bwd_chunk` does (its ring
    ``stages`` deep), in blocks 0 .. B - 1, and ``replay`` = (t0, ad_init,
    s_init, streams) that chunk's replay as :func:`fact_fwd_init` does, in
    the blocks after them; either None.  The replay's streams must not
    overlap the backward's.  ``smid`` ((blocks,) int32) receives each
    block's SM."""
    fwd = bwd = None
    if replay is not None:
        t0, ad_init, s_init, streams = replay
        n = streams[0].shape[1]
        fwd = dict(form="fact_fwd_init", px=px, lengths=lengths, fa=fa,
                   leaky_coefficient=leaky_coefficient, outs=streams, t0=t0,
                   n_frames=n, ad_rows=n, ad_init=ad_init, s_init=s_init)
    if backward is not None:
        t0, ad_init, streams = backward
        bwd = dict(form="fact_bwd_chunk", lengths=lengths, fa=fa,
                   leaky_coefficient=leaky_coefficient, streams=streams,
                   s_ys=s_ys, ad0=ad0, s0=s0, tot_prob=tot_prob, outs=outs,
                   debug=debug, stages=stages, t0=t0,
                   n_frames=streams[0].shape[1], ad_init=ad_init,
                   carry=carry)
    _pair_launch(fa, fwd, bwd, smid)
    return outs


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


def _card_lengths(px, lengths):
    """lengths as a (B,) int32 tensor on px's card, checked to lie in
    [1, T] on a host copy (lengths given on the host cost no wait)."""
    T = px.shape[1]
    lens_host = torch.as_tensor(lengths).cpu().to(torch.int32)
    _require(bool(((lens_host >= 1) & (lens_host <= T)).all()),
             f"lengths must lie in [1, T={T}]")
    return host_to(lens_host.contiguous(), px.device)


def _check_graph(fa: FactorizedArrays):
    if not supports(fa):
        raise ValueError("the factorized kernels require a fully "
                         "factorized graph (no residual arcs)")


def fused_fwd_bwd(px, lengths, fa: FactorizedArrays, leaky_coefficient,
                  debug, fwd, bwd, plain=None) -> FwdBwdResult:
    """The full stream mode's glue of a kernel pair: CPU tensors take the
    plain version (``plain``, default the precision's: the fast one for
    bfloat16 tiles); CUDA tensors run ``fwd``, the objective and ``bwd``
    (the signatures of :func:`fact_fwd` / :func:`fact_bwd`)."""
    debug = debug or get_verbose_level() >= 1
    _check_graph(fa)
    if not px.is_cuda:
        plain = plain or (forward_backward_prob_fast if is_fast(fa)
                          else forward_backward_prob_fact)
        res = plain(px, lengths, fa, leaky_coefficient)
        return res if debug else _frame0_traces(res)

    P = px.shape[2]
    lens = _card_lengths(px, lengths)
    px = px.float().contiguous()
    with torch.no_grad():
        ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad_last, ad0, s0 = \
            fwd(px, lens, fa, leaky_coefficient)
        objf, tot_prob = _objf(s_ys, ad_last, lens, fa, s0)
        gamma, ab, gs = bwd(lens, fa, leaky_coefficient, ad_ys, w1ad_ys,
                            xdst_ys, xsrc_ys, s_ys, ad0, s0,
                            tot_prob.contiguous(), P, debug=debug)
    return _package_result(objf, gamma, ab, gs)


def _mode_cluster(mode, px, fa, cluster):
    """The plan of each form of a call in ``mode`` (:func:`_plan` on px's
    card: the group form's (G, C) or the cluster size C; ``cluster``
    forces every form's): {form: C or (G, C)}."""
    props = _card_props(px.device)
    return {form: _form_plan(form, px.shape[0], props, fa, cluster)
            for form in MODE_FORMS[mode]}


def _lean(px, lens, fa, c, debug, stages, cluster=None):
    """The lean mode on the card: fact_fwd_snap's alpha' stream (snap 1),
    then fact_bwd_lean on it and px, each on ``cluster`` CTAs a column
    (default its :func:`cluster_size`)."""
    Cs = _mode_cluster("lean", px, fa, cluster)
    ad_ys, s_ys, ad_last, ad0, s0 = fact_fwd_snap(px, lens, fa, c, 1,
                                                  Cs["fact_fwd_snap"])
    objf, tot_prob = _objf(s_ys, ad_last, lens, fa, s0)
    return objf, fact_bwd_lean(lens, fa, c, ad_ys, px, s_ys, ad0, s0,
                               tot_prob.contiguous(), debug, stages,
                               Cs["fact_bwd_lean"])


def _ckpt(px, lens, fa, c, debug, stages, ckpt_chunk, cluster=None,
          paired=None):
    """The ckpt mode on the card (pallas_fact._forward_backward_ckpt):
    fact_fwd_snap keeps alpha' at each chunk's last frame, then from the
    last chunk down each chunk is replayed from the snapshot below it and
    its backward runs from the beta' carry above: alpha' rows for T / C
    snapshots and one chunk's three (four) streams, where the full mode
    keeps T.  Where :func:`ckpt_paired` says so the chunk scan is paired
    (:func:`fact_ckpt_pair` on :func:`pair_schedule`: chunk k's backward
    beside chunk k - 1's replay, the streams in two sets); else
    fact_fwd_init and fact_bwd_chunk run in turn, each on ``cluster`` CTAs
    a column (default its :func:`cluster_size`).  ``paired`` forces the
    choice (the tests and kernel_ablation.py compare the two)."""
    B, T, P = px.shape
    Cs = _mode_cluster("ckpt", px, fa, cluster)
    pair = ckpt_paired(B, _card_props(px.device), fa, cluster, paired,
                       stages)
    C = ckpt_chunk_length(T, ckpt_chunk)
    snaps, s_ys, ad_last, ad0, s0 = fact_fwd_snap(px, lens, fa, c, C,
                                                  Cs["fact_fwd_snap"])
    objf, tot_prob = _objf(s_ys, ad_last, lens, fa, s0)
    tot_prob = tot_prob.contiguous()
    outs = _outputs(B, T, P, px.device)
    carry = (_new(fa, px.device, B, fa.s_pad, dtype=torch.float32),
             _new(fa, px.device, B, dtype=torch.float32))
    n_streams = 3 if fa.xsrc_mode == "identity" else 4
    sets = [[_new(fa, px.device, B * C * fa.s_pad) for _ in range(n_streams)]
            for _ in range(2 if pair else 1)]
    # chunk 0 enters from alpha'(0) in the stream type (pallas_fact.py
    # :976-978)
    entry = ad0.to(stream_dtype(fa)).expand(B, fa.s_pad)

    def chunk(k):
        """Chunk k's first frame, alpha'(t0), s_{t0} and streams."""
        t0, n = k * C, min(C, T - k * C)
        streams = [buf[:B * n * fa.s_pad].view(B, n, fa.s_pad)
                   for buf in sets[k % len(sets)]] + [None] * (4 - n_streams)
        return (t0, entry if k == 0 else snaps[:, k - 1],
                s0.expand(B) if k == 0 else s_ys[:, t0 - 1], streams)

    n_chunks = snaps.shape[1]
    if pair:
        for kb, kf in pair_schedule(n_chunks):
            back = None
            if kb is not None:
                t0, ad_init, _, streams = chunk(kb)
                back = (t0, ad_init, streams)
            fact_ckpt_pair(px, lens, fa, c, None if kf is None else chunk(kf),
                           back, s_ys, ad0, s0, tot_prob, outs, carry, debug,
                           stages)
        return objf, outs
    for k in range(n_chunks - 1, -1, -1):
        t0, ad_init, s_init, streams = chunk(k)
        fact_fwd_init(px, lens, fa, c, t0, ad_init, s_init, streams,
                      Cs["fact_fwd_init"])
        fact_bwd_chunk(lens, fa, c, streams, s_ys, ad0, s0, tot_prob, t0,
                       ad_init, outs, carry, debug, stages,
                       Cs["fact_bwd_chunk"])
    return objf, outs


def forward_backward_prob_kernel(px, lengths, fa: FactorizedArrays,
                                 leaky_coefficient=1e-5,
                                 debug: bool = True,
                                 stream_mode: str = "auto",
                                 ckpt_chunk: int | None = None,
                                 stages: int | None = None,
                                 cluster: int | tuple | None = None
                                 ) -> FwdBwdResult:
    """Fused fwd+bwd on a fully-factorized graph (the resident tier,
    engine "pallas"), with forward_backward_prob_pallas's stream modes.

    px: (B, T, P) exp'd clamped nnet output (float32).  stream_mode:
    "full" (``fact_fwd`` emits W1 alpha' and the emission rows for
    ``fact_bwd``), "lean" (the alpha' stream alone; ``fact_bwd_lean``
    forms the rest from it and px: a third of the streams' memory),
    "ckpt" (alpha' at every ckpt_chunk-th frame, default about sqrt(T);
    each chunk replayed by ``fact_fwd_init`` before ``fact_bwd_chunk``:
    T / C + C alpha' rows, one more forward sweep) or "auto" (the
    cheapest whose streams fit the card's :func:`stream_budget`, on the
    CPU the JAX package's STREAM_BUDGET; :func:`resolve_stream_mode`).
    The fast forms run for a graph with bfloat16 tiles.  On the CPU this
    computes the plain version of the mode
    (``factorized.forward_backward_prob_mode``).  debug: with True the
    alpha*beta and sum-gamma traces cover every frame; with False only
    frame 0 (the reference's default, chain-computation.cc:337-338), the
    other frames reading exactly 1.0.  Verbose level >= 1 forces the full
    traces.  stages: the backward kernel's ring depth (default
    :func:`ring_stages`; the tests force each; the fast pair's group
    form has none).  cluster: the kernels' CTAs a column in every mode,
    or (G, C) for the fast full mode's group form (default each form's
    :func:`_plan`; the results do not depend on it)."""
    debug = debug or get_verbose_level() >= 1
    _check_graph(fa)
    B, T, _ = px.shape
    on_card = px.is_cuda
    mode = resolve_stream_mode(
        T, B, fa, stream_mode, ckpt_chunk,
        stream_budget(px.device) if on_card else STREAM_BUDGET, on_card)
    if not on_card:
        res = forward_backward_prob_mode(px, lengths, fa, leaky_coefficient,
                                         mode, ckpt_chunk)
        return res if debug else _frame0_traces(res)
    if mode == "lean":
        _require(fits_on_chip(fa, lean=True), f"stream mode 'lean': "
                 f"fact_bwd_lean needs {smem_bytes(fa, 0, lean=True)} bytes "
                 f"of shared memory per block at S_pad={fa.s_pad}, over the "
                 f"{MAX_SMEM} a Hopper block has (\"ckpt\" or \"full\" fit)")
    if mode == "full":
        Cs = _mode_cluster("full", px, fa, cluster)
        _require(stages is None or not isinstance(Cs["fact_bwd"], tuple),
                 f"fact_bwd's group form {Cs['fact_bwd']} has no ring "
                 f"(stages={stages})")
        return fused_fwd_bwd(
            px, lengths, fa, leaky_coefficient, debug,
            functools.partial(fact_fwd, cluster=Cs["fact_fwd"]),
            functools.partial(fact_bwd, stages=stages,
                              cluster=Cs["fact_bwd"]))
    lens = _card_lengths(px, lengths)
    px = px.float().contiguous()
    with torch.no_grad():
        if mode == "lean":
            objf, outs = _lean(px, lens, fa, leaky_coefficient, debug,
                               stages, cluster)
        else:
            objf, outs = _ckpt(px, lens, fa, leaky_coefficient, debug,
                               stages, ckpt_chunk, cluster)
    return _package_result(objf, *outs)
