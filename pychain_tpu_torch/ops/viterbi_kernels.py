"""Viterbi alignment on a hand-written CUDA kernel.

The port's counterpart of ``pychain_tpu/ops/viterbi.py::_pallas_sweep``
(B11).  On a TPU the max-plus sweep runs on a (B, T) grid over
VMEM-resident bf16 incidence masks with a (B, T, K) emission table built
outside; here one kernel, ``viterbi`` (``csrc/viterbi.cu``), runs one
block per sequence over the in-lists of the semiring engine's arc-id
form (slot j of state s names arc ``in_arcs[in_ptr[s] + j]``), reads
and clamps ``x[b, t, pdf]`` itself (no emission table, no clamped copy
of x),
keeps the winner's position in its state's in-list as a one- or
two-byte backpointer, and then scores the end state and walks the
traceback in the same block.

:func:`plan` picks the block's layout from the shapes (:class:`Layout`):
L lanes a state, the slot lists resident in shared memory, a ring of x
rows fetched ahead by TMA and the backpointers in shared memory, each
where it fits beside those before it.

The wrapper given CPU tensors computes the plain version
(``ops/viterbi.py``); given CUDA tensors it launches the kernel or
raises.  Each launch adds one to ``LAUNCHES["viterbi"]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools

import torch

from ..utils.device import host_to
from .fact_kernels import MAX_SMEM, _check, _ptr, _require, _stream
from .semiring import SemiringArrays
from .viterbi import ViterbiResult, viterbi_plain

LAUNCHES = {"viterbi": 0}

MAX_THREADS = 1024
ARCS_A_LANE = 16      # plan(): lanes enough for this many arcs each
SCRATCH = 64          # VIT_SCRATCH in the source
STAGES = (4, 2)       # ring depths plan() tries, deepest first
# every (resident lists, ring stages, backpointers in shared memory)
# plan() can choose; the last needs only the double-buffered delta
CHOICES = tuple(itertools.product((True, False), STAGES + (0,),
                                  (True, False)))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class Layout:
    """The kernel's block: ``threads`` (a multiple of 32: the compute
    warps and, with a ring, its producer warp), ``lanes`` (L) a state;
    ``stages`` of x rows fetched ahead by TMA (0: x read from device
    memory); the slot lists ``resident`` in shared memory; backpointers
    of ``bp_width`` bytes held in shared memory (``bp_smem``) or in
    device memory."""
    threads: int
    lanes: int
    stages: int
    resident: bool
    bp_smem: bool
    bp_width: int


def bp_width(max_in_degree: int) -> int:
    """Bytes a backpointer (a position in an in-list) needs."""
    return 1 if max_in_degree <= 256 else 2 if max_in_degree <= 65536 else 4


def lanes_for(s_pad: int, max_in_degree: int, ring: bool = True) -> int:
    """L: a power of two with about ARCS_A_LANE arcs a lane at the
    largest in-degree, at most 32, and S_pad * L compute threads in a
    block (1024, less the producer warp with a ring) where L > 1."""
    want = 1
    while want < 32 and want * ARCS_A_LANE < max_in_degree:
        want *= 2
    while want > 1 and s_pad * want > MAX_THREADS - 32 * ring:
        want //= 2
    return want


def threads_for(s_pad: int, lanes: int, ring: bool = True) -> int:
    """The multiple of 32 compute threads that covers S_pad * L, and
    with a ring its producer warp: at most 1024 in all."""
    return min(MAX_THREADS - 32 * ring,
               max(32, _up(s_pad * lanes, 32))) + 32 * ring


def smem_bytes(s_pad: int, k_pad: int, T: int, P: int, stages: int,
               resident: bool, bp_smem: bool, width: int) -> int:
    """The kernel's dynamic shared memory (must equal viterbi_smem_bytes
    in the source): the x ring and its mbarriers, delta double-buffered
    (each buffer at least SCRATCH floats, the tail's scratch), resident
    the offsets, packed slots and log weights, and the backpointers
    where they are held."""
    n = stages * (4 * P + 8) + 8 * max(s_pad, SCRATCH)
    if resident:
        n += 4 * (s_pad + 1) + 8 * k_pad
    if bp_smem:
        n += T * s_pad * width
    return n


def layout_smem(lay: Layout, s_pad: int, k_pad: int, T: int, P: int) -> int:
    """smem_bytes of a layout at these shapes."""
    return smem_bytes(s_pad, k_pad, T, P, lay.stages, lay.resident,
                      lay.bp_smem, lay.bp_width)


def plan(s_pad: int, k_pad: int, P: int, max_in_degree: int,
         T: int) -> Layout:
    """The layout for a batch's shapes.  Beside the double-buffered
    delta, in this order, each where it fits what is left of a block's
    shared memory: the slot lists resident (their source and pdf packed
    into 16 bits each: P <= 65,536), a ring of the deepest of STAGES
    (16-byte rows: P a multiple of 4), the backpointers.  Raises
    NotImplementedError where the delta alone does not fit
    (S_pad > 29,056)."""
    width = bp_width(max_in_degree)
    room = MAX_SMEM - smem_bytes(s_pad, k_pad, T, P, 0, False, False, width)
    if room < 0:
        raise NotImplementedError(
            f"a Viterbi batch with S_pad={s_pad} states needs "
            f"{MAX_SMEM - room} bytes of shared memory per block for its "
            f"double-buffered scores, over the {MAX_SMEM} a Hopper block "
            "has (S_pad <= 29,056): viterbi_align(..., sweep='scatter') "
            "aligns such a batch on the plain version, and the loss on it "
            "runs with impl='gather'")
    lists = 4 * (s_pad + 1) + 8 * k_pad       # as smem_bytes counts them
    resident = P <= 1 << 16 and lists <= room
    room -= lists * resident
    stages = next((k for k in STAGES if P % 4 == 0
                   and k * (4 * P + 8) <= room), 0)
    room -= stages * (4 * P + 8)
    lanes = lanes_for(s_pad, max_in_degree, stages > 0)
    return Layout(threads_for(s_pad, lanes, stages > 0), lanes, stages,
                  resident, T * s_pad * width <= room, width)


def fits_on_chip(g: SemiringArrays) -> bool:
    """Whether the least layout (the double-buffered delta alone) fits
    one block's shared memory: S_pad <= MAX_SMEM / 8 = 29,056 states."""
    return smem_bytes(g.num_states, g.k_pad, 0, 0, 0, False, False,
                      1) <= MAX_SMEM


def plan_for(g: SemiringArrays, P: int, T: int) -> Layout:
    """The kernel's layout for this batch, P and T (:func:`plan`)."""
    return plan(g.num_states, g.k_pad, P, g.max_in_degree, T)


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from ..csrc import build
    fn = build.load("viterbi").viterbi_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 12 + [_P] * 4 + [_P]
        fn.restype = ctypes.c_int
    return fn


def viterbi_sweep(x, lengths, g: SemiringArrays, layout: Layout = None):
    """Launch the kernel.  x (B, T, P) float32, lengths (B,) int32 in
    [0, T], g with B rows or one shared row, all on x's card.
    ``layout`` forces a :class:`Layout` (default: the plan's; on x whose
    rows are not 16-byte aligned, no ring).
    Returns objf (B,) float32, pdfs and states (B, T) int32."""
    _require(x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
             and x.dim() == 3,
             "x must be a contiguous (B, T, P) float32 CUDA tensor")
    B, T, P = x.shape
    _require(lengths.device == x.device and lengths.dtype == torch.int32
             and lengths.shape == (B,),
             "lengths must be a (B,) int32 tensor on x's device")
    _require(g.rows in (1, B), f"graph arrays have {g.rows} rows, the "
             f"batch {B}")
    G, K, S = g.rows, g.k_pad, g.num_states
    for name, dtype, shape in (
            ("src", torch.int32, (G, K)), ("pdf", torch.int32, (G, K)),
            ("logp", torch.float32, (G, K)),
            ("in_ptr", torch.int32, (G, S + 1)),
            ("in_arcs", torch.int32, (G, K)),
            ("initial", torch.float32, (G, S)),
            ("final", torch.float32, (G, S))):
        t = getattr(g, name)
        _require(t.device == x.device and t.dtype == dtype
                 and t.is_contiguous() and tuple(t.shape) == shape,
                 f"graph array {name}: {t.dtype} {tuple(t.shape)} on "
                 f"{t.device}, want contiguous {dtype} {shape} on "
                 f"{x.device}")
    _require(g.n_pdfs <= P, f"graphs emit pdf {g.n_pdfs - 1} but x has "
             f"only {P} columns")
    if not fits_on_chip(g):
        plan(S, K, P, 0, 0)            # raises NotImplementedError
    lay = layout or plan_for(g, P, T)
    if lay.stages and x.data_ptr() % 16:
        lay = dataclasses.replace(lay, stages=0)
    _require(lay.threads % 32 == 0
             and 32 * (1 + (lay.stages > 0)) <= lay.threads <= MAX_THREADS
             and lay.lanes in (1, 2, 4, 8, 16, 32)
             and lay.bp_width >= bp_width(g.max_in_degree)
             and (lay.stages == 0 or (2 <= lay.stages <= 8 and P % 4 == 0))
             and layout_smem(lay, S, K, T, P) <= MAX_SMEM
             and not (lay.resident and P > 1 << 16),
             f"viterbi: layout {lay} has no kernel or does not fit a "
             "block")
    bp = None if lay.bp_smem else torch.empty(
        B, T, S, dtype={1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            lay.bp_width], device=x.device)
    objf = torch.empty(B, dtype=torch.float32, device=x.device)
    pdfs = torch.empty(B, T, dtype=torch.int32, device=x.device)
    states = torch.empty(B, T, dtype=torch.int32, device=x.device)
    rc = _lib()(
        _ptr(lengths), _ptr(x), _ptr(g.in_ptr), _ptr(g.in_arcs),
        _ptr(g.src), _ptr(g.pdf), _ptr(g.logp), _ptr(g.initial),
        _ptr(g.final), B, T, P, K, S, int(G == 1), lay.threads,
        lay.lanes.bit_length() - 1, lay.stages, int(lay.resident),
        int(lay.bp_smem), lay.bp_width,
        _ptr(bp), _ptr(objf), _ptr(pdfs), _ptr(states), _stream())
    _check(rc, "viterbi")
    LAUNCHES["viterbi"] += 1
    return objf, pdfs, states


def viterbi_kernel(x, lengths, g: SemiringArrays,
                   layout: Layout = None) -> ViterbiResult:
    """Best paths of a batch.  x (B, T, P) log-likelihoods (clamped as
    read), lengths (B,) in [0, T].  On CUDA this launches ``viterbi``
    (``layout`` forces one); on the CPU it computes the plain version."""
    if not x.is_cuda:
        return viterbi_plain(x, lengths, g)
    B, T, _ = x.shape
    # checked on a host copy: lengths given on the host cost no wait
    lens_host = torch.as_tensor(lengths).cpu().to(torch.int32)
    _require(bool(((lens_host >= 0) & (lens_host <= T)).all()),
             f"lengths must lie in [0, T={T}]")
    objf, pdfs, states = viterbi_sweep(
        x.float().contiguous(), host_to(lens_host.contiguous(), x.device), g,
        layout)
    return ViterbiResult(objf=objf, pdfs=pdfs, states=states,
                         ok=torch.isfinite(objf))
