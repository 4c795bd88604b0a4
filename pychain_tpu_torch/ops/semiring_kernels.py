"""The log-semiring forward-backward on hand-written CUDA kernels.

The port's counterpart of ``pychain_tpu/ops/pallas_semiring.py`` and
``pychain_tpu/ops/semiring_xl.py``.  Those hold three kernel pairs that
compute one recurrence and differ only in how TPU VMEM holds the arc
incidence: dense (K, S, 128) one-hots (B5/B6), per-graph resident
(S_pad, K_pad) masks (B7/B8), masks re-expanded per arc chunk (B9/B10).
On the card the arcs stay id lists with no mask and no budget, so one
pair serves all three:

* ``semiring_fwd`` (``csrc/semiring_fwd.cu``): the alpha sweep, one block
  per sequence, the unnormalised alpha in two parity buffers in shared
  memory (normalised by whoever reads it); writes the alpha stream, the
  raw sums and alpha at each sequence's last frame;
* ``semiring_bwd`` (``csrc/semiring_bwd.cu``): the beta sweep with its
  log-scale carry, the arc occupancies a thread an arc, the alpha*beta
  trace and gamma (B, T, P), summed over each graph's compact pdf list
  (only the pdfs it emits) in a fixed order: deterministic, no atomics.

Each kernel runs one barrier a frame and a block of the multiple of 32
threads that covers the graph (at most 1024).  :func:`plan` picks, from
the shapes, what else a block keeps in shared memory: the graph's lists
(``resident``), a ring of rows fetched ahead by TMA (``stages``) and,
for the backward sweep, gamma rows stored by TMA (``grows``); near the
shared-memory limit the backward sweep falls back to two barriers a
frame (``pipe`` off).  :func:`kernel_lists` builds the arrays the kernels
read beside the :class:`SemiringArrays` lists, once per batch.

The glue the JAX wrappers run outside ``pallas_call`` (arc weights,
``lz0``, the objective, the injection rows) is ``ops/semiring.py``'s
:func:`prepare` / :func:`objective`, in PyTorch.

A wrapper given CPU tensors computes its kernel's plain version
(``ops/semiring.py``); given CUDA tensors it launches the kernel or
raises.  Each launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import torch

from ..utils.device import host_to
from .fact_kernels import MAX_SMEM, _check, _ptr, _require, _stream
from .fwdbwd import FwdBwdResult
from .semiring import (SemiringArrays, forward_backward_semiring, objective,
                       package, prepare)

LAUNCHES = {"semiring_fwd": 0, "semiring_bwd": 0}

MAX_THREADS = 1024                    # FACT_THREADS in fact_common.cuh
# Row strides the kernels' bulk copies need (16 bytes): warc rows padded
# to a multiple of 4 floats, alpha-stream rows to 2 doubles, gamma rows
# to 4 floats.  prepare(row_align=WARC_ALIGN) gives warc so.
WARC_ALIGN, ALPHA_ALIGN, GAMMA_ALIGN = 4, 2, 4


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class Layout:
    """A kernel's block: its threads and what it keeps in shared memory.

    ``stages``: the depth of the ring of rows fetched ahead by TMA (0: the
    rows are read from device memory); ``resident``: the graph's lists
    copied into shared memory for the whole sweep; ``pipe`` (backward):
    one barrier a frame, the gamma stage a frame late; ``grows``
    (backward): gamma rows assembled in shared memory and stored by TMA.
    """
    threads: int
    stages: int
    resident: bool
    pipe: bool = True
    grows: bool = False


# Layouts in order of preference; plan() takes the first that fits.
FWD_LADDER = ((True, 4), (False, 4), (False, 2), (False, 0))
BWD_LADDER = ((True, 3, True, True), (True, 2, True, True),
              (False, 2, True, True), (False, 0, True, True),
              (False, 0, True, False), (False, 0, False, False))


def fwd_smem_bytes(s_pad: int, k_pad: int, stages: int,
                   resident: bool) -> int:
    """semiring_fwd's dynamic shared memory (must equal
    semiring_fwd_smem_bytes in the source): the ring's rows and
    mbarriers, two double state vectors, 2 x 32 warp slots and, resident,
    the in-lists (S_pad + 1 offsets, K_pad packed arcs)."""
    return (stages * (4 * _up(k_pad, WARC_ALIGN) + 8) + 16 * s_pad + 512
            + (4 * (s_pad + 1 + k_pad) if resident else 0))


def bwd_smem_bytes(s_pad: int, k_pad: int, P: int, n_emit: int,
                   stages: int, resident: bool, pipe: bool,
                   grows: bool) -> int:
    """semiring_bwd's dynamic shared memory (must equal
    semiring_bwd_smem_bytes in the source): the ring (a warc row and an
    alpha row a stage, and its mbarriers), two gamma rows, b's two
    double vectors, log alpha's two (pipe), one or two (pipe) occupancy
    buffers and warp slots and, resident, the out-lists and the compact
    pdf list (S_pad + 1 + 3 K_pad + 2 E + 1 ints)."""
    nb = 2 if pipe else 1
    return (stages * (4 * _up(k_pad, WARC_ALIGN)
                      + 8 * _up(s_pad, ALPHA_ALIGN) + 8)
            + (8 * _up(P, GAMMA_ALIGN) if grows else 0)
            + (32 if pipe else 16) * s_pad + nb * (8 * k_pad + 512)
            + (4 * (s_pad + 1 + 3 * k_pad + 2 * n_emit + 1)
               if resident else 0))


def threads_for(n: int) -> int:
    """The multiple of 32 threads that covers n rows, at most 1024."""
    return min(MAX_THREADS, max(32, _up(n, 32)))


def plan(s_pad: int, k_pad: int, P: int, n_emit: int) -> dict:
    """Each kernel's layout for a batch's shapes (E = ``n_emit``, the most
    pdfs a graph of the batch emits): the first of FWD_LADDER /
    BWD_LADDER whose shared memory fits a block.  Raises
    NotImplementedError past the last (2 S_pad + K_pad > 28,992)."""
    out = {}
    for (res, st) in FWD_LADDER:
        if fwd_smem_bytes(s_pad, k_pad, st, res) <= MAX_SMEM:
            out["semiring_fwd"] = Layout(threads_for(s_pad), st, res)
            break
    for (res, st, pipe, grows) in BWD_LADDER:
        if bwd_smem_bytes(s_pad, k_pad, P, n_emit, st, res, pipe,
                          grows) <= MAX_SMEM:
            out["semiring_bwd"] = Layout(threads_for(max(s_pad, k_pad)), st,
                                         res, pipe, grows)
            break
    if len(out) < 2:
        raise NotImplementedError(
            f"a semiring batch with S_pad={s_pad}, K_pad={k_pad} needs more "
            f"shared memory per block than the {MAX_SMEM} bytes a Hopper "
            "block has, in every layout (2 S_pad + K_pad <= 28,992 fits); "
            "kernels that stream the state vectors are not written yet "
            "(ROADMAP.md, B5-B10 limits): impl='gather' runs such a batch "
            "on the generic gather engine, impl='semiring' on the plain "
            "version")
    return out


def fits_on_chip(g: SemiringArrays) -> bool:
    """Whether both kernels run on this batch in some layout: their
    smallest working set (two double state vectors, and one double
    occupancy a padded arc in the backward sweep) fits one block's
    shared memory: 2 S_pad + K_pad <= MAX_SMEM / 8 - 64 = 28,992."""
    s, k = g.num_states, g.k_pad
    return (fwd_smem_bytes(s, k, 0, False) <= MAX_SMEM
            and bwd_smem_bytes(s, k, 0, 0, 0, False, False, False)
            <= MAX_SMEM)


@dataclasses.dataclass(eq=False)
class KernelLists:
    """The arrays the kernels read beside a batch's lists (same device):
    ``in_pack`` (B, K_pad) the in-lists' slots as src << 16 | arc;
    ``out_sd`` (B, K_pad) the out-lists' slots as src << 16 | dst; the
    compact pdf list: ``emit_pdf`` (B, E) the pdfs a graph emits,
    ascending, ``emit_ptr`` (B, E + 1) their lists' offsets in
    ``pdf_arcs`` (arc ids ascending), ``n_emit`` (B,) how many; E the
    most in the batch.  Ids fit 16 bits on every batch that fits on
    chip (S_pad < 14,500, K_pad < 29,000)."""
    in_pack: torch.Tensor
    out_sd: torch.Tensor
    emit_pdf: torch.Tensor
    emit_ptr: torch.Tensor
    n_emit: torch.Tensor
    E: int


_kernel_lists = weakref.WeakKeyDictionary()


def kernel_lists(g: SemiringArrays) -> KernelLists:
    """The batch's :class:`KernelLists`, built once (on its device) and
    kept while the batch lives."""
    kl = _kernel_lists.get(g)
    if kl is None:
        src, dst = g.src.long(), g.dst.long()
        in_arcs = g.in_arcs.long()
        in_pack = (src.gather(1, in_arcs) << 16) | in_arcs
        out_sd = ((src << 16) | dst).gather(1, g.out_arcs.long())
        ptr = g.pdf_ptr.long()
        emitted = ptr[:, 1:] > ptr[:, :-1]
        n_emit = emitted.sum(dim=1)
        E = max(1, int(n_emit.max()))
        # the emitted pdfs first, ascending (a stable sort of 0/1 keys)
        order = torch.sort((~emitted).to(torch.int8), dim=1,
                           stable=True).indices[:, :E]
        total = ptr[:, -1:]
        e = torch.arange(E + 1, device=ptr.device)[None, :]
        starts = torch.cat([ptr.gather(1, order), total], dim=1)
        emit_ptr = torch.where(e < n_emit[:, None], starts, total)
        kl = KernelLists(*(t.to(torch.int32).contiguous() for t in
                           (in_pack, out_sd, order, emit_ptr, n_emit)), E)
        _kernel_lists[g] = kl
    return kl


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(name):
    from ..csrc import build
    fn = getattr(build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = {"semiring_fwd": [_P] * 5 + [_I] * 9 + [_P] * 3,
                       "semiring_bwd": [_P] * 15 + [_I] * 14 + [_P] * 2}[
            name] + [_P]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(warc, lengths, g: SemiringArrays):
    _require(warc.is_cuda and warc.dtype == torch.float32
             and warc.dim() == 3 and warc.stride(2) == 1,
             "warc must be a (B, T, K_pad) float32 CUDA tensor with unit "
             "stride over arcs")
    B, _, K = warc.shape
    _require(lengths.is_cuda and lengths.dtype == torch.int32
             and lengths.shape == (B,),
             "lengths must be a (B,) int32 CUDA tensor")
    S = g.num_states
    for name, shape in (("src", (B, K)), ("dst", (B, K)),
                        ("in_ptr", (B, S + 1)), ("in_arcs", (B, K)),
                        ("out_ptr", (B, S + 1)), ("out_arcs", (B, K)),
                        ("pdf_ptr", (B, g.n_pdfs + 1)), ("pdf_arcs", (B, K))):
        t = getattr(g, name)
        _require(t.device == warc.device and t.dtype == torch.int32
                 and t.is_contiguous() and tuple(t.shape) == shape,
                 f"graph array {name}: {t.dtype} {tuple(t.shape)} on "
                 f"{t.device}, want contiguous int32 {shape} on "
                 f"{warc.device}")
    if not fits_on_chip(g):
        plan(S, K, 0, 0)           # raises NotImplementedError


def _rows(t, align):
    """t (B, T, n) with its rows at a stride that is a multiple of
    ``align`` elements (a view of padded storage, as the kernels' bulk
    copies need): t itself where it already is, else a padded copy."""
    B, T, n = t.shape
    w = _up(n, align)
    if t.stride() == (T * w, w, 1):
        return t, w
    out = _padded(B, T, n, align, t.dtype, t.device)
    out.copy_(t)
    return out, w


def _padded(B, T, n, align, dtype, device, zero=False):
    """An empty (or zeroed) (B, T, n) view of storage whose rows are
    padded to a multiple of ``align`` elements."""
    new = torch.zeros if zero else torch.empty
    return new(B, T, _up(n, align), dtype=dtype, device=device)[:, :, :n]


def _require_cuda(name, t, shape, dtype=torch.float64):
    _require(t.is_cuda and t.dtype == dtype and t.is_contiguous()
             and tuple(t.shape) == shape,
             f"{name} must be a contiguous {dtype} CUDA tensor of shape "
             f"{shape}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def layouts(g: SemiringArrays, P: int) -> dict:
    """The kernels' layouts for this batch and P (:func:`plan`)."""
    return plan(g.num_states, g.k_pad, P, kernel_lists(g).E)


def semiring_fwd(warc, n0, lengths, g: SemiringArrays, layout=None):
    """Launch the alpha sweep.  warc (B, T, K_pad) float32 (rows at a
    stride of a multiple of 4 floats, as prepare(row_align=WARC_ALIGN)
    gives them, else copied so), n0 (B, S_pad) float64, lengths (B,)
    int32 in [1, T].  ``layout`` forces a :class:`Layout` (default: the
    plan's).  Returns, float64: n_ys (B, T, S_pad), alpha after frame t,
    written for t < T_b (a view of rows padded to 2 doubles); raw (B, T),
    1.0 past T_b; n_last (B, S_pad), alpha(T_b)."""
    _check_cuda_inputs(warc, lengths, g)
    B, T, K = warc.shape
    S = g.num_states
    _require_cuda("n0", n0, (B, S))
    lay = layout or plan(S, K, 0, 0)["semiring_fwd"]
    _require(fwd_smem_bytes(S, K, lay.stages, lay.resident) <= MAX_SMEM,
             f"semiring_fwd: layout {lay} does not fit a block")
    warc, kw = _rows(warc, WARC_ALIGN)
    n_ys = _padded(B, T, S, ALPHA_ALIGN, torch.float64, warc.device)
    raw = torch.empty(B, T, dtype=torch.float64, device=warc.device)
    n_last = torch.empty(B, S, dtype=torch.float64, device=warc.device)
    kl = kernel_lists(g)
    rc = _lib("semiring_fwd")(
        _ptr(lengths), _ptr(warc), _ptr(n0), _ptr(g.in_ptr),
        _ptr(kl.in_pack), B, T, K, kw, S, n_ys.stride(1), lay.threads,
        lay.stages, int(lay.resident), _ptr(n_ys), _ptr(raw), _ptr(n_last),
        _stream())
    _check(rc, "semiring_fwd")
    LAUNCHES["semiring_fwd"] += 1
    return n_ys, raw, n_last


def semiring_bwd(warc, n_ys, n0, lengths, rf, mf, c_row, cms,
                 g: SemiringArrays, P: int, layout=None):
    """Launch the beta sweep on the forward's alpha stream (float64, as
    are n0 and the rows of :func:`objective`; n_ys as semiring_fwd gives
    it, else copied to padded rows).  ``layout`` forces a
    :class:`Layout`.  Returns float32 (gamma (B, T, P), alpha_beta
    (B, T)), exact zeros past each T_b; gamma is a view of rows padded
    to 4 floats."""
    _check_cuda_inputs(warc, lengths, g)
    B, T, K = warc.shape
    S = g.num_states
    _require(n_ys.is_cuda and n_ys.dtype == torch.float64
             and tuple(n_ys.shape) == (B, T, S) and n_ys.stride(2) == 1,
             f"n_ys must be a (B, T, S_pad) float64 CUDA tensor, got "
             f"{n_ys.dtype} {tuple(n_ys.shape)} on {n_ys.device}")
    for name, t, shape in (("n0", n0, (B, S)),
                           ("rf", rf, (B, S)), ("mf", mf, (B,)),
                           ("c_row", c_row, (B, T)), ("cms", cms, (B, T))):
        _require_cuda(name, t, shape)
    _require(g.n_pdfs <= P, f"graphs emit pdf {g.n_pdfs - 1} but x has "
             f"only {P} columns")
    kl = kernel_lists(g)
    lay = layout or plan(S, K, P, kl.E)["semiring_bwd"]
    _require(bwd_smem_bytes(S, K, P, kl.E, lay.stages, lay.resident,
                            lay.pipe, lay.grows) <= MAX_SMEM
             and (lay.pipe or not (lay.stages or lay.resident
                                   or lay.grows)),
             f"semiring_bwd: layout {lay} does not fit a block or has no "
             "kernel")
    warc, kw = _rows(warc, WARC_ALIGN)
    n_ys, sw = _rows(n_ys, ALPHA_ALIGN)
    # without gamma rows the kernel stores only the emitted pdfs
    gamma = _padded(B, T, P, GAMMA_ALIGN, torch.float32, warc.device,
                    zero=not lay.grows)
    ab = torch.empty(B, T, dtype=torch.float32, device=warc.device)
    rc = _lib("semiring_bwd")(
        _ptr(lengths), _ptr(warc), _ptr(n_ys), _ptr(n0), _ptr(g.out_ptr),
        _ptr(g.out_arcs), _ptr(kl.out_sd), _ptr(kl.emit_pdf),
        _ptr(kl.emit_ptr), _ptr(kl.n_emit), _ptr(g.pdf_arcs), _ptr(rf),
        _ptr(mf), _ptr(c_row), _ptr(cms), B, T, K, kw, S, sw, P,
        gamma.stride(1), kl.E, lay.threads, lay.stages, int(lay.resident),
        int(lay.pipe), int(lay.grows), _ptr(gamma), _ptr(ab), _stream())
    _check(rc, "semiring_bwd")
    LAUNCHES["semiring_bwd"] += 1
    return gamma, ab


def forward_backward_semiring_kernel(x, lengths,
                                     g: SemiringArrays) -> FwdBwdResult:
    """Fused log-domain fwd+bwd of a list batch.  x (B, T, P) clamped
    log-likelihoods.  On CUDA this launches ``semiring_fwd`` then
    ``semiring_bwd``; on the CPU it computes the plain version."""
    if not x.is_cuda:
        return forward_backward_semiring(x, lengths, g)
    B, T, P = x.shape
    # checked on a host copy: lengths given on the host cost no wait
    lens_host = torch.as_tensor(lengths).cpu().to(torch.int32)
    _require(bool(((lens_host >= 1) & (lens_host <= T)).all()),
             f"lengths must lie in [1, T={T}]")
    lens = host_to(lens_host.contiguous(), x.device)
    with torch.no_grad():
        warc, c, n0, lz0 = prepare(x.float(), g, row_align=WARC_ALIGN)
        n_ys, raw, n_last = semiring_fwd(warc, n0, lens, g)
        objf, rf, mf, c_row, cms = objective(raw, n_last, c, lz0, lens, g)
        gamma, ab = semiring_bwd(warc, n_ys, n0, lens, rf, mf, c_row, cms,
                                 g, P)
    return package(objf, gamma, ab)
