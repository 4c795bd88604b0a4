"""Viterbi alignment on a hand-written CUDA kernel.

The port's counterpart of ``pychain_tpu/ops/viterbi.py::_pallas_sweep``
(B11).  On a TPU the max-plus sweep runs on a (B, T) grid over
VMEM-resident bf16 incidence masks with a (B, T, K) emission table built
outside; here one kernel, ``viterbi`` (``csrc/viterbi.cu``), runs one
block per sequence over the in-arc lists of the semiring engine's arc-id
form, reads and clamps ``x[b, t, pdf]`` itself (no emission table, no
clamped copy of x), writes int32 arc backpointers and then scores the
end state and walks the traceback in the same block.

The wrapper given CPU tensors computes the plain version
(``ops/viterbi.py``); given CUDA tensors it launches the kernel or
raises.  Each launch adds one to ``LAUNCHES["viterbi"]``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.device import host_to
from .fact_kernels import MAX_SMEM, _check, _ptr, _require, _stream
from .semiring import SemiringArrays
from .viterbi import ViterbiResult, viterbi_plain

LAUNCHES = {"viterbi": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes(s_pad: int) -> int:
    """Dynamic shared memory of the kernel: delta double-buffered in
    float32 (must equal viterbi_smem_bytes in the source)."""
    return 2 * s_pad * 4


def fits_on_chip(g: SemiringArrays) -> bool:
    """Whether the double-buffered delta fits one block's shared memory:
    S_pad <= MAX_SMEM / 8 = 29,056 states."""
    return smem_bytes(g.num_states) <= MAX_SMEM


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    from ..csrc import build
    fn = build.load("viterbi").viterbi_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 6 + [_P] * 4 + [_P]
        fn.restype = ctypes.c_int
    return fn


def viterbi_sweep(x, lengths, g: SemiringArrays):
    """Launch the kernel.  x (B, T, P) float32, lengths (B,) int32 in
    [0, T], g with B rows or one shared row, all on x's card.
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
        raise NotImplementedError(
            f"a Viterbi batch with S_pad={S} states needs "
            f"{smem_bytes(S)} bytes of shared memory per block for its "
            f"double-buffered scores, over the {MAX_SMEM} a Hopper block "
            "has (S_pad <= 29,056)")
    bp = torch.empty(B, T, S, dtype=torch.int32, device=x.device)
    objf = torch.empty(B, dtype=torch.float32, device=x.device)
    pdfs = torch.empty(B, T, dtype=torch.int32, device=x.device)
    states = torch.empty(B, T, dtype=torch.int32, device=x.device)
    rc = _lib()(
        _ptr(lengths), _ptr(x), _ptr(g.src), _ptr(g.pdf), _ptr(g.logp),
        _ptr(g.in_ptr), _ptr(g.in_arcs), _ptr(g.initial), _ptr(g.final),
        B, T, P, K, S, int(G == 1),
        _ptr(bp), _ptr(objf), _ptr(pdfs), _ptr(states), _stream())
    _check(rc, "viterbi")
    LAUNCHES["viterbi"] += 1
    return objf, pdfs, states


def viterbi_kernel(x, lengths, g: SemiringArrays) -> ViterbiResult:
    """Best paths of a batch.  x (B, T, P) log-likelihoods (clamped as
    read), lengths (B,) in [0, T].  On CUDA this launches ``viterbi``; on the
    CPU it computes the plain version."""
    if not x.is_cuda:
        return viterbi_plain(x, lengths, g)
    B, T, _ = x.shape
    # checked on a host copy: lengths given on the host cost no wait
    lens_host = torch.as_tensor(lengths).cpu().to(torch.int32)
    _require(bool(((lens_host >= 0) & (lens_host <= T)).all()),
             f"lengths must lie in [0, T={T}]")
    objf, pdfs, states = viterbi_sweep(
        x.float().contiguous(), host_to(lens_host.contiguous(), x.device), g)
    return ViterbiResult(objf=objf, pdfs=pdfs, states=states,
                         ok=torch.isfinite(objf))
