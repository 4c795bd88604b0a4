"""The log-semiring forward-backward on hand-written CUDA kernels.

The port's counterpart of ``pychain_tpu/ops/pallas_semiring.py`` and
``pychain_tpu/ops/semiring_xl.py``.  Those hold three kernel pairs that
compute one recurrence and differ only in how TPU VMEM holds the arc
incidence: dense (K, S, 128) one-hots (B5/B6), per-graph resident
(S_pad, K_pad) masks (B7/B8), masks re-expanded per arc chunk (B9/B10).
On the card the arcs stay id lists with no mask and no budget, so one
pair serves all three:

* ``semiring_fwd`` (``csrc/semiring_fwd.cu``): the alpha sweep, one block
  per sequence, alpha normalised to sum 1 in shared memory; writes the
  alpha stream, the raw sums and alpha at each sequence's last frame;
* ``semiring_bwd`` (``csrc/semiring_bwd.cu``): the beta sweep with its
  log-scale carry, arc occupancies in shared memory, the alpha*beta
  trace and gamma (B, T, P), summed over per-graph pdf lists in a fixed
  order: deterministic, no atomics.

The glue the JAX wrappers run outside ``pallas_call`` (arc weights,
``lz0``, the objective, the injection rows) is ``ops/semiring.py``'s
:func:`prepare` / :func:`objective`, in PyTorch.

A wrapper given CPU tensors computes its kernel's plain version
(``ops/semiring.py``); given CUDA tensors it launches the kernel or
raises.  Each launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.device import host_to
from .fact_kernels import MAX_SMEM, FACT_WARPS, _check, _ptr, _require, \
    _stream
from .fwdbwd import FwdBwdResult
from .semiring import (SemiringArrays, forward_backward_semiring, objective,
                       package, prepare)

LAUNCHES = {"semiring_fwd": 0, "semiring_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def smem_bytes(s_pad: int, k_pad: int) -> dict:
    """Dynamic shared memory of each kernel (must equal
    semiring_fwd_smem_bytes / semiring_bwd_smem_bytes in the sources)."""
    return {"semiring_fwd": (2 * s_pad + FACT_WARPS + 1) * 8,
            "semiring_bwd": (2 * s_pad + k_pad + 2 * FACT_WARPS + 2) * 8}


def fits_on_chip(g: SemiringArrays) -> bool:
    """Whether both kernels' per-sequence working set (two state vectors,
    and the arc occupancies in the backward sweep, in double) fits one
    block's shared memory: 2 S_pad + K_pad <= MAX_SMEM / 8 - 66 =
    28,990."""
    return max(smem_bytes(g.num_states, g.k_pad).values()) <= MAX_SMEM


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(name):
    from ..csrc import build
    fn = getattr(build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = {"semiring_fwd": [_P] * 6 + [_I] * 4 + [_P] * 3,
                       "semiring_bwd": [_P] * 13 + [_I] * 6 + [_P] * 2}[
            name] + [_P]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_inputs(warc, lengths, g: SemiringArrays):
    _require(warc.is_cuda and warc.dtype == torch.float32
             and warc.is_contiguous() and warc.dim() == 3,
             "warc must be a contiguous (B, T, K_pad) float32 CUDA tensor")
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
        raise NotImplementedError(
            f"a semiring batch with S_pad={g.num_states}, K_pad={g.k_pad} "
            f"needs {smem_bytes(g.num_states, g.k_pad)} bytes of shared "
            f"memory per block, over the {MAX_SMEM} a Hopper block has; "
            "kernels that stream the state vectors are not written yet "
            "(ROADMAP.md, B5-B10 limits)")


def _require_cuda(name, t, shape, dtype=torch.float64):
    _require(t.is_cuda and t.dtype == dtype and t.is_contiguous()
             and tuple(t.shape) == shape,
             f"{name} must be a contiguous {dtype} CUDA tensor of shape "
             f"{shape}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def semiring_fwd(warc, n0, lengths, g: SemiringArrays):
    """Launch the alpha sweep.  warc (B, T, K_pad) float32, n0 (B, S_pad)
    float64, lengths (B,) int32 in [1, T].  Returns, float64: n_ys
    (B, T, S_pad), alpha after frame t, written for t < T_b; raw (B, T),
    1.0 past T_b; n_last (B, S_pad), alpha(T_b)."""
    _check_cuda_inputs(warc, lengths, g)
    B, T, K = warc.shape
    S = g.num_states
    _require_cuda("n0", n0, (B, S))
    new = lambda *shape: torch.empty(shape, dtype=torch.float64,
                                     device=warc.device)
    n_ys, raw, n_last = new(B, T, S), new(B, T), new(B, S)
    rc = _lib("semiring_fwd")(
        _ptr(lengths), _ptr(warc), _ptr(n0), _ptr(g.src), _ptr(g.in_ptr),
        _ptr(g.in_arcs), B, T, K, S, _ptr(n_ys), _ptr(raw), _ptr(n_last),
        _stream())
    _check(rc, "semiring_fwd")
    LAUNCHES["semiring_fwd"] += 1
    return n_ys, raw, n_last


def semiring_bwd(warc, n_ys, n0, lengths, rf, mf, c_row, cms,
                 g: SemiringArrays, P: int):
    """Launch the beta sweep on the forward's alpha stream (float64, as
    are n0 and the rows of :func:`objective`).  Returns float32 (gamma
    (B, T, P), alpha_beta (B, T)), exact zeros past each T_b."""
    _check_cuda_inputs(warc, lengths, g)
    B, T, K = warc.shape
    S = g.num_states
    for name, t, shape in (("n_ys", n_ys, (B, T, S)), ("n0", n0, (B, S)),
                           ("rf", rf, (B, S)), ("mf", mf, (B,)),
                           ("c_row", c_row, (B, T)), ("cms", cms, (B, T))):
        _require_cuda(name, t, shape)
    _require(g.n_pdfs <= P, f"graphs emit pdf {g.n_pdfs - 1} but x has "
             f"only {P} columns")
    gamma = torch.empty(B, T, P, dtype=torch.float32, device=warc.device)
    ab = torch.empty(B, T, dtype=torch.float32, device=warc.device)
    rc = _lib("semiring_bwd")(
        _ptr(lengths), _ptr(warc), _ptr(n_ys), _ptr(n0), _ptr(g.dst),
        _ptr(g.out_ptr), _ptr(g.out_arcs), _ptr(g.pdf_ptr),
        _ptr(g.pdf_arcs), _ptr(rf), _ptr(mf), _ptr(c_row), _ptr(cms),
        g.n_pdfs, B, T, K, S, P, _ptr(gamma), _ptr(ab),
        _stream())
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
        warc, c, n0, lz0 = prepare(x.float(), g)
        n_ys, raw, n_last = semiring_fwd(warc, n0, lens, g)
        objf, rf, mf, c_row, cms = objective(raw, n_last, c, lz0, lens, g)
        gamma, ab = semiring_bwd(warc, n_ys, n0, lens, rf, mf, c_row, cms,
                                 g, P)
    return package(objf, gamma, ab)
