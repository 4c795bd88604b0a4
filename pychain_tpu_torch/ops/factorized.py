"""Plain PyTorch forward-backward on the factorized denominator graph.

The port's counterpart of ``pychain_tpu/ops/factorized.py``: the same
recurrences (the reference's "version 3" equations,
chain-computation.h:109-155) on the stratified form built by
``graphs/factorize.py`` (each transition matrix = diagonal + one dense
block + 128x128 tiles), written as eager float32 PyTorch with a Python
loop over frames.  Layout is state-major (S_pad, B) per frame, as in the
JAX engine, so the two compare step for step.

This is the PLAIN VERSION of the two CUDA kernels of
``ops/fact_kernels.py``: the CPU path of their wrapper, and what
``chip_smoke.py`` holds them against on the card.  It is not fast: each
frame launches a handful of small PyTorch operations.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.device import host_to
from .fwdbwd import FwdBwdResult, _ok_flags

TILE = 128


def _move(obj, device):
    """A copy of a dataclass of tensors with every tensor on ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _move(v, device)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass(eq=False)
class WArrays:
    """One stratified matrix as tensors (square W or rectangular E).

    ``rows``/``cols`` are the tiles' block coordinates (int64)."""
    diag: Optional[torch.Tensor]    # (S_pad,) or None (rectangular)
    dense: Optional[torch.Tensor]   # (R, C) or None
    tiles: torch.Tensor             # (n, 128, 128)
    rows: torch.Tensor              # (n,)
    cols: torch.Tensor              # (n,)
    dense_r0: int
    dense_c0: int
    out_rows: int

    def to(self, device) -> "WArrays":
        return _move(self, device)

    @property
    def operand_dtype(self) -> torch.dtype:
        return self.dense.dtype if self.dense is not None else \
            self.tiles.dtype


@dataclasses.dataclass(eq=False)
class FactorizedArrays:
    """The factorized denominator graph (shared across the batch) as
    tensors.  State vectors are permuted and padded to S_pad."""
    w1: WArrays
    f_dst: torch.Tensor   # (S_pad,) pdf id feeding each state's W1 term
    e_f: WArrays          # one-hot (S_pad, P_pad): x_dst = E_f @ x_t
    w2: WArrays
    g_src: torch.Tensor
    e_g: WArrays
    w1t: WArrays          # transposed orientations for the beta sweep
    w2t: WArrays
    e_ft: WArrays         # gamma scatter: E_f^T @ c
    e_gt: WArrays
    initial: torch.Tensor  # (S_pad,)
    final: torch.Tensor
    leaky: torch.Tensor
    # residual arcs (generic gather path); zero-length for HMM topologies
    res_src: torch.Tensor
    res_dst: torch.Tensor
    res_pdf: torch.Tensor
    res_prob: torch.Tensor
    # which engine runs this graph (the JAX package's names): "xla" the
    # plain version below, "pallas" the resident kernels B1/B2
    # (ops/fact_kernels.py), "stream" the cluster kernels B3/B4
    # (ops/stream_kernels.py)
    engine: str = "xla"
    # "identity": g == f on W2's support, so x_src = x_dst;
    # "matrix"/"stream": x_src = E_g @ px (see graphs/factorize.py)
    xsrc_mode: str = "stream"

    @property
    def s_pad(self) -> int:
        return int(self.initial.shape[0])

    @property
    def p_pad(self) -> int:
        return self.e_ft.out_rows

    @property
    def device(self) -> torch.device:
        return self.initial.device

    def to(self, device) -> "FactorizedArrays":
        return _move(self, device)


def _w_arrays(parts, td, out_rows) -> WArrays:
    return WArrays(
        diag=None if parts.diag is None else torch.as_tensor(
            np.asarray(parts.diag, np.float32)),
        dense=None if parts.dense is None else torch.as_tensor(
            np.asarray(parts.dense, np.float32)).to(td),
        tiles=torch.as_tensor(np.asarray(parts.tiles, np.float32)).to(td),
        rows=torch.as_tensor(np.asarray(parts.rows, np.int64)),
        cols=torch.as_tensor(np.asarray(parts.cols, np.int64)),
        dense_r0=int(parts.dense_r0),
        dense_c0=int(parts.dense_c0),
        out_rows=int(out_rows),
    )


def _transpose_parts(parts):
    from ..graphs.factorize import WParts
    t = np.transpose(parts.tiles, (0, 2, 1))
    r, c = parts.cols, parts.rows
    order = np.argsort(r, kind="stable")
    return WParts(
        diag=parts.diag,
        dense=None if parts.dense is None else parts.dense.T.copy(),
        dense_r0=parts.dense_c0, dense_c0=parts.dense_r0,
        tiles=t[order], rows=r[order], cols=c[order])


def _tile_dtype(tile_dtype) -> torch.dtype:
    if tile_dtype is None:
        return torch.float32
    if isinstance(tile_dtype, torch.dtype):
        return tile_dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        str(tile_dtype)]


def from_factorized_graph(fg, initial, final, leaky,
                          tile_dtype=None) -> FactorizedArrays:
    """CPU tensors from a host FactorizedGraph + the graph's
    (un-permuted) initial/final/leaky state vectors.

    tile_dtype: float32 (default, parity grade) or bfloat16 (the
    reference's fast mode: transition operands rounded to bfloat16,
    float32 accumulation).  The CUDA kernels take float32 only."""
    from ..graphs.factorize import permute_state_vector

    td = _tile_dtype(tile_dtype)
    one = torch.float32  # E matrices are one-hot; keep them exact

    def vec(v):
        return torch.as_tensor(np.asarray(v))

    return FactorizedArrays(
        w1=_w_arrays(fg.w1, td, fg.s_pad),
        f_dst=vec(fg.f_dst).long(),
        e_f=_w_arrays(fg.e_f, one, fg.s_pad),
        w2=_w_arrays(fg.w2, td, fg.s_pad),
        g_src=vec(fg.g_src).long(),
        e_g=_w_arrays(fg.e_g, one, fg.s_pad),
        w1t=_w_arrays(_transpose_parts(fg.w1), td, fg.s_pad),
        w2t=_w_arrays(_transpose_parts(fg.w2), td, fg.s_pad),
        e_ft=_w_arrays(_transpose_parts(fg.e_f), one, fg.p_pad),
        e_gt=_w_arrays(_transpose_parts(fg.e_g), one, fg.p_pad),
        initial=vec(permute_state_vector(fg, initial)),
        final=vec(permute_state_vector(fg, final)),
        leaky=vec(permute_state_vector(fg, leaky)),
        res_src=vec(fg.res_src).long(), res_dst=vec(fg.res_dst).long(),
        res_pdf=vec(fg.res_pdf).long(), res_prob=vec(fg.res_prob),
        xsrc_mode=fg.xsrc_mode,
    )


@contextlib.contextmanager
def _full_f32():
    """float32 products in full float32: no TF32 on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _operand(w: WArrays, v):
    """v as the matrix operand: with bfloat16 tiles, rounded to
    bfloat16 like the JAX engine's operand cast; the product itself
    accumulates in float32."""
    if w.operand_dtype == torch.bfloat16:
        return v.to(torch.bfloat16).float()
    return v


def _apply_w(w: WArrays, v):
    """W @ v for v (C_total, B) -> (w.out_rows, B):
    diagonal + dense block + sparse tiles."""
    c_total, B = v.shape
    if w.diag is not None:
        out = w.diag[:, None] * v
    else:
        out = torch.zeros((w.out_rows, B), dtype=torch.float32,
                          device=v.device)
    if w.dense is not None:
        R, C = w.dense.shape
        blk = w.dense.float() @ _operand(w, v[w.dense_c0:w.dense_c0 + C])
        out[w.dense_r0:w.dense_r0 + R] += blk
    if w.tiles.shape[0] > 0:
        vt = _operand(w, v).reshape(c_total // TILE, TILE, B)
        prod = torch.bmm(w.tiles.float(), vt[w.cols])      # (n, 128, B)
        acc = torch.zeros((w.out_rows // TILE, TILE, B),
                          dtype=torch.float32, device=v.device)
        acc.index_add_(0, w.rows, prod)
        out = out + acc.reshape(w.out_rows, B)
    return out


def _residual_fwd(fa: FactorizedArrays, ad, x_t):
    """Generic gather-path term for residual arcs (usually empty)."""
    if fa.res_src.shape[0] == 0:
        return 0.0
    w = ad[fa.res_src] * fa.res_prob[:, None] * x_t[fa.res_pdf]
    out = torch.zeros_like(ad)
    return out.index_add_(0, fa.res_dst, w)


def forward_prob_fact(px_tm, lengths, fa: FactorizedArrays,
                      leaky_coefficient):
    """Alpha sweep.  px_tm: (T, P, B) exp'd nnet output, time-major,
    pdf-major.  Returns (alpha_dash (T+1, S_pad, B), alpha_sums (T+1, B),
    objf (B,), tot_prob (B,))."""
    T, P, B = px_tm.shape
    s_pad = fa.s_pad
    leaky = fa.leaky[:, None]

    alpha0 = fa.initial[:, None].expand(s_pad, B)
    s0 = alpha0.sum(dim=0)
    ad0 = alpha0 + leaky_coefficient * s0[None, :] * leaky

    ad_prev, s_prev, ad_last = ad0, s0, ad0
    loglike = torch.log(s0)
    ad_ys, s_ys = [ad0], [s0]
    for t in range(1, T + 1):
        px_t = px_tm[t - 1]
        x_dst = _apply_w(fa.e_f, px_t)                    # (S_pad, B)
        # identity mode: g == f on W2's support, and W2 zeroes the
        # off-support columns, so x_dst serves as x_src
        x_src = (x_dst if fa.xsrc_mode == "identity"
                 else _apply_w(fa.e_g, px_t))
        a = x_dst * _apply_w(fa.w1, ad_prev)
        a = a + _apply_w(fa.w2, x_src * ad_prev)
        a = a + _residual_fwd(fa, ad_prev, px_t)
        a = a / s_prev[None, :]
        s_t = a.sum(dim=0)
        ad_t = a + leaky_coefficient * s_t[None, :] * leaky
        active = t <= lengths
        loglike = loglike + torch.where(
            t < lengths, torch.log(torch.where(s_t > 0, s_t, 1.0)), 0.0)
        ad_prev = torch.where(active[None, :], ad_t, ad_prev)
        s_prev = torch.where(active, s_t, s_prev)
        ad_last = torch.where((t == lengths)[None, :], ad_prev, ad_last)
        ad_ys.append(ad_prev)
        s_ys.append(s_prev)

    alpha_dash = torch.stack(ad_ys, dim=0)
    alpha_sums = torch.stack(s_ys, dim=0)
    tot_prob = (ad_last * fa.final[:, None]).sum(dim=0)
    objf = loglike + torch.log(tot_prob)
    return alpha_dash, alpha_sums, objf, tot_prob


def backward_prob_fact(px_tm, lengths, fa: FactorizedArrays,
                       leaky_coefficient, alpha_dash, alpha_sums, tot_prob):
    """Beta sweep + posteriors.  Returns (gamma (T, P_pad, B),
    alpha_beta (B, T), gamma_sum (B, T))."""
    T, P, B = px_tm.shape
    s_pad = fa.s_pad
    leaky = fa.leaky[:, None]
    bd_final = fa.final[:, None] / tot_prob[None, :]

    bd_next = torch.zeros((s_pad, B), dtype=px_tm.dtype,
                          device=px_tm.device)
    gammas, abs_, gss = [None] * T, [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        px_t, ad_t, s_t = px_tm[t], alpha_dash[t], alpha_sums[t]
        inject = lengths == t + 1
        bd_eff = torch.where(inject[None, :], bd_final, bd_next)
        b_next = bd_eff + leaky_coefficient * (
            (bd_eff * leaky).sum(dim=0, keepdim=True))
        x_dst = _apply_w(fa.e_f, px_t)
        x_src = (x_dst if fa.xsrc_mode == "identity"
                 else _apply_w(fa.e_g, px_t))
        inv_s = 1.0 / s_t[None, :]

        xb = x_dst * b_next                                 # (S_pad, B)
        w1t_term = _apply_w(fa.w1t, xb)
        w2t_term = _apply_w(fa.w2t, b_next)
        bd_t = (w1t_term + x_src * w2t_term) * inv_s

        # posteriors: pdf-attachment scatters as transposed E products;
        # in identity mode one E_f^T scatter of the combined mass
        w1_fwd = _apply_w(fa.w1, ad_t)
        c1 = xb * w1_fwd * inv_s                            # per-dst mass
        c2 = x_src * ad_t * w2t_term * inv_s                # per-src mass
        if fa.xsrc_mode == "identity":
            gamma_t = _apply_w(fa.e_ft, c1 + c2)
        else:
            gamma_t = _apply_w(fa.e_ft, c1) + _apply_w(fa.e_gt, c2)

        if fa.res_src.shape[0] > 0:
            vf = fa.res_prob[:, None] * b_next[fa.res_dst] \
                * px_t[fa.res_pdf]
            bd_t = bd_t + torch.zeros_like(bd_t).index_add_(
                0, fa.res_src, vf) * inv_s
            occ = ad_t[fa.res_src] * inv_s
            gamma_t = gamma_t + torch.zeros_like(gamma_t).index_add_(
                0, fa.res_pdf, vf * occ)

        active = t < lengths
        bd_next = torch.where(active[None, :], bd_t, bd_eff)
        gamma_t = torch.where(active[None, :], gamma_t, 0.0)
        abs_[t] = (ad_t * bd_next).sum(dim=0)
        gss[t] = gamma_t.sum(dim=0)
        gammas[t] = gamma_t
    gamma_tm = torch.stack(gammas, dim=0)                   # (T, P_pad, B)
    alpha_beta = torch.stack(abs_, dim=1)                   # (B, T)
    gamma_sum = torch.stack(gss, dim=1)
    return gamma_tm, alpha_beta, gamma_sum


def px_time_major(px, fa: FactorizedArrays):
    """(B, T, P) -> (T, P_eff, B), pdf axis zero-padded to a multiple
    of 128 that covers the graph's E matrices."""
    B, T, P = px.shape
    p_eff = max(-(-P // TILE) * TILE, fa.p_pad)
    px_tm = px.permute(1, 2, 0)
    if p_eff != P:
        px_tm = torch.nn.functional.pad(px_tm, (0, 0, 0, p_eff - P))
    return px_tm.contiguous()


def gamma_batch_major(gamma_tm, P):
    """(T, P_pad, B) -> (B, T, P), zero-padded or cut to P columns."""
    if gamma_tm.shape[1] < P:
        gamma_tm = torch.nn.functional.pad(
            gamma_tm, (0, 0, 0, P - gamma_tm.shape[1]))
    return gamma_tm[:, :P, :].permute(2, 0, 1).contiguous()


def forward_backward_prob_fact(px, lengths, fa: FactorizedArrays,
                               leaky_coefficient=1e-5) -> FwdBwdResult:
    """Fused fwd+bwd on the factorized graph.  px: (B, T, P) exp'd
    output; gamma is returned in (B, T, P)."""
    B, T, P = px.shape
    lengths = host_to(torch.as_tensor(lengths), px.device).long()
    with torch.no_grad(), _full_f32():
        px_tm = px_time_major(px, fa)
        alpha_dash, alpha_sums, objf, tot_prob = forward_prob_fact(
            px_tm, lengths, fa, leaky_coefficient)
        gamma_tm, alpha_beta, gamma_sum = backward_prob_fact(
            px_tm, lengths, fa, leaky_coefficient, alpha_dash, alpha_sums,
            tot_prob)
        gamma = gamma_batch_major(gamma_tm, P)
    ok = _ok_flags(objf, alpha_beta, gamma_sum)
    return FwdBwdResult(objf, gamma, ok, alpha_beta, gamma_sum)
