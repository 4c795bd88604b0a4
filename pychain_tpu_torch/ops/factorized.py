"""Plain PyTorch forward-backward on the factorized denominator graph.

The port's counterpart of ``pychain_tpu/ops/factorized.py``: the same
recurrences (the reference's "version 3" equations,
chain-computation.h:109-155) on the stratified form built by
``graphs/factorize.py`` (each transition matrix = diagonal + one dense
block + 128x128 tiles), written as eager float32 PyTorch with a Python
loop over frames.  Layout is state-major (S_pad, B) per frame, as in the
JAX engine, so the two compare step for step.

Two engines.  :func:`forward_backward_prob_fact` is the counterpart of
the JAX XLA engine (``impl="factorized"``): float32 throughout, and with
bfloat16 tiles only the matrix operands rounded.  It is the PLAIN
VERSION of the two CUDA kernels of ``ops/fact_kernels.py`` in float32.
:func:`forward_backward_prob_fast` is the plain version of the same
kernels in the fast mode (bfloat16 tiles): it rounds where the Pallas
kernels of ``pychain_tpu/ops/pallas_fact.py`` round in that mode, and
takes every sum in the CUDA kernels' order (on the graph's sliced-ELL
rows and pdf lists, ``fact_kernels.fast_operators``), so that they
equal it bit for bit; with ``cluster=C`` it takes them in the cluster
kernels' order instead (``ops/stream_kernels.py``: the ascending rows,
each sum over a vector's states split over C CTAs, :func:`cluster_sum`).
Each is the CPU path of the kernels' wrapper and what ``chip_smoke.py``
holds the kernels against on the card.  The kernels' lean and ckpt
stream modes have theirs too (:func:`forward_backward_prob_mode`): in
float32 the same numbers, in the fast mode each mode's own rounding
points (``lean=True``; :func:`forward_backward_prob_ckpt`, chunk by
chunk as the card runs it).  Neither is fast: each frame launches a
handful of small PyTorch operations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
    # True when this factorization serves a log-domain graph in
    # normalized-linear form (its weights exp'd: exact for hard zeros).
    # The loss then forces leaky_coefficient 0 (no leaky HMM in the log
    # domain, graph.py:54-59) and guards dead sequences to the log
    # engines' contract (objf -inf, gamma 0, ok False).
    log_semantics: bool = False
    # (2,) float32 [arc_shift, const_shift] when the log_semantics
    # weights were re-centered into float32's exp-safe band: every
    # length-L path was rescaled by exp(-(arc_shift L + const_shift)),
    # which the loss adds back onto objf.  None for a graph in the band.
    log_shifts: Optional[torch.Tensor] = None

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
    float32 accumulation; :func:`forward_backward_prob_fast`).  Both
    kernel pairs, resident and cluster, take both."""
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


def _fact_frames(px_tm, lengths, fa: FactorizedArrays, leaky_coefficient,
                 t0, n, ad_prev, s_prev):
    """The alpha recurrence over frames t0 .. t0 + n - 1 from alpha'(t0)
    = ad_prev (S_pad, B) and s_{t0} = s_prev (B,), each column's carry
    frozen past its length.  Yields (t, s_t, alpha'(t), s_t frozen) after
    frame t - 1, t = t0 + 1 .. t0 + n (1-based)."""
    leaky = fa.leaky[:, None]
    for t in range(t0 + 1, t0 + n + 1):
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
        ad_prev = torch.where(active[None, :], ad_t, ad_prev)
        s_prev = torch.where(active, s_t, s_prev)
        yield t, s_t, ad_prev, s_prev


def forward_prob_fact(px_tm, lengths, fa: FactorizedArrays,
                      leaky_coefficient, snap=None):
    """Alpha sweep.  px_tm: (T, P, B) exp'd nnet output, time-major,
    pdf-major.  Returns (alpha_dash (T+1, S_pad, B), alpha_sums (T+1, B),
    objf (B,), tot_prob (B,)); with ``snap`` = C alpha_dash holds
    alpha'(k C) for k = 0 .. ceil(T / C) - 1 alone (the ckpt mode's
    snapshots: each chunk's alpha' on entry)."""
    T, P, B = px_tm.shape
    alpha0 = fa.initial[:, None].expand(fa.s_pad, B)
    s0 = alpha0.sum(dim=0)
    ad0 = alpha0 + leaky_coefficient * s0[None, :] * fa.leaky[:, None]
    ad_last = ad0
    loglike = torch.log(s0)
    ad_ys, s_ys = [ad0], [s0]
    for t, s_t, ad_prev, s_prev in _fact_frames(px_tm, lengths, fa,
                                                leaky_coefficient, 0, T, ad0,
                                                s0):
        loglike = loglike + torch.where(
            t < lengths, torch.log(torch.where(s_t > 0, s_t, 1.0)), 0.0)
        ad_last = torch.where((t == lengths)[None, :], ad_prev, ad_last)
        if snap is None or (t % snap == 0 and t < T):
            ad_ys.append(ad_prev)
        s_ys.append(s_prev)

    alpha_dash = torch.stack(ad_ys, dim=0)
    alpha_sums = torch.stack(s_ys, dim=0)
    tot_prob = (ad_last * fa.final[:, None]).sum(dim=0)
    objf = loglike + torch.log(tot_prob)
    return alpha_dash, alpha_sums, objf, tot_prob


def _fact_back(px_tm, lengths, fa: FactorizedArrays, leaky_coefficient,
               alpha_dash, alpha_sums, tot_prob, t0, n, bd_next):
    """Beta sweep + posteriors over frames t0 + n - 1 down to t0, with
    alpha_dash[j] = alpha'(t0 + j) and alpha_sums[j] = s_{t0 + j}, from
    the beta' carry bd_next (S_pad, B) of the frames above.  Returns
    (gamma rows, alpha_beta columns, gamma_sum columns: lists of n,
    beta'(t0))."""
    leaky = fa.leaky[:, None]
    bd_final = fa.final[:, None] / tot_prob[None, :]
    gammas, abs_, gss = [None] * n, [None] * n, [None] * n
    for t in range(t0 + n - 1, t0 - 1, -1):
        j = t - t0
        px_t, ad_t, s_t = px_tm[t], alpha_dash[j], alpha_sums[j]
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
        abs_[j] = (ad_t * bd_next).sum(dim=0)
        gss[j] = gamma_t.sum(dim=0)
        gammas[j] = gamma_t
    return gammas, abs_, gss, bd_next


def backward_prob_fact(px_tm, lengths, fa: FactorizedArrays,
                       leaky_coefficient, alpha_dash, alpha_sums, tot_prob):
    """Beta sweep + posteriors.  Returns (gamma (T, P_pad, B),
    alpha_beta (B, T), gamma_sum (B, T))."""
    T, P, B = px_tm.shape
    bd_next = torch.zeros((fa.s_pad, B), dtype=px_tm.dtype,
                          device=px_tm.device)
    gammas, abs_, gss, _ = _fact_back(px_tm, lengths, fa, leaky_coefficient,
                                      alpha_dash, alpha_sums, tot_prob, 0,
                                      T, bd_next)
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


# ----------------------------------------------------------------------
# Fast mode: the Pallas kernels' rounding points (bfloat16 tiles)
# ----------------------------------------------------------------------
#
# pallas_fact.py rounds, with bfloat16 tiles: px to bfloat16 once
# (px_time_major(px, fa, dtype=bf16) :866, so x_dst and x_src are exact
# gathers of bfloat16 values); the operand of every dense-block and tile
# product (_WK.apply :190, :201), whose sums accumulate in float32, but
# not the diagonal stratum's, which stays float32 (:180-186); each
# state's posterior mass before the per-pdf sums (E^T applied with
# bfloat16 operands, :620-626, :676-678); and what it stores: the alpha'
# stream, W1 alpha' and the emission rows (:283-313), and gamma (:628).
# The carries alpha' and beta', s_t, the objective and the traces stay
# float32, and the backward sweep's alpha'(0) is the float32 ad0
# (:567-573).

def _bf(v):
    """v rounded to bfloat16 (to nearest even), kept as float32."""
    return v.to(torch.bfloat16).float()


def is_fast(fa: FactorizedArrays) -> bool:
    """Whether ``fa`` runs in the fast mode: bfloat16 transition tiles."""
    return fa.w1.operand_dtype == torch.bfloat16


def initial_alpha(fa: FactorizedArrays, leaky_coefficient):
    """(ad0 (S_pad,), s0 (1,)): alpha'(0) = initial + c * s0 * leaky with
    s0 = sum(initial), as the kernels' wrappers compute them."""
    s0 = fa.initial.sum().reshape(1)
    return (fa.initial + leaky_coefficient * s0 * fa.leaky).contiguous(), s0


THREADS = 1024   # FACT_THREADS in csrc/fact_common.cuh: a kernel's block


def block_sum(v):
    """The sum over axis 0 of v (N, B) that the kernels' block_sum takes
    (csrc/fact_common.cuh): thread t of the block adds rows t, t + 1024,
    ... in order, then a shuffle-down tree sums each warp's 32 threads,
    and another the 32 warps' partials.  Returns (B,)."""
    n, B = v.shape
    R = max(-(-n // THREADS), 1)
    x = torch.nn.functional.pad(v, (0, 0, 0, R * THREADS - n)).view(
        R, THREADS, B)
    part = x[0]
    for k in range(1, R):
        part = part + x[k]
    for groups in (32, 1):              # each warp's lanes, then the warps
        part = part.reshape(groups, -1, B)
        for off in (16, 8, 4, 2, 1):
            part = part[:, :off] + part[:, off:2 * off]
        part = part[:, 0]
    return part[0]


SLICE = 32   # rows of a sliced-ELL slice (fact_kernels.SLICE)


def cluster_rows(s_pad: int, cluster: int, device=None) -> list:
    """The rows each CTA of a cluster of ``cluster`` owns, as the cluster
    kernels lay them out (cluster_own_rows / cluster_row in
    csrc/fact_common.cuh): CTA r the 32-row slices r, r + C, ...,
    ascending, which it sums in this (local) order; none for a rank past
    the last slice."""
    slices = torch.arange(s_pad // SLICE, device=device)
    lane = torch.arange(SLICE, device=device)
    return [(slices[slices % cluster == r][:, None] * SLICE
             + lane).reshape(-1) for r in range(cluster)]


def pdf_columns(P: int, cluster: int) -> list:
    """The pdf columns CTA r of a cluster sums gamma over in stream_bwd.cu:
    [r ceil(P / C), (r + 1) ceil(P / C)), cut at P (empty past it)."""
    per = -(-P // cluster)
    return [slice(min(P, r * per), min(P, r * per + per))
            for r in range(cluster)]


def rank_sum(v, parts):
    """The sum over axis 0 of v (N, B) that a cluster takes: each CTA's
    part (``parts``: row indices or slices) by :func:`block_sum`, then the
    C partials added in rank order from 0 (cluster_rank_sum); an idle
    CTA's partial is 0.  Returns (B,)."""
    total = torch.zeros(v.shape[1:], dtype=v.dtype, device=v.device)
    for part in parts:
        total = total + block_sum(v[part])
    return total


def cluster_sum(v, cluster: int):
    """The sum over the states (axis 0) of v (S_pad, B) that the cluster
    kernels take with C = ``cluster`` CTAs (:func:`cluster_rows`,
    :func:`rank_sum`).  Returns (B,)."""
    return rank_sum(v, cluster_rows(v.shape[0], cluster, v.device))


def _ell_table(sell):
    """A sliced-ELL operator (``fact_kernels._sell``) as (cols, vals), two
    (slots, rows) tables: entry k of row r at [k, r], zero past the row's
    slice (a padding slot adds 0, as the kernels' (0, 0) entries do)."""
    sptr, col, val = sell
    sptr = sptr.long()
    slen = sptr[1:] - sptr[:-1]
    n_rows = len(slen) * 32
    K = int(slen.max()) if len(slen) else 0
    e = torch.arange(len(col), device=col.device)
    sl = torch.repeat_interleave(torch.arange(len(slen), device=col.device),
                                 slen * 32)
    k, row = e // 32 - sptr[:-1][sl], sl * 32 + e % 32
    cols = torch.zeros((K, n_rows), dtype=torch.long, device=col.device)
    vals = torch.zeros((K, n_rows), dtype=torch.float32, device=col.device)
    cols[k, row] = col.long()
    vals[k, row] = val.float()
    return cols, vals


def _ell_apply(table, v):
    """Each row of the operator times v (S_pad, B), its entries added in
    slot order from the first: sell_row_dot's sum (csrc/fact_common.cuh),
    whose products of two bfloat16 values are exact in float32."""
    cols, vals = table
    if cols.shape[0] == 0:
        return torch.zeros_like(v)
    terms = v[cols] * vals[:, :, None]              # (slots, S_pad, B)
    acc = terms[0]
    for k in range(1, terms.shape[0]):
        acc = acc + terms[k]
    return acc


def _list_table(lists, s_pad):
    """pdf -> states lists (``fact_kernels._pdf_lists``) as a (slots,
    lists) table of states, padded with s_pad (a zero row)."""
    ptr, states = (t.long() for t in lists)
    lens = ptr[1:] - ptr[:-1]
    n = len(lens)
    L = int(lens.max()) if n else 0
    table = torch.full((L, n), s_pad, dtype=torch.long, device=ptr.device)
    e = torch.arange(len(states), device=ptr.device)
    p = torch.repeat_interleave(torch.arange(n, device=ptr.device), lens)
    table[e - ptr[:-1][p], p] = states
    return table


def _list_sums(table, c, acc=None):
    """Each list's masses c (S_pad, B) added in list order, onto ``acc``
    (default 0): the gamma stage's sums (csrc/fact_bwd.cu)."""
    c = torch.cat([c, torch.zeros_like(c[:1])])
    if acc is None:
        acc = torch.zeros((table.shape[1], c.shape[1]), dtype=c.dtype,
                          device=c.device)
    for k in range(table.shape[0]):
        acc = acc + c[table[k]]
    return acc


def _fast_graph(fa: FactorizedArrays, cluster=None):
    """What the fast mode reads, on fa's device: the operators' tables
    (B1/B2's, or with ``cluster`` the cluster pair's ascending rows), the
    two diagonals (S_pad, 1), f_dst, g_src (or None) and the pdf lists'
    tables."""
    from . import fact_kernels as fk
    kg = fk.graph_for(fa)
    ops, (d1, d2) = fk.fast_operators(fa, ascending=cluster is not None)
    lists = [_list_table(kg.f_lists, fa.s_pad)]
    if kg.g_lists is not None:
        lists.append(_list_table(kg.g_lists, fa.s_pad))
    return ([_ell_table(op) for op in ops], d1[:, None], d2[:, None],
            kg.f_dst.long(), None if kg.g_src is None else kg.g_src.long(),
            lists)


def _state_sum(s_pad, cluster, device):
    """The sum over the states the kernels take: fact_*.cu's
    :func:`block_sum`, or with ``cluster`` the cluster pair's
    (:func:`cluster_sum`)."""
    if cluster is None:
        return block_sum
    return functools.partial(rank_sum,
                             parts=cluster_rows(s_pad, cluster, device))


def _fast_frames(px_tm, lengths, fa: FactorizedArrays, leaky_coefficient,
                 graph, total, t0, n, own, s_prev):
    """The fast alpha recurrence over frames t0 .. t0 + n - 1 from the
    carry own (S_pad, B; alpha'(t0), unrounded) and s_{t0} = s_prev (B,),
    each column's carry frozen past its length.  Yields (t, alpha'(t + 1)
    as computed, the carry, W1 alpha'(t), s_{t + 1}, active) after each
    frame t."""
    tables, d1, d2, f, g, _ = graph
    leaky = fa.leaky[:, None]
    for t in range(t0, t0 + n):
        x = _bf(px_tm[t][f])
        xs = x if g is None else _bf(px_tm[t][g])
        w1a = _ell_apply(tables[0], _bf(own)) + d1 * own
        u = xs * own
        w2u = _ell_apply(tables[1], _bf(u)) + d2 * u
        a = (x * w1a + w2u) * (1.0 / s_prev)[None, :]
        s_t = total(a)
        v = a + (leaky_coefficient * s_t)[None, :] * leaky
        active = t < lengths
        own = torch.where(active[None, :], v, own)
        s_prev = torch.where(active, s_t, s_prev)
        yield t, v, own, w1a, s_t, active


def forward_prob_fast(px_tm, lengths, fa: FactorizedArrays,
                      leaky_coefficient, graph=None, cluster=None,
                      snap=None):
    """Fast-mode alpha sweep.  px_tm: (T, P_eff, B) float32, rounded here.
    Every sum is taken in fact_fwd.cu's order (each row's slots, then the
    diagonal; :func:`block_sum`), or with ``cluster`` = C in stream_fwd.cu's
    (the ascending rows; :func:`cluster_sum`), so that the kernel gives
    these numbers bit for bit.  Returns (alpha_dash (T+1, S_pad, B):
    alpha'(0) = ad0 in float32, then the stored (bfloat16-rounded)
    alpha'(t); w1_alpha (T, S_pad, B): the stored W1 alpha'(t); s_ys (B,
    T): s_1 .. s_T, 1 past a column's end, as the kernel writes them;
    objf (B,), tot_prob (B,)).  With ``snap`` = C (fact_fwd_snap's
    snapshots) alpha_dash holds alpha'(k C) for k = 0 .. ceil(T / C) - 1
    alone and w1_alpha is None."""
    from .fact_kernels import _objf
    graph = graph or _fast_graph(fa, cluster)
    total = _state_sum(fa.s_pad, cluster, px_tm.device)
    T, _, B = px_tm.shape
    ad0, s0 = initial_alpha(fa, leaky_coefficient)
    own = ad0[:, None].expand(fa.s_pad, B)
    ad_last = own
    ad_ys, w1_ys, s_ys = [own], [], []
    for t, v, own, w1a, s_t, active in _fast_frames(
            px_tm, lengths, fa, leaky_coefficient, graph, total, 0, T, own,
            s0.expand(B)):
        ad_last = torch.where((lengths == t + 1)[None, :], v, ad_last)
        if snap is None:
            ad_ys.append(_bf(own))
            w1_ys.append(_bf(w1a))
        elif (t + 1) % snap == 0 and t + 1 < T:
            ad_ys.append(_bf(own))
        s_ys.append(torch.where(active, s_t, 1.0))
    s_ys = torch.stack(s_ys, dim=1)
    objf, tot_prob = _objf(s_ys, ad_last.t().contiguous(), lengths, fa, s0)
    return (torch.stack(ad_ys, dim=0),
            torch.stack(w1_ys, dim=0) if snap is None else None, s_ys, objf,
            tot_prob)


def _fast_back(px_tm, lengths, fa: FactorizedArrays, leaky_coefficient,
               alpha_dash, w1_alpha, s_ys, tot_prob, graph, cluster, t0, n,
               bd, leak):
    """The fast beta sweep over frames t0 + n - 1 down to t0, with
    alpha_dash[j] = alpha'(t0 + j) and w1_alpha[j] the stored W1
    alpha'(t0 + j) (None: the lean mode's, formed here from alpha'(t0 +
    j), unrounded), from the carry bd (S_pad, B) and its leaky sum leak
    (B,).  Returns (gamma rows (P, B), alpha_beta and gamma_sum columns:
    lists of n, the carry and its leaky sum at t0)."""
    tables, d1, d2, f, g, lists = graph
    P, B = px_tm.shape[1], px_tm.shape[2]
    total = _state_sum(fa.s_pad, cluster, px_tm.device)
    pdf_total = block_sum if cluster is None else functools.partial(
        rank_sum, parts=pdf_columns(P, cluster))
    leaky = fa.leaky[:, None]
    _, s0 = initial_alpha(fa, leaky_coefficient)
    bd_final = fa.final[:, None] / tot_prob[None, :]
    leak_final = total(bd_final * leaky)
    gammas, abs_, gss = [None] * n, [None] * n, [None] * n
    for t in range(t0 + n - 1, t0 - 1, -1):
        j = t - t0
        inject = lengths == t + 1
        bd = torch.where(inject[None, :], bd_final, bd)
        leak = torch.where(inject, leak_final, leak)
        inv = 1.0 / (s0.expand(B) if t == 0 else s_ys[:, t - 1])
        x = _bf(px_tm[t][f])
        xs = x if g is None else _bf(px_tm[t][g])
        ad = alpha_dash[j]
        if w1_alpha is None:
            # fact_bwd_lean: fact_fwd's rows over the stored alpha', plus
            # the diagonal term, not rounded
            w1a = _ell_apply(tables[0], _bf(ad)) + d1 * ad
        else:
            w1a = w1_alpha[j]
        v = bd + (leaky_coefficient * leak)[None, :]
        xb = x * v
        w1t = _ell_apply(tables[2], _bf(xb)) + d1 * xb
        sw = xs * (_ell_apply(tables[3], _bf(v)) + d2 * v)
        bd_t = (w1t + sw) * inv[None, :]
        # each state's mass, unscaled, rounded before its pdf's sum
        m1, m2 = xb * w1a, sw * ad
        if g is None:
            acc = _list_sums(lists[0], _bf(m1 + m2))
        else:
            acc = _list_sums(lists[1], _bf(m2),
                             _list_sums(lists[0], _bf(m1)))
        acc = torch.nn.functional.pad(acc[:P], (0, 0, 0, P - min(
            P, acc.shape[0])))
        active = t < lengths
        gammas[j] = torch.where(active[None, :], _bf(acc * inv[None, :]),
                                0.0)
        abs_[j] = torch.where(active, total(ad * bd_t), 0.0)
        gss[j] = torch.where(active, pdf_total(acc) * inv, 0.0)
        leak = torch.where(active, total(bd_t * leaky), leak)
        bd = torch.where(active[None, :], bd_t, bd)
    return gammas, abs_, gss, bd, leak


def backward_prob_fast(px_tm, lengths, fa: FactorizedArrays,
                       leaky_coefficient, alpha_dash, w1_alpha, s_ys,
                       tot_prob, graph=None, cluster=None):
    """Fast-mode beta sweep + posteriors on :func:`forward_prob_fast`'s
    results, every sum in fact_bwd.cu's order, or with ``cluster`` = C in
    stream_bwd.cu's (the sum-gamma trace over each CTA's pdf columns,
    :func:`pdf_columns`, then in rank order); w1_alpha None: the lean
    mode's (fact_bwd_lean.cu's W1 alpha', formed from alpha_dash).
    Returns (gamma (T, P_eff, B): bfloat16 values, zero past each
    column's end; alpha_beta (B, T), gamma_sum (B, T))."""
    graph = graph or _fast_graph(fa, cluster)
    T, _, B = px_tm.shape
    bd = torch.zeros((fa.s_pad, B), dtype=torch.float32,
                     device=px_tm.device)
    leak = torch.zeros(B, dtype=torch.float32, device=px_tm.device)
    gammas, abs_, gss, _, _ = _fast_back(
        px_tm, lengths, fa, leaky_coefficient, alpha_dash, w1_alpha, s_ys,
        tot_prob, graph, cluster, 0, T, bd, leak)
    return (torch.stack(gammas, dim=0), torch.stack(abs_, dim=1),
            torch.stack(gss, dim=1))


def forward_backward_prob_fast(px, lengths, fa: FactorizedArrays,
                               leaky_coefficient=1e-5,
                               cluster=None, lean=False) -> FwdBwdResult:
    """Fused fwd+bwd in the fast mode on a graph with bfloat16 tiles:
    what the Pallas kernels compute with bfloat16 tiles (the rounding
    points above), and the plain version of the CUDA kernels in that
    mode, which give its numbers bit for bit (it takes every sum in their
    order): the resident pair's, or with ``cluster`` = C the cluster
    pair's at C CTAs a cluster (for any G columns a CTA); with ``lean``
    the lean stream mode's (fact_bwd_lean forms W1 alpha' from the stored
    alpha' and does not round it, pallas_fact.py:597-601).  px: (B, T, P)
    exp'd output (float32); gamma is returned in (B, T, P), float32
    holding bfloat16 values."""
    B, T, P = px.shape
    lengths = host_to(torch.as_tensor(lengths), px.device).long()
    with torch.no_grad():
        graph = _fast_graph(fa, cluster)
        px_tm = px.permute(1, 2, 0)
        alpha_dash, w1_alpha, s_ys, objf, tot_prob = forward_prob_fast(
            px_tm, lengths, fa, leaky_coefficient, graph, cluster)
        gamma_tm, alpha_beta, gamma_sum = backward_prob_fast(
            px_tm, lengths, fa, leaky_coefficient, alpha_dash,
            None if lean else w1_alpha, s_ys, tot_prob, graph, cluster)
        gamma = gamma_batch_major(gamma_tm, P)
    ok = _ok_flags(objf, alpha_beta, gamma_sum)
    return FwdBwdResult(objf, gamma, ok, alpha_beta, gamma_sum)


# ----------------------------------------------------------------------
# The ckpt stream mode: snapshots and a chunked backward
# ----------------------------------------------------------------------
#
# pallas_fact.py:936-1006 keeps alpha' at each chunk's last frame alone,
# then scans the chunks from the last: each replays its forward from the
# snapshot below it (the full mode's streams for its C frames), then runs
# its backward from the beta' carry of the chunk above.  The kernels stop
# at each column's length, so T is not padded to a multiple of C (the
# Pallas grid runs every column to the padded T, :957-964): the last chunk
# is cut at T.  Chunk 0 enters from alpha'(0) rounded to the stream type
# (:976-978), and every chunk's backward reads the first sweep's s_t.

def forward_backward_prob_ckpt(px, lengths, fa: FactorizedArrays,
                               leaky_coefficient=1e-5,
                               ckpt_chunk=None,
                               schedule=None) -> FwdBwdResult:
    """The plain version of B1/B2 in the ckpt stream mode, in either
    precision (the fast one for bfloat16 tiles), chunk by chunk as the
    card runs it (``fact_kernels.ckpt_chunk_length``: C = ckpt_chunk,
    default about sqrt(T)).  In float32 it equals
    :func:`forward_backward_prob_fact` bit for bit (the same arithmetic
    from the same carries); in the fast mode each replay starts from the
    bfloat16 snapshot.  ``schedule``: the launches of the chunk scan, each
    a (backward chunk, replay chunk) pair, either None, run backward then
    replay, chunk k's replay kept in set k % 2 until its backward reads it
    (``fact_kernels.pair_schedule``, the paired scan); default each
    chunk's replay then its backward, from the last chunk down."""
    from .fact_kernels import ckpt_chunk_length
    B, T, P = px.shape
    C = ckpt_chunk_length(T, ckpt_chunk)
    lengths = host_to(torch.as_tensor(lengths), px.device).long()
    fast = is_fast(fa)
    c = leaky_coefficient
    with torch.no_grad(), _full_f32():
        if fast:
            graph = _fast_graph(fa)
            px_tm = px.permute(1, 2, 0)
            snaps, _, s_ys, objf, tot = forward_prob_fast(
                px_tm, lengths, fa, c, graph, snap=C)
            _, s0 = initial_alpha(fa, c)
            snaps[0] = _bf(snaps[0])
            carry = (torch.zeros((fa.s_pad, B), device=px.device),
                     torch.zeros(B, device=px.device))
        else:
            px_tm = px_time_major(px, fa)
            snaps, sums, objf, tot = forward_prob_fact(px_tm, lengths, fa, c,
                                                       snap=C)
            carry = (torch.zeros((fa.s_pad, B), device=px.device),)
        n_chunks = -(-T // C)
        gammas, abs_, gss = [None] * n_chunks, [None] * n_chunks, \
            [None] * n_chunks
        sets = {}   # set -> (chunk, its replayed streams)

        def replay(k):
            t0, n = k * C, min(C, T - k * C)
            if fast:
                s_init = s0.expand(B) if k == 0 else s_ys[:, t0 - 1]
                ad_c, w1_c = [snaps[k]], []
                for _, _, own, w1a, _, _ in _fast_frames(
                        px_tm, lengths, fa, c, graph, block_sum, t0, n,
                        snaps[k], s_init):
                    ad_c.append(_bf(own))
                    w1_c.append(_bf(w1a))
                sets[k % 2] = (k, (ad_c, w1_c))
            else:
                sets[k % 2] = (k, [snaps[k]] + [
                    ad for _, _, ad, _ in _fact_frames(
                        px_tm, lengths, fa, c, t0, n - 1, snaps[k],
                        sums[t0])])

        def backward(k, carry):
            t0, n = k * C, min(C, T - k * C)
            held, streams = sets[k % 2]
            assert held == k, f"chunk {k}'s set holds chunk {held}"
            if fast:
                out = _fast_back(px_tm, lengths, fa, c, *streams, s_ys, tot,
                                 graph, None, t0, n, *carry)
            else:
                out = _fact_back(px_tm, lengths, fa, c, streams,
                                 sums[t0:t0 + n], tot, t0, n, *carry)
            gammas[k], abs_[k], gss[k] = (torch.stack(x, dim=i) for x, i in
                                          zip(out[:3], (0, 1, 1)))
            return out[3:]

        if schedule is None:
            schedule = [launch for k in range(n_chunks - 1, -1, -1)
                        for launch in ((None, k), (k, None))]
        for kb, kf in schedule:
            if kb is not None:
                carry = backward(kb, carry)
            if kf is not None:
                replay(kf)
        gamma = gamma_batch_major(torch.cat(gammas, dim=0), P)
        alpha_beta, gamma_sum = torch.cat(abs_, dim=1), torch.cat(gss, dim=1)
    ok = _ok_flags(objf, alpha_beta, gamma_sum)
    return FwdBwdResult(objf, gamma, ok, alpha_beta, gamma_sum)


def forward_backward_prob_mode(px, lengths, fa: FactorizedArrays,
                               leaky_coefficient=1e-5, stream_mode="full",
                               ckpt_chunk=None) -> FwdBwdResult:
    """The plain version of B1/B2 in a stream mode ("full", "lean" or
    "ckpt"; ``fact_kernels.resolve_stream_mode`` resolves "auto") and
    the graph's precision: in float32 the three compute the same
    numbers."""
    if stream_mode == "ckpt":
        return forward_backward_prob_ckpt(px, lengths, fa, leaky_coefficient,
                                          ckpt_chunk)
    if is_fast(fa):
        return forward_backward_prob_fast(px, lengths, fa, leaky_coefficient,
                                          lean=stream_mode == "lean")
    return forward_backward_prob_fact(px, lengths, fa, leaky_coefficient)
