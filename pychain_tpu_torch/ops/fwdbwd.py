"""Batched HMM forward-backward on any graph: the generic gather engine.

The port's counterpart of ``pychain_tpu/ops/fwdbwd.py``: the
probability-domain recurrences with leaky-HMM (the reference's
chain-computation.{h,cc}, "version 3", chain-computation.h:25-158) and
the log-domain ones without it (chain-log-domain-computation.{h,cc}),
one frame at a time over the arcs of a :class:`GraphArrays`.  Unequal
lengths are masks, so batches need not be sorted.  It is plain PyTorch
on every device: the JAX engine has no TPU kernel (it is XLA), and it is
the port's engine for a list batch of prob-domain graphs and for
``impl="gather"``.

Every sum over arcs is deterministic, on the card as on the CPU
(docs/PARITY.md: gamma reproducible, no atomics).  ``index_add_`` and
``scatter_add_`` on CUDA tensors add in whatever order the atomics
land, so each segment reduction here follows a :class:`SegmentPlan`
built once a graph: the arcs sorted by the segment they sum into, in
rows of at most 32 summed by ``torch.sum`` (a fixed tree), level by
level until one value a segment is left.  Each frame is a handful of
small PyTorch operations: a check and an oracle, not a fast engine.

Shape conventions: x is (B, T, P); a graph's arrays are batched (B, ...)
or, ``shared``, unbatched.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import host_to

NEG_INF = float("-inf")
ROW = 32   # the widest row of a SegmentPlan level


class FwdBwdResult(NamedTuple):
    objf: torch.Tensor        # (B,) per-sequence total log-likelihood
    gamma: torch.Tensor       # (B, T, P) occupation posteriors = d objf / d x
    ok: torch.Tensor          # (B,) bool, invariants within 5% at t=0
    alpha_beta: torch.Tensor  # (B, T) per-frame sum_i alpha'(t,i) beta^(t,i)
    gamma_sum: torch.Tensor   # (B, T) per-frame sum_n gamma(t,n)


def _ok_flags(objf, alpha_beta, gamma_sum):
    """Per-sequence sanity flags, mirroring BetaGeneralFrameDebug
    (chain-computation.cc:345-391) at t=0 with the 5% 'abandon minibatch'
    threshold (the reference Python discards the flag, loss.py:44/62)."""
    ab0 = alpha_beta[:, 0]
    gs0 = gamma_sum[:, 0]
    return (torch.isfinite(objf)
            & ((ab0 - 1.0).abs() <= 0.05)
            & ((gs0 - 1.0).abs() <= 0.05))


# ----------------------------------------------------------------------
# Deterministic segment reductions
# ----------------------------------------------------------------------

class SegmentPlan:
    """A fixed order in which to reduce R rows of K values into R rows of
    M segments: ``seg`` (R, K) the segment of each value, ``valid``
    (R, K) the values that take part (the others are the reduction's
    neutral element: a padded arc's 0 or -inf).

    Built on the host: the valid values of all rows, flattened to R K,
    are sorted by (row, segment), stably, and each segment's run is cut
    into rows of ``width`` slots (twice the mean run, at most
    :data:`ROW`); a level reduces each row, and the next level does the
    same to the row results of segments that still have more than one,
    until every segment has one.  ``apply`` gathers with
    ``index_select`` and reduces with ``sum`` / ``amax`` over the last
    axis, so a reduction takes the same order on every call and
    device."""

    def __init__(self, seg: np.ndarray, valid: np.ndarray,
                 num_segments: int):
        seg = np.asarray(seg, np.int64)
        R, K = seg.shape
        self.n_in, self.n_out = R * K, R * num_segments
        keys = (seg + np.arange(R)[:, None] * num_segments)[valid]
        items = np.flatnonzero(valid)
        order = np.argsort(keys, kind="stable")
        keys, items = keys[order], items[order]
        n_in, levels = self.n_in, []
        while keys.size:
            first = np.ones(keys.size, bool)
            first[1:] = keys[1:] != keys[:-1]
            starts = np.flatnonzero(first)
            if starts.size == keys.size:
                break
            mean = keys.size / starts.size
            width = int(min(ROW, max(2, 1 << int(np.ceil(np.log2(mean))))))
            run = np.cumsum(first) - 1
            pos = np.arange(keys.size) - starts[run]
            new_row = pos % width == 0
            row = np.cumsum(new_row) - 1
            table = np.full((int(row[-1]) + 1, width), n_in, np.int64)
            table[row, pos % width] = items
            levels.append(table)
            keys, n_in = keys[new_row], table.shape[0]
            items = np.arange(n_in)
        out = np.full(self.n_out, n_in, np.int64)
        out[keys] = items
        self._host = (levels, out)
        self._on = {}

    def _tables(self, device):
        if device not in self._on:
            levels, out = self._host
            self._on[device] = ([torch.from_numpy(t).to(device)
                                 for t in levels],
                                torch.from_numpy(out).to(device))
        return self._on[device]

    def apply(self, v: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """v (N, n_in) -> (N, n_out): each segment's sum (``"sum"``, 0
        where it is empty) or max (``"amax"``, -inf)."""
        fill = 0.0 if op == "sum" else NEG_INF
        levels, out = self._tables(v.device)
        for table in levels:
            v = torch.cat([v, v.new_full((v.shape[0], 1), fill)], dim=1)
            v = v.index_select(1, table.view(-1)).view(
                v.shape[0], *table.shape)
            v = v.sum(dim=2) if op == "sum" else v.amax(dim=2)
        v = torch.cat([v, v.new_full((v.shape[0], 1), fill)], dim=1)
        return v.index_select(1, out)


@dataclasses.dataclass(eq=False)
class GraphArrays:
    """The graph tensors the gather engine reads (``pychain_tpu``'s
    ``GraphArrays``).

    Tensors have a leading batch dim (B, ...) unless ``shared`` is True:
    then they are unbatched and broadcast over the batch.  ``fwd_*`` arcs
    are grouped by source state, ``bwd_*`` by destination (the
    reference's forward/backward transition lists).  Padded arcs carry
    the neutral weight (0 in the prob domain, -inf in the log domain)
    and in-range indices.  ``leaky`` is None in the log domain.
    ``plans`` keeps what is derived from the arrays once: the engine's
    segment plans (:class:`SegmentPlan`, built on the host), its int64
    indices on each device, and the arc-id form ``viterbi_align`` reads;
    a copy made by :meth:`to` shares it."""
    fwd_src: torch.Tensor   # (K,) or (B, K) integer
    fwd_dst: torch.Tensor
    fwd_pdf: torch.Tensor
    fwd_prob: torch.Tensor  # float32
    bwd_src: torch.Tensor
    bwd_dst: torch.Tensor
    bwd_pdf: torch.Tensor
    bwd_prob: torch.Tensor
    initial: torch.Tensor   # (S,) or (B, S)
    final: torch.Tensor
    leaky: Optional[torch.Tensor]
    shared: bool
    plans: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_states(self) -> int:
        return int(self.initial.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.initial.device

    @property
    def log_domain(self) -> bool:
        return self.leaky is None

    def to(self, device) -> "GraphArrays":
        """A copy on ``device``; the plans (host arrays) come along."""
        return dataclasses.replace(self, **{
            f.name: host_to(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def take(self, index) -> "GraphArrays":
        """The batch rows ``index`` of a batched (not shared) graph; the
        plans are built anew for the new rows at first use."""
        if self.shared:
            raise ValueError("a shared graph has no batch rows to take")
        idx = torch.as_tensor(np.asarray(index), dtype=torch.long,
                              device=self.device)
        return dataclasses.replace(self, plans={}, **{
            f.name: getattr(self, f.name).index_select(0, idx)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def plan(self, side: str, num_segments: int = None) -> SegmentPlan:
        """The plan of ``side``: "bwd_dst" (alpha's sums into states),
        "fwd_src" (beta's) or "fwd_pdf" (gamma's, into num_segments
        pdfs)."""
        key = (side, num_segments)
        if key not in self.plans:
            seg = getattr(self, side).cpu().numpy()
            prob = getattr(self, side[:4] + "prob").cpu().numpy()
            if self.shared:
                seg, prob = seg[None], prob[None]
            neutral = NEG_INF if self.log_domain else 0.0
            self.plans[key] = SegmentPlan(
                seg, prob != neutral,
                self.num_states if num_segments is None else num_segments)
        return self.plans[key]

    def n_pdfs(self) -> int:
        """One more than the largest pdf an arc emits."""
        if "n_pdfs" not in self.plans:
            self.plans["n_pdfs"] = int(self.fwd_pdf.max()) + 1 \
                if self.fwd_pdf.numel() else 1
        return self.plans["n_pdfs"]


def _gather(values, idx, shared: bool):
    """values (B, N) at idx: (K,) shared or (B, K) batched -> (B, K)."""
    if shared:
        return values.index_select(1, idx)
    return torch.gather(values, 1, idx)


def _segment(g: GraphArrays, side: str, values, num_segments=None,
             op="sum"):
    """values (B, K) reduced into (B, M) by ``g.plan(side)``."""
    p = g.plan(side, num_segments)
    B = values.shape[0]
    if g.shared:
        return p.apply(values, op)
    return p.apply(values.reshape(1, -1), op).view(B, -1)


def safe_log(v):
    """log(v) with exact -inf at v <= 0 and no NaN from the masked
    branch (the inner where keeps log's argument positive)."""
    return torch.where(v > 0, torch.log(torch.where(v > 0, v, 1.0)),
                       NEG_INF)


def _segment_logsumexp(g: GraphArrays, side: str, terms):
    """Log-semiring segment reduction (B, K) -> (B, S): max-shifted
    exp / sum / log, -inf for an empty or all -inf segment."""
    m = _segment(g, side, terms, op="amax")
    fin = torch.isfinite(m)
    m_safe = torch.where(fin, m, 0.0)
    idx = _index(g, side)
    shifted = terms - _gather(m_safe, idx, g.shared)
    s = _segment(g, side, torch.exp(shifted))
    return torch.where(fin, torch.log(s) + m_safe, NEG_INF)


def _index(g: GraphArrays, name: str):
    """g's index array ``name`` as int64 (gathers want it), kept."""
    key = ("long", name, g.device)
    if key not in g.plans:
        g.plans[key] = getattr(g, name).long()
    return g.plans[key]


def _bexp(g: GraphArrays, v, B):
    """An unbatched graph array broadcast over the batch."""
    return v[None].expand(B, *v.shape) if g.shared else v


def _pdf_sums(g: GraphArrays, values, P):
    """values (B, K) of the fwd arcs summed by pdf into (B, P)."""
    n = g.n_pdfs()
    out = _segment(g, "fwd_pdf", values, n)
    return torch.nn.functional.pad(out, (0, P - n)) if P > n else out


def _prep(px, lengths, g: GraphArrays):
    lengths = host_to(torch.as_tensor(lengths), px.device).long()
    if g.device != px.device:
        raise ValueError(f"graph on {g.device} but x on {px.device}")
    return lengths


# ======================================================================
# Probability domain with leaky HMM (chain-computation.h:109-155)
# ======================================================================

def forward_prob(px, lengths, g: GraphArrays, leaky_coefficient: float):
    """Alpha sweep in the probability domain.  px (B, T, P) exp'd nnet
    output, lengths (B,).  Returns (alpha_dash (T+1, B, S), alpha_sums
    (T+1, B), objf (B,), tot_prob (B,))."""
    B, T, P = px.shape
    S = g.num_states
    lengths = _prep(px, lengths, g)
    src, pdf = _index(g, "bwd_src"), _index(g, "bwd_pdf")
    prob = _bexp(g, g.bwd_prob, B)
    leaky = _bexp(g, g.leaky, B)
    alpha0 = _bexp(g, g.initial, B)
    s0 = alpha0.sum(dim=1)
    ad0 = alpha0 + leaky_coefficient * s0[:, None] * leaky
    ad_prev, s_prev, ad_last = ad0, s0, ad0
    loglike = torch.log(s0)            # frame 0 always active
    ad_ys, s_ys = [ad0], [s0]
    for t in range(1, T + 1):
        w = (_gather(ad_prev, src, g.shared) * prob
             * _gather(px[:, t - 1], pdf, g.shared))
        alpha_t = _segment(g, "bwd_dst", w) / s_prev[:, None]
        s_t = alpha_t.sum(dim=1)
        ad_t = alpha_t + leaky_coefficient * s_t[:, None] * leaky
        active = t <= lengths
        loglike = loglike + torch.where(
            t < lengths, torch.log(torch.where(s_t > 0, s_t, 1.0)), 0.0)
        ad_prev = torch.where(active[:, None], ad_t, ad_prev)
        s_prev = torch.where(active, s_t, s_prev)
        ad_last = torch.where((t == lengths)[:, None], ad_prev, ad_last)
        ad_ys.append(ad_prev)
        s_ys.append(s_prev)
    alpha_dash = torch.stack(ad_ys, dim=0)
    alpha_sums = torch.stack(s_ys, dim=0)
    tot_prob = (ad_last * _bexp(g, g.final, B)).sum(dim=1)
    return alpha_dash, alpha_sums, loglike + torch.log(tot_prob), tot_prob


def backward_prob(px, lengths, g: GraphArrays, leaky_coefficient: float,
                  alpha_dash, alpha_sums, tot_prob):
    """Beta sweep + occupation posteriors, probability domain.  Returns
    (gamma (B, T, P), alpha_beta (B, T), gamma_sum (B, T))."""
    B, T, P = px.shape
    lengths = _prep(px, lengths, g)
    src, dst, pdf = (_index(g, n) for n in ("fwd_src", "fwd_dst", "fwd_pdf"))
    prob = _bexp(g, g.fwd_prob, B)
    leaky = _bexp(g, g.leaky, B)
    bd_final = _bexp(g, g.final, B) * (1.0 / tot_prob)[:, None]
    bd_next = torch.zeros_like(alpha_dash[0])
    gammas, abs_, gss = [None] * T, [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        ad_t, s_t = alpha_dash[t], alpha_sums[t]
        bd_eff = torch.where((lengths == t + 1)[:, None], bd_final, bd_next)
        # beta(t+1) with the leaky correction (chain-computation.cc:313-330)
        b_next = bd_eff + leaky_coefficient * (
            (bd_eff * leaky).sum(dim=1, keepdim=True))
        vf = (prob * _gather(b_next, dst, g.shared)
              * _gather(px[:, t], pdf, g.shared))
        inv_s = 1.0 / s_t[:, None]
        bd_t = _segment(g, "fwd_src", vf) * inv_s
        occ = _gather(ad_t, src, g.shared) * inv_s
        gamma_t = _pdf_sums(g, vf * occ, P)
        active = (t < lengths)[:, None]
        bd_next = torch.where(active, bd_t, bd_eff)
        gamma_t = torch.where(active, gamma_t, 0.0)
        # invariants (BetaGeneralFrameDebug, cc:345-391), pre-leaky beta'
        abs_[t] = (ad_t * bd_next).sum(dim=1)
        gss[t] = gamma_t.sum(dim=1)
        gammas[t] = gamma_t
    return (torch.stack(gammas, dim=1), torch.stack(abs_, dim=1),
            torch.stack(gss, dim=1))


def forward_backward_prob(px, lengths, g: GraphArrays,
                          leaky_coefficient: float = 1e-5) -> FwdBwdResult:
    """Fused forward+backward, probability domain with leaky HMM."""
    with torch.no_grad():
        px = px.float()
        alpha_dash, alpha_sums, objf, tot_prob = forward_prob(
            px, lengths, g, leaky_coefficient)
        gamma, alpha_beta, gamma_sum = backward_prob(
            px, lengths, g, leaky_coefficient, alpha_dash, alpha_sums,
            tot_prob)
    return FwdBwdResult(objf, gamma, _ok_flags(objf, alpha_beta, gamma_sum),
                        alpha_beta, gamma_sum)


# ======================================================================
# Log domain, no leaky HMM (chain-log-domain-computation.{h,cc})
# ======================================================================

def forward_log(x, lengths, g: GraphArrays):
    """Alpha sweep in the log domain.  x (B, T, P) clamped nnet
    log-likelihoods.  Returns (alpha (T+1, B, S), alpha_sums (T+1, B),
    objf (B,), tlp (B,)), tlp = logsumexp(alpha(T_b) + final)."""
    B, T, P = x.shape
    lengths = _prep(x, lengths, g)
    src, pdf = _index(g, "bwd_src"), _index(g, "bwd_pdf")
    prob = _bexp(g, g.bwd_prob, B)
    a0 = _bexp(g, g.initial, B)
    s0 = x.new_zeros(B)                 # alpha-sum(0) := 0, cc:89
    a_prev, s_prev, a_last = a0, s0, a0
    loglike = x.new_zeros(B)
    a_ys, s_ys = [a0], [s0]
    for t in range(1, T + 1):
        terms = (_gather(a_prev, src, g.shared) + prob
                 + _gather(x[:, t - 1], pdf, g.shared))
        a_t = _segment_logsumexp(g, "bwd_dst", terms) - s_prev[:, None]
        s_t = torch.logsumexp(a_t, dim=1)
        active = t <= lengths
        loglike = loglike + torch.where(t < lengths, s_t, 0.0)
        a_prev = torch.where(active[:, None], a_t, a_prev)
        s_prev = torch.where(active, s_t, s_prev)
        a_last = torch.where((t == lengths)[:, None], a_prev, a_last)
        a_ys.append(a_prev)
        s_ys.append(s_prev)
    alpha = torch.stack(a_ys, dim=0)
    alpha_sums = torch.stack(s_ys, dim=0)
    tlp = torch.logsumexp(a_last + _bexp(g, g.final, B), dim=1)
    return alpha, alpha_sums, loglike + tlp, tlp


def backward_log(x, lengths, g: GraphArrays, alpha, alpha_sums, tlp):
    """Beta sweep + posteriors, log domain; gamma in linear space (a
    linear sum of exp'd occupancies, where the reference accumulates
    log-gamma with atomicLogAdd and exps it at loss.py:77)."""
    B, T, P = x.shape
    lengths = _prep(x, lengths, g)
    src, dst, pdf = (_index(g, n) for n in ("fwd_src", "fwd_dst", "fwd_pdf"))
    prob = _bexp(g, g.fwd_prob, B)
    b_final = _bexp(g, g.final, B) - tlp[:, None]
    b_next = torch.full_like(alpha[0], NEG_INF)
    gammas, abs_, gss = [None] * T, [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        a_t, s_t = alpha[t], alpha_sums[t]
        b_eff = torch.where((lengths == t + 1)[:, None], b_final, b_next)
        vf = (prob + _gather(b_eff, dst, g.shared)
              + _gather(x[:, t], pdf, g.shared) - s_t[:, None])
        b_t = _segment_logsumexp(g, "fwd_src", vf)
        occ = vf + _gather(a_t, src, g.shared)
        gamma_t = _pdf_sums(g, torch.exp(occ), P)
        active = (t < lengths)[:, None]
        b_next = torch.where(active, b_t, b_eff)
        gamma_t = torch.where(active, gamma_t, 0.0)
        abs_[t] = torch.exp(torch.logsumexp(a_t + b_next, dim=1))
        gss[t] = gamma_t.sum(dim=1)
        gammas[t] = gamma_t
    return (torch.stack(gammas, dim=1), torch.stack(abs_, dim=1),
            torch.stack(gss, dim=1))


def forward_backward_log(x, lengths, g: GraphArrays) -> FwdBwdResult:
    """Fused forward+backward in the log domain (numerator path)."""
    with torch.no_grad():
        x = x.float()
        alpha, alpha_sums, objf, tlp = forward_log(x, lengths, g)
        gamma, alpha_beta, gamma_sum = backward_log(x, lengths, g, alpha,
                                                    alpha_sums, tlp)
    return FwdBwdResult(objf, gamma, _ok_flags(objf, alpha_beta, gamma_sum),
                        alpha_beta, gamma_sum)
