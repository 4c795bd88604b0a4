"""Dense-batched forward-backward for prob-domain LIST batches.

The port's counterpart of ``pychain_tpu/ops/dense_list.py``.  A batch
of per-sequence denominator-style graphs (each with its own topology)
is laid out as per-graph dense (S_pad, S_pad) blocks, the arcs of each
graph classified with the shared factorized engine's pdf-attachment
rule (``graphs/factorize._classify_arcs``), so the per-frame update is
two batched matrix-vector products plus emissions gathered once for
every frame:

    a_t = x_dst_t * (W1 @ a') + W2 @ (x_src_t * a')   [+ residual arcs]

with ``x_dst[t, b, s] = px[b, t, f_b(s)]`` (indices vary per graph but
not per frame).  The recurrences are those of
``ops.fwdbwd.forward_backward_prob`` (chain-computation.h:109-155,
leaky HMM included); only the evaluation differs.  Dense blocks take
O(B S_pad^2) device memory, so the dispatch gates this engine on
:func:`fits_dense_list`, the JAX package's budget.

The JAX package computes the products in XLA, outside any Pallas
kernel; here they are ``torch.bmm``.  Float32 blocks multiply in IEEE
float32 (TF32 off for the call, the JAX package's
``Precision.HIGH``); bfloat16 blocks multiply their bfloat16-rounded
operands in float32, as ``preferred_element_type=float32`` does.  The
occupation masses are computed in state space inside the sweep and
summed into pdf space once after it, in a fixed order
(:class:`~pychain_tpu_torch.ops.fwdbwd.SegmentPlan`, built on the host
once a batch): no atomics, so gamma is bit-identical on a rerun, on
the card as on the CPU.  The residual arcs' per-frame sums into states
take plans of their own.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .fwdbwd import FwdBwdResult, SegmentPlan, _ok_flags
from ..utils.device import host_to, ieee_float32


def _budget_bytes() -> int:
    return int(os.environ.get("PYCHAIN_DENSE_LIST_BUDGET",
                              2 * 1024 * 1024 * 1024))


def fits_dense_list(batch_size: int, num_states: int) -> bool:
    """W1 + W2 as float32 dense blocks within the budget (default 2 GiB,
    ``PYCHAIN_DENSE_LIST_BUDGET`` bytes)."""
    s_pad = -(-int(num_states) // 128) * 128
    return 2 * batch_size * s_pad * s_pad * 4 <= _budget_bytes()


def _is_bf16(tile_dtype) -> bool:
    return str(tile_dtype) in ("bfloat16", "torch.bfloat16")


@dataclasses.dataclass(eq=False)
class DenseListArrays:
    """A batch of per-sequence prob-domain graphs as dense blocks.

    Every tensor is batch-leading, so :meth:`take` keeps each graph
    with its sequence.  ``f_ok`` / ``g_ok`` mark the states whose W1 /
    W2 term is defined (a pdf attached); ``plans`` keeps the host-built
    segment plans of the gamma sums and the residual arcs."""
    w1: torch.Tensor        # (B, S_pad, S_pad) w1[b, dst, src], dst-attached
    w2: torch.Tensor        # (B, S_pad, S_pad) src-attached arcs
    f_idx: torch.Tensor     # (B, S_pad) int64 pdf of each state's W1 term
    g_idx: torch.Tensor     # (B, S_pad) int64 pdf of each state's W2 term
    f_ok: torch.Tensor      # (B, S_pad) bool
    g_ok: torch.Tensor      # (B, S_pad) bool
    initial: torch.Tensor   # (B, S_pad) float32
    final: torch.Tensor
    leaky: torch.Tensor
    # residual arcs (pdf attachable to neither end); prob 0 = padding
    res_src: torch.Tensor   # (B, R_pad) int64
    res_dst: torch.Tensor
    res_pdf: torch.Tensor
    res_prob: torch.Tensor  # (B, R_pad) float32
    n_pdfs: int             # 1 + the largest pdf an arc emits
    p_pad: int
    # f_idx == g_idx everywhere: x_src is x_dst and the two gamma masses
    # add before their one sum into pdfs
    x_same: bool
    tile_dtype: str = "float32"
    plans: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def s_pad(self) -> int:
        return int(self.w1.shape[-1])

    @property
    def batch_size(self) -> int:
        return int(self.w1.shape[0])

    @property
    def device(self) -> torch.device:
        return self.w1.device

    def _tensors(self):
        return [f.name for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def to(self, device) -> "DenseListArrays":
        """A copy on ``device``; the host-built plans come along."""
        return dataclasses.replace(self, **{
            n: host_to(getattr(self, n), device) for n in self._tensors()})

    def take(self, index) -> "DenseListArrays":
        """The batch rows ``index``; the plans are built anew for the new
        order at first use."""
        idx = torch.as_tensor(np.asarray(index), dtype=torch.long,
                              device=self.device)
        return dataclasses.replace(self, plans={}, **{
            n: getattr(self, n).index_select(0, idx)
            for n in self._tensors()})

    def plan(self, kind: str, num_segments: int) -> SegmentPlan:
        """The fixed-order sum of ``kind``: "gamma" (each frame's state
        and residual masses into num_segments pdfs), "res_dst" /
        "res_src" (the residual arcs' values into states)."""
        key = (kind, num_segments)
        if key not in self.plans:
            h = {n: getattr(self, n).cpu().numpy()
                 for n in ("f_idx", "g_idx", "f_ok", "g_ok", "res_src",
                           "res_dst", "res_pdf", "res_prob")}
            res_ok = h["res_prob"] != 0
            if kind == "gamma":
                if self.x_same:
                    seg = [h["f_idx"], h["res_pdf"]]
                    ok = [h["f_ok"] | h["g_ok"], res_ok]
                else:
                    seg = [h["f_idx"], h["g_idx"], h["res_pdf"]]
                    ok = [h["f_ok"], h["g_ok"], res_ok]
                self.plans[key] = SegmentPlan(np.concatenate(seg, 1),
                                              np.concatenate(ok, 1),
                                              num_segments)
            else:
                self.plans[key] = SegmentPlan(h[kind], res_ok, num_segments)
        return self.plans[key]


def dense_list_arrays(graphs, tile_dtype="float32",
                      device="cpu") -> DenseListArrays:
    """The dense form of a list of prob-domain ``ChainGraph``s, padded
    to the batch's largest S (``pychain_tpu/ops/dense_list.py``), on
    ``device``."""
    from ..graphs.factorize import _classify_arcs

    B = len(graphs)
    S = max(g.num_states for g in graphs)
    s_pad = -(-S // 128) * 128
    p_max = 1
    res_lists = []
    w1 = np.zeros((B, s_pad, s_pad), np.float32)
    w2 = np.zeros((B, s_pad, s_pad), np.float32)
    f_idx = np.zeros((B, s_pad), np.int64)
    g_idx = np.zeros((B, s_pad), np.int64)
    f_ok = np.zeros((B, s_pad), bool)
    g_ok = np.zeros((B, s_pad), bool)
    initial = np.zeros((B, s_pad), np.float32)
    final = np.zeros((B, s_pad), np.float32)
    leaky = np.zeros((B, s_pad), np.float32)
    for i, g in enumerate(graphs):
        if g.log_domain:
            raise ValueError("dense_list engine is for the probability "
                             "domain; log-domain lists dispatch to the "
                             "semiring kernels")
        s = g.num_states
        trans = np.asarray(g.forward_transitions)
        probs = np.asarray(g.forward_transition_probs, np.float32)
        src = trans[:, 0].astype(np.int64)
        dst = trans[:, 1].astype(np.int64)
        pdf = trans[:, 2].astype(np.int64)
        if len(pdf):
            p_max = max(p_max, int(pdf.max()) + 1)
        cls, f_raw, g_raw = _classify_arcs(src, dst, pdf)
        m1, m2, m0 = cls == 1, cls == 2, cls == 0
        np.add.at(w1[i], (dst[m1], src[m1]), probs[m1])
        np.add.at(w2[i], (dst[m2], src[m2]), probs[m2])
        f_idx[i, :len(f_raw)] = np.maximum(f_raw, 0)
        g_idx[i, :len(g_raw)] = np.maximum(g_raw, 0)
        f_ok[i, :len(f_raw)] = f_raw >= 0
        g_ok[i, :len(g_raw)] = g_raw >= 0
        res_lists.append((src[m0], dst[m0], pdf[m0], probs[m0]))
        initial[i, :s] = g.initial_probs
        final[i, :s] = g.final_probs
        if g.leaky_probs is not None:
            leaky[i, :s] = g.leaky_probs
    r_pad = max(len(r[0]) for r in res_lists)
    res = [np.zeros((B, r_pad), np.int64) for _ in range(3)]
    res_prob = np.zeros((B, r_pad), np.float32)
    for i, (rs, rd, rp, rw) in enumerate(res_lists):
        for out, v in zip(res, (rs, rd, rp)):
            out[i, :len(v)] = v
        res_prob[i, :len(rw)] = rw
    t = torch.from_numpy
    td = torch.bfloat16 if _is_bf16(tile_dtype) else torch.float32
    return DenseListArrays(
        w1=t(w1).to(td), w2=t(w2).to(td), f_idx=t(f_idx), g_idx=t(g_idx),
        f_ok=t(f_ok), g_ok=t(g_ok), initial=t(initial), final=t(final),
        leaky=t(leaky), res_src=t(res[0]), res_dst=t(res[1]),
        res_pdf=t(res[2]), res_prob=t(res_prob), n_pdfs=p_max,
        p_pad=-(-p_max // 128) * 128,
        x_same=bool(np.array_equal(f_idx, g_idx)),
        tile_dtype="bfloat16" if _is_bf16(tile_dtype) else "float32",
    ).to(device)


class _Blocks:
    """The two operators as the products read them: float32 blocks as
    they are; bfloat16 blocks upcast once a call, each vector rounded to
    bfloat16 before its product (the JAX package's
    ``v.astype(w.dtype)`` with float32 accumulation)."""

    def __init__(self, da: DenseListArrays):
        self.bf16 = da.w1.dtype == torch.bfloat16
        self.w1 = da.w1.float()
        self.w2 = da.w2.float()

    def _v(self, v):
        return v.to(torch.bfloat16).float() if self.bf16 else v

    def mv(self, w, v):
        """w (B, D, S) @ v (B, S) -> (B, D)."""
        return torch.bmm(w, self._v(v).unsqueeze(2)).squeeze(2)

    def mvt(self, w, v):
        """w^T @ v: w (B, D, S), v (B, D) -> (B, S)."""
        return torch.bmm(w.transpose(1, 2), self._v(v).unsqueeze(2)
                         ).squeeze(2)


def _emissions(px, da: DenseListArrays):
    """x_dst, x_src (T, B, S_pad) and res_x (T, B, R_pad): the emissions
    of every frame, gathered once (frame-invariant indices)."""
    B, T, _ = px.shape

    def take(idx):
        return torch.gather(px, 2, idx[:, None, :].expand(B, T, -1)
                            ).transpose(0, 1).contiguous()

    x_dst = take(da.f_idx)
    x_src = x_dst if da.x_same else take(da.g_idx)
    res_x = take(da.res_pdf)
    return x_dst, x_src, res_x


def _res_sum(da, kind, vals):
    """The residual arcs' values (B, R_pad) summed into their states
    (B, S_pad) in the plan's fixed order."""
    B = vals.shape[0]
    return da.plan(kind, da.s_pad).apply(vals.reshape(1, -1)).view(B, -1)


def forward_prob_dense(px, lengths, da: DenseListArrays, leaky_coefficient,
                       ems=None, blocks=None):
    """The alpha sweep; px (B, T, P).  Returns (alpha_dash (T+1, B, S_pad),
    alpha_sums (T+1, B), objf (B,), tot_prob (B,), w1a (T, B, S_pad)),
    w1a[t] = W1 @ alpha_dash[t], which the beta sweep reuses."""
    B, T, _ = px.shape
    x_dst_all, x_src_all, res_x_all = ems or _emissions(px, da)
    bl = blocks or _Blocks(da)
    has_res = da.res_src.shape[1] > 0
    alpha0 = da.initial
    s0 = alpha0.sum(dim=1)
    ad0 = alpha0 + leaky_coefficient * s0[:, None] * da.leaky
    ad_prev, s_prev, ad_last = ad0, s0, ad0
    loglike = torch.log(s0)
    ad_ys, s_ys, w1a = [ad0], [s0], []
    for t in range(1, T + 1):
        w1_a = bl.mv(bl.w1, ad_prev)
        w1a.append(w1_a)
        a = x_dst_all[t - 1] * w1_a + bl.mv(bl.w2, x_src_all[t - 1] * ad_prev)
        if has_res:
            vals = (torch.gather(ad_prev, 1, da.res_src) * da.res_prob
                    * res_x_all[t - 1])
            a = a + _res_sum(da, "res_dst", vals)
        a = a / s_prev[:, None]
        s_t = a.sum(dim=1)
        ad_t = a + leaky_coefficient * s_t[:, None] * da.leaky
        active = t <= lengths
        loglike = loglike + torch.where(
            t < lengths, torch.log(torch.where(s_t > 0, s_t, 1.0)), 0.0)
        ad_prev = torch.where(active[:, None], ad_t, ad_prev)
        s_prev = torch.where(active, s_t, s_prev)
        ad_last = torch.where((t == lengths)[:, None], ad_prev, ad_last)
        ad_ys.append(ad_prev)
        s_ys.append(s_prev)
    tot_prob = (ad_last * da.final).sum(dim=1)
    return (torch.stack(ad_ys), torch.stack(s_ys),
            loglike + torch.log(tot_prob), tot_prob, w1a)


def backward_prob_dense(px, lengths, da: DenseListArrays, leaky_coefficient,
                        alpha_dash, alpha_sums, tot_prob, ems=None,
                        blocks=None, w1a=None):
    """The beta sweep and the posteriors.  The per-dst (c1), per-src (c2)
    and residual (cr) masses are kept in state space and summed into pdf
    space once, after the sweep.  Returns (gamma (B, T, P), alpha_beta
    (B, T), gamma_sum (B, T))."""
    B, T, P = px.shape
    x_dst_all, x_src_all, res_x_all = ems or _emissions(px, da)
    bl = blocks or _Blocks(da)
    has_res = da.res_src.shape[1] > 0
    bd_final = da.final / tot_prob[:, None]
    bd_next = torch.zeros_like(alpha_dash[0])
    masses, abs_, gss = [None] * T, [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        x_dst, x_src = x_dst_all[t], x_src_all[t]
        ad_t, s_t = alpha_dash[t], alpha_sums[t]
        bd_eff = torch.where((lengths == t + 1)[:, None], bd_final, bd_next)
        b_next = bd_eff + leaky_coefficient * (
            (bd_eff * da.leaky).sum(dim=1, keepdim=True))
        inv_s = 1.0 / s_t[:, None]
        xb = x_dst * b_next
        w1t_term = bl.mvt(bl.w1, xb)
        w2t_term = bl.mvt(bl.w2, b_next)
        bd_t = (w1t_term + x_src * w2t_term) * inv_s
        w1_fwd = w1a[t] if w1a is not None else bl.mv(bl.w1, ad_t)
        c1 = xb * w1_fwd * inv_s
        c2 = x_src * ad_t * w2t_term * inv_s
        if has_res:
            vf = (da.res_prob * torch.gather(b_next, 1, da.res_dst)
                  * res_x_all[t])
            bd_t = bd_t + _res_sum(da, "res_src", vf) * inv_s
            cr = vf * torch.gather(ad_t, 1, da.res_src) * inv_s
        else:
            cr = c1.new_zeros((B, 0))
        active = (t < lengths)[:, None]
        bd_next = torch.where(active, bd_t, bd_eff)
        c1 = torch.where(active, c1, 0.0)
        c2 = torch.where(active, c2, 0.0)
        cr = torch.where(active, cr, 0.0)
        abs_[t] = (ad_t * bd_next).sum(dim=1)
        gss[t] = c1.sum(dim=1) + c2.sum(dim=1) + cr.sum(dim=1)
        masses[t] = (torch.cat([c1 + c2, cr], 1) if da.x_same
                     else torch.cat([c1, c2, cr], 1))
    m = torch.stack(masses)                         # (T, B, n)
    gamma = da.plan("gamma", P).apply(m.view(T, -1)).view(T, B, P)
    return (gamma.transpose(0, 1), torch.stack(abs_, dim=1),
            torch.stack(gss, dim=1))


def forward_backward_prob_dense(px, lengths, da: DenseListArrays,
                                leaky_coefficient=1e-5) -> FwdBwdResult:
    """Fused forward and backward over the batched dense graphs.  px
    (B, T, P) is the exp'd nnet output; gamma comes back (B, T, P)."""
    if da.device != px.device:
        raise ValueError(f"graph on {da.device} but x on {px.device}")
    if da.n_pdfs > px.shape[2]:
        raise ValueError(f"graphs emit pdfs up to {da.n_pdfs - 1} but px "
                         f"has {px.shape[2]} columns")
    with torch.no_grad(), ieee_float32():
        px = px.float()
        lengths = host_to(torch.as_tensor(lengths), px.device).long()
        ems = _emissions(px, da)
        bl = _Blocks(da)
        alpha_dash, alpha_sums, objf, tot_prob, w1a = forward_prob_dense(
            px, lengths, da, leaky_coefficient, ems=ems, blocks=bl)
        gamma, alpha_beta, gamma_sum = backward_prob_dense(
            px, lengths, da, leaky_coefficient, alpha_dash, alpha_sums,
            tot_prob, ems=ems, blocks=bl, w1a=w1a)
    return FwdBwdResult(objf, gamma, _ok_flags(objf, alpha_beta, gamma_sum),
                        alpha_beta, gamma_sum)
