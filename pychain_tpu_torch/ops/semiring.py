"""Log-semiring forward-backward for arbitrary numerator graphs.

The port's counterpart of ``pychain_tpu/ops/semiring.py`` and of the
host side of ``ops/pallas_semiring.py`` / ``ops/semiring_xl.py``.  It
serves every log-domain LIST batch that is not a linear chain: cyclic,
self-loop and DAG supervisions, among them the flat-start numerators of
``graphs/builder.make_numerator_fst``.

Graphs are held in **arc-id form** (:class:`SemiringArrays`), the layout
of the JAX package's ``SemiringXLArrays``: (B, K_pad) source, destination
and pdf ids and log-probs, (B, S_pad) initial and final log-probs, plus
host-built per-graph lists the CUDA kernels walk (in-arcs by destination
state, out-arcs by source state, arcs by pdf; CSR offsets local to each
graph, arc ids ascending within each list).  The (B, K, S) one-hots of
the JAX dense engine are a TPU matrix-unit device and are not built.

The recurrence is the select-free normalised-linear scheme of
``pallas_semiring.py:18-36`` (the reference's log-domain recurrences,
chain-log-domain-computation.cc, with the per-frame scale carried
explicitly): arc weights ``exp(logp + x[pdf] - c_t)`` max-shifted per
(sequence, frame); alpha divided by its sum every frame; beta divided by
its max with the log scale carried; the final-frame beta injected at
each sequence's own length; dead mass as exact zeros.

Precision: the TPU kernels run this in float32 throughout.  At the
flat-start size (T=500, 100-150 phones) float32 loses the mass of the
posterior's states, which sit far below alpha's and beta's own scales:
up to 1.7e-2 in gamma against a float64 run (PERF.md).  So the
carries (alpha, beta, their sums and log scales, the occupancies) are
float64 here and in the kernels; the arc weights stay in x's float type
and the results are float32.

:func:`forward_backward_semiring` is the PLAIN VERSION of the two CUDA
kernels of ``ops/semiring_kernels.py``: the same arithmetic written as
eager PyTorch with a Python loop over frames (per-frame gathers, and a
``scatter_add_`` that sums each list in ascending arc order).  The glue
around the sweeps (:func:`prepare`, :func:`objective`) is shared by both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import host_to
from .fwdbwd import FwdBwdResult, _ok_flags

NEG_INF = float("-inf")
TINY = 1e-37        # normalisation floor (pallas_semiring.py:62), normal in
                    # float32 too: a subnormal floor flushes to zero under
                    # FTZ, making log(max(m, TINY)) = -inf and the
                    # injection NaN
EXP_CLAMP = 80.0    # cap on an occupancy's log (a consistent one is <= 0)


@dataclasses.dataclass(eq=False)
class SemiringArrays:
    """Batched arbitrary log-domain graphs in arc-id form.

    ``src``/``dst`` are padded with S_pad (an out-of-range state) and
    ``logp`` with -inf, so padded arcs are inert; they appear in no list.
    Each ``*_ptr`` row holds CSR offsets into the same row of its
    ``*_arcs`` (arc ids of that graph, ascending within each list)."""
    src: torch.Tensor       # (B, K_pad) int32
    dst: torch.Tensor       # (B, K_pad) int32
    pdf: torch.Tensor       # (B, K_pad) int32, 0 on padding
    logp: torch.Tensor      # (B, K_pad) float32, -inf on padding
    initial: torch.Tensor   # (B, S_pad) float32 log initial probs
    final: torch.Tensor     # (B, S_pad) float32 log final probs
    in_ptr: torch.Tensor    # (B, S_pad + 1) int32: in-arcs by destination
    in_arcs: torch.Tensor   # (B, K_pad) int32
    out_ptr: torch.Tensor   # (B, S_pad + 1) int32: out-arcs by source
    out_arcs: torch.Tensor  # (B, K_pad) int32
    pdf_ptr: torch.Tensor   # (B, n_pdfs + 1) int32: arcs by pdf
    pdf_arcs: torch.Tensor  # (B, K_pad) int32
    max_in_degree: int      # the longest in-list, counted on the host
                            # (after take: the whole batch's, a bound)

    @property
    def device(self) -> torch.device:
        return self.logp.device

    @property
    def rows(self) -> int:
        """B, or 1 for a shared graph (``viterbi_align`` broadcasts it)."""
        return int(self.src.shape[0])

    @property
    def num_states(self) -> int:
        return int(self.initial.shape[1])

    @property
    def k_pad(self) -> int:
        return int(self.src.shape[1])

    @property
    def n_pdfs(self) -> int:
        """Number of pdf lists: one more than the largest pdf any arc emits."""
        return int(self.pdf_ptr.shape[1]) - 1

    def _tensors(self):
        return [f.name for f in dataclasses.fields(self)
                if f.name != "max_in_degree"]

    def to(self, device) -> "SemiringArrays":
        return dataclasses.replace(self, **{
            n: host_to(getattr(self, n), device) for n in self._tensors()})

    def take(self, index) -> "SemiringArrays":
        """The batch rows ``index`` (every list is local to its row, so
        the graphs and their lists move together)."""
        idx = torch.as_tensor(np.asarray(index), dtype=torch.long,
                              device=self.device)
        return dataclasses.replace(self, **{
            n: getattr(self, n).index_select(0, idx)
            for n in self._tensors()})


def _lists(key: np.ndarray, valid: np.ndarray, n_rows: int):
    """Per-row CSR lists of the arcs grouped by ``key`` (B, K): offsets
    (B, n_rows + 1) and arc ids (B, K), ascending within each group;
    arcs not ``valid`` sort last and belong to no group."""
    B, K = key.shape
    k = np.where(valid, key, n_rows).astype(np.int64)
    order = np.argsort(k, axis=1, kind="stable")
    flat = (k + np.arange(B)[:, None] * (n_rows + 1)).ravel()
    counts = np.bincount(flat, minlength=B * (n_rows + 1)).reshape(
        B, n_rows + 1)
    ptr = np.zeros((B, n_rows + 1), np.int64)
    np.cumsum(counts[:, :n_rows], axis=1, out=ptr[:, 1:])
    return ptr.astype(np.int32), order.astype(np.int32)


def semiring_from_ids(src, dst, pdf, logp, initial, final) -> SemiringArrays:
    """SemiringArrays (CPU tensors) from numpy arc-id arrays: src/dst
    (B, K_pad) padded with S_pad, pdf (B, K_pad), logp (B, K_pad),
    initial/final (B, S_pad).  Builds the kernels' lists, vectorised over
    the batch (list batches are rebuilt every minibatch)."""
    src, dst, pdf = (np.array(a, np.int32) for a in (src, dst, pdf))
    logp, initial, final = (np.array(a, np.float32)
                            for a in (logp, initial, final))
    s_pad = initial.shape[1]
    valid = src < s_pad
    n_pdfs = int(pdf[valid].max()) + 1 if valid.any() else 1
    in_ptr, in_arcs = _lists(dst, valid, s_pad)
    out_ptr, out_arcs = _lists(src, valid, s_pad)
    pdf_ptr, pdf_arcs = _lists(pdf, valid, n_pdfs)
    t = torch.from_numpy
    return SemiringArrays(
        src=t(src), dst=t(dst), pdf=t(np.where(valid, pdf, 0)),
        logp=t(logp), initial=t(initial), final=t(final),
        in_ptr=t(in_ptr), in_arcs=t(in_arcs), out_ptr=t(out_ptr),
        out_arcs=t(out_arcs), pdf_ptr=t(pdf_ptr), pdf_arcs=t(pdf_arcs),
        max_in_degree=int(np.diff(in_ptr, axis=1).max(initial=0)))


def semiring_arrays(graphs, max_k: int, max_s: int) -> SemiringArrays:
    """Compile a list of log-domain ChainGraphs (CPU tensors), padded to
    K_pad = max_k arcs and S_pad = max_s states."""
    B = len(graphs)
    src = np.full((B, max_k), max_s, np.int32)
    dst = np.full((B, max_k), max_s, np.int32)
    pdf = np.zeros((B, max_k), np.int32)
    logp = np.full((B, max_k), NEG_INF, np.float32)
    initial = np.full((B, max_s), NEG_INF, np.float32)
    final = np.full((B, max_s), NEG_INF, np.float32)
    for i, g in enumerate(graphs):
        k, s = g.num_transitions, g.num_states
        t = g.forward_transitions
        src[i, :k], dst[i, :k], pdf[i, :k] = t[:, 0], t[:, 1], t[:, 2]
        logp[i, :k] = g.forward_transition_probs
        initial[i, :s] = g.initial_probs
        final[i, :s] = g.final_probs
    return semiring_from_ids(src, dst, pdf, logp, initial, final)


# ----------------------------------------------------------------------
# Glue shared by the plain version and the kernels' wrapper
# ----------------------------------------------------------------------

def prepare(x, g: SemiringArrays, row_align: int = 1):
    """Arc weights and the normalised initial state
    (pallas_semiring.py:264-277, semiring_xl.py:642-653).

    Returns warc (B, T, K_pad) = exp(logp + x[pdf] - c) in x's float
    type, c (B, T) the per-(sequence, frame) arc max (0 where no arc is
    alive), n0 (B, S_pad) the initial probs normalised to sum 1 and lz0
    (B,) their log sum, both float64 (the carries' type).  With
    ``row_align`` > 1, warc is a view of storage whose rows are padded to
    a multiple of that many elements (the CUDA kernels' bulk copies)."""
    B, T, _ = x.shape
    K = g.k_pad
    em = torch.gather(x, 2, g.pdf.long()[:, None, :].expand(B, T, K))
    arc = g.logp[:, None, :] + em
    c = arc.amax(dim=2)
    c = torch.where(torch.isfinite(c), c, torch.zeros_like(c))
    kw = -(-K // row_align) * row_align
    warc = torch.empty(B, T, kw, dtype=arc.dtype, device=arc.device)
    warc = torch.exp(arc - c[:, :, None], out=warc[:, :, :K])
    ei = torch.exp(g.initial.double())
    z0 = ei.sum(dim=1)
    lz0 = torch.where(z0 > 0, torch.log(torch.clamp(z0, min=TINY)),
                      torch.zeros_like(z0))
    n0 = ei / torch.clamp(z0, min=TINY)[:, None]
    return warc, c, n0.contiguous(), lz0


def objective(raw, n_last, c, lz0, lengths, g: SemiringArrays):
    """objf from the raw alpha sums and alpha at each sequence's last
    frame, and the backward sweep's inputs (pallas_semiring.py:281-318,
    semiring_xl.py:661-694).

    raw (B, T): sum of the unnormalised alpha of each frame; n_last
    (B, S_pad): normalised alpha(T_b).  Returns objf (B,), rf (B, S_pad)
    the injected final beta (0 for a dead sequence), mf (B,) its log
    scale, c_row (B, T) = c with lz0 added at frame 0, and cms (B, T) =
    c_u - s_{u-1} (s_{-1} := 0) with dead frames floored at log(TINY),
    all float64."""
    B, T = raw.shape
    lengths = lengths.long()
    raw, n_last, c, lz0 = (v.double() for v in (raw, n_last, c, lz0))
    final = g.final.double()
    s_scale = torch.log(torch.clamp(raw, min=TINY)) + c
    s_ys = torch.where(raw > 0, s_scale, torch.full_like(raw, NEG_INF))
    s_ys = torch.cat([s_ys[:, :1] + lz0[:, None], s_ys[:, 1:]], dim=1)
    ts = torch.arange(1, T + 1, device=raw.device)
    ll = torch.where(ts[None, :] < lengths[:, None], s_ys,
                     torch.zeros_like(s_ys)).sum(dim=1)
    s_all = torch.cat([lz0[:, None], s_ys], dim=1)              # (B, T+1)
    s_last = torch.gather(s_all, 1, lengths[:, None])[:, 0]
    fmax = final.amax(dim=1)
    fmaxs = torch.where(torch.isfinite(fmax), fmax, torch.zeros_like(fmax))
    efin = torch.exp(final - fmaxs[:, None])
    tsum = (n_last * efin).sum(dim=1)
    tlp = torch.where(tsum > 0,
                      torch.log(torch.clamp(tsum, min=TINY)) + fmaxs
                      + s_last, torch.full_like(tsum, NEG_INF))
    objf = ll + tlp
    alive = torch.isfinite(tlp)
    rf = torch.where(alive[:, None], efin, torch.zeros_like(efin))
    mf = torch.where(alive, fmaxs - tlp, torch.zeros_like(tlp))
    s_shift = torch.cat([torch.zeros_like(s_scale[:, :1]),
                         s_scale[:, :-1]], dim=1)
    c_row = torch.cat([c[:, :1] + lz0[:, None], c[:, 1:]], dim=1)
    return (objf, rf.contiguous(), mf.contiguous(), c_row.contiguous(),
            (c - s_shift).contiguous())


def package(objf, gamma, alpha_beta) -> FwdBwdResult:
    """The float32 result of either path."""
    objf, gamma, alpha_beta = (v.float() for v in (objf, gamma,
                                                   alpha_beta))
    gamma_sum = gamma.sum(dim=2)
    return FwdBwdResult(objf, gamma, _ok_flags(objf, alpha_beta, gamma_sum),
                        alpha_beta, gamma_sum)


# ----------------------------------------------------------------------
# The plain version of the two sweeps
# ----------------------------------------------------------------------

def _ext(v):
    """v (B, S_pad) with a zero column at S_pad, the padded arcs' state."""
    return torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)


def forward_plain(warc, n0, g: SemiringArrays):
    """The alpha sweep over every frame (semiring_fwd's plain version),
    carried in float64.  Returns the normalised alpha stream n_ys
    (B, T, S_pad) (n_ys[:, t] = alpha(t + 1)) and the raw sums (B, T)."""
    B, T, _ = warc.shape
    S = g.num_states
    src, dst = g.src.long(), g.dst.long()
    n = n0
    n_ys, raws = [], []
    for t in range(T):
        contrib = torch.gather(_ext(n), 1, src) * warc[:, t].double()
        a_lin = torch.zeros(B, S + 1, dtype=n.dtype, device=n.device)
        a_lin = a_lin.scatter_add_(1, dst, contrib)[:, :S]
        raw = a_lin.sum(dim=1)
        n = a_lin * (1.0 / torch.clamp(raw, min=TINY))[:, None]
        n_ys.append(n)
        raws.append(raw)
    return torch.stack(n_ys, dim=1), torch.stack(raws, dim=1)


def backward_plain(warc, n_ys, n0, lengths, rf, mf, c_row, cms,
                   g: SemiringArrays, P: int):
    """The beta sweep (semiring_bwd's plain version), carried in float64:
    gamma (B, T, P) and the alpha*beta trace (B, T), taken as the sum of
    the frame's arc occupancies (semiring_xl.py:350-355; equal to
    sum_s alpha(u) beta(u) in exact arithmetic).  Before a sequence's
    injection frame its carry is exactly 0, so its occupancies and trace
    there are exact zeros."""
    B, T, _ = warc.shape
    S = g.num_states
    src, dst, pdf = g.src.long(), g.dst.long(), g.pdf.long()
    lengths = lengths.long()
    r = torch.zeros_like(rf)
    m = torch.zeros_like(mf)
    gammas, abs_ = [None] * T, [None] * T
    for u in range(T - 1, -1, -1):
        inj = (lengths == u + 1)
        r_eff = torch.where(inj[:, None], rf, r)
        m_eff = torch.where(inj, mf, m)
        vf = warc[:, u].double() * torch.gather(_ext(r_eff), 1, dst)
        b_lin = torch.zeros(B, S + 1, dtype=vf.dtype, device=vf.device)
        b_lin = b_lin.scatter_add_(1, src, vf)[:, :S]
        a_u = n0 if u == 0 else n_ys[:, u - 1]
        # occ = alpha(u)[src] * vf * exp(m_eff + c_u), assembled in log
        # space (as semiring.py:222-225 of the JAX package): a linear
        # product underflows where alpha and beta are each far below
        # their own scale (long sequences), losing whole frames of gamma
        lo = (torch.log(torch.gather(_ext(a_u), 1, src)) + torch.log(vf)
              + (m_eff + c_row[:, u])[:, None])
        occ = torch.exp(torch.clamp(lo, max=EXP_CLAMP))
        abs_[u] = occ.sum(dim=1)
        gammas[u] = torch.zeros(B, P, dtype=occ.dtype,
                                device=occ.device).scatter_add_(1, pdf, occ)
        mx = b_lin.amax(dim=1)
        r = b_lin * (1.0 / torch.clamp(mx, min=TINY))[:, None]
        m = m_eff + cms[:, u] + torch.log(torch.clamp(mx, min=TINY))
    return torch.stack(gammas, dim=1), torch.stack(abs_, dim=1)


def forward_backward_semiring(x, lengths, g: SemiringArrays) -> FwdBwdResult:
    """Fused log-domain fwd+bwd, plain PyTorch.  x (B, T, P) clamped
    log-likelihoods, lengths (B,) in [1, T].  Per-frame arbitrary scale,
    objf at each sequence's own length, -inf objf with zero posteriors
    and ``ok`` False for a sequence with no accepting path."""
    B, T, P = x.shape
    lengths = host_to(torch.as_tensor(lengths), x.device).long()
    x = x.float()
    warc, c, n0, lz0 = prepare(x, g)
    n_ys, raw = forward_plain(warc, n0, g)
    n_at = torch.cat([n0[:, None], n_ys], dim=1)               # (B, T+1, S)
    n_last = n_at[torch.arange(B, device=x.device), lengths]
    objf, rf, mf, c_row, cms = objective(raw, n_last, c, lz0, lengths, g)
    gamma, ab = backward_plain(warc, n_ys, n0, lengths, rf, mf, c_row, cms,
                               g, P)
    return package(objf, gamma, ab)
