"""Viterbi best path / forced alignment over log-domain graphs.

The port's counterpart of ``pychain_tpu/ops/viterbi.py``: the max-plus
(tropical) counterpart of the forward-backward engines, which closes the
flat-start -> align -> constrained-training loop with
``graphs/builder.py`` (``durations_from_alignment``,
``make_constrained_numerator``) and serves phone decoding
(``decode.PhoneDecoder``).

Graphs are read in the semiring engine's arc-id form
(:class:`~.semiring.SemiringArrays`), the same arrays the loss uses: a
list batch has B rows, a shared graph one row broadcast over the batch.
A state's backpointer is the HIGHEST arc id achieving its max
(``viterbi.py:86-92`` of the JAX package), whose ids are positions in the
compiler's backward lists.  Those lists are a stable sort of the forward
arcs by destination (``graphs/compiler.py``), and so are the arc-id
form's in-arc lists (``in_ptr``/``in_arcs``): each state's in-arcs are
the same arcs in the same order, so the last one achieving the max, and
with it every path, score and end state, is the same in either
numbering.

:func:`viterbi_plain` is the PLAIN VERSION of the CUDA kernel of
``ops/viterbi_kernels.py``: the JAX scatter sweep (``viterbi.py:404-417``)
as an eager frame loop, then the shared tail (``_finish``, :431-464):
end scoring, traceback, -1 masking.  Both clamp each emission to
[-30, 30] as they read it (NaN passes, as in ``torch.clamp``), so x is
never copied.  :func:`viterbi_align` is the entry point.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..graph import ChainGraphBatch
from ..utils.device import host_to
from .fwdbwd import GraphArrays
from .semiring import SemiringArrays

NEG_INF = float("-inf")
CLAMP = 30.0  # as chain_function (loss.py)


class ViterbiResult(NamedTuple):
    objf: torch.Tensor    # (B,) best-path log-likelihood (-inf: no path)
    pdfs: torch.Tensor    # (B, T) int32 pdf per frame, -1 beyond length
    states: torch.Tensor  # (B, T) int32 state after each frame, -1 beyond
    ok: torch.Tensor      # (B,) bool, objf finite


# ----------------------------------------------------------------------
# The plain version
# ----------------------------------------------------------------------

def _rows(g: SemiringArrays, B: int, *names):
    """The named arrays of g as B rows (views of a shared row), ids as
    int64."""
    if g.rows not in (1, B):
        raise ValueError(f"graph arrays have {g.rows} rows, the batch {B}")
    out = [getattr(g, n).expand(B, -1) for n in names]
    return [v.long() if v.dtype == torch.int32 else v for v in out]


def _ext(v):
    """v (B, S) with a -inf column at S_pad, the padded arcs' state."""
    return torch.cat([v, torch.full_like(v[:, :1], NEG_INF)], dim=1)


def _sweep(x, lengths, g: SemiringArrays):
    """The max-plus recurrence over every frame (the kernel's sweep).
    x (B, T, P) float32, lengths (B,) int64.  Returns delta at each
    sequence's last frame (B, S_pad) (the initial scores at length 0) and
    the arc backpointers (T, B, S_pad) int32: the highest arc id achieving
    each state's max, -1 where the max is -inf."""
    B, T, _ = x.shape
    S, K = g.num_states, g.k_pad
    src, dst, pdf, logp, initial = _rows(g, B, "src", "dst", "pdf", "logp",
                                         "initial")
    arc_ids = torch.arange(K, device=x.device).expand(B, K)
    delta = initial.clone()
    delta_end = delta.clone()
    bps = []
    for t in range(T):
        em = torch.clamp(torch.gather(x[:, t], 1, pdf), -CLAMP, CLAMP)
        # (delta[src] + logp) + em: the association of every sweep, so
        # the scores agree to the bit
        cand = (torch.gather(_ext(delta), 1, src) + logp) + em
        new = torch.full((B, S + 1), NEG_INF, dtype=cand.dtype,
                         device=x.device).scatter_reduce_(
            1, dst, cand, "amax", include_self=False)
        winner = cand == torch.gather(new, 1, dst)
        bp = torch.full((B, S + 1), -1, dtype=torch.long,
                        device=x.device).scatter_reduce_(
            1, dst, torch.where(winner, arc_ids, -1), "amax",
            include_self=False)
        new = new[:, :S]
        bps.append(torch.where(new > NEG_INF, bp[:, :S], -1).int())
        delta_end = torch.where((lengths == t + 1)[:, None], new, delta_end)
        delta = new
    return delta_end, torch.stack(bps)


def _finish(lengths, delta_end, bps, g: SemiringArrays) -> ViterbiResult:
    """End scoring and traceback (``viterbi.py:431-464``): the best end
    state is the LOWEST state of the max (``jnp.argmax``), objf is -inf
    at length 0, pdfs and states are -1 past each length and wherever
    objf is not finite."""
    T, B, S = bps.shape
    K = g.k_pad
    src, pdf, final = _rows(g, B, "src", "pdf", "final")
    end = delta_end + final
    top = end.amax(dim=1, keepdim=True)
    sid = torch.arange(S, device=end.device).expand(B, S)
    best_end = torch.where(end == top, sid, S).amin(dim=1)
    objf = torch.gather(end, 1, best_end[:, None])[:, 0]
    objf = torch.where(lengths > 0, objf, torch.full_like(objf, NEG_INF))
    c = best_end
    pdfs, states = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        c = torch.where(lengths == t + 1, best_end, c)
        arc = torch.gather(bps[t], 1, c[:, None])[:, 0].long()
        arc_safe = arc.clamp(0, K - 1)[:, None]
        valid = (t < lengths) & (arc >= 0)
        pdfs[t] = torch.where(valid, torch.gather(pdf, 1, arc_safe)[:, 0], -1)
        states[t] = torch.where(valid, c, -1)
        c = torch.where(valid, torch.gather(src, 1, arc_safe)[:, 0], c)
    ok = torch.isfinite(objf)
    pdfs = torch.where(ok[:, None], torch.stack(pdfs, dim=1), -1).int()
    states = torch.where(ok[:, None], torch.stack(states, dim=1), -1).int()
    return ViterbiResult(objf=objf, pdfs=pdfs, states=states, ok=ok)


def viterbi_plain(x, lengths, g: SemiringArrays) -> ViterbiResult:
    """Best paths, plain PyTorch.  x (B, T, P) float32 log-likelihoods
    (clamped here, as read), lengths (B,) in [0, T]."""
    lengths = host_to(torch.as_tensor(lengths), x.device).long()
    delta_end, bps = _sweep(x, lengths, g)
    return _finish(lengths, delta_end, bps, g)


def _from_graph_arrays(ga: GraphArrays) -> SemiringArrays:
    """The arc-id form of a log-domain GraphArrays (its ``bwd_*`` arcs:
    the in-arc lists are their runs), built once and kept with it."""
    if ga.leaky is not None:
        raise ValueError("viterbi_align needs a log-domain graph "
                         "(numerator supervision), got a prob-domain one")
    key = ("semiring", ga.device)
    if key not in ga.plans:
        from ..convert import viterbi_from_numpy
        ga.plans[key] = viterbi_from_numpy(ga.to("cpu"), ga.device)
    return ga.plans[key]


# ----------------------------------------------------------------------
# The entry point
# ----------------------------------------------------------------------

def viterbi_align(x, x_lengths, graphs, emission_mode: str = "auto",
                  dense_sweep: bool | None = None,
                  sweep: str = "auto") -> ViterbiResult:
    """Best path of each sequence through its (log-domain) graph.

    x (B, T, P) nnet log-likelihoods (a tensor; the device it lies on
    runs the sweep), x_lengths (B,) in [0, T], graphs a log-domain
    ``ChainGraphBatch`` (list or shared), the gather engine's
    ``GraphArrays`` of one (its arc-id form: the same kernel) or
    :class:`SemiringArrays` with B rows or one on x's device.  Returns per-frame pdf ids and states
    along the single best path: the max-plus counterpart of
    ``chain_function``.

    ``sweep``: ``"auto"`` runs the CUDA kernel on CUDA tensors (its plain
    version on the CPU); ``"scatter"`` asks for the plain version on any
    device.  The other names are the JAX package's, kept for its callers:
    ``"pallas"`` is ``"auto"``, ``"dense"`` and ``dense_sweep=`` (either
    value) are ``"scatter"``.  The JAX package's sweeps and its
    ``emission_mode`` differ in how a TPU builds the (B, T, K) emission
    table; the kernel reads ``x[b, t, pdf]`` itself and no such table is
    built, so ``emission_mode`` is validated and has no effect.
    """
    from .viterbi_kernels import viterbi_kernel   # it imports this module
    if emission_mode not in ("auto", "onehot", "gather"):
        raise ValueError(f"unknown emission_mode {emission_mode!r}")
    if sweep not in ("auto", "dense", "scatter", "pallas"):
        raise ValueError(f"unknown sweep {sweep!r}")
    if dense_sweep is not None:        # legacy knob: True/False pins
        sweep = "dense" if dense_sweep else "scatter"
    g = graphs
    if isinstance(graphs, ChainGraphBatch):
        g = graphs.semiring()
        if g is None:
            raise ValueError("viterbi_align needs a log-domain graph "
                             "(numerator supervision), got a prob-domain "
                             "one")
        if x.shape[0] != graphs.batch_size:
            raise ValueError(f"input batch size ({x.shape[0]}) does not "
                             f"equal the graph batch size "
                             f"({graphs.batch_size})")
    elif isinstance(graphs, GraphArrays):
        g = _from_graph_arrays(graphs)
    elif not isinstance(graphs, SemiringArrays):
        raise TypeError("graphs must be a ChainGraphBatch, GraphArrays or "
                        f"SemiringArrays, got {type(graphs).__name__}")
    B, T, P = x.shape
    if g.rows not in (1, B):
        raise ValueError(f"graph arrays have {g.rows} rows, the batch {B}")
    if g.n_pdfs > P:
        raise ValueError(f"graphs reference pdf ids up to {g.n_pdfs - 1} "
                         f"but the nnet output has only {P} columns")
    if x.device.type != g.device.type:
        raise ValueError(f"x is on {x.device} but the graphs are on "
                         f"{g.device}")
    lens = torch.as_tensor(x_lengths).cpu().long()
    if lens.shape != (B,):
        raise ValueError(f"x_lengths has shape {tuple(lens.shape)}, want "
                         f"({B},)")
    if B and int(lens.max()) > T:
        raise ValueError(f"x_lengths (max {int(lens.max())}) exceed the "
                         f"padded frame axis T={T}")
    if B and int(lens.min()) < 0:
        raise ValueError("x_lengths must be >= 0")
    with torch.no_grad():
        x = x.float()
        if sweep in ("dense", "scatter"):
            return viterbi_plain(x, lens, g)
        return viterbi_kernel(x, lens, g)
