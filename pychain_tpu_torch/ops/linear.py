"""Closed-form numerator for linear supervision graphs.

The port's counterpart of ``pychain_tpu/ops/linear.py``.  The standard
chain numerator FST is a linear chain (state t --pdf_t--> state t+1),
whose log-domain forward-backward has exactly ONE path:

    objf_b = sum_{t < T_b} (x[b, t, pdf_t] + logp_t) + final_b
    gamma[b, t, pdf_t] = 1            (t < T_b)

with objf = -inf, gamma = 0 and ok = False when the sequence length
differs from the chain length (no accepting path).  No recurrence, so
no kernel: a gather and a one-hot scatter over the batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .factorized import _move
from .fwdbwd import FwdBwdResult
from ..utils.device import host_to

NEG_INF = float("-inf")


@dataclasses.dataclass(eq=False)
class LinearArrays:
    """Batched linear numerator graphs (log domain)."""
    pdf_seq: torch.Tensor    # (B, Kmax) int64, padded with 0
    logp_seq: torch.Tensor   # (B, Kmax) float32, padded with 0
    final: torch.Tensor      # (B,) float32 log final prob of the end state
    graph_len: torch.Tensor  # (B,) int64 number of arcs per graph

    @property
    def device(self) -> torch.device:
        return self.final.device

    def to(self, device) -> "LinearArrays":
        return _move(self, device)

    def take(self, index) -> "LinearArrays":
        """The batch rows ``index`` (a (B,) tensor or sequence), gathered
        on this batch's device: a corpus staged on the card once yields
        each step's numerators from the step's index alone."""
        idx = torch.as_tensor(index, dtype=torch.long).to(self.device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).index_select(0, idx)
            for f in dataclasses.fields(self)})


def is_linear_graph(g) -> bool:
    """True if a log-domain ChainGraph is a single linear chain.
    Cached on the graph: ChainGraphs are immutable after construction
    and re-batched every minibatch."""
    cached = getattr(g, "_is_linear_cache", None)
    if cached is None:
        cached = _is_linear_graph(g)
        g._is_linear_cache = cached
    return cached


def _is_linear_graph(g) -> bool:
    if not g.log_domain:
        return False
    S, K = g.num_states, g.num_transitions
    if K != S - 1 or g.start_state != 0:
        return False
    t = g.forward_transitions
    if not (np.all(t[:, 0] == np.arange(K))
            and np.all(t[:, 1] == np.arange(1, K + 1))):
        return False
    # only the last state may be final; initial mass only at state 0
    if np.isfinite(g.final_probs[:-1]).any():
        return False
    if not np.isfinite(g.final_probs[-1]):
        return False
    init = np.asarray(g.initial_probs)
    return bool(init[0] == 0.0 and np.all(np.isneginf(init[1:])))


def linear_arrays(graphs, max_k: int) -> LinearArrays:
    """CPU tensors for a list of linear ChainGraphs."""
    B = len(graphs)
    pdf = np.zeros((B, max_k), np.int64)
    logp = np.zeros((B, max_k), np.float32)
    final = np.zeros(B, np.float32)
    glen = np.zeros(B, np.int64)
    for i, g in enumerate(graphs):
        k = g.num_transitions
        pdf[i, :k] = g.forward_transitions[:, 2]
        logp[i, :k] = g.forward_transition_probs
        final[i] = g.final_probs[-1]
        glen[i] = k
    return LinearArrays(pdf_seq=torch.from_numpy(pdf),
                        logp_seq=torch.from_numpy(logp),
                        final=torch.from_numpy(final),
                        graph_len=torch.from_numpy(glen))


def forward_backward_linear(x, lengths, g: LinearArrays) -> FwdBwdResult:
    """Closed-form objf + posteriors.  x: (B, T, P) clamped log-probs."""
    B, T, P = x.shape
    K = g.pdf_seq.shape[1]
    lengths = host_to(torch.as_tensor(lengths), x.device).long()

    kmax = min(K, T)
    pdf = g.pdf_seq[:, :kmax]
    ts = torch.arange(kmax, device=x.device)
    mask = ts[None, :] < lengths[:, None]                 # (B, kmax)

    emis = torch.gather(x[:, :kmax, :], 2, pdf[:, :, None])[..., 0]
    objf = torch.where(mask, emis + g.logp_seq[:, :kmax], 0.0).sum(1) \
        + g.final
    # no accepting path unless the sequence length equals the chain length
    feasible = (lengths == g.graph_len) & (g.graph_len <= T)
    objf = torch.where(feasible, objf, NEG_INF)

    keep = (mask & feasible[:, None]).to(x.dtype)          # (B, kmax)
    gamma = torch.zeros((B, T, P), dtype=x.dtype, device=x.device)
    gamma[:, :kmax, :].scatter_(2, pdf[:, :, None], keep[:, :, None])

    frame_mask = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    alpha_beta = (frame_mask & feasible[:, None]).to(x.dtype)
    gamma_sum = gamma.sum(dim=2)
    ok = feasible & torch.isfinite(objf)
    return FwdBwdResult(objf, gamma, ok, alpha_beta, gamma_sum)
