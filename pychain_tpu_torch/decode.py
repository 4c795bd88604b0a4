"""Phone-level Viterbi decoding: model evaluation.

The port's counterpart of ``pychain_tpu/decode.py``.  It composes what
the package already has: the LM∘topology graph of :mod:`graphs.builder`
(built in the LOG domain so the max-plus sweep applies) and
:func:`ops.viterbi.viterbi_align`.  The best path's forward-pdf arcs mark
phone entries, so the pdf sequence decodes directly into phones and
durations (read on the host, as in the JAX package).

This is phone recognition against the training phone LM, the native
counterpart of Kaldi's ``decode.sh`` for LF-MMI phone models, not a
word-level WFST decoder.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .graph import ChainGraph, ChainGraphBatch
from .graphs.builder import ChainTopology, PhoneLM, make_denominator_fst
from .ops.viterbi import viterbi_align

__all__ = ["DecodeResult", "PhoneDecoder", "edit_distance",
           "phone_error_rate"]


class DecodeResult(NamedTuple):
    phones: list        # per utterance: list[int] decoded phone sequence
    durations: list     # per utterance: list[int] frames per phone
    scores: np.ndarray  # (B,) best-path log-likelihood


class PhoneDecoder:
    """Reusable decoder over an LM∘topology graph.

    The graph is built once (log domain, broadcast across the batch);
    ``__call__`` takes the model's (B, T, P) log-likelihood output and
    per-sequence lengths, and decodes on the device x lies on.
    """

    def __init__(self, lm: PhoneLM, topo: ChainTopology,
                 prune_prob: float = 0.0):
        if topo.shared_pdfs:
            raise ValueError(
                "decoding requires the non-shared topology (distinct "
                "forward/self-loop pdfs mark the phone boundaries)")
        self.topo = topo
        fst = make_denominator_fst(lm, topo, prune_prob=prune_prob)
        self.graph = ChainGraph(fst, log_domain=True)
        self._batches = {}  # (batch_size, device) -> ChainGraphBatch

    def __call__(self, x: torch.Tensor, x_lengths) -> DecodeResult:
        B = x.shape[0]
        key = (B, x.device)
        if key not in self._batches:
            self._batches[key] = ChainGraphBatch(self.graph, B,
                                                 device=x.device)
        res = viterbi_align(x, x_lengths, self._batches[key])
        lengths = torch.as_tensor(x_lengths).cpu().numpy()
        pdfs = res.pdfs.cpu().numpy()
        phones, durations = [], []
        for b in range(B):
            seq = pdfs[b, :int(lengths[b])]
            ph, dur = [], []
            for p in seq:
                if p < 0:
                    continue
                if p % 2 == 0:                   # forward pdf: new phone
                    ph.append(int(p) // 2)
                    dur.append(1)
                elif dur:                        # self-loop pdf
                    dur[-1] += 1
            phones.append(ph)
            durations.append(dur)
        return DecodeResult(phones=phones, durations=durations,
                            scores=res.objf.cpu().numpy())


def edit_distance(ref, hyp) -> int:
    """Levenshtein distance between two sequences (for PER)."""
    m, n = len(ref), len(hyp)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1,
                         prev[j - 1] + (ref[i - 1] != hyp[j - 1]))
        prev = cur
    return prev[n]


def phone_error_rate(refs, hyps) -> float:
    """Total edit distance over total reference length."""
    errs = sum(edit_distance(r, h) for r, h in zip(refs, hyps))
    total = sum(len(r) for r in refs)
    return errs / max(total, 1)
