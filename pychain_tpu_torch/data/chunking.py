"""Fixed-width chunked chain training — the standard Kaldi chain
recipe practice the reference leaves to its host trainer.

The port's copy of ``pychain_tpu/data/chunking.py``, over the port's
``graphs/builder.py`` and ``graphs/fst.py``.

Real chain training rarely feeds whole utterances: Kaldi's
``nnet3-chain-get-egs`` splits each aligned utterance into fixed-width
chunks (~1.5 s) with per-chunk supervision, so every minibatch has ONE
static shape (no bucket ladder) and arbitrary-length
audio trains in O(chunk) memory.  The leaky-HMM denominator is built
for exactly this: its ``initial_mode='leaky'`` priors describe "the
chain may start anywhere", which is what a mid-utterance chunk needs.

:func:`chunk_alignment` splits an aligned utterance (phones +
durations) into chunk supervision plans; pair each with
``make_constrained_numerator(..., tolerance, first_is_continuation)``
(boundary-tolerant: the semiring kernels) or
``alignment_to_pdf_sequence`` + ``FST.linear`` (exact: the closed form).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graphs.builder import (ChainTopology, alignment_to_pdf_sequence,
                              make_constrained_numerator)
from ..graphs.fst import FST


@dataclass(frozen=True)
class ChunkPlan:
    """Supervision plan for one chunk of an aligned utterance."""
    start_frame: int          # chunk's first frame in the utterance
    num_frames: int           # chunk width (== requested, except last)
    phones: tuple             # phones overlapping the chunk
    durations: tuple          # their frame counts INSIDE the chunk
    first_is_continuation: bool  # chunk starts mid-phone


def chunk_alignment(phones, durations, chunk_frames: int,
                    min_tail: int = 0) -> list:
    """Split an aligned utterance into fixed-width chunk plans.

    Chunks tile the utterance left to right; the final partial chunk is
    kept if it has at least ``min_tail`` frames (0 keeps everything —
    pad it to the chunk width and pass the true length, as usual).
    """
    phones = [int(p) for p in phones]
    durations = [int(d) for d in durations]
    if len(phones) != len(durations):
        raise ValueError("phones and durations must have equal length")
    if any(d < 1 for d in durations):
        raise ValueError("every phone needs at least one frame")
    if chunk_frames < 1:
        raise ValueError("chunk_frames must be >= 1")
    T = int(sum(durations))
    ends = np.cumsum(durations)              # phone i covers [ends[i-1], ends[i])
    plans = []
    t0 = 0
    while t0 < T:
        t1 = min(t0 + chunk_frames, T)
        if t1 < t0 + chunk_frames and (t1 - t0) < min_tail and plans:
            break                            # drop a too-short tail
        i0 = int(np.searchsorted(ends, t0, side="right"))
        i1 = int(np.searchsorted(ends, t1 - 1, side="right"))
        ph, du = [], []
        for i in range(i0, i1 + 1):
            lo = t0 if i == i0 else int(ends[i - 1])
            hi = min(int(ends[i]), t1)
            ph.append(phones[i])
            du.append(hi - lo)
        starts_mid = t0 > (int(ends[i0 - 1]) if i0 > 0 else 0)
        plans.append(ChunkPlan(start_frame=t0, num_frames=t1 - t0,
                               phones=tuple(ph), durations=tuple(du),
                               first_is_continuation=starts_mid))
        t0 = t1
    return plans


def chunk_supervision(plan: ChunkPlan, topo: ChainTopology,
                      tolerance: int = 0) -> FST:
    """Supervision FST for one chunk: exact aligned linear chain at
    tolerance 0 (closed-form engine), boundary-tolerant banded graph
    otherwise (the semiring kernels in the port)."""
    if tolerance == 0:
        seq = alignment_to_pdf_sequence(
            plan.phones, plan.durations, topo,
            first_is_continuation=plan.first_is_continuation)
        return FST.linear(seq)
    return make_constrained_numerator(
        plan.phones, plan.durations, topo, tolerance=tolerance,
        first_is_continuation=plan.first_is_continuation)
