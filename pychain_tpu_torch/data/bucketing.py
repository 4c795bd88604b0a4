"""Length bucketing: a few batch shapes, minimal padding.

The port's copy of ``pychain_tpu/data/bucketing.py`` (numpy only, the
same shuffle stream: given the same lengths, seed and epoch it yields the
same batches).  The reference handles unequal lengths with
``pack_padded_sequence`` and requires every minibatch sorted by
decreasing length (loss.py:37-40, graph.py:177-194 ``reorder``).  This
module quantises utterance lengths into a small fixed set of bucket
shapes, with length masks absorbing the residual padding: no sorting,
and a few (B, T) shapes, so the kernels' per-shape set-up (graph
layouts, the caching allocator's blocks) is reused across batches.

Typical use::

    bucketer = LengthBucketer(BucketSpec.geometric(min_t=128, max_t=2048))
    for batch_idx in bucketer.batches(lengths, batch_size=64):
        T_pad = bucketer.bucket_for(lengths[batch_idx].max())
        feats = pad_to_bucket(raw_feats, batch_idx, T_pad)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np


@dataclass(frozen=True)
class BucketSpec:
    """A sorted tuple of padded lengths (bucket boundaries)."""

    lengths: tuple

    @staticmethod
    def geometric(min_t: int = 128, max_t: int = 2048,
                  growth: float = 1.4) -> "BucketSpec":
        """Geometric bucket ladder: padding overhead bounded by `growth`."""
        out = [min_t]
        while out[-1] < max_t:
            out.append(min(int(np.ceil(out[-1] * growth)), max_t))
        return BucketSpec(tuple(out))

    @staticmethod
    def linear(step: int = 100, max_t: int = 2000) -> "BucketSpec":
        """Linear ladder; always covers max_t even when step does not
        divide it (otherwise utterances of length in (last_rung, max_t]
        would overflow the top bucket and pad_to_bucket would raise)."""
        rungs = list(range(step, max_t + 1, step))
        if not rungs or rungs[-1] < max_t:
            rungs.append(max_t)
        return BucketSpec(tuple(rungs))

    def bucket_for(self, t: int) -> int:
        """Smallest bucket >= t (clamps to the largest bucket)."""
        for b in self.lengths:
            if t <= b:
                return b
        return self.lengths[-1]


class LengthBucketer:
    """Groups utterances into same-bucket minibatches.

    Greedy: sort by length, emit contiguous groups of ``batch_size``; all
    members of a group share a bucket shape, so padding waste is bounded
    by the bucket ladder's growth factor.  Unlike the reference, batches
    do NOT need to stay sorted afterwards (masks handle order).
    """

    def __init__(self, spec: BucketSpec, shuffle: bool = True, seed: int = 0):
        self.spec = spec
        self.shuffle = shuffle
        self.seed = seed

    def bucket_for(self, t: int) -> int:
        return self.spec.bucket_for(int(t))

    def batches(self, lengths: Sequence[int], batch_size: int,
                epoch: int = 0) -> Iterator[np.ndarray]:
        """Yield index arrays of size <= batch_size, grouped by length.

        ``epoch`` folds into the shuffle stream: different epochs (with
        the same constructor seed) produce different group orders and
        different intra-group permutations.
        """
        lengths = np.asarray(lengths)
        order = np.argsort(lengths, kind="stable")
        groups = [order[i:i + batch_size]
                  for i in range(0, len(order), batch_size)]
        if self.shuffle:
            rng = np.random.RandomState(
                (self.seed * 2654435761 + epoch) % (2**31 - 1))
            rng.shuffle(groups)
        for g in groups:
            if self.shuffle:
                g = g.copy()
                rng.shuffle(g)
            yield g

    def padded_shape(self, lengths: Sequence[int],
                     idx: np.ndarray) -> int:
        return self.bucket_for(int(np.asarray(lengths)[idx].max()))


def pad_to_bucket(features, idx, t_pad: int, pad_value: float = 0.0):
    """Gather ``features[i]`` (list of (T_i, D) arrays) for ``idx`` and
    pad to a (len(idx), t_pad, D) batch.

    Raises if any utterance is longer than ``t_pad``: silently
    truncating would desynchronise the features from linear/leveled
    numerator supervision (whose graph length must equal the utterance
    length), turning the loss into -inf with no diagnostic.
    """
    idx = np.asarray(idx)
    d = np.asarray(features[int(idx[0])]).shape[-1]
    out = np.full((len(idx), t_pad, d), pad_value, np.float32)
    lengths = np.zeros(len(idx), np.int32)
    for row, i in enumerate(idx):
        f = np.asarray(features[int(i)], np.float32)
        if f.shape[0] > t_pad:
            raise ValueError(
                f"utterance {int(i)} has {f.shape[0]} frames > bucket "
                f"shape {t_pad}; enlarge the bucket ladder (max_t) or "
                f"filter/chunk long utterances upstream")
        t = f.shape[0]
        out[row, :t] = f[:t]
        lengths[row] = t
    return out, lengths
