"""The group that train-mode statistics are taken over, and a sum over
its ranks with a gradient.

The models read :func:`stats_group` and nothing else of data
parallelism: it is None (statistics over this process's rows) until
data parallelism registers its group with :func:`set_stats_group`
(``parallel.multihost.join_job`` for an example's ``--dp``, and
``parallel.ShardedChainLoss`` for its mesh's ``dp`` axis, never its
``mp`` axis, whose ranks hold the same rows).  A process group that
something else started (a user's own DDP job) leaves the models'
statistics local.
"""

from __future__ import annotations

import torch

_stats_group = None


def set_stats_group(group) -> None:
    """Take train-mode statistics over ``group``'s ranks from now on
    (None: over this process's rows)."""
    global _stats_group
    _stats_group = group


def stats_group():
    """The registered group, while the process group runs; else None."""
    dist = torch.distributed
    if _stats_group is None or not (dist.is_available()
                                    and dist.is_initialized()):
        return None
    return _stats_group


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group's ranks; the gradient is summed the same way
    (every rank's result feeds every rank's loss term)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        torch.distributed.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (default: all), with a
    gradient."""
    return _AllReduceSum.apply(t, group)
