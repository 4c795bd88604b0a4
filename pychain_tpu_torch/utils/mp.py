"""The layers' side of model parallelism: a weight's placement over a
mesh's ``mp`` dim, and the four collectives a layer runs its shard
between.

``parallel.model_parallel`` places a model's parameters as DTensors and
re-exports what is here; the models read placements through this module
alone, which needs nothing of the port but torch.  Every rank of an mp
group holds the same rows and the same whole activations between
layers.  A layer reads its weight's placement (:func:`mp_shard`) and
runs a sharded weight's local product between two of the collectives
(:func:`mp_apply`); a replicated weight runs as its local tensor
(:func:`local`), as a plain one does.

The collectives, each an autograd Function over the mp group, built on
``all_reduce`` and ``all_gather`` (which gloo runs on CUDA tensors; not
``torch.distributed.nn.functional.all_gather``, whose backward needs the
``all_to_all`` that gloo lacks):

* :func:`copy_to_mp` — identity forward, all-reduce backward: the input
  of a layer whose output features are sharded (each rank's product
  reaches the input through its own shard only);
* :func:`gather_from_mp` — all-gather forward, own slice backward: a
  sharded output made whole;
* :func:`scatter_to_mp` — own slice forward, all-gather backward: the
  input of a layer whose input features are sharded;
* :func:`reduce_from_mp` — all-reduce forward, identity backward: the
  partial products of such a layer summed.

Each backward is right only where it stands above: a rule misplaced
gives an mp-times or a partial gradient while the loss stays right.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# bytes each kind of collective moved on this rank since the last reset:
# an all-reduce counts its tensor, an all-gather the gathered whole
COMM_BYTES = {"all_reduce": 0, "all_gather": 0}


def reset_comm_bytes() -> None:
    for k in COMM_BYTES:
        COMM_BYTES[k] = 0


def _dtensor():
    """(DTensor, Replicate, Shard) from this torch's module."""
    try:
        from torch.distributed.tensor import DTensor, Replicate, Shard
    except ImportError:          # torch before 2.4
        from torch.distributed._tensor import DTensor, Replicate, Shard
    return DTensor, Replicate, Shard


def local(t):
    """A DTensor's local shard (``host_local_batch_to_global``'s rows, a
    placed weight's slice, a replicated weight's whole), or ``t`` as it
    is (None included)."""
    DTensor = _dtensor()[0]
    return t.to_local() if isinstance(t, DTensor) else t


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    COMM_BYTES["all_reduce"] += out.numel() * out.element_size()
    return out


def _all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, dim)
    COMM_BYTES["all_gather"] += out.numel() * out.element_size()
    return out


def _own_slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                         f"divide over {n} mp ranks")
    return t.chunk(n, dim)[dist.get_rank(group)].contiguous()


class _CopyToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.group), None, None


class _ScatterToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _ReduceFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_mp(x, group):
    """x as it is; its gradient summed over the mp ranks."""
    return _CopyToMp.apply(x, group)


def gather_from_mp(x, dim: int, group):
    """The mp ranks' x laid together along ``dim`` (in rank order); the
    gradient of this rank's slice back."""
    return _GatherFromMp.apply(x, dim % x.dim(), group)


def scatter_to_mp(x, dim: int, group):
    """This rank's slice of x along ``dim``; the slices' gradients laid
    together back."""
    return _ScatterToMp.apply(x, dim % x.dim(), group)


def reduce_from_mp(x, group):
    """x summed over the mp ranks (the same bits on each); the gradient
    passed on as it is."""
    return _ReduceFromMp.apply(x, group)


def mp_shard(weight):
    """``(group, dim)`` of a weight sharded over one dim of its mesh (dim
    0: output features, 1: input features), or None for a plain or a
    replicated one.  Raises where no layer rule exists (a kernel's taps
    sharded, or more than one mesh dim)."""
    DTensor, _, Shard = _dtensor()
    if not isinstance(weight, DTensor):
        return None
    shards = [(name, p) for name, p in zip(weight.device_mesh.mesh_dim_names,
                                           weight.placements)
              if isinstance(p, Shard)]
    if not shards:
        return None
    if len(shards) != 1 or shards[0][1].dim not in (0, 1):
        raise NotImplementedError(
            f"placements {weight.placements}: a layer shards its weight's "
            "output (dim 0) or input features (dim 1) over one mesh dim")
    name, p = shards[0]
    return weight.device_mesh.get_group(name), p.dim


def mp_apply(fn, x, weight, bias, feature_dim: int):
    """``fn(x, w)`` plus ``bias`` for a sharded ``weight`` (:func:`mp_shard`,
    ``w`` its local shard): output features sharded, each rank's product
    of the whole x gathered along ``feature_dim``; input features sharded,
    the products of each rank's slice of x summed.  The whole bias is
    added last, broadcast along ``feature_dim`` of the output."""
    group, dim = mp_shard(weight)
    w = weight.to_local()
    if dim == 0:
        y = gather_from_mp(fn(copy_to_mp(x, group), w), feature_dim, group)
    else:
        y = reduce_from_mp(fn(scatter_to_mp(x, feature_dim, group), w), group)
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[feature_dim] = -1
    return y + local(bias).view(shape)


def whole(t):
    """The whole tensor of a DTensor (its shards gathered over the mesh
    dims that shard it; every rank of those groups calls it), or ``t``
    as it is."""
    DTensor, _, Shard = _dtensor()
    if not isinstance(t, DTensor):
        return t
    out = t.to_local().detach()
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            out = _all_gather(out, p.dim, t.device_mesh.get_group(name))
    return out
