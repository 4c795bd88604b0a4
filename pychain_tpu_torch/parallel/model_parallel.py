"""Model parallelism over a mesh's ``mp`` dim.

The port's counterpart of what GSPMD inserts for the JAX package when a
kernel carries an ``mp`` annotation (the models' ``nn.with_partitioning``,
or ``__graft_entry__.py``'s ``_param_spec``).  PyTorch runs one process a
device, so :func:`place_parameters` turns a model's parameters into
DTensors on the mesh: each chosen weight ``Shard(d)`` on ``mp`` and
``Replicate()`` on every other dim, every other parameter ``Replicate()``
on every dim, so that an optimizer takes ``model.parameters()`` as it
comes (the foreach optimizers of some PyTorch releases refuse a list that
mixes DTensors and tensors).  Biases, BatchNorm's scale and shift and the
TDNN-F bottleneck stay whole, as ``_param_spec`` replicates every 1-D
leaf; the running statistics are buffers and stay plain tensors.

A layer reads its weight's placement and runs its shard between the mp
collectives; those live in ``utils.mp`` (torch alone, so that the models
know nothing of this package) and are re-exported here: ``copy_to_mp``,
``gather_from_mp``, ``scatter_to_mp``, ``reduce_from_mp``, ``mp_shard``,
``mp_apply``, ``local``, ``whole``, ``COMM_BYTES``.  Dropout needs
nothing: it acts on whole activations, and the mp ranks' generators,
seeded alike, draw the same masks.
"""

from __future__ import annotations

from torch import nn

from ..utils.mp import (COMM_BYTES, _dtensor, copy_to_mp, gather_from_mp,
                        local, mp_apply, mp_shard, reduce_from_mp,
                        reset_comm_bytes, scatter_to_mp, whole)

__all__ = ["place_parameters", "copy_to_mp", "gather_from_mp",
           "scatter_to_mp", "reduce_from_mp", "mp_shard", "mp_apply",
           "local", "whole", "COMM_BYTES", "reset_comm_bytes"]


def place_parameters(model: nn.Module, mesh, spec=None):
    """Turn every parameter of ``model`` into a DTensor on ``mesh``, in
    place: ``spec(name, param)`` gives the dim d to shard over the mesh's
    ``"mp"`` dim (each rank keeps its slice; ``Replicate()`` on the other
    mesh dims) or None (``Replicate()`` everywhere).  ``spec``'s default
    is the model's own annotations (``model.mp_spec``) over the mesh dim
    named ``config.mp_axis``.  With that dim of size 1 the model stays as
    it is.  Every rank must hold the same whole weights (a seeded model,
    or ``convert.model_from_flax``).  Raises ValueError on a dim that
    does not divide, or on a model placed already.  Returns ``model``."""
    DTensor, Replicate, Shard = _dtensor()
    axis = "mp"
    if spec is None:
        spec = getattr(model, "mp_spec", None)
        if spec is None:
            raise TypeError(f"{type(model).__name__} has no mp annotations; "
                            "pass spec=")
        axis = model.config.mp_axis or axis
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh dims {mesh.mesh_dim_names} have no {axis!r}")
    n = mesh[axis].size()
    if n == 1:
        return model
    r = mesh.get_local_rank(axis)
    for name, p in list(model.named_parameters()):
        if isinstance(p, DTensor):
            raise ValueError(f"{name} is placed already")
        d = spec(name, p)
        placements = [Replicate() for _ in mesh.mesh_dim_names]
        value = p.detach()
        if d is not None:
            if p.shape[d] % n:
                raise ValueError(f"{name} {tuple(p.shape)}: dim {d} does "
                                 f"not divide over {n} ranks of {axis!r}")
            placements[mesh.mesh_dim_names.index(axis)] = Shard(d)
            value = value.chunk(n, d)[r].contiguous()
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path))
        setattr(owner, leaf, nn.Parameter(
            DTensor.from_local(value, mesh, placements, run_check=False),
            requires_grad=p.requires_grad))
    return model
