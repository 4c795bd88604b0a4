"""Data parallelism over ``torch.distributed``.

The port's counterpart of ``pychain_tpu/parallel/data_parallel.py``.
JAX runs one process over many devices (``shard_map`` and a ``psum``);
PyTorch runs one process per device in a process group, and each rank
holds its own rows of the batch.  The names stay:

* :func:`make_mesh` — a ``DeviceMesh`` over the ranks with axes
  ``("dp", "mp")``: rank r at dp index r // n_mp and mp index r % n_mp,
  as JAX's ``reshape(n_dp, n_mp)``.  The loss is batch-parallel over
  ``dp``; the mp ranks of one dp index hold the same rows, and the models
  shard their kernels over ``mp`` (``model_parallel``).
* :func:`shard_batch` — this rank's contiguous rows
  ``[r B / n, (r + 1) B / n)`` of a global batch.
* :func:`engine_pspec` — which engine arrays replicate (a shared
  denominator) and which shard over ``dp`` (per-sequence numerators).
* :func:`pjit_chain_function` and :class:`ShardedChainLoss` — the
  chain objective over the group: every rank runs the single-device
  engines (the card's kernels) on its rows, and only scalars cross
  ranks.

The objective is the JAX package's: the sum of the ranks' terms over
the sum of their frames.  Its value is the same on every rank; its
gradient is each rank's own: a rank's term is taken over the global
frame count, and only the value is reduced (:func:`global_value`), so
``backward()`` on every rank gives each rank the gradient of its rows.
The parameters' gradients are then summed over the dp ranks
(:func:`sum_gradients`), as the JAX step sums each shard's part of one
objective (DDP would average them).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import ChainGraphBatch
from ..loss import (_lengths, chain_function, chain_function_with_aux,
                    dispatch_arrays)
from ..ops.factorized import FactorizedArrays
from ..ops.fwdbwd import GraphArrays
from ..utils.device import host_to, resolve_device
from ..utils.dist import set_stats_group
from ..utils.mp import _dtensor, local as _local


def backend_for(device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def ensure_group(device=None) -> None:
    """Start a group of one rank (an in-process store, no network) when
    no process group is running, so that a single process needs no
    setup; a job of several ranks starts its group with
    :func:`~pychain_tpu_torch.parallel.multihost.initialize`."""
    dist = torch.distributed
    if not dist.is_initialized():
        dist.init_process_group(backend_for(resolve_device(device)),
                                store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(n_dp: int | None = None, n_mp: int = 1, device=None):
    """A ``("dp", "mp")`` DeviceMesh over the group's ranks (started as a
    group of one if none runs), rank r at (r // n_mp, r % n_mp).
    ``n_dp`` defaults to every rank over ``n_mp``; the mesh must cover
    the group (ValueError, and no group is left started).
    ``device=None`` means the card."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_mp = int(n_mp)
    n_dp = max(1, world // max(n_mp, 1)) if n_dp is None else int(n_dp)
    if n_dp < 1 or n_mp < 1 or n_dp * n_mp != world:
        raise ValueError(f"a ({n_dp}, {n_mp}) mesh needs {n_dp * n_mp} "
                         f"ranks; the process group has {world}")
    ensure_group(dev)
    return init_device_mesh(dev.type, (n_dp, n_mp),
                            mesh_dim_names=("dp", "mp"))


def dp_axis(mesh):
    """(group, rank, size) of the mesh's ``dp`` axis."""
    return (mesh.get_group("dp"), mesh.get_local_rank("dp"),
            mesh["dp"].size())


def dp_placements(mesh):
    """DTensor placements that shard dim 0 over ``dp`` and replicate
    over every other axis of the mesh."""
    _, Replicate, Shard = _dtensor()
    return [Shard(0) if name == "dp" else Replicate()
            for name in mesh.mesh_dim_names]


def _rows(n_rows: int, rank: int, size: int) -> slice:
    if n_rows % size:
        raise ValueError(f"batch size {n_rows} not divisible by dp axis "
                         f"size {size}")
    per = n_rows // size
    return slice(rank * per, (rank + 1) * per)


def _take_rows(g, rank: int, size: int):
    """This rank's rows of per-sequence engine arrays."""
    rows = _rows(_n_rows(g), rank, size)
    return g.take(list(range(rows.start, rows.stop)))


def _n_rows(g) -> int:
    for v in vars(g).values():
        if isinstance(v, torch.Tensor):
            return int(v.shape[0])
    raise TypeError(f"no batch rows in {type(g).__name__}")


def shard_batch(mesh, tree):
    """This rank's contiguous rows ``[r B / n, (r + 1) B / n)`` of each
    leaf of ``tree`` (tensors and numpy arrays with the batch leading,
    in dicts, lists and tuples; per-sequence engine arrays by their
    ``take``).  Raises ValueError when B does not divide by the dp axis
    size."""
    _, rank, size = dp_axis(mesh)

    def cut(v):
        if isinstance(v, dict):
            return {k: cut(u) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(cut(u) for u in v)
        if isinstance(v, (torch.Tensor, np.ndarray)):
            return v[_rows(v.shape[0], rank, size)]
        if hasattr(v, "take") and engine_pspec(v) == "shard":
            return _take_rows(v, rank, size)
        return v

    return cut(tree)


def engine_pspec(g) -> str:
    """How engine arrays spread over ``dp``: "replicate" for a shared
    graph (the factorized denominator, a shared GraphArrays), "shard"
    (rows over ranks) for every per-sequence engine, whose tensors are
    all batch-leading."""
    if isinstance(g, FactorizedArrays):
        return "replicate"
    if isinstance(g, GraphArrays):
        return "replicate" if g.shared else "shard"
    return "shard"


class _GlobalValue(torch.autograd.Function):
    """The sum over the ranks forward; the gradient passed to the local
    term as it is."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_value(local: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``local`` over the ranks as a value (the same bits on
    every rank), with the gradient of ``local`` alone: ``backward()`` on
    every rank leaves each rank the gradient of its own term, not
    ``world_size`` times it (the backward of an all-reduce would sum the
    ranks' incoming gradients)."""
    return _GlobalValue.apply(local, group)


def sum_gradients(params, group=None) -> None:
    """Sum each tensor's ``.grad`` over the dp ranks, in place: one
    all-reduce over the gradients laid end to end (a fixed order, so
    every rank gets the same bits); a DTensor's gradient by its local
    shard.  ``group`` is a process group or a DeviceMesh (its ``dp``
    group); None means the mesh of the DTensor parameters, else every
    rank.  The mp ranks of a dp index hold different shards, so with
    parameters placed over mp the sum must not cross them: a group of
    another size than the mesh's dp dim raises ValueError."""
    from torch.distributed.device_mesh import DeviceMesh
    DTensor = _dtensor()[0]
    params = list(params)
    meshes = {p.device_mesh for p in params if isinstance(p, DTensor)}
    if len(meshes) > 1:
        raise ValueError("the parameters lie on more than one mesh")
    if isinstance(group, DeviceMesh):
        meshes.add(group)
        group = group.get_group("dp")
    elif group is None and meshes:
        group = next(iter(meshes)).get_group("dp")
    for mesh in meshes:
        if torch.distributed.get_world_size(group) != mesh["dp"].size():
            raise ValueError(
                f"sum_gradients over {torch.distributed.get_world_size(group)}"
                f" ranks: parameters placed on a {tuple(mesh.shape)} mesh "
                "sum over its dp dim alone")
    grads = [_local(p.grad) for p in params if p.grad is not None]
    if not grads or torch.distributed.get_world_size(group) == 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def _comm_device(group) -> torch.device:
    if torch.distributed.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_ranks(flag: bool, group=None) -> bool:
    """True when ``flag`` holds on every rank of ``group``."""
    t = torch.tensor([0 if flag else 1], device=_comm_device(group))
    torch.distributed.all_reduce(t, group=group)
    return not bool(t.item())


def rows_and_frames(group, rank, size, rows: int, lengths):
    """One all-reduce of a (size + 1,) float64 vector on the group's
    device: entry r is rank r's rows, the last the frames of every
    rank.  Nothing is read back to the host, so under NCCL the step
    does not wait for the card."""
    table = torch.zeros(size + 1, dtype=torch.float64,
                        device=_comm_device(group))
    table[rank] = rows
    n = lengths.sum()
    table[size] = n if n.device == table.device else float(n)
    torch.distributed.all_reduce(table, group=group)
    return table


def per_frame(local: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
    """``local`` over the frame count held in a 0-dim tensor, with the
    bits of ``local / int(frames)`` (ChainLoss's division by a host
    number): on the card that division multiplies by the float32
    reciprocal, on the CPU it divides."""
    frames = frames.to(local.dtype)
    if frames.is_cuda:
        return local * frames.reciprocal()
    return local / frames


def pjit_chain_function(mesh, graphs, leaky_coefficient=1e-5,
                        impl: str = "auto"):
    """``fn(x, lengths) -> objf``: the chain log-likelihood of the whole
    batch, summed over the ranks.  ``graphs`` is the global batch;
    each rank keeps its rows of per-sequence engine arrays
    (:func:`engine_pspec`), and ``x`` / ``lengths`` are this rank's rows.
    The engines are ``impl``'s (:func:`~pychain_tpu_torch.loss.dispatch_arrays`);
    only the scalar crosses ranks."""
    group, rank, size = dp_axis(mesh)
    g = dispatch_arrays(graphs, impl)
    if engine_pspec(g) == "shard":
        g = _take_rows(g, rank, size)

    def fn(x, lengths):
        return global_value(chain_function(_local(x), _local(lengths), g,
                                           leaky_coefficient, impl), group)
    return fn


class ShardedChainLoss(torch.nn.Module):
    """Data-parallel :class:`~pychain_tpu_torch.ChainLoss`: the same
    objective, over the ranks of ``mesh``'s ``dp`` axis.

    Each rank calls it with its own rows: ``x`` (B_r, T, P) and
    ``x_lengths``, and ``num_graphs`` either for those rows or for the
    whole batch (then this rank takes its rows).  Every rank must hold
    as many rows (the global batch divides by the dp size; checked the
    first time a rank sees a local batch size).  Each call all-reduces
    one small vector on the group's device (:func:`rows_and_frames`)
    and reads nothing back after that first time.  The
    denominator is built once per local batch size on the mesh's
    device and dispatched through ``impl`` (the card's kernels under
    "auto"); ``tile_dtype="bfloat16"`` is the fast mode.  With
    ``xent_regularize`` > 0 the call takes ``xent_out``, the xent head's
    output, and adds Kaldi's regularizer on the numerator posteriors;
    ``l2_regularize`` adds the output-l2 on real frames (as
    ``chain_loss_xent``).  The value is the global objective on every
    rank; the gradient, each rank's rows' (:func:`global_value`).  It
    registers its ``dp`` group for the models' train-mode statistics
    (``utils.dist.set_stats_group``; none at a dp size of 1, where the
    mp ranks hold the same rows)."""

    def __init__(self, mesh, den_graph, leaky_coefficient=1e-5, avg=True,
                 impl: str = "auto", tile_dtype=None, xent_regularize=0.0,
                 l2_regularize=0.0):
        super().__init__()
        self.mesh = mesh
        self.den_graph = den_graph
        self.leaky_coefficient = leaky_coefficient
        self.avg = avg
        self.impl = impl
        self.tile_dtype = tile_dtype
        self.xent_regularize = float(xent_regularize)
        self.l2_regularize = float(l2_regularize)
        self.device = torch.device(mesh.device_type)
        self._den_cache = {}
        self._rows_checked = set()
        group, _, size = dp_axis(mesh)
        set_stats_group(group if size > 1 else None)

    def den_arrays(self, batch_size: int):
        """The denominator's engine arrays for a LOCAL batch size, built
        once per size."""
        if batch_size not in self._den_cache:
            self._den_cache[batch_size] = dispatch_arrays(ChainGraphBatch(
                self.den_graph, batch_size, tile_dtype=self.tile_dtype,
                device=self.device), self.impl)
        return self._den_cache[batch_size]

    def forward(self, x, x_lengths, num_graphs, xent_out=None):
        if (xent_out is None) == (self.xent_regularize > 0.0):
            raise ValueError(
                "pass xent_out exactly when xent_regularize > 0 "
                f"(xent_regularize={self.xent_regularize}, "
                f"xent_out={'set' if xent_out is not None else 'None'})")
        group, rank, size = dp_axis(self.mesh)
        x = _local(x)
        lengths = _lengths(_local(x_lengths))
        B = x.shape[0]
        table = rows_and_frames(group, rank, size, B, lengths)
        if B not in self._rows_checked:
            # once per local batch size: the one host read of the table
            rows = table[:size].cpu().numpy()
            if (rows != B).any():
                raise ValueError(
                    f"batch size {int(rows.sum())} not divisible by dp "
                    f"axis size {size}: the ranks hold "
                    f"{[int(b) for b in rows]} rows")
            self._rows_checked.add(B)
        num = dispatch_arrays(num_graphs, "auto")
        if engine_pspec(num) == "shard":
            n = _n_rows(num)
            if n == B * size and size > 1:
                num = _take_rows(num, rank, size)
            elif n != B:
                raise ValueError(f"num_graphs has {n} rows; this rank holds "
                                 f"{B} of {B * size}")
        den = self.den_arrays(B)
        den_objf = chain_function(x, lengths, den, self.leaky_coefficient,
                                  self.impl)
        if self.xent_regularize > 0.0:
            num_objf, aux = chain_function_with_aux(x, lengths, num)
            gamma = aux.gamma.detach().to(xent_out.dtype)
            extra = -self.xent_regularize * torch.sum(
                gamma * torch.log_softmax(_local(xent_out), dim=-1))
        else:
            num_objf = chain_function(x, lengths, num)
            extra = x.new_zeros(())
        if self.l2_regularize > 0.0:
            frames = torch.arange(x.shape[1], device=x.device)
            mask = frames[None, :] < host_to(lengths, x.device)[:, None]
            extra = extra + self.l2_regularize * 0.5 * torch.sum(
                torch.square(x) * mask[:, :, None])
        local = -(num_objf - den_objf) + extra
        if self.avg:
            local = per_frame(local, table[size])
        return global_value(local, group)
