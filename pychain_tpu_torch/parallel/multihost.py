"""Jobs of several processes: bootstrap, global batches, checkpoints.

The port's counterpart of ``pychain_tpu/parallel/multihost.py``.
``jax.distributed.initialize`` becomes ``init_process_group`` over a
``tcp://`` coordinator, one device per process: NCCL between cards,
gloo on the CPU (and for ranks that share one card, which NCCL
refuses).  The loss needs nothing more: :class:`ShardedChainLoss`
reduces its scalars over the group, on one host or many.

* :func:`global_dp_mesh` — a 1-D ``("dp",)`` DeviceMesh over every rank.
* :func:`host_local_batch_to_global` — this rank's rows, kept as they
  are, as its shard of a global ``DTensor`` (``.to_local()`` gives them
  back; the loss takes either).
* :func:`replicate_to_global` — the values of the mesh's first rank on
  every rank of the mesh.
* :func:`save_sharded` / :func:`restore_sharded` — checkpoints over
  ``torch.distributed.checkpoint`` (for orbax): each rank writes its
  shards of a DTensor, and a plain tensor is saved once as replicated;
  ``utils/checkpoint``'s ``path/step_N`` directories and ``LATEST``
  marker.  A restore fills a template of any placement on any device
  (a plain tensor of the global shape gets the whole array).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Optional

import numpy as np
import torch

from ..utils.checkpoint import latest_step
from ..utils.device import resolve_device
from ..utils.dist import set_stats_group
from ..utils.mp import _dtensor
from .data_parallel import backend_for, dp_placements


def local_rank(process_id: int) -> int:
    """This process's card on its host: ``LOCAL_RANK`` (torchrun's) when
    set, else the process id modulo the host's cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(1, torch.cuda.device_count())


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, local_device_count: Optional[int] = None,
               device=None, backend: Optional[str] = None) -> None:
    """Join this process to the job's process group, once per process,
    before any collective.  ``coordinator_address`` is ``host:port`` of
    rank 0.  One device per process: ``local_device_count`` may be None
    or 1.  ``device=None`` means this process's card (:func:`local_rank`),
    made the current device; ``backend`` defaults to NCCL on a card and
    gloo on the CPU (pass "gloo" for ranks that share a card)."""
    if local_device_count not in (None, 1):
        raise ValueError(
            f"local_device_count={local_device_count}: the port runs one "
            "process per device (start one process per card)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank(process_id) if dev.index is None
                              else dev.index)
    torch.distributed.init_process_group(
        backend or backend_for(dev),
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def global_dp_mesh(device=None):
    """A 1-D ``("dp",)`` DeviceMesh over every rank of the job, in rank
    order, so each rank's rows stay on its own device and only the
    scalars cross hosts."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    return init_device_mesh(dev.type, (torch.distributed.get_world_size(),),
                            mesh_dim_names=("dp",))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _on_mesh(x, mesh):
    t = torch.as_tensor(np.asarray(x)) if isinstance(x, np.ndarray) else x
    if mesh.device_type == "cuda" and not t.is_cuda:
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def host_local_batch_to_global(mesh, tree: Any) -> Any:
    """Each rank passes its own rows (global batch / ranks of them); each
    tensor or numpy leaf comes back as this rank's shard (dim 0 over
    ``dp``) of a global DTensor whose row order follows the rank.  The
    rows are kept as they are; other leaves pass unchanged."""
    DTensor = _dtensor()[0]
    placements = dp_placements(mesh)

    def put(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        return DTensor.from_local(_on_mesh(x, mesh), mesh, placements,
                                  run_check=False)

    return _tree_map(put, tree)


def replicate_to_global(mesh, tree: Any) -> Any:
    """The values of each tensor or numpy leaf on the mesh's first rank
    (every coordinate 0), broadcast to every rank of the mesh (the
    denominator graph's arrays, a seed's weights): over each mesh dim in
    turn from its first rank, last dim first, so that a (dp, mp) mesh's
    mp ranks get rank 0's values too, not their own dp column's."""
    groups = [mesh.get_group(name) for name in mesh.mesh_dim_names]

    def put(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        t = _on_mesh(x, mesh).clone()
        for group in reversed(groups):
            torch.distributed.broadcast(
                t, src=torch.distributed.get_global_rank(group, 0),
                group=group)
        return t

    return _tree_map(put, tree)


def save_sharded(path: str, step: int, state: Any) -> None:
    """Save a nested dict of tensors at ``path/step_N``; every rank
    calls it.  DTensor leaves are written shard by shard by the ranks
    that hold them; plain tensors are replicated values, written once.
    ``LATEST`` is set to N (by rank 0, then every rank waits)."""
    import torch.distributed.checkpoint as dcp
    path = os.path.abspath(path)
    dcp.save(state, storage_writer=dcp.FileSystemWriter(
        os.path.join(path, f"step_{step}")))
    if torch.distributed.get_rank() == 0:
        marker = os.path.join(path, "LATEST")
        with open(marker + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(marker + ".tmp", marker)
    torch.distributed.barrier()


def restore_sharded(path: str, template: Any,
                    step: Optional[int] = None) -> tuple[int, Any]:
    """``(step, state)`` of the given (or latest) step, read into a copy
    of ``template``'s structure: each leaf with the template's shape,
    placement and device (a plain tensor of the global shape gets the
    whole array); every rank calls it."""
    import torch.distributed.checkpoint as dcp
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    state = _tree_map(lambda v: torch.empty_like(v)
                      if isinstance(v, torch.Tensor) else v, template)
    dcp.load(state, storage_reader=dcp.FileSystemReader(
        os.path.join(os.path.abspath(path), f"step_{step}")))
    return step, state


# ----------------------------------------------------------------------
# --dp in the examples: torchrun's group, or one process per local card
# ----------------------------------------------------------------------

def _under_launcher() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def should_spawn(device) -> bool:
    """True when a ``--dp`` run must start its own ranks: on a host with
    several cards and no launcher's group (torchrun's ``RANK`` and
    ``WORLD_SIZE``) around it."""
    return (torch.device(device).type == "cuda" and not _under_launcher()
            and not torch.distributed.is_initialized()
            and torch.cuda.device_count() > 1)


def prebuild(device) -> None:
    """Build every CUDA source once, before ranks that share this
    checkout would each run nvcc."""
    if torch.device(device).type == "cuda":
        from ..csrc import build
        build.build()


def join_job(device=None) -> tuple[int, int, torch.device]:
    """The process group of a ``--dp`` run, as ``(rank, world, device)``:
    the group already running, or the one a launcher describes (torchrun's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``;
    ``LOCAL_RANK`` picks the card), else a group of one rank.  NCCL when
    each rank has a card of its own, gloo on the CPU and for ranks that
    share a card (``LOCAL_WORLD_SIZE`` above the host's cards).  A group
    of several ranks becomes the models' statistics group
    (``utils.dist.set_stats_group``).  Rank 0 builds the kernels first,
    so the others find them built."""
    from .data_parallel import ensure_group
    dist = torch.distributed
    dev = resolve_device(device)
    if not dist.is_initialized() and _under_launcher():
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        backend = "gloo"
        if dev.type == "cuda":
            cards = torch.cuda.device_count()
            torch.cuda.set_device(local_rank(rank) % cards)
            if int(os.environ.get("LOCAL_WORLD_SIZE", world)) <= cards:
                backend = "nccl"
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    else:
        ensure_group(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.get_world_size() > 1:
        set_stats_group(dist.group.WORLD)
    if dist.get_rank() == 0:
        prebuild(dev)
    dist.barrier()
    return dist.get_rank(), dist.get_world_size(), dev


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, argv, world, port, out):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    result = fn(argv)
    if rank == 0:
        torch.save({k: v for k, v in result.items() if k != "model"}, out)


def spawn_per_card(fn, argv) -> dict:
    """Run ``fn(argv)`` in one process per local card (the spawn start
    method), each as a launcher would start it, and return rank 0's
    result (without its ``model``).  Rank 0 writes the result to a file
    in a temporary directory, read once every rank has ended, so a
    result of any size comes back (a queue's pipe would block rank 0
    past its 64 KiB buffer, and the join with it).  The kernels are
    built first."""
    import tempfile
    import torch.multiprocessing as mp
    prebuild("cuda")
    world = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_rank_main, args=(fn, argv, world, _free_port(),
                                             out),
                           nprocs=world, start_method="spawn", join=True)
        return torch.load(out, weights_only=False)


def dp_main(main, argv, device, batch_size, run):
    """An example's ``--dp``: one process per local card when it must
    start its own ranks (:func:`spawn_per_card`, rank 0's result), else
    ``run(device, (rank, world))`` in this rank of :func:`join_job`'s
    group, with the ranks but 0 silent.  ``batch_size`` must divide
    over the ranks."""
    if should_spawn(device):
        return spawn_per_card(main, argv)
    rank, world, dev = join_job(device)
    if batch_size % world:
        raise ValueError(f"--batch-size {batch_size} does not divide over "
                         f"{world} ranks")
    with contextlib.ExitStack() as quiet:
        if rank:
            quiet.enter_context(contextlib.redirect_stdout(
                quiet.enter_context(open(os.devnull, "w"))))
        print(f"data parallel over {world} ranks "
              f"({torch.distributed.get_backend()})")
        return run(dev, (rank, world))
