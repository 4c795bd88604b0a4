#!/usr/bin/env python3
"""One SGD step of a TDNN on a ``("dp", "mp")`` mesh: the port of
``__graft_entry__.py``.

    python -m pychain_tpu_torch.tools.dryrun_multichip [--n 4] [--device cpu]
    torchrun --nproc-per-node N -m pychain_tpu_torch.tools.dryrun_multichip --n N

* :func:`setup` — ``_setup``'s problem from the same numpy draws: B=4
  linear numerators of T=16 frames over ``denominator_fst(12, 2)``
  (P=24), features (B, T, 16), and a TDNN of hidden width 32, kernels
  (3, 3), seeded;
* :func:`entry` — ``(fn, args)``: one process's forward step, ``fn(*args)``
  the chain loss;
* :func:`param_spec` — ``_param_spec``: every conv and dense kernel's
  output dim over ``mp``, the 1-D leaves whole;
* :func:`dryrun_multichip` — ``n`` ranks on an (n / 2 x 2) mesh (n // 1 x
  1 for an odd n): features, lengths and numerators over ``dp``, the
  denominator replicated, the kernels placed by :func:`param_spec`; the
  model with ``train=False``, ``ShardedChainLoss``, backward, the
  gradients summed over ``dp`` and SGD at 0.1 on the weights and the
  BatchNorm statistics (JAX differentiates flax's whole variables tree).
  Rank 0 prints ``__graft_entry__``'s two lines (the engines: the
  factorized family and the linear closed form; the mesh and the loss);
* :func:`run_rank` — this rank's part of it in a running job, the TDNN
  seeded or holding the flax ``variables`` (carried across by
  ``convert.model_from_flax``) that every rank passes.

Under a launcher (torchrun's ``RANK`` / ``WORLD_SIZE``), or in a running
process group, the process joins the job (``multihost.join_job``) as one
rank.  Alone it starts ``n`` ranks as subprocesses that share the card
over gloo (or the CPU with ``--device cpu``), under a time limit, and
fails if any rank fails.  It runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B, T, D, PHONES, SEED, LR = 4, 16, 16, 12, 0, 0.1
RANK_TIMEOUT = 600      # seconds the started ranks may take together
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup(batch=B, frames=T, feat_dim=D, num_phones=PHONES, seed=SEED,
          device=None, variables=None, mesh=None, spec=None):
    """``(model, feats, lengths, den, num_b)`` of ``_setup``: the same
    numpy draws in the same order, the TDNN seeded (or from the flax
    ``variables``) and, with ``mesh``, placed by ``spec``."""
    from .. import ChainGraph, ChainGraphBatch
    from ..convert import model_from_flax
    from ..models import TDNN, TDNNConfig
    from ..parallel.model_parallel import place_parameters
    from ..utils.device import resolve_device
    from ..utils.testgraphs import denominator_fst, linear_fst
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    den_fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                                 seed=seed)
    den = ChainGraph(den_fst, log_domain=False)
    nums = [ChainGraph(linear_fst(rng.randint(0, P, size=frames)),
                       log_domain=True) for _ in range(batch)]
    num_b = ChainGraphBatch(
        nums, max_num_transitions=max(g.num_transitions for g in nums),
        max_num_states=max(g.num_states for g in nums), device=device)
    cfg = TDNNConfig(num_pdfs=P, hidden_dim=32, kernel_sizes=(3, 3),
                     dilations=(1, 1), strides=(1, 1), dropout=0.0)
    feats = torch.from_numpy(rng.randn(batch, frames, feat_dim)
                             .astype(np.float32)).to(device)
    lengths = torch.full((batch,), frames, dtype=torch.int32)
    if variables is not None:
        model = model_from_flax(cfg, variables, device)
    else:
        model = TDNN(cfg, feat_dim, device=device)
    if mesh is not None:
        place_parameters(model, mesh, spec)
    return model, feats, lengths, den, num_b


def entry(device=None):
    """``(fn, example_args)``: ``fn(*example_args)`` is the chain loss of
    ``_setup``'s TDNN over the whole batch in one process."""
    from .. import ChainGraphBatch
    from ..loss import chain_loss
    model, feats, lengths, den, num_b = setup(device=device)
    den_b = ChainGraphBatch(den, feats.shape[0], device=feats.device)

    def fn(model, feats, lengths, den_b, num_b):
        return chain_loss(model(feats, train=False), lengths, num_b, den_b)

    return fn, (model, feats, lengths, den_b, num_b)


def param_spec(name: str, param) -> int | None:
    """``_param_spec`` in the port's layout: a conv kernel (k, in, out)
    sharded (None, None, mp) is a weight (out, in, k) on dim 0, a dense
    kernel (in, out) sharded (None, mp) a Linear weight (out, in) on dim
    0; every other leaf whole."""
    return 0 if param.dim() in (2, 3) else None


def _trainables(model) -> list:
    from ..examples.train_corpus import trainables
    return trainables(model)


def _sgd(tensors) -> None:
    from ..utils.mp import local
    with torch.no_grad():
        for t in tensors:
            local(t).sub_(LR * local(t.grad))


def _state(model) -> dict:
    """The model's whole weights and statistics on the CPU (placed ones
    gathered: every rank of the mesh calls it)."""
    from ..utils.mp import whole
    return {k: whole(v).detach().cpu() for k, v in
            model.state_dict().items()}


def _reset_launches() -> None:
    from ..ops import fact_kernels, semiring_kernels, stream_kernels, \
        viterbi_kernels
    for mod in (fact_kernels, semiring_kernels, stream_kernels,
                viterbi_kernels):
        mod.reset_launch_counts()


def _launches() -> dict:
    from ..ops import fact_kernels, semiring_kernels, stream_kernels, \
        viterbi_kernels
    out = {}
    for mod in (fact_kernels, semiring_kernels, stream_kernels,
                viterbi_kernels):
        out.update({k: v for k, v in mod.LAUNCHES.items() if v})
    return out


def reference_step(device=None) -> dict:
    """One process's step on the whole batch: ``{"loss", "state"}``, the
    loss and the weights and statistics after SGD."""
    fn, args = entry(device)
    model = args[0]
    tensors = _trainables(model)
    loss = fn(*args)
    loss.backward()
    _sgd(tensors)
    return {"loss": float(loss.detach()), "state": _state(model)}


def mesh_step(mesh, device, variables=None) -> dict:
    """This rank's step on ``mesh`` (every rank calls it): its result
    with the whole state after SGD, the local shapes, its plain
    (replicated) tensors as they are, the kernel launches and the two
    lines, which rank 0 prints."""
    from .. import ChainGraphBatch
    from ..convert import model_to_flax
    from ..loss import den_engine, dispatch_arrays
    from ..ops.factorized import FactorizedArrays
    from ..ops.linear import LinearArrays
    from ..parallel import ShardedChainLoss, shard_batch, sum_gradients
    from ..utils.mp import local, mp_shard
    n_dp, n_mp = mesh["dp"].size(), mesh["mp"].size()
    n = n_dp * n_mp
    batch = max(B, n_dp)
    model, feats, lengths, den, num_b = setup(
        batch, device=device, variables=variables, mesh=mesh,
        spec=param_spec)
    den_arr = dispatch_arrays(ChainGraphBatch(den, batch,
                                              device=feats.device), "auto")
    num_arr = dispatch_arrays(num_b, "auto")
    if not (isinstance(den_arr, FactorizedArrays)
            and isinstance(num_arr, LinearArrays)):
        raise RuntimeError(f"dryrun_multichip({n}): den engine "
                           f"{type(den_arr).__name__}, num engine "
                           f"{type(num_arr).__name__}")
    lines = [f"dryrun_multichip({n}): den engine=FactorizedArrays"
             f"[{den_engine(den_arr)}] num engine=LinearArrays"]
    tensors = _trainables(model)
    loss_fn = ShardedChainLoss(mesh, den)
    x, lens = shard_batch(mesh, (feats, lengths))
    _reset_launches()
    loss = loss_fn(model(x, train=False), lens, num_b)
    loss.backward()
    sum_gradients(tensors, mesh)
    _sgd(tensors)
    launched = _launches()
    value = float(loss.detach())
    if not np.isfinite(value):
        raise RuntimeError(f"dryrun_multichip({n}): non-finite loss {value}")
    lines.append(f"dryrun_multichip({n}): mesh=({n_dp}x{n_mp}) "
                 f"loss={value:.6f} ok")
    rank = torch.distributed.get_rank()
    if rank == 0:
        print("\n".join(lines), flush=True)
    return {"rank": rank, "n_dp": n_dp, "n_mp": n_mp,
            "dp_index": mesh.get_local_rank("dp"),
            "mp_index": mesh.get_local_rank("mp"),
            "backend": torch.distributed.get_backend(), "loss": value,
            "lines": lines, "launches": launched,
            "placed": sorted(k for k, v in model.named_parameters()
                             if mp_shard(v) is not None),
            "local_shapes": {k: tuple(local(v).shape)
                             for k, v in model.state_dict().items()},
            "plain": {k: local(v).detach().cpu() for k, v in
                      model.state_dict().items() if mp_shard(v) is None},
            "state": _state(model), "flax": model_to_flax(model)}


def run_rank(n: int, device=None, variables=None) -> dict:
    """Join the job (``multihost.join_job``: the running group, or the one
    a launcher describes), check that it has ``n`` ranks and take this
    rank's :func:`mesh_step` on an (n // n_mp, n_mp) mesh, n_mp = 2 for
    an even n, else 1 (the TDNN seeded, or from the flax ``variables``
    that every rank of the job passes)."""
    from ..parallel import make_mesh
    from ..parallel.multihost import join_job
    rank, world, dev = join_job(device)
    if world != n:
        raise ValueError(f"dryrun_multichip({n}) in a job of {world} ranks")
    n_mp = 2 if n % 2 == 0 else 1
    return mesh_step(make_mesh(n // n_mp, n_mp, device=dev), dev, variables)


def _under_job() -> bool:
    return (torch.distributed.is_initialized()
            or ("RANK" in os.environ and "WORLD_SIZE" in os.environ))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(n: int, device, timeout: float) -> list:
    """n ranks of this module as subprocesses, started as torchrun starts
    them, each writing its result; every rank killed past ``timeout``
    seconds, and a RuntimeError for any rank that fails.  Rank 0's
    output is printed here."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "pychain_tpu_torch.tools."
                "dryrun_multichip", "--n", str(n), "--out", tmp]
        if device is not None:
            argv += ["--device", str(device)]
        procs = []
        try:
            for r in range(n):
                env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                           LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                           MASTER_ADDR="localhost", MASTER_PORT=str(port),
                           PYTHONPATH=ROOT + os.pathsep
                           + os.environ.get("PYTHONPATH", ""))
                procs.append(subprocess.Popen(
                    argv, cwd=ROOT, env=env, text=True,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE))
            deadline = time.monotonic() + timeout
            logs = []
            for r, p in enumerate(procs):
                try:
                    logs.append(p.communicate(
                        timeout=max(1.0, deadline - time.monotonic())))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"dryrun_multichip({n}): rank {r} "
                                       f"ran past {timeout} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, (_, err)) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multichip({n}): rank {r} exited "
                                   f"{p.returncode}:\n{err[-3000:]}")
        sys.stdout.write(logs[0][0])
        sys.stdout.flush()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]


def dryrun_multichip(n: int, device=None,
                     timeout: float = RANK_TIMEOUT) -> list:
    """One training step on ``n`` ranks (module docstring).  Under a job
    this process is one rank and gets ``[its result]``; alone it starts
    the ``n`` ranks and gets every rank's, in rank order."""
    if _under_job():
        return [run_rank(n, device)]
    return _start_ranks(n, device, timeout)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4, help="ranks")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument("--out", default="",
                    help="under a launcher: write this rank's result here")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    if not _under_job():
        return dryrun_multichip(args.n, args.device)
    try:
        res = run_rank(args.n, args.device)
        if args.out:
            torch.save(res, os.path.join(args.out, f"rank{res['rank']}.pt"))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return [res]


if __name__ == "__main__":
    main()
