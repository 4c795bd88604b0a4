#!/usr/bin/env python3
"""ShardedChainLoss on the card against ChainLoss (the port of
``tools/sharded_check.py``).

    python -m pychain_tpu_torch.tools.sharded_check [--precision fast]
    torchrun --nproc-per-node N -m pychain_tpu_torch.tools.sharded_check

Alone it is a group of one rank (NCCL); under a launcher, the group that
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` describe
(``parallel.multihost.join_job``: NCCL with a card a rank, gloo for
ranks that share one).  The problem is bench.py's headline, main path
1's: ``denominator_fst(1500, 2, bigram_fanout=30)`` (S=3000, K=49.5k,
P=3000), B=128 linear numerators over numpy seed 0, at a depth cut to
T=150 frames, x from a CUDA generator seeded 2.  Each rank takes its
rows, times the sharded value and gradient (CUDA events, best of 3
after a warm-up) and ChainLoss's on the whole batch, and compares them:
the value's relative difference, the largest difference of its rows'
gradient, and whether both are bit-identical (``--precision both``:
float32, then bfloat16 tiles).  With ``--ckpt DIR`` it also saves its
rows of x's first 16 frames as a DTensor shard with ``save_sharded`` and
restores them, and the whole array into a plain tensor.  Last,
train-mode BatchNorm on this rank's rows of seeded features, against
the whole batch's statistics.  Every rank prints one JSON line,
``{"sharded_check": {...}}``, with its kernel launches in the sharded
steps.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", choices=("parity", "fast", "both"),
                    default="parity")
    ap.add_argument("--ckpt", default="",
                    help="also round-trip this rank's rows through "
                         "save_sharded / restore_sharded under this dir")
    return ap.parse_args(argv)


B, T, PHONES, REPS = 128, 150, 1500, 3


def _step_ms(fn):
    """(result of the last call, best ms of REPS calls after one
    warm-up), timed with CUDA events."""
    out = fn()
    best = float("inf")
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return out, best


def _batchnorm(rows, dev):
    """Train-mode BatchNorm over the ranks: this rank's rows of
    (B, 64, 50) features against the whole batch's statistics computed
    here in one piece (output and running statistics, largest
    difference)."""
    from pychain_tpu_torch.models.layers import BatchNorm
    feats = torch.randn(B, 64, 50, generator=torch.Generator(device=dev)
                        .manual_seed(3), device=dev)
    bn = BatchNorm(64).to(dev)
    with torch.no_grad():
        y = bn(feats[rows], train=True)
        var, mean = torch.var_mean(feats, dim=(0, 2), correction=0)
        ref = (feats[rows] - mean[None, :, None]) * torch.rsqrt(
            var + bn.eps)[None, :, None]
        m = bn.momentum
        return {"out_abs": float((y - ref).abs().max()),
                "stats_abs": max(
                    float((bn.running_mean - (1 - m) * mean).abs().max()),
                    float((bn.running_var - (m + (1 - m) * var))
                          .abs().max()))}


def main(argv=None) -> dict:
    args = parse_args(argv)
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch, ChainLoss
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.parallel import (ShardedChainLoss, global_dp_mesh,
                                            host_local_batch_to_global,
                                            make_mesh, restore_sharded,
                                            save_sharded)
    from pychain_tpu_torch.parallel.multihost import join_job
    from pychain_tpu_torch.utils.testgraphs import denominator_fst, linear_fst

    rank, world, dev = join_job("cuda")
    den_fst, P = denominator_fst(num_phones=PHONES, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    den = ChainGraph(den_fst)
    rng = np.random.RandomState(0)
    seqs = [rng.randint(0, P, size=T) for _ in range(B)]
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(2), device=dev)
    lens = torch.full((B,), T, dtype=torch.int32)
    if B % world:
        raise ValueError(f"B={B} does not divide over {world} ranks")
    rows = slice(rank * B // world, (rank + 1) * B // world)

    def nums(sl):
        return ChainGraphBatch([ChainGraph(linear_fst(s), log_domain=True)
                                for s in seqs[sl]], max_num_transitions=T,
                               max_num_states=T + 1, device=dev)

    mesh = make_mesh(device=dev)
    mine, whole = nums(rows), nums(slice(0, B))

    def step(loss, xs, lx, nb):
        xt = xs.clone().requires_grad_(True)
        v = loss(xt, lx, nb)
        v.backward()
        return v.detach(), xt.grad

    outs = []
    for prec in (("parity", "fast") if args.precision == "both"
                 else (args.precision,)):
        tile = "bfloat16" if prec == "fast" else None
        sharded = ShardedChainLoss(mesh, den, tile_dtype=tile)
        plain = ChainLoss(den, tile_dtype=tile, device=dev)
        fk.reset_launch_counts()
        (v_dp, g_dp), ms = _step_ms(lambda: step(
            sharded, x[rows], lens[rows], mine))
        launches = {k: v for k, v in fk.launched().items() if v}
        (v_1, g_1), plain_ms = _step_ms(lambda: step(plain, x, lens,
                                                     whole))
        g_rows = g_1[rows]
        outs.append({
            "rank": rank, "world": world,
            "backend": torch.distributed.get_backend(),
            "precision": prec, "B": B, "T": T, "rows": B // world,
            "loss": float(v_dp), "plain_loss": float(v_1),
            "loss_rel": abs(float(v_dp) - float(v_1))
            / max(1.0, abs(float(v_1))),
            "loss_bitwise": bool(torch.equal(v_dp, v_1)),
            "grad_abs": float((g_dp - g_rows).abs().max()),
            "grad_bitwise": bool(torch.equal(g_dp, g_rows)),
            "finite": bool(torch.isfinite(g_dp).all()),
            "ms": ms, "plain_ms": plain_ms,
            # steps timed: the warm-up and reps, one launch of a pair each
            "launches": launches, "steps": REPS + 1})
        del g_dp, g_1, g_rows
    out = outs[0]
    out["batchnorm"] = _batchnorm(rows, dev)
    if args.ckpt:
        # this rank's rows of x's first 16 frames
        part = x[:, :16].contiguous()
        gmesh = global_dp_mesh(device=dev)
        state = {"x": host_local_batch_to_global(gmesh, part[rows]),
                 "step": torch.tensor(7.0)}
        save_sharded(args.ckpt, 7, state)
        step_n, back = restore_sharded(args.ckpt, state)
        _, full = restore_sharded(args.ckpt, {
            "x": torch.zeros_like(part), "step": torch.tensor(0.0)})
        out["ckpt"] = {
            "step": step_n, "rows_equal": bool(torch.equal(
                back["x"].to_local(), part[rows])),
            "whole_equal": bool(torch.equal(full["x"], part)),
            "scalar": float(back["step"])}
        torch.distributed.barrier()
        if rank == 0:
            shutil.rmtree(args.ckpt, ignore_errors=True)
    for o in outs:
        print(json.dumps({"sharded_check": o}), flush=True)
    torch.distributed.destroy_process_group()
    return outs


if __name__ == "__main__":
    main()
    sys.exit(0)
