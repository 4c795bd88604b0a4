#!/usr/bin/env python3
"""Main path 1's (or 4's, or 7's) step on the card, for A/Bs between two trees.

    python -m pychain_tpu_torch.tools.step_time LABEL [--main4 | --long]

``ChainLoss(den)`` over the headline graph (``denominator_fst(1500, 2,
bigram_fanout=30)``; with ``--main4`` main path 4's 12k-state graph,
``denominator_fst(6000, 2, num_pdfs=3000, bigram_fanout=30,
forward_pdf_mode="separate")``, on the cluster tier) with B=128 linear
numerators of T=500 frames, its backward pass and an SGD update of x, in
float32 and with ``precision="fast"``: 3 warm-up steps, then 20 steps
timed one by one with CUDA events; prints the median and the least ms
of each, after LABEL.  To compare two trees, unpack each into a
directory and run the tool from each in turns in one call (A, B, B, A;
a tree without this tool, or without ``--main4``, runs this file with
its own package first on PYTHONPATH).  ``--long``: main path 7's step
instead, the denominator's value and gradient through ``chain_function``
(bench.py ``--long --big``: the headline graph, B=64, T=3,700, bfloat16
tiles; and float32 at T=1,000), in each stream mode ("auto" with the
card's budget stubbed: "full", one stream's bytes "lean", one byte
"ckpt"): 2 warm-up steps, then 10 timed, and a digest of the objective
and the gradient, so that two trees' bits can be compared.  It needs a
card.
"""

from __future__ import annotations

import hashlib
import statistics
import sys

import numpy as np
import torch

from pychain_tpu_torch import ChainGraph, ChainGraphBatch, ChainLoss
from pychain_tpu_torch.csrc import build
from pychain_tpu_torch.utils.device import resolve_device
from pychain_tpu_torch.utils.testgraphs import denominator_fst, linear_fst


def step_times(loss_mod, nums, lens, P, dev, steps=20, warmup=3):
    B, T = lens.shape[0], int(lens.max())
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(2), device=dev).requires_grad_(True)
    ms = []
    for i in range(warmup + steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = loss_mod(x, lens, nums)
        loss.backward()
        with torch.no_grad():
            x -= 1e-3 * x.grad
        x.grad = None
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            ms.append(start.elapsed_time(end))
    return statistics.median(ms), min(ms)


def long_steps(dev, steps=10, warmup=2):
    """Main path 7's step in each stream mode and precision: {(precision,
    mode): (median ms, least ms, digest of objf and the gradient)}."""
    from pychain_tpu_torch.loss import chain_function
    from pychain_tpu_torch.ops import fact_kernels as fk
    den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    den = ChainGraph(den_fst)
    real = fk.stream_budget
    out = {}
    for prec, tile, T in (("fast", "bfloat16", 3700), ("parity", None, 1000)):
        B = 64
        batch = ChainGraphBatch(den, B, tile_dtype=tile, device=dev)
        x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                        .manual_seed(70), device=dev).requires_grad_(True)
        lens = torch.full((B,), T, dtype=torch.int32)
        row = T * batch._fact.s_pad * B * fk.stream_dtype(batch._fact).itemsize
        for mode, budget in (("full", None), ("lean", row), ("ckpt", 1)):
            fk.stream_budget = real if budget is None else (
                lambda device, b=budget: b)
            try:
                ms = []
                for i in range(warmup + steps):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    objf = chain_function(x, lens, batch)
                    objf.backward()
                    end.record()
                    torch.cuda.synchronize()
                    if i >= warmup:
                        ms.append(start.elapsed_time(end))
                    if i < warmup + steps - 1:
                        x.grad = None
            finally:
                fk.stream_budget = real
            h = hashlib.sha256(objf.detach().cpu().numpy().tobytes())
            h.update(x.grad.cpu().numpy().tobytes())
            x.grad = None
            out[(prec, mode)] = (statistics.median(ms), min(ms),
                                 h.hexdigest()[:16])
        del x, batch
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    main4 = "--main4" in argv
    long = "--long" in argv
    argv = [a for a in argv if a not in ("--main4", "--long")]
    label = argv[0] if argv else "step"
    dev = resolve_device(None)
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    if long:
        print(label, "; ".join(
            f"{prec} {mode}: median {med:.3f} min {least:.3f} ms digest "
            f"{digest}" for (prec, mode), (med, least, digest)
            in long_steps(dev).items()), flush=True)
        return
    B, T = 128, 500
    if main4:
        den_fst, P = denominator_fst(num_phones=6000, states_per_phone=2,
                                     num_pdfs=3000, seed=0,
                                     bigram_fanout=30,
                                     forward_pdf_mode="separate")
    else:
        den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                     seed=0, bigram_fanout=30)
    den = ChainGraph(den_fst)
    rng = np.random.RandomState(0)
    nums = ChainGraphBatch(
        [ChainGraph(linear_fst(rng.randint(0, P, size=T)), log_domain=True)
         for _ in range(B)], max_num_transitions=T, max_num_states=T + 1,
        device=dev)
    lens = torch.full((B,), T, dtype=torch.int32)
    out = []
    for prec in ("parity", "fast"):
        med, least = step_times(ChainLoss(den, precision=prec), nums, lens,
                                P, dev)
        out.append(f"{prec}: median {med:.3f} min {least:.3f} ms")
    print(label, "; ".join(out), flush=True)


if __name__ == "__main__":
    main()
