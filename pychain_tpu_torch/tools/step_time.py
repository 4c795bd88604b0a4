#!/usr/bin/env python3
"""Main path 1's (or 4's) step on the card, for A/Bs between two trees.

    python -m pychain_tpu_torch.tools.step_time LABEL [--main4]

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
its own package first on PYTHONPATH).  It needs a card.
"""

from __future__ import annotations

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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    main4 = "--main4" in argv
    argv = [a for a in argv if a != "--main4"]
    label = argv[0] if argv else "step"
    dev = resolve_device(None)
    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
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
