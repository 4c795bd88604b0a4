#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pychain_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero.
Every loss kernel is held to its plain version with objf relative and
gamma and traces absolute errors of at most 1e-4, and gamma and the
alpha' stream also entry by entry: |d| <= 1e-3 |ref| + 1e-7.

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the eight sources of csrc/*.cu with nvcc (sm_90a), all at
   once, one nvcc each, and check that each kernel's shared memory size
   in Python equals its source's; then run tests/test_torch_card.py (the
   kernels against their plain versions, in pytest) in a fresh
   interpreter without tests/conftest.py, which imports JAX: every test
   must pass and none skip;
3. the denominator kernels (fact_fwd, fact_bwd) against their plain
   PyTorch version on the card: small graphs in the three x_src modes
   with unequal lengths and debug True/False, then the headline graph
   (bench.py's: denominator_fst(1500, 2, bigram_fanout=30), S=3000,
   K=49.5k, P=3000) at B=128, T=500: the gather wavefronts a frame of
   each operator in ascending and in B1/B2's bank order (at most 1.6 a
   slot-warp for W1 and W1^T), fact_bwd's ring depth (two stages here),
   gamma bit-identical on a rerun, with the kernels' and the plain
   version's times, and the cluster kernels' (phase 11) at their plans
   and at C=2, G=1;
4. the semiring kernels (semiring_fwd, semiring_bwd) against their plain
   version: small cyclic (random_fst), sausage (sausage_fst) and
   flat-start (make_numerator_fst) batches with unequal lengths and one
   infeasible sequence, the backward run twice for bit-identical gamma;
   then one batch of each size class the JAX package splits over three
   TPU kernel pairs, with each kernel's layout (semiring_kernels.plan:
   threads, ring stages, resident lists, gamma rows), the kernels' and
   the plain version's times:
   "semiring" (B5/B6) the flat-start batch of main path 2, "xl" (B7/B8)
   bench.py --xl (B=128, T=500, random_fst(1000, 3000, 5)), "xlstream"
   (B9/B10) tools/xl_stream_indomain.py (B=32, T=150,
   random_fst(3500, 512, 3));
5. main path 1: ChainLoss(den) with B=128 linear numerators over
   random pdf sequences of length T=500 and a (128, 500, 3000) float32
   leaf x, three SGD steps; the loss must be finite and fall, the
   gradient finite, and each step must launch each denominator kernel
   exactly once; one step timed with CUDA events after the warm-up step;
6. main path 2, the same with flat-start numerators
   (make_numerator_fst, lm=None; N_b phones drawn from 100..150, T=500,
   padded to K=300, S=151): each step must launch each of the four
   kernels exactly once; then one profiled step;
7. the Viterbi kernel (viterbi) against its plain version, bit for bit
   (objf, pdfs, states, ok): small cyclic batches at unequal lengths
   with a linear graph at a length it cannot accept and a length 0,
   under x of which about a fifth lies beyond the [-30, 30] clamp, a
   shared broadcast batch, and a tie-heavy batch of +-8 oracle
   emissions;
8. main path 3, realignment (examples/train_corpus.py:552-586):
   viterbi_align over main path 2's batch and x, durations and
   tolerance-3 constrained numerators (make_constrained_numerator) from
   each best path, then three ChainLoss SGD steps on them: the loss
   must fall, the alignment launch viterbi once and each step each of
   the four loss kernels once; then the semiring kernels at this
   constrained batch ("xl" by the JAX package's rule) as in phase 4;
9. three size classes of the Viterbi kernel, each bit-identical to the
   plain version, with both times and the bound: "realign" (main path
   2's batch and x), "b11" (bench.py --viterbi: B=128, T=500,
   random_fst(512, 512, 4)), "decode" (the graph of phase 10);
10. decoding: PhoneDecoder over a bigram phone LM of 2,000 seeded
   transcripts of 20-60 phones over 48 phones (ChainTopology(48): S=49,
   K=2,400, P=96), once on random x and once on +-8 oracle emissions, at
   B=128, T=500, lengths 250..500: one launch per call, and the oracle
   decode must give the planned phones (PER 0) and durations;
11. the cluster kernels (stream_fwd, stream_bwd: B3/B4) against their
   plain version on small graphs in the three x_src modes (and one where
   some ranks own no rows) at every plan
   (C CTAs a cluster in 1, 2, 4, 8, G columns a CTA in 1, 2, 4), B=5
   columns of unequal lengths and debug True/False, each gamma
   bit-identical on a rerun and across G; then the "s8k" class
   (bench.py --s8k: denominator_fst(4000, 2, bigram_fanout=30), B=64,
   T=300, which the JAX package streams in float32) forced to
   engine="stream": the plans (C, G, CTAs, active clusters, waves,
   shared memory), against the plain version and against B1/B2 on the
   same inputs, with both pairs' times and the cluster pair's at every
   plan that fits; B1/B2 themselves against the plain version there (one
   ring stage) and on an identity graph past one stage
   (denominator_fst(6000, 2, bigram_fanout=4), S_pad 12,032, no ring:
   the rows read from device memory) at B=6, T=40, gamma bit-identical
   on a rerun;
12. main path 4: ChainLoss over the 12k-state Kaldi-topology denominator
   (denominator_fst(6000, 2, num_pdfs=3000, bigram_fanout=30,
   forward_pdf_mode="separate"): S=12,000, K=198,000, P=6,000, past one
   block's shared memory) with B=128 linear numerators of length T=500
   over random pdfs in [0, 6000): the tier and plans the dispatch picks,
   the pair against the plain version at full B with debug True and
   False, with both times (and the pair's at every plan), three SGD
   steps (loss finite and falling, gradient finite, one launch of each
   cluster kernel a step and none of B1/B2), a timed and a profiled step;
13. the XL roofline probe (pychain_tpu_torch/tools/xl_roofline.py: T1
   as xl_vpu on the CUDA cores, T2 as xl_mxu on the tensor cores in its
   f32 and bf16 forms): each form against its plain version on small
   shapes (K not a multiple of 16, S not a multiple of 8, a state no arc
   enters; xl_vpu twice, bit-identical) and at the tool's default size
   (S=1000, K=3200, T=512, B=8), relative error with the tool's 1e-9
   floor at most 1e-5 (f32 forms) and 5e-3 (bf16), each form's drift
   against vpu printed; then the probe's own path, the tool's main()
   at the default size with 5 iterations, with the launch counts read;
14. one JSON line {"kernels": [...]} with each kernel's launches on the
   path that runs it (the xl_* rows: the probe's), its error against the
   plain version, its time, the plain version's time and the least time
   the card could take (bound_ms); the semiring and Viterbi kernels get
   one row per size class (the semiring kernels also one for main path
   3's batch, and their layouts; main paths 2 and 3 launch them three
   times each), the cluster kernels one for main path 4 and one for s8k,
   each with its plan;
15. the card's name and power limit, then the last line
   {"ok": true, "device": {...}}.

Without a CUDA device it exits non-zero and prints no result.  It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Hopper H100 SXM peaks at a 700 W power limit (NVIDIA data sheet):
# float32 and float64 outside the tensor cores, and device memory
# bandwidth.  The semiring kernels' arithmetic is float64.
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_BYTES = 3.35e12
PEAK_BF16_TC_FLOPS = 989e12   # dense, tensor cores
TOL = 1e-4   # objf relative, gamma and traces absolute (docs/PARITY.md:21)
# and, entry by entry, gamma and the alpha' stream: |d| <= RTOL |ref| + ATOL.
# An entry of gamma or alpha' is about 1/P or 1/S_pad (1.7e-4 at P=6,000),
# the size of TOL itself; both are sums of positive terms, so float32
# rounding keeps each entry's relative error small.
RTOL, ATOL = 1e-3, 1e-7


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else \
        f"nvidia-smi rc={out.returncode}"


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card over reps calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def absmax(a, b):
    return float((a.double() - b.double()).abs().max())


def excess(got, ref):
    """Entry-wise |got - ref| / (ATOL + RTOL |ref|): at most 1 passes."""
    return ((got - ref).abs() / (ATOL + RTOL * ref.abs()))


def compare(fa, px, lens, leaky_c, debug, label, run=None):
    """Kernel path (``run``, default B1/B2's) vs plain path on the same
    inputs.  Returns the observed errors."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops.factorized import forward_backward_prob_fact
    run = run or fk.forward_backward_prob_kernel
    got = run(px, lens, fa, leaky_c, debug=debug)
    ref = forward_backward_prob_fact(px, lens, fa, leaky_c)
    torch.cuda.synchronize()
    if not debug:
        ref = fk._frame0_traces(ref)
    errs = {"objf_rel": rel(got.objf, ref.objf),
            "gamma_abs": absmax(got.gamma, ref.gamma),
            "alpha_beta_abs": absmax(got.alpha_beta, ref.alpha_beta),
            "gamma_sum_abs": absmax(got.gamma_sum, ref.gamma_sum)}
    gamma_excess = float(excess(got.gamma, ref.gamma).max())
    print(f"# {label} debug={debug}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items())
        + f" gamma_excess={gamma_excess:.3e}", flush=True)
    for k, v in errs.items():
        check(v <= TOL, f"{label} debug={debug}: {k}={v:.3e} > {TOL}")
    check(gamma_excess <= 1.0, f"{label} debug={debug}: a gamma entry "
          f"differs by {gamma_excess:.3e} x ({RTOL} |ref| + {ATOL})")
    check(bool(got.ok.all()), f"{label}: ok flags {got.ok.tolist()}")
    return {**errs, "gamma_excess": gamma_excess}


def alpha_err(fa, px, lens, leaky_c, label, fwd=None):
    """Forward kernel alone (``fwd``, default fact_fwd): its alpha' stream
    (absolute and entry by entry) and sums (relative) against the plain
    forward sweep on frames before each column's end.  Returns the larger
    of the absolute and relative errors, and the largest entry's excess
    (:func:`excess`)."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops.factorized import (forward_prob_fact,
                                                  px_time_major)
    ad_ys, _, _, _, s_ys, _, _, _ = (fwd or fk.fact_fwd)(
        px, lens.int(), fa, leaky_c)
    alpha_dash, alpha_sums, _, _ = forward_prob_fact(
        px_time_major(px, fa), lens.long(), fa, leaky_c)
    B, T, _ = ad_ys.shape
    live = torch.arange(T, device=px.device)[None, :] < lens[:, None]
    ref_ad = alpha_dash[1:].permute(2, 0, 1)               # (B, T, S_pad)
    ref_s = alpha_sums[1:].t()
    err_ad = float(torch.where(live, (ad_ys - ref_ad).abs().amax(dim=2),
                               0.0).max())
    err_s = float(torch.where(live, (s_ys - ref_s).abs() / ref_s.abs(),
                              0.0).max())
    ad_excess = float(torch.where(live, excess(ad_ys, ref_ad).amax(dim=2),
                                  0.0).max())
    print(f"# {label} alpha' stream: abs err {err_ad:.3e}, excess "
          f"{ad_excess:.3e}; s_t rel err {err_s:.3e}", flush=True)
    check(max(err_ad, err_s) <= TOL, f"{label}: alpha' stream err "
          f"{err_ad:.3e}, s_t rel err {err_s:.3e} > {TOL}")
    check(ad_excess <= 1.0, f"{label}: an alpha' entry differs by "
          f"{ad_excess:.3e} x ({RTOL} |ref| + {ATOL})")
    return max(err_ad, err_s), ad_excess


def worst(errs):
    """Key by key, the largest of several compare() results."""
    errs = list(errs)
    return {k: max(e[k] for e in errs) for k in errs[0]}


MODES = (("source", "identity"), ("cross", "matrix"), ("separate", "stream"))


def pair_times(fa, px, lens, leaky_c, fwd, bwd, reps, plain=True):
    """CUDA-event milliseconds of a denominator kernel pair alone (fwd,
    bwd: the signatures of fact_fwd / fact_bwd) and, with ``plain``, of
    the plain version of each sweep, on the same inputs."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops.factorized import (backward_prob_fact,
                                                  forward_prob_fact,
                                                  px_time_major)
    P = px.shape[2]
    lens32 = lens.int()
    ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = fwd(px, lens32, fa,
                                                          leaky_c)
    objf, tot = fk._objf(s_ys, ad_last, lens32, fa, s0)

    def run_bwd():
        return bwd(lens32, fa, leaky_c, ad_ys, w1ad, xdst, xsrc, s_ys, ad0,
                   s0, tot.contiguous(), P, debug=False)

    run_bwd()
    fwd_ms = cuda_ms(lambda: fwd(px, lens32, fa, leaky_c), reps)
    bwd_ms = cuda_ms(run_bwd, reps)
    del ad_ys, w1ad, xdst, xsrc
    if not plain:
        return fwd_ms, bwd_ms
    px_tm = px_time_major(px, fa)
    with torch.no_grad():
        plain = forward_prob_fact(px_tm, lens.long(), fa, leaky_c)
        plain_fwd_ms = cuda_ms(
            lambda: forward_prob_fact(px_tm, lens.long(), fa, leaky_c), 2)
        plain_bwd_ms = cuda_ms(
            lambda: backward_prob_fact(px_tm, lens.long(), fa, leaky_c,
                                       plain[0], plain[1], plain[3]), 2)
    return fwd_ms, bwd_ms, plain_fwd_ms, plain_bwd_ms


def cluster_pair(C, G):
    """The cluster kernels with C and G forced."""
    from pychain_tpu_torch.ops import stream_kernels as stk
    return (functools.partial(stk.stream_fwd, cluster=C, columns=G),
            functools.partial(stk.stream_bwd, cluster=C, columns=G))


def stream_plans(fa, B, label):
    """Each cluster kernel's plan for this graph at B columns on this
    card, printed with cudaOccupancyMaxActiveClusters; returns
    {kernel: plan dict}."""
    from pychain_tpu_torch.ops import stream_kernels as stk
    plans = stk.plan(fa, B, torch.cuda.get_device_properties(0))
    out = {}
    for name, p in plans.items():
        out[name] = {**dataclasses.asdict(p),
                     "active_clusters": stk.active_clusters(fa, p)}
        print(f"# {label} plan {name}: C={p.cluster} G={p.columns} "
              f"threads={p.threads} CTAs={p.ctas} (per SM {p.ctas_per_sm}) "
              f"active clusters={out[name]['active_clusters']} "
              f"waves={p.waves} smem={p.smem} cost={p.cost}", flush=True)
    return out


def plan_times(fa, px, lens, leaky_c, label, reps=3):
    """CUDA-event ms of each kernel at every plan that fits (C, G), on the
    same inputs; printed, cheapest by the plan's rule first."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    props = torch.cuda.get_device_properties(0)
    B, T, P = px.shape
    lens32 = lens.int()
    ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = stk.stream_fwd(
        px, lens32, fa, leaky_c)
    _, tot = fk._objf(s_ys, ad_last, lens32, fa, s0)
    tot = tot.contiguous()
    out = {}
    for name in stk.LAUNCHES:
        for p in stk.candidates(fa, name, B, props):
            if name == "stream_fwd":
                fn = lambda: stk.stream_fwd(px, lens32, fa, leaky_c,
                                            cluster=p.cluster,
                                            columns=p.columns)
            else:
                fn = lambda: stk.stream_bwd(
                    lens32, fa, leaky_c, ad_ys, w1ad, xdst, xsrc, s_ys, ad0,
                    s0, tot, P, debug=False, cluster=p.cluster,
                    columns=p.columns)
            fn()
            out[f"{name} C={p.cluster} G={p.columns}"] = cuda_ms(fn, reps)
    print(f"# {label} times at every plan (ms, the rule's order): "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items()), flush=True)
    for name in stk.LAUNCHES:
        mine = {k: v for k, v in out.items() if k.startswith(name + " ")}
        pick, fastest = next(iter(mine)), min(mine, key=mine.get)
        print(f"# {label} {name}: the rule's plan {pick[len(name) + 1:]} "
              f"{mine[pick]:.3f} ms, the fastest timed "
              f"{fastest[len(name) + 1:]} {mine[fastest]:.3f} ms",
              flush=True)
    return out


def fact_bytes_ops(fa, kg, lens, T, P):
    """What a denominator sweep pair must move and compute for this run
    (L live frames): the forward reads px at the pdfs the graph reads and
    the graph once, and writes the streams, s_t and alpha'(T_b); the
    backward reads the streams, s_t, the graph and its pdf lists, and
    writes gamma and the two traces.  Returns (fwd_bytes, fwd_ops,
    bwd_bytes, bwd_ops)."""
    B, L = lens.shape[0], int(lens.sum())
    n_streams = 3 if fa.xsrc_mode == "identity" else 4
    s_pad, nnz = fa.s_pad, kg.nnz
    graph_bytes = nnz * 8 + (s_pad + 1) * 8 + 4 * s_pad * 4
    pdfs = set(kg.f_dst.tolist())
    if kg.g_src is not None:
        pdfs |= set(kg.g_src.tolist())
    fwd_bytes = (L * len(pdfs) * 4 + graph_bytes
                 + n_streams * L * s_pad * 4 + B * T * 4 + B * s_pad * 4)
    fwd_ops = 2 * nnz * L + 7 * s_pad * L
    bwd_bytes = (n_streams * L * s_pad * 4 + B * T * 4 + graph_bytes
                 + (fa.p_pad + 1 + s_pad) * 4 + B * T * P * 4 + 2 * B * T * 4)
    bwd_ops = 2 * nnz * L + 15 * s_pad * L
    return fwd_bytes, fwd_ops, bwd_bytes, bwd_ops


def resident_layout(fa, kg, label):
    """B1/B2's operators for this graph (fact_kernels.bank_order): each
    one's shared-memory gather wavefronts a frame in the ascending order
    (the cluster kernels') and in B1/B2's bank order, and each kernel's
    ring depth (fact_fwd has none).  Returns ({op: (slot-warps, ascending,
    bank order)}, fact_bwd's ring depth)."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    out = {}
    for name, op in zip(("w1", "w2", "w1t", "w2t"), kg.resident):
        asc = fk.gather_wavefronts(getattr(kg, name))
        banked = fk.gather_wavefronts(op)
        check(len(asc) == len(banked), f"{label} {name}: slot counts differ")
        out[name] = (len(asc), int(asc.sum()), int(banked.sum()))
    stages = fk.ring_stages(fa)
    print(f"# {label}: gather wavefronts a frame, ascending -> bank order "
          "(slot-warps; a slot-warp each): " + ", ".join(
              f"{k} {a} -> {b} ({n}; {a / max(n, 1):.3f} -> "
              f"{b / max(n, 1):.3f})" for k, (n, a, b) in out.items())
          + f"; ring depth: fact_fwd none, fact_bwd {stages} stage(s), "
          f"smem {fk.smem_bytes(fa)}", flush=True)
    return out, stages


def resident_rerun(fa, px, lens, leaky_c, label):
    """B1/B2 twice on the same inputs: gamma bit-identical."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    g1 = fk.forward_backward_prob_kernel(px, lens, fa, leaky_c).gamma
    g2 = fk.forward_backward_prob_kernel(px, lens, fa, leaky_c).gamma
    torch.cuda.synchronize()
    check(torch.equal(g1, g2), f"{label}: two runs of B1/B2 give "
          "different gamma")
    print(f"# {label}: B1/B2 gamma bit-identical over two runs", flush=True)


def ringless_class(dev, leaky_c):
    """B1/B2 on an identity graph past one ring stage (S_pad 12,032:
    fact_bwd reads its stream rows from device memory, ring depth 0)
    against the plain version, at B=6, T=40 with lengths T, T-2, 3, 1, 17,
    T-1; bigram fanout 4 keeps the host's bank-order search short."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    t0 = time.perf_counter()
    fst, P = denominator_fst(num_phones=6000, states_per_phone=2, seed=0,
                             bigram_fanout=4)
    fa = ChainGraphBatch(ChainGraph(fst), 6, device=dev)._fact
    kg = fk.graph_for(fa)
    print(f"# ringless graph: S_pad={fa.s_pad} xsrc_mode={fa.xsrc_mode} "
          f"nnz={kg.nnz}; built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _, stages = resident_layout(fa, kg, "ringless graph")
    check(stages == 0 and fk.fits_on_chip(fa),
          f"ringless graph: ring depth {stages}, fits {fk.fits_on_chip(fa)}")
    T = 40
    g = torch.Generator(device=dev).manual_seed(13)
    px = torch.exp(torch.randn(6, T, P, generator=g, device=dev))
    lens = torch.tensor([T, T - 2, 3, 1, 17, T - 1], device=dev)
    errs = worst(compare(fa, px, lens, leaky_c, debug, "ringless B1/B2")
                 for debug in (False, True))
    resident_rerun(fa, px, lens, leaky_c, "ringless graph")
    return errs


def check_smem():
    """Each kernel's shared memory in Python equals its source's."""
    import ctypes
    import types
    from pychain_tpu_torch.csrc import build
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    c_size = lambda name, *args: getattr(
        build.load(name), f"{name}_smem_bytes")(*args)
    for name in ("fact_fwd", "fact_bwd", "stream_fwd", "stream_bwd"):
        getattr(build.load(name), f"{name}_smem_bytes").restype = \
            ctypes.c_size_t
    for s_pad, mode in ((3072, "identity"), (12032, "stream"),
                        (384, "matrix"), (24320, "identity")):
        fa = types.SimpleNamespace(s_pad=s_pad, xsrc_mode=mode)
        identity = int(mode == "identity")
        got = {f"fact_bwd stages={k}": fk.smem_bytes(fa, k)["fact_bwd"]
               for k in (0, 1, 2)}
        got["fact_fwd"] = fk.smem_bytes(fa)["fact_fwd"]
        want = {f"fact_bwd stages={k}": c_size("fact_bwd", s_pad, identity,
                                               k) for k in (0, 1, 2)}
        want["fact_fwd"] = c_size("fact_fwd", s_pad)
        for C in stk.CLUSTERS:
            rows = stk.rows_per_cta(s_pad, C)
            for G in stk.COLUMNS:
                got.update({f"{k} C={C} G={G}": v for k, v in
                            stk.smem_bytes(fa, C, G).items()})
                want[f"stream_fwd C={C} G={G}"] = c_size(
                    "stream_fwd", s_pad, rows, C, G)
                want[f"stream_bwd C={C} G={G}"] = c_size(
                    "stream_bwd", s_pad, rows, identity, G)
        check(got == want, f"smem_bytes S_pad={s_pad} {mode}: Python {got} "
              f"!= sources {want}")
    from pychain_tpu_torch.tools import xl_roofline as xr
    xl = build.load("xl_roofline")
    for fn in (xl.xl_vpu_smem_bytes, xl.xl_mxu_smem_bytes):
        fn.restype = ctypes.c_size_t
    for S, K in ((1000, 3200), (37, 45), (4000, 20000)):
        check(xr.vpu_smem_bytes(S, K) == xl.xl_vpu_smem_bytes(S, K),
              f"xl_vpu smem S={S} K={K}: Python {xr.vpu_smem_bytes(S, K)} "
              f"!= source {xl.xl_vpu_smem_bytes(S, K)}")
        for split in (1, 3):
            py = xr.mxu_smem_bytes(S, K, split)
            c = xl.xl_mxu_smem_bytes(S, K, split)
            check(py == c, f"xl_mxu smem S_pad={S} K_pad={K} split={split}: "
                  f"Python {py} != source {c}")
    from pychain_tpu_torch.ops import semiring_kernels as sk
    for name in ("semiring_fwd", "semiring_bwd"):
        getattr(build.load(name), f"{name}_smem_bytes").restype = \
            ctypes.c_size_t
    up = lambda n, m: -(-n // m) * m
    for S, K, P, E in ((151, 300, 3000, 300), (1391, 2280, 3000, 600),
                       (37, 45, 13, 7), (3500, 7091, 512, 512)):
        for res, st in sk.FWD_LADDER:
            py = sk.fwd_smem_bytes(S, K, st, res)
            c = c_size("semiring_fwd", S, K, up(K, 4), st, int(res))
            check(py == c, f"semiring_fwd smem S={S} K={K} stages={st} "
                  f"resident={res}: Python {py} != source {c}")
        for res, st, pipe, grows in sk.BWD_LADDER:
            py = sk.bwd_smem_bytes(S, K, P, E, st, res, pipe, grows)
            c = c_size("semiring_bwd", S, K, up(K, 4), up(S, 2), up(P, 4),
                       E, st, int(res), int(pipe), int(grows))
            check(py == c, f"semiring_bwd smem S={S} K={K} P={P} E={E} "
                  f"{(res, st, pipe, grows)}: Python {py} != source {c}")
    print("# shared memory: Python sizes equal the sources' "
          "(fact_fwd, fact_bwd with a ring of 0, 1, 2 stages, stream_* at "
          "C = 1, 2, 4, 8 and G = 1, 2, 4, xl_vpu, xl_mxu, semiring_* at "
          "every layout of their ladders)", flush=True)


def card_tests():
    """tests/test_torch_card.py on this card, in a fresh interpreter
    without tests/conftest.py (which imports JAX): every test must pass
    and none skip."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", "-rs", "tests/test_torch_card.py"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    passed = re.search(r"(\d+) passed", summary)
    check(out.returncode == 0 and passed is not None and not re.search(
              r"skipped|failed|error|xfail|xpass|deselected", summary),
          f"card tests (pytest rc={out.returncode}): {summary}\n"
          f"{out.stdout[-6000:]}\n{out.stderr[-2000:]}")
    print(f"# card tests (tests/test_torch_card.py, --noconftest): "
          f"{passed.group(1)} passed, none skipped, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def stream_small(dev, leaky_c):
    """The cluster pair against the plain version on small graphs
    (S_pad = 384: with C = 8 some CTAs own one slice, others two; and
    S_pad = 128, where ranks 4-7 of 8 own none) at every (C, G), C in 1,
    2, 4, 8 and G in 1, 2, 4, with B = 5 columns of unequal lengths (no
    G > 1 divides B); gamma bit-identical on a rerun and across G at
    each C."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    errs = []
    for (mode, want), phones in zip(MODES + MODES[-1:], (150, 150, 150, 10)):
        fst, P = denominator_fst(num_phones=phones, states_per_phone=2,
                                 seed=3, forward_pdf_mode=mode)
        fa = ChainGraphBatch(ChainGraph(fst), 5, device=dev)._fact
        check(fa.xsrc_mode == want,
              f"{mode}: xsrc_mode {fa.xsrc_mode} != {want}")
        g = torch.Generator(device=dev).manual_seed(1)
        px = torch.exp(torch.randn(5, 16, P, generator=g, device=dev))
        lens = torch.tensor([16, 11, 7, 1, 13], device=dev)
        for C in stk.CLUSTERS:
            first = None
            for G in stk.COLUMNS:
                run = functools.partial(stk.forward_backward_prob_stream,
                                        cluster=C, columns=G)
                for debug in (True, False):
                    errs.append(compare(
                        fa, px, lens, leaky_c, debug, f"stream small {mode} "
                        f"S_pad={fa.s_pad} C={C} G={G}", run))
                g1 = run(px, lens, fa, leaky_c).gamma
                g2 = run(px, lens, fa, leaky_c).gamma
                torch.cuda.synchronize()
                check(torch.equal(g1, g2), f"stream small {mode} C={C} "
                      f"G={G}: two runs give different gamma")
                first = g1 if first is None else first
                check(torch.equal(g1, first), f"stream small {mode} C={C}: "
                      f"gamma at G={G} differs from G=1")
    print("# stream small: gamma bit-identical over two runs and across G "
          "at every mode and cluster size", flush=True)
    return errs


def s8k_class(dev, leaky_c):
    """bench.py --s8k's graph at B=64, T=300 (the JAX package streams it
    in float32) forced to engine="stream": against the plain version and
    against B1/B2 on the same inputs, with both pairs' times and the
    cluster pair's at every plan."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    B, T = 64, 300
    t0 = time.perf_counter()
    den_fst, P = denominator_fst(num_phones=4000, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    den = ChainGraph(den_fst)
    fa = dataclasses.replace(ChainGraphBatch(den, B, device=dev)._fact,
                             engine="stream")
    kg = fk.graph_for(fa)
    print(f"# s8k graph: S={den.num_states} K={den.num_transitions} P={P} "
          f"s_pad={fa.s_pad} xsrc_mode={fa.xsrc_mode} nnz={kg.nnz}; "
          f"engine={fa.engine}; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _, stages = resident_layout(fa, kg, "s8k")
    check(stages == 1, f"s8k: fact_bwd ring {stages} != 1")
    plans = stream_plans(fa, B, "s8k")
    gx = torch.Generator(device=dev).manual_seed(12)
    px = torch.exp(torch.randn(B, T, P, generator=gx, device=dev))
    lens = torch.full((B,), T, device=dev)
    errs = worst(compare(fa, px, lens, leaky_c, debug, "s8k stream",
                         stk.forward_backward_prob_stream)
                 for debug in (False, True))
    a_err = alpha_err(fa, px, lens, leaky_c, "s8k", stk.stream_fwd)
    # B1/B2 themselves (one ring stage here) against the plain version
    errs_b12 = worst(compare(fa, px, lens, leaky_c, debug, "s8k B1/B2")
                     for debug in (False, True))
    alpha_err(fa, px, lens, leaky_c, "s8k B1")
    got = stk.forward_backward_prob_stream(px, lens, fa, leaky_c)
    res = fk.forward_backward_prob_kernel(px, lens, fa, leaky_c)
    vs_b12 = {"objf_rel": rel(got.objf, res.objf),
              "gamma_abs": absmax(got.gamma, res.gamma)}
    del got, res
    print(f"# s8k: stream pair vs B1/B2 on the same inputs: {vs_b12}",
          flush=True)
    for k, v in vs_b12.items():
        check(v <= TOL, f"s8k: stream vs B1/B2 {k}={v:.3e}")
    times = pair_times(fa, px, lens, leaky_c, stk.stream_fwd, stk.stream_bwd,
                       5)
    fact_ms = pair_times(fa, px, lens, leaky_c, fk.fact_fwd, fk.fact_bwd,
                         5, plain=False)
    plan_times(fa, px, lens, leaky_c, "s8k")
    print(f"# s8k times: stream_fwd {times[0]:.3f} ms, stream_bwd "
          f"{times[1]:.3f} ms (plans above); fact_fwd {fact_ms[0]:.3f} ms, "
          f"fact_bwd {fact_ms[1]:.3f} ms; plain fwd {times[2]:.1f} ms, "
          f"plain bwd {times[3]:.1f} ms", flush=True)
    return (errs, a_err, times, fact_bytes_ops(fa, kg, lens, T, P), plans,
            errs_b12, fact_ms)


def main_path_4(dev, leaky_c, counters):
    """Main path 4: ChainLoss over the 12k-state Kaldi-topology
    denominator at B=128, T=500 with linear numerators."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch, ChainLoss
    from pychain_tpu_torch import loss as pt_loss
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import (denominator_fst,
                                                    linear_fst)
    B, T = 128, 500
    t0 = time.perf_counter()
    den_fst, P = denominator_fst(num_phones=6000, states_per_phone=2,
                                 num_pdfs=3000, seed=0, bigram_fanout=30,
                                 forward_pdf_mode="separate")
    den = ChainGraph(den_fst)
    loss_mod = ChainLoss(den)
    fa = pt_loss.dispatch_arrays(loss_mod.den_batch(B))
    engine = pt_loss.den_engine(fa)
    check(engine == "stream", f"main path 4: tier {engine!r}")
    kg = fk.graph_for(fa)
    print(f"# main path 4 graph: S={den.num_states} K={den.num_transitions} "
          f"P={P} s_pad={fa.s_pad} p_pad={fa.p_pad} xsrc_mode="
          f"{fa.xsrc_mode} nnz(W1+W2)={kg.nnz}; tier engine={engine!r} "
          f"(B1/B2 would need {fk.smem_bytes(fa)} of {fk.MAX_SMEM} bytes); "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    plans = stream_plans(fa, B, "main path 4")
    gx = torch.Generator(device=dev).manual_seed(10)
    px = torch.exp(torch.randn(B, T, P, generator=gx, device=dev))
    lens = torch.full((B,), T, device=dev)
    # debug=True: the alpha*beta and sum-gamma traces at every frame
    errs = worst(compare(fa, px, lens, leaky_c, debug, "main path 4",
                         stk.forward_backward_prob_stream)
                 for debug in (False, True))
    a_err = alpha_err(fa, px, lens, leaky_c, "main path 4", stk.stream_fwd)
    times = pair_times(fa, px, lens, leaky_c, stk.stream_fwd, stk.stream_bwd,
                       5)
    plan_times(fa, px, lens, leaky_c, "main path 4")
    print(f"# main path 4 times: stream_fwd {times[0]:.3f} ms, stream_bwd "
          f"{times[1]:.3f} ms (plans above); plain fwd {times[2]:.1f} ms, "
          f"plain bwd {times[3]:.1f} ms", flush=True)
    del px
    torch.cuda.empty_cache()

    rng = np.random.RandomState(4)
    nums = [ChainGraph(linear_fst(rng.randint(0, P, size=T)),
                       log_domain=True) for _ in range(B)]
    num_batch = ChainGraphBatch(nums, max_num_transitions=T,
                                max_num_states=T + 1, device=dev)
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(11), device=dev).requires_grad_(True)
    x_lengths = torch.full((B,), T, dtype=torch.int32)
    want = {k: 0 for c in counters for k in c}
    want.update(stream_fwd=1, stream_bwd=1)
    torch.cuda.reset_peak_memory_stats()
    _, step_ms, launches = train_steps(
        loss_mod, x, x_lengths, num_batch, counters, want,
        "main path 4 (12k-state Kaldi-topology denominator)")
    print(f"# main path 4: peak device memory over the steps "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    profiled_step(loss_mod, x, x_lengths, num_batch,
                  "main path 4 (cluster tier)")
    del x
    torch.cuda.empty_cache()
    return (errs, a_err, times, fact_bytes_ops(fa, kg, lens, T, P), plans,
            step_ms, launches)


# ----------------------------------------------------------------------
# The semiring kernels
# ----------------------------------------------------------------------

# (class, TPU kernels the class runs in the JAX package: fwd, bwd)
SR_CLASSES = {
    "semiring": ("pychain_tpu/ops/pallas_semiring.py:132",
                 "pychain_tpu/ops/pallas_semiring.py:231"),
    "xl": ("pychain_tpu/ops/semiring_xl.py:273",
           "pychain_tpu/ops/semiring_xl.py:369"),
    "xlstream": ("pychain_tpu/ops/semiring_xl.py:462",
                 "pychain_tpu/ops/semiring_xl.py:557"),
}


def size_class(batch_size, max_k, max_s):
    """Which TPU kernel pair the JAX package gives a list batch on a TPU:
    "semiring" (B5/B6) within the dense one-hot budget (semiring.py:43)
    and the Pallas one-hot VMEM rule (pallas_semiring.py:69-79), "xl"
    (B7/B8) within the resident mask budget (semiring_xl.py:67,97-102),
    else "xlstream" (B9/B10).  The port runs every class on the same two
    kernels; this only names the class."""
    s8 = (max_s + 7) // 8 * 8
    if (batch_size * max_k * max_s <= 1 << 26
            and 2 * max_k * s8 * 128 * 4 <= 48 * 1024 * 1024):
        return "semiring"
    if 2 * s8 * ((max_k + 127) // 128 * 128) * 2 <= 60 * 1024 * 1024:
        return "xl"
    return "xlstream"


def list_batch(fsts, dev, pad=None):
    """A log-domain list batch of ``fsts``, padded to ``pad`` = (K, S) or
    to the largest graph, and the host milliseconds its constructor took
    (the arc-id arrays and lists, rebuilt every minibatch in training)."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    graphs = [ChainGraph(f, log_domain=True) for f in fsts]
    K, S = pad or (max(g.num_transitions for g in graphs),
                   max(g.num_states for g in graphs))
    t0 = time.perf_counter()
    batch = ChainGraphBatch(graphs, max_num_transitions=K,
                            max_num_states=S, device=dev)
    return batch, (time.perf_counter() - t0) * 1e3


def sr_compare(g, x, lens, label, want_ok=None):
    """Semiring kernels vs plain version on the same inputs; errors."""
    from pychain_tpu_torch.ops import semiring_kernels as sk
    from pychain_tpu_torch.ops.semiring import forward_backward_semiring
    got = sk.forward_backward_semiring_kernel(x, lens, g)
    ref = forward_backward_semiring(x, lens, g)
    torch.cuda.synchronize()
    live = torch.isfinite(ref.objf)
    check(torch.equal(live, torch.isfinite(got.objf)),
          f"{label}: finite objf {got.objf.tolist()} vs {ref.objf.tolist()}")
    check(torch.equal(got.ok, ref.ok), f"{label}: ok {got.ok.tolist()} "
          f"vs plain {ref.ok.tolist()}")
    if want_ok is not None:
        check(got.ok.tolist() == want_ok, f"{label}: ok {got.ok.tolist()}, "
              f"want {want_ok}")
    errs = {"objf_rel": rel(got.objf[live], ref.objf[live]),
            "gamma_abs": absmax(got.gamma, ref.gamma),
            "alpha_beta_abs": absmax(got.alpha_beta, ref.alpha_beta),
            "gamma_sum_abs": absmax(got.gamma_sum, ref.gamma_sum)}
    print(f"# {label}: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items()),
          flush=True)
    for k, v in errs.items():
        check(v <= TOL, f"{label}: {k}={v:.3e} > {TOL}")
    dead = ~live
    check(bool((got.gamma[dead] == 0).all()), f"{label}: nonzero gamma of "
          "an infeasible sequence")
    return errs


def sr_sweeps(g, x, lens):
    """The glue and both kernels once: what the timing phases rerun."""
    from pychain_tpu_torch.ops import semiring_kernels as sk
    from pychain_tpu_torch.ops.semiring import objective, prepare
    lens32 = lens.int()
    warc, c, n0, lz0 = prepare(x, g, row_align=sk.WARC_ALIGN)
    n_ys, raw, n_last = sk.semiring_fwd(warc, n0, lens32, g)
    rows = objective(raw, n_last, c, lz0, lens32, g)[1:]
    return lens32, warc, n0, (n_ys, raw, n_last), rows


def sr_alpha_err(g, x, lens):
    """Forward kernel alone: its alpha stream and raw sums against the
    plain forward sweep on frames before each sequence's end."""
    from pychain_tpu_torch.ops.semiring import forward_plain
    _, warc, n0, (n_ys, raw, _), _ = sr_sweeps(g, x, lens)
    ref_n, ref_raw = forward_plain(warc, n0, g)
    live = torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None]
    err_n = float(((n_ys - ref_n).abs().amax(dim=2) * live).nan_to_num(
        nan=0.0).max())
    err_raw = float(((raw - ref_raw).abs() / ref_raw.abs().clamp(min=1e-30)
                     * live).max())
    return max(err_n, err_raw)


def bit_identical_gamma(g, x, lens, label):
    from pychain_tpu_torch.ops import semiring_kernels as sk
    lens32, warc, n0, (n_ys, _, _), rows = sr_sweeps(g, x, lens)
    P = x.shape[2]
    g1, ab1 = sk.semiring_bwd(warc, n_ys, n0, lens32, *rows, g, P)
    g2, ab2 = sk.semiring_bwd(warc, n_ys, n0, lens32, *rows, g, P)
    torch.cuda.synchronize()
    check(torch.equal(g1, g2) and torch.equal(ab1, ab2),
          f"{label}: two backward runs differ")
    print(f"# {label}: gamma bit-identical over two backward runs")


def sr_class(name, batch, x, lens, reps, label=None):
    """One size class (or, ``label``, one main path's batch of that
    class): errors, kernel and plain times, bytes and ops, the layouts."""
    from pychain_tpu_torch.ops import semiring_kernels as sk
    from pychain_tpu_torch.ops.semiring import backward_plain, forward_plain
    g = batch.semiring()
    B, T, P = x.shape
    label = label or f"class {name}"
    check(size_class(B, g.k_pad, g.num_states) == name,
          f"{label}: B={B} K={g.k_pad} S={g.num_states} is "
          f"{size_class(B, g.k_pad, g.num_states)!r} in the JAX package, "
          f"not {name!r}")
    layouts = sk.layouts(g, P)
    print(f"# {label}: layouts {layouts}", flush=True)
    errs = sr_compare(g, x, lens, label, want_ok=[True] * B)
    a_err = sr_alpha_err(g, x, lens)
    print(f"# {label}: alpha stream / raw sums err {a_err:.3e}")
    check(a_err <= TOL, f"{label}: alpha stream err {a_err:.3e}")
    lens32, warc, n0, (n_ys, raw, n_last), rows = sr_sweeps(g, x, lens)
    fwd_ms = cuda_ms(lambda: sk.semiring_fwd(warc, n0, lens32, g), reps)
    bwd_ms = cuda_ms(lambda: sk.semiring_bwd(warc, n_ys, n0, lens32, *rows,
                                             g, P), reps)
    with torch.no_grad():
        pn, _ = forward_plain(warc, n0, g)
        plain_fwd_ms = cuda_ms(lambda: forward_plain(warc, n0, g), 1)
        plain_bwd_ms = cuda_ms(lambda: backward_plain(
            warc, pn, n0, lens32, *rows, g, P), 1)
    del pn, n_ys, warc
    # what this run's data needs: frames t < T_b, each graph's own arcs
    # and states (those its arcs touch), 4 bytes a value: a float32 log
    # alpha stream keeps the range the backward needs (it takes alpha's
    # log), so the kernels' float64 stream is their design's choice, not
    # the function's need.  gamma and the trace are written whole.
    lens_l = lens.long()
    real = g.src < g.num_states
    n_arcs = real.sum(dim=1)
    n_states = torch.where(real, torch.maximum(g.src, g.dst),
                           torch.full_like(g.src, -1)).amax(dim=1) + 1
    L = int(lens_l.sum())
    arc_frames = int((lens_l * n_arcs).sum())
    state_frames = int((lens_l * n_states).sum())
    sum_k, sum_s = int(n_arcs.sum()), int(n_states.sum())
    # warc read, alpha stream and raw sums written, n0 read and alpha(T_b)
    # written, src and dst ids read
    fwd_bytes = (4 * arc_frames + 4 * state_frames + 4 * L + 8 * sum_s
                 + 8 * sum_k)
    fwd_ops = 2 * arc_frames + 3 * state_frames
    # warc and the alpha stream read, gamma and the trace written, c_row
    # and cms read for live frames, n0, rf and mf read, src, dst and pdf
    # ids read
    bwd_bytes = (4 * arc_frames + 4 * state_frames + 4 * B * T * P
                 + 4 * B * T + 8 * L + 8 * sum_s + 4 * B + 12 * sum_k)
    bwd_ops = 5 * arc_frames + 4 * state_frames
    print(f"# {label}: B={B} T={T} K_pad={g.k_pad} "
          f"S_pad={g.num_states} P={P} arcs {int(n_arcs.min())}.."
          f"{int(n_arcs.max())} states {int(n_states.min())}.."
          f"{int(n_states.max())}; semiring_fwd "
          f"{fwd_ms:.3f} ms, semiring_bwd {bwd_ms:.3f} ms; plain fwd "
          f"{plain_fwd_ms:.1f} ms, plain bwd {plain_bwd_ms:.1f} ms",
          flush=True)
    return {"class": name, "layouts": layouts,
            "fwd": (fwd_ms, plain_fwd_ms, fwd_bytes, fwd_ops,
                    max(errs["objf_rel"], a_err)),
            "bwd": (bwd_ms, plain_bwd_ms, bwd_bytes, bwd_ops,
                    max(errs["gamma_abs"], errs["alpha_beta_abs"],
                        errs["gamma_sum_abs"]))}


def flat_start_phones(B, num_phones, n_lo, n_hi, seed):
    """B transcripts of N_b phones drawn uniformly from n_lo..n_hi, phone
    ids from 0..num_phones-1."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, num_phones, size=n)
            for n in rng.randint(n_lo, n_hi + 1, size=B)]


def flat_start_fsts(B, num_phones, n_lo, n_hi, seed):
    """The flat-start numerators (make_numerator_fst, lm=None) of
    :func:`flat_start_phones`."""
    from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                                  make_numerator_fst)
    topo = ChainTopology(num_phones=num_phones)
    return [make_numerator_fst(p, topo) for p in
            flat_start_phones(B, num_phones, n_lo, n_hi, seed)]


def train_steps(loss_mod, x, x_lengths, nums, counters, want, label,
                reset=True):
    """Three SGD steps with every launch count set to 0 just before
    (unless the caller did so before more work of its path) and read just
    after; returns (losses, step_ms, launches)."""
    lr = 0.1 * float(x_lengths.sum())
    losses, step_ms, per_step = [], [], []
    for c in counters if reset else ():
        for k in c:
            c[k] = 0
    for step in range(3):
        before = {k: v for c in counters for k, v in c.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = loss_mod(x, x_lengths, nums)
        loss.backward()
        with torch.no_grad():
            grad_ok = torch.isfinite(x.grad).all()
            x -= lr * x.grad
        x.grad = None
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss.detach()))
        per_step.append({k: v - before[k] for c in counters
                         for k, v in c.items()})
        check(bool(grad_ok), f"{label} step {step}: non-finite gradient")
    launches = {k: v for c in counters for k, v in c.items()}
    print(f"# {label}: losses {losses}; step ms {step_ms} (the first "
          f"step may build batches); launches per step {per_step}",
          flush=True)
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    check(losses[0] > losses[1] > losses[2],
          f"{label}: loss did not fall: {losses}")
    for step, n in enumerate(per_step):
        check(n == want, f"{label} step {step} launches {n}, want {want}")
    return losses, step_ms, launches


def profiled_step(loss_mod, x, x_lengths, nums, label):
    """Where one step's device time goes."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss = loss_mod(x, x_lengths, nums)
        loss.backward()
        x.grad = None
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    events.sort(key=lambda e: -e.device_time_total)
    busy_us = sum(e.device_time_total for e in events)
    print(f"# profiled step, {label}: device busy {busy_us / 1e3:.3f} ms "
          f"over {len(events)} kernel names; top kernels (ms, calls):")
    for e in events[:14]:
        print(f"#   {e.device_time_total / 1e3:9.3f} {e.count:4d}  "
              f"{e.key[:90]}")


# ----------------------------------------------------------------------
# The Viterbi kernel
# ----------------------------------------------------------------------

def vit_compare(g, x, lens, label, want_ok=None):
    """Viterbi kernel vs plain version on the same x (each clamps it as
    it reads it): objf, pdfs, states and ok must be bit-identical (the
    kernel adds float32 in the plain version's order and compares).  Returns the number of
    mismatching entries (0) and the largest objf difference (0.0)."""
    from pychain_tpu_torch.ops import viterbi_kernels as vk
    from pychain_tpu_torch.ops.viterbi import viterbi_plain
    got = vk.viterbi_kernel(x, lens, g)
    ref = viterbi_plain(x, lens, g)
    torch.cuda.synchronize()
    bad = {k: int((getattr(got, k) != getattr(ref, k)).sum())
           for k in ref._fields}
    live = torch.isfinite(ref.objf)
    err = float((got.objf[live] - ref.objf[live]).abs().max()) \
        if bool(live.any()) else 0.0
    print(f"# {label}: mismatches {bad}, objf max abs diff {err:.3e}, ok "
          f"{int(got.ok.sum())}/{len(got.ok)}", flush=True)
    check(sum(bad.values()) == 0, f"{label}: kernel differs from the plain "
          f"version: {bad}")
    if want_ok is not None:
        check(got.ok.tolist() == want_ok, f"{label}: ok {got.ok.tolist()}, "
              f"want {want_ok}")
    check(bool((got.pdfs[~got.ok] == -1).all()), f"{label}: a path on an "
          "infeasible sequence")
    return sum(bad.values()), err


def vit_small(dev):
    """The kernel against its plain version on small batches."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                                  alignment_to_pdf_sequence,
                                                  make_numerator_fst)
    from pychain_tpu_torch.graphs.fst import FST
    from pychain_tpu_torch.utils.testgraphs import linear_fst, random_fst
    gen = torch.Generator(device=dev).manual_seed(6)
    # cyclic graphs at unequal lengths, a linear graph that accepts only
    # length 3 at length 5, and a length 0
    mixed, _ = list_batch([random_fst(num_states=6 + b, num_pdfs=10,
                                      max_arcs_per_state=4, seed=b)
                           for b in range(3)]
                          + [linear_fst([1, 2, 3]),
                             random_fst(num_states=5, num_pdfs=10, seed=9)],
                          dev)
    # about a fifth of x lies beyond the clamp
    x = 24.0 * torch.randn(5, 16, 10, generator=gen, device=dev)
    out = [vit_compare(mixed.semiring(), x, torch.tensor([16, 11, 7, 5, 0]),
                       "viterbi small cyclic",
                       [True, True, True, False, False])]
    topo = ChainTopology(num_phones=5)
    shared = ChainGraphBatch(ChainGraph(make_numerator_fst([0, 3, 1, 4],
                                                           topo),
                                        log_domain=True), 4, device=dev)
    x = torch.randn(4, 16, 10, generator=gen, device=dev)
    out.append(vit_compare(shared.semiring(), x, torch.tensor([16, 11, 7, 4]),
                           "viterbi small shared", [True] * 4))
    # ties: weightless flat-start arcs under +-8 oracle emissions with
    # extra +8 frames, and an ergodic weightless graph, every state final,
    # under flat emissions
    rng = np.random.RandomState(6)
    plans = [([1, 3, 0, 2], [3, 4, 2, 5]), ([2, 2, 4], [1, 6, 3]),
             ([4, 0], [7, 2])]
    fsts = [make_numerator_fst(ph, topo) for ph, _ in plans]
    fsts.append(FST.from_arcs(
        4, 0, [(s, d, p + 1, p + 1, 0.0) for s, d, p in
               ((0, 1, 0), (0, 2, 1), (1, 3, 2), (2, 3, 3), (3, 0, 4),
                (1, 1, 5), (2, 2, 5), (3, 3, 6), (0, 3, 7))],
        {s: 0.0 for s in range(4)}))
    xo = np.full((4, 16, 10), -8.0, np.float32)
    lens = []
    for b, (ph, du) in enumerate(plans):
        seq = alignment_to_pdf_sequence(ph, du, topo)
        xo[b, np.arange(len(seq)), seq] = 8.0
        for t in np.nonzero(rng.rand(16) < 0.5)[0]:
            xo[b, t, [f(p) for p in ph
                      for f in (topo.fwd_pdf, topo.self_pdf)]] = 8.0
        lens.append(len(seq))
    xo[3] = 8.0
    ties, _ = list_batch(fsts, dev)
    out.append(vit_compare(ties.semiring(), torch.from_numpy(xo).to(dev),
                           torch.tensor(lens + [16]), "viterbi small ties",
                           [True] * 4))
    return out


def vit_bytes_ops(g, lens, B, T):
    """What the function must move and compute for this run's data: x at
    each graph's pdfs and one backpointer per state of each graph, for
    live frames; each distinct graph's arrays once (src, pdf, logp;
    initial, final, in-arc offsets); lengths, objf, pdfs and states.  A
    backpointer need only name the winner's place in its state's in-arc
    list: ceil(log2(max in-degree)) bits, in whole bytes, at least one
    (the kernel writes int32 arc ids, a choice of its design).
    Operations: two adds and a compare per arc and live frame."""
    real = g.dst < g.num_states
    n_arcs = real.sum(dim=1)
    n_states = torch.where(real, torch.maximum(g.src, g.dst),
                           torch.full_like(g.src, -1)).amax(dim=1) + 1
    n_pdfs = torch.tensor([len(set(g.pdf[r][real[r]].tolist()))
                           for r in range(g.rows)], device=g.device)
    max_in = int((g.in_ptr[:, 1:] - g.in_ptr[:, :-1]).max())
    bp_bytes = max(1, -(-math.ceil(math.log2(max(max_in, 1))) // 8))
    per_b = (lambda v: v.expand(B)) if g.rows == 1 else (lambda v: v)
    L = lens.to(g.device).long()
    nbytes = (4 * int((L * per_b(n_pdfs)).sum())
              + bp_bytes * int((L * per_b(n_states)).sum())
              + 12 * int(n_arcs.sum()) + 12 * int(n_states.sum())
              + 8 * B + 8 * B * T)
    ops = 3 * int((L * per_b(n_arcs)).sum())
    return nbytes, ops, (int(n_arcs.min()), int(n_arcs.max()),
                         int(n_states.min()), int(n_states.max()), max_in,
                         bp_bytes)


def vit_class(name, g, x, lens, reps):
    """One size class: bit-identical check, kernel and plain times,
    bytes and operations."""
    from pychain_tpu_torch.ops import viterbi_kernels as vk
    from pychain_tpu_torch.ops.viterbi import viterbi_plain
    B, T, P = x.shape
    bad, err = vit_compare(g, x, lens, f"viterbi class {name}")
    lens32 = lens.int().to(x.device)
    ms = cuda_ms(lambda: vk.viterbi_sweep(x, lens32, g), reps)
    plain_ms = cuda_ms(lambda: viterbi_plain(x, lens32, g), 1)
    nbytes, ops, (k0, k1, s0, s1, max_in, bp_bytes) = vit_bytes_ops(
        g, lens, B, T)
    print(f"# viterbi class {name}: B={B} T={T} P={P} rows={g.rows} "
          f"K_pad={g.k_pad} S_pad={g.num_states} arcs {k0}..{k1} states "
          f"{s0}..{s1} max in-degree {max_in} (backpointer {bp_bytes} B in "
          f"the bound) lengths {int(lens.min())}..{int(lens.max())}; "
          f"viterbi {ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
    return ms, plain_ms, nbytes, ops, err, bad


def constrained_fsts(res, x_lengths, flat_phones, num_phones):
    """Tolerance-3 constrained numerators (make_constrained_numerator)
    from the best paths ``res`` of viterbi_align, and the phone
    durations read from them."""
    from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                                  durations_from_alignment,
                                                  make_constrained_numerator)
    ok = res.ok.cpu().numpy()
    states = res.states.cpu().numpy()
    lens = torch.as_tensor(x_lengths).cpu().numpy()
    check(bool(ok.all()), f"realign: {int((~ok).sum())} sequences have no "
          "alignment")
    topo = ChainTopology(num_phones=num_phones)
    fsts, durs_all = [], []
    for b, phones in enumerate(flat_phones):
        durs = durations_from_alignment(states[b], int(lens[b]))
        check(len(durs) == len(phones) and sum(durs) == lens[b],
              f"realign: sequence {b} durations {durs}")
        durs_all.append(durs)
        fsts.append(make_constrained_numerator(phones, durs, topo,
                                               tolerance=3))
    return fsts, durs_all


def realign(loss_mod, x, x_lengths, flat_batch, flat_phones, num_phones,
            counters, vit_counter):
    """Main path 3 (examples/train_corpus.py:552-586): align main path
    2's batch with its x, build tolerance-3 constrained numerators from
    the best paths, then three ChainLoss SGD steps on them.  Every count
    is set to 0 before the alignment and read after the last step."""
    from pychain_tpu_torch import viterbi_align
    for c in (*counters, vit_counter):
        for k in c:
            c[k] = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = viterbi_align(x.detach(), x_lengths, flat_batch)
    end.record()
    torch.cuda.synchronize()
    align_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    fsts, durs_all = constrained_fsts(res, x_lengths, flat_phones,
                                      num_phones)
    batch, batch_ms = list_batch(fsts, x.device)
    host_ms = (time.perf_counter() - t0) * 1e3
    g = batch.semiring()
    print(f"# main path 3 (realignment): viterbi_align {align_ms:.3f} ms "
          f"(CUDA events); durations + constrained numerators + "
          f"ChainGraphBatch {host_ms:.1f} ms on the host (of it the "
          f"batch {batch_ms:.1f} ms); K_pad={g.k_pad} S_pad="
          f"{g.num_states}; phone durations "
          f"{min(min(d) for d in durs_all)}..{max(max(d) for d in durs_all)}"
          " frames", flush=True)
    losses, step_ms, launches = train_steps(
        loss_mod, x, x_lengths, batch, counters,
        {"fact_fwd": 1, "fact_bwd": 1, "semiring_fwd": 1,
         "semiring_bwd": 1}, "main path 3 (constrained numerators)",
        reset=False)
    launches = {**launches, **vit_counter}
    print(f"# main path 3 launches: {launches}", flush=True)
    check(vit_counter["viterbi"] == 1, f"realign: viterbi launched "
          f"{vit_counter['viterbi']} times, want 1")
    profiled_step(loss_mod, x, x_lengths, batch, "constrained numerators")
    return step_ms, launches, align_ms, host_ms, batch


def decoding(dev, B, T, vit_counter):
    """The decoding path: PhoneDecoder over a bigram phone LM at B=128,
    T=500, once on random x and once on oracle emissions.  Returns the
    decoder's batch arrays, the random x and lengths (the "decode"
    class) and the launches."""
    from pychain_tpu_torch import viterbi_align
    from pychain_tpu_torch.decode import PhoneDecoder, phone_error_rate
    from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                                  alignment_to_pdf_sequence,
                                                  estimate_phone_lm)
    n_ph = 48
    rng = np.random.RandomState(7)
    t0 = time.perf_counter()
    texts = [[int(p) for p in rng.randint(0, n_ph, size=rng.randint(20, 61))]
             for _ in range(2000)]
    topo = ChainTopology(num_phones=n_ph)
    dec = PhoneDecoder(estimate_phone_lm(texts, num_phones=n_ph, order=2),
                       topo)
    build_s = time.perf_counter() - t0
    lens = torch.from_numpy(rng.randint(T // 2, T + 1, size=B))
    x_rand = torch.randn(B, T, topo.num_pdfs, generator=torch.Generator(
        device=dev).manual_seed(8), device=dev)
    refs, durs = texts[:B], []
    xo = np.full((B, T, topo.num_pdfs), -8.0, np.float32)
    for b, ph in enumerate(refs):
        n, L = len(ph), int(lens[b])
        du = 1 + rng.multinomial(L - n, [1.0 / n] * n)
        durs.append([int(d) for d in du])
        seq = alignment_to_pdf_sequence(ph, du, topo)
        xo[b, np.arange(L), seq] = 8.0
    x_or = torch.from_numpy(xo).to(dev)
    for k in vit_counter:
        vit_counter[k] = 0
    times = []
    for xx in (x_rand, x_or):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = dec(xx, lens)
        times.append((time.perf_counter() - t0) * 1e3)
        check(bool(np.isfinite(res.scores).all()), "decode: non-finite "
              "scores")
    launches = dict(vit_counter)
    batch = dec._batches[(B, x_rand.device)]
    align_ms = cuda_ms(lambda: viterbi_align(x_rand, lens, batch), 1)
    per = phone_error_rate(refs, res.phones)
    print(f"# decoding: graph S={dec.graph.num_states} "
          f"K={dec.graph.num_transitions} P={topo.num_pdfs} built in "
          f"{build_s:.2f} s; B={B} T={T} lengths {int(lens.min())}.."
          f"{int(lens.max())}; call (viterbi_align + host pdf->phone "
          f"reading) random x {times[0]:.1f} ms, oracle x {times[1]:.1f} "
          f"ms; viterbi_align alone {align_ms:.3f} ms (CUDA events); "
          f"oracle PER {per}; launches {launches}", flush=True)
    check(per == 0.0, f"decode: oracle PER {per}")
    check(res.durations == durs, "decode: oracle durations differ")
    check(launches == {"viterbi": 2}, f"decode: launches {launches}, want "
          "one per call")
    return batch.semiring(), x_rand, lens, launches


# ----------------------------------------------------------------------
# The XL roofline probe (T1/T2)
# ----------------------------------------------------------------------

XL_TOL = {"vpu": 1e-5, "mxu_f32": 1e-5, "mxu_bf16": 5e-3}
XL_REPLACES = {"vpu": ("tools/xl_roofline.py:72", "make_vpu kernel :50"),
               "mxu_f32": ("tools/xl_roofline.py:126",
                           "make_mxu kernel :94, f32 masks, HIGHEST"),
               "mxu_bf16": ("tools/xl_roofline.py:126",
                            "make_mxu kernel :94, bf16 masks, DEFAULT")}


def xl_probe(dev):
    """The probe's kernels against their plain versions, small shapes and
    the tool's default size; then the tool's own path with the launches
    counted.  Returns {form: row fields}."""
    from pychain_tpu_torch.tools import xl_roofline as xr
    for S, K, T, B in ((64, 192, 16, 2), (100, 250, 12, 3), (37, 45, 5, 2),
                       (1000, 3200, 8, 2)):
        rng = np.random.RandomState(S)
        src = rng.randint(0, S, (B, K)).astype(np.int32)
        dst = rng.randint(0, S, (B, K)).astype(np.int32)
        dst[dst == 0] = 1                        # state 0: no in-arc
        w = rng.rand(K).astype(np.float32) + 0.1
        args = [torch.from_numpy(a).to(dev) for a in (src, dst, w)]
        errs = {}
        for form, run in xr.RUNNERS.items():
            xr.reset_launch_counts()
            got = run(*args, S, T)
            check(xr.LAUNCHES[xr.KERNELS[form]] == 1
                  and sum(xr.LAUNCHES.values()) == 1,
                  f"xl {form} S={S}: launches {xr.LAUNCHES}, want one of "
                  f"{xr.KERNELS[form]}")
            errs[form] = xr.rel_diff(got, xr.plain(form, *args, S, T))
            check(errs[form] <= XL_TOL[form] and bool((got[:, 0] == 0).all())
                  and got.shape == (B, S),
                  f"xl {form} S={S} K={K} T={T} B={B}: rel err "
                  f"{errs[form]:.3e} (limit {XL_TOL[form]:.0e}), carry of "
                  f"the state without in-arcs {got[:, 0].tolist()}")
            if form == "vpu":
                check(torch.equal(run(*args, S, T), got),
                      f"xl_vpu S={S} K={K}: a rerun differs")
        print(f"# xl small S={S} K={K} T={T} B={B}: rel err "
              + ", ".join(f"{f} {e:.2e}" for f, e in errs.items())
              + "; xl_vpu bit-identical on a rerun", flush=True)

    S, K, T, B = 1000, 3200, 512, 8              # tools/xl_roofline.py:149-152
    src, dst, w = xr.inputs(S, K, B, dev)
    rows, kernel_out = {}, {}
    for form, run in xr.RUNNERS.items():
        got = run(src, dst, w, S, T)
        ref = xr.plain(form, src, dst, w, S, T)
        torch.cuda.synchronize()
        err, abs_err = xr.rel_diff(got, ref), absmax(got, ref)
        check(bool(torch.isfinite(got).all()) and err <= XL_TOL[form],
              f"xl {form} at S={S} K={K} T={T} B={B}: rel err {err:.3e} "
              f"(limit {XL_TOL[form]:.0e})")
        kernel_out[form] = got
        plain_ms = cuda_ms(lambda: xr.plain(form, src, dst, w, S, T), 1)
        # the kernel alone, on its prepared arrays (the runner's call adds
        # the input checks' host sync and the CSR sort or the padding)
        if form == "vpu":
            prep = xr.vpu_csr(src, dst, w, S)
            kernel_ms = cuda_ms(lambda: xr.vpu_kernel(*prep, S, T), 10)
        else:
            prep = xr.mxu_operands(src, dst, w)
            kernel_ms = cuda_ms(
                lambda: xr.mxu_kernel(xr.KERNELS[form], *prep, S, T), 3)
        drift = xr.rel_diff(got, kernel_out["vpu"])
        split = xr.SPLIT.get(xr.KERNELS[form], 0)
        s_pad, k_pad = -(-S // 16) * 16, -(-K // 16) * 16
        rows[form] = {"rel_err": err, "max_abs_err": abs_err,
                      "ms": kernel_ms, "plain_ms": plain_ms,
                      "drift_vs_vpu": drift,
                      # the function's own work: K gathers and 2K flops a
                      # frame and row; ids, weights in and the carry out
                      "bytes": B * K * 8 + K * 4 + B * S * 4,
                      "ops": 2 * K * B * T,
                      # what the dense tensor-core form does
                      "tc_dense_ops": 4 * s_pad * k_pad * B * T * split}
        print(f"# xl {form} at S={S} K={K} T={T} B={B}: rel err {err:.3e}, "
              f"max abs {abs_err:.3e} against the plain version; kernel "
              f"{kernel_ms:.3f} ms, plain {plain_ms:.1f} ms; carry drift "
              f"against vpu {drift:.3e}",
              flush=True)
        if split:
            dense = rows[form]["tc_dense_ops"]
            print(f"# xl {form}: dense tensor-core form {dense:.4e} ops, "
                  f"{dense / PEAK_BF16_TC_FLOPS * 1e3:.4f} ms at "
                  f"{PEAK_BF16_TC_FLOPS / 1e12:.0f} TFLOP/s (a count over a "
                  f"peak, not a timing)", flush=True)

    # xl_vpu at B=128 rows, the batch of semiring_fwd's xl class
    src128, dst128, w128 = xr.inputs(S, K, 128, dev)
    prep = xr.vpu_csr(src128, dst128, w128, S)
    xr.vpu_kernel(*prep, S, T)
    ms128 = cuda_ms(lambda: xr.vpu_kernel(*prep, S, T), 10)
    rows["vpu"]["b128_ms"] = ms128
    print(f"# xl_vpu at B=128 (S={S} K={K} T={T}): {ms128:.3f} ms, "
          f"{ms128 * 1e3 / (128 * T):.5f} us/frame/seq", flush=True)
    del src128, dst128, w128, prep

    # the probe's path: the tool's main(), launches counted
    xr.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = xr.main(["--iters", "5"])
    launches = dict(xr.LAUNCHES)
    print(f"# xl_roofline: {buf.getvalue().strip()}")
    print(f"# xl_roofline launches: {launches}", flush=True)
    for form in xr.FORMS:
        check(launches[xr.KERNELS[form]] >= 1,
              f"the probe ran {form} without launching "
              f"{xr.KERNELS[form]}")
        res = out["results"][form]
        rows[form].update(launches=launches[xr.KERNELS[form]],
                          call_ms=res["ms_per_call"],
                          us_per_frame=res["us_per_frame"],
                          compile_s=res["compile_s"])
    return rows


def bound(nbytes, ops, peak_flops=PEAK_F32_FLOPS):
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak_flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch, ChainLoss
    from pychain_tpu_torch.csrc import build
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import (denominator_fst,
                                                    linear_fst)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)

    # -- phase 2: build (all sources at once) ----------------------------
    t0 = time.perf_counter()
    secs = build.build()
    print(f"# build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"#   {name}: {line.strip()}")
    check_smem()
    card_tests()
    leaky_c = 1e-5

    # -- phase 3: kernels vs plain, small graphs -------------------------
    errs_small = []
    for mode, want in MODES:
        fst, P = denominator_fst(num_phones=12, states_per_phone=2, seed=3,
                                 forward_pdf_mode=mode)
        batch = ChainGraphBatch(ChainGraph(fst), 4, device=dev)
        check(batch._fact.xsrc_mode == want,
              f"{mode}: xsrc_mode {batch._fact.xsrc_mode} != {want}")
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(4, 16, P, generator=g, device=dev)
        lens = torch.tensor([16, 11, 7, 1], device=dev)
        for debug in (True, False):
            errs_small.append(compare(batch._fact, torch.exp(x), lens,
                                      leaky_c, debug, f"small {mode}"))

    # -- phase 3: headline graph -----------------------------------------
    B, T = 128, 500
    t0 = time.perf_counter()
    den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    den = ChainGraph(den_fst)
    den_batch = ChainGraphBatch(den, B, device=dev)
    fa = den_batch._fact
    kg = fk.graph_for(fa)
    print(f"# headline graph: S={den.num_states} K={den.num_transitions} "
          f"P={P} s_pad={fa.s_pad} p_pad={fa.p_pad} "
          f"xsrc_mode={fa.xsrc_mode} nnz(W1+W2)={kg.nnz} "
          f"smem={fk.smem_bytes(fa)} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    head_wf, head_stages = resident_layout(fa, kg, "headline graph")
    for name in ("w1", "w1t"):
        n, _, banked = head_wf[name]
        check(banked <= 1.6 * n, f"headline {name}: {banked / n:.3f} gather "
              "wavefronts a slot-warp in bank order (at most 1.6)")
    check(head_stages == 2, f"headline: fact_bwd ring {head_stages} != 2")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, T, P, generator=g, device=dev)
    px = torch.exp(x)
    lens = torch.full((B,), T, device=dev)
    head = compare(fa, px, lens, leaky_c, False, "headline")
    head_ad, _ = alpha_err(fa, px, lens, leaky_c, "headline")
    resident_rerun(fa, px, lens, leaky_c, "headline")

    # times: each kernel alone, and the plain version of each sweep; the
    # cluster kernels at their plans, at C=2, G=1 and at every plan, for
    # comparison
    fwd_ms, bwd_ms, plain_fwd_ms, plain_bwd_ms = pair_times(
        fa, px, lens, leaky_c, fk.fact_fwd, fk.fact_bwd, 5)
    head_plans = stream_plans(fa, B, "headline graph")
    head_st = pair_times(fa, px, lens, leaky_c, stk.stream_fwd,
                         stk.stream_bwd, 5, plain=False)
    head_c2 = pair_times(fa, px, lens, leaky_c, *cluster_pair(2, 1), 5,
                         plain=False)
    plan_times(fa, px, lens, leaky_c, "headline graph")
    print(f"# headline graph on the cluster kernels: stream_fwd "
          f"{head_st[0]:.3f} ms, stream_bwd {head_st[1]:.3f} ms at their "
          f"plans (C={head_plans['stream_fwd']['cluster']} "
          f"G={head_plans['stream_fwd']['columns']} / "
          f"C={head_plans['stream_bwd']['cluster']} "
          f"G={head_plans['stream_bwd']['columns']}); at C=2 G=1 "
          f"{head_c2[0]:.3f} / {head_c2[1]:.3f} ms; fact_fwd {fwd_ms:.3f} "
          f"ms, fact_bwd {bwd_ms:.3f} ms", flush=True)
    print(f"# headline times: fact_fwd {fwd_ms:.3f} ms, fact_bwd "
          f"{bwd_ms:.3f} ms; plain fwd {plain_fwd_ms:.1f} ms, plain bwd "
          f"{plain_bwd_ms:.1f} ms", flush=True)

    # -- phase 4: semiring kernels vs plain, small batches ---------------
    from pychain_tpu_torch.ops import semiring_kernels as sk
    from pychain_tpu_torch.utils.testgraphs import random_fst, sausage_fst
    errs_sr_small = []
    small = torch.Generator(device=dev).manual_seed(3)
    lens4 = torch.tensor([16, 11, 7, 1], device=dev)
    cyclic, _ = list_batch([random_fst(num_states=6 + b, num_pdfs=10,
                                       seed=b) for b in range(4)], dev)
    x10 = torch.randn(4, 16, 10, generator=small, device=dev)
    errs_sr_small.append(sr_compare(cyclic.semiring(), x10, lens4,
                                    "small cyclic", [True] * 4))
    rng = np.random.RandomState(3)
    saus_lens = [12, 9, 5, 2]
    sausage, _ = list_batch(
        [sausage_fst([list(rng.randint(0, 10, size=rng.randint(1, 4)))
                      for _ in range(n)], seed=b)
         for b, n in enumerate(saus_lens)], dev)
    x12 = torch.randn(4, 12, 10, generator=small, device=dev)
    errs_sr_small.append(sr_compare(
        sausage.semiring(), x12, torch.tensor(saus_lens, device=dev),
        "small sausage", [True] * 4))
    # 12 phones cannot fit in 10 frames: the last sequence is infeasible
    flat = [flat_start_fsts(1, 20, n, n, seed=n)[0] for n in (5, 8, 3, 12)]
    flat_small, _ = list_batch(flat, dev)
    x40 = torch.randn(4, 20, 40, generator=small, device=dev)
    flat_lens = torch.tensor([20, 15, 9, 10], device=dev)
    errs_sr_small.append(sr_compare(flat_small.semiring(), x40, flat_lens,
                                    "small flat-start",
                                    [True, True, True, False]))
    for label, batch, x_, l_ in (("small cyclic", cyclic, x10, lens4),
                                 ("small flat-start", flat_small, x40,
                                  flat_lens)):
        bit_identical_gamma(batch.semiring(), x_, l_, label)

    # -- phase 4: the three size classes ---------------------------------
    # "semiring": the flat-start batch of main path 2 (within the JAX
    # dense budget and the Pallas one-hot rule: B5/B6 on a TPU)
    t0 = time.perf_counter()
    flat_fsts = flat_start_fsts(B, 1500, 100, 150, seed=0)
    fsts_s = time.perf_counter() - t0
    flat_batch, flat_host_ms = list_batch(flat_fsts, dev, pad=(300, 151))
    print(f"# flat-start batch: B={B} phones "
          f"{min(f.num_states for f in flat_fsts) - 1}.."
          f"{max(f.num_states for f in flat_fsts) - 1}, K_pad=300, "
          f"S_pad=151; FSTs built in {fsts_s:.2f} s; ChainGraphBatch "
          f"(arc-id lists) {flat_host_ms:.1f} ms on the host",
          flush=True)
    gx = torch.Generator(device=dev).manual_seed(4)
    classes = {}
    x_flat = torch.randn(B, T, P, generator=gx, device=dev)
    classes["semiring"] = sr_class("semiring", flat_batch, x_flat, lens, 5)
    del x_flat
    # "xl": bench.py --xl (beyond the dense budget, masks resident: B7/B8)
    t0 = time.perf_counter()
    xl_batch, xl_host_ms = list_batch(
        [random_fst(num_states=1000, num_pdfs=3000, max_arcs_per_state=5,
                    seed=s) for s in range(B)], dev)
    print(f"# xl batch built in {time.perf_counter() - t0:.1f} s; "
          f"ChainGraphBatch (arc-id lists) {xl_host_ms:.1f} ms on the "
          "host", flush=True)
    x_xl = torch.randn(B, T, 3000, generator=gx, device=dev)
    classes["xl"] = sr_class("xl", xl_batch, x_xl, lens, 3)
    del x_xl, xl_batch
    # "xlstream": tools/xl_stream_indomain.py (beyond the resident budget:
    # masks re-expanded per arc chunk, B9/B10)
    Bs, Ts = 32, 150
    t0 = time.perf_counter()
    xs_batch, xs_host_ms = list_batch(
        [random_fst(num_states=3500, num_pdfs=512, max_arcs_per_state=3,
                    seed=s) for s in range(Bs)], dev)
    print(f"# xlstream batch built in {time.perf_counter() - t0:.1f} s; "
          f"ChainGraphBatch (arc-id lists) {xs_host_ms:.1f} ms on the "
          "host", flush=True)
    x_xs = torch.randn(Bs, Ts, 512, generator=gx, device=dev)
    classes["xlstream"] = sr_class("xlstream", xs_batch, x_xs,
                                   torch.full((Bs,), Ts, device=dev), 3)
    del x_xs, xs_batch

    # -- phase 5: main path 1, linear numerators -------------------------
    rng = np.random.RandomState(0)
    nums = [ChainGraph(linear_fst(rng.randint(0, P, size=T)),
                       log_domain=True) for _ in range(B)]
    num_batch = ChainGraphBatch(nums, max_num_transitions=T,
                                max_num_states=T + 1, device=dev)
    loss_mod = ChainLoss(den)
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(2), device=dev).requires_grad_(True)
    x_lengths = torch.full((B,), T, dtype=torch.int32)
    _, step_ms, launches = train_steps(
        loss_mod, x, x_lengths, num_batch, (fk.LAUNCHES, sk.LAUNCHES),
        {"fact_fwd": 1, "fact_bwd": 1, "semiring_fwd": 0,
         "semiring_bwd": 0}, "main path 1 (linear numerators)")
    profiled_step(loss_mod, x, x_lengths, num_batch, "linear numerators")

    # -- phase 6: main path 2, flat-start numerators ---------------------
    x = torch.randn(B, T, P, generator=torch.Generator(device=dev)
                    .manual_seed(5), device=dev).requires_grad_(True)
    _, flat_step_ms, flat_launches = train_steps(
        loss_mod, x, x_lengths, flat_batch, (fk.LAUNCHES, sk.LAUNCHES),
        {"fact_fwd": 1, "fact_bwd": 1, "semiring_fwd": 1,
         "semiring_bwd": 1}, "main path 2 (flat-start numerators)")
    profiled_step(loss_mod, x, x_lengths, flat_batch,
                  "flat-start numerators")

    # -- phase 7: the Viterbi kernel vs plain, small batches --------------
    from pychain_tpu_torch.ops import viterbi_kernels as vk
    vit_small_out = vit_small(dev)

    # -- phase 8: main path 3, realignment -------------------------------
    x_flat = x.detach().clone()      # main path 2's x, for the class below
    re_step_ms, re_launches, align_ms, _, re_batch = realign(
        loss_mod, x, x_lengths, flat_batch,
        flat_start_phones(B, 1500, 100, 150, seed=0), 1500,
        (fk.LAUNCHES, sk.LAUNCHES), vk.LAUNCHES)
    del x
    # the semiring pair at main path 3's constrained batch (the "xl" class
    # by the JAX package's rule), under the x it was aligned on
    classes["path3"] = sr_class("xl", re_batch, x_flat, lens, 5,
                                label="main path 3's batch")
    del re_batch

    # -- phase 9: the Viterbi size classes -------------------------------
    vit_classes = {"realign": vit_class("realign", flat_batch.semiring(),
                                        x_flat, lens, 5)}
    del x_flat
    t0 = time.perf_counter()
    b11_batch, _ = list_batch(
        [random_fst(num_states=512, num_pdfs=512, max_arcs_per_state=4,
                    seed=s) for s in range(B)], dev)
    print(f"# b11 batch built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    x_b11 = torch.randn(B, T, 512, generator=torch.Generator(
        device=dev).manual_seed(9), device=dev)
    vit_classes["b11"] = vit_class("b11", b11_batch.semiring(), x_b11, lens,
                                   5)
    del x_b11, b11_batch

    # -- phase 10: decoding ----------------------------------------------
    dec_g, x_dec, dec_lens, dec_launches = decoding(dev, B, T, vk.LAUNCHES)
    vit_classes["decode"] = vit_class("decode", dec_g, x_dec, dec_lens, 5)
    del x_dec, dec_g
    fwd_bytes, fwd_ops, bwd_bytes, bwd_ops = fact_bytes_ops(fa, kg, lens, T,
                                                            P)
    del den_batch, fa, kg, px, x_lengths, flat_batch, num_batch, loss_mod
    torch.cuda.empty_cache()

    # -- phase 11: the cluster kernels, small graphs and the s8k class ---
    errs_stream_small = stream_small(dev, leaky_c)
    s8k = s8k_class(dev, leaky_c)
    stream_classes = {"s8k": s8k[:5]}
    s8k_b12_errs, s8k_fact_ms = s8k[5:]
    errs_ringless = ringless_class(dev, leaky_c)
    torch.cuda.empty_cache()

    # -- phase 12: main path 4, the 12k-state Kaldi-topology denominator -
    m4 = main_path_4(dev, leaky_c, (fk.LAUNCHES, sk.LAUNCHES, stk.LAUNCHES))
    stream_classes["main4"] = m4[:5]
    m4_step_ms, m4_launches = m4[5:]
    torch.cuda.empty_cache()

    # -- phase 13: the XL roofline probe ----------------------------------
    from pychain_tpu_torch.tools import xl_roofline as xr
    xl_rows = xl_probe(dev)

    # -- phase 13: the kernels line --------------------------------------
    rows = []
    for name, ms, plain_ms, nbytes, ops, err, fn in (
            ("fact_fwd", fwd_ms, plain_fwd_ms, fwd_bytes, fwd_ops,
             max(head_ad, head["objf_rel"]), "_fwd_kernel_factory", ),
            ("fact_bwd", bwd_ms, plain_bwd_ms, bwd_bytes, bwd_ops,
             max(head["gamma_abs"], head["alpha_beta_abs"],
                 head["gamma_sum_abs"]), "_bwd_kernel_factory")):
        bms, by = bound(nbytes, ops)
        line = {"fact_fwd": 457, "fact_bwd": 768}[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"pychain_tpu_torch/csrc/{name}.cu",
            "replaces": f"pychain_tpu/ops/pallas_fact.py:{line}",
            "replaces_fn": f"pychain_tpu/ops/pallas_fact.py::{fn}",
            "launches": launches[name], "max_abs_err": err, "max_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "bytes": nbytes, "ops": ops,
            "ring_stages": head_stages if name == "fact_bwd" else 0,
            "s8k_ms": s8k_fact_ms[0 if name == "fact_fwd" else 1],
            "library_ms": None})
    # main path 2 runs the "semiring" class (the flat-start batch), main
    # path 3 its constrained batch ("xl" by the JAX package's rule); the
    # other rows are kernel checks at bench.py's and the tool's sizes
    sr_launches = {"semiring": flat_launches, "path3": re_launches}
    for batch_name, res in classes.items():
        cls = res["class"]
        for i, side in enumerate(("fwd", "bwd")):
            ms, plain_ms, nbytes, ops, err = res[side]
            name = f"semiring_{side}"
            lay = res["layouts"][name]
            bms, by = bound(nbytes, ops, PEAK_F64_FLOPS)
            rows.append({
                "name": name, "route": "cuda", "size_class": cls,
                "batch": {"path3": "main path 3"}.get(batch_name,
                                                      batch_name),
                "source": f"pychain_tpu_torch/csrc/{name}.cu",
                "replaces": SR_CLASSES[cls][i],
                "launches": sr_launches.get(batch_name, {}).get(name, 0),
                "on_main_path": batch_name in sr_launches,
                "threads": lay.threads, "stages": lay.stages,
                "resident": lay.resident,
                **({"pipe": lay.pipe, "grows": lay.grows}
                   if side == "bwd" else {}),
                "max_abs_err": err, "max_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "bytes": nbytes, "ops": ops, "library_ms": None})
    for cls, (errs, (a_err, a_excess), times, (fb, fo, bb, bo), plans) in \
            stream_classes.items():
        for i, name in enumerate(("stream_fwd", "stream_bwd")):
            nbytes, ops = ((fb, fo), (bb, bo))[i]
            err = (max(a_err, errs["objf_rel"]) if i == 0 else
                   max(errs["gamma_abs"], errs["alpha_beta_abs"],
                       errs["gamma_sum_abs"]))
            # alpha' (fwd) or gamma (bwd), entry by entry
            entry_excess = a_excess if i == 0 else errs["gamma_excess"]
            bms, by = bound(nbytes, ops)
            line, fn = ((463, "_fwd_kernel_factory"),
                        (668, "_bwd_kernel_factory"))[i]
            rows.append({
                "name": name, "route": "cuda", "size_class": cls,
                "cluster": plans[name]["cluster"],
                "columns": plans[name]["columns"],
                "active_clusters": plans[name]["active_clusters"],
                "source": f"pychain_tpu_torch/csrc/{name}.cu",
                "replaces": f"pychain_tpu/ops/pallas_stream.py:{line}",
                "replaces_fn": f"pychain_tpu/ops/pallas_stream.py::{fn}",
                # main path 4 runs the "main4" class
                "launches": m4_launches[name] if cls == "main4" else 0,
                "on_main_path": cls == "main4",
                "max_abs_err": err, "max_err": err,
                "entry_excess": entry_excess, "ms": times[i],
                "plain_ms": times[2 + i], "bound_ms": bms, "bound_by": by,
                "bytes": nbytes, "ops": ops, "library_ms": None})
    vit_launches = {"realign": re_launches["viterbi"],
                    "decode": dec_launches["viterbi"], "b11": 0}
    for cls, (ms, plain_ms, nbytes, ops, err, bad) in vit_classes.items():
        bms, by = bound(nbytes, ops)
        rows.append({
            "name": "viterbi", "route": "cuda", "size_class": cls,
            "source": "pychain_tpu_torch/csrc/viterbi.cu",
            "replaces": "pychain_tpu/ops/viterbi.py:175",
            "replaces_fn": "pychain_tpu/ops/viterbi.py::_vit_kernel",
            # main path 3 runs the "realign" class, decoding "decode"
            "launches": vit_launches[cls],
            "on_main_path": cls != "b11",
            "max_abs_err": err, "max_err": err, "mismatches": bad,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "ops": ops, "library_ms": None})
    for form, r in xl_rows.items():
        bms, by = bound(r["bytes"], r["ops"])
        rows.append({
            "name": xr.KERNELS[form], "route": "cuda",
            "source": "pychain_tpu_torch/csrc/xl_roofline.cu",
            "replaces": XL_REPLACES[form][0],
            "replaces_fn": XL_REPLACES[form][1],
            # the probe's path (its own main()); no main path runs it
            "launches": r["launches"], "on_main_path": False,
            "max_abs_err": r["max_abs_err"], "max_err": r["rel_err"],
            "rel_err": r["rel_err"], "drift_vs_vpu": r["drift_vs_vpu"],
            "ms": r["ms"], "call_ms": r["call_ms"],
            "b128_ms": r.get("b128_ms"),
            "us_per_frame": r["us_per_frame"],
            "plain_ms": r["plain_ms"], "bound_ms": bms, "bound_by": by,
            "bytes": r["bytes"], "ops": r["ops"],
            "tc_dense_ops": r["tc_dense_ops"] or None,
            "library_ms": None})
    print(f"# small-graph worst errors (denominator): {worst(errs_small)}")
    print(f"# small-batch worst errors (semiring): {worst(errs_sr_small)}")
    print(f"# small-graph worst errors (cluster kernels): "
          f"{worst(errs_stream_small)}")
    print(f"# B1/B2 worst errors at ring depth 1 (s8k): {s8k_b12_errs}; "
          f"at depth 0 (S_pad 12,032): {errs_ringless}")
    print(f"# small-batch Viterbi mismatches: "
          f"{sum(b for b, _ in vit_small_out)}")
    print(f"# step ms (timed step, after warm-up): linear numerators "
          f"{step_ms[-1]:.3f}, flat-start numerators {flat_step_ms[-1]:.3f}"
          f", constrained numerators {re_step_ms[-1]:.3f}, main path 4 "
          f"{m4_step_ms[-1]:.3f}; realignment viterbi_align {align_ms:.3f}")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
