#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pychain_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the four kernels from csrc/*.cu with nvcc (sm_90a), all
   sources at once, one nvcc each;
3. the denominator kernels (fact_fwd, fact_bwd) against their plain
   PyTorch version on the card: small graphs in the three x_src modes
   with unequal lengths and debug True/False, then the headline graph
   (bench.py's: denominator_fst(1500, 2, bigram_fanout=30), S=3000,
   K=49.5k, P=3000) at B=128, T=500, with the kernels' and the plain
   version's times;
4. the semiring kernels (semiring_fwd, semiring_bwd) against their plain
   version: small cyclic (random_fst), sausage (sausage_fst) and
   flat-start (make_numerator_fst) batches with unequal lengths and one
   infeasible sequence, the backward run twice for bit-identical gamma;
   then one batch of each size class the JAX package splits over three
   TPU kernel pairs, with the kernels' and the plain version's times:
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
7. one JSON line {"kernels": [...]} with each kernel's launches on the
   main path that runs it, its error against the plain version, its
   time, the plain version's time and the least time the card could take
   (bound_ms); the semiring kernels get one row per size class;
8. the card's name and power limit, then the last line
   {"ok": true, "device": {...}}.

Without a CUDA device it exits non-zero and prints no result.  It
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
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
TOL = 1e-4   # objf relative, gamma and traces absolute (docs/PARITY.md:21)


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


def compare(fa, px, lens, leaky_c, debug, label):
    """Kernel path vs plain path on the same inputs.  Returns the
    observed errors."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops.factorized import forward_backward_prob_fact
    got = fk.forward_backward_prob_kernel(px, lens, fa, leaky_c, debug=debug)
    ref = forward_backward_prob_fact(px, lens, fa, leaky_c)
    torch.cuda.synchronize()
    if not debug:
        ref = fk._frame0_traces(ref)
    errs = {"objf_rel": rel(got.objf, ref.objf),
            "gamma_abs": absmax(got.gamma, ref.gamma),
            "alpha_beta_abs": absmax(got.alpha_beta, ref.alpha_beta),
            "gamma_sum_abs": absmax(got.gamma_sum, ref.gamma_sum)}
    print(f"# {label} debug={debug}: " + " ".join(
        f"{k}={v:.3e}" for k, v in errs.items()), flush=True)
    for k, v in errs.items():
        check(v <= TOL, f"{label} debug={debug}: {k}={v:.3e} > {TOL}")
    check(bool(got.ok.all()), f"{label}: ok flags {got.ok.tolist()}")
    return errs


def alpha_err(fa, px, lens, leaky_c):
    """Forward kernel alone: its alpha' stream and sums against the
    plain forward sweep on frames before each column's end."""
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops.factorized import (forward_prob_fact,
                                                  px_time_major)
    ad_ys, _, _, _, s_ys, _, _, _ = fk.fact_fwd(
        px, lens.int(), fa, leaky_c)
    alpha_dash, alpha_sums, _, _ = forward_prob_fact(
        px_time_major(px, fa), lens.long(), fa, leaky_c)
    B, T, _ = ad_ys.shape
    live = torch.arange(T, device=px.device)[None, :] < lens[:, None]
    ref_ad = alpha_dash[1:].permute(2, 0, 1)               # (B, T, S_pad)
    ref_s = alpha_sums[1:].t()
    err_ad = float(((ad_ys - ref_ad).abs().amax(dim=2) * live).max())
    err_s = float(((s_ys - ref_s).abs() / ref_s.abs() * live).max())
    return max(err_ad, err_s)


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
    warc, c, n0, lz0 = prepare(x, g)
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


def sr_class(name, batch, x, lens, reps):
    """One size class: errors, kernel and plain times, bytes and ops."""
    from pychain_tpu_torch.ops import semiring_kernels as sk
    from pychain_tpu_torch.ops.semiring import backward_plain, forward_plain
    g = batch.semiring()
    B, T, P = x.shape
    check(size_class(B, g.k_pad, g.num_states) == name,
          f"class {name}: B={B} K={g.k_pad} S={g.num_states} is "
          f"{size_class(B, g.k_pad, g.num_states)!r} in the JAX package")
    errs = sr_compare(g, x, lens, f"class {name}", want_ok=[True] * B)
    a_err = sr_alpha_err(g, x, lens)
    print(f"# class {name}: alpha stream / raw sums err {a_err:.3e}")
    check(a_err <= TOL, f"class {name}: alpha stream err {a_err:.3e}")
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
    print(f"# class {name}: B={B} T={T} K_pad={g.k_pad} "
          f"S_pad={g.num_states} P={P} arcs {int(n_arcs.min())}.."
          f"{int(n_arcs.max())} states {int(n_states.min())}.."
          f"{int(n_states.max())}; semiring_fwd "
          f"{fwd_ms:.3f} ms, semiring_bwd {bwd_ms:.3f} ms; plain fwd "
          f"{plain_fwd_ms:.1f} ms, plain bwd {plain_bwd_ms:.1f} ms",
          flush=True)
    return {"fwd": (fwd_ms, plain_fwd_ms, fwd_bytes, fwd_ops,
                    max(errs["objf_rel"], a_err)),
            "bwd": (bwd_ms, plain_bwd_ms, bwd_bytes, bwd_ops,
                    max(errs["gamma_abs"], errs["alpha_beta_abs"],
                        errs["gamma_sum_abs"]))}


def flat_start_fsts(B, num_phones, n_lo, n_hi, seed):
    """B flat-start numerators (make_numerator_fst, lm=None) of N_b
    phones drawn uniformly from n_lo..n_hi, phone ids from
    0..num_phones-1."""
    from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                                  make_numerator_fst)
    rng = np.random.RandomState(seed)
    topo = ChainTopology(num_phones=num_phones)
    return [make_numerator_fst(rng.randint(0, num_phones, size=n), topo)
            for n in rng.randint(n_lo, n_hi + 1, size=B)]


def train_steps(loss_mod, x, x_lengths, nums, counters, want, label):
    """Three SGD steps with every launch count set to 0 just before and
    read just after; returns (losses, step_ms, launches)."""
    lr = 0.1 * float(x_lengths.sum())
    losses, step_ms, per_step = [], [], []
    for c in counters:
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
    from pychain_tpu_torch.ops.factorized import (backward_prob_fact,
                                                  forward_prob_fact,
                                                  px_time_major)
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
    leaky_c = 1e-5

    # -- phase 3: kernels vs plain, small graphs -------------------------
    errs_small = []
    for mode, want in (("source", "identity"), ("cross", "matrix"),
                       ("separate", "stream")):
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
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(B, T, P, generator=g, device=dev)
    px = torch.exp(x)
    lens = torch.full((B,), T, device=dev)
    head = compare(fa, px, lens, leaky_c, False, "headline")
    head_ad = alpha_err(fa, px, lens, leaky_c)
    print(f"# headline alpha'/s stream err: {head_ad:.3e}")
    check(head_ad <= TOL, f"headline alpha' stream err {head_ad:.3e}")

    # times: each kernel alone, and the plain version of each sweep
    lens32 = lens.int()
    fwd_out = fk.fact_fwd(px, lens32, fa, leaky_c)
    ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = fwd_out
    objf, tot = fk._objf(s_ys, ad_last, lens32, fa, s0)

    def run_bwd():
        return fk.fact_bwd(lens32, fa, leaky_c, ad_ys, w1ad, xdst, xsrc,
                           s_ys, ad0, s0, tot.contiguous(), P, debug=False)

    run_bwd()
    fwd_ms = cuda_ms(lambda: fk.fact_fwd(px, lens32, fa, leaky_c), 5)
    bwd_ms = cuda_ms(run_bwd, 5)
    px_tm = px_time_major(px, fa)
    with torch.no_grad():
        plain = forward_prob_fact(px_tm, lens.long(), fa, leaky_c)
        plain_fwd_ms = cuda_ms(
            lambda: forward_prob_fact(px_tm, lens.long(), fa, leaky_c), 2)
        plain_bwd_ms = cuda_ms(
            lambda: backward_prob_fact(px_tm, lens.long(), fa, leaky_c,
                                       plain[0], plain[1], plain[3]), 2)
    del plain, px_tm, fwd_out, ad_ys, w1ad, xdst, xsrc
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

    # -- phase 7: the kernels line ---------------------------------------
    L = int(lens.sum())
    n_streams = 3 if fa.xsrc_mode == "identity" else 4
    s_pad, nnz = fa.s_pad, kg.nnz
    graph_bytes = nnz * 8 + (fa.s_pad + 1) * 8 + 4 * s_pad * 4
    n_pdfs_read = len(set(kg.f_dst.tolist()))
    fwd_bytes = (L * n_pdfs_read * 4 + graph_bytes
                 + n_streams * L * s_pad * 4 + B * T * 4 + B * s_pad * 4)
    fwd_ops = 2 * nnz * L + 7 * s_pad * L
    bwd_bytes = (n_streams * L * s_pad * 4 + B * T * 4 + graph_bytes
                 + (fa.p_pad + 1 + s_pad) * 4 + B * T * P * 4 + 2 * B * T * 4)
    bwd_ops = 2 * nnz * L + 15 * s_pad * L

    rows = []
    for name, ms, plain_ms, nbytes, ops, err, fn in (
            ("fact_fwd", fwd_ms, plain_fwd_ms, fwd_bytes, fwd_ops,
             max(head_ad, head["objf_rel"]), "_fwd_kernel_factory", ),
            ("fact_bwd", bwd_ms, plain_bwd_ms, bwd_bytes, bwd_ops,
             max(head["gamma_abs"], head["alpha_beta_abs"],
                 head["gamma_sum_abs"]), "_bwd_kernel_factory")):
        bms, by = bound(nbytes, ops)
        line = {"fact_fwd": 213, "fact_bwd": 475}[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"pychain_tpu_torch/csrc/{name}.cu",
            "replaces": f"pychain_tpu/ops/pallas_fact.py:{line}",
            "replaces_fn": f"pychain_tpu/ops/pallas_fact.py::{fn}",
            "launches": launches[name], "max_abs_err": err, "max_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "bytes": nbytes, "ops": ops,
            "library_ms": None})
    for cls, res in classes.items():
        for i, side in enumerate(("fwd", "bwd")):
            ms, plain_ms, nbytes, ops, err = res[side]
            name = f"semiring_{side}"
            bms, by = bound(nbytes, ops, PEAK_F64_FLOPS)
            rows.append({
                "name": name, "route": "cuda", "size_class": cls,
                "source": f"pychain_tpu_torch/csrc/{name}.cu",
                "replaces": SR_CLASSES[cls][i],
                # main path 2 runs only the "semiring" class
                "launches": flat_launches[name] if cls == "semiring" else 0,
                "on_main_path": cls == "semiring",
                "max_abs_err": err, "max_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                "bytes": nbytes, "ops": ops, "library_ms": None})
    small_worst = {k: max(e[k] for e in errs_small) for k in errs_small[0]}
    print(f"# small-graph worst errors (denominator): {small_worst}")
    sr_worst = {k: max(e[k] for e in errs_sr_small)
                for k in errs_sr_small[0]}
    print(f"# small-batch worst errors (semiring): {sr_worst}")
    print(f"# step ms (timed step, after warm-up): linear numerators "
          f"{step_ms[-1]:.3f}, flat-start numerators {flat_step_ms[-1]:.3f}")
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
