#!/usr/bin/env python3
"""Time the denominator kernels with one phase removed at a time.

    python3 kernel_ablation.py

A diagnostic for PERF.md, run on a CUDA card: each variant is the
kernel's source with a few statements replaced (the emission gather,
the sparse products, the stream writes or reads, the gamma scatter),
built with the same nvcc flags into pychain_tpu_torch/csrc/build/ablate/
and timed with CUDA events: B1/B2 (fact_*) at the headline size
(bench.py's graph, B=128, T=500), the cluster beta sweep (stream_bwd)
at main path 4's (the 12k-state Kaldi-topology denominator, B=128,
T=500, C=2), where its gamma stage reads each state's mass from the CTA
that owns it, one 4-byte distributed-shared-memory load a state.  A variant computes wrong numbers by design; only its time
means something: how much of the full kernel's time the removed phase
accounts for (phases overlap, so the savings need not add up).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

FWD = {
    "full": [],
    "no_emission_gather": [("__ldg(px_t + f_dst[s])", "1.0f")],
    "no_products": [
        ("sell_row_dot(w1_ptr, w1_col, w1_val, d, ad)", "ad[d]"),
        ("sell_row_dot(w2_ptr, w2_col, w2_val, d, u)", "u[d]")],
    "no_stream_writes": [
        ("xdst_ys[o + s] = x;", ""), ("w1ad_ys[o + d] = w1a;", ""),
        ("ad_ys[o + d] = v;", "")],
    "no_block_sum": [("block_sum<1>(part, red);", "__syncthreads();")],
}
BWD = {
    "full": [],
    "no_products": [
        ("sell_row_dot(w1t_ptr, w1t_col, w1t_val, s, xb)", "xb[s]"),
        ("sell_row_dot(w2t_ptr, w2t_col, w2t_val, s, bn)", "bn[s]")],
    "no_stream_reads": [
        ("xb[s] = xdst_ys[o + s] * v;", "xb[s] = v;"),
        ("(identity ? xdst_ys[o + s] : xsrc_ys[o + s])", "1.0f"),
        ("w1ad_ys[o + s]", "1.0f"), ("ad_u[s]", "1.0f")],
    "no_gamma_scatter": [("if (p < n_pdf_lists) {", "if (false) {")],
    "no_gamma_writes": [("g_row[p] = acc;", "")],
}
STREAM_BWD = {
    "full": [],
    "no_gamma_stage": [("if (p < n_pdf_lists) {", "if (false) {")],
}


def build_variant(name, edits, out_dir):
    from pychain_tpu_torch.csrc import build
    src = (build.CSRC / f"{name}.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"{name}: statement not found: {old!r}")
        src = src.replace(old, new)
    tag = "_".join([name] + [str(abs(hash(e)) % 10**8) for e in edits])
    cu = out_dir / f"{tag}.cu"
    cu.write_text(src)
    so = out_dir / f"lib{tag}.so"
    cmd = [build.nvcc_path(), *build.FLAGS, "-I", str(build.CSRC), "-o",
           str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def main():
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.csrc import build
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst

    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kernel, variants in (("fact_fwd", FWD), ("fact_bwd", BWD),
                             ("stream_bwd", STREAM_BWD)):
        for label, edits in variants.items():
            jobs[(kernel, label)] = build_variant(kernel, edits, out_dir)
    for key, (proc, _) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{key}: nvcc failed:\n{out}")

    dev = torch.device("cuda")
    B, T = 128, 500
    den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    fa = ChainGraphBatch(ChainGraph(den_fst), B, device=dev)._fact
    g = torch.Generator(device=dev).manual_seed(0)
    px = torch.exp(torch.randn(B, T, P, generator=g, device=dev))
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    c = 1e-5

    def use(kernel, label):
        build._loaded[kernel] = ctypes.CDLL(str(jobs[(kernel, label)][1]))

    use("fact_fwd", "full")
    ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = fk.fact_fwd(
        px, lens, fa, c)
    _, tot = fk._objf(s_ys, ad_last, lens, fa, s0)
    tot = tot.contiguous()

    def time_ms(fn, reps=5):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    result = {}
    for label in FWD:
        use("fact_fwd", label)
        result[f"fact_fwd/{label}"] = time_ms(
            lambda: fk.fact_fwd(px, lens, fa, c))
    for label in BWD:
        use("fact_bwd", label)
        result[f"fact_bwd/{label}"] = time_ms(
            lambda: fk.fact_bwd(lens, fa, c, ad_ys, w1ad, xdst, xsrc, s_ys,
                                ad0, s0, tot, P, debug=False))
    del ad_ys, w1ad, xdst, xsrc, px

    # the cluster beta sweep at main path 4
    den_fst, P = denominator_fst(num_phones=6000, states_per_phone=2,
                                 num_pdfs=3000, seed=0, bigram_fanout=30,
                                 forward_pdf_mode="separate")
    fa = ChainGraphBatch(ChainGraph(den_fst), B, device=dev)._fact
    C = stk.cluster_size(fa)
    px = torch.exp(torch.randn(B, T, P, generator=g, device=dev))
    ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = stk.stream_fwd(
        px, lens, fa, c)
    _, tot = fk._objf(s_ys, ad_last, lens, fa, s0)
    tot = tot.contiguous()
    for label in STREAM_BWD:
        use("stream_bwd", label)
        result[f"stream_bwd/{label} C={C}"] = time_ms(
            lambda: stk.stream_bwd(lens, fa, c, ad_ys, w1ad, xdst, xsrc,
                                   s_ys, ad0, s0, tot, P, debug=False))
    for k, v in result.items():
        print(f"# {k:28s} {v:8.3f} ms")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"ablation_ms": result, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
