#!/usr/bin/env python3
"""Time the loss kernels with one phase removed at a time.

    python3 kernel_ablation.py [--only fact_fwd,fact_bwd/full,...]

A diagnostic for PERF.md, run on a CUDA card: each variant is the
kernel's source with a few statements replaced (the emission gathers,
the sparse products, the peer copies, the cluster barriers, the stream
writes or reads, the gamma stage, the transcendentals, the reductions),
built with the same nvcc flags into
pychain_tpu_torch/csrc/build/ablate/ and timed with CUDA events: B1/B2
(fact_*) at the headline size (bench.py's graph, B=128, T=500), the
cluster pair (stream_fwd, stream_bwd) at main path 4's (the 12k-state
Kaldi-topology denominator, B=128, T=500) at the plan it launches with,
the semiring pair (semiring_fwd, semiring_bwd) at main path 2's
flat-start batch and at main path 3's constrained batch.
A variant computes wrong numbers by design; only its time means
something: how much of the full kernel's time the removed phase
accounts for (phases overlap, so the savings need not add up).  Some
variants change what the host gives the kernel instead: B1/B2's
operators in ascending slot order, fact_bwd without its ring, or a
semiring kernel at another layout than its plan's (a step of its design
taken away).  The semiring tables match the source they find (the
first design or the redesign), so the script, copied into an older
tree's ``ab_*/`` copy, ablates that tree's kernels.
``--only`` times the named kernels' variants (``fact_fwd``) or single
variants (``fact_bwd/full``) alone; ``full`` alone times a kernel as it
is, to compare two trees of the repository.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

FWD = {
    "full": [],
    "ascending_order": {"order": "ascending"},
    "no_emission_gather": [("__ldg(px_t + f_dst[s])", "1.0f")],
    "no_products": [
        ("sell_row_dot(w1_ptr, w1_col, w1_val, d, ad)", "ad[d]"),
        ("sell_row_dot(w2_ptr, w2_col, w2_val, d, u)", "u[d]")],
    "no_stream_writes": [
        ("__stcs(xdst_ys + o + s, x);", ""),
        ("if (xsrc_ys) __stcs(xsrc_ys + o + s, xs);", ""),
        ("__stcs(w1ad_ys + o + d, w1a);", ""), ("__stcs(ad_ys + o + d, v);", "")],
    "no_block_sum": [("block_sum<1>(part, red);", "__syncthreads();")],
}
BWD = {
    "full": [],
    "ascending_order": {"order": "ascending"},
    # the stream rows read from device memory where the frame needs them
    "no_ring": {"stages": 0},
    "no_products": [
        ("sell_row_dot(w1t_ptr, w1t_col, w1t_val, s, xb)", "xb[s]"),
        ("sell_row_dot(w2t_ptr, w2t_col, w2t_val, s, bn)", "bn[s]")],
    # the ring's copies and waits (the stages' contents are stale)
    "no_stream_fetch": [
        ("mbar_wait(bar + i % stages, (i / stages) & 1);", ""),
        ("fetch(Tb - 1 - k);", ";"), ("fetch(u - stages);", ";")],
    "no_gamma_scatter": [("if (p < n_pdf_lists) {", "if (false) {")],
    "no_gamma_writes": [("__stcs(g_row + p, acc);", "")],
}
# The cluster pair (a cluster a group of G columns, W1's vector alone
# held whole, one / two cluster barriers a frame).
STREAM_FWD = {
    "full": [],
    "no_emissions": [("x[g] = __ldg(px_t + fd);", "x[g] = 1.0f;"),
                     ("g_src ? __ldg(px_t + gd) : x[g]", "x[g]"),
                     ("__ldg(px + (row0[g] + t) * P + pdf)", "1.0f")],
    "no_products": [
        ("sell_row_dot_cols<G>(w1_ptr, w1_col, w1_val, d, ad, w1a);",
         "load_cols<G>(ad + d * G, w1a);"),
        ("const int end = __ldg(w2_ptr + slice + 1);",
         "const int end = __ldg(w2_ptr + slice);")],
    "no_w2_product": [("const int end = __ldg(w2_ptr + slice + 1);",
                       "const int end = __ldg(w2_ptr + slice);")],
    "no_peer_copies": [(": *cluster.map_shared_rank(src, owner);",
                        ": *src;")],
    "no_cluster_barriers": [
        ("    cluster.sync();\n  }\n  if (rank == 0) {",
         "    __syncthreads();\n  }\n  if (rank == 0) {")],
    "no_stream_writes": [
        ("__stcs(xdst_ys + o, x[g]);", ""),
        ("if (xsrc_ys) __stcs(xsrc_ys + o, xs[g]);", ""),
        ("__stcs(w1ad_ys + o, w1a[g]);", ""),
        ("store_cols_stream<4 / G>(ad_ys + (row0[g] + t - 1) * s_pad + j0,",
         "if (false) store_cols_stream<4 / G>(ad_ys,")],
}
STREAM_BWD = {
    "full": [],
    "no_products": [
        ("sell_row_dot_cols<G>(w1t_ptr, w1t_col, w1t_val, d, xb, w1t);",
         "load_cols<G>(xb + d * G, w1t);"),
        ("const int end = __ldg(w2t_ptr + slice + 1);",
         "const int end = __ldg(w2t_ptr + slice);")],
    "no_w2_product": [("const int end = __ldg(w2t_ptr + slice + 1);",
                       "const int end = __ldg(w2t_ptr + slice);")],
    "no_peer_copies": [("cluster_gather_cols<G>(xb, s_pad, rank, lc);",
                        "")],
    "no_cluster_barriers": [("cluster.sync();   // X1", "__syncthreads();"),
                            ("cluster.sync();   // X2", "__syncthreads();")],
    "no_stream_reads": [
        ("__ldcs(xdst_ys + (row0[g] + u) * s_pad + d)", "1.0f"),
        ("__ldcs((identity ? xdst_ys : xsrc_ys) + o)", "1.0f"),
        ("__ldcs(ad_ys + o - s_pad)", "1.0f"), ("__ldcs(w1ad_ys + o)", "1.0f")],
    "no_gamma_stage": [("if (p < n_pdf_lists) {", "if (false) {")],
}

# The semiring pair (B5/B6) in its first design: one 1024-thread block a
# sequence, lists read from device memory, block_sum's two barriers and
# a normalising pass a frame (B5), a serial walk of the out-arcs with
# three double transcendentals an arc and a gamma stage over all P pdf
# lists (B6).  A tree with that design is ablated with these tables.
SR_FWD_FIRST = {
    "full": [],
    "no_warc_loads": [("static_cast<double>(__ldg(w + k))", "1.0")],
    "no_stream_writes": [("out[d] = v;", "")],
    "no_block_reduce": [("block_sum<1>(part, red);", "__syncthreads();")],
}
SR_BWD_FIRST = {
    "full": [],
    "no_warc_loads": [("static_cast<double>(__ldg(w + k)) * r[", "r[")],
    # log alpha from a constant: no alpha-stream row is read
    "no_alpha_loads": [("log(a_u[s]);", "-1.0;")],
    # occ = v: no log or exp (log alpha, now dead, goes with them)
    "no_transcendentals": [
        ("exp(fmin(la + log(v) + scale, SR_EXP_CLAMP))", "v")],
    "no_gamma_stage": [("if (p < n_p) {", "if (false) {")],
    # the sums still taken, the stores skipped
    "no_gamma_writes": [("g_u[p] = static_cast<float>(acc);",
                         "if (acc < 0.0) g_u[p] = 0.0f;")],
    "no_block_reduce": [("block_sum_max(trace, mx, red);",
                         "__syncthreads();")],
}
# The redesign: blocks sized to the graph, one barrier a
# frame, resident lists, TMA rings and (B6) gamma rows stored by TMA.
# The "layout" variants force another layout of the same source (a
# function of the plan's): the design's steps taken away one at a time.
_up32 = lambda lay: dataclasses.replace(lay, threads=1024)
SR_FWD = {
    "full": [],
    "threads_1024": {"layout": _up32},
    "no_ring": {"layout": lambda lay: dataclasses.replace(lay, stages=0)},
    "no_resident": {"layout": lambda lay: dataclasses.replace(
        lay, resident=False)},
    "lists_and_rows_from_memory": {"layout": lambda lay: dataclasses.replace(
        lay, stages=0, resident=False)},
    "no_warc_loads": [("static_cast<double>(w[pk & 0xffff])", "1.0")],
    "no_stream_writes": [
        ("if (t > 0) __stcs(out_prev + d, a_prev[d] * inv);", "")],
    "no_block_reduce": [
        ("part = warp_sum_all(part);", ""),
        ("warp_sum_all(lane < nwarps ? red[cur * 32 + lane] : 0.0);",
         "part;")],
    # the ring's waits and refills (the stages' contents are stale)
    "no_refill": [("mbar_wait(bar + t % stages, (t / stages) & 1);", ""),
                  ("fetch(t + stages);", ";")],
}
SR_BWD = {
    "full": [],
    "threads_1024": {"layout": _up32},
    "no_ring": {"layout": lambda lay: dataclasses.replace(lay, stages=0)},
    "no_resident": {"layout": lambda lay: dataclasses.replace(
        lay, resident=False)},
    "no_gamma_rows": {"layout": lambda lay: dataclasses.replace(
        lay, grows=False)},
    # two barriers a frame, nothing else resident: the layout at the limit
    "two_barriers": {"layout": lambda lay: dataclasses.replace(
        lay, stages=0, resident=False, pipe=False, grows=False)},
    "no_warc_loads": [("static_cast<double>(w[oarcs[q]]) *", ""),
                      ("static_cast<double>(w[k]) *", "")],
    "no_alpha_loads": [("log(a_next[s]);", "-1.0;")],
    # occ = v: no log or exp (log alpha goes too)
    "no_transcendentals": [
        ("exp(fmin(lsrc + log(v) + scale, SR_EXP_CLAMP))", "v"),
        ("log(a_next[s]);", "a_next[s];")],
    "no_gamma_stage": [("for (int e = nthr - 1 - tid; e < ne; e += nthr) {",
                        "for (int e = nthr - 1 - tid; e < 0; e += nthr) {")],
    # the sums still taken, no row stored
    "no_gamma_writes": [
        ("g[epdf[e]] = static_cast<float>(acc);",
         "if (acc < 0.0) g[epdf[e]] = 0.0f;"),
        ("    bulk_store(gamma + (rows + Tb - 1 - jg) * pw, "
         "grow + (jg & 1) * pw,\n               4u * pw);", "")],
    "no_block_reduce": [
        ("    trace = warp_sum_all(trace);\n    mx = warp_max_all(mx);\n",
         ""),
        ("    trace = warp_sum_all(lane < nwarps ? r_cur[2 * lane] : 0.0);\n"
         "    mx = warp_max_all(lane < nwarps ? r_cur[2 * lane + 1] : 0.0);"
         "\n", "")],
    "no_refill": [("mbar_wait(bar + j % stages, (j / stages) & 1);", ""),
                  ("fetch(j + stages);", ";")],
}
# statements that tell the designs apart
SR_DESIGNS = {"semiring_fwd": [("block_sum<1>(part, red);", SR_FWD_FIRST),
                               ("warp_sum_all(part)", SR_FWD)],
              "semiring_bwd": [("block_sum_max(trace, mx, red);",
                                SR_BWD_FIRST),
                               ("gamma_stage(", SR_BWD)]}


def sr_table(kernel):
    """The variant table that matches this tree's source of a semiring
    kernel."""
    from pychain_tpu_torch.csrc import build
    src = (build.CSRC / f"{kernel}.cu").read_text()
    for marker, table in SR_DESIGNS[kernel]:
        if marker in src:
            return table
    raise SystemExit(f"{kernel}: no variant table matches the source")


def spec(variant):
    """(source edits, host options) of a variant table entry: a list of
    edits, or a dict with "edits" and the options "order" ("ascending":
    B1/B2 read the cluster kernels' operators), "stages" (fact_bwd's
    ring depth) and "layout" (a semiring kernel's layout, a function of
    the plan's)."""
    if isinstance(variant, dict):
        return variant.get("edits", []), {k: v for k, v in variant.items()
                                          if k != "edits"}
    return variant, {}


_builds = {}


def build_variant(name, edits, out_dir):
    """Start nvcc on the kernel's source with ``edits`` (once for a given
    source and edits); returns (process, library path)."""
    from pychain_tpu_torch.csrc import build
    key = (name, tuple(edits))
    if key in _builds:
        return _builds[key]
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
    _builds[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    so)
    return _builds[key]


def semiring_batches(dev, B=128, T=500):
    """Main path 2's flat-start batch (chip_smoke.py's "semiring" class:
    100..150 phones, K_pad 300, S_pad 151) and main path 3's
    constrained batch: tolerance-3 numerators from viterbi_align's best
    paths of the first under x (chip_smoke.py aligns after three
    training steps, so its K_pad and S_pad may differ a little).
    Returns {label: (SemiringArrays, x, lengths)}."""
    import chip_smoke as cs
    from pychain_tpu_torch import viterbi_align
    phones = cs.flat_start_phones(B, 1500, 100, 150, seed=0)
    flat, _ = cs.list_batch(cs.flat_start_fsts(B, 1500, 100, 150, seed=0),
                            dev, pad=(300, 151))
    x = torch.randn(B, T, 3000, generator=torch.Generator(
        device=dev).manual_seed(4), device=dev)
    lens = torch.full((B,), T, device=dev)
    res = viterbi_align(x, lens, flat)
    fsts, _ = cs.constrained_fsts(res, lens, phones, 1500)
    path3, _ = cs.list_batch(fsts, dev)
    return {"path2": (flat.semiring(), x, lens),
            "path3": (path3.semiring(), x, lens)}


def semiring_ablation(tables, use, time_ms, dev):
    """B5/B6's variants at main path 2's and main path 3's batches.  Runs
    on the redesign's wrappers and on the first design's (a tree
    without layouts)."""
    from pychain_tpu_torch.ops import semiring_kernels as sk
    from pychain_tpu_torch.ops.semiring import objective, prepare
    align = getattr(sk, "WARC_ALIGN", 1)
    result = {}

    def kw(kernel, variant, g, P):
        # a variant's forced layout, a function of the plan's
        opts = spec(variant)[1]
        if "layout" not in opts:
            return {}
        return {"layout": opts["layout"](sk.layouts(g, P)[kernel])}

    for label, (g, x, lens) in semiring_batches(dev).items():
        tag = f"{label} K_pad={g.k_pad} S_pad={g.num_states}"
        P = x.shape[2]
        use("semiring_fwd", "full")
        lens32 = lens.int()
        warc, c, n0, lz0 = (prepare(x, g, row_align=align) if align > 1
                            else prepare(x, g))
        n_ys, raw, n_last = sk.semiring_fwd(warc, n0, lens32, g)
        rows = objective(raw, n_last, c, lz0, lens32, g)[1:]
        for name, variant in tables["semiring_fwd"].items():
            use("semiring_fwd", name)
            opts = kw("semiring_fwd", variant, g, P)
            result[f"semiring_fwd/{name} {tag}"] = time_ms(
                lambda: sk.semiring_fwd(warc, n0, lens32, g, **opts))
        use("semiring_fwd", "full")
        for name, variant in tables["semiring_bwd"].items():
            use("semiring_bwd", name)
            opts = kw("semiring_bwd", variant, g, P)
            result[f"semiring_bwd/{name} {tag}"] = time_ms(
                lambda: sk.semiring_bwd(warc, n_ys, n0, lens32, *rows, g, P,
                                        **opts))
        del n_ys, warc
    return result


def main():
    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.csrc import build
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst

    tables = {"fact_fwd": FWD, "fact_bwd": BWD, "stream_fwd": STREAM_FWD,
              "stream_bwd": STREAM_BWD, "semiring_fwd": sr_table(
                  "semiring_fwd"), "semiring_bwd": sr_table("semiring_bwd")}
    if "--only" in sys.argv:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
        tables = {k: {label: v for label, v in table.items()
                      if k in only or f"{k}/{label}" in only}
                  for k, table in tables.items()}
    out_dir = build.BUILD_DIR / "ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kernel, table in tables.items():
        # each forward kernel's full form writes the streams its partner
        # reads
        fwd = kernel.replace("bwd", "fwd")
        if table and (fwd, "full") not in jobs:
            jobs[(fwd, "full")] = build_variant(fwd, [], out_dir)
        for label, variant in table.items():
            if (kernel, label) not in jobs:
                jobs[(kernel, label)] = build_variant(
                    kernel, spec(variant)[0], out_dir)
    for key, (proc, _) in {id(j[0]): (k, j) for k, j in
                           jobs.items()}.values():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{key}: nvcc failed:\n{out}")

    dev = torch.device("cuda")
    B, T = 128, 500
    g = torch.Generator(device=dev).manual_seed(0)
    c = 1e-5

    def use(kernel, label):
        build._loaded[kernel] = ctypes.CDLL(str(jobs[(kernel, label)][1]))

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
    if tables["fact_fwd"] or tables["fact_bwd"]:
        den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                     seed=0, bigram_fanout=30)
        fa = ChainGraphBatch(ChainGraph(den_fst), B, device=dev)._fact
        px = torch.exp(torch.randn(B, T, P, generator=g, device=dev))
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        kept = fk.graph_for(fa)

        def layout(opts):
            # B1/B2's operators in the variant's slot order
            fk._graphs[fa] = kept if opts.get("order") != "ascending" else \
                dataclasses.replace(kept, resident=(kept.w1, kept.w2,
                                                    kept.w1t, kept.w2t))

        use("fact_fwd", "full")
        ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = fk.fact_fwd(
            px, lens, fa, c)
        _, tot = fk._objf(s_ys, ad_last, lens, fa, s0)
        tot = tot.contiguous()
        for label, variant in tables["fact_fwd"].items():
            use("fact_fwd", label)
            layout(spec(variant)[1])
            result[f"fact_fwd/{label}"] = time_ms(
                lambda: fk.fact_fwd(px, lens, fa, c))
        for label, variant in tables["fact_bwd"].items():
            use("fact_bwd", label)
            opts = spec(variant)[1]
            layout(opts)
            kw = {"stages": opts["stages"]} if "stages" in opts else {}
            result[f"fact_bwd/{label}"] = time_ms(
                lambda: fk.fact_bwd(lens, fa, c, ad_ys, w1ad, xdst, xsrc,
                                    s_ys, ad0, s0, tot, P, debug=False,
                                    **kw))
        fk._graphs[fa] = kept
        del ad_ys, w1ad, xdst, xsrc, px

    if tables["stream_fwd"] or tables["stream_bwd"]:
        # the cluster pair at main path 4
        den_fst, P = denominator_fst(num_phones=6000, states_per_phone=2,
                                     num_pdfs=3000, seed=0, bigram_fanout=30,
                                     forward_pdf_mode="separate")
        fa = ChainGraphBatch(ChainGraph(den_fst), B, device=dev)._fact
        tag = {k: f"C={p.cluster} G={p.columns}" for k, p in stk.plan(
            fa, B, torch.cuda.get_device_properties(dev)).items()}
        px = torch.exp(torch.randn(B, T, P, generator=g, device=dev))
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        use("stream_fwd", "full")
        ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = stk.stream_fwd(
            px, lens, fa, c)
        _, tot = fk._objf(s_ys, ad_last, lens, fa, s0)
        tot = tot.contiguous()
        for label in tables["stream_fwd"]:
            use("stream_fwd", label)
            result[f"stream_fwd/{label} {tag['stream_fwd']}"] = time_ms(
                lambda: stk.stream_fwd(px, lens, fa, c))
        use("stream_fwd", "full")
        for label in tables["stream_bwd"]:
            use("stream_bwd", label)
            result[f"stream_bwd/{label} {tag['stream_bwd']}"] = time_ms(
                lambda: stk.stream_bwd(lens, fa, c, ad_ys, w1ad, xdst, xsrc,
                                       s_ys, ad0, s0, tot, P, debug=False))
    if tables["semiring_fwd"] or tables["semiring_bwd"]:
        result.update(semiring_ablation(tables, use, time_ms, dev))
    for k, v in result.items():
        print(f"# {k:28s} {v:8.3f} ms")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"ablation_ms": result, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
