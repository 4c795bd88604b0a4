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
flat-start batch and at main path 3's constrained batch, the Viterbi
kernel (viterbi) at chip_smoke.py's realign, decode and b11 classes, the
XL probe's kernels (xl_vpu, xl_mxu in both splits) at the tool's default
size.
A variant computes wrong numbers by design; only its time means
something: how much of the full kernel's time the removed phase
accounts for (phases overlap, so the savings need not add up).  Some
variants change what the host gives the kernel instead: B1/B2's
operators in ascending slot order, fact_bwd without its ring, or a
semiring kernel at another layout than its plan's (a step of its design
taken away).  The semiring and Viterbi tables match the source they
find (the first design or the redesign), so the script, copied into an
older tree's ``ab_*/`` copy, ablates that tree's kernels.
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
        ("stream_put(xdst_ys + o + s, x);", ""),
        ("if (xsrc_ys) stream_put(xsrc_ys + o + s, xs);", ""),
        ("stream_put(w1ad_ys + o + d, w1a);", ""),
        ("stream_put(ad_ys + oa + d, v);", "")],
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
        ("fetch(t_hi - 1 - k);", ";"), ("fetch(u - stages);", ";")],
    "no_gamma_scatter": [("if (p < n_pdf_lists) {", "if (false) {")],
    "no_gamma_writes": [("__stcs(g_row + p, gv);", "")],
}
# B1/B2's lean forms at main path 7 (bench.py --long --big: B=64,
# T=3,700, bfloat16 tiles), a column on C CTAs: the cluster size forced
# (C1 again last, the drift of the run), CTAs of 1024 / C threads
# ("split"), and at C=2 the sparse products removed, 2, 4 or 8 slots'
# loads issued ahead in each row's
# sum, fact_bwd_lean's px rows gathered from device memory (LEAN_PX_RING
# 0) or its gamma stage spread over a CTA (without the trace), and
# the cluster barriers of a frame made block barriers (their cost: the
# peers' values are then read unsynchronised, the numbers wrong; the
# barriers at a launch's start and end stay, so no CTA exits while a peer
# writes to it).
_FWD_FRAME_BARRIERS = [
    ("      cluster_arrive();\n    }\n    // frame t + 1's",
     "      __syncthreads();\n    }\n    // frame t + 1's"),
    ("    } else {\n      cluster_wait();\n    }\n"
     "    cluster_warp_total<1>(part, red);",
     "    }\n    cluster_warp_total<1>(part, red);"),
    ("    if (!kAsync) cluster_arrive();\n    // alpha' is written",
     "    if (!kAsync) __syncthreads();\n    // alpha' is written"),
    ("    if (!kAsync) {\n      cluster_wait();\n    } else if",
     "    if (!kAsync) {\n    } else if")]
_BWD_FRAME_BARRIERS = [
    ("    cluster_arrive();   // X1", "    // X1"),
    ("    cluster_wait();\n\n    const bool traces",
     "\n    const bool traces"),
    ("cluster_barrier();   // X2", "__syncthreads();"),
    ("cluster_block_sum<1>(g1, red2, V, rank, lc);   // X3",
     "cluster_post<1>(g1, red2, V, rank, lc);\n      __syncthreads();\n"
     "      cluster_warp_total<1>(g1, red2);")]


def _unrolled(u):
    """Edits that put sell_row_dot with u slots' column ids and values
    loaded ahead of their u multiply-adds (the same sum in the same
    order) in place of sell_row_dot in a source."""
    helper = f"""
__device__ __forceinline__ float sell_row_dot_u(
    const int* __restrict__ sptr, const int* __restrict__ col,
    const float* __restrict__ val, int r, const float* v) {{
  const int lane = r & 31;
  const int slice = r >> 5;
  float acc = 0.0f;
  const int end = __ldg(sptr + slice + 1);
  int k = __ldg(sptr + slice);
  for (; k + {u} <= end; k += {u}) {{
    int c[{u}];
    float w[{u}];
#pragma unroll
    for (int j = 0; j < {u}; ++j) {{
      c[j] = __ldg(col + (k + j) * 32 + lane);
      w[j] = __ldg(val + (k + j) * 32 + lane);
    }}
#pragma unroll
    for (int j = 0; j < {u}; ++j) acc = fmaf(w[j], v[c[j]], acc);
  }}
  for (; k < end; ++k)
    acc = fmaf(__ldg(val + k * 32 + lane), v[__ldg(col + k * 32 + lane)],
               acc);
  return acc;
}}
#define sell_row_dot sell_row_dot_u
"""
    return [('#include "fact_common.cuh"\n',
             '#include "fact_common.cuh"\n' + helper)]


# fact_bwd_lean's gamma stage spread over all of a CTA's threads on the
# frames without the sum-gamma trace (its order needs the virtual
# threads)
_GAMMA_SPREAD = [(
    "    if (tid < V) {\n"
    "      for (int p = cluster_row(tid, rank, C); p < P; p += FACT_THREADS) {",
    "    const int own_p = cluster_own_rows((P + 31) & ~31, rank, C);\n"
    "    for (int i = tid; !traces && i < own_p; i += NT) {\n"
    "      const int p = cluster_row(i, rank, C);\n"
    "      if (p >= P) continue;\n"
    "      float acc = 0.0f;\n"
    "      if (p < n_pdf_lists) {\n"
    "        for (int k = __ldg(f_ptr + p); k < __ldg(f_ptr + p + 1); ++k)\n"
    "          acc += c1[__ldg(f_states + k)];\n"
    "        if (!identity)\n"
    "          for (int k = __ldg(g_ptr + p); k < __ldg(g_ptr + p + 1); ++k)\n"
    "            acc += c2[__ldg(g_states + k)];\n"
    "      }\n"
    "      __stcs(g_row + p, kFast ? round_to<S>(acc * inv_s) : acc);\n"
    "    }\n"
    "    if (traces && tid < V) {\n"
    "      for (int p = cluster_row(tid, rank, C); p < P; "
    "p += FACT_THREADS) {")]


_FWD_PRODUCTS = [("sell_row_dot(w1_ptr, w1_col, w1_val, d, ad)", "ad[d]"),
                 ("sell_row_dot(w2_ptr, w2_col, w2_val, d, u)", "u[d]")]
_BWD_PRODUCTS = [("sell_row_dot(w1t_ptr, w1t_col, w1t_val, s, xb)", "xb[s]"),
                 ("sell_row_dot(w2t_ptr, w2t_col, w2t_val, s, bn)", "bn[s]"),
                 ("sell_row_dot(w1_ptr, w1_col, w1_val, s, av)", "av[s]")]


# the cluster form's own work (wrong numbers): the DSMEM stores of the
# vectors the products gather (each value stored in this CTA alone; the
# warp totals still cross), the virtual threads' pass that adds their
# rows in the one-block order
_NO_PEER_STORES = [('#include "fact_common.cuh"\n',
                    '#include "fact_common.cuh"\n'
                    "#define cluster_put(p, x, rank, C) (*(p) = (x))\n")]
_FWD_NO_READD = [("    if (tid < V)\n      for (int d = cluster_row(tid",
                  "    if (false)\n      for (int d = cluster_row(tid")]
_BWD_NO_READD = [("    if (tid < V) {\n      for (int s = cluster_row(tid",
                  "    if (false) {\n      for (int s = cluster_row(tid")]


# CTAs of 1024 / C threads (the one-block kernel's threads a column),
# not built (LEAN_CLUSTER_THREADS is 1024)
_SPLIT = [('#include "fact_common.cuh"\n',
           '#include "fact_common.cuh"\n#undef LEAN_CLUSTER_THREADS\n'
           "#define LEAN_CLUSTER_THREADS(C) (1024 / (C))\n")]


def _lean_table(barriers, products, readd, px_ring=False):
    """The lean variants of a source: {label: (C, edits)}; "split" marks
    the CTAs of 1024 / C threads."""
    table = {"C1": {"cluster": 1},
             # what is left of a frame without its sparse products
             "C1_no_products": {"cluster": 1, "edits": products}}
    for C in (2, 4):
        table[f"C{C}"] = {"cluster": C}
        table[f"C{C}_split"] = {"cluster": C, "edits": _SPLIT}
    for name, edits in (
            ("no_products", products),
            ("no_peer_stores", _NO_PEER_STORES),
            ("no_readd", readd),
            ("unroll2", _unrolled(2)), ("unroll4", _unrolled(4)),
            ("unroll8", _unrolled(8)),
            ("no_cluster_barriers", barriers),
            ("split_no_cluster_barriers", _SPLIT + barriers)):
        table[f"C2_{name}"] = {"cluster": 2, "edits": edits}
    if px_ring:
        table["C2_no_px_ring"] = {
            "cluster": 2, "edits": [("#define LEAN_PX_RING 1\n",
                                     "#define LEAN_PX_RING 0\n")]}
        # the gamma stage spread over a CTA's threads off the trace frames
        table["C2_gamma_spread"] = {"cluster": 2, "edits": _GAMMA_SPREAD}
    table["C1_again"] = {"cluster": 1}
    return table


LEAN_FWD = _lean_table(_FWD_FRAME_BARRIERS, _FWD_PRODUCTS, _FWD_NO_READD)
LEAN_BWD = _lean_table(_BWD_FRAME_BARRIERS, _BWD_PRODUCTS, _BWD_NO_READD,
                       px_ring=True)

# B1/B2's full-stream forms at main path 7 (the same size), a column on C
# CTAs: fact_fwd's cluster form (fact_fwd_init runs the same code) and
# fact_bwd's (fact_bwd_chunk's likewise).  C = 1 and 2, each without its
# sparse products; at C = 2 the exchanges by DSMEM stores and cluster
# barriers (FACT_*_ASYNC 0) in place of st.async (also without the
# products), without the virtual threads' pass, the forward without its
# stream stores, the backward with its stream rows read where it needs
# them (no ring: ring depth 0) and with its gamma stage spread over a
# CTA's threads off the trace frames; and at bench.py --long's size
# (B=32, T=2,500) C = 1, 2 and 4 ("batch").
_FWD_OTHER_EXCHANGE = ("barriers", [("#define FACT_FWD_ASYNC 1\n",
                                      "#define FACT_FWD_ASYNC 0\n")])
_BWD_OTHER_EXCHANGE = ("barriers", [("#define FACT_BWD_ASYNC 1\n",
                                     "#define FACT_BWD_ASYNC 0\n")])
_FWD_NO_STREAM_STORES = [
    ("        stream_put(xdst_ys + o + s, x);\n"
     "        if (xsrc_ys) stream_put(xsrc_ys + o + s, xs[s]);", ""),
    ("      if (kAux) stream_put(w1ad_ys + o + d, w1a);", ""),
    ("      if (put) stream_put(ad_ys + oa + d, a[d]);", "")]
_FULL_GAMMA_SPREAD = [(
    "    if (tid < V) {\n"
    "      for (int p = cluster_row(tid, rank, C); p < P; p += FACT_THREADS) {\n"
    "        float acc = 0.0f;\n"
    "        if (p < n_pdf_lists) {\n"
    "          const int fe = __ldg(f_ptr + p + 1);\n"
    "          for (int q",
    "    const int own_p = cluster_own_rows((P + 31) & ~31, rank, C);\n"
    "    for (int i = tid; !traces && i < own_p; i += NT) {\n"
    "      const int p = cluster_row(i, rank, C);\n"
    "      if (p >= P) continue;\n"
    "      float acc = 0.0f;\n"
    "      if (p < n_pdf_lists) {\n"
    "        const int fe = __ldg(f_ptr + p + 1);\n"
    "        for (int q = __ldg(f_ptr + p); q < fe; ++q)\n"
    "          acc += c1[__ldg(f_states + q)];\n"
    "        if (!identity) {\n"
    "          const int ge = __ldg(g_ptr + p + 1);\n"
    "          for (int q = __ldg(g_ptr + p); q < ge; ++q)\n"
    "            acc += c2[__ldg(g_states + q)];\n"
    "        }\n"
    "      }\n"
    "      __stcs(g_row + p, kFast ? round_to<S>(acc * inv_s) : acc);\n"
    "    }\n"
    "    if (traces && tid < V) {\n"
    "      for (int p = cluster_row(tid, rank, C); p < P; p += FACT_THREADS) {\n"
    "        float acc = 0.0f;\n"
    "        if (p < n_pdf_lists) {\n"
    "          const int fe = __ldg(f_ptr + p + 1);\n"
    "          for (int q")]


def _full_table(other_exchange, products, readd, extra):
    """The full-stream forms' variants of a source: {label: options}
    ("batch": (B, T) other than main path 7's); other_exchange: (name,
    edits) of the exchange the source does not take."""
    other, flip = other_exchange
    table = {"C1": {"cluster": 1},
             "C1_no_products": {"cluster": 1, "edits": products},
             "C2": {"cluster": 2},
             "C2_no_products": {"cluster": 2, "edits": products},
             f"C2_{other}": {"cluster": 2, "edits": flip},
             f"C2_{other}_no_products": {"cluster": 2,
                                         "edits": flip + products},
             "C2_no_readd": {"cluster": 2, "edits": readd}}
    table.update(extra)
    for C in (1, 2, 4):
        table[f"B32_C{C}"] = {"cluster": C, "batch": (32, 2500)}
    table["C1_again"] = {"cluster": 1}
    return table


FULL_FWD = _full_table(_FWD_OTHER_EXCHANGE, _FWD_PRODUCTS, _FWD_NO_READD, {
    "C2_no_stream_stores": {"cluster": 2, "edits": _FWD_NO_STREAM_STORES}})
FULL_BWD = _full_table(_BWD_OTHER_EXCHANGE, _BWD_PRODUCTS, _BWD_NO_READD, {
    "C2_no_ring": {"cluster": 2, "stages": 0},
    "C2_gamma_spread": {"cluster": 2, "edits": _FULL_GAMMA_SPREAD}})
# the source of a table that is not named after its source
SOURCE = {"xl_vpu": "xl_roofline", "xl_mxu": "xl_roofline",
          "fact_fwd_snap": "fact_fwd", "fact_bwd_lean": "fact_bwd",
          "fact_fwd_cluster": "fact_fwd", "fact_bwd_cluster": "fact_bwd"}

# The cluster pair (a cluster a group of G columns, W1's vector alone
# held whole, one / two cluster barriers a frame).
STREAM_FWD = {
    "full": [],
    "no_emissions": [("x[g] = round_to<S>(__ldg(px_t + fd));",
                      "x[g] = 1.0f;"),
                     ("g_src ? round_to<S>(__ldg(px_t + gd)) : x[g]", "x[g]"),
                     ("__ldg(px + (row0[g] + t) * P + pdf)", "1.0f")],
    "no_products": [
        ("sell_row_dot_cols<G, S>(w1_ptr, w1_col, w1_val, d, ad, w1a);",
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
        ("stream_put(xdst_ys + o, x[g]);", ""),
        ("if (xsrc_ys) stream_put(xsrc_ys + o, xs[g]);", ""),
        ("stream_put(w1ad_ys + o, w1a[g]);", ""),
        ("store_cols_stream<4 / G>(ad_ys + (row0[g] + t - 1) * s_pad + j0,",
         "if (false) store_cols_stream<4 / G>(ad_ys,")],
}
STREAM_BWD = {
    "full": [],
    "no_products": [
        ("sell_row_dot_cols<G, S>(w1t_ptr, w1t_col, w1t_val, d, xb, w1t);",
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
        ("stream_get(xdst_ys + (row0[g] + u) * s_pad + d)", "1.0f"),
        ("stream_get((identity ? xdst_ys : xsrc_ys) + o)", "1.0f"),
        ("stream_get(ad_ys + o - s_pad)", "1.0f"),
        ("stream_get(w1ad_ys + o)", "1.0f")],
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


# The Viterbi kernel B11 in its first design: one block a
# sequence, a thread a state walking its in-arc list from device memory,
# int32 arc backpointers in device memory, the tail on thread 0.
VIT_FIRST = {
    "full": [],
    "no_x_loads": [("float e = __ldg(xt + __ldg(pdf_g + k));",
                    "float e = 1.0f;")],
    # no backpointer stored, none read back (the walk runs, finds -1)
    "no_bp_writes": [
        ("bpt[s] = best > -CUDART_INF_F ? arg : -1;", ""),
        ("const int arc = bp[(static_cast<size_t>(b) * T + t) * S + c];",
         "const int arc = -1;")],
    "no_tail": [("  if (tid != 0) return;\n  const float* fin",
                 "  return;\n  const float* fin")],
}
# The redesign: L lanes a state, resident slot lists, x fetched ahead,
# byte positions in shared memory, the end scoring on the block.  The
# "layout" variants force another layout (a function of the plan's and
# S_pad): a design step taken away.
def _vit(**kw):
    """A layout variant: the plan's with ``kw`` changed, its threads
    recounted (L lanes a state, a producer warp with a ring)."""
    def forced(lay, S):
        from pychain_tpu_torch.ops import viterbi_kernels as vk
        lay = dataclasses.replace(lay, **kw)
        return dataclasses.replace(lay, threads=vk.threads_for(
            S, lay.lanes, lay.stages > 0))
    return {"layout": forced}


def _lanes(f):
    """A layout variant with L = f(the plan's L)."""
    def forced(lay, S):
        return _vit(lanes=max(1, min(32, f(lay.lanes))))["layout"](lay, S)
    return {"layout": forced}


VIT = {
    "full": [],
    "lanes_1": _lanes(lambda L: 1),
    "lanes_x2": _lanes(lambda L: 2 * L),
    "lanes_half": _lanes(lambda L: L // 2),
    "no_resident": _vit(resident=False),
    "no_ring": _vit(stages=0),
    "ring_2": _vit(stages=2),
    "ring_8": _vit(stages=8),
    "bp_in_device_memory": _vit(bp_smem=False),
    # the first design's data flow in the new kernel: one lane a state,
    # lists, x and positions in device memory
    "last_rung": _vit(lanes=1, stages=0, resident=False, bp_smem=False),
    "no_unroll": [("#pragma unroll 4\n", "")],
    "unroll_8": [("#pragma unroll 4\n", "#pragma unroll 8\n")],
    "no_x_reads": [("float e = RING ? xr[col] : __ldg(xr + col);",
                    "float e = 1.0f;")],
    # the end scoring and the traceback
    "no_tail": [("  // the end state: the lowest state of the max",
                 "  return;\n  // the end state: the lowest state of the max")],
    # no state's work: what is left of a frame is the ring, the barrier
    # and the loop (no tail: the positions are never written)
    "empty_frames": [
        ("for (int base = 0; !producer && base < S; base += ngroups) {",
         "for (int base = 0; false && base < S; base += ngroups) {"),
        ("  // the end state: the lowest state of the max",
         "  return;\n  // the end state: the lowest state of the max")],
    # the arcs' work without the frame's stores and the tail
    "no_stores": [
        ("        nxt[s] = best;\n        bp_put(bpb, bp_row + s, bp_width, "
         "arg >= 0 ? arg - beg : 0);",
         "        if (best == 1.2345f) nxt[s] = best + arg;"),
        ("  // the end state: the lowest state of the max",
         "  return;\n  // the end state: the lowest state of the max")],
}
VIT_DESIGNS = {"viterbi": [("bpt[s] = best > -CUDART_INF_F ? arg : -1;",
                            VIT_FIRST), ("bp_put(", VIT)]}


# the XL probe's kernels (csrc/xl_roofline.cu) at the tool's default size
XL_VPU = {
    "full": [],
    "summing_warp_idle": [(
        "      const double v = xl_vpu_total(part_buf + cur * nt, nwarps, lane);",
        "      const double v = 1.0;")],
    "no_gathers": [(
        "for (int r = 0; r < R; ++r) v[r] = b_prev[e[r] & XL_SRC_MASK];",
        "for (int r = 0; r < R; ++r) v[r] = __int_as_float(e[r] & 0x3fffff);")],
    "no_stores": [("    b_next[s] = x;\n", "    if (x == -1.0f) b_next[s] = x;\n")],
    "no_partials": [("    part += x;\n    ++s;", "    ++s;")],
    "no_barrier": [("    // scale slots, which no thread reads after this barrier.\n"
                    "    __syncthreads();", "")],
}
XL_MXU = {
    "full": [],
    "no_mma": [("  asm volatile(\n      \"mma.sync",
                "  if (a0 == 12345u) asm volatile(\n      \"mma.sync")],
    # every occurrence is replaced: both loops of a product
    "no_first_product": [("frag1(c, j);", ";")],
    "no_second_product": [("frag2(c, j);", ";")],
    "all_behind_a_branch": [("      for (int j = 0; j < jmin; ++j) {",
                             "      for (int j = 0; j < 0; ++j) {"),
                            ("      for (int j = jmin; j < jmax; ++j) {",
                             "      for (int j = 0; j < jmax; ++j) {")],
    "no_first_pass": [("k0 < 16 * p1_hi;\n", "k0 < 0;\n")],
    "no_carry_terms": [("s < 16 * q_hi; s += 32) {", "s < 0; s += 32) {")],
    "first_pass_one_at_a_time": [("#define XL_MXU_BATCH 4 ",
                                  "#define XL_MXU_BATCH 1 ")],
    "no_barriers": [
        ("    __syncthreads();\n    // -- a^T = ohd", "    // -- a^T = ohd"),
        ("that frame's first barrier\n    __syncthreads();",
         "that frame's first barrier\n")],
}


def xl_ablation(tables, use, time_ms, dev):
    """The probe's kernels at the tool's default size (S=1000, K=3200,
    T=512, B=8) on their default plans: xl_vpu, and xl_mxu in both
    splits."""
    from pychain_tpu_torch.tools import xl_roofline as xr
    S, K, T, B = 1000, 3200, 512, 8
    src, dst, w = xr.inputs(S, K, B, dev)
    plan = xr.vpu_plan(src, dst, w, S)
    ops = xr.mxu_operands(src, dst, w, S)
    result = {}
    tag = f"{plan.threads // 32} warps {plan.slots} slots"
    for label in tables["xl_vpu"]:
        use("xl_vpu", label)
        result[f"xl_vpu/{label} {tag}"] = time_ms(
            lambda: xr.vpu_kernel(plan, S, T))
    for label in tables["xl_mxu"]:
        use("xl_mxu", label)
        for name in ("xl_mxu_f32", "xl_mxu_bf16"):
            result[f"{name}/{label}"] = time_ms(
                lambda: xr.mxu_kernel(name, ops, S, T))
    return result


def sr_table(kernel):
    """The variant table that matches this tree's source of a semiring
    kernel."""
    from pychain_tpu_torch.csrc import build
    src = (build.CSRC / f"{kernel}.cu").read_text()
    for marker, table in {**SR_DESIGNS, **VIT_DESIGNS}[kernel]:
        if marker in src:
            return table
    raise SystemExit(f"{kernel}: no variant table matches the source")


def spec(variant):
    """(source edits, host options) of a variant table entry: a list of
    edits, or a dict with "edits" and the options "order" ("ascending":
    B1/B2 read the cluster kernels' operators), "stages" (fact_bwd's
    ring depth), "layout" (a semiring kernel's layout, a function of
    the plan's) and "cluster" (the lean forms' CTAs a column)."""
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


def viterbi_batches(dev, B=128, T=500):
    """chip_smoke.py's three Viterbi size classes: "realign" (main path
    2's flat-start batch, K_pad 300, S_pad 151, under seeded x, all
    lengths T), "decode" (PhoneDecoder's 48-phone bigram graph, shared,
    P = 96, lengths 250..500) and "b11" (bench.py --viterbi: 128
    random_fst(512, 512, 4)).  Returns {label: (SemiringArrays, x,
    lengths)}."""
    import numpy as np
    import chip_smoke as cs
    from pychain_tpu_torch import ChainGraphBatch
    from pychain_tpu_torch.decode import PhoneDecoder
    from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                                  estimate_phone_lm)
    from pychain_tpu_torch.utils.testgraphs import random_fst
    gen = torch.Generator(device=dev)
    flat, _ = cs.list_batch(cs.flat_start_fsts(B, 1500, 100, 150, seed=0),
                            dev, pad=(300, 151))
    out = {"realign": (flat.semiring(), torch.randn(
        B, T, 3000, generator=gen.manual_seed(4), device=dev),
        torch.full((B,), T, device=dev))}
    rng = np.random.RandomState(7)
    texts = [[int(p) for p in rng.randint(0, 48, size=rng.randint(20, 61))]
             for _ in range(2000)]
    dec = PhoneDecoder(estimate_phone_lm(texts, num_phones=48, order=2),
                       ChainTopology(num_phones=48))
    out["decode"] = (ChainGraphBatch(dec.graph, B, device=dev).semiring(),
                     torch.randn(B, T, 96, generator=gen.manual_seed(8),
                                 device=dev),
                     torch.from_numpy(rng.randint(T // 2, T + 1, size=B)))
    b11, _ = cs.list_batch([random_fst(num_states=512, num_pdfs=512,
                                       max_arcs_per_state=4, seed=s)
                            for s in range(B)], dev)
    out["b11"] = (b11.semiring(), torch.randn(
        B, T, 512, generator=gen.manual_seed(9), device=dev),
        torch.full((B,), T, device=dev))
    return out


def viterbi_ablation(table, use, time_ms, dev):
    """B11's variants at its three size classes.  Runs on the redesign's
    wrappers and on the first design's (a tree without layouts); each
    forced layout must give the full kernel's bits."""
    from pychain_tpu_torch.ops import viterbi_kernels as vk
    result = {}
    for label, (g, x, lens) in viterbi_batches(dev).items():
        lens32 = lens.int().to(dev)
        lay = vk.plan_for(g, x.shape[2], x.shape[1]) if hasattr(
            vk, "plan_for") else None
        tag = f"{label} {lay}" if lay else label
        use("viterbi", "full")
        want = vk.viterbi_sweep(x, lens32, g)
        for name, variant in table.items():
            use("viterbi", name)
            opts = spec(variant)[1]
            kw = {"layout": opts["layout"](lay, g.num_states)} \
                if "layout" in opts else {}
            if kw:
                got = vk.viterbi_sweep(x, lens32, g, **kw)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"viterbi/{name} {label}: layout "
                                     f"{kw['layout']} differs from the "
                                     "plan's")
            result[f"viterbi/{name} {tag}"] = time_ms(
                lambda: vk.viterbi_sweep(x, lens32, g, **kw))
        del x
    return result


def lean_ablation(tables, use, time_ms, dev):
    """The lean forms' variants at main path 7 (bench.py --long --big: the
    headline graph, B=64, T=3,700, bfloat16 tiles), each call timed alone
    (fact_bwd_lean on the C = 1 sweep's alpha' stream)."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    B, T, c = 64, 3700, 1e-5
    den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    fa = ChainGraphBatch(ChainGraph(den_fst), B, tile_dtype="bfloat16",
                         device=dev)._fact
    px = torch.exp(torch.randn(B, T, P, generator=torch.Generator(
        device=dev).manual_seed(70), device=dev))
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    use("fact_fwd", "full")
    ad1, s_ys, ad_last, ad0, s0 = fk.fact_fwd_snap(px, lens, fa, c,
                                                   cluster=1)
    tot = fk._objf(s_ys, ad_last, lens, fa, s0)[1].contiguous()
    result = {}
    tag = f"B={B} T={T}"
    for label, variant in tables["fact_fwd_snap"].items():
        use("fact_fwd_snap", label)
        opts = spec(variant)[1]
        result[f"fact_fwd_snap_bf16/{label} {tag}"] = time_ms(
            lambda: fk.fact_fwd_snap(px, lens, fa, c,
                                     cluster=opts["cluster"]), reps=3)
    use("fact_fwd", "full")
    for label, variant in tables["fact_bwd_lean"].items():
        use("fact_bwd_lean", label)
        opts = spec(variant)[1]
        result[f"fact_bwd_lean_bf16/{label} {tag}"] = time_ms(
            lambda: fk.fact_bwd_lean(lens, fa, c, ad1, px, s_ys, ad0, s0, tot,
                                     debug=False, cluster=opts["cluster"]),
            reps=3)
    del px, ad1
    torch.cuda.empty_cache()
    return result


def full_cluster_ablation(tables, use, time_ms, dev):
    """The full-stream forms' variants at main path 7 (bench.py --long
    --big: the headline graph, B=64, T=3,700, bfloat16 tiles) and at
    bench.py --long's B=32, T=2,500, each launch timed alone (fact_bwd on
    the C = 1 sweep's streams)."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    c = 1e-5
    den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    result = {}
    for B, T in ((64, 3700), (32, 2500)):
        at = lambda variant: spec(variant)[1].get("batch", (64, 3700)) \
            == (B, T)
        fwd = {k: v for k, v in tables["fact_fwd_cluster"].items() if at(v)}
        bwd = {k: v for k, v in tables["fact_bwd_cluster"].items() if at(v)}
        if not (fwd or bwd):
            continue
        fa = ChainGraphBatch(ChainGraph(den_fst), B, tile_dtype="bfloat16",
                             device=dev)._fact
        px = torch.exp(torch.randn(B, T, P, generator=torch.Generator(
            device=dev).manual_seed(70), device=dev))
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        use("fact_fwd", "full")
        st = fk.fact_fwd(px, lens, fa, c, cluster=1)
        tot = fk._objf(st[4], st[5], lens, fa, st[7])[1].contiguous()
        tag = f"B={B} T={T}"
        for label, variant in fwd.items():
            use("fact_fwd_cluster", label)
            opts = spec(variant)[1]
            result[f"fact_fwd_bf16/{label} {tag}"] = time_ms(
                lambda: fk.fact_fwd(px, lens, fa, c,
                                    cluster=opts["cluster"]), reps=3)
        use("fact_fwd", "full")
        for label, variant in bwd.items():
            use("fact_bwd_cluster", label)
            opts = spec(variant)[1]
            result[f"fact_bwd_bf16/{label} {tag}"] = time_ms(
                lambda: fk.fact_bwd(lens, fa, c, *st[:5], st[6], st[7], tot,
                                    P, debug=False, stages=opts.get("stages"),
                                    cluster=opts["cluster"]), reps=3)
        del px, st
        torch.cuda.empty_cache()
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

    tables = {"fact_fwd": FWD, "fact_bwd": BWD, "fact_fwd_snap": LEAN_FWD,
              "fact_bwd_lean": LEAN_BWD, "fact_fwd_cluster": FULL_FWD,
              "fact_bwd_cluster": FULL_BWD, "stream_fwd": STREAM_FWD,
              "stream_bwd": STREAM_BWD, "semiring_fwd": sr_table(
                  "semiring_fwd"), "semiring_bwd": sr_table("semiring_bwd"),
              "viterbi": sr_table("viterbi"), "xl_vpu": XL_VPU,
              "xl_mxu": XL_MXU}
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
        src = SOURCE.get(kernel, kernel)
        fwd = src.replace("bwd", "fwd")
        if table and (fwd, "full") not in jobs:
            jobs[(fwd, "full")] = build_variant(fwd, [], out_dir)
        for label, variant in table.items():
            if (kernel, label) not in jobs:
                jobs[(kernel, label)] = build_variant(
                    src, spec(variant)[0], out_dir)
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
        build._loaded[SOURCE.get(kernel, kernel)] = ctypes.CDLL(
            str(jobs[(kernel, label)][1]))

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

    if tables["fact_fwd_snap"] or tables["fact_bwd_lean"]:
        result.update(lean_ablation(tables, use, time_ms, dev))
    if tables["fact_fwd_cluster"] or tables["fact_bwd_cluster"]:
        result.update(full_cluster_ablation(tables, use, time_ms, dev))

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
    if tables["viterbi"]:
        result.update(viterbi_ablation(tables["viterbi"], use, time_ms, dev))
    if tables["xl_vpu"] or tables["xl_mxu"]:
        result.update(xl_ablation(tables, use, time_ms, dev))
    for k, v in result.items():
        print(f"# {k:28s} {v:8.3f} ms")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"ablation_ms": result, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
