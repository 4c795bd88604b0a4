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
flat-start batch and at main path 3's constrained batch, the fast pair
(fast_fwd, fast_bwd: fact_fwd_bf16 / fact_bwd_bf16 one block a column
and in the group form) at the headline size, the Viterbi
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
# The fast pair (fact_fwd_bf16, fact_bwd_bf16: bfloat16 tiles, the full
# mode) at the headline graph, T=500: the one-block form (C1) at B=128
# and at B=8, 32, 64 (the L2 reads of the operators grow with the
# columns: every block reads every slot every frame), at B=128 with each
# slot's loads pinned to its slice's first slot ("one_slot": the operator
# read from L1, the same number of loads, gathers and sums; an empty asm
# on the index keeps the compiler from hoisting them) and without its
# products; and the group form (G columns a cluster of C CTAs, each CTA's
# rows of the operators in shared memory) at (2, 2) and (4, 4), also
# without its products.  Pinning both loads also pins each lane's gather
# to its first slot's column, so two more rows pin one load each:
# "pinned_val" (the real slot's column from L2, its gather as in the
# kernel; the value from the first slot) and "pinned_col" (the first
# slot's column and gather; the real slot's value from L2).


def _pinned(col_slot, val_slot):
    """An edit replacing sell_row_dot by a copy that reads each slot's
    column id at index ``col_slot`` and its value at ``val_slot``: "i"
    the slot's own (k 32 + lane), "i0" the slice's first slot's."""
    return [('#include "fact_common.cuh"\n', f'''#include "fact_common.cuh"
__device__ __forceinline__ float sell_row_dot_pinned(
    const int* __restrict__ sptr, const int* __restrict__ col,
    const float* __restrict__ val, int r, const float* v) {{
  const int lane = r & 31;
  const int slice = r >> 5;
  float acc = 0.0f;
  const int beg = __ldg(sptr + slice);
  const int end = __ldg(sptr + slice + 1);
  for (int k = beg; k < end; ++k) {{
    const int i = k * 32 + lane;
    int i0 = beg * 32 + lane;
    asm volatile("" : "+r"(i0));
    acc = fmaf(__ldg(val + {val_slot}), v[__ldg(col + {col_slot})], acc);
  }}
  return acc;
}}
#define sell_row_dot sell_row_dot_pinned
''')]


_ONE_SLOT = _pinned("i0", "i0")
_GROUP_FWD_PRODUCTS = [
    ("group_row_dot<G>(ops1, lp1, i, ad, w1a);",
     "load_packed<G>(ad, d, w1a);"),
    ("group_row_dot<G>(ops2, lp2, i, u, w2u);",
     "load_packed<G>(u, d, w2u);")]
_GROUP_BWD_PRODUCTS = [
    ("group_row_dot<G>(ops1, lp1, i, xb, w1t);",
     "load_packed<G>(xb, d, w1t);"),
    ("group_row_dot<G>(ops2, lp2, i, bn, w2t);",
     "load_packed<G>(bn, d, w2t);")]


def _fast_table(products, group_products):
    table = {"C1": {"cluster": 1}}
    for B in (8, 32, 64):
        table[f"C1_B{B}"] = {"cluster": 1, "batch": B}
    table["C1_one_slot"] = {"cluster": 1, "edits": _ONE_SLOT}
    table["C1_pinned_val"] = {"cluster": 1, "edits": _pinned("i", "i0")}
    table["C1_pinned_col"] = {"cluster": 1, "edits": _pinned("i0", "i")}
    table["C1_no_products"] = {"cluster": 1, "edits": products}
    for G, C in ((2, 2), (4, 4)):
        table[f"G{G}C{C}"] = {"cluster": (G, C)}
        table[f"G{G}C{C}_no_products"] = {"cluster": (G, C),
                                          "edits": group_products}
    table["C1_again"] = {"cluster": 1}
    return table


FAST_FWD = _fast_table(_FWD_PRODUCTS[:2], _GROUP_FWD_PRODUCTS)
FAST_BWD = _fast_table(_BWD_PRODUCTS[:2], _GROUP_BWD_PRODUCTS)
# the group form's other phases at (2, 2), one at a time (wrong numbers):
# the emission gathers, the stream stores or reads, the virtual threads'
# pass, the gamma stage (an exchange cannot go: an mbarrier phase armed
# before the last one completed traps)
_G22 = {"cluster": (2, 2)}
FAST_FWD.update({
    "G2C2_no_gather": dict(_G22, edits=[
        ("cp_async4(xd + k, px_t + __ldg(f_dst + s));", ""),
        ("if (g_src) cp_async4(xs + k, px_t + __ldg(g_src + s));", "")]),
    "G2C2_no_stream_writes": dict(_G22, edits=[
        ("          stream_put(w1ad_ys + o, v1);\n          stream_put(xdst_ys"
         " + o, x);\n          if (g_src) stream_put(xsrc_ys + o, xsv);", ""),
        ("stream_put(ad_ys + row * s_pad + d, v);", "")]),
    "G2C2_no_readd": dict(_G22, edits=[
        ("    if (tid < V)\n      for (int i = tid; i < own; i += V)\n"
         "#pragma unroll\n        for (int g = 0; g < G; ++g) part[g] +=",
         "    if (false)\n      for (int i = tid; i < own; i += V)\n"
         "#pragma unroll\n        for (int g = 0; g < G; ++g) part[g] +=")]),
})
# the exchanges made local (no st.async to a peer, no mbarrier armed or
# waited on; each CTA reads its own stale copies): what the two
# exchanges a frame cost, the cluster's skew included
FAST_FWD["G2C2_local"] = dict(_G22, edits=[
    ("      mbar_expect_tx(xbar, warp_bytes);\n      if (t + 1 < t_end) "
     "mbar_expect_tx(xbar + 1, carry_bytes);\n", ""),
    ("    mbar_wait_cluster(xbar, parity);\n    cluster_warp_total_all<G>",
     "    cluster_warp_total_all<G>"),
    ("      mbar_wait_cluster(xbar + 1, parity);\n    }\n  }\n  if (rank "
     "== 0)", "    }\n  }\n  if (rank == 0)"),
    ("ad + (d & ~31) * W, w, rank, C, xbar + 1);",
     "ad + (d & ~31) * W, w, rank, 1, xbar + 1);"),
    ("u + (d & ~31) * W, w, rank, C, xbar + 1);",
     "u + (d & ~31) * W, w, rank, 1, xbar + 1);"),
    ("cluster_post_async<G>(part, red, V, rank, lc, xbar);",
     "cluster_post_async<G>(part, red, V, rank, 0, xbar);")])
FAST_BWD.update({
    "G2C2_local": dict(_G22, edits=[
        ("      mbar_expect_tx(xbar, x1_bytes);\n      mbar_expect_tx(xbar + "
         "1, x2_bytes);\n", ""),
        ("    mbar_wait_cluster(xbar, parity);\n\n    // own rows: the "
         "products", "\n    // own rows: the products"),
        ("    mbar_wait_cluster(xbar + 1, parity);\n    cluster_warp_total_"
         "all<2 * G>", "    cluster_warp_total_all<2 * G>"),
        ("bn + (d & ~31) * W, w, rank, C, xbar);",
         "bn + (d & ~31) * W, w, rank, 1, xbar);"),
        ("xb + (d & ~31) * W, w, rank, C, xbar);",
         "xb + (d & ~31) * W, w, rank, 1, xbar);"),
        ("c1 + (d & ~31) * W, w, rank, C, xbar + 1);",
         "c1 + (d & ~31) * W, w, rank, 1, xbar + 1);"),
        ("c2 + (d & ~31) * W, w, rank, C, xbar + 1);",
         "c2 + (d & ~31) * W, w, rank, 1, xbar + 1);"),
        ("cluster_post_async<2 * G>(rows2, red, V, rank, lc, xbar + 1);",
         "cluster_post_async<2 * G>(rows2, red, V, rank, 0, xbar + 1);")]),
    "G2C2_no_stream_reads": dict(_G22, edits=[
        ("cp_async16(st + (j * G + g) * own_max + 8 * p, base + o);",
         "")]),
    "G2C2_no_gamma": dict(_G22, edits=[
        ("        if (p < n_pdf_lists) {\n          const int fe = __ldg("
         "f_ptr + p + 1);\n          for (int q = __ldg(f_ptr + p); q < fe;"
         " ++q) {", "        if (false) {\n          const int fe = __ldg("
         "f_ptr + p + 1);\n          for (int q = __ldg(f_ptr + p); q < fe;"
         " ++q) {")]),
    "G2C2_no_readd": dict(_G22, edits=[
        ("    if (tid < V)\n      for (int i = tid; i < own; i += V) {\n"
         "        const int d = cluster_row(i, rank, C);\n        const float "
         "lk", "    if (false)\n      for (int i = tid; i < own; i += V) {\n"
         "        const int d = cluster_row(i, rank, C);\n        const float "
         "lk")]),
})
# fact_bwd_bf16's group form at G = 1 (one column a cluster of 2 CTAs,
# the plan within the cluster forms' reach) beside one block a column:
# at main path 7's shape (B=64, T=3,700) as it is and without its
# products, its exchanges (made local), its gamma stage or its stream
# reads; at T=500 at B=8, 16, 32 and 64 (the plan's low end); at B=64
# on the headline family with bigram fan-outs 10 and 20 (W1^T and W2^T
# 132,608 and about 250,000 bytes: whether GROUP_MIN_OPERATOR_BYTES
# holds at G = 1); at bench.py --long's shape (B=32, T=2,500) at C = 2
# and C = 4 ("G1C4": the launch's refusal of G = 1 past C = 2 edited
# out; fast_ablation prints the clusters the card holds at once).
_P7 = {"batch": 64, "frames": 3700}
_G12 = dict(_P7, cluster=(1, 2))
FAST_BWD.update({
    "C1_B64_T3700": dict(_P7, cluster=1),
    "G1C2_B64_T3700": _G12,
    "G1C2_B64_T3700_no_products": dict(_G12, edits=_GROUP_BWD_PRODUCTS),
    "G1C2_B64_T3700_local": dict(_G12,
                                 edits=FAST_BWD["G2C2_local"]["edits"]),
    "G1C2_B64_T3700_no_gamma": dict(_G12,
                                    edits=FAST_BWD["G2C2_no_gamma"]["edits"]),
    "G1C2_B64_T3700_no_stream_reads": dict(
        _G12, edits=FAST_BWD["G2C2_no_stream_reads"]["edits"]),
    "C1_B16": {"cluster": 1, "batch": 16},
})
for _B in (8, 16, 32, 64):
    FAST_BWD[f"G1C2_B{_B}"] = {"cluster": (1, 2), "batch": _B}
for _f in (10, 20):
    FAST_BWD[f"C1_B64_fanout{_f}"] = {"cluster": 1, "batch": 64,
                                      "fanout": _f}
    FAST_BWD[f"G1C2_B64_fanout{_f}"] = {"cluster": (1, 2), "batch": 64,
                                        "fanout": _f}
_LONG = {"batch": 32, "frames": 2500}
FAST_BWD.update({
    "C1_B32_T2500": dict(_LONG, cluster=1),
    "G1C2_B32_T2500": dict(_LONG, cluster=(1, 2)),
    "G1C4_B32_T2500": dict(_LONG, cluster=(1, 4), edits=[(
        "  if (G == 1 && C != 2) return static_cast<int>(cudaErrorInvalidValue"
        ");\n", "")]),
})
# fact_fwd_bf16's group form at G = 1 (one column a cluster of 2 CTAs),
# beside one block a column and the cluster form at C = 2 (the plan it
# replaces within the cluster forms' reach): at main path 7's shape as it
# is and without its products, its exchanges (made local), its emission
# gathers or its stream writes; at T=500 at B=8, 16, 32 and 64; at B=64
# on the headline family with bigram fan-outs 5, 6, 7, 10 and 20 (W1 and
# W2 97,024, 113,152, 132,864, 176,640 and 343,808 bytes: where
# GROUP_ONE_MIN_OPERATOR_BYTES stands for the forward); at bench.py
# --long's shape.
FAST_FWD.update({
    "C1_B64_T3700": dict(_P7, cluster=1),
    "C2_B64_T3700": dict(_P7, cluster=2),
    "G1C2_B64_T3700": _G12,
    "G1C2_B64_T3700_no_products": dict(_G12, edits=_GROUP_FWD_PRODUCTS),
    "G1C2_B64_T3700_local": dict(_G12,
                                 edits=FAST_FWD["G2C2_local"]["edits"]),
    "G1C2_B64_T3700_no_gather": dict(
        _G12, edits=FAST_FWD["G2C2_no_gather"]["edits"]),
    "G1C2_B64_T3700_no_stream_writes": dict(
        _G12, edits=FAST_FWD["G2C2_no_stream_writes"]["edits"]),
    "C1_B16": {"cluster": 1, "batch": 16},
})
for _B in (8, 16, 32, 64):
    FAST_FWD[f"C2_B{_B}"] = {"cluster": 2, "batch": _B}
    FAST_FWD[f"G1C2_B{_B}"] = {"cluster": (1, 2), "batch": _B}
for _f in (5, 6, 7, 10, 20):
    FAST_FWD[f"C2_B64_fanout{_f}"] = {"cluster": 2, "batch": 64,
                                      "fanout": _f}
    FAST_FWD[f"G1C2_B64_fanout{_f}"] = {"cluster": (1, 2), "batch": 64,
                                        "fanout": _f}
FAST_FWD.update({
    "C2_B32_T2500": dict(_LONG, cluster=2),
    "G1C2_B32_T2500": dict(_LONG, cluster=(1, 2)),
})
# The ckpt mode's pair kernel (csrc/fact_ckpt.cu) at main path 7 fast
# (B=64, T=3,700), bench.py --long (B=32, T=2,500) and main path 7's
# float32 cut (B=64, T=1,000): beside each variant ckpt_ablation times,
# on chip_smoke.ckpt_chunks' per-chunk buffers, today's unpaired scan,
# each form alone and the two on two CUDA streams.  Variants: the fast
# chunk role reading W1^T and W2^T as column ids and float values
# ("float_slots": FACT_PAIR_WORDS 0, the graph's packed slots replaced by
# the column ids for the run; the packed words are the design, the same
# bits), and a role's body made empty (its blocks launch and exit: what
# the other role costs in the shared grid).
CKPT_PAIR = {
    "full": [],
    "float_slots": {"edits": [("#define FACT_PAIR_WORDS 1\n",
                               "#define FACT_PAIR_WORDS 0\n")],
                    "float_slots": True},
    "no_backward": [("    fact_bwd_column<S, BWD_CHUNK, ",
                     "    if (false) fact_bwd_column<S, BWD_CHUNK, ")],
    "no_replay": [("    fact_fwd_column<S, FWD_INIT>(",
                   "    if (false) fact_fwd_column<S, FWD_INIT>(")],
}

# the source of a table that is not named after its source
SOURCE = {"xl_vpu": "xl_roofline", "xl_mxu": "xl_roofline",
          "fact_fwd_snap": "fact_fwd", "fact_bwd_lean": "fact_bwd",
          "fact_fwd_cluster": "fact_fwd", "fact_bwd_cluster": "fact_bwd",
          "fast_fwd": "fact_fwd", "fast_bwd": "fact_bwd",
          "ckpt_pair": "fact_ckpt"}

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
    "no_peer_copies": [("cluster_gather_cols<W>(xb, s_pad, rank, lc);",
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

# The cluster pair's fast forms (stream_fwd_bf16, stream_bwd_bf16) at
# main path 4 fast (bfloat16 tiles, B=128, T=500), each launch timed alone
# (stream_bwd_bf16 on the streams of stream_fwd_bf16 at the same plan).
# The float layout (the design before the packed one: float32 copies, 8
# bytes a slot) at its plan then, (C, G) = (2, 2): as it is, with each
# slot's loads pinned to its slice's first slot ("one_slot": the operator
# read from L1, the same loads, gathers and sums; an empty asm on the
# index keeps the compiler from hoisting them), without the products, and
# at B=8 (4 groups: a 16th of the operator's L2 reads a frame).  The
# packed layout at its plan and at each (C, G) it fits at one or two
# waves, the same rows, and each of its design steps taken away: 8-byte
# slots on the packed vector ("slot8"), 4-byte slots on the float layout
# ("float_slot4"); and a step tried on top, each slot's word loaded 4
# slots ahead of its gather ("ahead4").
# how a variant loads a slot's word: read-only through L1 (the kernels'
# __ldg), L2 alone (__ldcg), or through L1 without allocating a line
_WORD_LOADS = {
    "ldg": "__ldg(pack + (A))",
    "ldcg": "__ldcg(pack + (A))",
    "noalloc": "ld_noalloc(pack + (A))"}
_NOALLOC = """__device__ __forceinline__ unsigned ld_noalloc(const unsigned* p) {
  unsigned w;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(w)
               : "l"(p));
  return w;
}
"""


def _row_dot(name, vector, slot, pinned=False, ahead=1, word="ldg",
             gather=True):
    """An edit adding ``name``, a row product of G columns: slots read as
    a packed word ("word": (sptr, pack), loaded as ``_WORD_LOADS[word]``)
    or a column id and a float value ("colval": (sptr, col, val)),
    gathered from the float32 copy ("float": each value rounded) or the
    packed vector ("packed"), or with ``gather`` False not gathered (the
    slot's value times itself); ``pinned``: every slot's loads at the
    slice's first slot; ``ahead``: that many slots' loads issued before
    their gathers, the rest one at a time (the same sum in the same
    order)."""
    args = ("const unsigned* __restrict__ pack" if slot == "word" else
            "const int* __restrict__ col, const float* __restrict__ val")
    vec = "const unsigned* v" if vector == "packed" else "const float* v"
    load = ("{ const unsigned w = " + _WORD_LOADS[word] + "; c[j] = "
            "slot_col(w); x[j] = slot_val(w); }" if slot == "word" else
            "{ c[j] = __ldg(col + (A)); x[j] = __ldg(val + (A)); }")
    gather = ("load_packed<G>(v, c[j], y);" if vector == "packed" else
              "load_cols<G>(v + c[j] * G, y);\n#pragma unroll\n"
              "        for (int g = 0; g < G; ++g) "
              "y[g] = round_to<__nv_bfloat16>(y[g]);") if gather else (
        "#pragma unroll\n        for (int g = 0; g < G; ++g) "
        "y[g] = x[j] + c[j];")

    def step(u):
        at = "i0" if pinned else "(k + j) * 32 + lane"
        pin = ('      int i0 = beg * 32 + lane;\n'
               '      asm volatile("" : "+r"(i0));\n' if pinned else "")
        return "\n".join([
            f"      int c[{u}];",
            f"      float x[{u}];",
            pin.rstrip("\n"),
            "#pragma unroll",
            f"      for (int j = 0; j < {u}; ++j) {load.replace('(A)', at)}",
            "#pragma unroll",
            f"      for (int j = 0; j < {u}; ++j) {{",
            "        float y[G];",
            f"        {gather}",
            "#pragma unroll",
            "        for (int g = 0; g < G; ++g) "
            "acc[g] = fmaf(x[j], y[g], acc[g]);",
            "      }"])

    body = "\n".join([
        "template <int G>",
        f"__device__ __forceinline__ void {name}(",
        f"    const int* __restrict__ sptr, {args}, int r, {vec},",
        "    float (&acc)[G]) {",
        "  const int lane = r & 31;",
        "  const int slice = r >> 5;",
        "#pragma unroll",
        "  for (int g = 0; g < G; ++g) acc[g] = 0.0f;",
        "  const int beg = __ldg(sptr + slice);",
        "  const int end = __ldg(sptr + slice + 1);",
        "  int k = beg;",
        f"  for (; k + {ahead} <= end; k += {ahead}) {{",
        step(ahead),
        "  }",
        "  for (; k < end; ++k) {",
        step(1).replace("(k + j)", "k"),
        "  }",
        "}", ""])
    return [('#include "fact_common.cuh"\n',
             '#include "fact_common.cuh"\n'
             + (_NOALLOC if word == "noalloc" else "") + body)]


# The packed layout with an operator ring (a design step tried and not
# kept, slower at (2, 2)): each warp's W1 (W1^T) slots brought into shared
# memory in pieces of 8 slots by bulk copies on mbarriers, 2 stages a
# warp, across frames, instead of one load a slot.
_RING = r"""
// The packed layout with an operator ring: each warp's slot words of W1
// (W1^T) come into shared memory by bulk copies (the TMA) instead of one
// load a slot.  A warp's rows are one
// 32-row slice, whose slots lie side by side (32 words a slot), so a
// slice's slots are one contiguous run: the warp takes them in pieces of
// at most STREAM_RING_SLOTS slots, each piece one bulk copy into one of
// STREAM_RING_STAGES stages, its mbarrier completed by the copy.  The
// pieces of a frame are the same every frame (the warp's slices in
// order), so lane 0 keeps the copies STREAM_RING_STAGES - 1 pieces ahead
// of the warp, across frames, and never past the launch's last piece:
// every copy is waited on before the CTA exits.
#define STREAM_RING_SLOTS 8
#define STREAM_RING_STAGES 2

// Shared memory of the ring, in 4-byte words: each warp's stages and
// their mbarriers.
__host__ __device__ inline int stream_ring_words() {
  return FACT_WARPS * STREAM_RING_STAGES * (STREAM_RING_SLOTS * 32 + 2);
}

// An L2 policy for data every CTA reads again: evicted last.
__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

struct SliceRing {
  const int* sptr;             // the operator's slice pointers
  const unsigned* pack;        // its packed slots
  unsigned* buf;               // this warp's stages, SLOTS x 32 words each
  unsigned long long* bar;     // this warp's mbarriers
  unsigned long long policy;
  int rank, C, own, first;     // own: this CTA's slices; first: the warp's
  int total;                   // pieces of the launch
  int used;                    // pieces the warp has read
  int issued;                  // pieces lane 0 has asked for
  int pj, pc;                  // the next piece to ask for: local slice, piece
};

// The ring of this warp over `frames` frames (every thread calls it;
// lane 0 initialises the mbarriers and asks for the first pieces).  ring:
// the CTA's ring (stream_ring_words words, 16-byte aligned).  The caller
// passes a block barrier before the first ring_row_dot.
__device__ __forceinline__ SliceRing ring_start(
    const int* __restrict__ sptr, const unsigned* __restrict__ pack,
    unsigned* ring, int s_pad, int rank, int C, int frames) {
  const int warp = threadIdx.x >> 5;
  SliceRing r;
  r.sptr = sptr;
  r.pack = pack;
  r.buf = ring + warp * STREAM_RING_STAGES * STREAM_RING_SLOTS * 32;
  r.bar = reinterpret_cast<unsigned long long*>(
              ring + FACT_WARPS * STREAM_RING_STAGES * STREAM_RING_SLOTS * 32) +
          warp * STREAM_RING_STAGES;
  r.policy = evict_last_policy();
  r.rank = rank;
  r.C = C;
  r.own = cluster_own_rows(s_pad, rank, C) >> 5;
  r.first = warp;
  int pieces = 0;
  for (int j = warp; j < r.own; j += FACT_WARPS) {
    const int k = j * C + rank;
    const int len = __ldg(sptr + k + 1) - __ldg(sptr + k);
    pieces += (len + STREAM_RING_SLOTS - 1) / STREAM_RING_SLOTS;
  }
  r.total = pieces * frames;
  r.used = 0;
  r.issued = 0;
  r.pj = warp;
  r.pc = 0;
  if ((threadIdx.x & 31) == 0) {
    for (int s = 0; s < STREAM_RING_STAGES; ++s) mbar_init(r.bar + s, 1);
  }
  return r;
}

// Lane 0: ask for the next piece, if the launch has one.
__device__ __forceinline__ void ring_issue(SliceRing& r) {
  if (r.issued >= r.total) return;
  int k = r.pj * r.C + r.rank;
  int lo = __ldg(r.sptr + k), len = __ldg(r.sptr + k + 1) - lo;
  while (r.pc * STREAM_RING_SLOTS >= len) {   // the next slice with slots
    r.pc = 0;
    r.pj += FACT_WARPS;
    if (r.pj >= r.own) r.pj = r.first;        // the next frame's first
    k = r.pj * r.C + r.rank;
    lo = __ldg(r.sptr + k);
    len = __ldg(r.sptr + k + 1) - lo;
  }
  const int at = r.pc * STREAM_RING_SLOTS;
  const int n = min(STREAM_RING_SLOTS, len - at);
  const int s = r.issued % STREAM_RING_STAGES;
  mbar_expect_tx(r.bar + s, n * 128);
  bulk_load(r.buf + s * STREAM_RING_SLOTS * 32, r.pack + (lo + at) * 32,
            n * 128, r.bar + s, r.policy);
  ++r.pc;
  ++r.issued;
}

// Lane 0: the first pieces (after the mbarriers' initialisation).
__device__ __forceinline__ void ring_prime(SliceRing& r) {
  if ((threadIdx.x & 31) != 0) return;
  for (int s = 0; s < STREAM_RING_STAGES; ++s) ring_issue(r);
}

// sell_row_dot_packed on row r, the next slice of this warp's ring: the
// same products in the same order, each slot's word read from the stage
// its piece landed in.  Every lane of the warp calls it.
template <int G>
__device__ __forceinline__ void ring_row_dot(SliceRing& ring, int r,
                                             const unsigned* v,
                                             float (&acc)[G]) {
  const int lane = r & 31;
  const int slice = r >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  const int len = __ldg(ring.sptr + slice + 1) - __ldg(ring.sptr + slice);
  for (int at = 0; at < len; at += STREAM_RING_SLOTS) {
    const int s = ring.used % STREAM_RING_STAGES;
    mbar_wait(ring.bar + s, (ring.used / STREAM_RING_STAGES) & 1);
    const unsigned* st = ring.buf + s * STREAM_RING_SLOTS * 32 + lane;
    const int n = min(STREAM_RING_SLOTS, len - at);
    for (int k = 0; k < n; ++k) {
      const unsigned w = st[k * 32];
      const float val = slot_val(w);
      float x[G];
      load_packed<G>(v, slot_col(w), x);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(val, x[g], acc[g]);
    }
    ++ring.used;
    // the stage is read: lane 0 refills it with a later piece
    __syncwarp();
    if (lane == 0) {
      fence_proxy_async();
      ring_issue(ring);
    }
  }
}

"""


def _ring(kernel):
    """The ring's edits of stream_fwd.cu or stream_bwd.cu (the packed
    instantiations alone; its shared memory added to the launch's)."""
    fwd = kernel == "stream_fwd"
    after = ("  float* slot = red + FACT_WARPS * G + G;       // partials, 2 x G\n"
             if fwd else
             "  float* slot_gs = slot_la + 2 * G;                   // sum gamma\n")
    words = ("s_pad * W + nbuf * rows * G + FACT_WARPS * G + 3 * G" if fwd
             else "s_pad * W + (kPacked ? rows * G : 0) + (identity ? 1 : 2)"
             " * rows * W + 2 * FACT_WARPS * G + 5 * G")
    op, vec, out = ("w1", "adp", "w1a") if fwd else ("w1t", "xbp", "w1t")
    ret = ("  return (static_cast<size_t>(s_pad) * W + nbuf * rows * G +\n"
           "          FACT_WARPS * G + 3 * G) * sizeof(float);\n" if fwd else
           "  return (static_cast<size_t>(s_pad) * W +\n"
           "          (packed ? static_cast<size_t>(rows) * G : 0) +\n"
           "          (identity ? 1 : 2) * static_cast<size_t>(rows) * W +\n"
           "          2 * FACT_WARPS * G + 5 * G) * sizeof(float);\n")
    ring_ret = ret.replace("  return (", "  const size_t w = (").replace(
        ") * sizeof(float);", ");") + (
        "  return ((packed ? (w + 3) / 4 * 4 + stream_ring_words() : w)) *\n"
        "         sizeof(float);\n")
    return [
        ('#include "fact_common.cuh"\n', '#include "fact_common.cuh"\n' + _RING),
        (after, after + f"  unsigned* ring_mem = reinterpret_cast<unsigned*>"
         f"(smem4) + (({words} + 3) & ~3);\n"),
        ("    t_max = max(t_max, Tb[g]);\n  }\n",
         "    t_max = max(t_max, Tb[g]);\n  }\n  SliceRing ring;\n"
         "  if constexpr (kPacked) {\n"
         f"    ring = ring_start({op}_ptr, {op}_pack, ring_mem, s_pad, rank, C,"
         " t_max);\n    ring_prime(ring);\n  }\n"),
        (f"sell_row_dot_packed<G>({op}_ptr, {op}_pack, d, {vec}, {out});",
         f"ring_row_dot<G>(ring, d, {vec}, {out});"),
        (ret, ring_ret)]


# The packed layout with the first slices of each CTA's operator rows
# resident in shared memory (a design step tried): the block's shared
# memory past the packed layout's (232,448 bytes a block in all) holds as
# many of the CTA's first own slices of W1 (W1^T) as fit, loaded once a
# launch; their rows read their slots there (group_row_dot), the others
# from L2.
_RESIDENT = r"""
// Load this CTA's first own slices of a packed operator that fit `budget`
// slot words into shared memory (lp: slice pointers, res: the slots);
// returns in *n_res the slices loaded.  The caller passes a block
// barrier before reading them.
__device__ __forceinline__ void resident_load(
    const int* __restrict__ sptr, const unsigned* __restrict__ pack,
    int s_pad, int rank, int C, int budget, int* lp, unsigned* res,
    int* n_res) {
  const int own = cluster_own_rows(s_pad, rank, C) >> 5;
  if (threadIdx.x == 0) {
    int at = 0, j = 0;
    for (; j < own; ++j) {
      const int k = j * C + rank;
      const int len = __ldg(sptr + k + 1) - __ldg(sptr + k);
      if ((at + len) * 32 > budget) break;
      lp[j] = at;
      at += len;
    }
    lp[j] = at;
    *n_res = j;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < *n_res; j += FACT_WARPS) {
    const int k = j * C + rank;
    const int lo = __ldg(sptr + k);
    const int n = (__ldg(sptr + k + 1) - lo) * 8;   // 16-byte pieces
    const uint4* src = reinterpret_cast<const uint4*>(pack) + lo * 8;
    uint4* dst = reinterpret_cast<uint4*>(res) + lp[j] * 8;
    for (int q = lane; q < n; q += 32) dst[q] = __ldg(src + q);
  }
}
"""


def _resident(kernel):
    """The resident slices' edits of stream_fwd.cu or stream_bwd.cu (the
    packed instantiations; the launch asks for the block's whole shared
    memory in the packed layout)."""
    fwd = kernel == "stream_fwd"
    words = ("s_pad * W + nbuf * rows * G + FACT_WARPS * G + 3 * G" if fwd
             else "s_pad * W + (kPacked ? rows * G : 0) + (identity ? 1 : 2)"
             " * rows * W + 2 * FACT_WARPS * G + 5 * G")
    op, vec, out = ("w1", "adp", "w1a") if fwd else ("w1t", "xbp", "w1t")
    ret = ("  return (static_cast<size_t>(s_pad) * W + nbuf * rows * G +\n"
           "          FACT_WARPS * G + 3 * G) * sizeof(float);\n" if fwd else
           "  return (static_cast<size_t>(s_pad) * W +\n"
           "          (packed ? static_cast<size_t>(rows) * G : 0) +\n"
           "          (identity ? 1 : 2) * static_cast<size_t>(rows) * W +\n"
           "          2 * FACT_WARPS * G + 5 * G) * sizeof(float);\n")
    return [
        ('#include "fact_common.cuh"\n',
         '#include "fact_common.cuh"\n' + _RESIDENT),
        ("    t_max = max(t_max, Tb[g]);\n  }\n",
         "    t_max = max(t_max, Tb[g]);\n  }\n"
         f"  const int res_at = (({words} + 3) & ~3) + 4;\n"
         "  int* n_res = reinterpret_cast<int*>(smem4) + res_at - 4;\n"
         "  int* res_lp = reinterpret_cast<int*>(smem4) + res_at;\n"
         "  const int lp_words = group_lp_words(s_pad, C);\n"
         "  unsigned* res_ops = reinterpret_cast<unsigned*>(res_lp + "
         "lp_words);\n"
         "  const int res_budget = 232448 / 4 - res_at - lp_words;\n"
         "  if constexpr (kPacked)\n"
         f"    resident_load({op}_ptr, {op}_pack, s_pad, rank, C, res_budget, "
         "res_lp, res_ops, n_res);\n"),
        (f"sell_row_dot_packed<G>({op}_ptr, {op}_pack, d, {vec}, {out});",
         f"if ((i >> 5) < *n_res) group_row_dot<G>(res_ops, res_lp, i, {vec}, "
         f"{out}); else sell_row_dot_packed<G>({op}_ptr, {op}_pack, d, {vec}, "
         f"{out});"),
        (ret, "  if (packed) return 232448;\n" + ret)]


_TODAY = {"cluster": 2, "columns": 2, "layout": "float"}
# each kernel's W1 product in the float and the packed layout, and the
# prefix of its operator's arguments
_FWD_W1 = ("sell_row_dot_cols<G, S>(w1_ptr, w1_col, w1_val, d, ad, w1a);",
           "sell_row_dot_packed<G>(w1_ptr, w1_pack, d, adp, w1a);", "w1_",
           "ad", "adp", "w1a")
_BWD_W1 = ("sell_row_dot_cols<G, S>(w1t_ptr, w1t_col, w1t_val, d, xb, w1t);",
           "sell_row_dot_packed<G>(w1t_ptr, w1t_pack, d, xbp, w1t);",
           "w1t_", "xb", "xbp", "w1t")


def _stream_fast_table(w1, no_products, no_w2, parts):
    """The fast cluster table of a kernel (its W1 calls ``w1``, its float
    layout's no_products edits, the edit that empties its W2 product, and
    the float32 table whose phase rows the packed layout repeats)."""
    f_call, p_call, ptr, fvec, pvec, out = w1

    def call(name, slot, vec):
        ops = (f"{ptr}ptr, {ptr}pack" if slot == "word" else
               f"{ptr}ptr, {ptr}col, {ptr}val")
        return f"{name}<G>({ops}, d, {vec}, {out});"

    table = {
        "full": {},
        "float": dict(_TODAY),
        "float_one_slot": dict(_TODAY, edits=_row_dot(
            "rd_pinned", "float", "colval", pinned=True)
            + [(f_call, call("rd_pinned", "colval", fvec))]),
        "float_no_products": dict(_TODAY, edits=no_products),
        "float_B8": dict(_TODAY, batch=8),
        "float_slot4": dict(_TODAY, edits=_row_dot("rd_word", "float", "word")
                            + [(f_call, call("rd_word", "word", fvec))]),
    }
    for C, G in ((2, 2), (4, 4)):
        table[f"packed_C{C}G{G}"] = {"cluster": C, "columns": G,
                                     "layout": "packed"}
    pk = {"cluster": 2, "columns": 2, "layout": "packed"}
    table.update({
        "packed_one_slot": dict(pk, edits=_row_dot(
            "rd_pinned", "packed", "word", pinned=True)
            + [(p_call, call("rd_pinned", "word", pvec))]),
        "packed_no_products": dict(pk, edits=[
            (p_call, f"load_packed<G>({pvec}, d, {out});"), no_w2]),
        "packed_B8": dict(pk, batch=8),
        "packed_slot8": dict(pk, edits=_row_dot("rd_colval", "packed",
                                                "colval")
                             + [(p_call, call("rd_colval", "colval", pvec))]),
        "packed_ahead1": dict(pk, edits=_row_dot("rd_ahead", "packed",
                                                 "word")
                              + [(p_call, call("rd_ahead", "word", pvec))]),
        "packed_ahead4": dict(pk, edits=_row_dot("rd_ahead", "packed", "word",
                                                 ahead=4)
                              + [(p_call, call("rd_ahead", "word", pvec))]),
        "packed_ahead8": dict(pk, edits=_row_dot("rd_ahead", "packed", "word",
                                                 ahead=8)
                              + [(p_call, call("rd_ahead", "word", pvec))]),
        "packed_ldcg": dict(pk, edits=_row_dot("rd_ldcg", "packed", "word",
                                               word="ldcg")
                            + [(p_call, call("rd_ldcg", "word", pvec))]),
        "packed_noalloc": dict(pk, edits=_row_dot(
            "rd_noalloc", "packed", "word", word="noalloc")
            + [(p_call, call("rd_noalloc", "word", pvec))]),
        "packed_no_gather": dict(pk, edits=_row_dot(
            "rd_nogather", "packed", "word", gather=False)
            + [(p_call, call("rd_nogather", "word", pvec))]),
        "packed_ring": dict(pk, edits=_ring(
            "stream_fwd" if ptr == "w1_" else "stream_bwd")),
        "packed_resident": dict(pk, edits=_resident(
            "stream_fwd" if ptr == "w1_" else "stream_bwd")),
        "float_again": dict(_TODAY),
    })
    if ptr == "w1_":
        # W2's operand: alpha' at the source read from this CTA's own
        # buffer (no DSMEM load), or x_src at the source not gathered
        table["packed_w2_local"] = dict(pk, edits=[(
            "      load_cols<G>(owner == rank ? p : cluster.map_shared_rank(p, "
            "owner), a);", "      load_cols<G>(p, a);")])
        table["packed_w2_no_px"] = dict(pk, edits=[(
            "round_to<S>(__ldg(px + (row0[g] + t) * P + pdf))", "1.0f")])
    # the packed layout's other phases, one at a time (wrong numbers)
    for label in ("no_emissions", "no_w2_product", "no_peer_copies",
                  "no_cluster_barriers", "no_stream_writes",
                  "no_stream_reads", "no_gamma_stage"):
        if label in parts:
            table[f"packed_{label}"] = dict(pk, edits=parts[label])
    return table


STREAM_FAST_FWD = _stream_fast_table(
    _FWD_W1, STREAM_FWD["no_products"],
    ("const int end = __ldg(w2_ptr + slice + 1);",
     "const int end = __ldg(w2_ptr + slice);"), STREAM_FWD)
STREAM_FAST_BWD = _stream_fast_table(
    _BWD_W1, STREAM_BWD["no_products"],
    ("const int end = __ldg(w2t_ptr + slice + 1);",
     "const int end = __ldg(w2t_ptr + slice);"), STREAM_BWD)
SOURCE.update(stream_fast_fwd="stream_fwd", stream_fast_bwd="stream_bwd")

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


def fast_ablation(tables, use, time_ms, dev):
    """The fast pair's variants at the headline graph (bfloat16 tiles,
    all columns full length) at B=128, T=500 unless a variant names its
    batch, frames or bigram fan-out, each launch timed alone
    (fact_bwd_bf16 on the one-block sweep's streams, which the group form
    writes bit for bit alike).  G = 1 past C = 2 is taken for this run
    (fact_kernels.FORM_GROUPS); the clusters of each G = 1 shape the card
    holds at once are printed."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    c = 1e-5
    fk.FORM_GROUPS = {**fk.FORM_GROUPS, "fact_bwd": tuple(dict.fromkeys(
        fk.FORM_GROUPS["fact_bwd"] + ((1, 4),)))}
    graphs = {}

    def graph(fanout):
        if fanout not in graphs:
            den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                         seed=0, bigram_fanout=fanout)
            graphs[fanout] = (ChainGraphBatch(
                ChainGraph(den_fst), 128, tile_dtype="bfloat16",
                device=dev)._fact, P)
        return graphs[fanout]

    def shape(v):
        o = spec(v)[1]
        return o.get("batch", 128), o.get("frames", 500), o.get("fanout", 30)

    result = {}
    keys = dict.fromkeys(shape(v) for k in ("fast_fwd", "fast_bwd")
                         for v in tables[k].values())
    for B, T, fanout in keys:
        fwd = {k: v for k, v in tables["fast_fwd"].items()
               if shape(v) == (B, T, fanout)}
        bwd = {k: v for k, v in tables["fast_bwd"].items()
               if shape(v) == (B, T, fanout)}
        fa, P = graph(fanout)
        px = torch.exp(torch.randn(B, T, P, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev))
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        use("fact_fwd", "full")
        st = fk.fact_fwd(px, lens, fa, c, cluster=1)
        tot = fk._objf(st[4], st[5], lens, fa, st[7])[1].contiguous()
        tag = f"B={B} T={T}" + (f" fanout={fanout}" if fanout != 30 else "")
        def active(form, group):
            if isinstance(group, tuple) and group[0] == 1:
                print(f"# {form}_bf16 {group} at {tag}: "
                      f"{fk.group_active_clusters(fa, form, group)} "
                      f"clusters at once for {B}", flush=True)

        for label, variant in fwd.items():
            use("fast_fwd", label)
            opts = spec(variant)[1]
            active("fact_fwd", opts["cluster"])
            result[f"fact_fwd_bf16/{label} {tag}"] = time_ms(
                lambda: fk.fact_fwd(px, lens, fa, c,
                                    cluster=opts["cluster"]))
        use("fact_fwd", "full")
        for label, variant in bwd.items():
            use("fast_bwd", label)
            opts = spec(variant)[1]
            group = opts["cluster"]
            active("fact_bwd", group)
            result[f"fact_bwd_bf16/{label} {tag}"] = time_ms(
                lambda: fk.fact_bwd(lens, fa, c, *st[:5], st[6], st[7], tot,
                                    P, debug=False, cluster=group))
        del px, st
        torch.cuda.empty_cache()
    return result


def stream_fast_ablation(tables, use, time_ms, dev):
    """The fast cluster pair's variants at main path 4 fast's graph
    (bfloat16 tiles, T=500, all columns full length) at B=128 unless a
    variant names its batch; ``cluster`` / ``columns`` / ``layout`` force
    the plan."""
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.ops import stream_kernels as stk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    T, c = 500, 1e-5
    den_fst, P = denominator_fst(num_phones=6000, states_per_phone=2,
                                 num_pdfs=3000, seed=0, bigram_fanout=30,
                                 forward_pdf_mode="separate")
    fa = ChainGraphBatch(ChainGraph(den_fst), 128, tile_dtype="bfloat16",
                         device=dev)._fact
    forced = lambda opts: {k: opts[k] for k in ("cluster", "columns",
                                                "layout") if k in opts}
    props = torch.cuda.get_device_properties(dev)

    def tag(name, B, opts):
        # (a tree from before the packed layout has the float one alone)
        p = stk.plan_kernel(fa, name, B, props, **forced(opts),
                            **({"active": stk.card_active(fa)} if hasattr(
                                stk, "card_active") else {}))
        return f"C={p.cluster} G={p.columns} {getattr(p, 'layout', 'float')}"

    result = {}
    for B in (128, 8):
        at = lambda v: spec(v)[1].get("batch", 128) == B
        fwd = {k: v for k, v in tables["stream_fast_fwd"].items() if at(v)}
        bwd = {k: v for k, v in tables["stream_fast_bwd"].items() if at(v)}
        if not (fwd or bwd):
            continue
        px = torch.exp(torch.randn(B, T, P, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev))
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        for label, variant in fwd.items():
            use("stream_fast_fwd", label)
            opts = spec(variant)[1]
            result[f"stream_fwd_bf16/{label} B={B} "
                   f"{tag('stream_fwd', B, opts)}"] = time_ms(
                lambda: stk.stream_fwd(px, lens, fa, c, **forced(opts)))
        for label, variant in bwd.items():
            opts = spec(variant)[1]
            use("stream_fwd", "full")
            st = stk.stream_fwd(px, lens, fa, c, **forced(opts))
            tot = fk._objf(st[4], st[5], lens, fa, st[7])[1].contiguous()
            use("stream_fast_bwd", label)
            result[f"stream_bwd_bf16/{label} B={B} "
                   f"{tag('stream_bwd', B, opts)}"] = time_ms(
                lambda: stk.stream_bwd(lens, fa, c, *st[:5], st[6], st[7],
                                       tot, P, debug=False, **forced(opts)))
            del st
        del px
        torch.cuda.empty_cache()
    return result


def ckpt_ablation(tables, use, time_ms, dev):
    """The ckpt mode's chunk scan at main path 7 fast (B=64, T=3,700),
    bench.py --long (B=32, T=2,500) and main path 7's float32 cut (B=64,
    T=1,000), each over one call's chunks (chip_smoke.ckpt_chunks'
    per-chunk buffers, the snapshot sweep outside the timing): today's
    unpaired scan (fact_fwd_init at its plan's C, then fact_bwd_chunk),
    fact_fwd_init and fact_bwd_chunk alone at C = 1, the two at C = 1 on
    two CUDA streams with events (chunk k's backward beside chunk k - 1's
    replay, a replay waiting for the backward two chunks above it, as the
    pair's two stream sets), each of the pair's roles alone (one-role
    pair launches: the replay's at its own smaller shared memory) and the
    pair kernel's variants, the slots' A/B in turns (full, float_slots,
    float_slots, full).  Also the SMs of one step's blocks (smid):
    one-role pair launches on the two streams (distinct SMs of each, and
    of both together) and one pair launch."""
    import chip_smoke as cs
    from pychain_tpu_torch import ChainGraph, ChainGraphBatch
    from pychain_tpu_torch.csrc import build
    from pychain_tpu_torch.ops import fact_kernels as fk
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    c = 1e-5
    den_fst, P = denominator_fst(num_phones=1500, states_per_phone=2,
                                 seed=0, bigram_fanout=30)
    props = torch.cuda.get_device_properties(dev)
    result = {}
    # the unpaired forms from the tree's own build
    for src in ("fact_fwd", "fact_bwd"):
        build._loaded.pop(src, None)
    for B, T, tile in ((64, 3700, "bfloat16"), (32, 2500, "bfloat16"),
                       (64, 1000, None)):
        fa = ChainGraphBatch(ChainGraph(den_fst), B, tile_dtype=tile,
                             device=dev)._fact
        px = torch.exp(torch.randn(B, T, P, generator=torch.Generator(
            device=dev).manual_seed(70), device=dev))
        lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        C = fk.ckpt_chunk_length(T)
        use("ckpt_pair", "full")
        ck = cs.ckpt_chunks(fa, px, lens, c, C)
        n = len(ck.chunks)
        tag = f"B={B} T={T}{' float32' if tile is None else ''}"

        def replay(k, cluster=1, smid=None):
            t0, ad_init, s_init, streams = ck.chunks[k]
            fk.fact_fwd_init(px, lens, fa, c, t0, ad_init, s_init, streams,
                             cluster, smid)

        def backward(k):
            t0, ad_init, _, streams = ck.chunks[k]
            fk.fact_bwd_chunk(lens, fa, c, streams, ck.s_ys, ck.ad0, ck.s0,
                              ck.tot, t0, ad_init, ck.outs, ck.carry,
                              debug=False, cluster=1)

        def pair(kb, kf, smid=None):
            back = None if kb is None else ck.chunks[kb]
            fk.fact_ckpt_pair(
                px, lens, fa, c, None if kf is None else ck.chunks[kf],
                None if back is None else (back[0], back[1], back[3]),
                ck.s_ys, ck.ad0, ck.s0, ck.tot, ck.outs, ck.carry,
                debug=False, smid=smid)

        init_c = fk.cluster_size(B, props, fa, "fact_fwd_init")

        def today():
            for k in range(n - 1, -1, -1):
                replay(k, init_c)
                backward(k)

        side = torch.cuda.Stream()
        main = torch.cuda.current_stream()

        def two_streams():
            done_rep = [torch.cuda.Event() for _ in range(n)]
            done_back = [torch.cuda.Event() for _ in range(n)]
            side.wait_stream(main)
            for kb, kf in fk.pair_schedule(n):
                if kf is not None:
                    with torch.cuda.stream(side):
                        if kf + 2 < n:
                            side.wait_event(done_back[kf + 2])
                        replay(kf)
                        done_rep[kf].record(side)
                if kb is not None:
                    main.wait_event(done_rep[kb])
                    backward(kb)
                    done_back[kb].record(main)
            main.wait_stream(side)

        def paired():
            for kb, kf in fk.pair_schedule(n):
                pair(kb, kf)

        result[f"ckpt/today (init C={init_c}) {tag}"] = time_ms(today, 3)
        result[f"ckpt/init alone C=1 {tag}"] = time_ms(
            lambda: [replay(k) for k in range(n)], 3)
        result[f"ckpt/chunk alone C=1 {tag}"] = time_ms(
            lambda: [backward(k) for k in range(n - 1, -1, -1)], 3)
        result[f"ckpt/two streams C=1 {tag}"] = time_ms(two_streams, 3)
        # the SMs of one step in the middle of the call
        k = n // 2
        a = torch.full((B,), -1, dtype=torch.int32, device=dev)
        b = torch.full((B,), -1, dtype=torch.int32, device=dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            pair(None, k - 1, smid=b)
        pair(k, None, smid=a)
        main.wait_stream(side)
        both = torch.full((2 * B,), -1, dtype=torch.int32, device=dev)
        pair(k, k - 1, smid=both)
        torch.cuda.synchronize()
        sa, sb = set(a.tolist()), set(b.tolist())
        print(f"# ckpt {tag}: SMs of one step on two streams (one-role "
              f"pair launches): backward {len(sa)}, replay {len(sb)}, "
              f"together {len(sa | sb)} distinct; one pair launch "
              f"{len(set(both.tolist()))} distinct SMs for {2 * B} blocks",
              flush=True)
        result[f"ckpt/pair's replay role alone {tag}"] = time_ms(
            lambda: [pair(None, k) for k in range(n)], 3)
        result[f"ckpt/pair's backward role alone {tag}"] = time_ms(
            lambda: [pair(k, None) for k in range(n - 1, -1, -1)], 3)
        table = tables["ckpt_pair"]
        # the slots' A/B in turns (full, float_slots, float_slots, full),
        # then the other variants
        ab = [label for label in ("full", "float_slots", "float_slots",
                                  "full") if label in table
              and (label == "full" or fk.is_fast(fa))]
        rest = [label for label in table
                if label not in ("full", "float_slots")]
        kept = fk.graph_for(fa)
        for i, label in enumerate(ab + rest):
            use("ckpt_pair", label)
            if spec(table[label])[1].get("float_slots"):
                fk._graphs[fa] = dataclasses.replace(kept, packed=(
                    *kept.packed[:2], kept.resident[2][1],
                    kept.resident[3][1]))
            turn = f" (turn {ab[:i + 1].count(label)})" if i < len(ab) else ""
            result[f"ckpt/pair {label} {tag}{turn}"] = time_ms(paired, 3)
            fk._graphs[fa] = kept
            if i == 0:
                gamma = ck.outs[0].clone()
            elif label == "float_slots":
                print(f"# ckpt {tag}: the float slots give the pair's gamma "
                      f"bit for bit: {torch.equal(ck.outs[0], gamma)}",
                      flush=True)
        use("ckpt_pair", "full")
        del px, ck
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
              "fact_bwd_cluster": FULL_BWD, "fast_fwd": FAST_FWD,
              "fast_bwd": FAST_BWD, "stream_fwd": STREAM_FWD,
              "stream_bwd": STREAM_BWD, "stream_fast_fwd": STREAM_FAST_FWD,
              "stream_fast_bwd": STREAM_FAST_BWD, "semiring_fwd": sr_table(
                  "semiring_fwd"), "semiring_bwd": sr_table("semiring_bwd"),
              "viterbi": sr_table("viterbi"), "xl_vpu": XL_VPU,
              "xl_mxu": XL_MXU, "ckpt_pair": CKPT_PAIR}
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
    if tables["fast_fwd"] or tables["fast_bwd"]:
        result.update(fast_ablation(tables, use, time_ms, dev))
    if tables["ckpt_pair"]:
        result.update(ckpt_ablation(tables, use, time_ms, dev))

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
    if tables["stream_fast_fwd"] or tables["stream_fast_bwd"]:
        result.update(stream_fast_ablation(tables, use, time_ms, dev))
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
