"""The port's cluster tier (B3/B4) against the JAX package's streamed one.

The JAX package serves denominators past its resident kernels' VMEM with
weight-streaming Pallas kernels (ops/pallas_stream.py); the port serves
denominators past one SM's shared memory with two CUDA kernels that split
each column's state vectors over a thread-block cluster
(ops/stream_kernels.py).  Here, on the CPU:

* the port's forward_backward_prob_stream (the plain version on CPU
  tensors) against JAX's B3/B4 in interpret mode, and ChainLoss with the
  denominator forced to engine="stream" in both packages: objf relative
  and gamma / gradient max-abs <= 1e-5;
* a step-for-step emulation of the two kernels on the arrays they read
  (packed state ids, each CTA's row range, the pdf columns each CTA
  owns, partial sums added in rank order) against the plain version, for
  every cluster size and x_src mode, to 1e-5; in the fast mode (bfloat16
  tiles: the graph's fast form, every sum in the kernels' order) equal
  under torch.equal to the plain fast version with ``cluster=C``;
* the tiering (resident, cluster, or NotImplementedError) and the card's
  stream budget, sized by arithmetic on the shapes of main path 4's
  graph rather than by building it.

tests/test_torch_card.py holds the kernels themselves to the plain
version on the card.
"""

import dataclasses
import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pychain_tpu.graphs.factorize as jfz
from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.loss import chain_loss as j_chain_loss
from pychain_tpu.ops.pallas_stream import \
    forward_backward_prob_stream as j_stream
from pychain_tpu.utils.testgraphs import denominator_fst

import pychain_tpu_torch as pt
import pychain_tpu_torch.graphs.factorize as pfz
from pychain_tpu_torch import loss as pt_loss
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.ops import stream_kernels as sk
from pychain_tpu_torch.ops.factorized import (block_sum,
                                              forward_backward_prob_fact,
                                              forward_backward_prob_fast,
                                              is_fast)
from pychain_tpu_torch.utils.testgraphs import linear_fst

LEAKY = 1e-5
MODES = [("source", "identity"), ("cross", "matrix"),
         ("separate", "stream")]


def _tiled_batches(mode, B):
    """The JAX stream tests' graph (tests/test_pallas_stream.py:33-55):
    denominator_fst(256, 2, bigram_fanout=2) with every transition
    matrix forced onto the 128x128 tile stratum (dense_min_fill=2.0), so
    that the JAX kernels stream W1 tiles; the same strata in both
    packages."""
    fst, P = denominator_fst(num_phones=256, states_per_phone=2,
                             bigram_fanout=2, seed=0, forward_pdf_mode=mode)
    j_orig, p_orig = jfz._build_wparts, pfz._build_wparts
    jfz._build_wparts = functools.partial(j_orig, dense_min_fill=2.0)
    pfz._build_wparts = functools.partial(p_orig, dense_min_fill=2.0)
    try:
        jbatch = JChainGraphBatch(JChainGraph(fst), B)
        batch = pt.ChainGraphBatch(pt.ChainGraph(fst), B, device="cpu")
    finally:
        jfz._build_wparts, pfz._build_wparts = j_orig, p_orig
    assert jbatch._fact.w1.tiles.shape[0] > 1, "W1 tiles must stream"
    return fst, P, jbatch, batch


def _assert_close(got, ref):
    np.testing.assert_allclose(got.objf.numpy(), np.asarray(ref.objf),
                               rtol=1e-5, atol=0)
    for name in ("gamma", "alpha_beta", "gamma_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", ["source", "separate"])
def test_stream_matches_jax_stream_interpret(mode):
    B, T = 4, 10
    _, P, jbatch, batch = _tiled_batches(mode, B)
    rng = np.random.RandomState(0)
    px = np.exp(rng.randn(B, T, P).astype(np.float32) * 0.3)
    lengths = np.array([T, T, T - 2, T - 5], np.int32)
    got = sk.forward_backward_prob_stream(
        torch.from_numpy(px.copy()), torch.from_numpy(lengths.copy()),
        batch._fact, LEAKY)
    ref = j_stream(jnp.asarray(px.copy()), jnp.asarray(lengths.copy()),
                   jbatch._fact, LEAKY)
    _assert_close(got, ref)


def test_chain_loss_forced_stream_matches_jax():
    """ChainLoss's objective and x-gradient with the denominator forced
    to engine="stream" in both packages."""
    B, T = 3, 8
    _, P, jbatch, batch = _tiled_batches("separate", B)
    rng = np.random.RandomState(1)
    lens = np.array([T, T - 3, T - 5], np.int32)
    seqs = [rng.randint(0, P, size=int(n)) for n in lens]
    x = rng.randn(B, T, P).astype(np.float32)
    K = int(lens.max())
    nums = pt.ChainGraphBatch(
        [pt.ChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1, device="cpu")
    den = dataclasses.replace(batch._fact, engine="stream")
    assert pt_loss.dispatch_arrays(den).engine == "stream"
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    val = pt_loss.chain_loss(xt, torch.from_numpy(lens.copy()), nums, den)
    val.backward()

    jnums = JChainGraphBatch(
        [JChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1)
    jden = dataclasses.replace(jbatch._fact, engine="stream")
    jval, jgrad = jax.value_and_grad(
        lambda a: j_chain_loss(a, jnp.asarray(lens.copy()), jnums, jden))(
            jnp.asarray(x.copy()))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# Emulation of the cluster kernels on the arrays they read
# ----------------------------------------------------------------------

def _case(mode, B=5, T=9, seed=2, num_phones=150, tile_dtype=None):
    """S = 300, S_pad = 384: 12 slices of 32 rows, so with C = 8 ranks
    0-3 own two slices and ranks 4-7 one (num_phones=10, S_pad = 128:
    ranks 4-7 own none).  B = 5 columns of unequal lengths: no G > 1
    divides B, and a group mixes lengths."""
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=mode)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, P).astype(np.float32)
    lengths = np.array([T, T - 2, 3, 1, T - 4][:B], np.int32)
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), B, tile_dtype=tile_dtype,
                            device="cpu")._fact
    return fa, torch.exp(torch.from_numpy(x)), torch.from_numpy(lengths)


def _entries(sell):
    """(row, col, val) of every entry of a sliced-ELL operator
    (fact_kernels._sell), padding included."""
    sptr, col, val = sell
    slen = (sptr[1:] - sptr[:-1]).long()
    k = torch.arange(len(col))
    row = (torch.repeat_interleave(torch.arange(len(slen)), slen * fk.SLICE)
           * fk.SLICE + k % fk.SLICE)
    return row, col.long(), val


def _mv(sell, V):
    """A sliced-ELL operator times the G columns of V (S_pad, G)."""
    row, col, val = _entries(sell)
    return torch.zeros(V.shape).index_add_(0, row, val[:, None] * V[col])


def _slots(sell, s_pad, *extra):
    """A sliced-ELL operator's arrays (col, val, then each array of
    ``extra`` laid out like col) as (K, S_pad) tables: entry k of row r at
    [k, r], zero past the row's slice (a padding slot: column 0, value
    0)."""
    row, _, _ = _entries(sell)
    sptr = sell[0].long()
    k = torch.arange(len(row)) // fk.SLICE - sptr[row // fk.SLICE]
    K = int((sptr[1:] - sptr[:-1]).max())
    out = []
    for arr in (sell[1], sell[2], *extra):
        t = torch.zeros((K, s_pad), dtype=arr.dtype)
        t[k, row] = arr
        out.append(t)
    return out


def _row_dot(table, rows, operand):
    """sell_row_dot_cols on the given rows: each row's entries times
    ``operand(k, cols)`` (the G columns of slot k's gathers), added in slot
    order from 0."""
    cols, vals = table[0][:, rows], table[1][:, rows]
    acc = 0.0
    for k in range(cols.shape[0]):
        acc = acc + vals[k][:, None] * operand(k, cols[k])
    return acc


def _bf(v):
    return v.to(torch.bfloat16).float()


class _Cluster:
    """The CTAs of one cluster: CTA r owns the 32-row slices k = r (mod C)
    in all G columns of its group, its rows' values at local rows (a
    (C, R, G) tensor per vector) and whole copies of the vector its W1
    (W1^T) product gathers (a (C, S_pad, G) tensor); a state is read from
    its owner's local row."""

    def __init__(self, fa, C):
        self.C, self.R = C, sk.rows_per_cta(fa.s_pad, C)
        self.kg = sk.cluster_graph(fk.kernel_graph(fa), C)
        # the fast mode: the operators' off-diagonal rows as slot tables
        # (W2's with the x_src pdf at each entry's source), the diagonals
        self.fast = is_fast(fa)
        if self.fast:
            w1, w2, w1t, w2t = sk.operators(self.kg)
            self.tables = (_slots(w1, fa.s_pad),
                           _slots(w2, fa.s_pad, sk.w2_source_pdfs(self.kg)),
                           _slots(w1t, fa.s_pad), _slots(w2t, fa.s_pad))
            self.d1, self.d2 = (d[:, None] for d in self.kg.diag)
        slices = torch.arange(fa.s_pad // fk.SLICE)
        self.own = [(slices[slices % C == r][:, None] * fk.SLICE
                     + torch.arange(fk.SLICE)).reshape(-1) for r in range(C)]
        self.n = [len(o) for o in self.own]
        assert sorted(torch.cat(self.own).tolist()) == list(range(fa.s_pad))
        assert max(self.n) == self.R
        s = torch.arange(fa.s_pad)
        self.owner = s // fk.SLICE % C
        self.local = s // fk.SLICE // C * fk.SLICE + s % fk.SLICE

    def at(self, V, states):
        """V (C, R, G) at the given states, each from its owner."""
        return V[self.owner[states], self.local[states]]

    def load(self, V, packed):
        packed = packed.long()
        return V[packed >> sk.LOCAL_BITS, packed & ((1 << sk.LOCAL_BITS) - 1)]

    def gather(self, W):
        """cluster_gather_cols: every CTA's copy takes each row from its
        owner."""
        for r in range(self.C):
            W[:, self.own[r]] = W[r, self.own[r]]

    def rank_sum(self, slots):
        """cluster_rank_sum: the CTAs' slots (C, NV) added in rank order."""
        total = torch.zeros(slots.shape[1:])
        for q in range(self.C):
            total = total + slots[q]
        return total

    def part(self, V):
        """A CTA's partial of the sum over its rows V (n, G): block_sum's
        tree in the fast mode (the order the plain fast version takes),
        else any order."""
        return block_sum(V) if self.fast else V.sum(0)


def _groups(lengths, B, G):
    """Each group of G columns: (b0, the columns' rows into (B, ...)
    arrays, clamped for columns past B, each column's length, 0 past B)."""
    for b0 in range(0, B, G):
        cols = [min(b0 + g, B - 1) for g in range(G)]
        Tb = [int(lengths[b0 + g]) if b0 + g < B else 0 for g in range(G)]
        yield b0, cols, Tb


def _emulate_fwd(px, lengths, fa, c, C, G, cl):
    """csrc/stream_fwd.cu: one group at a time, one CTA at a time between
    barriers."""
    kg = cl.kg
    B, T, P = px.shape
    s_pad = fa.s_pad
    f = kg.f_dst.long()
    g_src = None if kg.g_src is None else kg.g_src.long()
    w2_row, w2_col, w2_val = _entries(kg.w2)
    w2_pdf = sk.w2_source_pdfs(kg).long()
    leaky = fa.leaky[:, None]
    rnd = _bf if cl.fast else (lambda v: v)     # a stream entry's rounding
    s0 = fa.initial.sum()
    ad0 = fa.initial + c * s0 * fa.leaky
    nbuf = 2 if C > 1 else 1
    s_ys = torch.ones(B, T)
    ad_last = torch.zeros(B, s_pad)
    streams = torch.zeros(4, B, T, s_pad)   # ad, w1ad, xdst, xsrc
    for b0, cols, Tb in _groups(lengths, B, G):
        ad = ad0[None, :, None].repeat(C, 1, G)      # every CTA's copy
        A = torch.zeros(C, nbuf, cl.R, G)            # alpha on own rows
        slot = torch.zeros(C, 2, G)
        s_prev = s0.repeat(G)
        for t in range(max(Tb) + 1):
            if t > 0:
                par = (t - 1) % 2
                s_t = cl.rank_sum(slot[:, par])
                new = cl.at(A[:, par % nbuf], torch.arange(s_pad)) \
                    + c * s_t * leaky
                for g in range(G):
                    if t - 1 < Tb[g]:
                        streams[0, b0 + g, t - 1] = rnd(new[:, g])
                        s_ys[b0 + g, t - 1] = s_t[g]
                        s_prev[g] = s_t[g]
                    if t == Tb[g]:
                        ad_last[b0 + g] = new[:, g]
                if t == max(Tb):
                    break
                ad[:] = new
            px_t = px[cols, t].t()                     # (P, G)
            for r, own in enumerate(cl.own):
                if cl.fast:
                    al, w1a, x, xs = _fast_rows_fwd(cl, own, px_t, ad[r],
                                                    s_prev, f, g_src)
                else:
                    x = px_t[f[own]]
                    xs = x if g_src is None else px_t[g_src[own]]
                    w1a = _mv(kg.w1, ad[r])[own]
                    u = px_t[w2_pdf] * ad[r][w2_col]
                    w2u = torch.zeros(s_pad, G).index_add_(
                        0, w2_row, w2_val[:, None] * u)[own]
                    al = (x * w1a + w2u) / s_prev
                A[r, (t % 2) % nbuf, :cl.n[r]] = al
                for g in range(G):
                    if t < Tb[g]:
                        streams[1:, b0 + g, t, own] = torch.stack(
                            [rnd(w1a[:, g]), x[:, g], xs[:, g]])
                slot[r, t % 2] = cl.part(al)
    return streams, s_ys, ad_last, ad0, s0


def _fast_rows_fwd(cl, own, px_t, ad, s_prev, f, g_src):
    """stream_fwd_bf16 on one CTA's rows ``own``: px rounded as read, W1's
    off-diagonal gathers of the whole float32 alpha' copy ``ad`` rounded,
    W2's operand bfloat16(bfloat16(x_src) * alpha') at each entry's
    source, the float32 diagonals on the row's unrounded alpha', scaled by
    1 / s_{t-1}.  Returns (alpha, W1 alpha', x_dst, x_src) of the rows."""
    x = _bf(px_t[f[own]])
    xs = x if g_src is None else _bf(px_t[g_src[own]])
    a = ad[own]
    w1a = _row_dot(cl.tables[0], own, lambda k, c: _bf(ad[c])) \
        + cl.d1[own] * a
    pdfs = cl.tables[1][2][:, own]
    w2u = _row_dot(cl.tables[1], own,
                   lambda k, c: _bf(_bf(px_t[pdfs[k]]) * ad[c])) \
        + cl.d2[own] * (xs * a)
    return (x * w1a + w2u) * (1.0 / s_prev), w1a, x, xs


def _list_sums(lists, cl, V, acc):
    """Each pdf's masses (V: a CTA-local (C, R, G) vector, states packed)
    added in list order onto ``acc`` (n_lists, G): the gamma stage's
    sums."""
    ptr, states = (t.long() for t in lists)
    lens = ptr[1:] - ptr[:-1]
    acc = acc.clone()
    for k in range(int(lens.max())):
        has = lens > k
        acc[has] = acc[has] + cl.load(V, states[ptr[:-1][has] + k])
    return acc


def _emulate_bwd(lengths, fa, c, C, G, cl, streams, s_ys, ad0, s0, tot, P,
                 debug):
    """csrc/stream_bwd.cu: one group at a time, one CTA at a time between
    barriers; b and the carry in a by-state array every CTA reads."""
    kg = cl.kg
    B, T = s_ys.shape
    s_pad = fa.s_pad
    identity = kg.g_src is None
    w2t_row, w2t_col, w2t_val = _entries(kg.w2t)
    p_per = -(-P // C)
    owned = [(min(P, r * p_per), min(P, r * p_per + p_per))
             for r in range(C)]
    n_lists = min(P, kg.n_pdf_lists)

    def pdf_sums(lists, V):
        ptr, states = (t.long() for t in lists)
        pdf = torch.repeat_interleave(torch.arange(len(ptr) - 1),
                                      ptr[1:] - ptr[:-1])
        return torch.zeros(len(ptr) - 1, V.shape[2]).index_add_(
            0, pdf, cl.load(V, states))

    gamma = torch.zeros(B, T, P)
    ab = torch.full((B, T), 0.0 if debug else 1.0)
    gs = ab.clone()
    ad_ys, w1ad_ys, xdst_ys, xsrc_ys = streams
    for b0, cols, Tb in _groups(lengths, B, G):
        tot_g = torch.stack([tot[b0 + g] if b0 + g < B else torch.ones(())
                             for g in range(G)])
        c1, c2 = torch.zeros(C, cl.R, G), torch.zeros(C, cl.R, G)
        xb = torch.zeros(C, s_pad, G)
        # b and the beta' carry by state, in device memory
        bn, bd = torch.zeros(s_pad, G), torch.zeros(s_pad, G)
        slot_la, slot_gs = torch.zeros(C, 2 * G), torch.zeros(C, G)
        for r, own in enumerate(cl.own):
            bd[own] = fa.final[own][:, None] / tot_g
            slot_la[r, :G] = cl.part(bd[own] * fa.leaky[own][:, None])
        leak = cl.rank_sum(slot_la[:, :G])
        for u in range(max(Tb) - 1, -1, -1):
            active = torch.tensor([u < tb for tb in Tb])
            for r, own in enumerate(cl.own):
                bn[own] = bd[own] + c * leak
                xb[r, own] = xdst_ys[cols, u][:, own].t() * bn[own]
            # X1
            if u + 1 < max(Tb):
                s = cl.rank_sum(slot_gs)
                if cl.fast:        # the unscaled masses' sum, times 1 / s
                    s = s * (1.0 / s_ys[cols, u])
                for g in range(G):
                    if u + 1 < Tb[g]:
                        gs[b0 + g, u + 1] = s[g] if debug else 1.0
            cl.gather(xb)
            traces = debug or u == 0
            s_u = s0.repeat(G) if u == 0 else s_ys[cols, u - 1]
            for r, own in enumerate(cl.own):
                n = cl.n[r]
                xs = (xdst_ys if identity else xsrc_ys)[cols, u][:, own].t()
                adu = (ad0[own][:, None] if u == 0
                       else ad_ys[cols, u - 1][:, own].t())
                w1ad = w1ad_ys[cols, u][:, own].t()
                if cl.fast:
                    # the off-diagonal gathers rounded, the float32
                    # diagonals on the row's unrounded xb and b; masses
                    # unscaled, rounded
                    inv = 1.0 / s_u
                    w1t = _row_dot(cl.tables[2], own,
                                   lambda k, c: _bf(xb[r][c])) \
                        + cl.d1[own] * xb[r, own]
                    w2t = _row_dot(cl.tables[3], own,
                                   lambda k, c: _bf(bn[c])) \
                        + cl.d2[own] * bn[own]
                    sw = xs * w2t
                    bdt = (w1t + sw) * inv
                    m1, m2 = xb[r, own] * w1ad, sw * adu
                    c1[r, :n] = _bf(m1 + m2) if identity else _bf(m1)
                    c2[r, :n] = _bf(m2)
                else:
                    w1t = _mv(kg.w1t, xb[r])[own]
                    w2t = torch.zeros(s_pad, G).index_add_(
                        0, w2t_row, w2t_val[:, None] * bn[w2t_col])[own]
                    sw = xs * w2t
                    bdt = (w1t + sw) / s_u
                    m1 = xb[r, own] * w1ad / s_u
                    m2 = sw * adu / s_u
                    c1[r, :n] = m1 + m2 if identity else m1
                    c2[r, :n] = m2
                bd[own] = torch.where(active, bdt, bd[own])
                slot_la[r, :G] = cl.part(bdt * fa.leaky[own][:, None])
                slot_la[r, G:] = cl.part(adu * bdt) if traces else 0.0
            # X2
            tot2 = cl.rank_sum(slot_la)
            leak = torch.where(active, tot2[:G], leak)
            gp = torch.zeros(P, G)
            if cl.fast:        # each pdf's list in order, then E_g's
                acc = torch.zeros(kg.n_pdf_lists, G)
                acc = _list_sums(kg.f_lists, cl, c1, acc)
                if not identity:
                    acc = _list_sums(kg.g_lists, cl, c2, acc)
                gp[:n_lists] = acc[:n_lists]
            else:
                gp[:n_lists] = pdf_sums(kg.f_lists, c1)[:n_lists]
                if not identity:
                    gp[:n_lists] += pdf_sums(kg.g_lists, c2)[:n_lists]
            for g in range(G):
                if u < Tb[g]:
                    ab[b0 + g, u] = tot2[G + g] if traces else 1.0
                    gamma[b0 + g, u] = (_bf(gp[:, g] * (1.0 / s_u[g]))
                                        if cl.fast else gp[:, g])
            for r, (p0, p1) in enumerate(owned):
                slot_gs[r] = cl.part(gp[p0:p1]) if traces else 0.0
        s = cl.rank_sum(slot_gs)
        if cl.fast:
            s = s * (1.0 / s0)
        for g in range(G):
            if b0 + g < B:
                gs[b0 + g, 0] = s[g]
    return gamma, ab, gs


def _emulate_cluster(px, lengths, fa, c, C, G, debug):
    cl = _Cluster(fa, C)
    streams, s_ys, ad_last, ad0, s0 = _emulate_fwd(px, lengths, fa, c, C,
                                                   G, cl)
    objf, tot = fk._objf(s_ys, ad_last, lengths, fa, s0.reshape(1))
    gamma, ab, gs = _emulate_bwd(lengths, fa, c, C, G, cl, streams, s_ys,
                                 ad0, s0, tot, px.shape[2], debug)
    return objf, gamma, ab, gs


@pytest.mark.parametrize("G", sk.COLUMNS)
@pytest.mark.parametrize("C", sk.CLUSTERS)
@pytest.mark.parametrize("mode,want", MODES)
def test_cluster_emulation_matches_plain(mode, want, C, G):
    fa, px, lens = _case(mode)
    assert fa.xsrc_mode == want
    assert all(sk.fits(fa, k, C, G) for k in sk.LAUNCHES)
    _check_emulation(fa, px, lens, C, G, debug=C % 2 == 1 or G == 2)


@pytest.mark.parametrize("G", sk.COLUMNS)
def test_cluster_emulation_with_idle_ranks(G):
    fa, px, lens = _case("separate", num_phones=10)
    assert fa.s_pad == 128        # 4 slices: ranks 4-7 of 8 own no rows
    _check_emulation(fa, px, lens, 8, G, debug=True)


def _check_emulation(fa, px, lens, C, G, debug):
    ref = forward_backward_prob_fact(px, lens, fa, LEAKY)
    if not debug:
        ref = fk._frame0_traces(ref)
    objf, gamma, ab, gs = _emulate_cluster(px, lens, fa, LEAKY, C, G,
                                           debug=debug)
    torch.testing.assert_close(objf, ref.objf, rtol=1e-5, atol=0)
    torch.testing.assert_close(gamma, ref.gamma, rtol=0, atol=1e-5)
    torch.testing.assert_close(ab, ref.alpha_beta, rtol=0, atol=1e-5)
    torch.testing.assert_close(gs, ref.gamma_sum, rtol=0, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _fast_case(mode, num_phones=150):
    fa, px, lens = _case(mode, num_phones=num_phones, tile_dtype="bfloat16")
    return fa, px, lens, {}


def _fast_plain(mode, C, debug, num_phones=150):
    """The plain fast version with cluster=C on the fast case, once."""
    fa, px, lens, memo = _fast_case(mode, num_phones)
    if (C, debug) not in memo:
        ref = forward_backward_prob_fast(px, lens, fa, LEAKY, cluster=C)
        memo[C, debug] = ref if debug else fk._frame0_traces(ref)
    return memo[C, debug]


def _check_fast_emulation(mode, C, G, debug, num_phones=150):
    fa, px, lens, _ = _fast_case(mode, num_phones)
    assert is_fast(fa)
    ref = _fast_plain(mode, C, debug, num_phones)
    got = _emulate_cluster(px, lens, fa, LEAKY, C, G, debug=debug)
    for name, g in zip(("objf", "gamma", "alpha_beta", "gamma_sum"), got):
        assert torch.equal(g, getattr(ref, name)), name
    assert torch.equal(_bf(got[1]), got[1])


@pytest.mark.parametrize("G", sk.COLUMNS)
@pytest.mark.parametrize("C", sk.CLUSTERS)
@pytest.mark.parametrize("mode,want", MODES)
def test_fast_cluster_emulation_equals_plain(mode, want, C, G):
    """stream_fwd_bf16 / stream_bwd_bf16 emulated CTA by CTA equal the
    plain fast version with cluster=C bit for bit, at every G (B = 5
    columns of unequal lengths)."""
    assert _fast_case(mode)[0].xsrc_mode == want
    _check_fast_emulation(mode, C, G, debug=C % 2 == 1 or G == 2)


@pytest.mark.parametrize("G", sk.COLUMNS)
def test_fast_cluster_emulation_with_idle_ranks(G):
    fa = _fast_case("separate", 10)[0]
    assert fa.s_pad == 128        # 4 slices: ranks 4-7 of 8 own no rows
    _check_fast_emulation("separate", 8, G, debug=True, num_phones=10)


def test_cluster_graph_packs_the_pdf_lists():
    """Packed ids name each state's owner and local row; the sparse rows
    are B1/B2's own; E_g^T's lists hold only states with a W2 out-arc."""
    fa, _, _ = _case("separate")
    kg = fk.kernel_graph(fa)
    w2_src = set(fk._coo(fa.w2)[1].tolist())
    assert set(kg.g_lists[1].tolist()) == w2_src
    assert len(w2_src) < fa.s_pad
    for C in sk.CLUSTERS:
        ckg = sk.cluster_graph(kg, C)
        assert ckg.w1 is kg.w1 and ckg.w2t is kg.w2t
        packed = ckg.f_lists[1].long()
        owner = packed >> sk.LOCAL_BITS
        local = packed & ((1 << sk.LOCAL_BITS) - 1)
        state = ((local // fk.SLICE) * C + owner) * fk.SLICE \
            + local % fk.SLICE
        assert torch.equal(state, kg.f_lists[1].long())
        assert int(owner.max()) < C
        assert int(local.max()) < sk.rows_per_cta(fa.s_pad, C)


def test_cpu_wrapper_takes_plain_path_without_launching():
    fa, px, lens = _case("cross")
    sk.reset_launch_counts()
    got = sk.forward_backward_prob_stream(px, lens, fa, LEAKY, debug=False)
    assert sk.LAUNCHES == {"stream_fwd": 0, "stream_bwd": 0,
                           "stream_fwd_bf16": 0, "stream_bwd_bf16": 0}
    ref = fk._frame0_traces(forward_backward_prob_fact(px, lens, fa, LEAKY))
    for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=0)


# ----------------------------------------------------------------------
# Tiering and budgets
# ----------------------------------------------------------------------

def test_dispatch_tiering(monkeypatch):
    """pychain_tpu's test_dispatch_tiering with the port's functions: past
    the resident kernels the cluster tier, past the cluster limit
    NotImplementedError on CUDA (the plain version on the CPU); _run takes
    the tier at each call, from the graph's own arrays."""
    fa, px, lens = _case("source")
    on_card = types.SimpleNamespace(device=torch.device("cuda"),
                                    res_src=fa.res_src, s_pad=fa.s_pad,
                                    xsrc_mode=fa.xsrc_mode)
    taken = []

    def spy(tag, fn):
        def run(*args, **kwargs):
            taken.append(tag)
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(fk, "forward_backward_prob_kernel",
                        spy("pallas", fk.forward_backward_prob_kernel))
    monkeypatch.setattr(sk, "forward_backward_prob_stream",
                        spy("stream", sk.forward_backward_prob_stream))

    def engine(g, impl="auto"):
        taken.clear()
        pt_loss._run(torch.log(px), lens, pt_loss.dispatch_arrays(g, impl),
                     LEAKY, impl)
        return taken[0] if taken else "xla"

    assert pt_loss.den_engine(fa) == "pallas"
    assert engine(fa) == "pallas" and engine(fa, "factorized") == "xla"
    monkeypatch.setattr(fk, "fits_on_chip", lambda *a, **k: False)
    assert pt_loss.den_engine(on_card) == "stream"
    assert pt_loss.dispatch_arrays(fa, "pallas") is fa
    assert engine(fa, "pallas") == "stream"
    monkeypatch.setattr(sk, "fits_stream", lambda *a, **k: False)
    with pytest.raises(NotImplementedError, match="cluster of 8 CTAs"):
        pt_loss.den_engine(on_card)
    assert pt_loss.den_engine(fa) == "xla" and engine(fa) == "xla"
    # an explicit engine is honoured; impl="factorized" is the plain one
    for forced in ("stream", "pallas"):
        g = dataclasses.replace(fa, engine=forced)
        assert pt_loss.dispatch_arrays(g) is g
        assert engine(g) == forced and engine(g, "factorized") == "xla"


# An H100 SXM as torch.cuda.get_device_properties reports it (the fields
# plan() reads).
H100 = types.SimpleNamespace(
    multi_processor_count=132, shared_memory_per_block_optin=232448,
    shared_memory_per_multiprocessor=233472,
    max_threads_per_multi_processor=2048, regs_per_multiprocessor=65536)


def _shape(s_pad, xsrc_mode):
    """A graph's sizes alone, as the tiering and the plan read them."""
    return types.SimpleNamespace(s_pad=s_pad, xsrc_mode=xsrc_mode,
                                 res_src=torch.zeros(0))


MAIN4 = _shape(12032, "stream")
S8K = _shape(8064, "identity")
HEADLINE = _shape(3072, "identity")


def test_tiers_of_the_repo_graphs_by_arithmetic():
    """Main path 4's graph (denominator_fst(6000, 2, num_pdfs=3000,
    bigram_fanout=30, forward_pdf_mode="separate"): S = 12,000, S_pad =
    12,032, x_src "stream") is past the resident kernels and on the
    cluster tier; bench.py --s8k's (S = 8,000 "source", S_pad = 8,064)
    fits them.  The cluster tier ends where no C fits one column a CTA:
    at C = 8 past S_pad 46,368 (x_src "stream": stream_bwd's limit; 46,400
    in identity mode: stream_fwd's)."""
    assert fk.smem_bytes(MAIN4) == {"fact_fwd": 192644, "fact_bwd": 241036}
    assert not fk.fits_on_chip(MAIN4) and sk.fits_stream(MAIN4)
    assert fk.fits_on_chip(S8K)
    edge = lambda s_pad: _shape(s_pad, "stream")
    assert sk.fits_stream(edge(46368)) and not sk.fits_stream(edge(46400))
    assert not sk.fits(edge(46400), "stream_bwd", 8, 1)
    assert sk.fits(edge(46400), "stream_fwd", 8, 1)
    assert sk.fits_stream(_shape(46400, "identity"))
    assert not sk.fits(_shape(46432, "identity"), "stream_fwd", 8, 1)
    assert sk.fits(_shape(46432, "identity"), "stream_bwd", 8, 1)


@pytest.mark.parametrize("C,G", [(1, 1), (2, 1), (2, 2), (4, 2), (8, 4)])
def test_smem_formulas_by_arithmetic(C, G):
    """The per-CTA shared memory at main path 4: stream_fwd keeps alpha'
    whole and alpha on its rows (two buffers by parity when C > 1),
    stream_bwd x_dst * b whole and c1, c2 on its rows (no c2 in identity
    mode; b and the beta' carry live in device memory), each for G
    columns, plus the reductions' scratch."""
    R = sk.rows_per_cta(12032, C)
    assert R == 12032 // C
    nbuf = 1 if C == 1 else 2
    got = sk.smem_bytes(MAIN4, C, G)
    assert got == {"stream_fwd": 4 * G * (12032 + nbuf * R + 32 + 3),
                   "stream_bwd": 4 * G * (12032 + 2 * R + 64 + 5)}
    ident = sk.smem_bytes(S8K, C, G)["stream_bwd"]
    assert ident == 4 * G * (8064 + sk.rows_per_cta(8064, C) + 64 + 5)
    for name, size in got.items():
        assert sk.fits(MAIN4, name, C, G) == (size <= fk.MAX_SMEM)


@pytest.mark.parametrize("graph,B,fwd,bwd", [
    (MAIN4, 128, (2, 2, 128, 1), (2, 2, 128, 1)),
    (S8K, 64, (2, 1, 128, 1), (2, 1, 128, 1)),
    (HEADLINE, 128, (2, 2, 128, 1), (2, 2, 128, 1))])
def test_plan_rule_on_the_repo_shapes(graph, B, fwd, bwd):
    """plan() on an H100: one 1024-thread CTA an SM (64 registers a
    thread), so each plan's cost is waves x the busiest SM's work a frame,
    R (G + GRAPH_ROW) for its rows plus COPY_FLOAT a float copied from its
    peers; (C, G, CTAs, waves) of the cheapest, ties to the smaller C,
    then the larger G."""
    got = sk.plan(graph, B, H100)
    for name, want in (("stream_fwd", fwd), ("stream_bwd", bwd)):
        p = got[name]
        assert (p.cluster, p.columns, p.ctas, p.waves) == want, name
        assert p.ctas_per_sm == 1 and p.threads == 1024
        assert p.smem == sk.smem_bytes(graph, p.cluster, p.columns)[name]
        for q in sk.candidates(graph, name, B, H100):
            assert (p.cost, p.cluster, -p.columns) <= \
                (q.cost, q.cluster, -q.columns)


def test_plan_cost_by_hand():
    """Main path 4's stream_fwd at C = 2, G = 2: 128 CTAs of 6,016 rows,
    one wave, a frame (6,016 x 3 + 0.25 x 12,032 x 2 / 2) = 21,056; at
    C = 2, G = 1 two waves of 256 CTAs, 2 x (6,016 x 2 + 1,504)."""
    fwd = functools.partial(sk.plan_kernel, MAIN4, "stream_fwd")
    p = fwd(128, H100, cluster=2, columns=2)
    assert p.cost == 6016 * 3 + 0.25 * 12032 * 2 / 2 == 21056
    q = fwd(128, H100, cluster=2, columns=1)
    assert q.waves == 2 and q.cost == 2 * (6016 * 2 + 1504)
    # B not a multiple of G: the last cluster serves fewer columns
    assert fwd(5, H100, cluster=4, columns=2).ctas == 12


def test_card_budget_admits_full_mode(monkeypatch):
    """The S = 10,000 separate-pdf graph (S_pad 10,112) at B = 128,
    T = 500 keeps four float32 streams of 2.59 GB (10.4 GB): "full" under
    an 80 GB card's budget (40%, stream_budget), not under the JAX
    package's fixed 4 GiB, and the wrappers raise past the budget."""
    budget = int(80e9 * 0.40)
    assert 4 * 500 * 10112 * 128 * 4 == 10_354_688_000
    assert fk.select_stream_mode(500, 10112, 128, 4, 4, budget) == "full"
    assert fk.select_stream_mode(500, 10112, 128, 4, 4) == "lean"
    fa = types.SimpleNamespace(s_pad=10112, xsrc_mode="stream")
    fk.require_full_mode(500, fa, 128, budget)
    with pytest.raises(NotImplementedError, match="'lean'"):
        fk.require_full_mode(500, fa, 128, fk.STREAM_BUDGET)
    with pytest.raises(NotImplementedError, match="'ckpt'"):
        fk.require_full_mode(3700, fa, 128, fk.STREAM_BUDGET)
    card = types.SimpleNamespace(total_memory=80 * 10 ** 9)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: card)
    assert fk.stream_budget("cuda") == budget
    with pytest.raises(ValueError, match="no CUDA device"):
        fk.stream_budget("cpu")


def test_forced_cluster_size_past_the_limit_raises():
    """cluster= / columns= restrict the plan; a (C, G) that does not fit
    the card, or is not compiled, raises."""
    with pytest.raises(NotImplementedError, match="cluster 3"):
        sk.plan(MAIN4, 128, H100, cluster=3)
    with pytest.raises(NotImplementedError, match="stream_fwd"):
        sk.plan(MAIN4, 128, H100, cluster=1, columns=4)   # 385,584 bytes
    with pytest.raises(NotImplementedError, match="columns 3"):
        sk.plan(MAIN4, 128, H100, columns=3)
    p = sk.plan(MAIN4, 128, H100, cluster=8)
    assert p["stream_fwd"].cluster == p["stream_bwd"].cluster == 8
    fa, _, _ = _case("separate")
    assert sk.plan(fa, 5, H100, cluster=1, columns=4)[
        "stream_bwd"].columns == 4
