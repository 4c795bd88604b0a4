"""The fast pair's group form (fact_fwd_bf16, fact_bwd_bf16), on the CPU.

Past the cluster forms' reach (B 2 > the card's SMs: B > 66 on an H100)
``fact_kernels.group_size`` runs the fast mode's full-stream pair as a
group of G columns on a cluster of C CTAs (``cluster=(G, C)``): each
CTA holds its rows of the two operators it reads in shared memory for the
whole launch, packed 4 bytes a slot (``fact_kernels.pack_slots``), and
one load of a slot feeds the G columns' products (csrc/fact_fwd.cu and
csrc/fact_bwd.cu, ``fact_*_group_kernel``).

Within that reach (B 2 <= the SMs) both run their group form at G = 1,
one column on a cluster of 2 CTAs (``cluster=(1, 2)``), each packed
vector a word a state.

The CUDA kernels cannot run here.  ``_emu_group_fwd`` / ``_emu_group_bwd``
emulate them CTA by CTA on the arrays they read, put in place of the
launches (``fact_kernels._fwd_group_launch``, ``_bwd_group_launch``):
each CTA's slots copied through its local slice pointers from the packed
words and unpacked as the kernels unpack them, the G columns of a group
side by side with each column's own length (a column past its end, or
past B, runs on and is never written), the vectors the products gather
assembled from every CTA's rows after rounding to bfloat16 and packed as
the kernels pack them (``_packed``: G / 2 words a state, one at G = 1),
beta'(T_b)
injected at each column's own last frame, and every sum taken as the
kernels take it (each row's slots in order; the virtual threads' rows and
pdfs, the warp trees, the cross-warp tree: ``_cluster_total``).  The
results must equal the plain fast version (``forward_backward_prob_fast``)
under ``torch.equal``, as the card tests hold the kernels themselves to it
(tests/test_torch_card.py).  The plan rule and the shared-memory formula
are checked by arithmetic on a stubbed H100 at the headline graph, at
bench.py --s8k's and at main path 4's shape.
"""

import numpy as np
import pytest
import torch

import pychain_tpu_torch as pt
from pychain_tpu_torch.ops import factorized as pf
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.utils.testgraphs import denominator_fst

from test_torch_stream_modes import (H100, LEAKY, _assert_equal,
                                     _cluster_total, _emu_bwd, _emu_fwd,
                                     _shape, _split)


def _case(fwd_mode, num_phones=10, seed=6, B=5, T=12,
          lengths=(12, 8, 4, 1, 9)):
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=fwd_mode)
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), B, tile_dtype="bfloat16",
                            device="cpu")._fact
    rng = np.random.RandomState(seed + 11)
    px = torch.exp(torch.from_numpy(rng.randn(B, T, P).astype(np.float32)))
    return fa, px, torch.tensor(lengths, dtype=torch.int32)


def _cta_tables(kg, which, C):
    """Each CTA's shared-memory copy of operator ``which`` (B1/B2's
    order: w1, w2, w1t, w2t) as group_load_ops lays it out: the CTA's
    slices k = r (mod C) one after another (local slice pointers from the
    slice lengths), read back from the packed words by local row i as
    group_row_dot reads them (slot_col, slot_val).  Returns per CTA (rows
    (own,): the states cluster_row(i), cols and vals (K, own), live (K,
    own): whether slot k is one of the row's slice's)."""
    sptr = kg.resident[which][0].long()
    words = kg.packed[which]
    slices = len(sptr) - 1
    out = []
    for r in range(C):
        mine = list(range(r, slices, C))
        lp = np.concatenate([[0], np.cumsum(
            [int(sptr[k + 1] - sptr[k]) for k in mine])]).astype(np.int64)
        smem = (torch.cat([words[int(sptr[k]) * 32:int(sptr[k + 1]) * 32]
                           for k in mine]) if mine
                else torch.zeros(0, dtype=torch.int32))
        own = 32 * len(mine)
        K = int(np.diff(lp).max()) if mine else 0
        table = torch.zeros((K, own), dtype=torch.int32)
        live = torch.zeros((K, own), dtype=torch.bool)
        for j in range(len(mine)):
            n = int(lp[j + 1] - lp[j])
            table[:n, 32 * j:32 * j + 32] = smem[
                int(lp[j]) * 32:int(lp[j + 1]) * 32].view(n, 32)
            live[:n, 32 * j:32 * j + 32] = True
        cols, vals = fk.unpack_slots(table)
        i = torch.arange(own)
        rows = ((i >> 5) * C + r) * 32 + (i & 31)
        out.append((rows, cols.long(), vals, live))
    return out


def _dot(table, v):
    """group_row_dot of a CTA's rows: each row's slots of its slice in
    order, one rounding a slot (the product of two bfloat16 values is
    exact), G columns of v (S_pad, G) at once.  Returns (own, G)."""
    _, cols, vals, live = table
    acc = torch.zeros((cols.shape[1], v.shape[1]))
    for k in range(cols.shape[0]):
        acc = torch.where(live[k][:, None],
                          acc + v[cols[k]] * vals[k][:, None], acc)
    return acc


def _total(parts, rows_of, n, C):
    """The cluster's sum of one column: CTA r's terms on its rows."""
    whole = torch.full((n,), float("nan"))
    for part, rows in zip(parts, rows_of):
        whole[rows] = part
    return _cluster_total(_split(whole, C), C)


def _whole(parts, rows_of, n, G):
    """A whole vector (n, G) from each CTA's rows (the exchange), every
    row from one CTA."""
    out = torch.zeros((n, G))
    seen = torch.zeros(n, dtype=torch.int64)
    for part, rows in zip(parts, rows_of):
        out[rows] = part
        seen[rows] += 1
    assert bool((seen == 1).all())
    return out


def _packed(v):
    """A vector (n, G) of bfloat16 values through the group form's packed
    words and back (pack_cols / load_packed in csrc/fact_common.cuh): at
    G = 1 a word a state, the value's float32 bits; else G / 2 words a
    state, column 2j in the low half of word j, 2j + 1 in the high half.
    The words must hold the values exactly."""
    G = v.shape[1]
    bits = v.contiguous().view(torch.int32)
    if G == 1:
        words = bits.clone()
        back = words.view(torch.float32)
    else:
        lo, hi = bits[:, 0::2], bits[:, 1::2]
        words = ((lo >> 16) & 0xffff) | (hi & -65536)
        back = torch.stack([words << 16, words & -65536], 2).reshape(
            v.shape).view(torch.float32)
    assert words.shape == (v.shape[0], fk._packed_words(G))
    assert torch.equal(back, v), "not bfloat16 values"
    return back


def _groups(B, G, lengths):
    """Each cluster's columns and lengths (0 past B)."""
    for q in range(-(-B // G)):
        cols = [q * G + g for g in range(G)]
        yield cols, [int(lengths[b]) if b < B else 0 for b in cols]


def _emu_group_fwd(px, lengths, fa, c, outs, s_ys, ad_last, group,
                   smid=None):
    """fact_fwd_group_kernel in place of fact_kernels._fwd_group_launch,
    one cluster (G columns) at a time, each CTA's rows apart."""
    assert group in fk.FORM_GROUPS["fact_fwd"] and smid is None
    fk.LAUNCHES["fact_fwd_bf16"] += 1
    G, C = group
    kg = fk.graph_for(fa)
    tabs = [_cta_tables(kg, k, C) for k in (0, 1)]
    rows_of = [t[0] for t in tabs[0]]
    f = kg.f_dst.long()
    g_src = None if kg.g_src is None else kg.g_src.long()
    d1, d2 = kg.diag
    B, T, _ = px.shape
    n = fa.s_pad
    ad0, s0 = pf.initial_alpha(fa, c)
    bf = pf._bf
    for cols, Tb in _groups(B, G, lengths):
        t_end = max(Tb)
        xd = torch.zeros((n, G))
        xs = torch.zeros((n, G))

        def gather(t):
            for g, b in enumerate(cols):
                if t < Tb[g]:
                    xd[:, g] = bf(px[b, t, f])
                    xs[:, g] = xd[:, g] if g_src is None else bf(
                        px[b, t, g_src])
                    outs[2][b, t] = xd[:, g]
                    if outs[3] is not None:
                        outs[3][b, t] = xs[:, g]

        a = ad0[:, None].expand(n, G).clone()
        ad = _packed(bf(a))
        gather(0)
        u = _packed(bf(xs * a))
        s_prev = s0.expand(G).clone()
        for t in range(t_end):
            r = 1.0 / s_prev
            parts = []
            for k, rows in enumerate(rows_of):
                own_a = a[rows]
                v1 = _dot(tabs[0][k], ad) + d1[rows, None] * own_a
                v2 = _dot(tabs[1][k], u) + d2[rows, None] * (xs[rows]
                                                              * own_a)
                parts.append((xd[rows] * v1 + v2) * r)
                for g, b in enumerate(cols):
                    if t < Tb[g]:
                        outs[1][b, t, rows] = v1[:, g].to(outs[1].dtype)
            a = _whole(parts, rows_of, n, G)
            # a column past its end runs on in the kernel; nothing reads it
            s_t = torch.stack([_total([p[:, g] for p in parts], rows_of, n,
                                      C) if t < Tb[g] else s_prev[g]
                               for g in range(G)])
            if t + 1 < t_end:
                gather(t + 1)
            v = a + (c * s_t)[None, :] * fa.leaky[:, None]
            for g, b in enumerate(cols):
                if t < Tb[g]:
                    outs[0][b, t] = v[:, g]
                    s_ys[b, t] = s_t[g]
                    if t == Tb[g] - 1:
                        ad_last[b] = v[:, g]
            a, ad, u, s_prev = v, _packed(bf(v)), _packed(bf(xs * v)), s_t
        for g, b in enumerate(cols):
            if b < B:
                s_ys[b, Tb[g]:] = 1.0
    return ad0, s0


def _emu_group_bwd(lengths, fa, c, streams, s_ys, ad0, s0, tot_prob, outs,
                   debug, group, smid=None):
    """fact_bwd_group_kernel in place of fact_kernels._bwd_group_launch,
    one cluster at a time, each CTA's rows (and pdfs) apart."""
    assert group in fk.FORM_GROUPS["fact_bwd"] and smid is None
    fk.LAUNCHES["fact_bwd_bf16"] += 1
    G, C = group
    kg = fk.graph_for(fa)
    tabs = [_cta_tables(kg, k, C) for k in (2, 3)]
    rows_of = [t[0] for t in tabs[0]]
    d1, d2 = kg.diag
    lists = [pf._list_table(kg.group_lists, fa.s_pad)]
    if kg.g_lists is not None:
        lists.append(pf._list_table(kg.g_lists, fa.s_pad))
    identity = kg.g_src is None
    gamma, ab, gs = outs
    B, T = s_ys.shape
    P = gamma.shape[2]
    n = fa.s_pad
    bf = pf._bf
    pdf_rows = [torch.nonzero((torch.arange(P) >> 5) % C == r)[:, 0]
                for r in range(C)]
    for cols, Tb in _groups(B, G, lengths):
        for g, b in enumerate(cols):
            if b < B:
                gamma[b, Tb[g]:] = 0.0
                ab[b, Tb[g]:] = gs[b, Tb[g]:] = 0.0 if debug else 1.0
        t_hi = max(Tb)
        if t_hi == 0:
            continue
        tot_b = torch.stack([tot_prob[b] if b < B else torch.tensor(1.0)
                             for b in cols])
        inj = torch.stack([_total([(fa.final[R] / tot_b[g]) * fa.leaky[R]
                                   for R in rows_of], rows_of, n, C)
                           for g in range(G)])
        bd = torch.zeros((n, G))
        xo, wo, ao, so = (torch.zeros((n, G)) for _ in range(4))
        leak = torch.zeros(G)
        for u in range(t_hi - 1, -1, -1):
            traces = debug or u == 0
            inv = torch.stack([1.0 / (s0[0] if u == 0 else s_ys[b, u - 1]
                                      if b < B else torch.tensor(1.0))
                               for b in cols])
            for g, b in enumerate(cols):
                if u == Tb[g] - 1:
                    leak[g] = inj[g]
                    bd[:, g] = fa.final / tot_b[g]
                if u < Tb[g]:
                    xo[:, g] = streams[2][b, u].float()
                    wo[:, g] = streams[1][b, u].float()
                    ao[:, g] = (streams[0][b, u - 1].float() if u > 0
                                else ad0)
                    so[:, g] = xo[:, g] if identity else \
                        streams[3][b, u].float()
            cl = c * leak
            v = bd + cl[None, :]
            bn, xb = _packed(bf(v)), _packed(bf(xo * v))   # exchanged
            parts = {"bd": [], "m1": [], "m2": []}
            for k, R in enumerate(rows_of):
                xbs = xo[R] * v[R]
                t1 = _dot(tabs[0][k], xb) + d1[R, None] * xbs
                t2 = _dot(tabs[1][k], bn) + d2[R, None] * v[R]
                sw = so[R] * t2
                parts["bd"].append((t1 + sw) * inv)
                m1, m2 = xbs * wo[R], sw * ao[R]
                if identity:
                    parts["m1"].append(bf(m1 + m2))
                else:
                    parts["m1"].append(bf(m1))
                    parts["m2"].append(bf(m2))
            bd = _whole(parts["bd"], rows_of, n, G)
            c1 = _whole(parts["m1"], rows_of, n, G)
            acc = pf._list_sums(lists[0], c1)
            if not identity:
                acc = pf._list_sums(lists[1], _whole(parts["m2"], rows_of,
                                                     n, G), acc)
            acc = torch.nn.functional.pad(acc[:P], (0, 0, 0, P - min(
                P, acc.shape[0])))
            for g, b in enumerate(cols):
                if u >= Tb[g]:
                    continue         # runs on in the kernel; nothing reads it
                col = lambda x: [x[R, g] for R in rows_of]
                leak[g] = _total(col(bd * fa.leaky[:, None]), rows_of, n, C)
                gamma[b, u] = bf(acc[:, g] * inv[g])
                if traces:
                    ab[b, u] = _total(col(ao * bd), rows_of, n, C)
                    gs[b, u] = _total([acc[R, g] for R in pdf_rows],
                                      pdf_rows, P, C) * inv[g]
                else:
                    ab[b, u] = gs[b, u] = 1.0
    return outs


def _emulate(monkeypatch):
    """The group form's emulations (and the one-block form's,
    tests/test_torch_stream_modes.py) in place of the launches on a
    stubbed H100."""
    monkeypatch.setattr(fk, "_fwd_group_launch", _emu_group_fwd)
    monkeypatch.setattr(fk, "_bwd_group_launch", _emu_group_bwd)
    monkeypatch.setattr(fk, "_fwd_launch", _emu_fwd)
    monkeypatch.setattr(fk, "_bwd_launch", _emu_bwd)
    monkeypatch.setattr(fk, "_card_props", lambda device: H100)


def _full(fa, px, lens, cluster, debug=True):
    """The full mode's card path (fact_fwd, the objective, fact_bwd) at
    ``cluster``.  Returns (result, the four streams)."""
    P = px.shape[2]
    ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = fk.fact_fwd(
        px, lens, fa, LEAKY, cluster=cluster)
    objf, tot = fk._objf(s_ys, ad_last, lens, fa, s0)
    outs = fk.fact_bwd(lens, fa, LEAKY, ad_ys, w1ad, xdst, xsrc, s_ys, ad0,
                       s0, tot, P, debug, cluster=cluster)
    return fk._package_result(objf, *outs), (ad_ys, w1ad, xdst, xsrc)


def _streams_equal(got, ref, lens):
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        for col, Tb in enumerate(lens.tolist()):
            if a is not None:
                assert torch.equal(a[col, :Tb], b[col, :Tb])


@pytest.mark.parametrize("group", fk.GROUPS)
@pytest.mark.parametrize("fwd_mode,want", [("source", "identity"),
                                           ("separate", "stream"),
                                           ("cross", "matrix")])
def test_group_form_gives_the_plain_fast_versions_bits(monkeypatch, group,
                                                       fwd_mode, want):
    """fact_fwd and fact_bwd as groups of G columns on C CTAs (each (G,
    C) of GROUPS), B = 5 columns (not a multiple of G: the last cluster
    has idle columns) of lengths 12, 8, 4, 1, 9, debug True and False:
    the plain fast version's objf, gamma and traces under torch.equal,
    and the one-block form's streams; one launch of each fast kernel."""
    fa, px, lens = _case(fwd_mode)
    assert fa.xsrc_mode == want
    _emulate(monkeypatch)
    plain = pf.forward_backward_prob_fast(px, lens, fa, LEAKY)
    _, one = _full(fa, px, lens, 1)
    for debug in (True, False):
        fk.reset_launch_counts()
        got, streams = _full(fa, px, lens, group, debug)
        assert fk.launched() == {"fact_fwd_bf16": 1, "fact_bwd_bf16": 1}
        _assert_equal(got, plain if debug else fk._frame0_traces(plain))
        _streams_equal(streams, one, lens)


@pytest.mark.parametrize("group", [(2, 2), (4, 4)])
def test_group_form_past_1024_states(monkeypatch, group):
    """S_pad 1,280 and P past 1,024 (a virtual thread with two rows and
    two pdfs; five slices a CTA at C = 4, so the CTAs hold slot counts
    that differ), three columns of lengths 4, 3, 2: the plain fast
    version's bits."""
    fa, px, lens = _case("source", num_phones=600, seed=3, B=3, T=4,
                         lengths=(4, 3, 2))
    assert fa.s_pad > 1024 and px.shape[2] > 1024
    _emulate(monkeypatch)
    got, _ = _full(fa, px, lens, group)
    _assert_equal(got, pf.forward_backward_prob_fast(px, lens, fa, LEAKY))


def test_the_plan_reaches_the_group_form_on_a_call(monkeypatch):
    """forward_backward_prob_kernel's full mode takes each form's plan
    (fact_kernels._mode_cluster): at B = 67 on an H100 past 1,024 states,
    with the operator-size rule stubbed to take any operator (this
    graph's are far below it, which keeps one block a column), fact_fwd
    and fact_bwd run as groups at (2, 2) and the lean and ckpt forms keep
    one block a column; at B = 66 both run one column a cluster, (1, 2);
    a forced (G, C) reaches both launches; the results are the plain fast
    version's."""
    fa, px, lens = _case("source", num_phones=600, seed=3, B=67, T=3,
                         lengths=[3 - k % 3 for k in range(67)])
    assert fa.s_pad > 1024
    _emulate(monkeypatch)
    assert set(fk._mode_cluster("full", px, fa, None).values()) == {1}
    monkeypatch.setattr(fk, "GROUP_MIN_OPERATOR_BYTES",
                        {"fact_fwd": 0, "fact_bwd": 0})
    monkeypatch.setattr(fk, "GROUP_ONE_MIN_OPERATOR_BYTES",
                        {"fact_fwd": 0, "fact_bwd": 0})
    plan = fk._mode_cluster("full", px, fa, None)
    assert plan == {"fact_fwd": (2, 2), "fact_bwd": (2, 2)}
    assert set(fk._mode_cluster("lean", px, fa, None).values()) == {1}
    assert set(fk._mode_cluster("ckpt", px, fa, None).values()) == {1}
    assert fk._mode_cluster("full", px, fa, (4, 4)) == {
        "fact_fwd": (4, 4), "fact_bwd": (4, 4)}
    with pytest.raises(NotImplementedError, match="group"):
        fk._mode_cluster("lean", px, fa, (2, 2))
    assert fk._plan("fact_fwd", 66, "cpu", fa, None) == (1, 2)
    assert fk._plan("fact_bwd", 66, "cpu", fa, None) == (1, 2)
    got, _ = _full(fa, px, lens, plan["fact_fwd"])
    _assert_equal(got, pf.forward_backward_prob_fast(px, lens, fa, LEAKY))


def test_slot_packing_round_trip():
    """Every slot of the fast graph's four operators (B1/B2's bank order)
    packs into one word and back exactly (column ids and bfloat16 values,
    padding (0, 0) as 0); a column id past 16 bits or a value that is not
    a bfloat16 value is refused."""
    fa, _, _ = _case("separate", num_phones=600, seed=3, B=1, T=1,
                     lengths=(1,))
    kg = fk.graph_for(fa)
    for op, words in zip(kg.resident, kg.packed):
        assert words.dtype == torch.int32 and words.shape == op[1].shape
        col, val = fk.unpack_slots(words)
        assert torch.equal(col, op[1]) and torch.equal(val, op[2])
        assert bool(((words == 0) == (op[2] == 0)).all())
    col = torch.tensor([0, 1, 65535, 3], dtype=torch.int32)
    val = torch.tensor([0.0, 1.5, 2.0 ** -20, 0.00390625])
    back = fk.unpack_slots(fk.pack_slots(col, val))
    assert torch.equal(back[0], col) and torch.equal(back[1], val)
    with pytest.raises(ValueError, match="16 bits"):
        fk.pack_slots(torch.tensor([65536]), torch.tensor([1.0]))
    with pytest.raises(ValueError, match="bfloat16"):
        fk.pack_slots(torch.tensor([3]), torch.tensor([1.0 + 2.0 ** -10]))


def _graph(num_phones, bigram_fanout=30, forward_pdf_mode="source"):
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=0, bigram_fanout=bigram_fanout,
                             forward_pdf_mode=forward_pdf_mode)
    return pt.ChainGraphBatch(pt.ChainGraph(fst), 128,
                              tile_dtype="bfloat16", device="cpu")._fact


def _words(fa, which, C):
    """32 times the most slots any CTA holds of the two operators."""
    kg = fk.graph_for(fa)
    a, b = ((kg.resident[k][0].long().diff().numpy() for k in which))
    return 32 * max(int(a[r::C].sum() + b[r::C].sum()) for r in range(C))


def test_group_shared_memory_and_plan_at_the_headline_s8k_and_main4():
    """The group form's shared memory by its formula (packed vectors of
    S_pad G / 2 words, the per-row vectors on rank 0's rows, the scratch,
    the mbarriers, the local slice pointers, the slots of the CTA that
    holds the most), and the plan on a stubbed H100 (132 SMs, 232,448
    bytes a block): the headline graph (S_pad 3,072) takes (2, 2) from B
    = 67 to 132 and the cluster rule's form past 132, and at B <= 66 (1,
    2); outside identity mode (4, 4)'s backward CTA does not
    fit and a forced one raises; bench.py --s8k's graph (S_pad
    8,064: W1 alone 147,712 bytes a CTA at C = 4) fits no (G, C), so the
    plan keeps one block a column
    and every forced (G, C) raises; main path 4's (S_pad 12,032) is past
    B1/B2's limit, and the float32 tiles never take the group form."""
    head, s8k = _graph(1500), _graph(4000)
    assert (head.s_pad, s8k.s_pad) == (3072, 8064)
    for fa in (head, s8k):
        for G, C in fk.GROUPS:
            own = 32 * -(-(fa.s_pad // 32) // C)
            lp = 2 * ((fa.s_pad // 32 + C - 1) // C + 1 + 3 & ~3)
            fwd = (fa.s_pad * G + 3 * own * G + (33 * G + 3 & ~3) + 4 + lp
                   + _words(fa, (0, 1), C))
            bwd = (4 * fa.s_pad * G // 2 + own * G + 3 * own * G
                   + (66 * G + 3 & ~3) + (33 * G + 3 & ~3) + 8 + lp
                   + _words(fa, (2, 3), C))
            assert fk.group_smem_bytes(fa, G, C) == {
                "fact_fwd": max(4 * fwd, fk.LEAN_CLUSTER_MIN_SMEM),
                "fact_bwd": max(4 * bwd, fk.LEAN_CLUSTER_MIN_SMEM)}
    assert fk.graph_for(head).group_words[("fact_fwd", 2)] == 28480
    assert fk.group_smem_bytes(head, 2, 2) == {"fact_fwd": 176064,
                                              "fact_bwd": 194784}
    assert fk.group_smem_bytes(head, 4, 4) == {"fact_fwd": 144384,
                                              "fact_bwd": 196912}
    for form in fk.GROUP_FORMS:
        for B, want in ((8, (1, 2)), (66, (1, 2)), (67, (2, 2)),
                        (128, (2, 2)), (132, (2, 2)), (133, None)):
            assert fk.group_size(B, H100, head, form) == want
            assert fk.group_size(B, H100, s8k, form) is None
        with pytest.raises(NotImplementedError, match="S_pad=8064"):
            fk.group_size(128, H100, s8k, form, cluster=(4, 4))
        for G, C in fk.GROUPS:
            assert (fk.group_smem_bytes(s8k, G, C)[form] > fk.MAX_SMEM)
    xhead = _graph(1500, forward_pdf_mode="separate")
    assert fk.group_smem_bytes(xhead, 4, 4)["fact_bwd"] == 258352
    with pytest.raises(NotImplementedError, match="258352 bytes"):
        fk.group_size(128, H100, xhead, "fact_bwd", cluster=(4, 4))
    assert fk.group_size(128, H100, xhead, "fact_fwd", (4, 4)) == (4, 4)
    main4 = _shape(12032, "stream", fast=True)
    assert not fk.fits_on_chip(main4)
    assert fk.group_size(128, H100, main4, "fact_fwd") is None
    with pytest.raises(NotImplementedError, match="S_pad=12032"):
        fk.group_size(128, H100, main4, "fact_bwd", cluster=(2, 2))
    assert fk.group_size(128, H100, _shape(3072, "identity"),
                         "fact_fwd") is None


def test_the_plan_follows_the_operators_size():
    """The plan takes each form's group form only where its operator
    (slots at 8 bytes, what one block a column reads every frame) takes
    at least GROUP_MIN_OPERATOR_BYTES (the card's crossovers at B = 128):
    at the headline graph both (W1 and W2 453,888 bytes, W1^T and W2^T
    373,248); at the corpus recipe's denominator (path 6 (d):
    denominator_fst(1500, 2), a bigram fan-out of 10: 176,640 and 132,608
    bytes) the forward alone."""
    head, recipe = _graph(1500), _graph(1500, bigram_fanout=10)
    for fa, fwd, bwd, plan in ((head, 453888, 373248, (2, 2)),
                               (recipe, 176640, 132608, None)):
        words = fk.graph_for(fa).group_words
        assert (8 * words[("fact_fwd", 1)], 8 * words[("fact_bwd", 1)]) == \
            (fwd, bwd)
        assert fk.group_size(128, H100, fa, "fact_fwd") == (2, 2)
        assert fk.group_size(128, H100, fa, "fact_bwd") == plan
        # a forced (G, C) takes no heed of the rule
        assert fk.group_size(128, H100, fa, "fact_bwd", (2, 2)) == (2, 2)
    assert fk.GROUP_MIN_OPERATOR_BYTES == {"fact_fwd": 131072,
                                           "fact_bwd": 307200}


def test_group_form_refusals(monkeypatch):
    """A (G, C) that is not built, a form the group form does not run, a
    float32 graph or a forced ring raise before any launch."""
    monkeypatch.setattr(fk, "_card_props", lambda device: H100)
    fa, px, lens = _case("source", num_phones=600, seed=3, B=2, T=2,
                         lengths=(2, 1))
    f32 = pt.ChainGraphBatch(pt.ChainGraph(denominator_fst(
        num_phones=600, states_per_phone=2, seed=3)[0]), 2,
        device="cpu")._fact
    for bad in ((3, 2), (2, 8), (1, 4), (2, 1), (2, 4), (4, 2)):
        with pytest.raises(NotImplementedError, match="built"):
            fk.group_size(128, H100, fa, "fact_fwd", cluster=bad)
    for form in ("fact_fwd_snap", "fact_bwd_lean", "fact_fwd_init",
                 "fact_bwd_chunk"):
        with pytest.raises(NotImplementedError, match="group"):
            fk.group_size(128, H100, fa, form, cluster=(2, 2))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        fk.group_size(128, H100, f32, "fact_fwd", cluster=(2, 2))
    with pytest.raises(ValueError):
        fk._group_args("fact_fwd", 2, fa, (3, 2), None)
    ad_ys = torch.zeros((2, 2, fa.s_pad), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no ring"):
        fk.fact_bwd(lens, fa, LEAKY, ad_ys, ad_ys, ad_ys, None, None, None,
                    None, None, px.shape[2], stages=2, cluster=(2, 2))


# ----------------------------------------------------------------------
# The fast pair at G = 1: one column a cluster, within the cluster forms'
# reach
# ----------------------------------------------------------------------

ONE = [g for g in fk.FORM_GROUPS["fact_bwd"] if g[0] == 1]
ONE_FWD = [g for g in fk.FORM_GROUPS["fact_fwd"] if g[0] == 1]


def _one_column(fa, px, lens, group, debug=True, fwd_group=None):
    """fact_fwd at ``fwd_group`` (None: its plan: one block a column at
    these sizes, or (1, 2) past 1,024 states), the objective, then
    fact_bwd forced to ``group`` (None: its plan).  Returns (the result,
    the forward's outputs)."""
    P = px.shape[2]
    fwd = fk.fact_fwd(px, lens, fa, LEAKY, cluster=fwd_group)
    ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = fwd
    objf, tot = fk._objf(s_ys, ad_last, lens, fa, s0)
    outs = fk.fact_bwd(lens, fa, LEAKY, ad_ys, w1ad, xdst, xsrc, s_ys, ad0,
                       s0, tot, P, debug, cluster=group)
    return fk._package_result(objf, *outs), fwd


def _forward_equal(got, ref, lens):
    """The forward's streams on each column's frames, s_t and alpha'(T_b)
    under torch.equal."""
    _streams_equal(got[:4], ref[:4], lens)
    assert torch.equal(got[4], ref[4]) and torch.equal(got[5], ref[5])


@pytest.mark.parametrize("group", ONE)
@pytest.mark.parametrize("fwd_mode,want", [("source", "identity"),
                                           ("separate", "stream"),
                                           ("cross", "matrix")])
def test_one_column_a_cluster_gives_the_plain_fast_versions_bits(
        monkeypatch, group, fwd_mode, want):
    """fact_bwd at G = 1 (each (1, C) of FORM_GROUPS["fact_bwd"]), emulated
    CTA by CTA, on the forward's streams: B = 6 columns of lengths 12, 8,
    1, 2, 4, 9 (each its own cluster, so its own last frame and its own
    injection), debug True and False: the plain fast version's objf,
    gamma and traces under torch.equal; one launch of each fast kernel."""
    fa, px, lens = _case(fwd_mode, B=6, lengths=(12, 8, 1, 2, 4, 9))
    assert fa.xsrc_mode == want
    _emulate(monkeypatch)
    plain = pf.forward_backward_prob_fast(px, lens, fa, LEAKY)
    for debug in (True, False):
        fk.reset_launch_counts()
        got, _ = _one_column(fa, px, lens, group, debug)
        assert fk.launched() == {"fact_fwd_bf16": 1, "fact_bwd_bf16": 1}
        _assert_equal(got, plain if debug else fk._frame0_traces(plain))


@pytest.mark.parametrize("group", ONE_FWD)
@pytest.mark.parametrize("fwd_mode,want", [("source", "identity"),
                                           ("separate", "stream"),
                                           ("cross", "matrix")])
def test_one_column_forward_gives_the_plain_fast_versions_bits(
        monkeypatch, group, fwd_mode, want):
    """fact_fwd at G = 1 (each (1, C) of FORM_GROUPS["fact_fwd"]), emulated
    CTA by CTA with alpha' and u a word a state: B = 5 columns of lengths
    12, 8, 4, 1, 9 (each its own cluster, its own last frame), then
    fact_bwd at G = 1 on its streams, debug True and False: the plain fast
    version's objf, gamma and traces under torch.equal, and the one-block
    form's streams, s_t and alpha'(T_b); one launch of each fast kernel."""
    fa, px, lens = _case(fwd_mode)
    assert fa.xsrc_mode == want
    _emulate(monkeypatch)
    plain = pf.forward_backward_prob_fast(px, lens, fa, LEAKY)
    one = fk.fact_fwd(px, lens, fa, LEAKY, cluster=1)
    for debug in (True, False):
        fk.reset_launch_counts()
        got, fwd = _one_column(fa, px, lens, ONE[0], debug, group)
        assert fk.launched() == {"fact_fwd_bf16": 1, "fact_bwd_bf16": 1}
        _assert_equal(got, plain if debug else fk._frame0_traces(plain))
        _forward_equal(fwd, one, lens)


@pytest.mark.parametrize("fwd_mode", ["source", "separate"])
def test_one_column_a_cluster_past_1024_states(monkeypatch, fwd_mode):
    """S_pad 1,280 and P past 1,024 (a virtual thread with two rows and
    two pdfs), lengths 4, 1, 2: both forms at (1, 2) through the plan (the
    operator-size rule stubbed to take any operator), the plain fast
    version's bits, and the forward's streams the C = 2 cluster form's."""
    fa, px, lens = _case(fwd_mode, num_phones=600, seed=3, B=3, T=4,
                         lengths=(4, 1, 2))
    assert fa.s_pad > 1024 and px.shape[2] > 1024
    _emulate(monkeypatch)
    monkeypatch.setattr(fk, "GROUP_ONE_MIN_OPERATOR_BYTES",
                        {"fact_fwd": 0, "fact_bwd": 0})
    assert fk._mode_cluster("full", px, fa, None) == {"fact_fwd": (1, 2),
                                                      "fact_bwd": (1, 2)}
    fk.reset_launch_counts()
    got, fwd = _one_column(fa, px, lens, None)
    assert fk.launched() == {"fact_fwd_bf16": 1, "fact_bwd_bf16": 1}
    _assert_equal(got, pf.forward_backward_prob_fast(px, lens, fa, LEAKY))
    _forward_equal(fwd, fk.fact_fwd(px, lens, fa, LEAKY, cluster=2), lens)


def test_one_column_a_cluster_shared_memory():
    """fact_bwd's CTA at (1, 2) by the formula: b, x_dst * b and the
    masses (one vector in identity mode, two else, in two buffers) a word
    a state; beta' and the stage of 3 or 4 streams on rank 0's rows, one
    column; the scratch of 2 and 1 sums, the mbarriers, two sets of local
    slice pointers, and rank 0's or rank 1's slots of W1^T and W2^T,
    whichever are more: 169,824 bytes at the headline graph (95,232 of
    them slots), 200,544 outside identity mode."""
    head = _graph(1500)
    xhead = _graph(1500, forward_pdf_mode="separate")
    for fa, streams, want in ((head, 3, 169824), (xhead, 4, 200544)):
        s_pad, own = fa.s_pad, fa.s_pad // 2
        words = _words(fa, (2, 3), 2)
        lp = 2 * ((s_pad // 32 + 1) // 2 + 1 + 3 & ~3)
        bwd = ((2 + 2 * (streams - 2)) * s_pad + own + streams * own
               + (66 + 3 & ~3) + (33 + 3 & ~3) + 8 + lp + words)
        assert fk.group_smem_bytes(fa, 1, 2)["fact_bwd"] == 4 * bwd == want
    assert 4 * _words(head, (2, 3), 2) == 95232


def test_one_column_forward_shared_memory():
    """fact_fwd's CTA at (1, 2) by the formula, on a stubbed H100: alpha'
    and u a word a state (2 S_pad words, where (2, 2) holds S_pad G), the
    carry, x_dst and (outside identity mode) x_src on rank 0's rows, one
    column, the last two in two buffers; the scratch of one sum, the
    mbarriers, two sets of local slice pointers and rank 0's or rank 1's
    slots of W1 and W2: at the headline graph 39,376 words = 157,504
    bytes (28,480 words of slots), 169,792 outside identity mode, within
    the block; at bench.py --s8k's graph (S_pad 8,064) 412,448 bytes, past
    it, so a forced (1, 2) raises; main path 4's (S_pad 12,032) is past
    B1/B2's limit and raises too."""
    head, s8k = _graph(1500), _graph(4000)
    xhead = _graph(1500, forward_pdf_mode="separate")
    for fa, rows, want in ((head, 3, 157504), (xhead, 5, 169792),
                           (s8k, 3, 412448)):
        s_pad, own = fa.s_pad, fa.s_pad // 2
        lp = 2 * ((s_pad // 32 + 1) // 2 + 1 + 3 & ~3)
        fwd = (2 * s_pad + rows * own + (33 + 3 & ~3) + 4 + lp
               + _words(fa, (0, 1), 2))
        assert fk.group_smem_bytes(fa, 1, 2)["fact_fwd"] == 4 * fwd == want
    assert fk.graph_for(head).group_words[("fact_fwd", 2)] == 28480
    assert 4 * 39376 == 157504 <= H100.shared_memory_per_block_optin
    assert fk.group_size(64, H100, head, "fact_fwd", (1, 2)) == (1, 2)
    with pytest.raises(NotImplementedError, match="412448 bytes"):
        fk.group_size(64, H100, s8k, "fact_fwd", cluster=(1, 2))
    with pytest.raises(NotImplementedError, match="S_pad=12032"):
        fk.group_size(64, H100, _shape(12032, "stream", fast=True),
                      "fact_fwd", cluster=(1, 2))


@pytest.mark.parametrize("graph", ["headline", "s8k", "recipe", "float32"])
def test_one_column_a_cluster_plan(graph):
    """The plan on a stubbed H100 at B = 8, 32, 64, 66, 67 and 132: at the
    headline graph both forms take (1, 2) to B = 66 and (2, 2) past it;
    at the corpus recipe's (W1 and W2 176,640 bytes, W1^T and W2^T
    132,608: over GROUP_ONE_MIN_OPERATOR_BYTES; the backward's under
    GROUP_MIN_OPERATOR_BYTES) both take (1, 2) to 66, past it fact_fwd
    (2, 2) and fact_bwd one block a column; bench.py --s8k's graph (W1^T
    alone does not fit two CTAs) and float32 tiles keep the cluster
    rule's forms at every B."""
    fa = {"headline": lambda: _graph(1500), "s8k": lambda: _graph(4000),
          "recipe": lambda: _graph(1500, bigram_fanout=10),
          "float32": lambda: pt.ChainGraphBatch(pt.ChainGraph(
              denominator_fst(num_phones=1500, states_per_phone=2,
                              seed=0)[0]), 2, device="cpu")._fact}[graph]()
    for B in (8, 32, 64, 66, 67, 132):
        plan = {f: fk._form_plan(f, B, H100, fa, None)
                for f in fk.GROUP_FORMS}
        if graph == "headline":
            want = ({"fact_fwd": (1, 2), "fact_bwd": (1, 2)} if B <= 66
                    else {"fact_fwd": (2, 2), "fact_bwd": (2, 2)})
        elif graph == "recipe":
            want = ({"fact_fwd": (1, 2), "fact_bwd": (1, 2)} if B <= 66
                    else {"fact_fwd": (2, 2), "fact_bwd": 1})
        else:
            want = ({"fact_fwd": 2, "fact_bwd": 1} if B <= 66 else
                    {"fact_fwd": 1, "fact_bwd": 1})
        assert plan == want, (graph, B)


def test_one_column_plan_at_every_batch():
    """At the headline graph on a stubbed H100 (132 SMs), B = 1 ... 132:
    both forms at (1, 2) while B 2 <= 132 (B clusters of 2, one CTA an
    SM), at (2, 2) from 67 to 132 (ceil(B / 2) clusters of 2); past 132
    the cluster rule's one block a column.  On a card of 114 SMs the
    switch moves to B = 57."""
    head = _graph(1500)
    for B in range(1, 134):
        want = (1, 2) if 2 * B <= 132 else (2, 2) if B <= 132 else 1
        for form in fk.GROUP_FORMS:
            assert fk._form_plan(form, B, H100, head, None) == want, (form,
                                                                      B)
    small = type(H100)(multi_processor_count=114,
                       shared_memory_per_block_optin=232448)
    for form in fk.GROUP_FORMS:
        assert fk._form_plan(form, 57, small, head, None) == (1, 2)
        assert fk._form_plan(form, 58, small, head, None) == (2, 2)


def test_one_column_forward_threshold(monkeypatch):
    """GROUP_ONE_MIN_OPERATOR_BYTES gives each form its own least: the
    forward's the smallest W1 and W2 at which the card's (1, 2) was timed
    against the C = 2 cluster form at B = 64 (97,024 bytes, bigram fan-out
    5; it won there and at 113,152, 132,864, 176,640, 343,808 and 453,888:
    PERF.md), the backward's 128 KB.  The plan takes (1, 2) at B = 64
    where the form's operator (slots at 8 bytes) takes at least it, else
    the cluster form at C = 2 (fact_bwd one block); each form is held to
    its own operator's bytes (the headline's W1 and W2 453,888, W1^T and
    W2^T 373,248)."""
    assert fk.GROUP_ONE_MIN_OPERATOR_BYTES == {"fact_fwd": 97024,
                                               "fact_bwd": 131072}
    for fanout, sizes, want in (
            (4, (82176, 61440), {"fact_fwd": 2, "fact_bwd": 1}),
            (5, (97024, 73728), {"fact_fwd": (1, 2), "fact_bwd": 1}),
            (7, (132864, 96512), {"fact_fwd": (1, 2), "fact_bwd": 1})):
        fa = _graph(1500, bigram_fanout=fanout)
        words = fk.graph_for(fa).group_words
        assert (8 * words[("fact_fwd", 1)],
                8 * words[("fact_bwd", 1)]) == sizes, fanout
        assert {f: fk._form_plan(f, 64, H100, fa, None)
                for f in fk.GROUP_FORMS} == want, fanout
    head = _graph(1500)
    words = fk.graph_for(head).group_words
    fwd, bwd = 8 * words[("fact_fwd", 1)], 8 * words[("fact_bwd", 1)]
    assert (fwd, bwd) == (453888, 373248)
    for least, want in ((fwd + 1, {"fact_fwd": 2, "fact_bwd": 1}),
                        (fwd, {"fact_fwd": (1, 2), "fact_bwd": 1}),
                        (bwd, {"fact_fwd": (1, 2), "fact_bwd": (1, 2)})):
        monkeypatch.setattr(fk, "GROUP_ONE_MIN_OPERATOR_BYTES",
                            {f: least for f in fk.GROUP_FORMS})
        assert {f: fk._form_plan(f, 64, H100, head, None)
                for f in fk.GROUP_FORMS} == want, least


def test_a_forced_one_column_forward_raises(monkeypatch):
    """A forced (1, 2) on fact_fwd reaches _fwd_group_launch (emulated
    here; one launch, the plain fast version's bits), alone and as a
    call's plan; a (1, 2) that does not fit (bench.py --s8k's graph)
    raises NotImplementedError for both forms before any launch."""
    _emulate(monkeypatch)
    seen = []
    launch = fk._fwd_group_launch
    monkeypatch.setattr(fk, "_fwd_group_launch", lambda *a, **k: (
        seen.append(a[7]), launch(*a, **k))[1])
    fa, px, lens = _case("source", num_phones=600, seed=3, B=2, T=2,
                         lengths=(2, 1))
    assert fk.group_size(8, H100, fa, "fact_fwd", cluster=(1, 2)) == (1, 2)
    fk.reset_launch_counts()
    fwd = fk.fact_fwd(px, lens, fa, LEAKY, cluster=(1, 2))
    assert seen == [(1, 2)] and fk.launched() == {"fact_fwd_bf16": 1}
    _forward_equal(fwd, fk.fact_fwd(px, lens, fa, LEAKY, cluster=1), lens)
    assert fk._mode_cluster("full", px, fa, (1, 2)) == {"fact_fwd": (1, 2),
                                                         "fact_bwd": (1, 2)}
    got, _ = _full(fa, px, lens, (1, 2))
    assert seen == [(1, 2), (1, 2)]
    _assert_equal(got, pf.forward_backward_prob_fast(px, lens, fa, LEAKY))
    fk._group_args("fact_fwd", 2, fa, (1, 2), None)
    with pytest.raises(ValueError, match="not built"):
        fk._group_args("fact_fwd", 2, fa, (1, 4), None)
    fk.reset_launch_counts()
    for form in fk.GROUP_FORMS:
        with pytest.raises(NotImplementedError, match="S_pad=8064"):
            fk.group_size(8, H100, _graph(4000), form, cluster=(1, 2))
    assert fk.launched() == {}
