"""B1/B2's full-stream forms on a thread-block cluster, on the CPU.

Every form of ``ops/fact_kernels.py`` runs a column on a cluster of C CTAs
(``cluster=``): the full mode's pair (``fact_fwd``, ``fact_bwd``) and the
ckpt mode's replays and chunk backwards (``fact_fwd_init``,
``fact_bwd_chunk``) as the lean pair does since its cluster form.  The
CUDA kernels cannot run here; the card's host code runs on
tests/test_torch_stream_modes.py's per-CTA emulations of the kernels
(``_emu_fwd``, ``_emu_bwd``: each CTA's own rows computed apart, every sum
taken as the kernels take it), put in place of the launches, so that
C = 2 and 4 must give C = 1's bits: the streams, objf, gamma and the
traces.  That file already holds the lean and ckpt modes so at chunk 5 in
identity and stream mode; here the full mode on columns of unequal length
in the three x_src modes, past 1,024 states, the ckpt mode in matrix mode,
one cluster size for every launch of a call, and the plan rule and the
cluster forms' shared memory by arithmetic on a stubbed H100.
tests/test_torch_card.py holds the kernels themselves to it on the card.
"""

import types

import numpy as np
import pytest
import torch

import pychain_tpu_torch as pt
from pychain_tpu_torch.ops import factorized as pf
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.utils.testgraphs import denominator_fst

from test_torch_stream_modes import (H100, LEAKY, MODES, _assert_equal,
                                     _emu_bwd, _emu_fwd, _emu_pair, _shape)


def _graph_case(fwd_mode, tile_dtype, num_phones=10, seed=6, B=5, T=12,
                lengths=(12, 8, 4, 1, 9)):
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=fwd_mode)
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), B, tile_dtype=tile_dtype,
                            device="cpu")._fact
    rng = np.random.RandomState(seed + 11)
    px = torch.exp(torch.from_numpy(rng.randn(B, T, P).astype(np.float32)))
    return fa, px, torch.tensor(lengths, dtype=torch.int32)


def _emulate(monkeypatch, seen=None):
    """The emulated kernels in place of the launches on a stubbed H100;
    ``seen`` collects each launch's (form, cluster)."""
    def spy(emu):
        def launch(form, *args, **kw):
            if seen is not None:
                seen.append((form, kw.get("cluster", 1)))
            return emu(form, *args, **kw)
        return launch
    def pair(fa, replay, backward, smid=None):
        # the paired ckpt scan's roles, one block a column
        if seen is not None:
            seen.extend((role["form"], 1) for role in (replay, backward)
                        if role is not None)
        return _emu_pair(fa, replay, backward, smid)
    monkeypatch.setattr(fk, "_fwd_launch", spy(_emu_fwd))
    monkeypatch.setattr(fk, "_bwd_launch", spy(_emu_bwd))
    monkeypatch.setattr(fk, "_pair_launch", pair)
    monkeypatch.setattr(fk, "_card_props", lambda device: H100)


def _full(fa, px, lens, cluster, debug=True):
    """The full mode's card path: fact_fwd, the objective, fact_bwd, both
    on ``cluster`` CTAs a column.  Returns (result, the four streams)."""
    P = px.shape[2]
    ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = fk.fact_fwd(
        px, lens, fa, LEAKY, cluster=cluster)
    objf, tot = fk._objf(s_ys, ad_last, lens, fa, s0)
    outs = fk.fact_bwd(lens, fa, LEAKY, ad_ys, w1ad, xdst, xsrc, s_ys, ad0,
                       s0, tot, P, debug, cluster=cluster)
    return fk._package_result(objf, *outs), (ad_ys, w1ad, xdst, xsrc)


def _ckpt(fa, px, lens, cluster, debug=True, chunk=3):
    """The ckpt mode's card path at ``chunk`` on ``cluster`` CTAs a
    column."""
    objf, outs = fk._ckpt(px, lens, fa, LEAKY, debug, None, chunk, cluster)
    return fk._package_result(objf, *outs)


def _streams_equal(got, ref, lens):
    """The streams' rows of each column's frames (the rows past a
    column's end are never written)."""
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        for col, Tb in enumerate(lens.tolist()):
            if a is not None:
                assert torch.equal(a[col, :Tb], b[col, :Tb])


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("fwd_mode,want", MODES)
@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_full_cluster_gives_one_blocks_bits(monkeypatch, tile_dtype,
                                            fwd_mode, want, C):
    """fact_fwd and fact_bwd on C = 2 and 4 CTAs a column: C = 1's
    streams and results bit for bit, in both precisions and every x_src
    mode, at T=12 and lengths 12, 8, 4, 1, 9, debug True and False; one
    launch of each; the fast mode also the plain fast version's."""
    fa, px, lens = _graph_case(fwd_mode, tile_dtype)
    assert fa.xsrc_mode == want
    _emulate(monkeypatch)
    sfx = "_bf16" if tile_dtype else ""
    for debug in (True, False):
        one, one_streams = _full(fa, px, lens, 1, debug)
        fk.reset_launch_counts()
        got, streams = _full(fa, px, lens, C, debug)
        assert fk.launched() == {f"fact_fwd{sfx}": 1, f"fact_bwd{sfx}": 1}
        _assert_equal(got, one)
        _streams_equal(streams, one_streams, lens)
    if tile_dtype:
        _assert_equal(got, fk._frame0_traces(
            pf.forward_backward_prob_fast(px, lens, fa, LEAKY)))


@pytest.mark.parametrize("mode", ["full", "ckpt"])
@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_full_and_chunk_clusters_past_1024_states(monkeypatch, tile_dtype,
                                                  mode):
    """S_pad 1,280 and P past 1,024 (two rows and two pdfs for some
    virtual threads, five slices a CTA at C = 4): the full mode and the
    ckpt mode (chunk 3: replays and chunk backwards entered from
    snapshots and carries) at C = 2 and 4 give C = 1's bits, the fast
    mode also the plain version's."""
    fa, px, lens = _graph_case("source", tile_dtype, num_phones=600, seed=3,
                               B=2, T=4, lengths=(4, 3))
    assert fa.s_pad > 1024 and px.shape[2] > 1024
    _emulate(monkeypatch)

    def run(C):
        return _full(fa, px, lens, C)[0] if mode == "full" else \
            _ckpt(fa, px, lens, C)

    one = run(1)
    for C in (2, 4):
        _assert_equal(run(C), one)
    if tile_dtype:
        _assert_equal(one, pf.forward_backward_prob_mode(px, lens, fa, LEAKY,
                                                         mode, 3))


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_ckpt_chunk_forms_in_matrix_mode(monkeypatch, tile_dtype, C):
    """The ckpt mode in matrix mode (x_src by W2's source pdfs) at chunk
    3, lengths 12, 8, 4, 1, 9 (columns ending on a chunk boundary, inside
    one, in the first frame): C = 1's bits at C, debug True and False;
    float32 also the full mode's bits (the replay is the full form's
    arithmetic from the float32 snapshot)."""
    fa, px, lens = _graph_case("cross", tile_dtype)
    assert fa.xsrc_mode == "matrix"
    _emulate(monkeypatch)
    for debug in (True, False):
        got, one = (_ckpt(fa, px, lens, c, debug) for c in (C, 1))
        _assert_equal(got, one)
        if not tile_dtype:
            _assert_equal(got, _full(fa, px, lens, C, debug)[0])


@pytest.mark.parametrize("mode", ["lean", "ckpt"])
def test_a_call_runs_every_launch_at_one_cluster_size(monkeypatch, mode):
    """Each launch of a call takes its form's cluster size: on an H100
    at B=2 and S_pad 1,280 C = 2 for every form but fact_bwd and
    fact_bwd_chunk, which the plan keeps at C = 1 (the full mode's pair
    takes its sizes from the same rule, fact_kernels._mode_cluster), but
    the paired ckpt scan's roles, which run one block a column (B=2: 2 B
    <= 132); a forced C reaches every launch (unpaired)."""
    fa, px, lens = _graph_case("source", "bfloat16", num_phones=600, seed=3,
                               B=2, T=4, lengths=(4, 3))
    assert fa.s_pad > 1024
    seen = []
    _emulate(monkeypatch, seen)
    for m, forms in fk.MODE_FORMS.items():
        assert fk._mode_cluster(m, px, fa, None) == {
            f: 1 if f in ("fact_bwd", "fact_bwd_chunk") else 2 for f in forms}
    for forced in (None, 4):
        seen.clear()
        if mode == "lean":
            fk._lean(px, lens, fa, LEAKY, True, None, forced)
        else:
            fk._ckpt(px, lens, fa, LEAKY, True, None, 3, forced)
        want = fk._mode_cluster(mode, px, fa, forced)
        if mode == "ckpt" and forced is None:
            want["fact_fwd_init"] = 1
        assert {form for form, _ in seen} == set(want)
        assert all(c == want[form] for form, c in seen)


@pytest.mark.parametrize("B,sms,want", [
    (128, 132, 1),    # the headline batch, paths 1-3, 5 and 6 (d)
    (64, 132, 2),     # bench.py --long --big (main path 7)
    (32, 132, 2),     # bench.py --long
    (8, 132, 2),      # the recipe's B=8 denominator runs (path 6)
    (66, 132, 2),
    (67, 132, 1),
    (8, 16, 2),       # a card of 16 SMs
    (9, 16, 1),
])
def test_cluster_rule_for_every_form(B, sms, want):
    """One rule for every form: the largest C of the form's
    fact_kernels.PLAN_CLUSTERS with B C CTAs on the card's SMs whose CTA
    fits its shared memory: (1, 2) for the forward forms and
    fact_bwd_lean, (1,) for fact_bwd and fact_bwd_chunk (their cluster
    form no faster on the card), in both precisions and every x_src mode
    at the headline S_pad; a card whose block cannot hold a cluster CTA
    (99 KB) keeps C = 1, and so does a graph of 1,024 states or fewer (a
    thread of the one-block kernel has one row: a split shortens no
    thread's rows)."""
    props = types.SimpleNamespace(multi_processor_count=sms,
                                  shared_memory_per_block_optin=232448)
    small = types.SimpleNamespace(multi_processor_count=sms,
                                  shared_memory_per_block_optin=101376)
    for fast in (False, True):
        for xsrc in ("identity", "matrix", "stream"):
            head = _shape(3072, xsrc, fast)
            for form in fk.FWD_FORMS + fk.BWD_FORMS:
                kept = form in ("fact_bwd", "fact_bwd_chunk")
                assert fk.cluster_size(B, props, head, form) == \
                    (1 if kept else want)
                assert fk.cluster_size(B, small, head, form) == 1
                for s_pad, split in ((128, False), (1024, False),
                                     (1152, True)):
                    fa = _shape(s_pad, xsrc, fast)
                    assert fk.cluster_size(B, props, fa, form) == \
                        (1 if kept or not split else want)


@pytest.mark.parametrize("mode,limit,cluster_limit", [
    ("identity", 14464, 9600), ("stream", 11520, 7168),
    ("matrix", 11520, 7168)])
def test_full_and_chunk_cluster_shared_memory(mode, limit, cluster_limit):
    """fact_bwd and fact_bwd_chunk's cluster CTA: beta' and the masses in
    two buffers, b and x_dst * b, the totals of two sums in two buffers
    and the trace's (165 floats), the ring and its mbarriers (and three
    for an st.async exchange), padded to 16 bytes, at least 118,784
    bytes; the forward forms fact_fwd_snap's.  Its limit (S_pad 9,600 in
    identity mode, else 7,168) lies below C = 1's (14,464, 11,520):
    between them the plan keeps C = 1 and a forced C raises before any
    launch; in both precisions."""
    vectors = 6 if mode == "identity" else 8
    rows = 3 if mode == "identity" else 4
    for fast in (False, True):
        entry = 2 if fast else 4
        at, past = (_shape(cluster_limit, mode, fast),
                    _shape(cluster_limit + 128, mode, fast))
        full = ("fact_bwd", "fact_bwd_chunk")
        for C in (2, 4):
            for form in full:
                assert fk.cluster_fits(at, C, form)
                assert not fk.cluster_fits(past, C, form)
            for stages in (0, 1, 2):
                bars = (stages + fk.CLUSTER_XBARS + 1) // 2 * 2
                want = max(stages * rows * cluster_limit * entry + bars * 8
                           + (vectors * cluster_limit + 165) * 4,
                           fk.LEAN_CLUSTER_MIN_SMEM)
                got = fk.cluster_smem_bytes(at, C, stages)
                assert got["fact_bwd"] == got["fact_bwd_chunk"] == want
                assert {got[f] for f in fk.FWD_FORMS} == {max(
                    ((4 if mode == "identity" else 5) * cluster_limit + 40)
                    * 4, fk.LEAN_CLUSTER_MIN_SMEM)}
        for s_pad in (cluster_limit + 128, limit):
            fa = _shape(s_pad, mode, fast)
            assert fk.fits_on_chip(fa)
            for form in full:
                assert fk.cluster_size(8, H100, fa, form) == 1
                with pytest.raises(NotImplementedError,
                                   match=f"S_pad={s_pad}"):
                    fk.cluster_size(8, H100, fa, form, cluster=2)
            for form in fk.FWD_FORMS:
                assert fk.cluster_size(8, H100, fa, form) == 2
        assert not fk.fits_on_chip(_shape(limit + 128, mode, fast))


@pytest.mark.parametrize("s_pad,mode,fast,one,cluster", [
    (3072, "identity", True, 2, 2),      # main path 7
    (3072, "identity", False, 2, 2),
    (5760, "identity", False, 2, 1),
    (8064, "identity", True, 2, 0),      # s8k's size
    (7168, "identity", False, 1, 0),
    (4352, "stream", False, 2, 1),
    (6400, "stream", True, 2, 0),
])
def test_full_cluster_ring_depth(s_pad, mode, fast, one, cluster):
    """The cluster form's ring takes what fits beside its layout (two
    stages, else one, else none), C = 1's what fits beside its own; the
    headline graph keeps two stages at every C."""
    fa = _shape(s_pad, mode, fast)
    assert fk.ring_stages(fa) == one
    for C in (2, 4):
        assert fk.ring_stages(fa, cluster=C) == cluster
        assert fk.ring_stages(fa, lean=True, cluster=C) == \
            fk.ring_stages(fa, lean=True)
        got = fk.cluster_smem_bytes(fa, C)
        assert got["fact_bwd"] <= fk.MAX_SMEM
        if cluster < 2:
            assert fk.cluster_smem_bytes(fa, C, cluster + 1)[
                "fact_bwd"] > fk.MAX_SMEM
