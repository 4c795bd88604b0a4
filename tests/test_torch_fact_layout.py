"""B1/B2's operator layout on the host (ops/fact_kernels.py).

The resident kernels read W1, W2, W1^T and W2^T as sliced ELL with each
row's entries permuted among its slots so that a warp's gathers from
shared memory hit distinct banks (``bank_order``).  These tests hold the
permuted operators to the ascending ones the cluster kernels read: the
same slices, slot counts, entries per row and zero padding; and the
gather wavefront count (``gather_wavefronts``) at the headline graph
(bench.py's: denominator_fst(1500, 2, bigram_fanout=30), S_pad 3,072)
against the counts the ascending order gives.
"""

import types

import numpy as np
import pytest
import torch

import pychain_tpu_torch as pt
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.utils.testgraphs import denominator_fst

MODES = ["source", "cross", "separate"]
OPS = ("w1", "w2", "w1t", "w2t")


def _fact(num_phones, mode="source", bigram_fanout=10):
    fst, _ = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=0, forward_pdf_mode=mode,
                             bigram_fanout=bigram_fanout)
    return pt.ChainGraphBatch(pt.ChainGraph(fst), 2, device="cpu")._fact


_HEADLINE = {}


def _headline_graph():
    if not _HEADLINE:
        fa = _fact(1500, bigram_fanout=30)
        _HEADLINE["kg"] = fk.kernel_graph(fa)
        _HEADLINE["fa"] = fa
    return _HEADLINE["fa"], _HEADLINE["kg"]


def _entries(sell):
    """(row, col, val) of every arc entry of a sliced-ELL operator, sorted;
    and the columns of its padding entries."""
    sptr, col, val = (np.asarray(t) for t in sell)
    slen = np.diff(sptr)
    k = np.arange(len(col))
    row = np.repeat(np.arange(len(slen)), slen * fk.SLICE) * fk.SLICE \
        + k % fk.SLICE
    arc = val != 0
    order = np.lexsort((val[arc], col[arc], row[arc]))
    return (np.stack([row[arc][order], col[arc][order]]), val[arc][order],
            col[~arc])


def _assert_same_rows(ascending, banked):
    np.testing.assert_array_equal(np.asarray(banked[0]),
                                  np.asarray(ascending[0]))
    assert len(banked[1]) == len(ascending[1])
    rc_a, v_a, pad_a = _entries(ascending)
    rc_b, v_b, pad_b = _entries(banked)
    np.testing.assert_array_equal(rc_b, rc_a)
    np.testing.assert_array_equal(v_b, v_a)
    assert len(pad_b) == len(pad_a) and not pad_b.any()


@pytest.mark.parametrize("mode", MODES)
def test_bank_order_keeps_each_rows_entries_and_padding(mode):
    """Small graphs (S_pad 384) in the three x_src modes."""
    kg = fk.kernel_graph(_fact(150, mode))
    assert kg.resident is not None
    for name, banked in zip(OPS, kg.resident):
        _assert_same_rows(getattr(kg, name), banked)


def test_headline_wavefronts_and_rows():
    """The ascending order costs 2.87 / 3.10 gather wavefronts per
    slot-warp for W1 / W1^T at the headline graph; the bank order at most
    1.6, with the same slot counts and the same entries in each row."""
    fa, kg = _headline_graph()
    assert fa.s_pad == 3072
    w1, w1t = fk.gather_wavefronts(kg.w1), fk.gather_wavefronts(kg.w1t)
    assert (len(w1), int(w1.sum())) == (1820, 5225)
    assert (len(w1t), int(w1t.sum())) == (1504, 4661)
    for i, name in enumerate(OPS):
        _assert_same_rows(getattr(kg, name), kg.resident[i])
    for i in (0, 2):
        got = fk.gather_wavefronts(kg.resident[i])
        assert len(got) == (1820, 1504)[i // 2]
        assert got.mean() <= 1.6, (OPS[i], got.mean())


def test_gather_wavefronts_counts_distinct_words_per_bank():
    sptr = torch.tensor([0, 3], dtype=torch.int32)
    lanes = np.arange(fk.SLICE)
    col = np.concatenate([
        lanes,                        # 32 banks once: 1
        lanes * 32,                   # bank 0, 32 distinct words: 32
        np.where(lanes < 16, 5, 37),  # bank 5, two words: 2
    ]).astype(np.int32)
    got = fk.gather_wavefronts((sptr, torch.from_numpy(col), None))
    np.testing.assert_array_equal(got, [1, 32, 2])


def test_resident_operators_only_for_graphs_b1_b2_run(monkeypatch):
    fa = _fact(10)
    assert fk.kernel_graph(fa).resident is not None
    monkeypatch.setattr(fk, "fits_on_chip", lambda fa: False)
    assert fk.kernel_graph(fa).resident is None


# ----------------------------------------------------------------------
# fact_bwd's ring: depth and shared memory
# ----------------------------------------------------------------------

def _shape(s_pad, mode):
    return types.SimpleNamespace(s_pad=s_pad, xsrc_mode=mode)


@pytest.mark.parametrize("s_pad,mode,stages,bwd_bytes", [
    (3072, "identity", 2, 123292),      # the headline graph: two stages
    (8064, "identity", 1, 226196),      # s8k: one
    (12032, "identity", 0, 192908),     # past one stage: none
    (3072, "stream", 2, 160156),
    (6400, "stream", 1, 230804),
    (11520, "stream", 0, 230796),
])
def test_ring_depth_and_shared_memory(s_pad, mode, stages, bwd_bytes):
    fa = _shape(s_pad, mode)
    assert fk.ring_stages(fa) == stages
    assert fk.smem_bytes(fa)["fact_bwd"] == bwd_bytes <= fk.MAX_SMEM
    identity = mode == "identity"
    for k in (0, 1, 2):
        want = ((4 if identity else 5) * s_pad + 3 * 32 + 3
                + k * ((3 if identity else 4) * s_pad + 2)) * 4
        assert fk.smem_bytes(fa, k)["fact_bwd"] == want
        assert fk.smem_bytes(fa, k)["fact_fwd"] == (4 * s_pad + 33) * 4
    if stages < 2:
        assert fk.smem_bytes(fa, stages + 1)["fact_bwd"] > fk.MAX_SMEM


@pytest.mark.parametrize("mode,limit", [("identity", 14464),
                                        ("stream", 11520),
                                        ("matrix", 11520)])
def test_resident_limits_do_not_move(mode, limit):
    """The ring is sized to what is left: the largest S_pad B1/B2 take
    (S_pad a multiple of 128) is as before, and past it neither runs."""
    assert fk.fits_on_chip(_shape(limit, mode))
    assert fk.ring_stages(_shape(limit, mode)) == 0
    assert not fk.fits_on_chip(_shape(limit + 128, mode))

