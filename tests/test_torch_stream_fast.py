"""The cluster tier (B3/B4) in the fast mode (bfloat16 tiles) against JAX.

The JAX package's streamed kernels (ops/pallas_stream.py) compute, with
bfloat16 tiles, what its resident ones do in that mode; the port's plain
fast version (``ops/factorized.forward_backward_prob_fast``) with
``cluster=C`` takes every sum in the order of the cluster kernels
(``stream_fwd_bf16`` / ``stream_bwd_bf16``) at C CTAs a cluster, so that
they give its numbers bit for bit on the card.  Here, on the CPU:

* that plain version, at ``cluster`` None, 1, 2 and 4, against JAX's
  B3/B4 in interpret mode with bfloat16 tiles in the three x_src modes:
  objf relative and gamma / traces absolute <= 1e-5 (float32 sums in
  other orders; at these sizes no flipped bfloat16 rounding reaches
  these bars);
* ChainLoss(precision="fast") with the denominator forced to
  engine="stream" against JAX's chain_loss forced to its stream tier:
  value relative 1e-5, gradient absolute 1e-6;
* the CPU wrapper: the plain fast version in the caller's cluster order,
  no launch;
* the graph's fast form for the cluster tier (``KernelGraph.off`` and
  ``diag``), the W2 source pdfs in its layout and the cluster sums'
  order (the fast forms' shared memory and plan, which their packed
  layout sets, are tests/test_torch_stream_packed.py's).

tests/test_torch_stream.py emulates the fast cluster kernels CTA by CTA
against the same plain version (bit for bit); tests/test_torch_card.py
holds the kernels themselves to it on the card.
"""

import dataclasses
import functools

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
from pychain_tpu_torch.ops import factorized as fz
from pychain_tpu_torch.ops import stream_kernels as sk
from pychain_tpu_torch.utils.testgraphs import linear_fst

LEAKY = 1e-5
MODES = [("source", "identity"), ("cross", "matrix"),
         ("separate", "stream")]
B, T = 4, 10
LENGTHS = np.array([T, T, T - 2, T - 5], np.int32)


def _tiled(build):
    """Run ``build()`` with every transition matrix forced onto the 128x128
    tile stratum in both packages (dense_min_fill=2.0), as
    tests/test_pallas_stream.py:33-55 does, so that JAX's kernels stream
    W1 tiles."""
    j_orig, p_orig = jfz._build_wparts, pfz._build_wparts
    jfz._build_wparts = functools.partial(j_orig, dense_min_fill=2.0)
    pfz._build_wparts = functools.partial(p_orig, dense_min_fill=2.0)
    try:
        return build()
    finally:
        jfz._build_wparts, pfz._build_wparts = j_orig, p_orig


def _fst(mode):
    """The JAX stream tests' graph: denominator_fst(256, 2,
    bigram_fanout=2) (S_pad 512)."""
    return denominator_fst(num_phones=256, states_per_phone=2,
                           bigram_fanout=2, seed=0, forward_pdf_mode=mode)


def _batches(mode, batch_size):
    fst, P = _fst(mode)
    jbatch, batch = _tiled(lambda: (
        JChainGraphBatch(JChainGraph(fst), batch_size,
                         tile_dtype="bfloat16"),
        pt.ChainGraphBatch(pt.ChainGraph(fst), batch_size,
                           tile_dtype="bfloat16", device="cpu")))
    assert jbatch._fact.w1.tiles.shape[0] > 1, "W1 tiles must stream"
    assert fz.is_fast(batch._fact)
    return fst, P, jbatch, batch


def _px(P, seed=0):
    rng = np.random.RandomState(seed)
    return np.exp(rng.randn(B, T, P).astype(np.float32) * 0.3)


@functools.lru_cache(maxsize=None)
def _jax_stream(mode):
    """JAX's B3/B4 (interpret mode) with bfloat16 tiles, once per mode:
    (objf, gamma, alpha_beta, gamma_sum) as numpy."""
    _, P, jbatch, _ = _batches(mode, B)
    ref = j_stream(jnp.asarray(_px(P)), jnp.asarray(LENGTHS.copy()),
                   jbatch._fact, LEAKY)
    return tuple(np.asarray(getattr(ref, k))
                 for k in ("objf", "gamma", "alpha_beta", "gamma_sum"))


@pytest.mark.parametrize("cluster", [None, 1, 2, 4])
@pytest.mark.parametrize("mode,want", MODES)
def test_plain_fast_cluster_matches_jax_stream_bf16(mode, want, cluster):
    _, P, _, batch = _batches(mode, B)
    fa = batch._fact
    assert fa.xsrc_mode == want
    got = fz.forward_backward_prob_fast(
        torch.from_numpy(_px(P)), torch.from_numpy(LENGTHS.copy()), fa,
        LEAKY, cluster=cluster)
    objf, gamma, ab, gs = _jax_stream(mode)
    np.testing.assert_allclose(got.objf.numpy(), objf, rtol=1e-5, atol=0)
    for name, ref in (("gamma", gamma), ("alpha_beta", ab),
                      ("gamma_sum", gs)):
        np.testing.assert_allclose(getattr(got, name).numpy(), ref,
                                   rtol=0, atol=1e-5, err_msg=name)
    assert torch.equal(got.gamma.bfloat16().float(), got.gamma)
    assert bool(got.ok.all())


def test_chain_loss_fast_forced_stream_matches_jax():
    """ChainLoss(precision="fast")'s value and x-gradient with the
    denominator forced to engine="stream", against JAX's chain_loss with
    bfloat16 tiles forced to its stream tier."""
    Bl, Tl = 3, 8
    fst, P = _fst("separate")
    rng = np.random.RandomState(1)
    lens = np.array([Tl, Tl - 3, Tl - 5], np.int32)
    seqs = [rng.randint(0, P, size=int(n)) for n in lens]
    x = rng.randn(Bl, Tl, P).astype(np.float32)
    K = int(lens.max())
    nums = pt.ChainGraphBatch(
        [pt.ChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1, device="cpu")
    loss_mod = pt.ChainLoss(pt.ChainGraph(fst), precision="fast",
                            device="cpu")
    den = _tiled(lambda: loss_mod.den_batch(Bl))
    den._fact = dataclasses.replace(den._fact, engine="stream")
    assert pt_loss.dispatch_arrays(den).engine == "stream"
    assert fz.is_fast(den._fact)
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    val = loss_mod(xt, torch.from_numpy(lens.copy()), nums)
    val.backward()

    jnums = JChainGraphBatch(
        [JChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1)
    jbatch = _tiled(lambda: JChainGraphBatch(JChainGraph(fst), Bl,
                                             tile_dtype="bfloat16"))
    jden = dataclasses.replace(jbatch._fact, engine="stream")
    jval, jgrad = jax.value_and_grad(
        lambda a: j_chain_loss(a, jnp.asarray(lens.copy()), jnums, jden))(
            jnp.asarray(x.copy()))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# The CPU wrapper, the graph's fast form and the cluster sums
# ----------------------------------------------------------------------

def _small(mode="cross", num_phones=40, Bs=5, Ts=9, seed=3):
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=mode)
    rng = np.random.RandomState(seed)
    px = torch.exp(torch.from_numpy(rng.randn(Bs, Ts, P).astype(
        np.float32)))
    lens = torch.tensor([Ts, Ts - 2, 3, 1, Ts - 4][:Bs])
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), Bs, tile_dtype="bfloat16",
                            device="cpu")._fact
    return fa, px, lens


@pytest.mark.parametrize("debug", [True, False])
def test_cpu_stream_wrapper_takes_plain_fast_path(debug):
    """On CPU tensors the wrapper computes the plain fast version, in the
    caller's cluster order when one is given, and launches nothing."""
    fa, px, lens = _small()
    sk.reset_launch_counts()
    for cluster in (None, 2, 8):
        got = sk.forward_backward_prob_stream(px, lens, fa, LEAKY,
                                              debug=debug, cluster=cluster)
        ref = fz.forward_backward_prob_fast(px, lens, fa, LEAKY,
                                            cluster=cluster)
        if not debug:
            ref = fk._frame0_traces(ref)
        for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert set(sk.LAUNCHES.values()) == {0}
    assert set(sk.LAUNCHES) == {"stream_fwd", "stream_bwd",
                                "stream_fwd_bf16", "stream_bwd_bf16"}


@pytest.mark.parametrize("mode,want", MODES)
def test_fast_graph_for_the_cluster_tier(mode, want, monkeypatch):
    """A fast graph past B1/B2 has a fast form: the off-diagonal entries
    of the ascending operators, bfloat16 values held in float32, and the
    float32 diagonals, with no bank-ordered operators; the cluster pair
    reads it (stream_kernels.operators), and the W2 source pdfs are laid
    out like its W2.  A graph within B1/B2 has both forms."""
    fa, _, _ = _small(mode)
    assert fa.xsrc_mode == want
    both = fk.kernel_graph(fa)
    monkeypatch.setattr(fk, "fits_on_chip", lambda *a, **k: False)
    kg = fk.kernel_graph(fa)
    assert kg.resident is None and both.resident is not None
    for name, op, full, op_both in zip(("w1", "w2", "w1t", "w2t"), kg.off,
                                       (kg.w1, kg.w2, kg.w1t, kg.w2t),
                                       both.off):
        off = {k: v for k, v in _entries(full).items() if k[0] != k[1]}
        assert _entries(op) == off, name
        assert torch.equal(op[2].bfloat16().float(), op[2])
        assert all(torch.equal(a, b) for a, b in zip(op, op_both)), name
    for d, w in zip(kg.diag, (fa.w1, fa.w2)):
        assert d.dtype == torch.float32 and torch.equal(d, w.diag)
    assert sk.operators(kg) is kg.off
    src = kg.f_dst if kg.g_src is None else kg.g_src
    w2 = kg.off[1]
    pdfs = sk.w2_source_pdfs(kg)
    assert pdfs.shape == w2[1].shape
    assert torch.equal(pdfs, src[w2[1].long()])
    # a float32 graph's cluster pair reads the whole ascending rows
    f32 = pt.ChainGraphBatch(pt.ChainGraph(_fst_of(mode)), 2,
                             device="cpu")._fact
    kg32 = fk.kernel_graph(f32)
    assert kg32.off is None and kg32.diag is None
    assert sk.operators(kg32) == (kg32.w1, kg32.w2, kg32.w1t, kg32.w2t)


def _fst_of(mode):
    return denominator_fst(num_phones=40, states_per_phone=2, seed=3,
                           forward_pdf_mode=mode)[0]


def _entries(sell):
    """{(row, col): value} of a sliced-ELL operator's nonzero entries."""
    sptr, col, val = (np.asarray(t) for t in sell)
    slen = np.diff(sptr)
    k = np.arange(len(col))
    row = np.repeat(np.arange(len(slen)), slen * fk.SLICE) * fk.SLICE \
        + k % fk.SLICE
    nz = val != 0
    return dict(zip(zip(row[nz].tolist(), col[nz].tolist()),
                    val[nz].tolist()))


@pytest.mark.parametrize("C", sk.CLUSTERS)
def test_cluster_sum_order(C):
    """cluster_sum: CTA r sums the 32-row slices r, r + C, ... in
    ascending order by the block tree, the partials in rank order from 0;
    an idle rank (past the last slice) adds 0.  At C = 1 it is
    block_sum; the pdf columns split as stream_bwd.cu's."""
    s_pad = 128                       # 4 slices: ranks 4-7 of 8 idle
    rows = fz.cluster_rows(s_pad, C)
    assert sorted(torch.cat(rows).tolist()) == list(range(s_pad))
    for r, own in enumerate(rows):
        assert own.tolist() == sorted(own.tolist())
        assert all(s // 32 % C == r for s in own.tolist())
    assert [len(o) for o in rows] == [32 * len(range(r, 4, C))
                                      for r in range(C)]
    v = torch.from_numpy(np.random.RandomState(C).rand(s_pad, 3).astype(
        np.float32) * 1e3)
    want = torch.zeros(3)
    for own in rows:
        want = want + fz.block_sum(v[own])
    assert torch.equal(fz.cluster_sum(v, C), want)
    if C == 1:
        assert torch.equal(fz.cluster_sum(v, 1), fz.block_sum(v))
    assert torch.equal(fz.block_sum(v[:0]), torch.zeros(3))
    P = 13
    cols = fz.pdf_columns(P, C)
    per = -(-P // C)
    assert [(c.start, c.stop) for c in cols] == [
        (min(P, r * per), min(P, r * per + per)) for r in range(C)]
