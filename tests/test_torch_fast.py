"""The fast mode (bfloat16 tiles, ``precision="fast"``) against the JAX package.

The port's plain fast version (``ops/factorized.forward_backward_prob_fast``)
rounds where the Pallas kernels round with bfloat16 tiles
(``pychain_tpu/ops/pallas_fact.py``): px once, the operands of the
off-diagonal products, each state's posterior mass, and the stored
streams and gamma.  It is held to those kernels in interpret mode on the
same numpy inputs.  Both sides sum in float32 but in different orders, so
a sum that differs in its last bit can round to the neighbouring
bfloat16 value (2^-8 relative): the bars below are float32's where no
such flip reaches the result at these sizes, and name the flip where one
may.

The CUDA kernels B1/B2 in the fast mode cannot run here.  An emulation
of their algorithm on the arrays they read (``KernelGraph`` in the fast
form: diagonals apart in float32, bfloat16 off-diagonal values, the
gathered vectors rounded when written, masses rounded before the pdf
lists' sums) is held to the plain version, and the shared-memory and
stream-budget arithmetic at 2-byte streams is checked by hand.
tests/test_torch_card.py compares the kernels themselves with the plain
version on the card.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu import ChainLoss as JChainLoss
from pychain_tpu.loss import chain_function_with_aux as j_aux

import pychain_tpu_torch as pt
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.ops.factorized import (forward_backward_prob_fact,
                                              forward_backward_prob_fast,
                                              initial_alpha, is_fast)
from pychain_tpu_torch.utils.testgraphs import denominator_fst, linear_fst

LEAKY = 1e-5
MODES = [("source", "identity"), ("cross", "matrix"),
         ("separate", "stream")]


def _case(mode, B=4, T=9, seed=0, num_phones=10):
    """tests/test_pallas_bf16.py's size: denominator_fst(10, 2), B=4, T=9,
    unequal lengths."""
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=mode)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, P).astype(np.float32)
    lengths = np.array([T, T - 2, 3, 1][:B], np.int32)
    return fst, x, lengths


def _fast_fact(fst, B):
    return pt.ChainGraphBatch(pt.ChainGraph(fst), B, tile_dtype="bfloat16",
                              device="cpu")._fact


def _bf(v):
    return v.to(torch.bfloat16).float()


@pytest.mark.parametrize("mode,want", MODES)
def test_plain_fast_matches_jax_pallas_bf16(mode, want):
    """objf relative <= 1e-5 and traces <= 1e-5 (float32 sums in other
    orders); gamma to 1e-5 absolute: at this size no flipped bfloat16
    rounding reaches gamma, whose entries are bfloat16 on both sides."""
    for seed in (0, 1):
        fst, x, lengths = _case(mode, seed=seed)
        B = x.shape[0]
        jbatch = JChainGraphBatch(JChainGraph(fst), B, tile_dtype="bfloat16")
        _, ref = j_aux(jnp.asarray(x), lengths, jbatch, impl="pallas")
        fa = _fast_fact(fst, B)
        assert fa.xsrc_mode == want and is_fast(fa)
        got = forward_backward_prob_fast(
            torch.exp(torch.from_numpy(x)), torch.from_numpy(lengths), fa,
            LEAKY)
        np.testing.assert_allclose(got.objf.numpy(), np.asarray(ref.objf),
                                   rtol=1e-5, atol=0)
        for name in ("gamma", "alpha_beta", "gamma_sum"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)),
                                       rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
        # gamma holds bfloat16 values
        assert torch.equal(_bf(got.gamma), got.gamma)


def _loss_case(B=3, T=8, seed=0):
    den_fst, P = denominator_fst(num_phones=10, states_per_phone=2,
                                 seed=seed)
    rng = np.random.RandomState(seed)
    lens = np.array([T, T - 3, T - 5][:B], np.int32)
    seqs = [rng.randint(0, P, size=int(n)) for n in lens]
    x = rng.randn(B, T, P).astype(np.float32)
    K = int(max(lens))
    nums = pt.ChainGraphBatch(
        [pt.ChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1, device="cpu")
    jnums = JChainGraphBatch(
        [JChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1)
    return den_fst, x, lens, nums, jnums


def test_chain_loss_fast_matches_jax_pallas():
    """ChainLoss(precision="fast") value and gradient against JAX's with
    impl="pallas" (the fast mode's Pallas kernels): value relative 1e-5,
    gradient 1e-6 absolute, as the float32 loss test
    (tests/test_torch_loss.py): the gradient is gamma (bfloat16 on both
    sides) over ~20 frames."""
    den_fst, x, lens, nums, jnums = _loss_case()
    jloss = JChainLoss(JChainGraph(den_fst), precision="fast",
                       impl="pallas")
    jval, jgrad = jax.value_and_grad(
        lambda xx: jloss(xx, jnp.asarray(lens), jnums))(jnp.asarray(x))
    loss_mod = pt.ChainLoss(pt.ChainGraph(den_fst), precision="fast",
                            device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    val = loss_mod(xt, torch.from_numpy(lens), nums)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode,want", MODES)
def test_fast_within_the_jax_bf16_budget_of_float32(mode, want):
    """tests/test_pallas_bf16.py's budget: per-sequence objf 2e-2
    relative, gamma 3e-2 relative with 5e-3 absolute, and alpha*beta and
    sum(gamma) within 2e-2 of 1 on active frames."""
    fst, x, lengths = _case(mode, seed=3)
    B = x.shape[0]
    px = torch.exp(torch.from_numpy(x))
    lens = torch.from_numpy(lengths)
    f32 = pt.ChainGraphBatch(pt.ChainGraph(fst), B, device="cpu")._fact
    ref = forward_backward_prob_fact(px, lens, f32, LEAKY)
    got = forward_backward_prob_fast(px, lens, _fast_fact(fst, B), LEAKY)
    np.testing.assert_allclose(got.objf.numpy(), ref.objf.numpy(),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.gamma.numpy(), ref.gamma.numpy(),
                               rtol=3e-2, atol=5e-3)
    assert bool(got.ok.all())
    active = torch.arange(x.shape[1])[None, :] < lens[:, None]
    for trace in (got.alpha_beta, got.gamma_sum):
        assert float((trace - 1.0).abs()[active].max()) < 2e-2
    # and it is not the float32 result: the rounding points are there
    assert float((got.gamma - ref.gamma).abs().max()) > 1e-5


def test_factorized_impl_keeps_the_xla_engine():
    """impl="factorized" on bfloat16 tiles is the XLA engine's counterpart
    (operands rounded, streams float32), not the fast mode."""
    fst, x, lengths = _case("source")
    B = x.shape[0]
    fa = _fast_fact(fst, B)
    px = torch.exp(torch.from_numpy(x))
    xla = pt.loss._run(torch.from_numpy(x), torch.from_numpy(lengths), fa,
                       LEAKY, impl="factorized")
    want = forward_backward_prob_fact(px, torch.from_numpy(lengths), fa,
                                      LEAKY)
    torch.testing.assert_close(xla.gamma, want.gamma, rtol=0, atol=0)
    fast = pt.loss._run(torch.from_numpy(x), torch.from_numpy(lengths), fa,
                        LEAKY)
    assert not torch.equal(fast.gamma, xla.gamma)


# ----------------------------------------------------------------------
# The kernels' fast form on the host
# ----------------------------------------------------------------------

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


@pytest.mark.parametrize("mode,want", MODES)
def test_fast_kernel_graph_splits_the_diagonal(mode, want):
    """B1/B2's operators in the fast mode: the off-diagonal entries of the
    ascending ones, bfloat16 values (held in float32), bank order; the
    diagonals apart, float32 and unrounded (fa's diag strata)."""
    fa = _fast_fact(denominator_fst(num_phones=40, states_per_phone=2,
                                    seed=1, forward_pdf_mode=mode)[0], 2)
    assert fa.xsrc_mode == want
    kg = fk.kernel_graph(fa)
    d1, d2 = kg.diag
    assert d1.dtype == d2.dtype == torch.float32
    torch.testing.assert_close(d1, fa.w1.diag, rtol=0, atol=0)
    torch.testing.assert_close(d2, fa.w2.diag, rtol=0, atol=0)
    assert bool((d1 != 0).any()) and not torch.equal(_bf(d1), d1)
    for i, (name, diag) in enumerate(zip(("w1", "w2", "w1t", "w2t"),
                                         (d1, d2, d1, d2))):
        op = kg.resident[i]
        assert op[2].dtype == torch.float32
        assert torch.equal(_bf(op[2]), op[2])
        full = _entries(getattr(kg, name))
        off = {k: v for k, v in full.items() if k[0] != k[1]}
        assert _entries(op) == off, name
        for (r, c), v in full.items():
            if r == c:
                assert v == float(diag[r]), (name, r)
        # each slot's gathers in bank order: no worse than ascending
        asc = fk._sell(*map(np.asarray, zip(*off)), np.asarray(
            list(off.values()), np.float32), fa.s_pad)
        assert fk.gather_wavefronts(op).sum() <= \
            fk.gather_wavefronts(asc).sum()


def _csr_mv(sell, v):
    """A sliced-ELL operator times v, in float32."""
    sptr, col, val = sell
    n_rows = (len(sptr) - 1) * fk.SLICE
    slen = (sptr[1:] - sptr[:-1]).long()
    entries = torch.arange(len(col))
    row = (torch.repeat_interleave(torch.arange(len(slen)), slen * fk.SLICE)
           * fk.SLICE + entries % fk.SLICE)
    return torch.zeros(n_rows).index_add_(0, row,
                                          val.float() * v[col.long()])


def _lists_sum(lists, c, n):
    ptr, states = (t.long() for t in lists)
    rows = torch.repeat_interleave(torch.arange(n), ptr[1:] - ptr[:-1])
    return torch.zeros(n).index_add_(0, rows, c[states])


def _emulate_fast(px, lengths, fa, c, debug):
    """csrc/fact_fwd.cu and csrc/fact_bwd.cu in the fast mode, one column
    at a time, on the arrays they read: the gathered vectors rounded when
    their owner writes them, each owner's unrounded value for the float32
    diagonal and the carry, alpha scaled by 1 / s_{t-1}, masses rounded
    unscaled before the pdf lists' sums, gamma scaled after and rounded."""
    kg = fk.kernel_graph(fa)
    w1, w2, w1t, w2t = kg.resident
    d1, d2 = kg.diag
    B, T, P = px.shape
    s_pad = fa.s_pad
    f = kg.f_dst.long()
    g = None if kg.g_src is None else kg.g_src.long()
    ad0, s0 = initial_alpha(fa, c)
    s_ys = torch.ones(B, T)
    ad_last = torch.zeros(B, s_pad)
    streams = torch.zeros(4, B, T, s_pad)   # ad, w1ad, xdst, xsrc
    for b in range(B):
        own, s_prev = ad0.clone(), s0[0]
        for t in range(int(lengths[b])):
            x = _bf(px[b, t, f])
            xs = x if g is None else _bf(px[b, t, g])
            w1a = _csr_mv(w1, _bf(own)) + d1 * own
            w2u = _csr_mv(w2, _bf(xs * own)) + d2 * (xs * own)
            a = (x * w1a + w2u) * (1.0 / s_prev)
            s_t = a.sum()
            own = a + c * s_t * fa.leaky
            streams[:, b, t] = torch.stack([_bf(own), _bf(w1a), x, xs])
            s_ys[b, t] = s_t
            s_prev = s_t
        ad_last[b] = own
    objf, tot = fk._objf(s_ys, ad_last, lengths, fa, s0)

    gamma = torch.zeros(B, T, P)
    ab = torch.full((B, T), 0.0 if debug else 1.0)
    gs = ab.clone()
    for b in range(B):
        bd = fa.final / tot[b]
        for u in range(int(lengths[b]) - 1, -1, -1):
            inv = 1.0 / (s0[0] if u == 0 else s_ys[b, u - 1])
            ad_u = ad0 if u == 0 else streams[0, b, u - 1]
            _, w1ad, xd, xs = streams[:, b, u]
            v = bd + c * (bd * fa.leaky).sum()
            xbs = xd * v
            sw = xs * (_csr_mv(w2t, _bf(v)) + d2 * v)
            bd = (_csr_mv(w1t, _bf(xbs)) + d1 * xbs + sw) * inv
            m1, m2 = xbs * w1ad, sw * ad_u
            if g is None:
                gacc = _lists_sum(kg.f_lists, _bf(m1 + m2), kg.n_pdf_lists)
            else:
                gacc = (_lists_sum(kg.f_lists, _bf(m1), kg.n_pdf_lists)
                        + _lists_sum(kg.g_lists, _bf(m2), kg.n_pdf_lists))
            gamma[b, u, :min(P, kg.n_pdf_lists)] = _bf(gacc * inv)[:P]
            if debug or u == 0:
                ab[b, u] = (ad_u * bd).sum()
                gs[b, u] = gacc.sum() * inv
    return objf, gamma, ab, gs


@pytest.mark.parametrize("mode,want", MODES)
def test_fast_kernel_algorithm_emulation_matches_plain(mode, want):
    """The emulation against the plain fast version at 40 phones (S_pad
    256): objf relative 1e-5, gamma and traces 1e-5 absolute; the sums
    run in other orders, so a rare bfloat16 rounding may flip, and at
    this size none reaches these bars."""
    fst, x, lengths = _case(mode, seed=2, num_phones=40)
    fa = _fast_fact(fst, x.shape[0])
    assert fa.xsrc_mode == want
    px = torch.exp(torch.from_numpy(x))
    lens = torch.from_numpy(lengths)
    ref = forward_backward_prob_fast(px, lens, fa, LEAKY)
    for debug in (True, False):
        objf, gamma, ab, gs = _emulate_fast(px, lens, fa, LEAKY, debug)
        want_ab, want_gs = ref.alpha_beta, ref.gamma_sum
        if not debug:
            want_ab = fk._frame0_traces(ref).alpha_beta
            want_gs = fk._frame0_traces(ref).gamma_sum
        torch.testing.assert_close(objf, ref.objf, rtol=1e-5, atol=0)
        torch.testing.assert_close(gamma, ref.gamma, rtol=0, atol=1e-5)
        torch.testing.assert_close(ab, want_ab, rtol=0, atol=1e-5)
        torch.testing.assert_close(gs, want_gs, rtol=0, atol=1e-5)


@pytest.mark.parametrize("debug", [True, False])
def test_kernel_wrapper_cpu_takes_plain_fast_path(debug):
    fst, x, lengths = _case("cross")
    fa = _fast_fact(fst, x.shape[0])
    px = torch.exp(torch.from_numpy(x))
    lens = torch.from_numpy(lengths)
    fk.reset_launch_counts()
    got = fk.forward_backward_prob_kernel(px, lens, fa, LEAKY, debug=debug)
    assert set(fk.LAUNCHES.values()) == {0}
    ref = forward_backward_prob_fast(px, lens, fa, LEAKY)
    if not debug:
        ref = fk._frame0_traces(ref)
    for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=0)


# ----------------------------------------------------------------------
# Shared memory, ring depth and stream budget at 2-byte streams
# ----------------------------------------------------------------------

def _shape(s_pad, mode, fast=True):
    dt = torch.bfloat16 if fast else torch.float32
    return types.SimpleNamespace(s_pad=s_pad, xsrc_mode=mode,
                                 w1=types.SimpleNamespace(operand_dtype=dt))


@pytest.mark.parametrize("s_pad,mode,stages", [
    (3072, "identity", 2),      # the headline graph
    (8064, "identity", 2),      # s8k: two stages at 2 bytes (one at 4)
    (8192, "identity", 2),
    (8320, "identity", 1),
    (10496, "identity", 1),
    (10624, "identity", 0),
    (3072, "stream", 2),
    (6400, "stream", 2),
    (6528, "stream", 1),
    (8192, "stream", 1),
    (8320, "stream", 0),
])
def test_fast_ring_depth_and_shared_memory(s_pad, mode, stages):
    """A stage holds 3 (identity) or 4 stream rows of 2 S_pad bytes and
    an 8-byte mbarrier, after the 4 or 5 S_pad float vectors and the
    block_sum scratch."""
    fa = _shape(s_pad, mode)
    identity = mode == "identity"
    rows, vectors = (3, 4) if identity else (4, 5)
    assert fk.stream_dtype(fa) == torch.bfloat16
    assert fk.ring_stages(fa) == stages
    for k in (0, 1, 2):
        want = (vectors * s_pad + 3 * 32 + 3) * 4 + k * (rows * s_pad * 2
                                                          + 8)
        assert fk.smem_bytes(fa, k)["fact_bwd"] == want
        # fact_fwd's own x_src vector outside identity mode
        assert fk.smem_bytes(fa, k)["fact_fwd"] == (vectors * s_pad
                                                    + 33) * 4
    assert fk.smem_bytes(fa)["fact_bwd"] <= fk.MAX_SMEM
    if stages < 2:
        assert fk.smem_bytes(fa, stages + 1)["fact_bwd"] > fk.MAX_SMEM


@pytest.mark.parametrize("mode,limit", [("identity", 14464),
                                        ("stream", 11520),
                                        ("matrix", 11520)])
def test_fast_resident_limits_are_float32s(mode, limit):
    """fact_fwd's fifth vector stays within fact_bwd's: the largest S_pad
    B1/B2 take is the same in both precisions."""
    for fast in (True, False):
        assert fk.fits_on_chip(_shape(limit, mode, fast))
        assert not fk.fits_on_chip(_shape(limit + 128, mode, fast))


def test_fast_stream_budget_counts_two_bytes():
    """The "full" mode's streams at the stream type's size
    (pallas_fact.py:871): 3 bfloat16 streams of (T, 3072, 128) hold
    T * 2,359,296 bytes, float32 twice that."""
    budget = 3 * 500 * 3072 * 128 * 2          # the headline at T=500
    fast, f32 = _shape(3072, "identity"), _shape(3072, "identity", False)
    fk.require_full_mode(500, fast, 128, budget)
    with pytest.raises(NotImplementedError, match="float32 streams"):
        fk.require_full_mode(500, f32, 128, budget)
    with pytest.raises(NotImplementedError, match="bfloat16 streams"):
        fk.require_full_mode(501, fast, 128, budget)
    fk.require_full_mode(250, f32, 128, budget)
