"""The port's generic gather engine (pychain_tpu_torch/ops/fwdbwd.py)
against the JAX package's (pychain_tpu/ops/fwdbwd.py), on every case of
tests/test_fwdbwd.py.

Both packages get the same numpy inputs and run ``impl="gather"``:
objf within 1e-5 relative, gamma within 1e-5 absolute (the port sums
each segment in a fixed tree order, JAX sequentially, so the two differ
at float32 rounding).  Where the JAX test holds its engine to the dense
float64 oracle or to path enumeration, the port is held there too, at
the JAX test's tolerances.  Also: ``graph_arrays`` field by field
against JAX's for the four batch forms, the segment plans' sums and
maxima against float64 ``index_add_`` / ``scatter_reduce`` on skewed
segment sizes (several levels, empty segments, excluded padding), and
the dispatch of a prob-domain
list batch (auto takes the gather engine, with a one-time warning).
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.loss import chain_function_with_aux as j_aux
from pychain_tpu.loss import graph_arrays as j_graph_arrays
from pychain_tpu.utils import oracle

import pychain_tpu_torch as pt
from pychain_tpu_torch import loss as pt_loss
from pychain_tpu_torch.ops.fwdbwd import GraphArrays, SegmentPlan
from pychain_tpu_torch.utils.testgraphs import (denominator_fst,
                                                linear_fst, random_fst)

OBJF_RTOL, GAMMA_ATOL = 1e-5, 1e-5
FIELDS = ("fwd_src", "fwd_dst", "fwd_pdf", "fwd_prob", "bwd_src",
          "bwd_dst", "bwd_pdf", "bwd_prob", "initial", "final", "leaky")


def rand_x(rng, B, T, P, scale=1.0):
    return (rng.randn(B, T, P) * scale).astype(np.float32)


def _list(fsts, log_domain, **kw):
    """The port's list batch and JAX's of the same FSTs."""
    ports = [pt.ChainGraph(f, log_domain=log_domain, **kw) for f in fsts]
    jaxs = [JChainGraph(f, log_domain=log_domain, **kw) for f in fsts]
    K = max(g.num_transitions for g in ports)
    S = max(g.num_states for g in ports)
    return (pt.ChainGraphBatch(ports, max_num_transitions=K,
                               max_num_states=S, device="cpu"),
            JChainGraphBatch(jaxs, max_num_transitions=K, max_num_states=S),
            ports)


def _shared(fst, B, log_domain=False, **kw):
    return (pt.ChainGraphBatch(pt.ChainGraph(fst, log_domain=log_domain,
                                             **kw), B, device="cpu"),
            JChainGraphBatch(JChainGraph(fst, log_domain=log_domain, **kw),
                             B))


def _both(x, lengths, batch, jbatch, leaky=1e-5):
    """(port, JAX) FwdBwdResults of impl="gather" on the same x."""
    _, got = pt_loss.chain_function_with_aux(
        torch.from_numpy(x), torch.from_numpy(np.asarray(lengths)), batch,
        leaky_coefficient=leaky, impl="gather")
    _, ref = j_aux(jnp.asarray(x), jnp.asarray(lengths), jbatch,
                   leaky_coefficient=leaky, impl="gather")
    return got, ref


def _same(got, ref, ok=True):
    np.testing.assert_allclose(got.objf.numpy(), np.asarray(ref.objf),
                               rtol=OBJF_RTOL)
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(ref.gamma),
                               rtol=0, atol=GAMMA_ATOL)
    for name in ("alpha_beta", "gamma_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    if ok:
        assert bool(got.ok.all())


# ----------------------------------------------------------------------
# Log domain (numerator path)
# ----------------------------------------------------------------------

def test_log_domain_linear_vs_jax_and_oracle():
    rng = np.random.RandomState(0)
    pdfs = [[0, 2, 1, 3], [1, 1, 2, 0], [3, 0, 1, 2]]
    batch, jbatch, graphs = _list([linear_fst(p) for p in pdfs], True)
    x = rand_x(rng, 3, 6, 4)
    lengths = np.array([4, 4, 4], np.int32)
    got, ref = _both(x, lengths, batch, jbatch)
    _same(got, ref)
    ref_objf, ref_gamma = oracle.oracle_objf_log(x, lengths, graphs)
    np.testing.assert_allclose(got.objf.numpy(), ref_objf, rtol=2e-4)
    np.testing.assert_allclose(got.gamma.numpy(), ref_gamma, rtol=2e-3,
                               atol=2e-6)


def test_log_domain_unequal_lengths_random_graphs():
    rng = np.random.RandomState(1)
    B, T, P = 5, 9, 6
    batch, jbatch, graphs = _list(
        [random_fst(num_states=4 + b, num_pdfs=P, seed=b) for b in range(B)],
        True)
    lengths = np.array([9, 7, 5, 3, 1], np.int32)
    x = rand_x(rng, B, T, P)
    got, ref = _both(x, lengths, batch, jbatch)
    _same(got, ref, ok=False)
    ref_objf, ref_gamma = oracle.oracle_objf_log(x, lengths, graphs)
    np.testing.assert_allclose(got.objf.numpy(), ref_objf, rtol=2e-4)
    np.testing.assert_allclose(got.gamma.numpy(), ref_gamma, rtol=2e-3,
                               atol=2e-6)
    gam = got.gamma.numpy()
    for b in range(B):
        assert np.all(gam[b, lengths[b]:] == 0.0)


def test_log_domain_brute_force_tiny():
    rng = np.random.RandomState(2)
    fst = random_fst(num_states=3, num_pdfs=3, seed=5)
    batch, jbatch, (g,) = _list([fst], True)
    x = rand_x(rng, 1, 4, 3)
    lengths = np.array([4], np.int32)
    got, ref = _both(x, lengths, batch, jbatch)
    _same(got, ref, ok=False)
    brute = oracle.brute_force_objf_log(x[0].astype(np.float64), 4, g)
    np.testing.assert_allclose(float(got.objf[0]), brute, rtol=2e-4)


def test_log_domain_unsorted_batch():
    rng = np.random.RandomState(3)
    B, T, P = 4, 8, 5
    batch, jbatch, graphs = _list(
        [random_fst(num_states=5, num_pdfs=P, seed=10 + b) for b in range(B)],
        True)
    lengths = np.array([3, 8, 5, 6], np.int32)   # deliberately unsorted
    x = rand_x(rng, B, T, P)
    got, ref = _both(x, lengths, batch, jbatch)
    _same(got, ref, ok=False)
    ref_objf, ref_gamma = oracle.oracle_objf_log(x, lengths, graphs)
    np.testing.assert_allclose(got.objf.numpy(), ref_objf, rtol=2e-4)
    np.testing.assert_allclose(got.gamma.numpy(), ref_gamma, rtol=2e-3,
                               atol=2e-6)


def test_log_domain_infeasible_sequence():
    """A linear graph at a length it cannot take: objf not finite (NaN:
    the log engine's carry is -inf - -inf) and ok False in both
    packages; the other sequence unharmed."""
    rng = np.random.RandomState(11)
    batch, jbatch, _ = _list([linear_fst([1, 2, 3]),
                              random_fst(num_states=5, num_pdfs=4, seed=3)],
                             True)
    x = rand_x(rng, 2, 6, 4)
    lengths = np.array([5, 6], np.int32)
    got, ref = _both(x, lengths, batch, jbatch)
    assert not np.isfinite(np.asarray(ref.objf)[0])
    assert not torch.isfinite(got.objf[0]) and not bool(got.ok[0])
    assert bool(got.ok[1]) and bool(np.asarray(ref.ok)[1])
    np.testing.assert_allclose(got.objf[1:].numpy(),
                               np.asarray(ref.objf)[1:], rtol=OBJF_RTOL)
    np.testing.assert_allclose(got.gamma[1:].numpy(),
                               np.asarray(ref.gamma)[1:], atol=GAMMA_ATOL)


# ----------------------------------------------------------------------
# Probability domain with leaky HMM (denominator path)
# ----------------------------------------------------------------------

def test_prob_domain_vs_jax_and_oracle():
    rng = np.random.RandomState(4)
    B, T, P = 3, 7, 6
    fst = random_fst(num_states=6, num_pdfs=P, seed=21)
    batch, jbatch = _shared(fst, B)
    lengths = np.array([7, 5, 2], np.int32)
    x = rand_x(rng, B, T, P)
    got, ref = _both(x, lengths, batch, jbatch)
    _same(got, ref)
    ref_objf, ref_gamma = oracle.oracle_objf_prob(
        x, lengths, [JChainGraph(fst)] * B, 1e-5)
    np.testing.assert_allclose(got.objf.numpy(), ref_objf, rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got.gamma.numpy(), ref_gamma, rtol=1e-3,
                               atol=1e-6)


def test_prob_domain_batched_list_matches_shared():
    """The same graph broadcast and as a list of copies: the port's two
    batches agree (1e-6), and each matches JAX's of its form."""
    rng = np.random.RandomState(5)
    B, T, P = 4, 6, 5
    fst = random_fst(num_states=5, num_pdfs=P, seed=31)
    shared, jshared = _shared(fst, B)
    listed, jlisted, _ = _list([fst] * B, False)
    assert shared.shared and not listed.shared
    lengths = np.array([6, 6, 4, 3], np.int32)
    x = rand_x(rng, B, T, P)
    a, ja = _both(x, lengths, shared, jshared)
    b, jb = _both(x, lengths, listed, jlisted)
    _same(a, ja)
    _same(b, jb)
    np.testing.assert_allclose(a.objf.numpy(), b.objf.numpy(), rtol=1e-6)
    np.testing.assert_allclose(a.gamma.numpy(), b.gamma.numpy(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("initial_mode", ["fst", "leaky"])
@pytest.mark.parametrize("final_mode", ["fst", "ones"])
def test_prob_domain_leaky_modes(initial_mode, final_mode):
    rng = np.random.RandomState(6)
    P = 5
    fst = random_fst(num_states=6, num_pdfs=P, seed=41)
    batch, jbatch = _shared(fst, 2, initial_mode=initial_mode,
                            final_mode=final_mode)
    x = rand_x(rng, 2, 5, P)
    lengths = np.array([5, 4], np.int32)
    got, ref = _both(x, lengths, batch, jbatch)
    _same(got, ref, ok=False)
    ref_objf, ref_gamma = oracle.oracle_objf_prob(
        x, lengths, [JChainGraph(fst, initial_mode=initial_mode,
                                 final_mode=final_mode)] * 2, 1e-5)
    np.testing.assert_allclose(got.objf.numpy(), ref_objf, rtol=1e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got.gamma.numpy(), ref_gamma, rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("leaky", [0.0, 1e-5, 0.1])
def test_prob_domain_list_of_distinct_graphs(leaky):
    """Per-sequence leaky-HMM graphs of different sizes (the batch only
    the gather engine serves), at three leaky coefficients."""
    rng = np.random.RandomState(12)
    B, T, P = 4, 7, 6
    batch, jbatch, _ = _list(
        [random_fst(num_states=4 + 2 * b, num_pdfs=P, seed=50 + b)
         for b in range(B)], False)
    lengths = np.array([7, 3, 6, 5], np.int32)
    got, ref = _both(rand_x(rng, B, T, P), lengths, batch, jbatch, leaky)
    _same(got, ref, ok=False)


# ----------------------------------------------------------------------
# Invariants (the reference's native runtime checks)
# ----------------------------------------------------------------------

def test_alpha_beta_invariants_every_frame():
    rng = np.random.RandomState(7)
    B, T, P = 3, 10, 6
    batch, jbatch = _shared(random_fst(num_states=7, num_pdfs=P, seed=51), B)
    lengths = np.array([10, 6, 3], np.int32)
    got, ref = _both(rand_x(rng, B, T, P), lengths, batch, jbatch)
    _same(got, ref)
    ab, gs = got.alpha_beta.numpy(), got.gamma_sum.numpy()
    for b in range(B):
        for t in range(int(lengths[b])):
            assert abs(ab[b, t] - 1.0) < 1e-3, (b, t, ab[b, t])
            assert abs(gs[b, t] - 1.0) < 1e-3, (b, t, gs[b, t])


def test_gradient_is_gamma_and_scales():
    rng = np.random.RandomState(8)
    B, T, P = 2, 5, 4
    batch, _ = _shared(random_fst(num_states=5, num_pdfs=P, seed=61), B)
    lengths = torch.tensor([5, 3])
    x = torch.from_numpy(rand_x(rng, B, T, P)).requires_grad_(True)
    pt_loss.chain_function(x, lengths, batch, impl="gather").backward()
    _, res = pt_loss.chain_function_with_aux(x.detach(), lengths, batch,
                                             impl="gather")
    torch.testing.assert_close(x.grad, res.gamma, rtol=1e-6, atol=0)
    x.grad = None
    (2.5 * pt_loss.chain_function(x, lengths, batch,
                                  impl="gather")).backward()
    torch.testing.assert_close(x.grad, 2.5 * res.gamma, rtol=2e-4, atol=0)


def test_finite_difference_gradient():
    rng = np.random.RandomState(9)
    B, T, P = 1, 4, 3
    batch, _ = _shared(random_fst(num_states=4, num_pdfs=P, seed=71), B)
    lengths = torch.tensor([4])
    x = rand_x(rng, B, T, P).astype(np.float64)

    def f(xx):
        return float(pt_loss.chain_function(
            torch.from_numpy(xx.astype(np.float32)), lengths, batch,
            impl="gather"))

    xt = torch.from_numpy(x.astype(np.float32)).requires_grad_(True)
    pt_loss.chain_function(xt, lengths, batch, impl="gather").backward()
    g = xt.grad.numpy()
    eps = 1e-2
    for (b, t, p) in [(0, 0, 0), (0, 2, 1), (0, 3, 2)]:
        xp = x.copy()
        xp[b, t, p] += eps
        xm = x.copy()
        xm[b, t, p] -= eps
        fd = (f(xp) - f(xm)) / (2 * eps)
        assert abs(fd - g[b, t, p]) < 5e-3, (b, t, p, fd, g[b, t, p])


@pytest.mark.parametrize("kind", ["sign", "onehot"])
def test_saturated_logits_stay_finite(kind):
    """Value and gradient finite at the clamp's extremes: random +-30,
    and one pdf at +30 with the rest at -30 a frame; equal to JAX's."""
    rng = np.random.RandomState(0)
    fst, P = denominator_fst(num_phones=12, states_per_phone=2, seed=0)
    B, T = 3, 20
    batch, jbatch = _shared(fst, B)
    lengths = np.array([20, 15, 9], np.int32)
    if kind == "sign":
        x = np.sign(rng.randn(B, T, P)).astype(np.float32) * 30.0
    else:
        x = np.full((B, T, P), -30.0, np.float32)
        for b in range(B):
            x[b, np.arange(T), rng.randint(0, P, size=T)] = 30.0
    xt = torch.from_numpy(x).requires_grad_(True)
    o = pt_loss.chain_function(xt, torch.from_numpy(lengths), batch,
                               impl="gather")
    o.backward()
    assert np.isfinite(float(o.detach()))
    assert bool(torch.isfinite(xt.grad).all())
    jo = jax.value_and_grad(
        lambda v: pt_loss_j(v, lengths, jbatch))(jnp.asarray(x))[0]
    np.testing.assert_allclose(float(o), float(jo), rtol=OBJF_RTOL)


def pt_loss_j(x, lengths, jbatch):
    from pychain_tpu import chain_function as j_chain_function
    return j_chain_function(x, jnp.asarray(lengths), jbatch, impl="gather")


# ----------------------------------------------------------------------
# The arrays, the plans, the dispatch
# ----------------------------------------------------------------------

def _forms():
    rng = np.random.RandomState(13)
    den, _ = denominator_fst(num_phones=5, states_per_phone=2, seed=1)
    lists = [random_fst(num_states=4 + b, num_pdfs=6, seed=b)
             for b in range(3)]
    return {
        "shared prob": _shared(den, 3),
        "shared log": _shared(den, 3, log_domain=True),
        "list prob": _list(lists, False)[:2],
        "list log": _list(lists + [linear_fst(rng.randint(0, 6, size=4))],
                          True)[:2],
    }


@pytest.mark.parametrize("form", ["shared prob", "shared log", "list prob",
                                  "list log"])
def test_graph_arrays_match_jax(form):
    batch, jbatch = _forms()[form]
    ga = pt_loss.graph_arrays(batch)
    jga = j_graph_arrays(jbatch)
    assert ga is pt_loss.dispatch_arrays(batch, "gather")
    assert ga.shared == jga.shared and ga.device.type == "cpu"
    for f in FIELDS:
        a, b = getattr(ga, f), getattr(jga, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert tuple(a.shape) == tuple(b.shape), f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), f)


@pytest.mark.parametrize("sizes", [[1, 1, 1, 1], [3, 0, 70, 1, 5],
                                   [1200, 2, 0, 33], [40] * 6])
def test_segment_plan_sums_and_maxima(sizes):
    """Segments of the given sizes in two rows (the second reversed),
    shuffled, with a tenth of the values marked invalid: sums within
    float32 rounding of float64 index_add_, maxima exact, empty
    segments 0 and -inf; two applications bit-identical."""
    rng = np.random.RandomState(len(sizes))
    M = len(sizes)
    rows = []
    for r in range(2):
        seg = np.concatenate([np.full(n, s) for s, n in
                              enumerate(sizes[::1 if r == 0 else -1])])
        rows.append(rng.permutation(seg))
    seg = np.stack(rows)
    valid = rng.rand(*seg.shape) > 0.1
    plan = SegmentPlan(seg, valid, M)
    v = torch.from_numpy(rng.randn(3, seg.size).astype(np.float32))
    got = plan.apply(v).view(3, 2, M)
    mx = plan.apply(v, "amax").view(3, 2, M)
    assert torch.equal(plan.apply(v).view(3, 2, M), got)
    vv = v.view(3, 2, -1).double()
    for r in range(2):
        keep = torch.from_numpy(valid[r])
        idx = torch.from_numpy(seg[r])[keep]
        want = torch.zeros(3, M, dtype=torch.float64).index_add_(
            1, idx, vv[:, r, keep])
        torch.testing.assert_close(got[:, r].double(), want, rtol=1e-5,
                                   atol=1e-5)
        wmax = torch.full((3, M), float("-inf"), dtype=torch.float64)
        wmax = wmax.scatter_reduce(1, idx.expand(3, -1), vv[:, r, keep],
                                   "amax")
        torch.testing.assert_close(mx[:, r].double(), wmax, rtol=0, atol=0)


def test_prob_list_auto_is_gather_with_a_warning(monkeypatch):
    monkeypatch.setattr(pt_loss, "_gather_fallback_warned", False)
    batch, jbatch, _ = _list([random_fst(num_states=5, num_pdfs=4, seed=s)
                              for s in range(2)], False)
    with pytest.warns(RuntimeWarning, match="generic gather engine"):
        g = pt_loss.dispatch_arrays(batch)
    assert isinstance(g, GraphArrays) and g.leaky is not None
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # once only
        pt_loss.dispatch_arrays(batch)
    rng = np.random.RandomState(14)
    x = rand_x(rng, 2, 5, 4)
    lengths = np.array([5, 4], np.int32)
    _, got = pt_loss.chain_function_with_aux(torch.from_numpy(x),
                                             lengths, batch)
    _, ref = j_aux(jnp.asarray(x), jnp.asarray(lengths), jbatch,
                   impl="gather")
    _same(got, ref, ok=False)
    with pytest.raises(ValueError, match="requires a list batch"):
        pt_loss.dispatch_arrays(batch, "semiring")


def test_reorder_rebuilds_the_gather_arrays():
    rng = np.random.RandomState(15)
    fsts = [random_fst(num_states=4 + b, num_pdfs=5, seed=b)
            for b in range(3)]
    batch, _, _ = _list(fsts, False)
    before = batch.graph_arrays()
    batch.reorder([2, 0, 1])
    after = batch.graph_arrays()
    assert after is not before
    moved, _, _ = _list([fsts[2], fsts[0], fsts[1]], False)
    x = rand_x(rng, 3, 6, 5)
    lengths = np.array([6, 5, 4], np.int32)
    a = pt_loss.chain_function(torch.from_numpy(x), lengths, batch)
    b = pt_loss.chain_function(torch.from_numpy(x), lengths, moved)
    assert float(a) == float(b)
