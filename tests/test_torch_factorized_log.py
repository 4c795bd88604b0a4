"""Shared log-domain graphs on the factorized engines (``log_semantics``),
against the JAX package, on every case of tests/test_factorized_log.py.

A shared log-domain graph is the same transition matrix with log
weights: exp'd (shifted into float32's exp-safe band where they lie
outside it) the factorized engines serve it in normalized-linear form,
with leaky 0 and dead sequences guarded to the log engines' contract
(objf -inf, gamma 0, ok False).  Held here:

* the broadcast constructor builds ``_fact`` with ``log_semantics``, and
  its tiles, diagonals, dense blocks, state vectors and ``log_shifts``
  equal the JAX package's bit for bit, with and without a shift;
* factorized-log against the gather engine (objf rtol 1e-5, gamma rtol
  1e-4) in the port and in JAX, and against JAX's factorized-log;
* every tier's plain version (engine "pallas" and "stream": on the CPU
  the plain versions of B1/B2 and B3/B4) against the JAX tiers in
  interpret mode;
* leaky forced to 0; the infeasible contract; auto prefers ``_fact``
  (its kernel tier by ``den_engine``), and the closed form for a linear
  graph;
* a graph re-centered by -120 nats: objf = unshifted + (-120 L);
* a graph whose weights spread past 160 nats: the warning, no ``_fact``,
  the semiring engine under auto, equal to JAX's gather fallback;
* the fast mode (bfloat16 tiles) against JAX's Pallas kernels with
  bfloat16 tiles in interpret mode, within test_torch_fast.py's 1e-5;
* ``convert.factorized_from_numpy`` of JAX's log_semantics arrays;
* ``fact_kernels``' card path at leaky 0 on the emulated kernels of
  tests/test_torch_stream_modes.py: the plain version's numbers (bit for
  bit in the fast mode); a dead column (a graph entered through a chain
  of states, a length shorter than it) guarded and contained: the other
  columns equal a batch without it bit for bit;
* viterbi_align and the dispatch of a shared log-domain batch unchanged
  by the factorized form built beside it.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu import viterbi_align as j_viterbi
from pychain_tpu.loss import chain_function_with_aux as j_aux

import pychain_tpu_torch as pt
from pychain_tpu_torch import loss as pt_loss
from pychain_tpu_torch.convert import factorized_from_numpy
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.ops import factorized as pf
from pychain_tpu_torch.ops.factorized import FactorizedArrays
from pychain_tpu_torch.ops.linear import LinearArrays
from pychain_tpu_torch.ops.semiring import SemiringArrays
from pychain_tpu_torch.utils.testgraphs import (denominator_fst,
                                                entry_chain_fst, linear_fst,
                                                random_fst)

from test_torch_stream_modes import H100, _emu_bwd, _emu_fwd

WS = ("diag", "dense", "tiles", "rows", "cols")


def _graphs(fst, shift=0.0):
    """The port's and JAX's log-domain ChainGraph of ``fst``, every arc
    weight moved by ``shift`` nats."""
    out = []
    for cls in (pt.ChainGraph, JChainGraph):
        g = cls(fst, log_domain=True)
        if shift:
            g.forward_transition_probs = g.forward_transition_probs + \
                np.float32(shift)
            g.backward_transition_probs = g.backward_transition_probs + \
                np.float32(shift)
        out.append(g)
    return out


def _batches(fst, B, shift=0.0, tile_dtype=None):
    g, jg = _graphs(fst, shift)
    return (pt.ChainGraphBatch(g, B, tile_dtype=tile_dtype, device="cpu"),
            JChainGraphBatch(jg, B, tile_dtype=tile_dtype))


def _random(B=3, S=9, P=6, seed=5):
    return _batches(random_fst(num_states=S, num_pdfs=P, seed=seed), B)


def _den(B=3, seed=1, shift=0.0, tile_dtype=None, num_phones=6):
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed)
    return _batches(fst, B, shift, tile_dtype) + (P,)


def _x(B, T, P, seed):
    return np.random.RandomState(seed).randn(B, T, P).astype(np.float32)


def _aux(x, lengths, batch, **kw):
    return pt_loss.chain_function_with_aux(torch.from_numpy(x),
                                           torch.from_numpy(lengths), batch,
                                           **kw)[1]


def _jaux(x, lengths, jbatch, **kw):
    return j_aux(jnp.asarray(x), jnp.asarray(lengths), jbatch, **kw)[1]


def _close(got, ref, objf_rtol=1e-5, gamma_rtol=1e-4):
    np.testing.assert_allclose(np.asarray(got.objf), np.asarray(ref.objf),
                               rtol=objf_rtol, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.gamma), np.asarray(ref.gamma),
                               rtol=gamma_rtol, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.ok), np.asarray(ref.ok))


# ----------------------------------------------------------------------
# The arrays
# ----------------------------------------------------------------------

def test_broadcast_log_builds_fact():
    batch, _ = _random()
    assert isinstance(batch._fact, FactorizedArrays)
    assert batch._fact.log_semantics and batch._fact.log_shifts is None
    assert batch._fact.device.type == "cpu"


@pytest.mark.parametrize("shift", [0.0, -120.0, 95.0])
@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_tiles_and_shifts_equal_jax(shift, tile_dtype):
    batch, jbatch, _ = _den(shift=shift, tile_dtype=tile_dtype)
    fa, jfa = batch._fact, jbatch._fact
    assert jfa.log_semantics and fa.log_semantics
    if shift == 0.0:
        assert fa.log_shifts is None and jfa.log_shifts is None
    else:
        np.testing.assert_array_equal(fa.log_shifts.numpy(),
                                      np.asarray(jfa.log_shifts))
        assert float(fa.log_shifts[0]) != 0.0
    for name in ("w1", "w2", "w1t", "w2t", "e_f", "e_g", "e_ft", "e_gt"):
        w, jw = getattr(fa, name), getattr(jfa, name)
        for f in WS:
            a, b = getattr(w, f), getattr(jw, f)
            assert (a is None) == (b is None), (name, f)
            if a is not None:
                np.testing.assert_array_equal(
                    a.float().numpy(), np.asarray(b, np.float32),
                    err_msg=f"{name}.{f}")
    for f in ("initial", "final", "f_dst", "g_src"):
        np.testing.assert_array_equal(getattr(fa, f).numpy(),
                                      np.asarray(getattr(jfa, f)), f)
    assert fa.xsrc_mode == jfa.xsrc_mode


def test_convert_carries_log_semantics():
    batch, jbatch, P = _den(shift=-120.0)
    conv = factorized_from_numpy(jbatch._fact, device="cpu")
    assert conv.log_semantics
    np.testing.assert_array_equal(conv.log_shifts.numpy(),
                                  batch._fact.log_shifts.numpy())
    x = _x(3, 6, P, 3)
    lengths = np.array([6, 4, 2], np.int32)
    a = _aux(x, lengths, conv)
    b = _aux(x, lengths, batch)
    for name in ("objf", "gamma", "ok"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ----------------------------------------------------------------------
# Factorized-log against gather and against JAX
# ----------------------------------------------------------------------

def test_factorized_log_matches_gather():
    B, T, P = 3, 8, 6
    batch, jbatch = _random(B, P=P)
    x = _x(B, T, P, 0)
    lengths = np.array([8, 5, 3], np.int32)
    rg = _aux(x, lengths, batch, impl="gather")
    rf = _aux(x, lengths, batch, impl="factorized")
    _close(rf, rg)
    assert bool(rf.ok.all())
    _close(rf, _jaux(x, lengths, jbatch, impl="factorized"))
    _close(rg, _jaux(x, lengths, jbatch, impl="gather"), gamma_rtol=1e-5)
    xt = torch.from_numpy(x)
    grads = []
    for impl in ("gather", "factorized"):
        v = xt.clone().requires_grad_(True)
        pt_loss.chain_function(v, lengths, batch, impl=impl).backward()
        grads.append(v.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("engine", ["pallas", "stream"])
def test_tiers_match_jax_tiers(engine):
    """On the CPU the "pallas" and "stream" tiers compute B1/B2's and
    B3/B4's plain versions; each against JAX's tier in interpret mode and
    against the port's XLA-engine counterpart."""
    B, T = 2, 6
    batch, jbatch, P = _den(B)
    fa = batch._fact
    assert fk.supports(fa) and pt_loss.den_engine(fa) == "pallas"
    x = _x(B, T, P, 1)
    lengths = np.array([6, 4], np.int32)
    ref = _aux(x, lengths, batch, impl="factorized")
    got = _aux(x, lengths, dataclasses.replace(fa, engine=engine))
    _close(got, ref)
    jgot = _jaux(x, lengths, dataclasses.replace(jbatch._fact,
                                                 engine=engine))
    _close(got, jgot)


def test_leaky_is_forced_to_zero():
    B, T, P = 2, 6, 6
    batch, _ = _random(B, P=P, seed=9)
    x = torch.from_numpy(_x(B, T, P, 2))
    lengths = np.array([6, 6], np.int32)
    a = pt_loss.chain_function(x, lengths, batch, leaky_coefficient=0.3,
                               impl="factorized")
    b = pt_loss.chain_function(x, lengths, batch, leaky_coefficient=1e-5,
                               impl="factorized")
    g = pt_loss.chain_function(x, lengths, batch, leaky_coefficient=0.3,
                               impl="gather")
    assert float(a) == float(b)
    np.testing.assert_allclose(float(a), float(g), rtol=1e-5)


def test_infeasible_contract():
    """Dead sequences: objf -inf, gamma 0, ok False, finite gradients,
    as in the JAX package."""
    P = 5
    batch, jbatch = _batches(linear_fst([1, 2, 3, 4, 0, 2]), 2)
    assert isinstance(batch._linear, LinearArrays)
    x = _x(2, 8, P, 3)
    lengths = np.array([6, 4], np.int32)          # row 1 infeasible
    rf = _aux(x, lengths, batch, impl="factorized")
    rg = _aux(x, lengths, batch, impl="gather")
    assert rf.objf[1] == -np.inf
    assert not bool(rf.ok[1]) and bool(rf.ok[0])
    assert float(rf.gamma[1].abs().max()) == 0.0
    np.testing.assert_allclose(rf.objf[0].numpy(), rg.objf[0].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(rf.gamma[0].numpy(), rg.gamma[0].numpy(),
                               rtol=1e-4, atol=1e-6)
    jf = _jaux(x, lengths, jbatch, impl="factorized")
    np.testing.assert_array_equal(rf.objf.numpy()[1:],
                                  np.asarray(jf.objf)[1:])
    _close(rf, jf)
    v = torch.from_numpy(x).requires_grad_(True)
    pt_loss.chain_function(v, lengths, batch, impl="factorized").backward()
    assert bool(torch.isfinite(v.grad).all())


def test_out_of_band_shift_is_undone():
    """Every arc moved by -120 nats: exp would underflow float32, so the
    arcs are re-centered and log_shifts adds -120 L back: objf equals
    the unshifted objf - 120 L, gamma equal; both as JAX's."""
    B, T = 3, 7
    plain, _, P = _den(B)
    moved, jmoved, _ = _den(B, shift=-120.0)
    assert moved._fact.log_shifts is not None
    x = _x(B, T, P, 4)
    lengths = np.array([7, 5, 2], np.int32)
    a = _aux(x, lengths, plain)
    b = _aux(x, lengths, moved)
    np.testing.assert_allclose(b.objf.numpy(),
                               a.objf.numpy() - 120.0 * lengths, rtol=1e-5)
    np.testing.assert_allclose(b.gamma.numpy(), a.gamma.numpy(), rtol=1e-4,
                               atol=1e-6)
    _close(b, _jaux(x, lengths, jmoved, impl="factorized"))


def test_out_of_spread_warns_and_runs_the_semiring_engine():
    """Weights spanning more than 160 nats (one arc of a state with
    others 200 nats down): no factorized form, a warning, auto takes the
    semiring engine (its plain version here); equal to JAX's fallback
    and to the port's gather engine.  (The semiring engine scales each
    frame's arc weights by their largest and carries them in float32,
    as the JAX package's semiring kernels do, so an arc 87 nats below
    its frame's best weighs 0 there: on a graph where every path takes
    such an arc the loss is -inf, and impl="gather" is the exact
    engine.)"""
    fst = random_fst(num_states=7, num_pdfs=5, seed=8)
    g, jg = _graphs(fst)
    src = g.forward_transitions[:, 0]
    k = int(np.flatnonzero(np.bincount(src)[src] >= 2)[-1])
    for h in (g, jg):
        h.forward_transition_probs = h.forward_transition_probs.copy()
        h.forward_transition_probs[k] -= 200.0
        h.backward_transition_probs = h.backward_transition_probs.copy()
        h.backward_transition_probs[
            np.all(h.backward_transitions == h.forward_transitions[k],
                   axis=1)] -= 200.0
    with pytest.warns(RuntimeWarning, match="160 nats"):
        batch = pt.ChainGraphBatch(g, 3, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jbatch = JChainGraphBatch(jg, 3)
    assert batch._fact is None and batch._linear is None
    rows = pt_loss.dispatch_arrays(batch)
    assert isinstance(rows, SemiringArrays) and rows.rows == 3
    assert pt_loss.dispatch_arrays(batch, "semiring") is rows
    with pytest.raises(ValueError, match="factorized impl"):
        pt_loss.dispatch_arrays(batch, "factorized")
    x = _x(3, 6, 5, 5)
    lengths = np.array([6, 5, 3], np.int32)
    got = _aux(x, lengths, batch)
    _close(got, _aux(x, lengths, batch, impl="gather"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _close(got, _jaux(x, lengths, jbatch))


# ----------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------

def test_auto_prefers_fact():
    """Auto serves a shared cyclic log-domain batch through its
    factorized form: the kernel tier den_engine gives it (a random
    graph has residual arcs: "xla"; a denominator topology: B1/B2), the
    semiring arrays not built; a linear one through its closed form."""
    batch, _ = _random()
    g = pt_loss.dispatch_arrays(batch, "auto")
    assert isinstance(g, FactorizedArrays) and g.log_semantics
    assert g is batch._fact and pt_loss.resolved_engine(g) == "xla"
    assert batch._semiring is None
    den, _, _ = _den()
    g = pt_loss.dispatch_arrays(den)
    assert g.log_semantics and pt_loss.resolved_engine(g) == "pallas"
    lin, _ = _batches(linear_fst([1, 2, 3]), 2)
    assert isinstance(pt_loss.dispatch_arrays(lin), LinearArrays)
    assert pt_loss.dispatch_arrays(lin, "factorized") is lin._fact


def test_viterbi_is_unchanged_by_the_factorized_form():
    """viterbi_align and the dispatch after it: the batch's arc-id row
    (built by viterbi_align) does not pull the loss off _fact, and the
    alignment equals JAX's."""
    fst, P = denominator_fst(num_phones=6, states_per_phone=2, seed=2)
    batch, jbatch = _batches(fst, 3)
    x = _x(3, 9, P, 6)
    lengths = np.array([9, 6, 4], np.int32)
    res = pt.viterbi_align(torch.from_numpy(x), lengths, batch)
    ref = j_viterbi(jnp.asarray(x), lengths, jbatch, sweep="scatter")
    for name in ("pdfs", "states", "ok"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert batch._semiring is not None
    assert pt_loss.dispatch_arrays(batch) is batch._fact


# ----------------------------------------------------------------------
# The fast mode and the kernels' host code
# ----------------------------------------------------------------------

def test_fast_mode_matches_jax_bf16_pallas():
    """precision="fast" on a shared log-domain graph: the plain fast
    version (B1/B2 fast's, what the CPU runs) against JAX's Pallas
    kernels with bfloat16 tiles in interpret mode, within
    test_torch_fast.py's 1e-5; against float32 within JAX's bfloat16
    budget."""
    B, T = 3, 8
    batch, jbatch, P = _den(B, seed=3, tile_dtype="bfloat16")
    f32, _, _ = _den(B, seed=3)
    assert pf.is_fast(batch._fact) and batch._fact.log_semantics
    x = _x(B, T, P, 7)
    lengths = np.array([8, 6, 1], np.int32)
    got = _aux(x, lengths, batch)
    ref = _jaux(x, lengths, jbatch, impl="pallas")
    np.testing.assert_allclose(got.objf.numpy(), np.asarray(ref.objf),
                               rtol=1e-5)
    for name in ("gamma", "alpha_beta", "gamma_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    base = _aux(x, lengths, f32)
    np.testing.assert_allclose(got.objf.numpy(), base.objf.numpy(),
                               rtol=2e-2)
    np.testing.assert_allclose(got.gamma.numpy(), base.gamma.numpy(),
                               rtol=3e-2, atol=5e-3)


def _dead_case(tile_dtype):
    """A shared log-domain denominator behind a chain of 4 states (no
    path shorter than 5 frames)."""
    fst, P = denominator_fst(num_phones=8, states_per_phone=2, seed=4)
    batch = pt.ChainGraphBatch(
        pt.ChainGraph(entry_chain_fst(fst, 4), log_domain=True), 4,
        tile_dtype=tile_dtype, device="cpu")
    return batch, torch.from_numpy(_x(4, 9, P, 8)), P


@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_card_path_at_leaky_zero(monkeypatch, tile_dtype):
    """fact_fwd + fact_bwd on emulated kernels at leaky 0 (live columns:
    the emulations take no NaN): the plain version's numbers, bit for bit
    in the fast mode, whose leaky add is an exact 0."""
    batch, x, P = _dead_case(tile_dtype)
    fa = batch._fact
    assert fk.supports(fa) and fa.log_semantics
    px, lens = torch.exp(x), torch.tensor([9, 6, 7, 5], dtype=torch.int32)
    monkeypatch.setattr(fk, "_fwd_launch", _emu_fwd)
    monkeypatch.setattr(fk, "_bwd_launch", _emu_bwd)
    monkeypatch.setattr(fk, "_card_props", lambda device: H100)
    ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = fk.fact_fwd(
        px, lens, fa, 0.0)
    objf, tot = fk._objf(s_ys, ad_last, lens, fa, s0)
    outs = fk.fact_bwd(lens, fa, 0.0, ad_ys, w1ad, xdst, xsrc, s_ys, ad0,
                       s0, tot, P, True)
    got = fk._package_result(objf, *outs)
    ref = pf.forward_backward_prob_mode(px, lens, fa, 0.0, "full")
    assert bool(got.ok.all())
    if tile_dtype:
        for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
    else:
        torch.testing.assert_close(got.objf, ref.objf, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got.gamma, ref.gamma, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_dead_column_is_guarded_and_contained(tile_dtype):
    """Through the loss (auto: B1/B2's tier, its plain version here) a
    column of length 3 on that graph is dead: objf -inf, gamma 0, ok
    False, and every other column equals the same batch without it (bit
    for bit in the fast mode); JAX's factorized-log agrees."""
    batch, x, P = _dead_case(tile_dtype)
    assert pt_loss.resolved_engine(pt_loss.dispatch_arrays(batch)) == \
        "pallas"
    lens = torch.tensor([9, 3, 7, 5])
    got = pt_loss.chain_function_with_aux(x, lens, batch)[1]
    assert got.objf[1] == -np.inf and not bool(got.ok[1])
    assert float(got.gamma[1].abs().sum()) == 0.0
    live = [0, 2, 3]
    alone_batch = pt.ChainGraphBatch(batch._graph, 3, tile_dtype=tile_dtype,
                                     device="cpu")
    alone = pt_loss.chain_function_with_aux(x[live], lens[live],
                                            alone_batch)[1]
    assert torch.equal(got.ok[live], alone.ok)
    if tile_dtype:
        for name in ("objf", "gamma"):
            assert torch.equal(getattr(got, name)[live],
                               getattr(alone, name)), name
    else:
        # the float32 plain version's products are batched matmuls, whose
        # rounding may follow the batch's width (the kernels' does not)
        torch.testing.assert_close(got.objf[live], alone.objf, rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(got.gamma[live], alone.gamma, rtol=0,
                                   atol=1e-6)
        jg = JChainGraph(entry_chain_fst(
            denominator_fst(num_phones=8, states_per_phone=2, seed=4)[0], 4),
            log_domain=True)
        ref = _jaux(x.numpy(), lens.numpy().astype(np.int32),
                    JChainGraphBatch(jg, 4), impl="factorized")
        _close(got, ref)
