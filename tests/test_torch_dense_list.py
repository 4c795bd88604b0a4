"""The port's dense list engine (pychain_tpu_torch/ops/dense_list.py)
against the JAX package's (pychain_tpu/ops/dense_list.py), on the cases
of tests/test_dense_list.py.

Both packages get the same numpy inputs.  The port's ``impl="dense_list"``
is held to JAX's ``impl="dense_list"`` (objf 1e-5 relative, gamma 1e-4
relative with 1e-6 absolute: the products and the gamma sums run in
another order) and, as the JAX test holds its engine, to the port's own
gather engine at the JAX test's tolerances.  Also: the arrays field by
field against JAX's, the bfloat16 blocks against JAX's bfloat16 engine,
the dispatch (lazy build and cache, auto on the CPU keeping the gather
engine until the dense form is built), the budget gate with
``PYCHAIN_DENSE_LIST_BUDGET``, ``reorder`` keeping each graph with its
sequence, and gamma bit-identical on a rerun.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.loss import chain_function as j_chain_function
from pychain_tpu.loss import chain_function_with_aux as j_aux
from pychain_tpu.ops.dense_list import dense_list_arrays as j_arrays

import pychain_tpu_torch as pt
from pychain_tpu_torch import loss as pt_loss
from pychain_tpu_torch.ops.dense_list import (DenseListArrays,
                                              dense_list_arrays,
                                              fits_dense_list)
from pychain_tpu_torch.ops.fwdbwd import GraphArrays
from pychain_tpu_torch.utils.testgraphs import denominator_fst, random_fst


def _batches(fsts, tile_dtype=None):
    ports = [pt.ChainGraph(f) for f in fsts]
    jaxs = [JChainGraph(f) for f in fsts]
    K = max(g.num_transitions for g in ports)
    S = max(g.num_states for g in ports)
    P = max(g.num_pdfs for g in ports)
    return (pt.ChainGraphBatch(ports, max_num_transitions=K, max_num_states=S,
                               tile_dtype=tile_dtype, device="cpu"),
            JChainGraphBatch(jaxs, max_num_transitions=K, max_num_states=S,
                             tile_dtype=tile_dtype), P)


def _den_fsts(B, phones, seed):
    """Per-sequence denominator-style graphs of different topologies
    (phone counts vary by row): unequal S and K across the batch."""
    return [denominator_fst(num_phones=phones + i, states_per_phone=2,
                            seed=seed + i)[0] for i in range(B)]


def _random_fsts(B, P, seed):
    return [random_fst(num_states=7 + i, num_pdfs=P, max_arcs_per_state=4,
                       seed=seed + i) for i in range(B)]


def _port(x, lens, batch, impl):
    return pt_loss.chain_function_with_aux(torch.from_numpy(x),
                                           torch.from_numpy(lens), batch,
                                           impl=impl)[1]


def _jax(x, lens, jbatch, impl="dense_list"):
    return j_aux(jnp.asarray(x.copy()), jnp.asarray(lens), jbatch,
                 impl=impl)[1]


def _close(got, ref, rtol=1e-4):
    np.testing.assert_allclose(got.objf.numpy(), np.asarray(ref.objf),
                               rtol=1e-5)
    for name in ("gamma", "gamma_sum", "alpha_beta"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=1e-6)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))


CASES = {
    # tests/test_dense_list.py::test_dense_list_matches_gather
    "den": (lambda: _den_fsts(3, 6, 0), 12, [12, 9, 4], 0),
    # ::test_dense_list_residual_arcs (random graphs leave residual arcs)
    "residual": (lambda: _random_fsts(3, 6, 3), 8, [8, 6, 3], 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_and_gather(case):
    make, T, lens, seed = CASES[case]
    batch, jbatch, P = _batches(make())
    rng = np.random.RandomState(seed)
    x = rng.randn(batch.batch_size, T, P).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    got = _port(x, lens, batch, "dense_list")
    assert isinstance(batch._dense_list, DenseListArrays)
    _close(got, _jax(x, lens, jbatch))
    # the JAX test's parity with the gather engine
    _close(got, _port(x, lens, batch, "gather"))
    assert bool(got.ok.all())
    if case == "residual":
        assert batch._dense_list.res_prob.shape[1] > 0


def test_arrays_match_jax():
    for fsts in (_den_fsts(3, 5, 1), _random_fsts(3, 6, 3)):
        ports = [pt.ChainGraph(f) for f in fsts]
        got = dense_list_arrays(ports)
        ref = j_arrays([JChainGraph(f) for f in fsts])
        for name in ("w1", "w2", "f_idx", "g_idx", "initial", "final",
                     "leaky", "res_src", "res_dst", "res_pdf", "res_prob"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                err_msg=name)
        assert (got.p_pad, got.x_same) == (ref.p_pad, ref.x_same)


def test_bfloat16_blocks_match_jax():
    batch, jbatch, P = _batches(_den_fsts(3, 6, 0), tile_dtype="bfloat16")
    x = np.random.RandomState(5).randn(3, 12, P).astype(np.float32)
    lens = np.array([12, 9, 4], np.int32)
    got = _port(x, lens, batch, "dense_list")
    assert batch._dense_list.w1.dtype == torch.bfloat16
    _close(got, _jax(x, lens, jbatch))


def test_gradient_matches_gather():
    batch, jbatch, P = _batches(_den_fsts(2, 5, 4))
    x = np.random.RandomState(1).randn(2, 10, P).astype(np.float32)
    lens = np.array([10, 7], np.int32)

    def grad(impl):
        xt = torch.from_numpy(x).requires_grad_(True)
        pt_loss.chain_function(xt, torch.from_numpy(lens), batch,
                               impl=impl).backward()
        return xt.grad.numpy()

    gd = grad("dense_list")
    np.testing.assert_allclose(gd, grad("gather"), rtol=1e-4, atol=1e-6)
    gj = jax.grad(lambda v: j_chain_function(
        v, jnp.asarray(lens), jbatch, impl="dense_list"))(jnp.asarray(x))
    np.testing.assert_allclose(gd, np.asarray(gj), rtol=1e-4, atol=1e-6)


def test_dispatch_and_cache():
    batch, _, _ = _batches(_den_fsts(2, 4, 7))
    assert batch._dense_list is None   # not built at construction
    # auto on the CPU: the gather engine, the dense form left unbuilt
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert isinstance(pt_loss.dispatch_arrays(batch, "auto"),
                          GraphArrays)
    assert batch._dense_list is None
    arrs = pt_loss.dispatch_arrays(batch, "dense_list")
    assert isinstance(arrs, DenseListArrays)
    assert batch._dense_list is arrs   # kept for later dispatches
    # once built, auto returns it (as the JAX package does)
    assert pt_loss.dispatch_arrays(batch, "auto") is arrs
    # arrays given as they are pass through
    assert pt_loss.dispatch_arrays(arrs, "gather") is arrs
    with pytest.raises(ValueError, match="dense_list"):
        pt_loss.dispatch_arrays(pt.ChainGraphBatch(
            pt.ChainGraph(denominator_fst(num_phones=4, seed=0)[0]), 2,
            device="cpu"), "dense_list")
    logb = pt.ChainGraphBatch(
        [pt.ChainGraph(f, log_domain=True) for f in _random_fsts(2, 5, 0)],
        max_num_transitions=40, max_num_states=10, device="cpu")
    with pytest.raises(ValueError, match="dense_list"):
        pt_loss.dispatch_arrays(logb, "dense_list")


def test_budget_gate(monkeypatch):
    assert fits_dense_list(8, 2000)
    assert not fits_dense_list(128, 20000)
    batch, _, _ = _batches(_den_fsts(2, 4, 9))
    monkeypatch.setenv("PYCHAIN_DENSE_LIST_BUDGET", "1024")
    assert not fits_dense_list(2, batch.num_states)
    with pytest.raises(ValueError, match="dense_list"):
        pt_loss.dispatch_arrays(pt.ChainGraphBatch(
            batch._graphs, max_num_transitions=batch.num_transitions,
            max_num_states=batch.num_states, device="cpu"), "dense_list")


def test_reorder_keeps_pairing():
    batch, _, P = _batches(_den_fsts(3, 5, 11))
    x = np.random.RandomState(3).randn(3, 9, P).astype(np.float32)
    lens = np.array([9, 6, 5], np.int32)
    pt_loss.dispatch_arrays(batch, "dense_list")   # built before reorder
    batch.reorder([2, 0, 1])
    got = _port(x, lens, batch, "dense_list")
    fresh = pt.ChainGraphBatch(list(batch._graphs),
                               max_num_transitions=batch.num_transitions,
                               max_num_states=batch.num_states, device="cpu")
    ref = _port(x, lens, fresh, "dense_list")
    np.testing.assert_array_equal(got.objf.numpy(), ref.objf.numpy())
    np.testing.assert_array_equal(got.gamma.numpy(), ref.gamma.numpy())


def test_gamma_bit_identical_on_a_rerun():
    batch, _, P = _batches(_random_fsts(3, 6, 3))
    x = np.random.RandomState(4).randn(3, 8, P).astype(np.float32)
    lens = np.array([8, 6, 3], np.int32)
    a = _port(x, lens, batch, "dense_list")
    b = _port(x, lens, batch, "dense_list")
    assert torch.equal(a.gamma, b.gamma) and torch.equal(a.objf, b.objf)
