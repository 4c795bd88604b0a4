"""The JAX package's banded engine (pychain_tpu/ops/leveled.py,
``impl="leveled"``) against the port's, on the cases of
tests/test_leveled.py.

The port has no banded engine: ``impl="leveled"`` is "auto" there, the
semiring engine (its kernels on the card, their float64 plain version
here), which takes every log-domain list and ran main path 3's batch
85 times faster on the card than a port of the banded engine did
(PERF.md).  Both packages get the same numpy inputs and run
``impl="leveled"``: objf within 1e-5 relative and gamma within 1e-5
absolute of JAX's, and, as the JAX test holds its engine, against the
port's gather engine (objf 1e-4, gamma 1e-3 relative with 1e-5
absolute) and the float64 oracle (2e-4).  Also: on every graph that
JAX's detection admits (sausages, constrained numerators, linear
chains) the two agree, and the port runs the ones it refuses (graphs
with self-loops, an early final state, a level wider than 16); the
arcs each engine reads, graph by graph; the dispatch (auto's arrays,
one object); ``reorder``; and tolerance-3 constrained numerators (main
path 3's supervision) at a small size.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.loss import chain_function as j_chain_function
from pychain_tpu.loss import chain_function_with_aux as j_aux
from pychain_tpu.ops.leveled import is_leveled_graph as j_is_leveled
from pychain_tpu.ops.leveled import leveled_arrays as j_arrays
from pychain_tpu.utils import oracle

import pychain_tpu_torch as pt
from pychain_tpu_torch import loss as pt_loss
from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                              make_constrained_numerator)
from pychain_tpu_torch.graphs.fst import FST
from pychain_tpu_torch.ops.linear import LinearArrays
from pychain_tpu_torch.ops.semiring import SemiringArrays
from pychain_tpu_torch.utils.testgraphs import (linear_fst, random_fst,
                                                sausage_fst)


def _sausage_fst(rng, T, P, max_w=3, seed=0):
    alts = [list(rng.choice(P, size=rng.randint(1, max_w + 1),
                            replace=False)) for _ in range(T)]
    return sausage_fst(alts, seed=seed)


def _batches(fsts):
    ports = [pt.ChainGraph(f, log_domain=True) for f in fsts]
    jaxs = [JChainGraph(f, log_domain=True) for f in fsts]
    K = max(g.num_transitions for g in ports)
    S = max(g.num_states for g in ports)
    return (pt.ChainGraphBatch(ports, max_num_transitions=K,
                               max_num_states=S, device="cpu"),
            JChainGraphBatch(jaxs, max_num_transitions=K, max_num_states=S))


def _port(x, lens, batch, impl="leveled"):
    return pt_loss.chain_function_with_aux(torch.from_numpy(x),
                                           torch.from_numpy(lens), batch,
                                           impl=impl)[1]


def _jax(x, lens, jbatch):
    return j_aux(jnp.asarray(x.copy()), jnp.asarray(lens), jbatch,
                 impl="leveled")[1]


def _close_to_jax(got, ref):
    np.testing.assert_allclose(got.objf.numpy(), np.asarray(ref.objf),
                               rtol=1e-5)
    for name in ("gamma", "gamma_sum", "alpha_beta"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))


def _wide_fst():
    """A time-synchronous graph with a level 17 states wide."""
    arcs = []
    for i in range(17):
        arcs.append((0, 1 + i, i % 4 + 1, i % 4 + 1, 0.5))
        arcs.append((1 + i, 18, (i + 1) % 4 + 1, (i + 1) % 4 + 1, 0.5))
    return FST.from_arcs(19, 0, arcs, {18: 0.0})


def _early_final_fst():
    """A chain 0 -> 1 -> 2 -> 3 that may also end at state 1."""
    arcs = [(s, s + 1, s + 1, s + 1, 0.1) for s in range(3)]
    return FST.from_arcs(4, 0, arcs, {1: 0.0, 3: 0.0})


def test_detection():
    """JAX's detection decides which graphs its banded engine takes; the
    port's impl="leveled" is auto's engine on every one, equal to JAX's
    leveled where JAX takes the graph and to the port's gather engine
    everywhere."""
    rng = np.random.RandomState(0)
    P = 8
    topo = ChainTopology(num_phones=4)
    fsts = {
        "sausage": _sausage_fst(rng, 6, P),
        "random": random_fst(num_states=5, num_pdfs=4, seed=0),
        "linear": linear_fst(rng.randint(0, P, size=5)),
        "constrained": make_constrained_numerator([0, 2, 1], [3, 2, 4],
                                                  topo, tolerance=1),
        "wide": _wide_fst(),
        "early": _early_final_fst(),
    }
    want = {"sausage": True, "random": False, "linear": True,
            "constrained": True, "wide": False, "early": False}
    engine = {"linear": LinearArrays}
    for name, fst in fsts.items():
        assert j_is_leveled(JChainGraph(fst, log_domain=True)) == want[name]
        batch, jbatch = _batches([fst] * 2)
        g = pt_loss.dispatch_arrays(batch, "leveled")
        assert isinstance(g, engine.get(name, SemiringArrays)), name
        assert g is pt_loss.dispatch_arrays(batch, "auto"), name
        T = {"sausage": 6, "constrained": 9, "wide": 2, "early": 3}.get(
            name, 5)       # a length each graph accepts
        x = rng.randn(2, T, P).astype(np.float32)
        lens = np.full(2, T, np.int32)
        got = _port(x, lens, batch)
        gen = _port(x, lens, batch, "gather")
        np.testing.assert_allclose(got.objf.numpy(), gen.objf.numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        if want[name]:
            _close_to_jax(got, _jax(x, lens, jbatch))
        else:
            with pytest.raises(ValueError, match="time-synchronous"):
                _jax(x, lens, jbatch)


def _arcs(pdf, logp):
    """The (pdf, weight) pairs of a graph's real arcs, sorted."""
    real = np.isfinite(logp)
    return sorted(zip(pdf[real].tolist(), logp[real].tolist()))


def test_arrays_match_jax():
    """The arcs that the port's impl="leveled" reads (the semiring
    arrays) are those of JAX's banded arrays, graph by graph."""
    rng = np.random.RandomState(1)
    fsts = [_sausage_fst(rng, n, 6, seed=10 + i)
            for i, n in enumerate([8, 6, 8, 5])]
    batch, _ = _batches(fsts)
    got = pt_loss.dispatch_arrays(batch, "leveled")
    ref = j_arrays([JChainGraph(f, log_domain=True) for f in fsts])
    for b in range(len(fsts)):
        assert _arcs(got.pdf[b].numpy(), got.logp[b].numpy()) == _arcs(
            np.asarray(ref.pdf[b]), np.asarray(ref.logp[b])), b
        fin = got.final[b].numpy()
        jfin = np.asarray(ref.final[b])
        np.testing.assert_array_equal(np.sort(fin[np.isfinite(fin)]),
                                      np.sort(jfin[np.isfinite(jfin)]))


def test_matches_jax_gather_and_oracle():
    rng = np.random.RandomState(1)
    B, T, P = 4, 8, 6
    fsts = [_sausage_fst(rng, n, P, seed=10 + i)
            for i, n in enumerate([8, 6, 8, 5])]
    lens = np.array([8, 6, 8, 5], np.int32)
    x = rng.randn(B, T, P).astype(np.float32)
    batch, jbatch = _batches(fsts)
    lev = _port(x, lens, batch)
    _close_to_jax(lev, _jax(x, lens, jbatch))
    gen = _port(x, lens, batch, "gather")
    np.testing.assert_allclose(lev.objf.numpy(), gen.objf.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lev.gamma.numpy(), gen.gamma.numpy(),
                               rtol=1e-3, atol=1e-5)
    assert bool(lev.ok.all())
    gs = lev.gamma_sum.numpy()
    for b in range(B):
        np.testing.assert_allclose(gs[b, :lens[b]], 1.0, atol=1e-3)
    ref_objf, _ = oracle.oracle_objf_log(
        x, lens, [JChainGraph(f, log_domain=True) for f in fsts])
    np.testing.assert_allclose(lev.objf.numpy(), ref_objf, rtol=2e-4,
                               atol=1e-4)


def test_infeasible_length():
    rng = np.random.RandomState(2)
    P = 5
    fst = _sausage_fst(rng, 6, P, seed=3)
    batch, jbatch = _batches([fst, fst])
    x = rng.randn(2, 8, P).astype(np.float32)
    lens = np.array([6, 8], np.int32)
    res = _port(x, lens, batch)
    assert np.isfinite(res.objf[0].item()) and res.objf[1].item() == -np.inf
    assert bool(res.ok[0]) and not bool(res.ok[1])
    assert not res.gamma[1].any()
    _close_to_jax(res, _jax(x, lens, jbatch))


def test_gradient_matches():
    rng = np.random.RandomState(3)
    P = 4
    fst = _sausage_fst(rng, 5, P, seed=4)
    batch, jbatch = _batches([fst])
    x = rng.randn(1, 5, P).astype(np.float32)
    lens = np.array([5], np.int32)

    def grad(impl):
        xt = torch.from_numpy(x).requires_grad_(True)
        pt_loss.chain_function(xt, torch.from_numpy(lens), batch,
                               impl=impl).backward()
        return xt.grad.numpy()

    g_lev = grad("leveled")
    np.testing.assert_allclose(g_lev, grad("gather"), rtol=1e-3, atol=1e-5)
    g_jax = jax.grad(lambda v: j_chain_function(
        v, jnp.asarray(lens), jbatch, impl="leveled"))(jnp.asarray(x))
    np.testing.assert_allclose(g_lev, np.asarray(g_jax), rtol=0, atol=1e-5)


def test_constrained_numerators_and_reorder():
    """Tolerance-3 constrained numerators (the realignment's
    supervision) with unequal lengths, against JAX and the semiring
    engine; reorder keeps each graph with its sequence."""
    rng = np.random.RandomState(7)
    topo = ChainTopology(num_phones=6)
    fsts, lens = [], []
    for b in range(4):
        n = 3 + b
        phones = [int(p) for p in rng.randint(0, 6, size=n)]
        durs = [int(d) for d in rng.randint(2, 5, size=n)]
        fsts.append(make_constrained_numerator(phones, durs, topo,
                                               tolerance=3))
        lens.append(sum(durs))
    lens = np.asarray(lens, np.int32)
    x = rng.randn(4, int(lens.max()), 12).astype(np.float32)
    batch, jbatch = _batches(fsts)
    lev = _port(x, lens, batch)
    _close_to_jax(lev, _jax(x, lens, jbatch))
    sr = _port(x, lens, batch, "semiring")
    np.testing.assert_allclose(lev.objf.numpy(), sr.objf.numpy(), rtol=1e-4)
    np.testing.assert_allclose(lev.gamma.numpy(), sr.gamma.numpy(), rtol=0,
                               atol=1e-4)
    again = _port(x, lens, batch)
    assert torch.equal(lev.gamma, again.gamma)
    batch.reorder([3, 1, 0, 2])
    got = _port(x, lens, batch)
    fresh, _ = _batches([fsts[i] for i in (3, 1, 0, 2)])
    ref = _port(x, lens, fresh)
    np.testing.assert_array_equal(got.objf.numpy(), ref.objf.numpy())
    np.testing.assert_array_equal(got.gamma.numpy(), ref.gamma.numpy())
