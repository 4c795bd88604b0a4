"""The port's closed-form linear numerator against the JAX package's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.loss import chain_function_with_aux as j_aux
from pychain_tpu.loss import graph_arrays as j_graph_arrays

import pychain_tpu_torch as pt
from pychain_tpu_torch.convert import linear_from_numpy
from pychain_tpu_torch.ops.linear import (forward_backward_linear,
                                          is_linear_graph)
from pychain_tpu_torch.utils.testgraphs import linear_fst, random_fst


def _batches(seqs, T):
    K = max(len(s) for s in seqs)
    nums = [pt.ChainGraph(linear_fst(s), log_domain=True) for s in seqs]
    jnums = [JChainGraph(linear_fst(s), log_domain=True) for s in seqs]
    return (pt.ChainGraphBatch(nums, max_num_transitions=K,
                               max_num_states=K + 1, device="cpu"),
            JChainGraphBatch(jnums, max_num_transitions=K,
                             max_num_states=K + 1))


@pytest.mark.parametrize("lengths", [[7, 5, 3], [7, 4, 3]],
                         ids=["feasible", "one-infeasible"])
def test_linear_matches_jax(lengths):
    rng = np.random.RandomState(0)
    B, T, P = 3, 7, 6
    seqs = [rng.randint(0, P, size=n) for n in (7, 5, 3)]
    batch, jbatch = _batches(seqs, T)
    assert batch._linear is not None
    x = rng.randn(B, T, P).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    _, ref = j_aux(jnp.asarray(x), lens, jbatch)
    got = forward_backward_linear(torch.from_numpy(x),
                                  torch.from_numpy(lens), batch._linear)
    np.testing.assert_allclose(got.objf.numpy(), np.asarray(ref.objf),
                               rtol=1e-6)
    for name in ("gamma", "alpha_beta", "gamma_sum"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    if lengths[1] == 4:
        # no accepting path: objf = -inf, gamma = 0, ok False
        assert got.objf[1] == -np.inf and not bool(got.ok[1])
        assert float(got.gamma[1].abs().sum()) == 0.0


def test_linear_detection_and_convert():
    rng = np.random.RandomState(1)
    seqs = [rng.randint(0, 5, size=4) for _ in range(2)]
    batch, jbatch = _batches(seqs, 4)
    conv = linear_from_numpy(jbatch._linear, device="cpu")
    for f in ("pdf_seq", "logp_seq", "final", "graph_len"):
        torch.testing.assert_close(getattr(conv, f),
                                   getattr(batch._linear, f))
    cyclic = pt.ChainGraph(random_fst(num_states=5, seed=0),
                           log_domain=True)
    assert not is_linear_graph(cyclic)
    # a cyclic log-domain list goes to the semiring arrays instead
    batch = pt.ChainGraphBatch([cyclic], max_num_transitions=20,
                               max_num_states=5, device="cpu")
    assert batch._linear is None and batch._semiring is not None
    # a prob-domain list builds, with the gather engine's arrays (its
    # only engine), padded as the JAX package pads them
    prob = random_fst(num_states=5, seed=0)
    batch = pt.ChainGraphBatch([pt.ChainGraph(prob)], max_num_transitions=20,
                               max_num_states=5, device="cpu")
    assert batch._linear is None and batch._semiring is None
    assert batch._fact is None and batch.semiring() is None
    ga = batch.graph_arrays()
    jga = j_graph_arrays(JChainGraphBatch([JChainGraph(prob)],
                                          max_num_transitions=20,
                                          max_num_states=5))
    assert not ga.shared and ga.leaky is not None
    for f in ("fwd_src", "fwd_dst", "fwd_pdf", "fwd_prob", "bwd_src",
              "bwd_dst", "bwd_pdf", "bwd_prob", "initial", "final",
              "leaky"):
        np.testing.assert_array_equal(getattr(ga, f).numpy(),
                                      np.asarray(getattr(jga, f)), f)
