"""The port's ChainLoss against the JAX package's, plus its errors.

Value and gradient of ChainLoss(den)(x, lengths, nums) on the same
numpy x: objf relative <= 1e-5, gradient max-abs <= 1e-6 (float32, the
loss is averaged over ~20 frames so gradient entries are ~1e-2).
"""

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
from pychain_tpu_torch import loss as pt_loss
from pychain_tpu_torch.convert import factorized_from_numpy
from pychain_tpu_torch.graphs.builder import ChainTopology, \
    make_numerator_fst
from pychain_tpu_torch.graphs.fst import FST
from pychain_tpu_torch.ops import semiring_kernels as sk
from pychain_tpu_torch.utils.testgraphs import denominator_fst, linear_fst


def _setup(B=3, T=8, seed=0, mode="source", num_lens=None):
    den_fst, P = denominator_fst(num_phones=10, states_per_phone=2,
                                 seed=seed, forward_pdf_mode=mode)
    rng = np.random.RandomState(seed)
    lens = np.array([T, T - 3, T - 5][:B], np.int32)
    num_lens = lens if num_lens is None else np.asarray(num_lens)
    seqs = [rng.randint(0, P, size=int(n)) for n in num_lens]
    x = rng.randn(B, T, P).astype(np.float32)
    K = int(max(num_lens))
    nums = pt.ChainGraphBatch(
        [pt.ChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1, device="cpu")
    jnums = JChainGraphBatch(
        [JChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1)
    return den_fst, x, lens, nums, jnums


@pytest.mark.parametrize("mode", ["source", "separate"])
def test_chain_loss_value_and_grad_match_jax(mode):
    den_fst, x, lens, nums, jnums = _setup(mode=mode)
    jloss = JChainLoss(JChainGraph(den_fst))
    jval, jgrad = jax.value_and_grad(
        lambda xx: jloss(xx, jnp.asarray(lens), jnums))(jnp.asarray(x))

    loss_mod = pt.ChainLoss(pt.ChainGraph(den_fst), device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    val = loss_mod(xt, torch.from_numpy(lens), nums)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=1e-6)
    # the denominator batch is cached per batch size
    assert loss_mod.den_batch(3) is loss_mod.den_batch(3)


def test_sgd_step_lowers_the_loss():
    den_fst, x, lens, nums, _ = _setup(seed=1)
    loss_mod = pt.ChainLoss(pt.ChainGraph(den_fst), device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    losses = []
    for _ in range(3):
        val = loss_mod(xt, lens, nums)
        val.backward()
        with torch.no_grad():
            xt -= 2.0 * xt.grad
        xt.grad = None
        losses.append(float(val.detach()))
    assert np.isfinite(losses).all() and losses[0] > losses[1] > losses[2]


def test_chain_function_with_aux_ok_flags_match_jax():
    # sequence 1's numerator is one arc short: no accepting path
    den_fst, x, lens, nums, jnums = _setup(num_lens=[8, 4, 3])
    _, jres = j_aux(jnp.asarray(x), lens, jnums)
    objf, res = pt_loss.chain_function_with_aux(torch.from_numpy(x), lens,
                                                nums)
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(jres.ok))
    assert res.ok.tolist() == [True, False, True]
    assert float(objf) == -np.inf

    den = pt.ChainGraphBatch(pt.ChainGraph(den_fst), 3, device="cpu")
    jden = JChainGraphBatch(JChainGraph(den_fst), 3)
    _, jres = j_aux(jnp.asarray(x), lens, jden)
    objf, res = pt_loss.chain_function_with_aux(torch.from_numpy(x), lens,
                                                den)
    assert res.ok.all()
    np.testing.assert_allclose(res.objf.numpy(), np.asarray(jres.objf),
                               rtol=1e-5)
    np.testing.assert_allclose(res.alpha_beta.numpy(),
                               np.asarray(jres.alpha_beta), atol=1e-5)


def test_jax_arrays_through_convert_give_the_same_loss():
    den_fst, x, lens, _, _ = _setup(mode="cross")
    jden = JChainGraphBatch(JChainGraph(den_fst), 3)
    fa = factorized_from_numpy(jden._fact)
    mine = pt.ChainGraphBatch(pt.ChainGraph(den_fst), 3, device="cpu")
    xt = torch.from_numpy(x)
    a = pt_loss.chain_function(xt, lens, fa)
    b = pt_loss.chain_function(xt, lens, mine)
    assert float(a) == float(b)
    _, jres = j_aux(jnp.asarray(x), lens, jden, impl="factorized")
    np.testing.assert_allclose(float(a), float(np.asarray(jres.objf).sum()),
                               rtol=1e-5)


def test_fast_precision_plain_path_matches_jax_bf16():
    den_fst, x, lens, nums, jnums = _setup()
    jloss = JChainLoss(JChainGraph(den_fst), precision="fast",
                       impl="factorized")
    jval = jloss(jnp.asarray(x), jnp.asarray(lens), jnums)
    loss_mod = pt.ChainLoss(pt.ChainGraph(den_fst), precision="fast",
                            device="cpu")
    val = loss_mod(torch.from_numpy(x), lens, nums)
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)


def test_error_probes():
    den_fst, x, lens, nums, _ = _setup()
    den = pt.ChainGraph(den_fst)
    loss_mod = pt.ChainLoss(den, device="cpu")
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="batch size"):
        loss_mod(xt[:2], lens[:2], nums)
    with pytest.raises(Exception, match="empty graph"):
        pt.ChainGraph(FST())
    with pytest.raises(ValueError, match="log domain"):
        pt.ChainGraph(den_fst, initial_mode="leaky", log_domain=True)
    with pytest.raises(ValueError, match="pdf ids"):
        loss_mod(xt[:, :, :5], lens, nums)
    with pytest.raises(ValueError, match="exceed the padded"):
        loss_mod(xt, lens + 1, nums)
    with pytest.raises(ValueError, match="batch size should be"):
        pt.ChainGraphBatch(den, device="cpu")
    # a shared log-domain batch builds (it serves viterbi_align); the
    # loss on it is not ported
    shared_log = pt.ChainGraphBatch(pt.ChainGraph(den_fst, log_domain=True),
                                    xt.shape[0], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5"):
        pt_loss.chain_function(xt, lens, shared_log)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt_loss.chain_function(xt, lens, nums, impl="leveled")


def test_precision_errors():
    den = pt.ChainGraph(denominator_fst(num_phones=6, seed=0)[0])
    with pytest.raises(ValueError, match="precision must be"):
        pt.ChainLoss(den, precision="half", device="cpu")
    with pytest.raises(ValueError, match="contradicts"):
        pt.ChainLoss(den, precision="fast", tile_dtype="float32",
                     device="cpu")
    with pytest.raises(ValueError, match="contradicts"):
        pt.ChainLoss(den, precision="parity", tile_dtype="bfloat16",
                     device="cpu")
    assert pt.ChainLoss(den, precision="fast",
                        device="cpu").tile_dtype == "bfloat16"


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid")
    den = pt.ChainGraph(denominator_fst(num_phones=6, seed=0)[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.ChainLoss(den)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.ChainGraphBatch(den, 2)


# ----------------------------------------------------------------------
# Flat-start (end-to-end) numerators: the semiring path
# ----------------------------------------------------------------------

def _flat_start(B=3, T=9, seed=0):
    """A denominator and B flat-start numerators (make_numerator_fst,
    lm=None) over its pdfs, N_b phones in T frames."""
    den_fst, P = denominator_fst(num_phones=10, states_per_phone=2,
                                 seed=seed)
    rng = np.random.RandomState(seed)
    topo = ChainTopology(num_phones=P // 2)
    fsts = [make_numerator_fst(rng.randint(0, P // 2, size=n), topo)
            for n in rng.randint(2, 5, size=B)]
    x = rng.randn(B, T, P).astype(np.float32)
    lens = np.array([T, T - 2, T - 4][:B], np.int32)
    K, S = 2 * 4, 4 + 1
    nums = pt.ChainGraphBatch(
        [pt.ChainGraph(f, log_domain=True) for f in fsts],
        max_num_transitions=K, max_num_states=S, device="cpu")
    jnums = JChainGraphBatch([JChainGraph(f, log_domain=True) for f in fsts],
                             max_num_transitions=K, max_num_states=S)
    return den_fst, x, lens, nums, jnums


def test_flat_start_chain_loss_matches_jax():
    den_fst, x, lens, nums, jnums = _flat_start()
    assert nums._linear is None and nums._semiring is not None
    assert jnums._semiring is not None
    # the port first, while no JAX work is in flight
    loss_mod = pt.ChainLoss(pt.ChainGraph(den_fst), device="cpu")
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    val = loss_mod(xt, torch.from_numpy(lens), nums)
    val.backward()
    jloss = JChainLoss(JChainGraph(den_fst))
    jval, jgrad = jax.value_and_grad(
        lambda xx: jloss(xx, jnp.asarray(lens), jnums))(jnp.array(x))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=1e-6)


def test_flat_start_sgd_step_lowers_the_loss():
    den_fst, x, lens, nums, _ = _flat_start(seed=1)
    loss_mod = pt.ChainLoss(pt.ChainGraph(den_fst), device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    losses = []
    sk.reset_launch_counts()
    for _ in range(3):
        val = loss_mod(xt, lens, nums)
        val.backward()
        assert torch.isfinite(xt.grad).all()
        with torch.no_grad():
            xt -= 2.0 * xt.grad
        xt.grad = None
        losses.append(float(val.detach()))
    assert np.isfinite(losses).all() and losses[0] > losses[1] > losses[2]
    assert sk.LAUNCHES == {"semiring_fwd": 0, "semiring_bwd": 0}
