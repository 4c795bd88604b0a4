"""The port's training path against the JAX package's: chain_loss_xent,
one TDNN + ChainLoss + Adam step against flax + optax, torch.optim.Adam
against optax.adam, a fast-mode step on the CPU, and checkpoints.

Sizes: B=3, T=24, the denominator of 10 phones (P=20), linear
numerators; a TDNN of width 16.  Tolerances (float32): chain_loss_xent's
loss, terms and gradients within 1e-5; the step's loss, every parameter
after the update and the running statistics within 1e-5; Adam against
optax within 1e-6 over five steps; checkpoints restore bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu import ChainLoss as JChainLoss
from pychain_tpu.loss import chain_loss_xent as j_chain_loss_xent
from pychain_tpu import models as jm

import pychain_tpu_torch as pt
from pychain_tpu_torch import models as pm
from pychain_tpu_torch.convert import model_from_flax, model_to_flax
from pychain_tpu_torch.utils.checkpoint import (latest_step,
                                                restore_checkpoint,
                                                save_checkpoint)
from pychain_tpu_torch.utils.testgraphs import denominator_fst, linear_fst

B, T, D = 3, 24, 5
LENGTHS = np.array([24, 20, 15], np.int32)
TDNN_KW = dict(hidden_dim=16, kernel_sizes=(3, 3), dilations=(1, 3),
               strides=(1, 1), dropout=0.0)


def _graphs(seed=0):
    den_fst, P = denominator_fst(num_phones=10, states_per_phone=2,
                                 seed=seed)
    rng = np.random.RandomState(seed)
    seqs = [rng.randint(0, P, size=int(n)) for n in LENGTHS]
    K = int(LENGTHS.max())
    nums = pt.ChainGraphBatch(
        [pt.ChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1, device="cpu")
    jnums = JChainGraphBatch(
        [JChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1)
    return den_fst, P, nums, jnums


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ----------------------------------------------------------------------
# chain_loss_xent
# ----------------------------------------------------------------------

@pytest.mark.parametrize("l2,avg,same", [
    (0.0, True, False), (0.01, True, False), (0.0, False, False),
    (0.01, False, False), (0.01, True, True)],
    ids=["avg", "avg-l2", "sum", "sum-l2", "same-tensor"])
def test_chain_loss_xent_matches_jax(l2, avg, same):
    den_fst, P, nums, jnums = _graphs()
    rng = np.random.RandomState(1)
    x = rng.randn(B, T, P).astype(np.float32)
    xo = x if same else rng.randn(B, T, P).astype(np.float32)
    kw = dict(xent_regularize=0.1, l2_regularize=l2, avg=avg)
    jden = JChainGraphBatch(JChainGraph(den_fst), B)

    def jfun(a, b):
        return j_chain_loss_xent(a if not same else b, b, LENGTHS, jnums,
                                 jden, **kw)
    (jloss, (jmmi, jxent)), (gx, gxo) = jax.value_and_grad(
        jfun, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(xo))
    jgrad_x = np.asarray(gxo) if same else np.asarray(gx)

    den = pt.ChainGraphBatch(pt.ChainGraph(den_fst), B, device="cpu")
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    xot = xt if same else torch.from_numpy(xo).requires_grad_(True)
    loss, (mmi, xent) = pt.chain_loss_xent(xt, xot, torch.from_numpy(LENGTHS),
                                           nums, den, **kw)
    loss.backward()
    for got, want in ((loss, jloss), (mmi, jmmi), (xent, jxent)):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), jgrad_x, rtol=1e-5,
                               atol=1e-5)
    if not same:
        np.testing.assert_allclose(xot.grad.numpy(), np.asarray(gxo),
                                   rtol=1e-5, atol=1e-5)


def test_chain_loss_xent_gamma_is_a_soft_target():
    """With xent_regularize=1 and no MMI change, the xent head's gradient
    is softmax(xent_out) - gamma on real frames: gamma carries none."""
    den_fst, P, nums, _ = _graphs(seed=2)
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(B, T, P).astype(np.float32))
    xo = torch.from_numpy(rng.randn(B, T, P).astype(np.float32))
    xo.requires_grad_(True)
    den = pt.ChainGraphBatch(pt.ChainGraph(den_fst), B, device="cpu")
    loss, _ = pt.chain_loss_xent(x, xo, LENGTHS, nums, den,
                                 xent_regularize=1.0, avg=False)
    loss.backward()
    _, aux = pt.chain_function_with_aux(x, LENGTHS, nums)
    mask = torch.from_numpy(np.arange(T)[None, :] < LENGTHS[:, None])
    want = (torch.softmax(xo.detach(), -1) * aux.gamma.sum(-1, keepdim=True)
            - aux.gamma)
    torch.testing.assert_close(xo.grad, want * mask[:, :, None], rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------------------------
# One training step: TDNN -> ChainLoss -> Adam, against flax + optax
# ----------------------------------------------------------------------

def test_train_step_matches_flax_optax():
    den_fst, P, nums, jnums = _graphs()
    feats = np.random.RandomState(5).randn(B, T, D).astype(np.float32)
    jmodel = jm.TDNN(jm.TDNNConfig(num_pdfs=P, **TDNN_KW))
    variables = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(feats), train=False))
    jloss_mod = JChainLoss(JChainGraph(den_fst))
    tx = optax.adam(1e-3)
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = tx.init(params)

    def loss_fn(p):
        out, upd = jmodel.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jnp.asarray(feats), train=True, mutable=["batch_stats"])
        return jloss_mod(out, jnp.asarray(LENGTHS), jnums), upd
    (jloss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    updates, _ = tx.update(grads, opt_state, params)
    jparams = jax.tree.map(np.asarray, optax.apply_updates(params, updates))

    model = model_from_flax(pm.TDNNConfig(num_pdfs=P, **TDNN_KW), variables,
                            device="cpu")
    loss_mod = pt.ChainLoss(pt.ChainGraph(den_fst), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    out = model(torch.from_numpy(feats), train=True)
    loss = loss_mod(out, torch.from_numpy(LENGTHS), nums)
    loss.backward()
    opt.step()

    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    got = model_to_flax(model)
    got_params = dict(_flat(got["params"]))
    for path, want in _flat(jparams):
        np.testing.assert_allclose(got_params[path], want, rtol=0, atol=1e-5,
                                   err_msg=str(path))
    got_stats = dict(_flat(got["batch_stats"]))
    for path, want in _flat(jax.tree.map(np.asarray, upd["batch_stats"])):
        np.testing.assert_allclose(got_stats[path], want, rtol=0, atol=1e-5,
                                   err_msg=str(path))
    # the step moved every parameter
    for path, before in _flat(variables["params"]):
        assert not np.array_equal(got_params[path], before)


def test_adam_matches_optax():
    """torch.optim.Adam(lr) and optax.adam(lr): the same defaults (betas
    0.9 / 0.999, eps 1e-8 added to the root of the bias-corrected second
    moment) and the same update, over five steps."""
    rng = np.random.RandomState(7)
    p0 = rng.randn(4, 6).astype(np.float32)
    grads = [rng.randn(4, 6).astype(np.float32) for _ in range(5)]
    tx = optax.adam(1e-3)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([tp], lr=1e-3)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


@pytest.mark.parametrize("model_name", ["TDNN", "TDNNF", "BLSTM"])
def test_fast_mode_step_on_the_cpu(model_name):
    """ChainLoss(den, precision="fast") behind a model on the CPU (the
    plain fast version of B1/B2): a finite loss and gradients, and a
    step that moves the weights."""
    den_fst, P, nums, _ = _graphs(seed=1)
    cfg = {"TDNN": lambda: pm.TDNNConfig(num_pdfs=P, **TDNN_KW),
           "TDNNF": lambda: pm.TDNNFConfig(num_pdfs=P, hidden_dim=16,
                                           bottleneck_dim=8, num_layers=2),
           "BLSTM": lambda: pm.BLSTMConfig(num_pdfs=P, hidden_dim=8,
                                           num_layers=2, dropout=0.0)}
    model = getattr(pm, model_name)(cfg[model_name](), D, device="cpu")
    loss_mod = pt.ChainLoss(pt.ChainGraph(den_fst), precision="fast",
                            device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    feats = torch.from_numpy(
        np.random.RandomState(8).randn(B, T, D).astype(np.float32))
    kw = {"lengths": LENGTHS} if model_name == "BLSTM" else {}
    before = [p.detach().clone() for p in model.parameters()]
    loss = loss_mod(model(feats, True, **kw), LENGTHS, nums)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert all(torch.isfinite(p.grad).all() for p in model.parameters()
               if p.requires_grad)
    opt.step()
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))


# ----------------------------------------------------------------------
# Checkpoints
# ----------------------------------------------------------------------

def _trained(seed=0):
    den_fst, P, nums, _ = _graphs()
    model = pm.TDNN(pm.TDNNConfig(num_pdfs=P, **TDNN_KW), D, device="cpu",
                    generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    loss_mod = pt.ChainLoss(pt.ChainGraph(den_fst), device="cpu")
    feats = torch.from_numpy(
        np.random.RandomState(9).randn(B, T, D).astype(np.float32))

    def step():
        opt.zero_grad()
        loss = loss_mod(model(feats, True), LENGTHS, nums)
        loss.backward()
        opt.step()
        return float(loss.detach())
    return model, opt, step


def test_checkpoint_round_trip_is_exact(tmp_path):
    model, opt, step = _trained()
    for _ in range(2):
        step()
    save_checkpoint(tmp_path, 2, {"model": model.state_dict(),
                                  "opt": opt.state_dict()})
    fresh, fresh_opt, fresh_step = _trained(seed=1)
    got_step, state = restore_checkpoint(
        tmp_path, {"model": fresh.state_dict(), "opt": fresh_opt.state_dict()})
    assert got_step == 2
    fresh.load_state_dict(state["model"])
    fresh_opt.load_state_dict(state["opt"])
    for a, b in zip(model.state_dict().values(), fresh.state_dict().values()):
        assert torch.equal(a, b)
    saved, restored = opt.state_dict()["state"], \
        fresh_opt.state_dict()["state"]
    assert saved.keys() == restored.keys()
    for k in saved:
        for name in saved[k]:
            assert torch.equal(saved[k][name], restored[k][name])
    assert step() == fresh_step()


def test_checkpoint_latest_step_and_missing(tmp_path):
    assert latest_step(tmp_path) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "nowhere", {})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, {})
    model, opt, step = _trained()
    save_checkpoint(tmp_path, 3, {"model": model.state_dict()})
    first = {k: v.clone() for k, v in model.state_dict().items()}
    step()
    save_checkpoint(tmp_path, 5, {"model": model.state_dict()})
    assert latest_step(tmp_path) == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_3", "step_5"]
    template = {"model": model.state_dict()}
    n, state = restore_checkpoint(tmp_path, template, step=3)
    assert n == 3 and all(torch.equal(state["model"][k], v)
                          for k, v in first.items())
    n, state = restore_checkpoint(tmp_path, template)
    assert n == 5 and torch.equal(state["model"]["classifier.bias"],
                                  model.state_dict()["classifier.bias"])
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, template, step=4)


def test_checkpoint_refuses_a_template_it_does_not_fit(tmp_path):
    model, _, _ = _trained()
    save_checkpoint(tmp_path, 1, {"model": model.state_dict()})
    other = pm.TDNN(pm.TDNNConfig(num_pdfs=7, **TDNN_KW), D, device="cpu")
    with pytest.raises(ValueError, match="classifier"):
        restore_checkpoint(tmp_path, {"model": other.state_dict()})
    with pytest.raises(ValueError, match="no entries"):
        restore_checkpoint(tmp_path, {"model": model.state_dict(),
                                      "opt": {}})
