"""The port's acoustic models against the JAX package's flax models.

Weights come from flax ``model.init`` on a seed (then every leaf is
perturbed from a numpy seed, so that biases, BatchNorm scales and
running statistics are not at their initial values) and reach the port
through ``convert.model_from_flax``; inputs are made with numpy.

Tolerances (float32): outputs within 1e-5, running BatchNorm statistics
after a train-mode pass within 1e-6 (an unbiased-variance update is off
by far more at B*T = 72 frames), parameter gradients of sum(out * w)
within 1e-4 of each leaf's largest entry, the semi-orthogonal update
within 1e-5.  The BLSTM is compared on valid frames (flax and the port
both leave the padding's outputs to the padding).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychain_tpu import models as jm
from pychain_tpu_torch import models as pm
from pychain_tpu_torch.convert import model_from_flax, model_to_flax
from pychain_tpu_torch.models.layers import same_padding

B, T, D = 3, 24, 6
LENGTHS = np.array([24, 17, 9], np.int32)

CASES = {
    "tdnn": ("TDNN", dict(num_pdfs=20, hidden_dim=16, kernel_sizes=(3, 3, 3),
                          dilations=(1, 1, 3), strides=(1, 1, 1),
                          dropout=0.0)),
    # kernel 2 with dilation 3: SAME pads (1, 2), the odd pad high
    "tdnn_k2_d3": ("TDNN", dict(num_pdfs=20, hidden_dim=16,
                                kernel_sizes=(2, 2), dilations=(3, 1),
                                strides=(1, 1), dropout=0.0)),
    # stride 2 with kernels 2 and 3: T 24 -> 12 -> 6
    "tdnn_stride2": ("TDNN", dict(num_pdfs=20, hidden_dim=16,
                                  kernel_sizes=(2, 3), dilations=(1, 1),
                                  strides=(2, 2), dropout=0.0)),
    "tdnnf": ("TDNNF", dict(num_pdfs=20, hidden_dim=16, bottleneck_dim=8,
                            num_layers=3, dilations=(1, 3))),
    "blstm": ("BLSTM", dict(num_pdfs=20, hidden_dim=8, num_layers=2,
                            dropout=0.0)),
    "lstm_uni": ("BLSTM", dict(num_pdfs=20, hidden_dim=8, num_layers=2,
                               dropout=0.0, bidirectional=False)),
}


def _configs(case):
    name, kw = CASES[case]
    return (getattr(jm, name), getattr(jm, name + "Config")(**kw),
            getattr(pm, name + "Config")(**kw))


def _inputs(seed=0):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


def _variables(case, seed=0):
    """flax init on a seed, every leaf then perturbed (variances kept
    positive): nested dicts of numpy arrays."""
    jcls, jcfg, _ = _configs(case)
    x = jnp.asarray(_inputs())
    variables = jcls(jcfg).init(jax.random.PRNGKey(seed), x, False)
    rng = np.random.RandomState(seed + 1)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        noise = 0.1 * rng.randn(*a.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(a + noise) + 0.5
        return a + noise
    return jax.tree_util.tree_map_with_path(perturb, variables)


def _is_lstm(case):
    return CASES[case][0] == "BLSTM"


def _jax_apply(case, variables, x, train):
    jcls, jcfg, _ = _configs(case)
    args = (jnp.asarray(x), train) + ((jnp.asarray(LENGTHS),)
                                      if _is_lstm(case) else ())
    out, upd = jcls(jcfg).apply(variables, *args, mutable=["batch_stats"])
    return np.asarray(out), jax.tree.map(np.asarray, upd)


def _port_apply(model, case, x, train):
    kw = {"lengths": torch.from_numpy(LENGTHS)} if _is_lstm(case) else {}
    return model(x, train, **kw)


def _valid(case, out):
    """Frames both frameworks define: the BLSTM's within each length."""
    if not _is_lstm(case):
        return out
    return np.concatenate([out[b, :n] for b, n in enumerate(LENGTHS)])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_flax(case, train):
    variables = _variables(case)
    x = _inputs(1)
    ref, _ = _jax_apply(case, variables, x, train)
    model = model_from_flax(_configs(case)[2], variables, device="cpu")
    with torch.no_grad():
        out = _port_apply(model, case, torch.from_numpy(x), train).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(_valid(case, out), _valid(case, ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["tdnn", "tdnn_stride2", "tdnnf"])
def test_running_statistics_match_flax(case):
    variables = _variables(case)
    x = _inputs(2)
    _, upd = _jax_apply(case, variables, x, True)
    model = model_from_flax(_configs(case)[2], variables, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        _port_apply(model, case, torch.from_numpy(x), True)
    moved = model_to_flax(model)
    ref = upd["batch_stats"]
    for layer, stats in ref.items():
        for leaf in ("mean", "var"):
            got = moved["batch_stats"][layer]["BatchNorm_0"][leaf]
            want = stats["BatchNorm_0"][leaf]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the check can tell: an unbiased update moves the first layer's
    # running variance by far more than the tolerance at n = B * T
    key = "layers.0.bn.running_var"
    m = 0.95
    old = before[key].numpy()
    var_b = (moved["batch_stats"][next(iter(ref))]["BatchNorm_0"]["var"]
             - m * old) / (1 - m)
    n = B * T
    unbiased = m * old + (1 - m) * var_b * n / (n - 1)
    assert np.abs(unbiased - model.state_dict()[key].numpy()).max() > 1e-4


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("case", list(CASES))
def test_parameter_gradients_match_flax(case):
    variables = _variables(case)
    x = _inputs(3)
    jcls, jcfg, pcfg = _configs(case)
    w = np.random.RandomState(4).randn(
        *_jax_apply(case, variables, x, True)[0].shape).astype(np.float32)
    if _is_lstm(case):   # valid frames only
        w *= (np.arange(T)[None, :] < LENGTHS[:, None])[:, :, None]

    def objective(params):
        out, _ = jcls(jcfg).apply(
            {**variables, "params": params}, jnp.asarray(x), True,
            *((jnp.asarray(LENGTHS),) if _is_lstm(case) else ()),
            mutable=["batch_stats"])
        return jnp.sum(out * w)
    jgrads = jax.grad(objective)(
        jax.tree.map(jnp.asarray, variables["params"]))

    model = model_from_flax(pcfg, variables, device="cpu")
    out = _port_apply(model, case, torch.from_numpy(x), True)
    (out * torch.from_numpy(w)).sum().backward()
    # the gradients in flax's layout: a copy of the model holding them
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    holder = model_from_flax(pcfg, variables, device="cpu")
    with torch.no_grad():
        for k, p in holder.named_parameters():
            p.copy_(grads[k])
    got = dict(_flat(model_to_flax(holder)["params"]))
    for path, ref in _flat(jax.tree.map(np.asarray, jgrads)):
        scale = max(float(np.abs(ref).max()), 1e-12)
        err = float(np.abs(got[path] - ref).max())
        assert err <= 1e-4 * scale, (path, err, scale)


@pytest.mark.parametrize("strides", [(1, 1), (2, 1), (2, 2), (3, 2)])
def test_output_lengths_match_flax(strides):
    kw = dict(num_pdfs=5, hidden_dim=8, kernel_sizes=(3,) * len(strides),
              dilations=(1,) * len(strides), strides=strides, dropout=0.0)
    lengths = np.array([24, 23, 10, 1, 7])
    ref = np.asarray(jm.TDNN(jm.TDNNConfig(**kw)).output_lengths(lengths))
    model = pm.TDNN(pm.TDNNConfig(**kw), D, device="cpu")
    np.testing.assert_array_equal(model.output_lengths(lengths).numpy(), ref)
    out = model(torch.zeros(5, 24, D))
    assert out.shape[1] == ref[0]


@pytest.mark.parametrize("length,k,s,d,want", [
    (24, 2, 1, 3, (1, 2)), (24, 3, 1, 1, (1, 1)), (24, 2, 2, 1, (0, 0)),
    (25, 2, 2, 1, (0, 1)), (24, 3, 2, 1, (0, 1)), (7, 5, 3, 2, (4, 4))])
def test_same_padding_is_lax(length, k, s, d, want):
    from jax import lax
    ref = lax.padtype_to_pads((length,), (d * (k - 1) + 1,), (s,), "SAME")
    assert same_padding(length, k, s, d) == tuple(ref[0]) == want


@pytest.mark.parametrize("speed", [0.125, 0.5])
def test_semi_orthogonal_functions_match_jax(speed):
    case = "tdnnf"
    variables = _variables(case, seed=5)
    model = model_from_flax(_configs(case)[2], variables, device="cpu")
    ref_dev = float(jm.semi_orthogonal_deviation(variables["params"]))
    assert abs(pm.semi_orthogonal_deviation(model) - ref_dev) <= 1e-5
    ref = jm.constrain_semi_orthogonal(
        jax.tree.map(jnp.asarray, variables["params"]), speed)
    assert pm.constrain_semi_orthogonal(model, speed) is model
    got = dict(_flat(model_to_flax(model)["params"]))
    for path, want in _flat(jax.tree.map(np.asarray, ref)):
        np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-5)
    after = float(jm.semi_orthogonal_deviation(ref))
    assert abs(pm.semi_orthogonal_deviation(model) - after) <= 1e-5
    assert after < ref_dev
    # a state dict is updated in place too
    sd = model.state_dict()
    pm.constrain_semi_orthogonal(sd, speed)
    assert pm.semi_orthogonal_deviation(model) < after


def test_initialisation_follows_flax():
    g = torch.Generator().manual_seed(3)
    model = pm.TDNN(pm.TDNNConfig(num_pdfs=300, hidden_dim=256,
                                  dropout=0.0), 40, device="cpu",
                    generator=g)
    w = model.layers[1].conv.weight.detach()     # fan_in 3 * 256
    std = (1.0 / 768) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-7
    assert not model.layers[1].conv.bias.any()
    bn = model.layers[0].bn
    assert bool((bn.weight == 1).all()) and not bn.bias.any()
    same = pm.TDNN(model.config, 40, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in
               zip(model.state_dict().values(), same.state_dict().values()))
    lstm = pm.BLSTM(pm.BLSTMConfig(num_pdfs=10, hidden_dim=16,
                                   num_layers=1), 8, device="cpu").lstms[0]
    for g_ in range(4):
        blk = lstm.weight_hh_l0_reverse[g_ * 16:(g_ + 1) * 16]
        torch.testing.assert_close(blk @ blk.T, torch.eye(16), atol=1e-5,
                                   rtol=0)
    assert not lstm.bias_ih_l0.requires_grad and lstm.bias_hh_l0.requires_grad


@pytest.mark.parametrize("case", ["tdnn", "tdnnf", "blstm", "lstm_uni"])
def test_weights_carried_both_ways(case):
    variables = _variables(case)
    model = model_from_flax(_configs(case)[2], variables, device="cpu")
    back = model_to_flax(model)
    want = dict(_flat(variables))
    got = dict(_flat(back))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], np.asarray(want[path]))


def test_model_from_flax_refuses_missing_and_surplus_leaves():
    variables = _variables("tdnn")
    cfg = _configs("tdnn")[2]
    missing = {**variables, "params": dict(variables["params"])}
    del missing["params"]["Dense_0"]
    with pytest.raises(ValueError, match="missing.*Dense_0/kernel"):
        model_from_flax(cfg, missing, device="cpu")
    surplus = {**variables, "params": {**variables["params"],
                                       "Extra_0": {"kernel": np.ones(3)}}}
    with pytest.raises(ValueError, match="surplus.*Extra_0/kernel"):
        model_from_flax(cfg, surplus, device="cpu")
    # the TDNN-F's weights do not fit a TDNN
    with pytest.raises(ValueError, match="missing"):
        model_from_flax(cfg, _variables("tdnnf"), device="cpu")
    wrong = dataclasses.replace(cfg, hidden_dim=8)
    with pytest.raises(ValueError, match="does not fit"):
        model_from_flax(wrong, variables, device="cpu")


def test_device_rule_and_mp_axis():
    cfg = pm.TDNNConfig(num_pdfs=5, hidden_dim=8)
    # mp_axis with no mesh annotates only, as flax's with_partitioning:
    # the same weights and outputs as the model without it
    x = torch.from_numpy(_inputs())
    for cls, conf in ((pm.TDNN, pm.TDNNConfig(num_pdfs=5, hidden_dim=8)),
                      (pm.TDNNF, pm.TDNNFConfig(num_pdfs=5, hidden_dim=8,
                                                bottleneck_dim=4,
                                                num_layers=2))):
        annotated = cls(dataclasses.replace(conf, mp_axis="mp"), D,
                        device="cpu")
        plain = cls(conf, D, device="cpu")
        for a, b in zip(annotated.state_dict().values(),
                        plain.state_dict().values()):
            assert torch.equal(a, b)
        for train in (False, True):
            torch.testing.assert_close(annotated(x, train=train),
                                       plain(x, train=train), rtol=0, atol=0)
    if torch.cuda.is_available():
        assert next(pm.TDNN(cfg, D).parameters()).is_cuda
        return
    for build in (lambda: pm.TDNN(cfg, D), lambda: pm.TDNNF(
            pm.TDNNFConfig(num_pdfs=5), D), lambda: pm.BLSTM(
            pm.BLSTMConfig(num_pdfs=5), D),
            lambda: model_from_flax(_configs("tdnn")[2],
                                    _variables("tdnn"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_dropout_draws_from_the_module_generator():
    cfg = pm.TDNNConfig(num_pdfs=5, hidden_dim=64, kernel_sizes=(3,),
                        dilations=(1,), strides=(1,), dropout=0.5)
    x = torch.from_numpy(_inputs())
    a = pm.TDNN(cfg, D, device="cpu")
    b = pm.TDNN(cfg, D, device="cpu")
    torch.manual_seed(0)
    ya = a(x, train=True)
    torch.manual_seed(1)
    yb = b(x, train=True)
    # the same seed gives the same masks whatever the global RNG holds
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)
    assert not torch.equal(a(x, train=True), ya)      # the stream moves on
    c = pm.TDNN(cfg, D, device="cpu")
    c(x)                                     # eval mode draws no mask
    torch.testing.assert_close(c(x, train=True), ya, rtol=0, atol=0)
