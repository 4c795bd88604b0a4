"""The port's corpus recipe (pychain_tpu_torch/examples/train_corpus.py)
against the JAX package's (examples/train_corpus.py, imported by path).

* The synthetic corpora are the same bytes (the scp files up to their
  directory), and ``load_corpus`` gives equal graphs and features.
* Three recipe steps from the JAX recipe's initial TDNN weights
  (``convert.model_from_flax``) on the same batches, against a JAX step
  built as the recipe builds it (``chain_loss`` +
  ``apply_if_finite(chain(clip_by_global_norm, adam), 25)`` over the
  whole variables tree, ``train=False``), with the clip idle and with it
  triggering: losses within 1e-5 relative, each parameter and BatchNorm
  statistic within 1e-5 of its norm (Adam divides by the root of the
  second moment, so an element whose gradient is near zero carries the
  float32 rounding of its gradient into its update at full size).
* ``ClipAdam`` against optax on gradients with NaN and inf steps (the
  skips, the counters, the update applied once ``max_consecutive_errors``
  failures in a row have passed) within 1e-6, and a
  recipe step with a NaN gradient leaving the model and the optimizer
  as they were.
* Subprocess runs of ``python -m pychain_tpu_torch.examples.train_corpus
  --device cpu`` holding the JAX recipe tests' assertions
  (tests/test_recipe_smoke.py): the smoke run, --device-corpus, the PER
  gate (untrained >= 0.5, trained <= 0.15 and <= untrained / 3) in
  float32 and with bfloat16 tiles, flat start with realignment and
  chunking, checkpoint resume, --dp in a group of one rank equal to
  the run without it, and the default device refused without a card.  Each run writes its corpus
  under its own TMPDIR.
"""

import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.graphs.fst import FST as JFST
from pychain_tpu.loss import chain_loss as j_chain_loss
from pychain_tpu.loss import dispatch_arrays as j_dispatch

import pychain_tpu_torch as pt
from pychain_tpu_torch.convert import model_from_flax, model_to_flax
from pychain_tpu_torch.data import pad_to_bucket
from pychain_tpu_torch.examples import train_corpus as pr
from pychain_tpu_torch.loss import dispatch_arrays
from pychain_tpu_torch.utils.optim import ClipAdam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_recipe():
    spec = importlib.util.spec_from_file_location(
        "jax_train_corpus", os.path.join(REPO, "examples", "train_corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jr = _jax_recipe()


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ----------------------------------------------------------------------
# The synthetic corpus
# ----------------------------------------------------------------------

CORPORA = [("random", "aligned"), ("built", "aligned"), ("built", "flat"),
           ("built", "constrained")]


@pytest.mark.parametrize("graphs,num_style", CORPORA,
                         ids=[f"{g}-{n}" for g, n in CORPORA])
def test_synthetic_corpus_is_the_same_bytes(tmp_path, graphs, num_style):
    kw = dict(utts=10, num_phones=8, min_t=20, max_t=40, graphs=graphs,
              num_style=num_style, signal=1.2)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jr.make_synthetic_corpus(jdir, **kw)
    pr.make_synthetic_corpus(pdir, **kw)
    names = ["feats.ark", "num.ark", "den.fst"] + (
        ["text"] if graphs == "built" else [])
    for name in names:
        with open(os.path.join(jdir, name), "rb") as f:
            want = f.read()
        with open(os.path.join(pdir, name), "rb") as f:
            assert f.read() == want, name
    for name in ("feats.scp", "num.scp"):
        with open(os.path.join(jdir, name)) as f:
            want = f.read().replace(jdir, "DIR")
        with open(os.path.join(pdir, name)) as f:
            assert f.read().replace(pdir, "DIR") == want, name

    jkeys, jfeats, jnums, jden = jr.load_corpus(jdir)
    keys, feats, nums, den = pr.load_corpus(pdir)
    assert keys == jkeys
    for a, b in zip(feats, jfeats):
        np.testing.assert_array_equal(a, b)
    for g, jg in zip(nums + [den], jnums + [jden]):
        for name in ("num_states", "start_state", "log_domain"):
            assert getattr(g, name) == getattr(jg, name), name
        for name in ("forward_transitions", "forward_transition_probs",
                     "backward_transitions", "final_probs",
                     "initial_probs"):
            np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                          np.asarray(getattr(jg, name)))


# ----------------------------------------------------------------------
# Three steps from the same weights
# ----------------------------------------------------------------------

B = 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("corpus"))
    pr.make_synthetic_corpus(d, utts=12, num_phones=10, min_t=20, max_t=30)
    keys, feats, nums, den = pr.load_corpus(d)
    jnums = [JChainGraph(JFST.read_ark(p, o), log_domain=True)
             for _, p, o in pr.read_scp(os.path.join(d, "num.scp"))]
    jden = JChainGraph(JFST.read(os.path.join(d, "den.fst")))
    return feats, nums, den, jnums, jden


@pytest.mark.parametrize("clip,triggers", [(5.0, False), (0.5, True)],
                         ids=["clip-idle", "clip-triggers"])
def test_three_steps_match_the_jax_recipe(corpus, clip, triggers):
    feats, nums, den, jnums, jden = corpus
    P, D = 20, feats[0].shape[1]
    T = max(f.shape[0] for f in feats)
    jmodel = jr.build_model("tdnn", P, D)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, T, D)),
                            train=False)
    tx = optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(clip), optax.adam(1e-3)),
        max_consecutive_errors=25)
    params, state = variables, tx.init(variables)

    @jax.jit
    def jstep(p, st, x, lens, num_g, den_g):
        def loss_fn(q):
            out = jmodel.apply(q, x, train=False)
            return j_chain_loss(out, lens, num_g, den_g,
                                leaky_coefficient=1e-5)
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, st = tx.update(grads, st)
        return (loss, optax.apply_updates(p, updates), st,
                optax.global_norm(grads))

    model = model_from_flax(pr.model_config("tdnn", P),
                            jax.tree.map(np.asarray, variables),
                            device="cpu")
    opt = ClipAdam(pr.trainables(model), lr=1e-3, clip=clip)
    jden_g = j_dispatch(JChainGraphBatch(jden, B))
    den_g = dispatch_arrays(pt.ChainGraphBatch(den, B, device="cpu"))
    for s in range(3):
        idx = list(range(s * B, (s + 1) * B))
        x, lens = pad_to_bucket(feats, idx, T)
        jnum_g = j_dispatch(JChainGraphBatch(
            [jnums[i] for i in idx], max_num_transitions=T + 1,
            max_num_states=T + 2))
        jloss, params, state, gnorm = jstep(
            params, state, jnp.asarray(x), jnp.asarray(lens), jnum_g, jden_g)
        num_g = dispatch_arrays(pt.ChainGraphBatch(
            [nums[i] for i in idx], max_num_transitions=T + 1,
            max_num_states=T + 2, device="cpu"))
        loss = pr.train_step(model, opt, torch.from_numpy(x), lens, num_g,
                             den_g)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        assert (float(gnorm) >= clip) == triggers, float(gnorm)

    got = dict(_flat(model_to_flax(model)))
    before = dict(_flat(variables))
    for path, want in _flat(params):
        assert not np.array_equal(want, before[path]), path  # it moved
        err = np.linalg.norm(got[path] - want)
        assert err <= 1e-5 * np.linalg.norm(want), (path, err)
    assert int(opt.count) == 3 and int(opt.total_notfinite) == 0


def _optax_guarded(clip, max_errors):
    return optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(clip), optax.adam(1e-3)),
        max_consecutive_errors=max_errors)


@pytest.mark.parametrize("pattern", ["one-nan", "inf-then-finite",
                                     "gives-up"])
def test_clip_adam_skips_non_finite_updates_as_optax(pattern):
    """NaN / inf gradients skip the update and keep the moments and step
    count; after ``max_consecutive_errors`` failures in a row the next
    one is applied (and poisons the weights, as in optax)."""
    rng = np.random.RandomState(3)
    p0 = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    bad = {"one-nan": {1}, "inf-then-finite": {0, 1},
           "gives-up": {1, 2, 3, 4}}[pattern]
    max_errors = 2
    grads = []
    for step in range(6):
        g = [rng.randn(*a.shape).astype(np.float32) * 3 for a in p0]
        if step in bad:
            g[step % 2][0] = np.nan if pattern != "inf-then-finite" \
                else np.inf
        grads.append(g)
    tx = _optax_guarded(1.0, max_errors)
    jp = [jnp.asarray(a) for a in p0]
    st = tx.init(jp)
    tensors = [torch.tensor(a, requires_grad=True) for a in p0]
    opt = ClipAdam(tensors, lr=1e-3, clip=1.0,
                   max_consecutive_errors=max_errors)
    for g in grads:
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for t, a in zip(tensors, g):
            t.grad = torch.from_numpy(a.copy())
        opt.step()
        for t, want in zip(tensors, jp):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)
        assert int(opt.total_notfinite) == int(st.total_notfinite)
        assert int(opt.notfinite_count) == int(st.notfinite_count)
    if pattern == "gives-up":
        assert not all(np.isfinite(t.detach().numpy()).all()
                       for t in tensors)


def test_step_with_a_nan_gradient_preserves_the_state(corpus):
    feats, nums, den, _, _ = corpus
    T = max(f.shape[0] for f in feats)
    model = pr.build_model("tdnn", 20, feats[0].shape[1], device="cpu")
    opt = ClipAdam(pr.trainables(model), lr=1e-3)
    den_g = dispatch_arrays(pt.ChainGraphBatch(den, B, device="cpu"))
    num_g = dispatch_arrays(pt.ChainGraphBatch(
        nums[:B], max_num_transitions=T + 1, max_num_states=T + 2,
        device="cpu"))
    x, lens = pad_to_bucket(feats, list(range(B)), T)
    pr.train_step(model, opt, torch.from_numpy(x), lens, num_g, den_g)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = {k: [t.clone() for t in v] if isinstance(v, list)
                  else v.clone() for k, v in opt.state_dict().items()}
    x_nan = x.copy()
    x_nan[0, 3, 5] = np.nan
    loss = pr.train_step(model, opt, torch.from_numpy(x_nan), lens, num_g,
                         den_g)
    assert not np.isfinite(float(loss))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in opt.state_dict().items():
        if k == "total_notfinite":
            assert int(v) == 1
        elif k == "notfinite_count":
            assert int(v) == 1
        elif isinstance(v, list):
            assert all(torch.equal(a, b) for a, b in zip(v, opt_before[k]))
        else:
            assert torch.equal(v, opt_before[k]), k


# ----------------------------------------------------------------------
# The recipe as a user runs it
# ----------------------------------------------------------------------

def _recipe(tmp_path, *args, check=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = str(tmp_path)
    # one intra-op thread: alone the run takes as long (about 8 s for the
    # PER gate either way), but beside other test workers a process with
    # a thread a core oversubscribes them (353 s measured)
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "pychain_tpu_torch.examples.train_corpus",
         *args], capture_output=True, text=True, timeout=600, env=env,
        cwd=str(tmp_path))
    if check:
        assert r.returncode == 0, r.stderr[-2000:]
    return r


def _smoke(tmp_path, *extra):
    """tests/test_recipe_smoke.py's run and assertions."""
    out = _recipe(tmp_path, "--device", "cpu", "--steps", "3",
                  "--batch-size", "8", "--corpus-utts", "16",
                  "--warmup-steps", "1", "--diag-every", "2",
                  *extra).stdout
    assert "steady-state:" in out and "pipeline: host assembly" in out
    m = re.search(r"final loss (-?\d+\.\d+|nan|inf)", out)
    assert m, out[-2000:]
    assert m.group(1) not in ("nan", "inf"), out[-2000:]
    assert "ok=True" in out and "ok=False" not in out
    assert re.search(r"corpus: 16 utts, feat_dim=40", out)
    # the random denominator factorizes: the resident tier (B1/B2)
    assert re.search(r"denominator engine: pallas \(S_pad=\d+, float32 "
                     r"tiles\)", out)
    return out


def test_recipe_smoke(tmp_path):
    _smoke(tmp_path)


def test_recipe_device_corpus(tmp_path):
    out = _smoke(tmp_path, "--device-corpus")
    assert re.search(r"device corpus: 16 utts staged on cpu", out)


def _per_gate(tmp_path, *extra):
    """tests/test_recipe_smoke.py's PER gate arguments."""
    out = _recipe(tmp_path, "--device", "cpu",
                  "--synthetic-graphs", "built", "--num-style", "aligned",
                  "--corpus-utts", "32", "--corpus-phones", "24",
                  "--signal", "1.2", "--steps", "60", "--batch-size", "8",
                  "--warmup-steps", "2", "--diag-every", "0", "--eval-per",
                  "--eval-per-untrained", *extra).stdout
    m0 = re.search(r"untrained PER (\d+\.\d+) over (\d+) utts", out)
    m1 = re.search(r"eval PER (\d+\.\d+) over (\d+) utts", out)
    assert m0 and m1, out[-2000:]
    assert int(m1.group(2)) == 32
    # the built phone-LM denominator keeps residual arcs: the plain
    # version, in either tile dtype, as in the JAX package
    assert re.search(r"denominator engine: xla \(S_pad=\d+, "
                     r"(float32|bfloat16) tiles\)", out)
    return float(m0.group(1)), float(m1.group(1))


@pytest.mark.parametrize("tiles", ["float32", "bfloat16"])
def test_recipe_per_quality_gate(tmp_path, tiles):
    extra = ("--tile-dtype", "bfloat16") if tiles == "bfloat16" else ()
    untrained, trained = _per_gate(tmp_path, *extra)
    assert untrained >= 0.5, \
        f"gate not falsifiable: untrained PER {untrained} too low"
    assert trained <= 0.15, f"trained PER {trained} above the 0.15 gate"
    assert trained <= untrained / 3, (untrained, trained)


def test_recipe_flat_start_realign_and_chunk(tmp_path):
    out = _recipe(tmp_path, "--device", "cpu", "--synthetic-graphs",
                  "built", "--num-style", "flat", "--corpus-utts", "16",
                  "--batch-size", "8", "--steps", "8", "--realign-at", "4",
                  "--chunk-frames", "40", "--warmup-steps", "1",
                  "--diag-every", "2").stdout
    assert "realigning 16 utterances at step 4 (tolerance 3)" in out
    assert re.search(r"chunked into \d+ pieces of <= 40 frames", out)
    m = re.search(r"final loss (-?\d+\.\d+|nan|inf)", out)
    assert m and m.group(1) not in ("nan", "inf"), out[-2000:]
    assert "ok=True" in out and "ok=False" not in out


def test_recipe_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    args = ("--device", "cpu", "--batch-size", "8", "--corpus-utts", "16",
            "--warmup-steps", "1", "--diag-every", "0", "--ckpt", ckpt)
    first = _recipe(tmp_path, *args, "--steps", "2").stdout
    assert "resumed" not in first
    second = _recipe(tmp_path, *args, "--steps", "4").stdout
    assert "resumed from step 2" in second
    assert "done: 2 steps" in second
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_2", "step_4"]


def test_recipe_dp_is_refused_naming_its_roadmap_item(tmp_path):
    """--dp runs: on the CPU with no launcher, a group of one rank (gloo),
    with the losses of the run without it (two ranks:
    tests/test_torch_parallel.py)."""
    args = ("--device", "cpu", "--steps", "3", "--batch-size", "8",
            "--corpus-utts", "16", "--warmup-steps", "1", "--diag-every",
            "2")
    dp = _recipe(tmp_path, *args, "--dp").stdout
    assert "data parallel over 1 ranks (gloo)" in dp
    one = _recipe(tmp_path, *args).stdout
    losses = [re.findall(r"loss=(-?\d+\.\d+)", out) for out in (dp, one)]
    assert losses[0] and losses[0] == losses[1]
    final = [re.search(r"final loss (-?\d+\.\d+)", out).group(1)
             for out in (dp, one)]
    assert final[0] == final[1]


def test_recipe_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    r = _recipe(tmp_path, "--steps", "1", check=False)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
    # it refused before writing a corpus
    assert not os.path.exists(tmp_path / "pychain_tpu_torch_corpus")
