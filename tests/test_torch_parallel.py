"""The port's data parallelism (pychain_tpu_torch/parallel/) on two gloo
processes on the CPU, against the JAX package's single-device loss.

Two ranks run tests/_torch_parallel_worker.py once for the module (one
process each, 300 s limit, every exit code checked), each with its own
rows of every global batch; the tests read their results:

* the 12 cases of tests/test_data_parallel.py: ShardedChainLoss with
  the factorized denominator, its gradient, the denominator built once
  per local batch size (the JAX test's jit-once contract), an
  indivisible batch refused, pjit_chain_function on a shared graph and
  on linear numerators (sharded), unequal lengths (the global frame
  count), the bfloat16 fast mode, a shared numerator (replicated), the
  xent and l2 regularizers (value and both gradients), the xent_out
  contract, tolerance-1 constrained numerators (also as the whole
  batch's engine arrays, impl="leveled"): each value equal on both
  ranks and within 1e-5 relative of the JAX package's single-device
  ChainLoss (the
  bfloat16 mode within JAX's 2e-2 budget; xent 2e-4 as the JAX test);
  the gradients of the ranks' rows, laid together, within 1e-6 of the
  single-process port's and at the JAX test's tolerances of JAX's;
* tests/test_multihost.py's round trip: a 1-D dp mesh, each rank's own
  numerators, rows as DTensor shards, save_sharded / restore_sharded
  (each rank's rows back; a plain template gets the whole array),
  replicate_to_global;
* the gradient rule: a TDNN's parameter gradients summed over the ranks
  equal one process's on the whole batch (1e-5 of their norm), each
  rank's alone does not;
* train-mode BatchNorm over the ranks: outputs, running statistics and
  gradients those of one process on the whole batch;
* ``--dp`` in train_tdnn and the corpus recipe (also with
  --device-corpus): three steps' losses equal to one process's on the
  whole batch (1e-5).

In this process: the refusals (a mesh that does not cover the group,
``local_device_count`` > 1) and a group of one rank, whose
ShardedChainLoss equals ChainLoss bit for bit.  In a process of its own (120 s limit): spawn_per_card (an
example's --dp with no launcher on a host with several cards) with the
card count stubbed at 2, on gloo: rank 0's result, past a pipe's
buffer, comes back.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu import ChainLoss as JChainLoss
from pychain_tpu import chain_loss_xent as j_chain_loss_xent
from pychain_tpu.loss import chain_function as j_chain_function
from pychain_tpu.loss import dispatch_arrays as j_dispatch

import pychain_tpu_torch as pt
from pychain_tpu_torch import parallel

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_worker as w  # noqa: E402

WORLD = 2
ROWS = [slice(r * 8 // WORLD, (r + 1) * 8 // WORLD) for r in range(WORLD)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results: the job runs once for the module."""
    out = tmp_path_factory.mktemp("dp")
    env = dict(os.environ, TMPDIR=str(out), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, w.__file__, str(r), str(WORLD), port, str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _case(ranks, name):
    res = [r[name] for r in ranks]
    for r in res:
        assert "error" not in r, r.get("error")
    return res


def _same_value(res, key="loss"):
    vals = [r[key] for r in res]
    assert all(v == vals[0] for v in vals), vals
    return vals[0]


def _jnums(seqs, T):
    return JChainGraphBatch([JChainGraph(w.linear_fst(s), log_domain=True)
                             for s in seqs], max_num_transitions=T,
                            max_num_states=T + 1)


def _jloss(den_fst, x, lens, jnums):
    return float(JChainLoss(JChainGraph(den_fst))(jnp.asarray(x.copy()),
                                                  jnp.asarray(lens), jnums))


def _close(got, ref, rtol=1e-5):
    assert abs(got - ref) <= rtol * max(1.0, abs(ref)), (got, ref)


def _port_grad(den_fst, x, lens, nums):
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    pt.ChainLoss(pt.ChainGraph(den_fst), device="cpu")(
        xt, torch.from_numpy(lens), nums).backward()
    return xt.grad.numpy()


def test_factorized_matches_single_device(ranks):
    res = _case(ranks, "factorized")
    den_fst, P, seqs, x, lens = w.problem_setup(0)
    _close(_same_value(res), _jloss(den_fst, x, lens, _jnums(seqs, 10)))
    assert all(r["factorized"] for r in res)


def test_grad_matches_single_device(ranks):
    res = _case(ranks, "grad")
    den_fst, P, seqs, x, lens = w.problem_setup(1)
    jnums = _jnums(seqs, 10)
    _close(_same_value(res), _jloss(den_fst, x, lens, jnums))
    got = np.concatenate([r["grad"] for r in res])
    np.testing.assert_allclose(
        got, _port_grad(den_fst, x, lens, w.linear_batch(seqs, 10)),
        rtol=0, atol=1e-6)
    loss = JChainLoss(JChainGraph(den_fst))
    ref = jax.grad(lambda v: loss(v, jnp.asarray(lens), jnums))(
        jnp.asarray(x.copy()))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-6)


def test_den_built_once_values_flow(ranks):
    res = _case(ranks, "cache")
    assert all(r["n_den"] == 1 and r["same_den"] for r in res)
    v1, v2 = _same_value(res, "v1"), _same_value(res, "v2")
    assert v1 != v2
    den_fst, P, seqs, x, lens = w.problem_setup(2)
    _close(v1, _jloss(den_fst, x, lens, _jnums(seqs, 10)))


def test_rejects_indivisible_batch(ranks):
    for r in _case(ranks, "indivisible"):
        assert "divisible" in r["call"] and "[2, 1]" in r["call"]
        assert "divisible" in r["shard"]


def test_pjit_chain_function_shared_graph(ranks):
    res = _case(ranks, "pjit_shared")
    den_fst, P, seqs, x, lens = w.problem_setup(3)
    ref = float(j_chain_function(jnp.asarray(x.copy()), jnp.asarray(lens),
                                 j_dispatch(JChainGraphBatch(
                                     JChainGraph(den_fst), 1),
                                     "factorized")))
    _close(_same_value(res, "value"), ref)


def test_unequal_lengths(ranks):
    res = _case(ranks, "unequal")
    den_fst, P, seqs, x, lens = w.problem_unequal()
    jnums = JChainGraphBatch([JChainGraph(w.linear_fst(s), log_domain=True)
                              for s in seqs], max_num_transitions=10,
                             max_num_states=11)
    _close(_same_value(res), _jloss(den_fst, x, lens, jnums))


def test_bf16_fast_mode(ranks):
    res = _case(ranks, "bf16")
    assert all(r["tiles"] == "torch.bfloat16" for r in res)
    den_fst, P, seqs, x, lens = w.problem_setup(2)
    _close(_same_value(res), _jloss(den_fst, x, lens, _jnums(seqs, 10)),
           rtol=2e-2)


def test_pjit_chain_function_linear_numerators(ranks):
    res = _case(ranks, "pjit_linear")
    assert all(r["linear"] and r["spec"] == "shard" for r in res)
    den_fst, P, seqs, x, lens = w.problem_setup(5)
    ref = float(j_chain_function(jnp.asarray(x.copy()), jnp.asarray(lens),
                                 _jnums(seqs, 10)))
    _close(_same_value(res, "value"), ref)


def test_shared_numerator_batch(ranks):
    res = _case(ranks, "shared_num")
    assert all(r["spec"] == "replicate" for r in res)
    den_fst, P, x, lens = w.problem_shared_num()
    jnums = JChainGraphBatch(JChainGraph(den_fst, log_domain=True), 8)
    _close(_same_value(res), _jloss(den_fst, x, lens, jnums))


def test_xent_matches_single_device(ranks):
    res = _case(ranks, "xent")
    den_fst, P, seqs, x, xent, lens = w.problem_xent()
    jnums = _jnums(seqs, 10)

    def ref_fn(a, b):
        return j_chain_loss_xent(a, b, jnp.asarray(lens), jnums,
                                 JChainGraphBatch(JChainGraph(den_fst), 8),
                                 xent_regularize=0.1, l2_regularize=1e-3)[0]
    xa, xb = jnp.asarray(x.copy()), jnp.asarray(xent.copy())
    ref = float(ref_fn(xa, xb))
    np.testing.assert_allclose(_same_value(res), ref, rtol=2e-4)
    grads = jax.grad(ref_fn, argnums=(0, 1))(xa, xb)
    for key, g in zip(("grad_x", "grad_xent"), grads):
        np.testing.assert_allclose(np.concatenate([r[key] for r in res]),
                                   np.asarray(g), rtol=1e-3, atol=1e-5)


def test_xent_argument_contract(ranks):
    for r in _case(ranks, "xent_contract"):
        assert "xent_out" in r["plain"] and "xent_out" in r["reg"]


def test_constrained_numerators(ranks):
    res = _case(ranks, "constrained")
    den_fst, P, fsts, x, lens = w.problem_constrained()
    graphs = [JChainGraph(f, log_domain=True) for f in fsts]
    jnums = JChainGraphBatch(
        graphs, max_num_transitions=max(g.num_transitions for g in graphs),
        max_num_states=max(g.num_states for g in graphs))
    assert jnums._leveled is not None
    ref = _jloss(den_fst, x, lens, jnums)
    _close(_same_value(res), ref)
    _close(_same_value(res, "leveled"), ref)


def test_multihost_round_trip(ranks):
    res = _case(ranks, "multihost")
    den_fst, P, seqs, x, lens = w.problem_multihost()
    _close(_same_value(res), _jloss(den_fst, x, lens, _jnums(seqs, 10)))
    for r in res:
        assert r["step"] == 7 and r["step_scale"] == 3.0
        assert r["local_is_rows"]
        np.testing.assert_array_equal(r["restored_rows"], r["rows"])
        np.testing.assert_array_equal(r["whole"], x)
        np.testing.assert_array_equal(r["seed"], np.zeros(3, np.float32))
    np.testing.assert_array_equal(
        np.concatenate([r["rows"] for r in res]), x)


def _model_problem():
    den_fst, P, seqs, feats, lens = w.problem_model()
    model = w.small_tdnn(P, feats.shape[2])
    nums = w.linear_batch(seqs, feats.shape[1])
    loss_fn = pt.ChainLoss(pt.ChainGraph(den_fst), device="cpu")
    return model, loss_fn, torch.from_numpy(feats), lens, nums


def _rel_norm(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_gradient_rule(ranks):
    """Summed over the ranks (sum_gradients), a TDNN's parameter
    gradients are one process's on the whole batch; a rank's own part
    is not, and the parts add up to the sum."""
    res = _case(ranks, "grad_rule")
    model, loss_fn, feats, lens, nums = _model_problem()
    loss = loss_fn(model(feats, train=False), lens, nums)
    loss.backward()
    _close(_same_value(res), float(loss))
    for name, p in model.named_parameters():
        ref = p.grad.numpy()
        for r in res:
            assert _rel_norm(r["after"][name], ref) <= 1e-5, name
        parts = sum(r["before"][name] for r in res)
        np.testing.assert_allclose(parts, res[0]["after"][name], rtol=0,
                                   atol=1e-6 * max(np.abs(ref).max(), 1))
    assert any(_rel_norm(res[0]["before"][n], p.grad.numpy()) > 1e-3
               for n, p in model.named_parameters())


def test_batchnorm_global_statistics(ranks):
    res = _case(ranks, "batchnorm")
    model, loss_fn, feats, lens, nums = _model_problem()
    out = model(feats, train=True)
    loss = loss_fn(out, lens, nums)
    loss.backward()
    _close(_same_value(res), float(loss))
    np.testing.assert_allclose(np.concatenate([r["out"] for r in res]),
                               out.detach().numpy(), rtol=0, atol=1e-5)
    for name, b in model.named_buffers():
        for r in res:
            np.testing.assert_allclose(r["buffers"][name], b.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    for name, p in model.named_parameters():
        for r in res:
            assert _rel_norm(r["grads"][name], p.grad.numpy()) <= 1e-5, name


def test_dp_examples_match_one_process(ranks):
    r0 = _case(ranks, "examples")[0]
    for name in ("tdnn", "recipe", "recipe_staged"):
        assert len(r0[name]) == 3
        np.testing.assert_allclose(r0[f"{name}_dp"], r0[name], rtol=1e-5)
    for name in ("recipe", "recipe_staged"):
        assert r0[f"{name}_ok"] and r0[f"{name}_world"] == 2


def test_spawn_per_card_returns_a_large_result():
    """spawn_per_card, an example's --dp on a host with several cards and
    no launcher, on the CPU with the card count stubbed at 2 and no
    kernel build (gloo): rank 0's result of 50,000 losses (about 450 kB
    pickled, past a pipe's 64 KiB buffer) comes back whole, without its
    model, and the parent returns (a limit of 120 s ends a hang)."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = "\n".join([
        "import json, sys, torch",
        f"sys.path[:0] = [{os.path.dirname(tests)!r}, {tests!r}]",
        "torch.cuda.device_count = lambda: 2",
        "import _torch_parallel_worker as w",
        "from pychain_tpu_torch.parallel import multihost",
        "multihost.prebuild = lambda device: None   # no nvcc here",
        "r = multihost.spawn_per_card(w.spawn_target, ['50000'])",
        "print(json.dumps({'n': len(r['losses']), 'last': r['losses'][-1],"
        " 'world': r['world'], 'rank': r['rank'], 'keys': sorted(r)}))"])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"n": 50000, "last": 49999.0, "world": 2, "rank": 0,
                   "keys": ["losses", "rank", "world"]}


def test_refusals_and_a_group_of_one():
    # a (1 x 2) mesh does not cover a group of one rank (the model axis
    # runs in tests/test_torch_model_parallel.py's workers)
    with pytest.raises(ValueError, match=r"a \(1, 2\) mesh needs 2 ranks"):
        parallel.make_mesh(n_mp=2, device="cpu")
    with pytest.raises(ValueError, match="one process per device"):
        parallel.initialize("localhost:1", 1, 0, local_device_count=2,
                            device="cpu")
    assert not torch.distributed.is_initialized()
    try:
        mesh = parallel.make_mesh(device="cpu")   # a group of one rank
        den_fst, P, seqs, x, lens = w.problem_setup(0)
        nums = w.linear_batch(seqs, 10)
        den = pt.ChainGraph(den_fst)
        got = parallel.ShardedChainLoss(mesh, den)(torch.from_numpy(x),
                                                   lens, nums)
        ref = pt.ChainLoss(den, device="cpu")(torch.from_numpy(x), lens,
                                              nums)
        assert torch.equal(got, ref)
        assert parallel.shard_batch(mesh, {"x": x})["x"] is not None
    finally:
        torch.distributed.destroy_process_group()
