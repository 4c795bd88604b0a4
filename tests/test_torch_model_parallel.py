"""The port's model axis (pychain_tpu_torch/parallel/model_parallel.py,
the models' ``mp_axis``, tools/dryrun_multichip.py) on four gloo
processes on the CPU.

Four ranks run tests/_torch_parallel_worker.py's MP_CASES once for the
module (one process each, 300 s limit, every exit code checked) on a
(2 x 2) ("dp", "mp") mesh and on two (1 x 2) meshes, ranks 0-1 and 2-3
(each a sub-mesh of a (pair, dp, mp) mesh); the tests read their
results:

* TDNN and TDNN-F with ``mp_axis="mp"`` (each conv or affine kernel's
  output channels and the classifier's input features over "mp"; the
  TDNN-F bottleneck whole; every other parameter a replicated DTensor):
  one train-mode step (ShardedChainLoss,
  gradients summed over "dp", SGD at 0.1; the semi-orthogonal update
  after it for the TDNN-F): the loss and the state after the step within
  1e-5 of one process's on the whole batch (the loss relative, each
  tensor relative to its norm), the plain tensors bit-identical across
  the mp ranks of a dp index, each placed kernel's local shard 1/2 of it;
* two Adam steps over ``model.parameters()`` (every one a DTensor once
  placed) on the (2 x 2) mesh: the losses and the state those of one
  process (1e-5);
* dropout on a (1 x 2) mesh: the mp ranks draw the same masks, the
  output that of one process (1e-5);
* the four mp collectives, forward and backward, in a column- and a
  row-parallel product against the product whole (1e-6);
* ``dryrun_multichip(4)``'s ranks (``run_rank``, as under a job) on the
  flax weights of ``__graft_entry__``'s
  ``_setup`` (carried across by ``convert``): JAX's two lines, its loss
  within 1e-5 relative of the JAX package's ``entry()`` value, and its
  state after the step within 1e-5 of its norm of a plain
  ``jax.value_and_grad`` SGD step of ``_setup``'s model (JAX on one CPU
  device: not ``dryrun_multichip(8)``, which needs 8 virtual devices);
* ``convert.model_from_flax(..., mesh=)``: each rank's slice of the flax
  arrays, by the model's own annotations and by dryrun's ``param_spec``;
  ``model_to_flax`` gathers them back bit for bit;
* ``replicate_to_global`` over the whole (2 x 2) mesh: rank 0's values
  on every rank;
* ``save_sharded`` / ``restore_sharded`` of an mp-placed TDNN;
* ``make_mesh`` leaves the models' statistics group as it was;
* the refusals (a dim that does not divide, a gradient sum across the mp
  ranks, a kernel's taps sharded, a sharded bottleneck under the
  semi-orthogonal update).

In this process: a model with ``mp_axis`` and no mesh is the model
without it, and ``make_mesh`` of a shape that does not cover the group
raises.  In a fresh interpreter: importing the models and ``convert``
loads nothing of ``parallel``.  In a process of its own (240 s limit): the tool's command line
with ``--n 2 --device cpu`` starts its two ranks and prints the lines.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

import pychain_tpu_torch as pt
from pychain_tpu_torch.convert import _flatten

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_parallel_worker as w  # noqa: E402

WORLD = 2 * 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import __graft_entry__ as graft  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def graft_step():
    """JAX's side: _setup's flax variables, entry()'s loss, and one plain
    jax.value_and_grad SGD step (lr 0.1) of the whole variables tree, as
    dryrun_multichip's train_step takes it."""
    from pychain_tpu import chain_loss
    model, params, feats, lengths, den_b, num_b = graft._setup()
    fn, args = graft.entry()
    entry_loss = float(jax.jit(fn)(*args))

    def loss_fn(p):
        return chain_loss(model.apply(p, feats, train=False), lengths,
                          num_b, den_b)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new = jax.tree.map(lambda p, g: np.asarray(p - 0.1 * g), params, grads)
    return {"variables": jax.tree.map(np.asarray, params),
            "entry_loss": entry_loss, "step_loss": float(loss),
            "after": new}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, graft_step):
    """The four ranks' results: the job runs once for the module."""
    out = tmp_path_factory.mktemp("mp")
    torch.save(graft_step["variables"], out / "variables.pt")
    env = dict(os.environ, TMPDIR=str(out), OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, w.__file__, str(r), str(WORLD), port, str(out),
         "mp"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for r in range(WORLD)]
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


def _rel_norm(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _one_process(kind):
    """The step of the worker's case on the whole batch in one process
    (ChainLoss): (loss, state)."""
    den_fst, P, seqs, feats, lens = w.problem_model()
    model = w.mp_model(kind, P, feats.shape[2])
    loss = w.mp_step(model, pt.ChainLoss(pt.ChainGraph(den_fst),
                                         device="cpu"),
                     torch.from_numpy(feats), lens,
                     w.linear_batch(seqs, feats.shape[1]))
    return loss, {k: v.detach() for k, v in model.state_dict().items()}


CELLS = [f"{k}-{m}" for k in w.MP_MODELS for m in w.MP_MESHES]


@pytest.mark.parametrize("cell", CELLS)
def test_step_matches_one_process(ranks, cell):
    loss, state = _one_process(cell.split("-")[0])
    for r in _case(ranks, "mp_models"):
        got = r[cell]
        assert abs(got["loss"] - loss) <= 1e-5 * max(1.0, abs(loss))
        assert set(got["state"]) == set(state)
        for k, v in state.items():
            assert _rel_norm(got["state"][k], v) <= 1e-5, (cell, k)


@pytest.mark.parametrize("cell", CELLS)
def test_plain_tensors_bit_identical_across_mp(ranks, cell):
    """What is not placed (biases, BatchNorm, its statistics, the TDNN-F
    bottleneck) holds the same bits on the mp ranks of a dp index, and
    so does the loss."""
    res = [r[cell] for r in _case(ranks, "mp_models")]
    groups = {}
    for rank, r in enumerate(res):
        groups.setdefault((rank // 2, r["dp"]), []).append(r)
    assert len(groups) == 2 and all(len(g) == 2 for g in groups.values())
    for a, b in groups.values():
        assert {a["mp"], b["mp"]} == {0, 1}
        assert set(a["plain"]) == set(b["plain"])
        for k in a["plain"]:
            assert torch.equal(a["plain"][k], b["plain"][k]), (cell, k)
        assert a["loss"] == b["loss"]


@pytest.mark.parametrize("cell", CELLS)
def test_local_shards_are_half_of_each_kernel(ranks, cell):
    kind = cell.split("-")[0]
    want = ({f"layers.{i}.conv.weight" for i in range(2)} if kind == "tdnn"
            else {f"layers.{i}.affine.weight" for i in range(3)})
    want.add("classifier.weight")
    for r in _case(ranks, "mp_models"):
        got = r[cell]
        assert set(got["placed"]) == want
        for k, v in got["state"].items():
            shape = list(v.shape)
            if k in want:
                d = 1 if k == "classifier.weight" else 0
                shape[d] //= 2
            assert got["local_shapes"][k] == tuple(shape), k
        if kind == "tdnnf":
            # the bottleneck stays whole and semi-orthogonal updates it
            assert not any("linear_bottleneck" in k for k in got["placed"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_parameter_is_a_dtensor_once_placed(ranks, cell):
    """Placement leaves no plain parameter, so that an optimizer takes
    model.parameters() as they come (torch's foreach optimizers refuse a
    list that mixes DTensors and tensors)."""
    for r in _case(ranks, "mp_models"):
        assert r[cell]["plain_params"] == []


def test_make_mesh_leaves_the_statistics_group(ranks):
    assert all(r["unchanged"] for r in _case(ranks, "mp_stats"))


def test_models_load_no_parallel_stack():
    code = ("import sys, pychain_tpu_torch.models, pychain_tpu_torch.convert;"
            " print([m for m in sys.modules if m.startswith("
            "'pychain_tpu_torch.parallel')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


@pytest.mark.parametrize("mesh", w.MP_MESHES)
def test_tdnnf_bottleneck_stays_whole_under_the_constraint(ranks, mesh):
    """The semi-orthogonal update ran on each rank's whole bottleneck: the
    same as one process's update, bit-identical across the mp ranks."""
    _, state = _one_process("tdnnf")
    for r in _case(ranks, "mp_models"):
        got = r[f"tdnnf-{mesh}"]
        for i in range(3):
            k = f"layers.{i}.linear_bottleneck.weight"
            assert k in got["plain"] and got["local_shapes"][k] == tuple(
                state[k].shape)
            assert _rel_norm(got["plain"][k], state[k]) <= 1e-5


def test_adam_over_model_parameters_matches_one_process(ranks):
    """Adam over model.parameters() as they come (every one a DTensor on
    the placed model) on the (2 x 2) mesh: two steps' losses and the
    state after them those of one process (1e-5)."""
    den_fst, P, seqs, feats, lens = w.problem_model()
    model = w.mp_model("tdnn", P, feats.shape[2])
    losses = w.mp_adam_steps(model, pt.ChainLoss(pt.ChainGraph(den_fst),
                                                 device="cpu"),
                             torch.from_numpy(feats), lens,
                             w.linear_batch(seqs, feats.shape[1]))
    for r in _case(ranks, "mp_adam"):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        for k, v in model.state_dict().items():
            assert _rel_norm(r["state"][k], v.detach()) <= 1e-5, k


def test_dropout_masks_agree_across_mp(ranks):
    den_fst, P, seqs, feats, lens = w.problem_model()
    x = torch.from_numpy(feats)
    ref = w.mp_model("tdnn", P, feats.shape[2], dropout=0.5)(
        x, train=True).detach()
    outs = [r["out"] for r in _case(ranks, "mp_dropout")]
    kept = w.mp_model("tdnn", P, feats.shape[2])(x, train=True).detach()
    assert (ref - kept).abs().max() > 0.1          # the masks dropped some
    for o in outs:
        torch.testing.assert_close(o, ref, rtol=0, atol=1e-5)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[2], outs[3])


@pytest.mark.parametrize("part", ["copy_to_mp", "gather_from_mp",
                                  "scatter_to_mp", "reduce_from_mp"])
def test_collectives_forward_and_backward(ranks, part):
    """copy_to_mp's all-reduce shows in the column product's x gradient,
    gather_from_mp in its output and weight gradient, scatter_to_mp's
    all-gather in the row product's x gradient, reduce_from_mp in its
    output and weight gradient."""
    name, keys = {"copy_to_mp": ("column", ["gx"]),
                  "gather_from_mp": ("column", ["y", "gw"]),
                  "scatter_to_mp": ("row", ["gx"]),
                  "reduce_from_mp": ("row", ["y", "gw"])}[part]
    for r in _case(ranks, "mp_collectives"):
        for k in keys:
            torch.testing.assert_close(r[name][k], r[name][f"{k}_ref"],
                                       rtol=1e-6, atol=1e-6)


def test_dryrun_prints_the_graft_lines(ranks):
    res = _case(ranks, "mp_dryrun")
    lines = res[0]["printed"].strip().splitlines()
    assert len(lines) == 2
    assert re.fullmatch(r"dryrun_multichip\(4\): den engine="
                        r"FactorizedArrays\[\w+\] num engine=LinearArrays",
                        lines[0])
    assert re.fullmatch(r"dryrun_multichip\(4\): mesh=\(2x2\) "
                        r"loss=\d+\.\d{6} ok", lines[1])
    assert all(r["printed"] == "" for r in res[1:])
    assert all(r["lines"] == lines for r in res)
    assert [(r["n_dp"], r["n_mp"]) for r in res] == [(2, 2)] * 4


def test_dryrun_loss_matches_the_jax_entry(ranks, graft_step):
    ref = graft_step["entry_loss"]
    assert abs(graft_step["step_loss"] - ref) <= 1e-6 * abs(ref)
    for r in _case(ranks, "mp_dryrun"):
        assert abs(r["loss"] - ref) <= 1e-5 * abs(ref), (r["loss"], ref)
        assert f"loss={ref:.6f}" in r["lines"][1]


def test_dryrun_step_matches_jax_value_and_grad(ranks, graft_step):
    want = _flatten(graft_step["after"])
    for r in _case(ranks, "mp_dryrun"):
        got = _flatten(r["flax"])
        assert set(got) == set(want)
        for k, v in want.items():
            assert _rel_norm(got[k], v) <= 1e-5, k
        # param_spec: every kernel's output dim over "mp"
        assert r["placed"] == ["classifier.weight", "layers.0.conv.weight",
                               "layers.1.conv.weight"]
        assert r["local_shapes"]["classifier.weight"] == (12, 32)


def test_convert_slices_and_gathers(ranks, graft_step):
    flax = _flatten(graft_step["variables"])
    for r in _case(ranks, "mp_convert"):
        mp = r["mp"]
        for spec, cls_dim in (("own", 1), ("param_spec", 0)):
            loc = r[spec]["local"]
            for i in range(2):
                k = flax[("params", f"TDNNLayer_{i}", "Conv_0", "kernel")]
                want = torch.from_numpy(np.array(k)).permute(2, 1, 0) \
                    .chunk(2, 0)[mp]
                assert torch.equal(loc[f"layers.{i}.conv.weight"], want)
            dense = torch.from_numpy(np.array(
                flax[("params", "Dense_0", "kernel")])).T
            assert torch.equal(loc["classifier.weight"],
                               dense.chunk(2, cls_dim)[mp])
            back = _flatten(r[spec]["back"])
            assert set(back) == set(flax)
            for key, v in flax.items():
                np.testing.assert_array_equal(back[key], v)


def test_replicate_to_global_over_the_whole_mesh(ranks):
    for r in _case(ranks, "mp_replicate"):
        np.testing.assert_array_equal(r["w"], np.zeros(3, np.float32))


def test_sharded_checkpoint_of_an_mp_placed_tdnn(ranks):
    for r in _case(ranks, "mp_checkpoint"):
        assert r == {"step": 3, "placed_back": True, "whole_back": True,
                     "differed": True}


def test_refusals(ranks):
    for r in _case(ranks, "mp_refusals"):
        assert "does not divide" in r["indivisible"]
        assert "dp dim alone" in r["world_sum"]
        assert "output (dim 0) or input features" in r["taps"]
        assert "whole bottleneck" in r["bottleneck"]


def test_mp_axis_without_a_mesh_is_the_whole_model():
    den_fst, P, seqs, feats, lens = w.problem_model()
    x = torch.from_numpy(feats)
    for kind in w.MP_MODELS:
        model = w.mp_model(kind, P, feats.shape[2])
        plain = type(model)(
            type(model.config)(**{**model.config.__dict__, "mp_axis": None}),
            feats.shape[2], device="cpu")
        for a, b in zip(model.state_dict().values(),
                        plain.state_dict().values()):
            assert type(a) is torch.Tensor and torch.equal(a, b)
        assert torch.equal(model(x, train=True), plain(x, train=True))


def test_make_mesh_must_cover_the_group():
    from pychain_tpu_torch import parallel
    assert not torch.distributed.is_initialized()
    for shape in ((1, 2), (2, 1), (2, 2)):
        with pytest.raises(ValueError, match="mesh needs"):
            parallel.make_mesh(*shape, device="cpu")
    assert not torch.distributed.is_initialized()
    try:
        mesh = parallel.make_mesh(1, 1, device="cpu")
        assert mesh.mesh_dim_names == ("dp", "mp")
        model = w.mp_model("tdnn", 12, 16, mesh)      # an mp dim of 1
        assert all(type(p) is torch.nn.Parameter
                   and type(p.data) is torch.Tensor
                   for p in model.parameters())
    finally:
        torch.distributed.destroy_process_group()


def test_dryrun_cli_starts_its_ranks():
    """``python -m pychain_tpu_torch.tools.dryrun_multichip --n 2 --device
    cpu`` outside a job starts its 2 ranks (gloo on the CPU, a time
    limit, every exit code checked) and prints rank 0's two lines."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    for k in ("RANK", "WORLD_SIZE"):
        env.pop(k, None)
    out = subprocess.run(
        [sys.executable, "-m", "pychain_tpu_torch.tools.dryrun_multichip",
         "--n", "2", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == ("dryrun_multichip(2): den engine=FactorizedArrays"
                        "[pallas] num engine=LinearArrays")
    assert re.fullmatch(r"dryrun_multichip\(2\): mesh=\(1x2\) "
                        r"loss=\d+\.\d{6} ok", lines[1])
