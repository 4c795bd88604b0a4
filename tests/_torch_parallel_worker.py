"""One rank of tests/test_torch_parallel.py's job, or of
tests/test_torch_model_parallel.py's (the port only, no JAX).

    python tests/_torch_parallel_worker.py RANK WORLD PORT OUT_DIR [mp]

Joins a gloo group of WORLD processes on the CPU
(``parallel.initialize("localhost:PORT", ...)``), runs every case of
CASES (with ``mp``: MP_CASES, on 4 ranks) with its own rows of each
global batch, and writes ``OUT_DIR/rank<RANK>.pt``: {case: {name:
value}}, or {"error": text} for a case that raised.  The global problems
are built from numpy seeds by the ``problem_*`` functions below, which
the test modules import to build their single-process references.
"""

import functools
import os
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import pychain_tpu_torch as pt  # noqa: E402
from pychain_tpu_torch.graphs.builder import (  # noqa: E402
    ChainTopology, make_constrained_numerator)
from pychain_tpu_torch.utils.testgraphs import (  # noqa: E402
    denominator_fst, linear_fst)

TDNN_FLAGS = ["--steps", "3", "--utts", "16", "--batch-size", "4",
              "--min-t", "20", "--max-t", "40", "--verbose", "0",
              "--device", "cpu"]
RECIPE_FLAGS = ["--device", "cpu", "--steps", "3", "--batch-size", "8",
                "--corpus-utts", "16", "--warmup-steps", "1",
                "--diag-every", "2"]


# ----------------------------------------------------------------------
# The global problems (tests/test_data_parallel.py's _setup and cases)
# ----------------------------------------------------------------------

def problem_setup(seed, B=8, T=10):
    """(den_fst, P, pdf sequences, x, lengths) of
    tests/test_data_parallel.py::_setup."""
    rng = np.random.RandomState(seed)
    den_fst, P = denominator_fst(num_phones=8, states_per_phone=2,
                                 seed=seed)
    seqs = [rng.randint(0, P, size=T) for _ in range(B)]
    x = rng.randn(B, T, P).astype(np.float32)
    return den_fst, P, seqs, x, np.full((B,), T, np.int32)


def problem_unequal():
    den_fst, P, _, x, _ = problem_setup(4)
    rng = np.random.RandomState(4)
    lengths = np.array([10, 9, 8, 7, 10, 9, 8, 7], np.int32)
    seqs = [rng.randint(0, P, size=int(n)) for n in lengths]
    return den_fst, P, seqs, x, lengths


def problem_shared_num():
    rng = np.random.RandomState(6)
    den_fst, P = denominator_fst(num_phones=8, states_per_phone=2, seed=6)
    x = rng.randn(8, 10, P).astype(np.float32)
    return den_fst, P, x, np.full((8,), 10, np.int32)


def problem_xent():
    den_fst, P, seqs, x, lengths = problem_setup(7)
    xent = np.random.RandomState(8).randn(*x.shape).astype(np.float32)
    return den_fst, P, seqs, x, xent, lengths


def problem_constrained():
    """Tolerance-1 constrained numerators (time-synchronous)."""
    rng = np.random.RandomState(11)
    den_fst, P = denominator_fst(num_phones=8, states_per_phone=2, seed=11)
    topo = ChainTopology(num_phones=P // 2)
    fsts, lengths = [], []
    for _ in range(8):
        phones = [int(p) for p in rng.randint(0, topo.num_phones, size=3)]
        durs = [int(d) for d in rng.randint(2, 5, size=3)]
        fsts.append(make_constrained_numerator(phones, durs, topo,
                                               tolerance=1))
        lengths.append(sum(durs))
    lengths = np.array(lengths, np.int32)
    x = rng.randn(8, int(lengths.max()), P).astype(np.float32)
    return den_fst, P, fsts, x, lengths


def problem_multihost():
    """tests/_multihost_worker.py's problem (B=4, T=10)."""
    rng = np.random.RandomState(0)
    den_fst, P = denominator_fst(num_phones=8, states_per_phone=2, seed=0)
    seqs = [rng.randint(0, P, size=10) for _ in range(4)]
    x = rng.randn(4, 10, P).astype(np.float32)
    return den_fst, P, seqs, x, np.full((4,), 10, np.int32)


def problem_model(T=24, F=16):
    """Features, lengths and linear numerators for a small TDNN step."""
    rng = np.random.RandomState(21)
    den_fst, P = denominator_fst(num_phones=6, states_per_phone=2, seed=21)
    lengths = np.array([24, 20, 24, 17, 22, 24, 19, 24], np.int32)
    B = len(lengths)
    seqs = [rng.randint(0, P, size=int(n)) for n in lengths]
    feats = rng.randn(B, T, F).astype(np.float32)
    return den_fst, P, seqs, feats, lengths


def small_tdnn(P, F):
    from pychain_tpu_torch.models import TDNN, TDNNConfig
    cfg = TDNNConfig(num_pdfs=P, hidden_dim=32, kernel_sizes=(3, 3),
                     dilations=(1, 2), strides=(1, 1), dropout=0.0)
    return TDNN(cfg, F, device="cpu")


def linear_batch(seqs, T):
    nums = [pt.ChainGraph(linear_fst(s), log_domain=True) for s in seqs]
    return pt.ChainGraphBatch(nums, max_num_transitions=T,
                              max_num_states=T + 1, device="cpu")


# ----------------------------------------------------------------------
# The cases, one rank's side
# ----------------------------------------------------------------------

def _grad_of(fn, *xs):
    ts = [torch.from_numpy(np.ascontiguousarray(v)).requires_grad_(True)
          for v in xs]
    out = fn(*ts)
    out.backward()
    return float(out.detach()), [t.grad.numpy() for t in ts]


def case_factorized(mesh, rows):
    from pychain_tpu_torch.ops.factorized import FactorizedArrays
    from pychain_tpu_torch.parallel import ShardedChainLoss
    den_fst, P, seqs, x, lens = problem_setup(0)
    loss = ShardedChainLoss(mesh, pt.ChainGraph(den_fst), impl="factorized")
    got = loss(torch.from_numpy(x[rows]), lens[rows],
               linear_batch(seqs, 10))
    return {"loss": float(got),
            "factorized": isinstance(loss.den_arrays(1), FactorizedArrays)}


def case_grad(mesh, rows):
    from pychain_tpu_torch.parallel import ShardedChainLoss
    den_fst, P, seqs, x, lens = problem_setup(1)
    loss = ShardedChainLoss(mesh, pt.ChainGraph(den_fst), impl="factorized")
    nums = [seqs[i] for i in range(len(seqs))[rows]]
    v, (g,) = _grad_of(lambda t: loss(t, lens[rows], linear_batch(nums, 10)),
                       x[rows])
    return {"loss": v, "grad": g}


def case_cache(mesh, rows):
    """The JAX test's jit-once contract: one denominator build for
    repeated steps of one local batch size, values flowing."""
    from pychain_tpu_torch.parallel import ShardedChainLoss
    den_fst, P, seqs, x, lens = problem_setup(2)
    loss = ShardedChainLoss(mesh, pt.ChainGraph(den_fst))
    num = linear_batch(seqs, 10)
    v1 = float(loss(torch.from_numpy(x[rows]), lens[rows], num))
    den = loss._den_cache[x[rows].shape[0]]
    v2 = float(loss(torch.from_numpy(x[rows] * 1.01), lens[rows], num))
    return {"v1": v1, "v2": v2, "n_den": len(loss._den_cache),
            "same_den": loss._den_cache[x[rows].shape[0]] is den}


def case_indivisible(mesh, rows):
    from pychain_tpu_torch.parallel import ShardedChainLoss, shard_batch
    den_fst, P, seqs, x, lens = problem_setup(0)
    loss = ShardedChainLoss(mesh, pt.ChainGraph(den_fst))
    out = {}
    # a global batch of 3 rows over 2 ranks: rank 0 holds 2, rank 1 one
    mine = slice(0, 2) if rows.start == 0 else slice(2, 3)
    try:
        loss(torch.from_numpy(x[mine]), lens[mine],
             linear_batch(seqs[mine], 10))
        out["call"] = ""
    except ValueError as e:
        out["call"] = str(e)
    try:
        shard_batch(mesh, {"x": x[:3]})
        out["shard"] = ""
    except ValueError as e:
        out["shard"] = str(e)
    return out


def case_pjit_shared(mesh, rows):
    from pychain_tpu_torch.parallel import pjit_chain_function
    den_fst, P, seqs, x, lens = problem_setup(3)
    batch = pt.ChainGraphBatch(pt.ChainGraph(den_fst), 1, device="cpu")
    fn = pjit_chain_function(mesh, batch, impl="factorized")
    return {"value": float(fn(torch.from_numpy(x[rows]), lens[rows]))}


def case_unequal(mesh, rows):
    from pychain_tpu_torch.parallel import ShardedChainLoss
    den_fst, P, seqs, x, lens = problem_unequal()
    nums = [pt.ChainGraph(linear_fst(s), log_domain=True) for s in seqs]
    num_b = pt.ChainGraphBatch(nums, max_num_transitions=10,
                               max_num_states=11, device="cpu")
    loss = ShardedChainLoss(mesh, pt.ChainGraph(den_fst))
    # the whole batch's numerators: each rank takes its rows
    return {"loss": float(loss(torch.from_numpy(x[rows]), lens[rows],
                               num_b))}


def case_bf16(mesh, rows):
    from pychain_tpu_torch.parallel import ShardedChainLoss
    den_fst, P, seqs, x, lens = problem_setup(2)
    loss = ShardedChainLoss(mesh, pt.ChainGraph(den_fst), impl="pallas",
                            tile_dtype="bfloat16")
    v = float(loss(torch.from_numpy(x[rows]), lens[rows],
                   linear_batch(seqs, 10)))
    return {"loss": v, "tiles": str(loss.den_arrays(4).w1.tiles.dtype)}


def case_pjit_linear(mesh, rows):
    from pychain_tpu_torch.loss import dispatch_arrays
    from pychain_tpu_torch.ops.linear import LinearArrays
    from pychain_tpu_torch.parallel import engine_pspec, pjit_chain_function
    den_fst, P, seqs, x, lens = problem_setup(5)
    num_b = linear_batch(seqs, 10)
    arrs = dispatch_arrays(num_b, "auto")
    fn = pjit_chain_function(mesh, num_b)
    return {"linear": isinstance(arrs, LinearArrays),
            "spec": engine_pspec(arrs),
            "value": float(fn(torch.from_numpy(x[rows]), lens[rows]))}


def case_shared_num(mesh, rows):
    from pychain_tpu_torch.parallel import ShardedChainLoss, engine_pspec
    from pychain_tpu_torch.loss import dispatch_arrays
    den_fst, P, x, lens = problem_shared_num()
    num_b = pt.ChainGraphBatch(pt.ChainGraph(den_fst, log_domain=True),
                               x[rows].shape[0], device="cpu")
    loss = ShardedChainLoss(mesh, pt.ChainGraph(den_fst))
    return {"loss": float(loss(torch.from_numpy(x[rows]), lens[rows],
                               num_b)),
            "spec": engine_pspec(dispatch_arrays(num_b))}


def case_xent(mesh, rows):
    from pychain_tpu_torch.parallel import ShardedChainLoss
    den_fst, P, seqs, x, xent, lens = problem_xent()
    loss = ShardedChainLoss(mesh, pt.ChainGraph(den_fst), impl="factorized",
                            xent_regularize=0.1, l2_regularize=1e-3)
    nums = [seqs[i] for i in range(len(seqs))[rows]]
    v, (gx, gxe) = _grad_of(
        lambda a, b: loss(a, lens[rows], linear_batch(nums, 10), b),
        x[rows], xent[rows])
    return {"loss": v, "grad_x": gx, "grad_xent": gxe}


def case_xent_contract(mesh, rows):
    from pychain_tpu_torch.parallel import ShardedChainLoss
    den_fst, P, seqs, x, lens = problem_setup(9)
    xt = torch.from_numpy(x[rows])
    num = linear_batch(seqs, 10)
    out = {}
    for name, kw, xo in (("plain", {}, xt), ("reg", {"xent_regularize": 0.1},
                                             None)):
        try:
            ShardedChainLoss(mesh, pt.ChainGraph(den_fst), impl="factorized",
                             **kw)(xt, lens[rows], num, xent_out=xo)
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def case_constrained(mesh, rows):
    from pychain_tpu_torch.loss import dispatch_arrays
    from pychain_tpu_torch.parallel import ShardedChainLoss
    den_fst, P, fsts, x, lens = problem_constrained()
    graphs = [pt.ChainGraph(f, log_domain=True) for f in fsts]
    num_b = pt.ChainGraphBatch(
        graphs, max_num_transitions=max(g.num_transitions for g in graphs),
        max_num_states=max(g.num_states for g in graphs), device="cpu")
    loss = ShardedChainLoss(mesh, pt.ChainGraph(den_fst), impl="factorized")
    out = {"loss": float(loss(torch.from_numpy(x[rows]), lens[rows],
                              num_b))}
    # the whole batch's engine arrays (impl="leveled", the JAX package's
    # banded engine, is the port's auto: the semiring arrays): each rank
    # takes its rows
    lev = dispatch_arrays(num_b, "leveled")
    out["leveled"] = float(loss(torch.from_numpy(x[rows]), lens[rows], lev))
    return out


def case_multihost(mesh, rows, ckpt_dir):
    """tests/_multihost_worker.py: a 1-D dp mesh over every rank, each
    rank's own numerators and rows, the sharded checkpoint round trip."""
    from pychain_tpu_torch.parallel import (ShardedChainLoss, global_dp_mesh,
                                            host_local_batch_to_global,
                                            replicate_to_global,
                                            restore_sharded, save_sharded)
    from pychain_tpu_torch.loss import dispatch_arrays
    gmesh = global_dp_mesh(device="cpu")
    den_fst, P, seqs, x, lens = problem_multihost()
    B, T = x.shape[:2]
    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    lo, hi = rank * B // world, (rank + 1) * B // world
    local_nums = dispatch_arrays(linear_batch(seqs[lo:hi], T), "auto")
    x_g = host_local_batch_to_global(gmesh, x[lo:hi])
    len_g = host_local_batch_to_global(gmesh, lens[lo:hi])
    loss = float(ShardedChainLoss(gmesh, pt.ChainGraph(den_fst))(
        x_g, len_g, local_nums))
    seed = replicate_to_global(gmesh, {"w": np.full(3, rank, np.float32)})
    state = {"x": x_g, "step_scale": torch.tensor(3.0)}
    save_sharded(ckpt_dir, 7, state)
    step, restored = restore_sharded(ckpt_dir, state)
    # a plain template of the global shape gets the whole array
    _, whole = restore_sharded(ckpt_dir, {"x": torch.zeros(B, T, P),
                                          "step_scale": torch.tensor(0.0)})
    return {"loss": loss, "step": step,
            "restored_rows": restored["x"].to_local().numpy(),
            "rows": x[lo:hi], "step_scale": float(restored["step_scale"]),
            "whole": whole["x"].numpy(), "seed": seed["w"].numpy(),
            "local_is_rows": bool(torch.equal(x_g.to_local(),
                                              torch.from_numpy(x[lo:hi])))}


def case_grad_rule(mesh, rows):
    """A TDNN step's parameter gradients: each rank's before the sum and
    after sum_gradients (the test holds the sum to one process on the
    whole batch)."""
    from pychain_tpu_torch.parallel import ShardedChainLoss, sum_gradients
    den_fst, P, seqs, feats, lens = problem_model()
    model = small_tdnn(P, feats.shape[2])
    loss_fn = ShardedChainLoss(mesh, pt.ChainGraph(den_fst))
    nums = [seqs[i] for i in range(len(seqs))[rows]]
    out = model(torch.from_numpy(feats[rows]), train=False)
    loss = loss_fn(out, lens[rows], linear_batch(nums, feats.shape[1]))
    loss.backward()
    before = {n: p.grad.clone().numpy() for n, p in model.named_parameters()}
    sum_gradients(list(model.parameters()))
    return {"loss": float(loss), "before": before,
            "after": {n: p.grad.numpy() for n, p in model.named_parameters()}}


def case_batchnorm(mesh, rows):
    """Train-mode BatchNorm over the ranks: the whole batch's
    statistics (outputs, running statistics) and, through a loss, the
    parameter gradients after sum_gradients."""
    from pychain_tpu_torch.parallel import ShardedChainLoss, sum_gradients
    den_fst, P, seqs, feats, lens = problem_model()
    model = small_tdnn(P, feats.shape[2])
    loss_fn = ShardedChainLoss(mesh, pt.ChainGraph(den_fst))
    nums = [seqs[i] for i in range(len(seqs))[rows]]
    out = model(torch.from_numpy(feats[rows]), train=True)
    loss = loss_fn(out, lens[rows], linear_batch(nums, feats.shape[1]))
    loss.backward()
    sum_gradients(list(model.parameters()))
    return {"loss": float(loss), "out": out.detach().numpy(),
            "buffers": {n: b.numpy() for n, b in model.named_buffers()},
            "grads": {n: p.grad.numpy()
                      for n, p in model.named_parameters()}}


def case_examples(mesh, rows):
    """train_tdnn and the corpus recipe with --dp (both ranks), then,
    on rank 0, the same runs in one process on the whole batch."""
    from pychain_tpu_torch.examples import train_corpus, train_tdnn
    out = {"tdnn_dp": train_tdnn.main(TDNN_FLAGS + ["--dp"])["losses"]}
    for name, extra in (("recipe", []), ("recipe_staged",
                                         ["--device-corpus"])):
        r = train_corpus.main(RECIPE_FLAGS + extra + ["--dp"])
        out[f"{name}_dp"] = r["losses"]
        out[f"{name}_ok"] = r["ok"]
        out[f"{name}_world"] = r["dp"]
    if torch.distributed.get_rank() == 0:
        out["tdnn"] = train_tdnn.main(TDNN_FLAGS)["losses"]
        for name, extra in (("recipe", []), ("recipe_staged",
                                             ["--device-corpus"])):
            out[name] = train_corpus.main(RECIPE_FLAGS + extra)["losses"]
    torch.distributed.barrier()
    return out


def spawn_target(argv):
    """A rank of tests/test_torch_parallel.py's spawn_per_card case:
    joins the group as an example's --dp does (gloo on the CPU), sums a
    one over the ranks, and returns int(argv[0]) losses (with a model,
    which spawn_per_card leaves out)."""
    from pychain_tpu_torch.parallel.multihost import join_job
    rank, world, _ = join_job("cpu")
    ones = torch.ones(1)
    torch.distributed.all_reduce(ones)
    torch.distributed.destroy_process_group()
    return {"losses": [float(i) for i in range(int(argv[0]))],
            "world": int(ones.item()), "rank": rank, "model": object()}


CASES = ("factorized", "grad", "cache", "indivisible", "pjit_shared",
         "unequal", "bf16", "pjit_linear", "shared_num", "xent",
         "xent_contract", "constrained", "multihost", "grad_rule",
         "batchnorm", "examples")


# ----------------------------------------------------------------------
# The model axis: 4 ranks, a (2 x 2) mesh and two (1 x 2) meshes
# ----------------------------------------------------------------------

MP_MODELS = ("tdnn", "tdnnf")
MP_MESHES = ("2x2", "1x2")
MP_LR = 0.1


def mp_model(kind, P, F, mesh=None, dropout=0.0):
    """A small model of ``kind`` with ``mp_axis="mp"``, seeded alike on
    every rank, placed over ``mesh`` by its own annotations (whole
    without a mesh)."""
    from pychain_tpu_torch.models import TDNN, TDNNConfig, TDNNF, \
        TDNNFConfig
    if kind == "tdnn":
        cfg = TDNNConfig(num_pdfs=P, hidden_dim=32, kernel_sizes=(3, 3),
                         dilations=(1, 2), strides=(1, 1), dropout=dropout,
                         mp_axis="mp")
        return TDNN(cfg, F, device="cpu", mesh=mesh)
    cfg = TDNNFConfig(num_pdfs=P, hidden_dim=32, bottleneck_dim=8,
                      num_layers=3, kernel_size=2, dilations=(1, 1, 2),
                      mp_axis="mp")
    return TDNNF(cfg, F, device="cpu", mesh=mesh)


def mp_step(model, loss_fn, feats, lens, nums, mesh=None):
    """One train-mode step: the loss, backward, the gradients summed over
    the mesh's dp dim, SGD at MP_LR on the local shards; for a TDNN-F
    then the semi-orthogonal update.  Returns the loss."""
    from pychain_tpu_torch.models import TDNNF, constrain_semi_orthogonal
    from pychain_tpu_torch.parallel import sum_gradients
    from pychain_tpu_torch.parallel.model_parallel import local
    loss = loss_fn(model(feats, train=True), lens, nums)
    loss.backward()
    if mesh is not None:
        sum_gradients(model.parameters(), mesh)
    with torch.no_grad():
        for p in model.parameters():
            local(p).sub_(MP_LR * local(p.grad))
    if isinstance(model, TDNNF):
        constrain_semi_orthogonal(model)
    return float(loss.detach())


@functools.lru_cache(maxsize=1)
def _meshes():
    """{"2x2": the (dp, mp) mesh over the 4 ranks, "1x2": this rank's pair
    (ranks 0-1 or 2-3) as a (1 x 2) sub-mesh of a (pair, dp, mp) mesh},
    made once."""
    from torch.distributed.device_mesh import init_device_mesh
    from pychain_tpu_torch.parallel import make_mesh
    pairs = init_device_mesh("cpu", (2, 1, 2),
                             mesh_dim_names=("pair", "dp", "mp"))
    return {"2x2": make_mesh(2, 2, device="cpu"),
            "1x2": pairs["dp", "mp"]}


def _placement(model):
    from torch.distributed.tensor import DTensor
    from pychain_tpu_torch.parallel.model_parallel import local, mp_shard, \
        whole
    return {"placed": sorted(k for k, v in model.named_parameters()
                             if mp_shard(v) is not None),
            "plain_params": sorted(
                k for k, v in model.named_parameters()
                if not isinstance(v, DTensor)),
            "local_shapes": {k: tuple(local(v).shape)
                             for k, v in model.state_dict().items()},
            "plain": {k: local(v).detach().clone() for k, v in
                      model.state_dict().items() if mp_shard(v) is None},
            "state": {k: whole(v).detach().clone()
                      for k, v in model.state_dict().items()}}


def case_mp_models(out_dir):
    """TDNN and TDNN-F, each on the (2 x 2) and on a (1 x 2) mesh: one
    train-mode step of this rank's dp rows (ShardedChainLoss), the state
    after it gathered whole, the plain tensors as they are, the local
    shapes."""
    from pychain_tpu_torch.parallel import ShardedChainLoss, shard_batch
    den_fst, P, seqs, feats, lens = problem_model()
    out = {}
    for name, mesh in _meshes().items():
        for kind in MP_MODELS:
            model = mp_model(kind, P, feats.shape[2], mesh)
            loss_fn = ShardedChainLoss(mesh, pt.ChainGraph(den_fst))
            x, lx = shard_batch(mesh, (torch.from_numpy(feats), lens))
            loss = mp_step(model, loss_fn, x, lx,
                           linear_batch(seqs, feats.shape[1]), mesh)
            out[f"{kind}-{name}"] = {
                "loss": loss, "dp": mesh.get_local_rank("dp"),
                "mp": mesh.get_local_rank("mp"), **_placement(model)}
    return out


def mp_adam_steps(model, loss_fn, feats, lens, nums, mesh=None, steps=2):
    """``steps`` train-mode steps with Adam (1e-3) over
    ``model.parameters()`` as they come (on a placed model every one a
    DTensor), the gradients summed over the mesh's dp dim.  Returns the
    losses."""
    from pychain_tpu_torch.parallel import sum_gradients
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model(feats, train=True), lens, nums)
        loss.backward()
        if mesh is not None:
            sum_gradients(model.parameters(), mesh)
        opt.step()
        losses.append(float(loss.detach()))
    return losses


def case_mp_adam(out_dir):
    """Two Adam steps of a TDNN on the (2 x 2) mesh: the losses and the
    state after them, gathered whole."""
    from pychain_tpu_torch.parallel import ShardedChainLoss, shard_batch
    from pychain_tpu_torch.parallel.model_parallel import whole
    den_fst, P, seqs, feats, lens = problem_model()
    mesh = _meshes()["2x2"]
    model = mp_model("tdnn", P, feats.shape[2], mesh)
    x, lx = shard_batch(mesh, (torch.from_numpy(feats), lens))
    losses = mp_adam_steps(model, ShardedChainLoss(mesh, pt.ChainGraph(
        den_fst)), x, lx, linear_batch(seqs, feats.shape[1]), mesh)
    return {"losses": losses, "state": {k: whole(v).detach().clone() for k, v
                                        in model.state_dict().items()}}


def case_mp_dropout(out_dir):
    """A TDNN with dropout 0.5 on this rank's (1 x 2) mesh in train mode:
    the whole batch's output (each mp rank draws its masks on the whole
    activations from a generator seeded alike)."""
    from pychain_tpu_torch.utils.dist import set_stats_group
    den_fst, P, seqs, feats, lens = problem_model()
    set_stats_group(None)
    model = mp_model("tdnn", P, feats.shape[2], _meshes()["1x2"],
                     dropout=0.5)
    return {"out": model(torch.from_numpy(feats), train=True).detach()}


def case_mp_collectives(out_dir):
    """Each collective's forward and backward on the (2 x 2) mesh's mp
    groups, in a column- and a row-parallel product against the same
    product whole: outputs and the gradients of x and of the local
    weight."""
    from pychain_tpu_torch.parallel import model_parallel as mpl
    mesh = _meshes()["2x2"]
    group, r = mesh.get_group("mp"), mesh.get_local_rank("mp")
    g = torch.Generator().manual_seed(7 + mesh.get_local_rank("dp"))
    x = torch.randn(5, 8, generator=g)
    w = torch.randn(6, 8, generator=g)
    c = torch.randn(5, 6, generator=g)
    out = {}
    for name, dim in (("column", 0), ("row", 1)):
        xs = x.clone().requires_grad_(True)
        wl = w.chunk(2, dim)[r].clone().requires_grad_(True)
        if dim == 0:
            y = mpl.gather_from_mp(mpl.copy_to_mp(xs, group) @ wl.T, 1,
                                   group)
        else:
            y = mpl.reduce_from_mp(mpl.scatter_to_mp(xs, 1, group) @ wl.T,
                                   group)
        (y * c).sum().backward()
        xw = x.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        ref = xw @ ww.T
        (ref * c).sum().backward()
        out[name] = {"y": y.detach(), "y_ref": ref.detach(),
                     "gx": xs.grad, "gx_ref": xw.grad, "gw": wl.grad,
                     "gw_ref": ww.grad.chunk(2, dim)[r]}
    return out


def case_mp_dryrun(out_dir):
    """The port's dryrun_multichip(4) rank in this job (``run_rank``, which
    ``dryrun_multichip(4)`` calls under a job), on the flax weights of
    __graft_entry__'s _setup (written by the test): its printed lines
    and its result."""
    import contextlib
    import io
    from pychain_tpu_torch.tools import dryrun_multichip as dm
    variables = torch.load(os.path.join(out_dir, "variables.pt"),
                           weights_only=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = dm.run_rank(4, device="cpu", variables=variables)
    return {"printed": buf.getvalue(), **res}


def case_mp_convert(out_dir):
    """model_from_flax(..., mesh=) on the (2 x 2) mesh (the model's own
    annotations), and the whole model placed by dryrun's param_spec: this
    rank's local tensors, and model_to_flax's whole arrays back."""
    import dataclasses
    from pychain_tpu_torch.convert import model_from_flax, model_to_flax
    from pychain_tpu_torch.models import TDNNConfig
    from pychain_tpu_torch.parallel import place_parameters
    from pychain_tpu_torch.parallel.model_parallel import local
    from pychain_tpu_torch.tools.dryrun_multichip import param_spec
    variables = torch.load(os.path.join(out_dir, "variables.pt"),
                           weights_only=False)
    cfg = TDNNConfig(num_pdfs=24, hidden_dim=32, kernel_sizes=(3, 3),
                     dilations=(1, 1), strides=(1, 1), dropout=0.0)
    mesh = _meshes()["2x2"]
    out = {"mp": mesh.get_local_rank("mp")}
    for name in ("own", "param_spec"):
        if name == "own":
            model = model_from_flax(dataclasses.replace(cfg, mp_axis="mp"),
                                    variables, "cpu", mesh=mesh)
        else:
            model = place_parameters(model_from_flax(cfg, variables, "cpu"),
                                     mesh, param_spec)
        out[name] = {"local": {k: local(v).detach().clone() for k, v in
                               model.state_dict().items()},
                     "back": model_to_flax(model)}
    return out


def case_mp_replicate(out_dir):
    """replicate_to_global over the (2 x 2) mesh: rank 0's values on
    every rank (each rank offers its own rank number)."""
    from pychain_tpu_torch.parallel import replicate_to_global
    rank = torch.distributed.get_rank()
    got = replicate_to_global(_meshes()["2x2"],
                              {"w": np.full(3, rank, np.float32)})
    return {"w": got["w"].numpy()}


def case_mp_checkpoint(out_dir):
    """save_sharded / restore_sharded of a TDNN placed over the (2 x 2)
    mesh's mp dim: into a placed model of another seed (each rank its
    shards back) and into a whole model's state (the whole arrays)."""
    from pychain_tpu_torch.models import TDNN
    from pychain_tpu_torch.parallel import restore_sharded, save_sharded
    from pychain_tpu_torch.parallel.model_parallel import local, whole
    den_fst, P, seqs, feats, lens = problem_model()
    mesh = _meshes()["2x2"]
    model = mp_model("tdnn", P, feats.shape[2], mesh)
    state = model.state_dict()
    ckpt = os.path.join(out_dir, "mp_ckpt")
    save_sharded(ckpt, 3, state)
    other = TDNN(model.config, feats.shape[2], device="cpu",
                 generator=torch.Generator().manual_seed(5), mesh=mesh)
    step, back = restore_sharded(ckpt, other.state_dict())
    _, full = restore_sharded(ckpt, mp_model("tdnn", P, feats.shape[2])
                              .state_dict())
    return {"step": step,
            "placed_back": all(torch.equal(local(back[k]), local(v))
                               and type(back[k]) is type(v)
                               for k, v in state.items()),
            "whole_back": all(torch.equal(full[k], whole(v))
                              for k, v in state.items()),
            "differed": not torch.equal(local(other.state_dict()[
                "layers.0.conv.weight"]), local(state[
                    "layers.0.conv.weight"]))}


def case_mp_stats(out_dir):
    """make_mesh leaves the models' statistics group as it finds it (only
    ShardedChainLoss and join_job register one)."""
    from pychain_tpu_torch.parallel import make_mesh
    from pychain_tpu_torch.utils.dist import set_stats_group, stats_group
    group = torch.distributed.group.WORLD
    set_stats_group(group)
    make_mesh(2, 2, device="cpu")
    unchanged = stats_group() is group
    set_stats_group(None)
    return {"unchanged": unchanged}


def case_mp_refusals(out_dir):
    """What the model axis refuses: a dim that does not divide, a sum of
    mp-placed gradients over every rank, a weight's taps sharded, a
    sharded TDNN-F bottleneck under the semi-orthogonal update."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from pychain_tpu_torch.models import constrain_semi_orthogonal
    from pychain_tpu_torch.models.layers import conv_same
    from pychain_tpu_torch.parallel import place_parameters, sum_gradients
    from pychain_tpu_torch.tools.dryrun_multichip import param_spec
    mesh = _meshes()["2x2"]
    out = {}

    def refused(key, fn, exc):
        try:
            fn()
            out[key] = ""
        except exc as e:
            out[key] = str(e)

    refused("indivisible", lambda: place_parameters(
        mp_model("tdnn", 13, 16), mesh, param_spec), ValueError)
    model = mp_model("tdnn", 12, 16, mesh)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    refused("world_sum", lambda: sum_gradients(
        model.parameters(), torch.distributed.group.WORLD), ValueError)
    conv = torch.nn.Conv1d(4, 6, 2)
    conv.weight = torch.nn.Parameter(DTensor.from_local(
        conv.weight.detach()[:, :, :1], mesh, [Replicate(), Shard(2)],
        run_check=False))
    refused("taps", lambda: conv_same(conv, torch.zeros(1, 4, 5)),
            NotImplementedError)
    tdnnf = mp_model("tdnnf", 12, 16)
    place_parameters(tdnnf, mesh, lambda n, p: 0 if p.dim() == 3 else None)
    refused("bottleneck", lambda: constrain_semi_orthogonal(tdnnf),
            ValueError)
    return out


MP_CASES = ("mp_models", "mp_adam", "mp_dropout", "mp_collectives", "mp_dryrun",
            "mp_convert", "mp_replicate", "mp_checkpoint", "mp_stats",
            "mp_refusals")


def main():
    rank, world, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    mp = sys.argv[5:] == ["mp"]
    torch.set_num_threads(1)
    from pychain_tpu_torch.parallel import initialize, make_mesh
    initialize(f"localhost:{port}", world, rank, device="cpu")
    print(f"rank {rank}: joined", file=sys.stderr, flush=True)
    if mp:
        cases, args = MP_CASES, (out_dir,)
    else:
        per = 8 // world
        cases = CASES
        args = (make_mesh(device="cpu"), slice(rank * per, (rank + 1) * per))
    results = {}
    for name in cases:
        print(f"rank {rank}: {name}", file=sys.stderr, flush=True)
        fn = globals()[f"case_{name}"]
        try:
            extra = ((os.path.join(out_dir, "ckpt"),)
                     if name == "multihost" else ())
            results[name] = fn(*args, *extra)
        except Exception:
            results[name] = {"error": traceback.format_exc()}
        torch.distributed.barrier()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
