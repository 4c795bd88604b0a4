"""The port's Viterbi alignment against the JAX package's.

Four batches, each made from a seed with numpy and given to both
packages: "mixed" (cyclic random graphs, a flat-start numerator and a
linear graph at a length it cannot accept, at unequal lengths with one
of 0), "loud" (the same graphs under x of which about a quarter lies
beyond the [-30, 30] clamp, which the port applies as it reads x), "ties" (flat-start numerators, whose arcs all weigh 0, under
oracle emissions of +-8 with extra +8 frames, and a graph of weightless
arcs with every state final under flat emissions, so many paths and end
states score exactly alike and the tie rules decide) and "shared" (one
flat-start graph broadcast over the batch).  The port's plain version
(ops/viterbi.py) is held against the JAX scatter sweep and the B11
Pallas kernel in interpret mode: pdfs, states and ok identical, objf
equal.  No tolerance: every sweep adds the same float32 values in the
same association, (delta + logp) + x, and takes maxima, and JAX's
one-hot emission contraction adds only exact zeros.

The port reads the semiring engine's arc-id form, whose in-arc lists
hold the arcs of the JAX package's backward lists in the same order
(checked below), so the highest id achieving a max names the same arc.
The CUDA kernel cannot run here; an emulation of its walk (in-arc lists
in ascending id order, `>=` tie rule, lowest end state, one-thread
traceback) on the arrays it reads must match JAX too.
tests/test_torch_card.py compares the kernel with the plain version on
the card, bit for bit.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu import viterbi_align as j_viterbi
from pychain_tpu.loss import graph_arrays as j_graph_arrays

import pychain_tpu_torch as pt
from pychain_tpu_torch import loss as pt_loss
from pychain_tpu_torch.convert import viterbi_from_numpy
from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                              alignment_to_pdf_sequence,
                                              make_numerator_fst)
from pychain_tpu_torch.graphs.fst import FST
from pychain_tpu_torch.ops import viterbi as vt
from pychain_tpu_torch.ops import viterbi_kernels as vk
from pychain_tpu_torch.utils.testgraphs import (denominator_fst, linear_fst,
                                                random_fst)

P = 8
TOPO = ChainTopology(num_phones=P // 2)
T = 9


def _case(name, seed=0):
    """(fsts, shared, lengths, x) of one batch."""
    rng = np.random.RandomState(seed)
    if name in ("mixed", "loud"):
        fsts = [random_fst(num_states=7, num_pdfs=P, max_arcs_per_state=3,
                           seed=70 + seed),
                random_fst(num_states=9, num_pdfs=P, max_arcs_per_state=4,
                           seed=71 + seed),
                make_numerator_fst([1, 3, 0], TOPO),
                linear_fst([1, 2, 3]),         # accepts length 3 only
                random_fst(num_states=6, num_pdfs=P, max_arcs_per_state=3,
                           seed=72 + seed)]
        lengths = np.array([9, 7, 6, 5, 0], np.int32)
        x = rng.randn(len(fsts), T, P).astype(np.float32)
        if name == "loud":
            x *= 25.0
        return fsts, False, lengths, x
    if name == "ties":
        plans = [([1, 3, 0], [2, 4, 3]), ([2, 2, 1, 0], [1, 3, 2, 1]),
                 ([3, 0], [4, 1])]
        fsts = [make_numerator_fst(ph, TOPO) for ph, _ in plans]
        x = np.full((len(plans) + 1, T, P), -8.0, np.float32)
        lengths = []
        for b, (ph, du) in enumerate(plans):
            seq = alignment_to_pdf_sequence(ph, du, TOPO)
            x[b, np.arange(len(seq)), seq] = 8.0
            # on about half the frames every pdf of the transcript scores
            # +8 too: staying and moving on tie there
            for t in np.nonzero(rng.rand(T) < 0.5)[0]:
                x[b, t, [f(p) for p in ph
                         for f in (TOPO.fwd_pdf, TOPO.self_pdf)]] = 8.0
            lengths.append(len(seq))
        # an ergodic graph of weightless arcs, every state final, under
        # flat emissions: every path and every reachable end state ties
        fsts.append(FST.from_arcs(
            4, 0, [(s, d, p + 1, p + 1, 0.0) for s, d, p in
                   ((0, 1, 0), (0, 2, 1), (1, 3, 2), (2, 3, 3), (3, 0, 4),
                    (1, 1, 5), (2, 2, 5), (3, 3, 6), (0, 3, 7))],
            {s: 0.0 for s in range(4)}))
        x[-1] = 8.0
        lengths.append(T)
        return fsts, False, np.array(lengths, np.int32), x
    assert name == "shared"
    fst = make_numerator_fst([0, 2, 1], TOPO)
    x = rng.randn(3, T, P).astype(np.float32)
    return [fst], True, np.array([9, 6, 4], np.int32), x


def _batches(fsts, shared, B):
    """The port's batch and the JAX package's, of the same graphs."""
    if shared:
        return (pt.ChainGraphBatch(pt.ChainGraph(fsts[0], log_domain=True),
                                   B, device="cpu"),
                JChainGraphBatch(JChainGraph(fsts[0], log_domain=True), B))
    gs = [pt.ChainGraph(f, log_domain=True) for f in fsts]
    K = max(g.num_transitions for g in gs)
    S = max(g.num_states for g in gs)
    return (pt.ChainGraphBatch(gs, max_num_transitions=K, max_num_states=S,
                               device="cpu"),
            JChainGraphBatch([JChainGraph(f, log_domain=True)
                              for f in fsts],
                             max_num_transitions=K, max_num_states=S))


def _assert_same(got, ref):
    for name in ("pdfs", "states", "ok"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(np.asarray(got.objf),
                                  np.asarray(ref.objf))


@pytest.mark.parametrize("sweep", ["scatter", "pallas"])
@pytest.mark.parametrize("case", ["mixed", "loud", "ties", "shared"])
def test_plain_matches_jax(case, sweep):
    fsts, shared, lengths, x = _case(case)
    mine, theirs = _batches(fsts, shared, x.shape[0])
    # the port first, and JAX on its own copy of x
    got = pt.viterbi_align(torch.from_numpy(x), lengths, mine)
    ref = j_viterbi(jnp.array(x), lengths, theirs, sweep=sweep)
    _assert_same(got, ref)
    if case in ("mixed", "loud"):
        assert got.ok.tolist() == [True, True, True, False, False]
        assert got.objf[3] == got.objf[4] == -np.inf
        assert (got.pdfs[3:] == -1).all() and (got.states[3:] == -1).all()
    assert bool(got.ok[:3].all())


def test_shared_batch_matches_its_listed_copy():
    fsts, _, lengths, x = _case("shared")
    B = x.shape[0]
    shared, _ = _batches(fsts, True, B)
    listed, _ = _batches(fsts * B, False, B)
    assert shared.semiring().rows == 1 and listed.semiring().rows == B
    xt = torch.from_numpy(x)
    a = pt.viterbi_align(xt, lengths, shared)
    b = pt.viterbi_align(xt, lengths, listed)
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ----------------------------------------------------------------------
# Emulation of the CUDA kernel on the arrays it reads
# ----------------------------------------------------------------------

def _emulate(x, lengths, g):
    """csrc/viterbi.cu, one sequence, state and arc at a time, in float32;
    backpointers never written hold a value that fails if read."""
    x = np.asarray(x, np.float32)
    B, T_, _ = x.shape
    S = g.num_states
    a = {k: getattr(g, k).numpy() for k in
         ("src", "pdf", "logp", "in_ptr", "in_arcs", "initial", "final")}
    objf = np.empty(B, np.float32)
    pdfs = np.empty((B, T_), np.int32)
    states = np.empty((B, T_), np.int32)
    neg = np.float32(-np.inf)
    for b in range(B):
        r = 0 if g.rows == 1 else b
        src, pdf, logp, ptr, arcs = (a[k][r] for k in
                                     ("src", "pdf", "logp", "in_ptr",
                                      "in_arcs"))
        cur = a["initial"][r].copy()
        bp = np.full((T_, S), np.iinfo(np.int32).min, np.int64)
        Tb = int(lengths[b])
        for t in range(Tb):
            nxt = np.empty(S, np.float32)
            for s in range(S):
                best, arg = neg, -1
                for j in range(ptr[s], ptr[s + 1]):
                    k = arcs[j]
                    e = min(max(x[b, t, pdf[k]], np.float32(-30.0)),
                            np.float32(30.0))
                    cand = (cur[src[k]] + logp[k]) + e
                    if cand >= best:
                        best, arg = cand, k
                nxt[s] = best
                bp[t, s] = arg if best > neg else -1
            cur = nxt
        end = cur + a["final"][r]
        c, top = 0, end[0]
        for s in range(1, S):
            if end[s] > top:
                c, top = s, end[s]
        objf[b] = top if Tb > 0 else neg
        ok = np.isfinite(objf[b])
        for t in range(T_ - 1, -1, -1):
            out_pdf = out_state = -1
            if ok and t < Tb:
                arc = int(bp[t, c])
                if arc >= 0:
                    out_pdf, out_state, c = int(pdf[arc]), c, int(src[arc])
            pdfs[b, t], states[b, t] = out_pdf, out_state
    return vt.ViterbiResult(objf=objf, pdfs=pdfs, states=states,
                            ok=np.isfinite(objf))


@pytest.mark.parametrize("case", ["mixed", "loud", "ties", "shared"])
def test_kernel_algorithm_emulation_matches_jax(case):
    fsts, shared, lengths, x = _case(case, seed=1)
    mine, theirs = _batches(fsts, shared, x.shape[0])
    got = _emulate(x, lengths, mine.semiring())
    _assert_same(got, pt.viterbi_align(torch.from_numpy(x), lengths, mine))
    _assert_same(got, j_viterbi(jnp.array(x), lengths, theirs,
                                sweep="scatter"))


def test_in_arc_runs_are_the_backward_lists():
    """Each state's in-arc list of the arc-id form holds the arcs of the
    compiler's backward list of that state, in the same order: so the
    highest id achieving a max, in either numbering, is the same arc."""
    fsts, _, _, _ = _case("mixed")
    mine, _ = _batches(fsts, False, len(fsts))
    g = mine.semiring()
    for b, f in enumerate(fsts):
        cg = pt.ChainGraph(f, log_domain=True)
        k, s = cg.num_transitions, cg.num_states
        ptr, arcs = g.in_ptr[b].numpy(), g.in_arcs[b].numpy()
        np.testing.assert_array_equal(ptr[:s],
                                      cg.backward_transition_indices[:, 0])
        np.testing.assert_array_equal(ptr[1:s + 1],
                                      cg.backward_transition_indices[:, 1])
        assert (ptr[s:] == k).all()
        in_order = arcs[:k]
        assert all((np.diff(in_order[ptr[q]:ptr[q + 1]]) > 0).all()
                   for q in range(s))
        got = np.stack([g.src[b].numpy()[in_order], g.dst[b].numpy()[in_order],
                        g.pdf[b].numpy()[in_order]], axis=1)
        np.testing.assert_array_equal(got, cg.backward_transitions)
        np.testing.assert_array_equal(g.logp[b].numpy()[in_order],
                                      cg.backward_transition_probs)
        assert (g.logp[b, k:] == -np.inf).all()


@pytest.mark.parametrize("case", ["mixed", "shared"])
def test_viterbi_from_numpy_of_jax_graph_arrays(case):
    fsts, shared, lengths, x = _case(case, seed=2)
    mine, theirs = _batches(fsts, shared, x.shape[0])
    conv = viterbi_from_numpy(j_graph_arrays(theirs))
    assert conv.rows == mine.semiring().rows
    xt = torch.from_numpy(x)
    a = pt.viterbi_align(xt, lengths, conv)
    b = pt.viterbi_align(xt, lengths, mine)
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    _assert_same(a, j_viterbi(jnp.array(x), lengths, theirs,
                              sweep="scatter"))


def test_loss_on_a_shared_log_domain_batch_raises():
    fsts, _, lengths, x = _case("shared")
    shared, _ = _batches(fsts, True, x.shape[0])
    xt = torch.from_numpy(x)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5"):
        pt_loss.chain_function(xt, lengths, shared)
    loss = pt.ChainLoss(pt.ChainGraph(fsts[0], log_domain=True),
                        device="cpu")
    nums, _ = _batches(fsts * x.shape[0], False, x.shape[0])
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5"):
        loss(xt, lengths, nums)


@pytest.mark.parametrize("built_before", [True, False])
def test_reorder_keeps_each_graph_with_its_sequence(built_before):
    """Linear graphs, whose arc-id form is built only when asked for:
    before the reorder (then it moves) or after it (then it is built from
    the reordered graphs)."""
    rng = np.random.RandomState(3)
    lengths = np.array([9, 7, 6, 5, 3], np.int32)
    fsts = [linear_fst(list(rng.randint(0, P, size=n))) for n in lengths]
    x = rng.randn(len(fsts), T, P).astype(np.float32)
    mine, theirs = _batches(fsts, False, len(fsts))
    assert mine._semiring is None
    if built_before:
        mine.semiring()
    order = [2, 0, 4, 1, 3]
    mine.reorder(order)
    theirs.reorder(order)
    fresh, _ = _batches([fsts[i] for i in order], False, len(fsts))
    # the sequences move with their graphs: each linear graph accepts only
    # its own length, so a graph paired with another sequence fails
    x, lengths = x[order], lengths[order]
    xt = torch.from_numpy(x)
    got = pt.viterbi_align(xt, lengths, mine)
    want = pt.viterbi_align(xt, lengths, fresh)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert bool(got.ok.all())
    _assert_same(got, j_viterbi(jnp.array(x), lengths, theirs,
                                sweep="scatter"))


def test_sweep_names_and_cpu_wrapper_take_the_plain_version():
    fsts, _, lengths, x = _case("loud", seed=4)
    mine, _ = _batches(fsts, False, len(fsts))
    xt = torch.from_numpy(x)
    vk.reset_launch_counts()
    # the plain version clamps as it reads: a clamped copy changes nothing
    ref = vt.viterbi_plain(xt, lengths, mine.semiring())
    clamped = vt.viterbi_plain(torch.clamp(xt, -30, 30), lengths,
                               mine.semiring())
    for name in ref._fields:
        assert torch.equal(getattr(clamped, name), getattr(ref, name)), name
    runs = [pt.viterbi_align(xt, lengths, mine, sweep=s)
            for s in ("auto", "pallas", "scatter", "dense")]
    runs += [pt.viterbi_align(xt, lengths, mine, dense_sweep=d)
             for d in (True, False)]
    runs += [pt.viterbi_align(xt, lengths, mine, emission_mode=m)
             for m in ("onehot", "gather")]
    assert vk.LAUNCHES == {"viterbi": 0}
    for got in runs:
        for name in ref._fields:
            assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_validation():
    fsts, _, lengths, x = _case("mixed")
    mine, _ = _batches(fsts, False, len(fsts))
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="emission_mode"):
        pt.viterbi_align(xt, lengths, mine, emission_mode="dense")
    with pytest.raises(ValueError, match="sweep"):
        pt.viterbi_align(xt, lengths, mine, sweep="leveled")
    with pytest.raises(ValueError, match="exceed the padded"):
        pt.viterbi_align(xt, lengths + 1, mine)
    with pytest.raises(ValueError, match="pdf ids"):
        pt.viterbi_align(xt[:, :, :4], lengths, mine)
    with pytest.raises(ValueError, match="batch size"):
        pt.viterbi_align(xt[:3], lengths[:3], mine)
    den_fst, _ = denominator_fst(num_phones=4, states_per_phone=2, seed=0)
    den = pt.ChainGraphBatch(pt.ChainGraph(den_fst), 2, device="cpu")
    assert den.semiring() is None
    with pytest.raises(ValueError, match="log-domain"):
        pt.viterbi_align(torch.zeros(2, 4, 8), [4, 4], den)


def test_shared_memory_limit():
    g = _batches(*_case("mixed")[:2], 5)[0].semiring()
    assert vk.smem_bytes(512) == 4096 and vk.fits_on_chip(g)
    row = lambda s: torch.zeros(1, s)
    assert vk.fits_on_chip(dataclasses.replace(g, initial=row(29056)))
    assert not vk.fits_on_chip(dataclasses.replace(g, initial=row(29057)))
