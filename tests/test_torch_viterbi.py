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
from pychain_tpu import ChainLoss as JChainLoss
from pychain_tpu import viterbi_align as j_viterbi
from pychain_tpu.loss import chain_function_with_aux as j_aux
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

def _beats_slot(other, mine):
    """The lanes' rule: the larger value, then the larger slot."""
    return other[0] > mine[0] or (other[0] == mine[0] and other[1] > mine[1])


def _beats_state(other, mine):
    """The end scoring's rule: the larger value, then the lower state."""
    return other[0] > mine[0] or (other[0] == mine[0] and other[1] < mine[1])


def _butterfly(pairs, beats):
    """__shfl_xor_sync over len(pairs) lanes: at each offset every lane
    takes its partner's pair if it beats its own.  Returns lane 0's."""
    off = len(pairs) // 2
    while off:
        pairs = [pairs[q ^ off] if beats(pairs[q ^ off], pairs[q])
                 else pairs[q] for q in range(len(pairs))]
        off //= 2
    return pairs[0]


def _emulate(x, lengths, g, lanes):
    """csrc/viterbi.cu, one block a sequence, in float32, on the slot
    lists it loads (each slot's arc's source, pdf and log weight through
    in_arcs): state group s of ``lanes`` lanes,
    lane l walking slots in_ptr[s] + l, + lanes, ... with `>=`, the
    lanes' butterfly, positions stored at the plan's byte width (a
    position that does not fit fails), the end scoring as the block's
    reduction (per thread, per warp, over warps; a NaN at state 0 wins)
    and the traceback through in_ptr and the slot lists."""
    x = np.asarray(x, np.float32)
    B, T_, _ = x.shape
    S = g.num_states
    width = vk.bp_width(g.max_in_degree)
    nthr = vk.threads_for(S, lanes)
    arcs = g.in_arcs.long()
    a = {k: getattr(g, k).gather(1, arcs).numpy()
         for k in ("src", "pdf", "logp")}
    ptrs, inits, fins = (getattr(g, k).numpy() for k in
                         ("in_ptr", "initial", "final"))
    objf = np.empty(B, np.float32)
    pdfs = np.empty((B, T_), np.int32)
    states = np.empty((B, T_), np.int32)
    neg = np.float32(-np.inf)
    lo, hi = np.float32(-30.0), np.float32(30.0)
    for b in range(B):
        r = 0 if g.rows == 1 else b
        ptr = ptrs[r]
        src, pdf, logp = (a[k][r] for k in ("src", "pdf", "logp"))
        # unwritten positions hold the width's largest value, which
        # names no slot of a small graph
        bp = np.full((T_, S), 2 ** (8 * width) - 1, np.int64)
        cur = inits[r].copy()
        Tb = int(lengths[b])
        for t in range(Tb):
            row = x[b, t]
            nxt = np.empty(S, np.float32)
            for s in range(S):
                pairs = []
                for lane in range(lanes):
                    best, arg = neg, -1
                    for j in range(ptr[s] + lane, ptr[s + 1], lanes):
                        e = row[pdf[j]]
                        e = lo if e < lo else (hi if e > hi else e)
                        cand = (cur[src[j]] + logp[j]) + e
                        if cand >= best:
                            best, arg = cand, j
                    pairs.append((best, arg))
                best, arg = _butterfly(pairs, _beats_slot)
                nxt[s] = best
                pos = arg - ptr[s] if arg >= 0 else 0
                assert 0 <= pos < 2 ** (8 * width)
                bp[t, s] = pos
            cur = nxt
        end = cur + fins[r]
        part = []
        for tid in range(nthr):
            top, c = neg, 2 ** 31 - 1
            for s in range(tid, S, nthr):
                if _beats_state((end[s], s), (top, c)):
                    top, c = end[s], s
            part.append((top, c))
        warps = [_butterfly(part[w:w + 32], _beats_state)
                 for w in range(0, nthr, 32)]
        top, c = _butterfly(warps + [(neg, 2 ** 31 - 1)] * (32 - len(warps)),
                            _beats_state)
        if np.isnan(end[0]):
            top, c = end[0], 0
        objf[b] = top if Tb > 0 else neg
        ok = np.isfinite(objf[b])
        pdfs[b], states[b] = -1, -1
        for t in range(Tb - 1, -1, -1):
            if ok:
                j = ptr[c] + int(bp[t, c])
                pdfs[b, t], states[b, t], c = pdf[j], c, int(src[j])
    return vt.ViterbiResult(objf=objf, pdfs=pdfs, states=states,
                            ok=np.isfinite(objf))


@pytest.mark.parametrize("lanes", [1, 2, 4, 16, 32])
@pytest.mark.parametrize("case", ["mixed", "loud", "ties", "shared"])
def test_kernel_algorithm_emulation_matches_jax(case, lanes):
    fsts, shared, lengths, x = _case(case, seed=1)
    mine, theirs = _batches(fsts, shared, x.shape[0])
    got = _emulate(x, lengths, mine.semiring(), lanes)
    _assert_same(got, pt.viterbi_align(torch.from_numpy(x), lengths, mine))
    _assert_same(got, j_viterbi(jnp.array(x), lengths, theirs,
                                sweep="scatter"))


def _wide_fst(n_par=300, seed=0):
    """A graph with a state of n_par (> 256) in-arcs: state 0 -> 1 over
    n_par parallel arcs in a few weights and pdfs, so that many of them
    tie, then 1 -> 2 -> 1 and 2 -> 0 back; every state final."""
    rng = np.random.RandomState(seed)
    arcs = [(0, 1, int(p) + 1, int(p) + 1, float(w)) for p, w in
            zip(rng.randint(0, 3, size=n_par),
                rng.choice([0.0, 0.5], size=n_par))]
    arcs += [(1, 2, 4, 4, 0.0), (2, 1, 5, 5, 0.25), (2, 0, 6, 6, 0.0),
             (1, 1, 7, 7, 1.0)]
    return FST.from_arcs(3, 0, arcs, {s: 0.0 for s in range(3)})


@pytest.mark.parametrize("lanes", [1, 32])
def test_emulation_wide_in_degree_and_ties_across_lanes(lanes):
    """A state of 300 in-arcs (two-byte positions), many of them tied
    across lanes, under flat and random x: the emulation, the plain
    version and the JAX package agree."""
    fsts = [_wide_fst(seed=0), _wide_fst(seed=1), make_numerator_fst(
        [1, 3, 0], TOPO)]
    mine, theirs = _batches(fsts, False, 3)
    g = mine.semiring()
    assert g.max_in_degree > 256 and vk.bp_width(g.max_in_degree) == 2
    assert vk.plan_for(g, P, T).bp_width == 2
    rng = np.random.RandomState(5)
    x = np.where(rng.rand(3, T, P) < 0.5, 0.0,
                 rng.randn(3, T, P)).astype(np.float32)
    x[0] = 1.0           # every parallel arc of one weight ties
    lengths = np.array([T, 7, 6], np.int32)
    want = pt.viterbi_align(torch.from_numpy(x), lengths, mine)
    assert bool(want.ok.all())
    _assert_same(_emulate(x, lengths, g, lanes), want)
    _assert_same(want, j_viterbi(jnp.array(x), lengths, theirs,
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


def test_max_in_degree_is_counted_on_the_host():
    """The longest in-list, which plan() reads, is counted when the lists
    are built, and kept (a bound for a subset) by take() and to()."""
    fsts = [_wide_fst(n_par=40), *_case("mixed")[0]]
    mine, _ = _batches(fsts, False, len(fsts))
    g = mine.semiring()
    deg = (g.in_ptr[:, 1:] - g.in_ptr[:, :-1]).amax(dim=1)
    assert isinstance(g.max_in_degree, int)
    assert g.max_in_degree == int(deg.max()) == 42
    sub = g.take([2, 1])
    assert sub.max_in_degree == 42 >= int(deg[[2, 1]].max())
    assert sub.in_ptr.shape[0] == 2
    assert g.to("cpu").max_in_degree == 42


@pytest.mark.parametrize("case", ["mixed", "shared"])
def test_viterbi_from_numpy_of_jax_graph_arrays(case):
    fsts, shared, lengths, x = _case(case, seed=2)
    mine, theirs = _batches(fsts, shared, x.shape[0])
    conv = viterbi_from_numpy(j_graph_arrays(theirs), device="cpu")
    assert conv.rows == mine.semiring().rows
    xt = torch.from_numpy(x)
    a = pt.viterbi_align(xt, lengths, conv)
    b = pt.viterbi_align(xt, lengths, mine)
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    _assert_same(a, j_viterbi(jnp.array(x), lengths, theirs,
                              sweep="scatter"))


@pytest.mark.parametrize("case", ["mixed", "loud", "ties", "shared"])
def test_viterbi_of_graph_arrays(case):
    """viterbi_align given the gather engine's GraphArrays of a batch
    equals it given the batch (the same arc-id form) and the JAX
    package's given its GraphArrays; a prob-domain GraphArrays raises
    the JAX package's ValueError."""
    fsts, shared, lengths, x = _case(case, seed=4)
    mine, theirs = _batches(fsts, shared, x.shape[0])
    ga = pt_loss.graph_arrays(mine)
    xt = torch.from_numpy(x)
    a = pt.viterbi_align(xt, lengths, ga)
    b = pt.viterbi_align(xt, lengths, mine)
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert pt.viterbi_align(xt, lengths, ga).objf.equal(a.objf)   # kept
    _assert_same(a, j_viterbi(jnp.array(x), lengths, j_graph_arrays(theirs),
                              sweep="scatter"))
    den = pt.ChainGraphBatch(pt.ChainGraph(random_fst(num_states=5,
                                                      num_pdfs=P)),
                             x.shape[0], device="cpu")
    with pytest.raises(ValueError, match="prob-domain"):
        pt.viterbi_align(xt, lengths, pt_loss.graph_arrays(den))


def test_loss_on_a_shared_log_domain_batch_matches_jax():
    """The loss on the shared flat-start batch (its factorized-log form)
    and ChainLoss with that graph as the denominator both equal the JAX
    package's."""
    fsts, _, lengths, x = _case("shared")
    shared, jshared = _batches(fsts, True, x.shape[0])
    xt = torch.from_numpy(x)
    _, got = pt_loss.chain_function_with_aux(xt, lengths, shared)
    _, ref = j_aux(jnp.asarray(x), jnp.asarray(lengths), jshared)
    np.testing.assert_allclose(got.objf.numpy(), np.asarray(ref.objf),
                               rtol=1e-5)
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(ref.gamma),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    loss = pt.ChainLoss(pt.ChainGraph(fsts[0], log_domain=True),
                        device="cpu")
    jloss = JChainLoss(JChainGraph(fsts[0], log_domain=True))
    nums, jnums = _batches(fsts * x.shape[0], False, x.shape[0])
    np.testing.assert_allclose(
        float(loss(xt, lengths, nums)),
        float(jloss(jnp.asarray(x), jnp.asarray(lengths), jnums)),
        rtol=1e-5)


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
    """The least layout (delta double-buffered alone) bounds S_pad at
    29,056, as before."""
    g = _batches(*_case("mixed")[:2], 5)[0].semiring()
    assert vk.fits_on_chip(g)
    row = lambda s: torch.zeros(1, s)
    assert vk.fits_on_chip(dataclasses.replace(g, initial=row(29056)))
    assert not vk.fits_on_chip(dataclasses.replace(g, initial=row(29057)))


@pytest.mark.parametrize("shape,want,nbytes", [
    # realign (main path 3: flat-start, 2 in-arcs at most, 12-kB rows):
    # one lane a state
    ((151, 300, 3000, 2, 500),
     vk.Layout(192, 1, 4, True, True, 1),
     4 * (4 * 3000 + 8) + 8 * 151 + 4 * 152 + 8 * 300 + 151 * 500),
    # decode (48-phone bigram: 50 in-arcs, P = 96): 4 lanes
    ((49, 2400, 96, 50, 500),
     vk.Layout(256, 4, 4, True, True, 1),
     4 * (4 * 96 + 8) + 8 * 64 + 4 * 50 + 8 * 2400 + 49 * 500),
    # b11 (random_fst(512, 512, 4)): 2 lanes would take 1,024 compute
    # threads, so 1; 256 kB of positions go to device memory
    ((512, 1400, 512, 10, 500),
     vk.Layout(544, 1, 4, True, False, 1),
     4 * (4 * 512 + 8) + 8 * 512 + 4 * 513 + 8 * 1400),
    # wide in-degree: two-byte positions, 32 lanes
    ((3, 304, 8, 300, 9),
     vk.Layout(128, 32, 4, True, True, 2),
     4 * (4 * 8 + 8) + 8 * 64 + 4 * 4 + 8 * 304 + 9 * 3 * 2),
    # realign at T = 1,200: the ring keeps its 4 stages, and the 181 kB
    # of positions, which would fit beside 2, go to device memory
    ((151, 300, 3000, 2, 1200),
     vk.Layout(192, 1, 4, True, False, 1),
     4 * (4 * 3000 + 8) + 8 * 151 + 4 * 152 + 8 * 300),
    # P not a multiple of 4: no ring, positions still in shared memory
    ((49, 2400, 98, 50, 500),
     vk.Layout(224, 4, 0, True, True, 1),
     8 * 64 + 4 * 50 + 8 * 2400 + 49 * 500),
    # the limit: delta alone (8 S_pad bytes, all a block has)
    ((29056, 60000, 3000, 4, 500),
     vk.Layout(1024, 1, 0, False, False, 1), 232448),
])
def test_plan_by_arithmetic(shape, want, nbytes):
    s, k, P_, max_in, T_ = shape
    lay = vk.plan(s, k, P_, max_in, T_)
    assert lay == want
    assert vk.layout_smem(lay, s, k, T_, P_) == nbytes <= vk.MAX_SMEM
    # each part left out does not fit beside those before it
    size = lambda res, st, bps: vk.smem_bytes(s, k, T_, P_, st, res, bps,
                                              lay.bp_width)
    assert lay.resident or P_ > 1 << 16 or size(True, 0, False) > vk.MAX_SMEM
    for st in vk.STAGES:
        assert st <= lay.stages or P_ % 4 or \
            size(lay.resident, st, False) > vk.MAX_SMEM
    assert lay.bp_smem or size(lay.resident, lay.stages, True) > vk.MAX_SMEM


def test_plan_limit_and_rules():
    with pytest.raises(NotImplementedError, match="29,056"):
        vk.plan(29057, 100, 96, 4, 500)
    assert vk.plan(29056, 100, 96, 4, 500) == vk.Layout(
        1024, 1, 0, False, False, 1)
    # the least layout needs no more than the first design's 2 S_pad
    # floats
    # (each buffer at least 64 floats: the tail's scratch)
    for s in (64, 512, 29056):
        assert vk.smem_bytes(s, 100, 500, 96, 0, False, False, 1) == 8 * s
    assert vk.smem_bytes(5, 100, 500, 96, 0, False, False, 1) == 512
    # lanes: about 16 arcs a lane, S_pad * L compute threads of at most
    # 1024, less the producer warp with a ring
    assert [vk.lanes_for(49, d) for d in (1, 16, 17, 50, 200)] == \
        [1, 1, 2, 4, 16]
    assert vk.lanes_for(7, 600) == 32 and vk.lanes_for(2000, 50) == 1
    assert vk.lanes_for(512, 20) == 1 and vk.lanes_for(512, 20, False) == 2
    assert vk.threads_for(49, 4) == 256 and vk.threads_for(49, 4, False) == 224
    assert vk.threads_for(2000, 1) == 1024
    assert [vk.bp_width(d) for d in (1, 256, 257, 65536, 65537)] == \
        [1, 1, 2, 2, 4]
    # pdfs that do not pack into 16 bits are not resident
    lay = vk.plan(49, 2400, 70000, 50, 20)
    assert not lay.resident and lay.stages == 0
