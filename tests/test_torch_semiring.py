"""The port's semiring engine against the JAX package's three.

One batch mixes the graph classes the semiring engines exist for: a
cyclic random graph (over 128 arcs, so the JAX streamed kernels see
several arc chunks), a two-state self-loop graph, a flat-start numerator
(graphs/builder.make_numerator_fst) and a flat-start numerator too long
for its sequence (no accepting path: objf -inf, gamma 0, ok False), at
unequal lengths.  The port's plain PyTorch engine (ops/semiring.py) is
held against the JAX XLA scan (impl="semiring"), the B5/B6 Pallas kernels
in interpret mode (impl="semiring_pallas") and the B7/B8 and B9/B10 XL
kernels in interpret mode, resident and forced-streamed.  Tolerances are
float32's: objf relative <= 1e-5, gamma and traces max-abs <= 1e-5.

The CUDA kernels cannot run here; a step-for-step emulation of both on
the arrays they read (arc ids, CSR lists, pdf lists), with the stream
rows they never write set to NaN, must match the plain version.
tests/test_torch_card.py compares the kernels themselves with the plain
version on the card.
"""

import dataclasses
import importlib.util
import pathlib
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.loss import chain_function_with_aux as j_aux
from pychain_tpu.loss import dispatch_arrays as j_dispatch
from pychain_tpu.ops import semiring_xl as j_xl
from pychain_tpu.ops.pallas_semiring import supports as j_pallas_supports
from pychain_tpu.ops.semiring import fits_budget as j_fits_budget

import pychain_tpu_torch as pt
from pychain_tpu_torch import loss as pt_loss
from pychain_tpu_torch.convert import semiring_from_numpy
from pychain_tpu_torch.graphs.builder import ChainTopology, \
    make_numerator_fst
from pychain_tpu_torch.graphs.fst import FST
from pychain_tpu_torch.ops import semiring as sr
from pychain_tpu_torch.ops import semiring_kernels as sk
from pychain_tpu_torch.utils.testgraphs import random_fst

P = 12
LENGTHS = np.array([9, 7, 10, 4], np.int32)


def _selfloop_fst():
    arcs = [(0, 0, 1, 1, 0.7), (0, 1, 2, 2, 0.7),
            (1, 1, 3, 3, 0.4), (1, 0, 4, 4, 1.2)]
    return FST.from_arcs(2, 0, arcs, {1: 0.2, 0: 1.0})


def _fsts(seed=0):
    rng = np.random.RandomState(seed)
    topo = ChainTopology(num_phones=P // 2)
    return [random_fst(num_states=40, num_pdfs=P, max_arcs_per_state=6,
                       seed=seed),
            _selfloop_fst(),
            make_numerator_fst(rng.randint(0, P // 2, size=4), topo),
            make_numerator_fst(rng.randint(0, P // 2, size=6), topo)]


def _batches(fsts):
    gs = [pt.ChainGraph(f, log_domain=True) for f in fsts]
    K = max(g.num_transitions for g in gs)
    S = max(g.num_states for g in gs)
    mine = pt.ChainGraphBatch(gs, max_num_transitions=K, max_num_states=S,
                              device="cpu")
    theirs = JChainGraphBatch([JChainGraph(f, log_domain=True)
                               for f in fsts],
                              max_num_transitions=K, max_num_states=S)
    return mine, theirs


def _x(seed=0, B=4, T=10):
    return np.random.RandomState(seed + 1).randn(B, T, P).astype(np.float32)


def _assert_close(got, ref, atol=1e-5):
    ref_objf = np.asarray(ref.objf)
    np.testing.assert_allclose(got.objf.numpy(), ref_objf, rtol=1e-5, atol=0)
    for name in ("gamma", "alpha_beta", "gamma_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=atol, err_msg=name)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))


def _plain(batch, x):
    return sr.forward_backward_semiring(torch.from_numpy(x),
                                        torch.from_numpy(LENGTHS),
                                        batch._semiring)


@pytest.mark.parametrize("impl", ["semiring", "semiring_pallas",
                                  "semiring_xl", "semiring_xl_streamed"])
def test_plain_matches_jax_engines(impl, monkeypatch):
    fsts = _fsts()
    mine, theirs = _batches(fsts)
    assert mine._semiring.k_pad > 128
    if impl == "semiring_xl_streamed":
        monkeypatch.setattr(j_xl, "XL_VMEM_BUDGET", 1)
        monkeypatch.setattr(j_xl, "XL_STREAM_MASK_BUDGET", 1)
        impl = "semiring_xl"
    x = _x()
    # the port first, while no JAX work is in flight, and JAX on its own
    # copy of x
    got = _plain(mine, x)
    _, ref = j_aux(jnp.array(x), LENGTHS, theirs, impl=impl)
    _assert_close(got, ref)
    # the flat-start graph of 6 phones has no path of 4 frames
    assert got.ok.tolist() == [True, True, True, False]
    assert got.objf[3] == -np.inf
    assert float(got.gamma[3].abs().sum()) == 0.0


# ----------------------------------------------------------------------
# Emulation of the CUDA kernels on the arrays they read
# ----------------------------------------------------------------------

def _warp_all(x, op=np.add):
    """fact_common.cuh's warp_sum_all / warp_max_all on 32 lanes: a
    butterfly, every lane ending with the same bits."""
    x = np.array(x, np.float64)
    for off in (16, 8, 4, 2, 1):
        x = op(x, x[np.arange(32) ^ off])
    return x[0]


def _block_all(parts, op=np.add):
    """A frame's reduction: each warp's lanes, then the warps' slots in
    warp order, both by the butterfly."""
    nthr = len(parts)
    slots = [_warp_all(parts[w:w + 32], op) for w in range(0, nthr, 32)]
    return _warp_all(slots + [0.0] * (32 - len(slots)), op)


@np.errstate(divide="ignore")          # log 0 = -inf, as log gives
def _emulate(x, lengths, g):
    """csrc/semiring_fwd.cu and csrc/semiring_bwd.cu, one sequence, frame,
    thread and list at a time, at the plan's thread counts: float32
    weights in, float64 carries; the unnormalised alpha and b in parity
    buffers, normalised by the reader (a_prev[src] * inv_prev,
    b_prev[dst] * inv_prev); one reduction a frame over the threads'
    partials; the occupancies a thread an out-list slot; b[s] over s's
    out-list in ascending order; gamma a frame late over the compact pdf
    list into a row zeroed once."""
    warc, c, n0, lz0 = sr.prepare(x, g)
    B, T, P_ = x.shape
    S, K = g.num_states, g.k_pad
    f64 = np.float64
    w, n0n = warc.numpy().astype(f64), n0.numpy()
    kl = sk.kernel_lists(g)
    lay = sk.plan(S, K, P_, kl.E)
    ids = {k: getattr(g, k).numpy() for k in
           ("in_ptr", "out_ptr", "out_arcs", "pdf_arcs")}
    ids.update({k: getattr(kl, k).numpy() for k in
                ("in_pack", "out_sd", "emit_pdf", "emit_ptr", "n_emit")})
    n_ys = np.full((B, T, S), np.nan)           # rows never written: NaN
    raw = np.ones((B, T))
    n_last = np.full((B, S), np.nan)
    nthr = lay["semiring_fwd"].threads
    for b in range(B):
        ptr, pack = ids["in_ptr"][b], ids["in_pack"][b]
        a_prev, inv = n0n[b].copy(), f64(1.0)
        for t in range(int(lengths[b])):
            a = np.zeros(S)
            parts = np.zeros(nthr)
            for d in range(S):
                acc = f64(0)
                for pk in pack[ptr[d]:ptr[d + 1]]:
                    acc += (a_prev[pk >> 16] * inv) * w[b, t, pk & 0xffff]
                a[d] = acc
                parts[d % nthr] += acc
            if t > 0:
                n_ys[b, t - 1] = a_prev * inv
            r = _block_all(parts)
            raw[b, t] = r
            a_prev, inv = a, 1.0 / max(r, sr.TINY)
        n_ys[b, int(lengths[b]) - 1] = n_last[b] = a_prev * inv
    objf, rf, mf, c_row, cms = sr.objective(
        torch.from_numpy(raw), torch.from_numpy(n_last), c, lz0, lengths, g)
    rf, mf, c_row, cms = (v.numpy() for v in (rf, mf, c_row, cms))
    gamma = np.zeros((B, T, P_))
    ab = np.zeros((B, T))
    nthr = lay["semiring_bwd"].threads
    for b in range(B):
        optr, oarcs, osd = (ids["out_ptr"][b], ids["out_arcs"][b],
                            ids["out_sd"][b])
        eptr, epdf = ids["emit_ptr"][b], ids["emit_pdf"][b]
        parcs = ids["pdf_arcs"][b]
        b_prev, inv, m = rf[b].copy(), f64(1.0), mf[b]
        row = np.zeros(P_)                       # zeroed once
        for u in range(int(lengths[b]) - 1, -1, -1):
            a_u = n0n[b] if u == 0 else n_ys[b, u - 1]
            la = np.log(a_u)                     # once a state
            scale = m + c_row[b, u]
            bl = np.zeros(S)
            mx = np.zeros(nthr)
            for s in range(S):
                acc = f64(0)
                for q in range(optr[s], optr[s + 1]):
                    acc += w[b, u, oarcs[q]] * (b_prev[osd[q] & 0xffff] * inv)
                bl[s] = acc
                mx[s % nthr] = max(mx[s % nthr], acc)
            occ = np.full(K, np.nan)
            trace = np.zeros(nthr)
            for q in range(optr[S]):             # a thread a slot
                k, sd = oarcs[q], osd[q]
                v = w[b, u, k] * (b_prev[sd & 0xffff] * inv)
                occ[k] = np.exp(min(la[sd >> 16] + np.log(v) + scale,
                                    sr.EXP_CLAMP))
                trace[q % nthr] += occ[k]
            ab[b, u] = _block_all(trace)
            mxb = _block_all(mx, np.maximum)
            b_prev, inv = bl, 1.0 / max(mxb, sr.TINY)
            m = m + cms[b, u] + np.log(max(mxb, sr.TINY))
            for e in range(ids["n_emit"][b]):    # the compact pdf list
                row[epdf[e]] = sum((occ[k] for k in
                                    parcs[eptr[e]:eptr[e + 1]]), f64(0))
            gamma[b, u] = row.astype(np.float32)
    return sr.package(objf, torch.from_numpy(gamma), torch.from_numpy(ab))


def test_long_flat_start_keeps_every_frame_of_gamma():
    """At T=500 with 100-150 phones, alpha and beta on the posterior's
    states sit far below their own scales; in float32 their linear
    product (the TPU kernels' occupancy) underflows and loses whole
    frames.  Carried in float64 and assembled in log space, every frame's
    gamma still sums to 1."""
    rng = np.random.RandomState(0)
    topo = ChainTopology(num_phones=1500)
    fsts = [make_numerator_fst(rng.randint(0, 1500, size=n), topo)
            for n in rng.randint(100, 151, size=4)]
    gs = [pt.ChainGraph(f, log_domain=True) for f in fsts]
    g = pt.ChainGraphBatch(gs, max_num_transitions=300, max_num_states=151,
                           device="cpu").semiring()
    x = torch.from_numpy(np.random.RandomState(4).randn(4, 500, 3000)
                         .astype(np.float32))
    lens = torch.full((4,), 500)
    res = sr.forward_backward_semiring(x, lens, g)
    assert res.ok.all()
    assert float((res.gamma_sum - 1).abs().max()) < 1e-5
    assert float((res.alpha_beta - 1).abs().max()) < 1e-5
    # against the same recurrence with float64 weights too
    g64 = dataclasses.replace(g, **{f: getattr(g, f).double()
                                    for f in ("logp", "initial", "final")})
    warc, c, n0, lz0 = sr.prepare(x.double(), g64)
    n_ys, raw = sr.forward_plain(warc, n0, g64)
    n_last = n_ys[:, -1]
    objf, rf, mf, c_row, cms = sr.objective(raw, n_last, c, lz0, lens, g64)
    gamma, _ = sr.backward_plain(warc, n_ys, n0, lens, rf, mf, c_row, cms,
                                 g64, 3000)
    np.testing.assert_allclose(res.objf.numpy(), objf.numpy(), rtol=1e-6)
    np.testing.assert_allclose(res.gamma.numpy(), gamma.numpy(), rtol=0,
                               atol=1e-5)


def test_kernel_algorithm_emulation_matches_plain():
    mine, _ = _batches(_fsts(seed=2))
    x = torch.from_numpy(_x(seed=2))
    lens = torch.from_numpy(LENGTHS)
    ref = sr.forward_backward_semiring(x, lens, mine._semiring)
    got = _emulate(x, lens, mine._semiring)
    assert not torch.isnan(got.gamma).any()
    torch.testing.assert_close(got.objf, ref.objf, rtol=1e-5, atol=0)
    for name in ("gamma", "alpha_beta", "gamma_sum"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=1e-6)
    assert got.ok.tolist() == ref.ok.tolist() == [True, True, True, False]
    # the same float64 arithmetic in the same order: the float32 results
    # agree to a rounding of the last bit
    torch.testing.assert_close(got.gamma, ref.gamma, rtol=1e-6, atol=1e-9)


def test_kernel_wrapper_cpu_takes_plain_path():
    mine, _ = _batches(_fsts())
    x = torch.from_numpy(_x())
    lens = torch.from_numpy(LENGTHS)
    sk.reset_launch_counts()
    got = sk.forward_backward_semiring_kernel(x, lens, mine._semiring)
    assert sk.LAUNCHES == {"semiring_fwd": 0, "semiring_bwd": 0}
    ref = sr.forward_backward_semiring(x, lens, mine._semiring)
    for name in ref._fields:
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=0)
    report = pt.check_result(got, lens)
    assert report.bad_sequences.tolist() == [3]      # the infeasible one


def test_lists_group_every_arc_once_in_ascending_order():
    g = _batches(_fsts())[0]._semiring
    src, dst, pdf = (t.numpy() for t in (g.src, g.dst, g.pdf))
    for b in range(src.shape[0]):
        real = np.nonzero(src[b] < g.num_states)[0]
        for key, ptr, arcs, n in ((dst, g.in_ptr, g.in_arcs, g.num_states),
                                  (src, g.out_ptr, g.out_arcs, g.num_states),
                                  (pdf, g.pdf_ptr, g.pdf_arcs, g.n_pdfs)):
            ptr, arcs = ptr[b].numpy(), arcs[b].numpy()
            assert ptr[0] == 0 and ptr[-1] == len(real)
            assert sorted(arcs[:ptr[-1]]) == list(real)
            for i in range(n):
                grp = arcs[ptr[i]:ptr[i + 1]]
                assert (key[b][grp] == i).all() and (np.diff(grp) > 0).all()


def test_semiring_from_numpy_round_trips():
    fsts = _fsts()
    mine, theirs = _batches(fsts)
    g = mine._semiring
    back = semiring_from_numpy(g)
    for f in ("src", "dst", "pdf", "logp", "initial", "final", "in_ptr",
              "in_arcs", "out_ptr", "out_arcs", "pdf_ptr", "pdf_arcs"):
        assert torch.equal(getattr(back, f), getattr(g, f)), f
    # the JAX package's XL arrays pad K to 128 and S to 8 with inert arcs
    xa = j_dispatch(theirs, "semiring_xl")
    conv = semiring_from_numpy(xa)
    assert conv.k_pad % 128 == 0 and conv.num_states % 8 == 0
    k, s = g.k_pad, g.num_states
    for f in ("pdf", "logp"):
        assert torch.equal(getattr(conv, f)[:, :k], getattr(g, f)), f
    assert torch.equal(conv.initial[:, :s], g.initial)
    x = torch.from_numpy(_x())
    lens = torch.from_numpy(LENGTHS)
    a = sr.forward_backward_semiring(x, lens, conv)
    b = sr.forward_backward_semiring(x, lens, g)
    torch.testing.assert_close(a.objf, b.objf, rtol=1e-6, atol=0)
    torch.testing.assert_close(a.gamma, b.gamma, rtol=0, atol=1e-6)


def test_batch_reorder_permutes_engine():
    """reorder() moves the arc-id arrays and their per-graph lists with
    the graphs: after it, the batch computes what a batch built in the
    new order computes (mirrors test_xl_batch_reorder_permutes_engine)."""
    fsts = _fsts(seed=4)
    mine, theirs = _batches(fsts)
    order = [2, 0, 3, 1]
    x = _x(seed=4)
    lens = np.full(4, 10, np.int32)
    mine.reorder(order)
    theirs.reorder(order)
    fresh, _ = _batches([fsts[i] for i in order])
    _, got = pt_loss.chain_function_with_aux(torch.from_numpy(x), lens,
                                             mine)
    _, want = pt_loss.chain_function_with_aux(torch.from_numpy(x), lens,
                                              fresh)
    for name in got._fields:
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=0)
    _, ref = j_aux(jnp.array(x), lens, theirs, impl="semiring")
    _assert_close(got, ref)
    with pytest.raises(ValueError, match="permutation"):
        mine.reorder([0, 0, 1, 2])


def test_dispatch_and_forced_semiring_on_linear_batch():
    fsts = _fsts()
    mine, _ = _batches(fsts)
    assert isinstance(pt_loss.dispatch_arrays(mine, "auto"),
                      sr.SemiringArrays)
    for impl in ("semiring", "semiring_pallas", "semiring_xl"):
        assert pt_loss.dispatch_arrays(mine, impl) is mine._semiring
    with pytest.raises(ValueError, match="linear"):
        pt_loss.dispatch_arrays(mine, "linear")
    with pytest.raises(ValueError, match="factorized"):
        pt_loss.dispatch_arrays(mine, "factorized")
    # a linear batch takes the closed form under "auto", and a forced
    # impl="semiring" compiles its arc-id arrays on first use
    rng = np.random.RandomState(5)
    lin = pt.ChainGraphBatch(
        [pt.ChainGraph(FST.linear(rng.randint(0, P, size=6)),
                       log_domain=True) for _ in range(3)],
        max_num_transitions=6, max_num_states=7, device="cpu")
    assert lin._semiring is None
    # the JAX package's kernel names are taken as "auto"
    assert pt_loss.dispatch_arrays(lin, "semiring_xl") is lin._linear
    x = torch.from_numpy(_x(B=3, T=8))
    lens = np.array([6, 6, 5], np.int32)
    _, closed = pt_loss.chain_function_with_aux(x, lens, lin)
    _, plain = pt_loss.chain_function_with_aux(x, lens, lin,
                                               impl="semiring")
    assert lin._semiring is not None
    torch.testing.assert_close(plain.objf, closed.objf, rtol=1e-5, atol=0)
    torch.testing.assert_close(plain.gamma, closed.gamma, rtol=0, atol=1e-5)
    assert plain.ok.tolist() == closed.ok.tolist() == [True, True, False]


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_size_classes_and_shared_memory_limits():
    # the three classes chip_smoke.py runs (the flat-start batch, bench.py
    # --xl and tools/xl_stream_indomain.py), named as the JAX package
    # chooses its kernel pair for them
    size_class = _chip_smoke().size_class
    for b, k, s, want in ((128, 300, 151, "semiring"),
                          (128, 3103, 1000, "xl"),
                          (32, 7091, 3500, "xlstream")):
        assert size_class(b, k, s) == want
        dense = j_fits_budget(b, k, s) and j_pallas_supports(
            SimpleNamespace(src_oh=SimpleNamespace(shape=(b, k, s))))
        assert (want == "semiring") == dense
        assert (want == "xlstream") == (not j_xl.fits_xl_budget(k, s))
    # the smallest layout: b's two double vectors, one double occupancy
    # a padded arc and 64 warp slots
    assert sk.bwd_smem_bytes(151, 300, 3000, 300, 0, False, False,
                             False) == (2 * 151 + 300 + 64) * 8
    g = _batches(_fsts())[0]._semiring
    assert sk.fits_on_chip(g)
    # one block's shared memory takes 2 S_pad + K_pad <= 28,992 doubles
    ids = lambda k: torch.zeros(1, k, dtype=torch.int32)
    s = g.num_states
    assert sk.fits_on_chip(sr.SemiringArrays(
        **{**vars(g), "src": ids(28992 - 2 * s)}))
    assert not sk.fits_on_chip(sr.SemiringArrays(
        **{**vars(g), "src": ids(28993 - 2 * s)}))


def test_list_build_is_vectorised_and_matches_per_graph_lists():
    """The lists built for a batch equal those built graph by graph."""
    fsts = _fsts(seed=6)
    g = _batches(fsts)[0]._semiring
    for b in range(4):
        one = sr.semiring_from_ids(*(getattr(g, f)[b:b + 1].numpy() for f in
                                     ("src", "dst", "pdf", "logp",
                                      "initial", "final")))
        for f in ("in_ptr", "in_arcs", "out_ptr", "out_arcs"):
            assert torch.equal(getattr(one, f)[0], getattr(g, f)[b]), f
        n = one.n_pdfs
        assert torch.equal(one.pdf_ptr[0], g.pdf_ptr[b, :n + 1])


def _constrained_fsts(seed=0):
    """Tolerance-3 constrained numerators (main path 3's kind) over
    seeded phone sequences and durations."""
    from pychain_tpu_torch.graphs.builder import make_constrained_numerator
    rng = np.random.RandomState(seed)
    topo = ChainTopology(num_phones=P // 2)
    out = []
    for n in (3, 5, 4):
        phones = rng.randint(0, P // 2, size=n)
        durs = list(rng.randint(2, 6, size=n))
        out.append(make_constrained_numerator(phones, durs, topo,
                                              tolerance=3))
    return out


@pytest.mark.parametrize("kind", ["flat_start", "cyclic", "self_loop",
                                  "constrained"])
def test_kernel_lists_hold_every_arc_once_in_ascending_order(kind):
    """The compact pdf list semiring_bwd walks: only the pdfs a graph
    emits, ascending, and together their lists hold each real arc exactly
    once, ascending within a pdf; the packed in- and out-list slots
    decode to the lists' own source, destination and arc ids."""
    rng = np.random.RandomState(3)
    topo = ChainTopology(num_phones=P // 2)
    fsts = {"flat_start": [make_numerator_fst(rng.randint(0, P // 2,
                                                          size=n), topo)
                           for n in (2, 5, 3)],
            "cyclic": [random_fst(num_states=30, num_pdfs=P,
                                  max_arcs_per_state=5, seed=s)
                       for s in range(3)],
            "self_loop": [_selfloop_fst()] * 2,
            "constrained": _constrained_fsts()}[kind]
    g = _batches(fsts)[0]._semiring
    kl = sk.kernel_lists(g)
    assert sk.kernel_lists(g) is kl                 # built once a batch
    src, dst, pdf = (t.numpy() for t in (g.src, g.dst, g.pdf))
    for b in range(g.rows):
        real = np.nonzero(src[b] < g.num_states)[0]
        n = int(kl.n_emit[b])
        pdfs = kl.emit_pdf[b, :n].numpy()
        assert sorted(set(pdf[b][real])) == list(pdfs)
        ptr = kl.emit_ptr[b].numpy()
        assert ptr[0] == 0 and (ptr[n:] == len(real)).all()
        arcs = g.pdf_arcs[b].numpy()
        seen = []
        for e, p in enumerate(pdfs):
            grp = arcs[ptr[e]:ptr[e + 1]]
            assert len(grp) > 0 and (pdf[b][grp] == p).all()
            assert (np.diff(grp) > 0).all()
            seen.extend(grp)
        assert sorted(seen) == list(real) and len(seen) == len(set(seen))
        n_in = int(g.in_ptr[b, -1])
        pack = kl.in_pack[b, :n_in].numpy()
        in_arcs = g.in_arcs[b, :n_in].numpy()
        assert (pack & 0xffff == in_arcs).all()
        assert (pack >> 16 == src[b][in_arcs]).all()
        out_arcs = g.out_arcs[b, :n_in].numpy()
        sd = kl.out_sd[b, :n_in].numpy()
        assert (sd >> 16 == src[b][out_arcs]).all()
        assert (sd & 0xffff == dst[b][out_arcs]).all()


def test_layout_rule_by_arithmetic():
    """plan() on the shapes of main paths 2 and 3, the xl and xlstream
    classes and the limit: each kernel's layout is the first of its
    ladder that fits a block's 232,448 bytes, its shared memory is the
    kernels' own formula, and its block the multiple of 32 threads that
    covers the graph, at most 1024."""
    ladder = {"semiring_fwd": [sk.Layout(0, st, res)
                               for res, st in sk.FWD_LADDER],
              "semiring_bwd": [sk.Layout(0, st, res, pipe, grows)
                               for res, st, pipe, grows in sk.BWD_LADDER]}

    def fwd_formula(S, K, lay):
        kw = -(-K // 4) * 4
        return (lay.stages * (4 * kw + 8) + 2 * 8 * S + 2 * 32 * 8
                + (4 * (S + 1 + K) if lay.resident else 0))

    def bwd_formula(S, K, P_, E, lay):
        kw, sw, pw = -(-K // 4) * 4, -(-S // 2) * 2, -(-P_ // 4) * 4
        nb = 2 if lay.pipe else 1
        return (lay.stages * (4 * kw + 8 * sw + 8)
                + (2 * 4 * pw if lay.grows else 0)
                + 8 * S * (4 if lay.pipe else 2) + nb * (8 * K + 64 * 8)
                + (4 * (S + 1 + 3 * K + 2 * E + 1) if lay.resident else 0))

    # (S_pad, K_pad, P, E): the picks' ladder indices and threads
    cases = {"path 2": ((151, 300, 3000, 300), (0, 0), (160, 320)),
             "path 3": ((1391, 2280, 3000, 600), (0, 0), (1024, 1024)),
             "xl": ((1000, 3103, 3000, 3000), (0, 1), (1024, 1024)),
             "xlstream": ((3500, 7091, 512, 512), (0, 3), (1024, 1024)),
             "limit": ((10000, 8990, 3000, 3000), (3, 5), (1024, 1024)),
             "odd": ((37, 45, 13, 7), (0, 0), (64, 64))}
    for name, ((S, K, P_, E), picks, threads) in cases.items():
        plan = sk.plan(S, K, P_, E)
        for kernel, pick, nthr in zip(("semiring_fwd", "semiring_bwd"),
                                      picks, threads):
            lay = plan[kernel]
            assert lay.threads == nthr, (name, kernel)
            want = ladder[kernel][pick]
            assert (lay.stages, lay.resident) == (want.stages,
                                                  want.resident), name
            if kernel == "semiring_bwd":
                assert (lay.pipe, lay.grows) == (want.pipe, want.grows)
                sizes = [bwd_formula(S, K, P_, E, c) for c in
                         ladder[kernel]]
                assert sk.bwd_smem_bytes(
                    S, K, P_, E, lay.stages, lay.resident, lay.pipe,
                    lay.grows) == sizes[pick]
            else:
                sizes = [fwd_formula(S, K, c) for c in ladder[kernel]]
                assert sk.fwd_smem_bytes(S, K, lay.stages,
                                         lay.resident) == sizes[pick]
            assert sizes[pick] <= 232448
            assert all(v > 232448 for v in sizes[:pick]), (name, kernel)
    # 2 S_pad + K_pad = 28,990 runs (in the smallest layouts), one past
    # 28,992 does not
    assert sk.plan(14000, 990, 3000, 990)["semiring_bwd"] == sk.Layout(
        1024, 0, False, False, False)
    with pytest.raises(NotImplementedError, match="28,992"):
        sk.plan(14000, 993, 3000, 993)
    assert sk.threads_for(1) == 32 and sk.threads_for(33) == 64
    assert sk.threads_for(5000) == 1024
