"""The port's kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one (decided
inside the ``cuda`` fixture).  The module imports only torch, numpy,
pytest and the port: no JAX and no JAX package (tests/test_torch_isolation.py
checks it), so it runs on a machine with a card and no JAX, with
``tests/conftest.py`` (which imports JAX) left out:

    python -m pytest --noconftest -p no:cacheprovider -q -rs tests/test_torch_card.py

chip_smoke.py runs it so and fails if a test fails or skips.  The graphs
come from the port's own builders (utils/testgraphs.py, graphs/builder.py),
which match the JAX package's arc for arc; the CPU tests of each module
(tests/test_torch_<module>.py) hold the plain versions to the JAX package.

Tolerances: the loss kernels against their plain version objf relative
<= 1e-4 and gamma and traces max-abs <= 1e-4 (docs/PARITY.md:21; sums in
another order), gamma bit-identical on a rerun (no atomics); the Viterbi
kernel bit-identical (it adds the plain version's float32 values in the
same association).  The XL roofline probe's kernels are checked in
chip_smoke.py, not here.
"""

import numpy as np
import pytest
import torch

import pychain_tpu_torch as pt
from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                              alignment_to_pdf_sequence,
                                              estimate_phone_lm,
                                              make_numerator_fst)
from pychain_tpu_torch.graphs.fst import FST
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.ops import semiring as sr
from pychain_tpu_torch.ops import semiring_kernels as semk
from pychain_tpu_torch.ops import stream_kernels as stk
from pychain_tpu_torch.ops import viterbi_kernels as vk
from pychain_tpu_torch.ops.factorized import forward_backward_prob_fact
from pychain_tpu_torch.decode import PhoneDecoder
from pychain_tpu_torch.utils.testgraphs import (denominator_fst, linear_fst,
                                                random_fst)

LEAKY = 1e-5
MODES = [("source", "identity"), ("cross", "matrix"),
         ("separate", "stream")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_loss_close(got, ref):
    torch.testing.assert_close(got.objf, ref.objf, rtol=1e-4, atol=0)
    for name in ("gamma", "alpha_beta", "gamma_sum"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=1e-4)


# ----------------------------------------------------------------------
# The denominator kernels B1/B2 (ops/fact_kernels.py)
# ----------------------------------------------------------------------

def _den_case(mode, B=4, T=9, seed=0, num_phones=10):
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=mode)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, P).astype(np.float32)
    lengths = np.array([T, T - 2, 3, 1][:B], np.int32)
    return fst, x, lengths


class TestFactorized:

    @pytest.mark.cuda
    @pytest.mark.parametrize("mode,want", MODES)
    @pytest.mark.parametrize("debug", [True, False])
    def test_cuda_kernels_match_plain(self, cuda, mode, want, debug):
        fst, x, lengths = _den_case(mode, seed=5)
        fa = pt.ChainGraphBatch(pt.ChainGraph(fst), x.shape[0],
                                device=cuda)._fact
        assert fa.xsrc_mode == want
        px = torch.exp(torch.from_numpy(x)).to(cuda)
        lens = torch.from_numpy(lengths).to(cuda)
        fk.reset_launch_counts()
        got = fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                              debug=debug)
        assert fk.LAUNCHES == {"fact_fwd": 1, "fact_bwd": 1}
        ref = forward_backward_prob_fact(px, lens, fa, LEAKY)
        if not debug:
            ref = fk._frame0_traces(ref)
        _assert_loss_close(got, ref)

    @pytest.mark.cuda
    @pytest.mark.parametrize("stages", [0, 1, 2])
    @pytest.mark.parametrize("mode,want", MODES)
    def test_cuda_kernels_match_plain_at_every_ring_depth(self, cuda, mode,
                                                          want, stages):
        """fact_bwd with its ring forced to each depth (lengths T, T - 2,
        3 and 1: the ring's first and last frames), gamma bit-identical
        on a rerun."""
        fst, x, lengths = _den_case(mode, seed=6, num_phones=40)
        fa = pt.ChainGraphBatch(pt.ChainGraph(fst), x.shape[0],
                                device=cuda)._fact
        assert fa.xsrc_mode == want and fk.ring_stages(fa) == 2
        px = torch.exp(torch.from_numpy(x)).to(cuda)
        lens = torch.from_numpy(lengths).to(cuda)
        got = fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                              stages=stages)
        _assert_loss_close(got, forward_backward_prob_fact(px, lens, fa,
                                                           LEAKY))
        again = fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                                stages=stages)
        assert torch.equal(again.gamma, got.gamma)


# ----------------------------------------------------------------------
# The cluster kernels B3/B4 (ops/stream_kernels.py)
# ----------------------------------------------------------------------

def _stream_case(mode, B=5, T=9, seed=2, num_phones=150):
    """S = 300, S_pad = 384: 12 slices of 32 rows, so with C = 8 ranks
    0-3 own two slices and ranks 4-7 one.  B = 5 columns of unequal
    lengths: no G > 1 divides B, and a group mixes lengths."""
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=mode)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, P).astype(np.float32)
    lengths = np.array([T, T - 2, 3, 1, T - 4][:B], np.int32)
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), B, device="cpu")._fact
    return fa, torch.exp(torch.from_numpy(x)), torch.from_numpy(lengths)


class TestStream:

    @pytest.mark.cuda
    @pytest.mark.parametrize("G", [1, 2, 4])
    @pytest.mark.parametrize("C", [1, 2, 4, 8])
    @pytest.mark.parametrize("mode,want", MODES)
    @pytest.mark.parametrize("debug", [True, False])
    def test_cuda_stream_kernels_match_plain(self, cuda, mode, want, C, G,
                                             debug):
        fa, px, lens = _stream_case(mode)
        assert fa.xsrc_mode == want
        fa, px, lens = fa.to(cuda), px.to(cuda), lens.to(cuda)
        stk.reset_launch_counts()
        got = stk.forward_backward_prob_stream(px, lens, fa, LEAKY,
                                               debug=debug, cluster=C,
                                               columns=G)
        assert stk.LAUNCHES == {"stream_fwd": 1, "stream_bwd": 1}
        ref = forward_backward_prob_fact(px, lens, fa, LEAKY)
        if not debug:
            ref = fk._frame0_traces(ref)
        _assert_loss_close(got, ref)
        again = stk.forward_backward_prob_stream(px, lens, fa, LEAKY,
                                                 debug=debug, cluster=C,
                                                 columns=G)
        assert torch.equal(again.gamma, got.gamma)

    @pytest.mark.cuda
    @pytest.mark.parametrize("C", [1, 2, 8])
    @pytest.mark.parametrize("mode,want", MODES)
    def test_cuda_stream_gamma_is_the_same_at_every_g(self, cuda, mode,
                                                      want, C):
        """A column's arithmetic does not depend on the columns beside it:
        at one C, gamma and the traces are bit-identical for G = 1, 2, 4."""
        fa, px, lens = _stream_case(mode)
        fa, px, lens = fa.to(cuda), px.to(cuda), lens.to(cuda)
        res = [stk.forward_backward_prob_stream(px, lens, fa, LEAKY,
                                                cluster=C, columns=G)
               for G in (1, 2, 4)]
        for r in res[1:]:
            for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
                assert torch.equal(getattr(r, name), getattr(res[0], name))


# ----------------------------------------------------------------------
# ChainLoss on the card against ChainLoss on the CPU (loss.py)
# ----------------------------------------------------------------------

def _linear_setup(B=3, T=8, seed=0, mode="source", device="cpu"):
    den_fst, P = denominator_fst(num_phones=10, states_per_phone=2,
                                 seed=seed, forward_pdf_mode=mode)
    rng = np.random.RandomState(seed)
    lens = np.array([T, T - 3, T - 5][:B], np.int32)
    seqs = [rng.randint(0, P, size=int(n)) for n in lens]
    x = rng.randn(B, T, P).astype(np.float32)
    K = int(max(lens))
    nums = pt.ChainGraphBatch(
        [pt.ChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1, device=device)
    return den_fst, x, lens, nums


def _flat_start(B=3, T=9, seed=0, device="cpu"):
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
    nums = pt.ChainGraphBatch(
        [pt.ChainGraph(f, log_domain=True) for f in fsts],
        max_num_transitions=2 * 4, max_num_states=4 + 1, device=device)
    return den_fst, x, lens, nums


class TestLoss:

    @pytest.mark.cuda
    def test_cuda_chain_loss_matches_cpu(self, cuda):
        den_fst, x, lens, nums = _linear_setup(mode="cross")
        cpu = pt.ChainLoss(pt.ChainGraph(den_fst), device="cpu")
        xc = torch.from_numpy(x).requires_grad_(True)
        vc = cpu(xc, lens, nums)
        vc.backward()
        gpu = pt.ChainLoss(pt.ChainGraph(den_fst))
        _, _, _, num_gpu = _linear_setup(mode="cross", device=cuda)
        xg = torch.from_numpy(x).to(cuda).requires_grad_(True)
        fk.reset_launch_counts()
        vg = gpu(xg, lens, num_gpu)
        vg.backward()
        assert fk.LAUNCHES == {"fact_fwd": 1, "fact_bwd": 1}
        torch.testing.assert_close(vg.cpu(), vc.detach(), rtol=1e-5, atol=0)
        torch.testing.assert_close(xg.grad.cpu(), xc.grad, rtol=0, atol=1e-6)

    @pytest.mark.cuda
    def test_cuda_flat_start_chain_loss_matches_cpu(self, cuda):
        den_fst, x, lens, nums = _flat_start(seed=2)
        cpu = pt.ChainLoss(pt.ChainGraph(den_fst), device="cpu")
        xc = torch.from_numpy(x).requires_grad_(True)
        vc = cpu(xc, lens, nums)
        vc.backward()
        gpu = pt.ChainLoss(pt.ChainGraph(den_fst))
        _, _, _, num_gpu = _flat_start(seed=2, device=cuda)
        xg = torch.from_numpy(x).to(cuda).requires_grad_(True)
        fk.reset_launch_counts()
        semk.reset_launch_counts()
        vg = gpu(xg, lens, num_gpu)
        vg.backward()
        assert fk.LAUNCHES == {"fact_fwd": 1, "fact_bwd": 1}
        assert semk.LAUNCHES == {"semiring_fwd": 1, "semiring_bwd": 1}
        torch.testing.assert_close(vg.cpu(), vc.detach(), rtol=1e-5, atol=0)
        torch.testing.assert_close(xg.grad.cpu(), xc.grad, rtol=0, atol=1e-6)


# ----------------------------------------------------------------------
# The semiring kernels B5-B10 (ops/semiring_kernels.py)
# ----------------------------------------------------------------------

SR_P = 12
SR_LENGTHS = np.array([9, 7, 10, 4], np.int32)


def _selfloop_fst():
    arcs = [(0, 0, 1, 1, 0.7), (0, 1, 2, 2, 0.7),
            (1, 1, 3, 3, 0.4), (1, 0, 4, 4, 1.2)]
    return FST.from_arcs(2, 0, arcs, {1: 0.2, 0: 1.0})


def _sr_fsts(seed=0):
    """A cyclic random graph, a self-loop graph and two flat-start
    numerators, the second too long for its sequence (infeasible)."""
    rng = np.random.RandomState(seed)
    topo = ChainTopology(num_phones=SR_P // 2)
    return [random_fst(num_states=40, num_pdfs=SR_P, max_arcs_per_state=6,
                       seed=seed),
            _selfloop_fst(),
            make_numerator_fst(rng.randint(0, SR_P // 2, size=4), topo),
            make_numerator_fst(rng.randint(0, SR_P // 2, size=6), topo)]


def _list_batch(fsts, device=None):
    gs = [pt.ChainGraph(f, log_domain=True) for f in fsts]
    return pt.ChainGraphBatch(
        gs, max_num_transitions=max(g.num_transitions for g in gs),
        max_num_states=max(g.num_states for g in gs), device=device)


def _odd_case(device):
    """A list batch padded to K_pad 45 and S_pad 37 with P = 13 columns
    of x (none a multiple of 4): a cyclic graph, a self-loop graph and
    two flat-start numerators, the second (6 phones) too long for its 4
    frames; lengths 10, 1, 7, 4 of T = 10."""
    rng = np.random.RandomState(11)
    topo = ChainTopology(num_phones=6)
    fsts = [random_fst(num_states=12, num_pdfs=13, max_arcs_per_state=3,
                       seed=11), _selfloop_fst(),
            make_numerator_fst(rng.randint(0, 6, size=3), topo),
            make_numerator_fst(rng.randint(0, 6, size=6), topo)]
    batch = pt.ChainGraphBatch(
        [pt.ChainGraph(f, log_domain=True) for f in fsts],
        max_num_transitions=45, max_num_states=37, device=device)
    x = torch.from_numpy(rng.randn(4, 10, 13).astype(np.float32)).to(device)
    lens = torch.tensor([10, 1, 7, 4], device=device)
    return batch._semiring, x, lens


class TestSemiring:

    @pytest.mark.cuda
    def test_cuda_kernels_match_plain(self, cuda):
        batch = _list_batch(_sr_fsts(seed=7), device=cuda)
        x = torch.from_numpy(np.random.RandomState(8).randn(
            4, 10, SR_P).astype(np.float32)).to(cuda)
        lens = torch.from_numpy(SR_LENGTHS).to(cuda)
        semk.reset_launch_counts()
        got = semk.forward_backward_semiring_kernel(x, lens, batch._semiring)
        assert semk.LAUNCHES == {"semiring_fwd": 1, "semiring_bwd": 1}
        ref = sr.forward_backward_semiring(x, lens, batch._semiring)
        _assert_loss_close(got, ref)
        again = semk.forward_backward_semiring_kernel(x, lens,
                                                      batch._semiring)
        assert torch.equal(again.gamma, got.gamma)     # deterministic

    @pytest.mark.cuda
    def test_cuda_entry_points_default_to_the_card(self, cuda):
        batch = _list_batch(_sr_fsts())                # device=None
        assert batch._semiring.device.type == "cuda"

    @pytest.mark.cuda
    @pytest.mark.parametrize("rung", range(len(semk.BWD_LADDER)))
    def test_cuda_every_layout_matches_plain(self, cuda, rung):
        """Each layout plan() can pick, forced (semiring_bwd's rung of
        its ladder, semiring_fwd's the same or its last) on a batch whose
        K_pad, S_pad and P are no multiples of 4, at lengths 10, 1, 7
        and 4 of T = 10, the last infeasible: alpha stream and raw sums,
        objf, gamma and traces against the plain version, exact zeros
        past each length and on the infeasible sequence, gamma
        bit-identical on a rerun."""
        g, x, lens = _odd_case(cuda)
        B, T, P = x.shape
        S, K = g.num_states, g.k_pad
        assert (S % 4, K % 4, P % 4) != (0, 0, 0) and S % 2 and K % 2
        fres, fst = semk.FWD_LADDER[min(rung, len(semk.FWD_LADDER) - 1)]
        res, st, pipe, grows = semk.BWD_LADDER[rung]
        fl = semk.Layout(semk.threads_for(S), fst, fres)
        bl = semk.Layout(semk.threads_for(max(S, K)), st, res, pipe, grows)
        lens32 = lens.int()
        warc, c, n0, lz0 = sr.prepare(x, g, row_align=semk.WARC_ALIGN)
        n_ys, raw, n_last = semk.semiring_fwd(warc, n0, lens32, g,
                                              layout=fl)
        ref_n, ref_raw = sr.forward_plain(warc, n0, g)
        live = torch.arange(T, device=cuda)[None, :] < lens[:, None]
        torch.testing.assert_close(n_ys[live], ref_n[live], rtol=0,
                                   atol=1e-4)
        torch.testing.assert_close(raw[live], ref_raw[live], rtol=1e-4,
                                   atol=0)
        assert bool((raw[~live] == 1.0).all())
        objf, rf, mf, c_row, cms = sr.objective(raw, n_last, c, lz0,
                                                lens32, g)
        gamma, ab = semk.semiring_bwd(warc, n_ys, n0, lens32, rf, mf, c_row,
                                      cms, g, P, layout=bl)
        again, ab2 = semk.semiring_bwd(warc, n_ys, n0, lens32, rf, mf,
                                       c_row, cms, g, P, layout=bl)
        assert torch.equal(again, gamma) and torch.equal(ab2, ab)
        got = sr.package(objf, gamma, ab)
        ref = sr.forward_backward_semiring(x, lens, g)
        _assert_loss_close(got, ref)
        assert got.ok.tolist() == ref.ok.tolist() == [True, True, True,
                                                      False]
        assert bool((gamma[~live] == 0).all()) and bool((ab[~live] == 0)
                                                        .all())
        assert bool((gamma[3] == 0).all()) and bool((ab[3] == 0).all())

    @pytest.mark.cuda
    def test_cuda_shape_at_the_limit_runs(self, cuda):
        """2 S_pad + K_pad = 28,990 (S_pad 14,000, K_pad 990): the plan's
        smallest layouts run and match the plain version."""
        gs = [pt.ChainGraph(f, log_domain=True) for f in
              (random_fst(num_states=40, num_pdfs=SR_P,
                          max_arcs_per_state=6, seed=1), _selfloop_fst())]
        batch = pt.ChainGraphBatch(gs, max_num_transitions=990,
                                   max_num_states=14000, device=cuda)
        g = batch._semiring
        lay = semk.layouts(g, SR_P)
        assert lay["semiring_bwd"] == semk.Layout(1024, 0, False, False,
                                                  False)
        assert lay["semiring_fwd"] == semk.Layout(1024, 0, False)
        x = torch.from_numpy(np.random.RandomState(12).randn(
            2, 6, SR_P).astype(np.float32)).to(cuda)
        lens = torch.tensor([6, 3], dtype=torch.int32, device=cuda)
        semk.reset_launch_counts()
        got = semk.forward_backward_semiring_kernel(x, lens, g)
        assert semk.LAUNCHES == {"semiring_fwd": 1, "semiring_bwd": 1}
        ref = sr.forward_backward_semiring(x, lens, g)
        _assert_loss_close(got, ref)


# ----------------------------------------------------------------------
# The Viterbi kernel B11 (ops/viterbi_kernels.py)
# ----------------------------------------------------------------------

VIT_P = 8
VIT_TOPO = ChainTopology(num_phones=VIT_P // 2)
VIT_T = 9


def _vit_case(name, seed=0):
    """(fsts, shared, lengths, x) of one batch."""
    rng = np.random.RandomState(seed)
    P, TOPO, T = VIT_P, VIT_TOPO, VIT_T
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


class TestViterbi:

    @pytest.mark.cuda
    @pytest.mark.parametrize("case", ["mixed", "loud", "ties", "shared"])
    def test_cuda_kernel_matches_plain(self, case, cuda):
        fsts, shared, lengths, x = _vit_case(case, seed=5)
        if shared:
            batch = pt.ChainGraphBatch(
                pt.ChainGraph(fsts[0], log_domain=True), x.shape[0],
                device=cuda)
        else:
            batch = _list_batch(fsts, device=cuda)
        xt = torch.from_numpy(x).to(cuda)
        vk.reset_launch_counts()
        got = pt.viterbi_align(xt, lengths, batch)
        assert vk.LAUNCHES == {"viterbi": 1}
        ref = pt.viterbi_align(xt, lengths, batch, sweep="scatter")
        assert vk.LAUNCHES == {"viterbi": 1}
        for name in got._fields:     # bit-identical: no tolerance
            assert torch.equal(getattr(got, name), getattr(ref, name)), name


# ----------------------------------------------------------------------
# Phone decoding (decode.py) on the card against the CPU
# ----------------------------------------------------------------------

DEC_PHONES = 4
DEC_PLANS = [([2, 0, 3, 1, 2], [3, 2, 4, 2, 3]), ([0, 1], [4, 3]),
             ([3, 3, 1], [2, 5, 1])]


def _decoder():
    rng = np.random.RandomState(0)
    ts = [[int(p) for p in rng.randint(0, DEC_PHONES,
                                       size=rng.randint(4, 9))]
          for _ in range(30)]
    return PhoneDecoder(estimate_phone_lm(ts, num_phones=DEC_PHONES,
                                          order=2),
                        ChainTopology(num_phones=DEC_PHONES))


class TestDecode:

    @pytest.mark.cuda
    def test_cuda_decoder_matches_cpu(self, cuda):
        dec = _decoder()
        lengths = np.array(
            [len(alignment_to_pdf_sequence(ph, du, dec.topo))
             for ph, du in DEC_PLANS], np.int32)
        x = np.random.RandomState(2).randn(
            len(DEC_PLANS), 14, dec.topo.num_pdfs).astype(np.float32)
        vk.reset_launch_counts()
        got = dec(torch.from_numpy(x).to(cuda), lengths)
        assert vk.LAUNCHES == {"viterbi": 1}
        ref = dec(torch.from_numpy(x), lengths)
        assert got.phones == ref.phones and got.durations == ref.durations
        np.testing.assert_array_equal(got.scores, ref.scores)
