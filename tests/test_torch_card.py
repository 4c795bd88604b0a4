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
another order), gamma bit-identical on a rerun (no atomics); in the fast
mode (bfloat16 tiles) bit-identical to the plain fast version, which
takes every sum in the kernels' order (``cluster=C`` for the cluster
pair; in another order the bfloat16 roundings drift apart by far more
than float32 rounding); the Viterbi
kernel bit-identical (it adds the plain version's float32 values in the
same association).  The acoustic models (cuDNN and cuBLAS, no kernel of
the port's) against the CPU with TF32 off: outputs and BatchNorm
statistics within 1e-5, parameter gradients within 1e-4 of their norm.
The XL roofline probe's kernels against their plain versions: the f32
forms within 1e-5 relative, the bf16 form within 5e-3 (the tool's floor
of 1e-9), each bit-identical on a rerun.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import pychain_tpu_torch as pt
from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                              alignment_to_pdf_sequence,
                                              estimate_phone_lm,
                                              make_numerator_fst)
from pychain_tpu_torch.convert import model_from_flax, model_to_flax
from pychain_tpu_torch.graphs.fst import FST
from pychain_tpu_torch import models as pm
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.ops import semiring as sr
from pychain_tpu_torch.ops import semiring_kernels as semk
from pychain_tpu_torch.ops import stream_kernels as stk
from pychain_tpu_torch.ops import viterbi_kernels as vk
from pychain_tpu_torch.ops.factorized import (forward_backward_prob_fact,
                                              forward_backward_prob_fast,
                                              forward_backward_prob_mode)
from pychain_tpu_torch.ops.viterbi import viterbi_plain
from pychain_tpu_torch.tools import xl_roofline as xr
from pychain_tpu_torch.decode import PhoneDecoder
from pychain_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
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
        assert fk.launched() == {"fact_fwd": 1, "fact_bwd": 1}
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


class TestFast:
    """B1/B2 in the fast mode (bfloat16 tiles) against the plain fast
    version (ops/factorized.forward_backward_prob_fast)."""

    @staticmethod
    def _fast_case(cuda, mode, seed, num_phones):
        fst, x, lengths = _den_case(mode, seed=seed, num_phones=num_phones)
        fa = pt.ChainGraphBatch(pt.ChainGraph(fst), x.shape[0],
                                tile_dtype="bfloat16", device=cuda)._fact
        px = torch.exp(torch.from_numpy(x)).to(cuda)
        return fa, px, torch.from_numpy(lengths).to(cuda)

    @pytest.mark.cuda
    @pytest.mark.parametrize("stages", [0, 1, 2])
    @pytest.mark.parametrize("mode,want", MODES)
    @pytest.mark.parametrize("debug", [True, False])
    def test_fast_kernels_match_plain(self, cuda, mode, want, debug,
                                      stages):
        """Every ring depth (lengths T, T - 2, 3 and 1), the fast pair's
        launches alone, bit-identical to the plain version and on a
        rerun."""
        fa, px, lens = self._fast_case(cuda, mode, 7, 40)
        assert fa.xsrc_mode == want and fk.ring_stages(fa) == 2
        fk.reset_launch_counts()
        got = fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                              debug=debug, stages=stages)
        assert fk.launched() == {"fact_fwd_bf16": 1, "fact_bwd_bf16": 1}
        ref = forward_backward_prob_fast(px, lens, fa, LEAKY)
        if not debug:
            ref = fk._frame0_traces(ref)
        for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert torch.equal(got.gamma.bfloat16().float(), got.gamma)
        again = fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                                debug=debug, stages=stages)
        assert torch.equal(again.gamma, got.gamma)

    @pytest.mark.cuda
    @pytest.mark.parametrize("mode,want", MODES)
    def test_fast_streams_are_bfloat16(self, cuda, mode, want):
        """fact_fwd_bf16's streams against the plain fast forward sweep,
        bit for bit: bfloat16 alpha' and W1 alpha', float32 s_t."""
        from pychain_tpu_torch.ops.factorized import (forward_prob_fast,
                                                      px_time_major)
        fa, px, lens = self._fast_case(cuda, mode, 8, 40)
        ad_ys, w1ad, xdst, xsrc, s_ys, _, _, _ = fk.fact_fwd(
            px, lens.int(), fa, LEAKY)
        assert ad_ys.dtype == w1ad.dtype == xdst.dtype == torch.bfloat16
        assert (xsrc is None) == (want == "identity")
        alpha_dash, w1_alpha, s_plain, _, _ = forward_prob_fast(
            px_time_major(px, fa), lens.long(), fa, LEAKY)
        T = px.shape[1]
        for b, Tb in enumerate(lens.tolist()):
            assert torch.equal(ad_ys[b, :Tb].float(),
                               alpha_dash[1:Tb + 1, :, b])
            assert torch.equal(w1ad[b, :Tb].float(), w1_alpha[:Tb, :, b])
            assert torch.equal(s_ys[b, :Tb], s_plain[b, :Tb])
            assert bool((s_ys[b, Tb:T] == 1.0).all())

    @pytest.mark.cuda
    def test_fast_chain_loss_matches_cpu(self, cuda):
        den_fst, x, lens, nums = _linear_setup(mode="separate")
        cpu = pt.ChainLoss(pt.ChainGraph(den_fst), precision="fast",
                           device="cpu")
        xc = torch.from_numpy(x).requires_grad_(True)
        vc = cpu(xc, lens, nums)
        vc.backward()
        gpu = pt.ChainLoss(pt.ChainGraph(den_fst), precision="fast")
        _, _, _, num_gpu = _linear_setup(mode="separate", device=cuda)
        xg = torch.from_numpy(x).to(cuda).requires_grad_(True)
        fk.reset_launch_counts()
        vg = gpu(xg, lens, num_gpu)
        vg.backward()
        assert fk.launched() == {"fact_fwd_bf16": 1, "fact_bwd_bf16": 1}
        torch.testing.assert_close(vg.cpu(), vc.detach(), rtol=1e-5, atol=0)
        torch.testing.assert_close(xg.grad.cpu(), xc.grad, rtol=0,
                                   atol=1e-6)

class TestStreamModes:
    """B1/B2's lean and ckpt stream modes (fact_fwd_snap, fact_fwd_init,
    fact_bwd_lean, fact_bwd_chunk and their _bf16 forms) against their
    plain versions (factorized.forward_backward_prob_mode): float32
    within the parity bars, the fast mode bit for bit.  B=5 columns of
    T=12 frames, lengths 12, 8, 4, 1, 9 (ends on a chunk boundary of C=4,
    in the first frame, one past a boundary)."""

    LENGTHS = [12, 8, 4, 1, 9]

    @classmethod
    def _case(cls, cuda, mode, tile_dtype, seed=9, num_phones=40):
        fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                                 seed=seed, forward_pdf_mode=mode)
        rng = np.random.RandomState(seed)
        x = rng.randn(5, 12, P).astype(np.float32)
        fa = pt.ChainGraphBatch(pt.ChainGraph(fst), 5, tile_dtype=tile_dtype,
                                device=cuda)._fact
        return (fa, torch.exp(torch.from_numpy(x)).to(cuda),
                torch.tensor(cls.LENGTHS, dtype=torch.int32).to(cuda))

    @staticmethod
    def _check(got, ref, fast, debug):
        if not debug:
            ref = fk._frame0_traces(ref)
        if fast:
            for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
                assert torch.equal(getattr(got, name),
                                   getattr(ref, name)), name
            assert torch.equal(got.gamma.bfloat16().float(), got.gamma)
        else:
            _assert_loss_close(got, ref)
        assert bool(got.ok.all())

    @pytest.mark.cuda
    @pytest.mark.parametrize("stages", [0, 1, 2])
    @pytest.mark.parametrize("mode,want", MODES)
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_lean_kernels_match_plain(self, cuda, tile_dtype, mode, want,
                                      stages):
        """fact_fwd_snap at C = 1 and fact_bwd_lean at every ring depth,
        debug True and False, one launch each; gamma on a rerun."""
        fa, px, lens = self._case(cuda, mode, tile_dtype)
        assert fa.xsrc_mode == want and fk.ring_stages(fa, lean=True) == 2
        sfx = "_bf16" if tile_dtype else ""
        for debug in (True, False):
            fk.reset_launch_counts()
            got = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, debug=debug, stream_mode="lean",
                stages=stages)
            assert fk.launched() == {f"fact_fwd_snap{sfx}": 1,
                                     f"fact_bwd_lean{sfx}": 1}
            ref = forward_backward_prob_mode(px, lens, fa, LEAKY, "lean")
            self._check(got, ref, bool(tile_dtype), debug)
        again = fk.forward_backward_prob_kernel(
            px, lens, fa, LEAKY, stream_mode="lean", stages=stages)
        assert torch.equal(again.gamma,
                           fk.forward_backward_prob_kernel(
                               px, lens, fa, LEAKY, stream_mode="lean",
                               stages=stages).gamma)

    @pytest.mark.cuda
    @pytest.mark.parametrize("chunk", [4, 5, 12, 64])
    @pytest.mark.parametrize("mode,want", MODES)
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_ckpt_kernels_match_plain(self, cuda, tile_dtype, mode, want,
                                      chunk):
        """C dividing T (4), not dividing it (5), equal to T and past it
        (one chunk): one snapshot sweep, then a replay and a chunk's
        backward a chunk; debug True and False; gamma on a rerun."""
        fa, px, lens = self._case(cuda, mode, tile_dtype)
        assert fa.xsrc_mode == want
        sfx = "_bf16" if tile_dtype else ""
        n = -(-12 // min(chunk, 12))
        for debug in (True, False):
            fk.reset_launch_counts()
            got = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, debug=debug, stream_mode="ckpt",
                ckpt_chunk=chunk)
            assert fk.launched() == {f"fact_fwd_snap{sfx}": 1,
                                     f"fact_fwd_init{sfx}": n,
                                     f"fact_bwd_chunk{sfx}": n}
            ref = forward_backward_prob_mode(px, lens, fa, LEAKY, "ckpt",
                                             chunk)
            self._check(got, ref, bool(tile_dtype), debug)
        again = fk.forward_backward_prob_kernel(
            px, lens, fa, LEAKY, stream_mode="ckpt", ckpt_chunk=chunk)
        assert torch.equal(again.gamma, got.gamma)

    @pytest.mark.cuda
    @pytest.mark.parametrize("stages", [0, 1, 2])
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_ckpt_chunks_at_every_ring_depth(self, cuda, tile_dtype, stages):
        """fact_bwd_chunk with its ring forced to each depth at C = 5."""
        fa, px, lens = self._case(cuda, "separate", tile_dtype)
        got = fk.forward_backward_prob_kernel(
            px, lens, fa, LEAKY, stream_mode="ckpt", ckpt_chunk=5,
            stages=stages)
        ref = forward_backward_prob_mode(px, lens, fa, LEAKY, "ckpt", 5)
        self._check(got, ref, bool(tile_dtype), True)

    @pytest.mark.cuda
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_snapshot_sweep(self, cuda, tile_dtype):
        """fact_fwd_snap's rows: at C = 1 the alpha' stream of fact_fwd,
        at C = 4 its rows 3, 7 (alpha'(4), alpha'(8)), with the same s_t;
        the fast form equals the plain fast sweep's snapshots bit for
        bit."""
        from pychain_tpu_torch.ops.factorized import forward_prob_fast
        fa, px, lens = self._case(cuda, "cross", tile_dtype)
        full = fk.fact_fwd(px, lens, fa, LEAKY)
        one, s1, last1 = fk.fact_fwd_snap(px, lens, fa, LEAKY, 1)[:3]
        four, s4, _ = fk.fact_fwd_snap(px, lens, fa, LEAKY, 4)[:3]
        assert one.shape == full[0].shape and four.shape == (5, 3, fa.s_pad)
        live = torch.arange(12, device=cuda)[None, :] < lens[:, None]
        for b, Tb in enumerate(self.LENGTHS):
            rows = [3, 7] if Tb >= 8 else [3] if Tb >= 4 else []
            for s_ys in (s1, s4):
                torch.testing.assert_close(s_ys[b], full[4][b], rtol=1e-6,
                                           atol=0)
            torch.testing.assert_close(one[b, :Tb].float(),
                                       full[0][b, :Tb].float(), rtol=1e-5,
                                       atol=1e-7)
            for k, r in enumerate(rows):
                torch.testing.assert_close(four[b, k].float(),
                                           one[b, r].float(), rtol=1e-5,
                                           atol=1e-7)
        torch.testing.assert_close(last1, full[5], rtol=1e-5, atol=1e-7)
        if tile_dtype:
            snaps, _, s_plain, _, _ = forward_prob_fast(
                px.permute(1, 2, 0), lens.long(), fa, LEAKY, snap=4)
            assert torch.equal(s4[live], s_plain[live])
            for b, Tb in enumerate(self.LENGTHS):
                for k in range(1, 3):
                    if 4 * k < Tb:
                        assert torch.equal(four[b, k - 1].float(),
                                           snaps[k][:, b])

    @pytest.mark.cuda
    @pytest.mark.parametrize("C", [2, 4])
    @pytest.mark.parametrize("stages", [0, 1, 2])
    @pytest.mark.parametrize("mode,want", MODES)
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_lean_cluster_kernels_give_one_blocks_bits(
            self, cuda, tile_dtype, mode, want, stages, C):
        """fact_fwd_snap and fact_bwd_lean on C = 2 and 4 CTAs a column,
        every ring depth: bit for bit the C = 1 kernels' results (float32
        and fast), the fast forms also the plain version's; one launch
        each; gamma on a rerun."""
        fa, px, lens = self._case(cuda, mode, tile_dtype)
        assert fa.xsrc_mode == want
        sfx = "_bf16" if tile_dtype else ""
        for debug in (True, False):
            one = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, debug=debug, stream_mode="lean",
                stages=stages, cluster=1)
            fk.reset_launch_counts()
            got = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, debug=debug, stream_mode="lean",
                stages=stages, cluster=C)
            assert fk.launched() == {f"fact_fwd_snap{sfx}": 1,
                                     f"fact_bwd_lean{sfx}": 1}
            for name in ("objf", "gamma", "alpha_beta", "gamma_sum", "ok"):
                assert torch.equal(getattr(got, name),
                                   getattr(one, name)), name
            ref = forward_backward_prob_mode(px, lens, fa, LEAKY, "lean")
            self._check(got, ref, bool(tile_dtype), debug)
        again = fk.forward_backward_prob_kernel(
            px, lens, fa, LEAKY, stream_mode="lean", stages=stages,
            cluster=C)
        assert torch.equal(again.gamma, fk.forward_backward_prob_kernel(
            px, lens, fa, LEAKY, stream_mode="lean", stages=stages,
            cluster=C).gamma)

    @pytest.mark.cuda
    @pytest.mark.parametrize("num_phones", [40, 41])
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_lean_cluster_px_rows(self, cuda, tile_dtype, num_phones):
        """fact_bwd_lean's cluster form with px's rows in its ring (P % 4
        == 0) and gathering them from px (P % 4 != 0): C = 1's bits at
        C = 2 and 4, every ring depth."""
        fa, px, lens = self._case(cuda, "cross", tile_dtype,
                                  num_phones=num_phones)
        P = px.shape[2]
        assert P % 4 == (num_phones % 2) * 2
        for stages in (0, 1, 2):
            assert fk.lean_px_ring(fa, stages, P) == (stages > 0
                                                      and P % 4 == 0)
            one = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, stream_mode="lean", stages=stages,
                cluster=1)
            for C in (2, 4):
                got = fk.forward_backward_prob_kernel(
                    px, lens, fa, LEAKY, stream_mode="lean", stages=stages,
                    cluster=C)
                for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
                    assert torch.equal(getattr(got, name),
                                       getattr(one, name)), name

    @pytest.mark.cuda
    @pytest.mark.parametrize("C", [2, 4])
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_ckpt_snapshot_sweep_on_a_cluster(self, cuda, tile_dtype, C):
        """The ckpt mode with its snapshot sweep on C CTAs a column, at
        C=5 and 12: C = 1's bits, and float32 the full mode's bits."""
        fa, px, lens = self._case(cuda, "separate", tile_dtype)
        full = fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                               stream_mode="full")
        for chunk in (5, 12):
            one = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, stream_mode="ckpt", ckpt_chunk=chunk,
                cluster=1)
            got = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, stream_mode="ckpt", ckpt_chunk=chunk,
                cluster=C)
            for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
                assert torch.equal(getattr(got, name), getattr(one, name))
                if not tile_dtype:
                    assert torch.equal(getattr(got, name),
                                       getattr(full, name)), name

    @pytest.mark.cuda
    @pytest.mark.parametrize("debug", [True, False])
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_lean_cluster_past_1024_states(self, cuda, tile_dtype, debug):
        """S_pad 1,280 and P past 1,024 (two rows and two pdfs for some
        virtual threads): lean at C = 2 and 4 gives C = 1's bits; float32
        also the full mode's, the fast mode the plain version's."""
        fst, P = denominator_fst(num_phones=600, states_per_phone=2, seed=3,
                                 forward_pdf_mode="source")
        fa = pt.ChainGraphBatch(pt.ChainGraph(fst), 3, tile_dtype=tile_dtype,
                                device=cuda)._fact
        assert fa.s_pad > 1024 and P > 1024
        rng = np.random.RandomState(4)
        px = torch.exp(torch.from_numpy(
            rng.randn(3, 7, P).astype(np.float32))).to(cuda)
        lens = torch.tensor([7, 5, 2], dtype=torch.int32).to(cuda)
        one = fk.forward_backward_prob_kernel(
            px, lens, fa, LEAKY, debug=debug, stream_mode="lean", cluster=1)
        full = fk.forward_backward_prob_kernel(
            px, lens, fa, LEAKY, debug=debug, stream_mode="full")
        for C in (2, 4):
            got = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, debug=debug, stream_mode="lean",
                cluster=C)
            for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
                assert torch.equal(getattr(got, name), getattr(one, name))
                if not tile_dtype:
                    assert torch.equal(getattr(got, name),
                                       getattr(full, name)), name
        if tile_dtype:
            self._check(one, forward_backward_prob_mode(px, lens, fa, LEAKY,
                                                        "lean"), True, debug)

    @pytest.mark.cuda
    def test_cluster_ctas_sit_on_distinct_sms(self, cuda):
        """A C = 2 launch of each lean form at B = 64 (main path 7's batch)
        on the headline-sized request: the two CTAs of every cluster run on
        two SMs (the request keeps two CTAs off one SM), read from %smid;
        at C = 4 the four likewise."""
        fa, px, lens = self._case(cuda, "source", "bfloat16")
        B = 64
        px = px[:1].expand(B, -1, -1).contiguous()
        lens = torch.full((B,), 12, dtype=torch.int32, device=cuda)
        for C in (2, 4):
            smid = torch.full((B * C,), -1, dtype=torch.int32, device=cuda)
            ad_ys, s_ys, ad_last, ad0, s0 = fk.fact_fwd_snap(
                px, lens, fa, LEAKY, cluster=C, smid=smid)
            pairs = smid.view(B, C).cpu()
            assert bool((pairs >= 0).all())
            assert all(len(set(row.tolist())) == C for row in pairs)
            _, tot = fk._objf(s_ys, ad_last, lens, fa, s0)
            smid.fill_(-1)
            fk.fact_bwd_lean(lens, fa, LEAKY, ad_ys, px, s_ys, ad0, s0,
                             tot.contiguous(), cluster=C, smid=smid)
            pairs = smid.view(B, C).cpu()
            assert all(len(set(row.tolist())) == C for row in pairs)

    @pytest.mark.cuda
    def test_lean_cluster_errors_before_any_launch(self, cuda):
        """A forced cluster that is not built raises NotImplementedError
        in every mode; a launch of any form at such a C raises
        ValueError."""
        fa, px, lens = self._case(cuda, "source", None)
        fk.reset_launch_counts()
        for bad in (3, 8):
            for mode in fk.STREAM_MODES:
                with pytest.raises(NotImplementedError, match="cluster of"):
                    fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                                    stream_mode=mode,
                                                    cluster=bad)
        with pytest.raises(ValueError, match="is not built"):
            fk._fwd_launch("fact_fwd", px, lens, fa, LEAKY,
                           [None] * 4, cluster=3)
        assert fk.launched() == {}

    @pytest.mark.cuda
    @pytest.mark.parametrize("want", ["lean", "ckpt"])
    @pytest.mark.parametrize("precision", ["parity", "fast"])
    def test_chain_loss_auto_reaches_the_mode(self, cuda, monkeypatch,
                                              precision, want):
        """ChainLoss under "auto" with the card's budget stubbed (one
        stream's bytes: "lean"; 1 byte: "ckpt") launches that mode's
        kernels, and matches ChainLoss on the CPU under the same budget
        (value 1e-5 relative, gradient 1e-6)."""
        den_fst, x, lens, nums = _linear_setup(mode="separate")
        fa = pt.ChainGraphBatch(pt.ChainGraph(den_fst), 3, device="cpu",
                                tile_dtype="bfloat16" if precision == "fast"
                                else None)._fact
        row = 8 * fa.s_pad * 3 * fk.stream_dtype(fa).itemsize
        budget = row if want == "lean" else 1
        monkeypatch.setattr(fk, "STREAM_BUDGET", budget)
        monkeypatch.setattr(fk, "stream_budget", lambda device: budget)
        cpu = pt.ChainLoss(pt.ChainGraph(den_fst), precision=precision,
                           device="cpu")
        xc = torch.from_numpy(x).requires_grad_(True)
        vc = cpu(xc, lens, nums)
        vc.backward()
        gpu = pt.ChainLoss(pt.ChainGraph(den_fst), precision=precision)
        _, _, _, num_gpu = _linear_setup(mode="separate", device=cuda)
        xg = torch.from_numpy(x).to(cuda).requires_grad_(True)
        fk.reset_launch_counts()
        vg = gpu(xg, lens, num_gpu)
        vg.backward()
        sfx = "_bf16" if precision == "fast" else ""
        n = -(-8 // fk.ckpt_chunk_length(8))
        assert fk.launched() == (
            {f"fact_fwd_snap{sfx}": 1, f"fact_bwd_lean{sfx}": 1}
            if want == "lean" else
            {f"fact_fwd_snap{sfx}": 1, f"fact_fwd_init{sfx}": n,
             f"fact_bwd_chunk{sfx}": n})
        torch.testing.assert_close(vg.cpu(), vc.detach(), rtol=1e-5, atol=0)
        torch.testing.assert_close(xg.grad.cpu(), xc.grad, rtol=0,
                                   atol=1e-6)

    @pytest.mark.cuda
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_cluster_tier_raises_past_its_budget(self, cuda, monkeypatch,
                                                 tile_dtype):
        """The cluster kernels keep the full mode alone: past the card's
        budget they raise before any launch."""
        fa, px, lens = self._case(cuda, "separate", tile_dtype)
        monkeypatch.setattr(fk, "stream_budget", lambda device: 1)
        stk.reset_launch_counts()
        fk.reset_launch_counts()
        with pytest.raises(NotImplementedError, match="cluster kernels"):
            stk.forward_backward_prob_stream(px, lens, fa, LEAKY)
        assert set(stk.LAUNCHES.values()) == {0} and fk.launched() == {}
        # the resident tier takes the ckpt mode there
        fk.forward_backward_prob_kernel(px, lens, fa, LEAKY)
        assert set(fk.launched()) == {
            f"{k}{'_bf16' if tile_dtype else ''}"
            for k in ("fact_fwd_snap", "fact_fwd_init", "fact_bwd_chunk")}

    @pytest.mark.cuda
    def test_stream_mode_errors_before_any_launch(self, cuda):
        fa, px, lens = self._case(cuda, "source", None)
        fk.reset_launch_counts()
        with pytest.raises(ValueError, match="stream_mode"):
            fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                            stream_mode="bogus")
        for chunk in (0, -4, 2.5):
            with pytest.raises(ValueError, match="ckpt_chunk"):
                fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                                stream_mode="ckpt",
                                                ckpt_chunk=chunk)
        assert fk.launched() == {}


class TestFullCluster:
    """B1/B2's full-stream forms on a cluster of C CTAs a column
    (fact_fwd, fact_bwd: the full mode; fact_fwd_init, fact_bwd_chunk:
    the ckpt mode's replays and chunk backwards) and their _bf16 forms:
    C = 2 and 4 give the C = 1 kernels' bits, the fast forms also the
    plain fast version's, at every ring depth, on TestStreamModes' case
    (B=5, T=12, lengths 12, 8, 4, 1, 9)."""

    @staticmethod
    def _equal(got, ref):
        for name in ("objf", "gamma", "alpha_beta", "gamma_sum", "ok"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name

    @pytest.mark.cuda
    @pytest.mark.parametrize("C", [2, 4])
    @pytest.mark.parametrize("stages", [0, 1, 2])
    @pytest.mark.parametrize("mode,want", MODES)
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_full_cluster_kernels_give_one_blocks_bits(
            self, cuda, tile_dtype, mode, want, stages, C):
        """The full mode at C, debug True and False: one launch of each
        form, C = 1's bits, the fast forms the plain version's; the
        streams of fact_fwd at C equal C = 1's on every column's frames;
        gamma on a rerun."""
        fa, px, lens = TestStreamModes._case(cuda, mode, tile_dtype)
        assert fa.xsrc_mode == want
        sfx = "_bf16" if tile_dtype else ""
        for debug in (True, False):
            one = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, debug=debug, stream_mode="full",
                stages=stages, cluster=1)
            fk.reset_launch_counts()
            got = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, debug=debug, stream_mode="full",
                stages=stages, cluster=C)
            assert fk.launched() == {f"fact_fwd{sfx}": 1,
                                     f"fact_bwd{sfx}": 1}
            self._equal(got, one)
            if tile_dtype:
                TestStreamModes._check(got, forward_backward_prob_fast(
                    px, lens, fa, LEAKY), True, debug)
        for a, b in zip(fk.fact_fwd(px, lens, fa, LEAKY, cluster=C)[:6],
                        fk.fact_fwd(px, lens, fa, LEAKY, cluster=1)[:6]):
            assert (a is None) == (b is None)
            for col, Tb in enumerate(TestStreamModes.LENGTHS):
                if a is not None and a.dim() == 3:
                    assert torch.equal(a[col, :Tb], b[col, :Tb])
                elif a is not None:
                    assert torch.equal(a[col], b[col])
        again = fk.forward_backward_prob_kernel(
            px, lens, fa, LEAKY, stream_mode="full", stages=stages,
            cluster=C)
        assert torch.equal(again.gamma, fk.forward_backward_prob_kernel(
            px, lens, fa, LEAKY, stream_mode="full", stages=stages,
            cluster=C).gamma)

    @pytest.mark.cuda
    @pytest.mark.parametrize("C", [2, 4])
    @pytest.mark.parametrize("stages", [0, 1, 2])
    @pytest.mark.parametrize("mode,want", MODES)
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_ckpt_cluster_kernels_give_one_blocks_bits(
            self, cuda, tile_dtype, mode, want, stages, C):
        """The ckpt mode at C, chunk 5 (columns ending inside a chunk and
        on no boundary), debug True and False: one snapshot sweep and a
        replay and a chunk backward a chunk, all at C; C = 1's bits; the
        fast forms the plain version's, float32 the full mode's."""
        fa, px, lens = TestStreamModes._case(cuda, mode, tile_dtype)
        assert fa.xsrc_mode == want
        sfx = "_bf16" if tile_dtype else ""
        for debug in (True, False):
            one = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, debug=debug, stream_mode="ckpt",
                ckpt_chunk=5, stages=stages, cluster=1)
            fk.reset_launch_counts()
            got = fk.forward_backward_prob_kernel(
                px, lens, fa, LEAKY, debug=debug, stream_mode="ckpt",
                ckpt_chunk=5, stages=stages, cluster=C)
            assert fk.launched() == {f"fact_fwd_snap{sfx}": 1,
                                     f"fact_fwd_init{sfx}": 3,
                                     f"fact_bwd_chunk{sfx}": 3}
            self._equal(got, one)
            if tile_dtype:
                TestStreamModes._check(got, forward_backward_prob_mode(
                    px, lens, fa, LEAKY, "ckpt", 5), True, debug)
            else:
                self._equal(got, fk.forward_backward_prob_kernel(
                    px, lens, fa, LEAKY, debug=debug, stream_mode="full",
                    stages=stages, cluster=C))

    @pytest.mark.cuda
    @pytest.mark.parametrize("mode", ["full", "ckpt"])
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_full_cluster_past_1024_states(self, cuda, tile_dtype, mode):
        """S_pad 1,280 and P past 1,024 (two rows and two pdfs for some
        virtual threads): the full mode and the ckpt mode (chunk 3) at
        C = 2 and 4 give C = 1's bits; the fast mode also the plain
        version's."""
        fst, P = denominator_fst(num_phones=600, states_per_phone=2, seed=3,
                                 forward_pdf_mode="source")
        fa = pt.ChainGraphBatch(pt.ChainGraph(fst), 3, tile_dtype=tile_dtype,
                                device=cuda)._fact
        assert fa.s_pad > 1024 and P > 1024
        rng = np.random.RandomState(4)
        px = torch.exp(torch.from_numpy(
            rng.randn(3, 7, P).astype(np.float32))).to(cuda)
        lens = torch.tensor([7, 5, 2], dtype=torch.int32).to(cuda)
        run = lambda C: fk.forward_backward_prob_kernel(
            px, lens, fa, LEAKY, stream_mode=mode, ckpt_chunk=3, cluster=C)
        one = run(1)
        for C in (2, 4):
            self._equal(run(C), one)
        if tile_dtype:
            TestStreamModes._check(one, forward_backward_prob_mode(
                px, lens, fa, LEAKY, mode, 3), True, True)

    @pytest.mark.cuda
    def test_full_cluster_ctas_sit_on_distinct_sms(self, cuda):
        """A launch of each full and chunk form at B = 64 (main path 7's
        batch) at C = 2 and 4: the CTAs of every cluster run on C distinct
        SMs (%smid)."""
        fa, px, lens = TestStreamModes._case(cuda, "separate", "bfloat16")
        B = 64
        px = px[:1].expand(B, -1, -1).contiguous()
        lens = torch.full((B,), 12, dtype=torch.int32, device=cuda)

        def distinct(smid, C):
            rows = smid.view(B, C).cpu()
            assert bool((rows >= 0).all())
            assert all(len(set(r.tolist())) == C for r in rows)

        for C in (2, 4):
            smid = torch.full((B * C,), -1, dtype=torch.int32, device=cuda)
            streams = fk.fact_fwd(px, lens, fa, LEAKY, cluster=C, smid=smid)
            distinct(smid, C)
            ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = streams
            tot = fk._objf(s_ys, ad_last, lens, fa, s0)[1].contiguous()
            smid.fill_(-1)
            fk.fact_bwd(lens, fa, LEAKY, ad_ys, w1ad, xdst, xsrc, s_ys, ad0,
                        s0, tot, px.shape[2], cluster=C, smid=smid)
            distinct(smid, C)
            chunk = [t[:, 4:8].contiguous() for t in (ad_ys, w1ad, xdst,
                                                      xsrc)]
            smid.fill_(-1)
            fk.fact_fwd_init(px, lens, fa, LEAKY, 4, ad_ys[:, 3],
                             s_ys[:, 3].contiguous(), chunk, cluster=C,
                             smid=smid)
            distinct(smid, C)
            outs = fk._outputs(B, 12, px.shape[2], cuda)
            carry = (torch.zeros((B, fa.s_pad), device=cuda),
                     torch.zeros(B, device=cuda))
            smid.fill_(-1)
            fk.fact_bwd_chunk(lens, fa, LEAKY, chunk, s_ys, ad0, s0, tot, 4,
                              ad_ys[:, 3], outs, carry, cluster=C,
                              smid=smid)
            distinct(smid, C)

    @pytest.mark.cuda
    @pytest.mark.parametrize("mode", ["full", "ckpt"])
    def test_full_cluster_that_does_not_fit_raises_before_any_launch(
            self, cuda, monkeypatch, mode):
        """A forced C > 1 on a card whose block cannot hold a cluster CTA
        (a 99 KB block, stubbed) raises NotImplementedError before any
        launch; the plan then takes C = 1, which runs."""
        fa, px, lens = TestStreamModes._case(cuda, "source", "bfloat16")
        small = types.SimpleNamespace(multi_processor_count=132,
                                      shared_memory_per_block_optin=101376)
        monkeypatch.setattr(fk, "_card_props", lambda device: small)
        fk.reset_launch_counts()
        for C in (2, 4):
            with pytest.raises(NotImplementedError, match="118784"):
                fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                                stream_mode=mode, cluster=C)
        assert fk.launched() == {}
        assert set(fk._mode_cluster(mode, px, fa, None).values()) == {1}
        self._equal(fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                                    stream_mode=mode),
                    fk.forward_backward_prob_kernel(px, lens, fa, LEAKY,
                                                    stream_mode=mode,
                                                    cluster=1))


# ----------------------------------------------------------------------
# The cluster kernels B3/B4 (ops/stream_kernels.py)
# ----------------------------------------------------------------------

def _stream_case(mode, B=5, T=9, seed=2, num_phones=150, tile_dtype=None):
    """S = 300, S_pad = 384: 12 slices of 32 rows, so with C = 8 ranks
    0-3 own two slices and ranks 4-7 one (num_phones=10, S_pad = 128:
    ranks 4-7 own none).  B = 5 columns of unequal lengths: no G > 1
    divides B, and a group mixes lengths."""
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=mode)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, P).astype(np.float32)
    lengths = np.array([T, T - 2, 3, 1, T - 4][:B], np.int32)
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), B, tile_dtype=tile_dtype,
                            device="cpu")._fact
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
        assert stk.LAUNCHES == {"stream_fwd": 1, "stream_bwd": 1,
                                "stream_fwd_bf16": 0, "stream_bwd_bf16": 0}
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


class TestStreamFast:
    """B3/B4 in the fast mode (stream_fwd_bf16, stream_bwd_bf16) against
    the plain fast version with cluster=C, bit for bit."""

    @staticmethod
    def _case(cuda, mode, num_phones=150):
        fa, px, lens = _stream_case(mode, num_phones=num_phones,
                                    tile_dtype="bfloat16")
        return fa.to(cuda), px.to(cuda), lens.to(cuda)

    @pytest.mark.cuda
    @pytest.mark.parametrize("G", [1, 2, 4])
    @pytest.mark.parametrize("C", [1, 2, 4, 8])
    @pytest.mark.parametrize("mode,want", MODES)
    @pytest.mark.parametrize("debug", [True, False])
    def test_cuda_fast_stream_kernels_match_plain(self, cuda, mode, want, C,
                                                  G, debug):
        """objf, gamma and both traces equal the plain fast version at
        cluster=C; the fast pair's launches alone; gamma on a rerun."""
        fa, px, lens = self._case(cuda, mode)
        assert fa.xsrc_mode == want
        stk.reset_launch_counts()
        got = stk.forward_backward_prob_stream(px, lens, fa, LEAKY,
                                               debug=debug, cluster=C,
                                               columns=G)
        assert stk.LAUNCHES == {"stream_fwd": 0, "stream_bwd": 0,
                                "stream_fwd_bf16": 1, "stream_bwd_bf16": 1}
        ref = forward_backward_prob_fast(px, lens, fa, LEAKY, cluster=C)
        if not debug:
            ref = fk._frame0_traces(ref)
        for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
        assert torch.equal(got.gamma.bfloat16().float(), got.gamma)
        again = stk.forward_backward_prob_stream(px, lens, fa, LEAKY,
                                                 debug=debug, cluster=C,
                                                 columns=G)
        assert torch.equal(again.gamma, got.gamma)

    @pytest.mark.cuda
    @pytest.mark.parametrize("C", [1, 2, 4, 8])
    @pytest.mark.parametrize("mode,want", MODES)
    def test_cuda_fast_stream_streams_are_bfloat16(self, cuda, mode, want,
                                                   C):
        """stream_fwd_bf16's four streams are bfloat16 and equal the plain
        fast sweep's (alpha', W1 alpha') and the rounded emissions (x_dst,
        x_src) bit for bit; s_t float32, 1 past each column's end."""
        from pychain_tpu_torch.ops.factorized import forward_prob_fast
        fa, px, lens = self._case(cuda, mode)
        ad_ys, w1ad, xdst, xsrc, s_ys, _, _, _ = stk.stream_fwd(
            px, lens.int(), fa, LEAKY, cluster=C)
        for t in (ad_ys, w1ad, xdst) + ((xsrc,) if xsrc is not None
                                        else ()):
            assert t.dtype == torch.bfloat16
        assert (xsrc is None) == (want == "identity")
        assert s_ys.dtype == torch.float32
        alpha_dash, w1_alpha, s_plain, _, _ = forward_prob_fast(
            px.permute(1, 2, 0), lens.long(), fa, LEAKY, cluster=C)
        kg = fk.graph_for(fa)
        T = px.shape[1]
        for b, Tb in enumerate(lens.tolist()):
            assert torch.equal(ad_ys[b, :Tb].float(),
                               alpha_dash[1:Tb + 1, :, b])
            assert torch.equal(w1ad[b, :Tb].float(), w1_alpha[:Tb, :, b])
            x = px[b, :Tb]
            assert torch.equal(xdst[b, :Tb], x[:, kg.f_dst.long()]
                               .bfloat16())
            if xsrc is not None:
                assert torch.equal(xsrc[b, :Tb], x[:, kg.g_src.long()]
                                   .bfloat16())
            assert torch.equal(s_ys[b, :Tb], s_plain[b, :Tb])
            assert bool((s_ys[b, Tb:T] == 1.0).all())

    @pytest.mark.cuda
    @pytest.mark.parametrize("C", [1, 2, 8])
    @pytest.mark.parametrize("mode,want", MODES)
    def test_cuda_fast_stream_gamma_is_the_same_at_every_g(self, cuda, mode,
                                                           want, C):
        fa, px, lens = self._case(cuda, mode)
        res = [stk.forward_backward_prob_stream(px, lens, fa, LEAKY,
                                                cluster=C, columns=G)
               for G in (1, 2, 4)]
        for r in res[1:]:
            for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
                assert torch.equal(getattr(r, name), getattr(res[0], name))

    @pytest.mark.cuda
    @pytest.mark.parametrize("G", [1, 2, 4])
    def test_cuda_fast_stream_with_idle_ranks(self, cuda, G):
        """S_pad 128 at C = 8: ranks 4-7 own no rows."""
        fa, px, lens = self._case(cuda, "separate", num_phones=10)
        assert fa.s_pad == 128
        got = stk.forward_backward_prob_stream(px, lens, fa, LEAKY,
                                               cluster=8, columns=G)
        ref = forward_backward_prob_fast(px, lens, fa, LEAKY, cluster=8)
        for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name

    @pytest.mark.cuda
    def test_cuda_fast_chain_loss_on_the_cluster_tier_matches_cpu(self,
                                                                 cuda):
        """ChainLoss(precision="fast") with the denominator forced to
        engine="stream": one launch of each fast cluster kernel and none of
        another denominator kernel; value and gradient against the CPU
        (the plain fast version in B1/B2's order: sums in another order,
        value relative 1e-5, gradient 1e-6 absolute)."""
        den_fst, x, lens, nums = _linear_setup(mode="separate")
        _, _, _, num_gpu = _linear_setup(mode="separate", device=cuda)
        vals, grads = [], []
        for device, nb in (("cpu", nums), (cuda, num_gpu)):
            loss_mod = pt.ChainLoss(pt.ChainGraph(den_fst), precision="fast",
                                    device=device)
            den = loss_mod.den_batch(x.shape[0])
            den._fact = dataclasses.replace(den._fact, engine="stream")
            xt = torch.from_numpy(x).to(device).requires_grad_(True)
            stk.reset_launch_counts()
            fk.reset_launch_counts()
            v = loss_mod(xt, lens, nb)
            v.backward()
            vals.append(float(v.detach()))
            grads.append(xt.grad.cpu())
        assert stk.LAUNCHES == {"stream_fwd": 0, "stream_bwd": 0,
                                "stream_fwd_bf16": 1, "stream_bwd_bf16": 1}
        assert set(fk.LAUNCHES.values()) == {0}
        np.testing.assert_allclose(vals[1], vals[0], rtol=1e-5)
        torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=1e-6)

    @pytest.mark.cuda
    def test_cuda_fast_stream_raises_only_for_a_resource_limit(self, cuda):
        """A (C, G) that is not compiled raises before any launch; nothing
        falls back to the float32 kernels or the plain version."""
        fa, px, lens = self._case(cuda, "separate")
        stk.reset_launch_counts()
        fk.reset_launch_counts()
        with pytest.raises(NotImplementedError, match="cluster 3"):
            stk.forward_backward_prob_stream(px, lens, fa, LEAKY, cluster=3)
        assert set(stk.LAUNCHES.values()) == {0}
        assert set(fk.LAUNCHES.values()) == {0}


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
        assert fk.launched() == {"fact_fwd": 1, "fact_bwd": 1}
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
        assert fk.launched() == {"fact_fwd": 1, "fact_bwd": 1}
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


def _wide_fst(n_par=300, seed=0):
    """A graph with a state of n_par (> 256) in-arcs: state 0 -> 1 over
    n_par parallel arcs in a few weights and pdfs, so that many of them
    tie, then 1 -> 2 -> 1 and 2 -> 0 back; every state final (as
    tests/test_torch_viterbi.py's)."""
    rng = np.random.RandomState(seed)
    arcs = [(0, 1, int(p) + 1, int(p) + 1, float(w)) for p, w in
            zip(rng.randint(0, 3, size=n_par),
                rng.choice([0.0, 0.5], size=n_par))]
    arcs += [(1, 2, 4, 4, 0.0), (2, 1, 5, 5, 0.25), (2, 0, 6, 6, 0.0),
             (1, 1, 7, 7, 1.0)]
    return FST.from_arcs(3, 0, arcs, {s: 0.0 for s in range(3)})


def _vit_batch(case, device, seed=5):
    """(SemiringArrays, x on the device, lengths) of a case."""
    fsts, shared, lengths, x = _vit_case(case, seed=seed)
    if shared:
        batch = pt.ChainGraphBatch(pt.ChainGraph(fsts[0], log_domain=True),
                                   x.shape[0], device=device)
    else:
        batch = _list_batch(fsts, device=device)
    return batch.semiring(), torch.from_numpy(x).to(device), lengths


def _assert_vit_equal(got, ref):
    for name in got._fields:     # bit-identical: no tolerance
        assert torch.equal(getattr(got, name), getattr(ref, name)), name



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
        _assert_vit_equal(got, ref)

    @pytest.mark.cuda
    @pytest.mark.parametrize("case", ["mixed", "loud", "ties", "shared"])
    @pytest.mark.parametrize("res,stages,bp_smem", vk.CHOICES)
    def test_cuda_every_layout_matches_plain(self, cuda, case, res, stages,
                                             bp_smem):
        """Each layout plan() can choose, forced: bit-identical to the
        plain version."""
        g, xt, lengths = _vit_batch(case, cuda)
        lay = vk.plan_for(g, VIT_P, VIT_T)
        lay = dataclasses.replace(
            lay, stages=stages, resident=res, bp_smem=bp_smem,
            threads=vk.threads_for(g.num_states, lay.lanes, stages > 0))
        ref = viterbi_plain(xt, lengths, g)
        _assert_vit_equal(vk.viterbi_kernel(xt, lengths, g, lay), ref)

    @pytest.mark.cuda
    @pytest.mark.parametrize("case", ["mixed", "loud", "ties", "shared"])
    @pytest.mark.parametrize("lanes", [1, 2, 4, 16, 32])
    def test_cuda_every_lane_count_matches_plain(self, cuda, case, lanes):
        """L lanes a state (ties fall across lanes): the same bits."""
        g, xt, lengths = _vit_batch(case, cuda)
        lay = dataclasses.replace(
            vk.plan_for(g, VIT_P, VIT_T), lanes=lanes,
            threads=vk.threads_for(g.num_states, lanes))
        ref = viterbi_plain(xt, lengths, g)
        _assert_vit_equal(vk.viterbi_kernel(xt, lengths, g, lay), ref)

    @pytest.mark.cuda
    @pytest.mark.parametrize("bp_smem", [True, False])
    def test_cuda_wide_in_degree_matches_plain(self, cuda, bp_smem):
        """A state of 300 in-arcs, many tied: two-byte positions, held
        in shared or in device memory, at 32 and 1 lanes."""
        batch = _list_batch([_wide_fst(seed=0), _wide_fst(seed=1),
                             make_numerator_fst([1, 3, 0], VIT_TOPO)],
                            device=cuda)
        g = batch.semiring()
        rng = np.random.RandomState(5)
        x = np.where(rng.rand(3, VIT_T, VIT_P) < 0.5, 0.0,
                     rng.randn(3, VIT_T, VIT_P)).astype(np.float32)
        x[0] = 1.0
        xt = torch.from_numpy(x).to(cuda)
        lengths = np.array([VIT_T, 7, 6], np.int32)
        lay = vk.plan_for(g, VIT_P, VIT_T)
        assert lay.bp_width == 2 and lay.lanes == 32 and lay.bp_smem
        ref = viterbi_plain(xt, lengths, g)
        assert bool(ref.ok.all())
        for lanes in (32, 1):
            forced = dataclasses.replace(
                lay, bp_smem=bp_smem, lanes=lanes,
                threads=vk.threads_for(g.num_states, lanes))
            _assert_vit_equal(vk.viterbi_kernel(xt, lengths, g, forced),
                              ref)

    @pytest.mark.cuda
    @pytest.mark.parametrize("case", ["mixed", "loud", "ties", "shared"])
    @pytest.mark.parametrize("bp_smem", [True, False])
    def test_cuda_four_byte_positions_match_plain(self, cuda, case, bp_smem):
        """Four-byte positions (in-degree past 65,536 in plan(); forced
        here), held in shared or in device memory: the same bits."""
        g, xt, lengths = _vit_batch(case, cuda)
        lay = dataclasses.replace(vk.plan_for(g, VIT_P, VIT_T),
                                  bp_width=4, bp_smem=bp_smem)
        ref = viterbi_plain(xt, lengths, g)
        _assert_vit_equal(vk.viterbi_kernel(xt, lengths, g, lay), ref)

    @pytest.mark.cuda
    def test_cuda_end_scoring_on_many_warps(self, cuda):
        """S_pad 40 at 32 lanes: 32 warps (31 computing, 40 states over
        31 groups) post their end-state pairs into whichever delta buffer
        is free after the last frame (odd and even lengths: either one),
        and none of them reaches the scores read."""
        fsts, _, lengths, x = _vit_case("mixed", seed=7)
        g = pt.ChainGraphBatch(
            [pt.ChainGraph(f, log_domain=True) for f in fsts],
            max_num_transitions=45, max_num_states=40,
            device=cuda).semiring()
        xt = torch.from_numpy(x).to(cuda)
        lay = dataclasses.replace(vk.plan_for(g, VIT_P, VIT_T), lanes=32,
                                  threads=vk.threads_for(40, 32))
        assert lay.threads == 1024
        ref = viterbi_plain(xt, lengths, g)
        _assert_vit_equal(vk.viterbi_kernel(xt, lengths, g, lay), ref)

    @pytest.mark.cuda
    def test_cuda_shape_at_the_limit_runs(self, cuda):
        """S_pad 29,056: the least layout (delta alone in shared memory)
        runs, one launch, the same bits as the plain version."""
        fsts, _, lengths, x = _vit_case("mixed", seed=6)
        batch = pt.ChainGraphBatch(
            [pt.ChainGraph(f, log_domain=True) for f in fsts],
            max_num_transitions=45, max_num_states=29056, device=cuda)
        g = batch.semiring()
        assert vk.plan_for(g, VIT_P, VIT_T) == vk.Layout(
            1024, 1, 0, False, False, 1)
        xt = torch.from_numpy(x).to(cuda)
        vk.reset_launch_counts()
        got = pt.viterbi_align(xt, lengths, batch)
        assert vk.LAUNCHES == {"viterbi": 1}
        _assert_vit_equal(got, viterbi_plain(xt, lengths, g))


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


# ----------------------------------------------------------------------
# The acoustic models (models/*) and checkpoints on the card
# ----------------------------------------------------------------------

MODEL_CASES = {
    "tdnn": ("TDNN", dict(num_pdfs=20, hidden_dim=32,
                          kernel_sizes=(3, 2, 3), dilations=(1, 3, 3),
                          strides=(1, 1, 2), dropout=0.0)),
    "tdnnf": ("TDNNF", dict(num_pdfs=20, hidden_dim=32, bottleneck_dim=16,
                            num_layers=3)),
    "blstm": ("BLSTM", dict(num_pdfs=20, hidden_dim=16, num_layers=2,
                            dropout=0.0)),
    "lstm_uni": ("BLSTM", dict(num_pdfs=20, hidden_dim=16, num_layers=2,
                               dropout=0.0, bidirectional=False)),
}
M_B, M_T, M_D = 3, 40, 6
M_LENGTHS = [40, 31, 17]


@pytest.fixture
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _model(case, device, seed=0):
    name, kw = MODEL_CASES[case]
    return getattr(pm, name)(getattr(pm, name + "Config")(**kw), M_D,
                             device=device,
                             generator=torch.Generator().manual_seed(seed))


def _forward(model, case, x, train=True):
    kw = ({"lengths": torch.tensor(M_LENGTHS, device=x.device)}
          if MODEL_CASES[case][0] == "BLSTM" else {})
    return model(x, train, **kw)


def _valid_mask(case, shape):
    mask = torch.ones(shape)
    if MODEL_CASES[case][0] == "BLSTM":
        for b, n in enumerate(M_LENGTHS):
            mask[b, n:] = 0
    return mask


class TestModels:

    @pytest.mark.cuda
    @pytest.mark.parametrize("case", list(MODEL_CASES))
    def test_cuda_train_step_matches_cpu(self, cuda, no_tf32, case):
        """One train-mode forward and backward of sum(out * w) on the card
        and on the CPU from the same weights (drawn on the CPU)."""
        x = torch.from_numpy(np.random.RandomState(1).randn(
            M_B, M_T, M_D).astype(np.float32))
        res = []
        for dev in (cuda, torch.device("cpu")):
            model = _model(case, dev)
            out = _forward(model, case, x.to(dev))
            w = torch.from_numpy(np.random.RandomState(2).randn(
                *out.shape).astype(np.float32))
            w = (w * _valid_mask(case, out.shape)).to(dev)
            (out * w).sum().backward()
            res.append((out.detach().cpu() * w.cpu().ne(0),
                        {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.grad is not None},
                        {n: b.cpu() for n, b in model.named_buffers()}))
        (out_c, g_c, b_c), (out_p, g_p, b_p) = res
        torch.testing.assert_close(out_c, out_p, rtol=1e-5, atol=1e-5)
        assert g_c.keys() == g_p.keys() and g_c
        for n in g_p:
            assert float((g_c[n] - g_p[n]).norm()) <= \
                1e-4 * float(g_p[n].norm()) + 1e-12, n
        for n in b_p:
            torch.testing.assert_close(b_c[n], b_p[n], rtol=0, atol=1e-5)

    @pytest.mark.cuda
    @pytest.mark.parametrize("bidirectional", [True, False])
    def test_cuda_blstm_reads_each_sequence_within_its_length(
            self, cuda, no_tf32, bidirectional):
        """With lengths (a CUDA tensor) each sequence's outputs are those
        of the sequence run alone, unpadded: the backward direction never
        reads the padding first."""
        model = pm.BLSTM(pm.BLSTMConfig(num_pdfs=20, hidden_dim=16,
                                        num_layers=2, dropout=0.0,
                                        bidirectional=bidirectional), M_D,
                         device=cuda)
        x = torch.randn(M_B, M_T, M_D, generator=torch.Generator(
            device=cuda).manual_seed(3), device=cuda)
        with torch.no_grad():
            out = model(x, lengths=torch.tensor(M_LENGTHS, device=cuda))
            for b, n in enumerate(M_LENGTHS):
                alone = model(x[b:b + 1, :n])
                torch.testing.assert_close(out[b, :n], alone[0], rtol=1e-5,
                                           atol=1e-5)

    @pytest.mark.cuda
    def test_cuda_models_default_to_the_card(self, cuda):
        cpu = _model("tdnn", "cpu")
        card = _model("tdnn", None)
        assert all(t.is_cuda for t in card.state_dict().values())
        for a, b in zip(cpu.state_dict().values(),
                        card.state_dict().values()):
            assert torch.equal(a, b.cpu())
        name, kw = MODEL_CASES["tdnn"]
        moved = model_from_flax(pm.TDNNConfig(**kw), model_to_flax(cpu))
        assert all(t.is_cuda for t in moved.state_dict().values())
        for a, b in zip(cpu.state_dict().values(),
                        moved.state_dict().values()):
            assert torch.equal(a, b.cpu())

    @pytest.mark.cuda
    def test_cuda_checkpoint_round_trip(self, cuda, tmp_path):
        x = torch.randn(M_B, M_T, M_D, generator=torch.Generator(
            device=cuda).manual_seed(4), device=cuda)
        model = _model("tdnnf", cuda)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)

        def step(m, o):
            o.zero_grad()
            loss = _forward(m, "tdnnf", x).square().mean()
            loss.backward()
            o.step()
            return float(loss.detach())
        for _ in range(2):
            step(model, opt)
        save_checkpoint(tmp_path, 2, {"model": model.state_dict(),
                                      "opt": opt.state_dict()})
        fresh = _model("tdnnf", cuda, seed=7)
        fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
        n, state = restore_checkpoint(
            tmp_path, {"model": fresh.state_dict(),
                       "opt": fresh_opt.state_dict()})
        assert n == 2
        assert all(t.is_cuda for t in state["model"].values())
        fresh.load_state_dict(state["model"])
        fresh_opt.load_state_dict(state["opt"])
        for a, b in zip(model.state_dict().values(),
                        fresh.state_dict().values()):
            assert torch.equal(a, b)
        saved, got = opt.state_dict()["state"], fresh_opt.state_dict()[
            "state"]
        assert saved.keys() == got.keys()
        for i in saved:
            for k in saved[i]:
                assert torch.equal(saved[i][k].cpu(), got[i][k].cpu())
        a, b = step(model, opt), step(fresh, fresh_opt)
        assert abs(a - b) <= 1e-6 * abs(a)

    @pytest.mark.cuda
    def test_cuda_training_step_through_the_fast_loss(self, cuda):
        """A TDNN in front of ChainLoss(den, precision="fast") on the
        card: one launch of each fast kernel, a finite loss within the
        JAX package's bfloat16 budget (2e-2) of the float32 loss on the
        CPU from the same weights, finite gradients, an Adam step."""
        fst, P = denominator_fst(num_phones=10, states_per_phone=2, seed=0)
        rng = np.random.RandomState(5)
        seqs = [rng.randint(0, P, size=n) for n in (M_T, M_T - 7, 12)]
        lengths = np.array([len(s) for s in seqs], np.int32)
        x = torch.from_numpy(np.random.RandomState(6).randn(
            M_B, M_T, M_D).astype(np.float32))
        cfg = pm.TDNNConfig(num_pdfs=P, hidden_dim=32, kernel_sizes=(3, 3),
                            dilations=(1, 3), strides=(1, 1), dropout=0.0)
        losses = []
        for dev, precision in ((cuda, "fast"), ("cpu", "parity")):
            nums = pt.ChainGraphBatch(
                [pt.ChainGraph(linear_fst(s), log_domain=True)
                 for s in seqs], max_num_transitions=M_T,
                max_num_states=M_T + 1, device=dev)
            model = pm.TDNN(cfg, M_D, device=dev)
            loss_mod = pt.ChainLoss(pt.ChainGraph(fst), precision=precision,
                                    device=dev)
            opt = torch.optim.Adam(model.parameters(), lr=1e-3)
            fk.reset_launch_counts()
            loss = loss_mod(model(x.to(dev), True), lengths, nums)
            loss.backward()
            assert all(torch.isfinite(p.grad).all()
                       for p in model.parameters())
            opt.step()
            losses.append(float(loss.detach()))
            if dev == cuda:
                assert fk.launched() == {"fact_fwd_bf16": 1,
                                         "fact_bwd_bf16": 1}
        assert np.isfinite(losses[0])
        assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[1])


# ----------------------------------------------------------------------
# The corpus recipe's pieces on the card (examples/train_corpus.py)
# ----------------------------------------------------------------------

def _recipe_corpus(tmp_path):
    from pychain_tpu_torch.examples import train_corpus as tc
    d = str(tmp_path / "corpus")
    tc.make_synthetic_corpus(d, utts=12, num_phones=10, min_t=20, max_t=30)
    return tc, tc.load_corpus(d)


class TestRecipe:
    """The host->device pipeline, the staged corpus, fbank_batch and one
    recipe step on the card against the CPU."""

    def test_cuda_prefetched_batch_equals_its_host_data(self, cuda):
        from pychain_tpu_torch.data import prefetch
        from pychain_tpu_torch.data.prefetch import to_device
        from pychain_tpu_torch.ops.linear import linear_arrays
        rng = np.random.RandomState(0)
        graphs = [pt.ChainGraph(linear_fst(rng.randint(0, 9, size=n)),
                                log_domain=True) for n in (7, 5, 6)]
        items = [(torch.from_numpy(rng.randn(3, 7, 4).astype(np.float32)),
                  linear_arrays(graphs, 8), np.array([7, 5, 6]))
                 for _ in range(6)]
        # the consumer's stream is busy while the copies land
        busy = torch.randn(2048, 2048, device=cuda)
        got = []
        for x, lin, lens in prefetch(iter(items), depth=2,
                                     transfer=to_device(cuda)):
            for _ in range(4):
                busy = busy @ busy / 2048.0
            got.append((x * 1.0, lin.pdf_seq + 0, lens))
        torch.cuda.synchronize()
        assert len(got) == len(items)
        for (x, pdf, lens), (hx, hlin, hlens) in zip(got, items):
            assert x.is_cuda and pdf.is_cuda
            assert torch.equal(x.cpu(), hx)
            assert torch.equal(pdf.cpu(), hlin.pdf_seq)
            np.testing.assert_array_equal(lens, hlens)

    def test_cuda_device_corpus_gather_equals_host_assembly(self, cuda,
                                                            tmp_path):
        from pychain_tpu_torch.data import pad_to_bucket
        from pychain_tpu_torch.loss import dispatch_arrays
        from pychain_tpu_torch.utils.device import host_to
        tc, (keys, feats, nums, den) = _recipe_corpus(tmp_path)
        T = max(f.shape[0] for f in feats)
        K = max(g.num_transitions for g in nums) + 1
        S = max(g.num_states for g in nums) + 1
        x_all, _ = pad_to_bucket(feats, list(range(len(keys))), T)
        staged_x = host_to(torch.from_numpy(x_all), cuda)
        staged = dispatch_arrays(pt.ChainGraphBatch(
            nums, max_num_transitions=K, max_num_states=S, device=cuda))
        idx = np.array([7, 2, 11, 2])
        x_d = staged_x.index_select(0, torch.from_numpy(idx).to(cuda))
        nums_d = staged.take(torch.from_numpy(idx).to(cuda))
        x_h, _ = pad_to_bucket(feats, idx, T)
        nums_h = dispatch_arrays(pt.ChainGraphBatch(
            [nums[i] for i in idx], max_num_transitions=K, max_num_states=S,
            device="cpu"))
        assert torch.equal(x_d.cpu(), torch.from_numpy(x_h))
        for name in ("pdf_seq", "logp_seq", "final", "graph_len"):
            assert torch.equal(getattr(nums_d, name).cpu(),
                               getattr(nums_h, name)), name

    def test_cuda_fbank_batch_matches_cpu(self, cuda):
        from pychain_tpu_torch.data import (add_deltas_batch, cmvn_batch,
                                            fbank_batch)
        x = (np.random.RandomState(3).randn(4, 8000) * 0.2).astype(
            np.float32)
        got = fbank_batch(x, device=cuda)
        ref = fbank_batch(x, device="cpu")
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4)
        lens = np.array([49, 30, 12, 1])
        torch.testing.assert_close(
            add_deltas_batch(cmvn_batch(got, lens, device=cuda),
                             device=cuda).cpu(),
            add_deltas_batch(cmvn_batch(ref, lens, device="cpu"),
                             device="cpu"), rtol=0, atol=1e-4)

    def test_cuda_recipe_step_matches_cpu(self, cuda, no_tf32, tmp_path):
        from pychain_tpu_torch.data import pad_to_bucket
        from pychain_tpu_torch.loss import dispatch_arrays
        from pychain_tpu_torch.utils.optim import ClipAdam
        tc, (keys, feats, nums, den) = _recipe_corpus(tmp_path)
        B, P, D = 4, 20, feats[0].shape[1]
        T = max(f.shape[0] for f in feats)
        x, lens = pad_to_bucket(feats, list(range(B)), T)
        results = []
        for dev in (cuda, torch.device("cpu")):
            model = tc.build_model("tdnn", P, D, device=dev)
            opt = ClipAdam(tc.trainables(model), lr=1e-3, clip=5.0)
            den_g = dispatch_arrays(pt.ChainGraphBatch(den, B, device=dev))
            num_g = dispatch_arrays(pt.ChainGraphBatch(
                nums[:B], max_num_transitions=T + 1, max_num_states=T + 2,
                device=dev))
            fk.reset_launch_counts()
            loss = tc.train_step(model, opt, torch.from_numpy(x).to(dev),
                                 lens, num_g, den_g)
            if dev.type == "cuda":
                assert fk.LAUNCHES["fact_fwd"] == fk.LAUNCHES["fact_bwd"] \
                    == 1
            results.append((float(loss), {k: v.detach().cpu() for k, v in
                                          model.state_dict().items()}))
        (lc, sc), (lh, sh) = results
        assert abs(lc - lh) <= 1e-4 * abs(lh), (lc, lh)
        for k, want in sh.items():
            err = float(torch.linalg.vector_norm(sc[k] - want))
            assert err <= 1e-4 * float(torch.linalg.vector_norm(want)), k


# ----------------------------------------------------------------------
# Shared log-domain graphs (leaky 0) and the generic gather engine
# ----------------------------------------------------------------------

def _dead_batch(dev, tile_dtype=None, B=4, T=9, seed=8):
    """A shared log-domain denominator entered through a chain of 4
    states (no path shorter than 5 frames), x, and lengths whose second
    column (3 frames) is dead."""
    from pychain_tpu_torch.utils.testgraphs import entry_chain_fst
    fst, P = denominator_fst(num_phones=8, states_per_phone=2, seed=4)
    batch = pt.ChainGraphBatch(
        pt.ChainGraph(entry_chain_fst(fst, 4), log_domain=True), B,
        tile_dtype=tile_dtype, device=dev)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, P, generator=g)
    return batch, x, torch.tensor([9, 3, 7, 5][:B])


def _guarded_match(got, ref, live, fast):
    """got (card) and ref (plain) after the log engines' guard: the dead
    column -inf / 0 / not ok, the live ones equal (bit for bit in the
    fast mode, else within 1e-4)."""
    from pychain_tpu_torch.loss import _guard_infeasible
    got, ref = _guard_infeasible(got), _guard_infeasible(ref)
    assert got.objf[1] == float("-inf") and not bool(got.ok[1])
    assert float(got.gamma[1].abs().sum()) == 0.0
    assert bool(got.ok[live].all())
    if fast:
        for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
            assert torch.equal(getattr(got, name)[live].cpu(),
                               getattr(ref, name)[live].cpu()), name
    else:
        _assert_loss_close(
            got._replace(**{n: getattr(got, n)[live].cpu() for n in
                            ("objf", "gamma", "alpha_beta", "gamma_sum")}),
            ref._replace(**{n: getattr(ref, n)[live].cpu() for n in
                            ("objf", "gamma", "alpha_beta", "gamma_sum")}))


class TestLogSemantics:
    """B1/B2 and B3/B4 at leaky 0 on a shared log-domain graph with a dead
    column, against their plain version on the card; the loss on such a
    graph against the CPU."""

    @pytest.mark.parametrize("stream_mode", ["full", "lean", "ckpt"])
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_cuda_b1_b2_at_leaky_zero(self, cuda, tile_dtype, stream_mode):
        batch, x, lens = _dead_batch(cuda, tile_dtype)
        fa = batch._fact
        assert fa.log_semantics and fk.supports(fa)
        px = torch.exp(x).to(cuda)
        got = fk.forward_backward_prob_kernel(px, lens, fa, 0.0,
                                              stream_mode=stream_mode,
                                              ckpt_chunk=4)
        ref = forward_backward_prob_mode(px, lens.to(cuda), fa, 0.0,
                                         stream_mode, 4)
        torch.cuda.synchronize()
        _guarded_match(got, ref, [0, 2, 3], tile_dtype is not None)

    @pytest.mark.parametrize("C", [1, 2])
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_cuda_b3_b4_at_leaky_zero(self, cuda, tile_dtype, C):
        batch, x, lens = _dead_batch(cuda, tile_dtype)
        fa = batch._fact
        px = torch.exp(x).to(cuda)
        got = stk.forward_backward_prob_stream(px, lens, fa, 0.0, cluster=C,
                                               columns=1)
        if tile_dtype:
            ref = forward_backward_prob_fast(px, lens.to(cuda), fa, 0.0,
                                             cluster=C)
        else:
            ref = forward_backward_prob_fact(px, lens.to(cuda), fa, 0.0)
        torch.cuda.synchronize()
        _guarded_match(got, ref, [0, 2, 3], tile_dtype is not None)

    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_cuda_dead_column_is_contained(self, cuda, tile_dtype):
        """Every live column equals the same batch without the dead one,
        bit for bit: no NaN crosses columns."""
        batch, x, lens = _dead_batch(cuda, tile_dtype)
        alone = pt.ChainGraphBatch(batch._graph, 3, tile_dtype=tile_dtype,
                                   device=cuda)
        live = [0, 2, 3]
        a = pt.chain_function_with_aux(x.to(cuda), lens, batch)[1]
        b = pt.chain_function_with_aux(x[live].to(cuda), lens[live],
                                       alone)[1]
        assert a.objf[1] == float("-inf")
        for name in ("objf", "gamma", "ok"):
            assert torch.equal(getattr(a, name)[live], getattr(b, name)), name

    def test_cuda_loss_matches_cpu(self, cuda):
        from pychain_tpu_torch.loss import dispatch_arrays, resolved_engine
        fst, P = denominator_fst(num_phones=12, states_per_phone=2, seed=3)
        lens = torch.tensor([16, 11, 7, 1])
        x = torch.randn(4, 16, P, generator=torch.Generator().manual_seed(5))
        res = []
        for dev in (cuda, torch.device("cpu")):
            batch = pt.ChainGraphBatch(pt.ChainGraph(fst, log_domain=True), 4,
                                       device=dev)
            fa = dispatch_arrays(batch)
            assert fa.log_semantics and resolved_engine(fa) == "pallas"
            fk.reset_launch_counts()
            res.append(pt.chain_function_with_aux(x.to(dev), lens, batch)[1])
            if dev.type == "cuda":
                assert fk.launched() == {"fact_fwd": 1, "fact_bwd": 1}
        _assert_loss_close(*[r._replace(**{n: getattr(r, n).cpu() for n in
                                           ("objf", "gamma", "alpha_beta",
                                            "gamma_sum")}) for r in res])


class TestGather:
    """The generic gather engine on the card: deterministic, equal to the
    kernels on what they serve, equal to the CPU on a prob-domain list."""

    @pytest.mark.parametrize("kind", ["shared prob", "list log",
                                      "list prob"])
    def test_cuda_gather_is_deterministic(self, cuda, kind):
        if kind == "shared prob":
            fst, P = denominator_fst(num_phones=12, states_per_phone=2,
                                     seed=3)
            batch = pt.ChainGraphBatch(pt.ChainGraph(fst), 4, device=cuda)
        else:
            P = 10
            gs = [pt.ChainGraph(random_fst(num_states=6 + b, num_pdfs=P,
                                           seed=b),
                                log_domain=kind == "list log")
                  for b in range(4)]
            batch = pt.ChainGraphBatch(gs, max_num_transitions=max(
                g.num_transitions for g in gs), max_num_states=9,
                device=cuda)
        x = torch.randn(4, 16, P, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
        lens = torch.tensor([16, 11, 7, 1])
        a = pt.chain_function_with_aux(x, lens, batch, impl="gather")[1]
        b = pt.chain_function_with_aux(x, lens, batch, impl="gather")[1]
        torch.cuda.synchronize()
        assert a.gamma.is_cuda
        assert torch.equal(a.gamma, b.gamma) and torch.equal(a.objf, b.objf)

    @pytest.mark.parametrize("log_domain", [False, True])
    def test_cuda_gather_matches_b1_b2(self, cuda, log_domain):
        fst, P = denominator_fst(num_phones=12, states_per_phone=2, seed=3)
        batch = pt.ChainGraphBatch(pt.ChainGraph(fst, log_domain=log_domain),
                                   4, device=cuda)
        x = torch.randn(4, 16, P, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2))
        lens = torch.tensor([16, 11, 7, 1])
        fk.reset_launch_counts()
        k = pt.chain_function_with_aux(x, lens, batch)[1]
        assert fk.launched() == {"fact_fwd": 1, "fact_bwd": 1}
        g = pt.chain_function_with_aux(x, lens, batch, impl="gather")[1]
        assert fk.launched() == {"fact_fwd": 1, "fact_bwd": 1}
        _assert_loss_close(g, k)

    def test_cuda_gather_matches_the_semiring_kernels(self, cuda):
        gs = [pt.ChainGraph(random_fst(num_states=6 + b, num_pdfs=10, seed=b),
                            log_domain=True) for b in range(4)]
        batch = pt.ChainGraphBatch(gs, max_num_transitions=max(
            g.num_transitions for g in gs), max_num_states=9, device=cuda)
        x = torch.randn(4, 16, 10, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(3))
        lens = torch.tensor([16, 11, 7, 1])
        semk.reset_launch_counts()
        k = pt.chain_function_with_aux(x, lens, batch)[1]
        assert semk.LAUNCHES == {"semiring_fwd": 1, "semiring_bwd": 1}
        g = pt.chain_function_with_aux(x, lens, batch, impl="gather")[1]
        torch.testing.assert_close(g.objf, k.objf, rtol=1e-4, atol=0)
        torch.testing.assert_close(g.gamma, k.gamma, rtol=0, atol=1e-4)

    def test_cuda_prob_list_matches_cpu(self, cuda):
        P = 10
        gs = [pt.ChainGraph(random_fst(num_states=5 + 2 * b, num_pdfs=P,
                                       seed=20 + b)) for b in range(4)]
        x = torch.randn(4, 12, P, generator=torch.Generator().manual_seed(4))
        lens = torch.tensor([12, 5, 9, 1])
        res = []
        for dev in (cuda, torch.device("cpu")):
            batch = pt.ChainGraphBatch(gs, max_num_transitions=max(
                g.num_transitions for g in gs), max_num_states=11,
                device=dev)
            res.append(pt.chain_function_with_aux(x.to(dev), lens,
                                                  batch)[1])
        got, ref = res
        torch.testing.assert_close(got.objf.cpu(), ref.objf, rtol=1e-5,
                                   atol=0)
        torch.testing.assert_close(got.gamma.cpu(), ref.gamma, rtol=0,
                                   atol=1e-5)

    def test_cuda_viterbi_of_graph_arrays(self, cuda):
        from pychain_tpu_torch.loss import graph_arrays
        topo = ChainTopology(num_phones=4)
        gs = [pt.ChainGraph(make_numerator_fst(p, topo), log_domain=True)
              for p in ([1, 3, 0], [2, 2, 1, 0], [3, 0])]
        batch = pt.ChainGraphBatch(gs, max_num_transitions=max(
            g.num_transitions for g in gs), max_num_states=max(
            g.num_states for g in gs), device=cuda)
        x = torch.randn(3, 9, 8, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(6))
        lens = [9, 8, 5]
        vk.reset_launch_counts()
        a = pt.viterbi_align(x, lens, graph_arrays(batch))
        b = pt.viterbi_align(x, lens, batch)
        assert vk.LAUNCHES["viterbi"] == 2
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name


# ----------------------------------------------------------------------
# The dense list engine (ops/dense_list.py), impl="leveled" and data
# parallelism (parallel/) on the card
# ----------------------------------------------------------------------

def _prob_list(kind, dev):
    if kind == "den":
        fsts = [denominator_fst(num_phones=6 + b, states_per_phone=2,
                                seed=b)[0] for b in range(4)]
    else:    # random graphs: residual arcs
        fsts = [random_fst(num_states=7 + b, num_pdfs=6,
                           max_arcs_per_state=4, seed=3 + b)
                for b in range(4)]
    gs = [pt.ChainGraph(f) for f in fsts]
    P = max(g.num_pdfs for g in gs)
    return gs, P, pt.ChainGraphBatch(
        gs, max_num_transitions=max(g.num_transitions for g in gs),
        max_num_states=max(g.num_states for g in gs), device=dev)


class TestDenseList:
    """impl="dense_list" on the card: equal to the gather engine and to
    the CPU, gamma bit-identical on a rerun, taken by auto."""

    @pytest.mark.parametrize("kind", ["den", "residual"])
    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_cuda_dense_list_matches_gather_and_cpu(self, cuda, kind,
                                                    tile_dtype):
        from pychain_tpu_torch.ops.dense_list import DenseListArrays
        gs, P, batch = _prob_list(kind, cuda)
        if tile_dtype:
            batch = pt.ChainGraphBatch(
                gs, max_num_transitions=batch.num_transitions,
                max_num_states=batch.num_states, tile_dtype=tile_dtype,
                device=cuda)
        x = torch.randn(4, 14, P, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(7))
        lens = torch.tensor([14, 9, 5, 1])
        a = pt.chain_function_with_aux(x, lens, batch)[1]
        assert isinstance(batch._dense_list, DenseListArrays)
        b = pt.chain_function_with_aux(x, lens, batch)[1]
        torch.cuda.synchronize()
        assert torch.equal(a.gamma, b.gamma) and torch.equal(a.objf, b.objf)
        if tile_dtype is None:
            g = pt.chain_function_with_aux(x, lens, batch, impl="gather")[1]
            _assert_loss_close(a, g)
        cpu = pt.ChainGraphBatch(
            gs, max_num_transitions=batch.num_transitions,
            max_num_states=batch.num_states, tile_dtype=tile_dtype,
            device="cpu")
        c = pt.chain_function_with_aux(x.cpu(), lens, cpu,
                                       impl="dense_list")[1]
        torch.testing.assert_close(a.objf.cpu(), c.objf, rtol=1e-5, atol=0)
        torch.testing.assert_close(a.gamma.cpu(), c.gamma, rtol=0,
                                   atol=1e-5)

    def test_cuda_dense_list_keeps_ieee_float32(self, cuda):
        """TF32 on for the caller: the engine's products stay IEEE
        float32, and the caller's setting is restored."""
        gs, P, batch = _prob_list("den", cuda)
        x = torch.randn(4, 14, P, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(8))
        lens = torch.tensor([14, 9, 5, 1])
        ref = pt.chain_function_with_aux(x, lens, batch)[1]
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = pt.chain_function_with_aux(x, lens, batch)[1]
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        assert torch.equal(got.gamma, ref.gamma)


def _leveled_batch(kind, dev):
    from pychain_tpu_torch.graphs.builder import make_constrained_numerator
    from pychain_tpu_torch.utils.testgraphs import sausage_fst
    rng = np.random.RandomState(5)
    if kind == "sausage":
        lens = [12, 9, 12, 4]
        fsts = [sausage_fst([list(rng.choice(10, size=rng.randint(1, 4),
                                             replace=False))
                             for _ in range(n)], seed=b)
                for b, n in enumerate(lens)]
        P = 10
    else:
        topo = ChainTopology(num_phones=6)
        fsts, lens = [], []
        for b in range(4):
            n = 3 + b
            durs = [int(d) for d in rng.randint(2, 5, size=n)]
            fsts.append(make_constrained_numerator(
                [int(p) for p in rng.randint(0, 6, size=n)], durs, topo,
                tolerance=3))
            lens.append(sum(durs))
        P = topo.num_pdfs
    gs = [pt.ChainGraph(f, log_domain=True) for f in fsts]
    return gs, P, lens, pt.ChainGraphBatch(
        gs, max_num_transitions=max(g.num_transitions for g in gs),
        max_num_states=max(g.num_states for g in gs), device=dev)


class TestLeveled:
    """impl="leveled" (the JAX package's banded engine) is auto in the
    port: on the card the semiring kernels, one launch of each a call,
    auto's bits, equal to the CPU, gamma bit-identical on a rerun."""

    @pytest.mark.parametrize("kind", ["sausage", "constrained"])
    def test_cuda_leveled_matches_the_semiring_kernels(self, cuda, kind):
        gs, P, lens, batch = _leveled_batch(kind, cuda)
        x = torch.randn(4, max(lens), P, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(9))
        lens = torch.tensor(lens)
        semk.reset_launch_counts()
        k = pt.chain_function_with_aux(x, lens, batch)[1]
        assert semk.LAUNCHES == {"semiring_fwd": 1, "semiring_bwd": 1}
        a = pt.chain_function_with_aux(x, lens, batch, impl="leveled")[1]
        b = pt.chain_function_with_aux(x, lens, batch, impl="leveled")[1]
        torch.cuda.synchronize()
        assert semk.LAUNCHES == {"semiring_fwd": 3, "semiring_bwd": 3}
        assert torch.equal(a.gamma, b.gamma) and torch.equal(a.objf, b.objf)
        assert torch.equal(a.gamma, k.gamma) and torch.equal(a.objf, k.objf)
        assert bool(a.ok.all())
        cpu = pt.ChainGraphBatch(gs, max_num_transitions=batch.num_transitions,
                                 max_num_states=batch.num_states, device="cpu")
        c = pt.chain_function_with_aux(x.cpu(), lens, cpu, impl="leveled")[1]
        torch.testing.assert_close(a.objf.cpu(), c.objf, rtol=1e-5, atol=0)
        torch.testing.assert_close(a.gamma.cpu(), c.gamma, rtol=0,
                                   atol=1e-5)


class TestParallel:
    """ShardedChainLoss in a group of one rank over NCCL: the same kernels
    at the same batch, so ChainLoss's value and gradient bit for bit."""

    @pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
    def test_cuda_sharded_loss_world_one_nccl(self, cuda, tile_dtype):
        from pychain_tpu_torch import parallel
        assert not torch.distributed.is_initialized()
        try:
            mesh = parallel.make_mesh()
            assert torch.distributed.get_backend() == "nccl"
            fst, P = denominator_fst(num_phones=12, states_per_phone=2,
                                     seed=3)
            den = pt.ChainGraph(fst)
            rng = np.random.RandomState(0)
            nums = pt.ChainGraphBatch(
                [pt.ChainGraph(linear_fst(rng.randint(0, P, size=16)),
                               log_domain=True) for _ in range(4)],
                max_num_transitions=16, max_num_states=17, device=cuda)
            x = torch.randn(4, 16, P, device=cuda, generator=torch.Generator(
                device=cuda).manual_seed(10))
            lens = torch.full((4,), 16)
            grads = []
            for loss in (parallel.ShardedChainLoss(mesh, den,
                                                   tile_dtype=tile_dtype),
                         pt.ChainLoss(den, tile_dtype=tile_dtype)):
                xt = x.clone().requires_grad_(True)
                fk.reset_launch_counts()
                v = loss(xt, lens, nums)
                v.backward()
                grads.append((v.detach(), xt.grad, fk.launched()))
            (v1, g1, n1), (v2, g2, n2) = grads
            assert torch.equal(v1, v2) and torch.equal(g1, g2)
            assert n1 == n2 and sum(n1.values()) == 2
        finally:
            torch.distributed.destroy_process_group()


# ----------------------------------------------------------------------
# The XL roofline probe's kernels (tools/xl_roofline.py)
# ----------------------------------------------------------------------

XL_TOL = {"vpu": 1e-5, "mxu_f32": 1e-5, "mxu_bf16": 5e-3}
# (S, K, T, B): K not a multiple of 16, S not of 8; "hub": a state of 40
# in-arcs, a run longer than xl_vpu's register slots
XL_CASES = {"s64": (64, 192, 16, 2), "s100": (100, 250, 12, 3),
            "s37": (37, 45, 5, 2), "hub": (50, 170, 9, 2)}


def _xl_case(name, dev):
    """(src, dst, w, S, T) on dev; state 0 has no in-arc."""
    S, K, T, B = XL_CASES[name]
    rng = np.random.RandomState(S)
    src = rng.randint(0, S, (B, K)).astype(np.int32)
    dst = rng.randint(0, S, (B, K)).astype(np.int32)
    if name == "hub":
        dst[0, :40] = 5
    dst[dst == 0] = 1
    w = rng.rand(K).astype(np.float32) + 0.1
    return (*(torch.from_numpy(a).to(dev) for a in (src, dst, w)), S, T)


class TestXlRoofline:

    @pytest.mark.cuda
    @pytest.mark.parametrize("form", ["vpu", "mxu_f32", "mxu_bf16"])
    @pytest.mark.parametrize("name", sorted(XL_CASES))
    def test_kernel_matches_plain(self, cuda, name, form):
        src, dst, w, S, T = _xl_case(name, cuda)
        xr.reset_launch_counts()
        got = xr.RUNNERS[form](src, dst, w, S, T)
        assert xr.LAUNCHES[xr.KERNELS[form]] == 1
        assert sum(xr.LAUNCHES.values()) == 1
        ref = xr.plain(form, src, dst, w, S, T)
        assert got.shape == (src.shape[0], S)
        assert bool(torch.isfinite(got).all())
        assert xr.rel_diff(got, ref) <= XL_TOL[form]
        assert bool((got[:, 0] == 0).all())          # no in-arc
        assert torch.equal(xr.RUNNERS[form](src, dst, w, S, T), got)

    @pytest.mark.cuda
    @pytest.mark.parametrize("warps", [1, 2, 4, 8, 16])
    @pytest.mark.parametrize("name", ["s100", "hub"])
    def test_vpu_at_every_warp_count(self, cuda, monkeypatch, name, warps):
        """Register slots or shared memory, each count of compute warps a
        row that vpu_warps gives: the same CSR sums and a float64 sum b,
        so the bits of the count that K selects."""
        src, dst, w, S, T = _xl_case(name, cuda)
        want = xr.xl_vpu(src, dst, w, S, T)
        monkeypatch.setattr(xr, "vpu_warps", lambda K: warps)
        plan = xr.vpu_plan(src, dst, w, S)
        assert plan.threads == 32 * warps
        got = xr.vpu_kernel(plan, S, T)
        assert torch.equal(got, want)
        assert xr.rel_diff(got, xr.plain("vpu", src, dst, w, S, T)) <= 1e-5
