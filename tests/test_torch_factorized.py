"""The port's factorized denominator engine against the JAX package.

The port's plain PyTorch forward-backward (ops/factorized.py) is held
against the JAX package's XLA factorized engine and its Pallas kernels
(interpret mode on the CPU), on the same numpy inputs.  Tolerances are
float32's: objf relative <= 1e-5, gamma and traces max-abs <= 1e-5.

The CUDA kernels cannot run here; what surrounds them can.  A step-for-
step emulation of the two kernels in PyTorch, on the KernelGraph the
kernels read (CSR rows, pdf -> states lists), must match the plain
version, and the kernel wrapper must take the plain path for CPU
tensors without counting a launch.  tests/test_torch_card.py compares
the kernels themselves with the plain version on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.loss import chain_function_with_aux as j_aux
from pychain_tpu.utils.testgraphs import denominator_fst, random_fst

import pychain_tpu_torch as pt
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.ops.factorized import (forward_backward_prob_fact,
                                              px_time_major)

LEAKY = 1e-5
MODES = [("source", "identity"), ("cross", "matrix"),
         ("separate", "stream")]


def _case(mode, B=4, T=9, seed=0, num_phones=10):
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=mode)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, P).astype(np.float32)
    lengths = np.array([T, T - 2, 3, 1][:B], np.int32)
    return fst, x, lengths


def _port_fact(fst, B):
    return pt.ChainGraphBatch(pt.ChainGraph(fst), B, device="cpu")._fact


def _assert_close(got, ref, objf_rtol=1e-5, atol=1e-5):
    ref_objf = np.asarray(ref.objf)
    np.testing.assert_allclose(got.objf.numpy(), ref_objf, rtol=objf_rtol,
                               atol=0)
    for name in ("gamma", "alpha_beta", "gamma_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=atol, err_msg=name)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))


@pytest.mark.parametrize("mode,want", MODES)
def test_plain_matches_jax_factorized(mode, want):
    fst, x, lengths = _case(mode)
    B = x.shape[0]
    jbatch = JChainGraphBatch(JChainGraph(fst), B)
    _, ref = j_aux(jnp.asarray(x), lengths, jbatch, impl="factorized")
    fa = _port_fact(fst, B)
    assert fa.xsrc_mode == want
    got = forward_backward_prob_fact(
        torch.exp(torch.clamp(torch.from_numpy(x), -30, 30)),
        torch.from_numpy(lengths), fa, LEAKY)
    _assert_close(got, ref)


@pytest.mark.parametrize("mode", ["source", "separate"])
def test_plain_matches_jax_pallas_interpret(mode):
    """The Pallas kernels in float32 tiles, run in interpret mode."""
    fst, x, lengths = _case(mode, B=3, T=6, seed=7, num_phones=9)
    lengths = np.array([6, 4, 2], np.int32)
    jbatch = JChainGraphBatch(JChainGraph(fst), 3)
    _, ref = j_aux(jnp.asarray(x), lengths, jbatch, impl="pallas")
    got = forward_backward_prob_fact(
        torch.exp(torch.from_numpy(x)), torch.from_numpy(lengths),
        _port_fact(fst, 3), LEAKY)
    _assert_close(got, ref)


def test_plain_residual_arcs_match_jax():
    """A random graph leaves residual arcs for the gather path."""
    fst = random_fst(num_states=9, num_pdfs=6, max_arcs_per_state=4,
                     seed=3)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 6).astype(np.float32)
    lengths = np.array([5, 3], np.int32)
    jbatch = JChainGraphBatch(JChainGraph(fst), 2)
    _, ref = j_aux(jnp.asarray(x), lengths, jbatch, impl="factorized")
    fa = _port_fact(fst, 2)
    assert fa.res_src.shape[0] > 0
    got = forward_backward_prob_fact(torch.exp(torch.from_numpy(x)),
                                     torch.from_numpy(lengths), fa, LEAKY)
    _assert_close(got, ref)
    with pytest.raises(ValueError, match="fully factorized"):
        fk.forward_backward_prob_kernel(torch.exp(torch.from_numpy(x)),
                                        torch.from_numpy(lengths), fa)


@pytest.mark.parametrize("debug", [True, False])
def test_kernel_wrapper_cpu_takes_plain_path(debug):
    fst, x, lengths = _case("source")
    fa = _port_fact(fst, x.shape[0])
    px = torch.exp(torch.from_numpy(x))
    lens = torch.from_numpy(lengths)
    fk.reset_launch_counts()
    got = fk.forward_backward_prob_kernel(px, lens, fa, LEAKY, debug=debug)
    assert fk.LAUNCHES == {"fact_fwd": 0, "fact_bwd": 0}
    ref = forward_backward_prob_fact(px, lens, fa, LEAKY)
    torch.testing.assert_close(got.objf, ref.objf, rtol=0, atol=0)
    torch.testing.assert_close(got.gamma, ref.gamma, rtol=0, atol=0)
    if debug:
        torch.testing.assert_close(got.alpha_beta, ref.alpha_beta)
        report = pt.check_result(got, lens)
        assert report.all_ok and report.max_alpha_beta_err < 1e-4
    else:
        # frame 0 as computed, exactly 1.0 elsewhere
        torch.testing.assert_close(got.alpha_beta[:, 0],
                                   ref.alpha_beta[:, 0])
        assert bool((got.alpha_beta[:, 1:] == 1.0).all())
        assert bool((got.gamma_sum[:, 1:] == 1.0).all())


# ----------------------------------------------------------------------
# Emulation of the CUDA kernels' algorithm on the KernelGraph
# ----------------------------------------------------------------------

def _csr_mv(sell, v):
    """A sliced-ELL operator (fact_kernels._sell) times v."""
    sptr, col, val = sell
    n_rows = (len(sptr) - 1) * fk.SLICE
    slen = (sptr[1:] - sptr[:-1]).long()
    entries = torch.arange(len(col))
    row = (torch.repeat_interleave(torch.arange(len(slen)), slen * fk.SLICE)
           * fk.SLICE + entries % fk.SLICE)
    return torch.zeros(n_rows).index_add_(0, row, val * v[col.long()])


def _lists_sum(lists, c, n):
    ptr, states = (t.long() for t in lists)
    rows = torch.repeat_interleave(torch.arange(n), ptr[1:] - ptr[:-1])
    return torch.zeros(n).index_add_(0, rows, c[states])


def _emulate(px, lengths, fa, c, debug, resident=False):
    """csrc/fact_fwd.cu and csrc/fact_bwd.cu, one column at a time, on
    the ascending operators or (``resident``) on the operators B1/B2
    read."""
    kg = fk.kernel_graph(fa)
    w1, w2, w1t, w2t = (kg.resident if resident
                        else (kg.w1, kg.w2, kg.w1t, kg.w2t))
    B, T, P = px.shape
    s_pad = fa.s_pad
    f = kg.f_dst.long()
    g = None if kg.g_src is None else kg.g_src.long()
    s0 = fa.initial.sum()
    ad0 = fa.initial + c * s0 * fa.leaky
    s_ys = torch.ones(B, T)
    ad_last = torch.zeros(B, s_pad)
    streams = torch.zeros(4, B, T, s_pad)   # ad, w1ad, xdst, xsrc
    for b in range(B):
        ad, s_prev = ad0.clone(), s0
        for t in range(int(lengths[b])):
            x = px[b, t, f]
            xs = x if g is None else px[b, t, g]
            w1a = _csr_mv(w1, ad)
            a = (x * w1a + _csr_mv(w2, xs * ad)) / s_prev
            s_t = a.sum()
            ad = a + c * s_t * fa.leaky
            streams[:, b, t] = torch.stack([ad, w1a, x, xs])
            s_ys[b, t] = s_t
            s_prev = s_t
        ad_last[b] = ad
    objf, tot = fk._objf(s_ys, ad_last, lengths, fa, s0.reshape(1))

    gamma = torch.zeros(B, T, P)
    ab = torch.full((B, T), 0.0 if debug else 1.0)
    gs = ab.clone()
    for b in range(B):
        Tb = int(lengths[b])
        bd = fa.final / tot[b]
        for u in range(Tb - 1, -1, -1):
            s_u = s0 if u == 0 else s_ys[b, u - 1]
            ad_u = ad0 if u == 0 else streams[0, b, u - 1]
            _, w1ad, xd, xs = streams[:, b, u]
            bn = bd + c * (bd * fa.leaky).sum()
            xb = xd * bn
            sw = xs * _csr_mv(w2t, bn)
            bd = (_csr_mv(w1t, xb) + sw) / s_u
            m1 = xb * w1ad / s_u
            m2 = sw * ad_u / s_u
            if g is None:
                gp = _lists_sum(kg.f_lists, m1 + m2, kg.n_pdf_lists)
            else:
                gp = (_lists_sum(kg.f_lists, m1, kg.n_pdf_lists)
                      + _lists_sum(kg.g_lists, m2, kg.n_pdf_lists))
            gamma[b, u, :min(P, kg.n_pdf_lists)] = gp[:P]
            if debug or u == 0:
                ab[b, u] = (ad_u * bd).sum()
                gs[b, u] = gamma[b, u].sum()
            else:
                ab[b, u] = gs[b, u] = 1.0
    return objf, gamma, ab, gs


@pytest.mark.parametrize("mode,want", MODES)
def test_kernel_algorithm_emulation_matches_plain(mode, want):
    fst, x, lengths = _case(mode, seed=2)
    fa = _port_fact(fst, x.shape[0])
    assert fa.xsrc_mode == want
    px = torch.exp(torch.from_numpy(x))
    lens = torch.from_numpy(lengths)
    ref = forward_backward_prob_fact(px, lens, fa, LEAKY)
    objf, gamma, ab, gs = _emulate(px, lens, fa, LEAKY, debug=True)
    torch.testing.assert_close(objf, ref.objf, rtol=1e-5, atol=0)
    torch.testing.assert_close(gamma, ref.gamma, rtol=0, atol=1e-5)
    torch.testing.assert_close(ab, ref.alpha_beta, rtol=0, atol=1e-5)
    torch.testing.assert_close(gs, ref.gamma_sum, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode,want", MODES)
def test_kernel_algorithm_emulation_on_resident_operators(mode, want):
    """The emulation on B1/B2's operators (each row's entries in bank
    order) matches the plain version as the ascending ones do."""
    fst, x, lengths = _case(mode, seed=2, num_phones=40)
    fa = _port_fact(fst, x.shape[0])
    assert fa.xsrc_mode == want
    px = torch.exp(torch.from_numpy(x))
    lens = torch.from_numpy(lengths)
    ref = forward_backward_prob_fact(px, lens, fa, LEAKY)
    objf, gamma, ab, gs = _emulate(px, lens, fa, LEAKY, debug=True,
                                   resident=True)
    torch.testing.assert_close(objf, ref.objf, rtol=1e-5, atol=0)
    torch.testing.assert_close(gamma, ref.gamma, rtol=0, atol=1e-5)
    torch.testing.assert_close(ab, ref.alpha_beta, rtol=0, atol=1e-5)
    torch.testing.assert_close(gs, ref.gamma_sum, rtol=0, atol=1e-5)


def test_kernel_graph_csr_equals_stratified_parts():
    """Each CSR operator is the stratified matrix it came from."""
    from pychain_tpu_torch.ops.factorized import _apply_w
    fst, _, _ = _case("cross", seed=4)
    fa = _port_fact(fst, 2)
    kg = fk.kernel_graph(fa)
    v = torch.from_numpy(np.random.RandomState(4).rand(
        fa.s_pad).astype(np.float32))
    for csr, w in ((kg.w1, fa.w1), (kg.w2, fa.w2), (kg.w1t, fa.w1t),
                   (kg.w2t, fa.w2t)):
        torch.testing.assert_close(_csr_mv(csr, v),
                                   _apply_w(w, v[:, None])[:, 0],
                                   rtol=1e-6, atol=1e-7)
    c = v
    want = _apply_w(fa.e_ft, c[:, None])[:, 0]
    torch.testing.assert_close(_lists_sum(kg.f_lists, c, kg.n_pdf_lists),
                               want, rtol=1e-6, atol=1e-7)
    # each row's entries in ascending column order (a fixed sum order),
    # then zero padding
    sptr, col, val = kg.w1t
    for r in range(fa.s_pad):
        i, lane = divmod(r, fk.SLICE)
        idx = torch.arange(int(sptr[i]), int(sptr[i + 1])) * fk.SLICE + lane
        nz = val[idx] != 0
        seg = col[idx][nz]
        assert bool((seg[1:] > seg[:-1]).all())
        assert bool((col[idx][~nz] == 0).all())
        assert bool(nz.cummin(0).values.eq(nz).all())   # padding last


def test_stream_mode_and_shared_memory_sizing():
    # the headline size: 3 f32 streams of (500, 3072, 128) fit "full"
    assert fk.select_stream_mode(500, 3072, 128, 4, 3) == "full"
    assert fk.select_stream_mode(1500, 3072, 128, 4, 3) == "lean"
    assert fk.select_stream_mode(3700, 3072, 128, 4, 3) == "ckpt"
    fa = _port_fact(denominator_fst(num_phones=10, seed=0)[0], 2)
    sm = fk.smem_bytes(fa)
    assert sm["fact_fwd"] == (4 * fa.s_pad + 33) * 4
    assert fk.fits_on_chip(fa)
