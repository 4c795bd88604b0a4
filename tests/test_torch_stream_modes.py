"""The lean and ckpt stream modes of B1/B2 (``ops/fact_kernels.py``) on the CPU.

The JAX package's ``forward_backward_prob_pallas(..., stream_mode=...)``
keeps the fwd->bwd streams whole ("full"), keeps the alpha' stream alone
and recomputes the rest in the backward kernel ("lean"), or keeps alpha'
at each chunk's last frame and replays each chunk before its backward
("ckpt").  The port's plain versions of the three
(``factorized.forward_backward_prob_mode``) are held here to those Pallas
kernels in interpret mode on the same numpy inputs, at the JAX tests'
own sizes and cases (tests/test_pallas.py:131-274):

* float32: the ckpt mode equals the port's full mode bit for bit (the
  same arithmetic from the same carries), the lean mode is the full mode
  (objf within 1e-6 and gamma within 1e-5, the JAX test's bars for lean
  against full); against JAX the port's float32 bars of
  tests/test_torch_factorized.py (objf 1e-5 relative, gamma and traces
  1e-5 absolute: sums in other orders; at the lean case's objf of -0.128
  the two lie 2.4e-7 apart, 1.9e-6 relative);
* the fast mode (bfloat16 tiles): test_torch_fast.py's bars, 1e-5; each
  mode rounds in its own places (lean: W1 alpha' not rounded; ckpt: each
  replay from a bfloat16 snapshot), so neither equals the fast full mode.

The CUDA kernels cannot run here.  The host code that drives them on the
card (``fact_kernels._lean``, ``_ckpt``: the snapshot rows, each chunk's
entry, the stream buffers, the beta' carry) runs on emulations of the
kernels (``_emu_fwd``, ``_emu_bwd``: one column at a time, each kernel's
frame range, rows, injection and carry, its sums in its order) put in
place of the launches; in the fast mode they give the plain version's
numbers bit for bit.  tests/test_torch_card.py holds the kernels
themselves to the plain version on the card.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
import pychain_tpu.ops.pallas_fact as jpf

import pychain_tpu_torch as pt
from pychain_tpu_torch.ops import factorized as pf
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.utils.testgraphs import denominator_fst

LEAKY = 1e-5
MODES = [("source", "identity"), ("cross", "matrix"),
         ("separate", "stream")]


def _case(num_phones, seed, fwd_mode, B, T, lengths, tile_dtype=None):
    """A denominator and exp'd clamped x made with numpy: the JAX batch's
    FactorizedArrays, the port's (CPU), px and lengths."""
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=fwd_mode)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, P).astype(np.float32)
    px = np.exp(np.clip(x, -30, 30))
    jfa = JChainGraphBatch(JChainGraph(fst, log_domain=False), B,
                           tile_dtype=tile_dtype)._fact
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), B, tile_dtype=tile_dtype,
                            device="cpu")._fact
    return jfa, fa, px, np.asarray(lengths, np.int32)


def _jax(jfa, px, lengths, **kw):
    return jpf.forward_backward_prob_pallas(
        jnp.asarray(px), jnp.asarray(lengths), jfa, **kw)


def _port(fa, px, lengths, stream_mode, ckpt_chunk=None):
    return pf.forward_backward_prob_mode(
        torch.from_numpy(px), torch.from_numpy(lengths), fa, LEAKY,
        stream_mode, ckpt_chunk)


def _assert_near_jax(got, ref, objf_rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(got.objf.numpy(), np.asarray(ref.objf),
                               rtol=objf_rtol, atol=0)
    for name in ("gamma", "alpha_beta", "gamma_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=atol, err_msg=name)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))


def _assert_equal(got, ref):
    for name in ("objf", "gamma", "alpha_beta", "gamma_sum", "ok"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


# ----------------------------------------------------------------------
# The plain versions against the Pallas kernels in interpret mode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fwd_mode", ["source", "separate"])
def test_plain_lean_matches_jax_lean(fwd_mode):
    """tests/test_pallas.py's lean case (denominator_fst(8, 2), B=3, T=6,
    lengths 6, 4, 2), float32 tiles."""
    jfa, fa, px, lengths = _case(8, 11, fwd_mode, 3, 6, [6, 4, 2])
    got = _port(fa, px, lengths, "lean")
    full = _port(fa, px, lengths, "full")
    np.testing.assert_allclose(got.objf.numpy(), full.objf.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(got.gamma.numpy(), full.gamma.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert bool(got.ok.all())
    _assert_near_jax(got, _jax(jfa, px, lengths, stream_mode="lean"))


@pytest.mark.parametrize("fwd_mode", ["source", "cross", "separate"])
def test_plain_ckpt_matches_jax_ckpt(fwd_mode):
    """tests/test_pallas.py's ckpt case (denominator_fst(9, 2), B=3, T=11,
    lengths 11, 7, 2) at C = 4 (T not a multiple), 64 (one chunk) and the
    default: bit-identical to the port's full mode, near JAX's ckpt."""
    jfa, fa, px, lengths = _case(9, 7, fwd_mode, 3, 11, [11, 7, 2])
    full = _port(fa, px, lengths, "full")
    for chunk in (4, 64, None):
        got = _port(fa, px, lengths, "ckpt", chunk)
        _assert_equal(got, full)
        _assert_near_jax(got, _jax(jfa, px, lengths, stream_mode="ckpt",
                                   ckpt_chunk=chunk))


@pytest.mark.parametrize("stream_mode", ["lean", "ckpt"])
@pytest.mark.parametrize("fwd_mode,want", MODES)
def test_plain_fast_modes_match_jax_bf16(fwd_mode, want, stream_mode):
    """tests/test_pallas.py's bfloat16 ckpt case (denominator_fst(8, 2),
    B=2, T=9, lengths 9, 5; C=4 and the default), and the lean mode on it:
    test_torch_fast.py's bars; gamma holds bfloat16 values and differs
    from the fast full mode's (each mode's own rounding points)."""
    jfa, fa, px, lengths = _case(8, 3, fwd_mode, 2, 9, [9, 5],
                                 tile_dtype="bfloat16")
    assert fa.xsrc_mode == want and pf.is_fast(fa)
    full = _port(fa, px, lengths, "full")
    for chunk in ((4, None) if stream_mode == "ckpt" else (None,)):
        got = _port(fa, px, lengths, stream_mode, chunk)
        ref = _jax(jfa, px, lengths, stream_mode=stream_mode,
                   ckpt_chunk=chunk)
        _assert_near_jax(got, ref)
        assert torch.equal(got.gamma.bfloat16().float(), got.gamma)
        assert not torch.equal(got.gamma, full.gamma)
        assert bool(got.ok.all())


# ----------------------------------------------------------------------
# The wrapper on the CPU: modes, "auto" and errors
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_wrapper_takes_each_modes_plain_version(tile_dtype):
    """forward_backward_prob_kernel on CPU tensors: each stream mode's
    plain version, no launch, debug=False's frame-0 traces."""
    _, fa, px, lengths = _case(10, 4, "cross", 3, 10, [10, 7, 1],
                               tile_dtype=tile_dtype)
    px_t, lens = torch.from_numpy(px), torch.from_numpy(lengths)
    fk.reset_launch_counts()
    for mode, chunk in (("full", None), ("lean", None), ("ckpt", 3),
                        ("ckpt", None)):
        want = pf.forward_backward_prob_mode(px_t, lens, fa, LEAKY, mode,
                                             chunk)
        for debug in (True, False):
            got = fk.forward_backward_prob_kernel(
                px_t, lens, fa, LEAKY, debug=debug, stream_mode=mode,
                ckpt_chunk=chunk)
            _assert_equal(got, want if debug else fk._frame0_traces(want))
    assert fk.launched() == {}


@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_auto_reaches_lean_and_ckpt_under_a_stubbed_budget(monkeypatch,
                                                           tile_dtype):
    """tests/test_pallas.py's auto case (denominator_fst(8, 2), B=2,
    T=10, lengths 10, 6): the budget of one stream gives "lean", a budget
    of 1 byte "ckpt", in the port as in JAX (both budgets stubbed)."""
    jfa, fa, px, lengths = _case(8, 5, "source", 2, 10, [10, 6],
                                 tile_dtype=tile_dtype)
    px_t, lens = torch.from_numpy(px), torch.from_numpy(lengths)
    seen = []
    real = fk.forward_backward_prob_mode

    def spy(px, lengths, fa, c, mode, chunk):
        seen.append(mode)
        return real(px, lengths, fa, c, mode, chunk)

    monkeypatch.setattr(fk, "forward_backward_prob_mode", spy)
    item = 2 if tile_dtype else 4
    row = 10 * fa.s_pad * 2 * item
    for budget, want in ((fk.STREAM_BUDGET, "full"), (row, "lean"),
                         (1, "ckpt")):
        monkeypatch.setattr(fk, "STREAM_BUDGET", budget)
        monkeypatch.setattr(jpf, "STREAM_BUDGET", budget)
        monkeypatch.setattr(jpf, "LEAN_BUDGET", budget)
        got = fk.forward_backward_prob_kernel(px_t, lens, fa, LEAKY)
        assert seen[-1] == want
        _assert_equal(got, real(px_t, lens, fa, LEAKY, want, None))
        _assert_near_jax(got, _jax(jfa, px, lengths))


def test_stream_mode_errors():
    """forward_backward_prob_pallas's ValueErrors (pallas_fact.py:862-865,
    880-881): an unknown mode, a ckpt_chunk that is no positive int."""
    _, fa, px, lengths = _case(8, 5, "source", 2, 10, [10, 6])
    px_t, lens = torch.from_numpy(px), torch.from_numpy(lengths)
    with pytest.raises(ValueError, match="stream_mode"):
        fk.forward_backward_prob_kernel(px_t, lens, fa, LEAKY,
                                        stream_mode="bogus")
    for chunk in (-4, 0, 2.5, "8"):
        with pytest.raises(ValueError, match="ckpt_chunk"):
            fk.forward_backward_prob_kernel(px_t, lens, fa, LEAKY,
                                            stream_mode="ckpt",
                                            ckpt_chunk=chunk)


@pytest.mark.parametrize("T,want", [(3700, 64), (11, 8), (4, 4), (64, 8),
                                    (80, 8), (81, 16), (10000, 104)])
def test_default_chunk(T, want):
    """C = max(8, 8 ceil(floor(sqrt(T)) / 8)), at most T
    (pallas_fact.py:952-954); bench.py --long --big's T gives 64: 58
    chunks."""
    assert fk.ckpt_chunk_length(T) == want
    assert fk.ckpt_chunk_length(T, 5) == min(5, T)
    assert -(-3700 // fk.ckpt_chunk_length(3700)) == 58


def _shape(s_pad, mode, fast=False):
    dt = torch.bfloat16 if fast else torch.float32
    return types.SimpleNamespace(s_pad=s_pad, xsrc_mode=mode,
                                 w1=types.SimpleNamespace(operand_dtype=dt))


def test_auto_on_the_card_takes_ckpt_where_lean_does_not_fit():
    """bench.py --long --big's sizes: three bfloat16 streams of (3700,
    3072, 64) take 4.36 GB; under 4 GiB "auto" gives "lean", and on the
    card a graph past fact_bwd_lean's limit gets "ckpt"."""
    assert 3 * 3700 * 3072 * 64 * 2 == 4_364_697_600
    head = _shape(3072, "identity", fast=True)
    assert fk.resolve_stream_mode(3700, 64, head) == "lean"
    assert fk.resolve_stream_mode(3700, 64, head, on_card=True) == "lean"
    assert fk.resolve_stream_mode(3700, 64, head,
                                  budget=int(80e9 * 0.4)) == "full"
    big = _shape(9728, "identity")
    assert not fk.fits_on_chip(big, lean=True) and fk.fits_on_chip(big)
    assert fk.resolve_stream_mode(1000, 64, big) == "lean"
    assert fk.resolve_stream_mode(1000, 64, big, on_card=True) == "ckpt"
    assert fk.resolve_stream_mode(1000, 64, big, stream_mode="lean",
                                  on_card=True) == "lean"


@pytest.mark.parametrize("s_pad,mode,fast,stages", [
    (3072, "identity", False, 2),      # the headline graph
    (3072, "identity", True, 2),
    (7168, "identity", False, 2),
    (7296, "identity", False, 1),
    (8192, "identity", False, 1),
    (8320, "identity", False, 0),
    (8192, "identity", True, 2),
    (8320, "identity", True, 1),
    (8832, "identity", True, 1),
    (8960, "identity", True, 0),
    (5760, "stream", False, 2),
    (5888, "stream", False, 1),
    (6400, "matrix", False, 1),
    (6528, "matrix", False, 0),
    (6400, "stream", True, 2),
    (6528, "stream", True, 1),
    (6784, "stream", True, 1),
    (6912, "stream", True, 0),
])
def test_lean_ring_depth_and_shared_memory(s_pad, mode, fast, stages):
    """fact_bwd_lean's stage holds one alpha' row (4 or 2 S_pad bytes)
    and an mbarrier, after fact_bwd's 4 or 5 S_pad floats, alpha'(u),
    x_dst(u) and x_src(u) (outside identity mode) and the scratch."""
    fa = _shape(s_pad, mode, fast)
    vectors = 6 if mode == "identity" else 8
    entry = 2 if fast else 4
    assert fk.ring_stages(fa, lean=True) == stages
    for k in (0, 1, 2):
        want = (vectors * s_pad + 3 * 32 + 3) * 4 + k * (s_pad * entry + 8)
        assert fk.smem_bytes(fa, k, lean=True)["fact_bwd"] == want
    assert fk.smem_bytes(fa, lean=True)["fact_bwd"] <= fk.MAX_SMEM
    if stages < 2:
        assert fk.smem_bytes(fa, stages + 1,
                             lean=True)["fact_bwd"] > fk.MAX_SMEM


@pytest.mark.parametrize("mode,limit", [("identity", 9600),
                                        ("stream", 7168),
                                        ("matrix", 7168)])
def test_lean_limits(mode, limit):
    """The largest S_pad fact_bwd_lean takes, in both precisions (without
    a ring, float32 vectors alone)."""
    for fast in (False, True):
        assert fk.fits_on_chip(_shape(limit, mode, fast), lean=True)
        assert not fk.fits_on_chip(_shape(limit + 128, mode, fast),
                                   lean=True)


# ----------------------------------------------------------------------
# The card's host code on emulated kernels
# ----------------------------------------------------------------------

def _graph(fa):
    kg = fk.graph_for(fa)
    tabs = [pf._ell_table(op) for op in kg.resident]
    lists = [pf._list_table(kg.f_lists, fa.s_pad)]
    if kg.g_lists is not None:
        lists.append(pf._list_table(kg.g_lists, fa.s_pad))
    d1, d2 = kg.diag or (None, None)
    g = None if kg.g_src is None else kg.g_src.long()
    return kg.f_dst.long(), g, tabs, d1, d2, lists


def _mv(tab, v):
    """One row sum of a sliced-ELL operator per state, in slot order."""
    return pf._ell_apply(tab, v[:, None])[:, 0]


def _total(v):
    """block_sum's sum of one column (csrc/fact_common.cuh)."""
    return pf.block_sum(v[:, None])[0]


def _lists(table, c, acc=None):
    return pf._list_sums(table, c[:, None],
                         None if acc is None else acc[:, None])[:, 0]


def _emu_fwd(form, px, lengths, fa, c, outs, t0=0, n_frames=None, snap=1,
             ad_rows=None, ad_init=None, s_init=None, s_ys=None,
             ad_last=None):
    """fact_fwd.cu's kernel in place of fact_kernels._fwd_launch, one
    column at a time: frames t0 .. min(t0 + n, T_b) - 1 from ad_init /
    s_init (or ad0, s0), the auxiliary streams at local rows t - t0, alpha'
    at row (t + 1) / snap - 1 - t0 / snap when (t + 1) % snap == 0."""
    fk.LAUNCHES[fk._name(form, fa)] += 1
    f, g, tabs, d1, d2, _ = _graph(fa)
    fast = d1 is not None
    B, T, _ = px.shape
    n_frames = T if n_frames is None else n_frames
    ad0, s0 = pf.initial_alpha(fa, c)
    rnd = pf._bf if fast else (lambda v: v)
    for b in range(B):
        Tb = int(lengths[b])
        own, s_prev = ((ad0, s0[0]) if ad_init is None
                       else (ad_init[b].float(), s_init[b]))
        for t in range(t0, min(t0 + n_frames, Tb)):
            x = rnd(px[b, t, f])
            xs = x if g is None else rnd(px[b, t, g])
            if fast:
                w1a = _mv(tabs[0], pf._bf(own)) + d1 * own
                u = xs * own
                w2u = _mv(tabs[1], pf._bf(u)) + d2 * u
                a = (x * w1a + w2u) * (1.0 / s_prev)
            else:
                w1a = _mv(tabs[0], own)
                a = (x * w1a + _mv(tabs[1], xs * own)) / s_prev
            s_t = _total(a)
            v = a + (c * s_t) * fa.leaky
            if outs[1] is not None:
                outs[1][b, t - t0], outs[2][b, t - t0] = w1a, x
                if outs[3] is not None:
                    outs[3][b, t - t0] = xs
            if (t + 1) % snap == 0:
                outs[0][b, (t + 1) // snap - 1 - t0 // snap] = v
            if ad_last is not None and t == Tb - 1:
                ad_last[b] = v
            if s_ys is not None:
                s_ys[b, t] = s_t
            own, s_prev = v, s_t
        if s_ys is not None:
            s_ys[b, Tb:] = 1.0
    return ad0, s0


def _emu_bwd(form, lengths, fa, c, streams, s_ys, ad0, s0, tot_prob, outs,
             debug, stages, px=None, t0=0, n_frames=None, ad_init=None,
             carry=(None, None)):
    """fact_bwd.cu's kernel in place of fact_kernels._bwd_launch, one
    column at a time: frames past the end zeroed in the launch's range,
    beta'(T_b) injected where T_b - 1 lies in it, else the carry read;
    frames min(t0 + n, T_b) - 1 .. t0 on the launch's stream rows (the
    lean mode: alpha' rows and px, W1 alpha' formed here), alpha'(t0)
    from ad_init or ad0; the carry written for the launch below."""
    fk.LAUNCHES[fk._name(form, fa)] += 1
    f, g, tabs, d1, d2, lists = _graph(fa)
    fast = d1 is not None
    lean = form == "fact_bwd_lean"
    gamma, ab, gs = outs
    B, T = s_ys.shape
    P = gamma.shape[2]
    n = T if n_frames is None else n_frames
    rnd = pf._bf if fast else (lambda v: v)
    for b in range(B):
        Tb = int(lengths[b])
        past0, past1 = max(Tb, t0), t0 + n
        gamma[b, past0:past1] = 0.0
        ab[b, past0:past1] = gs[b, past0:past1] = 0.0 if debug else 1.0
        t_hi = min(t0 + n, Tb)
        if t_hi <= t0:
            continue
        if Tb <= t0 + n:
            bd = fa.final / tot_prob[b]
            leak = _total(bd * fa.leaky)
        else:
            bd, leak = carry[0][b].clone(), carry[1][b].clone()
        for u in range(t_hi - 1, t0 - 1, -1):
            inv = 1.0 / (s0[0] if u == 0 else s_ys[b, u - 1])
            if u > t0:
                ad = streams[0][b, u - t0 - 1].float()
            else:
                ad = ad0 if ad_init is None else ad_init[b].float()
            if lean:
                x = rnd(px[b, u, f])
                xs = x if g is None else rnd(px[b, u, g])
                w1a = _mv(tabs[0], rnd(ad)) + (d1 * ad if fast else 0.0)
            else:
                x, w1a = streams[2][b, u - t0].float(), \
                    streams[1][b, u - t0].float()
                xs = x if g is None else streams[3][b, u - t0].float()
            v = bd + c * leak
            xb = x * v
            if fast:
                w1t = _mv(tabs[2], pf._bf(xb)) + d1 * xb
                sw = xs * (_mv(tabs[3], pf._bf(v)) + d2 * v)
                bd_t = (w1t + sw) * inv
                m1, m2 = xb * w1a, sw * ad
                scale = inv
            else:
                sw = xs * _mv(tabs[3], v)
                bd_t = (_mv(tabs[2], xb) + sw) * inv
                m1, m2 = xb * w1a * inv, sw * ad * inv
                scale = 1.0
            if g is None:
                acc = _lists(lists[0], rnd(m1 + m2))
            else:
                acc = _lists(lists[1], rnd(m2), _lists(lists[0], rnd(m1)))
            acc = torch.nn.functional.pad(acc[:P], (0, P - min(P, len(acc))))
            gamma[b, u] = rnd(acc * scale)
            if debug or u == 0:
                ab[b, u] = _total(ad * bd_t)
                gs[b, u] = _total(acc) * scale
            else:
                ab[b, u] = gs[b, u] = 1.0
            leak, bd = _total(bd_t * fa.leaky), bd_t
        if carry[0] is not None and t0 > 0:
            carry[0][b], carry[1][b] = bd, leak
    return outs


@pytest.mark.parametrize("stream_mode,chunk", [
    ("full", None), ("lean", None), ("ckpt", 3), ("ckpt", 4),
    ("ckpt", 12), ("ckpt", None)])
@pytest.mark.parametrize("fwd_mode,want", MODES)
@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_host_code_on_emulated_kernels(monkeypatch, tile_dtype, fwd_mode,
                                       want, stream_mode, chunk):
    """fact_kernels' card path (fact_fwd + fact_bwd, _lean, _ckpt) with
    the launches emulated, at T=12 and lengths 12, 8, 4, 1, 9 (ends on a
    chunk boundary, in the first frame, one frame past a boundary; C = 3,
    4, 12 and the default 8), debug True and False: in the fast mode the
    plain version's numbers bit for bit, in float32 within 1e-5 (objf
    also 1e-6 absolute: one column's is 3e-3; the kernels' float32 sums
    run in another order, the plain version's through dense products);
    one snapshot sweep and
    one replay and one chunk backward a chunk."""
    fst, P = denominator_fst(num_phones=10, states_per_phone=2, seed=6,
                             forward_pdf_mode=fwd_mode)
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), 5, tile_dtype=tile_dtype,
                            device="cpu")._fact
    assert fa.xsrc_mode == want
    rng = np.random.RandomState(6)
    px = torch.exp(torch.from_numpy(rng.randn(5, 12, P).astype(np.float32)))
    lens = torch.tensor([12, 8, 4, 1, 9], dtype=torch.int32)
    monkeypatch.setattr(fk, "_fwd_launch", _emu_fwd)
    monkeypatch.setattr(fk, "_bwd_launch", _emu_bwd)
    fk.reset_launch_counts()
    sfx = "_bf16" if tile_dtype else ""
    for debug in (True, False):
        if stream_mode == "full":
            ad_ys, w1ad, xdst, xsrc, s_ys, ad_last, ad0, s0 = fk.fact_fwd(
                px, lens, fa, LEAKY)
            objf, tot = fk._objf(s_ys, ad_last, lens, fa, s0)
            outs = fk.fact_bwd(lens, fa, LEAKY, ad_ys, w1ad, xdst, xsrc,
                               s_ys, ad0, s0, tot, P, debug)
        elif stream_mode == "lean":
            objf, outs = fk._lean(px, lens, fa, LEAKY, debug, None)
        else:
            objf, outs = fk._ckpt(px, lens, fa, LEAKY, debug, None, chunk)
        got = fk._package_result(objf, *outs)
        ref = pf.forward_backward_prob_mode(px, lens, fa, LEAKY, stream_mode,
                                            chunk)
        if not debug:
            ref = fk._frame0_traces(ref)
        if tile_dtype:
            _assert_equal(got, ref)
        else:
            torch.testing.assert_close(got.objf, ref.objf, rtol=1e-5,
                                       atol=1e-6)
            for name in ("gamma", "alpha_beta", "gamma_sum"):
                torch.testing.assert_close(getattr(got, name),
                                           getattr(ref, name), rtol=0,
                                           atol=1e-5)
    n = -(-12 // fk.ckpt_chunk_length(12, chunk))
    want_launches = {
        "full": {"fact_fwd": 2, "fact_bwd": 2},
        "lean": {"fact_fwd_snap": 2, "fact_bwd_lean": 2},
        "ckpt": {"fact_fwd_snap": 2, "fact_fwd_init": 2 * n,
                 "fact_bwd_chunk": 2 * n}}[stream_mode]
    assert fk.launched() == {k + sfx: v for k, v in want_launches.items()}
