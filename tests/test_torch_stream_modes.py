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
numbers bit for bit.  Every form runs a column on a cluster of C CTAs
(``cluster=``): the emulations compute each CTA's rows (and, in the
backward, its pdfs) apart, assemble the vectors the products gather from
every CTA's rows, and take each sum as the kernels do (each virtual
thread's partial on the CTA that owns its rows, the warp trees there, the
cross-warp tree on the 32 posted totals: ``_cluster_total``), so that
C = 2 and C = 4 must give C = 1's bits; the plan rule
(``fact_kernels.cluster_size``) and the lean forms' cluster shared memory
and limits are checked by arithmetic on a stubbed card
(tests/test_torch_full_cluster.py: the full and chunk forms').
tests/test_torch_card.py holds the kernels themselves to the plain version
on the card.
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


# An H100 as the plan rule reads it (torch.cuda.get_device_properties).
H100 = types.SimpleNamespace(multi_processor_count=132,
                             shared_memory_per_block_optin=232448)


def _lists(table, c, acc=None):
    return pf._list_sums(table, c[:, None],
                         None if acc is None else acc[:, None])[:, 0]


def _virtual(rank, C):
    """CTA rank's virtual threads of the 1024-thread block:
    cluster_row(j, rank, C) for j < 1024 / C (csrc/fact_common.cuh)."""
    j = torch.arange(1024 // C)
    return ((j >> 5) * C + rank) * 32 + (j & 31)


def _owner(n, C):
    """The CTA that owns each of n rows (or pdfs): slice (i >> 5) mod C."""
    return (torch.arange(n) >> 5) % C


def _cluster_total(own, C):
    """The sum of the kernels' cluster form over n rows: own[r] (n,) holds
    CTA r's terms on its rows (NaN elsewhere, never read).  Each virtual
    thread v adds rows v, v + 1024, ... in turn on its CTA, each virtual
    warp's shuffle tree runs there, and the cross-warp tree sums the 32
    posted totals (block_sum's trees)."""
    n = own[0].shape[0]
    R = max(-(-n // 1024), 1)
    totals = torch.zeros(32)
    for r in range(C):
        v = _virtual(r, C)
        idx = v[None, :] + 1024 * torch.arange(R)[:, None]        # (R, V)
        x = torch.where(idx < n, own[r][idx.clamp(max=n - 1)], 0.0)
        assert not bool(torch.isnan(x).any()), "a term off its CTA's rows"
        part = x[0]
        for k in range(1, R):
            part = part + x[k]
        lanes = part.reshape(-1, 32)
        for off in (16, 8, 4, 2, 1):
            lanes = lanes[:, :off] + lanes[:, off:2 * off]
        totals[torch.arange(len(v) // 32) * C + r] = lanes[:, 0]
    t = totals[None, :]
    for off in (16, 8, 4, 2, 1):
        t = t[:, :off] + t[:, off:2 * off]
    return t[0, 0]


def _split(v, C):
    """v's rows apart by owner: CTA r's copy holds its rows, NaN
    elsewhere."""
    who = _owner(v.shape[0], C)
    return [torch.where(who == r, v, float("nan")) for r in range(C)]


def _rows_mv(tab, v, rows):
    """An operator's sums on a CTA's own rows (each its sell_row_dot)."""
    cols, vals = tab
    return pf._ell_apply((cols[:, rows], vals[:, rows]), v[:, None])[:, 0]


def _assemble(parts, rows_of, n):
    """A whole vector from each CTA's own rows (the DSMEM exchange)."""
    out = torch.full((n,), float("nan"))
    for part, rows in zip(parts, rows_of):
        out[rows] = part
    assert not bool(torch.isnan(out).any())
    return out


def _emu_fwd(form, px, lengths, fa, c, outs, t0=0, n_frames=None, snap=1,
             ad_rows=None, ad_init=None, s_init=None, s_ys=None,
             ad_last=None, cluster=1, smid=None, count=True):
    """fact_fwd.cu's kernel in place of fact_kernels._fwd_launch, one
    column at a time: frames t0 .. min(t0 + n, T_b) - 1 from ad_init /
    s_init (or ad0, s0), the auxiliary streams at local rows t - t0, alpha'
    at row (t + 1) / snap - 1 - t0 / snap when (t + 1) % snap == 0.  On a
    cluster each CTA computes its own rows (and their stream entries) from
    the whole carry and W2 operand, and s_t is the cluster's sum."""
    assert cluster in fk.LEAN_CLUSTERS and smid is None
    fk.LAUNCHES[fk._name(form, fa)] += count
    f, g, tabs, d1, d2, _ = _graph(fa)
    fast = d1 is not None
    B, T, _ = px.shape
    n_frames = T if n_frames is None else n_frames
    ad0, s0 = pf.initial_alpha(fa, c)
    rnd = pf._bf if fast else (lambda v: v)
    rows_of = pf.cluster_rows(fa.s_pad, cluster)
    for b in range(B):
        Tb = int(lengths[b])
        own, s_prev = ((ad0, s0[0]) if ad_init is None
                       else (ad_init[b].float(), s_init[b]))
        for t in range(t0, min(t0 + n_frames, Tb)):
            x = rnd(px[b, t, f])
            xs = x if g is None else rnd(px[b, t, g])
            u = xs * own      # whole in every CTA, as the carry
            parts, w1as = [], []
            for R in rows_of:
                if fast:
                    w1a = _rows_mv(tabs[0], pf._bf(own), R) + d1[R] * own[R]
                    w2u = _rows_mv(tabs[1], pf._bf(u), R) + d2[R] * u[R]
                    parts.append((x[R] * w1a + w2u) * (1.0 / s_prev))
                else:
                    w1a = _rows_mv(tabs[0], own, R)
                    parts.append((x[R] * w1a + _rows_mv(tabs[1], u, R))
                                 / s_prev)
                w1as.append(w1a)
            a = _assemble(parts, rows_of, fa.s_pad)
            w1a = _assemble(w1as, rows_of, fa.s_pad)
            s_t = _cluster_total(_split(a, cluster), cluster)
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
             carry=(None, None), cluster=1, smid=None, count=True):
    """fact_bwd.cu's kernel in place of fact_kernels._bwd_launch, one
    column at a time: frames past the end zeroed in the launch's range,
    beta'(T_b) injected where T_b - 1 lies in it, else the carry read;
    frames min(t0 + n, T_b) - 1 .. t0 on the launch's stream rows (the
    lean mode: alpha' rows and px, W1 alpha' formed here), alpha'(t0)
    from ad_init or ad0; the carry written for the launch below.  On a
    cluster each CTA computes its own rows' beta' and masses from the
    whole b and x_dst * b, and its own pdfs' gamma from the whole masses;
    every sum is the cluster's."""
    assert cluster in fk.LEAN_CLUSTERS and smid is None
    fk.LAUNCHES[fk._name(form, fa)] += count
    f, g, tabs, d1, d2, lists = _graph(fa)
    fast = d1 is not None
    lean = form == "fact_bwd_lean"
    rows_of = pf.cluster_rows(fa.s_pad, cluster)
    total = lambda v: _cluster_total(_split(v, cluster), cluster)
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
            leak = total(bd * fa.leaky)
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
            xb = x * v       # b and x_dst * b: whole in every CTA
            got = {"bd": [], "m1": [], "m2": []}
            for R in rows_of:
                if fast:
                    w1t = _rows_mv(tabs[2], pf._bf(xb), R) + d1[R] * xb[R]
                    sw = xs[R] * (_rows_mv(tabs[3], pf._bf(v), R)
                                  + d2[R] * v[R])
                    bd_r = (w1t + sw) * inv
                    m1, m2 = xb[R] * w1a[R], sw * ad[R]
                else:
                    sw = xs[R] * _rows_mv(tabs[3], v, R)
                    bd_r = (_rows_mv(tabs[2], xb, R) + sw) * inv
                    m1, m2 = xb[R] * w1a[R] * inv, sw * ad[R] * inv
                for k, val in (("bd", bd_r), ("m1", m1), ("m2", m2)):
                    got[k].append(val)
            bd_t, m1, m2 = (_assemble(got[k], rows_of, fa.s_pad)
                            for k in ("bd", "m1", "m2"))
            scale = inv if fast else 1.0
            # every CTA's whole masses; each CTA's own pdfs' sums
            if g is None:
                acc = _lists(lists[0], rnd(m1 + m2))
            else:
                acc = _lists(lists[1], rnd(m2), _lists(lists[0], rnd(m1)))
            acc = torch.nn.functional.pad(acc[:P], (0, P - min(P, len(acc))))
            acc = _assemble([acc[_owner(P, cluster) == r]
                             for r in range(cluster)],
                            [torch.nonzero(_owner(P, cluster) == r)[:, 0]
                             for r in range(cluster)], P)
            gamma[b, u] = rnd(acc * scale)
            if debug or u == 0:
                ab[b, u] = total(ad * bd_t)
                gs[b, u] = _cluster_total(_split(acc, cluster),
                                          cluster) * scale
            else:
                ab[b, u] = gs[b, u] = 1.0
            leak, bd = total(bd_t * fa.leaky), bd_t
        if carry[0] is not None and t0 > 0:
            carry[0][b], carry[1][b] = bd, leak
    return outs


def _emu_pair(fa, replay, backward, smid=None):
    """csrc/fact_ckpt.cu's kernel in place of fact_kernels._pair_launch:
    the replay role (_emu_fwd on its fact_fwd_init arguments), then the
    backward role (_emu_bwd on its fact_bwd_chunk arguments).  The roles
    share nothing, so their order does not matter to a right schedule;
    the replay first makes a wrong one show (it would overwrite the
    streams its backward reads).  Counted as the pair and its roles."""
    assert smid is None and (replay or backward)
    fk.LAUNCHES[fk._name(fk.PAIR, fa)] += 1
    for emu, kw, heads in (
            (_emu_fwd, replay, ("form", "px", "lengths", "fa",
                                "leaky_coefficient", "outs")),
            (_emu_bwd, backward, ("form", "lengths", "fa",
                                  "leaky_coefficient", "streams"))):
        if kw is not None:
            kw = dict(kw)
            args = [kw.pop(k) for k in heads]
            emu(*args, count=False, **kw)
            fk.ROLE_LAUNCHES[fk._name(args[0], fa)] += 1


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
    one snapshot sweep, then the paired chunk scan (B = 5: 2 B <= 132):
    n + 1 pair launches for n chunks, one replay and one chunk backward a
    chunk.  The card is an H100 stub (132 SMs); at S_pad 128 the plan
    rule keeps C = 1 (the cluster forms run forced in the tests below)."""
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
    monkeypatch.setattr(fk, "_pair_launch", _emu_pair)
    monkeypatch.setattr(fk, "_card_props", lambda device: H100)
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
        "ckpt": {"fact_fwd_snap": 2, "fact_ckpt_pair": 2 * (n + 1)}}[
            stream_mode]
    assert fk.launched() == {k + sfx: v for k, v in want_launches.items()}
    assert fk.roles_launched() == ({} if stream_mode != "ckpt" else {
        f"fact_fwd_init{sfx}": 2 * n, f"fact_bwd_chunk{sfx}": 2 * n})


# ----------------------------------------------------------------------
# The lean forms on a cluster of C CTAs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("n", [32, 128, 1000, 1280, 3000, 3072, 8064])
def test_cluster_sum_is_the_block_sum(n, C):
    """The cluster form's sums (each virtual thread's rows on the CTA that
    owns them, the warp trees there, block_sum's cross-warp tree on the
    posted totals) equal block_sum's bit for bit: over states (S_pad a
    multiple of 32, one to eight rows a virtual thread) and over pdfs
    (P = 1000, 3000)."""
    rng = np.random.RandomState(n + C)
    v = torch.from_numpy(rng.randn(n).astype(np.float32)
                         * np.exp(rng.randn(n) * 4).astype(np.float32))
    got = _cluster_total(_split(v, C), C)
    assert torch.equal(got, _total(v))
    if C > 1:
        # every virtual thread's rows lie in one CTA: C divides 32
        for r in range(C):
            rows = pf.cluster_rows(-(-n // 32) * 32, C)[r]
            assert bool((_owner(len(rows) and int(rows.max()) + 1, C)[rows]
                         == r).all())


def _cluster_run(monkeypatch, fa, px, lens, mode, cluster, chunk=None,
                 debug=True):
    """The card path of the lean or ckpt mode on emulated kernels with the
    lean forms forced to ``cluster`` CTAs."""
    monkeypatch.setattr(fk, "_fwd_launch", _emu_fwd)
    monkeypatch.setattr(fk, "_bwd_launch", _emu_bwd)
    monkeypatch.setattr(fk, "_card_props", lambda device: H100)
    fk.reset_launch_counts()
    if mode == "lean":
        objf, outs = fk._lean(px, lens, fa, LEAKY, debug, None, cluster)
    else:
        objf, outs = fk._ckpt(px, lens, fa, LEAKY, debug, None, chunk,
                              cluster)
    return fk._package_result(objf, *outs), fk.launched()


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("stream_mode,chunk", [("lean", None), ("ckpt", 5)])
@pytest.mark.parametrize("fwd_mode,want", [("source", "identity"),
                                           ("separate", "stream")])
@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_cluster_forms_give_one_blocks_bits(monkeypatch, tile_dtype,
                                            fwd_mode, want, stream_mode,
                                            chunk, C):
    """Lean and ckpt with the lean forms on C = 2 and 4 CTAs a column give
    C = 1's bits, in both precisions, identity and not, at T=12 and
    lengths 12, 8, 4, 1, 9 (C=5: every column but the first ends inside a
    chunk), debug True and False; the launches are the mode's."""
    fst, P = denominator_fst(num_phones=10, states_per_phone=2, seed=6,
                             forward_pdf_mode=fwd_mode)
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), 5, tile_dtype=tile_dtype,
                            device="cpu")._fact
    assert fa.xsrc_mode == want
    rng = np.random.RandomState(16)
    px = torch.exp(torch.from_numpy(rng.randn(5, 12, P).astype(np.float32)))
    lens = torch.tensor([12, 8, 4, 1, 9], dtype=torch.int32)
    sfx = "_bf16" if tile_dtype else ""
    for debug in (True, False):
        one, _ = _cluster_run(monkeypatch, fa, px, lens, stream_mode, 1,
                              chunk=chunk, debug=debug)
        got, launched = _cluster_run(monkeypatch, fa, px, lens, stream_mode,
                                     C, chunk=chunk, debug=debug)
        _assert_equal(got, one)
        n = -(-12 // 5)
        assert launched == {k + sfx: v for k, v in (
            {"fact_fwd_snap": 1, "fact_bwd_lean": 1} if stream_mode == "lean"
            else {"fact_fwd_snap": 1, "fact_fwd_init": n,
                  "fact_bwd_chunk": n}).items()}


@pytest.mark.parametrize("mode", ["lean", "ckpt"])
@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_cluster_forms_past_1024_states(monkeypatch, tile_dtype, mode):
    """A graph of S_pad 1,280 (two rows for some virtual threads, five
    slices a CTA at C = 4 and their pdfs past 1,024): the lean mode and
    the ckpt mode's snapshot sweep (chunk 3) at C = 2 and 4 give C = 1's
    bits and, in the fast mode, the plain version's."""
    fst, P = denominator_fst(num_phones=600, states_per_phone=2, seed=3,
                             forward_pdf_mode="source")
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), 2, tile_dtype=tile_dtype,
                            device="cpu")._fact
    assert fa.s_pad > 1024 and P > 1024
    rng = np.random.RandomState(4)
    px = torch.exp(torch.from_numpy(rng.randn(2, 4, P).astype(np.float32)))
    lens = torch.tensor([4, 3], dtype=torch.int32)
    chunk = 3 if mode == "ckpt" else None
    one, _ = _cluster_run(monkeypatch, fa, px, lens, mode, 1, chunk)
    for C in (2, 4):
        got, _ = _cluster_run(monkeypatch, fa, px, lens, mode, C, chunk)
        _assert_equal(got, one)
    if tile_dtype:
        _assert_equal(one, pf.forward_backward_prob_mode(px, lens, fa, LEAKY,
                                                         mode, chunk))


@pytest.mark.parametrize("B,sms,optin,want", [
    (128, 132, 232448, 1),    # the headline batch: 128 CTAs already
    (64, 132, 232448, 2),     # bench.py --long --big (main path 7)
    (32, 132, 232448, 2),     # bench.py --long: C = 4 is not planned
    (33, 132, 232448, 2),
    (66, 132, 232448, 2),     # 132 CTAs: the card exactly
    (67, 132, 232448, 1),
    (1, 132, 232448, 2),
    (5, 16, 232448, 2),       # a card of 16 SMs
    (9, 16, 232448, 1),
    (32, 132, 101376, 1),     # 99 KB a block: no cluster CTA fits
])
def test_lean_cluster_rule(B, sms, optin, want):
    """The largest C in (1, 2) (C = 4 is built, not planned: slower than
    C = 1 at B = 32) with B C CTAs on the card's SMs whose CTAs fit its
    shared memory (at least 118,784 bytes a cluster CTA)."""
    props = types.SimpleNamespace(multi_processor_count=sms,
                                  shared_memory_per_block_optin=optin)
    for fast in (False, True):
        head = _shape(3072, "identity", fast)
        for form in fk.MODE_FORMS["lean"]:
            assert fk.cluster_size(B, props, head, form) == want
            assert fk.cluster_size(B, props, head, form, cluster=1) == 1


def test_lean_cluster_forced_errors():
    """A forced C that is not built, or whose CTA does not fit the card,
    raises NotImplementedError with the numbers; a C that is not built
    raises ValueError at the launch, for every form."""
    head = _shape(3072, "identity")
    for bad in (3, 8, 0):
        for form in fk.MODE_FORMS["lean"]:
            with pytest.raises(NotImplementedError, match="cluster of"):
                fk.cluster_size(64, H100, head, form, cluster=bad)
    small = types.SimpleNamespace(multi_processor_count=132,
                                  shared_memory_per_block_optin=101376)
    for form in fk.MODE_FORMS["lean"]:
        with pytest.raises(NotImplementedError, match="118784"):
            fk.cluster_size(64, small, head, form, cluster=2)
    big = _shape(9728, "identity")
    with pytest.raises(NotImplementedError, match="S_pad=9728"):
        fk.cluster_size(16, H100, big, "fact_bwd_lean", cluster=4)
    for form, C in (("fact_fwd", 8), ("fact_bwd_chunk", 3),
                    ("fact_fwd_init", 0), ("fact_bwd", 8),
                    ("fact_fwd_snap", 8), ("fact_bwd_lean", 3)):
        with pytest.raises(ValueError):
            fk._cluster_args(form, 8, C, None)
    for form in fk.FWD_FORMS + fk.BWD_FORMS:
        for C in fk.LEAN_CLUSTERS:
            fk._cluster_args(form, 8, C, None)


@pytest.mark.parametrize("mode,limit", [("identity", 9600),
                                        ("stream", 7168),
                                        ("matrix", 7168)])
def test_cluster_form_keeps_the_lean_limits(mode, limit):
    """The cluster form's shared memory: fact_bwd_lean's formula (the
    vectors read whole are whole), fact_fwd_snap's with x_src on own rows
    outside identity mode, the scratch padded to 16 bytes and two
    mbarriers, both at least 118,784 bytes;
    so the lean limits
    (S_pad 9,600 identity, else 7,168) and the ring depth are C = 1's at
    every C, in both precisions."""
    for fast in (False, True):
        fa = _shape(limit, mode, fast)
        past = _shape(limit + 128, mode, fast)
        lean = fk.MODE_FORMS["lean"]
        for C in fk.LEAN_CLUSTERS:
            assert all(fk.cluster_fits(fa, C, f) for f in lean)
            assert not all(fk.cluster_fits(past, C, f) for f in lean)
            got = {k: fk.cluster_smem_bytes(fa, C)[k] for k in lean}
            one = fk.smem_bytes(fa, lean=True)
            if C == 1:
                assert got == {"fact_fwd_snap": one["fact_fwd"],
                               "fact_bwd_lean": one["fact_bwd"]}
            else:
                vectors = 4 if mode == "identity" else 5
                assert got == {
                    "fact_fwd_snap": (vectors * limit + 40) * 4,
                    "fact_bwd_lean": one["fact_bwd"]}
        head = _shape(3072, mode, fast)
        for C in (2, 4):
            small = fk.cluster_smem_bytes(head, C)
            one = fk.smem_bytes(head, lean=True)["fact_bwd"]
            assert small["fact_bwd_lean"] == max(one,
                                                 fk.LEAN_CLUSTER_MIN_SMEM)
            assert small["fact_fwd_snap"] == fk.LEAN_CLUSTER_MIN_SMEM
            assert 2 * (fk.LEAN_CLUSTER_MIN_SMEM + 1024) > 233472
            assert fk.ring_stages(head, lean=True) == 2


@pytest.mark.parametrize("s_pad,mode,fast,P,stages,want", [
    (3072, "identity", True, 3000, 2, True),     # main path 7
    (3072, "identity", True, 3001, 2, False),    # P % 4 != 0: no TMA copy
    (3072, "identity", True, 3000, 0, False),    # no ring
    (3072, "stream", False, 3000, 1, True),
    (7168, "identity", False, 3000, 2, False),   # does not fit beside it
    (7168, "identity", True, 3000, 2, True),
    (5760, "stream", False, 3000, 2, False),
])
def test_lean_px_ring_rule(s_pad, mode, fast, P, stages, want):
    """fact_bwd_lean's cluster form holds px's rows in its ring where there
    is a ring, P floats are 16-byte copies and they fit beside the C = 1
    layout (whose depth and limits they never change); its request then
    grows by a row a stage, never below 118,784 bytes."""
    fa = _shape(s_pad, mode, fast)
    assert fk.lean_px_ring(fa, stages, P) == want
    one = fk.smem_bytes(fa, stages, lean=True)["fact_bwd"]
    got = fk.cluster_smem_bytes(fa, 2, stages, P)["fact_bwd_lean"]
    assert got == max(one + (stages * 4 * P if want else 0),
                      fk.LEAN_CLUSTER_MIN_SMEM)
    assert got <= fk.MAX_SMEM
    assert fk.cluster_smem_bytes(fa, 1, stages, P)["fact_bwd_lean"] == one
