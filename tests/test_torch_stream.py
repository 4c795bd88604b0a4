"""The port's cluster tier (B3/B4) against the JAX package's streamed one.

The JAX package serves denominators past its resident kernels' VMEM with
weight-streaming Pallas kernels (ops/pallas_stream.py); the port serves
denominators past one SM's shared memory with two CUDA kernels that split
each column's state vectors over a thread-block cluster
(ops/stream_kernels.py).  Here, on the CPU:

* the port's forward_backward_prob_stream (the plain version on CPU
  tensors) against JAX's B3/B4 in interpret mode, and ChainLoss with the
  denominator forced to engine="stream" in both packages: objf relative
  and gamma / gradient max-abs <= 1e-5;
* a step-for-step emulation of the two kernels on the arrays they read
  (packed state ids, each CTA's row range, the pdf columns each CTA
  owns, partial sums added in rank order) against the plain version, for
  every cluster size and x_src mode, to 1e-5;
* the tiering (resident, cluster, or NotImplementedError) and the card's
  stream budget, sized by arithmetic on the shapes of main path 4's
  graph rather than by building it.

tests/test_torch_card.py holds the kernels themselves to the plain
version on the card.
"""

import dataclasses
import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pychain_tpu.graphs.factorize as jfz
from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.loss import chain_loss as j_chain_loss
from pychain_tpu.ops.pallas_stream import \
    forward_backward_prob_stream as j_stream
from pychain_tpu.utils.testgraphs import denominator_fst

import pychain_tpu_torch as pt
import pychain_tpu_torch.graphs.factorize as pfz
from pychain_tpu_torch import loss as pt_loss
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.ops import stream_kernels as sk
from pychain_tpu_torch.ops.factorized import forward_backward_prob_fact
from pychain_tpu_torch.utils.testgraphs import linear_fst

LEAKY = 1e-5
MODES = [("source", "identity"), ("cross", "matrix"),
         ("separate", "stream")]


def _tiled_batches(mode, B):
    """The JAX stream tests' graph (tests/test_pallas_stream.py:33-55):
    denominator_fst(256, 2, bigram_fanout=2) with every transition
    matrix forced onto the 128x128 tile stratum (dense_min_fill=2.0), so
    that the JAX kernels stream W1 tiles; the same strata in both
    packages."""
    fst, P = denominator_fst(num_phones=256, states_per_phone=2,
                             bigram_fanout=2, seed=0, forward_pdf_mode=mode)
    j_orig, p_orig = jfz._build_wparts, pfz._build_wparts
    jfz._build_wparts = functools.partial(j_orig, dense_min_fill=2.0)
    pfz._build_wparts = functools.partial(p_orig, dense_min_fill=2.0)
    try:
        jbatch = JChainGraphBatch(JChainGraph(fst), B)
        batch = pt.ChainGraphBatch(pt.ChainGraph(fst), B, device="cpu")
    finally:
        jfz._build_wparts, pfz._build_wparts = j_orig, p_orig
    assert jbatch._fact.w1.tiles.shape[0] > 1, "W1 tiles must stream"
    return fst, P, jbatch, batch


def _assert_close(got, ref):
    np.testing.assert_allclose(got.objf.numpy(), np.asarray(ref.objf),
                               rtol=1e-5, atol=0)
    for name in ("gamma", "alpha_beta", "gamma_sum"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("mode", ["source", "separate"])
def test_stream_matches_jax_stream_interpret(mode):
    B, T = 4, 10
    _, P, jbatch, batch = _tiled_batches(mode, B)
    rng = np.random.RandomState(0)
    px = np.exp(rng.randn(B, T, P).astype(np.float32) * 0.3)
    lengths = np.array([T, T, T - 2, T - 5], np.int32)
    got = sk.forward_backward_prob_stream(
        torch.from_numpy(px.copy()), torch.from_numpy(lengths.copy()),
        batch._fact, LEAKY)
    ref = j_stream(jnp.asarray(px.copy()), jnp.asarray(lengths.copy()),
                   jbatch._fact, LEAKY)
    _assert_close(got, ref)


def test_chain_loss_forced_stream_matches_jax():
    """ChainLoss's objective and x-gradient with the denominator forced
    to engine="stream" in both packages."""
    B, T = 3, 8
    _, P, jbatch, batch = _tiled_batches("separate", B)
    rng = np.random.RandomState(1)
    lens = np.array([T, T - 3, T - 5], np.int32)
    seqs = [rng.randint(0, P, size=int(n)) for n in lens]
    x = rng.randn(B, T, P).astype(np.float32)
    K = int(lens.max())
    nums = pt.ChainGraphBatch(
        [pt.ChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1, device="cpu")
    den = dataclasses.replace(batch._fact, engine="stream")
    assert pt_loss.dispatch_arrays(den).engine == "stream"
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    val = pt_loss.chain_loss(xt, torch.from_numpy(lens.copy()), nums, den)
    val.backward()

    jnums = JChainGraphBatch(
        [JChainGraph(linear_fst(s), log_domain=True) for s in seqs],
        max_num_transitions=K, max_num_states=K + 1)
    jden = dataclasses.replace(jbatch._fact, engine="stream")
    jval, jgrad = jax.value_and_grad(
        lambda a: j_chain_loss(a, jnp.asarray(lens.copy()), jnums, jden))(
            jnp.asarray(x.copy()))
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=1e-5)


# ----------------------------------------------------------------------
# Emulation of the cluster kernels on the arrays they read
# ----------------------------------------------------------------------

def _case(mode, B=4, T=9, seed=2, num_phones=150):
    """S = 300, S_pad = 384: 12 slices of 32 rows, so with C = 8 ranks
    0-3 own two slices and ranks 4-7 one (num_phones=10, S_pad = 128:
    ranks 4-7 own none)."""
    fst, P = denominator_fst(num_phones=num_phones, states_per_phone=2,
                             seed=seed, forward_pdf_mode=mode)
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, P).astype(np.float32)
    lengths = np.array([T, T - 2, 3, 1][:B], np.int32)
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), B, device="cpu")._fact
    return fa, torch.exp(torch.from_numpy(x)), torch.from_numpy(lengths)


def _csr_mv(sell, v):
    """A sliced-ELL operator (fact_kernels._sell) times v."""
    sptr, col, val = sell
    slen = (sptr[1:] - sptr[:-1]).long()
    entries = torch.arange(len(col))
    row = (torch.repeat_interleave(torch.arange(len(slen)), slen * fk.SLICE)
           * fk.SLICE + entries % fk.SLICE)
    return torch.zeros(len(slen) * fk.SLICE).index_add_(
        0, row, val * v[col.long()])


class _Cluster:
    """The CTAs of one column's cluster: CTA r owns the 32-row slices
    k = r (mod C), its rows' values at local rows (a (C, R) tensor per
    vector) and whole copies of the vectors its products gather (a
    (C, S_pad) tensor, its peers' rows copied in after each barrier); a
    packed id reads its owner's local row."""

    def __init__(self, fa, C):
        self.C, self.R = C, sk.rows_per_cta(fa.s_pad, C)
        self.kg = sk.cluster_graph(fk.kernel_graph(fa), C)
        slices = torch.arange(fa.s_pad // fk.SLICE)
        self.own = [(slices[slices % C == r][:, None] * fk.SLICE
                     + torch.arange(fk.SLICE)).reshape(-1) for r in range(C)]
        self.n = [len(o) for o in self.own]
        assert sorted(torch.cat(self.own).tolist()) == list(range(fa.s_pad))
        assert max(self.n) == self.R

    def local(self):
        return torch.zeros(self.C, self.R)

    def load(self, V, packed):
        packed = packed.long()
        return V[packed >> sk.LOCAL_BITS, packed & ((1 << sk.LOCAL_BITS) - 1)]

    def gather(self, W):
        """cluster_gather: every CTA's copy takes each row from its owner."""
        for r in range(self.C):
            W[:, self.own[r]] = W[r, self.own[r]]

    def rank_sum(self, parts):
        total = torch.zeros(())
        for p in parts:                # rank order, from 0
            total = total + p
        return total


def _emulate_cluster(px, lengths, fa, c, C, debug):
    """csrc/stream_fwd.cu and csrc/stream_bwd.cu, one column at a time,
    one CTA at a time between barriers."""
    cl = _Cluster(fa, C)
    kg = cl.kg
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
        ad = ad0.expand(C, s_pad).clone()
        u, xd = torch.zeros(C, s_pad), cl.local()
        s_prev = s0
        for t in range(int(lengths[b])):
            for r, own in enumerate(cl.own):
                x = px[b, t, f[own]]
                xs = x if g is None else px[b, t, g[own]]
                xd[r, :cl.n[r]] = x
                u[r, own] = xs * ad[r, own]
                streams[2, b, t, own] = x
                streams[3, b, t, own] = xs
            cl.gather(ad)
            cl.gather(u)
            a, parts = cl.local(), []
            for r, own in enumerate(cl.own):
                w1a = _csr_mv(kg.w1, ad[r])[own]
                a[r, :cl.n[r]] = (xd[r, :cl.n[r]] * w1a
                                  + _csr_mv(kg.w2, u[r])[own]) / s_prev
                streams[1, b, t, own] = w1a
                parts.append(a[r, :cl.n[r]].sum())
            s_t = cl.rank_sum(parts)
            for r, own in enumerate(cl.own):
                ad[r, own] = a[r, :cl.n[r]] + c * s_t * fa.leaky[own]
                streams[0, b, t, own] = ad[r, own]
            s_ys[b, t] = s_t
            s_prev = s_t
        ad_last[b] = streams[0, b, int(lengths[b]) - 1]
    objf, tot = fk._objf(s_ys, ad_last, lengths, fa, s0.reshape(1))

    p_per = -(-P // C)
    owned = [(min(P, r * p_per), min(P, r * p_per + p_per))
             for r in range(C)]
    n_lists = min(P, kg.n_pdf_lists)

    def pdf_sums(lists, V):
        ptr, states = (t.long() for t in lists)
        pdf = torch.repeat_interleave(torch.arange(len(ptr) - 1),
                                      ptr[1:] - ptr[:-1])
        return torch.zeros(len(ptr) - 1).index_add_(0, pdf,
                                                    cl.load(V, states))

    gamma = torch.zeros(B, T, P)
    ab = torch.full((B, T), 0.0 if debug else 1.0)
    gs = ab.clone()
    for b in range(B):
        Tb = int(lengths[b])
        bd = cl.local()
        inj = []
        for r, own in enumerate(cl.own):
            v = fa.final[own] / tot[b]
            bd[r, :cl.n[r]] = v
            inj.append((v * fa.leaky[own]).sum())
        leak_sum = cl.rank_sum(inj)
        for u_ in range(Tb - 1, -1, -1):
            s_u = s0 if u_ == 0 else s_ys[b, u_ - 1]
            ad_u = ad0 if u_ == 0 else streams[0, b, u_ - 1]
            _, w1ad, xdst, xsrc = streams[:, b, u_]
            bn, xb = torch.zeros(C, s_pad), torch.zeros(C, s_pad)
            for r, own in enumerate(cl.own):
                bn[r, own] = bd[r, :cl.n[r]] + c * leak_sum
                xb[r, own] = xdst[own] * bn[r, own]
            cl.gather(bn)
            cl.gather(xb)
            c1, c2 = cl.local(), cl.local()
            p_leak, p_ab = [], []
            for r, own in enumerate(cl.own):
                n = cl.n[r]
                w1t = _csr_mv(kg.w1t, xb[r])[own]
                sw = xsrc[own] * _csr_mv(kg.w2t, bn[r])[own]
                bdt = (w1t + sw) / s_u
                m1 = xb[r, own] * w1ad[own] / s_u
                m2 = sw * ad_u[own] / s_u
                if g is None:
                    c1[r, :n] = m1 + m2
                else:
                    c1[r, :n], c2[r, :n] = m1, m2
                bd[r, :n] = bdt
                p_leak.append((bdt * fa.leaky[own]).sum())
                p_ab.append((ad_u[own] * bdt).sum())
            gp = torch.zeros(P)
            gp[:n_lists] = pdf_sums(kg.f_lists, c1)[:n_lists]
            if g is not None:
                gp[:n_lists] += pdf_sums(kg.g_lists, c2)[:n_lists]
            p_gs = []
            for p0, p1 in owned:
                gamma[b, u_, p0:p1] = gp[p0:p1]
                p_gs.append(gp[p0:p1].sum())
            leak_sum = cl.rank_sum(p_leak)
            if debug or u_ == 0:
                ab[b, u_] = cl.rank_sum(p_ab)
                gs[b, u_] = cl.rank_sum(p_gs)
            else:
                ab[b, u_] = gs[b, u_] = 1.0
    return objf, gamma, ab, gs


@pytest.mark.parametrize("C", sk.CLUSTERS)
@pytest.mark.parametrize("mode,want", MODES)
def test_cluster_emulation_matches_plain(mode, want, C):
    fa, px, lens = _case(mode)
    assert fa.xsrc_mode == want
    _check_emulation(fa, px, lens, C)


def test_cluster_emulation_with_idle_ranks():
    fa, px, lens = _case("separate", num_phones=10)
    assert fa.s_pad == 128        # 4 slices: ranks 4-7 of 8 own no rows
    _check_emulation(fa, px, lens, 8)


def _check_emulation(fa, px, lens, C):
    ref = forward_backward_prob_fact(px, lens, fa, LEAKY)
    objf, gamma, ab, gs = _emulate_cluster(px, lens, fa, LEAKY, C,
                                           debug=True)
    torch.testing.assert_close(objf, ref.objf, rtol=1e-5, atol=0)
    torch.testing.assert_close(gamma, ref.gamma, rtol=0, atol=1e-5)
    torch.testing.assert_close(ab, ref.alpha_beta, rtol=0, atol=1e-5)
    torch.testing.assert_close(gs, ref.gamma_sum, rtol=0, atol=1e-5)


def test_cluster_graph_packs_the_pdf_lists():
    """Packed ids name each state's owner and local row; the sparse rows
    are B1/B2's own; E_g^T's lists hold only states with a W2 out-arc."""
    fa, _, _ = _case("separate")
    kg = fk.kernel_graph(fa)
    w2_src = set(fk._coo(fa.w2)[1].tolist())
    assert set(kg.g_lists[1].tolist()) == w2_src
    assert len(w2_src) < fa.s_pad
    for C in sk.CLUSTERS:
        ckg = sk.cluster_graph(kg, C)
        assert ckg.w1 is kg.w1 and ckg.w2t is kg.w2t
        packed = ckg.f_lists[1].long()
        owner = packed >> sk.LOCAL_BITS
        local = packed & ((1 << sk.LOCAL_BITS) - 1)
        state = ((local // fk.SLICE) * C + owner) * fk.SLICE \
            + local % fk.SLICE
        assert torch.equal(state, kg.f_lists[1].long())
        assert int(owner.max()) < C
        assert int(local.max()) < sk.rows_per_cta(fa.s_pad, C)


def test_cpu_wrapper_takes_plain_path_without_launching():
    fa, px, lens = _case("cross")
    sk.reset_launch_counts()
    got = sk.forward_backward_prob_stream(px, lens, fa, LEAKY, debug=False)
    assert sk.LAUNCHES == {"stream_fwd": 0, "stream_bwd": 0}
    ref = fk._frame0_traces(forward_backward_prob_fact(px, lens, fa, LEAKY))
    for name in ("objf", "gamma", "alpha_beta", "gamma_sum"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   rtol=0, atol=0)


# ----------------------------------------------------------------------
# Tiering and budgets
# ----------------------------------------------------------------------

def test_dispatch_tiering(monkeypatch):
    """pychain_tpu's test_dispatch_tiering with the port's functions: past
    the resident kernels the cluster tier, past the cluster limit
    NotImplementedError on CUDA (the plain version on the CPU); _run takes
    the tier at each call, from the graph's own arrays."""
    fa, px, lens = _case("source")
    on_card = types.SimpleNamespace(device=torch.device("cuda"),
                                    res_src=fa.res_src, s_pad=fa.s_pad,
                                    xsrc_mode=fa.xsrc_mode)
    taken = []

    def spy(tag, fn):
        def run(*args, **kwargs):
            taken.append(tag)
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(fk, "forward_backward_prob_kernel",
                        spy("pallas", fk.forward_backward_prob_kernel))
    monkeypatch.setattr(sk, "forward_backward_prob_stream",
                        spy("stream", sk.forward_backward_prob_stream))

    def engine(g, impl="auto"):
        taken.clear()
        pt_loss._run(torch.log(px), lens, pt_loss.dispatch_arrays(g, impl),
                     LEAKY, impl)
        return taken[0] if taken else "xla"

    assert pt_loss.den_engine(fa) == "pallas"
    assert engine(fa) == "pallas" and engine(fa, "factorized") == "xla"
    monkeypatch.setattr(fk, "fits_on_chip", lambda *a, **k: False)
    assert pt_loss.den_engine(on_card) == "stream"
    assert pt_loss.dispatch_arrays(fa, "pallas") is fa
    assert engine(fa, "pallas") == "stream"
    monkeypatch.setattr(sk, "fits_stream", lambda *a, **k: False)
    with pytest.raises(NotImplementedError, match="cluster of 8 CTAs"):
        pt_loss.den_engine(on_card)
    assert pt_loss.den_engine(fa) == "xla" and engine(fa) == "xla"
    # an explicit engine is honoured; impl="factorized" is the plain one
    for forced in ("stream", "pallas"):
        g = dataclasses.replace(fa, engine=forced)
        assert pt_loss.dispatch_arrays(g) is g
        assert engine(g) == forced and engine(g, "factorized") == "xla"


def test_tiers_of_the_repo_graphs_by_arithmetic():
    """Main path 4's graph (denominator_fst(6000, 2, num_pdfs=3000,
    bigram_fanout=30, forward_pdf_mode="separate"): S = 12,000, S_pad =
    12,032, x_src "stream") is past the resident kernels and runs on a
    cluster of 2; bench.py --s8k's (S = 8,000 "source", S_pad = 8,064)
    fits them; a cluster of 8 CTAs ends at S_pad 24,320."""
    main4 = types.SimpleNamespace(s_pad=12032, xsrc_mode="stream")
    assert fk.smem_bytes(main4) == {"fact_fwd": 192644, "fact_bwd": 241036}
    assert not fk.fits_on_chip(main4)
    assert sk.cluster_size(main4) == 2
    assert sk.rows_per_cta(12032, 2) == 6016
    assert sk.smem_bytes(main4, 2) == {
        "stream_fwd": (2 * 12032 + 2 * 6016 + 34) * 4,
        "stream_bwd": (2 * 12032 + 3 * 6016 + 102) * 4}
    s8k = types.SimpleNamespace(s_pad=8064, xsrc_mode="identity")
    assert fk.fits_on_chip(s8k) and sk.cluster_size(s8k) == 1
    edge = lambda s_pad: types.SimpleNamespace(s_pad=s_pad,
                                               xsrc_mode="stream")
    assert sk.cluster_size(edge(24320)) == 8
    assert sk.cluster_size(edge(24448)) is None


def test_card_budget_admits_full_mode(monkeypatch):
    """The S = 10,000 separate-pdf graph (S_pad 10,112) at B = 128,
    T = 500 keeps four float32 streams of 2.59 GB (10.4 GB): "full" under
    an 80 GB card's budget (40%, stream_budget), not under the JAX
    package's fixed 4 GiB, and the wrappers raise past the budget."""
    budget = int(80e9 * 0.40)
    assert 4 * 500 * 10112 * 128 * 4 == 10_354_688_000
    assert fk.select_stream_mode(500, 10112, 128, 4, 4, budget) == "full"
    assert fk.select_stream_mode(500, 10112, 128, 4, 4) == "lean"
    fa = types.SimpleNamespace(s_pad=10112, xsrc_mode="stream")
    fk.require_full_mode(500, fa, 128, budget)
    with pytest.raises(NotImplementedError, match="'lean'"):
        fk.require_full_mode(500, fa, 128, fk.STREAM_BUDGET)
    with pytest.raises(NotImplementedError, match="'ckpt'"):
        fk.require_full_mode(3700, fa, 128, fk.STREAM_BUDGET)
    card = types.SimpleNamespace(total_memory=80 * 10 ** 9)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: card)
    assert fk.stream_budget("cuda") == budget
    with pytest.raises(ValueError, match="no CUDA device"):
        fk.stream_budget("cpu")


def test_forced_cluster_size_past_the_limit_raises():
    fa, _, _ = _case("separate")
    with pytest.raises(NotImplementedError, match="cluster 3"):
        sk._cluster(fa, 3)
    assert sk._cluster(fa, None) == 1 and sk._cluster(fa, 8) == 8
