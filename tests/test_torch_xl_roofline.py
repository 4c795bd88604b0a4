"""The port's XL roofline probe (pychain_tpu_torch/tools/xl_roofline.py)
against the JAX tool (tools/xl_roofline.py, its Pallas kernels T1/T2 in
interpret mode on the CPU), and emulations of the two CUDA kernels on the
arrays they read.

Tolerances: the f32 forms agree with JAX to 1e-5 relative (the tool's
max(|ref|, 1e-9) floor): the same recurrence, sums taken in another
order.  The bf16 form rounds the carry and contrib to bf16 before each
product, as the TPU's DEFAULT precision does; JAX's interpret mode on the
CPU does not round them (its mxu_bf16 lands within 1e-6 of its vpu), so
there the bf16 form is held to a numpy recurrence that rounds, and to
JAX's interpret run only within 2e-2 and at least 1e-4 apart.
"""

import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pychain_tpu_torch.tools import xl_roofline as xr

ROOT = Path(__file__).resolve().parents[1]
CASES = {"s64": (64, 192, 16, 2, 0), "s100": (100, 250, 12, 2, 1)}


@functools.lru_cache(maxsize=None)
def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_xl_roofline", ROOT / "tools" / "xl_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(name):
    """(src, dst, w, S, T) as numpy; state 0 has no in-arc."""
    S, K, T, B, seed = CASES[name]
    rng = np.random.RandomState(seed)
    src = rng.randint(0, S, (B, K)).astype(np.int32)
    dst = rng.randint(0, S, (B, K)).astype(np.int32)
    dst[dst == 0] = 1
    w = rng.rand(K).astype(np.float32) + 0.1
    return src, dst, w, S, T


@functools.lru_cache(maxsize=None)
def _jax(name, form):
    """The JAX tool's carry (B, S) for a case, Pallas in interpret mode."""
    jt = _jax_tool()
    src, dst, w, S, T = _case(name)
    B, K = src.shape
    make = {"vpu": lambda: jt.make_vpu(S, K, jnp.float32),
            "mxu_f32": lambda: jt.make_mxu(S, K, jnp.float32,
                                           jax.lax.Precision.HIGHEST),
            "mxu_bf16": lambda: jt.make_mxu(S, K, jnp.bfloat16,
                                            jax.lax.Precision.DEFAULT)}
    run = make[form]()
    y = jax.jit(lambda a, b, c: run(a, b, c, B, T))(src, dst, w)
    return np.asarray(y).reshape(B, S)


def _port(name, form):
    src, dst, w, S, T = _case(name)
    xr.reset_launch_counts()
    y = xr.RUNNERS[form](torch.from_numpy(src), torch.from_numpy(dst),
                         torch.from_numpy(w), S, T)
    assert xr.LAUNCHES == {k: 0 for k in xr.LAUNCHES}   # CPU: plain only
    return y.numpy()


def _rel(y, ref):
    return float(np.max(np.abs(y.astype(np.float64) - ref)
                        / np.maximum(np.abs(ref), 1e-9)))


def _bf16(x):
    """float32 -> bfloat16 (round to nearest even) -> float32, in numpy."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def _numpy_recurrence(src, dst, w, S, T, bf16):
    """The recurrence in numpy float32; with bf16, the carry and contrib
    rounded to bf16 before each product.  Sum a is taken in float64 and
    rounded once, as the port takes it (order-free)."""
    B = src.shape[0]
    nc = np.full((B, S), np.float32(1.0 / S), np.float32)
    for _ in range(T):
        carry = _bf16(nc) if bf16 else nc
        a = np.zeros((B, S), np.float32)
        for b in range(B):
            contrib = carry[b, src[b]] * w
            np.add.at(a[b], dst[b], _bf16(contrib) if bf16 else contrib)
        raw = np.maximum(a.sum(1, keepdims=True, dtype=np.float64)
                         .astype(np.float32), np.float32(xr.TINY))
        nc = a * (np.float32(1.0) / raw)
    return nc


# ----------------------------------------------------------------------
# The plain versions against the JAX tool
# ----------------------------------------------------------------------

@pytest.mark.parametrize("form", ["vpu", "mxu_f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_forms_match_jax(name, form):
    got = _port(name, form)
    assert got.shape == _jax(name, form).shape
    assert np.all(np.isfinite(got))
    assert _rel(got, _jax(name, form)) <= 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_form_rounds_as_the_tpu(name):
    got = _port(name, "mxu_bf16")
    src, dst, w, S, T = _case(name)
    assert _rel(got, _numpy_recurrence(src, dst, w, S, T, True)) <= 1e-6
    # JAX's interpret mode does not round the f32 carry to bf16 (on a TPU
    # DEFAULT precision does): its bf16 form is its f32 form to 1e-6, so a
    # port that rounds lands between 1e-4 and 2e-2 from it
    assert _rel(_jax(name, "mxu_bf16"), _jax(name, "vpu")) <= 1e-6
    assert 1e-4 <= _rel(got, _jax(name, "mxu_bf16")) <= 2e-2


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_carry_does_not_depend_on_the_order_of_the_sums(name):
    """What lets the bf16 kernel match its plain version bit for bit: its
    per-state sums of a few bf16 values are exact in float32, and sum a is
    taken in float64, so no order of summation changes the carry."""
    src, dst, w, S, T = _case(name)
    ref = _port(name, "mxu_bf16")
    for perm in (np.arange(src.shape[1])[::-1],
                 np.random.RandomState(3).permutation(src.shape[1])):
        got = xr.plain("mxu_bf16", *(torch.from_numpy(a[..., perm].copy())
                                     for a in (src, dst, w)), S, T)
        assert np.array_equal(got.numpy(), ref)


def _bf16_carry(normaliser, S=1000, K=3200, T=512, B=8):
    """The bf16 form's carry at the tool's default size, sum a taken by
    ``normaliser(a) -> (B, 1) float32``."""
    src, dst, w = xr.inputs(S, K, B, device="cpu")
    rows = torch.arange(B).unsqueeze(1) * S
    flat_src = (src.long() + rows).reshape(-1)
    flat_dst = (dst.long() + rows).reshape(-1)
    wb = w.expand(B, K).reshape(-1)
    nc = torch.full((B, S), 1.0 / S)
    for _ in range(T):
        contrib = xr._bf16(xr._bf16(nc).reshape(-1)[flat_src] * wb)
        a = torch.zeros(B * S).index_add_(0, flat_dst, contrib).view(B, S)
        nc = a * (1.0 / normaliser(a).clamp(min=xr.TINY))
    return nc


def test_float32_sum_order_moves_the_bf16_carry():
    """Why the port sums a in float64: in float32 the order of that one sum
    (pairwise or sequential) moves the bf16 carry by more than the 5e-3
    the card holds the bf16 kernel to; in float64 no order does."""
    pairwise = _bf16_carry(lambda a: a.sum(1, keepdim=True))
    sequential = _bf16_carry(lambda a: a.cumsum(1)[:, -1:])
    assert xr.rel_diff(sequential, pairwise) > 5e-3
    f64 = _bf16_carry(lambda a: a.double().sum(1, keepdim=True).float())
    f64_reversed = _bf16_carry(
        lambda a: a.double().flip(1).cumsum(1)[:, -1:].float())
    assert torch.equal(f64, f64_reversed)


# ----------------------------------------------------------------------
# The kernels' algorithms on the arrays they read
# ----------------------------------------------------------------------

def _np(plan):
    """A plan's or operands' tensors as numpy arrays (ints kept)."""
    return type(plan)(*(a.numpy() if isinstance(a, torch.Tensor) else a
                        for a in plan))


def _thread_slots(plan, b):
    """Row b's arcs as xl_vpu's threads hold them: (R, threads) sources
    (bit 31: last in-arc) and weights.  Without register slots, each
    thread's run of the arcs in shared memory, padded as slots are."""
    if plan.slots:
        return plan.src[b], plan.w[b]
    toff = plan.toff[b]
    count = np.diff(toff)
    r = np.arange(max(int(count.max()), 1))[:, None]
    live = r < count[None, :]
    idx = np.minimum(toff[None, :-1] + r, plan.kc - 1)
    zero_slot = int(plan.tbeg[b, -1])                  # S
    return (np.where(live, plan.src[b][idx], zero_slot),
            np.where(live, plan.w[b][idx], np.float32(0)))


def _vpu_total(part, nwarps):
    """The compute threads' float64 partials as xl_vpu's warps add them:
    lane l adds those of threads l, l + 32, ... in order, then an xor
    butterfly."""
    lanes = np.zeros(32)
    for i in range(nwarps):
        lanes = lanes + part[32 * i:32 * i + 32]
    return _butterfly(lanes)


def _emulate_vpu(plan, S, T):
    """xl_vpu: each thread walks its slots in order; a state's in-arcs'
    products, each rounded, are summed in float32 and the sum scaled by c:
    b_{t+1}[s] = (sum b_t[src] w) * c_t, with c_0 = 1 and c_t = 1 / sum
    b_{t-1} (the summing warp's, a frame late); the carry is b_T * (1 /
    sum b_T).  Each thread adds its states' b to a float64 partial in
    order (b_0's: its states times 1/S); sums of b are totals of those
    (_vpu_total)."""
    B = plan.tbeg.shape[0]
    nt = plan.threads
    out = np.empty((B, S), np.float32)
    init = np.float32(1.0 / S)
    for b in range(B):
        E, W = _thread_slots(plan, b)
        src = E & 0x7FFFFFFF
        last = E < 0
        a = np.zeros(S + 1, np.float32)
        a[:S] = init
        part = np.diff(plan.tbeg[b]).astype(np.float64) * np.float64(init)
        scale = [np.float32(1.0), None]           # the two scale slots
        for t in range(T):
            # the summing warp: frame t + 1's scale from b_t's partials
            scale[(t + 1) % 2] = np.float32(1.0) / max(
                np.float32(_vpu_total(part, nt // 32)), np.float32(xr.TINY))
            c = scale[t % 2]
            v = a[src]
            nxt = np.zeros(S + 1, np.float32)
            acc = np.zeros(nt, np.float32)
            s = plan.tbeg[b, :nt].astype(np.int64).copy()
            part = np.zeros(nt)
            for r in range(E.shape[0]):
                acc = acc + v[r] * W[r]
                m = last[r]
                x = acc[m] * c
                nxt[s[m]] = x
                part[m] += x
                s[m] += 1
                acc[m] = 0
            a = nxt
        inv = (np.float32(1.0) / max(np.float32(_vpu_total(part, nt // 32)),
                                     np.float32(xr.TINY))
               if T > 0 else np.float32(1.0))
        out[b] = a[:S] * inv
    return out


def _pad_arcs(src, dst, k_pad):
    """src, dst in arc order, padded with -1 to k_pad (the dense masks'
    columns and rows)."""
    B, K = src.shape
    src_p = np.full((B, k_pad), -1, np.int32)
    dst_p = np.full((B, k_pad), -1, np.int32)
    src_p[:, :K], dst_p[:, :K] = src, dst
    return src_p, dst_p


def _fragment_masks(src_p, dst_p, s_pad):
    """The dense masks of the dense form, rebuilt lane by lane from its
    compares over every fragment: ohs (S_pad, K_pad) of the first product
    and ohd^T (K_pad, S_pad) of the second, arcs in arc order."""
    k_pad = src_p.shape[0]
    ohs = np.zeros((s_pad, k_pad), np.float32)
    ohd_t = np.zeros((k_pad, s_pad), np.float32)
    rows = (0, 1, 8, 9)          # a lane's rows of the tile: + 2 tig
    for g in range(8):
        for tig in range(4):
            for n in range(k_pad // 8):       # first product: arc tiles
                for s0 in range(0, s_pad, 16):
                    r = src_p[8 * n + g] - 2 * tig - s0
                    for row in rows:
                        if r == row:
                            ohs[s0 + 2 * tig + row, 8 * n + g] = 1.0
            for n in range(s_pad // 8):       # second product: state tiles
                s = 8 * n + g
                for k0 in range(0, k_pad, 16):
                    for row in rows:
                        k = k0 + 2 * tig + row
                        if dst_p[k] == s:
                            ohd_t[k, s] = 1.0
    return ohs, ohd_t


def _issued(tiles):
    """(n-tile, k-slab) of each fragment a tile list issues."""
    return [(n, q) for n, (first, count) in enumerate(tiles)
            for q in range(first, first + count)]


def _listed_masks(ops, b, s_pad):
    """The masks xl_mxu's issued fragments hold, rebuilt from its compares
    in the sorted orders: ohs (S_pad, K_pad) over src-order arcs (the
    first product's A tiles: lane (g, tig) holds arcs 16 n + g and + 8
    against states 2 tig + {0, 1, 8, 9} of the slab) and ohd^T (K_pad,
    S_pad) over dst-order arcs (the second's A tiles: states 16 m + g and
    + 8 against arcs 2 tig + {0, 1, 8, 9} of the slab)."""
    k_pad = ops.src_s.shape[1]
    ohs = np.zeros((s_pad, k_pad), np.float32)
    ohd_t = np.zeros((k_pad, s_pad), np.float32)
    for n, q in _issued(ops.tiles1[b]):
        for g in range(8):
            for tig in range(4):
                for arc in (16 * n + g, 16 * n + g + 8):   # A rows g, g + 8
                    r = ops.src_s[b, arc] - 16 * q - 2 * tig
                    for col in (0, 1, 8, 9):
                        if r == col:
                            ohs[16 * q + 2 * tig + col, arc] = 1.0
    for m, p in _issued(ops.tiles2[b]):
        for g in range(8):
            for tig in range(4):
                for state in (16 * m + g, 16 * m + g + 8):  # A rows g, g + 8
                    for col in (0, 1, 8, 9):
                        k = 16 * p + 2 * tig + col
                        if ops.dst_d[b, k] == state:
                            ohd_t[k, state] = 1.0
    return ohs, ohd_t


def _terms(x, split):
    """x as split bf16 terms, each the rounding of what the others left."""
    out = []
    for _ in range(split):
        h = _bf16(x)
        out.append(h)
        x = (x - h).astype(np.float32)
    return out


def _butterfly(v):
    """An xor butterfly over len(v) values (a power of two), float64: what
    every lane holds after it."""
    lanes = np.arange(len(v))
    off = len(v) // 2
    while off:
        v = v + v[lanes ^ off]
        off //= 2
    return v[0]


def _mxu_inv(red):
    """1 / max(sum of the warps' partials, 1e-30): a 32-lane butterfly,
    lanes past the warps holding 0."""
    return np.float32(1.0) / max(np.float32(_butterfly(red)),
                                 np.float32(xr.TINY))


MXU_WARPS = 16          # xl_mxu's warps a row (XL_MXU_WARPS in the source)


def _emulate_mxu(ops, S, T, split, warps=MXU_WARPS):
    """xl_mxu on its operands: per frame the carry's terms from a * inv,
    the first product over tiles1's fragments (columns 0 .. split - 1:
    one term each; each arc's one nonzero, so exact), asel = (hi + mid) +
    lo, contrib = asel * w and its terms moved to dst order by perm; the
    second product over tiles2's fragments, each fragment's 16 products
    summed in float64 and added to the float32 accumulator (the card's
    accumulation rounds once a fragment here), a = (hi + mid) + lo; sum a
    as the kernel's warps take it (each lane its states in order, a
    butterfly in the warp, a 32-lane butterfly over the warps'
    partials)."""
    B, k_pad = ops.src_s.shape
    s_pad = -(-S // 16) * 16
    n2 = s_pad // 16
    out = np.empty((B, S), np.float32)
    for b in range(B):
        a = np.zeros(s_pad, np.float32)
        a[:S] = np.float32(1.0 / S)
        inv = np.float32(1.0)
        red = None
        for t in range(T):
            if t > 0:
                inv = _mxu_inv(red)
            nc = np.stack(_terms(a * inv, split))             # (split, S_pad)
            st1 = np.zeros((split, k_pad), np.float32)
            for n, q in _issued(ops.tiles1[b]):
                cols = 16 * n + np.arange(16)
                r = ops.src_s[b, cols] - 16 * q
                hit = (r >= 0) & (r < 16)
                st1[:, cols[hit]] += nc[:, 16 * q + r[hit]]
            asel = st1[0]
            for i in range(1, split):
                asel = asel + st1[i]
            ct = np.stack(_terms(asel * ops.w_s[b], split))
            ct_d = np.zeros_like(ct)
            ct_d[:, ops.perm[b]] = ct
            st2 = np.zeros((split, s_pad), np.float32)
            for m, p in _issued(ops.tiles2[b]):
                ks = 16 * p + np.arange(16)
                for state in range(16 * m, 16 * m + 16):
                    hit = ops.dst_d[b, ks] == state
                    st2[:, state] = (st2[:, state].astype(np.float64)
                                     + ct_d[:, ks[hit]].astype(np.float64)
                                     .sum(1)).astype(np.float32)
            a = st2[0]
            for i in range(1, split):
                a = a + st2[i]
            red = np.zeros(32)
            for wp in range(warps):
                lanes = np.zeros(32)      # lane 4 g: states 16 m + g, + 8
                for m in range(wp * n2 // warps, (wp + 1) * n2 // warps):
                    for g in range(8):
                        lanes[4 * g] += a[16 * m + g]
                        lanes[4 * g] += a[16 * m + g + 8]
                red[wp] = _butterfly(lanes)
        if T > 0:
            inv = _mxu_inv(red)
        out[b] = (a * inv)[:S]
    return out


def _torch_case(name):
    src, dst, w, S, T = _case(name)
    return (torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(w), S, T)


def _hub_case():
    """A batch whose state 5 takes 40 in-arcs in row 0 (no register slots
    hold its run), states without in-arcs, K not a multiple of 16."""
    S, K, B = 50, 170, 2
    rng = np.random.RandomState(7)
    src = rng.randint(0, S, (B, K)).astype(np.int32)
    dst = rng.randint(0, S, (B, K)).astype(np.int32)
    dst[0, :40] = 5
    dst[dst == 0] = 1
    w = rng.rand(K).astype(np.float32) + 0.1
    return src, dst, w, S, 9


@pytest.mark.parametrize("name", sorted(CASES))
def test_vpu_kernel_emulation_matches_plain(name):
    src, dst, w, S, T = _case(name)
    plan = _np(xr.vpu_plan(*_torch_case(name)[:3], S))
    got = _emulate_vpu(plan, S, T)
    assert _rel(got, _port(name, "vpu")) <= 1e-6


def _plan_at(monkeypatch, args, S, warps):
    """vpu_plan's plan with ``warps`` compute warps a row, where vpu_warps
    would give the count for K."""
    monkeypatch.setattr(xr, "vpu_warps", lambda K: warps)
    return xr.vpu_plan(*args, S)


@pytest.mark.parametrize("warps", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", sorted(CASES) + ["hub"])
def test_vpu_plan_deals_every_arc_once(monkeypatch, name, warps):
    """Each thread owns a contiguous run of whole states and holds their
    in-arcs in CSR order (ascending arc id), the last one flagged; a state
    without in-arcs has one arc from the zero slot S with weight 0; pad
    slots read the zero slot; the arcs are in register slots where every
    run fits them, else in shared memory."""
    src, dst, w, S, T = _hub_case() if name == "hub" else _case(name)
    plan = _np(_plan_at(monkeypatch, [torch.from_numpy(a)
                                      for a in (src, dst, w)], S, warps))
    nt = plan.threads
    assert nt == 32 * warps
    runs = np.diff(plan.toff, axis=1)
    need = runs.max()
    assert plan.slots == (xr.VPU_SLOTS if need <= xr.VPU_SLOTS else 0)
    if name == "hub":
        assert plan.slots == 0 and need >= 40
    for b in range(src.shape[0]):
        tbeg = plan.tbeg[b]
        assert tbeg[0] == 0 and tbeg[-1] == S and np.all(np.diff(tbeg) >= 0)
        E, W = _thread_slots(plan, b)
        want_src, want_w, want_last = [], [], []
        for s in range(S):                     # CSR order with the dummies
            ids = np.flatnonzero(dst[b] == s)
            if len(ids) == 0:
                want_src.append([S]), want_w.append([0.0])
            else:
                want_src.append(src[b, ids]), want_w.append(w[ids])
            want_last += [False] * (max(len(ids), 1) - 1) + [True]
        got_src, got_w, got_last = [], [], []
        for i in range(nt):
            n = runs[b, i]
            assert np.sum(E[:, i] < 0) == tbeg[i + 1] - tbeg[i]
            got_src += list(E[:n, i] & 0x7FFFFFFF)
            got_w += list(W[:n, i])
            got_last += list(E[:n, i] < 0)
            assert np.all(E[n:, i] == S) and np.all(W[n:, i] == 0)
        np.testing.assert_array_equal(got_src, np.concatenate(want_src))
        np.testing.assert_array_equal(got_w, np.concatenate(want_w))
        np.testing.assert_array_equal(got_last, want_last)


@pytest.mark.parametrize("name", sorted(CASES) + ["hub"])
def test_vpu_carry_does_not_depend_on_the_warps(monkeypatch, name):
    """Every warp count that vpu_warps gives deals the same CSR sums and
    takes sum b in float64, rounded once: the emulated kernel's carry is
    bit for bit the same at 1 to 16 warps, in register slots and in shared
    memory, and within 1e-6 of the plain version."""
    src, dst, w, S, T = _hub_case() if name == "hub" else _case(name)
    args = [torch.from_numpy(a) for a in (src, dst, w)]
    outs = [_emulate_vpu(_np(_plan_at(monkeypatch, args, S, warps)), S, T)
            for warps in (1, 2, 4, 8, 16)]
    for got in outs[1:]:
        np.testing.assert_array_equal(got, outs[0])
    assert _rel(outs[0], xr.recurrence_plain(*args, S, T).numpy()) <= 1e-6


def test_vpu_default_warps():
    assert [xr.vpu_warps(k) for k in (1, 512, 513, 3200, 8192, 8193,
                                      10 ** 6)] == [1, 1, 2, 8, 16, 16, 16]
    src, dst, w = xr.inputs(1000, 3200, 2, device="cpu")
    plan = xr.vpu_plan(src, dst, w, 1000)
    assert (plan.threads, plan.slots) == (32 * 8, 24)


@pytest.mark.parametrize("form,split", [("mxu_f32", 3), ("mxu_bf16", 1)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mxu_kernel_emulation_matches_plain(name, form, split):
    src, dst, w, S, T = _torch_case(name)
    ops = _np(xr.mxu_operands(src, dst, w, S))
    assert ops.src_s.shape[1] % 16 == 0 and ops.src_s.shape[1] >= src.shape[1]
    got = _emulate_mxu(ops, S, T, split)
    assert _rel(got, _port(name, form)) <= (1e-5 if split == 3 else 1e-6)


@pytest.mark.parametrize("name", sorted(CASES) + ["hub"])
def test_mxu_tile_lists_issue_every_nonzero(name):
    """The masks of the fragments the tile lists issue, mapped back to arc
    order, are the dense form's masks: no nonzero is skipped, and the
    padding arcs (-1) land in no fragment."""
    src, dst, w, S, T = _hub_case() if name == "hub" else _case(name)
    B, K = src.shape
    ops = _np(xr.mxu_operands(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(w), S))
    k_pad, s_pad = ops.src_s.shape[1], -(-S // 16) * 16
    src_p, dst_p = _pad_arcs(src, dst, k_pad)
    for b in range(B):
        by_src = np.argsort(src[b], kind="stable")
        by_dst = np.argsort(dst[b], kind="stable")
        ohs, ohd_t = _listed_masks(ops, b, s_pad)
        assert not ohs[:, K:].any() and not ohd_t[K:].any()
        ohs_arc = np.zeros_like(ohs)
        ohs_arc[:, by_src] = ohs[:, :K]
        ohd_arc = np.zeros_like(ohd_t)
        ohd_arc[by_dst] = ohd_t[:K]
        want_ohs, want_ohd = _fragment_masks(src_p[b], dst_p[b], s_pad)
        np.testing.assert_array_equal(ohs_arc, want_ohs)
        np.testing.assert_array_equal(ohd_arc, want_ohd)
        # tiles wholly of padding issue nothing
        assert not ops.tiles1[b, -(-K // 16):, 1].any()


@pytest.mark.parametrize("name", sorted(CASES) + ["hub"])
def test_mxu_permutation_round_trips(name):
    """src_s, w_s are the arcs by a stable sort on src, dst_d by one on
    dst, and perm sends each src-order position to the same arc's
    dst-order position (padding to itself)."""
    src, dst, w, S, T = _hub_case() if name == "hub" else _case(name)
    B, K = src.shape
    ops = _np(xr.mxu_operands(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(w), S))
    k_pad = ops.src_s.shape[1]
    for b in range(B):
        by_src = np.argsort(src[b], kind="stable")
        by_dst = np.argsort(dst[b], kind="stable")
        np.testing.assert_array_equal(ops.src_s[b, :K], src[b, by_src])
        np.testing.assert_array_equal(ops.w_s[b, :K], w[by_src])
        np.testing.assert_array_equal(ops.dst_d[b, :K], dst[b, by_dst])
        assert (ops.src_s[b, K:] == -1).all() and (ops.dst_d[b, K:] == -1) \
            .all() and (ops.w_s[b, K:] == 0).all()
        perm = ops.perm[b]
        np.testing.assert_array_equal(np.sort(perm), np.arange(k_pad))
        np.testing.assert_array_equal(by_dst[perm[:K]], by_src)
        np.testing.assert_array_equal(perm[K:], np.arange(K, k_pad))
        # and back: the dst-order arcs through the inverse are src order
        back = np.empty(k_pad, np.int64)
        back[perm] = np.arange(k_pad)
        np.testing.assert_array_equal(ops.src_s[b, back[:K]],
                                      src[b, by_dst])


def test_issued_fragments_at_the_default_size():
    """At the tool's default size the lists hold some 260 fragments a frame
    and row in either product (the dense form 12,600 each), under a
    twentieth of the dense form's operations."""
    S, K, B = 1000, 3200, 8
    ops = xr.mxu_operands(*xr.inputs(S, K, B, device="cpu"), S)
    first, second = xr.issued_fragments(ops)
    assert 220 * B <= first <= 300 * B and 220 * B <= second <= 300 * B
    s_pad, k_pad = 1008, 3200
    dense = 4 * s_pad * k_pad * B
    assert dense == 2 * (k_pad // 16) * (s_pad // 16) * B * 2 * 16 * 16
    assert xr.issued_ops(ops) <= dense / 20


def test_three_bf16_terms_hold_a_float32_exactly():
    rng = np.random.RandomState(0)
    x = (rng.randn(10000) * 10.0 ** rng.randint(-30, 30, 10000)) \
        .astype(np.float32)
    hi, mid, lo = _terms(x, 3)
    np.testing.assert_array_equal(
        (hi.astype(np.float64) + mid + lo).astype(np.float32), x)
    np.testing.assert_array_equal(                     # torch rounds alike
        hi, torch.from_numpy(x).to(torch.bfloat16).float().numpy())


# ----------------------------------------------------------------------
# The tool
# ----------------------------------------------------------------------

def test_inputs_are_the_tools_draws():
    src, dst, w = xr.inputs(30, 70, 3, device="cpu")
    rng = np.random.RandomState(0)      # tools/xl_roofline.py:157-160
    np.testing.assert_array_equal(src.numpy(), rng.randint(0, 30, (3, 70)))
    np.testing.assert_array_equal(dst.numpy(), rng.randint(0, 30, (3, 70)))
    np.testing.assert_array_equal(w.numpy(),
                                  rng.rand(70).astype(np.float32) + 0.1)
    assert src.dtype == dst.dtype == torch.int32


def test_json_line_and_flags(capsys):
    out = xr.main(["--device", "cpu", "--s", "20", "--k", "45", "--t", "3",
                   "--b", "2", "--iters", "1"])
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["config"] == {"S": 20, "K": 45, "T": 3, "B": 2}
    assert line["device"]["platform"] == "cpu"
    assert list(line["results"]) == list(xr.FORMS)
    for res in line["results"].values():
        assert set(res) == {"compile_s", "ms_per_call", "us_per_frame"}
        assert res["ms_per_call"] > 0
    assert "[mxu_f32] carry rel diff vs vpu after 3 frames" in cap.err
    assert "[mxu_bf16] carry rel diff vs vpu after 3 frames" in cap.err


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xr.probe(20, 45, 2, 1, 1, device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xr.main(["--s", "20", "--k", "45", "--t", "2", "--b", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xr.inputs(10, 16, 2)


def test_runners_reject_bad_inputs():
    src, dst, w = xr.inputs(10, 16, 2, device="cpu")
    for run in xr.RUNNERS.values():
        with pytest.raises(ValueError, match="lie in"):
            run(src, dst, w, 5, 2)                     # ids past S
        with pytest.raises(ValueError, match="int32"):
            run(src.long(), dst, w, 10, 2)
        with pytest.raises(ValueError, match="float32"):
            run(src, dst, w.double(), 10, 2)


@pytest.mark.parametrize("scale", [1e20, 1e-20])
@pytest.mark.parametrize("name", sorted(CASES))
def test_vpu_refuses_a_growth_its_late_scale_cannot_keep(name, scale):
    """Weights that put a frame's growth past [1e-19, 1e19]: xl_vpu and the
    tool's kernel_call refuse them on the CPU too, while the kernel's
    emulation on its plan leaves the plain version (its stored sum g^2
    overflows or goes subnormal in float32); the other forms take them."""
    src, dst, w, S, T = _torch_case(name)
    w = w * scale
    lo, hi = (float(v) for v in xr.growth_bounds(src, w, S))
    assert not xr.VPU_GROWTH[0] <= lo <= hi <= xr.VPU_GROWTH[1]
    with pytest.raises(ValueError, match="a frame late"):
        xr.xl_vpu(src, dst, w, S, T)
    with pytest.raises(ValueError, match="a frame late"):
        xr.kernel_call("vpu", src, dst, w, S, T)
    ref = xr.plain("vpu", src, dst, w, S, T).numpy()
    assert np.isfinite(ref).all()
    with np.errstate(all="ignore"):
        got = _emulate_vpu(_np(xr.vpu_plan(src, dst, w, S)), S, T)
        assert not _rel(got, ref.astype(np.float64)) <= 1e-3
    for form in ("mxu_f32", "mxu_bf16"):
        assert np.isfinite(xr.RUNNERS[form](src, dst, w, S, T).numpy()).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_vpu_growth_bounds_hold_the_plain_growth(name):
    """growth_bounds brackets every frame's growth of the plain recurrence
    at the tests' and the tool's draws, which xl_vpu takes; a negative
    weight is refused."""
    src, dst, w, S, T = _torch_case(name)
    lo, hi = (float(v) for v in xr.growth_bounds(src, w, S))
    B, K = src.shape
    rows = torch.arange(B)[:, None] * S
    nc = torch.full((B, S), 1.0 / S, dtype=torch.float64)
    for _ in range(T):
        a = torch.zeros(B * S, dtype=torch.float64).index_add_(
            0, (dst.long() + rows).reshape(-1),
            (nc.reshape(-1)[(src.long() + rows).reshape(-1)]
             * w.double().expand(B, K).reshape(-1))).view(B, S)
        g = a.sum(1) / nc.sum(1)
        assert bool((g >= lo).all() and (g <= hi).all()), (g, lo, hi)
        nc = a / a.sum(1, keepdim=True)
    assert xr.xl_vpu(src, dst, w, S, T).shape == (B, S)
    xr.xl_vpu(*xr.inputs(100, 320, 2, device="cpu"), 100, 4)
    neg = w.clone()
    neg[3] = -0.5
    with pytest.raises(ValueError, match="w must be >= 0"):
        xr.xl_vpu(src, dst, neg, S, T)
