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
    src, dst, w = xr.inputs(S, K, B)
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

def _emulate_vpu(ptr, in_src, in_w, S, T):
    """xl_vpu: each state sums its in-arcs in CSR order, each product
    rounded, the carry read as a * inv; float32 but for sum a (float64,
    rounded once)."""
    B = ptr.shape[0]
    out = np.empty((B, S), np.float32)
    for b in range(B):
        a = np.full(S, np.float32(1.0 / S), np.float32)
        inv = np.float32(1.0)
        lo, hi = ptr[b, :-1], ptr[b, 1:]
        for _ in range(T):
            prod = (a[in_src[b]] * inv) * in_w[b]
            acc = np.zeros(S, np.float32)
            for d in range(int((hi - lo).max(initial=0))):
                live = lo + d < hi
                acc[live] += prod[(lo + d)[live]]
            a = acc
            inv = np.float32(1.0) / max(np.float32(a.sum(dtype=np.float64)),
                                        np.float32(xr.TINY))
        out[b] = a * inv
    return out


def _fragment_masks(src_p, dst_p, s_pad):
    """The dense masks xl_mxu's B fragments hold, rebuilt lane by lane
    from the kernel's rules: ohs (S_pad, K_pad) of the first product and
    ohd^T (K_pad, S_pad) of the second."""
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


def _terms(x, split):
    """x as split bf16 terms, each the rounding of what the others left."""
    out = []
    for _ in range(split):
        h = _bf16(x)
        out.append(h)
        x = (x - h).astype(np.float32)
    return out


def _emulate_mxu(src_p, dst_p, w_p, S, T, split):
    """xl_mxu: the carry and contrib as bf16 terms through the dense
    fragment masks; the terms' products are exact, the sums taken in
    float64 and rounded to float32 once (the card accumulates in float32)."""
    B, k_pad = src_p.shape
    s_pad = -(-S // 16) * 16
    out = np.empty((B, S), np.float32)
    for b in range(B):
        ohs, ohd_t = _fragment_masks(src_p[b], dst_p[b], s_pad)
        nc = np.zeros(s_pad, np.float32)
        nc[:S] = np.float32(1.0 / S)
        for _ in range(T):
            asel = sum(t.astype(np.float64) @ ohs
                       for t in _terms(nc, split)).astype(np.float32)
            contrib = asel * w_p
            a = sum(t.astype(np.float64) @ ohd_t
                    for t in _terms(contrib, split)).astype(np.float32)
            raw = max(np.float32(a.sum(dtype=np.float64)),
                      np.float32(xr.TINY))
            nc = a * (np.float32(1.0) / raw)
        out[b] = nc[:S]
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_vpu_kernel_emulation_matches_plain(name):
    src, dst, w, S, T = _case(name)
    ptr, in_src, in_w = (t.numpy() for t in xr.vpu_csr(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w),
        S))
    for b in range(src.shape[0]):      # every arc once, grouped by dst
        assert ptr[b, 0] == 0 and ptr[b, -1] == src.shape[1]
        assert ptr[b, 1] == ptr[b, 0]                   # state 0: no in-arc
        order = np.argsort(dst[b], kind="stable")
        np.testing.assert_array_equal(in_src[b], src[b, order])
        np.testing.assert_array_equal(
            np.repeat(np.arange(S), np.diff(ptr[b])), dst[b, order])
    got = _emulate_vpu(ptr, in_src, in_w, S, T)
    assert _rel(got, _port(name, "vpu")) <= 1e-6


@pytest.mark.parametrize("form,split", [("mxu_f32", 3), ("mxu_bf16", 1)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mxu_kernel_emulation_matches_plain(name, form, split):
    src, dst, w, S, T = _case(name)
    src_p, dst_p, w_p = (t.numpy() for t in xr.mxu_operands(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w)))
    assert src_p.shape[1] % 16 == 0 and src_p.shape[1] >= src.shape[1]
    got = _emulate_mxu(src_p, dst_p, w_p, S, T, split)
    assert _rel(got, _port(name, form)) <= (1e-5 if split == 3 else 1e-6)


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
    src, dst, w = xr.inputs(30, 70, 3)
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


def test_runners_reject_bad_inputs():
    src, dst, w = xr.inputs(10, 16, 2)
    for run in xr.RUNNERS.values():
        with pytest.raises(ValueError, match="lie in"):
            run(src, dst, w, 5, 2)                     # ids past S
        with pytest.raises(ValueError, match="int32"):
            run(src.long(), dst, w, 10, 2)
        with pytest.raises(ValueError, match="float32"):
            run(src, dst, w.double(), 10, 2)
