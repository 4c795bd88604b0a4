"""The cluster tier's packed layout (stream_fwd_bf16 / stream_bwd_bf16 at
G = 2 or 4), on the CPU: the kernels' reads emulated on the arrays the
host builds, and the fast forms' shared memory, limits and plan.

* The packed slots (``stream_kernels.packed_operators``, built by
  ``fact_kernels.pack_slots``) give back every slot's column id and value
  exactly, as slot_col / slot_val read them (``unpack_slots``), up to the
  tier's largest S_pad (46,368): every id fits 16 bits and the fast
  values are bfloat16 values.
* The packed vectors: a state's G values rounded to bfloat16 and packed
  (store_packed, and the forward's head, which packs each 16-byte read
  of alpha into 8 bytes) read back by load_packed equal ``round_to`` of
  the float32 values, which the float layout's gathers compute.
* ``smem_bytes`` / ``fits`` / ``plan`` of the fast forms at main path 4
  on an H100's properties (a ``types.SimpleNamespace``), and the tier's
  reach: ``fits_stream`` admits the graphs it admitted before, each on a
  fast plan.

tests/test_torch_card.py holds the kernels to the plain fast version bit
for bit at every plan they build.
"""

import types

import numpy as np
import pytest
import torch

from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.ops import stream_kernels as sk

from test_torch_stream import _case

H100 = types.SimpleNamespace(
    multi_processor_count=132, shared_memory_per_block_optin=232448,
    shared_memory_per_multiprocessor=233472,
    max_threads_per_multi_processor=2048, regs_per_multiprocessor=65536)


def _shape(s_pad, xsrc_mode, fast=True):
    """A graph's sizes and precision alone, as the plan reads them."""
    dt = torch.bfloat16 if fast else torch.float32
    return types.SimpleNamespace(
        s_pad=s_pad, xsrc_mode=xsrc_mode, res_src=torch.zeros(0),
        w1=types.SimpleNamespace(operand_dtype=dt))


MAIN4 = _shape(12032, "stream")
MAIN4_F32 = _shape(12032, "stream", fast=False)


def _bf16_bits(x):
    """The bits of x (float32) rounded to bfloat16, to nearest even."""
    return (x.to(torch.bfloat16).view(torch.int16).to(torch.int64)
            & 0xFFFF)


def _store_packed(X):
    """store_packed on every state: X (S, G) float32 -> (S, G / 2) words,
    column 2j in the low half of word j, 2j + 1 in the high half."""
    b = _bf16_bits(X)
    return b[:, 0::2] | b[:, 1::2] << 16


def _load_packed(words):
    """load_packed on every state: (S, W) words -> (S, 2 W) float32."""
    lo = (words << 16) & 0xFFFFFFFF
    hi = words & 0xFFFF0000
    out = torch.stack([lo, hi], dim=2).reshape(words.shape[0], -1)
    return torch.from_numpy(out.numpy().astype(np.uint32).view(np.float32))


def test_packed_slots_give_back_every_column_and_value():
    """Column ids up to the tier's largest S_pad and bfloat16 values of
    every magnitude the graphs hold (and 0, the padding's) round-trip
    exactly; a column past 16 bits or a value off the bfloat16 grid is
    refused."""
    rng = np.random.RandomState(0)
    col = torch.from_numpy(np.concatenate([
        [0, 1, 46367, 46368, 65535],
        rng.randint(0, 46368, size=4000)]).astype(np.int32))
    val = torch.from_numpy(np.concatenate([
        [0.0, 1.0, 2.0 ** -126, 3.0e38, 0.5],
        rng.rand(4000) * 10.0 ** rng.randint(-30, 5, size=4000)])
        .astype(np.float32)).to(torch.bfloat16).float()
    words = fk.pack_slots(col, val)
    got_col, got_val = fk.unpack_slots(words)
    assert torch.equal(got_col, col) and torch.equal(got_val, val)
    with pytest.raises(ValueError, match="16 bits"):
        fk.pack_slots(torch.tensor([65536]), torch.tensor([1.0]))
    with pytest.raises(ValueError, match="bfloat16"):
        fk.pack_slots(torch.tensor([3]), torch.tensor([1.0 + 2.0 ** -12]))


@pytest.mark.parametrize("mode", ["source", "cross", "separate"])
def test_packed_operators_are_the_fast_operators(mode):
    """The four packed operators hold, slot for slot, the column ids and
    values of the operators the float layout reads (padding (0, 0)
    included), in the same sliced-ELL positions."""
    fa = _case(mode, tile_dtype="bfloat16")[0]
    kg = fk.graph_for(fa)
    packs = sk.packed_operators(kg)
    for op, words in zip(sk.operators(kg), packs):
        assert words.dtype == torch.int32 and words.shape == op[1].shape
        col, val = fk.unpack_slots(words)
        assert torch.equal(col, op[1]) and torch.equal(val, op[2])
    assert sk.packed_for(fa) is sk.packed_for(fa)


@pytest.mark.parametrize("G", [2, 4])
def test_packed_vector_loads_equal_round_to(G):
    """A state's G values stored packed and loaded back are round_to's
    bfloat16 values of the float32 ones, for normal, tiny and huge
    values, ties and zeros; the forward's head packs each 16-byte read of
    4 interleaved floats into the 8 bytes of the same states' words."""
    rng = np.random.RandomState(G)
    S = 96
    x = rng.randn(S, G) * 10.0 ** rng.randint(-38, 38, size=(S, G))
    x[0] = 0.0
    x[1] = 1.0 + 2.0 ** -8            # a tie: to even
    x[2] = 1.0 + 3 * 2.0 ** -8        # a tie: up
    X = torch.from_numpy(x.astype(np.float32))
    words = _store_packed(X)
    assert torch.equal(_load_packed(words), X.to(torch.bfloat16).float())
    # the head: float4 q of the (S, G) interleaved floats -> uint2 q
    flat = X.reshape(-1, 4)
    head = torch.stack([_bf16_bits(flat[:, 0]) | _bf16_bits(flat[:, 1]) << 16,
                        _bf16_bits(flat[:, 2]) | _bf16_bits(flat[:, 3]) << 16],
                       dim=1).reshape(-1)
    assert torch.equal(head, words.reshape(-1))


def test_fast_shared_memory_by_arithmetic():
    """Main path 4 (S_pad 12,032, x_src "stream"): the float layout's
    words are the float32 pair's (both precisions); the packed layout
    holds the gathered vector in S_pad G / 2 words, stream_fwd two alpha
    buffers at every C, stream_bwd its own rows' x_dst * b (R G) and the
    masses packed (R G / 2 each)."""
    R = lambda C: sk.rows_per_cta(12032, C)
    for fast in (MAIN4, MAIN4_F32):
        assert sk.smem_bytes(fast, 2, 2) == {"stream_fwd": 192792,
                                             "stream_bwd": 193064}
    got = {(C, G): sk.smem_bytes(MAIN4, C, G, "packed")
           for C, G in ((1, 2), (2, 2), (4, 2), (4, 4), (8, 4))}
    for (C, G), smem in got.items():
        W = G // 2
        assert smem == {
            "stream_fwd": 4 * (12032 * W + 2 * R(C) * G + 32 * G + 3 * G),
            "stream_bwd": 4 * (12032 * W + R(C) * G + 2 * R(C) * W
                               + 64 * G + 5 * G)}
    assert got[(4, 4)] == {"stream_fwd": 193072, "stream_bwd": 193616}
    assert got[(2, 2)] == {"stream_fwd": 144664, "stream_bwd": 144936}
    # identity mode: one mass buffer
    ident = _shape(8064, "identity")
    assert sk.smem_bytes(ident, 2, 2, "packed")["stream_bwd"] == 4 * (
        8064 + 4032 * 2 + 4032 + 128 + 10)


def test_fast_fits_by_layout():
    """The packed layout fits main path 4 at (C, G) = (2, 2), (4, 2),
    (4, 4), (8, 2), (8, 4), not at C = 1 or (2, 4), and never at G = 1;
    the float layout fits what it fitted in both precisions (G = 4
    nowhere): at G = 4 the packed layout alone fits."""
    packed = {(C, G) for C in sk.CLUSTERS for G in sk.COLUMNS
              if all(sk.fits(MAIN4, k, C, G, layout="packed")
                     for k in sk.KERNELS)}
    assert packed == {(2, 2), (4, 2), (4, 4), (8, 2), (8, 4)}
    floats = {(C, G) for C in sk.CLUSTERS for G in sk.COLUMNS
              if all(sk.fits(MAIN4, k, C, G) for k in sk.KERNELS)}
    assert floats == {(C, G) for C in sk.CLUSTERS for G in sk.COLUMNS
                      if all(sk.fits(MAIN4_F32, k, C, G)
                             for k in sk.KERNELS)}
    assert floats == {(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (8, 1),
                      (8, 2)}
    assert not sk.fits(MAIN4, "stream_fwd_bf16", 2, 1, layout="packed")


def test_fast_plan_at_main_path_4():
    """On an H100 main path 4 fast (B = 128) runs both kernels in the
    packed layout at (C, G) = (2, 2), one wave of 128 CTAs (cost 18,048 /
    16,544 against the float layout's 21,056 / 21,056 and the packed
    (4, 4)'s 22,560 / 18,048); the float32 pair keeps its plan, (2, 2) in
    the float layout; each plan is the cheapest candidate, and the
    candidates span both layouts in the fast mode only."""
    fast = sk.plan(MAIN4, 128, H100)
    f32 = sk.plan(MAIN4_F32, 128, H100)
    for name in sk.KERNELS:
        assert fast[name].layout == "packed"
        assert (f32[name].cluster, f32[name].columns, f32[name].layout) \
            == (2, 2, "float")
        cands = sk.candidates(MAIN4, name, 128, H100)
        assert {p.layout for p in cands} == {"packed", "float"}
        assert {p.layout for p in sk.candidates(MAIN4_F32, name, 128,
                                                H100)} == {"float"}
        assert fast[name] == cands[0]
        assert fast[name].smem == sk.smem_bytes(
            MAIN4, fast[name].cluster, fast[name].columns,
            "packed")[name]
    for name in sk.KERNELS:
        assert (fast[name].cluster, fast[name].columns, fast[name].ctas,
                fast[name].waves) == (2, 2, 128, 1)


# The clusters of one CTA an SM an H100 holds at once
# (cudaOccupancyMaxActiveClusters, chip_smoke.py's line at main path 4):
# 30 of 4 CTAs and 15 of 8, not 132 / C.
H100_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15}


def _h100_active(name, C, G, layout):
    return H100_CLUSTERS[C]


def test_fast_waves_count_the_clusters_the_card_holds():
    """With the card's clusters at once (``active``) a fast plan's waves
    are its clusters over them: at main path 4 the packed (4, 4) takes
    two waves (32 clusters of 4 against 30), so the plan stays (2, 2);
    bench.py --s8k's graph at B = 64 takes the float layout at (2, 1)
    (the packed (4, 2), one wave by the SMs alone, is two by the card's
    clusters); the float32 pair's plans do not change."""
    p = sk.plan_kernel(MAIN4, "stream_fwd", 128, H100, cluster=4,
                       columns=4, layout="packed", active=_h100_active)
    assert p.waves == 2 and p.cost == 2 * (3008 * 4.5 + 0.25 * 12032 * 3)
    assert sk.plan_kernel(MAIN4, "stream_fwd", 128, H100, cluster=4,
                          columns=4, layout="packed").waves == 1
    main4 = sk.plan(MAIN4, 128, H100, active=_h100_active)
    assert {(p.cluster, p.columns, p.layout) for p in main4.values()} == \
        {(2, 2, "packed")}
    s8k = _shape(8064, "identity")
    naive = sk.plan(s8k, 64, H100)
    assert {(p.cluster, p.columns, p.layout) for p in naive.values()} == \
        {(4, 2, "packed")}
    card = sk.plan(s8k, 64, H100, active=_h100_active)
    assert {(p.cluster, p.columns, p.layout, p.waves)
            for p in card.values()} == {(2, 1, "float", 1)}
    f32 = _shape(8064, "identity", fast=False)
    assert sk.plan(f32, 64, H100, active=_h100_active) == \
        sk.plan(f32, 64, H100)


def test_fast_plan_cost_counts_the_slot_bytes():
    """A row's slots cost GRAPH_ROW at 8 bytes (the float layout) and half
    that at 4 (the packed layout); stream_bwd's packed copy moves half
    the bytes of its float copy."""
    fwd = lambda **kw: sk.plan_kernel(MAIN4, "stream_fwd", 128, H100, **kw)
    bwd = lambda **kw: sk.plan_kernel(MAIN4, "stream_bwd", 128, H100, **kw)
    R, g = 6016, sk.GRAPH_ROW
    copy = sk.COPY_FLOAT * 12032 * 2 / 2
    assert fwd(cluster=2, columns=2, layout="float").cost == \
        R * (2 + g) + copy
    assert fwd(cluster=2, columns=2, layout="packed").cost == \
        R * (2 + g / 2) + copy
    assert bwd(cluster=2, columns=2, layout="packed").cost == \
        R * (2 + g / 2) + copy / 2


def test_tier_reach_is_unchanged():
    """fits_stream admits the graphs it admitted before (46,368 in, 46,400
    out outside identity mode; 46,400 in, 46,432 out in it), each on a
    fast plan: near the top the packed layout fits no C, so the plan
    keeps the float layout at C = 8, G = 1."""
    edge = lambda s_pad, mode="stream": _shape(s_pad, mode)
    assert sk.fits_stream(edge(46368)) and not sk.fits_stream(edge(46400))
    assert sk.fits_stream(edge(46400, "identity"))
    assert not sk.fits_stream(edge(46432, "identity"))
    for shape in (edge(46336), edge(46368), edge(46400, "identity")):
        plans = sk.plan(shape, 2, H100)
        assert {(p.cluster, p.columns, p.layout)
                for p in plans.values()} == {(8, 1, "float")}
    # the packed layout's reach: S_pad 38,624 (38,656 in identity mode)
    # at C = 8, G = 2; one slice more fits no packed plan
    packed = lambda shape: any(
        all(sk.fits(shape, k, C, G, layout="packed") for k in sk.KERNELS)
        for C in sk.CLUSTERS for G in (2, 4))
    assert packed(edge(38624)) and not packed(edge(38656))
    assert packed(edge(38656, "identity"))
    assert not packed(edge(38688, "identity"))


def test_forced_plans_that_do_not_fit_raise():
    """A forced packed plan at G = 1, past the block's shared memory, or
    for a float32 graph, and a layout that is not one, raise."""
    with pytest.raises(NotImplementedError, match="layout 'packed'"):
        sk.plan(MAIN4, 128, H100, columns=1, layout="packed")
    with pytest.raises(NotImplementedError, match="layout 'packed'"):
        sk.plan(MAIN4, 128, H100, cluster=2, columns=4, layout="packed")
    with pytest.raises(NotImplementedError, match="layout 'packed'"):
        sk.plan(MAIN4_F32, 128, H100, layout="packed")
    with pytest.raises(NotImplementedError, match="layout 'wide'"):
        sk.plan(MAIN4, 128, H100, layout="wide")
    assert sk.plan(MAIN4, 128, H100, layout="float")[
        "stream_fwd"].layout == "float"
