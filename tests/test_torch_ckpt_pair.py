"""The ckpt mode's paired chunk scan (``fact_kernels.fact_ckpt_pair``) on the CPU.

On the card the ckpt mode runs chunk k's backward and chunk k - 1's
replay in one grid (csrc/fact_ckpt.cu), the chunk streams in two sets
(chunk k in set k % 2).  Here:

* the host schedule (``fact_kernels.pair_schedule``): which chunk each
  role of each launch takes, for 1, 2, 3 and 58 chunks (main path 7's
  T=3,700 at C=64) and for a chunk that divides neither 3,700 nor 1,000
  (chip_smoke.py's ODD_CHUNK, 96): each backward reads the set its own
  chunk's replay wrote in the launch before, and no launch writes a set
  that it or a later backward still reads;
* the plain version run on that schedule with two buffer sets
  (``factorized.forward_backward_prob_ckpt(..., schedule=)``: its
  per-chunk replay and backward) equals the plain ckpt result of the
  unpaired order bit for bit, in both precisions, and the JAX package's
  ckpt mode (``forward_backward_prob_pallas(..., stream_mode="ckpt")`` in
  interpret mode) within tests/test_torch_stream_modes.py's bars (1e-5);
* the plan (``fact_kernels.ckpt_paired``) on an H100 stub: paired where
  2 B <= 132 SMs, unpaired past it and under a forced cluster, a forced
  pair that does not fit refused; the pair's shared memory the larger of
  its roles';
* ``fact_kernels._ckpt`` paired against unpaired on the emulated kernels
  of tests/test_torch_stream_modes.py (the pair's roles emulated one
  after the other, the replay first): the same bits.

tests/test_torch_card.py (TestCkptPair) holds the kernel itself to the
unpaired scan on the card.
"""

import types

import numpy as np
import pytest
import torch

from pychain_tpu_torch.ops import factorized as pf
from pychain_tpu_torch.ops import fact_kernels as fk

from test_torch_stream_modes import (H100, LEAKY, _assert_equal,
                                     _assert_near_jax, _case, _emu_bwd,
                                     _emu_fwd, _emu_pair, _jax, _port)

ODD_CHUNK = 96   # chip_smoke.py's chunk that divides neither T


def _chunks(T, C):
    return -(-T // C)


@pytest.mark.parametrize("n", [1, 2, 3, 58, _chunks(3700, ODD_CHUNK),
                               _chunks(1000, ODD_CHUNK)])
def test_pair_schedule(n):
    """n + 1 launches; every chunk replayed once and its backward run
    once, the backwards from the last chunk down (the beta' carry's
    order), each in the launch after its replay; the first launch a
    replay alone, the last a backward alone; a launch's replay writes the
    set its backward does not read, and every backward finds its own
    chunk's streams in its set."""
    sched = fk.pair_schedule(n)
    assert len(sched) == n + 1
    assert sched[0] == (None, n - 1) and sched[-1] == (0, None)
    backs = [kb for kb, _ in sched if kb is not None]
    replays = [kf for _, kf in sched if kf is not None]
    assert backs == list(range(n - 1, -1, -1)) == replays
    held = {}
    for j, (kb, kf) in enumerate(sched):
        if kb is not None:
            assert held[kb % 2] == kb
            assert sched[j - 1][1] == kb
        if kf is not None:
            assert kb is None or kf % 2 != kb % 2
            held[kf % 2] = kf
    # every later backward that reads a set finds the chunk it was
    # written for: no launch overwrites a set before its backward
    for j, (_, kf) in enumerate(sched):
        if kf is not None:
            later = [kb for kb, _ in sched[j + 1:] if kb is not None
                     and kb % 2 == kf % 2]
            assert later[0] == kf


@pytest.mark.parametrize("T,C", [(3700, 64), (3700, ODD_CHUNK),
                                 (1000, ODD_CHUNK), (11, 4)])
def test_pair_schedule_covers_the_frames(T, C):
    """The chunks of the schedule cover frames 0 .. T - 1 once, the last
    one cut at T (3,700 at 96: 39 chunks, the last of 52 frames)."""
    assert fk.ckpt_chunk_length(T, C) == C
    k_all = [kf for _, kf in fk.pair_schedule(_chunks(T, C))
             if kf is not None]
    frames = sorted(t for k in k_all for t in range(k * C,
                                                    min(k * C + C, T)))
    assert frames == list(range(T))


@pytest.mark.parametrize("chunk", [1, 4, 5, 64, None])
@pytest.mark.parametrize("fwd_mode", ["source", "cross", "separate"])
@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_plain_on_the_pair_schedule(tile_dtype, fwd_mode, chunk):
    """tests/test_pallas.py's ckpt case (denominator_fst(9, 2), B=3,
    T=11, lengths 11, 7, 2): the plain ckpt scan on the pair's schedule
    (two buffer sets) equals it in the unpaired order bit for bit, and
    JAX's ckpt mode within 1e-5."""
    jfa, fa, px, lengths = _case(9, 7, fwd_mode, 3, 11, [11, 7, 2],
                                 tile_dtype)
    C = fk.ckpt_chunk_length(11, chunk)
    got = pf.forward_backward_prob_ckpt(
        torch.from_numpy(px), torch.from_numpy(lengths), fa, LEAKY, chunk,
        schedule=fk.pair_schedule(_chunks(11, C)))
    _assert_equal(got, _port(fa, px, lengths, "ckpt", chunk))
    _assert_near_jax(got, _jax(jfa, px, lengths, stream_mode="ckpt",
                               ckpt_chunk=chunk))


def test_plain_refuses_a_schedule_that_overwrites_a_set():
    """A schedule whose replay of chunk k - 2 comes before chunk k's
    backward (one set too few) is caught: the backward finds another
    chunk's streams in its set."""
    _, fa, px, lengths = _case(9, 7, "source", 3, 11, [11, 7, 2])
    bad = [(None, 2), (None, 1), (None, 0), (2, None), (1, None),
           (0, None)]
    with pytest.raises(AssertionError, match="holds chunk 0"):
        pf.forward_backward_prob_ckpt(torch.from_numpy(px),
                                      torch.from_numpy(lengths), fa, LEAKY,
                                      4, schedule=bad)


def _stub(s_pad, mode="identity", fast=True):
    """A graph's shape as the plan reads it."""
    return types.SimpleNamespace(
        s_pad=s_pad, xsrc_mode=mode, w1=types.SimpleNamespace(
            operand_dtype=torch.bfloat16 if fast else torch.float32))


@pytest.mark.parametrize("B,want", [(1, True), (32, True), (64, True),
                                    (66, True), (67, False), (128, False)])
@pytest.mark.parametrize("fast", [False, True])
def test_pair_plan_on_an_h100(B, want, fast):
    """Paired at B = 1, 32 (bench.py --long), 64 (main path 7) and 66
    (132 blocks), unpaired at 67 and 128; unpaired under any forced
    cluster; paired=False forces the unpaired scan; paired=True past the
    reach raises NotImplementedError."""
    fa = _stub(3072, fast=fast)
    assert fk.ckpt_paired(B, H100, fa) is want
    for C in (1, 2, 4):
        assert fk.ckpt_paired(B, H100, fa, cluster=C) is False
    assert fk.ckpt_paired(B, H100, fa, paired=False) is False
    if want:
        assert fk.ckpt_paired(B, H100, fa, paired=True) is True
        assert fk.ckpt_paired(B, H100, fa, cluster=1, paired=True) is True
    else:
        with pytest.raises(NotImplementedError, match=f"{2 * B} on 132"):
            fk.ckpt_paired(B, H100, fa, paired=True)
    with pytest.raises(NotImplementedError, match="cluster=2"):
        fk.ckpt_paired(min(B, 66), H100, fa, cluster=2, paired=True)


@pytest.mark.parametrize("sms,optin,B,want", [
    (16, 232448, 8, True),       # a card of 16 SMs
    (16, 232448, 9, False),
    (132, 86427, 64, False),     # a block one byte short of main path 7's
    (132, 86428, 64, True),
])
def test_pair_plan_follows_the_card(sms, optin, B, want):
    card = types.SimpleNamespace(multi_processor_count=sms,
                                 shared_memory_per_block_optin=optin)
    assert fk.ckpt_paired(B, card, _stub(3072)) is want


@pytest.mark.parametrize("s_pad,mode", [(3072, "identity"), (384, "matrix"),
                                        (8064, "stream"), (12032, "identity")])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("stages", [None, 0, 1, 2])
def test_pair_shared_memory(s_pad, mode, fast, stages):
    """The pair's request is the larger of its roles' one-block requests
    (fact_fwd_init's and fact_bwd_chunk's at the ring's depth), which is
    the backward's; at main path 7 fast (S_pad 3,072, identity, two
    stages) 86,428 bytes."""
    fa = _stub(s_pad, mode, fast)
    sm = fk.smem_bytes(fa, stages)
    assert fk.pair_smem_bytes(fa, stages) == max(sm["fact_fwd"],
                                                 sm["fact_bwd"]) \
        == sm["fact_bwd"]
    if (s_pad, mode, fast, stages) == (3072, "identity", True, None):
        assert fk.ring_stages(fa) == 2
        assert fk.pair_smem_bytes(fa) == 86428


@pytest.mark.parametrize("fwd_mode", ["source", "cross", "separate"])
def test_chunk_role_words_are_its_slots(fwd_mode):
    """The pair's fast chunk role reads W1^T and W2^T as packed words
    (KernelGraph.packed; FACT_PAIR_WORDS in csrc/fact_ckpt.cu): each word
    decodes (slot_col, slot_val) to the bank-ordered slot's column id and
    value exactly, so its products are fact_bwd_chunk's bit for bit."""
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    import pychain_tpu_torch as pt
    fst, _ = denominator_fst(num_phones=40, states_per_phone=2, seed=9,
                             forward_pdf_mode=fwd_mode)
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), 2, tile_dtype="bfloat16",
                            device="cpu")._fact
    kg = fk.graph_for(fa)
    for op, words in zip(kg.resident[2:], kg.packed[2:]):
        col, val = fk.unpack_slots(words)
        assert torch.equal(col, op[1]) and torch.equal(val, op[2])


@pytest.mark.parametrize("chunk", [3, 5, 12])
@pytest.mark.parametrize("fwd_mode", ["source", "separate"])
@pytest.mark.parametrize("tile_dtype", [None, "bfloat16"])
def test_paired_host_path_gives_the_unpaired_bits(monkeypatch, tile_dtype,
                                                  fwd_mode, chunk):
    """fact_kernels._ckpt paired and unpaired on the emulated kernels at
    T=12, lengths 12, 8, 4, 1, 9, debug True and False: the same bits;
    n + 1 pair launches (n of each role) against n of each form."""
    from pychain_tpu_torch.utils.testgraphs import denominator_fst
    import pychain_tpu_torch as pt
    fst, P = denominator_fst(num_phones=10, states_per_phone=2, seed=6,
                             forward_pdf_mode=fwd_mode)
    fa = pt.ChainGraphBatch(pt.ChainGraph(fst), 5, tile_dtype=tile_dtype,
                            device="cpu")._fact
    rng = np.random.RandomState(26)
    px = torch.exp(torch.from_numpy(rng.randn(5, 12, P).astype(np.float32)))
    lens = torch.tensor([12, 8, 4, 1, 9], dtype=torch.int32)
    monkeypatch.setattr(fk, "_fwd_launch", _emu_fwd)
    monkeypatch.setattr(fk, "_bwd_launch", _emu_bwd)
    monkeypatch.setattr(fk, "_pair_launch", _emu_pair)
    monkeypatch.setattr(fk, "_card_props", lambda device: H100)
    sfx = "_bf16" if tile_dtype else ""
    n = _chunks(12, chunk)
    for debug in (True, False):
        got = {}
        for paired in (True, False):
            fk.reset_launch_counts()
            objf, outs = fk._ckpt(px, lens, fa, LEAKY, debug, None, chunk,
                                  paired=paired)
            got[paired] = fk._package_result(objf, *outs)
            want = ({"fact_fwd_snap": 1, "fact_ckpt_pair": n + 1} if paired
                    else {"fact_fwd_snap": 1, "fact_fwd_init": n,
                          "fact_bwd_chunk": n})
            assert fk.launched() == {k + sfx: v for k, v in want.items()}
            assert fk.roles_launched() == ({
                f"fact_fwd_init{sfx}": n, f"fact_bwd_chunk{sfx}": n}
                if paired else {})
        _assert_equal(got[True], got[False])
