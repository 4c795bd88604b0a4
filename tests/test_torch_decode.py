"""The port's phone decoder and simplefst facade against the JAX package's.

Each side builds its own phone LM from the same seeded transcripts (the
builders are arc-for-arc identical) and decodes the same numpy x: the
phones, durations and scores must be identical (the sweeps add the same
float32 values in the same order; see tests/test_torch_viterbi.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pychain_tpu.simplefst as j_simplefst
from pychain_tpu.decode import PhoneDecoder as JPhoneDecoder
from pychain_tpu.decode import edit_distance as j_edit_distance
from pychain_tpu.decode import phone_error_rate as j_phone_error_rate
from pychain_tpu.graphs.builder import ChainTopology as JChainTopology
from pychain_tpu.graphs.builder import estimate_phone_lm as j_estimate

import pychain_tpu_torch.simplefst as simplefst
from pychain_tpu_torch.decode import (PhoneDecoder, edit_distance,
                                      phone_error_rate)
from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                              alignment_to_pdf_sequence,
                                              estimate_phone_lm)
from pychain_tpu_torch.graphs.fst import write_ark
from pychain_tpu_torch.ops import viterbi_kernels as vk
from pychain_tpu_torch.utils.testgraphs import denominator_fst, random_fst

NUM_PHONES = 4


def _transcripts(seed=0, n=30):
    rng = np.random.RandomState(seed)
    return [[int(p) for p in rng.randint(0, NUM_PHONES,
                                         size=rng.randint(4, 9))]
            for _ in range(n)]


def _decoders():
    ts = _transcripts()
    mine = PhoneDecoder(estimate_phone_lm(ts, num_phones=NUM_PHONES,
                                          order=2),
                        ChainTopology(num_phones=NUM_PHONES))
    theirs = JPhoneDecoder(j_estimate(ts, num_phones=NUM_PHONES, order=2),
                           JChainTopology(num_phones=NUM_PHONES))
    return mine, theirs


PLANS = [([2, 0, 3, 1, 2], [3, 2, 4, 2, 3]), ([0, 1], [4, 3]),
         ([3, 3, 1], [2, 5, 1])]


def _oracle(topo, T):
    """+-8 emissions that favour each plan's pdf path, and its lengths."""
    x = np.full((len(PLANS), T, topo.num_pdfs), -8.0, np.float32)
    lengths = []
    for b, (ph, du) in enumerate(PLANS):
        seq = alignment_to_pdf_sequence(ph, du, topo)
        x[b, np.arange(len(seq)), seq] = 8.0
        lengths.append(len(seq))
    return x, np.array(lengths, np.int32)


@pytest.mark.parametrize("emissions", ["oracle", "random"])
def test_decoder_matches_jax(emissions):
    mine, theirs = _decoders()
    T = 14
    x, lengths = _oracle(mine.topo, T)
    if emissions == "random":
        x = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    got = mine(torch.from_numpy(x), lengths)
    ref = theirs(jnp.array(x), lengths)
    assert got.phones == ref.phones
    assert got.durations == ref.durations
    np.testing.assert_array_equal(got.scores, np.asarray(ref.scores))
    if emissions == "oracle":
        assert got.phones == [ph for ph, _ in PLANS]
        assert got.durations == [du for _, du in PLANS]
        assert phone_error_rate(got.phones, [ph for ph, _ in PLANS]) == 0
    assert np.isfinite(got.scores).all()


def test_decoder_reuses_its_shared_batch():
    mine, _ = _decoders()
    x, lengths = _oracle(mine.topo, 14)
    vk.reset_launch_counts()
    mine(torch.from_numpy(x), lengths)
    mine(torch.from_numpy(x), lengths)
    assert list(mine._batches) == [(3, torch.device("cpu"))]
    batch = mine._batches[(3, torch.device("cpu"))]
    assert batch.shared and batch.semiring().rows == 1
    assert vk.LAUNCHES == {"viterbi": 0}       # the CPU: the plain version


def test_shared_topology_rejected():
    ts = _transcripts()
    with pytest.raises(ValueError, match="non-shared"):
        PhoneDecoder(estimate_phone_lm(ts, num_phones=NUM_PHONES),
                     ChainTopology(num_phones=NUM_PHONES, shared_pdfs=True))


def test_edit_distance_and_per_match_jax():
    assert edit_distance([1, 2, 3], [1, 3]) == 1
    assert edit_distance([], [1, 2]) == 2
    rng = np.random.RandomState(3)
    refs = [list(rng.randint(0, 5, size=rng.randint(0, 8)))
            for _ in range(20)]
    hyps = [list(rng.randint(0, 5, size=rng.randint(0, 8)))
            for _ in range(20)]
    for r, h in zip(refs, hyps):
        assert edit_distance(r, h) == j_edit_distance(r, h)
    assert phone_error_rate(refs, hyps) == j_phone_error_rate(refs, hyps)
    np.testing.assert_allclose(
        phone_error_rate([[1, 2, 3], [4]], [[1, 2], [4]]), 0.25)


def test_simplefst_matches_jax(tmp_path):
    den_fst, _ = denominator_fst(num_phones=5, states_per_phone=2, seed=1)
    num_fst = random_fst(num_states=6, num_pdfs=7, seed=2)
    path = str(tmp_path / "den.fst")
    den_fst.write(path)
    mine = simplefst.StdVectorFst.read(path)
    theirs = j_simplefst.StdVectorFst.read(path)
    assert isinstance(mine, simplefst.StdVectorFst)
    assert mine.num_states() == theirs.num_states() == den_fst.num_states
    assert (simplefst.StdVectorFst.start_state(mine)
            == j_simplefst.StdVectorFst.start_state(theirs) == den_fst.start)
    for log_domain in (False, True):
        a = simplefst.StdVectorFst.fst_to_tensor(mine, log_domain)
        b = j_simplefst.StdVectorFst.fst_to_tensor(theirs, log_domain)
        assert len(a) == len(b) == 7
        for u, v in zip(a, b):
            assert isinstance(u, np.ndarray)
            np.testing.assert_array_equal(u, np.asarray(v))
    np.testing.assert_array_equal(
        simplefst.StdVectorFst.set_leaky_probs(mine),
        j_simplefst.StdVectorFst.set_leaky_probs(theirs))
    # a written FST reads back unchanged, alone and from an ark
    again = str(tmp_path / "again.fst")
    mine.write(again)
    back = simplefst.StdVectorFst.read(again)
    for f in ("final", "arc_offsets", "ilabels", "olabels", "weights",
              "nextstates"):
        np.testing.assert_array_equal(getattr(back, f), getattr(den_fst, f))
    ark = str(tmp_path / "g.ark")
    offsets = write_ark(ark, {"den": den_fst, "num": num_fst})
    got = simplefst.StdVectorFst.read_ark(ark, offsets["num"])
    ref = j_simplefst.StdVectorFst.read_ark(ark, offsets["num"])
    for u, v in zip(simplefst.StdVectorFst.fst_to_tensor(got, True),
                    j_simplefst.StdVectorFst.fst_to_tensor(ref, True)):
        np.testing.assert_array_equal(u, np.asarray(v))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_decoder_matches_cpu(cuda):
    mine, _ = _decoders()
    x, lengths = _oracle(mine.topo, 14)
    x = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    vk.reset_launch_counts()
    got = mine(torch.from_numpy(x).to(cuda), lengths)
    assert vk.LAUNCHES == {"viterbi": 1}
    ref = mine(torch.from_numpy(x), lengths)
    assert got.phones == ref.phones and got.durations == ref.durations
    np.testing.assert_array_equal(got.scores, ref.scores)
