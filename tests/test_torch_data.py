"""The port's data layer (pychain_tpu_torch/data) against the JAX
package's (pychain_tpu/data) on the same inputs made from numpy seeds.

Exact: bucketing (batches, ``padded_shape``, ``pad_to_bucket``), the
feature ark and scp files (byte for byte, both compressed and plain,
each package reading the other's), chunk plans and chunk FSTs (arc for
arc), and the numpy feature functions.  The PyTorch batch functions on
the CPU (``device="cpu"``) against the JAX package's batch functions:
``fbank_batch`` within 1e-4 absolute on log-mel values (float32 FFTs in
two libraries, then a log: measured 2.6e-5 at these sizes),
``cmvn_batch`` and ``add_deltas_batch`` within 1e-5.  The prefetcher:
order, exceptions in position, early close, the transfer in the
producer thread, and ``to_device`` on the CPU.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pychain_tpu.data as jd
from pychain_tpu.data import kaldi_features as j_kf
from pychain_tpu.graphs.builder import ChainTopology as JTopo

import pychain_tpu_torch.data as pd
from pychain_tpu_torch.data import kaldi_features as p_kf
from pychain_tpu_torch.data.prefetch import to_device
from pychain_tpu_torch.graphs.builder import ChainTopology
from pychain_tpu_torch.ops.linear import LinearArrays


def test_the_same_names_as_the_jax_package():
    assert sorted(pd.__all__) == sorted(jd.__all__) and len(pd.__all__) == 26


# ----------------------------------------------------------------------
# Bucketing
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shuffle,epoch", [(True, 0), (True, 3),
                                           (False, 0)])
def test_bucketing_matches_jax(shuffle, epoch):
    rng = np.random.RandomState(1)
    lengths = rng.randint(20, 130, size=41)
    feats = [rng.randn(int(n), 3).astype(np.float32) for n in lengths]
    for spec in ("geometric", "linear"):
        js = getattr(jd.BucketSpec, spec)(**(
            {"min_t": 16, "max_t": 129} if spec == "geometric"
            else {"step": 25, "max_t": 129}))
        ps = getattr(pd.BucketSpec, spec)(**(
            {"min_t": 16, "max_t": 129} if spec == "geometric"
            else {"step": 25, "max_t": 129}))
        assert ps.lengths == js.lengths
        jb = jd.LengthBucketer(js, shuffle=shuffle, seed=7)
        pb = pd.LengthBucketer(ps, shuffle=shuffle, seed=7)
        jbatches = list(jb.batches(lengths, 6, epoch=epoch))
        pbatches = list(pb.batches(lengths, 6, epoch=epoch))
        assert len(pbatches) == len(jbatches)
        for a, b in zip(pbatches, jbatches):
            np.testing.assert_array_equal(a, b)
            t_pad = pb.padded_shape(lengths, a)
            assert t_pad == jb.padded_shape(lengths, b)
            for got, want in zip(pd.pad_to_bucket(feats, a, t_pad),
                                 jd.pad_to_bucket(feats, b, t_pad)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


def test_pad_to_bucket_refuses_a_long_utterance():
    feats = [np.zeros((5, 2), np.float32), np.zeros((9, 2), np.float32)]
    with pytest.raises(ValueError, match="9 frames > bucket shape 8"):
        pd.pad_to_bucket(feats, [0, 1], 8)


# ----------------------------------------------------------------------
# Kaldi feature arks and scp files
# ----------------------------------------------------------------------

def _mats(seed=0, n=5):
    rng = np.random.RandomState(seed)
    return {f"utt{i:03d}": (rng.randn(7 + 5 * i, 6) * (1 + i)).astype(
        np.float32) for i in range(n)}


@pytest.mark.parametrize("compress,fmt", [(False, 1), (True, 1), (True, 2),
                                          (True, 3)],
                         ids=["plain", "CM", "CM2", "CM3"])
def test_feats_ark_bytes_and_cross_reads(tmp_path, compress, fmt):
    mats = _mats()
    jpath, ppath = str(tmp_path / "j.ark"), str(tmp_path / "p.ark")
    joff = j_kf.write_feats_ark(jpath, mats, compress=compress,
                                compression_format=fmt)
    poff = p_kf.write_feats_ark(ppath, mats, compress=compress,
                                compression_format=fmt)
    assert poff == joff
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file, sequentially and at offsets
    for reader, path in ((p_kf, jpath), (j_kf, ppath)):
        seq = list(reader.read_feats_ark(path))
        assert [k for k, _ in seq] == list(mats)
        for (k, got), want in zip(seq, j_kf.read_feats_ark(jpath)):
            np.testing.assert_array_equal(got, want[1])
            if not compress:
                np.testing.assert_array_equal(got, mats[k])
        for k, off in joff.items():
            np.testing.assert_array_equal(
                reader.load_scp_entry(path, off, use_native=False),
                j_kf.load_scp_entry(jpath, off, use_native=False))
    assert p_kf.scan_feats_ark(jpath) == j_kf.scan_feats_ark(jpath)


def test_scp_round_trip(tmp_path):
    mats = _mats(seed=2, n=4)
    ark = str(tmp_path / "feats.ark")
    offsets = p_kf.write_feats_ark(ark, mats, compress=True)
    pscp, jscp = str(tmp_path / "p.scp"), str(tmp_path / "j.scp")
    p_kf.write_scp(pscp, ark, offsets)
    j_kf.write_scp(jscp, ark, offsets)
    with open(pscp) as a, open(jscp) as b:
        assert a.read() == b.read()
    entries = p_kf.read_scp(pscp)
    assert entries == j_kf.read_scp(pscp)
    assert [(k, o) for k, _, o in entries] == list(offsets.items())
    for key, path, off in entries:
        for native in (True, False):
            np.testing.assert_array_equal(
                p_kf.load_scp_entry(path, off, use_native=native),
                j_kf.load_scp_entry(path, off, use_native=False))
    # a bare path (no offset) reads from offset 0
    bare = str(tmp_path / "bare.scp")
    with open(bare, "w") as f:
        f.write(f"k {ark}\n\n")
    assert p_kf.read_scp(bare) == j_kf.read_scp(bare) == [("k", ark, 0)]


# ----------------------------------------------------------------------
# Chunking
# ----------------------------------------------------------------------

CHUNK_CASES = [([3, 1, 4, 1, 5, 2], [7, 3, 12, 4, 6, 8], 15, 0),
               ([2, 0, 5, 1, 3], [5, 9, 4, 11, 7], 10, 5),
               ([1], [23], 7, 3)]


@pytest.mark.parametrize("phones,durs,width,min_tail", CHUNK_CASES)
def test_chunk_plans_and_fsts_match_jax(phones, durs, width, min_tail):
    plans = pd.chunk_alignment(phones, durs, width, min_tail=min_tail)
    jplans = jd.chunk_alignment(phones, durs, width, min_tail=min_tail)
    assert [tuple(vars(p).values()) for p in plans] == \
        [tuple(vars(p).values()) for p in jplans]
    topo, jtopo = ChainTopology(num_phones=6), JTopo(num_phones=6)
    for tol in (0, 2):
        for p, jp in zip(plans, jplans):
            got = pd.chunk_supervision(p, topo, tolerance=tol)
            want = jd.chunk_supervision(jp, jtopo, tolerance=tol)
            assert got.start == want.start
            for name in ("final", "arc_offsets", "ilabels", "olabels",
                         "weights", "nextstates"):
                np.testing.assert_array_equal(getattr(got, name),
                                              getattr(want, name))


def test_chunking_validation():
    with pytest.raises(ValueError):
        pd.chunk_alignment([1, 2], [3], 4)
    with pytest.raises(ValueError):
        pd.chunk_alignment([1], [0], 4)
    with pytest.raises(ValueError):
        pd.chunk_alignment([1], [3], 0)


# ----------------------------------------------------------------------
# Prefetching
# ----------------------------------------------------------------------

def test_prefetch_order_and_completeness():
    items = list(range(57))
    assert list(pd.prefetch(iter(items), depth=3)) == items


def test_prefetch_transfer_runs_in_the_producer_thread():
    main = threading.get_ident()
    seen = []

    def transfer(x):
        seen.append(threading.get_ident())
        return torch.full((2, 2), float(x))

    out = list(pd.prefetch(range(5), depth=2, transfer=transfer))
    assert len(out) == 5 and float(out[3][0, 0]) == 3.0
    assert seen and all(t != main for t in seen)


def test_prefetch_exceptions_propagate_in_position():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    p = pd.prefetch(gen(), depth=2)
    assert next(p) == 1 and next(p) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)

    def bad(x):
        if x == 1:
            raise ValueError("bad transfer")
        return x

    p = pd.prefetch(range(4), depth=2, transfer=bad)
    assert next(p) == 0
    with pytest.raises(ValueError, match="bad transfer"):
        next(p)


def test_prefetch_close_stops_the_producer():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    with pd.Prefetcher(gen(), depth=2) as p:
        got = [next(p) for _ in range(3)]
    assert got == [0, 1, 2]
    n_after_close = len(produced)
    time.sleep(0.3)
    assert len(produced) == n_after_close <= 3 + 2 + 2
    assert not p._thread.is_alive()
    with pytest.raises(ValueError):
        pd.Prefetcher([], depth=0)


def test_to_device_on_the_cpu_keeps_every_part_of_an_item():
    lin = LinearArrays(pdf_seq=torch.arange(6).reshape(2, 3),
                       logp_seq=torch.zeros(2, 3), final=torch.zeros(2),
                       graph_len=torch.tensor([3, 2]))
    item = (torch.ones(2, 4), lin, np.array([3, 2], np.int32), None)
    out = list(pd.prefetch([item], transfer=to_device("cpu")))[0]
    assert torch.equal(out[0], item[0]) and out[3] is None
    assert isinstance(out[1], LinearArrays)
    assert torch.equal(out[1].pdf_seq, lin.pdf_seq)
    np.testing.assert_array_equal(out[2], item[2])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            to_device()


def test_linear_arrays_take_gathers_rows():
    lin = LinearArrays(pdf_seq=torch.arange(12).reshape(4, 3),
                       logp_seq=torch.randn(4, 3), final=torch.randn(4),
                       graph_len=torch.tensor([3, 2, 1, 3]))
    idx = torch.tensor([2, 0, 2])
    got = lin.take(idx)
    for name in ("pdf_seq", "logp_seq", "final", "graph_len"):
        assert torch.equal(getattr(got, name), getattr(lin, name)[idx])


# ----------------------------------------------------------------------
# Features
# ----------------------------------------------------------------------

def _audio(seed=0, b=3, n=5200):
    return (np.random.RandomState(seed).randn(b, n) * 0.2).astype(
        np.float32)


@pytest.mark.parametrize("window", ["povey", "hann", "hamming"])
def test_numpy_features_match_jax_exactly(window):
    cfg, jcfg = pd.FbankConfig(window=window), jd.FbankConfig(window=window)
    x = _audio()[0]
    np.testing.assert_array_equal(pd.mel_banks(cfg), jd.mel_banks(jcfg))
    assert pd.num_frames(5200, cfg) == jd.num_frames(5200, jcfg)
    np.testing.assert_array_equal(pd.fbank(x, cfg), jd.fbank(x, jcfg))
    np.testing.assert_array_equal(pd.mfcc(x, cfg), jd.mfcc(x, jcfg))
    pcm = (x * 32767).astype(np.int16)
    np.testing.assert_array_equal(pd.fbank(pcm, cfg), jd.fbank(pcm, jcfg))
    f = pd.fbank(x, cfg)
    np.testing.assert_array_equal(pd.add_deltas(f), jd.add_deltas(f))
    for norm_vars in (False, True):
        np.testing.assert_array_equal(pd.cmvn(f, 17, norm_vars),
                                      jd.cmvn(f, 17, norm_vars))


def test_wav_round_trip_matches_jax(tmp_path):
    x = _audio(b=1, n=1000)[0]
    pd.write_wav(str(tmp_path / "p.wav"), x, 16000)
    jd.write_wav(str(tmp_path / "j.wav"), x, 16000)
    assert (tmp_path / "p.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    got, rate = pd.read_wav(str(tmp_path / "j.wav"))
    want, _ = jd.read_wav(str(tmp_path / "j.wav"))
    assert rate == 16000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("int16", [False, True], ids=["float", "int16"])
def test_fbank_batch_matches_jax(int16):
    x = _audio()
    if int16:
        x = (x * 32767).astype(np.int16)
    want = np.asarray(jd.fbank_batch(x))
    got = pd.fbank_batch(x, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.stack([jd.fbank(a) for a in x]), rtol=0, atol=1e-4)
    assert pd.fbank_batch(x[:, :100], device="cpu").shape == (3, 0, 40)


def test_cmvn_and_deltas_batch_match_jax():
    rng = np.random.RandomState(4)
    f = rng.randn(3, 21, 5).astype(np.float32)
    lens = np.array([21, 13, 4])
    for lengths in (None, lens):
        for norm_vars in (False, True):
            np.testing.assert_allclose(
                pd.cmvn_batch(f, lengths, norm_vars, device="cpu").numpy(),
                np.asarray(jd.cmvn_batch(jnp.asarray(f), lengths,
                                         norm_vars)),
                rtol=0, atol=1e-5)
    for window, order in ((2, 2), (1, 1), (3, 2)):
        np.testing.assert_allclose(
            pd.add_deltas_batch(torch.from_numpy(f), window, order,
                                device="cpu").numpy(),
            np.asarray(jd.add_deltas_batch(f, window, order)),
            rtol=0, atol=1e-5)
