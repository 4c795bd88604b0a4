"""The port's native host library (pychain_tpu_torch/csrc/native.py over
its copy of pychain_native.cc, built here with g++) against the port's
Python twins and the JAX package's Python functions.

FST reads (whole files and ark entries at offsets) and writes: the same
arrays and the same bytes.  ``compile_fst``: integer arrays equal, the
probabilities within 1e-6 relative (``exp`` in C++ and in numpy);
``leaky_probs`` within 1e-6 relative.  ``scan_feats_ark`` and
``read_feats`` on every matrix format: the same keys, offsets and
values, bit for bit.  The two CPU forward-backward oracles within 1e-5:
the prob-domain one (a shared leaky-HMM denominator) against the port's
plain factorized engine and the JAX package's XLA engine, the log-domain
one (flat-start and cyclic numerators) against the port's plain semiring
engine and the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pychain_tpu import ChainGraph as JChainGraph
from pychain_tpu import ChainGraphBatch as JChainGraphBatch
from pychain_tpu.data import kaldi_features as j_kf
from pychain_tpu.graphs import compiler as j_compiler
from pychain_tpu.graphs.fst import FST as JFST
from pychain_tpu.loss import chain_function_with_aux as j_aux

import pychain_tpu_torch as pt
from pychain_tpu_torch.csrc import native
from pychain_tpu_torch.data import kaldi_features as p_kf
from pychain_tpu_torch.graph import ChainGraph, ChainGraphBatch
from pychain_tpu_torch.graphs import compiler
from pychain_tpu_torch.graphs.builder import ChainTopology, \
    make_numerator_fst
from pychain_tpu_torch.graphs.fst import FST, write_ark
from pychain_tpu_torch.ops.factorized import forward_backward_prob_fact
from pychain_tpu_torch.ops.semiring import forward_backward_semiring
from pychain_tpu_torch.utils.testgraphs import denominator_fst, random_fst

LEAKY = 1e-5


@pytest.fixture(scope="module", autouse=True)
def built():
    return native.build()


def _fields(fst):
    return (fst.start, fst.final, fst.arc_offsets, fst.ilabels,
            fst.olabels, fst.weights, fst.nextstates)


def _assert_same_fst(got, want):
    for a, b in zip(_fields(got), _fields(want)):
        np.testing.assert_array_equal(a, b)


def test_the_library_is_built_from_the_source_by_its_digest():
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libpychain_native-")
    assert native.available()


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError,
                       match=r"(?s)build failed.*error: expected"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_without_the_source_the_readers_take_numpy(tmp_path, monkeypatch):
    # an installation that lacks pychain_native.cc: not available, and
    # the feature readers fall back to their numpy twins
    rng = np.random.RandomState(4)
    mats = {f"u{i}": rng.randn(5 + i, 3).astype(np.float32)
            for i in range(3)}
    ark = str(tmp_path / "feats.ark")
    p_kf.write_feats_ark(ark, mats)
    want = p_kf.scan_feats_ark(ark)
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cc")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    got = p_kf.scan_feats_ark(ark)
    assert got == want
    for key, offset in got:
        np.testing.assert_array_equal(p_kf.load_scp_entry(ark, offset),
                                      mats[key])
    assert not (tmp_path / "build").exists()


def test_fst_read_and_write_match_python(tmp_path):
    fst = random_fst(num_states=17, num_pdfs=9, seed=3)
    path = str(tmp_path / "x.fst")
    fst.write(path)
    _assert_same_fst(native.read_fst(path), FST.read(path))
    jfst = JFST.read(path)
    np.testing.assert_array_equal(native.read_fst(path).weights,
                                  jfst.weights)
    out = str(tmp_path / "n.fst")
    native.write_fst(fst, out)
    with open(out, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()


def test_fst_ark_offsets_match_python(tmp_path):
    fsts = {f"u{i}": random_fst(num_states=6 + i, seed=i) for i in range(4)}
    path = str(tmp_path / "g.ark")
    offsets = write_ark(path, fsts)
    for k, off in offsets.items():
        got = native.read_fst(path, off)
        _assert_same_fst(got, FST.read_ark(path, off))
        _assert_same_fst(got, fsts[k])
        np.testing.assert_array_equal(got.nextstates,
                                      JFST.read_ark(path, off).nextstates)


@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("which", ["random", "denominator"])
def test_compile_fst_matches_python(log_domain, which):
    fst = (random_fst(num_states=23, num_pdfs=11, seed=7)
           if which == "random" else
           denominator_fst(num_phones=9, seed=2,
                           forward_pdf_mode="separate")[0])
    got = native.compile_fst(fst, log_domain=log_domain)
    for want in (compiler.compile_fst(fst, log_domain),
                 j_compiler.compile_fst(fst, log_domain)):
        assert got.num_states == want.num_states
        assert got.start_state == want.start_state
        for name in ("forward_transitions", "forward_transition_indices",
                     "backward_transitions", "backward_transition_indices"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        for name in ("forward_transition_probs", "backward_transition_probs",
                     "final_probs"):
            np.testing.assert_allclose(getattr(got, name),
                                       getattr(want, name), rtol=1e-6)


def test_leaky_probs_match_python():
    for fst in (random_fst(num_states=15, num_pdfs=6, seed=13),
                denominator_fst(num_phones=12, seed=1)[0]):
        got = native.leaky_probs(fst)
        np.testing.assert_allclose(got, compiler.leaky_probs(fst),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(got, j_compiler.leaky_probs(fst),
                                   rtol=1e-6, atol=1e-8)


def test_feature_scan_and_read_match_python(tmp_path):
    rng = np.random.RandomState(0)
    mats = {f"u{i}": (rng.randn(7 + 3 * i, 5) * 2).astype(np.float32)
            for i in range(4)}
    ark = str(tmp_path / "mixed.ark")
    offsets = {}
    with open(ark, "wb") as f:
        for i, (k, m) in enumerate(mats.items()):
            f.write(k.encode() + b" ")
            offsets[k] = f.tell()
            f.write(b"\x00B")
            if i == 0:
                p_kf.write_matrix(f, m)
            else:
                p_kf.write_compressed_matrix(f, m, fmt=i)   # CM, CM2, CM3
    for k, off in offsets.items():
        got = native.read_feats(ark, off)
        np.testing.assert_array_equal(
            got, p_kf.load_scp_entry(ark, off, use_native=False))
        np.testing.assert_array_equal(
            got, j_kf.load_scp_entry(ark, off, use_native=False))
    want = [(k, off) for k, off in offsets.items()]
    assert native.scan_feats_ark(ark) == want
    assert native.scan_feats_ark(ark, _initial_keys_cap=4) == want
    assert p_kf.scan_feats_ark(ark) == want
    with pytest.raises(ValueError):
        native.read_feats(ark, offsets["u1"] + 1)


def test_fwdbwd_prob_oracle_matches_the_plain_engines():
    rng = np.random.RandomState(0)
    den_fst, P = denominator_fst(num_phones=10, states_per_phone=2, seed=0)
    den = ChainGraph(den_fst)
    B, T = 3, 9
    lengths = np.array([9, 6, 2], np.int32)
    x = rng.randn(B, T, P).astype(np.float32)
    px = np.exp(np.clip(x, -30, 30))
    objf, gamma, ok = native.fwdbwd_prob(
        px, lengths, den.forward_transitions, den.forward_transition_probs,
        den.backward_transitions, den.backward_transition_probs,
        den.initial_probs, den.final_probs, den.leaky_probs, LEAKY)
    assert ok
    fa = ChainGraphBatch(den, B, device="cpu")._fact
    ref = forward_backward_prob_fact(torch.from_numpy(px),
                                     torch.from_numpy(lengths), fa, LEAKY)
    np.testing.assert_allclose(objf, ref.objf.numpy(), rtol=1e-5)
    np.testing.assert_allclose(gamma, ref.gamma.numpy(), rtol=0, atol=1e-5)
    _, jref = j_aux(jnp.asarray(x), lengths,
                    JChainGraphBatch(JChainGraph(den_fst), B),
                    leaky_coefficient=LEAKY, impl="factorized")
    np.testing.assert_allclose(objf, np.asarray(jref.objf), rtol=1e-5)
    np.testing.assert_allclose(gamma, np.asarray(jref.gamma), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["flat-start", "cyclic"])
def test_fwdbwd_log_oracle_matches_the_plain_engines(kind):
    rng = np.random.RandomState(1)
    if kind == "flat-start":
        topo = ChainTopology(num_phones=6)
        fsts = [make_numerator_fst(list(rng.randint(0, 6, size=n)), topo)
                for n in (4, 3, 2)]
        P = topo.num_pdfs
    else:
        fsts = [random_fst(num_states=5 + i, num_pdfs=7, seed=i)
                for i in range(3)]
        P = 7
    B, T = 3, 10
    lengths = np.array([10, 8, 5], np.int32)
    x = rng.randn(B, T, P).astype(np.float32)
    graphs = [ChainGraph(f, log_domain=True) for f in fsts]
    K = max(g.num_transitions for g in graphs) + 1
    S = max(g.num_states for g in graphs) + 1
    batch = ChainGraphBatch(graphs, max_num_transitions=K, max_num_states=S,
                            device="cpu")
    objf, gamma, ok = native.fwdbwd_log(
        x, lengths, batch.forward_transitions.numpy(),
        batch.forward_transition_probs.numpy(),
        batch.backward_transitions.numpy(),
        batch.backward_transition_probs.numpy(),
        batch.initial_probs.numpy(), batch.final_probs.numpy())
    assert ok
    ref = forward_backward_semiring(torch.from_numpy(x),
                                    torch.from_numpy(lengths),
                                    batch.semiring())
    np.testing.assert_allclose(objf, ref.objf.numpy(), rtol=1e-5)
    np.testing.assert_allclose(gamma, ref.gamma.numpy(), rtol=0, atol=1e-5)
    jbatch = JChainGraphBatch([JChainGraph(f, log_domain=True)
                               for f in fsts], max_num_transitions=K,
                              max_num_states=S)
    _, jref = j_aux(jnp.asarray(x), lengths, jbatch, impl="semiring")
    np.testing.assert_allclose(objf, np.asarray(jref.objf), rtol=1e-5)
    np.testing.assert_allclose(gamma, np.asarray(jref.gamma), rtol=0,
                               atol=1e-5)
    assert pt.ChainGraphBatch is ChainGraphBatch
