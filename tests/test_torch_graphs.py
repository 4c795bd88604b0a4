"""The port's host-side graph code against the JAX package's.

The port keeps its own copies of the numpy graph modules (FST I/O, the
compiler, the factorizer, the test-graph generators).  On the same
graphs they must produce bit-identical arrays, so both packages run the
same permuted state numbering.
"""

import dataclasses

import numpy as np
import pytest

from pychain_tpu.graphs import compiler as j_compiler
from pychain_tpu.graphs import factorize as j_factorize
from pychain_tpu.graphs.fst import FST as JFST
from pychain_tpu.ops.factorized import from_factorized_graph as j_from_fg
from pychain_tpu.utils import testgraphs as j_testgraphs

from pychain_tpu_torch.convert import factorized_from_numpy
from pychain_tpu_torch.graphs import compiler, factorize
from pychain_tpu_torch.graphs.fst import (FST, n_arcs, n_states,
                                          read_ark_sequential, write_ark)
from pychain_tpu_torch.ops.factorized import from_factorized_graph
from pychain_tpu_torch.utils import testgraphs

GRAPHS = [
    ("den-source", lambda m: m.denominator_fst(
        num_phones=10, seed=0, forward_pdf_mode="source")[0]),
    ("den-cross", lambda m: m.denominator_fst(
        num_phones=11, seed=1, forward_pdf_mode="cross")[0]),
    ("den-separate", lambda m: m.denominator_fst(
        num_phones=9, seed=2, forward_pdf_mode="separate")[0]),
    ("random", lambda m: m.random_fst(num_states=13, num_pdfs=7,
                                      max_arcs_per_state=4, seed=3)),
]


def _assert_same(a, b, path="graph"):
    """Recursive bit-equality of dataclass / array / scalar fields."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("name,make", GRAPHS)
def test_generators_compile_and_factorize_identically(name, make):
    fst, jfst = make(testgraphs), make(j_testgraphs)
    _assert_same(fst, jfst)
    for log_domain in (False, True):
        _assert_same(compiler.compile_fst(fst, log_domain),
                     j_compiler.compile_fst(jfst, log_domain))
    np.testing.assert_array_equal(compiler.leaky_probs(fst),
                                  j_compiler.leaky_probs(jfst))
    fg = factorize.factorize(compiler.compile_fst(fst))
    jfg = j_factorize.factorize(j_compiler.compile_fst(jfst))
    _assert_same(fg, jfg)     # every WParts field, perm, f_dst/g_src, ...
    v = np.arange(fg.num_states, dtype=np.float32)
    np.testing.assert_array_equal(factorize.permute_state_vector(fg, v),
                                  j_factorize.permute_state_vector(jfg, v))


def test_denominator_modes_reach_every_xsrc_mode():
    got = {}
    for mode in ("source", "cross", "separate"):
        fst, _ = testgraphs.denominator_fst(num_phones=10, seed=0,
                                            forward_pdf_mode=mode)
        got[mode] = factorize.factorize(compiler.compile_fst(fst)).xsrc_mode
    assert got == {"source": "identity", "cross": "matrix",
                   "separate": "stream"}


def test_port_arrays_equal_jax_arrays_through_convert():
    """from_factorized_graph in both packages, compared through the
    converter that carries the JAX arrays into the port."""
    fst, _ = testgraphs.denominator_fst(num_phones=10, seed=4,
                                        forward_pdf_mode="cross")
    cg = compiler.compile_fst(fst)
    leaky = compiler.leaky_probs(fst)
    init = np.zeros(cg.num_states, np.float32)
    init[cg.start_state] = 1.0
    fg = factorize.factorize(cg)
    mine = from_factorized_graph(fg, init, cg.final_probs, leaky)
    theirs = factorized_from_numpy(j_from_fg(
        j_factorize.factorize(j_compiler.compile_fst(fst)), init,
        cg.final_probs, leaky), device="cpu")
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            for g in dataclasses.fields(a):
                x, y = getattr(a, g.name), getattr(b, g.name)
                if hasattr(x, "numpy"):
                    np.testing.assert_array_equal(x.numpy(), y.numpy())
                else:
                    assert x == y
        elif hasattr(a, "numpy"):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            assert a == b


def test_fst_binary_roundtrip_and_bytes_match_jax(tmp_path):
    fst = testgraphs.random_fst(num_states=13, num_pdfs=7, seed=3)
    path = tmp_path / "a.fst"
    assert fst.write(str(path))
    _assert_same(FST.read(str(path)), fst)
    jpath = tmp_path / "b.fst"
    j_testgraphs.random_fst(num_states=13, num_pdfs=7, seed=3).write(
        str(jpath))
    assert path.read_bytes() == jpath.read_bytes()
    # and each package reads the other's file
    _assert_same(JFST.read(str(path)), FST.read(str(jpath)))
    assert n_states(fst) == 13 and n_arcs(fst) == fst.num_arcs


def test_fst_ark_and_text_roundtrip(tmp_path):
    fsts = {f"utt{i}": testgraphs.random_fst(num_states=5 + i, seed=i)
            for i in range(3)}
    path = str(tmp_path / "g.ark")
    offsets = write_ark(path, fsts)
    for key, fst in fsts.items():
        _assert_same(FST.read_ark(path, offsets[key]), fst)
    seq = dict(read_ark_sequential(path))
    assert set(seq) == set(fsts)
    fst = fsts["utt0"]
    _assert_same(FST.from_text(fst.to_text()), fst)
    lin = testgraphs.linear_fst([3, 1, 4])
    assert lin.num_states == 4 and list(lin.ilabels) == [4, 2, 5]


# ----------------------------------------------------------------------
# ChainGraphBatch's batched views (the reference's graph.py:73-194)
# ----------------------------------------------------------------------

VIEWS = ("forward_transitions", "backward_transitions",
         "forward_transition_probs", "backward_transition_probs",
         "forward_transition_indices", "backward_transition_indices",
         "initial_probs", "final_probs", "leaky_probs", "start_state")


def _view_batches(kind):
    """The same batch in both packages: a shared prob-domain denominator
    broadcast over 3 sequences, or a log-domain list of 3 graphs of
    different sizes padded past the largest."""
    import pychain_tpu as jp
    import pychain_tpu_torch as pt
    if kind == "shared":
        fst = testgraphs.denominator_fst(num_phones=10, seed=0)[0]
        return (jp.ChainGraphBatch(jp.ChainGraph(fst), 3),
                pt.ChainGraphBatch(pt.ChainGraph(fst), 3, device="cpu"))
    fsts = [testgraphs.random_fst(num_states=5 + 3 * i, num_pdfs=7,
                                  max_arcs_per_state=3, seed=i)
            for i in range(3)]
    K = max(n_arcs(f) for f in fsts) + 4
    S = max(n_states(f) for f in fsts) + 2
    return (jp.ChainGraphBatch([jp.ChainGraph(f, log_domain=True)
                                for f in fsts], max_num_transitions=K,
                               max_num_states=S),
            pt.ChainGraphBatch([pt.ChainGraph(f, log_domain=True)
                                for f in fsts], max_num_transitions=K,
                               max_num_states=S, device="cpu"))


def _assert_views(jb, pb, when):
    for name in VIEWS:
        want, got = getattr(jb, name), getattr(pb, name)
        if want is None:
            assert got is None, (name, when)
            continue
        want = np.asarray(want)
        assert got.device.type == "cpu" and got.shape == want.shape, name
        assert got.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{name} {when}")


@pytest.mark.parametrize("kind", ["shared", "list"])
def test_batched_views_match_jax(kind):
    jb, pb = _view_batches(kind)
    _assert_views(jb, pb, "as built")
    jb.reorder([2, 0, 1])
    pb.reorder([2, 0, 1])
    _assert_views(jb, pb, "after reorder")


@pytest.mark.parametrize("log_domain", [False, True],
                         ids=["prob-domain", "log-domain"])
def test_from_compiled_matches_jax(log_domain):
    """ChainGraph.from_compiled (no FST) against the JAX package's: the
    graph's arrays, its leaky and initial probabilities, and the batched
    views of a batch built from it."""
    import pychain_tpu as jp
    import pychain_tpu_torch as pt
    fst = (testgraphs.denominator_fst(num_phones=8, seed=4)[0]
           if not log_domain else
           testgraphs.random_fst(num_states=9, num_pdfs=6, seed=5))
    cg = compiler.compile_fst(fst, log_domain)
    jcg = j_compiler.compile_fst(fst, log_domain)
    S = cg.num_states
    if log_domain:
        init = np.full(S, -np.inf, np.float32)
        init[cg.start_state] = 0.0
        leaky = None
    else:
        leaky = compiler.leaky_probs(fst)
        init = leaky.copy()
    g = pt.ChainGraph.from_compiled(cg, init, leaky)
    jg = jp.ChainGraph.from_compiled(jcg, init, leaky)
    for name in ("num_states", "num_transitions", "start_state",
                 "num_pdfs", "log_domain"):
        assert getattr(g, name) == getattr(jg, name), name
    for name in ("forward_transitions", "forward_transition_probs",
                 "forward_transition_indices", "backward_transitions",
                 "backward_transition_probs", "backward_transition_indices",
                 "final_probs", "initial_probs", "leaky_probs"):
        want = getattr(jg, name)
        if want is None:
            assert getattr(g, name) is None, name
            continue
        got = np.asarray(getattr(g, name))
        assert got.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    if log_domain:
        jb = jp.ChainGraphBatch([jg], max_num_transitions=S * 4,
                                max_num_states=S + 1)
        pb = pt.ChainGraphBatch([g], max_num_transitions=S * 4,
                                max_num_states=S + 1, device="cpu")
    else:
        jb = jp.ChainGraphBatch(jg, 2)
        pb = pt.ChainGraphBatch(g, 2, device="cpu")
    _assert_views(jb, pb, "from_compiled")
