"""The port's graph builder against the JAX package's.

graphs/builder.py is pure numpy host code copied into the port; given the
same arguments both must build arc-for-arc the same FSTs and the same
phone LMs, and read the same files the same way.
"""

import numpy as np
import pytest

from pychain_tpu.graphs import builder as jb

from pychain_tpu_torch.graphs import builder as pb

FST_FIELDS = ("start", "final", "arc_offsets", "ilabels", "olabels",
              "weights", "nextstates")


def _same_fst(a, b):
    for f in FST_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
        assert np.asarray(getattr(a, f)).dtype == np.asarray(
            getattr(b, f)).dtype, f


def _transcripts(seed=0, n=12, num_phones=7):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, num_phones, size=rng.randint(2, 9)))
            for _ in range(n)]


@pytest.mark.parametrize("order,max_states", [(1, None), (2, None),
                                              (3, 20)])
def test_phone_lm_and_denominator_identical(order, max_states):
    tr = _transcripts()
    jlm = jb.estimate_phone_lm(tr, num_phones=7, order=order,
                               max_states=max_states)
    plm = pb.estimate_phone_lm(tr, num_phones=7, order=order,
                               max_states=max_states)
    assert plm.histories == jlm.histories and plm.start == jlm.start
    for f in ("probs", "final", "next_state"):
        np.testing.assert_array_equal(getattr(plm, f), getattr(jlm, f))
    assert plm.score(tr[0]) == jlm.score(tr[0])
    for shared in (False, True):
        jt = jb.ChainTopology(7, shared_pdfs=shared)
        pt_ = pb.ChainTopology(7, shared_pdfs=shared)
        assert pt_.num_pdfs == jt.num_pdfs
        for prune in (0.0, 0.05):
            _same_fst(pb.make_denominator_fst(plm, pt_, prune_prob=prune),
                      jb.make_denominator_fst(jlm, jt, prune_prob=prune))


def test_numerators_identical():
    tr = _transcripts(seed=1)
    jlm = jb.estimate_phone_lm(tr, num_phones=7)
    plm = pb.estimate_phone_lm(tr, num_phones=7)
    jt, pt_ = jb.ChainTopology(7), pb.ChainTopology(7)
    for phones in tr[:4]:
        _same_fst(pb.make_numerator_fst(phones, pt_),
                  jb.make_numerator_fst(phones, jt))
        _same_fst(pb.make_numerator_fst(phones, pt_, lm=plm),
                  jb.make_numerator_fst(phones, jt, lm=jlm))
    # the flat-start graph: N phones -> N + 1 states, 2 N arcs
    fst = pb.make_numerator_fst([3, 1, 4], pt_)
    assert fst.num_states == 4 and fst.num_arcs == 6
    durs = [2, 1, 3]
    for first in (False, True):
        _same_fst(pb.make_constrained_numerator([3, 1, 4], durs, pt_, 1,
                                                first_is_continuation=first),
                  jb.make_constrained_numerator([3, 1, 4], durs, jt, 1,
                                                first_is_continuation=first))
        assert pb.alignment_to_pdf_sequence([3, 1, 4], durs, pt_, first) \
            == jb.alignment_to_pdf_sequence([3, 1, 4], durs, jt, first)
    states = np.array([1, 1, 2, 3, 3, 3, -1])
    assert pb.durations_from_alignment(states) == \
        jb.durations_from_alignment(states) == [2, 1, 3]
    for bad in (lambda m: m.make_numerator_fst([], m.ChainTopology(3)),
                lambda m: m.ChainTopology(3).fwd_pdf(3),
                lambda m: m.ChainTopology(3, self_loop_prob=1.0)):
        with pytest.raises(ValueError):
            bad(pb)
        with pytest.raises(ValueError):
            bad(jb)


def test_readers_and_lm_file_identical(tmp_path):
    lex = tmp_path / "lexicon.txt"
    lex.write_text("a 1 2\nb 3\na 4 4\n\nc 0 5 6\n")
    text = tmp_path / "text"
    text.write_text("u1 a b\nu2 c a\n")
    ids = tmp_path / "ids"
    ids.write_text("u1 1 2 3\nu2 4\n")
    assert pb.read_lexicon(str(lex)) == jb.read_lexicon(str(lex))
    lexicon = pb.read_lexicon(str(lex))
    assert pb.read_transcripts(str(text), lexicon) == \
        jb.read_transcripts(str(text), lexicon) == \
        {"u1": [1, 2, 3], "u2": [0, 5, 6, 1, 2]}
    assert pb.read_transcripts(str(ids)) == jb.read_transcripts(str(ids))
    plm = pb.estimate_phone_lm(_transcripts(seed=2), num_phones=7, order=3)
    plm.save(str(tmp_path / "lm"))
    jlm = jb.PhoneLM.load(str(tmp_path / "lm"))
    back = pb.PhoneLM.load(str(tmp_path / "lm"))
    assert back.histories == jlm.histories == plm.histories
    np.testing.assert_array_equal(back.probs, jlm.probs)
    assert pb.EOS == jb.EOS
