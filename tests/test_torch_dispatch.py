"""The engine each main path's batch resolves to under impl="auto".

chip_smoke.py drives seven main paths on the card; each batch class
below is built as that script builds it (the same graphs, at their full
state counts; numerator lists at a few sequences, since the class and
not the batch size decides), and must dispatch to the engine it took
before shared log-domain graphs and the gather engine came in: B1/B2
("pallas") for the headline denominator in both precisions (paths 1, 5,
6 at bench width, 7), B3/B4 ("stream") for the 12k-state one (path 4),
the plain version ("xla") for a phone-LM denominator with residual arcs
(path 6's PER gates), the closed form for linear numerators, the
semiring kernels for flat-start and constrained ones (paths 2, 3, 6).
Then main path 8's: the headline graph as a shared log-domain graph at
B=32 takes its factorized-log form on B1/B2, at C=2 for fact_fwd on an
H100 (132 SMs); main path 4's graph the same way takes B3/B4; and a
decoding graph's alignment batch (shared, log domain) still reads the
arc-id row and takes the closed form or the factorized form for a loss.
"""

import types

import numpy as np
import pytest

import pychain_tpu_torch as pt
from pychain_tpu_torch.graphs.builder import (ChainTopology,
                                              estimate_phone_lm,
                                              make_constrained_numerator,
                                              make_denominator_fst,
                                              make_numerator_fst)
from pychain_tpu_torch.loss import dispatch_arrays, resolved_engine
from pychain_tpu_torch.ops import fact_kernels as fk
from pychain_tpu_torch.ops.factorized import FactorizedArrays, is_fast
from pychain_tpu_torch.ops.fwdbwd import GraphArrays
from pychain_tpu_torch.ops.linear import LinearArrays
from pychain_tpu_torch.ops.semiring import SemiringArrays
from pychain_tpu_torch.utils.testgraphs import (denominator_fst, linear_fst,
                                                random_fst)

H100 = types.SimpleNamespace(multi_processor_count=132,
                             shared_memory_per_block_optin=232448)
HEADLINE = dict(num_phones=1500, states_per_phone=2, seed=0,
                bigram_fanout=30)
MAIN4 = dict(num_phones=6000, states_per_phone=2, num_pdfs=3000,
             bigram_fanout=30, forward_pdf_mode="separate")


def _den(kw, B, log_domain=False, tile_dtype=None):
    fst, _ = denominator_fst(**kw)
    return pt.ChainGraphBatch(pt.ChainGraph(fst, log_domain=log_domain), B,
                              tile_dtype=tile_dtype, device="cpu")


@pytest.mark.parametrize("path,kw,B,tile_dtype,want", [
    ("main path 1", HEADLINE, 128, None, "pallas"),
    ("main paths 1 fast, 5, 6 (bench width)", HEADLINE, 128, "bfloat16",
     "pallas"),
    ("main path 7", HEADLINE, 64, "bfloat16", "pallas"),
    ("main path 4", MAIN4, 128, None, "stream"),
    ("main path 4 fast", MAIN4, 128, "bfloat16", "stream"),
])
def test_denominators_keep_their_tier(path, kw, B, tile_dtype, want):
    g = dispatch_arrays(_den(kw, B, tile_dtype=tile_dtype))
    assert isinstance(g, FactorizedArrays) and not g.log_semantics, path
    assert resolved_engine(g) == want, path
    assert is_fast(g) == (tile_dtype is not None)


def test_phone_lm_denominator_keeps_the_plain_version():
    """Main path 6's PER gates (and wav_to_train): a built phone-LM
    denominator has residual arcs."""
    rng = np.random.RandomState(0)
    topo = ChainTopology(num_phones=24)
    lm = estimate_phone_lm([list(rng.randint(0, 24, size=12))
                            for _ in range(40)], num_phones=24, order=2)
    fst = make_denominator_fst(lm, topo)
    g = dispatch_arrays(pt.ChainGraphBatch(pt.ChainGraph(fst), 8,
                                           device="cpu"))
    assert resolved_engine(g) == "xla" and not fk.supports(g)
    # the same graph shared in the log domain (a decoder's): its loss
    # takes the factorized-log form on the plain version too
    log = pt.ChainGraphBatch(pt.ChainGraph(fst, log_domain=True), 8,
                             device="cpu")
    g = dispatch_arrays(log)
    assert g.log_semantics and resolved_engine(g) == "xla"
    assert log.semiring().rows == 1


def test_numerator_lists_keep_their_engines():
    rng = np.random.RandomState(1)
    topo = ChainTopology(num_phones=1500)
    lin = [pt.ChainGraph(linear_fst(rng.randint(0, 3000, size=500)),
                         log_domain=True) for _ in range(3)]
    assert isinstance(dispatch_arrays(pt.ChainGraphBatch(
        lin, max_num_transitions=500, max_num_states=501, device="cpu")),
        LinearArrays)
    phones = [rng.randint(0, 1500, size=n) for n in (100, 150, 120)]
    flat = [pt.ChainGraph(make_numerator_fst(p, topo), log_domain=True)
            for p in phones]
    g = dispatch_arrays(pt.ChainGraphBatch(flat, max_num_transitions=300,
                                           max_num_states=151,
                                           device="cpu"))
    assert isinstance(g, SemiringArrays) and g.rows == 3
    durs = [np.full(len(p), 3) for p in phones]
    cons = [pt.ChainGraph(make_constrained_numerator(p, d, topo,
                                                     tolerance=3),
                          log_domain=True) for p, d in zip(phones, durs)]
    g = dispatch_arrays(pt.ChainGraphBatch(
        cons, max_num_transitions=max(c.num_transitions for c in cons),
        max_num_states=max(c.num_states for c in cons), device="cpu"))
    assert isinstance(g, SemiringArrays)


def test_main_path_8_takes_b1_b2_at_two_ctas():
    batch = _den(HEADLINE, 32, log_domain=True)
    fa = dispatch_arrays(batch)
    assert isinstance(fa, FactorizedArrays) and fa.log_semantics
    assert fa.log_shifts is None and fa.s_pad == 3072
    assert resolved_engine(fa) == "pallas"
    assert fk.cluster_size(32, H100, fa, "fact_fwd") == 2
    assert fk.cluster_size(32, H100, fa, "fact_bwd") == 1
    assert batch._semiring is None
    fast = dispatch_arrays(_den(HEADLINE, 32, log_domain=True,
                                tile_dtype="bfloat16"))
    assert fast.log_semantics and is_fast(fast)
    assert resolved_engine(fast) == "pallas"
    assert isinstance(dispatch_arrays(batch, "gather"), GraphArrays)


def test_main_path_4_graph_in_the_log_domain_takes_b3_b4():
    fa = dispatch_arrays(_den(MAIN4, 8, log_domain=True))
    assert fa.log_semantics and resolved_engine(fa) == "stream"


def test_xl_list_keeps_the_semiring_kernels_and_gathers_on_request():
    gs = [pt.ChainGraph(random_fst(num_states=60, num_pdfs=50,
                                   max_arcs_per_state=5, seed=s),
                        log_domain=True) for s in range(3)]
    batch = pt.ChainGraphBatch(
        gs, max_num_transitions=max(g.num_transitions for g in gs),
        max_num_states=60, device="cpu")
    assert isinstance(dispatch_arrays(batch), SemiringArrays)
    g = dispatch_arrays(batch, "gather")
    assert isinstance(g, GraphArrays) and not g.shared and g.leaky is None
