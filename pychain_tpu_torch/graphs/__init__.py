from .fst import FST, read_ark_sequential, write_ark
from .compiler import CompiledGraph, compile_fst, leaky_probs
from .factorize import FactorizedGraph, WParts
from .builder import (ChainTopology, PhoneLM, alignment_to_pdf_sequence,
                      durations_from_alignment, estimate_phone_lm,
                      make_constrained_numerator, make_denominator_fst,
                      make_numerator_fst, read_lexicon, read_transcripts,
                      words_to_phones)

__all__ = [
    "FST",
    "read_ark_sequential",
    "write_ark",
    "CompiledGraph",
    "compile_fst",
    "leaky_probs",
    "FactorizedGraph",
    "WParts",
    "ChainTopology",
    "PhoneLM",
    "alignment_to_pdf_sequence",
    "estimate_phone_lm",
    "durations_from_alignment",
    "make_constrained_numerator",
    "make_denominator_fst",
    "make_numerator_fst",
    "read_lexicon",
    "read_transcripts",
    "words_to_phones",
]
