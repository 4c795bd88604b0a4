#!/usr/bin/env python3
"""Offline graph-building CLI: the native counterpart of Kaldi's
``chain-est-phone-lm | chain-make-den-fst | chain-get-supervision``
stage (the port of ``tools/build_graphs.py``, flag for flag, the same
files byte for byte).

Reads a data dir with ``text`` (integer phone ids, or words with
``lexicon.txt`` beside it) and writes the artifacts the training
recipes (and the reference's own consumers) expect:

    den.fst        denominator graph (OpenFST binary VectorFst)
    num.ark        per-utterance numerator FSTs (Kaldi ark)
    num.scp        byte-offset index into num.ark
    phone_lm.npz   the phone LM (``PhoneLM.load``, for decoding)

Usage:
    python -m pychain_tpu_torch.tools.build_graphs --data-dir DIR \\
        [--order 3] [--max-lm-states 2000] [--num-style flat] \\
        [--self-loop-prob 0.5] [--prune-prob 0.0]

Numerator styles: ``flat`` (default: flat-start, no alignment needed)
or ``linear`` (transcripts are frame-level pdf sequences already).  It
builds host-side graphs only and touches no device.
"""

from __future__ import annotations

import argparse
import os

from pychain_tpu_torch.data import write_scp
from pychain_tpu_torch.graphs import (ChainTopology, FST, estimate_phone_lm,
                                      make_denominator_fst,
                                      make_numerator_fst, read_lexicon,
                                      read_transcripts, write_ark)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--order", type=int, default=2,
                    help="phone LM n-gram order")
    ap.add_argument("--max-lm-states", type=int, default=2000,
                    help="history-state budget for order >= 3")
    ap.add_argument("--num-style", choices=("flat", "linear"),
                    default="flat")
    ap.add_argument("--self-loop-prob", type=float, default=0.5)
    ap.add_argument("--prune-prob", type=float, default=0.0,
                    help="drop denominator arcs below this LM "
                         "probability (renormalized)")
    args = ap.parse_args(argv)

    d = args.data_dir
    text_path = os.path.join(d, "text")
    if not os.path.exists(text_path):
        ap.error(f"{text_path} not found")
    lex_path = os.path.join(d, "lexicon.txt")
    lexicon = read_lexicon(lex_path) if os.path.exists(lex_path) else None
    transcripts = read_transcripts(text_path, lexicon)
    if not transcripts:
        ap.error(f"{text_path} has no transcripts")
    num_phones = 1 + max(max(t) for t in transcripts.values() if t)
    topo = ChainTopology(num_phones=num_phones,
                         self_loop_prob=args.self_loop_prob)

    lm = estimate_phone_lm(list(transcripts.values()),
                           num_phones=num_phones, order=args.order,
                           max_states=args.max_lm_states)
    lm.save(os.path.join(d, "phone_lm.npz"))  # for PhoneLM.load / decoding
    den = make_denominator_fst(lm, topo, prune_prob=args.prune_prob)
    den.write(os.path.join(d, "den.fst"))
    print(f"den.fst: S={den.num_states} K={den.num_arcs} "
          f"(LM order {args.order}, {lm.num_states} LM states, "
          f"{num_phones} phones)")

    if args.num_style == "flat":
        fsts = {k: make_numerator_fst(t, topo)
                for k, t in transcripts.items() if t}
    else:
        fsts = {k: FST.linear(t) for k, t in transcripts.items() if t}
    ark_path = os.path.join(d, "num.ark")
    offsets = write_ark(ark_path, fsts)
    write_scp(os.path.join(d, "num.scp"), ark_path, offsets)
    print(f"num.ark/num.scp: {len(fsts)} numerator FSTs "
          f"({args.num_style})")


if __name__ == "__main__":
    main()
