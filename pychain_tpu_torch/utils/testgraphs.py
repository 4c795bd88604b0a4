"""Synthetic graph generators for tests and benchmarks.

The port's copy of ``pychain_tpu/utils/testgraphs.py`` (same generators,
same random streams, so both packages build the same graphs from a
seed).  Realistic graphs come from Kaldi (denominator FSTs from phone
LMs, linear numerator FSTs); these generators produce structurally
equivalent graphs at controllable sizes.
"""

from __future__ import annotations

import numpy as np

from ..graphs.fst import FST


def random_fst(num_states=8, num_pdfs=6, max_arcs_per_state=3, seed=0,
               all_final=True):
    """A small random ergodic FST; every state has out-arcs, and (by
    default) every state is final so every path length is viable."""
    rng = np.random.RandomState(seed)
    arcs = []
    for s in range(num_states):
        n = rng.randint(1, max_arcs_per_state + 1)
        for _ in range(n):
            dst = int(rng.randint(0, num_states))
            pdf = int(rng.randint(0, num_pdfs))
            w = float(rng.uniform(0.1, 2.0))  # tropical weight = -log prob
            arcs.append((s, dst, pdf + 1, pdf + 1, w))
    finals = {}
    for s in range(num_states):
        if all_final or rng.rand() < 0.5 or s == num_states - 1:
            finals[s] = float(rng.uniform(0.0, 1.0))
    return FST.from_arcs(num_states, 0, arcs, finals)


def linear_fst(pdf_ids, seed=None):
    """Linear numerator FST over the given pdf sequence."""
    return FST.linear(pdf_ids)


def denominator_fst(num_phones=40, states_per_phone=2, num_pdfs=None,
                    seed=0, bigram_fanout=10, forward_pdf_mode="source"):
    """A denominator-like ergodic HMM from a synthetic phone bigram LM.

    Structure mirrors Kaldi chain denominator graphs: each phone is an
    HMM of ``states_per_phone`` states (self-loop + forward arc, each
    with its own pdf), and phone end states connect to the start states
    of ``bigram_fanout`` randomly-chosen following phones with bigram
    probabilities.  Sizes: S = num_phones * states_per_phone,
    K ~ S * (2 + ...) — e.g. num_phones=1500, states_per_phone=2 gives
    S=3000, K~48k, matching the "trigram phone LM (~3k states)" baseline
    config.

    ``forward_pdf_mode`` controls what within-phone forward arcs emit,
    to exercise the three emission-attachment regimes of the
    factorizing compiler (graphs/factorize.py xsrc_mode):

    * "source" (default): the source state's own pdf — x_src == x_dst
      ("identity"),
    * "cross": another state's self-loop pdf — x_src reachable from
      x_dst through a one-hot state map ("matrix"),
    * "separate": a dedicated forward pdf per state, as in Kaldi's
      actual chain topology (self-loop pdf != forward pdf) — x_src
      needs its own gathered stream ("stream").
    """
    rng = np.random.RandomState(seed)
    S = num_phones * states_per_phone
    if num_pdfs is None:
        num_pdfs = 2 * num_phones  # one pdf per (phone, hmm-position)

    def state(phone, pos):
        return phone * states_per_phone + pos

    def pdf(phone, pos):
        return (phone * states_per_phone + pos) % num_pdfs

    def fwd_pdf(phone, pos):
        if forward_pdf_mode == "separate":
            return num_pdfs + pdf(phone, pos)
        if forward_pdf_mode == "cross":
            return pdf((phone + 1) % num_phones, 0)
        return pdf(phone, pos)

    arcs = []
    finals = {}
    for ph in range(num_phones):
        for pos in range(states_per_phone):
            s = state(ph, pos)
            # self loop
            arcs.append((s, s, pdf(ph, pos) + 1, pdf(ph, pos) + 1,
                         float(rng.uniform(0.3, 1.2))))
            if pos + 1 < states_per_phone:
                arcs.append((s, state(ph, pos + 1), fwd_pdf(ph, pos) + 1,
                             fwd_pdf(ph, pos) + 1,
                             float(rng.uniform(0.3, 1.2))))
        # phone-final state transitions to next phones' first states
        end = state(ph, states_per_phone - 1)
        nxt = rng.choice(num_phones, size=min(bigram_fanout, num_phones),
                         replace=False)
        for nph in nxt:
            arcs.append((end, state(int(nph), 0), pdf(int(nph), 0) + 1,
                         pdf(int(nph), 0) + 1, float(rng.uniform(0.5, 3.0))))
        finals[end] = float(rng.uniform(0.5, 2.0))
    total_pdfs = (2 * num_pdfs if forward_pdf_mode == "separate"
                  else num_pdfs)
    return FST.from_arcs(S, 0, arcs, finals), total_pdfs


def sausage_fst(pdf_alternatives, seed=0):
    """A time-synchronous 'sausage' supervision FST: at frame t, any of
    ``pdf_alternatives[t]`` (a list of pdf ids) may be emitted, each
    leading to the next level.  Mirrors the shape of Kaldi chain
    numerator supervision (time-constrained lattices); width-1
    everywhere reduces to a linear FST."""
    rng = np.random.RandomState(seed)
    arcs = []
    num_states = 1
    prev_level = [0]
    for alts in pdf_alternatives:
        width = max(1, min(len(alts), 4))
        level = list(range(num_states, num_states + width))
        num_states += width
        for j, pdf in enumerate(alts[:width]):
            dst = level[j % width]
            for s in prev_level:
                arcs.append((s, dst, int(pdf) + 1, int(pdf) + 1,
                             float(rng.uniform(0.0, 0.5))))
        prev_level = level
    finals = {s: float(rng.uniform(0.0, 0.5)) for s in prev_level}
    return FST.from_arcs(num_states, 0, arcs, finals)


def entry_chain_fst(fst, n, entry_label=1, chain_label=2):
    """``fst`` entered through a chain of ``n`` new states (numbered after
    its own, the first of them the start), so that no path is shorter
    than n + the shortest path of ``fst``: a length below that is
    infeasible for every sequence, a dead column in a shared graph.  The
    arc into the old start carries ``entry_label`` (a denominator_fst's
    start state is entered on label 1, so its emission stays that of
    the state's other in-arcs and the graph still factorizes fully);
    the chain's other arcs carry ``chain_label``.  Not in the JAX
    package's copy."""
    S = fst.num_states
    arcs = [(S + i, S + i + 1, chain_label, chain_label, 0.2)
            for i in range(n - 1)]
    arcs.append((S + n - 1, fst.start, entry_label, entry_label, 0.1))
    for s in range(S):
        il, ol, w, nxt = fst.state_arcs(s)
        arcs.extend((s, int(d), int(a), int(b), float(x))
                    for a, b, x, d in zip(il, ol, w, nxt))
    finals = {s: float(fst.final[s]) for s in range(S)
              if np.isfinite(fst.final[s])}
    return FST.from_arcs(S + n, S, arcs, finals)
