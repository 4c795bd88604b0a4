"""Chain graph construction from transcripts — no Kaldi required.

The port's copy of ``pychain_tpu/graphs/builder.py`` (pure numpy host
code; given the same arguments it builds arc-for-arc the same FSTs,
tests/test_torch_builder.py).  The reference (pychain) consumes graphs
produced offline by Kaldi's chain pipeline and never builds them itself
(the library starts at ``StdVectorFst::Read``, fstext.cc:177-179).  This
module rebuilds that offline pipeline natively, so a user can go
``transcripts -> den.fst + numerator FSTs`` with no external toolkit:

* :func:`estimate_phone_lm` — an interpolated, backoff-free n-gram
  phone LM as a closed automaton (the role of Kaldi's
  ``chain-est-phone-lm``: no backoff arcs, so the composed denominator
  graph needs no epsilon-removal/determinization),
* :func:`make_denominator_fst` — LM ∘ HMM-topology composition (the
  role of ``chain-make-den-fst``); every state's out-probabilities sum
  to exactly 1 (self-loop + forward arcs + final), i.e. the graph is
  stochastic, which bounds every numerator path's probability by the
  denominator total,
* :func:`make_numerator_fst` — flat-start ("end-to-end LF-MMI",
  Hadian et al. 2018) supervision: the transcript composed with the
  topology, self-loops included, no time constraints.  Runs on the
  semiring kernels (``ops/semiring_kernels.py``),
* :func:`alignment_to_pdf_sequence` — aligned supervision: with phone
  durations, the numerator collapses to a linear pdf sequence
  (``FST.linear``) and runs on the closed-form linear engine.

The HMM topology matches Kaldi's chain default ("one emitting state
per phone, traversable in one frame"): entering a phone emits its
*forward* pdf, staying in it emits its *self-loop* pdf
(:class:`ChainTopology`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .fst import FST

_BOS = -1  # beginning-of-sentence context marker (never a phone id)
EOS = -2   # end-of-sentence "word" in LM rows (exposed for tests)


# ----------------------------------------------------------------------
# HMM topology
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class ChainTopology:
    """Kaldi-chain-style phone HMM topology.

    Each phone has one emitting state: the arc *into* the phone emits
    ``fwd_pdf(p)`` and the self-loop emits ``self_pdf(p)``.  With
    ``shared_pdfs=True`` both collapse to one pdf per phone (the
    'shared' topology some flat-start recipes use).
    """

    num_phones: int
    shared_pdfs: bool = False
    self_loop_prob: float = 0.5

    def __post_init__(self):
        if not (0.0 < self.self_loop_prob < 1.0):
            raise ValueError("self_loop_prob must be in (0, 1)")
        if self.num_phones < 1:
            raise ValueError("need at least one phone")

    @property
    def num_pdfs(self) -> int:
        return self.num_phones if self.shared_pdfs else 2 * self.num_phones

    def fwd_pdf(self, phone: int) -> int:
        self._check(phone)
        return phone if self.shared_pdfs else 2 * phone

    def self_pdf(self, phone: int) -> int:
        self._check(phone)
        return phone if self.shared_pdfs else 2 * phone + 1

    def _check(self, phone: int) -> None:
        if not (0 <= phone < self.num_phones):
            raise ValueError(f"phone {phone} out of range "
                             f"[0, {self.num_phones})")


# ----------------------------------------------------------------------
# Phone n-gram LM (closed automaton, no backoff arcs)
# ----------------------------------------------------------------------

class PhoneLM:
    """An interpolated n-gram LM over phones as a closed automaton.

    States are phone histories (suffix-closed set of tuples).  Row
    ``probs[s]`` is a dense distribution over the ``num_phones`` next
    phones; ``final[s]`` is P(EOS | history).  Each row + its final
    sums to 1.  ``next_state[s, p]`` is the state reached by emitting
    phone ``p`` (always defined — no backoff arcs; dropped long
    histories are merged into their longest kept suffix at estimation
    time, which is how Kaldi's chain-est-phone-lm stays epsilon-free).
    """

    def __init__(self, order, num_phones, histories, probs, final,
                 next_state):
        self.order = order
        self.num_phones = num_phones
        self.histories = histories          # list[tuple[int, ...]]
        self.state_index = {h: i for i, h in enumerate(histories)}
        self.probs = probs                  # (S, P) float64
        self.final = final                  # (S,) float64
        self.next_state = next_state        # (S, P) int32

    @property
    def num_states(self) -> int:
        return len(self.histories)

    @property
    def start(self) -> int:
        h = (_BOS,) * (self.order - 1)
        while h not in self.state_index:
            h = h[1:]
        return self.state_index[h]

    def save(self, path: str) -> None:
        """Persist to an .npz (histories flattened with -3 separators —
        phone ids are >= 0 and BOS/EOS are -1/-2, so -3 is free).
        The .npz suffix is normalized on BOTH save and load so
        ``save(p)``/``load(p)`` round-trips for any p (np.savez
        auto-appends it, np.load does not)."""
        flat = []
        for h in self.histories:
            flat.extend(h)
            flat.append(-3)
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, order=self.order, num_phones=self.num_phones,
                 histories=np.asarray(flat, np.int64),
                 probs=self.probs, final=self.final,
                 next_state=self.next_state)

    @staticmethod
    def load(path: str) -> "PhoneLM":
        import os
        if not path.endswith(".npz") and not os.path.exists(path):
            path += ".npz"
        z = np.load(path)
        histories, cur = [], []
        for v in z["histories"]:
            if v == -3:
                histories.append(tuple(int(p) for p in cur))
                cur = []
            else:
                cur.append(int(v))
        return PhoneLM(int(z["order"]), int(z["num_phones"]), histories,
                       z["probs"], z["final"], z["next_state"])

    def score(self, phones) -> float:
        """Log-probability (natural log) of one transcript, including
        the EOS event — the exact score the denominator graph assigns
        to this phone path (before HMM transition probs)."""
        s = self.start
        lp = 0.0
        for p in phones:
            lp += float(np.log(self.probs[s, p]))
            s = int(self.next_state[s, p])
        return lp + float(np.log(self.final[s]))


def _suffixes(h):
    for i in range(len(h) + 1):
        yield h[i:]


def estimate_phone_lm(transcripts, num_phones=None, order=2,
                      interp=1.0, max_states=None,
                      min_history_count=1) -> PhoneLM:
    """Estimate a :class:`PhoneLM` from phone-id transcripts.

    Probabilities are recursively interpolated (Jelinek-Mercer with
    count-independent weight ``interp``):

        P_k(w|h) = (c(h,w) + interp * P_{k-1}(w|h[1:])) / (c(h) + interp)

    with an add-one base case over phones+EOS, so every row is a
    proper distribution.  Histories of maximal length are kept only if
    seen >= ``min_history_count`` times (and at most ``max_states`` of
    them, most frequent first); dropped histories merge into their
    longest kept suffix — the automaton stays closed with NO backoff
    arcs, exactly the property Kaldi's denominator pipeline relies on
    to avoid epsilon-removal of the composed graph.
    """
    transcripts = [list(map(int, t)) for t in transcripts]
    if not transcripts or all(len(t) == 0 for t in transcripts):
        raise ValueError("need at least one non-empty transcript")
    if num_phones is None:
        num_phones = max(max(t) for t in transcripts if t) + 1
    if order < 1:
        raise ValueError("order must be >= 1")
    for t in transcripts:
        for p in t:
            if not (0 <= p < num_phones):
                raise ValueError(f"phone id {p} out of range")

    # --- n-gram counts for every history length 0..order-1 ------------
    ctx_counts = [dict() for _ in range(order)]   # h -> count(h, *)
    ng_counts = [dict() for _ in range(order)]    # h -> {w: count}
    for t in transcripts:
        padded = [_BOS] * (order - 1) + t + [EOS]
        for i in range(order - 1, len(padded)):
            w = padded[i]
            for k in range(order):               # history length k
                h = tuple(padded[i - k:i])
                ctx_counts[k][h] = ctx_counts[k].get(h, 0) + 1
                ng_counts[k].setdefault(h, {})
                ng_counts[k][h][w] = ng_counts[k][h].get(w, 0) + 1

    # --- choose the kept (suffix-closed) history set -------------------
    kept = set()
    for k in range(min(order - 1, 1) + 1):       # always keep len 0, 1
        if k <= order - 1:
            kept.update(h for h in ctx_counts[k])
    kept.add(())
    long_hists = []
    for k in range(2, order):
        long_hists += [(ctx_counts[k][h], h) for h in ctx_counts[k]
                       if ctx_counts[k][h] >= min_history_count]
    long_hists.sort(key=lambda ch: (-ch[0], ch[1]))
    if max_states is not None:
        budget = max(0, max_states - len(kept))
        long_hists = long_hists[:budget]
    for _, h in long_hists:
        kept.add(h)
    # suffix-close (a kept history's suffixes must be states too)
    for h in list(kept):
        for s in _suffixes(h):
            kept.add(s)
    histories = sorted(kept, key=lambda h: (len(h), h))

    # --- interpolated probabilities ------------------------------------
    vocab = num_phones + 1                       # + EOS

    def prob(h, w):
        if len(h) == 0:
            c = ng_counts[0].get((), {}).get(w, 0)
            n = ctx_counts[0].get((), 0)
            return (c + 1.0) / (n + vocab)       # add-one base case
        k = len(h)
        c_hw = ng_counts[k].get(h, {}).get(w, 0)
        c_h = ctx_counts[k].get(h, 0)
        return (c_hw + interp * prob(h[1:], w)) / (c_h + interp)

    S = len(histories)
    probs = np.zeros((S, num_phones), np.float64)
    final = np.zeros(S, np.float64)
    next_state = np.zeros((S, num_phones), np.int32)
    index = {h: i for i, h in enumerate(histories)}

    def dest(h, p):
        nh = (h + (p,))[-(order - 1):] if order > 1 else ()
        while nh not in index:
            nh = nh[1:]
        return index[nh]

    for i, h in enumerate(histories):
        for p in range(num_phones):
            probs[i, p] = prob(h, p)
            next_state[i, p] = dest(h, p)
        final[i] = prob(h, EOS)

    return PhoneLM(order, num_phones, histories, probs, final, next_state)


# ----------------------------------------------------------------------
# Denominator graph: LM ∘ topology
# ----------------------------------------------------------------------

def make_denominator_fst(lm: PhoneLM, topo: ChainTopology,
                         prune_prob: float = 0.0) -> FST:
    """Compose the phone LM with the HMM topology into a denominator
    FST (the role of Kaldi's ``chain-make-den-fst``).

    Composed states are (LM state, current phone) pairs plus one
    initial state.  Every state is stochastic: self-loop ``sigma`` +
    forward arcs ``(1-sigma) * P(q|h)`` + final ``(1-sigma) * P(EOS|h)``
    sum to exactly 1 (the initial state has no self-loop).  Weights are
    tropical (-log p), pdfs follow ``topo``.

    ``prune_prob`` drops forward arcs with LM probability below the
    threshold and renormalizes the surviving row, trading exactness
    for graph size (Kaldi keeps bigrams dense; so does the default).
    """
    if topo.num_phones != lm.num_phones:
        raise ValueError("topology/LM phone-count mismatch: "
                         f"{topo.num_phones} vs {lm.num_phones}")
    sigma = topo.self_loop_prob

    rows = np.array(lm.probs, np.float64, copy=True)
    finals_lm = np.array(lm.final, np.float64, copy=True)
    if prune_prob > 0.0:
        rows[rows < prune_prob] = 0.0
        if (rows.sum(axis=1) == 0).any():
            raise ValueError("prune_prob removed every arc of a state")
        scale = (1.0 - finals_lm) / rows.sum(axis=1)
        rows *= scale[:, None]

    # composed state ids: 0 = initial; (lm_state, phone) discovered by BFS
    state_of = {}
    order_found = []

    def composed(lm_s, phone):
        key = (lm_s, phone)
        if key not in state_of:
            state_of[key] = 1 + len(order_found)
            order_found.append(key)
        return state_of[key]

    arcs = []
    finals = {}
    start_lm = lm.start

    def expand(src_id, lm_s, leave_prob):
        """Forward arcs + final of a state whose LM context is lm_s."""
        for q in range(lm.num_phones):
            pq = rows[lm_s, q]
            if pq <= 0.0:
                continue
            dst = composed(int(lm.next_state[lm_s, q]), q)
            w = -float(np.log(leave_prob * pq))
            lbl = topo.fwd_pdf(q) + 1
            arcs.append((src_id, dst, lbl, lbl, w))
        f = leave_prob * finals_lm[lm_s]
        if f > 0.0:
            finals[src_id] = -float(np.log(f))

    expand(0, start_lm, 1.0)                      # initial: no self-loop
    i = 0
    while i < len(order_found):                   # BFS over discovered
        lm_s, phone = order_found[i]
        sid = i + 1
        lbl = topo.self_pdf(phone) + 1
        arcs.append((sid, sid, lbl, lbl, -float(np.log(sigma))))
        expand(sid, lm_s, 1.0 - sigma)
        i += 1

    return FST.from_arcs(1 + len(order_found), 0, arcs, finals)


# ----------------------------------------------------------------------
# Numerator supervision
# ----------------------------------------------------------------------

def make_numerator_fst(phones, topo: ChainTopology,
                       lm: PhoneLM = None) -> FST:
    """Flat-start (end-to-end LF-MMI) numerator: the transcript
    composed with the topology — state per phone position, self-loops
    included, no time constraints.  Dispatches to the semiring kernels.

    With ``lm`` given, arcs carry the SAME scores the denominator
    assigns this path (LM probs × HMM transition probs), making every
    numerator path an exact denominator path — so
    ``num objf <= den objf`` holds for any emissions (the property the
    tests pin).  Without it, weights are 0 (the usual flat-start
    convention; the LM score is a constant offset per utterance).
    """
    phones = [int(p) for p in phones]
    if not phones:
        raise ValueError("empty transcript")
    sigma = topo.self_loop_prob
    use_lm = lm is not None
    if use_lm and lm.num_phones != topo.num_phones:
        raise ValueError("topology/LM phone-count mismatch")

    def nlog(p):
        return -float(np.log(p))

    arcs = []
    lm_s = lm.start if use_lm else None
    n = len(phones)
    for i, p in enumerate(phones):
        if use_lm:
            leave = 1.0 if i == 0 else 1.0 - sigma  # initial has no loop
            enter = nlog(leave * lm.probs[lm_s, p])
        else:
            enter = 0.0
        lbl = topo.fwd_pdf(p) + 1
        arcs.append((i, i + 1, lbl, lbl, enter))
        loop = topo.self_pdf(p) + 1
        arcs.append((i + 1, i + 1, loop, loop,
                     nlog(sigma) if use_lm else 0.0))
        if use_lm:
            lm_s = int(lm.next_state[lm_s, p])
    final = nlog((1.0 - sigma) * lm.final[lm_s]) if use_lm else 0.0
    return FST.from_arcs(n + 1, 0, arcs, {n: final})


def make_constrained_numerator(phones, durations, topo: ChainTopology,
                               tolerance: int = 5,
                               first_is_continuation: bool = False) -> FST:
    """Tolerance-constrained supervision (the style of Kaldi's
    ``chain-get-supervision``): phone boundaries may move up to
    ``tolerance`` frames from the alignment, no further.

    The graph is time-synchronous by construction — state (t, i) means
    "frame t-1 was in phone i", every arc advances one frame — so it
    levelizes with level width <= 2*tolerance + 1 and dispatches to the
    banded leveled engine — provided the pruned width stays within the
    engine's cap (16 slots, i.e. tolerance <= ~7 with short phones;
    beyond it the graph still computes correctly on the generic gather
    engine, and a UserWarning flags the downgrade).  ``tolerance=0``
    degenerates to the exact aligned linear path; ``tolerance=inf``
    would recover the flat-start graph of :func:`make_numerator_fst`
    (which is cyclic and cheaper to use directly).  Arc weights are 0
    (flat-start convention).

    ``first_is_continuation``: the sequence starts INSIDE phones[0]
    (a chunk boundary cut it), so the first frame emits its self-loop
    pdf, not its forward pdf — the convention Kaldi's chunked chain
    supervision uses for split utterances.
    """
    phones = [int(p) for p in phones]
    durations = [int(d) for d in durations]
    if not phones:
        raise ValueError("empty transcript")
    if len(phones) != len(durations):
        raise ValueError("phones and durations must have equal length")
    if any(d < 1 for d in durations):
        raise ValueError("every phone needs at least one frame")
    if tolerance < 0:
        raise ValueError("tolerance must be >= 0")
    n = len(phones)
    T = int(sum(durations))
    starts = np.cumsum([0] + durations[:-1])
    ends = starts + np.asarray(durations)        # phone i: [starts, ends)

    # allowed[t, i]: frame t may be in phone i (within tolerance window)
    t_idx = np.arange(T)[:, None]
    allowed = ((t_idx >= starts[None, :] - tolerance)
               & (t_idx <= ends[None, :] - 1 + tolerance))

    # forward reachability over states (tau, i), tau = t + 1
    fwd = np.zeros((T + 1, n), bool)
    if allowed[0, 0]:
        fwd[1, 0] = True
    for tau in range(1, T):
        stay = fwd[tau] & allowed[tau]
        adv = np.zeros(n, bool)
        adv[1:] = fwd[tau, :-1] & allowed[tau, 1:]
        fwd[tau + 1] = stay | adv
    # backward co-reachability from the accepting state (T, n-1)
    bwd = np.zeros((T + 1, n), bool)
    bwd[T, n - 1] = fwd[T, n - 1]
    for tau in range(T - 1, 0, -1):
        # an arc out of (tau, i) emits frame tau, which belongs to the
        # DESTINATION phone: stay needs allowed[tau, i], advance needs
        # allowed[tau, i+1]
        stay = bwd[tau + 1] & allowed[tau]
        adv = np.zeros(n, bool)
        adv[:-1] = bwd[tau + 1, 1:] & allowed[tau, 1:]
        bwd[tau] = fwd[tau] & (stay | adv)
    keep = fwd & bwd
    if not keep[T, n - 1]:
        raise ValueError("no feasible path — inconsistent alignment")

    width = int(keep.sum(axis=1).max())
    if width > 16:
        import warnings
        warnings.warn(
            f"constrained supervision level width {width} exceeds the "
            "leveled engine's 16-slot cap; the graph will run on the "
            "generic gather engine (correct but slower) — use a smaller "
            "tolerance or the flat-start make_numerator_fst",
            UserWarning, stacklevel=2)

    ids = np.full((T + 1, n), -1, np.int64)
    count = 1                                    # 0 is the initial state
    for tau in range(1, T + 1):
        for i in np.nonzero(keep[tau])[0]:
            ids[tau, i] = count
            count += 1

    arcs = []
    if keep[1, 0]:
        lbl = (topo.self_pdf(phones[0]) if first_is_continuation
               else topo.fwd_pdf(phones[0])) + 1
        arcs.append((0, int(ids[1, 0]), lbl, lbl, 0.0))
    for tau in range(1, T):
        for i in np.nonzero(keep[tau])[0]:
            src = int(ids[tau, i])
            if keep[tau + 1, i]:
                lbl = topo.self_pdf(phones[i]) + 1
                arcs.append((src, int(ids[tau + 1, i]), lbl, lbl, 0.0))
            if i + 1 < n and keep[tau + 1, i + 1]:
                lbl = topo.fwd_pdf(phones[i + 1]) + 1
                arcs.append((src, int(ids[tau + 1, i + 1]), lbl, lbl, 0.0))
    return FST.from_arcs(count, 0, arcs, {int(ids[T, n - 1]): 0.0})


def read_lexicon(filename: str) -> dict:
    """Kaldi-style lexicon: ``word phone1 phone2 ...`` per line (phones
    as integer ids or symbols resolved by the caller).  Later entries
    for the same word are alternative pronunciations; the FIRST is
    used by :func:`words_to_phones` (matching the common
    lexicon-disambiguation default).  Returns
    {word: [pronunciations], ...} with each pronunciation a phone list.
    """
    lex = {}
    with open(filename) as f:
        for ln in f:
            parts = ln.split()
            if not parts:
                continue
            word, phones = parts[0], parts[1:]
            if not phones:
                raise ValueError(f"lexicon entry for {word!r} has no "
                                 "phones")
            lex.setdefault(word, []).append([int(p) for p in phones])
    return lex


def words_to_phones(words, lexicon: dict):
    """Expand a word transcript into a phone-id sequence using each
    word's first pronunciation."""
    phones = []
    for w in words:
        if w not in lexicon:
            raise KeyError(f"word {w!r} not in lexicon")
        phones.extend(lexicon[w][0])
    return phones


def read_transcripts(filename: str, lexicon: dict = None) -> dict:
    """Kaldi ``text`` file: ``utt-id token token ...`` per line.
    Tokens are integer phone ids, or words when ``lexicon`` is given.
    Returns {utt_id: phone-id list}."""
    out = {}
    with open(filename) as f:
        for ln in f:
            parts = ln.split()
            if not parts:
                continue
            utt, toks = parts[0], parts[1:]
            if lexicon is not None:
                out[utt] = words_to_phones(toks, lexicon)
            else:
                try:
                    out[utt] = [int(t) for t in toks]
                except ValueError as e:
                    raise ValueError(
                        f"{filename}: transcript for {utt} has "
                        "non-integer tokens; pass a lexicon to expand "
                        "words") from e
    return out


def durations_from_alignment(states, length=None):
    """Recover per-phone durations from a ``viterbi_align`` state
    sequence over a :func:`make_numerator_fst` graph (where state i+1
    is phone position i).  Closes the flat-start loop: train
    flat-start, align, re-train constrained
    (:func:`make_constrained_numerator`).

    ``states``: 1-D int array for ONE sequence (``result.states[b]``);
    ``length``: true frame count (default: count of non-negative
    entries).  Returns a list of durations, one per phone position.
    """
    states = np.asarray(states)
    if states.ndim != 1:
        raise ValueError("pass one sequence's states (1-D)")
    if length is None:
        length = int((states >= 0).sum())
    s = states[:length].astype(np.int64)
    if length == 0 or s.min() < 1:
        raise ValueError("not a valid numerator-graph alignment")
    steps = np.diff(s)
    if (steps < 0).any() or (steps > 1).any() or s[0] != 1:
        raise ValueError("states must start at 1 and advance by 0 or 1 "
                         "per frame (a make_numerator_fst path)")
    n = int(s[-1])
    durs = np.bincount(s, minlength=n + 1)[1:]
    return [int(d) for d in durs]


def alignment_to_pdf_sequence(phones, durations, topo: ChainTopology,
                              first_is_continuation: bool = False):
    """Aligned supervision: with per-phone frame counts, the numerator
    collapses to one pdf per frame — feed the result to ``FST.linear``
    and the closed-form linear engine handles it.

    Frame layout per phone (duration d >= 1): the entering frame emits
    ``fwd_pdf``, the remaining d-1 frames emit ``self_pdf`` — exactly
    the pdf sequence of the corresponding path through
    :func:`make_numerator_fst`'s graph.  With
    ``first_is_continuation`` the sequence starts inside phones[0]
    (chunk boundary), so its first frame emits the self-loop pdf.
    """
    phones = [int(p) for p in phones]
    durations = [int(d) for d in durations]
    if len(phones) != len(durations):
        raise ValueError("phones and durations must have equal length")
    seq = []
    for i, (p, d) in enumerate(zip(phones, durations)):
        if d < 1:
            raise ValueError("every phone needs at least one frame")
        if i == 0 and first_is_continuation:
            seq.append(topo.self_pdf(p))
        else:
            seq.append(topo.fwd_pdf(p))
        seq.extend([topo.self_pdf(p)] * (d - 1))
    return seq
