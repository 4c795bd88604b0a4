"""Chain graphs: graph objects and batched tensors.

The port's counterpart of ``pychain_tpu/graph.py`` (and of the
reference's ``pychain/graph.py``):

* :class:`ChainGraph` — one FST lowered to transition arrays (numpy),
  with ``initial_mode``/``final_mode``/``log_domain`` semantics matching
  graph.py:25-70 of the reference,
* :class:`ChainGraphBatch` — a batch of graphs as tensors on a device.

Batch forms: a shared prob-domain graph broadcast over the batch (the
denominator: factorized, ``ops/factorized.py``); a shared log-domain
graph (the decoding graph, bench.py --xlstream's denominator), which
the factorized engines serve in normalized-linear form
(``log_semantics``: its weights exp'd, shifted into float32's exp-safe
band where they lie outside it, leaky 0 at dispatch) with the arc-id
form that ``viterbi_align`` reads beside it; a list of log-domain graphs
(the numerators): linear chains in closed form (``ops/linear.py``), any
other graph (cyclic, self-loop, flat-start) in arc-id form for the
semiring kernels (``ops/semiring.py``); and a list of prob-domain graphs
(per-sequence leaky-HMM graphs), as dense blocks (``ops/dense_list.py``)
or on the generic gather engine (``ops/fwdbwd.py``).  Every batch has
that engine's arrays (:meth:`ChainGraphBatch.graph_arrays`,
``impl="gather"``) and the
reference's batched views (``forward_transitions`` and the rest,
graph.py:73-194), each built on first use.
"""

from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np
import torch

from .graphs.compiler import CompiledGraph, compile_fst, \
    leaky_probs as _leaky_probs
from .graphs.fst import FST, n_arcs, n_states
from .utils.device import resolve_device

NEG_INF = float("-inf")

# float32's exp-safe band: exp(w) keeps full relative precision for
# w in about [-87.3, 88.7].  A log-domain graph served in
# normalized-linear form with weights outside it would silently
# underflow to 0 (removing legal paths) or overflow to inf.  A centered
# shift re-admits spreads up to _EXP_SPREAD; wider graphs skip the
# factorized form (pychain_tpu/graph.py:40-49).
_EXP_LO, _EXP_HI = -87.0, 88.0
_EXP_SPREAD = 160.0


def _log_band_shifts(graph):
    """Shifts bringing a log-domain graph's finite weights into the
    float32 exp-safe band, or None when impossible (a spread over
    _EXP_SPREAD nats, or +inf/NaN weights).  Returns (arc, init, fin):
    subtracting them from the arc/initial/final log-weights rescales
    every length-L path by exp(-(arc L + init + fin)), which the loss
    adds back onto the objf (loss._run).  All zeros for a graph already
    in the band (the common normalized case)."""

    def shift_of(v):
        v = np.asarray(v)
        if np.isposinf(v).any() or np.isnan(v).any():
            return None
        f = v[np.isfinite(v)]
        if f.size == 0:
            return 0.0
        lo, hi = float(f.min()), float(f.max())
        if _EXP_LO <= lo and hi <= _EXP_HI:
            return 0.0
        if hi - lo > _EXP_SPREAD:
            return None
        return (lo + hi) / 2.0

    shifts = [shift_of(v) for v in (graph.forward_transition_probs,
                                    graph.initial_probs, graph.final_probs)]
    return None if None in shifts else tuple(shifts)


def _exp_shifted(v, shift):
    """exp(v - shift) taken in float64 and cast once to float32, as the
    JAX package takes it (so that the tiles are its bit for bit)."""
    return np.exp((np.asarray(v) - shift).astype(np.float64)).astype(
        np.float32)


class ChainGraph:
    """One chain-training graph (numerator or denominator).

    Mirrors reference graph.py:23-70: lowers the FST, computes leaky-HMM
    priors (prob domain), and builds initial/final state distributions.
    """

    def __init__(self, fst: FST, initial_mode: str = "fst",
                 final_mode: str = "fst", log_domain: bool = False):
        if initial_mode not in ("fst", "leaky"):
            raise ValueError(f"initial_mode must be 'fst' or 'leaky', got "
                             f"{initial_mode!r}")
        if final_mode not in ("fst", "ones"):
            raise ValueError(f"final_mode must be 'fst' or 'ones', got "
                             f"{final_mode!r}")
        if n_states(fst) == 0 or n_arcs(fst) == 0:
            raise Exception("An empty graph encountered!")  # graph.py:69-70
        self.log_domain = log_domain
        g = compile_fst(fst, log_domain=log_domain)
        self._set_compiled(g)

        S = self.num_states
        if log_domain:
            # graph.py:54-59 — no leaky HMM in log domain.
            if initial_mode != "fst":
                raise ValueError(
                    "'leaky' mode is incompatible with log domain")
            self.leaky_probs = None
            self.initial_probs = np.full(S, NEG_INF, np.float32)
            self.initial_probs[self.start_state] = 0.0
            if final_mode == "ones":
                self.final_probs = np.zeros(S, np.float32)
        else:
            # graph.py:61-68.
            self.leaky_probs = _leaky_probs(fst)
            if initial_mode == "fst":
                self.initial_probs = np.zeros(S, np.float32)
                self.initial_probs[self.start_state] = 1.0
            else:
                self.initial_probs = self.leaky_probs.copy()
            if final_mode == "ones":
                self.final_probs = np.ones(S, np.float32)

    @classmethod
    def from_compiled(cls, g: CompiledGraph, initial_probs,
                      leaky_probs=None) -> "ChainGraph":
        """A graph built directly from a :class:`CompiledGraph`, without
        the FST (``pychain_tpu/graph.py::ChainGraph.from_compiled``):
        ``initial_probs`` (S,) in the graph's domain and, for a
        prob-domain graph, its ``leaky_probs`` (S,)."""
        self = cls.__new__(cls)
        self.log_domain = g.log_domain
        self._set_compiled(g)
        self.initial_probs = np.asarray(initial_probs, np.float32)
        self.leaky_probs = None if leaky_probs is None else np.asarray(
            leaky_probs, np.float32)
        return self

    def _set_compiled(self, g: CompiledGraph):
        self.num_states = g.num_states
        self.num_transitions = g.num_transitions
        self.start_state = g.start_state
        self.is_empty = False
        # Widest pdf id referenced by any arc: the nnet output must have
        # at least this many columns.
        self.num_pdfs = int(g.forward_transitions[:, 2].max()) + 1
        self.forward_transitions = g.forward_transitions
        self.forward_transition_probs = g.forward_transition_probs
        self.forward_transition_indices = g.forward_transition_indices
        self.backward_transitions = g.backward_transitions
        self.backward_transition_probs = g.backward_transition_probs
        self.backward_transition_indices = g.backward_transition_indices
        self.final_probs = g.final_probs


class ChainGraphBatch:
    """A batch of graphs as tensors on ``device`` (graph.py:73-194).

    Built either from a single :class:`ChainGraph` plus ``batch_size``
    (broadcast: the shared denominator) or from a list of graphs plus
    ``max_num_transitions``/``max_num_states``.  ``device=None`` means
    ``"cuda"``; with no card that raises unless ``device="cpu"`` is given.
    """

    def __init__(self, graphs, batch_size=None, max_num_transitions=None,
                 max_num_states=None, tile_dtype=None, device=None):
        self.device = resolve_device(device)
        self._tile_dtype = tile_dtype
        self._fact = None
        self._linear = None
        self._semiring = None
        self._semiring_rows = None   # a shared graph's, B rows (the loss)
        self._dense_list = None      # prob-domain lists: built on demand
        self._graph = None
        self._graphs = None
        self._gather = None
        self._views = {}
        gs = graphs if isinstance(graphs, (list, tuple)) else [graphs]
        self.num_pdfs = max(
            (getattr(g, "num_pdfs", 0) for g in gs), default=0)
        if isinstance(graphs, ChainGraph):
            if not batch_size:
                raise ValueError(
                    "batch size should be specified to expand a single graph")
            self.batch_size = int(batch_size)
            self._init_by_one(graphs)
        elif isinstance(graphs, (list, tuple)):
            if not max_num_transitions:
                raise ValueError(
                    "max_num_transitions should be specified if given a "
                    "a list of ChainGraph objects to initialize from")
            if not max_num_states:
                raise ValueError(
                    "max_num_states should be specified if given a "
                    "a list of ChainGraph objects to initialize from")
            self.batch_size = len(graphs)
            self._init_by_list(list(graphs), int(max_num_transitions),
                               int(max_num_states))
        else:
            raise ValueError(
                "ChainGraphBatch should be either initialized by a single "
                "ChainGraph object or a list of ChainGraph objects but "
                "given {}".format(type(graphs)))

    # -- broadcast constructor (graph.py:203-305) ------------------------
    def _init_by_one(self, graph: ChainGraph):
        self.log_domain = graph.log_domain
        self.shared = True
        self.num_states = graph.num_states
        self.num_transitions = graph.num_transitions
        self._graph = graph
        from .graphs.factorize import factorize
        from .ops.factorized import from_factorized_graph
        if not graph.log_domain:
            fg = factorize(graph)
            self._fact = from_factorized_graph(
                fg, graph.initial_probs, graph.final_probs,
                graph.leaky_probs, tile_dtype=self._tile_dtype).to(
                    self.device)
            return
        # a shared log-domain graph is the same transition matrix with
        # log weights: exp'd (exact for hard zeros, after re-centering
        # out-of-band weights) the factorized engines serve it in
        # normalized-linear form, B1/B2 or B3/B4 on the card; the loss
        # forces leaky 0 and guards dead sequences (loss._run)
        shifts = _log_band_shifts(graph)
        if shifts is None:
            import warnings
            warnings.warn(
                "pychain_tpu_torch: shared log-domain graph has finite "
                f"log-weights spanning more than {_EXP_SPREAD:.0f} nats "
                "(or +inf/NaN); the factorized-log form would silently "
                "under/overflow in float32, so it is not built for this "
                "graph: the loss runs on the semiring kernels instead",
                RuntimeWarning, stacklevel=4)
        else:
            sa, si, sf = shifts
            shim = types.SimpleNamespace(
                log_domain=False, num_states=graph.num_states,
                forward_transitions=graph.forward_transitions,
                forward_transition_probs=_exp_shifted(
                    graph.forward_transition_probs, sa),
                final_probs=_exp_shifted(graph.final_probs, sf))
            S = graph.num_states
            fa = from_factorized_graph(
                factorize(shim), _exp_shifted(graph.initial_probs, si),
                shim.final_probs,
                np.full(S, 1.0 / S, np.float32),   # unused: leaky is 0
                tile_dtype=self._tile_dtype)
            log_shifts = (None if sa == si == sf == 0.0 else
                          torch.tensor([sa, si + sf], dtype=torch.float32))
            self._fact = dataclasses.replace(
                fa, log_semantics=True, log_shifts=log_shifts).to(
                    self.device)
        from .ops.linear import is_linear_graph, linear_arrays
        if is_linear_graph(graph):
            self._linear = linear_arrays([graph] * self.batch_size,
                                         graph.num_transitions).to(
                                             self.device)

    # -- list constructor (graph.py:350-369) -----------------------------
    def _init_by_list(self, graphs, max_k, max_s):
        self.log_domain = graphs[0].log_domain
        self.shared = False
        self.num_states = max_s
        self.num_transitions = max_k
        for i, g in enumerate(graphs):
            if g.num_transitions > max_k or g.num_states > max_s:
                raise ValueError(
                    f"graph {i} exceeds padding shape: "
                    f"K={g.num_transitions}>{max_k} or "
                    f"S={g.num_states}>{max_s}")
        # the source graphs (references) let a forced impl="semiring"
        # compile arc-id arrays for a batch the linear form claimed, and
        # build the gather engine's arrays on first use
        self._graphs = list(graphs)
        if not self.log_domain:
            # per-sequence leaky-HMM graphs: the dense engine or the
            # gather engine, chosen at dispatch (loss.dispatch_arrays)
            return
        from .ops.linear import is_linear_graph, linear_arrays
        if all(is_linear_graph(g) for g in graphs):
            self._linear = linear_arrays(graphs, max_k).to(self.device)
        else:
            self.semiring()

    def semiring(self):
        """The batch in arc-id form, built on first use (at construction
        for a list batch that is not linear): B rows for a list, one
        broadcast row for a shared log-domain graph, None for a
        prob-domain batch."""
        if self._semiring is None and self.log_domain:
            from .ops.semiring import semiring_arrays
            self._semiring = semiring_arrays(
                [self._graph] if self.shared else self._graphs,
                self.num_transitions, self.num_states).to(self.device)
        return self._semiring

    # -- the reference's batched views (graph.py:73-194) -----------------
    def _view(self, name):
        """The batched view ``name``, built on this batch's device on
        first use: a shared graph's arrays broadcast over the batch, a
        list's padded to (max_num_transitions, max_num_states) as the
        JAX package pads them (log domain: -inf probs; prob domain: 0)."""
        if name not in self._views:
            if self.shared:
                v = getattr(self._graph, name)
                view = None if v is None else torch.as_tensor(
                    np.asarray(v)).to(self.device).expand(
                        self.batch_size, *np.shape(v))
            else:
                view = self._padded(name)
            self._views[name] = view
        return self._views[name]

    def _padded(self, name):
        h = self._padded_host(name)
        return None if h is None else torch.from_numpy(h).to(self.device)

    def _padded_host(self, name):
        """A list batch's view ``name`` as a numpy array, padded as the
        JAX package pads it (log domain: -inf probs; prob domain: 0)."""
        B, K, S = self.batch_size, self.num_transitions, self.num_states
        pad = NEG_INF if self.log_domain else 0.0
        if name.endswith("_transitions"):
            out, n = np.zeros((B, K, 3), np.int32), "num_transitions"
        elif name.endswith("_transition_probs"):
            out, n = np.full((B, K), pad, np.float32), "num_transitions"
        elif name.endswith("_transition_indices"):
            out, n = np.zeros((B, S, 2), np.int32), "num_states"
        elif name == "leaky_probs" and self.log_domain:
            return None
        else:
            fill = 0.0 if name == "leaky_probs" else pad
            out, n = np.full((B, S), fill, np.float32), "num_states"
        for i, g in enumerate(self._graphs):
            out[i, :getattr(g, n)] = getattr(g, name)
        return out

    def graph_arrays(self):
        """The batch as the generic gather engine's
        :class:`~pychain_tpu_torch.ops.fwdbwd.GraphArrays` on this
        batch's device (``pychain_tpu/loss.py::graph_arrays``): a shared
        graph's arrays unbatched, a list's padded; its segment plans are
        built on the host here, once a batch."""
        if self._gather is None:
            from .ops.fwdbwd import GraphArrays
            host = (functools.partial(getattr, self._graph) if self.shared
                    else self._padded_host)
            fwd, bwd = (np.asarray(host(f"{d}_transitions"))
                        for d in ("forward", "backward"))
            t = torch.from_numpy
            leaky = host("leaky_probs")
            ga = GraphArrays(
                fwd_src=t(fwd[..., 0].copy()), fwd_dst=t(fwd[..., 1].copy()),
                fwd_pdf=t(fwd[..., 2].copy()),
                fwd_prob=t(np.asarray(host("forward_transition_probs"),
                                      np.float32)),
                bwd_src=t(bwd[..., 0].copy()), bwd_dst=t(bwd[..., 1].copy()),
                bwd_pdf=t(bwd[..., 2].copy()),
                bwd_prob=t(np.asarray(host("backward_transition_probs"),
                                      np.float32)),
                initial=t(np.asarray(host("initial_probs"), np.float32)),
                final=t(np.asarray(host("final_probs"), np.float32)),
                leaky=None if leaky is None else t(
                    np.asarray(leaky, np.float32)),
                shared=self.shared)
            ga.plan("bwd_dst")
            ga.plan("fwd_src")
            ga.plan("fwd_pdf", ga.n_pdfs())
            self._gather = ga.to(self.device)
        return self._gather

    @property
    def forward_transitions(self):
        """(B, K, 3) int32: src, dst, pdf of each arc, by source."""
        return self._view("forward_transitions")

    @property
    def backward_transitions(self):
        """(B, K, 3) int32: the arcs by destination."""
        return self._view("backward_transitions")

    @property
    def forward_transition_probs(self):
        """(B, K) float32 (log probs in the log domain)."""
        return self._view("forward_transition_probs")

    @property
    def backward_transition_probs(self):
        return self._view("backward_transition_probs")

    @property
    def forward_transition_indices(self):
        """(B, S, 2) int32: each state's [begin, end) in the forward arcs."""
        return self._view("forward_transition_indices")

    @property
    def backward_transition_indices(self):
        return self._view("backward_transition_indices")

    @property
    def initial_probs(self):
        """(B, S) float32."""
        return self._view("initial_probs")

    @property
    def final_probs(self):
        return self._view("final_probs")

    @property
    def leaky_probs(self):
        """(B, S) float32, or None in the log domain."""
        return self._view("leaky_probs")

    @property
    def start_state(self):
        """(B,) int32."""
        if "start_state" not in self._views:
            gs = [self._graph] * self.batch_size if self.shared \
                else self._graphs
            self._views["start_state"] = torch.tensor(
                [g.start_state for g in gs], dtype=torch.int32,
                device=self.device)
        return self._views["start_state"]

    def reorder(self, new_order):
        """Permute the batch (reference graph.py:177-194).  Every
        per-sequence form moves with the graphs: the linear arrays, the
        arc-id arrays with their per-graph lists and the source graphs,
        so no graph is paired with another sequence afterwards; the
        batched views and the gather engine's arrays are rebuilt on their
        next use; the dense arrays (``impl="dense_list"``) move with their
        rows.  A broadcast batch is left as it is."""
        if self.shared:
            return
        order = [int(i) for i in np.asarray(new_order)]
        if sorted(order) != list(range(self.batch_size)):
            raise ValueError(f"new_order {order} is not a permutation of "
                             f"range({self.batch_size})")
        if self._linear is not None:
            idx = torch.tensor(order, device=self.device)
            self._linear = dataclasses.replace(self._linear, **{
                f.name: getattr(self._linear, f.name).index_select(0, idx)
                for f in dataclasses.fields(self._linear)})
        for name in ("_semiring", "_dense_list"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, v.take(order))
        self._graphs = [self._graphs[i] for i in order]
        self._views = {}
        self._gather = None
