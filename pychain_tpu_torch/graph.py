"""Chain graphs: graph objects and batched tensors.

The port's counterpart of ``pychain_tpu/graph.py`` (and of the
reference's ``pychain/graph.py``):

* :class:`ChainGraph` — one FST lowered to transition arrays (numpy),
  with ``initial_mode``/``final_mode``/``log_domain`` semantics matching
  graph.py:25-70 of the reference,
* :class:`ChainGraphBatch` — a batch of graphs as tensors on a device.

Ported batch forms: a shared prob-domain graph broadcast over the batch
(the denominator: factorized, ``ops/factorized.py``) and a list of
log-domain graphs (the numerators): linear chains in closed form
(``ops/linear.py``), any other graph (cyclic, self-loop, flat-start) in
arc-id form for the semiring kernels (``ops/semiring.py``).  A shared
log-domain graph and a list of prob-domain graphs need engines that are
not ported yet and raise ``NotImplementedError`` naming their ROADMAP.md
item.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graphs.compiler import CompiledGraph, compile_fst, \
    leaky_probs as _leaky_probs
from .graphs.fst import FST, n_arcs, n_states
from .utils.device import resolve_device

NEG_INF = float("-inf")


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
        self._graphs = None
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

    # -- broadcast constructor (graph.py:203-222) ------------------------
    def _init_by_one(self, graph: ChainGraph):
        self.log_domain = graph.log_domain
        self.shared = True
        self.num_states = graph.num_states
        self.num_transitions = graph.num_transitions
        if graph.log_domain:
            raise NotImplementedError(
                "a shared log-domain graph needs the factorized "
                "log_semantics engine, not ported yet (ROADMAP.md, "
                "deferred modules)")
        from .graphs.factorize import factorize
        from .ops.factorized import from_factorized_graph
        fg = factorize(graph)
        self._fact = from_factorized_graph(
            fg, graph.initial_probs, graph.final_probs, graph.leaky_probs,
            tile_dtype=self._tile_dtype).to(self.device)

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
        if not self.log_domain:
            raise NotImplementedError(
                "a list batch of prob-domain graphs needs the dense_list or "
                "gather engine, not ported yet (ROADMAP.md, deferred "
                "modules); the port runs log-domain numerator lists and a "
                "shared prob-domain denominator")
        # the source graphs (references) let a forced impl="semiring"
        # compile arc-id arrays for a batch the linear form claimed
        self._graphs = list(graphs)
        from .ops.linear import is_linear_graph, linear_arrays
        if all(is_linear_graph(g) for g in graphs):
            self._linear = linear_arrays(graphs, max_k).to(self.device)
        else:
            self.semiring()

    def semiring(self):
        """The batch in arc-id form for the semiring kernels, built on
        first use (at construction for a batch that is not linear), or
        None for a batch that is not a log-domain list."""
        if self._semiring is None and self._graphs is not None:
            from .ops.semiring import semiring_arrays
            self._semiring = semiring_arrays(
                self._graphs, self.num_transitions,
                self.num_states).to(self.device)
        return self._semiring

    def reorder(self, new_order):
        """Permute the batch (reference graph.py:177-194).  Every
        per-sequence form moves with the graphs: the linear arrays, the
        arc-id arrays with their per-graph lists, and the source graphs,
        so no graph is paired with another sequence afterwards.  A
        broadcast batch is left as it is."""
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
        if self._semiring is not None:
            self._semiring = self._semiring.take(order)
        self._graphs = [self._graphs[i] for i in order]
