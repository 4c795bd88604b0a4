"""Chain (LF-MMI) loss: the differentiable public API.

The port's counterpart of ``pychain_tpu/loss.py`` (and of the
reference's ``pychain/loss.py``):

* :class:`ChainFunction` — a ``torch.autograd.Function`` (reference
  loss.py:27-87): clamps the nnet output to [-30, 30], runs the fused
  forward-backward once in the forward pass and keeps the occupation
  posterior gamma; the backward pass is ``gamma * ct``.
* :func:`chain_function_with_aux` — the same, also returning the
  per-sequence objf, ``ok`` flags and invariant traces.
* :class:`ChainLoss` / :func:`chain_loss` — the shared denominator graph
  with per-utterance numerator graphs:
  ``objf = -(num - den) [/ sum(lengths)]`` (loss.py:90-105).
* :func:`chain_loss_xent` — the same with Kaldi's cross-entropy
  regularizer on the numerator posteriors and an optional output-l2.

Dispatch: a factorized denominator goes to a tier of CUDA kernels
(:func:`den_engine`, ``pychain_tpu/loss.py::_pallas_tier`` with the
card's limits): the resident pair of ``ops/fact_kernels.py`` (B1/B2,
``engine="pallas"``) when the graph's state vectors fit one block's
shared memory, else the cluster pair of ``ops/stream_kernels.py``
(B3/B4, ``engine="stream"``); past the cluster limit the CUDA path
raises (where the JAX package takes its XLA engine, the port has no
kernel; ``impl="gather"`` runs such a graph).  On CPU tensors every
tier computes the plain version.  A shared log-domain graph takes the
same tiers in normalized-linear form (``log_semantics``: leaky 0, the
``log_shifts`` correction, dead sequences guarded), or its closed form
when it is linear, or the semiring kernels when its weights spread too
wide for float32's exp (no factorized form).  A batch of linear
numerators goes to the closed form of ``ops/linear.py``; any other
log-domain list batch (cyclic, self-loop, flat-start) to the semiring
kernels of ``ops/semiring_kernels.py``, which serve what the JAX
package splits over ``impl="semiring_pallas"`` and ``"semiring_xl"``
(both taken here as ``"auto"``), as is ``"leveled"``, its banded
engine for time-synchronous graphs, which these kernels run faster
(PERF.md).  A list of prob-domain graphs has no
kernel: on the card it runs on the dense engine of
``ops/dense_list.py`` (batched products) within its memory budget, as
the JAX package's TPU dispatch does, and otherwise (on the CPU, or past
the budget) on the generic gather engine (``ops/fwdbwd.py``), with a
one-time warning.  ``impl="pallas"``, the JAX package's name for its
denominator tiering, is ``"auto"`` too.
A denominator with bfloat16 tiles (``precision="fast"``) runs the fast
mode of the same tiers (B1/B2's and B3/B4's bfloat16 forms), or on the
CPU its plain version, ``forward_backward_prob_fast``.
``impl="factorized"`` (denominator) and ``impl="semiring"`` (numerator
lists) ask for the plain PyTorch engine on any device, as the JAX
package's ``impl="semiring"`` forces its XLA scan; ``impl="gather"``
asks for the generic gather engine on any batch.  A FactorizedArrays
given with ``engine="pallas"`` or ``"stream"`` keeps that engine
(as ``tools/stream_ab.py`` forces the stream engine in JAX); the default
``"xla"`` takes the tier of :func:`den_engine`, chosen at each call.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph import ChainGraph, ChainGraphBatch
from .ops import fact_kernels, stream_kernels
from .ops.dense_list import (DenseListArrays, dense_list_arrays,
                             fits_dense_list, forward_backward_prob_dense)
from .ops.factorized import FactorizedArrays, forward_backward_prob_fact
from .ops.fwdbwd import (FwdBwdResult, GraphArrays, forward_backward_log,
                         forward_backward_prob)
from .ops.linear import LinearArrays, forward_backward_linear
from .ops.semiring import SemiringArrays, forward_backward_semiring
from .ops.semiring_kernels import forward_backward_semiring_kernel
from .utils.device import host_to, resolve_device

CLAMP = 30.0  # reference loss.py:30

IMPLS = ("auto", "dense_list", "factorized", "gather", "linear",
         "semiring")
# the JAX package's names for its semiring kernels (one kernel pair
# serves both of its classes here), for its banded engine of
# time-synchronous lists (those kernels take such lists too) and for
# its denominator tiering: "auto" already selects them
_ALIASES = {"semiring_pallas": "auto", "semiring_xl": "auto",
            "leveled": "auto", "pallas": "auto"}


def den_engine(fa: FactorizedArrays) -> str:
    """The denominator tier for ``fa``: "pallas" (B1/B2) when its state
    vectors fit one block's shared memory, else "stream" (B3/B4) when
    they fit a cluster's, else, on the CPU, "xla" (the plain version,
    what the CPU runs anyway); on CUDA past the cluster limit it raises
    NotImplementedError.  A graph with residual arcs (arcs that neither
    W1 nor W2 takes: a phone-LM denominator over ``ChainTopology``, as
    ``graphs/builder.py`` composes it) is "xla" on every device: no
    kernel takes such arcs, and the JAX package runs its XLA factorized
    engine on such a graph on every backend (its loss.py dispatch
    upgrades only ``pallas_fact.supports`` graphs to a kernel tier); the
    port runs that engine's counterpart, the plain version, where ``fa``
    lives."""
    if not fact_kernels.supports(fa):
        return "xla"
    if fact_kernels.fits_on_chip(fa):
        return "pallas"
    if stream_kernels.fits_stream(fa):
        return "stream"
    if fa.device.type == "cuda":
        c = max(stream_kernels.CLUSTERS)
        raise NotImplementedError(
            f"denominator graph with S_pad={fa.s_pad} needs "
            f"{stream_kernels.smem_bytes(fa, c)} bytes of shared memory per "
            f"CTA even on a cluster of {c} CTAs, over the "
            f"{fact_kernels.MAX_SMEM} a Hopper block has: no CUDA kernel "
            "serves it (impl='factorized' runs the plain version, "
            "impl='gather' the generic gather engine)")
    return "xla"


def resolved_engine(fa: FactorizedArrays) -> str:
    """The tier a denominator runs on under impl "auto": an engine the
    caller set is kept, else :func:`den_engine`'s."""
    return den_engine(fa) if fa.engine == "xla" else fa.engine


def graph_arrays(batch: ChainGraphBatch) -> GraphArrays:
    """The batch as the generic gather engine's GraphArrays
    (``pychain_tpu/loss.py::graph_arrays``), built once a batch."""
    return batch.graph_arrays()


_gather_fallback_warned = False


def _warn_gather_fallback(graphs):
    """One-time warning when a list of prob-domain (leaky-HMM) graphs
    drops onto the generic gather engine (pychain_tpu/loss.py:151-195):
    on the CPU, or on the card past the dense engine's budget.  No
    kernel of the port takes per-sequence prob-domain graphs, and the
    gather engine is one Python loop of small operations a frame."""
    global _gather_fallback_warned
    if _gather_fallback_warned:
        return
    _gather_fallback_warned = True
    import warnings
    warnings.warn(
        "pychain_tpu_torch: LIST-built prob-domain (leaky-HMM) graph "
        f"batch (B={graphs.batch_size}, K={graphs.num_transitions}, "
        f"S={graphs.num_states}) runs off the card or past the dense "
        "engine's budget (fits_dense_list, PYCHAIN_DENSE_LIST_BUDGET) — "
        "only a shared broadcast denominator factorizes onto B1/B2 and "
        "B3/B4; dispatching to the generic gather engine. If every "
        "sequence shares one denominator graph, build it with "
        "ChainGraphBatch(graph, batch_size); otherwise per-sequence "
        "prob-domain graphs run at gather speed.",
        RuntimeWarning, stacklevel=4)


def _dense_list(graphs):
    """The batch's dense arrays, built once (None where the batch is not
    a prob-domain list or its blocks are past the budget), as the JAX
    package's ``_force_engine(graphs, "dense_list")``."""
    if graphs._dense_list is None and graphs._graphs and \
            not graphs.log_domain and fits_dense_list(graphs.batch_size,
                                                      graphs.num_states):
        graphs._dense_list = dense_list_arrays(
            graphs._graphs, tile_dtype=graphs._tile_dtype or "float32",
            device=graphs.device)
    return graphs._dense_list


def _shared_log(graphs, impl):
    """The engine arrays of a shared log-domain batch: its closed form
    where it is linear, else its factorized-log form (the kernel tier of
    :func:`den_engine` under "auto"), else, when its weights spread too
    wide for that form, the semiring arrays broadcast to B rows."""
    if graphs._linear is not None and impl in ("auto", "linear"):
        return graphs._linear
    if impl == "linear":
        raise ValueError("linear impl requires a batch of linear-chain "
                         "log-domain graphs")
    if graphs._fact is not None and impl in ("auto", "factorized"):
        return graphs._fact
    if impl == "factorized":
        raise ValueError("factorized impl: this shared log-domain graph's "
                         "weights spread too wide for its factorized form")
    # "semiring" (the plain version) or auto past the factorized form
    if graphs._semiring_rows is None:
        graphs._semiring_rows = graphs.semiring().take(
            [0] * graphs.batch_size)
    return graphs._semiring_rows


def dispatch_arrays(graphs, impl: str = "auto"):
    """The engine-facing arrays of a graph batch.

    impl: "auto" (linear closed form for linear numerator batches, the
    semiring kernels for other log-domain lists, a shared graph's
    FactorizedArrays, whose kernel tier :func:`_run` takes from its
    ``engine`` or :func:`den_engine`, and for a list of prob-domain
    graphs the dense engine on the card within its budget, else the
    gather engine), "dense_list" (the dense engine, any device; a
    ValueError past its budget), "factorized" (the plain PyTorch engine
    for the denominator), "gather" (the generic gather engine, any
    batch), "linear", or "semiring" (the plain PyTorch engine for a
    log-domain list, built for a linear batch too).  "semiring_pallas",
    "semiring_xl", "leveled" and "pallas" are accepted as "auto"."""
    impl = _ALIASES.get(impl, impl)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    if isinstance(graphs, (FactorizedArrays, LinearArrays, SemiringArrays,
                           GraphArrays, DenseListArrays)):
        return graphs
    if impl == "gather":
        return graph_arrays(graphs)
    if impl == "dense_list":
        dl = (None if graphs.shared or graphs.log_domain
              else _dense_list(graphs))
        if dl is None:
            raise ValueError("dense_list impl requires a prob-domain list "
                             "batch whose dense blocks fit the budget "
                             "(fits_dense_list)")
        return dl
    if graphs.shared and graphs.log_domain:
        return _shared_log(graphs, impl)
    if graphs._linear is not None and impl in ("auto", "linear"):
        return graphs._linear
    if impl == "linear":
        raise ValueError("linear impl requires a batch of linear-chain "
                         "log-domain graphs")
    if impl == "semiring" or (impl == "auto"
                              and graphs._semiring is not None):
        sr = graphs.semiring()
        if sr is None:
            raise ValueError(f"impl={impl!r} requires a list batch of "
                             "log-domain graphs")
        return sr
    if graphs._fact is not None:
        return graphs._fact
    if impl == "auto" and not graphs.shared and not graphs.log_domain:
        # per-sequence leaky-HMM graphs: the dense engine on the card
        # within its budget (the JAX package's TPU rule), kept once
        # built; else the gather engine, with a one-time warning
        if graphs._dense_list is not None or graphs.device.type == "cuda":
            dl = _dense_list(graphs)
            if dl is not None:
                return dl
        _warn_gather_fallback(graphs)
        return graph_arrays(graphs)
    raise ValueError(f"impl={impl!r} requires a shared prob-domain "
                     "ChainGraphBatch (broadcast denominator)")


def _lengths(x_lengths) -> torch.Tensor:
    """x_lengths (list, array or tensor) as an int64 tensor, left on the
    device it came from."""
    if isinstance(x_lengths, torch.Tensor):
        return x_lengths.long()
    return torch.as_tensor(np.asarray(x_lengths), dtype=torch.int64)


def _guard_infeasible(res: FwdBwdResult) -> FwdBwdResult:
    """The log engines' contract for dead sequences
    (pychain_tpu/loss.py:362-382): a sequence whose path set is empty (or
    dies mid-utterance) comes back as objf -inf, gamma 0 and ok False,
    not the NaN or inf that the prob-domain division by tot_prob gives."""
    feasible = torch.isfinite(res.objf)
    objf = torch.where(feasible, res.objf, float("-inf"))
    gamma = torch.where(torch.isfinite(res.gamma), res.gamma, 0.0)
    gamma = torch.where(feasible[:, None, None], gamma, 0.0)
    return FwdBwdResult(objf, gamma, res.ok & feasible, res.alpha_beta,
                        res.gamma_sum)


def _run_fact(x, lengths, g: FactorizedArrays, leaky_coefficient, impl,
              debug) -> FwdBwdResult:
    px = torch.exp(x)
    if g.log_semantics:
        # no leaky HMM in the log domain (graph.py:54-59)
        leaky_coefficient = 0.0
    engine = "xla" if impl == "factorized" else resolved_engine(g)
    if engine == "xla":
        res = forward_backward_prob_fact(px, lengths, g, leaky_coefficient)
    elif engine == "stream":
        res = stream_kernels.forward_backward_prob_stream(
            px, lengths, g, leaky_coefficient, debug=debug)
    else:
        res = fact_kernels.forward_backward_prob_kernel(
            px, lengths, g, leaky_coefficient, debug=debug)
    if not g.log_semantics:
        return res
    if g.log_shifts is not None:
        # undo the exp-safe band's re-centering: every length-L path was
        # rescaled by exp(-(arc L + const)) (graph._log_band_shifts)
        shifts = g.log_shifts.to(res.objf.device)
        lens = host_to(torch.as_tensor(lengths), res.objf.device).float()
        res = res._replace(objf=res.objf + shifts[0] * lens + shifts[1])
    return _guard_infeasible(res)


def _run(x, lengths, g, leaky_coefficient, impl="auto",
         debug=True) -> FwdBwdResult:
    """debug=False lets the kernels compute the invariant traces at
    frame 0 only (the objective path discards them)."""
    with torch.no_grad():
        x = torch.clamp(x, -CLAMP, CLAMP)
        if isinstance(g, LinearArrays):
            return forward_backward_linear(x, lengths, g)
        if isinstance(g, DenseListArrays):
            return forward_backward_prob_dense(torch.exp(x), lengths, g,
                                               leaky_coefficient)
        if isinstance(g, SemiringArrays):
            if impl == "semiring":
                return forward_backward_semiring(x, lengths, g)
            return forward_backward_semiring_kernel(x, lengths, g)
        if isinstance(g, FactorizedArrays):
            return _run_fact(x, lengths, g, leaky_coefficient, impl, debug)
        if isinstance(g, GraphArrays):
            if g.leaky is not None:
                return forward_backward_prob(torch.exp(x), lengths, g,
                                             leaky_coefficient)
            return forward_backward_log(x, lengths, g)
    raise TypeError(f"no engine for {type(g).__name__}")


class ChainFunction(torch.autograd.Function):
    """``pychain.ChainFunction`` (reference loss.py:27-87).

    ``ChainFunction.apply(x, x_lengths, graphs, leaky_coefficient)``
    returns the chain log-likelihood summed over the batch; the
    gradient with respect to x is the occupation posterior scaled by
    the output cotangent.  With ``aux=True`` it returns
    ``(objf_sum, objf, ok, alpha_beta, gamma_sum, gamma)``, of which
    only ``objf_sum`` carries a gradient."""

    @staticmethod
    def forward(ctx, x, x_lengths, graphs, leaky_coefficient=1e-5,
                impl="auto", aux=False):
        g = dispatch_arrays(graphs, impl)
        # the engines move the lengths to x's device themselves
        res = _run(x, _lengths(x_lengths), g, leaky_coefficient, impl,
                   debug=aux)
        ctx.gamma = res.gamma
        objf = res.objf.sum()
        if not aux:
            return objf
        ctx.mark_non_differentiable(res.objf, res.ok, res.alpha_beta,
                                    res.gamma_sum, res.gamma)
        return (objf, res.objf, res.ok, res.alpha_beta, res.gamma_sum,
                res.gamma)

    @staticmethod
    def backward(ctx, ct, *unused):
        grad = ctx.gamma.to(ct.dtype) * ct
        ctx.gamma = None
        return grad, None, None, None, None, None


def _check_shapes(x, graphs, x_lengths=None):
    """Host-side sanity checks at the public boundary (loss.py:520):
    batch-size mismatch (reference loss.py:32-36), pdf ids beyond the
    nnet output, and lengths beyond the padded frame axis."""
    if x_lengths is not None:
        lens = _lengths(x_lengths)
        if lens.numel() and int(lens.max()) > x.shape[1]:
            raise ValueError(
                f"x_lengths (max {int(lens.max())}) exceed the padded "
                f"frame axis T={x.shape[1]} — the objective would be "
                "silently wrong")
    if not isinstance(graphs, ChainGraphBatch):
        return
    if x.shape[0] != graphs.batch_size:
        raise ValueError(
            "input batch size ({}) does not equal to graph batch size ({})"
            .format(x.shape[0], graphs.batch_size))
    if graphs.num_pdfs > x.shape[2]:
        raise ValueError(
            "graphs reference pdf ids up to {} but the nnet output has "
            "only {} columns".format(graphs.num_pdfs - 1, x.shape[2]))
    if x.device.type != graphs.device.type:
        raise ValueError(f"x is on {x.device} but the graphs are on "
                         f"{graphs.device}")


def chain_function(x, x_lengths, graphs, leaky_coefficient=1e-5,
                   impl: str = "auto"):
    """Total chain log-likelihood, summed over the batch; differentiable
    in x.  x (B, T, P) nnet log-likelihoods, x_lengths (B,), graphs a
    :class:`ChainGraphBatch`.  The batch need not be length-sorted."""
    _check_shapes(x, graphs, x_lengths)
    return ChainFunction.apply(x, x_lengths, graphs, leaky_coefficient,
                               impl, False)


def chain_function_with_aux(x, x_lengths, graphs, leaky_coefficient=1e-5,
                            impl: str = "auto"):
    """Like :func:`chain_function` but also returns diagnostics:
    (objf, aux) with aux a FwdBwdResult: per-sequence objf, ok flags,
    the per-frame invariant traces and gamma (no gradient)."""
    _check_shapes(x, graphs, x_lengths)
    objf, per_seq, ok, ab, gs, gamma = ChainFunction.apply(
        x, x_lengths, graphs, leaky_coefficient, impl, True)
    return objf, FwdBwdResult(per_seq, gamma, ok, ab, gs)


def chain_loss(x, x_lengths, num_graphs, den_graph_batch,
               leaky_coefficient=1e-5, avg=True, impl: str = "auto"):
    """Functional ChainLoss (reference loss.py:97-105):
    ``objf = -(num_objf - den_objf) [/ sum(x_lengths)]``."""
    den_objf = chain_function(x, x_lengths, den_graph_batch,
                              leaky_coefficient, impl)
    num_objf = chain_function(x, x_lengths, num_graphs)
    objf = -(num_objf - den_objf)
    if avg:
        objf = objf / int(_lengths(x_lengths).sum())
    return objf


def chain_loss_xent(x, xent_out, x_lengths, num_graphs, den_graph_batch,
                    leaky_coefficient=1e-5, xent_regularize=0.1,
                    l2_regularize=0.0, avg=True, impl: str = "auto"):
    """LF-MMI with cross-entropy regularization (``pychain_tpu/loss.py``
    ``chain_loss_xent``; Kaldi's chain recipe's companion objective).

    ``x`` feeds the MMI term; ``xent_out`` (same shape) is the xent
    head's log-likelihoods, and may be ``x`` itself.  The numerator
    forward-backward runs ONCE: its objf enters the MMI term and its
    occupation posteriors, detached as soft targets, weight
    ``log_softmax(xent_out)``.  ``l2_regularize`` penalises the chain
    output's magnitude on real frames (Kaldi's output-l2).

    Returns ``(loss, (mmi, xent))`` with
    ``loss = mmi + xent_regularize * xent + l2_regularize * l2``; with
    ``avg`` each term is divided by the total frames.  ``impl`` selects
    the denominator's engine as in :func:`chain_function`."""
    lengths = _lengths(x_lengths)
    den_objf = chain_function(x, lengths, den_graph_batch,
                              leaky_coefficient, impl)
    num_objf, aux = chain_function_with_aux(x, lengths, num_graphs)
    mmi = -(num_objf - den_objf)
    # soft targets: numerator posteriors, zero on padded frames
    gamma = aux.gamma.detach().to(xent_out.dtype)
    xent = -torch.sum(gamma * torch.log_softmax(xent_out, dim=-1))
    if l2_regularize > 0.0:
        frames = torch.arange(x.shape[1], device=x.device)
        mask = frames[None, :] < host_to(lengths, x.device)[:, None]
        l2 = 0.5 * torch.sum(torch.square(x) * mask[:, :, None])
    else:
        l2 = x.new_zeros(())   # skip the (B, T, P) reduction
    if avg:
        denom = int(lengths.sum())
        mmi, xent, l2 = mmi / denom, xent / denom, l2 / denom
    return mmi + xent_regularize * xent + l2_regularize * l2, (mmi, xent)


class ChainLoss(torch.nn.Module):
    """``pychain.ChainLoss`` (reference loss.py:90-105).

    Holds the single denominator graph; the per-utterance numerator
    graphs are passed at call time:
    ``loss = ChainLoss(den_graph)(x, x_lengths, num_graphs)``.
    ``device=None`` means ``"cuda"`` (raising with no card); the
    denominator batch is built on that device once per batch size.
    """

    def __init__(self, den_graph: ChainGraph, leaky_coefficient=1e-5,
                 avg=True, impl: str = "auto", tile_dtype=None,
                 precision: str = None, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.den_graph = den_graph
        self.leaky_coefficient = leaky_coefficient
        self.avg = avg
        self.impl = impl
        # precision="fast" selects bfloat16 transition operands and
        # streams (float32 accumulation: the Pallas kernels' fast mode,
        # on the card the bfloat16 forms of the resident and the cluster
        # kernels); "parity" (the default) keeps float32.  tile_dtype is
        # the expert form of the same switch.
        if precision not in (None, "parity", "fast"):
            raise ValueError(
                f"precision must be 'parity' or 'fast', got {precision!r}")
        if precision == "fast":
            if tile_dtype is not None and str(tile_dtype) not in (
                    "bfloat16", "torch.bfloat16"):
                raise ValueError(
                    "precision='fast' means bfloat16 tiles; it "
                    f"contradicts tile_dtype={tile_dtype!r}")
            tile_dtype = "bfloat16"
        elif precision == "parity" and tile_dtype is not None and str(
                tile_dtype) not in ("float32", "torch.float32"):
            raise ValueError("precision='parity' means float32 tiles; it "
                             f"contradicts tile_dtype={tile_dtype!r}")
        self.tile_dtype = tile_dtype
        self._den_batches = {}  # batch_size -> ChainGraphBatch cache

    def den_batch(self, batch_size: int) -> ChainGraphBatch:
        if batch_size not in self._den_batches:
            self._den_batches[batch_size] = ChainGraphBatch(
                self.den_graph, batch_size, tile_dtype=self.tile_dtype,
                device=self.device)
        return self._den_batches[batch_size]

    def forward(self, x, x_lengths, num_graphs):
        if x.device.type != self.device.type:
            raise ValueError(f"x is on {x.device} but the loss runs on "
                             f"{self.device}")
        _check_shapes(x, num_graphs)
        den = self.den_batch(x.shape[0])
        _check_shapes(x, den)
        return chain_loss(x, x_lengths, num_graphs, den,
                          self.leaky_coefficient, self.avg, self.impl)
