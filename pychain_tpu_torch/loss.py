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

Dispatch: a factorized denominator goes to a tier of CUDA kernels
(:func:`den_engine`, ``pychain_tpu/loss.py::_pallas_tier`` with the
card's limits): the resident pair of ``ops/fact_kernels.py`` (B1/B2,
``engine="pallas"``) when the graph's state vectors fit one block's
shared memory, else the cluster pair of ``ops/stream_kernels.py``
(B3/B4, ``engine="stream"``); past the cluster limit the CUDA path
raises (where the JAX package takes its XLA engine, the port has no
kernel).  On CPU tensors every tier computes the plain version.  A batch
of linear numerators goes to the closed form of ``ops/linear.py``; any
other log-domain list batch (cyclic, self-loop, flat-start) to the
semiring kernels of ``ops/semiring_kernels.py``, which serve what the
JAX package splits over ``impl="semiring_pallas"`` and ``"semiring_xl"``
(both taken here as ``"auto"``).  ``impl="pallas"``, the JAX package's
name for its denominator tiering, is ``"auto"`` too (float32 tiles).
``impl="factorized"`` (denominator) and ``impl="semiring"`` (numerator
lists) ask for the plain PyTorch engine on any device, as the JAX
package's ``impl="semiring"`` forces its XLA scan.  A FactorizedArrays
given with ``engine="pallas"`` or ``"stream"`` keeps that engine
(as ``tools/stream_ab.py`` forces the stream engine in JAX); the default
``"xla"`` takes the tier of :func:`den_engine`, chosen at each call.
"""

from __future__ import annotations

import numpy as np
import torch

from .graph import ChainGraph, ChainGraphBatch
from .ops import fact_kernels, stream_kernels
from .ops.factorized import FactorizedArrays, forward_backward_prob_fact
from .ops.fwdbwd import FwdBwdResult
from .ops.linear import LinearArrays, forward_backward_linear
from .ops.semiring import SemiringArrays, forward_backward_semiring
from .ops.semiring_kernels import forward_backward_semiring_kernel
from .utils.device import resolve_device

CLAMP = 30.0  # reference loss.py:30

IMPLS = ("auto", "factorized", "linear", "semiring")
# the JAX package's names for its semiring kernels (one kernel pair
# serves both of its classes here) and for its denominator tiering:
# "auto" already selects them
_ALIASES = {"semiring_pallas": "auto", "semiring_xl": "auto",
            "pallas": "auto"}
# engines of the JAX package that the port does not have yet
_NOT_PORTED = ("gather", "leveled", "dense_list")


def den_engine(fa: FactorizedArrays) -> str:
    """The denominator tier for ``fa``: "pallas" (B1/B2) when its state
    vectors fit one block's shared memory, else "stream" (B3/B4) when
    they fit a cluster's, else, on the CPU, "xla" (the plain version,
    what the CPU runs anyway); on CUDA past the cluster limit it raises
    NotImplementedError.  A graph with residual arcs stays "pallas",
    whose wrapper refuses it."""
    if not fact_kernels.supports(fa) or fact_kernels.fits_on_chip(fa):
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
            "serves it (impl='factorized' runs the plain version)")
    return "xla"


def dispatch_arrays(graphs, impl: str = "auto"):
    """The engine-facing arrays of a graph batch.

    impl: "auto" (linear closed form for linear numerator batches, the
    semiring kernels for other log-domain lists, a shared prob-domain
    graph's FactorizedArrays, whose kernel tier :func:`_run` takes from
    its ``engine`` or :func:`den_engine`),
    "factorized" (the plain PyTorch engine for the denominator),
    "linear", or "semiring" (the plain PyTorch engine for a log-domain
    list, built for a linear batch too).  "semiring_pallas",
    "semiring_xl" and "pallas" are accepted as "auto"."""
    impl = _ALIASES.get(impl, impl)
    if impl not in IMPLS:
        if impl in _NOT_PORTED:
            raise NotImplementedError(
                f"impl={impl!r} is not ported yet (ROADMAP.md, deferred "
                "modules); the port has " + ", ".join(IMPLS))
        raise ValueError(f"unknown impl {impl!r}")
    if isinstance(graphs, (FactorizedArrays, LinearArrays, SemiringArrays)):
        return graphs
    if graphs.shared and graphs.log_domain:
        raise NotImplementedError(
            "the loss on a shared log-domain graph needs the factorized "
            "log_semantics engine, not ported yet (ROADMAP.md A.5); such "
            "a batch serves viterbi_align and PhoneDecoder only")
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
    raise ValueError(f"impl={impl!r} requires a shared prob-domain "
                     "ChainGraphBatch (broadcast denominator)")


def _lengths(x_lengths) -> torch.Tensor:
    """x_lengths (list, array or tensor) as an int64 tensor, left on the
    device it came from."""
    if isinstance(x_lengths, torch.Tensor):
        return x_lengths.long()
    return torch.as_tensor(np.asarray(x_lengths), dtype=torch.int64)


def _run(x, lengths, g, leaky_coefficient, impl="auto",
         debug=True) -> FwdBwdResult:
    """debug=False lets the kernels compute the invariant traces at
    frame 0 only (the objective path discards them)."""
    with torch.no_grad():
        x = torch.clamp(x, -CLAMP, CLAMP)
        if isinstance(g, LinearArrays):
            return forward_backward_linear(x, lengths, g)
        if isinstance(g, SemiringArrays):
            if impl == "semiring":
                return forward_backward_semiring(x, lengths, g)
            return forward_backward_semiring_kernel(x, lengths, g)
        if isinstance(g, FactorizedArrays):
            px = torch.exp(x)
            if impl == "factorized":
                engine = "xla"
            else:      # an engine the caller set is kept
                engine = den_engine(g) if g.engine == "xla" else g.engine
            if engine == "xla":
                return forward_backward_prob_fact(px, lengths, g,
                                                  leaky_coefficient)
            if engine == "stream":
                return stream_kernels.forward_backward_prob_stream(
                    px, lengths, g, leaky_coefficient, debug=debug)
            return fact_kernels.forward_backward_prob_kernel(
                px, lengths, g, leaky_coefficient, debug=debug)
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
        # precision="fast" selects bfloat16 transition operands (float32
        # accumulation); "parity" (the default) keeps float32.
        # tile_dtype is the expert form of the same switch.
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
        if (tile_dtype is not None and "bfloat16" in str(tile_dtype)
                and self.device.type == "cuda" and impl != "factorized"):
            raise NotImplementedError(
                "bfloat16 tiles (precision='fast') have no CUDA kernel "
                "yet (ROADMAP.md, deferred modules)")
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
