"""Carry graph state from the JAX package into the port.

The functions read attributes and go through ``np.asarray``, so they take
the JAX package's ``FactorizedArrays`` / ``LinearArrays`` /
``SemiringXLArrays`` / ``GraphArrays`` (or anything with the same
fields) without importing JAX, and return the port's tensors on
``device`` (default: the CPU, since the result usually feeds a
ChainGraphBatch-free call in a test or a script that moves it).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.factorized import FactorizedArrays, WArrays
from .ops.linear import LinearArrays
from .ops.semiring import SemiringArrays, semiring_from_ids


def _t(v, dtype=None):
    return torch.as_tensor(np.array(np.asarray(v), dtype=dtype))


def _warrays(w) -> WArrays:
    dense_dtype = (torch.bfloat16 if w.dense is not None and
                   "bfloat16" in str(np.asarray(w.dense).dtype) else None)

    def operand(v):
        # bfloat16 arrays travel as float32 (numpy has no bfloat16)
        t = _t(np.asarray(v).astype(np.float32))
        return t.to(dense_dtype) if dense_dtype is not None else t

    return WArrays(
        diag=None if w.diag is None else _t(w.diag, np.float32),
        dense=None if w.dense is None else operand(w.dense),
        tiles=operand(w.tiles),
        rows=_t(np.asarray(w.rows, np.int64).reshape(-1)),
        cols=_t(np.asarray(w.cols, np.int64).reshape(-1)),
        dense_r0=int(w.dense_r0), dense_c0=int(w.dense_c0),
        out_rows=int(w.out_rows))


def factorized_from_numpy(fa, device="cpu") -> FactorizedArrays:
    """The port's FactorizedArrays from the JAX package's fields."""
    if getattr(fa, "log_semantics", False):
        raise NotImplementedError(
            "log_semantics factorized graphs are not ported yet "
            "(ROADMAP.md, deferred modules)")
    return FactorizedArrays(
        w1=_warrays(fa.w1), f_dst=_t(fa.f_dst, np.int64),
        e_f=_warrays(fa.e_f), w2=_warrays(fa.w2),
        g_src=_t(fa.g_src, np.int64), e_g=_warrays(fa.e_g),
        w1t=_warrays(fa.w1t), w2t=_warrays(fa.w2t),
        e_ft=_warrays(fa.e_ft), e_gt=_warrays(fa.e_gt),
        initial=_t(fa.initial, np.float32), final=_t(fa.final, np.float32),
        leaky=_t(fa.leaky, np.float32),
        res_src=_t(fa.res_src, np.int64), res_dst=_t(fa.res_dst, np.int64),
        res_pdf=_t(fa.res_pdf, np.int64),
        res_prob=_t(fa.res_prob, np.float32),
        engine=str(getattr(fa, "engine", "xla")),
        xsrc_mode=str(fa.xsrc_mode),
    ).to(device)


def linear_from_numpy(la, device="cpu") -> LinearArrays:
    """The port's LinearArrays from the JAX package's fields."""
    return LinearArrays(
        pdf_seq=_t(la.pdf_seq, np.int64), logp_seq=_t(la.logp_seq,
                                                      np.float32),
        final=_t(la.final, np.float32), graph_len=_t(la.graph_len, np.int64),
    ).to(device)


def semiring_from_numpy(xa, device="cpu") -> SemiringArrays:
    """The port's SemiringArrays from the fields of the JAX package's
    ``SemiringXLArrays`` (arc ids padded with S_pad, logp with -inf): the
    kernels' per-graph lists are built here from the ids."""
    return semiring_from_ids(
        *(np.asarray(getattr(xa, f)) for f in
          ("src", "dst", "pdf", "logp", "initial", "final"))).to(device)


def viterbi_from_numpy(ga, device="cpu") -> SemiringArrays:
    """The arrays ``viterbi_align`` reads from the fields of the JAX
    package's ``GraphArrays`` (log domain): ``bwd_*`` arcs (B, K) or,
    ``shared``, (K,) as one row.  The in-arc lists of the backward order
    are its own runs, so the arc ids are the JAX package's; its padded
    arcs (src = dst = 0, prob -inf) join state 0's list, inert."""
    if getattr(ga, "leaky", None) is not None:
        raise ValueError("viterbi_from_numpy needs log-domain GraphArrays, "
                         "got prob-domain ones (leaky is set)")
    f = [np.asarray(getattr(ga, n)) for n in
         ("bwd_src", "bwd_dst", "bwd_pdf", "bwd_prob", "initial", "final")]
    if ga.shared:
        f = [a[None] for a in f]
    return semiring_from_ids(*f).to(device)
