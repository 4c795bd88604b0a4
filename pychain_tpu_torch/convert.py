"""Carry graph state and model weights from the JAX package into the port.

The graph functions read attributes and go through ``np.asarray``, so
they take the JAX package's ``FactorizedArrays`` / ``LinearArrays`` /
``SemiringXLArrays`` / ``GraphArrays`` (or anything with the same
fields) without importing JAX.  :func:`model_from_flax` takes a flax
model's ``variables`` as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, variables)``) and :func:`model_to_flax`
gives them back, each also for a model placed over a mesh's ``mp`` dim
(each rank its slice; the whole arrays gathered back).  Every function
puts its result on ``device``:
``None`` means CUDA and raises with no card, as every entry point of the
port does; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.factorized import FactorizedArrays, WArrays
from .ops.linear import LinearArrays
from .ops.semiring import SemiringArrays, semiring_from_ids
from .utils.device import resolve_device
from .utils.mp import whole


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


def factorized_from_numpy(fa, device=None) -> FactorizedArrays:
    """The port's FactorizedArrays from the JAX package's fields, a
    shared log-domain graph's ``log_semantics`` and ``log_shifts``
    among them."""
    device = resolve_device(device)
    shifts = getattr(fa, "log_shifts", None)
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
        log_semantics=bool(getattr(fa, "log_semantics", False)),
        log_shifts=None if shifts is None else _t(shifts, np.float32),
    ).to(device)


def linear_from_numpy(la, device=None) -> LinearArrays:
    """The port's LinearArrays from the JAX package's fields."""
    device = resolve_device(device)
    return LinearArrays(
        pdf_seq=_t(la.pdf_seq, np.int64), logp_seq=_t(la.logp_seq,
                                                      np.float32),
        final=_t(la.final, np.float32), graph_len=_t(la.graph_len, np.int64),
    ).to(device)


def semiring_from_numpy(xa, device=None) -> SemiringArrays:
    """The port's SemiringArrays from the fields of the JAX package's
    ``SemiringXLArrays`` (arc ids padded with S_pad, logp with -inf): the
    kernels' per-graph lists are built here from the ids."""
    device = resolve_device(device)
    return semiring_from_ids(
        *(np.asarray(getattr(xa, f)) for f in
          ("src", "dst", "pdf", "logp", "initial", "final"))).to(device)


def viterbi_from_numpy(ga, device=None) -> SemiringArrays:
    """The arrays ``viterbi_align`` reads from the fields of the JAX
    package's ``GraphArrays`` (log domain): ``bwd_*`` arcs (B, K) or,
    ``shared``, (K,) as one row.  The in-arc lists of the backward order
    are its own runs, so the arc ids are the JAX package's; its padded
    arcs (src = dst = 0, prob -inf) join state 0's list, inert."""
    device = resolve_device(device)
    if getattr(ga, "leaky", None) is not None:
        raise ValueError("viterbi_from_numpy needs log-domain GraphArrays, "
                         "got prob-domain ones (leaky is set)")
    f = [np.asarray(getattr(ga, n)) for n in
         ("bwd_src", "bwd_dst", "bwd_pdf", "bwd_prob", "initial", "final")]
    if ga.shared:
        f = [a[None] for a in f]
    return semiring_from_ids(*f).to(device)


# ----------------------------------------------------------------------
# Model weights: flax variables <-> the port's nn.Modules
# ----------------------------------------------------------------------

def _flatten(tree, prefix=()):
    """{path tuple: leaf} of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _conv_leaves(scope, key, bias=True):
    yield ("params",) + scope + ("kernel",), f"{key}.weight", None, "conv"
    if bias:
        yield ("params",) + scope + ("bias",), f"{key}.bias", None, "vec"


def _bn_leaves(scope, key):
    for coll, leaf, name in (("params", "scale", "weight"),
                             ("params", "bias", "bias"),
                             ("batch_stats", "mean", "running_mean"),
                             ("batch_stats", "var", "running_var")):
        yield (coll,) + scope + ("BatchNorm_0", leaf), f"{key}.{name}", \
            None, "vec"


def _dense_leaves(key):
    yield ("params", "Dense_0", "kernel"), f"{key}.weight", None, "dense"
    yield ("params", "Dense_0", "bias"), f"{key}.bias", None, "vec"


def _flax_leaves(config):
    """(flax path, torch state-dict key, gate, kind) for every leaf of
    the flax model of ``config``.  ``gate`` names the rows of an LSTM
    tensor ("i", "f", "g", "o": ``nn.LSTM``'s order) that a flax block
    fills."""
    from .models import BLSTMConfig, TDNNConfig, TDNNFConfig
    if isinstance(config, TDNNConfig):
        for i in range(len(config.kernel_sizes)):
            scope, key = (f"TDNNLayer_{i}",), f"layers.{i}"
            yield from _conv_leaves(scope + ("Conv_0",), f"{key}.conv")
            yield from _bn_leaves(scope, f"{key}.bn")
    elif isinstance(config, TDNNFConfig):
        for i in range(config.num_layers):
            scope, key = (f"tdnnf_{i}",), f"layers.{i}"
            yield from _conv_leaves(scope + ("linear_bottleneck",),
                                    f"{key}.linear_bottleneck", bias=False)
            yield from _conv_leaves(scope + ("affine",), f"{key}.affine")
            yield from _bn_leaves(scope, f"{key}.bn")
    elif isinstance(config, BLSTMConfig):
        dirs = ("", "_reverse")[:1 + config.bidirectional]
        for layer in range(config.num_layers):
            for d, sfx in enumerate(dirs):
                cell = (f"OptimizedLSTMCell_{len(dirs) * layer + d}",)
                key = f"lstms.{layer}"
                for g in "ifgo":
                    yield (("params",) + cell + (f"i{g}", "kernel"),
                           f"{key}.weight_ih_l0{sfx}", g, "dense")
                    yield (("params",) + cell + (f"h{g}", "kernel"),
                           f"{key}.weight_hh_l0{sfx}", g, "dense")
                    yield (("params",) + cell + (f"h{g}", "bias"),
                           f"{key}.bias_hh_l0{sfx}", g, "vec")
    else:
        raise TypeError(f"no port model for {type(config).__name__}")
    yield from _dense_leaves("classifier")


def _layout(t, kind):
    """A conv kernel (k, in, out) <-> weight (out, in, k), a Dense kernel
    (in, out) <-> Linear weight (out, in); each map is its own inverse."""
    return {"conv": lambda: t.permute(2, 1, 0), "dense": lambda: t.T,
            "vec": lambda: t}[kind]()


def _rows(t, gate):
    """The rows of ``t`` that LSTM gate ``gate`` owns (all without)."""
    if gate is None:
        return t
    h = t.shape[0] // 4
    i = "ifgo".index(gate)
    return t[i * h:(i + 1) * h]


def model_from_flax(config, variables, device=None, mesh=None):
    """The port's model for ``config`` (a ``TDNNConfig``,
    ``TDNNFConfig`` or ``BLSTMConfig``) holding the flax ``variables``
    (``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
    arrays): the same function of its input.

    Conv kernels (k, in, out) become weights (out, in, k), Dense kernels
    (in, out) Linear weights (out, in), BatchNorm ``scale`` / ``bias`` /
    ``mean`` / ``var`` the port's ``weight`` / ``bias`` /
    ``running_mean`` / ``running_var``, and an LSTM cell's eight blocks
    the rows of ``weight_ih`` / ``weight_hh`` / ``bias_hh``.  With
    ``mesh`` and a config's ``mp_axis``, the kernels the model annotates
    are placed over that mesh dim (``parallel.place_parameters``), each
    rank keeping its slice of the flax arrays.  Raises ValueError on a
    missing or a surplus leaf, or on a shape that does not fit."""
    from .models import BLSTM, BLSTMConfig, TDNN, TDNNConfig, TDNNF
    device = resolve_device(device)
    flat = _flatten(variables)
    leaves = list(_flax_leaves(config))
    want = {path for path, *_ in leaves}
    missing = sorted("/".join(p) for p in want - flat.keys())
    surplus = sorted("/".join(p) for p in flat.keys() - want)
    if missing or surplus:
        raise ValueError(f"flax variables do not fit {type(config).__name__}"
                         f": missing {missing}, surplus {surplus}")
    cls = (TDNN if isinstance(config, TDNNConfig) else
           BLSTM if isinstance(config, BLSTMConfig) else TDNNF)
    # the first leaf is the first layer's input kernel
    path, _, _, kind = leaves[0]
    input_dim = np.shape(flat[path])[1 if kind == "conv" else 0]
    model = cls(config, int(input_dim), device="cpu")
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for path, key, gate, kind in leaves:
        src = _layout(torch.as_tensor(np.array(flat[path], np.float32)),
                      kind)
        dst = _rows(state[key], gate)
        if dst.shape != src.shape:
            raise ValueError(f"flax leaf {'/'.join(path)} of shape "
                             f"{tuple(np.shape(flat[path]))} does not fit "
                             f"{key} {tuple(dst.shape)}")
        dst.copy_(src)
    model.load_state_dict(state)
    model.to(device)
    if mesh is not None and getattr(config, "mp_axis", None):
        from .parallel.model_parallel import place_parameters
        place_parameters(model, mesh)
    return model


def model_to_flax(model) -> dict:
    """The flax ``variables`` (nested dicts of float32 numpy arrays) of
    the port's ``model``: the inverse of :func:`model_from_flax`.  An
    LSTM gate's flax bias is ``bias_hh + bias_ih``.  A placed weight is
    gathered whole (every rank of the model's mesh calls it)."""
    state = {k: whole(v).detach().to("cpu", torch.float32)
             for k, v in model.state_dict().items()}
    flat = {}
    for path, key, gate, kind in _flax_leaves(model.config):
        t = _rows(state[key], gate)
        if key.split(".")[-1].startswith("bias_hh"):
            t = t + _rows(state[key.replace("bias_hh", "bias_ih")], gate)
        flat[path] = _layout(t, kind).contiguous().numpy().copy()
    return _nest(flat)
