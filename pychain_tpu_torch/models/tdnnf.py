"""TDNN-F acoustic model: factored TDNN with semi-orthogonal bottlenecks
(the port of ``pychain_tpu/models/tdnnf.py``).

The standard Kaldi chain acoustic model (Povey et al., "Semi-Orthogonal
Low-Rank Matrix Factorization for Deep Neural Networks", Interspeech
2018).  Each layer factors one wide TDNN convolution into

    linear bottleneck conv (no bias, SEMI-ORTHOGONAL rows)
    -> affine conv back to hidden_dim -> ReLU -> BatchNorm -> dropout
    -> scaled residual bypass (0.66 x previous layer output)

Kaldi keeps the bottleneck factor M (rows <= cols) semi-orthogonal,
M M^T ~= sigma^2 I for a floating sigma, with a Newton-like update every
few optimizer steps (nnet-utils.cc ConstrainOrthonormalInternal,
"floating" case): :func:`constrain_semi_orthogonal`, which updates every
``linear_bottleneck`` weight in place.  Call it after the optimizer step
every ~4 steps.

With ``mp_axis`` set and a mesh whose dim of that name has n > 1 ranks,
each rank holds 1/n of every kernel the JAX model annotates: each
``affine`` convolution's output channels and the classifier's input
features (:meth:`TDNNF.mp_spec`).  The bottleneck stays whole, as in the
JAX model, so :func:`constrain_semi_orthogonal` acts on it as it is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.mp import local, mp_shard
from .layers import (BatchNorm, Dropout, conv_same, dropout_seed,
                     init_generator, linear)
from .tdnn import conv, dense

BOTTLENECK_KERNEL_NAME = "linear_bottleneck"


@dataclass(frozen=True)
class TDNNFConfig:
    num_pdfs: int = 1024
    hidden_dim: int = 512
    bottleneck_dim: int = 128
    num_layers: int = 6
    kernel_size: int = 2          # each factor spans 2 frames: the pair
    dilations: Sequence[int] = (1, 1, 1, 3, 3, 3)   # covers [-d, 0]+[0, d]
    dropout: float = 0.0
    bypass_scale: float = 0.66    # Kaldi's default residual scale
    mp_axis: str | None = None


class TDNNFLayer(nn.Module):
    """One factored layer on (B, C, T)."""

    def __init__(self, in_features: int, hidden_dim: int,
                 bottleneck_dim: int, kernel_size: int, dilation: int,
                 dropout: float, bypass_scale: float,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = init_generator(generator)
        self.bypass_scale = bypass_scale
        # factor 1: linear bottleneck, no bias, semi-orthogonal target
        # (found by name in constrain_semi_orthogonal)
        self.linear_bottleneck = conv(in_features, bottleneck_dim,
                                      kernel_size, generator,
                                      dilation=dilation, bias=False)
        # factor 2: affine back up to hidden_dim
        self.affine = conv(bottleneck_dim, hidden_dim, kernel_size,
                           generator, dilation=dilation)
        self.bn = BatchNorm(hidden_dim)
        self.dropout = Dropout(dropout, dropout_seed(generator))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        bypass = x
        x = conv_same(self.affine, conv_same(self.linear_bottleneck, x))
        x = self.dropout(self.bn(torch.relu(x), train), train)
        if bypass.shape[1] == x.shape[1]:
            x = x + self.bypass_scale * bypass
        return x


class TDNNF(nn.Module):
    """x (B, T, input_dim) -> per-frame pdf scores (B, T, num_pdfs).
    ``device``, ``generator`` and ``mesh`` as in :class:`~.tdnn.TDNN`."""

    def __init__(self, config: TDNNFConfig, input_dim: int, device=None,
                 generator: torch.Generator | None = None, mesh=None):
        super().__init__()
        device = resolve_device(device)
        generator = init_generator(generator)
        self.config = config
        dil = list(config.dilations)
        if len(dil) < config.num_layers:
            dil = dil + [dil[-1]] * (config.num_layers - len(dil))
        self.layers = nn.ModuleList(
            TDNNFLayer(input_dim if i == 0 else config.hidden_dim,
                       config.hidden_dim, config.bottleneck_dim,
                       config.kernel_size, dil[i], config.dropout,
                       config.bypass_scale, generator)
            for i in range(config.num_layers))
        width = config.hidden_dim if config.num_layers else input_dim
        self.classifier = dense(width, config.num_pdfs, generator)
        self.to(device)
        if mesh is not None and config.mp_axis is not None:
            from ..parallel.model_parallel import place_parameters
            place_parameters(self, mesh)

    def mp_spec(self, name: str, param) -> int | None:
        """The JAX model's annotations in the port's layout (as
        :meth:`~.tdnn.TDNN.mp_spec`): each ``affine`` weight on dim 0
        (output channels), the classifier's on dim 1 (input features), the
        bottleneck none; None without ``mp_axis``."""
        if self.config.mp_axis is None:
            return None
        if name.endswith(".affine.weight"):
            return 0
        return 1 if name == "classifier.weight" else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.transpose(1, 2)
        for layer in self.layers:
            x = layer(x, train)
        return linear(self.classifier, x.transpose(1, 2))

    def output_lengths(self, input_lengths) -> torch.Tensor:
        return torch.as_tensor(input_lengths)   # no frame subsampling


def _bottleneck_weights(model_or_state_dict):
    """Every ``linear_bottleneck`` conv weight (bneck, in, k), as the
    tensors the model or state dict holds (a replicated DTensor's local
    tensor, which shares its storage)."""
    sd = (model_or_state_dict.state_dict(keep_vars=True)
          if isinstance(model_or_state_dict, nn.Module)
          else model_or_state_dict)
    for key, w in sd.items():
        parts = key.split(".")
        if BOTTLENECK_KERNEL_NAME in parts[:-1] and parts[-1] == "weight":
            if mp_shard(w) is not None:
                raise ValueError(
                    f"{key} is sharded: the semi-orthogonal update needs "
                    "the whole bottleneck (the model's own annotations "
                    "keep it whole)")
            yield local(w)


def _sigma2(m: torch.Tensor):
    p = m @ m.T
    return p, torch.sum(p * p) / torch.trace(p)


@torch.no_grad()
def constrain_semi_orthogonal(model_or_state_dict,
                              update_speed: float = 0.125):
    """One floating-case semi-orthogonal update of every TDNN-F
    bottleneck weight, in place; returns its argument.

    M is the weight (bneck, in, k) as (bneck, in * k), rows <= cols, and
    sigma^2 = tr((M M^T)^2) / tr(M M^T) the scale that minimises the
    Frobenius deviation (Kaldi nnet-utils.cc, floating case):

        M <- M - (update_speed / sigma^2) (M M^T - sigma^2 I) M

    The JAX package's M orders its columns (k, in); the update acts on
    each column alike, so the order does not change it."""
    for w in _bottleneck_weights(model_or_state_dict):
        m = w.reshape(w.shape[0], -1)
        p, sigma2 = _sigma2(m)
        d = p - sigma2 * torch.eye(p.shape[0], dtype=p.dtype,
                                   device=p.device)
        w.copy_((m - (update_speed / sigma2) * (d @ m)).reshape(w.shape))
    return model_or_state_dict


@torch.no_grad()
def semi_orthogonal_deviation(model_or_state_dict) -> float:
    """max over bottleneck weights of ||M M^T / sigma^2 - I||_F /
    sqrt(rows): a convergence diagnostic for the constraint."""
    worst = 0.0
    for w in _bottleneck_weights(model_or_state_dict):
        p, sigma2 = _sigma2(w.reshape(w.shape[0], -1))
        eye = torch.eye(p.shape[0], dtype=p.dtype, device=p.device)
        dev = torch.linalg.norm(p / sigma2 - eye) / p.shape[0] ** 0.5
        worst = max(worst, float(dev))
    return worst
