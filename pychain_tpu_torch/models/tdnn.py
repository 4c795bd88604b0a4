"""TDNN acoustic model for chain training (the port of
``pychain_tpu/models/tdnn.py``).

A stack of dilated 1-D convolutions (time-delay layers) with ReLU, batch
norm and dropout, then a dense classifier: x (B, T, D) -> per-frame pdf
scores (B, T, num_pdfs).  The computation is flax's: SAME padding as
``lax`` pads it, flax's batch norm (``layers.BatchNorm``) and its
initialisers (``lecun_normal`` kernels, zero biases).  The convolutions
run channels-first through cuDNN; the model transposes once at its entry
and once at its exit.  ``convert.model_from_flax`` carries the JAX
package's weights across.

With ``mp_axis`` set and a mesh whose dim of that name has n > 1 ranks,
each rank holds 1/n of every kernel the JAX model annotates
(``nn.with_partitioning``): each convolution's output channels and the
classifier's input features (:meth:`TDNN.mp_spec`,
``parallel.model_parallel``).  Without a mesh, or with n = 1, the model
is the whole one, as flax's annotations only annotate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from ..utils.device import resolve_device
from .layers import (BatchNorm, Dropout, conv_same, dropout_seed,
                     init_generator, lecun_normal_, linear)


@dataclass(frozen=True)
class TDNNConfig:
    num_pdfs: int = 1024
    hidden_dim: int = 512
    kernel_sizes: Sequence[int] = (3, 3, 3, 3, 3)
    dilations: Sequence[int] = (1, 1, 3, 3, 3)
    strides: Sequence[int] = (1, 1, 1, 1, 1)
    dropout: float = 0.1
    # the mesh dim the annotated kernels shard over; None: no annotations
    mp_axis: str | None = None


def dense(in_features: int, out_features: int,
          generator: torch.Generator) -> nn.Linear:
    """flax's ``nn.Dense``: lecun_normal kernel, zero bias."""
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight, in_features, generator)
    nn.init.zeros_(layer.bias)
    return layer


def conv(in_features: int, features: int, kernel_size: int,
         generator: torch.Generator, dilation: int = 1, stride: int = 1,
         bias: bool = True) -> nn.Conv1d:
    """flax's ``nn.Conv`` (padding applied by ``layers.conv_same``):
    lecun_normal kernel over fan_in = kernel_size * in_features, zero
    bias."""
    layer = nn.Conv1d(in_features, features, kernel_size, stride=stride,
                      dilation=dilation, bias=bias)
    lecun_normal_(layer.weight, in_features * kernel_size, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class TDNNLayer(nn.Module):
    """Conv (SAME) -> ReLU -> BatchNorm -> dropout, on (B, C, T)."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 dilation: int, stride: int, dropout: float,
                 generator: torch.Generator | None = None):
        super().__init__()
        generator = init_generator(generator)
        self.conv = conv(in_features, features, kernel_size, generator,
                         dilation=dilation, stride=stride)
        self.bn = BatchNorm(features)
        self.dropout = Dropout(dropout, dropout_seed(generator))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = torch.relu(conv_same(self.conv, x))
        return self.dropout(self.bn(x, train), train)


class TDNN(nn.Module):
    """x (B, T, input_dim) -> per-frame pdf scores (B, T, num_pdfs).

    Unnormalised log-likelihood-style scores, as the chain objective
    expects.  ``device=None`` means CUDA (raising with no card); the
    weights are drawn on the CPU from ``generator`` (default: seeded
    with 0) and then moved, so a seed gives the same model everywhere.
    ``train=True`` normalises by batch statistics, moves the running
    ones and applies dropout.  ``mesh`` (a DeviceMesh with a dim named
    ``config.mp_axis``) places the annotated kernels over that dim."""

    def __init__(self, config: TDNNConfig, input_dim: int, device=None,
                 generator: torch.Generator | None = None, mesh=None):
        super().__init__()
        device = resolve_device(device)
        generator = init_generator(generator)
        self.config = config
        dims = [input_dim] + [config.hidden_dim] * len(config.kernel_sizes)
        self.layers = nn.ModuleList(
            TDNNLayer(dims[i], config.hidden_dim, k, d, s, config.dropout,
                      generator)
            for i, (k, d, s) in enumerate(zip(config.kernel_sizes,
                                              config.dilations,
                                              config.strides)))
        self.classifier = dense(dims[-1], config.num_pdfs, generator)
        self.to(device)
        if mesh is not None and config.mp_axis is not None:
            from ..parallel.model_parallel import place_parameters
            place_parameters(self, mesh)

    def mp_spec(self, name: str, param) -> int | None:
        """The JAX model's annotations, in the port's layout: a conv
        kernel (k, in, out) sharded (None, None, mp) is a weight (out, in,
        k) sharded on dim 0, the classifier's (in, out) sharded (mp, None)
        a Linear weight (out, in) on dim 1; None without ``mp_axis``."""
        if self.config.mp_axis is None:
            return None
        if name.endswith(".conv.weight"):
            return 0
        return 1 if name == "classifier.weight" else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.transpose(1, 2)
        for layer in self.layers:
            x = layer(x, train)
        return linear(self.classifier, x.transpose(1, 2))

    def output_lengths(self, input_lengths) -> torch.Tensor:
        """Frame subsampling from the strides."""
        out = torch.as_tensor(input_lengths)
        for s in self.config.strides:
            if s > 1:
                out = (out + s - 1) // s
        return out
