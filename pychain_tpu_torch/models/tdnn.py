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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from ..utils.device import resolve_device
from .layers import (BatchNorm, Dropout, conv_same, dropout_seed,
                     init_generator, lecun_normal_)


@dataclass(frozen=True)
class TDNNConfig:
    num_pdfs: int = 1024
    hidden_dim: int = 512
    kernel_sizes: Sequence[int] = (3, 3, 3, 3, 3)
    dilations: Sequence[int] = (1, 1, 3, 3, 3)
    strides: Sequence[int] = (1, 1, 1, 1, 1)
    dropout: float = 0.1
    # mesh axis name for kernel sharding in the JAX package; the port has
    # no model parallelism yet, and anything but None raises
    mp_axis: str | None = None


def require_no_mp_axis(mp_axis):
    if mp_axis is not None:
        raise NotImplementedError(
            f"mp_axis={mp_axis!r}: the port has no model parallelism yet "
            "(ROADMAP.md: \"parallelism\"); use mp_axis=None")


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
    ones and applies dropout."""

    def __init__(self, config: TDNNConfig, input_dim: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        require_no_mp_axis(config.mp_axis)
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.transpose(1, 2)
        for layer in self.layers:
            x = layer(x, train)
        return self.classifier(x.transpose(1, 2))

    def output_lengths(self, input_lengths) -> torch.Tensor:
        """Frame subsampling from the strides."""
        out = torch.as_tensor(input_lengths)
        for s in self.config.strides:
            if s > 1:
                out = (out + s - 1) // s
        return out
