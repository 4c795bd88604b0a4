"""Pieces the acoustic models share, written to compute what flax.linen
computes in the JAX package's models.

* :func:`lecun_normal_` — flax's default kernel initialiser: a normal of
  variance 1 / fan_in truncated at two standard deviations (not
  PyTorch's Kaiming-uniform).
* :func:`same_padding` — ``padding="SAME"`` as ``lax`` pads it, also with
  a stride (PyTorch's ``padding="same"`` refuses a stride and puts an
  even kernel's odd pad on the other side).
* :class:`BatchNorm` — ``flax.linen.BatchNorm(momentum=0.95)``: the
  running variance takes the biased batch variance, where
  ``F.batch_norm`` would take the unbiased one (a factor n / (n - 1)).
* :class:`Dropout` — inverted dropout whose mask comes from a generator
  the module holds.
* :func:`conv_same` / :func:`linear` — a convolution or a dense layer
  whose weight may be placed over a mesh's ``mp`` dim.

Convolution layers work channels-first (B, C, T); a model transposes
once at its entry and once at its exit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.dist import all_reduce_sum, stats_group
from ..utils.mp import local, mp_apply, mp_shard

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def init_generator(generator=None) -> torch.Generator:
    """The CPU generator that initialises a model: ``generator`` or, when
    None, one seeded with 0, so that a model is the same on every
    device."""
    if generator is None:
        return torch.Generator().manual_seed(0)
    if generator.device.type != "cpu":
        raise ValueError("models draw their initial weights on the CPU: "
                         f"pass a CPU generator, got one on "
                         f"{generator.device}")
    return generator


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal()``: variance 1 / fan_in, truncated at two
    standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std,
                                     2.0 * std, generator=generator)


def same_padding(length: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1) -> tuple[int, int]:
    """(low, high) pads of ``padding="SAME"`` the way ``lax`` computes
    them: the output has ceil(length / stride) frames and the low side
    gets the smaller half of the total."""
    out = -(-length // stride)
    total = max((out - 1) * stride + dilation * (kernel_size - 1) + 1
                - length, 0)
    return total // 2, total - total // 2


def conv_same(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (built with padding 0) over x (B, C, T) with SAME padding;
    a weight sharded over a mesh's mp dim runs its shard between the mp
    collectives (``utils.mp.mp_apply``), a replicated one as its local
    tensor."""
    pad = same_padding(x.shape[-1], conv.kernel_size[0], conv.stride[0],
                       conv.dilation[0])

    def padded(v):
        return F.pad(v, pad) if any(pad) else v

    if mp_shard(conv.weight) is None:
        return F.conv1d(padded(x), local(conv.weight), local(conv.bias),
                        conv.stride, 0, conv.dilation, conv.groups)
    # the collectives carry x unpadded
    return mp_apply(lambda v, w: F.conv1d(padded(v), w, None, conv.stride,
                                          0, conv.dilation),
                    x, conv.weight, conv.bias, 1)


def linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer`` over the last dim of x; a weight placed over a mesh's mp
    dim as in :func:`conv_same`."""
    if mp_shard(layer.weight) is None:
        return F.linear(x, local(layer.weight), local(layer.bias))
    return mp_apply(F.linear, x, layer.weight, layer.bias, -1)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.95, epsilon=1e-5)`` over the
    channels of (B, C, T).

    In training the statistics are taken over every frame, padded ones
    included (as in flax), and the running statistics move by
    ``momentum * old + (1 - momentum) * batch`` with the biased batch
    variance.  Under data parallelism (the group that ``parallel``
    registers, ``utils.dist.stats_group``) the statistics are the whole
    batch's: the ranks' sums and sums of squared deviations are
    all-reduced, as the JAX recipe's ``--dp`` step takes them over its
    global batch.  ``weight`` / ``bias`` are flax's ``scale`` /
    ``bias`` (replicated DTensors on a placed model: their local
    tensors)."""

    def __init__(self, features: int, momentum: float = 0.95,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        weight, bias = local(self.weight), local(self.bias)
        if not train:
            # flax's arithmetic, through which autograd also reaches the
            # running statistics when they are trained as parameters (the
            # corpus recipe differentiates flax's whole variables tree)
            mul = torch.rsqrt(self.running_var + self.eps) * weight
            return ((x - self.running_mean[:, None]) * mul[:, None]
                    + bias[:, None])
        group = stats_group()
        if group is None:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2), correction=0)
                self._update(mean, var)
            return F.batch_norm(x, None, None, weight, bias, True, 0.0,
                                self.eps)
        # the whole batch's statistics, two passes as var_mean takes them
        n = all_reduce_sum(x.new_tensor(float(x.shape[0] * x.shape[2])),
                           group)
        mean = all_reduce_sum(x.sum(dim=(0, 2)), group) / n
        d = x - mean[None, :, None]
        var = all_reduce_sum((d * d).sum(dim=(0, 2)), group) / n
        with torch.no_grad():
            self._update(mean, var)
        mul = torch.rsqrt(var + self.eps) * weight
        return d * mul[None, :, None] + bias[None, :, None]

    def _update(self, mean, var):
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
        self.running_var.mul_(m).add_(var, alpha=1.0 - m)


class Dropout(nn.Module):
    """Inverted dropout (flax's: keep with probability 1 - rate, scaled
    by 1 / (1 - rate)) in training only.  The mask comes from a generator
    on the input's device, seeded with ``seed`` at its first use there."""

    def __init__(self, rate: float, seed: int):
        super().__init__()
        self.rate, self.seed = float(rate), int(seed)
        self._generator = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        g = self._generator
        if g is None or g.device != x.device:
            g = self._generator = torch.Generator(x.device).manual_seed(
                self.seed)
        keep = torch.rand(x.shape, generator=g, device=x.device,
                          dtype=x.dtype) >= self.rate
        return x * keep / (1.0 - self.rate)


def dropout_seed(generator: torch.Generator) -> int:
    """A seed for a :class:`Dropout`, drawn from the init generator."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator))
