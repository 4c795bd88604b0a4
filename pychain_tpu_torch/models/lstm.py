"""Bidirectional LSTM acoustic model for chain training (the port of
``pychain_tpu/models/lstm.py``).

Each layer is one cuDNN ``nn.LSTM`` (both directions), with dropout
after every layer, then a dense classifier.  The cell computes what
flax's ``OptimizedLSTMCell`` does (gates i, f, g, o, ``nn.LSTM``'s
order): flax's input kernels (no bias) are ``weight_ih``, its hidden
kernels ``weight_hh`` and their biases ``bias_hh``; ``bias_ih`` stays
zero and takes no gradient, so the cell has one bias a gate as flax's
has.  Initialisation is flax's: lecun_normal input kernels, orthogonal
recurrent kernels (each gate's block), zero biases.

With ``lengths`` the sequences are packed: the backward direction reads
each sequence from its own last frame, never the padding first (flax's
``nn.RNN(reverse=True, keep_order=True, seq_lengths=...)``), and the
outputs past a length are those of padding (the classifier's bias).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from ..utils.device import resolve_device
from .layers import Dropout, dropout_seed, init_generator, lecun_normal_
from .tdnn import dense

GATES = 4   # i, f, g, o


@dataclass(frozen=True)
class BLSTMConfig:
    num_pdfs: int = 1024
    hidden_dim: int = 512
    num_layers: int = 3
    dropout: float = 0.1
    bidirectional: bool = True


def lstm(in_features: int, hidden: int, bidirectional: bool,
         generator: torch.Generator) -> nn.LSTM:
    """One layer with flax's initialisation and a frozen zero
    ``bias_ih``."""
    layer = nn.LSTM(in_features, hidden, batch_first=True,
                    bidirectional=bidirectional)
    with torch.no_grad():
        for sfx in ("", "_reverse")[:1 + bidirectional]:
            w_ih = getattr(layer, f"weight_ih_l0{sfx}")
            w_hh = getattr(layer, f"weight_hh_l0{sfx}")
            for g in range(GATES):
                rows = slice(g * hidden, (g + 1) * hidden)
                lecun_normal_(w_ih[rows], in_features, generator)
                nn.init.orthogonal_(w_hh[rows], generator=generator)
            for name in ("bias_ih", "bias_hh"):
                nn.init.zeros_(getattr(layer, f"{name}_l0{sfx}"))
            getattr(layer, f"bias_ih_l0{sfx}").requires_grad_(False)
    return layer


class BLSTM(nn.Module):
    """x (B, T, input_dim) -> per-frame pdf scores (B, T, num_pdfs).

    ``lengths`` (B,) masks padding: without it the reversed direction
    would read the pad frames first and contaminate the backward states
    of every short utterance.  ``device`` and ``generator`` as in
    :class:`~.tdnn.TDNN`."""

    def __init__(self, config: BLSTMConfig, input_dim: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        device = resolve_device(device)
        generator = init_generator(generator)
        self.config = config
        width = config.hidden_dim * (2 if config.bidirectional else 1)
        self.lstms = nn.ModuleList(
            lstm(input_dim if i == 0 else width, config.hidden_dim,
                 config.bidirectional, generator)
            for i in range(config.num_layers))
        self.dropouts = nn.ModuleList(
            Dropout(config.dropout, dropout_seed(generator))
            for _ in range(config.num_layers))
        self.classifier = dense(width if config.num_layers else input_dim,
                                config.num_pdfs, generator)
        self.to(device)

    def forward(self, x: torch.Tensor, train: bool = False,
                lengths=None) -> torch.Tensor:
        T = x.shape[1]
        if lengths is not None:
            lens = torch.as_tensor(lengths).to("cpu", torch.int64)
            x = pack_padded_sequence(x, lens, batch_first=True,
                                     enforce_sorted=False)
        for layer, drop in zip(self.lstms, self.dropouts):
            x, _ = layer(x)
            if lengths is None:
                x = drop(x, train)
            else:
                x = x._replace(data=drop(x.data, train))
        if lengths is not None:
            x, _ = pad_packed_sequence(x, batch_first=True, total_length=T)
        return self.classifier(x)

    def output_lengths(self, input_lengths) -> torch.Tensor:
        return torch.as_tensor(input_lengths)
