"""Acoustic models for chain training (the port of
``pychain_tpu/models``): TDNN, TDNN-F and BLSTM as ``torch.nn.Module``s
that compute what the JAX package's flax modules compute.
``convert.model_from_flax`` / ``model_to_flax`` carry weights between
the two."""

from .tdnn import TDNN, TDNNConfig
from .lstm import BLSTM, BLSTMConfig
from .tdnnf import (
    TDNNF,
    TDNNFConfig,
    constrain_semi_orthogonal,
    semi_orthogonal_deviation,
)

__all__ = [
    "TDNN", "TDNNConfig",
    "BLSTM", "BLSTMConfig",
    "TDNNF", "TDNNFConfig",
    "constrain_semi_orthogonal", "semi_orthogonal_deviation",
]
