"""pychain_tpu_torch — the LF-MMI ("chain") objective in PyTorch and CUDA.

The PyTorch/CUDA port of ``pychain_tpu``, kept beside it.  It imports
PyTorch and never JAX or the JAX package.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.  The shared denominator
runs on two hand-written Hopper kernels (``ops/fact_kernels.py``) when a
column's state vectors fit one block's shared memory, and past that on
two thread-block-cluster kernels (``ops/stream_kernels.py``); the linear
numerators on a closed form, and any other log-domain numerator list
(cyclic, self-loop, flat-start: ``graphs/builder.py``) on two more
(``ops/semiring_kernels.py``); Viterbi alignment and phone decoding
(``viterbi_align``, ``decode.PhoneDecoder``) on a seventh
(``ops/viterbi_kernels.py``).  The XL roofline probe
(``python -m pychain_tpu_torch.tools.xl_roofline``) times its recurrence
on a CUDA-core kernel and a tensor-core one (``tools/xl_roofline.py``).

Public surface, for what is ported (the reference's
``__init__.py:1-2`` re-exports loss + graph):
"""

from .graph import ChainGraph, ChainGraphBatch
from .loss import (
    ChainFunction,
    ChainLoss,
    chain_function,
    chain_function_with_aux,
    chain_loss,
)
from .graphs.fst import FST
from .ops.viterbi import ViterbiResult, viterbi_align
from .utils.diagnostics import (
    check_result,
    get_verbose_level,
    set_verbose_level,
)

__version__ = "0.1.0"

__all__ = [
    "ChainGraph",
    "ChainGraphBatch",
    "ChainFunction",
    "ChainLoss",
    "chain_function",
    "chain_function_with_aux",
    "chain_loss",
    "FST",
    "viterbi_align",
    "ViterbiResult",
    "check_result",
    "set_verbose_level",
    "get_verbose_level",
]
