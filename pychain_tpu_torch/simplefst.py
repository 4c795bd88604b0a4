"""Compatibility shim mirroring the reference's ``simplefst`` extension.

The port's counterpart of ``pychain_tpu/simplefst.py``.  The reference
exposes an OpenFST binding as a module named ``simplefst`` with a
``StdVectorFst`` class (openfst_binding/src/fstext.cc:174-184).  Code
written against it runs on the port by swapping the import:

    import pychain_tpu_torch.simplefst as simplefst
    fst = simplefst.StdVectorFst.read("den.fst")
    tensors = simplefst.StdVectorFst.fst_to_tensor(fst, log_domain)
    leaky = simplefst.StdVectorFst.set_leaky_probs(fst)

Tensors are returned as numpy arrays, as the JAX package returns them
(the reference returns torch CPU tensors; both are host arrays consumed
by graph construction).  The return order of ``fst_to_tensor`` matches
fstext.cc:109-116.
"""

from __future__ import annotations

import numpy as np

from .graphs.compiler import compile_fst, leaky_probs
from .graphs.fst import FST


class StdVectorFst(FST):
    """Reference-compatible facade over :class:`pychain_tpu_torch.FST`."""

    @staticmethod
    def read(filename: str) -> "StdVectorFst":
        return _as_std(FST.read(filename))

    @staticmethod
    def read_ark(filename: str, offset: int) -> "StdVectorFst":
        return _as_std(FST.read_ark(filename, offset))

    @staticmethod
    def fst_to_tensor(fst: FST, log_domain: bool = False):
        """(fwd_transitions, fwd_probs, fwd_indices, bwd_transitions,
        bwd_probs, bwd_indices, final_probs) — fstext.cc:109-116 order."""
        g = compile_fst(fst, log_domain=log_domain)
        return (
            g.forward_transitions,
            g.forward_transition_probs,
            g.forward_transition_indices,
            g.backward_transitions,
            g.backward_transition_probs,
            g.backward_transition_indices,
            g.final_probs,
        )

    @staticmethod
    def set_leaky_probs(fst: FST) -> np.ndarray:
        return leaky_probs(fst)

    @staticmethod
    def start_state(fst: FST) -> int:
        return fst.start

    def num_states(self) -> int:  # method in the reference binding
        return FST.num_states.fget(self)


def _as_std(fst: FST) -> StdVectorFst:
    out = StdVectorFst()
    out.__dict__.update(fst.__dict__)
    return out
