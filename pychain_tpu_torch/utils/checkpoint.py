"""Checkpoint / resume (the port of ``pychain_tpu/utils/checkpoint.py``).

The same layout as the JAX package's: ``path/step_N`` for each saved step
and a ``LATEST`` marker holding the newest N.  The state is a nested
dict of tensors, such as ``{"model": model.state_dict(), "opt":
optimizer.state_dict()}``, written by ``torch.save`` and read by
``torch.load(weights_only=True)``.  The JAX package's orbax format is
not read.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(path: str, step: int, state: Any) -> None:
    """Save ``state`` at ``path/step_N`` and mark N the latest.  The file
    is written under a temporary name and renamed, so an interrupted
    save leaves the previous checkpoint whole."""
    path = os.path.abspath(path)
    step_dir = os.path.join(path, f"step_{step}")
    os.makedirs(step_dir, exist_ok=True)
    target = os.path.join(step_dir, STATE_FILE)
    torch.save(state, target + ".tmp")
    os.replace(target + ".tmp", target)
    marker = os.path.join(path, "LATEST")
    with open(marker + ".tmp", "w") as f:
        f.write(str(step))
    os.replace(marker + ".tmp", marker)


def latest_step(path: str) -> Optional[int]:
    marker = os.path.join(os.path.abspath(path), "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def _device_of(template):
    if isinstance(template, torch.Tensor):
        return template.device
    items = (template.values() if isinstance(template, dict) else
             template if isinstance(template, (list, tuple)) else ())
    for v in items:
        dev = _device_of(v)
        if dev is not None:
            return dev
    return None


def _like(loaded, template, where="state"):
    """``loaded`` with each tensor on the device of the template's tensor
    at its place.  Raises ValueError where the template has an entry
    that ``loaded`` lacks or a tensor of another shape or dtype.  Entries
    the template lacks (a fresh optimizer's empty ``state``) stay where
    ``torch.load`` put them: on the template's device, from where
    ``Optimizer.load_state_dict`` moves the moments to their parameters
    (an Adam step count stays there)."""
    if isinstance(template, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or \
                loaded.shape != template.shape or \
                loaded.dtype != template.dtype:
            got = ((tuple(loaded.shape), loaded.dtype)
                   if isinstance(loaded, torch.Tensor)
                   else type(loaded).__name__)
            raise ValueError(f"checkpoint {where}: {got} where the template "
                             f"has {(tuple(template.shape), template.dtype)}")
        return loaded.to(template.device)
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or template.keys() - loaded.keys():
            raise ValueError(f"checkpoint {where}: no entries "
                             f"{sorted(map(str, template.keys()))} as the "
                             "template has")
        return {k: _like(v, template[k], f"{where}[{k!r}]")
                if k in template else v for k, v in loaded.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or \
                len(loaded) != len(template):
            raise ValueError(f"checkpoint {where}: a sequence of another "
                             "length than the template's")
        return type(template)(_like(a, b, f"{where}[{i}]") for i, (a, b) in
                              enumerate(zip(loaded, template)))
    return loaded


def restore_checkpoint(path: str, template: Any,
                       step: Optional[int] = None) -> tuple[int, Any]:
    """Restore the given (or latest) step as ``(step, state)``.
    ``template`` is a like-shaped state (for example a fresh model's and
    optimizer's ``state_dict``s): the file is read onto the template's
    device (its first tensor's) and each tensor goes where the
    template's tensor at its place is.  Raises FileNotFoundError when
    there is no checkpoint and ValueError when it does not fit the
    template."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    target = os.path.join(os.path.abspath(path), f"step_{step}", STATE_FILE)
    if not os.path.exists(target):
        raise FileNotFoundError(f"no checkpoint {target}")
    loaded = torch.load(target, map_location=_device_of(template),
                        weights_only=True)
    return step, _like(loaded, template)
