"""Where the port's tensors live: on the card unless the caller asks
for the CPU."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  With no card this raises instead of
    carrying on on the CPU: a caller who wants the CPU says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pychain_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain PyTorch engines on the CPU")
    return dev


def host_to(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``.  A CPU tensor goes to a CUDA device through
    pinned memory without waiting for the device's queue (a plain
    ``.to("cuda")`` of pageable memory synchronises the stream)."""
    device = torch.device(device)
    if t.device == device or device.type != "cuda" or t.is_cuda:
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@contextlib.contextmanager
def ieee_float32():
    """Float32 products in IEEE float32 on the card (no TF32) for the
    duration, whatever the caller's setting; restored after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
