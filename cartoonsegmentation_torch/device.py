"""Device and compute-dtype choice shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The given device, or CUDA; never a quiet move to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'the port runs on CUDA by default and no CUDA device is '
            "available; pass device='cpu' to run on the CPU")
    return torch.device('cuda')


def resolve_dtype(name: str, device: torch.device) -> torch.dtype:
    """A config dtype name: 'auto' → bf16 on CUDA, f32 on the CPU."""
    if name == 'auto':
        return torch.bfloat16 if device.type == 'cuda' else torch.float32
    if name in ('float32', 'f32'):
        return torch.float32
    return getattr(torch, name)
