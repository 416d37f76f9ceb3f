"""Device and compute-dtype choice shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The given device, or CUDA; never a quiet move to the CPU. Every
    entry point resolves its device here, so this is where the port's
    f32 policy is set: on CUDA, f32 matmuls and convs run in true f32,
    as the JAX reference's do, with TF32 off (process-wide flags; bf16
    work is not affected)."""
    device = torch.device(device) if device is not None else None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'the port runs on CUDA by default and no CUDA device is '
                "available; pass device='cpu' to run on the CPU")
        device = torch.device('cuda')
    if device.type == 'cuda':
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device


def resolve_dtype(name: str, device: torch.device) -> torch.dtype:
    """A config dtype name: 'auto' → bf16 on CUDA, f32 on the CPU."""
    if name == 'auto':
        return torch.bfloat16 if device.type == 'cuda' else torch.float32
    if name in ('float32', 'f32'):
        return torch.float32
    return getattr(torch, name)
