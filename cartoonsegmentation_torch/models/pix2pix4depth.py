"""BoostingMonoDepth's pix2pix depth-merge generator (port of
``cartoonsegmentation_tpu/models/pix2pix4depth.py``): the 'unet_1024'
UnetGenerator, 10 downs, ngf 64, norm 'none' — every conv without bias
but the outermost up-convolution.

The modules nest as the reference's UnetSkipConnectionBlocks, so the
parameter names are those of ``latest_net_G.pth`` (``model.model.0``,
``model.model.1.model.1``, ...) and ``load_state_dict`` takes it.
Input (B, 2, S, S): the outer (base) and inner (detail) estimates, each
min-max normalised to [-1, 1]; output (B, 1, S, S) in [-1, 1] (tanh).
"""
from __future__ import annotations

import torch
from torch import nn


class UnetSkipBlock(nn.Module):
    """One level: down (LeakyReLU 0.2 but at the outermost), the inner
    levels, up (ReLU, a transposed 4x4 stride-2 conv); an inner level
    returns its input joined to its output."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: int = None,
                 submodule: nn.Module = None, outermost: bool = False,
                 innermost: bool = False):
        super().__init__()
        self.outermost = outermost
        input_nc = input_nc or outer_nc
        down = nn.Conv2d(input_nc, inner_nc, 4, 2, 1, bias=False)
        if outermost:
            up = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1)
            mods = [down, submodule, nn.ReLU(), up, nn.Tanh()]
        elif innermost:
            up = nn.ConvTranspose2d(inner_nc, outer_nc, 4, 2, 1, bias=False)
            mods = [nn.LeakyReLU(0.2), down, nn.ReLU(), up, nn.Identity()]
        else:
            up = nn.ConvTranspose2d(inner_nc * 2, outer_nc, 4, 2, 1,
                                    bias=False)
            mods = [nn.LeakyReLU(0.2), down, nn.Identity(), submodule,
                    nn.ReLU(), up, nn.Identity()]
        self.model = nn.Sequential(*mods)

    def forward(self, x):
        if self.outermost:
            return self.model(x)
        return torch.cat([x, self.model(x)], 1)


class Pix2Pix4Depth(nn.Module):
    """UnetGenerator(input_nc=2, output_nc=1, num_downs, ngf,
    norm='none'); the tests shrink num_downs and ngf."""

    def __init__(self, num_downs: int = 10, ngf: int = 64):
        super().__init__()
        block = UnetSkipBlock(ngf * 8, ngf * 8, innermost=True)
        for _ in range(num_downs - 5):
            block = UnetSkipBlock(ngf * 8, ngf * 8, submodule=block)
        block = UnetSkipBlock(ngf * 4, ngf * 8, submodule=block)
        block = UnetSkipBlock(ngf * 2, ngf * 4, submodule=block)
        block = UnetSkipBlock(ngf, ngf * 2, submodule=block)
        self.model = UnetSkipBlock(1, ngf, input_nc=2, submodule=block,
                                   outermost=True)

    def forward(self, x):
        return self.model(x)


def minmax_normalize(x: torch.Tensor) -> torch.Tensor:
    """Each (S, S) map of x (..., S, S) min-max to [0, 1], then to
    [-1, 1] (pix2pix4depth_model.py)."""
    lo = x.amin((-2, -1), keepdim=True)
    hi = x.amax((-2, -1), keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=1e-12) * 2.0 - 1.0


def merge_depths(net: nn.Module, outer: torch.Tensor,
                 inner: torch.Tensor) -> torch.Tensor:
    """The merge net on N pairs of (S, S) estimates, (N, S, S) each: each
    map normalised on its own, the generator, its tanh mapped back to
    [0, 1] → (N, S, S)."""
    x = torch.stack([minmax_normalize(outer), minmax_normalize(inner)], 1)
    return (net(x)[:, 0] + 1.0) / 2.0
