"""Ken Burns pipeline state (port of
``cartoonsegmentation_tpu/pipeline/state.py``): a fixed-capacity point
cloud with invalid slots encoded as z = 0 points, which the splat
drops, grown by masked stream compaction (K10: ``append_masked_plain``
on the CPU, ``csrc/compact.cu`` on CUDA). ``append_masked`` returns a
new cloud, as in JAX; ``append_masked_`` appends in place where the
caller owns the cloud (the pipeline's clip makes one copy).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

import torch

from ..instances import Instances
from ..ops import _cuda
from ..ops.camera import DepthRange


@dataclass
class PointCloud:
    """Fixed-capacity point store; payload = BGR colour + disparity +
    depth."""
    points: torch.Tensor     # (P, 3) xyz; invalid slots have z = 0
    colors: torch.Tensor     # (P, 3)
    disparity: torch.Tensor  # (P,)
    depth: torch.Tensor      # (P,)
    count: torch.Tensor      # () int32 — number of live slots

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @staticmethod
    def with_capacity(capacity: int, device=None) -> 'PointCloud':
        return PointCloud(
            points=torch.zeros((capacity, 3), device=device),
            colors=torch.zeros((capacity, 3), device=device),
            disparity=torch.zeros((capacity,), device=device),
            depth=torch.zeros((capacity,), device=device),
            count=torch.zeros((), dtype=torch.int32, device=device))

    def shrink_to(self, capacity: int) -> 'PointCloud':
        """Slice to a smaller capacity (live slots are a prefix)."""
        capacity = min(capacity, self.capacity)
        return PointCloud(
            points=self.points[:capacity].contiguous(),
            colors=self.colors[:capacity].contiguous(),
            disparity=self.disparity[:capacity].contiguous(),
            depth=self.depth[:capacity].contiguous(),
            count=self.count.clamp(max=capacity))

    def clone(self) -> 'PointCloud':
        return PointCloud(*(getattr(self, k).clone() for k in (
            'points', 'colors', 'disparity', 'depth', 'count')))

    def append_masked(self, points, colors, disparity, depth, mask
                      ) -> 'PointCloud':
        """K10: a new cloud with the entries where ``mask`` is True
        appended, compacted in index order, dropping overflow beyond
        capacity. Flat (M, ...) arguments. This cloud is left as it was,
        as in the JAX version: its buffers are copied on the device and
        the copy is appended to, with no host sync."""
        out = self.clone()
        out.append_masked_(points, colors, disparity, depth, mask)
        return out

    def append_masked_(self, points, colors, disparity, depth, mask
                       ) -> 'PointCloud':
        """``append_masked`` into this cloud's own buffers (no copy), for
        a caller that owns the cloud; returns it."""
        append_masked_into(self, points, colors, disparity, depth, mask)
        return self


def append_masked_into(cloud: PointCloud, points, colors, disparity, depth,
                       mask) -> None:
    """K10 in place: the plain version on the CPU, csrc/compact.cu on
    CUDA."""
    if cloud.points.device.type == 'cpu':
        append_masked_plain(cloud, points, colors, disparity, depth, mask)
    else:
        _append_masked_kernel(cloud, points, colors, disparity, depth, mask)


def append_masked_plain(cloud: PointCloud, points, colors, disparity, depth,
                        mask) -> None:
    """K10's plain version, in place: slot count + rank of each set
    entry, kept below the capacity; count + set entries, clamped. The
    boolean index syncs the host on CUDA."""
    P = cloud.capacity
    m = mask.to(torch.int64)
    pos = cloud.count.to(torch.int64) + torch.cumsum(m, 0) - 1
    ok = (m > 0) & (pos < P)
    idx = pos[ok]
    for dst, src in ((cloud.points, points), (cloud.colors, colors),
                     (cloud.disparity, disparity), (cloud.depth, depth)):
        dst.index_copy_(0, idx, src[ok].to(dst.dtype))
    cloud.count.copy_((cloud.count + m.sum()).clamp(max=P))


def _append_masked_kernel(cloud: PointCloud, points, colors, disparity,
                          depth, mask) -> None:
    dev = cloud.points.device
    # colors are read at their strides, with no copy: the inpaint net's
    # image reaches the clip's appends channel-planar
    points, disparity = points.contiguous(), disparity.contiguous()
    depth, mask = depth.contiguous(), mask.contiguous()
    M = mask.shape[0]
    for name, t, nd in (('points', points, 2), ('disparity', disparity, 1),
                        ('depth', depth, 1)):
        _cuda.check(t, name, torch.float32, nd, dev)
        if t.shape[0] != M or (nd == 2 and t.shape[1] != 3):
            raise ValueError(f'{name} {tuple(t.shape)} does not fit a '
                             f'mask of {M}')
    if colors.device != dev:
        raise ValueError(f'colors is on {colors.device}, expected {dev}')
    if colors.dtype != torch.float32:
        raise TypeError(f'colors has dtype {colors.dtype}, expected '
                        f'torch.float32')
    if tuple(colors.shape) != (M, 3):
        raise ValueError(f'colors {tuple(colors.shape)} does not fit a mask '
                         f'of {M}')
    _cuda.check(mask, 'mask', torch.bool, 1, dev)
    for name in ('points', 'colors', 'disparity', 'depth'):
        _cuda.check(getattr(cloud, name), f'cloud.{name}', torch.float32,
                    2 if name in ('points', 'colors') else 1, dev)
    _cuda.check(cloud.count, 'cloud.count', torch.int32, 0, dev)
    scratch = _compact_scratch(dev, M)
    _cuda.launch('compact',
                 points.data_ptr(), colors.data_ptr(), disparity.data_ptr(),
                 depth.data_ptr(), mask.data_ptr(), M, colors.stride(0),
                 colors.stride(1), cloud.points.data_ptr(),
                 cloud.colors.data_ptr(), cloud.disparity.data_ptr(),
                 cloud.depth.data_ptr(),
                 cloud.capacity, cloud.count.data_ptr(), scratch.data_ptr(),
                 _cuda.stream_ptr(mask))


# csrc/compact.cu's entries a tile
COMPACT_TILE = 2048

# K10's scratch a card, by device index
_scratch: Dict[int, torch.Tensor] = {}


def _compact_scratch(dev: torch.device, M: int) -> torch.Tensor:
    """csrc/compact.cu's scratch on ``dev`` for M entries (int64): the
    slot word, two slots of a tile counter and a status word a tile of
    COMPACT_TILE entries. Zero when made; each call zeroes the slot the
    call before it used and hands it to the next, so one buffer serves
    every call on the card, made (or grown, zero again) by the first
    call that needs it; calls that overlap on two streams would share
    it, and the port makes them on one."""
    n = 5 + 2 * -(-M // COMPACT_TILE)
    buf = _scratch.get(dev.index)
    if buf is None or buf.numel() < n:
        buf = _scratch[dev.index] = torch.zeros(n, dtype=torch.int64,
                                                device=dev)
    return buf


@dataclass
class KenBurnsState:
    """Everything the render loop needs, on the pipeline's device."""
    image: torch.Tensor       # (H, W, 3) BGR float32 in [0, 1]
    disparity: torch.Tensor   # (H, W, 1) normalised to baseline
    depth: torch.Tensor       # (H, W, 1)
    raw_points: torch.Tensor  # (H*W, 3) validity-masked unprojection
    depth_min: torch.Tensor   # () DepthRange pieces
    depth_min_u: torch.Tensor
    depth_min_v: torch.Tensor
    cloud: PointCloud
    instances: Instances

    @property
    def hw(self):
        return self.image.shape[0], self.image.shape[1]

    @property
    def depth_range(self) -> DepthRange:
        return DepthRange(self.depth_min, self.depth_min_u,
                          self.depth_min_v)

    def replace(self, **kw) -> 'KenBurnsState':
        return replace(self, **kw)

    def to(self, device) -> 'KenBurnsState':
        kw = {k: getattr(self, k).to(device) for k in (
            'image', 'disparity', 'depth', 'raw_points', 'depth_min',
            'depth_min_u', 'depth_min_v', 'instances')}
        kw['cloud'] = PointCloud(**{
            k: getattr(self.cloud, k).to(device) for k in (
                'points', 'colors', 'disparity', 'depth', 'count')})
        return replace(self, **kw)
