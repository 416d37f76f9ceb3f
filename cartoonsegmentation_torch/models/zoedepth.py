"""ZoeDepth metric depth on the DPT-BEiT core (port of
``cartoonsegmentation_tpu/models/zoedepth.py``): the seed bin regressor,
an attractor layer a decoder level, the conditional log-binomial over
the bin centres (64 softplus bins, inverse attractors (16, 8, 4, 1),
temperatures 0.0212..50), and ZoeDepthNK's two heads behind a learned
nyu/kitti router. Tensors are NCHW; the input is RGB in [0, 1] and the
MiDaS normalisation (mean and std 0.5) happens inside.

Parameter names follow ZoeD_M12_N.pt / ZoeD_M12_NK.pt, so
``load_zoe_state_dict`` loads them with one transform: each block's
relative position bias table resized from the checkpoint's grid to the
model's (``resize_rel_pos_table``). ``infer_zoe`` is the reference's
inference: reflect padding, the cubic resize to the model grid and
back, the crop, the flip average.
"""
from __future__ import annotations

import functools
import math
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.image import resize_cubic, resize_cubic_nchw
from .beit import table_rows
from .dpt import DPTBeit


def _resize_ac(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode='bilinear', align_corners=True)


class MLP2(nn.Module):
    """Conv1x1 → ReLU → Conv1x1 as ``_net`` (the checkpoint's
    SeedBinRegressor / Projector / Attractor layout)."""

    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self._net = nn.Sequential(nn.Conv2d(cin, mid, 1), nn.ReLU(),
                                  nn.Conv2d(mid, cout, 1))

    def forward(self, x):
        return self._net(x)


def attract(net: MLP2, x, b_prev, prev_emb):
    """AttractorLayerUnnormed of the shipped configs (inverse attractors,
    their mean): the previous embedding resized onto x and added,
    softplus attractors, the bin centres moved by dx / (1 + 300 dx²).
    The reference calls its attractor function without arguments, so
    alpha 300 and gamma 2 hold whatever the config says."""
    h, w = x.shape[-2:]
    A = F.softplus(net(x + _resize_ac(prev_emb, h, w)))   # (B, nA, H, W)
    b_prev = _resize_ac(b_prev, h, w)                      # (B, nb, H, W)
    dx = A[:, :, None] - b_prev[:, None]
    return b_prev + (dx / (1 + 300.0 * dx ** 2)).mean(1)


@functools.lru_cache(maxsize=None)
def log_binomial_coef(n_classes: int) -> np.ndarray:
    """The reference's Stirling form n log n - k log k - (n-k) log(n-k)
    with eps 1e-7, built on the host in numpy f32 as the JAX package
    builds it: at k = K-1 the factor (n - k) is an exact 0 that removes
    its log term (a fused device expression makes it 0 · log 0 = NaN)."""
    seps = np.float32(1e-7)
    kf = np.arange(n_classes, dtype=np.float32)
    n = np.float32(n_classes - 1.0) + seps
    ks = kf + seps
    return n * np.log(n) - ks * np.log(ks) - (n - ks) * np.log(n - ks + seps)


def log_binomial(p: torch.Tensor, t: torch.Tensor, n_classes: int,
                 eps: float = 1e-4) -> torch.Tensor:
    """softmax over k of (log C(K-1, k) + k log p + (K-1-k) log(1-p)) / t,
    p and t (B, 1, H, W) → (B, K, H, W), in f32 (the JAX package's f32
    coefficient table promotes a bf16 p)."""
    dev = p.device
    p, t = p.float(), t.float()
    coef = torch.from_numpy(log_binomial_coef(n_classes)).to(dev)
    k = torch.arange(n_classes, dtype=torch.float32, device=dev)
    view = (1, n_classes, 1, 1)
    pc = p.clamp(eps, 1.0)
    omp = (1.0 - p).clamp(eps, 1.0)
    y = coef.view(view) + k.view(view) * torch.log(pc) \
        + (n_classes - 1 - k).view(view) * torch.log(omp)
    return torch.softmax(y / t, dim=1)


class ConditionalLogBinomial(nn.Module):

    min_temp, max_temp, p_eps = 0.0212, 50.0, 1e-4

    def __init__(self, cin: int, n_classes: int = 64,
                 bottleneck_factor: int = 2):
        super().__init__()
        self.n_classes = n_classes
        mid = cin // bottleneck_factor
        self.mlp = nn.Sequential(nn.Conv2d(cin, mid, 1), nn.GELU(),
                                 nn.Conv2d(mid, 4, 1))

    def forward(self, x, cond):
        pt = F.softplus(self.mlp(torch.cat([x, cond], 1))) + self.p_eps
        p = pt[:, 0:1] / (pt[:, 0:1] + pt[:, 1:2])
        t = pt[:, 2:3] / (pt[:, 2:3] + pt[:, 3:4])
        t = (self.max_temp - self.min_temp) * t + self.min_temp
        return log_binomial(p, t, self.n_classes)


def _bins(probs, centers):
    """Σ_k probs · centers (the centres resized onto probs' grid)."""
    centers = _resize_ac(centers, probs.shape[2], probs.shape[3])
    return (probs * centers.float()).sum(1, keepdim=True)


class _ZoeBase(nn.Module):
    """The shared DPT-BEiT core, under the checkpoint's ``core.core``,
    and the bottleneck conv."""

    def __init__(self, img_size, core_features, core_out_channels, core_dim,
                 core_depth, core_heads, core_hooks, btlnck_features):
        super().__init__()
        self.img_size = tuple(img_size)
        self.core = nn.Module()
        self.core.core = DPTBeit(img_size=img_size, features=core_features,
                                 out_channels=core_out_channels, dim=core_dim,
                                 depth=core_depth, num_heads=core_heads,
                                 hooks=core_hooks)
        self.conv2 = nn.Conv2d(core_features, btlnck_features, 1)

    @staticmethod
    def _chain(attractors, b_prev, prev_emb, embs):
        """The attractor layers over the decoder levels → (the last
        bin centres, the last embedding)."""
        for net, emb in zip(attractors, embs):
            b_prev, prev_emb = attract(net, emb, b_prev, prev_emb), emb
        return b_prev, prev_emb


class ZoeDepth(_ZoeBase):
    """ZoeD_M12_N: (B, 3, H, W) RGB in [0, 1] at ``img_size`` →
    {'metric_depth': (B, 1, H, W), 'rel_depth': (B, H, W)}. The geometry
    defaults to the shipped model; the tests shrink it."""

    def __init__(self, img_size: Tuple[int, int] = (384, 512),
                 n_bins: int = 64, bin_embedding_dim: int = 128,
                 n_attractors: Sequence[int] = (16, 8, 4, 1),
                 core_features: int = 256,
                 core_out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 core_dim: int = 1024, core_depth: int = 24,
                 core_heads: int = 16,
                 core_hooks: Sequence[int] = (5, 11, 17, 23),
                 btlnck_features: int = 256):
        super().__init__(img_size, core_features, core_out_channels,
                         core_dim, core_depth, core_heads, core_hooks,
                         btlnck_features)
        bed = bin_embedding_dim
        self.seed_bin_regressor = MLP2(btlnck_features, 256, n_bins)
        self.seed_projector = MLP2(btlnck_features, 128, bed)
        self.projectors = nn.ModuleList(
            [MLP2(core_features, 128, bed) for _ in range(4)])
        self.attractors = nn.ModuleList(
            [MLP2(bed, 128, n) for n in n_attractors])
        self.conditional_log_binomial = ConditionalLogBinomial(32 + 1 + bed,
                                                               n_bins)

    def forward(self, rgb01):
        rel, hooks = self.core.core((rgb01 - 0.5) / 0.5)
        btl = self.conv2(hooks['l4_rn'])
        b_prev = F.softplus(self.seed_bin_regressor(btl))
        embs = [self.projectors[i](hooks[k])
                for i, k in enumerate(('r4', 'r3', 'r2', 'r1'))]
        b_centers, prev_emb = self._chain(self.attractors, b_prev,
                                          self.seed_projector(btl), embs)
        last = hooks['out_conv']
        h, w = last.shape[-2:]
        last = torch.cat([last, _resize_ac(rel[:, None], h, w)], 1)
        probs = self.conditional_log_binomial(last,
                                              _resize_ac(prev_emb, h, w))
        return {'metric_depth': _bins(probs, b_centers), 'rel_depth': rel}


class PatchTransformerEncoder(nn.Module):
    """The NK router's encoder: a 1x1 patch embedding, a zero class token
    first, the fixed sinusoidal position code (the sin block, then the
    cos block), post-LN torch transformer layers under the checkpoint's
    ``transformer_encoder.layers.N`` (LayerNorm eps 1e-6, the JAX
    package's Flax default)."""

    def __init__(self, in_channels: int, embedding_dim: int = 128,
                 num_heads: int = 4, num_layers: int = 4, ff_dim: int = 1024):
        super().__init__()
        self.embedding_convPxP = nn.Conv2d(in_channels, embedding_dim, 1)
        self.transformer_encoder = nn.Module()
        self.transformer_encoder.layers = nn.ModuleList([
            nn.TransformerEncoderLayer(embedding_dim, num_heads, ff_dim,
                                       dropout=0.0, batch_first=True,
                                       layer_norm_eps=1e-6)
            for _ in range(num_layers)])

    def forward(self, x):                                 # → (B, S, E)
        emb = self.embedding_convPxP(x).flatten(2).transpose(1, 2)
        B, _, E = emb.shape
        emb = torch.cat([emb.new_zeros(B, 1, E), emb], 1)
        S = emb.shape[1]
        dev = emb.device
        pos = torch.arange(S, dtype=torch.float32, device=dev)[:, None]
        idx = torch.arange(0, E, 2, dtype=torch.float32, device=dev)[None]
        step = -torch.log(torch.tensor(10000.0, device=dev)) / E
        ang = pos * torch.exp(idx * step)
        emb = emb + torch.cat([torch.sin(ang), torch.cos(ang)], 1)[None].to(
            emb.dtype)
        for layer in self.transformer_encoder.layers:
            emb = layer(emb)
        return emb


# the domains of the shipped NK checkpoint (config_zoedepth_nk.json):
# (name, bins, min depth, max depth)
NK_BIN_CONF = (('nyu', 64, 1e-3, 10.0), ('kitti', 64, 1e-3, 80.0))


class ZoeDepthNK(_ZoeBase):
    """ZoeD_M12_NK: the shared DPT core and embedding chain, a router
    voting nyu or kitti over the batch, and a metric head a domain. Both
    heads run and ``torch.where`` takes the winner, as the JAX package
    does (no host sync on the vote). Output as ZoeDepth's plus
    'domain_logits' (B, 2)."""

    def __init__(self, img_size: Tuple[int, int] = (384, 512),
                 bin_conf=NK_BIN_CONF, bin_embedding_dim: int = 128,
                 n_attractors: Sequence[int] = (16, 8, 4, 1),
                 core_features: int = 256,
                 core_out_channels: Sequence[int] = (256, 512, 1024, 1024),
                 core_dim: int = 1024, core_depth: int = 24,
                 core_heads: int = 16,
                 core_hooks: Sequence[int] = (5, 11, 17, 23),
                 btlnck_features: int = 256):
        super().__init__(img_size, core_features, core_out_channels,
                         core_dim, core_depth, core_heads, core_hooks,
                         btlnck_features)
        bed = bin_embedding_dim
        mid = bed // 2
        self.domains = tuple(c[0] for c in bin_conf)
        self.patch_transformer = PatchTransformerEncoder(btlnck_features)
        self.mlp_classifier = nn.Sequential(nn.Linear(128, 128), nn.ReLU(),
                                            nn.Linear(128, 2))
        self.seed_projector = MLP2(btlnck_features, mid, bed)
        self.projectors = nn.ModuleList(
            [MLP2(core_features, mid, bed) for _ in range(4)])
        self.seed_bin_regressors = nn.ModuleDict(
            {name: MLP2(btlnck_features, mid, n) for name, n, _, _ in bin_conf})
        self.attractors = nn.ModuleDict(
            {name: nn.ModuleList([MLP2(bed, bed, a) for a in n_attractors])
             for name, _, _, _ in bin_conf})
        self.conditional_log_binomial = nn.ModuleDict(
            {name: ConditionalLogBinomial(32 + bed, n, bottleneck_factor=4)
             for name, n, _, _ in bin_conf})

    def forward(self, rgb01):
        rel, hooks = self.core.core((rgb01 - 0.5) / 0.5)
        btl = self.conv2(hooks['l4_rn'])
        seq = self.patch_transformer(btl)
        logits = self.mlp_classifier(seq[:, 0])
        vote = torch.softmax(logits.float().sum(0), -1)
        is_kitti = vote[1] > vote[0]
        prev0 = self.seed_projector(btl)
        embs = [self.projectors[i](hooks[k])
                for i, k in enumerate(('r4', 'r3', 'r2', 'r1'))]
        last = hooks['out_conv']
        h, w = last.shape[-2:]
        depths = []
        for name in self.domains:
            b_prev = F.softplus(self.seed_bin_regressors[name](btl))
            b_centers, prev_emb = self._chain(self.attractors[name],
                                              b_prev, prev0, embs)
            probs = self.conditional_log_binomial[name](
                last, _resize_ac(prev_emb, h, w))
            depths.append(_bins(probs, b_centers))
        return {'metric_depth': torch.where(is_kitti, depths[1], depths[0]),
                'rel_depth': rel, 'domain_logits': logits}


def pad_tta_amounts(h: int, w: int, fh: float = 3.0,
                    fw: float = 3.0) -> Tuple[int, int]:
    """The reference's reflect pad: int(sqrt(h/2)·3), int(sqrt(w/2)·3)."""
    return int(math.sqrt(h / 2) * fh), int(math.sqrt(w / 2) * fw)


def _infer_pad_aug(net: nn.Module, x: torch.Tensor, pad_input: bool,
                   dtype: torch.dtype) -> torch.Tensor:
    """One forward: reflect pad, the cubic resize to the model grid, the
    net (in ``dtype``), the prediction resized back to the padded size in
    f32 and cropped. (B, 3, H, W) → (B, 1, H, W)."""
    ph = pw = 0
    if pad_input:
        ph, pw = pad_tta_amounts(*x.shape[-2:])
        x = F.pad(x, (pw, pw, ph, ph), mode='reflect')
    PH, PW = x.shape[-2:]
    mh, mw = net.img_size
    if (PH, PW) != (mh, mw):
        x = resize_cubic_nchw(x, mh, mw)
    out = net(x.to(dtype))['metric_depth'].float()
    if tuple(out.shape[-2:]) != (PH, PW):
        out = resize_cubic_nchw(out, PH, PW)
    return out[..., ph:PH - ph, pw:PW - pw]


def infer_zoe(net: nn.Module, rgb01: torch.Tensor, with_flip_aug: bool = True,
              pad_input: bool = True,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The reference's default inference (depth_model.py:57-128): the
    padded forward, and with ``with_flip_aug`` the mean with the
    flipped image's, flipped back. rgb01 (B, 3, H, W) f32 → metric depth
    (B, 1, H, W) f32."""
    dtype = dtype or rgb01.dtype
    out = _infer_pad_aug(net, rgb01, pad_input, dtype)
    if with_flip_aug:
        out_f = _infer_pad_aug(net, rgb01.flip(-1), pad_input, dtype)
        out = 0.5 * (out + out_f.flip(-1))
    return out


def resize_rel_pos_table(table: torch.Tensor, src: Tuple[int, int],
                         dst: Tuple[int, int]) -> torch.Tensor:
    """A (rows(src), heads) bias table → (rows(dst), heads): the
    (2h-1) x (2w-1) lattice resized with the cubic of
    ``jax.image.resize``, the three cls rows kept."""
    sh, sw = 2 * src[0] - 1, 2 * src[1] - 1
    dh, dw = 2 * dst[0] - 1, 2 * dst[1] - 1
    if (sh, sw) == (dh, dw):
        return table
    heads = table.shape[1]
    body = table[:sh * sw].float().reshape(sh, sw, heads)
    body = resize_cubic(body, dh, dw).reshape(-1, heads)
    return torch.cat([body.to(table.dtype), table[sh * sw:]], 0)


def load_zoe_state_dict(net: nn.Module, sd: Mapping) -> None:
    """Load a ZoeDepth / ZoeDepthNK state dict (``module.`` prefixes
    dropped, keys the net lacks ignored) into ``net``, each block's bias
    table resized from its square training grid to the net's grid.
    Raises on a key of the net that the state dict lacks."""
    grid = net.core.core.pretrained.model.grid
    own = net.state_dict()
    out = {}
    for k, v in sd.items():
        k = k[len('module.'):] if k.startswith('module.') else k
        if k not in own:
            continue
        v = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        if k.endswith('attn.relative_position_bias_table') and \
                v.shape[0] != table_rows(grid):
            src = int(round((math.sqrt(v.shape[0] - 3) + 1) / 2))
            v = resize_rel_pos_table(v, (src, src), grid)
        out[k] = v
    missing = sorted(set(own) - set(out))
    if missing:
        raise KeyError(f'the state dict lacks {len(missing)} keys of '
                       f'{type(net).__name__}, e.g. {missing[:3]}')
    net.load_state_dict(out)
