"""Latent-diffusion building blocks (port of
``cartoonsegmentation_tpu/models/ldm.py``): the Stable-Diffusion UNet,
the SD VAE and the DDIM and LCM samplers that Marigold depth
(``models/marigold.py``) and latent-diffusion inpainting
(``models/ldm_inpaint.py``) run on.

Tensors are NCHW. Module trees keep diffusers' key names
(``down_blocks.{i}.resnets.{j}``, ``.attentions.{j}.transformer_blocks.{k}``,
``downsamplers.0.conv``, ``mid_block``, ``up_blocks.{k}`` deepest first,
``to_out.0``, ``ff.net.0.proj``, ``ff.net.2``; ``encoder.*``,
``decoder.*``, ``quant_conv``, ``post_quant_conv``), so a diffusers
``unet/`` or ``vae/`` state dict loads by ``load_state_dict``.
Attention runs through ``scaled_dot_product_attention``.

The samplers' tables are host numpy, built as the JAX package builds
them; a step is a few element-wise torch ops on the sample's device.
``init_random_`` draws a module's weights from a seeded generator on
the module's own device (Flax's default initialisers: kernels at
1/sqrt(fan-in), biases 0, norm scales 1).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding, diffusers get_timestep_embedding with
    flip_sin_to_cos=True, downscale_freq_shift=0: [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([args.cos(), args.sin()], -1)


class TimeEmbedding(nn.Module):
    """linear_1 → SiLU → linear_2 (diffusers TimestepEmbedding)."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock2D(nn.Module):
    """GN→SiLU→conv + time-proj → GN→SiLU→conv, ``conv_shortcut`` only
    where the channel count changes (diffusers ResnetBlock2D)."""

    def __init__(self, cin: int, cout: int, temb_ch: Optional[int] = None,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, 1, 1)
        if temb_ch:
            self.time_emb_proj = nn.Linear(temb_ch, cout)
        self.norm2 = nn.GroupNorm(32, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1)
        if cin != cout:
            self.conv_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, 'conv_shortcut'):
            x = self.conv_shortcut(x)
        return x + h


def _attention(q, k, v, heads: int):
    """(B, Nq, C) x (B, Nk, C) multi-head softmax attention."""
    B, Nq, C = q.shape
    d = C // heads
    q, k, v = (t.reshape(B, -1, heads, d).transpose(1, 2) for t in (q, k, v))
    out = F.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).reshape(B, Nq, C)


class CrossAttention(nn.Module):
    """to_q/to_k/to_v without bias + to_out.0 (diffusers Attention)."""

    def __init__(self, ch: int, heads: int, ctx_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(ch, ch, bias=False)
        self.to_k = nn.Linear(ctx_dim or ch, ch, bias=False)
        self.to_v = nn.Linear(ctx_dim or ch, ch, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        out = _attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx),
                         self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward with exact GELU: net.0 = GEGLU, net.2 = Linear
    (net.1, diffusers' dropout, holds nothing)."""

    def __init__(self, ch: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(ch, ch * mult), nn.Identity(),
                                  nn.Linear(ch * mult, ch)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """LN→self-attn, LN→cross-attn, LN→GEGLU feed-forward, all residual."""

    def __init__(self, ch: int, heads: int, ctx_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(ch)
        self.attn1 = CrossAttention(ch, heads)
        self.norm2 = nn.LayerNorm(ch)
        self.attn2 = CrossAttention(ch, heads, ctx_dim)
        self.norm3 = nn.LayerNorm(ch)
        self.ff = FeedForward(ch)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN → proj_in → transformer blocks → proj_out, residual (diffusers
    Transformer2DModel). ``linear_proj=True`` is SD2's Linear projections
    on the tokens; False is SD1.5's 1x1 convs, applied before the tokens
    are formed and after they are unformed."""

    def __init__(self, ch: int, heads: int, ctx_dim: int, depth: int = 1,
                 linear_proj: bool = True):
        super().__init__()
        self.linear_proj = linear_proj
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        proj = (lambda: nn.Linear(ch, ch)) if linear_proj else \
            (lambda: nn.Conv2d(ch, ch, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, heads, ctx_dim) for _ in range(depth)])
        self.proj_out = proj()

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.norm(x)
        if not self.linear_proj:
            h = self.proj_in(h)
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        if self.linear_proj:
            h = self.proj_in(h)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        if self.linear_proj:
            h = self.proj_out(h)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        if not self.linear_proj:
            h = self.proj_out(h)
        return h + x


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv; the VAE's pads (0, 1, 0, 1) first and convolves
    without padding (diffusers Downsample2D(padding=0))."""

    def __init__(self, ch: int, vae_pad: bool = False):
        super().__init__()
        self.vae_pad = vae_pad
        self.conv = nn.Conv2d(ch, ch, 3, 2, 0 if vae_pad else 1)

    def forward(self, x):
        if self.vae_pad:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2, then a 3x3 conv (diffusers Upsample2D)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, 1, 1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode='nearest'))


class _Block(nn.Module):
    """A diffusers down, mid or up block: ``resnets``, and where given
    ``attentions`` (one after each resnet) and a resampler."""

    def __init__(self, resnets, attentions=None, downsample=None,
                 upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions is not None:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNet2DCondition(nn.Module):
    """The SD conditional UNet (diffusers UNet2DConditionModel).

    Defaults are Stable Diffusion 2's (Marigold's, which widens conv_in
    to 8 input channels, rgb latent ‖ depth latent): 4 levels
    (320/640/1280/1280), 2 resnets a level, heads (5, 10, 20, 20) (head
    width 64), cross-attention on the first three levels, Linear
    projections, context width 1024. ``forward(x (B, in_ch, h, w),
    t (B,) timesteps, context (B, L, context_dim))``."""

    def __init__(self, in_ch: int = 4, out_ch: int = 4,
                 block_out: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2,
                 heads: Sequence[int] = (5, 10, 20, 20),
                 cross_attn: Sequence[bool] = (True, True, True, False),
                 linear_proj: bool = True, context_dim: int = 1024):
        super().__init__()
        self.block_out = tuple(block_out)
        self.layers_per_block = layers_per_block
        self.cross_attn = tuple(cross_attn)
        n, lpb = len(block_out), layers_per_block
        temb = block_out[0] * 4

        def tr(c, i):
            return Transformer2D(c, heads[i], context_dim,
                                 linear_proj=linear_proj)

        self.conv_in = nn.Conv2d(in_ch, block_out[0], 3, 1, 1)
        self.time_embedding = TimeEmbedding(block_out[0], temb)
        skips = [block_out[0]]
        self.down_blocks = nn.ModuleList()
        ch = block_out[0]
        for i, c in enumerate(block_out):
            res = [ResnetBlock2D(ch if j == 0 else c, c, temb)
                   for j in range(lpb)]
            att = [tr(c, i) for _ in range(lpb)] if cross_attn[i] else None
            down = Downsample2D(c) if i < n - 1 else None
            self.down_blocks.append(_Block(res, att, downsample=down))
            skips += [c] * lpb + ([c] if down is not None else [])
            ch = c
        self.mid_block = _Block(
            [ResnetBlock2D(ch, ch, temb), ResnetBlock2D(ch, ch, temb)],
            [tr(ch, n - 1)])
        self.up_blocks = nn.ModuleList()
        for i in reversed(range(n)):
            c = block_out[i]
            res = []
            for _ in range(lpb + 1):
                res.append(ResnetBlock2D(ch + skips.pop(), c, temb))
                ch = c
            att = [tr(c, i) for _ in range(lpb + 1)] if cross_attn[i] \
                else None
            up = Upsample2D(c) if i > 0 else None
            self.up_blocks.append(_Block(res, att, upsample=up))
        self.conv_norm_out = nn.GroupNorm(32, block_out[0], eps=1e-5)
        self.conv_out = nn.Conv2d(block_out[0], out_ch, 3, 1, 1)

    def forward(self, x, t, context):
        temb = self.time_embedding(timestep_embedding(t, self.block_out[0]))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, r in enumerate(blk.resnets):
                h = r(h, temb)
                if hasattr(blk, 'attentions'):
                    h = blk.attentions[j](h, context)
                skips.append(h)
            if hasattr(blk, 'downsamplers'):
                h = blk.downsamplers[0](h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, context)
        h = mid.resnets[1](h, temb)
        for blk in self.up_blocks:
            for j, r in enumerate(blk.resnets):
                h = r(torch.cat([h, skips.pop()], 1), temb)
                if hasattr(blk, 'attentions'):
                    h = blk.attentions[j](h, context)
            if hasattr(blk, 'upsamplers'):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAEAttention(nn.Module):
    """Single-head self-attention over the (H, W) tokens, with biases
    (the VAE mid block's)."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        out = _attention(self.to_q(h), self.to_k(h), self.to_v(h), 1)
        out = self.to_out[0](out)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _vae_mid(ch: int) -> _Block:
    return _Block([ResnetBlock2D(ch, ch, eps=1e-6),
                   ResnetBlock2D(ch, ch, eps=1e-6)], [VAEAttention(ch)])


def _run_mid(mid: _Block, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class AutoencoderEncoder(nn.Module):
    """The SD VAE's encoder (diffusers Encoder), up to its conv_out."""

    def __init__(self, block_out: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_ch: int = 4,
                 in_ch: int = 3):
        super().__init__()
        n = len(block_out)
        self.conv_in = nn.Conv2d(in_ch, block_out[0], 3, 1, 1)
        self.down_blocks = nn.ModuleList()
        ch = block_out[0]
        for i, c in enumerate(block_out):
            res = [ResnetBlock2D(ch if j == 0 else c, c, eps=1e-6)
                   for j in range(layers_per_block)]
            down = Downsample2D(c, vae_pad=True) if i < n - 1 else None
            self.down_blocks.append(_Block(res, downsample=down))
            ch = c
        self.mid_block = _vae_mid(ch)
        self.conv_norm_out = nn.GroupNorm(32, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * latent_ch, 3, 1, 1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, 'downsamplers'):
                h = blk.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderDecoder(nn.Module):
    """The SD VAE's decoder (diffusers Decoder), from its conv_in."""

    def __init__(self, block_out: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_ch: int = 4,
                 out_ch: int = 3):
        super().__init__()
        n = len(block_out)
        ch = block_out[-1]
        self.conv_in = nn.Conv2d(latent_ch, ch, 3, 1, 1)
        self.mid_block = _vae_mid(ch)
        self.up_blocks = nn.ModuleList()
        for k, c in enumerate(reversed(block_out)):
            res = [ResnetBlock2D(ch if j == 0 else c, c, eps=1e-6)
                   for j in range(layers_per_block + 1)]
            up = Upsample2D(c) if k < n - 1 else None
            self.up_blocks.append(_Block(res, upsample=up))
            ch = c
        self.conv_norm_out = nn.GroupNorm(32, block_out[0], eps=1e-6)
        self.conv_out = nn.Conv2d(block_out[0], out_ch, 3, 1, 1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for r in blk.resnets:
                h = r(h)
            if hasattr(blk, 'upsamplers'):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """The SD VAE (diffusers AutoencoderKL): ``encode`` → (mean, logvar)
    through quant_conv, ``decode`` through post_quant_conv."""

    def __init__(self, block_out: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_ch: int = 4):
        super().__init__()
        self.block_out = tuple(block_out)
        self.encoder = AutoencoderEncoder(block_out, layers_per_block,
                                          latent_ch)
        self.decoder = AutoencoderDecoder(block_out, layers_per_block,
                                          latent_ch)
        self.quant_conv = nn.Conv2d(2 * latent_ch, 2 * latent_ch, 1)
        self.post_quant_conv = nn.Conv2d(latent_ch, latent_ch, 1)

    @property
    def scale(self) -> int:
        """The spatial factor between image and latent (8 for SD's)."""
        return 2 ** (len(self.block_out) - 1)

    def encode(self, x):
        return self.quant_conv(self.encoder(x)).chunk(2, dim=1)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))


def vae_state_dict(sd) -> dict:
    """A diffusers VAE state dict in the port's keys: the legacy
    mid-block attention names (``query``/``key``/``value``/``proj_attn``,
    ``norm``) become ``to_q``/``to_k``/``to_v``/``to_out.0``,
    ``group_norm``, and their 1x1-conv weights Linear ones (the JAX
    package's ``_vae_attn``)."""
    legacy = {'query': 'to_q', 'key': 'to_k', 'value': 'to_v',
              'proj_attn': 'to_out.0', 'norm': 'group_norm'}
    out = {}
    for k, v in sd.items():
        head, _, tail = k.partition('.attentions.0.')
        if tail:
            name, _, leaf = tail.rpartition('.')
            name = legacy.get(name, name)
            if v.ndim == 4:
                v = v[:, :, 0, 0]
            k = f'{head}.attentions.0.{name}.{leaf}'
        out[k] = v
    return out


def fit_proj_weights(sd, module: nn.Module) -> dict:
    """``sd`` with each Transformer2D projection weight in the shape the
    module has: Linear weights or 1x1-conv weights are taken for either
    (the JAX package's ``_proj``)."""
    own = module.state_dict()
    out = dict(sd)
    for k, v in sd.items():
        if ('.proj_in.' in k or '.proj_out.' in k) and k in own \
                and v.ndim != own[k].ndim:
            out[k] = v.reshape(own[k].shape)
    return out


@torch.no_grad()
def init_random_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Draw ``module``'s weights in place from ``gen`` (on the module's
    device), in the order of ``modules()``: Conv2d and Linear weights
    normal at 1/sqrt(fan-in), their biases 0; GroupNorm and LayerNorm
    scales 1, biases 0 (Flax's defaults, as the JAX package's random
    init); Embedding tables normal at 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=gen)
    return module


# -- schedulers ---------------------------------------------------------

def make_alphas_cumprod(num_train_timesteps: int = 1000,
                        beta_start: float = 0.00085,
                        beta_end: float = 0.012) -> np.ndarray:
    """scaled_linear beta schedule (the SD/Marigold configuration)."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def spaced_timesteps(num_steps: int, num_train: int = 1000,
                     spacing: str = 'trailing',
                     steps_offset: int = 0) -> np.ndarray:
    """Descending inference timesteps (diffusers set_timesteps);
    ``steps_offset`` shifts 'leading' spacing up (SD1.x ships 1)."""
    if spacing == 'trailing':
        ts = np.round(np.arange(num_train, 0,
                                -num_train / num_steps)).astype(int) - 1
    else:  # leading
        step = num_train // num_steps
        ts = (np.arange(num_steps) * step).round().astype(int)[::-1]
        ts = np.minimum(ts + steps_offset, num_train - 1)
    return ts.astype(np.int32)


def _x0(prediction_type: str, model_out, sample, sq_at, sq_1mat):
    if prediction_type == 'v':
        return sq_at * sample - sq_1mat * model_out
    return (sample - sq_1mat * model_out) / sq_at


class DDIMScheduler:
    """Deterministic DDIM (eta = 0), epsilon or v prediction; the final
    step jumps to alpha 1, or to alpha_cumprod[0] with
    ``set_alpha_to_one=False`` (SD1.x)."""

    def __init__(self, num_steps: int, prediction_type: str = 'v',
                 spacing: str = 'trailing', steps_offset: int = 0,
                 set_alpha_to_one: bool = True):
        self.acp = make_alphas_cumprod()
        self.timesteps = spaced_timesteps(num_steps, spacing=spacing,
                                          steps_offset=steps_offset)
        self.prediction_type = prediction_type
        self.num_steps = num_steps
        self.final_alpha = 1.0 if set_alpha_to_one else float(self.acp[0])

    def step(self, model_out, i: int, sample):
        t = int(self.timesteps[i])
        a_t = float(self.acp[t])
        a_prev = float(self.acp[int(self.timesteps[i + 1])]) \
            if i + 1 < self.num_steps else self.final_alpha
        sq_at, sq_1mat = math.sqrt(a_t), math.sqrt(1.0 - a_t)
        x0 = _x0(self.prediction_type, model_out, sample, sq_at, sq_1mat)
        if self.prediction_type == 'v':
            eps = sq_at * model_out + sq_1mat * sample
        else:
            eps = model_out
        return math.sqrt(a_prev) * x0 + math.sqrt(1.0 - a_prev) * eps


class LCMScheduler:
    """Latent-consistency sampling (marigold-lcm-v1-0, 4 steps): the
    boundary conditions c_skip/c_out at timestep_scaling 10 and
    sigma_data 0.5; between steps the denoised estimate is noised again
    to the next timestep with the given ``noise``."""

    def __init__(self, num_steps: int, prediction_type: str = 'v',
                 timestep_scaling: float = 10.0, sigma_data: float = 0.5):
        self.acp = make_alphas_cumprod()
        self.timesteps = spaced_timesteps(num_steps, spacing='trailing')
        self.prediction_type = prediction_type
        self.num_steps = num_steps
        self.timestep_scaling = timestep_scaling
        self.sigma_data = sigma_data

    def step(self, model_out, i: int, sample, noise=None):
        t = int(self.timesteps[i])
        a_t = float(self.acp[t])
        sq_at, sq_1mat = math.sqrt(a_t), math.sqrt(1.0 - a_t)
        x0 = _x0(self.prediction_type, model_out, sample, sq_at, sq_1mat)
        st = t * self.timestep_scaling
        c_skip = self.sigma_data ** 2 / (st ** 2 + self.sigma_data ** 2)
        c_out = st / math.sqrt(st ** 2 + self.sigma_data ** 2)
        denoised = c_skip * sample + c_out * x0
        if i + 1 >= self.num_steps:
            return denoised
        a_next = float(self.acp[int(self.timesteps[i + 1])])
        return math.sqrt(a_next) * denoised + math.sqrt(1.0 - a_next) * noise
