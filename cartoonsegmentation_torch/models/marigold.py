"""Marigold diffusion depth (port of
``cartoonsegmentation_tpu/models/marigold.py``), on the latent-diffusion
backbone of ``models/ldm.py``:

  rgb → VAE encode (the mean, x 0.18215)
      → the E ensemble members as one batch: the depth latent denoised
        by the UNet on [rgb latent ‖ depth latent] under the frozen
        empty-prompt text embedding, one UNet call at batch E a step
      → VAE decode, channel mean, clip to [-1, 1], to [0, 1]
      → the affine-invariant ensemble merge (``ensemble_depths``).

Everything runs in f32 on the nets' device. The start noise and the LCM
step noises are drawn on the host from a ``torch.Generator`` seeded by
the seed (``draw_noise``); ``forward`` takes them as an argument, so a
test can hand in the JAX package's noise, and the card and the CPU run
on the same noise. The nets are made on the meta device and get their
weights either from a checkpoint (``load_weights``: diffusers'
``unet/``, ``vae/`` and ``text_encoder/`` state dicts) or, at first
use, drawn from the seed on their device (``ready``).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.pointcloud import true_div
from ..utils.image import resize_bilinear, resize_linear_u8, scaledown_size
from .clip import SD2_TEXT, clip_text_embed
from .ldm import (AutoencoderKL, DDIMScheduler, LCMScheduler,
                  UNet2DCondition, fit_proj_weights, init_random_,
                  vae_state_dict)

from ..utils.logger import LOGGER

VAE_SCALE = 0.18215
# CLIP BPE ids of the empty prompt: [startoftext, endoftext]
EMPTY_PROMPT_IDS = (49406, 49407)


def _f32(sd: Mapping) -> dict:
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v))).float()
            for k, v in sd.items()}


def vae_from_cfg(vae_cfg: Optional[dict]) -> AutoencoderKL:
    """The SD VAE, or the one ``vae_cfg`` sizes (the JAX package's keys;
    ``out_ch`` is the image's 3 either way)."""
    cfg = dict(vae_cfg or {})
    cfg.pop('out_ch', None)
    return AutoencoderKL(**cfg)


def load_nets(unet: nn.Module, vae: nn.Module, unet_sd: Mapping,
              vae_sd: Mapping) -> None:
    """diffusers' unet/ and vae/ state dicts into the nets by key name
    (in f32; a projection as Linear or 1x1-conv weights, the VAE's legacy
    attention keys mapped), in place of their tensors."""
    unet.load_state_dict(fit_proj_weights(_f32(unet_sd), unet), assign=True)
    vae.load_state_dict(vae_state_dict(_f32(vae_sd)), assign=True)


def empty_text_embed(text_sd: Mapping, num_layers: int = 23,
                     hidden: int = 1024, heads: int = 16,
                     device='cpu') -> torch.Tensor:
    """The checkpoint's CLIP text tower (SD2's) run once on the empty
    prompt → the frozen (1, 2, hidden) embedding (Marigold's
    encode_empty_text)."""
    return clip_text_embed(text_sd, EMPTY_PROMPT_IDS, hidden, num_layers,
                           heads, SD2_TEXT['act'], device)


class MarigoldDepth(nn.Module):
    """Marigold monocular depth. ``unet_cfg`` / ``vae_cfg`` override the
    SD2-sized defaults (the tests use tiny ones, the JAX package's
    keys); ``forward(img_rgb)`` → depth (H, W) f32 in [0, 1] on the nets'
    device, affine-invariant, at the input's resolution."""

    def __init__(self, processing_res: int = 768, denoise_steps: int = 4,
                 ensemble_size: int = 5, scheduler: str = 'lcm',
                 prediction_type: str = 'v', seed: int = 0,
                 context_dim: int = 1024, unet_cfg: Optional[dict] = None,
                 vae_cfg: Optional[dict] = None):
        super().__init__()
        self.processing_res = processing_res
        self.denoise_steps = denoise_steps
        self.ensemble_size = ensemble_size
        self.scheduler_kind = scheduler
        self.prediction_type = prediction_type
        self.seed = seed
        self.context_dim = context_dim
        with torch.device('meta'):
            self.unet = UNet2DCondition(in_ch=8, context_dim=context_dim,
                                        **(unet_cfg or {}))
            self.vae = vae_from_cfg(vae_cfg)
            self.register_buffer('text_embed',
                                 torch.empty(1, 2, context_dim))

    # -- weights -------------------------------------------------------
    def init_random(self, device='cpu', seed: Optional[int] = None
                    ) -> 'MarigoldDepth':
        """Every weight drawn on ``device`` from a generator seeded by
        ``seed`` (the model's by default): the nets by ``init_random_``,
        the text embedding at 0.02·N(0, 1)."""
        self.to_empty(device=device)
        gen = torch.Generator(device).manual_seed(
            self.seed if seed is None else seed)
        init_random_(self.unet, gen)
        init_random_(self.vae, gen)
        with torch.no_grad():
            self.text_embed.normal_(0.0, 1.0, generator=gen).mul_(0.02)
        return self.eval()

    def load_weights(self, unet_sd: Mapping, vae_sd: Mapping,
                     text_sd: Optional[Mapping] = None) -> None:
        """A Marigold checkpoint's unet/, vae/ and (optionally)
        text_encoder/ state dicts; without the text tower the embedding
        is zeros, as the JAX package's ``convert_marigold``."""
        load_nets(self.unet, self.vae, unet_sd, vae_sd)
        self.text_embed = empty_text_embed(text_sd) if text_sd is not None \
            else torch.zeros(1, 2, self.context_dim)
        self.eval()

    def ready(self, device) -> 'MarigoldDepth':
        """The model on ``device``, its weights drawn there from the seed
        first if none were loaded."""
        if self.text_embed.is_meta:
            LOGGER.warning('marigold: RANDOM init (no checkpoint loaded)')
            return self.init_random(device)
        return self.to(device)

    # -- inference -----------------------------------------------------
    def _scheduler(self):
        if self.scheduler_kind == 'lcm':
            return LCMScheduler(self.denoise_steps,
                                prediction_type=self.prediction_type)
        return DDIMScheduler(self.denoise_steps,
                             prediction_type=self.prediction_type)

    def latent_hw(self, H: int, W: int) -> Tuple[int, int, int, int]:
        """(ph, pw, lh, lw): the processing size (the long side fitted into
        processing_res, both sides rounded up to what the VAE and the
        UNet halve without remainder) and its latent."""
        sf = self.vae.scale
        div = sf * 2 ** (len(self.unet.block_out) - 1)
        ph, pw = scaledown_size(H, W, self.processing_res, divisor=div)
        return ph, pw, ph // sf, pw // sf

    def draw_noise(self, lh: int, lw: int, seed: Optional[int] = None
                   ) -> Tuple[torch.Tensor, list]:
        """The start noise (E, 4, lh, lw) and the LCM's denoise_steps - 1
        step noises (none for DDIM), on the host from a generator seeded
        by ``seed`` (the model's by default)."""
        gen = torch.Generator().manual_seed(self.seed if seed is None
                                            else seed)
        shape = (self.ensemble_size, 4, lh, lw)
        start = torch.randn(shape, generator=gen)
        n = self.denoise_steps - 1 if self.scheduler_kind == 'lcm' else 0
        return start, [torch.randn(shape, generator=gen) for _ in range(n)]

    @torch.inference_mode()
    def sample(self, rgb: torch.Tensor, noise: torch.Tensor,
               step_noise: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        """rgb (1, 3, ph, pw) in [0, 1] → the members' depths (E, ph, pw)
        in [0, 1], from the start noise (E, 4, lh, lw) and the LCM's step
        noises."""
        E, dev = self.ensemble_size, rgb.device
        sch = self._scheduler()
        mean, _ = self.vae.encode(rgb * 2.0 - 1.0)
        rgb_lat = (mean * VAE_SCALE).expand(E, -1, -1, -1)
        ctx = self.text_embed.expand(E, -1, -1)
        z = noise.to(dev)
        for i in range(self.denoise_steps):
            t = torch.full((E,), int(sch.timesteps[i]), device=dev)
            out = self.unet(torch.cat([rgb_lat, z], 1), t, ctx)
            if self.scheduler_kind == 'lcm':
                z = sch.step(out, i, z, step_noise[i].to(dev)
                             if i < len(step_noise) else None)
            else:
                z = sch.step(out, i, z)
        dec = self.vae.decode(true_div(z, VAE_SCALE))
        return (dec.mean(1).clamp(-1.0, 1.0) + 1.0) / 2.0

    @torch.inference_mode()
    def forward(self, img_rgb, seed: Optional[int] = None,
                noise: Optional[Tuple[torch.Tensor, list]] = None
                ) -> torch.Tensor:
        """img RGB uint8 (H, W, 3), numpy or a tensor → depth (H, W) f32 in
        [0, 1] on the nets' device: cv2's INTER_LINEAR down to the
        processing size (``resize_linear_u8``), the sampler, the ensemble
        merge, bilinear back to (H, W). ``noise`` is ``draw_noise``'s pair
        (drawn from ``seed`` when not given)."""
        dev = self.text_embed.device
        img = img_rgb if isinstance(img_rgb, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(img_rgb))
        H, W = img.shape[:2]
        ph, pw, lh, lw = self.latent_hw(H, W)
        small = resize_linear_u8(img.to(dev), ph, pw)
        rgb = true_div(small.float(), 255.0).permute(2, 0, 1)[None]
        start, steps = noise if noise is not None else \
            self.draw_noise(lh, lw, seed)
        depth = ensemble_depths(self.sample(rgb, start, steps))
        return resize_bilinear(depth[..., None], H, W)[..., 0]


def _median0(d: torch.Tensor) -> torch.Tensor:
    """jnp.median over axis 0: the middle value, the mean of the two
    middles (their sum times 0.5) for an even count. torch.median takes
    the lower middle."""
    s = d.sort(0).values
    E = d.shape[0]
    return (s[(E - 1) // 2] + s[E // 2]) * 0.5


def ensemble_depths(preds: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Affine-invariant ensemble merge (Marigold ensemble_depth): each
    member min-max normalised, then ``iters`` rounds of the closed-form
    least-squares scale and shift of each member to the members' median,
    the final median min-max normalised to [0, 1]. (E, H, W) → (H, W)."""
    E = preds.shape[0]
    flat = preds.reshape(E, -1)
    lo = flat.amin(1, keepdim=True)
    hi = flat.amax(1, keepdim=True)
    d = (flat - lo) / (hi - lo).clamp_min(1e-6)
    for _ in range(iters):
        med = _median0(d)[None]
        dm = d.mean(1, keepdim=True)
        mm = med.mean(1, keepdim=True)
        cov = ((d - dm) * (med - mm)).mean(1, keepdim=True)
        var = ((d - dm) ** 2).mean(1, keepdim=True).clamp_min(1e-12)
        a = cov / var
        d = a * d + (mm - a * dm)
    merged = _median0(d)
    lo, hi = merged.min(), merged.max()
    merged = (merged - lo) / (hi - lo).clamp_min(1e-6)
    return merged.reshape(preds.shape[1:])
