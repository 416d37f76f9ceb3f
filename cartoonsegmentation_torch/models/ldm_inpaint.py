"""Latent-diffusion inpainting in the process (port of
``cartoonsegmentation_tpu/models/ldm_inpaint.py``): the SD1.5-inpainting
architecture on the ``models/ldm.py`` blocks.

- a 9-channel conv_in UNet (noisy latent ‖ hole mask ‖ masked-image
  latent), 1x1-conv transformer projections, 8 heads a level, CLIP-L
  context 768 x 77 (``SD15_UNET``);
- classifier-free guidance as one UNet call at batch 2 a step
  ([uncond, cond]), both prompts embedded once (``load_checkpoint``;
  random weights leave cond at 0.02·N(0, 1) and uncond at zeros);
- DDIM with 'leading' spacing, steps_offset 1 and set_alpha_to_one
  False (the runwayml SD1.5-inpainting scheduler config).

Everything runs in f32 on the nets' device; the start noise is drawn on
the host from a ``torch.Generator`` seeded by the seed (``draw_noise``)
and can be handed in instead. Checkpoint layout: a diffusers directory
(unet/ vae/ text_encoder/ tokenizer/).
"""
from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pointcloud import true_div
from ..utils.image import resize_linear_u8, scaledown_size
from .clip import SD15_TEXT, ClipTokenizer, clip_text_embed
from .ldm import DDIMScheduler, UNet2DCondition, init_random_
from .marigold import VAE_SCALE, load_nets, vae_from_cfg

from ..utils.logger import LOGGER

SD15_UNET = dict(out_ch=4, block_out=(320, 640, 1280, 1280),
                 layers_per_block=2, heads=(8, 8, 8, 8),
                 cross_attn=(True, True, True, False),
                 linear_proj=False)


def resize_nearest_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST) of a host
    array: source index floor(i · (1 / (out / in))) in double, clipped
    to the last row or column."""
    H, W = img.shape[:2]

    def idx(n_in, n_out):
        i = np.floor(np.arange(n_out) * (1.0 / (n_out / n_in)))
        return np.minimum(i.astype(np.int64), n_in - 1)
    return img[idx(H, h)][:, idx(W, w)]


class LDMInpainter(nn.Module):
    """The SD-inpainting latent inpainter; ``forward(img_bgr, mask)`` →
    the inpainted uint8 BGR image at the input's resolution, pixels
    outside the hole kept."""

    def __init__(self, steps: int = 32, guidance: float = 7.0,
                 seed: int = 0, context_dim: int = 768,
                 context_len: int = 77, unet_cfg: Optional[dict] = None,
                 vae_cfg: Optional[dict] = None):
        super().__init__()
        self.steps = steps
        self.guidance = guidance
        self.seed = seed
        self.context_dim = context_dim
        self.context_len = context_len
        with torch.device('meta'):
            self.unet = UNet2DCondition(in_ch=9, context_dim=context_dim,
                                        **(unet_cfg or SD15_UNET))
            self.vae = vae_from_cfg(vae_cfg)
            self.register_buffer(
                'cond', torch.empty(1, context_len, context_dim))
            self.register_buffer(
                'uncond', torch.empty(1, context_len, context_dim))

    # -- weights -------------------------------------------------------
    def init_random(self, device='cpu', seed: Optional[int] = None
                    ) -> 'LDMInpainter':
        """Every weight drawn on ``device`` from a generator seeded by
        ``seed`` (the model's by default); cond at 0.02·N(0, 1), uncond
        zeros."""
        self.to_empty(device=device)
        gen = torch.Generator(device).manual_seed(
            self.seed if seed is None else seed)
        init_random_(self.unet, gen)
        init_random_(self.vae, gen)
        with torch.no_grad():
            self.cond.normal_(0.0, 1.0, generator=gen).mul_(0.02)
            self.uncond.zero_()
        return self.eval()

    def load_checkpoint(self, unet_path: str, vae_path: str, text_path: str,
                        tokenizer_dir: str, prompt: str,
                        negative: str = '') -> None:
        """A diffusers-layout checkpoint: the unet/, vae/ and text_encoder/
        weight files and the tokenizer directory (vocab.json,
        merges.txt); the two prompts are embedded once by the SD1.5 CLIP
        tower on the CPU."""
        from ..pipeline.kenburns import _load_torch_ckpt
        load_nets(self.unet, self.vae, _load_torch_ckpt(unet_path),
                  _load_torch_ckpt(vae_path))
        text_sd = _load_torch_ckpt(text_path)
        tok = ClipTokenizer(osp.join(tokenizer_dir, 'vocab.json'),
                            osp.join(tokenizer_dir, 'merges.txt'))
        self.cond = clip_text_embed(
            text_sd, tok.encode(prompt, self.context_len), **SD15_TEXT)
        self.uncond = clip_text_embed(
            text_sd, tok.encode(negative, self.context_len), **SD15_TEXT)
        self.eval()

    def ready(self, device) -> 'LDMInpainter':
        """The model on ``device``, its weights drawn there from the seed
        first if none were loaded."""
        if self.cond.is_meta:
            LOGGER.warning('ldm inpaint: RANDOM init (no checkpoint loaded)')
            return self.init_random(device)
        return self.to(device)

    # -- inference -----------------------------------------------------
    def size_for(self, H: int, W: int, res: int):
        """(rh, rw, lh, lw): the working size (the long side fitted into
        ``res``, both sides rounded up to what the VAE and the UNet halve
        without remainder) and its latent."""
        sf = self.vae.scale
        div = sf * 2 ** (len(self.unet.block_out) - 1)
        rh, rw = scaledown_size(H, W, res, divisor=div)
        return rh, rw, rh // sf, rw // sf

    def draw_noise(self, lh: int, lw: int, seed: Optional[int] = None
                   ) -> torch.Tensor:
        """The start noise (1, 4, lh, lw), on the host from a generator
        seeded by ``seed`` (the model's by default)."""
        gen = torch.Generator().manual_seed(self.seed if seed is None
                                            else seed)
        return torch.randn((1, 4, lh, lw), generator=gen)

    @torch.inference_mode()
    def sample(self, rgb01: torch.Tensor, mask: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
        """rgb01 (1, 3, h, w) in [0, 1], mask (1, 1, h, w) in {0, 1} (1 =
        hole) → (1, 3, h, w): the decoded sample under the hole, the
        image elsewhere."""
        dev = rgb01.device
        sch = DDIMScheduler(self.steps, prediction_type='epsilon',
                            spacing='leading', steps_offset=1,
                            set_alpha_to_one=False)
        keep = 1.0 - mask
        mean, _ = self.vae.encode(rgb01 * keep * 2.0 - 1.0)
        m_lat = mean * VAE_SCALE
        # jax.image.resize's 'nearest' is torch's 'nearest-exact'
        mask_l = F.interpolate(mask, size=m_lat.shape[-2:],
                               mode='nearest-exact')
        z = noise.to(dev)
        ctx = torch.cat([self.uncond, self.cond], 0)
        for i in range(self.steps):
            t = torch.full((2,), int(sch.timesteps[i]), device=dev)
            zin = torch.cat([z, mask_l, m_lat], 1)
            eps = self.unet(torch.cat([zin, zin], 0), t, ctx)
            e_un, e_c = eps[0:1], eps[1:2]
            z = sch.step(e_un + self.guidance * (e_c - e_un), i, z)
        dec = self.vae.decode(true_div(z, VAE_SCALE))
        out01 = ((dec + 1.0) / 2.0).clamp(0.0, 1.0)
        return rgb01 * keep + out01 * mask

    @torch.inference_mode()
    def forward(self, img_bgr: np.ndarray, mask: np.ndarray,
                res: Optional[int] = None, seed: Optional[int] = None,
                noise: Optional[torch.Tensor] = None) -> np.ndarray:
        """img_bgr uint8 (H, W, 3); mask (H, W), nonzero = hole → the
        inpainted uint8 BGR image (H, W, 3) on the host. The image goes
        to the working size by cv2's INTER_LINEAR (``resize_linear_u8``),
        the mask by INTER_NEAREST; resized back, the result keeps the
        input's pixels outside the hole at full resolution. ``noise`` is
        ``draw_noise``'s (drawn from ``seed`` when not given)."""
        dev = self.cond.device
        H, W = img_bgr.shape[:2]
        rh, rw, lh, lw = self.size_for(H, W, res or max(H, W))
        img = torch.from_numpy(np.ascontiguousarray(img_bgr)).to(dev)
        hole = np.asarray(mask) > 0
        m = resize_nearest_u8(hole.astype(np.uint8), rh, rw)
        rgb = true_div(resize_linear_u8(img, rh, rw).flip(-1).float(), 255.0)
        m_f = torch.from_numpy(m.astype(np.float32)).to(dev)[None, None]
        noise = noise if noise is not None else self.draw_noise(lh, lw, seed)
        out = self.sample(rgb.permute(2, 0, 1)[None], m_f, noise)
        # the uint8 cast truncates, as numpy's astype does
        out_u8 = (out[0].clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        out_u8 = out_u8.permute(1, 2, 0).flip(-1)
        if (rh, rw) != (H, W):
            out_u8 = resize_linear_u8(out_u8.contiguous(), H, W)
            out_u8 = torch.where(torch.from_numpy(hole).to(dev)[..., None],
                                 out_u8, img)
        return out_u8.cpu().numpy()
