"""Instance-aware style editing / repainting (port of
``cartoonsegmentation_tpu/pipeline/style.py``).

Per image: detect and tag the instances, fill the background where
they stood (``ops/inpaint_fill.py:inpaint``, kernels K13a push-pull
and K13b jitter refine, on the editor's device), tag the background,
repaint the background (img2img with ControlNet through the sd-webui
client), composite the instances back, then inpaint each instance with
its own prompt, ``niter`` rounds. The mask and prompt cache keeps the
JAX package's layout and file names, so a cache written by one
package serves the other.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from dataclasses import dataclass, field
from random import randint
from typing import Dict, List, Optional

import numpy as np

from ..device import resolve_device
from ..ops.inpaint_fill import inpaint as fill_inpaint
from ..serving.sd_webui import (b64_2img, img2b64, run_img2img,
                                run_sdinpaint_all)

from ..utils.logger import LOGGER


def long_side_to(h: int, w: int, long_side: int):
    """/32-rounded resize target (run_style.py:42-52)."""
    asp = h / w
    if asp > 1:
        h = int(round(long_side / 32)) * 32
        w = int(round(h / asp / 32)) * 32
    else:
        w = int(round(long_side / 32)) * 32
        h = int(round(w * asp / 32)) * 32
    return h, w


@dataclass
class StyleConfig:
    url: str = 'http://127.0.0.1:7860/sdapi/v1/img2img'
    onebyone: bool = True     # per-instance inpaints vs one joint mask
    style_prompt: str = ''
    bg_nprompt: str = ''
    global_nprompt: str = ''
    long_side: int = 768
    # exact working resolution (w, h) — overrides long_side when set
    # (reference repaint_person.py:196-197 resizes to -W/-H exactly)
    exact_size: Optional[tuple] = None
    # tag instances from a greyscale crop (reference infer_grey,
    # animeinsseg/__init__.py:237 / repaint_person.py:218 --to-grey)
    to_grey: bool = False
    # save every per-instance inpaint step, not just each round's
    # final output (reference repaint_person.py:217 --save_intermediate)
    save_intermediate: bool = False
    niter: int = 1
    random_seed: bool = False
    apply_bg_tagger: bool = False
    apply_fg_tagger: bool = True
    mask_blur: int = 4
    inpainting_fill: int = 1
    inpaint_full_res: int = 1
    inpaint_full_res_padding: int = 32
    denoising_strength: float = 0.75
    # Batch Count / Batch Size (reference Web_UI Component_AIS.py:
    # 366-385 sliders → sd-webui n_iter / batch_size): the FINAL
    # inpaint of each niter round generates count*size variants; the
    # chain continues on the first, the rest are saved alongside.
    batch_count: int = 1
    batch_size: int = 1
    sd_params: Dict = field(default_factory=dict)
    cache_masks_dir: str = 'workspace/style_cache'
    save_dir: str = 'repaint_output'
    auth: Optional[tuple] = None


def style_config_from_yaml(src) -> StyleConfig:
    """Load a reference-format style yaml (configs/3d_pixar.yaml
    schema: style_prompt/niter/global_nprompt/url/sd_params/...).
    Unknown keys are ignored; sd_params passes through verbatim."""
    import dataclasses
    from ..config import load_yaml
    raw = load_yaml(src)
    names = {f.name for f in dataclasses.fields(StyleConfig)}
    kw = {k: v for k, v in raw.items() if k in names}
    if raw.get('sd_params'):
        kw['sd_params'] = dict(raw['sd_params'])
    return StyleConfig(**kw)


class StyleEditor:

    def __init__(self, cfg: StyleConfig, detector=None, tagger=None,
                 device=None):
        self.cfg = cfg
        self.detector = detector  # AnimeInsSeg-compatible
        self.tagger = tagger      # callable img_bgr → (tags, char_tags)
        # the background fill's device: the detector's unless given
        self.device = resolve_device(
            device if device is not None
            else getattr(detector, 'device', None))

    def _work_size(self, img_bgr: np.ndarray):
        """(h, w) the editor works at: exact_size when set (reference
        -W/-H), otherwise /32-rounded long_side."""
        if self.cfg.exact_size is not None:
            w, h = self.cfg.exact_size
            return int(h), int(w)
        H, W = img_bgr.shape[:2]
        return long_side_to(H, W, self.cfg.long_side)

    def _grey3(self, img: np.ndarray) -> np.ndarray:
        """3-channel greyscale of a working image when cfg.to_grey —
        the reference greys the ENTIRE image before any processing
        (repaint_person.py:46-47), so the greyed pixels feed the bg
        fill, composites, and every SD request, not just the tagger."""
        if not self.cfg.to_grey:
            return img
        import cv2
        g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        return np.repeat(g[..., None], 3, axis=-1)

    def _tag(self, crop_bgr: np.ndarray):
        """Run the tagger, optionally on a greyscale view (reference
        infer_grey: animeinsseg/__init__.py:237)."""
        if self.cfg.to_grey:
            import cv2
            g = cv2.cvtColor(crop_bgr, cv2.COLOR_BGR2GRAY)
            crop_bgr = g[..., None][..., [0, 0, 0]]
        return self.tagger(crop_bgr)

    # ------------------------------------------------------------------
    def prepare(self, img_bgr: np.ndarray, imname: str):
        """Detect, tag, background-fill, cache — returns
        (bg RGB, mask_fg L, masks list, fg_prompts, bg_prompt)."""
        import cv2
        cfg = self.cfg
        os.makedirs(cfg.cache_masks_dir, exist_ok=True)
        promptp = osp.join(cfg.cache_masks_dir, f'{imname}_prompts.json')

        h, w = self._work_size(img_bgr)
        img_resized = self._grey3(cv2.resize(
            img_bgr, (w, h), interpolation=cv2.INTER_LANCZOS4))

        if osp.exists(promptp):
            return self._load_cache(promptp, imname)

        if self.detector is None:
            raise RuntimeError('StyleEditor.prepare needs a detector')
        instances = self.detector.infer(img_bgr)
        masks_np = instances.masks.cpu().numpy()
        valid = instances.valid.cpu().numpy()
        if not valid.any():
            return None

        prompts_dict = {}
        masks, fg_prompts = [], []
        for i in np.nonzero(valid)[0]:
            m = cv2.resize(masks_np[i].astype(np.uint8) * 255, (w, h),
                           interpolation=cv2.INTER_AREA)
            savename = f'{imname}_{str(i).zfill(3)}.png'
            cv2.imwrite(osp.join(cfg.cache_masks_dir, savename), m)
            masks.append(m)
            prompt = ''
            if self.tagger is not None:
                x, y, bw, bh = instances.bboxes[i].cpu().numpy().astype(int)
                crop = img_bgr[y:y + bh, x:x + bw].copy()
                mask_crop = masks_np[i][y:y + bh, x:x + bw]
                crop[~mask_crop] = 255
                tags, ctags = self._tag(crop)
                tags = [t for t in tags if t not in ctags]
                prompt = ','.join(tags).replace('_', ' ')
            prompts_dict[savename] = prompt
            fg_prompts.append(prompt)

        mask_fg = cv2.resize(
            (np.any(masks_np[valid], axis=0)).astype(np.uint8) * 255,
            (w, h), interpolation=cv2.INTER_AREA)
        bg_bgr = fill_inpaint(img_resized, mask_fg, patch_size=3,
                              device=self.device)
        cv2.imwrite(osp.join(cfg.cache_masks_dir,
                             f'{imname}_bg_repaint.png'), bg_bgr)
        cv2.imwrite(osp.join(cfg.cache_masks_dir,
                             f'{imname}_mask_fg.png'), mask_fg)
        bg_prompt = ''
        if self.tagger is not None:
            tags, _ = self._tag(bg_bgr)
            bg_prompt = ','.join(t.replace('_', ' ') for t in tags)
        prompts_dict[f'{imname}_bg_repaint.png'] = bg_prompt
        with open(promptp, 'w') as f:
            json.dump(prompts_dict, f)

        bg_rgb = bg_bgr[..., ::-1]
        return (bg_rgb, mask_fg, masks, fg_prompts, bg_prompt,
                img_resized[..., ::-1])

    def _load_cache(self, promptp: str, imname: str):
        import cv2
        cfg = self.cfg
        with open(promptp) as f:
            prompts_dict = json.load(f)
        masks, fg_prompts, bg_prompt, bg = [], [], '', None
        for name, prompt in prompts_dict.items():
            p = osp.join(cfg.cache_masks_dir, name)
            im = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            if name.endswith('bg_repaint.png'):
                bg_prompt, bg = prompt, im[..., ::-1]
            else:
                masks.append(im)
                fg_prompts.append(prompt)
        mask_fg = cv2.imread(
            osp.join(cfg.cache_masks_dir, f'{imname}_mask_fg.png'),
            cv2.IMREAD_GRAYSCALE)
        return bg, mask_fg, masks, fg_prompts, bg_prompt, None

    # ------------------------------------------------------------------
    def repaint(self, img_bgr: np.ndarray, imname: str) -> List[str]:
        """Full onebyone repaint loop; returns saved image paths."""
        import cv2
        cfg = self.cfg
        prep = self.prepare(img_bgr, imname)
        if prep is None:
            LOGGER.info('no fg instances found')
            return []
        bg_rgb, mask_fg, masks, fg_prompts, bg_prompt, img_rgb = prep
        if img_rgb is None:
            h, w = self._work_size(img_bgr)
            img_rgb = self._grey3(cv2.resize(
                img_bgr, (w, h),
                interpolation=cv2.INTER_LANCZOS4))[..., ::-1]
        return self.repaint_prepared(img_rgb, bg_rgb, mask_fg, masks,
                                     fg_prompts, bg_prompt, imname)

    def repaint_prepared(self, img_rgb: np.ndarray, bg_rgb: np.ndarray,
                         mask_fg: np.ndarray, masks: List[np.ndarray],
                         fg_prompts: List[str], bg_prompt: str,
                         imname: str) -> List[str]:
        """The repaint loop on already-prepared (possibly user-edited)
        masks and prompts — the seam the Web UI's per-instance style
        editing rides (reference interaction:
        Web_UI/Component/Component_Style_Editing.py:1345-2219, where
        detected masks and auto-tags are editable before repainting)."""
        import cv2
        cfg = self.cfg
        h, w = img_rgb.shape[:2]
        data = dict(cfg.sd_params)
        data.setdefault('width', w)
        data.setdefault('height', h)
        data.setdefault('seed', 0)
        data_inpaint = dict(data)
        data_inpaint.update({
            'mask_blur': cfg.mask_blur,
            'inpainting_fill': cfg.inpainting_fill,
            'inpaint_full_res': cfg.inpaint_full_res,
            'inpaint_full_res_padding': cfg.inpaint_full_res_padding,
            'denoising_strength': cfg.denoising_strength,
        })

        os.makedirs(cfg.save_dir, exist_ok=True)
        saved = []
        img_repainted = img_rgb
        out_b64 = None
        for it in range(cfg.niter):
            seed = randint(0, 65536) if cfg.random_seed \
                else data['seed'] + it
            data['seed'] = data_inpaint['seed'] = seed

            if it == 0:
                prompt = (cfg.style_prompt + ',' +
                          (bg_prompt + ',' if cfg.apply_bg_tagger else '')
                          ).strip(',')
                out_b64 = run_img2img(img2b64(bg_rgb), data, prompt,
                                      cfg.bg_nprompt, cfg.url, cfg.auth)
                bg_repainted = b64_2img(out_b64)
                alpha = (np.asarray(mask_fg, np.float32) / 255.0)[..., None]
                img_repainted = (img_repainted * alpha +
                                 bg_repainted[..., :3] * (1 - alpha)
                                 ).astype(np.uint8)

            if cfg.onebyone:
                fg_jobs = list(zip(fg_prompts, masks))
            else:  # one joint inpaint over the union mask
                fg_jobs = [(','.join(p for p in fg_prompts if p),
                            mask_fg)]
            n_var = max(1, int(cfg.batch_count)) \
                * max(1, int(cfg.batch_size))
            variants: List[np.ndarray] = []
            for j, (fg_prompt, mask) in enumerate(fg_jobs):
                prompt = (cfg.style_prompt + ',' +
                          (fg_prompt + ',' if cfg.apply_fg_tagger else '')
                          ).strip(',')
                data_j = dict(data_inpaint)
                if n_var > 1 and j == len(fg_jobs) - 1:
                    # batched variants on the round's final inpaint
                    data_j['n_iter'] = int(cfg.batch_count)
                    data_j['batch_size'] = int(cfg.batch_size)
                outs = run_sdinpaint_all(img2b64(img_repainted), mask,
                                         data_j, prompt,
                                         cfg.global_nprompt, cfg.url,
                                         cfg.auth)
                img_repainted = b64_2img(outs[0])[..., :3]
                variants = [b64_2img(o)[..., :3] for o in outs[1:]]
                if cfg.save_intermediate and j < len(fg_jobs) - 1:
                    # per-instance step output (reference
                    # repaint_person.py:182-184 save_intermediate)
                    ip = osp.join(cfg.save_dir,
                                  f'{imname}_onebyone_niter{it}_fg{j}_'
                                  f'{seed}.png')
                    cv2.imwrite(ip, img_repainted[..., ::-1])
                    saved.append(ip)

            outp = osp.join(cfg.save_dir,
                            f'{imname}_onebyone_niter{it}_output_'
                            f'{seed}.png')
            cv2.imwrite(outp, img_repainted[..., ::-1])
            saved.append(outp)
            for k, var in enumerate(variants):
                vp = osp.join(cfg.save_dir,
                              f'{imname}_onebyone_niter{it}_output_'
                              f'{seed}_var{k + 1}.png')
                cv2.imwrite(vp, var[..., ::-1])
                saved.append(vp)
        return saved

    # ------------------------------------------------------------------
    def repaint_whole(self, img_bgr: np.ndarray, imname: str) -> List[str]:
        """Whole-image img2img without any instance masks — the
        reference's ``--onebyone False`` path (repaint_person.py:81-103:
        one img2img of the resized image with the style prompt; no
        detection, no background fill). Returns saved image paths."""
        import cv2
        cfg = self.cfg
        h, w = self._work_size(img_bgr)
        img_rgb = self._grey3(cv2.resize(
            img_bgr, (w, h),
            interpolation=cv2.INTER_LANCZOS4))[..., ::-1]
        data = dict(cfg.sd_params)
        data.setdefault('width', w)
        data.setdefault('height', h)
        data.setdefault('seed', 0)
        # the reference whole-image path sends denoising_strength in
        # options_shared (repaint_person.py:55) — without this the -d
        # flag is silently ignored in --no-onebyone mode
        data.setdefault('denoising_strength', cfg.denoising_strength)
        out_b64 = run_img2img(img2b64(img_rgb), data, cfg.style_prompt,
                              cfg.global_nprompt, cfg.url, cfg.auth)
        os.makedirs(cfg.save_dir, exist_ok=True)
        outp = osp.join(cfg.save_dir, f'repaint-default-{imname}.png')
        cv2.imwrite(outp, b64_2img(out_b64)[..., :3][..., ::-1])
        return [outp]
