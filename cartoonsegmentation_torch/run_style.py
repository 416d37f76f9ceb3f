"""Instance-aware style editing CLI of the PyTorch port.

  python -m cartoonsegmentation_torch.run_style --img_path photo.png \
      [--cfg configs/3d_pixar.yaml] [--url .../sdapi/v1/img2img] \
      [--device cuda]

The flags of the JAX package's ``scripts/run_style.py``, with the same
meanings and the same yaml-vs-flag precedence, plus ``--device``.
Detects the instances with AnimeInsSeg and its ISNet refine, tags them
(``--tagger_ckpt``, or the stub with ``--allow-stub-tagger``), fills the
background on the device and repaints through a running
stable-diffusion-webui server (``--url``). Nets without a checkpoint
have random weights made from a fixed seed.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import sys


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--img_path', required=True)
    ap.add_argument('--cfg', default='',
                    help='style yaml (reference configs/3d_pixar.yaml '
                         'schema); CLI flags override its fields when '
                         'given explicitly')
    ap.add_argument('--style-prompt', default='')
    ap.add_argument('--bg_nprompt', default='')
    ap.add_argument('-n', '--global-nprompt', default='')
    ap.add_argument('--url',
                    default='http://127.0.0.1:7860/sdapi/v1/img2img')
    ap.add_argument('--long_side', type=int, default=768)
    ap.add_argument('-W', '--width', type=int, default=0,
                    help='exact working width (with -H overrides the '
                         'aspect-kept --long_side sizing)')
    ap.add_argument('-H', '--height', type=int, default=0)
    ap.add_argument('--niter', type=int, default=1)
    ap.add_argument('-s', '--steps', type=int, default=24)
    ap.add_argument('-c', '--cfg_scale', type=int, default=9)
    ap.add_argument('-S', '--sample_name', default='Euler a')
    ap.add_argument('-d', '--denoising_strength', type=float,
                    default=0.75)
    ap.add_argument('-f', '--fill', default='original',
                    choices=['fill', 'original', 'latent_noise',
                             'latent_nothing'],
                    help='masked content fill method')
    ap.add_argument('-b', '--mask_blur', type=int, default=4)
    ap.add_argument('--inpaint_full_res', type=int, default=1)
    ap.add_argument('--inpaint_full_res_padding', type=int, default=32)
    ap.add_argument('--no-onebyone', dest='onebyone',
                    action='store_false',
                    help='one joint inpaint over the union mask '
                         'instead of per-instance passes')
    ap.add_argument('--save_intermediate', action='store_true')
    ap.add_argument('--to-grey', dest='to_grey', action='store_true',
                    help='infer tags from a greyscale view')
    ap.add_argument('--apply-bg-tagger', action='store_true',
                    help='append background tags to the bg prompt')
    ap.add_argument('--no-fg-tagger', dest='apply_fg_tagger',
                    action='store_false',
                    help='skip per-instance tags in fg prompts')
    ap.add_argument('--save_dir', default='repaint_output')
    ap.add_argument('--cache_masks_dir', default='workspace/style_cache')
    ap.add_argument('--detector_ckpt', default='')
    ap.add_argument('--tagger_ckpt', default='',
                    help='Danbooru tagger checkpoint (onnx or torch); '
                         'when given, instance crops are tagged to '
                         'build the repaint prompts')
    ap.add_argument('--allow-stub-tagger', action='store_true',
                    help='permit the deterministic stub tagger '
                         '(fabricated tags) when no model is available')
    ap.add_argument('--random_seed', action='store_true')
    ap.add_argument('--device', default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         'plain versions of the kernels)')
    args = ap.parse_args(argv)

    import cv2
    from pathlib import Path
    from .pipeline.segment import AnimeInsSeg
    from .pipeline.style import StyleConfig, StyleEditor

    detector = AnimeInsSeg(device=args.device)
    if args.detector_ckpt:
        detector.load_torch_checkpoint(args.detector_ckpt)
    detector.set_refine_method('refinenet_isnet')

    if args.cfg:
        import dataclasses
        from .pipeline.style import style_config_from_yaml
        cfg = style_config_from_yaml(args.cfg)
        # explicit CLI flags override the yaml — detected from argv so
        # a flag explicitly set to its default still wins
        given = {a.lstrip('-').split('=')[0].replace('-', '_')
                 for a in argv if a.startswith('--')}
        overrides = {f.name: getattr(args, f.name)
                     for f in dataclasses.fields(cfg)
                     if f.name in given and hasattr(args, f.name)}
        cfg = dataclasses.replace(cfg, **overrides)
        sd = dict(cfg.sd_params)
        for k, flag in (('steps', 'steps'), ('cfg_scale', 'cfg_scale'),
                        ('sampler_name', 'sample_name')):
            if flag in given:
                sd[k] = getattr(args, flag)
        # the non-yaml path always wires the ControlNet slot; keep the
        # two paths consistent unless the yaml configured its own
        sd.setdefault('alwayson_scripts',
                      {'controlnet': {'args': [{}]}})
        cfg = dataclasses.replace(cfg, sd_params=sd)
        # inverted/short flags the `given` scan can't map onto field
        # names: apply only when explicitly present on the cmdline
        present = set(argv)
        if '--no-onebyone' in present:
            cfg.onebyone = False
        if '--no-fg-tagger' in present:
            cfg.apply_fg_tagger = False
        for flags, name, val in (
                (('-f', '--fill'), 'inpainting_fill',
                 ['fill', 'original', 'latent_noise',
                  'latent_nothing'].index(args.fill)),
                (('-b', '--mask_blur'), 'mask_blur', args.mask_blur),
                (('-d', '--denoising_strength'), 'denoising_strength',
                 args.denoising_strength),
                (('--inpaint_full_res',), 'inpaint_full_res',
                 args.inpaint_full_res),
                (('--inpaint_full_res_padding',),
                 'inpaint_full_res_padding',
                 args.inpaint_full_res_padding)):
            if present & set(flags):
                setattr(cfg, name, val)
    else:
        cfg = StyleConfig(
            url=args.url, style_prompt=args.style_prompt,
            bg_nprompt=args.bg_nprompt,
            global_nprompt=args.global_nprompt,
            long_side=args.long_side, niter=args.niter,
            onebyone=args.onebyone,
            random_seed=args.random_seed,
            denoising_strength=args.denoising_strength,
            mask_blur=args.mask_blur,
            inpainting_fill=['fill', 'original', 'latent_noise',
                             'latent_nothing'].index(args.fill),
            inpaint_full_res=args.inpaint_full_res,
            inpaint_full_res_padding=args.inpaint_full_res_padding,
            apply_fg_tagger=args.apply_fg_tagger,
            cache_masks_dir=args.cache_masks_dir,
            save_dir=args.save_dir,
            sd_params={'steps': args.steps, 'cfg_scale': args.cfg_scale,
                       'sampler_name': args.sample_name, 'seed': 0,
                       'alwayson_scripts': {'controlnet': {'args': [{}]}}})
    if args.width > 0 and args.height > 0:
        cfg.exact_size = (args.width, args.height)
    if args.save_intermediate:
        cfg.save_intermediate = True
    if args.to_grey:
        cfg.to_grey = True
    if args.apply_bg_tagger:
        cfg.apply_bg_tagger = True
    tagger = None
    if args.tagger_ckpt or args.allow_stub_tagger:
        from .models.tagger import Tagger
        # strict by default: fabricated stub tags must be opted into
        t = Tagger(args.tagger_ckpt, strict=not args.allow_stub_tagger,
                   device=detector.device)
        tagger = t.label_cv2_bgr
    editor = StyleEditor(cfg, detector=detector, tagger=tagger)

    if osp.isdir(args.img_path):
        paths = [osp.join(args.img_path, f)
                 for f in sorted(os.listdir(args.img_path))
                 if f.lower().endswith(('.jpg', '.png', '.webp'))]
    else:
        paths = [args.img_path]
    for p in paths:
        img = cv2.imread(p)
        name = Path(p).stem
        saved = editor.repaint(img, name)
        print(f'{p} -> {saved}')


if __name__ == '__main__':
    main()
