"""Per-person repaint CLI of the PyTorch port (the lineart-anime
variant of the style editor).

  python -m cartoonsegmentation_torch.repaint_person --img_path a.png \
      [-p PROMPT] [-W 768 -H 768] [--no-onebyone] [--device cuda]

The flags of the JAX package's ``scripts/repaint_person.py``, with the
same meanings and the same yaml-vs-flag precedence, plus ``--device``:
ControlNet lineart_anime conditioning, per-instance inpaints (the
background filled on the device), or with ``--no-onebyone`` one plain
whole-image img2img. Needs a running stable-diffusion-webui server
(``--url``).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import sys

# reference repaint_person.py:19
INPAINTING_FILL_METHODS = ['fill', 'original', 'latent_noise',
                           'latent_nothing']


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        description='Inpaint instances of people using stable '
                    'diffusion (reference repaint_person.py)')
    ap.add_argument('--img_path', required=True,
                    help='Path to input image.')
    ap.add_argument('--no-onebyone', dest='onebyone',
                    action='store_false',
                    help='plain whole-image img2img instead of '
                         'per-instance repainting (reference '
                         '--onebyone False)')
    ap.add_argument('-p', '--prompt', default='')
    ap.add_argument('-n', '--negative_prompt', '--nprompt',
                    dest='nprompt', default='')
    ap.add_argument('-W', '--width', type=int, default=768,
                    help='Width of output image.')
    ap.add_argument('-H', '--height', type=int, default=768,
                    help='Height of output image.')
    ap.add_argument('-s', '--steps', type=int, default=24)
    ap.add_argument('-c', '--cfg_scale', type=int, default=9,
                    help='Classifier free guidance scale.')
    ap.add_argument('-S', '--sample_name', default='Euler a',
                    help='Name of sampler to use.')
    ap.add_argument('-d', '--denoising_strength', type=float,
                    default=0.75)
    ap.add_argument('-f', '--fill', default=INPAINTING_FILL_METHODS[1],
                    choices=INPAINTING_FILL_METHODS,
                    help='masked content fill method')
    ap.add_argument('-b', '--mask_blur', type=int, default=4,
                    help='Blur radius of Gaussian filter on mask.')
    ap.add_argument('-r', '--resolution', type=int, default=640,
                    help='ControlNet processor resolution')
    ap.add_argument('--save_dir', default='repaint_output')
    ap.add_argument('--url',
                    default='http://127.0.0.1:7860/sdapi/v1/img2img')
    ap.add_argument('--cfg', default='',
                    help='repaint config path (style yaml; CLI flags '
                         'given explicitly still win)')
    ap.add_argument('--bg_nprompt',
                    default='((person)), character, 1girl, 1boy',
                    help='background negative prompt')
    ap.add_argument('--inpaint_full_res', type=int, default=1)
    ap.add_argument('--inpaint_full_res_padding', type=int, default=32)
    ap.add_argument('--detector_ckpt', default='')
    ap.add_argument('--save_intermediate', action='store_true',
                    help='save every per-instance inpaint step')
    ap.add_argument('--to-grey', dest='to_grey', action='store_true',
                    help='infer tags from a greyscale view')
    ap.add_argument('--no-tagger', dest='infer_tagger',
                    action='store_false',
                    help='skip per-instance tag inference')
    ap.add_argument('--device', default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         'plain versions of the kernels)')
    args = ap.parse_args(argv)

    import cv2
    from pathlib import Path
    from .pipeline.style import (StyleConfig, StyleEditor,
                                 style_config_from_yaml)

    # ControlNet lineart_anime conditioning rides sd_params verbatim
    # (reference repaint_person.py:44-77 options_shared)
    sd_params = {
        'steps': args.steps, 'seed': 0,
        'cfg_scale': args.cfg_scale,
        'sampler_name': args.sample_name,
        'alwayson_scripts': {'controlnet': {'args': [{
            'module': 'lineart_anime',
            'model': 'control_v11p_sd15s2_lineart_anime [3825e83e]',
            'weight': 1,
            'resize_mode': 'Inner Fit (Scale to Fit)',
            'lowvram': False,
            'processor_res': args.resolution,
            'threshold_a': 64, 'threshold_b': 64,
            'guidance_start': 0, 'guidance_end': 1,
            'pixel_perfect': True, 'enabled': True,
        }]}},
    }

    cfg = style_config_from_yaml(args.cfg) if args.cfg else StyleConfig()
    if args.cfg:
        # yaml wins over CLI DEFAULTS (reference OmegaConf merge_with,
        # repaint_person.py:222-224); only flags explicitly present on
        # the command line override it — mirroring run_style.py's
        # argv-presence scan so `--cfg x.yaml` doesn't silently reset
        # yaml fields like denoising_strength or save_dir to defaults
        # resolve which DESTS were explicitly given, using argparse's
        # own option table — this handles '-d0.6' attached short
        # forms and '--denois' prefix abbreviations exactly like
        # argparse itself resolved them (exact match beats prefix)
        opts = ap._option_string_actions
        present = set()
        for a in argv:
            if not a.startswith('-'):
                continue
            t = a.split('=')[0]
            if t in opts:
                present.add(opts[t].dest)
            elif t.startswith('--'):
                cands = {act.dest for o, act in opts.items()
                         if o.startswith('--') and o.startswith(t)}
                if len(cands) == 1:
                    present.add(next(iter(cands)))
            elif len(t) > 2 and t[:2] in opts:
                present.add(opts[t[:2]].dest)   # -d0.6

        def given(dest):
            return dest in present
        if given('url'):
            cfg.url = args.url
        if given('prompt'):
            cfg.style_prompt = args.prompt
        if given('nprompt'):
            cfg.global_nprompt = args.nprompt
        if given('bg_nprompt'):
            cfg.bg_nprompt = args.bg_nprompt
        if given('width') or given('height') \
                or cfg.exact_size is None:
            cfg.exact_size = (args.width, args.height)
        if given('denoising_strength'):
            cfg.denoising_strength = args.denoising_strength
        if given('mask_blur'):
            cfg.mask_blur = args.mask_blur
        if given('fill'):
            cfg.inpainting_fill = INPAINTING_FILL_METHODS.index(args.fill)
        if given('inpaint_full_res'):
            cfg.inpaint_full_res = args.inpaint_full_res
        if given('inpaint_full_res_padding'):
            cfg.inpaint_full_res_padding = args.inpaint_full_res_padding
        if given('save_dir'):
            cfg.save_dir = args.save_dir
        if args.save_intermediate:
            cfg.save_intermediate = True
        if args.to_grey:
            cfg.to_grey = True
        if not args.infer_tagger:
            cfg.apply_fg_tagger = False
        # CLI-assembled ControlNet block fills in what the yaml left
        # unset; yaml sd_params keys win over CLI DEFAULTS (reference
        # merge direction) — but an EXPLICIT CLI flag wins over yaml,
        # as the --cfg help promises
        cfg.sd_params = {**sd_params, **cfg.sd_params}
        for dest, key in (('steps', 'steps'),
                          ('cfg_scale', 'cfg_scale'),
                          ('sample_name', 'sampler_name')):
            if given(dest):
                cfg.sd_params[key] = getattr(args, dest)
        if given('resolution'):
            cn = cfg.sd_params.get('alwayson_scripts', {}) \
                .get('controlnet', {}).get('args')
            if cn:
                cn[0]['processor_res'] = args.resolution
    else:
        cfg.url = args.url
        cfg.style_prompt = args.prompt
        cfg.global_nprompt = args.nprompt
        cfg.bg_nprompt = args.bg_nprompt
        cfg.exact_size = (args.width, args.height)
        cfg.niter = 1
        cfg.apply_fg_tagger = args.infer_tagger
        cfg.denoising_strength = args.denoising_strength
        cfg.mask_blur = args.mask_blur
        cfg.inpainting_fill = INPAINTING_FILL_METHODS.index(args.fill)
        cfg.inpaint_full_res = args.inpaint_full_res
        cfg.inpaint_full_res_padding = args.inpaint_full_res_padding
        cfg.save_dir = args.save_dir
        cfg.save_intermediate = args.save_intermediate
        cfg.to_grey = args.to_grey
        cfg.sd_params = {**sd_params, **cfg.sd_params}
    cfg.apply_bg_tagger = True      # bg tags join the bg prompt

    # directory input (reference uses find_all_imgs); fail fast on an
    # unreadable path instead of crashing later inside cv2.resize
    if osp.isdir(args.img_path):
        paths = [osp.join(args.img_path, f)
                 for f in sorted(os.listdir(args.img_path))
                 if f.lower().endswith(('.jpg', '.jpeg', '.png',
                                        '.webp', '.bmp'))]
        if not paths:
            sys.exit(f'no images found in directory {args.img_path}')
    else:
        paths = [args.img_path]

    def read_or_die(p):
        img = cv2.imread(p)
        if img is None:
            sys.exit(f'cannot read image: {p}')
        return img

    if not args.onebyone:
        editor = StyleEditor(cfg, device=args.device)
        for p in paths:
            saved = editor.repaint_whole(read_or_die(p), Path(p).stem)
            print(f'{p} -> {saved}')
        return

    from .pipeline.segment import AnimeInsSeg
    detector = AnimeInsSeg(device=args.device)
    if args.detector_ckpt:
        detector.load_torch_checkpoint(args.detector_ckpt)
    tagger = None
    if args.infer_tagger:
        try:
            detector.init_tagger()
            tagger = detector.tagger.label_cv2_bgr
        except RuntimeError as e:
            # strict tagger refuses to fabricate tags without a
            # checkpoint; repaint still works, prompts just stay empty
            print(f'tagger unavailable ({e}); continuing untagged',
                  file=sys.stderr)
    editor = StyleEditor(cfg, detector=detector, tagger=tagger)
    for p in paths:
        saved = editor.repaint(read_or_die(p), Path(p).stem)
        print(f'{p} -> {saved}')


if __name__ == '__main__':
    main()
