"""Depth-estimation CLI of the PyTorch port (the upstream 3D-Ken-Burns
depth tool; port of the JAX package's ``scripts/estimate_depth.py``).

  python -m cartoonsegmentation_torch.estimate_depth --in photo.png \
      --out depth.npy [--depth-est default|leres|leres_boost|zoe|zoe_nk|marigold]

For 'default' the reference chain (depthestim.py:60-78): the disparity
net at its grid, Refine guided by the image resized (no antialias) to 4x
that grid, the disparity resized to the image and scaled by
max(H, W) / 256, depth = focal · baseline / (disparity + 1e-7) with
focal = max(H, W) / 2 and baseline 40. For 'leres', 'leres_boost',
'zoe', 'zoe_nk' and 'marigold' the pipeline's conversion: the disparity
normalised to the baseline, depth = focal · baseline / (disparity +
1e-5). ``--zoe-ckpt`` loads ZoeD_M12_N.pt or ZoeD_M12_NK.pt. <out> gets
the float32 depth (.npy) and the sibling .png the disparity / baseline ·
255 as uint8.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

BASELINE = 40.0
ESTIMATORS = ('default', 'leres', 'leres_boost', 'zoe', 'zoe_nk', 'marigold')


def depthestim(pipe, img_bgr: np.ndarray):
    """BGR uint8 image → (disparity f32 (H, W), depth f32 (H, W)) on the
    host, both at image resolution, by ``pipe.cfg.depth_est``."""
    from .ops.pointcloud import true_div
    from .utils.image import resize_bilinear
    H, W = img_bgr.shape[:2]
    image = torch.from_numpy(img_bgr.astype(np.float32) / 255.0).to(
        pipe.device)
    focal = max(H, W) / 2.0
    if pipe.cfg.depth_est == 'default':
        disp = pipe._est_default(image)                   # (dh, dw, 1)
        dh, dw = disp.shape[:2]
        guide = resize_bilinear(image, dh * 4, dw * 4)
        disp = pipe._refine_disparity(guide, disp)
        disp = resize_bilinear(disp, H, W) * (max(H, W) / 256.0)
        depth = true_div(focal * BASELINE, disp + 1e-7)
    else:
        disp = pipe._estimate_disparity(image)            # image resolution
        disp = disp / (disp.max() + 1e-12) * BASELINE
        depth = true_div(focal * BASELINE, disp + 1e-5)
    return disp[..., 0].cpu().numpy(), depth[..., 0].cpu().numpy()


def save_outputs(disp: np.ndarray, depth: np.ndarray, out: str):
    """The depth to <out> (.npy), disparity / baseline · 255 as uint8 to
    the sibling .png; (npy path, png path)."""
    import cv2
    png = out.replace('.npy', '.png') if out.endswith('.npy') \
        else out + '.png'
    cv2.imwrite(png, np.clip(disp / BASELINE * 255.0, 0.0,
                             255.0).astype(np.uint8))
    np.save(out, depth)
    return out if out.endswith('.npy') else out + '.npy', png


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--in', dest='input', required=True,
                    help='input image path')
    ap.add_argument('--out', default='./depthestim.npy',
                    help='output .npy path (a .png disparity preview is '
                         'written next to it)')
    ap.add_argument('--depth-est', default='default', choices=ESTIMATORS)
    ap.add_argument('--cfg', default=None,
                    help='optional kenburns yaml for estimator knobs')
    ap.add_argument('--disparity-ckpt', default=None)
    ap.add_argument('--refine-ckpt', default=None)
    ap.add_argument('--vgg-ckpt', default=None)
    ap.add_argument('--leres-ckpt', default=None)
    ap.add_argument('--zoe-ckpt', default=None)
    ap.add_argument('--device', default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         'CPU)')
    ap.add_argument('--seed', type=int, default=0,
                    help='seed of the random weights of nets without a '
                         'checkpoint')
    args = ap.parse_args(argv)

    import cv2
    from .config import KenBurnsConfig, build_kenburns_cfg
    from .pipeline.kenburns import KenBurnsPipeline

    cfg = build_kenburns_cfg(args.cfg) if args.cfg else KenBurnsConfig()
    cfg = cfg.replace(depth_est=args.depth_est, detector='none')
    pipe = KenBurnsPipeline(cfg, seed=args.seed, device=args.device)
    if args.disparity_ckpt or args.refine_ckpt or args.vgg_ckpt:
        pipe.load_torch_checkpoints(disparity=args.disparity_ckpt,
                                    refine=args.refine_ckpt,
                                    vgg=args.vgg_ckpt)
    if args.leres_ckpt:
        pipe.load_leres_checkpoint(args.leres_ckpt)
    if args.zoe_ckpt:
        pipe.load_zoe_checkpoint(args.zoe_ckpt)

    img = cv2.imread(args.input, cv2.IMREAD_COLOR)
    if img is None:
        raise SystemExit(f'cannot read {args.input}')
    disp, depth = depthestim(pipe, img)
    npy, png = save_outputs(disp, depth, args.out)
    print(f'wrote {npy} and {png} (depth range {depth.min():.3f}..'
          f'{depth.max():.3f})')


if __name__ == '__main__':
    main()
