"""Batch 3D Ken Burns over a directory with the PyTorch port (the
reference's run_kenburns_batch.py).

  python -m cartoonsegmentation_torch.run_kenburns_batch \\
      --cfg configs/3dkenburns.yaml --input-dir pics --save-dir out

Writes <save-dir>/<name>.mp4 for each image of the directory (a raw
<name>.yuv I420 stream where cv2 is missing). One pipeline serves every
image; its nets are made once. Runs on CUDA unless --device cpu.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg', default='configs/3dkenburns.yaml')
    ap.add_argument('--input-dir', required=True)
    ap.add_argument('--save-dir', default='workspace/output')
    ap.add_argument('--no-detector', action='store_true',
                    help='skip instance segmentation (the reference '
                         'always segments)')
    ap.add_argument('--device', default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         'plain versions of the kernels)')
    ap.add_argument('--seed', type=int, default=0,
                    help='seed of the random weights of nets without a '
                         'checkpoint')
    args = ap.parse_args(argv)

    from .config import build_kenburns_cfg
    from .pipeline import KenBurnsPipeline

    cfg = build_kenburns_cfg(args.cfg)
    if args.no_detector:
        cfg = cfg.replace(detector='none')
    pipe = KenBurnsPipeline(cfg, seed=args.seed, device=args.device)
    pipe.ensure_detector()

    os.makedirs(args.save_dir, exist_ok=True)
    imgs = sorted(
        osp.join(args.input_dir, f) for f in os.listdir(args.input_dir)
        if f.lower().endswith(('.jpg', '.jpeg', '.png', '.webp')))
    for p in imgs:
        name = osp.splitext(osp.basename(p))[0]
        # run(img, path) streams: each chunk's transfer and encode
        # overlap the next chunk's render
        frames = pipe.run(p, osp.join(args.save_dir, f'{name}.mp4'))
        print(f'{p} -> {pipe.last_video_path} ({len(frames)} frames)')


if __name__ == '__main__':
    main()
