"""3D Ken Burns CLI of the PyTorch port.

  python -m cartoonsegmentation_torch.run_kenburns \
      --cfg configs/3dkenburns.yaml --input-img photo.png

Writes <save-dir>/<name>.mp4 (a raw <name>.yuv I420 stream where cv2
is missing). The configured detector (AnimeInsSeg with its ISNet
refine in the shipped config) runs unless --no-detector is given.
--verbose also writes the stage images (<save-dir>/tmp_stage_<stage>_
<name>.png); --trace-dir DIR records a torch.profiler trace of the run
into DIR/trace.json (an error when a CUDA run's trace holds no kernel
event).
"""
from __future__ import annotations

import argparse
import os
import os.path as osp


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg', default='configs/3dkenburns.yaml')
    ap.add_argument('--input-img', required=True)
    ap.add_argument('--save-dir', default='workspace/output')
    ap.add_argument('--no-depth-field', action='store_true')
    ap.add_argument('--no-detector', action='store_true',
                    help='skip instance segmentation')
    ap.add_argument('--device', default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         'plain versions of the kernels)')
    ap.add_argument('--seed', type=int, default=0,
                    help='seed of the random weights of nets without a '
                         'checkpoint')
    ap.add_argument('--profile', action='store_true',
                    help='print the per-stage wall-time table when done')
    ap.add_argument('--verbose', action='store_true',
                    help='write the intermediate stage images (depth, '
                         'instances, inpainted views)')
    ap.add_argument('--trace-dir', default='',
                    help='record a torch.profiler trace of the run here '
                         '(trace.json, Chrome trace format)')
    args = ap.parse_args(argv)

    from .config import build_kenburns_cfg
    from .pipeline.kenburns import KenBurnsPipeline
    from .utils.profiling import trace

    cfg = build_kenburns_cfg(args.cfg)
    if args.no_depth_field:
        cfg = cfg.replace(depth_field=False)
    if args.no_detector:
        cfg = cfg.replace(detector='none')
    pipe = KenBurnsPipeline(cfg, seed=args.seed, device=args.device)
    # each stage image is a full-frame copy to the host: only --verbose
    # writes them
    pipe.stage_previews = args.verbose

    os.makedirs(args.save_dir, exist_ok=True)
    name = osp.splitext(osp.basename(args.input_img))[0]
    with trace(args.trace_dir, pipe.device):
        frames = pipe.run(args.input_img,
                          osp.join(args.save_dir, f'{name}.mp4'))
    if args.verbose:
        pipe.save_stages(args.save_dir, name)
    print(f'{len(frames)} frames → {pipe.last_video_path}')
    if args.profile:
        print(pipe.timer.report())


if __name__ == '__main__':
    main()
