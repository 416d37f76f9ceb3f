"""Interactive Ken Burns server of the PyTorch port (the reference's
naive_interface.py; stdlib HTTP, routes in serving/interface.py, the
browser UI at /).

  python -m cartoonsegmentation_torch.naive_interface \\
      --cfg configs/3dkenburns.yaml --port 8080 [--with-detector]

Runs on CUDA unless --device cpu is given; nets without a checkpoint
get random weights from --seed.
"""
from __future__ import annotations

import argparse


def main(argv=None, block: bool = True):
    """Parse ``argv`` and serve. With ``block`` False the server runs
    in a thread of its own and is returned (``srv.shutdown()`` stops
    it); ``--port 0`` takes a free port (``srv.server_address``)."""
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg', default='configs/3dkenburns.yaml')
    ap.add_argument('--host', default='0.0.0.0')
    ap.add_argument('--port', type=int, default=8080)
    ap.add_argument('--with-detector', action='store_true',
                    help='enable the /segment route + UI tab')
    ap.add_argument('--det-ckpt', default='',
                    help='torch checkpoint for the detector')
    ap.add_argument('--device', default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         'plain versions of the kernels)')
    ap.add_argument('--seed', type=int, default=0,
                    help='seed of the random weights of nets without a '
                         'checkpoint')
    args = ap.parse_args(argv)

    from .pipeline import AnimeInsSeg, KenBurnsPipeline
    from .serving.interface import serve

    pipe = KenBurnsPipeline(args.cfg, seed=args.seed, device=args.device)
    segmentor = None
    if args.with_detector:
        segmentor = AnimeInsSeg(seed=args.seed, device=pipe.device)
        if args.det_ckpt:
            segmentor.load_torch_checkpoint(args.det_ckpt)
    return serve(pipe, args.host, args.port, block=block,
                 segmentor=segmentor)


if __name__ == '__main__':
    main()
