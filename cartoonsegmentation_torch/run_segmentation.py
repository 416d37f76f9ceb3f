"""Instance segmentation CLI of the PyTorch port.

  python -m cartoonsegmentation_torch.run_segmentation \
      --input photo.png --save-dir out [--detector sam|maskrcnn] \
      [--save-json a.json]

Runs AnimeInsSeg (or its boxes re-masked by SAM with ``--detector
sam``, or torchvision's COCO Mask R-CNN with ``--detector maskrcnn``)
on an image or every image of a directory, writes each image with its
instances drawn to --save-dir, and with --save-json the COCO-style
annotations (compressed RLE masks). Nets without a checkpoint have
random weights made from a fixed seed. Needs cv2 to read, draw and
write the images.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--input', required=True, help='image file or dir')
    ap.add_argument('--save-dir', default='workspace/output')
    ap.add_argument('--ckpt', default='',
                    help='torch rtmdetl checkpoint of the box detector, or '
                         'the torchvision Mask R-CNN one with --detector '
                         'maskrcnn')
    ap.add_argument('--score-thr', type=float, default=0.3)
    ap.add_argument('--det-size', type=int, default=640)
    ap.add_argument('--detector', default='animeinsseg',
                    choices=('animeinsseg', 'sam', 'maskrcnn'),
                    help="'sam' re-masks the AnimeInsSeg boxes with SAM; "
                         "'maskrcnn' is the COCO model")
    ap.add_argument('--sam-ckpt', default='',
                    help='official sam_vit_*.pth')
    ap.add_argument('--save-json', default='',
                    help='write COCO-style annotations here')
    ap.add_argument('--device', default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         'plain versions of the kernels)')
    args = ap.parse_args(argv)

    import cv2
    from .data.coco_export import instances_to_coco
    from .pipeline.segment import AnimeInsSeg
    from .utils.constants import CATEGORIES

    if args.detector == 'maskrcnn':
        from .pipeline.maskrcnn_det import MaskRCNNDetector
        seg = MaskRCNNDetector(device=args.device)
    else:
        seg = AnimeInsSeg(det_size=args.det_size, device=args.device)
    if args.ckpt:
        seg.load_torch_checkpoint(args.ckpt)
    if args.detector == 'sam':
        from .pipeline.sam import SamDetector
        seg = SamDetector(seg)
        if args.sam_ckpt:
            seg.sam.load_torch_checkpoint(args.sam_ckpt)

    if osp.isdir(args.input):
        imgs = sorted(
            osp.join(args.input, f) for f in os.listdir(args.input)
            if f.lower().endswith(('.jpg', '.jpeg', '.png', '.webp')))
    else:
        imgs = [args.input]

    os.makedirs(args.save_dir, exist_ok=True)
    images_meta, annotations = [], []
    for ii, path in enumerate(imgs):
        img = cv2.imread(path)
        ins = seg.infer(img, pred_score_thr=args.score_thr)
        out = osp.join(args.save_dir, osp.basename(path))
        cv2.imwrite(out, ins.draw(img))
        print(f'{path}: {int(ins.count())} instances -> {out}')
        if args.save_json:
            im_meta, anns = instances_to_coco(ins, ii, osp.basename(path),
                                              img.shape[:2],
                                              obj_id_start=len(annotations))
            images_meta.append(im_meta)
            annotations.extend(anns)

    if args.save_json:
        with open(args.save_json, 'w') as f:
            json.dump({'info': {}, 'licenses': [], 'images': images_meta,
                       'annotations': annotations, 'categories': CATEGORIES},
                      f)
        print(f'annotations -> {args.save_json}')


if __name__ == '__main__':
    main()
