"""Detector training CLI of the PyTorch port (the counterpart of the JAX
package's ``scripts/train_detector.py``, with the same flags plus
``--device``):

  python -m cartoonsegmentation_torch.train_detector \
      --ann data/annotations/train.json=data/train \
      --val-ann data/annotations/val.json=data/val \
      --size l --steps 2000 --batch 8 --ckpt-out workspace/det.pt

Ties the training stack together end to end on one device:
  MixedDetDataset (COCO jsons, ignore-mask aware, mosaic/mixup)
  → the train step (DSLA, the RTMDet-Ins loss, K9t's dynamic heads on
    the card), AdamW on warmup + cosine with the global-norm clip
  → EMA weights, periodic checkpoints (``utils/checkpoint.py``),
    metrics.jsonl, the viz hook, COCO-mAP validation through
    ``AnimeInsSeg.infer`` (K8, K9 on the card).
The JAX script's data mesh across devices is not ported: ``--batch``
runs on the one device. Weights start from Flax's default initialisers
drawn from ``--seed`` (``models/rtmdet.py:init_flax_``); the seed also
seeds the data's draws. ``--resume`` loads a checkpoint's raw weights
(and its EMA weights) and starts a new optimizer and schedule, as the
JAX script does.
"""
from __future__ import annotations

import argparse
import os.path as osp
import random
import time

SIZES = {  # RTMDet deepen/widen factors
    'nano': (0.33, 0.125),  # test/smoke size
    'tiny': (0.167, 0.375), 's': (0.33, 0.5), 'm': (0.67, 0.75),
    'l': (1.0, 1.0),
}


def parse_sources(specs):
    from .data.dataset import CocoSource
    out = []
    for spec in specs:
        ann, _, root = spec.partition('=')
        out.append(CocoSource(ann, root or osp.dirname(ann)))
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--ann', action='append', required=True,
                    help='train COCO json, as path.json=img_root '
                         '(repeatable; sources are concatenated)')
    ap.add_argument('--val-ann', default='',
                    help='validation COCO json, same format')
    ap.add_argument('--size', default='l', choices=sorted(SIZES))
    ap.add_argument('--img-size', type=int, default=640)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--steps', type=int, default=1000)
    ap.add_argument('--lr', type=float, default=4e-3)
    ap.add_argument('--weight-decay', type=float, default=0.05)
    ap.add_argument('--warmup', type=int, default=100)
    ap.add_argument('--clip-norm', type=float, default=10.0)
    ap.add_argument('--ema-decay', type=float, default=0.9998,
                    help='EMA decay for the shipped weights (the '
                         'reference RTMDet recipe; 0 disables)')
    ap.add_argument('--max-instances', type=int, default=16)
    ap.add_argument('--mosaic-prob', type=float, default=0.5)
    ap.add_argument('--mixup-prob', type=float, default=0.3)
    ap.add_argument('--ckpt-out', default='workspace/detector.pt')
    ap.add_argument('--save-every', type=int, default=500)
    ap.add_argument('--resume', default='')
    ap.add_argument('--log-every', type=int, default=20)
    ap.add_argument('--val-every', type=int, default=0,
                    help='0 = validate only at the end')
    ap.add_argument('--val-max-images', type=int, default=100)
    ap.add_argument('--viz-dir', default='',
                    help='directory of sample images for the '
                         'visualization hook')
    ap.add_argument('--run-dir', default='',
                    help='experiment dir for metrics.jsonl + viz '
                         'grids (default: <ckpt-out dir>/run)')
    ap.add_argument('--wandb', action='store_true',
                    help='also mirror scalars to wandb when it is '
                         'importable (never required)')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         'plain versions of the kernels)')
    return ap


def ema_state_dict(model, ema_params) -> dict:
    """The model's state dict with each parameter's EMA value (a conv
    shared across levels under each of its keys); BatchNorm buffers the
    trained net's."""
    sd = model.state_dict()
    index = {id(p): i for i, p in enumerate(model.parameters())}
    for name, p in model.named_parameters(remove_duplicate=False):
        sd[name] = ema_params[index[id(p)]].detach()
    return sd


def main(argv=None) -> dict:
    """Train, save, validate. Returns a summary: each logged step's
    scalars and seconds, the validation results, the checkpoint path,
    the device's peak memory."""
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch
    from .data.dataset import MixedDetDataset
    from .device import resolve_device
    from .models.rtmdet import AnimeDetector, init_flax_
    from .parallel import (create_train_state, ema_decay_schedule,
                           ema_update, make_optimizer, make_train_step)
    from .utils.checkpoint import load_params, save_params
    from .utils.logger import LOGGER
    from .utils.tracking import ExperimentTracker

    dev = resolve_device(args.device)
    random.seed(args.seed)
    np.random.seed(args.seed)
    deepen, widen = SIZES[args.size]
    model = AnimeDetector(deepen, widen)
    init_flax_(model, torch.Generator().manual_seed(args.seed))
    resumed_ema = None
    if args.resume:
        LOGGER.info(f'resuming params from {args.resume}')
        restored = load_params(args.resume)
        raw = restored.get('raw_params', restored['params'])
        model.load_state_dict(raw)
        if 'raw_params' in restored:
            resumed_ema = restored['params']
    model = model.to(dev)
    LOGGER.info(f'training on {dev}, batch {args.batch}')
    tx = make_optimizer(args.lr, args.weight_decay, args.warmup, args.steps,
                        args.clip_norm)
    state = create_train_state(model, tx)

    ds = MixedDetDataset(parse_sources(args.ann), img_size=args.img_size,
                         mosaic_prob=args.mosaic_prob,
                         mixup_prob=args.mixup_prob,
                         max_instances=args.max_instances, train=True)
    LOGGER.info(f'train dataset: {len(ds)} images '
                f'({len(args.ann)} source(s))')
    step_fn = make_train_step(tx)

    ema_params = None
    if args.ema_decay > 0:
        if resumed_ema is not None:
            names = dict(model.named_parameters())
            ema_params = [resumed_ema[n].to(dev, torch.float32).clone()
                          for n in names]
        else:
            ema_params = [p.detach().clone() for p in state.params]

    run_dir = args.run_dir or osp.join(
        osp.dirname(args.ckpt_out) or '.', 'run')
    tracker = ExperimentTracker(run_dir, config=vars(args), name='detector',
                                use_wandb=args.wandb)

    viz = None
    if args.viz_dir:
        from .parallel.hooks import InstanceSegVisualizationHook
        viz = InstanceSegVisualizationHook(
            args.viz_dir, out_dir=osp.join(run_dir, 'images'),
            log_fn=None if not args.wandb else tracker.log_image)

    def shipped():
        return ema_state_dict(model, ema_params) if ema_params is not None \
            else model.state_dict()

    def save(tag=''):
        path = args.ckpt_out
        if tag:
            root, ext = osp.splitext(path)
            path = f'{root}_{tag}{ext}'
        # 'params' = the EMA weights (what inference loads; the
        # reference checkpoints carry EMA state); 'raw_params' = the raw
        # trajectory, which --resume continues unsmoothed
        save_params(path, {'params': shipped(),
                           'raw_params': model.state_dict()})
        LOGGER.info(f'saved {path}')
        return path

    seg_cache = []

    def make_infer():
        from .pipeline.segment import AnimeInsSeg
        if not seg_cache:
            seg_cache.append(AnimeInsSeg(det_size=args.img_size,
                                         max_instances=args.max_instances,
                                         device=dev, deepen=deepen,
                                         widen=widen))
        seg = seg_cache[0]
        seg.load_variables(shipped())
        return seg

    summary = {'steps': [], 'val': {}, 'device': str(dev)}

    def validate(step):
        if not args.val_ann:
            if viz is not None:
                viz.before_val(make_infer(), step)
            return
        from .data.metrics import AnimeMangaMetric
        src = parse_sources([args.val_ann])[0]
        seg = make_infer()
        metric = AnimeMangaMetric()
        n = min(len(src), args.val_max_images)
        for i in range(n):
            s = src.load(i)
            ins = seg.infer(s['image'])
            valid = ins.valid.cpu().numpy()
            pred = {
                'bboxes': ins.bboxes.cpu().numpy()[valid],
                'scores': ins.scores.cpu().numpy()[valid],
                'masks': list(ins.masks.cpu().numpy()[valid]),
            }
            gt_xywh = s['boxes'].copy()
            gt_xywh[:, 2:] -= gt_xywh[:, :2]
            gt = {'bboxes': gt_xywh, 'masks': list(s['masks'])}
            metric.update(s['image_id'], pred, gt)
        res = metric.compute()
        for k, v in res.items():
            LOGGER.info(f'step {step} val {k}: '
                        f"mAP={v['mAP']:.4f} mAP50={v['mAP_50']:.4f}")
            tracker.log(v, step, prefix=f'Metrics/{k}/')
        summary['val'][step] = res
        if viz is not None:
            viz.before_val(seg, step)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = last = time.perf_counter()
    for i, batch in enumerate(ds.batches(args.batch, args.steps)):
        metrics = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                  for k, v in batch.items()})
        if ema_params is not None:
            ema_update(ema_params, state.params,
                       ema_decay_schedule(args.ema_decay, state.step))
        step = i + 1
        if step % args.log_every == 0 or step == args.steps:
            m = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            rate = step * args.batch / (now - t0)
            LOGGER.info(f'step {step}/{args.steps} '
                        + ' '.join(f'{k}={v:.4f}' for k, v in m.items())
                        + f' ({rate:.1f} img/s)')
            tracker.log({**m, 'img_per_s': rate}, step, prefix='Train/')
            summary['steps'].append({'step': step, 'seconds': now - last,
                                     **m})
            last = now
        if args.save_every and step % args.save_every == 0 \
                and step < args.steps:
            save(tag=f'step{step}')
        if args.val_every and step % args.val_every == 0 \
                and step < args.steps:
            validate(step)
    sync()
    summary['train_seconds'] = time.perf_counter() - t0
    if dev.type == 'cuda':
        summary['max_memory_allocated'] = torch.cuda.max_memory_allocated(dev)
    summary['ckpt'] = save()
    validate(args.steps)
    tracker.close()
    return summary


if __name__ == '__main__':
    main()
