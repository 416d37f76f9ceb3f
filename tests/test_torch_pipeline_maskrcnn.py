"""The port's Ken Burns path with ``detector: maskrcnn`` and
``discfill_mode: exact`` against the JAX package's, on the CPU in f32.

The small edged Mask R-CNN of tests/test_torch_maskrcnn.py (min-side
64 / max-side 96) is installed on both pipelines through
``set_detector``, with the K11 ray march in the frame loop; LeReS,
Inpaint, the image and the sizes are tests/test_torch_pipeline.py's.
A file of its own, so that a distributed run puts it on another worker
than the other pipeline tests.
"""
import jax
import numpy as np
import pytest
import torch

from cartoonsegmentation_tpu.config import KenBurnsConfig as JConfig
from cartoonsegmentation_tpu.pipeline.kenburns import \
    KenBurnsPipeline as JPipeline
from cartoonsegmentation_torch.config import KenBurnsConfig as TConfig
from cartoonsegmentation_torch.models.convert import (inpaint_from_flax,
                                                      leres_from_flax)
from cartoonsegmentation_torch.models.kenburns import Inpaint as TInpaint
from cartoonsegmentation_torch.models.leres import LeReS as TLeReS
from cartoonsegmentation_torch.pipeline.kenburns import \
    KenBurnsPipeline as TPipeline
from test_torch_maskrcnn import small_detectors
from test_torch_pipeline import (CFG, LAYERS, H, W, _agreement, _image,
                                 _leres_variables, _np, _port_state)
from torch_cpu import torch_threads  # noqa: F401  (autouse)

MRCNN_CFG = dict(CFG, detector='maskrcnn', discfill_mode='exact',
                 max_instances=6, pred_score_thr=0.1)


@pytest.fixture(scope='module')
def both_mrcnn():
    img = _image()
    tdet, jdet = small_detectors(capacity=6)
    jp = JPipeline(JConfig(**MRCNN_CFG), seed=0)
    jp.stage_previews = False
    jp._leres_net, jp._leres_vars = _leres_variables()
    jp.set_detector(jdet)
    inpaint_params = jax.tree_util.tree_map(np.asarray,
                                            jp._vars('inpaint')['params'])
    tp = TPipeline(TConfig(**MRCNN_CFG), device='cpu')
    tp.leres_net = TLeReS(LAYERS)
    tp.leres_net.load_state_dict(leres_from_flax(jp._leres_vars,
                                                 tp.leres_net))
    tp.inpaint_net = TInpaint()
    tp.inpaint_net.load_state_dict(inpaint_from_flax(inpaint_params))
    tp.set_detector(tdet)
    state_j = jp.generate_state(img)
    boxes_j = jp.autozoom(state_j)
    frames_j = jp.process_kenburns(state_j, *boxes_j)
    frames_t = tp.run(img)
    return dict(tp=tp, jp=jp, state_j=state_j, boxes_j=boxes_j,
                frames_j=frames_j, frames_t=frames_t)


def test_maskrcnn_exact_instances(both_mrcnn):
    """The Mask R-CNN instances the depth stage sees: the same valid
    slots (at least 5) and >= 99.9% of mask pixels."""
    ins_t = both_mrcnn['tp'].last_state.instances
    ins_j = both_mrcnn['state_j'].instances
    valid = _np(ins_j.valid)
    assert valid.sum() >= 5 and ins_t.masks.shape == (6, H, W)
    np.testing.assert_array_equal(ins_t.valid.numpy(), valid)
    assert np.abs(ins_t.bboxes.numpy() - _np(ins_j.bboxes)).max() <= 1.0
    same = float((ins_t.masks.numpy() == _np(ins_j.masks)).mean())
    assert same >= 0.999, same
    assert 'detector' in both_mrcnn['tp'].timer.seconds


def test_maskrcnn_exact_frames(both_mrcnn):
    """The clip's frames against the JAX pipeline's at the detector-on
    test's thresholds; rendered from the JAX package's state (its
    instances included, which set the focal planes), >= 99.5% of values
    within 1 LSB."""
    from cartoonsegmentation_torch.instances import Instances
    ft, fj = both_mrcnn['frames_t'], both_mrcnn['frames_j']
    assert ft.shape == fj.shape == (CFG['num_frame'], H, W, 3)
    close1, mean = _agreement(ft, fj)
    close6, _ = _agreement(ft, fj, lsb=6)
    assert close1 >= 0.98 and close6 >= 0.99 and mean < 0.5, \
        (close1, close6, mean)
    tp, jp, sj = both_mrcnn['tp'], both_mrcnn['jp'], both_mrcnn['state_j']
    boxes = both_mrcnn['boxes_j']
    ij = sj.instances
    st = _port_state(sj).replace(instances=Instances(
        *(torch.from_numpy(np.array(getattr(ij, k)))
          for k in ('masks', 'bboxes', 'scores', 'valid'))))
    st = tp.inpaint_extremes(st, *boxes)
    sj = jp.inpaint_extremes(sj, *boxes)
    steps = [0.0, 0.5, 1.0]
    close1, mean = _agreement(tp.render_frames(st, *boxes, steps),
                              jp.render_frames(sj, *boxes,
                                               np.asarray(steps)))
    assert close1 >= 0.995 and mean < 0.1, (close1, mean)
