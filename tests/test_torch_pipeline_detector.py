"""The port's Ken Burns path with the shipped default's detector on
(AnimeInsSeg: RTMDet-Ins at det_size 128, deepen 0.33 / widen 0.25,
with the full-width ISNet refine at refine_size 64) against the JAX
package's, on the CPU in f32: its instances, the instance-adjusted
disparity, the autozoom cell and the frames.

LeReS, Inpaint, the image and the sizes are
tests/test_torch_pipeline.py's. A file of its own, so that a
distributed run puts it on another worker than the detector-free
pipeline tests.
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
from test_torch_pipeline import (CFG, LAYERS, H, W, _agreement, _image,
                                 _leres_variables, _np)
from torch_cpu import torch_threads  # noqa: F401  (autouse)

DET_CFG = dict(CFG, detector='animeinsseg', det_size=128, refine_size=64,
               max_instances=20)


@pytest.fixture(scope='module')
def both_det():
    from cartoonsegmentation_tpu.models.convert_rtmdet import convert_rtmdet
    from cartoonsegmentation_tpu.models.isnet import convert_isnet
    from cartoonsegmentation_tpu.models.rtmdet import \
        AnimeDetector as JDetector
    from cartoonsegmentation_tpu.pipeline.refine import \
        ISNetRefiner as JRefiner
    from cartoonsegmentation_tpu.pipeline.segment import AnimeInsSeg as JSeg
    from cartoonsegmentation_torch.models.isnet import ISNetDIS
    from cartoonsegmentation_torch.models.rtmdet import \
        AnimeDetector as TDetector
    from test_torch_detector import randomize

    def numpy_sd(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}
    img = _image()
    # detector and refine weights made in the port, carried to Flax by
    # the JAX package's checkpoint converters
    tdet = randomize(TDetector(0.33, 0.25), 0)
    tisnet = randomize(ISNetDIS(in_ch=4), 3)
    with torch.no_grad():
        tisnet.side1.weight *= 10.0

    jp = JPipeline(JConfig(**DET_CFG), seed=0)
    jp.stage_previews = False
    jp._leres_net, jp._leres_vars = _leres_variables()
    jseg = JSeg(det_size=128, mask_thr=0.3, max_instances=20, dtype=None)
    jseg.model = JDetector(0.33, 0.25)
    jseg._variables = convert_rtmdet(numpy_sd(tdet), 0.33, 0.25)
    jseg.refine = JRefiner(refine_size=64, mask_thr=0.3, dtype=None)
    jseg.refine._variables = convert_isnet(numpy_sd(tisnet))
    jp.set_detector(jseg)
    inpaint_params = jax.tree_util.tree_map(np.asarray,
                                            jp._vars('inpaint')['params'])

    tp = TPipeline(TConfig(**DET_CFG), device='cpu')
    tp.leres_net = TLeReS(LAYERS)
    tp.leres_net.load_state_dict(leres_from_flax(jp._leres_vars,
                                                 tp.leres_net))
    tp.inpaint_net = TInpaint()
    tp.inpaint_net.load_state_dict(inpaint_from_flax(inpaint_params))
    tp.ensure_detector()
    tp._detector.model = tdet
    tp._detector.refine.net = tisnet

    state_j = jp.generate_state(img)
    boxes_j = jp.autozoom(state_j)
    frames_j = jp.process_kenburns(state_j, *boxes_j)
    frames_t = tp.run(img)
    return dict(tp=tp, state_j=state_j, boxes_j=boxes_j, frames_j=frames_j,
                frames_t=frames_t)


def test_detector_on_instances(both_det):
    """The refined instances the depth stage sees: the same valid slots
    and boxes, >= 99.9% of mask pixels (f32 conv noise flips pixels at
    the 0.3 thresholds of the mask head and the refine)."""
    ins_t = both_det['tp'].last_state.instances
    ins_j = both_det['state_j'].instances
    valid = _np(ins_j.valid)
    assert valid.any() and ins_t.masks.shape == (20, H, W)
    np.testing.assert_array_equal(ins_t.valid.numpy(), valid)
    np.testing.assert_array_equal(ins_t.bboxes.numpy(), _np(ins_j.bboxes))
    same = float((ins_t.masks.numpy() == _np(ins_j.masks)).mean())
    assert same >= 0.999, same
    assert _np(ins_j.masks)[valid].any(axis=(1, 2)).all()
    assert 'detector' in both_det['tp'].timer.seconds


def test_detector_on_depth_and_frames(both_det):
    """The instance-adjusted disparity at the detector-free test's
    bounds, the same autozoom cell, and the frames at its thresholds."""
    st_t, st_j = both_det['tp'].last_state, both_det['state_j']
    disp_t = st_t.disparity[..., 0].numpy()
    disp_j = _np(st_j.disparity[..., 0])
    assert (np.abs(disp_t - disp_j) <= 1e-4).mean() >= 0.99
    (_, to_t), (_, to_j) = both_det['tp'].last_boxes, both_det['boxes_j']
    assert (to_t['crop_w'], to_t['crop_h']) == (to_j['crop_w'],
                                                 to_j['crop_h'])
    ft, fj = both_det['frames_t'], both_det['frames_j']
    assert ft.shape == fj.shape == (CFG['num_frame'], H, W, 3)
    close1, mean = _agreement(ft, fj)
    close6, _ = _agreement(ft, fj, lsb=6)
    assert close1 >= 0.98 and close6 >= 0.99 and mean < 0.5, \
        (close1, close6, mean)
