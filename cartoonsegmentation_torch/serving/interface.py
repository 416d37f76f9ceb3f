"""Interactive Ken Burns server of the port (stdlib HTTP, no flask
dependency; port of ``cartoonsegmentation_tpu/serving/interface.py``).

Parity: reference naive_interface.py:63-215 —
- POST /load_image        multipart/raw image → precompute device state
- GET  /get_live?fltTime= render ONE frame from the cached point
                          cloud (no inpaint), per-time frame cache
- POST /update_from,/update_to  move the camera boxes, drop the cache
- GET  /get_result        full inpainted render → mp4 bytes
- GET  /path_overlay?fltTime=  camera-path scrub preview: from/to
                          boxes + trajectory + the interpolated crop
                          rectangle at t (stepping-tab math,
                          Component_AIS.py:1424-1696)

Key property preserved: state generation (seg + depth + points)
happens once per image; live preview renders single frames from the
cached device state (naive_interface.py:132-173).

Requests arrive on the server's handler threads. The service's RLock
serialises the device work, and each service method that runs it
enters ``torch.inference_mode`` itself: the mode is per thread, and
the state's tensors made in one request are updated in place in
another.
"""
from __future__ import annotations

import base64
import json
import os
import os.path as osp
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..utils import LOGGER


def _center_to_corner(cx, cy, cw, ch):
    """Center+crop → integer corner points. Parity:
    Component_AIS.py:1635-1658 (ConvertLocation_From_Center_To_Corner:
    corners are center ± round(crop/2))."""
    hw, hh = int(round(cw / 2.0)), int(round(ch / 2.0))
    cx, cy = int(round(cx)), int(round(cy))
    return cx - hw, cy - hh, cx + hw, cy + hh


def _centralise_box(cx, cy, cw, ch, W, H):
    """Shift the camera center the minimal amount that brings the
    crop rectangle fully inside the image. Parity:
    Component_AIS.py:1660-1696 (Centralise_Camera)."""
    x1, y1, x2, y2 = _center_to_corner(cx, cy, cw, ch)
    if x1 < 0:
        cx += -x1
    elif x2 > W:
        cx += W - x2
    if y1 < 0:
        cy += -y1
    elif y2 > H:
        cy += H - y2
    return cx, cy


def _box_detector(det):
    """The AnimeInsSeg box detector inside a detector family, if any
    ('animeinsseg' IS one; 'sam' wraps one; 'maskrcnn' has none)."""
    from ..pipeline.sam import SamDetector
    from ..pipeline.segment import AnimeInsSeg
    if isinstance(det, AnimeInsSeg):
        return det
    if isinstance(det, SamDetector) \
            and isinstance(det.box_detector, AnimeInsSeg):
        return det.box_detector
    return None


class KenBurnsService:
    """Pipeline wrapper holding per-image cached state."""

    def __init__(self, pipeline, segmentor=None):
        self.pipe = pipeline
        self.segmentor = segmentor
        self.state = None
        self.pristine_state = None   # pre-inpaint state for box edits
        self.img: Optional[np.ndarray] = None
        self.obj_from: Optional[Dict] = None
        self.obj_to: Optional[Dict] = None
        self.frame_cache: Dict[float, bytes] = {}
        self.inpainted = False   # passes run for the CURRENT boxes
        # RLock: stage_list() is called both from handlers that
        # already hold the lock (load_image, step_inpaint) and bare
        # from GET /stages; it must itself lock against
        # generate_state's stages.clear()+insert on another thread
        self.lock = threading.RLock()
        # MJPEG playback state (naive_interface.py:27-34,131-173)
        self.times = np.linspace(0.0, 1.0,
                                 pipeline.cfg.num_frame).tolist()
        self.int_time = 0
        self.mode = 'automatic'

    def load_image(self, img_bytes: bytes) -> Dict:
        import cv2
        arr = np.frombuffer(img_bytes, np.uint8)
        img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError('could not decode image')
        with self.lock, torch.inference_mode():
            self.state = self.pipe.generate_state(img)
            self.pristine_state = self.state
            self.obj_from, self.obj_to = self.pipe.autozoom(self.state)
            self.img = self.pipe.stages.get('input')
            if self.img is None:
                self.img = img
            self.frame_cache.clear()
            self.inpainted = False
            self.times = np.linspace(
                0.0, 1.0, self.pipe.cfg.num_frame).tolist()
            self.int_time = 0
            H, W = self.state.hw
        return {'height': int(H), 'width': int(W),
                'objFrom': self.obj_from, 'objTo': self.obj_to,
                'stages': self.stage_list()}

    # -- per-stage stepping (reference stepping-demonstration tab:
    # Web_UI/Component/Component_AIS.py:493-787 runs the pipeline
    # stage by stage — segmentation, disparity estimation, coarse
    # depth, adjusted/refined depth, inpainted cloud — and previews
    # each; here generate_state records the same intermediates in
    # pipe.stages and these routes expose them one step at a time) --
    _STAGE_ORDER = ('input', 'instances', 'depth_coarse',
                    'depth_adjusted', 'depth_final')

    def stage_list(self):
        """Stage names in PIPELINE order (input → instances → depth
        stages → inpainted clouds by growing point count) so the
        stepping prev/next buttons walk the documented stage flow."""
        with self.lock:
            keys = set(self.pipe.stages.keys())
        out = [k for k in self._STAGE_ORDER if k in keys]
        inp = sorted((k for k in keys if k.startswith('inpainted_')),
                     key=lambda k: int(k.rsplit('_', 1)[1]))
        rest = sorted(keys - set(out) - set(inp))
        return out + inp + rest

    def stage_image(self, name: str) -> bytes:
        import cv2
        with self.lock:
            if name not in self.pipe.stages:
                raise ValueError(
                    f'no stage {name!r}; have {self.stage_list()}')
            img = np.asarray(self.pipe.stages[name])
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        ok, enc = cv2.imencode('.jpg', img,
                               [cv2.IMWRITE_JPEG_QUALITY, 90])
        return enc.tobytes()

    def autozoom_preview(self) -> bytes:
        """Input image with the from (green) / to (red) camera crop
        boxes drawn — the reference's HighLight_Crop_AutoZoom preview
        (Component_AIS.py:1698-1741)."""
        import cv2
        with self.lock:
            if self.state is None or self.img is None:
                raise ValueError('no image loaded')
            img = np.ascontiguousarray(self.img).copy()
            boxes = ((self.obj_from, (0, 200, 0)),
                     (self.obj_to, (0, 0, 220)))
            for obj, color in boxes:
                x1 = int(round(obj['center_u'] - obj['crop_w'] / 2))
                y1 = int(round(obj['center_v'] - obj['crop_h'] / 2))
                x2 = x1 + int(obj['crop_w'])
                y2 = y1 + int(obj['crop_h'])
                cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
            cv2.putText(img, 'from', (8, 24),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 200, 0), 2)
            cv2.putText(img, 'to', (8, 48),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 0, 220), 2)
        ok, enc = cv2.imencode('.jpg', img,
                               [cv2.IMWRITE_JPEG_QUALITY, 90])
        return enc.tobytes()

    def path_overlay(self, t: float) -> bytes:
        """Input image with the camera PATH drawn: the from (green) /
        to (red) crop boxes, the camera-center trajectory polyline
        across the whole clip, and the interpolated crop rectangle at
        scrub position ``t`` (white, thick) — centralise-clamped into
        the image. This is the reference stepping tab's live scrub
        preview. Parity: Web_UI/Component/Component_AIS.py:1424-1509
        (DoOnImageBox_Stepping_TabSelecting → HighLight_Crop_Using_*)
        and :1582-1696 (HighLight_Crop_Core,
        ConvertLocation_From_Center_To_Corner, Centralise_Camera)."""
        import cv2
        with self.lock:
            if self.state is None or self.img is None:
                raise ValueError('no image loaded')
            img = np.ascontiguousarray(self.img).copy()
            obj_from, obj_to = dict(self.obj_from), dict(self.obj_to)
            n = max(int(self.pipe.cfg.num_frame), 2)
        H, W = img.shape[:2]
        t = min(max(float(t), 0.0), 1.0)

        def lerp_box(tt):
            # same lerp as the render camera (kenburns._camera_params)
            fr = 1.0 - tt
            cw = fr * obj_from['crop_w'] + tt * obj_to['crop_w']
            ch = fr * obj_from['crop_h'] + tt * obj_to['crop_h']
            cx = fr * obj_from['center_u'] + tt * obj_to['center_u']
            cy = fr * obj_from['center_v'] + tt * obj_to['center_v']
            cx, cy = _centralise_box(cx, cy, cw, ch, W, H)
            return cx, cy, cw, ch

        pts = np.asarray([lerp_box(tt)[:2]
                          for tt in np.linspace(0.0, 1.0, n)])
        cv2.polylines(img, [np.round(pts).astype(np.int32)], False,
                      (200, 200, 60), 1, cv2.LINE_AA)
        for obj, color in ((obj_from, (0, 200, 0)),
                           (obj_to, (0, 0, 220))):
            cx, cy = _centralise_box(
                obj['center_u'], obj['center_v'],
                obj['crop_w'], obj['crop_h'], W, H)
            x1, y1, x2, y2 = _center_to_corner(
                cx, cy, obj['crop_w'], obj['crop_h'])
            cv2.rectangle(img, (x1, y1), (x2, y2), color, 1)
        cx, cy, cw, ch = lerp_box(t)
        x1, y1, x2, y2 = _center_to_corner(cx, cy, cw, ch)
        cv2.rectangle(img, (x1, y1), (x2, y2), (255, 255, 255), 2)
        cv2.circle(img, (int(round(cx)), int(round(cy))), 3,
                   (255, 255, 255), -1)
        cv2.putText(img, f't={t:.2f}', (8, 24),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 2)
        ok, enc = cv2.imencode('.jpg', img,
                               [cv2.IMWRITE_JPEG_QUALITY, 90])
        return enc.tobytes()

    def step_inpaint(self) -> Dict:
        """Stepping tab: run the two inpaint passes on the cached
        state so the inpainted-cloud previews (stages inpainted_N)
        become available before encoding; the inpainted state is kept
        so /get_result reuses it. Always starts from the PRISTINE
        (pre-inpaint) state — the stored state may hold passes for
        previous camera boxes, and stacking on those would leave stale
        inpainted content in the cloud."""
        with self.lock, torch.inference_mode():
            if self.state is None:
                raise ValueError('no image loaded')
            st = self.pipe.inpaint_extremes(
                self.pristine_state, self.obj_from, self.obj_to)
            self.state = st
            self.inpainted = True
            self.frame_cache.clear()   # cached frames are pre-inpaint
        return {'ok': True, 'stages': self.stage_list()}

    # keys the /config route may switch at runtime; everything else
    # would invalidate loaded weights or needs a fresh pipeline object
    CONFIG_KEYS = ('depth_est', 'inpaint_type', 'depth_field',
                   'num_frame', 'max_size', 'discfill_mode',
                   'dof_num_samples', 'depthest_use_medium',
                   'marigold_steps', 'marigold_ensemble',
                   'marigold_scheduler', 'ldm_inpaint_size',
                   'detector', 'depth_factor', 'auto_zoom')

    def set_config(self, payload: Dict) -> Dict:
        """Rebuild the pipeline with updated config knobs, carrying
        over any loaded weights; drops the cached image state."""
        from ..pipeline import KenBurnsPipeline
        kw = {k: payload[k] for k in self.CONFIG_KEYS if k in payload}
        changed_live = []
        if 'stage_previews' in payload:
            # the Setting tab's Verbose knob (reference
            # Component_AIS.py:2738-2775): toggles whether pipeline
            # stages keep full-frame preview copies for the stepping
            # tab — a pipeline attribute, no rebuild needed
            want = bool(payload['stage_previews'])
            if want != self.pipe.stage_previews:
                self.pipe.stage_previews = want
                changed_live.append('stage_previews')
        if not kw:
            return {'ok': True, 'changed': changed_live}
        marigold_changed = any(k.startswith('marigold_') for k in kw)
        with self.lock:
            old = self.pipe
            new = KenBurnsPipeline(old.cfg.replace(**kw), seed=old._seed,
                                   device=old.device)
            # stage_previews is a pipeline ATTRIBUTE, not a cfg key: a
            # fresh pipeline resets it to its default, so a payload
            # combining the Verbose knob with any rebuild key (the
            # webui cfgApply always sends both) would silently lose
            # the toggle. `old` already carries the applied value —
            # the live branch above ran first — so copy it across.
            new.stage_previews = old.stage_previews
            # carry the nets + heavyweight sub-models across; the
            # Marigold model bakes its sampler knobs at construction,
            # so when a marigold_* key changes it must be REBUILT from
            # the new cfg with the old weights moved in — carrying the
            # object would silently keep the old steps/scheduler
            carry = ['disparity_net', 'refine_net', 'inpaint_net',
                     'leres_net', 'p2p_net', 'zoe_net', '_zoe_ckpt_path',
                     '_zoe_ckpt_is_nk', 'ldm_inpainter']
            # the detector family object only survives if the
            # 'detector' knob itself didn't change; when it DID
            # change and a detector was in use, build the new family
            # NOW — generate_state only checks `_detector is not
            # None`, so dropping without rebuilding would silently
            # disable segmentation
            if kw.get('detector', old.cfg.detector) \
                    == old.cfg.detector:
                carry.append('_detector')
            elif old._detector is not None:
                new.ensure_detector()
                # both the 'animeinsseg' and 'sam' families carry an
                # AnimeInsSeg box detector — transfer its loaded
                # weights across the switch so a runtime family
                # change doesn't silently fall back to random init
                ob = _box_detector(old._detector)
                nb = _box_detector(new._detector)
                if ob is not None and nb is not None \
                        and ob.model is not None:
                    nb._shape = ob._shape
                    nb.load_variables(ob.model.state_dict())
            if not marigold_changed:
                carry.append('marigold')
            for attr in carry:
                if getattr(old, attr, None) is not None:
                    setattr(new, attr, getattr(old, attr))
            if marigold_changed and old.marigold is not None:
                _move_marigold_weights(old.marigold, new._ensure_marigold())
            self.pipe = new
            self.state = self.pristine_state = None
            self.obj_from = self.obj_to = None
            self.frame_cache.clear()
        return {'ok': True, 'changed': sorted(kw) + changed_live}

    def update_box(self, which: str, box: Dict) -> None:
        with self.lock:
            tgt = dict(self.obj_from if which == 'from' else self.obj_to)
            for k in ('center_u', 'center_v', 'crop_w', 'crop_h'):
                if k in box:
                    tgt[k] = box[k]
            if which == 'from':
                self.obj_from = tgt
                self.int_time = 0           # jump stream to t=0.0
            else:
                self.obj_to = tgt
                self.int_time = len(self.times) - 1   # ... to t=1.0
            self.frame_cache.clear()
            self.inpainted = False      # extremes moved: new passes
            # drop inpaint points generated for the OLD extremes —
            # /get_result would otherwise render stale content in the
            # regions those passes filled (naive_interface.py:108-129
            # equally re-derives everything from the pristine cloud)
            if self.pristine_state is not None:
                self.state = self.pristine_state

    def set_mode(self, mode: str) -> None:
        """Playback mode: 'automatic' advances t each streamed frame,
        'manual' holds the current frame (naive_interface.py:100-105)."""
        if mode not in ('automatic', 'manual'):
            raise ValueError(f'unknown mode {mode!r}')
        with self.lock:
            self.mode = mode

    def mjpeg_parts(self):
        """Infinite multipart/x-mixed-replace frame generator at the
        output fps, reusing the per-t JPEG cache; gray placeholder
        before an image is loaded (naive_interface.py:131-173)."""
        import time

        import cv2
        header = b'--frame\r\nContent-Type: image/jpeg\r\n\r\n'
        limiter = 0.0
        while True:
            time.sleep(max(0.0, (1.0 / 25.0) - (time.time() - limiter)))
            limiter = time.time()
            with self.lock:
                if self.state is None:
                    t = None
                else:
                    if self.int_time > len(self.times) - 1:
                        self.int_time = 0
                    t = float(self.times[self.int_time])
                    if self.mode == 'automatic':
                        self.int_time += 1
            if t is None:
                blank = np.full((768, 1024, 3), 29, np.uint8)
                _, enc = cv2.imencode('.jpg', blank,
                                      [cv2.IMWRITE_JPEG_QUALITY, 80])
                yield header + enc.tobytes() + b'\r\n'
                continue
            yield header + self.live_frame(t) + b'\r\n'

    def live_frame(self, t: float) -> bytes:
        """One JPEG frame at interpolation time t (no inpaint)."""
        import cv2
        with self.lock, torch.inference_mode():
            if self.state is None:
                raise ValueError('no image loaded')
            key = round(float(t), 4)
            if key in self.frame_cache:
                return self.frame_cache[key]
            frames = self.pipe.render_frames(
                self.state, self.obj_from, self.obj_to,
                np.asarray([key], np.float32), depth_field=False)
            ok, enc = cv2.imencode('.jpg', frames[0],
                                   [cv2.IMWRITE_JPEG_QUALITY, 80])
            data = enc.tobytes()
            self.frame_cache[key] = data
            return data

    def frames_gallery(self, n: int = 6) -> Dict:
        """n preview frames stepped along the camera path, as b64
        JPEGs — the reference stepping tab's "Generate Camera View"
        batched output box (Component_AIS.py:1052-1262 →
        Create_Output_BatchedImageBox gallery, :420-434). Renders
        through live_frame so every position reuses the per-t frame
        cache."""
        n = max(2, min(int(n), 16))
        with self.lock:
            if self.state is None:
                raise ValueError('no image loaded')
        frames = []
        for t in np.linspace(0.0, 1.0, n):
            frames.append(base64.b64encode(
                self.live_frame(float(t))).decode())
        return {'frames': frames, 'count': n}

    def segment(self, img_bytes: bytes,
                opts: Optional[Dict] = None) -> Dict:
        """Detect instances (browser UI tab); returns per-instance
        boxes/scores plus a base64 mask-overlay JPEG. `opts` carries
        the reference stepping tab's draw-options box
        (Component_AIS.py:1881-1916): draw_bbox / draw_mask /
        draw_tags toggles and the mask-alpha slider."""
        import base64

        import cv2
        opts = opts or {}
        if self.segmentor is None:
            raise ValueError('no segmentor configured '
                             '(serve(..., segmentor=...))')
        arr = np.frombuffer(img_bytes, np.uint8)
        img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError('could not decode image')
        with self.lock, torch.inference_mode():
            ins = self.segmentor.infer(img)
        valid = ins.valid.cpu().numpy()
        boxes = ins.bboxes.cpu().numpy()
        scores = ins.scores.cpu().numpy()
        out = [{'bbox': [float(v) for v in boxes[i]],
                'score': float(scores[i])}
               for i in range(len(valid)) if valid[i]]
        tags_by_slot: Optional[list] = None
        note = None
        if opts.get('draw_tags'):
            # infer_tags returns tags per VALID instance in
            # flatnonzero(valid) order; draw() indexes by slot
            try:
                with self.lock, torch.inference_mode():
                    tags, _ = self.segmentor.infer_tags(ins, img)
                tags_by_slot = [''] * len(valid)
                for pos, slot in enumerate(np.flatnonzero(valid)):
                    tags_by_slot[slot] = tags[pos]
                for rec, t in zip(out, tags):
                    rec['tags'] = t
            except Exception as e:  # tagger ckpt missing etc.
                note = f'tags unavailable: {e}'
        overlay = ins.draw(
            img,
            draw_bbox=bool(opts.get('draw_bbox', True)),
            draw_ins_mask=bool(opts.get('draw_mask', True)),
            tags=tags_by_slot,
            mask_alpha=float(opts.get('mask_alpha', 0.75)),
            draw_contour=bool(opts.get('draw_contour', False)))
        ok, enc = cv2.imencode('.jpg', overlay)
        resp = {'instances': out,
                'overlay': base64.b64encode(enc.tobytes()).decode()}
        if note:
            resp['note'] = note
        return resp

    def style(self, payload: Dict) -> Dict:
        """Per-instance style repaint (Web UI style tab — the
        reference capability lives in
        Web_UI/Component_Style_Editing.py:1345-2219): detect
        instances, inpaint-fill the background, repaint background
        then each instance through the sd-webui API, return the final
        image. payload: {image: b64 png/jpg, style_prompt, bg_nprompt,
        global_nprompt, url, denoising_strength, long_side, steps,
        cfg_scale, sampler_name, seed, batch_count, batch_size}."""
        import base64
        import tempfile

        import cv2
        if self.segmentor is None:
            raise ValueError('no segmentor configured '
                             '(serve(..., segmentor=...))')
        raw = base64.b64decode(payload['image'])
        img = cv2.imdecode(np.frombuffer(raw, np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError('could not decode image')
        tmp = tempfile.mkdtemp(prefix='style_web_')
        editor = self._style_editor(payload, tmp)
        try:
            with self.lock, torch.inference_mode():
                saved = editor.repaint(img, 'web')
            if not saved:
                return {'image': None, 'outputs': 0,
                        'note': 'no instances detected'}
            return self._pack_outputs(saved)
        finally:
            # the per-request workdir (mask cache + outputs) would
            # otherwise accumulate until the temp filesystem fills
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)

    # -- per-instance style editing (reference interaction model:
    # Web_UI/Component/Component_Style_Editing.py:1345-2219 — detect,
    # auto-tag, let the user EDIT each instance's mask and prompt,
    # then repaint) ---------------------------------------------------
    def _style_editor(self, payload: Dict, tmp: str):
        from ..pipeline.style import StyleConfig, StyleEditor
        cfg = StyleConfig(
            url=payload.get('url',
                            'http://127.0.0.1:7860/sdapi/v1/img2img'),
            style_prompt=payload.get('style_prompt', ''),
            bg_nprompt=payload.get('bg_nprompt', ''),
            global_nprompt=payload.get('global_nprompt', ''),
            long_side=int(payload.get('long_side', 768)),
            denoising_strength=float(
                payload.get('denoising_strength', 0.75)),
            # Batch Count / Batch Size (reference Component_AIS.py:
            # 366-385): variants of the round's final inpaint
            batch_count=int(payload.get('batch_count', 1)),
            batch_size=int(payload.get('batch_size', 1)),
            cache_masks_dir=f'{tmp}/cache', save_dir=f'{tmp}/out',
            sd_params={
                'steps': int(payload.get('steps', 24)),
                'cfg_scale': float(payload.get('cfg_scale', 9)),
                'sampler_name': payload.get('sampler_name', 'Euler a'),
                'seed': int(payload.get('seed', 0)),
                'alwayson_scripts': {'controlnet': {'args': [{}]}},
            })
        return StyleEditor(cfg, detector=self.segmentor,
                           tagger=getattr(self, 'tagger', None))

    @staticmethod
    def _pack_outputs(saved) -> Dict:
        """Response dict from the repaint loop's saved paths: `image`
        = the final chained output, `variants` = the batched extra
        generations of the last round (reference Batch Count/Size →
        the gradio output gallery), `outputs` = total saved."""
        import base64

        import cv2

        def b64png(path):
            out = cv2.imread(path)
            ok, enc = cv2.imencode('.png', out)
            return base64.b64encode(enc.tobytes()).decode()

        # saved order is [iter0, iter0 vars..., iter1, ...]: the last
        # round's variants are the entries after the final primary
        primaries = [p for p in saved if '_var' not in osp.basename(p)]
        primary = primaries[-1] if primaries else saved[-1]
        tail_vars = [p for p in saved[saved.index(primary) + 1:]
                     if '_var' in osp.basename(p)]
        return {'image': b64png(primary),
                'variants': [b64png(p) for p in tail_vars],
                'outputs': len(saved)}

    @staticmethod
    def _b64png(img: np.ndarray) -> str:
        import base64

        import cv2
        ok, enc = cv2.imencode('.png', img)
        return base64.b64encode(enc.tobytes()).decode()

    @staticmethod
    def _unb64(data: str, gray: bool = False) -> np.ndarray:
        import base64

        import cv2
        arr = np.frombuffer(base64.b64decode(data), np.uint8)
        return cv2.imdecode(
            arr, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)

    def style_prepare(self, payload: Dict) -> Dict:
        """Detect + auto-tag; return EDITABLE per-instance masks and
        prompts (plus the patch-filled background) for the style tab's
        per-instance rows. Everything round-trips through /style_apply
        so the user can repaint with edited masks/prompts."""
        import shutil
        import tempfile
        if self.segmentor is None:
            raise ValueError('no segmentor configured '
                             '(serve(..., segmentor=...))')
        import base64
        raw = base64.b64decode(payload['image'])
        import cv2
        img = cv2.imdecode(np.frombuffer(raw, np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError('could not decode image')
        tmp = tempfile.mkdtemp(prefix='style_web_')
        try:
            editor = self._style_editor(payload, tmp)
            with self.lock, torch.inference_mode():
                prep = editor.prepare(img, 'web')
            if prep is None:
                return {'instances': [],
                        'note': 'no instances detected'}
            bg_rgb, mask_fg, masks, fg_prompts, bg_prompt, img_rgb = prep
            return {
                'image': self._b64png(img_rgb[..., ::-1]),
                'bg': self._b64png(bg_rgb[..., ::-1]),
                'mask_fg': self._b64png(mask_fg),
                'bg_prompt': bg_prompt,
                'instances': [
                    {'mask': self._b64png(m), 'prompt': p}
                    for m, p in zip(masks, fg_prompts)],
            }
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def style_apply(self, payload: Dict) -> Dict:
        """Repaint with (possibly user-edited) per-instance masks and
        prompts from /style_prepare. payload: image/bg/mask_fg (b64
        from prepare, image+bg BGR-encoded PNGs at long_side),
        instances: [{mask: b64, prompt}], bg_prompt, + the same sd
        knobs as /style."""
        import shutil
        import tempfile
        img_bgr = self._unb64(payload['image'])
        bg_bgr = self._unb64(payload['bg'])
        mask_fg = self._unb64(payload['mask_fg'], gray=True)
        masks = [self._unb64(i['mask'], gray=True)
                 for i in payload.get('instances', [])]
        prompts = [i.get('prompt', '')
                   for i in payload.get('instances', [])]
        tmp = tempfile.mkdtemp(prefix='style_web_')
        try:
            editor = self._style_editor(payload, tmp)
            with self.lock, torch.inference_mode():
                saved = editor.repaint_prepared(
                    img_bgr[..., ::-1], bg_bgr[..., ::-1], mask_fg, masks,
                    prompts, payload.get('bg_prompt', ''), 'web')
            if not saved:
                return {'image': None, 'outputs': 0}
            return self._pack_outputs(saved)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    DEFAULT_SD_URL = 'http://127.0.0.1:7860/sdapi/v1/img2img'

    def style_options(self, url: str = '') -> Dict:
        """Enumerate the sd-webui server's samplers and checkpoints
        for the style tab's dropdowns (reference sources:
        Web_UI/Common/Utility_Sampler.py:1-31 / Utility_Model.py:1-79,
        consumed by Component_Style_Editing.py:979-1009). Degrades
        gracefully: hardcoded sampler fallback + empty model list when
        the server is unreachable, `live` says which happened."""
        from .sd_webui import (current_sd_model, list_samplers,
                               list_sd_models)
        url = url or self.DEFAULT_SD_URL
        models = list_sd_models(url)
        return {'samplers': list_samplers(url),
                'models': models,
                'current_model': current_sd_model(url),
                'live': bool(models)}

    def style_model(self, payload: Dict) -> Dict:
        """Switch the sd-webui server's active checkpoint (what
        choosing from the reference's model dropdown amounts to)."""
        from .sd_webui import set_sd_model
        title = payload.get('model', '')
        if not title:
            raise ValueError('payload needs {"model": <title>}')
        ok = set_sd_model(payload.get('url') or self.DEFAULT_SD_URL,
                          title)
        return {'ok': ok, 'model': title}

    def style_batch(self, payload: Dict) -> Dict:
        """Batch-directory style processing from the UI (reference
        capability: run_style.py iterates find_all_imgs over a
        directory; the Web UI exposes it here). payload: {dir,
        save_dir?, whole_image?, + the same sd knobs as /style}.
        Returns per-image saved paths (on the server's filesystem —
        batch outputs stay on disk rather than ballooning the
        response with dozens of b64 images)."""
        import tempfile

        import cv2
        d = payload.get('dir', '')
        if not osp.isdir(d):
            raise ValueError(f'not a directory: {d}')
        exts = ('.jpg', '.jpeg', '.png', '.webp', '.bmp')
        paths = [osp.join(d, f) for f in sorted(os.listdir(d))
                 if f.lower().endswith(exts)]
        if not paths:
            raise ValueError(f'no images found in {d}')
        whole = bool(payload.get('whole_image', False))
        if not whole and self.segmentor is None:
            raise ValueError('no segmentor configured '
                             '(serve(..., segmentor=...)); use '
                             'whole_image mode instead')
        import shutil
        tmp = tempfile.mkdtemp(prefix='style_batch_')
        try:
            editor = self._style_editor(payload, tmp)
            editor.cfg.save_dir = payload.get(
                'save_dir', osp.join(d, 'repaint_output'))
            results = []
            for p in paths:
                img = cv2.imread(p)
                if img is None:
                    results.append({'path': p, 'error': 'unreadable'})
                    continue
                name = osp.splitext(osp.basename(p))[0]
                try:
                    with self.lock, torch.inference_mode():
                        saved = (editor.repaint_whole(img, name) if whole
                                 else editor.repaint(img, name))
                    results.append({'path': p, 'saved': saved})
                except Exception as e:  # noqa: BLE001 — per-image
                    # seam: one bad image must not kill the batch
                    results.append({'path': p, 'error': str(e)})
            return {'count': len(paths),
                    'save_dir': editor.cfg.save_dir,
                    'results': results}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def result_video(self, inpaint: bool = True) -> bytes:
        """Full render with inpainting → mp4 bytes. `inpaint=False`
        skips the disocclusion inpaint passes on export — the
        reference stepping tab's IsInpainting checkbox
        (Component_AIS.py:2185-2189)."""
        import tempfile
        import os
        from ..pipeline import write_video
        with self.lock, torch.inference_mode():
            # inpaint only when /step_inpaint hasn't already added the
            # passes for the current boxes into the stored state
            # (process_kenburns does not return its state, so the flag
            # is only set by step_inpaint, which stores it)
            frames = self.pipe.process_kenburns(
                self.state, self.obj_from, self.obj_to,
                inpaint=inpaint and not self.inpainted)
        with tempfile.NamedTemporaryFile(suffix='.mp4',
                                         delete=False) as f:
            path = f.name
        written = path
        try:
            # the raw I420 stream beside it (.yuv) where cv2 is missing
            written = write_video(frames, path,
                                  playback=self.pipe.cfg.playback)
            with open(written, 'rb') as f:
                return f.read()
        finally:
            for p in {path, written}:
                if osp.exists(p):
                    os.unlink(p)


def _move_marigold_weights(old, new) -> None:
    """The nets and text embedding of a Marigold model into one made
    from a new cfg (its steps, ensemble and scheduler stay the new
    ones')."""
    new.unet, new.vae = old.unet, old.vae
    new.text_embed = old.text_embed
    new.context_dim = old.context_dim


def make_handler(service: KenBurnsService):

    class Handler(BaseHTTPRequestHandler):

        def _send(self, code: int, body: bytes,
                  ctype: str = 'application/json'):
            self.send_response(code)
            self.send_header('Content-Type', ctype)
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode())

        def do_POST(self):
            n = int(self.headers.get('Content-Length', 0))
            body = self.rfile.read(n)
            parsed = urlparse(self.path)
            path = parsed.path
            try:
                if path == '/load_image':
                    self._json(service.load_image(body))
                elif path == '/segment':
                    # draw options ride the query string (the body is
                    # the raw image): ?draw_bbox=0&draw_tags=1&...
                    q = parse_qs(parsed.query)
                    opts = {}
                    for k in ('draw_bbox', 'draw_mask', 'draw_tags',
                              'draw_contour'):
                        if k in q:
                            opts[k] = q[k][0] not in ('0', 'false', '')
                    if 'mask_alpha' in q:
                        opts['mask_alpha'] = float(q['mask_alpha'][0])
                    self._json(service.segment(body, opts))
                elif path in ('/update_from', '/update_to'):
                    service.update_box(path.rsplit('_', 1)[1],
                                       json.loads(body or b'{}'))
                    self._json({'ok': True})
                elif path == '/style':
                    self._json(service.style(json.loads(body or b'{}')))
                elif path == '/style_prepare':
                    self._json(service.style_prepare(
                        json.loads(body or b'{}')))
                elif path == '/style_apply':
                    self._json(service.style_apply(
                        json.loads(body or b'{}')))
                elif path == '/style_model':
                    self._json(service.style_model(
                        json.loads(body or b'{}')))
                elif path == '/style_batch':
                    self._json(service.style_batch(
                        json.loads(body or b'{}')))
                elif path == '/step_inpaint':
                    self._json(service.step_inpaint())
                elif path == '/update_mode':
                    service.set_mode(
                        json.loads(body or b'{}').get('mode',
                                                      'automatic'))
                    self._json({'ok': True})
                elif path == '/config':
                    self._json(service.set_config(
                        json.loads(body or b'{}')))
                else:
                    self._json({'error': 'not found'}, 404)
            except Exception as e:  # noqa: BLE001 — service seam
                LOGGER.warning(f'request failed: {e}')
                self._json({'error': str(e)}, 500)

        def do_GET(self):
            parsed = urlparse(self.path)
            q = parse_qs(parsed.query)
            try:
                if parsed.path in ('/', '/index.html'):
                    from .webui import PAGE_HTML
                    self._send(200, PAGE_HTML.encode(),
                               'text/html; charset=utf-8')
                elif parsed.path == '/get_live':
                    if 'fltTime' in q:      # single-frame variant
                        t = float(q['fltTime'][0])
                        self._send(200, service.live_frame(t),
                                   'image/jpeg')
                    else:                   # reference MJPEG stream
                        self.send_response(200)
                        self.send_header(
                            'Content-Type',
                            'multipart/x-mixed-replace; '
                            'boundary=frame')
                        self.end_headers()
                        try:
                            for part in service.mjpeg_parts():
                                self.wfile.write(part)
                                self.wfile.flush()
                        except (BrokenPipeError,
                                ConnectionResetError):
                            pass            # client went away
                elif parsed.path == '/get_result':
                    inp = q.get('inpaint', ['1'])[0] \
                        not in ('0', 'false', '')
                    self._send(200, service.result_video(inpaint=inp),
                               'video/mp4')
                elif parsed.path == '/stages':
                    self._json({'stages': service.stage_list()})
                elif parsed.path == '/stage':
                    name = q.get('name', [''])[0]
                    self._send(200, service.stage_image(name),
                               'image/jpeg')
                elif parsed.path == '/frames_gallery':
                    n = int(q.get('n', ['6'])[0])
                    self._json(service.frames_gallery(n))
                elif parsed.path == '/path_overlay':
                    t = float(q.get('fltTime', ['0'])[0])
                    self._send(200, service.path_overlay(t),
                               'image/jpeg')
                elif parsed.path == '/autozoom_preview':
                    self._send(200, service.autozoom_preview(),
                               'image/jpeg')
                elif parsed.path == '/style_options':
                    self._json(service.style_options(
                        q.get('url', [''])[0]))
                elif parsed.path == '/health':
                    cfg = service.pipe.cfg
                    conf = {k: getattr(cfg, k)
                            for k in service.CONFIG_KEYS}
                    conf['stage_previews'] = \
                        service.pipe.stage_previews
                    self._json({'ok': True,
                                'loaded': service.state is not None,
                                'config': conf})
                else:
                    self._json({'error': 'not found'}, 404)
            except Exception as e:  # noqa: BLE001
                LOGGER.warning(f'request failed: {e}')
                self._json({'error': str(e)}, 500)

        def log_message(self, *a):
            pass

    return Handler


def serve(pipeline, host: str = '0.0.0.0', port: int = 8080,
          block: bool = True, segmentor=None) -> ThreadingHTTPServer:
    service = KenBurnsService(pipeline, segmentor=segmentor)
    srv = ThreadingHTTPServer((host, port), make_handler(service))
    srv.service = service
    LOGGER.info(f'kenburns server on {host}:{srv.server_address[1]}')
    if block:
        srv.serve_forever()
    else:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv
