"""stable-diffusion-webui HTTP client (port of
``cartoonsegmentation_tpu/serving/sd_webui.py``).

The same requests with the same JSON bodies as the JAX client, sent
with the standard library (``urllib.request``) in place of
``requests``; images travel as base64 PNGs (``utils/io.py``, cv2).
``submit_request`` retries a bounded number of times and returns the
decoded JSON reply. ``ldm_inpaint_webui`` is the Ken Burns pipeline's
``inpaint_type: ldm`` fill.
"""
from __future__ import annotations

import base64
import copy
import json
import time
import urllib.request
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.io import b64_2img, img2b64  # noqa: F401 — re-exported seam

from ..utils.logger import LOGGER


def _request(url: str, data: Optional[str], auth: Optional[Tuple[str, str]],
             timeout: float):
    """GET (data None) or POST of a JSON string; the decoded JSON reply.
    Raises on a connection error or an HTTP error status."""
    headers = {}
    body = None
    if data is not None:
        body = data.encode('utf-8')
        headers['Content-Type'] = 'application/json'
    if auth:
        cred = f'{auth[0]}:{auth[1]}'.encode('utf-8')
        headers['Authorization'] = \
            'Basic ' + base64.b64encode(cred).decode('ascii')
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method='GET' if body is None else 'POST')
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode('utf-8'))


def submit_request(url: str, data: str, auth: Optional[Tuple[str, str]]
                   = None, retries: int = 5, wait_time: float = 5.0):
    """POST ``data`` (a JSON string) to ``url``, retrying up to
    ``retries`` times ``wait_time`` seconds apart; the decoded JSON
    reply."""
    last = None
    for attempt in range(retries):
        try:
            return _request(url, data, auth, timeout=600)
        except Exception as e:  # noqa: BLE001 — network seam
            last = e
            LOGGER.warning(f'sd-webui request failed '
                           f'({attempt + 1}/{retries}): {e}; '
                           f'retrying in {wait_time}s')
            time.sleep(wait_time)
    raise RuntimeError(f'sd-webui unreachable at {url}: {last}')


# the reference style tab's hardcoded sampler choices, served as the
# fallback when the sd-webui server cannot be reached
SAMPLER_FALLBACK = [
    'Euler a', 'Euler', 'LMS', 'Heun', 'DPM2', 'DPM2 a',
    'DPM++ 2S a', 'DPM++ 2M', 'DPM++ SDE', 'DPM fast', 'DPM adaptive',
    'LMS Karras', 'DPM2 Karras', 'DPM2 a Karras',
    'DPM++ 2S a Karras', 'DPM++ 2M Karras', 'DPM++ SDE Karras',
    'DDIM',
]


def api_base(url: str) -> str:
    """Server base from any sd-webui endpoint URL (the style configs
    store the full img2img route, e.g. .../sdapi/v1/img2img)."""
    i = url.find('/sdapi/')
    return url[:i] if i >= 0 else url.rstrip('/')


def list_samplers(url: str, auth=None):
    """Sampler names from GET /sdapi/v1/samplers; the hardcoded list
    when the server is down."""
    try:
        out = _request(f'{api_base(url)}/sdapi/v1/samplers', None, auth, 10.0)
        names = [s['name'] for s in out if s.get('name')]
        return names or SAMPLER_FALLBACK
    except Exception as e:  # noqa: BLE001 — network seam
        LOGGER.debug(f'sampler enumeration unavailable: {e}')
        return list(SAMPLER_FALLBACK)


def list_sd_models(url: str, auth=None):
    """Checkpoint titles from GET /sdapi/v1/sd-models; empty when the
    server is down."""
    try:
        out = _request(f'{api_base(url)}/sdapi/v1/sd-models', None, auth,
                       10.0)
        return [m['title'] for m in out if m.get('title')]
    except Exception as e:  # noqa: BLE001 — network seam
        LOGGER.debug(f'model enumeration unavailable: {e}')
        return []


def current_sd_model(url: str, auth=None) -> Optional[str]:
    """Active checkpoint title from GET /sdapi/v1/options."""
    try:
        out = _request(f'{api_base(url)}/sdapi/v1/options', None, auth, 10.0)
        return out.get('sd_model_checkpoint')
    except Exception:  # noqa: BLE001 — network seam
        return None


def set_sd_model(url: str, title: str, auth=None) -> bool:
    """Switch the server's active checkpoint via POST /sdapi/v1/options
    {sd_model_checkpoint}. Returns success."""
    try:
        _request(f'{api_base(url)}/sdapi/v1/options',
                 json.dumps({'sd_model_checkpoint': title}), auth, 600)
        return True
    except Exception as e:  # noqa: BLE001 — network seam
        LOGGER.warning(f'sd model switch failed: {e}')
        return False


def ldm_inpaint_webui(img: np.ndarray, mask: np.ndarray, resolution: int,
                      url: str, prompt: str = '', neg_prompt: str = '',
                      retries: int = 5, wait_time: float = 5.0,
                      **options) -> np.ndarray:
    """img2img inpaint of an RGB uint8 image under a grey uint8 mask
    (255 = repaint) at the aspect kept and the longer side rounded down
    to a multiple of 32, the shorter side at ``resolution``; ``options``
    join the request (``username``/``password`` become the request's
    basic auth). A reply of another size is resized back with PIL's
    LANCZOS. Raises RuntimeError when the server stays unreachable
    after ``retries`` tries ``wait_time`` seconds apart."""
    im_h, im_w = img.shape[:2]
    if im_h > im_w:
        W = resolution
        H = int((im_h / im_w * resolution) // 32 * 32)
    else:
        H = resolution
        W = int((im_w / im_h * resolution) // 32 * 32)
    auth = None
    if options.get('username'):
        auth = (options.pop('username'), options.pop('password', ''))
    options.pop('username', None)
    options.pop('password', None)
    data = {'init_images': [img2b64(img)], 'mask': img2b64(mask),
            'prompt': prompt, 'negative_prompt': neg_prompt,
            'width': W, 'height': H, **options}
    reply = submit_request(url, json.dumps(data), auth=auth,
                           retries=retries, wait_time=wait_time)
    out = b64_2img(reply['images'][0])
    if out.shape[:2] != (im_h, im_w):
        from PIL import Image
        out = np.array(Image.fromarray(out).resize(
            (im_w, im_h), resample=Image.Resampling.LANCZOS))
    return out


def run_img2img_all(img_b64: str, data: Dict, prompt: str, nprompt: str,
                    url: str, auth=None,
                    controlnet_input: Optional[str] = None):
    """img2img round with optional ControlNet conditioning; returns
    every generated image (b64 list). For n_iter · batch_size > 1 the
    server may prepend a grid composite, which is trimmed here."""
    data = dict(data)
    data['init_images'] = [img_b64]
    data['prompt'] = prompt
    data['negative_prompt'] = nprompt
    cn = data.get('alwayson_scripts', {}).get('controlnet')
    if cn and cn.get('args'):
        # a deep copy of the nested block before the conditioning image
        # goes in: the caller's request template stays as it was
        data['alwayson_scripts'] = copy.deepcopy(data['alwayson_scripts'])
        cn = data['alwayson_scripts']['controlnet']
        cn['args'][0]['input_image'] = (controlnet_input or img_b64)
    imgs = submit_request(url, json.dumps(data), auth=auth)['images']
    n = int(data.get('n_iter', 1)) * int(data.get('batch_size', 1))
    if n > 1 and len(imgs) == n + 1:
        imgs = imgs[1:]
    return imgs


def run_img2img(img_b64: str, data: Dict, prompt: str, nprompt: str,
                url: str, auth=None, controlnet_input: Optional[str] = None
                ) -> str:
    """Single-output img2img."""
    return run_img2img_all(img_b64, data, prompt, nprompt, url, auth,
                           controlnet_input)[0]


def run_sdinpaint_all(img_b64: str, mask: np.ndarray, data: Dict,
                      prompt: str, nprompt: str, url: str, auth=None):
    data = dict(data)
    data['mask'] = img2b64(mask)
    return run_img2img_all(img_b64, data, prompt, nprompt, url, auth,
                           controlnet_input=img_b64)


def run_sdinpaint(img_b64: str, mask: np.ndarray, data: Dict,
                  prompt: str, nprompt: str, url: str, auth=None) -> str:
    return run_sdinpaint_all(img_b64, mask, data, prompt, nprompt,
                             url, auth)[0]
