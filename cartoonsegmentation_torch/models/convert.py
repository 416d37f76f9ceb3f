"""Carry the JAX package's Flax parameter trees into the port.

``inpaint_from_flax``, ``leres_from_flax``, ``rtmdet_from_flax``,
``isnet_from_flax``, ``sam_from_flax`` and ``maskrcnn_from_flax`` turn
a Flax tree (numpy arrays, or anything ``np.asarray`` takes) into a
``state_dict`` of the port's ``Inpaint``, ``LeReS``, ``AnimeDetector``,
``ISNetDIS``, ``SAM`` and ``MaskRCNN``. Each walks the port module's
own keys and looks up the Flax path that the JAX package's converters
(``models/convert.py:convert_inpaint``, ``models/leres.py:
convert_leres``, ``models/convert_rtmdet.py:convert_rtmdet``,
``models/isnet.py:convert_isnet``, ``models/sam.py:convert_sam``,
``models/maskrcnn.py:convert_maskrcnn``) write for that checkpoint
key, so the two directions stay inverse to each other.

Layouts: Flax conv kernel (kh, kw, in, out) → torch (out, in, kh, kw);
Dense kernel (in, out) → Linear (out, in); ConvTranspose kernel →
torch (in, out, kh, kw) flipped; PReLU 'alpha' → weight; BatchNorm
scale/bias → weight/bias and batch_stats mean/var →
running_mean/running_var.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]


def _fetch(tree: Mapping, path: Path) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.array(node, np.float32)


def _to_torch(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if arr.ndim == 4:                         # (kh, kw, in, out)
        arr = arr.transpose(3, 2, 0, 1)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f'shape {tuple(t.shape)} does not fit '
                         f'{tuple(like.shape)}')
    return t.to(like.dtype)


def _from_flax(module: nn.Module, variables: Mapping,
               path_of) -> Dict[str, torch.Tensor]:
    """state_dict of ``module`` with every tensor that ``path_of(key)``
    maps to a (collection, path) read from ``variables``; keys it maps
    to None keep the module's value."""
    out = {}
    for k, v in module.state_dict().items():
        loc = path_of(k)
        out[k] = v.clone() if loc is None else \
            _to_torch(_fetch(variables[loc[0]], loc[1]), v)
    return out


# ---------------------------------------------------------------------------
# Inpaint
# ---------------------------------------------------------------------------

_BASIC_RCRC = {'0': 'prelu_in', '1': 'conv0', '2': 'prelu_mid',
               '3': 'conv1'}
_BASIC_CRC = {'0': 'conv0', '1': 'prelu_mid', '2': 'conv1'}
_DOWN = {'0': 'prelu0', '1': 'conv0', '2': 'prelu1', '3': 'conv1'}
_UP = {'1': 'prelu0', '2': 'conv0', '3': 'prelu1', '4': 'conv1'}
_LEAF = {'weight': 'kernel', 'bias': 'bias'}


def _block_leaf(parts, table) -> Path:
    """('netMain', idx, attr) or ('netShortcut', attr) → Flax leaf."""
    if parts[0] == 'netShortcut':
        return ('shortcut', _LEAF[parts[1]])
    name = table[parts[1]]
    if name.startswith('prelu'):
        return (name, 'alpha')
    return (name, _LEAF[parts[2]])


def inpaint_flax_path(key: str) -> Tuple[str, Path]:
    """Flax location of one ``Inpaint`` state_dict key."""
    head, rest = key.split('.', 1)
    parts = rest.split('.')
    if head == 'netContext':
        idx, attr = parts
        names = {'0': 'context0', '1': 'context_prelu0',
                 '2': 'context1', '3': 'context_prelu1'}
        name = names[idx]
        leaf = 'alpha' if 'prelu' in name else _LEAF[attr]
        return 'params', (name, leaf)
    if head in ('netInput', 'netImage', 'netDisparity'):
        name = {'netInput': 'net_input', 'netImage': 'net_image',
                'netDisparity': 'net_disparity'}[head]
        return 'params', (name,) + _block_leaf(parts, _BASIC_CRC)
    m = re.fullmatch(r'(\d+)x(\d+) - (\d+)x(\d+)', head)
    if m is None:
        raise KeyError(key)
    r1, c1, r2, c2 = map(int, m.groups())
    if r1 == r2:
        return 'params', (f'basic_r{r1}c{c1}',) + \
            _block_leaf(parts, _BASIC_RCRC)
    if r2 == r1 + 1:
        return 'params', (f'down_c{c1}r{r1}',) + _block_leaf(parts, _DOWN)
    return 'params', (f'up_c{c1 - 2}r{r2}',) + _block_leaf(parts, _UP)


def inpaint_from_flax(params: Mapping, module: Optional[nn.Module] = None
                      ) -> Dict[str, torch.Tensor]:
    """Flax ``Inpaint`` params (the 'params' collection) → the port's
    ``Inpaint`` state_dict."""
    from .kenburns import Inpaint
    module = module or Inpaint()
    return _from_flax(module, {'params': params}, inpaint_flax_path)


# ---------------------------------------------------------------------------
# LeReS
# ---------------------------------------------------------------------------

_BN = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
       'running_mean': ('batch_stats', 'mean'),
       'running_var': ('batch_stats', 'var')}


def _bn(prefix: Path, attr: str) -> Optional[Tuple[str, Path]]:
    if attr == 'num_batches_tracked':
        return None
    col, leaf = _BN[attr]
    return col, prefix + (leaf,)


def _ftb(prefix: Path, parts) -> Optional[Tuple[str, Path]]:
    if parts[0] == 'conv1':
        return 'params', prefix + ('conv1', _LEAF[parts[1]])
    idx, attr = parts[1], parts[2]
    if idx == '2':
        return _bn(prefix + ('branch_bn',), attr)
    name = {'1': 'branch_conv0', '4': 'branch_conv1'}[idx]
    return 'params', prefix + (name, _LEAF[attr])


def leres_flax_path(key: str) -> Optional[Tuple[str, Path]]:
    """Flax location of one ``LeReS`` state_dict key (None for the
    BatchNorm step counters, which Flax does not keep)."""
    parts = key.split('.')
    if parts[0] == 'encoder':
        rest = parts[1:]
        if rest[0] == 'conv1':
            return 'params', ('encoder', 'conv1', 'kernel')
        if rest[0] == 'bn1':
            return _bn(('encoder', 'bn1'), rest[1])
        block = ('encoder', f'{rest[0]}_{rest[1]}')
        sub = rest[2]
        if sub.startswith('conv'):
            return 'params', block + (sub, 'conv', 'kernel')
        if sub.startswith('bn'):
            return _bn(block + ('conv' + sub[-1], 'bn'), rest[3])
        if rest[3] == '0':                     # downsample conv
            return 'params', block + ('downsample', 'conv', 'kernel')
        return _bn(block + ('downsample', 'bn'), rest[4])
    rest = parts[1:]
    if rest[0] == 'conv':
        return _ftb(('decoder', 'conv'), rest[1:])
    if rest[0] == 'conv1':
        return 'params', ('decoder', 'conv1', _LEAF[rest[1]])
    if rest[0].startswith('ffm'):
        return _ftb(('decoder', rest[0], rest[1]), rest[2:])
    idx, attr = rest[2], rest[3]                 # outconv.adapt_conv.*
    if idx == '1':
        return _bn(('decoder', 'ao_bn'), attr)
    name = {'0': 'ao_conv0', '3': 'ao_conv1'}[idx]
    return 'params', ('decoder', name, _LEAF[attr])


def leres_from_flax(variables: Mapping, module: Optional[nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flax ``LeReS`` variables ({'params', 'batch_stats'}) → the
    port's ``LeReS`` state_dict (pass ``module`` for a reduced
    trunk)."""
    from .leres import LeReS
    module = module or LeReS()
    return _from_flax(module, variables, leres_flax_path)


# ---------------------------------------------------------------------------
# RTMDet-Ins (AnimeDetector)
# ---------------------------------------------------------------------------

def _convmod(prefix: Path, rest) -> Optional[Tuple[str, Path]]:
    """mmcv ConvModule leaf: conv.weight or bn.<attr>."""
    if rest[0] == 'conv':
        return 'params', prefix + ('conv', 'kernel')
    return _bn(prefix + ('bn',), rest[1])


def _csp(prefix: Path, rest) -> Optional[Tuple[str, Path]]:
    """CSPLayer leaf (main/short/final conv, blocks, attention)."""
    if rest[0] == 'blocks':
        block = prefix + (f'block{rest[1]}',)
        if rest[2] == 'conv1':
            return _convmod(block + ('conv1',), rest[3:])
        sub = {'depthwise_conv': 'dw', 'pointwise_conv': 'pw'}[rest[3]]
        return _convmod(block + ('conv2', sub), rest[4:])
    if rest[0] == 'attention':
        return 'params', prefix + ('attention', 'fc', _LEAF[rest[2]])
    return _convmod(prefix + (rest[0],), rest[1:])


_NECK = {'reduce_layers': ('reduce', _convmod),
         'top_down_blocks': ('top_down', _csp),
         'downsamples': ('downsample', _convmod),
         'bottom_up_blocks': ('bottom_up', _csp),
         'out_convs': ('out', _convmod)}


def rtmdet_flax_path(key: str) -> Optional[Tuple[str, Path]]:
    """Flax location of one ``AnimeDetector`` state_dict key (None for
    the BatchNorm step counters). A head conv shared across levels is
    one Flax kernel under every level's key."""
    parts = key.split('.')
    if parts[0] == 'backbone':
        if parts[1] == 'stem':
            return _convmod(('backbone', f'stem{parts[2]}'), parts[3:])
        si = int(parts[1][len('stage'):]) - 1
        sub, rest = parts[2], parts[3:]
        if sub == '0':
            return _convmod(('backbone', f'stage{si}_conv'), rest)
        if si == 3 and sub == '1':
            return _convmod(('backbone', 'stage3_spp', rest[0]), rest[1:])
        return _csp(('backbone', f'stage{si}_csp'), rest)
    if parts[0] == 'neck':
        name, fn = _NECK[parts[1]]
        return fn(('neck', f'{name}{parts[2]}'), parts[3:])
    rest = parts[1:]                                  # bbox_head.*
    if rest[0] == 'mask_head':
        if rest[1] == 'stacked_convs':
            return _convmod(('mask_head', f'conv{rest[2]}'), rest[3:])
        return 'params', ('mask_head', rest[1], _LEAF[rest[2]])
    if rest[0] in ('rtm_cls', 'rtm_reg', 'rtm_kernel'):
        return 'params', ('bbox_head', f'{rest[0]}_l{rest[1]}',
                          _LEAF[rest[2]])
    branch = rest[0][:-len('_convs')]                 # cls / reg / kernel
    lv, i = rest[1], rest[2]
    if rest[3] == 'conv':
        return 'params', ('bbox_head', f'{branch}_conv{i}', 'kernel')
    return _bn(('bbox_head', f'{branch}_bn_l{lv}_{i}'), rest[4])


def rtmdet_from_flax(variables: Mapping, module: Optional[nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """Flax ``AnimeDetector`` variables ({'params', 'batch_stats'}) →
    the port's ``AnimeDetector`` state_dict (pass ``module`` for a
    reduced one)."""
    from .rtmdet import AnimeDetector
    module = module or AnimeDetector()
    return _from_flax(module, variables, rtmdet_flax_path)


# ---------------------------------------------------------------------------
# ISNet
# ---------------------------------------------------------------------------

def isnet_flax_path(key: str) -> Optional[Tuple[str, Path]]:
    """Flax location of one ``ISNetDIS`` state_dict key."""
    parts = key.split('.')
    if len(parts) == 2:                               # conv_in / sideN
        return 'params', (parts[0], _LEAF[parts[1]])
    stage, block, layer, attr = parts
    if layer == 'conv_s1':
        return 'params', (stage, block, 'conv', _LEAF[attr])
    return _bn((stage, block, 'bn'), attr)


def isnet_from_flax(variables: Mapping, module: Optional[nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flax ``ISNetDIS`` variables → the port's ``ISNetDIS`` state_dict
    (``module`` defaults to the 4-channel refine net)."""
    from .isnet import ISNetDIS
    module = module or ISNetDIS(in_ch=4)
    return _from_flax(module, variables, isnet_flax_path)


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------

def _lin(a: np.ndarray) -> np.ndarray:          # Dense (in, out) → (out, in)
    return a.T


def _conv(a: np.ndarray) -> np.ndarray:         # (kh, kw, in, out)
    return a.transpose(3, 2, 0, 1)


def _deconv(a: np.ndarray) -> np.ndarray:
    """Flax ConvTranspose kernel → torch (in, out, kh, kw): the inverse
    of the JAX ``deconv_w`` (layout and spatial flip)."""
    return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _same(a: np.ndarray) -> np.ndarray:
    return a


_SAM_LEAF = {'weight': ('kernel', _lin), 'bias': ('bias', _same)}
_SAM_LN = {'weight': ('scale', _same), 'bias': ('bias', _same)}


def sam_flax_path(key: str):
    """(Flax path under 'params', layout function) of one ``SAM``
    state_dict key, or None for the keys the box path never reads (the
    prompt encoder's mask branch and not-a-point embedding)."""
    parts = key.split('.')
    top, rest = parts[0], parts[1:]
    if top == 'image_encoder':
        pre = ('image_encoder',)
        if rest[0] == 'pos_embed':
            return pre + ('pos_embed',), _same
        if rest[0] == 'patch_embed':
            leaf = rest[2]
            return pre + ('patch_embed', 'kernel' if leaf == 'weight'
                          else 'bias'), _conv if leaf == 'weight' else _same
        if rest[0] == 'neck':
            idx, leaf = rest[1], rest[2]
            if idx in ('0', '2'):
                return pre + (f'neck{idx}', 'kernel'), _conv
            return pre + (f'neck{idx}', leaf), _same
        blk = pre + (f'block{rest[1]}',)
        sub = rest[2:]
        if sub[0] in ('norm1', 'norm2'):
            name, fn = _SAM_LN[sub[1]]
            return blk + (sub[0], name), fn
        if sub[0] == 'mlp':
            name, fn = _SAM_LEAF[sub[2]]
            return blk + (sub[1], name), fn
        if sub[1] in ('rel_pos_h', 'rel_pos_w'):
            return blk + ('attn', sub[1]), _same
        name, fn = _SAM_LEAF[sub[2]]
        return blk + ('attn', sub[1], name), fn
    if top == 'prompt_encoder':
        pre = ('prompt_encoder',)
        if rest[0] == 'pe_layer':
            return pre + ('pe_gauss',), _same
        if rest[0] == 'point_embeddings':
            i = int(rest[1])
            return pre + ('point_embed',), lambda a: a[i:i + 1]
        if rest[0] == 'no_mask_embed':
            return pre + ('no_mask_embed',), lambda a: a[None]
        return None
    pre = ('mask_decoder',)
    if rest[0] in ('iou_token', 'mask_tokens'):
        return pre + (rest[0],), _same
    if rest[0] == 'output_upscaling':
        idx, leaf = rest[1], rest[2]
        if idx == '1':
            return pre + ('up_ln', leaf), _same
        name = {'0': 'up0', '3': 'up1'}[idx]
        return pre + (name, 'kernel' if leaf == 'weight' else 'bias'), \
            _deconv if leaf == 'weight' else _same
    if rest[0] in ('output_hypernetworks_mlps', 'iou_prediction_head'):
        mod = f'hyper{rest[1]}' if rest[0] == 'output_hypernetworks_mlps' \
            else 'iou_head'
        j, leaf = rest[-2], rest[-1]
        name, fn = _SAM_LEAF[leaf]
        return pre + (mod, f'l{j}', name), fn
    tr = pre + ('transformer',)                     # transformer.*
    sub = rest[1:]
    if sub[0] == 'norm_final_attn':
        name, fn = _SAM_LN[sub[1]]
        return tr + ('norm_final_attn', name), fn
    if sub[0] == 'final_attn_token_to_image':
        name, fn = _SAM_LEAF[sub[2]]
        return tr + (sub[0], sub[1], name), fn
    layer = tr + (f'layer{sub[1]}',)
    sub = sub[2:]
    if sub[0].startswith('norm'):
        name, fn = _SAM_LN[sub[1]]
        return layer + (sub[0], name), fn
    if sub[0] == 'mlp':
        name, fn = _SAM_LEAF[sub[2]]
        return layer + (sub[1], name), fn
    name, fn = _SAM_LEAF[sub[2]]
    return layer + (sub[0], sub[1], name), fn


def sam_from_flax(variables: Mapping, module: Optional[nn.Module] = None
                  ) -> Dict[str, torch.Tensor]:
    """Flax ``SAM`` variables ({'params': ...}) → the port's ``SAM``
    state_dict, whose keys are the official checkpoint's (``module``
    defaults to ViT-B at 1024)."""
    from .sam import sam_vit_b
    module = module or sam_vit_b()
    params = variables['params']
    out = {}
    for k, v in module.state_dict().items():
        loc = sam_flax_path(k)
        if loc is None:
            out[k] = v.clone()
            continue
        path, fn = loc
        arr = np.ascontiguousarray(fn(_fetch(params, path)))
        t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(f'{k}: shape {tuple(t.shape)} does not fit '
                             f'{tuple(v.shape)}')
        out[k] = t.to(v.dtype)
    return out


# ---------------------------------------------------------------------------
# Mask R-CNN
# ---------------------------------------------------------------------------

def _leaf(name: str, layout) -> Tuple[str, object]:
    """torch leaf → (Flax leaf, layout function) for a weight/bias."""
    return ('kernel', layout) if name == 'weight' else ('bias', _same)


def maskrcnn_flax_path(key: str):
    """(Flax path under 'params', layout function) of one ``MaskRCNN``
    state_dict key: the inverse of the JAX ``convert_maskrcnn``."""
    parts = key.split('.')
    if parts[0] == 'backbone' and parts[1] == 'body':
        rest = parts[2:]
        if rest[0] == 'conv1':
            return ('body', 'conv1', 'kernel'), _conv
        if rest[0] == 'bn1':
            return ('body', 'bn1', rest[1]), _same
        blk = ('body', f'{rest[0]}_{rest[1]}')
        sub = rest[2:]
        if sub[0] == 'downsample':
            if sub[1] == '0':
                return blk + ('down0', 'kernel'), _conv
            return blk + ('down1', sub[2]), _same
        if sub[0].startswith('conv'):
            return blk + (sub[0], 'kernel'), _conv
        return blk + (sub[0], sub[1]), _same
    if parts[0] == 'backbone':                   # backbone.fpn.*
        kind, i, leaf = parts[2], parts[3], parts[4]
        flax_leaf, fn = _leaf(leaf, _conv)
        name = ('inner' if kind == 'inner_blocks' else 'layer') + i
        return ('fpn', name, flax_leaf), fn
    if parts[0] == 'rpn':                        # rpn.head.*
        flax_leaf, fn = _leaf(parts[3], _conv)
        return ('rpn_head', parts[2], flax_leaf), fn
    head, name, leaf = parts[1], parts[2], parts[3]   # roi_heads.*
    if head in ('box_head', 'box_predictor'):
        flax_leaf, fn = _leaf(leaf, _lin)
        return ('box_head', name, flax_leaf), fn
    flax_leaf, fn = _leaf(leaf, _deconv if name == 'conv5_mask' else _conv)
    return ('mask_head', name, flax_leaf), fn


def maskrcnn_from_flax(variables: Mapping, module: Optional[nn.Module] = None
                       ) -> Dict[str, torch.Tensor]:
    """Flax ``MaskRCNN`` variables ({'params': ...}) → the port's
    ``MaskRCNN`` state_dict, whose keys are torchvision's (legacy
    nesting)."""
    from .maskrcnn import MaskRCNN
    module = module or MaskRCNN()
    params = variables['params']
    out = {}
    for k, v in module.state_dict().items():
        path, fn = maskrcnn_flax_path(k)
        t = torch.from_numpy(np.ascontiguousarray(fn(_fetch(params, path))))
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(f'{k}: shape {tuple(t.shape)} does not fit '
                             f'{tuple(v.shape)}')
        out[k] = t.to(v.dtype)
    return out
