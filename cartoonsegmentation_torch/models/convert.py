"""Carry the JAX package's Flax parameter trees into the port.

``inpaint_from_flax``, ``disparity_from_flax``, ``refine_from_flax``,
``leres_from_flax``, ``rtmdet_from_flax``, ``isnet_from_flax``,
``u2net_from_flax``, ``isnet_gt_from_flax``, ``modnet_from_flax``,
``sam_from_flax``, ``maskrcnn_from_flax``, ``swinv2_from_flax``,
``unet_from_flax`` and ``vae_from_flax`` turn a Flax tree (numpy
arrays, or anything ``np.asarray`` takes) into a ``state_dict`` of the
port's ``Inpaint``, ``DisparityEstimator``, ``Refine``, ``LeReS``,
``AnimeDetector``, ``ISNetDIS``, ``U2Net``, ``ISNetGTEncoder``,
``MODNet``, ``SAM``, ``MaskRCNN``, ``SwinV2``, ``UNet2DCondition`` and
``AutoencoderKL``.
Each walks the port module's own keys and looks up the Flax path that
the JAX package's converters (``models/convert.py: convert_inpaint``,
``convert_disparity``, ``convert_semantics``, ``convert_refine``,
``models/leres.py:convert_leres``, ``models/convert_rtmdet.py:
convert_rtmdet``, ``models/isnet.py:convert_isnet``,
``models/u2net.py:convert_u2net``, ``convert_isnet_gt``,
``models/modnet.py:convert_modnet``, ``models/sam.py:convert_sam``,
``models/maskrcnn.py:convert_maskrcnn``, ``models/swinv2.py:
convert_swinv2``, ``models/marigold.py:convert_unet``, ``convert_vae``)
write for that checkpoint key, so the two directions
stay inverse to each other.

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
    maps to a (collection, path) read from ``variables`` (or to
    (collection, path, layout), ``layout`` applied to the array first);
    keys it maps to None keep the module's value."""
    out = {}
    for k, v in module.state_dict().items():
        loc = path_of(k)
        if loc is None:
            out[k] = v.clone()
            continue
        arr = _fetch(variables[loc[0]], loc[1])
        if len(loc) == 3:
            arr = loc[2](arr)
        out[k] = _to_torch(arr, v)
    return out


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
    return 'params', _grid_leaf(key, head, parts)


def _grid_leaf(key: str, head: str, parts) -> Path:
    """Flax path of a grid U-net cell's leaf ('{r}x{c} - {r'}x{c'}')."""
    m = re.fullmatch(r'(\d+)x(\d+) - (\d+)x(\d+)', head)
    if m is None:
        raise KeyError(key)
    r1, c1, r2, c2 = map(int, m.groups())
    if r1 == r2:
        return (f'basic_r{r1}c{c1}',) + _block_leaf(parts, _BASIC_RCRC)
    if r2 == r1 + 1:
        return (f'down_c{c1}r{r1}',) + _block_leaf(parts, _DOWN)
    return (f'up_c{c1 - 2}r{r2}',) + _block_leaf(parts, _UP)


def inpaint_from_flax(params: Mapping, module: Optional[nn.Module] = None
                      ) -> Dict[str, torch.Tensor]:
    """Flax ``Inpaint`` params (the 'params' collection) → the port's
    ``Inpaint`` state_dict."""
    from .kenburns import Inpaint
    module = module or Inpaint()
    return _from_flax(module, {'params': params}, inpaint_flax_path)


# ---------------------------------------------------------------------------
# DisparityEstimator (Semantics + Disparity) and Refine
# ---------------------------------------------------------------------------

# vgg19_bn features' conv indices, the JAX Semantics' unit0..unit11
_VGG_CONV_IDX = (0, 3, 7, 10, 14, 17, 20, 23, 27, 30, 33, 36)


def disparity_flax_path(key: str) -> Optional[Tuple[str, Path]]:
    """Flax location of one ``DisparityEstimator`` state_dict key (None
    for the BatchNorm step counters)."""
    top, head, rest = key.split('.', 2)
    parts = rest.split('.')
    if top == 'semantics':                         # netVgg.<idx>.<attr>
        idx, attr = int(parts[0]), parts[1]
        if idx in _VGG_CONV_IDX:
            unit = f'unit{_VGG_CONV_IDX.index(idx)}'
            return 'params', ('semantics', unit, 'conv', _LEAF[attr])
        unit = f'unit{_VGG_CONV_IDX.index(idx - 1)}'
        return _bn(('semantics', unit, 'bn'), attr)
    pre = ('disparity',)
    if head in ('netImage', 'netSemantics'):
        name = {'netImage': 'net_image', 'netSemantics': 'net_semantics'}
        return 'params', pre + (name[head], _LEAF[parts[0]])
    if head == 'netDisparity':
        return 'params', pre + ('net_disparity',) + \
            _block_leaf(parts, _BASIC_CRC)
    return 'params', pre + _grid_leaf(key, head, parts)


def disparity_from_flax(variables: Mapping,
                        module: Optional[nn.Module] = None
                        ) -> Dict[str, torch.Tensor]:
    """Flax ``DisparityEstimator`` variables ({'params',
    'batch_stats'}: Semantics' BatchNorm statistics) → the port's
    ``DisparityEstimator`` state_dict."""
    from .kenburns import DisparityEstimator
    module = module or DisparityEstimator()
    return _from_flax(module, variables, disparity_flax_path)


_REFINE = {'netImageOne': ('img_one', _BASIC_CRC),
           'netImageTwo': ('img_two', _DOWN),
           'netImageThr': ('img_thr', _DOWN),
           'netDisparityOne': ('disp_one', _BASIC_CRC),
           'netDisparityTwo': ('disp_two', _UP),
           'netDisparityThr': ('disp_thr', _UP),
           'netDisparityFou': ('disp_fou', _BASIC_CRC),
           'netRefine': ('refine', _BASIC_CRC)}


def refine_flax_path(key: str) -> Tuple[str, Path]:
    """Flax location of one ``Refine`` state_dict key."""
    head, rest = key.split('.', 1)
    name, table = _REFINE[head]
    return 'params', (name,) + _block_leaf(rest.split('.'), table)


def refine_from_flax(params: Mapping, module: Optional[nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """Flax ``Refine`` params (the 'params' collection) → the port's
    ``Refine`` state_dict."""
    from .kenburns import Refine
    module = module or Refine()
    return _from_flax(module, {'params': params}, refine_flax_path)


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


def u2net_from_flax(variables: Mapping, module: Optional[nn.Module] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flax ``U2Net`` variables → the port's ``U2Net`` state_dict (the
    stages, sides and ``outconv`` under ISNet's naming; ``module``
    defaults to the full net)."""
    from .u2net import U2Net
    module = module or U2Net()
    return _from_flax(module, variables, isnet_flax_path)


def isnet_gt_flax_path(key: str) -> Optional[Tuple[str, Path]]:
    """Flax location of one ``ISNetGTEncoder`` state_dict key: the stem
    ``conv_in.{conv,bn}``, the rest as ISNet's."""
    parts = key.split('.')
    if parts[0] != 'conv_in':
        return isnet_flax_path(key)
    if parts[1] == 'conv':
        return 'params', ('conv_in', 'conv', _LEAF[parts[2]])
    return _bn(('conv_in', 'bn'), parts[2])


def isnet_gt_from_flax(variables: Mapping,
                       module: Optional[nn.Module] = None
                       ) -> Dict[str, torch.Tensor]:
    """Flax ``ISNetGTEncoder`` variables → the port's state_dict."""
    from .u2net import ISNetGTEncoder
    module = module or ISNetGTEncoder()
    return _from_flax(module, variables, isnet_gt_flax_path)


# torch InvertedResidual ``conv`` indices → the Flax block's children
# (expansion 1 has no expanding 1x1 conv)
_IR_EXP1 = {'0': 'dw', '1': 'dw_bn', '3': 'pw_lin', '4': 'pw_lin_bn'}
_IR_EXP6 = {'0': 'pw', '1': 'pw_bn', '3': 'dw', '4': 'dw_bn', '6': 'pw_lin',
            '7': 'pw_lin_bn'}
# the inference-time MODNet has no semantic or detail head in Flax
_MODNET_TRAIN_ONLY = ('conv_lr', 'conv_hr_0', 'conv_hr_1')


def _modnet_leaf(name: Path, attr: str, is_bn: bool):
    if is_bn:
        return _bn(name, attr)
    return 'params', name + (_LEAF[attr],)


def modnet_flax_path(key: str):
    """Flax location of one ``MODNet`` state_dict key (the backbone's
    under both of its names), or None for the step counters."""
    parts = key.split('.')
    if parts[0] == 'lr_branch' and parts[1] == 'backbone':
        parts = parts[1:]
    if parts[0] == 'backbone':                 # backbone.model.features.*
        n, rest = int(parts[3]), parts[4:]
        if n in (0, 18):
            name = ('stem', 'stem_bn') if n == 0 else ('head', 'head_bn')
            return _modnet_leaf(('backbone', name[rest[0] == '1']), rest[1],
                                rest[0] == '1')
        child = (_IR_EXP1 if n == 1 else _IR_EXP6)[rest[1]]
        return _modnet_leaf(('backbone', f'block{n}', child), rest[2],
                            child.endswith('bn'))
    if parts[1] == 'se_block':                 # Linear (out, in) ← (in, out)
        return 'params', ('se_block', 'fc0' if parts[3] == '0' else 'fc1',
                          'kernel'), _lin
    # a Conv2dIBNormRelu: <branch>.<name>[.<i>].layers.<0|1>...
    at = parts.index('layers')
    flax = '_'.join(parts[1:at])
    if parts[at + 1] == '0':
        return 'params', (flax, 'conv', _LEAF[parts[at + 2]])
    return _bn((flax, 'ibn', 'bnorm'), parts[at + 3])


def modnet_from_flax(variables: Mapping, module: Optional[nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """Flax ``MODNet`` variables → the port's ``MODNet`` state_dict. The
    semantic and detail heads, which the inference-time Flax tree lacks,
    keep the module's values."""
    from .modnet import MODNet
    module = module or MODNet()
    have = set(variables['params'])

    def path_of(key):
        loc = modnet_flax_path(key)
        if loc is not None and loc[1][0] in _MODNET_TRAIN_ONLY \
                and loc[1][0] not in have:
            return None
        return loc
    return _from_flax(module, variables, path_of)


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# SwinV2 (the tagger)
# ---------------------------------------------------------------------------

_SWIN_ATTN = {'qkv.weight': (('qkv_kernel',), _lin),
              'q_bias': (('q_bias',), _same),
              'v_bias': (('v_bias',), _same),
              'logit_scale': (('logit_scale',), _same),
              'cpb_mlp.0.weight': (('cpb_fc1', 'kernel'), _lin),
              'cpb_mlp.0.bias': (('cpb_fc1', 'bias'), _same),
              'cpb_mlp.2.weight': (('cpb_fc2', 'kernel'), _lin),
              'proj.weight': (('proj', 'kernel'), _lin),
              'proj.bias': (('proj', 'bias'), _same)}


def swinv2_flax_path(key: str):
    """(Flax path under 'params', layout function) of one ``SwinV2``
    state_dict key (timm's names), the inverse of the JAX
    ``models/swinv2.py:convert_swinv2``."""
    parts = key.split('.')
    leaf = parts[-1]
    if parts[0] == 'patch_embed':
        if parts[1] == 'proj':
            return ('patch_embed', _LEAF[leaf]), \
                (_conv if leaf == 'weight' else _same)
        return ('patch_norm', _SAM_LN[leaf][0]), _same
    if parts[0] == 'norm':
        return ('norm', _SAM_LN[leaf][0]), _same
    if parts[0] == 'head':                       # head.fc.*
        return ('head',) + (_SAM_LEAF[leaf][0],), _SAM_LEAF[leaf][1]
    i = parts[1]
    if parts[2] == 'downsample':
        if parts[3] == 'reduction':
            return (f'merge{i}', 'reduction', 'kernel'), _lin
        return (f'merge{i}', 'norm', _SAM_LN[leaf][0]), _same
    block = f'stage{i}_block{parts[3]}'            # layers.i.blocks.j.*
    sub = parts[4:]
    if sub[0] == 'attn':
        path, fn = _SWIN_ATTN['.'.join(sub[1:])]
        return (block, 'attn') + path, fn
    if sub[0] == 'mlp':
        name, fn = _SAM_LEAF[leaf]
        return (block, sub[1], name), fn
    return (block, sub[0], _SAM_LN[leaf][0]), _same


def swinv2_from_flax(variables: Mapping, module: Optional[nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """Flax ``SwinV2`` variables ({'params': ...}) → the port's
    ``SwinV2`` state_dict, whose keys are timm's (``module`` defaults to
    the WD tagger's SwinV2-B with 9083 classes)."""
    from .swinv2 import wd_tagger_swinv2
    module = module or wd_tagger_swinv2()
    params = variables['params']
    out = {}
    for k, v in module.state_dict().items():
        path, fn = swinv2_flax_path(k)
        t = torch.from_numpy(np.ascontiguousarray(fn(_fetch(params, path))))
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(f'{k}: shape {tuple(t.shape)} does not fit '
                             f'{tuple(v.shape)}')
        out[k] = t.to(v.dtype)
    return out


# ---------------------------------------------------------------------------
# latent diffusion: the SD UNet and VAE (Marigold, LDM inpainting)
# ---------------------------------------------------------------------------

def _ldm_modules(parts, up_level) -> list:
    """diffusers module names → the JAX package's (``models/ldm.py``):
    ``down_blocks.i.resnets.j`` → ``down_i_res_j``, ``.attentions.j`` →
    ``down_i_attn_j``, ``.downsamplers.0`` → ``down_i_downsample``, up
    blocks alike at level ``up_level(k)``, ``mid_block.resnets.j`` →
    ``mid_res_j``, ``mid_block.attentions.0`` → ``mid_attn``,
    ``transformer_blocks.b`` → ``blocks_b``, ``to_out.0`` → ``to_out``,
    ``ff.net.0.proj`` → ``ff.proj``, ``ff.net.2`` → ``ff.out``."""
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        if p in ('down_blocks', 'up_blocks'):
            side, lvl = p[:-7], int(parts[i + 1])
            if side == 'up':
                lvl = up_level(lvl)
            kind = parts[i + 2]
            if kind in ('downsamplers', 'upsamplers'):
                out.append(f'{side}_{lvl}_{side}sample')
            else:
                short = {'resnets': 'res', 'attentions': 'attn'}[kind]
                out.append(f'{side}_{lvl}_{short}_{parts[i + 3]}')
            i += 4
        elif p == 'mid_block':
            out.append(f'mid_res_{parts[i + 2]}' if parts[i + 1] == 'resnets'
                       else 'mid_attn')
            i += 3
        elif p == 'transformer_blocks':
            out.append(f'blocks_{parts[i + 1]}')
            i += 2
        elif p == 'to_out':
            out.append('to_out')
            i += 2
        elif p == 'ff':
            gate = parts[i + 2] == '0'
            out += ['ff', 'proj' if gate else 'out']
            i += 4 if gate else 3
        else:
            out.append(p)
            i += 1
    return out


def _ldm_leaf(leaf: str, like: torch.Tensor):
    """(Flax leaf name, layout) of a weight or bias by the port tensor's
    rank: a conv kernel, a Dense kernel or a norm's scale."""
    if leaf == 'bias':
        return 'bias', _same
    return {4: ('kernel', _conv), 2: ('kernel', _lin),
            1: ('scale', _same)}[like.ndim]


def _ldm_from_flax(module: nn.Module, tree_of) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in module.state_dict().items():
        parts = k.split('.')
        tree, path = tree_of(parts[:-1])
        name, fn = _ldm_leaf(parts[-1], v)
        t = torch.from_numpy(np.ascontiguousarray(
            fn(_fetch(tree, tuple(path) + (name,)))))
        if tuple(t.shape) != tuple(v.shape):
            raise ValueError(f'{k}: shape {tuple(t.shape)} does not fit '
                             f'{tuple(v.shape)}')
        out[k] = t.to(v.dtype)
    return out


def unet_from_flax(variables: Mapping, module: nn.Module
                   ) -> Dict[str, torch.Tensor]:
    """Flax ``UNet2DCondition`` variables ({'params': ...}) → the port's
    ``UNet2DCondition`` state_dict (diffusers' keys), the inverse of the
    JAX ``models/marigold.py:convert_unet`` (up blocks deepest first)."""
    n = len(module.block_out)
    params = variables['params']
    return _ldm_from_flax(module, lambda parts: (
        params, _ldm_modules(parts, lambda k: n - 1 - k)))


def vae_from_flax(encoder: Mapping, decoder: Mapping, module: nn.Module
                  ) -> Dict[str, torch.Tensor]:
    """Flax ``AutoencoderEncoder`` and ``AutoencoderDecoder`` variables →
    the port's ``AutoencoderKL`` state_dict, the inverse of the JAX
    ``models/marigold.py:convert_vae`` (quant_conv sits in the encoder's
    tree, post_quant_conv in the decoder's)."""
    enc, dec = encoder['params'], decoder['params']

    def tree_of(parts):
        if parts[0] in ('encoder', 'decoder'):
            return (enc if parts[0] == 'encoder' else dec), \
                _ldm_modules(parts[1:], lambda k: k)
        return (enc if parts[0] == 'quant_conv' else dec), parts
    return _ldm_from_flax(module, tree_of)
