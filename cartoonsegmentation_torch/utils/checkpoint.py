"""Checkpoints of the port's trainers (the counterpart of
``cartoonsegmentation_tpu/utils/checkpoint.py``, which writes Flax
msgpack): a dict of state dicts through ``torch.save``, read back with
``torch.load(weights_only=True)``. The detector's file holds 'params'
(the EMA weights with the trained net's BatchNorm buffers: what
``AnimeInsSeg.load_variables`` loads) and 'raw_params' (the trained
net's own state dict, which ``--resume`` continues from). JAX's msgpack
files are not read."""
from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict

import torch


def save_params(path: str, tree: Dict[str, Any]) -> None:
    """Write ``tree`` (state dicts and tensors) to ``path``, through a
    temporary file so that a killed run leaves the last whole file."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save({k: _to_cpu(v) for k, v in tree.items()}, tmp)
    os.replace(tmp, path)


def load_params(path: str) -> Dict[str, Any]:
    """The tree ``save_params`` wrote, its tensors on the CPU."""
    return torch.load(path, map_location='cpu', weights_only=True)


def _to_cpu(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, dict):
        return {k: _to_cpu(x) for k, x in v.items()}
    return v
