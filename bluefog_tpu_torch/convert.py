"""Carry weights between the JAX package's flax models and the port's.

A flax model's variables are nested mappings, ``params`` and
``batch_stats``, whose leaves are arrays; the port's models keep the same
submodule names (``BottleneckBlock_3.Conv_1``...), so only leaf names and
layouts change:

==================  ==========================  ===========================
flax leaf           port name                   layout
==================  ==========================  ===========================
``kernel`` (conv)   ``weight``                  HWIO -> OIHW
``kernel`` (dense)  ``weight``                  (in, out) -> (out, in)
``scale``           ``weight``                  as is
``bias``            ``bias``                    as is
``mean`` / ``var``  ``running_mean`` / ``_var``  as is (``batch_stats``)
==================  ==========================  ===========================

Everything here works on numpy arrays (anything ``np.asarray`` takes), so
neither side needs the other's framework.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax", "flax_from_state_dict", "load_flax"]

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _walk(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _to_torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf != "kernel":
        return arr
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 2:
        return arr.T
    raise ValueError(f"kernel of rank {arr.ndim} has no port layout")


def state_dict_from_flax(params: Mapping,
                         batch_stats: Optional[Mapping] = None
                         ) -> Dict[str, np.ndarray]:
    """The port's state dict (``name -> contiguous numpy array``) for flax
    ``params`` and, optionally, ``batch_stats``."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _walk(params):
        if path[-1] not in _PARAM_LEAF:
            raise KeyError(f"unknown flax param leaf {'/'.join(path)}")
        name = ".".join(path[:-1] + (_PARAM_LEAF[path[-1]],))
        out[name] = np.ascontiguousarray(
            _to_torch_layout(path[-1], np.asarray(arr)))
    for path, arr in _walk(batch_stats or {}):
        if path[-1] not in _STAT_LEAF:
            raise KeyError(f"unknown flax batch_stats leaf {'/'.join(path)}")
        name = ".".join(path[:-1] + (_STAT_LEAF[path[-1]],))
        out[name] = np.ascontiguousarray(np.asarray(arr))
    return out


def flax_from_state_dict(state: Mapping[str, object]
                         ) -> Tuple[Dict, Dict]:
    """``(params, batch_stats)`` as nested dicts of numpy arrays in flax's
    layouts, from a port state dict (tensors or arrays)."""
    params: Dict = {}
    stats: Dict = {}
    for name, val in state.items():
        arr = (val.detach().cpu().float().numpy()
               if isinstance(val, torch.Tensor) else np.asarray(val))
        *mods, leaf = name.split(".")
        if leaf in ("running_mean", "running_var"):
            tree, key = stats, leaf[len("running_"):]
        elif leaf == "weight" and arr.ndim == 1:
            tree, key = params, "scale"
        elif leaf == "weight":
            tree, key = params, "kernel"
            arr = (arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T)
        elif leaf == "bias":
            tree, key = params, "bias"
        else:
            raise KeyError(f"unknown port state leaf {name}")
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[key] = np.ascontiguousarray(arr)
    return params, stats


def load_flax(model: torch.nn.Module, params: Mapping,
              batch_stats: Optional[Mapping] = None) -> torch.nn.Module:
    """Copy flax ``params`` (and ``batch_stats``) into ``model`` in place.
    Every parameter must be covered, and every buffer too when
    ``batch_stats`` is given; a name the model lacks raises."""
    state = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in state_dict_from_flax(params, batch_stats).items()}
    res = model.load_state_dict(state, strict=False)
    buffers = {name for name, _ in model.named_buffers()}
    missing = [k for k in res.missing_keys
               if batch_stats is not None or k not in buffers]
    if missing or res.unexpected_keys:
        raise KeyError(f"flax variables do not match the model: missing "
                       f"{missing}, unexpected {res.unexpected_keys}")
    return model
