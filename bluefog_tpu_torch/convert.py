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
neither side needs the other's framework.  :func:`window_from_numpy` carries
a window's buffers the same way, so a run can hand a window to the port
mid-way.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["state_dict_from_flax", "flax_from_state_dict", "load_flax",
           "window_from_numpy"]

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


def _tensor(arr) -> torch.Tensor:
    """A CPU tensor of ``arr``'s values and dtype; numpy's ml_dtypes bfloat16
    (what a JAX bf16 array converts to) becomes torch.bfloat16."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def window_from_numpy(self_buf, peer_bufs, assoc_self=None, assoc_peers=None,
                      *, schedule, device="cuda", name: str = "win"):
    """A port window holding the given buffers: ``self_buf`` a pytree of
    rank-stacked ``(n, ...)`` arrays, ``peer_bufs`` the matching pytree of
    ``(n, K, ...)`` landing buffers, and, for an associated-p window,
    ``assoc_self`` ``(n,)`` and ``assoc_peers`` ``(n, K)``.  ``schedule`` is
    the port's :class:`~bluefog_tpu_torch.topology.GossipSchedule` (or
    Topology) the window was created with; ``device`` defaults to the GPU."""
    from bluefog_tpu_torch.ops import windows as W
    from bluefog_tpu_torch.parallel.context import resolve_device

    dev = resolve_device(device)
    to_dev = lambda t: _tensor(t).to(dev)  # noqa: E731
    state = W.win_create(pytree.tree_map(to_dev, self_buf), schedule,
                         name=name, associated_p=assoc_self is not None)
    k = state.spec.schedule.num_slots
    # the landing buffers flattened per rank and slot, in the layout's order
    peers = [to_dev(a) for a in pytree.tree_leaves(peer_bufs)]
    if len(peers) != len(state.layout.leaves):
        raise ValueError(f"peer_bufs has {len(peers)} leaves, self_buf "
                         f"{len(state.layout.leaves)}")
    for t, (dt, off, shape) in zip(peers, state.layout.leaves):
        if tuple(t.shape) != (state.layout.n, k, *shape):
            raise ValueError(f"peer leaf of shape {tuple(t.shape)} where the "
                             f"window holds {(state.layout.n, k, *shape)}")
        n_el = int(np.prod(shape, dtype=np.int64))
        state.peers[dt][:, :, off:off + n_el] = t.reshape(
            state.layout.n, k, -1)
    if assoc_self is not None:
        state.assoc_self.copy_(_tensor(assoc_self).reshape(-1))
        state.assoc_peers.copy_(_tensor(assoc_peers).reshape(
            state.assoc_peers.shape))
    return state
