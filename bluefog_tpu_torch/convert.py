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

The same table carries :class:`~bluefog_tpu_torch.models.lenet.LeNet5`'s
flax weights (conv and dense kernels with their biases, no
``batch_stats``): :func:`load_flax` fills the port's LeNet from
``variables["params"]``.  The transformer (:func:`gpt_from_flax`,
:func:`flax_from_gpt`) adds flax's ``embedding`` leaf, which carries over as
``weight`` unchanged; BERT (:func:`bert_from_flax`, :func:`flax_from_bert`)
and ViT (:func:`vit_from_flax`, :func:`flax_from_vit`, whose ``cls`` and
``pos_embed`` are parameters of the model itself) use the same rules.

The parallel models keep flax's names and layouts and hold every rank's
block on leading mesh dimensions (:mod:`bluefog_tpu_torch.parallel.axes`):
:func:`shard_from_global` cuts a global array into those blocks by its
partition spec, :func:`global_from_shards` joins them again, and
:func:`tp_from_flax` / :func:`flax_from_tp` carry the tensor-parallel GPT's
whole tree through its rule table; a stage-stacked tree (the pipeline's) is
:func:`shard_from_global` with ``P('pp', ...)``.  :func:`gpt_from_tp` lays a
gathered tensor-parallel GPT out as the dense ``TransformerLM``, and
:func:`moe_from_flax` / :func:`flax_from_moe` carry the Switch-MoE GPT.

Everything here works on numpy arrays (anything ``np.asarray`` takes), so
neither side needs the other's framework.  :func:`window_from_numpy` carries
a window's buffers the same way, so a run can hand a window to the port
mid-way.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["state_dict_from_flax", "flax_from_state_dict", "load_flax",
           "gpt_from_flax", "flax_from_gpt", "bert_from_flax",
           "flax_from_bert", "vit_from_flax", "flax_from_vit",
           "window_from_numpy", "shard_from_global", "global_from_shards",
           "tp_from_flax", "flax_from_tp", "gpt_from_tp", "moe_from_flax",
           "flax_from_moe"]

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


def _from_flax(params: Mapping, what: str) -> Dict[str, np.ndarray]:
    """A transformer's state dict from its flax params: ``embedding``
    tables, LayerNorm ``scale``, biases and top-level parameters as they
    are, Dense ``kernel`` ``(in, out)`` as ``weight`` ``(out, in)``, Conv
    ``kernel`` HWIO as OIHW."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _walk(params):
        leaf = path[-1]
        arr = np.asarray(arr)
        if len(path) == 1:
            # a parameter of the model itself (ViT's cls, pos_embed)
            out[leaf] = np.ascontiguousarray(arr)
            continue
        if leaf not in ("embedding", "kernel", "scale", "bias"):
            raise KeyError(f"unknown flax {what} leaf {'/'.join(path)}")
        name = ".".join(path[:-1] + ("bias" if leaf == "bias" else "weight",))
        if leaf == "kernel":
            arr = _to_torch_layout(leaf, arr)
        out[name] = np.ascontiguousarray(arr)
    return out


def _to_flax(state: Mapping[str, object], embeds: Tuple[str, ...],
             what: str) -> Dict:
    """The inverse of :func:`_from_flax` for a model whose embedding
    tables are the submodules named in ``embeds``."""
    params: Dict = {}
    for name, val in state.items():
        arr = (val.detach().cpu().numpy() if isinstance(val, torch.Tensor)
               else np.asarray(val))
        *mods, leaf = name.split(".")
        if not mods:
            params[leaf] = np.ascontiguousarray(arr)
            continue
        if leaf == "bias":
            key = "bias"
        elif leaf != "weight":
            raise KeyError(f"unknown port {what} leaf {name}")
        elif mods[-1] in embeds:
            key = "embedding"
        elif arr.ndim == 1:
            key = "scale"
        elif arr.ndim == 4:
            key, arr = "kernel", arr.transpose(2, 3, 1, 0)
        else:
            key, arr = "kernel", arr.T
        tree = params
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[key] = np.ascontiguousarray(arr)
    return {"params": params}


def gpt_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """The state dict of a
    :class:`~bluefog_tpu_torch.models.transformer.TransformerLM` for the
    JAX package's ``TransformerLM`` variables (``{"params": ...}`` or the
    params alone): ``embedding`` tables and LayerNorm ``scale`` and ``bias``
    as they are, Dense ``kernel`` ``(in, out)`` as ``weight`` ``(out, in)``.
    Exact: nothing is rounded."""
    return _from_flax(variables.get("params", variables), "GPT")


def flax_from_gpt(state: Mapping[str, object]) -> Dict:
    """``{"params": ...}`` in the JAX package's ``TransformerLM`` layout, as
    nested dicts of numpy arrays, from a port state dict (tensors or
    arrays); the inverse of :func:`gpt_from_flax`."""
    return _to_flax(state, ("tok", "pos"), "GPT")


def bert_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """The state dict of a :class:`~bluefog_tpu_torch.models.bert.
    BertEncoder` for the JAX package's ``BertEncoder`` variables: the
    ``tok``, ``pos`` (and ``typ``) tables and LayerNorm ``scale`` and
    ``bias`` as they are, Dense ``kernel`` ``(in, out)`` as ``weight``
    ``(out, in)``.  Exact."""
    return _from_flax(variables.get("params", variables), "BERT")


def flax_from_bert(state: Mapping[str, object]) -> Dict:
    """The inverse of :func:`bert_from_flax`: ``{"params": ...}`` in the
    JAX package's ``BertEncoder`` layout, as nested numpy dicts."""
    return _to_flax(state, ("tok", "pos", "typ"), "BERT")


def vit_from_flax(variables: Mapping) -> Dict[str, np.ndarray]:
    """The state dict of a :class:`~bluefog_tpu_torch.models.vit.ViT` for
    the JAX package's ``ViT`` variables: the patchify conv's HWIO kernel as
    OIHW, Dense kernels transposed, ``cls``, ``pos_embed``, scales and
    biases as they are.  Exact."""
    return _from_flax(variables.get("params", variables), "ViT")


def flax_from_vit(state: Mapping[str, object]) -> Dict:
    """The inverse of :func:`vit_from_flax`."""
    return _to_flax(state, (), "ViT")


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


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_from_global(arr, spec, mesh) -> np.ndarray:
    """The stacked blocks ``(*mesh.shape, *local)`` of a global array that a
    ``shard_map`` with in-spec ``spec`` (a partition spec: per dimension
    ``None``, an axis name or a tuple of them) hands each device of
    ``mesh``: a dimension sharded over axes is cut into their sizes (the
    first named axis outermost), a mesh axis the spec does not name holds
    copies."""
    arr = np.asarray(arr)
    sizes = mesh.sizes
    spec = tuple(spec) + (None,) * (arr.ndim - len(tuple(spec)))
    shape, where = [], {}
    for d, entry in enumerate(spec):
        names = _entry_axes(entry)
        block = arr.shape[d] // math.prod(sizes[a] for a in names)
        for a in names:
            where[a] = len(shape)
            shape.append(sizes[a])
        shape.append(block)
    cut = arr.reshape(shape)
    local = [i for i in range(len(shape)) if i not in where.values()]
    order, view = [], []
    for a in mesh.axis_names:
        if a in where:
            order.append(where[a])
            view.append(sizes[a])
        else:
            view.append(1)
    out = cut.transpose(order + local)
    out = out.reshape(view + [shape[i] for i in local])
    return np.broadcast_to(out, tuple(mesh.shape)
                           + out.shape[len(view):]).copy()


def global_from_shards(blocks, spec, mesh) -> np.ndarray:
    """The inverse of :func:`shard_from_global`: the global array from the
    stacked blocks, the copies of a replicated axis read from its rank 0."""
    blocks = np.asarray(blocks)
    names = list(mesh.axis_names)
    nl = len(names)
    spec = tuple(spec) + (None,) * (blocks.ndim - nl - len(tuple(spec)))
    used = [a for e in spec for a in _entry_axes(e)]
    idx = tuple(slice(None) if a in used else 0 for a in names)
    x = blocks[idx]                                  # used axes lead
    kept = [a for a in names if a in used]
    order = []
    for d, entry in enumerate(spec):
        order.extend(kept.index(a) for a in _entry_axes(entry))
        order.append(len(kept) + d)
    x = x.transpose(order)
    shape = [blocks.shape[nl + d] * math.prod(
        mesh.sizes[a] for a in _entry_axes(e)) for d, e in enumerate(spec)]
    return np.ascontiguousarray(x.reshape(shape))


def _flat_params(params: Mapping) -> Dict[str, np.ndarray]:
    return {"/".join(path): np.asarray(arr) for path, arr in _walk(params)}


def tp_from_flax(variables: Mapping, mesh, rules) -> Dict[str, np.ndarray]:
    """The stacked parameters of a :class:`~bluefog_tpu_torch.parallel.
    tensor.TPTransformerLM` over ``mesh`` (keyed like its
    ``named_parameters``) from the JAX package's ``TPTransformerLM``
    parameters as global arrays (e.g. ``gather_tp_params`` of its boxed
    tree), each cut by the spec ``rules`` (a rule table) resolves for it.
    Exact."""
    out = {}
    for name, arr in _flat_params(variables.get("params", variables)).items():
        spec = rules.resolve(name, arr.shape)
        out[name.replace("/", ".")] = shard_from_global(arr, spec, mesh)
    return out


def flax_from_tp(state: Mapping[str, object], mesh, rules) -> Dict:
    """The inverse of :func:`tp_from_flax`: ``{"params": ...}`` of global
    numpy arrays in the JAX package's ``TPTransformerLM`` layout."""
    params: Dict = {}
    nl = len(mesh.axis_names)
    for name, val in state.items():
        arr = (val.detach().cpu().numpy() if isinstance(val, torch.Tensor)
               else np.asarray(val))
        key = name.replace(".", "/")
        spec = rules.resolve(key, arr.shape[nl:])
        *mods, leaf = key.split("/")
        tree = params
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = global_from_shards(arr, spec, mesh)
    return {"params": params}


def gpt_from_tp(gathered: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """A dense :class:`~bluefog_tpu_torch.models.transformer.TransformerLM`
    state dict from one rank's gathered tensor-parallel GPT parameters
    (``{name: full array}``, flax layouts): the fused ``(in, 3, C)`` qkv
    kernel is the dense ``(in, 3C)`` one (q, k, v contiguous), Dense
    kernels transposed, tables and LayerNorm scales as they are.  Exact."""
    out: Dict[str, np.ndarray] = {}
    for name, val in gathered.items():
        arr = (val.detach().cpu().numpy() if isinstance(val, torch.Tensor)
               else np.asarray(val))
        *mods, leaf = name.replace("/", ".").split(".")
        if leaf == "qkv_kernel":
            mods, leaf, arr = mods + ["qkv"], "kernel", arr.reshape(
                arr.shape[0], -1)
        elif leaf == "qkv_bias":
            mods, leaf, arr = mods + ["qkv"], "bias", arr.reshape(-1)
        key = {"embedding": "weight", "scale": "weight", "kernel": "weight",
               "bias": "bias"}[leaf]
        if leaf == "kernel":
            arr = arr.T
        out[".".join(mods + [key])] = np.ascontiguousarray(arr)
    return out


def moe_from_flax(variables: Mapping, mesh=None,
                  ep_axis: str = "ep") -> Dict[str, np.ndarray]:
    """The state dict of the port's Switch-MoE GPT for the JAX package's
    ``MoETransformerLM`` variables: the trunk as :func:`gpt_from_flax`, each
    block's ``moe`` as its ``mlp``; the ``router`` as it is, the experts'
    global ``(E, ...)`` ``wi`` and ``wo`` cut over ``ep_axis`` of ``mesh``
    into ``(ep, E / ep, ...)`` (kept whole without a mesh).  Exact."""
    params = dict(variables.get("params", variables))
    moe = {}
    trunk = {}
    for blk, sub in params.items():
        if isinstance(sub, Mapping) and "moe" in sub:
            moe[blk] = sub["moe"]
            sub = {k: v for k, v in sub.items() if k != "moe"}
        trunk[blk] = sub
    out = _from_flax(trunk, "MoE GPT")
    for blk, leaves in moe.items():
        for leaf, arr in leaves.items():
            arr = np.asarray(arr)
            if leaf in ("wi", "wo") and mesh is not None:
                arr = shard_from_global(arr, (ep_axis,), mesh)
            out[f"{blk}.mlp.{leaf}"] = np.ascontiguousarray(arr)
    return out


def flax_from_moe(state: Mapping[str, object]) -> Dict:
    """The inverse of :func:`moe_from_flax` for an unsharded model (or an
    expert-parallel one's experts already joined to ``(E, ...)``)."""
    trunk, moe = {}, {}
    for name, val in state.items():
        if ".mlp." in name:
            arr = (val.detach().cpu().numpy()
                   if isinstance(val, torch.Tensor) else np.asarray(val))
            blk, _, leaf = name.split(".")
            if leaf in ("wi", "wo"):
                arr = arr.reshape(-1, *arr.shape[-2:])
            moe.setdefault(blk, {})[leaf] = np.ascontiguousarray(arr)
        else:
            trunk[name] = val
    params = _to_flax(trunk, ("tok", "pos"), "MoE GPT")["params"]
    for blk, leaves in moe.items():
        params.setdefault(blk, {})["moe"] = leaves
    return {"params": params}
