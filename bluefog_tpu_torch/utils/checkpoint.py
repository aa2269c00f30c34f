"""Checkpoint and resume of rank-stacked training state, and restart after
failure.

Counterpart of ``bluefog_tpu/utils/checkpoint.py`` (:class:`CheckpointManager`,
``_consensus``, :func:`resize_rank_state`, ``_classify_shapes``,
``_restore_elastic``, :func:`run_with_restart`), with the reference's
semantics and orbax replaced by files of this module's own layout:

- Each step is a directory ``step_<k>`` under the manager's root, holding
  ``manifest.json`` (every leaf's tree path, global shape and dtype, the mode
  and the process count) and one ``proc<p>.pt`` a process, written by
  ``torch.save``.  A step is written under a hidden temporary name and
  ``os.replace``-d into place, so a save that fails part way leaves no
  visible step.  ``max_to_keep`` newest steps are kept.
- Tensors come back through ``torch.load(weights_only=True)``, so numpy
  arrays and scalars are stored as tensors (a numpy scalar as a 0-d tensor,
  as the reference normalises them for orbax).
- ``mode='per_rank'`` stores the rank-stacked tree exactly (a bitwise resume
  of every rank's own model); ``mode='consensus'`` stores the rank mean
  (floats averaged in f64, integer leaves rank 0's copy): the artifact to
  deploy.
- Saves run on one background thread (the reference's native host engine is
  not ported): the device-to-host copy happens before the save is queued,
  at most one save is in flight, and :meth:`CheckpointManager.wait`
  re-raises its IO error.
- Over processes (``torch.distributed`` initialized, ``P`` processes) every
  array leaf is this process's owned block of ranks: each process writes its
  block as ``proc<p>.pt``, and process 0 writes the manifest and renames the
  directory after a barrier (in :meth:`~CheckpointManager.wait`, so every
  collective runs on the calling thread).  A restore at the same ``P``
  reads only the process's own block; at another process count or world
  size it reads every block, resizes the rank axis where the world changed,
  and keeps the owned rows.

:func:`run_with_restart` restores the latest checkpoint after a recoverable
failure, resizing the rank axis when the world size changed.
"""

from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import re
import shutil
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ["CheckpointManager", "run_with_restart", "resize_rank_state"]

log = logging.getLogger("bluefog_tpu_torch")

_STEP = re.compile(r"^step_(\d+)$")
_MANIFEST = "manifest.json"


def _procs() -> Tuple[int, int]:
    """``(this process, process count)`` of torch.distributed's group, or
    ``(0, 1)`` outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _ranked(leaf) -> bool:
    """Whether a leaf carries the rank axis: an array of rank >= 1."""
    return getattr(leaf, "ndim", 0) >= 1


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _to_host(leaf):
    """A host copy of ``leaf`` that training may not touch: tensors copied to
    the CPU, numpy arrays and scalars as tensors (a scalar as a 0-d tensor);
    Python values as they are."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(leaf))
    return leaf


def _mean_rows(t: torch.Tensor) -> torch.Tensor:
    """The f64 mean over the leading axis, the rows added in order (numpy's
    ``astype(float64).mean(axis=0)``)."""
    acc = t[0].double().clone()
    for row in t[1:]:
        acc += row.double()
    return acc / t.shape[0]


def _consensus(state):
    """Collapse the leading rank axis: floating leaves are averaged (the
    consensus model); integer/bool leaves (step counters, seeds) take rank
    0's copy, since their element-wise means would be corrupt; 0-d leaves
    pass through."""
    def one(leaf):
        if not _ranked(leaf):
            return leaf
        t = torch.as_tensor(leaf)
        if t.is_floating_point() or t.is_complex():
            return _mean_rows(t).to(t.dtype)
        return t[0]

    return pytree.tree_map(one, state)


def _norm_key(p) -> str:
    """A tree-path entry as a string, so mapping keys, sequence indices and
    attribute names compare alike."""
    for attr in ("key", "name", "idx"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def _path_leaves(tree) -> Dict[Tuple[str, ...], Any]:
    """``{normalized path tuple: leaf}`` for every leaf of ``tree``."""
    return {tuple(_norm_key(p) for p in path): leaf
            for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


def _resize_leaf(leaf, new_size: int):
    if not _ranked(leaf):
        return leaf
    t = torch.as_tensor(leaf)
    n = t.shape[0]
    if n == new_size:
        return t
    if new_size < n:
        if t.is_floating_point() or t.is_complex():
            return torch.stack([_mean_rows(t[j::new_size])
                                for j in range(new_size)]).to(t.dtype)
        return t[:new_size]
    reps = -(-new_size // n)
    return t.repeat(reps, *([1] * (t.ndim - 1)))[:new_size]


def resize_rank_state(state, new_size: int):
    """Map a rank-stacked tree saved at world size N onto ``new_size`` = M
    ranks (elastic re-topology).

    Shrink (M < N): surviving rank ``j`` folds ranks ``j, j+M, j+2M, ...``,
    floating leaves by averaging (each orphaned replica's divergence is
    merged instead of dropped), integer leaves take the group's first
    member.  Grow (M > N): new rank ``j`` starts from a copy of rank ``j %
    N``.  0-d and non-array leaves pass through."""
    return pytree.tree_map(lambda leaf: _resize_leaf(leaf, new_size), state)


def _leading_dim(tree) -> Optional[int]:
    for leaf in pytree.tree_leaves(tree):
        if _ranked(leaf):
            return int(_shape(leaf)[0])
    return None


def _classify_shapes(stored, template) -> str:
    """Compare stored leaf shapes (``{path tuple: shape}``, as
    :meth:`CheckpointManager.stored_shapes` gives them) with the template's:
    ``'exact'`` (same paths, same shapes), ``'rank_resize'`` (same paths; a
    pure rank-axis change: every array leaf's leading dim is its tree's
    world size and the trailing dims match per path), or ``'mismatch'``.  A
    consensus-mode checkpoint (no rank axis) or another model is a
    mismatch: resizing it would average along a weight axis."""
    t_shapes = {k: _shape(v) for k, v in _path_leaves(template).items()}
    if set(stored) != set(t_shapes):
        return "mismatch"
    if all(tuple(stored[k]) == t_shapes[k] for k in t_shapes):
        return "exact"
    n_src = next((s[0] for s in stored.values() if len(s)), None)
    n_tgt = next((s[0] for s in t_shapes.values() if len(s)), None)
    if n_src is None or n_tgt is None or n_src == n_tgt:
        return "mismatch"
    for k, t in t_shapes.items():
        s = tuple(stored[k])
        if (len(s) == 0) != (len(t) == 0):
            return "mismatch"
        if len(s) == 0:
            continue
        if s[0] != n_src or t[0] != n_tgt or s[1:] != t[1:]:
            return "mismatch"
    return "rank_resize"


def _global_template(template, procs: int):
    """The template with every array leaf at its global shape (the owned
    rows times the process count), as meta tensors: no memory."""
    if procs == 1:
        return template

    def one(leaf):
        if not _ranked(leaf):
            return leaf
        s = _shape(leaf)
        return torch.empty((s[0] * procs,) + tuple(s[1:]), device="meta")

    return pytree.tree_map(one, template)


def _like(value, t_leaf):
    """A restored ``value`` in the template leaf's type, dtype and device."""
    if isinstance(t_leaf, torch.Tensor):
        return torch.as_tensor(value).to(device=t_leaf.device,
                                         dtype=t_leaf.dtype)
    if isinstance(t_leaf, (np.ndarray, np.generic)):
        return np.asarray(torch.as_tensor(value).numpy()).astype(t_leaf.dtype)
    if isinstance(t_leaf, (bool, int, float)) and not isinstance(
            value, (bool, int, float)):
        return type(t_leaf)(torch.as_tensor(value).item())
    return value


def _nested(flat: Dict[Tuple[str, ...], Any]) -> Dict:
    """Nested dicts (string keys, as orbax stores containers) from path
    tuples."""
    out: Dict = {}
    for path, leaf in flat.items():
        tree = out
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = leaf
    return out


class CheckpointManager:
    """Save and restore rank-stacked training state with retention and
    asynchronous IO.

    Args:
      directory: checkpoint root (created if missing).
      max_to_keep: retention: the newest steps kept (None: all).
      async_save: write saves on a background thread (default True).
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._async = async_save
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: Optional[concurrent.futures.Future] = None
        self._commit: Optional[tuple] = None
        self.last_save_bytes = 0

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, *, mode: str = "per_rank",
             force: bool = False) -> None:
        """Save ``state`` at ``step``.

        ``mode='per_rank'`` stores the rank-stacked tree exactly;
        ``mode='consensus'`` stores the rank-averaged tree (resume gives
        every rank the average, as the reference's post-load
        ``broadcast_parameters`` would).  A step that exists raises unless
        ``force``, which replaces it."""
        if mode not in ("per_rank", "consensus"):
            raise ValueError(f"unknown checkpoint mode {mode!r}")
        self.wait()  # at most one save in flight
        if os.path.exists(self._step_dir(step)) and not force:
            raise ValueError(f"checkpoint step {step} already exists under "
                             f"{self.directory}")
        proc, procs = _procs()
        # the device-to-host copy happens here, before the save is queued,
        # so training may change the live tensors once this returns
        host = pytree.tree_map(_to_host, state)
        if mode == "consensus":
            if procs > 1:
                host = self._gathered(host, proc, procs)
            host = _consensus(host) if host is not None else None
            ranked = False
        else:
            ranked = True
        flat = _path_leaves(host) if host is not None else {}
        manifest = None
        if proc == 0:
            grow = procs if ranked else 1
            manifest = {"step": int(step), "mode": mode, "processes":
                        procs if ranked else 1, "leaves": [
                            {"path": list(k), "ranked": ranked and
                             _ranked(v), "dtype": str(getattr(
                                 v, "dtype", type(v).__name__)),
                             "shape": ([_shape(v)[0] * grow]
                                       + list(_shape(v)[1:])
                                       if ranked and _ranked(v)
                                       else list(_shape(v)))}
                            for k, v in flat.items()]}
        tmp = os.path.join(self.directory, f".step_{step}.tmp")
        block = ({json.dumps(list(k)): v for k, v in flat.items()}
                 if host is not None else None)
        self.last_save_bytes = sum(v.numel() * v.element_size()
                                   for v in flat.values()
                                   if isinstance(v, torch.Tensor))
        commit = (step, tmp, manifest, force)

        def write():
            try:
                os.makedirs(tmp, exist_ok=True)
                if block is not None:
                    torch.save(block, os.path.join(tmp, f"proc{proc}.pt"))
                if procs == 1:
                    self._finish(*commit)
            except BaseException:
                if procs == 1:
                    shutil.rmtree(tmp, ignore_errors=True)
                raise

        if procs > 1:
            self._commit = commit
        if self._async:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    1, thread_name_prefix="bf-checkpoint")
            self._pending = self._pool.submit(write)
        else:
            self._pending = concurrent.futures.Future()
            try:
                write()
                self._pending.set_result(None)
            except BaseException as e:  # noqa: BLE001: raised at wait()
                self._pending.set_exception(e)
            self.wait()

    @staticmethod
    def _gathered(host, proc: int, procs: int):
        """Process 0's view of the whole rank-stacked tree (every process's
        block in process order); None elsewhere."""
        import torch.distributed as dist

        blocks = [None] * procs if proc == 0 else None
        dist.gather_object(host, blocks, dst=0)
        if proc != 0:
            return None
        flats = [pytree.tree_flatten(b)[0] for b in blocks]
        leaves, spec = pytree.tree_flatten(blocks[0])
        merged = [torch.cat([f[i] for f in flats]) if _ranked(leaf) else leaf
                  for i, leaf in enumerate(leaves)]
        return pytree.tree_unflatten(merged, spec)

    def _finish(self, step: int, tmp: str, manifest, force: bool) -> None:
        """Process 0's half of a commit: the manifest, then the rename that
        makes the step visible, then retention."""
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        final = self._step_dir(step)
        if force and os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.max_to_keep:
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def wait(self) -> None:
        """Join the in-flight save, re-raising its IO error.  Over processes
        this is also where the save commits: every process's block written,
        process 0 writes the manifest and renames the step after a
        barrier."""
        pending, self._pending = self._pending, None
        commit, self._commit = self._commit, None
        err = None
        if pending is not None:
            try:
                pending.result()
            except BaseException as e:  # noqa: BLE001: re-raised below
                err = e
        if commit is not None:
            import torch.distributed as dist

            proc, procs = _procs()
            oks = [None] * procs
            dist.all_gather_object(oks, err is None)
            if proc == 0:
                if all(oks):
                    self._finish(*commit)
                else:
                    shutil.rmtree(commit[1], ignore_errors=True)
            dist.barrier()
            if err is None and not all(oks):
                err = RuntimeError(
                    f"checkpoint step {commit[0]} failed on process(es) "
                    f"{[q for q, ok in enumerate(oks) if not ok]}")
        if err is not None:
            raise err

    # --------------------------------------------------------------- restore
    def _steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = _STEP.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 _MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def all_steps(self):
        self.wait()
        return self._steps()

    def _manifest(self, step: int) -> Dict:
        with open(os.path.join(self._step_dir(step), _MANIFEST)) as f:
            return json.load(f)

    def _load(self, step: int, proc: int) -> Dict[Tuple[str, ...], Any]:
        path = os.path.join(self._step_dir(step), f"proc{proc}.pt")
        block = torch.load(path, map_location="cpu", weights_only=True)
        return {tuple(json.loads(k)): v for k, v in block.items()}

    def _load_global(self, step: int, manifest) -> Dict[Tuple[str, ...],
                                                        Any]:
        """Every leaf at its global shape: the blocks of every process that
        wrote one, concatenated along the rank axis in process order."""
        blocks = [self._load(step, q) for q in range(manifest["processes"])]
        out = {}
        for leaf in manifest["leaves"]:
            k = tuple(leaf["path"])
            out[k] = (torch.cat([b[k] for b in blocks]) if leaf["ranked"]
                      and len(blocks) > 1 else blocks[0][k])
        return out

    def _load_owned(self, step: int, manifest) -> Dict[Tuple[str, ...], Any]:
        """This process's rows of every leaf: its own block when the
        checkpoint was written by as many processes, else its slice of the
        global leaves."""
        proc, procs = _procs()
        if manifest["processes"] == procs:
            return self._load(step, proc)
        flat = self._load_global(step, manifest)
        if procs == 1:
            return flat
        ranked = {tuple(leaf["path"]) for leaf in manifest["leaves"]
                  if leaf["ranked"]}
        out = {}
        for k, v in flat.items():
            if k in ranked:
                rows = v.shape[0] // procs
                v = v[proc * rows:(proc + 1) * rows]
            out[k] = v
        return out

    def restore(self, step: Optional[int] = None, *,
                template: Optional[Any] = None) -> Any:
        """Restore ``step`` (default: the latest).  With a ``template`` (a
        tree of this process's leaves, as saved), into its structure,
        dtypes and devices; a shape that differs raises.  Without one, the
        stored tree as nested dicts of CPU tensors, every process's rows."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        manifest = self._manifest(step)
        if template is None:
            return _nested(self._load_global(step, manifest))
        flat = self._load_owned(step, manifest)
        paths, spec = pytree.tree_flatten_with_path(template)
        out = []
        for path, t_leaf in paths:
            key = tuple(_norm_key(p) for p in path)
            if key not in flat:
                raise KeyError(f"checkpoint step {step} has no leaf "
                               f"{'/'.join(key)}")
            value = flat[key]
            if _shape(value) != _shape(t_leaf):
                raise ValueError(
                    f"checkpoint leaf {'/'.join(key)} has shape "
                    f"{_shape(value)}, the template {_shape(t_leaf)}")
            out.append(_like(value, t_leaf))
        return pytree.tree_unflatten(out, spec)

    def stored_shapes(self, step: int):
        """The stored leaves' global shapes by path tuple, read from the
        manifest without loading data; None when it cannot be read."""
        self.wait()
        try:
            return {tuple(leaf["path"]): tuple(leaf["shape"])
                    for leaf in self._manifest(step)["leaves"]}
        except (OSError, ValueError, KeyError):
            return None

    def close(self) -> None:
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None


def _restore_elastic(manager: CheckpointManager, step: int, template):
    """Restore ``step`` into ``template`` (this process's rows), validating
    the shapes from the manifest first: an exact match restores as saved; a
    pure rank-axis change (the world shrank or grew) loads every block,
    resizes the rank axis and keeps this process's rows; anything else
    raises.  Leaves are aligned by tree path."""
    proc, procs = _procs()
    shapes = manager.stored_shapes(step)
    if shapes is None:
        return manager.restore(step, template=template)
    g_template = _global_template(template, procs)
    kind = _classify_shapes(shapes, g_template)
    if kind == "exact":
        return manager.restore(step, template=template)
    if kind == "mismatch":
        raise ValueError(
            f"checkpoint step {step} shapes do not match the template and "
            "are not a pure world-size change: refusing to restore")
    n_src = next((s[0] for s in shapes.values() if len(s)), None)
    n_tgt = _leading_dim(g_template)
    log.warning("elastic resume: checkpoint world size %d -> current %d",
                n_src, n_tgt)
    raw = manager._load_global(step, manager._manifest(step))
    paths, spec = pytree.tree_flatten_with_path(template)
    out = []
    for path, t_leaf in paths:
        key = tuple(_norm_key(p) for p in path)
        r = _resize_leaf(raw[key], n_tgt)
        if _ranked(t_leaf) and procs > 1:
            rows = n_tgt // procs
            r = r[proc * rows:(proc + 1) * rows]
        out.append(_like(r, t_leaf))
    return pytree.tree_unflatten(out, spec)


def run_with_restart(
    train_fn: Callable[..., Any],
    manager: CheckpointManager,
    init_state: Any,
    *,
    max_restarts: int = 3,
    recoverable: tuple = (Exception,),
    heartbeat_timeout_s: Optional[float] = None,
    heartbeat_grace_s: float = 30.0,
) -> Any:
    """Failure detection and recovery loop.

    Calls ``train_fn(state, start_step)``; ``train_fn`` checkpoints through
    ``manager`` as it trains and returns the final state.  On a recoverable
    exception the latest checkpoint is restored (or ``init_state`` if none
    was written yet) and ``train_fn`` is re-entered at ``latest_step + 1``,
    at most ``max_restarts`` times; after that the last failure propagates.
    When the restarted run brings a different world size (``init_state``'s
    rank axis differs from the checkpoint's), the state is resized by
    :func:`resize_rank_state`: shrink folds orphaned replicas into
    survivors by averaging, grow clones.

    ``heartbeat_timeout_s`` also arms a hang watchdog
    (:class:`~bluefog_tpu_torch.utils.failure.Heartbeat`): ``train_fn`` is
    then called as ``train_fn(state, start_step, heartbeat)`` and must call
    ``heartbeat.beat(step)`` once a step.  A silent hang gets a
    :class:`~bluefog_tpu_torch.utils.failure.HangError` injected, caught
    here like any failure; a hang stuck in native code past
    ``heartbeat_grace_s`` terminates the process for an outer supervisor.
    """
    from bluefog_tpu_torch.utils.failure import HangError, Heartbeat

    if heartbeat_timeout_s is not None:
        recoverable = tuple(recoverable) + (HangError,)
    restarts = 0
    while True:
        # recovery (latest_step / restore, which also joins and re-raises a
        # failed save) sits inside the same try as training, so a failure
        # there counts against max_restarts too
        try:
            step = manager.latest_step()
            if step is None:
                state, start = init_state, 0
            else:
                state = _restore_elastic(manager, step, init_state)
                start = step + 1
                log.info("restarting from checkpoint step %d", step)
            if heartbeat_timeout_s is None:
                return train_fn(state, start)
            with Heartbeat(heartbeat_timeout_s,
                           grace_s=heartbeat_grace_s) as hb:
                return train_fn(state, start, hb)
        except recoverable as e:  # noqa: PERF203
            restarts += 1
            if restarts > max_restarts:
                log.error("giving up after %d restarts: %s", max_restarts, e)
                raise
            log.warning("training failed (%s); restart %d/%d",
                        e, restarts, max_restarts)
            # janitor: win_mutex keys whose lease expired (held by a worker
            # thread the failure killed, say) must not stall the restarted
            # attempt until a contender's stealing notices
            try:
                from bluefog_tpu_torch.parallel.api import win_mutex_sweep

                swept = win_mutex_sweep()
                if swept:
                    log.warning("cleared %d expired win_mutex lease(s) "
                                "before restart", swept)
            except Exception as sweep_err:  # the restart goes on regardless
                log.warning("win_mutex sweep before restart failed: %s",
                            sweep_err)
