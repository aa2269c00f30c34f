"""One-sided window ops over rank-stacked tensors.

Counterpart of ``bluefog_tpu/ops/windows.py``.  A window holds, for every
rank, a *self* buffer (the value it publishes) and one landing buffer per
schedule slot (one per in-neighbour); ``win_put`` / ``win_accumulate`` /
``win_get`` write into the landing buffers of the receiving ranks, and
``win_update`` forms the weighted average of self and landing buffers.
The JAX package carries a window as functional per-rank state inside
``shard_map``; here the ``n`` ranks are virtual and every buffer carries them
on its leading axis.

Window memory is **one contiguous rank-stacked buffer per dtype**: the self
buffer is ``(n, L)`` and the landing buffers ``(n, K, L)``, with the window's
leaves packed along ``L`` in flatten order (the layout of ``fuse_apply``'s
buffers).  The pytrees callers see (:attr:`WindowState.self_buf`,
:attr:`WindowState.peer_bufs`) are views into them.  One put of ResNet-50's
f32 parameters is then one launch of the deliver kernel K2, not one per
leaf; the arithmetic is element-wise, so the values equal the JAX package's
per-leaf ones.

Unlike the JAX package's immutable state, a window here is updated **in
place**: every op writes the window's buffers and returns the same
:class:`WindowState`.  The pytree ``win_update`` returns is a view of the
window's self buffer, so it changes when that buffer is next written
(``win_sync``, ``win_update``, ``win_update_then_collect``).

Delivery routes per call through
:func:`~bluefog_tpu_torch.ops.deliver_kernel.resolve_window_backend`:
``'kernel'`` (K2, any schedule; the counterpart of ``'pallas'``) or
``'plain'`` (the counterpart of ``'xla'``).  The associated push-sum scalar
``p`` always takes the plain path, as in the JAX package.  ``win_update`` and
``win_update_then_collect`` are plain PyTorch, as the JAX package computes
them outside any kernel.

In a context that spans processes (:mod:`bluefog_tpu_torch.ops.transport`)
a window holds this process's owned ``m`` rows.  On the card its landing
buffers are allocated in peer memory (:class:`~bluefog_tpu_torch.ops.
transport.WindowLinks`): ``win_put`` and ``win_accumulate`` store this
process's payload into the receivers' slots, in whichever process they live,
through K2's peer form (``'kernel'``) or its plain twin (``'plain'``), and
``win_update`` first waits on the deliverers.  The self buffer stays this
process's own: every op pushes, so no peer reads it.  On the CPU the rows a
process's slots take arrive over gloo and the receiver lands them.

Not ported: window partitioning (``rule_table=`` / ``partition=``, with the
sharding slice), and the timeline, blackbox and metrics hooks (with the
observability slice).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from bluefog_tpu_torch.ops import deliver_kernel as _k2
from bluefog_tpu_torch.ops import gossip_kernel as _k1
from bluefog_tpu_torch.ops import transport as _T
from bluefog_tpu_torch.ops.collectives import _acc_dtype, _as_schedule
from bluefog_tpu_torch.topology.schedule import GossipSchedule

__all__ = [
    "WindowSpec",
    "WindowState",
    "win_create",
    "win_free",
    "win_put",
    "win_get",
    "win_accumulate",
    "win_update",
    "win_update_then_collect",
    "win_sync",
    "win_associated_p",
]


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Static window metadata: the schedule the window was created with, and
    its name."""

    schedule: GossipSchedule
    name: str = "win"


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where each leaf of a window's pytree lives: ``(dtype, offset,
    per-rank shape)`` in its dtype's ``(n, L)`` buffer, leaves in flatten
    order; ``dtypes`` lists the buffers in order of first appearance."""

    treedef: pytree.TreeSpec
    n: int
    leaves: Tuple[Tuple[torch.dtype, int, torch.Size], ...]
    dtypes: Tuple[torch.dtype, ...]

    @classmethod
    def of(cls, tree) -> "_Layout":
        leaves, treedef = pytree.tree_flatten(tree)
        if not leaves or any(not isinstance(t, torch.Tensor) or t.dim() == 0
                             for t in leaves):
            raise ValueError("a window needs a pytree of rank-stacked tensors")
        n = leaves[0].shape[0]
        ends: Dict[torch.dtype, int] = {}
        placed = []
        for t in leaves:
            if t.shape[0] != n:
                raise ValueError(f"leaves must share the leading rank axis "
                                 f"{n}, got shape {tuple(t.shape)}")
            off = ends.get(t.dtype, 0)
            placed.append((t.dtype, off, t.shape[1:]))
            ends[t.dtype] = off + math.prod(t.shape[1:])
        return cls(treedef, n, tuple(placed), tuple(ends))

    def pack(self, tree, device, out: Optional[Dict] = None
             ) -> Dict[torch.dtype, torch.Tensor]:
        """``tree``'s leaves concatenated into one ``(n, L)`` buffer per
        dtype: new buffers on ``device``, or written into ``out``."""
        leaves, treedef = pytree.tree_flatten(tree)
        if treedef != self.treedef:
            raise ValueError(f"pytree structure {treedef} does not match the "
                             f"window's {self.treedef}")
        parts: Dict[torch.dtype, List[torch.Tensor]] = {
            dt: [] for dt in self.dtypes}
        for t, (dt, _, shape) in zip(leaves, self.leaves):
            t = torch.as_tensor(t).detach()
            if tuple(t.shape) != (self.n, *shape):
                raise ValueError(f"leaf of shape {tuple(t.shape)} where the "
                                 f"window holds {(self.n, *shape)}")
            parts[dt].append(t.to(device=device, dtype=dt).reshape(self.n, -1))
        if out is None:
            return {dt: torch.cat(ps, dim=1) for dt, ps in parts.items()}
        for dt, ps in parts.items():
            dst = out[dt]
            if any(_shares_storage(p, dst) for p in ps):
                dst.copy_(torch.cat(ps, dim=1))
            else:
                torch.cat(ps, dim=1, out=dst)
        return out

    def views(self, bufs: Dict[torch.dtype, torch.Tensor]):
        """The pytree over ``(n, L)`` (or ``(n, K, L)``) buffers: each leaf a
        view of its span, shaped ``(n, *shape)`` (or ``(n, K, *shape)``)."""
        out = []
        for dt, off, shape in self.leaves:
            buf = bufs[dt]
            out.append(buf[..., off:off + math.prod(shape)].view(
                *buf.shape[:-1], *shape))
        return pytree.tree_unflatten(out, self.treedef)


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


@dataclasses.dataclass(eq=False)
class WindowState:
    """Window memory of all ``n`` ranks.

    Attributes:
      spec: static metadata (schedule, name).
      bufs: ``{dtype: (n, L)}`` self buffers, what each rank publishes.
      peers: ``{dtype: (n, K, L)}`` landing buffers, slot ``k`` of rank ``i``
        receiving from ``recv_src[i, k]``.
      links: over several processes on the card, the landing buffers in
        peer memory and the signals ordering deliveries against updates
        (``peers`` and ``assoc_peers`` are this process's own of them).
      assoc_self / assoc_peers: the associated push-sum scalar ``p``,
        ``(n,)`` f32, and its landing slots ``(n, K)``, when the window was
        created with ``associated_p=True``; else None.  Every put,
        accumulate and get moves ``p`` with the tensor's weight, and updates
        merge it with the same weights, so ``self_buf / p`` de-biases
        directed gossip.
    """

    spec: WindowSpec
    layout: _Layout
    bufs: Dict[torch.dtype, torch.Tensor]
    peers: Dict[torch.dtype, torch.Tensor]
    assoc_self: Optional[torch.Tensor] = None
    assoc_peers: Optional[torch.Tensor] = None
    links: Optional[_T.WindowLinks] = None

    @property
    def self_buf(self):
        """The self buffers as the window's pytree of ``(n, ...)`` views."""
        return self.layout.views(self.bufs)

    @property
    def peer_bufs(self):
        """The landing buffers as the window's pytree of ``(n, K, ...)``
        views."""
        return self.layout.views(self.peers)

    @property
    def device(self) -> torch.device:
        return next(iter(self.bufs.values())).device


def win_create(x, schedule, *, name: str = "win", associated_p: bool = False,
               rule_table=None, partition=None) -> WindowState:
    """Allocate window buffers for the pytree ``x`` of rank-stacked tensors,
    on ``x``'s device.

    The landing slots start as copies of ``x``, so a ``win_update`` before
    any communication returns ``x`` unchanged.  With ``associated_p=True``
    the window also carries the push-sum scalar ``p``, 1 on every rank, and
    the landing slots start empty (zeros, for the tensor and for ``p``), so
    all initial mass lives at self with weight 1.  Read ``p`` with
    :func:`win_associated_p`.

    ``rule_table`` / ``partition`` (window partitioning) are not ported and
    raise ``NotImplementedError``."""
    if rule_table is not None or partition is not None:
        raise NotImplementedError(
            "window partitioning (rule_table= / partition=) is not ported "
            "yet; it comes with the sharding slice")
    sched = _as_schedule(schedule)
    layout = _Layout.of(x)
    rows = _T.owned_rows(sched.size)
    if layout.n != rows:
        raise ValueError(f"leaves must be rank-stacked with leading axis "
                         f"{rows}, got {layout.n}")
    device = pytree.tree_leaves(x)[0].device
    bufs = layout.pack(x, device)
    k = sched.num_slots
    f32 = dict(dtype=torch.float32, device=device)
    tr = _T.active()
    links = None
    if tr is not None and device.type == "cuda":
        # landing buffers in peer memory, zeroed; the senders store there
        links = tr.window_links(rows, k, {dt: b.shape[1]
                                          for dt, b in bufs.items()},
                                associated_p)
        peers = links.landing
        p_peers = links.p_landing[..., 0] if associated_p else None
        if not associated_p:
            for dt, b in bufs.items():
                peers[dt].copy_(b[:, None].expand(-1, k, -1))
        # a sender's first store waits for these writes
        links.consumed.record()
    else:
        if associated_p:
            peers = {dt: b.new_zeros(b.shape[0], k, b.shape[1])
                     for dt, b in bufs.items()}
        else:
            peers = {dt: b[:, None].expand(-1, k, -1).clone()
                     for dt, b in bufs.items()}
        p_peers = torch.zeros(rows, k, **f32) if associated_p else None
    p = torch.ones(rows, **f32) if associated_p else None
    return WindowState(WindowSpec(sched, name), layout, bufs, peers, p,
                       p_peers, links)


def win_associated_p(state: WindowState) -> torch.Tensor:
    """The window's associated push-sum scalar ``p``, ``(n,)``."""
    if state.assoc_self is None:
        raise ValueError(
            f"window {state.spec.name!r} was created without associated_p")
    return state.assoc_self


def win_free(state: WindowState) -> None:
    """Free the window's memory.  In one process, and on the CPU, its
    buffers are freed when it is dropped; over several processes on the
    card its landing buffers in peer memory are unmapped and freed now, in
    every process (collective: every process frees its block of the
    window), and the window must not be used again."""
    tr = _T.active()
    if state.links is not None and tr is not None:
        tr.release_window(state.links)
        state.links = None
        state.peers = {}
        state.assoc_peers = None


def _deliver(state: WindowState, payload: Dict[torch.dtype, torch.Tensor], *,
             accumulate: bool, dst_weight=1.0,
             backend: str = "auto") -> WindowState:
    """Land ``dst_weight * payload`` (one ``(n, L)`` buffer per dtype) in the
    receivers' slots, and ``dst_weight * p`` in ``p``'s slots when the window
    carries it."""
    sched = state.spec.schedule
    route = _k2.resolve_window_backend(backend, sched)
    if sched.num_slots == 0:
        return state  # no in-edges anywhere: nothing lands
    w = float(dst_weight)
    tr = _T.active()
    if tr is not None:
        return _deliver_procs(tr, state, payload, accumulate, w, route)
    src, mask = _k2.deliver_tables(sched, state.device)
    if state.assoc_self is not None:
        # the scalar rides the plain path on every backend, as in the JAX
        # package: an (n,) payload is noise next to the tensor's
        _k2.window_deliver_plain(state.assoc_self[:, None],
                                 state.assoc_peers[:, :, None], src, mask, w,
                                 accumulate=accumulate)
    # the route alone picks the function: the kernel wrapper runs its plain
    # version only on CPU tensors
    fn = (_k2.window_deliver if route == "kernel"
          else _k2.window_deliver_plain)
    for dt, peers in state.peers.items():
        fn(payload[dt], peers, src, mask, w, accumulate=accumulate)
    return state


def _deliver_procs(tr, state: WindowState, payload, accumulate: bool,
                   w: float, route: str) -> WindowState:
    """:func:`_deliver` over several processes: on the card this process
    stores its payload into the receivers' slots through peer memory; on
    the CPU the rows its own slots take arrive over gloo."""
    sched = state.spec.schedule
    if state.links is not None:
        fn = (_k2.window_deliver_peer if route == "kernel"
              else _k2.window_deliver_peer_plain)
        with tr.delivering(state.links):
            if state.assoc_self is not None:
                _k2.window_deliver_peer_plain(
                    state.assoc_self[:, None],
                    tr.window_targets(state.links, sched, "p"), w,
                    accumulate=accumulate)
            for dt in state.peers:
                fn(payload[dt], tr.window_targets(state.links, sched, dt), w,
                   accumulate=accumulate)
        return state
    mask = _owned(_k2.deliver_tables(sched, state.device)[1], sched)
    dts = list(state.peers)
    flats = [payload[dt] for dt in dts]
    if state.assoc_self is not None:
        flats.append(state.assoc_self[:, None])
    with tr.exchange(sched, flats) as rows:
        for dt, r in zip(dts, rows):
            _k2.window_deliver_rows_plain(state.peers[dt], r, mask, w,
                                          accumulate=accumulate)
        if state.assoc_self is not None:
            _k2.window_deliver_rows_plain(state.assoc_peers[:, :, None],
                                          rows[-1], mask, w,
                                          accumulate=accumulate)
    return state


def _owned(t: torch.Tensor, sched: GossipSchedule) -> torch.Tensor:
    """A table over the schedule's ranks cut to this process's rows (all of
    them in one process)."""
    s = _T.owned_start(sched.size)
    return t[s:s + _T.owned_rows(sched.size)]


@contextlib.contextmanager
def _reading(state: WindowState):
    """Around an op that reads or rewrites the landing buffers: over
    several processes on the card, the senders' stores have landed before
    it and the next stores wait for it."""
    tr = _T.active()
    if tr is None or state.links is None:
        yield
        return
    with tr.updating(state.links):
        yield


def _prepare_payload(state: WindowState, x):
    """``x=None`` ships the self buffers as they are; an explicit ``x`` is
    packed into the window's layout (one copy per dtype)."""
    if x is not None and state.assoc_self is not None:
        # shipping a tensor that is not the window's tracked state would
        # desynchronize the (x, p) push-sum recursion and bias self_buf / p
        raise ValueError(
            f"window {state.spec.name!r} carries an associated push-sum "
            "scalar; pass x=None (ships self_buf) or win_sync(state, x) "
            "first so the (x, p) mass pair stays consistent")
    if x is None:
        return state.bufs
    return state.layout.pack(x, state.device)


@torch.no_grad()
def win_put(state: WindowState, x, *, dst_weight=1.0,
            backend: str = "auto") -> WindowState:
    """Write ``dst_weight * x`` into every out-neighbour's landing buffer
    (``x=None``: the self buffer, without a copy).  The receivers are not
    involved until they ``win_update``.  On an associated-p window
    ``dst_weight * p`` ships alongside, and an explicit ``x`` raises."""
    return _deliver(state, _prepare_payload(state, x), accumulate=False,
                    dst_weight=dst_weight, backend=backend)


@torch.no_grad()
def win_accumulate(state: WindowState, x, *, dst_weight=1.0,
                   backend: str = "auto") -> WindowState:
    """Like :func:`win_put`, but adds into the landing buffers
    (``MPI_Accumulate(MPI_SUM)``), in the window's dtype."""
    return _deliver(state, _prepare_payload(state, x), accumulate=True,
                    dst_weight=dst_weight, backend=backend)


@torch.no_grad()
def win_get(state: WindowState) -> WindowState:
    """Pull each in-neighbour's published value (its self buffer, and ``p``)
    into the matching landing slot."""
    return _deliver(state, state.bufs, accumulate=False)


def _merge(own: torch.Tensor, peers: torch.Tensor, sw: torch.Tensor,
           rw: torch.Tensor) -> torch.Tensor:
    """``sw * own + sum_k rw[:, k] * peers[:, k]`` in ``sw``'s dtype, in slot
    order, each product and sum rounded on its own."""
    acc = sw.dtype
    out = sw[:, None] * own.to(acc)
    for k in range(peers.shape[1]):
        out = out + rw[:, k, None] * peers[:, k].to(acc)
    return out


@torch.no_grad()
def win_update(state: WindowState, *, self_weight=None, recv_weights=None):
    """Weighted average of self and landing buffers, published as the new
    self buffer: ``out = w_self * self + sum_k where(mask_k, w_k, 0) *
    peer_k``, accumulated in f32 for bf16/f16 windows and in the window's
    dtype otherwise.  The weights come from the window's schedule unless
    overridden (``self_weight``: a scalar or ``(n,)``; ``recv_weights``:
    ``(K,)`` or ``(n, K)``).  ``p`` merges with the same weights.  Returns
    ``(out, state)``; ``out`` is the window's pytree of views of the self
    buffer."""
    sched = state.spec.schedule
    dev = state.device
    live = _owned(_k2.deliver_tables(sched, dev)[1], sched) != 0

    def merge(own, peers):
        sw, rw, _ = _k1.schedule_tables(sched, dev, self_weight,
                                        recv_weights,
                                        dtype=_acc_dtype(own.dtype))
        sw, rw = _owned(sw, sched), _owned(rw, sched)
        own.copy_(_merge(own, peers, sw, torch.where(live, rw, 0)))

    with _reading(state):
        for dt, buf in state.bufs.items():
            merge(buf, state.peers[dt])
        if state.assoc_self is not None:
            merge(state.assoc_self[:, None], state.assoc_peers[:, :, None])
    return state.self_buf, state


@torch.no_grad()
def win_update_then_collect(state: WindowState):
    """Sum-collect for push-sum: ``out = self + sum_k mask_k * peer_k`` over
    live slots, published as the new self buffer; then the landing buffers
    (and ``p``'s) are **zeroed**, so accumulated mass is consumed exactly
    once.  Returns ``(out, state)`` as :func:`win_update` does."""
    sched = state.spec.schedule
    live = _owned(_k2.deliver_tables(sched, state.device)[1], sched) != 0

    def collect(own, peers):
        acc = _acc_dtype(own.dtype)
        own.copy_(_merge(own, peers, torch.ones(own.shape[0], dtype=acc,
                                                device=own.device),
                         live.to(acc)))
        peers.zero_()

    with _reading(state):
        for dt, buf in state.bufs.items():
            collect(buf, state.peers[dt])
        if state.assoc_self is not None:
            collect(state.assoc_self[:, None], state.assoc_peers[:, :, None])
    return state.self_buf, state


@torch.no_grad()
def win_sync(state: WindowState, x=None) -> WindowState:
    """Publish a new local value without communicating: copy the pytree
    ``x`` into the self buffers (one copy per dtype).  ``x=None`` is a
    no-op."""
    if x is not None:
        state.layout.pack(x, state.device, out=state.bufs)
    return state
