"""The serving mesh: which devices a service drives, how pipeline groups
are placed on them, and the sharded NNUE evaluators.

The port of ``fishnet_tpu/parallel/mesh.py``. The JAX package shards
with ``jax.sharding`` and ``shard_map``; here a shard is one device (a
``torch.device``, ``cuda:N``) and a sharded call is one call per shard
on that shard's device, its rows in and its results out, concatenated
in shard order. There are no collectives: every shard's work is local
by construction (the pool's aligned emission for the legacy evaluator,
segment-local codes for the segmented one).

Axes: ``data`` (the batch) and ``model`` (the FT width, used by the
JAX trainers only). Serving replicates the parameters and splits the
batch over both axes.

Two serving tiers, as in the JAX package:

* **Per-shard placement** (the default mesh, ``SearchService(
  mesh_devices=...)``): the coalescer routes each pipeline group to a
  shard (``ShardRouter``); each shard holds its own parameter replica,
  anchor tables, async pipeline and ladder rung, and every dispatch is
  a plain single-device launch.
* **The legacy sharded evaluator** (``ShardedEvaluator``, an explicit
  ``--mesh DxM`` with ``M > 1``): one evaluator that splits every
  microbatch over the mesh.

A sequence of devices may name one device twice: two logical shards on
one card exercise the router, the per-shard tables, pipelines, ladders
and drains on a one-card host.
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fishnet_tpu_torch.device import on_device, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _visible(device_type: str) -> List[torch.device]:
    """Every visible device of ``device_type``: ``cuda:0..N-1`` (raises
    without a GPU, as every entry point does), or the one CPU."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    resolve_device("cuda")  # raises when no GPU is visible
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def serving_devices(requested=None, device_type: str = "cuda"
                    ) -> List[torch.device]:
    """The device list a serving mesh drives. ``requested`` is ``None``
    or ``"auto"`` (every visible device of ``device_type``: each
    ``cuda:N``, or the one CPU), an int ``N`` (the first ``N``), or an
    explicit sequence, taken as given — duplicates included, so two
    logical shards may share one card. ``FISHNET_NO_MESH=1`` clamps any
    request to its first device, the single-device service."""
    if requested is None or requested == "auto":
        devs = _visible(device_type)
    elif isinstance(requested, int) and not isinstance(requested, bool):
        devs = _visible(device_type)[: max(1, requested)]
    else:
        devs = [resolve_device(d) for d in requested]
    if os.environ.get("FISHNET_NO_MESH", "0") == "1":
        devs = devs[:1]
    return devs


def replicate_params(params: Dict[str, torch.Tensor],
                     devices: Sequence[torch.device]
                     ) -> List[Dict[str, torch.Tensor]]:
    """One parameter replica per shard, in shard order. Shard 0 keeps
    the caller's dict (the single-device service's object); every other
    shard gets its own copy on its device, even when it shares shard
    0's device, so no two shards ever read one tensor."""
    return [params] + [
        {k: v.to(dev, copy=True) for k, v in params.items()}
        for dev in devices[1:]
    ]


class ShardRouter:
    """Pipeline group -> shard assignment for the coalescer, weighted by
    occupancy (the JAX package's router, decision for decision).

    Groups start round-robin (group g on shard g % n_shards), so each
    driver thread's contiguous groups spread over the mesh and table
    placement is known before any traffic. At a group's FIRST traffic
    (``note_occupancy``, called by the coalescer per submitted
    microbatch) it moves to the least-loaded alive shard, ordered by
    (occupancy EMA, assigned groups, keep the current shard, shard id):
    nothing moves while the mesh is balanced, but a waking group leaves
    a hot shard for an idle one. ``FISHNET_SHARD_PLACEMENT=rr`` keeps
    the static layout (any other value, and the default ``lb``, balance;
    the JAX package's doc/sharding.md describes a ``"0:1,..."`` form
    that its code never read, and neither does this copy).

    ``drain`` — the per-shard ladder's last step — marks a shard dead
    and re-homes its groups least-loaded first (round-robin under
    ``rr``, the same walk when loads are level). All state is guarded by
    one leaf lock, never held while calling out: driver threads read
    ``shard_of`` every step while a sibling may be draining."""

    def __init__(self, n_groups: int, n_shards: int) -> None:
        if n_shards < 1 or n_groups < 1:
            raise ValueError("need at least one group and one shard")
        self.n_groups = n_groups
        self.n_shards = n_shards
        self._lock = threading.Lock()
        self._alive = list(range(n_shards))
        self._assign = {g: g % n_shards for g in range(n_groups)}
        self._rr_only = (
            os.environ.get("FISHNET_SHARD_PLACEMENT", "lb") == "rr"
        )
        self._active: set = set()
        self._load = [0.0] * n_shards
        #: Groups moved by a first-traffic re-home or a drain.
        self.rehomes = 0

    def _least_loaded_locked(self, current: Optional[int] = None) -> int:
        counts = {s: 0 for s in self._alive}
        for s in self._assign.values():
            if s in counts:
                counts[s] += 1
        return min(
            self._alive,
            key=lambda s: (
                self._load[s], counts[s], 0 if s == current else 1, s
            ),
        )

    def shard_of(self, group: int) -> int:
        with self._lock:
            return self._assign[group]

    def note_occupancy(self, group: int, n: int) -> None:
        """Record one submitted microbatch of ``n`` entries on
        ``group``'s shard (the EMA of the coalescer's width policy). A
        group's first note re-homes it to the least-loaded shard unless
        ``FISHNET_SHARD_PLACEMENT=rr`` pins the static layout."""
        with self._lock:
            s = self._assign[group]
            if not self._rr_only and group not in self._active:
                self._active.add(group)
                tgt = self._least_loaded_locked(current=s)
                if tgt != s:
                    self._assign[group] = tgt
                    self.rehomes += 1
                    s = tgt
            self._load[s] = 0.8 * self._load[s] + 0.2 * float(n)

    def shard_loads(self) -> List[float]:
        with self._lock:
            return list(self._load)

    def groups_of(self, shard: int) -> List[int]:
        with self._lock:
            return sorted(g for g, s in self._assign.items() if s == shard)

    def group_count(self, shard: int) -> int:
        with self._lock:
            return sum(1 for s in self._assign.values() if s == shard)

    def alive_shards(self) -> List[int]:
        with self._lock:
            return list(self._alive)

    def drain(self, shard: int) -> Dict[int, int]:
        """Mark ``shard`` dead and re-home its groups on the survivors,
        least-loaded first (round-robin under ``rr``). Returns {group:
        new shard} for the moved groups. Raises RuntimeError when no
        shard would remain."""
        with self._lock:
            if shard in self._alive:
                if len(self._alive) == 1:
                    raise RuntimeError("no alive shard left in the mesh")
                self._alive.remove(shard)
            moved = {}
            drained = sorted(g for g, s in self._assign.items() if s == shard)
            for i, g in enumerate(drained):
                if self._rr_only:
                    tgt = self._alive[i % len(self._alive)]
                else:
                    tgt = self._least_loaded_locked()
                self._assign[g] = tgt
                moved[g] = tgt
            self.rehomes += len(moved)
            return moved


def factor_mesh(n_devices: int, max_model: int = 2) -> Tuple[int, int]:
    """Split ``n_devices`` into (data, model) sizes, ``model`` capped at
    ``max_model`` (a 1024-wide FT gains nothing from more)."""
    model = 1
    for cand in range(min(max_model, n_devices), 0, -1):
        if n_devices % cand == 0:
            model = cand
            break
    return n_devices // model, model


@dataclass(frozen=True)
class Mesh:
    """A ``data x model`` grid of devices (the place of
    ``jax.sharding.Mesh``): ``grid[d][m]``."""

    grid: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.grid), len(self.grid[0])

    @property
    def size(self) -> int:
        data, model = self.shape
        return data * model

    @property
    def devices(self) -> List[torch.device]:
        """The devices in data-major order: the batch's shard order."""
        return [dev for row in self.grid for dev in row]


def make_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
              model: Optional[int] = None, device_type: str = "cuda") -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible
    device of ``device_type``), factored by ``factor_mesh`` unless
    given."""
    devs = (_visible(device_type) if devices is None
            else [resolve_device(d) for d in devices])
    n = len(devs)
    if data is None and model is None:
        data, model = factor_mesh(n)
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(tuple(tuple(devs[d * model:(d + 1) * model])
                      for d in range(data)))


def pad_to_multiple(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple)) * multiple


def _on(x, dev: torch.device) -> Optional[torch.Tensor]:
    """``x`` (numpy or torch) as a tensor on ``dev``; the uint16 wire
    travels as int16 (the evaluator widens it with a mask)."""
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint16:
            x = x.view(np.int16)
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev)


class ShardedEvaluator:
    """Batched NNUE evaluation split over a mesh: the legacy multi-device
    tier of an explicit ``--mesh DxM`` with ``M > 1``. The batch is cut
    into one equal slice per device (both axes: serving replicates the
    parameters), each slice evaluated on its device against its own
    replica, the results concatenated in shard order. Drop-in for the
    service's ``evaluator=`` seam; ``params`` passed to a call are
    ignored, as the JAX evaluator ignores them.

    Sound only because no delta entry references across a shard boundary:
    the native pool aligns block emission to the shard size
    (``fc_pool_step``'s ``align``; SearchService passes group capacity /
    ``size_multiple``), and ``_local_parents`` rebases the codes
    shard-locally — and raises on a cross-shard reference rather than
    read another shard's entry."""

    #: SearchService keeps the packed wire for this evaluator (its
    #: per-shard repack, then ``packed_eval``).
    supports_packed = True

    def __init__(self, params: Dict[str, torch.Tensor],
                 mesh: Optional[Mesh] = None,
                 batch_capacity: int = 1024) -> None:
        self.mesh = mesh if mesh is not None else make_mesh()
        self.devices = self.mesh.devices
        self.n_devices = len(self.devices)
        #: Batch sizes fed to a call must be multiples of this.
        self.size_multiple = self.n_devices
        self.batch_capacity = pad_to_multiple(batch_capacity, self.n_devices)
        first = self.devices[0]
        if params["ft_w"].device != first:
            params = {k: v.to(first) for k, v in params.items()}
        self.params = replicate_params(params, self.devices)

    def _local_parents(self, parent, batch: int) -> np.ndarray:
        """Batch-relative anchor codes rebased to shard-local indices;
        raises ValueError on a delta whose anchor lies in another shard
        (it would read another position's accumulator)."""
        shard = batch // self.n_devices
        parent = np.asarray(parent, np.int32)
        valid = parent >= 0
        ref = parent >> 1
        if valid.any():
            same_shard = (ref[valid] // shard) == (
                np.nonzero(valid)[0] // shard
            )
            if not same_shard.all():
                raise ValueError(
                    "delta entry references an anchor outside its mesh "
                    "shard — the pool must emit with align = shard size"
                )
        return np.where(valid, ((ref % shard) << 1) | (parent & 1),
                        -1).astype(np.int32)

    def _gather(self, outs: List[torch.Tensor]) -> np.ndarray:
        """Every shard's values on the host, in shard order (each shard's
        launches were all queued before the first read-back)."""
        return np.concatenate([o.cpu().numpy() for o in outs])

    def __call__(self, params, indices, buckets, parent=None, material=None):
        from fishnet_tpu_torch.nnue.torch_eval import evaluate_batch

        batch = indices.shape[0]
        if parent is None:
            parent = np.full((batch,), -1, np.int32)
        else:
            parent = self._local_parents(parent, batch)
        if isinstance(indices, torch.Tensor):
            indices = indices.cpu().numpy()
        indices = np.asarray(indices).astype(np.int32)
        shard = batch // self.n_devices
        outs = []
        for k, dev in enumerate(self.devices):
            sl = slice(k * shard, (k + 1) * shard)
            with on_device(dev):
                outs.append(evaluate_batch(
                    self.params[k], _on(indices[sl], dev),
                    _on(np.asarray(buckets)[sl], dev), _on(parent[sl], dev),
                    None if material is None
                    else _on(np.asarray(material)[sl], dev)))
        return self._gather(outs)

    def packed_eval(self, params, packed, offsets, buckets, parent,
                    material):
        """Evaluate an already per-shard-repacked row stream: ``packed``
        [n_devices * tier, 2, 8] (each shard's rows padded to one tier,
        its own trailing sentinel block), ``offsets`` [B] shard-local;
        each shard's ``evaluate_packed`` (the dense mode of the kernel,
        in-batch parents) runs on its device. ``params`` is ignored."""
        from fishnet_tpu_torch.nnue.torch_eval import evaluate_packed

        batch = offsets.shape[0]
        parent = self._local_parents(parent, batch)
        if material is None:
            material = np.zeros((batch,), np.int32)
        shard = batch // self.n_devices
        tier = packed.shape[0] // self.n_devices
        outs = []
        for k, dev in enumerate(self.devices):
            sl = slice(k * shard, (k + 1) * shard)
            with on_device(dev):
                outs.append(evaluate_packed(
                    self.params[k], _on(packed[k * tier:(k + 1) * tier], dev),
                    _on(np.asarray(offsets)[sl], dev),
                    _on(np.asarray(buckets)[sl], dev), _on(parent[sl], dev),
                    _on(np.asarray(material)[sl], dev)))
        return self._gather(outs)


class ShardedSegmentedEvaluator:
    """The fused coalescer wire (``evaluate_packed_anchored_segmented``)
    split over the mesh's data axis: each device evaluates its whole
    segments against its own tables. Segment-local codes make every
    shard self-contained: a device holding segments [k, k + K/n) never
    reads another device's rows or tables.

    Serving itself uses per-shard placement (independent per-device
    dispatches driven by SearchService's router), which lets shards
    degrade, drain and pipeline independently. This class is the
    topology's reference semantics, which the tests hold per-shard
    placement against."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 devices: Optional[Sequence] = None) -> None:
        if mesh is None:
            mesh = make_mesh(devices, model=1)
        self.mesh = mesh
        self.devices = mesh.devices
        self.n_devices = len(self.devices)

    def __call__(self, params, packed, buckets, parent, material,
                 anchor_tabs, seg_rows, psqt_tabs):
        """Same contract as ``evaluate_packed_anchored_segmented`` (the
        tables, stacked [K, A, ...], updated in place and returned); the
        segment count K must divide evenly over the mesh."""
        from fishnet_tpu_torch.nnue.torch_eval import (
            evaluate_packed_anchored_segmented,
        )

        k = anchor_tabs.shape[0]
        if k % self.n_devices:
            raise ValueError(
                f"segment count {k} does not divide over {self.n_devices} "
                "devices — pad the dispatch to a whole-segment multiple"
            )
        per = k // self.n_devices
        size = buckets.shape[0] // k
        tier = packed.shape[0] // k
        outs, writes = [], []
        for d, dev in enumerate(self.devices):
            segs = slice(d * per, (d + 1) * per)
            ents = slice(d * per * size, (d + 1) * per * size)
            local = {n: v.to(dev) for n, v in params.items()}
            tabs = anchor_tabs[segs].to(dev)
            ptabs = psqt_tabs[segs].to(dev)
            with on_device(dev):
                values, _, _ = evaluate_packed_anchored_segmented(
                    local, packed[d * per * tier:(d + 1) * per * tier].to(dev),
                    buckets[ents].to(dev), parent[ents].to(dev),
                    None if material is None else material[ents].to(dev),
                    tabs, seg_rows[segs].to(dev), ptabs)
            outs.append(values)
            writes.append((segs, tabs, ptabs))
        for segs, tabs, ptabs in writes:
            if tabs.data_ptr() != anchor_tabs[segs].data_ptr():
                anchor_tabs[segs].copy_(tabs)
                psqt_tabs[segs].copy_(ptabs)
        return (torch.cat([v.to(anchor_tabs.device) for v in outs]),
                anchor_tabs, psqt_tabs)
