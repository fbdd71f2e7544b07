"""Parameter placement for the sharded trainers over the port's ``Mesh``.

The JAX trainers shard by annotation (GSPMD): a ``PartitionSpec`` per
parameter and per batch key, and XLA inserts the collectives. Here the
work is split by hand over a ``data x model`` grid of devices in one
process (``parallel.mesh.Mesh``, ``grid[d][m]``):

* a :class:`ShardSpec` is the port's placement spec, a small frozen
  value per tensor naming the mesh axis that splits it (``None``,
  ``"data"`` or ``"model"``) and the dimension it splits — data, like
  the JAX package's ``PartitionSpec`` dicts;
* :class:`ShardedParams` holds each parameter ONCE, on grid row 0: a
  model-split parameter as one contiguous leaf per model shard
  (``grid[0][m]``), a replicated one as one leaf on ``grid[0][0]``. A
  data row ``d > 0`` computes on its own copy of the leaves
  (:meth:`ShardedParams.replica`), and :meth:`ShardedParams.reduce_grads`
  sums the rows' gradients onto the leaves in row order (row 0's
  backward writes the leaf's ``.grad`` itself), so two runs give the
  same bits. One optimizer steps over the leaves; its state lives
  beside each leaf;
* :func:`split_batch` cuts a batch into the data rows' slices in order
  (the JAX ``P("data")`` block layout).

A model-split dimension is cut into ``model`` equal contiguous blocks,
except where its spec is ``paired``: the NNUE FT output multiplies
column ``j`` by column ``j + L1/2``, so model shard ``m`` holds a block
``J_m`` of the pair indices ``[0, L1/2)`` and, for it, the columns
``J_m`` and ``L1/2 + J_m`` side by side in one contiguous leaf. Every
pair then lives on one device (see ``train/trainer.py``).

The gathered layout (:meth:`ShardedParams.gather`, ``full_module``) is
the single-device module's, byte for byte: checkpoints and exports go
through it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from fishnet_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

__all__ = ["REPLICATED", "ShardSpec", "ShardedParams", "check_model_split",
           "split_batch"]


@dataclass(frozen=True)
class ShardSpec:
    """Where a tensor lives on the mesh: ``axis`` (``None`` =
    replicated, ``"data"`` or ``"model"``) splits dimension ``dim``;
    ``paired`` cuts that dimension as NNUE L1 pairs (``j`` and
    ``j + n/2`` in one block)."""

    axis: Optional[str] = None
    dim: int = 0
    paired: bool = False

    def partition(self, ndim: int) -> Tuple[Optional[str], ...]:
        """The spec as a ``PartitionSpec``'s entries over ``ndim``
        dimensions (the axis at ``dim``, ``None`` elsewhere; empty when
        replicated)."""
        if self.axis is None:
            return ()
        return tuple(self.axis if i == self.dim else None
                     for i in range(self.dim + 1))


REPLICATED = ShardSpec()


def _block_index(n: int, shards: int, m: int, paired: bool) -> torch.Tensor:
    """The indices of a dimension of length ``n`` that model shard ``m``
    of ``shards`` holds, in its leaf's order."""
    if paired:
        half = n // 2
        size = half // shards
        lo = m * size
        return torch.cat([torch.arange(lo, lo + size),
                          torch.arange(half + lo, half + lo + size)])
    size = n // shards
    return torch.arange(m * size, (m + 1) * size)


def check_model_split(name: str, shape: Sequence[int], spec: ShardSpec,
                      shards: int) -> None:
    """Refuse a model axis that does not divide ``name``'s split
    dimension (its pair count when ``paired``): the JAX package pads
    nothing there either."""
    if spec.axis != MODEL_AXIS or shards == 1:
        return
    n = shape[spec.dim]
    units = n // 2 if spec.paired else n
    what = f"{n // 2} L1 pairs" if spec.paired else f"dimension {spec.dim} ({n})"
    if (spec.paired and n % 2) or units % shards:
        raise ValueError(f"{name}: {what} cannot be split over a model axis "
                         f"of {shards}; choose a mesh whose model size "
                         "divides it")


def split_batch(batch: Mapping[str, object], mesh: Mesh
                ) -> List[Dict[str, torch.Tensor]]:
    """The data rows' slices of ``batch`` (arrays or tensors, split on
    their first dimension in order), each on its row's first device.
    Refuses a batch the data axis does not divide."""
    data = mesh.shape[0]
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    rows = next(iter(tensors.values())).shape[0]
    if rows % data:
        raise ValueError(f"batch of {rows} rows cannot be split over a data "
                         f"axis of {data}; use a multiple of {data}")
    size = rows // data
    return [{k: v[d * size:(d + 1) * size].to(mesh.grid[d][0])
             for k, v in tensors.items()} for d in range(data)]


class ShardedParams(nn.Module):
    """A net's parameters placed on grid row 0 of ``mesh`` by ``specs``
    (a ShardSpec per name; missing names are replicated).
    ``make_module()`` builds the single-device module, whose names,
    shapes, order and layout :meth:`gather` and :meth:`scatter`
    translate to and from. Indexing by name gives the
    gathered tensor (detached, on the CPU), so ``quantize`` and
    ``params_to_jax`` read this net as they read the single one."""

    def __init__(self, make_module: Callable[[], nn.Module],
                 specs: Mapping[str, ShardSpec], mesh: Mesh) -> None:
        super().__init__()
        self.mesh = mesh
        self._make_module = make_module
        template = make_module()
        self.cfg = getattr(template, "cfg", None)
        model = mesh.shape[1]
        self.names: List[str] = []
        self.specs: Dict[str, ShardSpec] = {}
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self._index: Dict[str, List[Optional[torch.Tensor]]] = {}
        self._leaves: Dict[str, List[nn.Parameter]] = {}
        for name, p in template.named_parameters():
            spec = specs.get(name, REPLICATED)
            if spec.axis == DATA_AXIS:
                raise ValueError(f"{name}: parameters split over model or "
                                 "nothing, never over data")
            check_model_split(name, p.shape, spec, model)
            split = spec.axis == MODEL_AXIS and model > 1
            self.names.append(name)
            self.specs[name] = spec
            self.shapes[name] = tuple(p.shape)
            if split:
                idx = [_block_index(p.shape[spec.dim], model, m, spec.paired)
                       for m in range(model)]
                devs = list(mesh.grid[0])
            else:
                idx, devs = [None], [mesh.grid[0][0]]
            leaves = []
            for m, (ix, dev) in enumerate(zip(idx, devs)):
                part = p.detach() if ix is None else p.detach().index_select(spec.dim, ix)
                leaf = nn.Parameter(part.contiguous().to(dev))
                self.register_parameter(f"{name}__m{m}", leaf)
                leaves.append(leaf)
            self._index[name] = idx
            self._leaves[name] = leaves

    # -- layout -----------------------------------------------------------

    def leaves(self, name: str) -> List[nn.Parameter]:
        """``name``'s leaves: one per model shard, or one when
        replicated."""
        return self._leaves[name]

    def split(self, name: str) -> bool:
        return self._index[name][0] is not None

    def gather(self, name: str, parts: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
        """``name`` (or ``parts``, tensors shaped like its leaves) in the
        single-device layout, on the CPU."""
        parts = self._leaves[name] if parts is None else parts
        idx = self._index[name]
        if idx[0] is None:
            return parts[0].detach().cpu().clone()
        dim = self.specs[name].dim
        first = parts[0]
        full = torch.empty(self.shapes[name], dtype=first.dtype)
        for ix, part in zip(idx, parts):
            full.index_copy_(dim, ix, part.detach().cpu())
        return full

    def scatter(self, name: str, full: torch.Tensor) -> List[torch.Tensor]:
        """A single-device-layout tensor cut into ``name``'s leaves'
        shapes (CPU tensors)."""
        full = torch.as_tensor(full)
        if tuple(full.shape) != self.shapes[name]:
            raise ValueError(f"{name}: shape {tuple(full.shape)}, want "
                             f"{self.shapes[name]}")
        idx = self._index[name]
        if idx[0] is None:
            return [full]
        dim = self.specs[name].dim
        return [full.index_select(dim, ix).contiguous() for ix in idx]

    def load_full(self, name: str, full: torch.Tensor) -> None:
        """Overwrite ``name``'s leaves from a single-device-layout tensor."""
        with torch.no_grad():
            for leaf, part in zip(self._leaves[name], self.scatter(name, full)):
                leaf.copy_(part)

    def full_module(self) -> nn.Module:
        """A single-device module (on the CPU) holding the gathered
        parameters."""
        module = self._make_module()
        with torch.no_grad():
            for name, p in module.named_parameters():
                p.copy_(self.gather(name))
        return module

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.gather(name)

    # -- the data rows ----------------------------------------------------

    def replica(self, d: int) -> Dict[str, List[torch.Tensor]]:
        """Data row ``d``'s view of every parameter: the leaves
        themselves on row 0; on another row, a fresh copy of each leaf on
        ``grid[d][m]`` (sharing the leaf's storage where the device is
        the same) that collects that row's gradient."""
        out: Dict[str, List[torch.Tensor]] = {}
        row = self.mesh.grid[d]
        for name, leaves in self._leaves.items():
            if d == 0:
                out[name] = list(leaves)
                continue
            copies = []
            for m, leaf in enumerate(leaves):
                c = leaf.detach().to(row[m]) if leaf.device != row[m] else leaf.detach()
                copies.append(c.requires_grad_(True))
            out[name] = copies
        return out

    def reduce_grads(self, replicas: Sequence[Dict[str, List[torch.Tensor]]]) -> None:
        """Sum the rows' gradients onto the leaves, rows ``1..D-1`` in
        order after row 0's (which backward wrote into ``.grad``)."""
        with torch.no_grad():
            for rep in replicas[1:]:
                for name, leaves in self._leaves.items():
                    for leaf, copy in zip(leaves, rep[name]):
                        if copy.grad is None:
                            continue
                        g = copy.grad.to(leaf.device)
                        if leaf.grad is None:
                            leaf.grad = g.clone()
                        else:
                            leaf.grad.add_(g)

    # -- optimizer state in the gathered layout ---------------------------

    def layout(self) -> List[Tuple[str, List[nn.Parameter]]]:
        """``(name, leaves)`` in the single-device module's order: the
        checkpoint's view of the net."""
        return [(name, self._leaves[name]) for name in self.names]


def module_layout(net: nn.Module) -> List[Tuple[str, List[nn.Parameter]]]:
    """``(name, [parameter])`` of a single-device module, or a sharded
    net's layout."""
    if isinstance(net, ShardedParams):
        return net.layout()
    return [(name, [p]) for name, p in net.named_parameters()]


def gather_state(net: nn.Module, name: str, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Leaf-shaped tensors of ``name`` in the gathered layout (CPU)."""
    if isinstance(net, ShardedParams):
        return net.gather(name, parts)
    return parts[0].detach().cpu().clone()


def scatter_state(net: nn.Module, name: str, full: torch.Tensor) -> List[torch.Tensor]:
    """A gathered-layout tensor cut to ``name``'s leaves (CPU)."""
    if isinstance(net, ShardedParams):
        return net.scatter(name, full)
    return [torch.as_tensor(full)]


def mesh_devices(mesh: Mesh) -> List[torch.device]:
    """The mesh's distinct devices, in grid order."""
    seen: List[torch.device] = []
    for dev in mesh.devices:
        if dev not in seen:
            seen.append(dev)
    return seen
