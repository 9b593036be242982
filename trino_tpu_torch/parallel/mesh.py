"""Device mesh runtime, single-controller.

The reference lays a plan over a `jax.sharding.Mesh`: one process drives
every device, a stage is a `shard_map` program (per-shard code with
explicit collectives), and the rest runs under GSPMD. Torch has neither,
so the port keeps the single controller and writes both as loops over a
list of per-shard batches, one per mesh device, with the collectives
below as functions over that list (the semantics of `jax.lax`'s, shard 0
first). A `ShardedBatch` is such a list as data: the scans of a
MeshExecutor are split once into one block a shard (`split_rows`), each
on its shard's card, and per-shard operators keep them there until an
operator that needs every row takes them through `gather_rows`, the
all-gather onto the first device. Data moves between shards with
`Tensor.to(device)`, which orders the copy after the work queued on both
cards' current streams; no process group is involved. A mesh may name
one device several times: `make_mesh(8, "cuda")` lays eight shards on
one card, as the reference's tests lay eight virtual devices on one CPU.

Axis naming: a single "workers" axis for row-sharded execution;
`make_mesh_2d` reshapes the device list, and rows shard over every axis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..batch import Batch, Column
from ..exec.memory import batch_bytes

AXIS = "workers"


class Mesh:
    """An ordered list of devices (repeats allowed) and its axis names."""

    def __init__(self, devices: Sequence, axis_names=(AXIS,),
                 shape: Optional[tuple] = None):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape is not None else \
            (len(self.devices),)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def _default_devices(device) -> List[torch.device]:
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    devs = [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]
    if not devs:
        raise RuntimeError("make_mesh: CUDA is not available; pass "
                           "device='cpu' for a mesh on the CPU")
    return devs


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              axis: str = AXIS) -> Mesh:
    """A one-axis mesh. By default every card of `device`'s type (one
    shard on the CPU); `n_devices` shards cycle over those devices, so
    `make_mesh(8, "cpu")` is eight shards on the CPU."""
    devs = _default_devices(device)
    n = n_devices if n_devices is not None else len(devs)
    if n < 1:
        raise ValueError(f"a mesh needs a device, asked for {n}")
    return Mesh([devs[i % len(devs)] for i in range(n)], (axis,))


def make_mesh_2d(n_hosts: int, chips_per_host: int, device="cuda",
                 axes=("hosts", "chips")) -> Mesh:
    """Two-axis mesh (hosts x chips): the same device list reshaped; rows
    shard over both axes, host-major."""
    flat = make_mesh(n_hosts * chips_per_host, device)
    return Mesh(flat.devices, axes, (n_hosts, chips_per_host))


def pad_to_multiple(batch: Batch, multiple: int) -> Batch:
    """Grow a batch's capacity to the next multiple of `multiple` with dead
    rows (live and valid False, data zero) so row-sharding divides
    evenly; the live mask keeps the padding invisible."""
    pad = (-batch.capacity) % multiple
    if pad == 0:
        return batch

    def grow(t):
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    return Batch(columns=tuple(Column(grow(c.data), grow(c.valid))
                               for c in batch.columns),
                 live=grow(batch.live))


def slice_rows(batch: Batch, start: int, stop: int, device=None) -> Batch:
    """Rows [start, stop) of a batch, on `device` (default: where it is)."""
    def cut(t):
        t = t[start:stop]
        return t if device is None else t.to(device)
    return Batch(columns=tuple(Column(cut(c.data), cut(c.valid))
                               for c in batch.columns),
                 live=cut(batch.live))


def shard_rows(batch: Batch, mesh: Mesh) -> List[Batch]:
    """Contiguous row blocks of capacity / n, block i on shard i's device:
    the layout of `P('workers')`. The capacity must divide evenly."""
    n = mesh.size
    if batch.capacity % n:
        raise ValueError(f"capacity {batch.capacity} does not divide over "
                         f"{n} shards")
    per = batch.capacity // n
    return [slice_rows(batch, i * per, (i + 1) * per, d)
            for i, d in enumerate(mesh.devices)]


def replicate(batch: Batch, mesh: Mesh) -> List[Batch]:
    """The whole batch on every shard (a broadcast build side)."""
    return [slice_rows(batch, 0, batch.capacity, d) for d in mesh.devices]


def split_rows(batch: Batch, mesh: Mesh) -> "ShardedBatch":
    """`shard_rows` as the data a scan keeps: each block a copy of its own
    on its shard's card (a view of the global tensor would keep the whole
    table alive on the first card)."""
    n = mesh.size
    if batch.capacity % n:
        raise ValueError(f"capacity {batch.capacity} does not divide over "
                         f"{n} shards")
    per = batch.capacity // n

    def cut(t, i, d):
        return t[i * per:(i + 1) * per].to(d, copy=n > 1)
    shards = [Batch(columns=tuple(Column(cut(c.data, i, d),
                                         cut(c.valid, i, d))
                                  for c in batch.columns),
                    live=cut(batch.live, i, d))
              for i, d in enumerate(mesh.devices)]
    return ShardedBatch(shards, sum_by_shard=True)


class ShardedBatch:
    """A batch row-sharded over a mesh: `shards[i]` holds its rows on
    mesh device i, every shard with the same columns and capacity, the
    rows in shard order. `capacity` is the global batch's, the one every
    capacity rule of the executor reads.

    `sum_by_shard`: the reference holds these rows row-sharded as they
    lie here (`P('workers')`: a scan's even blocks, kept by filters,
    projections and the dense probe; a partitioned join's output before
    its compaction), so GSPMD sums a float over them shard by shard. A
    compacted batch it sums as one array.

    `slots`: set when the shards were compacted each on its own card where
    the single-device operator compacts the global batch. Slot rows are
    the rows the global compaction keeps (the live rows then; a later
    filter does not move them), so `gather_rows` compacts the
    concatenation by them to `capacity` and gives the global operator's
    layout, dead rows at their places."""

    def __init__(self, shards: Sequence[Batch], sum_by_shard: bool = False,
                 slots: Optional[List[torch.Tensor]] = None,
                 capacity: Optional[int] = None):
        self.shards = list(shards)
        self.sum_by_shard = sum_by_shard
        self.slots = slots
        self.capacity = capacity if capacity is not None else \
            sum(s.capacity for s in self.shards)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    @property
    def first(self) -> Batch:
        """Shard 0: its columns' dtypes are every shard's."""
        return self.shards[0]

    def map(self, fn) -> "ShardedBatch":
        """`fn` on every shard, for an operator that keeps each row where
        it is (a filter, a projection): the layout is kept."""
        return ShardedBatch([fn(s) for s in self.shards], self.sum_by_shard,
                            self.slots, self.capacity)

    def bytes_by_device(self) -> dict:
        """Bytes the shards hold, per device (data, validity and live)."""
        out: dict = {}
        for s in self.shards:
            out[str(s.device)] = out.get(str(s.device), 0) + batch_bytes(s)
        return out


def gather_rows(batch: "ShardedBatch", device=None) -> Batch:
    """The all-gather: the shards concatenated in shard order on `device`
    (default: shard 0's), compacted by their slots where the shards were
    compacted each on its own card."""
    out = concat_rows(batch.shards, device)
    if batch.slots is None:
        return out
    dev = out.device
    slots = torch.cat([s.to(dev) for s in batch.slots])
    idx = torch.sort((~slots).to(torch.uint8),
                     stable=True).indices[:batch.capacity]
    out = Batch(tuple(Column(c.data[idx], c.valid[idx])
                      for c in out.columns), out.live[idx])
    # the shards' common capacity may sum to less than the global one
    return pad_to_multiple(out, batch.capacity)


def concat_rows(shards: Sequence[Batch], device=None) -> Batch:
    """Row-sharded outputs concatenated in shard order (out_specs
    `P('workers')`), on `device` (default: shard 0's)."""
    device = device if device is not None else shards[0].device
    ncols = len(shards[0].columns)

    def cat(ts):
        return torch.cat([t.to(device) for t in ts])
    return Batch(columns=tuple(
        Column(cat([s.columns[j].data for s in shards]),
               cat([s.columns[j].valid for s in shards]))
        for j in range(ncols)), live=cat([s.live for s in shards]))


# --------------------------------------------------------------------------
# collectives over a list of per-shard tensors (jax.lax semantics)
# --------------------------------------------------------------------------

def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`lax.psum`: every shard gets the sum, added shard 0 first, left to
    right (the order XLA's CPU all-reduce adds doubles in)."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x.to(acc.device)
    return [acc.to(x.device) for x in xs]


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`lax.all_gather`: every shard gets the shards stacked in order."""
    dev = xs[0].device
    stacked = torch.stack([x.to(dev) for x in xs])
    return [stacked.to(x.device) for x in xs]


def all_to_all(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)` over
    [n, ...] buckets: shard i receives shard j's bucket i, stacked in j
    order."""
    return [torch.stack([x[i].to(xs[i].device) for x in xs])
            for i in range(len(xs))]
