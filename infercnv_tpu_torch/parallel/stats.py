"""The cell-axis mesh and the statistics summed over it.

Counterpart of infercnv_tpu/parallel/stats.py.  PyTorch has no
``jax.sharding.Mesh``, so the port keeps its own small one, ``CellMesh``:
an ordered list of this process's devices (its shards) and, for a run over
several processes, a ``torch.distributed`` process group that the caller
initialised (as the reference's caller calls ``jax.distributed.initialize``).
Shard ``i`` of rank ``r`` is global shard ``r * len(devices) + i``.  A device
may be listed more than once: two shards on one card (or eight on the CPU)
split the cells as eight virtual CPU devices do for the JAX package's tests.

A cell-sharded array is a ``CellSharded``: this process's shards, one tensor
on each shard's device, each holding an equal run of the global rows.

* ``put_cell_sharded`` splits a [C, ...] array every process holds into the
  mesh's shards (the reference's ``put_cell_sharded``, :134-149);
* ``to_host`` brings a result to the host: a sharded one concatenated and
  all-gathered across the processes, a replicated one read (:152-167);
* ``sharded_group_gene_stats``: per-group per-gene mean and sd (ddof=1) from
  one-hot products on each shard, summed over the shards in shard order and
  then over the processes (:35-60).  The products and sums are float64 and
  the results float32: the reference sums in float32, whose rounding over
  thousands of cells (and the variance's cancellation) is what the float64
  sums leave out;
* ``sharded_median`` / ``sharded_quantile``: exact order statistics by a
  radix select over the float32 values' order keys in three digit passes of
  11, 11 and 10 bits (the digits of the port's median kernels,
  csrc/radix_select.cuh), each pass's histogram summed over the shards and
  the processes; the values never leave their shards.  The reference takes
  32 one-bit rounds; both find the same key, so the same value (:63-131).

The shards' partial sums meet on the mesh's first device, where an NCCL
collective takes them (NCCL takes CUDA tensors only); under any other
backend they meet on the host (gloo takes host tensors for every
collective).  The backend is the caller's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from infercnv_tpu_torch.ops.median import from_key, to_key

#: the radix select's digits, high to low: (shift, bits)
_DIGITS = ((21, 11), (10, 11), (0, 10))


class CellMesh:
    """A 1-D cell-axis mesh: this process's shard devices, in order, and an
    optional process group spanning the processes of one run."""

    def __init__(self, devices: Sequence[Union[str, torch.device]],
                 group=None):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a CellMesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a CellMesh's devices must be of one type, got {devs}")
        self.devices: Tuple[torch.device, ...] = tuple(devs)
        self.group = group

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group) if self.group is not None else 1

    @property
    def n_shards(self) -> int:
        """Shards of the whole mesh, over every process."""
        return self.world * len(self.devices)

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.rank * len(self.devices)

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))

    def collective_device(self) -> torch.device:
        """Where the shards' partial sums meet: the first device for one
        process or under NCCL, the host under every other backend."""
        if self.group is None or dist.get_backend(self.group) == "nccl":
            return self.devices[0]
        return torch.device("cpu")

    def __repr__(self) -> str:
        return f"CellMesh({[str(d) for d in self.devices]}, world={self.world})"


@dataclasses.dataclass
class CellSharded:
    """This process's shards of a cell-sharded [C, ...] array: shard i on
    mesh.devices[i], each of C / mesh.n_shards rows."""

    shards: List[torch.Tensor]
    mesh: CellMesh

    @property
    def shape(self) -> Tuple[int, ...]:
        """The global array's shape."""
        first = self.shards[0].shape
        return (first[0] * self.mesh.n_shards,) + tuple(first[1:])

    def map(self, fn) -> "CellSharded":
        return CellSharded([fn(s) for s in self.shards], self.mesh)


def _tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def put_cell_sharded(x, mesh: CellMesh) -> CellSharded:
    """Split a [C, ...] array (numpy or a tensor, the whole of it in every
    process) into this process's shards of the mesh, each on its device.
    C must divide by the mesh's shard count (run() pads its chunks)."""
    if isinstance(x, CellSharded):
        return x
    t = _tensor(x)
    n = mesh.n_shards
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not split into {n} equal shards")
    rows = t.shape[0] // n
    first = mesh.first_shard
    return CellSharded([t[(first + i) * rows:(first + i + 1) * rows].to(d)
                        for i, d in enumerate(mesh.devices)], mesh)


def _all_gather_rows(local: torch.Tensor, mesh: CellMesh) -> torch.Tensor:
    dev = mesh.collective_device()
    t = local.to(dev).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts)


def to_host(r) -> np.ndarray:
    """A result on the host: a CellSharded concatenated in shard order and
    all-gathered over the mesh's processes (every process gets the whole
    array); a tensor (replicated) or an array read as it is."""
    if isinstance(r, CellSharded):
        local = torch.cat([s.cpu() for s in r.shards])
        if r.mesh.group is not None:
            local = _all_gather_rows(local, r.mesh)
        return local.cpu().numpy()
    if torch.is_tensor(r):
        return r.detach().cpu().numpy()
    return np.asarray(r)


def sum_over_mesh(parts: Sequence[torch.Tensor], mesh: CellMesh) -> torch.Tensor:
    """The sum of per-shard tensors, in shard order on the mesh's
    collective device, then over the processes."""
    dev = mesh.collective_device()
    total = parts[0].to(dev).clone()
    for p in parts[1:]:
        total += p.to(dev)
    if mesh.group is not None:
        dist.all_reduce(total, group=mesh.group)
    return total


def sharded_group_gene_stats(x, onehot, mesh: CellMesh
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group per-gene (means [K, G], sds [K, G], ddof=1) of a
    cell-sharded x [C, G], from one-hot membership [K, C] sharded on its
    cell axis: a CellSharded of onehot.T ([C, K]) or the whole [K, C]
    array.  Summed in float64, returned as float32 on the mesh's first
    device in every process."""
    xs = put_cell_sharded(x, mesh)
    ohs = onehot if isinstance(onehot, CellSharded) else \
        put_cell_sharded(_tensor(onehot).t(), mesh)
    counts, sums, sqs = [], [], []
    for xi, oi in zip(xs.shards, ohs.shards):
        xi = xi.to(torch.float64)
        oi = oi.to(device=xi.device, dtype=torch.float64).t()      # [K, c]
        counts.append(oi.sum(dim=1))
        sums.append(oi @ xi)
        sqs.append(oi @ (xi * xi))
    dev0 = mesh.devices[0]
    n = sum_over_mesh(counts, mesh).to(dev0)[:, None]
    s = sum_over_mesh(sums, mesh).to(dev0)
    q = sum_over_mesh(sqs, mesh).to(dev0)
    mean = s / n
    var = (q - n * mean * mean) / torch.clamp(n - 1, min=1)
    return (mean.to(torch.float32),
            torch.sqrt(torch.clamp(var, min=0.0)).to(torch.float32))


def _shard_keys(values, mesh: CellMesh) -> List[torch.Tensor]:
    vs = put_cell_sharded(values, mesh)
    return [to_key(s.reshape(-1).to(torch.float32)) for s in vs.shards]


def _select_keys(keys: List[torch.Tensor], ranks: Sequence[int],
                 mesh: CellMesh) -> List[int]:
    """The keys of the given 0-based ranks among all shards' keys: one
    histogram pass a digit, high to low, counting inside the prefix each
    rank has so far."""
    prefix = [0] * len(ranks)
    within = list(ranks)
    done_bits = 0
    for shift, bits in _DIGITS:
        hists = []
        for k in keys:
            rows = []
            for p in prefix:
                sel = k[(k >> (shift + bits)) == p] if done_bits else k
                rows.append(torch.bincount((sel >> shift) & ((1 << bits) - 1),
                                           minlength=1 << bits))
            hists.append(torch.stack(rows))
        hist = sum_over_mesh(hists, mesh).cpu().numpy()           # [ranks, 2^bits]
        for j in range(len(ranks)):
            cum = np.cumsum(hist[j])
            digit = int(np.searchsorted(cum, within[j], side="right"))
            within[j] -= int(cum[digit] - hist[j][digit])
            prefix[j] = (prefix[j] << bits) | digit
        done_bits += bits
    return prefix


def _count(keys: List[torch.Tensor], mesh: CellMesh) -> int:
    n = [torch.tensor([k.numel()], dtype=torch.int64) for k in keys]
    return int(sum_over_mesh(n, mesh).item())


def _value(key: int, device) -> torch.Tensor:
    return from_key(torch.tensor([key], dtype=torch.int64))[0].to(device)


def sharded_median(values, mesh: CellMesh) -> torch.Tensor:
    """Exact median of a cell-sharded vector (for example the per-cell
    library sizes of the depth factor), as a float32 scalar on the mesh's
    first device: the middle value, or the mean of the two middle values,
    (lo + hi) * 0.5 in float32, as numpy computes it."""
    keys = _shard_keys(values, mesh)
    n = _count(keys, mesh)
    k2 = n // 2
    dev0 = mesh.devices[0]
    if n % 2:
        return _value(_select_keys(keys, [k2], mesh)[0], dev0)
    lo, hi = _select_keys(keys, [k2 - 1, k2], mesh)
    return (_value(lo, dev0) + _value(hi, dev0)) * 0.5


def sharded_quantile(values, q: float, mesh: CellMesh) -> torch.Tensor:
    """Exact type-7 quantile (R's default) of a cell-sharded vector, as a
    float32 scalar on the mesh's first device.  The order statistics and
    the interpolation fraction come from float64 host arithmetic, as the
    reference's (:101-131); the interpolation is float32."""
    keys = _shard_keys(values, mesh)
    n = _count(keys, mesh)
    h = (n - 1) * float(q)
    lo_idx = int(np.floor(h))
    frac = float(h - lo_idx)
    hi_idx = min(lo_idx + 1, n - 1)
    lo_key, hi_key = _select_keys(keys, [lo_idx, hi_idx], mesh)
    dev0 = mesh.devices[0]
    lo, hi = _value(lo_key, dev0), _value(hi_key, dev0)
    return lo + torch.tensor(np.float32(frac), device=dev0) * (hi - lo)
