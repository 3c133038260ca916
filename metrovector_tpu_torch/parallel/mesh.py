"""Device meshes, row sharding and the candidate exchange: the counterpart
of :mod:`metrovector_tpu.parallel.mesh`.

A :class:`Mesh` names the devices that hold the shards of a corpus, in
shard order along its ``"shard"`` axis (or a ``(query, shard)`` grid),
and optionally a ``torch.distributed`` process group. Sharded data is a
list of per-shard tensors, one per mesh position of this process, each on
its position's device: shard ``s`` owns the global rows ``[s·per,
(s+1)·per)`` with ``per`` = :func:`rows_per_shard`. Under a process group
of W ranks with L positions each, rank r owns the shards ``[r·L,
(r+1)·L)``, so rank-major order is shard-major order.

The exchange (:func:`exchange_topk`): each shard's ``[Q, k]`` candidate
list carries global row ids; the lists are brought to the lead device
(``.to()`` in one process, ``all_gather`` under a group), concatenated
shard-major and cut by one stable descending sort (:func:`merge_topk`).
That is ``lax.top_k`` over the shard-major concatenation: equal scores go
to the lowest global row. ``torch.topk`` on CUDA keeps no order among
ties, so it is never used for the merge.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

SHARD_AXIS = "shard"
QUERY_AXIS = "query"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices along named axes. ``devices``: a tuple of ``torch.device``
    for a 1-D mesh, or a tuple of ``n_query`` rows of ``n_shard`` devices
    for a 2-D one. ``axis_names``: one name per axis. ``group``: a
    ``torch.distributed`` process group whose ranks each hold such a 1-D
    mesh (the shard axis spans ``group size × len(devices)`` shards), or
    None for one process. A device may repeat: several shards on one card
    (or on the CPU) is an explicit layout."""

    devices: tuple
    axis_names: tuple[str, ...]
    group: object = None

    @property
    def world(self) -> int:
        """Processes the shard axis spans."""
        if self.group is None:
            return 1
        return torch.distributed.get_world_size(self.group)

    @property
    def rank(self) -> int:
        """This process's rank in :attr:`group` (0 in one process)."""
        if self.group is None:
            return 0
        return torch.distributed.get_rank(self.group)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → its global size, as ``jax.sharding.Mesh.shape``."""
        if len(self.axis_names) == 1:
            return {self.axis_names[0]: len(self.devices) * self.world}
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    def size(self, axis: str) -> int:
        """The global size of ``axis``; raises ``ValueError`` for a name
        the mesh does not have."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, not {axis!r}")
        return self.shape[axis]

    def first_shard(self) -> int:
        """The global index of this process's first shard (1-D mesh)."""
        return self.rank * len(self.devices)

    def flat(self) -> list[torch.device]:
        """This process's positions in row-major order."""
        if len(self.axis_names) == 1:
            return list(self.devices)
        return [d for row in self.devices for d in row]

    @property
    def lead(self) -> torch.device:
        """The device results come back to: the first position's."""
        return self.flat()[0]

    def distinct(self) -> list[torch.device]:
        """The distinct devices of this process, in first-use order."""
        return list(dict.fromkeys(self.flat()))

    def cards(self) -> int:
        """How many distinct CUDA cards this process's positions span."""
        return sum(d.type == "cuda" for d in self.distinct())


def _devices(n: int | None, devices) -> list[torch.device]:
    """``devices`` as ``torch.device``s (the first ``n`` when given), or
    the first ``n`` (default: every) visible CUDA card. Raises when there
    is no card or fewer than asked for; a CUDA device in ``devices``
    that is not there raises too."""
    from ..engine import resolve_device

    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if n is not None:
            if n > len(devs):
                raise ValueError(f"requested {n} devices, only {len(devs)} given")
            devs = devs[:n]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return devs
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh found no CUDA card (torch.cuda.is_available() is False); "
            "pass devices= for an explicit layout such as ['cpu'] * 4")
    count = torch.cuda.device_count()
    n = count if n is None else int(n)
    if n > count:
        raise ValueError(f"requested {n} devices, only {count} available")
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS,
              devices=None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` visible CUDA cards (default
    every one), or over ``devices`` given explicitly (for example
    ``["cuda:0"] * 4``: four shards on one card, or ``["cpu"] * S``)."""
    return Mesh(tuple(_devices(n_devices, devices)), (axis,))


def make_mesh_2d(n_query: int, n_shard: int, query_axis: str = QUERY_AXIS,
                 shard_axis: str = SHARD_AXIS, devices=None) -> Mesh:
    """A ``(query, shard)`` mesh of ``n_query · n_shard`` devices (the
    first visible cards, or ``devices``), row-major: corpus rows shard
    along the shard axis and each row group repeats along the query axis;
    query batches split along the query axis."""
    need = n_query * n_shard
    if devices is not None and len(devices) < need:
        raise ValueError(f"requested {need} devices, only {len(devices)} given")
    devs = _devices(need, devices)
    grid = tuple(tuple(devs[r * n_shard:(r + 1) * n_shard]) for r in range(n_query))
    return Mesh(grid, (query_axis, shard_axis))


def rows_per_shard(padded_rows: int, n_shards: int, sublane: int) -> int:
    """Rows each shard owns: ``padded_rows`` split evenly, rounded up to
    the dtype's row multiple."""
    per = -(-padded_rows // n_shards)
    return -(-per // sublane) * sublane


def _to_tensor(arr) -> torch.Tensor:
    """``arr`` as a tensor, sharing its memory (a mapped file's arrays are
    read-only, and are only read)."""
    if isinstance(arr, torch.Tensor):
        return arr
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not writable")
        return torch.from_numpy(np.ascontiguousarray(arr))


def _shard_axis_devices(mesh: Mesh, axis: str) -> list[list[torch.device]]:
    """For each shard position of this process, the devices that hold it
    (one on a 1-D mesh; one per query row on a 2-D mesh)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}, not {axis!r}")
    if len(mesh.axis_names) == 1:
        return [[d] for d in mesh.devices]
    if mesh.axis_names.index(axis) == 1:
        return [list(col) for col in zip(*mesh.devices)]
    return [list(row) for row in mesh.devices]


def shard_rows(arr, mesh: Mesh, axis: str = SHARD_AXIS, sublane: int = 8,
               pad_value=0):
    """Pad the rows of ``arr`` (numpy or a tensor) to ``S ×
    rows_per_shard(rows, S, sublane)`` and place shard ``s`` on its
    device: a list of this process's shards (under a process group only
    its own rows are read). On a 2-D mesh the result is indexed
    ``[query row][shard]``, each shard repeated along the query axis (one
    copy per distinct device). Padding rows hold ``pad_value``; searches
    leave them out by their row count, not their values."""
    src = _to_tensor(arr)
    per = rows_per_shard(int(src.shape[0]), mesh.size(axis), sublane)
    return split_rows(src, mesh, axis, per, pad_value)


def split_rows(arr, mesh: Mesh, axis: str, per: int, pad_value=0):
    """:func:`shard_rows` with ``per`` rows a shard given; a list (or, on
    a 2-D mesh, a list of lists) of shards is returned as it is."""
    if isinstance(arr, (list, tuple)):
        return list(arr)
    src = _to_tensor(arr)
    first = mesh.first_shard() if len(mesh.axis_names) == 1 else 0
    holders = _shard_axis_devices(mesh, axis)
    placed = []
    for j, devs in enumerate(holders):
        lo = (first + j) * per
        piece = src[lo:lo + per]
        if piece.shape[0] < per:
            pad = torch.full((per - piece.shape[0],) + tuple(src.shape[1:]), pad_value,
                             dtype=src.dtype, device=src.device)
            piece = torch.cat([piece, pad])
        placed.append({d: piece.to(d).contiguous() for d in dict.fromkeys(devs)})
    if len(mesh.axis_names) == 1:
        return [copies[devs[0]] for copies, devs in zip(placed, holders)]
    s_ax = mesh.axis_names.index(axis)
    return [[placed[c if s_ax == 1 else r][d] for c, d in enumerate(row)]
            for r, row in enumerate(mesh.devices)]


def replicate(arr, mesh: Mesh) -> dict[torch.device, torch.Tensor]:
    """One copy of ``arr`` on each distinct device of the mesh, by device."""
    src = _to_tensor(arr)
    return {d: src.to(d) for d in mesh.distinct()}


def on_devices(x, devices) -> dict[torch.device, torch.Tensor]:
    """``x`` on each of ``devices``: a :func:`replicate` result is used as
    it is, anything else is copied once per distinct device."""
    if isinstance(x, dict):
        return x
    src = _to_tensor(x)
    return {d: src.to(d) for d in dict.fromkeys(devices)}


def merge_topk(best_s: torch.Tensor, best_i: torch.Tensor, s: torch.Tensor,
               i: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best of the carried list ``(best_s, best_i)`` and the next
    list ``(s, i)`` (global rows), by one stable descending sort of the
    concatenation: equal scores keep the carried entries first, and
    within each list its own order. Used for a stream's chunks and for
    the shards' lists alike."""
    cand_s = torch.cat([best_s, s], dim=1)
    cand_i = torch.cat([best_i, i], dim=1)
    top, pos = torch.sort(cand_s, dim=1, descending=True, stable=True)
    return top[:, :k].contiguous(), cand_i.gather(1, pos[:, :k])


def unfilled(nq: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``k`` unfilled slots (−inf, −1) for each of ``nq`` queries."""
    return (torch.full((nq, k), float("-inf"), dtype=torch.float32, device=device),
            torch.full((nq, k), -1, dtype=torch.int32, device=device))


def pad_list(s: torch.Tensor, i: torch.Tensor, k: int):
    """A best-first list widened to ``k`` with unfilled slots."""
    if s.shape[1] >= k:
        return s, i
    fs, fi = unfilled(s.shape[0], k - s.shape[1], s.device)
    return torch.cat([s, fs], dim=1), torch.cat([i.to(torch.int32), fi], dim=1)


def _gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` in rank order. NCCL takes the tensors on the
    card; gloo's all_gather takes host tensors, so under gloo a CUDA list
    goes through host memory and comes back to its device."""
    backend = torch.distributed.get_backend(group)
    host = backend != "nccl" and t.device.type != "cpu"
    src = t.cpu() if host else t.contiguous()
    out = [torch.empty_like(src) for _ in range(torch.distributed.get_world_size(group))]
    torch.distributed.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if host else out


def exchange_topk(lists, k: int, mesh: Mesh | None = None):
    """The global top-k of the shards' candidate lists ``[(s, i), ...]``
    (this process's shards in shard order, each ``[Q, k_s]`` best first
    with global row ids): brought to the first list's device, gathered
    from every rank under ``mesh.group``, concatenated shard-major and cut
    by :func:`merge_topk`. Widened to ``k`` with unfilled slots where fewer
    candidates exist."""
    lead = lists[0][0].device
    ss = [s.to(lead) for s, _ in lists]
    ii = [i.to(lead) for _, i in lists]
    if mesh is not None and mesh.group is not None:
        ss = _gather(torch.cat(ss, dim=1), mesh.group)
        ii = _gather(torch.cat(ii, dim=1), mesh.group)
    if len(ss) == 1:
        head_s, head_i = ss[0][:, :0], ii[0][:, :0]
    else:
        head_s, head_i = torch.cat(ss[:-1], dim=1), torch.cat(ii[:-1], dim=1)
    return pad_list(*merge_topk(head_s, head_i, ss[-1], ii[-1], k), k)
