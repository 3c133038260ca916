"""Several processes, one sharded corpus: the counterpart of
:mod:`metrovector_tpu.parallel.distributed`, on ``torch.distributed``.

:func:`initialize` joins a process group (NCCL for cards, gloo for a CPU
mesh or on request), :func:`global_mesh` makes this process's part of the
mesh with that group, and :func:`load_space_sharded` reads only this
process's shards' rows, as slices of the file's mapped block, so the page
cache of each host faults in only its own rows. :class:`DistributedSearcher`
is a :class:`~.sharded_search.ShardedDeviceSpace` over such a mesh: each
rank scans its shards and the candidate lists meet in one ``all_gather``
(:func:`.mesh.exchange_topk`), so every rank returns the whole answer.

One process with no group is the same code with a world of one.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..format.constants import sublane_multiple
from ..utils.transfer import put_chunked
from .mesh import SHARD_AXIS, Mesh, make_mesh, rows_per_shard
from .sharded_search import ShardedDeviceSpace, local_valid


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """Join a ``torch.distributed`` process group: ``coordinator_address``
    (``"host:port"`` of rank 0's rendezvous), the world size and this
    process's rank. ``backend``: ``"nccl"`` when CUDA is available, else
    ``"gloo"``, unless given (gloo serves a CPU mesh, or several processes
    sharing one card, which NCCL refuses). With no address and no
    ``WORLD_SIZE``/``MASTER_ADDR`` in the environment it does nothing (one
    process); with them it joins by the environment. A group already
    joined is kept."""
    dist = torch.distributed
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None and num_processes is None:
        if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
            return  # one process: nothing to join
        dist.init_process_group(backend, init_method="env://")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("coordinator_address, num_processes and process_id come together")
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                            rank=int(process_id))


def global_mesh(axis: str = SHARD_AXIS, devices=None) -> Mesh:
    """This process's part of the mesh over every process: its
    ``devices`` (default every visible card; every process must hold as
    many), with the default process group when one is joined. Rank r's
    positions are the shards ``[r·L, (r+1)·L)``."""
    local = make_mesh(axis=axis, devices=devices)
    group = torch.distributed.group.WORLD if torch.distributed.is_initialized() else None
    return Mesh(local.devices, local.axis_names, group)


def _upload(piece: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host slice on ``dev``: bf16 bit patterns become bfloat16."""
    if piece.dtype == np.uint16:
        return put_chunked(piece.view(np.int16), dev).view(torch.bfloat16)
    return put_chunked(np.ascontiguousarray(piece), dev)


def load_space_sharded(space, mesh: Mesh | None = None, axis: str = SHARD_AXIS,
                       uint8_offset: bool = False):
    """Load one dense space row-sharded over ``mesh`` (default
    :func:`global_mesh`), reading only this process's shards' rows of the
    mapped block. Returns ``(data, norms, valid_mask, rowsums,
    rows_per_shard)``: lists of this process's shard tensors (``valid_mask``
    None without tombstones, ``rowsums`` None unless ``uint8_offset``).

    ``uint8_offset``: each slice is recentred to ``c − 128`` (the pad
    columns and the rows past ``num_valid`` zero) and its per-row code sums
    computed, so no process holds more than its slices."""
    if mesh is None:
        mesh = global_mesh(axis)
    if len(mesh.axis_names) != 1:
        raise ValueError(f"a 1-D mesh is needed, got axes {mesh.axis_names}")
    n_shards = mesh.size(axis)
    per = rows_per_shard(space.padded_rows, n_shards, sublane_multiple(space.dtype))
    block = space.padded_array()  # the mapped file: slicing reads nothing yet
    norms = space.norms()
    dead = space.tombstone_mask()
    dim, nvalid = space.dim, space.num_vectors
    data, nrm, valid, sums = [], [], [], []
    for j, dev in enumerate(mesh.devices):
        lo = (mesh.first_shard() + j) * per
        hi = max(lo, min(lo + per, block.shape[0]))
        rows = hi - lo
        piece = np.zeros((per, block.shape[1]), block.dtype)
        piece[:rows] = block[lo:hi]
        if uint8_offset:
            # c − 128 as int8 is c's byte with its top bit flipped.
            piece = piece ^ np.uint8(0x80)
            piece = piece.view(np.int8)
            piece[:, dim:] = 0
            piece[local_valid(nvalid, lo // per, per):] = 0
            sums.append(torch.from_numpy(
                piece[:, :dim].sum(axis=1, dtype=np.int32).astype(np.float32)).to(dev))
        data.append(_upload(piece, dev))
        n = np.zeros(per, np.float32)
        n[:rows] = norms[lo:hi]
        nrm.append(torch.from_numpy(n).to(dev))
        if dead is not None:
            v = np.zeros(per, np.float32)
            live = max(0, min(hi, nvalid) - lo)
            v[:live] = ~dead[lo:lo + live]
            v[live:rows] = 1.0  # padding rows: left out by the row count
            valid.append(torch.from_numpy(v).to(dev))
    return (data, nrm, valid if dead is not None else None,
            sums if uint8_offset else None, per)


class DistributedSearcher(ShardedDeviceSpace):
    """Global exact search over a space sharded across processes: a
    :class:`~.sharded_search.ShardedDeviceSpace` on :func:`global_mesh`
    (or ``mesh``), which loads only this rank's rows; every rank calls
    :meth:`search` with the same batch and gets the whole answer."""

    def __init__(self, space, mesh: Mesh | None = None, axis: str = SHARD_AXIS):
        super().__init__(space, global_mesh(axis) if mesh is None else mesh, axis)
