"""k-means on the device: the training half of
:mod:`metrovector_tpu.index.ivf` (``IVFIndex`` is ROADMAP A7).

Lloyd's k-means with k-means++ seeding. The assignment step is a blocked
``argmax 2x·c − ‖c‖²`` matmul in full f32 (no TF32), ties to the first
centroid; the update step is a segment sum (``index_add_``). The host-side
seeding is the reference's code, and :func:`train_kmeans` makes the same
``np.random.Generator`` calls in the same order, so both packages start
from the same seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine import resolve_device
from ..ops.distances import full_f32_matmul


def _assign(data: torch.Tensor, centroids: torch.Tensor,
            c_norms: torch.Tensor, block_rows: int = 65536) -> torch.Tensor:
    """Nearest-centroid assignment, blocked over rows: int64 ``[N]``."""
    out = []
    for start in range(0, data.shape[0], block_rows):
        blk = data[start : start + block_rows]
        with full_f32_matmul():
            scores = 2.0 * (blk @ centroids.T) - c_norms[None, :]
        out.append(torch.argmax(scores, dim=1))  # the first maximum
    if not out:
        return torch.empty(0, dtype=torch.int64, device=data.device)
    return torch.cat(out)


def _update(data: torch.Tensor, assignments: torch.Tensor,
            num_clusters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums ``[C, D]`` and counts ``[C]`` (f32)."""
    sums = torch.zeros((num_clusters, data.shape[1]), dtype=torch.float32,
                       device=data.device)
    sums.index_add_(0, assignments, data)
    counts = torch.zeros(num_clusters, dtype=torch.float32, device=data.device)
    counts.index_add_(0, assignments,
                      torch.ones(data.shape[0], dtype=torch.float32,
                                 device=data.device))
    return sums, counts


def _kmeanspp_init(
    train: np.ndarray, k: int, rng: np.random.Generator, cap: int = 65_536
) -> np.ndarray:
    """k-means++ seeding (D² sampling) on a capped subsample, on the host:
    the reference's ``_kmeanspp_init`` line for line."""
    pool = train
    cap = min(cap, max(8_192, (1 << 22) // max(k, 1)))
    if pool.shape[0] > cap:
        pool = pool[rng.choice(pool.shape[0], cap, replace=False)]
    n = pool.shape[0]
    centers = np.empty((k, pool.shape[1]), np.float32)
    centers[0] = pool[rng.integers(n)]
    d2 = ((pool - centers[0]) ** 2).sum(1)
    for i in range(1, k):
        total = float(d2.sum())
        if not np.isfinite(total) or total <= 0.0:
            # Degenerate pool: uniform sampling instead of D² weights.
            centers[i] = pool[rng.integers(n)]
        else:
            centers[i] = pool[rng.choice(n, p=d2 / total)]
        d2 = np.minimum(d2, ((pool - centers[i]) ** 2).sum(1))
    return centers


def _sq_norms(c: torch.Tensor) -> torch.Tensor:
    return (c * c).sum(1)


def train_kmeans(
    data: np.ndarray,
    num_clusters: int,
    iters: int = 10,
    seed: int = 0,
    sample: int | None = 262_144,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """k-means++-seeded Lloyd's k-means on ``device``. ``data``: host
    ``[N, D]`` f32. Training runs on a random row subsample of ``sample``
    rows when N is larger; the final assignment covers all rows. Returns
    ``(centroids [C, D] f32, assignments [N] int32)``."""
    dev = resolve_device(device)
    n, d = data.shape
    num_clusters = min(num_clusters, n)
    rng = np.random.default_rng(seed)
    train = data
    if sample is not None and n > sample:
        train = data[rng.choice(n, sample, replace=False)]
    train = np.ascontiguousarray(train, dtype=np.float32)
    train_dev = torch.from_numpy(train).to(dev)

    centroids = torch.from_numpy(_kmeanspp_init(train, num_clusters, rng)).to(dev)
    for _ in range(iters):
        assign = _assign(train_dev, centroids, _sq_norms(centroids))
        sums, counts = _update(train_dev, assign, num_clusters)
        sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
        # Reseed empty clusters from random training rows.
        empty = counts == 0
        new_c = sums / np.maximum(counts[:, None], 1.0)
        if empty.any():
            new_c[empty] = train[rng.choice(train.shape[0], int(empty.sum()))]
        centroids = torch.from_numpy(new_c.astype(np.float32)).to(dev)

    full = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(dev)
    assignments = _assign(full, centroids, _sq_norms(centroids))
    return centroids.cpu().numpy(), assignments.to(torch.int32).cpu().numpy()
