"""Index structures (counterpart of :mod:`metrovector_tpu.index`): PQ with
exact re-rank, IVF and IVF-PQ and the k-means they train with, on the
device, and HNSW on the host.

The names import lazily, so ``import metrovector_tpu_torch.index`` loads
no kernel module."""

_LAZY = {
    "HNSWIndex": "metrovector_tpu_torch.index.hnsw",
    "IVFIndex": "metrovector_tpu_torch.index.ivf",
    "bucket_layout": "metrovector_tpu_torch.index.ivf",
    "train_kmeans": "metrovector_tpu_torch.index.ivf",
    "IVFPQIndex": "metrovector_tpu_torch.index.ivfpq",
    "train_ivfpq": "metrovector_tpu_torch.index.ivfpq",
    "PQIndex": "metrovector_tpu_torch.index.pq",
    "encode_pq": "metrovector_tpu_torch.index.pq",
    "pack_codes4": "metrovector_tpu_torch.index.pq",
    "reconstruct_pq": "metrovector_tpu_torch.index.pq",
    "train_pq": "metrovector_tpu_torch.index.pq",
    "unpack_codes4": "metrovector_tpu_torch.index.pq",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_LAZY)
