"""Index structures (counterpart of :mod:`metrovector_tpu.index`). This
slice holds PQ with exact re-rank and the k-means it trains with; IVF,
IVF-PQ and HNSW come later (ROADMAP A7, A9, A10).

The names import lazily, so ``import metrovector_tpu_torch.index`` loads
no kernel module."""

_LAZY = {
    "train_kmeans": "metrovector_tpu_torch.index.ivf",
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
