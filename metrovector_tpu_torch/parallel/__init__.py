"""Search past one card's memory: :class:`StreamingSearcher` streams a
host-resident corpus through the card in chunks. The multi-device layer of
the JAX package (its mesh, sharded search and distributed searchers) is
not ported yet."""

from .streaming import StreamingSearcher

__all__ = ["StreamingSearcher"]
