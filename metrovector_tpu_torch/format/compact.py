"""Rebuilds: load an existing MVT file back into a Builder.

Two user-facing workflows share the machinery:

* :func:`compact` — rebuild without tombstoned rows (renumbering; stable
  IDs survive).
* :func:`builder_from_reader` — the append/update path the reference has
  no story for (its builds are one-shot, ``src/builder.rs``): load every
  space verbatim (rows, IDs, tombstones, metadata, index configs,
  extensions) into a fresh :class:`Builder` so callers can
  ``add_vectors(...)`` / ``delete_vector(...)`` and re-emit the file.

The reference has no deletion story beyond schema-level tombstones it never
writes (``src/builder.rs:485`` in thegenem0/metrovector); MVT writes them
(``Builder.delete_vector``) and masks them at query time, and this module
closes the loop: physically drop deleted rows, renumber, filter metadata
columns, and re-emit a clean file. Index structures (IVF blocks, HNSW
graphs, PQ sidecars) are carried as *configuration* only — their persisted
blocks reference old row ids, so they are dropped and rebuilt lazily on
next use (``*.from_space`` retrains when blocks are absent). File-level
custom extensions and the security descriptor are row-independent and
round-trip verbatim.
"""

from __future__ import annotations

import numpy as np

from ..format.constants import VectorType
from ..format.manifest import IndexInfo
from .builder import Builder, BuiltFile
from .reader import Reader


def builder_from_reader(
    reader: Reader,
    drop_deleted: bool = False,
    materialize_ids: bool = False,
) -> Builder:
    """Load an open file's full contents into a fresh :class:`Builder`.

    With ``drop_deleted=False`` (the append workflow) rows, stable IDs
    AND tombstones carry over verbatim — append more vectors, delete
    more rows, then ``build().save(...)``. With ``drop_deleted=True``
    (the compaction workflow) tombstoned rows are physically removed and
    the survivors renumbered; stable ID columns are filtered so external
    references by ID stay valid. ``materialize_ids=True`` additionally
    writes the *pre-rebuild row positions* as the ID column of spaces
    that had none, so position-based references taken before a
    compaction can still be resolved afterwards."""
    b = Builder()
    for k, v in reader.manifest.hints.items():
        b.set_hint(k, v)
    # Carry file-level extension payloads and the security descriptor —
    # they are row-independent and must survive compaction verbatim.
    for ext_name in reader.extension_names():
        b.add_extension(ext_name, bytes(reader.extension(ext_name)))
    if reader.security:
        b.set_security(**reader.security)
    for name in reader.vector_space_names:
        sp = reader.vector_space(name)
        info = sp.info
        mask = sp.tombstone_mask()
        if drop_deleted and mask is not None:
            keep = ~mask
        else:
            keep = np.ones(sp.num_vectors, bool)

        handle = b.add_vector_space(
            name,
            dim=sp.dim,
            vector_type=info.vector_type,
            metric=sp.metric,
            dtype=sp.dtype,
            pad_dims=(info.padded_dim != sp.dim) or info.padded_dim == 0,
        )
        if sp.quantization is not None:
            # carry calibration; raw codes re-enter untouched below
            handle.with_quantization(
                sp.quantization.scale, sp.quantization.zero_point
            )
        if info.index.kind != 0:
            # Strip everything that references old block ids or old row
            # numbering: top-level *_block entries (IVF), the HNSW per-layer
            # block list and its entry node id. What survives is pure
            # configuration; graphs/assignments rebuild lazily on next use.
            params = {
                k: v
                for k, v in info.index.params.items()
                if not k.endswith("_block") and k not in ("layers", "entry")
            }
            b._get_space(name).index = IndexInfo(
                kind=info.index.kind, params=params
            )

        if info.vector_type == VectorType.SPARSE:
            kept_rows = [
                (v.cols, v.values)
                for i in np.flatnonzero(keep)
                for v in (sp.get_vector(int(i)),)
            ]
            b.add_sparse_vectors(name, kept_rows)
        elif keep.any():
            # raw stored values (codes for quantized spaces) pass through
            b.add_vectors(name, sp.to_numpy()[keep])

        ids = sp.ids()
        if ids is not None:
            b.set_vector_ids(name, ids[keep])
        elif materialize_ids and keep.any():
            b.set_vector_ids(name, np.flatnonzero(keep).astype(np.uint64))

        if not drop_deleted and mask is not None:
            # append workflow: tombstones carry over as-is
            for i in np.flatnonzero(mask):
                b.delete_vector(name, int(i))

        for col_name in sp.metadata_column_names():
            vals = sp.metadata_column(col_name)
            if isinstance(vals, list):  # string column
                kept = [v for v, k_ in zip(vals, keep) if k_]
            else:
                kept = vals[keep]
            col_info = sp._column_info(col_name)
            b.add_metadata_column(name, col_name, kept, dtype=col_info.dtype)

    return b


def compact(
    reader: Reader, path=None, materialize_ids: bool = False
) -> BuiltFile:
    """Rebuild every space without deleted rows. Returns the new
    :class:`BuiltFile`; also saves to ``path`` when given. See
    :func:`builder_from_reader` for the carrying rules."""
    built = builder_from_reader(
        reader, drop_deleted=True, materialize_ids=materialize_ids
    ).build()
    if path is not None:
        built.save(path)
    return built
