"""The MVT footer manifest: typed description of every block in the file.

Plays the role of the reference's FlatBuffers ``FileFooter`` tree
(``schema/mvf.fbs:12-30``, ``schema/core.fbs`` in thegenem0/metrovector):
block table with offsets/sizes/checksums, per-space metadata (name, dims,
dtype, metric, index config, tombstones, quantization), metadata columns and
the string heap. Encoded as canonical JSON — footer parsing is a cold path
(once per open); the hot byte paths live in the native codec.

Beyond the reference, each space records its **physical tiling**
(``padded_rows`` × ``padded_dim``) and an optional precomputed squared-norms
block, so the reader can hand a block straight to the TPU as a tile-aligned
array and run L2/cosine epilogues without touching the raw vectors again.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from ..errors import InvalidFormatError
from .constants import (
    FORMAT_VERSION,
    CompressionAlgorithm,
    DataType,
    DistanceMetric,
    IndexKind,
    TombstoneFormat,
    VectorType,
)


@dataclasses.dataclass
class BlockInfo:
    """One data block (reference ``DataBlock``, ``schema/core.fbs:7-13``)."""

    offset: int  # absolute byte offset from start of file
    size: int  # stored (possibly compressed) size in bytes
    crc32: int  # zlib CRC32 of the *stored* bytes
    compression: CompressionAlgorithm = CompressionAlgorithm.NONE
    uncompressed_size: int = 0  # == size when compression is NONE

    def to_json(self) -> dict[str, Any]:
        return {
            "offset": self.offset,
            "size": self.size,
            "crc32": self.crc32,
            "compression": int(self.compression),
            "uncompressed_size": self.uncompressed_size,
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "BlockInfo":
        return cls(
            offset=int(d["offset"]),
            size=int(d["size"]),
            crc32=int(d["crc32"]),
            compression=CompressionAlgorithm(d.get("compression", 0)),
            uncompressed_size=int(d.get("uncompressed_size", d["size"])),
        )


@dataclasses.dataclass
class IndexInfo:
    """Index configuration attached to a space (reference ``Index`` union,
    ``schema/index.fbs:6-36``). ``params`` carries kind-specific settings
    (IVF: num_clusters/nprobe + centroids/assignment block ids; HNSW: M,
    ef_construction)."""

    kind: IndexKind = IndexKind.NONE
    params: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict[str, Any]:
        return {"kind": int(self.kind), "params": self.params}

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "IndexInfo":
        return cls(kind=IndexKind(d.get("kind", 0)), params=dict(d.get("params", {})))


@dataclasses.dataclass
class QuantizationInfo:
    """Per-space scalar quantization parameters (reference's SQ extension,
    ``schema/extensions.fbs`` quantization tables). Dequantized value =
    ``(stored - zero_point) * scale``. For int8/uint8 spaces the search
    engine folds these into the distance epilogue so ranking matches the
    float-space order."""

    scale: float = 1.0
    zero_point: float = 0.0
    source_dtype: DataType = DataType.FLOAT32

    def to_json(self) -> dict[str, Any]:
        return {
            "scale": self.scale,
            "zero_point": self.zero_point,
            "source_dtype": int(self.source_dtype),
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "QuantizationInfo":
        return cls(
            scale=float(d.get("scale", 1.0)),
            zero_point=float(d.get("zero_point", 0.0)),
            source_dtype=DataType(d.get("source_dtype", 0)),
        )


@dataclasses.dataclass
class PQInfo:
    """Per-space product-quantization sidecar (the reference's PQ codebook
    extension, ``schema/extensions.fbs`` quantization tables — declared
    there, never written; implemented here, see
    :mod:`metrovector_tpu.index.pq`). Blocks: codebooks ``[m, ksub, dsub]``
    f32, codes ``[N, m]`` u8, reconstruction squared norms ``[N]`` f32."""

    m: int = 0
    ksub: int = 0
    dsub: int = 0
    codebooks_block: int = -1
    codes_block: int = -1
    recon_norms_block: int = -1
    # True when codes encode residuals x − centroid[assignment] against the
    # space's stored IVF coarse quantizer (IVF-PQ). recon_norms then hold
    # ‖x̂‖² of the FULL reconstruction centroid + decoded residual.
    residual: bool = False
    # True when the codes block is nibble-packed 4-bit PQ (``ksub ≤ 16``):
    # ``[N, ⌈m/2⌉]`` u8, even subspaces in low nibbles — half the bytes of
    # classic byte codes at the same m (see index.pq.pack_codes4).
    packed4: bool = False

    def to_json(self) -> dict[str, Any]:
        return {
            "m": self.m,
            "ksub": self.ksub,
            "dsub": self.dsub,
            "codebooks_block": self.codebooks_block,
            "codes_block": self.codes_block,
            "recon_norms_block": self.recon_norms_block,
            "residual": self.residual,
            "packed4": self.packed4,
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "PQInfo":
        return cls(
            m=int(d.get("m", 0)),
            ksub=int(d.get("ksub", 0)),
            dsub=int(d.get("dsub", 0)),
            codebooks_block=int(d.get("codebooks_block", -1)),
            codes_block=int(d.get("codes_block", -1)),
            recon_norms_block=int(d.get("recon_norms_block", -1)),
            residual=bool(d.get("residual", False)),
            packed4=bool(d.get("packed4", False)),
        )


@dataclasses.dataclass
class TombstoneInfo:
    """Deleted-row bookkeeping (reference ``TombstoneInfo``,
    ``schema/core.fbs:35-39``). BITMAP: ``block`` holds one byte per
    8 rows (LSB-first); SORTED_LIST: ``block`` holds sorted u32 row ids."""

    format: TombstoneFormat = TombstoneFormat.NONE
    block: int = -1  # block id, -1 when absent
    count: int = 0  # number of deleted rows

    def to_json(self) -> dict[str, Any]:
        return {"format": int(self.format), "block": self.block, "count": self.count}

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "TombstoneInfo":
        return cls(
            format=TombstoneFormat(d.get("format", 0)),
            block=int(d.get("block", -1)),
            count=int(d.get("count", 0)),
        )


@dataclasses.dataclass
class ColumnInfo:
    """Columnar metadata column (reference ``MetadataColumn``,
    ``schema/core.fbs:16-25``). Fixed-width dtypes store raw LE values;
    ``STRING_REF`` stores u32 offsets into the space's string heap."""

    name: str
    dtype: DataType
    block: int  # block id of the column data
    count: int  # logical number of values

    def to_json(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "dtype": int(self.dtype),
            "block": self.block,
            "count": self.count,
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "ColumnInfo":
        return cls(
            name=str(d["name"]),
            dtype=DataType(d["dtype"]),
            block=int(d["block"]),
            count=int(d["count"]),
        )


@dataclasses.dataclass
class SparseInfo:
    """CSR storage for a SPARSE space (the reference declares
    ``VectorType::Sparse`` and a ``SparseMetadata`` table,
    ``schema/core.fbs:28-32``, but can neither build nor read one):
    ``values`` (space dtype), ``cols`` (u32) and ``indptr`` (u64,
    ``num_vectors + 1`` entries) blocks."""

    values_block: int = -1
    cols_block: int = -1
    indptr_block: int = -1
    nnz: int = 0

    def to_json(self) -> dict[str, Any]:
        return {
            "values_block": self.values_block,
            "cols_block": self.cols_block,
            "indptr_block": self.indptr_block,
            "nnz": self.nnz,
        }

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "SparseInfo":
        return cls(
            values_block=int(d.get("values_block", -1)),
            cols_block=int(d.get("cols_block", -1)),
            indptr_block=int(d.get("indptr_block", -1)),
            nnz=int(d.get("nnz", 0)),
        )


@dataclasses.dataclass
class SpaceInfo:
    """One named vector space (reference ``VectorSpace`` table,
    ``schema/core.fbs:42-57``) plus the TPU tiling facts the reference
    doesn't need: physical ``padded_rows``/``padded_dim`` and the optional
    precomputed squared-L2-norms block."""

    name: str
    dim: int  # logical dimension
    num_vectors: int  # logical row count
    dtype: DataType
    vector_type: VectorType = VectorType.DENSE
    metric: DistanceMetric = DistanceMetric.L2
    padded_dim: int = 0  # physical elements per row in the block
    padded_rows: int = 0  # physical rows in the block
    vectors_block: int = -1  # block id of the tile-packed vector data
    norms_block: int = -1  # block id of f32 squared norms (padded_rows,)
    # Optional stable external IDs: block of u64 LE, one per logical row
    # (reference ``vector_ids_block_index``, ``schema/core.fbs:54`` — "0 =
    # use positions as IDs"; here −1 means positions are the IDs). Unlike
    # positions, these survive compaction.
    ids_block: int = -1
    index: IndexInfo = dataclasses.field(default_factory=IndexInfo)
    quantization: QuantizationInfo | None = None
    tombstones: TombstoneInfo = dataclasses.field(default_factory=TombstoneInfo)
    columns: list[ColumnInfo] = dataclasses.field(default_factory=list)
    string_heap_block: int = -1  # block id of this space's string heap
    sparse: SparseInfo | None = None  # present iff vector_type == SPARSE
    pq: PQInfo | None = None  # product-quantization sidecar

    def to_json(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name,
            "dim": self.dim,
            "num_vectors": self.num_vectors,
            "dtype": int(self.dtype),
            "vector_type": int(self.vector_type),
            "metric": int(self.metric),
            "padded_dim": self.padded_dim,
            "padded_rows": self.padded_rows,
            "vectors_block": self.vectors_block,
            "norms_block": self.norms_block,
            "ids_block": self.ids_block,
            "index": self.index.to_json(),
            "tombstones": self.tombstones.to_json(),
            "columns": [c.to_json() for c in self.columns],
            "string_heap_block": self.string_heap_block,
        }
        if self.quantization is not None:
            d["quantization"] = self.quantization.to_json()
        if self.sparse is not None:
            d["sparse"] = self.sparse.to_json()
        if self.pq is not None:
            d["pq"] = self.pq.to_json()
        return d

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "SpaceInfo":
        return cls(
            name=str(d["name"]),
            dim=int(d["dim"]),
            num_vectors=int(d["num_vectors"]),
            dtype=DataType(d["dtype"]),
            vector_type=VectorType(d.get("vector_type", 0)),
            metric=DistanceMetric(d.get("metric", 0)),
            padded_dim=int(d.get("padded_dim", 0)),
            padded_rows=int(d.get("padded_rows", 0)),
            vectors_block=int(d.get("vectors_block", -1)),
            norms_block=int(d.get("norms_block", -1)),
            ids_block=int(d.get("ids_block", -1)),
            index=IndexInfo.from_json(d.get("index", {})),
            quantization=(
                QuantizationInfo.from_json(d["quantization"])
                if "quantization" in d
                else None
            ),
            tombstones=TombstoneInfo.from_json(d.get("tombstones", {})),
            columns=[ColumnInfo.from_json(c) for c in d.get("columns", [])],
            string_heap_block=int(d.get("string_heap_block", -1)),
            sparse=(
                SparseInfo.from_json(d["sparse"]) if "sparse" in d else None
            ),
            pq=(PQInfo.from_json(d["pq"]) if "pq" in d else None),
        )


@dataclasses.dataclass
class Manifest:
    """The whole footer (reference ``FileFooter``, ``schema/mvf.fbs:12-30``)."""

    version: int = FORMAT_VERSION
    # Oldest reader version that can open this file (see
    # constants.FORMAT_VERSION). Writers set it from the features actually
    # used, so a v2 writer producing a v1-feature file stays maximally
    # compatible.
    compat_version: int = FORMAT_VERSION
    spaces: list[SpaceInfo] = dataclasses.field(default_factory=list)
    blocks: list[BlockInfo] = dataclasses.field(default_factory=list)
    stats: dict[str, Any] = dataclasses.field(default_factory=dict)
    hints: dict[str, Any] = dataclasses.field(default_factory=dict)
    # Named custom extension blocks (reference ``CustomExtension`` entries,
    # ``schema/extensions.fbs``): extension name → block id.
    extensions: dict[str, int] = dataclasses.field(default_factory=dict)
    # Declarative security descriptor (reference security/encryption tables,
    # ``schema/extensions.fbs`` — declarative there too; MVT round-trips it
    # verbatim, it does not encrypt).
    security: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_bytes(self) -> bytes:
        doc = {
            "format": "mvt",
            "version": self.version,
            "compat_version": self.compat_version,
            "spaces": [s.to_json() for s in self.spaces],
            "blocks": [b.to_json() for b in self.blocks],
            "stats": self.stats,
            "hints": self.hints,
        }
        if self.extensions:
            doc["extensions"] = self.extensions
        if self.security:
            doc["security"] = self.security
        return json.dumps(doc, separators=(",", ":"), sort_keys=True).encode("utf-8")

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Manifest":
        try:
            doc = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise InvalidFormatError(f"malformed footer manifest: {exc}") from exc
        if not isinstance(doc, dict) or doc.get("format") != "mvt":
            raise InvalidFormatError("footer is not an MVT manifest")
        try:
            return cls(
                version=int(doc["version"]),
                # v1 files predate the field: they require exactly a v1-capable
                # reader, i.e. compat == their version.
                compat_version=int(doc.get("compat_version", doc["version"])),
                spaces=[SpaceInfo.from_json(s) for s in doc.get("spaces", [])],
                blocks=[BlockInfo.from_json(b) for b in doc.get("blocks", [])],
                stats=dict(doc.get("stats", {})),
                hints=dict(doc.get("hints", {})),
                extensions={
                    str(k): int(v)
                    for k, v in dict(doc.get("extensions", {})).items()
                },
                security=dict(doc.get("security", {})),
            )
        except (KeyError, ValueError, TypeError) as exc:
            raise InvalidFormatError(f"invalid manifest field: {exc}") from exc

    def space(self, name: str) -> SpaceInfo | None:
        for s in self.spaces:
            if s.name == name:
                return s
        return None
