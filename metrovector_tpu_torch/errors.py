"""Error taxonomy for metrovector_tpu_torch.

Mirrors the capability surface of the reference error model
(``src/errors.rs:8-40`` in thegenem0/metrovector): IO, format, version,
lookup, bounds, dimension, type, corruption, extension and build errors —
re-expressed as a Python exception hierarchy so callers can catch either the
base :class:`MvtError` or a specific subclass.
"""

from __future__ import annotations


class MvtError(Exception):
    """Base class for all metrovector_tpu_torch errors."""


class IoError(MvtError):
    """Underlying file/OS I/O failure (reference: ``MvfError::Io``)."""


class InvalidFormatError(MvtError):
    """File structure is not a valid MVT file: bad magic, truncated file,
    or malformed footer (reference: ``MvfError::InvalidFormat``)."""


class UnsupportedVersionError(MvtError):
    """Footer declares a format version this library cannot read
    (reference: ``MvfError::UnsupportedVersion{got,expected}``)."""

    def __init__(self, got: int, expected: int):
        self.got = got
        self.expected = expected
        super().__init__(
            f"unsupported format version {got} (expected {expected})"
        )


class VectorSpaceNotFoundError(MvtError, KeyError):
    """Named vector space does not exist in the file
    (reference: ``MvfError::VectorSpaceNotFound``)."""

    def __init__(self, name: str):
        self.name = name
        MvtError.__init__(self, f"vector space not found: {name!r}")


class IndexOutOfBoundsError(MvtError, IndexError):
    """Vector index past the end of a space
    (reference: ``MvfError::IndexOutOfBounds{index,len}``)."""

    def __init__(self, index: int, length: int):
        self.index = index
        self.length = length
        MvtError.__init__(self, f"index {index} out of bounds (len {length})")


class VectorIdNotFoundError(MvtError, KeyError):
    """A stable external vector ID was not found in the space's ID column
    (no reference analog — the reference never writes IDs). Subclasses
    KeyError so dict-style callers keep working."""

    def __init__(self, vector_id):
        self.vector_id = vector_id
        MvtError.__init__(self, f"vector id {vector_id} not found")


class DimensionMismatchError(MvtError, ValueError):
    """Vector data does not match the space's declared dimension
    (reference: ``MvfError::DimensionMismatch{expected,actual}``)."""

    def __init__(self, expected: int, actual: int):
        self.expected = expected
        self.actual = actual
        MvtError.__init__(
            self, f"dimension mismatch: expected {expected}, got {actual}"
        )


class InvalidVectorTypeError(MvtError, TypeError):
    """Operation not valid for this vector/data type
    (reference: ``MvfError::InvalidVectorType``)."""


class CorruptedDataError(MvtError):
    """Checksum or structural integrity failure in a data block
    (reference: ``MvfError::CorruptedData``)."""


class ExtensionError(MvtError):
    """Failure in an optional extension (compression codec, quantization,
    etc.) (reference: ``MvfError::Extension``)."""


class BuildError(MvtError):
    """Builder-side misuse: duplicate space, empty build, unsupported
    encode dtype (reference: ``MvfError::Build``)."""


class MetadataColumnNotFoundError(MvtError, KeyError):
    """Named metadata column does not exist in the space."""

    def __init__(self, name: str):
        self.name = name
        MvtError.__init__(self, f"metadata column not found: {name!r}")


class HBMBudgetExceededError(MvtError, MemoryError):
    """A single space's device footprint exceeds the Database's HBM
    budget — nothing can be evicted to make it fit. No reference analog
    (the mmap reference has ~0 resident memory); this is the TPU-native
    capacity error for the serving facade."""

    def __init__(self, space: str, needed: int, budget: int):
        self.space = space
        self.needed = needed
        self.budget = budget
        MvtError.__init__(
            self,
            f"space {space!r} needs ~{needed} bytes of HBM but the "
            f"database budget is {budget} bytes; raise hbm_budget or "
            "serve this space via StreamingSearcher/PQ",
        )


class BatcherClosedError(MvtError, RuntimeError):
    """``MicroBatcher.submit`` after ``close()`` — the serving front-end
    no longer accepts requests. No reference analog (the reference ships
    no serving layer)."""
