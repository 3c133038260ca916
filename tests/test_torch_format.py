"""One file format, two implementations: the port's ``Builder`` writes the
same bytes as the JAX package's for the same inputs, and each package's
``Reader`` reads the other's file to equal arrays, checksums included.

Cases: dense f32, f16, bf16, int8 and uint8 (bf16: the port holds the bit
patterns as uint16 where the JAX package has ml_dtypes' bfloat16, so rows
compare by bits; the values include NaN, infinities, a subnormal and ties
of the rounding); sparse; a PQ sidecar; metadata
columns with a string heap and stable ids; tombstones. Each under no
compression, zlib and LZ4, with the native codec and with ``MVT_NO_NATIVE=1``
(both packages then take their numpy paths).

``rewrite_hints`` writes the same bytes as the JAX package's, and a rewrite
that fails partway (in the new footer, or at the rename) leaves the old file
whole, with its old hints, and no temporary file."""

import os

import numpy as np
import pytest

import metrovector_tpu as jax_mvt
import metrovector_tpu.native as jax_native
import metrovector_tpu_torch as port_mvt
import metrovector_tpu_torch.native as port_native
from metrovector_tpu_torch.format.constants import FOOTER_LEN_SIZE as FOOTER_LEN
from metrovector_tpu_torch.format.constants import MAGIC_LEN

KINDS = ["dense_f32", "dense_f16", "dense_bf16", "dense_int8", "dense_uint8", "sparse", "pq",
         "metadata", "tombstones"]
N, D = 60, 20


def _build(pkg, kind: str, compression: str) -> bytes:
    """The same content through one package's Builder."""
    rng = np.random.default_rng(11)
    b = pkg.Builder()
    if kind == "sparse":
        rows = [(rng.choice(300, int(rng.integers(0, 9)), replace=False),
                 rng.standard_normal(8).astype(np.float32)) for _ in range(N)]
        rows = [(c, v[: len(c)]) for c, v in rows]
        b.add_vector_space("s", dim=300, vector_type=pkg.VectorType.SPARSE,
                           metric=pkg.DistanceMetric.INNER_PRODUCT)
        b.add_sparse_vectors("s", rows)
    else:
        dtype = {"dense_f16": pkg.DataType.FLOAT16, "dense_bf16": pkg.DataType.BFLOAT16,
                 "dense_int8": pkg.DataType.INT8,
                 "dense_uint8": pkg.DataType.UINT8}.get(kind, pkg.DataType.FLOAT32)
        data = rng.standard_normal((N, D)).astype(np.float32)
        if kind == "dense_uint8":
            data = np.abs(data)
        if kind == "dense_bf16":  # specials, and values halfway between two bf16
            data[0, :8] = [np.nan, -np.nan, np.inf, -np.inf, 1e-40, 3.4e38,
                           1 + 2.0**-8, 1 + 3 * 2.0**-8]
        b.add_vector_space("s", dim=D, dtype=dtype, metric=pkg.DistanceMetric.COSINE)
        b.add_vectors("s", data)
    if kind == "pq":
        books = rng.standard_normal((4, 16, 5)).astype(np.float32)
        b.set_pq_index("s", books, rng.integers(0, 16, (N, 4)).astype(np.uint8))
    if kind == "metadata":
        b.add_metadata_column("s", "tag", [f"t{i % 7}" for i in range(N)])
        b.add_metadata_column("s", "year", list(range(1990, 1990 + N)))
        b.set_vector_ids("s", np.arange(N, dtype=np.uint64) * 13 + 5)
    if kind == "tombstones":
        for r in (0, 7, N - 1):
            b.delete_vector("s", r)
    return b.build(compression=getattr(pkg.CompressionAlgorithm, compression)).to_bytes()


def _contents(reader) -> dict:
    """Every array a reader exposes for the one space, as numpy."""
    sp = reader.vector_space("s")
    out = {"norms": np.array(sp.norms()), "num_vectors": sp.num_vectors,
           "dim": sp.dim, "metric": int(sp.metric), "dtype": int(sp.dtype)}
    if sp.is_sparse:
        out.update(zip(("indptr", "cols", "vals"),
                       (np.array(a) for a in sp.sparse_csr())))
    else:
        rows = np.array(sp.padded_array())
        out["rows"] = rows.view(np.uint16) if rows.dtype.name == "bfloat16" else rows
    out["ids"] = None if sp.ids() is None else np.array(sp.ids())
    out["tombstones"] = sp.tombstone_mask()
    pq = sp.pq_arrays()
    out["pq"] = None if pq is None else [np.array(a) for a in pq]
    out["columns"] = {c: np.array(sp.metadata_column(c))
                      for c in sp.metadata_column_names()}
    return out


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for key in a:
            _assert_same(a[key], b[key], f"{where}/{key}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for x, y in zip(a, b):
            _assert_same(x, y, where)
    elif a is None or b is None:
        assert a is None and b is None, where
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("codec", ["native", "no_native"])
@pytest.mark.parametrize("compression", ["NONE", "ZLIB", "LZ4"])
@pytest.mark.parametrize("kind", KINDS)
def test_same_bytes_and_cross_read(monkeypatch, kind, compression, codec):
    if codec == "no_native":
        monkeypatch.setenv("MVT_NO_NATIVE", "1")
        for mod in (jax_native, port_native):
            monkeypatch.setattr(mod, "_lib", None)
    else:
        assert jax_native.available() and port_native.available()
    jax_bytes = _build(jax_mvt, kind, compression)
    port_bytes = _build(port_mvt, kind, compression)
    assert port_bytes == jax_bytes
    want = _contents(jax_mvt.Reader.from_bytes(jax_bytes))
    for reader_pkg in (jax_mvt, port_mvt):
        for image in (jax_bytes, port_bytes):
            reader = reader_pkg.Reader.from_bytes(image)
            reader.validate_with_checksum()
            _assert_same(_contents(reader), want, f"{reader_pkg.__name__}")


def test_port_codec_builds_outside_its_sources():
    """The port compiles its codec into the git-ignored build tree, not next
    to ``codec.cpp`` as the JAX loader does."""
    if not port_native.available():
        pytest.skip("no C++ compiler: the port's numpy path is covered above")
    assert "/build/" in port_native._SO.replace("\\", "/")
    assert not port_native._SO.startswith(port_native._HERE)


# ------------------------------------------------------- footer rewrite ---

HINTS_OLD = {"tuned": {"s": {"dense": {"block_rows": 64}}}}
HINTS_NEW = {"tuned": {"s": {"adc": {"block_rows": 512}}, "t": {"x": 1}}}


def _file_with_hints(tmp_path, pkg, name="h.mvt") -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(_build(pkg, "metadata", "NONE"))
    pkg.rewrite_hints(path, HINTS_OLD)
    return path


def test_rewrite_hints_same_bytes_as_reference(tmp_path):
    """Both packages' rewrite_hints give the same file, twice in a row (the
    second merges into the first's hints), and the blocks still verify."""
    jax_path = _file_with_hints(tmp_path, jax_mvt, "jax.mvt")
    port_path = _file_with_hints(tmp_path, port_mvt, "port.mvt")
    jax_mvt.rewrite_hints(jax_path, HINTS_NEW)
    port_mvt.rewrite_hints(port_path, HINTS_NEW)
    with open(jax_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    reader = port_mvt.Reader.open(port_path)
    reader.validate_with_checksum()
    assert reader.manifest.hints["tuned"]["s"] == {
        "dense": {"block_rows": 64}, "adc": {"block_rows": 512}}


class _CrashingFile:
    """A file whose writes stop, with an error, halfway through the first
    write that reaches past ``limit``: a crash once the new footer has
    begun."""

    def __init__(self, f, limit):
        self._f, self._limit = f, limit

    def write(self, data):
        pos = self._f.tell()
        if pos + len(data) > self._limit:
            head = max(0, self._limit - pos)
            self._f.write(data[: head + (len(data) - head) // 2])
            self._f.flush()
            raise OSError("simulated crash while writing the footer")
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return self._f.__exit__(*exc)


def _assert_old_file(tmp_path, path, image):
    with open(path, "rb") as f:
        assert f.read() == image
    reader = port_mvt.Reader.open(path)
    reader.validate_with_checksum()
    assert reader.manifest.hints == HINTS_OLD
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]


def test_rewrite_hints_crash_in_footer_keeps_old_file(tmp_path, monkeypatch):
    """A rewrite that fails once it has begun to write the new footer leaves
    the original file as it was (old hints, blocks verify) and no
    temporary file."""
    path = _file_with_hints(tmp_path, port_mvt)
    with open(path, "rb") as f:
        image = f.read()
    flen = int.from_bytes(image[-MAGIC_LEN - FOOTER_LEN:-MAGIC_LEN], "little")
    footer_start = len(image) - MAGIC_LEN - FOOTER_LEN - flen
    real_open, real_fdopen = open, os.fdopen
    crashes = []

    def crashing(f, mode):
        if any(c in mode for c in "wa+"):
            crashes.append(mode)
            return _CrashingFile(f, footer_start)
        return f

    monkeypatch.setattr("builtins.open", lambda p, mode="r", *a, **kw: crashing(
        real_open(p, mode, *a, **kw), mode))
    monkeypatch.setattr(os, "fdopen", lambda fd, mode="r", *a, **kw: crashing(
        real_fdopen(fd, mode, *a, **kw), mode))
    with pytest.raises(OSError, match="simulated crash"):
        port_mvt.rewrite_hints(path, HINTS_NEW)
    monkeypatch.undo()
    assert crashes
    _assert_old_file(tmp_path, path, image)


def test_rewrite_hints_failed_replace_keeps_old_file(tmp_path, monkeypatch):
    path = _file_with_hints(tmp_path, port_mvt)
    with open(path, "rb") as f:
        image = f.read()

    def refuse(src, dst):
        raise OSError("simulated failure of the rename")

    monkeypatch.setattr(os, "replace", refuse)
    with pytest.raises(OSError, match="simulated failure"):
        port_mvt.rewrite_hints(path, HINTS_NEW)
    monkeypatch.undo()
    _assert_old_file(tmp_path, path, image)
