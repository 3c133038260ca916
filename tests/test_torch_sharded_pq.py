"""The port's sharded PQ search (K2 on each shard, K3's exact re-rank on
each shard's own rows, one exchange) on CPU meshes against the JAX
package's ``sharded_pq_topk`` on the 8-device virtual CPU mesh and against
the port's single-device ``PQIndex``: the mirror of
``tests/test_sharded_pq.py``.

The data is made exact: integer codebooks, integer queries and rows near
the reconstructions by integer offsets, so every LUT entry, ADC sum and
re-ranked score is an integer held exactly in f32 (the bf16 LUT too: its
entries stay below 256). Indices and scores are then identical to the
JAX package's and to the single-device index's, whatever the order of
the sums; cosine divides, so there the scores agree within the cosine
band of ``_torch_parity.tolerance`` and the int8 LUT's (the LUT's scale
rounds in another order) within 4 f32 ulps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metrovector_tpu import DistanceMetric
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.parallel import make_mesh as jax_mesh
from metrovector_tpu.parallel import replicate as jax_replicate
from metrovector_tpu.parallel import shard_rows as jax_shard_rows
from metrovector_tpu.parallel import sharded_pq_topk as jax_sharded_pq
from metrovector_tpu_torch.index.pq import PQIndex, pack_codes4, reconstruct_pq
from metrovector_tpu_torch.ops.adc_kernel import adc_tables, fused_adc_topk
from metrovector_tpu_torch.parallel import make_mesh, sharded_pq_topk

from _torch_parity import sq_norms, tolerance, unit_rows

ULP4 = 4 * 2.0**-24


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _case(rng, n=800, d=16, m=4, ksub=16, nq=5):
    books = rng.integers(-3, 4, (m, ksub, d // m)).astype(np.float32)
    codes = rng.integers(0, ksub, (n, m)).astype(np.uint8)
    recon = reconstruct_pq(codes, books)
    data = recon + rng.integers(-1, 2, (n, d)).astype(np.float32)
    q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    return dict(books=books, codes=codes, recon=recon, rnorms=sq_norms(recon), data=data,
                dnorms=sq_norms(data), q=q, n=n)


def _port(c, k, metric, mesh, q=None, **kw):
    q = c["q"] if q is None else q
    s, i = sharded_pq_topk(torch.from_numpy(q), c["codes"], torch.from_numpy(c["books"]),
                           c["rnorms"], c["n"], k, metric, mesh, **kw)
    return s.numpy(), i.numpy()


def _jax(c, k, metric, shards, q=None, codes=None, **kw):
    mesh = jax_mesh(shards)
    q = c["q"] if q is None else q
    codes = c["codes"] if codes is None else codes
    if "db" in kw:
        kw["db"] = jax_shard_rows(kw["db"], mesh)
        kw["db_norms"] = jax_shard_rows(kw["db_norms"], mesh)
    s, i = jax_sharded_pq(jax_replicate(q, mesh), jax_shard_rows(codes, mesh),
                          jnp.asarray(c["books"]), jax_shard_rows(c["rnorms"], mesh),
                          c["n"], k, metric, mesh, **kw)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("metric", [DistanceMetric.L2, DistanceMetric.INNER_PRODUCT])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_adc_matches_jax_and_reconstruction_oracle(rng, shards, metric):
    c = _case(rng)
    got = _port(c, 10, metric, cpu_mesh(shards), exact_lut=True)
    want = _jax(c, 10, metric, shards, exact_lut=True, backend="xla")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    _, oi = numpy_oracle(c["q"], c["recon"], 10, metric)
    np.testing.assert_array_equal(got[1], oi)


def test_rerank_at_full_depth_matches_the_true_oracle(rng):
    """Each shard re-ranks every one of its rows (rerank = a shard's rows):
    the exact answer over the original rows, as the JAX package's."""
    c = _case(rng, n=640)
    kw = dict(db=c["data"], db_norms=c["dnorms"], rerank=640 // 8)
    got = _port(c, 10, DistanceMetric.L2, cpu_mesh(8), **kw)
    want = _jax(c, 10, DistanceMetric.L2, 8, backend="xla", **kw)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    _, oi = numpy_oracle(c["q"], c["data"], 10, DistanceMetric.L2)
    np.testing.assert_array_equal(got[1], oi)


@pytest.mark.parametrize("rerank", [0, 40])
@pytest.mark.parametrize("lut", ["f32", "bf16"])
def test_matches_jax_kernel_interpret(rng, lut, rerank):
    """Against the JAX package's own ADC kernel (interpret mode) on 4
    shards: the f32 and bf16 LUTs, with and without a shard-local
    re-rank (fetch 40 of a shard's 128 rows)."""
    c = _case(rng, n=512)
    kw = dict(exact_lut=lut == "f32")
    if rerank:
        kw.update(db=c["data"], db_norms=c["dnorms"], rerank=rerank)
    got = _port(c, 8, DistanceMetric.L2, cpu_mesh(4), **kw)
    want = _jax(c, 8, DistanceMetric.L2, 4, backend="pallas", interpret=True, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("lut", ["f32", "bf16", "int8"])
def test_matches_the_single_device_index(rng, lut):
    """The sharded ADC (no re-rank) equals the port's single-device
    PQIndex on each LUT: a row's ADC score does not depend on its shard,
    and the int8 LUT is quantized per query over the whole LUT."""
    c = _case(rng, n=1024, d=32, m=8)
    idx = PQIndex.build(c["data"], DistanceMetric.L2, codebooks=c["books"], codes=c["codes"],
                        recon_norms=c["rnorms"], keep_vectors=False, device="cpu")
    kw = dict(exact_lut=lut == "f32", int8_lut=lut == "int8")
    single = idx.search(c["q"], k=10, **kw)
    got = _port(c, 10, DistanceMetric.L2, cpu_mesh(8), **kw)
    np.testing.assert_array_equal(got[1], single.indices)
    np.testing.assert_array_equal(got[0], single.scores)


def test_cosine_matches_single_device_and_jax(rng):
    """Cosine with queries normalized by the caller, as the reference
    asks: the single-device index's indices, the JAX package's within the
    cosine band."""
    c = _case(rng, n=400)
    qn = unit_rows(c["q"])
    idx = PQIndex.build(c["data"], DistanceMetric.COSINE, codebooks=c["books"],
                        codes=c["codes"], recon_norms=c["rnorms"], keep_vectors=False,
                        device="cpu")
    single = idx.search(c["q"], k=10, exact_lut=True)
    got = _port(c, 10, DistanceMetric.COSINE, cpu_mesh(8), q=qn, exact_lut=True)
    np.testing.assert_array_equal(got[1], single.indices)
    want = _jax(c, 10, DistanceMetric.COSINE, 8, q=qn, exact_lut=True, backend="xla")
    np.testing.assert_array_equal(got[1], want[1])
    band = tolerance(qn, c["recon"], DistanceMetric.COSINE)[0]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=band)


def test_int8_lut_near_the_exact_lut_and_the_jax_kernel(rng):
    """The reference's check (the int8 LUT's candidates overlap the exact
    LUT's), plus the JAX package's int8 LUT kernel in interpret mode: the
    same rows."""
    c = _case(rng, n=1024, d=32, ksub=32)
    exact = _port(c, 20, DistanceMetric.L2, cpu_mesh(8), exact_lut=True)
    got = _port(c, 20, DistanceMetric.L2, cpu_mesh(8), int8_lut=True)
    overlap = np.mean([len(set(exact[1][r]) & set(got[1][r])) / 20 for r in range(5)])
    assert overlap >= 0.85, overlap
    want = _jax(c, 20, DistanceMetric.L2, 8, int8_lut=True, backend="pallas", interpret=True)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=ULP4)


def test_packed4_matches_unsharded_and_jax(rng):
    """Nibble-packed codes shard row-wise like byte codes: the 8-way
    answer is the single-device index's and the JAX package's."""
    c = _case(rng, n=1024, d=32, m=8)
    packed = pack_codes4(c["codes"])
    idx = PQIndex.build(c["data"], DistanceMetric.L2, codebooks=c["books"], codes=packed,
                        recon_norms=c["rnorms"], keep_vectors=False, device="cpu")
    assert idx.packed4
    single = idx.search(c["q"], k=7, exact_lut=False)
    s, i = sharded_pq_topk(torch.from_numpy(c["q"]), packed, torch.from_numpy(c["books"]),
                           c["rnorms"], c["n"], 7, DistanceMetric.L2, cpu_mesh(8),
                           packed4=True)
    np.testing.assert_array_equal(i.numpy(), single.indices)
    np.testing.assert_array_equal(s.numpy(), single.scores)
    want = _jax(c, 7, DistanceMetric.L2, 8, codes=packed, packed4=True, interpret=True,
                block_rows=128)
    np.testing.assert_array_equal(i.numpy(), want[1])


def test_rerank_needs_the_rows_and_padding_shards(rng):
    """rerank without db raises, and so does a LUT built for other
    queries; a corpus smaller than the mesh leaves shards of padding only,
    which give unfilled slots, and k passes the corpus."""
    c = _case(rng, n=20)
    with pytest.raises(ValueError, match="rerank"):
        _port(c, 5, DistanceMetric.L2, cpu_mesh(8), rerank=10)
    q, books = torch.from_numpy(c["q"]), torch.from_numpy(c["books"])
    with pytest.raises(ValueError, match="lut holds"):
        fused_adc_topk(q, torch.from_numpy(c["codes"]), books,
                       torch.from_numpy(c["rnorms"]), 20, 5, DistanceMetric.L2,
                       exact_lut=True, lut=adc_tables(q[:2], books, True, False))
    s, i = _port(c, 30, DistanceMetric.L2, cpu_mesh(8), exact_lut=True,
                 db=c["data"], db_norms=c["dnorms"], rerank=30)
    _, oi = numpy_oracle(c["q"], c["data"], 20, DistanceMetric.L2)
    np.testing.assert_array_equal(i[:, :20], oi)
    assert i.shape[1] == 30 and (i[:, 20:] == -1).all()  # 8 rows a shard, 3 shards hold rows
