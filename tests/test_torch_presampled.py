"""The port's two-phase ``fused_topk_presampled`` (its plain path on CPU
tensors) against the JAX package's ``fused_topk_presampled`` run in
interpret mode and against ``numpy_oracle``, on the same numpy inputs from a
seed: the reference's own five cases (``tests/test_topk_kernel.py``) and
int8 L2, ``precision="high"``, the ``N <= 4·stride`` short cut, a mask that
kills the whole subsample, and k above the subsample's live rows. Then the
seeded ``fused_topk_reference`` on its own: seed ∪ scan partitions the
rows, a scan row that ties a seeded score at a lower index wins, and the
seed arguments match the JAX ``fused_topk``'s."""

import numpy as np
import pytest
import torch

from metrovector_tpu import DistanceMetric
from metrovector_tpu.ops import numpy_oracle
from metrovector_tpu.ops.topk_kernel import fused_topk as jax_fused_topk
from metrovector_tpu.ops.topk_kernel import fused_topk_presampled as jax_presampled
from metrovector_tpu_torch.ops import (
    fused_topk,
    fused_topk_presampled,
    fused_topk_presampled_reference,
    fused_topk_reference,
)

from _torch_parity import METRICS, assert_topk_match, exact_scores, tolerance, unit_rows

L2, IP, COS = DistanceMetric.L2, DistanceMetric.INNER_PRODUCT, DistanceMetric.COSINE


def _normal(rng, n, d, nq):
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    return x, q


def _norms(x, scale=1.0):
    return ((np.asarray(x, np.float64) * scale) ** 2).sum(1).astype(np.float32)


def _case(name):
    """(queries, db, norms, num_valid, k, metric, kwargs, oracle inputs,
    integer data?) of one named case. kwargs go to both packages' calls;
    the oracle gets (queries, rows, valid_mask) in f32/f64 values."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("f32-"):  # test_presampled_matches_oracle_f32
        metric = DistanceMetric[name[4:]]
        x, q = _normal(rng, 1024, 64, 5)
        return q, x, _norms(x), 1024, 10, metric, {"stride": 16}, (q, x, None), False
    if name == "k140-ragged":  # test_presampled_k_exceeds_lanes_and_ragged
        x, q = _normal(rng, 900, 32, 3)
        return q, x, _norms(x), 900, 140, L2, {"stride": 32}, (q, x, None), False
    if name == "tombstones-duplicates":  # test_presampled_tombstones_and_duplicates
        base = rng.standard_normal((48, 16)).astype(np.float32)
        x = base[rng.integers(0, 48, 768)]
        q = rng.standard_normal((4, 16)).astype(np.float32)
        mask = np.ones(768, np.float32)
        mask[rng.choice(768, 60, replace=False)] = 0.0
        return (q, x, _norms(x), 768, 12, L2, {"stride": 16, "valid_mask": mask},
                (q, x, mask), False)
    if name == "int8-deferred":  # test_presampled_int8_deferred_scale
        codes = rng.integers(-128, 128, (640, 32)).astype(np.int8)
        q = rng.integers(-128, 128, (3, 32)).astype(np.int8)
        scale = 0.031
        deq = codes.astype(np.float32) * scale
        return (q, codes, _norms(deq), 640, 10, IP, {"stride": 16, "scale": scale * 0.02},
                (q.astype(np.float32) * 0.02, deq, None), False)
    if name == "int8-l2":
        codes = rng.integers(-128, 128, (640, 32)).astype(np.int8)
        q = rng.integers(-128, 128, (3, 32)).astype(np.int8)
        return (q, codes, _norms(codes), 640, 10, L2, {"stride": 16},
                (q.astype(np.float32), codes.astype(np.float32), None), True)
    if name == "high":
        x = rng.integers(0, 64, (1024, 64)).astype(np.float32)
        q = rng.integers(0, 64, (6, 64)).astype(np.float32)
        return (q, x, _norms(x), 1024, 20, IP, {"stride": 16, "precision": "high"},
                (q, x, None), True)
    if name == "short-cut":  # n <= 4·stride: one plain scan
        x, q = _normal(rng, 200, 32, 4)
        return q, x, _norms(x), 200, 7, L2, {"stride": 64}, (q, x, None), False
    if name == "mask-kills-subsample":  # the seed is empty: floor 0
        x = rng.integers(0, 32, (768, 32)).astype(np.float32)
        q = rng.integers(0, 32, (5, 32)).astype(np.float32)
        mask = np.ones(768, np.float32)
        mask[::16] = 0.0
        mask[rng.choice(768, 40, replace=False)] = 0.0
        return (q, x, _norms(x), 768, 15, L2, {"stride": 16, "valid_mask": mask},
                (q, x, mask), True)
    if name == "k-above-subsample":  # 11 subsampled rows, 9 live; k = 20
        x = rng.integers(0, 32, (700, 32)).astype(np.float32)
        q = rng.integers(0, 32, (3, 32)).astype(np.float32)
        live = (np.arange(700) < 555).astype(np.float32)  # off the stride
        return (q, x, _norms(x), 555, 20, IP, {"stride": 64}, (q, x, live), True)
    raise KeyError(name)


CASES = [f"f32-{m.name}" for m in METRICS] + [
    "k140-ragged", "tombstones-duplicates", "int8-deferred", "int8-l2", "high",
    "short-cut", "mask-kills-subsample", "k-above-subsample"]


def _jax(q, x, norms, num_valid, k, metric, kw, sub=None):
    return jax_presampled(q, x, norms, np.int32(num_valid), k, metric, interpret=True,
                          block_rows=128, sub=sub, **kw)


def _port(fn, q, x, norms, num_valid, k, metric, kw, sub=None):
    kw = dict(kw)
    if kw.get("valid_mask") is not None:
        kw["valid_mask"] = torch.from_numpy(kw["valid_mask"])
    if sub is not None:
        sub = tuple(torch.from_numpy(np.ascontiguousarray(s)) for s in sub)
    s, i = fn(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms),
              num_valid, k, metric, sub=sub, **kw)
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("name", CASES)
def test_presampled_matches_jax_and_oracle(name):
    q, x, norms, num_valid, k, metric, kw, (oq, ox, omask), integer = _case(name)
    if metric == COS:
        q = unit_rows(q)
        oq = q
    before = (fused_topk.launches, fused_topk.launches_int, fused_topk.launches_high,
              fused_topk.launches_presampled)
    got = _port(fused_topk_presampled, q, x, norms, num_valid, k, metric, kw)
    assert before == (fused_topk.launches, fused_topk.launches_int,
                      fused_topk.launches_high, fused_topk.launches_presampled)
    plain = _port(fused_topk_presampled_reference, q, x, norms, num_valid, k, metric, kw)
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_array_equal(got[1], plain[1])
    want = tuple(np.asarray(a) for a in _jax(q, x, norms, num_valid, k, metric, kw))
    np.testing.assert_array_equal(got[1], want[1])
    live = np.arange(x.shape[0]) < num_valid
    if omask is not None:
        live &= omask != 0
    _, oi = numpy_oracle(oq, ox, k, metric, valid_mask=live.astype(np.float32))
    oi = np.where(np.arange(k)[None, :] < live.sum(), oi, -1)
    np.testing.assert_array_equal(got[1], oi)
    assert_topk_match(got, want, exact=integer, tol=tolerance(oq, ox, metric),
                      scores64=exact_scores(oq, ox, metric, live))
    # the two-phase result is fused_topk's, bit for bit
    one = fused_topk(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms),
                     num_valid, k, metric,
                     None if kw.get("valid_mask") is None
                     else torch.from_numpy(kw["valid_mask"]),
                     kw.get("precision", "highest"), kw.get("scale", 1.0))
    np.testing.assert_array_equal(got[0], one[0].numpy())
    np.testing.assert_array_equal(got[1], one[1].numpy())


@pytest.mark.parametrize("stride", [8, 32])
def test_presampled_presliced_sub_matches(stride):
    """test_presampled_presliced_sub_matches: the pre-sliced ``sub=`` pair
    gives what the self-sliced subsample gives, in both packages."""
    rng = np.random.default_rng(8)
    x, q = _normal(rng, 512, 32, 2)
    norms = _norms(x)
    kw = {"stride": stride}
    sub = (x[::stride], norms[::stride])
    a = _port(fused_topk_presampled, q, x, norms, 512, 9, L2, kw)
    b = _port(fused_topk_presampled, q, x, norms, 512, 9, L2, kw, sub=sub)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    want = tuple(np.asarray(t) for t in _jax(q, x, norms, 512, 9, L2, kw, sub=sub))
    np.testing.assert_array_equal(b[1], want[1])
    with pytest.raises(ValueError, match="sub must hold"):
        _port(fused_topk_presampled, q, x, norms, 512, 9, L2, kw,
              sub=(x[: 512 // stride - 1], norms[: 512 // stride - 1]))


def _seed_of(q, x, norms, metric, stride, k, **kw):
    """The exact top-k of the rows r % stride == 0 (a seed), as row ids."""
    s, i = fused_topk_reference(q, x[::stride], norms[::stride], x[::stride].shape[0],
                                k, metric, raw_scores=True, **kw)
    return s, torch.where(i >= 0, i * stride, i)


@pytest.mark.parametrize("k", [1, 9, 64])
@pytest.mark.parametrize("stride", [3, 16])
@pytest.mark.parametrize("metric", METRICS)
def test_seed_and_scan_partition_the_rows(metric, stride, k):
    """The seeded plain version over the rows it does not exclude, merged
    with the seed of the rows it does, is the plain scan of every row."""
    rng = np.random.default_rng(stride * 7 + k)
    x = torch.from_numpy(rng.integers(0, 9, (300, 24)).astype(np.float32))
    q = torch.from_numpy(rng.integers(0, 9, (4, 24)).astype(np.float32))
    if metric == COS:
        q = q / q.norm(dim=1, keepdim=True)
    norms = (x.double() ** 2).sum(1).float()
    mask = torch.from_numpy((rng.random(300) > 0.2).astype(np.float32))
    seed_s, seed_i = _seed_of(q, x, norms, metric, stride, k, valid_mask=mask[::stride])
    got = fused_topk_reference(q, x, norms, 300, k, metric, mask, seed_s=seed_s,
                               seed_i=seed_i, exclude_stride=stride)
    want = fused_topk_reference(q, x, norms, 300, k, metric, mask)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_scan_row_tying_a_seeded_score_at_a_lower_index_wins():
    """Row 3 (scanned) duplicates row 8 (seeded, stride 4): they tie, and
    the lower row ranks first, as the kernels' rank key orders them."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 5, (40, 8)).astype(np.float32))
    q = torch.from_numpy(rng.integers(0, 5, (2, 8)).astype(np.float32))
    x[3] = x[8] = q[0] * 3  # the best row of query 0, twice
    norms = (x.double() ** 2).sum(1).float()
    seed_s, seed_i = _seed_of(q, x, norms, IP, 4, 5)
    assert int(seed_i[0, 0]) == 8
    s, i = fused_topk_reference(q, x, norms, 40, 5, IP, seed_s=seed_s, seed_i=seed_i,
                                exclude_stride=4)
    assert i[0, :2].tolist() == [3, 8] and float(s[0, 0]) == float(s[0, 1])
    want = fused_topk_reference(q, x, norms, 40, 5, IP)
    assert torch.equal(s, want[0]) and torch.equal(i, want[1])


@pytest.mark.parametrize("route", ["f32-l2", "int8-deferred", "int8-l2"])
def test_seed_arguments_match_jax(route):
    """fused_topk's seed_s / seed_i / exclude_stride / raw_scores against
    the JAX fused_topk's, the seed from each package's own raw phase 1."""
    rng = np.random.default_rng(len(route))
    n, d, k, stride = 520, 32, 12, 8
    if route == "f32-l2":
        x, q = _normal(rng, n, d, 3)
        metric, kw, norms = L2, {}, _norms(x)
    else:
        x = rng.integers(-128, 128, (n, d)).astype(np.int8)
        q = rng.integers(-128, 128, (3, d)).astype(np.int8)
        metric = IP if route == "int8-deferred" else L2
        kw = {"scale": 0.25} if route == "int8-deferred" else {}
        norms = _norms(x)
    jxs, jxi = jax_fused_topk(q, x[::stride], norms[::stride], np.int32(n // stride), k,
                              metric, interpret=True, raw_scores=True, **kw)
    jxi = np.where(np.asarray(jxi) >= 0, np.asarray(jxi) * stride, -1)
    ps, pi = fused_topk(torch.from_numpy(q), torch.from_numpy(x[::stride].copy()),
                        torch.from_numpy(norms[::stride].copy()), n // stride, k, metric,
                        raw_scores=True, **kw)
    np.testing.assert_array_equal(pi.numpy() * stride, jxi)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(jxs))
    want = jax_fused_topk(q, x, norms, np.int32(n - 3), k, metric, interpret=True,
                          seed_s=np.asarray(jxs), seed_i=jxi.astype(np.int32),
                          exclude_stride=stride, **kw)
    got = fused_topk(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(norms),
                     n - 3, k, metric, seed_s=ps, seed_i=pi * stride,
                     exclude_stride=stride, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if route != "f32-l2":  # integer dots: identical scores
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("k", [5, 40])
def test_seed_stride_counts_subsample_rows(k):
    """fused_topk(_seed_stride=s) takes the seed's ids as rows of
    db[::s], as fused_topk_presampled's phase 1 gives them; unfilled
    entries (k above the subsample's 25 live rows) stay -1."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.integers(0, 9, (200, 16)).astype(np.float32))
    q = torch.from_numpy(rng.integers(0, 9, (3, 16)).astype(np.float32))
    norms = (x.double() ** 2).sum(1).float()
    s, i = fused_topk_reference(q, x[::8], norms[::8], 25, k, L2, raw_scores=True)
    got = fused_topk(q, x, norms, 200, k, L2, seed_s=s, seed_i=i, exclude_stride=8,
                     _seed_stride=8)
    want = fused_topk(q, x, norms, 200, k, L2, seed_s=s,
                      seed_i=torch.where(i >= 0, i * 8, i), exclude_stride=8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plain = fused_topk_reference(q, x, norms, 200, k, L2)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


def test_seed_arguments_checked():
    x = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="come together"):
        fused_topk(torch.zeros((2, 4)), x, torch.zeros(10), 10, 3, L2,
                   seed_s=torch.zeros((2, 3)))
