"""Product quantization (PQ) with exact re-rank on one ``torch.device``.

The counterpart of :mod:`metrovector_tpu.index.pq`:

* **Training** splits the dimensions into ``m`` subspaces and runs k-means
  (:func:`.ivf.train_kmeans`) in each, giving codebooks ``[m, ksub, dsub]``.
* **Encoding** assigns each subvector its nearest centroid
  (``argmax 2x·c − ‖c‖²``), giving uint8 codes ``[N, m]``, or nibble-packed
  ``[N, ⌈m/2⌉]`` for ``ksub ≤ 16``.
* **Search** is the ADC scan with a fused top-k,
  :func:`~..ops.adc_kernel.fused_adc_topk` (a shared-memory LUT gather on
  the card, where the TPU used one-hot matmuls), then with ``rerank=R`` an
  exact f32 rescore of the R candidates against the original rows,
  :func:`~..ops.gather_kernel.rescore_candidates`, ties to the candidate's
  position as ``lax.top_k`` breaks them in the reference.

Files round-trip through the shared format: ``Builder.set_pq_index`` writes
the sidecar and :meth:`PQIndex.from_space` opens it without retraining.
:meth:`PQIndex.add_rows` encodes appended rows with the trained codebooks
and publishes the grown planes as one snapshot. :meth:`PQIndex.autotune`
times the ADC kernel's launch grid and persists the winner in the file's
``adc`` hints, where :meth:`PQIndex.from_space` adopts it (the JAX
package's Mosaic tile in the same hints is not read).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..errors import DimensionMismatchError, IndexOutOfBoundsError
from ..format.constants import DistanceMetric
from ..utils.filters import checked_prepared_mask, padded_filter_plane

from ..engine import (
    PreparedFilter,
    SearchResult,
    grow_rows,
    ids_for_rows,
    merged_append_ids,
    pinned,
    publish,
    resolve_device,
)
from ..ops.adc_kernel import QUERY_TILES, fused_adc_topk, int8_lut_route
from ..ops.distances import distances_np, full_f32_matmul
from ..ops.gather_kernel import rescore_candidates
from ..ops.grid import check_grid
from ..utils.transfer import put_chunked
from ..utils.tune import tune_grid, tuned_grid
from .ivf import _to, train_kmeans

# ------------------------------------------------------------- training ---


def train_pq(
    data: np.ndarray,
    m: int = 16,
    ksub: int = 256,
    iters: int = 10,
    seed: int = 0,
    sample: int | None = 262_144,
    device="cuda",
) -> np.ndarray:
    """Train PQ codebooks on ``data`` ``[N, D]`` (host f32), one k-means
    per subspace on ``device``. ``D`` must be divisible by ``m``. Returns
    codebooks ``[m, ksub, dsub]`` f32."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, d = data.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by m={m} subspaces")
    dsub = d // m
    ksub = min(ksub, n)
    books = np.empty((m, ksub, dsub), np.float32)
    for j in range(m):
        sub = np.ascontiguousarray(data[:, j * dsub : (j + 1) * dsub])
        books[j], _ = train_kmeans(sub, ksub, iters=iters, seed=seed + j,
                                   sample=sample, device=device)
    return books


def _encode_blocked(data: torch.Tensor, books: torch.Tensor,
                    block_rows: int = 8192) -> torch.Tensor:
    """Nearest-centroid codes per subspace, ``[N, m]`` int64, blocked over
    rows; first maximum on ties."""
    m, ksub, dsub = books.shape
    b_norms = (books * books).sum(2)  # [m, ksub]
    out = []
    for start in range(0, data.shape[0], block_rows):
        blk = data[start : start + block_rows].reshape(-1, m, dsub)
        with full_f32_matmul():
            dots = torch.einsum("nmd,mkd->nmk", blk, books)
        out.append(torch.argmax(2.0 * dots - b_norms[None], dim=2))
    if not out:
        return torch.empty((0, m), dtype=torch.int64, device=data.device)
    return torch.cat(out)


def encode_pq(data: np.ndarray, codebooks: np.ndarray, device="cuda") -> np.ndarray:
    """Encode rows to PQ codes ``[N, m]`` uint8 (``ksub ≤ 256``) on
    ``device``."""
    dev = resolve_device(device)
    data = np.ascontiguousarray(data, dtype=np.float32)
    books = np.ascontiguousarray(codebooks, dtype=np.float32)
    if books.shape[1] > 256:
        raise ValueError("ksub > 256 does not fit uint8 codes")
    codes = _encode_blocked(torch.from_numpy(data).to(dev),
                            torch.from_numpy(books).to(dev))
    return codes.to(torch.uint8).cpu().numpy()


def pack_codes4(codes: np.ndarray) -> np.ndarray:
    """Nibble-pack 4-bit PQ codes ``[N, m]`` (values < 16) to
    ``[N, ⌈m/2⌉]`` uint8: even subspaces in low nibbles, odd in high; odd
    ``m`` pads a zero high nibble."""
    codes = np.asarray(codes, np.uint8)
    if codes.max(initial=0) > 15:
        raise ValueError("pack_codes4 requires 4-bit codes (ksub <= 16)")
    n, m = codes.shape
    if m % 2:
        codes = np.concatenate([codes, np.zeros((n, 1), np.uint8)], axis=1)
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def unpack_codes4(packed: np.ndarray, m: int) -> np.ndarray:
    """Inverse of :func:`pack_codes4`: ``[N, ⌈m/2⌉]`` → ``[N, m]``."""
    packed = np.asarray(packed, np.uint8)
    out = np.empty((packed.shape[0], 2 * packed.shape[1]), np.uint8)
    out[:, 0::2] = packed & 15
    out[:, 1::2] = packed >> 4
    return out[:, :m]


def reconstruct_pq(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """Decode codes back to approximate vectors ``[N, D]`` f32 (host)."""
    m, ksub, dsub = codebooks.shape
    codes = np.asarray(codes)
    out = np.empty((codes.shape[0], m * dsub), np.float32)
    for j in range(m):
        out[:, j * dsub : (j + 1) * dsub] = codebooks[j, codes[:, j]]
    return out


def _sq_norms64(x: np.ndarray) -> np.ndarray:
    x64 = np.asarray(x, np.float64)
    return np.einsum("ij,ij->i", x64, x64).astype(np.float32)


# -------------------------------------------------------------- the index ---


@dataclasses.dataclass
class PQIndex:
    """Product-quantized view of one space, resident on ``codes.device``.

    ``codebooks``: host ``[m, ksub, dsub]`` f32; ``codes``: uint8 ``[N, m]``,
    or nibble-packed ``[N, ⌈m/2⌉]`` when ``packed4``; ``recon_norms``:
    ``[N]`` f32 squared norms of the reconstructed rows; ``db``/``db_norms``:
    the original rows and their squared norms, for exact re-ranking;
    ``valid``: ``[N]`` f32, 0 for a tombstoned row. The device planes may
    hold more rows than ``num_vectors`` (the capacity of :meth:`add_rows`);
    the rows past it are never read. ``grid``: the ADC kernel's launch grid
    (:class:`~..ops.grid.Grid`), None for one wave.

    Mutations publish every changed field at once (:func:`~..engine.publish`)
    and a search reads one published state (:func:`~..engine.pinned`)."""

    codebooks: np.ndarray
    codes: torch.Tensor
    recon_norms: torch.Tensor
    metric: DistanceMetric
    dim: int
    num_vectors: int
    db: torch.Tensor | None = None
    db_norms: torch.Tensor | None = None
    valid: torch.Tensor | None = None
    packed4: bool = False
    host_ids: np.ndarray | None = None
    grid: object = None

    def __post_init__(self):
        self.codebooks = np.array(self.codebooks, np.float32)
        self._books = torch.from_numpy(self.codebooks).to(self.device)
        self.grid = check_grid(self.grid, QUERY_TILES, "PQIndex")
        self._host_space = None  # the file-backed origin, for persist
        self._write_lock = threading.Lock()  # one writer at a time

    def _adopt(self, space) -> "PQIndex":
        """Remember the file-backed origin and adopt the grid that
        :meth:`autotune` persisted there, if any."""
        self._host_space = space
        self.grid = check_grid(tuned_grid(space, "adc"), QUERY_TILES, "PQIndex")
        return self

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @classmethod
    def build(
        cls,
        vectors: np.ndarray,
        metric: DistanceMetric,
        m: int = 16,
        ksub: int = 256,
        iters: int = 10,
        seed: int = 0,
        codebooks: np.ndarray | None = None,
        codes: np.ndarray | None = None,
        recon_norms: np.ndarray | None = None,
        keep_vectors: bool = True,
        valid_mask: np.ndarray | None = None,
        ids: np.ndarray | None = None,
        pack4: bool | None = None,
        device="cuda",
    ) -> "PQIndex":
        """Train (or take precomputed) codebooks, encode and upload to
        ``device``. With ``keep_vectors`` the original rows stay on the
        device for re-ranking. Precomputed codes with ``⌈m/2⌉`` columns are
        taken as packed; ``pack4`` packs freshly encoded ones
        (``ksub ≤ 16``). ``valid_mask``: True marks a tombstoned row."""
        dev = resolve_device(device)
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        n, d = vectors.shape
        if codebooks is None:
            codebooks = train_pq(vectors, m=m, ksub=ksub, iters=iters,
                                 seed=seed, device=dev)
        codebooks = np.ascontiguousarray(codebooks, dtype=np.float32)
        m_eff, ksub_eff, _ = codebooks.shape
        already_packed = False
        if codes is None:
            codes = encode_pq(vectors, codebooks, device=dev)
        else:
            codes = np.asarray(codes, np.uint8)
            already_packed = (
                codes.shape[1] == (m_eff + 1) // 2 and codes.shape[1] != m_eff
            )
        if pack4 is None:
            pack4 = already_packed
        if pack4 and ksub_eff > 16:
            raise ValueError(f"pack4 requires ksub <= 16, got {ksub_eff}")
        if recon_norms is None:
            recon_norms = _sq_norms64(reconstruct_pq(
                unpack_codes4(codes, m_eff) if already_packed else codes,
                codebooks,
            ))
        if pack4 and not already_packed:
            codes = pack_codes4(codes)
        db = db_norms = None
        if keep_vectors:
            db = put_chunked(vectors, dev)
            db_norms = _to(_sq_norms64(vectors), dev, np.float32)
        valid = None
        if valid_mask is not None:
            valid = _to(~np.asarray(valid_mask, dtype=bool), dev, np.float32)
        if ids is not None:
            ids = np.ascontiguousarray(ids, dtype=np.uint64).reshape(-1)
        return cls(
            codebooks=codebooks,
            codes=_to(codes, dev, np.uint8),
            recon_norms=_to(recon_norms, dev, np.float32),
            metric=DistanceMetric(metric),
            dim=d,
            num_vectors=n,
            db=db,
            db_norms=db_norms,
            valid=valid,
            packed4=bool(pack4),
            host_ids=ids,
        )

    @classmethod
    def from_space(
        cls,
        space,
        m: int = 16,
        ksub: int = 256,
        iters: int = 10,
        seed: int = 0,
        keep_vectors: bool = True,
        device="cuda",
    ) -> "PQIndex":
        """The search-ready index of a host
        :class:`~metrovector_tpu_torch.vectors.space.VectorSpace` on ``device``,
        reusing the codebooks and codes persisted in the file when present
        (no retraining, no re-encoding). Tombstoned rows are masked. The
        grid persisted by :meth:`autotune` is adopted."""
        dev = resolve_device(device)
        stored = space.pq_arrays()
        codebooks = codes = stored_rnorms = None
        if stored is not None and not space.info.pq.residual:
            # Residual sidecars encode x − centroid and belong to IVF-PQ;
            # plain PQ retrains on raw rows.
            codebooks, codes, stored_rnorms = stored
        if stored_rnorms is not None and not keep_vectors:
            # Code-only: everything lives in the sidecar; the dense rows
            # are never read.
            mask = space.tombstone_mask()
            return cls(
                codebooks=codebooks,
                codes=_to(codes, dev, np.uint8),
                recon_norms=_to(stored_rnorms, dev, np.float32),
                metric=DistanceMetric(space.metric),
                dim=space.dim,
                num_vectors=space.num_vectors,
                valid=None if mask is None else _to(~mask, dev, np.float32),
                host_ids=space.ids(),
                packed4=bool(space.info.pq.packed4),
            )._adopt(space)
        vectors = np.asarray(space.to_numpy(), dtype=np.float32)
        q = space.quantization
        if q is not None:
            vectors = (vectors - q.zero_point) * q.scale
        return cls.build(
            vectors, space.metric, m=m, ksub=ksub, iters=iters, seed=seed,
            codebooks=codebooks, codes=codes, recon_norms=stored_rnorms,
            keep_vectors=keep_vectors, valid_mask=space.tombstone_mask(),
            ids=space.ids(), device=dev,
        )._adopt(space)

    @classmethod
    def from_state(cls, state: dict, device="cuda") -> "PQIndex":
        """Build from the host arrays of a reference ``PQIndex`` —
        ``codebooks``, ``codes``, ``recon_norms`` and the optional ``db``,
        ``db_norms``, ``valid`` (1 = live) and ``host_ids`` — and its
        scalars ``metric``, ``dim``, ``num_vectors`` and ``packed4``."""
        dev = resolve_device(device)

        def opt(name, dtype):
            v = state.get(name)
            return None if v is None else _to(v, dev, dtype)

        return cls(
            codebooks=np.asarray(state["codebooks"], np.float32),
            codes=_to(state["codes"], dev, np.uint8),
            recon_norms=_to(state["recon_norms"], dev, np.float32),
            metric=DistanceMetric(int(state["metric"])),
            dim=int(state["dim"]),
            num_vectors=int(state["num_vectors"]),
            db=opt("db", np.float32),
            db_norms=opt("db_norms", np.float32),
            valid=opt("valid", np.float32),
            packed4=bool(state.get("packed4", False)),
            host_ids=state.get("host_ids"),
        )

    @property
    def m(self) -> int:
        return int(self.codebooks.shape[0])

    @property
    def ksub(self) -> int:
        return int(self.codebooks.shape[1])

    @property
    def code_bytes_per_vector(self) -> int:
        return (self.m + 1) // 2 if self.packed4 else self.m

    # -- online mutation ------------------------------------------------------

    def add_rows(self, vectors, ids=None, reserve: float = 1.5) -> None:
        """Encode new rows with the existing codebooks (no retraining) on
        the device and append them, the reference's
        ``PQIndex.add_rows``: appends carry ``ids`` iff the index has an ID
        column, and the planes grow in capacity steps of 128 rows (to
        ``max(⌈total⌉, ⌈capacity·reserve⌉)``). Within capacity the rows
        are copied into the live planes past ``num_vectors``; beyond, new
        planes are filled by a copy on the device (:func:`~..engine.
        grow_rows`), all on the current stream. The grown planes, the ID
        column and the row count are published together."""
        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        if vectors.ndim == 1:
            vectors = vectors[None]
        if vectors.shape[1] != self.dim:
            raise DimensionMismatchError(expected=self.dim,
                                         actual=int(vectors.shape[1]))
        with self._write_lock:
            nv, n_new = self.num_vectors, int(vectors.shape[0])
            merged_ids = merged_append_ids(self.host_ids, ids, n_new, nv)
            if n_new == 0:
                return
            dev = self.device
            codes_new = encode_pq(vectors, self.codebooks, device=dev)
            rn_new = _sq_norms64(reconstruct_pq(codes_new, self.codebooks))
            if self.packed4:
                codes_new = pack_codes4(codes_new)
            total = nv + n_new
            cap = int(self.codes.shape[0])
            if total > cap:
                cap = max(-(-total // 128) * 128, -(-int(cap * reserve) // 128) * 128)
            changes = dict(
                codes=grow_rows(self.codes, nv, _to(codes_new, dev, np.uint8), cap),
                recon_norms=grow_rows(self.recon_norms, nv,
                                      _to(rn_new, dev, np.float32), cap),
                num_vectors=total,
            )
            if self.db is not None:
                changes["db"] = grow_rows(self.db, nv, _to(vectors, dev, np.float32), cap)
                changes["db_norms"] = grow_rows(
                    self.db_norms, nv, _to(_sq_norms64(vectors), dev, np.float32), cap)
            if self.valid is not None:
                changes["valid"] = grow_rows(
                    self.valid, nv, torch.ones(n_new, dtype=torch.float32, device=dev),
                    cap, fill=1.0)
            if merged_ids is not None:
                changes["host_ids"] = merged_ids
            publish(self, **changes)

    def autotune(self, queries=None, k: int = 10, batch: int = 128,
                 waves_candidates=None, tile_candidates=None, iters: int = 3,
                 apply: bool = True, persist: bool = False,
                 **search_kw) -> list[dict]:
        """Time the ADC kernel's launch grid with single-launch timings
        (one :meth:`search` and its readback a measurement) and, with
        ``apply``, set the fastest as :attr:`grid`. ``**search_kw`` reach
        :meth:`search` (``rerank=``, ``exact_lut=``, ``int8_lut=``), so the
        route timed is the one served: the lookup scan (f32 or bf16 LUT, or
        an int8 LUT at ksub > 16) or the int8 LUT's tensor-core product.

        Candidates: ``waves_candidates`` (default
        :data:`~..ops.grid.WAVES`) times ``tile_candidates`` (default: None,
        the kernel's own pick, and each of the lookup scan's
        :data:`~..ops.adc_kernel.QUERY_TILES`; the product has one tile, so
        None alone). A tile above the batch is reported ``skipped``; one
        that does not fit shared memory fails with ``inf`` and its
        ``error``. The report, fastest first, and ``persist`` (into
        ``hints["tuned"][space]["adc"]["cuda"]``, for an index built by
        :meth:`from_space` on a file-backed space) follow
        :meth:`~..engine.SearchEngine.autotune`; on the CPU it raises
        ``ValueError``."""
        if tile_candidates is None:
            mma = search_kw.get("int8_lut") and int8_lut_route(
                self.ksub, self.m, self.code_bytes_per_vector) == "mma"
            tile_candidates = (None,) if mma else (None,) + QUERY_TILES

        def run_with(q, grid):
            return lambda: self.search(q, k=k, grid=grid, **search_kw)

        return tune_grid(self, "adc", run_with, queries=queries, batch=batch, dim=self.dim,
                         waves=waves_candidates, tiles=tile_candidates, iters=iters,
                         apply=apply, persist=persist)

    def delete_rows(self, rows) -> None:
        """Tombstone rows by position; they never surface in results
        afterwards. Publishes a new plane."""
        with self._write_lock:
            idx = [int(r) for r in np.atleast_1d(rows)]
            for r in idx:
                if r < 0 or r >= self.num_vectors:
                    raise IndexOutOfBoundsError(r, self.num_vectors)
            valid = (self.valid.clone() if self.valid is not None
                     else torch.ones(self.codes.shape[0], dtype=torch.float32,
                                     device=self.device))
            valid[torch.as_tensor(idx, dtype=torch.int64, device=self.device)] = 0.0
            publish(self, valid=valid)

    def recommended_rerank(self, k: int = 10, recall_target: float = 1.0) -> int:
        """Rerank depth expected to reach ``recall_target`` at this ``k``:
        the reference's rule (``rerank = 40·k`` reached recall 1.000 on the
        8-bit m=16/ksub=256 and 4-bit m=32/ksub=16 configs of a 1M × 128
        clustered corpus in its measurements); 0 when the ADC scan alone is
        expected to meet the target."""
        if not 0.0 < recall_target <= 1.0:
            raise ValueError(
                f"recall_target must be in (0, 1], got {recall_target}"
            )
        raw = 0.63 if self.packed4 else 0.72
        if recall_target <= raw:
            return 0
        if recall_target >= 0.99:
            factor = 40
        elif recall_target >= 0.9:
            factor = 20
        else:
            factor = 12 if self.packed4 else 10
        return factor * k

    def prepare_filter(self, filter_mask) -> PreparedFilter:
        """Upload a ``[num_vectors]`` boolean/int row predicate once for
        many :meth:`search` calls; composed with the tombstones at launch."""
        ix = pinned(self)
        full = padded_filter_plane(filter_mask, ix.num_vectors,
                                   ix.codes.shape[0])
        return PreparedFilter(mask=torch.from_numpy(full).to(ix.device),
                              num_valid=ix.num_vectors)

    def _effective_mask(self, filter_mask):
        """The user predicate (raw or prepared) times the tombstone plane."""
        if filter_mask is None:
            return self.valid
        if isinstance(filter_mask, PreparedFilter):
            fdev = checked_prepared_mask(filter_mask, self.num_vectors,
                                         self.codes.shape[0])
        else:
            fdev = self.prepare_filter(filter_mask).mask
        return fdev if self.valid is None else self.valid * fdev

    # -- search ---------------------------------------------------------------

    def search(
        self,
        queries: np.ndarray,
        k: int = 10,
        rerank: int = 0,
        exact_lut: bool = True,
        block_rows: int | None = None,
        backend: str = "auto",
        int8_lut: bool = False,
        filter_mask=None,
        grid=None,
    ) -> SearchResult:
        """Approximate top-k by ADC over the codes; ``rerank=R`` (R ≥ k)
        rescores the top-R ADC candidates exactly against the original
        rows (requires ``keep_vectors``). ``exact_lut``: f32 LUT, else
        bf16; ``int8_lut``: the f32 LUT quantized per query to int8 (it
        overrides ``exact_lut``, as in the reference). ``filter_mask``: ``[num_vectors]`` predicate or a
        :meth:`prepare_filter` result, applied inside the scan together
        with the tombstones. ``backend`` takes only ``"auto"`` (the device
        decides); ``block_rows`` is accepted and ignored. ``grid``: the ADC
        kernel's launch grid for this search; by default :attr:`grid`, whose
        tile is a cap: a smaller tile runs where it does not fit this
        search's fetch and LUT (:mod:`~..ops.grid`).

        On a CUDA device each search is one launch of the ADC kernel and,
        with ``rerank``, one of the rescore kernel, at any fetch up to the
        whole corpus: the reference's route, with its ties by candidate
        position, even for a re-rank of every row."""
        ix = pinned(self)  # one published state for the whole search
        if backend != "auto":
            raise ValueError(
                f"backend={backend!r}: the port has one backend, 'auto' "
                "(the tensors' device decides)"
            )
        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.shape[1] != ix.dim:
            raise DimensionMismatchError(expected=ix.dim, actual=int(q.shape[1]))
        if rerank and ix.db is None:
            raise ValueError(
                "rerank requires the original vectors (build with "
                "keep_vectors=True)"
            )
        qnorms = np.einsum("ij,ij->i", q, q, dtype=np.float64).astype(np.float32)
        qdev = torch.from_numpy(q).to(ix.device)
        eff_valid = ix._effective_mask(filter_mask)
        fetch = max(k, rerank) if rerank else k
        fetch = min(fetch, ix.num_vectors) or 1
        qk = qdev
        if ix.metric == DistanceMetric.COSINE:
            qk = qdev * (1.0 / torch.sqrt(torch.clamp(
                (qdev * qdev).sum(1, keepdim=True), min=1e-30)))
        nv = ix.num_vectors  # the scan reads the logical rows, not the capacity
        if grid is None and ix.grid is not None:
            grid = ix.grid._replace(cap=True)
        s, i = fused_adc_topk(
            qk, ix.codes[:nv], ix._books, ix.recon_norms[:nv],
            nv, fetch, ix.metric,
            valid_mask=None if eff_valid is None else eff_valid[:nv],
            exact_lut=exact_lut and not int8_lut, packed4=ix.packed4,
            int8_lut=int8_lut, grid=grid,
        )
        if rerank:
            s, i = rescore_candidates(qdev, ix.db, ix.db_norms, i,
                                      min(k, fetch), ix.metric,
                                      tie="position")
        else:
            s, i = s[:, :k], i[:, :k]
        s, i = s.cpu().numpy(), i.cpu().numpy()
        dist = distances_np(s, ix.metric, qnorms)
        bad_fill = np.inf if ix.metric == DistanceMetric.L2 else -np.inf
        dist = np.where(i >= 0, dist, bad_fill)
        if s.shape[1] < k:
            pad = ((0, 0), (0, k - s.shape[1]))
            i = np.pad(i, pad, constant_values=-1)
            s = np.pad(s, pad, constant_values=-np.inf)
            dist = np.pad(dist, pad, constant_values=bad_fill)
        return SearchResult(indices=i, scores=s, distances=dist,
                            metric=ix.metric,
                            ids=ids_for_rows(ix.host_ids, i))
