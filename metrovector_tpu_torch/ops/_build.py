"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface, so they compile in
seconds without PyTorch's headers. Each ``.cu`` compiles in its own
``nvcc`` process, all started together, and one link makes the shared
library. It goes to
``build/metrovector_tpu_torch/<hash>/`` under the repository root, where
``<hash>`` covers the sources and the flags: an edit rebuilds, an unchanged
tree reuses the library. The build runs at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "metrovector_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
LIB_NAME = "libmvt_kernels.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin; the port's "
        "CUDA kernels are built from source at first use"
    )


def build_dir() -> Path:
    """The directory the current sources and flags build into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, jobs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        objs.append(str(obj))
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{out[-4000:]}")
    if not failed:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"link failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, out_dir / LIB_NAME)  # atomic: a reader never sees half


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if the sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = build_dir()
            if not (out_dir / LIB_NAME).exists():
                _compile(out_dir)
            lib = ctypes.CDLL(str(out_dir / LIB_NAME))
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            f32 = ctypes.c_float
            seed = [p, p, i32, i32, i32, i32]
            lib.mvt_fused_topk.argtypes = [
                p, p, i32, f32, f32,      # q, db, db_dtype, affine off, scale
                p, p,                     # norms, mask
                i64, i64, i64, i64,       # nq, n, d, num_valid
                i32, i32, i32,            # k, metric, tile
                i32, i64, i32, i32,       # splits, rows_per_split, list_len, tree
                p, p, p,                  # part_s/i, slots
                p, p, p, p,               # tmp_s/i, out_s/i
                *seed,                    # seed_s/i, kseed, mul, lists, excl
                p,                        # stream
            ]
            lib.mvt_fused_topk.restype = i32
            lib.mvt_fused_topk_occupancy.argtypes = [i32, i32, i32, i32, p]
            lib.mvt_fused_topk_occupancy.restype = i32
            lib.mvt_fused_topk_high.argtypes = [
                p, p, p, i64, p, p,       # q, qsplit, db, ldb, norms, mask
                i64, i64, i64, i64,       # nq, n, d, num_valid
                i32, i32,                 # k, metric
                i32, i32, i32,            # nw, stages, big
                i32, i64, i32, i32,       # splits, rows_per_split, list_len, tree
                p, p, p,                  # part_s/i, slots
                p, p, p, p,               # tmp_s/i, out_s/i
                *seed,                    # seed_s/i, kseed, mul, lists, excl
                p,                        # stream
            ]
            lib.mvt_fused_topk_high.restype = i32
            # nw, stages, k_smem, big, out
            lib.mvt_fused_topk_high_occupancy.argtypes = [i32, i32, i32, i32, p]
            lib.mvt_fused_topk_high_occupancy.restype = i32
            lib.mvt_fused_topk_high_smem.argtypes = [i32, i32, i32]
            lib.mvt_fused_topk_high_smem.restype = ctypes.c_longlong
            lib.mvt_fused_topk_int.argtypes = [
                i32,                      # bf16 (else int8) operands
                p, i64, p, i64,           # q, qstride, db, ldb (in values)
                p, p, p,                  # norms, mask, bias
                f32, f32, i32,            # scale, bias_scale, defer
                i64, i64, i64, i64,       # nq, n, d, num_valid
                i32, i32,                 # k, metric
                i32, i32, i32, i32,       # nw, stages, resident, big
                i32, i64, i32, i32,       # splits, rows_per_split, list_len, tree
                p, p, p,                  # part_s/i, slots
                p, p, p, p,               # tmp_s/i, out_s/i
                *seed, i32,               # seed_s/i, kseed, mul, lists, excl; raw
                p,                        # stream
            ]
            lib.mvt_fused_topk_int.restype = i32
            # bf16, nw, chunks, stages, resident, k_smem, big, out
            lib.mvt_fused_topk_int_occupancy.argtypes = [i32, i32, i32, i32, i32,
                                                         i32, i32, p]
            lib.mvt_fused_topk_int_occupancy.restype = i32
            lib.mvt_fused_topk_int_smem.argtypes = [i32, i32, i32, i32, i32]
            lib.mvt_fused_topk_int_smem.restype = ctypes.c_longlong
            lib.mvt_adc_topk.argtypes = [
                p, i32, p,                # lut, lut_dtype, lut_scale
                p, i32, i32,              # codes, cols, packed4
                p, p,                     # norms, mask
                i64, i64, i32, i32, i64,  # nq, n, m, ksub, num_valid
                i32, i32, i32, i32, i64,  # k, metric, qt, splits, rows_per_split
                i32, i32,                 # list_len (0: lists in shared memory), tree
                p, p, p,                  # part_s/i, slots
                p, p, p, p,               # tmp_s/i, out_s/i
                p,                        # stream
            ]
            lib.mvt_adc_topk.restype = i32
            lib.mvt_adc_topk_occupancy.argtypes = [i32, i32, i32, i32, i32,
                                                   i32, p]
            lib.mvt_adc_topk_occupancy.restype = i32
            lib.mvt_adc_int8_mma.argtypes = [
                p, p, p, i32, i32,        # lut, lut_scale, codes, cols, packed4
                p, p,                     # norms, mask
                i64, i64, i32, i64,       # nq, n, m, num_valid
                i32, i32,                 # k, metric
                i32, i32, i32,            # nw, stages, big
                i32, i64, i32, i32,       # splits, rows_per_split, list_len, tree
                p, p, p,                  # part_s/i, slots
                p, p, p, p,               # tmp_s/i, out_s/i
                p,                        # stream
            ]
            lib.mvt_adc_int8_mma.restype = i32
            # nw, packed4, m, cols, stages, k_smem, big, out
            lib.mvt_adc_int8_mma_occupancy.argtypes = [i32, i32, i32, i32, i32, i32,
                                                       i32, p]
            lib.mvt_adc_int8_mma_occupancy.restype = i32
            # nw, m, cols, stages, k_smem
            lib.mvt_adc_int8_mma_smem.argtypes = [i32, i32, i32, i32, i32]
            lib.mvt_adc_int8_mma_smem.restype = ctypes.c_longlong
            lib.mvt_adc_bucket_topk.argtypes = [
                p, i32, p, i32, i32,      # lut, lut_dtype, codes, cols, packed4
                p, p, p, i64, p, i32,     # norms, ids, starts, stride, counts, nb
                p, p, i32,                # mask, bias, groups
                i64, i32, i32, i64,       # nq, m, ksub, num_valid
                i32, i32, i32, i32,       # k, metric, qt, splits
                i32, i32,                 # lists in device memory, tree
                p, p, p,                  # part_s/i, slots
                p, p, p, p,               # tmp_s/i, out_s/i
                p,                        # stream
            ]
            lib.mvt_adc_bucket_topk.restype = i32
            # lut_dtype, packed4, qt, m, ksub, smem_k, gw, ids, out
            lib.mvt_adc_bucket_occupancy.argtypes = [i32, i32, i32, i32, i32,
                                                     i32, i32, i32, p]
            lib.mvt_adc_bucket_occupancy.restype = i32
            lib.mvt_gather_rows.argtypes = [p, i64, i64, p, i32, i64, p, p]
            lib.mvt_gather_rows.restype = i32
            lib.mvt_rescore.argtypes = [
                p, p, i32, p, p,          # q, db, db_dtype, norms, cand
                i64, i64, i32, i32, i32,  # nq, n, d, r, k
                i32, i32,                 # metric, tie_rows
                i32, i32, i32, i32,       # splits, split_len, list_len, merge
                i32, i32, i64,            # sort_len, room, smem
                p, p, p, p, p,            # part_s/i, tmp_s/i, arrivals
                p, p, p,                  # out_s/i, stream
            ]
            lib.mvt_rescore.restype = i32
            lib.mvt_query_postings.argtypes = [
                p, i64, i64, i32,         # qt, dim, nq, qtile
                p, p, p, p,               # scratch, qptr, post, stream
            ]
            lib.mvt_query_postings.restype = i32
            lib.mvt_ell_dots.argtypes = [
                p, p, p, i64,             # qt, qptr, post, dim
                p, p, i64, i32, i64, i32,  # cols, vals, n, r, nq, qg
                p, i64, p,                # dots, ldo, stream
            ]
            lib.mvt_ell_dots.restype = i32
            lib.mvt_ell_topk.argtypes = [
                p, p, p, i64,             # qt, qptr, post, dim
                p, p, p, p, p,            # cols, vals, ovf_ptr/cols/vals
                p, p,                     # norms, mask
                i64, i64, i32, i64,       # nq, n, r, num_rows
                i32, i32, i32, i32,       # k, metric, qg, rows
                i32, i64, i32, i32,       # splits, rows_per_split, list_len, tree
                p, p, p, p, p,            # part_s/i, buf_s/i, kth_key
                p, p, p, p,               # tmp_s/i, out_s/i
                p,                        # stream
            ]
            lib.mvt_ell_topk.restype = i32
            lib.mvt_ell_topk_occupancy.argtypes = [i32, i32, i32, p]
            lib.mvt_ell_topk_occupancy.restype = i32
            lib.mvt_cuda_error_string.argtypes = [i32]
            lib.mvt_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def raise_for(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error (a launch that
    was refused never runs, and no later synchronize reports it)."""
    if err != 0:
        msg = lib.mvt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")
