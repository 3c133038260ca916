// The ADC scan's C entry points (the kernel and its design: adc_scan.cuh).
// The IVF bucket-bias variant has its own: adc_bucket_kernel.cu. The
// int8-LUT lookup instances are compiled in adc_int8_kernel.cu; the int8
// LUT's tensor-core product (ksub <= 16) is adc_int8_mma_kernel.cu.

#include "adc_scan.cuh"

const void* mvt_adc_pick_int8(int qt, int packed4, int global);

namespace {

const void* pick(int qt, int packed4, int lut_dtype, int global) {
  if (lut_dtype == kLutF32) return pick_lt<float>(qt, packed4, global);
  if (lut_dtype == kLutBF16) return pick_lt<__nv_bfloat16>(qt, packed4, global);
  if (lut_dtype == kLutI8) return mvt_adc_pick_int8(qt, packed4, global);
  return nullptr;
}

size_t smem_for(int qt, int lut_dtype, int mk, int smem_k) {
  return scan_smem_bytes(
      qt, lut_dtype == kLutF32 ? 4 : (lut_dtype == kLutI8 ? sizeof(Lut8Smem) : 2), mk,
      smem_k);
}

cudaError_t prepare(const void* fn, size_t smem) {
  if (fn == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Launch the scan and the merge on `stream`; returns the cudaError_t of the
// launches (0 on success). `lut` is [nq, m*ksub] f32 (lut_dtype 0), bf16
// (1) or int8 (2, with its per-query scale `lut_scale` [nq] f32, else
// null); `codes` [n, cols] u8; `mask` may be null. With list_len 0 the lists
// stay in shared memory (k <= 1024) and part_* is [nq, splits, k];
// otherwise each split's list has list_len entries in part_*. With `tree`
// (always for lists in device memory) part_* and tmp_* are as large as
// every level of the merge tree needs (ops/select.py::merge_scratch) and
// the tree folds the lists; else merge_kernel does and tmp_* is unused.
// slots is [nq, splits] zeros (the group bars, select.cuh). out_* are
// [nq, k].
int mvt_adc_topk(const void* lut, int lut_dtype, const float* lut_scale,
                 const uint8_t* codes,
                 int cols, int packed4, const float* norms, const float* mask,
                 int64_t nq, int64_t n, int m, int ksub, int64_t num_valid,
                 int k, int metric, int qt, int splits, int64_t rows_per_split,
                 int list_len, int tree, float* part_s, int* part_i,
                 unsigned long long* slots, float* tmp_s, int* tmp_i,
                 float* out_s, int* out_i, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int lists_global = list_len > 0;
  const void* fn = pick(qt, packed4, lut_dtype, lists_global);
  int kl = lists_global ? list_len : k;
  const size_t smem = smem_for(qt, lut_dtype, m * ksub, lists_global ? 0 : k);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  const uintptr_t at = reinterpret_cast<uintptr_t>(codes);
  int vec = cols % 16 == 0 && at % 16 == 0 ? 16 : (cols % 4 == 0 && at % 4 == 0 ? 4 : 0);
  void* args[] = {&lut,       &lut_scale, &codes, &cols, &norms,  &mask, &nq,
                  &n,         &m,     &ksub,   &num_valid,      &kl,   &metric,
                  &rows_per_split, &vec, &k, &part_s, &part_i, &slots};
  const dim3 grid(static_cast<unsigned>((nq + qt - 1) / qt),
                  static_cast<unsigned>(splits));
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return merge_splits(part_s, part_i, tmp_s, tmp_i, nq, splits, kl, k,
                      lists_global || tree, out_s, out_i, st);
}

// Scan blocks that fit on one SM at once for this variant with lists of
// smem_k entries in shared memory (0: in device memory), written to
// *blocks_per_sm; returns the cudaError_t.
int mvt_adc_topk_occupancy(int lut_dtype, int packed4, int qt, int m,
                           int ksub, int smem_k, int* blocks_per_sm) {
  const void* fn = pick(qt, packed4, lut_dtype, smem_k == 0);
  const size_t smem = smem_for(qt, lut_dtype, m * ksub, smem_k);
  const cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                       kThreads, smem);
}

}  // extern "C"
