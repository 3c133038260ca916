// The IVF bucket-bias variant of the ADC scan (adc_scan.cuh with GROUP =
// true), in a translation unit of its own so that nvcc compiles it in
// parallel with the plain variant; adc_kernel.cu launches it.

#include "adc_scan.cuh"

extern "C" const void* mvt_adc_pick_group(int qt, int packed4, int lut_dtype,
                                          int global) {
  if (lut_dtype == kLutF32) return pick_lt<float, true>(qt, packed4, global);
  if (lut_dtype == kLutBF16) return pick_lt<__nv_bfloat16, true>(qt, packed4, global);
  return nullptr;
}
