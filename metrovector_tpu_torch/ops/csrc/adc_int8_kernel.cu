// K2's int8-LUT lookup instances: the scan of adc_scan.cuh with LutType
// kLutI8 (the biased entries added two queries an integer add, then
// f32(sum) * the query's scale), for the lookup route of
// ops/adc_kernel.py::int8_lut_route: ksub > 16, and nibble-packed or
// unpacked ksub <= 16 codes whose LUT is too large for the tensor-core
// product of adc_int8_mma_kernel.cu. A translation unit of their own, so
// that nvcc compiles them beside adc_kernel.cu's f32 and bf16 instances;
// adc_kernel.cu's entry points launch them.

#include "adc_scan.cuh"

// The int8-LUT scan kernel for query tile qt (nullptr for a tile not
// built), nibble-packed codes or not, lists in device memory or not.
const void* mvt_adc_pick_int8(int qt, int packed4, int global) {
  return pick_lt<int8_t>(qt, packed4, global);
}
