#!/usr/bin/env python3
"""Where the time of K2's int8-LUT tensor-core scan goes, on one NVIDIA GPU.

    python3 tools/adc_int8_profile.py [--out FILE]

``tools/wgmma_scan_profile.py``'s harness (``profile``) with this file's
variants and points, for ``csrc/adc_int8_mma_kernel.cu``: it builds patched
copies of the port under ``build/wgmma_profile/`` (git-ignored), all in
parallel, and times each in a process of its own by device time per kernel
name (``torch.profiler``):

* ``as_is``: the scan as it is;
* ``counters``: ``clock64()`` counters in the consumer loop, read back
  through an extra ``extern "C"`` entry: per block, consumer warpgroup 0's
  lane 0 sums the cycles of each phase of a tile (the group bar's refresh;
  the wait for the stage; the one-hot and the MMA; the compare pass; the
  offers, flushes and their barriers, and of that the flushes), and its own
  passing scores;
* ``no_selection``: the compare pass runs, nothing is offered (the lists
  stay empty);
* ``no_epilogue``: no compare either (the TMA ring, the one-hot and the
  MMA alone);
* ``no_mma``: the one-hot is built and folded into the accumulators by an
  integer add, no wgmma, no epilogue;
* ``tma_only``: neither one-hot nor MMA (the TMA ring alone).

The points are ``sift1m-pq4``'s shape (1M random rows of 32 nibble-packed
codes, ksub = 16, L2, random norms) at k = 400 and batches 256 and 32, and
at k = 10, batch 256. The patches are text edits of this checkout's
sources: the script fails if a source no longer holds the text it edits.
The variants' answers are not checked (only ``as_is`` computes the
contract). The last line of the output is JSON.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from wgmma_scan_profile import profile  # noqa: E402

MMA = "adc_int8_mma_kernel.cu"
TILE_TOP = ("    const int s = t % stages;\n"
            "    mbar_wait(sm.full + s, static_cast<unsigned>((t / stages) & 1));\n")
LOOP = ("  int acc[RB][NW / 2];\n  for (int t = 0; t < tiles; ++t) {\n"
        "    const int t0 = row_begin + t * kTileRows;\n")
REFRESH = "      sel_refresh(S, warp, lane);\n    }\n"
PASS = (
    "    unsigned long long pass = 0;\n#pragma unroll\n    for (int b = 0; b < RB; ++b) {\n"
    "      float inv[2];\n")
PASS_END = "      pass |= bits << (b * (NW / 2));\n    }\n"
OFFERS = "    tile_epilogue<NW, RB>(S, pass, warp, lane, t0 + r_lo, bar_id, [&](int i) {\n"
TILE_END = ("      return __int_as_float(acc[i / (NW / 2)][i % (NW / 2)]);\n    });\n"
            "  }\n  sel_finish(S, tw, bar_id);")
MMAS = ("#pragma unroll\n        for (int kk = 0; kk < 4; ++kk) {\n"
        "          WgmmaS8RA<NW>::mma(acc[b], a0[kk], smem_desc(lb + 32 * kk, kChunk), (c | kk) != 0);\n"
        "        }\n#pragma unroll\n        for (int kk = 0; kk < 4; ++kk) {\n"
        "          WgmmaS8RA<NW>::mma(acc[b], a1[kk], smem_desc(lb + QB * kChunk + 32 * kk, kChunk),\n"
        "                             1);\n        }\n")
COUNTERS = [
    (MMA, "namespace {\n\nconstexpr int kChunk = 128;",
     "__device__ long long g_prof[1024][8];\nnamespace {\n\nconstexpr int kChunk = 128;"),
    (MMA, LOOP,
     "  int acc[RB][NW / 2];\n  long long P[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  const long long T0 = clock64();\n  for (int t = 0; t < tiles; ++t) {\n"
     "    const int t0 = row_begin + t * kTileRows;\n    long long ta = clock64();\n"),
    (MMA, REFRESH, REFRESH + "    P[1] += clock64() - ta;\n    ta = clock64();\n"),
    (MMA, TILE_TOP, TILE_TOP + "    P[2] += clock64() - ta;\n    ta = clock64();\n"),
    (MMA, PASS, "    P[3] += clock64() - ta;\n    ta = clock64();\n" + PASS),
    (MMA, OFFERS + TILE_END,
     "    P[4] += clock64() - ta;\n    ta = clock64();\n    P[6] += __popcll(pass);\n"
     "    {  // tile_epilogue, with the flushes timed apart\n"
     "      unsigned long long pp = pass;\n"
     "      auto score_of = [&](int i) { return __int_as_float(acc[i / (NW / 2)][i % (NW / 2)]); };\n"
     "      for (bool any = wg_any(bar_id, pp != 0); any;) {\n"
     "        if (pp != 0) pp &= ~offer_pass<NW, RB>(S, pp, lane, t0 + r_lo, score_of);\n"
     "        if (!wg_any(bar_id, pp != 0)) break;\n"
     "        const long long tf = clock64();\n"
     "        sel_flush_full(S, warp, lane);\n"
     "        sel_refresh(S, warp, lane);\n"
     "        wg_sync(bar_id);\n"
     "        pp = still_pass<NW, RB>(S, pp, lane, score_of);\n"
     "        P[7] += clock64() - tf;\n"
     "      }\n"
     "    }\n"
     "    P[5] += clock64() - ta;\n  }\n"
     "  P[0] = clock64() - T0;\n"
     "  if (tw == 0 && blockIdx.x * gridDim.y + blockIdx.y < 512) {\n"
     "    for (int i = 0; i < 8; ++i) g_prof[2 * (blockIdx.x * gridDim.y + blockIdx.y) + wg][i] = P[i];\n"
     "  }\n  sel_finish(S, tw, bar_id);"),
    (MMA, 'extern "C" {\n',
     'extern "C" {\nint mvt_scan_profile(long long* out) {\n'
     "  return cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n"),
]
COUNTER_FIELDS = ("cycles", "group bar", "stage wait", "one-hot + MMA", "compare pass",
                  "offers, flushes, barriers", "own passing scores",
                  "of it flushes and the bar read after them")
NO_SELECTION = [
    (MMA, OFFERS, "    if (pass == 0x12345ull && acc[0][0] == 7)\n" + OFFERS),
]
NO_EPILOGUE = [
    (MMA, re.compile(re.escape(PASS) + ".*?" + re.escape(PASS_END), re.S),
     "    const unsigned long long pass = acc[0][0] == 0x7fffff01;\n"),
]
NO_MMA = NO_EPILOGUE + [
    (MMA, MMAS,
     "#pragma unroll\n        for (int kk = 0; kk < 4; ++kk) {\n"
     "          acc[b][kk] += a0[kk][0] ^ a0[kk][1] ^ a0[kk][2] ^ a0[kk][3] ^ a1[kk][0]\n"
     "                        ^ a1[kk][1] ^ a1[kk][2] ^ a1[kk][3]\n"
     "                        ^ static_cast<int>(smem_desc(lb, kChunk));\n"
     "        }\n"),
]
TMA_ONLY = NO_EPILOGUE + [
    (MMA, "      for (int c = 0; c < nch; c += 2) {  // nch is even\n",
          "      for (int c = 0; c < 0; c += 2) {  // nch is even\n"),
]
VARIANTS = {"as_is": [], "counters": COUNTERS, "no_selection": NO_SELECTION,
            "no_epilogue": NO_EPILOGUE, "no_mma": NO_MMA, "tma_only": TMA_ONLY}

POINTS = r'''
from metrovector_tpu_torch.ops.adc_kernel import fused_adc_topk
n, m = 1_000_000, 32
books = torch.randn((m, 16, 4), generator=g, device=dev)
codes = torch.randint(0, 16, (n, m), generator=g, device=dev, dtype=torch.uint8)
packed = (codes[:, 0::2] | (codes[:, 1::2] << 4)).contiguous()
rn = torch.rand(n, generator=g, device=dev) * 100
for nq, k in ((256, 400), (32, 400), (256, 10)):
    qs = [torch.randn((nq, 128), generator=g, device=dev) for _ in range(4)]
    point(f"pq4 {nq} k={k}", lambda q: fused_adc_topk(q, packed, books, rn, n, k, M.L2, None,
                                                      False, True, int8_lut=True), qs)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    return profile(VARIANTS, POINTS, COUNTER_FIELDS, "adc_", args.out)


if __name__ == "__main__":
    sys.exit(main())
