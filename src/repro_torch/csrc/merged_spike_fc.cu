// K3: merged-spike FC readout with int4 weights (paper §II-D2).
//
// Replaces the TPU kernel src/repro/kernels/merged_spike_fc.py
// `merged_spike_fc` (pl.pallas_call at line 43, body `_merged_fc_kernel`).
//
//   out[b][n] = (sum_k (sum_t spikes[t][b][k]) * unpack(packed)[k][n]) * scale[n]
//
// Shapes: spikes (TS, B, H) float32 in {0, 1}, packed (H/2, N) int8, scale
// (N,) float32; out (B, N) float32.  Merged spikes lie in {0..TS}, so the
// int8 tensor cores take them exactly, the sums are exact integers and the
// result is bit-equal to the plain version.  Other float inputs are taken
// too: a block whose merged tile holds a value that is not an integer in
// [-128, 127] computes its outputs as one fmaf chain each, k ascending.
//
// Bound on the H100: at B = 256, H = 128, N = 1920 the call moves 2.36 MB
// (the 1.97 MB output dominates) and does 126 M operations on spikes in
// {0..TS} and int4 weights, exact on the int8 tensor cores (1,979 TOP/s):
// bytes bound it, at 0.70 us.
//
// Design (common.cuh int4_tile_kernel, shared with K2): the wrapper's tile
// plan (kernels/merged_spike_fc.py tile_plan) gives 16 rows by 128 columns
// a block at the served shape, 240 blocks.  A block issues its packed
// column tile (8 KB) and its rows' TS spike trains with cp.async, unpacks
// the nibbles once into int8 (k-contiguous per column, padded against
// bank conflicts) while the trains land, then merges the trains (t = 0,
// 1, ... as the reference's sum; no division per element) into int8 rows
// and votes that every merged value is an s8 integer.  One weight pass
// serves every time step.  Each warp owns a 16 x 16 output tile: four
// mma.sync m16n8k32 s8 x s8 -> s32 steps over H = 128, then one
// __fmul_rn by the scale per output; four lanes of a fragment row store 32
// contiguous bytes, so the 1.97 MB of logits go out in whole sectors.
#include "common.cuh"

extern "C" int merged_spike_fc_launch(const void* spikes, const void* packed,
                                      const void* scale, void* out, int ts,
                                      int b, int h, int n, int rows, int cols,
                                      void* stream) {
  return reprotorch::launch_int4_tiles(spikes, packed, scale, out, ts, b, h,
                                       n, rows, cols, stream);
}
