// K2: matmul against nibble-packed int4 weights, scale in the epilogue.
//
// Replaces the TPU kernel src/repro/kernels/int4_matmul.py `int4_matmul`
// (pl.pallas_call at line 65, bodies `_int4_matmul_kernel`/`_unpack_block`).
//
//   out[m][n] = (sum_k x[m][k] * unpack(packed)[k][n]) * scale[n]
//
// Shapes: x (M, K) float32, packed (K/2, N) int8 (low nibble = even row),
// scale (N,) float32; out (M, N) float32.  Total over float32 x, as the
// TPU kernel: on the served path x holds 8-bit integer inputs (L0, K = 40)
// or spikes (L1, M = TS*B, K = 128), which the int8 tensor cores take
// exactly; every sum is then an integer below 2^24, exact in float32 in
// any order, and the single multiply by the scale rounds once: bit-equal
// to the plain version.  A block whose tile holds any other value (not an
// integer, or outside [-128, 127], or NaN) computes its outputs as one
// fmaf chain each, k ascending, within float32 rounding of it.
//
// Bound on the H100: the operands are 8-bit integers or spikes times int4
// weights, exact on the int8 tensor cores (1,979 TOP/s), so bytes bound
// both calls at B = 256: 0.175 MB for L0 (0.052 us) and 0.533 MB for L1
// (0.159 us).  A call this small is held by latency: the launch, one
// round of loads from L2, and the stores.
//
// Design (common.cuh int4_tile_kernel, shared with K3 at ts = 1): the
// wrapper's tile plan (kernels/int4_matmul.py tile_plan) gives 16-64 rows
// by 8-128 columns a block, at least 132 blocks at the served shapes
// (16 x 8 for L0: 256 blocks; 16 x 16 for L1: 256).  A block issues its
// whole packed column tile and its rows of x with cp.async, so every load
// is in flight at once; it unpacks the nibbles once into int8 in shared
// memory (k-contiguous per column, padded against bank conflicts) while
// the rows land, converts the rows to int8, and votes (__syncthreads_and)
// that every value is an integer in [-128, 127].  Each warp then owns a
// 16 x 8 or 16 x 16 output tile and runs mma.sync m16n8k32 s8 x s8 ->
// s32 over K padded with zeros to a multiple of 32; its four lanes of a
// fragment row store 32 contiguous bytes.  The int4 weights never exist in
// memory at float precision.
#include "common.cuh"

extern "C" int int4_matmul_launch(const void* x, const void* packed,
                                  const void* scale, void* out, int m, int k,
                                  int n, int rows, int cols, void* stream) {
  return reprotorch::launch_int4_tiles(x, packed, scale, out, 1, m, k, n,
                                       rows, cols, stream);
}
