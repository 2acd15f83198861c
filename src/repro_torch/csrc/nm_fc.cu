// K5: zero-skip FC readout over the group-packed N:M layout (merged-spike
// input).
//
// Replaces the TPU kernel src/repro/kernels/nm_fc.py `nm_fc`
// (pl.pallas_call at line 77, body `_nm_fc_kernel`).
//
//   merged    = sum_t spikes[t]                                     (B, H)
//   row(e, c) = (e / nm_n) * nm_m + ((packed[e][c] >> 4) & 0xF)
//   out[b][c] = (sum_e merged[b][row(e, c)] * nibble(packed[e][c])) * scale[c]
//
// Shapes: spikes (TS, B, H) float32, packed (E, N) int8 (value in the low
// nibble, in-group row offset in the high nibble, E = ceil(K / m) * n),
// scale (N,) float32; out (B, N) float32.  Pad slots are (offset 0, value 0)
// and add nothing; a decoded row outside [0, H) adds nothing either, so the
// gather never leaves the row (the engine validates the rows when it loads
// an artifact).  Products are integers in [-16, 14] and sums stay below
// 2^24: bit-equal to the plain version, and to K4 over the same mask stored
// as padded CSC (both sum the same terms in ascending row order; the pad
// slots add exact zeros).
//
// Bound on the H100 at B = 256, TS = 2, H = 128, N = 1920, 2:4 (E = 64):
// bytes — 262,144 B of spikes, 122,880 B packed, 7,680 B scale and the
// 1,966,080 B of logits, 2.36 MB over 3.35 TB/s: 0.704 us.  Its 62.9 M
// integer multiply-adds are exact on the int8 tensor cores (1,979 TOP/s):
// 0.03 us.  Bytes bound it.
//
// Design: K4's (sparse_fc.cu), over one byte an entry.  A block owns 32 x
// kRt batch rows by `cols` output columns (the tile plan, chosen by the
// wrapper from (ts, B, H, E, N)).  It starts a cp.async copy of its
// columns' packed tile (E x cols bytes, 8 KB at E = 64, cols = 128) into
// opted-in shared memory and, while that is in flight, stages its rows'
// merged spikes transposed (common.cuh stage_merged_transposed).  One pass
// then decodes each byte into the (offset in m, value) pair that K4's loop
// reads: a thread keeps one column and every (kGatherThreads / cols)-th
// entry, and advances its entries' group by a counter, not a division; a
// row outside [0, H) becomes offset 0 with value 0.  The products are
// common.cuh's gather_tile, K4's warp loop: four columns a warp, lanes on
// rows, an entry's quad one shared broadcast, 32 adjacent words a gather.
// The launch refuses an N:M geometry it cannot take (kErrNmGeometry), a
// plan whose tiles do not fit 227 KB (kErrSharedMemory) or that it does
// not take (kErrTilePlan).  Rows and columns past the edge are masked.
#include "common.cuh"

namespace {

using reprotorch::kGatherThreads;

// Byte offsets of one block's tiles in its dynamic shared memory:
//   wp   int8  [entries][cols]   the packed tile as staged
//   idx  int   [entries][cols]   each entry's offset in m
//   val  float [entries][cols]   each entry's value
//   m    float [h][rows + 1]     the merged rows, transposed
// entries x cols is a multiple of 32 bytes, so every tile is 16-byte
// aligned.  The wrapper's tile_plans compute the same bytes.
struct NmTileLayout {
  size_t idx, val, m, bytes;
  __host__ __device__ NmTileLayout(int entries, int rows, int cols, int h) {
    const size_t tile = static_cast<size_t>(entries) * cols;
    idx = tile;
    val = idx + sizeof(int) * tile;
    m = val + sizeof(float) * tile;
    bytes = m + sizeof(float) * static_cast<size_t>(h) * (rows + 1);
  }
};

template <int kRt>
__global__ void nm_fc_kernel(const float* __restrict__ spikes,
                             const int8_t* __restrict__ packed,
                             const float* __restrict__ scale,
                             float* __restrict__ out, int ts, int b, int h,
                             int entries, int n, int cols, int nm_n,
                             int nm_m, bool w16, bool out16) {
  constexpr int kRowsB = 32 * kRt;
  constexpr int kLd = kRowsB + 1;
  extern __shared__ __align__(16) unsigned char sh[];
  const NmTileLayout lay(entries, kRowsB, cols, h);
  int8_t* wp = reinterpret_cast<int8_t*>(sh);
  int* idx_sh = reinterpret_cast<int*>(sh + lay.idx);
  float* val_sh = reinterpret_cast<float*>(sh + lay.val);
  float* m_sh = reinterpret_cast<float*>(sh + lay.m);
  const int c0 = blockIdx.x * cols;
  const int row0 = blockIdx.y * kRowsB;

  // the packed tile, 16 bytes a copy (columns past n zero-filled); byte
  // loads where n is not a multiple of 16
  if (w16) {
    const int chunks = cols >> 4;
    for (int i = threadIdx.x; i < entries * chunks; i += kGatherThreads) {
      const int e = i / chunks;
      const int c = c0 + 16 * (i - e * chunks);
      const bool in = c < n;
      reprotorch::cp_async16(
          wp + 16 * i, packed + (in ? static_cast<long long>(e) * n + c : 0),
          in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < entries * cols; i += kGatherThreads) {
      const int e = i / cols;
      const int c = c0 + (i - e * cols);
      wp[i] = c < n ? packed[static_cast<long long>(e) * n + c] : 0;
    }
  }
  reprotorch::stage_merged_transposed<kRowsB>(spikes, ts, b, h, row0, m_sh);
  reprotorch::cp_async_wait_all();
  __syncthreads();
  // decode: this thread's column c and entries e0, e0 + step, ...; the
  // group row (e / nm_n) * nm_m follows e by a counter
  const int step = kGatherThreads / cols;
  const int c = threadIdx.x % cols;
  int e = threadIdx.x / cols;
  int slot = e % nm_n;
  int group_row = e / nm_n * nm_m;
  for (; e < entries; e += step) {
    const int i = e * cols + c;
    const int byte = wp[i];
    const int row = group_row + ((byte >> 4) & 0xF);
    const bool in = row < h;
    idx_sh[i] = in ? row * kLd : 0;
    val_sh[i] = in ? reprotorch::nibble(byte) : 0.0f;
    for (slot += step; slot >= nm_n; slot -= nm_n) group_row += nm_m;
  }
  __syncthreads();
  reprotorch::gather_tile<kRt>(idx_sh, val_sh, m_sh, entries, cols, c0, row0,
                               b, n, scale, out, out16);
}

}  // namespace

extern "C" int nm_fc_launch(const void* spikes, const void* packed,
                            const void* scale, void* out, int ts, int b,
                            int h, int entries, int n, int nm_n, int nm_m,
                            int rows_b, int cols, void* stream) {
  if (nm_n < 1 || nm_n > nm_m || nm_m > 16 || entries % nm_n != 0) {
    return reprotorch::kErrNmGeometry;
  }
  if ((rows_b != 32 && rows_b != 64) || (cols != 32 && cols != 64 && cols != 128)) {
    return reprotorch::kErrTilePlan;
  }
  const NmTileLayout lay(entries, rows_b, cols, h);
  if (lay.bytes > reprotorch::kMaxOptInSharedBytes) {
    return reprotorch::kErrSharedMemory;
  }
  void (*kernel)(const float*, const int8_t*, const float*, float*, int, int,
                 int, int, int, int, int, int, bool, bool) =
      rows_b == 32 ? nm_fc_kernel<1> : nm_fc_kernel<2>;
  const int opt = reprotorch::opt_in_shared(kernel, lay.bytes);
  if (opt != 0) return opt;
  const bool w16 = n % 16 == 0 && reprotorch::aligned_to(packed, 16);
  const bool out16 = n % 4 == 0 && reprotorch::aligned_to(out, 16);
  const dim3 grid((n + cols - 1) / cols, (b + rows_b - 1) / rows_b);
  kernel<<<grid, kGatherThreads, lay.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spikes), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(out), ts, b, h,
      entries, n, cols, nm_n, nm_m, w16, out16);
  return static_cast<int>(cudaGetLastError());
}
