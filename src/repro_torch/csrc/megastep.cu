// K6 + K7: the whole RSNN frame step over an F-frame chunk in one launch.
//
// Replaces the TPU kernel src/repro/kernels/megastep.py `megastep`
// (pl.pallas_call at line 250, body `_megastep_kernel`): K6 is its
// spike=False mode, K7 its spike=True mode, one template on kSpike here,
// and each at both precisions of the layer weights (a template on kFloat):
// int4 (W = nibble(q) * scale, dequantized next to the MAC) or float32
// (W read as stored).  For each frame f:
//
//   L0:  ff0 = x[f] @ W0x;  rec0[t] = s0[t] @ W0h;  stim = ff0 + rec0[t]
//   L1:  ff1[t] = s0'[t] @ W1x;  rec1[t] = s1[t] @ W1h;  stim = ff1 + rec1
//        each layer's LIF chain  u = stim + (beta * u) * (1 - h),
//        h = (u >= vth), t = 0..TS-1 (K1's chain exactly)
//   FC:  logits[f] = (sum_k merged[k] * q_fc[k]) * scale_fc, merged =
//        sum_t s1'[t] (dense_int4, K3's order), or the padded-CSC gather
//        of merged (csc, K4's order), or the N:M group-packed gather (nm,
//        K5's order): integer sums, one scale at the end; or, with float
//        weights, sum_k merged[k] * w_fc[k] in float32, k ascending, no
//        scale (dense_float)
//   counters: spikes_l0/l1[f][t] = sum_k s'[t][k], union_l1[f] = the
//        columns where some s1'[t] spiked, input_one_bits[f] = sum_d
//        popc(int(|x|) & (2^input_bits - 1))
//
// The state (s0/s1 spike trains, u/h of each layer) stays on chip across
// the F frames and is written once at the end.  Shapes: x (F, B, D), s0/s1
// (TS, B, H), u0/h0/u1/h1 (B, H), beta/vth (H,), all float32; the four
// layer weights (K/2, H) int8 nibbles + (H,) float32 scales, or (K, H)
// float32 (precision float, whose only FC is dense_float: w_fc (H, N)
// float32); FC dense_int4
// packed (H/2, N) int8 + scale (N,), csc indices (nnz, N) int32 +
// values (nnz, N) float32 + scale (N,), or nm packed (E, N) int8 (value |
// offset << 4, nm_n entries of every nm_m rows) + scale (N,).  Outputs:
// s0/s1 (TS, B, H), u0/u1 (B, H), logits (F, B, N), spikes_l0/l1
// (F, TS, B), union_l1 and input_one_bits (F, B).
//
// K7 (kSpike) runs the three spike-consuming products (L0 recurrent, L1
// feed-forward, L1 recurrent) over lossless event lists of each spike row,
// built by compact_row into shared memory, and the dense FCs (dense_int4,
// dense_float) over the merged union's events (values in {0..TS},
// gathered, never assumed 1);
// only the W rows the events name are read.  The csc and nm FCs keep their
// own gather in both modes, as the reference does.  Both modes sum in
// ascending k and a skipped term is an exact zero (fmaf(0, w, a) == a, and
// no partial sum is -0), so K7 is bit-equal to K6 on the same inputs.
//
// Bound on the H100, at B = 256, F = 1, TS = 2, H = 128, N = 1920 (nnz 95):
// the call moves 5.35 MB with csc (the 1.97 MB logits and 1.46 MB of CSC
// index + value dominate; 4.01 MB with dense_int4 and 2:4 nm, whose FC
// operands are 0.13 MB): 1.60 us (1.20 us) at 3.35 TB/s.  Its float32
// products over dequantized weights (no tensor-core type holds them
// exactly) are 53 MFLOP: 0.79 us at 67 TFLOP/s; the FC's integer sums are
// exact on the int8 tensor cores.  Bytes bound it.
//
// Design: a grid over slot tiles of kRows slots (32 blocks at B = 256, on
// 132 SMs), kMegaThreads threads a block: thread n owns hidden column n
// (its u/h of both layers live in registers across the frames), and every
// thread takes FC columns in turn.  The packed layer weights (27,136 B at
// PRUNED) are staged into shared memory once per launch, beside the tile's
// spike trains (float32), merged spikes, input rows and, for K7, two sets
// of event lists.  That is 48,896 B (K6) and 81,792 B (K7) at PRUNED,
// over the 48 KB a block gets by default.  Float layer weights are not
// staged: at BASELINE they are 827,392 B, far over a block's shared
// memory; thread n reads W[k][n] from global memory through the read-only
// path (__ldg), neighbouring threads on neighbouring addresses, and the
// four matrices stay in the 50 MB L2 for all the blocks.  Those loads are
// the float mode's latency: K6's loops over k are unrolled so that later
// loads are in flight, and K7, whose addresses come from its event lists,
// issues kLoadBatch loads ahead of their multiply-adds (event_dot), which
// keeps the order of the sum and so K7 == K6.  K6 then needs 42,240 B and
// K7 107,904 B of shared memory at BASELINE (21,760 B and 54,656 B at
// PRUNED).  Over 48 KB the launch opts in to the larger
// dynamic shared memory (cudaFuncSetAttribute), up to the per-kernel limit
// kMaxMegastepSharedBytes in common.cuh.  __syncthreads() separates the
// layers: L1 reads every column of L0's new spikes for its slots.  The FC
// operands stream from global memory / L2 (122,880 B of packed bytes for
// dense or 2:4 nm, 1.46 MB CSC, 1.97 MB float32 at BASELINE: not staged).
// A simple design: making it fast is later work.
#include <type_traits>

#include "common.cuh"

namespace {

using reprotorch::kMaxTs;
using reprotorch::kMegaThreads;
using reprotorch::kRows;
using reprotorch::nibble;

constexpr int kFcDenseInt4 = 0;
constexpr int kFcCsc = 1;
constexpr int kFcNm = 2;
constexpr int kFcDenseFloat = 3;  // float32 w_fc (H, N); float precision only
constexpr int kPrecisionInt4 = 0;
constexpr int kPrecisionFloat = 1;
constexpr int kWarps = kMegaThreads / 32;

struct Operands {
  const float* x;
  const float* s0;
  const float* u0;
  const float* h0;
  const float* s1;
  const float* u1;
  const float* h1;
  const float* beta[2];
  const float* vth[2];
  // l0_wx, l0_wh, l1_wx, l1_wh: int4 (K/2, H) nibbles + (H,) scales, read
  // only at int4; or float32 (K, H), read only at float
  const int8_t* q[4];
  const float* scale[4];
  const float* w[4];
  int fc_mode;
  const void* fc_a;  // dense_int4: packed (H/2, N) int8; csc: indices;
                     // nm: packed (nnz, N) int8, value | offset << 4;
                     // dense_float: w_fc (H, N) float32
  const float* fc_values;  // csc values (nnz, N); unused otherwise
  const float* fc_scale;   // (N,); unused by dense_float
  float* s0_out;
  float* u0_out;
  float* s1_out;
  float* u1_out;
  float* logits;
  float* spikes_l0;
  float* spikes_l1;
  float* union_l1;
  float* one_bits;
  int frames, ts, b, d, h, fc, nnz, nm_n, nm_m, input_bits;
};

// Byte offsets of the shared-memory regions, for the host's size check
// and the kernel's pointers alike.  Floats first (4-byte aligned), the
// packed int4 weight bytes last (none with float weights: those are read
// from global memory).
struct Layout {
  size_t s0, s1, merged, x, ev_idx, ev_val, ev_cnt, wq, total;
};

__host__ __device__ inline Layout shared_layout(int ts, int d, int h,
                                                bool spike, bool packed) {
  const size_t train = static_cast<size_t>(ts) * kRows * h;  // one (TS, kRows, H)
  Layout l;
  size_t off = 0;
  l.s0 = off;
  off += train * sizeof(float);
  l.s1 = off;
  off += train * sizeof(float);
  l.merged = off;
  off += static_cast<size_t>(kRows) * h * sizeof(float);
  l.x = off;
  off += static_cast<size_t>(kRows) * d * sizeof(float);
  l.ev_idx = off;
  if (spike) off += 2 * train * sizeof(int);  // two list sets, lossless
  l.ev_val = off;
  if (spike) off += 2 * train * sizeof(float);
  l.ev_cnt = off;
  if (spike) off += 2 * static_cast<size_t>(ts) * kRows * sizeof(int);
  l.wq = off;
  if (packed) off += static_cast<size_t>(d / 2 + 3 * (h / 2)) * h;
  l.total = (off + 15) & ~static_cast<size_t>(15);
  return l;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One dequantized weight W[k][n] = nibble * scale: the plain version's
// unpack(q).float() * scale, rounded once.
__device__ __forceinline__ float weight(const int8_t* q, int k, int n, int h,
                                        float scale) {
  const int byte = q[(k >> 1) * h + n];
  return __fmul_rn(nibble((k & 1) ? (byte >> 4) : byte), scale);
}

// One layer's weights as thread n reads them: int4 nibbles staged in
// shared memory with the column's scale, or a float32 (K, H) row-major
// matrix in global memory, through the read-only path.
struct PackedLayer {
  const int8_t* q;
  float scale;
  __device__ __forceinline__ float at(int k, int n, int h) const {
    return weight(q, k, n, h, scale);
  }
};

struct FloatLayer {
  const float* w;
  __device__ __forceinline__ float at(int k, int n, int h) const {
    return __ldg(w + static_cast<long long>(k) * h + n);
  }
};

// acc[r][t] += sum_k s[t][r][k] * W[k][n], k ascending; s is a (TS, kRows,
// H) spike train in shared memory, W's packed column n in shared memory.
__device__ __forceinline__ void dense_product(const float* s, int ts, int h,
                                              PackedLayer l, int n,
                                              float (&acc)[kRows][kMaxTs]) {
  for (int p = 0; p < h / 2; ++p) {
    const int byte = l.q[p * h + n];
    const float w_lo = __fmul_rn(nibble(byte), l.scale);
    const float w_hi = __fmul_rn(nibble(byte >> 4), l.scale);
#pragma unroll
    for (int t = 0; t < kMaxTs; ++t) {
      if (t >= ts) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* row = s + (t * kRows + r) * h + 2 * p;
        acc[r][t] = fmaf(row[0], w_lo, acc[r][t]);
        acc[r][t] = fmaf(row[1], w_hi, acc[r][t]);
      }
    }
  }
}

// The same sum with float weights: W[k][n] from global memory, k ascending
// (unrolled, so that loads of later k are in flight during the
// multiply-adds of earlier ones).
__device__ __forceinline__ void dense_product(const float* s, int ts, int h,
                                              FloatLayer l, int n,
                                              float (&acc)[kRows][kMaxTs]) {
#pragma unroll 4
  for (int k = 0; k < h; ++k) {
    const float w = l.at(k, n, h);
#pragma unroll
    for (int t = 0; t < kMaxTs; ++t) {
      if (t >= ts) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc[r][t] = fmaf(s[(t * kRows + r) * h + k], w, acc[r][t]);
      }
    }
  }
}

// a + sum_e vx[e] * W[ix[e]][n] over c events, e ascending.  With float
// weights each term is a load from L2 at an address an event names:
// kLoadBatch of them are issued before their multiply-adds, which still
// run in e order, so the sum is the same float.
constexpr int kLoadBatch = 8;

__device__ __forceinline__ float event_dot(const int* ix, const float* vx,
                                           int c, PackedLayer l, int n, int h,
                                           float a) {
  for (int e = 0; e < c; ++e) a = fmaf(vx[e], l.at(ix[e], n, h), a);
  return a;
}

__device__ __forceinline__ float event_dot(const int* ix, const float* vx,
                                           int c, FloatLayer l, int n, int h,
                                           float a) {
  int e = 0;
  for (; e + kLoadBatch <= c; e += kLoadBatch) {
    float w[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) w[j] = l.at(ix[e + j], n, h);
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) a = fmaf(vx[e + j], w[j], a);
  }
  for (; e < c; ++e) a = fmaf(vx[e], l.at(ix[e], n, h), a);
  return a;
}

// The same sum over each row's event list (list t * kRows + r, ascending
// index, lossless): only the rows of W that the events name are read.
template <class Layer>
__device__ __forceinline__ void gather_product(const int* idx,
                                               const float* val,
                                               const int* cnt, int ts, int h,
                                               Layer l, int n,
                                               float (&acc)[kRows][kMaxTs]) {
#pragma unroll
  for (int t = 0; t < kMaxTs; ++t) {
    if (t >= ts) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int li = t * kRows + r;
      acc[r][t] = event_dot(idx + li * h, val + li * h, cnt[li], l, n, h,
                            acc[r][t]);
    }
  }
}

// Event lists of the ts * kRows rows of a (TS, kRows, H) train, one warp a
// row: list l holds row l's nonzeros in ascending index, all of them.
__device__ __forceinline__ void compact_train(const float* s, int ts, int h,
                                              int* idx, float* val,
                                              int* cnt) {
  const int warp = threadIdx.x >> 5;
  for (int l = warp; l < ts * kRows; l += kWarps) {
    const int c = reprotorch::compact_row(s + l * h, 0, 1, h, h, idx + l * h,
                                          val + l * h);
    if ((threadIdx.x & 31) == 0) cnt[l] = c;
  }
}

// The sequential LIF chain of one layer for this thread's column n: reads
// stim = ff[r][t] + rec[r][t], carries u/h in registers, writes the new
// spikes into the train s.
__device__ __forceinline__ void lif_chain(const float (&ff)[kRows][kMaxTs],
                                          const float (&rec)[kRows][kMaxTs],
                                          float beta, float vth, int ts,
                                          int h, int n, float (&u)[kRows],
                                          float (&hh)[kRows], float* s) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int t = 0; t < kMaxTs; ++t) {
      if (t >= ts) continue;
      const float st = __fadd_rn(ff[r][t], rec[r][t]);
      u[r] = __fadd_rn(st, __fmul_rn(__fmul_rn(beta, u[r]),
                                     __fsub_rn(1.0f, hh[r])));
      hh[r] = (u[r] >= vth) ? 1.0f : 0.0f;
      s[(t * kRows + r) * h + n] = hh[r];
    }
  }
}

template <bool kSpike, bool kFloat>
__global__ void __launch_bounds__(kMegaThreads)
    megastep_kernel(const Operands o) {
  using Layer = std::conditional_t<kFloat, FloatLayer, PackedLayer>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ts = o.ts, b = o.b, d = o.d, h = o.h, fc = o.fc;
  const Layout lay = shared_layout(ts, d, h, kSpike, !kFloat);
  float* s0_sh = reinterpret_cast<float*>(smem + lay.s0);  // [t][r][k]
  float* s1_sh = reinterpret_cast<float*>(smem + lay.s1);
  float* m_sh = reinterpret_cast<float*>(smem + lay.merged);  // [r][k]
  float* x_sh = reinterpret_cast<float*>(smem + lay.x);       // [r][d]
  int* idx_sh = reinterpret_cast<int*>(smem + lay.ev_idx);    // 2 list sets
  float* val_sh = reinterpret_cast<float*>(smem + lay.ev_val);
  int* cnt_sh = reinterpret_cast<int*>(smem + lay.ev_cnt);
  int8_t* wq_sh = reinterpret_cast<int8_t*>(smem + lay.wq);
  const int train = ts * kRows * h;
  int* idx_b = idx_sh + train;  // the second list set
  float* val_b = val_sh + train;
  int* cnt_b = cnt_sh + ts * kRows;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, b - row0);
  const int n = tid;  // this thread's hidden column
  const bool owns = n < h;

  // the layer weights: int4 nibbles staged once for the whole chunk, with
  // this column's scales; float32 matrices read in place
  Layer wl[4];
  if constexpr (kFloat) {
#pragma unroll
    for (int m = 0; m < 4; ++m) wl[m] = FloatLayer{o.w[m]};
  } else {
    int off = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int count = ((m == 0 ? d : h) / 2) * h;
      for (int i = tid; i < count; i += kMegaThreads) wq_sh[off + i] = o.q[m][i];
      wl[m] = PackedLayer{wq_sh + off, owns ? o.scale[m][n] : 0.0f};
      off += count;
    }
  }
  // the previous frame's spike trains; rows past the batch are zero
  for (int i = tid; i < train; i += kMegaThreads) {
    const int t = i / (kRows * h);
    const int rem = i - t * kRows * h;
    const int r = rem / h;
    const int k = rem - r * h;
    const long long at = (static_cast<long long>(t) * b + row0 + r) * h + k;
    s0_sh[i] = r < rows ? o.s0[at] : 0.0f;
    s1_sh[i] = r < rows ? o.s1[at] : 0.0f;
  }
  float u0[kRows], h0[kRows], u1[kRows], h1[kRows];
  float beta0 = 0.0f, vth0 = 0.0f, beta1 = 0.0f, vth1 = 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const bool live = owns && r < rows;
    const long long at = static_cast<long long>(row0 + r) * h + n;
    u0[r] = live ? o.u0[at] : 0.0f;
    h0[r] = live ? o.h0[at] : 0.0f;
    u1[r] = live ? o.u1[at] : 0.0f;
    h1[r] = live ? o.h1[at] : 0.0f;
  }
  if (owns) {
    beta0 = o.beta[0][n];
    vth0 = o.vth[0][n];
    beta1 = o.beta[1][n];
    vth1 = o.vth[1][n];
  }
  const unsigned bit_mask = o.input_bits <= 0 ? 0u
      : o.input_bits >= 32 ? 0xffffffffu : ((1u << o.input_bits) - 1u);
  __syncthreads();  // the weights and trains are staged

  for (int f = 0; f < o.frames; ++f) {
    for (int i = tid; i < kRows * d; i += kMegaThreads) {
      const int r = i / d;
      const int k = i - r * d;
      x_sh[i] = r < rows
          ? o.x[(static_cast<long long>(f) * b + row0 + r) * d + k] : 0.0f;
    }
    if (kSpike) compact_train(s0_sh, ts, h, idx_sh, val_sh, cnt_sh);
    __syncthreads();  // x and the previous L0 train's lists are in place

    for (int r = warp; r < rows; r += kWarps) {  // input one-bits
      int c = 0;
      for (int k = lane; k < d; k += 32) {
        c += __popc(static_cast<unsigned>(static_cast<int>(
                        fabsf(x_sh[r * d + k]))) & bit_mask);
      }
      c = warp_sum(c);
      if (lane == 0) o.one_bits[static_cast<long long>(f) * b + row0 + r] = c;
    }

    // L0: ff0 over the input rows (dense: x is no spike train), rec0
    float ff[kRows][kMaxTs], rec[kRows][kMaxTs];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int t = 0; t < kMaxTs; ++t) ff[r][t] = rec[r][t] = 0.0f;
    }
    if (owns) {
      if constexpr (kFloat) {
#pragma unroll 4
        for (int k = 0; k < d; ++k) {
          const float w = wl[0].at(k, n, h);
#pragma unroll
          for (int r = 0; r < kRows; ++r) ff[r][0] = fmaf(x_sh[r * d + k], w, ff[r][0]);
        }
      } else {
        for (int p = 0; p < d / 2; ++p) {
          const int byte = wl[0].q[p * h + n];
          const float w_lo = __fmul_rn(nibble(byte), wl[0].scale);
          const float w_hi = __fmul_rn(nibble(byte >> 4), wl[0].scale);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            ff[r][0] = fmaf(x_sh[r * d + 2 * p], w_lo, ff[r][0]);
            ff[r][0] = fmaf(x_sh[r * d + 2 * p + 1], w_hi, ff[r][0]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int t = 1; t < kMaxTs; ++t) ff[r][t] = ff[r][0];  // broadcast over TS
      }
      if (kSpike) {
        gather_product(idx_sh, val_sh, cnt_sh, ts, h, wl[1], n, rec);
      } else {
        dense_product(s0_sh, ts, h, wl[1], n, rec);
      }
    }
    __syncthreads();  // every read of the previous L0 train is done
    if (owns) lif_chain(ff, rec, beta0, vth0, ts, h, n, u0, h0, s0_sh);
    __syncthreads();  // the new L0 train is complete

    // L1: ff1 over L0's new spikes, rec1 over the previous L1 train
    if (kSpike) {
      compact_train(s0_sh, ts, h, idx_sh, val_sh, cnt_sh);
      compact_train(s1_sh, ts, h, idx_b, val_b, cnt_b);
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int t = 0; t < kMaxTs; ++t) ff[r][t] = rec[r][t] = 0.0f;
    }
    if (owns) {
      if (kSpike) {
        gather_product(idx_sh, val_sh, cnt_sh, ts, h, wl[2], n, ff);
        gather_product(idx_b, val_b, cnt_b, ts, h, wl[3], n, rec);
      } else {
        dense_product(s0_sh, ts, h, wl[2], n, ff);
        dense_product(s1_sh, ts, h, wl[3], n, rec);
      }
    }
    __syncthreads();  // every read of the previous L1 train is done
    if (owns) lif_chain(ff, rec, beta1, vth1, ts, h, n, u1, h1, s1_sh);
    __syncthreads();  // the new L1 train is complete

    // merged spikes (sum over t = 0, 1, ...: exact) and the spike counters
    for (int i = tid; i < kRows * h; i += kMegaThreads) {
      const int r = i / h;
      const int k = i - r * h;
      float m = 0.0f;
      for (int t = 0; t < ts; ++t) m = __fadd_rn(m, s1_sh[(t * kRows + r) * h + k]);
      m_sh[i] = m;
    }
    for (int j = warp; j < ts * kRows; j += kWarps) {
      const int t = j / kRows;
      const int r = j - t * kRows;
      if (r >= rows) continue;
      int c0 = 0, c1 = 0;
      for (int k = lane; k < h; k += 32) {
        c0 += s0_sh[j * h + k] != 0.0f;
        c1 += s1_sh[j * h + k] != 0.0f;
      }
      c0 = warp_sum(c0);
      c1 = warp_sum(c1);
      if (lane == 0) {
        const long long at = (static_cast<long long>(f) * ts + t) * b + row0 + r;
        o.spikes_l0[at] = c0;
        o.spikes_l1[at] = c1;
      }
    }
    for (int r = warp; r < rows; r += kWarps) {
      int c = 0;
      for (int k = lane; k < h; k += 32) {
        bool any = false;
        for (int t = 0; t < ts; ++t) any |= s1_sh[(t * kRows + r) * h + k] != 0.0f;
        c += any;
      }
      c = warp_sum(c);
      if (lane == 0) o.union_l1[static_cast<long long>(f) * b + row0 + r] = c;
    }
    __syncthreads();  // merged spikes complete
    const bool float_fc = o.fc_mode == kFcDenseFloat;
    const bool dense_fc = float_fc || o.fc_mode == kFcDenseInt4;
    if (kSpike && dense_fc) {  // the merged union's events, values in {0..TS}
      for (int r = warp; r < kRows; r += kWarps) {
        const int c = reprotorch::compact_row(m_sh + r * h, 0, 1, h, h,
                                              idx_sh + r * h, val_sh + r * h);
        if (lane == 0) cnt_sh[r] = c;
      }
      __syncthreads();
    }

    // FC readout: integer sums, one scale per column; float32 sums of the
    // float FC, no scale
    for (int col = tid; col < fc; col += kMegaThreads) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      if (float_fc) {
        const float* w_fc = static_cast<const float*>(o.fc_a);
        if (kSpike) {  // (H, N) row-major: W_fc[k][col] is at(k, col, N)
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r] = event_dot(idx_sh + r * h, val_sh + r * h, cnt_sh[r],
                               FloatLayer{w_fc}, col, fc, 0.0f);
          }
        } else {
#pragma unroll 4
          for (int k = 0; k < h; ++k) {
            const float w = __ldg(w_fc + static_cast<long long>(k) * fc + col);
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r] = fmaf(m_sh[r * h + k], w, acc[r]);
          }
        }
      } else if (dense_fc) {
        const int8_t* packed = static_cast<const int8_t*>(o.fc_a);
        if (kSpike) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            float a = 0.0f;
            for (int e = 0; e < cnt_sh[r]; ++e) {
              const int k = idx_sh[r * h + e];
              const int byte = packed[static_cast<long long>(k >> 1) * fc + col];
              a = fmaf(val_sh[r * h + e], nibble((k & 1) ? (byte >> 4) : byte), a);
            }
            acc[r] = a;
          }
        } else {
          reprotorch::int4_column_dot(m_sh, rows, h, packed, fc, col, acc);
        }
      } else if (o.fc_mode == kFcNm) {  // K5's walk: one byte an entry
        const int8_t* packed = static_cast<const int8_t*>(o.fc_a);
        int group_row = 0;  // (e / nm_n) * nm_m
        int slot = 0;       // e % nm_n
        for (int e = 0; e < o.nnz; ++e) {
          const int byte = packed[static_cast<long long>(e) * fc + col];
          const int row = group_row + ((byte >> 4) & 0xF);
          if (++slot == o.nm_n) {
            slot = 0;
            group_row += o.nm_m;
          }
          if (row >= h) continue;
          const float v = nibble(byte);
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = fmaf(m_sh[r * h + row], v, acc[r]);
        }
      } else {
        const int* indices = static_cast<const int*>(o.fc_a);
        for (int e = 0; e < o.nnz; ++e) {
          const long long at = static_cast<long long>(e) * fc + col;
          const int row = indices[at];
          if (static_cast<unsigned>(row) >= static_cast<unsigned>(h)) continue;
          const float v = o.fc_values[at];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r] = fmaf(m_sh[r * h + row], v, acc[r]);
        }
      }
      const float s = float_fc ? 1.0f : o.fc_scale[col];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          o.logits[(static_cast<long long>(f) * b + row0 + r) * fc + col] =
              float_fc ? acc[r] : __fmul_rn(acc[r], s);
        }
      }
    }
    __syncthreads();  // the next frame overwrites x, the lists and merged
  }

  for (int i = tid; i < train; i += kMegaThreads) {
    const int t = i / (kRows * h);
    const int rem = i - t * kRows * h;
    const int r = rem / h;
    const int k = rem - r * h;
    if (r < rows) {
      const long long at = (static_cast<long long>(t) * b + row0 + r) * h + k;
      o.s0_out[at] = s0_sh[i];
      o.s1_out[at] = s1_sh[i];
    }
  }
  if (owns) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const long long at = static_cast<long long>(row0 + r) * h + n;
        o.u0_out[at] = u0[r];
        o.u1_out[at] = u1[r];
      }
    }
  }
}

}  // namespace

extern "C" int megastep_launch(
    const void* x, const void* s0, const void* u0, const void* h0,
    const void* s1, const void* u1, const void* h1, const void* beta0,
    const void* vth0, const void* beta1, const void* vth1, const void* w0x,
    const void* sc0x, const void* w0h, const void* sc0h, const void* w1x,
    const void* sc1x, const void* w1h, const void* sc1h, int precision,
    int fc_mode, const void* fc_a, const void* fc_values,
    const void* fc_scale, void* s0_out, void* u0_out, void* s1_out,
    void* u1_out, void* logits, void* spikes_l0, void* spikes_l1,
    void* union_l1, void* one_bits, int frames, int ts, int b, int d, int h,
    int fc, int nnz, int nm_n, int nm_m, int input_bits, int spike,
    void* stream) {
  if (ts > kMaxTs) return reprotorch::kErrTooManySteps;
  if (h > kMegaThreads) return reprotorch::kErrTooWide;
  // float weights come with the float FC only, int4 ones with the int4
  // layouts' FCs only
  const bool float_w = precision == kPrecisionFloat;
  if ((precision != kPrecisionInt4 && !float_w) || fc_mode < kFcDenseInt4 ||
      fc_mode > kFcDenseFloat || (fc_mode == kFcDenseFloat) != float_w) {
    return reprotorch::kErrFcMode;
  }
  if (fc_mode == kFcNm &&
      (nm_n < 1 || nm_n > nm_m || nm_m > 16 || nnz % nm_n != 0)) {
    return reprotorch::kErrNmGeometry;
  }
  const size_t smem = shared_layout(ts, d, h, spike != 0, !float_w).total;
  if (smem > reprotorch::kMaxMegastepSharedBytes) return reprotorch::kErrSharedMemory;
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  Operands o = {};
  o.x = f32(x);
  o.s0 = f32(s0);
  o.u0 = f32(u0);
  o.h0 = f32(h0);
  o.s1 = f32(s1);
  o.u1 = f32(u1);
  o.h1 = f32(h1);
  o.beta[0] = f32(beta0);
  o.vth[0] = f32(vth0);
  o.beta[1] = f32(beta1);
  o.vth[1] = f32(vth1);
  const void* wp[4] = {w0x, w0h, w1x, w1h};
  const void* sp[4] = {sc0x, sc0h, sc1x, sc1h};
  for (int m = 0; m < 4; ++m) {
    if (float_w) {
      o.w[m] = f32(wp[m]);
    } else {
      o.q[m] = i8(wp[m]);
      o.scale[m] = f32(sp[m]);
    }
  }
  o.fc_mode = fc_mode;
  o.fc_a = fc_a;
  o.fc_values = f32(fc_values);
  o.fc_scale = f32(fc_scale);
  o.s0_out = static_cast<float*>(s0_out);
  o.u0_out = static_cast<float*>(u0_out);
  o.s1_out = static_cast<float*>(s1_out);
  o.u1_out = static_cast<float*>(u1_out);
  o.logits = static_cast<float*>(logits);
  o.spikes_l0 = static_cast<float*>(spikes_l0);
  o.spikes_l1 = static_cast<float*>(spikes_l1);
  o.union_l1 = static_cast<float*>(union_l1);
  o.one_bits = static_cast<float*>(one_bits);
  o.frames = frames;
  o.ts = ts;
  o.b = b;
  o.d = d;
  o.h = h;
  o.fc = fc;
  o.nnz = nnz;
  o.nm_n = nm_n;
  o.nm_m = nm_m;
  o.input_bits = input_bits;
  void (*kernel)(const Operands) =
      spike ? (float_w ? megastep_kernel<true, true> : megastep_kernel<true, false>)
            : (float_w ? megastep_kernel<false, true> : megastep_kernel<false, false>);
  if (smem > reprotorch::kMaxSharedBytes) {  // opt in beyond 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((b + kRows - 1) / kRows);
  kernel<<<grid, kMegaThreads, smem, static_cast<cudaStream_t>(stream)>>>(o);
  return static_cast<int>(cudaGetLastError());
}
