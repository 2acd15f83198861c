// K6 + K7: the whole RSNN frame step over an F-frame chunk in one launch.
//
// Replaces the TPU kernel src/repro/kernels/megastep.py `megastep`
// (pl.pallas_call at line 250, body `_megastep_kernel`): K6 is its
// spike=False mode, K7 its spike=True mode, and each at both precisions of
// the layer weights: int4 (W = nibble(q) * scale) or float32 (W as stored).
// For each frame f:
//
//   L0:  ff0 = x[f] @ W0x;  rec0[t] = s0[t] @ W0h;  stim = ff0 + rec0[t]
//   L1:  ff1[t] = s0'[t] @ W1x;  rec1[t] = s1[t] @ W1h;  stim = ff1 + rec1
//        each layer's LIF chain  u = stim + (beta * u) * (1 - h),
//        h = (u >= vth), t = 0..TS-1 (K1's chain exactly)
//   FC:  logits[f] = (sum_k merged[k] * q_fc[k]) * scale_fc, merged =
//        sum_t s1'[t] (dense_int4, K3's sums), or the padded-CSC gather
//        of merged (csc, K4's order), or the N:M group-packed gather (nm,
//        K5's order): integer sums, one scale at the end; or, with float
//        weights, sum_k merged[k] * w_fc[k] in float32, k ascending, no
//        scale (dense_float)
//   counters: spikes_l0/l1[f][t] = sum_k s'[t][k], union_l1[f] = the
//        columns where some s1'[t] spiked, input_one_bits[f] = sum_d
//        popc(int(|x|) & (2^input_bits - 1))
//
// The state (the s0/s1 spike trains, u/h of each layer) stays on chip across
// the F frames and is written once at the end.  Shapes: x (F, B, D), s0/s1
// (TS, B, H) spikes, 0/1 only (kept as bits: a nonzero entry reads as 1;
// the served state is the kernel's own output), u0/h0/u1/h1 (B, H),
// beta/vth (H,), all float32;
// the four layer weights (K/2, H) int8 nibbles + (H,) float32 scales, or
// (K, H) float32 (precision float, whose only FC is dense_float: w_fc (H, N)
// float32); FC dense_int4 packed (H/2, N) int8 + scale (N,), csc indices
// (nnz, N) int32 + values (nnz, N) float32 + scale (N,), or nm packed (E, N)
// int8 (value | offset << 4, nm_n entries of every nm_m rows) + scale (N,).
// Outputs: s0/s1 (TS, B, H), u0/u1 (B, H), logits (F, B, N), spikes_l0/l1
// (F, TS, B), union_l1 and input_one_bits (F, B).
//
// Bound on the H100, at B = 256, F = 1, TS = 2, H = 128, N = 1920 (nnz 95):
// the call moves 5.35 MB with csc (the 1.97 MB logits and 1.46 MB of CSC
// index + value dominate; 4.01 MB with dense_int4 and 2:4 nm, whose FC
// operands are 0.13 MB): 1.60 us (1.20 us) at 3.35 TB/s.  Its products
// over the trains' events (counted as float32: at most 53 MFLOP, 0.79 us
// at 67 TFLOP/s) and the FC's integer sums (exact on the int8 tensor
// cores) take less: bytes bound it.  At BASELINE (H = 256, float weights)
// the float32 products of the events and of the merged union's FC rows
// bound it: 2.6 us (chip_smoke.py counts them from each run's trains; a
// dense count, 458 MFLOP and 6.9 us, adds products with a 0 spike, work
// that neither K6 nor K7 needs).
//
// Design: one thread-block cluster of C CTAs (8 or 16) for each tile of
// kSlots = 32 slots; kThreads = 256 threads a CTA, 8 column groups of
// each of the 32 slots.  The plan (32 slots, C, FC columns a sub-tile)
// comes from the wrapper: among the plans that fit 227 KB, resident_plan
// takes the widest FC sub-tile, then the fewest waves of the B / 32
// clusters over those the card holds at once (an H100 holds 7 clusters of
// 16 at one CTA an SM, 14 at two, 15 of 8), then the larger cluster: B =
// 256 runs 64 or 128 CTAs.
//   Cells, split by hidden column: CTA r owns hcp = 8 kCt hidden columns
//   of both layers (H / C rounded up to 8, 16 or 32; H need not divide),
//   thread (slot, g) the columns g kCt .. g kCt + kCt - 1 of them, whose
//   u/h live in registers across the chunk.  The CTA stages its slice of
//   the layer weights once a launch by cp.async, so no product reads L2:
//   float32 weights as they are ((D + 3 Hp) x hcp x 4 B, 103 KB at
//   BASELINE with C = 8); int4 weights as L0's input slice dequantized
//   (W = nibble * scale) and the other three as bit planes, 32 rows a
//   word (and as int8 for K7).  The spike trains live in shared memory as
//   bits, one (TS, 32, Hp / 32) word array per train and buffer (two
//   buffers: the previous frame's, read, and this frame's, written):
//   after each layer's LIF chain a warp's ballots give each slot its hcp
//   new bits, which its lanes store into every CTA's copy of the train
//   (cluster.map_shared_rank), and one cluster barrier makes them
//   visible, so every CTA reads the whole train from its own shared
//   memory.  Two cluster barriers a frame.  int4 products are exact
//   integers scaled once a column: K6 takes them from popcounts of the
//   spike words against the weights' four bit planes, K7 as sums of int8
//   nibbles over each row's event list (compacted once a frame per CTA
//   from the bits, one byte an event); the same integers, so K7 == K6.
//   float products add W[k] for each spike, k ascending: K6 over every
//   bit as fmaf(s, w, a) with s in {0, 1}, K7 over the events as
//   fmaf(1, w, a) is, the same floats (fmaf(0, w, a) == a: a sum never
//   holds -0).  L0's input product is an ascending fmaf chain over D.
//   FC readout, split by output column: CTA r takes nc = ceil(N / C) output
//   columns (rounded up to the sub-tile) for the tile's 32 slots.  Each
//   sub-tile of `cols` columns is staged by cp.async (the first while the
//   cells run, the next while the current one is multiplied).  The int4
//   FCs are decoded into a dense s8 tile (dense_int4 unpacked as K2/K3 do;
//   csc and nm scattered: their values are int4 integers and a column
//   names a row at most once) and run on the int8 tensor cores, mma.sync
//   m16n8k32 against the merged spikes as s8 ({0..TS}): exact integer
//   sums scaled once, the plain version's bits in every FC mode.
//   dense_float runs an ascending fmaf chain over k for each output (a
//   warp 4 slots by 32 columns, m as one float4 a k); K7's runs over the
//   rows of the tile's merged union only (and stages only those rows of
//   w_fc): the rows left out are zero for every slot of the tile, so K7 ==
//   K6.  The FC's L2 reads fall from 32 blocks x its bytes to B / 32
//   clusters x its bytes.
//   Counters: every CTA holds the whole new trains, so CTA r counts the
//   slots s with s % C == r from its own copy (popc), with no atomics and
//   no cross-CTA sums; the input one-bits likewise.
// What holds it now (megastep_trace.py's clock64 stamps): at F = 1 the
// launch's staging of the slices and the trains (a quarter of an int4
// call), the cluster barriers' waits, the FC's staging and decoding, and
// K7's compaction and event sums; at BASELINE the float FC's fmaf chains
// and the float layer products, on CUDA cores.  The launch refuses a plan
// it does not take (kErrTilePlan), shared memory over 227 KB
// (kErrSharedMemory) and a plan none of whose clusters can be resident
// (kErrCluster: cudaOccupancyMaxActiveClusters); ragged B, N and H are
// masked, with no divisibility rule but D and H even.
#include <cooperative_groups.h>

#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

// MEGA_STAMP(i): built with -DREPRO_MEGASTEP_TRACE (megastep_trace.py),
// thread 0 of each CTA stores clock64() into g_trace[cta][i] at stamp i,
// which ends phase i (the script names the phases); otherwise nothing.
#ifdef REPRO_MEGASTEP_TRACE
__device__ long long g_trace[1024][32];
#define MEGA_STAMP(i) \
  do { if (threadIdx.x == 0) g_trace[blockIdx.x][i] = clock64(); } while (0)
#else
#define MEGA_STAMP(i) do { } while (0)
#endif

namespace {

using reprotorch::kMaxTs;
using reprotorch::nibble;

constexpr int kFcDenseInt4 = 0;
constexpr int kFcCsc = 1;
constexpr int kFcNm = 2;
constexpr int kFcDenseFloat = 3;  // float32 w_fc (H, N); float precision only
constexpr int kPrecisionInt4 = 0;
constexpr int kPrecisionFloat = 1;
constexpr int kSlots = 32;   // slots a cluster: two m16 tiles of the int4 FC
constexpr int kGroups = 8;   // column groups of a slot
constexpr int kThreads = kSlots * kGroups;
constexpr int kWarps = kThreads / 32;

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
  int cluster, cols;  // the plan: CTAs a cluster, FC columns a sub-tile
  bool spike, vec16, w16, x16, out8, wvec;
};

__host__ __device__ constexpr size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// One CTA's shared memory, in bytes from the start (16-byte aligned
// regions), for the host's size check, the wrapper's tile_plans and the
// kernel's pointers alike:
//   w      float [D + 3 Hp][hcp]      the four layer slices (float), or
//          float [D][hcp]             int4: L0's input slice, dequantized
//   planes uint4 [3][hw][hcp]         int4: the recurrent and L1 slices'
//                                     bit planes, 32 rows a word
//   q      int8  [3][Hp][hcp]         int4: the same nibbles, for K7
//   sc     float [4][hcp]             int4: the slices' scales
//   x      float [2][32][D]           this frame's inputs and the next's
//   train  u32   [2 buf][2][TS][32][hw]  s0 and s1 as bits
//   ev     u8    [2][TS][32][lde]     K7: each row's events (hidden index)
//   ev_cnt int   [2][TS][32] + 1      K7: their counts, the union's count
//   uni    u8    [Hp]                 K7, dense_float: the tile's union
//   mfc    the merged spikes: int4 FCs s8 [32][ld] (mma's A); dense_float
//          float [Hp][32]
//   raw    the FC sub-tile as staged: csc int + float [E][cols]; nm int8
//          [E][cols]; dense_int4 int8 [H/2][cols]; dense_float float
//          [E][cols] (first, the int4 layer slices' bytes)
//   tile   int4 FCs: the sub-tile decoded, s8 [cols][ld] (mma's B);
//          dense_float: the second staging buffer, float [E][cols]
//   fsc    float [2][cols]            int4 FCs: two sub-tiles' scales
// hcp = 8, 16 or 32 (H / C rounded up), hp = C hcp rounded up to 32 bits,
// hw = hp / 32, lde = hp + 4, ld = hp + 16, E = nnz (csc, nm) or H.
struct MegaLayout {
  int hcp, hp, hw, lde, ld, entries;
  size_t w, planes, q, sc, x, train, ev, ev_cnt, uni, mfc, raw, tile, fsc, bytes;
  __host__ __device__ MegaLayout(int ts, int d, int h, int fc_mode, int nnz,
                                 bool spike, int cluster, int cols) {
    const int per = (h + cluster - 1) / cluster;
    hcp = 8;
    while (hcp < per) hcp *= 2;
    hp = (cluster * hcp + 31) / 32 * 32;
    hw = hp / 32;
    lde = hp + 4;
    ld = hp + reprotorch::kTilePad;
    const bool float_fc = fc_mode == kFcDenseFloat;
    entries = float_fc || fc_mode == kFcDenseInt4 ? h : nnz;
    const size_t tile_e = static_cast<size_t>(entries) * cols;
    size_t off = 0;
    w = off;
    off += align16(4ull * (float_fc ? d + 3 * hp : d) * hcp);
    planes = off;
    if (!float_fc) off += align16(16ull * 3 * hw * hcp);
    q = off;
    if (!float_fc) off += align16(3ull * hp * hcp);
    sc = off;
    if (!float_fc) off += align16(4ull * 4 * hcp);
    x = off;
    off += align16(4ull * 2 * kSlots * d);
    train = off;
    off += align16(4ull * 4 * ts * kSlots * hw);
    ev = off;
    if (spike) off += align16(2ull * ts * kSlots * lde);
    ev_cnt = off;
    if (spike) off += align16(4ull * (2 * ts * kSlots + 1));
    uni = off;
    if (spike && float_fc) off += align16(hp);
    mfc = off;
    off += align16(float_fc ? 4ull * hp * kSlots : static_cast<size_t>(kSlots) * ld);
    raw = off;
    off += align16(fc_mode == kFcCsc ? 8 * tile_e
                   : fc_mode == kFcNm ? tile_e
                   : fc_mode == kFcDenseInt4 ? static_cast<size_t>(h / 2) * cols
                                             : 4 * tile_e);
    tile = off;
    off += align16(float_fc ? 4 * tile_e : static_cast<size_t>(cols) * ld);
    fsc = off;
    if (!float_fc) off += align16(8ull * cols);
    // the int4 layer slices' bytes are staged through raw.. first
    const size_t slices = align16(static_cast<size_t>(d / 2 + 3 * (hp / 2)) * hcp);
    bytes = off > raw + slices ? off : raw + slices;
  }
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// kCt consecutive floats from shared memory (aligned to kCt floats).
template <int kCt>
__device__ __forceinline__ void load_w(const float* p, float (&v)[kCt]) {
  if constexpr (kCt == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (kCt == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// acc[t][i] += sum_k s[t][slot][k] * W[k][col i], k ascending, over every
// bit of the rows (K6, float weights): W's slice is [hp][hcp] with this
// thread's kCt columns at grp * kCt; each term is fmaf(s, w, a) with s the
// bit as 0.0 or 1.0 (fmaf(0, w, a) == a: a sum never holds -0).
template <int kTs, int kCt>
__device__ __forceinline__ void dense_product(const uint32_t* rows, int ts,
                                              int hw, int slot,
                                              const float* wm, int grp,
                                              float (&acc)[kTs][kCt]) {
  constexpr int hcp = kCt * kGroups;
  const float* wbase = wm + grp * kCt;
  for (int kw = 0; kw < hw; ++kw) {
    uint32_t bits[kTs];
#pragma unroll
    for (int t = 0; t < kTs; ++t) {
      bits[t] = t < ts ? rows[(t * kSlots + slot) * hw + kw] : 0u;
    }
    const float* wk = wbase + kw * 32 * hcp;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float wv[kCt];
      load_w<kCt>(wk + j * hcp, wv);
#pragma unroll
      for (int t = 0; t < kTs; ++t) {
        const float sv = ((bits[t] >> j) & 1u) ? 1.0f : 0.0f;
#pragma unroll
        for (int i = 0; i < kCt; ++i) acc[t][i] = fmaf(sv, wv[i], acc[t][i]);
      }
    }
  }
}

// The same sums over each row's event list (K7, float weights): ev[t][slot]
// holds the row's spikes' hidden indices ascending, cnt[t][slot] how many;
// only the rows of W the events name are read, each added as fmaf(1, w, a)
// is: the same floats as dense_product's.  Four events' weights are loaded
// before their adds, which run in event order.
template <int kTs, int kCt>
__device__ __forceinline__ void event_product(const uint8_t* ev,
                                              const int* cnt, int ts, int lde,
                                              int slot, const float* wm,
                                              int grp,
                                              float (&acc)[kTs][kCt]) {
  constexpr int hcp = kCt * kGroups;
  const float* wbase = wm + grp * kCt;
#pragma unroll
  for (int t = 0; t < kTs; ++t) {
    if (t >= ts) continue;
    const uint8_t* e8 = ev + (t * kSlots + slot) * lde;
    const int c = cnt[t * kSlots + slot];
    int e = 0;
    for (; e + 4 <= c; e += 4) {
      const uint32_t k4 = *reinterpret_cast<const uint32_t*>(e8 + e);
      float wv[4][kCt];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        load_w<kCt>(wbase + ((k4 >> (8 * u)) & 0xFFu) * hcp, wv[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < kCt; ++i) acc[t][i] = __fadd_rn(acc[t][i], wv[u][i]);
      }
    }
    for (; e < c; ++e) {
      float wv[kCt];
      load_w<kCt>(wbase + e8[e] * hcp, wv);
#pragma unroll
      for (int i = 0; i < kCt; ++i) acc[t][i] = __fadd_rn(acc[t][i], wv[i]);
    }
  }
}

// acc[t][i] += sum_k s[t][slot][k] * q[k][col i] over int4 weights, as
// exact integers (K6, int4): the nibbles' bit planes of each column and 32
// rows, P_b (b = 0..3, two's complement: q = P0 + 2 P1 + 4 P2 - 8 P3),
// take one AND and one popcount each against the spike word.  planes is
// [hw][hcp] uint4 (x..w = P0..P3), this thread's columns at grp * kCt.
template <int kTs, int kCt>
__device__ __forceinline__ void plane_product(const uint32_t* rows, int ts,
                                              int hw, int slot,
                                              const uint4* planes, int grp,
                                              int (&acc)[kTs][kCt]) {
  constexpr int hcp = kCt * kGroups;
  for (int kw = 0; kw < hw; ++kw) {
    uint32_t bits[kTs];
#pragma unroll
    for (int t = 0; t < kTs; ++t) {
      bits[t] = t < ts ? rows[(t * kSlots + slot) * hw + kw] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kCt; ++i) {
      const uint4 pl = planes[kw * hcp + grp * kCt + i];
#pragma unroll
      for (int t = 0; t < kTs; ++t) {
        acc[t][i] += __popc(bits[t] & pl.x) + 2 * __popc(bits[t] & pl.y) +
                     4 * __popc(bits[t] & pl.z) - 8 * __popc(bits[t] & pl.w);
      }
    }
  }
}

// kCt consecutive int8 from shared memory (aligned to kCt bytes), byte i
// in bits 8i..8i+7.
template <int kCt>
__device__ __forceinline__ uint32_t load_q(const int8_t* p) {
  if constexpr (kCt == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (kCt == 2) {
    return *reinterpret_cast<const uint16_t*>(p);
  } else {
    return static_cast<uint8_t>(p[0]);
  }
}

// The same integer sums over each row's event list (K7, int4): q is the
// nibbles as int8, [hp][hcp]; only the rows the events name are read.
template <int kTs, int kCt>
__device__ __forceinline__ void event_product_q(const uint8_t* ev,
                                                const int* cnt, int ts,
                                                int lde, int slot,
                                                const int8_t* q, int grp,
                                                int (&acc)[kTs][kCt]) {
  constexpr int hcp = kCt * kGroups;
  const int8_t* qbase = q + grp * kCt;
#pragma unroll
  for (int t = 0; t < kTs; ++t) {
    if (t >= ts) continue;
    const uint8_t* e8 = ev + (t * kSlots + slot) * lde;
    const int c = cnt[t * kSlots + slot];
    int e = 0;
    for (; e + 4 <= c; e += 4) {
      const uint32_t k4 = *reinterpret_cast<const uint32_t*>(e8 + e);
      uint32_t qv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) qv[u] = load_q<kCt>(qbase + ((k4 >> (8 * u)) & 0xFFu) * hcp);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < kCt; ++i) acc[t][i] += static_cast<int8_t>(qv[u] >> (8 * i));
      }
    }
    for (; e < c; ++e) {
      const uint32_t qv = load_q<kCt>(qbase + e8[e] * hcp);
#pragma unroll
      for (int i = 0; i < kCt; ++i) acc[t][i] += static_cast<int8_t>(qv >> (8 * i));
    }
  }
}

// One int4 layer product into float sums: the integer sums of rows (K6:
// the train's bits against the planes; K7: its event lists against q),
// each scaled once by its column's scale.
template <int kTs, int kCt>
__device__ __forceinline__ void int4_product(
    bool spike, const uint32_t* rows, const uint8_t* ev, const int* cnt,
    int ts, int hw, int lde, int slot, const uint4* planes, const int8_t* q,
    int grp, const float (&scale)[kCt], float (&out)[kTs][kCt]) {
  int acc[kTs][kCt];
#pragma unroll
  for (int t = 0; t < kTs; ++t) {
#pragma unroll
    for (int i = 0; i < kCt; ++i) acc[t][i] = 0;
  }
  if (spike) {
    event_product_q<kTs, kCt>(ev, cnt, ts, lde, slot, q, grp, acc);
  } else {
    plane_product<kTs, kCt>(rows, ts, hw, slot, planes, grp, acc);
  }
#pragma unroll
  for (int t = 0; t < kTs; ++t) {
#pragma unroll
    for (int i = 0; i < kCt; ++i) out[t][i] = __fmul_rn(__int2float_rn(acc[t][i]), scale[i]);
  }
}

// Event lists of the ts * 32 bit rows of one train: list r holds row r's
// set bits' indices, ascending, all of them.  A warp takes four rows at a
// time, lane l word l % 8 of row l / 8 (hw <= 8): a prefix sum of the
// words' popcounts over the row's eight lanes gives each word's first
// slot, and each lane writes its word's events.
__device__ __forceinline__ void compact_train(const uint32_t* rows, int ts,
                                              int hw, int lde, uint8_t* ev,
                                              int* cnt) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane & 7;
  for (int r0 = 4 * warp; r0 < ts * kSlots; r0 += 4 * kWarps) {
    const int r = r0 + (lane >> 3);
    uint32_t wd = sub < hw ? rows[r * hw + sub] : 0u;
    const int c = __popc(wd);
    int incl = c;  // inclusive prefix sum over the row's eight lanes
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o, 8);
      if (sub >= o) incl += v;
    }
    uint8_t* out = ev + r * lde + (incl - c);
    for (int j = 0; wd != 0u; ++j) {
      const int bit = __ffs(wd) - 1;
      out[j] = static_cast<uint8_t>(32 * sub + bit);
      wd &= wd - 1u;
    }
    if (sub == 7) cnt[r] = incl;
  }
}

// Store this CTA's hcp = 8 kCt bits of one train row into a CTA's copy of
// the row (a peer's, through distributed shared memory): slice `rank`.
template <int kCt>
__device__ __forceinline__ void store_slice(uint32_t* row, int rank,
                                            uint32_t bits) {
  if constexpr (kCt == 4) {
    row[rank] = bits;
  } else if constexpr (kCt == 2) {
    reinterpret_cast<uint16_t*>(row)[rank] = static_cast<uint16_t>(bits);
  } else {
    reinterpret_cast<uint8_t*>(row)[rank] = static_cast<uint8_t>(bits);
  }
}

// Bit j of x (8 bits) at bit j * kCt: a slot's column group j holds
// slice columns j kCt .. j kCt + kCt - 1.
template <int kCt>
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  if constexpr (kCt == 4) {
    x = (x | (x << 12)) & 0x000F000Fu;
    x = (x | (x << 6)) & 0x03030303u;
    return (x | (x << 3)) & 0x11111111u;
  } else if constexpr (kCt == 2) {
    x = (x | (x << 4)) & 0x0F0Fu;
    x = (x | (x << 2)) & 0x3333u;
    return (x | (x << 1)) & 0x5555u;
  } else {
    return x;
  }
}

// One layer's LIF chain for this thread's kCt columns, t = 0..ts-1, then
// each time step's new bits into every CTA's copy of the train `rows` (this
// CTA's pointer; mapped to each peer): a warp holds 4 slots x 8 column
// groups, so the ballot of column i gives each slot bit i of each group,
// which spread<kCt> puts in slice order.  `owns`: a live slot and a column
// below H (others never spike).
template <int kTs, int kCt>
__device__ __forceinline__ void lif_chain(
    const float (&ff)[kTs][kCt], const float (&rec)[kTs][kCt],
    const float (&beta)[kCt], const float (&vth)[kCt], const bool (&owns)[kCt],
    float (&u)[kCt], float (&hh)[kCt], int ts, int slot, int grp, int hw,
    int rank, int nctas, cg::cluster_group& cluster, uint32_t* rows) {
  const int lane_slot = slot & 3;
#pragma unroll
  for (int t = 0; t < kTs; ++t) {
    if (t >= ts) continue;
    uint32_t bits = 0u;
#pragma unroll
    for (int i = 0; i < kCt; ++i) {
      const float st = __fadd_rn(ff[t][i], rec[t][i]);
      u[i] = __fadd_rn(st, __fmul_rn(__fmul_rn(beta[i], u[i]),
                                     __fsub_rn(1.0f, hh[i])));
      const bool spk = owns[i] && u[i] >= vth[i];
      hh[i] = spk ? 1.0f : 0.0f;
      const uint32_t ball = __ballot_sync(0xffffffffu, spk);
      bits |= spread<kCt>((ball >> (8 * lane_slot)) & 0xFFu) << i;
    }
    uint32_t* row = rows + (t * kSlots + slot) * hw;
    for (int p = grp; p < nctas; p += kGroups) {
      store_slice<kCt>(cluster.map_shared_rank(row, p), rank, bits);
    }
  }
}

// The int4 FC of one sub-tile on the int8 tensor cores: out[row0 + r][cf +
// c] = (sum_k a8[r][k] * b8[c][k]) * scale[c] for the 32 rows and `cols`
// columns, k < kp; a8 the merged spikes (s8, {0..TS}), b8 the sub-tile's
// int4 weights (s8, k-contiguous a column), scale the sub-tile's scales in
// shared memory.  A warp takes 8-column tiles, both 16-row halves of each
// at once (common.cuh's mma_s8_warp_tile, int4_tile_kernel's fragments:
// one B fragment for two mmas); the integer sums are exact and scaled
// once, as the plain version's.
__device__ __forceinline__ void fc_mma(const int8_t* a8, const int8_t* b8,
                                       int ld, int kp, int cols, int cf,
                                       int row0, int b, int n,
                                       const float* scale,
                                       float* __restrict__ out, bool out8) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int nt = warp; nt < cols / 8; nt += kWarps) {
    if (cf + 8 * nt >= n) break;  // warp-uniform: later tiles lie further right
    int acc[2][1][4] = {};
    reprotorch::mma_s8_warp_tile<2, 1>(a8, b8 + 8 * nt * ld, ld, kp, acc);
    const int c = 8 * nt + 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {  // rows g, g + 8, then g + 16, g + 24
      reprotorch::store_scaled_n8(acc[mt][0], row0 + 16 * mt + (lane >> 2), b,
                                  cf + c, n, scale + c, out, out8);
    }
  }
}

// The float FC of one sub-tile: out[row0 + s][cf + c] = sum_e m[k(e)][s] *
// w[e][c], e ascending (k(e) = rows[e], or e where rows is null), one fmaf
// chain an output.  Warp w takes slots 4w..4w+3 (one float4 of m, the
// same for its lanes), lane l the kCpl columns l, l + 32, ... (cols =
// 32 kCpl; at 16 columns half the lanes idle); four entries' loads go
// ahead of their multiply-adds.
template <int kCpl>
__device__ __forceinline__ void fc_float(const float* m_f, const float* w,
                                         const uint8_t* rows, int entries,
                                         int cols, int cf, int row0, int b,
                                         int n, float* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane >= cols) return;
  const float* wl = w + lane;
  const float* mw = m_f + 4 * warp;
  float acc[4][kCpl];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int i = 0; i < kCpl; ++i) acc[s][i] = 0.0f;
  }
  int e = 0;
  for (; e + 4 <= entries; e += 4) {
    float4 mv[4];
    float wv[4][kCpl];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = rows != nullptr ? rows[e + u] : e + u;
      mv[u] = *reinterpret_cast<const float4*>(mw + k * kSlots);
#pragma unroll
      for (int i = 0; i < kCpl; ++i) wv[u][i] = wl[(e + u) * cols + 32 * i];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int i = 0; i < kCpl; ++i) {
        acc[0][i] = fmaf(mv[u].x, wv[u][i], acc[0][i]);
        acc[1][i] = fmaf(mv[u].y, wv[u][i], acc[1][i]);
        acc[2][i] = fmaf(mv[u].z, wv[u][i], acc[2][i]);
        acc[3][i] = fmaf(mv[u].w, wv[u][i], acc[3][i]);
      }
    }
  }
  for (; e < entries; ++e) {
    const int k = rows != nullptr ? rows[e] : e;
    const float4 mv = *reinterpret_cast<const float4*>(mw + k * kSlots);
#pragma unroll
    for (int i = 0; i < kCpl; ++i) {
      const float wv = wl[e * cols + 32 * i];
      acc[0][i] = fmaf(mv.x, wv, acc[0][i]);
      acc[1][i] = fmaf(mv.y, wv, acc[1][i]);
      acc[2][i] = fmaf(mv.z, wv, acc[2][i]);
      acc[3][i] = fmaf(mv.w, wv, acc[3][i]);
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int row = row0 + 4 * warp + s;
    if (row >= b) continue;
#pragma unroll
    for (int i = 0; i < kCpl; ++i) {
      const int c = cf + lane + 32 * i;
      if (c < n) out[static_cast<long long>(row) * n + c] = acc[s][i];
    }
  }
}

// CTAs an SM the compiler is to leave registers for: two (at most 128
// registers a thread) for the int4 kernels of up to 4 accumulators a
// layer product, so that clusters of 16 fit twice as many at once.
template <int kTs, int kCt, bool kFloat>
constexpr int kMinBlocks = !kFloat && kTs * kCt <= 4 ? 2 : 1;

template <int kTs, int kCt, bool kFloat>
__global__ void __launch_bounds__(kThreads, kMinBlocks<kTs, kCt, kFloat>)
    megastep_kernel(const Operands o) {
  extern __shared__ __align__(16) unsigned char smem[];
  MEGA_STAMP(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int nctas = o.cluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int ts = o.ts, b = o.b, d = o.d, h = o.h, n = o.fc;
  const MegaLayout lay(ts, d, h, o.fc_mode, o.nnz, o.spike, nctas, o.cols);
  constexpr int hcp = kCt * kGroups;
  const int hp = lay.hp, hw = lay.hw, lde = lay.lde, ld = lay.ld;
  float* w_sh = reinterpret_cast<float*>(smem + lay.w);
  uint4* planes = reinterpret_cast<uint4*>(smem + lay.planes);
  int8_t* q_sh = reinterpret_cast<int8_t*>(smem + lay.q);
  float* sc_sh = reinterpret_cast<float*>(smem + lay.sc);
  float* x_sh = reinterpret_cast<float*>(smem + lay.x);
  uint32_t* tr = reinterpret_cast<uint32_t*>(smem + lay.train);
  uint8_t* ev = smem + lay.ev;
  int* ev_cnt = reinterpret_cast<int*>(smem + lay.ev_cnt);
  int* uni_cnt = ev_cnt + 2 * ts * kSlots;
  uint8_t* uni = smem + lay.uni;
  unsigned char* mfc = smem + lay.mfc;
  unsigned char* raw = smem + lay.raw;
  unsigned char* tile = smem + lay.tile;
  float* fsc = reinterpret_cast<float*>(smem + lay.fsc);
  const int train_words = ts * kSlots * hw;
  // train(buf, which): the (TS, 32, hw) bits of s0 (which 0) or s1 (1)
  auto train = [&](int buf, int which) { return tr + (2 * buf + which) * train_words; };
  uint8_t* ev_l[2] = {ev, ev + ts * kSlots * lde};
  int* cnt_l[2] = {ev_cnt, ev_cnt + ts * kSlots};

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int slot = tid / kGroups;
  const int grp = tid % kGroups;
  const int row0 = (blockIdx.x / nctas) * kSlots;
  const int row = row0 + slot;
  const bool live = row < b;
  const int c0 = rank * hcp;  // this CTA's first hidden column
  constexpr bool float_fc = kFloat;  // float weights come with the float FC

  // The x rows of frame f into x buffer f % 2 (rows past the batch zero).
  auto stage_x = [&](int f) {
    float* dst = x_sh + (f & 1) * kSlots * d;
    const float* src = o.x + (static_cast<long long>(f) * b + row0) * d;
    if (o.x16) {
      const int quads = d / 4;
      for (int i = tid; i < kSlots * quads; i += kThreads) {
        const bool in = row0 + i / quads < b;
        reprotorch::cp_async16(dst + 4 * i, src + (in ? 4 * i : 0), in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kSlots * d; i += kThreads) {
        const bool in = row0 + i / d < b;
        reprotorch::cp_async4(dst + i, src + (in ? i : 0), in ? 4 : 0);
      }
    }
  };

  // --- once a launch: the layer slices, frame 0's inputs, the trains.
  // w_sh[r][q] for r over [D | Hp | Hp | Hp] (matrix m, its row k) and the
  // slice's columns q = col - c0
  const int wrows = d + 3 * hp;
  auto w_row = [&](int r, int& m, int& k) {
    m = r < d ? 0 : 1 + (r - d) / hp;
    k = r < d ? r : (r - d) - (m - 1) * hp;
  };
  if constexpr (kFloat) {
    const int quads = o.wvec ? hcp / 4 : hcp;
    const int width = o.wvec ? 4 : 1;
    for (int i = tid; i < wrows * quads; i += kThreads) {
      const int r = i / quads;
      const int q = width * (i - r * quads);
      int m, k;
      w_row(r, m, k);
      const int col = c0 + q;
      const bool in = k < (m == 0 ? d : h) && col < h;
      const float* src = o.w[m] + (in ? static_cast<long long>(k) * h + col : 0);
      if (o.wvec) {
        reprotorch::cp_async16(w_sh + r * hcp + q, src, in ? 16 : 0);
      } else {
        reprotorch::cp_async4(w_sh + r * hcp + q, src, in ? 4 : 0);
      }
    }
  } else {
    // the slices' nibble bytes into raw, [r / 2][hcp] (r over the rows of
    // D, then Hp, Hp, Hp), and their scales
    int8_t* wq = reinterpret_cast<int8_t*>(raw);
    const int prow = wrows / 2;
    const int chunks = o.wvec ? hcp / 4 : hcp;
    const int width = o.wvec ? 4 : 1;
    for (int i = tid; i < prow * chunks; i += kThreads) {
      const int pr = i / chunks;
      const int q = width * (i - pr * chunks);
      int m, k;
      w_row(2 * pr, m, k);
      const int col = c0 + q;
      const bool in = k < (m == 0 ? d : h) && col < h;
      const int8_t* src = o.q[m] + (in ? static_cast<long long>(k / 2) * h + col : 0);
      if (o.wvec) {
        reprotorch::cp_async4(wq + pr * hcp + q, src, in ? 4 : 0);
      } else {
        wq[pr * hcp + q] = in ? *src : 0;
      }
    }
    for (int i = tid; i < 4 * hcp; i += kThreads) {
      const int m = i / hcp;
      const int col = c0 + (i - m * hcp);
      reprotorch::cp_async4(sc_sh + i, o.scale[m] + (col < h ? col : 0), col < h ? 4 : 0);
    }
  }
  stage_x(0);
  reprotorch::cp_async_commit();
  MEGA_STAMP(1);

  // this thread's columns c0 + grp * kCt + i: u/h carries, LIF constants
  int col[kCt];
  bool owns[kCt];
  float u0[kCt], h0[kCt], u1[kCt], h1[kCt], beta0[kCt], vth0[kCt], beta1[kCt], vth1[kCt];
#pragma unroll
  for (int i = 0; i < kCt; ++i) {
    col[i] = c0 + grp * kCt + i;
    owns[i] = live && col[i] < h;
    const long long at = static_cast<long long>(row) * h + col[i];
    u0[i] = owns[i] ? o.u0[at] : 0.0f;
    h0[i] = owns[i] ? o.h0[at] : 0.0f;
    u1[i] = owns[i] ? o.u1[at] : 0.0f;
    h1[i] = owns[i] ? o.h1[at] : 0.0f;
    const bool in = col[i] < h;
    beta0[i] = in ? o.beta[0][col[i]] : 0.0f;
    vth0[i] = in ? o.vth[0][col[i]] : 0.0f;
    beta1[i] = in ? o.beta[1][col[i]] : 0.0f;
    vth1[i] = in ? o.vth[1][col[i]] : 0.0f;
  }
  MEGA_STAMP(2);
  // the initial trains: CTA `rank` takes the rows j % C == rank of s0 then
  // s1, a warp a row (its loads first, then a ballot a 32-column word), and
  // stores each word into every CTA's copy, once every CTA of the cluster
  // runs (its shared memory can take them)
  cluster.sync();
  for (int j = rank + nctas * warp; j < 2 * ts * kSlots; j += nctas * kWarps) {
    const int which = j / (ts * kSlots);
    const int rem = j - which * ts * kSlots;
    const int t = rem / kSlots;
    const int s = rem - t * kSlots;
    const float* src = (which ? o.s1 : o.s0) + (static_cast<long long>(t) * b + row0 + s) * h;
    const bool lv = row0 + s < b;
    bool on[reprotorch::kMaxMegaHidden / 32];
#pragma unroll
    for (int kw = 0; kw < reprotorch::kMaxMegaHidden / 32; ++kw) {
      const int k = 32 * kw + lane;
      on[kw] = kw < hw && lv && k < h && src[k] != 0.0f;
    }
    uint32_t* dst = train(0, which) + rem * hw;
#pragma unroll
    for (int kw = 0; kw < reprotorch::kMaxMegaHidden / 32; ++kw) {
      if (kw >= hw) break;
      const uint32_t word = __ballot_sync(0xffffffffu, on[kw]);
      for (int p = lane; p < nctas; p += 32) *cluster.map_shared_rank(dst + kw, p) = word;
    }
  }

  MEGA_STAMP(3);
  reprotorch::cp_async_wait_all();
  float sc1[kCt], sc2[kCt], sc3[kCt];  // int4: W0h, W1x, W1h's column scales
  if constexpr (!kFloat) {
    // from the staged nibbles: L0's input slice dequantized (W = nibble *
    // scale), and each other slice's bit planes and int8 nibbles
    __syncthreads();
    const int8_t* wq = reinterpret_cast<const int8_t*>(raw);
    auto nib = [&](int r, int q) {  // the nibble of slice row r, column q
      const int byte = wq[(r / 2) * hcp + q];
      return ((((r & 1) ? (byte >> 4) : byte) & 0xF) ^ 8) - 8;
    };
    for (int i = tid; i < d * hcp; i += kThreads) {
      const int q = i % hcp;
      w_sh[i] = __fmul_rn(static_cast<float>(nib(i / hcp, q)), sc_sh[q]);
    }
    for (int i = tid; i < 3 * hw * hcp; i += kThreads) {
      const int q = i % hcp;
      const int mk = i / hcp;  // (matrix - 1) * hw + kw
      const int r0 = d + (mk / hw) * hp + 32 * (mk % hw);
      uint32_t pl[4] = {0u, 0u, 0u, 0u};
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int v = nib(r0 + j, q) & 0xF;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) pl[bb] |= ((v >> bb) & 1u) << j;
      }
      planes[i] = make_uint4(pl[0], pl[1], pl[2], pl[3]);
    }
    for (int i = tid; i < 3 * hp * hcp; i += kThreads) {
      q_sh[i] = static_cast<int8_t>(nib(d + i / hcp, i % hcp));
    }
#pragma unroll
    for (int i = 0; i < kCt; ++i) {
      const int q = grp * kCt + i;
      sc1[i] = sc_sh[hcp + q];
      sc2[i] = sc_sh[2 * hcp + q];
      sc3[i] = sc_sh[3 * hcp + q];
    }
  }
  MEGA_STAMP(4);
  cluster.sync();  // the slices, frame 0's inputs and both trains are in place
  MEGA_STAMP(5);
  if (o.spike) {
    compact_train(train(0, 0), ts, hw, lde, ev_l[0], cnt_l[0]);
    compact_train(train(0, 1), ts, hw, lde, ev_l[1], cnt_l[1]);
  }
  const float* w0x = w_sh;
  const float* w0h = w_sh + d * hcp;
  const float* w1x = w0h + hp * hcp;
  const float* w1h = w1x + hp * hcp;
  const unsigned bit_mask = o.input_bits <= 0 ? 0u
      : o.input_bits >= 32 ? 0xffffffffu : ((1u << o.input_bits) - 1u);

  // the FC: this CTA's columns [cbeg, cend), sub-tiles of o.cols
  const int cols = o.cols;
  const int nc = ceil_div(ceil_div(n, nctas), cols) * cols;
  const int cbeg = rank * nc;
  const int cend = min(n, cbeg + nc);
  const int tiles = cend > cbeg ? ceil_div(cend - cbeg, cols) : 0;
  const int lcols = __ffs(cols) - 1;  // cols is a power of two
  const int entries_all = lay.entries;
  // Start copying FC sub-tile j (dense_float: into raw or tile by j; K7
  // dense_float: only the rows of the tile's union, `entries` of them).
  auto stage_fc = [&](int j, int entries) {
    const int cf = cbeg + j * cols;
    // rows of 4-byte elements, [rows][cols] into dst: row e from src row
    // row(e), 16 bytes a copy where vec16 (columns past n zero-filled)
    auto stage_rows = [&](const void* src, int rows, const uint8_t* row_of,
                          void* dst) {
      const int lw = o.vec16 ? lcols - 2 : lcols;  // log2(copies a row)
      const int width = o.vec16 ? 4 : 1;
      for (int i = tid; i < rows << lw; i += kThreads) {
        const int e = i >> lw;
        const int c = cf + width * (i & ((1 << lw) - 1));
        const bool in = c < n;
        const long long at = in ? static_cast<long long>(row_of ? row_of[e] : e) * n + c : 0;
        const float* from = static_cast<const float*>(src) + at;
        float* to = static_cast<float*>(dst) + width * i;
        if (o.vec16) {
          reprotorch::cp_async16(to, from, in ? 16 : 0);
        } else {
          reprotorch::cp_async4(to, from, in ? 4 : 0);
        }
      }
    };
    if (o.fc_mode == kFcCsc) {
      stage_rows(o.fc_a, entries, nullptr, raw);
      stage_rows(o.fc_values, entries, nullptr, raw + 4 * entries * cols);
    } else if constexpr (float_fc) {  // K7: only the rows of the tile's union
      stage_rows(o.fc_a, entries, o.spike ? uni : nullptr, (j & 1) ? tile : raw);
    }
    if constexpr (!float_fc) {  // the sub-tile's scales
      for (int c = tid; c < cols; c += kThreads) {
        const bool in = cf + c < n;
        reprotorch::cp_async4(fsc + (j & 1) * cols + c, o.fc_scale + (in ? cf + c : 0),
                              in ? 4 : 0);
      }
    }
    if (o.fc_mode == kFcNm || o.fc_mode == kFcDenseInt4) {
      // one byte an entry: nm's entries or dense_int4's row pairs
      const int rows = o.fc_mode == kFcNm ? o.nnz : h / 2;
      const int8_t* src = static_cast<const int8_t*>(o.fc_a);
      int8_t* dst = reinterpret_cast<int8_t*>(raw);
      if (o.w16) {
        const int lc = lcols - 4;  // log2(16-byte copies a row)
        for (int i = tid; i < rows << lc; i += kThreads) {
          const int e = i >> lc;
          const int c = cf + 16 * (i & ((1 << lc) - 1));
          const bool in = c < n;
          reprotorch::cp_async16(dst + 16 * i, src + (in ? static_cast<long long>(e) * n + c : 0),
                                 in ? 16 : 0);
        }
      } else {
        for (int i = tid; i < rows * cols; i += kThreads) {
          const int e = i >> lcols;
          const int c = cf + (i & (cols - 1));
          dst[i] = c < n ? src[static_cast<long long>(e) * n + c] : 0;
        }
      }
    }
  };
  // Decode the staged int4 sub-tile into mma's B operand: b8[c][k] the
  // weight of hidden row k in column c (k-contiguous, zero where no entry
  // names the row).  dense_int4 unpacks every row; csc and nm scatter their
  // entries (each names a row at most once; pads and rows outside [0, H)
  // add nothing).
  int8_t* b8 = reinterpret_cast<int8_t*>(tile);
  auto decode_fc = [&]() {
    const int8_t* wp = reinterpret_cast<const int8_t*>(raw);
    if (o.fc_mode == kFcDenseInt4) {  // b8[c][8q .. 8q + 7] from pairs 4q .. 4q + 3
      for (int i = tid; i < cols * (hp / 8); i += kThreads) {
        const int c = i & (cols - 1);
        *reinterpret_cast<uint2*>(b8 + c * ld + 8 * (i >> lcols)) =
            reprotorch::unpack_int4_8(wp, cols, c, i >> lcols, h / 2);
      }
      return;
    }
    for (int i = tid; i < cols * ld / 16; i += kThreads) {
      reinterpret_cast<uint4*>(b8)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    if (o.fc_mode == kFcCsc) {
      const int* ri = reinterpret_cast<const int*>(raw);
      const float* rv = reinterpret_cast<const float*>(raw) + entries_all * cols;
      for (int i = tid; i < entries_all * cols; i += kThreads) {
        const int at = ri[i];
        const float v = rv[i];
        if (static_cast<unsigned>(at) < static_cast<unsigned>(h) && v != 0.0f) {
          b8[(i & (cols - 1)) * ld + at] = static_cast<int8_t>(v);
        }
      }
    } else {  // nm, K5's walk: a column, every step-th entry
      const int step = kThreads / cols;
      const int c = tid % cols;
      int e = tid / cols;
      int slot_n = e % o.nm_n;
      int group_row = e / o.nm_n * o.nm_m;
      for (; e < entries_all; e += step) {
        const int byte = wp[e * cols + c];
        const int r = group_row + ((byte >> 4) & 0xF);
        if (r < h && (byte & 0xF) != 0) b8[c * ld + r] = static_cast<int8_t>(nibble(byte));
        for (slot_n += step; slot_n >= o.nm_n; slot_n -= o.nm_n) group_row += o.nm_m;
      }
    }
  };

  for (int f = 0; f < o.frames; ++f) {
    MEGA_STAMP(6);
    const int cur = f & 1, nxt = cur ^ 1;
    reprotorch::cp_async_wait_all();  // frame f's inputs
    __syncthreads();
    const bool early = !(o.spike && float_fc);  // sub-tile 0 needs no union
    if (early && tiles > 0) stage_fc(0, entries_all);
    reprotorch::cp_async_commit();
    const float* xs = x_sh + cur * kSlots * d;
    MEGA_STAMP(7);
    {  // input one-bits: a slot's eight lanes take every eighth input
      int c = 0;
      for (int k = grp; k < d; k += kGroups) {
        c += __popc(static_cast<unsigned>(static_cast<int>(fabsf(xs[slot * d + k]))) & bit_mask);
      }
#pragma unroll
      for (int o8 = 1; o8 < kGroups; o8 <<= 1) c += __shfl_xor_sync(0xffffffffu, c, o8);
      if (grp == 0 && slot % nctas == rank && live) {
        o.one_bits[static_cast<long long>(f) * b + row] = c;
      }
    }

    // L0: ff0 over the input row (dense: x is no spike train), rec0
    float ff[kTs][kCt], rec[kTs][kCt];
#pragma unroll
    for (int t = 0; t < kTs; ++t) {
#pragma unroll
      for (int i = 0; i < kCt; ++i) ff[t][i] = rec[t][i] = 0.0f;
    }
    {
      const float* xr = xs + slot * d;
      const float* wb = w0x + grp * kCt;
      int k = 0;
      for (; k + 4 <= d; k += 4) {
        float xv[4], wv[4][kCt];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          xv[u] = xr[k + u];
          load_w<kCt>(wb + (k + u) * hcp, wv[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int i = 0; i < kCt; ++i) ff[0][i] = fmaf(xv[u], wv[u][i], ff[0][i]);
        }
      }
      for (; k < d; ++k) {
        const float xv = xr[k];
        float wv[kCt];
        load_w<kCt>(wb + k * hcp, wv);
#pragma unroll
        for (int i = 0; i < kCt; ++i) ff[0][i] = fmaf(xv, wv[i], ff[0][i]);
      }
#pragma unroll
      for (int t = 1; t < kTs; ++t) {
#pragma unroll
        for (int i = 0; i < kCt; ++i) ff[t][i] = ff[0][i];  // the same for every t
      }
    }
    MEGA_STAMP(8);
    if constexpr (!kFloat) {
      int4_product<kTs, kCt>(o.spike, train(cur, 0), ev_l[0], cnt_l[0], ts, hw,
                             lde, slot, planes, q_sh, grp, sc1, rec);
    } else if (o.spike) {
      event_product<kTs, kCt>(ev_l[0], cnt_l[0], ts, lde, slot, w0h, grp, rec);
    } else {
      dense_product<kTs, kCt>(train(cur, 0), ts, hw, slot, w0h, grp, rec);
    }
    MEGA_STAMP(9);
    lif_chain<kTs, kCt>(ff, rec, beta0, vth0, owns, u0, h0, ts, slot, grp, hw,
                        rank, nctas, cluster, train(nxt, 0));
    MEGA_STAMP(10);
    cluster.sync();  // the new L0 train is complete in every CTA
    MEGA_STAMP(11);
    if (o.spike) {
      compact_train(train(nxt, 0), ts, hw, lde, ev_l[0], cnt_l[0]);
      __syncthreads();
    }

    // L1: ff1 over L0's new spikes, rec1 over the previous L1 train
#pragma unroll
    for (int t = 0; t < kTs; ++t) {
#pragma unroll
      for (int i = 0; i < kCt; ++i) ff[t][i] = rec[t][i] = 0.0f;
    }
    if constexpr (!kFloat) {
      int4_product<kTs, kCt>(o.spike, train(nxt, 0), ev_l[0], cnt_l[0], ts, hw,
                             lde, slot, planes + hw * hcp, q_sh + hp * hcp,
                             grp, sc2, ff);
      int4_product<kTs, kCt>(o.spike, train(cur, 1), ev_l[1], cnt_l[1], ts, hw,
                             lde, slot, planes + 2 * hw * hcp,
                             q_sh + 2 * hp * hcp, grp, sc3, rec);
    } else if (o.spike) {
      event_product<kTs, kCt>(ev_l[0], cnt_l[0], ts, lde, slot, w1x, grp, ff);
      event_product<kTs, kCt>(ev_l[1], cnt_l[1], ts, lde, slot, w1h, grp, rec);
    } else {
      dense_product<kTs, kCt>(train(nxt, 0), ts, hw, slot, w1x, grp, ff);
      dense_product<kTs, kCt>(train(cur, 1), ts, hw, slot, w1h, grp, rec);
    }
    MEGA_STAMP(12);
    lif_chain<kTs, kCt>(ff, rec, beta1, vth1, owns, u1, h1, ts, slot, grp, hw,
                        rank, nctas, cluster, train(nxt, 1));
    MEGA_STAMP(13);
    cluster.sync();  // the new L1 train is complete in every CTA
    MEGA_STAMP(14);

    if (f + 1 < o.frames) stage_x(f + 1);  // lands during the FC
    reprotorch::cp_async_commit();
    const uint32_t* s0n = train(nxt, 0);
    const uint32_t* s1n = train(nxt, 1);
    if (o.spike) compact_train(s1n, ts, hw, lde, ev_l[1], cnt_l[1]);
    // the counters of the slots this CTA counts, from its own copy
    for (int j = tid; j < ts * kSlots; j += kThreads) {
      const int t = j / kSlots;
      const int s = j - t * kSlots;
      if (s % nctas != rank || row0 + s >= b) continue;
      int c0n = 0, c1n = 0;
      for (int kw = 0; kw < hw; ++kw) {
        c0n += __popc(s0n[j * hw + kw]);
        c1n += __popc(s1n[j * hw + kw]);
      }
      const long long at = (static_cast<long long>(f) * ts + t) * b + row0 + s;
      o.spikes_l0[at] = c0n;
      o.spikes_l1[at] = c1n;
      if (t == 0) {
        int cu = 0;
        for (int kw = 0; kw < hw; ++kw) {
          uint32_t any = 0u;
          for (int tt = 0; tt < ts; ++tt) any |= s1n[(tt * kSlots + s) * hw + kw];
          cu += __popc(any);
        }
        o.union_l1[static_cast<long long>(f) * b + row0 + s] = cu;
      }
    }
    // merged spikes sum_t s1'[t] (exact), a thread a (slot, 32 rows): s8
    // [32][ld] for mma's A, or float [Hp][32] for the float FC
    for (int i = tid; i < kSlots * hw; i += kThreads) {
      const int s = i % kSlots;
      const int kw = i / kSlots;
      uint32_t words[kTs];
#pragma unroll
      for (int t = 0; t < kTs; ++t) words[t] = t < ts ? s1n[(t * kSlots + s) * hw + kw] : 0u;
      for (int j4 = 0; j4 < 32; j4 += 4) {
        uint32_t packed = 0u;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t v = 0u;
#pragma unroll
          for (int t = 0; t < kTs; ++t) v += (words[t] >> (j4 + jj)) & 1u;
          if constexpr (float_fc) {
            reinterpret_cast<float*>(mfc)[(32 * kw + j4 + jj) * kSlots + s] = static_cast<float>(v);
          }
          packed |= v << (8 * jj);
        }
        if constexpr (!float_fc) *reinterpret_cast<uint32_t*>(mfc + s * ld + 32 * kw + j4) = packed;
      }
    }
    if (o.spike && float_fc && warp == 0) {  // the tile's merged union
      const uint32_t below = (1u << lane) - 1u;
      int base = 0;
      for (int kw = 0; kw < hw; ++kw) {
        uint32_t any = 0u;
        for (int r = lane; r < ts * kSlots; r += 32) any |= s1n[r * hw + kw];
        any = __reduce_or_sync(0xffffffffu, any);
        if ((any >> lane) & 1u) uni[base + __popc(any & below)] = static_cast<uint8_t>(32 * kw + lane);
        base += __popc(any);
      }
      if (lane == 0) *uni_cnt = base;
    }
    __syncthreads();
    MEGA_STAMP(15);
    const int entries = o.spike && float_fc ? *uni_cnt : entries_all;
    if (!early && tiles > 0) stage_fc(0, entries);
    reprotorch::cp_async_commit();

    // FC readout of this CTA's columns, a sub-tile at a time
    float* out = o.logits + static_cast<long long>(f) * b * n;
    for (int j = 0; j < tiles; ++j) {
      reprotorch::cp_async_wait_all();
      __syncthreads();
      MEGA_STAMP(16);
      if constexpr (!float_fc) {
        decode_fc();
        __syncthreads();
      }
      MEGA_STAMP(17);
      if (j + 1 < tiles) stage_fc(j + 1, entries);
      reprotorch::cp_async_commit();
      const int cf = cbeg + j * cols;
      if constexpr (float_fc) {
        const float* m_f = reinterpret_cast<const float*>(mfc);
        const float* w = reinterpret_cast<const float*>((j & 1) ? tile : raw);
        const uint8_t* rows = o.spike ? uni : nullptr;
        if (cols == 128) {
          fc_float<4>(m_f, w, rows, entries, cols, cf, row0, b, n, out);
        } else if (cols == 64) {
          fc_float<2>(m_f, w, rows, entries, cols, cf, row0, b, n, out);
        } else {
          fc_float<1>(m_f, w, rows, entries, cols, cf, row0, b, n, out);
        }
      } else {
        fc_mma(reinterpret_cast<const int8_t*>(mfc), b8, ld, hp, cols, cf, row0,
               b, n, fsc + (j & 1) * cols, out, o.out8);
      }
    }
  }

  MEGA_STAMP(18);
  // the state: this CTA's columns of the last trains and the potentials
  const int fin = o.frames & 1;
  const uint32_t* s0f = train(fin, 0);
  const uint32_t* s1f = train(fin, 1);
#pragma unroll
  for (int i = 0; i < kCt; ++i) {
    if (!owns[i]) continue;
    const int k = col[i];
    for (int t = 0; t < ts; ++t) {
      const int r = (t * kSlots + slot) * hw + (k >> 5);
      const long long at = (static_cast<long long>(t) * b + row) * h + k;
      o.s0_out[at] = static_cast<float>((s0f[r] >> (k & 31)) & 1u);
      o.s1_out[at] = static_cast<float>((s1f[r] >> (k & 31)) & 1u);
    }
    const long long at = static_cast<long long>(row) * h + k;
    o.u0_out[at] = u0[i];
    o.u1_out[at] = u1[i];
  }
  MEGA_STAMP(19);
}

using MegaKernel = void (*)(const Operands);

// The instantiation for ts (kTs = 1, 2 or 4; ts = 3 runs kTs = 4 with its
// last step off), hcp = 8 kCt and the weights' precision, or null.
template <bool kFloat>
MegaKernel kernel_for(int ts, int hcp) {
  const int kts = ts <= 1 ? 1 : ts <= 2 ? 2 : 4;
  switch (kts * 100 + hcp) {
    case 108: return megastep_kernel<1, 1, kFloat>;
    case 116: return megastep_kernel<1, 2, kFloat>;
    case 132: return megastep_kernel<1, 4, kFloat>;
    case 208: return megastep_kernel<2, 1, kFloat>;
    case 216: return megastep_kernel<2, 2, kFloat>;
    case 232: return megastep_kernel<2, 4, kFloat>;
    case 408: return megastep_kernel<4, 1, kFloat>;
    case 416: return megastep_kernel<4, 2, kFloat>;
    case 432: return megastep_kernel<4, 4, kFloat>;
    default: return nullptr;
  }
}

// Check a plan and set up its launch: the kernel, its shared bytes and the
// launch configuration (grid of ceil(b / 32) clusters of `cluster` CTAs);
// the attributes the kernel needs are set.  A status, 0 when it can launch.
int plan_launch(int ts, int d, int h, int fc_mode, int nnz, bool spike,
                int rows, int cluster, int cols, int b, cudaStream_t stream,
                MegaKernel* kernel, cudaLaunchConfig_t* cfg,
                cudaLaunchAttribute* attr) {
  if (rows != kSlots || (cluster != 8 && cluster != 16) ||
      (cols != 16 && cols != 32 && cols != 64 && cols != 128)) {
    return reprotorch::kErrTilePlan;
  }
  const MegaLayout lay(ts, d, h, fc_mode, nnz, spike, cluster, cols);
  *kernel = fc_mode == kFcDenseFloat ? kernel_for<true>(ts, lay.hcp)
                                     : kernel_for<false>(ts, lay.hcp);
  if (*kernel == nullptr) return reprotorch::kErrTilePlan;
  if (lay.bytes > reprotorch::kMaxOptInSharedBytes) return reprotorch::kErrSharedMemory;
  cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(lay.bytes));
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(ceil_div(b, kSlots) * cluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = lay.bytes;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return 0;
}

// cudaOccupancyMaxActiveClusters of (kernel, shared bytes, cluster), cached:
// the launch asks it every call.
int max_clusters(MegaKernel kernel, const cudaLaunchConfig_t& cfg, int cluster,
                 int* clusters) {
  struct Entry {
    MegaKernel kernel;
    size_t smem;
    int cluster, clusters;
  };
  static std::mutex lock;
  static Entry cache[32];
  static int used = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    if (cache[i].kernel == kernel && cache[i].smem == cfg.dynamicSmemBytes &&
        cache[i].cluster == cluster) {
      *clusters = cache[i].clusters;
      return 0;
    }
  }
  const cudaError_t err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  cache[used % 32] = {kernel, cfg.dynamicSmemBytes, cluster, *clusters};
  if (used < 32) ++used;
  return 0;
}

int check_modes(int ts, int h, int precision, int fc_mode, int nnz, int nm_n,
                int nm_m) {
  if (ts > kMaxTs) return reprotorch::kErrTooManySteps;
  if (h > reprotorch::kMaxMegaHidden) return reprotorch::kErrTooWide;
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
  return 0;
}

}  // namespace

// A plan's shared bytes a CTA (info[0]) and how many of its clusters the
// card can hold at once (info[1]), or the status its launch would refuse
// it with.
extern "C" int megastep_plan_info(int ts, int d, int h, int precision,
                                  int fc_mode, int nnz, int nm_n, int nm_m,
                                  int spike, int b, int rows, int cluster,
                                  int cols, void* info) {
  int status = check_modes(ts, h, precision, fc_mode, nnz, nm_n, nm_m);
  if (status != 0) return status;
  MegaKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  status = plan_launch(ts, d, h, fc_mode, nnz, spike != 0, rows, cluster, cols,
                       b, nullptr, &kernel, &cfg, &attr);
  if (status != 0) return status;
  int* out = static_cast<int*>(info);
  out[0] = static_cast<int>(cfg.dynamicSmemBytes);
  return max_clusters(kernel, cfg, cluster, &out[1]);
}

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
    int fc, int nnz, int nm_n, int nm_m, int input_bits, int spike, int rows,
    int cluster, int cols, void* stream) {
  int status = check_modes(ts, h, precision, fc_mode, nnz, nm_n, nm_m);
  if (status != 0) return status;
  MegaKernel kernel;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  status = plan_launch(ts, d, h, fc_mode, nnz, spike != 0, rows, cluster, cols,
                       b, static_cast<cudaStream_t>(stream), &kernel, &cfg, &attr);
  if (status != 0) return status;
  int clusters = 0;
  status = max_clusters(kernel, cfg, cluster, &clusters);
  if (status != 0) return status;
  if (clusters < 1) return reprotorch::kErrCluster;
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const bool float_w = precision == kPrecisionFloat;
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
  o.cluster = cluster;
  o.cols = cols;
  o.spike = spike != 0;
  // 16-byte copies where the FC's rows, the x rows and the logits allow
  const bool csc = fc_mode == kFcCsc;
  o.vec16 = fc % 4 == 0 && reprotorch::aligned_to(fc_a, 16) &&
            (!csc || reprotorch::aligned_to(fc_values, 16));
  o.w16 = fc % 16 == 0 && reprotorch::aligned_to(fc_a, 16);
  o.x16 = d % 4 == 0 && reprotorch::aligned_to(x, 16);
  o.out8 = fc % 2 == 0 && reprotorch::aligned_to(logits, 8);
  // the layer slices' rows in 16-byte (float) or 4-byte (int4) copies
  bool wvec = h % 4 == 0;
  for (int m = 0; m < 4; ++m) wvec &= reprotorch::aligned_to(wp[m], float_w ? 16 : 4);
  o.wvec = wvec;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, o);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef REPRO_MEGASTEP_TRACE
// The stamps to the host (32 of each of 1024 CTAs), and their reset.
extern "C" int megastep_trace_read(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace)));
}

extern "C" int megastep_trace_clear() {
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, g_trace);
  return static_cast<int>(err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_trace)));
}
#endif
