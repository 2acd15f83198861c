// Error text for the status codes the launch functions return.
#include "common.cuh"

extern "C" const char* reprotorch_error_string(int code) {
  switch (code) {
    case reprotorch::kErrTooManySteps:
      return "more time steps than the kernel keeps in registers (kMaxTs)";
    case reprotorch::kErrSharedMemory:
      return "the block's tiles exceed its shared memory (227 KB, "
             "kMaxOptInSharedBytes)";
    case reprotorch::kErrCapacity:
      return "event-list capacity outside [1, k]";
    case reprotorch::kErrTooWide:
      return "hidden width over 256, the widest the megastep kernel takes "
             "(kMaxMegaHidden)";
    case reprotorch::kErrFcMode:
      return "an FC mode or weight precision the megastep kernel does not "
             "serve (int4 weights: dense_int4, csc, nm; float weights: "
             "dense_float)";
    case reprotorch::kErrNmGeometry:
      return "an N:M geometry the kernel does not take (needs 1 <= n <= m "
             "<= 16 and entries a multiple of n)";
    case reprotorch::kErrTilePlan:
      return "a tile plan the kernel does not take (rsnn_cell: 4, 8, 16 or "
             "32 rows, 16, 32 or 64 neurons, a warp at least; spike_cell: 1-32 "
             "rows (a power of two) in whole groups of 4 / TS rows (one at TS "
             "3 and 4), at most 8 groups, 32, 64 or 128 neurons; delta_step: "
             "1-32 rows (a power of two) by 32, 64 or 128 columns, 1 to 32 warps "
             "of 4 columns a thread; spike_broadcast: "
             "rows a multiple of 4, 32, 64 or 128 columns; sparse_fc: 32 or 64 rows, "
             "columns a multiple of 32; nm_fc: 32 or 64 rows, 32, 64 or 128 "
             "columns; int4_matmul, merged_spike_fc: 16, 32 or 64 rows, 8, 16, "
             "32, 64 or 128 columns; megastep: 32 slots, clusters of 8 or 16, "
             "16, 32, 64 or 128 FC columns a sub-tile)";
    case reprotorch::kErrCluster:
      return "no thread-block cluster of the megastep plan can be resident "
             "on the card (cudaOccupancyMaxActiveClusters is 0)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
