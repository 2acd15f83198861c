// Error text for the status codes the launch functions return.
#include "common.cuh"

extern "C" const char* reprotorch_error_string(int code) {
  switch (code) {
    case reprotorch::kErrTooManySteps:
      return "more time steps than the kernel keeps in registers (kMaxTs)";
    case reprotorch::kErrSharedMemory:
      return "the block's operand rows exceed its shared memory (kMaxSharedBytes)";
    case reprotorch::kErrCapacity:
      return "event-list capacity outside [1, k]";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
