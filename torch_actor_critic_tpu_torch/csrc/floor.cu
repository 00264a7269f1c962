// An empty kernel: the latency floor of one launch on this card.
//
// Replaces no TPU kernel. chip_smoke.py times it at the attention kernels'
// main-path grid (64 blocks of 128 threads) and at one block, so that their
// device times can be read against what no design of theirs can remove.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// smem: dynamic shared memory reserved per block (unused), at most 48 KB.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tac_empty(int grid, int block, int smem, void* stream) {
  if (grid < 1 || block < 1 || block > 1024 || smem < 0 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  empty_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
