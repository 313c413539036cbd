// score_add for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pkernels.py score_add (_score_band_kernel):
// score channel k of the packed matrix += delta over the first num_rows
// columns, in place (the fused trainer's chunk-end settle of the last
// tree's pending score delta).
//
// What bounds it on this card: bytes — 12 B/row (read score and delta,
// write score), ~0.04 ms at 10.5M rows and 3.35 TB/s.  The TPU kernel
// streamed the whole 8-row mutable band through VMEM because Mosaic DMAs
// need (8, 128)-aligned row blocks; here only the one score row moves.
//
// Design: a grid-stride elementwise add over the score row viewed as
// float32, one element per thread per step (coalesced).
#include "common.cuh"

namespace lgbt {

__global__ void __launch_bounds__(kThreads) score_add_kernel(int32_t* P, long long ld, int row,
                                                              const float* delta, int n) {
  float* score = reinterpret_cast<float*>(P + (long long)row * ld);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n; r += stride)
    score[r] = score[r] + delta[r];
}

}  // namespace lgbt

extern "C" int lgbt_score_add(void* P, long long ld, int row, void* delta, int n, void* stream) {
  if (n <= 0) return 0;
  long long want = ((long long)n + lgbt::kThreads - 1) / lgbt::kThreads;
  int grid = (int)std::min<long long>(want, 16LL * lgbt::num_sms());
  lgbt::score_add_kernel<<<grid, lgbt::kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)P, ld, row, (const float*)delta, n);
  return (int)cudaGetLastError();
}
