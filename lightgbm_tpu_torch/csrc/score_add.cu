// score_add for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pkernels.py score_add (_score_band_kernel):
// score channel k of the packed matrix += delta over the first num_rows
// columns, in place (the fused trainer's chunk-end settle of the last
// tree's pending score delta, and each multiclass tree's update).
//
// What bounds it on this card: bytes — 12 B/row (read score and delta,
// write score), ~0.04 ms at 10.5M rows and 3.35 TB/s.  The TPU kernel
// streamed the whole 8-row mutable band through VMEM because Mosaic DMAs
// need (8, 128)-aligned row blocks; here only the one score row moves.
//
// Design: one float4 of the row per thread, one 256-thread block for
// every 1024 values (on an H100 a grid capped at a few blocks an SM,
// striding over the row, ran slower than Tensor.add_, and more float4 a
// thread ran no faster).  The score row starts at row * ld * 4 bytes,
// which is 16-byte aligned only when row * ld % 4 == 0, so a scalar head
// brings the score to a 16-byte boundary and a scalar tail ends it.
// delta is read through the read-only path, as float4 when it lies at
// the same offset from a 16-byte boundary as the score, else as four
// scalars.
#include "common.cuh"

namespace lgbt {

__global__ void __launch_bounds__(kThreads) score_add_kernel(float* score, const float* delta,
                                                              long long n, int head,
                                                              bool delta_vec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < head) score[tid] += __ldg(delta + tid);
  const long long nvec = (n - head) / 4;
  if (tid < nvec) {
    float4* sv = reinterpret_cast<float4*>(score + head) + tid;
    const float* dv = delta + head + 4 * tid;
    const float4 d =
        delta_vec ? __ldg(reinterpret_cast<const float4*>(dv))
                  : make_float4(__ldg(dv), __ldg(dv + 1), __ldg(dv + 2), __ldg(dv + 3));
    float4 x = *sv;
    x.x += d.x;
    x.y += d.y;
    x.z += d.z;
    x.w += d.w;
    *sv = x;
  }
  const long long t = head + nvec * 4 + tid;
  if (t < n) score[t] += __ldg(delta + t);
}

}  // namespace lgbt

extern "C" int lgbt_score_add(void* P, long long ld, int row, void* delta, int n, void* stream) {
  if (n <= 0) return 0;
  float* score = reinterpret_cast<float*>((int32_t*)P + (long long)row * ld);
  const float* d = (const float*)delta;
  const int head = (int)std::min<long long>(((16 - (uintptr_t)score % 16) % 16) / 4, n);
  const bool delta_vec = ((uintptr_t)(d + head)) % 16 == 0;
  const long long nvec = (n - head) / 4;
  const int grid = (int)std::max<long long>(1, (nvec + lgbt::kThreads - 1) / lgbt::kThreads);
  lgbt::score_add_kernel<<<grid, lgbt::kThreads, 0, (cudaStream_t)stream>>>(score, d, n, head,
                                                                              delta_vec);
  return (int)cudaGetLastError();
}
