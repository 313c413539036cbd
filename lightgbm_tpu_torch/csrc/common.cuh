// Shared device helpers for the partitioned-trainer kernels (sm_90a).
//
// The packed matrix P is a row-major (C, ld) int32 array: channel c of
// data row r lives at P[c * ld + r].  Float channels (grad, hess,
// select, score, label, weight) are float32 bit patterns.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace lgbt {

constexpr int kThreads = 256;  // every kernel here launches 256-thread blocks

__device__ __forceinline__ float f32_at(const int32_t* P, long long ld, int row, long long r) {
  return __int_as_float(P[(long long)row * ld + r]);
}

// Split predicate of one row (pkernels.py _run_segment): bin field, EFB
// range remap, zero-bin -> default-bin-for-zero, then == (categorical)
// or <= (numerical) against the threshold bin.
struct SegParams {
  long long start;
  int cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo, off_hi, bias;
};

__device__ __forceinline__ SegParams load_seg(const int32_t* seg, int s) {
  const int32_t* q = seg + 12 * s;
  SegParams p;
  p.start = q[0];
  p.cnt = q[1];
  p.word = q[2];
  p.shift = q[3];
  p.zero_bin = q[4];
  p.dbz = q[5];
  p.thr = q[6];
  p.is_cat = q[7];
  p.off_lo = q[8];
  p.off_hi = q[9];
  p.bias = q[10];
  return p;
}

__device__ __forceinline__ int goes_left(int32_t word, const SegParams& p, unsigned vmask) {
  int v = (int)(((uint32_t)word >> p.shift) & vmask);
  int fb = (v >= p.off_lo && v < p.off_hi) ? (v - p.off_lo + p.bias) : p.zero_bin;
  int fv = (fb == p.zero_bin) ? p.dbz : fb;
  return p.is_cat ? (fv == p.thr) : (fv <= p.thr);
}

// Bin of feature f in its packed word (bits-wide fields, 32/bits per word).
__device__ __forceinline__ int bin_of(const int32_t* P, long long ld, long long r, int f, int bits) {
  int per = 32 / bits;
  uint32_t w = (uint32_t)P[(long long)(f / per) * ld + r];
  return (int)((w >> ((f % per) * bits)) & ((1u << bits) - 1u));
}

// Inclusive block-wide prefix sum of one int per thread; *total gets the
// block sum.  warp_sums must hold 32 ints of shared memory.  Every thread
// of the block must call it.
__device__ __forceinline__ int block_incl_scan(int v, int* warp_sums, int* total) {
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = (blockDim.x + 31) >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  int add = 0, tot = 0;
  for (int k = 0; k < nw; ++k) {
    int w = warp_sums[k];
    if (k < wid) add += w;
    tot += w;
  }
  __syncthreads();
  *total = tot;
  return x + add;
}

// Segment owning flat tile index b: the largest s < n_seg with
// tile_base[s] <= b (empty segments own no tiles).
__device__ __forceinline__ int seg_of_tile(const int32_t* tile_base, int n_seg, int b) {
  int lo = 0, hi = n_seg - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (tile_base[mid] <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Largest shared-memory block the current device allows (opt-in limit).
inline int max_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

inline int num_sms() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
  return v;
}

}  // namespace lgbt
