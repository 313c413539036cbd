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

// Histogram accumulator.  The kernels add the float32 (g*sel, h*sel, sel)
// of each row into float64 cells (shared memory, then global), and the
// wrappers round each sum to float32 once.  The float64 sum of float32
// terms is the same in any order up to ~1e-16 relative, so the rounded
// histogram is the correctly rounded one nearly always: equal to the
// plain versions' (which sum in float64 too) and the same from run to
// run, whatever order the atomics land in.  Split search compares gains
// that are often tied exactly (equal row sets, two-valued gradients of a
// first multiclass iteration); with float32 atomics those ties broke by
// the order of the additions.
using hacc = double;

// exp of a float32, taken in float64 and rounded once: the correctly
// rounded value (but for ~2^-29 of arguments).  The plain PyTorch
// versions take the objectives' exp the same way; float32 expf and
// PyTorch's CPU exp each miss it by an ulp on some arguments, which made
// the card's gradients differ from the CPU's.
__device__ __forceinline__ float exp_f32(float x) { return (float)exp((double)x); }

__device__ __forceinline__ float f32_at(const int32_t* P, long long ld, int row, long long r) {
  return __int_as_float(P[(long long)row * ld + r]);
}

// The row-local objectives of the single-tree update kernels
// (update_hist.cu, update_channels.cu), chosen at compile time.
enum ObjKind { kBinary = 0, kL2 = 1 };

template <int KIND>
__device__ __forceinline__ void gradients(float score, float label, float weight, int use_weight,
                                          float sigmoid, float w_pos, float w_neg, float* g,
                                          float* h) {
  if (KIND == kBinary) {
    // objective/binary.py gradients_rowwise (binary_objective.hpp:95-99)
    bool pos = label > 0.0f;
    float sign = pos ? 1.0f : -1.0f;
    float lw = pos ? w_pos : w_neg;
    float response = (-sign * sigmoid) / (1.0f + exp_f32(sign * sigmoid * score));
    float ar = fabsf(response);
    *g = response * lw;
    *h = ar * (sigmoid - ar) * lw;
  } else {
    // objective/regression.py RegressionL2Loss
    *g = score - label;
    *h = 1.0f;
  }
  if (use_weight) {
    *g = *g * weight;
    *h = *h * weight;
  }
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
