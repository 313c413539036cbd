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
// (update_hist.cu, update_channels.cu), chosen at compile time.  Each
// kind reads up to three float constants (objective/*.py
// kernel_params):
//   kBinary   p0 = sigmoid, p1 = w_pos, p2 = w_neg
//   kL2       -
//   kL1       p0 = gaussian_eta
//   kHuber    p0 = gaussian_eta, p1 = huber_delta
//   kFair     p0 = fair_c, p1 = fair_c * fair_c (rounded once)
//   kPoisson  p0 = poisson_max_delta_step
// A source dispatches on every kind by name and returns
// cudaErrorInvalidValue for any other value.
enum ObjKind { kBinary = 0, kL2 = 1, kL1 = 2, kHuber = 3, kFair = 4, kPoisson = 5 };
constexpr int kNumObjKinds = 6;

// float32(sqrt(2 pi)) and float32(1e-10), as the JAX expressions round them
constexpr float kSqrt2Pi = 2.5066282749176025f;
constexpr float kMinC = 1.0e-10f;

// Common::ApproximateHessianWithGaussian as objective/regression.py
// _gaussian_hessian evaluates it, operation for operation (the build
// passes -fmad=false, so no two of them contract); w is the row weight
// (1 without weights: every product by it is then exact).
__device__ __forceinline__ float gaussian_hessian(float score, float label, float grad,
                                                  float eta, float w) {
  const float x = fabsf(score - label);
  const float a = (2.0f * fabsf(grad)) * w;
  const float c = fmaxf((fabsf(score) + fabsf(label)) * eta, kMinC);
  const float e = exp_f32((-x * x) / ((2.0f * c) * c));
  return ((w * e) * a) / (c * kSqrt2Pi);
}

// (g, h) of one row; w is the row weight, 1 when use_weight is 0.  L1
// and Huber take the weight inside (as the reference writes them), the
// others multiply by it afterwards.
template <int KIND>
__device__ __forceinline__ void gradients(float score, float label, float w, int use_weight,
                                          float p0, float p1, float p2, float* g, float* h) {
  static_assert(KIND >= 0 && KIND < kNumObjKinds, "unknown objective kind");
  if (KIND == kBinary) {
    // objective/binary.py gradients_rowwise (binary_objective.hpp:95-99)
    const bool pos = label > 0.0f;
    const float sign = pos ? 1.0f : -1.0f;
    const float lw = pos ? p1 : p2;
    const float response = (-sign * p0) / (1.0f + exp_f32(sign * p0 * score));
    const float ar = fabsf(response);
    *g = response * lw;
    *h = ar * (p0 - ar) * lw;
  } else if (KIND == kL2) {
    // objective/regression.py RegressionL2Loss
    *g = score - label;
    *h = 1.0f;
  } else if (KIND == kL1) {
    // RegressionL1Loss: sign(diff) * w, the Gaussian hessian
    *g = (score - label >= 0.0f ? 1.0f : -1.0f) * w;
    *h = gaussian_hessian(score, label, *g, p0, w);
    return;
  } else if (KIND == kHuber) {
    // RegressionHuberLoss: quadratic inside |diff| <= delta
    const float diff = score - label;
    if (fabsf(diff) <= p1) {
      *g = diff * w;
      *h = 1.0f * w;
    } else {
      *g = (diff >= 0.0f ? p1 : -p1) * w;
      *h = gaussian_hessian(score, label, *g, p0, w);
    }
    return;
  } else if (KIND == kFair) {
    // RegressionFairLoss: c*x/(|x|+c), c^2/(|x|+c)^2
    const float x = score - label;
    const float ax_c = fabsf(x) + p0;
    *g = (p0 * x) / ax_c;
    *h = p1 / (ax_c * ax_c);
  } else {
    // RegressionPoissonLoss: raw-score space, hess = score + max_delta_step
    *g = score - label;
    *h = score + p0;
  }
  if (use_weight) {
    *g = *g * w;
    *h = *h * w;
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

namespace {

constexpr int kMaxDevices = 64;
// four histogram kernels an objective kind (update_hist.cu's slot0 =
// 4 * kind) in the source that has the most
constexpr int kMaxKernelSlots = 4 * kNumObjKinds;

// Each device's SM count and opt-in shared-memory limit, and the dynamic
// shared memory each kernel slot opted in to there (an attribute of the
// device's context).  File-local (internal linkage, so no GNU unique
// symbol): one table a source, and another copy of the library loaded
// into the process keeps its own.
struct DeviceLimits {
  int sms = 0, optin = 0;
  size_t smem[kMaxKernelSlots] = {};
};

inline DeviceLimits* device_limits() {
  static DeviceLimits table[kMaxDevices];
  return table;
}

// The current device's SM count, and the dynamic shared memory a block of
// `kernel` may take there: the opt-in limit less the kernel's static
// arrays, opted in at the kernel's first launch on the device.  `slot`
// (< kMaxKernelSlots) names the kernel within its source.
template <class K>
inline cudaError_t kernel_limits(K* kernel, int slot, int* sms, size_t* smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices || slot < 0 || slot >= kMaxKernelSlots)
    return cudaErrorInvalidValue;
  DeviceLimits& d = device_limits()[dev];
  if (d.sms == 0) {
    d.sms = num_sms();
    d.optin = max_smem_optin();
  }
  if (d.smem[slot] == 0) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    const size_t limit = (size_t)d.optin - fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)limit);
    if (e != cudaSuccess) return e;
    d.smem[slot] = limit;
  }
  *sms = d.sms;
  *smem = d.smem[slot];
  return cudaSuccess;
}

}  // namespace

// ---- histogram warps over rows staged in shared memory
// (partition_hist.cu, segment_hist.cu).  A staged channel holds a chunk's
// rows at a stride that is a multiple of 4, so four rows are one 16-byte
// load.

__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) & ~(size_t)15; }

// Features of one stripe of cells: 128 bytes of cells, one per lane, a
// bank each (16 float64 or 32 int32 cells).  Feature lf's cell (bin, v)
// lies at ((lf / S * nb + bin) * 3 + v) * S + lf % S, so the lanes of a
// warp, a feature each, read and write without bank conflicts whatever
// their bins.
__host__ __device__ constexpr int stripe_of(size_t cell) { return (int)(128 / cell); }

// Cells of one copy for nfl features of nb bins in stripes of S features.
__host__ __device__ __forceinline__ int stripe_span(int nfl, int nb, int S) {
  return (nfl + S - 1) / S * S * nb * 3;
}

// A staged value from its int32 word: float32 bits, or a plain int32.
__device__ __forceinline__ void from_bits(int b, float& v) { v = __int_as_float(b); }
__device__ __forceinline__ void from_bits(int b, int& v) { v = b; }

// Four staged values of one channel, one 16-byte load.
template <class V>
__device__ __forceinline__ void load4(const V* p, V (&o)[4]) {
  const int4 x = *reinterpret_cast<const int4*>(p);
  from_bits(x.x, o[0]);
  from_bits(x.y, o[1]);
  from_bits(x.z, o[2]);
  from_bits(x.w, o[3]);
}

// Four staged rows (from row i): one channel of bin words, and g*sel,
// h*sel, sel (three channels `stride` apart): four 16-byte loads.
template <class V>
struct Staged4 {
  int4 w;
  V g[4], h[4], c[4];
  __device__ __forceinline__ void load(const int32_t* wrow, const V* sv, int i, int stride) {
    w = *reinterpret_cast<const int4*>(wrow + i);
    load4(sv + i, g);
    load4(sv + stride + i, h);
    load4(sv + 2 * stride + i, c);
  }
};

// Add four staged rows (the first n of them) of one feature into a lane's
// own cells: cell (bin, v) at base[bin * bstride + v * vstride], for the
// bins of [blo, blo + nbr).  Rows of one bin are summed in registers
// first, so the read-add-writes that remain touch distinct cells and
// overlap.
template <class V, class C>
__device__ __forceinline__ void add_rows4(const Staged4<V>& q, int n, int sh, unsigned vmask,
                                          int blo, unsigned nbr, C* base, int bstride,
                                          int vstride) {
  const int wv[4] = {q.w.x, q.w.y, q.w.z, q.w.w};
  int bin[4];
  bool live[4];
  C sg[4], shh[4], sc[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    bin[u] = (int)(((uint32_t)wv[u] >> sh) & vmask);
    live[u] = u < n && (unsigned)(bin[u] - blo) < nbr;
    sg[u] = q.g[u];
    shh[u] = q.h[u];
    sc[u] = q.c[u];
  }
#pragma unroll
  for (int u = 1; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < u; ++v)
      if (live[u] && live[v] && bin[u] == bin[v]) {
        sg[v] += sg[u];
        shh[v] += shh[u];
        sc[v] += sc[u];
        live[u] = false;
      }
  C* cell[4];
  C old[4][3];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    cell[u] = base + bin[u] * bstride;
    if (live[u]) {
      old[u][0] = cell[u][0];
      old[u][1] = cell[u][vstride];
      old[u][2] = cell[u][2 * vstride];
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (live[u]) {
      cell[u][0] = old[u][0] + sg[u];
      cell[u][vstride] = old[u][1] + shh[u];
      cell[u][2 * vstride] = old[u][2] + sc[u];
    }
}

}  // namespace lgbt
