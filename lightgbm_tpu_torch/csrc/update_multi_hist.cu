// update_multi_and_hists for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pkernels.py update_multi_and_hists
// (_upd_multi_kernel): one pass over all N rows of the packed matrix that
// reads the K score channels, label, weight and select of each row,
// computes every class's (grad, hess) from the same score snapshot — a
// softmax across the K scores of the row, or one-vs-all sigmoids with
// class k's own label weights — writes the 2K gradient channels (and the
// select channel when a new one is given) back in place, and accumulates
// the K root (F, B, 3) histograms of the fresh values.  The K histograms
// share one count plane, so a histogram cell holds 2K+1 floats:
// [g_0*sel, h_0*sel, ..., g_{K-1}*sel, h_{K-1}*sel, sel].
//
// What bounds it on this card: the bytes are small (W bin words + K
// scores + label, weight, select read, 2K channels written: ~80 B/row at
// K=7, ~0.01 ms at 465k rows and 3.35 TB/s), so the kernel is bound by
// the (2K+1)*F shared-memory float64 atomics each row issues into the
// block's private histogram.  The TPU kernel's one-hot matmuls (whose
// 6K+1 bf16 value rows had to fit the MXU's sublanes) are not carried
// over: the card has atomics in shared memory.
//
// Design: grid-stride rows, one row per thread per step, the K scores and
// the K (g, h) pairs in registers (loops unrolled to kMaxK = 16 with a
// runtime guard).  Each block owns a float64 sub-histogram of its
// feature tile in shared memory ((2K+1)*B cells per feature, common.cuh
// hacc) and flushes it to the global (F, B, 2K+1) histogram with
// atomicAdd (zeros skipped).  Features are tiled over gridDim.y so any
// F*B*(2K+1) fits the 227 KB block limit (K=16, F=28, B=64 needs 473 KB);
// with more than one tile the channel update runs as its own launch
// first and the histogram launch reads the freshly written channels, as
// update_hist.cu does.  Compiled with -fmad=false, the plain version's
// float32 operation order, and exp_f32 (common.cuh), so g/h equal the
// plain version's bit for bit.
#include "common.cuh"

namespace lgbt {

constexpr int kMaxK = 16;

enum MultiKind { kSoftmax = 0, kOva = 1 };

struct MultiArgs {
  int32_t* P;
  long long ld;
  int n;
  const float* sel;  // (n,) or null
  int row_g0, row_sel, row_score, row_label, row_weight, use_weight;
  int K;
  float sigmoid;
  const float* wts;  // (2K,): one-vs-all w_pos[k], then w_neg[k]
  int nf, nb, bits, f_tile;
  hacc* hist;  // (F, B, 2K+1)
};

// objective/multiclass.py gradients_rowwise_all for one row
template <int KIND>
__device__ __forceinline__ void multi_gradients(const MultiArgs& a, long long r, float* g,
                                                float* h) {
  const float label = f32_at(a.P, a.ld, a.row_label, r);
  float s[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k)
    if (k < a.K) s[k] = f32_at(a.P, a.ld, a.row_score + k, r);
  if (KIND == kSoftmax) {
    // subtract the max, exp, sum, divide; grad = p - 1[y=k], hess = 2p(1-p)
    float m = s[0];
#pragma unroll
    for (int k = 1; k < kMaxK; ++k)
      if (k < a.K) m = fmaxf(m, s[k]);
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < a.K) {
        s[k] = exp_f32(s[k] - m);
        sum = sum + s[k];
      }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < a.K) {
        const float p = s[k] / sum;
        g[k] = p - (label == (float)k ? 1.0f : 0.0f);
        h[k] = 2.0f * p * (1.0f - p);
      }
  } else {
    // K binary loglosses, class k's positives being label == k
    // (binary_objective.hpp:95-99)
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < a.K) {
        const bool pos = label == (float)k;
        const float sign = pos ? 1.0f : -1.0f;
        const float lw = pos ? a.wts[k] : a.wts[a.K + k];
        const float response = (-sign * a.sigmoid) / (1.0f + exp_f32(sign * a.sigmoid * s[k]));
        const float ar = fabsf(response);
        g[k] = response * lw;
        h[k] = ar * (a.sigmoid - ar) * lw;
      }
  }
  if (a.use_weight) {
    const float w = f32_at(a.P, a.ld, a.row_weight, r);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < a.K) {
        g[k] = g[k] * w;
        h[k] = h[k] * w;
      }
  }
}

// UPDATE: recompute and write the channels.  HIST: accumulate the
// histograms (from the fresh values when UPDATE, else from the channels).
template <int KIND, bool UPDATE, bool HIST>
__global__ void __launch_bounds__(kThreads) upd_multi_kernel(MultiArgs a) {
  extern __shared__ hacc sh[];
  const int V = 2 * a.K + 1;
  const int f0 = blockIdx.y * a.f_tile;
  const int f1 = min(f0 + a.f_tile, a.nf);
  const int span = (f1 - f0) * a.nb * V;
  if (HIST) {
    for (int i = threadIdx.x; i < span; i += blockDim.x) sh[i] = 0.0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < a.n; r += stride) {
    float g[kMaxK], h[kMaxK], s;
    if (UPDATE) {
      multi_gradients<KIND>(a, r, g, h);
      s = a.sel ? a.sel[r] : f32_at(a.P, a.ld, a.row_sel, r);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < a.K) {
          a.P[(long long)(a.row_g0 + 2 * k) * a.ld + r] = __float_as_int(g[k]);
          a.P[(long long)(a.row_g0 + 2 * k + 1) * a.ld + r] = __float_as_int(h[k]);
        }
      if (a.sel) a.P[(long long)a.row_sel * a.ld + r] = __float_as_int(s);
    } else {
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < a.K) {
          g[k] = f32_at(a.P, a.ld, a.row_g0 + 2 * k, r);
          h[k] = f32_at(a.P, a.ld, a.row_g0 + 2 * k + 1, r);
        }
      s = f32_at(a.P, a.ld, a.row_sel, r);
    }
    if (HIST && s != 0.0f) {  // an unselected row adds nothing
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < a.K) {
          g[k] = g[k] * s;
          h[k] = h[k] * s;
        }
      for (int f = f0; f < f1; ++f) {
        const int b = bin_of(a.P, a.ld, r, f, a.bits);
        if (b >= a.nb) continue;
        hacc* cell = sh + ((f - f0) * a.nb + b) * V;
#pragma unroll
        for (int k = 0; k < kMaxK; ++k)
          if (k < a.K) {
            atomicAdd(cell + 2 * k, g[k]);
            atomicAdd(cell + 2 * k + 1, h[k]);
          }
        atomicAdd(cell + 2 * a.K, s);
      }
    }
  }
  if (HIST) {
    __syncthreads();
    hacc* out = a.hist + (long long)f0 * a.nb * V;
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      const hacc v = sh[i];
      if (v != 0.0) atomicAdd(out + i, v);
    }
  }
}

template <int KIND, bool UPDATE, bool HIST>
cudaError_t launch_multi(const MultiArgs& a, dim3 grid, size_t smem, cudaStream_t stream) {
  auto k = upd_multi_kernel<KIND, UPDATE, HIST>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  k<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t run_multi(MultiArgs a, cudaStream_t stream) {
  const int cell = a.nb * (2 * a.K + 1) * (int)sizeof(hacc);
  a.f_tile = std::max(1, std::min(a.nf, max_smem_optin() / cell));
  const int tiles = (a.nf + a.f_tile - 1) / a.f_tile;
  // at least 4 rows per thread, so the per-block flush stays small
  // against the rows a block accumulates
  const long long want = ((long long)a.n + 4 * kThreads - 1) / (4 * kThreads);
  const int gx = (int)std::min<long long>(std::max<long long>(want, 1), 4LL * num_sms());
  const size_t smem = (size_t)a.f_tile * cell;
  if (tiles == 1) return launch_multi<KIND, true, true>(a, dim3(gx, 1), smem, stream);
  cudaError_t e = launch_multi<KIND, true, false>(a, dim3(gx, 1), 0, stream);
  if (e != cudaSuccess) return e;
  return launch_multi<KIND, false, true>(a, dim3(gx, tiles), smem, stream);
}

}  // namespace lgbt

extern "C" int lgbt_update_multi_hist(void* P, long long ld, int n, void* sel, int row_g0,
                                      int row_sel, int row_score, int row_label, int row_weight,
                                      int use_weight, int kind, int K, float sigmoid, void* wts,
                                      int nf, int nb, int bits, void* hist, void* stream) {
  if (K < 1 || K > lgbt::kMaxK) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  lgbt::MultiArgs a;
  a.P = (int32_t*)P;
  a.ld = ld;
  a.n = n;
  a.sel = (const float*)sel;
  a.row_g0 = row_g0;
  a.row_sel = row_sel;
  a.row_score = row_score;
  a.row_label = row_label;
  a.row_weight = row_weight;
  a.use_weight = use_weight;
  a.K = K;
  a.sigmoid = sigmoid;
  a.wts = (const float*)wts;
  a.nf = nf;
  a.nb = nb;
  a.bits = bits;
  a.f_tile = nf;
  a.hist = (lgbt::hacc*)hist;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = (kind == lgbt::kSoftmax) ? lgbt::run_multi<lgbt::kSoftmax>(a, s)
                                           : lgbt::run_multi<lgbt::kOva>(a, s);
  return (int)e;
}
