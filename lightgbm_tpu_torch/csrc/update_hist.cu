// update_and_root_hist for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pkernels.py update_and_root_hist
// (_upd_hist_kernel): one pass over all N rows of the packed matrix that
// settles score += delta, recomputes (grad, hess) from the objective,
// optionally scales them by a per-row multiplier (GOSS's up-weighting of
// the sampled rest), optionally overwrites the select channel, writes
// those channels back in place and accumulates the root (F, B, 3)
// histogram of (grad*sel, hess*sel, sel) from the fresh values.  With
// with_hist = 0 only the channel update runs.
//
// What bounds it on this card: the bytes are small (the W bin words plus
// ~4 band channels read, 3 written: ~56 B/row, ~0.18 ms at 10.5M rows
// and 3.35 TB/s), so the kernel is bound by the 3*F shared-memory float
// atomics each row issues into the block's private histogram.  The TPU
// kernel's one-hot matmuls and bf16 3-term value split are not carried
// over: the card has native float atomics in shared memory, which give
// f32 sums directly.
//
// Design: grid-stride rows, one row per thread per step, coalesced over
// the row-major channels.  Each block owns a float64 sub-histogram of its
// feature tile in shared memory (common.cuh hacc) and flushes it to the
// global histogram with atomicAdd (zeros skipped).  Features are tiled over gridDim.y so
// any F*B fits the 227 KB block limit; when more than one tile is
// needed, the channel update runs as its own launch first and the
// histogram launch reads the freshly written channels, so no block ever
// reads a channel another block is rewriting.
#include "common.cuh"

namespace lgbt {

struct UpdArgs {
  int32_t* P;
  long long ld;
  int n;
  const float* delta;  // (n,) or null
  const float* sel;    // (n,) or null
  const float* mul;    // (n,) or null: g, h *= mul before they are written
  int row_g, row_h, row_sel, row_score, row_label, row_weight, use_weight;
  float sigmoid, w_pos, w_neg;
  int nf, nb, bits, f_tile;
  hacc* hist;  // (F, B, 3)
};

// UPDATE: recompute and write the channels.  HIST: accumulate the
// histogram (from the fresh values when UPDATE, else from the channels).
template <int KIND, bool UPDATE, bool HIST>
__global__ void __launch_bounds__(kThreads) upd_hist_kernel(UpdArgs a) {
  extern __shared__ hacc sh[];
  const int f0 = blockIdx.y * a.f_tile;
  const int f1 = min(f0 + a.f_tile, a.nf);
  const int span = (f1 - f0) * a.nb * 3;
  if (HIST) {
    for (int i = threadIdx.x; i < span; i += blockDim.x) sh[i] = 0.0;
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < a.n; r += stride) {
    float g, h, s;
    if (UPDATE) {
      float score = f32_at(a.P, a.ld, a.row_score, r);
      if (a.delta) score = score + a.delta[r];
      float label = f32_at(a.P, a.ld, a.row_label, r);
      float w = a.use_weight ? f32_at(a.P, a.ld, a.row_weight, r) : 1.0f;
      gradients<KIND>(score, label, w, a.use_weight, a.sigmoid, a.w_pos, a.w_neg, &g, &h);
      if (a.mul) {
        const float m = a.mul[r];
        g = g * m;
        h = h * m;
      }
      s = a.sel ? a.sel[r] : f32_at(a.P, a.ld, a.row_sel, r);
      a.P[(long long)a.row_g * a.ld + r] = __float_as_int(g);
      a.P[(long long)a.row_h * a.ld + r] = __float_as_int(h);
      if (a.sel) a.P[(long long)a.row_sel * a.ld + r] = __float_as_int(s);
      if (a.delta) a.P[(long long)a.row_score * a.ld + r] = __float_as_int(score);
    } else {
      g = f32_at(a.P, a.ld, a.row_g, r);
      h = f32_at(a.P, a.ld, a.row_h, r);
      s = f32_at(a.P, a.ld, a.row_sel, r);
    }
    if (HIST) {
      const float gs = g * s, hs = h * s;
      for (int f = f0; f < f1; ++f) {
        int b = bin_of(a.P, a.ld, r, f, a.bits);
        if (b >= a.nb) continue;
        hacc* cell = sh + ((f - f0) * a.nb + b) * 3;
        atomicAdd(cell, gs);
        atomicAdd(cell + 1, hs);
        atomicAdd(cell + 2, s);
      }
    }
  }
  if (HIST) {
    __syncthreads();
    hacc* out = a.hist + (long long)f0 * a.nb * 3;
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
      hacc v = sh[i];
      if (v != 0.0) atomicAdd(out + i, v);
    }
  }
}

template <int KIND, bool UPDATE, bool HIST>
cudaError_t launch_one(const UpdArgs& a, dim3 grid, size_t smem, cudaStream_t stream) {
  auto k = upd_hist_kernel<KIND, UPDATE, HIST>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  k<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t run(UpdArgs a, int with_hist, cudaStream_t stream) {
  long long want = ((long long)a.n + kThreads - 1) / kThreads;
  int gx = (int)std::min<long long>(std::max<long long>(want, 1), 4LL * num_sms());
  if (!with_hist) return launch_one<KIND, true, false>(a, dim3(gx, 1), 0, stream);
  const int cell = a.nb * 3 * (int)sizeof(hacc);
  const int max_smem = max_smem_optin();
  a.f_tile = std::max(1, std::min(a.nf, max_smem / cell));
  const int tiles = (a.nf + a.f_tile - 1) / a.f_tile;
  size_t smem = (size_t)a.f_tile * cell;
  if (tiles == 1) {
    return launch_one<KIND, true, true>(a, dim3(gx, 1), smem, stream);
  }
  cudaError_t e = launch_one<KIND, true, false>(a, dim3(gx, 1), 0, stream);
  if (e != cudaSuccess) return e;
  return launch_one<KIND, false, true>(a, dim3(gx, tiles), smem, stream);
}

}  // namespace lgbt

extern "C" int lgbt_update_root_hist(void* P, long long ld, int n, void* delta, void* sel,
                                     void* mul, int with_hist,
                                     int row_g, int row_h, int row_sel, int row_score,
                                     int row_label, int row_weight, int use_weight, int obj_kind,
                                     float sigmoid, float w_pos, float w_neg, int nf, int nb,
                                     int bits, void* hist, void* stream) {
  lgbt::UpdArgs a;
  a.P = (int32_t*)P;
  a.ld = ld;
  a.n = n;
  a.delta = (const float*)delta;
  a.sel = (const float*)sel;
  a.mul = (const float*)mul;
  a.row_g = row_g;
  a.row_h = row_h;
  a.row_sel = row_sel;
  a.row_score = row_score;
  a.row_label = row_label;
  a.row_weight = row_weight;
  a.use_weight = use_weight;
  a.sigmoid = sigmoid;
  a.w_pos = w_pos;
  a.w_neg = w_neg;
  a.nf = nf;
  a.nb = nb;
  a.bits = bits;
  a.f_tile = nf;
  a.hist = (lgbt::hacc*)hist;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = (obj_kind == lgbt::kBinary) ? lgbt::run<lgbt::kBinary>(a, with_hist, s)
                                              : lgbt::run<lgbt::kL2>(a, with_hist, s);
  return (int)e;
}
