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
// What bounds it on this card, and the design: update_hist.cuh, with
// this file's MultiUpd as its update policy (V = 2K + 1 planes; a lane
// owns (column, plane) pairs, so at the covertype cell's 12 columns and
// K = 7 the 180 pairs keep six warps' lanes busy).  The TPU kernel's
// one-hot matmuls (whose 6K+1 bf16 value rows had to fit the MXU's
// sublanes) are not carried over.  The K scores and (g, h) pairs stay in
// registers (loops unrolled to kMaxK = 16 with a runtime guard); the
// one-vs-all label weights come by value in the launch's parameters.
// Compiled with -fmad=false, the plain version's float32 operation order,
// and exp_f32 (common.cuh), so g/h equal the plain version's bit for bit.
#include "update_hist.cuh"

namespace lgbt {

constexpr int kMaxK = 16;

enum MultiKind { kSoftmax = 0, kOva = 1 };

// K trees' channels from one score snapshot.
template <int KIND>
struct MultiUpd {
  static constexpr int kMaxGH = 2 * kMaxK;
  int32_t* P;
  long long ld;
  long long n;
  const float* sel;  // (n,) or null
  int row_g0, row_sel, row_score, row_label, row_weight, use_weight;
  int K;
  float sigmoid;
  float wts[2 * kMaxK];  // one-vs-all w_pos[k] at k, w_neg[k] at kMaxK + k

  // objective/multiclass.py gradients_rowwise_all for one row
  __device__ __forceinline__ void gradients(long long r, float* g, float* h) const {
    const float label = f32_at(P, ld, row_label, r);
    float s[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) s[k] = f32_at(P, ld, row_score + k, r);
    if (KIND == kSoftmax) {
      // subtract the max, exp, sum, divide; grad = p - 1[y=k], hess = 2p(1-p)
      float m = s[0];
#pragma unroll
      for (int k = 1; k < kMaxK; ++k)
        if (k < K) m = fmaxf(m, s[k]);
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) {
          s[k] = exp_f32(s[k] - m);
          sum = sum + s[k];
        }
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) {
          const float p = s[k] / sum;
          g[k] = p - (label == (float)k ? 1.0f : 0.0f);
          h[k] = 2.0f * p * (1.0f - p);
        }
    } else {
      // K binary loglosses, class k's positives being label == k
      // (binary_objective.hpp:95-99)
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) {
          const bool pos = label == (float)k;
          const float sign = pos ? 1.0f : -1.0f;
          const float lw = pos ? wts[k] : wts[kMaxK + k];
          const float response = (-sign * sigmoid) / (1.0f + exp_f32(sign * sigmoid * s[k]));
          const float ar = fabsf(response);
          g[k] = response * lw;
          h[k] = ar * (sigmoid - ar) * lw;
        }
    }
    if (use_weight) {
      const float w = f32_at(P, ld, row_weight, r);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) {
          g[k] = g[k] * w;
          h[k] = h[k] * w;
        }
    }
  }

  // refresh row r in place; v = [g_k*sel, h_k*sel]_k; returns sel
  __device__ __forceinline__ float update(long long r, float* v) const {
    float g[kMaxK], h[kMaxK];
    gradients(r, g, h);
    const float s = sel ? sel[r] : f32_at(P, ld, row_sel, r);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) {
        P[(long long)(row_g0 + 2 * k) * ld + r] = __float_as_int(g[k]);
        P[(long long)(row_g0 + 2 * k + 1) * ld + r] = __float_as_int(h[k]);
        v[2 * k] = g[k] * s;
        v[2 * k + 1] = h[k] * s;
      }
    if (sel) P[(long long)row_sel * ld + r] = __float_as_int(s);
    return s;
  }

  // the channels as an earlier launch wrote them
  __device__ __forceinline__ float read(long long r, float* v) const {
    const float s = f32_at(P, ld, row_sel, r);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) {
        v[2 * k] = f32_at(P, ld, row_g0 + 2 * k, r) * s;
        v[2 * k + 1] = f32_at(P, ld, row_g0 + 2 * k + 1, r) * s;
      }
    return s;
  }
};

}  // namespace lgbt

// wts: 2K host floats (one-vs-all w_pos, then w_neg), copied into the
// launch's parameters; ticket: one zeroed unsigned; acc: F*B*(2K+1)
// zeroed float64 cells; hist: (K, F, B, 3) float32 out.
extern "C" int lgbt_update_multi_hist(void* P, long long ld, int n, void* sel, int row_g0,
                                      int row_sel, int row_score, int row_label, int row_weight,
                                      int use_weight, int kind, int K, float sigmoid,
                                      const float* wts, int nf, int nb, int bits, void* ticket,
                                      void* acc, void* hist, void* stream) {
  if (K < 1 || K > lgbt::kMaxK) return (int)cudaErrorInvalidValue;
  lgbt::UpdHist h{};
  h.nf = nf;
  h.nb = nb;
  h.bits = bits;
  h.V = 2 * K + 1;
  h.K = K;
  h.ticket = (unsigned*)ticket;
  h.acc = (lgbt::hacc*)acc;
  h.out = (float*)hist;
  cudaStream_t s = (cudaStream_t)stream;
  auto run = [&](auto u, int slot0) {
    u.P = (int32_t*)P;
    u.ld = ld;
    u.n = n;
    u.sel = (const float*)sel;
    u.row_g0 = row_g0;
    u.row_sel = row_sel;
    u.row_score = row_score;
    u.row_label = row_label;
    u.row_weight = row_weight;
    u.use_weight = use_weight;
    u.K = K;
    u.sigmoid = sigmoid;
    for (int k = 0; k < lgbt::kMaxK; ++k) {
      u.wts[k] = k < K ? wts[k] : 0.0f;
      u.wts[lgbt::kMaxK + k] = k < K ? wts[K + k] : 0.0f;
    }
    return lgbt::run_update_hist(u, h, 1, slot0, s);
  };
  switch (kind) {
    case lgbt::kSoftmax: return run(lgbt::MultiUpd<lgbt::kSoftmax>{}, 0);
    case lgbt::kOva: return run(lgbt::MultiUpd<lgbt::kOva>{}, 4);
    default: return (int)cudaErrorInvalidValue;
  }
}
