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
// What bounds it on this card, and the design: update_hist.cuh, with
// this file's SingleUpd as its update policy (K = 1, V = 3 planes).  The
// TPU kernel's one-hot matmuls and bf16 3-term value split are not
// carried over: the planes sum in float64 cells, rounded once.
#include "update_hist.cuh"

namespace lgbt {

// One tree's channels: score (+ delta), the objective's (g, h) times mul,
// select.
template <int KIND>
struct SingleUpd {
  static constexpr int kMaxGH = 2;
  int32_t* P;
  long long ld;
  long long n;
  const float* delta;  // (n,) or null
  const float* sel;    // (n,) or null
  const float* mul;    // (n,) or null: g, h *= mul before they are written
  int row_g, row_h, row_sel, row_score, row_label, row_weight, use_weight;
  float p0, p1, p2;  // the objective's constants (common.cuh ObjKind)

  // refresh row r in place; v = (g*sel, h*sel); returns sel
  __device__ __forceinline__ float update(long long r, float* v) const {
    float score = f32_at(P, ld, row_score, r);
    if (delta) score = score + delta[r];
    const float label = f32_at(P, ld, row_label, r);
    const float w = use_weight ? f32_at(P, ld, row_weight, r) : 1.0f;
    float g, h;
    gradients<KIND>(score, label, w, use_weight, p0, p1, p2, &g, &h);
    if (mul) {
      const float m = mul[r];
      g = g * m;
      h = h * m;
    }
    const float s = sel ? sel[r] : f32_at(P, ld, row_sel, r);
    P[(long long)row_g * ld + r] = __float_as_int(g);
    P[(long long)row_h * ld + r] = __float_as_int(h);
    if (sel) P[(long long)row_sel * ld + r] = __float_as_int(s);
    if (delta) P[(long long)row_score * ld + r] = __float_as_int(score);
    v[0] = g * s;
    v[1] = h * s;
    return s;
  }

  // the channels as an earlier launch wrote them
  __device__ __forceinline__ float read(long long r, float* v) const {
    const float s = f32_at(P, ld, row_sel, r);
    v[0] = f32_at(P, ld, row_g, r) * s;
    v[1] = f32_at(P, ld, row_h, r) * s;
    return s;
  }
};

}  // namespace lgbt

// ticket: one zeroed unsigned; acc: F*B*3 zeroed float64 cells; hist:
// (F, B, 3) float32 out (all three unused when with_hist is 0).
// obj_kind: a common.cuh ObjKind (any other value: cudaErrorInvalidValue,
// nothing launched); p0..p2 its constants.
extern "C" int lgbt_update_root_hist(void* P, long long ld, int n, void* delta, void* sel,
                                     void* mul, int with_hist,
                                     int row_g, int row_h, int row_sel, int row_score,
                                     int row_label, int row_weight, int use_weight, int obj_kind,
                                     float p0, float p1, float p2, int nf, int nb,
                                     int bits, void* ticket, void* acc, void* hist, void* stream) {
  lgbt::UpdHist h{};
  h.nf = nf;
  h.nb = nb;
  h.bits = bits;
  h.V = 3;
  h.K = 1;
  h.ticket = (unsigned*)ticket;
  h.acc = (lgbt::hacc*)acc;
  h.out = (float*)hist;
  cudaStream_t s = (cudaStream_t)stream;
  // each kind's four histogram kernels own slots 4 * kind .. 4 * kind + 3
  auto run = [&](auto u, int kind) {
    u.P = (int32_t*)P;
    u.ld = ld;
    u.n = n;
    u.delta = (const float*)delta;
    u.sel = (const float*)sel;
    u.mul = (const float*)mul;
    u.row_g = row_g;
    u.row_h = row_h;
    u.row_sel = row_sel;
    u.row_score = row_score;
    u.row_label = row_label;
    u.row_weight = row_weight;
    u.use_weight = use_weight;
    u.p0 = p0;
    u.p1 = p1;
    u.p2 = p2;
    return lgbt::run_update_hist(u, h, with_hist, 4 * kind, s);
  };
  using namespace lgbt;
  switch (obj_kind) {
    case kBinary: return run(SingleUpd<kBinary>{}, kBinary);
    case kL2: return run(SingleUpd<kL2>{}, kL2);
    case kL1: return run(SingleUpd<kL1>{}, kL1);
    case kHuber: return run(SingleUpd<kHuber>{}, kHuber);
    case kFair: return run(SingleUpd<kFair>{}, kFair);
    case kPoisson: return run(SingleUpd<kPoisson>{}, kPoisson);
    default: return (int)cudaErrorInvalidValue;
  }
}
