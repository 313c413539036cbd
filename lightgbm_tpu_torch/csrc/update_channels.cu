// update_channels for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pkernels.py update_channels (_update_kernel):
// score channel k += delta, then fresh (grad, hess) from the objective on
// the new score, then optionally select = sel, written in place over the
// first num_rows columns of the packed matrix.  The fused trainer runs it
// as GOSS's prep pass: the pending delta settles and the gradients are
// fresh before the |g*h| ranking picks the rows of the next tree.
//
// What bounds it on this card: bytes.  Per row it reads score, label,
// weight and (when given) delta and sel, and writes score, g, h and
// (when given) select: at most 9 words, 36 B/row, ~0.11 ms at 10.5M rows
// and 3.35 TB/s.  The TPU kernel streamed the whole 8-aligned mutable
// band through VMEM because Mosaic DMAs move (8, 128)-aligned row
// blocks; here each thread touches only the rows it needs.  It reads no
// bin word.
//
// Design: one thread per row, grid-stride over num_rows, coalesced over
// the row-major channels.  The objective is common.cuh's compile-time
// switch, the same device function update_hist.cu uses, so g and h are
// bit-equal to update_and_root_hist's channel writes.  Columns past
// num_rows are not written (the Pallas kernel also rewrites the padding
// columns of its last whole block; nothing reads them).
#include "common.cuh"

namespace lgbt {

struct ChanArgs {
  int32_t* P;
  long long ld;
  int n;
  const float* delta;  // (n,) or null
  const float* sel;    // (n,) or null
  int row_g, row_h, row_sel, row_score, row_label, row_weight, use_weight;
  float p0, p1, p2;  // the objective's constants (common.cuh ObjKind)
};

template <int KIND>
__global__ void __launch_bounds__(kThreads) update_channels_kernel(ChanArgs a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < a.n; r += stride) {
    float score = f32_at(a.P, a.ld, a.row_score, r);
    if (a.delta) {
      score = score + a.delta[r];
      a.P[(long long)a.row_score * a.ld + r] = __float_as_int(score);
    }
    const float label = f32_at(a.P, a.ld, a.row_label, r);
    const float w = a.use_weight ? f32_at(a.P, a.ld, a.row_weight, r) : 1.0f;
    float g, h;
    gradients<KIND>(score, label, w, a.use_weight, a.p0, a.p1, a.p2, &g, &h);
    a.P[(long long)a.row_g * a.ld + r] = __float_as_int(g);
    a.P[(long long)a.row_h * a.ld + r] = __float_as_int(h);
    if (a.sel) a.P[(long long)a.row_sel * a.ld + r] = __float_as_int(a.sel[r]);
  }
}

}  // namespace lgbt

// obj_kind: a common.cuh ObjKind (any other value: cudaErrorInvalidValue,
// nothing launched); p0..p2 its constants.
extern "C" int lgbt_update_channels(void* P, long long ld, int n, void* delta, void* sel,
                                    int row_g, int row_h, int row_sel, int row_score,
                                    int row_label, int row_weight, int use_weight, int obj_kind,
                                    float p0, float p1, float p2, void* stream) {
  if (obj_kind < 0 || obj_kind >= lgbt::kNumObjKinds) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  lgbt::ChanArgs a;
  a.P = (int32_t*)P;
  a.ld = ld;
  a.n = n;
  a.delta = (const float*)delta;
  a.sel = (const float*)sel;
  a.row_g = row_g;
  a.row_h = row_h;
  a.row_sel = row_sel;
  a.row_score = row_score;
  a.row_label = row_label;
  a.row_weight = row_weight;
  a.use_weight = use_weight;
  a.p0 = p0;
  a.p1 = p1;
  a.p2 = p2;
  long long want = ((long long)n + lgbt::kThreads - 1) / lgbt::kThreads;
  int grid = (int)std::min<long long>(want, 16LL * lgbt::num_sms());
  cudaStream_t s = (cudaStream_t)stream;
  using namespace lgbt;
  switch (obj_kind) {
    case kBinary: update_channels_kernel<kBinary><<<grid, kThreads, 0, s>>>(a); break;
    case kL2: update_channels_kernel<kL2><<<grid, kThreads, 0, s>>>(a); break;
    case kL1: update_channels_kernel<kL1><<<grid, kThreads, 0, s>>>(a); break;
    case kHuber: update_channels_kernel<kHuber><<<grid, kThreads, 0, s>>>(a); break;
    case kFair: update_channels_kernel<kFair><<<grid, kThreads, 0, s>>>(a); break;
    case kPoisson: update_channels_kernel<kPoisson><<<grid, kThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
