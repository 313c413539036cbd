// hist_segments / hist_dyn for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py hist_segments
// (_hist_multi_kernel) and lightgbm_tpu/ops/pkernels.py hist_dyn
// (_hist_kernel): the (F, B, 3) histogram of (grad*sel, hess*sel, sel)
// over each contiguous leaf segment [start, start+cnt) of a table, read
// from the given (grad, hess, select) channel rows of the packed matrix.
// hist_dyn is the one-segment table.  4- and 8-bit bin words.
//
// What bounds it on this card: bytes are W bin words + 3 channels read
// per row (~24 B/row at W=3), ~0.003 ms over 465k rows at 3.35 TB/s;
// the 3*F shared-memory float64 atomics per row bound it, as in the
// histogram half of partition_hist.cu, which this kernel is without the
// partition.
//
// Design: the segments are cut into fixed row tiles (tile_base is the
// host's prefix of tiles per segment, so empty segments own none); one
// block per (tile, feature tile) accumulates a float64 sub-histogram in
// shared memory (common.cuh hacc) and flushes it into its segment's global histogram with
// atomicAdd (zeros skipped).  Features are tiled over gridDim.y so any
// F*B fits 227 KB.  Rows whose select is 0 add nothing.  Histograms of
// table rows past n_seg are not written (the wrapper zeroes them).
#include "common.cuh"

namespace lgbt {

struct SegHistArgs {
  const int32_t* P;
  long long ld;
  const int32_t* seg;        // (n_seg, 2) [start, cnt]
  const int32_t* tile_base;  // (n_seg + 1,)
  int n_seg, tile;
  int bits, nf, nb, f_tile;
  int row_g, row_h, row_sel;
  hacc* hist;  // (n_seg.., F, B, 3)
};

__global__ void __launch_bounds__(kThreads) seg_hist_kernel(SegHistArgs a) {
  extern __shared__ hacc sh[];
  const int s = seg_of_tile(a.tile_base, a.n_seg, blockIdx.x);
  const long long start = a.seg[2 * s];
  const int cnt = a.seg[2 * s + 1];
  const int t = blockIdx.x - a.tile_base[s];
  const long long r0 = start + (long long)t * a.tile;
  const long long r1 = min(r0 + (long long)a.tile, start + (long long)cnt);
  const int f0 = blockIdx.y * a.f_tile;
  const int f1 = min(f0 + a.f_tile, a.nf);
  const int span = (f1 - f0) * a.nb * 3;
  for (int i = threadIdx.x; i < span; i += blockDim.x) sh[i] = 0.0;
  __syncthreads();
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const float sv = f32_at(a.P, a.ld, a.row_sel, r);
    if (sv == 0.0f) continue;
    const float gv = f32_at(a.P, a.ld, a.row_g, r) * sv;
    const float hv = f32_at(a.P, a.ld, a.row_h, r) * sv;
    for (int f = f0; f < f1; ++f) {
      const int b = bin_of(a.P, a.ld, r, f, a.bits);
      if (b >= a.nb) continue;
      hacc* cell = sh + ((f - f0) * a.nb + b) * 3;
      atomicAdd(cell, gv);
      atomicAdd(cell + 1, hv);
      atomicAdd(cell + 2, sv);
    }
  }
  __syncthreads();
  hacc* out = a.hist + ((long long)s * a.nf + f0) * a.nb * 3;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const hacc v = sh[i];
    if (v != 0.0) atomicAdd(out + i, v);
  }
}

}  // namespace lgbt

extern "C" int lgbt_segment_hist(void* P, long long ld, void* seg, void* tile_base, int n_seg,
                                 int total_tiles, int tile, int bits, int nf, int nb, int row_g,
                                 int row_h, int row_sel, void* hist, void* stream) {
  if (n_seg <= 0 || total_tiles <= 0) return 0;
  lgbt::SegHistArgs a;
  a.P = (const int32_t*)P;
  a.ld = ld;
  a.seg = (const int32_t*)seg;
  a.tile_base = (const int32_t*)tile_base;
  a.n_seg = n_seg;
  a.tile = tile;
  a.bits = bits;
  a.nf = nf;
  a.nb = nb;
  a.row_g = row_g;
  a.row_h = row_h;
  a.row_sel = row_sel;
  a.hist = (lgbt::hacc*)hist;
  const int cell = nb * 3 * (int)sizeof(lgbt::hacc);
  a.f_tile = std::max(1, std::min(nf, lgbt::max_smem_optin() / cell));
  const int ftiles = (nf + a.f_tile - 1) / a.f_tile;
  const size_t smem = (size_t)a.f_tile * cell;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(lgbt::seg_hist_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lgbt::seg_hist_kernel<<<dim3(total_tiles, ftiles), lgbt::kThreads, smem,
                          (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
