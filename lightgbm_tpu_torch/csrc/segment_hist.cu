// hist_segments / hist_dyn / hist_segment / hist_segment_q for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py hist_segments
// (_hist_multi_kernel), hist_segment (_hist_kernel) and hist_segment_q
// (_hist_kernel_q), and lightgbm_tpu/ops/pkernels.py hist_dyn
// (_hist_kernel): the (F, B, 3) histogram of (grad*sel, hess*sel, sel)
// over each contiguous column segment [start, start+cnt) of a table,
// read from the given (grad, hess, select) channel rows of a packed
// int32 matrix.  hist_dyn and hist_segment are the one-segment table.
// Bin words of 4, 8 or 16 bits (common.cuh bin_of).
//
// Two instantiations of one kernel:
//  - float (B6, B7, B8): the channels are float32 bit patterns; cells
//    are float64 (common.cuh hacc) in shared memory and in the global
//    output, which the wrapper rounds to float32 once;
//  - quantized (B9): the channels are int16 levels stored as plain int32
//    words (ops/histogram.py pack_columns_q), cells are int32 with native
//    atomicAdd(int*), shared and global.  Integer adds are exact in any
//    order, so the result equals the plain version's bit for bit.
//
// What bounds it on this card: bytes are W bin words + 3 channels per
// selected row and the select word of every other row (a row whose
// select is 0 adds nothing and reads nothing more); the 3*F shared-memory
// atomics per selected row bound it in practice.
//
// Design: the segments are cut into fixed row tiles (tile_base is the
// host's prefix of tiles per segment, so empty segments own none); one
// block per (tile, feature tile) accumulates a sub-histogram in shared
// memory and flushes it into its segment's global histogram with
// atomicAdd (zero cells skipped).  Features are tiled over gridDim.y so
// any F*B fits 227 KB.  Histograms of table rows past n_seg are not
// written (the wrapper zeroes them).
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
  void* hist;  // (n_seg.., F, B, 3) of hacc (float) or int (quantized)
};

template <bool Q>
struct HistTraits {  // float channels, float64 cells
  using cell = hacc;
  __device__ static float value(const int32_t* P, long long ld, int row, long long r) {
    return f32_at(P, ld, row, r);
  }
};

template <>
struct HistTraits<true> {  // int16 levels in int32 words, int32 cells
  using cell = int;
  __device__ static int value(const int32_t* P, long long ld, int row, long long r) {
    return P[(long long)row * ld + r];
  }
};

template <bool Q>
__global__ void __launch_bounds__(kThreads) seg_hist_kernel(SegHistArgs a) {
  using T = HistTraits<Q>;
  using cell_t = typename T::cell;
  extern __shared__ __align__(8) unsigned char smem[];
  cell_t* sh = reinterpret_cast<cell_t*>(smem);
  const int s = seg_of_tile(a.tile_base, a.n_seg, blockIdx.x);
  const long long start = a.seg[2 * s];
  const int cnt = a.seg[2 * s + 1];
  const int t = blockIdx.x - a.tile_base[s];
  const long long r0 = start + (long long)t * a.tile;
  const long long r1 = min(r0 + (long long)a.tile, start + (long long)cnt);
  const int f0 = blockIdx.y * a.f_tile;
  const int f1 = min(f0 + a.f_tile, a.nf);
  const int span = (f1 - f0) * a.nb * 3;
  for (int i = threadIdx.x; i < span; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const auto sv = T::value(a.P, a.ld, a.row_sel, r);
    if (sv == 0) continue;
    const auto gv = T::value(a.P, a.ld, a.row_g, r) * sv;
    const auto hv = T::value(a.P, a.ld, a.row_h, r) * sv;
    for (int f = f0; f < f1; ++f) {
      const int b = bin_of(a.P, a.ld, r, f, a.bits);
      if (b >= a.nb) continue;
      cell_t* c = sh + ((f - f0) * a.nb + b) * 3;
      atomicAdd(c, (cell_t)gv);
      atomicAdd(c + 1, (cell_t)hv);
      atomicAdd(c + 2, (cell_t)sv);
    }
  }
  __syncthreads();
  cell_t* out = reinterpret_cast<cell_t*>(a.hist) + ((long long)s * a.nf + f0) * a.nb * 3;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const cell_t v = sh[i];
    if (v != 0) atomicAdd(out + i, v);
  }
}

template <bool Q>
int launch_seg_hist(void* P, long long ld, void* seg, void* tile_base, int n_seg,
                    int total_tiles, int tile, int bits, int nf, int nb, int row_g, int row_h,
                    int row_sel, void* hist, void* stream) {
  if (n_seg <= 0 || total_tiles <= 0) return 0;
  SegHistArgs a;
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
  a.hist = hist;
  const int cell = nb * 3 * (int)sizeof(typename HistTraits<Q>::cell);
  a.f_tile = std::max(1, std::min(nf, max_smem_optin() / cell));
  const int ftiles = (nf + a.f_tile - 1) / a.f_tile;
  const size_t smem = (size_t)a.f_tile * cell;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(seg_hist_kernel<Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  seg_hist_kernel<Q><<<dim3(total_tiles, ftiles), kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace lgbt

// hist (n_seg.., F, B, 3) float64: B6, B7, B8
extern "C" int lgbt_segment_hist(void* P, long long ld, void* seg, void* tile_base, int n_seg,
                                 int total_tiles, int tile, int bits, int nf, int nb, int row_g,
                                 int row_h, int row_sel, void* hist, void* stream) {
  return lgbt::launch_seg_hist<false>(P, ld, seg, tile_base, n_seg, total_tiles, tile, bits, nf,
                                      nb, row_g, row_h, row_sel, hist, stream);
}

// hist (n_seg.., F, B, 3) int32 of int32-word levels: B9
extern "C" int lgbt_segment_hist_q(void* P, long long ld, void* seg, void* tile_base, int n_seg,
                                   int total_tiles, int tile, int bits, int nf, int nb, int row_g,
                                   int row_h, int row_sel, void* hist, void* stream) {
  return lgbt::launch_seg_hist<true>(P, ld, seg, tile_base, n_seg, total_tiles, tile, bits, nf,
                                     nb, row_g, row_h, row_sel, hist, stream);
}
