// level_stream / split_stream for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pkernels.py level_stream (_level_kernel) and
// split_stream (_split_kernel), both built on _run_segment: for each
// active leaf segment [start, start+cnt) of the packed matrix, partition
// the rows by the segment's split predicate (lefts to [start, start+nl),
// rights after them) and return both children's (F, B, 3) histograms
// from the same pass.  split_stream is the one-segment table.
//
// What bounds it on this card: bytes.  Every active row's C channels are
// read and written once by the function (128 B/row at C=16); this
// implementation moves them twice (scatter into a scratch matrix, then
// copy back), plus one extra read of the bin word for the counts, and
// issues 3*F shared-memory atomics per row for the histograms.
//
// Design: the TPU kernel's two-ended in-place protocol exists because
// Mosaic has no scatter.  Here the partition is a plain stable
// count / scan / scatter over fixed row tiles:
//   (a) count_kernel   — per-tile left counts of the predicate;
//   (b) scan_kernel    — per-segment exclusive scan of the tile counts
//                        (one block per segment) and the segment's nl;
//   (c) scatter_kernel — recomputes the predicate, ranks rows inside
//                        each 256-row chunk with a warp ballot + block
//                        prefix (stable), writes all C channels of the
//                        row to the scratch matrix at its left or right
//                        slot, and accumulates it into the block's
//                        shared-memory left/right histograms (flushed to
//                        global memory with atomicAdd, zeros skipped);
//                        features are tiled over gridDim.y (tile y > 0
//                        only histograms) so any F*B fits 227 KB;
//   (d) copyback_kernel — the active segments move back from scratch.
// Columns outside the active segments are never written.  The
// partition is stable, so it is deterministic; the float atomics make
// the histograms' summation order vary from run to run.
#include "common.cuh"

namespace lgbt {

struct PartArgs {
  int32_t* P;
  int32_t* S;  // scratch, same shape as P
  long long ld;
  int C;
  const int32_t* seg;        // (n_seg, 12)
  const int32_t* tile_base;  // (n_seg + 1,)
  int n_seg;
  int tile;
  int32_t* tile_left;  // (total_tiles,)
  int32_t* tile_loff;  // (total_tiles,)
  int32_t* nl;         // (>= n_seg,)
  int bits, nf, nb, f_tile;
  int row_g, row_h, row_sel;
  float* hist;  // (n_seg, 2, F, B, 3)
};

__device__ __forceinline__ void tile_range(const PartArgs& a, int b, int* s, SegParams* p,
                                           long long* r0, long long* r1) {
  *s = seg_of_tile(a.tile_base, a.n_seg, b);
  *p = load_seg(a.seg, *s);
  int t = b - a.tile_base[*s];
  *r0 = p->start + (long long)t * a.tile;
  *r1 = min(*r0 + (long long)a.tile, p->start + (long long)p->cnt);
}

__global__ void __launch_bounds__(kThreads) count_kernel(PartArgs a) {
  __shared__ int warp_sums[32];
  int s;
  SegParams p;
  long long r0, r1;
  tile_range(a, blockIdx.x, &s, &p, &r0, &r1);
  const unsigned vmask = (1u << a.bits) - 1u;
  int c = 0;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    c += goes_left(a.P[(long long)p.word * a.ld + r], p, vmask);
  int total;
  block_incl_scan(c, warp_sums, &total);
  if (threadIdx.x == 0) a.tile_left[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads) scan_kernel(PartArgs a) {
  __shared__ int warp_sums[32];
  const int s = blockIdx.x;
  const int b0 = a.tile_base[s], b1 = a.tile_base[s + 1];
  int running = 0;
  for (int base = b0; base < b1; base += blockDim.x) {
    int i = base + threadIdx.x;
    int v = (i < b1) ? a.tile_left[i] : 0;
    int total;
    int incl = block_incl_scan(v, warp_sums, &total);
    if (i < b1) a.tile_loff[i] = running + incl - v;
    running += total;
  }
  if (threadIdx.x == 0) a.nl[s] = running;
}

__global__ void __launch_bounds__(kThreads) scatter_kernel(PartArgs a) {
  extern __shared__ float sh[];
  __shared__ int warp_l[32];
  int s;
  SegParams p;
  long long r0, r1;
  tile_range(a, blockIdx.x, &s, &p, &r0, &r1);
  const unsigned vmask = (1u << a.bits) - 1u;
  const int f0 = blockIdx.y * a.f_tile;
  const int f1 = min(f0 + a.f_tile, a.nf);
  const int span = (f1 - f0) * a.nb * 3;
  const bool do_scatter = blockIdx.y == 0;
  for (int i = threadIdx.x; i < 2 * span; i += blockDim.x) sh[i] = 0.0f;
  __syncthreads();

  const int t = blockIdx.x - a.tile_base[s];
  const long long lbase = a.tile_loff[blockIdx.x];          // lefts before this tile
  const long long rbase = (long long)t * a.tile - lbase;     // rights before this tile
  const long long nls = a.nl[s];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  long long run_l = 0, run_r = 0;

  for (long long cb = r0; cb < r1; cb += blockDim.x) {
    const long long r = cb + threadIdx.x;
    const bool valid = r < r1;
    const int gl = valid ? goes_left(a.P[(long long)p.word * a.ld + r], p, vmask) : 0;
    const unsigned ball = __ballot_sync(0xffffffffu, gl);
    if (lane == 0) warp_l[wid] = __popc(ball);
    __syncthreads();
    int before = 0, chunk_l = 0;
    for (int k = 0; k < nw; ++k) {
      int w = warp_l[k];
      if (k < wid) before += w;
      chunk_l += w;
    }
    if (valid) {
      if (do_scatter) {
        const int lrank = before + __popc(ball & ((1u << lane) - 1u));
        const int rrank = (int)threadIdx.x - lrank;
        const long long dst = gl ? (p.start + lbase + run_l + lrank)
                                 : (p.start + nls + rbase + run_r + rrank);
        for (int c = 0; c < a.C; ++c) a.S[(long long)c * a.ld + dst] = a.P[(long long)c * a.ld + r];
      }
      const float sv = f32_at(a.P, a.ld, a.row_sel, r);
      const float gv = f32_at(a.P, a.ld, a.row_g, r) * sv;
      const float hv = f32_at(a.P, a.ld, a.row_h, r) * sv;
      float* hs = sh + (gl ? 0 : span);
      for (int f = f0; f < f1; ++f) {
        int b = bin_of(a.P, a.ld, r, f, a.bits);
        if (b >= a.nb) continue;
        float* cell = hs + ((f - f0) * a.nb + b) * 3;
        atomicAdd(cell, gv);
        atomicAdd(cell + 1, hv);
        atomicAdd(cell + 2, sv);
      }
    }
    const long long nvalid = min((long long)blockDim.x, r1 - cb);
    run_l += chunk_l;
    run_r += nvalid - chunk_l;
    __syncthreads();
  }

  const long long fb3 = (long long)a.nf * a.nb * 3;
  float* outl = a.hist + (long long)s * 2 * fb3 + (long long)f0 * a.nb * 3;
  float* outr = outl + fb3;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    float vl = sh[i], vr = sh[span + i];
    if (vl != 0.0f) atomicAdd(outl + i, vl);
    if (vr != 0.0f) atomicAdd(outr + i, vr);
  }
}

__global__ void __launch_bounds__(kThreads) copyback_kernel(PartArgs a) {
  int s;
  SegParams p;
  long long r0, r1;
  tile_range(a, blockIdx.x, &s, &p, &r0, &r1);
  for (int c = 0; c < a.C; ++c) {
    const long long off = (long long)c * a.ld;
    for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) a.P[off + r] = a.S[off + r];
  }
}

}  // namespace lgbt

extern "C" int lgbt_partition_hist(void* P, void* S, long long ld, int C, void* seg,
                                   void* tile_base, int n_seg, int total_tiles, int tile,
                                   void* tile_left, void* tile_loff, void* nl, int bits, int nf,
                                   int nb, int row_g, int row_h, int row_sel, void* hist,
                                   void* stream) {
  lgbt::PartArgs a;
  a.P = (int32_t*)P;
  a.S = (int32_t*)S;
  a.ld = ld;
  a.C = C;
  a.seg = (const int32_t*)seg;
  a.tile_base = (const int32_t*)tile_base;
  a.n_seg = n_seg;
  a.tile = tile;
  a.tile_left = (int32_t*)tile_left;
  a.tile_loff = (int32_t*)tile_loff;
  a.nl = (int32_t*)nl;
  a.bits = bits;
  a.nf = nf;
  a.nb = nb;
  a.row_g = row_g;
  a.row_h = row_h;
  a.row_sel = row_sel;
  a.hist = (float*)hist;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_seg <= 0) return 0;

  const int cell2 = 2 * nb * 3 * (int)sizeof(float);
  a.f_tile = std::max(1, std::min(nf, lgbt::max_smem_optin() / cell2));
  const int ftiles = (nf + a.f_tile - 1) / a.f_tile;
  const size_t smem = (size_t)a.f_tile * cell2;

  if (total_tiles > 0) lgbt::count_kernel<<<total_tiles, lgbt::kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lgbt::scan_kernel<<<n_seg, lgbt::kThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || total_tiles == 0) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(lgbt::scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lgbt::scatter_kernel<<<dim3(total_tiles, ftiles), lgbt::kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lgbt::copyback_kernel<<<total_tiles, lgbt::kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
