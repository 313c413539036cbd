// The staged update-and-histogram kernel shared by update_hist.cu (B1,
// one tree: the row-local objectives of common.cuh ObjKind) and
// update_multi_hist.cu (B2, K trees: softmax or one-vs-all), for Hopper
// (sm_90a).
//
// Both functions make one pass over the first n rows of the packed
// matrix: a row's channels are refreshed in place (scores, gradients,
// select) and V = 2K + 1 values of the row, [g_0*sel, h_0*sel, ...,
// g_{K-1}*sel, h_{K-1}*sel, sel], are added into an (F, B, V) float64
// histogram, which is rounded once into K (F, B, 3) float32 histograms
// sharing the count plane.  An update policy U (the .cu files) says how a
// row's channels are refreshed (U::update) or read back (U::read); this
// file holds everything else.
//
// What bounds it on this card: bytes in principle (W bin words and a few
// channels a row, ~0.18 ms at 10.5M x 28), but the histogram in practice.
// Each (row, feature, plane) is one read-add-write of a float64 shared
// cell, 16 bytes of shared-memory traffic: 882M of them at 10.5M x 28 x 3
// take at least ~0.42 ms at 128 B/clk on 132 SMs.  sm_90a has no shared
// float64 add (atomicAdd there is a compare-and-swap loop,
// ATOMS.CAST.SPIN.64), so no cell may be shared between lanes; and with
// so few histogram warps the read-add-writes are bound by each warp's own
// chain of instructions, not by the shared memory's rate.
//
// Design: one 512-thread block an SM (times the feature tiles); block b
// takes an equal share of the rows, 256 at a time, double-buffered:
//  - 8 stage warps, a row a thread: refresh the row's channels, then
//    stage its bin words and V values (float64) in shared memory, the
//    rows whose select is 0 left out (a ballot and one barrier of the
//    stage warps);
//  - meanwhile 8 histogram warps add the previous chunk.  A lane owns
//    (feature, plane) pairs, so its lanes work whatever F and V are and
//    never touch another lane's cell.  The cells of 16 pairs interleave
//    in 128-byte stripes, so the lanes of a warp never share a bank
//    whatever their bins (a tile of fewer pairs narrows its stripes, see
//    pair_stripe).  A lane reads four staged rows with each 16-byte
//    load.  With four or eight copies of the cells (as many as shared
//    memory holds), the four rows go to four copies and their
//    read-add-writes never meet; with one or two, rows of one bin are
//    summed in registers first and each copy takes its own rows.
// The block adds its copies and sends the nonzero cells to a global
// float64 accumulator with native reductions (REDG.E.ADD.F64).  The last
// block, by ticket, rounds the accumulator into the (K, F, B, 3) output,
// zeroes it and the ticket for the next call.  The accumulator and the
// ticket are the wrapper's workspace (ops/histogram.py), one a stream of
// a card.  Features are tiled over gridDim.y when one copy of the cells
// does not fit (down to one feature, then shorter chunks); with more than
// one tile the channels are refreshed by their own launch first and the
// histogram launch reads them, so no block reads a channel that another
// block rewrites.
#pragma once

#include "common.cuh"

namespace lgbt {

constexpr int kUpdThreads = 512;                               // a histogram block: one an SM
constexpr int kUpdHistWarps = 8;                               // warps 0-7 add
constexpr int kUpdStage = kUpdThreads - 32 * kUpdHistWarps;    // warps 8-15 stage, a row a thread
constexpr int kUpdChunk = kUpdStage;                           // rows staged at a time, at most
constexpr int kUpdMaxCopies = 8;                               // copies of the cells
constexpr int kUpdMinRows = 1024;                              // fewest rows a block takes
constexpr int kPairStripe = stripe_of(sizeof(hacc));          // 16 pairs' cells interleave

// The histogram half of a launch.
struct UpdHist {
  int nf, nb, bits, f_tile, copies, chunk;
  int stripe;        // pairs of a stripe of cells (pair_stripe)
  int V, K;          // V = 2K + 1 value planes; K output histograms
  unsigned* ticket;  // blocks done; 0 between calls
  hacc* acc;         // (F, B, V) cells; 0 between calls
  float* out;        // (K, F, B, 3)
};

// Cells of one copy: npairs (feature, plane) pairs of nb bins, in
// stripes of S pairs; pair q's cell of bin b lies at
// (q / S * nb + b) * S + q % S.
__host__ __device__ __forceinline__ int pair_span(int npairs, int nb, int S) {
  return (npairs + S - 1) / S * S * nb;
}

// Pairs of a stripe for a tile of npairs: whole 128-byte stripes
// (kPairStripe), or the power of two at or above npairs where that is
// narrower, so a narrow tile of many bins holds few empty cells.  With
// `tight`, stripes of equal width and no more of them than kPairStripe
// needs, so at most one empty cell a stripe and bin (the lanes of a warp
// may then share banks): the last resort of a tile that does not fit.
inline int pair_stripe(int npairs, bool tight) {
  if (tight) {
    const int stripes = (npairs + kPairStripe - 1) / kPairStripe;
    return (npairs + stripes - 1) / stripes;
  }
  int s = 1;
  while (s < npairs && s < kPairStripe) s <<= 1;
  return s;
}

// Shared-memory bytes of a block: `copies` copies of the cells of f_tile
// features, then two staging buffers of nwords bin words (int32) and V
// values (float64, so the adds convert nothing), `chunk` rows each (a
// staged channel holds chunk + 4 rows: four rows are one or two 16-byte
// loads, and the last four-row group of a chunk is padded with zeros).  A
// feature tile starts at a multiple of f_tile, a whole number of words or
// one feature.
inline size_t upd_smem(int f_tile, int V, int nb, int per, int copies, int chunk, int S) {
  const int nwords = (f_tile + per - 1) / per;
  return align16((size_t)copies * pair_span(f_tile * V, nb, S) * sizeof(hacc)) +
         (size_t)2 * (nwords * 4 + V * 8) * (chunk + 4);
}

__device__ __forceinline__ void stage_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kUpdStage) : "memory");
}

// Four staged rows of one (feature, plane) pair: bin words and values.
struct Rows4 {
  int4 w;
  double2 xa, xb;
  __device__ __forceinline__ void load(const int32_t* wrow, const double* vrow, int i) {
    w = *reinterpret_cast<const int4*>(wrow + i);
    xa = *reinterpret_cast<const double2*>(vrow + i);
    xb = *reinterpret_cast<const double2*>(vrow + i + 2);
  }
};

// Add four staged rows of one pair into the lane's own cells, bins below
// nb only: row u into cell[u][bin * S], S pairs a stripe.  kSlots: each row has its own
// copy of the cells (cell[u] apart), so the four read-add-writes never
// meet; else one copy (cell[u] all equal), and rows of one bin are summed
// in registers first, so the read-add-writes that remain touch distinct
// cells.  Either way the four overlap.  Padding rows carry bin 0 and the
// value 0.
template <bool kSlots>
__device__ __forceinline__ void add_pair4(const Rows4& r, int sh, unsigned vmask, unsigned nb,
                                          int S, hacc* const (&cell)[4]) {
  const int wv[4] = {r.w.x, r.w.y, r.w.z, r.w.w};
  hacc s[4] = {r.xa.x, r.xa.y, r.xb.x, r.xb.y};
  int bin[4];
  bool live[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    bin[u] = (int)(((uint32_t)wv[u] >> sh) & vmask);
    live[u] = (unsigned)bin[u] < nb;
  }
  if (!kSlots) {
#pragma unroll
    for (int u = 1; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < u; ++v)
        if (live[u] && live[v] && bin[u] == bin[v]) {
          s[v] += s[u];
          live[u] = false;
        }
  }
  hacc old[4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (live[u]) old[u] = cell[u][bin[u] * S];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (live[u]) cell[u][bin[u] * S] = old[u] + s[u];
}

// The copies' layout: with four or more (kSlots), groups of four, row u
// of a four-row group into copy u of its group; with one or two, a copy
// a group.  A group of warps takes every groups-th four-row group.
__host__ __device__ __forceinline__ int upd_groups(int copies) {
  return copies >= 4 ? copies / 4 : copies;
}

// UPDATE: refresh the channels and histogram the fresh values; else read
// the channels (refreshed by an earlier launch) and histogram them.
// kSlots: h.copies >= 4 (upd_groups).
template <class U, bool UPDATE, bool kSlots>
__global__ void __launch_bounds__(kUpdThreads, 1) upd_hist_kernel(U u, UpdHist h) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int stage_cnt[kUpdStage / 32];
  __shared__ int chunk_rows[2];
  __shared__ bool last;
  const int per = 32 / h.bits;
  const int f0 = blockIdx.y * h.f_tile, f1 = min(f0 + h.f_tile, h.nf), nfl = f1 - f0;
  const int V = h.V, npairs = nfl * V, S = h.stripe;
  const int span = pair_span(npairs, h.nb, S);
  const int w0 = f0 / per, nwords = (f1 - 1) / per - w0 + 1;
  const int chunk = h.chunk, stride = chunk + 4;
  hacc* hs = reinterpret_cast<hacc*>(smem);
  int32_t* sw =
      reinterpret_cast<int32_t*>(smem + align16((size_t)h.copies * span * sizeof(hacc)));
  double* sv = reinterpret_cast<double*>(sw + 2 * nwords * stride);
  // the block's rows: an equal share, cut at whole 32-row groups
  const long long n = u.n;
  const long long r0 = blockIdx.x == 0 ? 0 : (n * blockIdx.x / gridDim.x) & ~31LL;
  const long long r1 =
      blockIdx.x + 1 == gridDim.x ? n : (n * (blockIdx.x + 1) / gridDim.x) & ~31LL;
  const int nchunks = (int)((r1 - r0 + chunk - 1) / chunk);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < h.copies * span; i += kUpdThreads) hs[i] = 0.0;
  __syncthreads();
  if (wid >= kUpdHistWarps) {
    // stage warps: row st of chunk k into buffer k & 1, selected rows only
    const int st = threadIdx.x - 32 * kUpdHistWarps, sid = st >> 5;
    for (int k = 0; k <= nchunks; ++k) {
      if (k < nchunks) {
        const long long r = r0 + (long long)k * chunk + st;
        const bool live = st < chunk && r < r1;
        int32_t* swk = sw + (k & 1) * nwords * stride;
        double* svk = sv + (k & 1) * V * stride;
        // the first eight bin words load with the row's channels
        int32_t wd[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (live && e < nwords) wd[e] = __ldg(u.P + (long long)(w0 + e) * u.ld + r);
        float v[U::kMaxGH];
        float s = 0.0f;
        if (live) s = UPDATE ? u.update(r, v) : u.read(r, v);
        const unsigned keep = __ballot_sync(0xffffffffu, s != 0.0f);
        if (lane == 0) stage_cnt[sid] = __popc(keep);
        stage_barrier();
        int pos = __popc(keep & ((1u << lane) - 1u)), total = 0;
#pragma unroll
        for (int w = 0; w < kUpdStage / 32; ++w) {
          const int c = stage_cnt[w];
          pos += w < sid ? c : 0;
          total += c;
        }
        if (s != 0.0f) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (e < nwords) swk[e * stride + pos] = wd[e];
          for (int c0 = 8; c0 < nwords; c0 += 8) {  // eight loads in flight
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (c0 + e < nwords) wd[e] = __ldg(u.P + (long long)(w0 + c0 + e) * u.ld + r);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (c0 + e < nwords) swk[(c0 + e) * stride + pos] = wd[e];
          }
#pragma unroll
          for (int q = 0; q < U::kMaxGH; ++q)
            if (q < V - 1) svk[q * stride + pos] = v[q];
          svk[(V - 1) * stride + pos] = s;
        }
        if (st < 4) {  // pad the last four-row group: bin 0, value 0
          for (int w = 0; w < nwords; ++w) swk[w * stride + total + st] = 0;
          for (int q = 0; q < V; ++q) svk[q * stride + total + st] = 0.0;
        }
        if (st == 0) chunk_rows[k & 1] = total;
      }
      __syncthreads();
    }
  } else {
    // histogram warp wi of group g: lane takes pairs q = wi*32 + lane (+
    // k*32*wpg) of the tile, q = local feature * V + plane, and every
    // groups-th four staged rows from 4*g on
    const int groups = upd_groups(h.copies), wpg = kUpdHistWarps / groups;
    const int g = wid / wpg, wi = wid % wpg;
    const unsigned vmask = (1u << h.bits) - 1u;
    const int step = 4 * groups;
    for (int k = 0; k <= nchunks; ++k) {
      if (k > 0) {
        const int kc = k - 1, nrows = chunk_rows[kc & 1];
        const int32_t* swk = sw + (kc & 1) * nwords * stride;
        const double* svk = sv + (kc & 1) * V * stride;
        for (int q = wi * 32 + lane; q < npairs; q += wpg * 32) {
          const int lf = q / V, f = f0 + lf;
          const int32_t* wrow = swk + (f / per - w0) * stride;
          const double* vrow = svk + (q - lf * V) * stride;
          const int sh = (f % per) * h.bits;
          hacc* const base = hs + (kSlots ? 4 * g : g) * span + q / S * h.nb * S + q % S;
          hacc* const cell[4] = {base, base + (kSlots ? span : 0), base + (kSlots ? 2 * span : 0),
                                 base + (kSlots ? 3 * span : 0)};
          // the next four rows load before this four's adds; unrolled by
          // two, so the loads land in the other buffer's registers and no
          // copy waits for them
          int i = 4 * g;
          Rows4 cur;
          if (i < nrows) cur.load(wrow, vrow, i);
#pragma unroll 2
          for (; i < nrows; i += step) {
            Rows4 nxt = cur;
            if (i + step < nrows) nxt.load(wrow, vrow, i + step);
            add_pair4<kSlots>(cur, sh, vmask, (unsigned)h.nb, S, cell);
            cur = nxt;
          }
        }
      }
      __syncthreads();
    }
  }

  // the block's copies summed, in shared-memory order; nonzero cells to
  // the accumulator at (f, bin, plane)
  hacc* acc = h.acc + (long long)f0 * h.nb * V;
  for (int j = threadIdx.x; j < span; j += kUpdThreads) {
    const int q = j / (h.nb * S) * S + j % S;
    if (q >= npairs) continue;
    hacc x = 0.0;
    for (int c = 0; c < h.copies; ++c) x += hs[c * span + j];
    const int lf = q / V;
    if (x != 0.0)
      atomicAdd(acc + ((long long)lf * h.nb + j / S % h.nb) * V + (q - lf * V), x);
  }

  // the last block rounds the accumulator into the K histograms and resets
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(h.ticket, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int cells = h.nf * h.nb * V;
  const long long plane = (long long)h.nf * h.nb;
  for (int i0 = threadIdx.x; i0 < cells; i0 += 4 * kUpdThreads) {
    hacc x[4];  // four loads in flight before the stores
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (i0 + e * kUpdThreads < cells) x[e] = __ldcg(h.acc + i0 + e * kUpdThreads);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + e * kUpdThreads;
      if (i >= cells) continue;
      h.acc[i] = 0.0;
      const int v = i % V, fb = i / V;  // fb = f * nb + bin
      const float y = (float)x[e];
      if (v < 2 * h.K) {
        h.out[((v >> 1) * plane + fb) * 3 + (v & 1)] = y;
      } else {
        for (int k = 0; k < h.K; ++k) h.out[(k * plane + fb) * 3 + 2] = y;
      }
    }
  }
  if (threadIdx.x == 0) *h.ticket = 0;
}

// The channel refresh alone, a row a thread (with_hist = 0, and the first
// launch of a feature-tiled histogram).
template <class U>
__global__ void __launch_bounds__(kThreads) upd_only_kernel(U u) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < u.n; r += stride) {
    float v[U::kMaxGH];
    u.update(r, v);
  }
}

template <class U>
cudaError_t launch_update_only(const U& u, cudaStream_t st) {
  const long long want = (u.n + kThreads - 1) / kThreads;
  const int grid = (int)std::min<long long>(std::max<long long>(want, 1), 16LL * num_sms());
  upd_only_kernel<U><<<grid, kThreads, 0, st>>>(u);
  return cudaGetLastError();
}

// Copies of the cells (1, 2, 4 or 8) whose shared memory fits `limit`
// and that make the fewest four-row groups a chunk on the busiest lane
// (passes over its pairs times groups a copy group takes), a group
// summed by bin first weighing kDedupCost (fewer copies on a tie).
// Measured on an H100 (chip_ab.py --upd), four copies in slots beat two
// summed by bin at 28 features of 64 bins: 1.40 against 1.78 ms.
constexpr int kDedupCost = 3;

inline int upd_copies(const UpdHist& h, int per, size_t limit) {
  const int npairs = std::min(h.f_tile, h.nf) * h.V;
  int best = 1;
  long long best_cost = -1;
  for (int c = 1; c <= kUpdMaxCopies; c *= 2) {
    if (upd_smem(h.f_tile, h.V, h.nb, per, c, h.chunk, h.stripe) > limit) break;
    const int groups = upd_groups(c), lanes = 32 * (kUpdHistWarps / groups);
    const long long cost = (long long)((npairs + lanes - 1) / lanes) *
                           ((h.chunk + 4 * groups - 1) / (4 * groups)) * (c >= 4 ? 1 : kDedupCost);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

template <class U, bool UPDATE>
cudaError_t launch_hist(const U& u, const UpdHist& h, dim3 grid, size_t smem, cudaStream_t st) {
  if (h.copies >= 4)
    upd_hist_kernel<U, UPDATE, true><<<grid, kUpdThreads, smem, st>>>(u, h);
  else
    upd_hist_kernel<U, UPDATE, false><<<grid, kUpdThreads, smem, st>>>(u, h);
  return cudaGetLastError();
}

// Refresh the channels of u.n rows and, with `with_hist`, histogram them
// into h.out.  slot0 .. slot0 + 3 name the four histogram kernels of U
// (common.cuh kernel_limits).
template <class U>
int run_update_hist(const U& u, UpdHist h, int with_hist, int slot0, cudaStream_t st) {
  if (!with_hist) return (int)launch_update_only(u, st);
  int sms = 0;
  size_t limit = ~(size_t)0;
  const void* kernels[4] = {
      (const void*)upd_hist_kernel<U, true, false>, (const void*)upd_hist_kernel<U, true, true>,
      (const void*)upd_hist_kernel<U, false, false>, (const void*)upd_hist_kernel<U, false, true>};
  for (int i = 0; i < 4; ++i) {
    size_t l = 0;
    cudaError_t e = kernel_limits(kernels[i], slot0 + i, &sms, &l);
    if (e != cudaSuccess) return (int)e;
    limit = std::min(limit, l);
  }
  // the widest feature tile that fits one copy of the cells (down to one
  // feature), then tight stripes, then the longest chunk (down to 4
  // rows), then the copies
  const int per = 32 / h.bits;
  auto fits = [&] { return upd_smem(h.f_tile, h.V, h.nb, per, 1, h.chunk, h.stripe) <= limit; };
  h.f_tile = h.nf;
  h.chunk = kUpdChunk;
  h.stripe = pair_stripe(h.f_tile * h.V, false);
  while (h.f_tile > 1 && !fits()) {
    h.f_tile = h.f_tile > per ? std::max(per, (h.f_tile - 1) / per * per) : 1;
    h.stripe = pair_stripe(h.f_tile * h.V, false);
  }
  if (!fits()) h.stripe = pair_stripe(h.f_tile * h.V, true);
  while (h.chunk > 4 && !fits()) h.chunk /= 2;
  if (!fits()) return (int)cudaErrorInvalidValue;
  h.copies = upd_copies(h, per, limit);
  const size_t smem = upd_smem(h.f_tile, h.V, h.nb, per, h.copies, h.chunk, h.stripe);
  const int tiles = (h.nf + h.f_tile - 1) / h.f_tile;
  const long long want = (u.n + kUpdMinRows - 1) / kUpdMinRows;
  const int blocks = (int)std::min<long long>(std::max<long long>(want, 1), sms);
  cudaError_t e;
  if (tiles == 1) {
    e = launch_hist<U, true>(u, h, dim3(blocks, 1), smem, st);
  } else {
    e = launch_update_only(u, st);
    if (e == cudaSuccess) e = launch_hist<U, false>(u, h, dim3(blocks, tiles), smem, st);
  }
  if (e != cudaSuccess) cudaMemsetAsync(h.ticket, 0, sizeof(unsigned), st);
  return (int)e;
}

}  // namespace lgbt
