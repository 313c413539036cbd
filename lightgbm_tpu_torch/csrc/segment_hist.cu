// hist_segment / hist_segment_q / hist_dyn / hist_segments for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py hist_segment
// (_hist_kernel), hist_segment_q (_hist_kernel_q) and hist_segments
// (_hist_multi_kernel), and lightgbm_tpu/ops/pkernels.py hist_dyn
// (_hist_kernel): the (F, B, 3) histogram of (grad*sel, hess*sel, sel)
// over the columns [lo, hi) of a packed int32 matrix, read from the given
// (grad, hess, select) channel rows.  hist_segments runs it once a
// segment.  Bin words of 4, 8 or 16 bits.
//
// Two instantiations of one design:
//  - float (B6, B7, B8): the channels are float32 bit patterns; cells
//    are float64 (common.cuh hacc), rounded to the float32 output once;
//  - quantized (B9): the channels are int16 levels stored as plain int32
//    words (ops/histogram.py pack_columns_q); cells are int32.  Integer
//    adds are exact in any order, so the result equals the plain
//    version's bit for bit.
//
// What bounds it on this card: bytes.  The function reads the select word
// of every column of [lo, hi) and the W bin words, g and h of each
// selected one, and writes F*B*3 cells.  The mask grower calls it once a
// leaf over all N columns, and a leaf holds a few percent of them, so
// what a launch costs must follow the selected rows, not hi - lo.  In
// practice a selected row's W + 2 words lie in W + 2 channel rows, one
// 32-byte sector each (the gather bounds B9 at 10.5M rows), and a
// block's float64 read-add-writes are a chain of shared-memory latencies
// (they bound B8).
//
// Design, two launches from one call:
//  (a) seg_compact_kernel streams the select row of [lo, hi), sixteen
//      columns a thread in four 16-byte loads, and appends the selected
//      columns to an index list: one block-wide scan, one atomicAdd
//      ticket a block, and the block's part written from shared memory
//      in coalesced stores.  The histogram is order-free, so the list
//      needs no order and no look-back.
//  (b) seg_hist_kernel<Q, kFull>: at most one 512-thread block an SM (times
//      the feature tiles).  Each block reads the list's length; only as
//      many blocks as the list has kBlockRows-row shares take part, each
//      an equal share; the others return before touching shared memory.
//      Stage warps gather a chunk's rows (the block's bin words, g*sel,
//      h*sel, sel) into shared memory, double-buffered, while histogram
//      warps add the previous chunk into their own copy of the cells.
//      sm_90a has no shared float64 add (atomicAdd there is a
//      compare-and-swap loop, ATOMS.CAST.SPIN.64), so no cell is shared:
//      a histogram warp takes one copy's rows and a group of 32 (or 16)
//      features, a lane owns a feature (groups of lanes split the bins
//      below 17 features), reads four staged rows with each 16-byte load
//      and sums rows of one bin in registers before its read-add-writes.
//      The cells of 128 bytes of features interleave (stripe_of), so the
//      lanes of a warp never share a bank.  The block adds its copies and
//      sends the nonzero cells to a global accumulator with native
//      reductions (float64 or int32 REDG).  The last block, by ticket,
//      rounds (copies) the accumulator to the output, zeroes it and the
//      two counters for the next call, and adds the list's length to a
//      tally.
// Carry mode (out-of-core training, ops/histogram.py
// accumulate_histogram): the accumulator is a caller-owned (F, B, 3)
// carry, float64 (B8) or int32 (B9), that the launch only adds to; the
// last block resets the list's length and the ticket but neither rounds
// nor zeroes the carry.  Chunks of rows fold into one carry launch after
// launch, and seg_round_kernel rounds a float64 carry to float32 once,
// after the last chunk: the float64 sums of a row set do not depend on
// how its rows were cut, so the folded histogram is the one a single
// launch over all the rows gives.
// Many bins: the features are tiled over gridDim.y, down to one feature a
// tile (the stripes then narrow to the tile), and the staged chunk
// shortens from 256 rows to 4 when even that does not fit; so float64
// cells take up to about 9,670 bins, int32 ones twice that.
// The list, the counters and the accumulator are the wrapper's workspace
// (ops/histogram.py), one for each stream of a card.  A failed launch
// zeroes the counters again.
#include "common.cuh"

namespace lgbt {

constexpr int kCompactRows = 16;               // columns a compaction thread reads
constexpr int kHistThreads = 512;              // a histogram block: one an SM
constexpr int kHistChunk = 256;                // rows a block stages at a time, at most
constexpr int kHistMaxCopies = 8;              // copies of the cells
constexpr int kHistMaxWarps = 8;               // histogram warps (the rest stage rows)
constexpr int kBlockRows = 64;                 // fewest listed rows a histogram block takes
static_assert(kHistThreads - 32 * kHistMaxWarps >= kHistChunk, "a stage thread a chunk row");

struct SegHistArgs {
  const int32_t* P;
  long long ld;
  int lo, hi;
  int bits, nf, nb, f_tile, copies;
  int stripe;          // features of a stripe of cells (stripe_for)
  int chunk;           // rows a block stages at a time; a channel holds chunk + 4
  int row_g, row_h, row_sel;
  int* idx;            // (>= hi - lo,) columns of the selected rows
  int* count;          // the list's length; 0 between calls
  unsigned* ticket;    // histogram blocks done; 0 between calls
  void* acc;           // (F, B, 3) cells; 0 between calls
  long long* tally;    // selected rows summed over calls, or null
  void* out;           // (F, B, 3) float32 (float) or int32 (quantized)
  int carry;           // acc is the caller's carry: no rounding, no zeroing
};

// float channels into float64 cells, or int levels into int32 cells
template <bool Q>
struct HistTypes {
  using value = float;
  using cell = hacc;
  using out = float;
};

template <>
struct HistTypes<true> {
  using value = int;
  using cell = int;
  using out = int;
};

template <bool Q>
__device__ __forceinline__ bool is_selected(int32_t s) {
  return Q ? s != 0 : __int_as_float(s) != 0.0f;  // -0.0f is not selected
}

// (a): the columns of [lo, hi) whose select is not 0, appended to idx.
// q0 <= lo is the first column of a 16-byte aligned group of the select row.
template <bool Q>
__global__ void __launch_bounds__(kThreads) seg_compact_kernel(SegHistArgs a, long long q0) {
  __shared__ int warp_sums[32];
  __shared__ int base;
  __shared__ int list[kThreads * kCompactRows];  // the block's part of the list, in order
  const int32_t* sel = a.P + (long long)a.row_sel * a.ld;
  const long long c0 = q0 + ((long long)blockIdx.x * kThreads + threadIdx.x) * kCompactRows;
  int4 v[kCompactRows / 4];
#pragma unroll
  for (int u = 0; u < kCompactRows / 4; ++u)
    v[u] = c0 + 4 * u < a.hi ? __ldg(reinterpret_cast<const int4*>(sel + c0) + u)
                             : make_int4(0, 0, 0, 0);
  unsigned bits = 0;
#pragma unroll
  for (int u = 0; u < kCompactRows / 4; ++u) {
    const int32_t s[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long c = c0 + 4 * u + e;
      if (c >= a.lo && c < a.hi && is_selected<Q>(s[e])) bits |= 1u << (4 * u + e);
    }
  }
  const int mine = __popc(bits);
  int total;
  const int incl = block_incl_scan(mine, warp_sums, &total);
  if (total == 0) return;
  if (threadIdx.x == 0) base = atomicAdd(a.count, total);
  int pos = incl - mine;
  while (bits) {
    const int e = __ffs(bits) - 1;
    bits &= bits - 1;
    list[pos++] = (int)(c0 + e);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += kThreads) a.idx[base + i] = list[i];  // coalesced
}

// Stage one selected column: the block's bin words and (g*sel, h*sel,
// sel), the value loads issued before the words'.
template <bool Q>
__device__ __forceinline__ void stage_row(const SegHistArgs& a, long long r, int w0, int nwords,
                                          int32_t* sw, typename HistTypes<Q>::value* sv, int i,
                                          int stride) {
  const int32_t g = __ldg(a.P + (long long)a.row_g * a.ld + r);
  const int32_t h = __ldg(a.P + (long long)a.row_h * a.ld + r);
  const int32_t s = __ldg(a.P + (long long)a.row_sel * a.ld + r);
  for (int c0 = 0; c0 < nwords; c0 += 8) {  // eight loads in flight
    int32_t w[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < nwords) w[u] = __ldg(a.P + (long long)(w0 + c0 + u) * a.ld + r);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < nwords) sw[(c0 + u) * stride + i] = w[u];
  }
  if constexpr (Q) {
    sv[i] = g * s;
    sv[stride + i] = h * s;
    sv[2 * stride + i] = s;
  } else {
    const float sf = __int_as_float(s);
    sv[i] = __int_as_float(g) * sf;
    sv[stride + i] = __int_as_float(h) * sf;
    sv[2 * stride + i] = sf;
  }
}

// Features of a stripe of cells for a feature tile of f_tile: whole
// 128-byte stripes (stripe_of), or the power of two at or above f_tile
// where that is narrower, so a narrow tile of many bins holds no empty
// cells.
__host__ __device__ __forceinline__ int stripe_for(int f_tile, size_t cell) {
  int s = 1;
  while (s < f_tile && s < stripe_of(cell)) s <<= 1;
  return s;
}

// Shared-memory bytes of a histogram block: `copies` copies of the cells
// of f_tile features, then two staging buffers of nwords bin words and
// three values, `chunk` rows each.  A feature tile starts at a multiple
// of f_tile, within one word when f_tile < per.
inline size_t seg_smem(int f_tile, int nb, int per, int copies, size_t cell, int chunk) {
  const int nwords = (f_tile + per - 1) / per;
  return align16((size_t)copies * stripe_span(f_tile, nb, stripe_for(f_tile, cell)) * cell) +
         (size_t)2 * (nwords + 3) * (chunk + 4) * 4;
}

// (b): the histogram of the listed columns.  kFull: the stripe is
// stripe_of(cell) and the chunk kHistChunk, as compile-time constants
// (the usual case; reading them at run time cost B8 11 % a launch);
// otherwise a.stripe and a.chunk.
template <bool Q, bool kFull>
__global__ void __launch_bounds__(kHistThreads, 1) seg_hist_kernel(SegHistArgs a) {
  using V = typename HistTypes<Q>::value;
  using C = typename HistTypes<Q>::cell;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const int count = *a.count;  // the compaction launch's, ended before this one
  const int active = max(1, min((int)gridDim.x, (count + kBlockRows - 1) / kBlockRows));
  if ((int)blockIdx.x >= active) return;

  const int per = 32 / a.bits;
  const int f0 = blockIdx.y * a.f_tile, f1 = min(f0 + a.f_tile, a.nf), nfl = f1 - f0;
  const int S = kFull ? stripe_of(sizeof(C)) : a.stripe;
  const int chunk = kFull ? kHistChunk : a.chunk, stride = chunk + 4;
  const int span = stripe_span(nfl, a.nb, S);  // cells of one copy
  const int w0 = f0 / per, nwords = (f1 - 1) / per - w0 + 1;
  const int copies = a.copies;
  C* hs = reinterpret_cast<C*>(smem);
  int32_t* sw = reinterpret_cast<int32_t*>(smem + align16((size_t)copies * span * sizeof(C)));
  V* sv = reinterpret_cast<V*>(sw + 2 * nwords * stride);
  const int b0 = (int)((long long)count * blockIdx.x / active);
  const int b1 = (int)((long long)count * (blockIdx.x + 1) / active);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;

  if (b1 > b0) {
    for (int i = threadIdx.x; i < copies * span; i += kHistThreads) hs[i] = 0;
    __syncthreads();
    const int nchunks = (b1 - b0 + chunk - 1) / chunk;
    // each copy's features in groups of fw, a histogram warp each: 32, or
    // 16 (two lane groups split the bins) where that gives more warps
    const int fw = nfl > 16 && copies * ((nfl + 31) / 32) * 2 <= kHistMaxWarps ? 16 : 32;
    const int fgroups = max(1, min((nfl + fw - 1) / fw, kHistMaxWarps / copies));
    const int hwarps = copies * fgroups;
    if (wid >= hwarps) {
      // stage warps: chunk k into buffer k & 1, row st of it by thread st
      const int st = threadIdx.x - 32 * hwarps;
      for (int k = 0; k <= nchunks; ++k) {
        if (k < nchunks) {
          const int c0 = b0 + k * chunk;
          if (st < min(chunk, b1 - c0))
            stage_row<Q>(a, a.idx[c0 + st], w0, nwords, sw + (k & 1) * nwords * stride,
                         sv + (k & 1) * 3 * stride, st, stride);
        }
        __syncthreads();
      }
    } else {
      // histogram warp wid adds every copies-th four rows of a chunk into
      // copy cp of the cells, for feature group fg: lane fl of lane group
      // sub takes feature f0 + fg*g + fl (+ k*g*fgroups) and the bins of
      // range sub, so no other thread touches its cells
      const int cp = wid % copies, fg = wid / copies;
      int g = 32;
      while (g > 1 && g / 2 >= min(nfl, fw)) g >>= 1;
      const int ranges = 32 / g, sub = lane / g, fl = lane % g;
      const int bpr = (a.nb + ranges - 1) / ranges;
      const int blo = sub * bpr;
      const unsigned nbr = (unsigned)max(0, min(blo + bpr, a.nb) - blo);
      const unsigned vmask = (1u << a.bits) - 1u;
      C* const hw = hs + cp * span;
      for (int k = 0; k <= nchunks; ++k) {
        if (k > 0) {
          const int kc = k - 1;
          const int nrows = min(chunk, b1 - b0 - kc * chunk);
          const int32_t* swk = sw + (kc & 1) * nwords * stride;
          const V* svk = sv + (kc & 1) * 3 * stride;
          for (int f = f0 + fg * g + fl; f < f1; f += g * fgroups) {
            const int32_t* wrow = swk + (f / per - w0) * stride;
            const int sh = (f % per) * a.bits;
            C* base = hw + (f - f0) / S * a.nb * 3 * S + (f - f0) % S;
            // the next four rows load before this four's adds
            int i = 4 * cp;
            Staged4<V> cur;
            if (i < nrows) cur.load(wrow, svk, i, stride);
            for (; i < nrows; i += 4 * copies) {
              Staged4<V> nxt = cur;
              if (i + 4 * copies < nrows) nxt.load(wrow, svk, i + 4 * copies, stride);
              add_rows4<V, C>(cur, nrows - i, sh, vmask, blo, nbr, base, 3 * S, S);
              cur = nxt;
            }
          }
        }
        __syncthreads();
      }
    }
    // the block's copies summed, in shared-memory order (consecutive
    // threads on consecutive banks); nonzero cells to the accumulator
    C* acc = reinterpret_cast<C*>(a.acc) + (long long)f0 * a.nb * 3;
    const int nb3 = a.nb * 3;
    for (int j = threadIdx.x; j < span; j += kHistThreads) {
      // j = (lf / S * nb3 + bin * 3 + v) * S + lf % S
      const int lf = j / (nb3 * S) * S + j % S;
      if (lf >= nfl) continue;
      C v = 0;
      for (int c = 0; c < copies; ++c) v += hs[c * span + j];
      if (v != 0) atomicAdd(acc + (long long)lf * nb3 + j / S % nb3, v);
    }
  }

  // the last block rounds the accumulator to the output and resets (a
  // carry stays as the blocks left it)
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == (unsigned)(active * gridDim.y - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (a.carry) {
    if (threadIdx.x == 0) {
      if (a.tally) *a.tally += count;
      *a.count = 0;
      *a.ticket = 0;
    }
    return;
  }
  C* acc = reinterpret_cast<C*>(a.acc);
  auto* out = reinterpret_cast<typename HistTypes<Q>::out*>(a.out);
  const int cells = a.nf * a.nb * 3;
  for (int i0 = threadIdx.x; i0 < cells; i0 += 8 * kHistThreads) {
    C v[8];  // eight loads in flight before the stores
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * kHistThreads < cells) v[u] = __ldcg(acc + i0 + u * kHistThreads);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + u * kHistThreads < cells) {
        out[i0 + u * kHistThreads] = (typename HistTypes<Q>::out)v[u];
        acc[i0 + u * kHistThreads] = 0;
      }
  }
  if (threadIdx.x == 0) {
    if (a.tally) *a.tally += count;
    *a.count = 0;
    *a.ticket = 0;
  }
}

// A float64 carry rounded to float32, once a cell.
__global__ void __launch_bounds__(kThreads) seg_round_kernel(const hacc* carry, float* out,
                                                             long long cells) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < cells;
       i += (long long)gridDim.x * kThreads)
    out[i] = (float)__ldg(carry + i);
}

// Zero the list's length and the ticket after a failed launch, so the
// workspace is ready for the next call; returns the launch's error.
inline int reset_after(cudaError_t e, const SegHistArgs& a, cudaStream_t st) {
  cudaMemsetAsync(a.count, 0, sizeof(int), st);
  cudaMemsetAsync(a.ticket, 0, sizeof(unsigned), st);
  return (int)e;
}

template <bool Q>
int launch_seg_hist(SegHistArgs a, cudaStream_t st) {
  if (a.hi <= a.lo) return (int)cudaErrorInvalidValue;
  int sms = 0;
  size_t limit = 0, limit_full = 0;
  cudaError_t e = kernel_limits(seg_hist_kernel<Q, false>, 2 * Q, &sms, &limit);
  if (e == cudaSuccess) e = kernel_limits(seg_hist_kernel<Q, true>, 2 * Q + 1, &sms, &limit_full);
  if (e != cudaSuccess) return (int)e;
  limit = std::min(limit, limit_full);
  // the widest feature tile that fits one copy of the cells (down to one
  // feature), then the longest chunk (down to 4 rows), then as many
  // copies (histogram warps) as fit
  const size_t cell = sizeof(typename HistTypes<Q>::cell);
  const int per = 32 / a.bits;
  a.f_tile = a.nf;
  a.chunk = kHistChunk;
  while (a.f_tile > 1 && seg_smem(a.f_tile, a.nb, per, 1, cell, a.chunk) > limit)
    a.f_tile = a.f_tile > per ? std::max(per, (a.f_tile - 1) / per * per) : 1;
  while (a.chunk > 4 && seg_smem(a.f_tile, a.nb, per, 1, cell, a.chunk) > limit) a.chunk /= 2;
  if (seg_smem(a.f_tile, a.nb, per, 1, cell, a.chunk) > limit) return (int)cudaErrorInvalidValue;
  a.copies = 1;
  while (a.copies < kHistMaxCopies &&
         seg_smem(a.f_tile, a.nb, per, a.copies + 1, cell, a.chunk) <= limit)
    ++a.copies;
  a.stripe = stripe_for(a.f_tile, cell);
  const size_t smem = seg_smem(a.f_tile, a.nb, per, a.copies, cell, a.chunk);
  const int ftiles = (a.nf + a.f_tile - 1) / a.f_tile;

  // (a) from the 16-byte group that holds column lo of the select row
  const uintptr_t at = (uintptr_t)(a.P + (long long)a.row_sel * a.ld + a.lo);
  const long long q0 = a.lo - (long long)((at & 15) / 4);
  const long long per_block = (long long)kThreads * kCompactRows;
  const long long cblocks = (a.hi - q0 + per_block - 1) / per_block;
  seg_compact_kernel<Q><<<(unsigned)cblocks, kThreads, 0, st>>>(a, q0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return reset_after(e, a, st);
  // (b) enough blocks for every row selected; the surplus return at once
  const long long most = (a.hi - a.lo + kBlockRows - 1) / kBlockRows;
  const int blocks = (int)std::min<long long>(sms, most);
  const dim3 grid(blocks, ftiles);
  if (a.stripe == stripe_of(cell) && a.chunk == kHistChunk)
    seg_hist_kernel<Q, true><<<grid, kHistThreads, smem, st>>>(a);
  else
    seg_hist_kernel<Q, false><<<grid, kHistThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return reset_after(e, a, st);
  return 0;
}

}  // namespace lgbt

// The (F, B, 3) histogram of columns [lo, hi) into out: float32 from
// float64 cells (B6, B7, B8), or int32 of int32-word levels (B9).
// work: the cached workspace, as int32 words [count, ticket, idx (hi - lo
// at least)]; acc: F*B*3 zeroed 8-byte cells; tally: int64 or null.
extern "C" int lgbt_segment_hist(void* P, long long ld, int lo, int hi, int bits, int nf, int nb,
                                 int row_g, int row_h, int row_sel, int quantized, void* work,
                                 void* acc, void* tally, void* out, void* stream) {
  lgbt::SegHistArgs a{};
  a.P = (const int32_t*)P;
  a.ld = ld;
  a.lo = lo;
  a.hi = hi;
  a.bits = bits;
  a.nf = nf;
  a.nb = nb;
  a.row_g = row_g;
  a.row_h = row_h;
  a.row_sel = row_sel;
  a.count = (int*)work;
  a.ticket = (unsigned*)work + 1;
  a.idx = (int*)work + 2;
  a.acc = acc;
  a.tally = (long long*)tally;
  a.out = out;
  if (quantized) return lgbt::launch_seg_hist<true>(a, (cudaStream_t)stream);
  return lgbt::launch_seg_hist<false>(a, (cudaStream_t)stream);
}

// The carry mode of the same kernels: the selected rows of columns
// [lo, hi) added into carry, an (F, B, 3) float64 (float) or int32
// (quantized) tensor that the caller zeroes once and keeps across launches.
extern "C" int lgbt_segment_hist_carry(void* P, long long ld, int lo, int hi, int bits, int nf,
                                       int nb, int row_g, int row_h, int row_sel, int quantized,
                                       void* work, void* carry, void* tally, void* stream) {
  lgbt::SegHistArgs a{};
  a.P = (const int32_t*)P;
  a.ld = ld;
  a.lo = lo;
  a.hi = hi;
  a.bits = bits;
  a.nf = nf;
  a.nb = nb;
  a.row_g = row_g;
  a.row_h = row_h;
  a.row_sel = row_sel;
  a.count = (int*)work;
  a.ticket = (unsigned*)work + 1;
  a.idx = (int*)work + 2;
  a.acc = carry;
  a.tally = (long long*)tally;
  a.out = nullptr;
  a.carry = 1;
  if (quantized) return lgbt::launch_seg_hist<true>(a, (cudaStream_t)stream);
  return lgbt::launch_seg_hist<false>(a, (cudaStream_t)stream);
}

// out (float32) = carry (float64) rounded, `cells` cells.
extern "C" int lgbt_segment_hist_round(void* carry, void* out, long long cells, void* stream) {
  if (cells <= 0) return 0;
  const long long blocks = std::min<long long>((cells + lgbt::kThreads - 1) / lgbt::kThreads,
                                               4096);
  lgbt::seg_round_kernel<<<(unsigned)blocks, lgbt::kThreads, 0, (cudaStream_t)stream>>>(
      (const lgbt::hacc*)carry, (float*)out, cells);
  return (int)cudaGetLastError();
}
