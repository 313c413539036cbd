// level_stream / split_stream for Hopper (sm_90a).
//
// Replaces lightgbm_tpu/ops/pkernels.py level_stream (_level_kernel) and
// split_stream (_split_kernel), both built on _run_segment: for each
// active leaf segment [start, start+cnt) of the packed matrix, partition
// the rows by the segment's split predicate (lefts to [start, start+nl),
// rights after them, both in row order) and return both children's
// (F, B, 3) histograms from the same pass.  level_stream reads its
// segments from a table; split_stream passes its one segment by value.
//
// What bounds it on this card: bytes in principle.  The function reads
// and writes every active row's C channels once (8C B/row).  This design
// moves 16C B/row (the in-place contract forces a scratch copy and a
// copy back) and reads the predicate word once more, so it cannot reach
// half its bound.  In practice the histograms bound it: 3 float64 adds
// into shared memory per row and feature, with no native float64 shared
// atomic to make them.
//
// Design, two launches:
//   (a) part_scatter_kernel: one 512-thread block per (row tile, feature
//       tile), one block an SM.  The lead block of a row tile (feature
//       tile 0) takes its tile index from an atomic ticket, so every tile
//       it waits on already runs.  Pass 1 stores the tile's left bits in
//       shared memory (one ballot word per 32 rows); the lead block
//       publishes the tile's left count and looks back over its
//       predecessors' words (decoupled look-back, one warp reads 32 of
//       them at a time) for the lefts before it; the tile that ends its
//       segment writes nl.  Pass 2 takes 256 rows at a time,
//       double-buffered:
//       - the stage warps write each row's C channels into the segment's
//         scratch (lefts from the front in order, rights from the back in
//         reverse order, which needs no total; sixteen loads in flight a
//         thread) and stage the rows' bin words, g*sel, h*sel and sel in
//         shared memory from the same registers, lefts first, then rights;
//       - meanwhile the histogram warps add the previous chunk into
//         float64 shared-memory cells.  sm_90a has no shared float64 add
//         (atomicAdd there is a compare-and-swap loop, ATOMS.CAST.SPIN.64
//         in the SASS), so no cell is shared: each histogram warp adds one
//         child's rows into its own copy of that child's cells (as many
//         copies as shared memory holds, up to 4: 2 at 28 features of 64
//         bins, so four warps, one on each of the SM's schedulers); a lane
//         owns one feature (groups of lanes split the bins below 17
//         features), reads four staged rows with each 16-byte load and
//         sums rows of one bin in registers before its read-add-writes.
//         The cells of 16 features interleave, so the lanes of a warp hit
//         two banks at most.
//       The block adds its copies and flushes the nonzero cells into the
//       segment's global float64 cells (a native float64 reduction in L2).
//   (b) part_copy_kernel: moves each segment back from scratch (the
//       rights re-reversed, so the partition is stable and equals the
//       plain version bit for bit) and rounds the float64 cells to the
//       float32 output once.
// Rows per tile: pkernels.py partition_tile of the active rows.  The
// segment table form (level_stream, and split_stream given device
// scalars) reads its segments and n_active from device memory, so a
// CUDA graph can replay it for any counts: a one-block plan kernel
// (part_plan_kernel) clamps each segment to the matrix, empties the rows
// at or past n_active, and writes the tile and each segment's first tile
// on the card; the grid is a static bound (pkernels.py partition_grid:
// max(SMs, N / max tile) + segments row tiles, as the active segments are
// disjoint), and blocks past the last tile return at once.  split_stream
// given host ints passes its segment, tile and tile count by value.
// Features are tiled over gridDim.y so any F*B fits 227 KB.  Columns
// outside the active segments are never written.  The look-back words,
// the ticket and the float64 cells live in a workspace cached for each
// stream (ops/histogram.py stream_workspace), which the copy kernel
// leaves zeroed for the next call.  The float64 sums make the rounded
// histograms independent of the order of the additions but for sums
// within ~1e-16 of a float32 rounding boundary.
#include "common.cuh"

namespace lgbt {

constexpr int kChunk = 256;          // rows a block stages at a time
constexpr int kStride = kChunk + 4;  // a staged channel: 16-byte rows, 4 banks on per channel
constexpr int kStripe = stripe_of(sizeof(hacc));  // cells of 16 features interleave (common.cuh)
constexpr int kPartThreads = 512;    // a scatter block: one a SM, warps on all four schedulers
constexpr int kMaxCopies = 4;        // histogram warps, each with its own copy of the cells
constexpr int kTileStep = 512;       // a tile is a whole number of these rows (pkernels.py PART_CHUNK)
constexpr int kPlanThreads = 512;    // the plan kernel: one thread a segment
constexpr int kSegFields = 12;       // a row of the clamped segment table

// The launch's form, a template argument so that a profile names it:
// one segment by value (split_stream given host ints), or the segment
// table of level_stream, or of split_stream given device scalars.
enum PartForm { kByValue = 0, kLevelTable = 1, kSplitTable = 2 };

struct PartArgs {
  int32_t* P;
  long long ld;
  int C;
  int32_t* S;  // scratch: channel c, column j of segment s at S[c * sld + soff(s) + j]
  long long sld;
  const int32_t* seg;   // table form: the plan's clamped (n_seg, 12) table
  const int32_t* plan;  // table form: [tile, total tiles, first tile of each segment, total]
  SegParams one;        // by value: the segment
  int n_seg;
  int tile, total;  // by value: rows a tile and tiles; table form: the largest tile (shared memory)
  unsigned long long* flags;  // (tiles,) look-back words, zero
  int* ticket;                // zero
  int* nl;                    // (n_seg,): zeroed by the plan kernel (table form)
  int bits, nf, nb, f_tile, copies;
  int row_g, row_h, row_sel;
  hacc* acc;  // (n_seg, 2, F, B, 3), zero
  float* out;  // (out_cells,): acc rounded
  long long out_cells;
  int sms;
};

// Rows a tile and tiles of this launch.
template <int kForm>
__device__ __forceinline__ void plan_of(const PartArgs& a, int* tile, int* total) {
  constexpr bool kTable = kForm != kByValue;
  if (kTable) {
    *tile = a.plan[0];
    *total = a.plan[1];
  } else {
    *tile = a.tile;
    *total = a.total;
  }
}

template <int kForm>
__device__ __forceinline__ void tile_of(const PartArgs& a, int b, int* s, SegParams* p, int* t) {
  constexpr bool kTable = kForm != kByValue;
  if (kTable) {
    const int32_t* base = a.plan + 2;
    *s = seg_of_tile(base, a.n_seg, b);
    *p = load_seg(a.seg, *s);
    *t = b - base[*s];
  } else {
    *s = 0;
    *p = a.one;
    *t = b;
  }
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* q) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(q) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* q, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(q), "l"(v) : "memory");
}

constexpr unsigned long long kAggregate = 1ull << 32, kInclusive = 2ull << 32;

// Warp 0 of tile t of a segment (flat index b): publish the tile's left
// count, then sum its predecessors' counts back to the nearest one that
// has published its inclusive prefix.  Returns the lefts before the tile
// (in every lane) and publishes the tile's own inclusive prefix.
__device__ long long look_back(unsigned long long* flags, int b, int t, int agg) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) st_release(flags + b, kInclusive | (unsigned)agg);
    return 0;
  }
  if (lane == 0) st_release(flags + b, kAggregate | (unsigned)agg);
  long long excl = 0;
  for (int pos = t - 1;;) {
    const int q = pos - lane;  // lane 0 reads the nearest predecessor
    const unsigned long long v = q >= 0 ? ld_acquire(flags + b - t + q) : kInclusive;
    const unsigned state = (unsigned)(v >> 32);
    if (__any_sync(0xffffffffu, state == 0)) {
      __nanosleep(20);
      continue;
    }
    const unsigned inc = __ballot_sync(0xffffffffu, state == 2);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    long long val = lane <= stop ? (long long)(uint32_t)v : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) val += __shfl_xor_sync(0xffffffffu, val, o);
    excl += val;
    if (inc) break;
    pos -= 32;
  }
  if (lane == 0) st_release(flags + b, kInclusive | (unsigned)(excl + agg));
  return excl;
}

// Lefts of a staged chunk, from its left bits.
__device__ __forceinline__ int chunk_lefts(const uint32_t* cball) {
  int n = 0;
#pragma unroll
  for (int q = 0; q < kChunk / 32; ++q) n += __popc(cball[q]);
  return n;
}

// First staging slot of a chunk's rights: the lefts' end rounded up to
// four rows (one 16-byte load).
__device__ __forceinline__ int rights_slot(int chunk_l) { return (chunk_l + 3) & ~3; }

// Stage one row's g*sel, h*sel and sel (float32 bit patterns in).
__device__ __forceinline__ void stage_values(float* sv, int i, int32_t g, int32_t h, int32_t sel) {
  const float selv = __int_as_float(sel);
  sv[i] = __int_as_float(g) * selv;
  sv[kStride + i] = __int_as_float(h) * selv;
  sv[2 * kStride + i] = selv;
}

// Shared memory of a scatter block: each histogram warp's copy of both
// children's cells, two staging buffers (bin words, then g*sel, h*sel,
// sel) and the tile's left bits.
struct PartSmem {
  hacc* hs;     // [copies][2][span]
  int32_t* w;   // [2][nwords][kStride]
  float* v;     // [2][3][kStride]
  uint32_t* ball;  // [tile / 32]
};

__device__ __forceinline__ PartSmem carve(unsigned char* smem, int span, int nwords,
                                          int copies) {
  PartSmem m;
  m.hs = reinterpret_cast<hacc*>(smem);
  m.w = reinterpret_cast<int32_t*>(m.hs + 2 * copies * span);
  m.v = reinterpret_cast<float*>(m.w + 2 * nwords * kStride);
  m.ball = reinterpret_cast<uint32_t*>(m.v + 2 * 3 * kStride);
  return m;
}

template <int kForm>
__global__ void __launch_bounds__(kPartThreads, 1) part_scatter_kernel(PartArgs a) {
  constexpr bool kTable = kForm != kByValue;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_c[32];
  __shared__ int sh_b;
  __shared__ long long sh_before;

  const int per = 32 / a.bits;
  const int f0 = blockIdx.y * a.f_tile, f1 = min(f0 + a.f_tile, a.nf);
  const int span = stripe_span(f1 - f0, a.nb, kStripe);  // cells of one child
  const int w0 = f0 / per, nwords = (f1 - 1) / per - w0 + 1;
  const int copies = a.copies;
  const PartSmem m = carve(smem, span, nwords, copies);
  const bool lead = blockIdx.y == 0;  // partitions; other feature tiles only add

  int tile, total;
  plan_of<kForm>(a, &tile, &total);
  if (threadIdx.x == 0) sh_b = lead ? atomicAdd(a.ticket, 1) : (int)blockIdx.x;
  __syncthreads();
  const int b = sh_b;
  if (b >= total) return;  // a block of the static grid past the last tile
  for (int i = threadIdx.x; i < 2 * copies * span; i += kPartThreads) m.hs[i] = 0.0;
  __syncthreads();
  int s, t;
  SegParams p;
  tile_of<kForm>(a, b, &s, &p, &t);
  const long long r0 = p.start + (long long)t * tile;
  const long long r1 = min(r0 + (long long)tile, p.start + (long long)p.cnt);
  const unsigned vmask = (1u << a.bits) - 1u;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;

  // pass 1: the tile's left bits, one ballot word per 32 rows
  const int32_t* pword = a.P + (long long)p.word * a.ld;
  int c = 0;
  for (long long cb = r0; cb < r1; cb += kPartThreads) {
    const long long r = cb + threadIdx.x;
    const unsigned bw = __ballot_sync(0xffffffffu, r < r1 && goes_left(__ldg(pword + r), p, vmask));
    if (lane == 0) {
      m.ball[(cb - r0) / 32 + wid] = bw;
      c += __popc(bw);
    }
  }
  long long lbefore = 0;
  if (lead) {  // the tile's place among the segment's lefts
    int lefts;
    block_incl_scan(c, warp_c, &lefts);
    if (wid == 0) {
      const long long before = look_back(a.flags, b, t, lefts);
      if (lane == 0) {
        sh_before = before;
        if (r1 == p.start + (long long)p.cnt) a.nl[s] = (int)(before + lefts);
      }
    }
  }
  __syncthreads();
  if (lead) lbefore = sh_before;

  // pass 2, kChunk rows at a time, double-buffered: the stage warps write
  // chunk k's rows to the scratch and stage them while the histogram
  // warps add chunk k-1.
  const int nchunks = (int)((r1 - r0 + kChunk - 1) / kChunk);
  const int hwarps = 2 * copies;  // a left and a right histogram warp for each copy
  if (wid >= hwarps) {
    const int st = threadIdx.x - 32 * hwarps, nst = kPartThreads - 32 * hwarps;
    const long long rbefore = (long long)t * tile - lbefore;
    const long long soff = kTable ? p.start : 0;
    long long run_l = 0, run_r = 0;
    for (int k = 0; k <= nchunks; ++k) {
      if (k < nchunks) {
        const long long cb = r0 + (long long)k * kChunk;
        const int nrows = (int)min((long long)kChunk, r1 - cb);
        const uint32_t* cball = m.ball + k * (kChunk / 32);
        int32_t* sw = m.w + (k & 1) * nwords * kStride;
        float* sv = m.v + (k & 1) * 3 * kStride;
        const int chunk_l = chunk_lefts(cball);
        for (int i = st; i < nrows; i += nst) {
          const long long r = cb + i;
          const uint32_t bw = cball[i >> 5];
          int lrank = __popc(bw & ((1u << (i & 31)) - 1u));
          for (int q = 0; q < (i >> 5); ++q) lrank += __popc(cball[q]);
          const bool gl = (bw >> (i & 31)) & 1;
          // staged by side: lefts from slot 0, rights from a 16-byte boundary
          const int slot = gl ? lrank : rights_slot(chunk_l) + (i - lrank);
          if (lead) {
            const long long j = gl ? lbefore + run_l + lrank
                                   : p.cnt - 1 - (rbefore + run_r + (i - lrank));
            // every channel of the row into the scratch, sixteen loads in
            // flight; the loaded words are staged from the same registers
            int32_t* dst = a.S + soff + j;
            int32_t graw = 0, hraw = 0, sraw = 0;
            for (int c0 = 0; c0 < a.C; c0 += 16) {
              int32_t v[16];
#pragma unroll
              for (int u = 0; u < 16; ++u)
                if (c0 + u < a.C) v[u] = __ldg(a.P + (long long)(c0 + u) * a.ld + r);
#pragma unroll
              for (int u = 0; u < 16; ++u) {
                const int ch = c0 + u;
                if (ch < a.C) {
                  dst[(long long)ch * a.sld] = v[u];
                  if ((unsigned)(ch - w0) < (unsigned)nwords)
                    sw[(ch - w0) * kStride + slot] = v[u];
                  graw = ch == a.row_g ? v[u] : graw;
                  hraw = ch == a.row_h ? v[u] : hraw;
                  sraw = ch == a.row_sel ? v[u] : sraw;
                }
              }
            }
            stage_values(sv, slot, graw, hraw, sraw);
          } else {
            for (int w = 0; w < nwords; ++w)
              sw[w * kStride + slot] = __ldg(a.P + (long long)(w0 + w) * a.ld + r);
            stage_values(sv, slot, __ldg(a.P + (long long)a.row_g * a.ld + r),
                         __ldg(a.P + (long long)a.row_h * a.ld + r),
                         __ldg(a.P + (long long)a.row_sel * a.ld + r));
          }
        }
        run_l += chunk_l;
        run_r += nrows - chunk_l;
      }
      __syncthreads();
    }
  } else {
    // Histogram warp wid adds one child's staged rows (left for even wid)
    // into copy wid / 2 of the cells, every copies-th four of them: lane
    // fl of lane group sub takes feature f0 + fl (+ k*g) and the bins of
    // range sub, so no other thread touches its cells.
    const int side = wid & 1, cp = wid >> 1;
    const int nfl = f1 - f0;
    int g = 32;
    while (g > 1 && g / 2 >= nfl) g >>= 1;
    const int ranges = 32 / g, sub = lane / g, fl = lane % g;
    const int bpr = (a.nb + ranges - 1) / ranges;
    const int blo = sub * bpr;
    const unsigned nbr = (unsigned)max(0, min(blo + bpr, a.nb) - blo);
    hacc* const hw = m.hs + (2 * cp + side) * span;
    for (int k = 0; k <= nchunks; ++k) {
      if (k > 0) {
        const int kc = k - 1;
        const int nrows = (int)min((long long)kChunk, r1 - r0 - (long long)kc * kChunk);
        const int chunk_l = chunk_lefts(m.ball + kc * (kChunk / 32));
        const int lo = side ? rights_slot(chunk_l) : 0;
        const int hi = side ? lo + nrows - chunk_l : chunk_l;
        const int32_t* sw = m.w + (kc & 1) * nwords * kStride;
        const float* sv = m.v + (kc & 1) * 3 * kStride;
        for (int f = f0 + fl; f < f1; f += g) {
          const int32_t* wrow = sw + (f / per - w0) * kStride;
          const int sh = (f % per) * a.bits;
          hacc* base = hw + ((f - f0) / kStripe) * a.nb * 3 * kStripe + (f - f0) % kStripe;
          // the next four rows load before this four's adds
          int i = lo + 4 * cp;
          Staged4<float> cur;
          if (i < hi) cur.load(wrow, sv, i, kStride);
          for (; i < hi; i += 4 * copies) {
            Staged4<float> nxt = cur;
            if (i + 4 * copies < hi) nxt.load(wrow, sv, i + 4 * copies, kStride);
            add_rows4<float, hacc>(cur, hi - i, sh, vmask, blo, nbr, base, 3 * kStripe,
                                   kStripe);
            cur = nxt;
          }
        }
      }
      __syncthreads();
    }
  }

  const long long fb3 = (long long)a.nf * a.nb * 3;
  hacc* outl = a.acc + (long long)s * 2 * fb3 + (long long)f0 * a.nb * 3;
  hacc* outr = outl + fb3;
  const int nb3 = a.nb * 3;
  for (int i = threadIdx.x; i < (f1 - f0) * nb3; i += kPartThreads) {
    const int lf = i / nb3;
    const int j = ((lf / kStripe) * nb3 + i % nb3) * kStripe + lf % kStripe;
    hacc vl = 0.0, vr = 0.0;
    for (int h = 0; h < copies; ++h) {
      vl += m.hs[2 * h * span + j];
      vr += m.hs[(2 * h + 1) * span + j];
    }
    if (vl != 0.0) atomicAdd(outl + i, vl);
    if (vr != 0.0) atomicAdd(outr + i, vr);
  }
}

template <int kForm>
__device__ __forceinline__ int seg_cnt(const PartArgs& a, int s) {
  constexpr bool kTable = kForm != kByValue;
  return kTable ? a.seg[kSegFields * s + 1] : a.one.cnt;
}

// Row ranges a tile is cut into for the copy: enough for ~4 waves of
// 256-thread blocks over the tiles.
__host__ __device__ __forceinline__ int copy_split(int tile, int total, int sms) {
  const int by_tile = tile / kThreads, by_grid = 4 * 8 * sms / (total > 1 ? total : 1);
  const int ys = by_tile < by_grid ? by_tile : by_grid;
  return ys > 1 ? ys : 1;
}

// The copy kernel's blocks stride over (tile, row range) items, so the
// table form's static grid serves any tiling the plan picks.
template <int kForm>
__global__ void __launch_bounds__(kThreads) part_copy_kernel(PartArgs a) {
  constexpr bool kTable = kForm != kByValue;
  int tile, total;
  plan_of<kForm>(a, &tile, &total);
  const int ys = copy_split(tile, total, a.sms);
  for (long long v = blockIdx.x; v < (long long)total * ys; v += gridDim.x) {
    const int b = (int)(v / ys), y = (int)(v % ys);
    int s, t;
    SegParams p;
    tile_of<kForm>(a, b, &s, &p, &t);
    const long long r0 = p.start + (long long)t * tile;
    const long long r1 = min(r0 + (long long)tile, p.start + (long long)p.cnt);
    const long long q0 = r0 + (r1 - r0) * y / ys;
    const long long q1 = r0 + (r1 - r0) * (y + 1) / ys;
    const long long nls = a.nl[s];
    const long long soff = kTable ? p.start : 0;
    for (int c = 0; c < a.C; ++c) {
      int32_t* dst = a.P + (long long)c * a.ld;
      const int32_t* src = a.S + (long long)c * a.sld + soff;
      for (long long r = q0 + threadIdx.x; r < q1; r += 4 * kThreads) {  // four loads in flight
        int32_t w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const long long j = r + u * kThreads - p.start;
          if (r + u * kThreads < q1) w[u] = __ldg(src + (j < nls ? j : p.cnt - 1 + nls - j));
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r + u * kThreads < q1) dst[r + u * kThreads] = w[u];
      }
    }
    // the scatter kernel is done with the tile's look-back word: zero it
    // for the next launch on this stream
    if (y == 0 && threadIdx.x == 0) a.flags[b] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.ticket = 0;
  // round the float64 cells to the output once, leaving them zeroed (an
  // empty segment's were never written)
  const long long seg_cells = 2LL * a.nf * a.nb * 3;
  const long long nthreads = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < a.out_cells;
       i += nthreads) {
    const int s = (int)(i / seg_cells);
    float v = 0.0f;
    if (s < a.n_seg && seg_cnt<kForm>(a, s) > 0) {
      const hacc x = a.acc[i];
      v = (float)x;
      if (x != 0.0) a.acc[i] = 0.0;
    }
    a.out[i] = v;
  }
}

// The table form's plan, one block: thread s clamps segment s of the raw
// table (`stride` int32 a row: start, cnt, word, shift, zero_bin, dbz,
// thr, is_cat, off_lo, off_hi, bias) to the matrix's rows and channels,
// empties it when s >= n_active, and zeroes its left count; then the
// rows a tile (pkernels.py partition_tile of the active rows) and each
// segment's first tile, as the tiles of the segments before it.
struct PlanArgs {
  const int32_t* tab;
  int stride, n_seg;
  const int32_t* n_active;  // null: every row is active
  long long rows;
  int C, sms, tile_max;
  int32_t* seg;   // (n_seg, 12) out
  int32_t* plan;  // (n_seg + 3,) out: tile, total, first tiles, total
  int* nl;        // (n_seg,) out, zeroed
  unsigned long long* tally;  // null, or [0] += the active rows, [1] += 1 if any
};

__global__ void __launch_bounds__(kPlanThreads) part_plan_kernel(PlanArgs a) {
  __shared__ int warp_c[32];
  __shared__ unsigned long long warp_r[32];
  __shared__ int sh_tile;
  const int s = threadIdx.x, lane = s & 31, wid = s >> 5;
  const int nact = a.n_active ? *a.n_active : a.n_seg;
  int cnt = 0;
  if (s < a.n_seg) {
    const int32_t* q = a.tab + (long long)s * a.stride;
    int32_t* o = a.seg + kSegFields * s;
    const long long start = min(max((long long)q[0], 0LL), a.rows);
    cnt = s < nact ? (int)min(max((long long)q[1], 0LL), a.rows - start) : 0;
    o[0] = (int)start;
    o[1] = cnt;
    o[2] = min(max(q[2], 0), a.C - 1);
    for (int k = 3; k < 11; ++k) o[k] = q[k];
    o[11] = 0;
    a.nl[s] = 0;
  }
  unsigned long long r = (unsigned long long)cnt;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) r += __shfl_xor_sync(0xffffffffu, r, d);
  if (lane == 0) warp_r[wid] = r;
  __syncthreads();
  if (s == 0) {
    unsigned long long rows = 0;
    for (int w = 0; w < kPlanThreads / 32; ++w) rows += warp_r[w];
    const long long want = ((long long)(rows > 0 ? rows : 1) + a.sms - 1) / a.sms;
    // at most tile_max, whose left bits shared memory holds (segments
    // that overlap, which the contract rules out, can exceed it)
    sh_tile = (int)min((long long)a.tile_max, (want + kTileStep - 1) / kTileStep * kTileStep);
    if (a.tally) {
      atomicAdd(a.tally, rows);
      atomicAdd(a.tally + 1, rows > 0 ? 1ull : 0ull);
    }
  }
  __syncthreads();
  const int tile = sh_tile;
  const int tiles = (cnt + tile - 1) / tile;
  int total;
  const int incl = block_incl_scan(tiles, warp_c, &total);
  if (s < a.n_seg) a.plan[2 + s] = incl - tiles;
  if (s == 0) {
    a.plan[0] = tile;
    a.plan[1] = total;
    a.plan[2 + a.n_seg] = total;
  }
}

// Shared-memory bytes of a scatter block of f_tile features and `copies`
// copies of the cells (a feature tile starts at a multiple of f_tile, a
// whole number of words).
inline size_t part_smem(const PartArgs& a, int f_tile, int copies) {
  const int per = 32 / a.bits;
  const int nwords = (f_tile + per - 1) / per;
  return (size_t)2 * copies * stripe_span(f_tile, a.nb, kStripe) * sizeof(hacc) +
         (size_t)2 * (nwords + 3) * kStride * 4 + (size_t)a.tile / 8;
}

// grid: the row tiles (by value) or their static bound (table form).
template <int kForm>
int launch_partition(PartArgs a, int grid, cudaStream_t st) {
  if (grid <= 0) return 0;
  int sms = 0;
  size_t limit = 0;
  cudaError_t e = kernel_limits(part_scatter_kernel<kForm>, kForm, &sms, &limit);
  if (e != cudaSuccess) return (int)e;
  // the widest feature tile that fits one copy of the cells, then as many
  // copies (histogram warps) as fit
  const int per = 32 / a.bits;
  a.f_tile = a.nf;
  while (a.f_tile > per && part_smem(a, a.f_tile, 1) > limit)
    a.f_tile = std::max(per, (a.f_tile - 1) / per * per);
  if (part_smem(a, a.f_tile, 1) > limit) return (int)cudaErrorInvalidValue;
  a.copies = 1;
  while (a.copies < kMaxCopies && part_smem(a, a.f_tile, a.copies + 1) <= limit) ++a.copies;
  const size_t smem = part_smem(a, a.f_tile, a.copies);
  const int ftiles = (a.nf + a.f_tile - 1) / a.f_tile;
  part_scatter_kernel<kForm><<<dim3(grid, ftiles), kPartThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // a copy block for each (tile, row range) by value; the table form's
  // tiling is the plan's, so one wave of blocks (8 an SM) strides over its
  // items
  a.sms = sms;
  const int copy_grid = kForm == kByValue ? grid * copy_split(a.tile, grid, sms) : 8 * sms;
  part_copy_kernel<kForm><<<copy_grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace lgbt

// The table form (level_stream; split_stream given device scalars): the
// n_seg rows of a raw device table (`stride` int32 a row) and n_active
// (a device int32, or null for all rows); tile_max, the largest tile the
// plan can choose (it sizes shared memory), and grid, the static bound of
// row tiles, come from the wrapper (pkernels.py partition_grid).  seg and
// plan are the plan kernel's scratch, flags (grid words) and ticket are
// zero and left zeroed, as are the float64 cells acc (n_seg, 2, F, B, 3);
// out (n_seg, 2, F, B, 3) and nl (n_seg,) are written whole.  split
// names the form (split_stream's, whose tally, if any, counts its rows
// and whether it had any).
extern "C" int lgbt_level_stream(void* P, long long ld, int C, void* S, void* tab, int stride,
                                 int n_seg, void* n_active, long long rows, int sms, int tile_max,
                                 int grid, void* seg, void* plan, void* flags, void* ticket,
                                 void* nl, void* tally, int split, int bits, int nf, int nb,
                                 int row_g, int row_h, int row_sel, void* acc, void* out,
                                 void* stream) {
  if (n_seg <= 0 || n_seg > lgbt::kPlanThreads) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  lgbt::PlanArgs q{};
  q.tab = (const int32_t*)tab;
  q.stride = stride;
  q.n_seg = n_seg;
  q.n_active = (const int32_t*)n_active;
  q.rows = rows;
  q.C = C;
  q.sms = sms;
  q.tile_max = tile_max;
  q.seg = (int32_t*)seg;
  q.plan = (int32_t*)plan;
  q.nl = (int*)nl;
  q.tally = (unsigned long long*)tally;
  lgbt::part_plan_kernel<<<1, lgbt::kPlanThreads, 0, st>>>(q);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lgbt::PartArgs a{};
  a.P = (int32_t*)P;
  a.ld = ld;
  a.C = C;
  a.S = (int32_t*)S;
  a.sld = ld;
  a.seg = (const int32_t*)seg;
  a.plan = (const int32_t*)plan;
  a.n_seg = n_seg;
  a.tile = tile_max;
  a.flags = (unsigned long long*)flags;
  a.ticket = (int*)ticket;
  a.nl = (int*)nl;
  a.bits = bits;
  a.nf = nf;
  a.nb = nb;
  a.row_g = row_g;
  a.row_h = row_h;
  a.row_sel = row_sel;
  a.acc = (lgbt::hacc*)acc;
  a.out = (float*)out;
  a.out_cells = (long long)n_seg * 2 * nf * nb * 3;
  return split ? lgbt::launch_partition<lgbt::kSplitTable>(a, grid, st)
               : lgbt::launch_partition<lgbt::kLevelTable>(a, grid, st);
}

// split_stream given host ints: one segment by value; the scratch is
// (C, cnt); flags, ticket and acc as above.
extern "C" int lgbt_split_stream(void* P, long long ld, int C, void* S, int start, int cnt,
                                 int word, int shift, int zero_bin, int dbz, int thr, int is_cat,
                                 int off_lo, int off_hi, int bias, int tile, void* flags,
                                 void* ticket, void* nl, int bits, int nf, int nb, int row_g,
                                 int row_h, int row_sel, void* acc, void* out, void* stream) {
  lgbt::PartArgs a{};
  a.P = (int32_t*)P;
  a.ld = ld;
  a.C = C;
  a.S = (int32_t*)S;
  a.sld = cnt;
  a.one = lgbt::SegParams{start, cnt, word, shift, zero_bin, dbz, thr, is_cat, off_lo, off_hi,
                          bias};
  a.n_seg = 1;
  a.tile = tile;
  a.total = cnt > 0 ? (cnt + tile - 1) / tile : 0;
  a.flags = (unsigned long long*)flags;
  a.ticket = (int*)ticket;
  a.nl = (int*)nl;
  a.bits = bits;
  a.nf = nf;
  a.nb = nb;
  a.row_g = row_g;
  a.row_h = row_h;
  a.row_sel = row_sel;
  a.acc = (lgbt::hacc*)acc;
  a.out = (float*)out;
  a.out_cells = 2LL * nf * nb * 3;
  return lgbt::launch_partition<lgbt::kByValue>(a, a.total, (cudaStream_t)stream);
}
