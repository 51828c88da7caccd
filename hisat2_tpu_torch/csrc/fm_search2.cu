// Kernel 1: bigram double-step FM partial search with the event finish
// fused in (K1 + K2).
//
// Replaces hisat2_tpu/ops/search.py:partial_search2 (:409, with
// ops/rank.py:rank_from_rows :38 and rank2_from_rows :219) and
// _finish_events (:326).  Plain twin: hisat2_tpu_torch/ops/search.py.
//
// A group of FM_G = 8 threads walks one lane's read right to left, two
// chars per step (four lanes a warp).  Each step needs, of the fused
// rows of top and bot (44 words, 176 B; 49 on a sampled-SA index, whose
// 5 mark columns this kernel skips), the 1-char checkpoint of c, the
// bigram checkpoint of the step's symbol, the 8 words of 2-bit BWT and the
// 16 words of 4-bit bigram codes.  Thread g of the group loads word 4 + g
// and words 28 + 2g, 29 + 2g (one 8-byte load on a 44-column table) of
// each row, so a group's loads of one row fall on 32 and 64 contiguous
// bytes; the checkpoints are one broadcast load per row.  Each thread
// counts its words' share of both ranks of both rows, the four counts
// (each < 128) travel packed in one word through three shuffles, and
// every thread of the group then derives the 1-char LF (phase 1) and the
// 2-char bigram LF (phase 2) exactly as the JAX scan does.  Where top and
// bot lie in one 128-row block (top >> 7 == bot >> 7, once the range has
// narrowed) the group fetches that row once.  The next step's two read
// chars are fetched a step ahead, off the chain of dependent row fetches.
//
// Every event is folded into the PartialHits fields on the spot, as
// _finish_events' reduction would: hit slots, `abefore`, the uniq/post
// flags and the byte-packed round log.  The group's threads hold the same
// small state (range, right bound, arm and stop flags, counters), so their
// branches agree; only the group's first thread writes.  The kernel writes
// every field of its lane's row: the round log goes byte by byte straight
// into the lane's row of `rounds` (L / 2 + 2 bytes, which the group zeroes
// first), and the hit slots past the lane's count are zeroed at the end,
// so the dense mode needs no zero-filled outputs at any read length.
//
// Lane-list mode (K17, hisat2_tpu/ops/search.py:267 search_lanes_live):
// given `lanes`, group t searches lane lanes[t] only (the spliced prefix
// re-search lists the lanes whose cut can still yield a hit) and writes
// that lane's row; the caller has zeroed every other row.
//
// Bound (chip_smoke.py:work): the fused rows the lanes' steps fetch, one
// where top and bot share a 128-row block and two elsewhere, 176 B each,
// over the HBM rate; the table (55 MB at 40 Mbp) is just above the 50 MB
// L2.  Each step's fetch depends on the previous step's range, so a lane
// is a chain of ~L/2 dependent gathers; the design keeps every lane in
// flight at once (8,192 lanes are 2,048 warps, 256 blocks of 8 warps over
// the 132 SMs) and cuts the load instructions a lane issues per row from
// 26 scalar ones, each spread over a warp's 32 rows, to four whose
// addresses share a row.  What is left is the latency of those chains,
// not the bytes: PERF.md gives the times against the bound.  Groups of 4
// threads and blocks of 128 threads measured within 2.4% of this shape,
// and an L2 persisting window over the table gained nothing.
#include "common.cuh"

#define FM_G 8            // threads per lane
#define FM_THREADS 256    // 32 lanes per block

struct FmParams {
  int rows, a_stop_len, a_cancel_len, min_hit_len, H, R;
};

struct FmOut {
  int* top;
  int* bot;
  int* lo;
  int* hi;
  int* ab;
  uint8_t* uniq;
  uint8_t* post;
};

// One lane's search state and the accumulators of the fused event finish,
// the same in every thread of the lane's group.
struct FmLane {
  int top, bot, rb;
  bool arm, stopped;
  int nrec, na, nround;
};

// The event of one char: its kind (0 none, 1 fail, 2 anchor stop), range,
// right bound, position and whether the lane had stopped before it.
struct FmEv {
  int ev, top, bot, rb, pos;
  bool stopped;
};

// The words of one fused row a thread needs at one step: both checkpoints
// (broadcast to the group), its word of the 2-bit BWT and its two words of
// bigram codes.
struct FmRow {
  int b1, b2;
  uint32_t x, y0, y1;
};

template <bool VEC>
__device__ __forceinline__ FmRow fm_load(const uint32_t* __restrict__ row,
                                         int g, int c, int sym) {
  FmRow r;
  r.b1 = (int)__ldg(row + c);
  r.b2 = (int)__ldg(row + 12 + sym);
  r.x = __ldg(row + 4 + g);
  if (VEC) {
    const uint2 v = __ldg((const uint2*)(row + 28 + 2 * g));
    r.y0 = v.x;
    r.y1 = v.y;
  } else {
    r.y0 = __ldg(row + 28 + 2 * g);
    r.y1 = __ldg(row + 29 + 2 * g);
  }
  return r;
}

// occurrences of char c among the 16 chars of 2-bit word w below `within`
// (rank.py:rank_from_rows' count, one word of it)
__device__ __forceinline__ int fm_part1(uint32_t x, int within, int w,
                                        int c) {
  const int nvalid = min(max(within - 16 * w, 0), 16);
  const uint32_t y = ~(x ^ ((uint32_t)c * 0x55555555u));
  const uint32_t pairs = y & (y >> 1) & 0x55555555u;
  const uint32_t mask =
      nvalid >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nvalid)) - 1u);
  return __popc(pairs & mask);
}

// occurrences of symbol sym among the 8 codes of bigram word w below
// `within` (rank2_from_rows' count, one word of it)
__device__ __forceinline__ int fm_part2(uint32_t x, int within, int w,
                                        int sym) {
  const int nvalid = min(max(within - 8 * w, 0), 8);
  const uint32_t y = x ^ ((uint32_t)sym * 0x11111111u);
  const uint32_t m = y | (y >> 1) | (y >> 2) | (y >> 3);
  const uint32_t hit = (~m) & 0x11111111u;
  const uint32_t mask =
      nvalid >= 8 ? 0xFFFFFFFFu : ((1u << (4 * nvalid)) - 1u);
  return __popc(hit & mask);
}

// the thread's share of one row's two counts at `within`, packed a byte
// each (the 1-char count in byte 0, the bigram count in byte 2)
__device__ __forceinline__ int fm_part(const FmRow& r, int within, int g,
                                       int c, int sym) {
  return fm_part1(r.x, within, g, c) |
         ((fm_part2(r.y0, within, 2 * g, sym) +
           fm_part2(r.y1, within, 2 * g + 1, sym)) << 16);
}

// '$' is packed as char 0 at zrow (zrow2 for the bigrams) and excluded
// from the checkpoints
__device__ __forceinline__ int fm_corr1(int i, int c, int zrow) {
  return (c == 0 && zrow >= ((i >> 7) << 7) && i > zrow) ? 1 : 0;
}

__device__ __forceinline__ int fm_corr2(int i, int sym, int zrow,
                                        int zrow2) {
  if (sym != 0) return 0;
  const int b = (i >> 7) << 7;
  return ((zrow >= 0 && zrow >= b && i > zrow) ? 1 : 0) +
         ((zrow2 >= 0 && zrow2 >= b && i > zrow2) ? 1 : 0);
}

// One char of the search (search.py `phase`, :452-481): the new state
// and the char's event; returns whether the search restarts.
__device__ __forceinline__ bool fm_phase(FmLane& s, const FmParams& p,
                                         int pos, int c, int t_new,
                                         int b_new, FmEv& e) {
  const bool active = pos >= 0;
  const bool valid_c = (c < 4) && active;
  const bool ok = valid_c && (b_new > t_new);
  const int seg = s.rb - pos;
  const int width = b_new - t_new;
  bool arm = s.arm && !(ok && (seg - 1 >= p.a_cancel_len) && (width >= 4));
  const bool astop = ok && arm && active && (seg >= p.a_stop_len) &&
                     (width == 1);
  const bool fail = active && !ok;
  e.ev = astop ? 2 : (fail ? 1 : 0);
  e.top = astop ? t_new : s.top;
  e.bot = astop ? b_new : s.bot;
  e.rb = s.rb;  // == pos of the previous event (or len)
  e.pos = pos;
  e.stopped = s.stopped;
  int top_n = ok ? t_new : 0;
  int bot_n = ok ? b_new : p.rows;
  int rb_n = ok ? s.rb : pos;
  if (astop) {
    top_n = 0;
    bot_n = p.rows;
    rb_n = pos;
  }
  if (fail || astop) arm = true;
  if (active) {
    s.top = top_n;
    s.bot = bot_n;
    s.rb = rb_n;
  }
  s.arm = arm;
  s.stopped = s.stopped || astop;
  return fail || astop;
}

// The online finish of an event (_finish_events, :326-406): its hit slot,
// `abefore` and its byte of the round log; `lead` writes.
__device__ __forceinline__ void fm_record(FmLane& s, const FmParams& p,
                                          const FmOut& o, uint8_t* rlog,
                                          size_t hrow, bool lead,
                                          const FmEv& e) {
  if (e.ev == 0) return;
  const int eseg = (e.ev == 2) ? e.rb - e.pos : e.rb - e.pos - 1;
  const bool rec = (e.ev == 2) || (eseg >= p.min_hit_len);
  if (rec) {
    if (lead && s.nrec < p.H) {
      const size_t k = hrow + s.nrec;
      o.top[k] = e.top;
      o.bot[k] = e.bot;
      o.lo[k] = e.pos + (e.ev == 1 ? 1 : 0);
      o.hi[k] = e.rb;
      o.ab[k] = s.na;
      o.uniq[k] = e.ev == 2;
      o.post[k] = e.stopped;
    }
    s.nrec += 1;
  }
  if (e.ev == 1 && eseg >= 1) s.na += 1;
  if (!e.stopped) {
    if (lead && s.nround < p.R)
      rlog[s.nround] = (uint8_t)(min(eseg, 126) * 2 + (e.ev == 2));
    s.nround += 1;
  }
}

// VEC: the bigram words as one 8-byte load (44-column rows, 8-aligned)
template <bool VEC>
__global__ void __launch_bounds__(FM_THREADS) fm_search2_kernel(
    const uint32_t* __restrict__ blocked, const int* __restrict__ fchr,
    const int* __restrict__ ftab2, const int* __restrict__ reads,
    const int* __restrict__ lens, const int* __restrict__ lanes,
    int use_lanes, int N, int L, int zrow, int zrow2, int row_w, FmParams p,
    int RW, FmOut o, int* __restrict__ rounds, int* __restrict__ nrounds,
    int* __restrict__ nh, uint8_t* __restrict__ stopped_out) {
  const int t = (blockIdx.x * blockDim.x + threadIdx.x) / FM_G;
  const int g = threadIdx.x & (FM_G - 1);
  const bool have = t < N;
  const int lane = have ? (use_lanes ? lanes[t] : t) : 0;
  const int len = have ? lens[lane] : 0;
  const int steps = max(min((len + 1) / 2, (L + 1) / 2), 0);
  // the warp runs to its longest lane's steps, so that every thread
  // reaches the shuffles
  int wsteps = steps;
#pragma unroll
  for (int k = 16; k > 0; k >>= 1)
    wsteps = max(wsteps, __shfl_xor_sync(H2_FULL_MASK, wsteps, k));
  const bool lead = have && g == 0;
  const size_t hrow = (size_t)lane * p.H;
  int* rrow = rounds + (size_t)lane * RW;
  if (have)
    for (int k = g; k < RW; k += FM_G) rrow[k] = 0;
  __syncwarp();  // the zeroed log before the first thread's bytes
  uint8_t* rlog = (uint8_t*)rrow;
  const int* rd = reads + (size_t)lane * L;
  FmLane s{0, p.rows, len, true, false, 0, 0, 0};
  int c1n = steps > 0 ? rd[len - 1] : 4;
  int c2n = steps > 0 && len >= 2 ? rd[len - 2] : 4;
  FmEv e;
  for (int step = 0; step < wsteps; ++step) {
    const bool act = step < steps;  // the same in the whole group
    const int pos1 = len - 1 - 2 * step;
    const int pos2 = pos1 - 1;
    const int c1 = c1n, c2 = c2n;
    const int cc1 = min(c1, 3), cc2 = min(c2, 3);
    const int sym = cc2 * 4 + cc1;
    const int top0 = s.top, bot0 = s.bot;
    FmRow rt{0, 0, 0u, 0u, 0u}, rb{0, 0, 0u, 0u, 0u};
    if (act) {
      rt = fm_load<VEC>(blocked + (size_t)(top0 >> 7) * row_w, g, cc1, sym);
      if ((top0 >> 7) == (bot0 >> 7))
        rb = rt;  // one block holds both: one fetch
      else
        rb = fm_load<VEC>(blocked + (size_t)(bot0 >> 7) * row_w, g, cc1,
                          sym);
      if (step + 1 < steps) {
        c1n = rd[pos1 - 2];
        c2n = pos1 >= 3 ? rd[pos1 - 3] : 4;
      }
    }
    // the four counts (each < 128), a byte each: top 1-char, bot 1-char,
    // top bigram, bot bigram, summed over the group
    int part = act ? fm_part(rt, top0 & 127, g, cc1, sym) |
                         (fm_part(rb, bot0 & 127, g, cc1, sym) << 8)
                   : 0;
#pragma unroll
    for (int k = FM_G / 2; k > 0; k >>= 1)
      part += __shfl_xor_sync(H2_FULL_MASK, part, k);
    if (!act) continue;
    const int lf1 = __ldg(fchr + cc1);
    const int t1 = lf1 + rt.b1 + (part & 255) - fm_corr1(top0, cc1, zrow);
    const int b1 =
        lf1 + rb.b1 + ((part >> 8) & 255) - fm_corr1(bot0, cc1, zrow);
    const bool restart1 = fm_phase(s, p, pos1, c1, t1, b1, e);
    fm_record(s, p, o, rlog, hrow, lead, e);
    int t2, b2;
    if (restart1) {
      t2 = __ldg(fchr + cc2);
      b2 = __ldg(fchr + cc2 + 1);
    } else {
      const int base2 = __ldg(ftab2 + sym);
      t2 = base2 + rt.b2 + ((part >> 16) & 255) -
           fm_corr2(top0, sym, zrow, zrow2);
      b2 = base2 + rb.b2 + ((part >> 24) & 255) -
           fm_corr2(bot0, sym, zrow, zrow2);
    }
    fm_phase(s, p, pos2, c2, t2, b2, e);
    fm_record(s, p, o, rlog, hrow, lead, e);
  }
  if (!have) return;
  // terminal segment [0, rb) with the final range (search.py:369-399)
  const int term_seg = s.rb;
  const bool term_ok = term_seg >= p.min_hit_len;
  if (lead && term_ok && s.nrec < p.H) {
    const size_t k = hrow + s.nrec;
    o.top[k] = s.top;
    o.bot[k] = s.bot;
    o.lo[k] = 0;
    o.hi[k] = s.rb;
    o.ab[k] = s.na;
    o.uniq[k] = 1;
    o.post[k] = s.stopped;
  }
  const int nhit = min(s.nrec + (term_ok ? 1 : 0), p.H);
  for (int k = nhit + g; k < p.H; k += FM_G) {  // the unused slots
    o.top[hrow + k] = 0;
    o.bot[hrow + k] = 0;
    o.lo[hrow + k] = 0;
    o.hi[hrow + k] = 0;
    o.ab[hrow + k] = 0;
    o.uniq[hrow + k] = 0;
    o.post[hrow + k] = 0;
  }
  if (!lead) return;
  nh[lane] = nhit;
  const bool term_round = (term_seg > 0) && !s.stopped;
  if (term_round && s.nround < p.R)
    rlog[s.nround] = (uint8_t)(min(term_seg, 126) * 2 + 1);
  nrounds[lane] = min(s.nround + (term_round ? 1 : 0), p.R);
  stopped_out[lane] = s.stopped;
}

static bool fm_vec(const void* blocked, int row_w) {
  return row_w == 44 && ((uintptr_t)blocked & 7) == 0;
}

H2_EXPORT int h2_fm_search2(
    const void* blocked, const void* fchr, const void* ftab2,
    const void* reads, const void* lens, const void* lanes, int use_lanes,
    int N, int L, int zrow, int zrow2,
    int rows, int a_stop_len, int a_cancel_len, int min_hit_len, int H,
    int row_w, void* top, void* bot, void* lo, void* hi, void* ab, void* uniq,
    void* post, void* rounds, void* nrounds, void* nh, void* stopped,
    void* stream) {
  if (L < 1 || H < 1 || (row_w != 44 && row_w != 49))
    return (int)cudaErrorInvalidValue;
  FmParams p{rows, a_stop_len, a_cancel_len, min_hit_len, H, L / 2 + 2};
  const int RW = (p.R + 3) / 4;
  FmOut o{(int*)top, (int*)bot, (int*)lo, (int*)hi, (int*)ab,
          (uint8_t*)uniq, (uint8_t*)post};
  const long long threads = (long long)N * FM_G;
  const long long blocks = (threads + FM_THREADS - 1) / FM_THREADS;
  auto kern = fm_vec(blocked, row_w) ? fm_search2_kernel<true>
                                     : fm_search2_kernel<false>;
  if (blocks > 0)
    kern<<<(unsigned)blocks, FM_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)blocked, (const int*)fchr, (const int*)ftab2,
        (const int*)reads, (const int*)lens, (const int*)lanes, use_lanes,
        N, L, zrow, zrow2, row_w, p, RW, o,
        (int*)rounds, (int*)nrounds, (int*)nh, (uint8_t*)stopped);
  return (int)cudaGetLastError();
}

// The launch on a 44- or 49-column table, from the CUDA runtime: out =
// {registers per thread, static shared bytes, dynamic shared bytes,
// threads per block, blocks per SM, local bytes per thread}.
H2_EXPORT int h2_fm_search2_info(int row_w, int* out) {
  auto kern = row_w == 44 ? fm_search2_kernel<true>
                          : fm_search2_kernel<false>;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                    FM_THREADS, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = 0;
  out[3] = FM_THREADS;
  out[4] = blocks;
  out[5] = (int)a.localSizeBytes;
  return (int)e;
}
