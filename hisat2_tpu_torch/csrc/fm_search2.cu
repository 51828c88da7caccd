// Kernel 1: bigram double-step FM partial search with the event finish
// fused in (K1 + K2).
//
// Replaces hisat2_tpu/ops/search.py:partial_search2 (:409, with
// ops/rank.py:rank_from_rows :38 and rank2_from_rows :219) and
// _finish_events (:326).  Plain twin: hisat2_tpu_torch/ops/search.py.
//
// One thread per lane walks its read right to left, two chars per step.
// Each step loads the two fused rows of top and bot once (44 words, 176 B;
// 49 on a sampled-SA index, whose 5 mark columns this kernel skips)
// and derives both the 1-char LF (phase 1) and the 2-char bigram LF
// (phase 2) from them, exactly as the JAX scan does.  Instead of
// materialising the [N, L] event stream and reducing it afterwards, every
// event is folded into the PartialHits fields on the spot: hit slots,
// `abefore`, the uniq/post flags and the byte-packed round log.
//
// Lane-list mode (K17, hisat2_tpu/ops/search.py:267 search_lanes_live):
// given `lanes`, thread t searches lane lanes[t] only (the spliced prefix
// re-search lists the lanes whose cut can still yield a hit) and writes
// that lane's row; the caller has zeroed every other row.
//
// Every read length: the round log (L / 2 + 2 bytes) lives in a per-lane
// local array up to L = FM_MAX_L; above it a second instantiation ORs the
// log straight into the lane's row of `rounds`, which the wrapper has
// zeroed, so the log is the global scratch the wrapper sized from L.
//
// Bound: each step is a dependent random gather of two rows (latency, not
// bandwidth); at N = 8192 lanes one thread per lane is less than one wave
// of the card's 132 SMs.  Hiding that latency (several lanes per warp in
// flight, rows via shared memory) is left to later work.
#include "common.cuh"

#define FM_MAX_L 512
#define FM_MAX_R (FM_MAX_L / 2 + 2)
#define FM_MAX_RW ((FM_MAX_R + 3) / 4)

__device__ __forceinline__ int fm_rank1(const uint32_t* __restrict__ row,
                                        int i, int c, int zrow) {
  const int blk = i >> 7;
  const int within = i & 127;
  const int base = (int)__ldg(row + c);
  const uint32_t pat = (uint32_t)c * 0x55555555u;
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const int nvalid = min(max(within - 16 * w, 0), 16);
    const uint32_t x = ~(__ldg(row + 4 + w) ^ pat);
    const uint32_t pairs = x & (x >> 1) & 0x55555555u;
    const uint32_t mask =
        nvalid >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nvalid)) - 1u);
    cnt += __popc(pairs & mask);
  }
  // '$' is packed as char 0 at zrow and excluded from the checkpoints
  const int corr = (c == 0 && zrow >= (blk << 7) && i > zrow) ? 1 : 0;
  return base + cnt - corr;
}

__device__ __forceinline__ int fm_rank2(const uint32_t* __restrict__ row,
                                        int i, int sym, int zrow,
                                        int zrow2) {
  const int blk = i >> 7;
  const int within = i & 127;
  const int base = (int)__ldg(row + 12 + sym);
  const uint32_t pat = (uint32_t)sym * 0x11111111u;
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    const int nvalid = min(max(within - 8 * w, 0), 8);
    const uint32_t x = __ldg(row + 28 + w) ^ pat;
    const uint32_t m = x | (x >> 1) | (x >> 2) | (x >> 3);
    const uint32_t hit = (~m) & 0x11111111u;
    const uint32_t mask =
        nvalid >= 8 ? 0xFFFFFFFFu : ((1u << (4 * nvalid)) - 1u);
    cnt += __popc(hit & mask);
  }
  int corr = 0;
  if (sym == 0) {
    if (zrow >= 0 && zrow >= (blk << 7) && i > zrow) corr += 1;
    if (zrow2 >= 0 && zrow2 >= (blk << 7) && i > zrow2) corr += 1;
  }
  return base + cnt - corr;
}

struct FmState {
  int top, bot, rb;
  bool arm, stopped;
};

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

// Per-lane accumulators of the fused event finish.
struct FmAcc {
  int nrec, na, nround;
};

// One char of the search (search.py `phase`, :452-481) followed by the
// online finish of its event (_finish_events, :326-406).
__device__ __forceinline__ bool fm_phase(FmState& s, FmAcc& acc,
                                         const FmParams& p, const FmOut& o,
                                         uint32_t* rw, int lane, int pos,
                                         int c, int t_new, int b_new) {
  const bool active = pos >= 0;
  const bool valid_c = (c < 4) && active;
  const bool ok = valid_c && (b_new > t_new);
  const int seg = s.rb - pos;
  const int width = b_new - t_new;
  bool arm = s.arm && !(ok && (seg - 1 >= p.a_cancel_len) && (width >= 4));
  const bool astop = ok && arm && active && (seg >= p.a_stop_len) &&
                     (width == 1);
  const bool fail = active && !ok;
  const int ev = astop ? 2 : (fail ? 1 : 0);
  const int ev_top = astop ? t_new : s.top;
  const int ev_bot = astop ? b_new : s.bot;
  const int rb_ev = s.rb;  // == pos of the previous event (or len)
  const bool stopped_out = s.stopped;
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

  if (ev != 0) {
    const int eseg = (ev == 2) ? rb_ev - pos : rb_ev - pos - 1;
    const bool rec = (ev == 2) || (eseg >= p.min_hit_len);
    if (rec) {
      if (acc.nrec < p.H) {
        const size_t k = (size_t)lane * p.H + acc.nrec;
        o.top[k] = ev_top;
        o.bot[k] = ev_bot;
        o.lo[k] = pos + (ev == 1 ? 1 : 0);
        o.hi[k] = rb_ev;
        o.ab[k] = acc.na;
        o.uniq[k] = ev == 2;
        o.post[k] = stopped_out;
      }
      acc.nrec += 1;
    }
    if (ev == 1 && eseg >= 1) acc.na += 1;
    if (!stopped_out) {
      if (acc.nround < p.R) {
        const uint32_t val = (uint32_t)(min(eseg, 126) * 2 + (ev == 2));
        rw[acc.nround >> 2] |= val << (8 * (acc.nround & 3));
      }
      acc.nround += 1;
    }
  }
  return fail || astop;
}

// GLOG: the round log in the lane's zeroed row of `rounds` (L > FM_MAX_L)
template <bool GLOG>
__global__ void fm_search2_kernel(
    const uint32_t* __restrict__ blocked, const int* __restrict__ fchr,
    const int* __restrict__ ftab2, const int* __restrict__ reads,
    const int* __restrict__ lens, const int* __restrict__ lanes,
    int use_lanes, int N, int L, int zrow, int zrow2, int row_w, FmParams p,
    int RW,
    FmOut o, int* __restrict__ rounds, int* __restrict__ nrounds,
    int* __restrict__ nh, uint8_t* __restrict__ stopped_out) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N) return;
  const int lane = use_lanes ? lanes[tid] : tid;
  const int len = lens[lane];
  const int* rd = reads + (size_t)lane * L;
  uint32_t rw_local[GLOG ? 1 : FM_MAX_RW];
  uint32_t* rw = GLOG ? (uint32_t*)rounds + (size_t)lane * RW : rw_local;
  if (!GLOG)
    for (int k = 0; k < RW; ++k) rw[k] = 0u;
  FmState s{0, p.rows, len, true, false};
  FmAcc acc{0, 0, 0};
  const int S = (L + 1) / 2;
  for (int step = 0; step < S; ++step) {
    const int pos1 = len - 1 - 2 * step;
    const int pos2 = pos1 - 1;
    if (pos1 < 0) break;  // every later char is inactive: no events
    const int c1 = rd[pos1];
    const int c2 = pos2 >= 0 ? rd[pos2] : 4;
    const int top0 = s.top, bot0 = s.bot;
    const uint32_t* rt = blocked + (size_t)(top0 >> 7) * row_w;
    const uint32_t* rbp = blocked + (size_t)(bot0 >> 7) * row_w;
    const int cc1 = min(c1, 3);
    const int lf1 = fchr[cc1];
    const int t1 = lf1 + fm_rank1(rt, top0, cc1, zrow);
    const int b1 = lf1 + fm_rank1(rbp, bot0, cc1, zrow);
    const bool restart1 =
        fm_phase(s, acc, p, o, rw, lane, pos1, c1, t1, b1);
    const int cc2 = min(c2, 3);
    int t2, b2;
    if (restart1) {
      t2 = fchr[cc2];
      b2 = fchr[cc2 + 1];
    } else {
      const int sym = cc2 * 4 + cc1;
      const int base2 = ftab2[sym];
      t2 = base2 + fm_rank2(rt, top0, sym, zrow, zrow2);
      b2 = base2 + fm_rank2(rbp, bot0, sym, zrow, zrow2);
    }
    fm_phase(s, acc, p, o, rw, lane, pos2, c2, t2, b2);
  }
  // terminal segment [0, rb) with the final range (search.py:369-399)
  const int term_seg = s.rb;
  const bool term_ok = term_seg >= p.min_hit_len;
  if (term_ok && acc.nrec < p.H) {
    const size_t k = (size_t)lane * p.H + acc.nrec;
    o.top[k] = s.top;
    o.bot[k] = s.bot;
    o.lo[k] = 0;
    o.hi[k] = s.rb;
    o.ab[k] = acc.na;
    o.uniq[k] = 1;
    o.post[k] = s.stopped;
  }
  nh[lane] = min(acc.nrec + (term_ok ? 1 : 0), p.H);
  const bool term_round = (term_seg > 0) && !s.stopped;
  if (term_round && acc.nround < p.R) {
    const uint32_t val = (uint32_t)(min(term_seg, 126) * 2 + 1);
    rw[acc.nround >> 2] |= val << (8 * (acc.nround & 3));
  }
  nrounds[lane] = min(acc.nround + (term_round ? 1 : 0), p.R);
  if (!GLOG)
    for (int k = 0; k < RW; ++k)
      rounds[(size_t)lane * RW + k] = (int)rw[k];
  stopped_out[lane] = s.stopped;
}

H2_EXPORT int h2_fm_search2(
    const void* blocked, const void* fchr, const void* ftab2,
    const void* reads, const void* lens, const void* lanes, int use_lanes,
    int N, int L, int zrow, int zrow2,
    int rows, int a_stop_len, int a_cancel_len, int min_hit_len, int H,
    int row_w, void* top, void* bot, void* lo, void* hi, void* ab, void* uniq,
    void* post, void* rounds, void* nrounds, void* nh, void* stopped,
    void* stream) {
  if (L < 1 || (row_w != 44 && row_w != 49))
    return (int)cudaErrorInvalidValue;
  FmParams p{rows, a_stop_len, a_cancel_len, min_hit_len, H, L / 2 + 2};
  const int RW = (p.R + 3) / 4;
  FmOut o{(int*)top, (int*)bot, (int*)lo, (int*)hi, (int*)ab,
          (uint8_t*)uniq, (uint8_t*)post};
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  auto kern = L <= FM_MAX_L ? fm_search2_kernel<false>
                            : fm_search2_kernel<true>;
  if (blocks > 0)
    kern<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)blocked, (const int*)fchr, (const int*)ftab2,
        (const int*)reads, (const int*)lens, (const int*)lanes, use_lanes,
        N, L, zrow, zrow2, row_w, p, RW, o,
        (int*)rounds, (int*)nrounds, (int*)nh, (uint8_t*)stopped);
  return (int)cudaGetLastError();
}
