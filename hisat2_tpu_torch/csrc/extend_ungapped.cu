// Kernel 3: ungapped extension with closed-form soft clips (K6 + K7 fused).
//
// Replaces hisat2_tpu/ops/extend.py:pen_planes (:72, with its SNV
// branch :100-111) and extend_grouped (:225).  Plain twin:
// hisat2_tpu_torch/ops/extend.py:extend_grouped_plain (pen_planes +
// extend_from_planes).
//
// For each (lane, candidate) the per-column penalty is built from the
// candidate's reference window (on a graph index a mismatch that matches
// a catalog SNV allele of its two SNV-plane windows is forgiven), the read
// and its qualities; then the best left and right clip (ties keep the
// LARGER clip, extend.py's argmax on the reversed axis) under the
// >= 7-column trim-anchor rule and without it (for liveness), the
// alternate (trimmed-representation) score over the anchor forms, and the
// mismatch, N and SNV-match counts inside the kept region.
//
// Design (Hopper):
// - One evaluation per distinct (lane, start).  A candidate's row is a
//   function of its lane and start alone (the windows are
//   diag_chars(start)), so the slots of a lane that share a start share
//   one evaluation: the first slot of each start in its lane is evaluated
//   by one warp, which writes every slot of the lane with that start.  In
//   the pipeline all dead slots of a lane (start -1) are one group, so a
//   step evaluates about 1.6 rows per lane where it used to evaluate C.
//   A block of four warps lists the first slots among its consecutive
//   slots (32 on a launch that fills the card, so that its warps are
//   busy; 4 on a small one, so that each slot gets a warp) and its warps
//   take the list in turn; the penalty tables sit in shared memory.
// - The read is streamed in tiles of 32 * K columns; each lane owns a run
//   of K consecutive columns in registers.  The penalty prefix P, the
//   clip-cost prefix Cc and the reversed clip-cost prefix RS are serial
//   sums over the run and three interleaved warp scans per tile; every
//   argmax is a fold over the boundaries a lane owns and one warp
//   reduction at the end, with these rewrites of extend.py:
//   - the right clip b = base - k (base = len, or L under uniform_len)
//     is folded at boundary k = bidx(b), where P is the lane's own, and
//     its clip cost is Cc[b] = Cc[base] - RS[k];
//   - run_l[a] >= 7 is "a + 7 <= len and no penalised column in
//     [a, a + 7)" and run_r[k] >= 7 is "k >= 7 and none in [k - 7, k)":
//     bit windows over the lane's penalised mask and its neighbours';
//   - the alternate forms read P and Cc at boundaries below 64, P and
//     run_r at their mirrors bidx(b), and the next penalised column of
//     the first 64: the owners stash those in shared memory, so a warp
//     holds O(1) shared memory whatever L.
//   The kept-region counts are the totals less the clipped columns,
//   which are evaluated again (none where nothing is clipped).
// - Every read length: above one tile (L >= 32 * 16) a first pass sums
//   the penalties and clip costs, so that each tile's right-clip values,
//   which need both totals, are exact before the fold.
// - JAX's int32 arithmetic: sums are taken in uint32 and compared as
//   int32, so they wrap as XLA's do (an all out-of-text row of 21475
//   columns passes 2^31).  The SNV branch is a template parameter.
//
// Bound (chip_smoke.py:work): bytes, each lane's read and quals, the len
// columns of each distinct (lane, start) window, the starts and the eight
// output planes (~0.003 ms on the linear step), against ~30 integer
// operations per column of each group.  The kernel takes about 12x that:
// a group is one warp's chain of dependent loads, scans and reductions,
// and a step's ~13k groups are about two rounds of the resident warps.
#include "common.cuh"

#define EXT_OOB_PEN 100000
#define EXT_NO_ALT (-(1 << 30))
#define EXT_MINA 7
#define EXT_BIG (1 << 30)
#define EXT_WARPS 4         // warps per block
#define EXT_SLOTS_DENSE 32  // slots per block of a launch of many slots
#define EXT_SLOTS_SPARSE 4  // slots per block of a small launch
#define EXT_DENSE_NC 16384  // a launch of this many slots fills the card
#define EXT_HEAD 64         // the alternate forms read boundaries below this
#define EXT_MIN_BLOCKS 6    // blocks per SM: 80 registers a thread

struct ExtArgs {
  const int* reads;
  const int* quals;
  const int* lens;
  const int* cand_start;
  const int* win;
  const int* mm_pen;
  const int* clip_pen;
  const int* minsc;
  const int* snv1;  // [NC, W] SNV-plane windows (SNV kernel only)
  const int* snv2;
  long long NC;
  int C, L, W, margin;
  long long n_text;
  int n_pen, allow_softclip, uniform_len, use_minsc, mm_min;
  int* score;
  int* n_mm;
  int* n_n;
  int* n_snp;
  int* clip_l;
  int* clip_r;
  uint8_t* ok;
  int* alt;
};

// One warp's stash for the alternate forms: P[a] and Cc[a] for a < 64,
// P[bidx(b)] for b < 64, and bit masks of the penalised columns below 64,
// of run_l[a] >= 7 (a < 64) and of run_r[bidx(b)] >= 7 (b < 64).
struct ExtStash {
  int hP[EXT_HEAD];
  int hC[EXT_HEAD];
  int tP[EXT_HEAD];
  unsigned bits[6];  // hpen[2], hrl[2], trr[2]
};

// One evaluation: the lane's read, the group's windows and the penalty
// tables (mm_pen, then clip_pen, staged in shared memory).
struct ExtRow {
  const int* tab;
  const int* rd;
  const int* qs;
  const int* wc;  // window columns of the read (margin skipped)
  const int* s1;
  const int* s2;
  long long start;
  int len, base;
};

__device__ __forceinline__ unsigned ext_scan_pair(unsigned v, unsigned t,
                                                  int lane, int o) {
  return lane >= o ? v + t : v;
}

// pen_planes for one column: its penalty, its clip cost and flags (bit0
// mismatch, bit1 N, bit2 penalised, bit3 SNV match); zeros past len.
template <bool SNV>
__device__ __forceinline__ void ext_col(const ExtArgs& A, const ExtRow& r,
                                        int col, unsigned& pen, unsigned& cc,
                                        unsigned& f) {
  pen = 0u;
  cc = 0u;
  f = 0u;
  if (col >= r.len || col >= A.L) return;
  const int rdc = r.rd[col];
  const int q = min(r.qs[col], 63);
  const long long pos = r.start + col;
  const bool oob = pos < 0 || pos >= A.n_text;
  const int rc = min(r.wc[col], 3);
  const bool isn = rdc >= 4;
  const bool mm_raw = rdc < 4 && rdc != rc && !oob;
  bool snp = false;
  if (SNV) {
    const int v1 = min(r.s1[col], 3), v2 = min(r.s2[col], 3);
    snp = mm_raw && ((v1 != 0 && rdc == ((rc + v1) & 3)) ||
                     (v2 != 0 && rdc == ((rc + v2) & 3)));
  }
  const bool mm = mm_raw && !snp;
  pen = (mm ? (unsigned)r.tab[q] : 0u) + (isn ? (unsigned)A.n_pen : 0u) +
        (oob ? (unsigned)EXT_OOB_PEN : 0u);
  cc = (unsigned)r.tab[64 + q];
  f = (mm ? 1u : 0u) | (isn ? 2u : 0u) | ((int)pen > 0 ? 4u : 0u) |
      (snp ? 8u : 0u);
}

// The clip cost of one column (zero outside [0, len)).
__device__ __forceinline__ unsigned ext_ccost(const ExtArgs& A,
                                              const ExtRow& r, int col) {
  return (col >= 0 && col < r.len && col < A.L)
             ? (unsigned)r.tab[64 + min(r.qs[col], 63)]
             : 0u;
}

__device__ __forceinline__ unsigned ext_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(H2_FULL_MASK, v, o);
  return v;
}

// (value, index) maximum, ties to the LARGER index
__device__ __forceinline__ void ext_best(int& v, int& i, int v2, int i2) {
  if (v2 > v || (v2 == v && i2 > i)) {
    v = v2;
    i = i2;
  }
}

struct ExtOut {
  int score, nmm, nn, nsnp, clip_l, clip_r, alt;
  bool ok;
};

// Penalty total and mismatch / N / SNV-match counts of columns [lo, hi),
// strided over the warp (reduced over it).
template <bool SNV>
__device__ void ext_sums(const ExtArgs& A, const ExtRow& r, int lo, int hi,
                         int lane, unsigned& tot, unsigned& cct, int& nmm,
                         int& nn, int& nsnp) {
  unsigned sp = 0u, sc = 0u, cm = 0u, cn = 0u, cs = 0u;
  for (int c = lo + lane; c < hi; c += 32) {
    unsigned p, cc, f;
    ext_col<SNV>(A, r, c, p, cc, f);
    sp += p;
    sc += cc;
    cm += f & 1u;
    cn += (f >> 1) & 1u;
    cs += (f >> 3) & 1u;
  }
  tot = ext_sum(sp);
  cct = ext_sum(sc);
  nmm = (int)ext_sum(cm);
  nn = (int)ext_sum(cn);
  nsnp = SNV ? (int)ext_sum(cs) : 0;
}

template <bool SNV, int K>
__device__ ExtOut ext_eval(const ExtArgs& A, const ExtRow& r, ExtStash& sh,
                           long long n, int lane) {
  constexpr int TILE = 32 * K;
  const int L = A.L, len = r.len, base = r.base;
  ExtOut o;
  o.clip_l = o.clip_r = 0;
  o.alt = EXT_NO_ALT;
  if (!A.allow_softclip) {
    unsigned tot, cct;
    ext_sums<SNV>(A, r, 0, len, lane, tot, cct, o.nmm, o.nn, o.nsnp);
    o.score = (int)(0u - tot);
    o.ok = r.start >= 0 && o.score > -(EXT_OOB_PEN / 2);
    return o;
  }
  if (lane < 6) sh.bits[lane] = 0u;
  __syncwarp();
  const int ntiles = (L + TILE) / TILE;  // boundaries 0..L
  unsigned total = 0u, cctot = 0u;
  int cnt_mm = 0, cnt_n = 0, cnt_s = 0;
  if (ntiles > 1) {
    // the totals the right clips need before any tile is folded
    ext_sums<SNV>(A, r, 0, len, lane, total, cctot, cnt_mm, cnt_n, cnt_s);
  }
  unsigned carP = 0u, carC = 0u, carR = 0u, m30 = 0u, m31 = 0u;
  int gl = INT_MIN, cl = -1, glu = INT_MIN, clu = -1;
  int gr = INT_MIN, cr = -1, gru = INT_MIN, cru = -1;
  int fp = EXT_BIG;  // first penalised column >= 64
  unsigned lm = 0u, ln = 0u, ls = 0u;
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * TILE + lane * K;
    unsigned p[K], cc[K], rs[K];
    unsigned pm = 0u;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      unsigned f;
      ext_col<SNV>(A, r, c0 + i, p[i], cc[i], f);
      pm |= ((f >> 2) & 1u) << i;
      lm += f & 1u;
      ln += (f >> 1) & 1u;
      ls += (f >> 3) & 1u;
      rs[i] = ext_ccost(A, r, base - 1 - (c0 + i));
    }
    // penalised bits of the 7 columns after the tile (the last lanes'
    // run_l windows)
    unsigned ahead = 0u;
    if (t + 1 < ntiles) {
      unsigned pa = 0u, ca = 0u, fa = 0u;
      if (lane < EXT_MINA)
        ext_col<SNV>(A, r, (t + 1) * TILE + lane, pa, ca, fa);
      ahead = __ballot_sync(H2_FULL_MASK, (fa >> 2) & 1u);
    }
    // exclusive prefixes within the run, then across the warp
    unsigned sP = 0u, sC = 0u, sR = 0u;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      unsigned x = p[i];
      p[i] = sP;
      sP += x;
      x = cc[i];
      cc[i] = sC;
      sC += x;
      x = rs[i];
      rs[i] = sR;
      sR += x;
    }
    unsigned iP = sP, iC = sC, iR = sR;
#pragma unroll
    for (int o2 = 1; o2 < 32; o2 <<= 1) {
      const unsigned tP = __shfl_up_sync(H2_FULL_MASK, iP, o2);
      const unsigned tC = __shfl_up_sync(H2_FULL_MASK, iC, o2);
      const unsigned tR = __shfl_up_sync(H2_FULL_MASK, iR, o2);
      iP = ext_scan_pair(iP, tP, lane, o2);
      iC = ext_scan_pair(iC, tC, lane, o2);
      iR = ext_scan_pair(iR, tR, lane, o2);
    }
    const unsigned offP = carP + iP - sP, offC = carC + iC - sC,
                   offR = carR + iR - sR;
    carP += __shfl_sync(H2_FULL_MASK, iP, 31);
    carC += __shfl_sync(H2_FULL_MASK, iC, 31);
    carR += __shfl_sync(H2_FULL_MASK, iR, 31);
    if (ntiles == 1) {
      total = carP;
      cctot = carC;
    }
    // bit windows: hist bit j is column c0 - 2K + j, fut bit j column c0 + j
    const unsigned mK = (1u << K) - 1u;
    unsigned up1 = __shfl_up_sync(H2_FULL_MASK, pm, 1);
    unsigned up2 = __shfl_up_sync(H2_FULL_MASK, pm, 2);
    unsigned dn1 = __shfl_down_sync(H2_FULL_MASK, pm, 1);
    unsigned dn2 = __shfl_down_sync(H2_FULL_MASK, pm, 2);
    if (lane == 0) {
      up1 = m31;
      up2 = m30;
    } else if (lane == 1) {
      up2 = m31;
    }
    if (lane == 31) {
      dn1 = ahead & mK;
      dn2 = (ahead >> K) & mK;
    } else if (lane == 30) {
      dn2 = ahead & mK;
    }
    m30 = __shfl_sync(H2_FULL_MASK, pm, 30);
    m31 = __shfl_sync(H2_FULL_MASK, pm, 31);
    const unsigned long long hist = (unsigned long long)up2 |
                                    ((unsigned long long)up1 << K) |
                                    ((unsigned long long)pm << (2 * K));
    const unsigned long long fut = (unsigned long long)pm |
                                   ((unsigned long long)dn1 << K) |
                                   ((unsigned long long)dn2 << (2 * K));
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int k = c0 + i;
      if (k > L) break;
      const unsigned Pk = offP + p[i], Ck = offC + cc[i], Rk = offR + rs[i];
      const bool c_r = k >= EXT_MINA &&
                       ((hist >> (i + 2 * K - EXT_MINA)) & 0x7Fu) == 0u;
      const bool c_l = k + EXT_MINA <= len && ((fut >> i) & 0x7Fu) == 0u;
      if (k <= len) {  // left clip of k columns
        const int lv = (int)(Pk - Ck);
        if (lv >= glu) {
          glu = lv;
          clu = k;
        }
        if ((k == 0 || c_l) && lv >= gl) {
          gl = lv;
          cl = k;
        }
      }
      const int b = base - k;  // right clip of b columns, bidx(b) = k
      if (b >= 0 && b <= len) {
        const int rv = (int)(total - Pk - (cctot - Rk));
        ext_best(gru, cru, rv, b);
        if (b == 0 || c_r) ext_best(gr, cr, rv, b);
      }
      if (k < EXT_HEAD) {
        sh.hP[k] = (int)Pk;
        sh.hC[k] = (int)Ck;
        if ((pm >> i) & 1u) atomicOr(&sh.bits[k >> 5], 1u << (k & 31));
        if (c_l) atomicOr(&sh.bits[2 + (k >> 5)], 1u << (k & 31));
      } else if ((pm >> i) & 1u) {
        fp = min(fp, k);
      }
      if (b >= 0 && b < EXT_HEAD) {
        sh.tP[b] = (int)Pk;
        if (c_r) atomicOr(&sh.bits[4 + (b >> 5)], 1u << (b & 31));
      }
    }
  }
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1) {
    const int v0 = __shfl_xor_sync(H2_FULL_MASK, gl, o2);
    const int i0 = __shfl_xor_sync(H2_FULL_MASK, cl, o2);
    const int v1 = __shfl_xor_sync(H2_FULL_MASK, glu, o2);
    const int i1 = __shfl_xor_sync(H2_FULL_MASK, clu, o2);
    const int v2 = __shfl_xor_sync(H2_FULL_MASK, gr, o2);
    const int i2 = __shfl_xor_sync(H2_FULL_MASK, cr, o2);
    const int v3 = __shfl_xor_sync(H2_FULL_MASK, gru, o2);
    const int i3 = __shfl_xor_sync(H2_FULL_MASK, cru, o2);
    fp = min(fp, __shfl_xor_sync(H2_FULL_MASK, fp, o2));
    ext_best(gl, cl, v0, i0);
    ext_best(glu, clu, v1, i1);
    ext_best(gr, cr, v2, i2);
    ext_best(gru, cru, v3, i3);
  }
  if (ntiles == 1) {
    cnt_mm = (int)ext_sum(lm);
    cnt_n = (int)ext_sum(ln);
    cnt_s = SNV ? (int)ext_sum(ls) : 0;
  }
  __syncwarp();
  gl = max(gl, 0);
  gr = max(gr, 0);
  o.clip_l = gl > 0 ? cl : 0;
  o.clip_r = gr > 0 ? cr : 0;
  o.score = (int)(0u - (total - (unsigned)gl - (unsigned)gr));
  o.ok = ((glu > 0 ? clu : 0) + (gru > 0 ? cru : 0)) < len;
  if (A.use_minsc) {
    const int msc = A.minsc[n];
    const int T = h2_floordiv(-msc, max(A.mm_min, 1));
    const int TW = min(L, EXT_HEAD);
    const int KCR = min(TW, 32);
    const int cl_s = o.clip_l, cr_s = o.clip_r;
    const bool uni = A.uniform_len != 0;
    const unsigned p_len = total;
    auto bit = [&](int w, int i) {
      return (sh.bits[w + (i >> 5)] >> (i & 31)) & 1u;
    };
    auto loser = [&](bool okf, int sc, int clf, int crf) {
      const bool keep = okf && (clf > 0 || crf > 0) &&
                        !(clf == cl_s && crf == cr_s) && sc >= msc;
      return keep ? sc : EXT_NO_ALT;
    };
    const unsigned long long hpen = (unsigned long long)sh.bits[0] |
                                    ((unsigned long long)sh.bits[1] << 32);
    int best_any = EXT_NO_ALT, best_own = EXT_NO_ALT;
    for (int a = lane; a < TW; a += 32) {
      const bool prev_pen = a == 0 || bit(0, a - 1);
      const bool a_okw = prev_pen && bit(2, a) && a < len;
      const unsigned long long nx = hpen >> a;
      const int nextp = nx ? a + __ffsll((long long)nx) - 1
                           : (fp < EXT_BIG ? fp : len);
      const int a1 = min(nextp, len);
      const int cl_w = (a > 0 && a <= T) ? a : 0;
      const int crw_raw = len - a1;
      const int cr_w = (crw_raw > 0 && crw_raw <= T - 1) ? crw_raw : 0;
      const bool maskL = a > 0 && a <= T;
      const bool maskR = crw_raw > 0 && crw_raw <= T - 1 && crw_raw < KCR;
      const unsigned C_cr = (cr_w >= 1 && cr_w < KCR) ? (unsigned)sh.hC[cr_w]
                                                      : 0u;
      const unsigned P_cl_e = maskL ? (unsigned)sh.hP[a] : 0u;
      const unsigned C_cl_e = maskL ? (unsigned)sh.hC[a] : 0u;
      const unsigned P_hi_e = maskR ? (unsigned)sh.hP[a] : p_len;
      const unsigned C_cr_e = maskR ? C_cr : 0u;
      const int f_b = (int)(0u - (P_hi_e - P_cl_e) - C_cl_e - C_cr_e);
      const int f_l = (int)(0u - (p_len - P_cl_e) - C_cl_e);
      const int f_r = (int)(0u - P_hi_e - C_cr_e);
      const int lb = loser(a_okw, f_b, cl_w, cr_w);
      best_any = max(best_any, lb);
      best_any = max(best_any, loser(a_okw, f_l, cl_w, 0));
      best_any = max(best_any, loser(a_okw, f_r, 0, cr_w));
      const bool own =
          (cl_w == cl_s && cl_s > 0) || (cr_w == cr_s && cr_s > 0);
      if (own) best_own = max(best_own, lb);
    }
    // p_at(b) = P[bidx(b)]: bidx(b) = max(len - b, 0) is 0 past len
    auto p_at = [&](int b) {
      return (uni || b <= len) ? (unsigned)sh.tP[b] : 0u;
    };
    for (int b = lane; b < TW; b += 32) {
      const int pen_b = b == 0 ? 0 : (int)(p_at(b - 1) - p_at(b));
      const bool ok_b = b > 0 && b <= T - 1 && pen_b > 0 && bit(4, b) &&
                        b < len;
      const unsigned Cb = (unsigned)sh.hC[b];
      best_any = max(best_any, loser(ok_b, (int)(0u - p_at(b) - Cb), 0, b));
    }
    best_any = h2_warp_max(best_any);
    best_own = h2_warp_max(best_own);
    if (cl_s == 0 && cr_s == 0)
      o.alt = best_any;
    else if (cl_s > 0 && cr_s > 0)
      o.alt = EXT_NO_ALT;
    else
      o.alt = best_own;
  }
  // counts inside the kept region [clip_l, len - clip_r)
  o.nmm = cnt_mm;
  o.nn = cnt_n;
  o.nsnp = cnt_s;
  if (o.clip_l + o.clip_r > 0) {
    if (o.clip_l >= len - o.clip_r) {
      o.nmm = o.nn = o.nsnp = 0;
    } else {
      unsigned t0, c0;
      int m0, n0, s0, m1, n1, s1;
      ext_sums<SNV>(A, r, 0, o.clip_l, lane, t0, c0, m0, n0, s0);
      ext_sums<SNV>(A, r, len - o.clip_r, len, lane, t0, c0, m1, n1, s1);
      o.nmm -= m0 + m1;
      o.nn -= n0 + n1;
      o.nsnp -= s0 + s1;
    }
  }
  o.ok = o.ok && r.start >= 0 && o.score > -(EXT_OOB_PEN / 2);
  return o;
}

// A block takes S consecutive slots (EXT_SLOTS_DENSE on a launch of many
// slots, where compacting the work keeps every resident warp busy;
// EXT_SLOTS_SPARSE on a small one, where each slot gets a warp): warp 0
// lists the slots that are the first of their start in their lane, and
// the block's warps take the list's evaluations in turn.
template <bool SNV, int K>
__global__ void __launch_bounds__(32 * EXT_WARPS, EXT_MIN_BLOCKS)
    extend_ungapped_kernel(ExtArgs A, int S) {
  __shared__ ExtStash stash[EXT_WARPS];
  __shared__ int tab[128];
  __shared__ int work[EXT_SLOTS_DENSE];
  __shared__ int nwork;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const long long s0 = (long long)blockIdx.x * S;
  tab[threadIdx.x] = threadIdx.x < 64 ? A.mm_pen[threadIdx.x]
                                      : A.clip_pen[threadIdx.x - 64];
  if (wid == 0) {
    const long long slot = s0 + lane;
    bool first = false;
    if (lane < S && slot < A.NC) {
      const long long n = slot / A.C;
      const int j = (int)(slot - n * A.C);
      const int* row = A.cand_start + n * A.C;
      const int st = row[j];
      first = true;
      for (int jj = 0; jj < j && first; ++jj) first = row[jj] != st;
    }
    const unsigned m = __ballot_sync(H2_FULL_MASK, first);
    if (first) work[__popc(m & ((1u << lane) - 1u))] = lane;
    if (lane == 0) nwork = __popc(m);
  }
  __syncthreads();
  for (int it = wid; it < nwork; it += EXT_WARPS) {
    const long long slot = s0 + work[it];
    const long long n = slot / A.C;
    const int* row = A.cand_start + n * A.C;
    const int j = (int)(slot - n * A.C);
    const int st = row[j];
    const long long at = slot * A.W + A.margin;
    const int len = A.lens[n];
    const ExtRow r{tab, A.reads + n * A.L, A.quals + n * A.L, A.win + at,
                   SNV ? A.snv1 + at : nullptr, SNV ? A.snv2 + at : nullptr,
                   (long long)st, len, A.uniform_len ? A.L : len};
    const ExtOut o = ext_eval<SNV, K>(A, r, stash[wid], n, lane);
    // every slot of the lane with this start
    for (int j0 = j; j0 < A.C; j0 += 32) {
      const int jj = j0 + lane;
      if (jj < A.C && row[jj] == st) {
        const long long c = n * A.C + jj;
        A.score[c] = o.score;
        A.n_mm[c] = o.nmm;
        A.n_n[c] = o.nn;
        A.n_snp[c] = o.nsnp;
        A.clip_l[c] = o.clip_l;
        A.clip_r[c] = o.clip_r;
        A.ok[c] = o.ok ? 1 : 0;
        A.alt[c] = o.alt;
      }
    }
  }
}

// The instantiation for read length L: K = 4, 8 or 16 columns per lane
// and tile, the smallest whose one tile holds the L + 1 boundaries (16
// above that, in several tiles).
typedef void (*ExtKernel)(ExtArgs, int);
static ExtKernel ext_pick(int L, bool snv) {
  if (L + 1 <= 32 * 4)
    return snv ? extend_ungapped_kernel<true, 4>
               : extend_ungapped_kernel<false, 4>;
  if (L + 1 <= 32 * 8)
    return snv ? extend_ungapped_kernel<true, 8>
               : extend_ungapped_kernel<false, 8>;
  return snv ? extend_ungapped_kernel<true, 16>
             : extend_ungapped_kernel<false, 16>;
}

H2_EXPORT int h2_extend_ungapped(
    const void* reads, const void* quals, const void* lens,
    const void* cand_start, const void* win, const void* mm_pen,
    const void* clip_pen, const void* minsc, const void* snv1,
    const void* snv2, long long NC, int C, int L, int W, int margin,
    long long n_text, int n_pen, int allow_softclip, int uniform_len,
    int use_minsc, int mm_min, int use_snv, void* score, void* n_mm,
    void* n_n, void* n_snp, void* clip_l, void* clip_r, void* ok, void* alt,
    void* stream) {
  if (L < 1 || W < L + 2 * margin) return (int)cudaErrorInvalidValue;
  if (NC <= 0) return (int)cudaGetLastError();
  ExtArgs A{(const int*)reads, (const int*)quals, (const int*)lens,
            (const int*)cand_start, (const int*)win, (const int*)mm_pen,
            (const int*)clip_pen, (const int*)minsc, (const int*)snv1,
            (const int*)snv2, NC, C, L, W, margin, n_text, n_pen,
            allow_softclip, uniform_len, use_minsc, mm_min,
            (int*)score, (int*)n_mm, (int*)n_n, (int*)n_snp, (int*)clip_l,
            (int*)clip_r, (uint8_t*)ok, (int*)alt};
  const int S = NC >= EXT_DENSE_NC ? EXT_SLOTS_DENSE : EXT_SLOTS_SPARSE;
  const long long blocks = (NC + S - 1) / S;
  const ExtKernel kern = ext_pick(L, use_snv != 0);
  kern<<<(unsigned)blocks, 32 * EXT_WARPS, 0, (cudaStream_t)stream>>>(A, S);
  return (int)cudaGetLastError();
}

// The launch at read length L, from the CUDA runtime: out = {registers per
// thread, static shared bytes, dynamic shared bytes, threads per block,
// blocks per SM, local (spilled or stack) bytes per thread}.
H2_EXPORT int h2_extend_ungapped_info(int L, int use_snv, int* out) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  const ExtKernel kern = ext_pick(L, use_snv != 0);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                    32 * EXT_WARPS, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = 0;
  out[3] = 32 * EXT_WARPS;
  out[4] = blocks;
  out[5] = (int)a.localSizeBytes;
  return (int)e;
}
