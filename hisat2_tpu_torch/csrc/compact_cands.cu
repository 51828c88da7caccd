// Kernel 5: full-SA resolve + candidate dedup and compaction (K3 fused
// into K4).
//
// Replaces hisat2_tpu/ops/resolve.py:resolve_consecutive, full-SA branch
// (:174-186), and the compaction of hisat2_tpu/align/pipeline.py:772-998
// with ops/compact.py:22-62 (select_ranked, take_cols).  Plain twin:
// hisat2_tpu_torch/ops/compact.py:compact_candidates_plain.
//
// One warp per lane (read strand).  The warp gates the lane's H hits (hit
// count, long/short row caps, the lite tier's caps), resolves the rows
// top..top+P-1 of every live hit straight from the suffix array, and
// compacts the live slots of the J = H*P (a slot's key: its start; its
// identity: start, + 2^30 for a sweep-only slot) into a list in slot
// order.  The JAX version compares every pair of the J slots ([N, J, J]
// and [N, C, J] one-hot masks, the TPU having no fast gather); here the
// passes are sorts of the live list, prefix counts and segmented
// reductions, with a warp bitonic sort of 64-bit keys (in registers by
// shuffles up to 32 live slots, in the warp's pool past that):
//   1. sort by (start, j): each live slot's start segment (its first
//      position, by binary search), and in spliced mode the lane's 8
//      lowest align-capable starts (the first 8 of them in this order);
//   2. sort by (dead, identity, j): the first of each run of equal
//      identities is the kept slot (first occurrence); in DNA mode the
//      kept identities are distinct and are the compaction key, so a kept
//      slot's rank is a warp prefix count of the kept before it, and the
//      first C ranks are taken;
//   3. (spliced mode) sort of the kept by (distance key, j), the first C
//      taken;
//   4. provenance: min abefore, all post, any align-capable and any taken
//      align-capable over the live slots of each start segment (shared
//      atomics at the segment's first position), read by each taken
//      slot's segment (a slot not taken reads start 0's, as JAX's
//      zero-filled start): dup_short drops a sweep-only slot whose start
//      also holds a taken align-capable slot.
// Slots m < CC go to the core arrays, the rest to the extra arrays.
//
// Sampled SA (off_rate > 0): the rows' offsets come resolved by the walk
// (csrc/resolve_walk.cu, K19+K20) as offs [N, H, P] and offs2 [N, H2, P2],
// read in place of the SA for the same live slots.
//
// Spliced mode (pipeline.py:846-933): the prefix re-search's H2 hits add
// P2 sweep-only rows each (J = H*P + H2*P2 slots); a short slot survives
// only within max_intron of one of the lane's 8 lowest align-capable
// starts (int32 distances wrap, as JAX's), and short slots rank by that
// distance (ties by slot index, the stable rank of JAX), the re-search
// rows inheriting the lane's last hit's provenance.
//
// Bound: bytes, the live rows' SA (or offs) reads, a few hundred bytes a
// lane: 0.0006 ms on a linear step, 0.0010 on config 6's full step
// (chip_smoke.py:work); the sorts are O(n log^2 n / 32) a thread over
// the lane's n live slots (1.8 a lane on the linear step, 13 on the
// spliced ones).  Measured on an H100 (PERF.md): 0.015 ms linear, 0.041
// spliced and config 6 full, of which the resolve pass took 0.006-0.010
// in the previous design; its four O(J^2 / 32) passes took 0.023 and
// 0.082-0.124 ms, following J^2.
#include "common.cuh"

#define CC_SENT 0x7FFFFFFE  // 2^31 - 2
#define CC_SHORTBIT (1 << 30)
#define CC_BIG (1 << 30)

struct CompactArgs {
  const int* sa;
  const int* top;
  const int* bot;
  const int* lo;
  const int* hi;
  const int* nh;
  const int* abefore;
  const uint8_t* post;
  const uint8_t* stopped;
  const int* top2;  // [N, H2] the spliced prefix re-search (H2 = 0: none)
  const int* bot2;
  const int* lo2;
  const int* nh2;
  const int* offs;   // [N, H, P] resolved rows of a sampled SA, or null
  const int* offs2;  // [N, H2, P2] the re-search's (spliced), or null
  int N, H, P, C, CC, min_k, maxsize, short_rows, lite_cap, lane_meta;
  int H2, P2, max_intron;
  int* cstart;   // [N, CC]
  uint8_t* cvalid;
  uint8_t* cvalid_long;
  int* cab;
  uint8_t* cpost;
  int* xstart;   // [N, C - CC]
  uint8_t* xvalid;
  int* xab;
  uint8_t* xpost;
  int* h_minw;   // [N] (lane_meta)
  uint8_t* h_alignable;
  int* h_sat;    // [N] (lite)
};

// the warp's pool (ints): the sort keys (2 * JP, JP = J rounded up to a
// power of 2; then the start segments' reductions), start [J], flag [J],
// slot / cstart / cflag [C], abefore / post [H], the 8 lowest
// align-capable starts; even, so that the next pool's keys stay aligned
__host__ __device__ inline int cc_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline int cc_warp_ints(int J, int C, int H) {
  return (2 * cc_pow2(J) + 2 * J + 3 * C + 2 * H + 8 + 1) & ~1;
}

// |a - b| in wrapping int32, |INT_MIN| = INT_MIN as jnp.abs
__device__ __forceinline__ int cc_wrap_absdiff(int a, int b) {
  const int d = (int)((unsigned)a - (unsigned)b);
  return d < 0 ? (int)(0u - (unsigned)d) : d;
}

__device__ __forceinline__ unsigned cc_bias(int v) {
  return (unsigned)v ^ 0x80000000u;  // signed order as unsigned
}

// ascending sort of s[0..np) (np a power of 2, padded with ~0) by the warp
__device__ void cc_sort(unsigned long long* s, int np, int lane) {
  if (np <= 1) return;
  if (np <= 32) {  // the lanes below np form their own bitonic blocks
    unsigned long long v = lane < np ? s[lane] : ~0ull;
    for (int k = 2; k <= np; k <<= 1) {
      for (int jj = k >> 1; jj > 0; jj >>= 1) {
        const unsigned long long o = __shfl_xor_sync(H2_FULL_MASK, v, jj);
        const bool keep_min = ((lane & jj) == 0) == ((lane & k) == 0);
        v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
      }
    }
    __syncwarp();
    if (lane < np) s[lane] = v;
    __syncwarp();
    return;
  }
  for (int k = 2; k <= np; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int i = lane; i < (np >> 1); i += 32) {
        const int lo = ((i & ~(jj - 1)) << 1) | (i & (jj - 1));
        const int hi = lo + jj;
        const unsigned long long a = s[lo], b = s[hi];
        if ((a > b) == ((lo & k) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncwarp();
    }
  }
}

// the first position of s[0..n) whose high word is >= hi
__device__ __forceinline__ int cc_lower_bound(const unsigned long long* s,
                                              int n, unsigned hi) {
  int lo = 0, len = n;
  while (len > 0) {
    const int half = len >> 1;
    if ((unsigned)(s[lo + half] >> 32) < hi) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

#define CC_ALIGN 2       // align-capable
#define CC_LIVE 4        // live after the proximity filter (the live rows
                         // before it are the sort keys)
#define CC_KEPT 8        // the first of its identity
#define CC_TAKEN 16      // among the first C
#define CC_SEG_POST 1    // segment reductions: all post
#define CC_SEG_ALIGN 2   // any align-capable
#define CC_SEG_TAKEN 4   // any taken align-capable

// GLOBAL: each warp keeps its pool in its slice of `scratch` (cc_config),
// not in shared memory (a separate instantiation, so that the shared one
// keeps its shared-memory accesses), the warps walking the lanes with a
// grid stride; else a warp per lane, its pool in dynamic shared memory
template <bool GLOBAL>
__global__ void compact_cands_kernel(CompactArgs A, int warps,
                                     int* scratch) {
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1;
  const int H = A.H, P = A.P, C = A.C, J1 = H * P;
  const int J = J1 + A.H2 * A.P2;
  const bool spliced = A.H2 > 0;
  const size_t per = cc_warp_ints(J, C, H);
  int* pool = GLOBAL ? scratch + ((size_t)blockIdx.x * warps + wid) *
                                     (h2_slice(per * sizeof(int)) /
                                      sizeof(int))
                     : smem + (size_t)wid * per;
  const int JP = cc_pow2(J);
  unsigned long long* sKey = reinterpret_cast<unsigned long long*>(pool);
  int* sSegAb = pool;            // [JP] (after the sorts)
  int* sSegBits = pool + JP;     // [JP]
  int* sStart = pool + 2 * JP;   // [J]
  int* sFlag = sStart + J;       // [J]: CC_* bits, segment start << 8
  int* sSlot = sFlag + J;        // [C] slot -> source j, -1 if empty
  int* sCStart = sSlot + C;      // [C]
  int* sCFlag = sCStart + C;     // [C] bit0 taken, bit1 short
  int* sAb = sCFlag + C;         // [H]
  int* sPost = sAb + H;          // [H]
  int* sLsort = sPost + H;       // [8] lowest align-capable starts
  for (int n = blockIdx.x * warps + wid; n < A.N;
       n += gridDim.x * warps) {  // uniform per warp
    const int nh = A.nh[n];
    const bool stopped = A.stopped[n] != 0;
    const bool lite = A.lite_cap > 0;
    const int full_max = A.maxsize;
    const int maxsize = lite ? min(A.maxsize, A.lite_cap) : A.maxsize;
    const int* top = A.top + (size_t)n * H;
    const int* bot = A.bot + (size_t)n * H;
    const int* lo = A.lo + (size_t)n * H;
    const int* hi = A.hi + (size_t)n * H;

    // --- per-hit gates and lane metadata ---
    int minw = CC_BIG, alignable = 0, wide = 0;
    for (int h = lane; h < H; h += 32) {
      const int w = (int)((unsigned)bot[h] - (unsigned)top[h]);
      const bool islong =
          (int)((unsigned)hi[h] - (unsigned)lo[h]) > A.min_k + 2;
      const bool hv0 = h < nh;
      const bool hv = hv0 && (!lite || islong) &&
                      (islong ? w <= maxsize : w <= A.short_rows);
      const bool hv_meta =
          lite ? hv0 && (islong ? w <= full_max : w <= A.short_rows) : hv;
      if (hv_meta && w > 0) minw = min(minw, w);
      if (islong && (w == 1 || !stopped)) alignable = 1;
      if (lite && hv0 && islong && w > maxsize && w <= full_max) wide = 1;
      sAb[h] = A.abefore[(size_t)n * H + h];
      sPost[h] = A.post[(size_t)n * H + h];
    }
    // --- resolve rows top..top+P-1, compact the live slots by (start, j)
    int nl = 0, na = 0;
    for (int base = 0; base < J; base += 32) {
      const int j = base + lane;
      bool cv = false, align = false;
      int st = 0;
      if (j >= J1 && j < J) {  // a re-search row: sweep-only
        const int j2 = j - J1, h2 = j2 / A.P2, jj = j2 - h2 * A.P2;
        const size_t o2 = (size_t)n * A.H2 + h2;
        const int t = A.top2[o2];
        const int w2 = (int)((unsigned)A.bot2[o2] - (unsigned)t);
        cv = h2 < A.nh2[n] && w2 <= A.P2 && jj < w2;
        if (cv)
          st = (int)((unsigned)(A.offs2 != nullptr
                                    ? A.offs2[o2 * A.P2 + jj]
                                    : __ldg(A.sa + ((long long)t + jj))) -
                     (unsigned)A.lo2[o2]);
      } else if (j < J1) {
        const int h = j / P, jj = j - h * P;
        const int t = top[h];
        const int w = (int)((unsigned)bot[h] - (unsigned)t);
        const bool islong =
            (int)((unsigned)hi[h] - (unsigned)lo[h]) > A.min_k + 2;
        const bool hv = h < nh && (!lite || islong) &&
                        (islong ? w <= maxsize : w <= A.short_rows);
        cv = hv && jj < w;
        align = islong && (w == 1 || !stopped);
        if (cv) {
          const int off = A.offs != nullptr
                              ? A.offs[((size_t)n * H + h) * P + jj]
                              : __ldg(A.sa + ((long long)t + jj));
          st = (int)((unsigned)off - (unsigned)lo[h]);
        }
      }
      if (j < J) {
        sStart[j] = st;
        sFlag[j] = (cv ? CC_LIVE : 0) | (align ? CC_ALIGN : 0);
      }
      const unsigned bal = __ballot_sync(H2_FULL_MASK, cv);
      if (cv)
        sKey[nl + __popc(bal & lt)] =
            ((unsigned long long)cc_bias(st) << 32) | (unsigned)j;
      nl += __popc(bal);
      na += __popc(__ballot_sync(H2_FULL_MASK, cv && align));
    }
    const int np = cc_pow2(nl);
    for (int p = nl + lane; p < np; p += 32) sKey[p] = ~0ull;
    for (int m = lane; m < C; m += 32) sSlot[m] = -1;
    __syncwarp();
    // --- 1. by (start, j): start segments, the 8 lowest align starts ---
    cc_sort(sKey, np, lane);
    for (int p = lane; p < nl; p += 32) {
      const unsigned long long k = sKey[p];
      const int j = (int)(unsigned)k;
      sFlag[j] |= cc_lower_bound(sKey, nl, (unsigned)(k >> 32)) << 8;
    }
    __syncwarp();
    int head0 = -1;  // the segment of start 0 (a slot not taken)
    if (lane == 0) {
      const int p = cc_lower_bound(sKey, nl, cc_bias(0));
      if (p < nl && (unsigned)(sKey[p] >> 32) == cc_bias(0)) head0 = p;
    }
    head0 = __shfl_sync(H2_FULL_MASK, head0, 0);
    const int nls = min(J, 8);
    if (spliced) {
      // the first 8 of sort(where(live & align, start, SENT)): the align
      // starts in order, SENT past them (J - na copies), then any start
      // above SENT (INT_MAX)
      int found = 0;
      for (int base = 0; base < nl && found < nls; base += 32) {
        const int p = base + lane;
        const bool a =
            p < nl && (sFlag[(int)(unsigned)sKey[p]] & CC_ALIGN) != 0;
        const unsigned bal = __ballot_sync(H2_FULL_MASK, a);
        const int r = found + __popc(bal & lt);
        if (a && r < nls) sLsort[r] = (int)((unsigned)(sKey[p] >> 32) ^
                                            0x80000000u);
        found += __popc(bal);
      }
      __syncwarp();
      if (lane == 0) {
        int kle = 0;
        while (kle < min(found, nls) && sLsort[kle] != INT_MAX) ++kle;
        for (int k = kle; k < nls; ++k)
          sLsort[k] = k - kle < J - na ? CC_SENT : INT_MAX;
      }
      __syncwarp();
      // the proximity filter of the short slots
      for (int p = lane; p < nl; p += 32) {
        const unsigned long long k = sKey[p];
        const int j = (int)(unsigned)k;
        if (sFlag[j] & CC_ALIGN) continue;
        const int st = sStart[j];
        int ad = INT_MAX;
        for (int q = 0; q < nls; ++q)
          ad = min(ad, cc_wrap_absdiff(st, sLsort[q]));
        if (!(ad <= A.max_intron)) sFlag[j] &= ~CC_LIVE;
      }
    }
    __syncwarp();
    // --- 2. by (dead, identity, j): first occurrence, DNA rank ---
    for (int p = lane; p < nl; p += 32) {
      const int j = (int)(unsigned)sKey[p];
      const int f = sFlag[j];
      const unsigned id =
          (unsigned)sStart[j] + ((f & CC_ALIGN) ? 0u : (unsigned)CC_SHORTBIT);
      sKey[p] = ((unsigned long long)((f & CC_LIVE) ? 0 : 1) << 63) |
                ((unsigned long long)(id ^ 0x80000000u) << 31) |
                (unsigned)j;
    }
    __syncwarp();
    cc_sort(sKey, np, lane);
    int nlong = 0, r0 = 0;
    for (int base = 0; base < nl; base += 32) {
      const int p = base + lane;
      bool kept = false;
      int j = 0;
      if (p < nl) {
        const unsigned long long k = sKey[p];
        j = (int)((unsigned)k & 0x7FFFFFFFu);
        const unsigned id = (unsigned)(k >> 31) ^ 0x80000000u;
        kept = !(k >> 63) && id != (unsigned)CC_SENT &&
               (p == 0 || (sKey[p - 1] >> 31) != (k >> 31));
        if (kept) {
          sFlag[j] |= CC_KEPT;
          if (sFlag[j] & CC_ALIGN) ++nlong;
        }
      }
      if (!spliced) {
        const unsigned bal = __ballot_sync(H2_FULL_MASK, kept);
        const int r = r0 + __popc(bal & lt);
        if (kept && r < C) sSlot[r] = j;
        r0 += __popc(bal);
      }
    }
    __syncwarp();
    if (spliced) {
      // --- 3. the kept by (distance key, j) ---
      for (int p = lane; p < nl; p += 32) {
        const int j = (int)((unsigned)sKey[p] & 0x7FFFFFFFu);
        const int f = sFlag[j];
        const int st = sStart[j];
        int skey = st;
        if (!(f & CC_ALIGN)) {
          int ad = INT_MAX;
          for (int q = 0; q < nls; ++q)
            ad = min(ad, cc_wrap_absdiff(st, sLsort[q]));
          skey = (int)((unsigned)CC_SHORTBIT +
                       (unsigned)min(ad, CC_SHORTBIT - 1));
        }
        sKey[p] = ((unsigned long long)((f & CC_KEPT) ? 0 : 1) << 63) |
                  ((unsigned long long)cc_bias(skey) << 31) | (unsigned)j;
      }
      __syncwarp();
      cc_sort(sKey, np, lane);
      for (int p = lane; p < min(nl, C); p += 32) {
        const unsigned long long k = sKey[p];
        if (!(k >> 63)) sSlot[p] = (int)((unsigned)k & 0x7FFFFFFFu);
      }
    }
    __syncwarp();
    for (int m = lane; m < C; m += 32) {
      const int j = sSlot[m];
      sCStart[m] = j >= 0 ? sStart[j] : 0;
      sCFlag[m] = j >= 0 ? (1 | ((sFlag[j] & CC_ALIGN) ? 0 : 2)) : 0;
      if (j >= 0) sFlag[j] |= CC_TAKEN;
    }
    for (int p = lane; p < nl; p += 32) {  // the keys are spent
      sSegAb[p] = CC_BIG;
      sSegBits[p] = CC_SEG_POST;
    }
    __syncwarp();
    // --- 4. provenance over each start segment ---
    for (int j = lane; j < J; j += 32) {
      const int f = sFlag[j];
      if (!(f & CC_LIVE)) continue;
      const int seg = f >> 8;
      const int h = j < J1 ? j / P : max(nh - 1, 0);
      atomicMin(sSegAb + seg, sAb[h]);
      if (!sPost[h]) atomicAnd(sSegBits + seg, ~CC_SEG_POST);
      if (f & CC_ALIGN)
        atomicOr(sSegBits + seg,
                 CC_SEG_ALIGN | ((f & CC_TAKEN) ? CC_SEG_TAKEN : 0));
    }
    __syncwarp();
    for (int m = lane; m < C; m += 32) {
      const int j = sSlot[m];
      const int cs = sCStart[m];
      const int cf = sCFlag[m];
      const int seg = j >= 0 ? sFlag[j] >> 8 : head0;
      const int ab = seg >= 0 ? sSegAb[seg] : CC_BIG;
      const int bits = seg >= 0 ? sSegBits[seg] : CC_SEG_POST;
      bool valid = (cf & 1) != 0;
      if ((cf & 2) && (bits & CC_SEG_TAKEN)) valid = false;  // dup_short
      const bool allpost = (bits & CC_SEG_POST) != 0;
      const bool vlong = valid && (bits & CC_SEG_ALIGN);
      if (m < A.CC) {
        const size_t o = (size_t)n * A.CC + m;
        A.cstart[o] = cs;
        A.cvalid[o] = valid ? 1 : 0;
        A.cvalid_long[o] = vlong ? 1 : 0;
        A.cab[o] = ab;
        A.cpost[o] = allpost ? 1 : 0;
      } else {
        const size_t o = (size_t)n * (C - A.CC) + (m - A.CC);
        A.xstart[o] = cs;
        A.xvalid[o] = vlong ? 1 : 0;
        A.xab[o] = ab;
        A.xpost[o] = allpost ? 1 : 0;
      }
    }
    // --- lane outputs ---
    minw = -h2_warp_max(-minw);
    alignable = h2_warp_max(alignable);
    wide = h2_warp_max(wide);
    nlong = h2_warp_sum(nlong);
    if (lane == 0) {
      if (A.lane_meta) {
        A.h_minw[n] = minw;
        A.h_alignable[n] = alignable ? 1 : 0;
      }
      if (lite) A.h_sat[n] = min(nlong, 63) + 64 * wide;
    }
    __syncwarp();  // the next lane reuses the pool
  }
}

// warps per block (up to 4 within 48 KB of shared memory, else as many
// as the opt-in limit holds) and their dynamic shared bytes, else
// (h2_staging) CC_WARPS warps without shared memory, each keeping its
// pool in its slice of a scratch of `have` bytes
#define CC_WARPS 4
static cudaError_t cc_config(int J, int C, int H, int N, size_t have,
                             int* warps, size_t* smem, H2Staging* st) {
  const size_t per = (size_t)cc_warp_ints(J, C, H) * sizeof(int);
  cudaError_t e = h2_staging(compact_cands_kernel<false>,
                             compact_cands_kernel<true>, 32 * CC_WARPS,
                             CC_WARPS, per, (N + CC_WARPS - 1) / CC_WARPS,
                             have, st);
  if (e != cudaSuccess) return e;
  int w = CC_WARPS;
  while (!st->global && w > 1 && w * per > 48 * 1024) w >>= 1;
  *warps = w;
  *smem = st->global ? 0 : w * per;
  if (!st->global) st->grid = (N + w - 1) / w;
  return cudaSuccess;
}

// The global scratch h2_compact_cands needs for N lanes at these shapes
// (0: none).
H2_EXPORT int h2_compact_cands_scratch(int H, int P, int C, int H2, int P2,
                                       int N, long long* bytes) {
  int warps = 0;
  size_t smem = 0;
  H2Staging st;
  cudaError_t e = cc_config(H * P + H2 * P2, C, H, N, SIZE_MAX, &warps,
                            &smem, &st);
  *bytes = (long long)st.scratch;
  return (int)e;
}

H2_EXPORT int h2_compact_cands(
    const void* sa, const void* top, const void* bot, const void* lo,
    const void* hi, const void* nh, const void* abefore, const void* post,
    const void* stopped, const void* top2, const void* bot2,
    const void* lo2, const void* nh2, const void* offs, const void* offs2,
    int N, int H, int P, int C, int CC,
    int min_k, int maxsize, int short_rows, int lite_cap, int lane_meta,
    int H2, int P2, int max_intron, void* cstart,
    void* cvalid, void* cvalid_long, void* cab, void* cpost, void* xstart,
    void* xvalid, void* xab, void* xpost, void* h_minw, void* h_alignable,
    void* h_sat, void* scratch, long long scratch_bytes, void* stream) {
  if (H < 1 || P < 1 || C < 1 || CC < 0 || CC > C)
    return (int)cudaErrorInvalidValue;
  CompactArgs A{(const int*)sa, (const int*)top, (const int*)bot,
                (const int*)lo, (const int*)hi, (const int*)nh,
                (const int*)abefore, (const uint8_t*)post,
                (const uint8_t*)stopped, (const int*)top2, (const int*)bot2,
                (const int*)lo2, (const int*)nh2, (const int*)offs,
                (const int*)offs2, N, H, P, C, CC, min_k,
                maxsize, short_rows, lite_cap, lane_meta, H2, P2,
                max_intron, (int*)cstart,
                (uint8_t*)cvalid, (uint8_t*)cvalid_long, (int*)cab,
                (uint8_t*)cpost, (int*)xstart, (uint8_t*)xvalid, (int*)xab,
                (uint8_t*)xpost, (int*)h_minw, (uint8_t*)h_alignable,
                (int*)h_sat};
  int warps = 0;
  size_t smem = 0;
  H2Staging st;
  cudaError_t e = cc_config(H * P + H2 * P2, C, H, N,
                            scratch ? (size_t)scratch_bytes : 0, &warps,
                            &smem, &st);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = st.grid;
  auto kern = st.global ? compact_cands_kernel<true>
                        : compact_cands_kernel<false>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (blocks > 0)
    kern<<<(unsigned)blocks, 32 * warps, smem, (cudaStream_t)stream>>>(A, warps,
                                                             (int*)scratch);
  return (int)cudaGetLastError();
}
