// Per-diagonal junction planes of one lane in shared memory (shared by
// K13 pair_sweep.cu and K15 second_sweep.cu).
//
// Replaces what hisat2_tpu/ops/splice.py builds before its sweeps
// (pair_sweep :317-429, second_sweep :1125-1141): from each candidate's
// reference window (diag_chars, margin M) and the read, the penalty
// prefix P[x] (quality mismatch + N + out-of-text, ops/extend.py:72
// pen_planes' pen_raw: catalog SNVs are not forgiven), on a graph index
// the SNV-forgiving penalty prefix Pi[x] (pen_planes' pen, from the two
// SNV-plane windows: a mismatch whose read base is (ref + v) & 3 for a
// nonzero delta v = min(delta, 3) of either plane costs nothing, as
// extend.py:104-113; on a linear index Pi aliases P and takes no shared
// memory), the raw-mismatch prefix Pm[x], the penalized-column prefix
// Pr[x], the budget-scan bases (:389-419), the donor / acceptor
// dinucleotide codes and the PWM products (_pwm_prod :222, t ascending,
// each product rounded once: __fmul_rn keeps nvcc from contracting
// anything).  Plain twins: ops/splice.py:_prefix, _codes, _pwm_planes and
// the base planes in _pair_sweep_lanes.  x runs over 0..L; past the read
// the prefixes hold their total.  The planes never touch device memory.
//
// The sweeps read a junction's class from two masks: a donor-side mask
// per (diagonal, x) of the six (donor, acceptor) dinucleotide patterns of
// hi_aligner.h:1454-1458 its donor dinucleotide starts (GT-AG, CT-AC,
// GC-AG, AT-AC, CT-GC, GA-AT), an acceptor-side mask of those its acceptor
// dinucleotide ends, so (donor mask & acceptor mask) names the class.  On
// K13 bit 7 of each mask byte holds the budget test of that side at x
// (splice.py:389-419: lp - bl[x] <= -minsc on the donor side, rp - br[x]
// <= -minsc on the acceptor side), so the bases bl and br never take room.
//
// The prologue (sp_build) runs in four steps, each ending at a barrier:
//  1. stage: the lane's windows as bytes (diag_chars writes 0-3, and 4
//     outside the text; a byte holds every value the planes test), the
//     read as bytes and each column's quality penalty;
//  2. masks and PWM products: each warp takes a contiguous run of the
//     C * (L+1) cells (in pieces of SP_PIECE), 32 at a time; a cell whose
//     donor dinucleotide is GT or CT, or whose acceptor dinucleotide is
//     AG or AC, queues its one PWM product on that side in the warp's own
//     queue (a product is read only where the junction is canonical, and
//     then exactly one of the two on each side is: about a quarter of the
//     cells need one, none more than two); then the warp's lanes take its
//     queue, one product each, 9-factor products first, the factors from
//     tables indexed by the staged byte (the reverse-complement ones
//     pre-flipped).  The queues live in the P plane, which step 3 writes;
//  3. penalties: one (diagonal, column) cell per thread, each written
//     where its prefix goes;
//  4. prefixes: a group of 8 lanes per diagonal (16 past L = 256), so
//     that up to 32 diagonals go at once (more in turns), each lane a run
//     of columns: the lane's run totals, one group scan each (P, Pi, Pm,
//     Pr sums, the last penalized column a max), then the run again to
//     turn the penalties into prefixes in place.  On K13 the budget bases
//     too, by the same pattern: the next penalized column a suffix min,
//     the qualifying columns (found 32 columns at a time, each word's
//     penalized columns a bit mask, and marked in the acceptor mask's
//     spare bit SP_Q until the donor pass clears it), br a suffix max and
//     bl a prefix max over them, each folded into its side's budget bit.
// Rows are strided so that a warp reading one column of 32 different rows
// hits 32 banks: an odd number of words per row for every plane width.
// The staged windows share room with what the kernel keeps after the
// prologue (its union region).
//
// Where the planes of one lane outgrow the shared memory a block can use
// (long reads, many candidates), the kernels carve the same SpPlanes out
// of the block's slice of a global scratch instead (common.cuh:
// h2_staging, a block a lane): their own template instantiation, so that
// the shared one keeps its shared-memory accesses, each block walking the
// lanes with a grid stride.
#pragma once

#include "live_prefix.cuh"

#define SP_MAX_COLS 32766  // the int16 column counts (Pm, Pr, K13's x)
#define SP_PIECE 32768     // step 2's cells per queue (uint16 items)
#define SP_FTAB 240       // factor tables: 5 byte values x (9 + 9 + 15 + 15)
#define SP_DFW 0          // table offsets: donor forward [5][9]
#define SP_DRC 45         // donor reverse complement [5][9]
#define SP_AFW 90         // acceptor forward [5][15]
#define SP_ARC 165        // acceptor reverse complement [5][15]
// the mask bits: a (donor, acceptor) dinucleotide pattern each
#define SP_CFW 1u     // GT-AG: canonical forward
#define SP_CRC 2u     // CT-AC: canonical reverse
#define SP_SFW 12u    // GC-AG, AT-AC: semi-canonical forward
#define SP_SRC 48u    // CT-GC, GA-AT: semi-canonical reverse
#define SP_OK 128u    // K13: the side's budget test holds
#define SP_Q 64u      // K13, acceptor mask, step 4 only: a qualifying column

struct SpPlanes {
  int X1;        // L + 1 columns per diagonal
  int XS, XSh, XSb;  // row strides of the int32 / int16 / byte planes
  int* P;        // [C][XS] penalty prefix (SNVs not forgiven)
  int* Pi;       // [C][XS] SNV-forgiving penalty prefix (P on a linear index)
  float* dpw;    // [C][XS] donor-side PWM product: forward donor where the
                 // donor dinucleotide is GT, reverse acceptor where CT
  float* apw;    // [C][XS] acceptor-side: forward acceptor where the
                 // acceptor dinucleotide is AG, reverse donor where AC
  int16_t* Pm;   // [C][XSh] raw-mismatch prefix (counts columns: <= L)
  int16_t* Pr;   // [C][XSh] penalized-column prefix (budget planes only)
  uint8_t* dk;   // [C][XSb] donor-side mask (+ SP_OK on K13)
  uint8_t* ak;   // [C][XSb] acceptor-side mask (+ SP_OK on K13)
  float* ftab;   // [SP_FTAB] PWM factor tables by staged byte
  uint8_t* mtab; // [2][25] donor / acceptor masks by staged bytes (b0, b1)
  int* lp;       // [4][LP] intron-length step tables
  int* start;    // [C] candidate starts
  uint8_t* valid;  // [C]
  char* uni;     // the union region: staging, then the kernel's own arrays
  uint8_t* w;    // staging: [C][W] reference windows
  uint8_t* v1;   // [C][W] SNV-plane windows (graph index only)
  uint8_t* v2;
  uint8_t* rd;   // [L] read
  int* mq;       // [L] quality mismatch penalty of each column
};

__host__ __device__ inline size_t sp_align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// row strides (elements) of the int32, int16 and byte planes: L + 1
// columns, an odd number of 4-byte words
__host__ __device__ inline int sp_stride(int L) { return (L + 1) | 1; }
__host__ __device__ inline int sp_stride_h(int L) {
  return 2 * (((L + 2) / 2) | 1);
}
__host__ __device__ inline int sp_stride_b(int L) {
  return 4 * (((L + 4) / 4) | 1);
}

// Byte offsets of every section in dynamic shared memory; returns the
// total.  post: the bytes the kernel keeps in the union region after the
// prologue.  ops/splice.py reads the total through h2_pair_sweep_info /
// h2_second_sweep_info (sp_launch_info).
struct SpOffsets {
  size_t ftab, mtab, lp, start, valid, P, Pi, dpw, apw, Pm, Pr, dk, ak, uni,
      w, v1, v2, rd, mq;
};

__host__ __device__ inline size_t sp_layout(int C, int L, int W, int LP,
                                            bool budget, bool snv,
                                            size_t post, SpOffsets* o) {
  const size_t n = (size_t)C * sp_stride(L);
  const size_t nh = (size_t)C * sp_stride_h(L);
  const size_t nb = (size_t)C * sp_stride_b(L);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t r = at;
    at = sp_align16(at + bytes);
    return r;
  };
  o->ftab = take(SP_FTAB * 4);
  o->mtab = take(50);
  o->lp = take((size_t)16 * LP);
  o->start = take((size_t)4 * C);
  o->valid = take((size_t)C);
  o->P = take(4 * n);
  o->Pi = snv ? take(4 * n) : o->P;
  o->dpw = take(4 * n);
  o->apw = take(4 * n);
  o->Pm = take(2 * nh);
  o->Pr = budget ? take(2 * nh) : 0;
  o->dk = take(nb);
  o->ak = take(nb);
  // staging: windows, SNV windows, read, quality penalties (4-aligned)
  const size_t cw = (size_t)C * W;
  o->w = 0;
  o->v1 = snv ? cw : 0;
  o->v2 = snv ? 2 * cw : 0;
  o->rd = (snv ? 3 : 1) * cw;
  o->mq = (o->rd + L + 3) & ~(size_t)3;
  const size_t stage = o->mq + (size_t)4 * L;
  o->uni = take(stage > post ? stage : post);
  return at;
}

// Launch the shared or the global instantiation as h2_staging says (a
// block a lane; the dynamic shared bytes set first where they pass 48 KB).
template <class A>
inline cudaError_t sp_launch(void (*shared_k)(A, char*),
                             void (*global_k)(A, char*), int threads,
                             size_t need, const H2Staging& c, const A& args,
                             void* scratch, void* stream) {
  auto k = c.global ? global_k : shared_k;
  const size_t smem = c.global ? 0 : need;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (c.grid > 0)
    k<<<(unsigned)c.grid, threads, smem, (cudaStream_t)stream>>>(
        args, (char*)scratch);
  return cudaGetLastError();
}

// The launch of a sweep kernel at `threads` with planes of `need` bytes:
// out = {registers per thread, static shared bytes, dynamic shared bytes,
// threads per block, blocks per SM, local bytes per thread, global scratch
// bytes per block (0 where the planes fit the shared memory)}.
template <class K>
inline int sp_launch_info(K* shared_k, K* global_k, int threads,
                          size_t need, int* out) {
  H2Staging c;
  cudaError_t e = h2_staging(shared_k, global_k, threads, 1, need, 1,
                             SIZE_MAX, &c);
  if (e != cudaSuccess) return (int)e;
  K* k = c.global ? global_k : shared_k;
  const size_t smem = c.global ? 0 : need;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, k);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = threads;
  out[4] = 0;
  out[5] = (int)a.localSizeBytes;
  out[6] = (int)c.slice;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], k,
                                                            threads, smem);
}

__device__ inline void sp_carve(char* base, int C, int L, int W, int LP,
                                bool budget, bool snv, size_t post,
                                SpPlanes& s) {
  SpOffsets o;
  sp_layout(C, L, W, LP, budget, snv, post, &o);
  s.X1 = L + 1;
  s.XS = sp_stride(L);
  s.XSh = sp_stride_h(L);
  s.XSb = sp_stride_b(L);
  s.ftab = (float*)(base + o.ftab);
  s.mtab = (uint8_t*)(base + o.mtab);
  s.lp = (int*)(base + o.lp);
  s.start = (int*)(base + o.start);
  s.valid = (uint8_t*)(base + o.valid);
  s.P = (int*)(base + o.P);
  s.Pi = (int*)(base + o.Pi);
  s.dpw = (float*)(base + o.dpw);
  s.apw = (float*)(base + o.apw);
  s.Pm = (int16_t*)(base + o.Pm);
  s.Pr = budget ? (int16_t*)(base + o.Pr) : nullptr;
  s.dk = (uint8_t*)(base + o.dk);
  s.ak = (uint8_t*)(base + o.ak);
  s.uni = base + o.uni;
  s.w = (uint8_t*)(s.uni + o.w);
  s.v1 = snv ? (uint8_t*)(s.uni + o.v1) : nullptr;
  s.v2 = snv ? (uint8_t*)(s.uni + o.v2) : nullptr;
  s.rd = (uint8_t*)(s.uni + o.rd);
  s.mq = (int*)(s.uni + o.mq);
}

__device__ __forceinline__ int sp_base(int c) { return c > 3 ? 0 : c; }

// The masks of a donor dinucleotide (d0, d1) and of an acceptor one (a0,
// a1), bases 0-3 (a base outside 0-3 matches no pattern).
__device__ __forceinline__ unsigned sp_donor_mask(int d0, int d1) {
  if (d0 > 3 || d1 > 3) return 0;
  const int d = d0 * 4 + d1;   // GT 11, CT 7, GC 9, AT 3, GA 8
  return d == 11 ? 1u : d == 7 ? 2u | 16u : d == 9 ? 4u : d == 3 ? 8u
       : d == 8 ? 32u : 0u;
}

__device__ __forceinline__ unsigned sp_acceptor_mask(int a0, int a1) {
  if (a0 > 3 || a1 > 3) return 0;
  const int a = a0 * 4 + a1;   // AG 2, AC 1, GC 9, AT 3
  return a == 2 ? 1u | 4u : a == 1 ? 2u | 8u : a == 9 ? 16u : a == 3 ? 32u
       : 0u;
}

// junction class (1 canonical forward, 2 canonical reverse, 3 / 4
// semi-canonical, 0 none) of (donor mask & acceptor mask)
__device__ __forceinline__ int sp_dir(unsigned m) {
  return (m & SP_CFW) ? 1 : (m & SP_CRC) ? 2 : (m & SP_SFW) ? 3
       : (m & SP_SRC) ? 4 : 0;
}

// dst[i] = min(src[i], cap) as bytes for i < n (src 4-byte aligned): a
// scalar head up to 16-byte alignment, then 16-byte loads, then a tail.
__device__ inline void sp_stage_bytes(uint8_t* dst, const int* src, int n,
                                      unsigned cap) {
  const int head =
      min(n, (int)(((16 - ((uintptr_t)src & 15)) & 15) >> 2));
  for (int i = threadIdx.x; i < head; i += blockDim.x)
    dst[i] = (uint8_t)min((unsigned)__ldg(src + i), cap);
  const int nv = (n - head) >> 2;
  const int4* v = (const int4*)(src + head);
  uint8_t* d = dst + head;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const int4 q = __ldg(v + i);
    d[4 * i] = (uint8_t)min((unsigned)q.x, cap);
    d[4 * i + 1] = (uint8_t)min((unsigned)q.y, cap);
    d[4 * i + 2] = (uint8_t)min((unsigned)q.z, cap);
    d[4 * i + 3] = (uint8_t)min((unsigned)q.w, cap);
  }
  for (int i = head + 4 * nv + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = (uint8_t)min((unsigned)__ldg(src + i), cap);
}

// The block's constant tables: the PWM factors by staged byte (the
// reverse-complement ones flipped: byte b, step t reads the factor of base
// 3 - b at column k-1-t), the junction masks by staged bytes, the
// intron-length step tables, and the lane's starts and valid flags.  Ends with no barrier
// (sp_build's first step has one before anything reads them).
__device__ inline void sp_tables(const SpPlanes& s,
                                 const float* __restrict__ pwm,
                                 const int* __restrict__ lp, int LP,
                                 const int* __restrict__ starts,
                                 const uint8_t* __restrict__ valid, int C) {
  for (int k = threadIdx.x; k < SP_FTAB; k += blockDim.x) {
    int off, K, src, rc;
    if (k < SP_DRC) {
      off = SP_DFW; K = 9; src = 0; rc = 0;
    } else if (k < SP_AFW) {
      off = SP_DRC; K = 9; src = 0; rc = 1;
    } else if (k < SP_ARC) {
      off = SP_AFW; K = 15; src = 36; rc = 0;
    } else {
      off = SP_ARC; K = 15; src = 36; rc = 1;
    }
    const int b = (k - off) / K, t = (k - off) - b * K;
    const int c = sp_base(b);
    s.ftab[k] = rc ? __ldg(pwm + src + (3 - c) * K + (K - 1 - t))
                   : __ldg(pwm + src + c * K + t);
  }
  for (int k = threadIdx.x; k < 50; k += blockDim.x) {
    const int b0 = (k % 25) / 5, b1 = k % 5;
    s.mtab[k] = (uint8_t)(k < 25 ? sp_donor_mask(b0, b1)
                                 : sp_acceptor_mask(b0, b1));
  }
  for (int k = threadIdx.x; k < 4 * LP; k += blockDim.x) s.lp[k] = __ldg(lp + k);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    s.start[c] = __ldg(starts + c);
    s.valid[c] = valid[c];
  }
}

// A PWM product over the staged window bytes w: K factors of the table
// tab ([5][K]), t ascending, each product rounded.
template <int K>
__device__ __forceinline__ float sp_pwm(const uint8_t* w, const float* tab) {
  float f[K];
#pragma unroll
  for (int t = 0; t < K; ++t) f[t] = tab[w[t] * K + t];
  float acc = f[0];
#pragma unroll
  for (int t = 1; t < K; ++t) acc = __fmul_rn(acc, f[t]);
  return acc;
}

// Scans over the G lanes of a group (G a power of two; g = lane % G),
// exclusive: lane g gets op over the group's lanes before g (prefix) or
// after g (suffix), the identity at the end.
__device__ __forceinline__ int sp_excl_sum(int v, int g, int G) {
  int a = v;
  for (int o = 1; o < G; o <<= 1) {
    const int t = __shfl_up_sync(H2_FULL_MASK, a, o, G);
    if (g >= o) a += t;
  }
  return a - v;
}

__device__ __forceinline__ int sp_excl_max(int v, int g, int G, int id) {
  for (int o = 1; o < G; o <<= 1) {
    const int t = __shfl_up_sync(H2_FULL_MASK, v, o, G);
    if (g >= o) v = max(v, t);
  }
  const int t = __shfl_up_sync(H2_FULL_MASK, v, 1, G);
  return g == 0 ? id : t;
}

__device__ __forceinline__ int sp_excl_suffix_min(int v, int g, int G,
                                                  int id) {
  for (int o = 1; o < G; o <<= 1) {
    const int t = __shfl_down_sync(H2_FULL_MASK, v, o, G);
    if (g + o < G) v = min(v, t);
  }
  const int t = __shfl_down_sync(H2_FULL_MASK, v, 1, G);
  return g == G - 1 ? id : t;
}

__device__ __forceinline__ int sp_excl_suffix_max(int v, int g, int G,
                                                  int id) {
  for (int o = 1; o < G; o <<= 1) {
    const int t = __shfl_down_sync(H2_FULL_MASK, v, o, G);
    if (g + o < G) v = max(v, t);
  }
  const int t = __shfl_down_sync(H2_FULL_MASK, v, 1, G);
  return g == G - 1 ? id : t;
}

// The lane's inputs in device memory.
struct SpLane {
  const int* ch;     // [C][W] windows of where(valid, start, -1)
  const int* s1;     // [C][W] SNV-plane windows, or nullptr
  const int* s2;
  const int* rd;     // [L]
  const int* qs;     // [L]
  const int* mm_pen; // [64]
  int len, n_pen, minsc;
  long long n_text;
};

// One column's penalties (pen_planes): the penalty (SNVs not forgiven),
// the SNV-forgiving penalty (u1 / u2 the SNV windows, or nullptr) and
// whether the read base mismatches the reference.
struct SpPen {
  int pen, pf, mm;
};

__device__ __forceinline__ SpPen sp_pen(const SpPlanes& s, const SpLane& in,
                                        const uint8_t* w, const uint8_t* u1,
                                        const uint8_t* u2, long long st,
                                        int col) {
  const bool vp = col < in.len;
  const long long pos = st + col;
  const bool oob = vp && (pos < 0 || pos >= in.n_text);
  const int rc = min((int)w[col], 3);
  const int r = s.rd[col];
  const bool isn = vp && r >= 4;
  const bool mm_raw = vp && r < 4 && r != rc && !oob;
  const int mmq = mm_raw ? s.mq[col] : 0;
  const int base = (isn ? in.n_pen : 0) + (oob ? H2_OOB_PEN : 0);
  int pf = 0;
  if (u1) {
    const int v1 = u1[col], v2 = u2[col];
    const bool snp_ok = mm_raw && ((v1 != 0 && r == ((rc + v1) & 3)) ||
                                   (v2 != 0 && r == ((rc + v2) & 3)));
    pf = (snp_ok ? 0 : mmq) + base;
  }
  return SpPen{mmq + base, pf, mm_raw ? 1 : 0};
}

// Build every plane of one lane's C diagonals, cooperatively over the
// block (its tables from sp_tables; the budget bits when s.Pr is set,
// the SNV-forgiving prefix when s.Pi has its own room).  Ends with
// __syncthreads().
__device__ inline void sp_build(const SpPlanes& s, const SpLane& in, int C,
                                int L, int W, int M) {
  const int X1 = L + 1, XS = s.XS, XSh = s.XSh, XSb = s.XSb;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  const bool snv = s.v1 != nullptr;
  const bool budget = s.Pr != nullptr;
  // 1. stage
  sp_stage_bytes(s.w, in.ch, C * W, 4u);
  if (snv) {
    sp_stage_bytes(s.v1, in.s1, C * W, 3u);
    sp_stage_bytes(s.v2, in.s2, C * W, 3u);
  }
  for (int col = threadIdx.x; col < L; col += blockDim.x) {
    s.rd[col] = (uint8_t)min((unsigned)__ldg(in.rd + col), 4u);
    s.mq[col] = __ldg(in.mm_pen + min(__ldg(in.qs + col), 63));
  }
  __syncthreads();
  // 2. masks, then this warp's PWM products: cells [lo, hi) (k = c * X1
  // + x), SP_PIECE cells at a time, each piece's queue at P-plane entries
  // [2 plo, 2 phi) (9-factor items from the front, 15-factor ones from the
  // back; an item is 2 (k - plo) + side, which a uint16 holds)
  {
    const int ncell = C * X1;
    const int lo = (int)((long long)wid * ncell / nwarp);
    const int hi = (int)((long long)(wid + 1) * ncell / nwarp);
    const unsigned lt = (1u << lane) - 1;
    for (int plo = lo; plo < hi; plo += SP_PIECE) {
      const int phi = min(plo + SP_PIECE, hi);
      uint16_t* q = (uint16_t*)s.P + 2 * (size_t)plo;
      const int qcap = 2 * (phi - plo);
      int n9 = 0, n15 = 0;
      int c = (plo + lane) / X1, x = (plo + lane) - c * X1;  // cell plo + lane
      for (int k0 = plo; k0 < phi; k0 += 32) {
        const int k = k0 + lane;
        unsigned need9 = 0, need15 = 0;
        if (k < phi) {
          const uint8_t* w = s.w + c * W + M + x;
          const unsigned dm = s.mtab[w[0] * 5 + w[1]];
          const unsigned am = s.mtab[25 + w[-2] * 5 + w[-1]];
          s.dk[c * XSb + x] = (uint8_t)dm;
          s.ak[c * XSb + x] = (uint8_t)am;
          s.dpw[c * XS + x] = 0.0f;
          s.apw[c * XS + x] = 0.0f;
          // donor side: GT -> forward donor (9), CT -> reverse acceptor
          // (15); acceptor side: AG -> forward acceptor (15), AC ->
          // reverse donor (9)
          need9 = (dm & SP_CFW) | (am & SP_CRC);
          need15 = ((dm & SP_CRC) >> 1) | ((am & SP_CFW) << 1);
        }
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const bool a = (need9 >> side) & 1u, b = (need15 >> side) & 1u;
          const unsigned ma = __ballot_sync(H2_FULL_MASK, a);
          const unsigned mb = __ballot_sync(H2_FULL_MASK, b);
          const int item = 2 * (k - plo) + side;
          if (a) q[n9 + __popc(ma & lt)] = (uint16_t)item;
          if (b) q[qcap - 1 - (n15 + __popc(mb & lt))] = (uint16_t)item;
          n9 += __popc(ma);
          n15 += __popc(mb);
        }
        for (x += 32; x >= X1; x -= X1) ++c;
      }
      __syncwarp();
      for (int t = lane; t < n9 + n15; t += 32) {
        const int it = t < n9 ? q[t] : q[qcap - 1 - (t - n9)];
        const int k = plo + (it >> 1), side = it & 1;
        const int ck = k / X1, xk = k - ck * X1;
        const uint8_t* w = s.w + ck * W + M + xk;
        if (side == 0)
          s.dpw[ck * XS + xk] = (s.dk[ck * XSb + xk] & SP_CFW)
              ? sp_pwm<9>(w - 3, s.ftab + SP_DFW)
              : sp_pwm<15>(w - 1, s.ftab + SP_ARC);
        else
          s.apw[ck * XS + xk] = (s.ak[ck * XSb + xk] & SP_CFW)
              ? sp_pwm<15>(w - 14, s.ftab + SP_AFW)
              : sp_pwm<9>(w - 6, s.ftab + SP_DRC);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  // 3. each column's penalties, one cell per thread, in the planes they
  // are the prefix of (the penalty at P[col + 1], the SNV-forgiving one at
  // Pi[col + 1], the raw mismatch at Pm[col + 1])
  for (int k = threadIdx.x, c = k / L, col = k - c * L; k < C * L;
       k += blockDim.x) {
    const long long st = s.valid[c] ? (long long)s.start[c] : -1LL;
    const SpPen q = sp_pen(s, in, s.w + c * W + M,
                           snv ? s.v1 + c * W + M : nullptr,
                           snv ? s.v2 + c * W + M : nullptr, st, col);
    s.P[c * XS + col + 1] = q.pen;
    if (snv) s.Pi[c * XS + col + 1] = q.pf;
    s.Pm[c * XSh + col + 1] = (int16_t)q.mm;
    for (col += blockDim.x; col >= L; col -= L) ++c;
  }
  __syncthreads();
  // 4. prefixes and budget bits, a group of G lanes per diagonal (all C
  // diagonals at once up to 32), lane g of a group on the columns
  // [g * run, (g + 1) * run): the run's totals, the group's exclusive
  // scans of them, then the prefixes in place
  const int G = L <= 256 ? 8 : 16, g = lane & (G - 1);
  const int run = (L + G - 1) / G;
  for (int cg = wid * (32 / G); cg < C; cg += nwarp * (32 / G)) {
    const int c = cg + lane / G;
    const bool act = c < C;
    const int c0 = act ? min(g * run, L) : 0, c1 = act ? min(c0 + run, L) : 0;
    const int cr = act ? c : 0;
    int* P = s.P + cr * XS;
    int* Pf = s.Pi + cr * XS;
    int16_t* Pm = s.Pm + cr * XSh;
    int16_t* Pr = budget ? s.Pr + cr * XSh : nullptr;
    int tp = 0, tf = 0, tm = 0, tr = 0, tl = -1, tn = L;
    for (int col = c0; col < c1; ++col) {
      const int pen = P[col + 1];
      tp += pen;
      tm += Pm[col + 1];
      if (snv) tf += Pf[col + 1];
      if (pen > 0) {
        tr += 1;
        tl = col;
        tn = min(tn, col);
      }
    }
    int ps = sp_excl_sum(tp, g, G), pm = sp_excl_sum(tm, g, G);
    int pf = snv ? sp_excl_sum(tf, g, G) : 0;
    int pr = budget ? sp_excl_sum(tr, g, G) : 0;
    // the last penalized column before the run, the next one after it
    int last = budget ? sp_excl_max(tl, g, G, -1) : -1;
    const int nxt = budget ? sp_excl_suffix_min(tn, g, G, L) : L;
    unsigned pmask = 0;  // the penalized columns of the run's first word
    for (int col = c0; col < c1; ++col) {
      const int pen = P[col + 1];
      ps += pen;
      P[col + 1] = ps;
      pm += Pm[col + 1];
      Pm[col + 1] = (int16_t)pm;
      if (snv) {
        pf += Pf[col + 1];
        Pf[col + 1] = pf;
      }
      if (budget) {
        pr += pen > 0 ? 1 : 0;
        Pr[col + 1] = (int16_t)pr;
      }
      if (pen > 0 && col - c0 < 32) pmask |= 1u << (col - c0);
    }
    if (act && g == 0) {
      P[0] = 0;
      Pf[0] = 0;
      Pm[0] = 0;
      if (budget) Pr[0] = 0;
    }
    if (!budget) continue;
    __syncwarp();
    // qualifying columns: clean, in a run of >= 8 clean columns
    // (minK_local) between the last penalized column before and the next
    // one at or after; br[x] is the largest tot - P at a qualifying
    // column >= x, bl[x] the largest P at a qualifying column < x; the
    // donor side at x passes when P[x] - bl[x] <= -minsc, the acceptor
    // side when (tot - P[x]) - br[x] <= -minsc.  The run goes 32 columns
    // (a word) at a time; past a word's last penalized column the next
    // one is found by a scan of the Pr steps that never revisits a column
    const int tot = act ? P[L] : 0;
    uint8_t* dk = s.dk + cr * XSb;
    uint8_t* ak = s.ak + cr * XSb;
    int tb = 0, tq = 0, np = c0 - 1;
    for (int w0 = c0; w0 < c1; w0 += 32) {
      const int w1 = min(w0 + 32, c1);
      unsigned pw = pmask;
      if (w0 != c0) {
        pw = 0;
        for (int col = w0; col < w1; ++col)
          if (Pr[col + 1] != Pr[col]) pw |= 1u << (col - w0);
      }
      for (int col = w0; col < w1; ++col) {
        const unsigned bit = 1u << (col - w0);
        if (pw & bit) {
          last = col;
          continue;
        }
        // the next penalized column: in the word's mask, else after it
        const unsigned after = pw & ~((bit << 1) - 1);
        int nc;
        if (after) {
          nc = w0 + __ffs(after) - 1;
        } else {
          if (np < w1) {
            np = w1;
            while (np < c1 && Pr[np + 1] == Pr[np]) ++np;
          }
          nc = np < c1 ? np : nxt;
        }
        if (nc - (last + 1) >= 8) {
          ak[col] |= SP_Q;
          tb = max(tb, tot - P[col]);
          tq = max(tq, P[col]);
        }
      }
    }
    int m = sp_excl_suffix_max(tb, g, G, 0);
    if (act && g == 0 && (tot - P[L]) - 0 <= -in.minsc) ak[L] |= SP_OK;
    for (int col = c1 - 1; col >= c0; --col) {
      if (ak[col] & SP_Q) m = max(m, tot - P[col]);
      if ((tot - P[col]) - m <= -in.minsc) ak[col] |= SP_OK;
    }
    m = sp_excl_max(tq, g, G, 0);
    if (act && g == 0 && P[0] - 0 <= -in.minsc) dk[0] |= SP_OK;
    for (int col = c0; col < c1; ++col) {
      const unsigned a = ak[col];
      if (a & SP_Q) {
        m = max(m, P[col]);
        ak[col] = (uint8_t)(a & ~SP_Q);
      }
      if (P[col + 1] - m <= -in.minsc) dk[col + 1] |= SP_OK;
    }
  }
  __syncthreads();
}

// The PWM probability of a canonical junction, 1 / (1 + donor-side *
// acceptor-side product) (the forward product is dfw * afw, the reverse
// one drc * arc: one rounded product either way, and an f32 product does
// not depend on its operands' order).
__device__ __forceinline__ float sp_splsc(float dp, float ap) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(dp, ap)));
}

__device__ __forceinline__ float sp_pth(int D) {
  return D >= (1 << 16) ? 0.99f : D >= (1 << 15) ? 0.97f
       : D >= (1 << 14) ? 0.94f : D >= (1 << 13) ? 0.91f
       : D >= (1 << 12) ? 0.88f : 0.8f;
}

__device__ __forceinline__ int sp_max_intron_len(int anchor, int min_anchor) {
  const int a = max(anchor, 2);
  const int sh = min(max((a << 1) - 4, 13), 30);
  return anchor >= min_anchor ? (1 << sh) : 0;
}

__device__ __forceinline__ int sp_max_intron_len_noncan(int anchor,
                                                        int min_anchor) {
  const int a = max(anchor, 5);
  const int sh = min((a << 1) - 10, 30);
  return anchor >= min_anchor ? (1 << sh) : 0;
}

// intronLen_prob (cut 14, add 4) / _noncan (cut 16, add 0); a shift
// outside [0, 32) gives 0, as XLA's
__device__ __forceinline__ float sp_intron_len_prob(int anchor, int D,
                                                    int max_intron, int cut,
                                                    int add) {
  const int sh = min((anchor << 1) + add, 30);
  const int p2 = sh >= 0 ? (1 << sh) : 0;
  int e = anchor < cut ? p2 : max_intron;
  e = min(e, max_intron);
  const float q = __fdiv_rn(__int2float_rn(D), __int2float_rn(e));
  return q > 1.0f ? 1.0f : q;  // NaN stays NaN, as jnp.minimum
}

// the intron-length penalty from its step table (ops/splice.py:
// lenpen_table) in shared memory: brk/val of n entries
__device__ __forceinline__ int sp_lenpen(const int* brk, const int* val,
                                         int n, int D) {
  int i = -1;
  for (int t = 0; t < n; ++t)
    if (brk[t] <= D) i = t;
  return val[max(i, 0)];
}
