// Kernel 4: single-anchor small-gap (indel) sweep (K8).
//
// Replaces hisat2_tpu/ops/splice.py:self_indel_sweep (:952-1104), with
// its SNV windows (:998-1002).  Plain twin:
// hisat2_tpu_torch/ops/splice.py:self_indel_sweep_plain.
//
// For each candidate, every split point x and every gap g = 1..G of four
// kinds (deletion or insertion, the candidate holding the left or the
// right segment) is scored from the penalty prefix P_delta and the raw
// mismatch prefix R_delta of the read against the window shifted by
// delta in {-g, 0, +g}, packed into one key ((min(pen, PCAP-1) * 64 +
// min(raw, 63)) * 64 + cid), and the (key, x) minimum is kept for the
// strict (>= min_anchor flanks) and the wide rows, decoded as in
// splice.py:1085-1100.
//
// Design (Hopper):
// - A dead candidate's row depends on its start alone (JAX's `pack` with
//   ok false: score -2^30, d1 = d2 = start, x = 0, kind 0), so it is
//   written and nothing else is done for it.  Most candidates are dead.
// - A block of up to 4 warps takes 32 consecutive candidates; one ballot
//   over their `valid` bytes lists the live ones, and warp w sweeps the
//   live candidates w, w + 4, ... alone.  No block barrier.  The read is
//   staged per live candidate, not per lane: most lanes hold at most one
//   live candidate (PERF.md, the K8 split).
// - Each warp stages its candidate's window (and on a graph index, per
//   window column, the read bases a catalog SNV forgives) and the read's
//   bases and mismatch penalties in its own shared memory, keeps P0/R0
//   resident, and for each g builds P-g/R-g and P+g/R+g (warp scans over
//   32-column chunks), folds the four combos of that g for the split
//   points it owns (x = lane, lane + 32, ...) into a running (key, x)
//   minimum per set, and drops them.  Shared memory is O(L) per warp and
//   does not grow with G.
// - Every read length: where one warp's buffers do not fit the shared
//   memory a block may use (L above ~5,800), each warp stages in its own
//   slice of a global scratch that the wrapper allocates
//   (h2_indel_sweep_scratch), and a grid of as many blocks as the card
//   holds at once walks the candidate pools (common.cuh: h2_staging).
// - 32-bit arithmetic that reproduces JAX's int32: prefixes, penalty sums
//   and the packed key are computed in uint32 (wrapping, as XLA's int32
//   does; signed overflow is undefined in CUDA C++) and compared as int32.
//   From G = 17 on, cid reaches 64: a saturated key then wraps negative
//   and JAX emits a +524288 row, and a cid >= 64 carries into the raw
//   field, so `val & 63` decodes another combo; both are reproduced.
//   The first-index argmin is the lexicographic (key, x) minimum.
//
// Bound (chip_smoke.py:work): the windows of live candidates, each lane's
// read and quals and the ten output planes, and ~8 integer operations for
// each of the 4G combos at each split point of a live candidate.  The
// kernel is latency-bound instead: a live candidate is one warp's chain
// of 2G+1 chunked scans and G folds, overlapped only across warps.
#include "common.cuh"

#define SW_MAX_WARPS 4
#define SW_POOL 32
#define SW_PCAP (1 << 19)
#define SW_BIG (1 << 30)
#define SW_KEY_NONE 0x7FFFFFFF

// ints of one warp's shared memory: the window, the read's bases and
// mismatch penalties, six prefixes of L+1 (P0 R0 P-g R-g P+g R+g) and, with
// SNV windows, one byte per window column
__host__ __device__ inline int sw_warp_ints(int L, int W, bool snv) {
  return W + 2 * L + 6 * (L + 1) + (snv ? (W + 3) / 4 : 0);
}

struct SwArgs {
  const int* win;
  const int* reads;
  const int* quals;
  const int* lens;
  const int* starts;
  const uint8_t* valid;
  const int* minsc;
  const int* mm_pen;
  const int* snv1;  // [NC, W] SNV-plane windows (SNV kernel only)
  const int* snv2;
  long long NC;
  int C, L, W, M, G, n_pen, min_anchor;
  int rd_open, rd_ext, rf_open, rf_ext;
  int* out;  // [10, NC]: score d1 d2 x kind | w_score w_d1 w_d2 w_x w_kind
};

__device__ __forceinline__ unsigned sw_scan(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(H2_FULL_MASK, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// JAX's packed key in int32 arithmetic
__device__ __forceinline__ int sw_key(unsigned pen, unsigned raw,
                                      unsigned cid) {
  const int p = min((int)pen, SW_PCAP - 1), r = min((int)raw, 63);
  return (int)(((unsigned)p * 64u + (unsigned)r) * 64u + cid);
}

// (key, x) lexicographic minimum
__device__ __forceinline__ void sw_min(int& bk, int& bx, int k, int x) {
  if (k < bk || (k == bk && x < bx)) {
    bk = k;
    bx = x;
  }
}

struct SwWarp {
  const int* ch;
  const int* rd;
  const int* mq;
  const uint8_t* fz;  // read bases a catalog SNV forgives (SNV only)
  int len, n_pen;
};

// penalty and raw mismatch of read base r (quality penalty mq) of a
// column below len against window column m (splice.py:1035-1046)
template <bool SNV>
__device__ __forceinline__ void sw_col(const SwWarp& s, int r, int mq, int m,
                                       unsigned& pen, unsigned& raw) {
  const int chs = s.ch[m];
  bool mm = r < 4 && chs < 4 && r != chs;
  raw = mm;
  if (SNV && mm && r >= 0 && ((s.fz[m] >> r) & 1)) mm = false;
  pen = (mm ? (unsigned)mq : 0u) + (r >= 4 ? (unsigned)s.n_pen : 0u) +
        (chs > 3 ? 100000u : 0u);
}

// P[0..len], R[0..len] of the shift starting at window column ma (and, if
// TWO, of the one at mb); past len a prefix stays at its total, so
// readers clamp their index to len
template <bool SNV, bool TWO>
__device__ void sw_build(const SwWarp& s, int lane, int ma, int* Pa,
                         int* Ra, int mb, int* Pb, int* Rb) {
  unsigned ca = 0, cra = 0, cb = 0, crb = 0;
  for (int b = 0; b < s.len; b += 32) {
    const int c = b + lane;
    unsigned pa = 0, ra = 0, pb = 0, rb = 0;
    if (c < s.len) {
      const int r = s.rd[c], mq = s.mq[c];
      sw_col<SNV>(s, r, mq, ma + c, pa, ra);
      if (TWO) sw_col<SNV>(s, r, mq, mb + c, pb, rb);
    }
    pa = sw_scan(pa, lane);
    ra = sw_scan(ra, lane);
    if (TWO) {
      pb = sw_scan(pb, lane);
      rb = sw_scan(rb, lane);
    }
    if (c < s.len) {
      Pa[c + 1] = (int)(ca + pa);
      Ra[c + 1] = (int)(cra + ra);
      if (TWO) {
        Pb[c + 1] = (int)(cb + pb);
        Rb[c + 1] = (int)(crb + rb);
      }
    }
    ca += __shfl_sync(H2_FULL_MASK, pa, 31);
    cra += __shfl_sync(H2_FULL_MASK, ra, 31);
    if (TWO) {
      cb += __shfl_sync(H2_FULL_MASK, pb, 31);
      crb += __shfl_sync(H2_FULL_MASK, rb, 31);
    }
  }
  if (lane == 0) {
    Pa[0] = Ra[0] = 0;
    if (TWO) Pb[0] = Rb[0] = 0;
  }
}

// one set's row of a candidate from its (key, x) minimum (splice.py:
// 1085-1100); a dead candidate (live false) gets the constant row
__device__ __forceinline__ void sw_write(const SwArgs& A, long long cand,
                                         int which, int val, int am,
                                         bool live) {
  const int NCOMBO = 4 * A.G;
  int cid = min(val & 63, NCOMBO);
  const int score = -(val >> 12);
  const bool ok = live && score >= A.minsc[cand / A.C] &&
                  val < (SW_PCAP - 1) * 4096;
  cid = ok ? cid : NCOMBO;
  int o1 = 0, o2 = 0, kind = 0;
  if (cid < NCOMBO) {
    const int g = cid / 4 + 1, k = cid & 3;
    o1 = k == 0 ? -g : (k == 2 ? g : 0);
    o2 = k == 1 ? g : (k == 3 ? -g : 0);
    kind = k < 2 ? 2 : 3;  // KIND_DEL, KIND_INS
  }
  const unsigned st = (unsigned)A.starts[cand];
  int* out = A.out + (size_t)which * 5 * A.NC + cand;
  out[0] = ok ? score : -SW_BIG;
  out[A.NC] = (int)(st + (unsigned)o1);
  out[2 * A.NC] = (int)(st + (unsigned)o2);
  out[3 * A.NC] = ok ? am : 0;
  out[4 * A.NC] = ok ? kind : 0;
}

template <bool SNV>
__device__ void sw_sweep(const SwArgs& A, long long cand, int* ws,
                         int lane) {
  const int L = A.L, W = A.W, M = A.M, G = A.G;
  int* sCh = ws;
  int* sRd = sCh + W;
  int* sMq = sRd + L;
  int* P0 = sMq + L;
  int* R0 = P0 + (L + 1);
  int* Pm = R0 + (L + 1);
  int* Rm = Pm + (L + 1);
  int* Pp = Rm + (L + 1);
  int* Rp = Pp + (L + 1);
  uint8_t* sFz = (uint8_t*)(Rp + (L + 1));
  const long long n = cand / A.C;
  const int len = min(max(A.lens[n], 0), L);
  // the window columns any shift reads: [M - G, M + G + len)
  const int* win = A.win + cand * W;
  for (int m = M - G + lane; m < M + G + len; m += 32) {
    const int c = win[m];
    sCh[m] = c;
    if (SNV) {
      const int v1 = A.snv1[cand * W + m], v2 = A.snv2[cand * W + m];
      sFz[m] = (uint8_t)((v1 != 0 ? 1u << (((unsigned)c + v1) & 3u) : 0u) |
                         (v2 != 0 ? 1u << (((unsigned)c + v2) & 3u) : 0u));
    }
  }
  for (int c = lane; c < len; c += 32) {
    sRd[c] = A.reads[n * L + c];
    sMq[c] = A.mm_pen[min(A.quals[n * L + c], 63)];
  }
  __syncwarp();
  const SwWarp s{sCh, sRd, sMq, sFz, len, A.n_pen};
  sw_build<SNV, false>(s, lane, M, P0, R0, 0, nullptr, nullptr);
  __syncwarp();
  const unsigned T0 = P0[len], TR0 = R0[len];
  const int An = A.min_anchor;
  // split points where some combo can pass: x >= min(1, A), and
  // x <= max(len - 1, len - A)
  const int xlo = max(0, min(1, An)), xhi = min(L, max(len - 1, len - An));
  int bs = SW_KEY_NONE, bxs = 0, bw = SW_KEY_NONE, bxw = 0;
  for (int g = 1; g <= G; ++g) {
    sw_build<SNV, true>(s, lane, M - g, Pm, Rm, M + g, Pp, Rp);
    __syncwarp();
    const unsigned Tm = Pm[len], Tp = Pp[len], TRm = Rm[len], TRp = Rp[len];
    const unsigned cdel = (unsigned)A.rd_open + (unsigned)A.rd_ext * g;
    const unsigned cins = (unsigned)A.rf_open + (unsigned)A.rf_ext * g;
    const unsigned cid = 4u * (g - 1);
    for (int x = xlo + lane; x <= xhi; x += 32) {
      const int xi = min(x, len), xg = min(x + g, len);
      const unsigned p0 = P0[xi], r0 = R0[xi], p0g = P0[xg], r0g = R0[xg];
      const unsigned pm = Pm[xi], rm = Rm[xi], pmg = Pm[xg], rmg = Rm[xg];
      const unsigned pp = Pp[xi], rp = Rp[xi];
      // deletion, the candidate holds the right / the left segment
      const int kd = min(sw_key(pm + (T0 - p0) + cdel, rm + (TR0 - r0), cid),
                         sw_key(p0 + (Tp - pp) + cdel, r0 + (TRp - rp),
                                cid + 1));
      // insertion, the candidate holds the right / the left segment
      const int ki =
          min(sw_key(pp + (T0 - p0g) + cins, rp + (TR0 - r0g), cid + 2),
              sw_key(p0 + (Tm - pmg) + cins, r0 + (TRm - rmg), cid + 3));
      const bool okw_d = x >= 1 && x <= len - 1;
      const bool okw_i = x >= 1 && x + g <= len - 1;
      const bool oks_d = x >= An && x <= len - An;
      const bool oks_i = x >= An && x + g <= len - An;
      sw_min(bs, bxs,
             min(oks_d ? kd : SW_KEY_NONE, oks_i ? ki : SW_KEY_NONE), x);
      sw_min(bw, bxw,
             min(okw_d ? kd : SW_KEY_NONE, okw_i ? ki : SW_KEY_NONE), x);
    }
    __syncwarp();
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sw_min(bs, bxs, __shfl_xor_sync(H2_FULL_MASK, bs, o),
           __shfl_xor_sync(H2_FULL_MASK, bxs, o));
    sw_min(bw, bxw, __shfl_xor_sync(H2_FULL_MASK, bw, o),
           __shfl_xor_sync(H2_FULL_MASK, bxw, o));
  }
  if (lane < 2)
    sw_write(A, cand, lane, lane ? bw : bs, lane ? bxw : bxs, true);
  __syncwarp();
}

// GLOBAL: each warp stages in its slice of `scratch` (h2_slice of its
// sw_warp_ints ints, at block * warps + warp), not in shared memory (a separate
// instantiation, so that the shared one keeps its shared-memory
// accesses); blocks walk the pools of 32 candidates with a grid stride
template <bool SNV, bool GLOBAL>
__global__ void __launch_bounds__(32 * SW_MAX_WARPS)
    indel_sweep_kernel(SwArgs A, int* scratch) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const size_t per = sw_warp_ints(A.L, A.W, SNV);
  int* ws = GLOBAL ? scratch + ((size_t)blockIdx.x * nw + wid) *
                                   (h2_slice(per * sizeof(int)) / sizeof(int))
                   : smem + (size_t)wid * per;
  const long long pools = (A.NC + SW_POOL - 1) / SW_POOL;
  for (long long pool = blockIdx.x; pool < pools; pool += gridDim.x) {
    const long long c0 = pool * SW_POOL;
    const long long me = c0 + lane;
    const bool in = me < A.NC;
    const bool live = in && A.valid[me] != 0;
    unsigned m = __ballot_sync(H2_FULL_MASK, live);
    if (wid == 0 && in && !live) {
      sw_write(A, me, 0, SW_KEY_NONE, 0, false);
      sw_write(A, me, 1, SW_KEY_NONE, 0, false);
    }
    for (int i = 0; i < wid; ++i) m &= m - 1;
    while (m) {
      sw_sweep<SNV>(A, c0 + __ffs(m) - 1, ws, lane);
      for (int i = 0; i < nw; ++i) m &= m - 1;
    }
  }
}

typedef void (*SwKernel)(SwArgs, int*);
static SwKernel sw_pick(bool snv, bool global) {
  return snv ? (global ? indel_sweep_kernel<true, true>
                       : indel_sweep_kernel<true, false>)
             : (global ? indel_sweep_kernel<false, true>
                       : indel_sweep_kernel<false, false>);
}

// warps per block (as many as fit, up to 4) and their dynamic shared
// bytes, else (h2_staging) SW_MAX_WARPS warps without shared memory, each
// staging in its slice of a scratch of `have` bytes
static cudaError_t sw_config(int L, int W, bool snv, long long NC,
                             size_t have, int* warps, size_t* smem,
                             H2Staging* st) {
  const size_t per = (size_t)sw_warp_ints(L, W, snv) * sizeof(int);
  const long long pools = (NC + SW_POOL - 1) / SW_POOL;
  cudaError_t e = h2_staging(sw_pick(snv, false), sw_pick(snv, true),
                             32 * SW_MAX_WARPS, SW_MAX_WARPS, per, pools,
                             have, st);
  if (e != cudaSuccess) return e;
  *warps = st->global ? SW_MAX_WARPS
                      : (int)min((size_t)SW_MAX_WARPS, st->room / per);
  *smem = st->global ? 0 : per * *warps;
  return cudaSuccess;
}

static bool sw_shape_ok(int L, int W, int G) {
  return L >= 1 && W >= L && (W - L) % 2 == 0 && G >= 0 && G <= (W - L) / 2;
}

// The global scratch h2_indel_sweep needs for NC candidates at these
// shapes (0: none).
H2_EXPORT int h2_indel_sweep_scratch(int L, int W, int G, int use_snv,
                                     long long NC, long long* bytes) {
  if (!sw_shape_ok(L, W, G)) return (int)cudaErrorInvalidValue;
  int warps = 0;
  size_t smem = 0;
  H2Staging st;
  cudaError_t e =
      sw_config(L, W, use_snv != 0, NC, SIZE_MAX, &warps, &smem, &st);
  *bytes = (long long)st.scratch;
  return (int)e;
}

H2_EXPORT int h2_indel_sweep(
    const void* win, const void* reads, const void* quals, const void* lens,
    const void* starts, const void* valid, const void* minsc,
    const void* mm_pen, long long NC, int C, int L, int W, int G, int n_pen,
    int min_anchor, int rd_open, int rd_ext, int rf_open, int rf_ext,
    void* out, const void* snv1, const void* snv2, int use_snv,
    void* scratch, long long scratch_bytes, void* stream) {
  if (!sw_shape_ok(L, W, G)) return (int)cudaErrorInvalidValue;
  SwArgs A{(const int*)win, (const int*)reads, (const int*)quals,
           (const int*)lens, (const int*)starts, (const uint8_t*)valid,
           (const int*)minsc, (const int*)mm_pen, (const int*)snv1,
           (const int*)snv2, NC, C, L, W, (W - L) / 2, G, n_pen, min_anchor,
           rd_open, rd_ext, rf_open, rf_ext, (int*)out};
  int warps = 0;
  size_t smem = 0;
  H2Staging st;
  cudaError_t e =
      sw_config(L, W, use_snv != 0, NC, scratch ? (size_t)scratch_bytes : 0,
                &warps, &smem, &st);
  if (e != cudaSuccess) return (int)e;
  const long long grid = st.grid;
  auto kern = sw_pick(use_snv != 0, st.global);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (grid > 0)
    kern<<<(unsigned)grid, 32 * warps, smem, (cudaStream_t)stream>>>(
        A, (int*)scratch);
  return (int)cudaGetLastError();
}

// The launch at this shape, from the CUDA runtime: out = {registers per
// thread, static shared bytes, dynamic shared bytes, threads per block,
// blocks per SM}.
H2_EXPORT int h2_indel_sweep_info(int L, int W, int G, int use_snv,
                                  int* out) {
  if (!sw_shape_ok(L, W, G)) return (int)cudaErrorInvalidValue;
  int warps = 0;
  size_t smem = 0;
  H2Staging st;
  cudaError_t e =
      sw_config(L, W, use_snv != 0, 1, SIZE_MAX, &warps, &smem, &st);
  if (e != cudaSuccess) return (int)e;
  auto kern = sw_pick(use_snv != 0, st.global);
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, 32 * warps,
                                                    smem);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = 32 * warps;
  out[4] = blocks;
  return (int)e;
}
