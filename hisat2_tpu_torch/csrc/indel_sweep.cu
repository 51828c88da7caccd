// Kernel 4: single-anchor small-gap (indel) sweep (K8).
//
// Replaces hisat2_tpu/ops/splice.py:self_indel_sweep (:952-1104), with
// its SNV windows (:998-1002).  Plain twin:
// hisat2_tpu_torch/ops/splice.py:self_indel_sweep_plain.
//
// One block per (lane, candidate).  The candidate's window (and on a graph
// index its two SNV-plane windows: a mismatch that matches a catalog SNV
// allele costs nothing, but still counts as a raw mismatch), the read, its
// per-column mismatch penalties and N penalties go to shared memory; the
// block's warps then build, for every shift delta in [-G, G], the penalty
// prefix P_delta and the raw-mismatch prefix R_delta over x = 0..L (warp
// scans, one warp per shift).  Each thread then owns split points x and
// folds the 4 gap combos of every g = 1..G into two running minima of the
// packed key ((min(pen, PCAP-1) << 6 | min(raw, 63)) << 6 | combo), for
// the strict (>= min_anchor flanks) and the wide rows.  A block-wide
// (key, x) minimum gives the first-index argmin, decoded as in
// splice.py:1085-1100.  Gap-path penalties are summed in int64 and
// clamped before packing, so no signed int32 overflow can occur (the
// packed key itself stays below 2^31 by the PCAP clamp).
//
// The SNV branch is a template parameter: on a linear index the block
// stages one window and runs the mismatch test alone, as before it.
//
// Bound: (2G+1) * (L+1) prefix entries per candidate in shared memory and
// 4G combos per split point; at G = 5, L = 100 this is ~2k int ops per
// split point, issue-bound.
#include "common.cuh"

#define SW_THREADS 128
#define SW_PCAP (1 << 19)
#define SW_BIG (1 << 30)
#define SW_MAX_L 1024

// int offset of the 8-byte aligned reduction scratch in shared memory
// (nwin windows of W: 1, or 3 with the SNV planes)
__host__ __device__ inline size_t sw_red_offset(int L, int W, int G,
                                                int nwin) {
  const size_t ints = nwin * (size_t)W + 3 * (size_t)L +
                      2 * (size_t)(2 * G + 1) * (L + 1);
  return (ints + 1) & ~(size_t)1;
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

template <bool SNV>
__global__ void indel_sweep_kernel(SwArgs A) {
  extern __shared__ int smem[];
  const long long cand = blockIdx.x;
  if (cand >= A.NC) return;
  const int L = A.L, W = A.W, M = A.M, G = A.G;
  const int ND = 2 * G + 1;
  int* sCh = smem;          // [W]
  int* sS1 = sCh + W;       // [W] (SNV only)
  int* sS2 = sS1 + W;       // [W] (SNV only)
  int* sRd = SNV ? sS2 + W : sCh + W;  // [L]
  int* sMmq = sRd + L;      // [L] mismatch penalty by quality
  int* sIsn = sMmq + L;     // [L] N penalty (0 outside the read)
  int* sP = sIsn + L;       // [ND, L+1]
  int* sR = sP + ND * (L + 1);
  unsigned long long* sRed =
      (unsigned long long*)(smem + sw_red_offset(L, W, G, SNV ? 3 : 1));
  const long long n = cand / A.C;
  const int len = A.lens[n];
  const int tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5, nw = blockDim.x >> 5;
  for (int m = tid; m < W; m += blockDim.x) {
    sCh[m] = A.win[cand * W + m];
    if (SNV) {
      sS1[m] = A.snv1[cand * W + m];
      sS2[m] = A.snv2[cand * W + m];
    }
  }
  for (int c = tid; c < L; c += blockDim.x) {
    const int r = A.reads[n * L + c];
    sRd[c] = r;
    sMmq[c] = A.mm_pen[min(A.quals[n * L + c], 63)];
    sIsn[c] = (c < len && r >= 4) ? A.n_pen : 0;
  }
  __syncthreads();
  // prefixes of every shift: pen and raw mismatches of chs = ch[M+delta+c]
  for (int d = wid; d < ND; d += nw) {
    const int delta = d - G;
    int* P = sP + d * (L + 1);
    int* R = sR + d * (L + 1);
    int cp = 0, cr = 0;
    for (int b = 0; b < L; b += 32) {
      const int c = b + lane;
      int pen = 0, raw = 0;
      if (c < L) {
        const int chs = sCh[M + delta + c];
        const int r = sRd[c];
        const bool vp = c < len;
        bool mm = vp && r < 4 && chs < 4 && r != chs;
        raw = mm ? 1 : 0;
        if (SNV) {
          const int v1 = sS1[M + delta + c], v2 = sS2[M + delta + c];
          if ((v1 != 0 && r == ((chs + v1) & 3)) ||
              (v2 != 0 && r == ((chs + v2) & 3)))
            mm = false;
        }
        pen = (mm ? sMmq[c] : 0) + sIsn[c] + ((vp && chs > 3) ? 100000 : 0);
      }
      const int sp = h2_warp_incl_sum(pen, lane);
      const int sr = h2_warp_incl_sum(raw, lane);
      if (c < L) {
        P[c + 1] = cp + sp;
        R[c + 1] = cr + sr;
      }
      cp += __shfl_sync(H2_FULL_MASK, sp, 31);
      cr += __shfl_sync(H2_FULL_MASK, sr, 31);
    }
    if (lane == 0) {
      P[0] = 0;
      R[0] = 0;
    }
  }
  __syncthreads();

  const long long PC1 = SW_PCAP - 1;
  const int A_ = A.min_anchor;
  const int* P0 = sP + G * (L + 1);
  const int* R0 = sR + G * (L + 1);
  const long long T0 = P0[len], TR0 = R0[len];
  unsigned long long best_s = ~0ull, best_w = ~0ull;
  for (int x = tid; x <= L; x += blockDim.x) {
    unsigned int run_s = 0x7FFFFFFFu, run_w = 0x7FFFFFFFu;
    for (int g = 1; g <= G; ++g) {
      const int* Pm = sP + (G - g) * (L + 1);
      const int* Rm = sR + (G - g) * (L + 1);
      const int* Pp = sP + (G + g) * (L + 1);
      const int* Rp = sR + (G + g) * (L + 1);
      const long long Tm = Pm[len], Tp = Pp[len];
      const long long TRm = Rm[len], TRp = Rp[len];
      const bool inr = x + g <= L;
      // P[x + g], saturating at the total past the end
      const long long sP0 = inr ? P0[x + g] : T0;
      const long long sR0 = inr ? R0[x + g] : TR0;
      const long long sPm = inr ? Pm[x + g] : Tm;
      const long long sRm = inr ? Rm[x + g] : TRm;
      const long long cdel = (long long)A.rd_open + (long long)A.rd_ext * g;
      const long long cins = (long long)A.rf_open + (long long)A.rf_ext * g;
      const bool okw_d = x >= 1 && x <= len - 1;
      const bool okw_i = x >= 1 && x + g <= len - 1;
      const bool oks_d = x >= A_ && x <= len - A_;
      const bool oks_i = x >= A_ && x + g <= len - A_;
      long long pen[4], raw[4];
      // deletion, candidate holds the RIGHT segment: left = d - g
      pen[0] = Pm[x] + (T0 - P0[x]) + cdel;
      raw[0] = Rm[x] + (TR0 - R0[x]);
      // deletion, candidate holds the LEFT segment: right = d + g
      pen[1] = P0[x] + (Tp - Pp[x]) + cdel;
      raw[1] = R0[x] + (TRp - Rp[x]);
      // insertion, candidate holds the RIGHT segment: left = d + g
      pen[2] = Pp[x] + (T0 - sP0) + cins;
      raw[2] = Rp[x] + (TR0 - sR0);
      // insertion, candidate holds the LEFT segment: right = d - g
      pen[3] = P0[x] + (Tm - sPm) + cins;
      raw[3] = R0[x] + (TRm - sRm);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long cid = 4 * (g - 1) + k;
        const long long key =
            (min(pen[k], PC1) * 64 + min(raw[k], 63ll)) * 64 + cid;
        const unsigned int v = (unsigned int)key;
        const bool s_ok = k < 2 ? oks_d : oks_i;
        const bool w_ok = k < 2 ? okw_d : okw_i;
        if (s_ok && v < run_s) run_s = v;
        if (w_ok && v < run_w) run_w = v;
      }
    }
    const unsigned long long ks = ((unsigned long long)run_s << 32) | x;
    const unsigned long long kw = ((unsigned long long)run_w << 32) | x;
    if (ks < best_s) best_s = ks;
    if (kw < best_w) best_w = kw;
  }
  // block-wide (key, x) minimum: first-index argmin of the running rows
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    best_s = min(best_s, __shfl_xor_sync(H2_FULL_MASK, best_s, o));
    best_w = min(best_w, __shfl_xor_sync(H2_FULL_MASK, best_w, o));
  }
  if (lane == 0) {
    sRed[2 * wid] = best_s;
    sRed[2 * wid + 1] = best_w;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int k = 1; k < nw; ++k) {
    best_s = min(best_s, sRed[2 * k]);
    best_w = min(best_w, sRed[2 * k + 1]);
  }
  const int NCOMBO = 4 * G;
  const int st = A.starts[cand];
  const bool valid = A.valid[cand] != 0;
  const int msc = A.minsc[n];
  for (int which = 0; which < 2; ++which) {
    const unsigned long long key = which == 0 ? best_s : best_w;
    const unsigned int val = (unsigned int)(key >> 32);
    const int am = (int)(key & 0xFFFFFFFFull);
    int cid = min((int)(val & 63u), NCOMBO);
    const int score = -(int)(val >> 12);
    const bool ok = valid && score >= msc &&
                    (long long)val < PC1 * 4096;
    cid = ok ? cid : NCOMBO;
    int o1 = 0, o2 = 0, kind = 0;
    if (cid < NCOMBO) {
      const int g = cid / 4 + 1, k = cid & 3;
      o1 = k == 0 ? -g : (k == 2 ? g : 0);
      o2 = k == 1 ? g : (k == 3 ? -g : 0);
      kind = k < 2 ? 2 : 3;  // KIND_DEL, KIND_INS
    }
    int* out = A.out + (size_t)which * 5 * A.NC;
    out[0 * A.NC + cand] = ok ? score : -SW_BIG;
    out[1 * A.NC + cand] = st + o1;
    out[2 * A.NC + cand] = st + o2;
    out[3 * A.NC + cand] = ok ? am : 0;
    out[4 * A.NC + cand] = ok ? kind : 0;
  }
}

H2_EXPORT int h2_indel_sweep(
    const void* win, const void* reads, const void* quals, const void* lens,
    const void* starts, const void* valid, const void* minsc,
    const void* mm_pen, long long NC, int C, int L, int W, int G, int n_pen,
    int min_anchor, int rd_open, int rd_ext, int rf_open, int rf_ext,
    void* out, const void* snv1, const void* snv2, int use_snv,
    void* stream) {
  if (L > SW_MAX_L || L < 1 || W < L || (W - L) % 2 || G < 0 ||
      G > (W - L) / 2)
    return (int)cudaErrorInvalidValue;
  SwArgs A{(const int*)win, (const int*)reads, (const int*)quals,
           (const int*)lens, (const int*)starts, (const uint8_t*)valid,
           (const int*)minsc, (const int*)mm_pen, (const int*)snv1,
           (const int*)snv2, NC, C, L, W, (W - L) / 2, G, n_pen, min_anchor,
           rd_open, rd_ext, rf_open, rf_ext, (int*)out};
  const size_t smem =
      sw_red_offset(L, W, G, use_snv ? 3 : 1) * sizeof(int) +
      2 * (SW_THREADS / 32) * sizeof(unsigned long long);
  auto kern = use_snv ? indel_sweep_kernel<true> : indel_sweep_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (NC > 0)
    kern<<<(unsigned)NC, SW_THREADS, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
