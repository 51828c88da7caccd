// K15: the second-junction sweep of multi-exon reads.
//
// Replaces hisat2_tpu/ops/splice.py:second_sweep (:1107) with the site
// lookups of table_searchsorted (:192, site_search.cuh).  Plain twin:
// hisat2_tpu_torch/ops/splice.py:second_sweep_ref.
//
// One block per lane; the caller launches it once per base pair (the q2_
// and r2_ pairs of align/pipeline.py:1389-1445).  The block builds the
// lane's planes (splice_planes.cuh, without the budget bases), then sweeps
// both sides in turn: right of (j0, x1), the inner diagonal j0 as donor
// and every candidate diagonal as acceptor at x > x1; left of (i0, x1),
// every diagonal as donor and i0 as acceptor at x < x1.  Per x the side's
// two site-table candidates are looked up once (readid-gated) and kept in
// shared memory; a cell (c, x) matching one is a known junction: free and
// exempt from the gates.  Each thread folds its cells into two bests by
// (classified direction and score, PWM probability, lowest flat index):
// the minsc-gated set and the ungated "u" set; a block reduction merges
// them.
//
// Bound: per lane 2 * C * (L+1) cells (about 2.8 k at C = 14, L = 100) of
// shared-memory reads and integer compares, plus 2 * 2 * (L+1) site-table
// binary searches; operations-bound, small beside K13.
#include "site_search.cuh"
#include "splice_planes.cuh"

#define SS2_BIG (1 << 30)
#define SS2_THREADS 256

struct SecondArgs {
  const int* ch;
  const int* reads;
  const int* quals;
  const int* lens;
  const int* starts;
  const uint8_t* valid;
  const int* minsc;
  const int* mm_pen;
  const float* pwm;
  const int* lp;
  const int* b_i;
  const int* b_j;
  const int* b_x;
  const int* b_score;
  const uint8_t* b_valid;
  const int* rdids;
  H2Sites st;
  int use_ss;
  long long n_text;
  int N, C, L, W, M, n_pen, LP, nlp_can, nlp_nc, min_intron, max_intron,
      pen_can, pen_noncan, min_anchor, min_anchor_noncan;
  int* out;  // [2 sides, 8, N]: score d x dir uscore ud ux udir
};

__device__ __forceinline__ int s2_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

struct S2Best {
  int k;
  float p;
  int idx;
};

__device__ __forceinline__ bool s2_better(int k, float p, int idx,
                                          const S2Best& b) {
  return k > b.k || (k == b.k && (p > b.p || (p == b.p && idx < b.idx)));
}

__device__ __forceinline__ void s2_warp_fold(S2Best& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int k2 = __shfl_xor_sync(H2_FULL_MASK, b.k, o);
    const float p2 = __shfl_xor_sync(H2_FULL_MASK, b.p, o);
    const int i2 = __shfl_xor_sync(H2_FULL_MASK, b.idx, o);
    if (s2_better(k2, p2, i2, b)) b = S2Best{k2, p2, i2};
  }
}

__global__ void second_sweep_kernel(SecondArgs A) {
  extern __shared__ __align__(16) char smem[];
  __shared__ S2Best sRed[2][SS2_THREADS / 32];
  const int n = blockIdx.x;
  const int C = A.C, L = A.L, X1 = L + 1;
  SpPlanes s;
  float* pwm_s;
  char* free_ = sp_carve(smem, C, L, false, s, &pwm_s);
  int* sStart = (int*)free_;        // [C]
  int* sK = sStart + C;             // [2][X1] site candidate value
  uint8_t* sKm = (uint8_t*)(sK + 2 * X1);  // [2][X1] candidate usable
  for (int k = threadIdx.x; k < 96; k += blockDim.x) pwm_s[k] = A.pwm[k];
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    sStart[c] = A.starts[(size_t)n * C + c];
  __syncthreads();
  const int len = A.lens[n];
  const int minsc = A.minsc[n];
  sp_build(s, pwm_s, A.ch + (size_t)n * C * A.W, A.reads + (size_t)n * L,
           A.quals + (size_t)n * L, len, A.starts + (size_t)n * C,
           A.valid + (size_t)n * C, A.n_text, A.mm_pen, A.n_pen, C, L, A.W,
           A.M);
  const uint8_t* vld = A.valid + (size_t)n * C;
  const int bx = A.b_x[n], bsc = A.b_score[n];
  const bool bval = A.b_valid[n] != 0;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int side = 0; side < 2; ++side) {   // 0 right, 1 left
    const int inner = side == 0 ? A.b_j[n] : A.b_i[n];
    const int istart = sStart[inner];
    const int* Pin = s.P + (size_t)inner * X1;
    const int* Pmin = s.Pm + (size_t)inner * X1;
    const int tot_in = Pin[L];
    const int mm_bx = (bx >= 0 && bx <= L) ? Pmin[bx] : INT_MIN;
    if (A.use_ss) {
      for (int x = threadIdx.x; x < X1; x += blockDim.x) {
        const int rd = A.rdids[n];
        const int pos = side == 0 ? s2_add(istart, x - 1) : s2_add(istart, x);
        const int* tab = side == 0 ? A.st.kd : A.st.ka_s;
        const int* oth = side == 0 ? A.st.ka : A.st.kd_s;
        const int* rdt = side == 0 ? A.st.rdid : A.st.rdid_a;
        const int* lob = side == 0 ? A.st.kd_lob : A.st.ka_lob;
        const int lo = h2_table_searchsorted(tab, A.st.S, lob, A.st.NB,
                                             A.st.shift, pos);
        for (int t = 0; t < 2; ++t) {
          const int ii = min(lo + t, A.st.S - 1);
          const int srd = __ldg(rdt + ii);
          const bool m = lo + t < A.st.S && __ldg(tab + ii) == pos &&
                         (srd < 0 || srd < rd);
          sK[t * X1 + x] = __ldg(oth + ii);
          sKm[t * X1 + x] = m ? 1 : 0;
        }
      }
    }
    __syncthreads();
    S2Best bg{-2, -2.0f, INT_MAX}, bu{-2, -2.0f, INT_MAX};
    for (int k = threadIdx.x; k < C * X1; k += blockDim.x) {
      const int c = k / X1, x = k - c * X1;
      const int* Pc = s.P + (size_t)c * X1;
      const int* Pmc = s.Pm + (size_t)c * X1;
      int score, D, dl, ar, anchor_l, anchor_r;
      float dsf, asf, dsr, asr;
      bool vx;
      if (side == 0) {
        const int pcx = Pin[x] - (bsc + tot_in);
        score = -(pcx + (Pc[L] - Pc[x]));
        dl = s.dc[(size_t)inner * X1 + x];
        ar = s.ac[k];
        dsf = s.dfw[(size_t)inner * X1 + x];
        asf = s.afw[k];
        dsr = s.drc[k];
        asr = s.arc[(size_t)inner * X1 + x];
        D = (int)((unsigned)sStart[c] - (unsigned)istart);
        vx = x > bx && x <= len - 1;
        anchor_l = (int)((unsigned)(x - bx) -
                         2u * ((unsigned)Pmin[x] - (unsigned)mm_bx));
        anchor_r = (len - x) - 2 * (Pmc[len] - Pmc[x]);
      } else {
        const int scx = -(bsc + Pin[x]);
        score = -(Pc[x] + scx);
        dl = s.dc[k];
        ar = s.ac[(size_t)inner * X1 + x];
        dsf = s.dfw[k];
        asf = s.afw[(size_t)inner * X1 + x];
        dsr = s.drc[(size_t)inner * X1 + x];
        asr = s.arc[k];
        D = (int)((unsigned)istart - (unsigned)sStart[c]);
        vx = x >= 1 && x < bx;
        anchor_l = x - 2 * Pmc[x];
        anchor_r = (int)((unsigned)(bx - x) -
                         2u * ((unsigned)mm_bx - (unsigned)Pmin[x]));
      }
      bool canonical, can_fw;
      const int dir = sp_classify(dl, ar, &canonical, &can_fw);
      const bool is_spl2 = D >= A.min_intron && D <= A.max_intron &&
                           vld[c] && bval;
      float splsc = 0.0f;
      if (canonical) {
        const float prod = can_fw ? __fmul_rn(dsf, asf) : __fmul_rn(dsr, asr);
        splsc = __fdiv_rn(1.0f, __fadd_rn(1.0f, prod));
      }
      bool known = false;
      if (A.use_ss) {
        const int tgt = side == 0 ? s2_add(sStart[c], x)
                                  : s2_add(sStart[c], x - 1);
        known = (sKm[x] && sK[x] == tgt) || (sKm[X1 + x] && sK[X1 + x] == tgt);
      }
      const int pen2 = known ? 0 : (canonical ? A.pen_can : A.pen_noncan);
      const int sc2 = score - pen2;
      const bool valid4 = vx && is_spl2;
      const int sh = max(min(anchor_l, anchor_r), 1);
      const int thresh = canonical
          ? sp_max_intron_len(sh, A.min_anchor)
          : sp_max_intron_len_noncan(sh, A.min_anchor_noncan);
      const bool gated = thresh < A.max_intron;
      const bool ok4 = valid4 &&
          (known || (!(gated && D > thresh) &&
                     !(gated && canonical && splsc < sp_pth(D))));
      int lenpen = canonical
          ? sp_lenpen(A.lp, A.lp + A.LP, A.nlp_can, D)
          : sp_lenpen(A.lp + 2 * A.LP, A.lp + 3 * A.LP, A.nlp_nc, D);
      if (known) lenpen = 0;
      const int sc2u = ok4 ? sc2 - lenpen : -SS2_BIG;
      const int sc2g = sc2u >= minsc ? sc2u : -SS2_BIG;
      const int hd = dir != 0 ? 1 : 0;
      const int ku = sc2u > -SS2_BIG / 2
          ? (hd << 23) + max(sc2u, -(1 << 21)) + (1 << 21) : -1;
      const int kg = sc2g > -SS2_BIG / 2
          ? (hd << 23) + max(sc2g, -(1 << 21)) + (1 << 21) : -1;
      if (s2_better(kg, splsc, k, bg)) bg = S2Best{kg, splsc, k};
      if (s2_better(ku, splsc, k, bu)) bu = S2Best{ku, splsc, k};
    }
    s2_warp_fold(bg);
    s2_warp_fold(bu);
    if (lane == 0) {
      sRed[0][wid] = bg;
      sRed[1][wid] = bu;
    }
    __syncthreads();
    if (wid == 0) {
      const int nw = blockDim.x >> 5;
      for (int set = 0; set < 2; ++set) {
        S2Best b = lane < nw ? sRed[set][lane] : S2Best{-2, -2.0f, INT_MAX};
        s2_warp_fold(b);
        if (lane == 0) {
          const int pick = b.idx;
          const int c = min(pick / X1, C - 1);
          const int x = pick % X1;
          const int cc = pick / X1, xx = pick - cc * X1;
          // the class of the picked cell (recomputed from the codes)
          const int dl = side == 0 ? s.dc[(size_t)inner * X1 + xx]
                                   : s.dc[(size_t)cc * X1 + xx];
          const int ar = side == 0 ? s.ac[(size_t)cc * X1 + xx]
                                   : s.ac[(size_t)inner * X1 + xx];
          bool cn, cf;
          const int dir = sp_classify(dl, ar, &cn, &cf);
          const size_t NN = (size_t)A.N;
          int* o = A.out + (size_t)side * 8 * NN + n;
          const int f0 = set * 4;
          o[(f0 + 0) * NN] = b.k >= 0 ? (b.k & ((1 << 23) - 1)) - (1 << 21)
                                      : -SS2_BIG;
          o[(f0 + 1) * NN] = sStart[c];
          o[(f0 + 2) * NN] = x;
          o[(f0 + 3) * NN] = dir;
        }
      }
    }
    __syncthreads();
  }
}

H2_EXPORT int h2_second_sweep(
    const void* ch, const void* reads, const void* quals, const void* lens,
    const void* starts, const void* valid, const void* minsc,
    const void* mm_pen, const void* pwm, const void* lp, const void* b_i,
    const void* b_j, const void* b_x, const void* b_score,
    const void* b_valid, const void* rdids, const void* kd, const void* ka,
    const void* rdid, const void* ka_s, const void* kd_s,
    const void* rdid_a, const void* kd_lob, const void* ka_lob, int shift,
    int S, int NB, int use_ss, long long n_text, int N, int C, int L, int W,
    int M, int n_pen, int LP, int nlp_can, int nlp_nc, int min_intron,
    int max_intron, int pen_can, int pen_noncan, int min_anchor,
    int min_anchor_noncan, void* out, void* stream) {
  if (C < 1 || C > 32 || L < 1 || L > SP_MAX_L || M < 16 ||
      W != L + 2 * M || nlp_can < 1 || nlp_nc < 1 || (use_ss && S < 1))
    return (int)cudaErrorInvalidValue;
  H2Sites st{(const int*)kd, (const int*)ka, (const int*)rdid,
             (const int*)ka_s, (const int*)kd_s, (const int*)rdid_a,
             (const int*)kd_lob, (const int*)ka_lob, shift, S, NB};
  SecondArgs A{(const int*)ch, (const int*)reads, (const int*)quals,
               (const int*)lens, (const int*)starts, (const uint8_t*)valid,
               (const int*)minsc, (const int*)mm_pen, (const float*)pwm,
               (const int*)lp, (const int*)b_i, (const int*)b_j,
               (const int*)b_x, (const int*)b_score,
               (const uint8_t*)b_valid, (const int*)rdids, st, use_ss,
               n_text, N, C, L, W, M, n_pen, LP, nlp_can, nlp_nc,
               min_intron, max_intron, pen_can, pen_noncan, min_anchor,
               min_anchor_noncan, (int*)out};
  const size_t smem = sp_smem_bytes(C, L, false) + (size_t)C * 4 +
                      (size_t)2 * (L + 1) * 5 + 64;
  cudaError_t e = cudaFuncSetAttribute(
      second_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (N > 0)
    second_sweep_kernel<<<N, SS2_THREADS, smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
