// K15: the second-junction sweep of multi-exon reads, both base pairs of
// a spliced full step in one launch.
//
// Replaces hisat2_tpu/ops/splice.py:second_sweep (:1107) with the site
// lookups of table_searchsorted (:192, site_search.cuh), called once per
// base pair by hisat2_tpu/align/pipeline.py:1389-1412 (the q2_ and r2_
// pairs).  Plain twin: hisat2_tpu_torch/ops/splice.py:second_sweep_ref.
//
// One block per lane.  The planes depend on the lane alone, not on the
// base pair, so the block builds them once (splice_planes.cuh, without
// the budget bases), then sweeps four sides: for each base pair, right of
// (j0, x1), the inner diagonal j0 as donor and every candidate diagonal
// as acceptor at x > x1; left of (i0, x1), every diagonal as donor and i0
// as acceptor at x < x1.  Every side's two site-table candidates per x
// are looked up at once (readid-gated, 4 * (L+1) independent searches)
// and kept in shared memory; a cell (c, x) matching one is a known
// junction: free and exempt from the gates.  The per-(side, diagonal)
// values (D, the splice gate, both length penalties, the PWM floor) are
// tabled once.  Then a warp takes 32 columns of one diagonal and
// evaluates each cell for all four sides (the inner diagonals' values at
// those columns held in registers while the warp stays on them), folding
// into two bests per side by (classified direction and score, PWM
// probability, lowest flat index): the minsc-gated set and the ungated
// "u" set; the gates are evaluated only where the cell can score (else
// both keys are -1), and a cell with key -1 and probability 0 is not
// folded (cell 0, always folded, dominates it).  A block reduction merges
// them, one warp per (side, set).
//
// Where a lane's planes outgrow a block's shared memory (long reads, many
// candidates) the global instantiation keeps them, and the per-(side,
// diagonal) tables, in its slice of a global scratch (common.cuh:
// h2_staging): any L up to SP_MAX_COLS and any C.
//
// Bound: per lane one plane prologue (C * (L+1) cells of class masks, PWM
// products where a side is canonical, and prefix scans) and 4 * C *
// (L+1) cells of shared-memory reads and integer compares, plus 4 * 2 *
// (L+1) site-table binary searches; operations-bound on the CUDA cores.
#include "site_search.cuh"
#include "splice_planes.cuh"

#define SS2_BIG (1 << 30)
#define SS2_THREADS 256  // 8 warps: one per (side, set) in the final merge

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
  const int* b_i;      // [2, N] the base pairs: q2, then r2
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
  int* out;  // [2 base pairs, 2 sides, 8, N]: score d x dir uscore ud ux udir
};

// the union region after the prologue: the four sides' site candidates
// (a value and a usable flag for two per x), then per side and candidate
// D, the splice gate, both length penalties and the PWM floor
__host__ __device__ inline size_t s2_sites_bytes(int L) {
  return ((size_t)8 * (L + 1) * 5 + 3) & ~(size_t)3;
}

__host__ __device__ inline size_t s2_post_bytes(int C, int L) {
  return s2_sites_bytes(L) + (size_t)4 * C * 17;
}

__host__ __device__ inline size_t s2_smem_bytes(int C, int L, int W,
                                                int LP) {
  SpOffsets o;
  return sp_layout(C, L, W, LP, false, false, s2_post_bytes(C, L), &o);
}

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

// GLOBAL: the planes in the block's slice of `scratch` (h2_staging), the
// blocks walking the lanes with a grid stride; else in dynamic shared
// memory, a block per lane
template <bool GLOBAL>
__global__ void __launch_bounds__(SS2_THREADS, 3)
second_sweep_kernel(SecondArgs A, char* scratch) {
  extern __shared__ __align__(16) char smem[];
  __shared__ S2Best sRed[8][SS2_THREADS / 32];
  const int C = A.C, L = A.L, X1 = L + 1;
  SpPlanes s;
  char* base = smem;
  if (GLOBAL) {
    SpOffsets so;
    base = scratch + (size_t)blockIdx.x *
        h2_slice(sp_layout(C, L, A.W, A.LP, false, false,
                           s2_post_bytes(C, L), &so));
  }
  sp_carve(base, C, L, A.W, A.LP, false, false, s2_post_bytes(C, L), s);
  const int XS = s.XS, XSh = s.XSh, XSb = s.XSb;
  for (int n = blockIdx.x; n < A.N; n += gridDim.x) {
    sp_tables(s, A.pwm, A.lp, A.LP, A.starts + (size_t)n * C,
              A.valid + (size_t)n * C, C);
    const int len = A.lens[n];
    const int minsc = A.minsc[n];
    SpLane in{A.ch + (size_t)n * C * A.W, nullptr, nullptr,
              A.reads + (size_t)n * L, A.quals + (size_t)n * L, A.mm_pen, len,
              A.n_pen, minsc, A.n_text};
    sp_build(s, in, C, L, A.W, A.M);
    int* sK = (int*)s.uni;                    // [4 sides][2][X1] site value
    uint8_t* sKm = (uint8_t*)(sK + 8 * X1);   // [4][2][X1] candidate usable
    // per side and candidate ([4][C]): D, splice gate, length penalties,
    // PWM floor
    int* tD = (int*)(s.uni + s2_sites_bytes(L));
    int* tLc = tD + 4 * C;
    int* tLn = tLc + 4 * C;
    float* tPth = (float*)(tLn + 4 * C);
    uint8_t* tSpl = (uint8_t*)(tPth + 4 * C);
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nwarp = blockDim.x >> 5;
    const int LP = A.LP;
    const size_t NN = (size_t)A.N;
    // the four sides (base pair 0 right, 0 left, 1 right, 1 left): their
    // inner diagonal, x1, base score, inner total and raw mismatches at x1
    int cIn[4], cBx[4], cBsc[4], cTot[4], cMm[4];
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      const size_t bo = (size_t)(cb >> 1) * NN + n;
      const int inner = (cb & 1) == 0 ? A.b_j[bo] : A.b_i[bo];
      const int bx = A.b_x[bo];
      cIn[cb] = inner;
      cBx[cb] = bx;
      cBsc[cb] = A.b_score[bo];
      cTot[cb] = s.P[inner * XS + L];
      cMm[cb] = (bx >= 0 && bx <= L) ? s.Pm[inner * XSh + bx] : INT_MIN;
    }
    for (int t = threadIdx.x; t < 4 * C; t += blockDim.x) {
      const int cb = t / C, c = t - cb * C;
      const size_t bo = (size_t)(cb >> 1) * NN + n;
      const int istart = s.start[(cb & 1) == 0 ? A.b_j[bo] : A.b_i[bo]];
      const int D = (cb & 1) == 0
          ? (int)((unsigned)s.start[c] - (unsigned)istart)
          : (int)((unsigned)istart - (unsigned)s.start[c]);
      tD[cb * C + c] = D;
      tSpl[cb * C + c] = D >= A.min_intron && D <= A.max_intron &&
                         s.valid[c] && A.b_valid[bo] != 0;
      tLc[cb * C + c] = sp_lenpen(s.lp, s.lp + LP, A.nlp_can, D);
      tLn[cb * C + c] = sp_lenpen(s.lp + 2 * LP, s.lp + 3 * LP, A.nlp_nc, D);
      tPth[cb * C + c] = sp_pth(D);
    }
    // every side's two site-table candidates per x, looked up at once
    if (A.use_ss) {
      const int rd = A.rdids[n];
      for (int t = threadIdx.x; t < 4 * X1; t += blockDim.x) {
        const int cb = t / X1, x = t - cb * X1, side = cb & 1;
        const size_t bo = (size_t)(cb >> 1) * NN + n;
        const int istart = s.start[side == 0 ? A.b_j[bo] : A.b_i[bo]];
        const int pos = side == 0 ? s2_add(istart, x - 1) : s2_add(istart, x);
        const int* tab = side == 0 ? A.st.kd : A.st.ka_s;
        const int* oth = side == 0 ? A.st.ka : A.st.kd_s;
        const int* rdt = side == 0 ? A.st.rdid : A.st.rdid_a;
        const int* lob = side == 0 ? A.st.kd_lob : A.st.ka_lob;
        const int lo = h2_table_searchsorted(tab, A.st.S, lob, A.st.NB,
                                             A.st.shift, pos);
        for (int u = 0; u < 2; ++u) {
          const int ii = min(lo + u, A.st.S - 1);
          const int srd = __ldg(rdt + ii);
          const bool m = lo + u < A.st.S && __ldg(tab + ii) == pos &&
                         (srd < 0 || srd < rd);
          sK[(2 * cb + u) * X1 + x] = __ldg(oth + ii);
          sKm[(2 * cb + u) * X1 + x] = m ? 1 : 0;
        }
      }
    }
    __syncthreads();
    // the cells: a warp takes 32 columns of one diagonal and evaluates them
    // for all four sides; its items go chunk by chunk, so the inner
    // diagonals' values at its columns load once per chunk
    S2Best bg[4], bu[4];
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      bg[cb] = S2Best{-2, -2.0f, INT_MAX};
      bu[cb] = S2Best{-2, -2.0f, INT_MAX};
    }
    const int nch = (X1 + 31) >> 5;
    int cur = -1, iP[4], iPm[4];
    unsigned iK[4];
    for (int it = wid; it < C * nch; it += nwarp) {
      const int ch = it / C, c = it - ch * C;
      const int x = ch * 32 + lane;
      const bool inx = x < X1;
      if (ch != cur) {
        cur = ch;
#pragma unroll
        for (int cb = 0; cb < 4; ++cb) {
          const int in_c = cIn[cb];
          iP[cb] = inx ? s.P[in_c * XS + x] : 0;
          iPm[cb] = inx ? s.Pm[in_c * XSh + x] : 0;
          // right sides: the inner diagonal is the donor; left: acceptor
          iK[cb] = inx ? ((cb & 1) == 0 ? s.dk[in_c * XSb + x]
                                        : s.ak[in_c * XSb + x]) : 0u;
        }
      }
      if (!inx) continue;
      const int e = c * XS + x, k = c * X1 + x;
      const int pcx = s.P[e], pcl = s.P[c * XS + L];
      const int pmx = s.Pm[c * XSh + x], pml = s.Pm[c * XSh + len];
      const unsigned dkc = s.dk[c * XSb + x], akc = s.ak[c * XSb + x];
      const int st_c = s.start[c];
#pragma unroll
      for (int cb = 0; cb < 4; ++cb) {
        const int side = cb & 1;
        const int bx = cBx[cb], bsc = cBsc[cb], pin = iP[cb], pmin = iPm[cb];
        const unsigned m = side == 0 ? iK[cb] & akc : dkc & iK[cb];
        const bool canonical = (m & (SP_CFW | SP_CRC)) != 0;
        float splsc = 0.0f;
        if (canonical) {
          const int ei = cIn[cb] * XS + x;
          splsc = side == 0 ? sp_splsc(s.dpw[ei], s.apw[e])
                            : sp_splsc(s.dpw[e], s.apw[ei]);
        }
        const bool vx = side == 0 ? x > bx && x <= len - 1 : x >= 1 && x < bx;
        int kg = -1, ku = -1;
        if (vx && tSpl[cb * C + c]) {
          int score, anchor_l, anchor_r;
          if (side == 0) {
            score = -((pin - (bsc + cTot[cb])) + (pcl - pcx));
            anchor_l = (int)((unsigned)(x - bx) -
                             2u * ((unsigned)pmin - (unsigned)cMm[cb]));
            anchor_r = (len - x) - 2 * (pml - pmx);
          } else {
            score = -(pcx + -(bsc + pin));
            anchor_l = x - 2 * pmx;
            anchor_r = (int)((unsigned)(bx - x) -
                             2u * ((unsigned)cMm[cb] - (unsigned)pmin));
          }
          bool known = false;
          if (A.use_ss) {
            const int tgt = side == 0 ? s2_add(st_c, x) : s2_add(st_c, x - 1);
            const int* k2 = sK + 2 * cb * X1;
            const uint8_t* m2 = sKm + 2 * cb * X1;
            known = (m2[x] && k2[x] == tgt) ||
                    (m2[X1 + x] && k2[X1 + x] == tgt);
          }
          const int D = tD[cb * C + c];
          const int pen2 = known ? 0 : (canonical ? A.pen_can : A.pen_noncan);
          const int sc2 = score - pen2;
          const int sh = max(min(anchor_l, anchor_r), 1);
          const int thresh = canonical
              ? sp_max_intron_len(sh, A.min_anchor)
              : sp_max_intron_len_noncan(sh, A.min_anchor_noncan);
          const bool gated = thresh < A.max_intron;
          const bool ok4 = known ||
              (!(gated && D > thresh) &&
               !(gated && canonical && splsc < tPth[cb * C + c]));
          const int lenpen = known ? 0
                           : canonical ? tLc[cb * C + c] : tLn[cb * C + c];
          const int sc2u = ok4 ? sc2 - lenpen : -SS2_BIG;
          const int sc2g = sc2u >= minsc ? sc2u : -SS2_BIG;
          const int hd = m != 0 ? 1 : 0;
          ku = sc2u > -SS2_BIG / 2
              ? (hd << 23) + max(sc2u, -(1 << 21)) + (1 << 21) : -1;
          kg = sc2g > -SS2_BIG / 2
              ? (hd << 23) + max(sc2g, -(1 << 21)) + (1 << 21) : -1;
        }
        // a cell with key -1 and probability 0 loses to cell 0 (the same or
        // a better key, the lowest index), which is always folded
        const bool floor_g = kg == -1 && splsc == 0.0f && k != 0;
        const bool floor_u = ku == -1 && splsc == 0.0f && k != 0;
        if (!floor_g && s2_better(kg, splsc, k, bg[cb]))
          bg[cb] = S2Best{kg, splsc, k};
        if (!floor_u && s2_better(ku, splsc, k, bu[cb]))
          bu[cb] = S2Best{ku, splsc, k};
      }
    }
#pragma unroll
    for (int cb = 0; cb < 4; ++cb) {
      s2_warp_fold(bg[cb]);
      s2_warp_fold(bu[cb]);
      if (lane == 0) {
        sRed[2 * cb][wid] = bg[cb];
        sRed[2 * cb + 1][wid] = bu[cb];
      }
    }
    __syncthreads();
    // warp w merges side w / 2's set w % 2 (0 the gated, 1 the ungated)
    const int cb = wid >> 1, set = wid & 1, side = cb & 1;
    S2Best b = lane < nwarp ? sRed[wid][lane] : S2Best{-2, -2.0f, INT_MAX};
    s2_warp_fold(b);
    if (lane == 0) {
      const size_t bo = (size_t)(cb >> 1) * NN + n;
      const int inner = side == 0 ? A.b_j[bo] : A.b_i[bo];
      const int pick = b.idx;
      const int c = min(pick / X1, C - 1);
      const int x = pick % X1;
      const int cc = pick / X1, xx = pick - cc * X1;
      // the class of the picked cell (recomputed from the masks)
      const unsigned m = side == 0
          ? s.dk[inner * XSb + xx] & s.ak[cc * XSb + xx]
          : s.dk[cc * XSb + xx] & s.ak[inner * XSb + xx];
      int* o = A.out + (size_t)cb * 8 * NN + n;
      const int f0 = set * 4;
      o[(f0 + 0) * NN] = b.k >= 0 ? (b.k & ((1 << 23) - 1)) - (1 << 21)
                                  : -SS2_BIG;
      o[(f0 + 1) * NN] = s.start[c];
      o[(f0 + 2) * NN] = x;
      o[(f0 + 3) * NN] = sp_dir(m);
    }
    __syncthreads();  // the next lane's tables overwrite these planes
  }
}

static bool s2_shape_ok(int C, int L, int W, int M, int LP) {
  return C >= 1 && L >= 1 && L <= SP_MAX_COLS && M >= 16 &&
         W == L + 2 * M && LP >= 1;
}

static cudaError_t s2_config(int C, int L, int W, int LP, long long N,
                             size_t have, H2Staging* c) {
  return h2_staging(second_sweep_kernel<false>, second_sweep_kernel<true>,
                    SS2_THREADS, 1, s2_smem_bytes(C, L, W, LP), N, have, c);
}

// The global scratch h2_second_sweep needs for N lanes at these shapes
// (0: none, the planes fit the shared memory).
H2_EXPORT int h2_second_sweep_scratch(int C, int L, int W, int LP,
                                      long long N, long long* bytes) {
  if (!s2_shape_ok(C, L, W, (W - L) / 2, LP))
    return (int)cudaErrorInvalidValue;
  H2Staging c;
  cudaError_t e = s2_config(C, L, W, LP, N, SIZE_MAX, &c);
  *bytes = (long long)c.scratch;
  return (int)e;
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
    int min_anchor_noncan, void* out, void* scratch, long long scratch_bytes,
    void* stream) {
  if (!s2_shape_ok(C, L, W, M, LP) || nlp_can < 1 || nlp_nc < 1 ||
      nlp_can > LP || nlp_nc > LP || (use_ss && S < 1))
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
  // past the shared memory, as many blocks as the scratch holds
  H2Staging c;
  cudaError_t e = s2_config(C, L, W, LP, N,
                            scratch ? (size_t)scratch_bytes : 0, &c);
  if (e != cudaSuccess) return (int)e;
  return (int)sp_launch(second_sweep_kernel<false>,
                        second_sweep_kernel<true>, SS2_THREADS,
                        s2_smem_bytes(C, L, W, LP), c, A, scratch, stream);
}

// The launch of K15 at these shapes (sp_launch_info's out).
H2_EXPORT int h2_second_sweep_info(int C, int L, int W, int LP, int* out) {
  return sp_launch_info(second_sweep_kernel<false>,
                        second_sweep_kernel<true>, SS2_THREADS,
                        s2_smem_bytes(C, L, W, LP), out);
}
