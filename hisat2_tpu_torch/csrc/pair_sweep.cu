// K13 + K14: the junction pair sweep and its top pairs.
//
// Replaces hisat2_tpu/ops/splice.py:pair_sweep (:300, with _pwm_prod
// :222, _pwm_planes :246, _take_x_i/_j :286-297 and the max_intron_len /
// intron_len_prob gates :110-141) and select_pairs (:1318), plus the two
// raw-argmax base pairs of align/pipeline.py:1389-1396.  Plain twin:
// hisat2_tpu_torch/ops/splice.py:pair_sweep_ref.
//
// One block per lane.  The block first builds every candidate diagonal's
// planes in shared memory (splice_planes.cuh: prefixes, budget bases,
// donor/acceptor codes, PWM products; on a graph index also the
// SNV-forgiving prefix, from the SNV-plane windows: indel joins read it,
// splice joins the raw one, as splice.py:304-309 and pipeline.py:
// 1084-1089 pass pen_ind and pen_spl), then one thread per (i, j) pair
// scans x = 0..L+1 keeping the running best by the reference's order:
// classified direction and score (one key), then PWM probability, then
// the tie key (x for splices, raw mismatches * (L+2) + x for indels).
// That order is lexicographic, so the JAX version's blocked scan with a
// carry gives the same pick as one pass.  The epilogue recovers the class
// at the chosen x, applies the anchor / intron-length / PWM gates and the
// length penalty (a host-built step table: a device logf can sit one ulp
// off JAX's), and writes the [N, C, C] planes.  Then K14 on the same
// block: the top `top` pair scores (ties to the lower flat index, as
// lax.top_k) with their fields, and the first argmax of the raw scores
// with the runner-up after masking it (jnp.argmax takes the first max).
//
// Bound: per lane C^2 * (L+2) key evaluations (about 40 k at C = 14, L =
// 100), each a dozen shared-memory loads and integer ops; operations-
// bound on the CUDA cores, about 0.3 G ops per 8192-lane step.  f32 is
// kept bit-exact: every product, sum and quotient goes through __fmul_rn,
// __fadd_rn and __fdiv_rn, so nvcc cannot contract them into FMAs.
#include "splice_planes.cuh"

#define PS_BIG (1 << 30)

struct PairArgs {
  const int* ch;      // [N, C, W]
  const int* reads;   // [N, L]
  const int* quals;
  const int* lens;    // [N]
  const int* starts;  // [N, C]
  const uint8_t* valid;
  const int* minsc;
  const int* mm_pen;
  const float* pwm;   // [96]
  const int* lp;      // [4, LP]: brk_can, val_can, brk_nc, val_nc
  long long n_text;
  int N, C, L, W, M, n_pen, V, gcap, LP, nlp_can, nlp_nc;
  int min_intron, max_intron, pen_can, pen_noncan, min_anchor,
      min_anchor_noncan, rd_go, rd_ge, rf_go, rf_ge, top;
  const int* s1w;     // [N, C, W] SNV-plane windows (graph index only)
  const int* s2w;
  int use_snv;
  int* res;   // [6, N, C, C]: score, x, kind, spldir, splscore bits, raw
  int* sel;   // [9, N, top]: score, i, j, d1, d2, x, kind, spldir, splscore
  int* bsel;  // [N, 2]
};

__device__ __forceinline__ int ps_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__global__ void pair_sweep_kernel(PairArgs A) {
  extern __shared__ __align__(16) char smem[];
  const int n = blockIdx.x;
  const int C = A.C, L = A.L, X1 = L + 1, CC = C * C;
  SpPlanes s;
  float* pwm_s;
  char* free_ = sp_carve(smem, C, L, true, s, &pwm_s, A.use_snv != 0);
  int* sScore = (int*)free_;       // [CC]
  int* sRaw = sScore + CC;
  int* sX = sRaw + CC;
  int* sKind = sX + CC;
  int* sDir = sKind + CC;
  int* sSpl = sDir + CC;
  int* sStart = sSpl + CC;         // [C]
  for (int k = threadIdx.x; k < 96; k += blockDim.x) pwm_s[k] = A.pwm[k];
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    sStart[c] = A.starts[(size_t)n * C + c];
  __syncthreads();
  const int len = A.lens[n];
  const int minsc = A.minsc[n];
  sp_build(s, pwm_s, A.ch + (size_t)n * C * A.W, A.reads + (size_t)n * L,
           A.quals + (size_t)n * L, len, A.starts + (size_t)n * C,
           A.valid + (size_t)n * C, A.n_text, A.mm_pen, A.n_pen, C, L, A.W,
           A.M, A.use_snv ? A.s1w + (size_t)n * C * A.W : nullptr,
           A.use_snv ? A.s2w + (size_t)n * C * A.W : nullptr);
  const uint8_t* vld = A.valid + (size_t)n * C;
  for (int p = threadIdx.x; p < CC; p += blockDim.x) {
    const int i = p / C, j = p - i * C;
    const int D = ps_sub(sStart[j], sStart[i]);
    const bool is_spl = D >= A.min_intron && D <= A.max_intron;
    const bool is_del = D >= 1 && D < A.min_intron;
    const bool is_ins = D <= -1 && D >= -A.gcap;
    const bool pmask = vld[i] && vld[j] && (is_spl || is_del || is_ins);
    const long long I = D < 0 ? -(long long)D : 0;
    const int gap_pen = is_del ? A.rd_go + A.rd_ge * D
                      : is_ins ? A.rf_go + A.rf_ge * (-D) : 0;
    const int shift = (is_ins && I <= A.V) ? (int)I : 0;
    const int* Pi = s.P + (size_t)i * X1;     // splice joins: raw
    const int* Pj = s.P + (size_t)j * X1;
    const int* Fi = s.Pi + (size_t)i * X1;    // indel joins: SNV-forgiving
    const int* Fj = s.Pi + (size_t)j * X1;
    const int* Ri = s.Pr + (size_t)i * X1;
    const int* Rj = s.Pr + (size_t)j * X1;
    const int tot_j = Pj[L], totf_j = Fj[L], totr_j = Rj[L];
    const int* bli = s.bl + (size_t)i * X1;
    const int* brj = s.br + (size_t)j * X1;
    const uint8_t* dci = s.dc + (size_t)i * X1;
    const uint8_t* acj = s.ac + (size_t)j * X1;
    const float* dfi = s.dfw + (size_t)i * X1;
    const float* afj = s.afw + (size_t)j * X1;
    const float* drj = s.drc + (size_t)j * X1;
    const float* ari = s.arc + (size_t)i * X1;
    int bk = INT_MIN, bt = INT_MAX;
    float bp = -2.0f;
    for (int x = 0; x <= L + 1; ++x) {
      const int xi = min(x, L);            // past L the prefixes hold totals
      const int xs = min(x + shift, L);
      const bool vx = x >= 1 && (long long)x + I <= len - 1 && x <= L;
      const int pl_i = Pi[xi], pl_r = Ri[xi];
      const int score_ind = -(Fi[xi] + (totf_j - Fj[xs])) - gap_pen;
      const int raw4 = pl_r + (totr_j - Rj[xs]);
      int score = score_ind, hd = 0;
      float ssc = 0.0f;
      bool ok = vx && pmask;
      if (is_spl) {
        const int lp = pl_i;
        const int rp = tot_j - Pj[xi];
        const int dl = x <= L ? dci[x] : 255;
        const int ar = x <= L ? acj[x] : 255;
        bool canonical, can_fw;
        const int dir = sp_classify(dl, ar, &canonical, &can_fw);
        float splsc = 0.0f;
        if (canonical && x <= L) {
          const float prod = can_fw ? __fmul_rn(dfi[x], afj[x])
                                    : __fmul_rn(drj[x], ari[x]);
          splsc = __fdiv_rn(1.0f, __fadd_rn(1.0f, prod));
        }
        score = -(lp + rp) - (canonical ? A.pen_can : A.pen_noncan);
        hd = dir != 0 ? 1 : 0;
        ssc = splsc;
        const bool budget = x <= L && (lp - bli[x] <= -minsc) &&
                            (rp - brj[x] <= -minsc);
        ok = ok && budget;
      }
      const int k1 = ok ? (hd << 23) + max(score, -(1 << 21)) + (1 << 21)
                        : -1;
      const int tkey = is_spl ? x : raw4 * (L + 2) + x;
      if (k1 > bk || (k1 == bk && (ssc > bp || (ssc == bp && tkey < bt)))) {
        bk = k1;
        bp = ssc;
        bt = tkey;
      }
    }
    const int bx = is_spl ? bt : bt % (L + 2);
    const int bs = bk >= 0 ? (bk & ((1 << 23) - 1)) - (1 << 21) : -PS_BIG;
    bp = fmaxf(bp, 0.0f);
    // class at the chosen x (codes read 0 past x = L)
    const int dl = bx <= L ? s.dc[(size_t)i * X1 + bx] : 0;
    const int ar = bx <= L ? s.ac[(size_t)j * X1 + bx] : 0;
    bool canonical, can_fw;
    int spldir = sp_classify(dl, ar, &canonical, &can_fw);
    if (!is_spl) spldir = 0;
    canonical = spldir == 1 || spldir == 2;
    const int kind = is_spl ? 1 : is_del ? 2 : is_ins ? 3 : 0;
    const int* Pmi = s.Pm + (size_t)i * X1;
    const int* Pmj = s.Pm + (size_t)j * X1;
    const int mm_l = bx <= L ? Pmi[bx] : 0;
    const int xr = (int)min((long long)bx + I, (long long)L);
    const int mm_r = Pmj[len] - Pmj[xr];
    bool ok = bs > -PS_BIG / 2;
    const int shorter_raw = min(bx, len - bx);
    const bool pre_can = shorter_raw < A.min_anchor &&
        sp_intron_len_prob(shorter_raw, D, A.max_intron, 14, 4) > 0.01f;
    const bool pre_non = shorter_raw < A.min_anchor_noncan &&
        sp_intron_len_prob(shorter_raw, D, A.max_intron, 16, 0) > 0.01f;
    bool spl_ok = canonical ? !pre_can : !pre_non;
    const int adj_l = bx - 2 * mm_l;
    const int adj_r = (len - bx) - 2 * mm_r;
    const int shorter = max(min(adj_l, adj_r), 1);
    const int thresh = canonical
        ? sp_max_intron_len(shorter, A.min_anchor)
        : sp_max_intron_len_noncan(shorter, A.min_anchor_noncan);
    const bool gated = thresh < A.max_intron;
    spl_ok = spl_ok && !(gated && D > thresh);
    spl_ok = spl_ok && !(gated && canonical && bp < sp_pth(D));
    const int mm_short = adj_l <= adj_r ? mm_l : mm_r;
    spl_ok = spl_ok && !(gated && mm_short > 0);
    const int lenpen = canonical
        ? sp_lenpen(A.lp, A.lp + A.LP, A.nlp_can, D)
        : sp_lenpen(A.lp + 2 * A.LP, A.lp + 3 * A.LP, A.nlp_nc, D);
    int score = kind == 1 ? bs - lenpen : bs;
    if (kind == 1) ok = ok && spl_ok;
    const int raw = ok ? score : -PS_BIG;
    ok = ok && score >= minsc;
    score = ok ? score : -PS_BIG;
    const size_t NCC = (size_t)A.N * CC;
    const size_t o = (size_t)n * CC + p;
    A.res[o] = score;
    A.res[NCC + o] = bx;
    A.res[2 * NCC + o] = kind;
    A.res[3 * NCC + o] = spldir;
    A.res[4 * NCC + o] = __float_as_int(bp);
    A.res[5 * NCC + o] = raw;
    sScore[p] = score;
    sRaw[p] = raw;
    sX[p] = bx;
    sKind[p] = kind;
    sDir[p] = spldir;
    sSpl[p] = __float_as_int(bp);
  }
  __syncthreads();
  // K14 and the base pairs: warp 0
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int prev_v = INT_MAX, prev_p = -1;
  for (int r = 0; r < A.top; ++r) {
    // the best (score desc, index asc) strictly after the previous pick
    int bv = INT_MIN, bpk = INT_MAX;
    for (int p = lane; p < CC; p += 32) {
      const int v = sScore[p];
      const bool after = v < prev_v || (v == prev_v && p > prev_p);
      if (after && (v > bv || (v == bv && p < bpk))) {
        bv = v;
        bpk = p;
      }
    }
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) {
      const int v2 = __shfl_xor_sync(H2_FULL_MASK, bv, o2);
      const int p2 = __shfl_xor_sync(H2_FULL_MASK, bpk, o2);
      if (v2 > bv || (v2 == bv && p2 < bpk)) {
        bv = v2;
        bpk = p2;
      }
    }
    if (lane == 0) {
      const size_t NT = (size_t)A.N * A.top;
      const size_t o = (size_t)n * A.top + r;
      const int i = bpk / C, j = bpk - (bpk / C) * C;
      A.sel[o] = bv;
      A.sel[NT + o] = i;
      A.sel[2 * NT + o] = j;
      A.sel[3 * NT + o] = sStart[i];
      A.sel[4 * NT + o] = sStart[j];
      A.sel[5 * NT + o] = sX[bpk];
      A.sel[6 * NT + o] = sKind[bpk];
      A.sel[7 * NT + o] = sDir[bpk];
      A.sel[8 * NT + o] = sSpl[bpk];
    }
    prev_v = bv;
    prev_p = bpk;
  }
  int b0 = -1;
  for (int t = 0; t < 2; ++t) {
    int bv = INT_MIN, bpk = INT_MAX;
    for (int p = lane; p < CC; p += 32) {
      const int v = p == b0 ? -PS_BIG : sRaw[p];
      if (v > bv || (v == bv && p < bpk)) {
        bv = v;
        bpk = p;
      }
    }
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) {
      const int v2 = __shfl_xor_sync(H2_FULL_MASK, bv, o2);
      const int p2 = __shfl_xor_sync(H2_FULL_MASK, bpk, o2);
      if (v2 > bv || (v2 == bv && p2 < bpk)) {
        bv = v2;
        bpk = p2;
      }
    }
    if (lane == 0) A.bsel[(size_t)n * 2 + t] = bpk;
    b0 = bpk;
  }
}

H2_EXPORT int h2_pair_sweep(
    const void* ch, const void* reads, const void* quals, const void* lens,
    const void* starts, const void* valid, const void* minsc,
    const void* mm_pen, const void* pwm, const void* lp, long long n_text,
    int N, int C, int L, int W, int M, int n_pen, int V, int gcap, int LP,
    int nlp_can, int nlp_nc, int min_intron, int max_intron, int pen_can,
    int pen_noncan, int min_anchor, int min_anchor_noncan, int rd_go,
    int rd_ge, int rf_go, int rf_ge, int top, const void* s1w,
    const void* s2w, int use_snv, void* res, void* sel, void* bsel,
    void* stream) {
  if (C < 1 || C > 32 || L < 1 || L > SP_MAX_L || M < 16 ||
      W != L + 2 * M || top < 1 || top > C * C || nlp_can < 1 ||
      nlp_nc < 1)
    return (int)cudaErrorInvalidValue;
  PairArgs A{(const int*)ch, (const int*)reads, (const int*)quals,
             (const int*)lens, (const int*)starts, (const uint8_t*)valid,
             (const int*)minsc, (const int*)mm_pen, (const float*)pwm,
             (const int*)lp, n_text, N, C, L, W, M, n_pen, V, gcap, LP,
             nlp_can, nlp_nc, min_intron, max_intron, pen_can, pen_noncan,
             min_anchor, min_anchor_noncan, rd_go, rd_ge, rf_go, rf_ge, top,
             (const int*)s1w, (const int*)s2w, use_snv, (int*)res, (int*)sel,
             (int*)bsel};
  const size_t smem = sp_smem_bytes(C, L, true, use_snv != 0) +
                      (size_t)(6 * C * C + C) * 4 + 64;
  cudaError_t e = cudaFuncSetAttribute(
      pair_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int threads = min(1024, ((C * C + 31) / 32) * 32);
  if (N > 0)
    pair_sweep_kernel<<<N, max(threads, 64), smem, (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}
