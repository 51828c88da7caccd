// Kernel 3: ungapped extension with closed-form soft clips (K6 + K7 fused).
//
// Replaces hisat2_tpu/ops/extend.py:pen_planes (:72, with its SNV
// branch :100-111) and extend_grouped (:225).  Plain twin:
// hisat2_tpu_torch/ops/extend.py:extend_grouped_plain (pen_planes +
// extend_from_planes).
//
// One warp per (lane, candidate).  The warp builds the per-column
// penalties from the candidate's reference window (and, on a graph index,
// its two SNV-plane windows: a mismatch that matches a catalog SNV allele
// is forgiven), the read and its qualities, keeps them in shared memory
// (no penalty plane goes to device memory: in DNA mode nothing else
// consumes them), and runs warp scans for
// the penalty prefix P, the clip-cost prefix Cc and the last/next
// penalised column.  From those it evaluates, with warp reductions:
//   - the best left/right clip (ties keep the LARGER clip, i.e. the first
//     max on the reversed axis as in extend.py) under the >= 7-column
//     trim-anchor rule, and without it for liveness;
//   - the alternate (trimmed-representation) score over the anchor forms;
//   - the mismatch, N and SNV-match counts inside the kept region.
// The SNV branch is a template parameter, so a linear index runs the
// mismatch test alone.  All arithmetic stays in int32 exactly as the JAX
// version; the largest value is L * 100000 (out-of-text penalty), far
// from overflow for L <= EXT_MAX_L.
//
// Bound: per candidate it reads L read chars, L quals and L window chars
// (from L2: the read is shared by the lane's C candidates) and does
// O(L) shared-memory work per pass; at N*C = 90k candidates it is a few
// microseconds of issue-bound work per wave.
#include "common.cuh"

#define EXT_MAX_L 1024
#define EXT_OOB_PEN 100000
#define EXT_NO_ALT (-(1 << 30))
#define EXT_MINA 7
#define EXT_BIG (1 << 30)
#define EXT_WARPS 4

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

template <bool SNV>
__global__ void extend_ungapped_kernel(ExtArgs A) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const long long cand = (long long)blockIdx.x * EXT_WARPS + wid;
  if (cand >= A.NC) return;  // uniform per warp
  const int L = A.L;
  int* sP = smem + (size_t)wid * (5 * L + 2);
  int* sC = sP + (L + 1);
  int* sFlag = sC + (L + 1);  // bit0 mm, bit1 N, bit2 penalised, bit3 SNV
  int* sLast = sFlag + L;     // last penalised column <= col, else -1
  int* sNext = sLast + L;     // next penalised column >= col, else BIG
  const long long n = cand / A.C;
  const int len = A.lens[n];
  const int start = A.cand_start[cand];
  const int* rd = A.reads + n * L;
  const int* qs = A.quals + n * L;
  const int* wc = A.win + cand * A.W + A.margin;

  // --- per-column penalties (pen_planes) ---
  for (int col = lane; col < L; col += 32) {
    const int r = rd[col];
    const int q = min(qs[col], 63);
    const bool vp = col < len;
    const long long pos = (long long)start + col;
    const bool oob = vp && (pos < 0 || pos >= A.n_text);
    const int rc = min(wc[col], 3);
    const bool isn = vp && r >= 4;
    const bool mm_raw = vp && r < 4 && r != rc && !oob;
    bool snp_ok = false;
    if (SNV) {
      const long long at = cand * A.W + A.margin + col;
      const int v1 = min(A.snv1[at], 3), v2 = min(A.snv2[at], 3);
      snp_ok = mm_raw && ((v1 != 0 && r == ((rc + v1) & 3)) ||
                          (v2 != 0 && r == ((rc + v2) & 3)));
    }
    const bool mm = mm_raw && !snp_ok;
    const int pen = (mm ? A.mm_pen[q] : 0) + (isn ? A.n_pen : 0) +
                    (oob ? EXT_OOB_PEN : 0);
    sP[col + 1] = pen;
    sC[col + 1] = vp ? A.clip_pen[q] : 0;
    sFlag[col] = (mm ? 1 : 0) | (isn ? 2 : 0) | ((pen > 0 && vp) ? 4 : 0) |
                 (snp_ok ? 8 : 0);
  }
  __syncwarp();
  // --- prefix sums P[a] = sum pen[:a], Cc[a] = sum ccost[:a] ---
  int carryP = 0, carryC = 0;
  for (int b = 0; b < L; b += 32) {
    const int col = b + lane;
    const bool in = col < L;
    const int sp = h2_warp_incl_sum(in ? sP[col + 1] : 0, lane);
    const int sc = h2_warp_incl_sum(in ? sC[col + 1] : 0, lane);
    if (in) {
      sP[col + 1] = carryP + sp;
      sC[col + 1] = carryC + sc;
    }
    carryP += __shfl_sync(H2_FULL_MASK, sp, 31);
    carryC += __shfl_sync(H2_FULL_MASK, sc, 31);
  }
  if (lane == 0) {
    sP[0] = 0;
    sC[0] = 0;
  }
  // --- last / next penalised column ---
  int carry = -1;
  for (int b = 0; b < L; b += 32) {
    const int col = b + lane;
    const int v = (col < L && (sFlag[col] & 4)) ? col : -1;
    const int m = max(h2_warp_incl_max(v, lane), carry);
    if (col < L) sLast[col] = m;
    carry = __shfl_sync(H2_FULL_MASK, m, 31);
  }
  carry = EXT_BIG;
  for (int b = ((L - 1) / 32) * 32; b >= 0; b -= 32) {
    const int col = b + lane;
    const int v = (col < L && (sFlag[col] & 4)) ? col : EXT_BIG;
    const int m = min(h2_warp_suffix_min(v, lane), carry);
    if (col < L) sNext[col] = m;
    carry = __shfl_sync(H2_FULL_MASK, m, 0);
  }
  __syncwarp();

  const int total_pen = sP[L];
  const int p_len = sP[len];
  const bool uni = A.uniform_len != 0;
  // run_l[a]: pen-free run starting at a; run_r[a]: run ending below a
  auto nextp = [&](int a) { return sNext[a] == EXT_BIG ? len : sNext[a]; };
  auto run_l = [&](int a) { return a < L ? min(nextp(a), len) - a : 0; };
  auto run_r = [&](int a) { return a == 0 ? 0 : (a - 1) - sLast[a - 1]; };
  auto bidx = [&](int b) { return uni ? L - b : max(len - b, 0); };
  auto p_at = [&](int b) { return sP[bidx(b)]; };
  auto r_at = [&](int b) { return run_r(bidx(b)); };

  int clip_l = 0, clip_r = 0, score, alt = EXT_NO_ALT;
  bool ok = true;
  if (A.allow_softclip) {
    int gl = INT_MIN, cl = -1, glu = INT_MIN, clu = -1;
    int gr = INT_MIN, cr = -1, gru = INT_MIN, cru = -1;
    for (int a = lane; a <= L; a += 32) {
      const bool in_read = a <= len;
      const int lv = sP[a] - sC[a];
      const int v = (in_read && (a == 0 || run_l(a) >= EXT_MINA)) ? lv : -1;
      const int vu = in_read ? lv : -1;
      if (v >= gl) { gl = v; cl = a; }
      if (vu >= glu) { glu = vu; clu = a; }
      const int rv = p_len - p_at(a) - sC[a];
      const int w = (in_read && (a == 0 || r_at(a) >= EXT_MINA)) ? rv : -1;
      const int wu = in_read ? rv : -1;
      if (w >= gr) { gr = w; cr = a; }
      if (wu >= gru) { gru = wu; cru = a; }
    }
    h2_warp_argmax_last(gl, cl);
    h2_warp_argmax_last(glu, clu);
    h2_warp_argmax_last(gr, cr);
    h2_warp_argmax_last(gru, cru);
    gl = max(gl, 0);
    gr = max(gr, 0);
    clip_l = gl > 0 ? cl : 0;
    clip_r = gr > 0 ? cr : 0;
    score = -(total_pen - gl - gr);
    ok = ((glu > 0 ? clu : 0) + (gru > 0 ? cru : 0)) < len;
    if (A.use_minsc) {
      const int msc = A.minsc[n];
      const int T = h2_floordiv(-msc, max(A.mm_min, 1));
      const int TW = min(L, 64);
      const int KCR = min(TW, 32);
      const int cl_s = clip_l, cr_s = clip_r;
      auto loser = [&](bool okf, int sc, int clf, int crf) {
        const bool keep = okf && (clf > 0 || crf > 0) &&
                          !(clf == cl_s && crf == cr_s) && sc >= msc;
        return keep ? sc : EXT_NO_ALT;
      };
      int best_any = EXT_NO_ALT, best_own = EXT_NO_ALT;
      for (int a = lane; a < TW; a += 32) {
        const bool prev_pen = a == 0 ? true : ((sFlag[a - 1] & 4) != 0);
        const bool a_okw = prev_pen && run_l(a) >= EXT_MINA && a < len;
        const int a1 = min(nextp(a), len);
        const int cl_w = (a > 0 && a <= T) ? a : 0;
        const int crw_raw = len - a1;
        const int cr_w = (crw_raw > 0 && crw_raw <= T - 1) ? crw_raw : 0;
        const bool maskL = a > 0 && a <= T;
        const bool maskR = crw_raw > 0 && crw_raw <= T - 1 && crw_raw < KCR;
        const int C_cr = (cr_w >= 1 && cr_w < KCR) ? sC[cr_w] : 0;
        const int P_cl_e = maskL ? sP[a] : 0;
        const int C_cl_e = maskL ? sC[a] : 0;
        const int P_hi_e = maskR ? sP[a] : p_len;
        const int C_cr_e = maskR ? C_cr : 0;
        const int f_b = -(P_hi_e - P_cl_e) - C_cl_e - C_cr_e;
        const int f_l = -(p_len - P_cl_e) - C_cl_e;
        const int f_r = -P_hi_e - C_cr_e;
        const int lb = loser(a_okw, f_b, cl_w, cr_w);
        best_any = max(best_any, lb);
        best_any = max(best_any, loser(a_okw, f_l, cl_w, 0));
        best_any = max(best_any, loser(a_okw, f_r, 0, cr_w));
        const bool own =
            (cl_w == cl_s && cl_s > 0) || (cr_w == cr_s && cr_s > 0);
        if (own) best_own = max(best_own, lb);
      }
      const int Tmax = min(L, 64);
      for (int b = lane; b < Tmax; b += 32) {
        const int pen_b = b == 0 ? 0 : p_at(b - 1) - p_at(b);
        const bool ok_b = b > 0 && b <= T - 1 && pen_b > 0 &&
                          r_at(b) >= EXT_MINA && b < len;
        best_any = max(best_any, loser(ok_b, -p_at(b) - sC[b], 0, b));
      }
      best_any = h2_warp_max(best_any);
      best_own = h2_warp_max(best_own);
      if (cl_s == 0 && cr_s == 0)
        alt = best_any;
      else if (cl_s > 0 && cr_s > 0)
        alt = EXT_NO_ALT;
      else
        alt = best_own;
    }
  } else {
    score = -total_pen;
  }
  ok = ok && start >= 0 && score > -(EXT_OOB_PEN / 2);
  // aligned-region mismatch / N / SNV-match counts
  int nmm = 0, nn = 0, nsnp = 0;
  for (int col = lane; col < L; col += 32) {
    const bool keep = col >= clip_l && col < len - clip_r;
    const int f = sFlag[col];
    nmm += (keep && (f & 1)) ? 1 : 0;
    nn += (keep && (f & 2)) ? 1 : 0;
    if (SNV) nsnp += (keep && (f & 8)) ? 1 : 0;
  }
  nmm = h2_warp_sum(nmm);
  nn = h2_warp_sum(nn);
  if (SNV) nsnp = h2_warp_sum(nsnp);
  if (lane == 0) {
    A.score[cand] = score;
    A.n_mm[cand] = nmm;
    A.n_n[cand] = nn;
    A.n_snp[cand] = nsnp;
    A.clip_l[cand] = clip_l;
    A.clip_r[cand] = clip_r;
    A.ok[cand] = ok ? 1 : 0;
    A.alt[cand] = alt;
  }
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
  if (L > EXT_MAX_L || L < 1) return (int)cudaErrorInvalidValue;
  ExtArgs A{(const int*)reads, (const int*)quals, (const int*)lens,
            (const int*)cand_start, (const int*)win, (const int*)mm_pen,
            (const int*)clip_pen, (const int*)minsc, (const int*)snv1,
            (const int*)snv2, NC, C, L, W, margin, n_text, n_pen,
            allow_softclip, uniform_len, use_minsc, mm_min,
            (int*)score, (int*)n_mm, (int*)n_n, (int*)n_snp, (int*)clip_l,
            (int*)clip_r, (uint8_t*)ok, (int*)alt};
  const size_t smem = (size_t)EXT_WARPS * (5 * L + 2) * sizeof(int);
  auto kern = use_snv ? extend_ungapped_kernel<true>
                      : extend_ungapped_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (NC + EXT_WARPS - 1) / EXT_WARPS;
  if (blocks > 0)
    kern<<<(unsigned)blocks, 32 * EXT_WARPS, smem, (cudaStream_t)stream>>>(
        A);
  return (int)cudaGetLastError();
}
