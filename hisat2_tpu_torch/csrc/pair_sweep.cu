// K13 + K14: the junction pair sweep and its top pairs.
//
// Replaces hisat2_tpu/ops/splice.py:pair_sweep (:300, with _pwm_prod
// :222, _pwm_planes :246, _take_x_i/_j :286-297 and the max_intron_len /
// intron_len_prob gates :110-141) and select_pairs (:1318), plus the two
// raw-argmax base pairs of align/pipeline.py:1389-1396.  Plain twin:
// hisat2_tpu_torch/ops/splice.py:pair_sweep_ref.
//
// One block per lane.  The block first builds every candidate diagonal's
// planes in shared memory (splice_planes.cuh: prefixes, the class masks
// with both sides' budget tests, PWM products; on a graph index also the
// SNV-forgiving prefix, from the SNV-plane windows: indel joins read it,
// splice joins the raw one, as splice.py:304-309 and pipeline.py:
// 1084-1089 pass pen_ind and pen_spl).  Then it sorts the lane's C^2
// pairs by kind into a list in shared memory, each kind's run padded to
// whole warps: splice pairs that can score, indel pairs that can score,
// splice pairs that cannot (their pick is still the best PWM probability,
// then the lowest x), and the rest (no join, or an indel that cannot
// score: their pick is still the lowest raw tie key; on real lanes nearly
// every pair).  res["x"] is written for every pair, valid or not, and the
// second sweeps read it off the base pairs, so every pair scans its x.
// One thread per pair of the list (the warps fetch 32 pairs at a time)
// scans x = 0..L(+1) with the loop of its kind, so a warp's threads take
// one path, keeping the running best by the reference's order:
// classified direction and score (one key), then PWM probability, then
// the tie key (x for splices, raw mismatches * (L+2) + x for indels).  The
// tie key is unique per x, so the order is total: the JAX version's
// blocked scan with a carry gives the same pick as one pass, and a step
// that the first step dominates need not be folded.  The epilogue
// recovers the class at the chosen x, applies the anchor / intron-length
// / PWM gates and the length penalty (a host-built step table in shared
// memory: a device logf can sit one ulp off JAX's), and keeps the pair's
// fields in shared memory; the block writes the [N, C, C] planes
// coalesced.  Then K14 on the same block: warp 0 picks the top `top` pair
// scores (ties to the lower flat index, as lax.top_k) with their fields,
// warp 1 the first argmax of the raw scores and the runner-up after
// masking it (jnp.argmax takes the first max).
//
// Bound: per lane C^2 * (L+2) key evaluations (about 37 k at C = 19, L =
// 100), each a few shared-memory loads and integer ops, on the CUDA
// cores; the windows (three int32 planes on a graph index) are the bytes.
// Shared memory sets the blocks per SM: about 22 bytes a cell (int16 Pm /
// Pr, one PWM product a side, the class masks with the budget bits in
// place of the bases), so four blocks at C = 19 on a graph index.  Where
// a lane's planes outgrow a block's shared memory (long reads, many
// candidates) the global instantiation keeps them in its slice of a
// global scratch (common.cuh: h2_staging), any L up to SP_MAX_COLS
// and any C.  A
// splice pair's step at x reads four shared-memory words: both prefixes
// and both masks.  f32 is kept bit-exact: every product, sum and quotient
// goes through __fmul_rn, __fadd_rn and __fdiv_rn, so nvcc cannot
// contract them into FMAs.
#include "splice_planes.cuh"

#define PS_BIG (1 << 30)
#define PS_THREADS 256
#define PS_PAD 128   // the pair list's room for padding each kind to 32

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

// the pair kinds, in sweep order (the costly loops first)
#define PK_SPL 0    // splice join that can score
#define PK_IND 1    // deletion / insertion join that can score
#define PK_SPLX 2   // splice join with an invalid side: PWM pick only
#define PK_NONE 3   // no join, or an indel with an invalid side

// the union region after the prologue: per-pair fields, then the list
__host__ __device__ inline size_t ps_post_bytes(int C) {
  return (size_t)20 * C * C + 4 * PS_PAD + 4;
}

__host__ __device__ inline size_t ps_smem_bytes(int C, int L, int W, int LP,
                                                bool snv) {
  SpOffsets o;
  return sp_layout(C, L, W, LP, true, snv, ps_post_bytes(C), &o);
}

__device__ __forceinline__ int ps_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ void ps_fold(int k1, float ssc, int tkey, int& bk,
                                        float& bp, int& bt) {
  if (k1 > bk || (k1 == bk && (ssc > bp || (ssc == bp && tkey < bt)))) {
    bk = k1;
    bp = ssc;
    bt = tkey;
  }
}

__device__ __forceinline__ int ps_key(bool ok, int hd, int score) {
  return ok ? (hd << 23) + max(score, -(1 << 21)) + (1 << 21) : -1;
}

// GLOBAL: the planes in the block's slice of `scratch` (h2_staging), the
// blocks walking the lanes with a grid stride; else in dynamic shared
// memory, a block per lane
template <bool GLOBAL>
__global__ void __launch_bounds__(PS_THREADS, 4)
pair_sweep_kernel(PairArgs A, char* scratch) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int kcount[4], kfill[4], knext, klen;
  const int C = A.C, L = A.L, CC = C * C;
  const bool snv = A.use_snv != 0;
  SpPlanes s;
  char* base = smem;
  if (GLOBAL) {
    SpOffsets so;
    base = scratch + (size_t)blockIdx.x *
        h2_slice(sp_layout(C, L, A.W, A.LP, true, snv, ps_post_bytes(C),
                           &so));
  }
  sp_carve(base, C, L, A.W, A.LP, true, snv, ps_post_bytes(C), s);
  const int XS = s.XS, XSh = s.XSh, XSb = s.XSb;
  for (int n = blockIdx.x; n < A.N; n += gridDim.x) {
    sp_tables(s, A.pwm, A.lp, A.LP, A.starts + (size_t)n * C,
              A.valid + (size_t)n * C, C);
    const int len = A.lens[n];
    const int minsc = A.minsc[n];
    const size_t lw = (size_t)n * C * A.W;
    SpLane in{A.ch + lw, snv ? A.s1w + lw : nullptr,
              snv ? A.s2w + lw : nullptr, A.reads + (size_t)n * L,
              A.quals + (size_t)n * L, A.mm_pen, len, A.n_pen, minsc,
              A.n_text};
    sp_build(s, in, C, L, A.W, A.M);
    // the union region now holds the per-pair fields and the pair list
    int* sScore = (int*)s.uni;       // [CC]
    int* sRaw = sScore + CC;
    int* sSpl = sRaw + CC;
    int16_t* sX = (int16_t*)(sSpl + CC);
    int* plist = (int*)(sX + CC + (CC & 1));  // [CC + PS_PAD]
    uint8_t* sKind = (uint8_t*)(plist + CC + PS_PAD);
    uint8_t* sDir = sKind + CC;
    // sort the pairs by kind (a counting sort, warp by warp: one ballot and
    // one shared atomic per kind and 32 pairs; the order inside a kind is
    // free, every pair writes its own fields)
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int nwarp = blockDim.x >> 5;
    const unsigned lt = (1u << lane) - 1;
    if (threadIdx.x < 4) kcount[threadIdx.x] = 0;
    if (threadIdx.x == 0) knext = 0;
    __syncthreads();
    for (int p0 = wid * 32; p0 < CC; p0 += nwarp * 32) {
      const int p = p0 + lane;
      int kd = -1;
      if (p < CC) {
        const int i = p / C, j = p - i * C;
        const int D = ps_sub(s.start[j], s.start[i]);
        const bool is_spl = D >= A.min_intron && D <= A.max_intron;
        const bool join = is_spl || (D >= 1 && D < A.min_intron) ||
                          (D <= -1 && D >= -A.gcap);
        const bool pmask = s.valid[i] && s.valid[j] && join;
        kd = is_spl ? (pmask ? PK_SPL : PK_SPLX) : (pmask ? PK_IND : PK_NONE);
        sKind[p] = (uint8_t)kd;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned m = __ballot_sync(H2_FULL_MASK, kd == k);
        if (lane == 0 && m) atomicAdd(&kcount[k], __popc(m));
      }
    }
    __syncthreads();
    // each kind's run padded to whole warps (a warp takes one loop)
    if (threadIdx.x == 0) {
      int at = 0;
      for (int k = 0; k < 4; ++k) {
        kfill[k] = at;
        at += (kcount[k] + 31) & ~31;
      }
      klen = at;
    }
    for (int t = threadIdx.x; t < CC + PS_PAD; t += blockDim.x)
      plist[t] = -1;
    __syncthreads();
    for (int p0 = wid * 32; p0 < CC; p0 += nwarp * 32) {
      const int p = p0 + lane;
      const int kd = p < CC ? sKind[p] : -1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned m = __ballot_sync(H2_FULL_MASK, kd == k);
        int at = 0;
        if (lane == 0 && m) at = atomicAdd(&kfill[k], __popc(m));
        at = __shfl_sync(H2_FULL_MASK, at, 0);
        if (kd == k) plist[at + __popc(m & lt)] = p;
      }
    }
    __syncthreads();
    // the warps take the list 32 pairs at a time as they finish (the costly
    // kinds first), so that none waits long on another
    for (int t0 = __shfl_sync(H2_FULL_MASK,
                              lane ? 0 : atomicAdd(&knext, 32), 0);
         t0 < klen;
         t0 = __shfl_sync(H2_FULL_MASK,
                          lane ? 0 : atomicAdd(&knext, 32), 0)) {
      const int p = plist[t0 + lane];
      if (p < 0) continue;
      const int pk = sKind[p];
      const int i = p / C, j = p - i * C;
      const int D = ps_sub(s.start[j], s.start[i]);
      const bool is_spl = D >= A.min_intron && D <= A.max_intron;
      const bool is_del = D >= 1 && D < A.min_intron;
      const bool is_ins = D <= -1 && D >= -A.gcap;
      const long long I = D < 0 ? -(long long)D : 0;
      const int gap_pen = is_del ? A.rd_go + A.rd_ge * D
                        : is_ins ? A.rf_go + A.rf_ge * (-D) : 0;
      const int shift = (is_ins && I <= A.V) ? (int)I : 0;
      const int* Pi = s.P + i * XS;     // splice joins: raw
      const int* Pj = s.P + j * XS;
      const int* Fi = s.Pi + i * XS;    // indel joins: SNV-forgiving
      const int* Fj = s.Pi + j * XS;
      const int16_t* Ri = s.Pr + i * XSh;
      const int16_t* Rj = s.Pr + j * XSh;
      int bk = INT_MIN, bt = INT_MAX;
      float bp = -2.0f;
      if (pk == PK_SPL || pk == PK_SPLX) {
        // x = L+1 never wins a splice pair: its key is -1, its probability
        // 0 and its tie key the largest.  (donor mask & acceptor mask) holds
        // the class and, in SP_OK, both sides' budget tests
        const int tot_j = Pj[L];
        const uint8_t* dki = s.dk + i * XSb;
        const uint8_t* akj = s.ak + j * XSb;
        const float* dpi = s.dpw + i * XS;
        const float* apj = s.apw + j * XS;
        // a step whose key is -1 and probability 0 loses to x = 0 (the same
        // or a better key, the lowest tie key), so only x = 0 and the steps
        // that score or are canonical are folded
        if (pk == PK_SPL) {
          // x scores on [1, xhi] where both budget tests hold
          const long long xh = min((long long)L, (long long)len - 1 - I);
          const int xhi = (int)max(xh, 0LL);
#pragma unroll 1
          for (int x = 0; x <= L; ++x) {
            const unsigned m = dki[x] & akj[x];
            const bool canonical = (m & (SP_CFW | SP_CRC)) != 0;
            const bool ok = x >= 1 && x <= xhi && (m & SP_OK);
            if (!(ok || canonical || x == 0)) continue;
            const float splsc = canonical ? sp_splsc(dpi[x], apj[x]) : 0.0f;
            const int score = -(Pi[x] + (tot_j - Pj[x])) -
                              (canonical ? A.pen_can : A.pen_noncan);
            ps_fold(ps_key(ok, (m & ~SP_OK) != 0 ? 1 : 0, score), splsc, x, bk,
                    bp, bt);
          }
        } else {
#pragma unroll 1
          for (int x = 0; x <= L; ++x) {
            const unsigned m = dki[x] & akj[x];
            if (m & (SP_CFW | SP_CRC))
              ps_fold(-1, sp_splsc(dpi[x], apj[x]), x, bk, bp, bt);
            else if (x == 0)
              ps_fold(-1, 0.0f, 0, bk, bp, bt);
          }
        }
      } else {
        const int totf_j = Fj[L], totr_j = Rj[L];
        if (pk == PK_IND) {
          const long long xh = min((long long)L, (long long)len - 1 - I);
          const int xhi = (int)max(xh, 0LL);
#pragma unroll 1
          for (int x = 0; x <= L + 1; ++x) {
            const int xi = min(x, L);         // past L the prefixes hold totals
            const int xs = min(x + shift, L);
            const int raw4 = Ri[xi] + (totr_j - Rj[xs]);
            const int score_ind = -(Fi[xi] + (totf_j - Fj[xs])) - gap_pen;
            ps_fold(ps_key(x >= 1 && x <= xhi, 0, score_ind), 0.0f,
                    raw4 * (L + 2) + x, bk, bp, bt);
          }
        } else {
          // every key -1, every probability 0: the lowest tie key
#pragma unroll 1
          for (int x = 0; x <= L + 1; ++x) {
            const int raw4 = Ri[min(x, L)] + (totr_j - Rj[min(x + shift, L)]);
            bt = min(bt, raw4 * (L + 2) + x);
          }
          bk = -1;
          bp = 0.0f;
        }
      }
      const int bx = is_spl ? bt : bt % (L + 2);
      const int bs = bk >= 0 ? (bk & ((1 << 23) - 1)) - (1 << 21) : -PS_BIG;
      bp = fmaxf(bp, 0.0f);
      // class at the chosen x (none past x = L: the one-hot take of
      // splice.py:286-297 reads code 0, AA)
      const unsigned mx = bx <= L ? s.dk[i * XSb + bx] & s.ak[j * XSb + bx] : 0;
      const int spldir = is_spl ? sp_dir(mx) : 0;
      const bool canonical = spldir == 1 || spldir == 2;
      const int kind = is_spl ? 1 : is_del ? 2 : is_ins ? 3 : 0;
      const int16_t* Pmi = s.Pm + i * XSh;
      const int16_t* Pmj = s.Pm + j * XSh;
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
      const int LP = A.LP;
      const int lenpen = canonical
          ? sp_lenpen(s.lp, s.lp + LP, A.nlp_can, D)
          : sp_lenpen(s.lp + 2 * LP, s.lp + 3 * LP, A.nlp_nc, D);
      int score = kind == 1 ? bs - lenpen : bs;
      if (kind == 1) ok = ok && spl_ok;
      const int raw = ok ? score : -PS_BIG;
      ok = ok && score >= minsc;
      score = ok ? score : -PS_BIG;
      sScore[p] = score;
      sRaw[p] = raw;
      sX[p] = (int16_t)bx;
      sDir[p] = (uint8_t)spldir;
      sSpl[p] = __float_as_int(bp);
    }
    __syncthreads();
    // the kinds (sKind held the sort keys until now)
    for (int p = threadIdx.x; p < CC; p += blockDim.x) {
      const int i = p / C, j = p - i * C;
      const int D = ps_sub(s.start[j], s.start[i]);
      sKind[p] = (uint8_t)((D >= A.min_intron && D <= A.max_intron) ? 1
                           : (D >= 1 && D < A.min_intron) ? 2
                           : (D <= -1 && D >= -A.gcap) ? 3 : 0);
    }
    __syncthreads();
    // the [6, N, C, C] planes, coalesced
    {
      const size_t NCC = (size_t)A.N * CC;
      int* o = A.res + (size_t)n * CC;
      for (int p = threadIdx.x; p < CC; p += blockDim.x) {
        o[p] = sScore[p];
        o[NCC + p] = sX[p];
        o[2 * NCC + p] = sKind[p];
        o[3 * NCC + p] = sDir[p];
        o[4 * NCC + p] = sSpl[p];
        o[5 * NCC + p] = sRaw[p];
      }
    }
    if (wid == 0) {
      // K14: the best (score desc, index asc) strictly after the previous
      // pick, `top` times
      int prev_v = INT_MAX, prev_p = -1;
      for (int r = 0; r < A.top; ++r) {
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
          A.sel[3 * NT + o] = s.start[i];
          A.sel[4 * NT + o] = s.start[j];
          A.sel[5 * NT + o] = sX[bpk];
          A.sel[6 * NT + o] = sKind[bpk];
          A.sel[7 * NT + o] = sDir[bpk];
          A.sel[8 * NT + o] = sSpl[bpk];
        }
        prev_v = bv;
        prev_p = bpk;
      }
    } else if (wid == 1) {
      // the base pairs of the second sweeps: the first raw argmax, then the
      // first argmax with it masked to -2^30
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
    __syncthreads();  // the next lane's tables overwrite these planes
  }
}

static bool ps_shape_ok(int C, int L, int W, int M, int LP) {
  return C >= 1 && L >= 1 && L <= SP_MAX_COLS && M >= 16 &&
         W == L + 2 * M && LP >= 1;
}

static cudaError_t ps_config(int C, int L, int W, int LP, bool snv,
                             long long N, size_t have, H2Staging* c) {
  return h2_staging(pair_sweep_kernel<false>, pair_sweep_kernel<true>,
                    PS_THREADS, 1, ps_smem_bytes(C, L, W, LP, snv), N, have,
                    c);
}

// The global scratch h2_pair_sweep needs for N lanes at these shapes (0:
// none, the planes fit the shared memory).
H2_EXPORT int h2_pair_sweep_scratch(int C, int L, int W, int LP,
                                    int use_snv, long long N,
                                    long long* bytes) {
  if (!ps_shape_ok(C, L, W, (W - L) / 2, LP))
    return (int)cudaErrorInvalidValue;
  H2Staging c;
  cudaError_t e = ps_config(C, L, W, LP, use_snv != 0, N, SIZE_MAX, &c);
  *bytes = (long long)c.scratch;
  return (int)e;
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
    void* scratch, long long scratch_bytes, void* stream) {
  if (!ps_shape_ok(C, L, W, M, LP) || top < 1 || top > C * C ||
      nlp_can < 1 || nlp_nc < 1 || nlp_can > LP || nlp_nc > LP)
    return (int)cudaErrorInvalidValue;
  PairArgs A{(const int*)ch, (const int*)reads, (const int*)quals,
             (const int*)lens, (const int*)starts, (const uint8_t*)valid,
             (const int*)minsc, (const int*)mm_pen, (const float*)pwm,
             (const int*)lp, n_text, N, C, L, W, M, n_pen, V, gcap, LP,
             nlp_can, nlp_nc, min_intron, max_intron, pen_can, pen_noncan,
             min_anchor, min_anchor_noncan, rd_go, rd_ge, rf_go, rf_ge, top,
             (const int*)s1w, (const int*)s2w, use_snv, (int*)res, (int*)sel,
             (int*)bsel};
  // past the shared memory, as many blocks as the scratch holds
  H2Staging c;
  cudaError_t e = ps_config(C, L, W, LP, use_snv != 0, N,
                            scratch ? (size_t)scratch_bytes : 0, &c);
  if (e != cudaSuccess) return (int)e;
  return (int)sp_launch(pair_sweep_kernel<false>, pair_sweep_kernel<true>,
                        PS_THREADS, ps_smem_bytes(C, L, W, LP, use_snv != 0),
                        c, A, scratch, stream);
}

// The launch of K13 at these shapes (sp_launch_info's out).
H2_EXPORT int h2_pair_sweep_info(int C, int L, int W, int LP, int use_snv,
                                 int* out) {
  return sp_launch_info(pair_sweep_kernel<false>, pair_sweep_kernel<true>,
                        PS_THREADS, ps_smem_bytes(C, L, W, LP, use_snv != 0),
                        out);
}
