// K16: known / temp splice-site injection.
//
// Replaces hisat2_tpu/ops/splice.py:inject_known (:629) with
// table_searchsorted (:192, site_search.cuh) and, for the fresh diagonal,
// ops/extend.py:live_pen_prefix (:124, live_prefix.cuh:h2_warp_pen_prefix;
// K10, inject_indels.cu, has the same two phases).
// Plain twin: hisat2_tpu_torch/ops/splice.py:inject_known_ref.
//
// A lane has J = 2 * slots * C injected slots, the donor-keyed ones first
// (slot t*C + c: the t-th site whose donor lies in candidate c's read
// span), then the acceptor-keyed ones.  A slot is live when its site is
// visible (a temp site is seen only by later reads) and lies inside the
// read span of a valid candidate: a few per cent of the slots.  A block
// takes a tile of lanes and works in two phases.
//
// 1. Probe: a thread per (lane, candidate, side).  It searches the sorted
//    table once (bucket index when there is one) and reads its `slots`
//    consecutive rows; JAX too searches once and adds t (splice.py:666,
//    :681).  For each slot it forms the junction position x, the fresh
//    diagonal and the junction class from four reference chars, and
//    writes d1, d2, x, spldir and src; a dead slot also gets a dead
//    slot's score, kind and clips (JAX's d1 / d2 / x of a dead slot stay:
//    pack_slots reads them).  Each live slot goes onto a work list in
//    shared memory, a warp's slots by one ballot and one atomic.
// 2. Walk: a warp per listed slot.  Every gate reads sums over runs of
//    the read's columns: the source diagonal's (SNV-forgiving) penalty
//    below x, x - 1 and the inherited clip bounds, the clip cost below
//    them, and the fresh diagonal's penalty and raw mismatches on the
//    other side of x (h2_warp_pen_prefix).  The lanes take the run's
//    columns 32 apart, so the read, its qualities and the window load
//    coalesced and a packed reference word serves 16 columns of the
//    warp; each sum is one warp reduction of the lanes' partial sums,
//    in uint32 so that it wraps as JAX's int32 does.  Then the
//    donor-coverage gate (always on), the bounds, the anchor-purity gate
//    (mismatches <= anchor / 4), the minsc gate and the clip rule, and
//    the live slot's score, kind and clips.  Positions wrap as unsigned
//    int32, as JAX's.  The list is walked when it could overflow in the
//    next round of probes (within a round only past 4 slots a candidate)
//    and at the end of the tile.
//
// Bound: bytes.  The outputs (9 int32 planes [N, J]) dominate; then the
// per-candidate inputs, the probes' table rows (the tables sit in L2), and
// the read, qualities and windows of the live slots only.  The probes cost
// one ~log2(S) chain of dependent table loads per (lane, candidate, side).
#include "live_prefix.cuh"
#include "site_search.cuh"

#define IK_BIG (1 << 30)
#define IK_THREADS 256
// work-list entries of a block: a round of probes adds at most one a thread
#define IK_CAP (4 * IK_THREADS)

struct KnownArgs {
  const uint32_t* ref;
  const int* reads;
  const int* quals;
  const int* lens;
  const int* rdids;
  const int* starts;
  const uint8_t* valid;
  const int* ch;       // [N, C, W]
  const int* mm_pen;
  const int* clip_pen;
  const int* minsc;
  const int* clip_l;   // [N, C] the candidates' ungapped clips
  const int* clip_r;
  H2Sites st;
  const int* s1w;      // [N, C, W] SNV-plane windows (graph index only)
  const int* s2w;
  const uint32_t* snv1;  // packed SNV planes (graph index only)
  const uint32_t* snv2;
  long long n_text;
  int n_ref, n_snv, use_snv, N, C, L, W, M, slots, n_pen;
  int* out;            // [9, N, J]: score d1 d2 x kind spldir clip_l clip_r src
};

__device__ __forceinline__ int ik_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// The junction class of the site from its flanking dinucleotides.
__device__ __forceinline__ int ik_spldir(const KnownArgs& A, int d1, int d2,
                                         int x) {
  const int jl = ik_add(d1, x);
  const int jr = ik_add(ik_add(d2, x), -1);
  const int c0 = h2_packed_char(A.ref, A.n_ref, A.n_text, (long long)jl);
  const int c1 = h2_packed_char(A.ref, A.n_ref, A.n_text,
                                (long long)ik_add(jl, 1));
  const int c2 = h2_packed_char(A.ref, A.n_ref, A.n_text,
                                (long long)ik_add(jr, -1));
  const int c3 = h2_packed_char(A.ref, A.n_ref, A.n_text, (long long)jr);
  const int dl = (c0 < 4 && c1 < 4) ? c0 * 16 + c1 : 255;
  const int ar = (c2 < 4 && c3 < 4) ? c2 * 16 + c3 : 255;
  const bool cfw = dl == 0x23 && ar == 0x02;
  const bool crc = dl == 0x13 && ar == 0x01;
  const bool sfw = (dl == 0x21 && ar == 0x02) || (dl == 0x03 && ar == 0x01);
  const bool src_ = (dl == 0x13 && ar == 0x21) || (dl == 0x20 && ar == 0x03);
  return cfw ? 1 : crc ? 2 : sfw ? 3 : src_ ? 4 : 0;
}

// One live slot (lane n, slot j, junction position x, fresh diagonal),
// walked by the whole warp; lane 0 writes its score, kind and clips.
__device__ void ik_walk_slot(const KnownArgs& A, const int* mm_pen,
                             const int* clip_pen, int n, int j, int x,
                             int fresh, int lane) {
  const int C = A.C, J1 = A.slots * C, J = 2 * J1, L = A.L;
  const bool donor = j < J1;
  const int jj = donor ? j : j - J1;
  const int c = jj - (jj / C) * C;
  const size_t nc = (size_t)n * C + c;
  const int st = A.starts[nc];
  const int len = A.lens[n];
  const int lim = min(len, L);     // columns past the read add nothing
  const int* rd = A.reads + (size_t)n * L;
  const int* qs = A.quals + (size_t)n * L;
  const bool snv = A.use_snv != 0;
  const size_t wo = nc * A.W + A.M;
  const int* w = A.ch + wo;
  const int* v1w = snv ? A.s1w + wo : nullptr;
  const int* v2w = snv ? A.s2w + wo : nullptr;
  const int x_m1 = max(x - 1, 0);
  const int cl_src = A.clip_l[nc];
  const int cr_src = A.clip_r[nc];
  const int cl_d = cl_src < x ? cl_src : 0;
  const int cr_a = (len - cr_src) > x ? cr_src : 0;
  const int hi_cr = len - cr_a;
  // the source diagonal's (SNV-forgiving) penalty at one column
  auto src_pen = [&](int col) {
    const long long pos = (long long)st + col;
    const bool oob = pos < 0 || pos >= A.n_text;
    unsigned pen, mi;
    h2_col_pen(rd[col], qs[col], w[col], snv ? v1w[col] : 0,
               snv ? v2w[col] : 0, true, oob, mm_pen, A.n_pen, pen, mi);
    return pen;
  };
  const H2WordChars fw{A.ref, snv ? A.snv1 : nullptr, snv ? A.snv2 : nullptr,
                       A.n_ref, A.n_snv, A.n_text, (long long)fresh};
  // A walked slot has 1 <= x <= len - 1 and 0 <= cl_d < x < hi_cr.  A
  // prefix at a position outside [0, L] reads 0, as in the column walk
  // of the kernel this one replaces (a negative clip).
  unsigned r0 = 0, r1 = 0, r2 = 0;
  int score, mm_new, anchor_new, lpad, out_cl = 0, out_cr = 0;
  if (donor) {
    // source below x: [cl_d, x) into the score, x - 1 the coverage gate,
    // the clip cost below cl_d; fresh from x to the read's end
    const bool cl_in = cl_d >= 0;
    for (int col = lane; col < min(x, lim); col += 32) {
      const unsigned p = src_pen(col);
      const bool clipped = cl_in && col < cl_d;
      r0 += clipped ? 0u : p;
      r1 += col >= x_m1 ? p : 0u;
      r2 += clipped ? (unsigned)clip_pen[min(qs[col], 63)] : 0u;
    }
    const H2PenSums f = h2_warp_pen_prefix(rd, qs, len, x, lim,
                                           (long long)fresh, A.n_text,
                                           mm_pen, A.n_pen, 0, 0, fw, lane);
    r0 = __reduce_add_sync(H2_FULL_MASK, r0);
    r1 = __reduce_add_sync(H2_FULL_MASK, r1);
    r2 = __reduce_add_sync(H2_FULL_MASK, r2);
    score = (int)(0u - (r0 + r2 + f.tot_pen));
    mm_new = (int)f.tot_mm;
    anchor_new = len - x;
    lpad = (int)r1;
    out_cl = cl_d;
  } else {
    // fresh below x (x - 1 the coverage gate); source from x to hi_cr;
    // the clip cost below cr_a
    const H2PenSums f = h2_warp_pen_prefix(rd, qs, len, 0, min(x, lim),
                                           (long long)fresh, A.n_text,
                                           mm_pen, A.n_pen, x_m1, 0, fw,
                                           lane);
    if (hi_cr <= L) {
      for (int col = x + lane; col < min(hi_cr, lim); col += 32)
        r0 += src_pen(col);
    } else {
      for (int col = lane; col < min(x, lim); col += 32) r0 -= src_pen(col);
    }
    if (cr_a >= 0 && cr_a <= L)
      for (int col = lane; col < min(cr_a, lim); col += 32)
        r1 += (unsigned)clip_pen[min(qs[col], 63)];
    r0 = __reduce_add_sync(H2_FULL_MASK, r0);
    r1 = __reduce_add_sync(H2_FULL_MASK, r1);
    score = (int)(0u - (f.tot_pen + r0 + r1));
    mm_new = (int)f.tot_mm;
    anchor_new = x;
    lpad = (int)(f.tot_pen - f.pen_at[0]);
    out_cr = cr_a;
  }
  const int d1 = donor ? st : fresh;
  const int d2 = donor ? fresh : st;
  const bool ok = lpad == 0 && x >= 1 && x <= len - 1 && d2 > d1 &&
                  mm_new <= h2_floordiv(anchor_new, 4) &&
                  score >= A.minsc[n] && out_cl < x && out_cr < len - x;
  if (lane == 0) {
    const size_t NJ = (size_t)A.N * J;
    int* o = A.out + (size_t)n * J + j;
    o[0] = ok ? score : -IK_BIG;
    o[4 * NJ] = ok ? 1 : 0;   // KIND_SPL / KIND_NONE
    o[6 * NJ] = ok ? out_cl : 0;
    o[7 * NJ] = ok ? out_cr : 0;
  }
}

// The warps of the block walk the listed slots in turn.
__device__ __forceinline__ void ik_walk_list(const KnownArgs& A,
                                             const int* mm_pen,
                                             const int* clip_pen,
                                             const int4* list, int count) {
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < count; e += IK_THREADS / 32) {
    const int4 s = list[e];
    ik_walk_slot(A, mm_pen, clip_pen, s.x, s.y, s.z, s.w, lane);
  }
}

__global__ void __launch_bounds__(IK_THREADS)
    inject_known_kernel(KnownArgs A, int tile) {
  __shared__ int4 s_list[IK_CAP];
  __shared__ int s_mm[64], s_clip[64];
  __shared__ int s_count;
  const int C = A.C, J1 = A.slots * C, J = 2 * J1, S = A.st.S;
  const int items = 2 * C * tile;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * tile;
  const size_t NJ = (size_t)A.N * J;
  if (threadIdx.x < 64) {
    s_mm[threadIdx.x] = A.mm_pen[threadIdx.x];
    s_clip[threadIdx.x] = A.clip_pen[threadIdx.x];
  }
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  // walks the list where it holds more than `limit` slots (every thread
  // calls it)
  auto flush_if = [&](int limit) {
    __syncthreads();
    const int count = s_count;
    __syncthreads();   // read by all before the next appends
    if (count > limit) {
      ik_walk_list(A, s_mm, s_clip, s_list, count);
      if (threadIdx.x == 0) s_count = 0;
      __syncthreads();
    }
  };
  // a round of probes adds at most one slot a thread for each t, so the
  // list can fill within a round only past IK_CAP / IK_THREADS slots
  const bool tight = A.slots * IK_THREADS > IK_CAP;
  for (int base = 0; base < items; base += IK_THREADS) {
    // item -> (lane of the tile, side, candidate): neighbouring threads
    // take neighbouring candidates, whose slots are neighbours in a plane
    const int it = base + threadIdx.x;
    const int ln = it / (2 * C);
    const int side = (it - ln * 2 * C) / C;
    const int c = it - ln * 2 * C - side * C;
    const int n = n0 + ln;
    const bool have = it < items && n < A.N;
    const bool donor = side == 0;
    int st = 0, len = 0, rdid = 0, lo = 0;
    bool valid = false;
    if (have) {
      st = A.starts[(size_t)n * C + c];
      valid = A.valid[(size_t)n * C + c] != 0;
      len = A.lens[n];
      rdid = A.rdids[n];
      lo = donor ? h2_table_searchsorted(A.st.kd, S, A.st.kd_lob, A.st.NB,
                                         A.st.shift, st)
                 : h2_table_searchsorted(A.st.ka_s, S, A.st.ka_lob,
                                         A.st.NB, A.st.shift, ik_add(st, 1));
    }
    for (int t = 0; t < A.slots; ++t) {
      bool ok = false;
      int j = 0, x = 1, fresh = 0;
      if (have) {
        const int idx = min(lo + t, S - 1);
        if (donor) {
          const int kv = __ldg(A.st.kd + idx), srd = __ldg(A.st.rdid + idx);
          ok = lo + t < S && valid && kv >= st &&
               kv <= ik_add(st, len - 2) && (srd < 0 || srd < rdid);
          x = ok ? ik_add(ik_add(kv, -st), 1) : 1;
          fresh = ik_add(__ldg(A.st.ka + idx), -x);
        } else {
          const int q = ik_add(st, 1);
          const int kv = __ldg(A.st.ka_s + idx),
                    srd = __ldg(A.st.rdid_a + idx);
          ok = lo + t < S && valid && kv >= q &&
               kv <= ik_add(st, len - 1) && (srd < 0 || srd < rdid);
          x = ok ? ik_add(kv, -st) : 1;
          fresh = ik_add(ik_add(__ldg(A.st.kd_s + idx), -x), 1);
        }
        j = side * J1 + t * C + c;
        const int d1 = donor ? st : fresh;
        const int d2 = donor ? fresh : st;
        int* o = A.out + (size_t)n * J + j;
        o[NJ] = d1;
        o[2 * NJ] = d2;
        o[3 * NJ] = x;
        o[5 * NJ] = ik_spldir(A, d1, d2, x);
        o[8 * NJ] = c;
        if (!ok) {
          o[0] = -IK_BIG;
          o[4 * NJ] = 0;
          o[6 * NJ] = 0;
          o[7 * NJ] = 0;
        }
      }
      // the warp's live slots onto the list: one ballot, one atomic
      const unsigned bal = __ballot_sync(H2_FULL_MASK, ok);
      if (bal != 0) {
        const int leader = __ffs(bal) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&s_count, __popc(bal));
        at = __shfl_sync(H2_FULL_MASK, at, leader);
        if (ok)
          s_list[at + __popc(bal & ((1u << lane) - 1u))] =
              make_int4(n, j, x, fresh);
      }
      if (tight) flush_if(IK_CAP - IK_THREADS);
    }
    if (!tight) flush_if(IK_CAP - A.slots * IK_THREADS);
  }
  ik_walk_list(A, s_mm, s_clip, s_list, s_count);
}

H2_EXPORT int h2_inject_known(
    const void* ref, const void* reads, const void* quals, const void* lens,
    const void* rdids, const void* starts, const void* valid, const void* ch,
    const void* mm_pen, const void* clip_pen, const void* minsc,
    const void* clip_l, const void* clip_r, const void* kd, const void* ka,
    const void* rdid, const void* ka_s, const void* kd_s,
    const void* rdid_a, const void* kd_lob, const void* ka_lob, int shift,
    int S, int NB, const void* s1w, const void* s2w, const void* snv1,
    const void* snv2, long long n_text, int n_ref, int n_snv, int use_snv,
    int N, int C, int L, int W, int M, int slots, int n_pen, void* out,
    void* stream) {
  if (C < 1 || L < 1 || slots < 1 || S < 1 || W != L + 2 * M)
    return (int)cudaErrorInvalidValue;
  H2Sites st{(const int*)kd, (const int*)ka, (const int*)rdid,
             (const int*)ka_s, (const int*)kd_s, (const int*)rdid_a,
             (const int*)kd_lob, (const int*)ka_lob, shift, S, NB};
  KnownArgs A{(const uint32_t*)ref, (const int*)reads, (const int*)quals,
              (const int*)lens, (const int*)rdids, (const int*)starts,
              (const uint8_t*)valid, (const int*)ch, (const int*)mm_pen,
              (const int*)clip_pen, (const int*)minsc, (const int*)clip_l,
              (const int*)clip_r, st, (const int*)s1w, (const int*)s2w,
              (const uint32_t*)snv1, (const uint32_t*)snv2, n_text, n_ref,
              n_snv, use_snv, N, C, L, W, M, slots, n_pen, (int*)out};
  // a tile of lanes fills the block's threads with (lane, candidate,
  // side) items; past 128 candidates a lane's items take several rounds
  const int tile = max(1, IK_THREADS / (2 * C));
  const long long blocks = ((long long)N + tile - 1) / tile;
  if (blocks > 0)
    inject_known_kernel<<<(unsigned)blocks, IK_THREADS, 0,
                          (cudaStream_t)stream>>>(A, tile);
  return (int)cudaGetLastError();
}
