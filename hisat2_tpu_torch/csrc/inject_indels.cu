// K10+K11: known ALT indel injection, with live_pen_prefix as warp sums
// over runs of columns (live_prefix.cuh).
//
// Replaces hisat2_tpu/ops/splice.py:inject_indels (:838-949) with
// ops/extend.py:live_pen_prefix (:124-222).  Plain twin:
// hisat2_tpu_torch/ops/splice.py:inject_indels_plain.
//
// A lane has J = 2 * slots * C injected slots, the left-keyed ones first
// (slot t*C + c: the t-th event at or after start + 1 in the table sorted
// by position), then the right-keyed ones (the same in the table sorted
// by position + length).  A slot is live when its event lies inside the
// read span of a valid candidate, inside the read's bounds once the
// insertion is skipped, and, for an insertion, the skipped read chars
// are its allele: a few per cent of the slots at catalog density.  A
// block takes a tile of lanes and works in two phases.
//
// 1. Probe: a thread per (lane, candidate, side).  It runs one
//    lower-bound search of ip or rkey for start + 1 and reads `slots`
//    consecutive rows; JAX too searches once and adds t (splice.py:864,
//    :878).  For each slot it forms x, the fresh diagonal, the insertion
//    length, the event and the gates above (the allele check reads at
//    most INJ_MAX_INS chars), and writes d1, d2, x, src and the zero
//    spldir / splscore planes; a dead slot also gets a dead slot's score,
//    kind and event (JAX's d1 / d2 / x of a dead slot stay: pack_slots
//    reads them).  Each live slot goes onto a work list in shared memory,
//    a warp's slots by one ballot and one atomic.
// 2. Walk: a warp per listed slot.  Its score is two sums over runs of
//    the read's columns: left-keyed, the source window's penalty below x
//    and the fresh diagonal's from x + I (I the insertion's length) to
//    the read's end; right-keyed, the fresh diagonal below x and the
//    source from x + I to the end.  The fresh diagonal's chars come from
//    the packed reference and SNV planes, the source's from the windows.
//    The lanes take a run's columns 32 apart, so the read, its qualities
//    and the window load coalesced and a packed word serves 16 columns of
//    the warp; the lanes' shares of both runs are added and reduced once,
//    in uint32 so that the score wraps as JAX's int32 does (past ~21,475
//    out-of-text columns).  So a live slot reads about len - I columns
//    once.  Then the minsc gate, and the slot's score, kind and event.
//    Positions wrap as unsigned int32, as JAX's.  The list is walked when
//    it could overflow in the next round of probes (within a round only
//    past 4 slots a candidate) and at the end of the tile.
//
// Bound: bytes.  The outputs (9 int32 planes [N, J]) dominate; then the
// per-candidate inputs, the probes' table rows (the tables sit in L2), and
// the read, qualities and windows of the live slots only.  The probes cost
// one ~log2(E) chain of dependent table loads per (lane, candidate, side).
#include "live_prefix.cuh"

#define INJ_MAX_INS 16
#define INJ_BIG (1 << 30)
#define INJ_THREADS 256
// work-list entries of a block: a round of probes adds at most one a thread
// for each of its slots
#define INJ_CAP (4 * INJ_THREADS)

struct InjArgs {
  const uint32_t* ref_words;
  const uint32_t* snv1;
  const uint32_t* snv2;
  const int* reads;
  const int* quals;
  const int* lens;
  const int* starts;
  const uint8_t* valid;
  const int* ch;   // [N, C, W] windows of the source diagonals
  const int* s1w;
  const int* s2w;
  const int* ip;   // [E] event positions, sorted, 2^30-padded
  const int* ilen;
  const int* ins_chars;  // [E, INJ_MAX_INS]
  const int* rkey;       // [E] ip + ilen, sorted, 2^30-padded
  const int* r_ilen;
  const int* r_row;
  const int* mm_pen;
  const int* minsc;
  long long n_text;
  int n_ref, n_snv, N, C, L, W, margin, E, slots, n_pen;
  int* score;  // [N, J] each
  int* d1;
  int* d2;
  int* x;
  int* kind;
  int* event;
  int* src;
  int* spldir;
  int* splscore;  // float32 0.0 bits
};

__device__ __forceinline__ int inj_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int inj_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// first index i in [0, E) with tab[i] >= v, else E
__device__ __forceinline__ int inj_lower_bound(const int* tab, int E, int v) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(tab + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One live slot (lane n, slot j, junction position x, fresh diagonal,
// event ev), walked by the whole warp; lane 0 writes its score, kind and
// event.
__device__ void inj_walk_slot(const InjArgs& A, const int* mm_pen, int n,
                              int j, int x, int fresh, int ev, int lane) {
  const int C = A.C, J1 = A.slots * C, J = 2 * J1, L = A.L;
  const bool left = j < J1;
  const int jj = left ? j : j - J1;
  const int c = jj - (jj / C) * C;
  const size_t nc = (size_t)n * C + c;
  const int st = A.starts[nc];
  const int len = A.lens[n];
  const int lim = min(len, L);     // columns past the read add nothing
  // the event's signed length (+del / -ins) back from the fresh diagonal
  const int elen = left ? inj_sub(fresh, st) : inj_sub(st, fresh);
  const int I = max(inj_sub(0, elen), 0);
  const int xr = min(inj_add(x, I), L);
  const int* rd = A.reads + (size_t)n * L;
  const int* qs = A.quals + (size_t)n * L;
  const size_t wo = nc * A.W + A.margin;
  const H2WindowChars sw{A.ch + wo, A.s1w ? A.s1w + wo : nullptr,
                         A.s2w ? A.s2w + wo : nullptr};
  const H2WordChars fw{A.ref_words, A.snv1, A.snv2, A.n_ref, A.n_snv,
                       A.n_text, (long long)fresh};
  // left-keyed: source below x, fresh from x + I to the end;
  // right-keyed: fresh below x, source from x + I to the end
  unsigned s;
  if (left)
    s = h2_lane_pen_run(rd, qs, len, 0, min(x, lim), (long long)st,
                        A.n_text, mm_pen, A.n_pen, sw, lane) +
        h2_lane_pen_run(rd, qs, len, max(xr, 0), lim, (long long)fresh,
                        A.n_text, mm_pen, A.n_pen, fw, lane);
  else
    s = h2_lane_pen_run(rd, qs, len, 0, min(x, lim), (long long)fresh,
                        A.n_text, mm_pen, A.n_pen, fw, lane) +
        h2_lane_pen_run(rd, qs, len, max(xr, 0), lim, (long long)st,
                        A.n_text, mm_pen, A.n_pen, sw, lane);
  s = __reduce_add_sync(H2_FULL_MASK, s);
  const int score = (int)(0u - s);
  const bool ok = score >= A.minsc[n];
  if (lane == 0) {
    const size_t k = (size_t)n * J + j;
    A.score[k] = ok ? score : -INJ_BIG;
    A.kind[k] = ok ? (elen > 0 ? 2 : 3) : 0;  // KIND_DEL, KIND_INS, NONE
    A.event[k] = ok ? ev : -1;
  }
}

// The warps of the block walk the listed slots in turn.
__device__ __forceinline__ void inj_walk_list(const InjArgs& A,
                                              const int* mm_pen,
                                              const int4* list,
                                              const int* evs, int count) {
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < count; e += INJ_THREADS / 32) {
    const int4 s = list[e];
    inj_walk_slot(A, mm_pen, s.x, s.y, s.z, s.w, evs[e], lane);
  }
}

__global__ void __launch_bounds__(INJ_THREADS)
    inject_indels_kernel(InjArgs A, int tile) {
  __shared__ int4 s_list[INJ_CAP];
  __shared__ int s_ev[INJ_CAP];
  __shared__ int s_mm[64];
  __shared__ int s_count;
  const int C = A.C, J1 = A.slots * C, J = 2 * J1, E = A.E, L = A.L;
  const int items = 2 * C * tile;
  const int lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * tile;
  if (threadIdx.x < 64) s_mm[threadIdx.x] = A.mm_pen[threadIdx.x];
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  // walks the list where it holds more than `limit` slots (every thread
  // calls it)
  auto flush_if = [&](int limit) {
    __syncthreads();
    const int count = s_count;
    __syncthreads();   // read by all before the next appends
    if (count > limit) {
      inj_walk_list(A, s_mm, s_list, s_ev, count);
      if (threadIdx.x == 0) s_count = 0;
      __syncthreads();
    }
  };
  // a round of probes adds at most one slot a thread for each t, so the
  // list can fill within a round only past INJ_CAP / INJ_THREADS slots
  const bool tight = A.slots * INJ_THREADS > INJ_CAP;
  for (int base = 0; base < items; base += INJ_THREADS) {
    // item -> (lane of the tile, side, candidate): neighbouring threads
    // take neighbouring candidates, whose slots are neighbours in a plane
    const int it = base + threadIdx.x;
    const int ln = it / (2 * C);
    const int side = (it - ln * 2 * C) / C;
    const int c = it - ln * 2 * C - side * C;
    const int n = n0 + ln;
    const bool have = it < items && n < A.N;
    const bool left = side == 0;
    const int* tab = left ? A.ip : A.rkey;
    int st = 0, len = 0, key = 0, lo = 0;
    bool valid = false;
    if (have) {
      st = A.starts[(size_t)n * C + c];
      valid = A.valid[(size_t)n * C + c] != 0;
      len = A.lens[n];
      key = inj_add(st, 1);
      lo = inj_lower_bound(tab, E, key);
    }
    for (int t = 0; t < A.slots; ++t) {
      bool ok = false;
      int j = 0, x = 1, fresh = 0, ev = 0;
      if (have) {
        const int idx = min(lo + t, E - 1);
        const int tv = __ldg(tab + idx);
        const bool okd = lo + t < E && valid && tv >= key &&
                         tv <= inj_add(st, len - 1);
        x = okd ? inj_sub(tv, st) : 1;
        const int elen = left ? __ldg(A.ilen + idx) : __ldg(A.r_ilen + idx);
        fresh = left ? inj_add(st, elen) : inj_sub(st, elen);
        ev = left ? idx : __ldg(A.r_row + idx);
        const int I = max(inj_sub(0, elen), 0);
        ok = okd && x >= 1 && inj_add(x, I) <= len - 1;
        if (ok && elen <= 0) {  // insertion: the skipped chars, the allele
          const int* rd = A.reads + (size_t)n * L;
          const int* al = A.ins_chars + (size_t)max(ev, 0) * INJ_MAX_INS;
          for (int q = 0; q < I && q < INJ_MAX_INS; ++q)
            if (rd[min(x + q, L - 1)] != __ldg(al + q)) ok = false;
        }
        j = side * J1 + t * C + c;
        const size_t k = (size_t)n * J + j;
        A.d1[k] = left ? st : fresh;
        A.d2[k] = left ? fresh : st;
        A.x[k] = x;
        A.src[k] = c;
        A.spldir[k] = 0;
        A.splscore[k] = 0;
        if (!ok) {
          A.score[k] = -INJ_BIG;
          A.kind[k] = 0;
          A.event[k] = -1;
        }
      }
      // the warp's live slots onto the list: one ballot, one atomic
      const unsigned bal = __ballot_sync(H2_FULL_MASK, ok);
      if (bal != 0) {
        const int leader = __ffs(bal) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&s_count, __popc(bal));
        at = __shfl_sync(H2_FULL_MASK, at, leader);
        if (ok) {
          const int e = at + __popc(bal & ((1u << lane) - 1u));
          s_list[e] = make_int4(n, j, x, fresh);
          s_ev[e] = ev;
        }
      }
      if (tight) flush_if(INJ_CAP - INJ_THREADS);
    }
    if (!tight) flush_if(INJ_CAP - A.slots * INJ_THREADS);
  }
  inj_walk_list(A, s_mm, s_list, s_ev, s_count);
}

H2_EXPORT int h2_inject_indels(
    const void* ref_words, const void* snv1, const void* snv2,
    const void* reads, const void* quals, const void* lens,
    const void* starts, const void* valid, const void* ch, const void* s1w,
    const void* s2w, const void* ip, const void* ilen, const void* ins_chars,
    const void* rkey, const void* r_ilen, const void* r_row,
    const void* mm_pen, const void* minsc, long long n_text, int n_ref,
    int n_snv, int N, int C, int L, int W, int margin, int E, int slots,
    int n_pen, void* score, void* d1, void* d2, void* x, void* kind,
    void* event, void* src, void* spldir, void* splscore, void* stream) {
  if (E < 1 || C < 1 || L < 1 || slots < 1 || W < L + 2 * margin)
    return (int)cudaErrorInvalidValue;
  InjArgs A{(const uint32_t*)ref_words, (const uint32_t*)snv1,
            (const uint32_t*)snv2, (const int*)reads, (const int*)quals,
            (const int*)lens, (const int*)starts, (const uint8_t*)valid,
            (const int*)ch, (const int*)s1w, (const int*)s2w,
            (const int*)ip, (const int*)ilen, (const int*)ins_chars,
            (const int*)rkey, (const int*)r_ilen, (const int*)r_row,
            (const int*)mm_pen, (const int*)minsc, n_text, n_ref, n_snv, N,
            C, L, W, margin, E, slots, n_pen, (int*)score, (int*)d1,
            (int*)d2, (int*)x, (int*)kind, (int*)event, (int*)src,
            (int*)spldir, (int*)splscore};
  // a tile of lanes fills the block's threads with (lane, candidate,
  // side) items; past 128 candidates a lane's items take several rounds
  const int tile = max(1, INJ_THREADS / (2 * C));
  const long long blocks = ((long long)N + tile - 1) / tile;
  if (blocks > 0)
    inject_indels_kernel<<<(unsigned)blocks, INJ_THREADS, 0,
                           (cudaStream_t)stream>>>(A, tile);
  return (int)cudaGetLastError();
}
