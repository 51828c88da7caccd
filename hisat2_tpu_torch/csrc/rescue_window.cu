// K12: the top 8 diagonals of a mate-rescue window, as an int8 one-hot
// product on the tensor cores.
//
// Replaces the cross-correlation and top_k of
// hisat2_tpu/ops/rescue.py:rescue_candidates (:25, :39-59): for job r with
// window start ws = win_start[r] and read reads[r, :L],
//   matches[d] = sum_t [read[t] == ref[ws + d + t]],  d in [0, W),
// where a read code 4 (N, padding) and a position outside [0, n_text)
// match nothing; each count is rounded to the nearest bfloat16 value
// (ties to even), as the JAX one-hot convolution on bf16 inputs returns
// it, and the 8 largest are kept in lax.top_k's order: count descending,
// then d ascending.  out[r, i] = ws + d_i.  The rescoring of those 8
// diagonals is K5 and K6+K7 (ops/rescue.py).
// Plain twin: hisat2_tpu_torch/ops/rescue.py:rescue_window_plain.
//
// Bound: operations.  The JAX original is a one-hot product, 2 * 4 * W * L
// operations a job (~46 M at L = 100, W = 57,344) against ~0.1 MB of
// window and read: a 128-job chunk needs 0.0030 ms at the int8 tensor-core
// rate (0.0059 at bf16's).  So the product runs on the tensor cores, in
// its Toeplitz form: with d = 16 i + j, j in [0, 16), and u = j + t,
//   matches[16 i + j] = sum_{u, c} A[j, (u, c)] B[(u, c), i],
//   A[j, (u, c)] = [read[u - j] == c],  B[(u, c), i] = [ref[ws + 16 i + u] == c],
// an s8 x s8 -> s32 product by mma.sync m16n8k32 with K = 4 (L + 15)
// (chars x channels), whose integer sum is exact, so the bf16 step sees
// the true count.  A, the read, is the same for every window column: a
// warp builds its fragments once per read chunk, in registers.  B, the
// window, is staged as one-hot words (a byte a channel, 0 outside the
// text) in shared memory; a k-step is 8 consecutive chars of a column, so
// a thread's two B registers are two words.  An n-tile k takes the
// unit's columns 7 c + k (c < 8), so a thread's tiles k and k + 1 read
// the same words two steps apart: 27 pairs of loads feed its 105
// products; an XOR of bits 2-4 of the char index by bits 4-6 puts a
// warp's 32 loads on 32 banks (and a staging store of 4 chars on
// distinct bank groups).  Long mates are cut into read chunks of 104
// chars (15 k-steps of 8 chars hold a chunk and the 15 columns of its
// band); the accumulators carry across them.
//
// Grid: a unit is 896 diagonals (7 n-tiles of 8 columns); a block is one
// warp, which walks RW_UPB consecutive units of one job, the next unit's
// window loaded while this one runs, so no block waits on a barrier and a
// block's tail holds only its own warp.  Each count's key in the block is
// its code (rw_rank16) << 16 | (0xFFFF - its diagonal in the block).  On
// its first unit the warp keeps the keys at or above the 8th largest of
// its lanes' largest keys (8 lanes hold one at least as large; ~8-16 of
// 896) and sorts them by shuffles; on a later unit only a count whose
// code beats the list's 8th can enter (units come in diagonal order),
// which the lanes' largest counts decide for the whole unit, and the few
// that do are sorted in with the list.  A job's blocks write their lists
// to a scratch, and the last to finish (an atomic ticket a job,
// acquire-release) merges them the same way and resets the ticket, so
// the tickets stay zero across calls and CUDA-graph replays.  A job
// whose read has no ACGT column (the power-of-two padding of a rescue
// chunk) counts 0 on every diagonal: its answer is ws + 0..7, which it
// writes without a product.
//
// Measured on an H100 (PERF.md): 0.030 ms for a 128-job chunk at L =
// 100 against 0.074 for the CUDA-core kernel it replaced, 10x the int8
// bound: mma.sync issues the products below the int8 peak, and the
// warps' epilogues and staging run beside them.
#include <cuda/atomic>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int RW_THREADS = 32;                    // a block is one warp
constexpr int RW_UPB = 4;                         // units a block
constexpr int RW_MINB = 16;                       // blocks an SM
constexpr int RW_TOP = 8;
constexpr int RW_J = 16;                          // diagonals a column
constexpr int RW_TPW = 7;                         // n-tiles a unit
constexpr int RW_WCOLS = RW_TPW * 8;              // 56 columns a unit
constexpr int RW_UNIT = RW_WCOLS * RW_J;          // 896 diagonals a unit
constexpr int RW_KS = 15;                         // k-steps a read chunk
constexpr int RW_LC = 104;                        // read chars a chunk
// a unit's staged window chars: 16 * (RW_WCOLS - 1) + 8 * RW_KS, rounded
// up to the swizzle's 128-char period, in groups of 16 chars, two a lane
constexpr int RW_WIN = (16 * (RW_WCOLS - 1) + 8 * RW_KS + 127) / 128 * 128;
constexpr int RW_RD = 8 * RW_KS + RW_J;           // read chars -16..119
static_assert(RW_LC + RW_J - 1 <= 8 * RW_KS, "a chunk and its band");
static_assert(RW_WIN == 64 * 16, "two window groups a lane");
static_assert(RW_UNIT <= RW_WIN, "a unit's candidates in its window");
static_assert(RW_UPB * RW_UNIT <= 65536, "a block's diagonals in 16 bits");

// A 16-bit code of a match count rounded to the nearest bfloat16 value,
// ties to even, that orders as the rounded counts do: the count itself
// below 256 (exact in bfloat16), else its bfloat16 bits less those of 256
// (0x4380), plus 256.
__device__ __forceinline__ uint32_t rw_rank16(int c) {
  if (c < 256) return (uint32_t)c;
  return __bfloat16_as_ushort(__float2bfloat16_rn(__int2float_rn(c))) -
         0x4280u;
}

// Insert key into a descending list of 8 (keys are unique or 0 = empty).
template <typename K>
__device__ __forceinline__ void top8_insert(K (&best)[8], K key) {
#pragma unroll
  for (int i = 0; i < RW_TOP; ++i) {
    const K hi = best[i] > key ? best[i] : key;
    key = best[i] > key ? key : best[i];
    best[i] = hi;
  }
}

// Merge the 32 lanes' descending lists into the warp's top 8; lane 0
// writes them to out[0..7].
template <typename K>
__device__ __forceinline__ void warp_top8(K (&best)[8], K* out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RW_TOP; ++i) {
    K m = best[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const K t = __shfl_xor_sync(H2_FULL_MASK, m, o);
      m = t > m ? t : m;
    }
    if (m != 0 && best[0] == m) {
#pragma unroll
      for (int j = 0; j < RW_TOP - 1; ++j) best[j] = best[j + 1];
      best[RW_TOP - 1] = 0;
    }
    if (lane == 0) out[i] = m;
  }
}

// The warp's 32 values sorted descending over the lanes (a bitonic
// network by shuffles).
template <typename K>
__device__ __forceinline__ K warp_sort_desc(K v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const K o = __shfl_xor_sync(H2_FULL_MASK, v, j);
      const bool hi = ((lane & j) == 0) == ((lane & k) == 0);
      v = hi ? (o > v ? o : v) : (o < v ? o : v);
    }
  }
  return v;
}

// The shared-memory word of window char p: bits 2-4 xor bits 4-6.
__device__ __forceinline__ int rw_swz(int p) {
  return p ^ (((p >> 4) & 7) << 2);
}

// One-hot word of a char code 0..3: byte c is 1.
__device__ __forceinline__ uint32_t rw_onehot(uint32_t c) {
  return 1u << (8 * c);
}

// c += A (16 x 32, s8, row) * B (32 x 8, s8, col), s32.
__device__ __forceinline__ void rw_mma(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage a warp's window chars [base, base + RW_WIN) as swizzled one-hot
// words (0 outside the text; a position past the words but inside the
// text reads the last word, as the clamped gather of JAX's ref_char
// does: a sharded index's rescue reads shard 0's words at global
// positions), groups lane and lane + 32
// of 16 chars: the loads first (rw_load), the stores later (rw_store), so
// that the loads overlap what the warp does between.
struct RwGroups {
  uint32_t w[2], vm[2];
};

__device__ __forceinline__ RwGroups rw_load(const uint32_t* __restrict__ ref_words,
                                            int n_words, long long n_text,
                                            long long base, int lane) {
  RwGroups G;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long q = base + 16LL * (lane + 32 * h);
    uint32_t w = 0u, vm = 0u;
    if (q >= 0 && q + 16 <= n_text && ((q + 15) >> 4) < n_words) {
      const long long wi = q >> 4;
      const int sh = (int)(q & 15);
      w = __ldg(ref_words + wi);
      if (sh) w = __funnelshift_r(w, __ldg(ref_words + wi + 1), 2 * sh);
      vm = 0xFFFFu;
    } else {
      for (int j = 0; j < 16; ++j) {
        const long long p = q + j;
        if (p >= 0 && p < n_text && n_words > 0) {
          const long long pw = min(p >> 4, (long long)n_words - 1);
          w |= ((__ldg(ref_words + pw) >> (2 * (p & 15))) & 3u) << (2 * j);
          vm |= 1u << j;
        }
      }
    }
    G.w[h] = w;
    G.vm[h] = vm;
  }
  return G;
}

__device__ __forceinline__ void rw_store(uint32_t* win, const RwGroups& G,
                                         int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = lane + 32 * h;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t v[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = 4 * e + x;
        v[x] = (G.vm[h] >> j) & 1u ? rw_onehot((G.w[h] >> (2 * j)) & 3u) : 0u;
      }
      *reinterpret_cast<uint4*>(win + rw_swz(16 * k + 4 * e)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// A block is one warp, which walks RW_UPB consecutive units of work of one
// job: 896 diagonals (7 n-tiles of 8 columns) each, in its window in
// shared memory, the next unit's window loaded while this one runs.  Its
// top 8 goes to the scratch, and the job's last block to finish merges
// them; a block's tail holds only its own warp's resources.
__global__ void __launch_bounds__(RW_THREADS, RW_MINB)
rescue_window_kernel(const uint32_t* __restrict__ ref_words, int n_words,
                     long long n_text, const int* __restrict__ reads,
                     const int* __restrict__ win_start, int L, int W, int U,
                     int B, int* __restrict__ out,
                     unsigned* __restrict__ tickets,
                     unsigned long long* __restrict__ part) {
  __shared__ __align__(16) uint32_t win[RW_WIN];
  __shared__ __align__(8) uint32_t srd[RW_RD];
  __shared__ unsigned long long sk[32];
  const int lane = threadIdx.x;
  const int r = blockIdx.x / B;
  const int b = blockIdx.x - r * B;  // the job's block
  const int u0 = b * RW_UPB, u1 = min(u0 + RW_UPB, U);
  const int g = lane >> 2, tq = lane & 3;
  const long long ws = win_start[r];
  const int* rd = reads + (long long)r * L;

  RwGroups G = rw_load(ref_words, n_words, n_text,
                       ws + (long long)u0 * RW_UNIT, lane);
  // the first chunk's read chars (srd[i] = read[i - 16]), then the rest
  // of the read: a job with no ACGT column counts 0 on every diagonal
  int acgt = 0;
  for (int i = lane; i < RW_RD; i += 32) {
    const int t = i - RW_J;
    uint32_t v = 0u;
    if (t >= 0 && t < min(RW_LC, L)) {
      const unsigned c = (unsigned)__ldg(rd + t);
      if (c < 4u) {
        acgt = 1;
        v = rw_onehot(c);
      }
    }
    srd[i] = v;
  }
  for (int t = RW_LC + lane; t < L && !acgt; t += 32)
    acgt = (unsigned)__ldg(rd + t) < 4u;
  if (!__any_sync(H2_FULL_MASK, acgt)) {
    // every count 0: the 8 lowest diagonals
    if (b == 0 && lane < RW_TOP)
      out[(long long)r * RW_TOP + lane] = (int)(ws + (long long)lane);
    return;
  }

  const bool one_chunk = L <= RW_LC;  // A is built once, for every unit
  uint32_t best = 0u;  // lane l < 8: the block's l-th key, descending
  uint32_t a[RW_KS][4];
  for (int u = u0; u < u1; ++u) {
    const int d0 = u * RW_UNIT;
    int acc[RW_TPW][4];
#pragma unroll
    for (int k = 0; k < RW_TPW; ++k)
      acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0;
    for (int t0 = 0; t0 < L; t0 += RW_LC) {
      const int lc = min(RW_LC, L - t0);
      const bool fresh = !one_chunk || u == u0;
      __syncwarp();  // earlier reads of win and srd are done
      rw_store(win, G, lane);
      // the next (unit, chunk)'s window, loaded while this one runs
      int nt = t0 + RW_LC, nu = u;
      if (nt >= L) {
        nt = 0;
        nu = u + 1;
      }
      if (nu < u1)
        G = rw_load(ref_words, n_words, n_text,
                    ws + (long long)nu * RW_UNIT + nt, lane);
      if (!one_chunk && (u != u0 || t0 != 0)) {
        // the chunk's read chars: srd[i] = read[t0 + i - 16]
        for (int i = lane; i < RW_RD; i += 32) {
          const int t = i - RW_J;
          uint32_t v = 0u;
          if (t >= 0 && t < lc) {
            const unsigned c = (unsigned)__ldg(rd + t0 + t);
            if (c < 4u) v = rw_onehot(c);
          }
          srd[i] = v;
        }
      }
      __syncwarp();
      if (fresh) {
        // A fragments (rows j = g, g + 8; k = 4 u + c): a[s][0] row g at
        // u = 8 s + tq, [1] row g + 8, [2] row g at u + 4, [3] row g + 8.
        // Steps past the chunk's band (u >= lc + 15) are 0.
#pragma unroll
        for (int s = 0; s < RW_KS; ++s) {
          const int x = RW_J + 8 * s + tq - g;
          a[s][0] = srd[x];
          a[s][1] = srd[x - 8];
          a[s][2] = srd[x + 4];
          a[s][3] = srd[x - 4];
        }
      }
      // B fragments: tile k's column g is the unit's column 7 g + k, so
      // a thread's (k, s) needs the chars 16 (7 g + k) + 8 s + tq (and + 4)
      // = 112 g + 8 m + tq with m = 2 k + s: tile k + 1 at step s reads
      // what tile k read at step s + 2.  Each word is loaded once, at its
      // first use, and held while later steps reuse it: 27 pairs of loads
      // for the 105 products.  Tiles past W run and are masked below.
      uint32_t bw[2 * RW_TPW + RW_KS - 2][2];
#pragma unroll
      for (int s = 0; s < RW_KS; ++s) {
#pragma unroll
        for (int k = 0; k < RW_TPW; ++k) {
          const int m = 2 * k + s;
          if (s < 2 || k == RW_TPW - 1) {
            // the swizzle's xor: bits 4-6 of the char index, 7 g + m / 2
            const int x = ((7 * g + (m >> 1)) & 7) << 2;
            const int p = 112 * g + 8 * m + tq;
            bw[m][0] = win[p ^ x];
            bw[m][1] = win[(p + 4) ^ x];
          }
          rw_mma(acc[k], a[s], bw[m][0], bw[m][1]);
        }
      }
    }

    // accumulator e of n-tile k: row j = g + 8 (e >> 1), column 2 tq +
    // (e & 1) of the tile, the unit's column 7 (2 tq + (e & 1)) + k, and
    // diagonal dl = 16 column + j of the unit, db + dl of the block.  Its
    // key in the block: the rounded count's code (rw_rank16; the count
    // itself while the warp's counts stay below 256) << 16 | (0xFFFF - db
    // - dl); 0 past W
    int cm = 0;
#pragma unroll
    for (int k = 0; k < RW_TPW; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) cm = max(cm, acc[k][e]);
    // After its first unit, a block's list takes only keys whose code
    // beats its 8th (units come in diagonal order, so an equal code
    // loses); the code grows with the count, so the largest count decides
    // (counts past W only make this check pass more often)
    const uint32_t b7 = __shfl_sync(H2_FULL_MASK, best, RW_TOP - 1);
    const bool first = u == u0;
    if (!first && b7 != 0u &&
        !__any_sync(H2_FULL_MASK, rw_rank16(cm) > (b7 >> 16)))
      continue;
    const bool big = __any_sync(H2_FULL_MASK, cm >= 256);
    const bool full = d0 + RW_UNIT <= W;
    const int db = d0 - u0 * RW_UNIT;
    // The candidates for the block's top 8, keys >= tkey: on its first
    // unit, the 8th largest lane maximum (8 lanes hold a key at least as
    // large; ~8-16 of 896); later, a code past the list's 8th
    uint32_t tkey = b7 == 0u ? 1u : ((b7 >> 16) + 1u) << 16;
#pragma unroll
    for (int k = 0; k < RW_TPW; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int dl = 16 * (7 * (2 * tq + (e & 1)) + k) + g + 8 * (e >> 1);
        const uint32_t c = big ? rw_rank16(acc[k][e]) : (uint32_t)acc[k][e];
        acc[k][e] = (int)(full || d0 + dl < W
                              ? (c << 16) | (0xFFFFu - (uint32_t)(db + dl))
                              : 0u);
      }
    if (first) {
      uint32_t mx = 0u;
#pragma unroll
      for (int k = 0; k < RW_TPW; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx = max(mx, (uint32_t)acc[k][e]);
      tkey = max(1u, __shfl_sync(H2_FULL_MASK, warp_sort_desc(mx),
                                 RW_TOP - 1));
    }
    int nc = 0;
#pragma unroll
    for (int k = 0; k < RW_TPW; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) nc += (uint32_t)acc[k][e] >= tkey;
    const int incl = h2_warp_incl_sum(nc, lane);
    const int n = __shfl_sync(H2_FULL_MASK, incl, 31);
    int at = incl - nc;
    __syncwarp();  // the products' reads of win are done
#pragma unroll
    for (int k = 0; k < RW_TPW; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((uint32_t)acc[k][e] >= tkey) win[at++] = (uint32_t)acc[k][e];
    __syncwarp();
    // the list (lanes 0-7) and the candidates (lanes 8-31), sorted
    if (n <= 32 - RW_TOP) {
      uint32_t v = best;
      if (lane >= RW_TOP && lane - RW_TOP < n) v = win[lane - RW_TOP];
      v = warp_sort_desc(v);
      best = lane < RW_TOP ? v : 0u;
    } else {
      uint32_t l[RW_TOP];
#pragma unroll
      for (int i = 0; i < RW_TOP; ++i) l[i] = 0u;
      l[0] = best;
      for (int i = lane; i < n; i += 32)
        if (win[i] > l[RW_TOP - 1]) top8_insert(l, win[i]);
      uint32_t* tmp = reinterpret_cast<uint32_t*>(sk);
      warp_top8(l, tmp);
      __syncwarp();
      best = lane < RW_TOP ? tmp[lane] : 0u;
      __syncwarp();
    }
  }

  // the block's list as job keys: the count's code << 32 | ~d
  unsigned long long key = 0ull;
  if (best != 0u)
    key = ((unsigned long long)(best >> 16) << 32) |
          (0xFFFFFFFFu -
           (unsigned)(u0 * RW_UNIT + 0xFFFF - (int)(best & 0xFFFFu)));
  if (B > 1) {
    // the block's list to the scratch, then a ticket (acquire-release: it
    // publishes the list and, to the job's last block, every other's);
    // the last block merges and resets the ticket
    unsigned long long* jp = part + (long long)r * B * RW_TOP;
    sk[lane] = key;
    __syncwarp();
    unsigned ticket = 0u;
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RW_TOP; ++i) jp[b * RW_TOP + i] = sk[i];
      cuda::atomic_ref<unsigned, cuda::thread_scope_device> tk(tickets[r]);
      ticket = tk.fetch_add(1u, cuda::memory_order_acq_rel);
      if (ticket == (unsigned)(B - 1)) tk.store(0u, cuda::memory_order_relaxed);
    }
    ticket = __shfl_sync(H2_FULL_MASK, ticket, 0);
    if (ticket != (unsigned)(B - 1)) return;
    __syncwarp();  // the lanes' loads below follow lane 0's acquire
    // the lists at once (up to 32 of them): lane l holds keys l + 32 i, so
    // lanes 7, 15, 23 and 31 hold every list's 8th key; keys >= the
    // largest of those (each list descends) reach the job's top 8
    constexpr int NL = 8;
    const int nk = B * RW_TOP;
    int nj = 33;
    if (nk <= 32 * NL) {
      unsigned long long v[NL], tj = 0ull;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int at2 = lane + 32 * i;
        v[i] = at2 < nk ? __ldcg(jp + at2) : 0ull;
        if ((lane & 7) == 7) tj = v[i] > tj ? v[i] : tj;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long x = __shfl_xor_sync(H2_FULL_MASK, tj, o);
        tj = x > tj ? x : tj;
      }
      nj = 0;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const bool c = v[i] != 0ull && v[i] >= tj;
        const unsigned m = __ballot_sync(H2_FULL_MASK, c);
        const int pos = nj + __popc(m & ((1u << lane) - 1u));
        if (c && pos < 32) sk[pos] = v[i];
        nj += __popc(m);
      }
      __syncwarp();
    }
    if (nj <= 32) {
      key = warp_sort_desc(lane < nj ? sk[lane] : 0ull);
    } else {
      // many lists, or ties past 32 keys: every list whole
      unsigned long long l[RW_TOP];
#pragma unroll
      for (int i = 0; i < RW_TOP; ++i) l[i] = 0ull;
      for (int i = lane; i < nk; i += 32) {
        const unsigned long long x = __ldcg(jp + i);
        if (x > l[RW_TOP - 1]) top8_insert(l, x);
      }
      __syncwarp();
      warp_top8(l, sk);
      __syncwarp();
      key = lane < RW_TOP ? sk[lane] : 0ull;
    }
  }
  if (lane < RW_TOP) {
    const unsigned d = 0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull);
    out[(long long)r * RW_TOP + lane] = (int)(ws + (long long)d);
  }
}

}  // namespace

// A job's U = ceil(W / 896) units go to B = ceil(U / RW_UPB) blocks.
// tickets: R zeroed words that the launch leaves zeroed; scratch: the
// blocks' lists, R * B * 8 keys (unused when B = 1).
H2_EXPORT int h2_rescue_window(const void* ref_words, int n_words,
                               long long n_text, const void* reads,
                               const void* win_start, int R, int L, int W,
                               void* out, void* tickets, void* scratch,
                               long long scratch_bytes, void* stream) {
  if (R <= 0) return (int)cudaGetLastError();
  if (L < 1 || W < RW_TOP) return (int)cudaErrorInvalidValue;
  const long long U = ((long long)W + RW_UNIT - 1) / RW_UNIT;
  const long long B = (U + RW_UPB - 1) / RW_UPB;
  const long long blocks = (long long)R * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (B > 1 && (tickets == nullptr ||
                scratch_bytes < blocks * RW_TOP *
                                    (long long)sizeof(unsigned long long)))
    return (int)cudaErrorInvalidValue;
  rescue_window_kernel<<<(unsigned)blocks, RW_THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)ref_words, n_words, n_text, (const int*)reads,
      (const int*)win_start, L, W, (int)U, (int)B, (int*)out,
      (unsigned*)tickets, (unsigned long long*)scratch);
  return (int)cudaGetLastError();
}
