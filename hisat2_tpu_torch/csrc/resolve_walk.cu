// K19 + K20: the sampled-SA LF walk over the live rows.
//
// Replaces hisat2_tpu/ops/resolve.py:resolve_rows (:29, K19) and
// resolve_rows_sparse (:107, K20).  For SA row r, walk r <- LF(r) until
// the row is marked (its SA value is a multiple of 2^off_rate), at most
// 2^off_rate + 1 fetches; the answer is sa_marked[min(mark rank, len-1)]
// plus the steps taken.  A row never found marked reads 0, and so does a
// dead row (live[i] == 0).  Plain twin: hisat2_tpu_torch/ops/resolve.py:
// resolve_rows_sparse_plain (resolve_rows_plain without a live mask).
//
// Each step reads one fused 49-word block row (index/format.py:
// fuse_blocked): occ[0..3] | 8 BWT words | 16 bigram occ + 16 bigram words
// (unused here) | 4 mark words | the mark-rank checkpoint.  A step issues
// the loads of every word it may need at once (occ, the BWT and mark words
// up to the row's own, the checkpoint: 3-4 sectors of the 196 B row), so
// that it waits for one round trip, not for the mark word, then the BWT
// word, then occ[c].
// The mark bit and the mark rank come from the 4 mark words and the
// checkpoint (a masked __popc per word); the BWT char from one of the 8
// BWT words; the LF rank from occ[c] plus the count of 2-bit fields equal
// to c below the row in the block (an xor / and / __popc per word), less
// the '$' row.
//
// The TPU walks every lane in lock-step for 2^off_rate + 1 steps and
// compacts the live rows into chunks so that dead rows cost no gathers.
// Here, with a live mask (K20, the main path: 2-11% of the rows live), the
// grid is sized to the card (the blocks resident at once) and each block
// sweeps a run of rows in tiles: its threads read the tile's mask
// coalesced (4 bytes a thread), write 0 for the dead rows, and put the
// live ones on a list in shared memory with their SA rows (read in the
// sweep), a warp's by one ballot and one atomic.  Then all the block's
// threads walk that list, a row a thread (in rounds where it holds more
// rows than threads), so every resident warp walks live rows only.
// At ~2% density a launch lasts about one walk, the longest walk's chain
// of dependent fetches; at ~10% the walks' random sectors load the DRAM.
// Without a mask (K19) a thread takes a row and loads in sequence.  A
// row's result does not depend on the order of the rows.  The rows come
// as the first of each run of P consecutive SA rows (a hit's rows
// top..top+P-1), and a walk adds its offset in the run, so that the
// caller makes no [M] row tensor.
//
// Bound: where few rows are live (~2%), latency: the longest walk's chain
// of dependent loads (up to 2^off_rate + 1 block-row fetches and an
// sa_marked entry, each a DRAM round trip; the fused rows are ~4x the 50
// MB L2 at chromosome scale).  Where many are (~10%), the walks' random
// sectors: a step needs occ, the BWT and mark words up to the row's own
// and the checkpoint (3-4 of the 196 B row's 32 B sectors), then 4 B of
// sa_marked per live row, the first row of each run with a live row, and
// the mask and output of every row.
#include "common.cuh"

#define RW_WIDTH 49
#define RW_MARKS (RW_WIDTH - 5)
#define RW_THREADS 256
#define RW_PER 4                        // mask bytes a thread reads a tile
#define RW_TILE (RW_THREADS * RW_PER)   // rows a block sweeps a tile
// list entries: what stays after the walks (< a round) plus a tile
#define RW_CAP (RW_TILE + RW_THREADS)

struct RwIndex {
  const uint32_t* blocked;
  long long nblk;
  const int* sa_marked;
  long long ns;
  int f0, f1, f2, f3, zrow, max_steps;
};

// One walk: its row, its answer (0 until marked), whether it is over.
struct RwWalk {
  long long r;
  int val;
  bool done;
};

// The words of r's block row that a step may read, loaded at once:
// occ[0..3], the BWT words up to r's, the mark words up to r's and the
// checkpoint (17 slots; the words past r's count nothing and read 0).
__device__ __forceinline__ void rw_load(const RwIndex& X, long long r,
                                        uint32_t (&w)[17]) {
  const uint32_t* br =
      X.blocked + (size_t)min(r >> 7, X.nblk - 1) * RW_WIDTH;  // JAX clips
  const int within = (int)(r & 127);
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = __ldg(br + k);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[4 + k] = k <= (within >> 4) ? __ldg(br + 4 + k) : 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[12 + k] = k <= (within >> 5) ? __ldg(br + RW_MARKS + k) : 0u;
  w[16] = __ldg(br + RW_MARKS + 4);
}

// Step s of walk a on its row's words: the answer where the row is
// marked, else the LF of the row.
__device__ __forceinline__ void rw_apply(const RwIndex& X,
                                         const uint32_t (&w)[17], int s,
                                         RwWalk& a) {
  const long long r = a.r;
  const long long blk = r >> 7;
  const int within = (int)(r & 127);
  const int mi = (int)((r >> 5) & 3);
  const uint32_t mword =
      mi < 2 ? (mi == 0 ? w[12] : w[13]) : (mi == 2 ? w[14] : w[15]);
  if ((mword >> (r & 31)) & 1u) {
    int mr = (int)w[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int nv = min(max(within - 32 * k, 0), 32);
      const uint32_t msk = nv >= 32 ? 0xFFFFFFFFu : ((1u << nv) - 1u);
      mr += __popc(w[12 + k] & msk);
    }
    const long long at = min((long long)mr, X.ns - 1);
    a.val = (int)((unsigned)__ldg(X.sa_marked + at) + (unsigned)s);
    a.done = true;
    return;
  }
  const int bi = (int)((r >> 4) & 7);
  uint32_t cw = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) cw = k == bi ? w[4 + k] : cw;
  const unsigned c = (cw >> (2 * (r & 15))) & 3u;
  const uint32_t pat = c * 0x55555555u;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int nv = min(max(within - 16 * k, 0), 16);
    const uint32_t x = ~(w[4 + k] ^ pat);
    const uint32_t pairs = x & (x >> 1) & 0x55555555u;
    const uint32_t msk = nv >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nv)) - 1u);
    cnt += __popc(pairs & msk);
  }
  const int corr =
      (c == 0 && (long long)X.zrow >= (blk << 7) && r > X.zrow) ? 1 : 0;
  const int fc = c < 2 ? (c == 0 ? X.f0 : X.f1) : (c == 2 ? X.f2 : X.f3);
  const uint32_t occ = c < 2 ? (c == 0 ? w[0] : w[1]) : (c == 2 ? w[2] : w[3]);
  a.r = (long long)fc + (int)occ + cnt - corr;
}

// The walk from SA row r: its answer (0 if never marked).
__device__ __forceinline__ int rw_walk(const RwIndex& X, long long r) {
  RwWalk a{r, 0, false};
  for (int s = 0; s < X.max_steps && !a.done; ++s) {
    uint32_t w[17];
    rw_load(X, a.r, w);
    rw_apply(X, w, s, a);
  }
  return a.val;
}

// The first column of each char's rows in the BWT (fchr[0..3]).
__device__ __forceinline__ void rw_fchr(RwIndex& X, const int* fchr) {
  X.f0 = __ldg(fchr);
  X.f1 = __ldg(fchr + 1);
  X.f2 = __ldg(fchr + 2);
  X.f3 = __ldg(fchr + 3);
}

// SA row i: row[i / P] + i % P, `row` holding the first of each run of P
// consecutive rows (ops/resolve.py:walk_args), as int32 (it wraps as the
// plain twin's int32 rows do).  The division is 32-bit below 2^32 rows.
__device__ __forceinline__ int rw_row(const int* row, int P, long long i) {
  const long long q = i < 0xFFFFFFFFll ? (long long)((unsigned)i / (unsigned)P)
                                       : i / P;
  return (int)((unsigned)row[q] + (unsigned)(i - q * P));
}

// K19: every row live, a thread a row.  Every row walks, so the DRAM
// and the threads resident, not one walk's latency, bind: the steps load
// in sequence (the mark word, then a marked row's mark words and
// checkpoint or an unmarked row's BWT words and occ[c]), which reads
// fewer bytes and holds fewer registers than rw_load's all-at-once.
__global__ void __launch_bounds__(RW_THREADS)
    resolve_walk_dense(RwIndex X, const int* fchr,
                       const int* __restrict__ row, int P, long long M,
                       int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  rw_fchr(X, fchr);
  long long r = rw_row(row, P, i);
  for (int s = 0; s < X.max_steps; ++s) {
    const long long blk = r >> 7;
    const int within = (int)(r & 127);
    const uint32_t* br = X.blocked + (size_t)min(blk, X.nblk - 1) * RW_WIDTH;
    const uint32_t mword = __ldg(br + RW_MARKS + ((r >> 5) & 3));
    if ((mword >> (r & 31)) & 1u) {
      int mr = (int)__ldg(br + RW_MARKS + 4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int nv = min(max(within - 32 * k, 0), 32);
        const uint32_t msk = nv >= 32 ? 0xFFFFFFFFu : ((1u << nv) - 1u);
        mr += __popc(__ldg(br + RW_MARKS + k) & msk);
      }
      const long long at = min((long long)mr, X.ns - 1);
      out[i] = (int)((unsigned)__ldg(X.sa_marked + at) + (unsigned)s);
      return;
    }
    const uint32_t cw = __ldg(br + 4 + ((r >> 4) & 7));
    const unsigned c = (cw >> (2 * (r & 15))) & 3u;
    const uint32_t pat = c * 0x55555555u;
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int nv = min(max(within - 16 * k, 0), 16);
      if (nv == 0) break;
      const uint32_t x = ~(__ldg(br + 4 + k) ^ pat);
      const uint32_t pairs = x & (x >> 1) & 0x55555555u;
      const uint32_t msk = nv >= 16 ? 0xFFFFFFFFu : ((1u << (2 * nv)) - 1u);
      cnt += __popc(pairs & msk);
    }
    const int corr =
        (c == 0 && (long long)X.zrow >= (blk << 7) && r > X.zrow) ? 1 : 0;
    const int fc = c < 2 ? (c == 0 ? X.f0 : X.f1) : (c == 2 ? X.f2 : X.f3);
    r = (long long)fc + (int)__ldg(br + c) + cnt - corr;
  }
  out[i] = 0;  // never marked within the walk's bound
}

// K20: block b sweeps rows [b * per, min((b + 1) * per, M)) a tile at a
// time and walks the live ones from its list.
__global__ void __launch_bounds__(RW_THREADS)
    resolve_walk_sparse(RwIndex X, const int* fchr,
                        const int* __restrict__ row, int P,
                        const uint8_t* __restrict__ live, long long M,
                        long long per, int* __restrict__ out) {
  __shared__ int s_list[RW_CAP];   // a live row's index less beg
  __shared__ int s_row[RW_CAP];    // and its SA row
  __shared__ int s_n;
  const int tid = threadIdx.x, lane = tid & 31;
  rw_fchr(X, fchr);
  const long long beg = (long long)blockIdx.x * per;
  const long long end = min(beg + per, M);
  if (tid == 0) s_n = 0;
  __syncthreads();
  // walk entry e of the list
  auto walk = [&](int e) { out[beg + s_list[e]] = rw_walk(X, s_row[e]); };
  for (long long t0 = beg; t0 < end; t0 += RW_TILE) {
    // the tile's mask bytes and rows, all loads issued before any is used
    bool lvk[RW_PER];
    int rvk[RW_PER];
#pragma unroll
    for (int k = 0; k < RW_PER; ++k) {
      const long long i = t0 + k * RW_THREADS + tid;
      lvk[k] = i < end && live[i] != 0;
      rvk[k] = i < end ? rw_row(row, P, i) : 0;
    }
#pragma unroll
    for (int k = 0; k < RW_PER; ++k) {
      const long long i = t0 + k * RW_THREADS + tid;
      const bool lv = lvk[k];
      const int rv = rvk[k];
      if (i < end && !lv) out[i] = 0;
      const unsigned bal = __ballot_sync(H2_FULL_MASK, lv);
      if (bal != 0) {
        const int leader = __ffs(bal) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&s_n, __popc(bal));
        at = __shfl_sync(H2_FULL_MASK, at, leader);
        if (lv) {
          const int e = at + __popc(bal & ((1u << lane) - 1u));
          s_list[e] = (int)(i - beg);
          s_row[e] = rv;
        }
      }
    }
    __syncthreads();
    int n = s_n;
    // full rounds: a row a thread from the top of the list
    for (; n >= RW_THREADS; n -= RW_THREADS) walk(n - RW_THREADS + tid);
    __syncthreads();   // the list read by all before the next tile appends
    if (tid == 0) s_n = n;
    __syncthreads();
  }
  if (tid < s_n) walk(tid);
}

// The blocks of resolve_walk_sparse resident on the card at once (cached
// per device).
static long long rw_resident_blocks() {
  static int cached_dev = -1;
  static long long cached = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev != cached_dev) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, resolve_walk_sparse, RW_THREADS, 0) != cudaSuccess)
      return 0;
    cached = (long long)max(1, sms * per_sm);
    cached_dev = dev;
  }
  return cached;
}

H2_EXPORT int h2_resolve_walk(const void* blocked, long long nblk,
                              const void* fchr, const void* sa_marked,
                              long long ns, int zrow, int off_rate,
                              const void* row, int P, const void* live,
                              long long M, void* out, void* stream) {
  if (nblk < 1 || ns < 1 || off_rate < 1 || off_rate > 16 || M < 0 ||
      P < 1 || M % P != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaGetLastError();
  const RwIndex X{(const uint32_t*)blocked, nblk, (const int*)sa_marked, ns,
                  0, 0, 0, 0, zrow, (1 << off_rate) + 1};
  cudaStream_t s = (cudaStream_t)stream;
  if (live == nullptr) {
    const long long blocks = (M + RW_THREADS - 1) / RW_THREADS;
    resolve_walk_dense<<<(unsigned)blocks, RW_THREADS, 0, s>>>(
        X, (const int*)fchr, (const int*)row, P, M, (int*)out);
    return (int)cudaGetLastError();
  }
  const long long grid = rw_resident_blocks();
  if (grid <= 0) return (int)cudaGetLastError();
  // as many blocks as are resident at once, each a run of rows (a whole
  // number of warps' 32 rows), so that every SM sweeps and walks alike
  const long long per = ((M + grid - 1) / grid + 31) / 32 * 32;
  const long long blocks = (M + per - 1) / per;
  resolve_walk_sparse<<<(unsigned)blocks, RW_THREADS, 0, s>>>(
      X, (const int*)fchr, (const int*)row, P, (const uint8_t*)live, M,
      per, (int*)out);
  return (int)cudaGetLastError();
}
