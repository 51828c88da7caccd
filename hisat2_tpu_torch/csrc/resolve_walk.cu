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
// (unused here) | 4 mark words | the mark-rank checkpoint.  The mark bit
// and the mark rank come from the 4 mark words and the checkpoint (a
// masked __popc per word); the BWT char from one of the 8 BWT words; the
// LF rank from occ[c] plus the count of 2-bit fields equal to c below the
// row in the block (an xor / and / __popc per word), less the '$' row.
//
// The TPU walks every lane in lock-step for 2^off_rate + 1 steps and
// compacts the live rows into chunks so that dead rows cost no gathers.
// Here each row is one thread: a dead row returns at once, a live row
// stops at its own mark (SA mod 2^off_rate steps, 7.5 on average at
// off_rate 4), and the results do not depend on the order of the rows.
// The block row is 196 B, not 16 B aligned, so the words are scalar loads
// through the read-only cache, which keeps a step's sectors after its
// first load.
//
// Bound: bytes.  A chain of dependent random gathers.  A step past an
// unmarked row needs words 0-11 and 44-48 of its block row, the marked
// row's fetch words 44-48 only: at the row's offset in its first 32 B
// sector (196 * blk mod 32, a multiple of 4), four sectors or three (at
// offset 16) for an unmarked row, two or one for the marked row.  Then
// 4 B of sa_marked per live row, the row index of live rows, and the mask
// and output of every row.  Each step waits for its fetch, so the kernel
// needs many rows in flight (one thread each) to approach it.
#include "common.cuh"

#define RW_WIDTH 49
#define RW_MARKS (RW_WIDTH - 5)

__global__ void resolve_walk_kernel(const uint32_t* __restrict__ blocked,
                                    long long nblk, const int* fchr,
                                    const int* __restrict__ sa_marked,
                                    long long ns, int zrow, int max_steps,
                                    const int* __restrict__ row,
                                    const uint8_t* __restrict__ live,
                                    long long M, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  if (live != nullptr && live[i] == 0) {
    out[i] = 0;
    return;
  }
  const int f0 = __ldg(fchr), f1 = __ldg(fchr + 1), f2 = __ldg(fchr + 2),
            f3 = __ldg(fchr + 3);
  long long r = row[i];
  for (int s = 0; s < max_steps; ++s) {
    const long long blk = r >> 7;
    const int within = (int)(r & 127);
    const uint32_t* br =
        blocked + (size_t)min(blk, nblk - 1) * RW_WIDTH;  // JAX clips
    // mark bit, then the mark rank from the same 4 words + checkpoint
    const uint32_t mword = __ldg(br + RW_MARKS + ((r >> 5) & 3));
    if ((mword >> (r & 31)) & 1u) {
      int mr = (int)__ldg(br + RW_MARKS + 4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int nv = min(max(within - 32 * k, 0), 32);
        const uint32_t msk = nv >= 32 ? 0xFFFFFFFFu : ((1u << nv) - 1u);
        mr += __popc(__ldg(br + RW_MARKS + k) & msk);
      }
      const long long at = min((long long)mr, ns - 1);
      out[i] = (int)((unsigned)__ldg(sa_marked + at) + (unsigned)s);
      return;
    }
    // BWT char and LF rank over the block's 8 words
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
        (c == 0 && (long long)zrow >= (blk << 7) && r > zrow) ? 1 : 0;
    const int fc = c < 2 ? (c == 0 ? f0 : f1) : (c == 2 ? f2 : f3);
    r = (long long)fc + (int)__ldg(br + c) + cnt - corr;
  }
  out[i] = 0;  // never marked within the walk's bound
}

H2_EXPORT int h2_resolve_walk(const void* blocked, long long nblk,
                              const void* fchr, const void* sa_marked,
                              long long ns, int zrow, int off_rate,
                              const void* row, const void* live, long long M,
                              void* out, void* stream) {
  if (nblk < 1 || ns < 1 || off_rate < 1 || off_rate > 16 || M < 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (M + threads - 1) / threads;
  if (blocks > 0)
    resolve_walk_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)blocked, nblk, (const int*)fchr,
        (const int*)sa_marked, ns, zrow, (1 << off_rate) + 1,
        (const int*)row, (const uint8_t*)live, M, (int*)out);
  return (int)cudaGetLastError();
}
