// Kernel 2: reference chars along candidate diagonals, with a margin (K5).
//
// Replaces hisat2_tpu/ops/rank.py:ref_chars_block (:132) as reached
// through ops/splice.py:diag_chars (:277):
//   out[s][p][n, c, m] = plane_p[starts_s[n, c] - margin_s + m],
// 4 outside [0, n_text).  Plain twin:
// hisat2_tpu_torch/ops/splice.py:diag_chars_multi_plain.
//
// A position past a plane's words but inside the text (a sharded index's
// mate rescue reads shard 0's words at global positions) reads the word
// that JAX's gather reads there: the last row of `row` words, at the
// word's place in its row (ops/rank.py:clamp_words; `row` is the row
// width of the lowering JAX takes for the plane, ops/rank.py:clamp_row).
//
// One launch writes the windows of up to two start sets (the core
// candidates with their margin, the extra slots with none) on up to
// three packed planes (the reference and, on a graph index, the two SNV
// planes): a step's windows, which it used to ask for in up to six
// launches of one plane and one set each.  The grid covers both sets, a
// range of blocks each.
//
// Bound: bytes, and of those the int32 output, 16 times the packed words
// it reads and far more than the starts.  So the design aims at the store
// rate.  A thread writes groups of 4 consecutive flat chars (four on a
// large set, one on a small one), each one 16-byte store: a warp's store
// writes 512 contiguous bytes, whatever W is (a group may span two rows,
// since W = L + 2 * margin need not be a multiple of 4; such a group, and
// the ragged tail, take a char-by-char path).  The group's 4 chars come
// from at most two packed words, joined by a funnel shift; the three
// planes share the row, its start (loaded once per row, not per char) and
// every index, and differ only in the word loads.  The index math is
// 32-bit within a set of fewer than 2^31 chars and 64-bit in a second
// instantiation past it (a row index always fits 32 bits: the entry point
// refuses 2^31 starts in a set).
#include "common.cuh"

#define RW_THREADS 256
// groups of 4 chars a thread: 4 on a set of 2^21 chars or more (the
// division and the start loads shared by 16 chars), else 1 (a small set
// needs the threads to hide its load latency)
#define RW_GROUPS_BIG 4
#define RW_SMALL_SET (1LL << 21)

struct RwSet {
  const int* starts;
  long long chars;  // starts * W
  int W, margin, groups;
  int* out[3];      // [n, W] per plane
};

struct RwArgs {
  const uint32_t* plane[3];
  long long lim[3];  // n_text (0 on a plane of no words): chars past it read 4
  int n_words[3];
  int row[3];        // the clamp's row width, a power of two dividing n_words
  int n_planes;
  RwSet set[2];
  long long blocks0;  // blocks of set 0
};

// the word read for word index wi >= 0 of a plane of n_words > 0 words:
// wi itself below n_words, else word wi % row of the last row
__device__ __forceinline__ long long rw_word(long long wi, int n_words,
                                             int row) {
  return wi < n_words ? wi : (long long)n_words - row + (wi & (row - 1));
}

// the 4 chars of a plane from position pos0 on, into v[0..3]
__device__ __forceinline__ void rw_chars4(const uint32_t* __restrict__ w,
                                          int n_words, int row, long long lim,
                                          long long pos0, int v[4]) {
  const long long wi = pos0 >> 4;         // floor, also below 0
  const int sh = (int)(pos0 & 15);
  const bool any = n_words > 0;
  const uint32_t lo =
      (wi >= 0 && any) ? __ldg(w + rw_word(wi, n_words, row)) : 0u;
  const uint32_t hi = (sh > 12 && wi + 1 >= 0 && any)
                          ? __ldg(w + rw_word(wi + 1, n_words, row))
                          : 0u;
  const uint32_t bits = __funnelshift_r(lo, hi, 2 * sh);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long pos = pos0 + k;
    v[k] = (pos < 0 || pos >= lim) ? 4 : (int)((bits >> (2 * k)) & 3u);
  }
}

__device__ __forceinline__ int rw_char(const uint32_t* __restrict__ w,
                                       int n_words, int row, long long lim,
                                       long long pos) {
  if (pos < 0 || pos >= lim) return 4;
  return (int)((__ldg(w + rw_word(pos >> 4, n_words, row)) >>
                (2 * (pos & 15))) &
               3u);
}

// block `blk` of one start set (its fields read out of the argument
// struct by constant index, so that nothing of it goes to local memory)
template <typename Idx>
__device__ __forceinline__ void rw_set(const RwArgs& A, const int* starts,
                                       long long n_chars, int W, int margin,
                                       int G, int* const out[3],
                                       long long blk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Idx chars = (Idx)n_chars;
  const int P = A.n_planes;
  // group k of this thread: chars [f, f + 4), f = 4 * (the block's first
  // group + warp * 32 * G + k * 32 + lane)
  Idx f = ((Idx)blk * (RW_THREADS * G) + (Idx)(warp * 32 * G + lane)) * 4;
  if (f >= chars) return;
  Idx row = f / W;
  int col = (int)(f - row * W);
  Idx srow = -1;
  long long base = 0;                     // starts[row] - margin
#pragma unroll 1
  for (int k = 0; k < G && f < chars; ++k) {
    if (col + 3 < W && f + 3 < chars) {
      if (row != srow) {
        srow = row;
        base = (long long)__ldg(starts + row) - margin;
      }
      const long long pos0 = base + col;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        if (p < P) {
          int v[4];
          rw_chars4(A.plane[p], A.n_words[p], A.row[p], A.lim[p], pos0,
                    v);
          *reinterpret_cast<int4*>(out[p] + f) =
              make_int4(v[0], v[1], v[2], v[3]);
        }
      }
    } else {
      // a group across a row end, or the ragged tail: char by char
      for (int q = 0; q < 4 && f + q < chars; ++q) {
        const Idx r = (f + q) / W;
        const int c = (int)(f + q - r * W);
        const long long pos = (long long)__ldg(starts + r) - margin + c;
#pragma unroll
        for (int p = 0; p < 3; ++p)
          if (p < P)
            out[p][f + q] =
                rw_char(A.plane[p], A.n_words[p], A.row[p], A.lim[p], pos);
      }
    }
    // the thread's next group: 128 chars on
    f += 32 * 4;
    if (W >= 32 * 4) {
      col += 32 * 4;
      if (col >= W) {
        col -= W;
        ++row;
      }
    } else {
      row = f / W;
      col = (int)(f - row * W);
    }
  }
}

template <int S>
__device__ __forceinline__ void rw_run(const RwArgs& A, long long blk,
                                       int big) {
  int* const out[3] = {A.set[S].out[0], A.set[S].out[1], A.set[S].out[2]};
  if (big)
    rw_set<long long>(A, A.set[S].starts, A.set[S].chars, A.set[S].W,
                      A.set[S].margin, A.set[S].groups, out, blk);
  else
    rw_set<int>(A, A.set[S].starts, A.set[S].chars, A.set[S].W,
                A.set[S].margin, A.set[S].groups, out, blk);
}

__global__ void __launch_bounds__(RW_THREADS)
    ref_window_kernel(const RwArgs A, int big0, int big1) {
  const long long b = blockIdx.x;
  if (b < A.blocks0)
    rw_run<0>(A, b, big0);
  else
    rw_run<1>(A, b - A.blocks0, big1);
}

// h2_ref_window's one argument (ops/splice.py:_RwCall lays it out field
// for field, 8 bytes each, so that a call converts one pointer, not 26
// scalars): planes 0..n_planes-1 with their word counts and clamp rows
// (a power of two dividing the word count), then start sets
// 0..n_sets-1, each its starts, count, window width W and margin and its
// windows out[p] on plane p, int32 [count, W], each 16-byte aligned.
struct RwCallSet {
  const void* starts;
  long long n, W, margin;
  void* out[3];
};

struct RwCall {
  const void* plane[3];
  long long n_words[3];
  long long row[3];
  long long n_planes, n_text, n_sets;
  RwCallSet set[2];
};

H2_EXPORT int h2_ref_window(const RwCall* call, void* stream) {
  const RwCall& a = *call;
  const int P = (int)a.n_planes, S = (int)a.n_sets;
  if (P < 1 || P > 3 || S < 1 || S > 2) return (int)cudaErrorInvalidValue;
  RwArgs A;
  for (int p = 0; p < 3; ++p) {
    const long long nw = p < P ? a.n_words[p] : 0;
    const long long row = p < P ? a.row[p] : 1;
    if (nw < 0 || nw >= (1LL << 31) || row < 1 || row > 128 ||
        (row & (row - 1)) != 0 || nw % row != 0)
      return (int)cudaErrorInvalidValue;
    A.plane[p] = (const uint32_t*)a.plane[p];
    A.n_words[p] = (int)nw;
    A.row[p] = (int)row;
    A.lim[p] = nw > 0 ? a.n_text : 0;
  }
  A.n_planes = P;
  long long blocks[2];
  int big[2];
  for (int s = 0; s < 2; ++s) {
    const RwCallSet& c = a.set[s];
    const bool on = s < S;
    if (on && (c.W < 1 || c.W >= (1LL << 31) || c.margin < 0 ||
               c.margin >= (1LL << 31) || c.n < 0 || c.n >= (1LL << 31)))
      return (int)cudaErrorInvalidValue;
    for (int p = 0; p < P; ++p)   // the 16-byte stores
      if (on && c.n > 0 && ((uintptr_t)c.out[p] & 15) != 0)
        return (int)cudaErrorMisalignedAddress;
    RwSet& R = A.set[s];
    R.starts = (const int*)c.starts;
    R.W = on ? (int)c.W : 1;
    R.margin = on ? (int)c.margin : 0;
    R.chars = on ? c.n * c.W : 0;
    for (int p = 0; p < 3; ++p) R.out[p] = (int*)c.out[p];
    R.groups = R.chars >= RW_SMALL_SET ? RW_GROUPS_BIG : 1;
    const long long per_block = (long long)RW_THREADS * R.groups * 4;
    blocks[s] = (R.chars + per_block - 1) / per_block;
    // 32-bit flat indices where the set's chars and the last block's
    // overrun stay below 2^31
    big[s] = R.chars + per_block >= (1LL << 31);
  }
  A.blocks0 = blocks[0];
  const long long grid = blocks[0] + blocks[1];
  if (grid > 0)
    ref_window_kernel<<<(unsigned)grid, RW_THREADS, 0,
                        (cudaStream_t)stream>>>(A, big[0], big[1]);
  return (int)cudaGetLastError();
}

H2_EXPORT const char* h2_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
