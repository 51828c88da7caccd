"""Per-read deterministic RNG replication (reference: random_source.h
RandomSource, pat.h:55-91 genRandSeed, ds.h shufflePortion,
aln_sink.h:2504-2560 selectByScore streak shuffling).

The reference seeds a small LCG per read from (sequence, qualities, name,
global --seed) and consumes it ONLY in AlnSinkWrap::finishRead to shuffle
equal-score streaks of the sorted alignment list (rnd is passed through
the whole aligner but never drawn from before reporting — verified by
grep over hi_aligner.h / spliced_aligner.h).  Replicating the seed, the
LCG and the shuffle reproduces the reference's tie-break order exactly,
PROVIDED the pre-shuffle list order matches (descending score; equal
scores in descending report order — selectByScore sorts ascending by
(score, index) then reverses).

Copied verbatim from hisat2_tpu/align/rng.py; only the imports are
rewritten, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

_A = np.uint32(1664525)
_C = np.uint32(1013904223)


def gen_rand_seed(codes_fw: np.ndarray, qual_chars: np.ndarray,
                  name: str, seed: int = 0) -> int:
    """genRandSeed (pat.h:55-91): xor-fold the 2-bit read codes, the
    ASCII quality string and the read name (up to the first '/') into
    the global seed."""
    rseed = np.uint32((seed + 101)
                      * 59 * 61 * 67 * 71 * 73 * 79 * 83 & 0xffffffff)
    r = int(rseed)
    for i, p in enumerate(np.asarray(codes_fw, np.int64)):
        r ^= int(p) << ((i & 15) << 1)
    for i, p in enumerate(np.asarray(qual_chars, np.int64)):
        r ^= int(p) << ((i & 3) << 3)
    for i, ch in enumerate(name.encode()):
        if ch == 0x2F:          # '/'
            break
        r ^= ch << ((i & 3) << 3)
    return r & 0xffffffff


def gen_rand_seeds(codes: np.ndarray, lens: np.ndarray, quals: np.ndarray,
                   names, seed: int = 0) -> np.ndarray:
    """Vectorized gen_rand_seed over a padded batch.  quals are 0-based
    phred values; the reference hashes the ASCII string (phred + 33)."""
    B, L = codes.shape
    base = ((seed + 101) * 59 * 61 * 67 * 71 * 73 * 79 * 83) & 0xffffffff
    cols = np.arange(L)
    live = cols[None, :] < np.asarray(lens)[:, None]
    cw = np.where(live, codes.astype(np.int64), 0) << ((cols & 15) << 1)
    qw = np.where(live, quals.astype(np.int64) + 33, 0) << ((cols & 3) << 3)
    out = np.full(B, base, np.int64)
    for j in range(L):
        out ^= cw[:, j]
        out ^= qw[:, j]
    for b, nm in enumerate(names):
        v = 0
        for i, ch in enumerate(nm.encode()):
            if ch == 0x2F:
                break
            v ^= ch << ((i & 3) << 3)
        out[b] ^= v
    return (out & 0xffffffff).astype(np.uint32)


class RandomSource:
    """random_source.h:34-80: two LCG steps per draw."""

    def __init__(self, seed: int):
        self.last = np.uint32(seed)

    def next_u32(self) -> int:
        with np.errstate(over="ignore"):
            self.last = _A * self.last + _C
            ret = np.uint32(int(self.last) >> 16)
            self.last = _A * self.last + _C
            ret ^= self.last
        return int(ret)


def shuffle_portion(lst: list, begin: int, num: int,
                    rnd: RandomSource) -> None:
    """ds.h shufflePortion: partial Fisher-Yates, draws num-1 values."""
    if num < 2:
        return
    left = num
    for i in range(begin, begin + num - 1):
        rndi = rnd.next_u32() % left
        if rndi > 0:
            lst[i], lst[i + rndi] = lst[i + rndi], lst[i]
        left -= 1


def select_by_score(scores, rep_order, rnd: RandomSource):
    """selectByScore (aln_sink.h:2504-2560): return indices ordered like
    the reference's post-shuffle buf.  `scores` and `rep_order` are
    parallel lists: rep_order[i] is the approximate report index of
    alignment i (its position in the reference's rs list).  The buf is
    sorted ascending by (score, report index) then reversed, equal-score
    streaks shuffled with the read's LCG."""
    n = len(scores)
    if n == 0:
        return []
    buf = sorted(range(n), key=lambda i: (scores[i], rep_order[i]))
    buf.reverse()
    streak = 0
    for i in range(1, n):
        if scores[buf[i]] == scores[buf[i - 1]]:
            streak = (streak if streak else 1) + 1
        else:
            if streak > 1:
                shuffle_portion(buf, i - streak, streak, rnd)
            streak = 0
    if streak > 1:
        shuffle_portion(buf, n - streak, streak, rnd)
    return buf


def finalize_unpaired(alns, seed, k: int, ref_codes, orient_rank=None,
                      secondary: bool = False):
    """finishRead's unpaired reporting order (aln_sink.h:2060-2100):
    sort descending by score, shuffle every equal-score streak with the
    read's LCG (selectByScore), report min(#alns, k), truncating at the
    first score drop unless --secondary/-a.

    Report-order proxy: the reference accumulates alignments in SA-row
    resolution order, fw orientation searched before rc on equal
    prospects — so equal-score candidates are ordered by (rc, suffix of
    the joined reference at the alignment start).  Validated exactly on
    a 200-read duplicated-locus corpus (200/200 primaries)."""
    import dataclasses
    if not alns:
        return alns
    if len(alns) == 1:
        return [dataclasses.replace(alns[0], nh=1, secondary=False)]
    rep = _report_ranks(alns, ref_codes, orient_rank)
    order = select_by_score([a.score for a in alns], rep,
                            RandomSource(seed))
    sel = order[:min(k, len(order))]
    if not secondary:
        best = alns[sel[0]].score
        for i in range(1, len(sel)):
            if alns[sel[i]].score != best:
                sel = sel[:i]
                break
    nh = len(sel)
    return [dataclasses.replace(alns[j], nh=nh, secondary=i > 0)
            for i, j in enumerate(sel)]


def _suffix_cmp(ref_codes, pa: int, pb: int) -> int:
    """Lexicographic order of two joined-reference suffixes (chunked:
    duplicated regions can be identical for many kb)."""
    if pa == pb:
        return 0
    n = len(ref_codes)
    step = 4096
    off = 0
    while off < (1 << 21):
        a = ref_codes[pa + off:min(pa + off + step, n)]
        b = ref_codes[pb + off:min(pb + off + step, n)]
        m = min(len(a), len(b))
        if m:
            neq = np.flatnonzero(a[:m] != b[:m])
            if neq.size:
                i = int(neq[0])
                return -1 if a[i] < b[i] else 1
        if len(a) != len(b) or m < step:
            return -1 if len(a) < len(b) else (1 if len(a) > len(b) else 0)
        off += step
    return -1 if pa < pb else 1


def _report_ranks(top, ref_codes, orient_rank=None):
    """Report indices for an equal-score group: orientation completion
    order first (align() runs when a lane's search finishes — the
    interleave replay provides the order for linear runs, the
    round-count rule for graph runs; fw-first when truly unknown), then
    SA-row order = suffix order at the alignment's joined start."""
    import functools

    def okey(a):
        if orient_rank is None:
            return 1 if a.rc else 0
        return orient_rank[1 if a.rc else 0]

    def cmp(i, j):
        a, b = top[i], top[j]
        if okey(a) != okey(b):
            return -1 if okey(a) < okey(b) else 1
        return _suffix_cmp(ref_codes, a.joined_pos, b.joined_pos)

    order = sorted(range(len(top)), key=functools.cmp_to_key(cmp))
    rank = [0] * len(top)
    for pos, i in enumerate(order):
        rank[i] = pos
    return rank


def finalize_pairs(pairs, seed, k: int, ref_codes):
    """Concordant-pair reporting order (finishRead paired branch,
    aln_sink.h:1860-1870): selectByScore over pair score SUMS — best-sum
    streak only (truncation at the first drop), shuffled with
    rnd.init(seed1 ^ seed2), min(streak, k) reported.  Report-order
    proxy: pairs discover in pairReads' rs1 x rs2 loop order, ranked
    here by (mate1 orientation/suffix, mate2 suffix)."""
    if not pairs:
        return pairs
    sums = [a1.score + a2.score for a1, a2, *_ in pairs]
    best = max(sums)
    top = [p for p, sm in zip(pairs, sums) if sm == best]
    if len(top) > 1:
        import functools

        def cmp(i, j):
            a1, a2, *_ = top[i]
            b1, b2, *_ = top[j]
            if a1.rc != b1.rc:
                return -1 if not a1.rc else 1
            c = _suffix_cmp(ref_codes, a1.joined_pos, b1.joined_pos)
            if c:
                return c
            return _suffix_cmp(ref_codes, a2.joined_pos, b2.joined_pos)

        order = sorted(range(len(top)), key=functools.cmp_to_key(cmp))
        rank = [0] * len(top)
        for pos, i in enumerate(order):
            rank[i] = pos
        sel = select_by_score([0] * len(top), rank, RandomSource(seed))
        top = [top[j] for j in sel]
    return top[:k]
