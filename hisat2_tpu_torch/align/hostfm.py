"""Host-side FM-index queries for the per-read evaluation emulator.

The device kernels (ops/rank.py, ops/search.py) run these same queries
batched over lanes; this module answers them for ONE read at a time in
numpy, for the faithful per-read replay of the reference's evaluation
model (align/hybrid.py).  Layout docs: index/format.py.

Local-index ("HGFM") searches need no FM at all: a 57,344 bp window
(hier_idx_common.h:24-31 geometry) is scanned directly for occurrences
of a backward-growing pattern — the result set is identical to the
reference's LocalGFM backward search (hgfm.h:1553-1711), position for
position, because both enumerate every occurrence of the same substring
in the same window.

Copied verbatim from hisat2_tpu/align/hostfm.py; only the imports are
rewritten, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..index.format import BLOCK_BASES, WORDS_PER_BLOCK, FMIndex

# hier_idx_common.h:24-31
LOCAL_SIZE = (1 << 16) - (1 << 13)      # 57,344
LOCAL_OVERLAP = 1 << 10                 # 1,024
LOCAL_INTERVAL = LOCAL_SIZE - LOCAL_OVERLAP
LOCAL_FTAB_K = 6                        # local_ftabChars


def _popcount32(x) -> int:
    return int(bin(int(x)).count("1"))


class HostFM:
    """Single-row / single-range FM queries over a host FMIndex."""

    def __init__(self, index: FMIndex):
        self.meta = index.meta
        self.bwt_words = np.asarray(index.bwt_words)
        self.occ = np.asarray(index.occ)
        self.mark_words = np.asarray(index.mark_words)
        self.mark_chk = np.asarray(index.mark_chk)
        self.sa_marked = np.asarray(index.sa_marked)
        self.ftab_top = np.asarray(index.ftab_top)
        self.ftab_bot = np.asarray(index.ftab_bot)
        self.fchr = np.asarray(index.fchr)
        self.ref_words = np.asarray(index.ref_words)
        self.frag_joined = np.asarray(index.frag_joined)
        self.frag_ref = np.asarray(index.frag_ref)
        self.frag_off = np.asarray(index.frag_off)
        self.zrow = self.meta.zrow
        self._decoded = {}              # ref id -> int8 genome (lazy)
        self._blk_cache = {}            # block -> decoded 128 BWT chars

    # ---- rank / LF -------------------------------------------------

    def _block_chars(self, blk: int) -> np.ndarray:
        ch = self._blk_cache.get(blk)
        if ch is None:
            w0 = blk * WORDS_PER_BLOCK
            words = self.bwt_words[w0:w0 + WORDS_PER_BLOCK].astype(
                np.uint32)
            idx = np.arange(BLOCK_BASES)
            ch = ((words[idx >> 4] >> ((idx & 15) << 1).astype(np.uint32))
                  & 3).astype(np.int8)
            self._blk_cache[blk] = ch
        return ch

    def rank(self, row: int, c: int) -> int:
        """# of BWT char c in rows [0, row), '$' slot excluded."""
        blk, rem = divmod(int(row), BLOCK_BASES)
        n = int(self.occ[blk, c])
        if rem:
            n += int(np.count_nonzero(self._block_chars(blk)[:rem] == c))
        # the '$' slot stores char 0; occ checkpoints already exclude it,
        # so correct only when zrow lies in the counted in-block remainder
        if c == 0 and blk * BLOCK_BASES <= self.zrow < row:
            n -= 1
        return n

    def bwt_char(self, row: int) -> int:
        return int(self._block_chars(int(row) // BLOCK_BASES)
                   [int(row) % BLOCK_BASES])

    def lf_range(self, top: int, bot: int, c: int):
        f = int(self.fchr[c])
        return f + self.rank(top, c), f + self.rank(bot, c)

    def lf_row(self, row: int) -> int:
        """One walk-left step: row of SA[row]-1 (row != zrow)."""
        c = self.bwt_char(row)
        return int(self.fchr[c]) + self.rank(row, c)

    def ftab_lohi(self, codes) -> tuple[int, int]:
        """ftabLoHi (gfm.h:3280): codes = the ftab_k chars, text order."""
        idx = 0
        for c in codes:
            if c > 3:
                return 0, 0
            idx = idx * 4 + int(c)
        return int(self.ftab_top[idx]), int(self.ftab_bot[idx])

    # ---- resolve ---------------------------------------------------

    def _marked(self, row: int) -> bool:
        return bool((int(self.mark_words[int(row) >> 5])
                     >> (int(row) & 31)) & 1)

    def _mark_rank(self, row: int) -> int:
        """# marked rows before `row` (mark_chk blocks of 4 words)."""
        blk = int(row) // BLOCK_BASES
        n = int(self.mark_chk[blk])
        w0 = blk * 4
        for wi in range(w0, int(row) >> 5):
            n += _popcount32(self.mark_words[wi])
        rem = int(row) & 31
        if rem:
            n += _popcount32(int(self.mark_words[int(row) >> 5])
                             & ((1 << rem) - 1))
        return n

    def resolve_row(self, row: int) -> int:
        """SA[row] (joined offset) via walk-left to a marked row."""
        steps = 0
        row = int(row)
        while not self._marked(row):
            if row == self.zrow:        # SA[zrow] == 0
                return steps            # (never: 0 % 2^r == 0 is marked)
            row = self.lf_row(row)
            steps += 1
        return int(self.sa_marked[self._mark_rank(row)]) + steps

    def joined_to_text(self, j: int) -> tuple[int, int]:
        """joined offset -> (ref id, ref offset) (gfm.h joinedToTextOff)."""
        f = int(np.searchsorted(self.frag_joined, j, side="right")) - 1
        return (int(self.frag_ref[f]),
                int(self.frag_off[f]) + (j - int(self.frag_joined[f])))

    def text_to_joined(self, tidx: int, toff: int) -> int:
        """(ref id, ref offset) -> joined offset; -1 if inside no fragment
        (an N gap squeezed out of the joined text)."""
        sel = np.flatnonzero(self.frag_ref == tidx)
        for f in sel:
            ln = int(self.frag_joined[f + 1] - self.frag_joined[f])
            off = int(self.frag_off[f])
            if off <= toff < off + ln:
                return int(self.frag_joined[f]) + (toff - off)
        return -1

    # ---- genome access ----------------------------------------------

    def ref_len(self, tidx: int) -> int:
        return int(self.meta.ref_lens[tidx])

    def genome(self, tidx: int) -> np.ndarray:
        """Decoded chromosome (int8; 4 = N in inter-fragment gaps)."""
        g = self._decoded.get(tidx)
        if g is None:
            g = np.full(self.ref_len(tidx), 4, np.int8)
            words = self.ref_words
            sel = np.flatnonzero(self.frag_ref == tidx)
            for f in sel:
                j0 = int(self.frag_joined[f])
                ln = int(self.frag_joined[f + 1]) - j0
                off = int(self.frag_off[f])
                idx = j0 + np.arange(ln, dtype=np.int64)
                chars = ((words[idx >> 4].astype(np.int64)
                          >> (2 * (idx & 15))) & 3).astype(np.int8)
                g[off:off + ln] = chars
            self._decoded[tidx] = g
        return g

    def stretch(self, tidx: int, toff: int, ln: int) -> np.ndarray:
        """ref.getStretch equivalent: ln chars from (tidx, toff), N(4)
        outside fragments / past the ends."""
        g = self.genome(tidx)
        out = np.full(ln, 4, np.int8)
        lo = max(int(toff), 0)
        hi = min(int(toff) + ln, len(g))
        if hi > lo:
            out[lo - int(toff):hi - int(toff)] = g[lo:hi]
        return out


def local_window(fm: HostFM, tidx: int, toff: int) -> tuple[int, int]:
    """(window start, length) of the local index covering (tidx, toff) —
    HGFM::getLocalGFM geometry (hgfm.h:1553, hier_idx_common.h)."""
    wi = max(int(toff), 0) // LOCAL_INTERVAL
    start = wi * LOCAL_INTERVAL
    return start, min(LOCAL_SIZE, fm.ref_len(tidx) - start)


def prev_local_window(start: int) -> int | None:
    return start - LOCAL_INTERVAL if start >= LOCAL_INTERVAL else None


def next_local_window(fm: HostFM, tidx: int, start: int) -> int | None:
    s = start + LOCAL_INTERVAL
    return s if s < fm.ref_len(tidx) else None


def local_search(win: np.ndarray, seq: np.ndarray, extoff: int,
                 min_unique: int, kseeds: int,
                 max_hitlen: int = 1 << 30, unique_stop: bool = True):
    """localGFMSearch (hi_aligner.h:5824) over a decoded window.

    Matches seq[extoff], seq[extoff-1], ... leftward; returns
    (nelt, extlen, end_positions, unique_stop) where end_positions are
    window offsets of the occurrence's LAST char (aligned to extoff).
    nelt == 0 when the node range exceeds kseeds (the reference drops
    oversized final ranges) or the ftab 6-mer has no occurrence.
    """
    L = len(seq)
    left = extoff + 1
    if left < LOCAL_FTAB_K + 1:
        return 0, left, None, False
    # ftab: 6 chars ending at extoff, N check first
    for i in range(LOCAL_FTAB_K):
        if seq[extoff - i] > 3:
            return 0, i + 1, None, False
    pat = seq[extoff - LOCAL_FTAB_K + 1:extoff + 1]
    W = len(win)
    if W < LOCAL_FTAB_K:
        return 0, LOCAL_FTAB_K, None, False
    sw = np.lib.stride_tricks.sliding_window_view(win, LOCAL_FTAB_K)
    ends = np.flatnonzero((sw == pat).all(axis=1)) + LOCAL_FTAB_K - 1
    if ends.size == 0:
        return 0, LOCAL_FTAB_K, None, False
    dep = LOCAL_FTAB_K
    cur = ends
    unique = False
    while extoff - dep >= 0:
        c = seq[extoff - dep]
        if c > 3:
            break
        nxt = cur[(cur - dep >= 0)]
        nxt = nxt[win[nxt - dep] == c]
        if nxt.size == 0:
            break
        cur = nxt
        dep += 1
        if unique_stop and cur.size == 1 and dep >= min_unique:
            unique = True
            break
        if dep >= max_hitlen:
            break
    if cur.size > kseeds:
        return 0, 0, None, False
    return int(cur.size), dep, cur, unique
