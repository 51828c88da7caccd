"""Writer for the reference's `.ht2` index format (linear FM indexes).

Emits a `.1`-`.8` set that is byte-identical to what `hisat2-build-s`
produces for the same FASTA (no-ALT, forward index), so the reference
aligner can run against indexes built by this package — the strongest
available builder-correctness oracle.

Layout authority (all in the hisat2 sources):
  - .1/.2 header + stream: GFM::writeFromMemory (gfm.h:6143-6227),
    linear GFM::buildToDisk (gfm.h:4704-5075), names tail
    (gfm.h:1999-2004), szsToDisk (gfm.h:1175, impl ~5410).
  - .3/.4: BitPairReference::szsFromFasta / ctor (reference.cpp).
  - .5/.6: HGFM prelude (hgfm.h:2157-2166) + LocalGFM ctor stream
    (hgfm.h:190-240) + LocalGFM::buildToDisk (hgfm.h:690-1100),
    index_t = uint16, full_index_t = uint32.
  - .7/.8: empty ALT/haplotype/name lists (gfm.h:1276-1310).

Geometry constants follow hisat2-build-s defaults: global lineRate 6 /
offRate 4 / ftabChars 10; local lineRate 6 / offRate 3 / ftabChars 6,
window 57,344 bp advancing 56,320 bp (hier_idx_common.h:24-41).

Copied verbatim from hisat2_tpu/index/ht2_write.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import numpy as np

from .builder import suffix_array

VERSION = 33619968          # 2.1.0's version word, observed in built .ht2
GLOBAL_LINE_RATE = 6
GLOBAL_OFF_RATE = 4
GLOBAL_FTAB_CHARS = 10
LOCAL_LINE_RATE = 6
LOCAL_OFF_RATE = 3
LOCAL_FTAB_CHARS = 6
LOCAL_SIZE = 57344
LOCAL_INTERVAL = 56320


def _u32(*vals):
    return np.asarray(vals, "<u4").tobytes()


def _i32(*vals):
    return np.asarray(vals, "<i4").tobytes()


def _records(codes: np.ndarray):
    """RefRecords (off = leading non-ACGT run, len = ACGT stretch) for
    one sequence, ref_read.h:94-103 semantics."""
    isn = codes > 3
    recs = []
    i, n = 0, len(codes)
    first = True
    while i < n:
        j = i
        while j < n and isn[j]:
            j += 1
        k = j
        while k < n and not isn[k]:
            k += 1
        if k > j or first:
            recs.append((j - i, k - j, first))
            first = False
        i = k
    if not recs:
        recs.append((0, 0, True))
    return recs


def _pack_2bit_lsb(codes: np.ndarray) -> np.ndarray:
    """4 bp/byte, base i at bits 2i (LSB-first), zero padded."""
    n = len(codes)
    pad = (-n) % 4
    c = np.concatenate([codes.astype(np.uint8),
                        np.zeros(pad, np.uint8)]).reshape(-1, 4)
    return (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4)
            | (c[:, 3] << 6)).astype(np.uint8)


def _fm_stream(text: np.ndarray, line_rate: int, off_rate: int,
               ftab_chars: int, dtype):
    """The linear buildToDisk stream pieces for `text` (uint8 codes 0-3):
    returns (sides bytes, zoff, fchr[5], ftab, eftab, offs) with
    index-typed arrays in `dtype` (gfm.h:4704-5075)."""
    text = np.ascontiguousarray(text, np.uint8)
    n = len(text)
    # The reference's blockwise SA sorts with the terminal sentinel as
    # the LARGEST character (the '$' suffix lands in the last row).
    # Equivalent: SA of the complemented text with a smallest sentinel,
    # reversed (verified offs-identical vs hisat2-build-s output).
    sa = suffix_array((3 - text).astype(np.uint8))[::-1].astype(np.int64)
    gbwt_len = n + 1
    # BWT chars; the '$' row (saElt == 0) is written as 'A' but not
    # counted (gfm.h:4816-4827)
    bwt = np.where(sa > 0, text[np.maximum(sa - 1, 0)], 0).astype(np.uint8)
    zoff = int(np.flatnonzero(sa == 0)[0])
    counted = np.ones(gbwt_len, bool)
    counted[zoff] = False

    side_sz = 1 << line_rate
    isz = np.dtype(dtype).itemsize
    side_gbwt = side_sz - 4 * isz               # bytes of 2-bit chars/side
    chars_per_side = side_gbwt * 4
    n_sides = (n // 4 + 1 + side_gbwt - 1) // side_gbwt
    tot_chars = n_sides * chars_per_side
    # pad rows beyond the SA with 'A', counted in occ (gfm.h:4875-4885)
    chars = np.zeros(tot_chars, np.uint8)
    chars[:gbwt_len] = bwt
    cflag = np.zeros(tot_chars, bool)
    cflag[:gbwt_len] = counted
    cflag[gbwt_len:] = True
    # occ totals at each side START (occSave, gfm.h:4918-4931)
    per_side = (chars.reshape(n_sides, chars_per_side)[:, :, None]
                == np.arange(4)[None, None, :])
    per_side &= cflag.reshape(n_sides, chars_per_side)[:, :, None]
    side_tot = per_side.sum(axis=1, dtype=np.int64)
    occ_start = np.zeros((n_sides, 4), np.int64)
    occ_start[1:] = np.cumsum(side_tot, axis=0)[:-1]
    packed = _pack_2bit_lsb(chars).reshape(n_sides, side_gbwt)
    sides = np.zeros((n_sides, side_sz), np.uint8)
    sides[:, :side_gbwt] = packed
    sides[:, side_gbwt:] = occ_start.astype(dtype).view(np.uint8) \
        .reshape(n_sides, 4 * isz)

    # fchr: cumulative char counts, shifted (gfm.h:4962-4977)
    cnt = np.bincount(text, minlength=4)[:4]
    fchr = np.zeros(5, np.int64)
    fchr[1:] = np.cumsum(cnt)

    # ftab histogram + absorb (gfm.h:4833-4867): walk rows in SA order
    ftab_len = (1 << (2 * ftab_chars)) + 1
    ftab = np.zeros(ftab_len, np.int64)
    long_mask = (n - sa) >= ftab_chars
    # sufInt: first ftab_chars chars of each long suffix, MSB-first
    li = np.flatnonzero(long_mask)
    if li.size:
        starts = sa[li]
        idx = starts[:, None] + np.arange(ftab_chars)[None, :]
        sufints = np.zeros(li.size, np.int64)
        cs = text[idx.reshape(-1)].reshape(li.size, ftab_chars)
        for k in range(ftab_chars):
            sufints = (sufints << 2) | cs[:, k]
        np.add.at(ftab, sufints + 1, 1)
    # absorb: short suffixes between long ones attach to the NEXT long
    # suffix's sufInt (or the final ftab slot)
    absorb = np.zeros(ftab_len, np.int64)
    short_rows = np.flatnonzero(~long_mask)
    if short_rows.size and li.size:
        # for each run of consecutive short rows, find following long row
        nxt = np.searchsorted(li, short_rows)
        trailing = nxt >= li.size
        valid = ~trailing
        if valid.any():
            tgt = sufints[nxt[valid]]
            np.add.at(absorb, tgt, 1)
        if trailing.any():
            absorb[ftab_len - 1] += int(trailing.sum())
    elif short_rows.size:
        absorb[ftab_len - 1] += short_rows.size

    # prefix-sum with eftab insertion (gfm.h:4986-5034)
    eftab_len = ftab_chars * 2
    eftab = np.zeros(eftab_len, np.int64)
    off_mask_val = (1 << (8 * isz)) - 1          # OFF_MASK for this width
    out_ftab = np.zeros(ftab_len, np.int64)
    eftab_cur = 0
    hi_prev = 0                                  # ftabHi(i-1), starts 0
    for i in range(1, ftab_len):
        lo = ftab[i] + hi_prev
        if absorb[i] > 0:
            hi = lo + absorb[i]
            eftab[eftab_cur * 2] = lo
            eftab[eftab_cur * 2 + 1] = hi
            out_ftab[i] = eftab_cur ^ off_mask_val
            eftab_cur += 1
            hi_prev = hi
        else:
            out_ftab[i] = lo
            hi_prev = lo

    offs = sa[:: 1 << off_rate]
    return (sides.tobytes(), zoff, fchr, out_ftab, eftab, offs)


def _szs_bytes(recs, dtype):
    """szsToDisk (gfm.h:5410-5436): (joined off, seq id, seq off) per
    nonzero-len record."""
    out = []
    seq = -1
    off = 0
    totlen = 0
    for roff, rlen, first in recs:
        if rlen == 0:
            continue
        if first:
            off = 0
            seq += 1
        off += roff
        out.extend([totlen, seq, off])
        totlen += rlen
        off += rlen
    return np.asarray(out, dtype).tobytes(), len(out) // 3


def export_ht2(seqs, base: str):
    """Write `<base>.{1..8}.ht2` for `seqs` = [(name, codes uint8 0-4)].

    Linear (no-ALT) forward index, byte-compatible with
    `hisat2-build-s <fasta> <base>`."""
    names = [nm for nm, _ in seqs]
    codes_list = [np.asarray(c, np.uint8) for _, c in seqs]
    plens = [len(c) for c in codes_list]
    all_recs = []
    for i, c in enumerate(codes_list):
        for roff, rlen, first in _records(c):
            all_recs.append((roff, rlen, first))
    joined = np.concatenate(
        [c[c <= 3] for c in codes_list]) if codes_list else \
        np.zeros(0, np.uint8)
    n = len(joined)

    sides, zoff, fchr, ftab, eftab, offs = _fm_stream(
        joined, GLOBAL_LINE_RATE, GLOBAL_OFF_RATE, GLOBAL_FTAB_CHARS,
        "<u4")
    rstarts, n_frag = _szs_bytes(all_recs, "<u4")

    flags = 1
    with open(base + ".1.ht2", "wb") as f1:
        f1.write(_i32(1))                        # endian
        f1.write(_i32(VERSION))
        f1.write(_u32(n))                        # len
        f1.write(_u32(n + 1))                    # gbwtLen (patched value)
        f1.write(_u32(n + 1))                    # numNodes
        f1.write(_i32(GLOBAL_LINE_RATE, 2, GLOBAL_OFF_RATE,
                      GLOBAL_FTAB_CHARS))
        f1.write(_u32(GLOBAL_FTAB_CHARS * 2))    # eftabLen (patched)
        f1.write(_i32(-flags))
        f1.write(_u32(len(names)))
        f1.write(np.asarray(plens, "<u4").tobytes())
        f1.write(_u32(n_frag))
        f1.write(rstarts)
        f1.write(sides)
        f1.write(_u32(1, zoff))                  # zOffs
        f1.write(fchr.astype("<u4").tobytes())
        f1.write(ftab.astype("<u4").tobytes())
        f1.write(eftab.astype("<u4").tobytes())
        for nm in names:
            f1.write(nm.encode() + b"\n")
        f1.write(b"\x00")
    with open(base + ".2.ht2", "wb") as f2:
        f2.write(_i32(1))
        f2.write(offs.astype("<u4").tobytes())

    # .3/.4: RefRecords + 2-bit packed N-free stream
    with open(base + ".3.ht2", "wb") as f3:
        f3.write(_i32(1))
        f3.write(_u32(len(all_recs)))
        for roff, rlen, first in all_recs:
            f3.write(_u32(roff, rlen))
            f3.write(bytes([1 if first else 0]))
    with open(base + ".4.ht2", "wb") as f4:
        f4.write(_pack_2bit_lsb(joined).tobytes())

    # .5/.6: local FM indexes (HGFM prelude + one LocalGFM per window)
    _write_locals(base, codes_list, plens)

    # .7/.8: empty ALT database
    with open(base + ".7.ht2", "wb") as f7:
        f7.write(_i32(1) + _u32(0, 0))
    with open(base + ".8.ht2", "wb") as f8:
        f8.write(_i32(1) + _u32(0))


def _write_locals(base: str, codes_list, plens):
    n_local = sum((pl + LOCAL_INTERVAL - 1) // LOCAL_INTERVAL
                  for pl in plens)
    f5 = open(base + ".5.ht2", "wb")
    f6 = open(base + ".6.ht2", "wb")
    f5.write(_i32(1))
    f6.write(_i32(1))
    f5.write(_u32(n_local))
    f5.write(_i32(LOCAL_LINE_RATE, 2, LOCAL_OFF_RATE, LOCAL_FTAB_CHARS))
    f5.write(_i32(-1))                           # -flags
    joined_before = 0          # N-free joined offset, GLOBAL across seqs
    for tidx, codes in enumerate(codes_list):
        pl = plens[tidx]
        local_off = 0
        while local_off < pl:
            wlen = min(pl - local_off, LOCAL_SIZE)
            window = codes[local_off:local_off + wlen]
            recs = _records(window)
            text = window[window <= 3]
            # the next window starts LOCAL_INTERVAL later; its joined
            # offset advances by the N-free length of the interval part
            interval_part = codes[local_off:local_off + LOCAL_INTERVAL]
            f5.write(_u32(tidx, local_off, joined_before))
            joined_before += int((interval_part <= 3).sum())
            local_off += LOCAL_INTERVAL

            u2 = lambda *v: np.asarray(v, "<u2").tobytes()
            if len(text) == 0:
                # empty (all-N) window: header fields only (hgfm.h:198)
                f5.write(u2(0, 0, 0, 0))
                continue
            sides, zoff, fchr, ftab, eftab, offs = _fm_stream(
                text, LOCAL_LINE_RATE, LOCAL_OFF_RATE, LOCAL_FTAB_CHARS,
                "<u2")
            rstarts, n_frag = _szs_bytes(recs, "<u2")
            f5.write(u2(len(text)))              # gh._len
            f5.write(u2(len(text) + 1))          # gbwtLen (patched)
            f5.write(u2(len(text) + 1))          # numNodes
            f5.write(u2(LOCAL_FTAB_CHARS * 2))   # eftabLen
            f5.write(u2(1))                      # nPat
            f5.write(u2(wlen))                   # plen (with Ns)
            f5.write(u2(n_frag))
            f5.write(rstarts)
            f5.write(sides)
            f5.write(u2(1, zoff))
            f5.write(fchr.astype("<u2").tobytes())
            f5.write(ftab.astype("<u2").tobytes())
            f5.write(eftab.astype("<u2").tobytes())
            f6.write(offs.astype("<u2").tobytes())
    f5.write(b"\x00")
    f5.close()
    f6.close()


# ---------------------------------------------------------------------------
# Graph (SNP/splice) index export — GBWT construction in index/gbwt.py,
# serialization here.  Layout authority: gfm.h:4276-4704 (graph
# buildToDisk), gfm.h:147-182 (graph side geometry: chars in the low
# half, F/M bitvectors in quarters, 6 x index_t tail {F_locSave,
# M_occSave, occSave[0..3]}), hgfm.h:91-740 (graph LocalGFM stream).

GRAPH_LINE_RATE = 7            # default_lineRate_gfm, gfm.h:3907
LOCAL_GRAPH_LINE_RATE = 7      # local_lineRate_gfm, hier_idx_common.h:35


def _pack_bits_lsb(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8), bitorder="little")


def _graph_sides(bwt, F, M, pos, line_rate, off_rate, dtype):
    """Pack GBWT row streams into graph sides; returns (sides bytes,
    zoffs, fchr, offs) per GFM::buildToDisk (gfm.h:4377-4540)."""
    isz = np.dtype(dtype).itemsize
    side_sz = 1 << line_rate
    side_gbwt = side_sz - 6 * isz
    rows_per_side = side_gbwt * 2
    gbwt_len = len(bwt)
    gbwt_sz = gbwt_len // 2 + 1
    n_sides = (gbwt_sz + side_gbwt - 1) // side_gbwt
    tot_rows = n_sides * rows_per_side
    zoffs = np.flatnonzero(bwt == 5).astype(np.int64)
    chars = np.zeros(tot_rows, np.uint8)
    chars[:gbwt_len] = np.where(bwt == 5, 0, bwt)    # Z packs as A
    Fp = np.zeros(tot_rows, np.uint8)
    Fp[:gbwt_len] = F
    Mp = np.zeros(tot_rows, np.uint8)
    Mp[:gbwt_len] = M
    # counted chars: real non-Z rows AND padding rows (pads count as A,
    # gfm.h:4427-4436)
    counted = np.ones(tot_rows, bool)
    counted[zoffs] = False
    occ_cum = np.zeros((tot_rows + 1, 4), np.int64)
    for c in range(4):
        occ_cum[1:, c] = np.cumsum((chars == c) & counted)
    m_cum = np.concatenate([[0], np.cumsum(Mp.astype(np.int64))])
    f_pos = np.flatnonzero(Fp[:gbwt_len] == 1).astype(np.int64)

    side_starts = np.arange(n_sides) * rows_per_side
    occ_save = occ_cum[side_starts]                  # [n_sides, 4]
    m_save = m_cum[side_starts]
    # F_locSave: F start row of the last node whose M==1 row came
    # before side start (0 before any)
    if len(f_pos):
        f_save = np.where(m_save > 0, f_pos[np.maximum(m_save - 1, 0)], 0)
    else:
        f_save = np.zeros(len(m_save), np.int64)

    half = side_gbwt // 2
    quart = side_gbwt // 4
    ch_bytes = _pack_2bit_lsb(chars).reshape(n_sides, half)
    f_bytes = _pack_bits_lsb(Fp).reshape(n_sides, quart)
    m_bytes = _pack_bits_lsb(Mp).reshape(n_sides, quart)
    sides = np.zeros((n_sides, side_sz), np.uint8)
    sides[:, :half] = ch_bytes
    sides[:, half:half + quart] = f_bytes
    sides[:, half + quart:side_gbwt] = m_bytes
    tail = np.stack([f_save, m_save, occ_save[:, 0], occ_save[:, 1],
                     occ_save[:, 2], occ_save[:, 3]], 1)
    sides[:, side_gbwt:] = tail.astype(dtype).view(np.uint8) \
        .reshape(n_sides, 6 * isz)

    # fchr: counts over real non-Z rows only (pads excluded)
    creal = np.ones(gbwt_len, bool)
    creal[zoffs] = False
    cnt = np.bincount(chars[:gbwt_len][creal], minlength=4)[:4]
    fchr = np.zeros(5, np.int64)
    fchr[1:] = np.cumsum(cnt)

    # SA sample: every 2^off_rate-th node's pos (gfm.h:4414-4420)
    offs = pos[::1 << off_rate]
    return sides.tobytes(), zoffs, fchr, offs, n_sides


class _GbwtSearch:
    """Host mapGLF/mapGLF1 over the raw streams, for ftab construction
    (gfm.h:3358-3620 semantics, vectorized)."""

    def __init__(self, bwt, F, M, fchr):
        n = len(bwt)
        self.n = n
        self.occ = np.zeros((5, n + 1), np.int64)
        zmask = bwt == 5
        for c in range(4):
            self.occ[c, 1:] = np.cumsum((bwt == c) & ~zmask)
        self.rank_m = np.concatenate(
            [[0], np.cumsum(M.astype(np.int64))])
        f1 = np.flatnonzero(F == 1).astype(np.int64)
        self.f1pos = np.concatenate([f1, [n]])
        self.fchr = fchr
        self.bwt = bwt

    def glf_range(self, top, bot, c):
        """mapGLF on ranges (vectorized); returns (top', bot')."""
        t2 = self.fchr[c] + self.occ[c, top]
        b2 = self.fchr[c] + self.occ[c, bot]
        bad = (t2 + 1 >= self.n) | (t2 >= b2)
        t2c = np.where(bad, 0, t2)
        b2c = np.where(bad, 1, b2)
        node_top = self.rank_m[t2c + 1] - 1
        node_bot = self.rank_m[b2c]
        t3 = self.f1pos[node_top]
        b3 = self.f1pos[node_bot]
        return np.where(bad, 0, t3), np.where(bad, 0, b3)

    def glf1(self, row, c):
        """mapGLF1: single-row LF (requires bwt[row] == c), then the
        target node's full F-range."""
        ok = self.bwt[row] == c
        t2 = self.fchr[c] + self.occ[c, row]
        bad = ~ok | (t2 + 1 >= self.n)
        t2c = np.where(bad, 0, t2)
        node_top = self.rank_m[t2c + 1] - 1
        t3 = self.f1pos[node_top]
        b3 = self.f1pos[node_top + 1]
        return np.where(bad, 0, t3), np.where(bad, 0, b3)


def _graph_ftab(bwt, F, M, fchr, ftab_chars, dtype):
    """ftab/eftab via ftabChars-step backward searches
    (gfm.h:4560-4665)."""
    sr = _GbwtSearch(bwt, F, M, fchr)
    n_q = 1 << (2 * ftab_chars)
    top = np.zeros(n_q, np.int64)
    bot = np.full(n_q, sr.n, np.int64)
    alive = np.ones(n_q, bool)
    q = np.arange(n_q, dtype=np.int64)
    for j in range(ftab_chars):
        nt = (q >> (2 * j)) & 3
        w1 = (bot - top) == 1
        t_r, b_r = sr.glf_range(top, bot, nt)
        t_1, b_1 = sr.glf1(top, nt)
        nt_top = np.where(w1, t_1, t_r)
        nt_bot = np.where(w1, b_1, b_r)
        dead = nt_top >= nt_bot
        alive &= ~dead
        top = np.where(alive, nt_top, top)
        bot = np.where(alive, nt_bot, bot)
    # failures chain to the previous entry's bot (gfm.h:4610-4618)
    t_first = np.where(alive, top, -1)
    t_second = np.where(alive, bot, -1)
    # sequential fill: tFtab[i] = (prev.second, prev.second) on failure
    fail = ~alive
    if fail.any():
        prev = np.maximum.accumulate(
            np.where(fail, -1, np.arange(n_q)))
        # entry 0 failure -> (0, 0)
        carried = np.where(prev >= 0, t_second[np.maximum(prev, 0)], 0)
        t_first = np.where(fail, carried, t_first)
        t_second = np.where(fail, carried, t_second)
    # assemble ftab/eftab (gfm.h:4636-4660)
    off_mask_val = (1 << (8 * np.dtype(dtype).itemsize)) - 1
    ftab = np.zeros(n_q + 1, np.int64)
    ftab[0] = t_first[0]
    ftab[1] = t_second[0]
    eftab = []
    # boundary mismatches: ftab[i] (== tFtab[i-1].second) vs tFtab[i].first
    mism = np.flatnonzero(t_second[:-1] != t_first[1:]) + 1
    ftab[1:] = t_second
    for k, i in enumerate(mism):
        eftab.append(int(t_second[i - 1]))
        eftab.append(int(t_first[i]))
        ftab[i] = k ^ off_mask_val
    return ftab, np.asarray(eftab, np.int64)


def _remap_window_alts(alts, haps, lo, hi):
    """ALTs/haplotypes overlapping joined window [lo, hi), coords
    shifted to window space (hgfm.h:2236-2295)."""
    out, amap = [], {}
    for i, a in enumerate(alts):
        t = a["type"]
        if t == "single":
            if hi <= a["pos"]:
                break
            inside = lo <= a["pos"]
        elif t == "insertion":
            if hi < a["pos"]:
                break
            inside = lo <= a["pos"]
        elif t == "deletion":
            if hi < a["pos"] + a["len"]:
                break
            inside = lo <= a["pos"]
        elif t == "splicesite":
            if a.get("excluded"):
                continue
            if hi <= a["right"] + 1:
                continue
            inside = lo <= a["left"]
        else:
            continue
        if not inside:
            continue
        b = dict(a)
        if t == "splicesite":
            b["left"] -= lo
            b["right"] -= lo
        else:
            b["pos"] -= lo
            amap[i] = len(out)
        out.append(b)
    whaps = []
    for h in haps:
        if hi <= h["right"] or lo > h["left"]:
            continue
        ok = all(a in amap for a in h["alts"])
        if not ok:
            continue
        whaps.append({"left": h["left"] - lo, "right": h["right"] - lo,
                      "alts": [amap[a] for a in h["alts"]]})
    return out, whaps


ALT_TYPE_CODE = {"single": 1, "insertion": 2, "deletion": 3,
                 "splicesite": 5, "exon": 6}


def _alt_records(alts):
    """ALT::write records (alt.h:189-196): pos u32, type u32, len u32,
    seq u64."""
    recs = []
    for a in alts:
        t = a["type"]
        code = ALT_TYPE_CODE[t]
        if t in ("splicesite", "exon"):
            pos, ln = a["left"], a["right"]
            seq = (1 if a.get("fw", True) else 0) \
                | (256 if a.get("excluded") else 0)
        elif t == "single":
            pos, ln = a["pos"], 1
            seq = int(a["seq"][0])
        elif t == "deletion":
            pos, ln = a["pos"], a["len"]
            seq = 0
        else:
            pos, ln = a["pos"], a["len"]
            seq = 0
            for c in a["seq"]:
                seq = (seq << 2) | int(c)
        recs.append((pos, code, ln, seq))
    return recs


def write_alt_files(base, alts, altnames, haps):
    """`.7/.8.ht2` with ALT records + haplotypes (gfm.h:1812-1830)."""
    with open(base + ".7.ht2", "wb") as f7, \
            open(base + ".8.ht2", "wb") as f8:
        f7.write(_i32(1))
        f8.write(_i32(1))
        recs = _alt_records(alts)
        f7.write(_u32(len(recs)))
        f8.write(_u32(len(recs)))
        for pos, code, ln, seq in recs:
            f7.write(_u32(pos, code, ln))
            f7.write(np.asarray([seq], "<u8").tobytes())
        for nm in altnames:
            f8.write(nm.encode() + b"\n")
        f7.write(_u32(len(haps)))
        for h in haps:
            f7.write(_u32(h["left"], h["right"], len(h["alts"]),
                          *h["alts"]))


def _graph_fm_stream(text, alts, haps, line_rate, off_rate, ftab_chars,
                     dtype):
    """GBWT stream pieces for one (sub)genome with variants: returns
    (sides, zoffs, fchr, ftab, eftab, offs, gbwt_len, num_nodes)."""
    from .gbwt import build_gbwt
    st = build_gbwt(np.ascontiguousarray(text, np.uint8), alts,
                    haplotypes=haps)
    sides, zoffs, fchr, offs, _ = _graph_sides(
        st["bwt"], st["F"], st["M"], st["pos"], line_rate, off_rate,
        dtype)
    ftab, eftab = _graph_ftab(st["bwt"], st["F"], st["M"], fchr,
                              ftab_chars, dtype)
    return (sides, zoffs, fchr, ftab, eftab, offs,
            len(st["bwt"]), st["num_nodes"])


def export_ht2_graph(seqs, alts, altnames, haps, base: str):
    """Write `<base>.{1..8}.ht2` for a GRAPH index (SNPs/splice sites),
    byte-compatible with `hisat2-build-s --snp/--ss <fasta> <base>`.

    seqs: [(name, codes uint8 0-4)]; alts/haps in JOINED coords, sorted
    by the reference's ALT order (alt.h:57-70); altnames parallel to
    alts."""
    names = [nm for nm, _ in seqs]
    codes_list = [np.asarray(c, np.uint8) for _, c in seqs]
    plens = [len(c) for c in codes_list]
    all_recs = []
    for c in codes_list:
        for rec in _records(c):
            all_recs.append(rec)
    joined = np.concatenate(
        [c[c <= 3] for c in codes_list]) if codes_list else \
        np.zeros(0, np.uint8)
    n = len(joined)

    (sides, zoffs, fchr, ftab, eftab, offs, gbwt_len,
     num_nodes) = _graph_fm_stream(joined, alts, haps, GRAPH_LINE_RATE,
                                   GLOBAL_OFF_RATE, GLOBAL_FTAB_CHARS,
                                   "<u4")
    rstarts, n_frag = _szs_bytes(all_recs, "<u4")

    flags = 1
    with open(base + ".1.ht2", "wb") as f1:
        f1.write(_i32(1))
        f1.write(_i32(VERSION))
        f1.write(_u32(n))
        f1.write(_u32(gbwt_len))
        f1.write(_u32(num_nodes))
        f1.write(_i32(GRAPH_LINE_RATE, 2, GLOBAL_OFF_RATE,
                      GLOBAL_FTAB_CHARS))
        f1.write(_u32(len(eftab)))
        f1.write(_i32(-flags))
        f1.write(_u32(len(names)))
        f1.write(np.asarray(plens, "<u4").tobytes())
        f1.write(_u32(n_frag))
        f1.write(rstarts)
        f1.write(sides)
        f1.write(_u32(len(zoffs), *zoffs.tolist()))
        f1.write(fchr.astype("<u4").tobytes())
        f1.write(ftab.astype("<u4").tobytes())
        f1.write(eftab.astype("<u4").tobytes())
        for nm in names:
            f1.write(nm.encode() + b"\n")
        f1.write(b"\x00")
    with open(base + ".2.ht2", "wb") as f2:
        f2.write(_i32(1))
        f2.write(offs.astype("<u4").tobytes())

    with open(base + ".3.ht2", "wb") as f3:
        f3.write(_i32(1))
        f3.write(_u32(len(all_recs)))
        for roff, rlen, first in all_recs:
            f3.write(_u32(roff, rlen))
            f3.write(bytes([1 if first else 0]))
    with open(base + ".4.ht2", "wb") as f4:
        f4.write(_pack_2bit_lsb(joined).tobytes())

    _write_locals_graph(base, codes_list, plens, alts, haps)
    write_alt_files(base, alts, altnames, haps)


def _write_locals_graph(base: str, codes_list, plens, alts, haps):
    """Local indexes for a graph .5/.6: linear windows stream like the
    no-ALT case, variant windows get their own little GBWT; prelude
    lineRate = local_lineRate_gfm = 7 (hgfm.h:1975-1981, 2150-2416)."""
    n_local = sum((pl + LOCAL_INTERVAL - 1) // LOCAL_INTERVAL
                  for pl in plens)
    f5 = open(base + ".5.ht2", "wb")
    f6 = open(base + ".6.ht2", "wb")
    f5.write(_i32(1))
    f6.write(_i32(1))
    f5.write(_u32(n_local))
    f5.write(_i32(LOCAL_GRAPH_LINE_RATE, 2, LOCAL_OFF_RATE,
                  LOCAL_FTAB_CHARS))
    f5.write(_i32(-1))
    joined_before = 0
    u2 = lambda *v: np.asarray(v, "<u2").tobytes()
    for tidx, codes in enumerate(codes_list):
        pl = plens[tidx]
        local_off = 0
        while local_off < pl:
            wlen = min(pl - local_off, LOCAL_SIZE)
            window = codes[local_off:local_off + wlen]
            recs = _records(window)
            text = window[window <= 3]
            interval_part = codes[local_off:local_off + LOCAL_INTERVAL]
            f5.write(_u32(tidx, local_off, joined_before))
            lo = joined_before
            hi = joined_before + len(text)
            joined_before += int((interval_part <= 3).sum())
            local_off += LOCAL_INTERVAL
            if len(text) == 0:
                f5.write(u2(0, 0, 0, 0))
                continue
            walts, whaps = _remap_window_alts(alts, haps, lo, hi)
            if not walts:
                s_, zoff, fchr, ftab, eftab, offs = _fm_stream(
                    text, LOCAL_GRAPH_LINE_RATE, LOCAL_OFF_RATE,
                    LOCAL_FTAB_CHARS, "<u2")
                gbwt_len = len(text) + 1
                num_nodes = len(text) + 1
                zoffs = [zoff]
            else:
                (s_, zoffs_a, fchr, ftab, eftab, offs, gbwt_len,
                 num_nodes) = _graph_fm_stream(
                    text, walts, whaps, LOCAL_GRAPH_LINE_RATE,
                    LOCAL_OFF_RATE, LOCAL_FTAB_CHARS, "<u2")
                zoffs = zoffs_a.tolist()
            rstarts, n_frag = _szs_bytes(recs, "<u2")
            f5.write(u2(len(text)))
            f5.write(u2(gbwt_len))
            f5.write(u2(num_nodes))
            f5.write(u2(len(eftab)))
            f5.write(u2(1))
            f5.write(u2(wlen))
            f5.write(u2(n_frag))
            f5.write(rstarts)
            f5.write(s_)
            f5.write(u2(len(zoffs), *zoffs))
            f5.write(np.asarray(fchr, "<u2").tobytes())
            f5.write(np.asarray(ftab, "<u2").tobytes())
            f5.write(np.asarray(eftab, "<u2").tobytes())
            f6.write(np.asarray(offs, "<u2").tobytes())
    f5.write(b"\x00")
    f5.close()
    f6.close()


def parse_alt_files(seqs, snp_file=None, ss_file=None, exon_file=None,
                    haplotype_file=None):
    """Parse the reference's .snp/.ss/.exon/.haplotype text inputs into
    (alts, altnames, haplotypes) in JOINED coordinates, replicating the
    GFM ctor's skip rules and final sort (gfm.h:1311-1795):
      - positions inside N runs skipped; del/ins at a record start
        skipped; non-ACGT or ref-equal SNV alleles skipped; >32 bp
        insertions skipped
      - ss: exonic->intronic shift, flank-in-N check, adjacent-dup
        dedup (only when 16 bp motif flanks exist), excluded flag for
        repeated 16+16 motifs
      - final ALT sort (pos, INS-first, enum, len, seq) with altnames
        permuted and haplotype alt indices remapped; haplotypes sorted
        by (left, right)
    """
    names = [nm for nm, _ in seqs]
    codes_list = [np.asarray(c, np.uint8) for _, c in seqs]
    name_idx = {nm.split()[0]: i for i, nm in enumerate(names)}
    # per-chr records + cumulative joined starts
    recs_per = [_records(c) for c in codes_list]
    chr_joined = []
    tot = 0
    for c in codes_list:
        chr_joined.append(tot)
        tot += int((c <= 3).sum())
    jlen = tot
    joined = np.concatenate([c[c <= 3] for c in codes_list]) \
        if codes_list else np.zeros(0, np.uint8)

    def to_joined(ci, gpos, is_gap):
        """gfm.h:1356-1396 record walk; None == involve_Ns/skip."""
        pos = gpos
        add = 0
        for roff, rlen, _f in recs_per[ci]:
            if pos < roff:
                return None
            pos -= roff
            if pos == 0 and is_gap:
                return None
            if pos < rlen:
                break
            pos -= rlen
            add += rlen
        else:
            return None
        j = chr_joined[ci] + add + pos
        nxt = chr_joined[ci + 1] if ci + 1 < len(chr_joined) else jlen
        if j >= nxt:
            return None
        return j

    def pos_ok(ci, gpos):
        """checkPosToSzs: gpos falls inside an ACGT record."""
        pos = gpos
        for roff, rlen, _f in recs_per[ci]:
            if pos < roff:
                return False
            pos -= roff
            if pos < rlen:
                return True
            pos -= rlen
        return False

    alts, altnames = [], []
    id2num = {}
    base_code = {"A": 0, "C": 1, "G": 2, "T": 3}
    if snp_file:
        with open(snp_file) as f:
            for line in f:
                p = line.split()
                if not p or p[0].startswith("#") or len(p) < 5:
                    continue
                sid, typ, chrom, gp, arg = p[:5]
                ci = name_idx.get(chrom)
                if ci is None or typ not in ("single", "deletion",
                                             "insertion"):
                    continue
                j = to_joined(ci, int(gp), typ != "single")
                if j is None:
                    continue
                if typ == "single":
                    ch = arg.upper()
                    if ch not in base_code or base_code[ch] == joined[j]:
                        continue
                    alts.append({"type": "single", "pos": j, "len": 1,
                                 "seq": [base_code[ch]]})
                elif typ == "deletion":
                    alts.append({"type": "deletion", "pos": j,
                                 "len": int(arg)})
                else:
                    if len(arg) > 32 or any(c.upper() not in base_code
                                            for c in arg):
                        continue
                    alts.append({"type": "insertion", "pos": j,
                                 "len": len(arg),
                                 "seq": [base_code[c.upper()]
                                         for c in arg]})
                altnames.append(sid)
                id2num[sid] = len(alts) - 1

    haps = []
    if haplotype_file and alts:
        with open(haplotype_file) as f:
            for line in f:
                p = line.split()
                if not p or p[0].startswith("#") or len(p) < 5:
                    continue
                _hid, chrom, left, right, alt_list = p[:5]
                ci = name_idx.get(chrom)
                if ci is None:
                    continue
                jl = to_joined(ci, int(left), False)
                jr = to_joined(ci, int(right), False)
                if jl is None or jr is None:
                    continue
                ha = [id2num[a] for a in alt_list.split(",")
                      if a in id2num]
                if not ha:
                    continue
                haps.append({"left": jl, "right": jr, "alts": ha})
        haps.sort(key=lambda h: (h["left"], h["right"]))
    elif alts:
        from .gbwt import default_haplotypes
        haps = default_haplotypes(alts)

    if ss_file:
        ss_seq_count = {}
        ss_list = []
        with open(ss_file) as f:
            for line in f:
                p = line.split()
                if not p or p[0].startswith("#") or len(p) < 4:
                    continue
                chrom, l_s, r_s, strand = p[:4]
                ci = name_idx.get(chrom)
                if ci is None:
                    continue
                left, right = int(l_s) + 1, int(r_s) - 1
                if left >= right:
                    continue
                if not pos_ok(ci, left - 1) or not pos_ok(ci, right + 1):
                    continue
                jl = to_joined(ci, left, False)
                jr = to_joined(ci, right, False)
                if jl is None or jr is None:
                    continue
                key = None
                if jl >= 16 and jr + 17 <= jlen:
                    if alts and alts[-1]["type"] == "splicesite" \
                            and alts[-1]["left"] == jl \
                            and alts[-1]["right"] == jr:
                        continue
                    seqv = 0
                    for c in joined[jl - 16:jl]:
                        seqv = (seqv << 2) | int(c)
                    for c in joined[jr + 1:jr + 17]:
                        seqv = (seqv << 2) | int(c)
                    key = seqv
                    ss_seq_count[key] = ss_seq_count.get(key, 0) + 1
                a = {"type": "splicesite", "left": jl, "right": jr,
                     "fw": strand == "+", "excluded": False, "_k": key}
                alts.append(a)
                altnames.append("ss")
                ss_list.append(a)
        for a in ss_list:
            if a["_k"] is not None:
                a["excluded"] = ss_seq_count[a["_k"]] > 1
        for a in ss_list:
            del a["_k"]

    if exon_file:
        with open(exon_file) as f:
            for line in f:
                p = line.split()
                if not p or p[0].startswith("#") or len(p) < 4:
                    continue
                chrom, l_s, r_s, strand = p[:4]
                ci = name_idx.get(chrom)
                if ci is None:
                    continue
                left, right = int(l_s) + 1, int(r_s) - 1
                if left >= right:
                    continue
                jl = to_joined(ci, left, False)
                jr = to_joined(ci, right, False)
                if jl is None or jr is None:
                    continue
                alts.append({"type": "exon", "left": jl, "right": jr,
                             "fw": strand == "+", "excluded": False})
                altnames.append("exon")

    # final sort (alt.h:57-70 operator<) with haplotype remap
    enum_code = {"single": 1, "insertion": 2, "deletion": 3,
                 "splicesite": 5, "exon": 6}

    def altkey(a):
        t = a["type"]
        sqv = 0
        for c in a.get("seq", []):
            sqv = sqv * 4 + int(c)
        if t in ("splicesite", "exon"):
            sqv = (1 if a.get("fw", True) else 0) \
                + (256 if a.get("excluded") else 0)
        return (a.get("pos", a.get("left")),
                -1 if t == "insertion" else enum_code[t],
                a.get("len", a.get("right", 0)), sqv)

    order = sorted(range(len(alts)), key=lambda i: altkey(alts[i]))
    inv = {old: new for new, old in enumerate(order)}
    alts = [alts[i] for i in order]
    altnames = [altnames[i] for i in order]
    for h in haps:
        h["alts"] = [inv[a] for a in h["alts"]]
    return alts, altnames, haps
