"""FM index construction: FASTA -> suffix array -> packed TPU layout.

The reference builds its index with Kärkkäinen blockwise suffix sorting
(hisat2's blockwise_sa.h) or, for graph indexes, GCSA prefix doubling
(hisat2's gbwt_graph.h:1501).  Both are sort-dominated; here we use a
fully-vectorized prefix-doubling suffix sort (numpy lexsort) — the same
asymptotic shape as PathGraph's generation loop but over a plain text — which
handles multi-megabase references in seconds.  Whole-genome scale builds the
hierarchy of local indexes instead (one window at a time), mirroring the
reference HGFM build (hgfm.h:2150-2416).

N handling mirrors ref_read.cpp: runs of non-ACGT are *excluded* from the
joined text; each maximal ACGT stretch becomes a fragment with its own
(ref id, ref offset) record, and alignments may not span fragments.

Copied verbatim from hisat2_tpu/index/builder.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import numpy as np

from ..utils import bitops
from .format import BLOCK_BASES, DEFAULT_FTAB_K, FMIndex, FMMeta


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of `text` (uint8 codes 0..3) + implicit terminal sentinel.

    Returns int32 sa of length len(text)+1; sa[0] == len(text) (the "$"
    suffix).  Uses the native linear-time SA-IS builder (native/sais.cpp)
    when the C++ toolchain is available — ~25x faster than the numpy
    fallback and the piece that makes chromosome-scale builds practical —
    otherwise prefix doubling with numpy lexsort (O(n log^2 n)).
    """
    if len(text) >= 1 << 16:
        from ..native import suffix_array_native
        sa = suffix_array_native(text)
        if sa is not None:
            return sa.astype(np.int32) if sa.dtype != np.int32 else sa
    n = len(text)
    # Shift alphabet by +1 so 0 is the unique smallest sentinel.
    rank = np.zeros(n + 1, dtype=np.int64)
    rank[:n] = text.astype(np.int64) + 1
    k = 1
    m = n + 1
    order = np.argsort(rank, kind="stable").astype(np.int64)
    # refine ranks after initial single-char sort
    r_sorted = rank[order]
    changed = np.empty(m, dtype=np.int64)
    changed[0] = 0
    changed[1:] = (r_sorted[1:] != r_sorted[:-1]).astype(np.int64)
    new_sorted = np.cumsum(changed)
    rank[order] = new_sorted
    while rank[order[-1]] != m - 1:
        key2 = np.full(m, -1, dtype=np.int64)
        key2[: m - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        changed[0] = 0
        changed[1:] = ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).astype(np.int64)
        new_sorted = np.cumsum(changed)
        rank[order] = new_sorted
        k <<= 1
    return order.astype(np.int32)


def _fragments_from_seqs(seqs):
    """Split (name, codes) sequences at non-ACGT runs into fragments.

    Returns (joined_codes, frag_joined[F], frag_ref[F], frag_off[F],
             ref_names, ref_lens).
    """
    joined_parts = []
    frag_joined, frag_ref, frag_off = [], [], []
    ref_names, ref_lens = [], []
    joined_len = 0
    for rid, (name, codes) in enumerate(seqs):
        ref_names.append(name)
        ref_lens.append(len(codes))
        is_acgt = codes < 4
        if not is_acgt.any():
            continue
        # boundaries of maximal ACGT runs
        d = np.diff(is_acgt.astype(np.int8))
        starts = np.flatnonzero(d == 1) + 1
        ends = np.flatnonzero(d == -1) + 1
        if is_acgt[0]:
            starts = np.concatenate([[0], starts])
        if is_acgt[-1]:
            ends = np.concatenate([ends, [len(codes)]])
        for s, e in zip(starts, ends):
            joined_parts.append(codes[s:e])
            frag_joined.append(joined_len)
            frag_ref.append(rid)
            frag_off.append(int(s))
            joined_len += e - s
    joined = (np.concatenate(joined_parts) if joined_parts
              else np.zeros(0, dtype=np.uint8))
    # frag_joined is int64: the GLOBAL joined space of a multi-gigabase
    # genome exceeds int32 (shard-local tables re-narrow in the builder)
    return (joined, np.asarray(frag_joined, np.int64),
            np.asarray(frag_ref, np.int32), np.asarray(frag_off, np.int64),
            tuple(ref_names), tuple(int(x) for x in ref_lens))


def _build_ftab(text: np.ndarray, k: int):
    """[top,bot) for every k-mer (GFM ftab, gfm.h:3280 ftabLoHi).

    Encode each suffix's first k chars in base 5 with sentinel 0 (so
    short suffixes sort strictly below every full k-mer).  The SA-sorted
    key array is just the multiset of suffix keys in sorted order, so
    top[m] = #{keys < key(m)} and bot[m] = top[m] + #{keys == key(m)} —
    a chunked histogram + prefix sum, with no per-suffix int64 array
    materialized (the old searchsorted path held three 8n-byte
    temporaries: >70 GB at genome scale)."""
    n = len(text)
    pows = 5 ** np.arange(k - 1, -1, -1)
    hist = np.zeros(5 ** k, dtype=np.int64)
    CH = CHUNK_ROWS
    for p0 in range(0, n + 1, CH):
        p1 = min(n + 1, p0 + CH)
        t5 = np.zeros(p1 - p0 + k, dtype=np.int64)
        src = text[p0:min(n, p1 + k - 1)]
        t5[:len(src)] = src
        t5[:len(src)] += 1
        win = np.lib.stride_tricks.sliding_window_view(t5, k)[: p1 - p0]
        hist += np.bincount(win @ pows, minlength=5 ** k)
    cum = np.zeros(5 ** k + 1, dtype=np.int64)
    np.cumsum(hist, out=cum[1:])
    # key of kmer m: digits (base-4) + 1, in base 5
    m = np.arange(4 ** k, dtype=np.int64)
    km = np.zeros(4 ** k, dtype=np.int64)
    for j in range(k):
        km += (((m >> (2 * (k - 1 - j))) & 3) + 1) * pows[j]
    top = cum[km]
    bot = top + hist[km]
    return top.astype(np.int32), bot.astype(np.int32)





# largest joined text per shard: keeps every row/offset (incl. diagonal
# margins) inside int32 — whole genomes shard across sub-indexes, the
# reference's 64-bit -l flavor territory (hisat2:444-457)
SHARD_LIMIT_BP = 1_900_000_000

# rows per streamed derivation chunk (_build_single/_build_ftab); a
# multiple of BLOCK_BASES and 32 so block/mark-word boundaries never
# straddle chunks.  Patchable in tests to force multi-chunk coverage.
CHUNK_ROWS = 1 << 26


def build_fm_index(seqs, off_rate: int = None,
                   ftab_k: int = DEFAULT_FTAB_K,
                   shard_bp: int = None):
    """Build the full TPU-layout FM index from [(name, codes), ...].

    off_rate None picks adaptively: genomes under 128 Mbp store the FULL
    suffix array (off_rate 0 — SA resolution becomes one HBM gather, the
    dominant cost of the aligner's device step); larger genomes sample
    every 16th text position like the reference (offRate 4, gfm.h).

    Genomes larger than shard_bp (default 1.9 Gbp, the int32 row bound)
    return a ShardedFMIndex: fragments are grouped greedily into
    sub-indexes, each a complete standalone FM index; the aligner runs
    every shard and merges candidates with global joined coordinates."""
    frags = _fragments_from_seqs(seqs)
    joined, frag_joined, frag_ref, frag_off, ref_names, ref_lens = frags
    n = len(joined)
    if n == 0:
        raise ValueError("reference contains no ACGT bases")
    limit = shard_bp or SHARD_LIMIT_BP
    if n > limit:
        from .format import ShardedFMIndex
        fj = np.append(np.asarray(frag_joined, np.int64), n)
        sizes = np.diff(fj)
        groups, cur, cur_bp = [], [], 0
        for fi, sz in enumerate(sizes):
            if cur and cur_bp + sz > limit:
                groups.append(cur)
                cur, cur_bp = [], 0
            cur.append(fi)
            cur_bp += int(sz)
        if cur:
            groups.append(cur)
        shards, bases = [], []
        for g in groups:
            base = int(fj[g[0]])
            gjoined = joined[fj[g[0]]:fj[g[-1] + 1]]
            gfj = [int(fj[fi]) - base for fi in g]
            shards.append(_build_single(
                gjoined, np.asarray(gfj, np.int32),
                np.asarray([frag_ref[fi] for fi in g], np.int32),
                np.asarray([frag_off[fi] for fi in g], np.int32),
                ref_names, ref_lens, off_rate, ftab_k))
            bases.append(base)
        return ShardedFMIndex(shards=shards, shard_bases=bases)
    return _build_single(joined, np.asarray(frag_joined, np.int32),
                         np.asarray(frag_ref, np.int32),
                         np.asarray(frag_off, np.int32),
                         ref_names, ref_lens, off_rate, ftab_k)


def _build_single(joined, frag_joined, frag_ref, frag_off,
                  ref_names, ref_lens, off_rate, ftab_k) -> FMIndex:
    """Derive the packed TPU layout from the suffix array.

    Every per-row derivation (BWT chars, bigram plane, occ checkpoints,
    SA-sample marks) streams over the SA in 64 M-row chunks: the old
    one-shot vectorization materialized (rows, 16) int32 one-hots and
    int64 gather temporaries — >150 GB of peak RSS on a 1.9 Gbp shard,
    which OOM-killed genome-scale builds (the reference bounds build
    memory the same way via blockwise suffix sorting + --passMemExc,
    blockwise_sa.h, gfm.h:1890-1996)."""
    n = len(joined)
    if off_rate is None:
        off_rate = 0 if n < (1 << 27) else 4
    rows = n + 1
    sa = suffix_array(joined)
    nblocks = (rows + BLOCK_BASES - 1) // BLOCK_BASES
    pad_rows = nblocks * BLOCK_BASES

    # chunk-streamed derivation of BWT chars (L[i] = joined[sa[i]-1]),
    # bigram symbols (T[SA[i]-2], T[SA[i]-1]), occ/occ2 block counts,
    # SA-sample marks.  CH is a multiple of BLOCK_BASES and 32 so block
    # and mark-word boundaries never straddle chunks.
    bwt_codes = np.zeros(pad_rows, dtype=np.uint8)
    sym2 = np.zeros(pad_rows, dtype=np.uint8)
    occ = np.zeros((nblocks + 1, 4), dtype=np.int32)
    occ2 = np.zeros((nblocks + 1, 16), dtype=np.int32)
    mark_chk = np.zeros(nblocks + 1, dtype=np.int32)
    mark_words = np.zeros(pad_rows // 32, dtype=np.uint32)
    sa_marked_parts = []
    zrow = zrow2 = -1
    mask = (1 << off_rate) - 1
    CH = CHUNK_ROWS
    mark_shifts = np.arange(32, dtype=np.uint32)[None, :]
    for i0 in range(0, rows, CH):
        s = sa[i0:i0 + CH].astype(np.int64)
        m = len(s)
        prev = s - 1
        b = joined[np.maximum(prev, 0, out=prev)]
        # restore prev's sign info via s (prev was clobbered in place)
        b = np.where(s > 0, b, 0).astype(np.uint8)
        z = np.flatnonzero(s == 0)
        if z.size:
            zrow = i0 + int(z[0])
        prev2 = s - 2
        b2 = (joined[np.maximum(prev2, 0)] * np.uint8(4) + b)
        b2 = np.where(prev2 >= 0, b2, 0).astype(np.uint8)
        z2 = np.flatnonzero(s == 1)
        if z2.size:
            zrow2 = i0 + int(z2[0])
            b2[z2[0]] = 0
        bwt_codes[i0:i0 + m] = b
        sym2[i0:i0 + m] = b2
        # per-block histograms via composite-key bincount
        b0, b1 = i0 // BLOCK_BASES, (i0 + m + BLOCK_BASES - 1) // BLOCK_BASES
        local_block = (np.arange(m, dtype=np.int64) // BLOCK_BASES)
        cnt = np.bincount(local_block * 4 + b,
                          minlength=(b1 - b0) * 4).reshape(-1, 4)
        occ[b0 + 1:b1 + 1] += cnt.astype(np.int32)
        cnt2 = np.bincount(local_block * 16 + b2,
                           minlength=(b1 - b0) * 16).reshape(-1, 16)
        occ2[b0 + 1:b1 + 1] += cnt2.astype(np.int32)
        # SA-sample marks (rows whose SA value is a multiple of 2^off_rate)
        marked = (s & mask) == 0
        sa_marked_parts.append(sa[i0:i0 + m][marked])
        mcnt = np.bincount(local_block[marked], minlength=b1 - b0)
        mark_chk[b0 + 1:b1 + 1] += mcnt.astype(np.int32)
        mbits = np.zeros(((m + 31) // 32) * 32, dtype=np.uint32)
        mbits[:m] = marked
        mark_words[i0 // 32:i0 // 32 + len(mbits) // 32] = (
            mbits.reshape(-1, 32) << mark_shifts).sum(axis=1, dtype=np.uint32)
        del s, prev, b, prev2, b2, local_block, marked, mbits
    # '$' packs as 0 and contributes nothing to rank ('$'-corrections via
    # zrow/zrow2 at query time); exclude it (and the SA==1 bigram row)
    # from the checkpoint counts
    occ[zrow // BLOCK_BASES + 1, 0] -= 1
    occ2[zrow // BLOCK_BASES + 1, 0] -= 1
    if zrow2 >= 0:
        occ2[zrow2 // BLOCK_BASES + 1, 0] -= 1
    np.cumsum(occ, axis=0, out=occ)
    np.cumsum(occ2, axis=0, out=occ2)
    np.cumsum(mark_chk, out=mark_chk)
    sa_marked = np.concatenate(sa_marked_parts).astype(np.int32)
    del sa_marked_parts, sa

    # cumulative char counts C[]: fchr[c] = 1 + #{chars < c}  (the 1 is '$')
    fchr = np.zeros(5, dtype=np.int32)
    fchr[0] = 1
    np.cumsum(occ[-1], out=fchr[1:])
    fchr[1:] += 1

    bwt_words = bitops.pack_2bit(bwt_codes)
    del bwt_codes
    bwt2_words = bitops.pack_4bit(sym2)
    del sym2

    ftab_top, ftab_bot = _build_ftab(joined, ftab_k)
    ftab2_top, _ = _build_ftab(joined, 2)

    ref_words = bitops.pack_2bit(joined)
    meta = FMMeta(n=n, rows=rows, zrow=zrow, off_rate=off_rate,
                  ftab_k=ftab_k, ref_names=ref_names, ref_lens=ref_lens,
                  zrow2=zrow2)
    return FMIndex(
        meta=meta, bwt_words=bwt_words, occ=occ, mark_words=mark_words,
        mark_chk=mark_chk, sa_marked=sa_marked,
        bwt2_words=bwt2_words, occ2=occ2, ftab2_top=ftab2_top,
        ftab_top=ftab_top, ftab_bot=ftab_bot, fchr=fchr, ref_words=ref_words,
        frag_joined=np.concatenate([frag_joined, [np.int32(n)]]).astype(np.int32),
        frag_ref=frag_ref, frag_off=frag_off)
