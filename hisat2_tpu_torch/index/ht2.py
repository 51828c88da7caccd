"""Reader for the reference's `.ht2` index format.

Layout authority: GFM::writeFromMemory / readIntoMemory
(hisat2's gfm.h:6143-6227), BitPairReference::szsFromFasta
(hisat2's reference.cpp:587-648, ref_read.h:94-103 RefRecord), and
the ALT/Haplotype serialization (hisat2's alt.h:189-249,
gfm.h:1813-1825).

Strategy: a `.ht2` set fully determines the reference sequence (.3/.4
RefRecords + 2-bit stream), the names/lengths (.1 header tail) and the
variant database (.7/.8 ALTs in joined coordinates).  We decode those and
rebuild the TPU-native index with our own builder — the GBWT/FM payload of
.1/.2/.5/.6 is never needed, because the builder reconstructs an
equivalent (linear FM + variant planes) layout directly.  `.ht2` files are
always 32-bit little-endian (the 64-bit flavor uses the `.ht2l`
extension, hisat2:444-457).

Copied verbatim from hisat2_tpu/index/ht2.py; only the imports, the
location of the hisat2 sources in citations, and convert_ht2's fallback
cache directory are rewritten.  The copy caches under the system temporary
directory (tempfile.gettempdir(), so TMPDIR) in a directory of its own,
never in the one the JAX package uses.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

ALT_NONE, ALT_SNP_SGL, ALT_SNP_INS, ALT_SNP_DEL, ALT_SNP_ALT, \
    ALT_SPLICESITE, ALT_EXON = range(7)


class _Cursor:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u32(self, n=None):
        if n is None:
            v = int(np.frombuffer(self.d, np.uint32, 1, self.o)[0])
            self.o += 4
            return v
        v = np.frombuffer(self.d, np.uint32, n, self.o)
        self.o += 4 * n
        return v

    def i32(self):
        v = int(np.frombuffer(self.d, np.int32, 1, self.o)[0])
        self.o += 4
        return v

    def u64(self, n=None):
        if n is None:
            v = int(np.frombuffer(self.d, np.uint64, 1, self.o)[0])
            self.o += 8
            return v
        v = np.frombuffer(self.d, np.uint64, n, self.o)
        self.o += 8 * n
        return v

    def byte(self):
        v = self.d[self.o]
        self.o += 1
        return v

    def skip(self, n):
        self.o += n


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def read_header(base: str) -> dict:
    """Parse a built .1.ht2: header, then the buildToDisk stream layout
    (gfm.h:4704-5075 linear / 4276-4704 graph): nPat+plen, nFrag+rstarts,
    gbwtLen+numNodes (again), GBWT sides, zOffs, fchr, ftab,
    eftabLen+eftab, refnames.  Side geometry per GFMParams::init
    (gfm.h:147-182)."""
    d = _read(base + ".1.ht2")
    c = _Cursor(d)
    assert c.i32() == 1, "big-endian .ht2 not supported"
    version = c.i32()
    length = c.u32()
    gbwt_len = c.u32()
    num_nodes = c.u32()
    line_rate = c.i32()
    c.i32()                      # unused (always 2)
    off_rate = c.i32()
    ftab_chars = c.i32()
    eftab_len = c.u32()
    flags = c.i32()
    n_pat = c.u32()
    plen = c.u32(n_pat).astype(np.int64)
    n_frag = c.u32()
    rstarts = c.u32(3 * n_frag).astype(np.int64).reshape(n_frag, 3)
    # buildToDisk seek-patches gbwtLen/numNodes into the header
    # (gfm.h:4723-4727) — the sides start right here
    linear = gbwt_len == 0 or gbwt_len == length + 1
    side_sz = 1 << line_rate
    if linear:
        gbwt_sz = gbwt_len // 4 + 1
        side_gbwt_sz = side_sz - 4 * 4
    else:
        gbwt_sz = gbwt_len // 2 + 1
        side_gbwt_sz = side_sz - 4 * 6
    n_sides = (gbwt_sz + side_gbwt_sz - 1) // side_gbwt_sz
    c.skip(n_sides * side_sz)    # GBWT sides (not needed: we rebuild)
    n_z = c.u32()
    c.skip(4 * n_z)
    c.skip(4 * 5)                # fchr
    c.skip(4 * ((1 << (ftab_chars * 2)) + 1))
    c.skip(4 * eftab_len)
    names = [n.split()[0] for n in
             d[c.o:].split(b"\x00")[0].decode().strip("\n").split("\n")
             if n.strip()]
    return dict(version=version, length=int(length),
                gbwt_len=int(gbwt_len), num_nodes=int(num_nodes),
                line_rate=line_rate, off_rate=off_rate,
                ftab_chars=ftab_chars, flags=flags, n_pat=int(n_pat),
                plen=plen, rstarts=rstarts, names=names,
                linear=linear, n_sides=n_sides)


def read_ref(base: str):
    """Decode .3 (RefRecords) + .4 (2-bit stream) into per-sequence code
    arrays with N runs reinserted (reference.cpp:587-648)."""
    d3 = _Cursor(_read(base + ".3.ht2"))
    assert d3.i32() == 1
    nrec = d3.u32()
    recs = []
    for _ in range(nrec):
        off = d3.u32()
        ln = d3.u32()
        first = d3.byte() != 0
        recs.append((off, ln, first))
    stream = np.frombuffer(_read(base + ".4.ht2"), np.uint8)
    # 2-bit unpack, base i of byte b at bits (i*2) — LSB-first within the
    # byte (reference.cpp getStretch bit math)
    codes = np.empty(len(stream) * 4, np.uint8)
    for i in range(4):
        codes[i::4] = (stream >> (2 * i)) & 3
    seqs = []
    pos = 0
    cur = None
    for off, ln, first in recs:
        if first:
            if cur is not None:
                seqs.append(np.concatenate(cur) if cur else
                            np.zeros(0, np.uint8))
            cur = []
        if off:
            cur.append(np.full(off, 4, np.uint8))
        cur.append(codes[pos:pos + ln])
        pos += ln
    if cur is not None:
        seqs.append(np.concatenate(cur) if cur else np.zeros(0, np.uint8))
    return seqs


def read_alts(base: str):
    """Parse .7 (ALT records + haplotypes) and .8 (ALT names).

    Returns (alts, altnames, haplotypes) with alts as a list of
    (type, pos_or_left, len_or_right, seq) in JOINED coordinates."""
    p7 = base + ".7.ht2"
    if not os.path.exists(p7):
        return [], [], []
    c = _Cursor(_read(p7))
    assert c.i32() == 1
    n = c.u32()
    alts = []
    for _ in range(n):
        pos = c.u32()
        typ = c.u32()
        ln = c.u32()
        seq = c.u64()
        alts.append((typ, int(pos), int(ln), int(seq)))
    nh = c.u32() if c.o + 4 <= len(c.d) else 0
    haps = []
    for _ in range(nh):
        left = c.u32()
        right = c.u32()
        na = c.u32()
        haps.append((int(left), int(right),
                     [int(x) for x in c.u32(na)]) if na else
                    (int(left), int(right), []))
    names = []
    p8 = base + ".8.ht2"
    if os.path.exists(p8):
        d8 = _read(p8)
        c8 = _Cursor(d8)
        assert c8.i32() == 1
        n8 = c8.u32()
        names = d8[c8.o:].decode().split("\n")[:n8]
    return alts, names, haps


def _joined_to_ref(recs_cum, j):
    """joined offset -> (seq idx, ref offset) via the .3 record map."""
    frag_j, frag_seq, frag_off = recs_cum
    f = np.searchsorted(frag_j, j, "right") - 1
    f = np.clip(f, 0, len(frag_j) - 2)
    return frag_seq[f], frag_off[f] + (j - frag_j[f])


def _record_maps(base):
    d3 = _Cursor(_read(base + ".3.ht2"))
    assert d3.i32() == 1
    nrec = d3.u32()
    frag_j, frag_seq, frag_off = [], [], []
    j = 0
    seq_i = -1
    ref_off = 0
    for _ in range(nrec):
        off = d3.u32()
        ln = d3.u32()
        first = d3.byte() != 0
        if first:
            seq_i += 1
            ref_off = 0
        ref_off += off
        frag_j.append(j)
        frag_seq.append(seq_i)
        frag_off.append(ref_off)
        j += ln
        ref_off += ln
    frag_j.append(j)
    return (np.array(frag_j, np.int64), np.array(frag_seq, np.int64),
            np.array(frag_off, np.int64))


def convert_ht2(base: str, cache_base: str = None):
    """Build a TPU-native index (+ VariantDB when the .ht2 carries ALTs)
    from a reference .ht2 index set.  Caches beside the .ht2 files when
    the directory is writable, else in hisat2_tpu_torch_ht2cache under the
    system temporary directory, keyed by absolute path.

    Returns the cache base path (load with FMIndex.load /
    VariantDB.load)."""
    from .builder import build_fm_index
    from .variants import (SNP_DEL, SNP_INS, SNP_SGL, VariantDB,
                           attach_variants)

    if cache_base is None:
        d = os.path.dirname(os.path.abspath(base)) or "."
        if os.access(d, os.W_OK):
            cache_base = base + ".tpu"
        else:
            key = os.path.abspath(base).replace("/", "_")
            cache_dir = os.path.join(tempfile.gettempdir(),
                                     "hisat2_tpu_torch_ht2cache")
            os.makedirs(cache_dir, exist_ok=True)
            cache_base = os.path.join(cache_dir, key)
    if os.path.exists(cache_base + ".npz"):
        return cache_base

    hdr = read_header(base)
    seqs = read_ref(base)
    names = hdr["names"][:len(seqs)]
    idx = build_fm_index(list(zip(names, seqs)))
    idx.save(cache_base + ".npz")

    alts, altnames, haps = read_alts(base)
    if alts:
        maps = _record_maps(base)
        empty32 = np.zeros(0, np.int32)
        empty8 = np.zeros(0, np.int8)
        db = VariantDB(
            snp_names=[], snp_kind=empty8, snp_ref=empty32,
            snp_pos=empty32, snp_joined=empty32, snp_len=empty32,
            snp_seq=np.zeros(0, np.int64),
            ss_ref=empty32, ss_left=empty32, ss_right=empty32,
            ss_strand=empty8, exon_ref=empty32, exon_left=empty32,
            exon_right=empty32, exon_strand=empty8,
            hap_ref=empty32, hap_left=empty32, hap_right=empty32,
            hap_alts=[])
        kinds, refs, poss, js, lens_, seqs_, nm = \
            [], [], [], [], [], [], []
        ssr, ssl, ssx, sss = [], [], [], []
        exr, exl, exx, exs = [], [], [], []
        alt_to_snp = {}
        for i, (typ, pos, ln, sq) in enumerate(alts):
            name = altnames[i] if i < len(altnames) else ""
            if typ in (ALT_SNP_SGL, ALT_SNP_DEL, ALT_SNP_INS):
                rid, roff = _joined_to_ref(
                    maps, np.array([pos], np.int64))
                alt_to_snp[i] = len(kinds)
                kinds.append({ALT_SNP_SGL: SNP_SGL, ALT_SNP_DEL: SNP_DEL,
                              ALT_SNP_INS: SNP_INS}[typ])
                refs.append(int(rid[0]))
                poss.append(int(roff[0]))
                js.append(pos)
                lens_.append(ln)
                if typ == ALT_SNP_INS:
                    # reference packs MSB-first (gfm.h:1437); our
                    # VariantDB packs LSB-first (alt allele order)
                    v = 0
                    for t in range(ln):
                        v |= ((sq >> (2 * (ln - 1 - t))) & 3) << (2 * t)
                    seqs_.append(v)
                else:
                    seqs_.append(sq)
                nm.append(name)
            elif typ == ALT_SPLICESITE:
                rid, roff = _joined_to_ref(
                    maps, np.array([pos, ln], np.int64))
                ssr.append(int(rid[0]))
                ssl.append(int(roff[0]))
                ssx.append(int(roff[1]))
                sss.append(1 if (sq & 0xFF) else -1)
            elif typ == ALT_EXON:
                rid, roff = _joined_to_ref(
                    maps, np.array([pos, ln], np.int64))
                exr.append(int(rid[0]))
                exl.append(int(roff[0]))
                exx.append(int(roff[1]))
                exs.append(1 if (sq & 0xFF) else -1)
        db.snp_names = nm
        db.snp_kind = np.array(kinds, np.int8)
        db.snp_ref = np.array(refs, np.int32)
        db.snp_pos = np.array(poss, np.int32)
        db.snp_len = np.array(lens_, np.int32)
        db.snp_seq = np.array(seqs_, np.int64)
        from .variants import _to_joined
        db.snp_joined = (_to_joined(idx, db.snp_ref, db.snp_pos)
                         if len(kinds) else empty32)
        db.ss_ref = np.array(ssr, np.int32)
        db.ss_left = np.array(ssl, np.int32)
        db.ss_right = np.array(ssx, np.int32)
        db.ss_strand = np.array(sss, np.int8)
        db.exon_ref = np.array(exr, np.int32)
        db.exon_left = np.array(exl, np.int32)
        db.exon_right = np.array(exx, np.int32)
        db.exon_strand = np.array(exs, np.int8)
        hr, hl, hR, ha = [], [], [], []
        for left, right, alist in haps:
            rid, roff = _joined_to_ref(
                maps, np.array([left, right], np.int64))
            hr.append(int(rid[0]))
            hl.append(int(roff[0]))
            hR.append(int(roff[1]))
            ha.append([alt_to_snp[a] for a in alist if a in alt_to_snp])
        db.hap_ref = np.array(hr, np.int32)
        db.hap_left = np.array(hl, np.int32)
        db.hap_right = np.array(hR, np.int32)
        db.hap_alts = ha
        db.save(cache_base)
    return cache_base


def is_ht2(base: str) -> bool:
    return os.path.exists(base + ".1.ht2") or os.path.exists(
        base + ".3.ht2")
