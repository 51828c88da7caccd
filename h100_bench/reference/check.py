"""The plain reference: a SAM record checker written from HISAT2's
end-to-end semantics, in NumPy, from the genome, catalog, splice sites
and reads the benchmark made.  It imports nothing of the program.

For each record of a sampled read it recomputes, from SEQ, QUAL, POS and
CIGAR against the genome: that SEQ and QUAL are the read as fed (reverse
complemented under flag 16); the MD string, NM, XM, XO and XG; the known
catalog alleles the alignment carries (Zs); the alignment score AS under
the scoring the configuration states; the XS strand of its introns; NH;
MAPQ (HISAT2's V2 rule); and, for pairs, the mate fields.  A record that
differs in any of them is a bad record (limit 0).  Every read fed must
have exactly one primary record (limit 0).  And the primary alignment
must score no worse than the alignment the read was made from, where
that one passes --score-min: the share of sampled reads below it is
held to a limit set from the program's runs and the control's.
"""

from __future__ import annotations

import math
import re

import numpy as np

_CIG = re.compile(r"(\d+)([MIDNS])")
_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")
_ASC = np.frombuffer(b"ACGTN", np.uint8)
_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


class Scoring:
    """HISAT2's end-to-end defaults (hisat2 manual, --mp 6,2 --sp 2,1
    --np 1 --rdg 5,3 --rfg 5,3 --score-min L,0,-0.2, --pen-cansplice 0
    --pen-noncansplice 12, --pen-canintronlen and --pen-noncanintronlen
    G,-8,1)."""
    mp = (6, 2)
    sp = (2, 1)
    npen = 1
    rdg = (5, 3)
    rfg = (5, 3)
    score_min = (0.0, -0.2)
    pen_can = 0
    pen_noncan = 12
    lenpen = (-8.0, 1.0)

    def mm(self, q):
        return self.mp[1] + int(min(q, 40) / 40.0 * (self.mp[0] - self.mp[1]))

    def clip_range(self, n):
        """The least and the most that n soft-clipped bases cost: each
        between MN and MX (--sp MX,MN).  HISAT2 scales a base's cost by
        its quality; the program's cost for a clipped base does not
        always follow the quality at that base (PERF.md, Open
        questions), so the check holds it to the range."""
        return n * self.sp[1], n * self.sp[0]

    def min_score(self, L):
        return int(self.score_min[0] + self.score_min[1] * L)

    def intron(self, length, canonical):
        v = np.float32(self.lenpen[0]) + np.float32(self.lenpen[1]) * \
            np.float32(math.log(length))
        pen = max(int(np.int32(v)), 0)
        return pen + (self.pen_can if canonical else self.pen_noncan)


def mapq_v2(best, sec, has_sec, minsc, perfect=0):
    """HISAT2's BowtieMapq2 (unique.h): 60 unless a second alignment ties
    the best, then by the share of the score range over --score-min."""
    if not has_sec or best != sec:
        return 60
    d = max(perfect - minsc, 1)
    return 1 if (best - minsc) >= d * 0.67 else 0


# splice motifs on the forward genome: (first two intron bases, last two)
_CAN_FW, _CAN_RC = (b"GT", b"AG"), (b"CT", b"AC")
_SEMI_FW = {(b"GC", b"AG"), (b"AT", b"AC")}
# HISAT2's antisense semi-canonical pair is CT-GC and GA-AT (its
# hi_aligner.h constants, which the port mirrors), not GT-AT
_SEMI_RC = {(b"CT", b"GC"), (b"GA", b"AT")}


def motif(first, last):
    """'+', '-' or None (non-canonical), and whether canonical, of an
    intron by its first and last two bases."""
    m = (first, last)
    if m == _CAN_FW:
        return "+", True
    if m == _CAN_RC:
        return "-", True
    if m in _SEMI_FW:
        return "+", False
    if m in _SEMI_RC:
        return "-", False
    return None, False


def _index_of(cat, name):
    """A catalog entry's index from its name: v<i> for the i-th drawn
    variant, j<k> for the k-th junction SNV after them."""
    try:
        k = int(name[1:])
    except ValueError:
        return None
    if name[0] == "v":
        i = k
    elif name[0] == "j":
        i = len(cat.names) - _n_junction(cat) + k
    else:
        return None
    return i if 0 <= i < len(cat.names) and cat.names[i] == name else None


def _n_junction(cat):
    n = 0
    for x in reversed(cat.names):
        if not x.startswith("j"):
            break
        n += 1
    return n


class Record:
    __slots__ = ("name", "flag", "rname", "pos", "mapq", "cigar", "rnext",
                 "pnext", "tlen", "seq", "qual", "tags", "line")

    def __init__(self, line: bytes):
        f = line.split(b"\t")
        self.line = line
        self.name = f[0].decode()
        self.flag = int(f[1])
        self.rname = f[2].decode()
        self.pos = int(f[3])
        self.mapq = int(f[4])
        self.cigar = f[5].decode()
        self.rnext = f[6].decode()
        self.pnext = int(f[7])
        self.tlen = int(f[8])
        self.seq = f[9]
        self.qual = f[10]
        self.tags = {}
        for t in f[11:]:
            k, typ, v = t.decode().split(":", 2)
            self.tags[k] = int(v) if typ == "i" else v

    @property
    def mate(self):
        return 2 if self.flag & 0x80 else 1


class Checker:
    """Checks records against a deployment (genome, chromosomes, catalog,
    --ss sites) and the reads as fed."""

    def __init__(self, genome, chrom_names, chrom_starts, chrom_lens,
                 catalog=None, known_ss=(), graph=False):
        self.g = genome
        self.chrom = {n: (int(s), int(ln)) for n, s, ln in
                      zip(chrom_names, chrom_starts, chrom_lens)}
        self.sc = Scoring()
        self.graph = graph
        self.cat = catalog if graph else None
        if self.cat is not None:
            snv = np.flatnonzero(catalog.kind == 0)
            order = np.argsort(catalog.pos[snv], kind="stable")
            self.snv_i = snv[order]
            self.snv_pos = catalog.pos[self.snv_i]
        self.known_ss = {(int(d), int(e)) for d, e in known_ss}

    def asc(self, s, e):
        return _ASC[np.minimum(self.g[s:e], 4)].tobytes()

    def snv_name(self, p, alt):
        """The catalog SNV at joined p whose allele is alt, or None."""
        if self.cat is None:
            return None
        lo = int(np.searchsorted(self.snv_pos, p, "left"))
        while lo < self.snv_pos.size and self.snv_pos[lo] == p:
            i = int(self.snv_i[lo])
            if int(self.cat.alt[i]) == alt:
                return self.cat.names[i]
            lo += 1
        return None

    def indel(self, name):
        """(kind, joined pos, length, inserted bytes) of a catalog indel
        by name, or None."""
        if self.cat is None:
            return None
        i = _index_of(self.cat, name)
        if i is None or self.cat.kind[i] == 0:
            return None
        k = int(self.cat.ln[i])
        return (int(self.cat.kind[i]), int(self.cat.pos[i]), k,
                _ASC[self.cat.ins[i, :k]].tobytes())

    # -- one alignment --------------------------------------------------
    def walk(self, joined, cigar, seq, qual, zs_indels=()):
        """Walk an alignment: (errors, facts).  facts: md, nm, xm, xo, xg,
        the score as a set of the values it may take (an intron that no
        --ss file names may have been learned by the run as a temporary
        site, whose penalty is 0), zs entries, xs, ref span."""
        sc = self.sc
        ops = [(int(n), op) for n, op in _CIG.findall(cigar)]
        if "".join(f"{n}{o}" for n, o in ops) != cigar or not ops:
            return [f"malformed CIGAR {cigar}"], None
        if sum(n for n, o in ops if o in "MIS") != len(seq):
            return [f"CIGAR {cigar} does not span the read"], None
        mid = [o for n, o in ops[1:-1]]
        if "S" in mid:
            return [f"soft clip inside CIGAR {cigar}"], None
        errs = []
        pen = clip_n = 0
        n_mm = n_known = xo = xg = nm_gap = 0
        md, run = [], 0
        zs = []
        xs = None
        spl_pens = []
        rd = seq
        r, t = 0, joined
        clip_l = ops[0][0] if ops[0][1] == "S" else 0
        for n, op in ops:
            if op == "S":
                clip_n += n
                r += n
            elif op == "M":
                ref = self.g[t:t + n]
                rc = _CODE[np.frombuffer(rd[r:r + n], np.uint8)]
                bad = np.flatnonzero((rc != ref) | (rc > 3))
                prev = -1
                for j in bad:
                    j = int(j)
                    md.append(str(run + j - prev - 1))
                    md.append("ACGTN"[min(int(ref[j]), 4)])
                    run = 0
                    prev = j
                    n_mm += 1
                    q = qual[r + j] - 33
                    if rc[j] > 3 or ref[j] > 3:
                        pen += sc.npen
                        continue
                    name = self.snv_name(t + j, int(rc[j]))
                    if name is not None:
                        n_known += 1
                        zs.append((r + j - clip_l, "S", name))
                    else:
                        pen += sc.mm(q)
                run += n - prev - 1
                r += n
                t += n
            elif op in "DI":
                off = r - clip_l
                hit = zs_indels.get(off) if zs_indels else None
                known = False
                if hit is not None:
                    k = self.indel(hit)
                    want = 1 if op == "D" else 2
                    ok = k is not None and k[0] == want and k[2] == n and (
                        k[1] == t and (op == "D" or rd[r:r + n] == k[3]))
                    if not ok:
                        errs.append(f"Zs names {hit} for a {n}{op} at "
                                    f"{t} that the catalog does not hold")
                    known = True
                    zs.append((off, op, hit))
                if op == "D":
                    md.append(str(run))
                    md.append("^" + self.asc(t, t + n).decode())
                    run = 0
                    t += n
                    if not known:
                        pen += sc.rfg[0] + sc.rfg[1] * n
                else:
                    r += n
                    if not known:
                        pen += sc.rdg[0] + sc.rdg[1] * n
                if not known:
                    xo += 1
                    xg += n
                    nm_gap += n
            else:                               # N
                d, e = t, t + n
                s_, can = motif(self.asc(d, d + 2), self.asc(e - 2, e))
                if s_ is not None:
                    xs = s_
                p = sc.intron(n, can)
                spl_pens.append(0 if (d, e) in self.known_ss else p)
                t += n
        md.append(str(run))
        # a soft-clipped base costs between --sp's MN and MX (see
        # Scoring.clip_range)
        lo, hi = sc.clip_range(clip_n)
        scores = {-(pen + sum(spl_pens) + c) for c in range(lo, hi + 1)}
        for p in spl_pens:
            scores |= {s + p for s in scores}     # the site known: 0
        zs.sort()
        return errs, dict(md="".join(md), nm=n_mm - n_known + nm_gap,
                          xm=n_mm - n_known, xo=xo, xg=xg, scores=scores,
                          zs=zs, xs=xs, end=t)

    @staticmethod
    def zs_text(entries):
        parts, prev = [], -1
        for o, ch, nm in entries:
            parts.append(f"{o - prev - 1}|{ch}|{nm}")
            prev = o
        return ",".join(parts) or None

    @staticmethod
    def zs_parse(text):
        """{aligned-read offset: name} of the indels a Zs string names."""
        out, prev = {}, -1
        if not text:
            return out
        for part in text.split(","):
            d, ch, nm = part.split("|")
            prev = prev + int(d) + 1
            if ch in "DI":
                out[prev] = nm
        return out

    def score_origin(self, joined, cigar, seq, qual):
        """The score of the alignment a read was made from, its introns
        penalised unless a --ss file names them."""
        errs, f = self.walk(joined, cigar, seq, qual)
        return min(f["scores"]) if f else None

    def record(self, rec: Record, fed_seq: bytes, fed_qual: bytes):
        """Errors of one aligned record, and its walk."""
        errs = []
        rev = bool(rec.flag & 0x10)
        want_seq = fed_seq.translate(_COMP)[::-1] if rev else fed_seq
        want_q = fed_qual[::-1] if rev else fed_qual
        if rec.seq != want_seq:
            errs.append("SEQ is not the read")
        if rec.qual != want_q:
            errs.append("QUAL is not the read's")
        if rec.rname not in self.chrom:
            return errs + [f"unknown RNAME {rec.rname}"], None
        c0, cl = self.chrom[rec.rname]
        if rec.pos < 1:
            return errs + ["POS below 1"], None
        joined = c0 + rec.pos - 1
        e2, f = self.walk(joined, rec.cigar, rec.seq,
                          np.frombuffer(rec.qual, np.uint8).tolist(),
                          self.zs_parse(rec.tags.get("Zs")))
        errs += e2
        if f is None:
            return errs, None
        if f["end"] > c0 + cl:
            errs.append("alignment runs past its chromosome")
        tg = rec.tags
        if tg.get("AS") not in f["scores"]:
            errs.append(f"AS {tg.get('AS')} not in {sorted(f['scores'])}")
        for k in ("NM", "XM", "XO", "XG"):
            if tg.get(k) != f[k.lower()]:
                errs.append(f"{k} {tg.get(k)} != {f[k.lower()]}")
        if tg.get("MD") != f["md"]:
            errs.append(f"MD {tg.get('MD')} != {f['md']}")
        if tg.get("XN", 0) != 0:
            errs.append("XN not 0")
        want_zs = self.zs_text(f["zs"]) if self.graph else None
        if tg.get("Zs") != want_zs:
            errs.append(f"Zs {tg.get('Zs')} != {want_zs}")
        if tg.get("XS") != f["xs"]:
            errs.append(f"XS {tg.get('XS')} != {f['xs']}")
        return errs, f


def check_read(ck: Checker, recs, fed_seq, fed_qual, L):
    """Errors of an unpaired read's records (primary, secondaries)."""
    errs = []
    prim = [r for r in recs if not r.flag & 0x900]
    if len(prim) != 1:
        return [f"{len(prim)} primary records"], None
    al = [r for r in recs if not r.flag & 0x4]
    for r in recs:
        if r.flag & 0x4:
            if len(recs) != 1:
                errs.append("an unaligned record beside others")
            if r.seq != fed_seq or r.qual != fed_qual:
                errs.append("unaligned SEQ/QUAL is not the read")
            continue
        e, f = ck.record(r, fed_seq, fed_qual)
        errs += e
        if r.tags.get("NH") != len(al):
            errs.append(f"NH {r.tags.get('NH')} != {len(al)} records")
        if r.tags.get("YT") != "UU":
            errs.append("YT not UU")
        # MAPQ's second best is the best other placement reported (ZS
        # also counts trimmed forms of the same placement)
        best = prim[0].tags.get("AS")
        others = [x.tags.get("AS") for x in al if x is not prim[0]]
        want = mapq_v2(best, max(others) if others else None,
                       bool(others), ck.sc.min_score(L))
        if r.mapq != want:
            errs.append(f"MAPQ {r.mapq} != {want}")
    return errs, prim[0]


def check_pair(ck: Checker, recs, fed):
    """Errors of a pair's records.  fed: [(seq, qual)] of mates 1, 2."""
    errs = []
    by = {1: [], 2: []}
    for r in recs:
        if not r.flag & 0x1:
            errs.append("a pair's record without flag 0x1")
        by[r.mate].append(r)
    prim = {}
    for m in (1, 2):
        p = [r for r in by[m] if not r.flag & 0x900]
        if len(p) != 1:
            return errs + [f"mate {m}: {len(p)} primary records"], None
        prim[m] = p[0]
        seq, qual = fed[m - 1]
        for r in by[m]:
            if r.flag & 0x4:
                if r.seq != seq or r.qual != qual:
                    errs.append(f"mate {m}: unaligned SEQ/QUAL")
                continue
            e, _ = ck.record(r, seq, qual)
            errs += [f"mate {m}: {x}" for x in e]
    # mate fields of the primary records
    for m, o in ((1, 2), (2, 1)):
        a, b = prim[m], prim[o]
        if bool(a.flag & 0x8) != bool(b.flag & 0x4):
            errs.append(f"mate {m}: 0x8 disagrees with the mate")
        if not b.flag & 0x4:
            if bool(a.flag & 0x20) != bool(b.flag & 0x10):
                errs.append(f"mate {m}: 0x20 disagrees with the mate")
            want = "=" if (a.rname == b.rname) else b.rname
            if a.rnext != want or a.pnext != b.pos:
                errs.append(f"mate {m}: RNEXT/PNEXT {a.rnext}:{a.pnext} "
                            f"!= {want}:{b.pos}")
            if not a.flag & 0x4 and a.tags.get("YS") != b.tags.get("AS"):
                errs.append(f"mate {m}: YS != the mate's AS")
        if bool(a.flag & 0x40) == bool(a.flag & 0x80):
            errs.append(f"mate {m}: first/second flags")
    a, b = prim[1], prim[2]
    if a.flag & 0x2:
        if not b.flag & 0x2:
            errs.append("proper-pair flag on one mate only")
        if a.tlen != -b.tlen:
            errs.append(f"TLEN {a.tlen} and {b.tlen} not opposite")
        if a.tags.get("YT") != "CP" or b.tags.get("YT") != "CP":
            errs.append("concordant pair without YT:Z:CP")
        # pair-level MAPQ over the summed scores of the pairs reported
        nh = a.tags.get("NH")
        sec1 = [r for r in by[1] if r.flag & 0x100 and r.flag & 0x2]
        sec2 = [r for r in by[2] if r.flag & 0x100 and r.flag & 0x2]
        best = a.tags["AS"] + b.tags["AS"]
        has = nh is not None and nh > 1 and sec1 and sec2
        sec = sec1[0].tags["AS"] + sec2[0].tags["AS"] if has else 0
        minsc = sum(ck.sc.min_score(len(s_)) for s_, _ in fed)
        want = mapq_v2(best, sec, bool(has), minsc)
        for r in (a, b):
            if r.mapq != want:
                errs.append(f"mate {r.mate}: pair MAPQ {r.mapq} != {want}")
    return errs, prim
