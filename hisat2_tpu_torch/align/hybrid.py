"""Per-read replay of the reference's evaluation model (DNA mode).

The batched device pipeline (align/pipeline.py) finds the best-scoring
placements by global sweeps; the reference (HI_Aligner + SplicedAligner,
hisat2's hi_aligner.h + spliced_aligner.h) explores a BUDGETED,
ORDERED search tree whose shape decides byte-level SAM details the sweep
cannot see: which gap joins are ever evaluated (a 7 bp flank whose local
57 kb window lacks a >= minAnchorLen occurrence is soft-clipped even when
the gap scores better), which equal-score loci are ever visited
(NH/record count), and which evaluated-but-unreported scores feed
ZS/secbest.

This module replays that model faithfully, one read at a time, on the
host: partial search rounds over the global FM (partialSearch,
hi_aligner.h:5434), interleaved orientation scheduling with budget and
sibling gates (go/nextBWT, hi_aligner.h:3874-4076), anchor selection
(getAnchorHits, hi_aligner.h:4341), and the recursive local-index /
global-search / trim / direct-extension evaluation
(SplicedAligner::hybridSearch_recur, spliced_aligner.h:214-1892) with
the HGFM local-index geometry emulated by windowed occurrence scans
(align/hostfm.py).

It runs OFF the hot path: the driver applies it only to reads whose
device result is search-path-sensitive (gaps, clips, multimaps, or no
alignment).  Covers DNA mode (--no-spliced-alignment semantics) and
spliced (RNA) mode: novel-junction discovery in combineWith's diagonal
scan (hi_aligner.h:1432-1692: canonical/semi-canonical motif preference,
PWM probscore tie-break, anchor/intron-length-probability gates) and the
splice-site-DB-guided branches of hybridSearch_recur
(spliced_aligner.h:301-560, 1209-1330: known/temp-site anchored combines
with readid gating).  Splice ALTs baked into a graph index
(--ss at build time) are NOT modeled here — the device path covers them,
and such runs stay on the device result (see substitute_batch).

Copied verbatim from hisat2_tpu/align/hybrid.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import numpy as np

from . import hostfm
from .scoring import Scoring

NEG = -(1 << 62)
MIN_I32 = -(1 << 31)

# Edit types (edit.h)
MM = 0
RDGAP = 1      # deletion: read gap (ref char, no read char)
RFGAP = 2      # insertion: ref gap (read char, no ref char)
SPL = 3        # splice: intron skip of splen ref chars (edit.h EDIT_TYPE_SPL)

# splice directions (splice_site.h:36-43)
SPL_UNKNOWN, SPL_FW, SPL_RC, SPL_SEMI_FW, SPL_SEMI_RC = 0, 1, 2, 3, 4

# donor/acceptor PWM geometry (splice_site.h:49-63)
DONOR_EXONIC, DONOR_INTRONIC = 3, 6
ACC_INTRONIC, ACC_EXONIC = 14, 1
INTRONIC_LEN = max(DONOR_INTRONIC, ACC_INTRONIC)   # splice_site.h:76


def _max_intron_len(anchor: int, min_anchor: int) -> int:
    """MaxIntronLen (hi_aligner.h:48-57), scalar host form."""
    if anchor < min_anchor:
        return 0
    a = max(anchor, 2)
    return 1 << min(max(2 * a - 4, 13), 30)


def _max_intron_len_noncan(anchor: int, min_anchor: int) -> int:
    """MaxIntronLen_noncan (hi_aligner.h:70-79)."""
    if anchor < min_anchor:
        return 0
    a = max(anchor, 5)
    return 1 << min(2 * a - 10, 30)


def _intron_len_prob(anchor: int, intron_len: int,
                     max_intron: int) -> float:
    """intronLen_prob (hi_aligner.h:59-67)."""
    exp_len = max_intron
    if anchor < 14:
        exp_len = 1 << ((anchor << 1) + 4)
    exp_len = min(exp_len, max_intron)
    return min(float(intron_len) / float(exp_len), 1.0)


def _intron_len_prob_noncan(anchor: int, intron_len: int,
                            max_intron: int) -> float:
    """intronLen_prob_noncan (hi_aligner.h:81-89)."""
    exp_len = max_intron
    if anchor < 16:
        exp_len = 1 << (anchor << 1)
    exp_len = min(exp_len, max_intron)
    return min(float(intron_len) / float(exp_len), 1.0)

CANDIDATE_HIT, PSEUDOGENE_HIT, ANCHOR_HIT = 1, 2, 3


class Edit:
    __slots__ = ("pos", "typ", "rf", "rd", "snp", "splen", "sdir",
                 "known", "dseq", "aseq")

    def __init__(self, pos, typ, rf, rd, snp=-1, splen=0, sdir=0,
                 known=False, dseq=0, aseq=0):
        self.pos = int(pos)       # relative to hit.rdoff
        self.typ = typ
        self.rf = int(rf)         # ref char code (0-4)
        self.rd = int(rd)         # read char code (0-4)
        self.snp = int(snp)       # ALT id when forgiven (-1 = none)
        self.splen = int(splen)   # SPL: intron length (skipped ref chars)
        self.sdir = int(sdir)     # SPL: splice direction (SPL_*)
        self.known = bool(known)  # SPL: from the splice-site DB
        self.dseq = int(dseq)     # SPL canonical: packed 9-mer donor seq
        self.aseq = int(aseq)     # SPL canonical: packed 15-mer acceptor

    def key(self):
        return (self.pos, self.typ, self.rf, self.rd, self.splen,
                self.sdir)

    def clone(self):
        return Edit(self.pos, self.typ, self.rf, self.rd, self.snp,
                    self.splen, self.sdir, self.known, self.dseq,
                    self.aseq)

    def __repr__(self):
        if self.typ == SPL:
            return f"{self.pos}N{self.splen}d{self.sdir}" + (
                "k" if self.known else "")
        t = "M-+"[self.typ]
        return f"{self.pos}{t}{'ACGTN'[self.rf]}>{'ACGTN'[self.rd]}" + (
            f"@{self.snp}" if self.snp >= 0 else "")


class SC:
    """Scoring adapter (scoring.h semantics over the repo's Scoring)."""

    def __init__(self, s: Scoring):
        self.s = s
        self.mm_tab = s.mm_pen_table()
        self.mmp_max = s.mm_max

    def pen(self, rd: int, rf: int, q: int) -> int:
        """sc.score(rd, mask, q) as a POSITIVE penalty."""
        if rd > 3 or rf > 3:
            return self.s.n_pen
        return int(self.mm_tab[min(q, 63)])

    def clip(self, q_ascii: int) -> int:
        """Scoring::sc(q): soft-clip penalty per base (scoring.h:312)."""
        if q_ascii <= 33:
            return self.s.sp_min
        q = min(q_ascii - 33, 40)
        return int(q / 40.0 * (self.s.sp_max - self.s.sp_min)
                   + self.s.sp_min)

    # reference Scoring::readGapOpen() = const + linear (scoring.h:341)
    @property
    def rd_open(self):
        return self.s.rd_gap_open + self.s.rd_gap_ext

    @property
    def rf_open(self):
        return self.s.rf_gap_open + self.s.rf_gap_ext

    def max_read_gaps(self, minsc: int, rdlen: int) -> int:
        sc, num, first = 0, 0, True
        while sc >= minsc:
            sc -= self.rd_open if first else self.s.rd_gap_ext
            first = False
            num += 1
        return num - 1

    def max_ref_gaps(self, minsc: int, rdlen: int) -> int:
        sc, num, first = 0, 0, True
        while sc >= minsc:
            sc -= self.rf_open if first else self.s.rf_gap_ext
            first = False
            num += 1
        return num - 1

    # splice penalties (scoring.h:473-489)
    def can_spl(self, intronlen: int = 0) -> int:
        pen = int(self.s.pen_can_intron_len(float(intronlen))) \
            if intronlen > 0 else 0
        return max(pen, 0) + self.s.pen_can_splice

    def noncan_spl(self, intronlen: int = 0) -> int:
        pen = int(self.s.pen_noncan_intron_len(float(intronlen))) \
            if intronlen > 0 else 0
        return max(pen, 0) + self.s.pen_noncan_splice

    @property
    def conflict_spl(self) -> int:
        # driver default 1,000,000 (hisat2.cpp:483), --pen-conflictsplice
        return self.s.pen_conflict_splice


class Hit:
    """GenomeHit (hi_aligner.h:560+): a partial alignment."""
    __slots__ = ("fw", "rdoff", "ln", "trim5", "trim3", "tidx", "toff",
                 "joined", "edits", "score", "hitcount")

    def __init__(self, fw, rdoff, ln, tidx, toff, joined):
        self.fw = fw
        self.rdoff = int(rdoff)
        self.ln = int(ln)
        self.trim5 = 0
        self.trim3 = 0
        self.tidx = int(tidx)
        self.toff = int(toff)
        self.joined = int(joined)
        self.edits: list[Edit] = []
        self.score = 0
        self.hitcount = 1

    def clone(self):
        h = Hit(self.fw, self.rdoff, self.ln, self.tidx, self.toff,
                self.joined)
        h.trim5, h.trim3 = self.trim5, self.trim3
        h.edits = [e.clone() for e in self.edits]
        h.score = self.score
        h.hitcount = self.hitcount
        return h

    # -- geometry ----------------------------------------------------

    def right_off(self) -> int:
        toff = self.toff + self.ln
        for e in self.edits:
            if e.typ == RDGAP:
                toff += 1
            elif e.typ == RFGAP:
                toff -= 1
            elif e.typ == SPL:
                toff += e.splen
        return toff

    def get_left(self, want_score=False, seq=None, qual=None, sc=None):
        """Left gapless/unforgiven chunk (hi_aligner.h:888)."""
        ln, score = self.ln, 0
        for e in self.edits:
            if e.typ in (RDGAP, RFGAP, SPL) or (e.typ == MM
                                                and e.snp >= 0):
                ln = e.pos
                break
            if want_score and e.typ == MM:
                score -= sc.pen(e.rd, e.rf, qual[self.rdoff + e.pos] - 33)
        out = (self.rdoff, ln, self.toff)
        return out + ((score,) if want_score else ())

    def get_right(self, want_score=False, seq=None, qual=None, sc=None):
        """Right gapless/unforgiven chunk (hi_aligner.h:930)."""
        rdoff, ln, toff, score = self.rdoff, self.ln, self.toff, 0
        for e in reversed(self.edits):
            if e.typ in (RDGAP, RFGAP, SPL) or (e.typ == MM
                                                and e.snp >= 0):
                rdoff = self.rdoff + e.pos
                ln = self.ln - e.pos
                if e.typ in (RFGAP, MM):
                    rdoff += 1
                    ln -= 1
                toff = self.right_off() - ln
                break
            if want_score and e.typ == MM:
                score -= sc.pen(e.rd, e.rf, qual[self.rdoff + e.pos] - 33)
        out = (rdoff, ln, toff)
        return out + ((score,) if want_score else ())

    def left_anchor(self):
        """getLeftAnchor (hi_aligner.h:1010): (anchor len, # edits)."""
        anchor, nedits = self.ln, 0
        for e in self.edits:
            if e.typ == SPL:
                anchor = e.pos
                break
            nedits += 1
        return anchor, nedits

    def right_anchor(self):
        """getRightAnchor (hi_aligner.h:1033)."""
        anchor, nedits = self.ln, 0
        for e in reversed(self.edits):
            if e.typ == SPL:
                anchor = self.ln - e.pos - 1
                break
            nedits += 1
        return anchor, nedits

    def compatible_with(self, other: "Hit", spliced: bool = False,
                        max_intron: int = 0) -> bool:
        """compatibleWith (hi_aligner.h:1241); spliced relaxes the ref
        gap up to maxIntronLen."""
        if self is other:
            return False
        if self.fw != other.fw or self.tidx != other.tidx:
            return False
        if self.rdoff > other.rdoff:
            return False
        if self.rdoff + self.ln > other.rdoff + other.ln:
            return False
        if self.toff > other.toff:
            return False
        t_rdoff, t_len, t_toff = self.get_right()
        o_rdoff, o_len, o_toff = other.get_left()
        if t_rdoff > o_rdoff:
            return False
        if t_rdoff + t_len > o_rdoff + o_len:
            return False
        if t_toff > o_toff:
            return False
        if spliced:
            refdif = o_toff - t_toff
            rddif = o_rdoff - t_rdoff
            if refdif > rddif + max_intron:
                return False
        return True

    def identity(self):
        return (self.tidx, self.toff, self.fw, self.rdoff, self.ln,
                self.trim5, self.trim3,
                tuple(e.key() for e in self.edits))


class HybridAligner:
    """Reference-faithful per-read aligner over a host FM index."""

    def __init__(self, index, variants=None, scoring: Scoring | None = None,
                 k: int = 5, anchor_stop: bool = True,
                 spliced: bool = False, splice_db=None,
                 secondary: bool = False):
        self.fm = hostfm.HostFM(index)
        self.s = scoring or Scoring()
        self.sc = SC(self.s)
        self.khits = int(k)
        self.kseeds = max(5, 2 * self.khits)
        self.anchor_stop = anchor_stop
        self.spliced = bool(spliced)
        self.ssdb = splice_db
        self.secondary = bool(secondary)
        self._sites_ver = -1
        self._site_by_right = {}      # ref -> sorted [(right, left, ...)]
        self._site_by_left = {}       # ref -> sorted [(left, right, ...)]
        self._prob_tables = None
        g = self.fm.meta.n
        mk = 0
        while g > 0:
            g >>= 2
            mk += 1
        self.minK = mk                    # hi_aligner.h:3807
        self.minK_local = 8
        self.min_anchor = self.s.min_anchor           # tp.h:43 (7)
        self.min_anchor_noncan = self.s.min_anchor_noncan
        self.min_intron = self.s.min_intron_len
        self.max_intron = self.s.max_intron_len       # candidate merge
        # SNV ALT planes (joined pos -> alt code) for forgiveness; known
        # indel/splice ALTs are not modeled here (device path covers them)
        self.snv_pos = np.zeros(0, np.int64)
        self.snv_alt = np.zeros(0, np.int64)
        self.snv_id = np.zeros(0, np.int64)
        if variants is not None and len(variants.snp_pos):
            sgl = np.flatnonzero(np.asarray(variants.snp_kind) == 0)
            order = np.argsort(np.asarray(variants.snp_joined)[sgl],
                               kind="stable")
            sel = sgl[order]
            self.snv_pos = np.asarray(variants.snp_joined)[sel].astype(
                np.int64)
            self.snv_alt = np.asarray(variants.snp_seq)[sel].astype(
                np.int64)
            self.snv_id = sel.astype(np.int64)

    # ---- ALT forgiveness --------------------------------------------

    def snv_at(self, joined: int, rd: int) -> int:
        """ALT id if an SNV at joined position allows read char rd."""
        if not len(self.snv_pos):
            return -1
        i = int(np.searchsorted(self.snv_pos, joined, side="left"))
        while i < len(self.snv_pos) and self.snv_pos[i] == joined:
            if self.snv_alt[i] == rd:
                return int(self.snv_id[i])
            i += 1
        return -1

    # ---- splice-site DB lookups (splice_site.cpp:370-399) ------------

    def _refresh_sites(self):
        db = self.ssdb
        ver = len(db.sites) if db is not None else 0
        if ver == self._sites_ver:
            return
        self._sites_ver = ver
        by_r, by_l = {}, {}
        if db is not None:
            for (ref, left, right), (sdir, srd, ff, nr, *_) in \
                    db.sites.items():
                by_r.setdefault(ref, []).append(
                    (right, left, sdir, srd, ff))
                by_l.setdefault(ref, []).append(
                    (left, right, sdir, srd, ff))
            for ref in by_r:
                by_r[ref].sort()
                by_l[ref].sort()
        self._site_by_right = by_r
        self._site_by_left = by_l

    def left_sites(self, ref_id: int, left: int, range_: int, rdid: int):
        """getLeftSpliceSites: sites with ss.right in [left+1-range, left]
        in ascending (right, left) order; temp sites readid-gated
        (spliced_aligner.h:303-305, -p 1 mindist = 0)."""
        self._refresh_sites()
        import bisect
        lst = self._site_by_right.get(int(ref_id))
        if not lst:
            return []
        lo = bisect.bisect_left(lst, (left + 1 - range_, -1))
        out = []
        for i in range(lo, len(lst)):
            right, sleft, sdir, srd, ff = lst[i]
            if right > left:
                break
            # strict: a temp site enters the DB at its discoverer's
            # finishRead, so it is invisible to the discoverer itself
            if not ff and srd >= rdid:
                continue
            out.append((sleft, right, sdir, ff))
        return out

    def right_sites(self, ref_id: int, right: int, range_: int,
                    rdid: int):
        """getRightSpliceSites: sites with ss.left in
        [right, right+range-1] in ascending (left, right) order."""
        self._refresh_sites()
        import bisect
        lst = self._site_by_left.get(int(ref_id))
        if not lst:
            return []
        lo = bisect.bisect_left(lst, (right, -1))
        out = []
        for i in range(lo, len(lst)):
            sleft, sright, sdir, srd, ff = lst[i]
            if sleft > right + range_ - 1:
                break
            if not ff and srd >= rdid:
                continue
            out.append((sleft, sright, sdir, ff))
        return out

    def probscore(self, donor_seq: int, acc_seq: int) -> float:
        """SpliceSiteDB::probscore (splice_site.cpp:788-850)."""
        from ..ops.splice import junction_prob_tables, probscore_host
        if self._prob_tables is None:
            self._prob_tables = junction_prob_tables()
        return float(probscore_host(donor_seq, acc_seq,
                                    self._prob_tables))

    # ---- scoring -----------------------------------------------------

    def calculate_score(self, hit: Hit, seq, qual):
        """calculateScore (hi_aligner.h:3535), incl. the spliced terms:
        novel-junction intron-length/probscore/anchor-purity gates (as
        MIN_I32 accumulations, exactly like the reference) and the
        can/noncan splice penalties; known-site junctions are free."""
        sc, s = self.sc, self.s
        L = len(seq)
        score = 0
        mm = 0
        conflict = False
        whichsense = SPL_UNKNOWN
        prev = None
        for i, e in enumerate(hit.edits):
            if e.typ == MM:
                if e.snp < 0:
                    score -= sc.pen(e.rd, e.rf,
                                    qual[hit.rdoff + e.pos] - 33)
                    mm += 1
            elif e.typ == SPL:
                if not e.known:
                    left_anchor = hit.rdoff + e.pos
                    right_anchor = L - left_anchor
                    mm2 = 0
                    for e2 in hit.edits[i + 1:]:
                        if e2.typ in (MM, RDGAP, RFGAP):
                            mm2 += 1
                    left_anchor -= mm * 2
                    right_anchor -= mm2 * 2
                    shorter = min(left_anchor, right_anchor)
                    if shorter <= 0:
                        shorter = 1
                    can = e.sdir in (SPL_FW, SPL_RC)
                    thresh = (_max_intron_len(shorter, self.min_anchor)
                              if can else _max_intron_len_noncan(
                                  shorter, self.min_anchor_noncan))
                    if thresh < self.max_intron:
                        if e.splen > thresh:
                            score += MIN_I32
                        if can:
                            p = self.probscore(e.dseq, e.aseq)
                            pt = 0.8
                            if e.splen >> 16:
                                pt = 0.99
                            elif e.splen >> 15:
                                pt = 0.97
                            elif e.splen >> 14:
                                pt = 0.94
                            elif e.splen >> 13:
                                pt = 0.91
                            elif e.splen >> 12:
                                pt = 0.88
                            if p < pt:
                                score += MIN_I32
                        if shorter == left_anchor:
                            if hit.trim5 > 0:
                                score += MIN_I32
                            for e2 in hit.edits[:i]:
                                if e2.typ in (MM, RDGAP, RFGAP):
                                    score += MIN_I32
                        else:
                            if hit.trim3 > 0:
                                score += MIN_I32
                            for e2 in hit.edits[i + 1:]:
                                if e2.typ in (MM, RDGAP, RFGAP):
                                    score += MIN_I32
                    if e.snp < 0:
                        score -= (sc.can_spl(e.splen) if can
                                  else sc.noncan_spl(e.splen))
                if not conflict:
                    if whichsense == SPL_UNKNOWN:
                        whichsense = e.sdir
                    elif e.sdir != SPL_UNKNOWN:
                        if e.sdir in (SPL_FW, SPL_SEMI_FW) and \
                                whichsense not in (SPL_FW, SPL_SEMI_FW):
                            conflict = True
                        if e.sdir in (SPL_RC, SPL_SEMI_RC) and \
                                whichsense not in (SPL_RC, SPL_SEMI_RC):
                            conflict = True
            elif e.typ == RDGAP:
                open_ = not (prev is not None and prev.typ == RDGAP
                             and prev.pos == e.pos)
                if e.snp < 0:
                    score -= sc.rd_open if open_ else s.rd_gap_ext
            elif e.typ == RFGAP:
                open_ = not (prev is not None and prev.typ == RFGAP
                             and prev.pos + 1 == e.pos)
                if e.snp < 0:
                    score -= sc.rf_open if open_ else s.rf_gap_ext
            prev = e
        for i in range(hit.trim5):
            score -= sc.clip(qual[i])
        for i in range(hit.trim3):
            # the reference indexes trim3 clips from the FRONT quals too
            # (hi_aligner.h:3700-3706) — a quirk, replicated for parity
            score -= sc.clip(qual[i])
        if conflict:
            score -= sc.conflict_spl
        hit.score = score
        return score

    # ---- extension (alignWithALTs linear walk + SNV forgiveness) -----

    def _walk_left(self, hit: Hit, seq, mm_allowed: int):
        """Left extension walk (alignWithALTs_recur left branch,
        hi_aligner.h:2649): extend through up to mm_allowed mismatches,
        SNV-matching columns forgiven (snp-tagged, not counted)."""
        g = self.fm.genome(hit.tidx)
        pos = hit.rdoff - 1
        toff = hit.toff - 1
        used = 0
        new_edits = []
        while pos >= 0 and toff >= 0:
            rd = int(seq[pos])
            rf = int(g[toff]) if toff < len(g) else 4
            if rd != rf or rd == 4:
                jo = hit.joined - (hit.rdoff - pos)
                snp = self.snv_at(jo, rd) if rd < 4 and rf < 4 else -1
                if snp >= 0:
                    new_edits.append(Edit(pos, MM, rf, rd, snp))
                else:
                    if used >= mm_allowed:
                        break
                    used += 1
                    new_edits.append(Edit(pos, MM, rf, rd))
            pos -= 1
            toff -= 1
        ext = hit.rdoff - (pos + 1)
        if ext > 0:
            for e in hit.edits:
                e.pos += ext
            base = pos + 1
            adj = [Edit(e.pos - base, e.typ, e.rf, e.rd, e.snp)
                   for e in new_edits]
            hit.edits = list(reversed(adj)) + hit.edits
            hit.rdoff -= ext
            hit.toff -= ext
            hit.joined -= ext
            hit.ln += ext
        return ext

    def _walk_right(self, hit: Hit, seq, mm_allowed: int):
        g = self.fm.genome(hit.tidx)
        L = len(seq)
        ref_ext = hit.ln
        for e in hit.edits:
            if e.typ == RFGAP:
                ref_ext -= 1
            elif e.typ == RDGAP:
                ref_ext += 1
            elif e.typ == SPL:
                ref_ext += e.splen
        pos = hit.rdoff + hit.ln
        toff = hit.toff + ref_ext
        joined = hit.joined + ref_ext
        used = 0
        ext = 0
        while pos < L and toff < len(g):
            rd = int(seq[pos])
            rf = int(g[toff])
            if rd != rf or rd == 4:
                snp = self.snv_at(joined, rd) if rd < 4 and rf < 4 else -1
                if snp >= 0:
                    hit.edits.append(
                        Edit(pos - hit.rdoff, MM, rf, rd, snp))
                else:
                    if used >= mm_allowed:
                        break
                    used += 1
                    hit.edits.append(Edit(pos - hit.rdoff, MM, rf, rd))
            pos += 1
            toff += 1
            joined += 1
            ext += 1
        hit.ln += ext
        return ext

    def extend(self, hit: Hit, seq, qual, left_max, right_max,
               mm_allowed=0):
        """GenomeHit::extend (hi_aligner.h:1892)."""
        leftext = rightext = 0
        if left_max > 0 and hit.rdoff > 0 and hit.toff > 0:
            leftext = self._walk_left(hit, seq, mm_allowed)
        if right_max > 0 and hit.rdoff + hit.ln < len(seq):
            rightext = self._walk_right(hit, seq, mm_allowed)
        self.calculate_score(hit, seq, qual)
        return leftext, rightext

    # ---- combineWith (DNA: mismatches + one indel) --------------------

    def combine(self, left: "Hit", right: "Hit", seq, qual, minsc,
                splice_site=None):
        """combineWith (hi_aligner.h:1286): mutate `left` into the
        combination (mismatches + one indel, or — in spliced mode — one
        intron with motif/PWM splice-point choice); returns False if
        impossible.  splice_site = (ss_left, ss_right) pins the splice
        point to a known/temp DB site (spliceSite != NULL semantics)."""
        if not left.compatible_with(right, self.spliced, self.max_intron):
            return False
        sc, s, fm = self.sc, self.s, self.fm
        t_rdoff, t_len, t_toff, t_score = left.get_right(
            True, seq, qual, sc)
        o_rdoff, o_len, o_toff, o_score = right.get_left(
            True, seq, qual, sc)
        if t_rdoff > o_rdoff:
            return False
        if t_len != 0 and o_len != 0 and t_rdoff + t_len > o_rdoff + o_len:
            return False
        length = o_rdoff - t_rdoff + o_len
        reflen = fm.ref_len(left.tidx)
        if t_toff + length > reflen:
            return False
        refdif = o_toff - t_toff
        rddif = o_rdoff - t_rdoff
        spliced = ins = del_ = False
        if refdif != rddif:
            if refdif > rddif:
                if self.spliced and refdif - rddif >= self.min_intron:
                    spliced = True
                else:
                    del_ = True
            else:
                ins = True

        # gapless same-diagonal merge
        if not spliced and not ins and not del_ \
                and t_rdoff + t_len == o_rdoff:
            addoff = right.rdoff - left.rdoff
            for e in right.edits:
                ne = e.clone()
                ne.pos += addoff
                left.edits.append(ne)
            left.ln += right.ln
            self.calculate_score(left, seq, qual)
            return True

        remainsc = minsc - (left.score - t_score) \
            - (right.score - o_score)
        if remainsc > 0:
            remainsc = 0
        rdlen = len(seq)
        read_gaps = ref_gaps = 0
        if not spliced:
            read_gaps = sc.max_read_gaps(remainsc + sc.can_spl(), rdlen)
            ref_gaps = sc.max_ref_gaps(remainsc + sc.can_spl(), rdlen)
        if ins and refdif + ref_gaps < rddif:
            return False
        if del_ and rddif + read_gaps < refdif:
            return False
        # left-diagonal buffer with intronic margin (hi_aligner.h:1419)
        text = read_gaps + (INTRONIC_LEN if spliced else 0)
        if t_toff + length + text > reflen:
            text = reflen - (t_toff + length)
        refbuf = fm.stretch(left.tidx, t_toff, length + text)
        # right-diagonal buffer, with a left margin for the acceptor
        # intronic window (refbuf2[i] valid for i in [-oext, length))
        oext = min(read_gaps + INTRONIC_LEN,
                   o_toff + o_len - length)
        oext = max(oext, 0)
        buf2 = fm.stretch(left.tidx, o_toff + o_len - length - oext,
                          length + oext)

        def rb2(i):
            return int(buf2[i + oext])

        maxscore, maxscorei = NEG, None
        maxspldir = SPL_UNKNOWN
        maxsplscore = 0.0
        donor_seq = acc_seq = 0
        if spliced:
            # ---- splice-point scan (hi_aligner.h:1446-1612) ----------
            temp = [0] * length
            i = 0
            while i < length:
                rdc = int(seq[t_rdoff + i])
                rfc = int(refbuf[i])
                temp[i] = temp[i - 1] if i > 0 else 0
                if rdc != rfc:
                    temp[i] -= sc.pen(rdc, rfc, qual[t_rdoff + i] - 33)
                if temp[i] < remainsc:
                    break
                i += 1
            i_limit = min(i, length)
            temp2 = [0] * (length + 1)
            i2 = length - 1
            while i2 >= 0:
                rdc = int(seq[t_rdoff + i2])
                rfc = rb2(i2)
                temp2[i2] = temp2[i2 + 1] if i2 + 1 < length else 0
                if rdc != rfc:
                    temp2[i2] -= sc.pen(rdc, rfc, qual[t_rdoff + i2] - 33)
                if temp2[i2] < remainsc:
                    break
                i2 -= 1
            i2_limit = max(i2, 0)
            if splice_site is not None:
                sl = splice_site[0] - t_toff
                if i2_limit <= sl:
                    i2_limit = sl
                    i_limit = sl + 1
                else:
                    i_limit = i2_limit
            i, i2 = i2_limit, i2_limit + 1
            while i < i_limit and i2 < length:
                tempscore = temp[i] + temp2[i2]
                donor = acceptor = None
                if i + 2 < length + text:
                    donor = (int(refbuf[i + 1]), int(refbuf[i + 2]))
                if i2 - 2 >= -oext:
                    acceptor = (rb2(i2 - 2), rb2(i2 - 1))
                canonical = semi = False
                spldir = SPL_UNKNOWN
                if donor == (2, 3) and acceptor == (0, 2):      # GT..AG
                    spldir, canonical = SPL_FW, True
                elif donor == (1, 3) and acceptor == (0, 1):    # CT..AC
                    spldir, canonical = SPL_RC, True
                elif (donor == (2, 1) and acceptor == (0, 2)) \
                        or (donor == (0, 3) and acceptor == (0, 1)):
                    spldir, semi = SPL_SEMI_FW, True            # GC..AG/AT..AC
                elif (donor == (1, 3) and acceptor == (2, 1)) \
                        or (donor == (2, 0) and acceptor == (0, 3)):
                    spldir, semi = SPL_SEMI_RC, True
                tempscore -= (sc.can_spl() if canonical
                              else sc.noncan_spl())
                t_dseq = t_aseq = 0
                splscore = 0.0
                if canonical:
                    if spldir == SPL_FW:
                        if (i + 1 >= DONOR_EXONIC
                                and length + text > i + DONOR_INTRONIC
                                and i2 + oext >= ACC_INTRONIC
                                and length > i2 + ACC_EXONIC - 1):
                            for j in range(i + 1 - DONOR_EXONIC,
                                           i + DONOR_INTRONIC + 1):
                                b = int(refbuf[j])
                                if b > 3:
                                    b = 0
                                t_dseq = (t_dseq << 2) | b
                            for j in range(i2 - ACC_INTRONIC,
                                           i2 + ACC_EXONIC):
                                b = rb2(j)
                                if b > 3:
                                    b = 0
                                t_aseq = (t_aseq << 2) | b
                    elif spldir == SPL_RC:
                        if (i + 1 >= ACC_EXONIC
                                and length + text > i + ACC_INTRONIC
                                and i2 + oext >= DONOR_INTRONIC
                                and length > i2 + DONOR_EXONIC - 1):
                            for j in range(i + ACC_INTRONIC,
                                           i - ACC_EXONIC, -1):
                                b = int(refbuf[j])
                                if b > 3:
                                    b = 0
                                t_aseq = (t_aseq << 2) | (b ^ 3)
                            for j in range(i2 + DONOR_EXONIC - 1,
                                           i2 - DONOR_INTRONIC - 1, -1):
                                b = rb2(j)
                                if b > 3:
                                    b = 0
                                t_dseq = (t_dseq << 2) | (b ^ 3)
                    splscore = self.probscore(t_dseq, t_aseq)
                # splice-point preference (hi_aligner.h:1589-1608)
                if ((maxspldir == SPL_UNKNOWN and spldir == SPL_UNKNOWN
                     and maxscore < tempscore)
                        or (maxspldir == SPL_UNKNOWN
                            and spldir == SPL_UNKNOWN
                            and maxscore == tempscore and semi)
                        or (maxspldir != SPL_UNKNOWN
                            and spldir != SPL_UNKNOWN
                            and (maxscore < tempscore
                                 or (maxscore == tempscore
                                     and maxsplscore < splscore)))
                        or (maxspldir == SPL_UNKNOWN
                            and spldir != SPL_UNKNOWN)):
                    maxscore, maxscorei = tempscore, i
                    maxspldir = spldir
                    maxsplscore = splscore
                    if maxspldir != SPL_UNKNOWN:
                        donor_seq, acc_seq = t_dseq, t_aseq
                    else:
                        donor_seq = acc_seq = 0
                i += 1
                i2 += 1
            if maxscorei is None:
                return False
            if splice_site is None:
                # novel-junction anchor gate (hi_aligner.h:1656-1678)
                shorter = min(maxscorei + 1, length - maxscorei - 1)
                if maxspldir in (SPL_SEMI_FW, SPL_SEMI_RC, SPL_UNKNOWN):
                    if shorter < self.min_anchor_noncan:
                        if _intron_len_prob_noncan(
                                shorter, o_toff - t_toff,
                                self.max_intron) > 0.01:
                            return False
                else:
                    if shorter < self.min_anchor:
                        if _intron_len_prob(
                                shorter, o_toff - t_toff,
                                self.max_intron) > 0.01:
                            return False
            if maxscore < remainsc:
                return False
            inslen = dellen = 0
        elif not ins and not del_:
            # same-diagonal interior gap (pieces apart on the read but on
            # one diagonal): the reference never enters the split-point
            # scan — maxscorei stays INDEX_MAX, there is no gap penalty
            # and no score gate — so every interior mismatch is simply
            # filled from the left diagonal (hi_aligner.h:1385-1418
            # skipped, fill loop 1775-1800); the caller gates on score.
            inslen = dellen = 0
            maxscore, maxscorei = 0, length
        else:
            inslen = (rddif - refdif) if ins else 0
            dellen = (refdif - rddif) if del_ else 0
            if ins:
                gap_penalty = -(sc.rf_open + s.rf_gap_ext * (inslen - 1))
            else:
                gap_penalty = -(sc.rd_open + s.rd_gap_ext * (dellen - 1))
            if gap_penalty < remainsc:
                return False
            # prefix penalties on the left diagonal (raw, no forgiveness)
            temp = [0] * length
            i = 0
            while i < length:
                rdc = int(seq[t_rdoff + i])
                rfc = int(refbuf[i])
                temp[i] = temp[i - 1] if i > 0 else 0
                if rdc != rfc:
                    temp[i] -= sc.pen(rdc, rfc, qual[t_rdoff + i] - 33)
                if temp[i] + gap_penalty < remainsc:
                    break
                i += 1
            i_limit = min(i, length)
            # suffix penalties on the right diagonal
            temp2 = [0] * (length + 1)
            i2 = length - 1
            while i2 >= 0:
                rdc = int(seq[t_rdoff + i2])
                rfc = rb2(i2)
                temp2[i2] = temp2[i2 + 1] if i2 + 1 < length else 0
                if rdc != rfc:
                    temp2[i2] -= sc.pen(rdc, rfc, qual[t_rdoff + i2] - 33)
                if temp2[i2] + gap_penalty < remainsc:
                    break
                i2 -= 1
            i2_limit = 0 if i2 < inslen else i2 - inslen
            maxscore, maxscorei = NEG, None
            i, i2 = i2_limit, i2_limit + 1 + inslen
            while i < i_limit and i2 < length:
                t = temp[i] + temp2[i2] + gap_penalty
                if t > maxscore:
                    maxscore, maxscorei = t, i
                i += 1
                i2 += 1
            if maxscorei is None or maxscore < remainsc:
                return False

        # rebuild edits: keep left's edits up to its last gap/spl/forgiven
        keep = 0
        for j in range(len(left.edits) - 1, -1, -1):
            e = left.edits[j]
            if e.typ in (RDGAP, RFGAP, SPL) or (e.typ == MM
                                                and e.snp >= 0):
                keep = j + 1
                break
        left.edits = left.edits[:keep]
        addoff = t_rdoff - left.rdoff
        if spliced:
            # spliced rebuild (hi_aligner.h:1692-1773; no forgiveness
            # on the rebuilt mismatches, matching the reference)
            for i in range(length):
                rdc = int(seq[t_rdoff + i])
                rfc = int(refbuf[i]) if i <= maxscorei else rb2(i)
                if rdc != rfc:
                    left.edits.append(Edit(i + addoff, MM, rfc, rdc))
                if i == maxscorei:
                    lpos = t_toff + i + 1
                    rpos = o_toff + o_len - (length - i - 1)
                    left.edits.append(Edit(
                        i + 1 + addoff, SPL, 0, 0,
                        splen=rpos - lpos, sdir=maxspldir,
                        known=splice_site is not None,
                        dseq=donor_seq, aseq=acc_seq))
        else:
            i = 0
            while i < length:
                rdc = int(seq[t_rdoff + i])
                rfc = int(refbuf[i]) if i <= maxscorei else rb2(i)
                if rdc != rfc:
                    jo = left.joined + i + (t_toff - left.toff)
                    if i > maxscorei:
                        # right diagonal: joined shifts by the gap
                        jo += (dellen - inslen)
                    snp = (self.snv_at(jo, rdc)
                           if rdc < 4 and rfc < 4 else -1)
                    left.edits.append(Edit(i + addoff, MM, rfc, rdc, snp))
                if i == maxscorei:
                    lpos = t_toff + i + 1
                    rpos = o_toff + o_len - (length - i - 1)
                    if del_:
                        skip = rpos - lpos
                        for j in range(skip):
                            rfc2 = (int(refbuf[i + 1 + j])
                                    if i + 1 + j < length + text
                                    else int(fm.stretch(
                                        left.tidx, t_toff + i + 1 + j,
                                        1)[0]))
                            left.edits.append(
                                Edit(i + 1 + addoff, RDGAP, rfc2, 4))
                    else:
                        skip = lpos - rpos
                        for j in range(skip):
                            rdc2 = int(seq[t_rdoff + i + 1 + j])
                            left.edits.append(
                                Edit(i + 1 + j + addoff, RFGAP, 4, rdc2))
                        i += skip
                i += 1
        # append the right hit's own structured tail (its edits from the
        # first gap/splice/forgiven onward, hi_aligner.h:1831-1846)
        fsi = len(right.edits)
        for j, e in enumerate(right.edits):
            if e.typ in (RDGAP, RFGAP, SPL) or (e.typ == MM
                                                and e.snp >= 0):
                fsi = j
                break
        addoff2 = right.rdoff - left.rdoff
        for e in right.edits[fsi:]:
            ne = e.clone()
            ne.pos += addoff2
            left.edits.append(ne)
        left.ln = right.rdoff + right.ln - left.rdoff
        left.trim3 += right.trim3
        self.calculate_score(left, seq, qual)
        return True

    # ---- trims ---------------------------------------------------------

    def trim5(self, hit: Hit, n, seq, qual):
        hit.trim5 = n
        self.calculate_score(hit, seq, qual)

    def trim3(self, hit: Hit, n, seq, qual):
        hit.trim3 = n
        self.calculate_score(hit, seq, qual)

    # ---- partial search (hi_aligner.h:5434) ---------------------------

    def _partial_search(self, lane: "Lane", seq):
        """One partialSearch round; returns anchor-stop flag."""
        fm = self.fm
        L = lane.L
        ftab_k = fm.meta.ftab_k
        lane.n_search += 1
        offset = lane.cur
        dep = offset
        left = L - dep
        armed = self.anchor_stop
        if left < ftab_k + 1:
            lane.cur = L
            lane.hits.append(PartialHit(0, 0, offset, lane.cur - offset))
            lane.done = True
            return False
        for i in range(ftab_k):
            if seq[L - dep - 1 - i] > 3:
                lane.cur += i + 1
                lane.hits.append(
                    PartialHit(0, 0, offset, lane.cur - offset))
                if lane.cur >= L:
                    lane.done = True
                return False
        top, bot = fm.ftab_lohi(seq[L - dep - ftab_k:L - dep])
        dep += ftab_k
        if top >= bot:
            lane.cur = dep
            lane.hits.append(PartialHit(0, 0, offset, dep - offset))
            if lane.cur >= L:
                lane.done = True
            return False
        same_range = 0
        astop = False
        while dep < L:
            c = int(seq[L - dep - 1])
            if c > 3:
                t2 = b2 = 0
            else:
                t2, b2 = fm.lf_range(top, bot, c)
            if t2 >= b2:
                break
            if armed:
                if b2 - t2 != 1 and bot - top == b2 - t2:
                    same_range += 1
                    if same_range >= 5:
                        armed = False
                else:
                    same_range = 0
                if dep - offset >= self.minK + 8 and b2 - t2 >= 4:
                    armed = False
            top, bot = t2, b2
            dep += 1
            if armed and dep - offset >= self.minK + 12 and bot - top == 1:
                lane.n_unique += 1
                astop = True
                break
        ht = ANCHOR_HIT if astop else CANDIDATE_HIT
        lane.hits.append(PartialHit(top, bot, offset, dep - offset, ht))
        lane.cur = dep
        if lane.cur >= L:
            if ht == CANDIDATE_HIT:
                lane.n_unique += 1
            lane.done = True
        return astop

    # ---- anchor selection (hi_aligner.h:4341 getAnchorHits) -----------

    def _resolve_partial(self, ph: PartialHit, L: int):
        """(coords in SA-row order, straddled): getAnchorHits does NOT
        sort its coords (hi_aligner.h:4377-4402) — the anchor created
        for a merged candidate region is the first-resolved row's."""
        fm = self.fm
        coords = []
        straddled = False
        for row in range(ph.top, ph.bot):
            j = fm.resolve_row(row)
            f = int(np.searchsorted(fm.frag_joined, j, side="right")) - 1
            if j + ph.ln > int(fm.frag_joined[f + 1]):
                straddled = True
            tid = int(fm.frag_ref[f])
            toff = int(fm.frag_off[f]) + (j - int(fm.frag_joined[f]))
            coords.append((tid, toff, j))
        return coords, straddled

    def _get_anchor_hits(self, lane: "Lane", fw: bool, seq):
        L = lane.L
        maxsize = max(self.khits, self.kseeds)
        max_size = maxsize if lane.cur >= L else 1

        def usable(h):
            return not (h.empty or h.resolved
                        or (h.hit_type == CANDIDATE_HIT
                            and h.size > max_size)
                        or h.ln <= self.minK + 2)

        genome_hits: list[Hit] = []
        for _ in range(len(lane.hits)):
            cand = [h for h in lane.hits if usable(h)]
            if not cand:
                break
            hj = cand[0]
            for hk in cand[1:]:
                if hk.hit_type != hj.hit_type:
                    if hk.hit_type > hj.hit_type:
                        hj = hk
                elif (hj.size > hk.size
                      or (hj.size == hk.size and hj.ln < hk.ln)):
                    hj = hk
            coords, straddled = self._resolve_partial(hj, L)
            hj.resolved = True
            if not coords:
                continue
            rdoff = L - hj.bwoff - hj.ln
            n_before = len(genome_hits)
            stop = False
            for tid, toff, j in coords:
                overlapped = False
                for gh in genome_hits[:n_before]:
                    if gh.tidx != tid or gh.fw != fw:
                        continue
                    hitoff = gh.toff + L - gh.rdoff
                    hitoff2 = toff + L - rdoff
                    if abs(hitoff - hitoff2) <= self.max_intron:
                        overlapped = True
                        gh.hitcount += 1
                        break
                if not overlapped:
                    h = Hit(fw, rdoff, 1 if straddled else hj.ln,
                            tid, toff, j)
                    genome_hits.append(h)
                if (hj.hit_type == CANDIDATE_HIT
                        and len(genome_hits) >= maxsize):
                    stop = True
                    break
            if stop:
                break
        return genome_hits

    # ---- sink helpers --------------------------------------------------

    def _redundant(self, sink: "Sink", hit: Hit) -> bool:
        """redundant(sink, rdi, hit) (hi_aligner.h:5384): same leftmost
        coord + identical edit list."""
        for r in sink.rs:
            if (r.tidx, r.toff, r.fw) != (hit.tidx, hit.toff, hit.fw):
                continue
            if len(r.edits) == len(hit.edits) and all(
                    a.key() == b.key()
                    for a, b in zip(r.edits, hit.edits)):
                return True
        return False

    def _report(self, sink: "Sink", hit: Hit, L: int, minsc: int):
        """reportHit (hi_aligner.h:5146): full-coverage + score gates."""
        if hit.rdoff - hit.trim5 > 0 \
                or hit.ln + hit.trim5 + hit.trim3 < L:
            return
        if hit.score < minsc:
            return
        sink.report(hit)

    # ---- splice-site-guided report variants (spliced_aligner.h:283-547)

    def _report_spliced_variants(self, hit: "Hit", seq, qual, minsc,
                                 sink: "Sink") -> int:
        """At full coverage, try re-expressing the alignment through
        known/temp splice sites near its ends (the reference's
        another_spliced block): a site-anchored left exon piece combined
        into the hit, then site-anchored right extensions of every
        variant; report the best-scoring set."""
        maxsc = NEG
        L = len(seq)
        fm, sc = self.fm, self.sc
        rdid = self._rdid
        best_score = hit.score
        lst = [hit]
        mml = self.minK
        fragoff, fraglen, left_toff = hit.get_left()
        if fraglen >= mml and left_toff >= mml and hit.trim5 == 0:
            for ss_left, ss_right, sdir, ff in self.left_sites(
                    hit.tidx, left_toff + mml, mml, rdid):
                if left_toff + fraglen - 1 < ss_right:
                    continue
                if fragoff + ss_right < left_toff + 1:
                    continue
                readoff = fragoff + ss_right - left_toff - 1
                joined = fm.text_to_joined(hit.tidx, ss_left)
                if joined < 0:
                    continue
                t = Hit(hit.fw, readoff + 1, 0, hit.tidx, ss_left + 1,
                        joined + 1)
                self.extend(t, seq, qual, 1 << 30, 0, 0)
                if t.ln <= 0:
                    continue
                if not t.compatible_with(hit, True, self.max_intron):
                    continue
                ms = max(minsc, best_score)
                combined = self.combine(t, hit, seq, qual, ms,
                                        splice_site=(ss_left, ss_right))
                ms = max(ms, sink.best)
                la, ned = t.left_anchor()
                if combined and t.score >= ms and ned <= la // 4:
                    if t.identity() in self._searched:
                        continue
                    if not self._redundant(sink, t):
                        if t.score > best_score:
                            best_score = t.score
                        lst.append(t)
        num = len(lst)
        for i in range(num):
            h = lst[i]
            fragoff, fraglen, right_toff = h.get_right()
            if h.score < best_score:
                continue
            if fraglen >= mml and h.trim3 == 0:
                for ss_left, ss_right, sdir, ff in self.right_sites(
                        h.tidx, right_toff + fraglen - mml, mml, rdid):
                    if right_toff > ss_left:
                        continue
                    readoff = fragoff + ss_left - right_toff + 1
                    if readoff >= L:
                        continue
                    joined = fm.text_to_joined(h.tidx, ss_right)
                    if joined < 0:
                        continue
                    t = Hit(h.fw, readoff, 0, h.tidx, ss_right, joined)
                    self.extend(t, seq, qual, 0, 1 << 30, 0)
                    if t.ln <= 0:
                        continue
                    if not h.compatible_with(t, True, self.max_intron):
                        continue
                    ch = h.clone()
                    ms = max(minsc, best_score)
                    combined = self.combine(
                        ch, t, seq, qual, ms,
                        splice_site=(ss_left, ss_right))
                    ms = max(ms, sink.best)
                    ra, ned = ch.right_anchor()
                    if combined and ch.score >= ms and ned <= ra // 4:
                        if ch.identity() in self._searched:
                            continue
                        if not self._redundant(sink, ch):
                            if ch.score > best_score:
                                # reference quirk: the threshold compares
                                # the COMBINED score but records the
                                # right-extension piece's score
                                # (spliced_aligner.h:508-509)
                                best_score = t.score
                            lst.append(ch)
        for i, h in enumerate(lst):
            if not self.secondary and h.score < best_score:
                continue
            if i > 0:
                self._searched.add(h.identity())
            if not self._redundant(sink, h):
                self._report(sink, h, L, minsc)
                maxsc = max(maxsc, h.score)
        return maxsc

    # ---- hybridSearch_recur (spliced_aligner.h:214) --------------------

    def _recur(self, hit: Hit, hitoff: int, hitlen: int, seq, qual,
               minsc: int, sink: "Sink", dep: int = 0) -> int:
        maxsc = NEG
        L = len(seq)
        if hit.score < minsc:
            return maxsc
        if dep >= 128:
            return maxsc
        if hitoff == hit.rdoff - hit.trim5 \
                and hitlen == hit.ln + hit.trim5 + hit.trim3:
            key = hit.identity()
            if key in self._searched:
                return maxsc
            self._searched.add(key)
        s, sc, fm = self.s, self.sc, self.fm

        if hitoff == 0 and hitlen == L:
            if not self._redundant(sink, hit):
                if self.spliced and self.ssdb is not None \
                        and len(self.ssdb.sites):
                    maxsc = max(maxsc, self._report_spliced_variants(
                        hit, seq, qual, minsc, sink))
                else:
                    self._report(sink, hit, L, minsc)
                    maxsc = max(maxsc, hit.score)
            return maxsc

        if hitoff > 0 and (hitoff + hitlen == L
                           or hitoff + hitoff < L - hitlen):
            # ---- extend LEFT (spliced_aligner.h:560-1200) --------------
            if self.spliced and self.ssdb is not None \
                    and len(self.ssdb.sites):
                # splice-site-guided left combine (spliced_aligner.h:551)
                fragoff, fraglen, left_toff = hit.get_left()
                mml = self.minK_local
                if fraglen >= mml and left_toff >= mml:
                    for ss_left, ss_right, sdir, ff in self.left_sites(
                            hit.tidx, left_toff + mml,
                            mml + min(mml, fragoff), self._rdid):
                        if left_toff + fraglen - 1 < ss_right:
                            continue
                        if fragoff + ss_right < left_toff + 1:
                            continue
                        readoff = fragoff + ss_right - left_toff - 1
                        joined = fm.text_to_joined(hit.tidx, ss_left)
                        if joined < 0:
                            continue
                        t = Hit(hit.fw, readoff + 1, 0, hit.tidx,
                                ss_left + 1, joined + 1)
                        self.extend(t, seq, qual, 1 << 30, 0, 0)
                        if t.ln <= 0:
                            continue
                        if not t.compatible_with(hit, True,
                                                 self.max_intron):
                            continue
                        ms = minsc
                        combined = self.combine(
                            t, hit, seq, qual, ms,
                            splice_site=(ss_left, ss_right))
                        if not self.secondary:
                            ms = max(ms, sink.best)
                        if combined and t.score >= ms and \
                                t.score + sc.clip(0) * hit.rdoff \
                                >= hit.score:
                            maxsc = max(maxsc, self._recur(
                                t, t.rdoff, t.ln + t.trim3, seq, qual,
                                minsc, sink, dep + 1))
            use_local = True
            if hitoff == hit.rdoff and hitoff <= self.minK:
                t = hit.clone()
                self.extend(t, seq, qual, 1 << 30, 0, 1)
                if t.rdoff == 0:
                    use_local = False
            success = False
            count = 0
            prev_score = hit.score
            stash: list[Hit] = []
            wstart, wlen = hostfm.local_window(fm, hit.tidx, hit.toff)
            first = True
            while not success and count < 2 and use_local:
                count += 1
                if self.li_atts >= self.li_budget:
                    break
                if not first:
                    nw = hostfm.prev_local_window(wstart)
                    if nw is None:
                        break
                    wstart = nw
                first = False
                win = fm.genome(hit.tidx)[
                    wstart:wstart + hostfm.LOCAL_SIZE]
                extoff = hitoff - 1
                if extoff > 0:
                    extoff -= 1
                if extoff < self.min_anchor:
                    extoff = self.min_anchor
                nelt, extlen, ends, ustop = 0, 0, None, False
                no_ext = False
                while extoff < L:
                    self.li_atts += 1
                    nelt, extlen, ends, ustop = hostfm.local_search(
                        win, seq, extoff, self.minK_local, self.kseeds)
                    if extoff + 1 - extlen >= hitoff:
                        no_ext = True
                        break
                    if nelt <= 5:
                        break
                    extoff += 1
                if (nelt > 0 and nelt <= 5 and extlen >= self.min_anchor
                        and not no_ext):
                    # window coords ascending; iterate DESCENDING
                    for wpos in sorted(int(e) for e in ends)[::-1]:
                        toff = wstart + wpos - extlen + 1
                        j = fm.text_to_joined(hit.tidx, toff)
                        if j < 0 or fm.text_to_joined(
                                hit.tidx, toff + extlen - 1) != \
                                j + extlen - 1:
                            continue      # straddles an N gap: rejected
                        t = Hit(hit.fw, extoff + 1 - extlen, extlen,
                                hit.tidx, toff, j)
                        if not t.compatible_with(hit, self.spliced,
                                                 self.max_intron):
                            if count == 1:
                                continue
                            break
                        if ustop:
                            self.extend(t, seq, qual, 1 << 30, 0, 0)
                        ms = minsc
                        combined = self.combine(t, hit, seq, qual, ms)
                        ms = max(ms, sink.best)
                        if combined and t.score >= ms:
                            if t.score >= prev_score - sc.mmp_max:
                                maxsc = max(maxsc, self._recur(
                                    t, t.rdoff, t.ln + t.trim3,
                                    seq, qual, minsc, sink, dep + 1))
                            else:
                                stash.append(t)
                if maxsc >= prev_score - sc.mmp_max:
                    success = True
                if not success and (
                        self.li_atts >= self.li_budget or count == 2
                        or hostfm.prev_local_window(wstart) is None):
                    for t in stash:
                        ms = max(minsc, sink.best)
                        if t.score >= ms:
                            maxsc = max(maxsc, self._recur(
                                t, t.rdoff, t.ln + t.trim3,
                                seq, qual, minsc, sink, dep + 1))
            if not success:
                # global search (long-distance joins)
                if hitoff > self.minK and self.li_atts < self.li_budget:
                    maxsc = max(maxsc, self._global_left(
                        hit, hitoff, seq, qual, minsc, sink, dep))
                t = hit.clone()
                trim_max = (t.score - max(maxsc, minsc)) // sc.clip(0)
                if t.rdoff < trim_max:
                    tr = t.clone()
                    self.trim5(tr, tr.rdoff, seq, qual)
                    if tr.score > maxsc and tr.score >= minsc:
                        maxsc = max(maxsc, self._recur(
                            tr, 0, tr.ln + tr.trim5 + tr.trim3,
                            seq, qual, minsc, sink, dep + 1))
                # direct extension with mismatches
                ms = minsc
                mm = (t.score - ms) // sc.mmp_max
                nmm = 1
                if hitoff <= self.minK_local:
                    nmm = min(t.rdoff, mm)
                lext, _ = self.extend(t, seq, qual, 1 << 30, 0, nmm)
                ms = max(ms, sink.best)
                if t.score >= ms and lext >= min(self.minK_local,
                                                 hit.rdoff):
                    maxsc = max(maxsc, self._recur(
                        t, t.rdoff, t.ln + t.trim3, seq, qual,
                        minsc, sink, dep + 1))
                elif hitoff > self.minK_local:
                    jump = self.minK if hitoff > self.minK \
                        else self.minK_local
                    exp = hit.score - (hit.rdoff - hitoff) // jump \
                        * sc.mmp_max - sc.mmp_max
                    if exp >= ms:
                        maxsc = max(maxsc, self._recur(
                            hit, hitoff - jump, hitlen + jump,
                            seq, qual, minsc, sink, dep + 1))
        else:
            # ---- extend RIGHT (spliced_aligner.h:1260-1892) ------------
            if self.spliced and self.ssdb is not None \
                    and len(self.ssdb.sites):
                # splice-site-guided right combine (spliced_aligner.h:1203)
                fragoff, fraglen, right_toff = hit.get_right()
                mml = self.minK_local
                if fraglen >= mml:
                    right_unmapped = L - fragoff - fraglen
                    for ss_left, ss_right, sdir, ff in self.right_sites(
                            hit.tidx, right_toff + fraglen - mml,
                            mml + min(mml, right_unmapped), self._rdid):
                        if right_toff > ss_left:
                            continue
                        readoff = fragoff + ss_left - right_toff + 1
                        if readoff >= L:
                            continue
                        joined = fm.text_to_joined(hit.tidx, ss_right)
                        if joined < 0:
                            continue
                        t = Hit(hit.fw, readoff, 0, hit.tidx, ss_right,
                                joined)
                        self.extend(t, seq, qual, 0, 1 << 30, 0)
                        if t.ln <= 0:
                            continue
                        if not hit.compatible_with(t, True,
                                                   self.max_intron):
                            continue
                        ch = hit.clone()
                        ms = minsc
                        combined = self.combine(
                            ch, t, seq, qual, ms,
                            splice_site=(ss_left, ss_right))
                        if not self.secondary:
                            ms = max(ms, sink.best)
                        if combined and ch.score >= ms and \
                                ch.score + sc.clip(0) * (
                                    L - hit.rdoff - hit.ln - hit.trim5) \
                                >= hit.score:
                            maxsc = max(maxsc, self._recur(
                                ch, ch.rdoff - ch.trim5,
                                ch.ln + ch.trim5, seq, qual,
                                minsc, sink, dep + 1))
            use_local = True
            if hit.ln == hitlen and hitoff + hitlen + self.minK > L:
                t = hit.clone()
                self.extend(t, seq, qual, 0, 1 << 30, 1)
                if t.rdoff + t.ln == L:
                    use_local = False
            success = False
            count = 0
            prev_score = hit.score
            stash = []
            wstart, wlen = hostfm.local_window(fm, hit.tidx, hit.toff)
            first = True
            while not success and count < 2 and use_local:
                count += 1
                if self.li_atts >= self.li_budget:
                    break
                if not first:
                    nw = hostfm.next_local_window(fm, hit.tidx, wstart)
                    if nw is None:
                        break
                    wstart = nw
                first = False
                win = fm.genome(hit.tidx)[
                    wstart:wstart + hostfm.LOCAL_SIZE]
                extoff = hitoff + hitlen + self.minK_local
                if extoff + 1 < L:
                    extoff += 1
                if extoff >= L:
                    extoff = L - 1
                max_hitlen = max(extoff - hitoff - hitlen,
                                 self.minK_local)
                nelt, extlen, ends, ustop = 0, 0, None, False
                no_ext = False
                while max_hitlen < extoff + 1 and extoff < L:
                    self.li_atts += 1
                    nelt, extlen, ends, ustop = hostfm.local_search(
                        win, seq, extoff, self.minK_local, self.kseeds,
                        max_hitlen, unique_stop=False)
                    if extoff < hitoff + hitlen:
                        no_ext = True
                        break
                    if nelt <= 5:
                        break
                    if extoff + 1 < L:
                        extoff += 1
                    elif extlen < max_hitlen:
                        break
                    else:
                        max_hitlen += 1
                if (nelt > 0 and nelt <= 5 and extlen >= self.min_anchor
                        and not no_ext):
                    for wpos in sorted(int(e) for e in ends):
                        toff = wstart + wpos - extlen + 1
                        j = fm.text_to_joined(hit.tidx, toff)
                        if j < 0 or fm.text_to_joined(
                                hit.tidx, toff + extlen - 1) != \
                                j + extlen - 1:
                            continue
                        t = Hit(hit.fw, extoff + 1 - extlen, extlen,
                                hit.tidx, toff, j)
                        if not hit.compatible_with(t, self.spliced,
                                                   self.max_intron):
                            if count == 1:
                                continue
                            break
                        self.extend(t, seq, qual, 0, 1 << 30, 0)
                        ch = hit.clone()
                        ms = minsc
                        combined = self.combine(ch, t, seq, qual, ms)
                        ms = max(ms, sink.best)
                        if combined and ch.score >= ms:
                            if ch.score >= prev_score - sc.mmp_max:
                                maxsc = max(maxsc, self._recur(
                                    ch, ch.rdoff - ch.trim5,
                                    ch.ln + ch.trim5, seq, qual,
                                    minsc, sink, dep + 1))
                            else:
                                stash.append(ch)
                if maxsc >= prev_score - sc.mmp_max:
                    success = True
                if not success and (
                        self.li_atts >= self.li_budget or count == 2
                        or hostfm.next_local_window(
                            fm, hit.tidx, wstart) is None):
                    for t in stash:
                        ms = max(minsc, sink.best)
                        if t.score >= ms:
                            maxsc = max(maxsc, self._recur(
                                t, t.rdoff - t.trim5, t.ln + t.trim5,
                                seq, qual, minsc, sink, dep + 1))
            if not success:
                if hitoff + hitlen + self.minK + 1 < L \
                        and self.li_atts < self.li_budget:
                    maxsc = max(maxsc, self._global_right(
                        hit, hitoff, hitlen, seq, qual, minsc, sink,
                        dep))
                t = hit.clone()
                trim_len = L - hitoff - t.ln - t.trim5
                trim_max = (t.score - max(maxsc, minsc)) // sc.clip(0)
                if trim_len < trim_max:
                    tr = t.clone()
                    self.trim3(tr, L - hitoff - tr.ln - tr.trim5,
                               seq, qual)
                    if tr.score > maxsc and tr.score >= minsc:
                        maxsc = max(maxsc, self._recur(
                            tr, tr.rdoff - tr.trim5,
                            tr.ln + tr.trim5 + tr.trim3,
                            seq, qual, minsc, sink, dep + 1))
                ms = minsc
                mm = (t.score - ms) // sc.mmp_max
                nmm = 1
                if L - hitoff - hitlen <= self.minK_local:
                    nmm = min(L - t.rdoff - t.ln, mm)
                _, rext = self.extend(t, seq, qual, 0, 1 << 30, nmm)
                ms = max(ms, sink.best)
                if t.score >= ms and rext >= min(
                        self.minK_local, L - hit.ln - hit.rdoff):
                    maxsc = max(maxsc, self._recur(
                        t, t.rdoff - t.trim5, t.ln + t.trim5,
                        seq, qual, minsc, sink, dep + 1))
                elif hitoff + hitlen + self.minK_local < L:
                    jump = self.minK \
                        if hitoff + hitlen + self.minK < L \
                        else self.minK_local
                    exp = hit.score - (hitlen - hit.ln) // jump \
                        * sc.mmp_max - sc.mmp_max
                    if exp >= ms:
                        maxsc = max(maxsc, self._recur(
                            hit, hitoff, hitlen + jump, seq, qual,
                            minsc, sink, dep + 1))
        return maxsc

    # ---- global FM searches inside the recursion -----------------------

    def _global_backward(self, seq, extoff: int):
        """globalGFMSearch (hi_aligner.h:5679): backward search ending at
        extoff, unique-stop at width 1 and len >= minK."""
        fm = self.fm
        ftab_k = fm.meta.ftab_k
        if extoff + 1 < ftab_k + 1:
            return 0, 0, 0, 0, False
        for i in range(ftab_k):
            if seq[extoff - i] > 3:
                return 0, 0, 0, 0, False
        top, bot = fm.ftab_lohi(seq[extoff - ftab_k + 1:extoff + 1])
        if top >= bot:
            return 0, 0, 0, 0, False
        dep = ftab_k
        ustop = False
        while extoff - dep >= 0:
            c = int(seq[extoff - dep])
            if c > 3:
                break
            t2, b2 = fm.lf_range(top, bot, c)
            if t2 >= b2:
                break
            top, bot = t2, b2
            dep += 1
            if bot - top == 1 and dep >= self.minK:
                ustop = True
                break
        if bot - top > self.kseeds:
            return 0, 0, 0, 0, False
        return bot - top, dep, top, bot, ustop

    def _global_join(self, hit, left_piece, extoff, extlen, top, bot,
                     ustop, seq, qual, minsc, sink, dep, left_side):
        """Shared coord loop of the global-search branches."""
        fm = self.fm
        maxsc = NEG
        coords = []
        for row in range(top, bot):
            j = fm.resolve_row(row)
            f = int(np.searchsorted(fm.frag_joined, j, "right")) - 1
            if j + extlen > int(fm.frag_joined[f + 1]):
                continue                    # reject straddled
            tid = int(fm.frag_ref[f])
            toff = int(fm.frag_off[f]) + (j - int(fm.frag_joined[f]))
            coords.append((tid, toff, j))
        coords.sort()
        order = coords[::-1] if left_side else coords
        for tid, toff, j in order:
            t = Hit(hit.fw, extoff + 1 - extlen, extlen, tid, toff, j)
            if left_side:
                if not t.compatible_with(hit, self.spliced,
                                         self.max_intron):
                    continue
                if ustop:
                    self.extend(t, seq, qual, 1 << 30, 0, 0)
                ms = minsc
                combined = self.combine(t, hit, seq, qual, ms)
                newhit = t
            else:
                if not hit.compatible_with(t, self.spliced,
                                           self.max_intron):
                    continue
                self.extend(t, seq, qual, 0, 1 << 30, 0)
                ch = hit.clone()
                ms = minsc
                combined = self.combine(ch, t, seq, qual, ms)
                newhit = ch
            ms = max(ms, sink.best)
            if combined and newhit.score >= ms:
                maxsc = max(maxsc, self._recur(
                    newhit, newhit.rdoff - newhit.trim5,
                    newhit.ln + newhit.trim5 +
                    (newhit.trim3 if left_side else 0),
                    seq, qual, minsc, sink, dep + 1))
        return maxsc

    def _global_left(self, hit, hitoff, seq, qual, minsc, sink, dep):
        extoff = hitoff - 1
        if extoff > 0:
            extoff -= 1
        nelt, extlen, top, bot, ustop = self._global_backward(seq, extoff)
        if not (0 < nelt <= 5 and extlen >= self.minK):
            return NEG
        return self._global_join(hit, None, extoff, extlen, top, bot,
                                 ustop, seq, qual, minsc, sink, dep, True)

    def _global_right(self, hit, hitoff, hitlen, seq, qual, minsc, sink,
                      dep):
        extoff = hitoff + hitlen + self.minK + 1
        if extoff >= len(seq):
            return NEG
        nelt, extlen, top, bot, ustop = self._global_backward(seq, extoff)
        if not (0 < nelt <= 5 and extlen >= self.minK):
            return NEG
        return self._global_join(hit, None, extoff, extlen, top, bot,
                                 ustop, seq, qual, minsc, sink, dep,
                                 False)

    # ---- go()/nextBWT loop (hi_aligner.h:3874) -------------------------

    def align_read(self, codes, quals, L: int, nofw=False, norc=False,
                   rdid: int = None):
        """Run the full per-read search; returns (Sink, minsc)."""
        L = int(L)
        # temp-splice-site visibility: sites discovered by reads with
        # rdid' <= rdid are usable (-p 1 mindist=0 semantics); default
        # sees everything (a late read)
        self._rdid = int(rdid) if rdid is not None else (1 << 62)
        seq_fw = np.asarray(codes[:L], np.int8)
        seq_rc = np.where(seq_fw < 4, 3 - seq_fw, seq_fw)[::-1].copy()
        q = np.asarray(quals[:L], np.int64)
        qual_fw = q
        qual_rc = q[::-1].copy()
        minsc = self.s.min_score(L)
        sink = Sink()
        self._searched = set()
        self.li_atts = 0
        self.li_budget = 1 << 62
        lanes = {True: Lane(L), False: Lane(L)}
        if nofw:
            lanes[True].done = True
        if norc:
            lanes[False].done = True
        found = [True, False]

        while True:
            # pickNextReadToSearch
            pick, best_cs = None, None
            for fw in (True, False):
                ln = lanes[fw]
                if ln.done:
                    continue
                cs = (1 << 62) if ln.cur == 0 \
                    else ln.search_score(self.minK)
                if best_cs is None or cs > best_cs:
                    pick, best_cs = fw, cs
            if pick is None:
                break
            fw = pick
            lane = lanes[fw]
            # nextBWT gates
            best = sink.best
            if best >= minsc:
                maxmm = (-best + self.sc.mmp_max - 1) // self.sc.mmp_max
                if lane.n_actual() > maxmm + 1:
                    lane.done = True
                    break                     # unpaired: search over
            sib = lanes[not fw]
            if sib.done and best < minsc and lane.n_actual() > \
                    sib.n_actual() + (1 if self.anchor_stop else 0):
                lane.done = True
                break
            astop = self._partial_search(
                lane, seq_fw if fw else seq_rc)
            if not lane.done and not astop:
                if lane.cur + 1 < L:
                    lane.cur += 1             # mismatch-skip restart
                continue
            if astop:
                lane.done = True
            # align() this completed lane
            ok = self._align_lane(
                lane, fw, seq_fw if fw else seq_rc,
                qual_fw if fw else qual_rc, minsc, sink)
            found[0] = ok
            if not found[0] and not found[1]:
                break
        return sink, minsc

    def _align_lane(self, lane, fw, seq, qual, minsc, sink) -> bool:
        if lane.min_width() > self.kseeds * 2:
            return False
        best = max(sink.best, minsc)
        maxmm = (-best + self.sc.mmp_max - 1) // self.sc.mmp_max
        if lane.n_actual() > maxmm + 1:
            return True
        anchors = self._get_anchor_hits(lane, fw, seq)
        if not anchors:
            return False
        add = (-minsc // self.sc.mmp_max) * len(anchors)
        self.li_budget = self.li_atts + max(10, add)
        # hybridSearch wrapper: exact extension of all anchors first
        for h in anchors:
            self.extend(h, seq, qual, 1 << 30, 1 << 30, 0)
        done = [False] * len(anchors)
        for _ in range(len(anchors)):
            hj = None
            for i, h in enumerate(anchors):
                if done[i]:
                    continue
                if hj is None or (h.hitcount, h.ln) > \
                        (anchors[hj].hitcount, anchors[hj].ln):
                    hj = i
            if hj is None:
                break
            h = anchors[hj]
            self._recur(h, h.rdoff, h.ln, seq, qual, minsc, sink, 0)
            done[hj] = True
        return True


# ---------------------------------------------------------------------------
# search-side state
# ---------------------------------------------------------------------------

class PartialHit:
    """BWTHit (hi_aligner.h:103): one gapless backward-search segment."""
    __slots__ = ("top", "bot", "bwoff", "ln", "hit_type", "resolved")

    def __init__(self, top, bot, bwoff, ln, hit_type=CANDIDATE_HIT):
        self.top, self.bot = int(top), int(bot)
        self.bwoff, self.ln = int(bwoff), int(ln)
        self.hit_type = hit_type
        self.resolved = False

    @property
    def empty(self):
        return self.bot <= self.top

    @property
    def size(self):
        return max(self.bot - self.top, 0)


class Lane:
    """ReadBWTHit (hi_aligner.h:210): per-orientation search state."""
    __slots__ = ("cur", "done", "n_search", "n_unique", "hits", "L")

    def __init__(self, L):
        self.cur = 0
        self.done = False
        self.n_search = 0
        self.n_unique = 0
        self.hits: list[PartialHit] = []
        self.L = L

    def n_actual(self):
        return self.n_search - self.n_unique

    def search_score(self, minK):
        s = sum(h.ln * h.ln for h in self.hits)
        na = self.n_actual()
        s -= na * minK * minK
        s -= 1 << min(2 * na, 62)
        return s

    def min_width(self):
        w, wl = 1 << 62, 0
        for h in self.hits:
            if h.empty:
                continue
            if h.size < w or (h.size == w and h.ln > wl):
                w, wl = h.size, h.ln
        return w


class Sink:
    """AlnSinkWrap state for one read (aln_sink.h:2404 report)."""

    def __init__(self):
        self.rs: list[Hit] = []       # submission order
        self.best = NEG
        self.best2 = NEG

    def report(self, hit: Hit):
        self.rs.append(hit.clone())
        s = hit.score
        if s > self.best:
            self.best2 = self.best
            self.best = s
        elif s > self.best2:
            self.best2 = s



# ---------------------------------------------------------------------------
# finalize + SAM-field rendering
# ---------------------------------------------------------------------------

def composite_score(h: Hit) -> int:
    """AlnScore::hisat2_score (aligner_result.h:315): raw score in the
    high bits, 65535 - trimmed chars in the low 16 — selection and the
    -k truncation compare THIS, so an equal-raw-score soft-clipped twin
    ranks strictly below the untrimmed form (it still feeds ZS)."""
    return (h.score << 16) | (65535 - h.trim5 - h.trim3)


def finalize(sink: Sink, seed: int, khits: int, secondary: bool = False):
    """finishRead unpaired selection (aln_sink.h:2069 + selectByScore
    2500-2566) over the TRUE submission order: returns (selected Hits,
    nh, zs)."""
    from .rng import RandomSource, select_by_score
    scores = [composite_score(h) for h in sink.rs]
    order = select_by_score(scores, list(range(len(scores))),
                            RandomSource(seed))
    sel = order[:min(khits, len(order))]
    if sel and not secondary:
        best = scores[sel[0]]
        for i in range(1, len(sel)):
            if scores[sel[i]] != best:
                sel = sel[:i]
                break
    zs = sink.best2 if sink.best2 > NEG else None
    return [sink.rs[i] for i in sel], len(sel), zs


def render_fields(hit: Hit):
    """(pos1, cigar, MD, AS, XM, XO, XG, NM) for a reported Hit
    (sam.h field semantics; forgiven-SNV columns render as MD matches
    and are excluded from XM/NM, like the reference's snpID edits)."""
    dels: dict[int, list[int]] = {}
    spls: dict[int, int] = {}
    ins_pos = set()
    mms = {}
    for e in hit.edits:
        if e.typ == RDGAP:
            dels.setdefault(e.pos, []).append(e.rf)
        elif e.typ == RFGAP:
            ins_pos.add(e.pos)
        elif e.typ == SPL:
            spls[e.pos] = e.splen
        else:
            mms[e.pos] = e
    ops = []
    if hit.trim5:
        ops.append((hit.trim5, "S"))
    run, run_op = 0, None
    for p in range(hit.ln):
        if p in spls:
            if run:
                ops.append((run, run_op))
                run, run_op = 0, None
            ops.append((spls[p], "N"))
        if p in dels:
            if run:
                ops.append((run, run_op))
                run, run_op = 0, None
            ops.append((len(dels[p]), "D"))
        op = "I" if p in ins_pos else "M"
        if op == run_op:
            run += 1
        else:
            if run:
                ops.append((run, run_op))
            run, run_op = 1, op
    if run:
        ops.append((run, run_op))
    if hit.ln in dels:
        ops.append((len(dels[hit.ln]), "D"))
    if hit.trim3:
        ops.append((hit.trim3, "S"))
    cigar = "".join(f"{n}{o}" for n, o in ops)
    md, match = [], 0
    ACGT = "ACGTN"
    for p in range(hit.ln + 1):
        if p in dels:
            md.append(str(match))
            match = 0
            md.append("^" + "".join(ACGT[c] for c in dels[p]))
        if p >= hit.ln:
            break
        if p in ins_pos:
            continue
        e = mms.get(p)
        if e is not None and e.snp < 0:
            md.append(str(match))
            match = 0
            md.append(ACGT[e.rf])
        else:
            match += 1
    md.append(str(match))
    xm = sum(1 for e in hit.edits if e.typ == MM and e.snp < 0)
    xo = xg = 0
    prev = None
    for e in hit.edits:
        if e.typ == RDGAP:
            if not (prev and prev.typ == RDGAP and prev.pos == e.pos):
                xo += 1
            if e.snp < 0:
                xg += 1
        elif e.typ == RFGAP:
            if not (prev and prev.typ == RFGAP and prev.pos + 1 == e.pos):
                xo += 1
            if e.snp < 0:
                xg += 1
        prev = e
    return (hit.toff + 1, cigar, "".join(md), hit.score, xm, xo, xg,
            xm + xg)

# ---------------------------------------------------------------------------
# pipeline integration: substitute search-path-sensitive reads
# ---------------------------------------------------------------------------

def _hit_junctions(hit: Hit):
    """Group a Hit's gap/splice edits into pipeline junction descriptors:
    [(x_abs, kind, ref_len, dir, known)] with x = read offset of the
    split point (KIND_SPL/KIND_DEL: right segment start; KIND_INS:
    insertion start)."""
    juncs = []
    i = 0
    es = hit.edits
    while i < len(es):
        e = es[i]
        if e.typ == SPL:
            juncs.append((hit.rdoff + e.pos, 1, e.splen, e.sdir,
                          e.known))
            i += 1
        elif e.typ == RDGAP:
            k = 1
            while i + k < len(es) and es[i + k].typ == RDGAP \
                    and es[i + k].pos == e.pos:
                k += 1
            juncs.append((hit.rdoff + e.pos, 2, k, 0, False))
            i += k
        elif e.typ == RFGAP:
            k = 1
            while i + k < len(es) and es[i + k].typ == RFGAP \
                    and es[i + k].pos == e.pos + k:
                k += 1
            juncs.append((hit.rdoff + e.pos, 3, -k, 0, False))
            i += k
        else:
            i += 1
    return juncs


def hit_to_alignment(hit: Hit, read_idx: int, L: int, nh: int,
                     secondary: bool, zs, mapq: int):
    """Convert an emulator Hit to the pipeline's Alignment dataclass
    (up to 3 gap junctions; caller pre-checks the junction count)."""
    from .host import Alignment
    juncs = _hit_junctions(hit)
    jp = hit.joined - hit.rdoff
    n_del = sum(j[2] for j in juncs if j[1] in (1, 2))   # N + D skips
    n_ins = sum(-j[2] for j in juncs if j[1] == 3)
    kw = {}
    diag = jp
    for n, (x, kind, ln, jdir, known) in enumerate(juncs):
        diag += ln
        pfx = ("junc_", "junc2_", "junc3_")[n]
        kw[pfx + "kind"] = kind
        kw[pfx + "x"] = x
        kw[pfx + "len"] = ln
        kw[pfx + ("d2" if n == 0 else ("d3" if n == 1 else "d4"))] = diag
        kw["spl_dir" if n == 0 else pfx + "dir"] = jdir
        if n == 0:
            kw["junc_known"] = known
    n_mm = sum(1 for e in hit.edits if e.typ == MM and e.snp < 0
               and e.rd < 4 and e.rf < 4)
    n_n = sum(1 for e in hit.edits if e.typ == MM
              and (e.rd > 3 or e.rf > 3))
    return Alignment(
        read_idx=read_idx, rc=not hit.fw, ref_id=hit.tidx,
        ref_pos=hit.toff, joined_pos=jp, clip_l=hit.trim5,
        clip_r=hit.trim3, aln_span=(L - hit.trim5 - hit.trim3
                                    + n_del - n_ins),
        score=hit.score, n_mm=n_mm, n_n=n_n, mapq=mapq, nh=nh,
        secondary=secondary, zs=zs, **kw)


def substitute_batch(aligner, res, codes, quals, lens, seeds,
                     secondary: bool = False, exact: bool = False,
                     rdids=None):
    """Replace search-path-sensitive reads' results with the per-read
    hybridSearch replay (unpaired mode; DNA and spliced).

    Default scope = the batched sweeps' known divergence surface: a
    NOVEL gap or splice join in any kept candidate (join-vs-clip and
    record-set choices are path-dependent), a soft clip >= 5
    (local-search ZS band), a multimap pool containing a novel join, or
    no alignment at all (budgeted give-ups the sweeps over/under-run).
    `exact` widens the scope to EVERY imperfect read (any
    edit/clip/junction/multimap) — full byte-parity mode
    (--exact-replay), at per-read host cost.
    Out of scope entirely (returns {}): -a, sharded indexes,
    --nofw/--norc, and spliced runs over an index with baked-in splice
    ALTs (--ss at build time) — the replay does not model ALT-splice
    extension; the device path covers those.
    Returns {read_idx: [Alignment...]} and patches res.raw in place so
    the vectorized SAM renderer and metrics see the substituted rows."""
    from .mapq import mapq_selected
    from .host import RAW_COLS
    if aligner.all_hits or len(aligner.shards) != 1 \
            or aligner.no_fw or aligner.no_rc:
        return {}
    if aligner.spliced and aligner.variants is not None \
            and len(aligner.variants.ss_ref):
        return {}
    raw = res.raw
    B = res.n_reads
    ci = {nm: i for i, nm in enumerate(RAW_COLS)}
    if raw is not None and len(raw["cols"][0]):
        cols = [np.asarray(c) for c in raw["cols"]]
        rd = cols[ci["read"]]
        jk1, jk2, jk3 = (cols[ci["junc_kind"]], cols[ci["junc2_kind"]],
                         cols[ci["junc3_kind"]])
        known = cols[ci["junc_known"]].astype(bool) \
            | (cols[ci["junc_snp"]] >= 0)
        gap = np.isin(jk1, (2, 3)) | np.isin(jk2, (2, 3)) \
            | np.isin(jk3, (2, 3))
        spl = (jk1 == 1) | (jk2 == 1) | (jk3 == 1)
        novel = (gap | spl) & ~known if aligner.spliced \
            else (gap & ~known)
        risky_rows = novel \
            | (cols[ci["clip_l"]] >= 5) | (cols[ci["clip_r"]] >= 5)
        if exact:
            risky_rows |= (cols[ci["clip_l"]] > 0) \
                | (cols[ci["clip_r"]] > 0) | (cols[ci["n_mm"]] > 0) \
                | (cols[ci["has_sec"]] > 0) \
                | (spl if aligner.spliced else np.zeros(len(rd), bool))
        risk = np.zeros(B, bool)
        np.logical_or.at(risk, rd[risky_rows], True)
        # multimap pools: order/record-set divergence needs a novel join
        # in the pool (or any pool, under exact)
        pool = np.bincount(rd, minlength=B)
        hasgap = np.zeros(B, bool)
        np.logical_or.at(hasgap, rd[novel], True)
        risk |= (pool >= 2) & (hasgap if not exact
                               else np.ones(B, bool))
        # forms outside the replay's model keep the device result: for
        # DNA, known-ALT joins and spliced forms; for spliced runs,
        # known-ALT indel injections
        if aligner.spliced:
            out_model = (cols[ci["junc_snp"]] >= 0) \
                | (gap & cols[ci["junc_known"]].astype(bool))
        else:
            out_model = known | spl
        block = np.zeros(B, bool)
        np.logical_or.at(block, rd[out_model], True)
        aligned = np.zeros(B, bool)
        aligned[rd] = True
        risk = (risk | ~aligned) & ~block
    else:
        cols = None
        risk = np.ones(B, bool)
    idxs = np.flatnonzero(risk)
    if not idxs.size:
        return {}
    hy = getattr(aligner, "_hybrid", None)
    if hy is None:
        hy = HybridAligner(aligner.shards[0], variants=aligner.variants,
                           scoring=aligner.scoring, k=aligner.k,
                           anchor_stop=aligner.anchor_stop,
                           spliced=aligner.spliced,
                           splice_db=aligner.splice_db,
                           secondary=secondary)
        aligner._hybrid = hy
    overrides = {}
    minsc_v = np.zeros(len(idxs), np.int64)
    for t, i in enumerate(idxs):
        L = int(lens[i])
        q_ascii = np.asarray(quals[i, :L], np.int64) + 33
        sink, minsc = hy.align_read(
            codes[i, :L], q_ascii, L,
            rdid=int(rdids[i]) if rdids is not None else None)
        minsc_v[t] = minsc
        hits, nh, zs = finalize(sink, int(seeds[i]), aligner.k,
                                secondary=secondary)
        if any(len(_hit_junctions(h)) > 3 for h in hits):
            continue            # beyond the Alignment junction arity
        if not hits:
            overrides[i] = []
            continue
        best = hits[0].score
        # MAPQ's secbest is the SELECTED set's runner-up (equal-best
        # multimaps only, post-truncation); ZS separately reports the
        # best unselected submission (sink best2)
        sec = hits[1].score if nh >= 2 else 0
        mq = int(mapq_selected([best], [sec], [nh >= 2], [0], [minsc])[0])
        overrides[i] = [
            hit_to_alignment(h, int(i), L, nh, n > 0, zs, mq)
            for n, h in enumerate(hits)]
    if not overrides:
        return {}
    # patch res.raw: drop substituted reads' rows, splice in new ones
    new_rows = []
    for i, alns in overrides.items():
        for a in alns:
            new_rows.append((
                a.read_idx, int(a.rc), a.ref_id, a.ref_pos, a.joined_pos,
                a.clip_l, a.clip_r, a.aln_span, a.score, a.n_mm, a.n_n,
                a.mapq, a.nh, int(a.secondary), int(a.zs is not None),
                a.zs if a.zs is not None else 0,
                a.junc_kind, a.junc_x, a.junc_len, a.junc_d2, a.spl_dir,
                int(a.junc_known), a.junc_snp,
                a.junc2_kind, a.junc2_x, a.junc2_len, a.junc2_d3,
                a.junc2_dir,
                a.junc3_kind, a.junc3_x, a.junc3_len, a.junc3_d4,
                a.junc3_dir))
    over = np.zeros(B, bool)
    over[list(overrides)] = True
    if cols is not None:
        keep = ~over[cols[ci["read"]]]
        kept = [c[keep] for c in cols]
    else:
        kept = [np.zeros(0, np.int64) for _ in RAW_COLS]
    if new_rows:
        nr = np.asarray(new_rows, np.int64).T
        merged = [np.concatenate([k, n]) for k, n in zip(kept, nr)]
    else:
        merged = kept
    order = np.argsort(merged[0], kind="stable")
    res.raw = {"cols": [c[order] for c in merged]}
    res._alignments = None
    return overrides

def partial_rounds(hy: HybridAligner, seq) -> list[tuple[int, int]]:
    """Exact per-round (segment length, unique-search flag) log for one
    orientation — nextBWT's loop over partialSearch with the mismatch
    skip (hi_aligner.h:4060-4070).  The interleaved-search replay
    (align/replay.py) consumes these; the device's event-stream logs
    carry rare one-off length deltas that flip its scheduling on
    gate-threshold pairs, so at-risk pairs re-derive the logs here."""
    L = len(seq)
    lane = Lane(L)
    out = []
    while not lane.done:
        nu = lane.n_unique
        astop = hy._partial_search(lane, seq)
        h = lane.hits[-1]
        out.append((h.ln, 1 if lane.n_unique > nu else 0))
        if astop:
            lane.done = True
        if lane.done:
            break
        if lane.cur + 1 < L:
            lane.cur += 1
    return out
