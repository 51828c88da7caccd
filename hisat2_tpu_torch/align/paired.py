"""Paired-end policy + pair assembly (reference: hisat2's pe.{h,cpp}
PairedEndPolicy, and HI_Aligner::pairReads, hi_aligner.h:3905-3955).

Given per-mate candidate alignments (already scored), classify pairs:
  concordant (CP): orientations match --fr/--rf/--ff, fragment length within
                   [minins, maxins], same reference
  discordant (DP): both mates align uniquely but violate constraints
  mixed (UP):      mates reported separately

Copied verbatim from hisat2_tpu/align/paired.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PairPolicy:
    minins: int = 0          # -I (hisat2.cpp:332)
    maxins: int = 500        # -X (hisat2.cpp:333)
    orient: str = "fr"       # --fr/--rf/--ff
    no_mixed: bool = False
    no_discordant: bool = False
    # RNA mode pairs WITHOUT the insert-size policy: any correctly
    # oriented colinear pair whose inner gap fits maxIntronLen is
    # concordant (pairReads, hi_aligner.h:5090-5105: the
    # PairedEndPolicy/-I/-X check runs only under no_spliced_alignment)
    spliced: bool = False
    max_intron: int = 500000
    tlen_adjust: bool = True   # --no-templatelen-adjustment disables
    # mate-geometry rules (pe.cpp:97-137): overlap/containment allowed by
    # default, dovetailing not (--dovetail / --no-contain / --no-overlap)
    dovetail_ok: bool = False
    contain_ok: bool = True
    overlap_ok: bool = True

    def concordant(self, a1, a2, len1: int, len2: int, intron_fn=None,
                   rdid: int = 0):
        """a1, a2: Alignment (mate1, mate2).  Returns (ok, tlen1) where
        tlen1/tlen2 are the signed TLENs per mate.

        Template length follows AlnRes::setFragmentLength
        (aligner_result.h:1601-1650): per-mate extents include trimmed
        bases; a spliced mate contributes its RIGHT-anchored non-intron
        window (so its own intron falls out geometrically); when the inner
        gap between mates exceeds 100 bp, the largest known/temp splice
        site strictly inside the fragment is subtracted (the reference's
        template-length adjustment, on by default)."""
        if a1.ref_id != a2.ref_id:
            return False, 0, 0
        p1, p2 = a1.joined_pos, a2.joined_pos

        def coords(a, ln):
            # extended coords: st/en left-anchored, st2/en2 right-anchored
            # windows of the non-intron extent
            jl1 = a.junc_len if a.junc_kind else 0
            jl2 = a.junc2_len if a.junc2_kind else 0
            x = ln + (jl1 if a.junc_kind in (2, 3) else 0) \
                + (jl2 if a.junc2_kind in (2, 3) else 0)
            right = a.joined_pos + ln + jl1 + jl2 - 1
            return (a.joined_pos, a.joined_pos + x - 1,
                    right - x + 1, right)

        st, en, st2, en2 = coords(a1, len1)
        ost, oen, ost2, oen2 = coords(a2, len2)
        # imUpstream tie is STRICT (setFragmentLength,
        # aligner_result.h:1610): equal extents -> mate1 is downstream
        left_is_1 = (st < ost) or (st == ost and en2 < oen2)
        if self.spliced:
            if self.orient == "fr":
                ok = ((not a1.rc) and a2.rc) if left_is_1 \
                    else ((not a2.rc) and a1.rc)
            elif self.orient == "rf":
                ok = (a1.rc and not a2.rc) if left_is_1 \
                    else (a2.rc and not a1.rc)
            else:
                ok = (not a1.rc) and (not a2.rc) and left_is_1
            if not ok:
                return False, 0, 0
        else:
            # DNA mode: the pairReads colinear pre-check
            # (hi_aligner.h:4480-4491) + peClassifyPair (pe.cpp:40-137)
            m1fw, m2fw = {"fr": (True, False), "rf": (False, True),
                          "ff": (True, True)}[self.orient]
            aln1 = (a1.aln_start, a1.aln_start + a1.aln_span - 1)
            aln2 = (a2.aln_start, a2.aln_start + a2.aln_span - 1)
            if (not a1.rc) == m1fw:
                if (not a2.rc) != m2fw:
                    return False, 0, 0
                Lc, Rc, Lc2, Rc2 = aln1[0], aln1[1], aln2[0], aln2[1]
            else:
                if (not a2.rc) == m2fw:
                    return False, 0, 0
                Lc, Rc, Lc2, Rc2 = aln2[0], aln2[1], aln1[0], aln1[1]
            if Lc > Lc2 or Rc > Rc2:
                return False, 0, 0
            if Rc + self.max_intron < Lc2:
                return False, 0, 0
            # peClassifyPair on (refoff, refExtent)-sorted mates; ties
            # swap (strict < in pairReads, hi_aligner.h:4497)
            if a1.aln_start < a2.aln_start:
                (lo1, hi1), fw1 = aln1, not a1.rc
                (lo2, hi2), fw2 = aln2, not a2.rc
            else:
                (lo1, hi1), fw1 = aln2, not a2.rc
                (lo2, hi2), fw2 = aln1, not a1.rc
            if self.orient in ("fr", "rf"):
                if fw1 == fw2:
                    return False, 0, 0
                one_left = fw1 if self.orient == "fr" else not fw1
            else:
                if fw1 != fw2:
                    return False, 0, 0
                one_left = fw1
            fragc = max(hi1, hi2) + 1 - min(lo1, lo2)
            if fragc > self.maxins or fragc < self.minins:
                return False, 0, 0
            containment = (lo1 >= lo2 and hi1 <= hi2) or \
                          (lo2 >= lo1 and hi2 <= hi1)
            olap = ((lo1 <= lo2 <= hi1) or (lo1 <= hi2 <= hi1)
                    or containment)
            if olap and not self.overlap_ok:
                return False, 0, 0
            if not olap:
                if (one_left and lo2 < lo1) or \
                        (not one_left and lo1 < lo2):
                    return False, 0, 0
            if containment and not self.contain_ok:
                return False, 0, 0
            if (one_left and (hi1 > hi2 or lo2 < lo1)) or \
                    (not one_left and (hi2 > hi1 or lo1 < lo2)):
                if not self.dovetail_ok:
                    return False, 0, 0
        if left_is_1:
            up, up_right = min(st2, ost), min(en2, oen)
            dn_left, dn = max(st2, ost), max(en2, oen)
        else:
            up, up_right = min(st, ost2), min(en, oen2)
            dn_left, dn = max(st, ost2), max(en, oen2)
        intron = 0
        if intron_fn is not None and up_right + 100 < dn_left:
            intron = intron_fn(a1.ref_id, up, dn, rdid)
        frag = 1 + dn - up - intron
        if self.spliced:
            # colinear + gap within maxIntronLen; no -I/-X check
            if dn_left > up_right + 1 + self.max_intron:
                return False, 0, 0
        tlen1 = frag if left_is_1 else -frag
        # the tie rule is PER-MATE (strict <): at identical extents both
        # mates classify as downstream and both print -frag
        left_is_2 = (ost < st) or (ost == st and oen2 < en2)
        tlen2 = frag if left_is_2 else -frag
        return True, tlen1, tlen2


def best_pairs(cands1, cands2, len1, len2, policy: PairPolicy, k: int,
               intron_fn=None, rdid: int = 0):
    """Cross candidate lists (small, <= k each) -> sorted concordant pairs.

    Returns list of (a1, a2, tlen1, tlen2) sorted by pair score desc,
    position."""
    out = []
    for a1 in cands1:
        for a2 in cands2:
            ok, tlen1, tlen2 = policy.concordant(a1, a2, len1, len2,
                                                 intron_fn, rdid)
            if ok:
                out.append((a1, a2, tlen1, tlen2))
    out.sort(key=lambda t: (-(t[0].score + t[1].score),
                            t[0].joined_pos, t[1].joined_pos))
    return out[:k]
