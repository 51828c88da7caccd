"""STR (CODIS) locus conversion: repeat-structure specs -> allele MSA.

Behavioral equivalent of the reference's CODIS converter
(hisat2's hisatgenotype_modules/hisatgenotype_convert_codis.py):
forensic STR alleles are published as repeat structures
(`[TTTC]3TTTTTTCT[CTTT]14CTCC[TTCC]2`, NIST STRBase notation); typing
needs them as a multiple sequence alignment over a shared backbone so
the variant-set machinery (genotype/msa.py, genotype/vars.py) applies.

Design: an allele is a list of segments (repeat unit, copy count).  The
locus backbone is built by folding every allele into a running backbone
with a segment-level alignment (unit-set match scores 0, two
single-copy literal segments substitute at -1, anything else -2, gap
-1 — the segment-DP semantics the reference uses); each allele then
renders against the backbone as a gap-padded row, repeats
left-justified within their backbone slot.  Flanking genomic sequence
is prepended/appended verbatim to every row.

Spec file format (tab-separated): `locus<TAB>allele_id<TAB>structure`;
optional flank records come from a plain FASTA keyed `<locus>_left` /
`<locus>_right`.

Copied verbatim from hisat2_tpu/genotype/strloci.py; only the imports,
and the location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Segment:
    units: frozenset            # alternative repeat units at this slot
    counts: set = field(default_factory=set)   # copy counts seen

    @property
    def unit(self) -> str:      # longest unit (backbone rendering)
        return max(self.units, key=len)

    @property
    def max_count(self) -> int:
        return max(self.counts)


def parse_structure(s: str):
    """`[TTTC]3TTTTTTCT[CTTT]14` -> [Segment({TTTC},{3}), ...].

    Literal runs (no brackets) are single-copy segments."""
    segs = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c == " ":
            i += 1
            continue
        if c == "[":
            j = s.index("]", i)
            unit = s[i + 1:j]
            i = j + 1
            k = i
            while k < n and s[k].isdigit():
                k += 1
            cnt = int(s[i:k])
            i = k
            if not unit or cnt <= 0:
                raise ValueError(f"bad repeat block in {s!r}")
            segs.append(Segment(frozenset([unit]), {cnt}))
        else:
            k = i
            while k < n and s[k] in "ACGT":
                k += 1
            if k == i:
                raise ValueError(f"bad char {c!r} in {s!r}")
            segs.append(Segment(frozenset([s[i:k]]), {1}))
            i = k
    return segs


def expand(segs) -> str:
    """Concrete sequence of a parsed allele (single unit/count each)."""
    out = []
    for g in segs:
        (u,) = g.units
        (c,) = g.counts
        out.append(u * c)
    return "".join(out)


def _sub_score(a: Segment, b: Segment) -> int:
    """get_equal_score (convert_codis.py:207-214): unit-set equality 0,
    two single-copy literals -1, else -2."""
    if a.units == b.units:
        return 0
    if a.counts == b.counts == {1}:
        return -1
    return -2


def _dp_table(bb, al):
    """The reference's segment DP (convert_codis.py SW_alignment:
    first row/column accumulate gap -1 from [0][0] with no free start;
    a[0][0] is 0 on unit equality else -1)."""
    n, m = len(bb), len(al)
    a = [[0] * m for _ in range(n)]
    for i in range(n):
        for j in range(m):
            if i == 0:
                if j == 0:
                    a[0][0] = 0 if bb[0].units == al[0].units else -1
                else:
                    a[0][j] = a[0][j - 1] - 1
            elif j == 0:
                a[i][0] = a[i - 1][0] - 1
            else:
                a[i][j] = max(a[i - 1][j] - 1, a[i][j - 1] - 1,
                              a[i - 1][j - 1] + _sub_score(bb[i], al[j]))
    return a


def _fold(bb, al):
    """combine_alleles (convert_codis.py:249-300): backtrack prefers
    backbone-gap, then allele-gap, then diagonal; merges unit/count
    sets on the diagonal."""
    a = _dp_table(bb, al)
    out = []
    i, j = len(bb) - 1, len(al) - 1
    while i >= 0 and j >= 0:
        g, h = bb[i], al[j]
        if i == 0:
            if j == 0:
                if g.units == h.units:
                    out.append(Segment(g.units, g.counts | h.counts))
                else:
                    out.append(Segment(g.units | h.units,
                                       g.counts | h.counts))
            else:
                out.append(Segment(h.units, set(h.counts) | {0}))
            j -= 1
        elif j == 0:
            out.append(Segment(g.units, g.counts | {0}))
            i -= 1
        else:
            if a[i - 1][j] - 1 == a[i][j]:
                out.append(Segment(g.units, g.counts | {0}))
                i -= 1
            elif a[i][j - 1] - 1 == a[i][j]:
                out.append(Segment(h.units, set(h.counts) | {0}))
                j -= 1
            else:
                if g.units == h.units:
                    out.append(Segment(g.units, g.counts | h.counts))
                else:
                    out.append(Segment(g.units | h.units,
                                       g.counts | h.counts))
                i -= 1
                j -= 1
    return out[::-1]


def build_backbone(alleles):
    """Fold order per the reference (convert_codis.py:520-527): start
    from the LAST allele, fold the rest in reverse."""
    bb = [Segment(g.units, set(g.counts)) for g in alleles[-1]]
    for al in reversed(alleles[:-1]):
        bb = _fold(bb, al)
    return bb


def render_row(bb, al) -> str:
    """Gap-padded ('.') MSA row (msf_alignment, convert_codis.py:
    303-362): same DP/backtrack; matched slots render the BACKBONE's
    longest unit repeated the allele's count, left-justified."""
    a = _dp_table(bb, al)
    out = []
    i, j = len(bb) - 1, len(al) - 1
    while i >= 0 and j >= 0:
        g, h = bb[i], al[j]
        gi = g.unit
        gn = g.max_count
        (hj,) = h.units
        (hn,) = h.counts
        if i == 0:
            if j != 0:
                raise ValueError("allele segment outside backbone")
            if g.units == h.units:
                out.append(gi * hn + "." * (len(gi) * (gn - hn)))
            else:
                out.append(hj + "." * (len(gi) - len(hj)))
            j -= 1
            i -= 1
        elif j == 0:
            out.append("." * (len(gi) * gn))
            i -= 1
        else:
            if a[i - 1][j] - 1 == a[i][j]:
                out.append("." * (len(gi) * gn))
                i -= 1
            elif a[i][j - 1] - 1 == a[i][j]:
                raise ValueError("allele overflows backbone slot")
            else:
                if g.units == h.units:
                    out.append(gi * hn + "." * (len(gi) * (gn - hn)))
                else:
                    out.append(hj + "." * (len(gi) - len(hj)))
                i -= 1
                j -= 1
    while i >= 0:
        out.append("." * (len(bb[i].unit) * bb[i].max_count))
        i -= 1
    return "".join(out[::-1])


def convert_str_locus(records, left_flank: str = "",
                      right_flank: str = ""):
    """records = [(allele_id, structure_string)] -> (names, rows,
    backbone_name) as an aligned-FASTA-style MSA (gap '-'), flanks
    included, duplicate-sequence alleles dropped (first id wins)."""
    parsed, seen = [], {}
    for aid, st in records:
        segs = parse_structure(st)
        seq = expand(segs)
        if seq in seen:
            continue
        seen[seq] = aid
        parsed.append((aid, segs))
    bb = build_backbone([segs for _, segs in parsed])
    names, rows = [], []
    for aid, segs in parsed:
        row = render_row(bb, segs).replace(".", "-")
        names.append(aid)
        rows.append(left_flank + row + right_flank)
    return names, rows


def main_convert(argv=None):
    import argparse
    import sys
    p = argparse.ArgumentParser(prog="hisat2-tpu genotype convert-str")
    p.add_argument("spec", help="TSV: locus<TAB>allele<TAB>structure")
    p.add_argument("-o", "--out", default="str_msa",
                   help="output basename; writes <out>.<locus>.msa.fa")
    p.add_argument("--flanks", default=None,
                   help="FASTA of <locus>_left / <locus>_right flanks")
    args = p.parse_args(argv)
    flanks = {}
    if args.flanks:
        name, seq = None, []
        for line in open(args.flanks):
            if line.startswith(">"):
                if name:
                    flanks[name] = "".join(seq)
                name, seq = line[1:].split()[0], []
            else:
                seq.append(line.strip())
        if name:
            flanks[name] = "".join(seq)
    by_locus = {}
    for line in open(args.spec):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        locus, aid, st = line.split("\t")
        by_locus.setdefault(locus, []).append((aid, st))
    for locus, recs in by_locus.items():
        names, rows = convert_str_locus(
            recs, flanks.get(locus + "_left", ""),
            flanks.get(locus + "_right", ""))
        path = f"{args.out}.{locus}.msa.fa"
        with open(path, "w") as f:
            for nm, row in zip(names, rows):
                f.write(f">{locus}*{nm}\n{row}\n")
        print(f"[convert-str] {locus}: {len(names)} alleles -> {path}",
              file=sys.stderr)
    return 0
