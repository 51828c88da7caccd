"""CYP allele-variant tables -> allele MSA.

Behavioral equivalent of the reference's CYP extraction
(hisat2's hisatgenotype_modules/hisatgenotype_extract_cyp_data.py
makeVarDict/makeMSF): pharmacogene star-alleles are published as
variant lists against a gene reference sequence
(`-1584C>G; 100C>T; 1023_1024delAG; 1661_1662insA`), numbered in gene
coordinates with a discontinuity at zero (…-2,-1,+1,+2…; upstream and
coding positions carry separate offsets into the reference FASTA).
Typing needs a gap-padded MSA over an insertion-augmented backbone.

The zero-egress port: the reference scrapes cypalleles.ki.se at run
time; here the variant table is a plain text input (`allele<TAB>v1;
v2; ...`), which is also exactly what the reference's downloader writes
to cyp_var_files/.

Copied verbatim from hisat2_tpu/genotype/cypvar.py; only the imports,
and the location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import re

_SNV = re.compile(r"^(-?\d+)([ACGT])>([ACGT])$")
_DEL = re.compile(r"^(-?\d+)(?:_(-?\d+))?del([ACGT]+)$")
_INS = re.compile(r"^(-?\d+)(?:_(-?\d+))?ins([ACGT]+)$")


def parse_var(tok: str):
    """One variant token -> ('S', pos, ref, alt) | ('D', pos, seq) |
    ('I', pos, seq) | None, positions in gene numbering."""
    tok = tok.strip()
    if not tok or tok == "None":
        return None
    m = _SNV.match(tok)
    if m:
        return ("S", int(m.group(1)), m.group(2), m.group(3))
    m = _DEL.match(tok)
    if m:
        lo = int(m.group(1))
        seq = m.group(3)
        if m.group(2) is not None:
            hi = int(m.group(2))
            span = hi - lo + (1 if (lo < 0) == (hi < 0) else 0)
            if span != len(seq):
                raise ValueError(f"deletion span mismatch: {tok}")
        return ("D", lo, seq)
    m = _INS.match(tok)
    if m:
        # `a_b insXX` inserts between a and b; build_msa's convention is
        # insert-BEFORE-index, so the position is b (the second
        # coordinate).  The reference's makeIns inserts after index(a),
        # i.e. the same between-a-and-b slot
        # (hisatgenotype_extract_cyp_data.py makeMSF).  Gene numbering
        # has no zero: after -1 comes +1.
        if m.group(2) is not None:
            pos = int(m.group(2))
        else:
            a = int(m.group(1))
            pos = 1 if a == -1 else a + 1
        return ("I", pos, m.group(3))
    raise ValueError(f"unrecognized variant notation: {tok!r}")


def parse_var_table(path_or_lines):
    """allele<TAB>v1; v2; ... -> {allele: [parsed vars]}."""
    lines = (open(path_or_lines) if isinstance(path_or_lines, str)
             else path_or_lines)
    table = {}
    for line in lines:
        line = line.rstrip("\n")
        if not line or line.startswith("#"):
            continue
        allele, _, rest = line.partition("\t")
        out = []
        # the reference's .var tables separate variants with ','
        # (makeVarDict, hisatgenotype_extract_cyp_data.py:319-350);
        # ';' accepted as well
        for tok in rest.replace(";", ",").split(","):
            v = parse_var(tok)
            if v is not None:
                out.append(v)
        table[allele.strip()] = out
    return table


def gene_pos_to_index(pos: int, offset_pos: int, offset_neg: int) -> int:
    """Gene numbering (no zero; negatives upstream) -> string index."""
    return pos + (offset_pos if pos > 0 else offset_neg)


def build_msa(ref_seq: str, var_table: dict, offset_pos: int,
              offset_neg: int, ref_name: str = "REF"):
    """-> (names, rows): insertion-augmented, '-'-gapped MSA rows.

    Backbone columns: every reference base, plus after each insertion
    point the LONGEST insertion seen there (the reference's longestIns
    augmentation, hisatgenotype_extract_cyp_data.py:399-440)."""
    longest_ins = {}
    parsed = {}
    for allele, vs in var_table.items():
        ops = []
        for v in vs:
            if v[0] == "I":
                idx = gene_pos_to_index(v[1], offset_pos, offset_neg)
                longest_ins[idx] = max(longest_ins.get(idx, 0),
                                       len(v[2]))
                ops.append(("I", idx, v[2]))
            elif v[0] == "S":
                idx = gene_pos_to_index(v[1], offset_pos, offset_neg)
                if not (0 <= idx < len(ref_seq)):
                    raise ValueError(f"SNV outside reference: {v}")
                if ref_seq[idx] != v[2]:
                    raise ValueError(
                        f"reference base mismatch at {v[1]}: "
                        f"expected {v[2]}, have {ref_seq[idx]}")
                ops.append(("S", idx, v[3]))
            else:
                idx = gene_pos_to_index(v[1], offset_pos, offset_neg)
                if ref_seq[idx:idx + len(v[2])] != v[2]:
                    raise ValueError(
                        f"deleted bases mismatch at {v[1]}: {v}")
                ops.append(("D", idx, len(v[2])))
        parsed[allele] = ops

    # column layout: ref index i occupies one column + ins_w[i] extra
    # insertion columns AFTER it (insertion "at i" = between i-1 and i
    # per a_b insXX numbering -> extra columns after index i-1)
    n = len(ref_seq)
    ins_after = [0] * (n + 1)
    for idx, w in longest_ins.items():
        ins_after[max(idx, 0)] = w
    col_of = [0] * (n + 1)
    c = ins_after[0]
    for i in range(n):
        col_of[i] = c
        c += 1 + ins_after[i + 1]
    total = c
    names, rows = [], []
    bb = ["-"] * total
    for i, ch in enumerate(ref_seq):
        bb[col_of[i]] = ch
    names.append(ref_name)
    rows.append("".join(bb))
    for allele, ops in parsed.items():
        row = list(rows[0])
        for op in ops:
            if op[0] == "S":
                row[col_of[op[1]]] = op[2]
            elif op[0] == "D":
                for k in range(op[1], op[1] + op[2]):
                    row[col_of[k]] = "-"
            else:
                idx, seq = op[1], op[2]
                base = col_of[idx - 1] + 1 if idx > 0 else 0
                for k, ch in enumerate(seq):
                    row[base + k] = ch
        names.append(allele)
        rows.append("".join(row))
    return names, rows


def main_extract(argv=None):
    import argparse
    import sys
    p = argparse.ArgumentParser(prog="hisat2-tpu genotype extract-cyp")
    p.add_argument("var_file", help="allele<TAB>v1; v2; ... table")
    p.add_argument("fasta", help="gene reference FASTA (one record)")
    p.add_argument("-o", "--out", default="cyp.msa.fa")
    p.add_argument("--offset-pos", type=int, required=True,
                   help="string index of gene position +1, minus 1")
    p.add_argument("--offset-neg", type=int, required=True,
                   help="string index of gene position -1, plus 1")
    p.add_argument("--gene", default="CYP")
    args = p.parse_args(argv)
    seq = []
    for line in open(args.fasta):
        if not line.startswith(">"):
            seq.append(line.strip())
    ref_seq = "".join(seq).upper()
    table = parse_var_table(args.var_file)
    names, rows = build_msa(ref_seq, table, args.offset_pos,
                            args.offset_neg,
                            ref_name=args.gene + "*REF")
    with open(args.out, "w") as f:
        for nm, row in zip(names, rows):
            pre = "" if "*" in nm else args.gene + "*"
            f.write(f">{pre}{nm}\n{row}\n")
    print(f"[extract-cyp] {len(names)} alleles -> {args.out}",
          file=sys.stderr)
    return 0
