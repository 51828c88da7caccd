"""Allele MSA -> backbone + variant table (hisatgenotype_extract_vars
equivalent, hisat2's hisatgenotype_extract_vars.py).

The reference encodes each typed locus as a BACKBONE sequence plus
per-allele variant lists extracted from the IMGT multiple sequence
alignment; reads align against the backbone graph and allele
compatibility is variant-set consistency — this is what lets typing
scale to thousands of alleles without per-allele alignment.

Input here is a generic aligned FASTA (every record the same length,
'-' for gaps).  Backbone = column-majority base over non-gap entries;
columns where the majority is a gap become insertion columns (skipped in
backbone coordinates).  Variants:
  ('S', pos, base)   single-nucleotide difference at backbone pos
  ('D', pos, len)    deletion of len backbone bases starting at pos
  ('I', pos, seq)    insertion of seq before backbone pos

Copied verbatim from hisat2_tpu/genotype/msa.py; only the imports, and
the location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import numpy as np

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def parse_msa(path_or_records):
    """-> (backbone_codes uint8 [N], allele_vars {name: [var,...]},
    var_index {var: id}, allele_spans {name: (lo, hi)})

    allele_spans: backbone coordinates covered by the allele (leading /
    trailing gaps in the MSA mean the allele sequence is partial —
    common in IMGT nucleotide alignments)."""
    if isinstance(path_or_records, str):
        recs = []
        name, seq = None, []
        for line in open(path_or_records):
            if line.startswith(">"):
                if name:
                    recs.append((name, "".join(seq)))
                name = line[1:].split()[0]
                seq = []
            else:
                seq.append(line.strip())
        if name:
            recs.append((name, "".join(seq)))
    else:
        recs = list(path_or_records)
    if not recs:
        raise ValueError("empty MSA")
    L = len(recs[0][1])
    mat = np.frombuffer(
        "".join(s for _, s in recs).upper().encode(), np.uint8
    ).reshape(len(recs), L)
    # column majority over A/C/G/T/-
    counts = np.zeros((5, L), np.int32)
    for i, ch in enumerate(b"ACGT-"):
        counts[i] = (mat == ch).sum(axis=0)
    maj = np.argmax(counts, axis=0)           # 4 = gap-majority column
    bb_cols = np.flatnonzero(maj < 4)
    backbone = maj[bb_cols].astype(np.uint8)
    # backbone position of each MSA column (for gap cols: position of the
    # NEXT backbone column — insertion point)
    col_to_bb = np.cumsum(np.isin(np.arange(L), bb_cols))  # 1-based after
    col_bb_pos = col_to_bb - 1                # backbone pos of col if bb
    ins_point = np.searchsorted(bb_cols, np.arange(L))

    allele_vars = {}
    allele_spans = {}
    asc = np.frombuffer(b"ACGT", np.uint8)
    for r, (name, _) in enumerate(recs):
        row = mat[r]
        nz = np.flatnonzero(row != ord("-"))
        if not nz.size:
            allele_vars[name] = []
            allele_spans[name] = (0, 0)
            continue
        lo_col, hi_col = nz[0], nz[-1] + 1
        span_lo = int(ins_point[lo_col])
        out = []
        # SNVs on backbone columns
        for c in bb_cols[(bb_cols >= lo_col) & (bb_cols < hi_col)]:
            ch = row[c]
            if ch == ord("-"):
                continue
            if ch != asc[maj[c]] and ch in asc:
                out.append(("S", int(col_bb_pos[c]),
                            "ACGT"[int(np.where(asc == ch)[0][0])]))
        # deletions: runs of '-' on backbone columns within span
        bbc = bb_cols[(bb_cols >= lo_col) & (bb_cols < hi_col)]
        isdel = row[bbc] == ord("-")
        if isdel.any():
            d = np.diff(isdel.astype(np.int8))
            starts = np.flatnonzero(d == 1) + 1
            ends = np.flatnonzero(d == -1) + 1
            if isdel[0]:
                starts = np.concatenate([[0], starts])
            if isdel[-1]:
                ends = np.concatenate([ends, [len(bbc)]])
            for s, e in zip(starts, ends):
                out.append(("D", int(col_bb_pos[bbc[s]]), int(e - s)))
        # insertions: non-gap chars on gap-majority columns
        gap_cols = np.flatnonzero((maj == 4) & (row != ord("-")))
        gap_cols = gap_cols[(gap_cols >= lo_col) & (gap_cols < hi_col)]
        if gap_cols.size:
            brk = np.flatnonzero(np.diff(gap_cols) != 1)
            groups = np.split(gap_cols, brk + 1)
            for grp in groups:
                seq = "".join(chr(c) for c in row[grp])
                if all(ch in "ACGT" for ch in seq):
                    out.append(("I", int(ins_point[grp[0]]), seq))
        allele_vars[name] = out
        allele_spans[name] = (span_lo,
                              int(col_bb_pos[bbc[-1]]) + 1 if len(bbc)
                              else span_lo)
    var_ids = {}
    for vs in allele_vars.values():
        for v in vs:
            if v not in var_ids:
                var_ids[v] = len(var_ids)
    # canonical order by (pos, type, data)
    ordered = sorted(var_ids, key=lambda v: (v[1], v[0], str(v[2])))
    var_ids = {v: i for i, v in enumerate(ordered)}
    return backbone, allele_vars, var_ids, allele_spans
