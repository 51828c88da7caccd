"""GTF -> .ss / .exon extraction (behavioral ports of
hisat2's hisat2_extract_splice_sites.py and
hisat2_extract_exons.py).

Both tools parse exon features grouped by transcript, sort each
transcript's exons and merge neighbours separated by introns of <= 5 bp,
then emit 0-based coordinates:
  .ss:   chrom <last base of left exon> <first base of right exon> strand
  .exon: chrom <start-1> <end-1> strand, overlap-merged across transcripts

Copied verbatim from hisat2_tpu/tools/gtf.py; only the imports, and the
location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import sys
from collections import defaultdict


def _parse_transcripts(gtf_file):
    """{transcript_id: (chrom, strand, [[left, right], ...])} with exons
    sorted and <=5 bp introns collapsed (1-based, inclusive)."""
    trans = {}
    genes = defaultdict(list)
    for line in gtf_file:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "#" in line:
            line = line.split("#")[0].strip()
        fields = line.split("\t")
        if len(fields) != 9:
            continue
        chrom, _src, feature, left, right, _score, strand, _frame, vals = \
            fields
        if feature != "exon":
            continue
        left, right = int(left), int(right)
        if left >= right:
            continue
        attrs = {}
        for attr in vals.split(";")[:-1]:
            key, _, val = attr.strip().partition(" ")
            attrs[key] = val.strip('"')
        if "gene_id" not in attrs or "transcript_id" not in attrs:
            continue
        tid = attrs["transcript_id"]
        if tid not in trans:
            trans[tid] = [chrom, strand, [[left, right]]]
            genes[attrs["gene_id"]].append(tid)
        else:
            trans[tid][2].append([left, right])
    for tid, (chrom, strand, exons) in trans.items():
        exons.sort()
        merged = [exons[0]]
        for ex in exons[1:]:
            if ex[0] - merged[-1][1] <= 5:
                merged[-1][1] = ex[1]
            else:
                merged.append(ex)
        trans[tid] = (chrom, strand, merged)
    return trans


def extract_splice_sites(gtf_file, out=sys.stdout):
    trans = _parse_transcripts(gtf_file)
    junctions = set()
    for chrom, strand, exons in trans.values():
        for i in range(1, len(exons)):
            junctions.add((chrom, exons[i - 1][1], exons[i][0], strand))
    for chrom, left, right, strand in sorted(junctions):
        out.write(f"{chrom}\t{left - 1}\t{right - 1}\t{strand}\n")


def extract_exons(gtf_file, out=sys.stdout):
    trans = _parse_transcripts(gtf_file)
    uniq = set()
    for chrom, strand, exons in trans.values():
        for left, right in exons:
            uniq.add((chrom, left, right, strand))
    uniq = sorted(uniq)
    if not uniq:
        return
    # merge overlapping exons across transcripts; strand becomes the
    # earlier exon's strand when they disagree
    merged = [uniq[0]]
    for exon in uniq[1:]:
        prev = merged[-1]
        if exon[0] != prev[0] or prev[2] < exon[1]:
            merged.append(exon)
            continue
        if prev[2] < exon[2]:
            strand = prev[3] if prev[3] in "+-" else exon[3]
            merged[-1] = (prev[0], prev[1], exon[2], strand)
    for chrom, left, right, strand in merged:
        out.write(f"{chrom}\t{left - 1}\t{right - 1}\t{strand}\n")


def main_ss(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="hisat2-tpu extract-splice-sites",
        description="Extract splice sites (.ss) from a GTF file")
    p.add_argument("gtf", type=argparse.FileType("r"))
    args = p.parse_args(argv)
    extract_splice_sites(args.gtf)
    return 0


def main_exons(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="hisat2-tpu extract-exons",
        description="Extract exons (.exon) from a GTF file")
    p.add_argument("gtf", type=argparse.FileType("r"))
    args = p.parse_args(argv)
    extract_exons(args.gtf)
    return 0
