"""Read simulator with ground-truth SAM (hisat2_simulate_reads.py
equivalent, hisat2's hisat2_simulate_reads.py).

Generates DNA fragments from the genome or RNA fragments from GTF
transcripts, optionally incorporating known variants (.snp: single /
deletion / insertion) and uniform sequencing errors, and writes:
  <base>_1.fa [, <base>_2.fa]   the reads (mate2 reverse-complemented)
  <base>.sam                    the true alignments with spliced CIGARs,
                                XM/NM/MD, Zs (variants used), XS/TI (RNA)

The truth SAM drives accuracy evaluation: align the reads, then compare
reported positions/CIGARs to the truth (the reference's evaluation/
calculate_read_cost.py workflow).

Copied verbatim from hisat2_tpu/tools/simulate.py; only the imports, and
the location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import random
import sys
from collections import defaultdict

_RC = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}


def revcomp(s):
    return "".join(_RC.get(c, "N") for c in reversed(s))


def read_genome(path):
    chrs = {}
    name, parts = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    chrs[name] = "".join(parts).upper()
                name = line[1:].split()[0]
                parts = []
            else:
                parts.append(line)
    if name is not None:
        chrs[name] = "".join(parts).upper()
    return chrs


def read_transcripts(genome, gtf_file, min_len):
    """{tid: (chrom, strand, length, [[start, end], ...])} (0-based,
    inclusive exon bounds, sorted)."""
    raw = defaultdict(list)
    strands = {}
    chroms = {}
    with open(gtf_file) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) != 9 or fields[2] != "exon":
                continue
            chrom, _, _, left, right, _, strand, _, vals = fields
            if chrom not in genome:
                continue
            tid = None
            for attr in vals.split(";"):
                k, _, v = attr.strip().partition(" ")
                if k == "transcript_id":
                    tid = v.strip('"')
                    break
            if tid is None:
                continue
            raw[tid].append([int(left) - 1, int(right) - 1])
            strands[tid] = strand
            chroms[tid] = chrom
    trans = {}
    for tid, exons in raw.items():
        exons.sort()
        tlen = sum(e - s + 1 for s, e in exons)
        if tlen < min_len:
            continue
        trans[tid] = (chroms[tid], strands[tid], tlen, exons)
    return trans


def read_snps(path):
    """{chrom: sorted [(pos, kind, data, id)]} from a hisat2 .snp file."""
    snps = defaultdict(list)
    if not path:
        return snps
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 5:
                continue
            sid, kind, chrom, pos, data = p[:5]
            snps[chrom].append((int(pos), kind, data, sid))
    for c in snps:
        snps[c].sort()
    return snps


def expr_profile(kind, n):
    if kind == "constant":
        return [1.0 / n] * n
    # flux-like zipf mixture (the reference's default "flux" profile shape)
    ws = [1.0 / (i + 1) for i in range(n)]
    tot = sum(ws)
    return [w / tot for w in ws]


def _apply_variants_and_errors(chr_seq, exons, tpos, read_len, snps, rng,
                               error_rate, max_mismatch):
    """Walk `read_len` transcript bases starting at transcript offset
    `tpos`, emitting (read_seq, cigar string, MD, NM, XM, Zs, pos).

    Genomic coordinates follow the exon chain (introns -> N ops); each
    heterozygous variant in range is included with probability 1/2;
    uniform errors are added up to max_mismatch."""
    # map transcript offset -> (exon index, genomic pos)
    off = tpos
    ei = 0
    while off > exons[ei][1] - exons[ei][0]:
        off -= exons[ei][1] - exons[ei][0] + 1
        ei += 1
    gpos = exons[ei][0] + off
    start_gpos = gpos

    read = []
    cig = []            # (op, len)
    md = []             # MD components built as (matches, event str)
    zs = []             # (read offset, kind char, id)
    nm = xm = 0
    match_run = 0
    n_read = 0

    def cig_add(op, ln):
        if cig and cig[-1][0] == op:
            cig[-1][1] += ln
        else:
            cig.append([op, ln])

    # active snps for this chromosome within the window
    import bisect
    while n_read < read_len:
        # intron crossing?
        if gpos > exons[ei][1]:
            if ei + 1 >= len(exons):
                break
            gap = exons[ei + 1][0] - exons[ei][1] - 1
            cig_add("N", gap)
            ei += 1
            gpos = exons[ei][0]
            continue
        # variant at this position?
        hit = None
        lo = bisect.bisect_left(snps, (gpos,))
        if lo < len(snps) and snps[lo][0] == gpos:
            if rng.random() < 0.5:
                hit = snps[lo]
        if hit is not None:
            _, kind, data, sid = hit
            if kind == "single" and data != chr_seq[gpos]:
                read.append(data)
                cig_add("M", 1)
                md.append(("X", chr_seq[gpos], match_run))
                match_run = 0
                zs.append((n_read, "S", sid))
                gpos += 1
                n_read += 1
                continue
            if kind == "deletion":
                dl = int(data)
                if gpos + dl <= exons[ei][1] + 1 and n_read > 0:
                    cig_add("D", dl)
                    md.append(("D", chr_seq[gpos:gpos + dl], match_run))
                    match_run = 0
                    zs.append((n_read, "D", sid))
                    gpos += dl
                    continue
            if kind == "insertion":
                il = len(data)
                if n_read + il < read_len and n_read > 0:
                    read.append(data)
                    cig_add("I", il)
                    zs.append((n_read, "I", sid))
                    n_read += il
                    continue
        base = chr_seq[gpos]
        if rng.random() < error_rate and xm < max_mismatch and base in _RC:
            err = random.choice([c for c in "ACGT" if c != base])
            read.append(err)
            cig_add("M", 1)
            md.append(("X", base, match_run))
            match_run = 0
            xm += 1
        else:
            read.append(base)
            cig_add("M", 1)
            match_run += 1
        gpos += 1
        n_read += 1

    # MD string
    md_str = []
    for ev in md:
        if ev[0] == "X":
            md_str.append(str(ev[2]))
            md_str.append(ev[1])
        else:
            md_str.append(str(ev[2]))
            md_str.append("^" + ev[1])
    md_str.append(str(match_run))
    # normalize: deletion followed directly by matches needs the 0 rule
    md_out = "".join(md_str)
    # NM = mismatches + deleted + inserted bases
    ndel = sum(ln for op, ln in cig if op == "D")
    nins = sum(ln for op, ln in cig if op == "I")
    n_snp_mm = sum(1 for z in zs if z[1] == "S")
    nm = xm + n_snp_mm + ndel + nins
    # Zs string (delta-encoded by read offset)
    zs_parts, prev = [], -1
    for o, k, sid in zs:
        zs_parts.append("%d|%s|%s" % (o - prev - 1, k, sid))
        prev = o
    cigar = "".join("%d%s" % (ln, op) for op, ln in cig)
    return ("".join(read), cigar, md_out, nm, xm + n_snp_mm,
            ",".join(zs_parts), start_gpos)


def simulate(genome_file, base, gtf_file=None, snp_file=None, rna=False,
             paired=True, read_len=100, frag_len=250, num_frag=10000,
             profile="flux", error_rate=0.0, max_mismatch=3, seed=0):
    rng = random.Random(seed)
    random.seed(seed)
    if read_len > frag_len:
        frag_len = read_len
    genome = read_genome(genome_file)
    snps = read_snps(snp_file)
    if rna:
        trans = read_transcripts(genome, gtf_file, frag_len)
        tids = sorted(trans)
        rng.shuffle(tids)
        n = min(len(tids), 10000)
        prof = expr_profile(profile, n)
    else:
        tids = sorted(genome)
        tot = sum(len(genome[c]) for c in tids)
        prof = [len(genome[c]) / tot for c in tids]
    counts = [int(p * num_frag) for p in prof]
    i = 0
    while sum(counts) < num_frag:
        counts[i % len(counts)] += 1
        i += 1

    sam = open(base + ".sam", "w")
    sam.write("@HD\tVN:1.0\tSO:unsorted\n")
    for c in genome:
        sam.write("@SQ\tSN:%s\tLN:%d\n" % (c, len(genome[c])))
    r1 = open(base + "_1.fa", "w")
    r2 = open(base + "_2.fa", "w") if paired else None

    rid = 1
    for t, cnt in enumerate(counts):
        if rna:
            tid = tids[t]
            chrom, strand, tlen, exons = trans[tid]
        else:
            chrom = tids[t]
            tlen = len(genome[chrom])
            exons = [[0, tlen - 1]]
            strand, tid = None, None
        chr_seq = genome[chrom]
        chr_snps = snps.get(chrom, [])
        for _ in range(cnt):
            for _try in range(50):
                fp = rng.randint(0, tlen - frag_len)
                if rna or "N" not in chr_seq[fp:fp + frag_len]:
                    break
            a1 = _apply_variants_and_errors(
                chr_seq, exons, fp, read_len, chr_snps, rng,
                error_rate / 100.0, max_mismatch)
            a2 = _apply_variants_and_errors(
                chr_seq, exons, fp + frag_len - read_len, read_len,
                chr_snps, rng, error_rate / 100.0, max_mismatch)
            flag, flag2 = (99, 163) if paired else (0, 0)
            swapped = rng.randint(0, 1) == 1 if paired else False
            if not paired and rng.randint(0, 1) == 1:
                flag = 16
                swapped = True
            if swapped and paired:
                flag, flag2 = flag - 16, flag2 - 16
                a1, a2 = a2, a1
            seq1, cig1, md1, nm1, xm1, zs1, p1 = a1
            seq2, cig2, md2, nm2, xm2, zs2, p2 = a2
            extra = ""
            if rna:
                extra = "\tXS:A:%s\tTI:Z:%s" % (strand, tid)
            z1 = "\tZs:Z:" + zs1 if zs1 else ""
            z2 = "\tZs:Z:" + zs2 if zs2 else ""
            r1.write(">%d\n%s\n" % (rid, revcomp(seq1) if swapped
                                    else seq1))
            rnext, pnext = (chrom, p2 + 1) if paired else ("*", 0)
            sam.write("%d\t%d\t%s\t%d\t255\t%s\t%s\t%d\t0\t%s\t*\t"
                      "XM:i:%d\tNM:i:%d\tMD:Z:%s%s%s\n"
                      % (rid, flag, chrom, p1 + 1, cig1, rnext, pnext,
                         seq1, xm1, nm1, md1, z1, extra))
            if paired:
                r2.write(">%d\n%s\n" % (rid, seq2 if swapped
                                        else revcomp(seq2)))
                sam.write("%d\t%d\t%s\t%d\t255\t%s\t%s\t%d\t0\t%s\t*\t"
                          "XM:i:%d\tNM:i:%d\tMD:Z:%s%s%s\n"
                          % (rid, flag2, chrom, p2 + 1, cig2, chrom,
                             p1 + 1, seq2, xm2, nm2, md2, z2, extra))
            rid += 1
    sam.close()
    r1.close()
    if r2:
        r2.close()


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="hisat2-tpu simulate-reads",
        description="Simulate reads with a ground-truth SAM")
    p.add_argument("genome")
    p.add_argument("base")
    p.add_argument("--gtf", default=None)
    p.add_argument("--snp", default=None)
    p.add_argument("-d", "--dna", action="store_true")
    p.add_argument("--single-end", action="store_true")
    p.add_argument("-r", "--read-length", type=int, default=100)
    p.add_argument("-f", "--fragment-length", type=int, default=250)
    p.add_argument("-n", "--num-fragment", type=int, default=10000)
    p.add_argument("-e", "--expr-profile", default="flux",
                   choices=["flux", "constant"])
    p.add_argument("--error-rate", type=float, default=0.0)
    p.add_argument("--max-mismatch", type=int, default=3)
    p.add_argument("--random-seed", type=int, default=0)
    args = p.parse_args(argv)
    rna = not args.dna
    if rna and not args.gtf:
        print("error: RNA mode requires --gtf (or pass -d)",
              file=sys.stderr)
        return 1
    simulate(args.genome, args.base, gtf_file=args.gtf, snp_file=args.snp,
             rna=rna, paired=not args.single_end,
             read_len=args.read_length, frag_len=args.fragment_length,
             num_frag=args.num_fragment, profile=args.expr_profile,
             error_rate=args.error_rate, max_mismatch=args.max_mismatch,
             seed=args.random_seed)
    return 0
