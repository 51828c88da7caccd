"""UCSC dbSNP dump -> .snp / .haplotype extractor.

Behavioral port of hisat2's hisat2_extract_snps_haplotypes_UCSC.py
(576 L, python 2): parses a UCSC snpNNN table (plain or gzipped), filters
to genomic single/deletion/insertion records, strand-adjusts alleles, and
emits the same `.snp` rows plus greedy genotype-colored `.haplotype`
groups (inter/intra-gap splitting).  Output is byte-identical to the
reference script on the same inputs (oracle-diffed; see
tests/test_tools.py + the verify skill's py2-shim recipe).

Copied verbatim from hisat2_tpu/tools/variants_ucsc.py; only the
imports, and the location of the hisat2 sources in citations, are
rewritten.
"""

from __future__ import annotations

import functools
import gzip
import re
import sys
from argparse import ArgumentParser


def _read_genome(f):
    chrs = {}
    name, seq = "", []
    for line in f:
        if line.startswith(">"):
            if name:
                chrs[name] = "".join(seq)
            name = line.strip().split()[0][1:]
            seq = []
        else:
            seq.append(line.strip())
    if name:
        chrs[name] = "".join(seq)
    return chrs


_RC = {"A": "T", "a": "t", "C": "G", "c": "g",
       "G": "C", "g": "c", "T": "A", "t": "a"}


def _revcomp(s):
    return "".join(_RC.get(c, c) for c in reversed(s))


def _compare_vars(a, b):
    a_chr, a_pos, a_type, a_data = a[:4]
    b_chr, b_pos, b_type, b_data = b[:4]
    if a_pos != b_pos:
        return a_pos - b_pos
    if a_type != b_type:
        if a_type == "I":
            return -1
        if b_type == "I":
            return 1
        return -1 if a_type == "S" else 1
    # py2 cmp() on mixed data (str alleles / int lengths): types within a
    # (pos, type) group are homogeneous, so plain comparison is safe
    if a_data < b_data:
        return -1
    if a_data > b_data:
        return 1
    return 0


def _compatible_vars(a, b):
    a_pos, a_type, a_data = a[1:4]
    b_pos = b[1]
    if a_pos == b_pos:
        return False
    if a_type == "D" and b_pos <= a_pos + a_data:
        return False
    return True


def _generate_haplotypes(snp_file, haplotype_file, vars_, inter_gap,
                         intra_gap, num_haplotypes):
    vars_ = sorted(vars_, key=functools.cmp_to_key(_compare_vars))
    tmp, v = [], 0
    while v < len(vars_):
        var = vars_[v]
        for v2 in range(v + 1, len(vars_)):
            if _compare_vars(var, vars_[v2]) == 0:
                v += 1
            else:
                break
        tmp.append(var)
        v += 1
    vars_ = tmp

    counts = {}
    for var in vars_:
        counts[var[4]["id"]] = counts.get(var[4]["id"], 0) + 1
    dup = {i for i, c in counts.items() if c > 1}
    counts = {}
    for var in vars_:
        vid = var[4]["id"]
        counts[vid] = counts.get(vid, -1) + 1
        var[4]["id2"] = (f"{vid}.{counts[vid]}" if vid in dup else vid)

    cmpt = [-1] * len(vars_)
    for v in range(len(vars_)):
        _, pos, typ, data = vars_[v][:4]
        if typ == "D":
            pos += data - 1
        for v2 in range(v + 1, len(vars_)):
            if cmpt[v2] >= 0:
                continue
            if pos + inter_gap < vars_[v2][1]:
                break
            cmpt[v2] = v

    genotypes = []
    for v in range(len(vars_)):
        var = vars_[v]
        freq = var[4]["freq"]
        used = [False] * 100
        if cmpt[v] >= 0:
            v2 = v - 1
            while v2 >= cmpt[v]:
                var2 = vars_[v2]
                if not _compatible_vars(var2, var) or freq >= 0.1:
                    used[var2[4]["genotype"]] = True
                v2 -= 1
        for i, u in enumerate(used):
            if not u:
                var[4]["genotype"] = i
                break
        genotypes.append(var[4]["genotype"])

    for chrom, pos, typ, data, d in vars_:
        tname = {"S": "single", "D": "deletion", "I": "insertion"}[typ]
        snp_file.write(f"{d['id2']}\t{tname}\t{chrom}\t{pos}\t{data}\n")

    haplotypes = [""] * (max(genotypes) + 1)
    for i, num in enumerate(genotypes):
        haplotypes[num] = (str(i) if haplotypes[num] == ""
                           else haplotypes[num] + f"#{i}")
    haplotypes = set(haplotypes)

    def split_haplotypes(hs):
        out = set()
        for h in hs:
            h = h.split("#")
            if len(h) == 1:
                out.add(h[0])
                continue
            prev_s, s = 0, 1
            while s < len(h):
                _, ploc, ptyp, pdata, _ = vars_[int(h[s - 1])]
                loc = vars_[int(h[s])][1]
                if ptyp == "D":
                    ploc += int(pdata) - 1
                if ploc + intra_gap < loc:
                    out.add("#".join(h[prev_s:s]))
                    prev_s = s
                s += 1
                if s == len(h):
                    out.add("#".join(h[prev_s:s]))
        return out

    def cmp_h(a, b):
        a = a.split("#")
        b = b.split("#")
        ab = vars_[int(a[0])][1]
        _, ae, at, ad, _ = vars_[int(a[-1])]
        if at == "D":
            ae += int(ad) - 1
        bb = vars_[int(b[0])][1]
        _, be, bt, bd, _ = vars_[int(b[-1])]
        if bt == "D":
            be += int(bd) - 1
        if ab != bb:
            return ab - bb
        return ae - be

    hs = sorted(split_haplotypes(haplotypes),
                key=functools.cmp_to_key(cmp_h))
    for h_i, hstr in enumerate(hs):
        h = hstr.split("#")
        chrom, h_begin = vars_[int(h[0])][:2]
        _, h_end, ht, hd, _ = vars_[int(h[-1])]
        if ht == "D":
            h_end += int(hd) - 1
        h_new_begin = h_begin
        for h_j in reversed(range(h_i)):
            hc = hs[h_j].split("#")
            _, hc_begin, hct, hcd, _ = vars_[int(hc[-1])]
            hc_end = hc_begin + (int(hcd) - 1 if hct == "D" else 0)
            if hc_end + inter_gap < h_begin:
                break
            if h_new_begin > hc_end:
                h_new_begin = hc_end
        ids = ",".join(vars_[int(i)][4]["id2"] for i in h)
        haplotype_file.write(f"ht{num_haplotypes}\t{chrom}\t{h_new_begin}"
                             f"\t{h_end}\t{ids}\n")
        num_haplotypes += 1
    return num_haplotypes


def extract_ucsc(genome_file, snp_fname, base_fname,
                 inter_gap=30, intra_gap=50):
    chr_dic = _read_genome(genome_file)
    snp_out = open(base_fname + ".snp", "w")
    hap_out = open(base_fname + ".haplotype", "w")
    opener = gzip.open if snp_fname.endswith(".gz") else open
    snp_list = []
    prev_chr, curr_right = "", -1
    num_haplotypes = 0
    ids_seen = set()
    with opener(snp_fname, "rt") as f:
        for line in f:
            if not line or line.startswith("#"):
                continue
            line = line.strip()
            fields = line.split("\t")
            if len(fields) < 12:
                continue
            (_, chrom, start, end, rs_id, score, strand, _refN, _refU,
             observed, mol_type, class_type) = fields[:12]
            allele_freqs = fields[-2].split(",")[:-1]
            if allele_freqs:
                try:
                    float(allele_freqs[0])
                except ValueError:
                    allele_freqs = []
            try:
                start, end = int(start), int(end)
                int(score)
            except ValueError:
                continue
            if mol_type != "genomic":
                continue
            if class_type not in ("single", "deletion", "insertion"):
                continue
            if class_type == "single" and start + 1 != end:
                continue
            if class_type == "insertion" and start != end:
                continue
            if chrom not in chr_dic:
                continue
            chr_seq = chr_dic[chrom]
            if start >= len(chr_seq):
                continue
            if rs_id in ids_seen:
                continue
            ids_seen.add(rs_id)
            if (prev_chr != chrom or curr_right + inter_gap < start) \
                    and snp_list:
                num_haplotypes = _generate_haplotypes(
                    snp_out, hap_out, snp_list, inter_gap, intra_gap,
                    num_haplotypes)
                snp_list = []
            observed = observed.upper()
            allele_list = observed.split("/")
            if not allele_freqs:
                allele_freqs = [0.0] * len(allele_list)
            if strand == "-":
                allele_list = [_revcomp(a) for a in allele_list]
            if class_type == "single":
                ref_base = chr_seq[start].upper()
                if ref_base not in allele_list:
                    continue
                for a in range(min(len(allele_list), len(allele_freqs))):
                    allele = allele_list[a]
                    freq = float(allele_freqs[a])
                    if allele not in "ACGT" or len(allele) != 1:
                        continue
                    if allele == ref_base:
                        continue
                    snp_list.append([chrom, start, "S", allele,
                                     {"id": rs_id, "freq": freq}])
            elif class_type == "deletion":
                if start > 0 and chr_seq[start - 1].upper() not in "ACGT":
                    continue
                if len(allele_list) != 2 or \
                        len(allele_list) != len(allele_freqs):
                    continue
                if allele_list[0] == "-":
                    freq = float(allele_freqs[1])
                elif allele_list[1] == "-":
                    freq = float(allele_freqs[0])
                else:
                    continue
                snp_list.append([chrom, start, "D", end - start,
                                 {"id": rs_id, "freq": freq}])
            else:
                if start > 0 and chr_seq[start - 1].upper() not in "ACGT":
                    continue
                for a in range(min(len(allele_list), len(allele_freqs))):
                    allele = allele_list[a]
                    freq = float(allele_freqs[a])
                    if allele == "-" or len(allele) <= 0:
                        continue
                    if re.match("^[ACGT]+$", allele):
                        snp_list.append([chrom, start, "I", allele,
                                         {"id": rs_id, "freq": freq}])
            if curr_right < end:
                curr_right = end
            if prev_chr != chrom:
                curr_right = end
            prev_chr = chrom
    if snp_list:
        _generate_haplotypes(snp_out, hap_out, snp_list, inter_gap,
                             intra_gap, num_haplotypes)
    snp_out.close()
    hap_out.close()


def main(argv=None):
    p = ArgumentParser(description="Extract SNPs/haplotypes from a UCSC "
                       "dbSNP table dump (hisat2_extract_snps_haplotypes_"
                       "UCSC.py equivalent)")
    p.add_argument("genome_file")
    p.add_argument("snp_fname")
    p.add_argument("base_fname")
    p.add_argument("--inter-gap", dest="inter_gap", type=int, default=30)
    p.add_argument("--intra-gap", dest="intra_gap", type=int, default=50)
    args = p.parse_args(argv)
    with open(args.genome_file) as g:
        extract_ucsc(g, args.snp_fname, args.base_fname,
                     args.inter_gap, args.intra_gap)
    return 0


if __name__ == "__main__":
    sys.exit(main())
