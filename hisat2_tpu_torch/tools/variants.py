"""VCF -> .snp / .haplotype extraction (behavioral port of
hisat2's hisat2_extract_snps_haplotypes_VCF.py, standard path).

The transformation:
  - each VCF ALT allele becomes a normalized variant: trailing shared
    prefix trimmed (anchors multi-base records at their last common base),
    'S' single / 'I' insertion (<= 32 bp) / 'D' deletion, validated
    against the genome; multi-allelic records get ".<i>" id suffixes
  - variants cluster into groups separated by > inter_gap bp; each group
    emits its variants (sorted, de-duplicated) and its haplotypes
  - haplotypes come from phased genotype columns when present (each
    chromosome's allele string becomes a haplotype), else from a greedy
    compatibility coloring; haplotypes with internal gaps > intra_gap are
    split; output rows are `ht<N> chr left right id1,id2,...`

Copied verbatim from hisat2_tpu/tools/variants.py; only the imports, and
the location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import functools
import gzip
import sys


def read_genome(path):
    chrs = {}
    name, parts = None, []
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    chrs[name] = "".join(parts)
                name = line[1:].split()[0]
                parts = []
            else:
                parts.append(line)
    if name is not None:
        chrs[name] = "".join(parts)
    return chrs


def compare_vars(a, b):
    _, a_pos, a_type, a_data = a[:4]
    _, b_pos, b_type, b_data = b[:4]
    if a_pos != b_pos:
        return a_pos - b_pos
    if a_type != b_type:
        if a_type == "I":
            return -1
        if b_type == "I":
            return 1
        return -1 if a_type == "S" else 1
    sa, sb = str(a_data), str(b_data)
    return -1 if sa < sb else (1 if sa > sb else 0)


def compatible_vars(a, b):
    """a before b on the same chromosome: can they share a haplotype?"""
    _, a_pos, a_type, a_data = a[:4]
    _, b_pos, _, _ = b[:4]
    if a_pos == b_pos:
        return False
    if a_type == "D" and b_pos <= a_pos + a_data:
        return False
    return True


def extract_vars(chr_seq, chrom, pos, ref_allele, alt_alleles, var_id):
    """Normalize one VCF record's ALT alleles (0-based pos)."""
    out = []
    alts = alt_alleles.split(",")
    for a, alt in enumerate(alts):
        if "N" in alt:
            continue
        ref2, pos2 = ref_allele, pos
        m = min(len(ref2), len(alt))
        if m > 1:
            ref2 = ref2[m - 1:]
            alt = alt[m - 1:]
            pos2 += m - 1
        if len(ref2) == 1 and len(alt) == 1:
            vtype, data = "S", alt
            if ref2 == alt or chr_seq[pos2] != ref2:
                continue
        elif len(ref2) == 1:
            vtype, data = "I", alt[1:]
            if len(data) > 32 or chr_seq[pos] != ref2:
                continue
        else:
            vtype, data = "D", len(ref2) - 1
            if chr_seq[pos2:pos2 + data + 1] != ref2:
                continue
        vid2 = "%s.%d" % (var_id, a) if len(alts) > 1 else var_id
        out.append([chrom, pos2, vtype, data,
                    {"id": var_id, "id2": vid2, "alt_index": a}])
    return out


def _split_haplotypes(haplotypes, variants, intra_gap):
    split = set()
    for h in haplotypes:
        ids = h.split("#")
        if len(ids) == 1:
            split.add(ids[0])
            continue
        prev_s, s = 0, 1
        while s < len(ids):
            _, ploc, ptype, pdata, _ = variants[int(ids[s - 1])]
            _, loc, _, _, _ = variants[int(ids[s])]
            if ptype == "D":
                ploc += int(pdata) - 1
            if ploc + intra_gap < int(loc):
                split.add("#".join(ids[prev_s:s]))
                prev_s = s
            s += 1
            if s == len(ids):
                split.add("#".join(ids[prev_s:s]))
    return split


def generate_haplotypes(snp_out, hap_out, variants, inter_gap, intra_gap,
                        num_genomes, num_haplotypes):
    variants = sorted(variants, key=functools.cmp_to_key(compare_vars))
    # de-duplicate, merging genotype info into the first copy
    uniq, v = [], 0
    while v < len(variants):
        var = variants[v]
        for v2 in range(v + 1, len(variants)):
            if compare_vars(var, variants[v2]) == 0:
                v += 1
                if "genotype" not in var[4] and \
                        "genotype" in variants[v2][4]:
                    var[4]["genotype"] = variants[v2][4]["genotype"]
            else:
                break
        uniq.append(var)
        v += 1
    variants = uniq

    for chrom, pos, vtype, data, vdic in variants:
        tname = {"S": "single", "D": "deletion", "I": "insertion"}[vtype]
        snp_out.write("%s\t%s\t%s\t%s\t%s\n"
                      % (vdic["id2"], tname, chrom, pos, data))

    # leftmost earlier variant each variant could conflict with
    cmpt = [-1] * len(variants)
    for v in range(len(variants)):
        _, pos, vtype, data = variants[v][:4]
        if vtype == "D":
            pos += data - 1
        for v2 in range(v + 1, len(variants)):
            if cmpt[v2] >= 0:
                continue
            _, pos2, vtype2 = variants[v2][:3]
            if vtype == "D" and vtype2 == "D":
                if pos + 1 < pos2:
                    break
            elif pos < pos2:
                break
            cmpt[v2] = v

    haplotypes = set()
    if num_genomes > 0:
        digit = "0123456789"
        max_num = 1
        genotypes_list = []
        for v, var in enumerate(variants):
            vdic = var[4]
            if "genotype" not in vdic:
                used = [True, True] + [False] * 8
                if cmpt[v] >= 0:
                    for v2 in range(v - 1, cmpt[v] - 1, -1):
                        if not compatible_vars(variants[v2], var):
                            used[int(variants[v2][4]["genotype"][0])] = True
                for i, u in enumerate(used):
                    if not u:
                        vdic["genotype"] = digit[i] * (num_genomes * 2)
                        max_num = max(max_num, i)
                        break
            genotypes_list.append(vdic["genotype"])
        n_chrom = len(genotypes_list[0])
        cols = ["".join(g[i] for g in genotypes_list)
                for i in range(n_chrom)]
        for raw in set(cols):
            for num in range(1, max_num + 1):
                ns = str(num)
                if ns not in raw:
                    continue
                hap = "#".join(str(i) for i in range(len(raw))
                               if raw[i] == ns)
                haplotypes.add(hap)
    else:
        genotypes_list = []
        for v, var in enumerate(variants):
            vdic = var[4]
            used = [False] * 100
            if cmpt[v] >= 0:
                for v2 in range(v - 1, cmpt[v] - 1, -1):
                    if not compatible_vars(variants[v2], var):
                        used[variants[v2][4]["genotype"]] = True
            for i, u in enumerate(used):
                if not u:
                    vdic["genotype"] = i
                    break
            genotypes_list.append(vdic["genotype"])
        maxg = max(genotypes_list)
        haps = [""] * (maxg + 1)
        for i, num in enumerate(genotypes_list):
            haps[num] = str(i) if not haps[num] else haps[num] + "#%d" % i
        haplotypes = set(haps)

    haplotypes = _split_haplotypes(haplotypes, variants, intra_gap)

    def hap_key(h):
        ids = h.split("#")
        _, b_loc, _, _, _ = variants[int(ids[0])]
        _, e_loc, e_type, e_data, _ = variants[int(ids[-1])]
        end = int(e_loc) + (int(e_data) - 1 if e_type == "D" else 0)
        return (int(b_loc), end)

    haplotypes = sorted(haplotypes, key=hap_key)
    for h_i, h in enumerate(haplotypes):
        ids = h.split("#")
        chrom, b_loc, _, _, _ = variants[int(ids[0])]
        _, e_loc, e_type, e_data, _ = variants[int(ids[-1])]
        h_begin = int(b_loc)
        h_end = int(e_loc) + (int(e_data) - 1 if e_type == "D" else 0)
        h_new_begin = h_begin
        for h_j in range(h_i - 1, -1, -1):
            hc = haplotypes[h_j].split("#")
            _, hc_loc, hc_type, hc_data, _ = variants[int(hc[-1])]
            hc_end = int(hc_loc) + (int(hc_data) - 1
                                    if hc_type == "D" else 0)
            if hc_end + inter_gap < h_begin:
                break
            if h_new_begin > hc_end:
                h_new_begin = hc_end
        names = ",".join(variants[int(i)][4]["id2"] for i in ids)
        hap_out.write("ht%d\t%s\t%d\t%d\t%s\n"
                      % (num_haplotypes, chrom, h_new_begin, h_end, names))
        num_haplotypes += 1
    return num_haplotypes


def generate_haplotypes_ucsc(snp_out, hap_out, variants, inter_gap,
                             intra_gap, num_haplotypes):
    """UCSC-dump variant grouping (hisat2_extract_snps_haplotypes_UCSC.py:
    123-320): no genotype columns, so common variants (freq >= 0.1) are
    forced onto separate haplotypes; duplicate rs-ids get .N suffixes."""
    variants = sorted(variants, key=functools.cmp_to_key(compare_vars))
    uniq, v = [], 0
    while v < len(variants):
        var = variants[v]
        while v + 1 < len(variants) and \
                compare_vars(var, variants[v + 1]) == 0:
            v += 1
        uniq.append(var)
        v += 1
    variants = uniq

    counts = {}
    for var in variants:
        counts[var[4]["id"]] = counts.get(var[4]["id"], 0) + 1
    dup = {i for i, c in counts.items() if c > 1}
    seen = {}
    for var in variants:
        vid = var[4]["id"]
        if vid in dup:
            k = seen.get(vid, -1) + 1
            seen[vid] = k
            var[4]["id2"] = "%s.%d" % (vid, k)
        else:
            var[4]["id2"] = vid

    # chain variants within inter_gap for the coloring pass
    cmpt = [-1] * len(variants)
    for v in range(len(variants)):
        vc, pos, vtype, data = variants[v][:4]
        if vtype == "D":
            pos += data - 1
        for v2 in range(v + 1, len(variants)):
            if cmpt[v2] >= 0:
                continue
            vc2, pos2 = variants[v2][:2]
            if vc != vc2 or pos + inter_gap < pos2:
                break
            cmpt[v2] = v

    genotypes_list = []
    for v, var in enumerate(variants):
        vdic = var[4]
        freq = vdic["freq"]
        used = [False] * 100
        if cmpt[v] >= 0:
            for v2 in range(v - 1, cmpt[v] - 1, -1):
                if not compatible_vars(variants[v2], var) or freq >= 0.1:
                    used[variants[v2][4]["genotype"]] = True
        for i, u in enumerate(used):
            if not u:
                vdic["genotype"] = i
                break
        genotypes_list.append(vdic["genotype"])

    for chrom, pos, vtype, data, vdic in variants:
        tname = {"S": "single", "D": "deletion", "I": "insertion"}[vtype]
        snp_out.write("%s\t%s\t%s\t%s\t%s\n"
                      % (vdic["id2"], tname, chrom, pos, data))

    maxg = max(genotypes_list)
    haps = [""] * (maxg + 1)
    for i, num in enumerate(genotypes_list):
        haps[num] = str(i) if not haps[num] else haps[num] + "#%d" % i
    haplotypes = _split_haplotypes(set(haps), variants, intra_gap)

    def hap_key(h):
        ids = h.split("#")
        _, b_loc, _, _, _ = variants[int(ids[0])]
        _, e_loc, e_type, e_data, _ = variants[int(ids[-1])]
        end = int(e_loc) + (int(e_data) - 1 if e_type == "D" else 0)
        return (int(b_loc), end)

    haplotypes = sorted(haplotypes, key=hap_key)
    for h_i, h in enumerate(haplotypes):
        ids = h.split("#")
        chrom, b_loc, _, _, _ = variants[int(ids[0])]
        _, e_loc, e_type, e_data, _ = variants[int(ids[-1])]
        h_begin = int(b_loc)
        h_end = int(e_loc) + (int(e_data) - 1 if e_type == "D" else 0)
        h_new_begin = h_begin
        for h_j in range(h_i - 1, -1, -1):
            hc = haplotypes[h_j].split("#")
            _, hc_loc, hc_type, hc_data, _ = variants[int(hc[-1])]
            hc_end = int(hc_loc) + (int(hc_data) - 1
                                    if hc_type == "D" else 0)
            if hc_end + inter_gap < h_begin:
                break
            if h_new_begin > hc_end:
                h_new_begin = hc_end
        names = ",".join(variants[int(i)][4]["id2"] for i in ids)
        hap_out.write("ht%d\t%s\t%d\t%d\t%s\n"
                      % (num_haplotypes, chrom, h_new_begin, h_end, names))
        num_haplotypes += 1
    return num_haplotypes


_RC = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N", "-": "-"}


def extract_snps_haplotypes_ucsc(genome_file, snp_files, base_fname,
                                 inter_gap=30, intra_gap=50):
    """UCSC dbSNP dump -> .snp/.haplotype (behavioral port of
    hisat2_extract_snps_haplotypes_UCSC.py main, :329-520)."""
    import re
    chr_dic = read_genome(genome_file)
    snp_out = open(base_fname + ".snp", "w")
    hap_out = open(base_fname + ".haplotype", "w")
    num_haplotypes = 0
    for fname in snp_files:
        op = gzip.open if fname.endswith(".gz") else open
        snp_list = []
        ids_seen = set()
        prev_chr, curr_right = "", -1
        with op(fname, "rt") as f:
            for line in f:
                if not line or line.startswith("#"):
                    continue
                fields = line.strip().split("\t")
                if len(fields) < 12:
                    continue
                (_id, chrom, start, end, rs_id, score, strand, _refNCBI,
                 _refUCSC, observed, mol_type, class_type) = fields[:12]
                freqs = fields[-2].split(",")[:-1]
                if freqs:
                    try:
                        float(freqs[0])
                    except ValueError:
                        freqs = []
                start, end = int(start), int(end)
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
                    num_haplotypes = generate_haplotypes_ucsc(
                        snp_out, hap_out, snp_list, inter_gap, intra_gap,
                        num_haplotypes)
                    snp_list = []
                alleles = observed.upper().split("/")
                if not freqs:
                    freqs = ["0.0"] * len(alleles)
                if strand == "-":
                    alleles = ["".join(_RC.get(c, "N") for c in a[::-1])
                               for a in alleles]
                if class_type == "single":
                    ref_base = chr_seq[start].upper()
                    if ref_base not in alleles:
                        continue
                    for a in range(min(len(alleles), len(freqs))):
                        al = alleles[a]
                        if al not in "ACGT" or len(al) != 1 \
                                or al == ref_base:
                            continue
                        snp_list.append([chrom, start, "S", al,
                                         {"id": rs_id,
                                          "freq": float(freqs[a])}])
                elif class_type == "deletion":
                    if start > 0 and chr_seq[start - 1].upper() not in \
                            "ACGT":
                        continue
                    if len(alleles) != 2 or len(alleles) != len(freqs):
                        continue
                    if alleles[0] == "-":
                        freq = float(freqs[1])
                    elif alleles[1] == "-":
                        freq = float(freqs[0])
                    else:
                        continue
                    snp_list.append([chrom, start, "D", end - start,
                                     {"id": rs_id, "freq": freq}])
                else:
                    if start > 0 and chr_seq[start - 1].upper() not in \
                            "ACGT":
                        continue
                    for a in range(min(len(alleles), len(freqs))):
                        al = alleles[a]
                        if al == "-" or not al:
                            continue
                        if re.match("^[ACGT]+$", al):
                            snp_list.append([chrom, start, "I", al,
                                             {"id": rs_id,
                                              "freq": float(freqs[a])}])
                curr_right = max(curr_right, end) if prev_chr == chrom \
                    else end
                prev_chr = chrom
        if snp_list:
            num_haplotypes = generate_haplotypes_ucsc(
                snp_out, hap_out, snp_list, inter_gap, intra_gap,
                num_haplotypes)
    snp_out.close()
    hap_out.close()


def extract_snps_haplotypes(genome_file, vcf_files, base_fname,
                            inter_gap=30, intra_gap=50, only_rs=False):
    chr_dic = read_genome(genome_file)
    snp_out = open(base_fname + ".snp", "w")
    hap_out = open(base_fname + ".haplotype", "w")
    num_haplotypes = 0
    for vcf_fname in vcf_files:
        op = gzip.open if vcf_fname.endswith(".gz") else open
        num_genomes = 0
        variants = []
        prev_var_id, prev_chr, prev_pos = "", "", -1
        curr_right = -1
        with op(vcf_fname, "rt") as f:
            for line in f:
                if line.startswith("##"):
                    continue
                fields = line.rstrip("\n").split("\t")
                if line.startswith("#"):
                    num_genomes = max(len(fields) - 9, 0)
                    continue
                chrom, pos, var_id, ref_allele, alt_alleles = fields[:5]
                genotypes = fields[9:] if len(fields) >= 10 else []
                if prev_chr != chrom:
                    curr_right = -1
                if only_rs and not var_id.startswith("rs"):
                    continue
                if ";" in var_id or var_id == prev_var_id:
                    continue
                if chrom not in chr_dic:
                    continue
                pos = int(pos) - 1
                if pos == prev_pos:
                    continue
                if variants and (curr_right + inter_gap < pos
                                 or prev_chr != chrom):
                    num_haplotypes = generate_haplotypes(
                        snp_out, hap_out, variants, inter_gap, intra_gap,
                        num_genomes, num_haplotypes)
                    variants = []
                for v, var in enumerate(extract_vars(
                        chr_dic[chrom], chrom, pos, ref_allele,
                        alt_alleles, var_id)):
                    # NOTE: the reference compares genotype digits against
                    # the index within the FILTERED variant list (v+1), not
                    # the VCF allele number — replicated as-is
                    cnv = []
                    for g in genotypes:
                        cnv.append("1" if g[0:1] == str(v + 1) else "0")
                        cnv.append("1" if g[2:3] == str(v + 1) else "0")
                    if cnv and "1" not in cnv:
                        continue
                    var[4]["genotype"] = "".join(cnv) if cnv else None
                    if var[4]["genotype"] is None:
                        del var[4]["genotype"]
                    variants.append(var)
                    right = var[1]
                    if var[2] == "D":
                        right += var[3] - 1
                    curr_right = max(curr_right, right)
                prev_var_id, prev_chr, prev_pos = var_id, chrom, pos
            if variants:
                num_haplotypes = generate_haplotypes(
                    snp_out, hap_out, variants, inter_gap, intra_gap,
                    num_genomes, num_haplotypes)
    snp_out.close()
    hap_out.close()


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        prog="hisat2-tpu extract-snps-haplotypes",
        description="Extract SNPs and haplotypes from VCF file(s)")
    p.add_argument("genome", help="reference FASTA")
    p.add_argument("vcf", help="comma-separated VCF file(s) (.gz ok)")
    p.add_argument("base", help="output basename (.snp/.haplotype)")
    p.add_argument("--inter-gap", type=int, default=30)
    p.add_argument("--intra-gap", type=int, default=50)
    p.add_argument("--only-rs", action="store_true")
    p.add_argument("--format", choices=["vcf", "ucsc"], default="vcf",
                   help="input flavor: VCF or a UCSC dbSNP dump")
    args = p.parse_args(argv)
    if args.format == "ucsc":
        extract_snps_haplotypes_ucsc(args.genome, args.vcf.split(","),
                                     args.base, args.inter_gap,
                                     args.intra_gap)
    else:
        extract_snps_haplotypes(args.genome, args.vcf.split(","), args.base,
                                args.inter_gap, args.intra_gap,
                                args.only_rs)
    return 0
