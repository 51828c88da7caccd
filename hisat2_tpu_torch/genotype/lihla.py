"""Standalone HLA realignment checker — behavioral equivalent of
hisat2's li_hla/main.cpp (484 L).

Consumes the extract-vars outputs (`PREFIX.snp`, `PREFIX.link`,
`PREFIX_backbone.fa`) plus a SAM of reads aligned to the backbone
(with `Zs` catalog-variant tags, as both hisat2 and this package
emit), and independently ranks diploid allele pairs by the li_hla
log-likelihood model:

  - per (alignment, allele) compatibility: every catalog SNP whose
    position the read covers contributes -2 when the allele disagrees
    with the read's observed variant set (Zs); interior deletion
    columns past the first cost 0 unless the read starts inside
    (main.cpp:301-344)
  - per pair (j, k): reads are soft-assigned (0.5/0.5 on ties,
    0.99/0.01 at a one-SNP margin, winner-takes-all beyond), with a
    coverage-bin penalty (-4 per 50 bp bin whose soft-assigned reads
    exceed mean + 4*sqrt(mean)) and a -log10(len_j*len_k) prior
    (main.cpp:349-440)

Used as a CROSS-CHECK of the typing path: the committed fixture test
asserts the checker's top pair matches the MSA-typing report.

Copied verbatim from hisat2_tpu/genotype/lihla.py; only the imports, and
the location of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import math
import sys


def _read_snp_file(path, backbone=None):
    """PREFIX.snp: `id type backbone pos arg` (0-based pos)."""
    snps = []
    name_to_id = {}
    pos_to_snp = {}
    for line in open(path):
        f = line.rstrip("\n").split("\t")
        if len(f) < 5:
            continue
        if backbone and f[2] != backbone:
            continue
        sid = len(snps)
        name_to_id[f[0]] = sid
        typ = f[1][0]
        pos = int(f[3])
        if typ == "d":
            length = int(f[4])
        elif typ == "i":
            length = len(f[4])
        else:
            length = 1
        snps.append((typ, pos, length))
        for p in range(length):
            if typ != "i" or p == 0:
                pos_to_snp.setdefault(pos + p, []).append(sid)
    return snps, name_to_id, pos_to_snp


def _backbone_length(path, backbone):
    n = 0
    inside = False
    for line in open(path):
        if line.startswith(">"):
            nm = line[1:].split()[0].strip()
            if backbone is None or nm == backbone:
                inside = True
            elif inside:
                break
        elif inside:
            n += len(line.strip())
    return n


def _read_link_file(path, name_to_id, snps, backbone_len):
    """PREFIX.link: `snp_id<TAB>allele allele ...`."""
    allele_ids = {}
    allele_names = []
    allele_snps = []
    allele_len = []
    snp_alleles = [set() for _ in snps]
    for line in open(path):
        f = line.rstrip("\n").split("\t")
        if len(f) < 2 or f[0] not in name_to_id:
            continue
        sid = name_to_id[f[0]]
        typ, _pos, length = snps[sid]
        for nm in f[1].split():
            if nm not in allele_ids:
                allele_ids[nm] = len(allele_names)
                allele_names.append(nm)
                allele_snps.append(set())
                allele_len.append(backbone_len)
            aid = allele_ids[nm]
            snp_alleles[sid].add(aid)
            allele_snps[aid].add(sid)
            if typ == "d":
                allele_len[aid] -= length
            elif typ == "i":
                allele_len[aid] += length
    return allele_names, allele_len, snp_alleles


def _iter_sam(path, backbone=None):
    """(ref_start0, ref_end0_incl, zs_snp_names) per mapped record."""
    import re
    cig_re = re.compile(r"(\d+)([MIDNSHP=X])")
    for line in open(path):
        if line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        flag = int(f[1])
        if flag & 0x4:
            continue
        if backbone and f[2].split()[0] != backbone:
            continue
        start = int(f[3]) - 1
        span = sum(int(n) for n, op in cig_re.findall(f[5])
                   if op in "MDN=X")
        zs = []
        for tag in f[11:]:
            if tag.startswith("Zs:Z:"):
                for part in tag[5:].split(","):
                    sub = part.split("|")
                    if len(sub) == 3:
                        zs.append(sub[2])
        yield start, start + span - 1, zs


def rank_pairs(prefix, sam_path, backbone=None, bin_size=50):
    """The li_hla model end-to-end; returns sorted
    [(allele_a, allele_b, loglik)]."""
    snps, name_to_id, pos_to_snp = _read_snp_file(
        prefix + ".snp", backbone)
    bb_len = _backbone_length(prefix + "_backbone.fa", backbone)
    allele_names, allele_len, snp_alleles = _read_link_file(
        prefix + ".link", name_to_id, snps, bb_len)
    n_allele = len(allele_names)
    if not n_allele:
        return []
    # per-alignment compatibility rows (main.cpp:285-344)
    compat = []
    coords = []
    for start, end, zs in _iter_sam(sam_path, backbone):
        hit = set()
        for nm in zs:
            if nm in name_to_id:
                hit.add(name_to_id[nm])
        row = [0.0] * n_allele
        for k in range(start, end + 1):
            for sid in pos_to_snp.get(k, ()):
                typ, pos, _ln = snps[sid]
                tag_present = sid in hit
                # alleles disagreeing with the observation lose 2
                for aid in range(n_allele):
                    has = aid in snp_alleles[sid]
                    if has != tag_present:
                        v = -2.0
                        if typ == "d" and pos < k and k != start:
                            v = 0.0   # interior del column already paid
                        row[aid] += v
        compat.append(row)
        coords.append(start)
    n_aln = len(compat)
    results = []
    for j in range(n_allele):
        for k in range(j, n_allele):
            ll = 0.0
            bin_adjust = 0.0
            avg = (n_aln / float(allele_len[j] + allele_len[k])
                   * bin_size) if allele_len[j] + allele_len[k] else 0.0
            prev_bin = -1
            jbin = kbin = 0.0
            for i in range(n_aln):
                vj, vk = compat[i][j], compat[i][k]
                if vj == vk:
                    wj = wk = 0.5
                elif vj == vk + 2:
                    wj, wk = (1.0, 0.0) if vj == 0 else (0.99, 0.01)
                elif vk == vj + 2:
                    wj, wk = (0.0, 1.0) if vk == 0 else (0.01, 0.99)
                elif vk > vj:
                    wj, wk = 0.0, 1.0
                else:
                    wj, wk = 1.0, 0.0
                lval = wj * vj + wk * vk
                if coords[i] // bin_size != prev_bin:
                    if prev_bin != -1 and (
                            jbin > avg + 4 * math.sqrt(avg)
                            or kbin > avg + 4 * math.sqrt(avg)):
                        bin_adjust -= 4
                    prev_bin = coords[i] // bin_size
                    jbin = kbin = 0.0
                jbin += wj
                kbin += wk
                ll += lval
            ll -= math.log10(max(allele_len[j], 1))
            ll -= math.log10(max(allele_len[k], 1))
            ll += bin_adjust
            results.append((allele_names[j], allele_names[k], ll))
    results.sort(key=lambda r: -r[2])
    return results


def main_check(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog="hisat2-tpu genotype li-hla")
    p.add_argument("prefix", help="extract-vars output prefix "
                                  "(PREFIX.snp/.link/_backbone.fa)")
    p.add_argument("sam", help="SAM of reads aligned to the backbone")
    p.add_argument("-b", "--backbone", default=None)
    p.add_argument("--top", type=int, default=5)
    args = p.parse_args(argv)
    results = rank_pairs(args.prefix, args.sam, args.backbone)
    if not results:
        print("-1 -1 -1")
        return 1
    best = results[0][2]
    shown = 0
    for a, b, ll in results:
        if shown >= args.top and ll != best:
            break
        print(f"{a} {b} {ll:.6f}")
        shown += 1
    return 0


if __name__ == "__main__":
    sys.exit(main_check())
