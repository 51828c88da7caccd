"""Genotype-genome construction: splice typed-locus backbones into the
reference genome and rebase their variant/haplotype databases.

Behavioral equivalent of hisat2's hisatgenotype_build_genome.py
(build_genotype_genome, lines 41-359): for every gene in each database's
.locus file, the genomic interval [left, right] is REPLACED by the
(usually longer) backbone consensus; downstream coordinates shift by the
running length difference `off`; per-gene variants, haplotypes, and
links renumber into one global hvN/htN namespace; genome-wide common
variants that fall outside every replaced interval pass through with the
shift applied.

Outputs (<base>.fa .locus .snp .index.snp .haplotype .link .coord
.clnsig .partial) feed `hisat2_tpu build --snp --haplotype` directly —
the TPU graph index replaces the reference's hisat2-build subprocess.

Copied verbatim from hisat2_tpu/genotype/build_genome.py; only the
imports, and the location of the hisat2 sources in citations, are
rewritten.
"""

from __future__ import annotations

import sys
from functools import cmp_to_key


def read_genome(fobj):
    chr_dic, chr_names, chr_full_names = {}, [], []
    name, full, seq = "", "", []
    for line in fobj:
        if line.startswith(">"):
            if name:
                chr_dic[name] = "".join(seq)
            full = line.strip()[1:]
            name = full.split()[0]
            chr_names.append(name)
            chr_full_names.append(full)
            seq = []
        else:
            seq.append(line.strip())
    if name:
        chr_dic[name] = "".join(seq)
    return chr_dic, chr_names, chr_full_names


def read_allele_sequences(fname):
    out, name, seq = {}, "", []
    for line in open(fname):
        if line.startswith(">"):
            if name and name not in out:
                out[name] = "".join(seq)
            name, seq = line.strip()[1:], []
        else:
            seq.append(line.strip())
    if name and name not in out:
        out[name] = "".join(seq)
    return out


def read_variants(fname):
    """{backbone: [[pos, type, data, var_id], ...]} (deletion data int)."""
    out = {}
    for line in open(fname):
        var_id, vtype, bb, left, data = line.split()
        if vtype == "deletion":
            data = int(data)
        out.setdefault(bb, []).append([int(left), vtype, data, var_id])
    return out


def read_haplotypes(fname):
    out = {}
    for line in open(fname):
        _ht, bb, left, right, ids = line.split()
        out.setdefault(bb, []).append([int(left), int(right),
                                       ids.split(",")])
    return out


def read_links(fname):
    return [line.rstrip("\n").split("\t")
            for line in open(fname) if line.strip()]


def read_clnsig(fname):
    """{var_id: (gene, clnsig)} from a 3-column file."""
    out = {}
    for line in open(fname):
        parts = line.rstrip("\n").split("\t")
        if len(parts) >= 3:
            out[parts[0]] = (parts[1], parts[2])
    return out


def build_genotype_genome(genome_fa, database_list, base,
                          commonvar_base=None, clnsig_fname=None,
                          out=sys.stderr):
    """database_list entries are extract_vars output bases (each with
    .locus/.snp/.index.snp/.haplotype/.link/_backbone.fa/.partial).
    commonvar_base: optional genome-coordinate .snp/.haplotype pair to
    merge (the reference's UCSC common-SNP path)."""
    chr_dic, chr_names, chr_full_names = read_genome(open(genome_fa))

    genotype_vars, genotype_haplotypes = {}, {}
    if commonvar_base:
        for bb, vs in read_variants(f"{commonvar_base}.snp").items():
            genotype_vars[bb] = vs
        for bb, hs in read_haplotypes(
                f"{commonvar_base}.haplotype").items():
            genotype_haplotypes[bb] = hs
    clnsig = read_clnsig(clnsig_fname) if clnsig_fname else {}

    genotype_genes = {}
    for database in database_list:
        for line in open(f"{database}.locus"):
            name, chrom, left, right, length, exon_str, strand = \
                line.split()
            if chrom not in chr_names:
                continue
            genotype_genes.setdefault(chrom, []).append(
                [int(left), int(right), int(length), name, database,
                 exon_str, strand])

    files = {ext: open(f"{base}.{ext}", "w")
             for ext in ("locus", "snp", "index.snp", "haplotype",
                         "link", "coord", "clnsig")}
    genome_out = open(f"{base}.fa", "w")
    var_num = haplotype_num = 0

    for c, chrom in enumerate(chr_names):
        chr_seq = chr_dic[chrom]
        chr_genes = sorted(genotype_genes.get(chrom, []),
                           key=lambda g: (g[0], g[1], g[2]))
        cvars = genotype_vars.get(chrom, [])
        chts = genotype_haplotypes.get(chrom, [])
        vi = hti = 0
        off = 0
        prev_right = 0
        out_parts = []
        out_len = 0

        def flush_common(left, right, vi, hti, haplotype_num):
            """Pass through common vars/haplotypes strictly left of the
            next replaced interval; drop ones overlapping it (reference
            add_vars, build_genome.py:183-221)."""
            while vi < len(cvars):
                v_left, v_type, v_data, v_id = cvars[vi]
                v_right = v_left + (v_data if v_type == "deletion"
                                    else 0)
                if v_right > right:
                    break
                if v_right >= left:
                    vi += 1
                    continue
                line = (f"{v_id}\t{v_type}\t{chrom}\t{v_left + off}"
                        f"\t{v_data}")
                print(line, file=files["snp"])
                print(line, file=files["index.snp"])
                if v_id in clnsig:
                    g, sig = clnsig[v_id]
                    print(f"{v_id}\t{g}\t{sig}", file=files["clnsig"])
                vi += 1
            while hti < len(chts):
                h_left, h_right, h_vars = chts[hti]
                if h_right > right:
                    break
                if h_right >= left:
                    hti += 1
                    continue
                print(f"ht{haplotype_num}\t{chrom}\t{h_left + off}"
                      f"\t{h_right + off}\t{','.join(h_vars)}",
                      file=files["haplotype"])
                hti += 1
                haplotype_num += 1
            return vi, hti, haplotype_num

        for left, right, length, name, family, exon_str, strand \
                in chr_genes:
            vi, hti, haplotype_num = flush_common(
                left, right, vi, hti, haplotype_num)
            allele_seqs = read_allele_sequences(f"{family}_backbone.fa")
            allele_vars = read_variants(f"{family}.snp")
            allele_index_vars = read_variants(f"{family}.index.snp")
            allele_haplotypes = read_haplotypes(f"{family}.haplotype")
            links = read_links(f"{family}.link")
            if name not in allele_seqs or name not in allele_vars or \
                    name not in allele_haplotypes:
                continue
            allele_seq = allele_seqs[name]
            if left < prev_right:
                print(f"Warning: skipping {name} ...", file=out)
                continue
            assert length == len(allele_seq) and left < right

            if prev_right < left:
                out_parts.append(chr_seq[prev_right:left])
                out_len += left - prev_right

            fam_name = family.split("/")[-1].upper()
            print(f"{fam_name}\t{name}\t{chrom}\t{out_len}"
                  f"\t{out_len + length - 1}\t{exon_str}\t{strand}",
                  file=files["locus"])
            print(f"{chrom}\t{out_len}\t{left}\t{right - left + 1}",
                  file=files["coord"])
            out_parts.append(allele_seq)
            out_len += length

            index_ids = {v[3] for v in allele_index_vars.get(name, [])}
            var2new = {}
            for v_left, v_type, v_data, v_id in allele_vars[name]:
                new_id = f"hv{var_num}"
                var2new[v_id] = new_id
                line = (f"{new_id}\t{v_type}\t{chrom}"
                        f"\t{v_left + left + off}\t{v_data}")
                print(line, file=files["snp"])
                if v_id in index_ids:
                    print(line, file=files["index.snp"])
                var_num += 1
            for h_left, h_right, h_vars in allele_haplotypes[name]:
                ids = ",".join(var2new[v] for v in h_vars)
                print(f"ht{haplotype_num}\t{chrom}"
                      f"\t{h_left + left + off}\t{h_right + left + off}"
                      f"\t{ids}", file=files["haplotype"])
                haplotype_num += 1
            for v_id, allele_names in links:
                if v_id in var2new:
                    print(f"{var2new[v_id]}\t{allele_names}",
                          file=files["link"])

            off += length - (right - left + 1)
            prev_right = right + 1

        vi, hti, haplotype_num = flush_common(
            sys.maxsize, sys.maxsize, vi, hti, haplotype_num)
        print(f"{chrom}\t{out_len}\t{prev_right}"
              f"\t{len(chr_seq) - prev_right}", file=files["coord"])
        out_parts.append(chr_seq[prev_right:])
        out_seq = "".join(out_parts)
        assert len(out_seq) == len(chr_seq) + off
        print(f">{chr_full_names[c]}", file=genome_out)
        for s in range(0, len(out_seq), 60):
            print(out_seq[s:s + 60], file=genome_out)

    genome_out.close()
    for f in files.values():
        f.close()

    with open(f"{base}.partial", "w") as pf:
        for database in database_list:
            try:
                lines = open(f"{database}.partial")
            except FileNotFoundError:
                continue
            fam = database.split("/")[-1].upper()
            for line in lines:
                if line.strip():
                    print(f"{fam}\t{line.strip()}", file=pf)
    return var_num, haplotype_num
