"""MSA -> backbone + variant/haplotype/link file extraction.

Behavioral equivalent of hisat2's hisatgenotype_extract_vars.py
(extract_vars, create_consensus_seq, leftshift_deletions, the per-allele
variant walk at lines 683-728, and the haplotype grouping at 1018-1157),
re-written for this repo: the consensus and variant scans are
numpy-vectorized over the allele x column matrix instead of per-character
Python loops, and the GRCh38 remap shells out to OUR aligner (or takes an
explicit locus) instead of a hisat2 subprocess.

Outputs (written by `write_locus_files`, formats identical to the
reference so `hisat2_tpu build --snp/--haplotype` and hisatgenotype-style
downstream tools consume them unchanged):
  <base>_backbone.fa   consensus sequence per gene
  <base>.locus         backbone chr left right len exon_str strand
  <base>.snp           hvN  single|deletion|insertion  backbone pos data
  <base>.index.snp     the subset with freq >= min_var_freq
  <base>.snp.freq      hvN <freq%%>
  <base>.link          hvN allele names carrying the variant
  <base>.haplotype     htN backbone begin end hv_i,hv_j,...
  <base>_sequences.fa  every allele sequence, gaps removed
  <base>.partial       allele names marked partial in the .dat file

Copied verbatim from hisat2_tpu/genotype/vars.py; only the imports, the
aligner (TorchAligner on the device the caller names), and the location
of the hisat2 sources in citations, are rewritten.
"""

from __future__ import annotations

import os
from functools import cmp_to_key

import numpy as np

_COMP = {"A": "T", "C": "G", "G": "C", "T": "A", ".": ".", "E": "E",
         "N": "N"}


def reverse_complement(seq: str) -> str:
    return "".join(_COMP.get(c, "N") for c in reversed(seq))


def read_msf(path, left_ext: str = "", right_ext: str = ""):
    """Parse a GCG MSF multiple alignment (the IMGT distribution format;
    reference read_MSF_file, hisatgenotype_extract_vars.py:406-466).

    -> (names {allele: id}, seqs [aligned strings])"""
    names, seqs = {}, []
    for line in open(path):
        line = line.strip()
        if not line or not line[0].isalnum():
            continue
        if line.startswith("MSF"):
            continue
        if line.startswith("Name"):
            parts = line.split("\t")[0].split()
            if len(parts) < 2:
                continue
            name = parts[1]
            if name in names:
                continue
            names[name] = len(names)
        else:
            if not seqs:
                seqs = [left_ext for _ in range(len(names))]
            cols = line.split()
            name, fives = cols[0], cols[1:]
            if not fives:
                continue
            if name not in names:
                names[name] = len(names)
            i = names[name]
            if i >= len(seqs):
                seqs.append(left_ext)
            seqs[i] += "".join(fives)
    if right_ext:
        seqs = [s + right_ext for s in seqs]
    return names, seqs


def find_seq_len(seqs) -> int:
    """Majority alignment length (reference find_seq_len)."""
    lens = {}
    for s in seqs:
        lens[len(s)] = lens.get(len(s), 0) + 1
    return max(lens.items(), key=lambda kv: (kv[1], -kv[0]))[0]


_LUT = np.zeros(256, np.int8)
for _i, _c in enumerate("ACGT."):
    _LUT[ord(_c)] = _i
_LUT[ord("E")] = 4


def _seq_matrix(seqs, seq_len):
    """[n_alleles, seq_len] int8 codes (A C G T =0..3, './E'=4); rows of
    the wrong length are excluded from the consensus like the reference
    (create_consensus_seq skips them but still divides by len(seqs))."""
    rows = [s for s in seqs if len(s) == seq_len]
    if not rows:
        return np.zeros((0, seq_len), np.int8)
    buf = np.frombuffer("".join(rows).encode(), np.uint8)
    return _LUT[buf].reshape(len(rows), seq_len)


def create_consensus(seqs, seq_len, min_var_freq, remove_empty=True):
    """Column-frequency consensus (reference create_consensus_seq).

    Returns (consensus str over 'ACGT.', freq [list of {nt: pct}]) and
    MUTATES seqs in place to drop all-empty columns when remove_empty,
    exactly like the reference."""
    mat = _seq_matrix(seqs, seq_len)
    counts = np.zeros((5, seq_len), np.int64)
    for k in range(5):
        counts[k] = (mat == k).sum(axis=0)
    pct = counts * (100.0 / max(len(seqs), 1))
    A, C, G, T, E = pct
    base_idx = pct[:4].argmax(axis=0)
    cons = np.where(E >= 100.0, 5,
                    np.where(E >= 100.0 - min_var_freq, 4, base_idx))
    consensus = "".join("ACGT.E"[i] for i in cons)

    skip_pos = set()
    if "E" in consensus and remove_empty:
        skip_pos = {i for i, c in enumerate(consensus) if c == "E"}
        keep = [i for i in range(seq_len) if i not in skip_pos]
        for si in range(len(seqs)):
            s = seqs[si]
            seqs[si] = "".join(s[i] for i in keep if i < len(s))
        consensus = consensus.replace("E", "")

    freq = []
    for j in range(seq_len):
        if j in skip_pos:
            continue
        d = {}
        for k in range(5):
            if pct[k, j] > 0.0:
                d["ACGT."[k]] = pct[k, j]
        freq.append(d)
    return consensus, freq


def leftshift_deletions(backbone: str, seq: str) -> str:
    """Shift each gap run left over equal flanking bases (reference
    leftshift_deletions, extract_vars.py:136-187)."""
    if len(seq) != len(backbone):
        return seq
    s = list(seq)
    n = len(s)
    i = 0
    while i < n and s[i] not in "ACGT":
        i += 1
    while i < n:
        if s[i] != ".":
            i += 1
            continue
        j = i + 1
        while j < n and s[j] == ".":
            j += 1
        if j >= n:
            break
        while i > 0 and s[i - 1] in "ACGT" and backbone[j - 1] in "ACGT":
            if s[i - 1] != backbone[j - 1]:
                break
            s[j - 1] = s[i - 1]
            s[i - 1] = "."
            i -= 1
            j -= 1
        i = j
        while i < n and s[i] not in "ACGT":
            i += 1
    return "".join(s)


def call_allele_variants(backbone: str, allele_seq: str):
    """One allele vs the backbone -> [(pos, 'M'|'D'|'I', data, bb_col)]
    where pos is in BACKBONE (gap-free) coordinates and bb_col the MSA
    column (for frequency lookups).  Mirrors the reference's two-state
    walk (extract_vars.py:683-728): M closes I/D runs, '.' on one side
    opens/extends a run, pos = column - #backbone-dots-so-far."""
    out = []
    ins = dele = None        # [pos, col, data]
    ndots = 0
    for col, (bc, cc) in enumerate(zip(backbone, allele_seq)):
        if bc != "." and cc != ".":
            if ins is not None:
                out.append((ins[0], "I", ins[2], ins[1]))
                ins = None
            elif dele is not None:
                out.append((dele[0], "D", dele[2], dele[1]))
                dele = None
            if bc != cc:
                out.append((col - ndots, "M", cc, col))
        elif bc == "." and cc != ".":
            if dele is not None:
                out.append((dele[0], "D", dele[2], dele[1]))
                dele = None
            if ins is not None:
                ins[2] += cc
            else:
                ins = [col - ndots, col, cc]
        elif bc != "." and cc == ".":
            if ins is not None:
                out.append((ins[0], "I", ins[2], ins[1]))
                ins = None
            if dele is not None:
                dele[2] += 1
            else:
                dele = [col - ndots, col, 1]
        if bc == ".":
            ndots += 1
    if ins is not None:
        out.append((ins[0], "I", ins[2], ins[1]))
    elif dele is not None:
        out.append((dele[0], "D", dele[2], dele[1]))
    return out


def _var_freq(kind, data, bb_col, backbone_freq):
    """Variant population frequency from the consensus column stats
    (reference insertVar, extract_vars.py:645-678)."""
    if kind == "M":
        return backbone_freq[bb_col].get(data, 0.0)
    if kind == "D":
        return min(backbone_freq[bb_col + d].get(".", 0.0)
                   for d in range(int(data)))
    return min(backbone_freq[bb_col + i].get(data[i], 0.0)
               for i in range(len(data)))


def cmp_var_key(a, b):
    """Variant ordering: locus, then I < M < D, then data
    (reference cmp_varKey)."""
    al, at, ad = a.split("-", 2)
    bl, bt, bd = b.split("-", 2)
    al, bl = int(al), int(bl)
    if al != bl:
        return al - bl
    if at != bt:
        order = {"I": 0, "M": 1, "D": 2}
        return order[at] - order[bt]
    if at in "MI":
        return -1 if ad < bd else (1 if ad > bd else 0)
    return int(ad) - int(bd)


def extract_gene_vars(names, seqs, ref_allele, min_var_freq=0.0,
                      leftshift=True, remove_empty=True):
    """Consensus + per-allele variant calls for one gene.

    -> dict(backbone=str, freq=[{nt: pct}], vars={key: [freq, [names]]},
            allele_vars={name: [keys]}, seqs=the possibly-shrunk MSA)"""
    seqs = list(seqs)
    seq_len = find_seq_len(seqs)
    backbone, freq = create_consensus(seqs, seq_len, min_var_freq,
                                      remove_empty)
    if remove_empty:
        seq_len = find_seq_len(seqs)
    if leftshift:
        for i in range(len(seqs)):
            seqs[i] = leftshift_deletions(backbone, seqs[i])
        backbone, freq = create_consensus(seqs, seq_len, min_var_freq,
                                          remove_empty)
        seq_len = find_seq_len(seqs)

    variants = {}
    for name, idx in names.items():
        if idx >= len(seqs) or len(seqs[idx]) != seq_len:
            continue
        for pos, kind, data, col in call_allele_variants(backbone,
                                                         seqs[idx]):
            key = (f"{pos}-{kind}-{data}" if kind in "MI"
                   else f"{pos}-{kind}-{int(data)}")
            if key not in variants:
                variants[key] = [_var_freq(kind, data, col, freq), []]
            variants[key][1].append(name)

    allele_vars = {}
    for key, (_f, anames) in variants.items():
        for nm in anames:
            allele_vars.setdefault(nm, []).append(key)
    for nm in allele_vars:
        allele_vars[nm].sort(key=cmp_to_key(cmp_var_key))
    return dict(backbone=backbone, freq=freq, vars=variants,
                allele_vars=allele_vars, seqs=seqs, names=names)


def reconstruct(backbone: str, var_keys) -> str:
    """Apply sorted variant keys to the gap-free backbone (the
    reference's sanity check, extract_vars.py:774-826)."""
    s = list(backbone.replace(".", ""))
    diff = 0
    for key in var_keys:
        locus, kind, data = key.split("-", 2)
        locus = int(locus)
        if kind == "M":
            s[locus + diff] = data
        elif kind == "I":
            s[locus + diff:locus + diff] = list(data)
            diff += len(data)
        else:
            del s[locus + diff:locus + diff + int(data)]
            diff -= int(data)
    return "".join(s)


def group_haplotypes(keys, variants, allele_vars, inter_gap, intra_gap,
                     whole_haplotype=False, min_var_freq=0.0):
    """Group index variants into haplotype windows (reference
    extract_vars.py:1018-1157): variants within inter_gap chain into one
    window; each allele's variant subset inside the window is one
    haplotype; haplotypes split at internal gaps > intra_gap; each
    haplotype's begin extends back over earlier overlapping haplotypes.

    -> [(begin, end, [varKey,...])] in emission order."""
    excluded = {k for k in keys if variants[k][0] < min_var_freq}

    def key_end(key):
        locus, kind, data = key.split("-", 2)
        locus = int(locus)
        return locus + int(data) - 1 if kind == "D" else locus

    var_leftmost = int(keys[0].split("-", 1)[0]) if keys else 0
    var_rightmost = max((key_end(k) for k in keys), default=0)

    out = []
    i = 0
    while i < len(keys):
        prev_locus = key_end(keys[i])
        if whole_haplotype:
            j = len(keys)
        else:
            j = i + 1
            while j < len(keys):
                locus2 = int(keys[j].split("-", 1)[0])
                if prev_locus + inter_gap < locus2:
                    break
                prev_locus = locus2
                if keys[i].split("-", 2)[1] == "D":
                    prev_locus += int(keys[i].split("-", 2)[2]) - 1
                j += 1

        alleles = set()
        for k in range(i, j):
            fr, anames = variants[keys[k]]
            if fr < min_var_freq:
                continue
            alleles |= set(anames)
        cur_vars = set(keys[i:j]) - excluded
        haplotypes = set()
        for allele in alleles:
            avs = set(allele_vars[allele]) - excluded
            haplotypes.add("#".join(sorted(cur_vars & avs,
                                           key=cmp_to_key(cmp_var_key))))

        if not whole_haplotype:
            split = set()
            for h in haplotypes:
                hv = h.split("#")
                if len(hv) == 1:
                    split.add(hv[0])
                    continue
                prev_s, s = 0, 1
                while s < len(hv):
                    if key_end(hv[s - 1]) + intra_gap < \
                            int(hv[s].split("-", 1)[0]):
                        split.add("#".join(hv[prev_s:s]))
                        prev_s = s
                    s += 1
                    if s == len(hv):
                        split.add("#".join(hv[prev_s:s]))
            haplotypes = split

        def hap_span(h):
            hv = h.split("#")
            # (begin, end) like the reference's cmp_haplotype; the final
            # string component makes equal-span order deterministic (the
            # reference's py2 sort leaves those in set-iteration order)
            return (int(hv[0].split("-", 1)[0]), key_end(hv[-1]), h)

        hlist = sorted(haplotypes, key=hap_span)
        for h_i, h in enumerate(hlist):
            hv = h.split("#")
            if whole_haplotype:
                h_begin, h_end = var_leftmost, var_rightmost
            else:
                h_begin, h_end = hap_span(h)[:2]
                h_new_begin = h_begin
                for h_j in reversed(range(h_i)):
                    hc_end = key_end(hlist[h_j].split("#")[-1])
                    if hc_end + inter_gap < h_begin:
                        break
                    if h_new_begin > hc_end:
                        h_new_begin = hc_end
                h_begin = h_new_begin
            out.append((h_begin, h_end, hv))
        i = j
    return out


def parse_dat(path):
    """hla.dat (EMBL flat format): -> ({allele: [(exonL, exonR)]},
    [partial allele names]); reference extract_vars.py:339-369 +
    1178-1189."""
    exons, partial = {}, []
    allele, skip_ft = None, True
    for line in open(path):
        if line.startswith("DE"):
            allele = line.split()[1].rstrip(",;")
            if allele.startswith("HLA-"):
                allele = allele[4:]
            if "partial" in line:
                partial.append(allele)
                skip_ft = True
            else:
                skip_ft = False
        elif line.startswith("FT") and not skip_ft:
            if "exon" in line:
                rng = line.split()[2].split("..")
                exons.setdefault(allele, []).append(
                    (int(rng[0]) - 1, int(rng[1]) - 1))
    return exons, partial


def create_map(seq: str):
    """gap-free position -> MSA column (reference create_map)."""
    m = {}
    count = 0
    for i, c in enumerate(seq):
        if c == ".":
            continue
        m[count] = i
        count += 1
    return m


class VarWriter:
    """Accumulates per-gene extraction results and writes the reference's
    9-file output set with global hvN / htN numbering."""

    def __init__(self, base):
        self.base = base
        self.files = {
            ext: open(f"{base}{ext}", "w")
            for ext in ("_backbone.fa", ".locus", ".snp", ".index.snp",
                        ".snp.freq", ".link", ".haplotype",
                        "_sequences.fa")}
        self.num_vars = 0
        self.num_haplotypes = 0

    def add_gene(self, gene, res, locus_line, inter_gap=30, intra_gap=50,
                 whole_haplotype=False, min_var_freq=0.0):
        backbone_name = f"{gene}*BACKBONE"
        bb = res["backbone"].replace(".", "")
        f = self.files["_backbone.fa"]
        print(f">{backbone_name}", file=f)
        for s in range(0, len(bb), 60):
            print(bb[s:s + 60], file=f)
        print(locus_line, file=self.files[".locus"])

        keys = sorted(res["vars"], key=cmp_to_key(cmp_var_key))
        var2id = {}
        tstr = {"M": "single", "I": "insertion", "D": "deletion"}
        for key in keys:
            locus, kind, data = key.split("-", 2)
            freq, anames = res["vars"][key]
            vid = f"hv{self.num_vars}"
            line = f"{vid}\t{tstr[kind]}\t{backbone_name}\t{locus}\t{data}"
            print(line, file=self.files[".snp"])
            if freq >= min_var_freq:
                print(line, file=self.files[".index.snp"])
            print(f"{vid}\t{freq:.2f}", file=self.files[".snp.freq"])
            print(f"{vid}\t{' '.join(sorted(anames))}",
                  file=self.files[".link"])
            var2id[key] = self.num_vars
            self.num_vars += 1

        for begin, end, hv in group_haplotypes(
                keys, res["vars"], res["allele_vars"], inter_gap,
                intra_gap, whole_haplotype, min_var_freq):
            ids = ",".join(f"hv{var2id[v]}" for v in hv)
            print(f"ht{self.num_haplotypes}\t{backbone_name}"
                  f"\t{begin}\t{end}\t{ids}",
                  file=self.files[".haplotype"])
            self.num_haplotypes += 1

        f = self.files["_sequences.fa"]
        for name, idx in res["names"].items():
            if idx >= len(res["seqs"]):
                continue
            seq = res["seqs"][idx].replace(".", "")
            print(f">{name}", file=f)
            for s in range(0, len(seq), 60):
                print(seq[s:s + 60], file=f)

    def write_partial(self, partial_alleles):
        with open(f"{self.base}.partial", "w") as f:
            for name in partial_alleles:
                print(name, file=f)

    def close(self):
        for f in self.files.values():
            f.close()


def extract_vars(db_dir, base, genes=None, inter_gap=30, intra_gap=50,
                 whole_haplotype=False, min_var_freq=0.0, leftshift=True,
                 genome_index=None, locus_map=None, dat_name=None,
                 device="cuda"):
    """Full extraction over a hisatgenotype_db-style directory:
    <db_dir>/msf/<gene>_gen.msf (+ fasta/<gene>_gen.fasta for allele-id
    mapping, <dat_name> for exons/partials).

    locus_map: {gene: (chr, left, right, strand)} placements of the
    reference allele; when absent and genome_index is given, the
    reference-allele sequence is aligned with OUR aligner to locate it
    (the reference shells out to hisat2 against GRCh38,
    extract_vars.py:246-287)."""
    import glob as _glob
    msf_dir = os.path.join(db_dir, "msf")
    gene_names = sorted(
        os.path.basename(p).split("_")[0]
        for p in _glob.glob(os.path.join(msf_dir, "*_gen.msf")))
    if genes:
        gene_names = [g for g in gene_names if g in set(genes)]

    dat_path = dat_name or os.path.join(db_dir, "hla.dat")
    gene_exons, partial = ({}, [])
    if os.path.exists(dat_path):
        gene_exons, partial = parse_dat(dat_path)

    writer = VarWriter(base)
    for gene in gene_names:
        names, seqs = read_msf(os.path.join(msf_dir, f"{gene}_gen.msf"))
        ref_allele = _pick_ref_allele(names, gene)
        placement = (locus_map or {}).get(gene)
        strand = placement[3] if placement else "+"
        if strand == "-":
            for nm in list(names):
                seqs[names[nm]] = reverse_complement(seqs[names[nm]])
        res = extract_gene_vars(names, seqs, ref_allele,
                                min_var_freq=min_var_freq,
                                leftshift=leftshift)
        bb_len = len(res["backbone"].replace(".", ""))
        exon_str = _exon_str(gene_exons.get(ref_allele), res, ref_allele,
                             strand)
        if placement:
            chrom, left, right = placement[0], placement[1], placement[2]
        elif genome_index is not None:
            chrom, left, right = _remap_backbone(
                genome_index, res["seqs"][names[ref_allele]], device)
        else:
            chrom, left, right = gene, 0, bb_len
        if not exon_str:
            exon_str = f"{left}-{right - 1}"
        writer.add_gene(
            gene, res,
            f"{gene}*BACKBONE\t{chrom}\t{left}\t{right - 1}\t{bb_len}"
            f"\t{exon_str}\t{strand}",
            inter_gap, intra_gap, whole_haplotype, min_var_freq)
    writer.write_partial(partial)
    writer.close()
    return writer.num_vars, writer.num_haplotypes


def _pick_ref_allele(names, gene):
    """First allele of the gene in MSF order ('the reference allele' —
    the reference picks the one its GRCh38 remap aligns best; without a
    remap the canonical *01:01:01:01-style first entry is the IMGT
    convention)."""
    for nm in names:
        return nm
    raise ValueError(f"no alleles for {gene}")


def _exon_str(exons, res, ref_allele, strand):
    """Exon ranges in backbone coordinates (reference
    extract_vars.py:894-903: ref-allele MSA map, minus backbone dots)."""
    if not exons:
        return ""
    idx = res["names"].get(ref_allele)
    if idx is None or idx >= len(res["seqs"]):
        return ""
    ref_seq = res["seqs"][idx]
    if strand == "-":
        n = len(ref_seq.replace(".", ""))
        exons = [(n - r - 1, n - l - 1) for l, r in reversed(exons)]  # noqa: E741
    seq_map = create_map(ref_seq)
    bb = res["backbone"]
    dots = np.cumsum(np.frombuffer(bb.encode(), np.uint8) == ord("."))
    parts = []
    for l, r in exons:  # noqa: E741
        if l not in seq_map or r not in seq_map:
            return ""
        cl, cr = seq_map[l], seq_map[r]
        parts.append(f"{cl - int(dots[cl])}-{cr - int(dots[cr])}")
    return ",".join(parts)


def _remap_backbone(genome_index, ref_seq, device="cuda"):
    """Place the (gap-free) reference-allele sequence on the genome with
    our aligner — the tpu-native analog of the reference's hisat2
    subprocess remap."""
    import numpy as _np

    from ..align.host import read_alignments
    from ..align.pipeline import TorchAligner
    from ..index.format import FMIndex

    index = (genome_index if isinstance(genome_index, FMIndex)
             else FMIndex.load(genome_index))
    aligner = TorchAligner(index, device=device)
    seq = ref_seq.replace(".", "")
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    L = min(len(seq), 512)
    codes = _np.zeros((1, L), _np.int64)
    for i, c in enumerate(seq[:L]):
        codes[0, i] = code.get(c, 0)
    quals = _np.full((1, L), 40, _np.int64)
    res = aligner.align_batch(codes, quals, _np.asarray([L]))
    alns = read_alignments(res.raw, 0)
    if not alns:
        return "-", 0, len(seq)
    a = alns[0]
    ref_id = int(a.ref_id) if hasattr(a, "ref_id") else 0
    chrom = index.meta.ref_names[ref_id]
    # Alignment has ref_pos and no pos: an aligned backbone raises
    # AttributeError here, as in the JAX package (its vars.py:623); the
    # port keeps the fault rather than place the backbone by ref_pos
    return chrom, int(a.pos), int(a.pos) + len(seq)
