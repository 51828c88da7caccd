"""Generate the genotype corpus tests/data/geno_* and its oracles.

    python tests/data/make_geno.py           # writes the files below

The corpus (numpy only, seeded):

- geno_alleles.fa.gz: 40 alleles of a 3,000 bp locus, X*01:01 to
  X*04:10, each with 2-12 private or shared SNVs (tests/test_genotype_msa.py's
  shape);
- geno_locus.msa.fa.gz: an STR locus MSA of 30 alleles, STR*01 to STR*30:
  1,000 bp flanks on both sides of a [TCTA]n[TCTG]m repeat (n 6-14, m
  3-8, gaps at the right end of each block, so the repeat-length
  differences are indels against the backbone) and 1-6 flank SNVs each;
- geno_gg.fa.gz, geno_gg.locus, geno_gg.snp, geno_msa/{GA,GB}.msa.fa.gz:
  a 30 kbp genotype genome (chr1) whose windows [6000, 8000) and [18000,
  20500) are the backbones of genes GA and GB, their .locus file, a .snp
  catalog of 24 variants (SNVs, deletions, insertions) away from the
  loci, and per-gene MSAs of 20 alleles each (4-8 SNVs, every fifth
  allele with a 1-3 bp deletion);
- geno_loci.txt: the `name chr start end` lines of the two loci;
- the reads, 150 bp (120 bp for the STR locus), each a 2:1 diploid mix
  plus background reads:
    geno_reads_alleles.fa.gz  X*01:04 x 120, X*03:08 x 60, 20 random
    geno_reads_msa.fa.gz      STR*06 x 160, STR*20 x 80, 20 random
    geno_reads_gg.fa.gz       GA*05 x 80, GA*12 x 40, GB*03 x 80,
                              GB*16 x 40, 80 from chr1 off the loci

The oracles, written by the JAX package's CLI on the CPU (`python -m
hisat2_tpu ...`) in a directory holding the corpus with every `.gz`
unpacked, and the genotype-genome index built there with `python -m
hisat2_tpu build --snp geno_gg.snp geno_gg.fa geno_gg_idx`; they are
hisat2_tpu's output, and each is the command of RUNS below:
    geno_ref_alleles.txt.gz         genotype --alleles
    geno_ref_msa.txt.gz,            genotype --msa --assembly
    geno_ref_msa.assembly.fa.gz
    geno_ref_run.txt.gz             genotype --run --index
    geno_ref_extract.{GA,GB}.fa.gz  genotype --extract-reads
"""

import contextlib
import gzip
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BASES = np.array(list("ACGTN"))
N_CHR = 30000
LOCI = (("GA", 6000, 8000), ("GB", 18000, 20500))
IDX = "geno_gg_idx"
# oracle -> (genotype arguments, [(file the run writes, oracle file)])
RUNS = {
    "alleles": (["--alleles", "geno_alleles.fa", "-U",
                 "geno_reads_alleles.fa", "--out", "rep_alleles.txt"],
                [("rep_alleles.txt", "geno_ref_alleles.txt")]),
    "msa": (["--msa", "geno_locus.msa.fa", "-U", "geno_reads_msa.fa",
             "--out", "rep_msa.txt", "--assembly", "--out-base",
             "geno_asm", "--top", "4"],
            [("rep_msa.txt", "geno_ref_msa.txt"),
             ("geno_asm.assembly.fa", "geno_ref_msa.assembly.fa")]),
    "run": (["--run", "geno_gg", "--index", IDX, "--msa-dir", "geno_msa",
             "-U", "geno_reads_gg.fa", "--out", "rep_run.txt"],
            [("rep_run.txt", "geno_ref_run.txt")]),
    "extract": (["--extract-reads", "geno_loci.txt", "--index", IDX, "-U",
                 "geno_reads_gg.fa", "--out-base", "ext"],
                [(f"ext.{g}.fa", f"geno_ref_extract.{g}.fa")
                 for g, _, _ in LOCI]),
}
# committed inputs: name -> gzipped in the repo
INPUTS = ("geno_alleles.fa", "geno_locus.msa.fa", "geno_gg.fa",
          "geno_msa/GA.msa.fa", "geno_msa/GB.msa.fa",
          "geno_reads_alleles.fa", "geno_reads_msa.fa", "geno_reads_gg.fa")
PLAIN = ("geno_gg.locus", "geno_gg.snp", "geno_loci.txt")


def stage(d):
    """Unpack the committed corpus into directory d (relative names)."""
    os.makedirs(os.path.join(d, "geno_msa"), exist_ok=True)
    for name in INPUTS:
        with gzip.open(os.path.join(HERE, name + ".gz"), "rb") as f, \
                open(os.path.join(d, name), "wb") as o:
            o.write(f.read())
    for name in PLAIN:
        shutil.copy(os.path.join(HERE, name), os.path.join(d, name))


def _s(a):
    return "".join(BASES[a])


def _reads(rng, seq, n, L, tag, start):
    out = []
    for i in range(n):
        st = int(rng.integers(0, len(seq) - L + 1))
        out.append((f"{tag}{start + i}", seq[st:st + L]))
    return out


def make_alleles(rng):
    L = 3000
    bb = rng.integers(0, 4, L)
    alleles = []
    for a in range(40):
        seq = bb.copy()
        for p in rng.choice(L, int(rng.integers(2, 13)), replace=False):
            seq[p] = (seq[p] + 1 + rng.integers(0, 3)) % 4
        alleles.append((f"X*{a // 10 + 1:02d}:{a % 10 + 1:02d}", _s(seq)))
    reads = (_reads(rng, alleles[3][1], 120, 150, "a", 0)
             + _reads(rng, alleles[27][1], 60, 150, "a", 120)
             + [(f"bg{i}", _s(rng.integers(0, 4, 150))) for i in range(20)])
    return alleles, reads


def make_str_msa(rng):
    fl, fr = rng.integers(0, 4, 1000), rng.integers(0, 4, 1000)
    rows, seqs = [], []
    for a in range(30):
        n, m = int(rng.integers(6, 15)), int(rng.integers(3, 9))
        left, right = fl.copy(), fr.copy()
        for p in rng.choice(2000, int(rng.integers(1, 7)), replace=False):
            side, q = (left, p) if p < 1000 else (right, p - 1000)
            side[q] = (side[q] + 1 + rng.integers(0, 3)) % 4
        blk1 = "TCTA" * n + "----" * (14 - n)
        blk2 = "TCTG" * m + "----" * (8 - m)
        rows.append((f"STR*{a + 1:02d}",
                     _s(left) + blk1 + blk2 + _s(right)))
        seqs.append(_s(left) + "TCTA" * n + "TCTG" * m + _s(right))
    reads = (_reads(rng, seqs[5], 160, 120, "s", 0)
             + _reads(rng, seqs[19], 80, 120, "s", 160)
             + [(f"bg{i}", _s(rng.integers(0, 4, 120))) for i in range(20)])
    return rows, reads


def make_genome(rng):
    chrom = rng.integers(0, 4, N_CHR)
    msas, reads = {}, []
    picks = {"GA": (4, 11), "GB": (2, 15)}
    for gene, lo, hi in LOCI:
        bb = chrom[lo:hi]
        rows = []
        for a in range(20):
            seq = _s(bb)
            seq = np.array(list(seq))
            for p in rng.choice(hi - lo, int(rng.integers(4, 9)),
                                replace=False):
                seq[p] = "ACGT"[("ACGT".index(seq[p]) + 1
                                 + int(rng.integers(0, 3))) % 4]
            if a % 5 == 4:
                p = int(rng.integers(200, hi - lo - 200))
                seq[p:p + int(rng.integers(1, 4))] = "-"
            rows.append((f"{gene}*{a + 1:02d}", "".join(seq)))
        msas[gene] = rows
        for k, n in zip(picks[gene], (80, 40)):
            body = rows[k][1].replace("-", "")
            reads += _reads(rng, body, n, 150, f"{gene}_", len(reads))
    busy = np.zeros(N_CHR, bool)
    for _, lo, hi in LOCI:
        busy[lo - 300:hi + 300] = True
    off = np.flatnonzero(~busy[:N_CHR - 150])
    for i in range(80):
        st = int(rng.choice(off))
        while busy[st:st + 150].any():
            st = int(rng.choice(off))
        reads.append((f"b{i}", _s(chrom[st:st + 150])))
    cand = np.flatnonzero(~busy[500:N_CHR - 500]) + 500
    lines = []
    for k, p in enumerate(sorted(rng.choice(cand, 24, replace=False))):
        p = int(p)
        if k % 3 == 0:
            lines.append(f"gv{k}\tdeletion\tchr1\t{p}\t"
                         f"{int(rng.integers(1, 4))}")
        elif k % 3 == 1:
            alt = (int(chrom[p]) + int(rng.integers(1, 4))) % 4
            lines.append(f"gv{k}\tsingle\tchr1\t{p}\t{BASES[alt]}")
        else:
            lines.append(f"gv{k}\tinsertion\tchr1\t{p}\t"
                         + _s(rng.integers(0, 4, int(rng.integers(1, 4)))))
    return chrom, msas, reads, lines


def write_fa(path, recs, gz=False):
    """One-line FASTA records [(name, str or base codes 0-4)] to path, or
    gzipped without a time stamp to path + ".gz" with gz."""
    text = "".join(f">{nm}\n{s if isinstance(s, str) else _s(s)}\n"
                   for nm, s in recs).encode()
    if gz:
        with gzip.GzipFile(path + ".gz", "wb", mtime=0) as f:
            f.write(text)
    else:
        with open(path, "wb") as f:
            f.write(text)


@contextlib.contextmanager
def recorded_aligners():
    """Every TorchAligner built inside the block, in order (a lite twin
    before its parent): the genotype driver builds its own, and the checks
    on the card hold their steps' kernels against the plain twins."""
    from hisat2_tpu_torch.align import pipeline
    made, base = [], pipeline.TorchAligner

    class Recorded(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    pipeline.TorchAligner = Recorded
    try:
        yield made
    finally:
        pipeline.TorchAligner = base


def main():
    rng = np.random.default_rng(1717)
    alleles, areads = make_alleles(rng)
    msa, mreads = make_str_msa(rng)
    chrom, msas, greads, lines = make_genome(rng)
    os.makedirs(os.path.join(HERE, "geno_msa"), exist_ok=True)
    write_fa(os.path.join(HERE, "geno_alleles.fa"), alleles, True)
    write_fa(os.path.join(HERE, "geno_locus.msa.fa"), msa, True)
    s = _s(chrom)
    write_fa(os.path.join(HERE, "geno_gg.fa"), [("chr1", "".join(
        s[i:i + 60] + "\n" for i in range(0, len(s), 60)).rstrip("\n"))],
        True)
    for gene, rows in msas.items():
        write_fa(os.path.join(HERE, "geno_msa", f"{gene}.msa.fa"), rows,
                 True)
    write_fa(os.path.join(HERE, "geno_reads_alleles.fa"), areads, True)
    write_fa(os.path.join(HERE, "geno_reads_msa.fa"), mreads, True)
    write_fa(os.path.join(HERE, "geno_reads_gg.fa"), greads, True)
    with open(os.path.join(HERE, "geno_gg.locus"), "w") as f:
        for gene, lo, hi in LOCI:
            f.write(f"HLA\t{gene}*01\tchr1\t{lo}\t{hi - 1}\t{lo}-{hi - 1}"
                    "\t+\n")
    with open(os.path.join(HERE, "geno_gg.snp"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(HERE, "geno_loci.txt"), "w") as f:
        for gene, lo, hi in LOCI:
            f.write(f"{gene}\tchr1\t{lo}\t{hi}\n")
    repo = os.path.dirname(os.path.dirname(HERE))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    py = [sys.executable, "-m", "hisat2_tpu"]
    with tempfile.TemporaryDirectory() as d:
        stage(d)
        subprocess.run(py + ["build", "--snp", "geno_gg.snp", "geno_gg.fa",
                             IDX], cwd=d, env=env, check=True)
        for argv, outs in RUNS.values():
            subprocess.run(py + ["genotype"] + argv, cwd=d, env=env,
                           check=True)
            for got, oracle in outs:
                with open(os.path.join(d, got), "rb") as f, gzip.GzipFile(
                        os.path.join(HERE, oracle + ".gz"), "wb",
                        mtime=0) as o:
                    o.write(f.read())


if __name__ == "__main__":
    main()
