"""Generate the graph-DNA CLI corpus tests/data/gdna_*.

    python tests/data/make_gdna.py            # writes the four files below

- gdna_genome.fa.gz: two seeded random chromosomes (40 kbp and 20 kbp) with
  a 300 bp block repeated three times (multimaps);
- gdna.snp: a hisat2 .snp catalog of 60 variants, SNVs, deletions and
  insertions in turn (indels 1-3 bp, a few up to 8 bp);
- gdna_reads.fa: 200 reads of 100 bp; most carry one or two catalog
  alleles, some sequencing errors, a quarter are reverse-complemented;
- gdna_ref.sam.gz: the oracle, written by the JAX package on the CPU
  (`python -m hisat2_tpu build --snp gdna.snp` then `python -m hisat2_tpu
  align --no-spliced-alignment -f`); it is hisat2_tpu's output, not
  hisat2's.  Only numpy is needed for the first three files.
"""

import gzip
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ACGT = "ACGT"
ALIGN_ARGS = ["--no-spliced-alignment", "-f"]


def make(rng):
    chroms = {"gA": rng.integers(0, 4, 40000).astype(np.uint8),
              "gB": rng.integers(0, 4, 20000).astype(np.uint8)}
    blk = chroms["gA"][3000:3300].copy()
    chroms["gA"][21000:21300] = blk
    chroms["gB"][7000:7300] = blk
    cat, lines = [], []
    k = 0
    for name, g in chroms.items():
        nvar = 40 if name == "gA" else 20
        for p in sorted(rng.choice(np.arange(500, len(g) - 500), nvar,
                                   replace=False)):
            p = int(p)
            t = k % 3
            if t == 0:
                alt = (int(g[p]) + int(rng.integers(1, 4))) % 4
                lines.append(f"rsg{k}\tsingle\t{name}\t{p}\t{ACGT[alt]}")
                cat.append((name, "S", p, alt))
            elif t == 1:
                ln = int(rng.integers(1, 4)) if k % 5 else int(
                    rng.integers(4, 9))
                lines.append(f"rsg{k}\tdeletion\t{name}\t{p}\t{ln}")
                cat.append((name, "D", p, ln))
            else:
                ln = int(rng.integers(1, 4)) if k % 5 else int(
                    rng.integers(4, 9))
                ins = rng.integers(0, 4, ln).astype(np.uint8)
                lines.append(f"rsg{k}\tinsertion\t{name}\t{p}\t"
                             + "".join(ACGT[c] for c in ins))
                cat.append((name, "I", p, ins))
            k += 1
    reads = []
    L = 100
    for i in range(200):
        name, kind, p, v = cat[i % len(cat)]
        g = chroms[name]
        off = int(rng.integers(10, L - 10))
        s = max(0, min(p - off, len(g) - L - 10))
        if i % 8 == 7:                          # no allele
            r = g[s:s + L].copy()
        elif kind == "S":
            r = g[s:s + L].copy()
            r[p - s] = v
        elif kind == "D":
            r = np.concatenate([g[s:p], g[p + v:s + L + v]])
        else:
            r = np.concatenate([g[s:p], v, g[p:s + L]])[:L]
        r = r[:L].copy()
        if i % 6 == 1:
            for q in rng.choice(L, int(rng.integers(1, 3)), replace=False):
                r[q] = (r[q] + int(rng.integers(1, 4))) % 4
        if i % 4 == 2:
            r = (3 - r)[::-1]
        reads.append((f"gr{i}_{name}_{kind}{p}", r))
    return chroms, lines, reads


def main():
    rng = np.random.default_rng(2026)
    chroms, lines, reads = make(rng)
    with gzip.open(os.path.join(HERE, "gdna_genome.fa.gz"), "wt") as f:
        for name, g in chroms.items():
            f.write(f">{name}\n")
            s = "".join(ACGT[c] for c in g)
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60] + "\n")
    with open(os.path.join(HERE, "gdna.snp"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(HERE, "gdna_reads.fa"), "w") as f:
        for name, r in reads:
            f.write(f">{name}\n{''.join(ACGT[c] for c in r)}\n")
    repo = os.path.dirname(os.path.dirname(HERE))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory() as d:
        with gzip.open(os.path.join(HERE, "gdna_genome.fa.gz"), "rb") as f, \
                open(os.path.join(d, "g.fa"), "wb") as o:
            o.write(f.read())
        py = [sys.executable, "-m", "hisat2_tpu"]
        subprocess.run(py + ["build", "--snp",
                             os.path.join(HERE, "gdna.snp"), "g.fa", "idx"],
                       cwd=d, env=env, check=True)
        subprocess.run(py + ["align"] + ALIGN_ARGS
                       + ["-x", "idx", "-U",
                          os.path.join(HERE, "gdna_reads.fa"), "-S",
                          "out.sam"], cwd=d, env=env, check=True)
        with open(os.path.join(d, "out.sam"), "rb") as f, gzip.open(
                os.path.join(HERE, "gdna_ref.sam.gz"), "wb") as o:
            o.write(b"".join(x for x in f if not x.startswith(b"@")))


if __name__ == "__main__":
    main()
