"""Generate the genome-scale CLI corpus tests/data/shard_*.

    python tests/data/make_shard.py         # writes the files below

- shard_genome.fa.gz: two seeded random chromosomes (sA, sB, 100 kbp
  each) with GT..AG introns of 80 bp to 15 kbp planted on both, and 2 kbp
  of sA copied into sB (reads there align to both);
- shard_reads.fa: 160 reads of 100 bp: unspliced reads (exact, with
  sequencing errors, an N, a 3 bp deletion or a 2 bp insertion), reads in
  the duplicated block, and reads across one planted intron, on both
  chromosomes and both strands;
- the oracles, written by the JAX package on the CPU; they are
  hisat2_tpu's output, not hisat2's:
    shard_ref_dna.sam.gz  `build --shard-bp 150000 --offrate 4` (two
                          shards, sampled SA), `align
                          --no-spliced-alignment`
    shard_ref_rna.sam.gz  the same index, `align` (spliced, the default)
    shard_ref_or4.sam.gz  `build --offrate 4` (one sampled index), `align
                          --no-spliced-alignment`
  Only numpy is needed for the corpus itself.
"""

import gzip
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ACGT = "ACGT"
L = 100
N_CHR = 100000
INTRONS = [(20000, 200), (40000, 1000), (60000, 5000), (75000, 80),
           (80000, 15000)]
# oracle name -> (build arguments, extra align arguments)
ORACLES = {
    "shard_ref_dna": (["--shard-bp", "150000", "--offrate", "4"],
                      ["--no-spliced-alignment"]),
    "shard_ref_rna": (["--shard-bp", "150000", "--offrate", "4"], []),
    "shard_ref_or4": (["--offrate", "4"], ["--no-spliced-alignment"]),
}


def make(rng):
    chroms = {}
    for name in ("sA", "sB"):
        g = rng.integers(0, 4, N_CHR).astype(np.uint8)
        for s, ln in INTRONS:
            g[s], g[s + 1] = 2, 3
            g[s + ln - 2], g[s + ln - 1] = 0, 2
        chroms[name] = g
    chroms["sB"][30000:32000] = chroms["sA"][8000:10000]
    reads = []
    for i in range(160):
        name = ("sA", "sB")[i % 2]
        g = chroms[name]
        k = (i // 2) % 8
        if k < 3:                       # across one intron
            s, ln = INTRONS[(i // 2) % len(INTRONS)]
            x = int(rng.integers(12, L - 12))
            r = np.concatenate([g[s - x:s], g[s + ln:s + ln + L - x]])
            tag = f"spl:{name}:{s - x}:{ln}"
        elif k == 3:                    # the duplicated block
            p = int(rng.integers(8000, 10000 - L))
            r = chroms["sA"][p:p + L].copy()
            tag = f"dup:sA:{p}"
        else:
            p = int(rng.integers(100, N_CHR - L - 100))
            if k == 4:                  # a 3 bp deletion
                r = np.concatenate([g[p:p + 45], g[p + 48:p + L + 3]])
            elif k == 5:                # a 2 bp insertion
                r = np.concatenate([g[p:p + 50], [1, 3], g[p + 50:p + L - 2]])
            else:
                r = g[p:p + L].copy()
                if k == 6:
                    for q in rng.choice(L, 2, replace=False):
                        r[q] = (r[q] + 1) % 4
                    r[int(rng.integers(0, L))] = 4
            tag = f"dna:{name}:{p}"
        r = r[:L]
        if i % 3 == 0:
            r = np.where(r < 4, 3 - r, 4)[::-1]
        reads.append((f"r{i}_{tag}", "".join("ACGTN"[c] for c in r)))
    return chroms, reads


def main():
    chroms, reads = make(np.random.default_rng(2027))
    with gzip.open(os.path.join(HERE, "shard_genome.fa.gz"), "wt") as f:
        for name, g in chroms.items():
            f.write(f">{name}\n")
            s = "".join(ACGT[c] for c in g)
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60] + "\n")
    with open(os.path.join(HERE, "shard_reads.fa"), "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq}\n")
    repo = os.path.dirname(os.path.dirname(HERE))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    py = [sys.executable, "-m", "hisat2_tpu"]
    with tempfile.TemporaryDirectory() as d:
        with gzip.open(os.path.join(HERE, "shard_genome.fa.gz"), "rb") as f, \
                open(os.path.join(d, "g.fa"), "wb") as o:
            o.write(f.read())
        for oracle, (bargs, aargs) in ORACLES.items():
            idx = "idx_" + "_".join(a.strip("-") for a in bargs)
            if not os.path.exists(os.path.join(d, idx + ".npz")):
                subprocess.run(py + ["build"] + bargs + ["g.fa", idx],
                               cwd=d, env=env, check=True)
            subprocess.run(py + ["align"] + aargs + [
                "-f", "-x", idx, "-U", os.path.join(HERE, "shard_reads.fa"),
                "-S", "out.sam"], cwd=d, env=env, check=True)
            with open(os.path.join(d, "out.sam"), "rb") as f, gzip.open(
                    os.path.join(HERE, oracle + ".sam.gz"), "wb") as o:
                o.write(b"".join(x for x in f if not x.startswith(b"@")))


if __name__ == "__main__":
    main()
