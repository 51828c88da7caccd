"""Generate the spliced-graph CLI corpus tests/data/gss_*.

    python tests/data/make_gss.py           # writes the files below

- gss_genome.fa.gz: two seeded random chromosomes (gsA, gsB, 60 kbp each)
  with 12 GT..AG introns of 80 bp to 4 kbp planted on each;
- gss.ss: every second intron as a known splice site (hisat2 .ss: the
  last base of the upstream exon and the first of the downstream one,
  0-based), the rest left for novel discovery;
- gss.snp: a hisat2 .snp catalog: per intron one SNV within 10 bp of its
  junction (upstream or downstream exon in turn), a 1-3 bp deletion 25-35
  bp upstream and a 1-3 bp insertion 25-35 bp downstream of the junction,
  and 20 SNVs elsewhere, each with a 2 bp deletion 25-31 bp downstream;
- gss_reads.fa: 192 reads of 100 bp across one intron (clean, carrying
  the intron's junction SNV, its deletion or its insertion, with a
  sequencing error, or with an 8-14 bp anchor on a known intron), and
  unspliced reads (clean, or with a catalog SNV and mostly its
  deletion); a quarter of them
  reverse-complemented;
- the oracles, written by the JAX package on the CPU; they are
  hisat2_tpu's output, not hisat2's:
    gss_ref_snpss.sam.gz  `build --snp gss.snp --ss gss.ss`, `align`
                          (spliced, the default; k = 10 on a graph)
    gss_ref_ss.sam.gz     `build --ss gss.ss`, `align`
    gss_ref_ns.sam.gz     `build --snp gss.snp --ss gss.ss --shard-bp
                          60000 --offrate 4` (two shards, sampled SA),
                          `align -k 10`: config 6's shape
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
N_CHR = 60000
NAMES = ("gsA", "gsB")
LENS = (80, 150, 300, 600, 1200, 4000)
# intron k of a chromosome starts at 2500 + 4700 k
INTRONS = [(2500 + 4700 * k, LENS[k % len(LENS)]) for k in range(12)]
SNP, SS = "gss.snp", "gss.ss"
# oracle name -> (build arguments, extra align arguments)
ORACLES = {
    "gss_ref_snpss": (["--snp", SNP, "--ss", SS], []),
    "gss_ref_ss": (["--ss", SS], []),
    "gss_ref_ns": (["--snp", SNP, "--ss", SS, "--shard-bp", "60000",
                    "--offrate", "4"], ["-k", "10"]),
}


def make(rng):
    chroms, cat, lines, sites = {}, {}, [], []
    for ci, name in enumerate(NAMES):
        g = rng.integers(0, 4, N_CHR).astype(np.uint8)
        for s, ln in INTRONS:
            g[s], g[s + 1] = 2, 3
            g[s + ln - 2], g[s + ln - 1] = 0, 2
        chroms[name] = g
        for k, (s, ln) in enumerate(INTRONS):
            if k % 2 == 0:
                sites.append(f"{name}\t{s - 1}\t{s + ln}\t+")
            d = int(rng.integers(1, 11))
            p = s - d if k % 2 else s + ln + d - 1
            alt = (int(g[p]) + int(rng.integers(1, 4))) % 4
            dp = s - int(rng.integers(25, 36))
            dl = int(rng.integers(1, 4))
            ip = s + ln + int(rng.integers(25, 36))
            ins = rng.integers(0, 4, int(rng.integers(1, 4))).astype(
                np.uint8)
            tag = f"{ci}_{k}"
            lines += [f"rsj{tag}\tsingle\t{name}\t{p}\t{ACGT[alt]}",
                      f"rsd{tag}\tdeletion\t{name}\t{dp}\t{dl}",
                      f"rsi{tag}\tinsertion\t{name}\t{ip}\t"
                      + "".join(ACGT[c] for c in ins)]
            cat[(name, k)] = (p, alt, dp, dl, ip, ins)
    # SNVs away from the junctions, between the introns, each with a 2 bp
    # deletion 25-31 bp downstream
    far = []
    for j in range(20):
        name = NAMES[j % 2]
        k = int(rng.integers(0, len(INTRONS) - 1))
        s, ln = INTRONS[k]
        p = s + ln + 200 + int(rng.integers(0, min(2000, 4300 - ln)))
        alt = (int(chroms[name][p]) + 1) % 4
        fd = p + 25 + j % 7
        lines += [f"rsf{j}\tsingle\t{name}\t{p}\t{ACGT[alt]}",
                  f"rsfd{j}\tdeletion\t{name}\t{fd}\t2"]
        far.append((name, p, alt, fd))
    reads = []
    for i in range(192):
        name = NAMES[i % 2]
        g = chroms[name]
        k = (i // 2) % len(INTRONS)
        s, ln = INTRONS[k]
        p, alt, dp, dl, ip, ins = cat[(name, k)]
        kind = (i // 24) % 8
        x = int(rng.integers(40, L - 40))
        up = g[s - x:s].copy()
        down = g[s + ln:s + ln + L + 4].copy()
        if kind == 1:                   # the junction SNV
            if p < s:
                up[p - (s - x)] = alt
            else:
                down[p - (s + ln)] = alt
        elif kind == 2:                 # the upstream deletion
            up = np.concatenate([g[s - x - dl:dp], g[dp + dl:s]])
        elif kind == 3:                 # the downstream insertion
            down = np.concatenate([g[s + ln:ip], ins, g[ip:ip + L]])
        if kind == 6:                   # a short anchor on a known site
            s, ln = INTRONS[2 * (k // 2)]
            x = int(rng.integers(8, 15))
            r = np.concatenate([g[s - x:s], g[s + ln:s + ln + L]])
        elif kind == 7:                 # unspliced: a catalog SNV and
            fn, fp, fa, fd = far[(i // 2) % len(far)]   # deletion, or clean
            if fn != name:
                fp, fa = s + ln + 300, None
            o = int(rng.integers(10, 40))
            r = g[fp - o:fp - o + L].copy()
            if fa is not None:
                if i % 4 != 2:
                    r = np.concatenate([g[fp - o:fd], g[fd + 2:fd + L]])
                r[o] = fa
        else:
            r = np.concatenate([up, down])
        r = r[:L].copy()
        if kind == 4:                   # one sequencing error
            q = int(rng.integers(0, L))
            r[q] = (r[q] + 1) % 4
        if kind == 5 and i % 4 == 1:    # the SNV and an error
            if p < s:
                r[p - (s - x)] = alt
            q = int(rng.integers(0, L))
            r[q] = (r[q] + 2) % 4
        if i % 4 == 3:
            r = (3 - r)[::-1]
        reads.append((f"q{i}_{name}_{kind}_{s}", r))
    return chroms, lines, sites, reads


def main():
    chroms, lines, sites, reads = make(np.random.default_rng(2028))
    with gzip.open(os.path.join(HERE, "gss_genome.fa.gz"), "wt") as f:
        for name, g in chroms.items():
            f.write(f">{name}\n")
            s = "".join(ACGT[c] for c in g)
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60] + "\n")
    with open(os.path.join(HERE, SNP), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(HERE, SS), "w") as f:
        f.write("\n".join(sites) + "\n")
    with open(os.path.join(HERE, "gss_reads.fa"), "w") as f:
        for name, r in reads:
            f.write(f">{name}\n{''.join(ACGT[c] for c in r)}\n")
    repo = os.path.dirname(os.path.dirname(HERE))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    py = [sys.executable, "-m", "hisat2_tpu"]
    with tempfile.TemporaryDirectory() as d:
        with gzip.open(os.path.join(HERE, "gss_genome.fa.gz"), "rb") as f, \
                open(os.path.join(d, "g.fa"), "wb") as o:
            o.write(f.read())
        for oracle, (bargs, aargs) in ORACLES.items():
            bargs = [os.path.join(HERE, a) if a in (SNP, SS) else a
                     for a in bargs]
            subprocess.run(py + ["build"] + bargs + ["g.fa", oracle],
                           cwd=d, env=env, check=True)
            subprocess.run(py + ["align"] + aargs + [
                "-f", "-x", oracle, "-U", os.path.join(HERE, "gss_reads.fa"),
                "-S", "out.sam"], cwd=d, env=env, check=True)
            with open(os.path.join(d, "out.sam"), "rb") as f, gzip.open(
                    os.path.join(HERE, oracle + ".sam.gz"), "wb") as o:
                o.write(b"".join(x for x in f if not x.startswith(b"@")))


if __name__ == "__main__":
    main()
