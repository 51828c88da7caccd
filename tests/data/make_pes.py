"""Generate the spliced paired-end CLI corpus tests/data/pes_*.

    python tests/data/make_pes.py           # writes the files below

- pes_genome.fa.gz: two seeded random chromosomes (eA, eB, 100 kbp each)
  with GT..AG introns of 80 bp to 15 kbp planted on both, and the pe
  corpus's shape of repeat: one 120 bp unit planted 6 times on each
  chromosome at 15 kbp spacing (12 copies: more than -k 5 placements on a
  linear index, so a mate inside it needs mate rescue, and at most 4 in a
  rescue window);
- pes.snp: a hisat2 .snp catalog of 24 variants (SNVs, deletions and
  insertions in turn, away from the introns and the repeat);
- pes.ss: every second intron of each chromosome as a known splice site;
- pes_reads_1.fa, pes_reads_2.fa: 160 pairs of 100 bp mates, --fr, with
  fragments of 200-400 bp on the spliced transcript: plain pairs (a third
  carry the catalog's SNV alleles, some sequencing errors and Ns), pairs
  with one mate across a junction, pairs whose mates lie on the two exons
  of an intron of 1-15 kbp (concordant only through the intron length
  the splice-site table knows), pairs with one mate inside the repeat
  (rescued on a linear index), pairs whose mate 2 is random sequence,
  pairs whose mates lie on different chromosomes, and pairs with an
  insert of 2-6 kbp;
- the oracles, written by the JAX package's CLI on the CPU (`python -m
  hisat2_tpu build ... g.fa idx`, then `python -m hisat2_tpu align -f -x
  idx -1 pes_reads_1.fa -2 pes_reads_2.fa -S out.sam` with the extra
  arguments below; the SAM body only); they are hisat2_tpu's output, not
  hisat2's:
    pes_ref_rna.sam.gz        `build`, `align` (spliced, the default)
    pes_ref_snpss.sam.gz      `build --snp pes.snp --ss pes.ss`, `align`
                              (spliced, k = 10 on a graph)
    pes_ref_shard_dna.sam.gz  `build --shard-bp 150000 --offrate 4` (two
                              shards, one chromosome each, sampled SA),
                              `align --no-spliced-alignment`
    pes_ref_nss.sam.gz        the nss corpus (tests/data/nss_*): `build`,
                              `align -1 nss_reads.fa -2 nss_reads.fa`
                              (spliced; every read its own mate)
    shard_ref_pe.sam.gz       the shard corpus (tests/data/shard_*, made
                              by make_shard.py): `build --shard-bp 150000
                              --offrate 4`, `align --no-spliced-alignment
                              -1 shard_reads.fa -2 shard_reads.fa`
  Two runs of the JAX CLI on this corpus fail, and have no oracle: on the
  two shards, spliced (`align`), its paired give-up replay raises
  KeyError: 'h_rounds' (hisat2_tpu/align/driver.py:540); on two shards of
  a graph index (`build --snp pes.snp --ss pes.ss --shard-bp 150000
  --offrate 4`), its first mate rescue raises KeyError: 'snv1'
  (hisat2_tpu/align/pipeline.py:1484).
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
NAMES = ("eA", "eB")
INTRONS = [(12000, 80), (26000, 300), (33000, 1000), (47000, 5000),
           (60000, 15000), (88000, 150)]
LONG = [k for k, (_, ln) in enumerate(INTRONS) if ln >= 1000]
SPOTS = [5000 + 15000 * i for i in range(6)]
EXON = 600          # transcript flank on each side of an intron
SNP, SS = "pes.snp", "pes.ss"
SHARDS = ["--shard-bp", "150000", "--offrate", "4"]
# oracle name -> (corpus, build arguments, extra align arguments)
ORACLES = {
    "pes_ref_rna": ("pes", [], []),
    "pes_ref_snpss": ("pes", ["--snp", SNP, "--ss", SS], []),
    "pes_ref_shard_dna": ("pes", SHARDS, ["--no-spliced-alignment"]),
    "pes_ref_nss": ("nss", [], []),
    "shard_ref_pe": ("shard", SHARDS, ["--no-spliced-alignment"]),
}


def rc(s):
    return np.where(s < 4, 3 - s, 4)[::-1].copy()


def make(rng):
    chroms = {}
    unit = rng.integers(0, 4, 120).astype(np.uint8)
    for name in NAMES:
        g = rng.integers(0, 4, N_CHR).astype(np.uint8)
        for s in SPOTS:
            g[s:s + 120] = unit
        for s, ln in INTRONS:
            g[s], g[s + 1] = 2, 3
            g[s + ln - 2], g[s + ln - 1] = 0, 2
        chroms[name] = g
    sites = [f"{name}\t{s - 1}\t{s + ln}\t+" for name in NAMES
             for k, (s, ln) in enumerate(INTRONS) if k % 2 == 0]
    # the catalog: away from the repeat copies and 700 bp clear of every
    # intron boundary
    busy = np.zeros(N_CHR, bool)
    for s in SPOTS:
        busy[s - 300:s + 420] = True
    for s, ln in INTRONS:
        busy[s - 700:s + 700] = True
        busy[s + ln - 700:s + ln + 700] = True
    cand = np.flatnonzero(~busy[:N_CHR - 1000])
    cand = cand[cand > 1000]
    lines, snvs = [], []
    k = 0
    for name in NAMES:
        g = chroms[name]
        for p in sorted(rng.choice(cand, 12, replace=False)):
            p = int(p)
            t = k % 3
            if t == 0 or k % 4 == 1:
                alt = (int(g[p]) + int(rng.integers(1, 4))) % 4
                lines.append(f"rse{k}\tsingle\t{name}\t{p}\t{ACGT[alt]}")
                snvs.append((name, p, alt))
            elif t == 1:
                lines.append(f"rse{k}\tdeletion\t{name}\t{p}\t"
                             f"{int(rng.integers(1, 4))}")
            else:
                ins = rng.integers(0, 4, int(rng.integers(1, 4)))
                lines.append(f"rse{k}\tinsertion\t{name}\t{p}\t"
                             + "".join(ACGT[c] for c in ins))
            k += 1
    alt_g = {n: g.copy() for n, g in chroms.items()}
    for name, p, a in snvs:
        alt_g[name][p] = a

    def noisy(m, i):
        m = m.copy()
        if i % 5 == 1:
            for q in rng.choice(L, int(rng.integers(1, 3)), replace=False):
                if m[q] < 4:
                    m[q] = (m[q] + int(rng.integers(1, 4))) % 4
        if i % 23 == 4:
            m[int(rng.integers(5, L - 5))] = 4
        return m

    def frag_pair(seq, s, F, fw):
        left, right = seq[s:s + L].copy(), rc(seq[s + F - L:s + F])
        return (left, right) if fw else (right, left)

    def mrna(g, k):
        s, ln = INTRONS[k]
        return np.concatenate([g[s - EXON:s], g[s + ln:s + ln + EXON]])

    pairs = []
    for i in range(160):
        name = NAMES[i % 2]
        g = chroms[name]
        fw = i % 3 != 1
        if i < 50 or i >= 150:                # plain (a third on SNVs)
            if i % 3 == 0:
                ps = [p for (n, p, _) in snvs if n == name]
                s = ps[(i // 4) % len(ps)] - int(rng.integers(10, 90))
                seq = alt_g[name]
            else:
                s = int(rng.integers(1000, N_CHR - 1000))
                seq = g
            m1, m2 = frag_pair(seq, s, int(rng.integers(200, 401)), fw)
            tag = "plain"
        elif i < 80:                          # one mate across a junction
            k = (i // 2) % len(INTRONS)
            x = int(rng.integers(20, 81))     # its first exon's share
            F = int(rng.integers(200, 401))
            t = mrna(g, k)
            if i % 4 < 2:                     # the left mate crosses
                f0 = EXON - x
            else:                             # the right mate crosses
                f0 = EXON + x - F
            m1, m2 = frag_pair(t, f0, F, fw)
            tag = f"jx{INTRONS[k][0]}"
        elif i < 100:                         # the fragment spans an intron
            k = LONG[(i // 2) % len(LONG)]
            F = int(rng.integers(260, 401))
            f0 = EXON - L - int(rng.integers(0, F - 2 * L + 1))
            f0 = min(max(f0, EXON + L - F), EXON - L)
            m1, m2 = frag_pair(mrna(g, k), f0, F, fw)
            tag = f"sp{INTRONS[k][0]}"
        elif i < 120:                         # one mate inside the repeat
            sp = SPOTS[(i // 2) % len(SPOTS)] + 10
            F = int(rng.integers(250, 400))
            if i % 4 < 2:
                m1, m2 = g[sp:sp + L].copy(), rc(g[sp + F - L:sp + F])
            else:
                e = sp + L
                m1, m2 = g[e - F:e - F + L].copy(), rc(g[sp:sp + L])
            tag = "rep"
        elif i < 130:                         # mate 2 is random sequence
            s = int(rng.integers(1000, N_CHR - 1000))
            m1 = g[s:s + L].copy()
            m2 = rng.integers(0, 4, L).astype(np.uint8)
            tag = "rnd"
        elif i < 140:                         # mates on two chromosomes
            a = int(rng.integers(1000, N_CHR - 1000))
            b = int(rng.integers(1000, N_CHR - 1000))
            m1 = chroms["eA"][a:a + L].copy()
            m2 = rc(chroms["eB"][b:b + L])
            tag = "xchr"
        else:                                 # insert far above -X 500
            s = int(rng.integers(1000, N_CHR - 8000))
            m1, m2 = frag_pair(g, s, int(rng.integers(2000, 6000)), fw)
            tag = "far"
        pairs.append((f"ep{i}_{name}_{tag}", noisy(m1, i), noisy(m2, i + 7)))
    return chroms, lines, sites, pairs


def _seq(m):
    return "".join("ACGTN"[c] for c in m)


def main():
    chroms, lines, sites, pairs = make(np.random.default_rng(2029))
    with gzip.GzipFile(os.path.join(HERE, "pes_genome.fa.gz"), "wb",
                       mtime=0) as f:
        for name, g in chroms.items():
            s = _seq(g)
            f.write((f">{name}\n" + "".join(
                s[i:i + 60] + "\n" for i in range(0, len(s), 60))).encode())
    with open(os.path.join(HERE, SNP), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(HERE, SS), "w") as f:
        f.write("\n".join(sites) + "\n")
    for m in (1, 2):
        with open(os.path.join(HERE, f"pes_reads_{m}.fa"), "w") as f:
            for name, m1, m2 in pairs:
                f.write(f">{name}\n{_seq(m1 if m == 1 else m2)}\n")
    repo = os.path.dirname(os.path.dirname(HERE))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    py = [sys.executable, "-m", "hisat2_tpu"]
    reads = {"pes": ("pes_reads_1.fa", "pes_reads_2.fa"),
             "nss": ("nss_reads.fa", "nss_reads.fa"),
             "shard": ("shard_reads.fa", "shard_reads.fa")}
    with tempfile.TemporaryDirectory() as d:
        for corpus in reads:
            with gzip.open(os.path.join(HERE, f"{corpus}_genome.fa.gz"),
                           "rb") as f, \
                    open(os.path.join(d, f"{corpus}.fa"), "wb") as o:
                o.write(f.read())
        for oracle, (corpus, bargs, aargs) in ORACLES.items():
            bargs = [os.path.join(HERE, a) if a in (SNP, SS) else a
                     for a in bargs]
            subprocess.run(py + ["build"] + bargs + [f"{corpus}.fa", oracle],
                           cwd=d, env=env, check=True)
            r1, r2 = (os.path.join(HERE, x) for x in reads[corpus])
            subprocess.run(py + ["align"] + aargs + [
                "-f", "-x", oracle, "-1", r1, "-2", r2, "-S", "out.sam"],
                cwd=d, env=env, check=True)
            with open(os.path.join(d, "out.sam"), "rb") as f, gzip.GzipFile(
                    os.path.join(HERE, oracle + ".sam.gz"), "wb",
                    mtime=0) as o:
                o.write(b"".join(x for x in f if not x.startswith(b"@")))


if __name__ == "__main__":
    main()
