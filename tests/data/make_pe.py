"""Generate the paired-end DNA CLI corpus tests/data/pe_*.

    python tests/data/make_pe.py            # writes the files below

- pe_genome.fa.gz: two seeded random chromosomes (pA 280 kbp, pB 40 kbp);
  pA carries a 120 bp unit 15 times at 18 kbp spacing, the fixture shape
  of tests/test_rescue.py, so a mate inside it needs mate rescue;
- pe.snp: a hisat2 .snp catalog of 40 variants (SNVs, deletions and
  insertions in turn, outside the repeat);
- pe_reads_1.fa, pe_reads_2.fa: 200 pairs of 100 bp mates, --fr, with
  fragments of 200-450 bp: plain pairs (half carry the catalog's SNV
  alleles, some sequencing errors and Ns), pairs with one mate inside the
  repeat (rescued), pairs in the wrong orientation, pairs with too long an
  insert, pairs whose mate 2 is random sequence, and pairs whose mates lie
  on different chromosomes;
- pe_reads.tab: the same pairs as --12 tabbed input (quality I);
- the oracles, written by the JAX package on the CPU (`python -m
  hisat2_tpu build [--snp pe.snp]`, then `python -m hisat2_tpu align
  --no-spliced-alignment -f -1 pe_reads_1.fa -2 pe_reads_2.fa`); they are
  hisat2_tpu's output, not hisat2's:
    pe_ref.sam.gz           linear index
    pe_ref_snp.sam.gz       graph index (pe.snp)
    pe_ref_nomixed.sam.gz   linear index, --no-mixed
    pe_ref_nodisc.sam.gz    linear index, --no-discordant
    pe_ref_conc.txt.gz      linear index, the --un-conc and --al-conc
                            files, each after a line "== <file name>"
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
SPOTS = [20000 + 18000 * i for i in range(15)]
ALIGN_ARGS = ["--no-spliced-alignment", "-f", "-1", "pe_reads_1.fa", "-2",
              "pe_reads_2.fa"]
# oracle name -> (index, extra align arguments)
ORACLES = {"pe_ref": ("idx", []),
           "pe_ref_snp": ("idxs", []),
           "pe_ref_nomixed": ("idx", ["--no-mixed"]),
           "pe_ref_nodisc": ("idx", ["--no-discordant"])}
CONC_ARGS = ["--un-conc", "un.fa", "--al-conc", "al.fa"]
CONC_FILES = ["un.1.fa", "un.2.fa", "al.1.fa", "al.2.fa"]


def rc(s):
    return (3 - s)[::-1].copy()


def make(rng):
    chroms = {"pA": rng.integers(0, 4, 280000).astype(np.uint8),
              "pB": rng.integers(0, 4, 40000).astype(np.uint8)}
    unit = rng.integers(0, 4, 120).astype(np.uint8)
    for s in SPOTS:
        chroms["pA"][s:s + 120] = unit
    # the catalog, away from the repeat copies
    lines, snvs, dels = [], [], []
    k = 0
    for name, g in chroms.items():
        nvar = 30 if name == "pA" else 10
        cand = np.arange(1000, len(g) - 1000)
        if name == "pA":
            near = np.zeros(len(g), bool)
            for s in SPOTS:
                near[s - 600:s + 720] = True
            cand = cand[~near[cand]]
        for p in sorted(rng.choice(cand, nvar, replace=False)):
            p = int(p)
            t = k % 3
            if t == 0:
                alt = (int(g[p]) + int(rng.integers(1, 4))) % 4
                lines.append(f"rsp{k}\tsingle\t{name}\t{p}\t{ACGT[alt]}")
                snvs.append((name, p, alt))
            elif t == 1:
                ln = int(rng.integers(1, 4))
                lines.append(f"rsp{k}\tdeletion\t{name}\t{p}\t{ln}")
                dels.append((name, p, ln))
            else:
                ins = rng.integers(0, 4, int(rng.integers(1, 4)))
                lines.append(f"rsp{k}\tinsertion\t{name}\t{p}\t"
                             + "".join(ACGT[c] for c in ins))
            k += 1
    alt_g = {n: g.copy() for n, g in chroms.items()}
    for name, p, a in snvs:
        alt_g[name][p] = a

    def noisy(m, i):
        m = m.copy()
        if i % 5 == 1:
            for q in rng.choice(L, int(rng.integers(1, 3)), replace=False):
                m[q] = (m[q] + int(rng.integers(1, 4))) % 4
        if i % 23 == 4:
            m[int(rng.integers(5, L - 5))] = 4
        return m

    def frag_pair(g, s, F, fw):
        left, right = g[s:s + L].copy(), rc(g[s + F - L:s + F])
        return (left, right) if fw else (right, left)

    pairs = []
    for i in range(200):
        if i < 110:                           # plain (SNV alleles on half)
            name = "pA" if i % 4 else "pB"
            g = alt_g[name] if i % 2 else chroms[name]
            if i % 2 and i % 3 == 0:
                # a fragment over a catalog SNV of this chromosome
                ps = [p for (n, p, _) in snvs if n == name]
                p = ps[int(rng.integers(0, len(ps)))]
                s = p - int(rng.integers(10, 90))
            else:
                s = int(rng.integers(500, len(g) - 1000))
            F = int(rng.integers(200, 451))
            m1, m2 = frag_pair(g, s, F, i % 3 != 1)
            tag = "plain"
        elif i < 120:                         # mate 1 over a deletion
            name, p, ln = dels[(i - 110) % len(dels)]
            g = chroms[name]
            s = p - int(rng.integers(20, 80))
            F = int(rng.integers(250, 400))
            m1 = np.concatenate([g[s:p], g[p + ln:s + L + ln]])
            m2 = rc(g[s + F - L:s + F])
            tag = "del"
        elif i < 140:                         # one mate inside the repeat
            sp = SPOTS[(i - 120) % 15] + 10
            g = chroms["pA"]
            F = int(rng.integers(250, 400))
            if i % 2:
                m1, m2 = g[sp:sp + L].copy(), rc(g[sp + F - L:sp + F])
            else:
                e = sp + L
                m1, m2 = g[e - F:e - F + L].copy(), rc(g[sp:sp + L])
            tag = "rep"
        elif i < 155:                         # same strand: wrong orientation
            g = chroms["pA"]
            s = int(rng.integers(500, len(g) - 1000))
            F = int(rng.integers(200, 451))
            m1, m2 = g[s:s + L].copy(), g[s + F - L:s + F].copy()
            tag = "ff"
        elif i < 170:                         # insert far above -X 500
            g = chroms["pA"]
            s = int(rng.integers(500, len(g) - 8000))
            F = int(rng.integers(1500, 6000))
            m1, m2 = frag_pair(g, s, F, i % 2 == 0)
            tag = "far"
        elif i < 185:                         # mate 2 is random sequence
            g = chroms["pA"]
            s = int(rng.integers(500, len(g) - 1000))
            m1 = g[s:s + L].copy()
            m2 = rng.integers(0, 4, L).astype(np.uint8)
            tag = "rnd"
        else:                                 # mates on two chromosomes
            a = int(rng.integers(500, 270000))
            b = int(rng.integers(500, 39000))
            m1 = chroms["pA"][a:a + L].copy()
            m2 = rc(chroms["pB"][b:b + L])
            tag = "xchr"
        pairs.append((f"pp{i}_{tag}", noisy(m1, i), noisy(m2, i + 7)))
    return chroms, lines, pairs


def _seq(m):
    return "".join("ACGTN"[c] for c in m)


def main():
    rng = np.random.default_rng(2027)
    chroms, lines, pairs = make(rng)
    with gzip.open(os.path.join(HERE, "pe_genome.fa.gz"), "wt") as f:
        for name, g in chroms.items():
            f.write(f">{name}\n")
            s = _seq(g)
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60] + "\n")
    with open(os.path.join(HERE, "pe.snp"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for m in (1, 2):
        with open(os.path.join(HERE, f"pe_reads_{m}.fa"), "w") as f:
            for name, m1, m2 in pairs:
                f.write(f">{name}\n{_seq(m1 if m == 1 else m2)}\n")
    with open(os.path.join(HERE, "pe_reads.tab"), "w") as f:
        for name, m1, m2 in pairs:
            f.write(f"{name}\t{_seq(m1)}\t{'I' * L}\t{_seq(m2)}\t"
                    f"{'I' * L}\n")
    repo = os.path.dirname(os.path.dirname(HERE))
    env = dict(os.environ, PYTHONPATH=repo, JAX_PLATFORMS="cpu")
    py = [sys.executable, "-m", "hisat2_tpu"]
    with tempfile.TemporaryDirectory() as d:
        for f_ in ("pe_reads_1.fa", "pe_reads_2.fa"):
            os.symlink(os.path.join(HERE, f_), os.path.join(d, f_))
        with gzip.open(os.path.join(HERE, "pe_genome.fa.gz"), "rb") as f, \
                open(os.path.join(d, "g.fa"), "wb") as o:
            o.write(f.read())
        subprocess.run(py + ["build", "g.fa", "idx"], cwd=d, env=env,
                       check=True)
        subprocess.run(py + ["build", "--snp", os.path.join(HERE, "pe.snp"),
                             "g.fa", "idxs"], cwd=d, env=env, check=True)
        for out, (idx, extra) in ORACLES.items():
            args = ALIGN_ARGS + ["-x", idx, "-S", "out.sam"] + extra
            if out == "pe_ref":
                args += CONC_ARGS
            subprocess.run(py + ["align"] + args, cwd=d, env=env,
                           check=True)
            with open(os.path.join(d, "out.sam"), "rb") as f, gzip.GzipFile(
                    os.path.join(HERE, out + ".sam.gz"), "wb", mtime=0) as o:
                o.write(b"".join(x for x in f if not x.startswith(b"@")))
        with gzip.GzipFile(os.path.join(HERE, "pe_ref_conc.txt.gz"), "wb",
                           mtime=0) as o:
            for f_ in CONC_FILES:
                o.write(f"== {f_}\n".encode())
                with open(os.path.join(d, f_), "rb") as f:
                    o.write(f.read())


if __name__ == "__main__":
    main()
