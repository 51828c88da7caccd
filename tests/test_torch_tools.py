"""The port's copies of the JAX package's numpy tools write the same bytes,
and the port's `align -A <argfile>` mode runs each line as its own run:

- one parametrised test calls each module's main(argv) in-process, the
  JAX package's and the port's, on the same inputs, and compares return
  codes, stdout, stderr and every file written: `inspect` (no flag, -s,
  -n, --snp, --ss, --ss-all, --exon) on a --snp --ss --exon index of the
  gss genome (built once per module by the port's `build`),
  `extract-splice-sites` and `extract-exons` on a seeded GTF,
  `extract-snps-haplotypes` on a seeded VCF, `extract-snps-haplotypes-ucsc`
  on tests/data/ucsc, and `simulate-reads`, RNA and --dna, with a fixed
  --random-seed;
- `align -A` (--device cpu) on a two-line arg file over the mm3 corpus
  writes the same SAMs as the two direct runs (and their bodies equal
  the committed oracles mm3_ref_k10 and mm3_ref_sec); a missing arg file
  returns 1 and an empty one 0, with JAX's messages.
"""

import contextlib
import gzip
import io
import os

import numpy as np
import pytest
import torch

from hisat2_tpu.cli import inspect as jinspect
from hisat2_tpu.tools import gtf as jgtf
from hisat2_tpu.tools import simulate as jsim
from hisat2_tpu.tools import variants as jvar
from hisat2_tpu.tools import variants_ucsc as jucsc
from hisat2_tpu_torch.cli import inspect as tinspect
from hisat2_tpu_torch.tools import gtf as tgtf
from hisat2_tpu_torch.tools import simulate as tsim
from hisat2_tpu_torch.tools import variants as tvar
from hisat2_tpu_torch.tools import variants_ucsc as tucsc

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs in parallel
    workers, and torch's default of a thread per core oversubscribes the
    CPU (each small op then waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gtf(rng, chroms):
    """Seeded transcripts on both strands: shared exons, an exon pair
    closer than 6 bp (merged), overlapping genes."""
    lines = []
    for t in range(14):
        name = list(chroms)[t % 2]
        n = len(chroms[name])
        start = int(rng.integers(1000, n - 20000))
        exons, x = [], start
        for _ in range(int(rng.integers(2, 6))):
            ln = int(rng.integers(80, 400))
            exons.append((x, x + ln))
            x += ln + int(rng.integers(100, 3000))
        if t % 5 == 0:
            a, b = exons[0]
            exons[0] = (a, a + (b - a) // 2)
            exons.insert(1, (a + (b - a) // 2 + 3, b))
        strand = "+-"[t % 3 == 1]
        gene = f"g{t // 2}"
        for a, b in exons:
            lines.append(f"{name}\tsim\texon\t{a}\t{b}\t.\t{strand}\t.\t"
                         f'gene_id "{gene}"; transcript_id "t{t}";')
    return "\n".join(lines) + "\n"


def _vcf(rng, chroms):
    lines = ["##fileformat=VCFv4.1",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\ts1\ts2"]
    for name, seq in chroms.items():
        for k, p in enumerate(sorted(rng.choice(
                np.arange(100, len(seq) - 100), 40, replace=False))):
            p = int(p)
            ref = seq[p]
            if k % 3 == 0:
                alt = "ACGT"[("ACGT".index(ref) + 1) % 4]
            elif k % 3 == 1:
                ref, alt = seq[p:p + 3], seq[p]
            else:
                alt = ref + "".join("ACGT"[c] for c in rng.integers(0, 4, 2))
            gts = "\t".join(("0|1", "1|1", "1|0", "0|0")[(k + i) % 4]
                            for i in range(2))
            vid = f"rs{1000 + k}" if k % 4 else f"var{k}"
            lines.append(f"{name}\t{p + 1}\t{vid}\t{ref}\t{alt}\t.\tPASS\t."
                         f"\tGT\t{gts}")
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    ind = d / "in"
    ind.mkdir()
    chroms, name = {}, None
    with gzip.open(f"{DATA}/gss_genome.fa.gz", "rt") as f:
        text = f.read()
    (ind / "g.fa").write_text(text)
    for line in text.splitlines():
        if line.startswith(">"):
            name = line[1:].split()[0]
            chroms[name] = []
        else:
            chroms[name].append(line.strip())
    chroms = {k: "".join(v) for k, v in chroms.items()}
    rng = np.random.default_rng(404)
    gtf = _gtf(rng, chroms)
    (ind / "a.gtf").write_text(gtf)
    (ind / "v.vcf").write_text(_vcf(rng, chroms))
    with open(ind / "exons.txt", "w") as f:
        for ln in gtf.splitlines()[:12]:
            c = ln.split("\t")
            f.write(f"{c[0]}\t{int(c[3]) - 1}\t{int(c[4]) - 1}\t{c[6]}\n")
    for n in ("gen.fa", "snp.txt"):
        with gzip.open(f"{DATA}/ucsc/{n}.gz", "rb") as f:
            (ind / f"ucsc_{n}").write_bytes(f.read())
    from hisat2_tpu_torch.cli.build import main as build
    cwd = os.getcwd()
    os.chdir(ind)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(out):
            assert build(["--snp", f"{DATA}/gss.snp", "--ss",
                          f"{DATA}/gss.ss", "--exon", "exons.txt", "g.fa",
                          "idx"]) == 0
    finally:
        os.chdir(cwd)
    return d


IDX = "../in/idx"
CASES = {
    "inspect": ("inspect", [IDX]),
    "inspect_s": ("inspect", [IDX, "-s"]),
    "inspect_n": ("inspect", [IDX, "-n"]),
    "inspect_snp": ("inspect", [IDX, "--snp"]),
    "inspect_ss": ("inspect", [IDX, "--ss"]),
    "inspect_ss_all": ("inspect", [IDX, "--ss-all"]),
    "inspect_exon": ("inspect", [IDX, "--exon"]),
    "extract_splice_sites": ("main_ss", ["../in/a.gtf"]),
    "extract_exons": ("main_exons", ["../in/a.gtf"]),
    "extract_snps_haplotypes": ("variants", ["../in/g.fa", "../in/v.vcf",
                                             "vcf"]),
    "extract_snps_haplotypes_ucsc": ("ucsc", ["../in/ucsc_gen.fa",
                                              "../in/ucsc_snp.txt", "ucsc"]),
    "simulate_rna": ("simulate", ["../in/g.fa", "sim", "--gtf",
                                  "../in/a.gtf", "--snp", f"{DATA}/gss.snp",
                                  "-n", "300", "--error-rate", "0.01",
                                  "--random-seed", "7"]),
    "simulate_dna": ("simulate", ["../in/g.fa", "sim", "--dna",
                                  "--single-end", "-n", "300",
                                  "--random-seed", "11"]),
}
# `inspect --exon` prints nothing in the JAX package: print_variants has
# no exon mode (hisat2_tpu/cli/inspect.py:62-66); the port mirrors it
EMPTY = {"inspect_exon"}
MAINS = {
    "inspect": (jinspect.main, tinspect.main),
    "main_ss": (jgtf.main_ss, tgtf.main_ss),
    "main_exons": (jgtf.main_exons, tgtf.main_exons),
    "variants": (jvar.main, tvar.main),
    "ucsc": (jucsc.main, tucsc.main),
    "simulate": (jsim.main, tsim.main),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_matches_jax(inputs, case, monkeypatch):
    key, argv = CASES[case]
    got = {}
    for pkg, fn in zip(("jax", "port"), MAINS[key]):
        d = inputs / f"{case}_{pkg}"
        d.mkdir()
        monkeypatch.chdir(d)
        out, err = io.StringIO(), io.StringIO()
        # the GTF extractors write to the sys.stdout bound at their import
        gtf = jgtf if pkg == "jax" else tgtf
        for f in (gtf.extract_splice_sites, gtf.extract_exons):
            monkeypatch.setattr(f, "__defaults__", (out,))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = fn(list(argv))
        files = {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}
        got[pkg] = (rc, out.getvalue(), err.getvalue(), files)
    assert got["port"] == got["jax"]
    rc, out, _, files = got["port"]
    if case in EMPTY:
        assert rc == 0 and out == "" and not files, case
    else:
        assert rc == 0 and (out.count("\n") >= 2 or any(files.values())), \
            case


def test_align_argfile_runs_each_line(tmp_path, monkeypatch, capsys):
    from hisat2_tpu_torch.cli.align import main
    from hisat2_tpu_torch.cli.build import main as build
    with gzip.open(f"{DATA}/mm3_genome.fa.gz", "rb") as f:
        (tmp_path / "g.fa").write_bytes(f.read())
    monkeypatch.chdir(tmp_path)
    assert build(["g.fa", "idx"]) == 0
    reads = f"{DATA}/mm3_reads.fa"
    runs = {"k10": ["-k", "10"], "sec": ["-k", "3", "--secondary"]}

    def line(name, out):
        return (["--no-spliced-alignment", "-f", "-x", "idx", "-U", reads,
                 "-S", out, "--device", "cpu", "--quiet"] + runs[name])

    with open("args.txt", "w") as f:
        f.write(" ".join(line("k10", "A_k10.sam")) + "\n\n   \n"
                + " ".join(line("sec", "A_sec.sam")) + "\n")
    assert main(["-A", "args.txt"]) == 0
    for name in runs:
        assert main(line(name, f"D_{name}.sam")) == 0
        a = open(f"A_{name}.sam").read().replace(f"A_{name}.sam", "X")
        d = open(f"D_{name}.sam").read().replace(f"D_{name}.sam", "X")
        assert a == d, name
        with gzip.open(f"{DATA}/mm3_ref_{name}.sam.gz", "rt") as f:
            want = [x for x in f if not x.startswith("@")]
        assert [x for x in a.splitlines(True) if not x.startswith("@")] \
            == want, name
    capsys.readouterr()
    assert main(["-A", "missing.txt"]) == 1
    assert "Error: could not open arg file missing.txt" in \
        capsys.readouterr().err
    open("empty.txt", "w").close()
    assert main(["-A", "empty.txt"]) == 0
    assert "Warning: No arg strings parsed from empty.txt" in \
        capsys.readouterr().err
