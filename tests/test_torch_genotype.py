"""The port's genotype callers on the CPU, against the JAX package:

- the port CLI (`genotype ... --device cpu`) on the geno_* corpus writes
  reports and files byte-equal to the JAX CLI's committed oracles
  (tests/data/make_geno.py names each command): --alleles, --msa
  --assembly, --run on a --snp genotype-genome index (built once per
  module by the port's `build`) and --extract-reads;
- the numpy modes in-process, the port's driver against hisat2_tpu's on
  the same inputs, with equal output files (or stdout): --extract-vars on
  test_genotype_vars.py's two configs, --build-genome on
  test_genotype_genome.py's inputs, --convert-str, --extract-cyp, and
  --li-hla on the committed ref0 extract-vars files with a seeded SAM;
- `_remap_backbone` (the --extract-vars --index path) fails in the port
  where it fails in JAX: an aligned backbone raises AttributeError on
  `a.pos` (hisat2_tpu/genotype/vars.py:623; Alignment has no `pos` in
  either package), and a backbone that does not align gives ("-", 0, n);
- `genotype` runs on the card by default: without one it raises.
"""

import contextlib
import dataclasses
import gzip
import importlib.util
import inspect
import io
import os

import numpy as np
import pytest
import torch

from hisat2_tpu.genotype import driver as jdriver
from hisat2_tpu_torch.genotype import driver as tdriver

DATA = os.path.join(os.path.dirname(__file__), "data")
GDATA = os.path.join(DATA, "genotype")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


make_geno = _load("make_geno", os.path.join(DATA, "make_geno.py"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs in parallel
    workers, and torch's default of a thread per core oversubscribes the
    CPU (each small op then waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("geno"))
    make_geno.stage(d)
    from hisat2_tpu_torch.cli.build import main as build
    cwd = os.getcwd()
    os.chdir(d)
    try:
        assert build(["--snp", "geno_gg.snp", "geno_gg.fa",
                      make_geno.IDX]) == 0
    finally:
        os.chdir(cwd)
    return d


@pytest.mark.parametrize("mode", sorted(make_geno.RUNS))
def test_cli_matches_jax_oracle(corpus, mode, monkeypatch):
    argv, outs = make_geno.RUNS[mode]
    monkeypatch.chdir(corpus)
    assert tdriver.main(argv + ["--device", "cpu"]) == 0
    for got, oracle in outs:
        with gzip.open(os.path.join(DATA, oracle + ".gz"), "rb") as f:
            want = f.read()
        with open(got, "rb") as f:
            assert f.read() == want, f"{mode}: {got} differs from {oracle}"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_defaults_to_the_card_and_raises_without_one(corpus,
                                                         monkeypatch):
    argv, _ = make_geno.RUNS["alleles"]
    monkeypatch.chdir(corpus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.main(argv)


def _sam_for(prefix, rng):
    """Reads of two alleles of the PREFIX.link catalog over the backbone,
    each with the Zs tags of the allele's variants it covers."""
    snps = [ln.split("\t") for ln in open(prefix + ".snp").read().split(
        "\n") if ln]
    carriers = {}
    for ln in open(prefix + ".link"):
        sid, names = ln.rstrip("\n").split("\t")
        carriers[sid] = set(names.split())
    alleles = sorted(set().union(*carriers.values()))
    pick = (alleles[1], alleles[-2])
    bb_name = snps[0][2]
    n = sum(len(x.strip()) for x in open(prefix + "_backbone.fa")
            if not x.startswith(">"))
    lines = [f"@SQ\tSN:{bb_name}\tLN:{n}"]
    for i in range(240):
        al = pick[i % 3 == 2]
        st = int(rng.integers(0, n - 100))
        zs = [f"{int(p) - st}|{t[0].upper()}|{sid}"
              for sid, t, _, p, _ in snps
              if st <= int(p) < st + 100 and al in carriers.get(sid, ())]
        tag = ("\tZs:Z:" + ",".join(zs)) if zs else ""
        lines.append(f"r{i}\t0\t{bb_name}\t{st + 1}\t60\t100M\t*\t0\t0\t"
                     f"{'A' * 100}\t{'I' * 100}\tAS:i:0{tag}")
    return "\n".join(lines) + "\n"


def _numpy_inputs(mode, d):
    """Write mode's inputs into d; -> the genotype arguments."""
    if mode.startswith("extract_vars"):
        from test_genotype_vars import make_db
        make_db(f"{d}/HLA")
        freq = "5.0" if mode.endswith("5") else "0.0"
        return ["--extract-vars", "HLA", "--out-base", "hla",
                "--leftshift", "--min-var-freq", freq]
    if mode == "build_genome":
        from test_genotype_genome import make_inputs
        make_inputs(d)
        return ["--build-genome", "genome.fa", "--database-list", "hla",
                "--out-base", "gg", "--commonvar", "snp144Common"]
    if mode == "convert_str":
        from test_genotype_strcyp import STR_ALLELES
        rng = np.random.default_rng(31)
        with open(f"{d}/spec.tsv", "w") as f:
            f.write("# locus allele structure\n")
            for aid, st in STR_ALLELES:
                f.write(f"D21\t{aid}\t{st}\n")
            for aid, n in (("11", 11), ("12", 12), ("13", 13)):
                f.write(f"TH\t{aid}\t[AATG]{n}\n")
        with open(f"{d}/flanks.fa", "w") as f:
            for nm in ("D21_left", "D21_right", "TH_left"):
                f.write(f">{nm}\n" + "".join(
                    "ACGT"[c] for c in rng.integers(0, 4, 80)) + "\n")
        return ["--convert-str", "spec.tsv", "--flanks", "flanks.fa",
                "--out-base", "str"]
    if mode == "extract_cyp":
        rng = np.random.default_rng(88)
        seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 400))
        o_pos, o_neg = 99, 100

        def at(gp):
            return seq[gp + (o_pos if gp > 0 else o_neg)]

        r1, r2 = at(20), at(-30)
        n1 = "ACGT"[("ACGT".index(r1) + 1) % 4]
        n2 = "ACGT"[("ACGT".index(r2) + 2) % 4]
        dseq = seq[50 + o_pos:53 + o_pos + 1]
        with open(f"{d}/cyp.var", "w") as f:
            f.write("\n".join([
                "CYPTEST*1\tNone", f"CYPTEST*2\t20{r1}>{n1}",
                f"CYPTEST*3\t-30{r2}>{n2},50_53del{dseq}",
                "CYPTEST*4\t70_71insTTAG",
                f"CYPTEST*5\t20{r1}>{n1},70_71insGG"]) + "\n")
        with open(f"{d}/cyp.fa", "w") as f:
            f.write(">cyptest\n" + seq + "\n")
        return ["--extract-cyp", "cyp.var,cyp.fa", "--out-base", "cyp",
                "--cyp-offset-pos", str(o_pos), "--cyp-offset-neg",
                str(o_neg)]
    assert mode == "li_hla"
    for ext in (".snp", ".link", "_backbone.fa"):
        with gzip.open(f"{GDATA}/ref0{ext}.gz", "rb") as f, \
                open(f"{d}/ref0{ext}", "wb") as o:
            o.write(f.read())
    with open(f"{d}/bb.sam", "w") as f:
        f.write(_sam_for(f"{d}/ref0", np.random.default_rng(9)))
    return ["--li-hla", "ref0,bb.sam", "--top", "6"]


@pytest.mark.parametrize("mode", ["extract_vars0", "extract_vars5",
                                  "build_genome", "convert_str",
                                  "extract_cyp", "li_hla"])
def test_numpy_mode_matches_jax(tmp_path, mode, monkeypatch):
    outs = {}
    for pkg, drv in (("jax", jdriver), ("port", tdriver)):
        d = tmp_path / pkg
        d.mkdir()
        argv = _numpy_inputs(mode, str(d))
        before = set(os.listdir(d))
        monkeypatch.chdir(d)
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = drv.main(argv)
        files = {n: (d / n).read_bytes() for n in sorted(os.listdir(d))
                 if n not in before}
        outs[pkg] = (rc, out.getvalue(), err.getvalue(), files)
    assert outs["port"] == outs["jax"]
    rc, out, _, files = outs["port"]
    assert rc == 0 and (files or out.count("\n") >= 6), (mode, out)


def test_remap_backbone_fails_where_jax_fails(tmp_path):
    from hisat2_tpu.align.pipeline import Alignment as JAlignment
    from hisat2_tpu.genotype import vars as jvars
    from hisat2_tpu_torch.align.host import Alignment as TAlignment
    from hisat2_tpu_torch.genotype import vars as tvars
    from hisat2_tpu_torch.index.builder import build_fm_index

    # JAX's remap reads `a.pos` of an Alignment, which has ref_pos only
    src = inspect.getsource(jvars._remap_backbone)
    assert "int(a.pos), int(a.pos) + len(seq)" in src
    for cls in (JAlignment, TAlignment):
        names = {f.name for f in dataclasses.fields(cls)}
        assert "ref_pos" in names and "pos" not in names
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    index = build_fm_index([("chr9", g)])
    bb = "".join("ACGT"[c] for c in g[7000:7300])
    with pytest.raises(AttributeError, match="no attribute 'pos'"):
        tvars._remap_backbone(index, bb, "cpu")
    other = "".join("ACGT"[c] for c in rng.integers(0, 4, 300))
    assert tvars._remap_backbone(index, other, "cpu") == ("-", 0, 300)
    # the CLI path: --extract-vars with --index places the backbone there
    from test_genotype_vars import make_db
    make_db(str(tmp_path / "HLA"))
    ref = open(tmp_path / "HLA" / "fasta" / "A_gen.fasta").read().split(
        ">")[1].split("\n", 1)[1].replace("\n", "")
    host = np.concatenate([g[:5000], np.array(
        ["ACGT".index(c) for c in ref], np.uint8), g[5000:]])
    build_fm_index([("chr6", host)]).save(str(tmp_path / "idx"))
    with pytest.raises(AttributeError, match="no attribute 'pos'"):
        tdriver.main(["--extract-vars", str(tmp_path / "HLA"), "--index",
                      str(tmp_path / "idx"), "--out-base",
                      str(tmp_path / "hla"), "--device", "cpu"])
