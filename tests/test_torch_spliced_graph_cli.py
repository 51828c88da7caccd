"""The port's CLI in its default (spliced) mode on SNP + splice-site indexes
(tests/data/gss_*, made by tests/data/make_gss.py): `python -m
hisat2_tpu_torch build` then `align --device cpu`, the SAM body byte-equal
to the oracles written by `python -m hisat2_tpu` on the same corpus:

  gss_ref_snpss  `build --snp --ss`, `align` (k = 10 on a graph index)
  gss_ref_ss     `build --ss` (baked sites, no SNVs), `align`
  gss_ref_ns     `build --snp --ss --shard-bp 60000 --offrate 4` (two
                 shards, sampled SA), `align -k 10`: config 6's shape
"""

import gzip
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
SNP, SS = f"{DATA}/gss.snp", f"{DATA}/gss.ss"
CASES = {
    "gss_ref_snpss": (["--snp", SNP, "--ss", SS], []),
    "gss_ref_ss": (["--ss", SS], []),
    "gss_ref_ns": (["--snp", SNP, "--ss", SS, "--shard-bp", "60000",
                    "--offrate", "4"], ["-k", "10"]),
}


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "hisat2_tpu_torch"] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("gss")
    with gzip.open(f"{DATA}/gss_genome.fa.gz", "rb") as f:
        (d / "g.fa").write_bytes(f.read())
    return d


@pytest.mark.parametrize("oracle", sorted(CASES))
def test_cli_spliced_graph_matches_oracle(genome, oracle):
    bargs, aargs = CASES[oracle]
    d = str(genome)
    _run(["build"] + bargs + ["g.fa", oracle], d)
    if "--shard-bp" in bargs:
        assert os.path.exists(os.path.join(d, oracle + ".s1.npz"))
    _run(["align"] + aargs + ["-f", "-x", oracle, "-U",
                              f"{DATA}/gss_reads.fa", "-S", "out.sam",
                              "--device", "cpu"], d)
    with open(os.path.join(d, "out.sam")) as f:
        got = [x for x in f if not x.startswith("@")]
    with gzip.open(f"{DATA}/{oracle}.sam.gz", "rt") as f:
        want = f.readlines()
    assert got == want
    spliced = [x for x in got if "N" in x.split("\t")[5]]
    assert len(spliced) >= 60
    if "--snp" in bargs:
        assert any("Zs:Z:" in x for x in spliced)
