"""The genome-scale CLI corpus (tests/data/shard_*, made by
tests/data/make_shard.py): two 100 kbp chromosomes with planted introns
and a block copied from one into the other, and 160 DNA and spliced reads.

The oracles are the JAX package's output (hisat2_tpu on the CPU), not
hisat2's.  Each test builds the index with `python -m hisat2_tpu_torch
build` (two shards with --shard-bp, or one index, sampled at --offrate 4)
and asserts that `python -m hisat2_tpu_torch align --device cpu` writes
the oracle's SAM body byte for byte, in a process where neither jax nor
hisat2_tpu can import; the header lists both chromosomes at their
lengths.  A paired run on the two-shard index equals the JAX CLI's.
"""

import gzip
import os
import subprocess
import sys

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = ["--shard-bp", "150000", "--offrate", "4"]
CASES = {"shard_ref_dna": (SHARDS, ["--no-spliced-alignment"]),
         "shard_ref_rna": (SHARDS, []),
         "shard_ref_or4": (["--offrate", "4"], ["--no-spliced-alignment"])}

# makes `import jax` fail, as on a machine without JAX, and `import
# hisat2_tpu` too: the port keeps its own copies of what it needs
NO_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "hisat2_tpu"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None
sys.meta_path.insert(0, _NoJax())
"""


def _run(args, cwd):
    # one torch thread: the suite runs in parallel workers, and a thread
    # per core each oversubscribes the CPU
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    code = (NO_JAX + "import runpy\n"
            "sys.argv = ['hisat2_tpu_torch'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('hisat2_tpu_torch', run_name='__main__')\n"
            "finally:\n"
            "    assert 'jax' not in sys.modules\n"
            "    assert 'hisat2_tpu' not in sys.modules\n")
    return subprocess.run([sys.executable, "-c", code] + args, cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard_cli")
    with gzip.open(os.path.join(DATA, "shard_genome.fa.gz"), "rb") as f:
        (d / "g.fa").write_bytes(f.read())
    for name, bargs in (("sh", SHARDS), ("or4", ["--offrate", "4"])):
        r = _run(["build"] + bargs + ["g.fa", name], d)
        assert r.returncode == 0, r.stderr[-3000:]
    assert (d / "sh.s0.npz").exists() and (d / "sh.s1.npz").exists()
    return d


@pytest.mark.parametrize("oracle", sorted(CASES))
def test_cli_writes_oracle(built, oracle):
    bargs, aargs = CASES[oracle]
    idx = "sh" if bargs is SHARDS else "or4"
    out = f"{oracle}.sam"
    r = _run(["align"] + aargs + ["-f", "-x", idx, "-U",
                                  os.path.join(DATA, "shard_reads.fa"),
                                  "-S", out, "--device", "cpu"], built)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(built / out) as f:
        lines = f.readlines()
    sq = [x.split() for x in lines if x.startswith("@SQ")]
    assert sq == [["@SQ", "SN:sA", "LN:100000"], ["@SQ", "SN:sB", "LN:100000"]]
    with gzip.open(os.path.join(DATA, oracle + ".sam.gz"), "rt") as f:
        want = f.readlines()
    got = [x for x in lines if not x.startswith("@")]
    assert got == want
    body = [x.split("\t") for x in got]
    assert {x[2] for x in body} >= {"sA", "sB"}
    if not aargs:
        assert sum("N" in x[5] for x in body) >= 50      # spliced CIGARs


def test_cli_refuses_paired_on_shards(built):
    """Paired reads on the two-shard index, every read its own mate: the
    SAM body equals the JAX CLI's (shard_ref_pe, written by
    tests/data/make_pes.py)."""
    reads = os.path.join(DATA, "shard_reads.fa")
    r = _run(["align", "--no-spliced-alignment", "-f", "-x", "sh", "-1",
              reads, "-2", reads, "-S", "pe.sam", "--device", "cpu"], built)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(built / "pe.sam") as f:
        got = [x for x in f if not x.startswith("@")]
    with gzip.open(os.path.join(DATA, "shard_ref_pe.sam.gz"), "rt") as f:
        assert got == f.readlines()
    assert {x.split("\t")[2] for x in got} >= {"sA", "sB"}
