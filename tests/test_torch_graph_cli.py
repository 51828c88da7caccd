"""The graph-DNA CLI corpus (tests/data/gdna_*, made by
tests/data/make_gdna.py): a 60 kbp two-chromosome genome, a 60-variant
.snp catalog and 200 reads carrying catalog alleles.

The oracle gdna_ref.sam.gz is the JAX package's output (hisat2_tpu on the
CPU), not hisat2's.  One test asserts that `python -m hisat2_tpu` still
writes it; the other builds the index with `python -m hisat2_tpu_torch
build --snp` and asserts that `python -m hisat2_tpu_torch align --device
cpu` writes it byte for byte, Zs:Z tags included, in a process where
neither jax nor hisat2_tpu can import.
"""

import gzip
import os
import subprocess
import sys

import pytest

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALIGN = ["align", "--no-spliced-alignment", "-f", "-x", "idx", "-U",
         os.path.join(DATA, "gdna_reads.fa"), "-S", "out.sam"]

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


def _oracle():
    with gzip.open(os.path.join(DATA, "gdna_ref.sam.gz"), "rt") as f:
        return f.readlines()


def _body(path):
    with open(path) as f:
        return [x for x in f if not x.startswith("@")]


def _genome(d):
    with gzip.open(os.path.join(DATA, "gdna_genome.fa.gz"), "rb") as f:
        (d / "g.fa").write_bytes(f.read())


def _run(pkg, args, cwd, no_jax):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    code = ((NO_JAX if no_jax else "import sys\n") + "import runpy\n"
            f"sys.argv = [{pkg!r}] + sys.argv[1:]\n"
            f"runpy.run_module({pkg!r}, run_name='__main__')\n"
            + ("assert 'jax' not in sys.modules\n"
               "assert 'hisat2_tpu' not in sys.modules\n" if no_jax else ""))
    r = subprocess.run([sys.executable, "-c", code] + args, cwd=str(cwd),
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.parametrize("pkg", ["hisat2_tpu", "hisat2_tpu_torch"])
def test_graph_cli_writes_oracle(tmp_path, pkg):
    port = pkg == "hisat2_tpu_torch"
    _genome(tmp_path)
    _run(pkg, ["build", "--snp", os.path.join(DATA, "gdna.snp"), "g.fa",
               "idx"], tmp_path, port)
    assert (tmp_path / "idx.var.npz").exists()
    _run(pkg, ALIGN + (["--device", "cpu"] if port else []), tmp_path, port)
    got, want = _body(tmp_path / "out.sam"), _oracle()
    assert got == want
    assert sum("Zs:Z:" in x for x in got) > 100
