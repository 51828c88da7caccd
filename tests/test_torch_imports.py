"""The port stands alone: it imports neither jax nor the JAX package.

- An AST scan of every .py under hisat2_tpu_torch/, and of chip_smoke.py,
  finds no import of jax, jaxlib or hisat2_tpu, lazy imports in functions
  included (and no importlib call naming them).
- In a process whose sys.meta_path refuses all three, every module of the
  port imports, `python -m hisat2_tpu_torch build` indexes the mm3 genome
  and `align --device cpu` runs on the mm3, gdna and paired corpora; none
  of the three names is in sys.modules at the end.
"""

import ast
import gzip
import os
import pkgutil
import subprocess
import sys

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "hisat2_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "hisat2_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _banned_imports(path):
    tree = ast.parse(open(path).read(), path)
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            if fname in ("import_module", "__import__", "run_module"):
                names = [node.args[0].value]
        bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                for n in names if n.split(".")[0] in BANNED]
    return bad


def test_no_banned_import_in_source():
    files = _port_files()
    assert len(files) > 40
    bad = [b for f in files for b in _banned_imports(f)]
    assert not bad, bad


def test_port_runs_with_jax_and_hisat2_tpu_blocked(tmp_path):
    import hisat2_tpu_torch
    mods = sorted(m.name for m in pkgutil.walk_packages(
        hisat2_tpu_torch.__path__, "hisat2_tpu_torch."))
    assert len(mods) > 35
    assert {f"hisat2_tpu_torch.parallel.{m}" for m in
            ("mesh", "multihost", "dryrun")} <= set(mods)
    for name in ("mm3", "gdna", "pe"):
        with gzip.open(f"{DATA}/{name}_genome.fa.gz", "rb") as f:
            (tmp_path / f"{name}.fa").write_bytes(f.read())
    cli = [
        ["build", "mm3.fa", "mm3"],
        ["align", "--no-spliced-alignment", "-f", "-x", "mm3", "-U",
         f"{DATA}/mm3_reads.fa", "-k", "10", "-S", "mm3.sam"],
        ["build", "--snp", f"{DATA}/gdna.snp", "gdna.fa", "gdna"],
        ["align", "--no-spliced-alignment", "-f", "-x", "gdna", "-U",
         f"{DATA}/gdna_reads.fa", "-S", "gdna.sam"],
        ["build", "pe.fa", "pe"],
        ["align", "--no-spliced-alignment", "-f", "-x", "pe", "-1",
         f"{DATA}/pe_reads_1.fa", "-2", f"{DATA}/pe_reads_2.fa", "-S",
         "pe.sam"],
    ]
    code = f"""
import importlib, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BANNED!r}:
            raise ModuleNotFoundError(f"No module named {{name!r}}")
        return None
sys.meta_path.insert(0, _Block())
for m in {mods!r}:
    importlib.import_module(m)
from hisat2_tpu_torch.__main__ import main
for argv in {cli!r}:
    if argv[0] == "align":
        argv = argv + ["--device", "cpu", "--quiet"]
    sys.argv = ["hisat2_tpu_torch"] + argv
    assert main() == 0, argv
left = [m for m in sys.modules if m.split(".")[0] in {BANNED!r}]
assert not left, left
print("BLOCKED_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0 and "BLOCKED_OK" in r.stdout, r.stderr[-3000:]
    for name, oracle in (("mm3", "mm3_ref_k10"), ("gdna", "gdna_ref"),
                         ("pe", "pe_ref")):
        with open(tmp_path / f"{name}.sam") as f:
            got = [x for x in f if not x.startswith("@")]
        with gzip.open(f"{DATA}/{oracle}.sam.gz", "rt") as f:
            want = [x for x in f if not x.startswith("@")]
        assert got == want, name
