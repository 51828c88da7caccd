"""The port stands alone: it imports neither jax nor the JAX package.

- An AST scan of every .py under hisat2_tpu_torch/, and of chip_smoke.py,
  finds no import of jax, jaxlib or hisat2_tpu, lazy imports in functions
  included (and no importlib call naming them).
- In a process whose sys.meta_path refuses all three, every module of the
  port imports, `python -m hisat2_tpu_torch build` indexes the mm3 genome
  and `align --device cpu` runs on the mm3, gdna and paired corpora,
  `inspect -s` on the gdna index and `genotype --msa --device cpu` on the
  geno corpus (its report equal to the JAX oracle's, less the
  --assembly line); none of the three names is in sys.modules at the end.
"""

import ast
import gzip
import os
import pkgutil
import subprocess
import sys

import pytest

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
    with gzip.open(f"{DATA}/geno_locus.msa.fa.gz", "rb") as f:
        (tmp_path / "locus.msa.fa").write_bytes(f.read())
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
        ["inspect", "-s", "gdna"],
        ["genotype", "--msa", "locus.msa.fa", "-U",
         f"{DATA}/geno_reads_msa.fa.gz", "--out", "msa.txt"],
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
    elif argv[0] == "genotype":
        argv = argv + ["--device", "cpu"]
    sys.argv = ["hisat2_tpu_torch"] + argv
    assert main() == 0, argv
left = [m for m in sys.modules if m.split(".")[0] in {BANNED!r}]
assert not left, left
print("BLOCKED_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=REPO,
                                OMP_NUM_THREADS="1"),
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0 and "BLOCKED_OK" in r.stdout, r.stderr[-3000:]
    for name, oracle in (("mm3", "mm3_ref_k10"), ("gdna", "gdna_ref"),
                         ("pe", "pe_ref")):
        with open(tmp_path / f"{name}.sam") as f:
            got = [x for x in f if not x.startswith("@")]
        with gzip.open(f"{DATA}/{oracle}.sam.gz", "rt") as f:
            want = [x for x in f if not x.startswith("@")]
        assert got == want, name
    with gzip.open(f"{DATA}/geno_ref_msa.txt.gz", "rt") as f:
        # the oracle ran with --assembly, which adds its last line
        want = [x for x in f if not x.startswith("assembly:")]
    assert open(tmp_path / "msa.txt").readlines() == want


# the port's verbatim copies of JAX modules that have no kernel: their
# code equals the original's apart from imports, docstrings and, in the
# genotype driver and vars, the aligner (TorchAligner with a device)
COPIES = ("genotype/__init__.py", "genotype/typing.py", "genotype/msa.py",
          "genotype/assembly.py", "genotype/driver.py", "genotype/vars.py",
          "genotype/build_genome.py", "genotype/strloci.py",
          "genotype/cypvar.py", "genotype/lihla.py", "cli/inspect.py",
          "tools/__init__.py", "tools/gtf.py", "tools/variants.py",
          "tools/variants_ucsc.py", "tools/simulate.py")


class _Normalize(ast.NodeTransformer):
    """Drops imports and docstrings; with port=True also undoes the named
    edits: TorchAligner -> TPUAligner, and every `device` parameter,
    keyword, positional argument and the `--device` option."""

    def __init__(self, port):
        self.port = port

    def _body(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body = body[1:]
        keep = []
        for st in body:
            if isinstance(st, (ast.Import, ast.ImportFrom)):
                continue
            if (self.port and isinstance(st, ast.Expr)
                    and isinstance(st.value, ast.Call)
                    and getattr(st.value.func, "attr", "") == "add_argument"
                    and st.value.args
                    and getattr(st.value.args[0], "value", "") == "--device"):
                continue
            keep.append(st)
        node.body = keep or [ast.Pass()]
        return node

    def generic_visit(self, node):
        node = super().generic_visit(node)
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef)):
            node = self._body(node)
        if not self.port:
            return node
        if isinstance(node, ast.Name) and node.id == "TorchAligner":
            node.id = "TPUAligner"
        if isinstance(node, ast.Call):
            node.keywords = [k for k in node.keywords if k.arg != "device"]
            node.args = [a for a in node.args
                         if not (isinstance(a, ast.Name) and a.id == "device")]
        if isinstance(node, ast.arguments):
            names = [a.arg for a in node.args]
            if "device" in names:
                i = names.index("device")
                nd = len(node.args) - len(node.defaults)
                node.args.pop(i)
                if i >= nd:
                    node.defaults.pop(i - nd)
        return node


def _norm_dump(path, port):
    tree = _Normalize(port).visit(ast.parse(open(path).read(), path))
    return ast.dump(tree, include_attributes=False)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_jax_module(rel):
    port = _norm_dump(os.path.join(REPO, "hisat2_tpu_torch", rel), True)
    jax = _norm_dump(os.path.join(REPO, "hisat2_tpu", rel), False)
    assert port == jax, rel
