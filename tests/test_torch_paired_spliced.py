"""Port parity for paired reads in spliced mode and on sharded indexes, on
the CPU, against hisat2_tpu:

- the paired CLI (`python -m hisat2_tpu_torch align -1 -2 --device cpu`)
  on the pes corpus (tests/data/make_pes.py), in a process where neither
  jax nor hisat2_tpu can import: SAM bodies byte-equal to the JAX CLI's
  oracles, spliced (the default for -1/-2) on a linear and on a --snp
  --ss index, and in DNA mode on two sampled shards;
- the paired runs the JAX CLI fails on are refused up front, naming the
  JAX fault: a sharded graph index (its mate rescue's KeyError: 'snv1')
  and spliced mode on several shards (its give-up replay's KeyError:
  'h_rounds');
- the driver's _align_pair_batch in-process on a spliced aligner with the
  temp-site fixed point, the JAX package's against the port's: the same
  SAM text and the same splice sites;
- the reference chars past a plane's words but inside the text (a
  sharded index's rescue reads shard 0's words at global positions):
  ref_chars_block (K5's twin) against JAX's on its three lowerings (the
  128-word rows forced by lowering JAX's _ROW8_MAX_WORDS, a module
  constant meant for that, and the port's ROW8_MAX_WORDS with it), the
  clamp of JAX's ref_char (K12's twin), and rescue_candidates, whose
  window count reads through the one and its rescoring through the
  other, on windows across and wholly past the words.

Tolerance: exact.
"""

import gzip
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.align import driver as jdriver
from hisat2_tpu.align.paired import PairPolicy as JPairPolicy
from hisat2_tpu.align.pipeline import TPUAligner
from hisat2_tpu.align.scoring import Scoring
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu.io.fasta import ReadBatch as JReadBatch
from hisat2_tpu.io.fasta import iter_fasta
from hisat2_tpu.io.fasta import read_batches as jread_batches
from hisat2_tpu.io.sam import SamWriter as JSamWriter
from hisat2_tpu.ops import rank as jrank
from hisat2_tpu.ops import rescue as jrescue
from hisat2_tpu_torch.align import driver as tdriver
from hisat2_tpu_torch.align.paired import PairPolicy
from hisat2_tpu_torch.align.pipeline import TorchAligner
from hisat2_tpu_torch.io.fasta import ReadBatch, read_batches
from hisat2_tpu_torch.io.sam import SamWriter
from hisat2_tpu_torch.ops import rank as trank
from hisat2_tpu_torch.ops import rescue
from hisat2_tpu_torch.utils.intops import u32_to_tensor

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = ["--shard-bp", "150000", "--offrate", "4"]
GRAPH = ["--snp", os.path.join(DATA, "pes.snp"), "--ss",
         os.path.join(DATA, "pes.ss")]
READS = ["-1", os.path.join(DATA, "pes_reads_1.fa"), "-2",
         os.path.join(DATA, "pes_reads_2.fa")]
# oracle -> (index, extra align arguments)
CASES = {"pes_ref_rna": ("lin", []),
         "pes_ref_snpss": ("gra", []),
         "pes_ref_shard_dna": ("sh", ["--no-spliced-alignment"])}

# makes `import jax` and `import hisat2_tpu` fail, as on the card's machine
NO_JAX = """
import sys
class _NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "hisat2_tpu"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None
sys.meta_path.insert(0, _NoJax())
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs in parallel
    workers, and a thread per core each oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs(argss, cwd):
    """Run the port's CLI once per argument list, the runs side by side
    (one torch thread each); returns their CompletedProcess objects."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    code = (NO_JAX + "import runpy\n"
            "sys.argv = ['hisat2_tpu_torch'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('hisat2_tpu_torch', run_name='__main__')\n"
            "finally:\n"
            "    assert 'jax' not in sys.modules\n"
            "    assert 'hisat2_tpu' not in sys.modules\n")
    procs = [subprocess.Popen([sys.executable, "-c", code] + a,
                              cwd=str(cwd), env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for a in argss]
    out = []
    for a, p in zip(argss, procs):
        so, se = p.communicate(timeout=600)
        out.append(subprocess.CompletedProcess(a, p.returncode, so, se))
    return out


# the refused runs: (index, extra align arguments, the JAX fault named)
REFUSED = {"graph_shards": ("shg", ["--no-spliced-alignment"],
                            "KeyError: 'snv1'"),
           "spliced_shards": ("sh", [], "KeyError: 'h_rounds'")}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The pes genome built by the port (linear, --snp --ss, two shards,
    and two shards of the --snp --ss index), then every CLI run of the
    module: the oracles' and the refused ones."""
    d = tmp_path_factory.mktemp("pes_cli")
    with gzip.open(os.path.join(DATA, "pes_genome.fa.gz"), "rb") as f:
        (d / "g.fa").write_bytes(f.read())
    for r in _runs([["build"] + b + ["g.fa", n] for n, b in (
            ("lin", []), ("gra", GRAPH), ("sh", SHARDS),
            ("shg", GRAPH + SHARDS))], d):
        assert r.returncode == 0, r.stderr[-3000:]
    assert (d / "sh.s1.npz").exists() and (d / "shg.s1.npz").exists()
    runs = {**{k: (i, a, f"{k}.sam") for k, (i, a) in CASES.items()},
            **{k: (i, a, f"{k}.sam") for k, (i, a, _) in REFUSED.items()}}
    done = _runs([["align"] + a + ["-f", "-x", i] + READS
                  + ["-S", o, "--device", "cpu"]
                  for i, a, o in runs.values()], d)
    return d, dict(zip(runs, done))


@pytest.mark.parametrize("oracle", sorted(CASES))
def test_cli_writes_oracle(built, oracle):
    d, done = built
    idx, aargs = CASES[oracle]
    r = done[oracle]
    assert r.returncode == 0, r.stderr[-3000:]
    with open(d / f"{oracle}.sam") as f:
        lines = f.readlines()
    sq = [x.split() for x in lines if x.startswith("@SQ")]
    assert sq == [["@SQ", "SN:eA", "LN:100000"], ["@SQ", "SN:eB", "LN:100000"]]
    with gzip.open(os.path.join(DATA, oracle + ".sam.gz"), "rt") as f:
        want = f.readlines()
    got = [x for x in lines if not x.startswith("@")]
    assert got == want
    body = [x.split("\t") for x in got]
    prim = [x for x in body if not int(x[1]) & 256]
    conc = {x[0] for x in prim if int(x[1]) & 2}
    assert {x[2] for x in prim} >= {"eA", "eB"}
    if aargs:
        return
    # junction mates, and fragments over a 1-15 kbp intron paired through
    # the intron length the splice-site table knows
    assert sum("N" in x[5] for x in prim) >= 25
    assert sum("_sp" in n for n in conc) >= 18
    assert sum("_rep" in n for n in conc) == 20       # the repeat mates
    if idx == "gra":
        assert "Zs:Z:" in "".join(got)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_cli_refuses_what_jax_fails_on(built, case):
    d, done = built
    r = done[case]
    assert r.returncode == 1
    assert REFUSED[case][2] in r.stderr and "hisat2_tpu/align/" in r.stderr
    sam = d / f"{case}.sam"
    assert not sam.exists() or not [
        x for x in open(sam) if not x.startswith("@")]


# -- the driver's pair batch in-process ------------------------------------
PICK = (list(range(0, 6)) + list(range(50, 62)) + list(range(80, 88))
        + list(range(100, 106)) + [120, 121, 130, 131, 140, 141])


def _picked(rb, reader, m):
    b = next(reader(os.path.join(DATA, f"pes_reads_{m}.fa"), 1000))
    return rb([b.names[i] for i in PICK],
              [b.codes[i, :b.lens[i]] for i in PICK],
              [b.quals[i, :b.lens[i]] for i in PICK])


def test_align_pair_batch_spliced_matches_jax():
    """A fused batch of 38 pairs (plain, junction, intron-spanning,
    repeat, random, cross-chromosome and far mates) through both
    drivers' _align_pair_batch with the CLI's spliced defaults: pairing
    through the intron lengths, the rescue, the temp-site fixed point."""
    idx = build_fm_index(list(iter_fasta(
        os.path.join(DATA, "pes_genome.fa.gz"))))
    names, lens = list(idx.meta.ref_names), idx.meta.ref_lens
    outs, sites = [], []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            al = TPUAligner(idx, spliced=True, lane_meta=True)
            rb, rd, drv, pol, sw = (JReadBatch, jread_batches, jdriver,
                                    JPairPolicy, JSamWriter)
        else:
            al = TorchAligner(idx, spliced=True, lane_meta=True,
                              device="cpu")
            rb, rd, drv, pol, sw = (ReadBatch, read_batches, tdriver,
                                    PairPolicy, SamWriter)
        b1, b2 = (_picked(rb, rd, m) for m in (1, 2))
        sink = io.StringIO()
        w = sw(sink, names, lens, no_head=True)
        ref_fn = lambda p, s, a=al: a.ref_codes[p:p + s]  # noqa: E731
        drv._align_pair_batch(al, w, pol(spliced=True), al.scoring, al.k,
                              b1, b2, ref_fn)
        outs.append(sink.getvalue())
        sites.append(al.splice_db.sites)
    assert outs[1] == outs[0]
    assert sites[1] == sites[0]
    body = [x.split("\t") for x in outs[1].splitlines()]
    conc = {x[0] for x in body if int(x[1]) & 2}
    assert sum("N" in x[5] for x in body) >= 8
    assert sum("_sp" in n for n in conc) >= 6 and sum(
        "_rep" in n for n in conc) >= 4


# -- chars past the words: K5's and K12's twins ----------------------------
def _words(nw, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, nw, dtype=np.uint64).astype(np.uint32)


# (word count, JAX lowering): 8-word rows, 128-word rows (forced), and
# the flat gather of an unpadded plane
LOWERINGS = [(520, 8), (512, 128), (517, 1)]


def _lowering(monkeypatch, nw, row):
    if row == 128:
        monkeypatch.setattr(jrank, "_ROW8_MAX_WORDS", 256)
        monkeypatch.setattr(trank, "ROW8_MAX_WORDS", 256)
    assert trank.clamp_row(nw) == row


@pytest.mark.parametrize("nw,row", LOWERINGS)
def test_ref_chars_past_the_words_match_jax(monkeypatch, nw, row):
    _lowering(monkeypatch, nw, row)
    words = _words(nw, nw)
    end = 16 * nw
    n_text = end + 5000
    L = 137
    starts = np.array([[-60, 0, 5, end - 300],
                       [end - 137, end - 40, end - 1, end],
                       [end + 3, end + 129, end + 2047, end + 4000],
                       [n_text - 100, n_text - 1, n_text + 7, 17]],
                      np.int32)
    j = np.asarray(jrank.ref_chars_block(jnp.asarray(words), n_text,
                                         jnp.asarray(starts), L))
    t = trank.ref_chars_block(u32_to_tensor(words, "cpu"), n_text,
                              torch.from_numpy(starts), L).numpy()
    np.testing.assert_array_equal(t, j)
    # ref_char's clamp: the word index to the last word
    pos = starts[..., None].astype(np.int64) + np.arange(L)
    jc = np.asarray(jrank.ref_char(jnp.asarray(words), jnp.asarray(
        np.clip(pos, 0, n_text - 1).astype(np.int32))))
    jc = np.where((pos < 0) | (pos >= n_text), 4, jc)
    t1 = trank.ref_chars_block(u32_to_tensor(words, "cpu"), n_text,
                               torch.from_numpy(starts), L, row=1).numpy()
    np.testing.assert_array_equal(t1, jc)
    past = (pos >= end) & (pos < n_text)
    assert past.sum() >= 1000 and (t[past] < 4).all()
    if row > 1:
        assert (t[past] != t1[past]).any()       # the two clamps differ


@pytest.mark.parametrize("nw,row", LOWERINGS[:2])
def test_rescue_past_the_words_matches_jax(monkeypatch, nw, row):
    """rescue_candidates on windows across and past 16 * nw: the counts
    read ref_char's clamp (K12's twin), the rescoring the row clamp (K5's
    twin); mates copied from both virtual texts, and random ones."""
    _lowering(monkeypatch, nw, row)
    words = _words(nw, 3 * nw)
    end = 16 * nw
    n_text = end + 6000
    Wd, L, R = 1200, 100, 8
    rng = np.random.default_rng(nw)
    ws = np.array([end - 900, end - 60, end, end + 700, end + 2100,
                   end + 4100, n_text - 700, end - 3000], np.int32)
    wt = u32_to_tensor(words, "cpu")
    virt = {r: trank.ref_chars_block(wt, n_text, torch.tensor([0]),
                                     n_text, row=r)[0].numpy()
            for r in (1, row)}
    reads = rng.integers(0, 4, (R, L)).astype(np.int32)
    for i in range(R - 1):
        v = virt[(1, row)[i % 2]]
        s = int(ws[i]) + int(rng.integers(0, Wd - L))
        s = min(max(s, 0), n_text - L)
        reads[i] = np.minimum(v[s:s + L], 3)
        if i % 3 == 2:
            reads[i, rng.integers(0, L, 3)] = rng.integers(0, 4, 3)
    quals = rng.integers(5, 41, (R, L)).astype(np.int32)
    lens = np.full(R, L, np.int32)
    lens[5] = 71
    reads[5, 71:] = 4
    sc = Scoring()
    mm, cp = sc.mm_pen_table(), sc.clip_pen_table()
    js, je = jrescue.rescue_candidates(
        jnp.asarray(words), n_text, jnp.asarray(reads), jnp.asarray(quals),
        jnp.asarray(lens), jnp.asarray(ws), Wd, jnp.asarray(mm),
        jnp.asarray(cp), sc.n_pen)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ts, te = rescue.rescue_candidates(
        wt, n_text, t(reads), t(quals), t(lens), t(ws), Wd,
        t(mm.astype(np.int32)), t(cp.astype(np.int32)), sc.n_pen)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for f in je._fields:
        np.testing.assert_array_equal(getattr(te, f).numpy(),
                                      np.asarray(getattr(je, f)), err_msg=f)
    assert (ts.numpy() >= end).sum() > 20
    assert (te.score.numpy() == 0).any()          # an exact past-words hit
