"""Port parity for the paired-DNA slice, on the CPU, against hisat2_tpu:

- K12's plain twin (ops/rescue.py) against hisat2_tpu.ops.rescue.
  rescue_candidates run as JAX on the CPU: the starts and every
  ExtendResult field equal, at L = 100, 150 and 300 (300 takes the
  bfloat16 rounding of the match counts), on windows at the text's start
  and past its end, mates with Ns, the 15-copy tie window of
  tests/test_rescue.py, and a graph index with SNV planes;
- TorchAligner.rescue_mates against TPUAligner.rescue_mates, field by
  field, on that fixture and on random jobs;
- align_batch(paired=True) on a fused pair batch of the committed corpus:
  raw columns and lane metadata equal, on a linear and a graph index;
- the paired CLI (`python -m hisat2_tpu_torch align -1 -2 --device cpu`)
  in a process where neither jax nor hisat2_tpu can import: SAM bodies
  byte-equal to the committed oracles tests/data/pe_ref*.sam.gz (written
  by hisat2_tpu, tests/data/make_pe.py) on the linear and the graph index,
  under --no-mixed and --no-discordant, and with --12 input plus
  --un-conc/--al-conc files.
"""

import dataclasses
import gzip
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.align.pipeline import TPUAligner
from hisat2_tpu.align.scoring import Scoring
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu.index.graph import build_graph_arrays
from hisat2_tpu.index.variants import attach_variants
from hisat2_tpu.ops import rescue as jrescue
from hisat2_tpu_torch.align.driver import _dispatch_pair_batch
from hisat2_tpu_torch.align.pipeline import TorchAligner
from hisat2_tpu_torch.index.format import _pad128
from hisat2_tpu_torch.io.fasta import iter_fasta, read_batches
from hisat2_tpu_torch.ops import rescue
from hisat2_tpu_torch.utils.intops import u32_to_tensor

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 57344
SPOTS = [20000 + 18000 * i for i in range(15)]
N_TEXT = 300_000
LONG_AT = (240_000, 240_900, 242_700, 246_000)

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


@pytest.fixture(scope="module")
def genome():
    """tests/test_rescue.py's fixture (a 120 bp unit 15 times at 18 kbp
    spacing in 300 kbp) plus a 300 bp unit 4 times with 1, 0, 2 and 3
    mismatches."""
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, N_TEXT).astype(np.uint8)
    unit = rng.integers(0, 4, 120).astype(np.uint8)
    for s in SPOTS:
        g[s:s + 120] = unit
    long_unit = rng.integers(0, 4, 300).astype(np.uint8)
    for c, at in zip((1, 0, 2, 3), LONG_AT):    # mismatches per copy
        g[at:at + 300] = long_unit
        g[at + np.arange(c) * 7 + 3] ^= 1
    return g, long_unit


@pytest.fixture(scope="module")
def indexes(genome, tmp_path_factory):
    g, _ = genome
    lin = build_fm_index([("chrP", g)])
    gi = build_fm_index([("chrP", g)])
    rng = np.random.default_rng(8)
    pos = np.sort(rng.choice(np.arange(100, N_TEXT - 100), 3000,
                             replace=False))
    snp = tmp_path_factory.mktemp("pe_snp") / "v.snp"
    snp.write_text("".join(
        f"v{k}\tsingle\tchrP\t{p}\t{'ACGT'[(int(g[p]) + 1 + k % 3) % 4]}\n"
        for k, p in enumerate(pos)))
    attach_variants(gi, snp_file=str(snp))
    return lin, gi


def _jobs(genome, L, R=10, seed=0):
    """Rescue jobs: random mates, the tie window, the 300 bp near-copies,
    windows at the start (negative) and past the end, Ns, short mates."""
    g, long_unit = genome
    rng = np.random.default_rng(seed + L)
    reads = np.full((R, L), 4, np.int32)
    lens = np.full(R, L, np.int32)
    ws = np.zeros(R, np.int64)
    for i in range(R):
        s = int(rng.integers(0, N_TEXT - L))
        reads[i] = g[s:s + L]
        ws[i] = (s - int(rng.integers(0, W - L))) // 56320 * 56320
    reads[0, :100] = g[SPOTS[0] + 10:SPOTS[0] + 110]
    ws[0] = 0
    reads[1, :min(L, 300)] = long_unit[:L]
    ws[1] = LONG_AT[0] // 56320 * 56320
    ws[2], ws[3] = -56320, N_TEXT - 1000
    reads[2], reads[3] = g[:L], g[N_TEXT - L:]
    reads[4:6, ::11] = 4
    lens[6:8] = L - np.array([7, 29])
    for i in (6, 7):
        reads[i, lens[i]:] = 4
    quals = rng.integers(5, 41, (R, L)).astype(np.int32)
    return reads, quals, lens, ws.astype(np.int32)


@pytest.mark.parametrize("L,graph", [(100, False), (150, False),
                                     (300, False), (100, True)])
def test_rescue_candidates_matches_jax(genome, indexes, L, graph):
    idx = indexes[graph]
    reads, quals, lens, ws = _jobs(genome, L)
    sc = Scoring()
    mm, cp = sc.mm_pen_table(), sc.clip_pen_table()
    rw = _pad128(idx.ref_words)
    snv = None
    if graph:
        ga = build_graph_arrays(idx, idx._variants)
        snv = [_pad128(ga.snv_delta1), _pad128(ga.snv_delta2)]
    js, je = jrescue.rescue_candidates(
        jnp.asarray(rw), idx.meta.n, jnp.asarray(reads), jnp.asarray(quals),
        jnp.asarray(lens), jnp.asarray(ws), W, jnp.asarray(mm),
        jnp.asarray(cp), sc.n_pen,
        snv_delta1=jnp.asarray(snv[0]) if graph else None,
        snv_delta2=jnp.asarray(snv[1]) if graph else None)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    ts, te = rescue.rescue_candidates(
        u32_to_tensor(rw, "cpu"), idx.meta.n, t(reads), t(quals), t(lens),
        t(ws), W, t(mm.astype(np.int32)), t(cp.astype(np.int32)), sc.n_pen,
        snv_delta1=u32_to_tensor(snv[0], "cpu") if graph else None,
        snv_delta2=u32_to_tensor(snv[1], "cpu") if graph else None)
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert tuple(je._fields) == tuple(te._fields)
    for f in je._fields:
        np.testing.assert_array_equal(np.asarray(getattr(je, f)),
                                      getattr(te, f).numpy(), err_msg=f)
    if L == 100:
        # the tie window: three copies count 100, the lowest ranks first
        assert ts[0, :3].tolist() == [SPOTS[0] + 10, SPOTS[1] + 10,
                                      SPOTS[2] + 10]
    if L == 300:
        # the first copy counts 299 and the second 300: both read 300
        # in bfloat16, so the lower diagonal ranks first
        assert ts[1, :2].tolist() == [LONG_AT[0], LONG_AT[1]]
    if graph:
        assert int(te.n_snp.sum()) > 0


def _asdicts(lst):
    return [[dataclasses.asdict(a) for a in alns] for alns in lst]


@pytest.mark.parametrize("graph", [False, True])
def test_rescue_mates_matches_jax(genome, indexes, graph):
    g, _ = genome
    idx = indexes[graph]
    var = idx._variants if graph else None
    ja = TPUAligner(idx, variants=var)
    ta = TorchAligner(idx, variants=var, device="cpu")
    rng = np.random.default_rng(13 + graph)
    R, L = 21, 100
    codes = np.full((R, L), 4, np.uint8)
    lens = np.full(R, L, np.int32)
    anchors = np.zeros(R, np.int64)
    rcf = rng.random(R) < 0.5
    for i in range(R):
        s = int(rng.integers(0, N_TEXT - L))
        m = g[s:s + L].copy()
        m[rng.integers(0, L, int(rng.integers(0, 4)))] = rng.integers(0, 4)
        if rcf[i]:
            m = (3 - m)[::-1]
        codes[i] = m
        anchors[i] = s + int(rng.integers(-400, 400))
    s = SPOTS[0]                                # the test_rescue fixture
    codes[0] = g[s + 10:s + 110]
    anchors[0], rcf[0] = s - 250, False
    codes[1, :] = g[SPOTS[3] + 10:SPOTS[3] + 110]   # 15 copies, 3 in the
    anchors[1], rcf[1] = SPOTS[2], False             # window: rescued
    anchors[2] = N_TEXT - 50                     # a window past the text
    codes[2] = g[N_TEXT - L:]
    rcf[2] = False
    lens[3] = 77
    codes[3, 77:] = 4
    quals = rng.integers(10, 41, (R, L)).astype(np.uint8)
    jr = ja.rescue_mates(codes, quals, lens, anchors, rcf, 500)
    tr = ta.rescue_mates(codes, quals, lens, anchors, rcf, 500)
    assert _asdicts(jr) == _asdicts(tr)
    assert tr[0] and tr[0][0].joined_pos == s + 10 and tr[0][0].zs == 0
    assert sum(bool(x) for x in tr) > R // 2


@pytest.fixture(scope="module")
def pe_batch():
    b1 = next(read_batches(f"{DATA}/pe_reads_1.fa", 256, fmt="fasta"))
    b2 = next(read_batches(f"{DATA}/pe_reads_2.fa", 256, fmt="fasta"))
    seqs = list(iter_fasta(f"{DATA}/pe_genome.fa.gz"))
    return b1, b2, seqs


@pytest.mark.parametrize("graph", [False, True])
def test_align_batch_paired_matches_jax(pe_batch, graph):
    """The fused pair batch (mate 1 reads, then mate 2 reads) through
    align_batch(paired=True): the lite and full passes on a graph index,
    the skipped unpaired interleave replay, the lane metadata the paired
    give-up replay reads."""
    b1, b2, seqs = pe_batch
    idx = build_fm_index(seqs)
    var = None
    if graph:
        attach_variants(idx, snp_file=f"{DATA}/pe.snp")
        var = idx._variants
    ja = TPUAligner(idx, variants=var, lane_meta=True, k=10 if graph else 5)
    ta = TorchAligner(idx, variants=var, lane_meta=True,
                      k=10 if graph else 5, device="cpu")
    B = len(b1.names)
    rd = np.arange(B, dtype=np.int64)
    (handle, lens) = _dispatch_pair_batch(ta, b1, b2, rd)
    tr = ta.collect(handle, paired=True)
    codes = np.concatenate([b1.codes, b2.codes])
    quals = np.concatenate([b1.quals, b2.quals])
    jres = ja.align_batch(codes, quals, lens, np.concatenate([rd, rd]),
                          paired=True)
    assert tr.orient_ranks is None and jres.orient_ranks is None
    for a, b in zip(jres.raw["cols"], tr.raw["cols"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert sorted(jres.lanes) == sorted(tr.lanes)
    for k in jres.lanes:
        np.testing.assert_array_equal(np.asarray(jres.lanes[k]),
                                      np.asarray(tr.lanes[k]), err_msg=k)
    assert tr.n_aligned > 300


def _run_port(args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    code = (NO_JAX + "import runpy\n"
            "sys.argv = ['hisat2_tpu_torch'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('hisat2_tpu_torch', run_name='__main__')\n"
            "finally:\n"
            "    assert 'jax' not in sys.modules\n"
            "    assert 'hisat2_tpu' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code] + args, cwd=str(cwd),
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.fixture(scope="module")
def pe_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pe_cli")
    with gzip.open(f"{DATA}/pe_genome.fa.gz", "rb") as f:
        (d / "g.fa").write_bytes(f.read())
    _run_port(["build", "g.fa", "idx"], d)
    _run_port(["build", "--snp", f"{DATA}/pe.snp", "g.fa", "idxs"], d)
    return d


def _body(path):
    with open(path) as f:
        return [x for x in f if not x.startswith("@")]


def _oracle(name):
    with gzip.open(f"{DATA}/{name}.sam.gz", "rt") as f:
        return f.readlines()


MATES = ["-1", f"{DATA}/pe_reads_1.fa", "-2", f"{DATA}/pe_reads_2.fa", "-f"]


@pytest.mark.parametrize("oracle,idx,extra", [
    ("pe_ref", "idx", MATES),
    ("pe_ref_snp", "idxs", MATES),
    ("pe_ref_nomixed", "idx", MATES + ["--no-mixed"]),
    ("pe_ref_nodisc", "idx", MATES + ["--no-discordant"]),
    ("pe_ref", "idx", ["--12", f"{DATA}/pe_reads.tab", "--un-conc",
                       "un.fa", "--al-conc", "al.fa"]),
])
def test_paired_cli_matches_oracle(pe_dir, oracle, idx, extra):
    out = f"out_{oracle}_{len(extra)}.sam"
    _run_port(["align", "--no-spliced-alignment", "-x", idx, "-S", out,
               "--device", "cpu"] + extra, pe_dir)
    got = _body(pe_dir / out)
    assert got == _oracle(oracle)
    flags = [int(x.split("\t")[1]) for x in got]
    assert sum(f & 2 > 0 for f in flags) > 250       # concordant mates
    if "--un-conc" in extra:
        with gzip.open(f"{DATA}/pe_ref_conc.txt.gz", "rt") as f:
            want = f.read()
        have = "".join(f"== {n}\n" + (pe_dir / n).read_text()
                       for n in ("un.1.fa", "un.2.fa", "al.1.fa", "al.2.fa"))
        assert have == want
