"""The port's spliced mode end to end on the CPU: the CLI (the default,
spliced, mode) on the committed nss and mj3x corpora against their
oracles, unpaired and paired, the splice-site files, and
tests/test_spliced.py's cases re-run on the port (their expectations were
verified against hisat2-align-s on the same fixtures).  The port alone:
its output must equal the oracle byte for byte."""

import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from hisat2_tpu_torch.align.pipeline import TorchAligner
from hisat2_tpu_torch.index import build_fm_index as t_build_fm_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")


def _run(args, cwd, ok=True):
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "hisat2_tpu_torch"] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=600)
    if ok:
        assert r.returncode == 0, r.stderr[-3000:]
    return r


def _body(path, opener=open):
    with opener(path, "rt") as f:
        return [x for x in f if not x.startswith("@")]


def _index(tmp_path_factory, tag):
    d = tmp_path_factory.mktemp(tag)
    with gzip.open(f"{DATA}/{tag}_genome.fa.gz", "rb") as f, \
            open(d / "g.fa", "wb") as o:
        o.write(f.read())
    _run(["build", "g.fa", "idx"], str(d))
    return d


@pytest.fixture(scope="module")
def nss_idx(tmp_path_factory):
    return _index(tmp_path_factory, "nss")


def test_cli_novel_splicesite_round_trip(nss_idx):
    """p1 writes novel.ss (== the oracle's), p2 reads it back; both SAM
    bodies equal the committed oracles (tests/test_reporting_modes.py:86
    on the port)."""
    d = str(nss_idx)
    _run(["align", "-f", "-x", "idx", "-U", f"{DATA}/nss_reads.fa",
          "--novel-splicesite-outfile", "novel.ss", "-S", "p1.sam",
          "--device", "cpu"], d)
    with open(os.path.join(d, "novel.ss")) as f, \
            open(f"{DATA}/nss_ref_novel.ss") as g:
        assert f.read() == g.read()
    assert _body(os.path.join(d, "p1.sam")) == _body(
        f"{DATA}/nss_ref_p1.sam.gz", gzip.open)
    _run(["align", "-f", "-x", "idx", "-U", f"{DATA}/nss_reads.fa",
          "--novel-splicesite-infile", f"{DATA}/nss_ref_novel.ss",
          "-S", "p2.sam", "--device", "cpu"], d)
    assert _body(os.path.join(d, "p2.sam")) == _body(
        f"{DATA}/nss_ref_p2.sam.gz", gzip.open)


def test_cli_known_splicesite_infile(nss_idx):
    """--known-splicesite-infile loads the same sites as from-file sites:
    no novel site is left to write."""
    d = str(nss_idx)
    _run(["align", "-f", "-x", "idx", "-U", f"{DATA}/nss_reads.fa",
          "--known-splicesite-infile", f"{DATA}/nss_ref_novel.ss",
          "--novel-splicesite-outfile", "k.ss", "-S", "k.sam",
          "--device", "cpu"], d)
    with open(os.path.join(d, "k.ss")) as f:
        assert f.read() == ""
    assert len(_body(os.path.join(d, "k.sam"))) == 30


def test_cli_three_junction_reads(tmp_path_factory):
    """Reads crossing three introns (tests/test_reporting_modes.py:110 on
    the port; mj3_a25 is the JAX package's known residual)."""
    d = str(_index(tmp_path_factory, "mj3x"))
    _run(["align", "-f", "-x", "idx", "-U", f"{DATA}/mj3x_reads.fa",
          "-S", "out.sam", "--device", "cpu"], d)
    got = {x.split("\t")[0]: x for x in _body(os.path.join(d, "out.sam"))}
    want = {x.split("\t")[0]: x
            for x in _body(f"{DATA}/mj3x_ref.sam.gz", gzip.open)}
    for k in want:
        if k != "mj3_a25":
            assert got.get(k) == want[k], k


def test_cli_refuses_spliced_paired(nss_idx):
    """Spliced paired reads (the default for -1/-2), every read its own
    mate: the SAM body equals the JAX CLI's (tests/data/make_pes.py)."""
    _run(["align", "-f", "-x", "idx", "-1", f"{DATA}/nss_reads.fa",
          "-2", f"{DATA}/nss_reads.fa", "-S", "pe.sam", "--device",
          "cpu"], str(nss_idx))
    got = _body(os.path.join(str(nss_idx), "pe.sam"))
    assert got == _body(f"{DATA}/pes_ref_nss.sam.gz", gzip.open)
    assert sum("N" in x.split("\t")[5] for x in got) >= 30


_INTRONS = [(30000, 200), (60000, 1000), (90000, 5000), (120000, 80),
            (150000, 20000), (180000, 500)]


def _genome():
    """tests/test_spliced.py:13's genome."""
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, 200000).astype(np.uint8)
    for s, ln in _INTRONS:
        g[s], g[s + 1] = 2, 3
        g[s + ln - 2], g[s + ln - 1] = 0, 2
    return g


@pytest.fixture(scope="module")
def port_rna():
    g = _genome()
    idx = t_build_fm_index([("chrT", g)])
    return TorchAligner(idx, spliced=True, device="cpu"), g


def _align_one(al, read):
    L = len(read)
    res = al.align_batch(read[None, :].astype(np.int32),
                         np.full((1, L), 40, np.int32),
                         np.array([L], np.int32))
    return res.alignments[0]


def test_port_novel_splice_exact(port_rna):
    al, g = port_rna
    a = _align_one(al, np.concatenate([g[29950:30000], g[30200:30250]]))[0]
    assert (a.junc_kind, a.junc_x, a.junc_len) == (1, 50, 200)
    assert a.ref_pos == 29950 and a.score == 0 and a.spl_dir == 1
    assert a.mapq == 60 and a.nh == 1


def test_port_long_intron_length_penalty(port_rna):
    al, g = port_rna
    a = _align_one(al, np.concatenate([g[149980:150000],
                                       g[170000:170080]]))[0]
    assert (a.junc_kind, a.junc_x, a.junc_len) == (1, 20, 20000)
    assert a.score == -1


def test_port_short_anchor_gated(port_rna):
    al, g = port_rna
    a = _align_one(al, np.concatenate([g[59990:60000], g[61000:61090]]))[0]
    assert a.junc_kind == 0 and a.clip_l == 10 and a.score == -20


@pytest.mark.parametrize("kind", ["del", "ins"])
def test_port_novel_indels(port_rna, kind):
    al, g = port_rna
    if kind == "del":
        p = 40000
        a = _align_one(al, np.concatenate([g[p:p + 50],
                                           g[p + 55:p + 105]]))[0]
        assert a.junc_kind == 2 and a.junc_len == 5
        assert a.score == -(5 + 3 * 5)
    else:
        p = 45000
        a = _align_one(al, np.concatenate(
            [g[p:p + 50], np.array([1, 2, 3], np.uint8), g[p + 50:p + 97]]))[0]
        assert a.junc_kind == 3 and a.junc_len == -3
        assert a.score == -(5 + 3 * 3)


def test_port_spliced_sam_rendering(port_rna):
    from hisat2_tpu_torch.io.sam import SamWriter
    al, g = port_rna
    read = np.concatenate([g[29950:30000], g[30200:30250]])
    alns = _align_one(al, read)
    sink = io.StringIO()
    w = SamWriter(sink, ["chrT"], [len(g)], no_head=True)
    w.write_read("r1", read.astype(np.int32), np.full(100, 40, np.int32),
                 alns, lambda p, s: g[p:p + s])
    fields = sink.getvalue().strip().split("\t")
    assert fields[3] == "29951" and fields[5] == "50M200N50M"
    assert "XS:A:+" in fields and "NM:i:0" in fields and "MD:Z:100" in fields
    assert fields.index("YT:Z:UU") < fields.index("XS:A:+") < \
        fields.index("NH:i:1")


def _mini(seed, n, introns, motifs=None):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    for k, (s, ln) in enumerate(introns):
        (d0, d1), (a0, a1) = (motifs or [((2, 3), (0, 2))] * len(introns))[k]
        g[s], g[s + 1], g[s + ln - 2], g[s + ln - 1] = d0, d1, a0, a1
    return TorchAligner(t_build_fm_index([("chrM", g)]), spliced=True,
                        device="cpu"), g


def test_port_two_junction_read():
    al, g = _mini(21, 150000, [(40000, 400), (40440, 600)])
    read = np.concatenate([g[39970:40000], g[40400:40440], g[41040:41070]])
    a = _align_one(al, read)[0]
    assert a.junc_kind == 1 and a.junc2_kind == 1
    assert (a.junc_x, a.junc_len) == (30, 400)
    assert (a.junc2_x, a.junc2_len) == (70, 600)
    assert a.score == 0 and a.mapq == 60


def test_port_noncan_junction_budget_window():
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, 200000).astype(np.uint8)
    g[30000], g[30001] = 3, 3
    g[34998], g[34999] = 3, 3
    al = TorchAligner(t_build_fm_index([("chrT", g)]), spliced=True,
                      device="cpu")
    a = _align_one(al, np.concatenate([g[29942:30000], g[35000:35042]]))[0]
    assert (a.ref_pos, a.score, a.junc_kind, a.junc_x, a.junc_len,
            a.spl_dir) == (29942, -18, 1, 63, 5000, 2)


def test_port_conflicting_splice_strands_dropped():
    al, g = _mini(33, 150000, [(40000, 400), (40440, 600)],
                  [((2, 3), (0, 2)), ((1, 3), (0, 1))])
    read = np.concatenate([g[39970:40000], g[40400:40440], g[41040:41070]])
    for a in _align_one(al, read):
        both = a.junc_kind == 1 and a.junc2_kind == 1
        dirs = {a.spl_dir, a.junc2_dir}
        conflict = both and (dirs & {1, 3}) and (dirs & {2, 4})
        assert not (conflict and a.score >= -100), a


def test_port_refuses_out_of_slice_modes(tmp_path):
    """Spliced runs on a graph index, refused until the graph slice came,
    now run: a spliced aligner on a one-SNV index builds and places a read
    carrying the SNV's allele as hisat2_tpu does (its row and Zs tag)."""
    from hisat2_tpu.align.pipeline import TPUAligner
    from hisat2_tpu.index.builder import build_fm_index
    from hisat2_tpu.index.variants import attach_variants
    g = _genome()[:30000]
    alt = (int(g[5000]) + 1) % 4
    idx = build_fm_index([("c1", g)])
    snp = tmp_path / "v.snp"
    snp.write_text(f"rs1\tsingle\tc1\t5000\t{'ACGT'[alt]}\n")
    attach_variants(idx, snp_file=str(snp))
    ta = TorchAligner(idx, variants=idx._variants, spliced=True,
                      device="cpu")
    ja = TPUAligner(idx, variants=idx._variants, spliced=True)
    read = g[4950:5050].copy()
    read[50] = alt
    a, b = _align_one(ja, read), _align_one(ta, read)
    assert [str(x) for x in a] == [str(x) for x in b] and len(b) == 1
    assert b[0].ref_pos == 4950 and b[0].score == 0
    rd = read.astype(np.int32)
    assert ta.annotate_snps(b[0], rd) == ja.annotate_snps(a[0], rd) == \
        ("50|S|rs1", (50,))
