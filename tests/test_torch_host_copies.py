"""The port's copies of the JAX package's numpy host modules behave as the
originals, on the CPU:

- index/builder: equal FM index arrays for the mm3 genome; for the gdna
  genome with gdna.snp, equal VariantDB arrays and graph arrays;
- index/format: an index saved by either package loads in the other;
- index/ht2: the conversion of the tests/data/ht2fix reference index is
  equal;
- io/fasta: equal read batches (FASTA, FASTQ-free tabbed pairs);
- io/sam: SamWriter.write_pair writes the same bytes on the same pair
  records (concordant, discordant, mixed, unaligned; Zs tags on a graph
  index), taken from a real paired batch of the committed corpus.
"""

import dataclasses
import io
import os

import numpy as np
import pytest

from hisat2_tpu.align.pipeline import Alignment as JAlignment
from hisat2_tpu.index import builder as jbuilder
from hisat2_tpu.index import graph as jgraph
from hisat2_tpu.index import ht2 as jht2
from hisat2_tpu.index import variants as jvariants
from hisat2_tpu.index.format import FMIndex as JFMIndex
from hisat2_tpu.io import fasta as jfasta
from hisat2_tpu.io import sam as jsam
from hisat2_tpu_torch.align import driver
from hisat2_tpu_torch.align.paired import PairPolicy
from hisat2_tpu_torch.align.pipeline import TorchAligner
from hisat2_tpu_torch.index import builder as tbuilder
from hisat2_tpu_torch.index import graph as tgraph
from hisat2_tpu_torch.index import ht2 as tht2
from hisat2_tpu_torch.index import variants as tvariants
from hisat2_tpu_torch.index.format import FMIndex as TFMIndex
from hisat2_tpu_torch.io import fasta as tfasta
from hisat2_tpu_torch.io import sam as tsam

DATA = os.path.join(os.path.dirname(__file__), "data")


def _arrays_equal(a, b):
    assert dataclasses.asdict(a.meta) == dataclasses.asdict(b.meta)
    aa, ba = a.arrays(), b.arrays()
    assert sorted(aa) == sorted(ba)
    for k in aa:
        np.testing.assert_array_equal(np.asarray(aa[k]), np.asarray(ba[k]),
                                      err_msg=k)


def _fields_equal(x, y):
    for f in dataclasses.fields(x):
        a, b = getattr(x, f.name), getattr(y, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _genome(name):
    return list(jfasta.iter_fasta(f"{DATA}/{name}_genome.fa.gz"))


def test_builder_matches_jax_mm3():
    seqs = _genome("mm3")
    _arrays_equal(jbuilder.build_fm_index(seqs),
                  tbuilder.build_fm_index(seqs))


def test_builder_variants_graph_match_jax_gdna():
    seqs = _genome("gdna")
    ji = jvariants.attach_variants(jbuilder.build_fm_index(seqs),
                                   snp_file=f"{DATA}/gdna.snp")
    ti = tvariants.attach_variants(tbuilder.build_fm_index(seqs),
                                   snp_file=f"{DATA}/gdna.snp")
    _arrays_equal(ji, ti)
    _fields_equal(ji._variants, ti._variants)
    assert ti._variants.n_snps == 60
    _fields_equal(jgraph.build_graph_arrays(ji, ji._variants),
                  tgraph.build_graph_arrays(ti, ti._variants))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_saved_index_loads_in_the_other_package(tmp_path, writer):
    seqs = _genome("pe")
    idx = (jbuilder if writer == "jax" else tbuilder).build_fm_index(seqs)
    idx.save(str(tmp_path / "idx"))
    other = TFMIndex if writer == "jax" else JFMIndex
    _arrays_equal(idx, other.load(str(tmp_path / "idx")))


def test_ht2_conversion_matches_jax(tmp_path):
    base = os.path.join(DATA, "ht2fix", "ht2fix")
    jc = jht2.convert_ht2(base, cache_base=str(tmp_path / "j"))
    tc = tht2.convert_ht2(base, cache_base=str(tmp_path / "t"))
    _arrays_equal(JFMIndex.load(jc), TFMIndex.load(tc))
    _fields_equal(jvariants.VariantDB.load(jc), tvariants.VariantDB.load(tc))


@pytest.mark.parametrize("path,kw", [
    ("mm3_reads.fa", {"fmt": "fasta"}),
    ("pe_reads_2.fa", {"fmt": "auto", "skip": 7, "limit": 150}),
    ("gdna_reads.fa", {"fmt": "fasta", "trim5": 3, "trim3": 5}),
])
def test_fasta_batches_match_jax(path, kw):
    jb = list(jfasta.read_batches(f"{DATA}/{path}", 16, **kw))
    tb = list(tfasta.read_batches(f"{DATA}/{path}", 16, **kw))
    assert len(jb) == len(tb) > 1
    for a, b in zip(jb, tb):
        assert a.names == b.names
        for f in ("codes", "quals", "lens"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    jt = list(jfasta.iter_tabbed(f"{DATA}/pe_reads.tab"))
    tt = list(tfasta.iter_tabbed(f"{DATA}/pe_reads.tab"))
    assert len(jt) == len(tt) == 200
    for a, b in zip(jt, tt):
        assert a[0] == b[0] and len(a) == len(b) == 5
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


class _Recorder:
    """Passes write_pair through to a SamWriter and keeps its arguments."""

    def __init__(self, w):
        self.w = w
        self.calls = []

    def write_pair(self, *a, **k):
        self.calls.append((a, k))
        return self.w.write_pair(*a, **k)


def _to_jax(x):
    if isinstance(x, list):
        return [_to_jax(y) for y in x]
    if isinstance(x, tuple):
        return tuple(_to_jax(y) for y in x)
    if dataclasses.is_dataclass(x):
        return JAlignment(**dataclasses.asdict(x))
    return x


@pytest.mark.parametrize("graph", [False, True])
def test_write_pair_matches_jax(graph):
    seqs = _genome("pe")
    idx = tbuilder.build_fm_index(seqs)
    var = None
    if graph:
        tvariants.attach_variants(idx, snp_file=f"{DATA}/pe.snp")
        var = idx._variants
    al = TorchAligner(idx, variants=var, lane_meta=True, device="cpu",
                      k=10 if graph else 5)
    b1 = next(tfasta.read_batches(f"{DATA}/pe_reads_1.fa", 256))
    b2 = next(tfasta.read_batches(f"{DATA}/pe_reads_2.fa", 256))
    names, lens = list(idx.meta.ref_names), idx.meta.ref_lens
    ann = al.annotate_snps if graph else None
    tout, jout = io.StringIO(), io.StringIO()
    rec = _Recorder(tsam.SamWriter(tout, names, lens, no_head=True,
                                   annotator=ann))
    ref_fn = lambda pos, span: al.ref_codes[pos:pos + span]  # noqa: E731
    driver._align_pair_batch(al, rec, PairPolicy(), al.scoring, al.k, b1,
                             b2, ref_fn)
    jw = jsam.SamWriter(jout, names, lens, no_head=True, annotator=ann)
    for a, k in rec.calls:
        jw.write_pair(*_to_jax(a), **k)
    assert tout.getvalue() == jout.getvalue()
    flags = {int(x.split("\t")[1]) for x in tout.getvalue().splitlines()}
    assert {99, 147, 97, 145, 73, 133} <= flags   # CP, DP, mixed + unal
    if graph:
        assert "Zs:Z:" in tout.getvalue()
