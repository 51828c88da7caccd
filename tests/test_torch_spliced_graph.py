"""Port parity for spliced RNA on a SNP + splice-site graph index (config
6's mix, `hisat2-build --snp --ss`): the spliced torch aligner at k = 10
against hisat2_tpu on the CPU, on the committed gss corpus
(tests/data/make_gss.py: two 60 kbp chromosomes, 24 GT..AG introns, half
of them baked in as known sites, a catalog SNV within 10 bp of each
junction, a deletion and an insertion near each, and reads across the
junctions carrying them, on both strands).

- The kernels' plain twins on the arguments the port's own graph step
  gives them, against the JAX functions on the same inputs: K13+K14 with
  the SNV windows against splice.py:pair_sweep(pen_raw, pen) and
  select_pairs; K16 with the SNV windows and deltas against inject_known
  (source prefix from the SNV-forgiving plane, pipeline.py:1117-1120),
  on the lite and the full step; K15 unchanged against second_sweep on
  the raw planes (pipeline.py:1406-1407).
- The whole lite and full step: packed buffers and layouts.
- align_batch through the two tiers and the temp-site fixed point: every
  raw column, the site DB, and the SAM records with their Zs tags
  (align_check, which tests/test_torch_spliced_graph_shards.py runs on
  two shards).

Tolerance: exact (integer results; f32 fields compared by their bits).
"""

import gzip
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hisat2_tpu.align.pipeline import TPUAligner
from hisat2_tpu.align.pipeline import read_alignments as j_read_alignments
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu.index.variants import attach_variants
from hisat2_tpu.io.sam import SamWriter as JSamWriter
from hisat2_tpu.ops import extend as j_extend
from hisat2_tpu.ops import splice as j_splice
from hisat2_tpu_torch.align.host import read_alignments
from hisat2_tpu_torch.align.pipeline import TorchAligner
from hisat2_tpu_torch.io.sam import SamWriter
from hisat2_tpu_torch.ops import splice

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
K = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (the suite runs in parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fasta(path, opener=open):
    seqs, name = {}, None
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                name = line[1:]
                seqs[name] = []
            elif line:
                seqs[name].append(line)
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate("ACGT"):
        lut[ord(c)] = i
    return {k: lut[np.frombuffer("".join(v).encode(), np.uint8)]
            for k, v in seqs.items()}


def _index(shard_bp=None, off_rate=None):
    chroms = _fasta(os.path.join(DATA, "gss_genome.fa.gz"), gzip.open)
    kw = {}
    if shard_bp:
        kw = dict(shard_bp=shard_bp, off_rate=off_rate)
    idx = build_fm_index(list(chroms.items()), **kw)
    attach_variants(idx, snp_file=os.path.join(DATA, "gss.snp"),
                    ss_file=os.path.join(DATA, "gss.ss"))
    return idx


def reads():
    """The corpus reads: (names, codes, quals, lens), seeded qualities."""
    rd = _fasta(os.path.join(DATA, "gss_reads.fa"))
    names = list(rd)
    codes = np.stack([rd[n] for n in names])
    rng = np.random.default_rng(5)
    quals = rng.integers(15, 41, codes.shape).astype(np.uint8)
    return names, codes, quals, np.full(len(codes), codes.shape[1],
                                        np.int32)


def aligners(idx):
    """The spliced JAX and torch aligners at k = 10 on a graph index."""
    return (TPUAligner(idx, variants=idx._variants, spliced=True, k=K,
                       lane_meta=True),
            TorchAligner(idx, variants=idx._variants, spliced=True, k=K,
                         lane_meta=True, device="cpu"))


@pytest.fixture(scope="module")
def gss():
    idx = _index()
    names, codes, quals, lens = reads()
    ja, ta = aligners(idx)
    assert ta.graph is not None and len(idx._variants.ss_ref) == 12
    return dict(idx=idx, ja=ja, ta=ta, names=names, codes=codes,
                quals=quals, lens=lens, cap={})


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _capture(gss, lite):
    """The keyword arguments of each kernel wrapper's first call in the
    port's graph step (lite or full), once per module."""
    if lite not in gss["cap"]:
        ta = gss["ta"]._fast if lite else gss["ta"]
        B = len(gss["lens"])
        minsc = ta._minsc(gss["lens"])
        rd, ss = ta._step_site_args(np.arange(B) + 3)
        cap = {}
        ta.step(*ta.upload(gss["codes"], gss["quals"], gss["lens"], minsc),
                True, capture=cap, rdids=rd, ss=ss)
        gss["cap"][lite] = cap
    return gss["cap"][lite]


def _jax_planes(gss, kw, snv=True):
    """pen_planes of the captured windows, with the SNV windows."""
    gd = gss["ta"].shard_graph_dev[0]
    n = gss["ta"].meta.n
    mstart = torch.where(kw["valid"], kw["starts"], -1)
    W = kw["ch"].shape[2]
    L = kw["reads"].shape[1]
    M = (W - L) // 2
    s1w = s2w = None
    if snv:
        s1w = jnp.asarray(j_splice.diag_chars(
            jnp.asarray(gd["snv1"].numpy().view(np.uint32)), n,
            jnp.asarray(mstart.numpy()), L, M))
        s2w = jnp.asarray(j_splice.diag_chars(
            jnp.asarray(gd["snv2"].numpy().view(np.uint32)), n,
            jnp.asarray(mstart.numpy()), L, M))
    return j_extend.pen_planes(
        jnp.asarray(gss["ta"].dev.ref_words.numpy().view(np.uint32)), n,
        jnp.asarray(kw["reads"].numpy()), jnp.asarray(kw["quals"].numpy()),
        jnp.asarray(kw["lens"].numpy()), jnp.asarray(mstart.numpy()),
        jnp.asarray(kw["mm_pen"].numpy()), kw["n_pen"],
        snv_delta1=jnp.asarray(gd["snv1"].numpy().view(np.uint32)),
        snv_delta2=jnp.asarray(gd["snv2"].numpy().view(np.uint32)),
        win_chars=jnp.asarray(kw["ch"].numpy()), win_margin=M,
        snv1_win=s1w, snv2_win=s2w), M


def test_pair_sweep_snv_windows_match_jax(gss):
    """K13+K14's plain twin with the SNV windows: indel joins on the
    SNV-forgiving plane, splice joins on the raw one."""
    kw = _capture(gss, False)["pair_sweep"]
    assert kw["snv1_w"] is not None
    pl, M = _jax_planes(gss, kw)
    valid = np.asarray(kw["valid"])
    forgiven = (np.asarray(pl.pen) != np.asarray(pl.pen_raw)) & \
        valid[:, :, None]
    assert forgiven.any()
    prm = gss["ja"].splice_params
    tables = tuple(jnp.asarray(t) for t in j_splice.junction_prob_tables())
    a = [jnp.asarray(kw[k].numpy()) for k in ("starts", "valid", "lens",
                                              "minsc")]
    res = jax.jit(lambda ch, pr, pi, mr, st, va, ln, ms: j_splice.pair_sweep(
        ch, pr, pi, mr, st, va, ln, ms, tables, prm,
        max_gap=kw["max_gap"]))(jnp.asarray(kw["ch"].numpy()), pl.pen_raw,
                                pl.pen, pl.mm_raw, *a)
    got, sel, _ = splice.pair_sweep_ref(**kw)
    for f in ("score", "x", "kind", "spldir", "splscore", "raw"):
        _eq(got[f], getattr(res, f), f)
    want = j_splice.select_pairs(res, a[0], top=kw["top"])
    for f in want:
        _eq(sel[f], want[f], f"select_pairs {f}")
    # the raw plane alone (a linear index's sweep) gives other indel joins
    lin, _, _ = splice.pair_sweep_ref(**dict(kw, snv1_w=None, snv2_w=None))
    assert not torch.equal(lin["score"], got["score"])


@pytest.mark.parametrize("lite", (True, False))
def test_inject_known_snv_match_jax(gss, lite):
    """K16's plain twin on a graph index: the source prefix from the
    SNV-forgiving plane, the fresh diagonal forgiven through the SNV
    deltas (splice.py:701-711)."""
    kw = _capture(gss, lite)["inject_known"]
    assert kw["snv_delta1"] is not None
    pl, M = _jax_planes(gss, kw)
    N, C = kw["starts"].shape
    zero3 = jnp.zeros((N, C, 1), jnp.int32)
    al3 = jnp.broadcast_to(jnp.asarray(kw["lens"].numpy())[:, None, None],
                           (N, C, 1))
    take = lambda P: jnp.take_along_axis(P, al3, axis=2)[:, :, 0]  # noqa
    Pm = jnp.concatenate([zero3, jnp.cumsum(pl.mm_raw.astype(jnp.int32),
                                            axis=2)], axis=2)
    P_fg = jnp.concatenate([zero3, jnp.cumsum(pl.pen, axis=2)], axis=2)
    ss = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
          for k, v in kw["tabs"].items()}
    u32 = lambda t: jnp.asarray(t.numpy().view(np.uint32))  # noqa: E731
    j = lambda k: jnp.asarray(kw[k].numpy())  # noqa: E731
    n = kw["n_text"]
    want = jax.jit(lambda words, s1, s2, reads, quals, lens, rdids, starts,
                   valid, P_fg, Pm, ss, mm_pen, minsc, cl, cr, clip_pen:
                   j_splice.inject_known(
                       words, n, reads, quals, lens, rdids, starts, valid,
                       P_fg, take(P_fg), Pm, take(Pm), ss["ss_kd"],
                       ss["ss_ka"], ss["ss_rdid"], ss["ss_ka_s"],
                       ss["ss_kd_s"], ss["ss_rdid_a"], mm_pen, 1, minsc,
                       slots=kw["slots"], src_clip_l=cl, src_clip_r=cr,
                       clip_pen=clip_pen, snv_delta1=s1, snv_delta2=s2,
                       kd_lob=ss.get("ss_kd_lob"),
                       ka_lob=ss.get("ss_ka_lob"),
                       ss_shift=ss.get("ss_shift")))(
        u32(kw["ref_words"]), u32(kw["snv_delta1"]), u32(kw["snv_delta2"]),
        j("reads"), j("quals"), j("lens"), j("rdids"), j("starts"),
        j("valid"), P_fg, Pm, ss, j("mm_pen"), j("minsc"), j("src_clip_l"),
        j("src_clip_r"), j("clip_pen"))
    got = splice.inject_known_ref(**kw)
    for f in want:
        _eq(got[f], want[f], f)
    ok = np.asarray(want["score"]) > -2 ** 29
    assert ok.sum() >= 5
    # without the SNV inputs (a linear index's twin) some slot changes
    lin = splice.inject_known_ref(**dict(kw, snv1_w=None, snv2_w=None,
                                         snv_delta1=None, snv_delta2=None))
    assert not torch.equal(lin["score"], got["score"])


def test_second_sweep_raw_planes_match_jax(gss):
    """K15 takes no graph input: on the graph step's own arguments (both
    base pairs, stacked) it equals second_sweep on the raw planes, once
    per base pair."""
    kw = _capture(gss, False)["second_sweep"]
    assert tuple(kw["b_i"].shape) == (2, kw["starts"].shape[0])
    pl, M = _jax_planes(gss, kw, snv=False)
    prm = gss["ja"].splice_params
    tables = tuple(jnp.asarray(t) for t in j_splice.junction_prob_tables())
    j = lambda k: jnp.asarray(kw[k].numpy())  # noqa: E731
    ss = {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
          for k, v in kw["ss"].items()}
    sweep = jax.jit(lambda ch, pr, mr, st, va, ln, ms, bi, bj, bx, bsc, bok,
                    ss, rd: j_splice.second_sweep(
                        ch, pr, mr, st, va, ln, ms, tables, prm, bi, bj, bx,
                        bsc, bok, ss=ss, rdids=rd))
    got = splice.second_sweep_ref(**kw)
    for t in range(2):
        want = sweep(j("ch"), pl.pen_raw, pl.mm_raw, j("starts"), j("valid"),
                     j("lens"), j("minsc"),
                     *(j(k)[t] for k in ("b_i", "b_j", "b_x", "b_score",
                                         "b_valid")), ss, j("rdids"))
        for side in ("right", "left"):
            for f in want[side]:
                _eq(got[t][side][f], want[side][f], f"pair {t} {side} {f}")


@pytest.mark.parametrize("lite", (True, False))
def test_spliced_graph_steps_match_jax(gss, lite):
    ja, ta = (gss["ja"]._fast, gss["ta"]._fast) if lite else \
        (gss["ja"], gss["ta"])
    codes, quals, lens = gss["codes"], gss["quals"], gss["lens"]
    rdids = np.arange(len(lens), dtype=np.int64) + 3
    minsc = ta._minsc(lens)
    rd, qd, h2d = ja._pack_h2d(codes, quals, lens, minsc)
    jp = ja._dispatch_packed(rd, qd, rdids, True, h2d)[0]
    tp = ta._dispatch_packed(codes, quals, lens, minsc, True,
                             rdids=rdids)[0]
    w = np.asarray(jp).shape[1]
    assert ja._out_specs[w] == ta._out_specs[w]
    assert ja._spill_meta[w] == ta._spill_meta[w]
    _eq(tp[0].numpy(), jp, "packed buffer")


def _sam(res, writer_cls, read_fn, al, names, codes, quals, lens):
    sink = io.StringIO()
    w = writer_cls(sink, list(al.meta.ref_names), list(al.meta.ref_lens),
                   no_head=True, annotator=al.annotate_snps)
    w.write_batch_raw(names, codes, quals, lens, res.raw, al.ref_codes,
                      finalize=lambda i: read_fn(res.raw, i))
    return sink.getvalue()


def align_check(ja, ta, names, codes, quals, lens):
    """align_batch of both aligners: raw columns, sites, SAM with Zs."""
    args = (codes, quals, lens)
    ra, rb = ja.align_batch(*args), ta.align_batch(*args)
    for i, (a, b) in enumerate(zip(ra.raw["cols"], rb.raw["cols"])):
        _eq(b, a, f"raw column {i}")
    assert ja.splice_db.sites == ta.splice_db.sites
    sa = _sam(ra, JSamWriter, j_read_alignments, ja, names, *args)
    sb = _sam(rb, SamWriter, read_alignments, ta, names, *args)
    assert sb == sa
    cols = rb.raw["cols"]
    assert (np.asarray(cols[16]) == 1).sum() >= 60       # spliced rows
    assert "Zs:Z:" in sb and "N" in sb
    zs_spliced = [x for x in sb.splitlines()
                  if "Zs:Z:" in x and "N" in x.split("\t")[5]]
    assert zs_spliced, "no spliced alignment carries a Zs tag"


def test_spliced_graph_align_batch_matches_jax(gss):
    """Two tiers, the temp-site fixed point, the Zs annotator (which walks
    the CIGAR's N ops)."""
    align_check(gss["ja"], gss["ta"], gss["names"], gss["codes"],
                gss["quals"], gss["lens"])
