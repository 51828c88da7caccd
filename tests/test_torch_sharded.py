"""Port parity for genome-scale DNA alignment: sampled-SA indexes and
two-shard ShardedFMIndex, the torch aligner against hisat2_tpu on the CPU.

- the whole DNA step on an off_rate 4 index (the resolve walk, K19+K20,
  feeding kernel 5 through its offs argument): the packed buffer, its
  layout and every unpacked key, spill and full_out layouts, uniform and
  variable lengths, with and without lane metadata; the batch has reads
  in a 3-copy repeat (hits wider than one row, dead slots);
- the alignments of an off_rate 4 index equal those of the full-SA index
  (tests/test_pipeline.py:122 test_sampled_sa_matches_full_sa, on the
  port);
- align_batch on a two-shard sampled index with a cross-shard duplicate
  (tests/test_index_build.py:110's genome), per-shard packed buffers
  included;
- the graph two-tier path on a two-shard sampled graph index with SNVs,
  deletions and insertions on both shards (tests/test_parallel.py:89's
  genome and catalog): align_batch through both tiers and the per-shard
  lite and full steps;
- _merge_shards on fetched per-shard outputs with shard bases [0,
  2^31 + 4096]: int64 global positions, u_event rows mapped per shard;
- a paired run on two shards: collect(paired=True) on a fused pair
  batch, and rescue_mates with windows on both shards (those on shard 1
  read past shard 0's words, as JAX's do); on the graph index JAX's
  rescue raises and the port's refuses.

Tolerance: exact (integer results).
"""

import dataclasses

import numpy as np
import pytest
import torch

from hisat2_tpu.align.pipeline import TPUAligner
from hisat2_tpu.index.builder import build_fm_index
from hisat2_tpu.index.format import ShardedFMIndex
from hisat2_tpu.index.variants import attach_variants
from hisat2_tpu_torch.align.pipeline import TorchAligner

ACGT = "ACGT"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process: the suite runs in parallel
    workers, and torch's default of a thread per core oversubscribes the
    CPU (each small op then waits on descheduled threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _reads(g, B, L, seed, var_lens=False, spots=()):
    """B reads of g: exact, with 1-2 mismatches, a 3 bp deletion, a 2 bp
    insertion, an N, reverse complements, reads from `spots`, and (with
    var_lens) every fourth read shorter."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(g) - L - 4, B)
    for i, s in enumerate(spots):
        starts[3 * i + 1] = s
    codes = np.stack([g[s:s + L] for s in starts]).astype(np.uint8)
    for i in range(0, B, 3):
        for q in rng.choice(L, int(rng.integers(1, 3)), replace=False):
            codes[i, q] = (codes[i, q] + 1) % 4
    s = int(starts[4])
    codes[4] = np.concatenate([g[s:s + 30], g[s + 33:s + L + 3]])
    s = int(starts[5])
    codes[5] = np.concatenate([g[s:s + 40], [1, 2], g[s + 40:s + L - 2]])
    codes[2, L // 2] = 4
    codes[1::5] = np.where(codes[1::5] < 4, 3 - codes[1::5], 4)[:, ::-1]
    quals = rng.integers(2, 41, (B, L)).astype(np.uint8)
    lens = np.full(B, L, np.int32)
    if var_lens:
        lens[::4] = L - rng.integers(1, 20, len(lens[::4]))
        for i in range(0, B, 4):
            codes[i, lens[i]:] = 4
    return codes, quals, lens


def _minsc(al, lens):
    return np.array([al.scoring.min_score(int(x)) for x in lens], np.int64)


def _steps_match(ja, ta, codes, quals, lens, full_out=False):
    """Every shard's packed buffer, layout and unpacked keys."""
    B = len(lens)
    minsc = _minsc(ja, lens)
    uniform = bool(np.all(lens == codes.shape[1]))
    rd, qd, h2d = ja._pack_h2d(codes, quals, lens, minsc)
    jps = ja._dispatch_packed(rd, qd, np.arange(B), uniform, h2d,
                              full_out=full_out)
    tps = ta._dispatch_packed(codes, quals, lens, minsc, uniform,
                              full_out=full_out)
    assert len(jps) == len(tps) == len(ja.shards)
    for jp, tp in zip(jps, tps):
        w = np.asarray(jp).shape[1]
        assert ja._out_specs[w] == ta._out_specs[w]
        assert ja._spill_meta[w] == ta._spill_meta[w]
        _eq(tp[0].numpy(), jp, "packed buffer")
    jo, to = ja._merge_shards(jps), ta._merge_shards(tps)
    assert sorted(jo) == sorted(to)
    for k in jo:
        _eq(to[k], jo[k], k)
    return jo


def _results_match(ra, rb):
    for a, b in zip(ra.raw["cols"], rb.raw["cols"]):
        _eq(b, a, "raw column")
    for k in ra.lanes or {}:
        if hasattr(ra.lanes[k], "shape"):
            _eq(rb.lanes[k], ra.lanes[k], k)


# -- one sampled index ------------------------------------------------------
@pytest.fixture(scope="module")
def sampled():
    g = np.random.default_rng(1234).integers(0, 4, 20000).astype(np.uint8)
    unit = g[1000:1300].copy()
    g[5000:5300] = unit
    g[9000:9300] = unit
    idx0 = build_fm_index([("chr_t", g)])
    idx4 = build_fm_index([("chr_t", g)], off_rate=4)
    assert idx0.meta.off_rate == 0 and idx4.meta.off_rate == 4
    al = {lm: (TPUAligner(idx4, lane_meta=lm),
               TorchAligner(idx4, lane_meta=lm, device="cpu"))
          for lm in (False, True)}
    return dict(g=g, idx0=idx0, idx4=idx4, al=al)


@pytest.mark.parametrize("var_lens,full_out,lane_meta", [
    (False, False, False), (False, True, True),
    (True, False, True), (True, True, False)])
def test_sampled_step_matches_jax(sampled, var_lens, full_out, lane_meta):
    ja, ta = sampled["al"][lane_meta]
    assert ta.dev.blocked.shape[1] == 49
    codes, quals, lens = _reads(sampled["g"], 48, 80, 7 + var_lens,
                                var_lens, spots=(1010, 5100, 9200))
    jo = _steps_match(ja, ta, codes, quals, lens, full_out)
    assert (jo["u_dd"] != 0).any()             # indel sweep rows


def test_sampled_align_batch_matches_jax(sampled):
    ja, ta = sampled["al"][True]
    codes, quals, lens = _reads(sampled["g"], 48, 80, 11, True,
                                spots=(1020, 5020))
    ra, rb = ja.align_batch(codes, quals, lens), ta.align_batch(codes, quals,
                                                                lens)
    assert rb.n_aligned == ra.n_aligned > 40
    _results_match(ra, rb)


def test_sampled_sa_matches_full_sa(sampled):
    """tests/test_pipeline.py:122: the off_rate 4 index routes candidate
    resolution through the walk; the alignment set must be identical to
    the full-SA index's."""
    g = sampled["g"]
    n, L = 48, 72
    rng = np.random.default_rng(3)
    starts = rng.integers(0, len(g) - L, n)
    codes = np.stack([g[s:s + L] for s in starts]).astype(np.uint8)
    for i in range(n):
        q = int(rng.integers(0, L))
        codes[i, q] = (codes[i, q] + 1) % 4
    codes[::2] = np.where(codes[::2] < 4, 3 - codes[::2], 4)[:, ::-1]
    lens = np.full(n, L, np.int32)
    quals = np.full((n, L), 40, np.uint8)
    r0 = TorchAligner(sampled["idx0"], device="cpu").align_batch(
        codes, quals, lens)
    r4 = TorchAligner(sampled["idx4"], device="cpu").align_batch(
        codes, quals, lens)
    for i in range(n):
        a0 = sorted((a.joined_pos, a.score, a.rc) for a in r0.alignments[i])
        a4 = sorted((a.joined_pos, a.score, a.rc) for a in r4.alignments[i])
        assert a0 == a4, f"read {i}: {a0} != {a4}"
        assert a0


# -- two shards, linear -----------------------------------------------------
@pytest.fixture(scope="module")
def two_shards():
    """tests/test_index_build.py:110: two 60 kbp chromosomes, 2 kbp of
    chromosome A copied into B; each its own shard, sampled at off_rate
    4."""
    rng = np.random.default_rng(12)
    ga = rng.integers(0, 4, 60000).astype(np.uint8)
    gb = rng.integers(0, 4, 60000).astype(np.uint8)
    gb[20000:22000] = ga[10000:12000]
    sh = build_fm_index([("cA", ga), ("cB", gb)], shard_bp=70000,
                        off_rate=4)
    assert isinstance(sh, ShardedFMIndex) and len(sh.shards) == 2
    ja = TPUAligner(sh, lane_meta=True)
    ta = TorchAligner(sh, lane_meta=True, device="cpu")
    assert not ta.lane_meta and not ja.lane_meta
    return dict(g=np.concatenate([ga, gb]), sh=sh, ja=ja, ta=ta)


def test_two_shard_step_matches_jax(two_shards):
    ja, ta = two_shards["ja"], two_shards["ta"]
    assert ta.shard_bases == ja.shard_bases == [0, 60000]
    assert [d.meta.n for d in ta.devs] == [60000, 60000]
    codes, quals, lens = _reads(two_shards["g"], 48, 80, 21, True,
                                spots=(10500, 80500, 81000))
    jo = _steps_match(ja, ta, codes, quals, lens)
    assert jo["u_d1"].dtype == np.int64 and (jo["u_d1"] >= 60000).any()


def test_two_shard_align_batch_matches_jax(two_shards):
    ja, ta = two_shards["ja"], two_shards["ta"]
    codes, quals, lens = _reads(two_shards["g"], 64, 80, 23, True,
                                spots=(10500, 80500, 70000, 5000))
    ra, rb = ja.align_batch(codes, quals, lens), ta.align_batch(codes, quals,
                                                                lens)
    _results_match(ra, rb)
    ref = np.asarray(rb.raw["cols"][2])
    assert (ref == 0).any() and (ref == 1).any()       # both chromosomes
    dup = rb.alignments[1]                             # cross-shard copy
    assert {a.ref_id for a in dup} == {0, 1}


def test_two_shard_paired_refused(two_shards):
    """Paired reads on two shards run as in JAX: a fused pair batch's
    collect(paired=True), and mate rescue with global window starts read
    from shard 0's words up to the global n (JAX pipeline.py:1472-1480),
    anchors on both shards and at their border."""
    ja, ta, g = two_shards["ja"], two_shards["ta"], two_shards["g"]
    codes, quals, lens = _reads(g, 16, 80, 5, spots=(10500, 80500))
    _results_match(ja.collect(ja.dispatch(codes, quals, lens), paired=True),
                   ta.collect(ta.dispatch(codes, quals, lens), paired=True))
    rng = np.random.default_rng(6)
    R, L = 10, 80
    at = np.array([3000, 20000, 59000, 59990, 60010, 61000, 80500, 100000,
                   119000, 10500])
    anchors = at + rng.integers(-300, 300, R)
    rcf = np.arange(R) % 3 == 1
    cs = np.zeros((R, L), np.uint8)
    for i, a in enumerate(at):
        s = int(min(max(a + 150, 0), len(g) - L))
        m = g[s:s + L].copy()
        cs[i] = np.where(m < 4, 3 - m, 4)[::-1] if rcf[i] else m
    qs = rng.integers(10, 41, (R, L)).astype(np.uint8)
    ls = np.full(R, L, np.int32)
    jr = ja.rescue_mates(cs, qs, ls, anchors, rcf, 500)
    tr = ta.rescue_mates(cs, qs, ls, anchors, rcf, 500)
    assert [[dataclasses.asdict(a) for a in x] for x in tr] == \
        [[dataclasses.asdict(a) for a in x] for x in jr]
    assert sum(bool(x) for x in tr[:3]) == 3        # shard 0's windows


# -- two shards, graph --------------------------------------------------------
@pytest.fixture(scope="module")
def graph_shards(tmp_path_factory):
    """tests/test_parallel.py:89: two 30 kbp chromosomes, each with two
    SNVs, a 3 bp deletion and a 3 bp insertion; one shard each."""
    rng = np.random.default_rng(21)
    s1 = rng.integers(0, 4, 30000).astype(np.uint8)
    s2 = rng.integers(0, 4, 30000).astype(np.uint8)
    snp = tmp_path_factory.mktemp("gsh") / "v.snp"
    lines = []
    for i, chrom in enumerate(("cA", "cB")):
        s = (s1, s2)[i]
        for j, p in enumerate((1000, 7000)):
            lines.append(f"rs{i}{j}\tsingle\t{chrom}\t{p}\t"
                         + ACGT[(s[p] + 1) % 4])
        lines.append(f"rd{i}\tdeletion\t{chrom}\t12000\t3")
        lines.append(f"ri{i}\tinsertion\t{chrom}\t15000\tTTA")
    snp.write_text("\n".join(lines) + "\n")
    sh = build_fm_index([("cA", s1), ("cB", s2)], shard_bp=31000,
                        off_rate=4)
    assert len(sh.shards) == 2
    attach_variants(sh, snp_file=str(snp))
    db = sh._variants
    # reads over the variants, with their alleles, on both chromosomes
    B, L = 40, 80
    codes = np.zeros((B, L), np.uint8)
    for i in range(B):
        s = (s1, s2)[i % 2]
        k = (i // 2) % 5
        if k == 0:              # an SNV allele
            p = (1000, 7000)[i % 4 // 2]
            r = s[p - 40:p - 40 + L].copy()
            r[40] = (s[p] + 1) % 4
        elif k == 1:            # the deletion
            r = np.concatenate([s[11960:12000], s[12003:12003 + L]])
        elif k == 2:            # the insertion
            r = np.concatenate([s[14960:15000], [3, 3, 0],
                                s[15000:15000 + L]])
        else:
            p = int(rng.integers(100, 29000))
            r = s[p:p + L].copy()
            if k == 3:
                r[int(rng.integers(5, L - 5))] = (r[10] + 1) % 4
        codes[i] = r[:L]
    codes[1::7] = np.where(codes[1::7] < 4, 3 - codes[1::7], 4)[:, ::-1]
    quals = np.full((B, L), 40, np.uint8)
    lens = np.full(B, L, np.int32)
    ja = TPUAligner(sh, variants=db)
    ta = TorchAligner(sh, variants=db, device="cpu")
    return dict(sh=sh, ja=ja, ta=ta, codes=codes, quals=quals, lens=lens)


@pytest.mark.parametrize("lite", (True, False))
def test_graph_two_shard_step_matches_jax(graph_shards, lite):
    ja, ta = graph_shards["ja"], graph_shards["ta"]
    if lite:
        ja, ta = ja._fast, ta._fast
    assert ta.graph.snv_delta1.shape == (1,)      # host-only global view
    jo = _steps_match(ja, ta, graph_shards["codes"], graph_shards["quals"],
                      graph_shards["lens"])
    if not lite:
        assert (jo["u_event"] >= 0).any()         # known-indel slots


def test_graph_two_shard_align_batch_matches_jax(graph_shards):
    ja, ta = graph_shards["ja"], graph_shards["ta"]
    args = (graph_shards["codes"], graph_shards["quals"],
            graph_shards["lens"])
    ra, rb = ja.align_batch(*args), ta.align_batch(*args)
    _results_match(ra, rb)
    cols = rb.raw["cols"]
    jsnp = np.asarray(cols[22])
    refs = np.asarray(cols[2])
    for ref in (0, 1):                 # known-indel alignments per shard
        assert ((jsnp >= 0) & (refs == ref)).any()


def test_graph_two_shard_rescue_refused(graph_shards):
    """Mate rescue on a sharded graph index: JAX's raises KeyError, its
    SNV planes living per shard (pipeline.py:394-416); the port's refuses
    with that fault, and never scores on shard 0's planes."""
    ja, ta = graph_shards["ja"], graph_shards["ta"]
    job = (graph_shards["codes"][:2], graph_shards["quals"][:2],
           graph_shards["lens"][:2], np.array([500, 40000]),
           np.array([False, True]), 500)
    with pytest.raises(KeyError, match="snv1"):
        ja.rescue_mates(*job)
    with pytest.raises(NotImplementedError, match="KeyError: 'snv1'"):
        ta.rescue_mates(*job)


@pytest.mark.parametrize("lite", (True, False))
def test_merge_shards_int64_matches_jax(graph_shards, lite):
    """The merge on the two shards' fetched outputs, rebased as if the
    second shard began at 2^31 + 4096 (past int32)."""
    ja, ta = graph_shards["ja"], graph_shards["ta"]
    if lite:
        ja, ta = ja._fast, ta._fast
    codes, quals, lens = (graph_shards["codes"], graph_shards["quals"],
                          graph_shards["lens"])
    minsc = _minsc(ja, lens)
    outs = [ta._fetch_out(p) for p in ta._dispatch_packed(
        codes, quals, lens, minsc, True)]
    bases = [0, 2 ** 31 + 4096]

    def merged(al):
        saved = al.shard_bases
        al.shard_bases = bases
        al._fetch_out = lambda o: {k: v.copy() for k, v in o.items()}
        try:
            return al._merge_shards(outs)
        finally:
            al.shard_bases = saved
            del al._fetch_out

    jm, tm = merged(ja), merged(ta)
    assert sorted(jm) == sorted(tm)
    for k in jm:
        assert jm[k].dtype == tm[k].dtype, k
        _eq(tm[k], jm[k], k)
    assert tm["u_d1"].dtype == np.int64 and tm["u_d1"].max() >= 2 ** 31
