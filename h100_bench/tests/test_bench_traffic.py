"""The generators: the same seed gives the same reads, another seed other
reads with the same sizes, and each read is what its origin says."""

import importlib

import numpy as np
import pytest

from conftest import tiny, tiny_workload


def generator(cell):
    from h100_bench import harness
    return importlib.import_module(
        f"h100_bench.traffic.{harness.load_workload(cell)['generator']}")


@pytest.fixture(scope="module")
def deps():
    from h100_bench import deploy
    return {n: deploy.make(tiny(n)) for n in ("tiny_dna", "tiny_rna")}


CELLS = [("celegans_dna.unpaired", "tiny_dna"),
         ("celegans_dna.paired", "tiny_dna"),
         ("grch38_snp_tran_280m.unpaired", "tiny_rna")]


@pytest.mark.parametrize("cell,config", CELLS)
def test_deterministic_per_seed(deps, cell, config):
    gen = generator(cell)
    p = tiny_workload(cell, pool=3000)["traffic"]
    seed = 2 ** 31 + 12345
    a = gen.generate(deps[config], p, seed)
    b = gen.generate(deps[config], p, seed)
    c = gen.generate(deps[config], p, seed + 1)
    for x, y, z in zip(a.mates, b.mates, c.mates):
        assert x.fastq == y.fastq
        assert np.array_equal(x.start, y.start)
        assert x.fastq != z.fastq and x.codes.shape == z.codes.shape


def test_deployment_is_fixed(deps):
    from h100_bench import deploy
    d2 = deploy.make(tiny("tiny_rna"))
    d1 = deps["tiny_rna"]
    assert np.array_equal(d1.genome, d2.genome)
    assert d1.introns == d2.introns and d1.known_ss == d2.known_ss
    assert np.array_equal(d1.catalog.pos, d2.catalog.pos)


@pytest.mark.parametrize("cell,config", CELLS)
def test_reads_match_their_origin(deps, cell, config):
    """Each read, walked along its origin against the genome, differs
    only by the substitutions and Ns the mix puts on it, and reads
    without sequencing errors score their catalog alleles as known on a
    graph index."""
    from h100_bench.reference.judge import checker, origin_score
    from h100_bench.traffic import reads
    dep = deps[config]
    cfg = tiny(config)
    ck = checker(dep, cfg)
    tr = generator(cell).generate(
        dep, tiny_workload(cell, pool=2000)["traffic"], 99)
    scores = []
    for m in tr.mates:
        for i in range(400):
            s = origin_score(ck, m, i, reads.origin_cigar)
            if s is not None:
                scores.append(s)
    # the mix keeps most reads within --score-min of their origin
    assert np.mean(np.array(scores) >= -20) > 0.8
    assert max(scores) == 0


@pytest.mark.parametrize("cell,config", [CELLS[2]])
def test_every_batch_has_the_same_mix(deps, cell, config):
    from h100_bench.traffic import reads
    p = tiny_workload(cell, pool=1024, batch=256)["traffic"]
    tr = reads.generate(deps[config], p, 3)
    for m in tr.mates:
        kinds = [np.bincount(m.ev[b:b + 256], minlength=5)
                 for b in range(0, 1024, 256)]
        assert all(np.array_equal(k, kinds[0]) for k in kinds), kinds
        rcs = [int(m.rc[b:b + 256].sum()) for b in range(0, 1024, 256)]
        assert len(set(rcs)) == 1


def test_fastq_records(deps):
    tr = generator("celegans_dna.unpaired").generate(
        deps["tiny_dna"], tiny_workload(
        "celegans_dna.unpaired", pool=50)["traffic"], 5)
    m = tr.mates[0]
    recs = m.fastq.split(b"\n")
    assert recs[0] == b"@r000000000" and recs[2] == b"+"
    assert len(recs[1]) == m.lens[0] == len(recs[3])
    assert int(m.ends[-1]) == len(m.fastq)


@pytest.mark.parametrize("cell,config", CELLS[:2])
def test_simulator_shares(deps, cell, config):
    """hisat2_simulate_reads.py's model: no errors by default, each
    catalog variant a read walks over kept with probability 1/2 (at a
    GRCh38 graph density about 2% of reads take an indel), half of the
    reads (pairs) on the reverse strand, Q40 throughout, no N."""
    p = tiny_workload(cell, pool=20000)["traffic"]
    assert p["error_rate"] == 0.0 and p["het"] == 0.5
    tr = generator(cell).generate(deps[config], p, 2 ** 31 + 5)
    for k, m in enumerate(tr.mates):
        indel = np.mean(m.ev != 0)
        assert 0.01 < indel < 0.04, indel
        assert abs(m.rc.mean() - 0.5) < 0.02
        assert (m.quals[m.codes < 4] == 40).all() and (m.codes < 4).all()
    if tr.paired:
        a, b = tr.mates
        assert (a.rc != b.rc).all()
        left = np.where(a.rc, b.start, a.start)
        right = np.where(a.rc, a.start, b.start)
        assert (right - left == p["fragment"] - p["read_len"]).all()


def test_simulator_errors(deps):
    """With --error-rate set, substitutions fall on bases copied from the
    genome, at most max_mismatch a read (a later cell's mix is data)."""
    from h100_bench.reference.judge import checker, origin_score
    from h100_bench.traffic import reads
    dep = deps["tiny_dna"]
    p = dict(tiny_workload("celegans_dna.unpaired", pool=3000)["traffic"],
             error_rate=2.0, het=0.0)
    tr = generator("celegans_dna.unpaired").generate(dep, p, 17)
    ck = checker(dep, tiny("tiny_dna"))
    m = tr.mates[0]
    sc = np.array([origin_score(ck, m, i, reads.origin_cigar)
                   for i in range(600)])
    assert (m.ev == 0).all()
    assert (sc % 6 == 0).all() and sc.min() >= -18 and (sc < 0).mean() > 0.5


@pytest.mark.parametrize("cell,config", CELLS[:2])
def test_fixed_pool_in_seed_order(deps, cell, config):
    """A workload with a pool_seed: every seed gets the same reads (pairs
    kept whole, each with its origin), in an order of its own."""
    from h100_bench import harness
    wl = tiny_workload(cell, pool=300)
    wl["pool_seed"] = 11
    gen = generator(cell)
    a = harness.make_traffic(gen, deps[config], wl, 2 ** 31 + 3)
    b = harness.make_traffic(gen, deps[config], wl, 2 ** 31 + 3)
    c = harness.make_traffic(gen, deps[config], wl, 2 ** 31 + 4)
    assert a.mates[0].fastq == b.mates[0].fastq
    assert a.mates[0].fastq != c.mates[0].fastq

    def rows(tr):
        return sorted(tuple((m.codes[i].tobytes(), int(m.start[i]),
                             bool(m.rc[i])) for m in tr.mates)
                      for i in range(tr.n))
    assert rows(a) == rows(c)
    from h100_bench.traffic import reads
    for tr in (a, c):
        for m in tr.mates:
            for i in range(0, tr.n, 37):
                assert reads.origin_cigar(m, i)
