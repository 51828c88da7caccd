"""Runs of the harness on the CPU at a tiny size, the port's plain twins
standing in for its kernels: a sound run comes out correct; with the
timed path broken underneath (an answer altered where it is produced,
half of a batch left out, a step that returns nothing) it does not; and
the control reads above the limit a sound run stays under."""

import numpy as np
import pytest

from conftest import tiny, tiny_manifest, tiny_workload

SECONDS = 3


def run(cell, config, tmp_path, faults=None, trace=False, seed=2 ** 31 + 7):
    from h100_bench import harness
    return harness.run(cell, seed, SECONDS, trace, device="cpu",
                       faults=faults,
                       manifest=tiny_manifest(cell, config),
                       workload=tiny_workload(cell), config=tiny(config),
                       cache=str(tmp_path / "cache"))


def _shift(monkeypatch):
    """Every alignment placed one base right of where it was found."""
    from hisat2_tpu_torch.align import pipeline
    orig = pipeline.TorchAligner.collect

    def collect(self, *a, **k):
        res = orig(self, *a, **k)
        if res.raw is not None and len(res.raw["cols"][0]):
            res.raw["cols"][3] = res.raw["cols"][3] + 1
            res.raw["cols"][4] = res.raw["cols"][4] + 1
        return res
    return lambda: monkeypatch.setattr(pipeline.TorchAligner, "collect",
                                       collect)


def _half(monkeypatch):
    """Half of each batch's reads never rendered."""
    from hisat2_tpu_torch.io import sam
    orig_b = sam.SamWriter.write_batch_raw
    orig_p = sam.SamWriter.write_pair
    n = [0]

    def write_batch_raw(self, names, codes, quals, lens, raw, *a, **k):
        h = len(names) // 2
        if raw is not None:
            keep = np.asarray(raw["cols"][0]) < h
            raw = {"cols": [np.asarray(c)[keep] for c in raw["cols"]]}
        if k.get("n_filtered") is not None:
            k["n_filtered"] = k["n_filtered"][:h]
        return orig_b(self, names[:h], codes[:h], quals[:h], lens[:h],
                      raw, *a, **k)

    def write_pair(self, *a, **k):
        n[0] += 1
        if n[0] % 2:
            return orig_p(self, *a, **k)

    def apply():
        monkeypatch.setattr(sam.SamWriter, "write_batch_raw",
                            write_batch_raw)
        monkeypatch.setattr(sam.SamWriter, "write_pair", write_pair)
    return apply


def _nothing(monkeypatch):
    """The aligner returns its batch unchanged: no alignment from the
    device step, the host replay or mate rescue."""
    from hisat2_tpu_torch.align import hybrid, pipeline
    orig = pipeline.TorchAligner.collect

    def collect(self, *a, **k):
        res = orig(self, *a, **k)
        if res.raw is not None:
            res.raw = {"cols": [np.asarray(c)[:0] for c in res.raw["cols"]]}
            res._alignments = None
        return res

    def rescue(self, codes, *a, **k):
        return [[] for _ in range(len(codes))]

    def apply():
        monkeypatch.setattr(pipeline.TorchAligner, "collect", collect)
        monkeypatch.setattr(pipeline.TorchAligner, "rescue_mates", rescue)
        monkeypatch.setattr(hybrid, "substitute_batch",
                            lambda *a, **k: {})
    return apply


CELLS = [("celegans_dna.unpaired", "tiny_dna"),
         ("celegans_dna.paired", "tiny_dna"),
         ("grch38_snp_tran_280m.unpaired", "tiny_rna")]


@pytest.mark.parametrize("cell,config", CELLS)
def test_sound_run_is_correct(cell, config, tmp_path):
    rc, res = run(cell, config, tmp_path)
    assert rc == 0
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"]["reads_per_s"]["value"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [_shift, _half, _nothing])
@pytest.mark.parametrize("cell,config", CELLS)
def test_broken_path_is_not_correct(cell, config, fault, monkeypatch,
                                    tmp_path):
    rc, res = run(cell, config, tmp_path, faults=fault(monkeypatch))
    assert rc == 0
    assert not res["correct"], res["checks"]


def test_traced_run_reads_its_spans(tmp_path):
    rc, res = run("celegans_dna.unpaired", "tiny_dna", tmp_path,
                  trace=True)
    assert rc == 0 and res["correct"]
    m = res["metrics"]
    for k in ("render_ms", "collect_ms", "host_phase_ms",
              "replay_ms", "dispatch_ms"):
        assert m[k]["value"] > 0, k
    assert "reads_per_s" not in m
    # the device's metrics are read only on a card
    assert "device_idle_share" not in m and "busy_s" not in res["device"]


@pytest.mark.parametrize("cell,config", CELLS)
def test_control_fails_the_limit(cell, config):
    from h100_bench import deploy
    from h100_bench.reference.control import control_reading
    from h100_bench.reference.judge import sample
    from h100_bench.traffic import reads
    from test_bench_traffic import generator
    wl = tiny_workload(cell, pool=4000)
    dep = deploy.make(tiny(config))
    for seed in (1, 2, 3):
        tr = generator(cell).generate(dep, wl["traffic"], seed)
        v = control_reading(dep, tr, tiny(config),
                            sample(tr, tr.n, 1500, seed), reads.origin_cigar)
        assert v > wl["limits"]["below_origin_pct"], (seed, v)
