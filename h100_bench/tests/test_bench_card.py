"""On a machine with a card: one short run of each cell's shape on the
tiny deployments, the hand kernels doing the work, comes out correct and
reads its traced metrics."""

import pytest

from conftest import tiny, tiny_manifest, tiny_workload

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("cell,config", [
    ("celegans_dna.unpaired", "tiny_dna"),
    ("celegans_dna.paired", "tiny_dna"),
    ("grch38_snp_tran_280m.unpaired", "tiny_rna")])
def test_cell_on_card(card, cell, config, tmp_path):
    from h100_bench import harness
    for trace in (False, True):
        rc, res = harness.run(cell, 2 ** 31 + 3, 3, trace, device="cuda",
                              manifest=tiny_manifest(cell, config),
                              workload=tiny_workload(cell, batch=4096,
                                                     pool=100000),
                              config=tiny(config),
                              cache=str(tmp_path / "cache"))
        assert rc == 0 and res["correct"], res["checks"]
        if trace:
            assert res["device"]["busy_s"] > 0
            assert 0 < res["metrics"]["device_idle_share"]["value"] <= 100
