"""Port parity for spliced RNA on a sharded SNP + splice-site graph index
(config 6's shape: two shards sampled at off_rate 4, k = 10): align_batch
of the spliced torch aligner against hisat2_tpu on the CPU, on the gss
corpus (tests/data/make_gss.py), one chromosome per shard.  Each shard's
step takes its own SNV planes and windows and its window of the site
tables.  The comparison is test_torch_spliced_graph.py's align_check:
every raw column, the site DB, and the SAM records with their Zs tags.

Tolerance: exact.
"""

import pytest
import torch

from test_torch_spliced_graph import _index, align_check, aligners, reads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_spliced_graph_two_shards_match_jax():
    idx = _index(shard_bp=61000, off_rate=4)
    assert len(idx.shards) == 2
    assert all(sh.meta.off_rate == 4 for sh in idx.shards)
    ja, ta = aligners(idx)
    assert ta.graph is not None and len(ta.shard_graph_dev) == 2
    align_check(ja, ta, *reads())
