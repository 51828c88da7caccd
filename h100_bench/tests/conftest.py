"""Tests of the benchmark harness.  Run from the repository's root:

    python -m pytest h100_bench/tests -q            # CPU: the card tests skip
    python -m pytest h100_bench/tests -q -m gpu     # on a machine with a card
"""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny(name):
    with open(os.path.join(HERE, "data", name + ".json")) as f:
        return json.load(f)


def tiny_workload(cell, pool=12000, batch=256):
    """A cell's workload at a size a CPU run holds: small batches, a
    small pool, the same mix and limits."""
    from h100_bench import harness
    wl = harness.load_workload(cell)
    wl["traffic"]["pool"] = pool
    wl["traffic"]["block"] = batch
    wl["warmup"] = batch
    wl["batch_size"] = batch
    wl["align_args"] = list(wl.get("align_args", [])) + [
        "--batch-size", str(batch)]
    wl["sample"] = 300
    return wl


def tiny_manifest(cell, config):
    """The manifest with the one tiny cell, which every per-layer metric
    lists (a cell not registered yet reads them too; a reader that finds
    nothing leaves its metric out)."""
    from h100_bench import harness
    man = harness.load_manifest()
    return dict(man, workloads=[{"name": cell, "config": config,
                                 "traffic": "t", "chips": 1}],
                per_layer=[dict(m, workloads=[cell])
                           for m in man["per_layer"]])
