"""BENCHMARK.json against the contract's shape, and the files it names."""

import json
import os
import re

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATHCH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def man():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    m = man()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    assert all(PATHCH.match(p) for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(x["name"] for x in m["configs"])) == len(m["configs"])
    assert len(set(x["name"] for x in m["workloads"])) == len(m["workloads"])
    metrics = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert len(json.dumps(m)) < 64 * 1024


def test_cells_configs_and_metrics_resolve():
    m = man()
    configs = {c["name"]: c for c in m["configs"]}
    cells = {w["name"] for w in m["workloads"]}
    pairs = set()
    for w in m["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.exists(os.path.join(
            REPO, "h100_bench", "workloads", w["name"] + ".json"))
    used = {w["config"] for w in m["workloads"]}
    assert used == set(configs)
    for c in configs.values():
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    assert all(x["source"] in ("host_clock", "device_trace")
               for x in m["end_to_end"])
    assert all(0 < x["bound"] <= 0.25 for x in m["end_to_end"])
    layers = {}
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        assert set(x["workloads"]) <= cells, x
        assert os.path.exists(os.path.join(
            REPO, "h100_bench", "metrics", x["name"] + ".py"))
        layers.setdefault(x["layer"], set()).add(x["name"])
    for w in cells:                 # every cell reports a per-layer metric
        assert any(w in x["workloads"] for x in m["per_layer"])


def test_metric_files_declare_what_the_manifest_says():
    from h100_bench import harness
    for x in man()["per_layer"]:
        mod = harness.metric_module(x["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            x["layer"], x["unit"], x["source"], x["moves"]), x["name"]
        assert callable(mod.read)


def test_cell_metrics_follow_the_lists():
    from h100_bench import harness
    m = man()
    got = harness.cell_metrics(m, "celegans_dna.paired")
    assert "pairing_self_ms" in got and "replay_ms" not in got
    got = harness.cell_metrics(m, "celegans_dna.unpaired")
    assert "replay_ms" in got and "rescue_ms" not in got


def test_run_seconds_fit_the_full_check():
    m = man()
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
