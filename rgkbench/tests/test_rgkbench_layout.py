"""Every file that BENCHMARK.json names loads by its name, a new metric
file is picked up without an edit, and the roofline's byte count."""

import json
import os

import pytest

from rgkbench import harness
from rgkbench.metrics import _intersect as ix

SPEC = harness.spec()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_workload_loads(cell):
    wl = harness.workload(cell)
    entry = {w["name"]: w for w in SPEC["workloads"]}[cell]
    assert wl["config"] == entry["config"]
    assert wl["traffic"] == entry["traffic"]
    drv = harness.load_module("drivers", wl["driver"])
    for fn in ("setup", "window", "trace", "judge", "readings"):
        assert callable(getattr(drv, fn))


@pytest.mark.parametrize("cfg", [c["name"] for c in SPEC["configs"]])
def test_config_loads(cfg):
    entry = {c["name"]: c for c in SPEC["configs"]}[cfg]
    data = harness.config(cfg)
    assert os.path.relpath(os.path.join(harness.BENCH, "configs",
                                        cfg + ".json"),
                           harness.ROOT) == entry["file"]
    assert sorted(data["reduced"]) == sorted(entry["reduced"])
    assert callable(harness.load_module("configs", cfg).write)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_loads_and_reads_nothing_from_nothing(metric):
    assert harness.load_module("metrics", metric).read({}) is None


def test_new_metric_file_is_picked_up(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "new.thing_ms.py").write_text(
        "def read(rec):\n    return rec.get('thing', None)\n")
    monkeypatch.setattr(harness, "BENCH", str(tmp_path))
    entries = [{"name": "new.thing_ms", "unit": "ms"},
               {"name": "new.thing_ms", "unit": "ms",
                "workloads": ["other"]}]
    got = harness.per_layer(entries[:1], "cell", {"thing": 2.5})
    assert got == {"new.thing_ms": {"value": 2.5, "unit": "ms"}}
    assert harness.per_layer(entries[1:], "cell", {"thing": 2.5}) == {}
    assert harness.per_layer(entries[:1], "cell", {}) == {}


def test_roofline_bytes_by_hand():
    # 2 closest queries over 1000 live rays in all, 3 any-hit queries
    # over 500, a scene of 10 triangles: 1000 * (32 + 16) + 500 * (32 +
    # 4) + 5 * 10 * 36.
    assert ix.least_bytes(2, 1000, 3, 500, 10) == 48000 + 18000 + 1800
    rec = {"queries": {"closest": 2, "any": 3, "any_rays": 500},
           "block_rays": 1000, "triangles": 10,
           "kernels": {"void flat_sweep<true>(float)": (5, 2.0),
                       "elementwise": (7, 9.0)}}
    share = harness.load_module("metrics", "intersect_roofline").read(rec)
    assert share == pytest.approx(100 * 67800 / 3.35e12 / 2e-3)
    shade = harness.load_module("metrics", "shade.ms_per_step").read(
        dict(rec, steps=3))
    assert shade == pytest.approx(3.0)


def test_benchmark_json_names():
    ok = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
             "0123456789_.-")
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert set(n) <= ok and len(n) <= 64
    assert len(json.dumps(SPEC)) < 64 * 1024
