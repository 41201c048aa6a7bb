"""A configuration, a traffic mix and a per-layer metric that are new
files, with a workloads entry naming them, are taken up without an edit
to any file of the harness."""

import json
import shutil
import time
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parent.parent


def make_root(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    (root / "perfbench" / "configs").mkdir(parents=True)
    (root / "perfbench" / "traffic").mkdir()
    (root / "perfbench" / "metrics").mkdir()
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "cd_default.json").read_text())
    cfg["name"] = "cd_v0"
    cfg["encoder"]["variable_divisions"] = 0
    (root / "perfbench" / "configs" / "cd_v0.json").write_text(
        json.dumps(cfg))
    (root / "perfbench" / "traffic" / "clips.json").write_text(json.dumps(
        {"entry": "encode_whole", "repeat": 1,
         "batches": [[["jazz", 0.3]], [["rhythm", 0.25]]]}))
    (root / "perfbench" / "metrics" / "encode.request_count.py").write_text(
        "def read(trace):\n"
        "    return float(sum(1 for s in trace.spans if s[0] == 'request'))\n")
    spec["configs"].append({"name": "cd_v0", "source": "https://x.invalid",
                            "file": "perfbench/configs/cd_v0.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "cd_v0.clips", "config": "cd_v0",
                              "traffic": "clips", "chips": 1, "why": "t"})
    for m in spec["end_to_end"]:
        if m["name"] == "encode_xrt":
            m["workloads"].append("cd_v0.clips")
    spec["per_layer"].append({"name": "encode.request_count", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "client", "moves": "encode_xrt",
                              "workloads": ["cd_v0.clips"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    spec = harness.load_spec(root)
    assert harness.config_of(spec, "cd_v0", root)["encoder"][
        "variable_divisions"] == 0
    here = root / "perfbench"
    assert harness.traffic_of("clips", here)["entry"] == "encode_whole"
    e2e, layer = harness.metrics_of(spec, "cd_v0.clips")
    assert {m["name"] for m in e2e} == {"encode_xrt", "setup_s"}
    assert [m["name"] for m in layer] == ["encode.request_count"]
    assert harness.reader_of("encode.request_count", here).read(
        type("T", (), {"spans": [("request", 0, 1)]})) == 1.0
    # the shipped cells keep their own metrics
    _, layer = harness.metrics_of(spec, "cd_default.tracks_decode")
    assert "encode.request_count" not in {m["name"] for m in layer}


def test_a_new_cell_runs_from_its_files(tmp_path):
    root = make_root(tmp_path)
    cell = harness.Cell("cd_v0.clips", 2**31 + 5, 0.05, True,
                        device="cpu", root=root)
    result = cell.run(time.perf_counter())
    assert result["correct"] is True
    assert result["metrics"]["encode.request_count"]["value"] >= 1
    assert list(result)[-1] == "checks"
    shutil.rmtree(root)


def test_a_mix_asking_for_what_the_harness_lacks_is_refused(tmp_path):
    """A traffic key the harness does not implement (more clients, an open
    loop) is refused, never silently run as one closed-loop client."""
    here = tmp_path / "perfbench"
    (here / "traffic").mkdir(parents=True)
    mix = {"entry": "decode", "repeat": 1, "batches": [[["jazz", 1.0]]]}
    (here / "traffic" / "ok.json").write_text(json.dumps(mix))
    assert harness.traffic_of("ok", here)["entry"] == "decode"
    (here / "traffic" / "four.json").write_text(json.dumps(
        {**mix, "clients": 4}))
    with pytest.raises(ValueError, match="clients"):
        harness.traffic_of("four", here)
    (here / "traffic" / "live.json").write_text(json.dumps(
        {**mix, "content": "live"}))
    with pytest.raises(ValueError, match="content"):
        harness.traffic_of("live", here)


def test_shipped_mixes_load_and_cycle():
    for name in ("tracks_encode", "tracks_decode", "corpus_encode",
                 "corpus_decode"):
        t = harness.traffic_of(name)
        order = harness.request_order(t, 2**31 + 17)
        first = [next(order) for _ in range(harness.cycle_of(t))]
        # a whole cycle holds every batch ``repeat`` times
        assert sorted(first) == sorted(
            list(range(len(t["batches"]))) * t["repeat"])
