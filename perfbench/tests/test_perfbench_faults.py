"""The check that decides ``correct``: a run with the timed path broken
underneath comes out not correct, for each fault a cell can have, and so
does the control; the same run unbroken comes out correct. The look for a
card is skipped: the port runs its kernels' plain versions on the CPU, at
a size a test run holds."""

import time

import pytest

from perfbench import entries, faults, harness

SEED = 2**31 + 4242
CELLS = {
    "cd_default.tracks_encode": [[["jazz", 0.3]], [["rhythm", 0.25]]],
    "cd_default.tracks_decode": [[["vocal", 0.12]], [["popular", 0.1]]],
    "hires_b8192.corpus_encode": [[["jazz", 0.1], ["classic", 0.12],
                                   ["rhythm", 0.09], ["vocal", 0.11]]],
    "hires_b8192.corpus_decode": [[["jazz", 0.1], ["classic", 0.09],
                                   ["rhythm", 0.08], ["vocal", 0.1]]],
}


# A clip on which the -V search picks other blocks than -B's (CPU reading:
# the fixed blocks' stream is 2.4 % longer).
VSEARCH_BATCHES = [[["popular", 0.3]]]


def run(workload, monkeypatch=None, fault=None, control=False):
    shipped = harness.traffic_of(
        harness.cell_of(harness.load_spec(), workload)["traffic"])
    entry_name = shipped["entry"]
    traffic = {"entry": entry_name, "repeat": 2,
               "content": shipped.get("content", "seeded"),
               "batches": (VSEARCH_BATCHES if fault == "vsearch_skipped"
                           else CELLS[workload])}
    if fault is not None:
        monkeypatch.setitem(entries.ENTRIES, entry_name, faults.broken(
            entries.ENTRIES[entry_name], fault))
    cell = harness.Cell(workload, SEED, 0.01, False, device="cpu",
                        traffic=traffic, control=control)
    return cell.run(time.perf_counter())


@pytest.mark.parametrize("workload", list(CELLS))
def test_sound_run_is_correct(workload):
    r = run(workload)
    assert r["correct"] is True and r["failed"] == 0
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("workload", list(CELLS))
def test_control_is_not_correct(workload):
    r = run(workload, control=True)
    assert r["correct"] is False
    assert r["checks"]["mismatched_samples"]["value"] > 0


@pytest.mark.parametrize("fault,workload", [
    ("answer_altered", w) for w in CELLS] + [
    ("half_batch_left_out", w) for w in CELLS if "corpus" in w])
def test_fault_is_not_correct(monkeypatch, fault, workload):
    r = run(workload, monkeypatch, fault)
    assert r["correct"] is False
    assert r["failed"] > 0


@pytest.mark.parametrize("fault,workload", [
    ("every_block_raw", "cd_default.tracks_encode"),
    ("every_block_raw", "hires_b8192.corpus_encode"),
    ("vsearch_skipped", "cd_default.tracks_encode")])
def test_left_out_work_is_not_correct(monkeypatch, fault, workload):
    """An encoder that leaves out part of the work writes valid, lossless
    streams: the size reference is what catches it."""
    r = run(workload, monkeypatch, fault)
    assert r["correct"] is False and r["failed"] > 0
    gap = r["checks"]["stream_size_gap_pct"]
    assert gap["value"] > gap["limit"]
    assert r["checks"]["mismatched_samples"]["value"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", list(CELLS))
def test_control_on_the_card(cuda, workload):
    """The control at the cell's own traffic on the card, one seed (the
    three and more seeds of the record: control.py)."""
    cell = harness.Cell(workload, SEED, 1.0, False, device=cuda,
                        control=True)
    r = cell.run(time.perf_counter())
    assert r["correct"] is False
