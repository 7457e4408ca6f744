"""chip_smoke.py's ``device_ms`` rule on synthetic profiler traces: a
kernel seen fewer times than it was launched is scaled by launches / seen
only when its events are short of time (the profiler dropped launches);
when some events last more than ``MERGED_EVENT`` times the median (the
profiler folded launches into one event) the summed time stands whole.

The dropped case has the shape of a P = 1 b1 top-10 trace of the sharded
path on the H100: 17 ``scan_small_k`` events of 20 launches summing
44.7 ms, each about 2.63 ms, as long as every event of a whole trace of
the same call (the store after its 0.1% delete, whose tombstone mask
every scan reads). Scaled, it reads 2.63 ms a call. The merged case is
synthetic: no trace on the card has shown an event past 1.5x its
median; the rule keeps such a trace whole if one ever does.

``agreement`` holds ``device_ms`` against the busy share's own trace of
the same call, read by its events' lengths (``events_per_call``) when
that trace lost events.
"""

import importlib.util
from pathlib import Path

import pytest

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

REPS = 20
SCAN = "void scan_small_k<float, 10>(...)"
MERGE = "void merge_small_k<10>(...)"
COPY = "Memcpy DtoH (Device -> Pinned)"
EXPECT = ("scan_small_k", "merge_small_k")


def trace(scan_events: list[float], merge_events: list[float],
          copy_events: list[float]):
    """(by_name ms a call, counts, lengths) as profile_device gives them
    for one trace of REPS calls."""
    lengths = {SCAN: scan_events, MERGE: merge_events, COPY: copy_events}
    by_name = {k: sum(v) / REPS for k, v in lengths.items()}
    counts = {k: len(v) for k, v in lengths.items()}
    return by_name, counts, lengths


# the dropped case: 17 events of 44.7 ms in all, each as long as a launch
DROPPED = [44.7 / 17] * 17
# a synthetic merged case: 14 single launches of 2.11 ms and 3 events of
# 5.05 ms (about two launches and a half each): 17 events, 44.7 ms in all
MERGED = [2.11] * 14 + [(44.7 - 14 * 2.11) / 3] * 3


@pytest.mark.parametrize("scan,want", [
    ([2.11] * 20, 2.11),                     # whole: nothing to scale
    (DROPPED, 44.7 / 17),                    # 3 launches dropped: scaled
    (MERGED, 44.7 / REPS),                   # 3 launches merged: whole
], ids=["whole", "dropped", "merged"])
def test_per_call_ms_scales_only_dropped_launches(scan, want):
    by_name, counts, lengths = trace(scan, [0.005] * 20, [0.01] * 17)
    got = chip_smoke.per_call_ms(by_name, counts, lengths, EXPECT, REPS)
    assert got[SCAN] == pytest.approx(want, rel=1e-9)
    assert got[MERGE] == pytest.approx(0.005, rel=1e-9)
    # a copy is not a kernel the call launches once: never scaled
    assert got[COPY] == pytest.approx(0.01 * 17 / REPS, rel=1e-9)


def test_merged_events_threshold():
    assert not chip_smoke.merged_events([])
    assert not chip_smoke.merged_events([2.0] * 10 + [2.9])
    assert chip_smoke.merged_events([2.0] * 10 + [3.1])
    assert chip_smoke.MERGED_EVENT == 1.5


def test_event_stats_reads_each_kernels_events():
    by_name, counts, lengths = trace(DROPPED, [0.005] * 20, [0.01] * 17)
    got = chip_smoke.event_stats(lengths, EXPECT)
    assert set(got) == set(EXPECT)
    assert got["scan_small_k"]["events"] == 17
    assert got["scan_small_k"]["lengths_ms"] == DROPPED
    assert got["scan_small_k"]["median_ms"] == pytest.approx(44.7 / 17)
    assert got["merge_small_k"]["max_ms"] == 0.005
    assert chip_smoke.event_stats({}, EXPECT) == {}


@pytest.mark.parametrize("scan,want", [
    (DROPPED, 44.7 / 17 + 0.005),
    (MERGED, 44.7 / REPS + 0.005),
], ids=["dropped", "merged"])
def test_device_ms_reads_event_lengths(monkeypatch, scan, want):
    """device_ms over three agreeing traces of the same shape returns
    their per-call sum, merge included (the copy is not in ``expect``
    here and carries no time)."""
    def fake_profile(fn, reps, expect=(), tries=3, lengths=None):
        by_name, counts, lens = trace(scan, [0.005] * 20, [])
        by_name.pop(COPY)
        counts.pop(COPY)
        lens.pop(COPY)
        lengths.clear()
        lengths.update(lens)
        return 1.0, by_name, counts, False

    monkeypatch.setattr(chip_smoke, "profile_device", fake_profile)
    out = chip_smoke.device_ms(lambda: None, REPS, EXPECT)
    assert out["device_ms"] == pytest.approx(want, rel=1e-9)
    assert out["launches_seen"] == {"scan_small_k": len(scan),
                                    "merge_small_k": 20}
    assert len(out["device_ms_traces"]) == 3
    assert out["events_ms"]["scan_small_k"]["lengths_ms"] == scan


def test_events_per_call_reads_a_lossy_trace_by_its_events():
    """17 of 20 scan events, each 2.63 ms: the call is 2.63 ms of scan
    plus the merge and the copy at their summed time a call."""
    by_name, counts, lengths = trace(DROPPED, [0.005] * 20, [0.01] * 17)
    got = chip_smoke.events_per_call(by_name, lengths, EXPECT)
    assert got == pytest.approx(44.7 / 17 + 0.005 + 0.01 * 17 / REPS,
                                rel=1e-9)


@pytest.mark.parametrize("dev,share,want", [
    (2.15, {"device_ms_per_call": 2.10}, True),
    (2.67, {"device_ms_per_call": 2.15}, False),
    (2.15, {"device_ms_per_call": "not measured (the profiler missed "
            "events)", "device_ms_per_call_by_events": 2.14}, True),
    ("not measured (no three traces agree)", {"device_ms_per_call": 2.1},
     "not compared: one of them was not measured"),
    (2.15, {"device_ms_per_call": "not measured"},
     "not compared: one of them was not measured"),
], ids=["whole", "apart", "by_events", "no_device_ms", "no_share"])
def test_agreement_within_trace_margin(dev, share, want):
    got = chip_smoke.agreement(dev, share)
    assert got["agreement"] == want
    assert got["device_share_ms"] == share["device_ms_per_call"]
    if "device_ms_per_call_by_events" in share:
        assert got["device_share_ms_by_events"] == 2.14
