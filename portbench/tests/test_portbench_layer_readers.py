"""The readers of the program's busy times, DtoH split and GIL probe, on
synthetic records: what each reads, and None where the program recorded
nothing (a tree without those measures)."""

import pytest

from portbench import registry

TAKE_READERS = ("dtoh_busy_ms", "dtoh_card_gb_s", "pin_alloc_ms", "storage_write_busy_gb_s",
                "gil_wait_pct", "gil_wait_max_ms")
RESTORE_READERS = ("storage_read_busy_gb_s", "consume_busy_ms")


def _take(dtoh_busy, dtoh_bytes, card_ns, pin_ns, written, write_busy, gil_ns, wall, gil_max):
    return {
        "rollup": {"take_wall_s": wall},
        "stats": {},
        "take_summary": {
            "take_wall_s": wall,
            "stages": {"dtoh": {"total_s": 9.0, "busy_s": dtoh_busy},
                       "storage_write": {"total_s": 9.0, "busy_s": write_busy}},
            "counters": {"dtoh.bytes": dtoh_bytes, "dtoh.card_ns": card_ns,
                         "dtoh.pin_alloc_ns": pin_ns, "storage.bytes_written": written,
                         "gil.wait_ns": gil_ns, "gil.samples": 100},
            "gauges": {"gil.wait_max_s": gil_max},
        },
    }


def _restore(read, read_busy, consume_busy):
    return {"restore_s": 1.0, "stats": {}, "summary": {
        "stages": {"storage_read": {"total_s": 9.0, "busy_s": read_busy},
                   "consume": {"total_s": 9.0, "busy_s": consume_busy}},
        "counters": {"storage.bytes_read": read},
    }}


TAKES = {"records": [
    _take(0.05, 2_000_000_000, 50_000_000, 3_000_000, 2_000_000_000, 1.0, 10_000_000, 2.0, 0.020),
    _take(0.07, 1_000_000_000, 25_000_000, 1_000_000, 1_000_000_000, 2.0, 30_000_000, 2.0, 0.040),
]}
RESTORES = {"records": [_restore(1_800_000_000, 0.5, 0.3), _restore(1_800_000_000, 0.4, 0.5)]}


@pytest.mark.parametrize("name,want", [
    ("dtoh_busy_ms", 60.0),  # mean of 50 and 70 ms
    ("dtoh_card_gb_s", 40.0),  # 3 GB over 75 ms on the card
    ("pin_alloc_ms", 2.0),  # mean of 3 and 1 ms
    ("storage_write_busy_gb_s", 1.0),  # 3 GB over 3 s busy
    ("gil_wait_pct", 1.0),  # 40 ms waited over 4 s of takes
    ("gil_wait_max_ms", 30.0),  # mean of 20 and 40 ms
])
def test_take_readers(name, want):
    assert registry.metric(name)(TAKES) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [
    ("storage_read_busy_gb_s", 4.0),  # 3.6 GB over 0.9 s busy
    ("consume_busy_ms", 400.0),  # mean of 300 and 500 ms
])
def test_restore_readers(name, want):
    assert registry.metric(name)(RESTORES) == pytest.approx(want)


@pytest.mark.parametrize("name", TAKE_READERS + RESTORE_READERS)
def test_readers_find_nothing_on_a_tree_without_the_measures(name):
    """The parent's summaries: no ``busy_s``, no ``dtoh.*`` or ``gil.*``."""
    bare_take = {"rollup": {}, "stats": {}, "take_summary": {
        "take_wall_s": 2.0, "stages": {"dtoh": {"total_s": 1.0}, "storage_write": {"total_s": 1.0}},
        "counters": {"storage.bytes_written": 10}, "gauges": {}}}
    bare_restore = {"restore_s": 1.0, "stats": {}, "summary": {
        "stages": {"storage_read": {"total_s": 1.0}, "consume": {"total_s": 1.0}},
        "counters": {"storage.bytes_read": 10}}}
    for records in ([], [bare_take, bare_restore], [{"rollup": {}, "stats": {}, "take_summary": {}}]):
        assert registry.metric(name)({"records": records}) is None


@pytest.mark.parametrize("name", TAKE_READERS)
def test_take_readers_ignore_restore_records(name):
    assert registry.metric(name)(RESTORES) is None


@pytest.mark.parametrize("name", RESTORE_READERS)
def test_restore_readers_ignore_take_records(name):
    assert registry.metric(name)(TAKES) is None


def test_gil_wait_pct_stays_a_share():
    """Lateness summed over a probe that lives inside the take cannot
    pass the take's wall time."""
    full = {"records": [_take(0.1, 1, 1, 1, 1, 1.0, 2_000_000_000, 2.0, 0.005)]}
    assert registry.metric("gil_wait_pct")(full) == pytest.approx(100.0)


def test_every_reader_has_its_entry():
    bench = registry.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in TAKE_READERS + RESTORE_READERS:
        assert entries[name]["source"] == "program_span"
    for name in ("dtoh_busy_ms", "dtoh_card_gb_s", "pin_alloc_ms", "storage_write_busy_gb_s",
                 "gil_wait_pct"):
        assert entries[name]["workloads"] == ["big.async_mem", "big.sync_mem"]
    assert entries["gil_wait_max_ms"]["workloads"] == ["big.async_mem"]
    assert entries["gil_wait_max_ms"]["moves"] == "step_ms_p95"
    for name in RESTORE_READERS:
        assert entries[name]["workloads"] == ["big.resume_fs"]
