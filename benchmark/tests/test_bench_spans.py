"""The arithmetic of ``harness/spans.py`` and the readers of the port's
spans, on made-up timelines (nanoseconds)."""

import pytest

from harness import core, spans
from harness.tracing import Trace

NEW = ("demons_levels_ms.dir", "copy_ms.dir", "copy_ms.planqa",
       "copy_ms.view", "masks_host_ms.planqa", "goals_host_ms.planqa",
       "gamma_launches.planqa")

H2D = "Memcpy HtoD (Pageable -> Device)"
D2H = "Memcpy DtoH (Device -> Pageable)"


def fake_run(trace, jobs=2):
    run = core.Run("x", True)
    run.jobs = [(0.0, 1.0)] * jobs
    run.window = (0.0, 1.0)
    run.trace = trace
    return run


def test_idle_inside_a_span_counts_work_launched_before_it():
    # mia.dose.goals holds 100-600; a kernel launched at 50 (before the
    # span) runs 80-250 inside it, one launched inside runs 400-450
    device = [(80, 250, "k0", 50), (400, 450, "k1", 380),
              (700, 800, "k2", 690)]
    tr = Trace(device, [(0, 1000, "bench.goals"),
                        (100, 600, "mia.dose.goals")], (0, 1000))
    # idle in 100-600: 250-400 and 450-600
    assert spans.idle_s(tr, "mia.dose.goals") == pytest.approx(300e-9)
    # launched under it: k1 alone
    assert spans.launches(tr, "mia.dose.goals") == 1


def test_ranges_of_one_name_count_once_and_clip_to_the_window():
    # two ranges of one name, one inside the other, and one across the
    # window's end: idle 0-100 once, and 900-1000 of the last
    tr = Trace([], [(0, 100, "mia.rois.cache"), (20, 60, "mia.rois.cache"),
                    (900, 1200, "mia.rois.cache")], (0, 1000))
    assert spans.idle_s(tr, "mia.rois.cache") == pytest.approx(200e-9)


def test_copies_go_to_the_innermost_range():
    # mia.demons holds 0-1000; inside it mia.demons.inputs 10-200 and
    # mia.demons.field_out 800-990; one copy launched in each, one in
    # mia.demons alone and one outside every mia range
    device = [(20, 120, H2D, 15), (150, 400, "kernel", 140),
              (500, 560, D2H, 450), (850, 980, D2H, 810),
              (1100, 1150, D2H, 1020)]
    tr = Trace(device, [(0, 1000, "mia.demons"),
                        (10, 200, "mia.demons.inputs"),
                        (800, 990, "mia.demons.field_out"),
                        (0, 1200, "bench.demons")], (0, 1200))
    by = spans.copies_by_range(tr)
    assert by == pytest.approx({("mia.demons.inputs", H2D): 100e-9,
                                ("mia.demons", D2H): 60e-9,
                                ("mia.demons.field_out", D2H): 130e-9,
                                (None, D2H): 50e-9})
    # the total is taken under the benchmark's bench.* range, whichever
    # of the port's ranges the copy was launched in, if any
    assert spans.copy_s(tr) == pytest.approx(340e-9)
    assert spans.copy_s(tr, spans.PORT) == pytest.approx(290e-9)
    assert spans.innermost(tr, [5, 15, 300, 995, 1100]) == [
        "mia.demons", "mia.demons.inputs", "mia.demons", "mia.demons",
        None]


def test_launches_counted_under_a_range():
    device = [(10 * i + 5, 10 * i + 8, f"k{i}", 10 * i) for i in range(10)]
    tr = Trace(device, [(0, 35, "mia.gamma.scan"),
                        (50, 75, "mia.gamma.scan")], (0, 100))
    # launches at 0, 10, 20, 30 and 50, 60, 70
    assert spans.launches(tr, "mia.gamma.scan") == 7
    assert spans.per_job(fake_run(tr), 7) == pytest.approx(3.5)


SPAN = {"demons_levels_ms.dir": "mia.demons.level",
        "copy_ms.dir": "bench.demons", "copy_ms.planqa": "bench.goals",
        "copy_ms.view": "bench.update",
        "masks_host_ms.planqa": "mia.rois.masks",
        "goals_host_ms.planqa": "mia.dose.goals",
        "gamma_launches.planqa": "mia.gamma.scan"}


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_none_without_their_spans(name):
    # copies and a kernel under other ranges than the reader's: the
    # benchmark's where the reader takes the port's, the port's where
    # it takes the benchmark's
    device = [(10, 50, H2D, 5), (60, 90, "kernel", 55)]
    other = ("mia.demons", "mia.x") if SPAN[name].startswith("bench.") \
        else ("bench.demons", "bench.goals", "bench.masks")
    tr = Trace(device, [(0, 100, n) for n in other], (0, 100))
    reader = core.load_metric(name)
    assert reader.read(fake_run(tr)) is None
    assert reader.read(fake_run(None)) is None


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_their_spans(name):
    # two jobs; under the span: a copy 10-30 (launched at 5) and a
    # kernel 40-60 (launched at 35); the span 0-100 is idle for 60 ns
    device = [(10, 30, H2D, 5), (40, 60, "kernel", 35)]
    tr = Trace(device, [(0, 100, SPAN[name])], (0, 100))
    want = {"demons_levels_ms.dir": 40e-9 * 1e3 / 2,
            "masks_host_ms.planqa": 60e-9 * 1e3 / 2,
            "goals_host_ms.planqa": 60e-9 * 1e3 / 2,
            "gamma_launches.planqa": 1.0}.get(name, 20e-9 * 1e3 / 2)
    assert core.load_metric(name).read(fake_run(tr)) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_zero_where_their_spans_hold_nothing(name):
    # the span 10-90 is there, but the one kernel, 0-100, was launched
    # before it: nothing launched under it, no copy, no idle time
    tr = Trace([(0, 100, "kernel", -5)], [(10, 90, SPAN[name])], (0, 100))
    assert core.load_metric(name).read(fake_run(tr)) == 0
