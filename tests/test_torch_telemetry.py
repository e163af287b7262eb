"""The port's spans (``telemetry.trace``) on the CPU, at tiny sizes.

Off: with no profiler recording, ``trace`` enters no
``record_function`` range and reads no clock, and the traced paths
return what they return with the spans recorded. On: under a CPU
``torch.profiler.profile`` each path's spans appear, as many as its
stages, each inside the span that holds it (PERF.md's span table)."""

import time

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
from medicalimageanalysis_torch import interop, telemetry
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device

SHAPE = (16, 32, 32)
SPACING = [2.0, 2.0, 3.0]            # [sx, sy, sz] mm
PLANES = ("Axial", "Coronal", "Sagittal")
GOALS = {"Body": ["Dmax <= 62Gy", "D95% >= 20Gy", "V20Gy <= 35%"],
         "Core": ["Dmean >= 30Gy", "D2cc <= 80Gy"]}


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def blob(shift=(0.0, 0.0, 0.0)):
    """A smooth HU-like ellipsoid on SHAPE, its centre moved by ``shift``
    voxels (z, y, x)."""
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in SHAPE),
                          indexing="ij")
    c = [(n - 1) / 2 + s for n, s in zip(SHAPE, shift)]
    r2 = (((z - c[0]) / 5) ** 2 + ((y - c[1]) / 9) ** 2
          + ((x - c[2]) / 10) ** 2)
    return (1000.0 * np.exp(-r2) - 1000.0).astype(np.int16)


def add_image(name, shift=(0.0, 0.0, 0.0)):
    return interop.image_from_arrays(blob(shift), SPACING, [0.0, 0.0, 0.0],
                                     np.eye(3), "CT", name)


def circles(radius_mm, centre_mm=(31.0, 31.0)):
    """Axial contours, (N, 3) mm, on the middle slices."""
    t = np.linspace(0.0, 2 * np.pi, 24, endpoint=False)
    return [np.stack([centre_mm[0] + radius_mm * np.cos(t),
                      centre_mm[1] + radius_mm * np.sin(t),
                      np.full_like(t, k * SPACING[2])], axis=1)
            for k in range(4, 12)]


def plan_case():
    """A CT with two contoured ROIs and two doses on a coarser grid."""
    image = add_image("CT")
    interop.rois_from_numpy(image, {"Body": circles(20.0),
                                    "Core": circles(8.0)})
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64)
                            for n in (12, 18, 18)), indexing="ij")
    dose = 60.0 * np.exp(-((z - 6) ** 2 + (y - 9) ** 2 + (x - 9) ** 2) / 40)
    for name, scale in (("RTDOSE plan", 1.0), ("RTDOSE eval", 1.02)):
        interop.dose_from_numpy(dose * scale, [4.0, 4.0, 4.0],
                                [-2.0, -2.0, -1.5], np.eye(3), name=name)
    return image


# -- the paths: set-up outside the profiled call, then the call --------
def demons_path():
    add_image("fixed")
    add_image("moving", shift=(0.5, 1.0, -1.0))
    d = tmia.Deformable(reference_name="fixed", moving_name="moving",
                        device="cpu")

    def call():
        info = d.compute_demons(method="fast", pyramid=(4, 2, 1),
                                iterations=2)
        return [np.asarray(d.dvf), d.create_image()["array"],
                info["level_shapes"]]
    return call


def syn_path():
    """Greedy SyN with CC forces over two levels, at one count a level."""
    add_image("fixed")
    add_image("moving", shift=(0.5, 1.0, -1.0))
    d = tmia.Deformable(reference_name="fixed", moving_name="moving",
                        device="cpu")

    def call():
        info = d.compute_demons(method="syn", forces="lncc",
                                lncc_radius=2, pyramid=(2, 1),
                                iterations=(2, 1), smooth=False)
        return [np.asarray(d.dvf), d.create_image()["array"],
                info["level_shapes"]]
    return call


def masks_path():
    image = plan_case()
    return lambda: image.compute_roi_masks()


def goals_path():
    image = plan_case()
    image.compute_roi_masks()
    dose = TData.dose["RTDOSE plan"]
    return lambda: dose.evaluate_constraints(GOALS, image_name="CT")


def gamma_path():
    plan_case()
    dose = TData.dose["RTDOSE plan"]

    def call():
        g = dose.compute_gamma("RTDOSE eval", dose_pct=3.0, dta_mm=3.0)
        return [g["gamma"], g["pass_rate"]]
    return call


def view_path():
    add_image("reference")
    add_image("overlay", shift=(0.0, 2.0, 1.0))
    rigid = tmia.Rigid("reference", "overlay", device="cpu")
    for p in PLANES:                          # the first reslice
        rigid.retrieve_array_plane(p)

    def call():
        rigid.update_rotation(r_x=1.0, r_y=-0.5, r_z=2.0)
        return [rigid.retrieve_array_plane(p) for p in PLANES]
    return call


def demons_batch_path():
    """Two pairs over a mesh of two CPU entries, one pair a data row."""
    from medicalimageanalysis_torch.parallel.batch import demons_batch
    from medicalimageanalysis_torch.parallel.mesh import make_mesh

    fixed = np.stack([blob(), blob()])
    moving = np.stack([blob((0.5, 1.0, -1.0)), blob((0.0, -1.0, 0.5))])
    mesh = make_mesh(devices=["cpu"] * 2)
    return lambda: demons_batch(fixed, moving, SPACING, iterations=2,
                                mesh=mesh)


def view_array_path():
    """A rotation, then the whole overlay read on the host."""
    add_image("reference")
    add_image("overlay", shift=(0.0, 2.0, 1.0))
    rigid = tmia.Rigid("reference", "overlay", device="cpu")

    def call():
        rigid.update_rotation(r_x=1.0, r_y=-0.5, r_z=2.0)
        return rigid.display.array
    return call


PATHS = {"demons": demons_path, "masks": masks_path, "goals": goals_path,
         "gamma": gamma_path, "view": view_path,
         "view_array": view_array_path,
         "demons_batch": demons_batch_path, "syn": syn_path}

# (span, the span that holds it or None, how many) for each path
NESTING = {
    "demons": [("mia.demons", None, 1),
               ("mia.deformable.setup", "mia.demons", 1),
               ("mia.deformable.resample", "mia.demons", 1),
               ("mia.demons.inputs", "mia.demons", 2),
               ("mia.demons.level", "mia.demons", 3),
               ("mia.deformable.store", "mia.demons", 1),
               ("mia.deformable.dvf_out", None, 1),
               ("mia.deformable.create_image", None, 1),
               ("mia.deformable.image_out", "mia.deformable.create_image",
                1)],
    "syn": [("mia.demons", None, 1),
            ("mia.deformable.setup", "mia.demons", 1),
            ("mia.deformable.resample", "mia.demons", 1),
            ("mia.demons.inputs", "mia.demons", 2),
            ("mia.demons.level", "mia.demons", 2),
            ("mia.syn.assemble", "mia.demons", 1),
            ("mia.deformable.store", "mia.demons", 1),
            ("mia.deformable.dvf_out", None, 1),
            ("mia.deformable.create_image", None, 1),
            ("mia.deformable.image_out", "mia.deformable.create_image",
             1)],
    "masks": [("mia.rois.masks", None, 1),
              ("mia.rois.rasterize", "mia.rois.masks", 1),
              ("mia.rois.pack", "mia.rois.masks", 1),
              ("mia.rois.cache", "mia.rois.masks", 4)],
    "goals": [("mia.dose.goals", None, 1),
              ("mia.dose.roi_dose", "mia.dose.goals", len(GOALS)),
              ("mia.rois.device_mask", "mia.dose.roi_dose", len(GOALS)),
              ("mia.dose.values_out", "mia.dose.goals", len(GOALS)),
              ("mia.dose.coverage", "mia.dose.goals", len(GOALS)),
              ("mia.dose.goal_values", "mia.dose.goals", len(GOALS))],
    "gamma": [("mia.gamma", None, 1),
              ("mia.gamma.resample", "mia.gamma", 1),
              ("mia.gamma.scan", "mia.gamma", 1)],
    "demons_batch": [("mia.batch.demons", None, 1),
                     ("mia.batch.inputs", "mia.batch.demons", 2),
                     ("mia.batch.lockstep", "mia.batch.demons", 1),
                     ("mia.batch.fields_out", "mia.batch.demons", 1)],
    "view": [("mia.view.reslice", None, 1),
             ("mia.resample.warp", "mia.view.reslice", 1),
             ("mia.view.state", "mia.view.reslice", 1),
             ("mia.view.plane", None, len(PLANES))],
    "view_array": [("mia.view.reslice", None, 1),
                   ("mia.resample.warp", "mia.view.reslice", 1),
                   ("mia.view.state", "mia.view.reslice", 1),
                   ("mia.view.array", None, 1)],
}


def profiled(call):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = call()
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith("mia.")]
    return out, ranges


def same(a, b):
    """Equal, element by element, through lists, tuples and dicts."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def refuse(*args, **kwargs):
    raise AssertionError("called with no profiler recording")


def test_trace_off_enters_no_range_and_reads_no_clock(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(time, "perf_counter", refuse)
    ran = []
    with telemetry.trace("mia.x"):
        ran.append(1)

    @telemetry.trace("mia.y")
    def f(v):
        return v + 1

    assert ran == [1] and f(1) == 2


def test_trace_sees_a_profiler_started_after_the_span_was_made():
    span = telemetry.trace("mia.late")     # made with no profiler on

    @telemetry.trace("mia.late")
    def f():
        return 3

    def g():
        with span:
            return 4

    for call, want in ((f, 3), (g, 4)):
        out, ranges = profiled(call)
        assert out == want and [r[0] for r in ranges] == ["mia.late"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_off_path_returns_what_the_traced_path_returns(path, monkeypatch):
    traced, ranges = profiled(PATHS[path]())
    assert ranges
    TData.clear()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert same(PATHS[path]()(), traced)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_appear_and_nest(path):
    _, ranges = profiled(PATHS[path]())
    by = {}
    for name, start, end in ranges:
        by.setdefault(name, []).append((start, end))
    assert set(by) == {name for name, _, _ in NESTING[path]}
    for name, parent, count in NESTING[path]:
        assert len(by[name]) == count, name
        if parent is not None:
            assert all(any(ps <= s and e <= pe for ps, pe in by[parent])
                       for s, e in by[name]), (name, parent)


def test_batch_spans_run_in_order():
    """demons_batch: every row's inputs, then the lockstep rounds, then
    the fields out, one after another inside mia.batch.demons."""
    _, ranges = profiled(demons_batch_path())
    inner = sorted((start, end, name) for name, start, end in ranges
                   if name != "mia.batch.demons")
    assert [n for _, _, n in inner] == [
        "mia.batch.inputs", "mia.batch.inputs", "mia.batch.lockstep",
        "mia.batch.fields_out"]
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))
