"""Greedy SyN with ANTs-CC (LNCC) forces, on the CPU: the port's
``Deformable.compute_demons(method="syn", forces="lncc")`` on pairs of
the benchmark's seeded T1 brain phantom (``benchmark/harness/brain.py``)
at 20 x 24 x 28 voxels of 8 mm (the OASIS field of view), a 3-level
pyramid, against the benchmark's plain reference
(``benchmark/harness/reference/syn.py``) in float64; the per-level
``iterations``; SyN's counter and its assembly span.

Tolerances against the float64 reference, each above what float32
itself gives (the reference computed in float32 forks from float64 by
the same amounts as the port, to the digit, on these seeds) and below
what bfloat16 contractions give (the control, one precision step below
float32 on a CPU):

- the stored field one voxel in from the faces, at most 0.1 mm:
  float32's largest 0.026 mm, bfloat16's smallest 3.1 mm;
- the field's mean gap over the grid, at most 5e-3 mm: float32's
  largest 3.6e-4 mm, bfloat16's smallest 0.19 mm;
- the deformed image one voxel in from the faces, at most 10 voxels
  more than one intensity unit (of a white matter at 1,000) apart:
  float32 none, bfloat16 at least 3,600;
- the voxels where exactly one side reads the display background, at
  most 200: float32's own 81-105, on the grid's faces, where a sample
  within rounding of the last slice falls inside on one side and out
  on the other; bfloat16 at least 672.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import medicalimageanalysis_torch as tmia
from medicalimageanalysis_torch import interop
from medicalimageanalysis_torch.config import config as tconfig
from medicalimageanalysis_torch.data import Data as TData
from medicalimageanalysis_torch.device import set_default_device
from medicalimageanalysis_torch.ops.registration import demons as tdemons

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from harness import brain, phantoms  # noqa: E402
from harness.jobs.syn import gaps  # noqa: E402
from harness.reference import syn as reference  # noqa: E402

SHAPE = (28, 24, 20)                      # (Z, Y, X)
SPACING = [8.0, 8.0, 8.0]                 # [sx, sy, sz] mm
ORIGIN = [-(n - 1) / 2 * s for n, s in zip(SHAPE[::-1], SPACING)]
SOLVER = dict(method="syn", forces="lncc", lncc_radius=2,
              pyramid=[4, 2, 1], iterations=[4, 3, 2], std=1.732,
              smooth=False, step=2.0)
LIMITS = {"field_interior_max_mm": 0.1, "field_mean_mm": 5e-3,
          "image_voxels_over_1": 10, "edge_flips": 200}


@pytest.fixture(autouse=True)
def torch_env():
    TData.clear()
    torch.set_num_threads(1)
    set_default_device("cpu")
    yield
    TData.clear()
    set_default_device(None)


def subjects(seed, n=2):
    """``n`` int16 subjects of one seeded template, registered as port
    MR images ``s0``, ``s1``, ..."""
    gen = phantoms.generator(seed, "cpu")
    t = brain.template(gen)
    out = []
    for k in range(n):
        vol, _ = brain.subject(SHAPE, SPACING, t, gen, (3.0, 8.0), 0.15,
                               0.02)
        out.append(vol.to(torch.int16).numpy())
        interop.image_from_arrays(out[-1], SPACING, ORIGIN, np.eye(3), "MR",
                                  f"s{k}")
    return out


def registered(**solver):
    """The port's stored field and deformed image, s1 onto s0."""
    d = tmia.Deformable(reference_name="s0", moving_name="s1", device="cpu")
    d.compute_demons(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in solver.items()})
    return np.asarray(d.dvf), d.create_image()["array"]


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 12])
def test_syn_lncc_matches_the_plain_reference(seed):
    fixed, moving = subjects(seed)
    field, image = registered(**SOLVER)
    bg = float(tconfig.background_fill)
    want = reference.register_and_warp(fixed, moving, SPACING, SOLVER, bg)
    assert np.abs(want[0]).max() > 2.0                 # the solver moved
    got = gaps(field, image, *want, bg)
    assert all(got[k] <= v for k, v in LIMITS.items()), got
    lowered = gaps(*reference.register_and_warp(
        fixed, moving, SPACING, SOLVER, bg, dtype=torch.float32,
        contract=torch.bfloat16), *want, bg)
    assert any(lowered[k] > v for k, v in LIMITS.items()), lowered


@pytest.mark.parametrize("method,forces", [("fast", "ssd"),
                                           ("syn", "lncc"), ("syn", "ssd")])
def test_equal_counts_a_level_give_the_int_result_bit_for_bit(method,
                                                              forces):
    fixed, moving = subjects(5)
    kw = dict(method=method, forces=forces, pyramid=(4, 2), step=1.0,
              lncc_radius=2)
    want = tdemons.demons_registration(fixed, moving, SPACING,
                                       iterations=3, **kw)
    for counts in ((3, 3, 3), [3, 3, 3], np.array([3, 3, 3])):
        got = tdemons.demons_registration(fixed, moving, SPACING,
                                          iterations=counts, **kw)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pyramid,counts", [((4, 2, 1), (3, 3)),
                                            ((4, 2), (3, 3)),
                                            ((4, 2, 1), (3, 3, 3, 3)),
                                            (None, (3, 3))])
def test_counts_of_another_length_raise(pyramid, counts):
    fixed, moving = subjects(5)
    with pytest.raises(ValueError, match="iteration counts"):
        tdemons.demons_registration(fixed, moving, SPACING, method="syn",
                                    forces="lncc", pyramid=pyramid,
                                    iterations=counts)


@pytest.mark.parametrize("forces,sums", [("lncc", 5), ("ssd", 0)])
def test_syn_counts_its_work_level_by_level(forces, sums):
    """Three levels at 3, 2 and 1 iterations: six iterations, five
    windowed sums each with CC forces (none with SSD), two exps of three
    squarings each, one assembly."""
    fixed, moving = subjects(5)
    before = dict(tdemons.SYN)
    info = {}
    tdemons.demons_registration(fixed, moving, SPACING, method="syn",
                                forces=forces, pyramid=(4, 2, 1),
                                iterations=(3, 2, 1), lncc_radius=2,
                                info=info)
    got = {k: tdemons.SYN[k] - before[k] for k in before}
    assert got == {"levels": 3, "iterations": 6, "box_sums": 6 * sums,
                   "squarings": 36, "assembles": 1}
    assert len(info["level_shapes"]) == 3


def test_per_level_counts_run_level_by_level():
    """(2, 0, 1) runs two iterations at the coarse level, none at the
    middle one (the field carried through) and one at full size: the
    fields of the same levels run one at a time, warm-started in turn."""
    fixed, moving = subjects(5)
    before = dict(tdemons.SYN)
    tdemons.demons_registration(fixed, moving, SPACING, method="syn",
                                forces="lncc", pyramid=(4, 2, 1),
                                iterations=(2, 0, 1), lncc_radius=2)
    assert tdemons.SYN["iterations"] - before["iterations"] == 3
    assert tdemons.SYN["box_sums"] - before["box_sums"] == 15


@pytest.mark.parametrize("method,assembles", [("syn", 1), ("fast", 0)])
def test_assemble_span_once_a_syn_registration(method, assembles):
    fixed, moving = subjects(5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tdemons.demons_registration(fixed, moving, SPACING, method=method,
                                    forces="lncc", pyramid=(2, 1),
                                    iterations=(2, 1), lncc_radius=2)
    names = [e.name for e in prof.events()]
    assert names.count("mia.syn.assemble") == assembles
    assert names.count("mia.demons.level") == 2


@pytest.mark.parametrize("factor,with_halves", [(4, False), (2, True),
                                                (1, True)])
def test_syn_level_inputs_keep_the_pyramid_bits(factor, with_halves):
    """SyN's level set-up through the kept operators gives the bits of the
    other methods' downsampling, voxel ratio and prolongation."""
    fixed, moving = (torch.as_tensor(v, dtype=torch.float32)
                     for v in subjects(7))
    sp = torch.tensor(SPACING, dtype=torch.float32)
    gen = torch.Generator().manual_seed(3)
    halves = [torch.randn((7, 6, 5, 3), generator=gen) for _ in range(2)] \
        if with_halves else None
    f_l, m_l, sp_l, u1_0, u2_0 = tdemons._syn_inputs(fixed, moving, sp,
                                                     factor, halves)
    want_f = tdemons._downsample_volume(fixed, factor) if factor > 1 \
        else fixed
    assert torch.equal(f_l, want_f)
    assert torch.equal(m_l, tdemons._downsample_volume(moving, factor)
                       if factor > 1 else moving)
    ratio = torch.tensor([SHAPE[2] / f_l.shape[2], SHAPE[1] / f_l.shape[1],
                          SHAPE[0] / f_l.shape[0]], dtype=torch.float32)
    assert torch.equal(sp_l, sp * ratio)
    if not with_halves:
        assert u1_0 is None and u2_0 is None
        return
    for got, h in zip((u1_0, u2_0), halves):
        want = torch.movedim(tdemons._upsample_field(h, f_l.shape) / sp_l,
                             -1, 0).contiguous()
        assert torch.equal(got, want)


def test_syn_level_off_the_card_is_new_and_steps_eagerly():
    """Off the card nothing is kept, and ``run`` is ``n`` steps one after
    another (0 steps hand back the start)."""
    fixed, moving = (torch.as_tensor(v, dtype=torch.float32)
                     for v in subjects(9))
    sp = torch.tensor(SPACING, dtype=torch.float32)
    args = (SHAPE, 1.732, 2.0, 0.001, False, "lncc", 2,
            torch.device("cpu"))
    kept = dict(tdemons._SYN_LEVELS)
    a, b = tdemons._syn_level(*args), tdemons._syn_level(*args)
    assert a is not b and tdemons._SYN_LEVELS == kept
    a.load(fixed, moving, sp)
    zero = torch.zeros((3,) + SHAPE)
    assert all(t is zero for t in a.run(zero, zero, 0))
    want = (zero, zero)
    with torch.no_grad():
        for _ in range(3):
            want = a.step(*want)
    got = a.run(zero, zero, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert a.graph is None


def test_captured_launches_count_once_a_replay(monkeypatch):
    """A capture's launches leave the warp counters as they were; each
    replay adds them once."""
    from medicalimageanalysis_torch.ops import warp

    monkeypatch.setattr(warp, "LAUNCHES", {"warp_disp": 5,
                                           "warp_coords": 1})
    key = ("warp_disp", 4, False, (2, 3, 4), (2, 3, 4))
    monkeypatch.setattr(warp, "LAUNCH_SHAPES", {key: 5})
    mark = warp.launch_counts()
    new = ("warp_disp", 1, False, (2, 3, 4), (2, 3, 4))
    warp.LAUNCHES["warp_disp"] += 3          # what a capture counts
    warp.LAUNCH_SHAPES[key] += 2
    warp.LAUNCH_SHAPES[new] = 1
    delta = warp.captured_launches(mark)
    assert (warp.LAUNCHES, warp.LAUNCH_SHAPES) == mark
    assert delta == ({"warp_disp": 3}, {key: 2, new: 1})
    warp.count_replays(delta, 4)
    assert warp.LAUNCHES == {"warp_disp": 17, "warp_coords": 1}
    assert warp.LAUNCH_SHAPES == {key: 13, new: 4}
