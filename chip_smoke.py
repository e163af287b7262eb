#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch twin on the card, then drives the
port's two paths once at clinical CT size through the entry points a user
calls:

    read_dicoms -> Rigid.compute_intensity -> Rigid.create_image

on two synthetic 128 x 512 x 512 CT series with a known 3 degree + 4 mm
offset, and

    read_dicoms -> Deformable.compute_demons -> create_image
                -> compute_jacobian;  Deformable.compute_bspline

on a third series, the reference warped by a known smooth field (plus SyN
with LNCC forces and diffeomorphic demons on a reduced pair), then the
dose-QA path

    read_dicoms (CT + RTSTRUCT + RTDOSE) -> Image.compute_roi_masks
        -> Dose.compute_roi_dose_statistics / compute_dvh_curve per ROI
        -> parallel.batch.dvh_batch;  Deformable.update_dose / update_mask

on the reference series with a seven-ROI structure set and a uint32 dose
grid, the cohort rigid

    models.rigid_intensity.register_rigid_intensity_batch (4 pairs, each
        volume normalised on the card);  parallel.batch.make_registration_step

after the rigid path, and after the dose-QA path the plan-QA path

    utils.dose.accumulate_dose / Dose.evaluate_constraints / compute_eqd2 /
        compute_bed / compute_geud / compute_ntcp / compute_tcp
        -> Dose.compute_gamma, parallel.batch.gamma_batch
        -> utils.metrics.compare_rois (device against host),
           parallel.batch.compare_masks_batch, utils.roi.margin.expand_mask

on the same folder (its gamma scan and exact EDT are plain PyTorch on the
card, profiled against their bounds), then the view path

    Image.update_rotation (off-axis display) -> retrieve_array_plane /
        retrieve_vtk_volume / reset_array;
    Rigid.update_translation / update_rotation -> the resliced overlay,
        exact and with config.use_shear_warp (three lane_interp passes)

on the reference series and the fitted rigid (the lane_interp kernel is
then held against its plain twin at the passes this path ran), the
oblique entry ops/warp.affine_warp_oblique called alone at the display's
map (no path calls it; its launches are counted apart), and the cohort
preprocess at the bench shape. Between the plan-QA and the view paths
runs the ROI mesh path

    Image.create_external -> Roi.create_mesh / create_discrete_mesh /
        create_display_mesh (marching tetrahedra and smoothing on the
        card) -> Roi.convert_mask (the port's C++ border tracer, no cv2)
        -> Image.create_roi_from_margin / create_roi_from_boolean ->
        Dose.compute_isodose_contours -> Rigid.update_translation and
        Deformable.update_rois with visible meshes (the coords mode)

on the dose-QA folder, then the rest of the mesh slice on its meshes

    ops.voxelize.voxelize_mesh_device / voxelize_batch (each mesh against
        the host float64 twin) -> Roi.compute_mask of a mesh-only ROI
        (CreateImageFromMask.add_mesh_roi) -> Dose.evaluate_constraints
        and Deformable.compute_demons masked by mesh-only ROIs ->
        Rigid / Deformable Display.compute_mesh_slice (the coords mode)
        -> TriMesh.save / read_stl / read_vtk / read_ply / read_obj /
        read_3mf (ModelToMask) -> clean_mesh, the self-intersection
        repair, expansion, Refinement's splits, Volume.create

and after it the image-analysis path

    Image.resample_to (the CT onto the dose grid and back) /
        create_rotated_volume / compute_projection (MIP, mean, DRR) ->
        the Deformable Display's frames and grid planes ->
        a whole-body PET: compute_suv / compute_mtv_tlg / compute_radiomics
        (and the CT's PTV) -> an MR's correct_bias and n4_batch ->
        a 10-phase 4D-CT: find_phase_groups / combine_phases / compute_itv
        -> parallel.batch.demons_batch

(resamples bit-equal to the plain affine twin, texture counts bit-equal
to a numpy count, one N4 level against its float64 twin), then the IO
path

    Image.export_dicom / create_rtstruct / create_seg, Dose.create_rtdose,
        an RTPLAN, Rigid / Deformable.create_reg, Image.create_nifti,
        Rigid / Deformable.export_image, the save_* methods ->
        read_dicoms of the whole folder -> read_nifti / read_mhd /
        the load_* methods

at full size, every object read back held on the card against what was
written, then the rest of ingest

    read_dicoms of one folder: the reference CT as one enhanced
        multi-frame file, an NM RECON TOMO, NM planar and whole-body, a US
        cine, DX, CR, MG, RF and XA;  ops.bitpack.pack12 / unpack12_device

and the rest of registration

    Rigid.compute_phase_correlation / auto_register / compute_landmarks
        / compute_icp_vtk / compute_o3d -> Deformable.compute_tps ->
        utils.DeformableJAX.elastix (the default map and a staged
        Euler + B-spline map) -> Deformable.compute_demons(roi_names=
        ["Body"])

at full size, then the multi-device path on four logical shards of the
card

    parallel.mesh.make_mesh -> parallel.halo.gaussian_z_sharded /
        demons_z_sharded (SSD and LNCC) / warp_z_sharded /
        demons_batch_z_sharded -> the mesh= paths of parallel.batch and
        register_rigid_intensity_batch -> parallel.cohort.ingest_cohort
        -> initialize_distributed (one NCCL rank) and
        distributed_cohort_batch

each held against its single-device (mesh=None) result. Before the
paths, two phases of the port's public surface:

    validate.validate_kernels(fast=False) (every hand kernel bit-equal to
        its plain version and to a host golden at the JAX fixtures) ->
    the four examples (medicalimageanalysis_torch/examples: end_to_end,
        registration_suite, adaptive_rt, cohort_scale) at their own
        sizes, their own asserts holding

and the paths' warp launch shapes that no row times are timed on their
own tensors after the phase (recorded_rows). Each phase prints one JSON
line; any failure raises and exits non-zero. Near the end it
prints the card's name and power limit (nvidia-smi) and a JSON line with
every kernel's launches, error, times, bound and ms lost; the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

It needs a CUDA card and the rest of the repository: without either it
exits non-zero before printing any result. It imports torch, numpy,
scipy and the port; nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

SHAPE = (128, 512, 512)          # one clinical CT series (z, y, x)
SPACING = [0.8, 0.8, 2.0]        # [sx, sy, sz] mm
ROT_DEG = 3.0                    # known rotation about the volume's z axis
SHIFT_MM = 4.0                   # known origin shift of the moving series
RIGID_LEVELS = ((4, 60, 0.3), (2, 40, 0.1), (1, 25, 0.03))  # the default
SEED = 20261016
REF_UID = "1.2.826.0.1.3680043.10.1016.1"
MOV_UID = "1.2.826.0.1.3680043.10.1016.2"
DEF_UID = "1.2.826.0.1.3680043.10.1016.3"
REF_ORIGIN = [-204.4, -210.0, -128.0]
BUMP_MM = 4.0                    # known deformation: peak in x and in y
BUMP_SIGMA_MM = 60.0             # ... a Gaussian bump centred in the body
DEMONS_PYRAMID = (4, 2, 1)
# demons bounds (PERF.md §6): the residual ratio; its excess over the
# ratio the known field itself reaches through the same create_image
# (the floor the phantom's noise sets, printed beside it); the field's
# p95 error against the known field
RESIDUAL_LIMIT = 0.5
FLOOR_EXCESS = 1.1
FIELD_P95_LIMIT_MM = 0.5
# dose QA (phase_dose_qa): a 30 mm spherical PTV and a 60 Gy plan
PTV_RADIUS_MM = 30.0
PTV_CENTER_MM = (-20.0, -15.0, -30.0)      # (x, y, z), inside the body
PRESCRIPTION_GY = 60.0
DOSE_SPACING_MM = 2.5
DOSE_SCALING = 1.5e-8                      # 60 Gy -> 4.0e9 stored
DVH_BINS = 300
# the view path (phase_view): the display rotation, the Rigid nudges, and
# the bound on the shear lane's interior mean |diff| against the exact
# reslice (HU), fixed from a CPU rehearsal of the phase at (32, 128, 128)
# (PERF.md §6)
VIEW_DISPLAY_DEG = 30.0
VIEW_NUDGE_MM = 1.0
VIEW_NUDGE_DEG = 2.0
SHEAR_INTERIOR_HU = 2.0
SHEAR_MASK_AGREE = 0.93
PLANES = ("Axial", "Coronal", "Sagittal")
# the cohort rigid (phase_cohort_rigid): three known poses of the
# reference, (rx, ry, rz) degrees and (tx, ty, tz) mm about its centre.
# tz is a whole number of slices: a sub-slice z shift of this phantom
# (noise independent between slices) biases the MSE toward whole slices
# (a CPU rehearsal at (32, 128, 128): 1/8 slice fitted as 0)
COHORT_POSES = ((0.0, 0.0, 2.0, 3.0, -2.0, 2.0),
                (2.5, 0.0, 0.0, 0.0, 3.5, -2.0),
                (0.0, 3.5, 0.0, -2.0, 0.0, 4.0))
# plan QA (phase_plan_qa): the DVH goals; NTCP (LKB: TD50 Gy, m, n) of
# the organs and TCP (logistic: TCD50 Gy, gamma50, a) of the target
# (Emami / Burman-style literature values); the evaluated doses of the
# gamma checks (an exact 1 mm origin shift, a 5 % scale); the voxels the
# float64 brute force holds; the PTV margin
COHORT_PROFILE_STEPS = 15      # steps a pair in the cohort level's profile
# make_registration_step's rate (Adam moves each pose unit about this much
# a step; at the default 0.05, and at 0.02, the loss of a CPU rehearsal at
# (32, 128, 128) rose and fell within 10 steps)
STEP_LR = 0.01
PLAN_GOALS = {"PTV": ["D95% >= 55Gy", "Dmax <= 62Gy", "Dmean >= 58Gy"],
              "Lung_L": ["V20Gy <= 35%", "Dmean <= 20Gy"],
              "Lung_R": ["V20Gy <= 35%", "V5Gy <= 3000cc"],
              "SpinalCord": ["Dmax <= 45Gy", "D0.1cc <= 45Gy"],
              "Heart": ["D2cc <= 62Gy", "V30Gy <= 50%", "Dmedian <= 40Gy"]}
NTCP_LKB = {"Lung_L": (24.5, 0.18, 0.87), "Lung_R": (24.5, 0.18, 0.87),
            "SpinalCord": (66.5, 0.175, 0.05), "Heart": (48.0, 0.10, 0.35)}
TCP_PTV = (50.0, 2.0, -10.0)
GAMMA_CRITERIA = {"3%/3mm": dict(dose_pct=3.0, dta_mm=3.0),
                  "2%/2mm": dict(dose_pct=2.0, dta_mm=2.0),
                  "3%/3mm local": dict(dose_pct=3.0, dta_mm=3.0, local=True)}
GAMMA_SHIFT_MM = 1.0
GAMMA_SCALE = 1.05
GAMMA_BRUTE_VOXELS = 2000
MARGIN_MM = 5.0
EXTERNAL_HU = -250                          # create_external's default
# the rest of the mesh slice (phase_mesh_rest): a voxel where the card's
# voxelization differs from the float64 twin must have its center within
# this many pixels of the mesh (on the surface); a mesh of more points
# than TEXT_MESH_POINTS (the Body, the lungs) is written and read in the
# binary formats only: the text formats' Python line loops run at 10-25
# MB/s, seconds a format at these sizes
TIE_DISTANCE_PX = 1e-3
TEXT_MESH_POINTS = 100_000
BINARY_MESH_FORMATS = ("stl_binary", "ply_binary_colors")
# the image-analysis path (phase_image_analysis). PET: a whole-body PT
# series (Z, Y, X) at [sx, sy, sz] mm, stored int16 with a rescale slope,
# START decay over one hour, three hot spheres ((x, y, z) mm from the
# volume centre, radius mm, Bq/mL) in a body of PET_BACKGROUND_BQML; the
# lesion ROI is the largest sphere grown by PET_ROI_MARGIN_MM. MR: a
# phantom with a known smooth multiplicative bias (tests/test_n4.py's
# form), corrected at shrink 4. 4D: ten breathing phases whose tumour
# moves FOURD_AMPLITUDE_MM in z, cut to 64 slices (PERF.md §4). The
# demons_batch pairs, the Display's frame count, and the rotation and
# projection angles (degrees, zyx).
PET_UID = "1.2.826.0.1.3680043.10.1016.4"
MR_UID = "1.2.826.0.1.3680043.10.1016.5"
FOURD_UID = "1.2.826.0.1.3680043.10.1016.6"
PET_SHAPE = (250, 200, 200)
PET_SPACING = [4.07, 4.07, 3.0]
PET_SLOPE = 2.0
PET_BACKGROUND_BQML = 3000.0
PET_SPHERES = (((40.0, -20.0, 60.0), 25.0, 30000.0),
               ((-60.0, 10.0, -150.0), 15.0, 24000.0),
               ((20.0, 30.0, 200.0), 10.0, 18000.0))
PET_WEIGHT_KG = 75.0
PET_DOSE_BQ = 3.7e8
PET_HALF_LIFE_S = 6586.2
PET_START, PET_SERIES_TIME = "090000", "100000"
PET_ROI_MARGIN_MM = 10.0
PET_BIN_SUV = 0.5
PTV_BIN_HU = 25.0
SUV_CUT = 2.5
SUV_RELATIVE = 0.41
MR_SHAPE = (176, 256, 256)
MR_SPACING = [1.0, 1.0, 1.0]
MR_SHRINK = 4
# the B-spline control spacing floor of the MR's correction: at the
# default 32 voxels the finest levels absorb the phantom's sphere into
# the bias at this size (field spread 0.147 against the bound 0.041, on
# the card and in both packages on the CPU: scripts/image_analysis_cpu.py
# n4 --jax)
MR_CONTROL_SPACING_MM = 128.0
FOURD_PHASES = 10
FOURD_SHAPE = (64, 512, 512)
FOURD_SPACING = [0.98, 0.98, 2.5]
FOURD_AMPLITUDE_MM = 10.0
FOURD_TUMOUR_MM = 15.0
DEMONS_BATCH_SHAPE = (64, 256, 256)
DEMONS_BATCH_ITERATIONS = 50
DISPLAY_DIVISION = 4
IO_FRACTIONS = 30                # the io phase's RTPLAN: fractions and
IO_BEAMS = (("CW Arc", 181.0, 250.0), ("CCW Arc", 179.0, 230.0))  # beams
# ingest_rest: the NM, US and projection objects at clinical sizes
NM_TOMO_SHAPE = (128, 128, 128)  # one detector, SpacingBetweenSlices < 0
NM_PITCH_MM = 4.42
NM_DETECTOR_IPP = (-282.88, -282.88, 200.0)
NM_STATIC_SHAPE = (256, 256)
NM_WHOLE_BODY_SHAPE = (1024, 256)
US_SHAPE = (60, 480, 640)        # a grayscale cine
DX_SHAPE = (2048, 2048)
CR_SHAPE = (2500, 2048)
MG_SHAPE = (3328, 2560)
RF_SHAPE = (30, 1024, 1024)
XA_SHAPE = (30, 512, 512)
# registration_rest: the known motions and the landmark counts
PC_SHIFT_MM = (12.4, -20.8, 6.0)
PC_LIMIT_MM = 0.5
AUTO_POSE = (0.0, 0.0, 3.0, 32.0, -24.0, 0.0)   # deg about x, y, z; mm
LANDMARKS_N = 8
TPS_N = 30
ICP_MAX_POINTS = 100_000
ICP_MOTION = (2.0, 3.0)          # deg about an oblique axis, mm
ICP_O3D_ITERATIONS = 200
ELASTIX_RATIO_LIMIT = 0.5        # elastix: residual ratio in the body
ELASTIX_P95_LIMIT_MM = 1.0       # ... and the field's p95 error
ELASTIX_STAGES = [
    {"Transform": ["EulerTransform"], "Metric": ["AdvancedMeanSquares"],
     "NumberOfResolutions": ["3"], "MaximumNumberOfIterations": ["120"]},
    {"Transform": ["BSplineTransform"], "Metric": ["AdvancedMeanSquares"],
     "NumberOfResolutions": ["2"],
     "FinalGridSpacingInPhysicalUnits": ["20"],
     "MaximumNumberOfIterations": ["100"]}]
ROTATE_DEG = (0.0, 0.0, 10.0)
PROJECTION_DEG = (0.0, 0.0, 15.0)
# the card's published peaks (H100 SXM at 700 W): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations
# over the float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12            # float64 outside the tensor cores
SLEEP_CYCLES = 20_000_000        # cuda_ms's hold: ~10 ms at 1.98 GHz
LEAD_CYCLES = 2_000              # a profile window's short lead sleeps


_T0 = time.perf_counter()


def emit(phase, **fields):
    """One JSON line for ``phase``; ``t_s`` is the script's wall time at
    its end, so the lines show where the command time goes."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - _T0}), flush=True)


def max_abs(a, b):
    return float((a - b).abs().max())


def cuda_ms(fn, reps=10, warmup=2):
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events).
    A sleep kernel (about 10 ms) holds the stream while the host queues
    the launches, so a launch shorter than the host's time to queue it is
    timed on the device, not at the host's rate."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# the kernels' records in a profile, by the wrapper count they answer to
WARP_MODES = {"0": "warp_coords", "1": "warp_affine", "2": "warp_disp",
              "3": "warp_affine_shear"}
# the affine mode's two kernel entries (ops/warp.affine_path), and every
# warp kernel by the name its launches count under
AFFINE_KERNELS = ("warp_affine", "warp_affine_axis")
WARP_KERNELS = tuple(WARP_MODES.values()) + ("warp_affine_axis",)


def kernel_of(key):
    """The wrapper count a device event answers to, or None. A dose_hist
    call launches two kernels; only its main pass (dose_hist_count)
    answers, not its finish (dose_hist_finish). The affine mode's
    separable entry runs csrc/warp.cu axis_kernel."""
    if "dose_hist_count" in key:
        return "dose_hist"
    if "lane_interp_kernel" in key:
        return "lane_interp"
    if "axis_kernel" in key:
        return "warp_affine_axis"
    mode = re.search(r"(?:warp|affine)_kernel<\(\(anonymous namespace\)"
                     r"::Mode\)(\d)", key)
    return WARP_MODES[mode.group(1)] if mode else None


def profile_device(fn, expect=()):
    """Run ``fn()`` under torch.profiler. Returns its wall ms, the device
    events (kernels and copies) it issued, their summed device ms and
    share of the wall time, the port's kernel records among them per
    wrapper (``profiled``, with their names and ms) beside the launches
    the wrappers counted meanwhile (``wrapper_launches``), and the eight
    longest events. The caller holds the two counts equal and each
    kernel in ``expect`` launched (:func:`check_profile`): the card, not a
    plain path, ran the kernels, and the device figures miss none of
    them. Where they differ, ``events`` lists every event of the port's
    kernels, every device event and the runtime calls: name, device
    type, start (µs from the first event) and duration. The sleep
    kernels that open the window (``spin_kernel``) and the device-side
    copies of the port's spans (:func:`is_range`, counted in
    ``ranges_left_out``) are left out of every figure: the device
    figures are ``fn``'s work alone."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t_start = time.perf_counter()
    before = launch_counts()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        # a trace loses its first device records (PERF.md §7; after a
        # profile of 58,000 events, every record of the first 12 ms):
        # sleep kernels go first, three short ones, one of ~20 ms and 32
        # short ones, and none of them counts in the figures
        for _ in range(3):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda._sleep(2 * SLEEP_CYCLES)
        for _ in range(32):
            torch.cuda._sleep(LEAD_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    counted = {k: v - before[k] for k, v in launch_counts().items()}
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.key]
    events = [e for e in on_device if not is_range(e)]
    profiled = dict.fromkeys(counted, 0)
    names, kernel_ms = set(), dict.fromkeys(counted, 0.0)
    for e in events:
        k = kernel_of(e.key)
        if k is not None:
            profiled[k] += e.count
            kernel_ms[k] += e.self_device_time_total / 1e3
            names.add(e.key[:90])
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    out = dict(expect=list(expect), profiled_wall_ms=wall_ms,
               profile_s=time.perf_counter() - t_start,
               device_events=sum(e.count for e in events),
               ranges_left_out=sum(e.count for e in on_device
                                   if is_range(e)),
               device_ms=device_ms, device_share=device_ms / wall_ms,
               profiled=profiled, wrapper_launches=counted,
               kernel_ms=kernel_ms, kernels=sorted(names),
               top_ms=[[e.key[:90], e.self_device_time_total / 1e3]
                       for e in top])
    if profiled != counted:
        raw = prof.events()
        first = min((e.time_range.start for e in raw), default=0)
        out["events"] = [
            [e.name[:60], str(e.device_type).split(".")[-1],
             e.time_range.start - first,
             e.time_range.end - e.time_range.start]
            for e in raw if kernel_of(e.name) is not None
            or e.device_type == torch.autograd.DeviceType.CUDA
            or e.name.startswith(("cuda", "mia_torch::", "aten::copy_"))]
    return out


def is_range(event):
    """Whether a profiler event is a ``record_function`` range (the
    port's ``mia.*`` spans): the profiler copies each range onto the
    device's timeline, and such a copy is no device work."""
    return getattr(event, "is_user_annotation", False) \
        or event.key.startswith("mia.")


def launch_counts():
    """Every wrapper's launch count, by kernel."""
    from medicalimageanalysis_torch.ops import hist, lane_interp, warp

    return {**warp.LAUNCHES, **hist.LAUNCHES, **lane_interp.LAUNCHES}


def launch_shapes():
    """The warp wrappers' launches by (operator, B, gradients, output
    dims, volume dims) since the counts were last reset."""
    from medicalimageanalysis_torch.ops import warp

    return dict(warp.LAUNCH_SHAPES)


def shape_rows(shapes):
    """launch_shapes() as JSON rows [operator, B, grad, "ZxYxX" out,
    "ZxYxX" volume, count]."""
    return [[k, B, int(g), "x".join(map(str, shape)),
             "x".join(map(str, vin)), n]
            for (k, B, g, shape, vin), n in sorted(shapes.items())]


def launch_key(kernel, B, want_grad, shape, vin):
    """The timed_key a launch of ``kernel`` is weighed under: the affine
    kernels' by their volume dims too, so that a map from another grid
    onto the same output (the dose onto the CT, the CT onto itself) has
    its own row."""
    return timed_key(B, want_grad, shape,
                     vin if kernel in AFFINE_KERNELS else None)


def ms_lost(kernel, timed, shapes):
    """Sum over ``kernel``'s launches at a shape its phase timed of
    launches x (ms - bound ms), with the launches it covers and those at
    shapes the phase did not time (``timed``: launch_key -> row)."""
    lost, covered, untimed = 0.0, 0, 0
    for (k, B, grad, shape, vin), n in shapes.items():
        if k != kernel:
            continue
        row = timed.get(launch_key(k, B, grad, shape, vin))
        if row is None:
            untimed += n
            continue
        lost += n * (row["ms"] - row["bound_ms"])
        covered += n
    return dict(ms_lost=lost, launches_timed_shapes=covered,
                launches_untimed_shapes=untimed)


def check_profile(name, p):
    assert p["profiled"] == p["wrapper_launches"], \
        f"{name}: profiled kernel records {p['profiled']} != counted " \
        f"launches {p['wrapper_launches']}"
    missing = [k for k in p["expect"] if not p["wrapper_launches"][k]]
    assert not missing, f"{name}: no {missing} kernel among {p['top_ms']}"


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """The least time the card could take for a kernel's work: (ms,
    'bytes' or 'operations'); ``ops`` at ``ops_per_s`` (float32 unless
    named)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plain_program_rows(profiles, plan, mesh_work, analysis_work):
    """The JAX package's programs on the plan-QA and ROI mesh paths that
    run as plain PyTorch on the card (no hand kernel yet): device ms and
    device events under the profiler against the bound of their work.
    The full-size squared EDT: a bool mask read, float32 distances
    written, an add and a min per (voxel, line position) pair of each of
    the three passes. compute_gamma at 3 %/3 mm: both doses read, the map
    written, 30 operations per fine-grid sample of the resample and 5 per
    (offset, voxel) of the scan. The marching-tetrahedra table pass of
    the external's mask: the uint8 mask read, float32 points and int32
    faces written. taubin_smooth of its mesh (40 umbrella steps): float64
    points and int32 faces read, points written; per step 3 adds per
    directed edge and 12 float64 operations per point. The voxelization
    of the external's mesh (one voxelize_mesh_device call): float32
    vertices and int32 faces and sideband read, the uint8 mask written;
    40 float32 and integer operations per (triangle, window pixel) pair.
    One N4 level of the MR (shrink 4): res, total and w read, res and
    total written; the float32 operations of the B-spline contractions it
    ran (counted per call). texture_matrices of the PTV's crop: int32
    levels and the bool mask read once; per voxel 10 + 3 ceil(log2 Lmax)
    operations for each of the 13 directions and 7 for each of the 26
    neighbours, integer and boolean operations counted at the float32
    rate."""
    Z, Y, X = plan["edt_shape"]
    n = Z * Y * X
    w = plan["gamma_work"]
    mc, tb = mesh_work["mesh"], mesh_work["taubin"]
    work = {
        "edt": ("medicalimageanalysis_tpu/ops/edt.py:93",
                bound(5 * n, 2 * n * (X + Y + Z))),
        "compute_gamma": ("medicalimageanalysis_tpu/ops/gamma.py:93",
                          bound(4 * (2 * w["ref"] + w["eval"]),
                                5 * w["offsets"] * w["ref"]
                                + 30 * w["fine"])),
        "marching_tetrahedra": (
            "medicalimageanalysis_tpu/ops/marching_cubes.py:217",
            bound(mc["voxels"] + 12 * mc["points"] + 12 * mc["faces"], 0)),
        "taubin_smooth": (
            "medicalimageanalysis_tpu/utils/mesh/surface.py:75",
            bound(48 * tb["points"] + 12 * tb["faces"],
                  tb["steps"] * (6 * tb["edges"] + 12 * tb["points"]),
                  F64_OPS_PER_S))}
    vx = mesh_work["voxelize"]
    work["voxelize"] = ("medicalimageanalysis_tpu/ops/voxelize.py:496",
                        bound(12 * vx["points"] + 24 * vx["faces"]
                              + vx["voxels"], 40 * vx["pairs"]))
    n4w, tex = analysis_work["n4_level"], analysis_work["texture_matrices"]
    work["n4_level"] = ("medicalimageanalysis_tpu/ops/n4.py:203",
                        bound(20 * n4w["voxels"], n4w["ops"]))
    work["texture_matrices"] = (
        "medicalimageanalysis_tpu/ops/radiomics.py:141",
        bound(5 * tex["voxels"], tex["voxels"] * (
            13 * (10 + 3 * math.ceil(math.log2(tex["Lmax"]))) + 26 * 7)))
    rows = {}
    for name, (replaces, (b, by)) in work.items():
        p = profiles[name]
        rows[name] = dict(replaces=replaces, device_ms=p["device_ms"],
                          wall_ms=p["profiled_wall_ms"],
                          launches=p["device_events"], bound_ms=b,
                          bound_by=by, share_of_bound=b / p["device_ms"],
                          device_share=p["device_share"])
    rows["compute_gamma"]["search_offsets"] = w["offsets"]
    rows["marching_tetrahedra"].update(mc)
    rows["taubin_smooth"].update(tb)
    rows["voxelize"].update(vx)
    rows["n4_level"].update(n4w)
    rows["texture_matrices"].update(tex)
    return rows


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
def phase_device():
    from medicalimageanalysis_torch.device import set_numerics

    assert torch.cuda.is_available()
    set_numerics()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    smi = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())
    return smi


def phase_build():
    """The three CUDA sources, the C++ DICOM scanner and the C++ contour
    tracer, built at once (one compiler process each)."""
    from medicalimageanalysis_torch.native import get_trace_lib
    from medicalimageanalysis_torch.ops._build import (
        build_library, load_hist_library, load_lane_interp_library,
        load_warp_library)
    from medicalimageanalysis_torch.read.dicom import load_native_scanner

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = ("warp", "hist", "lane_interp")
    with ThreadPoolExecutor(max_workers=len(sources) + 2) as pool:
        builds = {name: pool.submit(timed, build_library, name)
                  for name in sources}
        scanner = pool.submit(timed, load_native_scanner)
        tracer = pool.submit(timed, get_trace_lib)
        built = {name: job.result() for name, job in builds.items()}
        lib, scanner_s = scanner.result()
        _, tracer_s = tracer.result()
    assert lib is not None, "DICOM scanner did not build"
    load_warp_library()
    load_hist_library()
    load_lane_interp_library()

    def regs(ptxas):
        return [ln.strip() for ln in ptxas.splitlines()
                if "registers" in ln or "spill" in ln]

    emit("build", seconds=time.perf_counter() - t0,
         scanner_seconds=scanner_s, tracer_seconds=tracer_s,
         **{f"{name}_seconds": sec for name, (_, sec) in built.items()},
         libraries=[os.path.relpath(path) for (path, _), _ in built.values()],
         **{f"ptxas_{name}": regs(ptxas)
            for name, ((_, ptxas), _) in built.items()})


def smooth_warp(gen, shape, dev, special=True):
    """A smooth random warp of the (Z, Y, X) grid with ~5 % of points
    pushed outside; with ``special`` also exact dim-1 edges, -0.0, NaN,
    +-inf and 1e30."""
    Z, Y, X = shape
    zz = torch.arange(Z, device=dev, dtype=torch.float32)[:, None, None]
    yy = torch.arange(Y, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(X, device=dev, dtype=torch.float32)[None, None, :]
    a = torch.rand(6, generator=gen, device=dev) * 6.28
    cz = zz + 1.5 * torch.sin(xx / 41 + a[0]) * torch.cos(yy / 53 + a[1])
    cy = yy + 3.0 * torch.sin(zz / 17 + a[2]) + 0.01 * xx
    cx = xx - 4.0 * torch.cos(yy / 29 + a[3]) + 0.02 * zz
    out = torch.rand(shape, generator=gen, device=dev) < 0.05
    cz[out] = cz[out] + Z * torch.sign(torch.randn(
        int(out.sum()), generator=gen, device=dev))
    if not special:
        return cz, cy, cx
    values = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                           -float("inf"), 1e30, -1e30], device=dev)
    n = values.numel()
    for c, hi in ((cz, Z - 1), (cy, Y - 1), (cx, X - 1)):
        flat = c.view(-1)
        pick = torch.randint(0, flat.numel(), (64,), generator=gen,
                             device=dev)
        flat[pick[:n]] = values
        flat[pick[n:n + 16]] = float(hi)            # exact far edge
        flat[pick[n + 16:n + 32]] = 0.0             # exact near edge
    return cz, cy, cx


def library_sample_ms(vol, cz, cy, cx, want_grad=False):
    """CUDA-event ms of the nearest PyTorch call to a warp mode on the
    same inputs: ``F.grid_sample`` (3-D, bilinear, align_corners=True) of
    the B volumes as channels at the normalised (x, y, z) grid, with the
    grid's gradient (backward) when the mode fuses the coordinate
    gradients. Its boundary differs: zeros padding blends samples up to
    one voxel outside the volume, where the kernel clamps its taps and
    sets ``background`` outside [0, dim-1]. The grid is built outside the
    timed call."""
    B, Z, Y, X = vol.shape
    grid = torch.stack([cx * (2.0 / (X - 1)) - 1.0,
                        cy * (2.0 / (Y - 1)) - 1.0,
                        cz * (2.0 / (Z - 1)) - 1.0], -1)[None]
    inp = vol[None]
    if not want_grad:
        ms = cuda_ms(lambda: F.grid_sample(inp, grid, mode="bilinear",
                                           padding_mode="zeros",
                                           align_corners=True))
    else:
        grid.requires_grad_(True)
        ones = torch.ones((1, B) + tuple(cz.shape), device=vol.device)

        def fwd_bwd():
            out = F.grid_sample(inp, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=True)
            return torch.autograd.grad(out, grid, ones)

        ms = cuda_ms(fwd_bwd)
    del grid
    torch.cuda.empty_cache()
    return ms


def warp_bound(n_in, n_out, B, n_coord_inputs, want_grad):
    """bound() of a warp call: B volumes of n_in voxels and
    ``n_coord_inputs`` float32 coordinate or displacement volumes of
    n_out voxels read once, B (4 B with gradients) outputs written
    once; 30 float32 operations per output sample (the 7 lerps of 3
    and the taps' weights), 30 more with gradients."""
    outs = B * (4 if want_grad else 1)
    nbytes = 4 * (B * n_in + n_coord_inputs * n_out + outs * n_out)
    return bound(nbytes, B * n_out * (60 if want_grad else 30))


def pyramid_shapes():
    """The (Z, Y, X) grids the registration samples on at strides 4, 2
    and 1 (models/rigid_intensity._downsample on SHAPE)."""
    return [tuple(max(n // s, 2) for n in SHAPE) for s in (4, 2, 1)]


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past an 8-byte
    boundary: the kernel must take its rows one float at a time."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 8 != 0
    return out


# where tiles and vectors are ragged (csrc/warp.cu: tiles of 64 x 8 output
# voxels in coords and disp, 2 a thread as float2 where Xo is even and the
# rows aligned, at most 4 volumes a launch): name -> (B, volume dims,
# output dims, misaligned coordinate or displacement rows). Each runs on a
# smooth field and on one with special values (NaN, +-inf, 1e30, exact
# edges)
WARP_EDGES = {"x131_y9_z6": (1, (6, 9, 131), (6, 9, 131), False),
              "z1_y7_x130": (2, (1, 7, 130), (1, 7, 130), False),
              "out_ne_vol": (1, (10, 20, 70), (6, 9, 131), False),
              "B5_split": (5, (5, 16, 132), (5, 16, 132), False),
              "misaligned": (4, (4, 10, 128), (4, 10, 128), True),
              "x4_y3_z3": (3, (3, 3, 4), (3, 3, 4), False)}


def edge_cases():
    """(name, B, volume dims, output dims, misaligned, field) of every
    ragged-edge check: each WARP_EDGES case on both fields."""
    return [(name, B, vshape, oshape, mis, field)
            for name, (B, vshape, oshape, mis) in WARP_EDGES.items()
            for field in ("smooth", "special")]


def timed_key(B, want_grad, shape, vin=None):
    """The key of a timed row: a launch's (B, gradients, output dims),
    and its volume dims ``vin`` where given (launch_key)."""
    key = (int(B), bool(want_grad), tuple(int(s) for s in shape))
    return key if vin is None else key + (tuple(int(s) for s in vin),)


def phase_warp_coords(gen, dev):
    """Kernel against plain version at every grid the main path gives the
    kernel: B=1 with and without gradients at each pyramid level, and a
    batch of two at full size; then the ragged edges (WARP_EDGES), each
    with and without gradients on a smooth and a special warp. Each timed
    row carries its bound (``timed``: for the launches by shape)."""
    from medicalimageanalysis_torch.ops.warp import warp_coords_plain

    op = torch.ops.mia_torch.warp_coords
    bg = -3001.0
    rows, timed = {}, {}

    def check(key, vol, cz, cy, cx, want):
        k = op(vol, cz, cy, cx, bg, want)
        p = warp_coords_plain(vol, cz, cy, cx, bg, want)
        torch.cuda.synchronize()
        errs = [max_abs(a, b) for a, b in zip(k, p)]
        assert all(torch.isfinite(t).all() for t in k)
        assert errs == [0.0] * len(errs), \
            f"warp_coords {key}: kernel != plain {errs}"
        return errs

    for shape in pyramid_shapes():
        cz, cy, cx = smooth_warp(gen, shape, dev)
        for B in ((1, 2) if shape == SHAPE else (1,)):
            vol = torch.randn((B,) + shape, generator=gen, device=dev) * 500
            for want in (False, True):
                key = "x".join(map(str, shape)) + f"_B{B}_grad{int(want)}"
                errs = check(key, vol, cz, cy, cx, want)
                ms = cuda_ms(lambda: op(vol, cz, cy, cx, bg, want))
                plain_ms = cuda_ms(
                    lambda: warp_coords_plain(vol, cz, cy, cx, bg, want),
                    reps=3, warmup=1)
                rows[key] = dict(max_abs_err=errs, ms=ms, plain_ms=plain_ms)
                rows[key]["bound_ms"], rows[key]["bound_by"] = warp_bound(
                    vol[0].numel(), cz.numel(), B, 3, want)
                timed[timed_key(B, want, shape)] = rows[key]
                if shape == SHAPE and B == 1 and want:
                    rows[key]["library_ms"] = library_sample_ms(
                        vol, cz, cy, cx, want_grad=True)
            del vol
        del cz, cy, cx
    for name, B, vshape, oshape, mis, field in edge_cases():
        vol = torch.randn((B,) + vshape, generator=gen, device=dev) * 500
        cz, cy, cx = smooth_warp(gen, oshape, dev, special=field == "special")
        if mis:
            cz, cy, cx = (misaligned(c) for c in (cz, cy, cx))
        for want in (False, True):
            key = f"edge_{name}_{field}_grad{int(want)}"
            rows[key] = dict(B=B, vol=list(vshape), out=list(oshape),
                             max_abs_err=check(key, vol, cz, cy, cx, want))
        del vol, cz, cy, cx
    emit("warp_coords", tolerance=0.0, **rows)
    torch.cuda.empty_cache()
    # the registration's finest-level call
    main = rows["x".join(map(str, SHAPE)) + "_B1_grad1"]
    return dict(max_abs_err=max(max(r["max_abs_err"]) for r in rows.values()),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], timed=timed)


def dose_grid():
    """The RTDOSE grid dose_plan() writes over the reference CT: (Z, Y, X)
    dims, [sx, sy, sz] spacing, origin (the CT's)."""
    extent = [SPACING[i] * (SHAPE[2 - i] - 1) for i in range(3)]
    n = [int(np.ceil(e / DOSE_SPACING_MM)) + 1 for e in extent]  # x, y, z
    return (n[2], n[1], n[0]), [DOSE_SPACING_MM] * 3, \
        np.asarray(REF_ORIGIN, np.float64)


def gamma_fine_map(dta_mm, shift_mm=(GAMMA_SHIFT_MM, 0.0, 0.0)):
    """Dose.compute_gamma's one resample onto its fine search grid, for an
    evaluated dose ``shift_mm`` (x, y, z) from the reference on the dose
    grid: (float32 output -> input pixel map, fine grid dims)."""
    from medicalimageanalysis_torch.ops.gamma import (
        fine_grid_layout, fine_grid_shape, fine_to_ref_pixel_matrix)
    from medicalimageanalysis_torch.ops.resample import compose_pixel_matrix

    shape, spacing, origin = dose_grid()
    s, r = fine_grid_layout(spacing, dta_mm)[:2]
    A = compose_pixel_matrix(np.eye(3), spacing, origin + np.asarray(shift_mm),
                             np.eye(3), spacing, origin).astype(np.float64) \
        @ fine_to_ref_pixel_matrix(s, r)
    return A.astype(np.float32), fine_grid_shape(shape, s, r)


def affine_cases():
    """Output-pixel -> input-pixel maps (x, y, z order), name -> (input
    dims, map, output dims). On SHAPE three rotated maps (the general
    path); then the axis-aligned maps the paths run (the separable path):
    gamma's fine grids at 3 %/3 mm and 2 %/2 mm from the dose grid, the
    CT onto the dose grid (resample_to) and the dose onto the CT (the DVH
    masks' grid), and a flip in x and z."""
    from medicalimageanalysis_torch.ops.resample import compose_pixel_matrix

    Z, Y, X = SHAPE
    c = np.array([(X - 1) / 2, (Y - 1) / 2, (Z - 1) / 2])

    def about_center(R, t=(0.0, 0.0, 0.0)):
        A = np.eye(4)
        A[:3, :3] = R
        A[:3, 3] = c + np.asarray(t) - R @ c
        return A.astype(np.float32)

    def rz(deg):
        th = np.deg2rad(deg)
        return np.array([[np.cos(th), -np.sin(th), 0],
                         [np.sin(th), np.cos(th), 0], [0, 0, 1]])

    out = {name: (SHAPE, A, SHAPE) for name, A in (
        ("near_identity", about_center(rz(0.7), (0.31, -0.47, 0.23))),
        ("relabel_90", about_center(rz(90.0))),
        ("oblique_45", about_center(rz(45.0), (0.5, 0.25, 0.0))))}
    dose_shape, dose_sp, origin = dose_grid()
    for name, dta in (("gamma_3mm", 3.0), ("gamma_2mm", 2.0)):
        A, fine = gamma_fine_map(dta)
        out[name] = (dose_shape, A, fine)
    out["ct_to_dose"] = (SHAPE, compose_pixel_matrix(
        np.eye(3), SPACING, origin, np.eye(3), dose_sp, origin), dose_shape)
    out["dose_to_ct"] = (dose_shape, compose_pixel_matrix(
        np.eye(3), dose_sp, origin, np.eye(3), SPACING, origin), SHAPE)
    flip = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32)
    flip[0, 3], flip[2, 3] = X - 1, Z - 1
    out["flip_xz"] = (SHAPE, flip, SHAPE)
    return out


# the axis entry's two branches forced: every tile gathers its taps, or
# every tile whose input rows fit stages them (mia_warp_affine_axis_ratio)
AXIS_BRANCHES = {"gather": 0.0, "stage": 1e30}


def affine_entry(vol, coef, out_shape, bg, entry, misalign=False):
    """One call of a kernel entry of the affine mode on vol (B <= 4,
    Z, Y, X), outside the wrapper (no launch counted): "general"
    (mia_warp_affine), "axis" (mia_warp_affine_axis) or an AXIS_BRANCHES
    name. Returns (CUDA error, output); with ``misalign`` the output
    starts 4 bytes past an 8-byte boundary."""
    from medicalimageanalysis_torch.ops._build import load_warp_library

    lib = load_warp_library()
    B, Z, Y, X = vol.shape
    n = B * math.prod(out_shape)
    buf = torch.empty(n + 1, dtype=torch.float32, device=vol.device)
    out = (buf[1:] if misalign else buf[:n]).view((B,) + tuple(out_shape))
    args = (vol.data_ptr(), B, Z, Y, X, (ctypes.c_float * 12)(*coef),
            *out_shape, bg, out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if entry in AXIS_BRANCHES:
        err = lib.mia_warp_affine_axis_ratio(*args, AXIS_BRANCHES[entry],
                                             stream)
    elif entry == "axis":
        err = lib.mia_warp_affine_axis(*args, stream)
    else:
        err = lib.mia_warp_affine(*args, stream)
    return err, out


def affine_edges():
    """Where the affine tiles and paths are ragged or the map special:
    name -> (volume dims, 12 coefficients, output dims, misaligned volume
    and output). Output x tiles of 32, y tiles of 8 and the separable
    path's z tiles of 16 cut at Xo 1, 69 and 509, odd Yo, Zo 1 and 21;
    signed-zero and 1e-30 off-diagonals; NaN, +-inf and 1e30 diagonals
    and translations; maps landing exactly on faces 0 and dim - 1."""
    def diag(scale, shift, off=()):
        A = np.zeros((3, 4), np.float32)
        A[[0, 1, 2], [0, 1, 2]] = scale
        A[:, 3] = shift
        coef = [float(v) for v in A.reshape(-1)]
        for k, v in off:
            coef[k] = v
        return coef

    nan, inf = float("nan"), float("inf")
    up = (0.34, 0.34, 0.3)
    return {
        "xo1": ((7, 9, 40), diag(up, (3.2, 0.3, 0.1)), (21, 25, 1), False),
        "xo69": ((7, 9, 40), diag(up, (0.1, 0.2, 0.3)), (21, 25, 69), False),
        "xo509": ((7, 9, 180), diag(up, (0.1, 0.2, 0.3)), (19, 23, 509),
                  False),
        "zo1_y17": ((4, 20, 30), diag((0.5, 0.5, 1.0), (0.1, 0.2, 1.5)),
                    (1, 17, 57), False),
        "down_ragged": ((40, 90, 100), diag((3.125, 3.125, 1.25),
                                            (0.5, 0.25, 0.0)),
                        (31, 27, 33), False),
        "misaligned": ((7, 9, 40), diag(up, (0.1, 0.2, 0.3)), (21, 25, 69),
                       True),
        "signed_zero": ((7, 9, 40), diag(up, (0.1, 0.2, 0.3),
                                         ((1, -0.0), (4, -0.0), (9, -0.0))),
                        (21, 25, 69), False),
        "off_1e-30": ((7, 9, 40), diag(up, (0.1, 0.2, 0.3), ((4, 1e-30),)),
                      (21, 25, 69), False),
        "off_nan": ((7, 9, 40), diag(up, (0.1, 0.2, 0.3), ((8, nan),)),
                    (21, 25, 69), False),
        "nan_shift": ((7, 9, 40), diag(up, (nan, 0.2, 0.3)), (21, 25, 69),
                      False),
        "inf_shift": ((7, 9, 40), diag(up, (0.1, inf, -inf)), (21, 25, 69),
                      False),
        "huge": ((7, 9, 40), diag((1e30, 0.34, 0.3), (0.1, 0.2, 1e30)),
                 (21, 25, 69), False),
        "nan_inf_diag": ((7, 9, 40), diag((0.34, nan, inf), (0.1, 0.2, 0.3)),
                         (21, 25, 69), False),
        "faces": ((5, 9, 33), diag((0.5, 0.5, 0.25), (0.0, 0.0, 0.0)),
                  (17, 17, 65), False),
        "faces_flip": ((5, 9, 33), diag((-0.5, -0.5, -0.25), (32.0, 8.0, 4.0)),
                       (17, 17, 65), False)}


def affine_bound(vol, coef, shape):
    """warp_bound of one ``affine`` launch on vol (B, Z, Y, X) at the 12
    coefficients onto ``shape``. Where the map has fewer outputs than
    volume voxels (a downsampling: the CT onto the dose grid), what it
    must read is the volume voxels that the taps of its samples inside
    the volume touch (mesh_taps), not the whole volume. Returns (ms,
    'bytes' or 'operations', those voxels or None)."""
    from medicalimageanalysis_torch.ops.warp import affine_coords

    B, Z, Y, X = vol.shape
    n_out = math.prod(shape)
    if n_out >= Z * Y * X:
        return (*warp_bound(Z * Y * X, n_out, B, 0, False), None)
    A = torch.tensor(coef, dtype=torch.float32, device=vol.device)
    cz, cy, cx = affine_coords(A.reshape(3, 4), shape)
    inside = (cz >= 0) & (cz <= Z - 1) & (cy >= 0) & (cy <= Y - 1) \
        & (cx >= 0) & (cx <= X - 1)
    taps = mesh_taps(vol, cz[inside], cy[inside], cx[inside])
    del cz, cy, cx, inside
    return (*bound(4 * B * (taps + n_out), 30 * B * n_out), taps)


def phase_warp_affine(gen, dev):
    """Kernel against plain version at each affine_cases map, through the
    operator (the wrapper's entry); at an axis-aligned map also each
    branch of the separable entry forced, and the general entry. Then the
    ragged edges and special maps (affine_edges) through every entry that
    takes them, each bit-equal; the separable entry refuses a map with a
    non-zero off-diagonal. Each case's row: the kernel it took
    (ops/warp.affine_path), ms (and each branch's), plain ms, bound
    (affine_bound) and F.grid_sample at the same samples. Returns a row
    for each of the two kernels, warp_affine (at the near-identity map)
    and warp_affine_axis (at gamma's 3 %/3 mm fine grid), each with its
    ``timed`` rows: the general kernel's launches at SHAPE from SHAPE
    weighed by the near-identity map's time, the separable kernel's by
    its maps at their shapes, until a path's own row takes their key."""
    from medicalimageanalysis_torch.ops.warp import (affine_coords,
                                                     affine_path,
                                                     warp_affine_plain)

    op = torch.ops.mia_torch.warp_affine
    bg = -3001.0
    rows = {}
    timed = {k: {} for k in AFFINE_KERNELS}

    def held(what, got, want):
        err = max_abs(got, want)
        assert torch.equal(got, want), f"warp_affine {what}: kernel != " \
            f"plain ({err})"
        return err

    for name, (shape_in, A, shape) in affine_cases().items():
        vol = torch.randn((1,) + tuple(shape_in), generator=gen,
                          device=dev) * 500
        coef = [float(v) for v in np.float32(A[:3]).reshape(-1)]
        kernel = affine_path(coef)
        p = warp_affine_plain(vol, coef, shape, bg)
        k = op(vol, coef, list(shape), bg)
        torch.cuda.synchronize()
        row = dict(path=kernel, shape_in=list(shape_in), shape=list(shape),
                   max_abs_err=held(name, k, p),
                   background_share=float((k == bg).float().mean()),
                   ms=cuda_ms(lambda: op(vol, coef, list(shape), bg)),
                   plain_ms=cuda_ms(lambda: warp_affine_plain(
                       vol, coef, shape, bg), reps=3, warmup=1))
        del k
        if kernel == "warp_affine_axis":
            for entry in ("general",) + tuple(AXIS_BRANCHES):
                err, k = affine_entry(vol, coef, shape, bg, entry)
                assert err == 0, f"affine {entry} {name}: CUDA error {err}"
                torch.cuda.synchronize()
                held(f"{name} ({entry})", k, p)
                row[f"{entry}_ms"] = cuda_ms(
                    lambda: affine_entry(vol, coef, shape, bg, entry))
                del k
        del p
        cz, cy, cx = affine_coords(torch.as_tensor(A, device=dev), shape)
        row["library_ms"] = library_sample_ms(vol, cz, cy, cx)
        del cz, cy, cx
        row["bound_ms"], row["bound_by"], taps = affine_bound(vol, coef,
                                                              shape)
        if taps is not None:
            row["taps"] = taps
        rows[name] = row
        del vol
        torch.cuda.empty_cache()
        if kernel == "warp_affine_axis" or name == "near_identity":
            timed[kernel][timed_key(1, False, shape, shape_in)] = row
    for name, (vshape, coef, shape, mis) in affine_edges().items():
        vol = torch.randn((2,) + vshape, generator=gen, device=dev) * 500
        if mis:
            vol = misaligned(vol)
        kernel = affine_path(coef)
        p = warp_affine_plain(vol, coef, shape, bg)
        row = dict(path=kernel, vol=list(vshape), out=list(shape),
                   max_abs_err=held(f"edge {name}",
                                    op(vol, coef, list(shape), bg), p))
        entries = ("general",) + (("axis",) + tuple(AXIS_BRANCHES)
                                  if kernel == "warp_affine_axis" else ())
        for entry in entries:
            err, k = affine_entry(vol, coef, shape, bg, entry, misalign=mis)
            assert err == 0, f"affine {entry} edge {name}: CUDA error {err}"
            torch.cuda.synchronize()
            held(f"edge {name} ({entry})", k, p)
        if kernel == "warp_affine":    # the separable entry refuses the map
            err, _ = affine_entry(vol, coef, shape, bg, "axis")
            assert err != 0, f"the axis entry took edge {name}"
            row["axis_entry_refused"] = err
        row["entries"] = list(entries)
        rows[f"edge_{name}"] = row
        del vol, p
    emit("warp_affine", tolerance=0.0, **rows)
    torch.cuda.empty_cache()
    out = {}
    for kernel, main in (("warp_affine", rows["near_identity"]),
                         ("warp_affine_axis", rows["gamma_3mm"])):
        out[kernel] = dict(
            max_abs_err=max(r["max_abs_err"] for r in rows.values()
                            if kernel == "warp_affine"
                            or r["path"] == kernel),
            ms=main["ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], timed=timed[kernel])
    return out


def smooth_disp(gen, shape, dev, special=False):
    """A smooth planar (3, Z, Y, X) voxel field, rows (x, y, z), with ~5 %
    of samples pushed outside; with ``special`` also NaN, +-inf, +-1e30,
    -0.0 and displacements landing exactly on the near and far edges."""
    Z, Y, X = shape
    zz = torch.arange(Z, device=dev, dtype=torch.float32)[:, None, None]
    yy = torch.arange(Y, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(X, device=dev, dtype=torch.float32)[None, None, :]
    a = torch.rand(4, generator=gen, device=dev) * 6.28
    disp = torch.stack(torch.broadcast_tensors(
        -4.0 * torch.cos(yy / 29 + a[0]) + 0.02 * zz,
        3.0 * torch.sin(zz / 17 + a[1]) + 0.01 * xx,
        1.5 * torch.sin(xx / 41 + a[2]) * torch.cos(yy / 53 + a[3]))) \
        .contiguous()
    out = torch.rand(shape, generator=gen, device=dev) < 0.05
    disp[2][out] += Z * torch.sign(torch.randn(int(out.sum()), generator=gen,
                                               device=dev))
    if special:
        values = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                               -float("inf"), 1e30, -1e30], device=dev)
        n = values.numel()
        for row, (base, hi) in enumerate(((xx, X - 1), (yy, Y - 1),
                                          (zz, Z - 1))):
            flat = disp[row].view(-1)
            at = base.expand(shape).reshape(-1)
            pick = torch.randint(0, flat.numel(), (64,), generator=gen,
                                 device=dev)
            flat[pick[:n]] = values
            far, near = pick[n:n + 16], pick[n + 16:n + 32]
            flat[far] = hi - at[far]                  # lands on dim-1
            flat[near] = -at[near]                    # lands on 0
    return disp


def phase_warp_disp(gen, dev):
    """Kernel against plain version at the three pyramid grids, at every
    batch the deformable path gives the kernel: B=1 with gradients (the
    B-spline sampler), B=3 without (DVF inversion and composition warp a
    field), B=4 without (the fast-demons stack), each on a smooth field
    and on one mixing in NaN, +-inf, +-1e30 and exact-edge displacements;
    then the ragged edges (WARP_EDGES), each with and without gradients
    on a smooth and a special field. Times are taken on the smooth
    fields; each timed row carries its bound (``timed``)."""
    from medicalimageanalysis_torch.ops.warp import warp_disp_plain

    op = torch.ops.mia_torch.warp_disp
    bg = 0.0
    rows, timed = {}, {}

    def check(key, vol, disp, want):
        k = op(vol, disp, bg, want)
        p = warp_disp_plain(vol, disp, bg, want)
        torch.cuda.synchronize()
        errs = [max_abs(a, b) for a, b in zip(k, p)]
        assert all(torch.isfinite(t).all() for t in k)
        assert errs == [0.0] * len(errs), \
            f"warp_disp {key}: kernel != plain {errs}"
        return errs

    for shape in pyramid_shapes():
        for field in ("smooth", "special"):
            disp = smooth_disp(gen, shape, dev, special=field == "special")
            for B, want in ((1, True), (3, False), (4, False)):
                vol = smooth_disp(gen, shape, dev) if B == 3 else \
                    torch.randn((B,) + shape, generator=gen, device=dev) * 500
                key = "x".join(map(str, shape)) \
                    + f"_B{B}_grad{int(want)}_{field}"
                row = dict(max_abs_err=check(key, vol, disp, want))
                if field == "smooth":
                    row["ms"] = cuda_ms(lambda: op(vol, disp, bg, want))
                    row["plain_ms"] = cuda_ms(
                        lambda: warp_disp_plain(vol, disp, bg, want),
                        reps=3, warmup=1)
                    row["bound_ms"], row["bound_by"] = warp_bound(
                        vol[0].numel(), disp[0].numel(), B, 3, want)
                    timed[timed_key(B, want, shape)] = row
                if field == "smooth" and shape == SHAPE and B == 4:
                    zz, yy, xx = (torch.arange(n, device=dev,
                                               dtype=torch.float32)
                                  for n in shape)
                    row["library_ms"] = library_sample_ms(
                        vol, zz[:, None, None] + disp[2],
                        yy[None, :, None] + disp[1],
                        xx[None, None, :] + disp[0])
                rows[key] = row
                del vol
            del disp
    for name, B, vshape, oshape, mis, field in edge_cases():
        vol = torch.randn((B,) + vshape, generator=gen, device=dev) * 500
        disp = smooth_disp(gen, oshape, dev, special=field == "special")
        if mis:
            disp = misaligned(disp)
        for want in (False, True):
            key = f"edge_{name}_{field}_grad{int(want)}"
            rows[key] = dict(B=B, vol=list(vshape), out=list(oshape),
                             max_abs_err=check(key, vol, disp, want))
        del vol, disp
    emit("warp_disp", tolerance=0.0, **rows)
    torch.cuda.empty_cache()
    # the fast-demons iteration's call at full size
    main = rows["x".join(map(str, SHAPE)) + "_B4_grad0_smooth"]
    return dict(max_abs_err=max(max(r["max_abs_err"]) for r in rows.values()),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], timed=timed)


def hist_case(gen, n, thresholds, dev, valid_all=False):
    """Doses uniform on [0, 70) Gy with ~1 % special values (NaN, +-inf,
    -0.0, 1e-40 and doses exactly on a threshold); ``valid`` drawn from
    {0, 1, 0.5, -1, NaN}, or all 1."""
    dose = torch.rand(n, generator=gen, device=dev) * 70.0
    k = max(1, n // 100)
    pick = torch.randint(0, n, (k,), generator=gen, device=dev)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"),
                            -0.0, 1e-40], device=dev)
    finite = thresholds[torch.isfinite(thresholds)]
    pool = torch.cat([special, finite])
    dose[pick] = pool[torch.randint(0, pool.numel(), (k,), generator=gen,
                                    device=dev)]
    if valid_all:
        valid = torch.ones(n, device=dev)
    else:
        values = torch.tensor([0.0, 1.0, 0.5, -1.0, float("nan")],
                              device=dev)
        valid = values[torch.randint(0, 5, (n,), generator=gen, device=dev)]
    return dose, valid


def hist_bound(n, n_bins):
    """bound() of the function at N voxels and n_bins thresholds, not of
    any design: the bytes (dose and valid read once, thresholds read,
    counts written) against ceil(log2(n_bins + 1)) compares a voxel, a
    binary search of the sorted thresholds."""
    return bound(4 * (2 * n + n_bins) + 8 * n_bins,
                 n * math.ceil(math.log2(n_bins + 1)))


def hist_cases(gen, dev):
    """The histogram's checked cases, as (key, dose, valid, thresholds),
    made one at a time: N in {1, 2047, 2049, 13 M} with 300 sorted
    thresholds and with 23 unsorted, repeated ones (NaN, +-inf, -0.0
    among them), one case of 1100 thresholds, one whose top bins hold
    more than 2^24 voxels, 13 M doses all inside one threshold interval
    (peaked), 20,000 unsorted thresholds (above the shared-memory
    histogram's limit), thresholds in pairs of -0.0 and 0.0 against many
    signed zero doses, and the dvh_batch shape (33,554,432 voxels, 32
    bins, a 0/1 mask as valid)."""
    sorted_thr = torch.linspace(0.0, 66.0, DVH_BINS, device=dev)
    base = torch.tensor([0.0, 5.0, 5.0, 60.0, -0.0, float("nan"),
                         float("inf"), -float("inf"), 30.0, 1e-40, 65.0,
                         12.5], device=dev)
    mixed = torch.cat([base, sorted_thr[torch.randperm(
        DVH_BINS, generator=gen, device=dev)[:11]]])
    mixed = mixed[torch.randperm(23, generator=gen, device=dev)]
    cases = [(f"n{n}_{name}", n, thr, False)
             for n in (1, 2047, 2049, 13_000_000)
             for name, thr in (("300sorted", sorted_thr),
                               ("23unsorted", mixed))]

    def shuffled(lo, hi, k):
        t = torch.cat([torch.linspace(lo, hi, k - 8, device=dev), base[:8]])
        return t[torch.randperm(k, generator=gen, device=dev)]

    zeros = torch.tensor([-0.0, 0.0, 0.0, -0.0, 5.0, -5.0, 1e-40, -1e-40,
                          float("nan"), 60.0], device=dev)
    dvh_batch_thr = torch.arange(32, dtype=torch.float32, device=dev) * 5.0
    cases += [("n1000003_1100unsorted", 1_000_003, shuffled(-1.0, 71.0, 1100),
               False),
              ("n20000000_300sorted_allvalid", 20_000_000, sorted_thr, True),
              ("n13000000_300sorted_peaked", 13_000_000, sorted_thr, True),
              ("n1000000_20000unsorted", 1_000_000,
               shuffled(-1.0, 71.0, 20_000), False),
              ("n1000000_signed_zeros", 1_000_000, zeros, False),
              ("n33554432_32_mask", 33_554_432, dvh_batch_thr, False)]
    for key, n, thr, valid_all in cases:
        dose, valid = hist_case(gen, n, thr, dev, valid_all)
        if key.endswith("peaked"):       # every dose in (s_271, s_272)
            lo, hi = float(thr[271]), float(thr[272])
            dose = lo + (hi - lo) * (0.05 + 0.9 * torch.rand(
                n, generator=gen, device=dev))
            assert bool(((dose > lo) & (dose < hi)).all())
        elif key.endswith("signed_zeros"):
            dose[::7] = 0.0
            dose[::11] = -0.0
        elif key.endswith("mask"):       # dvh_batch: a 0/1 ROI mask
            valid = (torch.rand(n, generator=gen, device=dev) < 0.3).float()
        yield key, dose, valid, thr


def phase_hist(gen, dev):
    """Kernel against plain twin, bit-equal on the counts, at every
    :func:`hist_cases` case; kernel and plain ms, the bound and its share
    for each. For information, the composite torch.bucketize + bincount
    + cumsum at 13 M x 300 bins (``composite_ms``; no single PyTorch call
    computes the function)."""
    from medicalimageanalysis_torch.ops.hist import _hist_plain

    op = torch.ops.mia_torch.dose_hist
    rows = {}
    for key, dose, valid, thr in hist_cases(gen, dev):
        k = op(dose, valid, thr)
        p = _hist_plain(dose, valid, thr)
        torch.cuda.synchronize()
        err = int((k - p).abs().max())
        assert err == 0, f"dose_hist {key}: kernel != plain ({err})"
        row = dict(max_abs_err=err, max_count=int(k.max()),
                   ms=cuda_ms(lambda: op(dose, valid, thr)),
                   plain_ms=cuda_ms(lambda: _hist_plain(dose, valid, thr),
                                    reps=3, warmup=1))
        row["bound_ms"], row["bound_by"] = hist_bound(dose.numel(),
                                                      thr.numel())
        row["bound_share"] = row["bound_ms"] / row["ms"]
        if key == "n13000000_300sorted":
            def composite():
                srt = torch.sort(thr).values
                at = torch.bucketize(dose, srt, right=True)
                at = torch.where(valid > 0, at, thr.numel())
                return torch.bincount(at, minlength=thr.numel() + 1)[
                    :thr.numel()].cumsum(0)
            row["composite_ms"] = cuda_ms(composite)
        rows[key] = row
        del dose, valid, k, p
    big = rows["n20000000_300sorted_allvalid"]["max_count"]
    assert big > 2 ** 24, f"no bin above 2^24 voxels ({big})"
    emit("hist", tolerance=0, bins_above_2pow24=True, **rows)
    torch.cuda.empty_cache()
    main = rows["n13000000_300sorted"]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None)


@contextlib.contextmanager
def recording_hist_calls(calls):
    """Keep every (dose, valid, thresholds) the port hands the dose_hist
    operator inside the block, by (N, n_bins), in ``calls``: the path's
    own tensors, to check and time the kernel on after it."""
    from medicalimageanalysis_torch.ops import hist

    run = hist._dose_hist_op

    def op(dose, valid, thresholds):
        calls.setdefault((dose.numel(), thresholds.numel()), []).append(
            (dose, valid, thresholds))
        return run(dose, valid, thresholds)

    hist._dose_hist_op = op
    try:
        yield calls
    finally:
        hist._dose_hist_op = run


def hist_path_lost(calls, shapes, phase="hist_path"):
    """The kernel at every (N, n_bins) a path launched (the dose-QA path,
    or the ``phase`` named), on the tensors it launched with (``calls``;
    ``shapes``: launches by shape): each call held bit-equal to the plain
    twin again, the first at each shape timed. Per shape: launches,
    max_abs_err, ms, bound ms; ms lost, sum of launches x (ms - bound
    ms)."""
    from medicalimageanalysis_torch.ops.hist import _hist_plain

    op = torch.ops.mia_torch.dose_hist
    assert {k: len(v) for k, v in calls.items()} == dict(shapes), \
        (sorted((k, len(v)) for k, v in calls.items()), sorted(shapes.items()))
    rows, lost, worst = [], 0.0, 0
    for (n, n_bins), count in sorted(shapes.items()):
        err = 0
        for dose, valid, thr in calls[(n, n_bins)]:
            k = op(dose, valid, thr)
            p = _hist_plain(dose, valid, thr)
            torch.cuda.synchronize()
            err = max(err, int((k - p).abs().max()))
            del k, p
        assert err == 0, f"dose_hist at the path's {n} x {n_bins}: " \
            f"kernel != plain ({err})"
        dose, valid, thr = calls[(n, n_bins)][0]
        row = dict(n=n, n_bins=n_bins, launches=count, max_abs_err=err,
                   ms=cuda_ms(lambda: op(dose, valid, thr)))
        row["bound_ms"], _ = hist_bound(n, n_bins)
        lost += count * (row["ms"] - row["bound_ms"])
        worst = max(worst, err)
        rows.append(row)
    out = dict(ms_lost=lost, launches_timed_shapes=sum(shapes.values()),
               launches_untimed_shapes=0)
    emit(phase, shapes=rows, **out)
    return dict(out, path_max_abs_err=worst)


def lane_case(gen, R, Xs, Xd, dev, special=False):
    """data (R, Xs) of 500 HU scale and shear-like positions (R, Xd): a
    slope Xs/Xd and a per-row offset within 5 % of the width, so some
    positions fall beyond either edge; with ``special`` also exactly
    -0.5 and Xs - 0.5, their near insides, the tap edges, NaN and +-inf
    (in place of up to a third of the positions)."""
    data = torch.randn((R, Xs), generator=gen, device=dev) * 500
    off = (torch.rand((R, 1), generator=gen, device=dev) * 2 - 1) \
        * (0.05 * Xs + 1)
    pos = torch.arange(Xd, device=dev, dtype=torch.float32)[None, :] \
        * (Xs / Xd) + off
    if special:
        values = torch.tensor([-0.5, Xs - 0.5, -0.4999, Xs - 0.5001, 0.0,
                               Xs - 1.0, max(Xs - 2.0, 0.0), float("nan"),
                               float("inf"), -float("inf"), -2.0, Xs + 2.0],
                              device=dev)
        flat = pos.view(-1)
        k = min(flat.numel() // 3 + 1, 3 * values.numel())
        pick = torch.randperm(flat.numel(), generator=gen, device=dev)[:k]
        flat[pick] = values[torch.arange(k, device=dev) % values.numel()]
    return data, pos.contiguous()


def lane_bound(R, Xs, Xd):
    """bound() of lane_interp at R rows of Xs source and Xd destination
    floats: data and pos read once, out written once; 6 operations an
    output."""
    return bound(4 * (R * Xs + 2 * R * Xd), 6 * R * Xd)


def library_lane_ms(data, pos):
    """CUDA-event ms of the nearest PyTorch call to lane_interp on the
    same inputs: 2-D ``F.grid_sample`` (bilinear, align_corners=True) of
    the (1, 1, R, Xs) image at x = pos and y = the row index, normalised
    (row-exact up to float32 rounding of the normalisation). Its edge
    differs: zeros padding blends up to one pixel beyond the row, where
    the kernel extrapolates half a pixel and returns 0 beyond. The grid
    is built outside the timed call."""
    R, Xs = data.shape
    ys = torch.arange(R, device=data.device, dtype=torch.float32) \
        * (2.0 / max(R - 1, 1)) - 1.0
    grid = torch.stack([pos * (2.0 / max(Xs - 1, 1)) - 1.0,
                        ys[:, None].expand_as(pos)], -1)[None]
    inp = data[None, None]
    ms = cuda_ms(lambda: F.grid_sample(inp, grid, mode="bilinear",
                                       padding_mode="zeros",
                                       align_corners=True))
    del grid
    torch.cuda.empty_cache()
    return ms


def phase_lane_interp(gen, dev, passes):
    """Kernel against plain twin, bit-equal: the shear lane's passes at
    the shapes the view path gave the kernel (``passes``: name -> (rows
    R, source width Xs, destination width Xd), recorded by phase_view),
    each also with special positions, and the edge cases of
    tests/test_torch_lane_interp.py (odd R, Xd != Xs, Xs of 1 and 2,
    R = 1). Kernel and plain ms, the byte bound and its share, and the
    2-D grid_sample for the passes."""
    from medicalimageanalysis_torch.ops.lane_interp import lane_interp_plain

    op = torch.ops.mia_torch.lane_interp
    cases = [(name, R, Xs, Xd, special)
             for name, (R, Xs, Xd) in passes.items()
             for special in (False, True)]
    cases += [("odd_R", 37, 64, 64, True), ("wider", 37, 64, 70, True),
              ("narrower", 9, 40, 23, True), ("Xs1", 2, 1, 8, True),
              ("Xs2", 5, 2, 7, True), ("R1_Xs2", 1, 2, 5, True),
              # rows of 571 and 538 floats: a scalar head and tail around
              # each row's 16-byte body, with the data rows staged in
              # shared memory (Xs 256-1536) or read through L1; pos 4
              # bytes off out's alignment (every output one float at a
              # time); data rows 4 bytes off (a staged copy's own head)
              ("head_tail_571", 33, 512, 571, True),
              ("head_tail_538", 35, 130, 538, True),
              ("wide_rows", 5, 2000, 1999, True),
              ("misaligned_pos", 33, 512, 571, True),
              ("misaligned_data", 37, 300, 70, True)]
    rows = {}
    for name, R, Xs, Xd, special in cases:
        data, pos = lane_case(gen, R, Xs, Xd, dev, special)
        if name == "misaligned_pos":
            pos = misaligned(pos)
        elif name == "misaligned_data":
            data = misaligned(data)
        k = op(data, pos)
        p = lane_interp_plain(data, pos)
        torch.cuda.synchronize()
        err = max_abs(k, p)
        key = f"{name}_special" if special and name in passes else name
        assert bool(torch.isfinite(k).all()), key
        assert err == 0.0, f"lane_interp {key}: kernel != plain ({err})"
        row = dict(shape=[R, Xs, Xd], max_abs_err=err)
        if name in passes and not special:
            row["ms"] = cuda_ms(lambda: op(data, pos))
            row["plain_ms"] = cuda_ms(lambda: lane_interp_plain(data, pos),
                                      reps=3, warmup=1)
            row["bound_ms"], row["bound_by"] = lane_bound(R, Xs, Xd)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["library_ms"] = library_lane_ms(data, pos)
        rows[key] = row
        del data, pos, k, p
    emit("lane_interp", tolerance=0.0, **rows)
    torch.cuda.empty_cache()
    main = rows["rotation_pass1"]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"],
                lost=sum(r["ms"] - r["bound_ms"] for r in rows.values()
                         if "ms" in r))


def oblique_cases():
    """Fully oblique output -> input pixel maps about SHAPE's centre
    (x, y, z order): 30 and 45 degrees about z, 45 about (1, 1, 1)."""
    from scipy.spatial.transform import Rotation

    Z, Y, X = SHAPE
    c = np.array([(X - 1) / 2, (Y - 1) / 2, (Z - 1) / 2])
    out = {}
    for name, deg, axis in (("z30", 30.0, (0, 0, 1)), ("z45", 45.0, (0, 0, 1)),
                            ("xyz45", 45.0, (1, 1, 1))):
        ax = np.asarray(axis, float)
        R = Rotation.from_rotvec(np.deg2rad(deg) * ax
                                 / np.linalg.norm(ax)).as_matrix()
        A = np.eye(4)
        A[:3, :3] = R
        A[:3, 3] = c - R @ c
        out[name] = A
    return out


def relayout(vol, A):
    """The oblique entry's input relayout for map A (the JAX package's
    _axis_align_input): (perm, flips, A2, relayouted volume)."""
    from medicalimageanalysis_torch.ops.resample import _axis_align_input

    al = _axis_align_input(A, tuple(vol.shape))
    if al is None:
        return None, (), A, vol
    perm, flips, A2 = al
    v = vol.permute(*perm)
    return perm, flips, A2, (v.flip(flips) if flips else v).contiguous()


def phase_warp_affine_shear(gen, dev):
    """The affine_shear kernel against its plain twin, and the whole
    oblique entry (V2 build + affine_shear) against the direct affine
    mode, both bit-equal, at the oblique maps on SHAPE; the V2 build ms,
    the residual (kernel) ms, their sum against direct affine, V2's
    shape and the kernel's bound: the logical volume read once and the
    output written once (every row the kernel reads from V2 holds a
    cell of the volume; V2's staircase padding is never read)."""
    from medicalimageanalysis_torch.ops.warp import (
        affine_coords, affine_warp_fused, affine_warp_oblique, oblique_plan,
        oblique_v2, warp_affine_shear_plain)

    op = torch.ops.mia_torch.warp_affine_shear
    vol = torch.randn(SHAPE, generator=gen, device=dev) * 500
    rows = {}
    for name, A in oblique_cases().items():
        perm, flips, A2, volr = relayout(vol, A)
        plan = oblique_plan(A2, tuple(volr.shape))
        assert plan is not None, name
        coef = [float(v) for v in np.float32(A2[:3]).reshape(-1)] + [
            float(np.float32(plan[k])) for k in ("ky", "kz", "oy", "oz")]
        v2 = oblique_v2(volr, plan)[None]
        dims = list(volr.shape)
        k = op(v2, coef, dims, list(SHAPE), -3001.0)
        p = warp_affine_shear_plain(v2, coef, dims, SHAPE, -3001.0)
        torch.cuda.synchronize()
        err = max_abs(k, p)
        assert err == 0.0, f"warp_affine_shear {name}: kernel != plain {err}"
        del p
        whole = affine_warp_oblique(vol, A2, -3001.0, SHAPE, plan,
                                    perm=perm, flips=flips)
        direct = affine_warp_fused(volr, A2, -3001.0, SHAPE)
        torch.cuda.synchronize()
        assert torch.equal(whole, direct), f"oblique {name} != affine"
        assert torch.equal(k[0], direct)
        inside = float((direct != -3001.0).float().mean())
        del whole, direct
        v2_ms = cuda_ms(lambda: oblique_v2(volr, plan))
        ms = cuda_ms(lambda: op(v2, coef, dims, list(SHAPE), -3001.0))
        row = dict(v2_shape=list(v2.shape[1:]), plan=plan,
                   max_abs_err=err, inside_share=inside, v2_ms=v2_ms, ms=ms,
                   oblique_ms=v2_ms + ms,
                   affine_ms=cuda_ms(lambda: affine_warp_fused(
                       volr, A2, -3001.0, SHAPE)),
                   plain_ms=cuda_ms(lambda: warp_affine_shear_plain(
                       v2, coef, dims, SHAPE, -3001.0), reps=2, warmup=1))
        row["bound_ms"], row["bound_by"] = bound(
            4 * (volr.numel() + k.numel()), 30 * k.numel())
        cz, cy, cx = affine_coords(torch.as_tensor(
            A2, dtype=torch.float32, device=dev), SHAPE)
        row["library_ms"] = library_sample_ms(volr[None], cz, cy, cx)
        del cz, cy, cx
        rows[name] = row
        del v2, k, volr
        torch.cuda.empty_cache()
    emit("warp_affine_shear", shape=list(SHAPE), tolerance=0.0, **rows)
    del vol
    torch.cuda.empty_cache()
    main = rows["z30"]
    return dict(max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], timed={})


# ---------------------------------------------------------------------------
def ct_noise(gen, hu=20.0, sigma_vox=1.0):
    """Noise of ``hu`` standard deviation, correlated in-plane as a
    reconstruction kernel correlates CT noise: white noise from ``gen``
    blurred by a Gaussian of ``sigma_vox`` along y and x. (White noise
    would be smoothed by every trilinear resample, so an exact
    deformable warp could not bring a resampled series back to its
    reference: the residual ratio would measure the noise.)"""
    from medicalimageanalysis_torch.ops.filters import gauss_taps

    taps, r = gauss_taps(sigma_vox)
    k = torch.as_tensor(taps).view(1, 1, -1)
    Z, Y, X = SHAPE
    n = torch.randn(SHAPE, generator=gen)
    n = F.conv1d(n.reshape(-1, 1, X), k, padding=r).reshape(SHAPE)
    n = F.conv1d(n.transpose(1, 2).reshape(-1, 1, Y), k, padding=r) \
        .reshape(Z, X, Y).transpose(1, 2)
    return n * (hu / n.std())


def phantom(gen):
    """A CT-like phantom in HU: an off-centre body ellipsoid with lungs,
    spine and a few soft-tissue blobs, plus 20 HU of in-plane correlated
    noise from ``gen``."""
    Z, Y, X = SHAPE
    z = torch.linspace(-1, 1, Z)[:, None, None]
    y = torch.linspace(-1, 1, Y)[None, :, None]
    x = torch.linspace(-1, 1, X)[None, None, :]

    def ell(cz, cy, cx, rz, ry, rx):
        return ((z - cz) / rz) ** 2 + ((y - cy) / ry) ** 2 \
            + ((x - cx) / rx) ** 2 <= 1

    vol = torch.full(SHAPE, -1000.0)
    vol[ell(0.0, 0.05, 0.02, 1.2, 0.62, 0.8)] = 40.0
    vol[ell(0.1, -0.05, -0.33, 0.8, 0.35, 0.25)] = -820.0
    vol[ell(0.05, -0.08, 0.36, 0.7, 0.33, 0.22)] = -780.0
    vol[ell(0.0, 0.45, 0.0, 1.3, 0.09, 0.08)] = 700.0
    vol[ell(-0.3, 0.1, 0.15, 0.25, 0.15, 0.12)] = 120.0
    vol[ell(0.4, 0.2, -0.1, 0.2, 0.1, 0.18)] = -90.0
    vol += ct_noise(gen)
    return vol.round().clamp(-1024, 3071).to(torch.int16).numpy()


def ground_truth(ref_origin, mov_origin, zyx_matrix, zyx_offset):
    """The reference -> moving physical 4x4 that Rigid.matrix should hold
    for mov[o] = ref[Rm @ o + off] (scipy, zyx pixels)."""
    S = np.diag(SPACING)
    R = zyx_matrix[::-1, ::-1]                 # zyx -> xyz
    off = zyx_offset[::-1]
    A = np.eye(4)                              # moving physical -> ref
    A[:3, :3] = S @ R @ np.linalg.inv(S)
    A[:3, 3] = ref_origin + S @ off - A[:3, :3] @ mov_origin
    return np.linalg.inv(A)


def write_pair(gen, folder):
    from scipy import ndimage
    from scipy.spatial.transform import Rotation

    from medicalimageanalysis_torch.utils.creation import CreateDicomImage

    ref = phantom(gen)
    th = np.deg2rad(ROT_DEG)
    Rm = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                   [0, np.sin(th), np.cos(th)]])     # zyx: about the z axis
    center = (np.asarray(SHAPE) - 1) / 2
    off = center - Rm @ center
    mov = ndimage.affine_transform(ref.astype(np.float32), Rm, offset=off,
                                   order=1, mode="nearest")
    mov = np.round(mov).astype(np.int16)
    ref_origin = np.array(REF_ORIGIN)
    mov_origin = ref_origin + np.array([SHIFT_MM, 0.0, 0.0])
    for name, arr, origin, uid in (("ref", ref, ref_origin, REF_UID),
                                   ("mov", mov, mov_origin, MOV_UID)):
        CreateDicomImage(os.path.join(folder, name), arr, series=uid,
                         origin=list(origin), spacing=SPACING[:2],
                         thickness=SPACING[2]).run(patient_id="SMOKE")
    truth = ground_truth(ref_origin, mov_origin, Rm, off)
    angle = Rotation.from_matrix(truth[:3, :3]).magnitude()
    assert abs(np.rad2deg(angle) - ROT_DEG) < 1e-6
    return truth, ref


def known_bump():
    """(Z, Y, X) float32 Gaussian of peak 1 and sigma BUMP_SIGMA_MM,
    centred in the phantom's body ellipsoid: BUMP_MM times it is the known
    point displacement in x and in y (mm), 0 in z."""
    sx, sy, sz = SPACING
    # phantom(): body centre (z, y, x) = (0.0, 0.05, 0.02) on [-1, 1]
    axes = [(np.arange(n) - (c + 1) / 2 * (n - 1)) * s
            for n, c, s in zip(SHAPE, (0.0, 0.05, 0.02), (sz, sy, sx))]
    r2 = axes[0][:, None, None] ** 2 + axes[1][None, :, None] ** 2 \
        + axes[2][None, None, :] ** 2
    return np.exp(-r2 / (2 * BUMP_SIGMA_MM ** 2)).astype(np.float32)


def bump_deformed(ref):
    """The reference phantom sampled at p + u(p), u the known bump field
    (scipy, order 1, on the host), as int16 HU."""
    from scipy import ndimage

    g = known_bump()
    zz, yy, xx = np.meshgrid(*(np.arange(n, dtype=np.float32)
                               for n in SHAPE), indexing="ij")
    yy += (BUMP_MM / SPACING[1]) * g
    xx += (BUMP_MM / SPACING[0]) * g
    mov = ndimage.map_coordinates(ref.astype(np.float32), [zz, yy, xx],
                                  order=1, mode="nearest")
    return np.round(mov).astype(np.int16)


def write_deformed(ref, folder):
    """bump_deformed(ref) written as a third series with the reference's
    origin and spacing."""
    from medicalimageanalysis_torch.utils.creation import CreateDicomImage

    CreateDicomImage(folder, bump_deformed(ref), series=DEF_UID,
                     origin=REF_ORIGIN, spacing=SPACING[:2],
                     thickness=SPACING[2]).run(patient_id="SMOKE")


def residual_ratio(warped, moving, fixed, body):
    """Mean |warped - fixed| over mean |moving - fixed|, inside the body
    and where the warp sampled inside the volume."""
    keep = body & (warped != -3001.0)
    return float(np.abs(warped - fixed)[keep].mean()
                 / np.abs(moving - fixed)[keep].mean())


def phase_deformable(folder, names, dev):
    """The deformable path at full width: ingest the deformed series,
    fast demons with the (4, 2, 1) pyramid at its defaults (50 iterations
    a level), create_image and compute_jacobian; then the B-spline at its
    defaults (100 steps, 50 mm control spacing) and create_image."""
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch import interop
    from medicalimageanalysis_torch.data import Data

    t0 = time.perf_counter()
    mia.read_dicoms(folder_path=folder, clear=False, device=dev)
    ingest_s = time.perf_counter() - t0
    name = [n for n in Data.image_list
            if Data.image[n].series_uid == DEF_UID]
    assert len(name) == 1, Data.image_list
    names = dict(names, deformed=name[0])
    fixed = Data.image[names["ref"]].array.astype(np.float32)
    moving = Data.image[names["deformed"]].array.astype(np.float32)
    body = fixed > -900.0                      # body ellipsoid, lungs in
    g = known_bump()

    def field_error(dvf):
        err = np.sqrt((dvf[..., 0] - BUMP_MM * g) ** 2
                      + (dvf[..., 1] - BUMP_MM * g) ** 2 + dvf[..., 2] ** 2)
        return [float(v) for v in np.percentile(err[body], [50, 95])]

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        return res, time.perf_counter() - t0

    deform = mia.Deformable(reference_name=names["ref"],
                            moving_name=names["deformed"], device=dev)
    info, demons_s = timed(lambda: deform.compute_demons(
        method="fast", pyramid=DEMONS_PYRAMID))
    out, image_s = timed(deform.create_image)
    jac, jac_s = timed(deform.compute_jacobian)
    warped = out["array"]
    assert warped.shape == SHAPE and np.isfinite(warped).all()
    assert np.isfinite(deform.dvf).all() and np.isfinite(jac["det"]).all()
    ratio = residual_ratio(warped, moving, fixed, body)
    median, p95 = field_error(deform.dvf)
    # the floor: the known field itself through the same create_image
    ref = Data.image[names["ref"]]
    known = np.stack([BUMP_MM * g, BUMP_MM * g, np.zeros_like(g)], -1)
    oracle = interop.deformable_from_numpy(
        known, ref.origin, ref.spacing, names["ref"], names["deformed"],
        name="known field", device=dev).create_image()["array"]
    del known
    demons = dict(
        seconds=demons_s, create_image_seconds=image_s,
        jacobian_seconds=jac_s, level_shapes=info["level_shapes"],
        residual_ratio=ratio, residual_limit=RESIDUAL_LIMIT,
        floor_excess_limit=FLOOR_EXCESS,
        field_err_p95_limit_mm=FIELD_P95_LIMIT_MM,
        known_field_residual_ratio=residual_ratio(oracle, moving, fixed,
                                                  body),
        field_err_mm_median=median, field_err_mm_p95=p95,
        folding_fraction=jac["folding_fraction"], det_min=jac["det_min"],
        det_max=jac["det_max"])
    del out, warped, jac, oracle

    bspline = mia.Deformable(reference_name=names["ref"],
                             moving_name=names["deformed"], device=dev)
    _, bspline_s = timed(bspline.compute_bspline)
    out, image_s = timed(bspline.create_image)
    assert np.isfinite(bspline.dvf).all() and np.isfinite(out["array"]).all()
    median, p95 = field_error(bspline.dvf)
    bs = dict(seconds=bspline_s, create_image_seconds=image_s,
              residual_ratio=residual_ratio(out["array"], moving, fixed,
                                            body),
              field_err_mm_median=median, field_err_mm_p95=p95)
    emit("deformable", shape=list(SHAPE), ingest_seconds=ingest_s,
         demons=demons, bspline=bs)
    assert ratio <= RESIDUAL_LIMIT, f"demons residual ratio {ratio}"
    assert ratio <= FLOOR_EXCESS * demons["known_field_residual_ratio"], \
        f"demons residual ratio {ratio} above the known field's"
    assert demons["field_err_mm_p95"] <= FIELD_P95_LIMIT_MM, demons
    return names


def phase_deformable_variants(names, dev):
    """SyN with LNCC forces and diffeomorphic demons, 10 iterations each,
    on the pair resampled to (Z/2, Y/4, X/4): the remaining callers of
    the disp mode (scaling-and-squaring compositions, SyN's inversion).
    Returns the warp rows of a second, uncounted run (recorded_rows)."""
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch import interop
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.resample import separable_resample

    Z, Y, X = SHAPE
    small = (Z // 2, Y // 4, X // 4)
    spacing = [SPACING[0] * X / small[2], SPACING[1] * Y / small[1],
               SPACING[2] * Z / small[0]]
    arrays = {}
    for key in ("ref", "deformed"):
        img = Data.image[names[key]]
        arrays[key] = separable_resample(
            torch.as_tensor(img.array, device=dev), small).cpu().numpy()
        interop.image_from_arrays(arrays[key], spacing, img.origin,
                                  img.matrix, "CT", f"{key} small")
    body = arrays["ref"] > -900.0
    rows = {}
    variants = (("syn", "lncc"), ("diffeomorphic", "ssd"))
    for method, forces in variants:
        d = mia.Deformable(reference_name="ref small",
                           moving_name="deformed small", device=dev)
        sync(dev)
        t0 = time.perf_counter()
        d.compute_demons(method=method, forces=forces, iterations=10)
        sync(dev)
        seconds = time.perf_counter() - t0
        out = d.create_image()["array"]
        assert np.isfinite(d.dvf).all() and np.isfinite(out).all()
        rows[f"{method}_{forces}"] = dict(
            seconds=seconds, residual_ratio=residual_ratio(
                out, arrays["deformed"], arrays["ref"], body))
    emit("deformable_variants", shape=list(small), iterations=10, **rows)

    def again():
        for method, forces in variants:
            d = mia.Deformable(reference_name="ref small",
                               moving_name="deformed small", device=dev)
            d.compute_demons(method=method, forces=forces, iterations=10)
            d.create_image()

    # the reduced grid's warp keys, timed on the variants' own tensors
    return recorded_rows(again, dev)


# ---------------------------------------------------------------------------
# dose QA: a clinical structure set and a dose plan on the reference CT
def norm_to_mm(axis, v):
    """Phantom coordinate v in [-1, 1] along axis 'x', 'y' or 'z' -> mm on
    the reference grid."""
    i = "xyz".index(axis)
    n = SHAPE[2 - i]
    return REF_ORIGIN[i] + SPACING[i] * (v + 1.0) * (n - 1) / 2.0


def slice_z(k):
    return REF_ORIGIN[2] + SPACING[2] * k


def loop_mm(k, cx_n, cy_n, rx_n, ry_n, n, indent=None):
    """(n, 3) mm polygon on slice k: an ellipse of normalised centre and
    radii, optionally pushed in by 35 % around direction ``indent``
    (radians) to make it concave."""
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = np.ones(n)
    if indent is not None:
        d = np.angle(np.exp(1j * (a - indent)))
        r = 1.0 - 0.35 * np.exp(-d ** 2 / 0.25)
    x = norm_to_mm("x", cx_n + rx_n * r * np.cos(a))
    y = norm_to_mm("y", cy_n + ry_n * r * np.sin(a))
    return np.stack([x, y, np.full(n, slice_z(k))], axis=1)


STRUCTURES = ("Body", "Lung_L", "Lung_R", "Heart", "SpinalCord", "Esophagus",
              "PTV")


def structure_set():
    """{roi: [(contour (N, 3) mm, slice index), ...]}: the phantom's
    body (every slice, 256 vertices), two concave lungs (the left with an
    inner contour, an XOR hole, on its middle slices), heart, spinal
    cord, oesophagus, and a spherical PTV of radius PTV_RADIUS_MM."""
    Z = SHAPE[0]
    zn = np.linspace(-1, 1, Z)
    rois = {name: [] for name in STRUCTURES}

    def ellipsoid(name, c, r, n, indent=None, hole=None):
        for k in range(Z):
            t = 1.0 - ((zn[k] - c[0]) / r[0]) ** 2
            if t <= 0.05:
                continue
            f = np.sqrt(t)
            rois[name].append((loop_mm(k, c[2], c[1], r[2] * f, r[1] * f, n,
                                       indent), k))
            if hole is not None and abs(zn[k] - c[0]) < hole * r[0]:
                rois[name].append((loop_mm(k, c[2] - 0.3 * r[2] * f, c[1],
                                           0.3 * r[2] * f, 0.3 * r[1] * f,
                                           24), k))

    # the phantom's ellipsoids (phantom()), z radius 1.2 covers every slice
    ellipsoid("Body", (0.0, 0.05, 0.02), (1.2, 0.62, 0.8), 256)
    ellipsoid("Lung_L", (0.1, -0.05, -0.33), (0.8, 0.35, 0.25), 64,
              indent=0.0, hole=0.3)
    ellipsoid("Lung_R", (0.05, -0.08, 0.36), (0.7, 0.33, 0.22), 64,
              indent=np.pi)
    ellipsoid("Heart", (-0.3, 0.1, 0.15), (0.25, 0.15, 0.12), 64)
    for k in range(Z):
        rois["SpinalCord"].append((loop_mm(k, 0.0, 0.45, 0.035, 0.04, 32),
                                   k))
        rois["Esophagus"].append((loop_mm(k, 0.05, 0.3, 0.03, 0.03, 32), k))
    cx, cy, cz = PTV_CENTER_MM
    a = np.linspace(0, 2 * np.pi, 128, endpoint=False)
    for k in range(Z):
        dz = slice_z(k) - cz
        if abs(dz) >= PTV_RADIUS_MM:
            continue
        r = np.sqrt(PTV_RADIUS_MM ** 2 - dz ** 2)
        rois["PTV"].append((np.stack([cx + r * np.cos(a), cy + r * np.sin(a),
                                      np.full(128, slice_z(k))], 1), k))
    return rois


def dose_plan():
    """(Z, Y, X) Gy on a DOSE_SPACING_MM grid over the reference CT: the
    prescription within 2 mm of the PTV, falling off smoothly to 5 Gy.
    Returns (dose, origin)."""
    shape, _, origin = dose_grid()
    zz, yy, xx = np.meshgrid(*(origin[2 - i] + DOSE_SPACING_MM * np.arange(n)
                               for i, n in enumerate(shape)), indexing="ij")
    cx, cy, cz = PTV_CENTER_MM
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2)
    edge = PTV_RADIUS_MM + 2.0
    falloff = 5.0 + (PRESCRIPTION_GY - 5.0) * np.exp(
        -(r - edge) ** 2 / (2 * 20.0 ** 2))
    return np.where(r <= edge, PRESCRIPTION_GY, falloff), origin


def write_rt(folder, img):
    """RTSTRUCT and RTDOSE for the reference series, written with the
    port's own DICOM writer (tests/helpers.py's layout). Returns the
    number of contours."""
    from medicalimageanalysis_torch.dicom import (Dataset, Sequence,
                                                  dcmwrite, generate_uid,
                                                  uids)

    def base(modality, sop_class):
        ds = Dataset()
        ds.SOPClassUID = sop_class
        ds.SOPInstanceUID = generate_uid()
        ds.Modality = modality
        ds.PatientName = "Smoke^Patient"
        ds.PatientID = "SMOKE"
        return ds

    rois = structure_set()
    ds = base("RTSTRUCT", uids.RTStructureSetStorage)
    ds.StructureSetLabel = "smoke"
    series_item = Dataset()
    series_item.SeriesInstanceUID = img.series_uid
    study_item = Dataset()
    study_item.RTReferencedSeriesSequence = Sequence([series_item])
    for_item = Dataset()
    for_item.ReferencedFrameOfReferenceUID = img.frame_ref
    for_item.RTReferencedStudySequence = Sequence([study_item])
    ds.ReferencedFrameOfReferenceSequence = Sequence([for_item])
    roi_seq, contour_seq = Sequence(), Sequence()
    for number, (name, contours) in enumerate(rois.items(), start=1):
        s = Dataset()
        s.ROINumber = number
        s.ROIName = name
        s.ReferencedFrameOfReferenceUID = img.frame_ref
        roi_seq.append(s)
        item = Dataset()
        item.ReferencedROINumber = number
        item.ROIDisplayColor = [255, 40 * number % 256, 0]
        cs = Sequence()
        for xyz, k in contours:
            c = Dataset()
            c.ContourGeometricType = "CLOSED_PLANAR"
            ref = Dataset()
            ref.ReferencedSOPClassUID = uids.CTImageStorage
            ref.ReferencedSOPInstanceUID = f"{REF_UID}.{k}"
            c.ContourImageSequence = Sequence([ref])
            c.ContourData = [float(v) for v in np.round(xyz, 3).reshape(-1)]
            c.NumberOfContourPoints = len(xyz)
            cs.append(c)
        item.ContourSequence = cs
        contour_seq.append(item)
    ds.StructureSetROISequence = roi_seq
    ds.ROIContourSequence = contour_seq
    dcmwrite(os.path.join(folder, "rs.dcm"), ds)

    dose, origin = dose_plan()
    rd = base("RTDOSE", uids.RTDoseStorage)
    rd.FrameOfReferenceUID = img.frame_ref
    rd.ImagePositionPatient = [float(v) for v in origin]
    rd.ImageOrientationPatient = [1, 0, 0, 0, 1, 0]
    rd.PixelSpacing = [DOSE_SPACING_MM, DOSE_SPACING_MM]
    rd.SliceThickness = DOSE_SPACING_MM
    rd.GridFrameOffsetVector = [DOSE_SPACING_MM * i
                                for i in range(dose.shape[0])]
    rd.DoseGridScaling = DOSE_SCALING
    rd.DoseUnits = "GY"
    rd.DoseType = "PHYSICAL"
    rd.DoseSummationType = "PLAN"
    rd.NumberOfFrames = dose.shape[0]
    rd.Rows, rd.Columns = dose.shape[1], dose.shape[2]
    rd.BitsAllocated = rd.BitsStored = 32
    rd.HighBit = 31
    rd.PixelRepresentation = 0
    rd.SamplesPerPixel = 1
    rd.PhotometricInterpretation = "MONOCHROME2"
    rd.PixelData = np.round(dose / DOSE_SCALING).astype("<u4").tobytes()
    dcmwrite(os.path.join(folder, "rd.dcm"), rd)
    return sum(len(c) for c in rois.values()), dose.shape


def phase_dose_qa(folder, names, dev):
    """The dose-QA path on the reference CT at full size: read_dicoms on
    its folder (CT + RTSTRUCT + RTDOSE), the pooled ROI masks, per ROI
    the DVH statistics and the 300-bin curve, dvh_batch over the ROIs;
    then Deformable.update_dose / update_mask on the deformed pair and
    the DVH of the warped dose."""
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.dvh import dvh_statistics
    from medicalimageanalysis_torch.ops.resample import (affine_resample,
                                                         compose_pixel_matrix)
    from medicalimageanalysis_torch.parallel.batch import (dvh_batch,
                                                           rasterize_batch)
    from medicalimageanalysis_torch.utils.metrics import voxel_volume_cc

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    rt_folder = os.path.join(folder, "ref")
    n_contours, dose_shape = write_rt(rt_folder, Data.image[names["ref"]])
    _, read_ms = timed(lambda: mia.read_dicoms(folder_path=rt_folder,
                                               clear=False, device=dev))
    img_name = [n for n in Data.image_list
                if Data.image[n].rois.get("Body") is not None
                and Data.image[n].rois["Body"].contour_pixel is not None]
    assert len(img_name) == 1, img_name
    img_name = img_name[0]
    img = Data.image[img_name]
    dose_name = Data.dose_list[-1]
    dose = Data.dose[dose_name]
    roi_names = [n for n in img.rois if img.rois[n].contour_pixel is not None]
    assert len(roi_names) >= 6, roi_names
    masks, masks_ms = timed(lambda: img.compute_roi_masks(roi_names))
    # the same function on the CPU: bit-equal masks
    cpu = rasterize_batch([img.rois[n].contour_pixel for n in roi_names],
                          tuple(int(v) for v in img.dimensions),
                          device="cpu")
    for i, n in enumerate(roi_names):
        assert np.array_equal(masks[n], cpu[i]), f"{n}: card mask != CPU"
    del cpu

    stats, rows = {}, {}
    for n in roi_names:
        stats[n], stats_ms = timed(
            lambda: dose.compute_roi_dose_statistics(img_name, n))
        (bins, vol_pct), curve_ms = timed(
            lambda: dose.compute_dvh_curve(img_name, n, n_bins=DVH_BINS))
        assert np.isfinite(vol_pct).all() and vol_pct.shape == (DVH_BINS,)
        assert vol_pct[0] == 100.0 and np.all(np.diff(vol_pct) <= 0)
        rows[n] = dict(voxels=int(masks[n].sum()),
                       volume_cc=stats[n]["Volume (cc)"],
                       D95=stats[n]["D95"], Dmean=stats[n]["Dmean"],
                       stats_ms=stats_ms, curve_ms=curve_ms)
    # PTV: the rasterized sphere against the analytic one. The fill
    # convention (interior + 8-connected boundary, cv2's) adds about half
    # a pixel of radius in-plane, so the 2 % limit applies to the
    # contoured slices' discs grown by that half pixel; the plain ratio
    # to 4/3 pi R^3 is printed beside it
    ptv_mm3 = 1e3 * stats["PTV"]["Volume (cc)"]
    sphere_mm3 = 4.0 / 3.0 * np.pi * PTV_RADIUS_MM ** 3
    cz = PTV_CENTER_MM[2]
    discs_mm3 = sum(np.pi * (np.sqrt(PTV_RADIUS_MM ** 2
                                     - (slice_z(k) - cz) ** 2)
                             + SPACING[0] / 2) ** 2 * SPACING[2]
                    for k in range(SHAPE[0])
                    if abs(slice_z(k) - cz) < PTV_RADIUS_MM)
    assert abs(ptv_mm3 / discs_mm3 - 1) <= 0.02, (ptv_mm3, discs_mm3)
    assert stats["PTV"]["D95"] >= 55.0, stats["PTV"]["D95"]

    # dvh_batch over the ROIs, on the dose resampled onto the CT grid
    A = compose_pixel_matrix(dose.matrix, dose.spacing, dose.origin,
                             img.matrix, img.spacing, img.origin)
    grid = affine_resample(dose.array, A, img.array.shape, background=0.0,
                           device=dev)
    B = len(roi_names)
    mask_t = torch.stack([torch.as_tensor(masks[n], device=dev)
                          for n in roi_names])
    batch, batch_ms = timed(lambda: dvh_batch(
        grid.expand((B,) + tuple(grid.shape)), mask_t,
        voxel_volume_cc(img.spacing), device=dev))
    for b, n in enumerate(roi_names):
        for key in ("Volume (cc)", "Dmin", "Dmax", "D95", "D50",
                    "VS20Gy_cc", "VS50Gy_percent"):
            assert np.isclose(batch[key][b], stats[n][key], rtol=1e-6,
                              atol=0), (n, key, batch[key][b], stats[n][key])
        assert np.isclose(batch["Dmean"][b], stats[n]["Dmean"], rtol=1e-5)
    del grid, mask_t

    # adaptive RT: the plan dose warped through the deformable pair
    deform = Data.deformable[f"DVF_{names['ref']}_{names['deformed']}"]
    warped, warp_ms = timed(lambda: deform.update_dose(dose_name))
    ptv = torch.as_tensor(masks["PTV"], device=dev) > 0
    warped_t = torch.as_tensor(warped["array"], device=dev)
    w_stats, w_ms = timed(lambda: dvh_statistics(
        warped_t[ptv], voxel_volume_cc(img.spacing), roi_name="PTV"))
    w_mask, mask_warp_ms = timed(lambda: deform.update_mask(masks["PTV"]))
    assert np.isfinite(warped["array"]).all()
    assert w_mask.shape == SHAPE and w_mask.sum() > 0
    assert np.isfinite(w_stats["D95"]) and w_stats["Dmax"] <= 60.001
    emit("dose_qa", shape=list(SHAPE), rois=len(roi_names),
         contours=n_contours, dose_grid=list(dose_shape),
         read_ms=read_ms, masks_ms=masks_ms,
         masks_ms_per_roi=masks_ms / len(roi_names),
         masks_equal_cpu=True, ptv_mm3=ptv_mm3,
         ptv_over_sphere=ptv_mm3 / sphere_mm3,
         ptv_over_discs=ptv_mm3 / discs_mm3, ptv_d95=stats["PTV"]["D95"],
         dvh_batch_ms=batch_ms, update_dose_ms=warp_ms,
         warped_ptv_dvh_ms=w_ms, warped_ptv_d95=w_stats["D95"],
         update_mask_ms=mask_warp_ms, warped_ptv_voxels=int(w_mask.sum()),
         per_roi=rows)
    return img_name, dose_name


def device_goal(metric, unit, d, voxel_cc):
    """A DVH goal's value read on the card from the ROI doses ``d`` (a
    float32 tensor), by other means than utils/dose's sorted float64
    numpy: D<p>% and Dmedian from ops.edt.masked_percentile (an order
    statistic by a radix search, interpolated in float32), D<v>cc from
    torch.topk, V<g>Gy from a count. Returns (value, tolerance): the
    percentile's float32 interpolation may move it by a few float32 ulps
    of the dose, every other reading is exact or a float64 mean."""
    from medicalimageanalysis_torch.ops.edt import masked_percentile

    q = metric[1:].lower()
    every = torch.ones_like(d, dtype=torch.bool)
    if metric[0] == "D":
        if q in ("max", "min"):
            return float(getattr(d, q)()), 0.0
        if q == "mean":
            return float(d.to(torch.float64).mean()), 1e-9
        if q == "median" or q.endswith("%"):
            pct = 50.0 if q == "median" else 100.0 - float(q[:-1])
            return float(masked_percentile(d, every, pct)), 1e-4
        k = int(np.clip(round(float(q[:-2]) / voxel_cc), 1, d.numel()))
        return float(torch.topk(d, k).values[-1]), 0.0
    covered = int((d >= float(q[:-2])).sum())
    return (100.0 * covered / d.numel() if unit == "%"
            else covered * voxel_cc), 1e-9


def mask_roi(img, name, mask):
    """Hold ``mask`` as a mask-only ROI of ``img``, served from the
    image's mask cache: the plan-QA goals read the mask as it is, without
    the contour round trip of Roi.convert_mask (ported, and driven by the
    ROI mesh path)."""
    img.add_roi(roi_name=name)
    img._roi_mask_cache_put(name, img.rois[name], mask)


def gamma_brute_force(fine, ref, layout, dta_mm, dd, cap, picks):
    """gamma at the flat voxels ``picks`` of ``ref`` (numpy) by a float64
    numpy minimum over the same fine-grid offsets: the fine samples are
    gathered on the card, everything after in float64."""
    s, r, offsets, dist2 = layout
    z, y, x = np.unravel_index(picks, ref.shape)
    idx = [torch.as_tensor(c[:, None] * si + ri + offsets[None, :, a],
                           device=fine.device)
           for a, (c, si, ri) in enumerate(zip((z, y, x), s, r))]
    ev = fine[idx[0], idx[1], idx[2]].cpu().numpy().astype(np.float64)
    diff = ev - ref.reshape(-1)[picks].astype(np.float64)[:, None]
    g2 = dist2[None, :] / dta_mm ** 2 + diff * diff / dd ** 2
    return np.minimum(np.sqrt(g2.min(axis=1)), cap)


def phase_plan_qa(names, img_name, dose_name, dev):
    """The plan-QA path on the dose-QA folder's CT and RTDOSE, at full
    size: accumulate_dose (rigid, then one entry through the fitted
    Deformable), evaluate_constraints, EQD2 / BED / gEUD / NTCP / TCP,
    compute_gamma against three evaluated doses at three criteria (held
    against a float64 brute force), gamma_batch against compute_gamma,
    compare_rois device against host and compare_masks_batch on the
    structure set against its deformable warp, expand_mask device
    against scipy. Returns the calls the profiler runs again."""
    from types import SimpleNamespace

    from scipy import ndimage

    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.edt import squared_edt
    from medicalimageanalysis_torch.ops.gamma import (
        _OUTSIDE, fine_grid_layout, fine_grid_shape, fine_to_ref_pixel_matrix,
        gamma_index, upsample_to_fine)
    from medicalimageanalysis_torch.ops.resample import (affine_resample,
                                                         compose_pixel_matrix)
    from medicalimageanalysis_torch.parallel.batch import (
        compare_masks_batch, gamma_batch)
    from medicalimageanalysis_torch.utils.dose import (accumulate_dose,
                                                       register_dose_grid)
    from medicalimageanalysis_torch.utils.metrics import compare_rois
    from medicalimageanalysis_torch.utils.roi.margin import expand_mask

    img, dose = Data.image[img_name], Data.dose[dose_name]
    step_ms = {}

    def timed(key, fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        step_ms[key] = 1e3 * (time.perf_counter() - t0)
        return out

    # accumulation: two halves of the plan equal its resample to the bit;
    # then half of it through the fitted deformable field
    A = compose_pixel_matrix(dose.matrix, dose.spacing, dose.origin,
                             img.matrix, img.spacing, img.origin)
    alone = affine_resample(dose.array, A, SHAPE, background=0.0,
                            device=dev).cpu().numpy()
    acc = timed("accumulate_rigid", lambda: accumulate_dose(
        img_name, [dose_name, dose_name], weights=[0.5, 0.5],
        name="plan halves"))
    assert np.array_equal(acc.array, alone), "accumulated halves != plan"
    deform_name = f"DVF_{names['ref']}_{names['deformed']}"
    warped_dose = Data.deformable[deform_name].update_dose(dose_name)["array"]
    acc2 = timed("accumulate_deformable", lambda: accumulate_dose(
        names["ref"], [(dose_name, deform_name), dose_name],
        weights=[0.5, 0.5], name="adaptive sum"))
    assert np.array_equal(acc2.array, np.float32(0.5) * warped_dose
                          + np.float32(0.5) * alone)
    del alone, warped_dose

    # DVH goals: each value against a reading on the card from the ROI's
    # doses
    goals = timed("evaluate_constraints", lambda: dose.evaluate_constraints(
        PLAN_GOALS, image_name=img_name))
    voxel_cc = float(np.prod(img.spacing)) / 1000.0
    in_roi = {n: dose.compute_roi_dose_array(img_name, n).astype(np.float64)
              for n in PLAN_GOALS}
    goal_err = 0.0
    for g in goals:
        on_card = torch.as_tensor(in_roi[g["roi"]], dtype=torch.float32,
                                  device=dev)
        want, tol = device_goal(g["metric"], g["unit"], on_card, voxel_cc)
        err = abs(g["value"] - want)
        assert err <= tol * max(1.0, abs(want)), (g, want, tol)
        goal_err = max(goal_err, err)
    ptv_d95 = [g["value"] for g in goals
               if g["roi"] == "PTV" and g["metric"] == "D95%"][0]
    assert ptv_d95 >= 55.0, ptv_d95

    # radiobiology: the converted grids at every voxel against the float64
    # formula (one float32 rounding), gEUD / NTCP / TCP per ROI
    eqd2 = timed("eqd2", lambda: dose.compute_eqd2(30, 3.0, name="EQD2"))
    bed = dose.compute_bed(30, 3.0, name="BED")
    D = dose.array.astype(np.float64)
    for got, want in ((eqd2.array, D * (D / 30 + 3.0) / 5.0),
                      (bed.array, D * (1.0 + D / 30 / 3.0))):
        assert np.all(np.abs(got - want) <= 2.0 ** -24 * np.abs(want))
    plateau = dose.array == dose.array.max()
    eqd2_at_60 = float(np.abs(eqd2.array[plateau] - 60.0).max())
    assert eqd2_at_60 < 1e-3, eqd2_at_60
    del D
    biology = {}
    for n, (td50, m, nn) in NTCP_LKB.items():
        d = in_roi[n]
        eud = float(np.mean(d ** (1.0 / nn)) ** nn)
        t = (eud - td50) / (m * td50)
        got = dose.compute_ntcp(img_name, n, td50, m=m, n=nn)
        want = 0.5 * (1.0 + math.erf(t / math.sqrt(2.0)))
        assert math.isclose(got["gEUD"], eud, rel_tol=1e-9), (n, got, eud)
        assert math.isclose(got["ntcp"], want, rel_tol=1e-9,
                            abs_tol=1e-12), (n, got, want)
        biology[n] = dict(gEUD=got["gEUD"], ntcp=got["ntcp"])
    tcd50, g50, a = TCP_PTV
    eud = float(np.mean(in_roi["PTV"] ** a) ** (1.0 / a))
    got = dose.compute_tcp(img_name, "PTV", tcd50, g50, a)
    assert math.isclose(got["gEUD"], eud, rel_tol=1e-9)
    assert math.isclose(got["tcp"], 1.0 / (1.0 + (tcd50 / eud) ** (4 * g50)),
                        rel_tol=1e-9)
    assert math.isclose(dose.compute_geud(img_name, "PTV", a), eud,
                        rel_tol=1e-9)
    biology["PTV"] = dict(gEUD=got["gEUD"], tcp=got["tcp"])
    del in_roi

    # gamma: three evaluated doses, each a registered Dose, at three
    # criteria
    shifted = SimpleNamespace(
        plane=dose.plane, spacing=dose.spacing, matrix=dose.matrix,
        orientation=dose.orientation, frame_ref=dose.frame_ref,
        origin=np.asarray(dose.origin, float) + [GAMMA_SHIFT_MM, 0.0, 0.0])
    evals = {"identical": register_dose_grid(dose.array, dose,
                                             name="eval identical"),
             "shift_1mm": register_dose_grid(dose.array, shifted,
                                             name="eval shifted"),
             "scaled_5pct": register_dose_grid(
                 dose.array * np.float32(GAMMA_SCALE), dose,
                 name="eval scaled")}
    gamma = {}
    for ev_name, ev in evals.items():
        for crit, kw in GAMMA_CRITERIA.items():
            out = timed(f"gamma {ev_name} {crit}",
                        lambda: dose.compute_gamma(ev, **kw))
            gamma[(ev_name, crit)] = out
    rows = {f"{e} {c}": dict(pass_rate=o["pass_rate"], max=o["max"],
                             mean=o["mean"], analysed=o["analysed_voxels"],
                             offsets=o["search_offsets"])
            for (e, c), o in gamma.items()}
    for crit in GAMMA_CRITERIA:
        assert gamma[("identical", crit)]["pass_rate"] == 100.0
        assert gamma[("identical", crit)]["max"] < 1e-3, rows
    assert gamma[("shift_1mm", "3%/3mm")]["pass_rate"] >= 99.0, rows
    assert gamma[("scaled_5pct", "3%/3mm")]["pass_rate"] < 95.0, rows
    # the scan against a float64 brute force at 2,000 seeded voxels
    layout = fine_grid_layout(dose.spacing, 3.0, None, 2.0)
    brute = {}
    for ev_name in ("shift_1mm", "scaled_5pct"):
        ev = evals[ev_name]
        Af = compose_pixel_matrix(ev.matrix, ev.spacing, ev.origin,
                                  dose.matrix, dose.spacing, dose.origin
                                  ).astype(np.float64) \
            @ fine_to_ref_pixel_matrix(layout[0], layout[1])
        fine = affine_resample(
            ev.array, Af.astype(np.float32),
            fine_grid_shape(dose.array.shape, layout[0], layout[1]),
            background=float(_OUTSIDE), device=dev)
        out = gamma[(ev_name, "3%/3mm")]
        picks = np.random.default_rng(SEED).choice(
            np.flatnonzero(out["mask"]), GAMMA_BRUTE_VOXELS, replace=False)
        want = gamma_brute_force(fine, dose.array, layout, 3.0,
                                 0.03 * out["norm_dose"], 2.0, picks)
        err = float(np.abs(out["gamma"].reshape(-1)[picks] - want).max())
        assert err <= 1e-5, (ev_name, err)
        brute[ev_name] = err
        del fine
    # gamma_batch on shared-grid pairs against compute_gamma pair by pair.
    # The batch upsamples on the shared grid (three contractions), the
    # per-pair path resamples with the affine warp, whose float32 1/s
    # coefficients put a face plane's fine samples up to ~1e-6 voxel
    # outside the grid (the outside sentinel there): the maps are held
    # equal on the voxels beyond the search radius from every face, and
    # everywhere to the per-pair scan on the batch's own fine grid
    pairs = [dose.array, dose.array * np.float32(GAMMA_SCALE),
             dose.array * np.float32(0.97), eqd2.array]
    batch = timed("gamma_batch", lambda: gamma_batch(
        np.stack([dose.array] * len(pairs)), np.stack(pairs), dose.spacing,
        dose_pct=3.0, dta_mm=3.0, return_maps=True, device=dev))
    s_f, r_f = layout[0], layout[1]
    core = tuple(slice(int(np.ceil(ri / si)) + 1, -int(np.ceil(ri / si)) - 1)
                 for ri, si in zip(r_f, s_f))
    batch_vs = []
    for b, arr in enumerate(pairs):
        one = dose.compute_gamma(register_dose_grid(arr, dose,
                                                    name=f"batch eval {b}"))
        same_grid = gamma_index(dose.array, upsample_to_fine(
            torch.as_tensor(arr, device=dev), s_f, r_f), dose.spacing)
        g_b, g_1 = batch["gamma"][b], one["gamma"]
        in_core = one["mask"][core]
        near = int((np.abs(g_1[core] - 1.0) <= 1e-4)[in_core].sum())
        flips = abs(int((g_b[core] <= 1.0)[in_core].sum())
                    - int((g_1[core] <= 1.0)[in_core].sum()))
        row = dict(core_map_max_diff=float(np.abs(g_b[core]
                                                  - g_1[core]).max()),
                   same_grid_map_max_diff=float(np.abs(
                       g_b - same_grid["gamma"]).max()),
                   pass_rate=one["pass_rate"],
                   batch_pass_rate=float(batch["pass_rate"][b]),
                   same_grid_pass_rate=same_grid["pass_rate"],
                   core_pass_flips=flips, core_near_one=near)
        assert batch["analysed_voxels"][b] == one["analysed_voxels"] \
            == same_grid["analysed_voxels"], (b, row)
        assert row["core_map_max_diff"] <= 1e-4 and flips <= near, (b, row)
        # the batch's pass rate is float32, the per-pair one float64
        assert row["same_grid_map_max_diff"] <= 1e-5 and math.isclose(
            row["batch_pass_rate"], same_grid["pass_rate"],
            rel_tol=1e-6), (b, row)
        batch_vs.append(row)

    # the structure set against its deformable warp: compare_rois device
    # against host, then compare_masks_batch over all of it
    deform = Data.deformable[deform_name]
    roi_names = [n for n in img.rois if img.rois[n].contour_pixel is not None]
    masks = img.compute_roi_masks(roi_names)
    warped = timed("update_mask_all", lambda: {
        n: deform.update_mask(masks[n]) for n in roi_names})
    panels = {}
    for n in roi_names:
        mask_roi(img, f"{n} warped", warped[n])
        host = timed(f"compare_rois host {n}", lambda: compare_rois(
            img, n, f"{n} warped", backend="host"))
        devp = timed(f"compare_rois device {n}", lambda: compare_rois(
            img, n, f"{n} warped"))            # the default: the card
        assert set(host) == set(devp)
        for k in host:
            if k in ("dice", "jaccard", "volume_a_cc", "volume_b_cc") \
                    or k.startswith("surface_dice"):
                assert math.isclose(devp[k], host[k], rel_tol=1e-6), (n, k)
            else:
                assert abs(devp[k] - host[k]) <= 1e-3, (n, k, devp, host)
        panels[n] = dict(device=devp, host_minus_device_max=max(
            abs(host[k] - devp[k]) for k in host))
    stack_a = np.stack([masks[n] for n in roi_names])
    stack_b = np.stack([warped[n] for n in roi_names])
    batch_panel = timed("compare_masks_batch", lambda: compare_masks_batch(
        stack_a, stack_b, img.spacing, device=dev))
    for i, n in enumerate(roi_names):
        assert math.isclose(float(batch_panel["hd95_mm"][i]),
                            panels[n]["device"]["hd95_mm"], rel_tol=1e-6)
    del stack_a, stack_b, warped

    # margins: the device EDT on the whole grid against scipy on a crop
    # around the PTV (its bounding box plus the margin's reach and two
    # voxels: nothing outside it is within the margin); they may differ
    # only where a voxel's distance to the PTV lies within 1e-4 mm of the
    # margin
    ptv = masks["PTV"] > 0
    sx, sy, sz = (float(v) for v in img.spacing)
    reach = [int(np.ceil(MARGIN_MM / v)) + 2 for v in (sz, sy, sx)]
    lo = np.maximum(np.argwhere(ptv).min(0) - reach, 0)
    hi = np.minimum(np.argwhere(ptv).max(0) + 1 + reach, SHAPE)
    crop = tuple(slice(a, b) for a, b in zip(lo, hi))
    grown = timed("expand_mask device", lambda: expand_mask(
        ptv, img.spacing, MARGIN_MM))          # the default: the card
    grown_host = np.zeros_like(grown)
    grown_host[crop] = timed("expand_mask scipy crop", lambda: expand_mask(
        ptv[crop], img.spacing, MARGIN_MM, backend="scipy"))
    differ = np.argwhere(grown != grown_host)
    if differ.size:
        dist = ndimage.distance_transform_edt(~ptv[crop],
                                              sampling=(sz, sy, sx))
        d = dist[tuple((differ - lo).T)]
        assert np.all(np.abs(d - MARGIN_MM) <= 1e-4), d
    assert grown.sum() > ptv.sum()
    body = torch.as_tensor(masks["Body"], device=dev) > 0
    emit("plan_qa", shape=list(SHAPE), dose_grid=list(dose.array.shape),
         accumulate_equal_to_resample=True, goals=[
             dict(roi=g["roi"], goal=g["goal"], value=g["value"],
                  passed=g["passed"]) for g in goals],
         goals_max_abs_err_vs_card=goal_err,
         ptv_d95=ptv_d95, eqd2_max_abs_at_60gy=eqd2_at_60,
         radiobiology=biology, gamma=rows, gamma_brute_force_max_err=brute,
         gamma_batch=batch_vs, compare_rois=panels,
         margin_mm=MARGIN_MM, margin_voxels_differ=int(len(differ)),
         ptv_voxels=int(ptv.sum()), grown_voxels=int(grown.sum()),
         step_ms=step_ms)
    sp = tuple(float(v) for v in img.spacing)
    # each criterion's gamma again, recorded: the fine grids' keys timed
    warp_rows = recorded_rows(lambda: [
        dose.compute_gamma(evals["shift_1mm"], **kw)
        for kw in GAMMA_CRITERIA.values()], dev)
    return dict(
        warp_rows=warp_rows,
        gamma=lambda: dose.compute_gamma(evals["shift_1mm"], dose_pct=3.0,
                                         dta_mm=3.0),
        gamma_work=dict(offsets=len(layout[3]), ref=dose.array.size,
                        eval=evals["shift_1mm"].array.size,
                        fine=int(np.prod(fine_grid_shape(
                            dose.array.shape, layout[0], layout[1])))),
        edt=lambda: squared_edt(body, sp), edt_shape=tuple(body.shape))


def mesh_equal(a, b):
    return (a.points.shape == b.points.shape
            and np.array_equal(a.points, b.points)
            and np.array_equal(a.faces, b.faces))


@contextlib.contextmanager
def recording(module, name):
    """Within the block, ``module.name`` records what each call returns
    in the list yielded."""
    fn, seen = getattr(module, name), []

    def record(*args, **kwargs):
        seen.append(fn(*args, **kwargs))
        return seen[-1]

    setattr(module, name, record)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def uncounted():
    """Within the block the wrappers' launches count nowhere: a check run
    inside a path's launch window (a comparison, an input made on the
    card) leaves the path's counts and shapes as they were."""
    from medicalimageanalysis_torch.ops import hist, lane_interp, warp

    saved = [(c, dict(c)) for c in (warp.LAUNCHES, hist.LAUNCHES,
                                    lane_interp.LAUNCHES, warp.LAUNCH_SHAPES,
                                    hist.LAUNCH_SHAPES)]
    try:
        yield
    finally:
        for counts, before in saved:
            counts.clear()
            counts.update(before)


@contextlib.contextmanager
def recording_warp_calls(calls):
    """Within the block, keep in ``calls`` copies of the inputs of the
    first warp_coords / warp_affine / warp_disp operator call at each
    (kernel, launch_key), an affine call under the kernel entry it takes
    (ops/warp.affine_path): the path's own tensors, to check and time the
    kernel on after it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from medicalimageanalysis_torch.ops.warp import affine_path

    kernels = {"mia_torch::warp_coords": "warp_coords",
               "mia_torch::warp_affine": "warp_affine",
               "mia_torch::warp_disp": "warp_disp"}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = kernels.get(func._schema.name)
            if name == "warp_affine":     # (vol, coef, out_shape, bg)
                name = affine_path(args[1])
                key = (name, timed_key(args[0].shape[0], False, args[2],
                                       args[0].shape[1:]))
            elif name is not None:
                key = (name, timed_key(args[0].shape[0], args[-1],
                                       args[1].shape[-3:]))
            if name is not None:
                if key not in calls:
                    calls[key] = tuple(a.clone() if torch.is_tensor(a)
                                       else a for a in args)
            return func(*args, **(kwargs or {}))

    with Record():
        yield calls


@contextlib.contextmanager
def recording_affine_calls(calls):
    """Within the block, keep in ``calls`` the first ops/warp.affine_warp
    call at each (affine_path, launch_key), as recording_warp_calls keeps
    them: the volume it sampled (a reference, or the float32 batch the
    wrapper makes of it; the callers' volumes outlive the block
    unchanged), its 12 coefficients, output dims and background, for a
    volume on the card of at most MAX_B volumes. Every affine launch goes
    through affine_warp. No copy of a float32 volume
    and no dispatch mode: a path timed inside it keeps its times."""
    from medicalimageanalysis_torch.ops import warp

    run = warp.affine_warp
    affine_path = warp.affine_path

    def affine_warp(volume, pixel_matrix, out_shape, background=0.0):
        A = torch.as_tensor(pixel_matrix, dtype=torch.float32).cpu()
        coef = [float(v) for v in A[:3, :].reshape(12)]
        shape = [int(s) for s in out_shape]
        vol = torch.as_tensor(volume)
        B = 1 if vol.dim() == 3 else vol.shape[0]
        key = (affine_path(coef), timed_key(B, False, shape,
                                            vol.shape[-3:]))
        # a launch on the card (one a call), not the CPU's plain twin
        if vol.is_cuda and B <= warp.MAX_B and key not in calls:
            calls[key] = (warp._as_batch(vol)[0], coef, shape,
                          float(background))
        return run(volume, pixel_matrix, out_shape, background)

    warp.affine_warp = affine_warp
    try:
        yield calls
    finally:
        warp.affine_warp = run


def warp_path_rows(calls):
    """The warp kernels at each key recorded by recording_warp_calls, on
    those tensors: held bit-equal to the plain twin, timed, with the bound
    of their work (warp_bound; for a list of points, the field voxels
    their taps touch; for a halo slab deeper than the output, the slab
    rows the taps reach, slab_rows; for an affine map, affine_bound) and
    F.grid_sample at the same points (library_sample_ms). Returns
    {kernel: {launch_key: row}}, each affine row tagged with its kernel
    entry (``path``)."""
    from medicalimageanalysis_torch.ops.warp import (MAX_B, affine_coords,
                                                     warp_affine_plain,
                                                     warp_coords_plain,
                                                     warp_disp_plain)

    plain = {"warp_coords": warp_coords_plain, "warp_disp": warp_disp_plain,
             "warp_affine": warp_affine_plain,
             "warp_affine_axis": warp_affine_plain}
    out = {}
    for (name, key), args in sorted(calls.items()):
        B, want, shape = key[:3]
        affine = name in AFFINE_KERNELS
        assert B <= MAX_B, (name, key)         # one launch a call
        op = getattr(torch.ops.mia_torch, "warp_affine" if affine else name)
        k, p = op(*args), plain[name](*args)
        torch.cuda.synchronize()
        if affine:
            k, p = [k], [p]
        errs = [max_abs(a, b) for a, b in zip(k, p)]
        assert errs == [0.0] * len(errs), \
            f"{name} at the path's {key}: kernel != plain {errs}"
        del k, p
        row = dict(B=B, grad=want, shape=list(shape), max_abs_err=errs,
                   ms=cuda_ms(lambda: op(*args)),
                   plain_ms=cuda_ms(lambda: plain[name](*args), reps=3,
                                    warmup=1))
        if affine:
            row["path"], row["shape_in"] = name, list(key[3])
            row["bound_ms"], row["bound_by"], taps = affine_bound(
                args[0], args[1], shape)
            if taps is not None:
                row["taps"] = taps
        else:
            row["bound_ms"], row["bound_by"] = warp_bound(
                args[0][0].numel(), math.prod(shape), B, 3, want)
        if name == "warp_disp" and args[0].shape[1] != shape[0]:
            # a halo slab (parallel/halo.py): the rows the field reaches
            row["slab_rows"] = slab_rows(args[0].shape[1], args[1][2])
            row["bound_ms"], row["bound_by"] = warp_bound(
                row["slab_rows"] * math.prod(args[0].shape[2:]),
                math.prod(shape), B, 3, want)
        if name == "warp_coords" and tuple(shape[:2]) == (1, 1):
            # points (a mesh warp): the field voxels their taps touch,
            # read once, as phase_mesh_warp bounds the external's
            n = math.prod(shape)
            row["taps"] = mesh_taps(*args[:4])
            row["bound_ms"], row["bound_by"] = bound(
                4 * (B * row["taps"] + 3 * n + B * n), B * 30 * n)
        if name == "warp_coords":
            cz, cy, cx = args[1:4]
        elif affine:
            coef = torch.tensor(args[1], dtype=torch.float32,
                                device=args[0].device)
            cz, cy, cx = affine_coords(coef.reshape(3, 4), shape)
        else:
            zz, yy, xx = (torch.arange(n, device=args[1].device,
                                       dtype=torch.float32) for n in shape)
            cz = zz[:, None, None] + args[1][2]
            cy = yy[None, :, None] + args[1][1]
            cx = xx[None, None, :] + args[1][0]
        row["library_ms"] = library_sample_ms(args[0], cz, cy, cx, want)
        del cz, cy, cx
        out.setdefault(name, {})[key] = row
    torch.cuda.empty_cache()
    return out


def recorded_rows(fn, dev):
    """``fn()`` again with its warp calls recorded, then the kernel at
    each recorded key on those tensors (warp_path_rows); no launch of
    either counts. For the launch shapes no other row times."""
    if torch.device(dev).type != "cuda":
        return {}
    calls = {}
    with uncounted():
        with recording_warp_calls(calls):
            fn()
        rows = warp_path_rows(calls)
    del calls
    torch.cuda.empty_cache()
    return rows


def merge_warp_rows(kernels, path_rows, label):
    """A path's warp rows (warp_path_rows) into the kernel rows: timed
    rows weigh the path's launches in ms_lost, in place of any row at
    their key, each beside the synthetic field's time at its key
    (``synthetic_field_ms``, which marks a path's row), and the kernel's
    row lists them under ``label``."""
    for name, rows in path_rows.items():
        for key, row in rows.items():
            before = kernels[name]["timed"].get(key)
            row["synthetic_field_ms"] = None if before is None \
                else before.get("synthetic_field_ms", before["ms"])
            kernels[name]["max_abs_err"] = max(
                kernels[name]["max_abs_err"], max(row["max_abs_err"]))
        kernels[name]["timed"].update(rows)
        kernels[name][label] = list(rows.values())


def carry_meshes(image, meshes, poi):
    """ROIs holding ``meshes`` (name -> TriMesh), visible, and a POI
    "Iso" at ``poi`` (mm) on ``image``: structures to carry across a
    registration whose moving image it is."""
    for name, mesh in meshes.items():
        image.create_roi(name=name, visible=True)
        image.rois[name].update_mesh(mesh)
    image.add_poi("Iso", point=np.asarray(poi, np.float64))


def drop_structures(names, images=None, pois=("Iso",)):
    """Remove the ROIs ``names`` and the POIs ``pois`` from ``images``
    (default every image); the registry's sync then gives back an empty
    ROI of each name another image still contours."""
    from medicalimageanalysis_torch.data import Data

    for image in Data.image.values() if images is None else images:
        for name in names:
            image.rois.pop(name, None)
        for name in pois:
            image.pois.pop(name, None)
    Data.match_rois()
    Data.match_pois()


def phase_roi_mesh(names, img_name, dose_name, rigid, dev):
    """The ROI mesh path on the dose-QA folder's CT (128 x 512 x 512), 7
    ROIs and RTDOSE: Image.create_external (the card's threshold, scipy's
    labelling) held bit-equal to the recipe on the host; per ROI and the
    external, the table path on the card held bit-equal to the native
    host twin, then create_mesh / create_discrete_mesh /
    create_display_mesh; a PTV round trip (convert_mask); a 5 mm margin
    ROI and a ring (margin - PTV); isodose contours at 9 levels, each
    level's round trip at its fixed point; a Rigid nudge and
    Deformable.update_rois (percent 100 and 50) through the demons field
    with the meshes visible on the moving images, the mesh warp's
    launches counted. Returns what phase_mesh_warp needs after the
    path's launch counts are read."""
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops import geometry as geo
    from medicalimageanalysis_torch.ops.marching_cubes import (
        marching_cubes_host, marching_cubes_mask)
    from medicalimageanalysis_torch.ops.warp import LAUNCHES
    from medicalimageanalysis_torch.utils.convert.contour import (
        _rasterize_plane)
    from medicalimageanalysis_torch.utils.image import threshold
    from medicalimageanalysis_torch.utils.metrics import voxel_volume_cc
    from scipy import ndimage

    img, dose = Data.image[img_name], Data.dose[dose_name]
    roi_names = [n for n in img.rois if img.rois[n].contour_pixel is not None]
    step_ms = {}

    def timed(key, fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        step_ms[key] = 1e3 * (time.perf_counter() - t0)
        return out

    # the external contour: the threshold on the card, the labelling,
    # largest component and per-slice fill on the host
    arr = img.array
    binary = timed("threshold_and_download", lambda: (
        torch.as_tensor(arr, device=dev) > EXTERNAL_HU).cpu().numpy())
    assert np.array_equal(binary, arr > EXTERNAL_HU)
    timed("label_26", lambda: ndimage.label(binary,
                                            structure=np.ones((3, 3, 3))))
    del binary
    with recording(threshold, "external") as seen:
        ext = timed("create_external", lambda: img.create_external(
            name="External", threshold=EXTERNAL_HU))
    host = timed("external_host", lambda: threshold.external(
        arr, EXTERNAL_HU, device="cpu"))
    assert len(seen) == 1 and np.array_equal(seen[0], host), \
        "external: card mask != host recipe"
    ext_voxels = int(host.sum())
    del seen, host

    # every ROI's mesh: the card's table path against the host twin on
    # the same mask, then the Roi's three mesh builds
    vox_cc = voxel_volume_cc(img.spacing)
    p2p = geo.pixel_to_position_matrix(img.matrix, img.spacing, img.origin)
    rows, meshes, work = {}, {}, {}
    for n in roi_names + ["External"]:
        roi = img.rois[n]
        mask = roi.compute_mask()
        mask_t = torch.as_tensor(mask, device=dev)
        on_card = timed(f"{n}_table_card",
                        lambda: marching_cubes_mask(mask_t))
        on_host = timed(f"{n}_table_host", lambda: marching_cubes_host(mask))
        assert mesh_equal(on_card, on_host), f"{n}: card table path != host"
        timed(f"{n}_create_mesh", roi.create_mesh)
        smoothed = roi.mesh
        timed(f"{n}_create_discrete_mesh", roi.create_discrete_mesh)
        assert mesh_equal(roi.mesh, on_card.transform(p2p, inplace=False)), \
            f"{n}: discrete mesh != its table path"
        discrete = roi.mesh
        timed(f"{n}_create_display_mesh", roi.create_display_mesh)
        mask_cc = float(mask.sum()) * vox_cc
        for label, m in (("smoothed", smoothed), ("display", roi.mesh)):
            assert np.isfinite(m.points).all() and m.faces.shape == \
                discrete.faces.shape, (n, label)
        ratio = discrete.volume / 1e3 / mask_cc
        assert 0.85 < ratio < 1.05, (n, ratio)
        rows[n] = dict(voxels=int(mask.sum()), points=discrete.n_points,
                       faces=discrete.n_cells, mask_cc=mask_cc,
                       discrete_over_mask=ratio,
                       display_over_mask=roi.mesh.volume / 1e3 / mask_cc,
                       **{k: step_ms[f"{n}_{k}"] for k in (
                           "table_card", "table_host", "create_mesh",
                           "create_discrete_mesh", "create_display_mesh")})
        meshes[n] = roi.mesh
        if n == "External":
            work["mesh"] = dict(voxels=int(mask.size), points=on_card.n_points,
                                faces=on_card.n_cells)
            body_mask, body_discrete = mask_t, discrete
        del mask_t
    assert rows["External"]["voxels"] > 0.9 * ext_voxels

    # a PTV round trip through a ROI of its own: mask -> contours ->
    # mask gives the mask back
    ptv = img.rois["PTV"].compute_mask()
    img.create_roi(name="PTV_trip")
    timed("ptv_convert_mask", lambda: img.rois["PTV_trip"].convert_mask(ptv))
    assert np.array_equal(img.rois["PTV_trip"].compute_mask(), ptv), \
        "PTV round trip changed the mask"
    ptv_trip = dict(contours=len(img.rois["PTV_trip"].contour_pixel),
                    voxels=int(ptv.sum()))

    # a 5 mm margin ROI (the card's EDT) and a ring around the PTV
    grown = timed("create_roi_from_margin", lambda: img.create_roi_from_margin(
        "PTV_5mm", "PTV", MARGIN_MM)).compute_mask()
    ring = timed("create_roi_from_boolean",
                 lambda: img.create_roi_from_boolean(
                     "Ring", "subtract", "PTV_5mm", "PTV")).compute_mask()
    interior = ndimage.binary_erosion(ptv > 0)
    assert not (ring.astype(bool) & interior).any(), "ring enters the PTV"
    assert np.all(grown >= ptv), "the margin lost PTV voxels"
    margin = dict(margin_mm=MARGIN_MM, grown_voxels=int(grown.sum()),
                  ring_voxels=int(ring.sum()))

    # isodose contours at 9 levels: each level's contours rasterize back
    # to its thresholded mask on the dose grid
    iso = timed("isodose_contours", lambda: dose.compute_isodose_contours())
    assert len(iso) == 9, list(iso)
    d_arr = np.asarray(dose.array, np.float32)
    levels = {}
    for gy, (pix, pos) in iso.items():
        level = (d_arr >= gy).astype(np.uint8)
        back = _rasterize_plane(pix, d_arr.shape, "Axial")
        assert np.array_equal(back, level), f"isodose {gy}: round trip"
        assert len(pos) == len(pix) > 0, gy
        levels[f"{gy:.3f}"] = dict(contours=len(pix),
                                   voxels=int(level.sum()))

    # the meshes visible on the moving images: a Rigid nudge, then the
    # deformable contour propagation
    mov, deformed = Data.image[names["mov"]], Data.image[names["deformed"]]
    carry_meshes(mov, meshes, PTV_CENTER_MM)
    carry_meshes(deformed, meshes, PTV_CENTER_MM)
    nudge = mia.Rigid(names["ref"], names["mov"],
                      matrix=np.array(rigid.matrix, np.float64))
    timed("rigid_nudge", lambda: nudge.update_translation(t_x=VIEW_NUDGE_MM))
    T = np.linalg.inv(nudge.matrix @ nudge.combo_matrix)
    for n, mesh in meshes.items():
        assert mesh_equal(nudge.rois[n], mesh.transform(T, inplace=False)), n
    iso_mm = nudge.update_pois()["Iso"]
    assert np.allclose(iso_mm, (T @ np.append(PTV_CENTER_MM, 1.0))[:3])

    deform = Data.deformable[f"DVF_{names['ref']}_{names['deformed']}"]
    before = LAUNCHES["warp_coords"]
    timed("deformable_update_rois", deform.update_rois)
    launches = LAUNCHES["warp_coords"] - before
    # one launch a mesh on the card (a CPU rehearsal runs the plain twin)
    assert launches == len(meshes) or torch.device(dev).type == "cpu", \
        (launches, len(meshes))
    # the propagation again, recorded: each mesh's points key timed
    warp_rows = recorded_rows(deform.update_rois, dev)
    full = {n: deform.rois[n].points - deform.rigid_rois[n].points
            for n in meshes}
    timed("deformable_update_rois_50", lambda: deform.update_rois(percent=50))
    moved = 0.0
    for n in meshes:
        half = deform.rois[n].points - deform.rigid_rois[n].points
        assert np.isfinite(full[n]).all()
        # a field scaled by 0.5 samples to exactly half the displacement
        # (the differences of mm positions round at 1e-13 mm)
        assert np.allclose(half, 0.5 * full[n], rtol=0, atol=1e-9), n
        moved = max(moved, float(np.abs(full[n]).max()))
    assert 0.5 < moved < 2 * BUMP_MM, moved
    pois = deform.update_pois()
    assert np.all(np.isfinite(pois["Iso"]))

    emit("roi_mesh", shape=list(SHAPE), rois=len(roi_names) + 1,
         external_voxels=ext_voxels, external_equal_host=True,
         tables_equal_host=True, per_roi=rows, ptv_round_trip=ptv_trip,
         margin=margin, isodose=levels, mesh_warp_launches=launches,
         mesh_warp_max_mm=moved, step_ms=step_ms)

    def cleanup():
        """The structures and the Rigid this path added, removed."""
        drop_structures(["External", "PTV_trip", "PTV_5mm", "Ring"])
        drop_structures(roi_names, [mov, deformed])
        Data.rigid.pop(nudge.rigid_name)
        Data.rigid_list.remove(nudge.rigid_name)

    return dict(deform=deform, body_mask=body_mask,
                body_discrete=body_discrete, external=ext, work=work,
                meshes=meshes, cleanup=cleanup, warp_rows=warp_rows)


def slab_rows(depth, dz):
    """The rows of a ``depth``-row volume that a ``disp`` launch's taps
    read for the z displacements ``dz`` (Zo, Yo, Xo) at the base rows
    0..Zo-1: from the lowest floor(z + dz) to the highest floor + 1,
    clamped to the volume as the kernel clamps its taps."""
    zz = torch.arange(dz.shape[0], device=dz.device,
                      dtype=torch.float32)[:, None, None]
    f = torch.floor(zz + dz)
    lo = int(f.min().clamp(0, depth - 1))
    hi = int((f.max() + 1).clamp(0, depth - 1))
    return hi - lo + 1


def mesh_taps(planar, cz, cy, cx):
    """The number of distinct field voxels among the 8 trilinear taps of
    the points (cz, cy, cx), clamped to the grid as the kernel clamps."""
    _, Z, Y, X = planar.shape
    corners = []
    for c, n in ((cz, Z), (cy, Y), (cx, X)):
        lo = torch.floor(c.reshape(-1)).clamp(0, n - 1).to(torch.int64)
        corners.append((lo, (lo + 1).clamp(max=n - 1)))
    taps = torch.cat([(z * Y + y) * X + x for z in corners[0]
                      for y in corners[1] for x in corners[2]])
    return int(torch.unique(taps).numel())


def phase_mesh_warp(path, dev):
    """After the ROI mesh path: its mesh warp's warp_coords launch at the
    Body's points against the plain version on the same tensors (bit-
    equal), timed with its bound and beside F.grid_sample at the same
    points; then the profiles of a mesh build, the
    marching-tetrahedra pass, the Taubin smoothing and the mesh warp.
    Removes the path's ROIs and its Rigid. Returns the kernel row (with
    the launch shape it times), the profiles and the work sizes of their
    bounds."""
    from medicalimageanalysis_torch.device import as_f32
    from medicalimageanalysis_torch.ops.marching_cubes import (
        marching_cubes_mask)
    from medicalimageanalysis_torch.ops.registration.dvf import (
        point_sample_inputs)
    from medicalimageanalysis_torch.ops.warp import warp_coords_plain
    from medicalimageanalysis_torch.utils.mesh.surface import (
        _adjacency, taubin_smooth)

    deform, body = path["deform"], path["body_discrete"]
    args = point_sample_inputs(as_f32(deform.dvf, dev),
                               deform.rigid_rois["External"].points,
                               deform.origin, deform.spacing)
    op = torch.ops.mia_torch.warp_coords
    k = op(*args, 0.0, False)[0]
    p = warp_coords_plain(*args, 0.0, False)[0]
    torch.cuda.synchronize()
    err = max_abs(k, p)
    assert err == 0.0, f"mesh warp: kernel != plain ({err})"
    n_pts = int(args[1].numel())
    row = dict(max_abs_err=err, points=n_pts, taps=mesh_taps(*args),
               ms=cuda_ms(lambda: op(*args, 0.0, False)),
               plain_ms=cuda_ms(lambda: warp_coords_plain(*args, 0.0, False),
                                reps=3, warmup=1),
               library_ms=library_sample_ms(*args))
    # what these points need: the 3 components of each field voxel among
    # their taps read once, the coordinates read, the samples written;
    # 30 float32 operations a sample
    row["bound_ms"], row["bound_by"] = bound(
        4 * (3 * row["taps"] + 3 * n_pts + 3 * n_pts), 3 * 30 * n_pts)
    del args, k, p
    emit("mesh_warp", tolerance=0.0, **row)
    row["shape"] = (1, 1, n_pts)

    edges = _adjacency(torch.as_tensor(body.faces, dtype=torch.int64,
                                       device=dev)).shape[0]
    work = dict(path["work"], taubin=dict(
        points=body.n_points, faces=body.n_cells, edges=int(edges),
        steps=40))
    body_mask = path["body_mask"]
    profiles = {
        "mesh_build": profile_device(path["external"].create_discrete_mesh),
        "marching_tetrahedra": profile_device(
            lambda: marching_cubes_mask(body_mask)),
        "taubin_smooth": profile_device(lambda: taubin_smooth(body)),
        "mesh_warp": profile_device(deform.update_rois, ["warp_coords"])}
    path["cleanup"]()
    path.clear()
    torch.cuda.empty_cache()
    return dict(kernel_row=row, profiles=profiles, work=work)


def voxel_pixels(img, mesh):
    """A mesh's points (mm) as pixel coordinates on ``img``'s grid, as
    Roi.compute_mask converts them."""
    from medicalimageanalysis_torch.ops import geometry as geo

    p2pix = geo.position_to_pixel_matrix(img.matrix, img.spacing, img.origin)
    return np.asarray(mesh.points, np.float64) @ p2pix[:3, :3].T \
        + p2pix[:3, 3]


def surface_ties(pts, faces, got, want):
    """The voxels where the card's mask ``got`` differs from the float64
    twin's ``want``, each held to be on the surface: its center within
    TIE_DISTANCE_PX pixels of the mesh (``pts`` in pixels), where the
    float32 and float64 geometries may decide inside and outside apart.
    Returns the count."""
    from medicalimageanalysis_torch.utils.mesh.trimesh import TriMesh
    from medicalimageanalysis_torch.utils.mesh.volume import (
        _surface_closest)

    at = np.argwhere(got != want)
    if len(at):
        dist, _ = _surface_closest(at[:, ::-1].astype(np.float64),
                                   TriMesh(pts, faces))
        assert dist.max() <= TIE_DISTANCE_PX, \
            f"{int((dist > TIE_DISTANCE_PX).sum())} of {len(at)} " \
            f"differing voxels lie off the surface (up to {dist.max()} px)"
    return int(len(at))


def mesh_file_rows(name, mesh, folder, only=None):
    """``mesh`` written and read back in every mesh format (or those in
    ``only``): rows of MB, ms and MB/s each way and the largest point
    error against the mesh written. Points and faces must read back
    equal: exactly (OBJ), the float32 cast of each coordinate (binary STL
    and PLY), within the writers' decimal digits (%g: ASCII STL, VTK;
    .9g: ASCII PLY, 3MF).
    STL welds its vertices on reading, so it is held by its triangles'
    corners, face by face."""
    from medicalimageanalysis_torch.read import mf3, obj, ply, stl, vtk

    def digits(b, n):
        """Half a unit in the n-th significant digit of each value."""
        mag = np.floor(np.log10(np.maximum(np.abs(b), 1e-30)))
        return 0.5 * 10.0 ** (mag - n + 1) * (1 + 1e-9) + 1e-300

    def triangles(m):
        return m.points[m.faces].reshape(len(m.faces), 9)

    def read_3mf_mesh(path):
        import xml.etree.ElementTree as ET
        import zipfile
        ns = {"m": "http://schemas.microsoft.com/3dmanufacturing/"
                   "core/2015/02"}
        root = ET.parse(zipfile.ZipFile(path).open("3D/3dmodel.model"))
        pts = np.array([[float(v.get(k)) for k in "xyz"]
                        for v in root.iterfind(".//m:vertex", ns)])
        tris = np.array([[int(t.get(k)) for k in ("v1", "v2", "v3")]
                         for t in root.iterfind(".//m:triangle", ns)])
        return type(mesh)(pts, tris)

    f32 = mesh.points.astype(np.float32).astype(np.float64)
    formats = {
        "stl_binary": (stl.write_stl, stl.read_stl, {}, "stl", f32),
        "stl_ascii": (stl.write_stl, stl.read_stl, {"binary": False},
                      "stl", 6),
        "vtk": (vtk.write_vtk_polydata, vtk.read_vtk_polydata, {}, "vtk", 6),
        "ply_binary_colors": (ply.write_ply, ply.read_ply, {}, "ply", f32),
        "ply_ascii": (ply.write_ply, ply.read_ply, {"binary": False}, "ply",
                      9),
        "obj": (obj.write_obj, obj.read_obj, {}, "obj", mesh.points),
        "3mf": (mf3.write_3mf, read_3mf_mesh, {}, "3mf", 9)}
    rows = {}
    for fmt, (write, read, kw, ext, want) in formats.items():
        if only is not None and fmt not in only:
            continue
        path = os.path.join(folder, f"{name}_{fmt}.{ext}")
        t0 = time.perf_counter()
        write(path, mesh, **kw)
        t1 = time.perf_counter()
        back = read(path)
        t2 = time.perf_counter()
        mb = os.path.getsize(path) / 1e6
        if ext == "stl":
            ref = triangles(type(mesh)(want if not isinstance(want, int)
                                       else mesh.points, mesh.faces))
            got = triangles(back)
        else:
            assert np.array_equal(back.faces, mesh.faces), (name, fmt)
            ref = mesh.points if isinstance(want, int) else want
            got = back.points
        assert got.shape == ref.shape, (name, fmt, got.shape, ref.shape)
        err = np.abs(got - ref)
        if isinstance(want, int):
            assert np.all(err <= digits(ref, want)), (name, fmt)
        else:
            assert np.array_equal(got, ref), (name, fmt)
        if fmt in ("ply_binary_colors", "obj"):
            assert np.array_equal(back.point_data["colors"],
                                  mesh.point_data["colors"]), (name, fmt)
        os.remove(path)
        rows[fmt] = dict(mb=mb, write_ms=1e3 * (t1 - t0),
                         read_ms=1e3 * (t2 - t1),
                         write_mb_s=mb / max(t1 - t0, 1e-9),
                         read_mb_s=mb / max(t2 - t1, 1e-9),
                         max_err_mm=float(err.max()) if err.size else 0.0)
    return rows


def phase_mesh_rest(path, names, img_name, dose_name, rigid, dev):
    """The rest of the mesh slice on the ROI mesh path's 8 meshes on the
    reference CT (128 x 512 x 512), the fitted Rigid and the demons
    Deformable: each mesh voxelized on the card (ops/voxelize, plain
    PyTorch), alone and all 8 in one voxelize_batch, the heart in all
    three planes, each held bit-equal to the host float64 twin but at
    on-surface ties (counted); a mesh-only ROI (CreateImageFromMask +
    add_mesh_roi of the PTV's mesh): its compute_mask, its DVH goals
    against readings on the card, and a compute_demons masked by a
    mesh-only ROI on both images; the Rigid and Deformable Displays'
    mesh cuts through the heart on three planes (the Deformable's through
    update_rois: one warp_coords launch); every ROI mesh written and
    read back as STL, VTK, PLY, OBJ and 3MF (the Body's and the lungs'
    in the binary formats); read_3mf of the heart; clean_mesh, the
    self-intersection search and repair, only_main_component, expansion,
    Refinement's four splits and Volume(...).create() on the heart. The
    launch window is the whole phase; after it the Deformable cut's warp
    runs again, recorded, and is held and timed on its own tensors.
    Returns the window's launches and shapes, the warp rows, the profile
    of one voxelization (the external) and the work sizes of its bound."""
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.voxelize import (
        voxelize_batch, voxelize_compute_marginal_ms, voxelize_mesh_device)
    from medicalimageanalysis_torch.ops.warp import LAUNCHES
    from medicalimageanalysis_torch.utils.convert.voxelize import (
        host_voxelize)
    from medicalimageanalysis_torch.utils.creation import (
        CreateImageFromMask)
    from medicalimageanalysis_torch.utils.mesh import surface
    from medicalimageanalysis_torch.utils.mesh.volume import Volume
    from medicalimageanalysis_torch.utils.metrics import dice_coefficient

    t_phase = time.perf_counter()
    registry = {k: (dict(v) if isinstance(v, dict) else list(v))
                for k, v in registry_state().items()}
    img, dose = Data.image[img_name], Data.dose[dose_name]
    meshes = path["meshes"]
    dims = tuple(int(v) for v in img.dimensions)
    out = {}

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        return res, 1e3 * (time.perf_counter() - t0)

    # -- voxelization on the card, each mesh against the float64 twin
    pixels = {n: voxel_pixels(img, m) for n, m in meshes.items()}
    singles, rows = {}, {}
    for n, m in meshes.items():
        stats = {}
        got, ms = timed(lambda: voxelize_mesh_device(
            pixels[n], m.faces, dims, device=dev, stats=stats))
        want, host_ms = timed(lambda: host_voxelize(
            pixels[n], np.asarray(m.faces, np.int64), dims, "Axial"))
        ties = surface_ties(pixels[n], m.faces, got, want)
        singles[n] = got
        rows[n] = dict(points=m.n_points, faces=m.n_cells, ms=ms,
                       host_ms=host_ms, big_faces=stats["big_faces"],
                       crop_bytes=stats["crop_bytes"], pairs=stats["pairs"],
                       upload_bytes=stats["upload_bytes"],
                       voxels=int(want.sum()), ties=ties)
        assert want.sum() > 0 and stats["big_faces"] == 0, (n, rows[n])
    order = list(meshes)
    batch_stats = {}
    batch, batch_ms = timed(lambda: voxelize_batch(
        [(pixels[n], meshes[n].faces) for n in order], dims, device=dev,
        stats=batch_stats))
    for b, n in enumerate(order):
        assert np.array_equal(batch[b], singles[n]), f"batch {n} != single"
    del batch
    # the pooled pass's device time on resident inputs (the JAX package's
    # voxelize_compute_marginal_ms), beside the whole call's
    resident_ms = voxelize_compute_marginal_ms(
        [(pixels[n], meshes[n].faces) for n in order], dims, device=dev)
    assert 0.0 < resident_ms < batch_ms, (resident_ms, batch_ms)
    planes = {}
    organ = "Heart"
    for plane in PLANES:
        faces = np.asarray(meshes[organ].faces, np.int64)
        got, ms = timed(lambda: voxelize_mesh_device(
            pixels[organ], faces, dims, plane=plane, device=dev))
        want, host_ms = timed(lambda: host_voxelize(
            pixels[organ], faces, dims, plane))
        planes[plane] = dict(ms=ms, host_ms=host_ms, voxels=int(want.sum()),
                             ties=surface_ties(pixels[organ], faces, got,
                                               want))
    ext = meshes["External"]
    work = dict(points=ext.n_points, faces=ext.n_cells,
                pairs=rows["External"]["pairs"], voxels=int(np.prod(dims)),
                crop_bytes=rows["External"]["crop_bytes"])
    profile = profile_device(lambda: voxelize_mesh_device(
        pixels["External"], ext.faces, dims, device=dev, as_numpy=False))
    marks = {"voxelize": time.perf_counter()}
    out["voxelize"] = dict(per_mesh=rows, batch_ms=batch_ms,
                           batch_resident_pass_ms=resident_ms,
                           batch_crop_bytes=batch_stats["crop_bytes"],
                           batch_equal_to_single=True, planes=planes,
                           organ=organ)

    # -- a mesh-only ROI: CreateImageFromMask + add_mesh_roi of the PTV's
    # mesh, its mask, its DVH goals; a demons masked by a mesh-only ROI
    ptv = img.rois["PTV"].compute_mask()
    fake = CreateImageFromMask(ptv.astype(np.int16), np.asarray(img.origin),
                               list(np.asarray(img.spacing)), "PTV mesh")
    fake.add_image()
    fake.add_mesh_roi(meshes["PTV"], "PTV_mesh")
    roi = Data.image["PTV mesh"].rois["PTV_mesh"]
    assert roi.contour_pixel is None
    mask, mask_ms = timed(roi.compute_mask)
    assert np.array_equal(mask, singles["PTV"]), "mesh-only mask"
    goals, goals_ms = timed(lambda: dose.evaluate_constraints(
        {"PTV_mesh": PLAN_GOALS["PTV"]}, image_name="PTV mesh"))
    voxel_cc = float(np.prod(img.spacing)) / 1000.0
    with uncounted():
        d = torch.as_tensor(dose.compute_roi_dose_array(
            "PTV mesh", "PTV_mesh"), dtype=torch.float32, device=dev)
    goal_err = 0.0
    for g in goals:
        want, tol = device_goal(g["metric"], g["unit"], d, voxel_cc)
        err = abs(g["value"] - want)
        assert err <= tol * max(1.0, abs(want)), (g, want, tol)
        goal_err = max(goal_err, err)
    del d
    for n in (names["ref"], names["deformed"]):
        Data.image[n].create_roi(name="PTV_shell", visible=False)
        Data.image[n].rois["PTV_shell"].update_mesh(meshes["PTV"].copy())
    masked = mia.Deformable(reference_name=names["ref"],
                            moving_name=names["deformed"],
                            roi_names=["PTV_shell"], device=dev)
    (ref_mask, mov_mask), union_ms = timed(masked.roi_mask_union)
    assert np.array_equal(ref_mask, singles["PTV"]) \
        and np.array_equal(mov_mask, singles["PTV"]), "mesh-only union"
    dinfo, dem_ms = timed(lambda: masked.compute_demons(
        method="fast", pyramid=DEMONS_PYRAMID))
    fixed = Data.image[names["ref"]].array.astype(np.float32)
    moving = Data.image[names["deformed"]].array.astype(np.float32)
    warped = masked.create_image()["array"]
    keep = (ref_mask > 0) & (warped != -3001.0)
    in_mask = float(np.abs(warped - fixed)[keep].mean()
                    / np.abs(moving - fixed)[keep].mean())
    assert in_mask < 1.0, in_mask
    out["mesh_only_roi"] = dict(
        mask_ms=mask_ms, voxels=int(mask.sum()),
        dice_with_contoured=float(dice_coefficient(mask, ptv)),
        goals_ms=goals_ms, goals=len(goals), goal_max_err=goal_err,
        union_ms=union_ms, masked_demons_ms=dem_ms,
        level_shapes=dinfo["level_shapes"],
        residual_ratio_in_mask=in_mask)
    del ptv, mask, warped, fixed, moving
    marks["mesh_only_roi"] = time.perf_counter()

    # -- the Displays' mesh cuts through the heart on three planes
    to_ref = np.linalg.inv(np.asarray(rigid.matrix @ rigid.combo_matrix))
    carried = meshes[organ].transform(to_ref, inplace=False)
    rigid.rois.pop(organ, None)
    cuts = {}
    for plane in PLANES:
        loops, ms = timed(lambda: rigid.display.compute_mesh_slice(
            organ, location=carried.center, slice_plane=plane))
        normal = np.asarray(rigid.display.matrix)[
            :3, {"Axial": 2, "Coronal": 1}.get(plane, 0)]
        direct = carried.slice_plane(normal, carried.center)
        assert len(loops.loops) == len(direct) > 0, (plane, len(direct))
        for a, b in zip(loops.loops, direct):
            assert np.allclose(a, b, rtol=0, atol=1e-9), plane
        cuts[f"rigid_{plane}"] = dict(ms=ms, loops=len(direct),
                                      points=int(loops.number_of_points))
    deform = path["deform"]
    deform.rois[organ] = None
    before = LAUNCHES["warp_coords"]
    for plane in PLANES:
        loops, ms = timed(lambda: deform.display.compute_mesh_slice(
            organ, location=meshes[organ].center, slice_plane=plane))
        assert len(loops.loops) > 0, plane
        cuts[f"deformable_{plane}"] = dict(
            ms=ms, loops=len(loops.loops),
            points=int(loops.number_of_points))
    cut_launches = LAUNCHES["warp_coords"] - before
    # one warp of the heart's mesh for the three cuts (a CPU rehearsal
    # runs the plain twin)
    assert cut_launches == 1 or torch.device(dev).type == "cpu", \
        cut_launches
    out["mesh_cuts"] = dict(organ=organ, coords_launches=cut_launches,
                            **cuts)
    marks["mesh_cuts"] = time.perf_counter()

    # -- mesh IO: every ROI mesh in every format, those of more than
    # TEXT_MESH_POINTS points in the binary ones
    rng = np.random.default_rng(SEED)
    io_rows = {}
    with tempfile.TemporaryDirectory(prefix="mia_mesh_") as tmp:
        for n in [k for k in meshes if k != "External"]:
            m = meshes[n].copy()
            m["colors"] = rng.integers(0, 256, (m.n_points, 3)).astype(
                np.uint8)
            io_rows[n] = mesh_file_rows(
                n, m, tmp, only=BINARY_MESH_FORMATS
                if m.n_points > TEXT_MESH_POINTS else None)
        path_3mf = os.path.join(tmp, "heart.3mf")
        meshes[organ].save(path_3mf)
        reader, read_ms = timed(lambda: mia.read_3mf(path_3mf,
                                                     roi_name="Heart_3mf"))
    fake3 = Data.image[reader.image_name]
    assert reader.image_name in Data.image_list
    roi3 = fake3.rois["Heart_3mf"]
    mask3, mask3_ms = timed(roi3.compute_mask)
    px3 = voxel_pixels(fake3, roi3.mesh)
    want3 = host_voxelize(px3, np.asarray(roi3.mesh.faces, np.int64),
                          fake3.dimensions, "Axial")
    ties3 = surface_ties(px3, roi3.mesh.faces, mask3, want3)
    assert mask3.sum() > 0
    out["mesh_io"] = dict(per_mesh=io_rows, read_3mf=dict(
        ms=read_ms, image=reader.image_name,
        dims=[int(v) for v in fake3.dimensions],
        spacing=[float(v) for v in fake3.spacing], mask_ms=mask3_ms,
        voxels=int(mask3.sum()), ties=ties3,
        points=roi3.mesh.n_points))
    marks["mesh_io"] = time.perf_counter()

    # -- repair and tets on the heart
    heart = meshes[organ]
    rep = {}
    cleaned, rep["clean_mesh_ms"] = timed(lambda: surface.clean_mesh(heart))
    bad, rep["find_self_intersections_ms"] = timed(
        lambda: surface.find_self_intersections(heart))
    fixed_mesh, rep["remove_self_intersections_ms"] = timed(
        lambda: surface.remove_self_intersections(heart, device=dev))
    main, rep["only_main_component_ms"] = timed(
        lambda: surface.only_main_component(heart))
    # the normal offset alone: on a marching-tetrahedra surface its
    # self-intersections' repair erodes the shell (the JAX package's
    # expansion docstring), so fix_intersections stays off
    grown, rep["expansion_ms"] = timed(lambda: surface.expansion(
        heart, 2.0, device=dev))
    assert bad.size == 0 and fixed_mesh.n_cells == cleaned.n_cells
    assert grown.volume > heart.volume and main.n_points == heart.n_points
    ref = surface.Refinement(heart)
    split, rep["tri_split_ms"] = timed(ref.tri_split)
    adv, rep["advanced_split_ms"] = timed(
        lambda: surface.Refinement(heart).advanced_split(area_factor=1.5))
    _, rep["find_face_correction_ms"] = timed(ref.find_face_correction)
    (mids, edges), rep["compute_midpoints_ms"] = timed(ref.compute_midpoints)
    assert split.n_points == heart.n_points + len(ref.correct_faces)
    assert np.allclose(mids, (heart.points[edges[:, 0]]
                              + heart.points[edges[:, 1]]) / 2)
    tets, rep["volume_create_ms"] = timed(lambda: Volume(heart).create())
    ratio = tets.volume / heart.volume
    min_dihedral = float(tets.dihedral_angles().min())
    assert 0.94 <= ratio <= 1.03 and min_dihedral >= 8.0, \
        (ratio, min_dihedral)
    out["repair"] = dict(
        points=heart.n_points, faces=heart.n_cells,
        cleaned_faces=cleaned.n_cells, self_intersections=int(bad.size),
        repaired_faces=fixed_mesh.n_cells, main_points=main.n_points,
        expanded_cc=grown.volume / 1e3, tri_split_faces=split.n_cells,
        advanced_split_faces=adv.n_cells, midpoints=len(mids),
        tets=tets.n_cells, tet_over_surface_volume=ratio,
        min_dihedral_deg=min_dihedral, **rep)

    launches, shapes = launch_counts(), launch_shapes()
    marks["repair"] = time.perf_counter()
    seconds = marks["repair"] - t_phase
    out["section_s"] = {k: v - p for (k, v), p in zip(
        marks.items(), [t_phase] + list(marks.values())[:-1])}

    # after the window: the Deformable cut's warp again, recorded, held
    # bit-equal to the plain twin and timed on its own tensors
    calls = {}
    with uncounted():
        with recording_warp_calls(calls):
            deform.rois[organ] = None
            deform.display.compute_mesh_slice(
                organ, location=meshes[organ].center, slice_plane="Axial")
        warp_rows = warp_path_rows(calls) \
            if torch.device(dev).type == "cuda" else {}
    # the masked demons again, recorded: its cropped grids' keys timed
    demons_rows = recorded_rows(lambda: masked.compute_demons(
        method="fast", pyramid=DEMONS_PYRAMID), dev)
    for name, rows in demons_rows.items():
        warp_rows.setdefault(name, {}).update(rows)
    drop_structures(["PTV_mesh", "PTV_shell", "Heart_3mf"])
    set_registry(registry)
    for n in (names["ref"], names["deformed"]):
        getattr(Data.image[n], "_roi_mask_cache", {}).pop("PTV_shell", None)
    torch.cuda.empty_cache()
    emit("mesh_rest", seconds=seconds, shape=list(SHAPE), meshes=len(meshes),
         launches=launches, **out)
    return dict(launches=launches, shapes=shapes, warp_rows=warp_rows,
                profile=profile, work=work)


def shear_against_exact(shear, exact, dev):
    """(share of voxels whose valid masks agree, mean |diff| in HU over
    the voxels valid in both and 2 voxels inside them: a 5^3 box
    erosion) of a shear-lane reslice against the exact one."""
    s = torch.as_tensor(shear, device=dev)
    e = torch.as_tensor(exact, device=dev)
    agree = float(((s != -3001.0) == (e != -3001.0)).float().mean())
    outside = ((s == -3001.0) | (e == -3001.0)).float()[None, None]
    interior = F.max_pool3d(outside, 5, stride=1, padding=2)[0, 0] == 0
    assert int(interior.sum()) > 0.3 * interior.numel()
    return agree, float((s - e).abs()[interior].mean())


@contextlib.contextmanager
def recording_shear_passes(log):
    """Append (rows R, source width Xs, destination width Xd) of every
    shear_x pass that ops/resample runs inside the block to ``log``: the
    shapes the shear lane gives the lane_interp kernel."""
    from medicalimageanalysis_torch.ops import resample

    run = resample.shear_x

    def shear_x(vol, pos_x):
        Z, Y, Xs = vol.shape
        log.append((Z * Y, Xs, int(pos_x.shape[-1])))
        return run(vol, pos_x)

    resample.shear_x = shear_x
    try:
        yield log
    finally:
        resample.shear_x = run


def phase_view(names, rigid, dev):
    """The view path at full width on the reference series and the fitted
    rigid. The off-axis display: Image.update_rotation(r_z=30), its
    secondary array against the plain affine twin of the same matrix on
    the card (bit-equal); retrieve_array_plane on the three planes,
    retrieve_slice, retrieve_vtk_volume, reset_array. The Rigid nudges:
    update_translation (the overlay refreshed by Display.compute_reslice)
    and update_rotation, each with config.use_shear_warp False, then
    True; each shear reslice against the exact reslice of the same matrix
    (shape and origin equal, valid masks agreeing on SHEAR_MASK_AGREE of
    voxels, interior mean |diff| below SHEAR_INTERIOR_HU). ms per view
    update. Returns the number of shear reslices, the shapes of their
    lane_interp passes ("<nudge>_pass<i>": (R, Xs, Xd)) and the display's
    output -> input pixel map and output shape."""
    from medicalimageanalysis_torch.config import config
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.resample import rotation_grid
    from medicalimageanalysis_torch.ops.warp import warp_affine_plain

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    img = Data.image[names["ref"]]
    _, rotate_ms = timed(lambda: img.update_rotation(r_z=VIEW_DISPLAY_DEG))
    sec = img.display.secondary_array
    A, shape, _ = rotation_grid(img.array.shape, img.matrix, img.spacing,
                                img.origin, img.display.matrix)
    assert sec.shape == shape and sec.dtype == np.float32
    assert np.isfinite(sec).all()
    vol = torch.as_tensor(img.array, device=dev).to(torch.float32)
    coef = [float(v) for v in np.float32(A[:3]).reshape(-1)]
    plain = warp_affine_plain(vol[None], coef, shape, -3001.0)[0]
    assert np.array_equal(sec, plain.cpu().numpy()), \
        "display reslice != plain affine"
    del plain, vol
    planes, planes_ms = timed(lambda: {p: img.retrieve_array_plane(p)
                                       for p in PLANES})
    for p, a in planes.items():
        assert a.ndim == 2 and np.isfinite(a).all(), p
    slices = {p: img.retrieve_slice(p) for p in PLANES}
    assert all(np.isfinite(s["origin"]).all() for s in slices.values())
    vtk, vtk_ms = timed(img.retrieve_vtk_volume)
    assert np.array_equal(vtk["array"], sec)
    assert np.allclose(vtk["origin"], img.display.origin)
    display = dict(display_deg=VIEW_DISPLAY_DEG, out_shape=list(shape),
                   inside_share=float((sec != -3001.0).mean()),
                   update_rotation_ms=rotate_ms, planes_ms=planes_ms,
                   retrieve_vtk_volume_ms=vtk_ms, equal_to_plain=True)
    del sec, vtk
    img.reset_array()
    assert img.display.secondary_array is None

    nudges = {"translation": lambda: rigid.update_translation(
                  t_x=VIEW_NUDGE_MM),
              "rotation": lambda: rigid.update_rotation(r_z=VIEW_NUDGE_DEG)}
    rows, n_shear, passes = {}, 0, {}
    for nudge, step in nudges.items():
        for shear in (False, True):
            config.use_shear_warp = shear

            def update():
                step()
                if nudge == "translation":    # the overlay refreshed
                    rigid.display.compute_reslice()
                return {p: rigid.retrieve_array_plane(p) for p in PLANES}

            with recording_shear_passes([]) as log:
                planes, ms = timed(update)
            config.use_shear_warp = False
            out = rigid.display.array
            assert np.isfinite(out).all()
            assert any(a is not None for a in planes.values())
            row = dict(ms=ms, out_shape=list(out.shape))
            assert len(log) == (3 if shear else 0), log
            if shear:
                n_shear += 1
                for i, rxx in enumerate(log):
                    passes[f"{nudge}_pass{i + 1}"] = rxx
                row["lane_passes"] = [list(rxx) for rxx in log]
                exact = rigid.create_image()
                assert out.shape == exact["array"].shape
                assert np.array_equal(rigid.display.origin, exact["origin"])
                row["mask_agree"], row["interior_mean_abs_hu"] = \
                    shear_against_exact(out, exact["array"], dev)
                assert row["mask_agree"] >= SHEAR_MASK_AGREE, row
                assert row["interior_mean_abs_hu"] < SHEAR_INTERIOR_HU, row
                del exact
            rows[f"{nudge}_{'shear' if shear else 'exact'}"] = row
    emit("view", shape=list(SHAPE), display=display,
         interior_limit_hu=SHEAR_INTERIOR_HU,
         mask_agree_limit=SHEAR_MASK_AGREE, rigid=rows)
    return dict(n_shear=n_shear, passes=passes, display_map=(A, shape))


def phase_oblique_entry(names, A, shape, dev):
    """The oblique entry (affine_warp_oblique: one V2 build by the coords
    mode, one affine_shear launch), called on its own at the off-axis
    display's map: bit-equal to the plain affine twin of that map, which
    the display's secondary array equals. No path of the port calls it
    (affine_resample keeps the direct affine mode for every map), so its
    launches are counted apart from the view path's."""
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.warp import (affine_warp_oblique,
                                                     oblique_plan,
                                                     warp_affine_plain)

    vol = torch.as_tensor(Data.image[names["ref"]].array,
                          device=dev).to(torch.float32)
    perm, flips, A2, volr = relayout(vol, np.asarray(A, np.float64))
    plan = oblique_plan(A2, tuple(volr.shape))
    assert plan is not None
    v2_shape = [plan["Z2"], plan["Y2"], int(volr.shape[2])]
    del volr
    sync(dev)
    t0 = time.perf_counter()
    oblique = affine_warp_oblique(vol, A2, -3001.0, shape, plan, perm=perm,
                                  flips=flips)
    sync(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    coef = [float(v) for v in np.float32(A[:3]).reshape(-1)]
    plain = warp_affine_plain(vol[None], coef, shape, -3001.0)[0]
    assert torch.equal(oblique, plain), "oblique entry != display reslice"
    emit("oblique_entry", out_shape=list(shape), v2_shape=v2_shape, ms=ms,
         equal_to_display=True)
    del vol, oblique, plain
    torch.cuda.empty_cache()


def phase_ingest(folder, dev):
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data

    t0 = time.perf_counter()
    mia.read_dicoms(folder_path=folder, device="cpu")
    cpu_s = time.perf_counter() - t0
    plain = {Data.image[n].series_uid: Data.image[n].array
             for n in Data.image_list}
    t0 = time.perf_counter()
    reader = mia.read_dicoms(folder_path=folder, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    names = {}
    for n in Data.image_list:
        img = Data.image[n]
        assert img.array.shape == SHAPE and img.array.dtype == np.int16
        assert np.array_equal(img.array, plain[img.series_uid]), \
            f"{n}: card assembly != CPU assembly"
        names["ref" if img.series_uid == REF_UID else "mov"] = n
    assert len(names) == 2, reader.report.summary()
    emit("ingest", series=2, slices=2 * SHAPE[0], seconds=seconds,
         series_per_s=2 / seconds, cpu_seconds=cpu_s,
         assembly_equal=True, report=reader.report.summary())
    return names


def registration_error(M, ref, truth):
    """(centre error mm, worst corner error mm, angle error deg) of the
    fitted reference -> moving matrix ``M`` against the known one, over
    the reference image ``ref``."""
    from scipy.spatial.transform import Rotation

    Z, Y, X = SHAPE
    points = [ref.compute_center()] + [
        ref.compute_position([x, y, z]) for z in (0, Z - 1)
        for y in (0, Y - 1) for x in (0, X - 1)]
    errs = [float(np.linalg.norm((M @ np.append(p, 1.0))[:3]
                                 - (truth @ np.append(p, 1.0))[:3]))
            for p in points]
    angle = float(np.rad2deg(Rotation.from_matrix(
        M[:3, :3].T @ truth[:3, :3]).magnitude()))
    return errs[0], max(errs[1:]), angle


def phase_rigid(names, truth):
    """The default three-level registration, run twice: the first call
    pays cuBLAS and allocator set-up, the second is the steady cost.
    ``wall_ms`` is the whole call; ``prep_ms`` its host-side work before
    the descent (cast, percentile, quantise, upload); ``ms_per_level``
    the descent alone."""
    import medicalimageanalysis_torch as mia

    rigid = mia.Rigid(names["ref"], names["mov"])
    steps = [s for _, s, _ in RIGID_LEVELS]
    rows = {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = rigid.compute_intensity()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        assert [len(ls) for ls in info["losses"]] == steps
        ms_level = [1e3 * s for s in info["level_seconds"]]
        center_err, corner_err, angle_err = registration_error(
            rigid.matrix, mia.Data.image[rigid.reference_name], truth)
        final = [float(ls[-1]) for ls in info["losses"]]
        assert all(np.isfinite(final))
        assert center_err <= 0.5 and angle_err <= 0.3, \
            f"registration missed: {center_err:.3f} mm, {angle_err:.3f} deg"
        rows[run] = dict(wall_ms=wall_ms,
                         prep_ms={k: 1e3 * s
                                  for k, s in info["prep_seconds"].items()},
                         ms_per_level=ms_level,
                         ms_per_step=[m / n for m, n in zip(ms_level, steps)],
                         final_loss_per_level=final,
                         center_err_mm=center_err, corner_err_mm=corner_err,
                         angle_err_deg=angle_err)
    emit("rigid", limit_mm=0.5, limit_deg=0.3, **rows)
    return rigid, rows["warm"]


def phase_reslice(rigid, dev):
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.resample import reslice_grid
    from medicalimageanalysis_torch.ops.warp import warp_affine_plain

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = rigid.create_image()
    seconds = time.perf_counter() - t0
    mov = Data.image[rigid.moving_name]
    ref = Data.image[rigid.reference_name]
    A, shape, lo, _ = reslice_grid(mov.array.shape, mov.matrix, mov.spacing,
                                   mov.origin, rigid.matrix, ref.spacing)
    vol = torch.as_tensor(mov.array, device=dev).to(torch.float32)[None]
    plain = warp_affine_plain(vol, [float(v) for v in A[:3].reshape(-1)],
                              shape, -3001.0)[0].cpu().numpy()
    arr = out["array"]
    assert arr.shape == shape and np.isfinite(arr).all()
    assert np.array_equal(arr, plain), "create_image != plain reslice"
    assert np.allclose(out["origin"], lo)
    inside = float((arr != -3001.0).mean())
    assert inside > 0.8, f"reslice is mostly background ({inside})"
    emit("reslice", ms=1e3 * seconds, out_shape=list(shape),
         equal_to_plain=True, inside_share=inside)


def known_pose_volume(ref_vol, ref, pose, dev):
    """The reference resampled on the card at a known pose (angles in
    degrees about x, y, z, then a translation in mm, about the reference
    centre), its edge voxels carried outwards (the sample coordinates
    clamped to the volume, as write_pair's scipy resample does with
    mode="nearest"; a background fill would give the moving volume a
    border the reference lacks, and bias the registration). Returns
    (int16 numpy volume on the reference grid, its reference -> moving
    matrix, models.rigid_intensity.pose_to_matrix of the pose)."""
    from medicalimageanalysis_torch.models.rigid_intensity import (
        pose_to_matrix)
    from medicalimageanalysis_torch.ops import geometry as geo
    from medicalimageanalysis_torch.ops.warp import affine_coords, field_warp

    p = np.concatenate([np.deg2rad(pose[:3]), pose[3:]]).astype(np.float32)
    truth = pose_to_matrix(torch.as_tensor(p), torch.as_tensor(
        np.asarray(ref.compute_center(), np.float32))).numpy() \
        .astype(np.float64)
    pix2pos = geo.pixel_to_position_matrix(ref.matrix, ref.spacing,
                                           ref.origin)
    # moving pixel -> physical -> reference physical (truth^-1) -> pixel
    A = np.linalg.inv(pix2pos) @ np.linalg.inv(truth) @ pix2pos
    cz, cy, cx = affine_coords(torch.as_tensor(A, dtype=torch.float32,
                                               device=dev), SHAPE)
    cz, cy, cx = (c.clamp(0, n - 1).contiguous()
                  for c, n in zip((cz, cy, cx), SHAPE))
    out = field_warp(ref_vol, cz, cy, cx)
    return out.round().clamp(-1024, 3071).to(torch.int16).cpu().numpy(), \
        truth


def phase_cohort_rigid(names, truth, rigid, dev):
    """The cohort rigid at full size: P = 4 pairs of 128 x 512 x 512 int16
    (the phantom pair, and the reference resampled on the card at three
    known poses), all 8 volumes normalised on the card (bit-equal to the
    host recipe, which also runs and is timed), then
    register_rigid_intensity_batch (each pair within the phase_rigid
    limits of its truth and equal to its single-pair descent), then 10
    make_registration_step steps at B = 4, stride 2. Returns the batch
    inputs (for a profile of one level) and the batch's poses, losses and
    ms (for the multi-device path's mesh= call)."""
    from types import SimpleNamespace

    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.models import rigid_intensity as ri
    from medicalimageanalysis_torch.ops import geometry as geo
    from medicalimageanalysis_torch.ops.volume import stored_to_float
    from medicalimageanalysis_torch.parallel.batch import (
        make_registration_step)

    ref, mov = Data.image[names["ref"]], Data.image[names["mov"]]
    ref_vol = torch.as_tensor(ref.array, device=dev).to(torch.float32)
    pairs = [(mov.array, mov, truth)]
    for pose in COHORT_POSES:
        arr, known = known_pose_volume(ref_vol, ref, np.asarray(pose), dev)
        pairs.append((arr, SimpleNamespace(array=arr, matrix=ref.matrix,
                                           spacing=ref.spacing,
                                           origin=ref.origin), known))
    del ref_vol

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    # the normalisation: every volume on the card, each held bit-equal to
    # the host recipe of models/rigid_intensity (numpy on this machine),
    # run here split into its cast, percentile and quantisation
    def device_normalise(a):
        vol, up = timed(lambda: stored_to_float(a, dev))
        bounds, pct = timed(lambda: ri._percentile_bounds(vol))
        codes, quant = timed(lambda: ri._quantize(vol, *bounds))
        return codes, dict(upload=up, percentile=pct, quantize=quant)

    host_ms = dict(cast=0.0, percentile=0.0, quantize=0.0)
    dev_ms = dict(upload=0.0, percentile=0.0, quantize=0.0)
    host_codes, refs, movs = {}, [], []
    for k, arr in enumerate([ref.array] * len(pairs)
                            + [a for a, _, _ in pairs]):
        key = "ref" if k < len(pairs) else k     # the 4 refs are one volume
        if key not in host_codes:
            a, ms = timed(lambda: arr.astype(np.float32))
            host_ms["cast"] += ms
            (lo, hi), ms = timed(lambda: np.percentile(a, [2, 98]))
            host_ms["percentile"] += ms
            host_codes[key], ms = timed(lambda: (np.clip(
                (a - lo) / max(hi - lo, 1e-6), 0, 1) * 65535.0 + 0.5)
                .astype(np.uint16))
            host_ms["quantize"] += ms
            del a
        codes, ms = device_normalise(arr)
        for step, v in ms.items():
            dev_ms[step] += v
        assert np.array_equal(codes.cpu().numpy().astype(np.uint16),
                              host_codes[key]), \
            f"volume {k}: device normalisation != host recipe"
        (refs if k < len(pairs) else movs).append(codes)
    n_host = len(host_codes)
    n_dev = len(refs) + len(movs)
    host_codes.clear()

    ref_pix2pos = geo.pixel_to_position_matrix(
        ref.matrix, ref.spacing, ref.origin).astype(np.float32)
    mov_pos2pix = np.stack([geo.position_to_pixel_matrix(
        img.matrix, img.spacing, img.origin).astype(np.float32)
        for _, img, _ in pairs])
    center = np.asarray(ref.compute_center(), np.float32)
    P = len(pairs)
    geo_in = (np.stack([ref_pix2pos] * P), mov_pos2pix,
              np.stack([center] * P))
    scale = 1.0 / 65535.0
    (poses, losses), batch_ms = timed(
        lambda: ri.register_rigid_intensity_batch(
            refs, movs, *geo_in, levels=RIGID_LEVELS, intensity_scale=scale))
    steps = sum(s for _, s, _ in RIGID_LEVELS)
    rows = []
    for p, (arr, img, known) in enumerate(pairs):
        M = ri.pose_to_matrix(torch.as_tensor(poses[p]),
                              torch.as_tensor(center)).numpy() \
            .astype(np.float64)
        center_err, corner_err, angle_err = registration_error(M, ref, known)
        if p == 0:            # phase_rigid's warm call of this pair
            single = np.asarray(rigid.misc["intensity_info"]["pose"],
                                np.float32)
        else:
            _, info = ri.register_rigid_intensity(ref, img, device=dev)
            single = info["pose"]
        rows.append(dict(center_err_mm=center_err, corner_err_mm=corner_err,
                         angle_err_deg=angle_err, final_loss=float(losses[p]),
                         single_pose_max_diff=float(np.abs(
                             single - poses[p]).max())))
    worst_single = max(r["single_pose_max_diff"] for r in rows)

    # the batched step on the same volumes, unit geometry, B = 4
    def dequantised(codes):
        return torch.stack([c.to(torch.float32) * scale for c in codes])

    ref_b, mov_b = dequantised(refs), dequantised(movs)
    step, init = make_registration_step(SHAPE, lr=STEP_LR, stride=2,
                                        device=dev)
    params, state = init(P)
    step_losses, step_ms = [], []
    for _ in range(10):
        (params, state, loss), ms = timed(
            lambda: step(params, state, ref_b, mov_b))
        step_losses.append(float(loss))
        step_ms.append(ms)
    # one more step, recorded: the batched points' keys timed
    step_rows = recorded_rows(lambda: step(params, state, ref_b, mov_b),
                              dev)
    del ref_b, mov_b
    torch.cuda.empty_cache()
    emit("cohort_rigid", pairs=P, shape=list(SHAPE),
         numpy=np.__version__, poses_deg_mm=[list(p) for p in COHORT_POSES],
         normalisation_bit_equal=True,
         prep_ms_host_per_volume={k: v / n_host for k, v in host_ms.items()},
         prep_ms_device_per_volume={k: v / n_dev for k, v in dev_ms.items()},
         batch_ms=batch_ms, ms_per_pair=batch_ms / P,
         ms_per_step=batch_ms / (P * steps), limit_mm=0.5, limit_deg=0.3,
         single_pose_limit=1e-4, per_pair=rows,
         step_losses=step_losses, step_ms=step_ms)
    for p, r in enumerate(rows):
        assert r["center_err_mm"] <= 0.5 and r["angle_err_deg"] <= 0.3, \
            f"cohort pair {p} missed: {r}"
    assert worst_single <= 1e-4, f"batch != single-pair descent: {rows}"
    assert step_losses[-1] < step_losses[0], step_losses
    return refs, movs, geo_in, dict(poses=poses, losses=losses,
                                    batch_ms=batch_ms, warp_rows=step_rows)


def ia_timed(fn, dev):
    """(fn(), its wall ms with the card synchronised on both sides)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, 1e3 * (time.perf_counter() - t0)


def affine_coef(A):
    """The 12 coefficients affine_resample hands the ``affine`` launch for
    the output -> input pixel map A."""
    return [float(v) for v in np.asarray(A, np.float32)[:3].reshape(-1)]


def affine_plain(vol, A, out_shape, background):
    """The plain twin of the ``affine`` launch affine_resample makes for
    the map A, on vol's device."""
    from medicalimageanalysis_torch.ops.warp import warp_affine_plain

    return warp_affine_plain(vol[None].contiguous(), affine_coef(A),
                             tuple(int(s) for s in out_shape),
                             float(background))[0]


def held_equal(what, out, plain):
    """Assert an entry point's numpy result bit-equal to its plain twin
    computed on the card; returns the max |difference| (0)."""
    got = torch.as_tensor(out, device=plain.device)
    assert got.shape == plain.shape, (what, got.shape, plain.shape)
    assert torch.equal(got, plain), \
        f"{what}: entry point != plain affine ({max_abs(got, plain)})"
    return 0.0


def ia_resample(img_name, dose_name, dev):
    """Image.resample_to (the CT onto the dose grid; the dose, registered
    as an image by CreateImageFromMask, onto the CT), create_rotated_volume
    about the PTV and compute_projection (MIP, mean and DRR, rotated), each
    bit-equal to the plain affine twin on the card and timed (the call,
    host copies included); the kernel alone timed at the dose grid."""
    from medicalimageanalysis_torch.config import config
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.resample import compose_pixel_matrix
    from medicalimageanalysis_torch.structure.image import (clamp_to_air,
                                                            project)
    from medicalimageanalysis_torch.utils.creation import CreateImageFromMask

    ct, dose = Data.image[img_name], Data.dose[dose_name]
    vol = torch.as_tensor(np.asarray(ct.array, np.float32), device=dev)
    ms, errs = {}, {}
    dose_shape = tuple(int(n) for n in dose.dimensions)
    out, ms["ct_to_dose_grid"] = ia_timed(lambda: ct.resample_to(dose), dev)
    A = compose_pixel_matrix(ct.matrix, ct.spacing, ct.origin, dose.matrix,
                             dose.spacing, dose.origin)
    errs["ct_to_dose_grid"] = held_equal("resample_to(dose)", out,
                                         affine_plain(vol, A, dose_shape,
                                                      -3001.0))

    darr = np.asarray(dose.array, np.float32)
    CreateImageFromMask(darr, list(np.asarray(dose.origin, float)),
                        list(np.asarray(dose.spacing, float)), "Dose grid",
                        modality="RTDOSE").add_image()
    dimg = Data.image["Dose grid"]
    assert np.allclose(dimg.matrix, dose.matrix)
    out, ms["dose_to_ct"] = ia_timed(
        lambda: dimg.resample_to(img_name, background=0.0), dev)
    A = compose_pixel_matrix(dimg.matrix, dimg.spacing, dimg.origin,
                             ct.matrix, ct.spacing, ct.origin)
    errs["dose_to_ct"] = held_equal(
        "resample_to(ct)", out,
        affine_plain(torch.as_tensor(darr, device=dev), A, SHAPE, 0.0))
    Data.delete_image("Dose grid")

    ptv = ct.rois["PTV"]
    if ptv.mesh is None:
        ptv.create_discrete_mesh()
    out, ms["rotated_volume"] = ia_timed(
        lambda: ct.create_rotated_volume(angles=ROTATE_DEG, roi_name="PTV"),
        dev)
    errs["rotated_volume"] = held_equal(
        "create_rotated_volume", out,
        affine_plain(vol, ct._rotation_pixel_matrix(
            ROTATE_DEG, ptv.mesh.center), SHAPE, 0.0))
    rotated = clamp_to_air(affine_plain(
        vol, ct._rotation_pixel_matrix(PROJECTION_DEG, np.asarray(
            ct.compute_center(), np.float64)),
        SHAPE, config.background_fill))
    projections = {}
    for mode in ("mip", "mean", "drr"):
        out, ms[f"projection_{mode}"] = ia_timed(
            lambda: ct.compute_projection(mode=mode, axis="y",
                                          angles=PROJECTION_DEG), dev)
        errs[f"projection_{mode}"] = held_equal(
            f"compute_projection({mode})", out,
            project(rotated, mode, 1, ct.spacing))
        assert np.isfinite(out).all()
        projections[mode] = [float(out.min()), float(out.max())]
    assert 0.0 <= projections["drr"][0] and projections["drr"][1] < 1.0
    del vol, rotated
    row = dict(ms=ms, max_abs_err=errs, dose_shape=list(dose_shape),
               projection_range=projections)
    emit("image_analysis_resample", **row)
    return row


def affine_at_dose_grid(img_name, dose_name, dev):
    """After the image-analysis path's launch window: the ``affine``
    launch of resample_to(dose) against its plain twin on the same
    tensors (bit-equal), timed with its bound (affine_bound: the CT
    voxels the taps of its samples inside the volume touch read once, the
    samples written, 30 float32 operations each) and beside F.grid_sample
    at the same samples. Returns the kernel row, the kernel it counts
    under (ops/warp.affine_path) and its launch_key."""
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.resample import compose_pixel_matrix
    from medicalimageanalysis_torch.ops.warp import (affine_coords,
                                                     affine_path)

    ct, dose = Data.image[img_name], Data.dose[dose_name]
    vol = torch.as_tensor(np.asarray(ct.array, np.float32), device=dev)
    A = compose_pixel_matrix(ct.matrix, ct.spacing, ct.origin, dose.matrix,
                             dose.spacing, dose.origin)
    shape = tuple(int(n) for n in dose.dimensions)
    op = torch.ops.mia_torch.warp_affine
    coef, volb = affine_coef(A), vol[None].contiguous()
    k = op(volb, coef, list(shape), -3001.0)[0]
    err = max_abs(k, affine_plain(vol, A, shape, -3001.0))
    assert err == 0.0, f"affine at the dose grid: kernel != plain ({err})"
    kernel = affine_path(coef)
    row = dict(max_abs_err=err, shape=list(shape), path=kernel,
               ms=cuda_ms(lambda: op(volb, coef, list(shape), -3001.0)),
               plain_ms=cuda_ms(lambda: affine_plain(vol, A, shape,
                                                     -3001.0),
                                reps=3, warmup=1))
    cz, cy, cx = affine_coords(torch.as_tensor(np.asarray(A, np.float32),
                                               device=dev), shape)
    # F.grid_sample of the CT at the same samples
    row["library_ms"] = library_sample_ms(vol[None], cz, cy, cx)
    del cz, cy, cx
    row["bound_ms"], row["bound_by"], row["taps"] = affine_bound(
        volb, coef, shape)
    emit("affine_at_dose_grid", tolerance=0.0, **row)
    del vol, volb, k
    torch.cuda.empty_cache()
    return row, kernel, timed_key(1, False, shape, ct.array.shape)


def ia_display(names, dev):
    """The demons field of the deformable path through the Deformable
    Display: DISPLAY_DIVISION frames (the last bit-equal to create_image,
    which launches outside the path's counts), the field's component
    planes against the field itself, and the queries. Returns the row and
    a closure computing the frames again."""
    from medicalimageanalysis_torch.data import Data

    deform = Data.deformable[f"DVF_{names['ref']}_{names['deformed']}"]
    display = deform.display

    def frames():
        display.array = []
        display.compute_deformation(division=DISPLAY_DIVISION)

    _, frames_ms = ia_timed(frames, dev)
    assert len(display.array) == DISPLAY_DIVISION
    with uncounted():
        full, full_ms = ia_timed(deform.create_image, dev)
    assert np.array_equal(display.array[-1], full["array"]), \
        "Display frame at ratio 1 != create_image"
    fixed = Data.image[names["ref"]].array.astype(np.float32)
    moving = Data.image[names["deformed"]].array.astype(np.float32)
    body = fixed > -900.0
    # each frame's residual against the fixed image, for information
    ratios = [residual_ratio(f, moving, fixed, body) for f in display.array]
    assert all(np.isfinite(f).all() and f.shape == SHAPE
               for f in display.array)
    display.compute_slice_location()
    dvf = np.asarray(deform.dvf)
    loc = [int(v) for v in display.slice_location]
    cuts = {"Axial": np.s_[loc[0]], "Coronal": np.s_[:, loc[1]],
            "Sagittal": np.s_[:, :, loc[2]]}
    planes_ms = {}
    for plane in PLANES:
        for k, vector in enumerate("xyz"):
            g, planes_ms[f"{plane}_{vector}"] = ia_timed(
                lambda: deform.retrieve_grid(plane, vector), dev)
            assert np.array_equal(g, dvf[cuts[plane]][..., k])
        frame = deform.retrieve_array_plane(plane, solo=True)
        assert np.array_equal(frame, display.array[0][cuts[plane]])
    queries = {p: dict(offset=deform.retrieve_offset(p),
                       location=int(deform.retrieve_slice_location(p)),
                       scroll_max=int(deform.retrieve_scroll_max(p)),
                       aspect=float(deform.compute_aspect(p)))
               for p in PLANES}
    display.array = []
    row = dict(division=DISPLAY_DIVISION, frames_ms=frames_ms,
               create_image_ms=full_ms, residual_ratio_per_frame=ratios,
               grid_ms=planes_ms, queries=queries)
    emit("image_analysis_display", **row)
    return row, lambda: (frames(), display.array.clear())


def pet_phantom():
    """(stored int16 (Z, Y, X), origin mm): the body, an elliptic cylinder
    of PET_BACKGROUND_BQML varying by up to 20 % in z, and the hot
    spheres, on a grid centred at the origin's opposite corner."""
    Z, Y, X = PET_SHAPE
    sx, sy, sz = PET_SPACING
    origin = -np.array([(X - 1) * sx, (Y - 1) * sy, (Z - 1) * sz]) / 2
    z = origin[2] + sz * np.arange(Z)[:, None, None]
    y = origin[1] + sy * np.arange(Y)[None, :, None]
    x = origin[0] + sx * np.arange(X)[None, None, :]
    act = np.where((x / 170.0) ** 2 + (y / 110.0) ** 2 <= 1.0,
                   PET_BACKGROUND_BQML * (1.0 + 0.2 * np.sin(z / 90.0)), 0.0)
    act = np.broadcast_to(act, PET_SHAPE).copy()
    for (cx, cy, cz), r, bq in PET_SPHERES:
        act[(x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 <= r * r] = bq
    return np.round(act / PET_SLOPE).astype(np.int16), origin


def write_pet(folder):
    from medicalimageanalysis_torch.dicom import Dataset, Sequence
    from medicalimageanalysis_torch.utils.creation import CreateDicomImage

    raw, origin = pet_phantom()
    info = Dataset()
    info.RadionuclideTotalDose = PET_DOSE_BQ
    info.RadionuclideHalfLife = PET_HALF_LIFE_S
    info.RadiopharmaceuticalStartTime = PET_START
    CreateDicomImage(folder, raw, series=PET_UID, origin=list(origin),
                     spacing=PET_SPACING[:2], thickness=PET_SPACING[2]).run(
        patient_id="SMOKE", modality="PT", rescale_slope=PET_SLOPE,
        extra_tags={"Units": "BQML", "DecayCorrection": "START",
                    "SeriesTime": PET_SERIES_TIME,
                    "PatientWeight": PET_WEIGHT_KG,
                    "RadiopharmaceuticalInformationSequence":
                        Sequence([info])})


def numpy_texture_counts(lev, mask, ng, lmax, alpha=0):
    """Texture counts of levels ``lev`` under ``mask`` in numpy, by another
    route than the port's: every voxel's GLCM pair and 26 neighbours read
    from a padded copy, every run walked forward from its first voxel.
    Returns glcm (13, ng, ng), glrlm (13, ng, lmax), gldm (ng, 27),
    ngtdm_n, hist (ng,) as float64 counts and ngtdm_s (ng,) float64."""
    from medicalimageanalysis_torch.ops.radiomics import DIRECTIONS_13

    lp = np.full(tuple(n + 2 for n in lev.shape), -1, np.int64)
    lp[1:-1, 1:-1, 1:-1] = np.where(mask, lev, -1)
    vz, vy, vx = np.nonzero(mask)
    lv = lev[mask].astype(np.int64)
    glcm = np.zeros((13, ng, ng))
    glrlm = np.zeros((13, ng, lmax))
    for k, (dz, dy, dx) in enumerate(DIRECTIONS_13):
        prev = lp[vz - dz + 1, vy - dy + 1, vx - dx + 1]
        ok = prev >= 0
        np.add.at(glcm[k], (lv[ok], prev[ok]), 1.0)
        glcm[k] += glcm[k].T.copy()
        first = np.flatnonzero(~(ok & (prev == lv)))
        pos = np.stack([vz[first], vy[first], vx[first]], 1)
        length = np.ones(first.size, np.int64)
        walking = np.arange(first.size)
        while walking.size:
            pos[walking] += (dz, dy, dx)
            nxt = lp[pos[walking, 0] + 1, pos[walking, 1] + 1,
                     pos[walking, 2] + 1]
            walking = walking[nxt == lv[first[walking]]]
            length[walking] += 1
        np.add.at(glrlm[k], (lv[first], length - 1), 1.0)
    dep = np.zeros(lv.size, np.int64)
    nsum = np.zeros(lv.size)
    ncount = np.zeros(lv.size, np.int64)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if not (dz or dy or dx):
                    continue
                nb = lp[vz + dz + 1, vy + dy + 1, vx + dx + 1]
                ok = nb >= 0
                dep += ok & (np.abs(nb - lv) <= alpha)
                nsum += np.where(ok, nb + 1, 0)
                ncount += ok
    gldm = np.zeros((ng, 27))
    np.add.at(gldm, (lv, dep), 1.0)
    has = ncount > 0
    s = np.zeros(ng)
    np.add.at(s, lv[has], np.abs(lv[has] + 1 - nsum[has] / ncount[has]))
    return {"glcm": glcm, "glrlm": glrlm, "gldm": gldm, "ngtdm_s": s,
            "ngtdm_n": np.bincount(lv[has], minlength=ng).astype(float),
            "hist": np.bincount(lv, minlength=ng).astype(float)}


def radiomics_pin(image, roi_name, values, bin_width, dev):
    """Image.compute_radiomics of one ROI; the texture matrices it counted
    on the card against numpy_texture_counts of the same crop: counts
    bit-equal, ngtdm_s to 1e-6 relative. Returns its row and the counted
    inputs (for the profile)."""
    from medicalimageanalysis_torch.ops import radiomics

    with recording(radiomics, "texture_matrices") as seen:
        out, ms = ia_timed(lambda: image.compute_radiomics(
            roi_name, values=values, bin_width=bin_width), dev)
    assert len(seen) == 1
    mask = np.asarray(image.rois[roi_name].compute_mask()) > 0
    vals = np.asarray(image.array if values is None else values, np.float32)
    _, _, cvol, cm = radiomics._crop(vals, mask)
    levels, ng = radiomics.discretize(cvol, cm, bin_width=bin_width)
    assert ng == out["meta"]["Ng"] and int(cm.sum()) == out["meta"]["voxels"]
    ref, ref_ms = ia_timed(lambda: numpy_texture_counts(
        levels, cm, ng, max(levels.shape)), "cpu")
    got = seen[0]
    for key in ("glcm", "glrlm", "gldm", "ngtdm_n", "hist"):
        assert np.array_equal(got[key], ref[key]), \
            f"{roi_name} {key}: card counts != numpy count"
    s_err = float(np.abs(got["ngtdm_s"] - ref["ngtdm_s"]).max()
                  / max(ref["ngtdm_s"].max(), 1e-30))
    assert s_err <= 1e-6, f"{roi_name} ngtdm_s: {s_err}"
    for fam, feats in out.items():
        if fam != "meta":
            assert all(np.isfinite(v) for v in feats.values()), (fam, feats)
    return dict(ms=ms, numpy_count_ms=ref_ms, voxels=out["meta"]["voxels"],
                crop=[int(n) for n in cm.shape], Ng=ng,
                ngtdm_s_rel_err=s_err, counts_equal=True,
                glcm_contrast=out["glcm"]["Contrast"],
                mesh_volume_cc=out["shape"]["MeshVolume"] / 1000.0), \
        (levels, cm, ng)


def ia_pet(folder, img_name, dev):
    """A whole-body PT series written and read: compute_suv against a
    float64 host reading of the same tags; compute_mtv_tlg of the largest
    sphere's ROI at an absolute and a relative cut against its known
    voxels; compute_radiomics of that lesion (on SUV) and of the CT's PTV
    (on HU), their counts pinned against numpy."""
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.utils.metrics import voxel_volume_cc

    write_pet(folder)
    _, read_ms = ia_timed(lambda: mia.read_dicoms(folder_path=folder,
                                                  clear=False, device=dev),
                          dev)
    name = [n for n in Data.image_list if Data.image[n].series_uid == PET_UID]
    assert len(name) == 1, Data.image_list
    pet = Data.image[name[0]]
    assert pet.array.shape == PET_SHAPE and pet.array.dtype == np.float32
    suv, suv_ms = ia_timed(pet.compute_suv, dev)
    decayed = PET_DOSE_BQ * 2.0 ** (-3600.0 / PET_HALF_LIFE_S)
    scale = PET_WEIGHT_KG * 1000.0 / decayed
    expect = pet.array.astype(np.float64) * scale
    suv_err = float(np.abs(suv - expect).max() / expect.max())
    assert suv_err <= 1e-6, f"compute_suv: {suv_err} relative"

    (cx, cy, cz), r, _ = PET_SPHERES[0]
    Z, Y, X = PET_SHAPE
    o = np.asarray(pet.origin, np.float64)
    sp = np.asarray(pet.spacing, np.float64)
    z = o[2] + sp[2] * np.arange(Z)[:, None, None]
    y = o[1] + sp[1] * np.arange(Y)[None, :, None]
    x = o[0] + sp[0] * np.arange(X)[None, None, :]
    d2 = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2
    pet.create_roi(name="Lesion", color=[255, 0, 0])
    pet.rois["Lesion"].convert_mask(
        (d2 <= (r + PET_ROI_MARGIN_MM) ** 2).astype(np.uint8))
    roi = np.asarray(pet.rois["Lesion"].compute_mask()) > 0
    sphere = (d2 <= r * r) & roi
    voxel_cc = voxel_volume_cc(pet.spacing)
    mtv = {}
    for label, threshold, relative in (("absolute", SUV_CUT, False),
                                       ("relative", SUV_RELATIVE, True)):
        got, ms = ia_timed(lambda: pet.compute_mtv_tlg(
            "Lesion", suv=suv, threshold=threshold, relative=relative),
            dev)
        inside = expect[roi]
        cut = threshold * (inside.max() if relative else 1.0)
        hot = inside[inside >= cut]
        assert hot.size == int(sphere.sum()), (label, hot.size)
        known = dict(mtv_cc=hot.size * voxel_cc, tlg=hot.sum() * voxel_cc,
                     suv_max=inside.max())
        assert got["mtv_cc"] == known["mtv_cc"], (label, got, known)
        for key in ("tlg", "suv_max"):
            assert abs(got[key] - known[key]) <= 1e-6 * known[key], \
                (label, key, got[key], known[key])
        mtv[label] = dict(got, ms=ms, known_tlg=known["tlg"],
                          sphere_cc=4.0 / 3.0 * np.pi * r ** 3 / 1000.0)
    assert abs(mtv["absolute"]["mtv_cc"] - mtv["absolute"]["sphere_cc"]) \
        <= 0.1 * mtv["absolute"]["sphere_cc"]
    lesion, _ = radiomics_pin(pet, "Lesion", suv, PET_BIN_SUV, dev)
    ptv, tex_inputs = radiomics_pin(Data.image[img_name], "PTV", None,
                                    PTV_BIN_HU, dev)
    drop_structures(["Lesion"])
    Data.delete_image(name[0])
    row = dict(shape=list(PET_SHAPE), read_ms=read_ms, suv_ms=suv_ms,
               suv_rel_err=suv_err, suv_max=float(suv.max()), mtv_tlg=mtv,
               radiomics_lesion=lesion, radiomics_ptv=ptv)
    emit("image_analysis_pet", **row)
    return row, tex_inputs


def mr_phantom(seed, shape=MR_SHAPE):
    """(volume, truth, bias) on ``shape``: tests/test_n4.py's biased volume
    (two tissue classes, 15 of noise, a smooth polynomial log-bias)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape],
                             indexing="ij")
    logb = 0.25 * zz + 0.18 * yy * xx - 0.15 * xx ** 2
    truth = np.where(zz ** 2 + yy ** 2 + xx ** 2 < 0.6, 800.0, 300.0)
    del zz, yy
    truth = np.clip(truth + rng.normal(0, 15, shape), 1, None)
    bias = np.exp(logb)
    return truth * bias, truth, bias


def n4_work(shape3, mats_shapes, evals, adjoints):
    """Float32 operations of the einsums an N4 level ran: per B-spline
    evaluation and adjoint, its three contractions (B lanes of Z, Y, X
    voxels on a C, D, E control grid)."""
    Z, Y, X = shape3
    C, D, E = mats_shapes
    ev = 2 * (Z * C * D * E + Z * Y * D * E + Z * Y * X * E)
    adj = 2 * (C * Z * Y * X + C * D * Y * X + C * D * E * X)
    return sum(b * ev for b in evals) + sum(b * adj for b in adjoints)


def ia_mr(folder, dev):
    """An MR with a known bias through Image.correct_bias (shrink 4): the
    recovery bounds of tests/test_n4.py:58-76; the first fitting level at
    full size pinned against the host float64 twin (one iteration, then
    six: tests/test_n4.py's 2e-3 and 1.2e-2); n4_batch of two volumes,
    each lane held to its single-volume field. Returns the row and the
    level's profile closure with the work of its bound."""
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops import n4
    from medicalimageanalysis_torch.parallel.batch import n4_batch
    from medicalimageanalysis_torch.utils.creation import CreateDicomImage

    vol, truth, bias = mr_phantom(SEED)
    CreateDicomImage(folder, np.round(vol).astype(np.int16), series=MR_UID,
                     origin=[-128.0, -128.0, -88.0], spacing=MR_SPACING[:2],
                     thickness=MR_SPACING[2]).run(patient_id="SMOKE",
                                                  modality="MR")
    del vol
    mia.read_dicoms(folder_path=folder, clear=False, device=dev)
    name = [n for n in Data.image_list if Data.image[n].series_uid == MR_UID]
    mr = Data.image[name[0]]
    arr = mr.array.astype(np.float64)
    (corr, field), correct_ms = ia_timed(lambda: mr.correct_bias(
        shrink=MR_SHRINK, control_spacing_mm=MR_CONTROL_SPACING_MM,
        return_field=True), dev)
    ident = float(np.abs(corr * field - arr).max() / arr.max())
    assert np.allclose(arr, corr * field, rtol=2e-3)
    r = field / bias
    r = r / r.mean()
    recovered = float(r.std())
    limit = 0.25 * float(bias.std() / bias.mean())
    bright = truth > 500
    cv_before = float(arr[bright].std() / arr[bright].mean())
    cv_after = float(corr[bright].std() / corr[bright].mean())
    assert recovered < limit, (recovered, limit)
    assert cv_after < 0.45 * cv_before, (cv_after, cv_before)
    del truth, corr

    # one full-size level against the float64 twin, from the same state
    logv, sm = n4._shrunk_log(arr, arr > 0, MR_SHRINK)
    w64 = sm.astype(np.float64)
    shape3 = logv.shape
    floor = [MR_CONTROL_SPACING_MM / s for s in MR_SPACING[::-1]]
    sp_vox = n4._level_spacings(shape3, 4, floor, MR_SHRINK)[0]
    mats = n4._level_basis_mats(shape3, sp_vox, dev)
    mats_host = [n4._bspline_basis_matrix(n, sp_vox[ax], p)
                 for p in (1, 2) for ax, n in enumerate(shape3)]
    res0 = torch.as_tensor(logv.astype(np.float32), device=dev)[None]
    w = torch.as_tensor(sm.astype(np.float32), device=dev)[None]
    pin = {}
    for n_it, tol in ((1, 2e-3), (6, 1.2e-2)):
        (res_d, tot_d), dev_ms = ia_timed(lambda: n4._n4_level(
            res0.clone(), torch.zeros_like(res0), w, 200, 0.15, 0.01, 1e-4,
            n_it, *mats), dev)
        (res_h, tot_h), host_ms = ia_timed(lambda: n4._host_n4_level(
            logv, np.zeros_like(logv), w64, 200, 0.15, 0.01, 1e-4, n_it,
            mats_host), "cpu")
        err = max(float(np.abs(tot_d[0].cpu().numpy() - tot_h).max()),
                  float(np.abs(res_d[0].cpu().numpy() - res_h).max()))
        assert err <= tol, f"N4 level, {n_it} iterations: {err} > {tol}"
        pin[f"iterations_{n_it}"] = dict(max_abs_err=err, tolerance=tol,
                                         ms=dev_ms, host_f64_ms=host_ms)

    # the level as correct_bias runs it, its einsum work counted
    evals, adjoints = [], []
    ev, adj = n4._bspline_eval, n4._bspline_adjoint

    def count_eval(phi, *m):
        evals.append(phi.shape[0])
        return ev(phi, *m)

    def count_adj(v, *m):
        adjoints.append(v.shape[0])
        return adj(v, *m)

    def level():
        return n4._n4_level(res0.clone(), torch.zeros_like(res0), w, 200,
                            0.15, 0.01, 1e-3, 50, *mats)


    n4._bspline_eval, n4._bspline_adjoint = count_eval, count_adj
    try:
        level()
    finally:
        n4._bspline_eval, n4._bspline_adjoint = ev, adj
    ctrl = tuple(int(m.shape[1]) for m in mats[:3])
    work = dict(voxels=int(np.prod(shape3)), control_grid=list(ctrl),
                fits=len(adjoints) - len(evals),
                cg_evaluations=len(evals),
                ops=n4_work(shape3, ctrl, evals, adjoints))

    vol2, _, bias2 = mr_phantom(SEED + 1)
    vol2 = np.round(vol2).astype(np.float32)
    batch = np.stack([mr.array.astype(np.float32), vol2])
    (_, fields), batch_ms = ia_timed(lambda: n4_batch(
        batch, shrink=MR_SHRINK, min_control_spacing=floor,
        return_fields=True, device=dev), dev)
    (_, field2), single_ms = ia_timed(lambda: n4.n4_bias_correction(
        vol2, shrink=MR_SHRINK, min_control_spacing=floor,
        return_field=True, device=dev), dev)
    del vol2, batch
    lanes = []
    for lane, single in zip(fields, (field, field2)):
        ratio = lane.astype(np.float64) / single
        lanes.append([float(ratio.mean()), float(ratio.std())])
        # tests/test_n4.py's n4_batch rule: each lane its single call's
        assert abs(lanes[-1][0] - 1.0) < 2e-3 and lanes[-1][1] < 5e-3, lanes
    r2 = fields[1] / bias2
    r2 = r2 / r2.mean()
    recovered2 = float(r2.std())
    assert recovered2 < 0.25 * float(bias2.std() / bias2.mean()), recovered2
    Data.delete_image(name[0])
    row = dict(shape=list(MR_SHAPE), shrink=MR_SHRINK, correct_ms=correct_ms,
               identity_rel_err=ident, field_std_after=recovered,
               field_std_limit=limit, cv_bright_before=cv_before,
               cv_bright_after=cv_after, level_pin=pin,
               control_spacing_mm=MR_CONTROL_SPACING_MM,
               n4_batch_ms=batch_ms, n4_batch_volumes=2,
               n4_single_ms=single_ms, n4_batch_lane_ratio=lanes,
               n4_batch_lane1_field_std=recovered2)
    emit("image_analysis_mr", **row)
    return row, level, work


def fourd_phase(k):
    """Phase k of the breathing phantom (int16 HU): a body with two
    lungs, the tumour sphere moving FOURD_AMPLITUDE_MM in z and 3 mm in
    y over the cycle; and the tumour's mask."""
    Z, Y, X = FOURD_SHAPE
    sx, sy, sz = FOURD_SPACING
    z = (np.arange(Z) - (Z - 1) / 2)[:, None, None] * sz
    y = (np.arange(Y) - (Y - 1) / 2)[None, :, None] * sy
    x = (np.arange(X) - (X - 1) / 2)[None, None, :] * sx
    vol = np.full(FOURD_SHAPE, -1000, np.int16)
    body = np.broadcast_to((x / 200.0) ** 2 + (y / 140.0) ** 2 <= 1,
                           FOURD_SHAPE)
    vol[body] = 40
    for cx in (-90.0, 90.0):
        lung = np.broadcast_to(((x - cx) / 70.0) ** 2 + (y / 90.0) ** 2
                               + (z / 90.0) ** 2 <= 1, FOURD_SHAPE)
        vol[lung] = -820
    t = 2 * np.pi * k / FOURD_PHASES
    tumour = ((x + 90.0) ** 2 + (y - 3.0 * np.sin(t)) ** 2
              + (z - FOURD_AMPLITUDE_MM * np.sin(t)) ** 2
              <= FOURD_TUMOUR_MM ** 2)
    vol[tumour] = 30
    return vol, tumour


def ia_fourd(folder, dev):
    """Ten phases written as one series (TemporalPositionIdentifier) and
    read: find_phase_groups, combine_phases (mean, MIP) against the host
    reductions, per-phase GTVs, compute_itv onto the average (the union)
    and onto a coarser planning grid (one affine resample, held against
    the plain twin on the card)."""
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.resample import compose_pixel_matrix
    from medicalimageanalysis_torch.utils import fourd
    from medicalimageanalysis_torch.utils.creation import (
        CreateDicomImage, CreateImageFromMask)
    from medicalimageanalysis_torch.dicom import generate_uid

    study, frame = generate_uid(), generate_uid()
    Z = FOURD_SHAPE[0]
    origin = [-(n - 1) / 2 * s for n, s in zip(FOURD_SHAPE[::-1],
                                               FOURD_SPACING)]
    vols, gtvs = [], []
    t0 = time.perf_counter()
    for k in range(FOURD_PHASES):
        vol, gtv = fourd_phase(k)
        vols.append(vol)
        gtvs.append(gtv)
        CreateDicomImage(folder, vol, study=study, series=FOURD_UID,
                         frame=frame, origin=origin,
                         spacing=FOURD_SPACING[:2],
                         thickness=FOURD_SPACING[2]).run(
            patient_id="SMOKE", modality="CT", instance_offset=k * Z,
            extra_tags={"TemporalPositionIdentifier": str(k + 1),
                        "NumberOfTemporalPositions": str(FOURD_PHASES)})
    write_s = time.perf_counter() - t0
    _, read_ms = ia_timed(lambda: mia.read_dicoms(
        folder_path=folder, clear=False, device=dev), dev)
    phases = [n for n in Data.image_list
              if Data.image[n].series_uid == FOURD_UID]
    groups, group_ms = ia_timed(lambda: fourd.find_phase_groups(phases),
                                "cpu")
    assert len(groups) == 1 and len(groups[0]) == FOURD_PHASES, groups
    group = groups[0]
    assert [fourd.temporal_sort_key(Data.image[n]) for n in group] == \
        [(0, float(k + 1)) for k in range(FOURD_PHASES)]
    for k, n in enumerate(group):
        assert np.array_equal(Data.image[n].array, vols[k])
    stack = np.stack(vols).astype(np.float64)
    aip, mean_ms = ia_timed(lambda: fourd.combine_phases(group, "mean",
                                                         device=dev), dev)
    mip, mip_ms = ia_timed(lambda: fourd.combine_phases(group, "mip",
                                                        device=dev), dev)
    mean_err = int(np.abs(aip.array.astype(np.int64)
                          - np.rint(stack.mean(0))).max())
    assert mean_err <= 1 and aip.array.dtype == np.int16, mean_err
    assert np.array_equal(mip.array, np.max(np.stack(vols), 0))
    del stack, vols
    t0 = time.perf_counter()
    union = np.zeros(FOURD_SHAPE, bool)
    for k, n in enumerate(group):
        img = Data.image[n]
        img.create_roi(name="GTV", color=[255, 0, 0])
        img.rois["GTV"].convert_mask(gtvs[k].astype(np.uint8))
        union |= np.asarray(img.rois["GTV"].compute_mask()) > 0
    gtv_s = time.perf_counter() - t0
    _, itv_ms = ia_timed(lambda: fourd.compute_itv(
        group, "GTV", target=aip.image_name), dev)
    got = np.asarray(aip.rois["ITV_GTV"].compute_mask()) > 0
    assert np.array_equal(got, union), "ITV on the average != union"
    plan_shape = (Z // 2, FOURD_SHAPE[1] // 2, FOURD_SHAPE[2] // 2)
    CreateImageFromMask(np.zeros(plan_shape, np.int16), origin,
                        [2 * s for s in FOURD_SPACING], "Planning 4D") \
        .add_image()
    plan = Data.image["Planning 4D"]
    _, itv_plan_ms = ia_timed(lambda: fourd.compute_itv(
        group, "GTV", target="Planning 4D"), dev)
    first = Data.image[group[0]]
    A = compose_pixel_matrix(first.matrix, first.spacing, first.origin,
                             plan.matrix, plan.spacing, plan.origin)
    plain = affine_plain(torch.as_tensor(union.astype(np.float32),
                                         device=dev), A, plan_shape,
                         0.0) >= 0.5
    got = torch.as_tensor(np.asarray(plan.rois["ITV_GTV"].compute_mask())
                          > 0, device=dev)
    assert torch.equal(got, plain), "ITV on the planning grid != plain"
    itv_cc = float(union.sum() * np.prod(FOURD_SPACING) / 1000.0)
    drop_structures(["GTV", "ITV_GTV"])
    for n in group + [aip.image_name, mip.image_name, "Planning 4D"]:
        Data.delete_image(n)
    row = dict(phases=FOURD_PHASES, shape=list(FOURD_SHAPE),
               write_s=write_s, read_ms=read_ms, group_ms=group_ms,
               mean_ms=mean_ms, mip_ms=mip_ms, mean_max_err=mean_err,
               gtv_masks_s=gtv_s, itv_ms=itv_ms,
               itv_planning_ms=itv_plan_ms, itv_cc=itv_cc,
               itv_planning_voxels=int(got.sum()))
    emit("image_analysis_fourd", **row)
    return row


def demons_batch_pairs(ref, deformed, dev):
    """demons_batch's two pairs at DEMONS_BATCH_SHAPE from the full-size
    reference and deformed series (host arrays), downsampled on ``dev``:
    (fixed (2, Z, Y, X), moving (2, Z, Y, X), spacing [sx, sy, sz] mm,
    the known fields (2, Z, Y, X, 3) mm). moving(x + d(x)) = fixed(x):
    the reference registered to the deformed series (d the known bump:
    the deformed series is the reference at p + bump) and to the
    reference warped on ``dev`` by the opposite bump (d its opposite)."""
    from medicalimageanalysis_torch.ops.registration.dvf import warp_volume
    from medicalimageanalysis_torch.ops.resample import separable_resample

    def down(arr):
        return separable_resample(torch.as_tensor(
            np.asarray(arr, np.float32), device=dev), DEMONS_BATCH_SHAPE)

    ref, deformed, g = down(ref), down(deformed), down(known_bump())
    sp = [s * n / m for s, n, m in zip(SPACING, SHAPE[::-1],
                                       DEMONS_BATCH_SHAPE[::-1])]
    known = torch.stack([BUMP_MM * g, BUMP_MM * g, torch.zeros_like(g)], -1)
    opposite = warp_volume(ref, -known, sp, background=-1000.0)
    return (torch.stack([deformed, opposite]), torch.stack([ref, ref]), sp,
            torch.stack([known, -known]))


def ia_demons_batch(names, dev):
    """demons_batch of the two demons_batch_pairs, each within the
    deformable path's residual bound (the known field's own ratio beside
    it); the first bit-equal to the single-pair demons_registration. The
    pairs' making and the checks launch outside the path's counts.
    Returns the row and a closure running the batch again."""
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.registration.demons import (
        demons_registration)
    from medicalimageanalysis_torch.ops.registration.dvf import warp_volume
    from medicalimageanalysis_torch.parallel.batch import demons_batch

    with uncounted():
        fixed, moving, sp, known = demons_batch_pairs(
            Data.image[names["ref"]].array,
            Data.image[names["deformed"]].array, dev)

    def batch():
        return demons_batch(fixed, moving, sp, method="fast",
                            iterations=DEMONS_BATCH_ITERATIONS, device=dev)

    dvfs, batch_ms = ia_timed(batch, dev)
    assert dvfs.shape == (2,) + DEMONS_BATCH_SHAPE + (3,)
    ratios, floors = [], []
    with uncounted():
        single, single_ms = ia_timed(lambda: demons_registration(
            fixed[0], moving[0], sp, method="fast",
            iterations=DEMONS_BATCH_ITERATIONS, device=dev), dev)
        assert np.array_equal(dvfs[0], single), \
            "demons_batch != single pair"
        m = moving[0].cpu().numpy()
        for b in range(2):
            f = fixed[b].cpu().numpy()
            body = f > -900.0
            for out, d in ((ratios, dvfs[b]), (floors, known[b])):
                warped = warp_volume(moving[b], d, sp, background=-3001.0)
                out.append(residual_ratio(warped.cpu().numpy(), m, f, body))
    row = dict(pairs=2, shape=list(DEMONS_BATCH_SHAPE), spacing=sp,
               iterations=DEMONS_BATCH_ITERATIONS, ms=batch_ms,
               single_pair_ms=single_ms, residual_ratio=ratios,
               known_field_residual_ratio=floors,
               residual_limit=RESIDUAL_LIMIT)
    emit("image_analysis_demons_batch", **row)
    assert all(r <= RESIDUAL_LIMIT for r in ratios), ratios
    return row, batch


def phase_image_analysis(folder, names, img_name, dose_name, dev):
    """The image-analysis path at full width: resample / rotate / project
    the dose-QA CT, the Deformable Display of the demons field, a
    whole-body PET (SUV, MTV / TLG, radiomics), an MR's N4 correction and
    n4_batch, a 10-phase 4D-CT's average, MIP and ITV, and demons_batch.
    Returns the profile closures (one N4 level, one texture_matrices
    call) with the work of their bounds, and closures running the
    Display's frames and demons_batch again (``warp_calls``)."""
    from medicalimageanalysis_torch.ops import radiomics

    seconds = {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    step("resample", ia_resample, img_name, dose_name, dev)
    _, frames = step("display", ia_display, names, dev)
    _, (levels, cm, ng) = step("pet", ia_pet, os.path.join(folder, "pet"),
                               img_name, dev)
    _, n4_level, n4_work_row = step("mr", ia_mr, os.path.join(folder, "mr"),
                                    dev)
    step("fourd", ia_fourd, os.path.join(folder, "fourd"), dev)
    _, batch = step("demons_batch", ia_demons_batch, names, dev)
    emit("image_analysis", seconds=sum(seconds.values()),
         seconds_per_step=seconds)
    lmax = max(levels.shape)
    tex_work = dict(voxels=int(levels.size), roi_voxels=int(cm.sum()),
                    Ng=ng, Lmax=lmax)
    return dict(profiles={
                    "n4_level": n4_level,
                    "texture_matrices": lambda: radiomics.texture_matrices(
                        levels, cm, ng, device=dev)},
                work=dict(n4_level=n4_work_row, texture_matrices=tex_work),
                warp_calls=dict(display_frames=frames, demons_batch=batch))


def path_bytes(*paths):
    """Bytes of the files at ``paths`` (files, or directories walked)."""
    total = 0
    for p in paths:
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                total += sum(os.path.getsize(os.path.join(root, f))
                             for f in files)
        elif os.path.exists(p):
            total += os.path.getsize(p)
    return total


def io_timed(rows, name, fn, *paths):
    """fn() with the card synchronised on both sides; rows[name] gets its
    ms and the MB of ``paths`` (what it wrote or read) with the rate."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    mb = path_bytes(*paths) / 1e6
    rows[name] = dict(ms=ms, mb=mb, mb_per_s=1e3 * mb / ms)
    return out


def io_rtplan(path, img, dose_sop):
    """An RTPLAN in the shape of tests/test_rtplan.py's fixture, built with
    the port's own Dataset: the prescription, one fraction group of
    IO_FRACTIONS with two beams (IO_BEAMS: name, gantry angle, meterset),
    one control point a beam, and the RTDOSE it references."""
    from medicalimageanalysis_torch.dicom import (Dataset, Sequence,
                                                  dcmwrite, generate_uid,
                                                  uids)

    ds = Dataset()
    ds.SOPClassUID = uids.RTPlanStorage
    ds.SOPInstanceUID = generate_uid()
    ds.SeriesInstanceUID = generate_uid()
    ds.StudyInstanceUID = img.get_study_uid()
    ds.FrameOfReferenceUID = img.frame_ref
    ds.Modality = "RTPLAN"
    ds.PatientID = "SMOKE"
    ds.PatientName = "Smoke^Patient"
    ds.RTPlanLabel = "SmokeVMAT"
    ds.RTPlanName = f"PTV {PRESCRIPTION_GY:g}/{IO_FRACTIONS}"
    ds.ApprovalStatus = "APPROVED"
    dr = Dataset()
    dr.DoseReferenceNumber = 1
    dr.DoseReferenceStructureType = "SITE"
    dr.DoseReferenceType = "TARGET"
    dr.DoseReferenceDescription = "PTV"
    dr.TargetPrescriptionDose = PRESCRIPTION_GY
    ds.DoseReferenceSequence = Sequence([dr])
    refs, beams = [], []
    for number, (name, gantry, mu) in enumerate(IO_BEAMS, start=1):
        rb = Dataset()
        rb.ReferencedBeamNumber = number
        rb.BeamDose = PRESCRIPTION_GY / IO_FRACTIONS / len(IO_BEAMS)
        rb.BeamMeterset = mu
        refs.append(rb)
        cp = Dataset()
        cp.ControlPointIndex = 0
        cp.NominalBeamEnergy = 6.0
        cp.GantryAngle = gantry
        cp.BeamLimitingDeviceAngle = 30.0
        cp.PatientSupportAngle = 0.0
        cp.IsocenterPosition = list(PTV_CENTER_MM)
        b = Dataset()
        b.BeamNumber = number
        b.BeamName = name
        b.BeamType = "DYNAMIC"
        b.RadiationType = "PHOTON"
        b.TreatmentMachineName = "TrueBeam1"
        b.TreatmentDeliveryType = "TREATMENT"
        b.NumberOfControlPoints = 178
        b.FinalCumulativeMetersetWeight = 1.0
        b.ControlPointSequence = Sequence([cp])
        beams.append(b)
    fg = Dataset()
    fg.FractionGroupNumber = 1
    fg.NumberOfFractionsPlanned = IO_FRACTIONS
    fg.NumberOfBeams = len(IO_BEAMS)
    fg.ReferencedBeamSequence = Sequence(refs)
    ds.FractionGroupSequence = Sequence([fg])
    ds.BeamSequence = Sequence(beams)
    rd = Dataset()
    rd.ReferencedSOPClassUID = uids.RTDoseStorage
    rd.ReferencedSOPInstanceUID = dose_sop
    ds.ReferencedDoseSequence = Sequence([rd])
    dcmwrite(path, ds)


def on_card_equal(what, a, b, dev):
    """Assert two arrays (or tensors) bit-equal, compared on the card."""
    ta, tb = (x.to(dev) if torch.is_tensor(x) else torch.as_tensor(
        np.require(x, requirements="W"), device=dev) for x in (a, b))
    assert ta.shape == tb.shape and ta.dtype == tb.dtype, \
        (what, ta.shape, tb.shape, ta.dtype, tb.dtype)
    assert torch.equal(ta, tb), f"{what}: not bit-equal"


def geometry_err(a, b):
    """Largest |difference| of origin, spacing and matrix (mm / unitless)."""
    return max(float(np.abs(np.asarray(getattr(a, k), np.float64)
                            - np.asarray(getattr(b, k), np.float64)).max())
               for k in ("origin", "spacing", "matrix"))


def phase_io(folder, names, img_name, dose_name, rigid, dev):
    """The IO path at full size: the dose-QA CT exported as a DICOM
    series, its structure set as RTSTRUCT and as SEG (the SEG's segments
    under collision-suffixed names, so the read registers both), the
    RTDOSE, an RTPLAN, the fitted rigid's and the demons field's REGs, a
    NIfTI, both registrations' create_image as MHD, and the json + npy
    saves; then one read_dicoms over the DICOM files (with the moving
    series the REGs reference) into a cleared registry, every read-back
    object held against what was written, and the NIfTI, MHD and saved
    folders loaded back. The registry is restored after. Returns the
    path's launches and launch shapes, the histogram's and the warp
    kernels' rows on the path's own tensors, and the profile of the
    deformable REG's read and upload."""
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.dicom import dcmread
    from medicalimageanalysis_torch.ops import hist
    from medicalimageanalysis_torch.read.mhd import read_mhd_volume
    from medicalimageanalysis_torch.read.reg import decode_vector_grid
    from medicalimageanalysis_torch.reader import check_memory
    from medicalimageanalysis_torch.structure.common import collision_suffix
    from medicalimageanalysis_torch.structure.deformable import Deformable
    from medicalimageanalysis_torch.structure.dose import Dose
    from medicalimageanalysis_torch.structure.image import Image
    from medicalimageanalysis_torch.structure.plan import Plan
    from medicalimageanalysis_torch.structure.rigid import Rigid
    from medicalimageanalysis_torch.structure.roi import Roi

    t_phase = time.perf_counter()
    io = os.path.join(folder, "io")
    saved = os.path.join(io, "saved")
    j = lambda *p: os.path.join(io, *p)          # noqa: E731
    ct, dose = Data.image[img_name], Data.dose[dose_name]
    deform = Data.deformable[f"DVF_{names['ref']}_{names['deformed']}"]
    roi_names = list(STRUCTURES)

    # what the read-back is held against, made before the path; its
    # launches count nowhere
    with uncounted():
        before = ct.compute_roi_masks(roi_names)
        ptv_dose, _, _ = dose._roi_dose(img_name, "PTV", dev)
        max_dose = float(ptv_dose.max()) * 1.05 + 1e-6
        _, curve = dose.compute_dvh_curve(img_name, "PTV", n_bins=DVH_BINS,
                                          max_dose=max_dose)
    ct_array = np.asarray(ct.array)
    field = torch.as_tensor(np.asarray(deform.dvf), device=dev)
    dose_gy = torch.as_tensor(np.asarray(dose.array), dtype=torch.float64,
                              device=dev)

    hist_calls, writers, readers = {}, {}, {}
    with recording_hist_calls(hist_calls):
        io_timed(writers, "export_dicom",
                 lambda: ct.export_dicom(j("ct")), j("ct"))
        io_timed(writers, "create_rtstruct",
                 lambda: ct.create_rtstruct(roi_names=roi_names,
                                            path=j("ct", "rs.dcm")),
                 j("ct", "rs.dcm"))
        # the SEG's segments: the structure set under collision-suffixed
        # names, their masks the pooled pass's, so that the read holds
        # RTSTRUCT and SEG ROIs side by side
        aliases = {n: collision_suffix(n, ct.rois) for n in roi_names}
        for n, a in aliases.items():
            ct.rois[a] = Roi(ct, name=a, color=ct.rois[n].color)
            ct._roi_mask_cache_put(a, ct.rois[a], before[n])
        try:
            io_timed(writers, "create_seg",
                     lambda: ct.create_seg(roi_names=list(aliases.values()),
                                           path=j("ct", "seg.dcm")),
                     j("ct", "seg.dcm"))
        finally:
            for a in aliases.values():
                ct.rois.pop(a)
                ct._roi_mask_cache.pop(a, None)
        rd = io_timed(writers, "create_rtdose",
                      lambda: dose.create_rtdose(path=j("ct", "rd.dcm")),
                      j("ct", "rd.dcm"))
        io_timed(writers, "rtplan",
                 lambda: io_rtplan(j("rp.dcm"), ct, rd.SOPInstanceUID),
                 j("rp.dcm"))
        io_timed(writers, "rigid_create_reg",
                 lambda: rigid.create_reg(path=j("reg_rigid.dcm")),
                 j("reg_rigid.dcm"))
        io_timed(writers, "deformable_create_reg",
                 lambda: deform.create_reg(path=j("reg_dvf.dcm")),
                 j("reg_dvf.dcm"))
        io_timed(writers, "create_nifti",
                 lambda: ct.create_nifti(j("ct.nii")), j("ct.nii"))
        io_timed(writers, "rigid_export_image",
                 lambda: rigid.export_image(j("rigid.mhd")),
                 j("rigid.mhd"), j("rigid.raw"))
        io_timed(writers, "deformable_export_image",
                 lambda: deform.export_image(j("dvf.mhd")),
                 j("dvf.mhd"), j("dvf.raw"))
        io_timed(writers, "save_image", lambda: ct.save_image(saved),
                 os.path.join(saved, img_name))
        io_timed(writers, "save_rigid",
                 lambda: rigid.save_rigid(os.path.join(saved, "rigid")),
                 os.path.join(saved, "rigid"))
        io_timed(writers, "save_deformable",
                 lambda: deform.save_deformable(os.path.join(saved, "dvf")),
                 os.path.join(saved, "dvf"))
        io_timed(writers, "dose_save_image", lambda: dose.save_image(saved),
                 os.path.join(saved, dose_name))

        registry = registry_state()
        try:
            Data.clear()
            files = [os.path.join(r, f)
                     for d in (io, os.path.join(folder, "mov"),
                               os.path.join(folder, "deformed"))
                     for r, _, fs in os.walk(d) for f in fs
                     if f.endswith(".dcm")]
            report = io_timed(readers, "read_dicoms", lambda: mia.read_dicoms(
                file_list=files, device=dev), *files).report
            # the registry: the CT and the two series the REGs move, 7
            # RTSTRUCT and 7 SEG ROIs on the CT, one of each other object
            s = report.summary()
            assert s["failed"] == 0 and s["failed_series"] == 0 \
                and s["unmatched_rtstructs"] == 0 \
                and s["unmatched_segs"] == 0, s
            assert len(Data.image_list) == 3 and len(Data.dose_list) == 1 \
                and len(Data.plan_list) == 1 and len(Data.rigid_list) == 1 \
                and len(Data.deformable_list) == 1, s
            ct_b = [Data.image[n] for n in Data.image_list
                    if Data.image[n].series_uid == ct.series_uid]
            assert len(ct_b) == 1, Data.image_list
            ct_b = ct_b[0]
            contoured = sorted(n for n, r in ct_b.rois.items()
                               if r.contour_position is not None)
            assert contoured == sorted(roi_names + list(aliases.values())), \
                contoured
            on_card_equal("CT read back", ct_b.array, ct_array, dev)
            masks = io_timed(readers, "compute_roi_masks",
                             lambda: ct_b.compute_roi_masks(contoured))
            for n in roi_names:
                on_card_equal(f"{n} from the RTSTRUCT", masks[n], before[n],
                              dev)
                on_card_equal(f"{n} from the SEG", masks[aliases[n]],
                              before[n], dev)

            # the dose: the stored integers within DoseGridScaling / 2 of
            # the grid, the grid read back within that plus the reader's
            # float32 roundings (uint32 -> float32 of the stored value, at
            # most 128 below 2^32; DoseGridScaling to float32, 2^-24 of the
            # top dose; the product, half an ulp of the top)
            dose_b = Data.dose[Data.dose_list[0]]
            scaling = float(rd.DoseGridScaling)
            stored = torch.from_numpy(np.frombuffer(rd.PixelData, "<u4")
                                      .astype(np.int64)).to(dev)
            quant = float((stored.reshape(dose_gy.shape).double() * scaling
                           - dose_gy).abs().max())
            assert quant <= scaling / 2, (quant, scaling)
            top = float(dose_gy.max())
            dose_bound = scaling * (0.5 + 128) + 1.0001 * top * 2.0 ** -24 \
                + float(np.spacing(np.float32(top))) / 2
            back = torch.as_tensor(np.asarray(dose_b.array), device=dev,
                                   dtype=torch.float64)
            dose_err = float((back - dose_gy).abs().max())
            assert dose_err <= dose_bound, (dose_err, dose_bound)
            assert geometry_err(dose_b, dose) <= 1e-6
            # the PTV's curve (affine + the histogram): a voxel moves
            # across a bin only where its resampled dose lies within the
            # grid's error, plus 8 float32 ulp of the top for the
            # resample's own rounding, of the bin's threshold
            bins, curve_b = io_timed(readers, "compute_dvh_curve",
                                     lambda: dose_b.compute_dvh_curve(
                                         ct_b.image_name, "PTV",
                                         n_bins=DVH_BINS, max_dose=max_dose))
            near_gy = dose_bound + 8 * float(np.spacing(np.float32(top)))
            thr = torch.as_tensor(bins, dtype=torch.float32, device=dev)
            near = ((ptv_dose[None, :] - thr[:, None]).abs() <= near_gy) \
                .sum(1).cpu().numpy()
            allowed = 100.0 * near / ptv_dose.numel() + 1e-4
            curve_diff = np.abs(curve_b.astype(np.float64)
                                - curve.astype(np.float64))
            assert np.all(curve_diff <= allowed), \
                (curve_diff.max(), allowed[np.argmax(curve_diff - allowed)])

            # the rigid: the matrix from 16-character DS values; its
            # create_image (the affine mode) against the original's, which
            # export_image wrote
            rigid_b = Data.rigid[Data.rigid_list[0]]
            matrix_err = float(np.abs(np.asarray(rigid_b.matrix)
                                      - np.asarray(rigid.matrix)).max())
            assert matrix_err <= 1e-12, matrix_err
            out_r = io_timed(readers, "rigid_create_image",
                             rigid_b.create_image)
            exported_r = read_mhd_volume(j("rigid.mhd"))
            on_card_equal("rigid create_image", out_r["array"],
                          exported_r[0], dev)
            # the deformable: the field, and its create_image (affine,
            # coords, disp) against the original's export
            def_b = Data.deformable[Data.deformable_list[0]]
            assert torch.is_tensor(def_b.dvf) \
                and def_b.dvf.device.type == dev.type
            on_card_equal("deformable field", def_b.dvf, field, dev)
            assert np.array_equal(np.asarray(def_b.rigid_matrix, np.float64),
                                  np.asarray(deform.rigid_matrix,
                                             np.float64))
            out_d = io_timed(readers, "deformable_create_image",
                             def_b.create_image)
            exported_d = read_mhd_volume(j("dvf.mhd"))
            on_card_equal("deformable create_image", out_d["array"],
                          exported_d[0], dev)
            # the plan
            plan = Data.plan[Data.plan_list[0]]
            assert [(b["name"], b["gantry_angle"]) for b in plan.beams] \
                == [(n, g) for n, g, _ in IO_BEAMS], plan.beams
            assert plan.total_beam_meterset() == sum(m for *_, m in IO_BEAMS)
            assert plan.n_fractions == IO_FRACTIONS
            assert plan.target_prescription_dose == PRESCRIPTION_GY
            assert plan.linked_dose_names() == [dose_b.dose_name]
            io_timed(writers, "create_rtplan",
                     lambda: plan.create_rtplan(path=j("rp2.dcm")),
                     j("rp2.dcm"))
            io_timed(writers, "save_plan", lambda: plan.save_plan(saved),
                     os.path.join(saved, plan.plan_name))

            # the rest, loaded into a cleared registry
            read_back = registry_state()
            Data.clear()
            io_timed(readers, "read_nifti", lambda: mia.read_nifti(
                j("ct.nii"), device=dev), j("ct.nii"))
            img_n = Data.image["ct"]
            on_card_equal("NIfTI", img_n.array, ct_array, dev)
            # the sform holds float32: each value within half its ulp
            nifti_err = geometry_err(img_n, ct)
            assert nifti_err <= float(np.spacing(np.float32(
                np.abs(np.asarray(ct.origin)).max()))), nifti_err
            for name, out in (("rigid", out_r), ("dvf", out_d)):
                io_timed(readers, f"read_mhd_{name}", lambda: mia.read_mhd(
                    file=j(f"{name}.mhd"), device=dev),
                    j(f"{name}.mhd"), j(f"{name}.raw"))
                on_card_equal(f"MHD {name}", Data.image[name].array,
                              out["array"], dev)
                assert float(np.abs(np.asarray(Data.image[name].origin)
                                    - np.asarray(out["origin"])).max()) \
                    <= 1e-6
            img_l = io_timed(readers, "load_image", lambda: Image.load_image(
                os.path.join(saved, img_name), device=dev),
                os.path.join(saved, img_name))
            on_card_equal("load_image", img_l.array, ct_array, dev)
            assert geometry_err(img_l, ct) == 0.0
            loaded = img_l.compute_roi_masks(roi_names)
            for n in roi_names:
                on_card_equal(f"{n} loaded", loaded[n], before[n], dev)
            rigid_l = io_timed(readers, "load_rigid", lambda: Rigid.load_rigid(
                os.path.join(saved, "rigid"), device=dev),
                os.path.join(saved, "rigid"))
            assert np.array_equal(rigid_l.matrix, rigid.matrix)
            def_l = io_timed(readers, "load_deformable",
                             lambda: Deformable.load_deformable(
                                 os.path.join(saved, "dvf"), device=dev),
                             os.path.join(saved, "dvf"))
            on_card_equal("load_deformable", def_l.dvf, field, dev)
            dose_l = io_timed(readers, "dose_load_image",
                              lambda: Dose.load_image(
                                  os.path.join(saved, dose_name),
                                  device=dev),
                              os.path.join(saved, dose_name))
            on_card_equal("dose load_image", dose_l.array, dose.array, dev)
            plan_l = io_timed(readers, "load_plan", lambda: Plan.load_plan(
                os.path.join(saved, plan.plan_name)),
                os.path.join(saved, plan.plan_name))
            assert plan_l.beams == plan.beams
            assert plan_l.total_beam_meterset() == plan.total_beam_meterset()
            assert plan_l.referenced_dose_sops == [rd.SOPInstanceUID]
            mia.read_dicoms(file_list=[j("rp2.dcm")], clear=False,
                            device=dev)
            plan_2 = Data.plan[Data.plan_list[-1]]
            assert plan_2.beams == [dict(b, n_control_points=1)
                                    for b in plan.beams]
            memory_gb = check_memory({"io": files})
            assert np.isfinite(memory_gb), memory_gb

            launches, shapes = launch_counts(), launch_shapes()
            hist_shapes = dict(hist.LAUNCH_SHAPES)
            seconds = time.perf_counter() - t_phase

            # after the window: the path's warp keys (both create_image
            # calls again, on the read-back registry) and its histogram
            # calls held bit-equal to the plain twins on its tensors, and
            # timed; the deformable REG's read and upload profiled
            set_registry(read_back)
            calls = {}
            with uncounted():
                with recording_warp_calls(calls):
                    rigid_b.create_image()
                    def_b.create_image()
                warp_rows = warp_path_rows(calls)
                hist_row = hist_path_lost(hist_calls, hist_shapes,
                                          phase="io_hist_path")

            def reg_read():
                grid = dcmread(j("reg_dvf.dcm")) \
                    .DeformableRegistrationSequence[0] \
                    .DeformableRegistrationGridSequence[0]
                return decode_vector_grid(grid.VectorGridData,
                                          np.flip(grid.GridDimensions), dev)

            profile = profile_device(reg_read)
        finally:
            set_registry(registry)
    del field, dose_gy, ptv_dose
    torch.cuda.empty_cache()
    emit("io", seconds=seconds, writers=writers, readers=readers,
         written_mb=sum(r["mb"] for r in writers.values()),
         registry=dict(images=3, rois=len(contoured), doses=1, plans=1,
                       rigid=1, deformable=1),
         rtdose=dict(scaling=scaling, quantisation_gy=quant,
                     read_back_err_gy=dose_err, bound_gy=dose_bound),
         dvh_ptv=dict(max_abs_pct=float(curve_diff.max()),
                      bins_that_moved=int((curve_diff > 0).sum()),
                      bound_pct_max=float(allowed.max()), near_gy=near_gy),
         rigid_matrix_err=matrix_err, nifti_geometry_err_mm=nifti_err,
         check_memory_gb=memory_gb, launches=launches,
         reg_read=dict(wall_ms=profile["profiled_wall_ms"],
                       device_ms=profile["device_ms"],
                       device_share=profile["device_share"],
                       mb=path_bytes(j("reg_dvf.dcm")) / 1e6))
    return dict(launches=launches, shapes=shapes, hist=hist_row,
                warp_rows=warp_rows, profile=profile)


# ---------------------------------------------------------------------------
# ingest_rest: every modality the JAX package reads, in one folder
def planar_dataset(modality, arr, bits_stored=16, frames=None, **tags):
    """A planar (or NM) dataset of ``arr`` with the port's DICOM classes:
    uint8 pixels as 8-bit MONOCHROME2, anything else as uint16."""
    from medicalimageanalysis_torch.dicom import Dataset, generate_uid, uids

    ds = Dataset()
    ds.SOPClassUID = uids.MODALITY_SOP_CLASS[modality]
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = modality
    ds.PatientID = "SMOKE"
    ds.SeriesInstanceUID = generate_uid()
    ds.FrameOfReferenceUID = generate_uid()
    if frames is not None:
        ds.NumberOfFrames = frames
    ds.Rows, ds.Columns = arr.shape[-2], arr.shape[-1]
    eight = arr.dtype == np.uint8
    ds.BitsAllocated = 8 if eight else 16
    ds.BitsStored = 8 if eight else bits_stored
    ds.HighBit = ds.BitsStored - 1
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    for key, value in tags.items():
        setattr(ds, key, value)
    ds.PixelData = arr.tobytes() if eight else arr.astype("<u2").tobytes()
    return ds


def enhanced_ct_dataset(img):
    """The reference CT as one enhanced multi-frame file: per-frame
    PlanePositionSequence, shared orientation, pixel measures and rescale
    (stored = HU + 1024, 12 bits)."""
    from medicalimageanalysis_torch.dicom import Dataset, Sequence
    from medicalimageanalysis_torch.dicom import generate_uid, uids

    arr = np.asarray(img.array)
    ds = planar_dataset("CT", (arr.astype(np.int32) + 1024).astype(
        np.uint16), bits_stored=12, frames=arr.shape[0])
    ds.SOPClassUID = uids.CTImageStorage
    ds.SeriesInstanceUID = generate_uid()
    ds.ImageType = ["ORIGINAL", "PRIMARY", "AXIAL"]
    ds.SliceThickness = float(img.spacing[2])

    def item(**kw):
        d = Dataset()
        for k, v in kw.items():
            setattr(d, k, v)
        return Sequence([d])

    shared = Dataset()
    shared.PlaneOrientationSequence = item(ImageOrientationPatient=[
        float(v) for v in np.concatenate([img.matrix[0], img.matrix[1]])])
    shared.PixelMeasuresSequence = item(
        PixelSpacing=[float(img.spacing[1]), float(img.spacing[0])],
        SliceThickness=float(img.spacing[2]))
    shared.PixelValueTransformationSequence = item(
        RescaleSlope=1.0, RescaleIntercept=-1024.0)
    ds.SharedFunctionalGroupsSequence = Sequence([shared])
    frames = []
    for k in range(arr.shape[0]):
        fg = Dataset()
        fg.PlanePositionSequence = item(ImagePositionPatient=[
            float(v) for v in np.asarray(img.origin)
            + k * img.spacing[2] * np.asarray(img.matrix[2])])
        frames.append(fg)
    ds.PerFrameFunctionalGroupsSequence = Sequence(frames)
    return ds


def ingest_rest_objects(gen):
    """(file name, dataset, written pixels, reader's expected array) for
    the NM, US and projection objects at clinical sizes; pixels from
    ``gen`` (a CPU torch generator)."""
    from medicalimageanalysis_torch.dicom import Dataset, Sequence

    def pixels(shape, hi, dtype):
        return torch.randint(0, hi, shape, generator=gen).numpy().astype(
            dtype)

    out = []
    # NM RECON TOMO: one detector, negative pitch (frames walk -z)
    tomo = pixels(NM_TOMO_SHAPE, 60000, np.uint16)
    ds = planar_dataset("NM", tomo, frames=NM_TOMO_SHAPE[0],
                        ImageType=["DERIVED", "SECONDARY", "RECON TOMO",
                                   "EMISSION"],
                        PatientPosition="HFS",
                        PixelSpacing=[NM_PITCH_MM, NM_PITCH_MM],
                        SliceThickness=NM_PITCH_MM,
                        SpacingBetweenSlices=-NM_PITCH_MM,
                        NumberOfDetectors=1,
                        NumberOfSlices=NM_TOMO_SHAPE[0])
    det = Dataset()
    det.ImageOrientationPatient = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    det.ImagePositionPatient = list(NM_DETECTOR_IPP)
    ds.DetectorInformationSequence = Sequence([det])
    out.append(("nm_tomo.dcm", ds, tomo, tomo[::-1].astype(np.float32)))
    # NM planar static (detector spacing) and whole body
    static = pixels((1,) + NM_STATIC_SHAPE, 60000, np.uint16)
    ds = planar_dataset("NM", static, frames=1,
                        ImageType=["ORIGINAL", "PRIMARY", "STATIC",
                                   "EMISSION"])
    det = Dataset()
    det.PixelSpacing = [2.4, 2.4]
    ds.DetectorInformationSequence = Sequence([det])
    out.append(("nm_static.dcm", ds, static, static.astype(np.int32)))
    wb = pixels((1,) + NM_WHOLE_BODY_SHAPE, 60000, np.uint16)
    ds = planar_dataset("NM", wb, frames=1, PixelSpacing=[2.4, 2.4],
                        ImageType=["ORIGINAL", "PRIMARY", "WHOLE BODY",
                                   "EMISSION"])
    out.append(("nm_whole_body.dcm", ds, wb, wb.astype(np.int32)))
    # US grayscale cine
    us = pixels(US_SHAPE, 256, np.uint8)
    ds = planar_dataset("US", us, frames=US_SHAPE[0])
    out.append(("us_cine.dcm", ds, us, us))
    # DX (12 bits, axial), CR (sagittal: the reader flips the rows),
    # MG (12 bits, "Inverse": pivots about 4095)
    dx = pixels(DX_SHAPE, 4096, np.uint16)
    ds = planar_dataset("DX", dx, bits_stored=12,
                        ImagerPixelSpacing=[0.139, 0.139])
    out.append(("dx.dcm", ds, dx, dx.astype(np.int16)[None]))
    cr = pixels(CR_SHAPE, 1024, np.uint16)
    ds = planar_dataset("CR", cr, bits_stored=10, PixelSpacing=[0.1, 0.1],
                        PatientOrientation=["P", "F"])
    out.append(("cr.dcm", ds, cr, np.flip(cr.astype(np.int16)[:, :, None],
                                          axis=0)))
    mg = pixels(MG_SHAPE, 4096, np.uint16)
    ds = planar_dataset("MG", mg, bits_stored=12,
                        ImagerPixelSpacing=[0.07, 0.07],
                        PresentationLUTShape="Inverse")
    out.append(("mg.dcm", ds, mg, (4095 - mg.astype(np.int16))[None]))
    # RF and XA cines
    rf = pixels(RF_SHAPE, 4096, np.uint16)
    ds = planar_dataset("RF", rf, bits_stored=12, frames=RF_SHAPE[0],
                        ImagerPixelSpacing=[0.3, 0.3])
    out.append(("rf_cine.dcm", ds, rf, rf.astype(np.int16)))
    xa = pixels(XA_SHAPE, 1024, np.uint16)
    ds = planar_dataset("XA", xa, bits_stored=10, frames=XA_SHAPE[0],
                        ImagerPixelSpacing=[0.2, 0.2])
    out.append(("xa_cine.dcm", ds, xa, xa.astype(np.int16)))
    return out


@contextlib.contextmanager
def timing_readers(rows):
    """Within the block, DicomReader._build_series records the ms of each
    reader class it calls in ``rows`` (class name -> list of ms)."""
    from medicalimageanalysis_torch.read.dicom import DicomReader

    build = DicomReader._build_series

    def timed(self, reader_cls, image_set, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return build(self, reader_cls, image_set, *args, **kwargs)
        finally:
            rows.setdefault(reader_cls.__name__, []).append(
                1e3 * (time.perf_counter() - t0))

    DicomReader._build_series = timed
    try:
        yield rows
    finally:
        DicomReader._build_series = build


def phase_ingest_rest(folder, names, gen, dev):
    """The rest of ingest at clinical sizes: the reference CT written as
    one enhanced multi-frame file, an NM RECON TOMO, an NM planar static
    and whole-body, a US cine, DX, CR, MG, RF and XA, all written with
    the port's DICOM writer into one folder and read by one read_dicoms
    on the card into a cleared registry (restored after). Each object is
    held against the pixels written, after the reader's flips, casts and
    inverse pivot; the enhanced CT against the single-frame series the
    ingest phase read; the tomo's geometry against its detector vectors.
    Then pack12 on the host and unpack12_device on the card over the
    128 x 512 x 512 CT, bit-equal."""
    import medicalimageanalysis_torch as mia
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.dicom import dcmread, dcmwrite
    from medicalimageanalysis_torch.ops.bitpack import pack12, unpack12_device

    ref = Data.image[names["ref"]]
    ct_array = np.asarray(ref.array)
    root = os.path.join(folder, "ingest_rest")
    os.makedirs(root)
    t0 = time.perf_counter()
    objects = ingest_rest_objects(gen)
    enhanced = enhanced_ct_dataset(ref)
    dcmwrite(os.path.join(root, "ct_enhanced.dcm"), enhanced)
    for fname, ds, _, _ in objects:
        dcmwrite(os.path.join(root, fname), ds)
    write_s = time.perf_counter() - t0
    written_mb = path_bytes(root) / 1e6
    enhanced_uid = enhanced.SeriesInstanceUID
    del enhanced
    # the multi-frame file's decode alone (host), as the read pays it once
    parsed = dcmread(os.path.join(root, "ct_enhanced.dcm"))
    t0 = time.perf_counter()
    frames = parsed.pixel_array
    decode_ms = 1e3 * (time.perf_counter() - t0)
    assert frames.shape == ct_array.shape, frames.shape
    del parsed, frames

    registry = registry_state()
    readers = {}
    try:
        Data.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timing_readers(readers):
            report = mia.read_dicoms(folder_path=root, device=dev).report
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        assert not report.failed_series and not report.failed_files, \
            report.summary()
        images = {}
        for n in Data.image_list:
            fp = Data.image[n].filepaths
            images[os.path.basename(fp if isinstance(fp, str)
                                    else fp[0])] = n
        # one image per object, named "{modality} {NN}" in read order
        assert len(Data.image_list) == 1 + len(objects), Data.image_list
        assert sorted(int(n.split()[1]) for n in Data.image_list) \
            == list(range(1, len(objects) + 2)), Data.image_list
        ct = Data.image[images["ct_enhanced.dcm"]]
        assert ct.series_uid == enhanced_uid
        assert ct.modality == "CT" and ct.array.dtype == np.int16
        assert np.array_equal(ct.array, ct_array), \
            "enhanced CT != single-frame series"
        for attr in ("origin", "spacing", "matrix"):
            assert np.array_equal(np.asarray(getattr(ct, attr), np.float64),
                                  np.asarray(getattr(ref, attr),
                                             np.float64)), attr
        assert len(ct.sops) == ct_array.shape[0]
        checked = {}
        for fname, ds, written, expected in objects:
            name = images[fname]
            img = Data.image[name]
            assert img.modality == ds.Modality, (fname, name)
            assert img.array.dtype == expected.dtype, (fname, img.array.dtype)
            assert np.array_equal(img.array, expected), fname
            checked[fname] = dict(name=name, shape=list(img.array.shape),
                                  dtype=str(img.array.dtype),
                                  spacing=[float(v) for v in img.spacing],
                                  plane=img.plane)
        # the tomo's geometry: the detector's axes, |pitch| spacing, slice
        # k at the detector walk's frame (frames reversed: pitch < 0)
        tomo = Data.image[checked["nm_tomo.dcm"]["name"]]
        n = NM_TOMO_SHAPE[0]
        assert np.array_equal(np.asarray(tomo.matrix, np.float64), np.eye(3))
        assert np.allclose(tomo.spacing, NM_PITCH_MM, rtol=1e-12)
        walk = np.asarray(NM_DETECTOR_IPP) + np.arange(n)[:, None] \
            * -NM_PITCH_MM * np.array([0.0, 0.0, 1.0])
        slices = np.asarray(tomo.origin) + np.arange(n)[:, None] \
            * tomo.spacing[2] * np.asarray(tomo.matrix[2])
        tomo_err = float(np.abs(slices - walk[::-1]).max())
        assert tomo_err < 1e-9, tomo_err
        reader_ms = {k: [round(v, 3) for v in ms]
                     for k, ms in readers.items()}
    finally:
        set_registry(registry)

    # 12-bit packing of the CT: pack on the host, unpack on the card
    t0 = time.perf_counter()
    words, lo, tail = pack12(ct_array)
    pack_ms = 1e3 * (time.perf_counter() - t0)
    wd = torch.from_numpy(words.view(np.int32)).to(dev)
    ct_dev = torch.as_tensor(ct_array, device=dev)
    out = unpack12_device(wd, lo, tail, dtype=torch.int16)
    assert out.dtype == torch.int16 and torch.equal(out, ct_dev), \
        "unpack12_device != the CT"
    f32 = unpack12_device(wd, lo, tail)
    assert torch.equal(f32, ct_dev.to(torch.float32))
    unpack_ms = cuda_ms(lambda: unpack12_device(wd, lo, tail,
                                                dtype=torch.int16))
    moved = words.nbytes + ct_array.nbytes
    del wd, ct_dev, out, f32
    emit("ingest_rest", seconds_read_dicoms=read_s, write_seconds=write_s,
         written_mb=written_mb, objects=len(objects) + 1,
         reader_ms=reader_ms, enhanced_ct=dict(
             frames=int(ct_array.shape[0]), equal_to_series=True,
             decode_ms=decode_ms),
         checked=checked, nm_tomo_geometry_err_mm=tomo_err,
         bitpack=dict(pack_ms=pack_ms, words_mb=words.nbytes / 1e6,
                      unpack_device_ms=unpack_ms,
                      unpack_gb_per_s=moved / unpack_ms / 1e6,
                      bound_ms=bound(moved, 0)[0], bit_equal=True))


# ---------------------------------------------------------------------------
# registration_rest: every Rigid and Deformable registration entry point
def bump_at(points):
    """known_bump()'s Gaussian at (N, 3) physical points (x, y, z mm)."""
    centre = [REF_ORIGIN[k] + (c + 1) / 2 * (n - 1) * s for k, (c, n, s)
              in enumerate(zip((0.02, 0.05, 0.0), SHAPE[::-1], SPACING))]
    r2 = np.sum((np.asarray(points) - np.asarray(centre)) ** 2, axis=1)
    return np.exp(-r2 / (2 * BUMP_SIGMA_MM ** 2))


def body_points(gen, n, ref, margin_mm=40.0):
    """``n`` points (x, y, z mm) drawn in the phantom's body ellipsoid,
    ``margin_mm`` inside its half-axes, from ``gen``."""
    c = np.asarray(ref.compute_center(), np.float64)
    half = np.array([SHAPE[2] * SPACING[0], SHAPE[1] * SPACING[1],
                     SHAPE[0] * SPACING[2]]) / 2 * np.array([0.7, 0.6, 0.8])
    half = np.maximum(half - margin_mm, 5.0)
    u = torch.rand((4 * n, 3), generator=gen, dtype=torch.float64).numpy()
    p = (2 * u - 1)
    p = p[np.sum(p * p, axis=1) <= 1.0][:n]
    assert len(p) == n
    return c + p * half


def icp_mesh(image, name, limit):
    """``image``'s ROI ``name`` as a mesh of at most ``limit`` vertices:
    its mesh (made by create_mesh when it has none), decimated by
    Roi.create_decimate_mesh when larger."""
    roi = image.rois[name]
    if roi.mesh is None:
        roi.create_mesh()
    n = roi.mesh.points.shape[0]
    if n <= limit:
        return roi.mesh, n
    return roi.create_decimate_mesh(percent=1.0 - 0.9 * limit / n), n


def icp_run(rigid, entry, source, target, truth, **kw):
    """One Rigid mesh-ICP entry point under the profiler: the vertex RMS
    against the known motion, the iterations and the ms a step."""
    from medicalimageanalysis_torch.utils.mesh.trimesh import TriMesh

    p = profile_device(lambda: getattr(rigid, entry)(
        TriMesh(source.points.copy(), source.faces.copy()),
        TriMesh(target.points.copy(), target.faces.copy()), **kw))
    check_profile(f"icp_{entry}", p)
    M = np.asarray(rigid.matrix, np.float64)
    pts = np.asarray(source.points, np.float64)
    got = pts @ M[:3, :3].T + M[:3, 3]
    want = pts @ truth[:3, :3].T + truth[:3, 3]
    rms = float(np.sqrt(np.mean(np.sum((got - want) ** 2, axis=1))))
    info = rigid.misc["icp_info"]
    it = int(info["iterations"])
    return dict(vertex_rms_mm=rms, iterations=it,
                ms=p["profiled_wall_ms"], ms_per_iteration=(
                    p["profiled_wall_ms"] / max(it, 1)),
                device_ms=p["device_ms"], device_share=p["device_share"],
                device_events=p["device_events"],
                mean_distance=float(info["mean_distance"]),
                landmarks=info.get("landmarks"),
                fitness=info.get("fitness"))


def elastix_rows(info):
    """ms per level and per iteration of an elastix_registration info."""
    return dict(level_shapes=info["level_shapes"],
                control_grids=info["control_grids"], steps=info["steps"],
                ms_per_level=[1e3 * s for s in info["level_seconds"]],
                ms_per_iteration=[1e3 * s / info["steps"]
                                  for s in info["level_seconds"]])


def phase_registration_rest(names, img_name, gen, dev):
    """The rest of registration at full size, every entry point a user
    calls, on the rigid pair's reference and the deformed series:
    phase correlation (Rigid.compute_phase_correlation) on a copy shifted
    by PC_SHIFT_MM; auto_register on the reference at AUTO_POSE (40 mm
    and 3°; compute_intensity alone runs beside it, printed);
    compute_landmarks over 8 POIs at that pose; compute_tps over 30 POIs
    on the bump pair, then create_image; compute_icp_vtk / compute_o3d
    (point, plane) on the dose-QA study's left lung (decimated to
    ICP_MAX_POINTS vertices) and heart, each moved by ICP_MOTION;
    elastix, the default map (Mattes MI) on the bump pair and a staged
    Euler + B-spline map on the AUTO_POSE pair; compute_demons masked by
    an external "Body" on both images. The registry and the images' ROIs
    and POIs are restored after. Returns the window's launches and
    shapes, the warp kernels' rows on the path's own tensors."""
    import medicalimageanalysis_torch as mia
    from scipy.spatial import Delaunay
    from scipy.spatial.transform import Rotation

    from medicalimageanalysis_torch import interop
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.ops.registration.bspline import (
        elastix_registration)
    from medicalimageanalysis_torch.ops.registration.dvf import (
        invert_dvf, warp_volume)
    from medicalimageanalysis_torch.ops.registration.phase_correlation \
        import _phase_correlate_core
    from medicalimageanalysis_torch.ops.registration.tps import (
        tps_displacement_grid, tps_fit)
    from medicalimageanalysis_torch.ops.resample import (
        affine_resample, compose_pixel_matrix)
    from medicalimageanalysis_torch.ops.volume import stored_to_float
    from medicalimageanalysis_torch.parallel.batch import rasterize_batch
    from medicalimageanalysis_torch.utils.deformable.torch_backend import (
        DeformableTorch)

    t_phase = time.perf_counter()
    registry = {k: (dict(v) if isinstance(v, dict) else list(v))
                for k, v in registry_state().items()}
    ref, deformed = Data.image[names["ref"]], Data.image[names["deformed"]]
    saved_pois = {n: dict(Data.image[n].pois)
                  for n in (names["ref"], names["deformed"])}
    saved_body = {n: Data.image[n].rois.pop("Body", None)
                  for n in (names["ref"], names["deformed"])}
    fixed = ref.array.astype(np.float32)
    moving_bump = deformed.array.astype(np.float32)
    body = fixed > -900.0
    sp = np.asarray(ref.spacing, np.float64)
    g = known_bump()

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    def field_error(point_field):
        """|d - u| (mm) in the body, u the known bump: median, p95."""
        d = torch.as_tensor(point_field, device=dev)
        gt = torch.as_tensor(g, device=dev) * BUMP_MM
        err = torch.sqrt((d[..., 0] - gt) ** 2 + (d[..., 1] - gt) ** 2
                         + d[..., 2] ** 2)[torch.as_tensor(body, device=dev)]
        return [float(v) for v in np.percentile(err.cpu().numpy(),
                                                [50, 95])]

    out = {}
    try:
        # -- phase correlation: a copy whose origin moved by PC_SHIFT_MM
        shift = np.asarray(PC_SHIFT_MM)
        interop.image_from_arrays(ref.array, ref.spacing,
                                  np.asarray(ref.origin) + shift, ref.matrix,
                                  "CT", "PC shifted")
        rigid_pc = mia.Rigid(names["ref"], "PC shifted", device=dev)
        info, pc_ms = timed(rigid_pc.compute_phase_correlation)
        pc_err = float(np.abs(rigid_pc.matrix[:3, 3] - shift).max())
        assert pc_err <= PC_LIMIT_MM and np.allclose(
            rigid_pc.matrix[:3, :3], np.eye(3)), (pc_err, info)
        with uncounted():
            vol = stored_to_float(np.asarray(ref.array), dev)
            A = compose_pixel_matrix(ref.matrix, ref.spacing,
                                     np.asarray(ref.origin) + shift,
                                     ref.matrix, ref.spacing, ref.origin)
            bg = float(vol.mean(dtype=torch.float64))
            resliced = affine_resample(vol, A, SHAPE, background=bg)
            reslice_ms = cuda_ms(lambda: affine_resample(
                vol, A, SHAPE, background=bg), reps=3, warmup=1)
            fft_ms = cuda_ms(lambda: _phase_correlate_core(
                vol, resliced, True, 6), reps=3, warmup=1)
            del vol, resliced
        out["phase_correlation"] = dict(
            shift_mm=list(shift), recovered_mm=list(info["shift_mm"]),
            err_mm=pc_err, limit_mm=PC_LIMIT_MM, response=info["response"],
            ms=pc_ms, reslice_ms=reslice_ms, ffts_ms=fft_ms)

        # -- auto_register at a pose beyond the descent's capture range
        ref_vol = torch.as_tensor(ref.array, device=dev).to(torch.float32)
        with uncounted():
            arr, known = known_pose_volume(ref_vol, ref,
                                           np.asarray(AUTO_POSE), dev)
        del ref_vol
        interop.image_from_arrays(arr, ref.spacing, ref.origin, ref.matrix,
                                  "CT", "auto pose")
        rigid_auto = mia.Rigid(names["ref"], "auto pose", device=dev)
        info, auto_ms = timed(rigid_auto.auto_register)
        c_err, k_err, a_err = registration_error(rigid_auto.matrix, ref,
                                                 known)
        stages = rigid_auto.misc["auto_register"]
        plain = mia.Rigid(names["ref"], "auto pose", device=dev)
        plain.compute_intensity()
        p_err = registration_error(plain.matrix, ref, known)
        out["auto_register"] = dict(
            pose=list(AUTO_POSE), ms=auto_ms,
            stage_ms={k: 1e3 * v for k, v in stages["seconds"].items()},
            phase_correlation=stages["phase_correlation"],
            center_err_mm=c_err, corner_err_mm=k_err, angle_err_deg=a_err,
            limit_mm=0.5, limit_deg=0.3,
            compute_intensity_alone=dict(center_err_mm=p_err[0],
                                         angle_err_deg=p_err[2]))
        assert c_err <= 0.5 and a_err <= 0.3, out["auto_register"]

        # -- compute_landmarks: 8 POIs at the known pose
        # the known pose with its rotation made exactly orthonormal
        # (pose_to_matrix rounds it to float32): a rigid map to 1e-16
        U, _, Vt = np.linalg.svd(known[:3, :3])
        exact = known.copy()
        exact[:3, :3] = U @ Vt
        pts = body_points(gen, LANDMARKS_N, ref)
        moved = pts @ exact[:3, :3].T + exact[:3, 3]
        interop.pois_from_numpy(ref, {f"F{i}": p for i, p in
                                      enumerate(pts)})
        interop.pois_from_numpy(Data.image["auto pose"], {
            f"F{i}": p for i, p in enumerate(moved)})
        rigid_lm = mia.Rigid(names["ref"], "auto pose", device=dev)
        fre, lm_ms = timed(lambda: rigid_lm.compute_landmarks(
            poi_names=[f"F{i}" for i in range(LANDMARKS_N)]))
        lm_err = registration_error(rigid_lm.matrix, ref, exact)
        out["landmarks"] = dict(n=LANDMARKS_N, fre_max_mm=max(fre.values()),
                                limit_mm=1e-6, ms=lm_ms,
                                center_err_mm=lm_err[0],
                                angle_err_deg=lm_err[2])
        assert max(fre.values()) < 1e-6, fre

        # -- compute_tps: 30 POIs on the bump pair (moving points x_i,
        # reference points x_i + u(x_i))
        x = body_points(gen, TPS_N, ref, margin_mm=20.0)
        u = BUMP_MM * bump_at(x)
        t = x + np.stack([u, u, np.zeros_like(u)], axis=1)
        interop.pois_from_numpy(ref, {f"T{i}": p for i, p in enumerate(t)})
        interop.pois_from_numpy(deformed, {f"T{i}": p for i, p in
                                           enumerate(x)})
        tps = mia.Deformable(reference_name=names["ref"],
                             moving_name=names["deformed"], roi_names=[],
                             device=dev)
        res, tps_ms = timed(lambda: tps.compute_tps(
            poi_names=[f"T{i}" for i in range(TPS_N)]))
        W, Acoef = tps_fit(x, t - x)
        with uncounted():
            grid_ms = cuda_ms(lambda: tps_displacement_grid(
                x, W, Acoef, ref.origin, ref.spacing, np.eye(3), SHAPE,
                device=dev), reps=3, warmup=1)
        img_out, tps_image_ms = timed(tps.create_image)
        # the field against the known bump inside the landmarks' hull,
        # on every fourth voxel
        zz, yy, xx = np.meshgrid(*(np.arange(0, n, 4) for n in SHAPE),
                                 indexing="ij")
        grid_pts = np.stack([xx * sp[0], yy * sp[1], zz * sp[2]], -1) \
            .reshape(-1, 3) + np.asarray(ref.origin)
        inside = Delaunay(x).find_simplex(grid_pts) >= 0
        d = tps.dvf[::4, ::4, ::4].reshape(-1, 3).cpu().numpy()[inside]
        ub = BUMP_MM * bump_at(grid_pts[inside])
        err = np.sqrt((d[:, 0] - ub) ** 2 + (d[:, 1] - ub) ** 2
                      + d[:, 2] ** 2)
        with uncounted():
            tps_ratio = residual_ratio(img_out["array"], moving_bump, fixed,
                                       body)
        out["tps"] = dict(
            n=TPS_N, residual_max_mm=max(res.values()), limit_mm=1e-3,
            ms=tps_ms, grid_ms=grid_ms, grid_voxels=int(np.prod(SHAPE)),
            create_image_ms=tps_image_ms, hull_voxels_sampled=int(
                inside.sum()), field_err_mm_median=float(np.median(err)),
            field_err_mm_p95=float(np.percentile(err, 95)),
            residual_ratio=tps_ratio)
        assert max(res.values()) < 1e-3, res
        assert isinstance(tps.dvf, torch.Tensor) \
            and tps.dvf.device.type == torch.device(dev).type
        del img_out

        # -- ICP on the dose-QA study's ROI meshes: the largest organ at
        # risk (the left lung, concave, with an inner hole) decimated to
        # at most ICP_MAX_POINTS vertices, held to 0.1 mm; and the heart,
        # a near-ellipsoid whose rotation point-to-point ICP pins only
        # slowly (PERF.md §6): every variant reported, point-to-plane held
        from medicalimageanalysis_torch.utils.mesh.trimesh import TriMesh
        icp = {}
        for roi_name, held in (("Lung_L", ("vtk", "o3d_point", "o3d_plane")),
                               ("Heart", ("o3d_plane",))):
            (mesh, n_full), dec_ms = timed(lambda: icp_mesh(
                Data.image[img_name], roi_name, ICP_MAX_POINTS))
            c = np.asarray(mesh.points, np.float64).mean(axis=0)
            axis = np.array([1.0, -2.0, 0.5]) / np.linalg.norm(
                [1.0, -2.0, 0.5])
            R = Rotation.from_rotvec(np.deg2rad(ICP_MOTION[0]) * axis) \
                .as_matrix()
            M = np.eye(4)
            M[:3, :3] = R
            M[:3, 3] = c - R @ c + ICP_MOTION[1] * np.array([0.6, 0.0, 0.8])
            target = TriMesh(np.asarray(mesh.points, np.float64) @ R.T
                             + M[:3, 3], np.asarray(mesh.faces))
            rows = dict(vertices=int(mesh.points.shape[0]),
                        mesh_vertices=int(n_full), decimate_ms=dec_ms,
                        held_to_limit=list(held))
            for key, entry, kw in (
                    ("vtk", "compute_icp_vtk", {}),
                    ("o3d_point", "compute_o3d",
                     dict(method="point", iterations=ICP_O3D_ITERATIONS)),
                    ("o3d_plane", "compute_o3d",
                     dict(method="plane", iterations=ICP_O3D_ITERATIONS))):
                rigid_icp = mia.Rigid(img_name, img_name, device=dev)
                rows[key] = icp_run(rigid_icp, entry, mesh, target, M, **kw)
            icp[roi_name] = rows
        out["icp"] = dict(motion_deg=ICP_MOTION[0], motion_mm=ICP_MOTION[1],
                          limit_rms_mm=0.1, **icp)
        for roi_name, rows in icp.items():
            for key in rows["held_to_limit"]:
                assert rows[key]["vertex_rms_mm"] <= 0.1, out["icp"]

        # -- elastix, the default map on the bump pair: the backend's
        # defaults (4 levels, 10 mm, 300 steps) with SimpleElastix's
        # default metric, Mattes MI (the backend's own default, 'Intensity'
        # mean squares, walks in the flat body in both packages: PERF.md
        # §6). The sampling field on the reference grid, inverted to the
        # point field for the error.
        backend = DeformableTorch(device=dev)
        backend.create_sitk_image(ref.array, ref.origin, ref.spacing,
                                  ref.matrix)
        backend.create_sitk_image(deformed.array, deformed.origin,
                                  deformed.spacing, deformed.matrix,
                                  reference=False)
        backend.resample()
        einfo = {}
        ela, ela_ms = timed(lambda: backend.elastix(metric="MI",
                                                    info=einfo))
        with uncounted():
            sampling = ela["array"]
            warped = warp_volume(moving_bump, sampling, sp,
                                 background=-3001.0, device=dev)
            ela_ratio = residual_ratio(warped.cpu().numpy(), moving_bump,
                                       fixed, body)
            del warped
            e_med, e_p95 = field_error(invert_dvf(sampling, sp,
                                                  device=dev))
        out["elastix_default"] = dict(
            metric="mi", ms=ela_ms, residual_ratio=ela_ratio,
            residual_limit=ELASTIX_RATIO_LIMIT, field_err_mm_median=e_med,
            field_err_mm_p95=e_p95, field_p95_limit_mm=ELASTIX_P95_LIMIT_MM,
            **elastix_rows(einfo))
        del ela, sampling
        assert ela_ratio <= ELASTIX_RATIO_LIMIT \
            and e_p95 <= ELASTIX_P95_LIMIT_MM, out["elastix_default"]

        # -- elastix, staged Euler + B-spline on the AUTO_POSE pair
        sinfo = {}
        (sdvf, _), st_ms = timed(lambda: elastix_registration(
            fixed, arr, sp, parameter_map=ELASTIX_STAGES, metric="mse",
            device=dev, info=sinfo))
        o = np.eye(4)
        o[:3, 3] = np.asarray(ref.origin, np.float64)
        M_phys = o @ sinfo["matrix"] @ np.linalg.inv(o)
        s_err = registration_error(M_phys, ref, known)
        with uncounted():
            warped = warp_volume(arr.astype(np.float32), sdvf, sp,
                                 background=-3001.0, device=dev)
            st_ratio = residual_ratio(warped.cpu().numpy(),
                                      arr.astype(np.float32), fixed, body)
            del warped
        linear, spline = sinfo["stages"]
        out["elastix_staged"] = dict(
            ms=st_ms, center_err_mm=s_err[0], angle_err_deg=s_err[2],
            seed_response=linear["seed_response"], seeded=linear["seeded"],
            linear_ms_per_level=[1e3 * s for s in linear["level_seconds"]],
            residual_ratio=st_ratio,
            bspline=elastix_rows(spline), stage_seconds=[
                s["seconds"] for s in sinfo["stages"]])
        del sdvf
        assert linear["seeded"] and s_err[0] <= 0.5 and s_err[2] <= 0.3, \
            out["elastix_staged"]
        assert st_ratio <= ELASTIX_RATIO_LIMIT, out["elastix_staged"]

        # -- compute_demons masked by an external "Body" on both images
        for n in (names["ref"], names["deformed"]):
            Data.image[n].create_external(name="Body")
        masked = mia.Deformable(reference_name=names["ref"],
                                moving_name=names["deformed"],
                                roi_names=["Body"], device=dev)
        (ref_mask, mov_mask), union_ms = timed(masked.roi_mask_union)
        host = [rasterize_batch(
            [Data.image[n].rois["Body"].contour_pixel],
            tuple(int(v) for v in Data.image[n].dimensions),
            device="cpu")[0] for n in (names["ref"], names["deformed"])]
        assert np.array_equal(ref_mask, host[0]) \
            and np.array_equal(mov_mask, host[1]), "mask union != host"
        dinfo, dem_ms = timed(lambda: masked.compute_demons(
            method="fast", pyramid=DEMONS_PYRAMID))
        dem_out, dem_image_ms = timed(masked.create_image)
        keep = (ref_mask > 0) & (dem_out["array"] != -3001.0)
        in_mask = float(np.abs(dem_out["array"] - fixed)[keep].mean()
                        / np.abs(moving_bump - fixed)[keep].mean())
        out["masked_demons"] = dict(
            ms=dem_ms, create_image_ms=dem_image_ms, union_ms=union_ms,
            mask_voxels=[int(ref_mask.sum()), int(mov_mask.sum())],
            union_equal_to_host=True, dvf_shape=list(masked.dvf.shape),
            level_shapes=dinfo["level_shapes"],
            residual_ratio_in_mask=in_mask, limit=RESIDUAL_LIMIT)
        del dem_out
        assert in_mask <= RESIDUAL_LIMIT, out["masked_demons"]

        launches, shapes = launch_counts(), launch_shapes()
        seconds = time.perf_counter() - t_phase

        # after the window: each warp key of the path on its own tensors
        # (the stages again with few steps: the launch shapes are the
        # same), held bit-equal and timed
        calls = {}
        with uncounted():
            with recording_warp_calls(calls):
                rigid_pc.compute_phase_correlation(update=False)
                short = [dict(st, MaximumNumberOfIterations="10")
                         for st in ELASTIX_STAGES]
                elastix_registration(fixed, arr, sp, parameter_map=short,
                                     metric="mse", device=dev)
                backend.elastix(metric="MI", iterations=2)
                tps.create_image()
                masked.compute_demons(method="fast", pyramid=DEMONS_PYRAMID,
                                      iterations=1)
            warp_rows = warp_path_rows(calls)
    finally:
        for n, roi in saved_body.items():
            img = Data.image[n]
            img.rois.pop("Body", None)
            getattr(img, "_roi_mask_cache", {}).pop("Body", None)
            if roi is not None:
                img.rois["Body"] = roi
        for n, pois in saved_pois.items():
            Data.image[n].pois = pois
        set_registry(registry)
    torch.cuda.empty_cache()
    emit("registration_rest", seconds=seconds, launches=launches, **out)
    return dict(launches=launches, shapes=shapes, warp_rows=warp_rows)


# ---------------------------------------------------------------------------
# multi-device: the (data, space) mesh on one card, as logical shards
MD_SHARDS = 4                    # logical shards on the one card
MD_HALO = 16                     # demons_z_sharded's halo rows
MD_ITERATIONS = 50               # demons_registration's default level
MD_ROIS = 4                      # dose-QA ROIs in the data-axis calls
MD_N4_SHAPE = (88, 128, 128)     # n4_batch's cut: MR_SHAPE / 2, ...
MD_N4 = dict(shrink=4, levels=1, max_iterations=10)  # ... one short level
MD_PREPROCESS = (8, (40, 256, 256), (40, 128, 128))  # B, in, out
MD_SEAM_ROWS = 4    # rows each side of a shard boundary: the LNCC box
#                     (radius 3) and smoothing (radius 4) halos' reach
# the LNCC sharded field's mean |diff| from the single level, overall and
# over the seam rows: 2.5x the 0.008 mm the card gave (the sums' order,
# amplified by the peak normalisation), 1/160 of the grid's 3.2 mm; a
# halo or box-sum fault moves the seam rows by tenths of a mm
MD_LNCC_MEAN_MM = 0.02


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def coordinate_bound(vol, coord_max):
    """The largest |difference| two float32 computations of the same z
    sample coordinate can leave in a trilinear warp of ``vol``: the
    coordinates (global row + u_z against local row + (u_z + halo)) each
    round once or twice below ``coord_max``, so they differ by under
    2 ulp(coord_max), times the largest step between z neighbours, plus
    8 ulp of the largest value for the weights' products."""
    ulp = float(np.spacing(np.float32(coord_max)))
    step = float(np.abs(np.diff(vol, axis=0)).max())
    top = float(np.spacing(np.float32(np.abs(vol).max())))
    return 2 * ulp * step + 8 * top


def phase_multi_device(folder, names, img_name, dose_name, cohort, dev):
    """The multi-device path on one card, with its shards as logical
    shards (the mesh's entries repeat the card): the space axis (a
    Gaussian z pass, demons and LNCC demons and a warp, z-sharded with
    halo exchange, against their single-device twins), both axes
    (demons_batch_z_sharded, the pair and its reverse), the data axis
    (the cohort rigid, dvh / rasterize / compare_masks / gamma over
    dose-QA ROIs, radiomics of the PTV crop, demons_batch, n4_batch,
    preprocess_batch and ingest_cohort, each against its mesh=None
    result), then distributed_cohort_batch over a one-rank NCCL group.
    The twins run inside uncounted(): the launch counts are the sharded
    calls'. Returns the launches, shapes, recorded histogram calls, the
    warp rows of the path's keys and the profile's closure."""
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.device import full_float32
    from medicalimageanalysis_torch.models import rigid_intensity as ri
    from medicalimageanalysis_torch.ops import hist, radiomics
    from medicalimageanalysis_torch.ops.filters import _gauss_kernel_matrix
    from medicalimageanalysis_torch.ops.registration.demons import (
        demons_registration)
    from medicalimageanalysis_torch.ops.registration.dvf import warp_volume
    from medicalimageanalysis_torch.ops.resample import (affine_resample,
                                                         compose_pixel_matrix,
                                                         separable_resample)
    from medicalimageanalysis_torch.parallel import batch, cohort as pcohort
    from medicalimageanalysis_torch.parallel import halo
    from medicalimageanalysis_torch.parallel.mesh import (
        initialize_distributed, make_mesh)
    from medicalimageanalysis_torch.utils.creation import CreateDicomImage
    from medicalimageanalysis_torch.utils.metrics import voxel_volume_cc

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        return res, 1e3 * (time.perf_counter() - t0)

    def same(a, b):
        """Bit-equal, through dicts, tuples and lists (NaN equal NaN)."""
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
        return a == b or (a != a and b != b)

    t_phase = time.perf_counter()
    rows, hist_calls = {}, {}
    space4 = make_mesh(MD_SHARDS, space=MD_SHARDS, devices=[dev] * MD_SHARDS)
    both = make_mesh(MD_SHARDS, space=2, devices=[dev] * MD_SHARDS)
    data4 = make_mesh(MD_SHARDS, space=1, devices=[dev] * MD_SHARDS)
    # the reference registered onto the deformed series: one fast level
    # reaches a residual ratio of 0.37 that way at 64 x 256 x 256, 0.61
    # the other way (ROADMAP.md queue 3, observations)
    ref_arr = Data.image[names["ref"]].array.astype(np.float32)
    fixed = Data.image[names["deformed"]].array.astype(np.float32)
    moving = ref_arr
    body = fixed > -900.0
    body_rev = moving > -900.0
    demons_kw = dict(method="fast", iterations=MD_ITERATIONS, std=1,
                     step=2.0)

    def in_turns(sharded, single):
        """The sharded call and its single-device twin in turns (sharded,
        twin, twin, sharded: the first call of a shape pays the caching
        allocator's growth); returns both results and both mean ms, the
        twin's calls uncounted."""
        res_sh, ms_a = timed(sharded)
        with uncounted():
            res_1, ms_b = timed(single)
            res_1, ms_c = timed(single)
        res_sh, ms_d = timed(sharded)
        return res_sh, res_1, (ms_a + ms_d) / 2, (ms_b + ms_c) / 2

    def ratio(field, mov, fix, mask):
        with uncounted():
            warped = warp_volume(mov, field, SPACING, background=-3001.0,
                                 device=dev).cpu().numpy()
        return residual_ratio(warped, mov, fix, mask)

    # --- the space axis: z-sharded over 4 logical shards of 32 slices
    mz = torch.as_tensor(_gauss_kernel_matrix(SHAPE[0], 1.5), device=dev)
    with full_float32():
        g_sh, g_1, ms_sh, ms_1 = in_turns(
            lambda: halo.gaussian_z_sharded(fixed, 1.5, space4),
            lambda: torch.einsum("ij,jyx->iyx", mz,
                                 torch.as_tensor(fixed, device=dev)))
    g_err = float(np.abs(np.asarray(g_sh) - g_1.cpu().numpy()).max())
    g_lim = 1e-5 * float(np.abs(fixed).max())
    rows["gaussian_z_sharded"] = dict(ms=ms_sh, mesh_none_ms=ms_1,
                                      max_abs_err=g_err, limit=g_lim)
    assert g_err <= g_lim, rows["gaussian_z_sharded"]
    del g_sh, g_1

    d_sh, d_1, ms_sh, ms_1 = in_turns(
        lambda: halo.demons_z_sharded(fixed, moving, space4, SPACING,
                                      halo=MD_HALO, **demons_kw),
        lambda: demons_registration(fixed, moving, SPACING, device=dev,
                                    **demons_kw))
    r_sh, r_1 = ratio(d_sh, moving, fixed, body), \
        ratio(d_1, moving, fixed, body)
    diff = np.abs(d_sh - d_1)
    rows["demons_z_sharded"] = dict(
        ms=ms_sh, mesh_none_ms=ms_1, iterations=MD_ITERATIONS, halo=MD_HALO,
        shards=MD_SHARDS, residual_ratio=r_sh, mesh_none_residual_ratio=r_1,
        residual_limit=RESIDUAL_LIMIT, field_max_abs_diff_mm=float(diff.max()),
        field_p99_abs_diff_mm=float(np.percentile(diff, 99)),
        max_abs_uz_mm=float(np.abs(d_sh[..., 2]).max()))
    assert r_sh <= RESIDUAL_LIMIT, rows["demons_z_sharded"]
    assert abs(r_sh - r_1) <= 0.02 * r_1, rows["demons_z_sharded"]
    del diff

    # warp_z_sharded: the deformed series by the sharded field
    w_sh, w_1, ms_sh, ms_1 = in_turns(
        lambda: np.asarray(halo.warp_z_sharded(
            moving, d_sh, space4, SPACING, background=-3001.0,
            halo=MD_HALO)),
        lambda: warp_volume(moving, d_sh, SPACING, background=-3001.0,
                            device=dev).cpu().numpy())
    w_err = float(np.abs(w_sh - w_1).max())
    w_lim = coordinate_bound(moving, SHAPE[0])
    rows["warp_z_sharded"] = dict(
        ms=ms_sh, mesh_none_ms=ms_1, max_abs_err=w_err, bound=w_lim,
        background_voxels=int((w_sh == -3001.0).sum()),
        mesh_none_background_voxels=int((w_1 == -3001.0).sum()))
    assert np.array_equal(w_sh == -3001.0, w_1 == -3001.0), \
        rows["warp_z_sharded"]
    assert w_err <= w_lim, rows["warp_z_sharded"]
    del w_sh, w_1

    # LNCC demons at the variants' grid, 16-slice shards
    small = (SHAPE[0] // 2, SHAPE[1] // 4, SHAPE[2] // 4)
    sp_small = [SPACING[0] * SHAPE[2] / small[2],
                SPACING[1] * SHAPE[1] / small[1],
                SPACING[2] * SHAPE[0] / small[0]]
    with uncounted():
        f_s, m_s = (separable_resample(torch.as_tensor(a, device=dev),
                                       small).cpu().numpy()
                    for a in (fixed, moving))
    lncc_kw = dict(demons_kw, forces="lncc")
    l_sh, l_1, ms_sh, ms_1 = in_turns(
        lambda: halo.demons_z_sharded(f_s, m_s, space4, sp_small,
                                      halo=MD_HALO, **lncc_kw),
        lambda: demons_registration(f_s, m_s, sp_small, device=dev,
                                    **lncc_kw))

    def ratio_small(field):
        with uncounted():
            warped = warp_volume(m_s, field, sp_small, background=-3001.0,
                                 device=dev).cpu().numpy()
        return residual_ratio(warped, m_s, f_s, f_s > -900.0)

    rl_sh, rl_1 = ratio_small(l_sh), ratio_small(l_1)
    diff = np.abs(l_sh - l_1)
    # where the fields differ: the rows within MD_SEAM_ROWS of a shard
    # boundary (the halo exchanges' reach) against the interior rows
    zl = small[0] // MD_SHARDS
    seam = np.abs((np.arange(small[0]) + 0.5) % zl - zl / 2) \
        >= zl / 2 - MD_SEAM_ROWS
    seam[:MD_SEAM_ROWS] = seam[-MD_SEAM_ROWS:] = False   # global edges
    by_row = diff.reshape(small[0], -1)
    worst = int(by_row.max(axis=1).argmax())
    rows["demons_z_sharded_lncc"] = dict(
        shape=list(small), ms=ms_sh, mesh_none_ms=ms_1,
        residual_ratio=rl_sh, mesh_none_residual_ratio=rl_1,
        field_mean_abs_diff_mm=float(diff.mean()),
        field_max_abs_diff_mm=float(diff.max()),
        seam_rows=int(seam.sum()),
        seam_mean_abs_diff_mm=float(by_row[seam].mean()),
        interior_mean_abs_diff_mm=float(by_row[~seam].mean()),
        seam_max_abs_diff_mm=float(by_row[seam].max()),
        interior_max_abs_diff_mm=float(by_row[~seam].max()),
        worst_row=worst,
        worst_row_to_seam=int(min(abs(worst + 0.5 - b * zl) - 0.5
                                  for b in range(1, MD_SHARDS))),
        mean_limit_mm=MD_LNCC_MEAN_MM)
    assert np.isfinite(l_sh).all()
    assert abs(rl_sh - rl_1) <= 0.02 * rl_1, rows["demons_z_sharded_lncc"]
    assert diff.mean() <= MD_LNCC_MEAN_MM, rows["demons_z_sharded_lncc"]
    assert by_row[seam].mean() <= MD_LNCC_MEAN_MM, \
        rows["demons_z_sharded_lncc"]
    del l_sh, l_1, diff

    # --- both axes: the pair and its reverse, 2 data rows x 2 shards
    pairs_f, pairs_m = np.stack([fixed, moving]), np.stack([moving, fixed])
    b_sh, ms_sh = timed(lambda: halo.demons_batch_z_sharded(
        pairs_f, pairs_m, both, SPACING, halo=MD_HALO, **demons_kw))
    with uncounted():
        rev_1, ms_rev = timed(lambda: demons_registration(
            moving, fixed, SPACING, device=dev, **demons_kw))
    rb = [ratio(b_sh[0], moving, fixed, body),
          ratio(b_sh[1], fixed, moving, body_rev)]
    rb_1 = [r_1, ratio(rev_1, fixed, moving, body_rev)]
    rows["demons_batch_z_sharded"] = dict(
        pairs=2, mesh=both.shape, ms=ms_sh,
        mesh_none_ms=rows["demons_z_sharded"]["mesh_none_ms"] + ms_rev,
        residual_ratio=rb, mesh_none_residual_ratio=rb_1)
    # each pair as its single-device level; the reverse (deformed onto
    # the reference) is the orientation one level leaves above the limit
    assert rb[0] <= RESIDUAL_LIMIT, rows["demons_batch_z_sharded"]
    for a, b in zip(rb, rb_1):
        assert abs(a - b) <= 0.02 * b, rows["demons_batch_z_sharded"]
    del pairs_f, pairs_m, b_sh, rev_1, d_1
    torch.cuda.empty_cache()

    # --- the data axis: each function against its mesh=None result
    refs, movs, geo_in, plain = cohort
    scale = 1.0 / 65535.0
    (poses, losses), ms_sh = timed(lambda: ri.register_rigid_intensity_batch(
        refs, movs, *geo_in, levels=RIGID_LEVELS, intensity_scale=scale,
        mesh=data4))
    rows["register_rigid_intensity_batch"] = dict(
        pairs=len(refs), ms=ms_sh, mesh_none_ms=plain["batch_ms"],
        pose_max_abs_diff=float(np.abs(poses - plain["poses"]).max()))
    assert np.array_equal(poses, plain["poses"]) \
        and np.array_equal(losses, plain["losses"]), \
        rows["register_rigid_intensity_batch"]

    img, dose = Data.image[img_name], Data.dose[dose_name]
    roi_names = [n for n in img.rois
                 if img.rois[n].contour_pixel is not None][:MD_ROIS]
    masks = img.compute_roi_masks(roi_names)
    with uncounted():
        A = compose_pixel_matrix(dose.matrix, dose.spacing, dose.origin,
                                 img.matrix, img.spacing, img.origin)
        grid = affine_resample(dose.array, A, img.array.shape,
                               background=0.0, device=dev)
    dose_b = grid.expand((len(roi_names),) + tuple(grid.shape))
    mask_b = torch.stack([torch.as_tensor(masks[n], device=dev)
                          for n in roi_names])
    vox = voxel_volume_cc(img.spacing)
    with recording_hist_calls(hist_calls):
        out_sh, ms_sh = timed(lambda: batch.dvh_batch(
            dose_b, mask_b, vox, mesh=data4))
    with uncounted():
        out_1, ms_1 = timed(lambda: batch.dvh_batch(dose_b, mask_b, vox,
                                                    device=dev))
    rows["dvh_batch"] = dict(rois=roi_names, ms=ms_sh, mesh_none_ms=ms_1,
                             bit_equal=same(out_sh, out_1))
    assert rows["dvh_batch"]["bit_equal"], rows["dvh_batch"]
    del dose_b, grid

    contours = [img.rois[n].contour_pixel for n in roi_names]
    dims = tuple(int(v) for v in img.dimensions)
    out_sh, ms_sh = timed(lambda: batch.rasterize_batch(contours, dims,
                                                        mesh=data4))
    with uncounted():
        out_1, ms_1 = timed(lambda: batch.rasterize_batch(contours, dims,
                                                          device=dev))
    rows["rasterize_batch"] = dict(ms=ms_sh, mesh_none_ms=ms_1,
                                   bit_equal=same(out_sh, out_1))
    assert rows["rasterize_batch"]["bit_equal"]

    stack_a = np.stack([masks[n] for n in roi_names])
    stack_b = np.roll(stack_a, 2, axis=3)          # 1.6 mm in x
    out_sh, ms_sh = timed(lambda: batch.compare_masks_batch(
        stack_a, stack_b, img.spacing, mesh=data4))
    with uncounted():
        out_1, ms_1 = timed(lambda: batch.compare_masks_batch(
            stack_a, stack_b, img.spacing, device=dev))
    rows["compare_masks_batch"] = dict(ms=ms_sh, mesh_none_ms=ms_1,
                                       bit_equal=same(out_sh, out_1))
    assert rows["compare_masks_batch"]["bit_equal"]
    del stack_a, stack_b

    d = dose.array.astype(np.float32)
    evals = np.stack([d, d * np.float32(GAMMA_SCALE), d * np.float32(0.97),
                      np.roll(d, 1, axis=2)])
    refs_g = np.stack([d] * len(evals))
    out_sh, ms_sh = timed(lambda: batch.gamma_batch(
        refs_g, evals, dose.spacing, return_maps=True, mesh=data4))
    with uncounted():
        out_1, ms_1 = timed(lambda: batch.gamma_batch(
            refs_g, evals, dose.spacing, return_maps=True, device=dev))
    rows["gamma_batch"] = dict(ms=ms_sh, mesh_none_ms=ms_1,
                               pass_rate=[float(v) for v in
                                          out_sh["pass_rate"]],
                               bit_equal=same(out_sh, out_1))
    assert rows["gamma_batch"]["bit_equal"]
    del refs_g, evals, out_sh, out_1

    ptv = np.asarray(img.rois["PTV"].compute_mask()) > 0
    lo, hi, _, cm = radiomics._crop(fixed, ptv)
    box = tuple(slice(a, b) for a, b in zip(lo, hi))
    crops = np.stack([a[box] for a in (fixed, moving, fixed, moving)])
    crop_m = np.stack([cm, cm, np.roll(cm, 1, axis=2), np.roll(cm, 1,
                                                                axis=2)])
    out_sh, ms_sh = timed(lambda: batch.radiomics_batch(
        crops, crop_m, SPACING, bin_width=PTV_BIN_HU, mesh=data4))
    with uncounted():
        out_1, ms_1 = timed(lambda: batch.radiomics_batch(
            crops, crop_m, SPACING, bin_width=PTV_BIN_HU, device=dev))
    rows["radiomics_batch"] = dict(crop=list(cm.shape), ms=ms_sh,
                                   mesh_none_ms=ms_1,
                                   bit_equal=same(out_sh, out_1))
    assert rows["radiomics_batch"]["bit_equal"]

    with uncounted():
        f2, m2, sp2, _ = demons_batch_pairs(ref_arr, fixed, dev)
        f4, m4 = torch.cat([f2, f2]), torch.cat([m2, m2])
    out_sh, ms_sh = timed(lambda: batch.demons_batch(
        f4, m4, sp2, method="fast", iterations=DEMONS_BATCH_ITERATIONS,
        mesh=data4))
    with uncounted():
        out_1, ms_1 = timed(lambda: batch.demons_batch(
            f4, m4, sp2, method="fast", iterations=DEMONS_BATCH_ITERATIONS,
            device=dev))
    rows["demons_batch"] = dict(pairs=4, shape=list(DEMONS_BATCH_SHAPE),
                                ms=ms_sh, mesh_none_ms=ms_1,
                                bit_equal=same(out_sh, out_1))
    assert rows["demons_batch"]["bit_equal"]
    del f2, m2, f4, m4, out_sh, out_1

    vols = np.stack([mr_phantom(SEED + k, MD_N4_SHAPE)[0]
                     for k in range(4)]).astype(np.float32)
    (c_sh, f_sh), ms_sh = timed(lambda: batch.n4_batch(
        vols, return_fields=True, mesh=data4, **MD_N4))
    with uncounted():
        (c_1, f_1), ms_1 = timed(lambda: batch.n4_batch(
            vols, return_fields=True, device=dev, **MD_N4))
    lanes = []
    for a, b in zip(f_sh, f_1):
        r = a.astype(np.float64) / b.astype(np.float64)
        lanes.append([float(abs(r.mean() - 1.0)), float(r.std())])
    rows["n4_batch"] = dict(
        volumes=4, shape=list(MD_N4_SHAPE), cut=dict(
            MD_N4, note="MR_SHAPE halved, one fitting level of at most "
            "10 iterations: the phase's time"),
        ms=ms_sh, mesh_none_ms=ms_1, bit_equal=same(f_sh, f_1),
        field_ratio_mean_dev_std=lanes)
    # tests/test_n4.py's lane rule: a B=1 contraction may sum otherwise
    assert all(m < 2e-3 and s < 5e-3 for m, s in lanes), rows["n4_batch"]
    del vols, c_sh, f_sh, c_1, f_1

    B, in_shape, out_shape = MD_PREPROCESS
    g = torch.Generator().manual_seed(SEED)
    raw = (torch.randn((B,) + in_shape, generator=g) * 300.0 - 226.0) \
        .round().to(torch.int16).numpy()
    slopes, intercepts = np.ones(B, np.float32), np.full(B, -24.0,
                                                         np.float32)
    (v_sh, k_sh), ms_sh = timed(lambda: batch.preprocess_batch(
        raw, slopes, intercepts, out_shape, mesh=data4))
    with uncounted():
        (v_1, k_1), ms_1 = timed(lambda: batch.preprocess_batch(
            raw, slopes, intercepts, out_shape, device=dev))
    atol = 1e-5 * float(v_1.abs().max())
    rows["preprocess_batch"] = dict(
        batch=B, in_shape=list(in_shape), out_shape=list(out_shape),
        ms=ms_sh, mesh_none_ms=ms_1, bit_equal=same((v_sh, k_sh),
                                                    (v_1, k_1)),
        max_abs_err=max_abs(v_sh, v_1), atol=atol,
        mask_voxels_differ=int((k_sh != k_1).sum()))
    # phase_preprocess's bound: B=2 rows and B=8 may sum in other orders
    assert torch.allclose(v_sh, v_1, rtol=1e-5, atol=atol), \
        rows["preprocess_batch"]
    del raw, v_sh, k_sh, v_1, k_1

    # ingest_cohort of a four-series cohort folder into its own registry
    cohort_dir = os.path.join(folder, "cohort")
    ref_img = Data.image[names["ref"]]
    series = (fixed, moving, Data.image[names["mov"]].array,
              np.roll(fixed, 3, axis=2))
    for k, arr in enumerate(series):
        CreateDicomImage(os.path.join(cohort_dir, f"s{k}"),
                         np.asarray(arr).astype(np.int16),
                         series=f"{REF_UID}.9{k}", origin=REF_ORIGIN,
                         spacing=SPACING[:2], thickness=SPACING[2]).run(
                             patient_id="COHORT")
    registry = registry_state()
    try:
        got, ms_sh = timed(lambda: pcohort.ingest_cohort(
            folder_path=cohort_dir, out_shape=(64, 256, 256), mesh=data4,
            device=dev))
        uids = {n: Data.image[n].series_uid for n in got}
        with uncounted():
            want, ms_1 = timed(lambda: pcohort.ingest_cohort(
                folder_path=cohort_dir, out_shape=(64, 256, 256),
                device=dev))
        by_uid = {Data.image[n].series_uid: want[n] for n in want}
    finally:
        set_registry(registry)
    errs = [max_abs(got[n]["volume"], by_uid[u]["volume"])
            for n, u in uids.items()]
    atol = 1e-5 * max(float(by_uid[u]["volume"].abs().max())
                      for u in uids.values())
    rows["ingest_cohort"] = dict(
        series=len(got), ms=ms_sh, mesh_none_ms=ms_1,
        bit_equal=all(same(got[n], by_uid[u]) for n, u in uids.items()),
        max_abs_err=max(errs), atol=atol)
    assert len(got) == 4 and max(errs) <= atol, rows["ingest_cohort"]
    del got, want, by_uid

    # --- one-rank NCCL: the global batch of the four cohort volumes
    os.environ["MIA_COORDINATOR"] = f"localhost:{free_port()}"
    import torch.distributed as dist

    assert initialize_distributed(num_processes=1, process_id=0)
    try:
        backend = dist.get_backend_config()
        assert "cuda:nccl" in backend, backend
        ranked = make_mesh(MD_SHARDS, space=1, devices=[dev] * MD_SHARDS)
        host = [m.cpu().numpy().astype(np.int32) for m in movs]
        gb, ms_sh = timed(lambda: pcohort.distributed_cohort_batch(
            host, ranked))
        total = float(ranked.psum({p: b.to(torch.float64).mean()
                                   for p, b in gb.blocks.items()}))
    finally:
        dist.destroy_process_group()
        os.environ.pop("MIA_COORDINATOR")
    want_total = float(sum(h.astype(np.float64).mean() for h in host))
    rows["distributed_cohort_batch"] = dict(
        backend=backend, ranks=1, shape=list(gb.shape), ms=ms_sh,
        mean_sum=total, numpy_mean_sum=want_total)
    assert gb.shape == (len(host),) + SHAPE
    assert abs(total - want_total) <= 1e-9 * want_total, \
        rows["distributed_cohort_batch"]
    del host, gb

    launches, shapes = launch_counts(), launch_shapes()
    hist_shapes = dict(hist.LAUNCH_SHAPES)
    seconds = time.perf_counter() - t_phase

    # after the window: each warp key of the path on its own tensors (the
    # sharded calls again, one iteration or step: the keys are the same)
    calls = {}
    short = dict(demons_kw, iterations=1)
    with uncounted():
        with recording_warp_calls(calls):
            halo.demons_z_sharded(fixed, moving, space4, SPACING,
                                  halo=MD_HALO, **short)
            halo.demons_z_sharded(f_s, m_s, space4, sp_small, halo=MD_HALO,
                                  **dict(lncc_kw, iterations=1))
            halo.warp_z_sharded(moving, d_sh, space4, SPACING,
                                background=-3001.0, halo=MD_HALO)
            halo.demons_batch_z_sharded(np.stack([fixed, moving]),
                                        np.stack([moving, fixed]), both,
                                        SPACING, halo=MD_HALO, **short)
            ri.register_rigid_intensity_batch(
                refs, movs, *geo_in, intensity_scale=scale, mesh=data4,
                levels=tuple((s, 1, lr) for s, _, lr in RIGID_LEVELS))
        warp_rows = warp_path_rows(calls)
    del calls
    torch.cuda.empty_cache()
    emit("multi_device", seconds=seconds, shards=MD_SHARDS,
         meshes=dict(space=space4.shape, both=both.shape, data=data4.shape),
         launches=launches, **rows)

    def profile():
        return halo.demons_z_sharded(fixed, moving, space4, SPACING,
                                     halo=MD_HALO, **demons_kw)

    return dict(launches=launches, shapes=shapes, hist_calls=hist_calls,
                hist_shapes=hist_shapes, warp_rows=warp_rows,
                profile=profile)


# the kernels each example's path launches on the card at least once; a
# tuple of names: at least one of them (the affine mode's two entries)
EXAMPLE_KERNELS = {
    "end_to_end": ("warp_coords", AFFINE_KERNELS, "warp_disp"),
    "registration_suite": ("warp_coords", AFFINE_KERNELS, "warp_disp"),
    "adaptive_rt": ("warp_disp", "dose_hist"),
    "cohort_scale": ("warp_coords", "warp_disp", "dose_hist")}


def phase_validate():
    """validate_kernels(fast=False) on the card: every hand kernel held
    bit-equal to its plain version and to its host golden at the JAX
    fixtures (medicalimageanalysis_torch/validate.py). A kernel that does
    not build or launch raises there; a failed check fails the run."""
    from medicalimageanalysis_torch.validate import validate_kernels

    t0 = time.perf_counter()
    result = validate_kernels(fast=False)
    seconds = time.perf_counter() - t0
    emit("validate", seconds=seconds, **result)
    assert result["backend"] == "cuda", result["backend"]
    assert result["ok"], {k: result["detail"][k]
                          for k, ok in result["checks"].items() if not ok}


def phase_examples():
    """The four examples (medicalimageanalysis_torch/examples) on the
    card at their own sizes, each in a folder of its own: each one's own
    asserts hold inside its main; its wall time, launches and printed
    lines. They replace the Data registry, so they run before the
    paths."""
    import contextlib
    import importlib
    import io

    rows = {}
    with tempfile.TemporaryDirectory(prefix="mia_examples_") as root:
        for name, expect in EXAMPLE_KERNELS.items():
            module = importlib.import_module(
                f"medicalimageanalysis_torch.examples.{name}")
            before = launch_counts()
            printed = io.StringIO()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                module.main(workdir=os.path.join(root, name))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = {k: v - before[k] for k, v in launch_counts().items()}
            rows[name] = dict(seconds=seconds, launches=launched,
                              printed=printed.getvalue().splitlines())
            missing = [k for k in expect if not any(
                launched[n] for n in ((k,) if isinstance(k, str) else k))]
            assert not missing, f"example {name} never launched {missing}"
    emit("examples", seconds=sum(r["seconds"] for r in rows.values()),
         **rows)


def untimed_calls(kernels, calls):
    """The recorded calls (recording_affine_calls) at keys no path's row
    (merge_warp_rows) of their kernel times yet: a synthetic map's row
    at the key gives way to the path's own call."""
    timed = {name: {k for k, row in kernels[name]["timed"].items()
                    if "synthetic_field_ms" in row}
             for name in {name for name, _ in calls}}
    return {(name, key): args for (name, key), args in calls.items()
            if key not in timed[name]}


@contextlib.contextmanager
def timing_affine_calls(kernels, label):
    """Within the block, record the path's affine calls
    (recording_affine_calls); after it, hold and time those at keys no
    path's row times yet on their own tensors (warp_path_rows), uncounted,
    and merge them under ``label``: every affine launch of the path is
    then weighed by a call of its own path or of an earlier one."""
    calls = {}
    with recording_affine_calls(calls):
        yield
    with uncounted():
        merge_warp_rows(kernels, warp_path_rows(untimed_calls(kernels,
                                                              calls)), label)
    del calls
    torch.cuda.empty_cache()


def untimed_rows(kernels, shapes):
    """[path, kernel, B, grad, "ZxYxX" out, "ZxYxX" volume, launches] of
    every warp launch shape no row times, by path."""
    out = []
    for path, per_path in shapes.items():
        for (k, B, grad, shape, vin), n in sorted(per_path.items()):
            if launch_key(k, B, grad, shape, vin) not in kernels[k]["timed"]:
                out.append([path, k, B, int(grad), "x".join(map(str, shape)),
                            "x".join(map(str, vin)), n])
    return out


def registry_state():
    """The port's registry, every dict and list of it."""
    from medicalimageanalysis_torch.data import Data

    return {k: getattr(Data, k) for k in (
        "image", "rigid", "deformable", "dose", "plan", "image_list",
        "rigid_list", "deformable_list", "dose_list", "plan_list",
        "roi_list", "poi_list")}


def set_registry(state):
    """Put back a registry_state()."""
    from medicalimageanalysis_torch.data import Data

    for k, v in state.items():
        setattr(Data, k, v)


def phase_preprocess(gen, dev):
    from medicalimageanalysis_torch.ops.filters import _gauss_kernel_matrix
    from medicalimageanalysis_torch.parallel.batch import make_preprocess_fn

    B, in_shape, out_shape = 8, (40, 256, 256), (40, 128, 128)
    # smooth structure around the -250 HU threshold plus noise, so the
    # mask has edges everywhere
    z, y, x = (torch.arange(n, dtype=torch.float32) for n in in_shape)
    field = 800.0 * torch.sin(x / 9.0)[None, None, :] \
        * torch.cos(y / 13.0)[None, :, None] \
        * torch.cos(z / 7.0)[:, None, None] - 226.0
    raw = (field + 60.0 * torch.randn((B,) + in_shape, generator=gen)
           ).round().to(torch.int16)
    slope = torch.ones(B)
    intercept = torch.full((B,), -24.0)
    fn_dev = make_preprocess_fn(in_shape, out_shape, device=dev)
    fn_cpu = make_preprocess_fn(in_shape, out_shape, device="cpu")
    rd, sd, idv = raw.to(dev), slope.to(dev), intercept.to(dev)
    vd, md = fn_dev(rd, sd, idv)
    vc, mc = fn_cpu(raw, slope, intercept)
    vd, md = vd.cpu(), md.cpu()
    # rtol 1e-5 on HU values; the atol covers the zero crossings, where
    # a relative bound means nothing (cuBLAS sums in another order)
    atol = 1e-5 * float(vc.abs().max())
    assert torch.allclose(vd, vc, rtol=1e-5, atol=atol)
    # masks: identical except at voxels whose blurred value sits within
    # 1e-3 HU of the -250 threshold, where the sum order may flip them
    blurred = vc
    for eq, n in (("ij,bjyx->biyx", out_shape[0]),
                  ("kj,bzjx->bzkx", out_shape[1]),
                  ("lj,bzyj->bzyl", out_shape[2])):
        blurred = torch.einsum(eq, torch.as_tensor(
            _gauss_kernel_matrix(n, 1.0)), blurred)
    near = (blurred + 250.0).abs() <= 1e-3
    differ = md != mc
    n_differ, n_near = int(differ.sum()), int(near.sum())
    assert not (differ & ~near).any(), "mask differs away from threshold"
    assert n_differ <= n_near
    us = 1e3 * cuda_ms(lambda: fn_dev(rd, sd, idv), reps=10) / B
    emit("preprocess", batch=B, in_shape=list(in_shape),
         out_shape=list(out_shape), us_per_series=us,
         max_abs_err=float((vd - vc).abs().max()), atol=atol,
         mask_voxels_differ=n_differ, mask_voxels_near_threshold=n_near)


# ---------------------------------------------------------------------------
def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from medicalimageanalysis_torch.config import config
    from medicalimageanalysis_torch.ops import hist, lane_interp, warp

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cpu_gen = torch.Generator().manual_seed(SEED)

    smi = phase_device()
    phase_build()
    kernels = {"warp_coords": phase_warp_coords(gen, dev),
               **phase_warp_affine(gen, dev),
               "warp_disp": phase_warp_disp(gen, dev),
               "dose_hist": phase_hist(gen, dev),
               "warp_affine_shear": phase_warp_affine_shear(gen, dev)}

    def reset_counts():
        for counts in (warp.LAUNCHES, hist.LAUNCHES, lane_interp.LAUNCHES):
            for key in counts:
                counts[key] = 0
        warp.LAUNCH_SHAPES.clear()
        hist.LAUNCH_SHAPES.clear()

    reset_counts()                         # validate_kernels starts here
    phase_validate()
    validate_launches = launch_counts()    # ... and ends here
    shapes = {"validate": launch_shapes()}
    reset_counts()                         # the four examples start here
    phase_examples()
    examples_launches = launch_counts()    # ... and end here
    shapes["examples"] = launch_shapes()
    with tempfile.TemporaryDirectory(prefix="mia_smoke_") as folder:
        truth, ref = write_pair(cpu_gen, folder)
        reset_counts()                     # the rigid path starts here
        with timing_affine_calls(kernels, "rigid"):
            names = phase_ingest(folder, dev)
            rigid, warm = phase_rigid(names, truth)
            phase_reslice(rigid, dev)
            rigid_launches = launch_counts()   # ... and ends here
            shapes["rigid"] = launch_shapes()
        reset_counts()                     # the cohort rigid starts here
        cohort = phase_cohort_rigid(names, truth, rigid, dev)
        cohort_launches = launch_counts()  # ... and ends here
        shapes["cohort_rigid"] = launch_shapes()
        merge_warp_rows(kernels, cohort[3].pop("warp_rows"), "cohort_rigid")
        deformed = os.path.join(folder, "deformed")
        write_deformed(ref, deformed)
        del ref
        reset_counts()                     # the deformable path starts here
        with timing_affine_calls(kernels, "deformable"):
            names = phase_deformable(deformed, names, dev)
            variant_rows = phase_deformable_variants(names, dev)
            deformable_launches = launch_counts()  # ... and ends here
            shapes["deformable"] = launch_shapes()
            merge_warp_rows(kernels, variant_rows, "deformable_variants")
        reset_counts()                     # the dose-QA path starts here
        with timing_affine_calls(kernels, "dose_qa"):
            with recording_hist_calls({}) as hist_calls:
                img_name, dose_name = phase_dose_qa(folder, names, dev)
            dose_qa_launches = launch_counts()  # ... and ends here
            shapes["dose_qa"] = launch_shapes()
        hist_shapes = dict(hist.LAUNCH_SHAPES)
        # the histogram at each shape the path launched, on its tensors
        path = hist_path_lost(hist_calls, hist_shapes)
        kernels["dose_hist"]["max_abs_err"] = max(
            kernels["dose_hist"]["max_abs_err"], path.pop("path_max_abs_err"))
        kernels["dose_hist"].update(path)
        del hist_calls
        torch.cuda.empty_cache()
        reset_counts()                     # the plan-QA path starts here
        with timing_affine_calls(kernels, "plan_qa_reslices"):
            plan = phase_plan_qa(names, img_name, dose_name, dev)
            plan_qa_launches = launch_counts()  # ... and ends here
            shapes["plan_qa"] = launch_shapes()
            merge_warp_rows(kernels, plan.pop("warp_rows"), "plan_qa")
        torch.cuda.empty_cache()
        reset_counts()                     # the ROI mesh path starts here
        mesh_path = phase_roi_mesh(names, img_name, dose_name, rigid, dev)
        roi_mesh_launches = launch_counts()  # ... and ends here
        shapes["roi_mesh"] = launch_shapes()
        merge_warp_rows(kernels, mesh_path.pop("warp_rows"), "roi_mesh")
        reset_counts()                     # the rest of the mesh slice
        mesh_rest = phase_mesh_rest(mesh_path, names, img_name, dose_name,
                                    rigid, dev)
        mesh_rest_launches = mesh_rest["launches"]  # ... ends in it
        shapes["mesh_rest"] = mesh_rest["shapes"]
        # the Deformable cut's warp on its own tensors, as below
        merge_warp_rows(kernels, mesh_rest.pop("warp_rows"), "mesh_rest")
        mesh = phase_mesh_warp(mesh_path, dev)
        mesh["work"]["voxelize"] = mesh_rest.pop("work")
        del mesh_path
        # the mesh warp's launch at the external's points, timed
        row = mesh["kernel_row"]
        coords = kernels["warp_coords"]
        coords["timed"][timed_key(3, False, row.pop("shape"))] = row
        coords["max_abs_err"] = max(coords["max_abs_err"], row["max_abs_err"])
        coords["mesh_warp"] = row
        reset_counts()                     # the image-analysis path starts
        affine_calls = {}
        with recording_affine_calls(affine_calls):
            analysis = phase_image_analysis(folder, names, img_name,
                                            dose_name, dev)
        image_analysis_launches = launch_counts()  # ... and ends here
        shapes["image_analysis"] = launch_shapes()
        # the CT onto the dose grid: its affine launch timed, in place of
        # the synthetic map's row at its key
        row, name, key = affine_at_dose_grid(img_name, dose_name, dev)
        merge_warp_rows(kernels, {name: {key: dict(
            row, max_abs_err=[row["max_abs_err"]])}}, "at_dose_grid")
        # the Display's frames and demons_batch again, each warp launch
        # key held and timed on their own tensors, and the path's affine
        # launches at keys no row times yet (the ITV's planning grid):
        # these rows weigh the launches at their keys in ms_lost on every
        # path
        calls = untimed_calls(kernels, affine_calls)
        with recording_warp_calls(calls):
            for rerun in analysis.pop("warp_calls").values():
                rerun()
        merge_warp_rows(kernels, warp_path_rows(calls), "image_analysis")
        del calls, affine_calls
        reset_counts()                     # the IO path starts here
        io = phase_io(folder, names, img_name, dose_name, rigid, dev)
        io_launches = io["launches"]       # ... and ends in it
        shapes["io"] = io["shapes"]
        # its histogram and warp launches on its own tensors, as above
        row = io["hist"]
        hist_k = kernels["dose_hist"]
        hist_k["max_abs_err"] = max(hist_k["max_abs_err"],
                                    row.pop("path_max_abs_err"))
        for key in ("ms_lost", "launches_timed_shapes",
                    "launches_untimed_shapes"):
            hist_k[key] += row[key]
        hist_k["io"] = row
        merge_warp_rows(kernels, io["warp_rows"], "io")
        torch.cuda.empty_cache()
        reset_counts()                     # the ingest_rest path starts
        phase_ingest_rest(folder, names, cpu_gen, dev)
        ingest_rest_launches = launch_counts()  # ... and ends here
        shapes["ingest_rest"] = launch_shapes()
        reset_counts()                     # the registration_rest path
        reg = phase_registration_rest(names, img_name, cpu_gen, dev)
        registration_rest_launches = reg["launches"]  # ... ends in it
        shapes["registration_rest"] = reg["shapes"]
        # its warp launches on its own tensors, as above
        merge_warp_rows(kernels, reg.pop("warp_rows"), "registration_rest")
        torch.cuda.empty_cache()
        reset_counts()                     # the multi-device path starts
        md = phase_multi_device(folder, names, img_name, dose_name, cohort,
                                dev)
        multi_device_launches = md["launches"]  # ... and ends in it
        shapes["multi_device"] = md["shapes"]
        # its warp and histogram launches on its own tensors, as above
        merge_warp_rows(kernels, md.pop("warp_rows"), "multi_device")
        with uncounted():
            row = hist_path_lost(md.pop("hist_calls"), md.pop("hist_shapes"),
                                 phase="multi_device_hist_path")
        hist_k = kernels["dose_hist"]
        hist_k["max_abs_err"] = max(hist_k["max_abs_err"],
                                    row.pop("path_max_abs_err"))
        for key in ("ms_lost", "launches_timed_shapes",
                    "launches_untimed_shapes"):
            hist_k[key] += row[key]
        hist_k["multi_device"] = row
        torch.cuda.empty_cache()
        reset_counts()                     # the view path starts here
        # its affine launches at keys no path's row times yet (the
        # off-axis display's and the Rigid nudges' grids) timed after it
        with timing_affine_calls(kernels, "view"):
            view = phase_view(names, rigid, dev)
            view_launches = launch_counts()    # ... and ends here
            shapes["view"] = launch_shapes()
        reset_counts()      # the oblique entry alone, at the display's map
        phase_oblique_entry(names, *view["display_map"], dev)
        oblique_launches = launch_counts()
    # lane_interp against its plain twin at the passes the view path ran
    kernels["lane_interp"] = phase_lane_interp(gen, dev, view["passes"])
    assert rigid_launches["warp_coords"] and rigid_launches["warp_affine"], \
        f"a kernel of the rigid path never launched: {rigid_launches}"
    assert all(deformable_launches[k] for k in
               ("warp_coords", "warp_affine_axis", "warp_disp")), \
        f"a kernel of the deformable path never launched: " \
        f"{deformable_launches}"
    assert all(dose_qa_launches[k] for k in
               ("dose_hist", "warp_affine_axis", "warp_coords",
                "warp_disp")), \
        f"a kernel of the dose-QA path never launched: {dose_qa_launches}"
    assert cohort_launches["warp_coords"], \
        f"the cohort rigid never launched warp_coords: {cohort_launches}"
    assert all(plan_qa_launches[k] for k in
               ("warp_affine_axis", "warp_coords", "warp_disp")), \
        f"a kernel of the plan-QA path never launched: {plan_qa_launches}"
    assert roi_mesh_launches["warp_coords"], \
        f"the ROI mesh path never launched warp_coords: {roi_mesh_launches}"
    assert all(mesh_rest_launches[k] for k in
               ("warp_affine_axis", "warp_coords", "warp_disp")), \
        f"a kernel of the mesh_rest path never launched: " \
        f"{mesh_rest_launches}"
    assert all(image_analysis_launches[k] for k in
               ("warp_affine", "warp_affine_axis", "warp_coords",
                "warp_disp")), \
        f"a kernel of the image-analysis path never launched: " \
        f"{image_analysis_launches}"
    assert all(io_launches[k] for k in
               ("warp_affine", "warp_affine_axis", "warp_coords",
                "warp_disp", "dose_hist")), \
        f"a kernel of the IO path never launched: {io_launches}"
    # ingest_rest assembles with plain PyTorch: no kernel of its own
    assert all(validate_launches.values()), \
        f"a kernel never launched in validate_kernels: {validate_launches}"
    assert all(multi_device_launches[k] for k in
               ("warp_coords", "warp_disp", "dose_hist")), \
        f"a kernel of the multi-device path never launched: " \
        f"{multi_device_launches}"
    assert all(registration_rest_launches[k] for k in
               ("warp_affine", "warp_affine_axis", "warp_coords",
                "warp_disp")), \
        f"a kernel of the registration_rest path never launched: " \
        f"{registration_rest_launches}"
    # three lane_interp passes per shear reslice; the exact reslices (the
    # display, its volume bundle, two Rigid nudges and two comparisons).
    # No view route reaches the oblique entry: affine_resample keeps the
    # direct affine mode for every map
    assert view_launches["lane_interp"] == 3 * view["n_shear"], \
        view_launches
    assert view_launches["warp_affine"] >= 6, view_launches
    assert view_launches["warp_affine_axis"] == 0, view_launches
    assert view_launches["warp_affine_shear"] == 0, view_launches
    assert view_launches["warp_coords"] == 0, view_launches
    # the oblique entry called alone: one V2 build, one affine_shear
    assert oblique_launches == dict(
        {k: 0 for k in oblique_launches}, warp_coords=1,
        warp_affine_shear=1), oblique_launches
    # every kernel's launches on the fifteen paths (validate_kernels and
    # the examples at their own sizes among them), and the warp launches
    # by shape over them
    paths = (validate_launches, examples_launches, rigid_launches,
             cohort_launches, deformable_launches, dose_qa_launches,
             plan_qa_launches, roi_mesh_launches, mesh_rest_launches,
             image_analysis_launches, io_launches, ingest_rest_launches,
             registration_rest_launches, multi_device_launches,
             view_launches)
    launches = {k: sum(p[k] for p in paths) for k in rigid_launches}
    all_shapes = {}
    for per_path in shapes.values():
        for key, n in per_path.items():
            all_shapes[key] = all_shapes.get(key, 0) + n
    assert sum(all_shapes.values()) == sum(
        launches[k] for k in WARP_KERNELS), (all_shapes, launches)
    emit("untimed_shapes", rows=untimed_rows(kernels, shapes))
    for name in WARP_KERNELS:
        kernels[name].update(ms_lost(name, kernels[name].pop("timed"),
                                     all_shapes))
    # lane_interp: each pass shape the view path ran, timed once
    kernels["lane_interp"]["ms_lost"] = kernels["lane_interp"].pop("lost")

    # the paths' calls again, each under the profiler: the hand-written
    # kernel, not a plain path, must be what ran on the card. The
    # profiles also show where the time goes: device events per step or
    # iteration, device time, and its share of the wall time.
    from medicalimageanalysis_torch.data import Data
    from medicalimageanalysis_torch.models.rigid_intensity import (
        register_rigid_intensity_batch)
    from medicalimageanalysis_torch.ops.registration.bspline import (
        bspline_registration)
    from medicalimageanalysis_torch.ops.registration.demons import (
        demons_registration)
    from medicalimageanalysis_torch.parallel.batch import rasterize_batch

    fixed = Data.image[names["ref"]].array
    moving = Data.image[names["deformed"]].array

    def shear_reslice():
        config.use_shear_warp = True
        try:
            rigid.display.compute_reslice()
        finally:
            config.use_shear_warp = False

    profiles = {
        "rigid": profile_device(rigid.compute_intensity, ["warp_coords"]),
        "reslice": profile_device(rigid.create_image, ["warp_affine"]),
        # one Rigid view reslice through the shear-warp lane
        "shear_reslice": profile_device(shear_reslice, ["lane_interp"]),
        # one full-size demons level (50 iterations) and one B-spline call
        # (100 steps), each from host arrays to a host field
        "demons_level": profile_device(lambda: demons_registration(
            fixed, moving, SPACING, method="fast", device=dev),
            ["warp_disp"]),
        "bspline": profile_device(lambda: bspline_registration(
            fixed, moving, SPACING, device=dev), ["warp_disp"]),
        # one DVH curve of the largest ROI, from the cached mask
        "dvh_curve_body": profile_device(
            lambda: Data.dose[dose_name].compute_dvh_curve(
                img_name, "Body", n_bins=DVH_BINS),
            ["warp_affine_axis", "dose_hist"]),
        # the pooled rasterization of the structure set alone, without
        # the mask cache's host bit-packing
        "rasterize_batch": profile_device(lambda: rasterize_batch(
            [roi.contour_pixel for roi in Data.image[img_name].rois.values()
             if roi.contour_pixel is not None],
            tuple(int(v) for v in Data.image[img_name].dimensions))),
        # plan QA: one gamma (3 %/3 mm, the shifted dose) and one full-size
        # squared EDT (the Body mask), both plain PyTorch on the card
        "compute_gamma": profile_device(plan["gamma"],
                                        ["warp_affine_axis"]),
        "edt": profile_device(plan["edt"]),
        # one cohort level over the four pairs: the first level's stride
        # and rate, COHORT_PROFILE_STEPS steps (the trace's processing
        # grows with its events, 58,000 at the level's 60 steps)
        "cohort_level": profile_device(lambda: register_rigid_intensity_batch(
            cohort[0], cohort[1], *cohort[2],
            levels=((RIGID_LEVELS[0][0], COHORT_PROFILE_STEPS,
                     RIGID_LEVELS[0][2]),),
            intensity_scale=1.0 / 65535.0), ["warp_coords"]),
        # the ROI mesh path: a mesh build (the external), the
        # marching-tetrahedra pass, the Taubin smoothing, the mesh warp;
        # the external's voxelization (mesh_rest)
        **mesh["profiles"], "voxelize": mesh_rest["profile"],
        # the image-analysis path: the MR's first N4 fitting level (up to
        # 50 iterations) and the PTV's texture_matrices, plain PyTorch
        **{name: profile_device(fn)
           for name, fn in analysis["profiles"].items()},
        # the IO path: the deformable REG's read and upload (403 MB)
        "io_reg_read": io["profile"],
        # the multi-device path: one demons_z_sharded call (4 logical
        # shards, 50 iterations), beside demons_level
        "demons_z_sharded": profile_device(md["profile"], ["warp_disp"])}
    descent = profiles["rigid"]
    descent["device_events_per_step"] = \
        descent["device_events"] / sum(s for _, s, _ in RIGID_LEVELS)
    # against the unprofiled warm call and its descent
    descent["device_share_of_warm_call"] = \
        descent["device_ms"] / warm["wall_ms"]
    descent["device_share_of_warm_descent"] = \
        descent["device_ms"] / sum(warm["ms_per_level"])
    profiles["demons_level"]["device_events_per_iteration"] = \
        profiles["demons_level"]["device_events"] / 50
    profiles["demons_z_sharded"]["device_events_per_iteration"] = \
        profiles["demons_z_sharded"]["device_events"] / MD_ITERATIONS
    profiles["bspline"]["device_events_per_step"] = \
        profiles["bspline"]["device_events"] / 100
    profiles["taubin_smooth"]["device_events_per_step"] = \
        profiles["taubin_smooth"]["device_events"] / 40
    profiles["cohort_level"]["device_events_per_step"] = \
        profiles["cohort_level"]["device_events"] / (
            len(COHORT_POSES) + 1) / COHORT_PROFILE_STEPS
    emit("kernel_ran", launches=launches,
         launches_validate=validate_launches,
         launches_examples=examples_launches,
         launches_rigid_path=rigid_launches,
         launches_cohort_rigid_path=cohort_launches,
         launches_deformable_path=deformable_launches,
         launches_dose_qa_path=dose_qa_launches,
         launches_plan_qa_path=plan_qa_launches,
         launches_roi_mesh_path=roi_mesh_launches,
         launches_mesh_rest_path=mesh_rest_launches,
         launches_image_analysis_path=image_analysis_launches,
         launches_io_path=io_launches,
         launches_ingest_rest_path=ingest_rest_launches,
         launches_registration_rest_path=registration_rest_launches,
         launches_multi_device_path=multi_device_launches,
         launches_view_path=view_launches,
         launches_oblique_entry=oblique_launches,
         launch_shapes={k: shape_rows(v) for k, v in shapes.items()},
         **profiles)
    for name, p in profiles.items():
        check_profile(name, p)
    emit("plain_programs", **plain_program_rows(profiles, plan,
                                                mesh["work"],
                                                analysis["work"]))
    phase_preprocess(cpu_gen, dev)
    # the port and this script ran without JAX and without the JAX package
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "medicalimageanalysis_tpu"))
    assert not loaded, f"JAX or the JAX package was imported: {loaded}"

    rows = [{"name": name, "route": "cuda",
             "source": "medicalimageanalysis_torch/csrc/warp.cu",
             "replaces": "medicalimageanalysis_tpu/ops/pallas_warp.py:181",
             "launches": launches[name], **kernels[name]}
            for name in ("warp_coords", "warp_affine", "warp_affine_axis",
                         "warp_disp", "warp_affine_shear")]
    # affine_shear is reached only by affine_warp_oblique called directly:
    # validate_kernels' oblique check calls it, no other path does; the
    # entry's own call at the display's map counted beside
    rows[-1]["launches_oblique_entry"] = oblique_launches["warp_affine_shear"]
    rows.append({"name": "dose_hist", "route": "cuda",
                 "source": "medicalimageanalysis_torch/csrc/hist.cu",
                 "replaces":
                 "medicalimageanalysis_tpu/ops/pallas_kernels.py:29",
                 "launches": launches["dose_hist"], **kernels["dose_hist"]})
    rows.append({"name": "lane_interp", "route": "cuda",
                 "source": "medicalimageanalysis_torch/csrc/lane_interp.cu",
                 "replaces":
                 "medicalimageanalysis_tpu/ops/pallas_kernels.py:93",
                 "launches": launches["lane_interp"],
                 **kernels["lane_interp"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
