#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stereo_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each ending in one flushed JSON line with its name and seconds
(and, once the card is in use, the smoke's card memory after it:
``card_memory_bytes``):

1. device:   the card's name, count and ``nvidia-smi`` name/power limit;
2. build:    one ``nvcc`` call builds every ``stereo_tpu_torch/csrc/*.cu``
             into one library (0 s when the library is already built),
             with each kernel's registers, spills and static shared memory;
   io:       one ``g++`` call builds the native host runtime
             (``stereo_tpu_torch/_native``); the committed KITTI fixture
             frames decoded by it equal the Python decoder's bytes, and the
             host ms of a 375x1242 frame for each decoder; the other PNG
             kinds (low-bit grey, palettes, grey+alpha, 16-bit colour, each
             plain and Adam7) against the Python decoder; every committed
             JPEG fixture (``tests/fixtures/jpeg``) decoded by the native
             JPEG decoder to the SHA-256 of PIL's decode in its manifest,
             and the host ms of the 375x1242 JPEG frame; every committed
             BMP, TIFF, GIF, PNM and PFM fixture (``tests/fixtures/raster``)
             to its manifest's SHA-256s (PIL's RGB, the JAX trainer's
             ground truth), and the host ms of the fixture frame as a BMP,
             a PPM and an uncompressed, LZW and Deflate TIFF;
3. kernels:  each kernel against its plain PyTorch version at the shapes of
             the single-view paths (384x1280, disparity 1..64; GwcNet's
             volume also at disparity 192 and in bf16), with its median
             time (``ms``: launch and run; ``device_ms``: run alone;
             ``host_us``: launch alone), the plain version's time and its
             bound; the classical kernels also on adversarial integer
             pairs (every plane a winner, all planes tied) and windows
             (smallest and largest disparity, across the wrap),
             ``gwc_volume`` (``GWC_VARIANTS``, each in float32 and bf16)
             at 4, 5, 8, 16 and 32 channels per group, at disparity 192,
             at the row shards of tile 4 and 2 ((1, 320, 24, 320) and
             (1, 320, 48, 320)), at a width off its strip and a width
             under D, each also against the volume in float64, and
             ``upsample_blend`` also at the servers' batch of 2, at scale 2,
             at widths that are not a multiple of its tile or are under D,
             and at a scale (8) it takes at run time;
   kernels_middlebury: the same for the classical kernels at
             ``MatchingConfig()``, 1080x1920 / disparity 75..262;
4. golden:   the classical matcher on the synthetic KITTI pair against the
             committed golden (>= 99% of pixels within 0.5 px);
5. pipeline: ``DepthEstimationPipeline`` on single views at full width
             (the fused route: two CUDA graphs), the result against the
             same frame through the plain versions, and its ms/frame with
             the per-stage times;
   profile:  device time by kernel over a few frames (``torch.profiler``)
             and the device's busy share of the wall time, and the
             device's time per frame by CUDA events, which see the kernels
             of a replayed graph;
   fused_single_view: ``FusedSingleViewEngine`` against the unfused
             ``SingleViewEngine`` on the same frames at batch 1 and 2:
             disparities and right views, launches per frame (equal),
             ms/frame of both, device time and busy share, graphs captured;
             two captures that fail raise, keep no graph and leave
             ``empty_cache`` able to free the default pool;
   fresh_deep3d: ``RightViewSynthesis()`` with its defaults (fresh weights
             and a warning where the checkout has no ``deep3d.npz``), one
             frame;
6. dnn:      the same pipeline with the GwcNet backend: single views
             (ms/frame, stages, the disparity against the same frame
             through ``gwc_volume_plain``), the synthetic KITTI pair, GwcNet
             at disparity 192 and its feature extractor alone, a few
             forwards each of MSNet2D, MSNet3D and GwcNet in bf16, and a
             seeded GwcNet at 4 channels per group against its plain
             volume;
   profile_dnn: the GwcNet single view's device time by kernel;
7. evaluation: ``run_depth_estimation_pipeline_evaluation`` with the six
             metrics on the KITTI fixture drive (``KittiSingleViewCamera``,
             Velodyne ground truth): classical and GwcNet, each with the
             real right view and with Deep3D's, each arm's metrics and
             disparities against the same arm through the plain versions;
   runner:   ``run_depth_estimation_pipeline`` on the drive (classical,
             Deep3D) with every saver, each file read back (PNGs, PLYs, the
             mp4, each of its frames read by the port's own MPEG-4 decoder
             within ``VIDEO_PSNR_FLOOR_DB`` of the context PNG of its
             index), the mp4's bytes a frame and the host ms to encode a
             grid, the batched runner at batch 2 against it, the
             frames/s of both runners, and one frame under
             ``device_trace``, whose Chrome trace must hold the kernels;
   video_stream: ``VIDEO_STREAM_FRAMES`` KITTI grids (1192x1300, the
             runner's context grids rolled sideways a few pixels a frame)
             streamed through ``open_video_writer``, past the ~923 frames
             at which the uncompressed AVI the port wrote before hit 4
             GiB: every frame counted in ``stsz``, 64-bit chunk offsets
             (``co64``), the last frame decoded within the floor; the
             median host ms to encode a frame and the bytes a frame;
   middlebury: ``middlebury_pair()`` written as a Middlebury scene, run
             through ``MiddleburyStereoCamera``, the config it implies and
             the runner at 1080x1920 / disparity 75..262, against the same
             pair through the plain versions, with its ms/frame;
   synthetic: the ``--synthetic`` evaluation at the JAX script's
             defaults (``SyntheticStereoCamera``, seed 20260817, 8 frames at
             384x1280): classical and GwcNet with the real right view, whose
             D1 must be within 1e-3 of the JAX package's record, GwcNet in
             bf16 held to float32 on the same frames, and both with
             Deep3D's view; each arm against the plain versions;
   orbax:    Orbax checkpoints: the committed fixture (JAX's
             ``save_params``: OCDBT, zstd, two chunks of a sharded array)
             read by the port, every leaf against its npz twin bit for
             bit, and its zarr3 twin (``orbax_small_zarr3``, zarr v3
             ``sharding_indexed`` arrays) against the same npz; the zstd
             decoder's MB/s on its 1 MiB array;
             GwcNet's committed weights and Deep3D's (committed or
             seeded, as ``make_synthesis`` has them) written by the
             port's ``save_params`` and loaded back by ``checkpoint_dir``:
             the GwcNet and the classical (fused) single view at 384x1280
             equal to the npz-loaded runs bit for bit, all four kernels
             launched; each tree's host load ms against its npz; whether
             the machine has ``zstd.h`` or ``libzstd.so.1``;
   train_deep3d: ``Trainer`` (Deep3D at 384x1280 / 96x320, batch 2) on the
             fixture drive: a step without dropout against the same step
             on the CPU, a few steps, ms/step and peak memory, and the
             export through ``RightViewSynthesis``'s ``upsample_blend``
             against the plain version;
   train_stereo: GwcNet at its published widths: ``SyntheticStereoTrainer``
             at its defaults (256x512, disparity 64, batch 4), its first
             step against the CPU's, a few steps; ``StereoTrainer`` for an
             epoch on four 16-bit-GT triplets, and from the same seed with
             the ground truth as PFM and as float TIFF (the same losses);
             the export through the GwcNet backend's ``gwc_volume`` against
             the plain version;
   scripts:  the five entry points (``python -m
             stereo_tpu_torch.scripts.<name>``: the evaluation, the KITTI
             and Middlebury runs, both training scripts for 2 steps), each
             in its own process;
8. server:   ``DepthEstimationServer`` on a free local port answers nine
             uploads (seeded PNGs; the fixture frame as PNG, JPEG, BMP, LZW
             TIFF and PPM, resized by the server, each decoded tensor equal
             to the PNG's; the GIF fixture), then shuts down, once with the
             classical backend and once with GwcNet;
   server_asgi: ``create_asgi_app`` around the classical pipeline, driven
             through ASGI's scope/receive/send: GET, a raw and a multipart
             POST of the fixture frame, and a bad payload (400).
9. the mesh, virtual: every mesh names cuda:0 n times
   (``mesh_devices=[cuda:0] * n``), so its shards run in turn on the card:
   mesh_kernels: the row-halo mode (``rows_prepadded``) of
             ``matching_core`` and ``sampled_window`` against their plain
             versions bit for bit on the row shards of KITTI (tile 2 and
             4) and ``MatchingConfig()`` (tile 4): the integer pairs, the
             real pair and the four winner maps, with times and bounds;
   mesh:     ``ShardedClassicalEngine`` through the pipeline against the
             single-device engine: KITTI on (1,4,1), (2,2,1) and (1,1,3),
             Middlebury on (1,4,1) and (1,2,5); equal on the integer pairs,
             >= 99% within 0.5 px on the real ones; ms/frame of each;
   mesh_single_view: the single view on (2,2,1), batch 4
             (``ShardedSingleViewEngine``, Deep3D's rows split over the
             tile pair), against the single-device pipeline's
             ``process_batch``;
   mesh_dnn: GwcNet (committed weights) on (2,2,2), batch 4, each
             group's frame split by rows over its 2 tile devices, against
             the single-device backend frame by frame within 5e-3 px;
   mesh_server: a server on a classical (2,1,1) mesh pipeline,
             micro-batch 2, and ``check_devices`` over the mesh;
   mesh_dnn_rows: GwcNet in float32 and bf16, MSNet2D and MSNet3D
             (committed weights, disparity 64) on (1,4,1) and (1,2,1), at
             384x1280 and at 368x1280 (a shard's rows gather ahead of an
             hourglass's stride), one frame split by rows with a halo
             exchange per layer, each within 5e-3 px of the
             single-device backend, with ``gwc_volume`` launched once per
             shard, each run eagerly and replayed from the split's CUDA
             graph (equal bit for bit); the halo exchanges (and of
             them the gathers ahead of a stride) and bytes per frame, graphs captured, launches per
             replay, ms/frame, device ms and busy share of both runs and
             of whole frames dealt, kernels per frame (``torch.profiler``)
             and peak memory beside the single device's;
   mesh_single_view_rows: the single view (Deep3D at 96x320) on (1,2,1),
             (1,4,1), (2,2,1) and (1,8,1) (12 down rows a shard, gathered
             before VggBlock_2's pool), batch 4, Deep3D's rows split over the
             tile devices (``row_split``), eagerly and replayed (equal bit
             for bit), ``upsample_blend`` once per shard and frame, the
             disparities equal to the single device's or within JAX's gate,
             the right views' largest difference, and the ms/frame of the
             split (device ms, busy share), of whole frames dealt and of
             the single device;
   mesh_train: Deep3D's sharded training step (``parallel.train``, the
             graft entry's step (b)) at 384x1280 / 96x320, batch 2, on
             (2,1,1), (1,2,1), (2,2,1), (1,4,1) and (1,8,1): three steps
             from the smoke's Deep3D weights against the single-device
             ``Trainer``, dropout off and then on from one generator seed;
             the largest loss and gradient gaps, replica equality, halo
             rounds forward and backward, ms/step (median), device ms and
             peak memory beside the single device's; no kernel launches
             (training runs the plain compositions); then a ``memory``
             line after ``train_stereo``, after ``mesh_train``, after
             a collection (``free_card``) and after cuBLAS's workspaces
             are freed: the allocator's counters, the bytes by pool and
             stream, and the segments a live block pins
             (``memory_line``);
   multiprocess: (run right after ``build``, while the smoke's own
             process holds none of the card's memory) the mesh across
             processes: two ranks spawned on cuda:0,
             a gloo group on a file store (``initialize_distributed``),
             each rank listing its own entries of cuda:0 and ``make_mesh``
             joining them in rank order: KITTI's classical kernel path on
             (1,2,1) and (1,4,1) with the ring across the ranks, the
             blockwise path on (1,1,3) with the argmax and the owned gather
             across them, and the single view and GwcNet on (2,2,1) with
             ``data`` across the ranks, and GwcNet's rows split across
             the ranks at 384 and 368 rows; every rank's result equal bit for
             bit to the same mesh in one process; ms/frame of both, the
             bytes staged through the host per frame (gloo moves host
             tensors), the launches of both ranks; and Deep3D's training
             step on (2,1,1) with ``data`` across the ranks, its losses,
             weights and Adam state on both ranks equal bit for bit to
             the same mesh in one process, and with a tile group across
             the ranks: (1,2,1), (1,4,1) and (1,8,1), one, two and four
             shards a rank.

The kernel launch counts are zeroed just before each path of phases 5-9
(the exported networks' inference included) is driven and read just
after; every kernel of that path must have launched, and the mesh phases
together must launch all four kernels and both row-halo modes.  Training launches
none: the networks train in their training mode, which runs the
differentiable plain compositions, as the JAX package trains through XLA.
A line ``{"training": ...}`` gives each trainer's ms/step and peak
memory.  Then a JSON line with every kernel's numbers (its launches
summed over those paths, the ranks of ``multiprocess`` included, each
counting its own; the Middlebury entries' over the ``middlebury``
phase and the Middlebury meshes; the row-halo entries,
``matching_core[rows_prepadded]`` and ``sampled_window[rows_prepadded]``,
timed at shard 1 of KITTI's tile 4), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero without that last line; so does a machine without CUDA.
Every network loads its committed checkpoint (``data/checkpoints/*.npz``)
when it is present, else seeded random weights at the same width; the
phase lines say which.

    python3 chip_smoke.py --phases multiprocess synthetic

runs the device and build phases and then only the named phases, in
the order of ``ONLY_PHASES``, with their gates (``io``,
``multiprocess``, ``mesh_dnn_rows``, ``orbax``, ``server`` (the classical
pipeline's), ``train_stereo``,
``mesh_single_view_rows``, ``mesh_train``, ``synthetic``, ``runner``
with ``video_stream`` after it; Deep3D's
committed weights when ``data/checkpoints/deep3d.npz`` is present, which
the whole smoke's copy may leave out), ending with the ``nvidia-smi``
line and no kernels line.
``--memory-history`` (first, before ``--phases`` or alone) records every
allocation's stack (``torch.cuda.memory._record_memory_history``), so the
``memory`` lines name the repo's frame that made each live block.

    python3 chip_smoke.py --compare NAME=DIR [NAME=DIR ...]

times versions of the kernels against each other instead: each ``DIR``
holds any of ``matching_core.cu``, ``sampled_window.cu``,
``upsample_blend.cu`` and ``gwc_volume.cu`` with the launchers' C
interface, built into a library of its own (one ``nvcc`` call each, all
at once).  Each version of the classical kernels must equal the
plain versions (winners, MBM costs and windows) before it is timed; then
all are timed in turns (first to last, then last to first) at the KITTI
and Middlebury configs, ``matching_core`` also at a second disparity range
of each size, which splits its fixed cost from its cost per plane.  Each
version of ``upsample_blend`` must be within 2e-4 of its plain version and
is timed the same way at the KITTI shape and at the smoke's other shapes
of it.  Each version of ``gwc_volume`` must pass the main smoke's gates
against ``gwc_volume_plain`` at every one of ``GWC_VARIANTS``, and the
versions must equal each other in every element (bit for bit); then they
are timed the same way at each variant, with each variant's bound, the
device time of a copy that moves as many bytes (the card's rate for that
traffic), and the kernel's and the plain version's distance from the
volume in float64.
Each time is taken as ``ms`` (launch and run), ``device_ms`` (run alone)
and ``host_us`` (launch alone).
"""

from __future__ import annotations

import gc
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KITTI_GOLDEN = os.path.join(ROOT, "tests", "golden",
                            "kitti_synthetic_disparity_tpu.npz")
DEEP3D_NPZ = os.path.join(ROOT, "data", "checkpoints", "deep3d.npz")
# JAX's save_params of a seeded tree, and its npz twin beside it
# (tests/fixtures/make_orbax_fixture.py).
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "orbax_small")
# The same tree written with ``use_zarr3=True`` (zarr v3 arrays).
ORBAX_ZARR3_FIXTURE = ORBAX_FIXTURE + "_zarr3"
# The committed KITTI fixture drive: two 375x1242 frames per camera, each
# PNG Paeth-filtered as image libraries write them, and Velodyne scans.
FIXTURE_DRIVE = os.path.join(ROOT, "tests", "fixtures", "kitti", "2011_09_26",
                             "2011_09_26_drive_0001_sync")
FIXTURE_FRAMES = [os.path.join(FIXTURE_DRIVE, side, "data", name)
                  for side in ("image_02", "image_03")
                  for name in ("0000000000.png", "0000000001.png")]
# JPEGs written by Pillow and the SHA-256 of PIL's decode of each
# (tests/fixtures/make_jpeg_fixtures.py); the first frame above as a JPEG
# at quality 90 among them.
JPEG_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg")
JPEG_FRAME = os.path.join(JPEG_FIXTURES, "kitti_0000000000_q90.jpg")
# BMP, TIFF, GIF, PNM and PFM fixtures with the SHA-256 of PIL's decode.
RASTER_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "raster")
RASTER_GIF = os.path.join(RASTER_FIXTURES, "gif.gif")
# The fixture frame's formats for the host timings and the server: name ->
# content type.
FRAME_FORMATS = {"bmp": "image/bmp", "ppm": "image/x-portable-pixmap",
                 "tiff_raw": "image/tiff", "tiff_lzw": "image/tiff",
                 "tiff_deflate": "image/tiff"}
# A Middlebury calibration for ``middlebury_pair()``: MatchingConfig()'s
# 1080x1920 and disparity range 75..262.
MIDDLEBURY_CALIB = """cam0=[1758.23 0 953.34; 0 1758.23 552.29; 0 0 1]
cam1=[1758.23 0 953.34; 0 1758.23 552.29; 0 0 1]
doffs=0
baseline=111.53
width=1920
height=1080
ndisp=290
isint=0
vmin=75
vmax=262
dyavg=0
dymax=0
"""

# The lowest PSNR a frame of the context video may have against its source
# grid: the worst frame of the JAX package's mp4 (OpenCV's mp4v) of the
# fixture drive's context grids, 32.83 dB with the committed Deep3D's right
# view (33.01 dB with the real one, 33.34 dB with seeded Deep3D), less
# 1 dB; ``python tests/video_floor.py`` measures them, and
# tests/test_torch_video.py holds this floor to the real right view's.
VIDEO_PSNR_FLOOR_DB = 31.8
# Frames of the long-stream check (``phase_video_stream``).
VIDEO_STREAM_FRAMES = 1000

# The kernels each single-view path must launch.
CLASSICAL_KERNELS = ("upsample_blend", "matching_core", "sampled_window")
GWCNET_KERNELS = ("upsample_blend", "gwc_volume")

# The sources ``--compare`` builds from each version's directory.
COMPARED_SOURCES = ("matching_core.cu", "sampled_window.cu",
                    "upsample_blend.cu", "gwc_volume.cu")

# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def report(phase: str, start: float, **numbers) -> None:
    """One phase's line; once this process uses the card, with its card
    memory after the phase (bytes allocated and reserved by PyTorch, and
    free on the card)."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        numbers["card_memory_bytes"] = dict(
            allocated=torch.cuda.memory_allocated(),
            reserved=torch.cuda.memory_reserved(),
            free=torch.cuda.mem_get_info()[0])
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter()
                                                       - start, 3),
                      **numbers}), flush=True)


def require(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(message)


def cuda_ms(fn, reps: int, device_only: bool = False,
            spin_cycles: int = 1_000_000) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls (CUDA events around
    each call on an idle device), after one warm-up call.  The time counts
    the host's launch of the call's kernels as well as their run.  With
    ``device_only`` the device first spins for ``spin_cycles`` (by default
    about half a millisecond), so the host has queued the launches before
    the start event is reached: the time is then the device's alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, reps: int = 50) -> float:
    """Median host microseconds of one call of ``fn``, the calls queued
    back to back without a synchronization (a launch's host cost)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def timings(fn, reps: int = 50) -> dict:
    """A kernel wrapper's ``ms`` (launch and run), ``device_ms`` (run
    alone) and ``host_us`` (launch alone)."""
    return dict(ms=cuda_ms(fn, reps), device_ms=cuda_ms(fn, reps, True),
                host_us=host_us(fn, reps))


def bound(nbytes: float, ops: float) -> tuple:
    """Least time on the card for moving ``nbytes`` and doing ``ops``
    float32 operations: the larger of the two, and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kitti_pair():
    """The synthetic KITTI-config pair of the committed golden (true
    disparity 11): seeded integer RGB and its roll by -11 columns."""
    rng = np.random.default_rng(0)
    left = np.round(rng.uniform(0, 255, (3, 384, 1280))).astype(np.float32)
    return left, np.roll(left, -11, axis=-1)


def middlebury_pair():
    """A seeded integer RGB pair at ``MatchingConfig()``'s 1080x1920,
    true disparity 150 (inside 75..262)."""
    rng = np.random.default_rng(5)
    left = np.round(rng.uniform(0, 255, (3, 1080, 1920))).astype(np.float32)
    return left, np.roll(left, -150, axis=-1)


def integer_pairs(cfg, rng):
    """The integer-valued downscaled pairs ``matching_core`` is held to
    (every box sum is exact, so kernel and plain version must agree): a
    constant pair, where every plane ties and plane 0 must win everywhere;
    then for each plane p, seeded noise and its roll that makes p the
    winner, so that plane 0, plane D-1 and both sides of every chunk
    boundary of the kernel's disparity split are winners."""
    hd, wd = cfg.down_height, cfg.down_width
    lo, num_d = cfg.min_disparity_down, cfg.num_disparities_down
    flat = np.full((hd, wd), 128.0, np.float32)
    yield "constant", 0, flat, flat
    noise = rng.integers(0, 256, (hd, wd)).astype(np.float32)
    for p in range(num_d):
        yield f"plane {p}", p, noise, np.roll(noise, -(lo + p), axis=-1)


def check_classical(torch, cfg, dev, rng, pair, label: str,
                    plain_reps: int) -> list:
    """``matching_core`` and ``sampled_window`` against their plain versions
    at ``cfg`` (the pooled and full-res luma of ``pair``), with their
    median times, the plain versions' times and their bounds."""
    from stereo_tpu_torch.ops import mean_pool, rgb_to_grayscale
    from stereo_tpu_torch.ops.cuda import (matching_core, matching_core_plain,
                                           sampled_window,
                                           sampled_window_plain)

    h, w = cfg.height, cfg.width
    hd, wd = cfg.down_height, cfg.down_width
    lo, num_d, k = cfg.min_disparity_down, cfg.num_disparities_down, cfg.k
    shape = f"{h}x{w}, disparity {cfg.min_disparity}..{cfg.max_disparity}"

    # matching_core on the integer pairs: disparity within 1e-4 and MBM
    # costs within relative 1e-6 of the plain version; each case's winner
    # must be the plane it was built for on most pixels.
    err = mbm_rel = 0.0
    cases = 0
    for name, plane, left_i, right_i in integer_pairs(cfg, rng):
        ld = torch.from_numpy(left_i).to(dev)
        rd = torch.from_numpy(np.ascontiguousarray(right_i)).to(dev)
        disp_k, mbm_k = matching_core(ld, rd, cfg)
        disp_p, mbm_p = matching_core_plain(ld, rd, cfg)
        err = max(err, float((disp_k - disp_p).abs().max()))
        mbm_rel = max(mbm_rel, float(((mbm_k - mbm_p).abs()
                                      / mbm_p.abs().clamp_min(1)).max()))
        hit = float((disp_k == lo + plane).float().mean())
        require(hit >= (1.0 if name == "constant" else 0.5),
                f"matching_core {label} {name}: plane {plane} won on only "
                f"{hit} of the pixels")
        cases += 1
    require(err <= 1e-4, f"matching_core {label} disparity off by {err}")
    require(mbm_rel <= 1e-6, f"matching_core {label} mbm off by rel {mbm_rel}")

    # The real-valued luma may flip near-tie winners: >= 99% equal.
    left, right = pair
    lg = rgb_to_grayscale(torch.from_numpy(left).to(dev)).contiguous()
    rg = rgb_to_grayscale(torch.from_numpy(right).to(dev)).contiguous()
    lgd, rgd = mean_pool(lg, k).contiguous(), mean_pool(rg, k).contiguous()
    disp_kr, _ = matching_core(lgd, rgd, cfg)
    disp_pr, _ = matching_core_plain(lgd, rgd, cfg)
    frac_real = float(((disp_kr - disp_pr).abs() <= 0.5).float().mean())
    require(frac_real >= 0.99, f"matching_core {label} real pair: {frac_real}")
    times = timings(lambda: matching_core(lgd, rgd, cfg))
    plain_ms = cuda_ms(lambda: matching_core_plain(lgd, rgd, cfg), plain_reps)
    # Per pixel and plane, summing separably: one difference (sub, abs),
    # the 3x3 box and its subtraction from 255*area, the three MBM box
    # sums, two products and the winner test.
    r, s, m, L = (cfg.cost_patch_radius, cfg.small_mbm_radius,
                  cfg.mid_mbm_radius, cfg.large_mbm_radius)
    per = 2 + 4 * r + 1 + 4 * (L + s + m) + 2 + 1
    b_ms, b_by = bound(4 * hd * wd * (2 + 1 + 3), per * num_d * hd * wd)
    results = [dict(name="matching_core", kernel="matching_core", config=shape,
                    route="cuda",
                    source="stereo_tpu_torch/csrc/matching_core.cu",
                    replaces="stereo_tpu/ops/pallas/kernels.py:210",
                    max_abs_err=err, max_mbm_rel_err=mbm_rel,
                    integer_cases=cases, real_pair_frac_within_0p5=frac_real,
                    **times, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None)]

    # sampled_window on the real-valued luma: at the kernel's winners, at
    # the smallest and the largest disparity everywhere (taps at
    # negative disparities and beyond the first columns read across the
    # image's wrap), and at seeded winners over the whole range.
    maps = {"winners": disp_kr,
            "smallest": torch.full((hd, wd), float(lo), device=dev),
            "largest": torch.full((hd, wd), float(lo + num_d - 1), device=dev),
            "seeded": torch.from_numpy(rng.integers(lo, lo + num_d, (hd, wd))
                                       .astype(np.float32)).to(dev)}
    errs = {}
    for name, disp in maps.items():
        win_k = sampled_window(lg, rg, disp, cfg)
        win_p = sampled_window_plain(lg, rg, disp, cfg)
        errs[name] = float((win_k - win_p).abs().max())
    err = max(errs.values())
    require(err <= 2e-2, f"sampled_window {label} off by {errs}")
    times = timings(lambda: sampled_window(lg, rg, disp_kr, cfg))
    plain_ms = cuda_ms(lambda: sampled_window_plain(lg, rg, disp_kr, cfg),
                       plain_reps)
    # Per tap: (2r+1)^2 differences (sub, abs) and their sum.
    win, patch = 2 * k + 3, 2 * cfg.sad_patch_radius + 1
    b_ms, b_by = bound(4 * (2 * h * w + hd * wd + win * hd * wd),
                       3 * win * patch * patch * hd * wd)
    results.append(dict(name="sampled_window", kernel="sampled_window",
                        config=shape, route="cuda",
                        source="stereo_tpu_torch/csrc/sampled_window.cu",
                        replaces="stereo_tpu/ops/pallas/kernels.py:394",
                        max_abs_err=err, max_abs_err_by_map=errs, **times,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None))
    return results


def check_other_radii(torch, dev) -> dict:
    """The classical kernels at radii other than the defaults (the
    scaling bench's "light" set and the JAX kernel tests' Middlebury-style
    set), which run the kernels' instance with run-time radii: on integer
    pairs with the winner at each plane in turn they must equal the plain
    versions as at the defaults.  The image is small (10 tiles), so
    ``matching_core`` splits its 16 planes into 8 chunks here."""
    from stereo_tpu_torch.core.config import MatchingConfig
    from stereo_tpu_torch.ops.cuda import (matching_core, matching_core_plain,
                                           sampled_window,
                                           sampled_window_plain)

    rng = np.random.default_rng(4)
    errors = {}
    for name, radii in (("light", (1, 2, 1, 1, 2)), ("mid", (1, 3, 1, 2, 3))):
        cfg = MatchingConfig(height=96, width=320, min_disparity=8,
                             max_disparity=39, cost_patch_radius=radii[0],
                             sad_patch_radius=radii[1],
                             small_mbm_radius=radii[2],
                             mid_mbm_radius=radii[3],
                             large_mbm_radius=radii[4])
        full = rng.integers(0, 256, (96, 320)).astype(np.float32)
        lg = torch.from_numpy(full).to(dev)
        e = dict(disparity=0.0, mbm_rel=0.0, window=0.0)
        for p in range(cfg.num_disparities_down):
            shift = cfg.k * (cfg.min_disparity_down + p)
            rg = torch.from_numpy(
                np.roll(full, -shift, axis=-1).copy()).to(dev)
            ld, rd = lg[::2, ::2].contiguous(), rg[::2, ::2].contiguous()
            disp_k, mbm_k = matching_core(ld, rd, cfg)
            disp_p, mbm_p = matching_core_plain(ld, rd, cfg)
            win_k = sampled_window(lg, rg, disp_k, cfg)
            win_p = sampled_window_plain(lg, rg, disp_k, cfg)
            e["disparity"] = max(e["disparity"],
                                 float((disp_k - disp_p).abs().max()))
            e["mbm_rel"] = max(e["mbm_rel"], float(
                ((mbm_k - mbm_p).abs() / mbm_p.abs().clamp_min(1)).max()))
            e["window"] = max(e["window"], float((win_k - win_p).abs().max()))
        errors[name] = e
        require(e["disparity"] <= 1e-4 and e["mbm_rel"] <= 1e-6
                and e["window"] <= 2e-2, f"radii {name}: {e}")
    return errors


def phase_kernels(torch, cfg, dev) -> list:
    from stereo_tpu_torch.ops.cuda import upsample_blend, upsample_blend_plain

    rng = np.random.default_rng(1)
    h, w = cfg.height, cfg.width
    results = check_classical(torch, cfg, dev, rng, kitti_pair(), "KITTI",
                              plain_reps=5)

    # upsample_blend: softmax volume (1, 65, 96, 320), view in 0..1.
    prob, view = blend_inputs(torch, rng, dev, 1, 65, h // 4, w // 4, 4)
    out_k = upsample_blend(prob, view, 4)
    out_p = upsample_blend_plain(prob, view, 4)
    err = float((out_k - out_p).abs().max())
    require(err <= 2e-4, f"upsample_blend off by {err}")
    times = timings(lambda: upsample_blend(prob, view, 4))
    plain_ms = cuda_ms(lambda: upsample_blend_plain(prob, view, 4), 3)
    b_ms, b_by = bound(4 * (prob.numel() + view.numel() + out_k.numel()),
                       blend_ops(65, h, w, 4))
    results.append(dict(name="upsample_blend", kernel="upsample_blend",
                        route="cuda",
                        source="stereo_tpu_torch/csrc/upsample_blend.cu",
                        replaces="stereo_tpu/ops/pallas/blend.py:209",
                        max_abs_err=err, **times, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        cases=check_blend_cases(torch, dev)))
    results.append(check_gwc_volume(torch, rng, dev))
    return results


# upsample_blend's other shapes, (N, D, H/s, W/s, s): the servers'
# micro-batch, Deep3D's other scale, a width that is not a multiple of the
# kernel's tile, a width under D (every pixel's shift window cut at the
# edge; narrower than a tile, it takes the per-pixel kernel), and a scale
# the kernel takes at run time.
BLEND_CASES = ((2, 65, 96, 320, 4), (1, 65, 192, 640, 2),
               (1, 65, 24, 250, 4), (1, 65, 4, 12, 4), (1, 9, 12, 32, 8))

# The shapes the split single view gives it (``synthesis.split_blend``),
# (N, D, H/s, W/s, s, above, below): a shard's volume rows of the 96-row
# down view with ``above`` / ``below`` rows of its neighbours, its view
# zero-padded by s rows for each.  Tile 2 (48 rows + 1) at the group
# batches 4 and 2 of (1,2,1) and (2,2,1), top and bottom shard; tile 4
# (24 rows + 1 or 2) at batch 4, top, bottom and a middle shard.
BLEND_SHARD_CASES = ((4, 65, 49, 320, 4, 0, 1), (4, 65, 49, 320, 4, 1, 0),
                     (2, 65, 49, 320, 4, 0, 1), (2, 65, 49, 320, 4, 1, 0),
                     (4, 65, 25, 320, 4, 0, 1), (4, 65, 25, 320, 4, 1, 0),
                     (4, 65, 26, 320, 4, 1, 1))


def blend_ops(num_d, h, w, s):
    """Float32 operations ``upsample_blend`` needs for one (h, w) view: per
    output pixel and plane whose view column lies inside the view, the
    blend's 3 FMAs (6) and the column phase's FMA (2); per low column of
    an output row and plane, shared by s pixels, the row phase's
    subtraction and FMA (3) and the column difference (1)."""
    live = sum(min(num_d, w - x) for x in range(w)) * h
    return (8 + 4 / s) * live


def blend_inputs(torch, rng, dev, n, num_d, hl, wl, s, above=0, below=0):
    """A softmax volume (n, num_d, hl, wl) and a view in 0..1 at x s, its
    first ``s * above`` and last ``s * below`` rows zero (a shard's
    view, padded as ``split_blend`` pads it)."""
    logits = rng.standard_normal((n, num_d, hl, wl)).astype(np.float32)
    prob = torch.softmax(torch.from_numpy(logits).to(dev), dim=1).contiguous()
    view = rng.uniform(0, 1, (n, 3, s * hl, s * wl)).astype(np.float32)
    view[:, :, :s * above] = 0
    view[:, :, s * (hl - below):] = 0
    return prob, torch.from_numpy(view).to(dev)


def check_blend_cases(torch, dev) -> list:
    """``upsample_blend`` against its plain version at ``BLEND_CASES`` and
    ``BLEND_SHARD_CASES``, within 2e-4 as at the main path's shape, with
    its times."""
    from stereo_tpu_torch.ops.cuda import upsample_blend, upsample_blend_plain

    rng = np.random.default_rng(6)
    cases = []
    for case in BLEND_CASES + BLEND_SHARD_CASES:
        s = case[4]
        prob, view = blend_inputs(torch, rng, dev, *case)
        err = float((upsample_blend(prob, view, s)
                     - upsample_blend_plain(prob, view, s)).abs().max())
        require(err <= 2e-4, f"upsample_blend {case}: off by {err}")
        cases.append(dict(shape=list(case), max_abs_err=err,
                          **timings(lambda: upsample_blend(prob, view, s))))
    return cases


# ``gwc_volume``'s variants, (D, dtype, G, H, W) on GwcNet's 320 feature
# channels, the path's shape first: D=16 (disparity 64) and 48 (192) at
# 40 groups (8 channels per group) in both dtypes; 80, 64, 20 and 10 groups
# (4, 5, 16 and 32 channels); the row split's shards of a 384x1280 frame,
# 24 rows over 4 tile devices and 48 over 2; a width that is not a
# multiple of the kernel's 4- or 8-column strip; and a width under D, so
# that strip edges and the zero region (w < d) meet on the card.
GWC_VARIANTS = tuple(
    (d, dtype, g, h, w) for d, g, h, w, dtypes in (
        (16, 40, 96, 320, ("float32", "bfloat16")),
        (48, 40, 96, 320, ("float32", "bfloat16")),
        (16, 80, 96, 320, ("float32", "bfloat16")),
        (16, 64, 96, 320, ("float32", "bfloat16")),
        (16, 20, 96, 320, ("float32", "bfloat16")),
        (16, 10, 96, 320, ("float32", "bfloat16")),
        (16, 40, 24, 320, ("float32", "bfloat16")),
        (16, 40, 48, 320, ("float32", "bfloat16")),
        (16, 40, 96, 318, ("float32", "bfloat16")),
        (48, 40, 96, 44, ("float32", "bfloat16")))
    for dtype in dtypes)
GWC_DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def gwc_features(torch, rng, dev):
    """Left and right features (1, 320, 96, 320), ReLU'd like real ones."""
    return tuple(torch.from_numpy(np.maximum(rng.standard_normal(
        (1, 320, 96, 320)), 0).astype(np.float32)).to(dev) for _ in range(2))


def gwc_case(torch, left, right, variant):
    """A variant's features: the first H rows and W columns, in its dtype."""
    _, dtype, _, h, w = variant
    return tuple(x[..., :h, :w].to(getattr(torch, dtype)).contiguous()
                 for x in (left, right))


def gwc_limit(torch, vol) -> tuple:
    """max|vol| and the smoke's gate: 1e-5 * max|vol| in float32, one bf16
    ulp of max|vol| in bf16."""
    peak = float(vol.float().abs().max())
    if vol.dtype == torch.float32:
        return peak, 1e-5 * peak
    return peak, 2.0 ** (np.floor(np.log2(peak)) - 7)


def gwc_float64(torch, left, right, d: int, g: int):
    """The volume in float64: each group's product sum, times 1/cpg."""
    import torch.nn.functional as F

    n, c, h, w = left.shape
    lf, rp = left.double(), F.pad(right.double(), (d, 0))
    return torch.stack([(lf * rp[..., d - k:d - k + w])
                        .view(n, g, c // g, h, w).sum(2) * (g / c)
                        for k in range(d)], dim=2)


def gwc_distance(torch, vol, ref) -> dict:
    """How far ``vol`` lies from the float64 volume: the largest difference
    and how many elements differ from it rounded to ``vol``'s dtype."""
    return dict(max_abs=float((vol.double() - ref).abs().max()),
                differing_from_rounded=int((vol != ref.to(vol.dtype)).sum()))


def gwc_bound(lt, d: int, g: int) -> tuple:
    """Each input read once and the volume written once; one multiply and
    one add per channel at each live (d, w >= d) position."""
    n, c, h, w = lt.shape
    live = n * h * sum(max(w - k, 0) for k in range(d))
    return bound(lt.element_size() * (2 * n * c * h * w + n * g * d * h * w),
                 2 * c * live)


def check_gwc_volume(torch, rng, dev) -> dict:
    """``gwc_volume`` at ``GWC_VARIANTS``.  Float32 must agree with the
    plain version within 1e-5 * max|vol|, bf16 (compared in bf16) within
    one bf16 ulp of max|vol|; each variant also says how many elements
    differ at all, and how far the kernel and the plain version each lie
    from the volume in float64.  The kernel's entry is the path's shape
    (D=16, float32, 40 groups at (1, 320, 96, 320)); the others go in
    ``variants``."""
    from stereo_tpu_torch.ops.cuda import gwc_volume, gwc_volume_plain

    left, right = gwc_features(torch, rng, dev)
    variants = []
    for variant in GWC_VARIANTS:
        d, dtype, g, h, w = variant
        lt, rt = gwc_case(torch, left, right, variant)
        vol_k = gwc_volume(lt, rt, d, g)
        vol_p = gwc_volume_plain(lt, rt, d, g)
        torch.cuda.synchronize()
        err = float((vol_k.float() - vol_p.float()).abs().max())
        differing = int((vol_k != vol_p).sum())
        peak, limit = gwc_limit(torch, vol_p)
        require(err <= limit, f"gwc_volume {variant}: off by {err} (limit "
                              f"{limit})")
        ref = gwc_float64(torch, lt, rt, d, g)
        float64 = dict(kernel=gwc_distance(torch, vol_k, ref),
                       plain=gwc_distance(torch, vol_p, ref))
        del ref
        times = timings(lambda: gwc_volume(lt, rt, d, g))
        plain_ms = cuda_ms(lambda: gwc_volume_plain(lt, rt, d, g), 5)
        b_ms, b_by = gwc_bound(lt, d, g)
        variants.append(dict(planes=d, dtype=dtype, groups=g,
                             channels_per_group=lt.shape[1] // g,
                             shape=list(lt.shape),
                             max_abs_err=err, elements_differing=differing,
                             limit=limit, max_abs_vol=peak, float64=float64,
                             **times, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by))
    main = variants[0]
    return dict(name="gwc_volume", kernel="gwc_volume", route="cuda",
                source="stereo_tpu_torch/csrc/gwc_volume.cu",
                replaces="stereo_tpu/ops/pallas/gwc_volume.py:103",
                max_abs_err=main["max_abs_err"], ms=main["ms"],
                device_ms=main["device_ms"], host_us=main["host_us"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                variants=variants)


def ptxas_summary(log: str) -> dict:
    """Registers, spills and static shared memory of each kernel, from the
    ``-Xptxas -v`` lines of an ``nvcc`` build (keyed by mangled name)."""
    kernels, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            name = found.group(1)
            kernels[name] = {}
            continue
        if name is None:
            continue
        for key, pattern in (("registers", r"Used (\d+) registers"),
                             ("stack_frame", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("static_smem", r"(\d+) bytes smem")):
            found = re.search(pattern, line)
            if found:
                kernels[name][key] = int(found.group(1))
    return kernels


def sass_counts(path: str) -> dict:
    """Shared-memory loads and stores, barriers, float adds and FMAs and
    global loads in the machine code of each kernel of a library
    (``cuobjdump``), or None where the toolkit has no ``cuobjdump``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if any(k in name for k in ("matching_core", "sampled_window",
                                   "upsample_blend", "gwc_volume")):
            counts[name] = {op: len(re.findall(rf"\b{op}(\.\w+)*\s", block))
                            for op in ("LDS", "STS", "BAR", "FADD", "FFMA",
                                       "LDG", "LDGSTS", "STG")}
    return counts


def frame_ms(torch, fn, reps: int) -> list:
    """Host milliseconds of ``reps`` calls of ``fn``, each between two
    ``torch.cuda.synchronize()``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def frame_device_ms(torch, fn, reps: int = 10) -> float:
    """Median device milliseconds of one call of ``fn``: ``cuda_ms`` with
    the device first spun for about 20 ms, so that the host has queued a
    whole frame (gaps between its kernels counted, launches not)."""
    return cuda_ms(fn, reps, device_only=True, spin_cycles=40_000_000)


def seeded_frames(torch, dev, shape, seed: int, n: int = 4) -> list:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(np.round(rng.uniform(0, 255, (3, *shape)))
                             .astype(np.float32)).to(dev) for _ in range(n)]


def make_synthesis(dev):
    """Deep3D at its native 384x1280 / 96x320: the committed weights when
    present, else seeded ones of the same width."""
    from stereo_tpu_torch.synthesis import RightViewSynthesis

    committed = os.path.isfile(DEEP3D_NPZ)
    synthesis = RightViewSynthesis(
        output_shape=(384, 1280),
        checkpoint_dir=DEEP3D_NPZ if committed else None,
        seed=None if committed else 0, device=dev)
    return synthesis, "committed" if committed else "seeded"


def phase_pipeline(torch, dev, synthesis, reference_check: bool):
    from stereo_tpu_torch.core.config import PipelineConfig
    from stereo_tpu_torch.matching.classical import ClassicalStereoEngine
    from stereo_tpu_torch.ops import rescale_generated_view
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.ops.cuda import upsample_blend_plain
    from stereo_tpu_torch.pipeline import DepthEstimationPipeline
    from stereo_tpu_torch.synthesis.right_view_synthesis import resize_nchw

    config = PipelineConfig()
    pipeline = DepthEstimationPipeline(config, synthesis=synthesis, device=dev)
    frames = seeded_frames(torch, dev, config.image_shape, 2)

    reset_launch_counts()
    result = pipeline.process(frames[0])
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    require(all(counts[k] >= 1 for k in CLASSICAL_KERNELS),
            f"pipeline missed a kernel: {counts}")
    disp = result.disparity_map
    require(tuple(disp.shape) == tuple(config.image_shape),
            f"disparity shape {tuple(disp.shape)}")
    require(bool(torch.isfinite(disp).all()), "non-finite disparity")

    # The same frame through the plain versions on the card.
    frac = None
    if reference_check:
        with torch.no_grad():
            left = frames[0][None]
            down = resize_nchw(left, synthesis.model_down_shape) / 255.0
            prob = synthesis.model.prob_volume_low(down).float()
            right = rescale_generated_view(upsample_blend_plain(
                prob, left / 255.0, synthesis.model.prob_volume_scale))[0]
            require(float((right - result.right_image).abs().max()) < 0.05,
                    "synthesized view differs from the plain version")
            plain = ClassicalStereoEngine(
                config.matching_config().replace(impl="torch"), device=dev)
            disp_plain = plain.compute_disparity_map(frames[0], right)
        frac = float(((disp - disp_plain).abs() <= 0.5).float().mean())
        require(frac >= 0.99, f"pipeline vs plain: {frac} within 0.5 px")

    for f in frames:
        pipeline.process(f)
    pipeline.reset_stage_times()
    cycle = itertools.cycle(frames)
    times = frame_ms(torch, lambda: pipeline.process(next(cycle)), 20)
    stages = {k: v * 1e3 for k, v in pipeline.stage_times().items()}
    return pipeline, dict(launches_per_frame=counts,
                          frac_within_0p5_of_plain=frac,
                          ms_per_frame_median=statistics.median(times),
                          ms_per_frame_min=min(times),
                          stage_ms=stages)


def phase_fused_single_view(torch, dev, synthesis):
    """``FusedSingleViewEngine`` (two CUDA graphs per batch size) against
    the unfused ``SingleViewEngine`` on the same frames, at the main path's
    full width (384x1280, disparity 0..64, Deep3D 384x1280 / 96x320) at
    batch 1 and 2: the disparities (JAX's gate, at least 0.99 within
    0.5 px) and right views (within 0.05), the launches per frame (equal
    to the unfused path's), ms/frame medians of 20 calls of each engine
    (host clock, synchronized), the device's time per frame by CUDA events
    and its busy share, and the graphs captured."""
    from torch.profiler import ProfilerActivity, profile

    from stereo_tpu_torch.core.config import PipelineConfig
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.pipeline import ClassicalStereoBackend
    from stereo_tpu_torch.pipeline.single_view import (FusedSingleViewEngine,
                                                       SingleViewEngine)

    config = PipelineConfig()
    matching = config.matching_config()
    require(synthesis.split_inference, "the synthesis has no split inference")
    fused = FusedSingleViewEngine(matching, synthesis)
    unfused = SingleViewEngine(ClassicalStereoBackend(matching, device=dev),
                               synthesis)
    t0 = time.perf_counter()
    fused.warmup()
    warmup_s = time.perf_counter() - t0
    require(fused.graphs_captured == 2, f"warmup captured "
                                        f"{fused.graphs_captured} graphs")
    batches, counts = {}, {k: 0 for k in LAUNCHES}
    for n in (1, 2):
        frames = torch.stack(seeded_frames(torch, dev, config.image_shape,
                                           20 + n, n))
        if n > 1:
            t0 = time.perf_counter()
            fused.process_batch(frames)          # captures this batch size
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
        reset_launch_counts()
        disp_u, right_u = unfused.process_batch(frames)
        torch.cuda.synchronize()
        launches_u = dict(LAUNCHES)
        reset_launch_counts()
        disp_f, right_f = fused.process_batch(frames)
        torch.cuda.synchronize()
        launches_f = dict(LAUNCHES)
        require(launches_f == launches_u
                and all(launches_f[k] >= 1 for k in CLASSICAL_KERNELS),
                f"fused launches {launches_f}, unfused {launches_u}")
        for k in counts:
            counts[k] += launches_f[k]
        diff = (disp_f - disp_u).abs()
        share = float((diff <= 0.5).float().mean())
        right_diff = float((right_f - right_u).abs().max())
        require(share >= 0.99 and right_diff <= 0.05,
                f"fused vs unfused at batch {n}: {share} within 0.5 px, "
                f"right views {right_diff} apart")
        ms_f = frame_ms(torch, lambda: fused.process_batch(frames), 20)
        ms_u = frame_ms(torch, lambda: unfused.process_batch(frames), 20)
        dev_f = frame_device_ms(torch, lambda: fused.process_batch(frames))
        dev_u = frame_device_ms(torch, lambda: unfused.process_batch(frames))
        med_f, med_u = statistics.median(ms_f), statistics.median(ms_u)
        batches[f"batch{n}"] = dict(
            disparity_equal=bool(torch.equal(disp_f, disp_u)),
            disparity_max_abs_diff=float(diff.max()),
            share_within_0p5=share, right_view_max_abs_diff=right_diff,
            launches_per_frame={k: v / n for k, v in launches_f.items()},
            unfused_launches_per_frame={k: v / n
                                        for k, v in launches_u.items()},
            fused_ms_per_frame_median=med_f / n,
            unfused_ms_per_frame_median=med_u / n,
            fused_device_ms_per_frame=dev_f / n,
            unfused_device_ms_per_frame=dev_u / n,
            fused_device_busy_share=dev_f / med_f,
            unfused_device_busy_share=dev_u / med_u,
            **({"capture_s": capture_s} if n > 1 else {}))
    # The profiler over a few replays: whether it sees the graphs' kernels.
    one = torch.stack(seeded_frames(torch, dev, config.image_shape, 21, 1))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fused.process_batch(one)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    seen = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    prof_ms = sum(e.self_device_time_total for e in seen) / 1e3 / 3
    profiler = dict(sees_graph_kernels=bool(seen), wall_ms_per_frame=wall_ms,
                    device_ms_per_frame=prof_ms if seen else None,
                    device_busy_share=prof_ms / wall_ms if seen else None,
                    note=None if seen else "the profiler sees no kernel "
                    "inside the replayed graphs; the CUDA-event device "
                    "times above stand for it")
    # A capture that fails raises and keeps nothing; the card goes on.
    failures = check_capture_failure(torch, matching, synthesis, one)
    disp_after, _ = fused.process_batch(one)
    disp_before, _ = unfused.process_batch(one)
    require(torch.equal(disp_after, disp_before),
            "the fused engine differs after the failed captures")
    return counts, dict(warmup_s=warmup_s,
                        graphs_captured=fused.graphs_captured,
                        capture_failure=failures,
                        weights="committed" if os.path.isfile(DEEP3D_NPZ)
                        else "seeded", profiler=profiler, **batches)


def check_capture_failure(torch, matching, synthesis, frames) -> dict:
    """A capture that fails raises out of ``process_batch``, keeps no graph
    (nothing runs eagerly in its place) and leaves the thread on its
    stream: once with an exception raised inside the capture, once with a
    device synchronization, which CUDA refuses while the stream captures
    (the capture then fails to end).  The same engine then captures once
    the failure is gone (PyTorch refuses a capture into a pool after a
    failed one: ``GraphPool`` takes a new pool).  Afterwards the
    allocator records into no graph's pool: ``empty_cache`` gives a freed
    1 GiB block back to the card."""
    from stereo_tpu_torch.pipeline.single_view import FusedSingleViewEngine

    results = {}
    stream = torch.cuda.current_stream()
    for label in ("exception", "synchronize"):
        engine = FusedSingleViewEngine(matching, synthesis)
        net = engine._net

        def failing(left, label=label, net=net):
            if torch.cuda.is_current_stream_capturing():
                if label == "exception":
                    raise RuntimeError("injected failure")
                torch.cuda.synchronize()
            return net(left)

        engine._net = failing
        try:
            engine.process_batch(frames)
        except Exception as exc:  # noqa: BLE001 — the failure is the result
            results[label] = f"{type(exc).__name__}: {str(exc)[:160]}"
        else:
            require(False, f"a capture with a {label} did not raise")
        require(engine.graphs_captured == 0,
                f"a failed capture ({label}) kept a graph")
        require(torch.cuda.current_stream() == stream,
                f"a failed capture ({label}) left the thread on another "
                f"stream")
        engine._net = net
        engine.process_batch(frames)
        require(engine.graphs_captured == 2,
                f"after a failed capture ({label}) the engine captured "
                f"{engine.graphs_captured} graphs")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    block = torch.empty(1 << 30, dtype=torch.uint8, device=stream.device)
    del block
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    results["reserved_bytes_around_a_freed_GiB"] = [before, after]
    require(after <= before, f"after the failed captures empty_cache kept "
                             f"{after - before} bytes of a freed block")
    return results


def phase_fresh_deep3d(torch, dev) -> dict:
    """``RightViewSynthesis()`` with its defaults: the committed Deep3D
    checkpoint when the checkout has it, else fresh weights with a
    warning (as the JAX package); one frame through it either way."""
    import warnings

    from stereo_tpu_torch.synthesis import RightViewSynthesis

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rvs = RightViewSynthesis()
    said = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    frame = seeded_frames(torch, dev, (384, 1280), 40, 1)[0]
    right = rvs.process(frame)
    torch.cuda.synchronize()
    require(tuple(right.shape) == (3, 384, 1280)
            and bool(torch.isfinite(right).all())
            and float(right.min()) >= 0 and float(right.max()) <= 255,
            "RightViewSynthesis() gave no view")
    committed = os.path.isfile(DEEP3D_NPZ)
    require(committed or said, "fresh weights without a warning")
    return dict(checkpoint_present=committed,
                weights="committed" if committed else "fresh",
                warning=said[0] if said else None,
                device=str(rvs.device), split_inference=rvs.split_inference)


def fixture_leaves(tree) -> dict:
    """An Orbax tree's leaves keyed by their dotted paths (list indices as
    their numbers), as the fixture's npz twin keys them."""
    if isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
    if not isinstance(tree, dict):
        return {"": tree}
    return {".".join(p for p in (k, sub) if p): leaf
            for k, v in tree.items()
            for sub, leaf in fixture_leaves(v).items()}


def read_fixture(torch, root: str) -> tuple:
    """An Orbax fixture tree read by the port, every leaf held to the npz
    twin bit for bit: ``(leaves, read ms)``."""
    from stereo_tpu_torch.utils.orbax import read_tree

    t0 = time.perf_counter()
    got = fixture_leaves(read_tree(root))
    read_ms = (time.perf_counter() - t0) * 1e3
    with np.load(ORBAX_FIXTURE + ".npz") as data:
        bf16 = set(data["__bfloat16__"].tolist())
        twin = {k: data[k] for k in data.files if k != "__bfloat16__"}
    require(set(got) == set(twin),
            f"{root}: leaves {sorted(got)} != twin {sorted(twin)}")
    for key, want in twin.items():
        leaf = got[key]
        if key in bf16:
            require(leaf.dtype == torch.bfloat16, f"{key}: {leaf.dtype}")
            leaf = leaf.view(torch.int16).numpy().view(np.uint16)
        leaf = np.asarray(leaf)
        require(leaf.dtype == want.dtype and leaf.shape == want.shape
                and np.array_equal(leaf, want),
                f"{root}: leaf {key} differs from its twin")
    return got, read_ms


def check_orbax_fixture(torch) -> dict:
    """The committed fixtures read by the port, every leaf against their
    npz twin bit for bit: JAX's ``save_params``'s (OCDBT, zarr v2, zstd, a
    sharded array in two chunks, 1 MiB across eight 128 KiB zstd blocks)
    and the same tree written as zarr3 (``sharding_indexed`` arrays); and
    the port's zstd decoder's rate on the large array's chunk."""
    from stereo_tpu_torch import _native
    from stereo_tpu_torch.utils.ocdbt import OcdbtStore

    got, read_ms = read_fixture(torch, ORBAX_FIXTURE)
    zarr3, zarr3_read_ms = read_fixture(torch, ORBAX_ZARR3_FIXTURE)
    chunk = OcdbtStore(ORBAX_FIXTURE)["smooth/0"]
    decoded = _native.zstd_decompress(chunk)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        _native.zstd_decompress(chunk)
    seconds = (time.perf_counter() - t0) / reps
    return dict(leaves=len(got), read_ms=read_ms, zarr3_leaves=len(zarr3),
                zarr3_read_ms=zarr3_read_ms, zstd_frame_bytes=len(chunk),
                zstd_decoded_bytes=len(decoded),
                zstd_decode_mb_per_s=len(decoded) / seconds / 1e6)


def zstd_on_host() -> dict:
    """Whether the machine has zstd's header or library (for the record:
    the port decodes with its own code)."""
    import ctypes.util

    headers = [d for d in ("/usr/include", "/usr/local/include")
               if os.path.isfile(os.path.join(d, "zstd.h"))]
    libraries = [d for d in ("/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu",
                             "/usr/lib64", "/usr/lib", "/usr/local/lib")
                 if os.path.isfile(os.path.join(d, "libzstd.so.1"))]
    return dict(zstd_h=headers, libzstd_so_1=libraries,
                find_library=ctypes.util.find_library("zstd"))


def load_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def phase_orbax(torch, dev, synthesis, deep3d_weights: str, tmp: str):
    """Orbax checkpoints on the card: the committed fixture against its
    twin; GwcNet's committed weights and Deep3D's (the committed ones when
    the checkout has them, else the seeded synthesis's) written by the
    port's ``save_params`` and loaded back by ``checkpoint_dir`` at full
    width: the GwcNet single view and the classical single view (the fused
    route) each equal, bit for bit, to the same frame through the
    npz-loaded networks, with every kernel of the path launched; the host
    ms of each load against its npz."""
    from stereo_tpu_torch.core.config import PipelineConfig
    from stereo_tpu_torch.models import (build_stereo_model,
                                         flax_arrays_from_state_dict,
                                         load_deep3d_checkpoint,
                                         load_or_init_params, nest_variables,
                                         save_params)
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                           DnnStereoMatchingBackend)
    from stereo_tpu_torch.pipeline.single_view import SingleViewEngine
    from stereo_tpu_torch.synthesis import RightViewSynthesis

    numbers = dict(fixture=check_orbax_fixture(torch), **zstd_on_host())
    frame = seeded_frames(torch, dev, (384, 1280), 41, 1)[0]
    counts = {}

    # GwcNet: the committed npz -> an Orbax directory -> the single view.
    gwc_dir = os.path.join(tmp, "gwcnet")
    model = build_stereo_model("gwcnet", 64)
    gwc_weights = load_or_init_params(model, "gwcnet")
    save_params(model, gwc_dir)
    probe = build_stereo_model("gwcnet", 64)
    npz_ms = (load_ms(lambda: load_or_init_params(probe, "gwcnet"))
              if gwc_weights != "seeded" else None)
    orbax_ms = load_ms(lambda: load_or_init_params(
        probe, "gwcnet", checkpoint_dir=gwc_dir))
    by_npz = DnnStereoMatchingBackend("gwcnet", (384, 1280),
                                      max_disparity=64, device=dev)
    by_orbax = DnnStereoMatchingBackend("gwcnet", (384, 1280),
                                        max_disparity=64,
                                        checkpoint_dir=gwc_dir, device=dev)
    require(by_orbax.weights == gwc_dir, f"GwcNet loaded {by_orbax.weights}")
    want, _ = SingleViewEngine(by_npz, synthesis).process(frame)
    reset_launch_counts()
    got, _ = SingleViewEngine(by_orbax, synthesis).process(frame)
    torch.cuda.synchronize()
    counts["gwcnet"] = dict(LAUNCHES)
    require(all(counts["gwcnet"][k] >= 1 for k in GWCNET_KERNELS),
            f"Orbax GwcNet single view missed a kernel: {counts['gwcnet']}")
    require(torch.equal(got, want),
            "GwcNet from Orbax differs from the npz-loaded run")
    numbers["gwcnet"] = dict(
        weights=gwc_weights, load_ms_orbax=orbax_ms, load_ms_npz=npz_ms,
        orbax_bytes=dir_bytes(gwc_dir), launches=counts["gwcnet"],
        equal_bit_for_bit=True)
    del by_npz, by_orbax

    # Deep3D: its weights -> an Orbax directory -> RightViewSynthesis and
    # the classical single view.
    d3_dir = os.path.join(tmp, "deep3d")
    if deep3d_weights == "committed":
        state, _ = load_deep3d_checkpoint(DEEP3D_NPZ)
    else:      # seeded: the global branch's bf16 kernels are held exactly
        state = {k: v.float() for k, v in synthesis.model.state_dict().items()}
    save_params(nest_variables(flax_arrays_from_state_dict(synthesis.model,
                                                           state)), d3_dir)
    d3_orbax_ms = load_ms(lambda: load_deep3d_checkpoint(d3_dir))
    d3_npz_ms = (load_ms(lambda: load_deep3d_checkpoint(DEEP3D_NPZ))
                 if deep3d_weights == "committed" else None)
    from_orbax = RightViewSynthesis(output_shape=(384, 1280),
                                    checkpoint_dir=d3_dir, device=dev)
    config = PipelineConfig()
    want = DepthEstimationPipeline(config, synthesis=synthesis,
                                   device=dev).process(frame)
    pipeline = DepthEstimationPipeline(config, synthesis=from_orbax,
                                       device=dev)
    reset_launch_counts()
    got = pipeline.process(frame)
    torch.cuda.synchronize()
    counts["classical"] = dict(LAUNCHES)
    require(all(counts["classical"][k] >= 1 for k in CLASSICAL_KERNELS),
            f"Orbax classical single view missed a kernel: "
            f"{counts['classical']}")
    require(torch.equal(got.right_image, want.right_image)
            and torch.equal(got.disparity_map, want.disparity_map),
            "single view from Orbax Deep3D differs from the npz-loaded run")
    numbers["deep3d"] = dict(
        weights=deep3d_weights, load_ms_orbax=d3_orbax_ms,
        load_ms_npz=d3_npz_ms, orbax_bytes=dir_bytes(d3_dir),
        launches=counts["classical"], equal_bit_for_bit=True,
        fused=pipeline._fused_single_view() is not None)
    return counts, numbers


def dir_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


def phase_dnn(torch, dev, synthesis):
    """The single-view pipeline with GwcNet at 384x1280 / disparity 1..64,
    held against the same frame through ``gwc_volume_plain``; then GwcNet
    on the synthetic KITTI pair at disparity 64 and 192, its feature
    extractor alone, and MSNet2D, MSNet3D and GwcNet in bf16 (disparity
    64) on the pair."""
    import stereo_tpu_torch.models.gwcnet as gwcnet_module
    from stereo_tpu_torch.core.config import PipelineConfig
    from stereo_tpu_torch.ops.cuda import (LAUNCHES, gwc_volume_plain,
                                           reset_launch_counts)
    from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                           DnnStereoMatchingBackend)

    config = PipelineConfig(stereo_matching_backend="gwcnet")
    pipeline = DepthEstimationPipeline(config, synthesis=synthesis, device=dev)
    backend = pipeline.stereo_matching
    build_gwc_volume = gwcnet_module.build_gwc_volume
    frames = seeded_frames(torch, dev, config.image_shape, 4)

    reset_launch_counts()
    result = pipeline.process(frames[0])
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    require(all(counts[k] >= 1 for k in GWCNET_KERNELS),
            f"GwcNet pipeline missed a kernel: {counts}")
    disp = result.disparity_map
    require(tuple(disp.shape) == tuple(config.image_shape),
            f"GwcNet disparity shape {tuple(disp.shape)}")
    require(bool(torch.isfinite(disp).all()), "non-finite GwcNet disparity")

    # The same frame (same weights, same synthesized view) with the volume
    # built by the plain version.
    gwcnet_module.build_gwc_volume = gwc_volume_plain
    try:
        disp_plain = backend.process(frames[0], result.right_image)
    finally:
        gwcnet_module.build_gwc_volume = build_gwc_volume
    diff = (disp - disp_plain).abs()
    frac = float((diff <= 0.5).float().mean())
    require(frac >= 0.99, f"GwcNet vs plain volume: {frac} within 0.5 px")

    for f in frames:
        pipeline.process(f)
    pipeline.reset_stage_times()
    cycle = itertools.cycle(frames)
    times = frame_ms(torch, lambda: pipeline.process(next(cycle)), 20)
    stages = {k: v * 1e3 for k, v in pipeline.stage_times().items()}
    single = dict(weights=backend.weights, launches_per_frame=counts,
                  frac_within_0p5_of_plain=frac,
                  max_abs_diff_to_plain=float(diff.max()),
                  ms_per_frame_median=statistics.median(times),
                  ms_per_frame_min=min(times), stage_ms=stages)

    # The same single view with GwcNet in bf16 (``--compute-dtype
    # bfloat16``): its time, and its map beside the float32 one (Deep3D's
    # view from seeded weights is no scene, so its maps are held in phase
    # ``synthetic`` on the record's frames instead).
    pipe_bf16 = DepthEstimationPipeline(
        PipelineConfig(stereo_matching_backend="gwcnet",
                       compute_dtype="bfloat16"), synthesis=synthesis,
        device=dev)
    reset_launch_counts()
    disp_bf16 = pipe_bf16.process(frames[0]).disparity_map
    torch.cuda.synchronize()
    require(LAUNCHES["gwc_volume"] >= 1, f"bf16 view missed gwc_volume: "
                                         f"{dict(LAUNCHES)}")
    d16 = (disp_bf16 - disp).abs()
    times16 = frame_ms(torch, lambda: pipe_bf16.process(next(cycle)), 20)
    single_bf16 = dict(ms_per_frame_median=statistics.median(times16),
                       ms_per_frame_min=min(times16),
                       vs_float32=dict(max_abs=float(d16.max()),
                                       mean_abs=float(d16.mean()),
                                       share_over_0p5=float(
                                           (d16 > 0.5).float().mean())))
    del pipe_bf16

    left, right = (torch.from_numpy(x).to(dev) for x in kitti_pair())

    def pair_numbers(fn, reps):
        disp = fn()
        times = frame_ms(torch, fn, reps)
        require(bool(torch.isfinite(disp).all()), "non-finite disparity")
        return dict(ms_per_frame_median=statistics.median(times),
                    median_disparity=float(disp[:, 64:-64].median()))

    pair = pair_numbers(lambda: pipeline.process(left, right).disparity_map,
                        10)
    pipe192 = DepthEstimationPipeline(
        PipelineConfig(stereo_matching_backend="gwcnet", max_disparity=192),
        device=dev)
    pair192 = pair_numbers(
        lambda: pipe192.process(left, right).disparity_map, 10)
    del pipe192
    # GwcNet's 2-D feature extractor alone (the stacked pair), to split
    # its device time from the volume and the 3-D aggregation.
    stacked = torch.zeros((2, 3, *config.image_shape), device=dev)
    with torch.no_grad():
        features_ms = cuda_ms(
            lambda: backend.model.GwcFeatureExtractor_0(stacked), 5)
    others = {}
    for name, dtype in (("msnet2d", "float32"), ("msnet3d", "float32"),
                        ("gwcnet", "bfloat16")):
        net = DnnStereoMatchingBackend(name, config.image_shape,
                                       max_disparity=64, compute_dtype=dtype,
                                       device=dev)
        others[f"{name}_{dtype}"] = dict(weights=net.weights, **pair_numbers(
            lambda: net.process(left, right), 3))
        del net
    others["gwcnet_groups80"] = check_gwcnet_groups(torch, dev, left, right)
    return pipeline, dict(single_view=single,
                          single_view_bfloat16=single_bf16, pair_d64=pair,
                          pair_d192=pair192,
                          gwcnet_features_ms=features_ms, **others)


def check_gwcnet_groups(torch, dev, left, right, groups: int = 80) -> dict:
    """A seeded GwcNet with 4 channels per group (80 groups of its 320
    features; its aggregation's weights depend on the group count, so no
    committed weights) in eval mode at 384x1280 / disparity 64: the
    ``gwc_volume`` kernel at a group size it takes at run time, held
    against the same forward with the plain volume."""
    import stereo_tpu_torch.models.gwcnet as gwcnet_module
    from stereo_tpu_torch.models import init_params
    from stereo_tpu_torch.ops.cuda import (LAUNCHES, gwc_volume_plain,
                                           reset_launch_counts)
    from stereo_tpu_torch.pipeline.backends import normalize_imagenet

    net = gwcnet_module.GwcNet(max_disparity=64, num_groups=groups)
    init_params(net, 0)
    net = net.to(dev).eval()
    lt, rt = (normalize_imagenet(x)[None] for x in (left, right))
    reset_launch_counts()
    with torch.no_grad():
        disp = net(lt, rt)
    torch.cuda.synchronize()
    launched = LAUNCHES["gwc_volume"]
    require(launched >= 1, f"GwcNet at {groups} groups missed gwc_volume")
    build_gwc_volume = gwcnet_module.build_gwc_volume
    gwcnet_module.build_gwc_volume = gwc_volume_plain
    try:
        with torch.no_grad():
            disp_plain = net(lt, rt)
    finally:
        gwcnet_module.build_gwc_volume = build_gwc_volume
    diff = (disp - disp_plain).abs()
    frac = float((diff <= 0.5).float().mean())
    require(bool(torch.isfinite(disp).all()) and frac >= 0.99,
            f"GwcNet at {groups} groups vs the plain volume: {frac}")
    return dict(groups=groups, channels_per_group=320 // groups,
                weights="seeded", gwc_volume_launches=launched,
                frac_within_0p5_of_plain=frac,
                max_abs_diff_to_plain=float(diff.max()))


def profile_calls(torch, fn, frames: int) -> dict:
    """Device time by kernel over ``frames`` calls of ``fn`` after one
    warm-up call (torch.profiler), the device's busy share of the wall
    time, and the kernels each call launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return dict(frames=frames, wall_ms_per_frame=wall_ms / frames,
                device_ms_per_frame=device_ms / frames,
                device_busy_share=device_ms / wall_ms,
                kernels_per_frame=sum(e.count for e in kernels) / frames,
                profiler_sees_kernels=bool(kernels),
                top=[dict(name=e.key[:90], calls=e.count // frames,
                          ms_per_frame=e.self_device_time_total / 1e3 / frames)
                     for e in kernels[:12]])


def phase_profile(torch, pipeline, dev, frames: int = 3) -> dict:
    """Device time by kernel over a few pipeline frames (torch.profiler),
    and the share of the wall time the device was busy."""
    left = torch.zeros((3, *pipeline.get_configuration().image_shape),
                       device=dev)
    numbers = profile_calls(torch, lambda: pipeline.process(left), frames)
    # The device's own time for a frame by CUDA events, which also see the
    # kernels of a replayed CUDA graph.
    events_ms = frame_device_ms(torch, lambda: pipeline.process(left))
    wall_ms = numbers["wall_ms_per_frame"]
    return dict(numbers, event_device_ms_per_frame=events_ms,
                event_device_busy_share=events_ms / wall_ms)


def profile(torch, label: str, pipeline, dev) -> None:
    """The profile only measures; a profiler that cannot trace the card is
    reported, not fatal."""
    t = time.perf_counter()
    try:
        report(label, t, **phase_profile(torch, pipeline, dev))
    except Exception as exc:  # noqa: BLE001 — measurement only
        report(label, t, error=f"{type(exc).__name__}: {exc}")


def jpeg_manifest() -> dict:
    with open(os.path.join(JPEG_FIXTURES, "expected.json")) as f:
        return json.load(f)


def manifest_checked_jpeg(path: str) -> tuple:
    """A committed JPEG's bytes and the port's decode of it, which must
    hash to the SHA-256 of PIL's decode in the fixtures' manifest."""
    import hashlib

    from stereo_tpu_torch.utils.image_io import decode_image_rgb

    with open(path, "rb") as f:
        data = f.read()
    entry = jpeg_manifest()["files"][os.path.basename(path)]
    rgb = decode_image_rgb(data)
    digest = hashlib.sha256(rgb.tobytes()).hexdigest()
    require(list(rgb.shape) == entry["shape"] and digest == entry["sha256"],
            f"JPEG decode of {path}: shape {rgb.shape}, sha256 {digest}, "
            f"manifest {entry['shape']} {entry['sha256']}")
    return data, rgb


def raster_manifest() -> dict:
    with open(os.path.join(RASTER_FIXTURES, "expected.json")) as f:
        return json.load(f)


def manifest_checked_raster(path: str) -> tuple:
    """A committed BMP/TIFF/GIF/PNM/PFM fixture's bytes and the port's RGB
    decode of it, which must hash to the SHA-256 of PIL's decode in the
    manifest, as its ground-truth array must hash to the JAX trainer's."""
    import hashlib

    from stereo_tpu_torch.utils.image_io import (decode_image,
                                                 decode_image_rgb,
                                                 disparity_of)

    with open(path, "rb") as f:
        data = f.read()
    entry = raster_manifest()["files"][os.path.basename(path)]
    rgb = decode_image_rgb(data)
    digest = hashlib.sha256(rgb.tobytes()).hexdigest()
    disp = hashlib.sha256(disparity_of(decode_image(data)).tobytes())
    require(list(rgb.shape) == entry["shape"] and digest == entry["sha256"]
            and disp.hexdigest() == entry["disparity_sha256"],
            f"decode of {path}: shape {rgb.shape}, sha256 {digest}, "
            f"ground truth {disp.hexdigest()}, manifest {entry}")
    return data, rgb


_FRAME_FILES = {}


def raster_writers() -> tuple:
    """``bmp_file``, ``bmp_rows`` and ``tiff_file`` of
    ``tests/raster_files.py`` (NumPy only: the card's machine has no imaging
    library)."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import raster_files

    return raster_files.bmp_file, raster_files.bmp_rows, raster_files.tiff_file


def frame_files() -> tuple:
    """The fixture frame's pixels ((375, 1242, 3) uint8, its PNG decoded)
    and ``FRAME_FORMATS`` name -> the frame's file bytes: a 24-bit BMP, a
    P6 PPM and RGB TIFFs uncompressed, LZW and Deflate (predictor 2),
    written once by ``tests/raster_files.py``."""
    if not _FRAME_FILES:
        from stereo_tpu_torch.utils.png import decode_png

        bmp_file, bmp_rows, tiff_file = raster_writers()

        with open(FIXTURE_FRAMES[0], "rb") as f:
            frame = decode_png(f.read())
        h, w, _ = frame.shape
        _FRAME_FILES["frame"] = frame
        _FRAME_FILES["files"] = {
            "bmp": bmp_file(w, h, 24, bmp_rows(frame[..., ::-1], 24)),
            "ppm": b"P6 %d %d 255\n" % (w, h) + frame.tobytes(),
            "tiff_raw": tiff_file(frame, 2),
            "tiff_lzw": tiff_file(frame, 2, compression=5),
            "tiff_deflate": tiff_file(frame, 2, compression=8, predictor=2)}
    return _FRAME_FILES["frame"], _FRAME_FILES["files"]


def upload_ms(torch, data: bytes, shape, dev, reps: int = 10) -> float:
    """Host ms of ``decode_png_to_pipeline_image`` to the card, median."""
    from stereo_tpu_torch.serve import decode_png_to_pipeline_image

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_png_to_pipeline_image(data, shape, dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_server(torch, pipeline, dev, kernels):
    """Nine uploads to a server around ``pipeline``: three seeded PNG
    frames at the pipeline's shape, the fixture frame's PNG bytes (375x1242,
    Paeth-filtered, resized by the server), the same frame as a JPEG
    (``Content-Type: image/jpeg``), whose decoded upload tensor must equal
    the one from a PNG of its manifest-checked pixels, and as a BMP, an LZW
    TIFF and a PPM, whose upload tensors must equal the PNG's, and the GIF
    fixture (``image/gif``), whose tensor must equal a PNG of its
    manifest-checked pixels.  Every name in ``kernels`` must launch in that
    run.  Also the host ms of decoding and uploading the fixture frame in
    each format (``decode_png_to_pipeline_image``)."""
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.serve import (DepthEstimationServer,
                                        decode_png_to_pipeline_image)
    from stereo_tpu_torch.utils.png import decode_png, encode_png

    config = pipeline.get_configuration()
    server = DepthEstimationServer(config, pipeline=pipeline, micro_batch=2,
                                   device=dev)
    rng = np.random.default_rng(3)
    uploads = [encode_png(rng.integers(0, 256, (*config.image_shape, 3),
                                       dtype=np.uint8)) for _ in range(3)]
    with open(FIXTURE_FRAMES[0], "rb") as f:
        uploads.append(f.read())
    jpeg, pixels = manifest_checked_jpeg(JPEG_FRAME)
    uploads.append(jpeg)
    types = ["image/png"] * 4 + ["image/jpeg"]
    from_jpeg = decode_png_to_pipeline_image(jpeg, config.image_shape, dev)
    from_png = decode_png_to_pipeline_image(encode_png(pixels),
                                            config.image_shape, dev)
    require(from_jpeg.dtype == torch.uint8
            and torch.equal(from_jpeg, from_png),
            "the JPEG upload's tensor differs from its pixels' PNG upload")
    decode_ms = upload_ms(torch, uploads[3], config.image_shape, dev)
    jpeg_decode_ms = upload_ms(torch, jpeg, config.image_shape, dev)
    from_frame_png = decode_png_to_pipeline_image(uploads[3],
                                                  config.image_shape, dev)
    _, files = frame_files()
    format_ms = {}
    for name in ("bmp", "tiff_lzw", "ppm"):
        tensor = decode_png_to_pipeline_image(files[name],
                                              config.image_shape, dev)
        require(tensor.dtype == torch.uint8
                and torch.equal(tensor, from_frame_png),
                f"the {name} upload's tensor differs from the PNG upload's")
        format_ms[name] = upload_ms(torch, files[name], config.image_shape,
                                    dev)
        uploads.append(files[name])
        types.append(FRAME_FORMATS[name])
    gif, gif_pixels = manifest_checked_raster(RASTER_GIF)
    require(torch.equal(
        decode_png_to_pipeline_image(gif, config.image_shape, dev),
        decode_png_to_pipeline_image(encode_png(gif_pixels),
                                     config.image_shape, dev)),
        "the GIF upload's tensor differs from its pixels' PNG upload")
    uploads.append(gif)
    types.append("image/gif")
    replies = [None] * len(uploads)
    host, port = server.start("127.0.0.1", 0)

    def post(i):
        req = urllib.request.Request(f"http://{host}:{port}/", data=uploads[i],
                                     headers={"Content-Type": types[i]})
        with urllib.request.urlopen(req, timeout=120) as resp:
            replies[i] = (resp.status, resp.read())

    try:
        reset_launch_counts()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(uploads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
    finally:
        server.shutdown()
    # The stage timer folds finished stages as it goes: a server that never
    # asks for the stage times must not hold more CUDA events per batch.
    pending = pipeline._timer.pending
    require(pending <= 8, f"stage timer holds {pending} pending stages")
    statuses = [r[0] if r else None for r in replies]
    require(statuses == [200] * len(uploads), f"server replies {statuses}")
    for _, body in replies:
        shape = decode_png(body).shape
        require(shape[:2] == tuple(config.image_shape), f"reply shape {shape}")
    require(all(counts[k] >= 1 for k in kernels),
            f"{config.stereo_matching_backend} path missed a kernel: {counts}")
    return counts, dict(statuses=statuses, content_types=types,
                        batches=server.batcher.batches_run,
                        frames=server.batcher.frames_run,
                        timer_pending=pending,
                        jpeg_upload_equals_png_of_its_pixels=True,
                        bmp_tiff_ppm_uploads_equal_the_png_upload=True,
                        gif_upload_equals_png_of_its_pixels=True,
                        fixture_decode_upload_ms_median=decode_ms,
                        fixture_jpeg_decode_upload_ms_median=jpeg_decode_ms,
                        fixture_format_decode_upload_ms_median=format_ms)


def phase_io() -> dict:
    """The native host runtime: its g++ build, the committed fixture frames
    decoded by it equal byte for byte to the Python decoder, and the host
    ms of a 375x1242 frame for each decoder (the Python one timed once);
    every committed JPEG decoded to its manifest's SHA-256, and the host ms
    of the 375x1242 JPEG frame (median of 20, under the PNG's 50 ms); every
    committed BMP, TIFF, GIF, PNM and PFM fixture decoded to its manifest's
    SHA-256 (RGB and ground truth), and the host ms of ``decode_image_rgb``
    of the fixture frame as a BMP, a PPM and an uncompressed, an LZW and a
    Deflate TIFF (median of 20 each, each under 50 ms, each equal to the
    PNG's pixels)."""
    from stereo_tpu_torch import _native
    from stereo_tpu_torch.pipeline.camera.kitti import KITTI_PAD
    from stereo_tpu_torch.utils.image_io import decode_image_rgb
    from stereo_tpu_torch.utils.png import decode_png, decode_png_python

    _native.library()
    frames = []
    python_ms = None
    for path in FIXTURE_FRAMES:
        with open(path, "rb") as f:
            data = f.read()
        native = _native.decode_png_hwc(data)
        t0 = time.perf_counter()
        oracle = decode_png_python(data)
        if python_ms is None:
            python_ms = (time.perf_counter() - t0) * 1e3
        padded = _native.decode_png_padded_chw(path, KITTI_PAD)
        require(np.array_equal(native, oracle)
                and np.array_equal(decode_png(data), oracle)
                and np.array_equal(padded[:, 5:380, 19:1261],
                                   oracle.transpose(2, 0, 1)),
                f"native decode of {path} differs from the Python decoder")
        frames.append(dict(frame=os.path.relpath(path, ROOT),
                           shape=list(native.shape), bytes=len(data),
                           equal_to_python=True))
    with open(FIXTURE_FRAMES[0], "rb") as f:
        data = f.read()

    def host_ms(fn, reps=20):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    native_ms = host_ms(lambda: _native.decode_png_hwc(data))
    require(native_ms < 50, f"native decode took {native_ms} ms")
    names = sorted(jpeg_manifest()["files"])
    for name in names:
        manifest_checked_jpeg(os.path.join(JPEG_FIXTURES, name))
    with open(JPEG_FRAME, "rb") as f:
        jpeg = f.read()
    jpeg_ms = host_ms(lambda: _native.decode_jpeg_rgb(jpeg))
    require(jpeg_ms < 50, f"native JPEG decode took {jpeg_ms} ms")
    raster_names = sorted(raster_manifest()["files"])
    for name in raster_names:
        manifest_checked_raster(os.path.join(RASTER_FIXTURES, name))
    frame, files = frame_files()
    format_ms = {}
    for name, blob in files.items():
        require(np.array_equal(decode_image_rgb(blob), frame),
                f"the fixture frame as {name} decodes to other pixels")
        format_ms[name] = host_ms(lambda: decode_image_rgb(blob))
        require(format_ms[name] < 50,
                f"{name} decode of the frame took {format_ms[name]} ms")
    return dict(gxx_seconds=round(_native.build_seconds, 3),
                library=os.path.relpath(_native.library_path(), ROOT),
                native_available=_native.available(),
                build_error=_native.build_error(),
                png_cases=check_png_cases(),
                jpeg_fixtures=dict(files=len(names), equal_to_manifest=True),
                frames=frames, python_decode_ms_once=python_ms,
                native_decode_ms=native_ms,
                native_jpeg_decode_ms=jpeg_ms,
                raster_fixtures=dict(files=len(raster_names),
                                     equal_to_manifest=True),
                frame_format_decode_ms=format_ms,
                frame_format_bytes={k: len(v) for k, v in files.items()},
                decode_png_ms=host_ms(lambda: decode_png(data)),
                native_file_padded_ms=host_ms(
                    lambda: _native.decode_png_padded_chw(FIXTURE_FRAMES[0],
                                                          KITTI_PAD)))


# Adam7's passes: (first column, first row, column step, row step).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def encode_test_png(samples, depth: int, color: int, interlace: bool,
                    palette=None, trns=None) -> bytes:
    """PNG bytes of the stored ``samples`` (H, W, S) at ``depth`` bits,
    plain or Adam7, row r of each pass filtered with type r % 3 (none, Sub,
    Up): an encoder of its own, since the card's machine has no imaging
    library."""
    import struct
    import zlib

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    h, w, s = samples.shape
    bpp = max(1, s * depth // 8)
    raw = bytearray()
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prior = None
        for r, row in enumerate(sub):
            vals = row.reshape(-1).astype(np.int64)
            if depth == 16:
                packed = vals.astype(">u2").tobytes()
            elif depth == 8:
                packed = vals.astype(np.uint8).tobytes()
            else:
                packed = np.packbits(((vals[:, None] >> np.arange(
                    depth - 1, -1, -1)) & 1).reshape(-1).astype(
                        np.uint8)).tobytes()
            cur = np.frombuffer(packed, np.uint8).astype(np.int64)
            up = np.zeros_like(cur) if prior is None else prior
            left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
            pred = (np.zeros_like(cur), left, up)[r % 3]
            raw.append(r % 3)
            raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
            prior = cur
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace))
    body = chunk(b"IHDR", ihdr)
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns.astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(
        bytes(raw))) + chunk(b"IEND", b""))


def check_png_cases() -> dict:
    """The PNG kinds the decoders take besides 8-bit grey/RGB/RGBA (grey at
    1, 2, 4 and 16 bits, palettes with and without tRNS, grey+alpha, 16-bit
    RGB and RGBA), plain and Adam7: the native samples equal the Python
    oracle's, and the native padded RGB (a file, as the cameras read it)
    equals the oracle's samples mapped as PIL's ``convert("RGB")`` maps
    them (the CPU tests hold that mapping to PIL itself)."""
    import tempfile

    from stereo_tpu_torch import _native
    from stereo_tpu_torch.utils.png import decode_png_python, rgb_like_pil

    rng = np.random.default_rng(30)
    cases = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "case.png")
        for color, depth, trns in ((0, 1, False), (0, 2, False),
                                   (0, 4, False), (0, 16, False),
                                   (3, 4, False), (3, 8, True),
                                   (4, 8, False), (4, 16, False),
                                   (2, 16, False), (6, 16, False)):
            for interlace in (False, True):
                samples_per_pixel = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
                palette = alpha = None
                top = 2 ** depth
                if color == 3:
                    top = min(top, 40)
                    palette = rng.integers(0, 256, (top, 3))
                    alpha = rng.integers(0, 256, top // 2) if trns else None
                elif color == 0 and depth == 16:
                    top = 400                   # PIL clips 16-bit grey
                samples = rng.integers(0, top, (37, 45, samples_per_pixel))
                data = encode_test_png(samples, depth, color, interlace,
                                       palette, alpha)
                oracle = decode_png_python(data)
                native = _native.decode_png_hwc(data)
                with open(path, "wb") as f:
                    f.write(data)
                padded = _native.decode_png_padded_chw(path)
                require(np.array_equal(native, oracle)
                        and np.array_equal(padded, rgb_like_pil(oracle)
                                           .transpose(2, 0, 1)),
                        f"PNG colour type {color}, depth {depth}, tRNS "
                        f"{trns}, interlace {interlace}: native differs "
                        f"from the Python decoder")
                cases += 1
    return dict(cases=cases, equal_to_python=True)


class plain_versions:
    """Within the block the pipeline's modules call the kernels' plain
    versions instead of their wrappers: the same frames through the same
    pipeline, weights and all, with no kernel."""

    def __enter__(self):
        import stereo_tpu_torch.models.deep3d as deep3d
        import stereo_tpu_torch.models.gwcnet as gwcnet
        import stereo_tpu_torch.ops.classical_fused as classical_fused
        import stereo_tpu_torch.synthesis.right_view_synthesis as rvs
        from stereo_tpu_torch.ops.cuda import (gwc_volume_plain,
                                               matching_core_plain,
                                               sampled_window_plain,
                                               upsample_blend_plain)
        from stereo_tpu_torch.pipeline import DepthEstimationPipeline

        # The fused engine replays graphs captured with the kernels, so the
        # plain run takes the pipeline's unfused route: the same stages.
        self.swaps = ((classical_fused, "matching_core", matching_core_plain),
                      (classical_fused, "sampled_window",
                       sampled_window_plain),
                      (deep3d, "upsample_blend", upsample_blend_plain),
                      (rvs, "upsample_blend", upsample_blend_plain),
                      (gwcnet, "build_gwc_volume", gwc_volume_plain),
                      (DepthEstimationPipeline, "_fused_single_view",
                       lambda pipeline: None))
        self.saved = [getattr(m, name) for m, name, _ in self.swaps]
        for module, name, plain in self.swaps:
            setattr(module, name, plain)
        return self

    def __exit__(self, *exc):
        for (module, name, _), kernel in zip(self.swaps, self.saved):
            setattr(module, name, kernel)


def recording(pipeline) -> list:
    """Record every disparity map ``pipeline.process`` returns."""
    maps = []
    process = pipeline.process

    def process_and_record(left, right=None):
        result = process(left, right)
        maps.append(result.disparity_map)
        return result

    pipeline.process = process_and_record
    return maps


def compare_maps(torch, got: list, want: list) -> dict:
    diffs = [(a - b).abs() for a, b in zip(got, want)]
    return dict(frac_within_0p5=min(float((d <= 0.5).float().mean())
                                    for d in diffs),
                frac_equal=min(float((d == 0).float().mean())
                               for d in diffs),
                max_abs_diff=max(float(d.max()) for d in diffs))


def run_arms(torch, dev, synthesis, make_camera, needed: dict):
    """``run_depth_estimation_pipeline_evaluation`` with the six metrics
    for each (backend, rvs[, compute dtype]) arm of ``needed`` on
    ``make_camera(rvs)``, each held against the same arm with the frames
    run through the plain versions; every kernel the arm names must launch
    in its run.  Returns the launch counts, the numbers and the kernel
    run's disparity maps of each arm."""
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                           extract_config_from_camera,
                                           run_depth_estimation_pipeline_evaluation)
    from stereo_tpu_torch.pipeline.metrics import default_metrics

    arms, counts, arm_maps = {}, {}, {}
    for (backend, rvs, *dtype), kernels in needed.items():
        t = time.perf_counter()
        camera = make_camera(rvs)
        config = extract_config_from_camera(camera).update(
            stereo_matching_backend=backend,
            compute_dtype=dtype[0] if dtype else "float32")
        pipeline = DepthEstimationPipeline(
            config, synthesis=synthesis if rvs == "on" else None, device=dev)
        maps = recording(pipeline)
        reset_launch_counts()
        metrics = run_depth_estimation_pipeline_evaluation(
            camera, pipeline, default_metrics(), verbose=False)
        torch.cuda.synchronize()
        arm = "/".join([backend, f"rvs_{rvs}", *dtype])
        counts[arm] = dict(LAUNCHES)
        require(all(counts[arm][k] >= 1 for k in kernels),
                f"evaluation {arm} missed a kernel: {counts[arm]}")
        kernel_maps = list(maps)
        maps.clear()
        with plain_versions():
            reset_launch_counts()
            plain = run_depth_estimation_pipeline_evaluation(
                camera, pipeline, default_metrics(), verbose=False)
            torch.cuda.synchronize()
            require(not any(LAUNCHES.values()),
                    f"plain run of {arm} launched {dict(LAUNCHES)}")
        require(len(kernel_maps) == len(maps) == len(camera),
                f"evaluation {arm}: {len(kernel_maps)} frames")
        require(all(np.isfinite(v) for v in metrics.values()),
                f"evaluation {arm}: {metrics}")
        diff = max(abs(metrics[k] - plain[k]) for k in metrics)
        agreement = compare_maps(torch, kernel_maps, maps)
        require(diff <= 1e-3 and agreement["frac_within_0p5"] >= 0.99,
                f"evaluation {arm}: metrics {metrics} against the plain "
                f"versions' {plain}, disparity {agreement}")
        arms[arm] = dict(metrics=metrics, plain_metrics=plain,
                         max_metric_diff=diff, disparity_vs_plain=agreement,
                         frames=len(camera), launches=counts[arm],
                         seconds=round(time.perf_counter() - t, 3))
        arm_maps[arm] = kernel_maps
        del pipeline
    return counts, arms, arm_maps


def phase_evaluation(torch, dev, synthesis):
    """The KITTI fixture drive's evaluation: classical and GwcNet, each
    with the real right view (rvs off) and with Deep3D's (rvs on)."""
    from stereo_tpu_torch.pipeline.camera import KittiSingleViewCamera

    needed = {("classical", "off"): ("matching_core", "sampled_window"),
              ("classical", "on"): CLASSICAL_KERNELS,
              ("gwcnet", "off"): ("gwc_volume",),
              ("gwcnet", "on"): GWCNET_KERNELS}
    counts, arms, _ = run_arms(
        torch, dev, synthesis, lambda rvs: KittiSingleViewCamera(
            FIXTURE_DRIVE, return_right_view=(rvs == "off")), needed)
    return counts, arms


# The JAX package's accuracy record on its held-out synthetic scenes (seed
# 20260817, 8 frames, 384x1280, disparity 0..64, rvs off), committed
# weights: results/evaluation/evaluation_r05_native_protocol.json.
RECORD_D1 = {"classical": 0.055478671099990606,
             "gwcnet": 0.00038426719038398005}
# The same record's depth-prior scenes with Deep3D's right view (rvs on):
# held only with the committed Deep3D weights.
RECORD_RVS_ON_D1 = {"classical": 0.09480642108246684,
                    "gwcnet": 0.017927043576491997}


def phase_synthetic(torch, dev, synthesis, deep3d_weights: str):
    """The ``--synthetic`` evaluation at the JAX script's defaults, the
    record's protocol (``SyntheticStereoCamera``: seed 20260817, 8 frames,
    384x1280; random-disparity scenes with the real right view, depth-prior
    scenes with Deep3D's), classical and GwcNet on the committed weights:
    every arm against the plain versions, and the rvs-off D1 within 1e-3
    of the record, the rvs-on D1 too when ``deep3d_weights`` is
    ``"committed"`` (seeded Deep3D weights synthesize no usable view; their
    D1 is printed, not held); GwcNet also in bf16 with the real right
    view, its maps held to the float32 arm's."""
    from stereo_tpu_torch.pipeline.camera import SyntheticStereoCamera

    needed = {("classical", "off"): ("matching_core", "sampled_window"),
              ("gwcnet", "off"): ("gwc_volume",),
              ("gwcnet", "off", "bfloat16"): ("gwc_volume",),
              ("classical", "on"): CLASSICAL_KERNELS,
              ("gwcnet", "on"): GWCNET_KERNELS}
    counts, arms, maps = run_arms(
        torch, dev, synthesis, lambda rvs: SyntheticStereoCamera(
            n_frames=8, height=384, width=1280,
            return_right_view=(rvs == "off"), seed=20260817,
            depth_prior=(rvs == "on"), device=dev), needed)
    d1 = {}
    for backend, want in RECORD_D1.items():
        got = arms[f"{backend}/rvs_off"]["metrics"]["D1"]
        d1[backend] = dict(port=got, record=want, diff=got - want)
        require(abs(got - want) <= 1e-3,
                f"synthetic D1 {backend}: {got} against the record {want}")
    rvs_on = {"deep3d_weights": deep3d_weights,
              "held": deep3d_weights == "committed"}
    for backend, want in RECORD_RVS_ON_D1.items():
        got = arms[f"{backend}/rvs_on"]["metrics"]["D1"]
        rvs_on[backend] = dict(port=got, record=want, diff=got - want)
        require(not rvs_on["held"] or abs(got - want) <= 1e-3,
                f"synthetic rvs-on D1 {backend}: {got} against the record "
                f"{want} (committed Deep3D)")
    # The bf16 GwcNet arm held to the float32 one on the same frames: the
    # CPU test's mean bound (0.02 px) and the record's D1 within 1e-3, as
    # the float32 arm.  The CPU test's 0.5 px max bound does not hold for
    # bf16 against float32 at 384x1280 (1.67 px, 0.0102% of the pixels
    # beyond 0.5 px on an H100), so the max and the share beyond 0.5 px
    # are reported, not held.
    diffs = [(a - b).abs() for a, b in zip(maps["gwcnet/rvs_off/bfloat16"],
                                           maps["gwcnet/rvs_off"])]
    bf16 = dict(mean_abs=statistics.fmean(float(d.mean()) for d in diffs),
                max_abs=max(float(d.max()) for d in diffs),
                share_over_0p5=max(float((d > 0.5).float().mean())
                                   for d in diffs),
                d1=arms["gwcnet/rvs_off/bfloat16"]["metrics"]["D1"])
    require(bf16["mean_abs"] <= 0.02
            and abs(bf16["d1"] - RECORD_D1["gwcnet"]) <= 1e-3,
            f"bf16 GwcNet against float32: {bf16}")
    return counts, dict(arms=arms, d1_vs_record=d1,
                        rvs_on_d1_vs_record=rvs_on, bf16_vs_float32=bf16)


def timed_steps(torch, step, reps: int) -> list:
    """Host milliseconds of ``reps`` training steps, each between two
    ``torch.cuda.synchronize()``; the last one's loss must be finite."""
    times, loss = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    require(bool(torch.isfinite(loss)), f"training loss {loss}")
    return times


def grads_of(model) -> dict:
    return {n: p.grad.detach().double().cpu()
            for n, p in model.named_parameters() if p.grad is not None}


def compare_steps(torch, card_model, cpu_model, card_loss, cpu_loss,
                  before: dict, lr: float) -> dict:
    """One training step taken on the card and on the CPU from the same
    weights and inputs (dropout off), compared.  Tolerances (both sides
    float32, TF32 off): the loss within 1e-4 relative; the BatchNorm
    statistics within 1e-4 of each array's largest entry; the gradients
    within 5e-2 in global relative norm (where BatchNorm trains, the early
    convolutions' weight gradients sum some 10^5 products that cancel, and
    their float32 rounding reaches a percent of the norm); no
    parameter's Adam update apart by more than 2.01 learning rates (the
    update is about lr * sign(gradient), so a gradient near 0 may flip)."""
    loss_rel = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    g_card, g_cpu = grads_of(card_model), grads_of(cpu_model)
    num = sum(float(((g_card[k] - g_cpu[k]) ** 2).sum()) for k in g_cpu)
    den = sum(float((g_cpu[k] ** 2).sum()) for k in g_cpu)
    grad_rel = (num / den) ** 0.5
    card_state = {k: v.double().cpu() for k, v in
                  card_model.state_dict().items()}
    cpu_state = {k: v.double() for k, v in cpu_model.state_dict().items()}
    stats = [k for k in cpu_state if k.endswith(("running_mean",
                                                 "running_var"))]
    stats_rel = max((float((card_state[k] - cpu_state[k]).abs().max())
                     / max(float(cpu_state[k].abs().max()), 1e-12)
                     for k in stats), default=0.0)
    params = [n for n, _ in cpu_model.named_parameters()]
    update_diff = max(float(((card_state[k] - before[k])
                             - (cpu_state[k] - before[k])).abs().max())
                      for k in params)
    moved = sum(int((card_state[k] != before[k]).sum()) for k in params)
    result = dict(loss_card=float(card_loss), loss_cpu=float(cpu_loss),
                  loss_rel=loss_rel, grad_rel=grad_rel,
                  batch_stats_rel=stats_rel,
                  max_update_diff_in_lr=update_diff / lr,
                  params_moved=moved)
    require(loss_rel <= 1e-4 and stats_rel <= 1e-4 and grad_rel <= 5e-2
            and update_diff <= 2.01 * lr and moved > 0,
            f"card step against CPU step: {result}")
    return result


def check_trained(torch, model, before: dict) -> dict:
    """The parameters moved and every parameter and statistic is finite."""
    state = model.state_dict()
    params = [n for n, _ in model.named_parameters()]
    moved = sum(int((state[k].cpu() != before[k]).any()) for k in params)
    finite = all(bool(torch.isfinite(v).all()) for v in state.values())
    require(moved > 0 and finite,
            f"training: {moved} parameters moved, all finite: {finite}")
    return dict(parameter_tensors_moved=moved, of=len(params))


def phase_train_deep3d(torch, dev, tmp: str):
    """``Trainer`` at the reference's operating point: Deep3D at 384x1280 /
    96x320, batch 2, float32, on the fixture drive through
    ``KittiStereoDataset``.  One step without dropout against the same
    step on the CPU; a few steps with dropout; the export loaded into
    ``RightViewSynthesis`` on the card, whose ``upsample_blend`` view must
    equal the plain version's."""
    from stereo_tpu_torch.core.config import TrainerConfig
    from stereo_tpu_torch.models import Deep3D
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.synthesis import RightViewSynthesis
    from stereo_tpu_torch.train import KittiStereoDataset, Trainer
    from stereo_tpu_torch.train.kitti_dataset import batch_iterator
    from stereo_tpu_torch.train.trainer import to_device

    config = TrainerConfig(batch_size=2, log_every=0)
    dataset = KittiStereoDataset([FIXTURE_DRIVE])
    batch = next(batch_iterator(dataset, 2, seed=0))
    trainer = Trainer(config=config, seed=0, device=dev, dropout=False)
    before = {k: v.detach().double().cpu()
              for k, v in trainer.model.state_dict().items()}
    cpu = Trainer(Deep3D(), config, state_dict={
        k: v.cpu() for k, v in trainer.model.state_dict().items()},
        device="cpu", dropout=False)
    t0 = time.perf_counter()
    cpu_loss = cpu.train_step(*to_device(batch, "cpu"))
    cpu_step_s = time.perf_counter() - t0
    card_loss = trainer.train_step(*to_device(batch, dev))
    torch.cuda.synchronize()
    versus_cpu = compare_steps(torch, trainer.model, cpu.model, card_loss,
                               cpu_loss, before, config.learning_rate)
    del cpu

    trainer.dropout = True
    torch.cuda.reset_peak_memory_stats(dev)
    losses = trainer.train(dataset, n_epochs=2)
    device_batch = to_device(batch, dev)
    times = timed_steps(torch, lambda: trainer.train_step(*device_batch), 4)
    peak = torch.cuda.max_memory_allocated(dev)
    require(all(np.isfinite(losses)), f"Deep3D epoch losses {losses}")
    trained = check_trained(torch, trainer.model, before)

    path = os.path.join(tmp, "deep3d.npz")
    trainer.export_inference_variables(path)
    synthesis = RightViewSynthesis(output_shape=(384, 1280),
                                   checkpoint_dir=path, device=dev)
    left = torch.from_numpy(batch[0][:1] * 255.0).to(dev)
    reset_launch_counts()
    view = synthesis.process_batch(left)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    require(counts["upsample_blend"] >= 1,
            f"exported Deep3D missed upsample_blend: {counts}")
    with plain_versions():
        plain = synthesis.process_batch(left)
    err = float((view - plain).abs().max())
    require(err <= 0.05 and bool(torch.isfinite(view).all()),
            f"exported Deep3D view off the plain version by {err}")
    return counts, dict(
        versus_cpu=versus_cpu, cpu_step_s=cpu_step_s, epoch_losses=losses,
        ms_per_step_median=statistics.median(times), ms_per_step=times,
        max_memory_allocated_bytes=peak, trained=trained,
        export_view_vs_plain_max_abs=err, export_launches=counts)


def write_png16(path: str, image) -> None:
    """(H, W) uint16 -> a 16-bit grey PNG (filter 0), written with zlib:
    KITTI 2015's ground-truth format (disparity * 256)."""
    import struct
    import zlib

    h, w = image.shape
    rows = np.ascontiguousarray(image, ">u2").view(np.uint8).reshape(h, 2 * w)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def write_kitti2015(root: str, n: int = 4) -> tuple:
    """``n`` KITTI 2015 style triplets: the fixture drive's frames as
    ``image_2``/``image_3`` and seeded 16-bit disparities (0..64 px, 30%
    missing) as ``disp_occ_0``; returns the three file lists."""
    rng = np.random.default_rng(12)
    lists = ([], [], [])
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        name = f"{i:06d}_10.png"
        for j, side in enumerate(("image_02", "image_03")):
            dst = os.path.join(root, ("image_2", "image_3")[j], name)
            shutil.copy(os.path.join(FIXTURE_DRIVE, side, "data",
                                     f"{i % 2:010d}.png"), dst)
            lists[j].append(dst)
        disp = rng.uniform(0, 64, (375, 1242)) * (rng.uniform(
            0, 1, (375, 1242)) > 0.3)
        dst = os.path.join(root, "disp_occ_0", name)
        write_png16(dst, np.round(disp * 256).astype(np.uint16))
        lists[2].append(dst)
    return lists


def ground_truth_twins(png_paths, root: str) -> dict:
    """The 16-bit ground-truth PNGs again as PFM (``Pf``, little-endian,
    bottom-up) and as float32 TIFF (Deflate, predictor 3), the same
    disparities (multiples of 1/256, exact in float32): format -> paths.
    Each twin must read back (``read_disparity``) equal to its PNG."""
    from stereo_tpu_torch.train.stereo_trainer import read_disparity

    tiff_file = raster_writers()[2]

    twins = {"pfm": [], "float_tiff": []}
    for fmt in twins:
        os.makedirs(os.path.join(root, f"disp_{fmt}"), exist_ok=True)
    for png in png_paths:
        disp = read_disparity(png)
        h, w = disp.shape
        stem = os.path.splitext(os.path.basename(png))[0]
        blobs = {"pfm": b"Pf\n%d %d\n-1.0\n" % (w, h) + disp[::-1].astype(
                     "<f4").tobytes(),
                 "float_tiff": tiff_file(disp, 1, compression=8,
                                         predictor=3)}
        for fmt, blob in blobs.items():
            path = os.path.join(root, f"disp_{fmt}",
                                stem + (".pfm" if fmt == "pfm" else ".tif"))
            with open(path, "wb") as f:
                f.write(blob)
            require(np.array_equal(read_disparity(path), disp),
                    f"{path} reads back other disparities than {png}")
            twins[fmt].append(path)
    return twins


def phase_train_stereo(torch, dev, tmp: str):
    """GwcNet at its published widths (320 features, 40 groups, 16
    layer-2 blocks): ``SyntheticStereoTrainer`` at its defaults (256x512,
    disparity 64, batch 4), its first step on two scenes against the same
    step on the CPU, then a few steps; ``StereoTrainer`` for one epoch on
    four 16-bit-GT triplets, then from the same seed on the same triplets
    with their ground truth as PFM and as float TIFF, whose epoch losses
    must equal the PNG epoch's; the synthetic trainer's export loaded in
    the GwcNet backend, whose ``gwc_volume`` must agree with the plain
    version on the exported net."""
    import copy

    import stereo_tpu_torch.models.gwcnet as gwcnet_module
    from stereo_tpu_torch.core.config import TrainerConfig
    from stereo_tpu_torch.ops.cuda import (LAUNCHES, gwc_volume_plain,
                                           reset_launch_counts)
    from stereo_tpu_torch.pipeline import DnnStereoMatchingBackend
    from stereo_tpu_torch.train import (Kitti2015StereoDataset,
                                        StereoTrainer, SyntheticStereoTrainer)
    from stereo_tpu_torch.train.stereo_trainer import stereo_step

    trainer = SyntheticStereoTrainer("gwcnet", chunk=3, device=dev)
    before = {k: v.detach().double().cpu()
              for k, v in trainer.model.state_dict().items()}
    left, right, gt = (x[:2] for x in trainer.next_batch())
    lr = trainer.schedule(0)
    cpu_model = copy.deepcopy(trainer.model).cpu()
    cpu_opt = torch.optim.AdamW(cpu_model.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
    t0 = time.perf_counter()
    cpu_loss = stereo_step(cpu_model, cpu_opt, trainer.loss_fn, 64,
                           left.cpu(), right.cpu(), gt.cpu(), clip_norm=5.0)
    cpu_step_s = time.perf_counter() - t0
    card_loss = stereo_step(trainer.model, trainer.optimizer, trainer.loss_fn,
                            64, left, right, gt, clip_norm=5.0)
    torch.cuda.synchronize()
    versus_cpu = compare_steps(torch, trainer.model, cpu_model, card_loss,
                               cpu_loss, before, lr)
    del cpu_model, cpu_opt

    torch.cuda.reset_peak_memory_stats(dev)
    losses = trainer.train(3, log_every_chunks=0)
    times = timed_steps(torch, trainer._step, 3)
    peak = torch.cuda.max_memory_allocated(dev)
    require(all(np.isfinite(losses)), f"GwcNet synthetic losses {losses}")
    trained = check_trained(torch, trainer.model, before)
    path = os.path.join(tmp, "gwcnet.npz")
    trainer.export(path)

    files = write_kitti2015(os.path.join(tmp, "kitti2015"))
    kitti = StereoTrainer("gwcnet", config=TrainerConfig(
        n_epochs=1, batch_size=4, learning_rate=1e-3), device=dev)
    kitti_before = {k: v.detach().double().cpu()
                    for k, v in kitti.model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    kitti_losses = kitti.train(Kitti2015StereoDataset(*files))
    torch.cuda.synchronize()
    kitti_epoch_s = time.perf_counter() - t0
    kitti_peak = torch.cuda.max_memory_allocated(dev)
    require(len(kitti_losses) == 1 and np.isfinite(kitti_losses[0]),
            f"StereoTrainer epoch losses {kitti_losses}")
    kitti_trained = check_trained(torch, kitti.model, kitti_before)
    del kitti
    twin_losses = {}
    for fmt, paths in ground_truth_twins(
            files[2], os.path.join(tmp, "kitti2015")).items():
        twin = StereoTrainer("gwcnet", config=TrainerConfig(
            n_epochs=1, batch_size=4, learning_rate=1e-3), device=dev)
        twin_losses[fmt] = twin.train(Kitti2015StereoDataset(
            files[0], files[1], paths))
        del twin
        require(twin_losses[fmt] == kitti_losses,
                f"{fmt} ground truth: epoch losses {twin_losses[fmt]}, "
                f"16-bit PNG {kitti_losses}")

    backend = DnnStereoMatchingBackend("gwcnet", (384, 1280),
                                       max_disparity=64,
                                       checkpoint_dir=path, device=dev)
    require(backend.weights == path, f"backend loaded {backend.weights}")
    pair = [torch.from_numpy(x).to(dev) for x in kitti_pair()]
    reset_launch_counts()
    disp = backend.process(*pair)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    require(counts["gwc_volume"] >= 1,
            f"exported GwcNet missed gwc_volume: {counts}")
    build = gwcnet_module.build_gwc_volume
    gwcnet_module.build_gwc_volume = gwc_volume_plain
    try:
        plain = backend.process(*pair)
    finally:
        gwcnet_module.build_gwc_volume = build
    agreement = compare_maps(torch, [disp], [plain])
    require(agreement["frac_within_0p5"] >= 0.99
            and bool(torch.isfinite(disp).all()),
            f"exported GwcNet against the plain volume: {agreement}")
    return counts, dict(
        versus_cpu=versus_cpu, cpu_step_s=cpu_step_s, losses=losses,
        ms_per_step_median=statistics.median(times), ms_per_step=times,
        max_memory_allocated_bytes=peak, trained=trained,
        kitti2015=dict(epoch_loss=kitti_losses[0], epoch_s=kitti_epoch_s,
                       steps=1, batch=4, max_disparity=192,
                       max_memory_allocated_bytes=kitti_peak,
                       trained=kitti_trained,
                       ground_truth_twin_losses=twin_losses,
                       twin_losses_equal_png=True),
        export_vs_plain=agreement, export_launches=counts)


def phase_runner(torch, dev, synthesis, tmp: str):
    """``run_depth_estimation_pipeline`` on the fixture drive (classical,
    rvs on) with every saver, each file read back; then the batched runner
    at batch 2 against the per-frame run, and the frames/s of both."""
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                           extract_config_from_camera,
                                           run_depth_estimation_pipeline,
                                           run_depth_estimation_pipeline_batched)
    from stereo_tpu_torch.pipeline.camera import KittiSingleViewCamera
    from stereo_tpu_torch.pipeline.hooks import (ContextFrameSaver,
                                                 ContextVideoSaver,
                                                 DisparityMapSaver, LambdaHook,
                                                 PointCloudSaver)
    from stereo_tpu_torch.utils.image_io import open_video_writer, read_video
    from stereo_tpu_torch.utils.png import decode_png
    from stereo_tpu_torch.utils.pointcloud import read_ply

    camera = KittiSingleViewCamera(FIXTURE_DRIVE)
    config = extract_config_from_camera(camera)
    pipeline = DepthEstimationPipeline(config, synthesis=synthesis, device=dev)
    n = len(camera)

    def collector(store):
        return LambdaHook(lambda ctx: store.__setitem__(
            ctx.frame_index, ctx.disparity_map.cpu()))

    per_frame = {}
    video = os.path.join(tmp, "video", "drive.mp4")
    hooks = [collector(per_frame),
             DisparityMapSaver(os.path.join(tmp, "disparity")),
             ContextFrameSaver(os.path.join(tmp, "context")),
             PointCloudSaver.for_camera(camera, os.path.join(tmp, "cloud"),
                                        config.invalid_disparity),
             ContextVideoSaver(video, fps=30)]
    reset_launch_counts()
    t0 = time.perf_counter()
    run_depth_estimation_pipeline(camera, pipeline, hooks)
    torch.cuda.synchronize()
    with_savers_s = time.perf_counter() - t0
    counts = {"runner": dict(LAUNCHES)}
    require(all(counts["runner"][k] >= 1 for k in CLASSICAL_KERNELS),
            f"runner missed a kernel: {counts['runner']}")

    files = {}
    for sub in ("disparity", "context", "cloud"):
        (folder,) = os.listdir(os.path.join(tmp, sub))
        files[sub] = sorted(os.path.join(tmp, sub, folder, f)
                            for f in os.listdir(os.path.join(tmp, sub,
                                                             folder)))
        require(len(files[sub]) == n, f"{sub} saver wrote {files[sub]}")
    h, w = config.image_shape
    for path in files["disparity"]:
        shape = decode_png(open(path, "rb").read()).shape
        require(shape == (h + 20, w + 20, 3), f"{path}: {shape}")
    grid = (3 * h + 40, w + 20, 3)
    for path in files["context"]:
        shape = decode_png(open(path, "rb").read()).shape
        require(shape == grid, f"{path}: {shape}")
    for i, path in enumerate(files["cloud"]):
        valid = int((per_frame[i] != config.invalid_disparity).sum())
        points = read_ply(path)
        require(points.shape == (valid, 3),
                f"{path}: {points.shape}, {valid} valid pixels")
    frames, fps = read_video(video)
    require(frames.shape == (n, *grid) and fps == 30,
            f"video {frames.shape} at {fps} fps")
    contexts = [decode_png(open(path, "rb").read())
                for path in files["context"]]
    video_psnr = [psnr_db(frame, context)
                  for frame, context in zip(frames, contexts)]
    require(min(video_psnr) >= VIDEO_PSNR_FLOOR_DB,
            f"video frames against their context PNGs: {video_psnr} dB, "
            f"floor {VIDEO_PSNR_FLOOR_DB}")
    writer = open_video_writer(os.path.join(tmp, "video", "timed.mp4"),
                               *grid[:2], 30)
    encode_ms = []
    for _ in range(5):
        for context in contexts:
            t0 = time.perf_counter()
            writer.write(context[:, :, ::-1])
            encode_ms.append((time.perf_counter() - t0) * 1e3)
    writer.release()

    # Both runners with one collecting hook, warm: agreement and frames/s.
    batched = {}
    reset_launch_counts()
    run_depth_estimation_pipeline_batched(camera, pipeline, 2,
                                          [collector(batched)])
    torch.cuda.synchronize()
    counts["runner_batched"] = dict(LAUNCHES)
    require(sorted(batched) == list(range(n)), f"batched frames {batched}")
    agreement = compare_maps(torch, [batched[i] for i in range(n)],
                             [per_frame[i] for i in range(n)])
    require(agreement["frac_within_0p5"] >= 0.99,
            f"batched runner against per-frame: {agreement}")

    def fps_of(run, reps=3):
        rates = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
        return statistics.median(rates)

    # One frame under ``device_trace``: its Chrome trace holds the card's
    # kernels, the hand-written ones among them.
    from stereo_tpu_torch.utils.profiling import device_trace

    left, _ = next(camera.stream_image_pairs())
    with device_trace(os.path.join(tmp, "trace")) as trace_path:
        pipeline.process(left)
        torch.cuda.synchronize()
    with open(trace_path) as f:
        traced = [e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    require(all(any(k in name for name in traced) for k in CLASSICAL_KERNELS),
            f"device_trace holds no kernel of {CLASSICAL_KERNELS}: "
            f"{len(traced)} kernel events")

    sink = {}
    numbers = dict(
        frames=n, files={k: len(v) for k, v in files.items()},
        trace_kernel_events=len(traced),
        video_frames=int(frames.shape[0]),
        video_bytes=os.path.getsize(video),
        video_bytes_per_frame=os.path.getsize(video) / n,
        video_psnr_db=video_psnr, video_psnr_db_min=min(video_psnr),
        video_psnr_floor_db=VIDEO_PSNR_FLOOR_DB,
        video_encode_ms=statistics.median(encode_ms),
        batched_vs_per_frame=agreement,
        fps_per_frame_with_savers=n / with_savers_s,
        fps_per_frame=fps_of(lambda: run_depth_estimation_pipeline(
            camera, pipeline, [collector(sink)])),
        fps_batched_2=fps_of(lambda: run_depth_estimation_pipeline_batched(
            camera, pipeline, 2, [collector(sink)])),
        launches=counts)
    return counts, numbers, contexts


def psnr_db(a, b) -> float:
    """PSNR of two uint8 images, in dB."""
    err = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64))
                  ** 2)
    return float("inf") if err == 0 else float(10 * np.log10(255.0 ** 2
                                                             / err))


def phase_video_stream(grids: list, tmp: str) -> dict:
    """``VIDEO_STREAM_FRAMES`` context grids through ``open_video_writer``
    (frame k: grid k mod len(grids) rolled 4k pixels sideways), the file's
    tables read back, and its last frame decoded by the port."""
    from stereo_tpu_torch import _native
    from stereo_tpu_torch.utils.image_io import open_video_writer
    from stereo_tpu_torch.utils.mp4 import read_sample, read_track

    def frame(k):
        return np.roll(grids[k % len(grids)], 4 * k, axis=1)

    path = os.path.join(tmp, "stream.mp4")
    h, w, _ = grids[0].shape
    writer = open_video_writer(path, h, w, 30)
    encode_ms = []
    t0 = time.perf_counter()
    for k in range(VIDEO_STREAM_FRAMES):
        bgr = frame(k)[:, :, ::-1]
        t1 = time.perf_counter()
        writer.write(bgr)
        encode_ms.append((time.perf_counter() - t1) * 1e3)
    writer.release()
    stream_s = time.perf_counter() - t0
    track = read_track(path)
    require(len(track.sizes) == len(track.offsets) == VIDEO_STREAM_FRAMES,
            f"stsz counts {len(track.sizes)} of {VIDEO_STREAM_FRAMES}")
    with open(path, "rb") as f:
        f.seek(max(track.offsets) + track.sizes[-1])
        moov = f.read()
        require(b"co64" in moov and b"stco" not in moov,
                "the chunk offsets are not in co64")
        last = read_sample(f, track, VIDEO_STREAM_FRAMES - 1)
    t1 = time.perf_counter()
    decoded = _native.decode_mp4v(track.config, last, threads=4)
    decode_ms = (time.perf_counter() - t1) * 1e3
    last_psnr = psnr_db(decoded[:, :, ::-1], frame(VIDEO_STREAM_FRAMES - 1))
    require(last_psnr >= VIDEO_PSNR_FLOOR_DB,
            f"last frame of the stream: {last_psnr} dB, floor "
            f"{VIDEO_PSNR_FLOOR_DB}")
    # The encoder alone at each thread count, on the stream's first frames.
    by_threads = {}
    for threads in (1, 2, 4, 8):
        encoder = _native.Mpeg4Encoder(w & ~1, h & ~1, 30, 4, threads)
        times = []
        for k in range(10):
            bgr = frame(k)[:, :, ::-1]
            t1 = time.perf_counter()
            encoder.encode(bgr, k)
            times.append((time.perf_counter() - t1) * 1e3)
        encoder.close()
        by_threads[threads] = statistics.median(times)
    size = os.path.getsize(path)
    return dict(frames=VIDEO_STREAM_FRAMES, shape=[h, w], bytes=size,
                encode_ms_by_threads=by_threads,
                bytes_per_frame=size / VIDEO_STREAM_FRAMES,
                stsz_count=len(track.sizes), chunk_offsets="co64",
                encode_ms_median=statistics.median(encode_ms),
                encode_ms_p90=float(np.percentile(encode_ms, 90)),
                stream_s=stream_s, last_frame_psnr_db=last_psnr,
                last_frame_decode_ms=decode_ms)


def write_middlebury_scene(scene: str) -> tuple:
    """``middlebury_pair()`` as ``im0.png``/``im1.png`` with a calib.txt
    of its size and disparity range."""
    from stereo_tpu_torch.utils.png import encode_png

    left, right = middlebury_pair()
    os.makedirs(scene, exist_ok=True)
    for name, image in (("im0.png", left), ("im1.png", right)):
        with open(os.path.join(scene, name), "wb") as f:
            f.write(encode_png(image.transpose(1, 2, 0).astype(np.uint8)))
    with open(os.path.join(scene, "calib.txt"), "w") as f:
        f.write(MIDDLEBURY_CALIB)
    return left, right


def phase_middlebury(torch, dev, scene: str, out: str):
    """The classical pipeline at full Middlebury size through the camera,
    the config it implies and the runner with the disparity saver, against
    the same pair through the plain versions."""
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                           extract_config_from_camera,
                                           run_depth_estimation_pipeline)
    from stereo_tpu_torch.pipeline.camera import MiddleburyStereoCamera
    from stereo_tpu_torch.pipeline.hooks import DisparityMapSaver, LambdaHook
    from stereo_tpu_torch.utils.png import decode_png

    camera = MiddleburyStereoCamera(scene)
    config = extract_config_from_camera(camera)
    require((config.image_shape, config.min_disparity, config.max_disparity)
            == ((1080, 1920), 75, 262), f"Middlebury config {config}")
    pipeline = DepthEstimationPipeline(config, device=dev)
    got = {}
    reset_launch_counts()
    run_depth_estimation_pipeline(camera, pipeline, [
        LambdaHook(lambda ctx: got.__setitem__(ctx.frame_index,
                                               ctx.disparity_map)),
        DisparityMapSaver(out)])
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    require(counts["matching_core"] >= 1 and counts["sampled_window"] >= 1,
            f"Middlebury path missed a kernel: {counts}")
    (left, right), = list(camera.stream_image_pairs())
    with plain_versions():
        plain = pipeline.process(left, right).disparity_map
    agreement = compare_maps(torch, [got[0]], [plain])
    require(agreement["frac_within_0p5"] >= 0.99,
            f"Middlebury against the plain versions: {agreement}")
    median = float(got[0][:, 300:-300].median())
    require(abs(median - 150.0) <= 0.5,
            f"Middlebury median disparity {median}, true 150")
    (folder,) = os.listdir(out)
    (saved,) = os.listdir(os.path.join(out, folder))
    shape = decode_png(open(os.path.join(out, folder, saved), "rb").read()
                       ).shape
    require(shape == (1100, 1940, 3), f"saved disparity grid {shape}")
    lt, rt = (torch.from_numpy(x).to(dev) for x in (left, right))
    return counts, dict(
        launches=counts, vs_plain=agreement, median_disparity=median,
        ms_per_frame_median=statistics.median(frame_ms(
            torch, lambda: pipeline.process(lt, rt), 10)),
        ms_per_frame_from_host_median=statistics.median(frame_ms(
            torch, lambda: pipeline.process(left, right), 5)))


def phase_scripts(scene_root: str, tmp: str) -> dict:
    """The five entry points as a user runs them, each in its own process
    on the card, all at once: the evaluation (rvs off, classical and
    GwcNet), the KITTI run with the real right view, the Middlebury run,
    and both training scripts in synthetic mode for 2 steps each, at their
    default sizes."""
    runs = {
        "evaluate_depth_estimation_pipeline": [
            "--drive-dirs", FIXTURE_DRIVE, "--backends", "classical",
            "gwcnet", "--rvs", "off", "--output-dir",
            os.path.join(tmp, "evaluation")],
        "train_right_view_synthesis_model": [
            "--synthetic", "--steps", "2", "--chunk", "1", "--export-every",
            "2", "--export-dir", os.path.join(tmp, "train", "deep3d.npz")],
        "train_stereo_model": [
            "--model", "gwcnet", "--synthetic", "--max-disparity", "64",
            "--steps", "2", "--warmup-steps", "1", "--chunk", "1",
            "--checkpoint", os.path.join(tmp, "train", "gwcnet.npz")],
        "run_kitti_pipeline": [
            "--drive-dir", FIXTURE_DRIVE, "--backends", "classical",
            "--use-right-view", "--save-dir", os.path.join(tmp, "kitti")],
        "run_middlebury_pipeline": [
            "--middlebury-dir", scene_root, "--save-dir",
            os.path.join(tmp, "middlebury")],
    }
    def run(name):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"stereo_tpu_torch.scripts.{name}",
             *runs[name]], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        return proc, time.perf_counter() - t0

    # All five at once, each in its own process on the one card.
    with ThreadPoolExecutor(len(runs)) as pool:
        done = dict(zip(runs, pool.map(run, runs)))
    numbers = {}
    for name, (proc, seconds) in done.items():
        require(proc.returncode == 0,
                f"{name} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
        numbers[name] = dict(seconds=round(seconds, 3))
    for name in ("deep3d", "gwcnet"):
        with open(os.path.join(tmp, "train",
                               f"{name}_synthetic_losses.json")) as f:
            losses = json.load(f)["losses"]
        require(len(losses) == 2 and all(np.isfinite(losses)),
                f"{name} training script's losses {losses}")
        require(os.path.isfile(os.path.join(tmp, "train", f"{name}.npz")),
                f"{name} training script exported nothing")
    (written,) = os.listdir(os.path.join(tmp, "evaluation"))
    with open(os.path.join(tmp, "evaluation", written)) as f:
        results = json.load(f)
    require(len(results) == 2 and all(
        len(m) == 6 and all(np.isfinite(v) for v in m.values())
        for m in results.values()), f"evaluation script wrote {results}")
    numbers["evaluate_depth_estimation_pipeline"]["results"] = results
    from stereo_tpu_torch.utils.image_io import read_video

    frames, _ = read_video(os.path.join(tmp, "kitti", "classical",
                                        "classical.mp4"))
    require(frames.shape == (2, 3 * 384 + 40, 1300, 3),
            f"KITTI run's video: {frames.shape}")
    numbers["run_kitti_pipeline"]["video_frames"] = int(frames.shape[0])
    saved = [f for _, _, fs in os.walk(os.path.join(tmp, "middlebury"))
             for f in fs]
    require(sorted(saved) == ["context_frame_000000.png",
                              "disparity_map_000000.png"],
            f"Middlebury run wrote {saved}")
    return numbers


def phase_server_asgi(torch, pipeline):
    """``create_asgi_app`` around ``pipeline`` driven through ASGI's
    scope/receive/send: GET, then POSTs of the fixture frame's bytes
    (375x1242, resized by the server), the same as a multipart upload, and
    a bad payload."""
    import asyncio

    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.serve import create_asgi_app
    from stereo_tpu_torch.utils.png import decode_png

    config = pipeline.get_configuration()
    app = create_asgi_app(config, pipeline=pipeline, device=pipeline.device)
    with open(FIXTURE_FRAMES[0], "rb") as f:
        frame = f.read()
    boundary = "smokeboundary"
    form = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\";"
            f" filename=\"left.png\"\r\nContent-Type: image/png\r\n\r\n"
            ).encode() + frame + f"\r\n--{boundary}--\r\n".encode()
    requests = [("GET", b"", None), ("POST", frame, "image/png"),
                ("POST", form, f"multipart/form-data; boundary={boundary}"),
                ("POST", b"not a png", "image/png")]

    async def call(method, body, ctype):
        headers = [(b"content-type", ctype.encode())] if ctype else []
        sent, messages = [], [{"type": "http.request", "body": body,
                               "more_body": False}]

        async def receive():
            return messages.pop(0)

        async def send(message):
            sent.append(message)

        await app({"type": "http", "method": method, "path": "/",
                   "headers": headers}, receive, send)
        return sent[0]["status"], b"".join(m.get("body", b"")
                                           for m in sent[1:])

    async def drive():
        return [await call(*r) for r in requests]

    reset_launch_counts()
    t0 = time.perf_counter()
    replies = asyncio.run(drive())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    statuses = [status for status, _ in replies]
    require(statuses == [200, 200, 200, 400], f"ASGI statuses {statuses}")
    require(json.loads(replies[0][1])["image_shape"]
            == list(config.image_shape), f"ASGI GET {replies[0][1]}")
    for _, body in replies[1:3]:
        shape = decode_png(body).shape
        require(shape[:2] == tuple(config.image_shape),
                f"ASGI reply shape {shape}")
    require(replies[1][1] == replies[2][1], "raw and multipart replies differ")
    require(all(counts[k] >= 1 for k in CLASSICAL_KERNELS),
            f"ASGI path missed a kernel: {counts}")
    return counts, dict(statuses=statuses, launches=counts,
                        seconds=round(seconds, 3))


# The virtual mesh: every phase below names one card n times
# (``mesh_devices=[cuda:0] * n``), so the shards run in turn on it.  That
# shows each sharded path right and each shard's kernels at their shapes;
# it does not show copies between cards or shards overlapping.
ROW_HALO = "[rows_prepadded]"


def virtual_mesh(torch, n: int) -> list:
    return [torch.device("cuda", 0)] * n


def shard_rows(torch, full, ti: int, local_h: int, halo: int):
    """Rows ``ti*local_h - halo .. (ti+1)*local_h + halo`` of ``full``,
    wrapped at the global borders: shard ``ti``'s rows after the ring
    exchange of ``halo`` rows."""
    idx = torch.arange(ti * local_h - halo, (ti + 1) * local_h + halo,
                       device=full.device) % full.shape[-2]
    return full.index_select(-2, idx).contiguous()


def check_row_halo(torch, cfg, dev, rng, pair, tile: int, label: str) -> list:
    """The row-halo mode of ``matching_core`` and ``sampled_window`` on the
    row shards of ``tile`` at ``cfg``, against their plain versions, bit for
    bit: ``matching_core`` on every shard of the real pair's luma and on
    shard 0 (which wraps at the top) of every integer pair of
    ``integer_pairs``; ``sampled_window`` on every shard at the kernel's
    winners and at the smallest, largest and seeded winners.  Returns the
    two kernels' rows at shard 1 of the real pair, with their times."""
    from stereo_tpu_torch.ops import mean_pool, rgb_to_grayscale
    from stereo_tpu_torch.ops.cuda import (matching_core, matching_core_plain,
                                           sampled_window,
                                           sampled_window_plain)

    k = cfg.k
    pad, sad_r = cfg.large_mbm_radius + cfg.cost_patch_radius, \
        cfg.sad_patch_radius
    local_hd = cfg.down_height // tile
    local_h = k * local_hd
    lo, num_d = cfg.min_disparity_down, cfg.num_disparities_down
    shape = (f"{cfg.height}x{cfg.width}, disparity {cfg.min_disparity}.."
             f"{cfg.max_disparity}, tile {tile}: {local_hd} rows of "
             f"{cfg.down_width} + 2x{pad}")

    def equal(a, b):
        return bool(torch.equal(a, b))

    mc_equal, cases = True, 0
    for _, _, left_i, right_i in integer_pairs(cfg, rng):
        ld = shard_rows(torch, torch.from_numpy(left_i).to(dev), 0, local_hd,
                        pad)
        rd = shard_rows(torch, torch.from_numpy(
            np.ascontiguousarray(right_i)).to(dev), 0, local_hd, pad)
        got = matching_core(ld, rd, cfg, rows_prepadded=True)
        want = matching_core_plain(ld, rd, cfg, rows_prepadded=True)
        mc_equal &= equal(got[0], want[0]) and equal(got[1], want[1])
        cases += 1
    require(mc_equal, f"matching_core{ROW_HALO} {label}: an integer pair "
                      f"differs from the plain version")

    left, right = pair
    lg = rgb_to_grayscale(torch.from_numpy(left).to(dev)).contiguous()
    rg = rgb_to_grayscale(torch.from_numpy(right).to(dev)).contiguous()
    errs = dict(matching_core=0.0, sampled_window=0.0)
    shards = []
    for ti in range(tile):
        ld, rd = (shard_rows(torch, mean_pool(x, k), ti, local_hd, pad)
                  for x in (lg, rg))
        disp, mbm = matching_core(ld, rd, cfg, rows_prepadded=True)
        disp_p, mbm_p = matching_core_plain(ld, rd, cfg, rows_prepadded=True)
        errs["matching_core"] = max(
            errs["matching_core"], float((disp - disp_p).abs().max()),
            float((mbm - mbm_p).abs().max()))
        lgs, rgs = (shard_rows(torch, x, ti, local_h, sad_r)
                    for x in (lg, rg))
        for winners in (disp, torch.full_like(disp, float(lo)),
                        torch.full_like(disp, float(lo + num_d - 1)),
                        torch.from_numpy(rng.integers(
                            lo, lo + num_d, tuple(disp.shape)).astype(
                                np.float32)).to(dev)):
            win = sampled_window(lgs, rgs, winners, cfg, rows_prepadded=True)
            win_p = sampled_window_plain(lgs, rgs, winners, cfg,
                                         rows_prepadded=True)
            errs["sampled_window"] = max(errs["sampled_window"],
                                         float((win - win_p).abs().max()))
        shards.append((ld, rd, lgs, rgs, disp))
    require(errs == dict(matching_core=0.0, sampled_window=0.0),
            f"row-halo kernels {label} differ from the plain versions: {errs}")

    # Times at shard 1 (shard 0 when the mesh has one).
    ld, rd, lgs, rgs, disp = shards[min(1, tile - 1)]
    hd, wd = disp.shape
    r, s, m, L = (cfg.cost_patch_radius, cfg.small_mbm_radius,
                  cfg.mid_mbm_radius, cfg.large_mbm_radius)
    per = 2 + 4 * r + 1 + 4 * (L + s + m) + 2 + 1
    mc_bound = bound(4 * (2 * ld.numel() + 4 * hd * wd), per * num_d * hd * wd)
    win_n, patch = 2 * k + 3, 2 * sad_r + 1
    sw_bound = bound(4 * (2 * lgs.numel() + hd * wd + win_n * hd * wd),
                     3 * win_n * patch * patch * hd * wd)
    common = dict(config=shape, route="cuda", library_ms=None)
    return [
        dict(name=f"matching_core{ROW_HALO}", kernel=f"matching_core{ROW_HALO}",
             source="stereo_tpu_torch/csrc/matching_core.cu",
             replaces="stereo_tpu/ops/pallas/kernels.py:210",
             max_abs_err=errs["matching_core"], integer_cases=cases,
             integer_cases_equal=mc_equal,
             **timings(lambda: matching_core(ld, rd, cfg,
                                             rows_prepadded=True)),
             plain_ms=cuda_ms(lambda: matching_core_plain(
                 ld, rd, cfg, rows_prepadded=True), 3),
             bound_ms=mc_bound[0], bound_by=mc_bound[1], **common),
        dict(name=f"sampled_window{ROW_HALO}",
             kernel=f"sampled_window{ROW_HALO}",
             source="stereo_tpu_torch/csrc/sampled_window.cu",
             replaces="stereo_tpu/ops/pallas/kernels.py:394",
             max_abs_err=errs["sampled_window"],
             **timings(lambda: sampled_window(lgs, rgs, disp, cfg,
                                              rows_prepadded=True)),
             plain_ms=cuda_ms(lambda: sampled_window_plain(
                 lgs, rgs, disp, cfg, rows_prepadded=True), 3),
             bound_ms=sw_bound[0], bound_by=sw_bound[1], **common)]


def phase_mesh_kernels(torch, dev, kitti, middlebury) -> dict:
    """``check_row_halo`` at the shards of the KITTI config (tile 2 and 4)
    and of the Middlebury one (tile 4)."""
    rng = np.random.default_rng(6)
    cases = {}
    for label, cfg, pair, tile in (
            ("kitti_tile2", kitti, kitti_pair(), 2),
            ("kitti_tile4", kitti, kitti_pair(), 4),
            ("middlebury_tile4", middlebury, middlebury_pair(), 4)):
        cases[label] = check_row_halo(torch, cfg, dev, rng, pair, tile, label)
    return cases


def real_pair(shape, seed: int, shift: int):
    """A seeded real-valued RGB pair (no value is an integer) and its roll
    by -``shift`` columns."""
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (3, *shape)).astype(np.float32)
    return left, np.roll(left, -shift, axis=-1)


def phase_mesh(torch, dev, kitti, middlebury):
    """``ShardedClassicalEngine`` through ``DepthEstimationPipeline``'s
    ``process_batch`` with the right views given, against the single-device
    engine on the same frames: KITTI on (1,4,1), (2,2,1) and (1,1,3) (33
    planes over 3 shards: the blockwise path), Middlebury on (1,4,1) and
    (1,2,5) (95 planes over 5).  Equal on the integer pairs; on the real
    pairs at least 99% of pixels within 0.5 px.  Returns the launch counts
    of the KITTI and of the Middlebury runs, and each mesh's ms/frame
    beside the single device's."""
    from stereo_tpu_torch.core.config import MeshConfig, PipelineConfig
    from stereo_tpu_torch.matching.classical import ClassicalStereoEngine
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.pipeline import DepthEstimationPipeline

    runs = (("kitti", kitti, kitti_pair(), ((1, 4, 1), (2, 2, 1), (1, 1, 3))),
            ("middlebury", middlebury, middlebury_pair(),
             ((1, 4, 1), (1, 2, 5))))
    counts = {"kitti": {k: 0 for k in LAUNCHES},
              "middlebury": {k: 0 for k in LAUNCHES}}
    numbers = {}
    for label, cfg, integer, meshes in runs:
        shape = (cfg.height, cfg.width)
        pairs = {"integer": integer, "real": real_pair(shape, 8, 20)}
        single = ClassicalStereoEngine(cfg, device=dev)
        for name, (left, right) in pairs.items():
            lefts = torch.from_numpy(np.stack([left, left[:, ::-1]])).to(dev)
            rights = torch.from_numpy(np.stack([right, right[:, ::-1]])
                                      ).to(dev)
            want = single.compute_disparity_maps(lefts, rights)
            single_ms = frame_ms(torch, lambda: single.compute_disparity_maps(
                lefts[:1], rights[:1]), 5)
            numbers[f"{label}/single/{name}"] = dict(
                ms_per_frame_median=statistics.median(single_ms))
            for mesh in meshes:
                mc = MeshConfig(*mesh)
                pipeline = DepthEstimationPipeline(
                    PipelineConfig(image_shape=shape,
                                   min_disparity=cfg.min_disparity,
                                   max_disparity=cfg.max_disparity,
                                   matching=cfg, mesh=mc), device=dev,
                    mesh_devices=virtual_mesh(torch, mc.num_devices))
                n = mc.data
                reset_launch_counts()
                got = pipeline.process_batch(lefts[:n], rights[:n])
                torch.cuda.synchronize()
                run_counts = dict(LAUNCHES)
                for k, v in run_counts.items():
                    counts[label][k] += v
                got = got.disparity_map
                diff = (got - want[:n]).abs()
                equal = bool(torch.equal(got, want[:n]))
                frac = float((diff <= 0.5).float().mean())
                engine = pipeline.stereo_matching.engine
                kernels = ("matching_core" + ROW_HALO,
                           "sampled_window" + ROW_HALO)
                require(all(run_counts[k] >= 1 for k in kernels)
                        == engine.use_kernels,
                        f"mesh {label} {mesh}: kernel path "
                        f"{engine.use_kernels}, launches {run_counts}")
                require(equal if name == "integer" else frac >= 0.99,
                        f"mesh {label} {mesh} {name}: {frac} within 0.5 "
                        f"px, max {float(diff.max())}")
                times = frame_ms(torch, lambda: pipeline.process_batch(
                    lefts[:n], rights[:n]), 3)
                numbers[f"{label}/{'x'.join(map(str, mesh))}/{name}"] = dict(
                    kernel_path=engine.use_kernels, equal=equal,
                    frac_within_0p5=frac, max_abs_diff=float(diff.max()),
                    ms_per_frame_median=statistics.median(times) / n,
                    launches=run_counts)
                del pipeline
        del single
        torch.cuda.empty_cache()
    return counts, numbers


# Grey levels within which the split single view's right views must stay of
# the single device's.  Deep3D's global branch runs its two Dense products
# in bf16, and on the card the libraries round the network's products in
# other places for other batch sizes and row counts; the bf16 rounding of
# the branch's inputs and outputs then moves the softmax volume.  With the
# committed weights the single device's own views of a frame move by more
# than 1e-3 between batch 1 and batch 4 (``batch_spread`` prints it), so
# the split is held at the tolerance the repo states for the bf16 global
# branch (tests/test_torch_synthesis.py).  A shard edge read wrong moves
# the views by whole grey levels.
SPLIT_VIEW_ATOL = 0.1


def batch_spread(single, frames, want) -> float:
    """The largest difference between the single device's right view of
    the first frame alone and the same view in the batch ``want``: how far
    the single device's own rounding moves with the batch size."""
    alone = single.process_batch(frames[:1]).right_image
    return float((alone - want.right_image[:1]).abs().max())


def phase_mesh_single_view(torch, dev, config, synthesis):
    """The single view of ``config`` on a (2,2,1) virtual mesh
    (``process_batch(left)`` dispatches to ``ShardedSingleViewEngine``:
    Deep3D split by rows over each group's tile pair, then the classical
    matcher per frame) against the single-device pipeline's
    ``process_batch`` of the same 4 frames.  The counted and compared call
    replays the split's CUDA graph (the call before it captured it), and
    must equal the split run eagerly bit for bit."""
    from stereo_tpu_torch.core.config import MeshConfig
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.pipeline import DepthEstimationPipeline

    shape = tuple(config.image_shape)
    frames = torch.stack(seeded_frames(torch, dev, shape, 9))
    single = DepthEstimationPipeline(config, synthesis=synthesis, device=dev)
    want = single.process_batch(frames)
    mc = MeshConfig(data=2, tile=2, disp=1)
    pipeline = DepthEstimationPipeline(
        config.replace(mesh=mc), synthesis=synthesis, device=dev,
        mesh_devices=virtual_mesh(torch, mc.num_devices))
    engine = pipeline._sharded_single_view()
    require(engine.row_split and engine.graph_splits,
            f"(2,2,1) at {shape}: row_split {engine.row_split}, "
            f"graph_splits {engine.graph_splits}")
    engine.graph_splits = False
    eager = pipeline.process_batch(frames)
    engine.graph_splits = True
    pipeline.process_batch(frames)
    reset_launch_counts()
    got = pipeline.process_batch(frames)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    require(engine.graphs_captured >= 1,
            f"mesh single view captured {engine.graphs_captured} graphs")
    require(all(counts[k] >= 1 for k in CLASSICAL_KERNELS),
            f"mesh single view missed a kernel: {counts}")
    replay_equals_eager = bool(
        torch.equal(got.disparity_map, eager.disparity_map)
        and torch.equal(got.right_image, eager.right_image))
    require(replay_equals_eager,
            "mesh single view: the replayed split differs from the eager")
    require(tuple(got.disparity_map.shape) == (4, *shape)
            and tuple(got.right_image.shape) == (4, 3, *shape),
            f"mesh single view shapes {tuple(got.disparity_map.shape)}")
    diff = (got.disparity_map - want.disparity_map).abs()
    view_diff = float((got.right_image - want.right_image).abs().max())
    equal = bool(torch.equal(got.disparity_map, want.disparity_map))
    frac = float((diff <= 0.5).float().mean())
    # Bit-equal, or JAX's gate (tests/test_parallel_synthesis.py): Deep3D
    # runs each group's shard rows on the mesh and the batch of 4 on the
    # single device, and cuDNN may round those in other places.
    require(equal or (frac >= 0.99 and float(diff.mean()) < 0.1),
            f"mesh single view: {frac} within 0.5 px, mean "
            f"{float(diff.mean())}")
    spread = batch_spread(single, frames, want)
    require(view_diff <= SPLIT_VIEW_ATOL, f"mesh single view: right views "
            f"off by {view_diff} (the single device's batch spread {spread})")
    times = frame_ms(torch, lambda: pipeline.process_batch(frames), 3)
    single_times = frame_ms(torch, lambda: single.process_batch(frames), 3)
    return counts, dict(equal=equal, frac_within_0p5=frac,
                        mean_abs_diff=float(diff.mean()),
                        max_abs_diff=float(diff.max()),
                        right_view_max_abs_diff=view_diff,
                        single_batch_spread=spread, launches=counts,
                        graphs_captured=engine.graphs_captured,
                        replay_equals_eager=replay_equals_eager,
                        ms_per_frame_median=statistics.median(times) / 4,
                        single_ms_per_frame_median=statistics.median(
                            single_times) / 4)


def phase_mesh_dnn(torch, dev, config):
    """GwcNet (committed weights, float32) at ``config``'s shape on a
    (2,2,2) virtual mesh through the pipeline's ``process_batch`` with the
    right views given: each group's frame split by rows over its 2 tile
    devices (``gwc_volume`` launched once per shard), against the
    single-device backend frame by frame (within 5e-3 px).  The counted
    and compared call replays the split's CUDA graph (the call before it
    captured it), and must equal the split run eagerly bit for bit."""
    from stereo_tpu_torch.core.config import MeshConfig
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                           DnnStereoMatchingBackend)

    shape = tuple(config.image_shape)
    left = torch.stack(seeded_frames(torch, dev, shape, 10))
    right = torch.roll(left, -7, dims=-1)
    mc = MeshConfig(data=2, tile=2, disp=2)
    pipeline = DepthEstimationPipeline(
        config.replace(stereo_matching_backend="gwcnet", mesh=mc), device=dev,
        mesh_devices=virtual_mesh(torch, mc.num_devices))
    engine = pipeline.stereo_matching.engine
    require(engine.row_split and engine.graph_splits,
            f"(2,2,2) at {shape}: row_split {engine.row_split}, "
            f"graph_splits {engine.graph_splits}")
    engine.graph_splits = False
    eager = pipeline.process_batch(left, right).disparity_map
    engine.graph_splits = True
    pipeline.process_batch(left, right)
    reset_launch_counts()
    got = pipeline.process_batch(left, right).disparity_map
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    require(engine.graphs_captured >= 1,
            f"mesh GwcNet captured {engine.graphs_captured} graphs")
    replay_equals_eager = bool(torch.equal(got, eager))
    require(replay_equals_eager,
            "mesh GwcNet: the replayed split differs from the eager")
    require(counts["gwc_volume"] == mc.tile * len(left),
            f"mesh GwcNet: {counts['gwc_volume']} gwc_volume launches for "
            f"{len(left)} frames at tile {mc.tile}")
    backend = engine.replicas[dev].model
    single = DnnStereoMatchingBackend("gwcnet", shape,
                                      max_disparity=backend.max_disparity,
                                      device=dev)
    want = torch.stack([single.process(l, r) for l, r in zip(left, right)])
    diff = float((got - want).abs().max())
    require(diff <= 5e-3, f"mesh GwcNet off by {diff} px")
    times = frame_ms(torch, lambda: pipeline.process_batch(left, right), 3)
    single_times = frame_ms(torch, lambda: single.process_batch(left, right),
                            3)
    return counts, dict(weights=pipeline.stereo_matching.weights,
                        row_split=engine.row_split,
                        halo_rounds_per_forward=engine.halo["rounds"],
                        halo_bytes_per_frame=engine.halo["bytes"] / len(left),
                        max_abs_diff=diff, equal=bool(torch.equal(got, want)),
                        graphs_captured=engine.graphs_captured,
                        replay_equals_eager=replay_equals_eager,
                        launches=counts,
                        ms_per_frame_median=statistics.median(times) / 4,
                        single_batch_ms_per_frame_median=statistics.median(
                            single_times) / 4)


# The row split's networks: each at disparity 64 with its committed
# weights, GwcNet also in bf16.
ROW_SPLIT_NETS = (("gwcnet", "float32"), ("gwcnet", "bfloat16"),
                  ("msnet2d", "float32"), ("msnet3d", "float32"))


def peak_bytes(torch, fn) -> int:
    """``torch.cuda.max_memory_allocated()`` over one call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def brief_profile(torch, fn) -> dict:
    """``profile_calls`` over 2 calls, with the top 4 kernels."""
    numbers = profile_calls(torch, fn, 2)
    numbers["top"] = numbers["top"][:4]
    return numbers


def split_timings(torch, run, reps: int = 5) -> dict:
    """A split's ms per call (host clock, median of ``reps`` calls), its
    device ms per call (CUDA events after a spin, which see a replayed
    graph's kernels; an eager split's launches outlast the spin, and then
    its gaps count too) and the busy share, device over wall."""
    ms = statistics.median(frame_ms(torch, run, reps))
    device = frame_device_ms(torch, run)
    return dict(ms_per_frame_median=ms, device_ms_per_frame=device,
                busy_share=device / ms)


# The heights of ``mesh_dnn_rows``: KITTI's 384 rows (16 divide a shard's
# rows at tile 2 and 4: every level splits) and 368 (16 x 23, the old rule
# dealt whole frames there): 184 rows a shard at tile 2, whose hourglasses
# gather ahead of their second stride, and 92 at tile 4, ahead of their
# first.
ROW_SPLIT_HEIGHTS = (384, 368)


def phase_mesh_dnn_rows(torch, dev, config):
    """Each of ``ROW_SPLIT_NETS`` at each of ``ROW_SPLIT_HEIGHTS`` x
    ``config``'s width on virtual meshes (1,4,1) and (1,2,1), one frame
    (the synthetic KITTI pair, cropped to the height) through the
    pipeline's ``process_batch`` and ``process``: the frame's rows split
    over the tile devices, with a halo exchange at each row-mixing layer
    and a gather ahead of a stride that would split a row (``ops.rows``),
    run eagerly (the shard threads launching), replayed from the split's
    CUDA graph (``ShardThreads.replay``) and, for the record, dealt whole
    (``row_split = False``).  The replay must equal the eager split bit
    for bit, each must be within 5e-3 px of the single-device backend,
    and GwcNet must launch ``gwc_volume`` ``tile`` times in a replay
    (once per shard).  Returns the launch counts of the replays summed
    over the cases, the numbers (row_split, the gathers ahead of a
    stride, graphs captured, launches per replay, halo exchanges and bytes
    per frame, ms/frame, device ms and busy share of the replayed, eager
    and dealt runs, a profile of the first two and peak memory beside the
    single device's) and the cases that failed a gate, so that every
    case is reported before the phase fails."""
    from stereo_tpu_torch.core.config import MeshConfig
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                           DnnStereoMatchingBackend)

    width = config.image_shape[1]
    pair = [torch.from_numpy(x).to(dev)[None] for x in kitti_pair()]
    totals = {k: 0 for k in LAUNCHES}
    cases, failed = [], []
    for height in ROW_SPLIT_HEIGHTS:
        left, right = (x[..., :height, :].contiguous() for x in pair)
        shape = (height, width)
        for name, dtype in ROW_SPLIT_NETS:
            single = DnnStereoMatchingBackend(name, shape, max_disparity=64,
                                              compute_dtype=dtype, device=dev)
            want = single.process_batch(left, right)
            single_ms = frame_ms(torch, lambda: single.process_batch(
                left, right), 5)
            single_profile = brief_profile(torch, lambda: single.process_batch(
                left, right))
            single_peak = peak_bytes(torch,
                                     lambda: single.process_batch(left, right))
            for tile in (4, 2):
                mc = MeshConfig(tile=tile)
                pipeline = DepthEstimationPipeline(
                    config.replace(image_shape=shape,
                                   stereo_matching_backend=name,
                                   compute_dtype=dtype, max_disparity=64,
                                   mesh=mc),
                    device=dev, mesh_devices=virtual_mesh(torch, tile))
                engine = pipeline.stereo_matching.engine

                def run():
                    return pipeline.process_batch(left, right).disparity_map

                # Dealt: the whole frame on the group's first device.
                engine.row_split = False
                dealt = run()
                dealt_numbers = split_timings(torch, run)
                engine.row_split = True
                # Eager: every shard thread launches its network.
                engine.graph_splits = False
                reset_launch_counts()
                eager = run()
                torch.cuda.synchronize()
                eager_counts = dict(LAUNCHES)
                eager_numbers = split_timings(torch, run)
                eager_profile = brief_profile(torch, run)
                # Replayed: the first call runs eagerly and captures the
                # split; the counted call replays it.
                engine.graph_splits = True
                run()
                reset_launch_counts()
                got = run()
                torch.cuda.synchronize()
                counts = dict(LAUNCHES)
                for k, v in counts.items():
                    totals[k] += v
                one = pipeline.process(left[0], right[0]).disparity_map
                diff = float((got - want).abs().max())
                diff_one = float((one - want[0]).abs().max())
                gwc_wanted = tile if name == "gwcnet" else 0
                case = dict(
                    network=name, dtype=dtype, shape=list(shape),
                    mesh=[1, tile, 1], weights=engine.weights,
                    row_split=engine.row_split,
                    graph_splits=engine.graph_splits,
                    graphs_captured=engine.graphs_captured,
                    launches_per_replay=counts,
                    replay_equals_eager=bool(torch.equal(got, eager)),
                    gwc_volume_launches=counts["gwc_volume"],
                    eager_launches=eager_counts,
                    halo_rounds_per_frame=engine.halo["rounds"],
                    gather_rounds_per_frame=engine.halo["gather_rounds"],
                    halo_bytes_per_frame=engine.halo["bytes"],
                    max_abs_diff=diff, mean_abs_diff=float(
                        (got - want).abs().mean()),
                    equal=bool(torch.equal(got, want)),
                    process_max_abs_diff=diff_one,
                    finite=bool(torch.isfinite(got).all()),
                    **split_timings(torch, run),
                    profile=brief_profile(torch, run),
                    eager=dict(eager_numbers, profile=eager_profile),
                    dealt=dict(dealt_numbers, max_abs_diff=float(
                        (dealt - want).abs().max())),
                    single_ms_per_frame_median=statistics.median(single_ms),
                    single_profile=single_profile,
                    max_memory_allocated_bytes=peak_bytes(torch, run),
                    single_max_memory_allocated_bytes=single_peak)
                if not (case["row_split"] and case["finite"]
                        and diff <= 5e-3 and diff_one <= 5e-3
                        and case["replay_equals_eager"]
                        and engine.graphs_captured >= 1
                        and counts["gwc_volume"] == gwc_wanted):
                    failed.append(f"{name} {dtype} {height}x{width} "
                                  f"(1,{tile},1)")
                cases.append(case)
                del pipeline, engine
            del single
            torch.cuda.empty_cache()
    return totals, dict(mesh="virtual: cuda:0 named n times", cases=cases), \
        failed


# Deep3D's rows split over the tile devices of these meshes, batch 4: at
# tile 8 a shard holds 12 of the 96 down rows and gathers before
# VggBlock_2's pool.
SINGLE_VIEW_ROW_MESHES = ((1, 2, 1), (1, 4, 1), (2, 2, 1), (1, 8, 1))


def phase_mesh_single_view_rows(torch, dev, config, synthesis):
    """The single view of ``config`` (Deep3D at 96x320) on the virtual
    meshes of ``SINGLE_VIEW_ROW_MESHES``, 4 frames through the pipeline's
    ``process_batch(left)``: ``ShardedSingleViewEngine`` splits each
    group's frames by rows over its tile devices (``row_split``), each
    shard running Deep3D and ``upsample_blend`` on its rows, then the
    matcher per frame.  The split runs eagerly and replayed from its CUDA
    graph; the replay must equal the eager run bit for bit, launch
    ``upsample_blend`` once per shard (on its group's batch), give the
    single device's disparities or disparities within JAX's gate
    (tests/test_parallel_synthesis.py) and right views within
    ``SPLIT_VIEW_ATOL`` grey levels of the single device's.  Beside each:
    the ms/frame of the
    split (with its device ms and busy share), of the same engine dealing
    whole frames and of the single device.  Returns the launch counts of
    the replays, the numbers and the cases that failed a gate."""
    from stereo_tpu_torch.core.config import MeshConfig
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.pipeline import DepthEstimationPipeline

    shape = tuple(config.image_shape)
    frames = torch.stack(seeded_frames(torch, dev, shape, 11))
    n = len(frames)
    single = DepthEstimationPipeline(config, synthesis=synthesis, device=dev)
    want = single.process_batch(frames)
    single_ms = statistics.median(frame_ms(
        torch, lambda: single.process_batch(frames), 5)) / n
    single_device_ms = frame_device_ms(
        torch, lambda: single.process_batch(frames)) / n
    spread = batch_spread(single, frames, want)
    totals = {k: 0 for k in LAUNCHES}
    cases, failed = [], []
    for mesh in SINGLE_VIEW_ROW_MESHES:
        mc = MeshConfig(*mesh)
        pipeline = DepthEstimationPipeline(
            config.replace(mesh=mc), synthesis=synthesis, device=dev,
            mesh_devices=virtual_mesh(torch, mc.num_devices))
        engine = pipeline._sharded_single_view()

        def run():
            return pipeline.process_batch(frames)

        engine.graph_splits = False
        eager = run()
        eager_ms = statistics.median(frame_ms(torch, run, 3)) / n
        engine.graph_splits = True
        run()
        reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        for k, v in counts.items():
            totals[k] += v
        timed = split_timings(torch, run)
        engine.row_split = False            # whole frames dealt
        dealt_ms = statistics.median(frame_ms(torch, run, 3)) / n
        engine.row_split = True
        diff = (got.disparity_map - want.disparity_map).abs()
        equal = bool(torch.equal(got.disparity_map, want.disparity_map))
        frac = float((diff <= 0.5).float().mean())
        case = dict(
            mesh=list(mesh), row_split=engine.row_split,
            graphs_captured=engine.graphs_captured,
            launches_per_replay=counts,
            upsample_blend_launches=counts["upsample_blend"],
            replay_equals_eager=bool(
                torch.equal(got.disparity_map, eager.disparity_map)
                and torch.equal(got.right_image, eager.right_image)),
            halo_rounds_per_forward=engine.halo["rounds"],
            halo_bytes_per_frame=engine.halo["bytes"] / n,
            equal=equal, frac_within_0p5=frac,
            mean_abs_diff=float(diff.mean()),
            max_abs_diff=float(diff.max()),
            right_view_max_abs_diff=float(
                (got.right_image - want.right_image).abs().max()),
            finite=bool(torch.isfinite(got.right_image).all()),
            ms_per_frame_median=timed["ms_per_frame_median"] / n,
            device_ms_per_frame=timed["device_ms_per_frame"] / n,
            busy_share=timed["busy_share"],
            eager_ms_per_frame_median=eager_ms,
            dealt_ms_per_frame_median=dealt_ms,
            single_ms_per_frame_median=single_ms,
            single_device_ms_per_frame=single_device_ms)
        if not (case["row_split"] and case["finite"]
                and case["replay_equals_eager"]
                and engine.graphs_captured >= 1
                and counts["upsample_blend"] == mc.num_devices
                and case["right_view_max_abs_diff"] <= SPLIT_VIEW_ATOL
                and all(counts[k] >= n for k in ("matching_core",
                                                 "sampled_window"))
                and (equal or (frac >= 0.99
                               and case["mean_abs_diff"] < 0.1))):
            failed.append(f"single view {mesh}")
        cases.append(case)
        del pipeline, engine
        torch.cuda.empty_cache()
    return totals, dict(mesh="virtual: cuda:0 named n times", batch=n,
                        single_batch_spread=spread, cases=cases), failed


# (1,8,1): 12 of the 96 down rows a shard, gathered before VggBlock_2's
# pool, the levels below whole on every shard.
MESH_TRAIN_MESHES = ((2, 1, 1), (1, 2, 1), (2, 2, 1), (1, 4, 1), (1, 8, 1))
MESH_TRAIN_STEPS = 3
# The gates of ``mesh_train``'s gaps, sharded against single-device steps in
# float32 (TF32 off) on the card: the shards' convolutions round otherwise
# than the whole batch's, a pre-activation or a pooling window within that
# rounding of a tie flips its ReLU or its max, and a gradient near 0 may
# flip its first Adam update (about lr * sign): so the gates are on the
# loss's relative gap and the gradients' relative gap in global norm; the
# largest gap in one array, relative to that array's largest entry, is
# printed beside them.
MESH_TRAIN_LOSS_RTOL = 1e-4
MESH_TRAIN_GRAD_NORM_RTOL = 1e-2


# The allocator's counters printed by ``memory_line``.
MEMORY_STATS = ("reserved_bytes.all.current", "allocated_bytes.all.current",
                "active_bytes.all.current",
                "inactive_split_bytes.all.current", "segment.all.current")


def port_frame(block: dict) -> Optional[str]:
    """The innermost frame of the repo's code in a block's allocation
    stack (recorded under ``--memory-history``), as ``file:line name``."""
    for frame in block.get("frames") or ():
        name = frame.get("filename", "")
        if name.startswith(ROOT) and "/torch/" not in name:
            return (f"{os.path.relpath(name, ROOT)}:{frame.get('line')} "
                    f"{frame.get('name')}")
    return None


def memory_line(torch, after: str, top: int = 40) -> None:
    """One line on what holds the card after ``after``: the allocator's
    ``MEMORY_STATS``; from ``torch.cuda.memory_snapshot()`` the bytes of
    every segment by memory pool ((0, 0) the default one, others a CUDA
    graph's) and by stream, and the segments that still hold a live block
    (the largest ``top`` of them: stream, size, pool, the live blocks'
    sizes and, where the allocations were recorded, the frame of the repo
    that made each), with their bytes by pool.  A graph's pool keeps its
    segments, live block or not, while the graph lives."""
    stats = torch.cuda.memory_stats()
    pinned, by_pool, reserved, by_stream = [], {}, {}, {}
    for seg in torch.cuda.memory_snapshot():
        pool = str(tuple(seg.get("segment_pool_id", ())))
        reserved[pool] = reserved.get(pool, 0) + seg["total_size"]
        by_stream[seg["stream"]] = (by_stream.get(seg["stream"], 0)
                                    + seg["total_size"])
        live = [b for b in seg["blocks"] if b["state"].startswith("active")]
        if not live:
            continue
        by_pool[pool] = by_pool.get(pool, 0) + seg["total_size"]
        pinned.append(dict(
            stream=seg["stream"], size=seg["total_size"], pool=pool,
            live=[b["size"] for b in live],
            frames=sorted({port_frame(b) or "?" for b in live})))
    pinned.sort(key=lambda seg: -seg["size"])
    print(json.dumps({"phase": "memory", "after": after,
                      **{k: stats.get(k, 0) for k in MEMORY_STATS},
                      "reserved_bytes_by_pool": reserved,
                      "reserved_bytes_by_stream": by_stream,
                      "pinned_segments": len(pinned),
                      "pinned_bytes_by_pool": by_pool,
                      "largest_pinned": pinned[:top]}), flush=True)


def clear_cublas_workspaces(torch) -> None:
    """Free cuBLAS's workspaces (one per handle and stream, made on the
    first cuBLAS call of each and kept by PyTorch), then the cache: for
    the last ``memory`` line, which tells the segments they pin apart."""
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()


def free_card(torch) -> None:
    """Collect unreachable objects, then return the cached blocks to the
    card: a training step can outlive its last reference in a reference
    cycle (one through the optimizer's constructor frame), and its
    weights, Adam state and gradients with it."""
    gc.collect()
    torch.cuda.empty_cache()


def train_batch(torch, dev, config):
    """A batch of the fixture drive at Deep3D's 384x1280 / 96x320 on
    ``dev``, as ``phase_train_deep3d`` takes it."""
    from stereo_tpu_torch.train import KittiStereoDataset
    from stereo_tpu_torch.train.kitti_dataset import batch_iterator
    from stereo_tpu_torch.train.trainer import to_device

    dataset = KittiStereoDataset([FIXTURE_DRIVE])
    return to_device(next(batch_iterator(dataset, config.batch_size,
                                         seed=0)), dev)


def deep3d_weights_of(synthesis) -> dict:
    """The smoke's Deep3D weights (``make_synthesis``'s) in float32, on
    the CPU."""
    return {k: v.detach().float().cpu()
            for k, v in synthesis.model.state_dict().items()}


def step_gaps(loss, grads, want_loss, want_grads) -> dict:
    """A sharded step's gaps to the single device's: the loss's relative
    gap, the gradients' relative gap in global norm, and the largest gap
    in one array relative to that array's largest entry."""
    num = sum(float(((grads[k] - want_grads[k]).double() ** 2).sum())
              for k in want_grads)
    den = sum(float((want_grads[k].double() ** 2).sum()) for k in want_grads)
    worst, key = max((float((grads[k] - want_grads[k]).abs().max())
                      / max(float(want_grads[k].abs().max()), 1e-30), k)
                     for k in want_grads)
    return dict(loss_rel=abs(loss - want_loss) / abs(want_loss),
                grad_norm_rel=(num / den) ** 0.5, grad_array_rel=worst,
                grad_array=key)


def phase_mesh_train(torch, dev, synthesis, deep3d_weights: str):
    """``ShardedTrainStep`` on each of ``MESH_TRAIN_MESHES`` (virtual
    meshes of cuda:0) against ``Trainer`` on the whole batch, float32:
    ``MESH_TRAIN_STEPS`` steps from the same weights, dropout off and then
    on from generator seed 0; the gaps of every step within
    ``MESH_TRAIN_LOSS_RTOL`` and ``MESH_TRAIN_GRAD_NORM_RTOL``, the
    replicas identical, and ms/step (median of 5, host clock), device ms
    and peak memory with dropout on beside the single device's.  The
    kernels' launch counts over the phase must all be 0."""
    from stereo_tpu_torch.core.config import MeshConfig, TrainerConfig
    from stereo_tpu_torch.models import Deep3D
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.parallel import make_mesh
    from stereo_tpu_torch.parallel.train import ShardedTrainStep
    from stereo_tpu_torch.train import Trainer

    config = TrainerConfig(batch_size=2, log_every=0)
    batch = train_batch(torch, dev, config)
    weights = deep3d_weights_of(synthesis)

    def fresh():
        model = Deep3D()
        model.load_state_dict(weights)
        return model.to(dev)

    def timed(step) -> dict:
        return dict(ms_per_step_median=statistics.median(
                        timed_steps(torch, step, 5)),
                    device_ms_per_step=frame_device_ms(torch, step, 5),
                    max_memory_allocated_bytes=peak_bytes(torch, step))

    reset_launch_counts()
    single, want = {}, {}
    for dropout in (False, True):
        trainer = Trainer(Deep3D(), config, state_dict=weights, device=dev,
                          dropout=dropout)
        trainer.generator.manual_seed(0)
        want[dropout] = []
        for _ in range(MESH_TRAIN_STEPS):
            loss = float(trainer.train_step(*batch))
            want[dropout].append((loss, {
                n: p.grad.detach().clone()
                for n, p in trainer.model.named_parameters()}))
        if dropout:
            single = timed(lambda: trainer.train_step(*batch))
        del trainer
    free_card(torch)

    meshes, failed = {}, []
    for shape in MESH_TRAIN_MESHES:
        mc = MeshConfig(*shape)
        mesh = make_mesh(mc, virtual_mesh(torch, mc.num_devices))
        case = {}
        for dropout in (False, True):
            step = ShardedTrainStep(fresh(), config, mesh, dropout=dropout,
                                    seed=0)
            gaps = []
            for want_loss, want_grads in want[dropout]:
                loss = float(step.step(*batch))
                gaps.append(step_gaps(loss, {
                    n: p.grad for n, p in step.model.named_parameters()},
                    want_loss, want_grads))
            arm = dict(
                loss_rel_max=max(g["loss_rel"] for g in gaps),
                grad_norm_rel_max=max(g["grad_norm_rel"] for g in gaps),
                grad_array_rel_max=max(g["grad_array_rel"] for g in gaps),
                steps=gaps, replicas=len(step.replicas),
                replicas_identical=step.replicas_identical(),
                row_split=step.layout.row_split,
                halo_rounds=step.halo and step.halo["rounds"],
                halo_back_rounds=step.halo and step.halo["back_rounds"])
            if dropout:
                arm.update(timed(lambda: step.step(*batch)))
            step.close()
            del step
            free_card(torch)
            if not (arm["loss_rel_max"] <= MESH_TRAIN_LOSS_RTOL
                    and arm["grad_norm_rel_max"] <= MESH_TRAIN_GRAD_NORM_RTOL
                    and arm["replicas_identical"]
                    and arm["row_split"] == (shape[1] > 1)):
                failed.append((shape, dropout))
            case["dropout" if dropout else "no_dropout"] = arm
        meshes["x".join(map(str, shape))] = case
    del want
    free_card(torch)
    counts = dict(LAUNCHES)
    require(all(v == 0 for v in counts.values()),
            f"mesh_train launched kernels: {counts}")
    require(not failed, f"mesh_train gaps or replicas off the gates at "
                        f"{failed}: {meshes}")
    return dict(weights=deep3d_weights, batch=config.batch_size, steps=MESH_TRAIN_STEPS,
                gates=dict(loss_rel=MESH_TRAIN_LOSS_RTOL,
                           grad_norm_rel=MESH_TRAIN_GRAD_NORM_RTOL),
                single_device=single, meshes=meshes, launches=counts)


# The mesh across processes: (label, engine, mesh, entries of cuda:0 each
# of the two ranks lists).  KITTI's kernel path with the ring across the
# ranks ((1,2,1): one entry each; (1,4,1): two each), the blockwise path
# with the argmax and the owned gather across them ((1,1,3): two entries
# on rank 0, one on rank 1), the single view and GwcNet with ``data``
# across the ranks and each tile pair split by rows within a rank, and
# (``*_rows_*``) row splits whose tile group spans the ranks: GwcNet and
# the single view on (1,2,1), one shard a rank, and the single view on
# (1,4,1), two shards a rank taking turns, the middle edge across.
MULTIPROCESS_CASES = (
    ("kitti_kernels_121", "classical", (1, 2, 1), (1, 1)),
    ("kitti_kernels_141", "classical", (1, 4, 1), (2, 2)),
    ("kitti_blockwise_113", "classical", (1, 1, 3), (2, 1)),
    ("single_view_221", "single_view", (2, 2, 1), (2, 2)),
    ("gwcnet_221", "gwcnet", (2, 2, 1), (2, 2)),
    ("gwcnet_rows_121", "gwcnet", (1, 2, 1), (1, 1)),
    ("single_view_rows_121", "single_view", (1, 2, 1), (1, 1)),
    ("single_view_rows_141", "single_view", (1, 4, 1), (2, 2)),
    ("gwcnet_rows_121_h368", "gwcnet", (1, 2, 1), (1, 1)),
)
# The cases at another height than KITTI's 384 rows: GwcNet's split across
# the ranks at 368 rows (184 a shard: the hourglasses gather across the
# ranks ahead of their second stride), which the old rule dealt whole.
MULTIPROCESS_HEIGHTS = {"gwcnet_rows_121_h368": 368}
MULTIPROCESS_RANKS = 2
# Deep3D's training step in ``multiprocess``: ``data`` across the two
# ranks, one entry each.
MULTIPROCESS_TRAIN_MESH = (2, 1, 1)
# And (label, mesh, entries each rank lists) of training steps whose tile
# group spans the two ranks: (1,2,1) one shard a rank; (1,4,1) two shards
# a rank, the middle edge across and the gathered levels' gradients sent
# to every shard's rank; (1,8,1) four shards a rank, 12 down rows a shard,
# gathered before VggBlock_2's pool.
MULTIPROCESS_TRAIN_ROWS = (("train_rows_121", (1, 2, 1), (1, 1)),
                           ("train_rows_141", (1, 4, 1), (2, 2)),
                           ("train_rows_181", (1, 8, 1), (4, 4)))
MULTIPROCESS_TRAIN_STEPS = 2


def multiprocess_train_cases():
    """(label, mesh, entries each rank lists) of every training case of
    phase ``multiprocess``."""
    label = "train_" + "".join(map(str, MULTIPROCESS_TRAIN_MESH))
    return ((label, MULTIPROCESS_TRAIN_MESH, (1, 1)),
            *MULTIPROCESS_TRAIN_ROWS)


def multiprocess_train(torch, dev, synthesis, mesh) -> dict:
    """``ShardedTrainStep`` on ``mesh`` (a case of
    ``multiprocess_train_cases``, across the ranks or in one process)
    from the smoke's Deep3D weights on the fixture batch, dropout on: each
    step's loss, a SHA-256 of the weights and Adam state afterwards (their
    bytes in parameter order), whether this process's replicas are
    identical, ms/step (host clock, each step's median), the peak memory
    allocated, the bytes staged through the host per step, whether the
    step split rows and what the split exchanged in the last step
    (``ShardedTrainStep.halo``).  The
    steps run under ``torch.use_deterministic_algorithms`` (cuDNN's
    deterministic algorithms; ``CUBLAS_WORKSPACE_CONFIG`` is set where the
    rank starts): a shard's backward then gives the same bits in every
    process, so the ranks' result can equal one process's.  Any
    operation it flags as nondeterministic is listed."""
    import hashlib
    import warnings

    from stereo_tpu_torch.core.config import TrainerConfig
    from stereo_tpu_torch.models import Deep3D
    from stereo_tpu_torch.parallel.train import ShardedTrainStep

    config = TrainerConfig(batch_size=2, log_every=0)
    batch = train_batch(torch, dev, config)
    model = Deep3D()
    model.load_state_dict(deep3d_weights_of(synthesis))
    step = ShardedTrainStep(model.to(dev), config, mesh, dropout=True,
                            seed=0)
    staged = mesh.transport.staged_bytes if mesh.transport else 0
    losses = []
    torch.cuda.reset_peak_memory_stats(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            times = timed_steps(torch, lambda: losses.append(
                step.step(*batch)) or losses[-1], MULTIPROCESS_TRAIN_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
    staged = (mesh.transport.staged_bytes if mesh.transport else 0) - staged
    replica = next(iter(step.replicas))
    digest = hashlib.sha256()
    for p in step.replicas[replica].parameters():
        for t in [p.detach()] + list(
                step.optimizers[replica].state[p].values()):
            digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    numbers = dict(losses=torch.stack(losses).cpu(),
                   digest=digest.hexdigest(), replicas=len(step.replicas),
                   replicas_identical=step.replicas_identical(),
                   ms_per_step=times,
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                       dev),
                   staged_bytes_per_step=staged / MULTIPROCESS_TRAIN_STEPS,
                   row_split=step.layout.row_split, halo=step.halo,
                   nondeterministic=sorted({
                       str(w.message)[:200] for w in caught
                       if "deterministic" in str(w.message)}))
    step.close()
    return numbers


def multiprocess_case(torch, kind, mc, mesh, synthesis, dev, height=384):
    """The engine of one case on ``mesh`` and its inputs at 384x1280 (a
    network's at ``height`` x 1280): a call returning its outputs as a
    tuple, the frames per call, the path taken (the kernel path or the
    row split) and the engine."""
    from stereo_tpu_torch.core.config import PipelineConfig
    from stereo_tpu_torch.parallel import (ShardedClassicalEngine,
                                           ShardedDnnEngine,
                                           ShardedSingleViewEngine)

    cfg = PipelineConfig().matching_config()
    if kind == "classical":
        engine = ShardedClassicalEngine(cfg, mc, mesh=mesh)
        left, right = (torch.from_numpy(np.stack([x] * mc.data)).to(dev)
                       for x in kitti_pair())
        return (lambda: (engine.compute_disparity_maps(left, right),),
                mc.data, engine.use_kernels, engine)
    n = 2 * mc.data * mc.disp
    left = torch.stack(seeded_frames(torch, dev, (384, 1280), 9, n))
    if kind == "single_view":
        engine = ShardedSingleViewEngine(cfg, mc, mesh=mesh,
                                         synthesis=synthesis)
        return (lambda: engine.process_batch(left, return_right=True), n,
                engine.row_split, engine)
    left = left[..., :height, :].contiguous()
    engine = ShardedDnnEngine("gwcnet", (height, 1280), mc, mesh=mesh,
                              max_disparity=64)
    right = torch.roll(left, -7, dims=-1)
    return (lambda: (engine.process_batch(left, right),), n,
            engine.row_split, engine)


def multiprocess_rank(rank: int, world: int, init: str, out: str) -> None:
    """One rank of phase ``multiprocess``: every case of
    ``MULTIPROCESS_CASES`` across the gloo group on cuda:0 (a warm-up
    call, the counted call, five timed ones) and every training case of
    ``multiprocess_train_cases``, its outputs saved to
    ``out/rank{rank}.pt``; then rank 0 runs each case's mesh in this
    process alone, saved to ``out/one_process.pt``.  A failure writes
    ``out/rank{rank}.err`` and exits 1."""
    import traceback

    try:
        sys.path.insert(0, ROOT)
        # cuBLAS's deterministic workspace, for the training case: set
        # before the first cuBLAS call.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        import torch
        import torch.distributed as dist
        from stereo_tpu_torch.core.config import MeshConfig
        from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
        from stereo_tpu_torch.parallel import (initialize_distributed,
                                               make_mesh)
        from stereo_tpu_torch.parallel.mesh import Mesh

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        initialize_distributed(init, world, rank, backend="gloo")
        synthesis, weights = make_synthesis(dev)

        def timed(run, n, sync):
            times = []
            for _ in range(5):
                sync()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times) / n

        maps, numbers = {}, {}
        for label, kind, shape, entries in MULTIPROCESS_CASES:
            mc = MeshConfig(*shape)
            mesh = make_mesh(mc, [dev] * entries[rank])
            run, n, path, engine = multiprocess_case(
                torch, kind, mc, mesh, synthesis, dev,
                MULTIPROCESS_HEIGHTS.get(label, 384))
            run()       # a row split captures its CUDA graph here
            dist.barrier()
            torch.cuda.synchronize()
            reset_launch_counts()
            staged = mesh.transport.staged_bytes
            got = run()
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            staged = mesh.transport.staged_bytes - staged
            maps[label] = [x.cpu() for x in got]
            numbers[label] = dict(
                path=path, ms_per_frame_median=timed(run, n, dist.barrier),
                staged_bytes_per_frame=staged / n, launches=counts,
                halo=getattr(engine, "halo", None),
                entries=int(sum(mesh.is_local(i)
                                for i in np.ndindex(*shape))))
            del run, mesh, engine
            torch.cuda.empty_cache()
        train = {}
        for label, shape, entries in multiprocess_train_cases():
            mesh = make_mesh(MeshConfig(*shape), [dev] * entries[rank])
            dist.barrier()
            train[label] = multiprocess_train(torch, dev, synthesis, mesh)
            del mesh
            free_card(torch)
        torch.save(dict(maps=maps, numbers=numbers, weights=weights,
                        backend=dist.get_backend(), train=train),
                   os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            maps, numbers, halos = {}, {}, {}
            for label, kind, shape, _ in MULTIPROCESS_CASES:
                mc = MeshConfig(*shape)
                grid = np.empty(mc.num_devices, dtype=object)
                grid[:] = [dev] * mc.num_devices
                run, n, _, engine = multiprocess_case(
                    torch, kind, mc, Mesh(grid.reshape(shape)), synthesis,
                    dev, MULTIPROCESS_HEIGHTS.get(label, 384))
                run()
                maps[label] = [x.cpu() for x in run()]
                halos[label] = getattr(engine, "halo", None)
                numbers[label] = timed(run, n, lambda: None)
                del run, engine
                torch.cuda.empty_cache()
            train = {}
            for label, shape, _ in multiprocess_train_cases():
                grid = np.empty(int(np.prod(shape)), dtype=object)
                grid[:] = [dev] * grid.size
                train[label] = multiprocess_train(torch, dev, synthesis,
                                                  Mesh(grid.reshape(shape)))
                free_card(torch)
            torch.save(dict(maps=maps, ms_per_frame_median=numbers,
                            halo=halos, train=train),
                       os.path.join(out, "one_process.pt"))
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def phase_multiprocess(torch, tmp: str):
    """The mesh across processes: ``MULTIPROCESS_RANKS`` ranks spawned on
    cuda:0 (``parallel.transport.spawn_ranks``), a gloo group on a file
    store, each rank listing its entries of cuda:0 (``make_mesh``'s global
    mesh); each case of ``MULTIPROCESS_CASES`` on every rank equal bit for
    bit to the same mesh in one process, ms/frame (median of 5) of both,
    the bytes staged through the host per frame, and the ranks' launches
    summed (the classical kernel path in its row-halo mode); for a row
    split, each rank's halo rounds, and the rounds, bytes and host seconds
    that crossed ranks per forward.  A split whose tile group spans the
    ranks must split rows, launch ``gwc_volume`` or ``upsample_blend``
    once per shard and the matcher at least once a frame, and exchange as
    often as one process, every time across.  Deep3D's training step on
    each mesh of ``multiprocess_train_cases`` (``data`` across the ranks,
    or a tile group across them) gives every rank the losses, weights and
    Adam state of one process bit for bit, every replica identical; a
    tile group across the ranks splits rows and crosses ranks in every
    round of the forward and of the backward; ms/step of each rank beside
    one process, the bytes staged per step, and the cross-rank rounds,
    bytes and host seconds of forward and backward.  The ranks are joined
    within a time limit; a failed or hung rank fails the phase."""
    from stereo_tpu_torch.parallel.transport import spawn_ranks

    os.makedirs(tmp)
    # What this process leaves the ranks on the card.
    free_card(torch)
    free_bytes = torch.cuda.mem_get_info()[0]
    codes = spawn_ranks(multiprocess_rank, MULTIPROCESS_RANKS,
                        os.path.join(tmp, "store"), args=(tmp,),
                        timeout_s=480)
    errors = {name: open(os.path.join(tmp, name)).read()[-3000:]
              for name in os.listdir(tmp) if name.endswith(".err")}
    require(codes == [0] * MULTIPROCESS_RANKS,
            f"multiprocess ranks exited {codes}: {errors}")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                        weights_only=False)
             for r in range(MULTIPROCESS_RANKS)]
    one = torch.load(os.path.join(tmp, "one_process.pt"), weights_only=False)
    counts = {k: sum(r["numbers"][label]["launches"][k] for r in ranks
                     for label, *_ in MULTIPROCESS_CASES)
              for k in ranks[0]["numbers"][MULTIPROCESS_CASES[0][0]][
                  "launches"]}
    cases = {}
    for label, kind, shape, _ in MULTIPROCESS_CASES:
        want = one["maps"][label]
        equal = all(len(r["maps"][label]) == len(want) and all(
            torch.equal(a, b) for a, b in zip(r["maps"][label], want))
            for r in ranks)
        launches = {k: sum(r["numbers"][label]["launches"][k]
                           for r in ranks) for k in counts}
        path = ranks[0]["numbers"][label]["path"]
        needed = {"classical": ("matching_core" + ROW_HALO,
                                "sampled_window" + ROW_HALO) if path else (),
                  "single_view": CLASSICAL_KERNELS,
                  "gwcnet": ("gwc_volume",)}[kind]
        require(equal, f"multiprocess {label}: differs from one process")
        require(all(launches[k] >= 1 for k in needed),
                f"multiprocess {label}: launches {launches}")
        shards = shape[0] * shape[1] * shape[2]
        if kind == "gwcnet":
            # One launch per shard on its group's frames: tile x groups.
            require(launches["gwc_volume"] == shards,
                    f"multiprocess {label}: gwc_volume launches "
                    f"{launches['gwc_volume']}")
        halos = [r["numbers"][label]["halo"] for r in ranks]
        if "_rows_" in label:
            # A tile group across the ranks: split, not dealt; one blend
            # per shard; the matcher on every frame, on the rank it is
            # dealt to; each rank exchanges as often as one process does,
            # every exchange across the ranks.
            frames = 2 * shape[0] * shape[2]
            require(path, f"multiprocess {label}: no row split")
            if kind == "single_view":
                require(launches["upsample_blend"] == shards,
                        f"multiprocess {label}: upsample_blend launches "
                        f"{launches['upsample_blend']}")
                require(all(launches[k] >= frames for k in
                            ("matching_core", "sampled_window")),
                        f"multiprocess {label}: matcher launches "
                        f"{launches}")
            rounds = one["halo"][label]["rounds"]
            require(all(h is not None and h["rounds"] == h["cross_rounds"]
                        == rounds for h in halos),
                    f"multiprocess {label}: halo {halos}, one process "
                    f"{rounds} rounds")
        cases[label] = dict(
            mesh=shape, equal=equal, kernel_path_or_row_split=path,
            entries_per_rank=[r["numbers"][label]["entries"] for r in ranks],
            ms_per_frame_median=[r["numbers"][label]["ms_per_frame_median"]
                                 for r in ranks],
            one_process_ms_per_frame_median=one["ms_per_frame_median"][label],
            staged_bytes_per_frame=[
                r["numbers"][label]["staged_bytes_per_frame"] for r in ranks],
            launches=launches)
        if halos[0] is not None:
            cases[label].update(
                halo_rounds_per_forward=[h["rounds"] for h in halos],
                cross_rank_rounds_per_forward=[h["cross_rounds"]
                                               for h in halos],
                cross_rank_bytes_per_forward=[h["cross_bytes"]
                                              for h in halos],
                cross_rank_seconds_per_forward=[h["cross_seconds"]
                                                for h in halos],
                one_process_halo_rounds=one["halo"][label]["rounds"])
    # Deep3D's training step with data, or a tile group, across the ranks:
    # every rank's losses, weights and Adam state those of one process, bit
    # for bit; a tile group across the ranks splits rows, and each rank
    # crosses ranks in every round of the forward and of the backward.
    for label, shape, _ in multiprocess_train_cases():
        want = one["train"][label]
        trained = [r["train"][label] for r in ranks]
        equal = all(torch.equal(t["losses"], want["losses"])
                    and t["digest"] == want["digest"] for t in trained)
        require(equal and want["replicas_identical"]
                and all(t["replicas_identical"] for t in trained)
                and bool(torch.isfinite(want["losses"]).all()),
                f"multiprocess {label}: ranks {trained}, one process {want}")
        cases[label] = dict(
            mesh=shape, equal=equal, losses=want["losses"].tolist(),
            ms_per_step=[t["ms_per_step"] for t in trained],
            one_process_ms_per_step=want["ms_per_step"],
            max_memory_allocated_bytes=[t["max_memory_allocated_bytes"]
                                        for t in trained],
            staged_bytes_per_step=[t["staged_bytes_per_step"]
                                   for t in trained],
            replicas_per_rank=[t["replicas"] for t in trained],
            flagged_nondeterministic=want["nondeterministic"])
        if shape[1] == 1:
            continue
        halos = [t["halo"] for t in trained]
        rounds = want["halo"]["rounds"]
        require(want["row_split"] and all(t["row_split"] for t in trained)
                and all(h["rounds"] == h["cross_rounds"] == h["back_rounds"]
                        == h["back_cross_rounds"] == rounds > 0
                        for h in halos),
                f"multiprocess {label}: row split {want['row_split']}, "
                f"halo {halos}, one process {want['halo']}")
        cases[label].update(
            halo_rounds_per_step=rounds,
            cross_rank_rounds_forward=[h["cross_rounds"] for h in halos],
            cross_rank_rounds_backward=[h["back_cross_rounds"]
                                        for h in halos],
            cross_rank_seconds_forward=[h["cross_seconds"] for h in halos],
            cross_rank_seconds_backward=[h["back_cross_seconds"]
                                         for h in halos],
            cross_rank_bytes_forward=[h["cross_bytes"] for h in halos],
            cross_rank_bytes_backward=[h["back_cross_bytes"]
                                       for h in halos])
    return counts, dict(backend=ranks[0]["backend"],
                        ranks=MULTIPROCESS_RANKS,
                        free_bytes_at_spawn=free_bytes,
                        deep3d_weights=ranks[0]["weights"], cases=cases)


def phase_mesh_server(torch, dev, config, synthesis):
    """A server on a classical (2,1,1) virtual-mesh pipeline of ``config``,
    micro-batch 2, answers PNG uploads (``phase_server``), and
    ``check_devices`` over the mesh's devices is healthy."""
    from stereo_tpu_torch.core.config import MeshConfig
    from stereo_tpu_torch.parallel.health import check_devices
    from stereo_tpu_torch.pipeline import DepthEstimationPipeline

    mc = MeshConfig(data=2)
    pipeline = DepthEstimationPipeline(
        config.replace(mesh=mc), synthesis=synthesis, device=dev,
        mesh_devices=virtual_mesh(torch, mc.num_devices))
    counts, numbers = phase_server(torch, pipeline, dev, CLASSICAL_KERNELS)
    report = check_devices(timeout_s=60, devices=list(pipeline.mesh.devices.flat))
    require(report.healthy, f"mesh health: {report}")
    return counts, dict(numbers, health=dict(
        healthy=report.healthy, latency_s=report.latency_s,
        num_devices=report.num_devices))


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stereo_tpu_torch.core.config import MatchingConfig, PipelineConfig
    from stereo_tpu_torch.matching.classical import ClassicalStereoEngine
    from stereo_tpu_torch.ops.cuda import build

    t = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    report("device", t, name=name, count=count, nvidia_smi=smi,
           torch=torch.__version__, cuda=torch.version.cuda)

    t = time.perf_counter()
    build.library()
    report("build", t, nvcc_seconds=round(build.build_seconds, 3),
           library=os.path.relpath(build.library_path(), ROOT),
           ptxas=ptxas_summary(build.build_log))

    # The mesh across processes first, while this process holds none of
    # the card: the later phases leave tens of GB reserved by its
    # allocator, which the ranks' training cases need.
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        multiprocess_counts, numbers = phase_multiprocess(
            torch, os.path.join(tmp, "multiprocess"))
        report("multiprocess", t, **numbers)

    t = time.perf_counter()
    report("io", t, **phase_io())

    t = time.perf_counter()
    cfg = PipelineConfig().matching_config()
    kernels = phase_kernels(torch, cfg, dev)
    report("kernels", t, kernels=kernels,
           other_radii=check_other_radii(torch, dev))

    # The classical kernels at the matcher's own default, Middlebury
    # 1080x1920 / disparity 75..262: 95 planes at 540x960.
    t = time.perf_counter()
    middlebury = check_classical(torch, MatchingConfig(), dev,
                                 np.random.default_rng(2), middlebury_pair(),
                                 "Middlebury", plain_reps=3)
    for k in middlebury:
        k["name"] += "_middlebury"
    report("kernels_middlebury", t, kernels=middlebury)

    t = time.perf_counter()
    golden = np.load(KITTI_GOLDEN)["disparity"].astype(np.float32)
    engine = ClassicalStereoEngine(MatchingConfig(
        height=384, width=1280, min_disparity=0, max_disparity=64), device=dev)
    left, right = kitti_pair()
    disp = engine.compute_disparity_map(left, right).cpu().numpy()
    frac = float(np.mean(np.abs(disp - golden) <= 0.5))
    require(frac >= 0.99, f"KITTI golden: only {frac} within 0.5 px")
    report("golden", t, frac_within_0p5px=frac,
           mean_disparity=float(disp.mean()))

    t = time.perf_counter()
    synthesis, deep3d_weights = make_synthesis(dev)
    pipeline, numbers = phase_pipeline(torch, dev, synthesis,
                                       reference_check=True)
    report("pipeline", t, weights=deep3d_weights, **numbers)
    profile(torch, "profile", pipeline, dev)

    # The main path of this slice: the fused single view, its launch counts
    # zeroed just before each batch's run and read just after.
    t = time.perf_counter()
    fused_counts, numbers = phase_fused_single_view(torch, dev, synthesis)
    report("fused_single_view", t, **numbers)

    t = time.perf_counter()
    report("fresh_deep3d", t, **phase_fresh_deep3d(torch, dev))
    torch.cuda.empty_cache()

    t = time.perf_counter()
    dnn_pipeline, numbers = phase_dnn(torch, dev, synthesis)
    report("dnn", t, deep3d_weights=deep3d_weights, **numbers)
    profile(torch, "profile_dnn", dnn_pipeline, dev)

    # Launch counts of every path driven through the user's entry points,
    # each zeroed just before its run and read just after: the KITTI-size
    # paths, and the Middlebury path (the kernels at MatchingConfig()).
    counts = {"fused_single_view": fused_counts}
    t = time.perf_counter()
    arm_counts, arms = phase_evaluation(torch, dev, synthesis)
    counts.update({f"evaluation/{k}": v for k, v in arm_counts.items()})
    report("evaluation", t, deep3d_weights=deep3d_weights, arms=arms)

    t = time.perf_counter()
    synthetic_counts, numbers = phase_synthetic(torch, dev, synthesis,
                                                deep3d_weights)
    counts.update({f"synthetic/{k}": v for k, v in synthetic_counts.items()})
    report("synthetic", t, deep3d_weights=deep3d_weights, **numbers)

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        orbax_counts, numbers = phase_orbax(torch, dev, synthesis,
                                            deep3d_weights,
                                            os.path.join(tmp, "orbax"))
        counts.update({f"orbax/{k}": v for k, v in orbax_counts.items()})
        report("orbax", t, **numbers)
        torch.cuda.empty_cache()

        # Training launches no kernel (as in the JAX package, whose models
        # train through XLA compositions); the exported weights do, in the
        # inference wrappers.
        training = {}
        for label, phase in (("train_deep3d", phase_train_deep3d),
                             ("train_stereo", phase_train_stereo)):
            t = time.perf_counter()
            counts[f"{label}/export"], numbers = phase(
                torch, dev, os.path.join(tmp, label))
            report(label, t, **numbers)
            training[label] = dict(
                ms_per_step_median=numbers["ms_per_step_median"],
                max_memory_allocated_bytes=numbers[
                    "max_memory_allocated_bytes"])
            torch.cuda.empty_cache()
        memory_line(torch, "train_stereo")
        training["train_stereo_kitti2015"] = {
            k: numbers["kitti2015"][k] for k in ("epoch_s",
                                                 "max_memory_allocated_bytes")}
        print(json.dumps({"training": training}), flush=True)

        t = time.perf_counter()
        runner_counts, numbers, grids = phase_runner(
            torch, dev, synthesis, os.path.join(tmp, "runner"))
        counts.update(runner_counts)
        report("runner", t, deep3d_weights=deep3d_weights, **numbers)

        t = time.perf_counter()
        report("video_stream", t, **phase_video_stream(grids, tmp))
        del grids

        t = time.perf_counter()
        scenes = os.path.join(tmp, "middlebury")
        write_middlebury_scene(os.path.join(scenes, "seeded"))
        middlebury_counts, numbers = phase_middlebury(
            torch, dev, os.path.join(scenes, "seeded"),
            os.path.join(tmp, "middlebury_out"))
        report("middlebury", t, **numbers)

        t = time.perf_counter()
        report("scripts", t, **phase_scripts(scenes,
                                             os.path.join(tmp, "scripts")))

    for label, pipe, needed in (("server", pipeline, CLASSICAL_KERNELS),
                                ("server_dnn", dnn_pipeline, GWCNET_KERNELS)):
        t = time.perf_counter()
        counts[label], numbers = phase_server(torch, pipe, dev, needed)
        report(label, t, launches=counts[label], **numbers)

    t = time.perf_counter()
    counts["server_asgi"], numbers = phase_server_asgi(torch, pipeline)
    report("server_asgi", t, **numbers)
    del pipeline, dnn_pipeline
    torch.cuda.empty_cache()

    # The mesh phases, on a virtual mesh of cuda:0.
    t = time.perf_counter()
    row_halo = phase_mesh_kernels(torch, dev, cfg, MatchingConfig())
    report("mesh_kernels", t, mesh="virtual: cuda:0 named n times",
           cases=row_halo)

    t = time.perf_counter()
    mesh_counts, numbers = phase_mesh(torch, dev, cfg, MatchingConfig())
    counts["mesh"] = mesh_counts["kitti"]
    report("mesh", t, **numbers)
    for label, phase, args in (
            ("mesh_single_view", phase_mesh_single_view,
             (PipelineConfig(), synthesis)),
            ("mesh_dnn", phase_mesh_dnn, (PipelineConfig(),)),
            ("mesh_server", phase_mesh_server,
             (PipelineConfig(), synthesis))):
        t = time.perf_counter()
        counts[label], numbers = phase(torch, dev, *args)
        report(label, t, **numbers)
        torch.cuda.empty_cache()
    t = time.perf_counter()
    counts["mesh_dnn_rows"], numbers, failed = phase_mesh_dnn_rows(
        torch, dev, PipelineConfig())
    report("mesh_dnn_rows", t, **numbers)
    t = time.perf_counter()
    counts["mesh_single_view_rows"], numbers, failed_sv = (
        phase_mesh_single_view_rows(torch, dev, PipelineConfig(), synthesis))
    report("mesh_single_view_rows", t, **numbers)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = phase_mesh_train(torch, dev, synthesis, deep3d_weights)
    counts["mesh_train"] = numbers["launches"]
    report("mesh_train", t, **numbers)
    memory_line(torch, "mesh_train")
    free_card(torch)
    memory_line(torch, "free_card")
    clear_cublas_workspaces(torch)
    memory_line(torch, "cublas_workspaces_cleared")
    counts["multiprocess"] = multiprocess_counts
    require(not failed, f"mesh_dnn_rows failed its gates: {failed}")
    require(not failed_sv,
            f"mesh_single_view_rows failed its gates: {failed_sv}")
    mesh_launches = {k: sum(c[k] for label, c in counts.items()
                            if label.startswith("mesh"))
                     for k in counts["mesh"]}
    require(all(v >= 1 for v in mesh_launches.values()),
            f"the mesh phases missed a kernel: {mesh_launches}")

    kernels += row_halo["kitti_tile4"]
    for k in kernels:
        k["launches"] = sum(c[k["kernel"]] for c in counts.values())
    middlebury += [dict(k, name=k["name"] + "_middlebury")
                   for k in row_halo["middlebury_tile4"]]
    for k in middlebury:
        k["launches"] = (middlebury_counts[k["kernel"]]
                         + mesh_counts["middlebury"][k["kernel"]])
    kernels += middlebury
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}), flush=True)
    for line in smi:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


def launch_classical(torch, lib, cfg, left_down, right_down, disparity,
                     left_gray, right_gray):
    """The C launchers of one library, on preallocated outputs: returns
    ``(run_matching_core, run_sampled_window, outputs)``."""
    from stereo_tpu_torch.ops.cuda import build

    hd, wd = left_down.shape
    h, w = left_gray.shape
    disp = torch.empty((hd, wd), device=left_down.device)
    mbm = torch.empty((3, hd, wd), device=left_down.device)
    win = torch.empty((2 * cfg.k + 3, hd, wd), device=left_down.device)

    def run_matching_core():
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.stereo_matching_core(
            left_down.data_ptr(), right_down.data_ptr(), disp.data_ptr(),
            mbm.data_ptr(), hd, wd, cfg.min_disparity_down,
            cfg.num_disparities_down, cfg.cost_patch_radius,
            cfg.small_mbm_radius, cfg.mid_mbm_radius, cfg.large_mbm_radius,
            0, stream), "matching_core")

    def run_sampled_window():
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.stereo_sampled_window(
            left_gray.data_ptr(), right_gray.data_ptr(), disparity.data_ptr(),
            win.data_ptr(), h, w, hd, wd, cfg.k, cfg.sad_patch_radius,
            cfg.min_disparity_down, cfg.num_disparities_down, 0, stream),
            "sampled_window")

    return run_matching_core, run_sampled_window, (disp, mbm, win)


def compare_classical(torch, libs, dev) -> None:
    """``--compare`` of the classical kernels' versions in ``libs``."""
    from stereo_tpu_torch.core.config import MatchingConfig, PipelineConfig
    from stereo_tpu_torch.ops import mean_pool, rgb_to_grayscale
    from stereo_tpu_torch.ops.cuda import (matching_core_plain,
                                           sampled_window_plain)

    kitti = PipelineConfig().matching_config()
    middlebury = MatchingConfig()
    # A second disparity range of each image size: 17 planes at KITTI,
    # 48 at Middlebury.
    configs = (("kitti", kitti, kitti_pair),
               ("kitti_17_planes", kitti.replace(max_disparity=32),
                kitti_pair),
               ("middlebury", middlebury, middlebury_pair),
               ("middlebury_48_planes", middlebury.replace(max_disparity=168),
                middlebury_pair))
    order = list(libs) + list(libs)[::-1]
    for label, cfg, make_pair in configs:
        t = time.perf_counter()
        left, right = make_pair()
        lg = rgb_to_grayscale(torch.from_numpy(left).to(dev)).contiguous()
        rg = rgb_to_grayscale(torch.from_numpy(right).to(dev)).contiguous()
        lgd = mean_pool(lg, cfg.k).contiguous()
        rgd = mean_pool(rg, cfg.k).contiguous()
        disp_p, mbm_p = matching_core_plain(lgd, rgd, cfg)
        win_p = sampled_window_plain(lg, rg, disp_p, cfg)
        runs, checks = {}, {}
        for name, lib in libs.items():
            runs[name] = launch_classical(torch, lib, cfg, lgd, rgd, disp_p,
                                          lg, rg)
            run_mc, run_sw, (disp, mbm, win) = runs[name]
            run_mc()
            run_sw()
            torch.cuda.synchronize()
            checks[name] = dict(
                winners_equal=float((disp == disp_p).float().mean()),
                mbm_max_abs_diff=float((mbm - mbm_p).abs().max()),
                window_max_abs_diff=float((win - win_p).abs().max()))
            # The same bits as the plain versions, as in the main smoke.
            require(checks[name] == dict(winners_equal=1.0,
                                         mbm_max_abs_diff=0.0,
                                         window_max_abs_diff=0.0),
                    f"version {name} at {label}: {checks[name]}")
        times = {name: dict(matching_core=[], sampled_window=[])
                 for name in libs}
        for name in order:
            run_mc, run_sw, _ = runs[name]
            times[name]["matching_core"].append(timings(run_mc))
            times[name]["sampled_window"].append(timings(run_sw))
        report("compare", t, config=label,
               shape=[cfg.height, cfg.width, cfg.num_disparities_down],
               checks=checks, ms=times, order=order)


def compare_blend(torch, libs, dev) -> None:
    """``--compare`` of the ``upsample_blend`` versions in ``libs``."""
    from stereo_tpu_torch.ops.cuda import build, upsample_blend_plain

    order = list(libs) + list(libs)[::-1]
    for n, num_d, hl, wl, s in ((1, 65, 96, 320, 4),) + BLEND_CASES:
        label = "x".join(map(str, (n, num_d, hl, wl, s)))
        t = time.perf_counter()
        prob, view = blend_inputs(torch, np.random.default_rng(1), dev, n,
                                  num_d, hl, wl, s)
        want = upsample_blend_plain(prob, view, s)
        out = torch.empty_like(view)
        runs, checks = {}, {}
        for name, lib in libs.items():
            def run(lib=lib):
                build.check(lib.stereo_upsample_blend(
                    prob.data_ptr(), view.data_ptr(), out.data_ptr(), n,
                    num_d, hl, wl, s * hl, s * wl,
                    torch.cuda.current_stream().cuda_stream),
                    "upsample_blend")
            out.fill_(float("nan"))
            run()
            checks[name] = float((out - want).abs().max())
            # The main smoke's gate (nan fails it too).
            require(checks[name] <= 2e-4,
                    f"version {name} at {label}: off by {checks[name]}")
            runs[name] = run
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(timings(runs[name]))
        report("compare_blend", t, config=label, shape=[n, num_d, hl, wl, s],
               max_abs_err=checks, ms=times, order=order)


def compare_gwc(torch, libs, dev) -> None:
    """``--compare`` of the ``gwc_volume`` versions in ``libs``."""
    from stereo_tpu_torch.ops.cuda import build, gwc_volume_plain

    order = list(libs) + list(libs)[::-1]
    left, right = gwc_features(torch, np.random.default_rng(1), dev)
    for variant in GWC_VARIANTS:
        d, dtype, g, h, w = variant
        t = time.perf_counter()
        lt, rt = gwc_case(torch, left, right, variant)
        n, c = lt.shape[:2]
        want = gwc_volume_plain(lt, rt, d, g)
        peak, limit = gwc_limit(torch, want)
        bits = torch.int32 if dtype == "float32" else torch.int16
        runs, outs, errs = {}, {}, {}
        for name, lib in libs.items():
            out = torch.full_like(want, float("nan"))

            def run(lib=lib, out=out):
                build.check(lib.stereo_gwc_volume(
                    lt.data_ptr(), rt.data_ptr(), out.data_ptr(), n, c, h, w,
                    g, d, GWC_DTYPE_CODES[dtype],
                    torch.cuda.current_stream().cuda_stream), "gwc_volume")
            run()
            torch.cuda.synchronize()
            errs[name] = float((out.float() - want.float()).abs().max())
            # The main smoke's gate (nan fails it too).
            require(errs[name] <= limit, f"version {name} at {variant}: off "
                                         f"by {errs[name]} (limit {limit})")
            runs[name], outs[name] = run, out
        first = outs[next(iter(libs))].view(bits)
        differing = {name: int((out.view(bits) != first).sum())
                     for name, out in outs.items()}
        require(not any(differing.values()),
                f"versions differ at {variant}: {differing}")
        ref = gwc_float64(torch, lt, rt, d, g)
        float64 = dict(kernel=gwc_distance(torch, outs[next(iter(libs))], ref),
                       plain=gwc_distance(torch, want, ref))
        del ref, outs
        times = {name: [] for name in libs}
        for name in order:
            times[name].append(timings(runs[name]))
        b_ms, b_by = gwc_bound(lt, d, g)
        # The card's rate for the same traffic: a copy that reads and
        # writes as many bytes as the variant's inputs and volume.
        moved = (2 * lt.numel() + want.numel()) * lt.element_size()
        src = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        copy_ms = cuda_ms(lambda: dst.copy_(src), 50, True)
        del src, dst
        report("compare_gwc", t, planes=d, dtype=dtype, groups=g,
               channels_per_group=c // g, shape=list(lt.shape),
               max_abs_err=errs, limit=limit, max_abs_vol=peak,
               elements_differing_from_first=differing, float64=float64,
               bound_ms=b_ms, bound_by=b_by, copy_device_ms=copy_ms,
               ms=times, order=order)


# What ``--phases`` runs, in this order.
ONLY_PHASES = ("io", "multiprocess", "mesh_dnn_rows", "orbax", "server",
               "train_stereo", "mesh_single_view_rows", "mesh_train",
               "synthetic", "runner")


def only(names) -> int:
    """``--phases``: see the module's docstring."""
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    require(set(names) <= set(ONLY_PHASES),
            f"--phases takes {', '.join(ONLY_PHASES)}, not {names}")
    sys.path.insert(0, ROOT)
    from stereo_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    report("device", time.perf_counter(), name=torch.cuda.get_device_name(0),
           nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    t = time.perf_counter()
    build.library()
    report("build", t, nvcc_seconds=round(build.build_seconds, 3))
    if "io" in names:
        t = time.perf_counter()
        report("io", t, **phase_io())
    if "multiprocess" in names:
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            counts, numbers = phase_multiprocess(
                torch, os.path.join(tmp, "multiprocess"))
            report("multiprocess", t, launches=counts, **numbers)
    if "mesh_dnn_rows" in names:
        from stereo_tpu_torch.core.config import PipelineConfig

        t = time.perf_counter()
        counts, numbers, failed = phase_mesh_dnn_rows(torch, dev,
                                                      PipelineConfig())
        report("mesh_dnn_rows", t, launches=counts, **numbers)
        require(not failed, f"mesh_dnn_rows failed its gates: {failed}")
    if "orbax" in names:
        synthesis, deep3d_weights = make_synthesis(dev)
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            counts, numbers = phase_orbax(torch, dev, synthesis,
                                          deep3d_weights,
                                          os.path.join(tmp, "orbax"))
            report("orbax", t, launches=counts, **numbers)
        del synthesis
        torch.cuda.empty_cache()
    if "server" in names:
        synthesis, deep3d_weights = make_synthesis(dev)
        pipeline, _ = phase_pipeline(torch, dev, synthesis,
                                     reference_check=False)
        t = time.perf_counter()
        counts, numbers = phase_server(torch, pipeline, dev,
                                       CLASSICAL_KERNELS)
        report("server", t, deep3d_weights=deep3d_weights, launches=counts,
               **numbers)
        del synthesis, pipeline
        torch.cuda.empty_cache()
    if "train_stereo" in names:
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            counts, numbers = phase_train_stereo(
                torch, dev, os.path.join(tmp, "train_stereo"))
            report("train_stereo", t, **numbers)
        torch.cuda.empty_cache()
        memory_line(torch, "train_stereo")
    if "mesh_single_view_rows" in names:
        from stereo_tpu_torch.core.config import PipelineConfig

        synthesis, deep3d_weights = make_synthesis(dev)
        t = time.perf_counter()
        counts, numbers, failed = phase_mesh_single_view_rows(
            torch, dev, PipelineConfig(), synthesis)
        report("mesh_single_view_rows", t, deep3d_weights=deep3d_weights,
               launches=counts, **numbers)
        require(not failed, f"mesh_single_view_rows failed its gates: "
                            f"{failed}")
        del synthesis
        torch.cuda.empty_cache()
    if "mesh_train" in names:
        synthesis, deep3d_weights = make_synthesis(dev)
        t = time.perf_counter()
        report("mesh_train", t, **phase_mesh_train(torch, dev, synthesis,
                                                   deep3d_weights))
        memory_line(torch, "mesh_train")
        free_card(torch)
        memory_line(torch, "free_card")
        clear_cublas_workspaces(torch)
        memory_line(torch, "cublas_workspaces_cleared")
        del synthesis
        torch.cuda.empty_cache()
    if "synthetic" in names:
        synthesis, deep3d_weights = make_synthesis(dev)
        t = time.perf_counter()
        _, numbers = phase_synthetic(torch, dev, synthesis, deep3d_weights)
        report("synthetic", t, deep3d_weights=deep3d_weights, **numbers)
    if "runner" in names:
        synthesis, deep3d_weights = make_synthesis(dev)
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            counts, numbers, grids = phase_runner(
                torch, dev, synthesis, os.path.join(tmp, "runner"))
            report("runner", t, deep3d_weights=deep3d_weights, **numbers)
            t = time.perf_counter()
            report("video_stream", t, **phase_video_stream(grids, tmp))
    for line in smi:
        print(line, flush=True)
    return 0


def compare(specs) -> int:
    """``--compare``: see the module's docstring."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stereo_tpu_torch.ops.cuda import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    report("device", time.perf_counter(), name=torch.cuda.get_device_name(0),
           nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    t = time.perf_counter()
    variants = dict(spec.split("=", 1) for spec in specs)
    sources = {name: [os.path.join(src_dir, f) for f in COMPARED_SOURCES
                      if os.path.isfile(os.path.join(src_dir, f))]
               for name, src_dir in variants.items()}
    require(all(sources.values()), f"a version has no kernel source: "
                                   f"{sources}")
    # One nvcc call per version, all at once.
    with ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(build.compile_library,
                                            sources.values())))
    libs = {}
    for name, (path, seconds, log) in built.items():
        libs[name] = build.load(path)
        report("variant", t, name=name, sources=sources[name],
               nvcc_seconds=round(seconds, 3), ptxas=ptxas_summary(log),
               sass=sass_counts(path))

    classical = {name: lib for name, lib in libs.items()
                 if hasattr(lib, "stereo_matching_core")
                 and hasattr(lib, "stereo_sampled_window")}
    if classical:
        compare_classical(torch, classical, dev)
    blend = {name: lib for name, lib in libs.items()
             if hasattr(lib, "stereo_upsample_blend")}
    if blend:
        compare_blend(torch, blend, dev)
    gwc = {name: lib for name, lib in libs.items()
           if hasattr(lib, "stereo_gwc_volume")}
    if gwc:
        compare_gwc(torch, gwc, dev)
    for line in smi:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    if "--memory-history" in sys.argv:
        # Every allocation's Python stack, for ``memory_line``'s frames.
        import torch

        sys.argv.remove("--memory-history")
        torch.cuda.memory._record_memory_history(max_entries=200000)
    if len(sys.argv) > 2 and sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2:]))
    if len(sys.argv) > 2 and sys.argv[1] == "--phases":
        sys.exit(only(sys.argv[2:]))
    sys.exit(main())
