#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``stereo_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each ending in one flushed JSON line with its name and seconds:

1. device:   the card's name, count and ``nvidia-smi`` name/power limit;
2. build:    one ``nvcc`` call builds every ``stereo_tpu_torch/csrc/*.cu``
             into one library (0 s when the library is already built);
3. kernels:  each kernel against its plain PyTorch version at the shapes of
             the single-view paths (384x1280, disparity 1..64; GwcNet's
             volume also at disparity 192 and in bf16), with its median
             time, the plain version's time and its bound;
4. golden:   the classical matcher on the synthetic KITTI pair against the
             committed golden (>= 99% of pixels within 0.5 px);
5. pipeline: ``DepthEstimationPipeline`` on single views at full width,
             the result against the same frame through the plain versions,
             and its ms/frame with the per-stage times;
   profile:  device time by kernel over a few frames (``torch.profiler``)
             and the device's busy share of the wall time;
6. dnn:      the same pipeline with the GwcNet backend: single views
             (ms/frame, stages, the disparity against the same frame
             through ``gwc_volume_plain``), the synthetic KITTI pair, GwcNet
             at disparity 192 and its feature extractor alone, and a few
             forwards each of MSNet2D, MSNet3D and GwcNet in bf16;
   profile_dnn: the GwcNet single view's device time by kernel;
7. server:   ``DepthEstimationServer`` on a free local port answers three
             PNG uploads, then shuts down, once with the classical backend
             and once with GwcNet.  The kernel launch counts are zeroed
             just before each and read just after; every kernel of that
             path must have launched.

Then a JSON line with every kernel's numbers (its launches summed over
the two server runs), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and the script
exits non-zero without that last line; so does a machine without CUDA.
Every network loads its committed checkpoint (``data/checkpoints/*.npz``)
when it is present, else seeded random weights at the same width; the
phase lines say which.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KITTI_GOLDEN = os.path.join(ROOT, "tests", "golden",
                            "kitti_synthetic_disparity_tpu.npz")
DEEP3D_NPZ = os.path.join(ROOT, "data", "checkpoints", "deep3d.npz")

# The kernels each single-view path must launch.
CLASSICAL_KERNELS = ("upsample_blend", "matching_core", "sampled_window")
GWCNET_KERNELS = ("upsample_blend", "gwc_volume")

# H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def report(phase: str, start: float, **numbers) -> None:
    print(json.dumps({"phase": phase, "seconds": round(time.perf_counter()
                                                       - start, 3),
                      **numbers}), flush=True)


def require(cond: bool, message: str) -> None:
    if not cond:
        raise RuntimeError(message)


def cuda_ms(fn, reps: int) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` calls (CUDA events
    around each call), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_kernels(torch, cfg, dev) -> list:
    from stereo_tpu_torch.ops import mean_pool, rgb_to_grayscale
    from stereo_tpu_torch.ops.cuda import (matching_core, matching_core_plain,
                                           sampled_window,
                                           sampled_window_plain,
                                           upsample_blend,
                                           upsample_blend_plain)

    rng = np.random.default_rng(1)
    h, w = cfg.height, cfg.width
    hd, wd = cfg.down_height, cfg.down_width
    num_d, k = cfg.num_disparities_down, cfg.k
    results = []

    # matching_core: an integer-valued pair is exact in every box sum, so
    # kernel and plain version must agree to 1e-4; a real-valued pair (the
    # pooled luma of the KITTI pair) may flip near-tie winners.
    li = rng.integers(0, 256, (hd, wd)).astype(np.float32)
    ld = torch.from_numpy(li).to(dev)
    rd = torch.from_numpy(np.roll(li, -5, axis=-1).copy()).to(dev)
    disp_k, mbm_k = matching_core(ld, rd, cfg)
    disp_p, mbm_p = matching_core_plain(ld, rd, cfg)
    err = float((disp_k - disp_p).abs().max())
    require(err <= 1e-4, f"matching_core disparity off by {err} (int pair)")
    mbm_rel = float(((mbm_k - mbm_p).abs() / mbm_p.abs().clamp_min(1)).max())
    require(mbm_rel <= 1e-6, f"matching_core mbm off by rel {mbm_rel}")
    left, right = kitti_pair()
    lg = rgb_to_grayscale(torch.from_numpy(left).to(dev)).contiguous()
    rg = rgb_to_grayscale(torch.from_numpy(right).to(dev)).contiguous()
    lgd, rgd = mean_pool(lg, k).contiguous(), mean_pool(rg, k).contiguous()
    disp_kr, _ = matching_core(lgd, rgd, cfg)
    disp_pr, _ = matching_core_plain(lgd, rgd, cfg)
    frac_real = float(((disp_kr - disp_pr).abs() <= 0.5).float().mean())
    require(frac_real >= 0.99, f"matching_core real pair: {frac_real}")
    ms = cuda_ms(lambda: matching_core(lgd, rgd, cfg), 50)
    plain_ms = cuda_ms(lambda: matching_core_plain(lgd, rgd, cfg), 5)
    # Per pixel and plane, summing separably: one difference (sub, abs),
    # the 3x3 box and its subtraction from 255*area, the three MBM box
    # sums, two products and the winner test.
    r, s, m, L = (cfg.cost_patch_radius, cfg.small_mbm_radius,
                  cfg.mid_mbm_radius, cfg.large_mbm_radius)
    per = 2 + 4 * r + 1 + 4 * (L + s + m) + 2 + 1
    b_ms, b_by = bound(4 * hd * wd * (2 + 1 + 3), per * num_d * hd * wd)
    results.append(dict(name="matching_core", route="cuda",
                        source="stereo_tpu_torch/csrc/matching_core.cu",
                        replaces="stereo_tpu/ops/pallas/kernels.py:210",
                        max_abs_err=err, real_pair_frac_within_0p5=frac_real,
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None))

    # sampled_window on the real-valued luma and the kernel's winners.
    win_k = sampled_window(lg, rg, disp_kr, cfg)
    win_p = sampled_window_plain(lg, rg, disp_kr, cfg)
    err = float((win_k - win_p).abs().max())
    require(err <= 2e-2, f"sampled_window off by {err}")
    ms = cuda_ms(lambda: sampled_window(lg, rg, disp_kr, cfg), 50)
    plain_ms = cuda_ms(lambda: sampled_window_plain(lg, rg, disp_kr, cfg), 3)
    # Per tap: (2r+1)^2 differences (sub, abs) and their sum.
    win, patch = 2 * k + 3, 2 * cfg.sad_patch_radius + 1
    b_ms, b_by = bound(4 * (2 * h * w + hd * wd + win * hd * wd),
                       3 * win * patch * patch * hd * wd)
    results.append(dict(name="sampled_window", route="cuda",
                        source="stereo_tpu_torch/csrc/sampled_window.cu",
                        replaces="stereo_tpu/ops/pallas/kernels.py:394",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None))

    # upsample_blend: softmax volume (1, 65, 96, 320), view in 0..1.
    logits = rng.standard_normal((1, 65, h // 4, w // 4)).astype(np.float32)
    prob = torch.softmax(torch.from_numpy(logits).to(dev), dim=1).contiguous()
    view = torch.from_numpy(
        rng.uniform(0, 1, (1, 3, h, w)).astype(np.float32)).to(dev)
    out_k = upsample_blend(prob, view, 4)
    out_p = upsample_blend_plain(prob, view, 4)
    err = float((out_k - out_p).abs().max())
    require(err <= 2e-4, f"upsample_blend off by {err}")
    ms = cuda_ms(lambda: upsample_blend(prob, view, 4), 50)
    plain_ms = cuda_ms(lambda: upsample_blend_plain(prob, view, 4), 3)
    # Per output pixel and live plane: 9 ops of bilinear weight, 3 FMAs.
    live = sum(min(65, w - x) for x in range(w)) * h
    b_ms, b_by = bound(4 * (prob.numel() + view.numel() + out_k.numel()),
                       15 * live)
    results.append(dict(name="upsample_blend", route="cuda",
                        source="stereo_tpu_torch/csrc/upsample_blend.cu",
                        replaces="stereo_tpu/ops/pallas/blend.py:209",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    results.append(check_gwc_volume(torch, rng, dev))
    return results


def check_gwc_volume(torch, rng, dev) -> dict:
    """``gwc_volume`` at GwcNet's width on the 384x1280 path (features
    (1, 320, 96, 320), 40 groups): D=16 planes (disparity 64) and 48
    (disparity 192) in float32, 16 in bf16.  Float32 must agree with the
    plain version within 1e-5 * max|vol|, bf16 (compared in bf16) within
    one bf16 ulp of max|vol|.  The kernel's entry is the path's shape
    (D=16, float32); the others go in ``variants``."""
    from stereo_tpu_torch.ops.cuda import gwc_volume, gwc_volume_plain

    n, c, h, w, g = 1, 320, 96, 320, 40
    # ReLU'd like real features.
    left, right = (torch.from_numpy(np.maximum(rng.standard_normal(
        (n, c, h, w)), 0).astype(np.float32)).to(dev) for _ in range(2))
    variants = []
    for d, dtype in ((16, torch.float32), (48, torch.float32),
                     (16, torch.bfloat16)):
        lt, rt = left.to(dtype), right.to(dtype)
        vol_k = gwc_volume(lt, rt, d, g)
        vol_p = gwc_volume_plain(lt, rt, d, g)
        torch.cuda.synchronize()
        err = float((vol_k.float() - vol_p.float()).abs().max())
        peak = float(vol_p.float().abs().max())
        if dtype == torch.float32:
            limit = 1e-5 * peak
        else:
            limit = 2.0 ** (np.floor(np.log2(peak)) - 7)   # 1 bf16 ulp
        require(err <= limit, f"gwc_volume D={d} {dtype}: off by {err} "
                              f"(limit {limit})")
        ms = cuda_ms(lambda: gwc_volume(lt, rt, d, g), 50)
        plain_ms = cuda_ms(lambda: gwc_volume_plain(lt, rt, d, g), 5)
        # Each input read once, the volume written once; one multiply and
        # one add per channel at each live (d, w >= d) position.
        live = n * h * sum(w - k for k in range(d))
        b_ms, b_by = bound(lt.element_size()
                           * (2 * n * c * h * w + n * g * d * h * w),
                           2 * c * live)
        variants.append(dict(planes=d, dtype=str(dtype).split(".")[-1],
                             max_abs_err=err, limit=limit, max_abs_vol=peak,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by))
    main = variants[0]
    return dict(name="gwc_volume", route="cuda",
                source="stereo_tpu_torch/csrc/gwc_volume.cu",
                replaces="stereo_tpu/ops/pallas/gwc_volume.py:103",
                max_abs_err=main["max_abs_err"], ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None,
                variants=variants)


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
    return pipeline, dict(single_view=single, pair_d64=pair,
                          pair_d192=pair192,
                          gwcnet_features_ms=features_ms, **others)


def phase_profile(torch, pipeline, dev, frames: int = 3) -> dict:
    """Device time by kernel over a few pipeline frames (torch.profiler),
    and the share of the wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    left = torch.zeros((3, *pipeline.get_configuration().image_shape),
                       device=dev)
    pipeline.process(left)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            pipeline.process(left)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return dict(frames=frames, wall_ms_per_frame=wall_ms / frames,
                device_ms_per_frame=device_ms / frames,
                device_busy_share=device_ms / wall_ms,
                top=[dict(name=e.key[:90], calls=e.count // frames,
                          ms_per_frame=e.self_device_time_total / 1e3 / frames)
                     for e in kernels[:12]])


def profile(torch, label: str, pipeline, dev) -> None:
    """The profile only measures; a profiler that cannot trace the card is
    reported, not fatal."""
    t = time.perf_counter()
    try:
        report(label, t, **phase_profile(torch, pipeline, dev))
    except Exception as exc:  # noqa: BLE001 — measurement only
        report(label, t, error=f"{type(exc).__name__}: {exc}")


def phase_server(torch, pipeline, dev, kernels):
    """Three PNG uploads to a server around ``pipeline``; every name in
    ``kernels`` must launch in that run."""
    from stereo_tpu_torch.ops.cuda import LAUNCHES, reset_launch_counts
    from stereo_tpu_torch.serve import DepthEstimationServer
    from stereo_tpu_torch.utils.png import decode_png, encode_png

    config = pipeline.get_configuration()
    server = DepthEstimationServer(config, pipeline=pipeline, micro_batch=2,
                                   device=dev)
    rng = np.random.default_rng(3)
    uploads = [encode_png(rng.integers(0, 256, (*config.image_shape, 3),
                                       dtype=np.uint8)) for _ in range(3)]
    replies = [None] * len(uploads)
    host, port = server.start("127.0.0.1", 0)

    def post(i):
        req = urllib.request.Request(f"http://{host}:{port}/", data=uploads[i],
                                     headers={"Content-Type": "image/png"})
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
    statuses = [r[0] if r else None for r in replies]
    require(statuses == [200] * len(uploads), f"server replies {statuses}")
    for _, body in replies:
        shape = decode_png(body).shape
        require(shape[:2] == tuple(config.image_shape), f"reply shape {shape}")
    require(all(counts[k] >= 1 for k in kernels),
            f"{config.stereo_matching_backend} path missed a kernel: {counts}")
    return counts, dict(statuses=statuses, batches=server.batcher.batches_run,
                        frames=server.batcher.frames_run)


def main() -> int:
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
           library=os.path.relpath(build.library_path(), ROOT))

    t = time.perf_counter()
    cfg = PipelineConfig().matching_config()
    kernels = phase_kernels(torch, cfg, dev)
    report("kernels", t, kernels=kernels)

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

    t = time.perf_counter()
    dnn_pipeline, numbers = phase_dnn(torch, dev, synthesis)
    report("dnn", t, deep3d_weights=deep3d_weights, **numbers)
    profile(torch, "profile_dnn", dnn_pipeline, dev)

    counts = {}
    for label, pipe, needed in (("server", pipeline, CLASSICAL_KERNELS),
                                ("server_dnn", dnn_pipeline, GWCNET_KERNELS)):
        t = time.perf_counter()
        counts[label], numbers = phase_server(torch, pipe, dev, needed)
        report(label, t, launches=counts[label], **numbers)

    for k in kernels:
        k["launches"] = sum(c[k["name"]] for c in counts.values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}
                                  for k in kernels]}), flush=True)
    for line in smi:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
