"""The port's classical matcher (``stereo_tpu_torch``) against ``stereo_tpu``.

Same seeded numpy inputs through both packages.  Integer-valued inputs keep
every box sum exact in float32, so the classical stages agree to 1e-4 (in
practice bit for bit); the windowed SAD sums agree to 2e-2, the bound the
JAX kernel tests use for reassociated sums (``tests/test_pallas.py``).  The
JAX Pallas kernels run in interpret mode on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_tpu import ops as jops
from stereo_tpu.core.config import MatchingConfig as JaxMatchingConfig
from stereo_tpu.matching import classical as jax_classical
from stereo_tpu.ops.gather import take_lane as jax_take_lane
from stereo_tpu.ops.gather import take_window_lanes as jax_take_window_lanes
from stereo_tpu.ops.pallas import matching_core as jax_matching_core
from stereo_tpu.ops.pallas import sampled_window as jax_sampled_window
from stereo_tpu.ops.refinement import refine_from_window as jax_refine

from stereo_tpu_torch import ops as tops
from stereo_tpu_torch.core.config import MatchingConfig
from stereo_tpu_torch.matching.classical import ClassicalStereoEngine
from stereo_tpu_torch.ops import cuda as tcuda
from stereo_tpu_torch.ops.gather import take_lane, take_window_lanes

import torch_threads

torch_threads.take_worker_share()

# The five configs of tests/test_pallas.py: KITTI-like, Middlebury-like
# (nonzero min disparity), min disparity beyond the halo, a height with no
# aligned tile, and enough planes for the TPU kernels' chunked loops.
CONFIGS = {
    "kitti": dict(height=32, width=64, downscale_factor=2, min_disparity=0,
                  max_disparity=15, cost_patch_radius=1, sad_patch_radius=2,
                  threshold=5, small_mbm_radius=1, mid_mbm_radius=1,
                  large_mbm_radius=2),
    "middlebury": dict(height=48, width=96, downscale_factor=2,
                       min_disparity=8, max_disparity=23, cost_patch_radius=1,
                       sad_patch_radius=3, threshold=5, small_mbm_radius=1,
                       mid_mbm_radius=2, large_mbm_radius=3),
    "bigmin": dict(height=48, width=128, downscale_factor=2, min_disparity=24,
                   max_disparity=39, cost_patch_radius=1, sad_patch_radius=2,
                   threshold=5, small_mbm_radius=1, mid_mbm_radius=1,
                   large_mbm_radius=2),
    "unaligned": dict(height=40, width=64, downscale_factor=2,
                      min_disparity=0, max_disparity=11, cost_patch_radius=1,
                      sad_patch_radius=2, threshold=5, small_mbm_radius=1,
                      mid_mbm_radius=1, large_mbm_radius=2),
    "fori": dict(height=16, width=224, downscale_factor=2, min_disparity=0,
                 max_disparity=99, cost_patch_radius=1, sad_patch_radius=1,
                 threshold=5, small_mbm_radius=1, mid_mbm_radius=1,
                 large_mbm_radius=1),
}


def stereo_pair(h, w, shift, seed=21):
    """Smoothed integer-valued grey pair, right = left rolled by -shift."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w)).astype(np.float32)
    left = np.round((left + np.roll(left, 1, 0) + np.roll(left, 1, 1)) / 3)
    return left.astype(np.float32), np.roll(left, -shift, axis=-1).astype(
        np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(x)


def close(got, want, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


class TestImageOps:
    def test_rgb_to_grayscale(self):
        rgb = np.random.default_rng(0).integers(0, 256, (3, 17, 23)).astype(
            np.float32)
        np.testing.assert_array_equal(tops.rgb_to_grayscale(t(rgb)).numpy(),
                                      np.asarray(jops.rgb_to_grayscale(j(rgb))))

    @pytest.mark.parametrize("k,shape", [(2, (16, 24)), (2, (17, 23)),
                                         (3, (2, 13, 20)), (1, (5, 7))])
    def test_mean_pool(self, k, shape):
        x = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
        np.testing.assert_array_equal(tops.mean_pool(t(x), k).numpy(),
                                      np.asarray(jops.mean_pool(j(x), k)))

    def test_rescale_generated_view(self):
        v = np.random.default_rng(2).uniform(-0.2, 1.2, (3, 8, 9)).astype(
            np.float32)
        np.testing.assert_array_equal(
            tops.rescale_generated_view(t(v)).numpy(),
            np.asarray(jops.rescale_generated_view(j(v))))


class TestStageOps:
    @pytest.mark.parametrize("radius,axis", [(1, -1), (2, -2), (4, 0), (7, -1)])
    def test_box_sum_1d(self, radius, axis):
        x = np.random.default_rng(3).integers(0, 256, (5, 6, 9)).astype(
            np.float32)
        np.testing.assert_array_equal(
            tops.box_sum_1d(t(x), radius, axis).numpy(),
            np.asarray(jops.box_sum_1d(j(x), radius, axis)))

    def test_box_sum_2d_and_wrap_pad(self):
        x = np.random.default_rng(4).uniform(0, 255, (7, 11)).astype(np.float32)
        np.testing.assert_array_equal(tops.box_sum_2d(t(x), 2, 3).numpy(),
                                      np.asarray(jops.box_sum_2d(j(x), 2, 3)))
        np.testing.assert_array_equal(tops.wrap_pad(t(x), 3, -1).numpy(),
                                      np.asarray(jops.wrap_pad(j(x), 3, -1)))

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_cost_aggregation_wta(self, name):
        c = CONFIGS[name]
        lg, rg = stereo_pair(c["height"] // 2, c["width"] // 2, 5)
        args = (c["min_disparity"] // 2, c["max_disparity"] // 2,
                c["cost_patch_radius"])
        radii = (c["small_mbm_radius"], c["mid_mbm_radius"],
                 c["large_mbm_radius"])

        @jax.jit
        def jax_stages(left, right):
            vol = jops.sad_cost_volume(left, right, *args)
            agg = jops.mbm_aggregate(vol, *radii)
            return (vol, agg, jops.wta_disparity(agg, args[0]),
                    jops.sad_similarity_plane(left, right, 3, 1))

        vol_j, agg_j, disp_j, plane_j = jax_stages(j(lg), j(rg))
        vol_t = tops.sad_cost_volume(t(lg), t(rg), *args)
        close(vol_t, vol_j)
        agg_t = tops.mbm_aggregate(vol_t, *radii)
        np.testing.assert_allclose(agg_t.numpy(), np.asarray(agg_j),
                                   rtol=1e-6)
        close(tops.wta_disparity(agg_t, args[0]), disp_j)
        close(tops.sad_similarity_plane(t(lg), t(rg), 3, 1), plane_j)

    def test_gathers(self):
        rng = np.random.default_rng(5)
        vol = rng.uniform(0, 1, (6, 7, 20)).astype(np.float32)
        start = rng.integers(0, 7, (6, 7)) * 2
        idx = rng.integers(0, 20, (6, 7))
        close(take_window_lanes(t(vol), t(start), 7),
              jax_take_window_lanes(j(vol), j(start), 7, step=2), atol=0)
        close(take_lane(t(vol), t(idx)), jax_take_lane(j(vol), j(idx)), atol=0)

    def test_quadratic_function_peak(self):
        rng = np.random.default_rng(6)
        xs = [rng.integers(0, 5, 64).astype(np.float32) for _ in range(3)]
        ys = [rng.integers(0, 4, 64).astype(np.float32) for _ in range(3)]
        args = [v for pair in zip(xs, ys) for v in pair]
        close(tops.quadratic_function_peak(*map(t, args)),
              jops.quadratic_function_peak(*map(j, args)), atol=1e-6)

    @pytest.mark.parametrize("name", ["kitti", "middlebury"])
    def test_secondary_matching_and_sampled_sad(self, name):
        c = CONFIGS[name]
        k = c["downscale_factor"]
        lg, rg = stereo_pair(c["height"], c["width"], 6)
        ld, rd = tops.mean_pool(t(lg), k), tops.mean_pool(t(rg), k)
        min_dd = c["min_disparity"] // k
        vol = tops.sad_cost_volume(ld, rd, min_dd, c["max_disparity"] // k,
                                   c["cost_patch_radius"])
        agg = tops.mbm_aggregate(vol, c["small_mbm_radius"],
                                 c["mid_mbm_radius"], c["large_mbm_radius"])
        disp = tops.wta_disparity(agg, min_dd)
        r = c["sad_patch_radius"]

        @jax.jit
        def jax_refinement(left, right, aggregated, disparity):
            return (jops.sampled_sad_volume(left, right, k, r, -3, 9),
                    jops.secondary_matching(left, right, aggregated,
                                            disparity, k, r, min_dd))

        want_sad, want = jax_refinement(j(lg), j(rg), j(agg.numpy()),
                                        j(disp.numpy()))
        close(tops.sampled_sad_volume(t(lg), t(rg), k, r, -3, 9), want_sad)
        close(tops.secondary_matching(t(lg), t(rg), agg, disp, k, r, min_dd),
              want)

    def test_refine_from_window(self):
        rng = np.random.default_rng(7)
        window = rng.integers(0, 50, (9, 11, 7)).astype(np.float32)
        disp = rng.integers(1, 6, (9, 11)).astype(np.float32)
        mbm = [rng.integers(0, 50, (9, 11)).astype(np.float32)
               for _ in range(3)]
        close(tops.refine_from_window(t(window), t(disp), *map(t, mbm), 2),
              jax_refine(j(window), j(disp), *map(j, mbm), 2), atol=1e-6)

    @pytest.mark.parametrize("k,shape", [(2, (24, 40)), (3, (25, 38))])
    def test_fills(self, k, shape):
        rng = np.random.default_rng(8)
        gray = rng.integers(0, 256, shape).astype(np.float32)
        down = rng.uniform(0, 9, (-(-shape[0] // k), -(-shape[1] // k))
                           ).astype(np.float32)
        v_t = tops.upscale_vertical_fill(t(gray), t(down), k, 5.0)
        v_j = jops.upscale_vertical_fill(j(gray), j(down), k, 5.0)
        close(v_t, v_j, atol=1e-6)
        close(tops.horizontal_fill(t(gray), v_t, k, 5.0),
              jops.horizontal_fill(j(gray), v_j, k, 5.0), atol=1e-6)


class TestKernelPlainVersions:
    """The kernels' plain versions against the JAX Pallas kernels."""

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_matching_core(self, name):
        c = CONFIGS[name]
        cfg_j, cfg_t = JaxMatchingConfig(**c), MatchingConfig(**c)
        lg, rg = stereo_pair(c["height"], c["width"], c["min_disparity"] + 6)
        ld = jops.mean_pool(j(lg), cfg_j.k)
        rd = jops.mean_pool(j(rg), cfg_j.k)
        want_disp, want_mbm = jax_matching_core(ld, rd, cfg_j)
        disp, mbm = tcuda.matching_core(t(np.asarray(ld)), t(np.asarray(rd)),
                                        cfg_t)
        close(disp, want_disp)
        np.testing.assert_allclose(mbm.numpy(), np.asarray(want_mbm),
                                   rtol=1e-6)

    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_sampled_window(self, name):
        c = CONFIGS[name]
        cfg_j, cfg_t = JaxMatchingConfig(**c), MatchingConfig(**c)
        lg, rg = stereo_pair(c["height"], c["width"], 6)
        ld, rd = tops.mean_pool(t(lg), cfg_t.k), tops.mean_pool(t(rg), cfg_t.k)
        disp, _ = tcuda.matching_core(ld, rd, cfg_t)
        want = jax_sampled_window(j(lg), j(rg), j(disp.numpy()), cfg_j)
        got = tcuda.sampled_window(t(lg), t(rg), disp, cfg_t)
        close(got, want, atol=2e-2)

    def test_unsupported_device_raises(self):
        cfg = MatchingConfig(**CONFIGS["kitti"])
        x = torch.empty((16, 32), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tcuda.matching_core(x, x, cfg)
        with pytest.raises(ValueError, match="unsupported device"):
            tcuda.sampled_window(x, x, x, cfg)


@functools.lru_cache(maxsize=None)
def engine_case(name):
    """Seeded integer RGB pair for config ``name`` and the JAX XLA path's
    disparity on it (computed once for both of the port's impls)."""
    c = CONFIGS[name]
    rng = np.random.default_rng(9)
    left = rng.integers(0, 256, (3, c["height"], c["width"])).astype(
        np.float32)
    right = np.roll(left, -6, axis=-1)
    fn = jax.jit(functools.partial(jax_classical.compute_disparity_map,
                                   config=JaxMatchingConfig(**c, impl="xla")))
    return left, right, np.asarray(fn(j(left), j(right)))


class TestClassicalStereoEngine:
    @pytest.mark.parametrize("impl", ["auto", "torch"])
    @pytest.mark.parametrize("name", sorted(CONFIGS))
    def test_matches_jax_xla_path(self, name, impl):
        c = CONFIGS[name]
        left, right, want = engine_case(name)
        engine = ClassicalStereoEngine(MatchingConfig(**c, impl=impl),
                                       device="cpu")
        close(engine.compute_disparity_map(left, right), want)

    def test_batch_loops_per_frame(self):
        c = CONFIGS["kitti"]
        rng = np.random.default_rng(10)
        lefts = rng.integers(0, 256, (2, 3, 32, 64)).astype(np.float32)
        rights = np.roll(lefts, -4, axis=-1)
        engine = ClassicalStereoEngine(MatchingConfig(**c), device="cpu")
        batch = engine.compute_disparity_maps(lefts, rights)
        for i in range(2):
            np.testing.assert_array_equal(
                batch[i].numpy(),
                engine.compute_disparity_map(lefts[i], rights[i]).numpy())

    def test_rejects_wrong_shape_and_cuda_impl_on_cpu(self):
        c = CONFIGS["kitti"]
        x = np.zeros((3, 32, 64), np.float32)
        with pytest.raises(ValueError, match="engine built for"):
            ClassicalStereoEngine(MatchingConfig(**c), device="cpu"
                                  ).compute_disparity_map(x[:, :16], x[:, :16])
        with pytest.raises(ValueError, match="impl='cuda'"):
            ClassicalStereoEngine(MatchingConfig(**c, impl="cuda"),
                                  device="cpu").compute_disparity_map(x, x)
        with pytest.raises(ValueError, match="unknown impl"):
            MatchingConfig(impl="pallas")
