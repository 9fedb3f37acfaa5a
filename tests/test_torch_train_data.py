"""The port's training data against the JAX package's on the same seeds
and files: the key stream (``train.prng``) bit for bit against
``jax.random``; generated scenes and the synthetic camera; the mean pool
and the oracle warp; 16-bit PNG decoding against PIL; and both KITTI
datasets and the batch iterator on the same files."""

import io
import os
import struct
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stereo_tpu import _native as jax_native
from stereo_tpu.pipeline.camera import \
    SyntheticStereoCamera as JaxSyntheticStereoCamera
from stereo_tpu.train import synthetic as jax_synthetic
from stereo_tpu.train.kitti_dataset import \
    KittiStereoDataset as JaxKittiStereoDataset
from stereo_tpu.train.kitti_dataset import batch_iterator as jax_batch_iterator
from stereo_tpu.train.stereo_trainer import \
    Kitti2015StereoDataset as JaxKitti2015StereoDataset

from stereo_tpu_torch.pipeline.camera import SyntheticStereoCamera
from stereo_tpu_torch.train import prng, synthetic
from stereo_tpu_torch.train.kitti_dataset import (KittiStereoDataset,
                                                  batch_iterator)
from stereo_tpu_torch.train.stereo_trainer import (Kitti2015StereoDataset,
                                                   read_disparity_png)
from stereo_tpu_torch.utils import png

import torch_threads

torch_threads.take_worker_share()

FIXTURE_DRIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "fixtures", "kitti", "2011_09_26",
                             "2011_09_26_drive_0001_sync")

# --- the key stream ----------------------------------------------------------

SEEDS = [0, 1, 20260817, 2 ** 32 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_keys_split_fold_in_bits_equal_jax(seed):
    key, ours = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(key, np.int64))
    for n in (1, 2, 3, 5, 7):
        np.testing.assert_array_equal(
            prng.split(ours, n).numpy(),
            np.asarray(jax.random.split(key, n), np.int64))
    for data in (0, 1, 5, 12345, 2 ** 31 + 3):
        np.testing.assert_array_equal(
            prng.fold_in(ours, data).numpy(),
            np.asarray(jax.random.fold_in(key, data), np.int64))
    for shape in ((), (6,), (3, 6), (3, 1, 1), (5, 7, 3)):
        np.testing.assert_array_equal(
            prng.random_bits(ours, shape).numpy(),
            np.asarray(jax.random.bits(key, shape, jnp.uint32), np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_uniform_equals_jax(seed):
    """Bit for bit, at the bounds and shapes the generator draws with."""
    key, ours = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for shape in ((), (6,), (3, 6), (3, 1, 1)):
        for lo, hi in ((0.0, 1.0), (60.0, 195.0), (-28.0, 28.0), (2.0, 7.0),
                       (0.0, 2 * np.pi), (6.0, 58.0), (64 / 6, 64 / 2)):
            np.testing.assert_array_equal(
                prng.uniform(ours, shape, lo, hi).numpy(),
                np.asarray(jax.random.uniform(key, shape, minval=lo,
                                              maxval=hi)))


def test_prng_batched_keys_equal_vmap():
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    ours = prng.split(prng.PRNGKey(7), 4)
    np.testing.assert_array_equal(
        prng.split(ours, 3).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys),
                   np.int64))
    np.testing.assert_array_equal(
        prng.uniform(ours, (6,), 2.0, 7.0).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (6,), minval=2.0, maxval=7.0))(keys)))


# --- scenes -------------------------------------------------------------------

_jax_scene = jax.jit(jax_synthetic.synthetic_stereo_scene,
                     static_argnums=(1, 2, 5, 6, 7))


def jax_scene(seed, index, h, w, depth_prior, camera_t):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), index)
    return [np.asarray(a) for a in _jax_scene(key, h, w, 6.0, 58.0, 6,
                                              depth_prior, True, camera_t)]


def port_scene(seed, index, h, w, depth_prior, camera_t):
    key = prng.fold_in(prng.PRNGKey(seed), index)
    return [a.numpy() for a in synthetic.synthetic_stereo_scene(
        key, h, w, 6.0, 58.0, 6, depth_prior, True, camera_t)]


@pytest.mark.parametrize("camera_t", [0.0, 0.37])
@pytest.mark.parametrize("index", [0, 1, 2])
def test_random_disparity_scene_equals_jax(index, camera_t):
    """Random-disparity scenes (the stereo family): both ground truths
    equal; the views within 0.06 grey levels on all but 1e-4 of the
    pixels.  The rest are the hash noise's wraps: it multiplies a sine by
    43758 and keeps the fraction, so a sine one float32 step apart can
    land across an integer and move the pixel by up to the noise's full
    swing, 14 grey levels."""
    got = port_scene(20260817, index, 96, 320, False, camera_t)
    want = jax_scene(20260817, index, 96, 320, False, camera_t)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[:2], want[:2]):
        diff = np.abs(a - b)
        assert a.shape == (3, 96, 320) and a.dtype == np.float32
        assert (diff > 0.06).mean() <= 1e-4 and diff.max() <= 14.1


def assert_views_near(a, b):
    """Views of scenes whose world columns differ from JAX's by a float32
    step somewhere: XLA's CPU code fuses some products and sums into FMAs
    and takes ``r ** 1.5`` of the ground ramp with its own float32 power,
    and which it does depends on the shape and the surrounding program.
    A column one step off moves the hash noise (a sine times 43758, its
    fraction kept) by up to its swing, 14 grey levels; the rest of the
    texture does not move.  So: within 14.1 everywhere and within 0.1 grey
    levels on at least half the pixels."""
    diff = np.abs(a - np.asarray(b))
    assert diff.max() <= 14.1 and (diff <= 0.1).mean() >= 0.5


@pytest.mark.parametrize("camera_t", [0.0, 0.37])
def test_depth_prior_scene_equals_jax(camera_t):
    """Depth-prior scenes (the single-view family): both ground truths
    within 1e-5 px (a float32 step of the ramp, see ``assert_views_near``)
    and the views near JAX's."""
    got = port_scene(20260817, 3, 96, 320, True, camera_t)
    want = jax_scene(20260817, 3, 96, 320, True, camera_t)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for a, b in zip(got[:2], want[:2]):
        assert_views_near(a, b)


def test_right_frame_ground_truth_and_motion():
    """On a background-only scene both ground truths are its one
    disparity; a rig one baseline to the right has the t=0 right view as
    its left view."""
    key = prng.PRNGKey(3)
    _, _, gt, gt_r = synthetic.synthetic_stereo_scene(
        key, 64, 256, n_layers=1, with_right_frame_gt=True)
    d = float(gt_r[0, 0])
    assert 6.0 <= d <= 58.0
    assert torch.all(gt_r == d) and torch.all(gt == d)
    t1 = synthetic.synthetic_stereo_scene(key, 64, 256, camera_t=1.0)
    t0 = synthetic.synthetic_stereo_scene(key, 64, 256, camera_t=0.0)
    np.testing.assert_array_equal(t1[0].numpy(), t0[1].numpy())


def test_batch_mean_pool_and_oracle_warp_equal_jax():
    """The trainers' batch (vmapped scenes, depth prior, right-frame GT)
    and the two helpers on it, against JAX: GT within 1e-5 px, views near
    JAX's, the helpers within 1e-5 of JAX on the same input."""
    got = [a.numpy() for a in synthetic.synthetic_stereo_batch(
        prng.PRNGKey(11), 2, 64, 128, depth_prior=True,
        with_right_frame_gt=True)]
    want = [np.array(a) for a in jax.jit(
        jax_synthetic.synthetic_stereo_batch, static_argnums=range(1, 9))(
        jax.random.PRNGKey(11), 2, 64, 128, 6.0, 58.0, 6, True, True)]
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for a, b in zip(got[:2], want[:2]):
        assert_views_near(a, b)
    left = want[0] / 255.0
    np.testing.assert_allclose(
        synthetic.mean_pool_nchw(torch.from_numpy(left), 4).numpy(),
        np.asarray(jax_synthetic._mean_pool_nchw(left, 4)), rtol=0,
        atol=1e-6)
    np.testing.assert_allclose(
        synthetic.oracle_warp_batch(torch.from_numpy(left),
                                    torch.from_numpy(want[3])).numpy(),
        np.asarray(jax_synthetic.oracle_warp_batch(left, want[3])),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("kwargs", [
    dict(depth_prior=False), dict(depth_prior=True, return_right_view=False),
    dict(drive_speed=0.25)], ids=["stereo", "single_view", "drive"])
def test_synthetic_camera_equals_jax(kwargs):
    """Frames, withheld right views and ground truth of the JAX camera:
    ground truth within 1e-5 px (equal in the stereo family), views near
    JAX's (``assert_views_near``)."""
    args = dict(n_frames=2, height=64, width=128, seed=5, **kwargs)
    ours, theirs = SyntheticStereoCamera(**args), JaxSyntheticStereoCamera(
        **args)
    assert ours.get_image_shape() == theirs.get_image_shape() == (64, 128)
    assert ours.get_disparity_boundaries() == (0, 64)
    assert (ours.focal_length(), ours.baseline()) == (720.0, 0.54)
    frames = list(zip(ours.stream_image_pairs_with_gt_disparity(),
                      theirs.stream_image_pairs_with_gt_disparity()))
    assert len(frames) == 2
    for (left, right, gt), (j_left, j_right, j_gt) in frames:
        assert (right is None) == (j_right is None)
        if kwargs == dict(depth_prior=False):
            np.testing.assert_array_equal(gt, np.asarray(j_gt))
        np.testing.assert_allclose(gt, np.asarray(j_gt), rtol=0, atol=1e-5)
        assert_views_near(left, j_left)
        if right is not None:
            assert_views_near(right, j_right)


# --- 16-bit PNG ---------------------------------------------------------------

def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def png16(image, ftype):
    """A 16-bit grey (2-D) or RGB PNG whose every row uses filter
    ``ftype``, filtered here byte by byte (2 bytes a sample)."""
    h, w = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    rows = image.astype(">u2").view(np.uint8).reshape(h, -1).astype(np.int64)
    bpp = 2 * channels
    out = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out.append(ftype)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0 if channels == 1 else 2,
                       0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(out))) + _chunk(b"IEND",
                                                                   b""))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png16_every_filter_type(ftype, channels):
    """Native and Python decoders against PIL on 16-bit images of every
    filter type: equal uint16 samples."""
    rng = np.random.default_rng(ftype + 10 * channels)
    shape = (9, 13) if channels == 1 else (9, 13, 3)
    image = rng.integers(0, 65536, shape).astype(np.uint16)
    data = png16(image, ftype)
    for decode in (png.decode_png, png.decode_png_python):
        got = decode(data)
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got.reshape(shape), image)
    with Image.open(io.BytesIO(data)) as im:
        pil = np.asarray(im)
    if channels == 1:   # PIL reads 16-bit RGB as 8-bit; grey it keeps
        np.testing.assert_array_equal(pil, image)


def test_disparity_png_scaled_by_bit_depth(tmp_path):
    """KITTI's uint16 ground truth is disparity * 256, scaled because the
    header says 16 bits, even when every value is small; an 8-bit map is
    not scaled."""
    d16, d8 = str(tmp_path / "d16.png"), str(tmp_path / "d8.png")
    Image.fromarray(np.full((8, 16), 256, np.uint16)).save(d16)
    Image.fromarray(np.full((8, 16), 100, np.uint8), mode="L").save(d8)
    np.testing.assert_array_equal(read_disparity_png(d16), 1.0)
    np.testing.assert_array_equal(read_disparity_png(d8), 100.0)


# --- datasets -----------------------------------------------------------------

def jax_native_loaded(timeout: float = 60.0):
    """The JAX package's native library, loaded (it decodes and resizes
    the JAX dataset's images; its NumPy and PIL fallbacks differ).  It
    builds in place under a fixed name without a lock, so a process beside
    others building it can record a failed load: wait for the racing build
    and load again, bounded, then insist on it."""
    deadline = time.monotonic() + timeout
    while not jax_native.available() and time.monotonic() < deadline:
        time.sleep(1.0)
        jax_native._build_error = None
    assert jax_native.available(), (
        f"stereo_tpu._native did not load: {jax_native.build_error()}")


def test_kitti_dataset_and_batches_equal_jax():
    """The fixture drive's items (padded full views, the 96x320 view, in
    0..1) and the shuffled batches equal the JAX package's."""
    jax_native_loaded()
    ours = KittiStereoDataset([FIXTURE_DRIVE])
    theirs = JaxKittiStereoDataset([FIXTURE_DRIVE])
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        for a, b in zip(ours[i], theirs[i]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert [a.shape for a in ours[0]] == [(3, 384, 1280), (3, 96, 320),
                                          (3, 384, 1280)]
    for drop_last, size in ((True, 2), (False, 3)):
        got = list(batch_iterator(ours, size, seed=3, drop_last=drop_last))
        want = list(jax_batch_iterator(theirs, size, seed=3,
                                       drop_last=drop_last))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_batch_iterator_raises_a_loader_fault():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise OSError("unreadable frame")
            return (np.zeros(2, np.float32),)

    with pytest.raises(OSError, match="unreadable"):
        list(batch_iterator(Broken(), 1, shuffle=False))


def test_kitti2015_dataset_equals_jax(tmp_path):
    """Triplets with 16-bit ground truth written by PIL: the same crops,
    drawn from the same numpy generator, and the same batches."""
    rng = np.random.default_rng(9)
    files = {"l": [], "r": [], "d": []}
    for i in range(3):
        for side in ("l", "r"):
            path = str(tmp_path / f"{side}{i}.png")
            Image.fromarray(rng.integers(0, 256, (40, 70, 3)).astype(
                np.uint8)).save(path)
            files[side].append(path)
        path = str(tmp_path / f"d{i}.png")
        Image.fromarray(rng.integers(0, 64 * 256, (40, 70)).astype(
            np.uint16)).save(path)
        files["d"].append(path)
    args = (files["l"], files["r"], files["d"])
    ours = Kitti2015StereoDataset(*args, crop=(32, 64))
    theirs = JaxKitti2015StereoDataset(*args, crop=(32, 64))
    for i in range(3):
        for a, b in zip(ours.load(i, np.random.default_rng(i)),
                        theirs.load(i, np.random.default_rng(i))):
            np.testing.assert_array_equal(a, b)
    got, want = list(ours.batches(2, seed=4)), list(theirs.batches(2, seed=4))
    assert len(got) == len(want) == 1
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    assert got[0][2].max() < 64 and got[0][2].dtype == np.float32
