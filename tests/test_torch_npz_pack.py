"""``stereo_tpu_torch.utils.npz_pack``: a packed npz unpacks to the same
keys, dtypes, shapes and bytes, and the byte planes shrink float16
weights further than the npz's own compression."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

from stereo_tpu_torch.utils import npz_pack

import torch_threads

torch_threads.take_worker_share()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "['params']['Conv_0']['kernel']": rng.standard_normal(
            (3, 3, 8, 16)).astype(np.float16),
        "['params']['Conv_0']['bias']": rng.standard_normal(16).astype(
            np.float32),
        "['batch_stats']['mean']": rng.standard_normal(5).astype(">f4"),
        "__meta__down_shape": np.array([96, 320], np.int64),
        "__meta__prob_volume_scale": np.array(4, np.int64),
        "empty": np.zeros((0, 3), np.float16),
        "mask": rng.uniform(size=7) < 0.5,
        "bytes": rng.integers(0, 256, 11).astype(np.uint8),
    }


def _assert_same(got: dict, want: dict):
    assert list(got) == list(want)
    for key, a in want.items():
        b = got[key]
        assert (b.dtype, b.shape) == (a.dtype, a.shape), key
        assert b.tobytes() == a.tobytes(), key


@pytest.mark.parametrize("dtype", ["<f2", ">f2", "<f4", "<i8", "|u1", "|b1"])
def test_planes_round_trip(dtype):
    a = np.random.default_rng(1).integers(0, 255, (4, 6)).astype(dtype)
    data = npz_pack._planes(a)
    assert len(data) == a.nbytes
    back = npz_pack._from_planes(data, a.dtype, a.shape)
    assert back.dtype == a.dtype and back.tobytes() == a.tobytes()


def test_high_bytes_first():
    a = np.array([0x1234, 0x5678], "<u2")
    assert npz_pack._planes(a) == bytes([0x12, 0x56, 0x34, 0x78])
    assert npz_pack._planes(a.astype(">u2")) == bytes([0x12, 0x56, 0x34,
                                                       0x78])


def test_pack_unpack_bit_for_bit(tmp_path):
    want = _arrays()
    src, packed, out = (str(tmp_path / n) for n in ("a.npz", "a.pack",
                                                     "b.npz"))
    np.savez_compressed(src, **want)
    npz_pack.pack(src, packed)
    _assert_same(npz_pack.load_packed(packed), want)
    npz_pack.unpack(packed, out)
    with np.load(out) as data:
        _assert_same({k: data[k] for k in data.files}, want)


def test_smaller_than_the_npz(tmp_path):
    # Weights as trained weights are spread: normal, float16.
    w = (np.random.default_rng(2).standard_normal(200_000) * 0.02).astype(
        np.float16)
    buf = io.BytesIO()
    np.savez_compressed(buf, w=w)
    src = tmp_path / "w.npz"
    src.write_bytes(buf.getvalue())
    npz_pack.pack(str(src), str(tmp_path / "w.pack"))
    assert (tmp_path / "w.pack").stat().st_size < 0.95 * len(buf.getvalue())


def test_command_line(tmp_path):
    want = _arrays()
    np.savez(tmp_path / "a.npz", **want)
    for args in (("pack", "a.npz", "a.pack"), ("unpack", "a.pack", "b.npz")):
        subprocess.run([sys.executable, "-m", "stereo_tpu_torch.utils.npz_pack",
                        *args], cwd=tmp_path, check=True,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    with np.load(tmp_path / "b.npz") as data:
        _assert_same({k: data[k] for k in data.files}, want)
