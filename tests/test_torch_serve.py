"""The port's serving path: its PNG codec against PIL, the upload resize,
JPEG uploads against the JAX package's upload decode, and the HTTP server
with micro-batching, on the CPU."""

import io
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_tpu.serve.api import (
    decode_png_to_pipeline_image as jax_decode_upload)
from stereo_tpu.serve.api import quantize_disparity_u8 as jax_quantize

from stereo_tpu_torch.core.config import PipelineConfig
from stereo_tpu_torch.pipeline import DepthEstimationPipeline
from stereo_tpu_torch.serve import (BadRequestError, DepthEstimationServer,
                                    decode_png_to_pipeline_image,
                                    encode_disparity_png)
from stereo_tpu_torch.serve.api import quantize_disparity_u8
from stereo_tpu_torch.synthesis import RightViewSynthesis
from stereo_tpu_torch.utils.png import (decode_png, decode_png_rgb,
                                        encode_png)

import torch_threads

torch_threads.take_worker_share()

SHAPE = (48, 96)


def pil_png(array, mode, **save):
    buf = io.BytesIO()
    Image.fromarray(array, mode).save(buf, format="PNG", **save)
    return buf.getvalue()


def chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


# 16-bit grey that PIL clips to 255 where its high byte is not 0.
SIXTEEN_BIT = np.array([0, 1, 200, 255, 256, 300, 4096, 65535] * 2,
                       np.uint16).reshape(4, 4)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def interlaced_rgb_png(image):
    """An Adam7-interlaced 8-bit RGB PNG of ``image`` (filter type 0)."""
    h, w, _ = image.shape
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = np.asarray(image[y0::dy, x0::dx], np.uint8)
        for row in sub.reshape(sub.shape[0], -1):
            raw += b"\x00" + row.tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def filtered_png(image, ftype):
    """An 8-bit RGB PNG whose every row uses filter ``ftype``: an
    independent forward filter, so the decoder's inverse is checked."""
    h, w, bpp = image.shape
    rows = image.reshape(h, w * bpp).astype(np.int64)
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
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        out.append(ftype)
        out += ((cur - pred) % 256).astype(np.uint8).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


class TestPngCodec:
    @pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3),
                                               ("RGBA", 4)])
    def test_decodes_pil_output(self, mode, channels):
        rng = np.random.default_rng(channels)
        shape = (31, 45) if channels == 1 else (31, 45, channels)
        image = rng.integers(0, 256, shape).astype(np.uint8)
        for save in ({}, {"optimize": True}, {"compress_level": 0}):
            got = decode_png(pil_png(image, mode, **save))
            np.testing.assert_array_equal(got.reshape(shape), image)

    @pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
    def test_every_filter_type(self, ftype):
        image = np.random.default_rng(ftype).integers(
            0, 256, (9, 13, 3)).astype(np.uint8)
        data = filtered_png(image, ftype)
        np.testing.assert_array_equal(decode_png(data), image)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(data))), image)

    @pytest.mark.parametrize("shape", [(17, 29), (17, 29, 3)])
    def test_encoder_read_by_pil(self, shape):
        image = np.random.default_rng(7).integers(0, 256, shape).astype(
            np.uint8)
        with Image.open(io.BytesIO(encode_png(image))) as im:
            np.testing.assert_array_equal(np.asarray(im), image)

    @pytest.mark.parametrize("make,refused", [
        (lambda: b"not a png", True),
        (lambda: pil_png(SIXTEEN_BIT, "I;16"), False),
        (lambda: pil_png(np.arange(16, dtype=np.uint8).reshape(4, 4), "P"),
         False),
        (lambda: interlaced_rgb_png(np.random.default_rng(12).integers(
            0, 256, (5, 7, 3))), False),
        (lambda: pil_png(np.zeros((4, 4), np.uint8), "L")[:-9]
         + b"corrupted", True),
        (lambda: encode_png(np.zeros((4, 4), np.uint8))[:40], True),
    ], ids=["garbage", "16bit", "palette", "interlaced", "bad_crc",
            "truncated"])
    def test_unsupported_or_broken_raises_bad_request(self, make, refused):
        """Garbage and broken files are a ``BadRequestError``.  16-bit,
        palette and interlaced PNGs, refused until the decoder took them,
        decode to exactly what PIL's ``convert("RGB")`` (the JAX server's
        decode) gives, as uploads too."""
        data = make()
        if refused:
            with pytest.raises(BadRequestError):
                decode_png(data)
            return
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(decode_png_rgb(data), want)
        got = decode_png_to_pipeline_image(data, want.shape[:2], "cpu")
        np.testing.assert_array_equal(got.numpy().transpose(1, 2, 0), want)


class TestUpload:
    def test_same_size_upload_is_identity(self):
        image = np.random.default_rng(8).integers(
            0, 256, (*SHAPE, 3)).astype(np.uint8)
        got = decode_png_to_pipeline_image(pil_png(image, "RGB"), SHAPE, "cpu")
        assert got.dtype == torch.uint8
        # An image library's same-size bilinear resize is the identity too.
        with Image.open(io.BytesIO(pil_png(image, "RGB"))) as im:
            pil = np.asarray(im.resize((SHAPE[1], SHAPE[0]), Image.BILINEAR))
        np.testing.assert_array_equal(pil, image)
        np.testing.assert_array_equal(got.numpy().transpose(1, 2, 0), image)

    def test_grey_upload_becomes_rgb(self):
        image = np.random.default_rng(9).integers(0, 256, SHAPE).astype(
            np.uint8)
        got = decode_png_to_pipeline_image(pil_png(image, "L"), SHAPE, "cpu")
        assert got.shape == (3, *SHAPE)
        for c in range(3):
            np.testing.assert_array_equal(got[c].numpy(), image)

    @pytest.mark.parametrize("src", [(96, 192), (61, 133), (30, 50)])
    def test_resize_tracks_pil_bilinear(self, src):
        rng = np.random.default_rng(10)
        base = rng.integers(0, 256, (src[0] // 4 + 1, src[1] // 4 + 1, 3))
        image = np.repeat(np.repeat(base, 4, 0), 4, 1)[:src[0], :src[1]]
        image = image.astype(np.uint8)
        got = decode_png_to_pipeline_image(pil_png(image, "RGB"), SHAPE, "cpu")
        with Image.open(io.BytesIO(pil_png(image, "RGB"))) as im:
            want = np.asarray(im.resize((SHAPE[1], SHAPE[0]), Image.BILINEAR))
        diff = np.abs(got.numpy().transpose(1, 2, 0).astype(np.int32)
                      - want.astype(np.int32))
        # Both antialias with the same triangle filter; PIL resamples in
        # fixed point and rounds once more, so results differ by at most
        # one grey level.
        assert diff.max() <= 1

    def test_quantize_matches_jax(self):
        d = np.array([[-3.0, 0.5, 1.5, 2.5, 254.6, 300.0, 7.49]], np.float32)
        np.testing.assert_array_equal(
            quantize_disparity_u8(torch.from_numpy(d)).numpy(), jax_quantize(d))
        png = encode_disparity_png(torch.from_numpy(d))
        np.testing.assert_array_equal(decode_png(png)[..., 0], jax_quantize(d))


def pil_jpeg(array, **save):
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, format="JPEG", **save)
    return buf.getvalue()


def blocky(shape, seed):
    """An (H, W, 3) image of 4x4 blocks (``test_resize_tracks_pil_bilinear``'s
    kind of image)."""
    base = np.random.default_rng(seed).integers(
        0, 256, (shape[0] // 4 + 1, shape[1] // 4 + 1, 3))
    image = np.repeat(np.repeat(base, 4, 0), 4, 1)[:shape[0], :shape[1]]
    return image.astype(np.uint8)


class TestJpegUpload:
    @pytest.mark.parametrize("progressive", [False, True],
                             ids=["baseline", "progressive"])
    @pytest.mark.parametrize("subsampling", [0, 1, 2])
    def test_at_pipeline_shape_equals_jax(self, subsampling, progressive):
        """Decoded as the JAX server decodes it (PIL), with no resize:
        equal in every element."""
        data = pil_jpeg(blocky(SHAPE, subsampling), quality=90,
                        subsampling=subsampling, progressive=progressive)
        got = decode_png_to_pipeline_image(data, SHAPE, "cpu")
        want = jax_decode_upload(data, SHAPE)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("src", [(96, 192), (61, 133), (30, 50)])
    @pytest.mark.parametrize("subsampling", [0, 1, 2])
    def test_resized_within_one_level_of_jax(self, subsampling, src):
        """The same decode, then the device resize against PIL's bilinear:
        at most one grey level apart, as ``test_resize_tracks_pil_bilinear``
        bounds PNG uploads."""
        data = pil_jpeg(blocky(src, 10 + subsampling), quality=95,
                        subsampling=subsampling)
        got = decode_png_to_pipeline_image(data, SHAPE, "cpu").numpy()
        want = jax_decode_upload(data, SHAPE)
        assert got.shape == want.shape == (3, *SHAPE)
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


@pytest.fixture(scope="module")
def server():
    synthesis = RightViewSynthesis(output_shape=SHAPE, seed=0,
                                   model_full_shape=(128, 256),
                                   model_down_shape=(32, 64), device="cpu")
    config = PipelineConfig(image_shape=SHAPE, max_disparity=16)
    pipeline = DepthEstimationPipeline(config, synthesis=synthesis,
                                       device="cpu")
    srv = DepthEstimationServer(config, pipeline=pipeline, micro_batch=2,
                                device="cpu")
    host, port = srv.start("127.0.0.1", 0)
    yield srv, f"http://{host}:{port}/"
    srv.shutdown()


def post(url, data, ctype="image/png"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


class TestServer:
    def test_concurrent_posts_are_answered(self, server):
        srv, url = server
        rng = np.random.default_rng(11)
        uploads = [encode_png(rng.integers(0, 256, (*SHAPE, 3)).astype(
            np.uint8)) for _ in range(3)]
        replies = [None] * 3

        def worker(i):
            replies[i] = post(url, uploads[i])

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        for status, body in replies:
            assert status == 200
            assert decode_png(body).shape == (*SHAPE, 1)
        assert srv.batcher.frames_run >= 3

    def test_multipart_and_get(self, server):
        _, url = server
        png = encode_png(np.zeros((*SHAPE, 3), np.uint8))
        body = (b"--XyZ\r\nContent-Disposition: form-data; name=\"file\"; "
                b"filename=\"a.png\"\r\nContent-Type: image/png\r\n\r\n"
                + png + b"\r\n--XyZ--\r\n")
        status, reply = post(url, body, "multipart/form-data; boundary=XyZ")
        assert status == 200 and decode_png(reply).shape == (*SHAPE, 1)
        with urllib.request.urlopen(url, timeout=30) as resp:
            info = json.loads(resp.read())
        assert info["image_shape"] == list(SHAPE) and info["device"] == "cpu"

    @pytest.mark.parametrize("make", [
        lambda: pil_png(np.full(SHAPE, 300, np.uint16), "I;16"),
        lambda: pil_png(np.random.default_rng(13).integers(
            0, 256, SHAPE).astype(np.uint8), "P"),
        lambda: interlaced_rgb_png(np.random.default_rng(14).integers(
            0, 256, (*SHAPE, 3))),
    ], ids=["16bit", "palette", "interlaced"])
    def test_png_kinds_the_jax_server_reads_are_served(self, server, make):
        """Uploads the port answered 400 to before its decoder took them."""
        _, url = server
        status, body = post(url, make())
        assert status == 200 and decode_png(body).shape == (*SHAPE, 1)

    def test_jpeg_upload_and_multipart_jpeg_are_served(self, server):
        """A JPEG upload, raw and as a multipart file: 200 and a disparity
        PNG of the pipeline's shape."""
        _, url = server
        data = pil_jpeg(blocky((61, 133), 15), quality=90, subsampling=2)
        status, reply = post(url, data, "image/jpeg")
        assert status == 200 and decode_png(reply).shape == (*SHAPE, 1)
        body = (b"--XyZ\r\nContent-Disposition: form-data; name=\"file\"; "
                b"filename=\"a.jpg\"\r\nContent-Type: image/jpeg\r\n\r\n"
                + data + b"\r\n--XyZ--\r\n")
        status, reply = post(url, body, "multipart/form-data; boundary=XyZ")
        assert status == 200 and decode_png(reply).shape == (*SHAPE, 1)

    def test_jpeg_is_400_naming_the_format(self, server):
        _, url = server
        with pytest.raises(urllib.error.HTTPError) as err:
            post(url, b"\xff\xd8\xff\xe0" + bytes(64), "image/jpeg")
        assert err.value.code == 400
        assert b"JPEG" in err.value.read()

    def test_bad_payload_is_400(self, server):
        _, url = server
        with pytest.raises(urllib.error.HTTPError) as err:
            post(url, b"definitely not a png")
        assert err.value.code == 400

    def test_shutdown_releases_the_port(self):
        synthesis = RightViewSynthesis(output_shape=SHAPE, seed=0,
                                       model_full_shape=(128, 256),
                                       model_down_shape=(32, 64), device="cpu")
        config = PipelineConfig(image_shape=SHAPE, max_disparity=16)
        srv = DepthEstimationServer(config, micro_batch=2, device="cpu",
                                    pipeline=DepthEstimationPipeline(
                                        config, synthesis=synthesis,
                                        device="cpu"))
        host, port = srv.start("127.0.0.1", 0)
        status, _ = post(f"http://{host}:{port}/",
                         encode_png(np.zeros((*SHAPE, 3), np.uint8)))
        assert status == 200
        srv.shutdown()
        assert not srv.batcher._worker.is_alive()
        with pytest.raises(urllib.error.URLError):
            post(f"http://{host}:{port}/", b"x")
