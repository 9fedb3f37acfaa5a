"""The port's BMP, TIFF and GIF decoders (``stereo_tpu_torch/_native/
raster.cc``) and its PNM/PFM decoder (``utils/pnm.py``), through
``utils.image_io.decode_image_rgb`` / ``read_image_chw``, the stereo
trainer's ground truth (``Kitti2015StereoDataset.load``) and the server's
upload decode, against the JAX package, which reads every one of these
files with PIL (Pillow 12.1; libtiff 4.7 for compressed TIFF).

Files come from PIL (seeded noise and crops of the committed KITTI frame)
and, for the variants PIL opens but does not write, from the writers in
``tests/raster_files.py``: every BMP header, RLE, 16-bit and bitfields
BMP; TIFF in both byte orders, BigTIFF, tiles, planar configuration 2,
predictors 2 and 3, fill order 2, low depths, PackBits; GIF frames that do
not cover the screen; ``Pf``; PGM/PPM at odd maxvals.  Every comparison is
exact (tolerance 0).  Files PIL refuses are a ``BadRequestError`` (HTTP
400), and the variants PIL opens and the port does not are refused by
name.  ``tests/raster_pil_agreement.py`` adds thousands of damaged files.
"""

import hashlib
import io
import json
import os
import struct
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from stereo_tpu.serve.api import (
    decode_png_to_pipeline_image as jax_decode_upload)
from stereo_tpu.train.stereo_trainer import (
    Kitti2015StereoDataset as JaxKitti2015StereoDataset)
from stereo_tpu.utils import image_io as jax_image_io

from stereo_tpu_torch.serve import decode_png_to_pipeline_image
from stereo_tpu_torch.train.stereo_trainer import (Kitti2015StereoDataset,
                                                   read_disparity)
from stereo_tpu_torch.utils import image_io
from stereo_tpu_torch.utils.png import BadRequestError, encode_png

import torch_threads
from raster_files import (bmp_file, bmp_rle, bmp_rows, damaged, gif_file,
                          gif_lzw, retyped, tiff_file, zero_count)
from raster_pil import pil_decode

torch_threads.take_worker_share()

HERE = os.path.dirname(os.path.abspath(__file__))
FRAME = os.path.join(HERE, "fixtures", "kitti", "2011_09_26",
                     "2011_09_26_drive_0001_sync", "image_02", "data",
                     "0000000000.png")
FIXTURES = os.path.join(HERE, "fixtures", "raster")
with open(os.path.join(FIXTURES, "expected.json")) as _f:
    MANIFEST = json.load(_f)
H, W = 13, 21
_cache = {}


def kitti_crop(h: int = 37, w: int = 53, seed: int = 0) -> np.ndarray:
    """A seeded (h, w, 3) uint8 crop of the committed KITTI frame."""
    if "frame" not in _cache:
        with Image.open(FRAME) as im:
            _cache["frame"] = np.asarray(im.convert("RGB"))
    frame = _cache["frame"]
    rng = np.random.default_rng(seed)
    y = int(rng.integers(0, frame.shape[0] - h + 1))
    x = int(rng.integers(0, frame.shape[1] - w + 1))
    return np.ascontiguousarray(frame[y:y + h, x:x + w])


def noise(shape, high=256, dtype=np.uint8, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, high, shape).astype(dtype)


def pil_save(image: Image.Image, fmt: str, **save) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **save)
    return buf.getvalue()


def grey_ramp() -> np.ndarray:
    return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


def write(tmp_path, data: bytes, name: str = "image.img") -> str:
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


# --- the variants: name -> bytes ---------------------------------------------

def pnm_variants() -> dict:
    out = {}
    for maxval in (1, 15, 255, 300, 1023, 65535):
        v = noise((H, W, 3), maxval + 1, np.int64, seed=maxval)
        wide = ">u2" if maxval > 255 else np.uint8
        head = b"%d %d\n# a comment\n%d\n" % (W, H, maxval)
        out[f"P5_maxval{maxval}"] = b"P5\n" + head + v[..., 0].astype(
            wide).tobytes()
        out[f"P6_maxval{maxval}"] = b"P6 " + head + v.astype(wide).tobytes()
        out[f"P2_maxval{maxval}"] = b"P2\n" + head + b" ".join(
            b"%d" % x for x in v[..., 0].ravel())
        out[f"P3_maxval{maxval}"] = b"P3\n" + head + b"\n".join(
            b"%d %d %d" % tuple(p) for p in v.reshape(-1, 3))
    bits = noise((H, W), 2, seed=1)
    out["P1"] = b"P1\n%d %d\n" % (W, H) + b"\n".join(
        b" ".join(b"%d" % x for x in row) for row in bits)
    out["P1_unspaced"] = b"P1 %d %d\n" % (W, H) + b"".join(
        b"%d" % x for x in bits.ravel())
    out["P4"] = b"P4 %d %d\n" % (W, H) + np.packbits(
        bits.astype(np.uint8), axis=1).tobytes()
    f = np.random.default_rng(2).uniform(-20, 300, (H, W)).astype(np.float32)
    f[0, :4] = [np.nan, np.inf, -np.inf, 254.99]
    out["Pf_little_endian"] = b"Pf\n%d %d\n-1.0\n" % (W, H) + f[::-1].astype(
        "<f4").tobytes()
    out["Pf_big_endian"] = b"Pf\n%d %d\n2.5\n" % (W, H) + f[::-1].astype(
        ">f4").tobytes()
    out["P6_pil"] = pil_save(Image.fromarray(kitti_crop(seed=3)), "PPM")
    out["P5_pil_16bit"] = pil_save(Image.fromarray(
        noise((H, W), 65536, np.uint16, 4)), "PPM")
    return out


BITFIELDS_32 = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
                (0xFF000000, 0xFF00, 0xFF, 0),
                (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)]


def bmp_variants() -> dict:
    out = {}
    idx = noise((H, W), dtype=np.int64, seed=7)
    palette = noise((256, 3), seed=8)
    rgb = kitti_crop(H, W, seed=9)
    for header in (12, 40, 52, 56, 64, 108, 124):
        for bits in (1, 4, 8):
            v = idx % (1 << bits)
            out[f"bmp{header}_{bits}bit"] = bmp_file(
                W, H, bits, bmp_rows(v, bits), palette=palette[:1 << bits],
                header=header)
        out[f"bmp{header}_24bit"] = bmp_file(
            W, H, 24, bmp_rows(rgb[..., ::-1], 24), header=header)
        if header == 12:
            continue
        out[f"bmp{header}_8bit_top_down"] = bmp_file(
            W, H, 8, bmp_rows(idx[::-1], 8), palette=palette, header=header,
            top_down=True)
        out[f"bmp{header}_4bit_short_palette"] = bmp_file(
            W, H, 4, bmp_rows(idx % 16, 4), palette=palette[:5],
            header=header)
        x = np.dstack([rgb[..., ::-1], noise((H, W, 1), seed=10)])
        out[f"bmp{header}_32bit"] = bmp_file(W, H, 32, bmp_rows(x, 32),
                                             header=header)
        v16 = noise((H, W), 65536, np.uint16, seed=11)
        out[f"bmp{header}_16bit_555"] = bmp_file(W, H, 16, bmp_rows(v16, 16),
                                                 header=header)
        for name, masks in (("565", (0xF800, 0x7E0, 0x1F, 0)),
                            ("555", (0x7C00, 0x3E0, 0x1F, 0))):
            out[f"bmp{header}_16bit_bitfields_{name}"] = bmp_file(
                W, H, 16, bmp_rows(v16, 16), header=header, compression=3,
                masks=masks)
        for rle4 in (False, True):
            bits = 4 if rle4 else 8
            v = idx % (1 << bits) * (noise((H, W), 2, seed=12) > 0)
            v[:, 5:12] = 3
            out[f"bmp{header}_rle{bits}"] = bmp_file(
                W, H, bits, bmp_rle(v, rle4), palette=palette[:1 << bits],
                header=header, compression=2 if rle4 else 1)
    x = np.dstack([rgb[..., ::-1], noise((H, W, 1), seed=13)])
    for i, masks in enumerate(BITFIELDS_32):
        # A 40-byte header holds no alpha mask: PIL takes it as 0.
        for header in (40, 56, 124) if masks[3] == 0 else (56, 124):
            out[f"bmp{header}_32bit_bitfields{i}"] = bmp_file(
                W, H, 32, bmp_rows(x, 32), header=header, compression=3,
                masks=masks)
    # A pixel offset of 0: PIL reads from where its reading of the header,
    # masks and palette stopped.
    for name in ("bmp40_32bit_bitfields0", "bmp40_8bit", "bmp12_4bit",
                 "bmp40_rle8"):
        out[name + "_offset0"] = out[name][:10] + bytes(4) + out[name][14:]
    out["bmp_rle8_delta_eol_overflow"] = bmp_file(
        8, 4, 8, bytes([3, 7, 0, 2, 9, 9, 1, 1, 2, 3, 0, 0, 12, 5, 0, 5,
                        1, 2, 3, 4, 5, 0, 0, 8, 6, 0, 1]),
        palette=palette, compression=1)
    out["bmp_rle4_odd_absolute_run"] = bmp_file(
        8, 2, 4, bytes([0, 5, 0x12, 0x34, 0x50, 0, 3, 0x9A, 0, 0, 8, 0x11,
                        0, 1]), palette=palette[:16], compression=2)
    out["bmp_rle8_grey_palette"] = bmp_file(
        8, 2, 8, bytes([8, 7, 0, 0, 8, 200, 0, 1]), palette=grey_ramp(),
        compression=1)
    out["bmp_8bit_grey_palette"] = bmp_file(W, H, 8, bmp_rows(idx, 8),
                                            palette=grey_ramp())
    out["bmp_1bit_black_white"] = bmp_file(
        W, H, 1, bmp_rows(idx % 2, 1), palette=[(0, 0, 0), (255, 255, 255)])
    crop = Image.fromarray(kitti_crop(seed=14))
    for mode in ("1", "L", "P", "RGB"):
        image = crop.convert(mode)
        out[f"bmp_pil_{mode}"] = pil_save(image, "BMP")
    return out


def tiff_variants() -> dict:
    out = {}
    rgb = kitti_crop(H, W, seed=15)
    g16 = noise((H, W), 65536, np.uint16, seed=16)
    f32 = np.random.default_rng(17).uniform(-20, 300, (H, W)).astype(
        np.float32)
    s16 = (noise((H, W), 6000, np.int64, seed=18) - 3000).astype(np.int16)
    cmap = noise((256, 3), 65536, np.int64, seed=19)
    codecs = {"raw": 1, "lzw": 5, "deflate": 8, "packbits": 32773}
    for order, be in (("II", False), ("MM", True)):
        for cname, comp in codecs.items():
            k = f"tiff_{order}_{cname}"
            out[f"{k}_rgb8"] = tiff_file(rgb, 2, big_endian=be,
                                         compression=comp)
            out[f"{k}_grey16"] = tiff_file(g16, 1, big_endian=be,
                                           compression=comp)
            out[f"{k}_rgb16"] = tiff_file(
                noise((H, W, 3), 65536, np.uint16, 20), 2, big_endian=be,
                compression=comp)
            out[f"{k}_float32"] = tiff_file(f32, 1, big_endian=be,
                                            compression=comp)
            out[f"{k}_signed16"] = tiff_file(s16, 1, big_endian=be,
                                             compression=comp)
            out[f"{k}_tiles"] = tiff_file(rgb, 2, big_endian=be,
                                          compression=comp, tile=(16, 16))
            out[f"{k}_strips"] = tiff_file(rgb, 2, big_endian=be,
                                           compression=comp, rows_per_strip=4)
            out[f"{k}_planar2"] = tiff_file(rgb, 2, big_endian=be,
                                            compression=comp, planar=2,
                                            rows_per_strip=5)
            out[f"{k}_palette8"] = tiff_file(rgb[..., 0], 3, big_endian=be,
                                             compression=comp, colormap=cmap)
            out[f"{k}_cmyk"] = tiff_file(noise((H, W, 4), seed=21), 5,
                                         big_endian=be, compression=comp)
            out[f"{k}_min_is_white8"] = tiff_file(rgb[..., 1], 0,
                                                  big_endian=be,
                                                  compression=comp)
            for bits in (1, 2, 4):
                v = noise((H, W), 1 << bits, seed=bits)
                for photo in (0, 1, 3):
                    cm = cmap[:1 << bits] if photo == 3 else None
                    out[f"{k}_{bits}bit_photometric{photo}"] = tiff_file(
                        v, photo, bits=bits, big_endian=be, compression=comp,
                        colormap=cm)
                out[f"{k}_{bits}bit_fill_order2"] = tiff_file(
                    v, 1, bits=bits, big_endian=be, compression=comp,
                    fill_order=2)
            alpha = noise((H, W, 1), seed=22)
            for extra in (0, 1, 2):
                out[f"{k}_rgba_extra{extra}"] = tiff_file(
                    np.dstack([rgb, alpha]), 2, big_endian=be,
                    compression=comp, extra=(extra,))
            out[f"{k}_rgba16_associated"] = tiff_file(
                noise((H, W, 4), 65536, np.uint16, 23), 2, big_endian=be,
                compression=comp, extra=(1,))
            out[f"{k}_grey_alpha"] = tiff_file(np.dstack([rgb[..., 0], alpha]),
                                               1, big_endian=be,
                                               compression=comp, extra=(2,))
            if not be:   # PIL reads an MM BigTIFF as classic (refused below)
                out[f"{k}_bigtiff"] = tiff_file(rgb, 2, bigtiff=True,
                                                compression=comp)
        for cname in ("lzw", "deflate"):
            comp = codecs[cname]
            k = f"tiff_{order}_{cname}"
            out[f"{k}_predictor2_rgb8"] = tiff_file(
                rgb, 2, big_endian=be, compression=comp, predictor=2)
            out[f"{k}_predictor2_grey16"] = tiff_file(
                g16, 1, big_endian=be, compression=comp, predictor=2)
            out[f"{k}_predictor2_planar2"] = tiff_file(
                rgb, 2, big_endian=be, compression=comp, predictor=2,
                planar=2)
            out[f"{k}_predictor3_float32"] = tiff_file(
                f32, 1, big_endian=be, compression=comp, predictor=3)
            out[f"{k}_predictor3_float32_tiles"] = tiff_file(
                f32, 1, big_endian=be, compression=comp, predictor=3,
                tile=(16, 16))
    # Sizes past the C ints PIL and libtiff keep them in, which PIL reads:
    # no rows per strip (0xFFFFFFFF) for libtiff, and a BigTIFF's LONG8
    # strip or tile height past 2^63 for PIL's own raw decoder.
    out["tiff_lzw_rows_per_strip_unset"] = tiff_file(
        rgb, 2, compression=5, override_tags={278: (4, [2**32 - 1])})
    out["tiff_raw_bigtiff_rows_per_strip_2to64"] = tiff_file(
        rgb, 2, bigtiff=True, override_tags={278: (16, [2**64 - 1])})
    out["tiff_raw_bigtiff_tile_length_2to64"] = tiff_file(
        rgb, 2, bigtiff=True, tile=(16, 16),
        override_tags={323: (16, [2**64 - 1])})
    # A tile width of 0: PIL's decoder reads a tile from x = 0 to x = 0 as
    # the whole image (from the last offset), whatever its length.
    for th in (16, 0):
        out[f"tiff_raw_tile_width0_length{th}"] = tiff_file(
            rgb, 2, tile=(16, 16), override_tags={322: (4, [0]),
                                                  323: (4, [th])})
    # Entries of another type than the tag's, which PIL and libtiff read
    # each their own way: offsets and a colour map as BYTE (PIL iterates
    # the bytes), PlanarConfiguration as BYTE (neither 1 nor 2 to PIL),
    # Photometric 0 as FLOAT (0.0 is PIL's key 0), a Predictor past
    # libtiff's 16 bits (passed over), a fractional RowsPerStrip past the
    # image (any larger size to PIL).
    out["tiff_raw_strip_offsets_byte"] = retyped(tiff_file(rgb, 2), 273, 1)
    out["tiff_raw_planar_byte"] = retyped(tiff_file(rgb, 2), 284, 1)
    out["tiff_lzw_photometric_float"] = retyped(
        tiff_file(rgb[..., 1], 0, compression=5), 262, 11)
    out["tiff_lzw_palette_colormap_byte"] = retyped(
        tiff_file(rgb[..., 0] % 16, 3, bits=4, compression=5,
                  colormap=cmap[:16]), 320, 1)
    out["tiff_MM_lzw_predictor_slong"] = retyped(
        tiff_file(rgb, 2, big_endian=True, compression=5, predictor=2),
        317, 9)
    out["tiff_raw_rows_per_strip_double"] = tiff_file(
        rgb, 2, override_tags={278: (12, [1e300])})
    # No StripByteCounts: libtiff estimates the strip from the data less
    # the header and the directory.
    out["tiff_deflate_byte_counts_estimated"] = tiff_file(
        rgb, 2, compression=8, override_tags={279: None})
    # ... and where StripByteCounts holds no value (padded with a zero).
    out["tiff_deflate_byte_counts_none"] = zero_count(tiff_file(
        rgb, 2, compression=8), 279)
    # Compression and MaxSampleValue given once a sample, as TIFF before
    # 5.0 allowed; SMinSampleValue as a DOUBLE.
    out["tiff_lzw_compression_per_sample"] = tiff_file(
        rgb, 2, compression=5, override_tags={259: (3, [5, 5, 5]),
                                              281: (3, [255] * 3)})
    out["tiff_lzw_float_smin_double"] = tiff_file(
        f32, 1, compression=5, override_tags={340: (12, [-20.0])})
    for orientation in range(1, 9):
        out[f"tiff_orientation{orientation}"] = tiff_file(
            rgb, 2, orientation=orientation)
        out[f"tiff_lzw_orientation{orientation}"] = tiff_file(
            rgb, 2, compression=5, orientation=orientation)
    crop = Image.fromarray(kitti_crop(seed=24))
    images = {mode: crop.convert(mode) for mode in
              ("1", "L", "LA", "P", "RGB", "RGBA", "CMYK")}
    images["I;16"] = Image.fromarray(noise((37, 53), 65536, np.uint16, 25))
    images["F"] = Image.fromarray(np.random.default_rng(26).uniform(
        -10, 300, (37, 53)).astype(np.float32))
    images["I"] = Image.fromarray(
        noise((37, 53), 140000, np.int64, 27).astype(np.int32) - 70000)
    for mode, image in images.items():
        for cname in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"):
            save = {} if cname == "raw" else {"compression": cname}
            out[f"tiff_pil_{mode}_{cname}"] = pil_save(image, "TIFF", **save)
    out["tiff_pil_rgb_lzw_predictor2"] = pil_save(
        images["RGB"], "TIFF", compression="tiff_lzw", predictor=2)
    out["tiff_pil_big_tiff"] = pil_save(images["RGB"], "TIFF", big_tiff=True)
    out["tiff_pil_I;16B_lzw"] = pil_save(Image.frombytes(
        "I;16B", (53, 37), noise((37, 53), 65536, np.uint16,
                                 28).astype(">u2").tobytes()), "TIFF",
        compression="tiff_lzw")
    return out


def gif_variants() -> dict:
    out = {}
    idx = noise((H, W), dtype=np.int64, seed=29)
    palette = noise((256, 3), seed=30)
    tables = {"global": (palette, None), "local": (None, palette),
              "both": (palette, palette[::-1]), "none": (None, None),
              "global_grey_ramp": (grey_ramp(), None),
              "local_grey_ramp": (palette, grey_ramp())}
    for name, (gp, lp) in tables.items():
        for interlace in (False, True):
            for transparency in (None, 5):
                k = (f"gif_{name}{'_interlaced' if interlace else ''}"
                     f"{'_transparent' if transparency is not None else ''}")
                kw = dict(global_palette=gp, local_palette=lp,
                          transparency=transparency, interlace=interlace)
                out[k] = gif_file((W, H), (0, 0), idx, **kw)
                out[k + "_partial_frame"] = gif_file((W + 5, H + 4), (3, 2),
                                                     idx, **kw)
                out[k + "_frame_past_screen"] = gif_file((W, H), (6, 4), idx,
                                                         **kw)
    for bits in range(2, 9):
        v = (idx % (1 << bits)).astype(np.uint8)
        out[f"gif_min_code_size{bits}"] = gif_file(
            (W, H), (0, 0), v, global_palette=palette[:1 << bits],
            min_bits=bits)
        out[f"gif_min_code_size{bits}_short_palette"] = gif_file(
            (W, H), (0, 0), v, global_palette=palette[:2], min_bits=bits)
    crop = Image.fromarray(kitti_crop(seed=31))
    for mode in ("P", "L", "1", "RGB"):
        for interlace in (False, True):
            out[f"gif_pil_{mode}{'_interlaced' if interlace else ''}"] = \
                pil_save(crop.convert(mode), "GIF", interlace=interlace)
    return out


def all_variants() -> dict:
    if "variants" not in _cache:
        _cache["variants"] = {**pnm_variants(), **bmp_variants(),
                              **tiff_variants(), **gif_variants()}
    return _cache["variants"]


def names(prefix: str) -> list:
    return sorted(k for k in all_variants() if k.startswith(prefix))


VARIANTS = sorted(all_variants())


@pytest.mark.parametrize("name", VARIANTS)
def test_reads_like_jax(tmp_path, name):
    """``read_image_chw`` and ``decode_image_rgb`` of the file equal the JAX
    package's ``read_image_chw`` (PIL's ``convert("RGB")``) in every
    element, and the trainer's ground truth equals JAX's reading of it."""
    data = all_variants()[name]
    path = write(tmp_path, data)
    want = jax_image_io.read_image_chw(path)
    got = image_io.read_image_chw(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        image_io.decode_image_rgb(data).transpose(2, 0, 1), want)
    _, want_disp = pil_decode(data)
    np.testing.assert_array_equal(read_disparity(path), want_disp)


def test_every_variant_is_one_pil_opens():
    """None of the variants above is a file PIL refuses."""
    refused = [k for k, v in all_variants().items()
               if isinstance(pil_decode(v)[0], Exception)]
    assert refused == []


# --- the stereo trainer's ground truth ---------------------------------------

def ground_truth_files() -> dict:
    """Seeded disparities (multiples of 1/256 in 0..64, some missing) in the
    formats of the stereo datasets' ground truth."""
    rng = np.random.default_rng(32)
    disp = np.round(rng.uniform(0, 64, (40, 64)) * 256) / 256
    disp[rng.uniform(0, 1, disp.shape) < 0.3] = 0
    d32 = disp.astype(np.float32)
    d16 = np.round(disp * 256).astype(np.uint16)
    d8 = np.round(disp).astype(np.uint8)
    return {
        "pfm": b"Pf\n64 40\n-1.0\n" + d32[::-1].astype("<f4").tobytes(),
        "pfm_big_endian": b"Pf\n64 40\n1.0\n" + d32[::-1].astype(
            ">f4").tobytes(),
        "float_tiff": tiff_file(d32, 1),
        "float_tiff_lzw_predictor3": tiff_file(d32, 1, compression=5,
                                               predictor=3),
        "float_tiff_deflate_mm": tiff_file(d32, 1, compression=8,
                                           big_endian=True),
        "pgm16": b"P5\n64 40\n65535\n" + d16.astype(">u2").tobytes(),
        "tiff16": tiff_file(d16, 1, compression=8, predictor=2),
        "bmp8_grey": bmp_file(64, 40, 8, bmp_rows(d8, 8),
                              palette=grey_ramp()),
        "bmp8_palette": bmp_file(64, 40, 8, bmp_rows(d8, 8),
                                 palette=noise((256, 3), seed=33)),
        "gif": gif_file((64, 40), (0, 0), d8, global_palette=grey_ramp()),
        "gif_palette": gif_file((64, 40), (0, 0), d8,
                                global_palette=noise((256, 3), seed=34)),
        "png16": pil_save(Image.fromarray(d16), "PNG"),
    }


@pytest.mark.parametrize("kind", sorted(ground_truth_files()))
def test_dataset_loads_like_jax(tmp_path, kind):
    """``Kitti2015StereoDataset.load`` equals JAX's in every element: the
    views (a PNG and a BMP of KITTI crops) and the ground truth, cropped at
    the same seeded corner."""
    gt = write(tmp_path, ground_truth_files()[kind], "disp.img")
    left = write(tmp_path, encode_png(kitti_crop(40, 64, seed=36)), "l.png")
    right = write(tmp_path, bmp_file(64, 40, 24, bmp_rows(
        kitti_crop(40, 64, seed=37)[..., ::-1], 24)), "r.bmp")
    ours = Kitti2015StereoDataset([left], [right], [gt], crop=(24, 48))
    theirs = JaxKitti2015StereoDataset([left], [right], [gt], crop=(24, 48))
    for seed in range(3):
        got = ours.load(0, np.random.default_rng(seed))
        want = theirs.load(0, np.random.default_rng(seed))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


# --- refusals ----------------------------------------------------------------

def refused_files() -> dict:
    """Files PIL refuses, each a ``BadRequestError`` for the port."""
    rgb = kitti_crop(H, W, seed=38)
    bmp = bmp_file(W, H, 24, bmp_rows(rgb[..., ::-1], 24))
    lzw = tiff_file(rgb, 2, compression=5)
    mm_lzw = tiff_file(rgb, 2, big_endian=True, compression=5)
    gif = gif_file((W, H), (0, 0), rgb[..., 0], global_palette=grey_ramp()[
        ::-1])
    return {
        "bmp_truncated": bmp[:-5],
        "bmp_header_size_20": bmp[:14] + b"\x14" + bmp[15:],
        "bmp_jpeg_compression": bmp_file(W, H, 24, b"\xff\xd8\xff" + bytes(99),
                                         compression=4),
        "bmp_png_compression": bmp_file(W, H, 24, b"\x89PNG" + bytes(99),
                                        compression=5),
        "bmp_rle_on_24bit": bmp_file(8, 2, 24, bytes([8, 1, 8, 2, 0, 1]),
                                     compression=1),
        "bmp_rle_ends_early": bmp_file(8, 4, 8, bytes([3, 7, 0, 0, 8, 1, 0, 1]),
                                       palette=noise((256, 3)),
                                       compression=1),
        "bmp_palette_over_256": bmp_file(W, H, 8, bmp_rows(rgb[..., 0], 8),
                                         palette=noise((300, 3))),
        "tiff_lzw_truncated": lzw[:len(lzw) // 3] + lzw[len(lzw) // 3:][-200:],
        "tiff_no_strips": tiff_file(rgb, 2)[:8] + b"\0\0",
        "tiff_mm_bigtiff": tiff_file(rgb, 2, big_endian=True, bigtiff=True),
        # A classic MM header with BigTIFF's version, which libtiff reads.
        "tiff_mm_lzw_version_43": mm_lzw[:3] + b"+" + mm_lzw[4:],
        # A tile's size wraps to 0 in 64 bits; one of 12.9 GB; rows per
        # strip and a raw tile's row stride past INT_MAX.
        "tiff_tile_size_wraps": tiff_file(
            np.dstack([rgb, rgb[..., :1]]), 2, extra=(2,), compression=5,
            tile=(16, 16), override_tags={322: (4, [2**31]),
                                          323: (4, [2**31])}),
        "tiff_tile_over_int_max_bytes": tiff_file(
            rgb, 2, compression=5, tile=(16, 16),
            override_tags={322: (3, [65535]), 323: (3, [65535])}),
        "tiff_rows_per_strip_over_int_max": tiff_file(
            rgb, 2, compression=8, override_tags={278: (4, [2**31])}),
        "tiff_raw_tile_stride_over_int_max": tiff_file(
            rgb, 2, bigtiff=True, tile=(16, 16),
            override_tags={322: (16, [2**62])}),
        # libtiff reads no Compression of type IFD; a fractional
        # RowsPerStrip within the image gives PIL float tile extents.
        "tiff_lzw_compression_ifd": retyped(lzw, 259, 13),
        "tiff_raw_rows_per_strip_float": tiff_file(
            rgb, 2, override_tags={278: (11, [4.0])}),
        "tiff_lzw_max_sample_value_differs": tiff_file(
            rgb, 2, compression=5, override_tags={281: (3, [255, 255, 9])}),
        "tiff_lzw_smin_two_for_one_sample": tiff_file(
            noise((H, W), seed=42), 1, compression=5,
            override_tags={340: (12, [0.0, 1.0])}),
        "tiff_lzw_samples_per_pixel_twice": tiff_file(
            rgb, 2, compression=5, override_tags={277: (3, [3, 3])}),
        "tiff_raw_tile_length_float": tiff_file(
            rgb, 2, tile=(16, 16), override_tags={323: (11, [1e30])}),
        # libtiff cannot estimate byte counts past an entry of a type of
        # no known size.
        "tiff_deflate_byte_counts_unknown_type": retyped(tiff_file(
            rgb, 2, compression=8,
            override_tags={279: None, 65000: (3, [1])}), 65000, 99),
        # PIL seeks to an entry's values past 2^63: an OverflowError.
        "tiff_bigtiff_value_offset_past_2to63": tiff_file(
            rgb, 2, bigtiff=True,
            override_tags={278: (16, [2**64 - 1])}).replace(
                struct.pack("<HHQQ", 278, 16, 1, 2**64 - 1),
                struct.pack("<HHQQ", 278, 16, 2, 2**64 - 1)),
        "tiff_raw_palette_fill_order2": tiff_file(
            noise((H, W), 16), 3, bits=4, colormap=noise((16, 3), 65536,
                                                         np.int64),
            fill_order=2),
        "gif_truncated": gif[:len(gif) // 2],
        "gif_code_stream_ends_early": gif_file(
            (W, H), (0, 0), rgb[..., 0], global_palette=grey_ramp()[::-1],
            stream=gif_lzw(rgb[..., 0].tobytes()[:100])),
        "gif_no_frame": b"GIF89a" + bytes(32),
        "pgm_truncated": b"P5 %d %d 255\n" % (W, H) + bytes(W * H - 1),
        "pgm_value_over_maxval": b"P2 2 1 15\n3 16\n",
        "pfm_colour": b"PF\n2 1\n-1.0\n" + bytes(24),
        "pfm_zero_scale": b"Pf\n2 1\n0.0\n" + bytes(8),
        "unknown_format": b"RIFF\0\0\0\0WEBPVP8 " + bytes(40),
    }


@pytest.mark.parametrize("name", sorted(refused_files()))
def test_files_pil_refuses_are_bad_requests(name):
    data = refused_files()[name]
    assert isinstance(pil_decode(data)[0], Exception)
    with pytest.raises(BadRequestError):
        image_io.decode_image_rgb(data)


def named_refusals() -> dict:
    """Variants PIL opens and the port refuses, with the name its message
    gives: TIFF compressions PIL reads through libtiff's other codecs, and
    photometrics the port does not convert.  (This libtiff has no WebP
    codec, so PIL neither writes nor reads a WebP TIFF here; the port
    refuses one by name all the same.)"""
    crop = Image.fromarray(kitti_crop(seed=39))
    return {
        "tiff_jpeg": (pil_save(crop, "TIFF", compression="jpeg"), "JPEG"),
        "tiff_group4": (pil_save(crop.convert("1"), "TIFF",
                                 compression="group4"), "CCITT"),
        "tiff_lzma": (pil_save(crop, "TIFF", compression="lzma"), "LZMA"),
        "tiff_zstd": (pil_save(crop, "TIFF", compression="zstd"), "ZSTD"),
        "tiff_ycbcr_lzw": (pil_save(crop.convert("YCbCr"), "TIFF",
                                    compression="tiff_lzw"), "YCbCr"),
        "tiff_cielab": (pil_save(crop.convert("LAB"), "TIFF"), "CIELab"),
    }


@pytest.mark.parametrize("name", sorted(named_refusals()))
def test_variants_pil_opens_are_refused_by_name(name):
    data, label = named_refusals()[name]
    assert not isinstance(pil_decode(data)[0], Exception)
    with pytest.raises(BadRequestError, match=f"TIFF: .*{label}"):
        image_io.decode_image_rgb(data)


# Pillow's own PNM headers, which its source labels "for test purposes
# only": PIL opens them, the port refuses them by their magic number.
PILLOW_TEST_PNMS = {b"P0CMYK": 4, b"PyP": 1, b"PyRGBA": 4, b"PyCMYK": 4}


@pytest.mark.parametrize("magic", sorted(PILLOW_TEST_PNMS))
def test_pillow_test_only_pnm_headers_are_refused(magic):
    data = magic + b" %d %d 255\n" % (W, H) + noise(
        (H, W, PILLOW_TEST_PNMS[magic]), seed=5).tobytes()
    with Image.open(io.BytesIO(data)) as im:
        im.load()
    with pytest.raises(BadRequestError, match=magic.decode()):
        image_io.decode_image_rgb(data)


@pytest.mark.parametrize("seed", range(4))
def test_damaged_files_decode_or_refuse_like_pil(seed):
    """Seeded truncations and flipped bytes of a few variants: where PIL
    decodes the file the port gives the same pixels, where it refuses the
    port refuses (``raster_pil_agreement.py`` runs thousands)."""
    rng = np.random.default_rng(seed)
    variants = all_variants()
    pool = [k for k in VARIANTS if "pil" not in k]
    for _ in range(60):
        name = pool[int(rng.integers(len(pool)))]
        data = damaged(variants[name], rng,
                       "truncate" if rng.integers(2) else "flip")
        want, _ = pil_decode(data)
        try:
            got = image_io.decode_image_rgb(data)
        except BadRequestError:
            got = None
        if isinstance(want, Exception):
            assert got is None, name
        else:
            assert got is not None and np.array_equal(got, want), name


# --- serving -----------------------------------------------------------------

SHAPE = (48, 96)
UPLOADS = {"image/bmp": lambda px: bmp_file(
               SHAPE[1], SHAPE[0], 24, bmp_rows(px[..., ::-1], 24)),
           "image/tiff": lambda px: tiff_file(px, 2, compression=5),
           "image/x-portable-pixmap": lambda px: b"P6 %d %d 255\n" % (
               SHAPE[1], SHAPE[0]) + px.tobytes(),
           "image/gif": lambda px: gif_file(
               SHAPE[::-1], (0, 0), px[..., 0], global_palette=grey_ramp())}


@pytest.mark.parametrize("ctype", sorted(UPLOADS))
def test_upload_decode_equals_jax_and_the_png_of_its_pixels(ctype):
    """At the pipeline's shape the upload tensor equals JAX's upload decode
    and the port's decode of a PNG of the same pixels."""
    px = kitti_crop(*SHAPE, seed=40)
    if ctype == "image/gif":
        px = np.repeat(px[..., :1], 3, axis=2)
    data = UPLOADS[ctype](px)
    got = decode_png_to_pipeline_image(data, SHAPE, "cpu").numpy()
    np.testing.assert_array_equal(got, jax_decode_upload(data, SHAPE))
    np.testing.assert_array_equal(got, decode_png_to_pipeline_image(
        encode_png(px), SHAPE, "cpu").numpy())


@pytest.fixture(scope="module")
def server():
    from stereo_tpu_torch.core.config import PipelineConfig
    from stereo_tpu_torch.pipeline import DepthEstimationPipeline
    from stereo_tpu_torch.serve import DepthEstimationServer
    from stereo_tpu_torch.synthesis import RightViewSynthesis

    synthesis = RightViewSynthesis(output_shape=SHAPE, seed=0,
                                   model_full_shape=(128, 256),
                                   model_down_shape=(32, 64), device="cpu")
    config = PipelineConfig(image_shape=SHAPE, max_disparity=16)
    pipeline = DepthEstimationPipeline(config, synthesis=synthesis,
                                       device="cpu")
    srv = DepthEstimationServer(config, pipeline=pipeline, micro_batch=2,
                                device="cpu")
    host, port = srv.start("127.0.0.1", 0)
    yield f"http://{host}:{port}/"
    srv.shutdown()


def post(url: str, data: bytes, ctype: str):
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def test_http_route_serves_each_format_and_answers_400(server):
    px = kitti_crop(61, 133, seed=41)
    uploads = {"image/bmp": bmp_file(133, 61, 24, bmp_rows(px[..., ::-1], 24)),
               "image/tiff": tiff_file(px, 2, compression=5),
               "image/x-portable-pixmap": b"P6 133 61 255\n" + px.tobytes(),
               "image/gif": gif_file((133, 61), (0, 0), px[..., 0],
                                     global_palette=grey_ramp())}
    for ctype, data in uploads.items():
        status, body = post(server, data, ctype)
        assert status == 200
        with Image.open(io.BytesIO(body)) as im:
            assert im.size == SHAPE[::-1]
    for name, data in (("BMP", refused_files()["bmp_truncated"]),
                       ("TIFF", named_refusals()["tiff_jpeg"][0]),
                       ("GIF", refused_files()["gif_truncated"]),
                       ("PNM", refused_files()["pgm_truncated"])):
        with pytest.raises(urllib.error.HTTPError) as err:
            post(server, data, "application/octet-stream")
        assert err.value.code == 400
        assert name.encode() in err.value.read()


# --- the committed fixtures --------------------------------------------------

@pytest.mark.parametrize("name", sorted(MANIFEST["files"]))
def test_fixture_matches_its_manifest(name):
    """``expected.json`` holds PIL's decode of each committed file and the
    JAX trainer's ground truth of it; the port's decode equals both."""
    entry = MANIFEST["files"][name]
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    assert len(data) == entry["bytes"] < 256 * 1024
    want, want_disp = pil_decode(data)
    got = image_io.decode_image_rgb(data)
    assert list(got.shape) == entry["shape"] == list(want.shape)
    assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]
    disp = image_io.disparity_of(image_io.decode_image(data))
    assert hashlib.sha256(np.ascontiguousarray(
        want_disp, np.float32).tobytes()).hexdigest() == entry[
            "disparity_sha256"]
    assert hashlib.sha256(disp.tobytes()).hexdigest() == entry[
        "disparity_sha256"]
