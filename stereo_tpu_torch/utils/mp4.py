"""The ISO base media file format (MP4) of the port's context video: one
``mp4v`` video track (MPEG-4 Part 2, ``_native/mpeg4.cc``), muxed and
demuxed here in plain Python.

``Mp4Writer`` streams as OpenCV's writer does: ``ftyp`` first, then an
``mdat`` in its 64-bit ``largesize`` form that grows with each sample and
whose size is patched in on ``close``, then ``moov`` last (``mvhd``, one
``trak`` of ``tkhd`` and ``mdia``: ``mdhd``, ``hdlr vide``, ``minf`` with
``vmhd``, ``dinf``/``dref`` and ``stbl``: ``stsd`` with an ``mp4v`` sample
entry and its ``esds``, ``stts``, ``stsc``, ``stsz`` and ``co64``).  With a
64-bit ``mdat`` and 64-bit chunk offsets the file has no 4 GiB limit.
Every sample is a sync sample (intra only), so there is no ``stss``; every
sample is a chunk of its own.

``read_track`` reads only that layout back and raises ``ValueError``
naming MP4 for anything else, a truncated file included.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, List, NamedTuple

import numpy as np

_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
_FTYP_BRANDS = (b"isom", 0x200, (b"isom", b"iso2", b"mp41"))
_MP4V_OBJECT_TYPE = 0x20     # ISO/IEC 14496-2 visual
_VISUAL_STREAM = 0x04


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", version << 24 | flags), *parts)


def _descriptor(tag: int, *parts: bytes) -> bytes:
    body = b"".join(parts)
    n = len(body)
    size = bytes([0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F])
    return bytes([tag]) + size + body


def timescale_of(fps: int) -> int:
    """The media timescale of a track at ``fps``: fps doubled until it is
    at least 10000, as libavformat's MP4 muxer picks it (each sample then
    lasts timescale / fps ticks)."""
    scale = int(fps)
    while scale < 10000:
        scale *= 2
    return scale


def _times(version: int) -> bytes:
    """Creation and modification time, both 0."""
    return bytes(16 if version else 8)


def _duration(version: int, duration: int) -> bytes:
    return struct.pack(">Q" if version else ">I", duration)


class Mp4Writer:
    """Streams the samples of one ``mp4v`` track of ``width`` x ``height``
    frames at ``fps`` into an MP4; ``config`` is the stream's VOS/VO/VOL
    headers (the ``esds`` decoder-specific info)."""

    def __init__(self, path: str, width: int, height: int, fps: int,
                 config: bytes):
        self.width, self.height, self.fps = int(width), int(height), int(fps)
        self.config = bytes(config)
        self.sizes: List[int] = []
        self.offsets: List[int] = []
        self._file: BinaryIO = open(path, "wb")
        brand, minor, compatible = _FTYP_BRANDS
        self._file.write(_box(b"ftyp", brand, struct.pack(">I", minor),
                              *compatible))
        self._mdat_at = self._file.tell()
        self._file.write(struct.pack(">I4sQ", 1, b"mdat", 0))

    def write(self, sample: bytes) -> None:
        self.offsets.append(self._file.tell())
        self.sizes.append(len(sample))
        self._file.write(sample)

    def close(self) -> None:
        if self._file.closed:
            return
        f = self._file
        end = f.tell()
        f.seek(self._mdat_at + 8)
        f.write(struct.pack(">Q", end - self._mdat_at))
        f.seek(end)
        f.write(self._moov())
        f.close()

    def _moov(self) -> bytes:
        n, fps = len(self.sizes), self.fps
        timescale = timescale_of(fps)
        delta = timescale // fps
        media = n * delta
        movie = (media * 1000 + timescale // 2) // timescale
        v = int(max(media, movie) >= 2 ** 32)
        mvhd = _full_box(b"mvhd", v, 0, _times(v),
                         struct.pack(">I", 1000), _duration(v, movie),
                         struct.pack(">IH10x", 0x10000, 0x100), _MATRIX,
                         bytes(24), struct.pack(">I", 2))
        tkhd = _full_box(b"tkhd", v, 3, _times(v),
                         struct.pack(">II", 1, 0), _duration(v, movie),
                         struct.pack(">8xhhH2x", 0, 0, 0), _MATRIX,
                         struct.pack(">II", self.width << 16,
                                     self.height << 16))
        mdhd = _full_box(b"mdhd", v, 0, _times(v),
                         struct.pack(">I", timescale), _duration(v, media),
                         struct.pack(">HH", 0x55C4, 0))      # "und"
        hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                         b"VideoHandler\0")
        vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                       _full_box(b"url ", 0, 1)))
        largest = max(self.sizes, default=0)
        peak = min(largest * 8 * fps, 2 ** 32 - 1)
        average = min(sum(self.sizes) * 8 * fps // max(n, 1), 2 ** 32 - 1)
        esds = _full_box(b"esds", 0, 0, _descriptor(
            3, struct.pack(">HB", 1, 0),
            _descriptor(4, bytes([_MP4V_OBJECT_TYPE, _VISUAL_STREAM << 2 | 1]),
                        min(largest, 2 ** 24 - 1).to_bytes(3, "big"),
                        struct.pack(">II", peak, average),
                        _descriptor(5, self.config)),
            _descriptor(6, b"\x02")))
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                     struct.pack(">HHIIIH", self.width, self.height,
                                 0x480000, 0x480000, 0, 1),
                     bytes(32), struct.pack(">Hh", 0x18, -1), esds)
        stbl = _box(
            b"stbl",
            _full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
            _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta)),
            _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
            _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n),
                      np.asarray(self.sizes, ">u4").tobytes()),
            _full_box(b"co64", 0, 0, struct.pack(">I", n),
                      np.asarray(self.offsets, ">u8").tobytes()))
        minf = _box(b"minf", vmhd, dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)


class Track(NamedTuple):
    """What ``read_track`` finds: the frames' size, the frame rate, the
    VOS/VO/VOL headers, and each sample's offset and size in the file."""
    width: int
    height: int
    fps: int
    config: bytes
    offsets: List[int]
    sizes: List[int]


def _refuse(path: str, why: str) -> ValueError:
    return ValueError(f"MP4: {path!r} is not an mp4v MP4 of this writer's "
                      f"layout ({why})")


class _Boxes:
    """The boxes of one level, in order, each checked to lie inside it."""

    def __init__(self, data: bytes, start: int, end: int, path: str):
        self.items = []
        pos = start
        while pos < end:
            if pos + 8 > end:
                raise _refuse(path, "truncated box header")
            size, kind = struct.unpack_from(">I4s", data, pos)
            header = 8
            if size == 1:
                if pos + 16 > end:
                    raise _refuse(path, "truncated box header")
                size = struct.unpack_from(">Q", data, pos + 8)[0]
                header = 16
            if size < header or pos + size > end:
                raise _refuse(path, f"box {kind!r} runs past its parent: "
                                    f"the file is truncated or damaged")
            self.items.append((kind, pos + header, pos + size))
            pos += size
        self.path = path

    def expect(self, *kinds: bytes) -> list:
        got = tuple(k for k, _, _ in self.items)
        if got != kinds:
            raise _refuse(self.path, f"boxes {got}, expected {kinds}")
        return [(s, e) for _, s, e in self.items]


def _read_descriptor(data: bytes, pos: int, end: int, tag: int,
                     path: str) -> tuple:
    if pos >= end or data[pos] != tag:
        raise _refuse(path, f"esds descriptor {tag} missing")
    pos += 1
    n = 0
    for _ in range(4):
        if pos >= end:
            raise _refuse(path, "truncated esds")
        byte = data[pos]
        pos += 1
        n = n << 7 | byte & 0x7F
        if not byte & 0x80:
            break
    if pos + n > end:
        raise _refuse(path, "truncated esds")
    return pos, pos + n


def read_track(path: str) -> Track:
    """The video track of an MP4 ``Mp4Writer`` wrote; ``ValueError``
    naming MP4 for any other file, a truncated one included."""
    with open(path, "rb") as f:
        head = f.read(32)
        top = []
        pos = 0
        size = os.fstat(f.fileno()).st_size
        while pos < size:     # top-level boxes, without reading the mdat
            f.seek(pos)
            h = f.read(16)
            if len(h) < 8:
                raise _refuse(path, "truncated box header")
            n, kind = struct.unpack_from(">I4s", h)
            if n == 1:
                if len(h) < 16:
                    raise _refuse(path, "truncated box header")
                n = struct.unpack_from(">Q", h, 8)[0]
            if n < 8 or pos + n > size:
                raise _refuse(path, f"box {kind!r} runs past the end of the "
                                    f"file: it is truncated")
            top.append((kind, pos, n))
            pos += n
        kinds = tuple(k for k, _, _ in top)
        if kinds != (b"ftyp", b"mdat", b"moov"):
            raise _refuse(path, f"top-level boxes {kinds}")
        if head[8:12] != _FTYP_BRANDS[0]:
            raise _refuse(path, f"brand {head[8:12]!r}")
        _, mdat_at, mdat_size = top[1]
        _, moov_at, moov_size = top[2]
        f.seek(moov_at)
        data = f.read(moov_size)
    try:
        return _parse_moov(data, mdat_at, mdat_at + mdat_size, path)
    except (struct.error, IndexError) as exc:
        raise _refuse(path, f"malformed moov: {exc}") from exc


def _parse_moov(data: bytes, mdat_at: int, mdat_end: int,
                path: str) -> Track:
    (moov,) = _Boxes(data, 0, len(data), path).expect(b"moov")
    _, trak = _Boxes(data, moov[0], moov[1], path).expect(b"mvhd", b"trak")
    _, mdia = _Boxes(data, *trak, path).expect(b"tkhd", b"mdia")
    mdhd, hdlr, minf = _Boxes(data, *mdia, path).expect(b"mdhd", b"hdlr",
                                                        b"minf")
    if data[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
        raise _refuse(path, "not a video track")
    version = data[mdhd[0]]
    timescale = struct.unpack_from(">I", data,
                                   mdhd[0] + (20 if version else 12))[0]
    _, _, stbl = _Boxes(data, *minf, path).expect(b"vmhd", b"dinf", b"stbl")
    stsd, stts, stsc, stsz, co64 = _Boxes(data, *stbl, path).expect(
        b"stsd", b"stts", b"stsc", b"stsz", b"co64")
    (entry,) = _Boxes(data, stsd[0] + 8, stsd[1], path).expect(b"mp4v")
    width, height = struct.unpack_from(">HH", data, entry[0] + 24)
    (esds,) = _Boxes(data, entry[0] + 78, entry[1], path).expect(b"esds")
    s, e = _read_descriptor(data, esds[0] + 4, esds[1], 3, path)
    if data[s + 2]:
        raise _refuse(path, "ES descriptor flags")
    s, e = _read_descriptor(data, s + 3, e, 4, path)
    if data[s] != _MP4V_OBJECT_TYPE or data[s + 1] >> 2 != _VISUAL_STREAM:
        raise _refuse(path, f"object type {data[s]:#x}, not MPEG-4 visual")
    s, e = _read_descriptor(data, s + 13, e, 5, path)
    config = data[s:e]

    n = struct.unpack_from(">I", data, stsz[0] + 8)[0]
    if (struct.unpack_from(">I", data, stsz[0] + 4)[0] != 0
            or stsz[0] + 12 + 4 * n > stsz[1]):
        raise _refuse(path, "stsz without a size per sample")
    sizes = list(struct.unpack_from(f">{n}I", data, stsz[0] + 12))
    if struct.unpack_from(">I", data, co64[0] + 4)[0] != n or \
            co64[0] + 8 + 8 * n > co64[1]:
        raise _refuse(path, "co64 does not give every sample its chunk")
    offsets = list(struct.unpack_from(f">{n}Q", data, co64[0] + 8))
    runs, count, delta = struct.unpack_from(">III", data, stts[0] + 4)
    if ((runs, count) != (1, n) or
            struct.unpack_from(">IIII", data, stsc[0] + 4) != (1, 1, 1, 1)):
        raise _refuse(path, "samples not one a chunk at one duration")
    if not delta or timescale % delta:
        raise _refuse(path, f"sample duration {delta} of {timescale}")
    for offset, size in zip(offsets, sizes):
        if offset < mdat_at + 16 or offset + size > mdat_end:
            raise _refuse(path, "a sample outside the mdat")
    return Track(width, height, timescale // delta, config, offsets, sizes)


def read_sample(f: BinaryIO, track: Track, index: int) -> bytes:
    """The bytes of sample ``index`` from the open file ``f``."""
    f.seek(track.offsets[index])
    data = f.read(track.sizes[index])
    if len(data) != track.sizes[index]:
        raise ValueError("MP4: a sample runs past the end of the file")
    return data


__all__ = ["Mp4Writer", "Track", "read_sample", "read_track", "timescale_of"]
