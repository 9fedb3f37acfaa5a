"""Writers of BMP, TIFF, GIF and PNM/PFM files for the tests of the port's
decoders (``stereo_tpu_torch/_native/raster.cc``, ``utils/pnm.py``): the
variants PIL opens but does not write (RLE and 16-bit BMP, every BMP
header, TIFF byte orders, BigTIFF, tiles, planar configuration 2,
predictors, fill order 2, packed low depths, PackBits; GIF frames that do
not cover the screen; ``Pf``; PGM at odd maxvals), from numpy samples.
The encoders are simple and valid: TIFF's LZW codes the longest known
string at each step, GIF's writes every index as a literal code, PackBits
writes literal and repeat runs.  Also the
seeded damage ``raster_pil_agreement.py`` applies (truncations, flipped
bytes, a TIFF entry's size or type rewritten).  NumPy and the standard library only:
``chip_smoke.py`` writes its full-width files with it on the card's
machine, which has no imaging library (PIL's reading is in
``raster_pil.py``).
"""

import struct
import zlib

import numpy as np


# --- bit writers -------------------------------------------------------------

def _pack_msb(codes, widths) -> bytes:
    """Codes packed MSB-first, each at its width."""
    acc = bits = 0
    out = bytearray()
    for code, w in zip(codes, widths):
        acc = ((acc << w) | code) & 0xFFFFFF
        bits += w
        while bits >= 8:
            bits -= 8
            out.append((acc >> bits) & 255)
    if bits:
        out.append((acc << (8 - bits)) & 255)
    return bytes(out)


def tiff_lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB-first codes, the width growing one code early, as
    libtiff writes them): a clear code, the longest known string at each
    step, a clear before the table fills, the end code."""
    codes = []

    def width(k: int) -> int:
        # The decoder adds an entry after each code but the first after a
        # clear, and widens once its next free entry passes 2^bits - 2.
        free = 258 + max(0, k - 2)
        return 9 if free <= 510 else 10 if free <= 1022 else \
            11 if free <= 2046 else 12

    out = []
    k = 0
    table, next_code, prefix = {}, 258, None

    def emit(code: int) -> None:
        nonlocal k
        out.append((code, width(k) if k else 9))
        k += 1

    emit(256)
    for c in data:
        if prefix is None:
            prefix = c
            continue
        code = table.get((prefix << 8) | c)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        table[(prefix << 8) | c] = next_code
        next_code += 1
        prefix = c
        if next_code == 4093:
            emit(256)
            k = 1
            table, next_code = {}, 258
    if prefix is not None:
        emit(prefix)
    emit(257)
    return _pack_msb([c for c, _ in out], [w for _, w in out])


def gif_lzw(indices: bytes, min_bits: int = 8) -> bytes:
    """GIF LZW sub-blocks (LSB-first): a clear code, every index a literal,
    a clear before the table would widen the codes, the end code, the
    zero-length terminator."""
    clear = 1 << min_bits
    size = min_bits + 1
    limit = (1 << size) - 1 - (clear + 2)
    codes = []
    for i, v in enumerate(indices):
        if i % limit == 0:
            codes.append(clear)
        codes.append(v)
    codes.append(clear + 1)
    acc = bits = 0
    out = bytearray()
    for code in codes:
        acc |= code << bits
        bits += size
        while bits >= 8:
            out.append(acc & 255)
            acc >>= 8
            bits -= 8
    if bits:
        out.append(acc & 255)
    blocks = bytearray([min_bits])
    for i in range(0, len(out), 255):
        chunk = out[i:i + 255]
        blocks += bytes([len(chunk)]) + chunk
    return bytes(blocks + b"\0")


def packbits(data: bytes) -> bytes:
    """PackBits: runs of three or more as repeats, the rest as literals."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


# --- TIFF --------------------------------------------------------------------

def _row_bytes(values: np.ndarray, bits: int, big: bool) -> bytes:
    """One row of samples (1-D) at ``bits`` each, padded to a byte."""
    if bits < 8:
        shifted = np.unpackbits(values.astype(np.uint8)[:, None], axis=1,
                                count=8)[:, 8 - bits:]
        return np.packbits(shifted.ravel()).tobytes()
    if values.dtype.kind == "f":
        return values.astype(">f4" if big else "<f4").tobytes()
    code = {8: "u1", 16: "u2", 32: "u4"}[bits]
    if values.dtype.kind == "i":
        code = code.replace("u", "i")
    return values.astype((">" if big else "<") + code).tobytes()


def _predict(values: np.ndarray, bits: int, stride: int) -> np.ndarray:
    """Horizontal differencing (predictor 2) of one row of samples."""
    mask = (1 << bits) - 1
    v = values.astype(np.int64)
    out = v.copy()
    out[stride:] = (v[stride:] - v[:-stride]) & mask
    return out.astype(values.dtype)


def _predict_float(values: np.ndarray, stride: int) -> bytes:
    """Floating-point prediction (predictor 3) of one row: the byte planes,
    most significant first, differenced bytewise."""
    raw = np.frombuffer(values.astype(">f4").tobytes(), np.uint8).reshape(
        -1, 4)
    planes = raw.T.ravel().astype(np.int64)
    out = planes.copy()
    out[stride:] = (planes[stride:] - planes[:-stride]) & 255
    return out.astype(np.uint8).tobytes()


def reverse_bits(data: bytes) -> bytes:
    table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return data.translate(table)


def tiff_file(samples: np.ndarray, photometric: int, *, bits: int = None,
              big_endian: bool = False, bigtiff: bool = False,
              compression: int = 1, predictor: int = 1, planar: int = 1,
              tile=None, rows_per_strip: int = None, extra=(),
              sample_format: int = None, colormap=None, orientation=None,
              fill_order: int = 1, override_tags=None) -> bytes:
    """A TIFF of ``samples`` ((H, W) or (H, W, S); uint8/uint16/int16/
    int32/float32), one IFD, strips or ``tile=(tw, th)`` tiles.  ``override_tags``
    ({tag: (type, values)}; SHORT, LONG, FLOAT, DOUBLE or LONG8, or None to
    leave the tag out) replaces entries after
    the pixels are written: a directory that lies about them."""
    a = np.asarray(samples)
    if a.ndim == 2:
        a = a[..., None]
    h, w, spp = a.shape
    bits = bits or a.dtype.itemsize * 8
    if sample_format is None:
        sample_format = {"f": 3, "i": 2}.get(a.dtype.kind, 1)
    planes = [a[..., p:p + 1] for p in range(spp)] if planar == 2 else [a]
    tw, th = tile if tile else (w, rows_per_strip or h)

    def encode_rows(block: np.ndarray) -> bytes:
        rows = []
        stride = block.shape[2]
        for row in block:
            flat = row.reshape(-1)
            if predictor == 2:
                rows.append(_row_bytes(_predict(flat, bits, stride), bits,
                                       big_endian))
            elif predictor == 3:
                rows.append(_predict_float(flat, stride))
            else:
                rows.append(_row_bytes(flat, bits, big_endian))
        raw = b"".join(rows)
        if compression == 5:
            raw = tiff_lzw(raw)
        elif compression in (8, 32946):
            raw = zlib.compress(raw)
        elif compression == 32773:
            raw = packbits(raw)
        return reverse_bits(raw) if fill_order == 2 else raw

    chunks = []
    for plane in planes:
        for y in range(0, h, th):
            for x in range(0, w, tw if tile else w):
                block = plane[y:y + th, x:x + (tw if tile else w)]
                if tile:
                    pad = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    pad[:block.shape[0], :block.shape[1]] = block
                    block = pad
                chunks.append(encode_rows(block))
    e = ">" if big_endian else "<"
    offset_type, offset_fmt = (16, "Q") if bigtiff else (4, "L")
    header = ((b"MM" if big_endian else b"II")
              + struct.pack(e + "H", 43 if bigtiff else 42))
    header += (struct.pack(e + "HHQ", 8, 0, 16) if bigtiff
               else struct.pack(e + "L", 8))
    body = bytearray(header)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c
        if len(body) % 2:
            body += b"\0"
    tags = {256: (3 if w < 65536 else 4, [w]),
            257: (3 if h < 65536 else 4, [h]),
            258: (3, [bits] * spp), 259: (3, [compression]),
            262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar]),
            339: (3, [sample_format] * spp)}
    if fill_order != 1:
        tags[266] = (3, [fill_order])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra:
        tags[338] = (3, list(extra))
    if orientation is not None:
        tags[274] = (3, [orientation])
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).T.ravel()])
    if tile:
        tags.update({322: (3, [tw]), 323: (3, [th]),
                     324: (offset_type, offsets),
                     325: (offset_type, [len(c) for c in chunks])})
    else:
        tags.update({273: (offset_type, offsets), 278: (3, [th]),
                     279: (offset_type, [len(c) for c in chunks])})
    for tag, entry in (override_tags or {}).items():
        if entry is None:
            tags.pop(tag, None)
        else:
            tags[tag] = entry
    fmt = {3: "H", 4: "L", 11: "f", 12: "d", 16: "Q"}
    inline = 8 if bigtiff else 4
    if len(body) % 2:
        body += b"\0"
    ifd_at = len(body)
    entry = 20 if bigtiff else 12
    count_fmt = "Q" if bigtiff else "H"
    out_of_line = ifd_at + struct.calcsize(count_fmt) + entry * len(tags) + (
        8 if bigtiff else 4)
    entries, extra_data = bytearray(), bytearray()
    for tag in sorted(tags):
        typ, values = tags[tag]
        data = struct.pack(e + fmt[typ] * len(values), *values)
        if len(data) <= inline:
            value = data.ljust(inline, b"\0")
        else:
            value = struct.pack(e + offset_fmt, out_of_line + len(extra_data))
            extra_data += data
            if len(extra_data) % 2:
                extra_data += b"\0"
        entries += struct.pack(e + "HH" + ("Q" if bigtiff else "L"), tag, typ,
                               len(values)) + value
    body += struct.pack(e + count_fmt, len(tags)) + entries
    body += struct.pack(e + offset_fmt, 0) + extra_data
    first = struct.pack(e + offset_fmt, ifd_at)
    if bigtiff:
        body[8:16] = first
    else:
        body[4:8] = first
    return bytes(body)


# --- BMP ---------------------------------------------------------------------

def bmp_rle(indices: np.ndarray, rle4: bool) -> bytes:
    """RLE8/RLE4 rows (bottom-up): encoded runs for repeats, absolute runs
    for the rest, an end of line per row, the end of the bitmap."""
    out = bytearray()
    for row in indices[::-1]:
        row = [int(v) for v in row]
        i, n = 0, len(row)
        while i < n:
            j = i
            while j < n and j - i < 255 and row[j] == row[i]:
                j += 1
            run = row[i:min(n, i + (254 if rle4 else 255))]
            if rle4:
                run = run[:len(run) // 2 * 2]
            if j - i >= 3 or len(run) < (4 if rle4 else 3):
                v = row[i]
                out += bytes([j - i, (v << 4 | v) if rle4 else v])
                i = j
                continue
            if rle4:
                data = bytes(a << 4 | b for a, b in zip(run[::2], run[1::2]))
            else:
                data = bytes(run)
            out += bytes([0, len(run)]) + data
            if len(data) % 2:
                out += b"\0"
            i += len(run)
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_file(width: int, height: int, bits: int, pixels: bytes, *,
             palette=None, header: int = 40, compression: int = 0,
             masks=None, top_down: bool = False, colors: int = None) -> bytes:
    """A BMP with the given header size; ``pixels`` are the stored rows
    (padded to 4 bytes) or the RLE stream, ``palette`` (N, 3) RGB."""
    pal = b""
    if palette is not None:
        pad = b"" if header == 12 else b"\0"
        pal = b"".join(bytes([b, g, r]) + pad for r, g, b in palette)
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        n_colors = len(palette) if colors is None and palette is not None \
            else (colors or 0)
        info = struct.pack("<IiiHHIIiiII", header, width,
                           -height if top_down else height, 1, bits,
                           compression, len(pixels), 2835, 2835, n_colors, 0)
        if masks is not None and header >= 52:
            info += struct.pack("<" + "I" * len(masks), *masks)
        info = info.ljust(header, b"\0")
    after = b""
    if masks is not None and header == 40:
        after = struct.pack("<III", *masks[:3])
    offset = 14 + len(info) + len(after) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + info + after + pal + pixels)


def bmp_rows(values: np.ndarray, bits: int) -> bytes:
    """Bottom-up rows of (H, W) samples at ``bits`` (1, 4, 8, 16; 24/32
    from (H, W, 3|4) BGR(X) bytes), each padded to 4 bytes."""
    rows = []
    for row in values[::-1]:
        if bits < 8:
            data = _row_bytes(row.reshape(-1), bits, False)
        elif bits == 16:
            data = row.astype("<u2").tobytes()
        else:
            data = row.astype(np.uint8).tobytes()
        rows.append(data + b"\0" * (-len(data) % 4))
    return b"".join(rows)


# --- GIF ---------------------------------------------------------------------

def gif_file(screen, frame, indices: np.ndarray, *, global_palette=None,
             local_palette=None, transparency=None, interlace=False,
             min_bits: int = 8, stream: bytes = None) -> bytes:
    """A GIF89a of one frame at ``frame`` = (x0, y0) on a ``screen`` =
    (w, h), its (fh, fw) ``indices`` LZW-coded (rows interlaced when
    asked), or the given code ``stream``."""
    def table(p):
        p = np.asarray(p, np.uint8)
        size = max(1, int(np.ceil(np.log2(max(len(p), 2)))))
        full = np.zeros((1 << size, 3), np.uint8)
        full[:len(p)] = p
        return size, full.tobytes()

    flags, gct = 0, b""
    if global_palette is not None:
        size, gct = table(global_palette)
        flags = 0x80 | (size - 1)
    out = b"GIF89a" + struct.pack("<HHBBB", *screen, flags, 0, 0) + gct
    if transparency is not None:
        out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\0"
    fh, fw = indices.shape
    rows = indices
    if interlace:
        order = (list(range(0, fh, 8)) + list(range(4, fh, 8))
                 + list(range(2, fh, 4)) + list(range(1, fh, 2)))
        rows = indices[order]
    lflags, lct = (0x40 if interlace else 0), b""
    if local_palette is not None:
        size, lct = table(local_palette)
        lflags |= 0x80 | (size - 1)
    out += b"," + struct.pack("<HHHHB", *frame, fw, fh, lflags) + lct
    out += stream if stream is not None else gif_lzw(
        rows.astype(np.uint8).tobytes(), min_bits)
    return out + b";"


# --- damage ------------------------------------------------------------------

# ImageWidth, ImageLength, RowsPerStrip, TileWidth, TileLength, and values
# at the edges of the C ints and sizes PIL and libtiff keep them in (a few
# small ones too; none that would make either allocate gigabytes).
SIZE_TAGS = (256, 257, 278, 322, 323)
SIZE_VALUES = (0, 1, 15, 17, 65535, 65536, 2**31 - 1, 2**31, 2**32 - 2,
               2**32 - 1, 2**40, 2**62, 2**63, 2**64 - 1)
# Every TIFF type but SHORT and LONG, the writer's own.
OTHER_TYPES = (1, 2, 5, 6, 7, 8, 9, 10, 11, 12, 13, 16, 17, 18)


def _entries(data: bytes):
    """The byte order, BigTIFF or not, and (offset, tag) of each entry of a
    TIFF's first directory; None where there is no whole directory."""
    e = ">" if data[:2] == b"MM" else "<"
    big = data[2:4] in (b"\0+", b"+\0")
    count_fmt, entry = ("Q", 20) if big else ("H", 12)
    try:
        at = struct.unpack_from(e + ("Q" if big else "L"), data,
                                8 if big else 4)[0]
        count = struct.unpack_from(e + count_fmt, data, at)[0]
        first = at + struct.calcsize(count_fmt)
        spots = [(first + i * entry,
                  struct.unpack_from(e + "H", data, first + i * entry)[0])
                 for i in range(count)]
    except (struct.error, OverflowError):  # no whole directory
        return None
    return e, big, spots


def with_size(data: bytes, rng: np.random.Generator) -> bytes:
    """A TIFF whose first directory has one size entry (``SIZE_TAGS``)
    rewritten as one LONG (LONG8 in BigTIFF) of a seeded ``SIZE_VALUES``
    value; the data unchanged where there is none."""
    found = _entries(data)
    spots = [at for at, tag in found[2] if tag in SIZE_TAGS] if found else []
    if not spots:
        return data
    e, big, _ = found
    spot = spots[int(rng.integers(len(spots)))]
    value = SIZE_VALUES[int(rng.integers(len(SIZE_VALUES)))]
    out = bytearray(data)
    if big:
        struct.pack_into(e + "HQQ", out, spot + 2, 16, 1, value)
    else:
        struct.pack_into(e + "HLL", out, spot + 2, 4, 1, value & 0xFFFFFFFF)
    return bytes(out)


def with_type(data: bytes, rng: np.random.Generator) -> bytes:
    """A TIFF whose first directory has one entry's type replaced by a
    seeded one of ``OTHER_TYPES``, its count and value bytes kept; the data
    unchanged where there is no directory."""
    found = _entries(data)
    if not found or not found[2]:
        return data
    e, _, spots = found
    spot = spots[int(rng.integers(len(spots)))][0]
    out = bytearray(data)
    struct.pack_into(e + "H", out, spot + 2,
                     OTHER_TYPES[int(rng.integers(len(OTHER_TYPES)))])
    return bytes(out)


def retyped(data: bytes, tag: int, typ: int) -> bytes:
    """A TIFF with the entry of ``tag`` given the type ``typ``, its count and
    value bytes kept."""
    e, _, spots = _entries(data)
    out = bytearray(data)
    for at, t in spots:
        if t == tag:
            struct.pack_into(e + "H", out, at + 2, typ)
    return bytes(out)


def zero_count(data: bytes, tag: int) -> bytes:
    """A classic TIFF with the entry of ``tag`` given a count of 0."""
    e, _, spots = _entries(data)
    out = bytearray(data)
    for at, t in spots:
        if t == tag:
            struct.pack_into(e + "L", out, at + 4, 0)
    return bytes(out)


def damaged(data: bytes, rng: np.random.Generator, kind: str) -> bytes:
    """A truncation (at a seeded length), 1-4 seeded bytes replaced, or, in
    a TIFF, one size entry rewritten ("size") or one entry's type
    replaced ("type")."""
    if kind == "truncate":
        return data[:int(rng.integers(1, len(data)))]
    if kind == "size":
        return with_size(data, rng)
    if kind == "type":
        return with_type(data, rng)
    out = bytearray(data)
    for _ in range(int(rng.integers(1, 5))):
        out[int(rng.integers(0, len(out)))] = int(rng.integers(0, 256))
    return bytes(out)
