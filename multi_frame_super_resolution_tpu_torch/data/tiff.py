"""TIFF in numpy and the standard library's zlib: ``decode`` reads a
TIFF's first image, uncompressed as native/mfsr_native.cpp::decode_tiff
reads it, or compressed with LZW (5), Deflate (8, 32946) or PackBits
(32773), with Predictor 2 and in chunky or planar order (the forms the
JAX package reads through Pillow); ``encode`` writes an uncompressed
baseline TIFF."""

from __future__ import annotations

import struct
import zlib

import numpy as np

# TIFF field types the reader takes: BYTE, SHORT, LONG
_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4)}
TAGS = {256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample", 259: "Compression",
        262: "PhotometricInterpretation", 266: "FillOrder", 273: "StripOffsets", 277: "SamplesPerPixel",
        278: "RowsPerStrip", 279: "StripByteCounts", 284: "PlanarConfiguration", 317: "Predictor",
        322: "TileWidth", 323: "TileLength", 324: "TileOffsets", 325: "TileByteCounts", 338: "ExtraSamples",
        339: "SampleFormat"}
COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}


def _tag(tag):
    return f"TIFF {TAGS[tag]} (tag {tag})"


def lzw_decode(data: bytes, size: int, name: str) -> bytes:
    """TIFF 6.0 LZW (MSB-first codes of 9-12 bits, the width growing one
    code early; 256 clears, 257 ends) -> at most ``size`` bytes. The old
    LSB-first LZW of TIFF 5 raises."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise ValueError(f"{name}: TIFF Compression (tag 259) 5 in old-style (TIFF 5, LSB-first) LZW; the reader "
                         "decodes TIFF 6.0 LZW")
    b = np.frombuffer(data + bytes(4), np.uint8).astype(np.uint32)
    n = len(data) + 1
    words = ((b[:n] << 24) | (b[1 : n + 1] << 16) | (b[2 : n + 2] << 8) | b[3 : n + 3]).tolist()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    end, p, width, prev = 8 * len(data), 0, 9, None
    while p + width <= end and len(out) < size:
        code = (words[p >> 3] >> (32 - width - (p & 7))) & ((1 << width) - 1)
        p += width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if prev is None:
            if code > 255:
                raise ValueError(f"{name}: corrupt LZW data (code {code} after a clear)")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        elif code == len(table):
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError(f"{name}: corrupt LZW data (code {code} past the table's {len(table)})")
        out += entry
        prev = entry
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def packbits_decode(data: bytes, size: int) -> bytes:
    """PackBits (Compression 32773) -> at most ``size`` bytes."""
    out, i = bytearray(), 0
    while i < len(data) and len(out) < size:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i : i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _inflate(data: bytes, name: str) -> bytes:
    try:
        return zlib.decompressobj().decompress(data)
    except zlib.error as err:
        raise ValueError(f"{name}: TIFF Deflate strip does not inflate ({err})") from None


def _fields(blob: bytes, end: str, name: str) -> dict:
    try:
        magic, ifd = struct.unpack_from(end + "HI", blob, 2)
        if magic != 42:
            raise ValueError(f"{name}: TIFF header without 42")
        (n_entries,) = struct.unpack_from(end + "H", blob, ifd)
        fields = {}
        for i in range(n_entries):
            entry = ifd + 2 + 12 * i
            tag, kind, count = struct.unpack_from(end + "HHI", blob, entry)
            if tag in TAGS and kind in _TYPES:
                code, unit = _TYPES[kind]
                at = entry + 8 if unit * count <= 4 else struct.unpack_from(end + "I", blob, entry + 8)[0]
                fields[tag] = struct.unpack_from(f"{end}{count}{code}", blob, at)
            elif tag in TAGS:
                fields[tag] = None  # present (a tile tag refuses), of a type the reader does not take
    except struct.error as err:
        raise ValueError(f"{name}: truncated TIFF ({err})") from None
    return fields


def decode(blob: bytes, name: str = "TIFF"):
    """A TIFF's first image -> (its samples (H, W, C), bit depth 8 or 16):
    II or MM byte order, strips, 8- or 16-bit samples, 1 or at least 3
    samples a pixel (the first 3 kept). Uncompressed chunky files read as
    the native library reads them (rows no strip covers stay 0); LZW,
    Deflate and PackBits strips, Predictor 2 (horizontal differencing per
    sample, 16-bit in the file's byte order) and PlanarConfiguration 2
    (each plane's strips in turn) as libtiff decodes them. Anything else
    raises ValueError naming the tag and value. (The Predictor tag acts
    on LZW and Deflate strips only, as in libtiff.)"""
    end = "<" if blob[:2] == b"II" else ">"
    fields = _fields(blob, end, name)
    for tag in (322, 323, 324, 325):
        if tag in fields:
            raise ValueError(f"{name}: tiled TIFF ({_tag(tag)}); the reader reads strips")
    for tag in (256, 257, 273):
        if fields.get(tag) is None:
            raise ValueError(f"{name}: no {_tag(tag)}")
    (width,), (height,), offsets = fields[256], fields[257], fields[273]

    def one(tag, default):  # a field of a type the reader does not take counts as absent, as in the C++ reader
        values = fields.get(tag)
        return values[0] if values else default

    bits, compression, spp = one(258, 8), one(259, 1), one(277, 1)
    rows_per_strip, planar, predictor = min(one(278, height), height) or height, one(284, 1), one(317, 1)
    photometric = one(262, None)
    if compression in (6, 7):
        raise ValueError(f"{name}: JPEG-in-TIFF ({_tag(259)} {compression}); the reader decodes Compression "
                         "1, 5, 8, 32946 and 32773")
    if compression not in COMPRESSIONS:
        raise ValueError(f"{name}: {_tag(259)} {compression}; the reader decodes Compression 1 (none), 5 (LZW), "
                         "8 and 32946 (Deflate) and 32773 (PackBits)")
    if planar not in (1, 2):
        raise ValueError(f"{name}: {_tag(284)} {planar}; the reader takes 1 (chunky) and 2 (planar)")
    # the native library reads uncompressed chunky files ignoring the tags
    # below; the other forms are libtiff's, through Pillow in the JAX package
    libtiff = compression != 1 or planar == 2
    where = "on a compressed or planar TIFF"
    if libtiff and photometric not in (1, 2):
        raise ValueError(f"{name}: {_tag(262)} {photometric} {where}; the reader takes 1 (BlackIsZero) and 2 "
                         "(RGB) there")
    if libtiff and one(339, 1) != 1:
        raise ValueError(f"{name}: {_tag(339)} {one(339, 1)} {where}; the reader takes 1 (unsigned) there")
    if libtiff and spp > 3 and one(338, 0) == 1:
        raise ValueError(f"{name}: {_tag(338)} 1 (associated alpha) {where}; the reader takes unassociated or "
                         "unspecified extra samples there")
    if libtiff and one(266, 1) != 1:
        raise ValueError(f"{name}: {_tag(266)} {one(266, 1)} {where}; the reader takes 1 (MSB first) there")
    predictor = predictor if compression in (5, 8, 32946) else 1  # libtiff's codecs with a predictor
    if predictor == 3:
        raise ValueError(f"{name}: {_tag(317)} 3 (floating point); the reader takes 1 and 2")
    if predictor not in (1, 2):
        raise ValueError(f"{name}: {_tag(317)} {predictor}; the reader takes 1 and 2")
    if bits not in (8, 16):
        raise ValueError(f"{name}: {_tag(258)} {bits}; the reader takes 8 and 16")
    if spp == 0 or spp == 2:
        raise ValueError(f"{name}: {_tag(277)} {spp}; the reader takes 1, 3 or more")
    per_plane = spp if planar == 1 else 1
    row_bytes = width * per_plane * bits // 8
    counts = fields.get(279) or ()
    strips = -(-height // rows_per_strip)
    planes = []
    for plane in range(1 if planar == 1 else spp):
        rows = np.zeros((height, row_bytes), np.uint8)  # rows no strip covers stay 0, as in the C++ reader
        row = 0
        for s in range(strips):
            at = plane * strips + s
            if at >= len(offsets):
                if planar == 2 or compression != 1:
                    raise ValueError(f"{name}: TIFF with {len(offsets)} strips, {strips * (spp if planar == 2 else 1)} "
                                     "expected")
                break
            n = min(rows_per_strip, height - row)
            size, offset = n * row_bytes, offsets[at]
            if compression == 1:
                if (at < len(counts) and counts[at] < size) or offset + size > len(blob):
                    raise ValueError(f"{name}: TIFF strip {at} holds fewer than its {n} rows")
                data = blob[offset : offset + size]
            else:
                if at >= len(counts):
                    raise ValueError(f"{name}: compressed TIFF without a {_tag(279)} for strip {at}")
                raw = blob[offset : offset + counts[at]]
                if compression == 5:
                    data = lzw_decode(raw, size, name)
                elif compression == 32773:
                    data = packbits_decode(raw, size)
                else:
                    data = _inflate(raw, name)
                if len(data) < size:
                    raise ValueError(f"{name}: TIFF {COMPRESSIONS[compression]} strip {at} decodes to "
                                     f"{len(data)} bytes, fewer than its {n} rows' {size}")
            strip = np.frombuffer(data, np.uint8, size).reshape(n, row_bytes)
            if predictor == 2:  # a running sum along each row of each sample, mod 2^bits
                kind = np.dtype(end + "u2") if bits == 16 else np.dtype(np.uint8)
                samples = strip.view(kind).reshape(n, width, per_plane)
                summed = np.cumsum(samples, axis=1, dtype=kind.newbyteorder("="))  # wraps mod 2^bits
                strip = summed.astype(kind).reshape(n, -1).view(np.uint8)
            rows[row : row + n] = strip
            row += n
        planes.append(rows.view(end + "u2") if bits == 16 else rows)
    if planar == 1:
        samples = planes[0].reshape(height, width, spp)
    else:
        samples = np.stack([p.reshape(height, width) for p in planes], -1)
    return samples[..., : 1 if spp == 1 else 3], bits


def encode(img: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of an uncompressed
    little-endian baseline TIFF: one chunky strip, BlackIsZero or RGB."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    pixels = np.ascontiguousarray(img).tobytes()
    ifd_at = 8 + len(pixels) + len(pixels) % 2  # the IFD on a word boundary
    bits_at = ifd_at + 2 + 12 * 10 + 4  # BitsPerSample's 3 values, after the IFD
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, c, 8 if c == 1 else bits_at), (259, 3, 1, 1),
               (262, 3, 1, 1 if c == 1 else 2), (273, 4, 1, 8), (277, 3, 1, c), (278, 4, 1, h),
               (279, 4, 1, len(pixels)), (284, 3, 1, 1)]
    ifd = struct.pack("<H", len(entries))
    for tag, kind, count, value in entries:
        field = struct.pack("<HH", value, 0) if kind == 3 and count == 1 else struct.pack("<I", value)
        ifd += struct.pack("<HHI", tag, kind, count) + field
    tail = struct.pack("<3H", 8, 8, 8) if c == 3 else b""
    return (b"II" + struct.pack("<HI", 42, ifd_at) + pixels + bytes(len(pixels) % 2) + ifd
            + struct.pack("<I", 0) + tail)
