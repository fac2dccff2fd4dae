"""JPEG in numpy and the standard library, as libjpeg-turbo computes it.

``decode`` reads baseline (SOF0, and SOF1 at 8-bit precision) and
progressive (SOF2) Huffman JPEG with one (gray) or three (YCbCr, or RGB
where an Adobe marker or the component ids say so) components and
sampling factors 1 or 2, to the samples libjpeg-turbo's default
decompression gives (what Pillow and the native library return):
dequantization, the ISLOW integer IDCT with its descale and range limit
(jidctint.c), fancy upsampling (jdsample.c: h2v1, h2v2 with its
alternating biases, h1v2; box upsampling where a component is at most 2
samples wide) and the fixed-point YCbCr -> RGB tables (jdcolor.c). Only
the entropy decoding runs as a Python loop; the rest is vectorised over
every block at once. Anything else raises ValueError naming the marker
or value.

``encode`` writes a baseline JPEG as Pillow does with its defaults
(libjpeg-turbo's jpeg_set_defaults): the standard tables scaled to a
quality (75) as jpeg_set_quality scales them, 4:2:0 YCbCr for RGB and one
component for gray, the rgb_ycc tables (jccolor.c), h2v2_downsample with
its alternating bias (jcsample.c), edge replication to whole blocks and
the encoder's dummy blocks, the ISLOW FDCT (jfdctint.c) with libjpeg's
rounding quantization, and the standard Huffman tables.
"""

from __future__ import annotations

import functools
import re
import struct

import numpy as np

# zigzag position -> natural (row-major) index of an 8 x 8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {0xC3: "SOF3 (lossless)", 0xC5: "SOF5 (hierarchical)", 0xC6: "SOF6 (hierarchical)",
              0xC7: "SOF7 (hierarchical)", 0xC9: "SOF9 (arithmetic)", 0xCA: "SOF10 (arithmetic)",
              0xCB: "SOF11 (arithmetic)", 0xCC: "DAC (arithmetic)", 0xCD: "SOF13 (arithmetic)",
              0xCE: "SOF14 (arithmetic)", 0xCF: "SOF15 (arithmetic)", 0xDC: "DNL"}
_MASK = [(1 << s) - 1 for s in range(33)]
_MARKER = re.compile(rb"\xff(?=[^\x00\xd0-\xd7])")  # ends a scan's data: a marker other than RSTn


# --- the entropy-coded data ---------------------------------------------

@functools.lru_cache(maxsize=64)
def _lookup(bits: bytes, values: bytes) -> list:
    """A DHT table (counts of codes of lengths 1-16, symbols) -> a list
    indexed by the next 16 bits of the stream: (length << 8) | symbol, or
    -1 where no code starts. Cached: files from one encoder share their
    tables, and the list is only read."""
    table = np.full(1 << 16, -1, np.int64)
    code, i = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if code >= 1 << length:
                raise ValueError("corrupt JPEG: a DHT table with more codes than its lengths allow")
            lo = code << (16 - length)
            table[lo : lo + (1 << (16 - length))] = (length << 8) | values[i]
            code, i = code + 1, i + 1
        code <<= 1
    return table.tolist()


def _windows(segment: bytes) -> list:
    """The unstuffed entropy-coded bytes -> the 64 bits that start at each
    byte, as Python ints; zeros past the end, as libjpeg fills them, for
    512 bytes (more than one block can read: the decoders check the end
    after each block)."""
    b = np.frombuffer(segment + bytes(520), np.uint8).astype(np.uint64)
    n = len(segment) + 513
    w = np.zeros(n, np.uint64)
    for i in range(8):
        w |= b[i : i + n] << np.uint64(56 - 8 * i)
    return w.tolist()


def _segments(data: bytes, count: int, name: str) -> list:
    """A scan's entropy-coded data split at its restart markers, each piece
    unstuffed (0xFF00 -> 0xFF); fewer than ``count`` pieces raise."""
    pieces = re.split(rb"\xff[\xd0-\xd7]", data)
    if len(pieces) < count:
        raise ValueError(f"{name}: truncated JPEG scan ({len(pieces)} of its {count} restart intervals)")
    return [piece.replace(b"\xff\x00", b"\xff") for piece in pieces[:count]]


def _truncated(name):
    return ValueError(f"{name}: truncated JPEG scan (its entropy-coded data ends before its last block)")


def _bad_code(name):
    return ValueError(f"{name}: corrupt JPEG scan (a Huffman code no table holds)")


def _scan_sequential(segments, groups, coefs, dc_tabs, ac_tabs, name):
    """Decode a baseline scan: ``groups`` is one list per restart interval
    of (component, coefficient offset) in decode order."""
    for seg, blocks in zip(segments, groups):
        W = _windows(seg)
        end = 8 * len(seg)
        p = 0
        pred = [0] * len(coefs)
        for ci, base in blocks:
            out, dc, ac = coefs[ci], dc_tabs[ci], ac_tabs[ci]
            e = dc[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            if e < 0:
                raise _bad_code(name)
            p += e >> 8
            s = e & 0xFF
            if s:
                v = (W[p >> 3] >> (64 - s - (p & 7))) & _MASK[s]
                p += s
                if v >> (s - 1) == 0:
                    v -= _MASK[s]
                pred[ci] += v
            out[base] = pred[ci]
            k = 1
            while k < 64:
                e = ac[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                if e < 0:
                    raise _bad_code(name)
                p += e >> 8
                s = e & 15
                if s:
                    k += (e >> 4) & 15
                    v = (W[p >> 3] >> (64 - s - (p & 7))) & _MASK[s]
                    p += s
                    if v >> (s - 1) == 0:
                        v -= _MASK[s]
                    if k > 63:
                        raise ValueError(f"{name}: corrupt JPEG scan (a coefficient past 63)")
                    out[base + k] = v
                    k += 1
                elif (e & 0xF0) == 0xF0:
                    k += 16
                else:
                    break
            if p > end:
                raise _truncated(name)


def _scan_progressive(segments, groups, coefs, dc_tabs, ac_tabs, ss, se, ah, al, name):
    """Decode one progressive scan (jdphuff.c's four kinds) into the
    coefficient lists, which hold each block's 64 in zigzag order."""
    for seg, blocks in zip(segments, groups):
        W = _windows(seg)
        end = 8 * len(seg)
        p = 0
        if ss == 0 and ah == 0:  # DC first
            pred = [0] * len(coefs)
            for ci, base in blocks:
                e = dc_tabs[ci][(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                if e < 0:
                    raise _bad_code(name)
                p += e >> 8
                s = e & 0xFF
                if s:
                    v = (W[p >> 3] >> (64 - s - (p & 7))) & _MASK[s]
                    p += s
                    if v >> (s - 1) == 0:
                        v -= _MASK[s]
                    pred[ci] += v
                coefs[ci][base] = pred[ci] << al
                if p > end:
                    raise _truncated(name)
        elif ss == 0:  # DC refine: one bit a block
            bit = 1 << al
            for ci, base in blocks:
                if (W[p >> 3] >> (63 - (p & 7))) & 1:
                    coefs[ci][base] |= bit
                p += 1
        elif ah == 0:  # AC first, with end-of-band runs
            eobrun = 0
            for ci, base in blocks:
                if eobrun:
                    eobrun -= 1
                    continue
                out, ac = coefs[ci], ac_tabs[ci]
                k = ss
                while k <= se:
                    e = ac[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                    if e < 0:
                        raise _bad_code(name)
                    p += e >> 8
                    s, r = e & 15, (e >> 4) & 15
                    if s:
                        k += r
                        v = (W[p >> 3] >> (64 - s - (p & 7))) & _MASK[s]
                        p += s
                        if v >> (s - 1) == 0:
                            v -= _MASK[s]
                        if k > se:
                            raise ValueError(f"{name}: corrupt JPEG scan (a coefficient past the band)")
                        out[base + k] = v << al
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        eobrun = 1 << r
                        if r:
                            eobrun += (W[p >> 3] >> (64 - r - (p & 7))) & _MASK[r]
                            p += r
                        eobrun -= 1
                        break
                if p > end:
                    raise _truncated(name)
        else:  # AC refine (decode_mcu_AC_refine)
            p1, m1 = 1 << al, -1 << al
            eobrun = 0
            for ci, base in blocks:
                out, ac = coefs[ci], ac_tabs[ci]
                k = ss
                if eobrun == 0:
                    while k <= se:
                        e = ac[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                        if e < 0:
                            raise _bad_code(name)
                        p += e >> 8
                        s, r = e & 15, (e >> 4) & 15
                        if s:
                            s = p1 if (W[p >> 3] >> (63 - (p & 7))) & 1 else m1
                            p += 1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                eobrun += (W[p >> 3] >> (64 - r - (p & 7))) & _MASK[r]
                                p += r
                            break
                        while k <= se:
                            c = out[base + k]
                            if c:
                                if (W[p >> 3] >> (63 - (p & 7))) & 1 and not c & p1:
                                    out[base + k] = c + (p1 if c >= 0 else m1)
                                p += 1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                        if s:
                            if k > se:
                                raise ValueError(f"{name}: corrupt JPEG scan (a coefficient past the band)")
                            out[base + k] = s
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        c = out[base + k]
                        if c:
                            if (W[p >> 3] >> (63 - (p & 7))) & 1 and not c & p1:
                                out[base + k] = c + (p1 if c >= 0 else m1)
                            p += 1
                        k += 1
                    eobrun -= 1
                if p > end:
                    raise _truncated(name)
        if p > end:
            raise _truncated(name)


# --- the integer transforms ---------------------------------------------

CONST_BITS, PASS1_BITS = 13, 2
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c, shift):
    """jpeg_idct_islow's pass over axis 1 of ``c`` (N, 8, ...): the even
    and odd parts, outputs descaled by ``shift``."""
    z2, z3 = c[:, 2], c[:, 6]
    z1 = (z2 + z3) * F0541
    tmp2 = z1 - z3 * F1847
    tmp3 = z1 + z2 * F0765
    tmp0 = (c[:, 0] + c[:, 4]) << CONST_BITS
    tmp1 = (c[:, 0] - c[:, 4]) << CONST_BITS
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = c[:, 7], c[:, 5], c[:, 3], c[:, 1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F1175
    o0, o1, o2, o3 = o0 * F0298, o1 * F2053, o2 * F3072, o3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return np.stack([_descale(x, shift) for x in out], axis=1)


def _range_limit() -> np.ndarray:
    """The post-IDCT table of jdmaster.c's prepare_range_limit_table,
    indexed by (descaled value) & 1023: x -> x + 128 clamped to [0, 255]
    for x in [-512, 511], wrapping past that as libjpeg's table does."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE = _range_limit()


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow on blocks (N, 64) of zigzag-ordered coefficients
    with the natural-order quantization table ``quant`` (64,) -> uint8
    (N, 8, 8). (The code's shortcuts for all-zero AC columns and rows give
    these values too.)"""
    c = np.zeros((len(coefs), 64), np.int64)
    c[:, ZIGZAG] = coefs
    c = (c * quant.astype(np.int64)).reshape(-1, 8, 8)
    ws = _idct_1d(c, CONST_BITS - PASS1_BITS)  # columns: along the vertical frequencies
    ws = ws.astype(np.int32).astype(np.int64)  # the int workspace
    out = _idct_1d(ws.transpose(0, 2, 1), CONST_BITS + PASS1_BITS + 3).transpose(0, 2, 1)
    return _RANGE[out & 1023]


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jpeg_fdct_islow on (N, 8, 8) samples minus 128 -> (N, 8, 8) int64
    coefficients, scaled up by 8 as libjpeg leaves them."""

    def one_pass(d, final):
        t0, t7 = d[:, 0] + d[:, 7], d[:, 0] - d[:, 7]
        t1, t6 = d[:, 1] + d[:, 6], d[:, 1] - d[:, 6]
        t2, t5 = d[:, 2] + d[:, 5], d[:, 2] - d[:, 5]
        t3, t4 = d[:, 3] + d[:, 4], d[:, 3] - d[:, 4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = [None] * 8
        if final:
            out[0], out[4] = _descale(t10 + t11, PASS1_BITS), _descale(t10 - t11, PASS1_BITS)
            shift = CONST_BITS + PASS1_BITS
        else:
            out[0], out[4] = (t10 + t11) << PASS1_BITS, (t10 - t11) << PASS1_BITS
            shift = CONST_BITS - PASS1_BITS
        z1 = (t12 + t13) * F0541
        out[2] = _descale(z1 + t13 * F0765, shift)
        out[6] = _descale(z1 - t12 * F1847, shift)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * F1175
        t4, t5, t6, t7 = t4 * F0298, t5 * F2053, t6 * F3072, t7 * F1501
        z1, z2 = z1 * -F0899, z2 * -F2562
        z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
        out[7] = _descale(t4 + z1 + z3, shift)
        out[5] = _descale(t5 + z2 + z4, shift)
        out[3] = _descale(t6 + z2 + z3, shift)
        out[1] = _descale(t7 + z1 + z4, shift)
        return np.stack(out, axis=1)

    d = blocks.astype(np.int64)
    rows = one_pass(d.transpose(0, 2, 1), False).transpose(0, 2, 1)  # pass 1 along each row
    return one_pass(rows, True)  # pass 2 along each column


# --- upsampling and colour ----------------------------------------------

def _upsample(plane: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """A component's samples (h, w) at its own size -> fy x the rows and
    fx x the columns, as libjpeg-turbo's jdsample.c upsamples with
    do_fancy_upsampling: h2v1_fancy_upsample, h1v2_fancy_upsample and
    h2v2_fancy_upsample (the triangle filters, edges replicated), and
    box replication where fancy upsampling does not apply (a component at
    most 2 samples wide at h2v1 or h2v2)."""
    if (fx, fy) == (1, 1):
        return plane
    x = plane.astype(np.int32)
    h, w = x.shape
    if fx == 2 and w <= 2:
        return np.repeat(np.repeat(plane, fy, 0), fx, 1)
    if fy == 2:  # 3 x the nearer row + the further one (h1v2 and h2v2 share this)
        up = np.concatenate([x[:1], x[:-1]], 0)
        down = np.concatenate([x[1:], x[-1:]], 0)
        near = 3 * x
        above, below = near + up, near + down
        if fx == 1:
            out = np.empty((2 * h, w), np.int32)
            out[0::2], out[1::2] = (above + 1) >> 2, (below + 2) >> 2
            return out.astype(np.uint8)
        out = np.empty((2 * h, 2 * w), np.int32)
        for rows, colsum in ((slice(0, None, 2), above), (slice(1, None, 2), below)):
            left = np.concatenate([colsum[:, :1], colsum[:, :-1]], 1)
            right = np.concatenate([colsum[:, 1:], colsum[:, -1:]], 1)
            out[rows, 0::2] = (3 * colsum + left + 8) >> 4
            out[rows, 1::2] = (3 * colsum + right + 7) >> 4
        return out.astype(np.uint8)
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)  # h2v1
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((h, 2 * w), np.int32)
    out[:, 0::2], out[:, 1::2] = (3 * x + left + 1) >> 2, (3 * x + right + 2) >> 2
    return out.astype(np.uint8)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    return ((fix(1.40200) * x + one_half) >> 16, (fix(1.77200) * x + one_half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + one_half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """ycc_rgb_convert: uint8 planes -> uint8 (H, W, 3)."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# --- the decoder ----------------------------------------------------------

def _u16(blob, at):
    return (blob[at] << 8) | blob[at + 1]


def decode(blob: bytes, name: str = "JPEG") -> np.ndarray:
    """A JPEG file's bytes -> its uint8 samples (H, W, 1) or (H, W, 3)."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG (no SOI marker)")
    quant, dc_tables, ac_tables = {}, {}, {}
    frame, restart, adobe, jfif = None, 0, None, False
    coefs, latched, progressive = [], [], False
    pos, n = 2, len(blob)
    while True:
        while pos < n and blob[pos] != 0xFF:  # junk between markers: libjpeg skips it with a warning
            pos += 1
        while pos < n and blob[pos] == 0xFF:
            pos += 1
        if pos >= n:
            if frame is not None and frame.get("done"):
                break  # a file that ends without EOI after its last scan
            raise ValueError(f"{name}: truncated JPEG (no EOI marker, or no complete frame)")
        marker = blob[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError(f"{name}: truncated JPEG marker 0x{marker:02X}")
        length = _u16(blob, pos)
        seg = blob[pos + 2 : pos + length]
        if len(seg) != length - 2:
            raise ValueError(f"{name}: truncated JPEG marker 0x{marker:02X}")
        pos += length
        if marker in _SOF_NAMES:
            raise ValueError(f"{name}: JPEG {_SOF_NAMES[marker]}; the decoder reads baseline (SOF0, SOF1) and "
                             "progressive (SOF2) Huffman JPEG")
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise ValueError(f"{name}: JPEG with two SOF markers")
            precision, height, width, count = seg[0], _u16(seg, 1), _u16(seg, 3), seg[5]
            if precision != 8:
                raise ValueError(f"{name}: JPEG of {precision}-bit precision; the decoder reads 8-bit")
            if height == 0:
                raise ValueError(f"{name}: JPEG height 0 (set by a DNL marker); the decoder reads SOF heights")
            if count not in (1, 3):
                what = "4 components (CMYK/YCCK)" if count == 4 else f"{count} components"
                raise ValueError(f"{name}: JPEG with {what}; the decoder reads 1 (gray) or 3 (YCbCr/RGB)")
            comps = []
            for i in range(count):
                cid, hv, tq = seg[6 + 3 * i : 9 + 3 * i]
                hs, vs = hv >> 4, hv & 15
                if hs not in (1, 2) or vs not in (1, 2):
                    raise ValueError(f"{name}: JPEG sampling factors {hs} x {vs}; the decoder reads 1 and 2")
                comps.append({"id": cid, "h": hs, "v": vs, "tq": tq})
            if count == 1:  # one component: its blocks are the MCUs
                comps[0]["h"] = comps[0]["v"] = 1
            hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
            mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c["bw"], c["bh"] = mx * c["h"], my * c["v"]  # blocks stored, whole MCUs
                c["w"] = -(-width * c["h"] // hmax)  # the component's samples
                c["hgt"] = -(-height * c["v"] // vmax)
            frame = {"w": width, "h": height, "comps": comps, "hmax": hmax, "vmax": vmax, "mx": mx, "my": my}
            progressive = marker == 0xC2
            coefs = [[0] * (c["bw"] * c["bh"] * 64) for c in comps]
            latched = [None] * count
        elif marker == 0xC4:  # DHT
            at = 0
            while at < len(seg):
                tc, th = seg[at] >> 4, seg[at] & 15
                bits = bytes(seg[at + 1 : at + 17])
                values = bytes(seg[at + 17 : at + 17 + sum(bits)])
                if len(bits) != 16 or len(values) != sum(bits) or tc > 1:
                    raise ValueError(f"{name}: corrupt JPEG DHT marker")
                (ac_tables if tc else dc_tables)[th] = _lookup(bits, values)
                at += 17 + sum(bits)
        elif marker == 0xDB:  # DQT, 8- or 16-bit entries
            at = 0
            while at < len(seg):
                pq, tq = seg[at] >> 4, seg[at] & 15
                size = 128 if pq else 64
                raw = seg[at + 1 : at + 1 + size]
                if len(raw) != size:
                    raise ValueError(f"{name}: corrupt JPEG DQT marker")
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = np.frombuffer(raw, ">u2" if pq else np.uint8)
                quant[tq] = table
                at += 1 + size
        elif marker == 0xDD:  # DRI
            restart = _u16(seg, 0)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xDA:  # SOS, then its entropy-coded data
            if frame is None:
                raise ValueError(f"{name}: JPEG SOS before SOF")
            ns = seg[0]
            scomps = []
            for i in range(ns):
                cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
                ci = next((j for j, c in enumerate(frame["comps"]) if c["id"] == cid), None)
                if ci is None:
                    raise ValueError(f"{name}: JPEG scan of component {cid}, which the frame lacks")
                scomps.append((ci, tables >> 4, tables & 15))
            ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
            m = _MARKER.search(blob, pos)
            data_end = m.start() if m else n
            data = blob[pos:data_end]
            pos = data_end
            for ci, _, _ in scomps:
                if latched[ci] is None:
                    tq = frame["comps"][ci]["tq"]
                    if tq not in quant:
                        raise ValueError(f"{name}: JPEG component without its DQT table {tq}")
                    latched[ci] = quant[tq].copy()
            _scan(frame, data, scomps, coefs, dc_tables, ac_tables, restart, progressive, ss, se, ah, al, name)
            frame["done"] = True
        # APPn, COM and the rest: skipped
    if frame is None or not frame.get("done"):
        raise ValueError(f"{name}: JPEG without a frame and scan")
    return _finish(frame, coefs, latched, adobe, jfif, name)


def _scan(frame, data, scomps, coefs, dc_tables, ac_tables, restart, progressive, ss, se, ah, al, name):
    comps = frame["comps"]
    if progressive:
        if (ss == 0) != (se == 0) or se > 63 or ss > se or (ss > 0 and len(scomps) != 1) or al > 13:
            raise ValueError(f"{name}: invalid progressive JPEG scan (Ss {ss}, Se {se}, Ah {ah}, Al {al})")
    if len(scomps) == 1:  # non-interleaved: the component's own blocks, raster order
        ci = scomps[0][0]
        c = comps[ci]
        bw, bh = -(-c["w"] // 8), -(-c["hgt"] // 8)
        base = ((np.arange(bh)[:, None] * c["bw"] + np.arange(bw)[None, :]) * 64).reshape(-1)
        cis = np.full(base.size, ci)
        units, per_unit = bh * bw, 1
    else:
        parts = []
        for ci, _, _ in scomps:
            c = comps[ci]
            my, mx, v, h = np.meshgrid(np.arange(frame["my"]), np.arange(frame["mx"]), np.arange(c["v"]),
                                       np.arange(c["h"]), indexing="ij")
            parts.append(((my * c["v"] + v) * c["bw"] + mx * c["h"] + h).reshape(frame["my"], frame["mx"], -1) * 64)
        per = [p.shape[-1] for p in parts]
        base = np.concatenate(parts, -1).reshape(-1)
        cis = np.tile(np.repeat([ci for ci, _, _ in scomps], per), frame["my"] * frame["mx"])
        units, per_unit = frame["my"] * frame["mx"], sum(per)
    interval = restart or units
    count = -(-units // interval)
    order = list(zip(cis.tolist(), base.tolist()))
    step = interval * per_unit
    groups = [order[i : i + step] for i in range(0, len(order), step)]
    dc_tabs, ac_tabs = [None] * len(comps), [None] * len(comps)
    for ci, td, ta in scomps:
        need_dc, need_ac = ss == 0 and ah == 0, ss > 0 or not progressive
        if need_dc and td not in dc_tables:
            raise ValueError(f"{name}: JPEG scan without its DC Huffman table {td}")
        if need_ac and ta not in ac_tables:
            raise ValueError(f"{name}: JPEG scan without its AC Huffman table {ta}")
        dc_tabs[ci], ac_tabs[ci] = dc_tables.get(td), ac_tables.get(ta)
    segments = _segments(data, count, name)
    if progressive:
        _scan_progressive(segments, groups, coefs, dc_tabs, ac_tabs, ss, se, ah, al, name)
        for ci, _, _ in scomps:
            bits = frame.setdefault("bits", {}).setdefault(ci, [-1] * 64)
            for k in range(ss, se + 1):
                bits[k] = al
    else:
        _scan_sequential(segments, groups, coefs, dc_tabs, ac_tabs, name)


def _finish(frame, coefs, latched, adobe, jfif, name) -> np.ndarray:
    comps = frame["comps"]
    for bits in frame.get("bits", {}).values():
        # libjpeg block-smooths a progressive file whose scans leave its DC
        # known and any of the first 9 AC coefficients incomplete
        # (jdcoefct.c, smoothing_ok)
        if bits[0] >= 0 and any(b != 0 for b in bits[1:10]):
            raise ValueError(f"{name}: progressive JPEG whose scans leave coefficients 1-9 incomplete (libjpeg "
                             "block-smooths those; the decoder reads files whose scans complete them)")
    planes = []
    for ci, c in enumerate(comps):
        if latched[ci] is None:
            raise ValueError(f"{name}: JPEG with a component no scan covers")
        blocks = np.asarray(coefs[ci], np.int64).reshape(-1, 64)
        pix = idct_islow(blocks, latched[ci]).reshape(c["bh"], c["bw"], 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(c["bh"] * 8, c["bw"] * 8)[: c["hgt"], : c["w"]]
        up = _upsample(plane, frame["hmax"] // c["h"], frame["vmax"] // c["v"])
        planes.append(up[: frame["h"], : frame["w"]])
    if len(planes) == 1:
        return planes[0][..., None]
    ids = [c["id"] for c in comps]
    rgb = (not jfif) and ((adobe == 0) if adobe is not None else ids == [82, 71, 66])
    if rgb:
        return np.stack(planes, -1)
    return ycc_to_rgb(*planes)


# --- the encoder -----------------------------------------------------------

# jcparam.c's std_luminance_quant_tbl and std_chrominance_quant_tbl (natural order)
STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)

# jcparam.c's std_huff_tables: (bits, values) of DC and AC, luminance and chrominance
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a34"
    "35363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a9293949596"
    "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1"
    "f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26272829"
    "2a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a82838485868788898a929394"
    "95969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9ea"
    "f2f3f4f5f6f7f8f9fa"))


def quality_tables(quality: int = 75):
    """jpeg_set_quality(quality, force_baseline=TRUE): the standard tables
    scaled (natural order)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (STD_LUMA, STD_CHROMA))


def _codes(table):
    """A (bits, values) table -> {symbol: (code, length)}."""
    bits, values = table
    codes, code, i = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[i]] = (code, length)
            code, i = code + 1, i + 1
        code <<= 1
    return codes


def _rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's rgb_ycc_convert (SCALEBITS 16, Cb and Cr rounded by
    0.5 - epsilon)."""
    def fix(v):
        return int(v * (1 << 16) + 0.5)

    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b + offset + half - 1) >> 16
    cr = (fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _pad(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Replicate the last row and column out to (h, w)."""
    return np.pad(plane, ((0, h - plane.shape[0]), (0, w - plane.shape[1])), mode="edge")


def _downsample(full: np.ndarray, fx: int, fy: int) -> np.ndarray:
    """jcsample.c's downsampling of a full-size plane padded to whole
    output samples: h2v1_downsample (bias 0, 1, 0, 1, ... along each
    output row), h2v2_downsample (bias 1, 2, 1, 2, ...), int_downsample
    for h1v2 (the mean rounded half up)."""
    x = full.astype(np.int64)
    if (fx, fy) == (1, 1):
        return x
    if fy == 1:
        s, biases = x[:, 0::2] + x[:, 1::2], (0, 1)
    elif fx == 1:
        return (x[0::2] + x[1::2] + 1) >> 1
    else:
        s, biases = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2], (1, 2)
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, *biases)
    return (s + bias) >> (fx * fy // 2)


def _quantize(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg's quantize: sign(c) floor((|c| + q / 2) / q) with q the
    table times 8 (the FDCT's scale)."""
    div = (q.astype(np.int64) * 8).reshape(8, 8)
    mag = (np.abs(coef) + (div >> 1)) // div
    return np.where(coef < 0, -mag, mag)


def _blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    return plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)


def encode(img: np.ndarray, quality: int = 75, sampling: tuple = (2, 2)) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of a baseline JFIF JPEG as
    Pillow's save writes them: quality 75 and 4:2:0 (luma ``sampling``
    (2, 2), chroma 1 x 1) by default; (1, 1) is 4:4:4, (2, 1) 4:2:2 and
    (1, 2) 4:4:0."""
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"the JPEG encoder takes uint8 (H, W) or (H, W, 3), got {img.dtype} {img.shape}")
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a JPEG is 1-65535 pixels on a side, got {h} x {w}")
    if tuple(sampling) not in ((1, 1), (2, 1), (1, 2), (2, 2)):
        raise ValueError(f"JPEG luma sampling factors {sampling}; the encoder writes 1 or 2 each way")
    qluma, qchroma = quality_tables(quality)
    if img.ndim == 2:
        planes, factors, tables = [img.astype(np.int64)], [(1, 1)], [0]
    else:
        planes, factors, tables = list(_rgb_to_ycc(img)), [tuple(sampling), (1, 1), (1, 1)], [0, 1, 1]
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    comp_blocks = []
    for plane, (fh, fv), t in zip(planes, factors, tables):
        cw, ch = -(-w * fh // hmax), -(-h * fv // vmax)  # the component's samples
        bw, bh = -(-cw // 8), -(-ch // 8)  # its real blocks (width_in_blocks, height_in_blocks)
        ex, ey = hmax // fh, vmax // fv
        # the input rows padded to the row group, its columns to the output's
        # whole blocks, downsampled, then the output rows out to whole blocks
        full = _pad(plane, -(-h // vmax) * vmax, bw * 8 * ex)
        data = _pad(_downsample(full, ex, ey), bh * 8, bw * 8)
        q = qluma if t == 0 else qchroma
        coef = fdct_islow(_blocks(data - 128, bh, bw).reshape(-1, 8, 8))
        quantized = _quantize(coef, q).reshape(bh, bw, 64)[:, :, ZIGZAG]
        # the MCU grid: dummy blocks right of and below the real ones, AC 0
        grid = np.zeros((my * fv, mx * fh, 64), np.int64)
        grid[:bh, :bw] = quantized
        for bx in range(bw, mx * fh):  # the block to the left's DC, within each MCU
            grid[:bh, bx, 0] = grid[:bh, bx - 1, 0]
        for by in range(bh, my * fv):  # a dummy row: the DC of the MCU's last block above
            for m in range(mx):
                grid[by, m * fh : (m + 1) * fh, 0] = grid[by - 1, (m + 1) * fh - 1, 0]
        comp_blocks.append((grid, fh, fv, t))
    return _assemble(h, w, comp_blocks, (qluma, qchroma), mx, my)


def _assemble(h, w, comp_blocks, quant, mx, my) -> bytes:
    out = bytearray(b"\xff\xd8")
    out += b"\xff\xe0" + struct.pack(">H5sBBBHHBB", 16, b"JFIF\x00", 1, 1, 0, 1, 1, 0, 0)
    used = sorted({t for *_, t in comp_blocks})
    for t in used:
        out += b"\xff\xdb" + struct.pack(">HB", 67, t) + bytes(quant[t][ZIGZAG].astype(np.uint8))
    nc = len(comp_blocks)
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * nc, 8, h, w, nc)
    for i, (_, fh, fv, t) in enumerate(comp_blocks):
        out += bytes([i + 1, (fh << 4) | fv, t])
    huff = {0: (DC_LUMA, AC_LUMA), 1: (DC_CHROMA, AC_CHROMA)}
    for t in used:
        for cls, table in ((0, huff[t][0]), (1, huff[t][1])):
            bits, values = table
            body = bytes([(cls << 4) | t]) + bytes(bits) + bytes(values)
            out += b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * nc, nc)
    for i, (*_, t) in enumerate(comp_blocks):
        out += bytes([i + 1, (t << 4) | t])
    out += bytes([0, 63, 0])
    out += _entropy(comp_blocks, huff, mx, my)
    out += b"\xff\xd9"
    return bytes(out)


def _entropy(comp_blocks, huff, mx, my) -> bytes:
    """jchuff.c's encode_one_block over the MCUs, bits packed MSB first,
    0xFF stuffed with 0x00, the last byte padded with 1 bits."""
    codes = {t: (_codes(dc), _codes(ac)) for t, (dc, ac) in huff.items()}
    # each MCU's blocks: each component's fv x fh in raster order, in turn
    per_mcu = [grid.reshape(my, fv, mx, fh, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, fv * fh, 64)
               for grid, fh, fv, _ in comp_blocks]
    blocks = np.concatenate(per_mcu, axis=2).reshape(-1, 64).tolist()
    comp_of = [ci for ci, g in enumerate(per_mcu) for _ in range(g.shape[2])]
    per = len(comp_of)
    acc, nacc = 0, 0
    out = bytearray()
    pred = [0] * len(comp_blocks)
    for i, blk in enumerate(blocks):
        ci = comp_of[i % per]
        dc_codes, ac_codes = codes[comp_blocks[ci][3]]
        diff = blk[0] - pred[ci]
        pred[ci] = blk[0]
        parts = []
        nbits = abs(diff).bit_length()
        parts.append(dc_codes[nbits])
        if nbits:
            parts.append(((diff - 1 if diff < 0 else diff) & ((1 << nbits) - 1), nbits))
        run = 0
        for k in range(1, 64):
            v = blk[k]
            if v == 0:
                run += 1
                continue
            while run > 15:
                parts.append(ac_codes[0xF0])
                run -= 16
            nbits = abs(v).bit_length()
            parts.append(ac_codes[(run << 4) | nbits])
            parts.append(((v - 1 if v < 0 else v) & ((1 << nbits) - 1), nbits))
            run = 0
        if run:
            parts.append(ac_codes[0x00])
        for code, length in parts:
            acc = (acc << length) | code
            nacc += length
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1
    if nacc:
        byte = ((acc << (8 - nacc)) | ((1 << (8 - nacc)) - 1)) & 0xFF
        out.append(byte)
        if byte == 0xFF:
            out.append(0)
    return bytes(out)
