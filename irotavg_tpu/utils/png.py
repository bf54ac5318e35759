"""Grayscale image codec with numpy + zlib only: PNG read/write, binary PGM
read.

The reader covers what camera sequences ship as: 8-bit, non-interlaced
PNG of colour types 0 (gray), 2 (RGB), 4 (gray+alpha) and 6 (RGBA) with
any of the five row filters, and binary (P5) PGM.  Colour is converted
with PIL's ``L`` weights (ITU-R 601-2 luma in 16-bit fixed point), so a
frame decodes to the same pixels it would through PIL; alpha is dropped.
Anything else raises ``ValueError`` naming what is unsupported.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def read_gray(path: str) -> np.ndarray:
    """Decode a PNG or binary PGM file to a (H, W) uint8 gray image."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(_SIG):
        return _decode_png(data, path)
    if data.startswith(b"P5"):
        return _decode_pgm(data, path)
    raise ValueError(f"{path}: not a PNG or binary PGM file")


def write_png(path: str, image: np.ndarray) -> None:
    """Encode a (H, W) gray or (H, W, 3|4) RGB(A) uint8 array as PNG."""
    im = np.asarray(image)
    if im.dtype != np.uint8:
        raise ValueError(f"write_png needs uint8 pixels, got {im.dtype}")
    if im.ndim == 2:
        color = 0
    elif im.ndim == 3 and im.shape[2] in (3, 4):
        color = 2 if im.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png: unsupported shape {im.shape}")
    h, w = im.shape[:2]
    rows = im.reshape(h, -1)
    # filter type 0 (None) on every row
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIG)
        fh.write(_chunk(b"IHDR", ihdr))
        fh.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _decode_png(data: bytes, path: str) -> np.ndarray:
    pos = len(_SIG)
    ihdr = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color, _comp, _filt, interlace = ihdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace}); need 8-bit, colour type "
            "0/2/4/6, non-interlaced")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{path}: PNG image data has the wrong size")
    raw = raw.reshape(h, 1 + w * ch)
    px = _unfilter(raw[:, 0], raw[:, 1:], ch, path).reshape(h, w, ch)
    if ch <= 2:
        return px[:, :, 0].copy()
    rgb = px[:, :, :3].astype(np.uint32)
    lum = rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470 + rgb[:, :, 2] * 7471
    return ((lum + 0x8000) >> 16).astype(np.uint8)


def _unfilter(ftype, rows, bpp, path):
    """Undo the per-row PNG filters (spec section 9)."""
    h, stride = rows.shape
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f = int(ftype[y])
        cur = rows[y]
        if f == 0:
            rec = cur
        elif f == 1:
            # Sub: running sum along each channel (uint8 wraps mod 256)
            rec = np.cumsum(cur.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:
            rec = cur + prior
        elif f in (3, 4):
            rec = _unfilter_sequential(f, cur, prior, bpp)
        else:
            raise ValueError(f"{path}: bad PNG filter type {f} in row {y}")
        out[y] = rec
        prior = out[y]
    return out


def _unfilter_sequential(f, cur, prior, bpp):
    """Average (3) and Paeth (4) depend on the reconstructed left byte."""
    c = cur.tolist()
    b = prior.tolist()
    rec = bytearray(len(c))
    for i in range(len(c)):
        a = rec[i - bpp] if i >= bpp else 0
        if f == 3:
            rec[i] = (c[i] + ((a + b[i]) >> 1)) & 0xFF
        else:
            ul = b[i - bpp] if i >= bpp else 0
            p = a + b[i] - ul
            pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - ul)
            pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else ul)
            rec[i] = (c[i] + pred) & 0xFF
    return np.frombuffer(bytes(rec), np.uint8)


def _decode_pgm(data: bytes, path: str) -> np.ndarray:
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: malformed PGM header")
        fields.append(int(data[start:pos]))
    w, h, maxval = fields
    if not 0 < maxval < 256:
        raise ValueError(f"{path}: PGM maxval {maxval} unsupported; need "
                         "8-bit samples")
    pos += 1                                   # the single whitespace byte
    px = np.frombuffer(data, np.uint8, count=w * h, offset=pos)
    return px.reshape(h, w).copy()
