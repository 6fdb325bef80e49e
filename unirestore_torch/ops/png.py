"""PNG decode and encode on the standard library's ``zlib`` and ``struct`` (and numpy).

The restore server reads uploads and writes answers with this codec, so it
needs no imaging package. ``decode`` takes non-interlaced PNGs of bit depth 8
in grey, grey + alpha, RGB and RGBA, and palette or grey at bit depths 1, 2,
4 or 8, with all five filter types, and returns RGB as PIL's
``Image.convert("RGB")`` does: alpha dropped, grey repeated, palette looked
up, sub-byte grey scaled to 0-255. ``encode`` writes 8-bit RGB. Other input
(JPEG, 16-bit, interlaced) raises ``UnsupportedImage``; ``read_rgb`` hands it
to PIL when PIL imports.

Unfiltering: each byte depends on its left, upper and upper-left neighbours
(Sub, Up, Average, Paeth), so ``_unfilter`` walks the anti-diagonals of the
(row, pixel) grid and reconstructs every cell of one diagonal at once, each
with its own row's filter: H + W numpy steps instead of H * W Python ones.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}


class UnsupportedImage(ValueError):
    """Input this codec does not decode: not a PNG, 16-bit, or interlaced."""


def _chunks(data: bytes):
    if not data.startswith(SIGNATURE):
        raise UnsupportedImage("not a PNG file")
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"truncated {ctype!r} chunk")
        (crc,) = struct.unpack(">I", data[end - 4:end])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"bad CRC in {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end
    raise ValueError("no IEND chunk")


def _unfilter(types: np.ndarray, filtered: np.ndarray, bpp: int) -> np.ndarray:
    """Reverse the per-row filters of (H, row_bytes) scanlines; ``bpp`` bytes per pixel."""
    h, n = filtered.shape
    if types.size and types.max() > 4:
        raise ValueError(f"unknown filter type {int(types.max())}")
    px = n // bpp
    f = filtered.reshape(h, px, bpp).astype(np.int32)
    r = np.zeros((h + 1, px + 1, bpp), np.int32)  # row 0 and column 0: the zero border
    kind = types.astype(np.int32)
    for d in range(h + px - 1):
        y = np.arange(max(0, d - px + 1), min(h, d + 1))
        x = d - y
        a, b, c = r[y + 1, x], r[y, x + 1], r[y, x]  # left, up, up-left
        t = kind[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        r[y + 1, x + 1] = (f[y, x] + pred) & 255
    return r[1:, 1:].reshape(h, n).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB."""
    header, palette, idat = None, None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in _CHANNELS or compression != 0 or filtering != 0 or w == 0 or h == 0:
        raise ValueError(f"malformed IHDR {header}")
    if interlace:
        raise UnsupportedImage("interlaced PNG")
    if depth == 16:
        raise UnsupportedImage("16-bit PNG")
    if depth not in _DEPTHS[color]:
        raise ValueError(f"bit depth {depth} with colour type {color}")
    ch = _CHANNELS[color]
    row_bytes = (w * ch * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (row_bytes + 1):
        raise ValueError(f"image data holds {len(raw)} bytes, want {h * (row_bytes + 1)}")
    rows = np.frombuffer(raw, np.uint8, count=h * (row_bytes + 1)).reshape(h, row_bytes + 1)
    recon = _unfilter(rows[:, 0], rows[:, 1:], max(1, ch * depth // 8))

    if depth < 8:  # grey or palette indices, packed big-endian within each byte
        bits = np.unpackbits(recon, axis=1)[:, :w * depth].reshape(h, w, depth)
        samples = (bits.astype(np.uint16) << np.arange(depth - 1, -1, -1, dtype=np.uint16)).sum(-1)
        if color == 0:
            samples = samples * (255 // (2 ** depth - 1))
        samples = samples.astype(np.uint8)[..., None]
    else:
        samples = recon.reshape(h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError("palette image without a PLTE chunk")
        idx = samples[..., 0]
        if idx.max() >= len(palette):
            raise ValueError(f"palette index {int(idx.max())} past {len(palette)} entries")
        return palette[idx]
    if color in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode(rgb: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (8-bit RGB, no filtering, zlib ``level``)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"want (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, w * 3 + 1), np.uint8)  # filter byte 0 (None) on every row
    rows[:, 1:] = rgb.reshape(h, w * 3)
    return (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def read_rgb(data: bytes) -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8 RGB: PNG by ``decode``, anything else by
    PIL when it imports; without PIL that raises ``UnsupportedImage``."""
    try:
        return decode(data)
    except UnsupportedImage as e:
        try:
            from PIL import Image
        except ImportError:
            raise UnsupportedImage(f"{e}: this codec does not read it and PIL is not "
                                   "installed") from None
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
