"""Gamma-corrected PNG I/O with the standard library only (port of
burn_raymarching_tpu/data/image_io.py, which uses Pillow).

Same transfer functions: save encodes linear → x^(1/2.2), clamps, scales
by 255 and truncates to uint8; load decodes with (x/255)^2.2. Images are
[H*W, 3] linear float32. The writer emits 8-bit RGB PNG (filter 0 on every
row); the reader undoes all five PNG row filters, so it also reads PNGs
written by Pillow (which picks filters adaptively).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# Channels per 8-bit color type: gray, RGB, gray+alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png_rgb(pixels: np.ndarray) -> bytes:
    """Encode a [H, W, 3] uint8 array as the bytes of an 8-bit RGB PNG."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w, c = pixels.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3] pixels, got {pixels.shape}")
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png_rgb(pixels: np.ndarray, path: str) -> None:
    """Write a [H, W, 3] uint8 array as an 8-bit RGB PNG."""
    data = encode_png_rgb(pixels)
    with open(path, "wb") as f:
        f.write(data)


def _chunks(data: bytes):
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        yield tag, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo one PNG row filter (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    if ftype == 0:
        return row
    if ftype == 1:
        r = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(r, axis=0) % 256).astype(np.uint8).reshape(-1)
    if ftype == 2:
        return (row.astype(np.int64) + prior) % 256
    out = row.astype(np.int64).tolist()
    b = prior.astype(np.int64).tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if ftype == 3:
            out[i] = (out[i] + ((a + b[i]) >> 1)) & 255
        elif ftype == 4:
            c = b[i - bpp] if i >= bpp else 0
            p = a + b[i] - c
            pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
            out[i] = (out[i] + pred) & 255
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
    return np.asarray(out, np.int64)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG → [H, W, 3] uint8 RGB (alpha
    dropped, gray expanded)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``read_png`` of the bytes of a PNG."""
    idat = []
    hdr = None
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, color "
                         f"type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * ch)
    img = np.zeros((h, w * ch), np.uint8)
    prior = np.zeros(w * ch, np.int64)
    for y in range(h):
        row = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, ch)
        img[y] = row
        prior = img[y].astype(np.int64)
    img = img.reshape(h, w, ch)
    if ch in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def save_array_as_image(arr, width: int, height: int, path: str) -> None:
    """Save a [H*W, 3] (or [H, W, 3]) linear float array as a gamma-2.2 PNG."""
    a = np.asarray(arr, dtype=np.float32).reshape(height, width, 3)
    a = np.clip(a, 0.0, 1.0)
    pixels = (a ** (1.0 / 2.2) * 255.0).astype(np.uint8)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    write_png_rgb(pixels, path)


def load_image_as_array(path: str) -> np.ndarray:
    """Load a PNG → [H*W, 3] linear float32 via gamma-2.2 decode."""
    pixels = np.asarray(read_png(path), dtype=np.float32) / 255.0
    return (pixels ** 2.2).reshape(-1, 3)


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of a PNG file."""
    with open(path, "rb") as f:
        head = f.read(33)
    tag, body = next(_chunks(head))
    if tag != b"IHDR":
        raise ValueError(f"{path}: first chunk is not IHDR")
    w, h = struct.unpack(">II", body[:8])
    return w, h
