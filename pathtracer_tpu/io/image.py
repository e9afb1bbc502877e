"""Image output: PNG and Radiance HDR writers.

Replicates the reference's save path (Image::savePNG/saveHDR, src/image.cpp:
23-50, driven by saveImage at src/main.cpp:395-419): PNG is clamp(pix,0,1)*255
3-channel; saveImage mirrors x (width-1-x) and names files
"<name>.<timestamp>.<N>samp.png".

PNG is written and read with numpy and zlib alone: 8-bit, non-interlaced
RGB (and RGBA or grey on read), the format of the reference's renders.
"""
from __future__ import annotations

import struct
import time
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # PNG colour type -> samples per pixel


def to_uint8(img: np.ndarray) -> np.ndarray:
    """HDR float [H,W,3] -> clamped 8-bit (image.cpp:28-38)."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """[H,W,3] uint8 -> PNG bytes (filter 0 on every row)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, c = arr.shape
    assert c == 3, "RGB only"
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth_row(cur: np.ndarray, prior: np.ndarray, bpp: int) -> None:
    """Undo the Paeth filter in place (sequential along the row)."""
    a_ = [0] * bpp
    c_ = [0] * bpp
    line = cur.tolist()
    up = prior.tolist()
    for i, x in enumerate(line):
        k = i % bpp
        a, b, c = a_[k], up[i], c_[k]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        v = (x + pred) & 0xFF
        line[i] = v
        a_[k], c_[k] = v, b
    cur[:] = line


def _avg_row(cur: np.ndarray, prior: np.ndarray, bpp: int) -> None:
    """Undo the Average filter in place (sequential along the row)."""
    line = cur.tolist()
    up = prior.tolist()
    for i, x in enumerate(line):
        left = line[i - bpp] if i >= bpp else 0
        line[i] = (x + ((left + up[i]) >> 1)) & 0xFF
    cur[:] = line


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H,W,C] uint8 (8-bit, non-interlaced, grey/RGB/RGBA)."""
    assert data[:8] == _PNG_SIG, "not a PNG"
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        f, cur = raw[y, 0], raw[y, 1:].copy()
        if f == 1:      # Sub: running sum per channel
            cur = np.cumsum(cur.reshape(w, bpp), axis=0, dtype=np.uint64)
            cur = (cur & 0xFF).astype(np.uint8).reshape(-1)
        elif f == 2:    # Up
            cur = cur + prior
        elif f == 3:
            _avg_row(cur, prior, bpp)
        elif f == 4:
            _paeth_row(cur, prior, bpp)
        elif f != 0:
            raise ValueError(f"bad PNG filter {f}")
        out[y] = cur
        prior = cur
    return out.reshape(h, w, bpp)


def save_png(img, path: str, mirror_x: bool = True) -> str:
    """Save averaged image as PNG. mirror_x replicates main.cpp:407."""
    arr = to_uint8(img)
    if mirror_x:
        arr = arr[:, ::-1, :]
    with open(path, "wb") as f:
        f.write(encode_png(arr))
    return path


def save_hdr(img, path: str, mirror_x: bool = True) -> str:
    """Minimal Radiance RGBE (.hdr) writer, flat (non-RLE) scanlines
    (image.cpp:45-50 equivalent)."""
    arr = np.asarray(img, dtype=np.float32)
    if mirror_x:
        arr = arr[:, ::-1, :]
    h, w, _ = arr.shape
    maxc = arr.max(axis=-1)
    valid = maxc >= 1e-32
    m, e = np.frexp(np.where(valid, maxc, 1.0))
    scale = np.where(valid, m * 256.0 / np.where(valid, maxc, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., 0] = np.clip(arr[..., 0] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 1] = np.clip(arr[..., 1] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 2] = np.clip(arr[..., 2] * scale, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(valid, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    return path


def reference_style_name(image_name: str, samples: int,
                         ext: str = "png") -> str:
    """"<FILE>.<UTC timestamp>.<N>samp.<ext>" (main.cpp:398-404)."""
    ts = time.strftime("%Y-%m-%d_%H-%M-%Sz", time.gmtime())
    return f"{image_name}.{ts}.{samples}samp.{ext}"


def load_png(path: str) -> np.ndarray:
    """PNG file -> [H,W,3] float32 in [0, 1] (grey expands, alpha drops)."""
    with open(path, "rb") as f:
        arr = decode_png(f.read())
    if arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    return arr[..., :3].astype(np.float32) / 255.0
