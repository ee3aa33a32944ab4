"""Host-side image / volume I/O (counterpart of drtvam_tpu/utils/io.py,
numpy only).

A small self-contained OpenEXR v2 codec:
  * write: single-part scanline, float32, uncompressed;
  * read: uncompressed, ZIPS and ZIP scanline images, float32/half.

`save_vol` tiles the Z-slices of a (Z, Y, X, C) volume into a square
mosaic image, so the artifact files match the JAX package's.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIX_HALF, _PIX_FLOAT = 1, 2


def _attr(name, atype, payload):
    return name.encode() + b"\0" + atype.encode() + b"\0" + \
        struct.pack("<i", len(payload)) + payload


def write_exr(path, img):
    """Write (H, W) or (H, W, C) float array; C in (1, 3). Channels are
    'Y' (1ch) or B,G,R (3ch), float32, no compression."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c == 1:
        names = ["Y"]
    elif c == 3:
        names = ["B", "G", "R"]  # alphabetical storage order
        img = img[..., ::-1]     # so channel i stores B,G,R
    else:
        raise ValueError(f"EXR writer supports 1 or 3 channels, got {c}")

    chans = b""
    for n in names:
        chans += n.encode() + b"\0" + struct.pack("<i", _PIX_FLOAT) + \
            b"\0\0\0\0" + struct.pack("<ii", 1, 1)
    chans += b"\0"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += _attr("channels", "chlist", chans)
    header += _attr("compression", "compression", b"\0")
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    start = 8 + len(header) + 8 * h
    row_bytes = 8 + c * w * 4
    offsets = struct.pack(f"<{h}Q", *(start + y * row_bytes
                                      for y in range(h)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<iI", _MAGIC, 2))
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, c * w * 4))
            f.write(img[y].T.astype("<f4").tobytes())


def _unzip_block(data, n_bytes):
    raw = bytearray(zlib.decompress(data))
    if len(raw) != n_bytes:
        raise ValueError("corrupt EXR zip block")
    # undo delta predictor
    for i in range(1, len(raw)):
        raw[i] = (raw[i] + raw[i - 1] - 128) & 0xFF
    # de-interleave: first half = even bytes, second half = odd bytes
    out = bytearray(len(raw))
    half = (len(raw) + 1) // 2
    out[0::2] = raw[:half]
    out[1::2] = raw[half:]
    return bytes(out)


def read_exr(path):
    """Read a scanline EXR into (H, W) or (H, W, C) float32.

    Supports NO/ZIPS/ZIP compression, FLOAT and HALF channels. A lone
    'Y'/'L' channel returns (H, W); R,G,B(,A) return (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<iI", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\0", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\0", pos)
        atype = data[pos:e].decode()
        pos = e + 1
        size, = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = (atype, data[pos:pos + size])
        pos += size
    pos += 1

    # channels
    chan_raw = attrs["channels"][1]
    channels = []
    cp = 0
    while chan_raw[cp] != 0:
        e = chan_raw.index(b"\0", cp)
        cname = chan_raw[cp:e].decode()
        cp = e + 1
        ptype, = struct.unpack_from("<i", chan_raw, cp)
        channels.append((cname, ptype))
        cp += 16
    comp = attrs["compression"][1][0]
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    if comp == 0:
        lines_per_block = 1
    elif comp in (2, 3):  # ZIPS, ZIP
        lines_per_block = 1 if comp == 2 else 16
    else:
        raise ValueError(f"unsupported EXR compression {comp}")

    n_blocks = -(-h // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)

    dtypes = {_PIX_HALF: np.dtype("<f2"), _PIX_FLOAT: np.dtype("<f4")}
    out = {name: np.zeros((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        y, nb = struct.unpack_from("<ii", data, off)
        block = data[off + 8:off + 8 + nb]
        ny = min(lines_per_block, y1 - y + 1)
        row_bytes = sum(dtypes[pt].itemsize * w for _, pt in channels)
        if comp != 0:
            block = _unzip_block(block, row_bytes * ny)
        bp = 0
        for yy in range(ny):
            for name, pt in channels:
                n = dtypes[pt].itemsize * w
                row = np.frombuffer(block[bp:bp + n], dtype=dtypes[pt])
                out[name][y - y0 + yy] = row.astype(np.float32)
                bp += n

    names = [n for n, _ in channels]
    if len(names) == 1:
        return out[names[0]]
    order = [n for n in ("R", "G", "B", "A") if n in out] or names
    return np.stack([out[n] for n in order], -1)


def reshape_grid(array):
    """Tile (N, H, W[, C]) into a square (rows*H, rows*W, C) mosaic
    (reference utils.py:13-27)."""
    array = np.asarray(array)
    if array.ndim == 3:
        array = array[..., None]
    elif array.ndim != 4:
        raise ValueError(f"Invalid array shape: {array.shape}")
    n, h, w, c = array.shape
    rows = int(np.ceil(np.sqrt(n)))
    out = np.zeros((rows * rows, h, w, c), array.dtype)
    out[:n] = array
    return out.reshape(rows, rows, h, w, c).swapaxes(1, 2).reshape(
        rows * h, rows * w, c)


def save_img(img, path):
    """Single image -> EXR (reference utils.py:29-37)."""
    write_exr(path, np.asarray(img))


def save_vol(vol, path):
    """(Z, Y, X, C) volume -> Z-slice mosaic EXR (utils.py:39-46)."""
    write_exr(path, reshape_grid(np.asarray(vol)))
