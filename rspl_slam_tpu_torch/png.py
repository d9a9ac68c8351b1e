"""PNG and PGM images with zlib and numpy: the port's stand-in for PIL.

:func:`read_gray` returns what ``PIL.Image.open(p).convert("L")`` returns,
as (H, W) uint8, for 8-bit PNGs in gray, gray + alpha, RGB and RGBA (every
row filter) and for binary PGM (P5, maxval 255). RGB becomes gray with
PIL's fixed-point luma, ``(R·19595 + G·38470 + B·7471 + 0x8000) >> 16``;
alpha is dropped, as PIL drops it. Interlaced, palette and 16-bit PNGs and
JPEG raise ``NotImplementedError`` (ROADMAP.md §1, item 4b).

Undoing the row filters is the decode's one sequential step: Avg and
Paeth read the pixel to the left. :func:`unfilter_numpy` does it in numpy
and Python (Sub and Up vectorized); :func:`unfilter_compiled` calls the
host C++ loop of ``csrc/png_unfilter.cu``, built by ``ops/cuda_build`` at
first use. The two agree bit for bit.

:func:`write_png` writes 8-bit PNGs with one fixed filter or, by default,
the filter per row that minimizes the sum of the filtered bytes read as
signed (libpng's heuristic).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["read_gray", "read_png", "to_luma", "write_png", "unfilter_numpy",
           "unfilter_compiled", "FILTERS"]

_SIG = b"\x89PNG\r\n\x1a\n"
_SAMPLES = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type → samples per pixel
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
FILTERS = ("none", "sub", "up", "avg", "paeth")


def _unsupported(what: str):
    raise NotImplementedError(f"{what} is not read by the port's image reader "
                              "(ROADMAP.md §1, item 4b)")


# ------------------------------------------------------------------ filters
def _paeth(a, b, c):
    """Paeth predictor of int arrays (left, up, up-left)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_numpy(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of decompressed PNG data: ``raw`` holds
    ``height`` rows of a filter byte and ``stride`` bytes; returns the
    (height, stride) uint8 samples. ``bpp``: bytes per pixel."""
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        f, r = int(rows[y, 0]), rows[y, 1:]
        if f == 0:
            cur = r.copy()
        elif f == 1:
            cur = np.cumsum(r.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:
            cur = r + prior
        elif f in (3, 4):
            cur = _unfilter_row_seq(f, r.tolist(), prior.tolist(), bpp)
        else:
            raise ValueError(f"invalid PNG filter type {f} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def _unfilter_row_seq(f: int, r: list, p: list, bpp: int) -> np.ndarray:
    """Avg (3) or Paeth (4) on one row, byte by byte (each byte reads the
    one ``bpp`` to its left)."""
    cur = [0] * len(r)
    for i in range(len(r)):
        a = cur[i - bpp] if i >= bpp else 0
        b = p[i]
        if f == 3:
            cur[i] = (r[i] + ((a + b) >> 1)) & 255
        else:
            c = p[i - bpp] if i >= bpp else 0
            q = a + b - c
            pa, pb, pc = abs(q - a), abs(q - b), abs(q - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (r[i] + pred) & 255
    return np.asarray(cur, np.uint8)


def unfilter_compiled(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """:func:`unfilter_numpy` through the host C++ loop of
    ``csrc/png_unfilter.cu`` (built with nvcc at first use; a failed build
    raises)."""
    from rspl_slam_tpu_torch.ops import cuda_build

    src = np.frombuffer(raw, np.uint8, height * (stride + 1))
    out = np.empty((height, stride), np.uint8)
    cuda_build.launch("png_unfilter", "png_unfilter", src.ctypes.data, out.ctypes.data,
                      height, stride, bpp)
    return out


# ----------------------------------------------------------------- reading
def read_png(data: bytes, compiled: bool = False) -> np.ndarray:
    """8-bit non-interlaced PNG bytes → (H, W, samples) uint8 (1 gray,
    2 gray + alpha, 3 RGB, 4 RGBA). ``compiled``: undo the filters with the
    C++ loop rather than numpy."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = hdr
    if ctype == 3:
        _unsupported("a palette PNG")
    if depth != 8:
        _unsupported(f"a {depth}-bit PNG")
    if interlace:
        _unsupported("an interlaced PNG")
    if ctype not in _SAMPLES:
        raise ValueError(f"invalid PNG colour type {ctype}")
    bpp = _SAMPLES[ctype]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < H * (W * bpp + 1):
        raise ValueError("truncated PNG image data")
    fn = unfilter_compiled if compiled else unfilter_numpy
    return fn(raw, H, W * bpp, bpp).reshape(H, W, bpp)


def to_luma(pixels: np.ndarray) -> np.ndarray:
    """(H, W, samples) uint8 → (H, W) uint8 as PIL's ``convert("L")``:
    gray passes, alpha drops, RGB takes the fixed-point ITU-R 601 luma."""
    if pixels.shape[-1] in (1, 2):
        return np.ascontiguousarray(pixels[..., 0])
    rgb = pixels[..., :3].astype(np.uint32)
    y = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000
    return (y >> 16).astype(np.uint8)


def _read_pgm(data: bytes) -> np.ndarray:
    """Binary PGM (P5, maxval 255) → (H, W) uint8."""
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    W, H, maxval = fields
    if maxval != 255:
        _unsupported(f"a PGM with maxval {maxval}")
    pos += 1  # the one whitespace byte before the samples
    return np.frombuffer(data, np.uint8, W * H, pos).reshape(H, W).copy()


def read_gray(path: str, compiled: bool = False) -> np.ndarray:
    """An image file → (H, W) uint8 gray, equal to PIL's
    ``Image.open(path).convert("L")`` on the files this module reads."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIG:
        return to_luma(read_png(data, compiled))
    if data[:2] == b"P5":
        return _read_pgm(data)
    if data[:3] == b"\xff\xd8\xff":
        _unsupported("JPEG")
    raise ValueError(f"{path}: not a PNG or binary PGM file")


# ----------------------------------------------------------------- writing
def _filtered(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Every row under each of the five filters: (5, H, stride) uint8."""
    x = rows.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[:, bpp:] = up[:, :-bpp]
    preds = (0, left, up, (left + up) >> 1, _paeth(left, up, upleft))
    return np.stack([(x - p) & 255 for p in preds]).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, img: np.ndarray, filter_type: str | None = None,
              level: int = 6) -> None:
    """Write an 8-bit PNG: ``img`` (H, W) gray or (H, W, 2|3|4) gray + alpha,
    RGB, RGBA. ``filter_type``: one of :data:`FILTERS` for every row, or
    None to choose per row (least sum of |filtered bytes| read as signed)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    H, W, bpp = img.shape
    if bpp not in _COLOR_TYPE:
        raise ValueError(f"cannot write {bpp} samples per pixel as PNG")
    cand = _filtered(img.reshape(H, W * bpp), bpp)
    if filter_type is None:
        cost = np.abs(cand.view(np.int8).astype(np.int64)).sum(-1)  # (5, H)
        choice = cost.argmin(0)
    else:
        choice = np.full(H, FILTERS.index(filter_type))
    body = np.concatenate([choice.astype(np.uint8)[:, None],
                           cand[choice, np.arange(H)]], 1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[bpp], 0, 0, 0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(body.tobytes(), level))
                + _chunk(b"IEND", b""))

