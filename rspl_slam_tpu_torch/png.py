"""Images without PIL: the port's stand-in for PIL.

:func:`read_gray` returns what ``PIL.Image.open(p).convert("L")`` returns,
as (H, W) uint8, for every file PIL 12.1 reads that the port reads: PNG
(every colour type, bit depth and interlace), JPEG (every kind
libjpeg-turbo decodes for PIL: sequential, progressive and lossless,
Huffman or arithmetic coded, gray, YCbCr, RGB, CMYK, YCCK), netpbm P1-P6
at any maxval, Pillow's own P0CMYK and Py kinds and gray PFM, TIFF (every
mode of PIL's ``OPEN_INFO``, uncompressed, PackBits, LZW or Deflate with
PIL's quirks, and JPEG, old-style JPEG, CCITT and compressed YCbCr as
libtiff hands them to PIL; transposed by its Orientation tag as PIL
transposes it), BMP and the headerless DIB, GIF (frame 0), WebP
(lossless, lossy, with alpha, frame 0 of an animation), QOI, Sun raster,
PCX, SGI, TGA, ICO, CUR, DDS (bit masks, luminance, palette, BC1-BC7 with
BC6H), PSD, DCX, BLP, FTEX and ICNS. RGB becomes gray with PIL's
fixed-point luma, ``(R·19595 + G·38470 + B·7471 + 0x8000) >> 16``; alpha
and tRNS are dropped, as PIL drops them.

8-bit non-interlaced PNGs in gray, gray + alpha, RGB and RGBA (what the
EuRoC-class datasets hold) decode here with zlib and numpy: their chunks
walked as PIL's PNG plugin walks them (``native.png_layout`` and
``native.png_tail``: CRCs checked before the first IDAT only, the image
data from the first run of IDATs), zlib fed one row at a time as Pillow
feeds it, the row filters undone in numpy and Python
(:func:`unfilter_numpy`, Sub and Up vectorized) or, with ``compiled``, in
the host C++ loop of ``csrc/png_unfilter.cu`` (:func:`unfilter_compiled`,
built by ``ops/cuda_build`` at first use); the two agree bit for bit.
Every other file goes to the host C++ of ``native.py``
(``csrc/native_runtime.cpp`` and the headers it includes), which tells
the format as PIL's ``Image.open`` does, trying PIL's plugins in their
order, whatever the extension. The kinds PIL refuses raise
``NotImplementedError`` naming the kind with PIL's reason, and so do the
formats and kinds PIL reads that the port does not yet (JPEG 2000 of
the 9/7 wavelet, HT code-blocks or Part 2 markers; AVIF and every other plugin of PIL's the port does not read,
each named); a file no plugin of PIL's opens raises ``ValueError``.
(TIFF's LZMA, ZSTD and ThunderScan, and reversible JPEG 2000, read as
PIL reads them; TIFF's WebP and SGILog are refused as PIL refuses
them.)

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
    raise NotImplementedError(f"{what} is not read by read_png; read_gray decodes it "
                              "through native.decode_u8")


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
def _inflate(data: bytes, reads: list, rows: int, row_len: int) -> tuple[bytes, int]:
    """A PNG's image data as Pillow's ZipDecode inflates it: each read of
    ``reads`` (``native.png_layout``) handed to zlib one row of output (its
    filter byte first) at a time until the read is used up, done the
    moment the last row is full (zlib decodes on within that read while no
    symbol needs output, as in Pillow). Returns the rows and the read that
    filled the last one; IOError where zlib fails, a row's filter byte is
    not 0-4, or the reads end first (PIL: "image file is truncated")."""
    z = zlib.decompressobj()
    out, left, done = bytearray(), row_len + 1, 0
    for k, (a, b) in enumerate(reads):
        tail = data[a:b]
        while tail:
            try:
                got = z.decompress(tail, left)
            except zlib.error as e:
                raise IOError(f"broken PNG data stream: {e}") from None
            tail = z.unconsumed_tail
            out += got
            left -= len(got)
            if left:
                break
            if out[done * (row_len + 1)] > 4:
                raise IOError("unrecognized PNG data stream contents (a filter type above 4)")
            done += 1
            if done == rows:
                return bytes(out), k
            left = row_len + 1
    raise IOError("PNG image file is truncated")


def _plain(layout: dict) -> bool:
    """An 8-bit PNG in gray, gray + alpha, RGB or RGBA, not interlaced and
    not an APNG frame smaller than its image (:func:`read_png` decodes it)."""
    return (layout["depth"] == 8 and layout["ctype"] in _SAMPLES and not layout["interlaced"]
            and not layout["tiled"])


def _read(data: bytes, layout: dict, compiled: bool) -> np.ndarray:
    from rspl_slam_tpu_torch import native

    H, W = layout["size"]
    bpp = _SAMPLES[layout["ctype"]]
    raw, read = _inflate(data, layout["reads"], H, W * bpp)
    native.png_tail(data, read)
    fn = unfilter_compiled if compiled else unfilter_numpy
    return fn(raw, H, W * bpp, bpp).reshape(H, W, bpp)


def read_png(data: bytes, compiled: bool = False) -> np.ndarray:
    """8-bit non-interlaced PNG bytes → (H, W, samples) uint8 (1 gray,
    2 gray + alpha, 3 RGB, 4 RGBA), as PIL reads the file: the chunks as
    its PNG plugin walks them (``native.png_layout``, ``native.png_tail``),
    the data through zlib here. ``compiled``: undo the filters with the
    C++ loop rather than numpy."""
    from rspl_slam_tpu_torch import native

    layout = native.png_layout(data) if data[:8] == _SIG else None
    if layout is None:
        raise ValueError("not a PNG file PIL opens")
    if layout["ctype"] == 3:
        _unsupported("a palette PNG")
    if layout["depth"] != 8:
        _unsupported(f"a {layout['depth']}-bit PNG")
    if layout["interlaced"]:
        _unsupported("an interlaced PNG")
    if layout["tiled"]:
        _unsupported("an APNG frame smaller than its image")
    return _read(data, layout, compiled)


def to_luma(pixels: np.ndarray) -> np.ndarray:
    """(H, W, samples) uint8 → (H, W) uint8 as PIL's ``convert("L")``:
    gray passes, alpha drops, RGB takes the fixed-point ITU-R 601 luma."""
    if pixels.shape[-1] in (1, 2):
        return np.ascontiguousarray(pixels[..., 0])
    rgb = pixels[..., :3].astype(np.uint32)
    y = rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000
    return (y >> 16).astype(np.uint8)


def read_gray(path: str, compiled: bool = False) -> np.ndarray:
    """An image file → (H, W) uint8 gray, equal to PIL's
    ``Image.open(path).convert("L")`` on the files this module reads.
    ``compiled``: the row-unfilter route of 8-bit PNGs (see the module)."""
    from rspl_slam_tpu_torch import native

    with open(path, "rb") as f:
        data = f.read()
    layout = native.png_layout(data) if data[:8] == _SIG else None
    if layout is not None and _plain(layout):
        return to_luma(_read(data, layout, compiled))
    # the C++ tells the format as Image.open does (ValueError where no plugin opens it)
    return native.decode_u8(data, path)


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

