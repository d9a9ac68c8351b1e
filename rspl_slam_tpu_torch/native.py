"""The port's native runtime (port of native.py): ctypes bindings of
``csrc/native_runtime.cpp``, host C++ built by ``ops/cuda_build`` with the
host compiler at first use into ``rspl_slam_tpu_torch/_build/``.

- :func:`decode_gray`: an image file of any format below → (H, W)
  float32 in [0, 1], the 8-bit gray of PIL's
  ``Image.open(p).convert("L")`` divided by 255 as
  ``datasets.EurocDataset`` divides it;
- :func:`decode_u8`: the same decode of an encoded image in memory, 8-bit;
  :func:`image_size` its size from the header; :func:`plugin_of` the PIL
  plugin that takes it;
- :func:`remap_bilinear`: ``camera.remap_bilinear``'s border clamp on the
  host;
- :func:`merge_lines`: the reference's MergeLines (``ops/lines.merge_lines``
  calls it);
- :class:`NativeStereoLoader`: decode threads that read, decode and
  optionally rectify stereo pairs ahead of the consumer, in order.

The decoder tells formats apart as PIL 12.1's ``Image.open`` does: it
tries PIL's plugins in their order (the preinit BMP, DIB, GIF, JPEG, PPM,
PNG, then ``Image.ID``), each by its accept test (or, for the plugins with
none, their open checks), and a plugin whose open fails as PIL's passes
the file on does so here too. It reads every kind PIL reads from: PNG of
every colour type, bit depth and interlace, its chunks walked as PIL's
plugin walks them (``csrc/native_png.h``: CRCs checked before the first
IDAT only, the image data from the first run of IDATs, frame 0 of an
APNG); JPEG sequential, progressive
(with libjpeg-turbo's block smoothing) and lossless, Huffman or
arithmetic coded, gray, YCbCr, RGB, CMYK and YCCK at any integral
sampling; netpbm P1-P6 at any maxval, Pillow's own P0CMYK and Py kinds
and gray PFM ("Pf"); TIFF
(``csrc/native_tiff.h``: classic and BigTIFF, both byte orders, strips
and tiles, planar 1 and 2, fill order 2, no compression, PackBits, LZW
and Deflate with predictors 2 and 3, every mode PIL's ``OPEN_INFO`` maps,
with PIL's own byte-order and planar quirks, a tag written twice read by
its last entry where PIL decides and its first where libtiff decodes; and
what libtiff hands PIL from its own codecs: LZMA (``native_xz.h``), ZSTD
(``native_zstd.h``), ThunderScan, new-style JPEG (``native_tiff_jpeg.h``),
compressed YCbCr and old-style JPEG (``native_tiff_ycbcr.h``), CCITT MH,
Group 3, Group 4 and RLEW (``native_fax3.h``); oriented as PIL's
``ImageOps.exif_transpose`` orients it); BMP and the headerless DIB
(``csrc/native_bmp.h``: every header size, 1-32 bits, RLE4, RLE8,
BITFIELDS, top-down rows); GIF frame 0 (``csrc/native_gif.h``); WebP as
libwebp 1.6.0 decodes it (``csrc/native_webp.h``, ``native_vp8.h``);
QOI, Sun raster (raw and RLE, colour maps), PCX (bit planes, the
256-colour palette), SGI (raw and RLE, 1 or 2 bytes a sample) and TGA
(types 1-3 and 9-11, colour maps, both orientation bits) as their
plugins and Pillow's decoders read them (``csrc/native_raster.h``); ICO
and CUR (``csrc/native_ico.h``: the entry PIL picks, PNG or DIB); DDS
(``csrc/native_bcn.h``: bit masks, luminance, palette, BC1-BC5, BC6H
unsigned and signed, BC7, as Pillow's bcn decoder decodes them); PSD's
merged image, raw or PackBits (``csrc/native_psd.h``), DCX (its first
PCX frame), BLP (JPEG, palettes, the plugin's own DXT1/3/5) and FTEX
(``csrc/native_blp.h``), ICNS (the best size's PNG or RLE icon,
``csrc/native_icns.h``); MSP, XBM, XPM, IM, IMT, IPTC (its data opened
again through every plugin), SPIDER, GBR, McIDAS, PIXAR, XVThumb and FITS
(raw, or a GZIP_1 tile) as their plugins read them
(``csrc/native_layouts.h``), frame 0 of FLI / FLC (``csrc/native_fli.h``)
and the PhotoCD base image (``csrc/native_raster.h``). JPEG is read as
libjpeg-turbo reads it behind Pillow's suspending source, markers,
damaged data and the data's end included. Kinds
PIL refuses (12-bit, hierarchical, DNL and fractional-sampling JPEG,
lossless YCbCr; TIFF modes missing from ``OPEN_INFO``, CIELAB; the BMP
headers, depths, compressions, masks and palettes PIL rejects; TIFF's
WebP, which Pillow's libtiff lacks, and SGILog, which libtiff refuses on
the photometrics PIL has modes for; GIF code
sizes above 12; WebP frames libwebp rejects; Sun, TGA colour maps PIL
cannot apply; PCX and SGI modes PIL has none for; DDS header sizes and
pixel formats PIL does not decode; Lab PSD; BLP kinds the plugin's
BLPFormatError names) and formats and kinds PIL reads that
the port does not yet (TIFF's 12-bit and short-stream new-style JPEG,
old-style JPEG in
tiles, on separate planes, in big-endian strips or with restart
intervals off the strips; JPEG 2000 (an ICNS of a JPEG 2000 best size
too), AVIF and every other plugin of PIL's the port does not read, each
by name; an IPTC file whose data is not a JPEG or 8-bit netpbm image of
mode L) raise ``NotImplementedError`` naming the kind or format. A
file no plugin of PIL's opens raises ``ValueError``, and a file that fails
to decode (libtiff's own failures included) ``IOError``, on every route:
the library's ``native_runtime_error_kind`` decides.

There is no fallback: where the library cannot be built, every entry point
raises.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np

__all__ = ["build", "available", "decode_gray", "decode_u8", "image_size", "plugin_of",
           "png_layout", "png_tail", "remap_bilinear", "merge_lines", "NativeStereoLoader"]

_NAME = "native_runtime"


def _lib():
    from rspl_slam_tpu_torch.ops import cuda_build

    return cuda_build.library(_NAME)


def build() -> bool:
    """Build (or find) the library; raises where the compiler fails."""
    _lib()
    return True


def available() -> bool:
    """True where the library builds and loads. The port's callers do not
    test this: they call and let a build failure raise."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _raise(rc: int, what: str):
    """Raise the exception the library's ``native_runtime_error_kind``
    names for error code ``rc``."""
    lib = _lib()
    msg = lib.native_runtime_error_string(rc).decode()
    kind = lib.native_runtime_error_kind(rc)
    if kind == 1:
        raise NotImplementedError(f"{what}: {msg}")
    if kind == 2:
        raise ValueError(f"{what}: {msg}")
    raise IOError(f"native decode failed ({msg}): {what}")


def image_size(data: bytes, what: str = "image header") -> tuple[int, int]:
    """(H, W) of an encoded image in memory, from its header."""
    buf = np.frombuffer(data, np.uint8)
    hw = np.zeros(2, np.int32)
    rc = _lib().native_image_size(buf.ctypes.data, len(buf), hw.ctypes.data)
    if rc:
        _raise(rc, what)
    return int(hw[0]), int(hw[1])


def plugin_of(data: bytes) -> str:
    """The name of the PIL plugin that takes an encoded image in memory, as
    ``Image.open`` tries them (``im.format``: the one the decoder reads it
    with, or the one it refuses it naming); "" where none does, where
    :func:`decode_u8` raises ``ValueError``."""
    buf = np.frombuffer(data, np.uint8) if len(data) else np.zeros(1, np.uint8)
    out = ctypes.create_string_buffer(16)
    _lib().native_identify(buf.ctypes.data, len(data), ctypes.addressof(out))
    return out.value.decode()


def png_layout(data: bytes) -> dict | None:
    """A PNG as PIL's PNG plugin opens it (``csrc/native_png.h``), for
    ``png.py``'s own inflate: its size, bit depth, colour type, whether it
    is interlaced or tiled (an APNG frame smaller than the image), and the
    (start, end) of each read ``ImageFile.load`` gives the decoder; None
    where the open fails (``decode_u8`` then raises what PIL's failure maps
    to)."""
    buf = np.frombuffer(data, np.uint8) if len(data) else np.zeros(1, np.uint8)
    cap = 64
    while True:
        out = np.zeros(7 + 2 * cap, np.int64)
        if _lib().native_png_layout(buf.ctypes.data, len(data), out.ctypes.data, cap):
            return None
        if out[6] <= cap:
            break
        cap = int(out[6])
    w, h, depth, ctype, interlaced, tiled, n = (int(v) for v in out[:7])
    return {"size": (h, w), "depth": depth, "ctype": ctype, "interlaced": bool(interlaced),
            "tiled": bool(tiled), "reads": out[7:7 + 2 * n].reshape(n, 2).tolist()}


def png_tail(data: bytes, read: int, what: str = "PNG") -> None:
    """PIL's ``load_end`` after a PNG's image was done in read ``read`` of
    :func:`png_layout`: the chunks after the data through their handlers;
    raises what their failure maps to."""
    buf = np.frombuffer(data, np.uint8)
    rc = _lib().native_png_tail(buf.ctypes.data, len(data), read)
    if rc:
        _raise(rc, what)


def decode_u8(data: bytes, what: str = "image") -> np.ndarray:
    """An encoded image in memory (any format :func:`decode_gray` reads) →
    (H, W) uint8 gray."""
    H, W = image_size(data, what)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((H, W), np.uint8)
    rc = _lib().native_decode_u8(buf.ctypes.data, len(buf), out.ctypes.data, H, W)
    if rc:
        _raise(rc, what)
    return out


def decode_gray(path: str, H: int, W: int) -> np.ndarray:
    """Decode an image file to (H, W) float32 in [0, 1]; IOError when it
    cannot be read or has another size."""
    out = np.empty((H, W), np.float32)
    rc = _lib().native_decode_file(str(path).encode(), out.ctypes.data, H, W)
    if rc:
        _raise(rc, str(path))
    return out


def remap_bilinear(src: np.ndarray, map_xy: np.ndarray) -> np.ndarray:
    """(H, W) float32 image, (H, W, 2) source (x, y) per output pixel →
    the bilinear remap with ``camera.remap_bilinear``'s border clamp."""
    src = np.ascontiguousarray(src, np.float32)
    H, W = src.shape
    map_xy = np.ascontiguousarray(map_xy, np.float32)
    if map_xy.shape != (H, W, 2):
        raise ValueError(f"map of shape {map_xy.shape} for an image of {(H, W)}")
    dst = np.empty_like(src)
    rc = _lib().native_remap_bilinear(src.ctypes.data, H, W, map_xy.ctypes.data,
                                      dst.ctypes.data)
    if rc:
        raise ValueError(f"remap of a {H}×{W} image: the clamp needs 2×2 pixels")
    return dst


def merge_lines(segs: np.ndarray, angle_thr: float, distance_thr: float,
                ep_thr: float) -> np.ndarray:
    """MergeLines in C++: (N, 4) segments → the merged (M, 4) float64."""
    S = np.ascontiguousarray(segs, np.float64).reshape(-1, 4)
    out = np.empty_like(S)
    m = _lib().native_merge_lines(S.ctypes.data, len(S), angle_thr, distance_thr, ep_thr,
                                  out.ctypes.data)
    return out[:m]


class NativeStereoLoader:
    """Ordered stereo prefetcher over explicit file lists: ``threads`` C++
    workers decode (and, given ``map_l`` and ``map_r``, rectify) pairs into
    a reorder buffer of ``depth`` frames; iteration yields ``(index, left,
    right)`` in order, (H, W) float32 in [0, 1]. A frame that fails to
    decode or has another size raises IOError at its turn, one of a kind
    the decoder refuses NotImplementedError, one of no known signature
    ValueError, as :func:`decode_u8` does. :meth:`close`
    (or dropping the loader, or interpreter exit) stops and joins the
    workers."""

    def __init__(self, left_paths, right_paths, H, W, map_l=None, map_r=None,
                 depth=3, threads=2):
        if len(left_paths) != len(right_paths):
            raise ValueError("left and right path lists differ in length")
        if (map_l is None) != (map_r is None):
            raise ValueError("rectification needs both maps")
        lib = _lib()
        self.H, self.W = int(H), int(W)
        self.n = len(left_paths)
        self._lp = (ctypes.c_char_p * self.n)(*[str(p).encode() for p in left_paths])
        self._rp = (ctypes.c_char_p * self.n)(*[str(p).encode() for p in right_paths])
        maps = []
        for m in (map_l, map_r):
            if m is not None:
                m = np.ascontiguousarray(m, np.float32)
                if m.shape != (self.H, self.W, 2):
                    raise ValueError(f"rectify map of shape {m.shape} for {(self.H, self.W)}")
            maps.append(m)  # the C++ side copies them
        handle = ctypes.c_void_p()
        rc = lib.native_loader_create(
            ctypes.addressof(self._lp), ctypes.addressof(self._rp), self.n, self.H, self.W,
            None if maps[0] is None else maps[0].ctypes.data,
            None if maps[1] is None else maps[1].ctypes.data,
            int(depth), int(threads), ctypes.addressof(handle))
        if rc:
            raise ValueError(f"native loader: {lib.native_runtime_error_string(rc).decode()}")
        self._h = handle.value
        self._next = 0
        self._close = weakref.finalize(self, lib.native_loader_destroy, self._h)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._close.alive:
            raise StopIteration
        left = np.empty((self.H, self.W), np.float32)
        right = np.empty((self.H, self.W), np.float32)
        rc = _lib().native_loader_next(self._h, left.ctypes.data, right.ctypes.data)
        if rc == -1:
            raise StopIteration
        i, self._next = self._next, self._next + 1
        if rc <= -100:
            _raise(-100 - rc, f"native loader: frame {i} ({self._lp[i].decode()}, "
                              f"{self._rp[i].decode()}), {self.H}×{self.W}")
        return rc, left, right

    def close(self) -> None:
        self._close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
