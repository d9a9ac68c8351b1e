"""The TIFF codecs PIL reads through libtiff (PIL 12.1, libtiff 4.7.1) and
the port reads with its own C++ (``rspl_slam_tpu_torch/csrc/
native_tiff_jpeg.h``, ``native_tiff_ycbcr.h``, ``native_fax3.h``): random,
seeded files of each, held to PIL's ``Image.open(p).convert("L")`` bit for
bit through ``native.decode_u8`` and ``png.read_gray``:

- new-style JPEG (compression 7): gray, RGB and YCbCr; 1×1, 2×1 and 2×2
  sampling; strips and tiles; whole streams, shared quantization tables or
  shared quantization and Huffman tables (JPEGTables); restart intervals;
  separate planes; a last strip's stream a whole strip tall; the
  subsampling fix-up where the tag is absent;
- YCbCr under LZW, Deflate and PackBits, which PIL reads through
  libtiff's TIFFRGBAImage: every subsampling libtiff puts (4×4, 4×2, 4×1,
  2×2, 2×1, 1×2, 1×1), positionings, ReferenceBlackWhite and
  YCbCrCoefficients, predictor 2 (done and left undone), odd sizes;
- old-style JPEG (compression 6): the JPEGQTables / JPEGDCTables /
  JPEGACTables layout and the JPEGInterchangeFormat one (its header, or the
  whole stream), strips with restart intervals;
- CCITT Modified Huffman (2), RLEW (32771), Group 3 1D and 2D with and
  without fill bits (3), Group 4 (4): PIL's writer and this suite's
  encoder, fill order 2, both photometrics, odd widths, strips at odd file
  offsets, tiles, and bit flips, cuts and stray bytes in the strips after
  the first (libtiff's recovery: a bad code word ends its row, Group 3
  decodes a strip again without EOLs, Group 4 stops at an early EOFB and
  leaves the strip buffer's rows as they were).

Where PIL raises, the port raises; the layouts PIL reads that the port
refuses raise ``NotImplementedError`` naming them. Rows libtiff leaves
unwritten in an image's first strip or tile are Pillow's uninitialized
memory (two reads of one file differ), so the corruptions here start at
the second segment.
"""

import io

import numpy as np
import pytest
import torch_make_image_kinds as mk
from PIL import Image

from rspl_slam_tpu_torch import native, png


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("L"))


def _agrees(data: bytes, tmp_path, refusal=None):
    """The port's two routes equal PIL where PIL reads; raise where PIL
    raises; ``refusal``: PIL reads, the port refuses naming it."""
    path = tmp_path / "image.tif"
    path.write_bytes(data)
    try:
        ref = _pil(data)
    except Exception:
        ref = None
    routes = (lambda: native.decode_u8(data), lambda: png.read_gray(str(path)))
    for route in routes:
        if refusal is not None:
            assert ref is not None
            with pytest.raises(NotImplementedError, match=refusal):
                route()
        elif ref is None:
            with pytest.raises((ValueError, OSError, NotImplementedError)):
                route()
        else:
            np.testing.assert_array_equal(route(), ref)
    return ref


def _size(rng, lo=5, hi=48):
    return int(rng.integers(lo, hi)), int(rng.integers(lo, hi))


def _rgb(rng, H, W):
    if rng.random() < 0.5:
        return mk.scene(H, W, int(rng.integers(0, 1000)), 3)
    return rng.integers(0, 256, (H, W, 3)).astype(np.uint8)


def _orientation(rng):
    return int(rng.integers(1, 9)) if rng.random() < 0.4 else None


# ------------------------------------------------------- new-style JPEG
@pytest.mark.parametrize("tables", ["none", "dqt", "all"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("photo,sampling", [(1, (1, 1)), (2, (1, 1)), (6, (1, 1)), (6, (2, 1)),
                                            (6, (2, 2))])
def test_random_new_style_jpeg_matches_pil(photo, sampling, layout, tables, tmp_path):
    """Two random new-style JPEG TIFFs of this photometric, sampling,
    layout and JPEGTables use (quality, restart interval, byte order,
    orientation and size random): PIL's bytes."""
    rng = np.random.default_rng([photo, *sampling, layout == "tiles", len(tables)])
    for _ in range(2):
        H, W = _size(rng)
        rgb = _rgb(rng, H, W)
        img = {1: rgb[..., 0], 2: rgb, 6: mk.rgb_to_ycbcr(rgb)}[photo]
        lay = ({"tile": (16 * int(rng.integers(1, 3)), 16)} if layout == "tiles"
               else {"rows_per_strip": 8 * sampling[1] * int(rng.integers(1, 4))})
        data = mk.encode_tiff_jpeg(img, photo, sampling, tables,
                                   quality=int(rng.integers(30, 96)),
                                   restart=int(rng.choice([0, 1, 3])),
                                   order=str(rng.choice(["<", ">"])),
                                   orientation=_orientation(rng), **lay)
        assert _agrees(data, tmp_path) is not None


@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("photo", [2, 6])
def test_new_style_jpeg_on_separate_planes_matches_pil(photo, layout, tmp_path):
    """One single-component stream a plane: RGB as stored, YCbCr through
    libtiff's RGBA interface (1×1; other subsamplings raise in both)."""
    rng = np.random.default_rng([photo, layout == "tiles"])
    H, W = _size(rng, 9)
    rgb = _rgb(rng, H, W)
    lay = {"tile": (16, 16)} if layout == "tiles" else {"rows_per_strip": 16}
    img = rgb if photo == 2 else mk.rgb_to_ycbcr(rgb)
    tags = [(530, 3, [1, 1])] if photo == 6 else []
    assert _agrees(mk.encode_tiff_jpeg(img, photo, tables="dqt", planar=2, tags=tags, **lay),
                   tmp_path) is not None
    if photo == 6:
        bad = mk.encode_tiff_jpeg(img, 6, tables="dqt", planar=2, tags=[(530, 3, [2, 2])], **lay)
        assert _agrees(bad, tmp_path) is None


def _ycc_stream(blk, sampling=(2, 2), rows=None):
    rows = blk.shape[0] if rows is None else rows
    full = np.pad(blk, ((0, max(0, rows - blk.shape[0])), (0, 0), (0, 0)), mode="edge")[:rows]
    return mk.encode_jpeg([full[..., i] for i in range(3)],
                          sampling=[sampling, (1, 1), (1, 1)], markers=b"")


def test_new_style_jpeg_stream_sizes_and_tags_as_libtiff_checks_them(tmp_path):
    """JPEGPreDecode's checks, as PIL meets them: a last strip's stream a
    whole strip tall reads its top rows; a stream taller than its strip
    elsewhere, a component count, sampling or precision other than the
    TIFF's, and a JPEGTables stream that is not tables only raise; a
    stream shorter than its strip (libtiff leaves Pillow's buffer rows as
    they were) is refused naming it; without a YCbCrSubsampling tag,
    libtiff takes the first stream's factors."""
    rng = np.random.default_rng(3)
    ycc = mk.rgb_to_ycbcr(_rgb(rng, 40, 24))
    kw = {"photometric": 6, "compression": 7, "rows_per_strip": 16, "tags": [(530, 3, [2, 2])]}
    assert _agrees(mk.encode_tiff(ycc, codec=lambda b: _ycc_stream(b, rows=16), **kw),
                   tmp_path) is not None
    assert _agrees(mk.encode_tiff(ycc, codec=lambda b: _ycc_stream(b, rows=b.shape[0] + 8), **kw),
                   tmp_path) is None
    _agrees(mk.encode_tiff(ycc, codec=lambda b: _ycc_stream(b, rows=b.shape[0] - 2), **kw),
            tmp_path, refusal="smaller")
    assert _agrees(mk.encode_tiff(ycc, codec=lambda b: _ycc_stream(b, (2, 1)), **kw),
                   tmp_path) is None
    assert _agrees(mk.encode_tiff(ycc[..., :1], compression=7, rows_per_strip=16,
                                  codec=lambda b: _ycc_stream(np.dstack([b] * 3))),
                   tmp_path) is None
    for samp in ((1, 1), (2, 1), (2, 2)):
        assert _agrees(mk.encode_tiff(ycc, photometric=6, compression=7, rows_per_strip=16,
                                      codec=lambda b, s=samp: _ycc_stream(b, s)),
                       tmp_path) is not None
    stream = _ycc_stream(ycc)
    assert _agrees(mk.encode_tiff(ycc, codec=lambda b: _ycc_stream(b), **{
        **kw, "tags": [(530, 3, [2, 2]), (347, 7, list(stream))]}), tmp_path) is None
    g12 = rng.integers(0, 4096, (20, 16))
    _agrees(mk.encode_tiff(g12, bits=12, compression=7,
                           codec=lambda b: mk.encode_jpeg([b[..., 0]], precision=12,
                                                          markers=b"")),
            tmp_path, refusal="12-bit")


# ------------------------------------------------- YCbCr, TIFFRGBAImage
@pytest.mark.parametrize("compression", [5, 8, 32773])
@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)])
def test_random_compressed_ycbcr_matches_pil(sampling, compression, tmp_path):
    """Two random YCbCr TIFFs of this subsampling and compression (strips
    or tiles, odd sizes, YCbCrPositioning, ReferenceBlackWhite,
    YCbCrCoefficients, predictor 2, byte order and orientation random):
    PIL's bytes. A 4×4 strip of an odd number of blocks a row is left out:
    libtiff reads its last chroma from memory it never wrote."""
    hs, vs = sampling
    rng = np.random.default_rng([hs, vs, compression])
    for _ in range(2):
        H, W = _size(rng)
        tiled = rng.random() < 0.4
        if sampling == (4, 4) and not tiled and -(-W // 4) % 2:
            W += 4
        ycc = mk.rgb_to_ycbcr(_rgb(rng, H, W))
        lay = ({"tile": (16 * int(rng.integers(1, 3)), 16)} if tiled
               else {"rows_per_strip": vs * int(rng.integers(1, 6))})
        tags = []
        if rng.random() < 0.5:
            tags.append((531, 3, [int(rng.integers(1, 3))]))
        if rng.random() < 0.5:
            tags.append((532, 5, [int(rng.integers(0, 30)), 1, int(rng.integers(200, 256)), 1,
                                  int(rng.integers(110, 140)), 1, int(rng.integers(220, 300)),
                                  int(rng.integers(1, 4)), int(rng.integers(110, 140)), 1,
                                  int(rng.integers(220, 300)), 1]))
        if rng.random() < 0.4:
            tags.append((529, 5, [int(rng.integers(200, 350)), 1000,
                                  int(rng.integers(550, 720)), 1000,
                                  int(rng.integers(60, 150)), 1000]))
        data = mk.encode_tiff_ycbcr(ycc, hs, vs, compression,
                                    2 if compression != 32773 and rng.random() < 0.4 else 1,
                                    order=str(rng.choice(["<", ">"])),
                                    orientation=_orientation(rng), tags=tags, **lay)
        assert _agrees(data, tmp_path) is not None


def test_ycbcr_layouts_libtiff_refuses_raise(tmp_path):
    """Subsamplings libtiff has no put function for (1×4, 2×4), a YCbCr
    image of one sample, and 2×2 on separate planes raise in PIL and in the
    port; 1×1 on separate planes reads."""
    rng = np.random.default_rng(4)
    ycc = mk.rgb_to_ycbcr(_rgb(rng, 20, 20))
    for hs, vs in ((1, 4), (2, 4)):
        assert _agrees(mk.encode_tiff_ycbcr(ycc, hs, vs, 5, rows_per_strip=8), tmp_path) is None
    assert _agrees(mk.encode_tiff(ycc[..., 0], photometric=6, compression=5), tmp_path) is None
    for sub, reads in (([1, 1], True), ([2, 2], False)):
        data = mk.encode_tiff(ycc, photometric=6, compression=8, planar=2,
                              tags=[(530, 3, sub)])
        assert (_agrees(data, tmp_path) is not None) == reads


# -------------------------------------------------------- old-style JPEG
@pytest.mark.parametrize("layout", ["tables", "jif", "jif_whole"])
@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2)])
def test_random_old_style_jpeg_matches_pil(sampling, layout, tmp_path):
    """Two random old-style JPEG TIFFs of this sampling and layout (one
    strip or strips of whole restart intervals, quality, orientation and
    size random): PIL's bytes; JPEGProc 14 reads as 1 (libtiff writes a
    baseline frame whatever it says)."""
    hs, vs = sampling
    rng = np.random.default_rng([hs, vs, len(layout)])
    for _ in range(2):
        H, W = _size(rng, 8)
        ycc = mk.rgb_to_ycbcr(_rgb(rng, H, W))
        rps = 8 * vs * int(rng.integers(1, 4)) if rng.random() < 0.7 else None
        tags = [(512, 3, [14])] if layout == "tables" and rng.random() < 0.5 else []
        data = mk.encode_tiff_ojpeg(ycc, hs, vs, rows_per_strip=rps, layout=layout,
                                    quality=int(rng.integers(30, 96)),
                                    orientation=_orientation(rng), tags=tags)
        assert _agrees(data, tmp_path) is not None


def test_old_style_jpeg_layouts_the_port_refuses(tmp_path):
    """PIL reads these and the port refuses each, naming it: strips of a
    big-endian file (libtiff's OJPEG reads strip k from strip 2k's data)
    and strips whose restart interval is not one strip's MCUs; a strip
    height that is no multiple of the MCU's raises in both."""
    ycc = mk.rgb_to_ycbcr(mk.scene(48, 32, 9, 3))
    _agrees(mk.encode_tiff_ojpeg(ycc, 2, 2, rows_per_strip=16, order=">"), tmp_path,
            refusal="big-endian")
    _agrees(mk.encode_tiff_ojpeg(ycc, 2, 2, rows_per_strip=16, tags=[(515, 3, [1])]), tmp_path,
            refusal="restart interval")
    assert _agrees(mk.encode_tiff_ojpeg(ycc, 2, 2, order=">"), tmp_path) is not None
    data = mk.encode_tiff_ojpeg(ycc, 2, 2, rows_per_strip=16)
    bad = data.replace(b"\x16\x01\x04\x00\x01\x00\x00\x00\x10\x00\x00\x00",
                       b"\x16\x01\x04\x00\x01\x00\x00\x00\x08\x00\x00\x00")
    assert bad != data and _agrees(bad, tmp_path) is None


# ----------------------------------------------------------------- CCITT
def _corrupt(rng):
    """Bit flips, cuts and stray bytes in some strips after the first."""
    seen = []

    def corrupt(data):
        seen.append(1)
        if len(seen) == 1 or rng.random() < 0.5 or not data:
            return data
        d = bytearray(data)
        k = rng.integers(0, 3)
        if k == 0:
            d[rng.integers(0, len(d))] ^= 1 << int(rng.integers(0, 8))
        elif k == 1 and len(d) > 1:
            d = d[:rng.integers(1, len(d))]
        else:
            d[rng.integers(0, len(d))] = int(rng.integers(0, 256))
        return bytes(d)
    return corrupt


@pytest.mark.parametrize("fill_order", [1, 2])
@pytest.mark.parametrize("compression,options", [(2, 0), (32771, 0), (3, 0), (3, 1), (3, 4),
                                                 (3, 5), (4, 0)])
def test_random_ccitt_matches_pil(compression, options, fill_order, tmp_path):
    """Four random bilevel TIFFs of this CCITT coding and fill order (size,
    odd widths, photometric, strips or tiles, the strips' file offset
    parity and, in two of them, corruptions after the first strip random):
    PIL's bytes, libtiff's recoveries included."""
    rng = np.random.default_rng([compression, options, fill_order])
    for i in range(4):
        H, W = _size(rng, 3, 60)
        bits = (rng.random((H, W)) < rng.uniform(0.05, 0.95)).astype(np.int64)
        if rng.random() < 0.5:
            bits = np.repeat(bits[:, :max(1, W // 5)], 5, 1)[:, :W]
        tiled = compression != 32771 and rng.random() < 0.3
        lay = {"tile": (16, 16)} if tiled else {"rows_per_strip": int(rng.integers(1, H + 1))}
        data = mk.encode_tiff_fax(bits, compression, int(rng.integers(0, 2)), options,
                                  rtc=bool(rng.random() < 0.5), fill_order=fill_order,
                                  corrupt=_corrupt(rng) if i >= 2 else None,
                                  prefix=b"\0" * int(rng.integers(0, 2)), **lay)
        _agrees(data, tmp_path)


@pytest.mark.parametrize("compression", ["tiff_ccitt", "tiff_raw_16", "group3", "group4"])
def test_pils_own_ccitt_files_read_as_pil_reads_them(compression, tmp_path):
    """PIL's writer (libtiff's encoder) at odd widths, dithered: the port
    reads what PIL reads back, including RLEW rows that libtiff's word
    alignment misreads."""
    for W in (45, 64, 97):
        im = Image.fromarray(mk.scene(24, W, W)).convert("1")
        buf = io.BytesIO()
        im.save(buf, "TIFF", compression=compression)
        assert _agrees(buf.getvalue(), tmp_path) is not None


def test_ccitt_of_other_sample_depths_raises(tmp_path):
    """CCITT with 8-bit samples raises in libtiff ("Bits/sample must be
    1") and in the port."""
    g = mk.scene(16, 16, 2)
    assert _agrees(mk.encode_tiff(g, compression=4, codec=lambda b: mk.fax_encode(
        (b[..., 0] > 128).astype(np.int64), 4)), tmp_path) is None


def test_pil_dither_is_pils_convert_1():
    """``torch_make_image_kinds.pil_dither`` (the card's Group 4 tree has no
    PIL to dither with) equals PIL's ``convert("1")`` on scenes and noise."""
    rng = np.random.default_rng(8)
    for img in (mk.scene(40, 57, 1), mk.scene(33, 90, 2),
                rng.integers(0, 256, (30, 41)).astype(np.uint8)):
        np.testing.assert_array_equal(mk.pil_dither(img),
                                      np.asarray(Image.fromarray(img).convert("1")))
