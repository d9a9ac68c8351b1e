"""Every JPEG, netpbm, PFM, TIFF, BMP, GIF, WebP, QOI, Sun raster, PCX,
SGI, TGA, ICO, CUR, DIB and DDS kind that the JAX package's reader takes
(PIL's ``Image.open(p).convert("L")``,
``rspl_slam_tpu.datasets._load_gray``) through every CPU route of the
port's reader: ``png.read_gray``, ``native.decode_u8`` / ``decode_gray``
and the ``NativeStereoLoader`` threads, bit for bit; the kinds PIL
refuses raising ``NotImplementedError`` on every route, naming the kind;
and the kinds and formats PIL reads that the port does not yet raising
``NotImplementedError`` naming them.

The fixtures are ``tests/fixtures/image_kinds/`` (written by
``tests/torch_make_image_kinds.py``, whose encoders these tests also use
for random files): progressive (PIL's and partially refined ones, which
libjpeg-turbo smooths), arithmetic-coded, lossless, CMYK, YCCK, RGB,
4:1:1, netpbm P1-P6 at several maxvals, the refused 12-bit,
hierarchical, DNL and fractional-sampling files; TIFF (PIL's writer and
the encoder: tiles, planes, predictors, big-endian, BigTIFF, fill order
2, every sample kind, orientations 2-8 by tag and by XMP; new- and
old-style JPEG, compressed YCbCr, CCITT with libtiff's recoveries, and
the JPEG layouts the port refuses), BMP (RLE, BITFIELDS, OS/2, top-down), PFM;
GIF (identity palettes, frame 0 past or inside the screen, interlaced,
animated) and WebP (lossless, lossy, alpha, animated, libwebp's own
options) with the kinds of both that PIL refuses; QOI, Sun raster, PCX,
SGI, TGA, ICO, CUR, headerless DIB and DDS (BC1, BC6H, BC7) files; PSD
(raw gray, PackBits RGB), DCX, BLP (JPEG, DXT5), FTEX, ICNS (RLE and PNG
best sizes) and Pillow's P0CMYK and PyCMYK files; JPEG 2000, AVIF and an
ICNS of a JPEG 2000 best size, which the port refuses; a 752×480 progressive
stereo sequence and a lossy WebP pair of its first frames. Random GIFs
and WebPs are in ``test_torch_gif_webp.py``, random TIFFs of libtiff's
codecs in ``test_torch_tiff_codecs.py``, random files of the formats read
since QOI in ``test_torch_pillow_formats.py``, random PSD, DCX, BLP,
FTEX, ICNS and damaged PNG files in ``test_torch_pillow_containers.py``.
``manifest.json`` pins each
readable file's PIL sha256 and each refused file's refusal word.
"""

import contextlib
import hashlib
import io
import json
import os
import shutil
import struct

import numpy as np
import pytest
import torch_make_image_kinds as mk
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, TiffImagePlugin
from test_torch_common import rendered_sequence, small_system_cfg

from rspl_slam_tpu import datasets as jdatasets
from rspl_slam_tpu_torch import cli as tcli
from rspl_slam_tpu_torch import datasets as tdatasets
from rspl_slam_tpu_torch import native, png
from rspl_slam_tpu_torch.models import superpoint
from rspl_slam_tpu_torch.models.weights import save_npz_pytree
from rspl_slam_tpu_torch.slam import INIT_POSE

DIR = os.path.join(os.path.dirname(__file__), "fixtures", "image_kinds")
with open(os.path.join(DIR, "manifest.json")) as _f:
    MANIFEST = json.load(_f)["files"]
SEQ = sorted(n for n in MANIFEST if n.startswith(mk.SEQ_DIR + "/"))
READ = sorted(n for n, e in MANIFEST.items() if "sha256" in e and n not in SEQ)
REFUSED = sorted(n for n, e in MANIFEST.items() if e.get("refused") and not e.get("pil_reads"))
UNPORTED = sorted(n for n, e in MANIFEST.items() if e.get("pil_reads"))


def _sha(u8: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(u8).tobytes()).hexdigest()


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("L"))


def _routes(path: str) -> dict:
    """The port's four CPU routes of one file, as (H, W) uint8 (the float
    routes scaled back exactly: they are u8 / 255)."""
    with open(path, "rb") as f:
        data = f.read()
    u8 = png.read_gray(path)
    H, W = u8.shape
    out = {"read_gray": u8, "decode_u8": native.decode_u8(data, path)}
    f32 = native.decode_gray(path, H, W)
    with native.NativeStereoLoader([path], [path], H, W) as loader:
        (_, left, right), = list(loader)
    for k, v in (("decode_gray", f32), ("loader_left", left), ("loader_right", right)):
        u = np.round(v * 255).astype(np.uint8)
        np.testing.assert_array_equal(u.astype(np.float32) / 255.0, v, err_msg=k)
        out[k] = u
    return out


@pytest.mark.parametrize("name", READ)
def test_fixture_reads_as_pil_on_every_route(name):
    """Each readable fixture: the manifest's hash is PIL's own (live), and
    every route of the port gives JAX's ``_load_gray`` pixels exactly."""
    path = os.path.join(DIR, name)
    ref = jdatasets._load_gray(path)
    with open(path, "rb") as f:
        assert _sha(_pil(f.read())) == MANIFEST[name]["sha256"]
    for route, u8 in _routes(path).items():
        np.testing.assert_array_equal(u8.astype(np.float32) / 255.0, ref, err_msg=route)
        assert _sha(u8) == MANIFEST[name]["sha256"], route


def test_sequence_reads_as_pil_on_every_route():
    """The 752×480 progressive stereo sequence: each frame's hash is PIL's,
    on every route, and the loader's pairs equal JAX's dataset's frames."""
    root = os.path.join(DIR, mk.SEQ_DIR)
    for name in SEQ:
        path = os.path.join(DIR, name)
        with open(path, "rb") as f:
            data = f.read()
        assert _sha(_pil(data)) == MANIFEST[name]["sha256"]
        assert _sha(png.read_gray(path)) == MANIFEST[name]["sha256"]
        assert _sha(native.decode_u8(data)) == MANIFEST[name]["sha256"]
    jds = jdatasets.EurocDataset(root)
    tds = tdatasets.EurocDataset(root)
    assert len(jds) == len(tds) == mk.SEQ_FRAMES
    with native.NativeStereoLoader(*tds.file_lists(), 480, 752, threads=3) as loader:
        for i, left, right in loader:
            np.testing.assert_array_equal(left, jds[i].image_left)
            np.testing.assert_array_equal(right, jds[i].image_right)


@pytest.mark.parametrize("name", REFUSED)
def test_refused_kind_raises_in_pil_and_the_port(name):
    """A kind PIL refuses raises there (JAX's reader included) and raises
    ``NotImplementedError`` naming the kind on every route of the port."""
    path = os.path.join(DIR, name)
    with open(path, "rb") as f:
        data = f.read()
    with pytest.raises(Exception):
        jdatasets._load_gray(path)
    _raises_on_every_route(path, data, MANIFEST[name]["refusal"])


def _raises_on_every_route(path, data, word):
    H, W = mk.H_SMALL, mk.W_SMALL  # the size a caller expects (a DNL file's header says 0)
    for call in (lambda: png.read_gray(path), lambda: native.decode_u8(data, path),
                 lambda: native.decode_gray(path, H, W)):
        with pytest.raises(NotImplementedError, match=word):
            call()
    with native.NativeStereoLoader([path], [path], H, W) as loader:
        with pytest.raises(NotImplementedError, match=word):
            next(loader)


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_kind_raises_in_the_port_alone(name):
    """A kind or format PIL reads that the port does not read yet (TIFF's
    12-bit and short-stream new-style JPEG,
    old-style JPEG of big-endian strips or odd restart intervals; AVIF):
    PIL (JAX's reader) reads it, and every route of the port raises
    ``NotImplementedError`` naming the kind or format."""
    path = os.path.join(DIR, name)
    with open(path, "rb") as f:
        data = f.read()
    assert jdatasets._load_gray(path).ndim == 2
    _raises_on_every_route(path, data, MANIFEST[name]["refusal"])


def test_refusals_name_the_format_they_refuse(tmp_path):
    """No JPEG refusal speaks of netpbm: a P0CMYK file (refused naming
    netpbm until the port read Pillow's own kinds) now reads as PIL reads
    it, and a PFM file, which the port now reads, equals PIL; a 16-bit P5
    at maxval 1023 reads (it raised as a refused JPEG kind before); a
    lossless JPEG that declares YCbCr (JFIF) raises in PIL and names
    lossless in the port; the GIF and WebP kinds PIL refuses (an LZW code
    size of 13, a hidden VP8 frame, VP8L version 2, ALPH reserved bits)
    raise in PIL and name their format and kind in the port."""
    cmyk = tmp_path / "f.pnm"
    cmyk.write_bytes(b"P0CMYK\n3 2\n255\n" + bytes(range(24)))
    ref = np.asarray(Image.open(cmyk).convert("L"))
    assert ref.shape == (2, 3)
    np.testing.assert_array_equal(png.read_gray(str(cmyk)), ref)
    np.testing.assert_array_equal(native.decode_gray(str(cmyk), 2, 3), ref / np.float32(255))
    pfm = tmp_path / "f.pfm"
    pfm.write_bytes(b"Pf\n3 2\n-1.0\n" + np.arange(6, dtype="<f4").tobytes() * 40)
    np.testing.assert_array_equal(png.read_gray(str(pfm)), np.asarray(Image.open(pfm).convert("L")))
    p5 = tmp_path / "p5.pgm"
    p5.write_bytes(mk.encode_pnm("P5", np.arange(6).reshape(2, 3) * 200, 1023))
    np.testing.assert_array_equal(png.read_gray(str(p5)), np.asarray(Image.open(p5).convert("L")))
    lj = mk.encode_jpeg([mk.scene(16, 16, s) for s in range(3)], mode="lossless",
                        markers=mk.JFIF)
    with pytest.raises(OSError):
        _pil(lj)
    with pytest.raises(NotImplementedError, match="lossless") as e:
        native.decode_u8(lj)
    assert "netpbm" not in str(e.value)
    # the GIF and WebP kinds PIL refuses: each code's message names its format
    # and its kind, and no other format
    idx = np.arange(48).reshape(6, 8) % 16
    lossy = bytearray(mk._pil_save(Image.fromarray(mk.scene(16, 16, 1, 3)), "WEBP", quality=50))
    lossy[20] &= ~16  # the frame tag's show bit cleared: a hidden frame
    vp8l = bytearray(mk._pil_save(Image.fromarray(mk.scene(16, 16, 2, 3)), "WEBP", lossless=True))
    vp8l[24] |= 0x40  # VP8L version 2
    alph = bytearray(mk._pil_save(Image.fromarray(mk.scene(16, 16, 3, 4), "RGBA"), "WEBP", quality=50))
    alph[alph.index(b"ALPH") + 8] |= 0xC0  # the ALPH header's reserved bits
    for data, fmt, kind in ((mk.encode_gif(idx, code_size=13), "GIF", "LZW minimum code size"),
                            (bytes(lossy), "WebP", "VP8 frame"), (bytes(vp8l), "WebP", "VP8L header"),
                            (bytes(alph), "WebP", "ALPH chunk")):
        with pytest.raises(OSError):
            _pil(data)
        with pytest.raises(NotImplementedError, match=kind) as e:
            native.decode_u8(data)
        others = {"GIF", "WebP", "JPEG", "netpbm", "TIFF", "BMP"} - {fmt}
        assert fmt in str(e.value) and not any(o in str(e.value) for o in others)


def test_cmyk_to_gray_is_pils_on_every_byte_value():
    """PIL's CMYK → L (its cmyk2rgb with MULDIV255, then luma) on every
    (C, K) pair of byte values (M and Y other mixes), through a lossless
    CMYK JPEG (libjpeg passes CMYK through; PIL reads it inverted,
    "CMYK;I")."""
    c, k = np.meshgrid(np.arange(256), np.arange(256))
    planes = [c, (c * 7 + k * 3) % 256, (c + k * 11) % 256, k]
    data = mk.encode_jpeg(planes, mode="lossless", markers=b"")
    np.testing.assert_array_equal(native.decode_u8(data), _pil(data))


SAMPLINGS = {1: [[(1, 1)], [(2, 2)], [(1, 3)]],
             3: [[(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
                 [(4, 1), (1, 1), (1, 1)], [(1, 2), (1, 1), (1, 1)], [(2, 2), (2, 1), (1, 2)]],
             4: [[(1, 1)] * 4, [(2, 2), (1, 1), (1, 1), (2, 2)]]}


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_random_progressive_scripts_match_pil(seed):
    """Random progressive scan scripts (spectral bands in any order, any
    Al, refinements interleaved, stopped short or complete), Huffman or
    arithmetic, with or without restarts, any component count and
    sampling, random sizes: the port's decode equals PIL's."""
    rng = np.random.default_rng(seed)
    H, W = int(rng.integers(1, 48)), int(rng.integers(1, 48))
    nc = int(rng.choice([1, 3, 4]))
    samp = SAMPLINGS[nc][int(rng.integers(len(SAMPLINGS[nc])))]
    planes = [mk.scene(H, W, int(rng.integers(1000))) for _ in range(nc)]
    data = mk.encode_jpeg(planes, sampling=samp, mode="progressive", arith=bool(rng.random() < 0.4),
                          scans=mk.random_scan_script(rng, nc, complete=bool(rng.random() < 0.5)),
                          restart=int(rng.integers(0, 5)), quality=int(rng.integers(10, 101)),
                          markers=[b"", mk.JFIF, mk.adobe(0), mk.adobe(2)][int(rng.integers(4))])
    np.testing.assert_array_equal(native.decode_u8(data), _pil(data))


@settings(max_examples=15, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_random_lossless_scans_match_pil(seed):
    """Lossless JPEGs with random predictors and point transforms, one
    interleaved scan or a scan per component (each its own predictor),
    with or without restarts: the port's decode equals PIL's."""
    rng = np.random.default_rng(seed)
    H, W = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    nc = int(rng.choice([1, 3]))
    planes = [mk.scene(H, W, int(rng.integers(1000))) for _ in range(nc)]
    if nc == 3 and rng.random() < 0.5:
        scans = [([c], int(rng.integers(1, 8)), 0, 0, int(rng.integers(0, 3))) for c in range(3)]
    else:
        scans = [(list(range(nc)), int(rng.integers(1, 8)), 0, 0, int(rng.integers(0, 3)))]
    data = mk.encode_jpeg(planes, mode="lossless", scans=scans, markers=b"",
                          restart=W * int(rng.integers(0, 3)))
    np.testing.assert_array_equal(native.decode_u8(data), _pil(data))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(maxval=st.integers(1, 65535), kind=st.sampled_from(["P2", "P3", "P5", "P6"]),
       seed=st.integers(0, 2 ** 16))
def test_random_pnm_maxvals_match_pil(tmp_path_factory, maxval, kind, seed):
    """Random maxvals, sizes and samples of each grey and colour netpbm kind
    (plain ones with comments): ``read_gray`` on a file and ``decode_u8``
    in memory both equal PIL."""
    rng = np.random.default_rng(seed)
    H, W = int(rng.integers(1, 12)), int(rng.integers(1, 12))
    shape = (H, W, 3) if kind in ("P3", "P6") else (H, W)
    data = mk.encode_pnm(kind, rng.integers(0, maxval + 1, shape), maxval, comment=b"x",
                         line=int(rng.integers(1, 9)))
    path = str(tmp_path_factory.mktemp("pnm") / "f")
    with open(path, "wb") as f:
        f.write(data)
    ref = _pil(data)
    np.testing.assert_array_equal(png.read_gray(path), ref)
    np.testing.assert_array_equal(native.decode_u8(data), ref)


# ------------------------------------------------------------ TIFF, BMP, PFM
TIFF_KEYS = sorted(TiffImagePlugin.OPEN_INFO, key=repr)


def _tiff_samples(rng, bits, sf, S, H, W):
    if sf == 3:
        img = rng.normal(120, 150, (H, W, S)).astype(np.float32)
        img[rng.random((H, W, S)) < 0.05] = np.nan
        return img
    if sf == 2:
        return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (H, W, S))
    top = (1 << bits) if bits < 63 else 1 << 62
    return rng.integers(0, top if rng.random() < 0.5 else min(top, 600), (H, W, S))


def _agrees_with_pil(data, refusal=None):
    """The port's decode of ``data`` equals PIL's; where PIL raises, the
    port raises; ``refusal``: where PIL reads the file, the port refuses
    it, naming the kind."""
    try:
        ref = _pil(data)
    except Exception:
        ref = None
    if refusal is not None and ref is not None:
        with pytest.raises(NotImplementedError, match=refusal):
            native.decode_u8(data)
    elif ref is None:
        with pytest.raises((ValueError, OSError, NotImplementedError)):
            native.decode_u8(data)
    else:
        np.testing.assert_array_equal(native.decode_u8(data), ref)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("predictor", [1, 2, 3])
@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
def test_random_tiffs_match_pil(compression, predictor, planar, layout, order):
    """Random TIFFs of three kinds of PIL's OPEN_INFO (its bits, sample
    format, photometric, extra samples, fill order) in this byte order,
    compression, predictor, planar configuration and layout, at random
    sizes, strip heights, tile sizes, orientations (none or 1-8) and
    BigTIFF or not: the port equals
    PIL where PIL reads (compressed YCbCr through libtiff's RGBA interface
    too, its missing subsampling tag read as 2 × 2), raises where PIL
    raises, and refuses, naming it, what PIL reads past its own buffer (a
    compressed palette with an extra plane)."""
    rng = np.random.default_rng([compression, predictor, planar, layout == "tiles", order == ">"])
    keys = [k for k in TIFF_KEYS if k[0] == (b"II" if order == "<" else b"MM")]
    for i in rng.choice(len(keys), 3, replace=False):
        _, photo, sf, fill, bps, extra = keys[i]
        H, W = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        img = _tiff_samples(rng, bps[0], sf[0], len(bps), H, W)
        data = mk.encode_tiff(
            img, bits=bps[0], photometric=photo, sample_format=sf[0], extra=extra,
            compression=compression, predictor=predictor, planar=planar, order=order,
            tile=((int(rng.choice([16, 32])), int(rng.choice([16, 32])))
                  if layout == "tiles" else None),
            rows_per_strip=int(rng.integers(1, H + 3)), bigtiff=bool(rng.random() < 0.3),
            fill_order=fill,
            colormap=rng.integers(0, 65536, (1 << bps[0], 3)) if photo == 3 else None,
            orientation=int(rng.integers(0, 9)) or None)
        refusal = None
        if compression != 1 and photo == 3 and planar == 2 and extra == (0,):
            refusal = "separate planes"
        _agrees_with_pil(data, refusal)


XMP6 = list(b'<x:xmpmeta><rdf:Description tiff:Orientation="6"/></x:xmpmeta>')
# (tag, type, values) entries of the Orientation tag (274) and the XMP
# packet (700), as PIL 12.1 reads them (probed): a number transposes; a
# rational or float that is a whole number counts as it; a BYTE,
# UNDEFINED or ASCII value, a type PIL does not know (17) and a number
# outside 2-8 do not; with no tag an XMP packet stored as bytes gives its
# first tiff:Orientation digit, and one stored as a non-empty string or
# number makes PIL raise
ORIENTATION_TAGS = {
    **{f"short {v}": [(274, 3, [v])] for v in range(10)},
    "long 6": [(274, 4, [6])], "sshort 7": [(274, 8, [7])], "sshort -2": [(274, 8, [-2])],
    "slong 8": [(274, 9, [8])], "sbyte 5": [(274, 6, [5])], "ifd 2": [(274, 13, [2])],
    "long8 3": [(274, 16, [3])], "slong8 6": [(274, 17, [6])],
    "byte 6": [(274, 1, [6])], "undefined 6": [(274, 7, [6])], "ascii 6": [(274, 2, [54, 0])],
    "rational 12/2": [(274, 5, [12, 2])], "rational 13/2": [(274, 5, [13, 2])],
    "rational 6/0": [(274, 5, [6, 0])], "srational -12/-2": [(274, 10, [-12, -2])],
    "float 7.0": [(274, 11, [7.0])], "double 6.0": [(274, 12, [6.0])],
    "double 6.5": [(274, 12, [6.5])], "two values 6 3": [(274, 3, [6, 3])],
    "xmp bytes 6": [(700, 1, XMP6)], "xmp undefined 6": [(700, 7, XMP6)],
    "xmp element 3": [(700, 1, list(b"<tiff:Orientation>3</tiff:Orientation>"))],
    "xmp second match 4": [(700, 1, list(b'tiff:Orientation>x tiff:Orientation="4"'))],
    "xmp no digit": [(700, 1, list(b'tiff:Orientation="'))],
    "xmp text": [(700, 2, XMP6 + [0])], "xmp text empty": [(700, 2, [0])],
    "xmp number 5": [(700, 3, [5])], "xmp number 0": [(700, 3, [0])],
    "xmp 6 and tag 3": [(274, 3, [3]), (700, 1, XMP6)],
    "xmp 6 and ascii tag": [(274, 2, [54, 0]), (700, 1, XMP6)],
    "xmp 6 and slong8 tag": [(274, 17, [6]), (700, 1, XMP6)],
}


@pytest.mark.parametrize("layout", ["uncompressed strips", "LZW tiles"])
@pytest.mark.parametrize("case", sorted(ORIENTATION_TAGS))
def test_tiff_orientation_as_pil_reads_it(case, layout):
    """PIL flips or rotates a TIFF after decoding it (``load_end``'s
    ``ImageOps.exif_transpose``) by the Orientation tag, or with no tag by
    its XMP packet: the port, on a 5×7 image (so a swap of width and
    height shows), equals it on PIL's own route and on libtiff's, and
    raises where it raises."""
    img = np.random.default_rng(7).integers(0, 256, (5, 7))
    kw = {"compression": 5, "tile": (16, 16)} if layout == "LZW tiles" else {}
    _agrees_with_pil(mk.encode_tiff(img, tags=ORIENTATION_TAGS[case], **kw))


BMP_MASKS = {16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F), (0xF000, 0x7E0, 0x1F)],
             24: [(0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000)],
             32: [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
                  (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                  (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                  (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0), (0xFF, 0xFF00, 0xFF0000, 0)]}
BMP_CASES = [(bits, comp, header, top) for bits in (1, 2, 4, 8, 16, 24, 32)
             for comp in ("raw", "rle", "bitfields") for header in (12, 40, 56, 124)
             for top in (False, True) if header != 12 or (comp == "raw" and not top)]


@pytest.mark.parametrize("bits,compression,header,top_down", BMP_CASES)
def test_random_bmps_match_pil(bits, compression, header, top_down):
    """Random BMPs of each depth, compression, header size and row order
    (palettes grey or not, short or not, indices past them; RLE with
    deltas, absolute runs and early ends; every BITFIELDS mask PIL maps and
    some it does not): the port equals PIL, or raises where PIL raises."""
    rng = np.random.default_rng([bits, ["raw", "rle", "bitfields"].index(compression), header,
                                 top_down])
    for _ in range(2):
        H, W = int(rng.integers(1, 30)), int(rng.integers(1, 30))
        kw = dict(header=header, top_down=top_down)
        if bits <= 8:
            k = (1 << bits) if rng.random() < 0.6 else int(rng.integers(1, (1 << bits) + 1))
            px = rng.integers(0, 1 << bits, (H, W))
            grey = rng.random() < 0.3
            kw["palette"] = (np.stack([np.arange(k) * (255 if k == 2 else 1)] * 3, 1) if grey
                             else rng.integers(0, 256, (k, 3)))
            if header != 12 and rng.random() < 0.3:
                kw["colors"] = k
        elif bits == 16:
            px = rng.integers(0, 65536, (H, W))
        else:
            px = rng.integers(0, 256, (H, W, bits // 8))
        if compression == "rle":
            rle4 = bits == 4 if rng.random() < 0.8 else bits != 4
            kw["compression"] = 2 if rle4 else 1
            kw["rle"] = mk.rle_encode(
                (px if top_down else px[::-1]) if px.ndim == 2 else px[..., 0],
                rle4, stop_early=int(rng.integers(0, H)) if rng.random() < 0.15 else None,
                delta_at=(int(rng.integers(0, H)), int(rng.integers(0, 3)), int(rng.integers(0, 2)))
                if rng.random() < 0.3 else None)
        elif compression == "bitfields":
            kw["compression"] = 3
            masks = BMP_MASKS.get(bits, [(0xFF0000, 0xFF00, 0xFF)])
            kw["masks"] = masks[int(rng.integers(len(masks)))]
        _agrees_with_pil(mk.encode_bmp(px, bits, **kw))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scale", [-1.0, 1.0, -0.25, 3.5])
def test_random_pfms_match_pil(scale, seed):
    """Gray PFMs in both byte orders (the scale's sign), rows bottom to
    top, values past both ends of L and NaNs: the port equals PIL."""
    rng = np.random.default_rng(seed)
    img = rng.normal(100, 150, (int(rng.integers(1, 30)), int(rng.integers(1, 30))))
    img[rng.random(img.shape) < 0.05] = np.nan
    _agrees_with_pil(mk.encode_pfm(img, scale))


def test_pil_boundaries_of_i16_and_f_to_l(tmp_path):
    """PIL's conversions to L as probed on PIL 12.1: 16-bit gray clips at
    255 (0, 100, 255, 256, 1000, 65535 → 0, 100, 255, 255, 255, 255) in
    either byte order, raw or LZW; float truncates toward zero and clamps
    (-1, 0.6, 1.5, 254.5, 255.5, 300 → 0, 0, 1, 254, 255, 255), through
    TIFF and PFM; the port gives the same values, and so does PIL."""
    i16 = np.array([[0, 100, 255, 256, 1000, 65535]])
    f = np.array([[-1, 0.6, 1.5, 254.5, 255.5, 300]], np.float32)
    files = [(mk.encode_tiff(i16, bits=16, order=o, compression=c), [0, 100, 255, 255, 255, 255])
             for o in "<>" for c in (1, 5)]
    files += [(mk.encode_tiff(f, bits=32, sample_format=3, order=o), [0, 0, 1, 254, 255, 255])
              for o in "<>"]
    files += [(mk.encode_pfm(f, sc), [0, 0, 1, 254, 255, 255]) for sc in (-1.0, 1.0)]
    for i, (data, want) in enumerate(files):
        path = tmp_path / f"b{i}"
        path.write_bytes(data)
        assert png.read_gray(str(path)).tolist() == [want]
        assert _pil(data).tolist() == [want]


def _pil_j2k(**kw) -> bytes:
    buf = io.BytesIO()
    Image.new("L", (8, 6), 90).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


# a file of each kind the port refuses by name: JPEG 2000 of the
# irreversible 9/7 wavelet (the port reads the reversible 5/3), a Lab PSD,
# AVIF; the signature alone where no more is needed
UNPORTED_SIGNATURES = {
    "JPEG 2000": _pil_j2k(no_jp2=True, irreversible=True),
    "JPEG 2000 (JP2)": _pil_j2k(irreversible=True),
    # a 2 × 2 Lab PSD: the one PSD kind still refused (PIL cannot convert it)
    "PSD": b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, 2, 2, 8, 9),
    "AVIF": b"\0\0\0\x1cftypavif"}


@pytest.mark.parametrize("fmt", sorted(UNPORTED_SIGNATURES))
def test_unported_format_raises_naming_it(fmt):
    """A file that starts with the signature PIL identifies a format by, of
    a format or kind the port does not read yet (for PSD, which the port
    reads, a Lab header: PIL does not convert Lab either; for JPEG 2000,
    which the port reads, PIL's file of the 9/7 wavelet), raises
    ``NotImplementedError`` naming that format on ``decode_u8`` and
    ``image_size``; a file no plugin of PIL's opens keeps its
    ``ValueError``."""
    data = UNPORTED_SIGNATURES[fmt] + bytes(64)
    word = fmt.split(" (")[0]
    with pytest.raises(NotImplementedError, match=word):
        native.decode_u8(data)
    with pytest.raises(NotImplementedError, match=word):
        native.image_size(data)
    with pytest.raises(ValueError, match="no plugin of PIL's opens it"):
        native.decode_u8(b"hello" + bytes(64))


# compressions written as a second Compression entry after the file's own
# (1): PIL routes the file to libtiff by the last entry, libtiff decodes by
# the first (uncompressed)
TIFF_SECOND_COMPRESSION = {34925: "LZMA", 50000: "ZSTD", 50001: "WebP", 34676: "SGILog",
                           34677: "SGILog", 32809: "ThunderScan"}


@pytest.mark.parametrize("compression", sorted(TIFF_SECOND_COMPRESSION))
def test_tiff_compression_libtiff_reads_raises_naming_it(compression):
    """An 8-bit gray TIFF stored uncompressed that writes Compression again
    as this kind: PIL hands it to libtiff by the last entry, libtiff reads
    the first and decodes no compression, so PIL reads the raw pixels, and
    so does the port (it once refused these naming the second entry's
    kind; the compressions themselves are in
    ``test_torch_tiff_compressions.py``)."""
    g = mk.scene(16, 16, compression)
    data = mk.encode_tiff(g, tags=[(259, 3, [compression])])
    np.testing.assert_array_equal(_pil(data), g)
    np.testing.assert_array_equal(native.decode_u8(data), g)


# a file of each compression the port reads as libtiff decodes it for PIL
TIFF_LIBTIFF_READ = {
    2: lambda g, ycc: mk.encode_tiff_fax(g > 128, 2, 1),
    3: lambda g, ycc: mk.encode_tiff_fax(g > 128, 3, 0, 5, rows_per_strip=8),
    4: lambda g, ycc: mk.encode_tiff_fax(g > 128, 4, 1),
    32771: lambda g, ycc: mk.encode_tiff_fax(g > 128, 32771, 0),
    6: lambda g, ycc: mk.encode_tiff_ojpeg(ycc, 2, 2),
    7: lambda g, ycc: mk.encode_tiff_jpeg(ycc, 6, (2, 2), "all", rows_per_strip=16),
}


@pytest.mark.parametrize("compression", sorted(TIFF_LIBTIFF_READ))
def test_tiff_compression_libtiff_reads_reads_as_pil(compression):
    """Each compression PIL reads through libtiff that the port reads
    (CCITT MH, Group 3, Group 4, RLEW; old- and new-style JPEG) gives
    PIL's bytes (a 16×16 file of it; ``tests/test_torch_tiff_codecs.py``
    has the random ones)."""
    rgb = mk.scene(16, 16, compression, 3)
    data = TIFF_LIBTIFF_READ[compression](rgb[..., 0], mk.rgb_to_ycbcr(rgb))
    np.testing.assert_array_equal(native.decode_u8(data), _pil(data))


def pil_luma_of(rgb):
    r, g, b = (int(v) for v in rgb)
    return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16


def test_rle_rows_cut_short_fill_as_pil_and_early_ends_raise(tmp_path):
    """PIL's RLE decoder, as probed: rows an end-of-line cuts short and the
    pixels a delta skips read as index 0 (the palette's first entry, not
    black), a delta's offsets come from the two bytes after its own two;
    codes that end before the last row raise in PIL ("not enough image
    data") and in the port."""
    rng = np.random.default_rng(5)
    idx = rng.integers(1, 16, (6, 10))
    pal = rng.integers(0, 256, (16, 3))
    rows = [r[: 3 + i] for i, r in enumerate(idx[::-1])]  # each row ended early by an EOL
    data = mk.encode_bmp(idx, 8, compression=1, palette=pal,
                         rle=mk.rle_encode(rows, False, delta_at=(2, 2, 1)))
    ref = _pil(data)
    assert (ref == pil_luma_of(pal[0])).any()
    np.testing.assert_array_equal(native.decode_u8(data), ref)
    short = mk.encode_bmp(idx, 8, compression=1, palette=pal,
                          rle=mk.rle_encode(idx[::-1], False, stop_early=3))
    path = tmp_path / "short.bmp"
    path.write_bytes(short)
    with pytest.raises(ValueError, match="not enough image data"):
        _pil(short)
    with pytest.raises(OSError):
        png.read_gray(str(path))


MIXED = ("prog_gray.jpg", "arith_prog.jpg", "lossless_rgb_p7.jpg", "cmyk_prog.jpg", "ycck.jpg",
         "ycc_411.jpg", "p5_max1023.pgm", "p2.pgm", "p6_max1000.ppm", "p1.pbm",
         "tiff_raw_gray.tif", "tiff_lzw_pred2_16bit.tif", "tiff_be_16bit_tiles.tif",
         "tiff_float_pred3.tif", "tiff_bigtiff_lzw.tif", "tiff_palette4.tif", "bmp_gray8.bmp",
         "bmp_pal8.bmp", "bmp_rle8.bmp", "bmp_rle4.bmp", "bmp_1bit.bmp", "gif_quantized.gif",
         "gif_identity_local.gif", "gif_interlaced.gif", "webp.webp", "webp_lossy_alpha.webp",
         "webp_animated.webp", "webp_lossy.webp", "pfm_le.pfm")


def test_datasets_agree_on_a_tree_of_mixed_kinds(tmp_path):
    """The port's ``EurocDataset`` and JAX's on one tree whose frames are
    each of another kind (file names of any extension, as JAX's reader
    lists them): the same frames, and the loader's too."""
    for cam in ("cam0", "cam1"):
        os.makedirs(tmp_path / cam / "data")
    for i, name in enumerate(MIXED):
        for cam, other in (("cam0", name), ("cam1", MIXED[-1 - i])):
            shutil.copy(os.path.join(DIR, other),
                        tmp_path / cam / "data" / f"{1_000_000_000_000 + i}{os.path.splitext(name)[1]}")
    jds, tds = jdatasets.EurocDataset(str(tmp_path)), tdatasets.EurocDataset(str(tmp_path))
    assert jds.names == tds.names and len(tds) == len(MIXED)
    with native.NativeStereoLoader(*tds.file_lists(), 48, 64) as loader:
        for i, left, right in loader:
            for a in (tds[i], (left, right)):
                fl, fr = (a.image_left, a.image_right) if hasattr(a, "image_left") else a
                np.testing.assert_array_equal(fl, jds[i].image_left)
                np.testing.assert_array_equal(fr, jds[i].image_right)


WRITERS = {".tif": lambda u8: mk.encode_tiff(u8.astype(np.int64), bits=16, compression=5,
                                             predictor=2, rows_per_strip=16),
           ".tiff": lambda u8: mk.encode_tiff_jpeg(mk.rgb_to_ycbcr(np.dstack([u8] * 3)), 6, (2, 2),
                                                   "all", rows_per_strip=16),
           ".bmp": lambda u8: mk.encode_bmp(u8, 8, palette=np.stack([np.arange(256)] * 3, 1)),
           ".webp": lambda u8: mk._pil_save(Image.fromarray(u8), "WEBP", quality=80)}


def _cli_tree(root, frames, gt, ext, via=None):
    """A raw-EuRoC tree of ``frames`` under ``root``: progressive JPEGs
    written by PIL (``ext`` ".jpg"), PNG copies of PIL's decode of them
    (".png"), or those pixels as 16-bit LZW TIFFs with predictor 2 (".tif"),
    YCbCr 4:2:0 JPEG-in-TIFFs with shared JPEGTables (".tiff"),
    bottom-up 8-bit grey-palette BMPs (".bmp") or lossy WebPs at quality 80
    (".webp"); with ``via`` (one of those writers), the pixels PIL decodes
    from that writer's file instead."""
    seq = os.path.join(root, "mav0")
    names = [1_403_636_579_763_555_584 + i * 50_000_000 for i in range(len(frames))]
    for ns, pair in zip(names, frames):
        for cam, im in zip(("cam0", "cam1"), pair):
            buf = io.BytesIO()
            Image.fromarray((np.clip(im, 0, 1) * 255).astype(np.uint8)).save(
                buf, "JPEG", quality=85, progressive=True)
            path = os.path.join(seq, cam, "data", f"{ns}{ext}")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if ext == ".jpg":
                with open(path, "wb") as f:
                    f.write(buf.getvalue())
            pixels = _pil(buf.getvalue())
            if via is not None:
                pixels = _pil(WRITERS[via](pixels))
            if ext in WRITERS:
                with open(path, "wb") as f:
                    f.write(WRITERS[ext](pixels))
            elif ext == ".png":
                png.write_png(path, pixels)
    with open(os.path.join(seq, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        f.writelines(f"{ns},{ns}{ext}\n" for ns in names)
    os.makedirs(os.path.join(seq, "state_groundtruth_estimate0"))
    with open(os.path.join(seq, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.writelines(f"{ns},{T[0, 3]!r},{T[1, 3]!r},{T[2, 3]!r}\n" for ns, T in zip(names, gt))


def _cli_inputs(tmp_path):
    cfg = small_system_cfg()
    frames, traj = rendered_sequence(cfg, 6)
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    cam = cfg.camera
    (tmp_path / "algo.yaml").write_text(
        f"superpoint:\n  max_keypoints: {cfg.superpoint.max_keypoints}\n"
        f"superglue:\n  image_width: {cam.image_width}\n  image_height: {cam.image_height}\n"
        "  num_gnn_layers: 2\nkeyframe:\n  max_distance: 0.08\n")
    P = [cam.fx, 0.0, cam.cx, 0.0, 0.0, cam.fy, cam.cy, 0.0, 0.0, 0.0, 1.0, 0.0]
    (tmp_path / "cam.yaml").write_text(
        f"%YAML:1.0\nimage_width: {cam.image_width}\nimage_height: {cam.image_height}\n"
        f"bf: {cam.bf!r}\nLEFT.P: !!opencv-matrix\n  rows: 3\n  cols: 4\n  dt: d\n"
        f"  data: [{', '.join(repr(float(v)) for v in P)}]\n")
    save_npz_pytree(str(tmp_path / "sp.npz"), superpoint.init_params(0))
    return frames, gt


def _cli_run(tmp_path, frames, gt, ext, *extra, via=None):
    root = str(tmp_path / (ext[1:] + (via or "")))
    _cli_tree(root, frames, gt, ext, via)
    traj_path = str(tmp_path / f"traj{ext}{via or ''}{len(extra)}.txt")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tcli.main(["run", "--dataroot", root, "--config", str(tmp_path / "algo.yaml"),
                   "--camera-config", str(tmp_path / "cam.yaml"),
                   "--sp-weights", str(tmp_path / "sp.npz"), "--matcher", "cosine",
                   "--no-lines", "--device", "cpu", "--traj-path", traj_path, *extra])
    assert "processed 6 frames" in out.getvalue()
    with open(traj_path) as f:
        return f.read()


@pytest.fixture(scope="module")
def cli_png(tmp_path_factory):
    """``cli run --device cpu`` (the native prefetcher; the cosine matcher,
    lines off, to keep it short) on a 6-frame 320×240 PNG tree, run once
    for the CLI tests below: (their directory, frames, ground truth, the
    trajectory's text)."""
    tmp_path = tmp_path_factory.mktemp("cli")
    frames, gt = _cli_inputs(tmp_path)
    text = _cli_run(tmp_path, frames, gt, ".png")
    assert text
    return tmp_path, frames, gt, text


def test_cli_run_on_progressive_jpegs_equals_its_png_copies(cli_png):
    """``cli run`` on progressive JPEGs of the PNG tree's pixels: the same
    trajectory, text for text."""
    tmp_path, frames, gt, png_text = cli_png
    assert _cli_run(tmp_path, frames, gt, ".jpg") == png_text


def test_cli_run_on_tiff_and_bmp_trees_equals_png(cli_png):
    """The same pixels as 16-bit LZW TIFFs with predictor 2 through
    ``cli run`` (the native prefetcher) and as bottom-up 8-bit BMPs through
    ``cli run --no-native`` (``EurocDataset``): each trajectory equals the
    PNG tree's, text for text (no camera distortion: both routes feed the
    same frames)."""
    tmp_path, frames, gt, png_text = cli_png
    assert _cli_run(tmp_path, frames, gt, ".tif") == png_text
    assert _cli_run(tmp_path, frames, gt, ".bmp", "--no-native") == png_text


def test_cli_run_on_a_lossy_webp_tree_equals_its_png_copies(cli_png):
    """The PNG tree's pixels as lossy WebPs (quality 80) through ``cli run
    --no-native`` (``EurocDataset``): the trajectory equals that of a PNG
    tree of PIL's decode of the same WebPs through the native prefetcher,
    text for text."""
    tmp_path, frames, gt, _ = cli_png
    webp_text = _cli_run(tmp_path, frames, gt, ".webp", "--no-native")
    assert webp_text == _cli_run(tmp_path, frames, gt, ".png", via=".webp")


def test_cli_run_on_a_jpeg_in_tiff_tree_equals_its_png_copies(cli_png):
    """The PNG tree's pixels as YCbCr 4:2:0 JPEG-in-TIFFs (16-row strips,
    one JPEGTables stream) through ``cli run`` (the native prefetcher):
    the trajectory equals that of a PNG tree of PIL's decode of the same
    TIFFs, text for text."""
    tmp_path, frames, gt, _ = cli_png
    assert _cli_run(tmp_path, frames, gt, ".tiff") == _cli_run(tmp_path, frames, gt, ".png",
                                                              via=".tiff")
