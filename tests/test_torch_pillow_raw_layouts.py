"""The plugins of PIL 12.1 that hold their samples behind a small header,
as the port reads them: MSP, XBM, XPM, IM, IMT, IPTC, SPIDER, GBR, McIDAS,
PIXAR, XVThumb, FITS, FLI / FLC (frame 0) and PCD
(``csrc/native_layouts.h``, ``native_fli.h``, ``native_raster.h``).

PIL is the oracle, opened on a path as the JAX package's reader
(``rspl_slam_tpu.datasets._load_gray``) opens it. Random files of each
format (the encoders of ``tests/torch_make_image_kinds.py``, over their
header options) and bit-flipped, truncated and lengthened copies of them
give the port PIL's pixels, or the exception PIL's failure maps to: PIL
finding no plugin is the port's ``ValueError``; any other failure is the
port's ``NotImplementedError`` (a kind PIL refuses, named) or ``IOError``.
Where PIL opens a file, the port names the plugin PIL names.

Cases are cheap (a tenth of a second or less, PCD's 786 KB files a little
more); the seeds make them deterministic.
"""

import io
import os
import struct

import numpy as np
import pytest
import torch_make_image_kinds as mk
from PIL import Image
from test_torch_pillow_containers import _check_routes
from test_torch_pillow_formats import _agrees, _img, _mutate, _pil_format, _pil_saved, _size

from rspl_slam_tpu_torch import native, png


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("pillow_raw_layouts")


def _jpeg(a, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _layout_agrees(path, data):
    """``_agrees``, with two rules of the IPTC plugin, whose load opens its
    data fields again through every plugin: where that data is a JPEG of a
    kind PIL's JPEG plugin passes on (12-bit samples, 2 components), PIL
    finds no plugin while the port refuses the kind by name, as it refuses a
    lone JPEG of it (ROADMAP §1, "Stays refused"); and where PIL opens an
    IPTC file in mode L whose data opens as an image of another mode, PIL's
    ``convert("L")`` copies that image unconverted (an RGB JPEG comes out as
    (H, W, 3)): the port refuses it, naming IPTC."""
    with open(path, "wb") as f:
        f.write(data)
    try:
        with Image.open(path) as im:
            im.load()
            unconverted = im.format == "IPTC" and im.im.mode != im.mode
    except Exception:  # noqa: BLE001 - _agrees holds the failure's class
        unconverted = False
    if not unconverted:
        fault = _agrees(path, data)
        if fault and fault.startswith("PIL identifies nothing; the port: refused") and \
                "JPEG" in fault and "PIL does not read it either" in fault:
            return None
        return fault
    try:
        native.decode_u8(data)
    except NotImplementedError as e:
        return None if "IPTC" in str(e) else f"refused, not naming IPTC: {e}"
    except Exception as e:  # noqa: BLE001
        return f"PIL leaves the image unconverted; the port raises {type(e).__name__}"
    return "PIL leaves the image unconverted; the port reads it"


# ------------------------------------------------------------- generators
def _msp(rng):
    H, W = _size(rng, 30)
    bits = _img(rng, H, W, hi=2)
    if rng.random() < 0.4:
        return mk.encode_msp(bits)
    rows = mk.msp_rows(bits)
    if rng.random() < 0.3:  # blank rows (length 0), and rows decoding short or long
        for i in rng.integers(0, H, 2):
            rows[i] = [b"", b"\x01\x55", bytes([0, 5, 0xAA])][int(rng.integers(3))]
    return mk.encode_msp(bits, b"LinS", rows=rows)


def _xbm(rng):
    H, W = _size(rng, 30)
    hot = tuple(int(v) for v in rng.integers(0, 9, 2)) if rng.random() < 0.4 else None
    data = mk.encode_xbm(_img(rng, H, W, hi=2), name=[b"im", b"a_b", b"x"][int(rng.integers(3))],
                         hotspot=hot, per_line=int(rng.integers(1, 16)),
                         sep=[b", ", b",", b" ,\n  "][int(rng.integers(3))])
    if rng.random() < 0.3:
        data = data.upper()  # upper-case hex digits, the header's words as they were
        for word in (b"#define", b"_width", b"_height", b"_bits", b"_x_hot", b"_y_hot",
                     b"static char"):
            data = data.replace(word.upper(), word)
    if rng.random() < 0.2:
        data = b"\n  " + data.replace(b"\n", b"\r\n")
    return data


def _xpm(rng):
    H, W = _size(rng, 20)
    cpp = int(rng.choice([1, 2]))
    n = int(rng.choice([2, 16, 256, 300])) if cpp == 2 else int(rng.integers(2, 60))
    colours = [tuple(rng.integers(0, 256, 3)) for _ in range(n)]
    if rng.random() < 0.4:
        colours[int(rng.integers(n))] = None
    keys = None
    if rng.random() < 0.2:  # a duplicate key: the dict keeps its first place and last colour
        keys = [mk.encode_xpm(np.zeros((1, 1), int), colours, cpp).split(b"\n")[4 + i][1:1 + cpp]
                for i in range(n)]
        keys[-1] = keys[0]
    idx = rng.integers(0, n, (H, W))
    data = mk.encode_xpm(idx, colours, cpp, keys=keys, pixels_comment=bool(rng.random() < 0.5))
    if rng.random() < 0.3:  # colours of other hex widths
        data = data.replace(b" c #", b" c #000", 1)
    return data


IM_TYPES = ["0 1", "L 1", "Greyscale", "RGB", "B1", "B2", "B4", "X 24", "L 32 S", "L 32 F",
            "RGB3", "RYB3", "LA", "RGBA", "RGBX", "CMYK", "YCC", "L 8", "L 8S", "L 16", "L 16S",
            "L 16L", "L 16B", "L 32", "L 32F", "L 32S", "L*4", "L*12", "L*24", "L*16B", "PA",
            "RLB"]
IM_BPP = {"RGB": 3, "X 24": 3, "RGB3": 3, "RYB3": 3, "RGBA": 4, "RGBX": 4, "CMYK": 4, "YCC": 3,
          "LA": 2, "PA": 2, "L 32 S": 4, "L 32 F": 4, "L 32": 4, "L 32F": 4, "L 32S": 4,
          "L 16": 2, "L 16S": 2, "L 16L": 2, "L 16B": 2, "L*16B": 2, "L*12": 2, "L*24": 3,
          "RLB": 3}


PIL_IM_MODES = ["1", "L", "LA", "P", "PA", "I", "I;16", "I;16B", "F", "RGB", "RGBA", "RGBX",
                "CMYK", "YCbCr"]


def _im(rng):
    H, W = _size(rng, 16)
    if rng.random() < 0.25:  # PIL's own writer (P and PA with a colour Lut)
        mode = PIL_IM_MODES[int(rng.integers(len(PIL_IM_MODES)))]
        if mode in ("I;16", "I;16B"):
            im = Image.fromarray(rng.integers(0, 3000, (H, W)).astype(np.uint16)).convert(mode)
        else:
            im = Image.fromarray(_img(rng, H, W, 4), "RGBA")
            im = im.convert("P").convert("PA") if mode == "PA" else im.convert(mode)
        buf = io.BytesIO()
        im.save(buf, "IM")
        return buf.getvalue()
    kind = IM_TYPES[int(rng.integers(len(IM_TYPES)))]
    nbytes = (W + 7) // 8 * H if kind in ("0 1", "L 1", "B1") else W * H * IM_BPP.get(kind, 1)
    data = _img(rng, 1, nbytes + int(rng.integers(0, 3))).tobytes()
    if kind.startswith("L 32 F") or kind == "L 32F":
        data = (rng.random(W * H) * 300 - 20).astype("<f4").tobytes()
    lut = None
    r = rng.random()
    if r < 0.2:
        lut = np.tile(np.arange(256), 3)  # linear grey: no palette
    elif r < 0.35:
        lut = np.tile(rng.integers(0, 256, 256), 3)  # a grey Lut convert() ignores
    elif r < 0.5:
        lut = rng.integers(0, 256, 768)  # colour: P, or PA from LA
    extra = ["File size (no of images): 1", "Name: im.im", "Comment: a", "Comment: b"][
        :int(rng.integers(0, 5))]
    return mk.encode_im(kind + " image", (W, H), data, lut=lut, extra=extra,
                        block=int(rng.choice([512, 512, 200])))


def _imt(rng):
    H, W = _size(rng, 30)
    return mk.encode_imt(_img(rng, H, W), comment=b"made by numpy" if rng.random() < 0.4 else b"")


def _iptc(rng):
    H, W = _size(rng, 20)
    g = _img(rng, H, W)
    layers, component, band = (1, 0, None)
    if rng.random() < 0.5:
        layers, component = [(3, 1), (4, 1)][int(rng.integers(2))]
        band = int(rng.integers(0, 5)) if rng.random() < 0.8 else None
    if rng.random() < 0.5:
        return mk.encode_iptc(W, H, g.tobytes(), layers, component, band, 1,
                              chunk=int(rng.choice([7, 50, 30000])))
    a = g if layers != 1 or rng.random() < 0.6 else _img(rng, H, W, 3)
    return mk.encode_iptc(W, H, _jpeg(a, quality=int(rng.integers(50, 95))), layers, component,
                          band, 5, chunk=int(rng.choice([40, 30000, 40000])))


def _spider(rng):
    H, W = _size(rng, 20)
    a = rng.random((H, W)) * 320 - 30
    if rng.random() < 0.3:
        a.flat[rng.integers(0, H * W, 3)] = [np.nan, np.inf, -np.inf]
    return mk.encode_spider(a, big=bool(rng.random() < 0.5),
                            stack=int(rng.integers(1, 4)) if rng.random() < 0.3 else 0)


def _gbr(rng):
    H, W = _size(rng, 20)
    px = _img(rng, H, W) if rng.random() < 0.5 else _img(rng, H, W, 4)
    return mk.encode_gbr(px, int(rng.choice([1, 2])), name=b"b" * int(rng.integers(0, 9)))


def _mcidas(rng):
    H, W = _size(rng, 20)
    b = int(rng.choice([1, 2, 4]))
    hi = {1: 256, 2: 600, 4: 1 << 20}[b]
    px = rng.integers(0, hi, (H, W))
    if b == 4 and rng.random() < 0.5:
        px -= hi // 2
    return mk.encode_mcidas(px, b, prefix=int(rng.integers(0, 5)), bands=int(rng.integers(1, 3)))


def _pixar(rng):
    H, W = _size(rng, 20)
    if rng.random() < 0.15:  # another channel / depth: no mode
        return mk.encode_pixar(_img(rng, H, W, 3), channels=int(rng.choice([8, 14])),
                               depth=int(rng.choice([1, 3])))
    return mk.encode_pixar(_img(rng, H, W, 3))


def _xvthumb(rng):
    H, W = _size(rng, 20)
    comments = [b"#XVVERSION:Version 2.28", b"#IMGINFO:%d" % int(rng.integers(100)), b"#"][
        :int(rng.integers(0, 4))]
    return mk.encode_xvthumb(_img(rng, H, W), comments=comments)


def _fits(rng):
    H, W = _size(rng, 16)
    bitpix = int(rng.choice([8, 16, 32, -32, -64]))
    if bitpix == 8:
        a = _img(rng, H, W)
    elif bitpix > 0:
        a = rng.integers(-300, 700, (H, W))
    else:
        a = rng.random((H, W)) * 300 - 20
    if rng.random() < 0.3:
        gz_bits = int(rng.choice([8, 16, 32, -32]))
        return mk.encode_fits(rng.integers(-400, 700, (H, W)), gz_bits, gzip_tile=True,
                              gzip_members=int(rng.integers(1, 3)))
    return mk.encode_fits(a, bitpix, naxis=1 if rng.random() < 0.2 else 2)


def _fli(rng):
    H, W = _size(rng, 20)
    W += W % 2 if rng.random() < 0.7 else 0  # SS2 moves words
    idx = _img(rng, H, W)
    pal = rng.integers(0, 256, (256, 3))
    prev = _img(rng, H, W)
    chunks = []
    r = rng.random()
    if r < 0.35:
        chunks.append(mk.fli_chunk(4, mk.fli_palette(pal)))
    elif r < 0.6:
        packets = [(int(rng.integers(0, 4)), int(rng.integers(1, 40))) for _ in range(3)]
        chunks.append(mk.fli_chunk(11, mk.fli_palette(pal, 2, packets)))
    first = int(rng.integers(4))
    if first == 0:
        chunks.append(mk.fli_chunk(15, mk.fli_brun(idx)))
    elif first == 1:
        chunks.append(mk.fli_chunk(16, idx.tobytes()))
    elif first == 2:
        chunks += [mk.fli_chunk(16, prev.tobytes()), mk.fli_chunk(12, mk.fli_lc(idx, prev))]
    else:
        chunks += [mk.fli_chunk(15, mk.fli_brun(prev)), mk.fli_chunk(7, mk.fli_ss2(idx, prev))
                   if W % 2 == 0 else mk.fli_chunk(12, mk.fli_lc(idx, prev))]
    if rng.random() < 0.2:
        chunks.append(mk.fli_chunk(int(rng.choice([13, 18])), bytes(int(rng.integers(0, 6)))))
    return mk.encode_fli(idx, pal, kind=int(rng.choice([0xAF11, 0xAF12])), chunks=chunks,
                         prefix=bytes(int(rng.integers(1, 10))) if rng.random() < 0.1 else b"")


GENERATORS = {"msp": _msp, "xbm": _xbm, "xpm": _xpm, "im": _im, "imt": _imt, "iptc": _iptc,
              "spider": _spider, "gbr": _gbr, "mcidas": _mcidas, "pixar": _pixar,
              "xvthumb": _xvthumb, "fits": _fits, "fli": _fli}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fmt", sorted(GENERATORS))
def test_random_and_corrupted_files_agree_with_pil(fmt, seed, scratch):
    """Eight random files of the format over its header options, each with
    six corrupted copies: the port gives PIL's pixels or the exception
    class PIL's failure maps to, and names the plugin PIL opens it with."""
    rng = np.random.default_rng([seed, sorted(GENERATORS).index(fmt), 22])
    path = str(scratch / f"{fmt}_{seed}")
    faults = []
    for i in range(8):
        data = GENERATORS[fmt](rng)
        for j, d in enumerate([data] + [_mutate(rng, d) for d in [data] * 6]):
            fault = _layout_agrees(path, d)
            if fault is None:
                pil = _pil_format(path)
                if pil and not pil.startswith("!") and native.plugin_of(d) != pil:
                    fault = f"PIL's plugin {pil}; the port's {native.plugin_of(d)}"
            if fault:
                faults.append(f"file {i}, copy {j}: {fault}")
    assert not faults, faults


@pytest.mark.parametrize("orientation", range(4))
def test_pcd_reads_as_pil_in_each_orientation(orientation, tmp_path):
    """A PhotoCD base image (768 × 512, PhotoYCC through PIL's tables)
    in each orientation (1 and 3 rotate by 90 and 270 degrees), and copies
    cut short, one byte long, and with the orientation byte's high bits
    set: PIL's pixels or its failure's class on every route."""
    data = mk.pcd_sample(orientation, orientation)
    path = str(tmp_path / "f.pcd")
    with open(path, "wb") as f:
        f.write(data)
    _check_routes(path, data, "ok")
    assert native.plugin_of(data) == "PCD"
    odd = bytearray(data)
    odd[2048 + 1538] |= 0xFC
    for copy in (data[:len(data) - 1000], data + b"\0", bytes(odd), data[:3000]):
        assert _agrees(path, copy) is None


def test_the_smokes_photocd_hashes_are_pils():
    """``chip_smoke.PCD_SAMPLES_SHA256`` (the card's machine has no PIL) is
    PIL's sha256 of each PhotoCD file ``pcd_sample`` writes, and the port's."""
    import chip_smoke

    for (seed, orientation), want in chip_smoke.PCD_SAMPLES_SHA256.items():
        data = mk.pcd_sample(seed, orientation)
        assert mk.pil_sha256(data) == want
        assert chip_smoke._u8_sha256(native.decode_u8(data)) == want


# ------------------------------------------------ the plugins read now
def _mcidas():
    """An 8-bit McIDAS area: the directory's words (w[1..64] as PIL numbers
    them) with its rows of 5 bytes at 256."""
    words = [0] * 64
    words[1] = 4                      # w[2]: the accept test's last byte
    words[8], words[9] = 3, 5         # w[9], w[10]: height, width
    words[10], words[13] = 1, 1       # w[11]: 1 byte per pixel; w[14]: one band
    words[33] = 256                   # w[34]: the data's offset
    return struct.pack("!64i", *words) + bytes(15)


def _pixar():
    head = bytearray(512)
    head[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", head, 416, 3, 4)     # height, width
    struct.pack_into("<HH", head, 424, 14, 2)    # RGB
    return bytes(head) + bytes(512) + bytes(range(36))


# the files the refusal test of ``test_torch_pillow_formats.py`` gave these
# plugins while the port refused them (the same bytes), and the word the
# refusal named; a PCD file of that test was too short for PIL's load
FORMERLY_REFUSED = {
    "FITS": (lambda: b"".join(c.ljust(80) for c in (
        b"SIMPLE  = T", b"BITPIX  = 8", b"NAXIS   = 2", b"NAXIS1  = 4", b"NAXIS2  = 3",
        b"END")).ljust(2880) + bytes(2880), "FITS"),
    "FLI": (lambda: struct.pack("<IHHHHHHI", 256, 0xAF11, 1, 4, 3, 8, 0, 5) + bytes(108)
            + struct.pack("<IH", 16, 0xF1FA) + bytes(10), "FLI"),
    "GBR": (lambda: struct.pack(">IIIII", 28, 2, 4, 3, 1) + b"GIMP" + struct.pack(">I", 10)
            + bytes(12), "GBR"),
    "IM": (lambda: _pil_saved("IM"), "IM"),
    "IMT": (lambda: b"width 4\nheight 3\npixel n8\n\x0c" + bytes(12), "IMT"),
    "IPTC": (lambda: b"".join(bytes([0x1C, 3, t]) + struct.pack(">H", len(v)) + v
                              for t, v in ((60, b"\x01\x00"), (20, b"\x00\x04"), (30, b"\x00\x03"),
                                           (120, b"\x01")))
             + b"\x1c\x08\x0a\x00\x0c" + bytes(12), "IPTC"),
    "MCIDAS": (_mcidas, "McIDAS"),
    "MSP": (lambda: _pil_saved("MSP", "1"), "MSP"),
    "PCD": (lambda: bytes(2048) + b"PCD_" + bytes(1600), "PhotoCD"),
    "PIXAR": (_pixar, "PIXAR"),
    "SPIDER": (lambda: _pil_saved("SPIDER", "F"), "SPIDER"),
    "XBM": (lambda: _pil_saved("XBM", "1"), "XBM"),
    "XPM": (lambda: b'/* XPM */\nstatic char *x[] = {\n"2 1 1 1",\n"a c #000000",\n"aa"\n};\n',
            "XPM"),
    "XVThumb": (lambda: b"P7 332\n#XVVERSION\n#END_OF_COMMENTS\n2 1 255\n\x00\x01",
                "XV thumbnail"),
}


@pytest.mark.parametrize("plugin", sorted(FORMERLY_REFUSED))
def test_every_plugin_refused_before_now_reads_as_pil(plugin, tmp_path):
    """A file PIL gives to each of these plugins, which the port refused by
    name until it read them: PIL opens it with the plugin, the port names
    the same plugin, no longer refuses it, and gives PIL's pixels (or, for
    the PCD file, too short for PIL's load, an IOError) on ``decode_u8``,
    ``image_size`` and ``png.read_gray``."""
    make, word = FORMERLY_REFUSED[plugin]
    data = make()
    path = tmp_path / "f"
    path.write_bytes(data)
    with Image.open(path) as im:
        assert im.format == plugin
        size = im.size
        try:
            ref = np.asarray(im.convert("L"))
        except OSError:
            ref = None
    assert native.plugin_of(data) == plugin
    if ref is None:
        for call in (lambda: native.decode_u8(data), lambda: png.read_gray(str(path))):
            with pytest.raises(OSError) as e:
                call()
            assert not isinstance(e.value, NotImplementedError) and word not in str(e.value)
        assert native.image_size(data) == size[::-1]
        return
    assert native.image_size(data) == ref.shape
    np.testing.assert_array_equal(native.decode_u8(data), ref)
    np.testing.assert_array_equal(png.read_gray(str(path)), ref)


def test_raw_layout_fixtures_regenerate_byte_for_byte():
    """The fixtures of these plugins are what
    ``torch_make_image_kinds.layout_files`` writes, byte for byte."""
    root = os.path.join(os.path.dirname(__file__), "fixtures", "image_kinds")
    for name, (data, *_) in mk.layout_files(0).items():
        with open(os.path.join(root, name), "rb") as f:
            assert f.read() == data, name
