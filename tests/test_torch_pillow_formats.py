"""The formats the port reads as PIL 12.1's plugins read them, beyond
JPEG, netpbm, TIFF, BMP, GIF and WebP: headerless DIB, QOI, Sun raster,
PCX, SGI, TGA, ICO, CUR and DDS; and how a file is identified, plugin by
plugin in ``Image.open``'s order, with a named refusal for every plugin the
port does not read (PSD, DCX, BLP, FTEX and ICNS, read since, are in
``test_torch_pillow_containers.py``).

PIL is the oracle, opened on a path as the JAX package's reader
(``rspl_slam_tpu.datasets._load_gray``) opens it. Random files of each
format (the encoders of ``tests/torch_make_image_kinds.py``, over their
header options) and bit-flipped, truncated and lengthened copies of them
give the port PIL's pixels, or the exception PIL's failure maps to: PIL
finding no plugin (``UnidentifiedImageError``) is the port's
``ValueError``; any other failure is the port's ``NotImplementedError`` (a
kind PIL refuses, named) or ``IOError``. The random ICO files mix PNG and
DIB entries, corrupted like the rest: the port's PNG reader checks the
CRCs of the chunks before IDAT only, as PIL does, and an error of the
pass-on kinds while the entry loads passes the ICO on
(``test_torch_pillow_containers.py`` holds PNG chunks to PIL).

Cases are cheap (about 0.1 s each); the seeds make them deterministic.
"""

import io
import os
import struct

import numpy as np
import pytest
import torch_make_image_kinds as mk
from PIL import Image, UnidentifiedImageError

from rspl_slam_tpu import datasets as jdatasets
from rspl_slam_tpu_torch import native, png


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("pillow_formats")


def _pil(path):
    """PIL's result for a file: ("ok", gray) or ("value" | "error", exception)."""
    try:
        with Image.open(path) as im:
            return "ok", np.asarray(im.convert("L"))
    except UnidentifiedImageError as e:
        return "value", e
    except Exception as e:  # noqa: BLE001 - PIL's decoders raise many kinds
        return "error", e


def _port(data):
    try:
        return "ok", native.decode_u8(data)
    except NotImplementedError as e:
        return "refused", e
    except ValueError as e:
        return "value", e
    except OSError as e:
        return "error", e


def _agrees(path, data):
    """The port's decode of ``data`` against PIL's of the same file: the
    same pixels, ValueError where PIL identifies nothing, an IOError or a
    named refusal where PIL fails otherwise. Returns a fault or None."""
    with open(path, "wb") as f:
        f.write(data)
    a, b = _pil(path), _port(data)
    if a[0] == "ok":
        if b[0] != "ok" or b[1].shape != a[1].shape or not np.array_equal(a[1], b[1]):
            return f"PIL reads {a[1].shape}; the port: {b[0]} {b[1] if b[0] != 'ok' else ''}"
    elif a[0] == "value":
        if b[0] != "value":
            return f"PIL identifies nothing; the port: {b[0]} {b[1] if b[0] != 'ok' else ''}"
    elif b[0] not in ("refused", "error"):
        return f"PIL raises {type(a[1]).__name__}: {a[1]}; the port: {b[0]}"
    return None


def _mutate(rng, data: bytes) -> bytes:
    d = bytearray(data)
    r = rng.random()
    if r < 0.6 and d:  # one to three bits flipped
        for _ in range(int(rng.integers(1, 4))):
            i = int(rng.integers(len(d)))
            d[i] ^= 1 << int(rng.integers(8))
    elif r < 0.8:  # truncated
        d = d[:int(rng.integers(0, len(d) + 1))]
    else:  # bytes inserted
        i = int(rng.integers(len(d) + 1))
        d[i:i] = bytes(rng.integers(0, 256, int(rng.integers(1, 5))).astype(np.uint8))
    return bytes(d)


def _img(rng, H, W, C=None, hi=256):
    a = rng.integers(0, hi, (H, W) if C is None else (H, W, C))
    if rng.random() < 0.5:  # runs, for the run-length coders
        a = np.repeat(a, 3, axis=1)[:, :W]
    return a.astype(np.uint8)


def _size(rng, top=12):
    return int(rng.integers(1, top)), int(rng.integers(1, top))


# ----------------------------------------------------------- generators
def _qoi(rng):
    H, W = _size(rng, 20)
    px = _img(rng, H, W, 4)
    px[rng.random((H, W)) < 0.5] = px[0, 0]
    if rng.random() < 0.5:
        px = px // 64 * 64
    return mk.encode_qoi(px, int(rng.choice([3, 4])))


def _sun(rng):
    H, W = _size(rng)
    depth = int(rng.choice([1, 4, 8, 24, 32]))
    px = _img(rng, H, W, 3) if depth > 8 else _img(rng, H, W, hi=1 << depth)
    pal = None
    if depth in (4, 8) and rng.random() < 0.5:
        pal = rng.integers(0, 256, (int(rng.integers(1, 1 << depth + 1)), 3))
    elif depth in (1, 24) and rng.random() < 0.1:  # a map PIL cannot apply
        pal = rng.integers(0, 256, (4, 3))
    return mk.encode_sun(px, depth, int(rng.choice([0, 1, 2, 3, 2])), palette=pal)


def _pcx(rng):
    H, W = _size(rng, 14)
    kind = int(rng.integers(4))
    own = rng.random() < 0.7  # the header's stride PIL's own, else the unpadded one
    if kind == 0:
        return mk.encode_pcx(_img(rng, H, W, hi=2), 1, 1, version=int(rng.choice([0, 2, 3, 5])),
                             stride=None if own else (W + 7) // 8)
    if kind == 1:
        planes = int(rng.choice([2, 4]))
        return mk.encode_pcx(_img(rng, H, W, hi=1 << planes), 1, planes,
                             palette16=rng.integers(0, 256, (16, 3)),
                             stride=None if own else (W + 7) // 8)
    if kind == 2:
        r = rng.random()
        pal = None if r < 0.3 else (np.repeat(np.arange(256)[:, None], 3, 1) if r < 0.5
                                    else rng.integers(0, 256, (256, 3)))
        return mk.encode_pcx(_img(rng, H, W), 8, 1, palette256=pal, stride=None if own else W)
    return mk.encode_pcx(_img(rng, H, W, 3), 8, 3, stride=None if own else W)


def _sgi(rng):
    H, W = _size(rng)
    Z, bpc = int(rng.choice([1, 3, 4])), int(rng.choice([1, 2]))
    px = _img(rng, H, W, Z).astype(np.uint16)
    if bpc == 2:
        px = px * 257 + rng.integers(0, 2, px.shape)
    return mk.encode_sgi(px, bpc, rle=bool(rng.random() < 0.7))


def _tga(rng):
    H, W = _size(rng)
    itype, rle = int(rng.choice([1, 2, 3])), bool(rng.random() < 0.6)
    kw = dict(top_down=bool(rng.random() < 0.5), flip=bool(rng.random() < 0.5),
              ident=bytes(int(rng.integers(0, 3))))
    if itype == 1:
        n, start = int(rng.integers(1, 40)), int(rng.integers(0, 4))
        return mk.encode_tga(rng.integers(0, n + start + 2, (H, W)), 9 if rle else 1, 8,
                             cmap=rng.integers(0, 256, (n, 3)),
                             cmap_depth=int(rng.choice([16, 24])), cmap_start=start, **kw)
    if itype == 3:
        depth = int(rng.choice([8, 16] if rle else [8, 16, 1]))
        px = _img(rng, H, W, 2) if depth == 16 else _img(rng, H, W, hi=2 if depth == 1 else 256)
        return mk.encode_tga(px, 11 if rle else 3, depth, **kw)
    return mk.encode_tga(_img(rng, H, W, 4), 10 if rle else 2, int(rng.choice([16, 24, 32])),
                         **kw)


BMP_MASKS = {16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)], 24: [(0xFF0000, 0xFF00, 0xFF)],
             32: [(0xFF0000, 0xFF00, 0xFF)]}


def _dib(rng):
    H, W = _size(rng, 10)
    bits = int(rng.choice([1, 4, 8, 16, 24, 32]))
    header = int(rng.choice([12, 40, 52, 56, 64, 108, 124]))
    kw = {}
    if bits <= 8:
        px = _img(rng, H, W, hi=1 << bits)
        if rng.random() < 0.7:
            kw["palette"] = rng.integers(0, 256, (1 << bits, 3))
        if header != 12 and bits in (4, 8) and rng.random() < 0.4:
            kw["compression"] = 2 if bits == 4 else 1
    else:
        px = _img(rng, H, W, 3)
        if header != 12 and rng.random() < 0.3:
            kw["compression"] = 3
            kw["masks"] = BMP_MASKS[bits][int(rng.integers(len(BMP_MASKS[bits])))]
    if header != 12 and rng.random() < 0.3:
        kw["top_down"] = True
    return mk.encode_dib(px, bits, header=header, **kw)


def _dib_entry(rng, H, W):
    bits = int(rng.choice([1, 4, 8, 24, 32]))
    px = _img(rng, H, W, 3) if bits > 8 else _img(rng, H, W, hi=1 << bits)
    pal = rng.integers(0, 256, (1 << bits, 3)) if bits <= 8 else None
    return mk.ico_dib(px, bits, palette=pal), bits


def _cur(rng):
    H, W = _size(rng, 10)
    return mk.encode_ico([_dib_entry(rng, H + k, W + k)[0]
                          for k in range(int(rng.integers(1, 3)))], kind=2)


def _ico(rng, png_entries=False):
    entries, dims = [], []
    for _ in range(int(rng.integers(1, 4))):
        H, W = _size(rng, 10)
        if png_entries and rng.random() < 0.4:
            mode = str(rng.choice(["L", "RGB", "RGBA", "P", "LA", "I;16"]))
            chans = {"RGB": 3, "RGBA": 4, "LA": 2}.get(mode)
            a = _img(rng, H, W, chans)
            im = Image.fromarray(a.astype(np.uint16) * 257 if mode == "I;16" else a)
            buf = io.BytesIO()
            (im.convert("P") if mode == "P" else im).save(buf, "PNG")
            entries.append(buf.getvalue())
            dims.append((W, H, 0, int(rng.choice([0, 32]))))
        else:
            e, bits = _dib_entry(rng, H, W)
            entries.append(e)
            # the directory's colour count and bits PIL sorts by (32: its alpha rule)
            dims.append((W, H, int(rng.choice([0, 0, 2, 16, 255])),
                         int(rng.choice([bits, bits, 0, 32]))))
    return mk.encode_ico(entries, kind=1, dims=dims)


DXGI = {1: [70, 71], 2: [73, 74], 3: [76, 77], 4: [79, 80], 5: [82, 83, 84], 6: [95, 96],
        7: [97, 98, 99]}
FOURCC = {1: [b"DXT1"], 2: [b"DXT3"], 3: [b"DXT5"], 4: [b"BC4U", b"ATI1"],
          5: [b"BC5U", b"ATI2", b"BC5S"]}
BC6_MODES = np.array([0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15])


def _dds(rng, kinds):
    H, W = _size(rng, 14)
    k = int(rng.choice(kinds))
    if k == 0:  # uncompressed: bit masks, luminance, palette, DX10 RGBA
        r = rng.random()
        if r < 0.4:
            bc = int(rng.choice([8, 16, 24, 32]))
            masks = [(0xF800, 0x7E0, 0x1F, 0), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                     (0x7C00, 0x3E0, 0x1F, 0x8000), (0xF00, 0xF0, 0xF, 0xF000),
                     (0xE0, 0x1C, 0x3, 0)][int(rng.integers(5))]
            return mk.encode_dds(rng.integers(0, 256, W * H * bc // 8).astype(np.uint8), W, H,
                                 pfflags=0x41 if rng.random() < 0.5 else 0x40, bitcount=bc,
                                 masks=masks)
        if r < 0.6:
            return mk.encode_dds(rng.integers(0, 256, W * H).astype(np.uint8), W, H,
                                 pfflags=0x20000, bitcount=8)
        if r < 0.7:
            return mk.encode_dds(rng.integers(0, 256, 2 * W * H).astype(np.uint8), W, H,
                                 pfflags=0x20001, bitcount=16)
        if r < 0.85:
            return mk.encode_dds(rng.integers(0, 256, 1024 + W * H).astype(np.uint8), W, H,
                                 pfflags=0x20)
        return mk.encode_dds(rng.integers(0, 256, 4 * W * H).astype(np.uint8), W, H,
                             fourcc=b"DX10", dxgi=int(rng.choice([27, 28, 29])))
    nb = ((W + 3) // 4) * ((H + 3) // 4)
    blocks = rng.integers(0, 256, (nb, 8 if k in (1, 4) else 16)).astype(np.uint8)
    if k == 7 and rng.random() < 0.5:  # every BC7 mode, not mostly mode 0
        m = rng.integers(0, 8, nb)
        blocks[:, 0] = (blocks[:, 0] & ~((2 << m) - 1) & 0xFF) | (1 << m)
    if k == 6 and rng.random() < 0.5:  # every BC6H mode, not mostly the reserved ones
        blocks[:, 0] = (blocks[:, 0] & 0xE0) | BC6_MODES[rng.integers(0, 14, nb)]
    if k in FOURCC and rng.random() < 0.5:
        return mk.encode_dds(blocks, W, H, fourcc=FOURCC[k][int(rng.integers(len(FOURCC[k])))])
    return mk.encode_dds(blocks, W, H, fourcc=b"DX10", dxgi=int(rng.choice(DXGI[k])))


GENERATORS = {
    "qoi": _qoi, "sun": _sun, "pcx": _pcx, "sgi": _sgi, "tga": _tga, "dib": _dib,
    "cur": _cur, "ico": lambda rng: _ico(rng, png_entries=True),
    "dds_bc1_3": lambda rng: _dds(rng, (1, 2, 3)), "dds_bc4_5": lambda rng: _dds(rng, (4, 5)),
    "dds_bc6h": lambda rng: _dds(rng, (6,)), "dds_bc7": lambda rng: _dds(rng, (7,)),
    "dds_uncompressed": lambda rng: _dds(rng, (0,)),
}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fmt", sorted(GENERATORS))
def test_random_and_corrupted_files_agree_with_pil(fmt, seed, scratch):
    """Eight random files of the format over its header options, each with
    six corrupted copies: the port gives PIL's pixels or the exception
    class PIL's failure maps to, and names the plugin PIL opens it with."""
    rng = np.random.default_rng([seed, sorted(GENERATORS).index(fmt)])
    path = str(scratch / f"{fmt}_{seed}")
    faults = []
    for i in range(8):
        data = GENERATORS[fmt](rng)
        for j, d in enumerate([data] + [_mutate(rng, data) for _ in range(6)]):
            fault = _agrees(path, d)
            if fault:
                faults.append(f"file {i}, copy {j}: {fault}")
    assert not faults, faults


@pytest.mark.parametrize("seed", range(3))
def test_ico_png_entries_read_as_pil(seed, scratch):
    """ICO files mixing PNG entries (L, RGB, RGBA, P, LA, 16-bit gray) and
    DIB entries: the entry PIL picks, read through the port's PNG reader,
    gives PIL's gray."""
    rng = np.random.default_rng(100 + seed)
    path = str(scratch / f"ico_png_{seed}")
    faults = [f for f in (_agrees(path, _ico(rng, png_entries=True)) for _ in range(12)) if f]
    assert not faults, faults


DIB_CASES = [(hs, bits) for hs in (12, 40, 52, 56, 64, 108, 124) for bits in (1, 4, 8, 24)] + [
    (hs, bits) for hs in (40, 52, 56, 64, 108, 124) for bits in (16, 32)]


@pytest.mark.parametrize("header,bits", DIB_CASES)
def test_headerless_dib_reads_on_every_route(header, bits, tmp_path):
    """A DIB (a BMP without its 14-byte file header) of every header size
    PIL's DIB plugin accepts: PIL's pixels, JAX's ``_load_gray``'s, on
    ``png.read_gray``, ``native.decode_u8`` and a ``NativeStereoLoader``."""
    rng = np.random.default_rng([header, bits])
    px = rng.integers(0, 256, (7, 9, 3)) if bits > 8 else rng.integers(0, 1 << bits, (7, 9))
    pal = rng.integers(0, 256, (1 << bits, 3)) if bits <= 8 else None
    data = mk.encode_dib(px, bits, palette=pal, header=header)
    path = tmp_path / "f.dib"
    path.write_bytes(data)
    ref = jdatasets._load_gray(str(path))
    with Image.open(path) as im:
        assert im.format == "DIB"
    assert native.plugin_of(data) == "DIB"
    np.testing.assert_array_equal(png.read_gray(str(path)).astype(np.float32) / 255.0, ref)
    np.testing.assert_array_equal(native.decode_u8(data).astype(np.float32) / 255.0, ref)
    with native.NativeStereoLoader([str(path)], [str(path)], 7, 9) as loader:
        (_, left, right), = list(loader)
    np.testing.assert_array_equal(left, ref)
    np.testing.assert_array_equal(right, ref)


def _tga_header(itype, depth, w=2, h=1, cmap=(0, 0, 0)):
    start, size, mdepth = cmap
    return struct.pack("<BBBHHBHHHHBB", 0, 1 if size else 0, itype, start, size, mdepth, 0, 0,
                       w, h, depth, 0x20)


# a file of each kind of these formats PIL refuses, and two phrases of the
# port's refusal: the format and PIL's own reason
PIL_REFUSES = {
    "sun_map_on_rgb": (lambda: mk.encode_sun(np.zeros((2, 3, 3)), 24, 1, palette=np.zeros((4, 3))),
                       ("Sun raster", "unrecognized image mode")),
    "sun_map_of_300": (lambda: mk.encode_sun(np.zeros((2, 3)), 8, 1, palette=np.zeros((300, 3))),
                       ("Sun raster", "invalid palette size")),
    "pcx_2bit": (lambda: mk.encode_pcx(np.zeros((2, 3)), 2, 1), ("PCX", "unknown PCX mode")),
    "sgi_two_channels": (lambda: mk.encode_sgi(np.zeros((2, 3, 2)), 1, dimension=3),
                         ("SGI", "Unsupported SGI image mode")),
    "sgi_compression_2": (lambda: b"\x01\xda\x02\x01" + mk.encode_sgi(np.zeros((2, 3)), 1)[4:],
                          ("SGI", "cannot load this image")),
    "tga_rgb_8bit": (lambda: _tga_header(2, 8) + bytes(2), ("TGA", "cannot load this image")),
    "tga_indices_without_map": (lambda: _tga_header(1, 8) + bytes(2), ("TGA", "unknown raw mode")),
    "tga_map_32bit": (lambda: _tga_header(1, 8, cmap=(0, 2, 32)) + bytes(8) + bytes(2),
                      ("TGA", "unrecognized raw mode")),
    "tga_map_on_rgb": (lambda: _tga_header(2, 24, cmap=(0, 2, 24)) + bytes(6) + bytes(6),
                       ("TGA", "unrecognized image mode")),
    "tga_map_of_300": (lambda: _tga_header(1, 8, cmap=(0, 300, 24)) + bytes(900) + bytes(2),
                       ("TGA", "invalid palette size")),
    "dds_header_100": (lambda: b"DDS " + struct.pack("<I", 100) + bytes(200),
                       ("DDS", "Unsupported header size")),
    "dds_bc4s": (lambda: mk.encode_dds(bytes(8), 4, 4, fourcc=b"BC4S"),
                 ("DDS", "Unimplemented pixel format")),
    "dds_bc4_snorm": (lambda: mk.encode_dds(bytes(8), 4, 4, fourcc=b"DX10", dxgi=81),
                      ("DDS", "Unimplemented DXGI format")),
    "dds_bc1_srgb": (lambda: mk.encode_dds(bytes(8), 4, 4, fourcc=b"DX10", dxgi=72),
                     ("DDS", "Unimplemented DXGI format")),
    "dds_luminance_16": (lambda: mk.encode_dds(bytes(32), 4, 4, pfflags=0x20000, bitcount=16),
                         ("DDS", "Unsupported bitcount")),
    "dds_no_format_flag": (lambda: mk.encode_dds(bytes(32), 4, 4, pfflags=0x2),
                           ("DDS", "Unknown pixel format flags")),
    "dib_2bit": (lambda: mk.encode_dib(np.zeros((2, 3)), 8)[:14] + b"\x02"
                 + mk.encode_dib(np.zeros((2, 3)), 8)[15:], ("BMP", "pixel depth")),
}


@pytest.mark.parametrize("kind", sorted(PIL_REFUSES))
def test_kinds_pil_refuses_are_refused_with_its_reason(kind, tmp_path):
    """Each kind of these formats PIL takes and fails on (a colour map it
    cannot apply, a mode or compression it lacks, a DDS format it has no
    decoder for): PIL raises, and the port raises ``NotImplementedError``
    naming the format and PIL's reason, on ``decode_u8`` and
    ``png.read_gray``."""
    make, (fmt, reason) = PIL_REFUSES[kind]
    data = make()
    path = tmp_path / "f"
    path.write_bytes(data)
    assert _pil(str(path))[0] == "error"
    for call in (lambda: native.decode_u8(data), lambda: png.read_gray(str(path))):
        with pytest.raises(NotImplementedError, match=fmt) as e:
            call()
        assert reason in str(e.value)


# ------------------------------------------------------------ identification
def _tga_under_a_pcx_signature():
    """A file PCX's accept takes (0x0A, version 0) whose PCX header PIL
    declines (an empty box), and a valid TGA: the TGA header's ID field
    length is 10, its image type 3 (gray), 5 × 3 pixels after the ID."""
    head = bytearray(struct.pack("<BBBHHBHHHHBB", 10, 0, 3, 0, 0, 0, 0, 0, 5, 3, 8, 0x20))
    head[4:12] = struct.pack("<HHHH", 9, 9, 1, 1)  # PCX: xmax + 1 <= xmin
    return bytes(head) + b"0123456789" + bytes(range(100, 115)) + bytes(60)


def _tga_under_an_im_header():
    """A text header IM takes (a first line that is a TGA header ending in
    ': x', then an IM tag and 0x1A) that TGA would read too."""
    tga = struct.pack("<BBBHHBHHHHBB", ord("A"), 0, 3, 0, 0, 0, 0, 0, 4, 2, 8, 0x20)
    text = tga + b": x\nImage size (x*y): 4*2\nImage type: L image\n\x1a"
    return text + bytes(range(60, 60 + 128))


def test_identification_follows_image_opens_plugin_order(tmp_path):
    """The plugin order of ``Image.open``: a PCX-signed file that PCX
    declines is read as TGA (by PIL and the port, the same pixels); a file
    IM's text header takes, which TGA alone would read, is IM's (PIL opens
    it as IM, whose mode "L image" fails to load; the port names IM and
    raises IOError as PIL's load fails, never reads it as TGA); junk is no
    plugin's (ValueError)."""
    pcx_tga = _tga_under_a_pcx_signature()
    path = tmp_path / "a"
    path.write_bytes(pcx_tga)
    with Image.open(path) as im:
        assert im.format == "TGA"
        ref = np.asarray(im.convert("L"))
    assert native.plugin_of(pcx_tga) == "TGA"
    np.testing.assert_array_equal(native.decode_u8(pcx_tga), ref)
    np.testing.assert_array_equal(png.read_gray(str(path)), ref)

    im_tga = _tga_under_an_im_header()
    path.write_bytes(im_tga)
    with Image.open(path) as im:
        assert im.format == "IM"
        with pytest.raises(ValueError, match="unrecognized image mode"):
            im.convert("L")
    with Image.open(path, formats=["TGA"]) as im:
        assert im.format == "TGA"
    assert native.plugin_of(im_tga) == "IM"
    with pytest.raises(OSError) as e:
        native.decode_u8(im_tga)
    assert not isinstance(e.value, NotImplementedError)

    junk = b"\x02\x7fjunk" + bytes(200)
    path.write_bytes(junk)
    with pytest.raises(UnidentifiedImageError):
        Image.open(path)
    assert native.plugin_of(junk) == ""
    with pytest.raises(ValueError, match="no plugin of PIL's opens it"):
        native.decode_u8(junk)


SIGNATURES = [b"BM", b"(\0\0\0", b"\x0c\0\0\0", b"GIF89a", b"\xff\xd8\xff", b"P5",
              b"\x89PNG\r\n\x1a\n", b"\0\0\0\x1cftypavif", b"BLP1", b"BUFR", b"\0\0\2\0",
              b"\x0a\x05", b"\xb1\x68\xde\x3a", b"DDS ", b"%!PS", b"SIMPLE", b"FTEX",
              b"\0\0\0\x1c\0\0\0\x02", b"GRIB\0\0\0\x01", b"\x89HDF\r\n\x1a\n",
              b"\xff\x4f\xff\x51", b"icns", b"\0\0\1\0",
              b"Image type: L image\r\nName: x\r\n\x1a", b"width 4\nheight 4\npixel n8\n\x0c",
              b"\x1c\x03\x3c\x00\x02\x01\x00", b"\0\0\0\0\0\0\0\x04", b"\0\0\1\xb3", b"II*\0",
              b"DanM", b"\x80\xe8\0\0", b"8BPS", b"qoif", b"\x01\xda", b"\x59\xa6\x6a\x95",
              b"\x01\0\0\0", b"#define x_width 4\n", b"/* XPM */", b"P7 332",
              b"RIFF\0\0\0\0WEBPVP8L", b""]


def _pil_format(path):
    """PIL's ``im.format`` for a file; "" where no plugin opens it; where a
    plugin takes it and fails, "!" and the plugin (its module's name)."""
    try:
        with Image.open(path) as im:
            return im.format
    except UnidentifiedImageError:
        return ""
    except Exception as e:  # noqa: BLE001 - a plugin took the file and failed
        tb, plugin = e.__traceback__, "?"
        while tb:
            name = os.path.basename(tb.tb_frame.f_code.co_filename)
            if name.endswith("ImagePlugin.py"):
                plugin = name[:-len("ImagePlugin.py")].replace("Stub", "").upper()
            tb = tb.tb_next
        return "!" + plugin


@pytest.mark.parametrize("seed", range(4))
def test_the_plugin_that_takes_a_file_is_pils(seed, tmp_path):
    """Each signature of PIL's plugins followed by random or sparse bytes,
    some cut short: wherever PIL opens the file, the port names the same
    plugin; the port finds no plugin (ValueError) only where PIL finds
    none (where PIL's plugin passes the file on and the port's refuses it,
    the port refuses: it never reads what PIL does not)."""
    rng = np.random.default_rng(seed)
    path = tmp_path / "f"
    faults = []
    for _ in range(150):
        body = rng.integers(0, 256, int(rng.integers(0, 120))).astype(np.uint8)
        if rng.random() < 0.5:
            body *= rng.random(len(body)) < 0.3
        data = SIGNATURES[int(rng.integers(len(SIGNATURES)))] + body.tobytes()
        if rng.random() < 0.3:
            data = data[:int(rng.integers(len(data) + 1))]
        path.write_bytes(data)
        pil, port = _pil_format(path), native.plugin_of(data)
        if (pil and not pil.startswith("!") and pil != port) or (port == "" and pil != ""):
            faults.append((data[:24], pil, port))
    assert not faults, faults


# ------------------------------------------------------------------ refusals
def _pil_saved(fmt, mode="L", size=(8, 6), **kw):
    buf = io.BytesIO()
    Image.new(mode, size, 90).save(buf, fmt, **kw)
    return buf.getvalue()


def _wmf():
    head = struct.pack("<LHhhhhHLH", 0x9AC6CDD7, 0, 0, 0, 100, 80, 1440, 0, 0)
    return head + b"\x01\x00\t\x00" + bytes(40)


# a file each plugin the port does not read takes, and the word its refusal
# names it by (the plugins read since, FITS through XVThumb, are cases of
# test_torch_pillow_raw_layouts.py's FORMERLY_REFUSED; JPEG 2000, read since
# in its reversible kind, by PIL's file of the irreversible 9/7 wavelet)
REFUSED_PLUGINS = {
    "AVIF": (lambda: _pil_saved("AVIF", "RGB"), "AVIF"),
    "BUFR": (lambda: b"BUFR" + bytes(40), "BUFR"),
    "EPS": (lambda: _pil_saved("EPS"), "EPS"),
    "GRIB": (lambda: b"GRIB\0\0\0\x01" + bytes(40), "GRIB"),
    "HDF5": (lambda: b"\x89HDF\r\n\x1a\n" + bytes(40), "HDF5"),
    "JPEG2000": (lambda: _pil_saved("JPEG2000", irreversible=True), "JPEG 2000"),
    "MPEG": (lambda: b"\0\0\1\xb3\x00\x40\x30" + bytes(40), "MPEG"),
    "WMF": (_wmf, "WMF"),
}


@pytest.mark.parametrize("plugin", sorted(REFUSED_PLUGINS))
def test_every_plugin_the_port_does_not_read_is_refused_by_name(plugin, tmp_path):
    """A file PIL gives to each of its plugins the port does not read
    (PIL's own writer where it has one): PIL opens it with that plugin (or
    the plugin's open fails on it, as with EPS without Ghostscript), and
    the port names the same plugin and raises ``NotImplementedError``
    naming it, on ``decode_u8``, ``image_size`` and ``png.read_gray``."""
    make, word = REFUSED_PLUGINS[plugin]
    data = make()
    path = tmp_path / "f"
    path.write_bytes(data)
    module = {"JPEG2000": "JPEG2K", "XVThumb": "XVTHUMB"}.get(plugin, plugin)
    assert _pil_format(path) in (plugin, "!" + module)
    assert native.plugin_of(data) == plugin
    for call in (lambda: native.decode_u8(data), lambda: native.image_size(data),
                 lambda: png.read_gray(str(path))):
        with pytest.raises(NotImplementedError, match=word):
            call()
