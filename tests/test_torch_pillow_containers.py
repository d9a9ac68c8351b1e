"""PNG chunks as PIL 12.1 reads them, and the PSD, DCX, BLP, FTEX and ICNS
plugins and Pillow's own netpbm kinds (P0CMYK, PyCMYK, PyRGBA, PyP), as
the port reads them.

PIL is the oracle, opened on a path as the JAX package's reader
(``rspl_slam_tpu.datasets._load_gray``) opens it. PIL's PNG plugin checks
the CRC of each chunk before the first IDAT only (a bad one passes the file
on, and no other plugin takes it: ``UnidentifiedImageError``), reads the
image data from the run of IDAT chunks that starts at the first (a run too
short for the image: "image file is truncated"), and checks no CRC after
it; the port does the same on every route (``png.read_gray``,
``native.decode_u8``, ``native.decode_gray``, ``NativeStereoLoader``), and
inside an ICO's and an ICNS's PNG entries. Random files of each format (the
encoders of ``tests/torch_make_image_kinds.py``, over their header
options) and bit-flipped, truncated and lengthened copies of them give the
port PIL's pixels, or the exception PIL's failure maps to: PIL finding no
plugin is the port's ``ValueError``; any other failure is the port's
``NotImplementedError`` (a kind PIL refuses, named) or ``IOError``. Where
PIL opens a file, the port names the plugin PIL names.

Cases are cheap (a tenth of a second or less); the seeds make them
deterministic.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch_jpeg_probe as jp
import torch_make_image_kinds as mk
from PIL import Image
from test_torch_pillow_formats import _agrees, _img, _mutate, _pcx, _pil, _pil_format, _size

from rspl_slam_tpu import datasets as jdatasets
from rspl_slam_tpu_torch import native, png

SIG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module")
def scratch(tmp_path_factory):
    return tmp_path_factory.mktemp("pillow_containers")


# ------------------------------------------------------------------ PNG
def chunks(data: bytes) -> list:
    """A PNG's chunks as [type, body, crc] lists (bodies as stored)."""
    out, pos = [], 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        out.append([kind, data[pos + 8:pos + 8 + n], data[pos + 8 + n:pos + 12 + n]])
        pos += 12 + n
    return out


def join(parts) -> bytes:
    """A PNG of (type, body) or (type, body, crc) parts (a crc of None:
    the right one)."""
    out = bytearray(SIG)
    for kind, body, *crc in parts:
        c = crc[0] if crc and crc[0] is not None else struct.pack(">I", zlib.crc32(kind + body))
        out += struct.pack(">I", len(body)) + kind + body + c
    return bytes(out)


def _pil_png(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG", **kw)
    return buf.getvalue()


def _png(rng):
    """A PNG PIL writes (L, RGB, RGBA, P with or without transparency, LA,
    16-bit gray, bilevel, or an APNG) with its image data split over
    several IDAT chunks and ancillary chunks before and after it."""
    H, W = _size(rng, 20)
    mode = str(rng.choice(["L", "RGB", "RGBA", "P", "LA", "I;16", "1", "APNG"]))
    if mode == "APNG":
        frames = [Image.fromarray(_img(rng, H, W)) for _ in range(int(rng.integers(1, 4)))]
        data = _pil_png(frames[0], save_all=True, append_images=frames[1:],
                        default_image=bool(rng.random() < 0.3))
    else:
        a = _img(rng, H, W, {"RGB": 3, "RGBA": 4, "LA": 2}.get(mode))
        im = Image.fromarray(a.astype(np.uint16) * 257 if mode == "I;16" else a)
        im = im.convert(mode) if mode in ("P", "1") else im
        kw = {"transparency": int(rng.integers(0, 256))} if mode == "P" and rng.random() < 0.5 else {}
        data = _pil_png(im, **kw)
    parts = [c[:2] for c in chunks(data)]
    out = []
    for kind, body in parts:
        if kind == b"IDAT" and len(body) > 2 and rng.random() < 0.5:
            cut = sorted(int(c) for c in rng.integers(0, len(body), int(rng.integers(1, 4))))
            out += [(b"IDAT", body[a:b]) for a, b in zip([0] + cut, cut + [len(body)])]
            continue
        if kind in (b"IDAT", b"IEND") and rng.random() < 0.3:
            extra = [(b"tEXt", b"k\0v"), (b"gAMA", struct.pack(">I", 45455)),
                     (b"pHYs", struct.pack(">IIB", 2835, 2835, 1)), (b"zzZz", b"x")]
            out.append(extra[int(rng.integers(len(extra)))])
        out.append((kind, body))
    return join(out)


def _base_png(kind: str = "L", size=(16, 16), seed: int = 0) -> list:
    """The parts of a small PNG of the port's writer (gray or RGB) or, for
    "P", PIL's palette writer; two IDAT chunks."""
    rng = np.random.default_rng(seed)
    H, W = size
    if kind == "P":
        im = Image.fromarray(rng.integers(0, 256, (H, W, 3)).astype(np.uint8)).convert("P")
        parts = [c[:2] for c in chunks(_pil_png(im))]
    else:
        img = rng.integers(0, 256, (H, W) if kind == "L" else (H, W, 3)).astype(np.uint8)
        raw = b"".join(b"\0" + r.tobytes() for r in img.reshape(H, -1))
        parts = [(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0 if kind == "L" else 2, 0, 0, 0)),
                 (b"IDAT", zlib.compress(raw)), (b"IEND", b"")]
    idat = [i for i, p in enumerate(parts) if p[0] == b"IDAT"]
    body = b"".join(parts[i][1] for i in idat)
    half = len(body) // 2
    rest = [p for p in parts if p[0] != b"IDAT"]
    at = idat[0]
    return rest[:at] + [(b"IDAT", body[:half]), (b"IDAT", body[half:])] + rest[at:]


def _bad_crc(parts, kind):
    i = next(i for i, p in enumerate(parts) if p[0] == kind)
    out = [list(p) for p in parts]
    good = zlib.crc32(out[i][0] + out[i][1])
    out[i] = [out[i][0], out[i][1], struct.pack(">I", good ^ 0x10)]
    return out


def _apng_tile(rng):
    """An APNG whose first frame (fcTL before IDAT) is a 6 × 5 tile at (3, 2)
    of a 16 × 12 image: PIL reads the tile into zeros."""
    tile = rng.integers(0, 256, (5, 6)).astype(np.uint8)
    raw = b"".join(b"\0" + r.tobytes() for r in tile)
    fctl = struct.pack(">IIIIIHHBB", 0, 6, 5, 3, 2, 1, 10, 0, 0)
    return [(b"IHDR", struct.pack(">IIBBBBB", 16, 12, 8, 0, 0, 0, 0)),
            (b"acTL", struct.pack(">II", 1, 0)), (b"fcTL", fctl),
            (b"IDAT", zlib.compress(raw)), (b"IEND", b"")]


def _png_cases():
    """name → (PNG bytes, PIL's outcome: "ok", "value" (no plugin) or "error")."""
    rng = np.random.default_rng(7)
    gray, pal = _base_png("L"), _base_png("P", seed=1)
    text = [p for p in gray if p[0] == b"IHDR"] + [(b"tEXt", b"Comment\0hi")] + \
        [p for p in gray if p[0] != b"IHDR"]
    idat = [i for i, p in enumerate(gray) if p[0] == b"IDAT"]
    split = gray[:idat[0] + 1] + [(b"tEXt", b"k\0v")] + gray[idat[0] + 1:]
    short = gray[:idat[0] + 1] + gray[idat[1] + 1:]
    body = zlib.compress(b"".join(b"\0" + bytes(range(16)) for _ in range(16)))
    cut = [gray[0], (b"IDAT", body[:len(body) - 9]), (b"IEND", b"")]
    frames = [Image.fromarray(rng.integers(0, 256, (16, 16)).astype(np.uint8)) for _ in range(3)]
    return {
        "crc_ihdr": (join(_bad_crc(gray, b"IHDR")), "value"),
        "crc_plte": (join(_bad_crc(pal, b"PLTE")), "value"),
        "crc_text_before_idat": (join(_bad_crc(text, b"tEXt")), "value"),
        "crc_idat": (join(_bad_crc(gray, b"IDAT")), "ok"),
        "crc_second_idat": (join([list(p) for p in gray[:idat[1]]] + [
            [b"IDAT", gray[idat[1]][1], b"\0\0\0\0"]] + [list(p) for p in gray[idat[1] + 1:]]), "ok"),
        "crc_iend": (join(_bad_crc(gray, b"IEND")), "ok"),
        "idat_split_by_text": (join(split), "error"),
        "idat_run_cut_short": (join(short), "error"),
        "zlib_stream_cut_short": (join(cut), "error"),
        "apng_frame0": (_pil_png(frames[0], save_all=True, append_images=frames[1:]), "ok"),
        "apng_default_image": (_pil_png(frames[0], save_all=True, append_images=frames[1:],
                                        default_image=True), "ok"),
        "apng_frame0_tile": (join(_apng_tile(rng)), "ok"),
    }


PNG_CASES = _png_cases()


def _outcome(call):
    try:
        return "ok", call()
    except NotImplementedError as e:
        return "refused", e
    except ValueError as e:
        return "value", e
    except OSError as e:
        return "error", e


def _every_route(path: str, data: bytes, H: int, W: int) -> dict:
    """The outcome of each route of the port's reader on one file, as
    (H, W) uint8 where it reads."""
    def loader():
        with native.NativeStereoLoader([path], [path], H, W) as it:
            (_, left, _), = list(it)
        return np.round(left * 255).astype(np.uint8)

    return {"read_gray": _outcome(lambda: png.read_gray(path)),
            "decode_u8": _outcome(lambda: native.decode_u8(data)),
            "decode_gray": _outcome(
                lambda: np.round(native.decode_gray(path, H, W) * 255).astype(np.uint8)),
            "loader": _outcome(loader)}


def _check_routes(path, data, want):
    """PIL's outcome is ``want``; every route gives PIL's pixels (and JAX's
    reader's), or the exception class its failure maps to."""
    pil = _pil(path)
    assert pil[0] == want, pil
    H, W = pil[1].shape if pil[0] == "ok" else (16, 16)
    ref = jdatasets._load_gray(path) if pil[0] == "ok" else None
    for route, (kind, got) in _every_route(path, data, H, W).items():
        if pil[0] == "ok":
            assert kind == "ok", (route, got)
            np.testing.assert_array_equal(got, pil[1], err_msg=route)
            np.testing.assert_array_equal(got.astype(np.float32) / 255.0, ref, err_msg=route)
        elif pil[0] == "value":
            assert kind == "value", (route, kind, got)
        else:
            assert kind in ("error", "refused"), (route, kind, got)


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_png_chunks_read_as_pil_on_every_route(case, tmp_path):
    """A bad CRC before the first IDAT (IHDR, PLTE, an ancillary chunk)
    passes the file on (no plugin then: ``ValueError``); a bad CRC on an
    IDAT or on IEND reads PIL's pixels; image data split by another chunk,
    or a run of IDATs or a zlib stream too short for the image, raises
    ``IOError``; an APNG reads its frame 0 (the default image, or the first
    fcTL's tile into zeros); on every route."""
    data, want = PNG_CASES[case]
    path = tmp_path / "f.png"
    path.write_bytes(data)
    _check_routes(str(path), data, want)


def _in_ico(data: bytes) -> bytes:
    return mk.encode_ico([data], dims=[(16, 16, 0, 32)])


def _in_icns(data: bytes) -> bytes:
    return mk.encode_icns([(b"icp4", data)])


# PIL's outcome for each case inside an ICO (whose open loads its PNG entry:
# an error of the pass-on kinds passes the ICO on) and an ICNS (which loads
# the entry after the open: every error raises)
CONTAINED = {"ok": ("ok", "ok"), "value": ("value", "error"), "error": ("error", "error")}


@pytest.mark.parametrize("container", ["ico", "icns"])
@pytest.mark.parametrize("case", sorted(c for c in PNG_CASES if not c.startswith("apng")))
def test_png_entries_of_ico_and_icns_read_as_pil(case, container, tmp_path):
    """The same PNG cases as an ICO's and an ICNS's only entry: the bad
    CRCs after the first IDAT read, the split and short data raise, and a
    bad CRC before it passes an ICO on but raises in an ICNS (whose entry
    PIL opens while it loads); on every route."""
    data, want = PNG_CASES[case]
    wrapped = (_in_ico if container == "ico" else _in_icns)(data)
    path = tmp_path / f"f.{container}"
    path.write_bytes(wrapped)
    _check_routes(str(path), wrapped, CONTAINED[want][container == "icns"])


# ------------------------------------------------------------- generators
def _jpeg(rng, H, W):
    mode = str(rng.choice(["L", "RGB", "CMYK"]))
    a = _img(rng, H, W, {"L": None, "RGB": 3, "CMYK": 4}[mode])
    buf = io.BytesIO()
    Image.fromarray(a, mode).save(buf, "JPEG", quality=int(rng.integers(50, 95)))
    return buf.getvalue()


def _psd(rng):
    H, W = _size(rng, 14)
    kind = int(rng.integers(6))
    layers = None
    if rng.random() < 0.4:
        layers = rng.integers(0, 256, int(rng.integers(0, 40))).astype(np.uint8).tobytes()
    res = b""
    if rng.random() < 0.4:
        res = mk.psd_resource(int(rng.integers(1000, 1100)),
                              rng.integers(0, 256, int(rng.integers(0, 9))).astype(np.uint8)
                              .tobytes(), b"ab"[:int(rng.integers(0, 3))])
    kw = dict(compression=int(rng.choice([0, 1, 1, 0, 2])), layers=layers, resources=res)
    if kind == 0:
        return mk.encode_psd(_img(rng, H, W, hi=2), 0, 1, **kw)
    if kind == 1:
        return mk.encode_psd(_img(rng, H, W), int(rng.choice([0, 1, 7, 8])), 8, **kw)
    if kind == 2:
        pal = rng.integers(0, 256, (256, 3)) if rng.random() < 0.8 else None
        return mk.encode_psd(_img(rng, H, W), 2, 8, palette=pal, **kw)
    if kind == 3:
        return mk.encode_psd(_img(rng, H, W, int(rng.choice([3, 4]))), 3, 8, **kw)
    if kind == 4:
        return mk.encode_psd(_img(rng, H, W, 4), 4, 8, **kw)
    return mk.encode_psd(_img(rng, H, W, 3), 9, 8, **kw)


def _dcx(rng):
    return mk.encode_dcx([_pcx(rng) for _ in range(int(rng.integers(1, 3)))])


def _blp(rng):
    H, W = _size(rng, 14)
    r, alpha = rng.random(), int(rng.choice([0, 1, 4, 8]))
    if r < 0.25:  # BLP1 JPEG, its header split off at a random point
        j = _jpeg(rng, H, W)
        k = int(rng.integers(0, len(j)))
        return mk.encode_blp(1, W, H, j[k:], compression=0, alpha=alpha, jpeg_header=j[:k])
    pal = rng.integers(0, 256, (256, 4))
    if r < 0.45:
        return mk.encode_blp(1, W, H, _img(rng, H, W).tobytes(), compression=1,
                             encoding=int(rng.choice([4, 5])), alpha=alpha, palette=pal)
    if r < 0.6:
        return mk.encode_blp(2, W, H, _img(rng, H, W).tobytes(), encoding=1, alpha=alpha,
                             palette=pal)
    if r < 0.65:  # a kind PIL refuses (BLPFormatError)
        return mk.encode_blp(2, W, H, bytes(64), encoding=int(rng.choice([2, 3])), alpha=alpha,
                             alpha_encoding=int(rng.choice([2, 5, 8])))
    kind = int(rng.choice([1, 3, 5]))
    nb = ((W + 3) // 4) * ((H + 3) // 4)
    blocks = rng.integers(0, 256, nb * (8 if kind == 1 else 16)).astype(np.uint8)
    if rng.random() < 0.5:  # encoded blocks, not noise
        rgba = _img(rng, H, W, 4)
        blocks = np.frombuffer(mk.dxt_blocks(rgba, kind), np.uint8)
    return mk.encode_blp(2, W, H, blocks.tobytes(), encoding=2, alpha=alpha,
                         alpha_encoding={1: 0, 3: 1, 5: 7}[kind])


def _ftex(rng):
    H, W = _size(rng, 14)
    if rng.random() < 0.6:
        nb = ((W + 3) // 4) * ((H + 3) // 4)
        return mk.encode_ftex(W, H, rng.integers(0, 256, nb * 8).astype(np.uint8).tobytes(), 0)
    return mk.encode_ftex(W, H, _img(rng, H, W, 3).tobytes(), 1)


ICNS_RGB = [(b"is32", b"s8mk", 16), (b"il32", b"l8mk", 32), (b"ih32", b"h8mk", 48)]
ICNS_PNG = [(b"icp4", 16), (b"ic11", 32), (b"icp5", 32), (b"ic12", 64), (b"icp6", 64)]


def _icns(rng):
    blocks = []
    for _ in range(int(rng.integers(1, 4))):
        t = rng.random()
        if t < 0.45:
            typ, mask, s = ICNS_RGB[int(rng.integers(len(ICNS_RGB)))]
            blocks.append((typ, mk.icns_rgb(_img(rng, s, s, 3), rle=rng.random() < 0.8)))
            if rng.random() < 0.6:
                blocks.append((mask, _img(rng, s, s).tobytes()))
        elif t < 0.5:
            blocks.append((b"it32", b"\0\0\0\0" + mk.icns_rgb(_img(rng, 128, 128, 3) // 64 * 64)))
        else:
            typ, s = ICNS_PNG[int(rng.integers(len(ICNS_PNG)))]
            s = s if rng.random() < 0.9 else int(rng.integers(1, 70))  # a size the slot may refuse
            mode = str(rng.choice(["L", "RGB", "RGBA", "P"]))
            im = Image.fromarray(_img(rng, s, s, {"RGB": 3, "RGBA": 4}.get(mode)))
            blocks.append((typ, _pil_png(im.convert("P") if mode == "P" else im)))
    return mk.encode_icns(blocks)


def _pnm(rng):
    H, W = _size(rng, 10)
    magic = [b"P0CMYK", b"PyCMYK", b"PyRGBA", b"PyP"][int(rng.integers(4))]
    maxval = int(rng.choice([255, 255, 100, 1000, 65535, 1]))
    hi = maxval + 1 if rng.random() < 0.9 else 65536  # samples past maxval too
    px = rng.integers(0, hi, (H, W) if magic == b"PyP" else (H, W, 4))
    return mk.encode_pillow_pnm(magic, px, maxval)


GENERATORS = {"png": _png, "psd": _psd, "dcx": _dcx, "blp": _blp, "ftex": _ftex,
              "icns": _icns, "pnm": _pnm}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fmt", sorted(GENERATORS))
def test_random_and_corrupted_files_agree_with_pil(fmt, seed, scratch):
    """Eight random files of the format over its header options, each with
    six corrupted copies: the port gives PIL's pixels or the exception
    class PIL's failure maps to, and names the plugin PIL opens it with."""
    rng = np.random.default_rng([seed, sorted(GENERATORS).index(fmt), 21])
    path = str(scratch / f"{fmt}_{seed}")
    faults = []
    for i in range(8):
        data = GENERATORS[fmt](rng)
        for j, d in enumerate([data] + [_mutate(rng, d) for d in [data] * 6]):
            fault = _agrees(path, d)
            if fault is None:
                pil = _pil_format(path)
                if pil and not pil.startswith("!") and native.plugin_of(d) != pil:
                    fault = f"PIL's plugin {pil}; the port's {native.plugin_of(d)}"
            if fault:
                faults.append(f"file {i}, copy {j}: {fault}")
    assert not faults, faults


# ------------------------------------------------------- the plugins read now
def _pil_saved(fmt, mode="L", size=(8, 6), **kw):
    buf = io.BytesIO()
    Image.new(mode, size, 90).save(buf, fmt, **kw)
    return buf.getvalue()


def _icns_j2k():
    buf = io.BytesIO()
    Image.fromarray(mk.scene(32, 32, 3, 3)).save(buf, "JPEG2000", no_jp2=True)
    return mk.encode_icns([(b"is32", mk.icns_rgb(mk.scene(16, 16, 4, 3))),
                           (b"ic11", buf.getvalue())])


# the files the refusal test gave these plugins while the port refused them
# (the same bytes), and an ICNS whose best size is a JPEG 2000 codestream
FORMERLY_REFUSED = {
    "BLP": lambda: _pil_saved("BLP", "P"),
    "DCX": lambda: struct.pack("<II", 0x3ADE68B1, 12) + bytes(4) + _pil_saved("PCX"),
    "FTEX": lambda: (b"FTEX" + struct.pack("<IIIII", 0, 4, 4, 1, 1) + bytes(8)
                     + struct.pack("<II", 1, 0) + struct.pack("<II", 0, 64) + bytes(64)),
    "ICNS": lambda: _pil_saved("ICNS", "RGB", (16, 16)),
    "PSD": lambda: (b"8BPS" + struct.pack(">H6xHIIHH", 1, 1, 3, 4, 8, 1) + bytes(14)
                    + bytes(12)),
    "ICNS of JPEG 2000": _icns_j2k,
}


@pytest.mark.parametrize("plugin", sorted(FORMERLY_REFUSED))
def test_plugins_refused_before_now_read_as_pil(plugin, tmp_path):
    """A file PIL gives to each of these plugins (PIL's own writer where it
    has one), which the port refused by name until it read them: PIL opens
    it with the plugin, the port names the same plugin and gives PIL's
    pixels on ``decode_u8``, ``image_size`` and ``png.read_gray`` (an ICNS
    whose best size is JPEG 2000 too, since the port reads JPEG 2000)."""
    data = FORMERLY_REFUSED[plugin]()
    path = tmp_path / "f"
    path.write_bytes(data)
    name = plugin.split()[0]
    with Image.open(path) as im:
        assert im.format == name
        ref = np.asarray(im.convert("L"))
    assert native.plugin_of(data) == name
    assert native.image_size(data) == ref.shape
    np.testing.assert_array_equal(native.decode_u8(data), ref)
    np.testing.assert_array_equal(png.read_gray(str(path)), ref)


# ---------------------------------------------- the JPEG inside a BLP file
def _pil_jpeg(array, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _jpeg_cases():
    """name → (JPEG bytes, PIL's outcome): how PIL (libjpeg-turbo behind
    Pillow's suspending source) reads a stream's end and damaged data."""
    g = mk.scene(24, 32, 5)
    base, prog = _pil_jpeg(g, quality=90), _pil_jpeg(g, quality=90, progressive=True)
    sos = base.index(b"\xff\xda")
    data = sos + 2 + struct.unpack(">H", base[sos + 2:sos + 4])[0]
    # sixteen 1 bits, a code no table of PIL's writer has
    bad_code = base[:data + 6] + b"\xff\x00\xff\x00" + base[data + 6:]
    # one bit flipped in the scan of a 16 × 16 gray file: a code no table has
    # (decoded as 0), and coefficients out of range (through the SIMD IDCT)
    flipped = [bytearray(_pil_jpeg(mk.scene(16, 16, s), quality=q)) for s, q in ((0, 100), (0, 95))]
    flipped[0][437] ^= 1
    flipped[1][353] ^= 1
    cases = {
        "progressive_without_eoi": (prog[:-2], "error"),
        "baseline_cut_in_its_scan": (base[:data + (len(base) - data) // 2], "error"),
        "baseline_eoi_turned_into_rst1": (base[:-1] + b"\xd1", "ok"),
        "baseline_without_eoi_then_16_bytes": (base[:-2] + bytes(range(1, 17)), "ok"),
        "baseline_a_code_no_table_has": (bad_code, "ok"),
        "baseline_flipped_scan_bit": (bytes(flipped[0]), "ok"),
        "baseline_flipped_scan_bit_2": (bytes(flipped[1]), "ok"),
    }
    ends = jp.ends_files()
    for i, counts in PROBE_ENDS.items():
        for k, want in zip(counts, ("error", "ok")):
            cases[f"probe_ends_{i}_{k}_bytes"] = (jp.cut(ends[i][1], k), want)
    mutated = jp.mutated_files()
    for i, want in PROBE_MUTATED.items():
        cases[f"probe_mutation_{i}"] = (mutated[i], want)
    coded = jp.coded_files()
    for i, want in PROBE_CODED.items():
        cases[f"probe_coded_{i}_{coded[i][0].replace(' ', '_')}"] = (coded[i][1], want)
    # an arithmetic scan past Pillow's first 65,536-byte read: jdarith.c
    # cannot suspend, so PIL fails on it
    noisy = np.clip(mk.scene(240, 400, 1).astype(np.int64)
                    + np.random.default_rng(0).integers(-60, 60, (240, 400)), 0, 255)
    big = mk.encode_jpeg([noisy.astype(np.uint8)], arith=True, quality=97)
    assert len(big) > 65536
    cases["arithmetic_past_the_first_read"] = (big, "error")
    return cases


# the files of tests/torch_jpeg_probe.py whose outcome the port did not share
# with PIL's: three of its "ends" files, each without EOI at the last count
# of bytes PIL still raises at and the first it reads at (libjpeg's fast
# path, file 57; its slow path's fills one bit at a time, 25 and 37), and 25
# of its "mutations" files with PIL's outcome (libjpeg leaving the MCUs of a
# segment whose data ran out as zeros; its marker reader's errors; Huffman
# tables looked up only where a scan uses them, and no default ones in a
# progressive scan; a sample depth PIL's open refuses, "value")
PROBE_ENDS = {25: (0, 1), 37: (3, 4), 57: (0, 1)}
PROBE_MUTATED = {
    36: "ok", 54: "ok", 64: "value", 292: "value", 298: "error", 368: "value", 380: "error",
    410: "ok", 421: "ok", 454: "error", 510: "ok", 517: "ok", 562: "ok", 670: "ok", 697: "ok",
    705: "error", 725: "error", 751: "error", 832: "error", 915: "ok", 1002: "error",
    1012: "error", 1031: "ok", 1039: "ok", 1042: "ok"}
# and of its "coded" files (JPEGs PIL cannot write): arithmetic scans whose
# bad codes stop the segment and whose restarts resync as libjpeg does,
# lossless scans whose rows after the data ran out keep zero differences,
# and files the marker reader and table rules repaired
PROBE_CODED = {28: "error", 94: "error", 100: "error", 108: "error", 112: "ok", 168: "ok",
               181: "ok", 207: "ok", 234: "error", 281: "ok", 289: "ok", 291: "ok",
               331: "error", 334: "ok", 335: "ok", 391: "ok", 392: "ok", 404: "ok",
               416: "error"}
JPEG_CASES = _jpeg_cases()


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_data_ends_and_damage_read_as_pil(case, tmp_path):
    """What a BLP1's JPEG (and any JPEG) does where its data ends or is
    damaged: a progressive stream must reach EOI, a one-scan stream must
    not run out inside its scan (libjpeg fills 57 bits ahead, or to a
    marker, and 6 bytes at a time on its fast path); a code no table has
    decodes as 0; coefficients out of range go through the SIMD IDCT's
    16-bit lanes; the probe's files: PIL's outcome first, then PIL's pixels
    or its failure's class on ``png.read_gray`` and ``native.decode_u8``,
    and where PIL's open refuses the frame's sample depth (no plugin then:
    "value") the port's refusal naming it."""
    data, want = JPEG_CASES[case]
    path = tmp_path / "f.jpg"
    path.write_bytes(data)
    pil = _pil(str(path))
    assert pil[0] == want, pil
    for route in (lambda: png.read_gray(str(path)), lambda: native.decode_u8(data)):
        kind, got = _outcome(route)
        if want == "ok":
            assert kind == "ok", got
            np.testing.assert_array_equal(got, pil[1])
        elif want == "value":
            assert kind == "refused" and "not 8-bit" in str(got), (kind, got)
        else:
            assert kind == "error", got


def test_container_fixtures_regenerate_byte_for_byte():
    """The PSD, DCX, BLP, FTEX, ICNS and Pillow netpbm fixtures are what
    ``torch_make_image_kinds.container_files`` writes, byte for byte."""
    import os

    root = os.path.join(os.path.dirname(__file__), "fixtures", "image_kinds")
    for name, (data, *_) in mk.container_files(0).items():
        with open(os.path.join(root, name), "rb") as f:
            assert f.read() == data, name
