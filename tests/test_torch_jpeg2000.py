"""JPEG 2000 (ISO/IEC 15444-1, reversible: the 5/3 wavelet and the RCT) as
PIL 12.1 reads it through its bundled OpenJPEG 2.5.4, held to PIL byte for
byte: the port's ``csrc/native_j2k.h`` through ``native.decode_u8``,
``png.read_gray``, ``NativeStereoLoader`` and ``EurocDataset``.

PIL is the oracle, opened on a file's path as JAX's ``_load_gray`` opens
it: every file gives PIL's ``convert("L")`` bit for bit, or raises what
PIL's failure maps to (no plugin opens it: ``ValueError``; any other
failure, OpenJPEG's "broken data stream" included: ``IOError``). A file of
a kind the port refuses by design (the 9/7 wavelet and its ICT, HT
code-blocks, Part 2 markers) raises ``NotImplementedError`` naming its
ROADMAP item.

- the three fixtures (codestream, JP2, an ICNS whose best size is a
  codestream) on every route, and the 752×480 rate-20 sequence through
  both datasets;
- a seeded corpus written by PIL: sizes 1 to 70, image and tile offsets,
  tile sizes, 1 to 6 resolutions, code-block and precinct sizes, the five
  progressions, one to three quality layers at rates, ``mct`` 0 and 1, L,
  LA, RGB, RGBA and I;16, signed and unsigned, J2K and JP2, PLT markers
  and comments;
- damaged copies of it: bit flips in the headers and in the packet data,
  cuts anywhere and at the end;
- packet headers moved into PPT and PPM markers;
- a seeded corpus written by OpenJPEG's own encoder through ctypes
  (``torch_j2k_probe.openjpeg_encode``) for what PIL's cannot write: the
  code-block style bits (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM),
  SOP and EPH markers, POCs, tile-parts, RGN, precinct sizes per
  resolution, subsampled components, 1 to 16 bits signed and unsigned,
  and damaged copies;
- JP2 colour boxes and image headers against Pillow's choice of unpacker;
- the open's pass-on (a file PIL's ``_open`` rejects goes on, here to no
  plugin), and the refusals by name.
"""

import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from rspl_slam_tpu import datasets as jdatasets
from rspl_slam_tpu_torch import datasets as tdatasets
from rspl_slam_tpu_torch import native, png

DIR = os.path.join(os.path.dirname(__file__), "fixtures", "image_kinds")
PROGRESSIONS = ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]


def _pil(path):
    try:
        with Image.open(path) as im:
            return "ok", np.asarray(im.convert("L"))
    except Exception as e:  # noqa: BLE001 - OpenJPEG's failures come as OSError, others as they are
        return ("value" if type(e).__name__ == "UnidentifiedImageError" else "error"), e


def _port(route):
    try:
        return "ok", route()
    except NotImplementedError as e:
        return "refused", e
    except ValueError as e:
        return "value", e
    except OSError as e:
        return "error", e


def _outcome(data: bytes, path) -> tuple:
    """(PIL's outcome, the port's on decode_u8 and read_gray): "" where
    they agree, "refused" where the port refuses by design, else the
    fault."""
    path.write_bytes(data)
    a = _pil(str(path))
    for name, route in (("decode_u8", lambda: native.decode_u8(data)),
                        ("read_gray", lambda: png.read_gray(str(path)))):
        b = _port(route)
        if b[0] == "refused":
            assert "ROADMAP" in str(b[1]) and "JPEG 2000" in str(b[1]), b[1]
            return a[0], "refused"
        if a[0] == "ok":
            if b[0] != "ok" or not np.array_equal(a[1], b[1]):
                return a[0], f"{name}: PIL reads {a[1].shape}; the port: {b[0]} " \
                             f"{b[1] if b[0] != 'ok' else 'other pixels'}"
        elif a[0] != b[0]:
            return a[0], f"{name}: PIL {a[0]} ({a[1]}); the port: {b[0]} {b[1] if b[0] != 'ok' else ''}"
    return a[0], ""


# ------------------------------------------------------------ fixtures
@pytest.mark.parametrize("name", ["j2k.j2k", "jp2.jp2", "icns_jp2.icns"])
def test_fixtures_read_as_pil_on_every_route(name, tmp_path):
    """The codestream, the JP2 file and the ICNS whose best size is a
    codestream: PIL's pixels (JAX's ``_load_gray``) through ``decode_u8``,
    ``read_gray``, ``decode_gray``, the loader, and both ``EurocDataset``s
    over a tree of the file."""
    path = os.path.join(DIR, name)
    ref = jdatasets._load_gray(path)
    with open(path, "rb") as f:
        data = f.read()
    u8 = native.decode_u8(data)
    np.testing.assert_array_equal(u8.astype(np.float32) / 255.0, ref)
    np.testing.assert_array_equal(png.read_gray(path), u8)
    H, W = u8.shape
    np.testing.assert_array_equal(native.decode_gray(path, H, W), ref)
    for cam in ("cam0", "cam1"):
        os.makedirs(tmp_path / cam / "data")
        for i in range(2):
            (tmp_path / cam / "data" / f"{1_000_000_000 + i}{os.path.splitext(name)[1]}").write_bytes(data)
    jds, tds = jdatasets.EurocDataset(str(tmp_path)), tdatasets.EurocDataset(str(tmp_path))
    assert len(tds) == len(jds) == 2
    with native.NativeStereoLoader(*tds.file_lists(), H, W) as loader:
        for i, left, right in loader:
            np.testing.assert_array_equal(left, ref)
            np.testing.assert_array_equal(right, ref)
            np.testing.assert_array_equal(tds[i].image_left, jds[i].image_left)


def test_rate_20_sequence_reads_as_pil_through_both_datasets():
    """The 752×480 sequence as reversible codestreams at rate 20 (one
    quality layer: most code-blocks lose their lower bit-planes, which
    OpenJPEG rebuilds at the half step): both datasets and the loader give
    JAX's frames."""
    root = os.path.join(DIR, "seq_j2k")
    jds, tds = jdatasets.EurocDataset(root), tdatasets.EurocDataset(root)
    assert len(jds) == len(tds) == 6
    with native.NativeStereoLoader(*tds.file_lists(), 480, 752, threads=3) as loader:
        for i, left, right in loader:
            np.testing.assert_array_equal(left, jds[i].image_left)
            np.testing.assert_array_equal(right, jds[i].image_right)


# ------------------------------------------------------------- corpus
def _image(rng):
    W, H = int(rng.integers(1, 71)), int(rng.integers(1, 71))
    mode = str(rng.choice(["L", "LA", "RGB", "RGBA", "I;16"]))
    nb = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}[mode]
    if mode == "I;16":
        arr = rng.integers(0, 1 << int(rng.choice([9, 12, 16])), (H, W)).astype(np.uint16)
        return Image.fromarray(arr), mode, W, H
    if rng.random() < 0.5:
        base = rng.integers(0, 256, (H, W, nb))
    else:
        base = (np.add.outer(np.arange(H), np.arange(W))[..., None] * int(rng.integers(1, 8))
                + rng.integers(0, 30, (H, W, nb)))
    arr = np.clip(base, 0, 255).astype(np.uint8)
    return Image.fromarray(arr[..., 0] if nb == 1 else arr, mode), mode, W, H


def _options(rng, mode, W, H) -> dict:
    """PIL's encoder options at random. PIL's encoder crashes where an
    image offset reaches past the image, so offsets stay inside it."""
    kw = {}
    if rng.random() < 0.3:
        kw["offset"] = (int(rng.integers(0, 9)), int(rng.integers(0, 9)))
    if rng.random() < 0.3:
        kw["tile_size"] = (int(rng.integers(8, 40)), int(rng.integers(8, 40)))
        if rng.random() < 0.5 and "offset" in kw:
            kw["tile_offset"] = (int(rng.integers(0, kw["offset"][0] + 1)),
                                 int(rng.integers(0, kw["offset"][1] + 1)))
    kw["num_resolutions"] = int(rng.integers(1, 7))
    if "offset" in kw and (kw["offset"][0] >= W or kw["offset"][1] >= H):
        del kw["offset"]
        kw.pop("tile_offset", None)
    if rng.random() < 0.4:
        kw["codeblock_size"] = (int(2 ** rng.integers(2, 7)), int(2 ** rng.integers(2, 7)))
    if rng.random() < 0.4:
        kw["precinct_size"] = (int(2 ** rng.integers(2, 8)), int(2 ** rng.integers(2, 8)))
    kw["progression"] = str(rng.choice(PROGRESSIONS))
    if rng.random() < 0.5:
        kw["quality_mode"] = "rates"
        kw["quality_layers"] = sorted((float(rng.uniform(2, 60)) for _ in range(int(rng.integers(1, 4)))),
                                      reverse=True)
    if mode in ("RGB", "RGBA") and rng.random() < 0.5:
        kw["mct"] = 1
    if rng.random() < 0.2:
        kw["signed"] = True
    if rng.random() < 0.2:
        kw["plt"] = True
    if rng.random() < 0.2:
        kw["comment"] = "c%d" % int(rng.integers(1000))
    kw["no_jp2"] = bool(rng.random() < 0.5)
    return kw


def corpus(seed: int, attempts: int) -> list:
    """The files PIL's encoder writes of ``attempts`` random draws (it
    refuses some, such as more resolutions than the size allows)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(attempts):
        im, mode, W, H = _image(rng)
        kw = _options(rng, mode, W, H)
        buf = io.BytesIO()
        try:
            im.save(buf, "JPEG2000", **kw)
        except (OSError, ValueError):
            continue
        out.append(buf.getvalue())
    return out


def damaged(rng, data: bytes, k: int) -> list:
    """``k`` damaged copies of a file: one bit flipped in the headers (up to
    the first SOT) or in the packet data, or the file cut anywhere or one
    to three bytes before its end."""
    out = []
    sot = data.find(b"\xff\x90")
    for _ in range(k):
        d = bytearray(data)
        r = rng.random()
        if r < 0.3 and sot > 0:
            i = int(rng.integers(0, sot))
            d[i] ^= 1 << int(rng.integers(8))
        elif r < 0.7:
            i = int(rng.integers(max(sot, 0), len(d)))
            d[i] ^= 1 << int(rng.integers(8))
        elif r < 0.85:
            d = d[:int(rng.integers(1, len(d)))]
        else:
            d = d[:len(d) - int(rng.integers(1, 4))]
        out.append(bytes(d))
    return out


# seed → (PIL-written files of 90 draws, damaged copies PIL reads, PIL
# fails, the port refuses by design)
CORPUS_COUNTS = {1: (55, 210, 230, 0), 2: (54, 223, 209, 0), 3: (55, 200, 239, 1)}


@pytest.mark.parametrize("seed", sorted(CORPUS_COUNTS))
def test_random_pil_written_files_match_pil(seed, tmp_path):
    """The seeded corpus and 8 damaged copies of each: PIL's outcome every
    time (0 disagreements); a damaged copy the port refuses (a flip that
    made the 9/7 wavelet or HT code-blocks of a header) names JPEG 2000 and
    its ROADMAP item. The counts of files, and of outcomes, are stated."""
    files = corpus(seed, 90)
    rng = np.random.default_rng(seed + 1000)
    faults, counts = [], {"ok": 0, "error": 0, "refused": 0}
    path = tmp_path / "f"
    for i, data in enumerate(files):
        pil, fault = _outcome(data, path)
        assert pil == "ok" and fault == "", (i, fault)
        for j, d in enumerate(damaged(rng, data, 8)):
            pil, fault = _outcome(d, path)
            if fault == "refused":
                counts["refused"] += 1
            elif fault:
                faults.append((i, j, fault))
            else:
                counts["ok" if pil == "ok" else "error"] += 1
    assert not faults, faults[:5]
    assert (len(files), counts["ok"], counts["error"], counts["refused"]) == CORPUS_COUNTS[seed]


def _openjpeg_file(lib, rng, path):
    """One random codestream of OpenJPEG's encoder (its options as
    ``openjpeg_encode`` takes them); False where the encoder refuses."""
    import torch_j2k_probe as probe

    nc = int(rng.choice([1, 1, 2, 3, 3, 4]))
    W, H = int(rng.integers(1, 49)), int(rng.integers(1, 49))
    prec = int(rng.choice([1, 4, 8, 8, 8, 10, 12, 16]))
    sgnd = bool(rng.random() < 0.2)
    off = (int(rng.integers(0, 6)), int(rng.integers(0, 6))) if rng.random() < 0.3 else (0, 0)
    dx, dy = [1] * nc, [1] * nc
    if rng.random() < 0.3:
        for k in range(nc):
            if rng.random() < 0.5:
                dx[k], dy[k] = int(rng.integers(1, 3)), int(rng.integers(1, 3))
    lo, hi = (-(1 << (prec - 1)), 1 << (prec - 1)) if sgnd else (0, 1 << prec)
    planes = []
    for k in range(nc):
        x0, y0 = -(-off[0] // dx[k]), -(-off[1] // dy[k])
        w, h = -(-(off[0] + W) // dx[k]) - x0, -(-(off[1] + H) // dy[k]) - y0
        if rng.random() < 0.5:
            planes.append(rng.integers(lo, hi, (h, w)))
        else:
            ramp = np.add.outer(np.arange(h), np.arange(w)) * int(rng.integers(1, 5))
            planes.append(np.clip(ramp + rng.integers(0, 8, (h, w)) + lo, lo, hi - 1))
    kw = dict(size=(W, H), prec=prec, sgnd=sgnd, dx=dx, dy=dy, offset=off,
              resolutions=int(rng.integers(1, 5)),
              cblk=(int(2 ** rng.integers(2, 7)), int(2 ** rng.integers(2, 7))),
              prog=int(rng.integers(0, 5)), mode=int(rng.integers(0, 64)) if rng.random() < 0.7 else 0,
              sop_eph=int(rng.choice([0, 2, 4, 6])), mct=int(nc >= 3 and rng.random() < 0.5))
    while kw["cblk"][0] * kw["cblk"][1] > 4096:
        kw["cblk"] = (kw["cblk"][0] // 2, kw["cblk"][1])
    if rng.random() < 0.4:
        kw["layers"] = tuple(sorted((float(rng.uniform(2, 40)) for _ in range(int(rng.integers(1, 4)))),
                                    reverse=True))
    if rng.random() < 0.3:
        kw["tile"] = (int(rng.integers(8, 33)), int(rng.integers(8, 33)))
        if rng.random() < 0.5:
            kw["tile_parts"] = str(rng.choice(["R", "L", "C"]))
    if rng.random() < 0.2:
        kw["roi"] = (int(rng.integers(0, nc)), int(rng.integers(0, 12)))
    if rng.random() < 0.3:
        kw["precincts"] = [(int(rng.integers(4, 8)), int(rng.integers(4, 8)))
                           for _ in range(int(rng.integers(1, 4)))]
    if rng.random() < 0.2:
        R = kw["resolutions"]
        kw["pocs"] = [(0, 0, 1, max(1, R // 2), nc, int(rng.integers(0, 5))),
                      (max(1, R // 2) if R > 1 else 0, 0, 1, R, nc, int(rng.integers(0, 5)))]
    return probe.openjpeg_encode(lib, planes, str(path), **kw)


# seed → (OpenJPEG-written files of 60 draws, of them PIL reads; damaged
# copies PIL reads, fails, identifies as nothing, the port refuses by
# design)
OPENJPEG_COUNTS = {1: (51, 44, 86, 99, 19, 0), 2: (54, 50, 87, 123, 6, 0)}


@pytest.mark.parametrize("seed", sorted(OPENJPEG_COUNTS))
def test_openjpeg_written_files_match_pil(seed, tmp_path):
    """Codestreams OpenJPEG's own encoder writes (through ctypes: every
    code-block style bit, SOP / EPH, POCs, tile-parts, RGN, per-resolution
    precincts, subsampled components, 1-16 bits signed and unsigned, RCT)
    and 4 damaged copies of each: PIL's outcome every time (0
    disagreements); the counts stated."""
    import torch_j2k_probe as probe

    lib = probe.libopenjp2()
    rng = np.random.default_rng(seed)
    src, check = tmp_path / "src.j2k", tmp_path / "f"
    files = reads = 0
    counts = {"ok": 0, "error": 0, "value": 0, "refused": 0}
    faults = []
    for i in range(60):
        if not _openjpeg_file(lib, rng, src):
            continue
        data = src.read_bytes()
        files += 1
        pil, fault = _outcome(data, check)
        assert fault == "", (i, fault)
        reads += pil == "ok"
        for j, d in enumerate(damaged(rng, data, 4)):
            pil, fault = _outcome(d, check)
            if fault == "refused":
                counts["refused"] += 1
            elif fault:
                faults.append((i, j, fault))
            else:
                counts[pil] += 1
    assert not faults, faults[:5]
    assert (files, reads, *counts.values()) == OPENJPEG_COUNTS[seed]


def moved_headers(cs: bytes, kind: str) -> bytes:
    """A codestream whose every packet has SOP and EPH markers, rewritten
    with its packet headers (each with its EPH) moved out of the tile data
    into PPT markers of each tile-part (``kind`` "ppt"; Zppt counting on
    across a tile's parts) or PPM markers of the main header ("ppm", one
    Nppm a tile-part). A header ends at its EPH and a body at the next SOP:
    bit stuffing keeps both markers out of headers and code-block data."""
    sot = cs.find(b"\xff\x90")
    out, pos, parts = cs[:sot], sot, []
    while pos < len(cs) and cs[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack(">I", cs[pos + 6:pos + 10])[0]
        end = pos + psot if psot else len(cs) - 2
        sod = cs.find(b"\xff\x93", pos + 12)
        data, headers, bodies, i = cs[sod + 2:end], b"", b"", 0
        while i < len(data):
            j = data.index(b"\xff\x92", i + 6) + 2
            k = data.find(b"\xff\x91", j)
            k = len(data) if k < 0 else k
            headers += data[i + 6:j]
            bodies += data[i:i + 6] + data[j:k]
            i = k
        parts.append((cs[pos:pos + 12], cs[pos + 12:sod], headers, bodies))
        pos = end

    def markers(code, blob, z0=0):
        return b"".join(struct.pack(">HHB", code, len(blob[a:a + 65000]) + 3, z0 + z)
                        + blob[a:a + 65000] for z, a in enumerate(range(0, len(blob), 65000)))

    if kind == "ppm":
        out += markers(0xFF60, b"".join(struct.pack(">I", len(h)) + h for _, _, h, _ in parts))
    zppt = {}
    for sot_segment, head, headers, bodies in parts:
        ppt = b""
        if kind == "ppt":
            z0 = zppt.get(sot_segment[4:6], 0)
            ppt = markers(0xFF61, headers, z0)
            zppt[sot_segment[4:6]] = z0 + -(-len(headers) // 65000)
        body = head + ppt + b"\xff\x93" + bodies
        out += sot_segment[:6] + struct.pack(">I", 12 + len(body)) + sot_segment[10:] + body
    return out + b"\xff\xd9"


# seed → outcomes of the PPT and PPM files of 20 draws and of 2 damaged
# copies of each (PIL reads / fails / identifies as nothing)
MOVED_HEADER_COUNTS = {1: (83, 34, 3), 2: (79, 38, 3)}


@pytest.mark.parametrize("seed", sorted(MOVED_HEADER_COUNTS))
def test_packet_headers_in_ppt_and_ppm_markers_read_as_pil(seed, tmp_path):
    """OpenJPEG-written codestreams with SOP and EPH in every packet (gray
    or three components, 1-3 resolutions, any progression, style bits,
    tiles, tile-parts, layers), their packet headers moved into PPT or PPM
    markers (``moved_headers``: no encoder of PIL's or OpenJPEG's writes
    them), and 2 damaged copies of each: PIL's outcome every time."""
    import torch_j2k_probe as probe

    lib = probe.libopenjp2()
    rng = np.random.default_rng(seed)
    src, check = tmp_path / "src.j2k", tmp_path / "f"
    counts = {"ok": 0, "error": 0, "value": 0}
    for _ in range(20):
        g = rng.integers(0, 256, (int(rng.integers(4, 40)), int(rng.integers(4, 40))))
        planes = [g] if rng.random() < 0.5 else [g] + [rng.integers(0, 256, g.shape)] * 2
        kw = dict(resolutions=int(rng.integers(1, 4)), sop_eph=6, prog=int(rng.integers(0, 5)),
                  mode=int(rng.integers(0, 64)) if rng.random() < 0.5 else 0)
        if rng.random() < 0.5:
            kw["tile"] = (int(rng.integers(8, 24)), int(rng.integers(8, 24)))
        if rng.random() < 0.3:
            kw["tile_parts"] = str(rng.choice(["R", "C"]))
        if rng.random() < 0.4:
            kw["layers"] = (30.0, 10.0, 0.0)
        if not probe.openjpeg_encode(lib, planes, str(src), **kw):
            continue
        for kind in ("ppt", "ppm"):
            data = moved_headers(src.read_bytes(), kind)
            for d in [data] + damaged(rng, data, 2):
                pil, fault = _outcome(d, check)
                assert fault == "", (kind, kw, fault)
                counts[pil] += 1
    assert tuple(counts.values()) == MOVED_HEADER_COUNTS[seed]


# ------------------------------------------------ JP2 boxes, unpackers
def _box(t: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + t + body


def _jp2(codestream, H, W, nc, bpc, enum=None, meth=1):
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", H, W, nc, bpc, 7, 0, 0))
    colr = _box(b"colr", struct.pack(">BBBI", meth, 0, 0, enum)) if enum is not None else b""
    return (_box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", ihdr + colr) + _box(b"jp2c", codestream))


@pytest.mark.parametrize("comps,mode", [(1, "L"), (2, "LA"), (3, "RGB"), (4, "RGBA")])
def test_jp2_colour_spaces_pick_pillows_unpacker(comps, mode, tmp_path):
    """A codestream of 1-4 components in a JP2 whose ihdr names 1-4
    components of 8 or 12 bits and whose colr box names sRGB, gray, sYCC
    (Pillow's YCbCr conversion), CMYK, e-sYCC, another space, an ICC
    profile, or is missing: Pillow's mode, unpacker or failure (48 files a
    component count)."""
    rng = np.random.default_rng(comps)
    arr = rng.integers(0, 256, (6, 5, comps)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr[..., 0] if comps == 1 else arr, mode).save(buf, "JPEG2000", no_jp2=True)
    n = 0
    for nc in (1, 2, 3, 4):
        for bpc in (7, 11):
            for enum, meth in ((16, 1), (17, 1), (18, 1), (12, 1), (24, 1), (99, 1), (0, 2), (None, 1)):
                data = _jp2(buf.getvalue(), 6, 5, nc, bpc, enum, meth)
                assert _outcome(data, tmp_path / "f")[1] == "", (nc, bpc, enum, meth)
                n += 1
    assert n == 64


def test_sycc_conversion_is_pillows_on_every_value(tmp_path):
    """sYCC (colr 18) over three components: Pillow's ImagingConvertYCbCr2RGB
    on all 256 values of Y, Cb and Cr, then to L."""
    y, cb, cr = np.meshgrid(np.arange(256), np.arange(0, 256, 5), np.arange(0, 256, 15),
                            indexing="ij")
    arr = np.stack([y, cb, cr], -1).reshape(256, -1, 3).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, "RGB").save(buf, "JPEG2000", no_jp2=True)
    data = _jp2(buf.getvalue(), arr.shape[0], arr.shape[1], 3, 7, 18)
    assert _outcome(data, tmp_path / "f") == ("ok", "")


def test_precisions_and_signs_unpack_as_pillow(tmp_path):
    """L, LA, RGB and RGBA codestreams and JP2 files whose SIZ names 1 to
    31 bits, unsigned and signed (Ssiz patched): OpenJPEG's DC shift and
    clamp to the precision, then Pillow's shift to 8 or 16 bits (I;16
    past 8 bits for one component), its rounding offset where it shifts
    down, its signed offset, and the stores that wrap (160 files)."""
    rng = np.random.default_rng(0)
    n = 0
    for mode, nb in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        arr = rng.integers(0, 256, (7, 9, nb)).astype(np.uint8)
        for no_jp2 in (True, False):
            buf = io.BytesIO()
            Image.fromarray(arr[..., 0] if nb == 1 else arr, mode).save(buf, "JPEG2000",
                                                                        no_jp2=no_jp2)
            data = buf.getvalue()
            siz = data.find(b"\xff\x51")
            for prec in (1, 4, 7, 8, 9, 12, 16, 20, 24, 31):
                for sign in (0, 0x80):
                    d = bytearray(data)
                    for k in range(nb):
                        d[siz + 40 + 3 * k] = (prec - 1) | sign
                    assert _outcome(bytes(d), tmp_path / "f")[1] == "", (mode, prec, sign)
                    n += 1
    assert n == 160


def test_subsampled_components_read_as_pil(tmp_path):
    """Codestreams of 7 × 9, 16 × 16 and 13 × 20 pixels (plain, with an
    image offset, in 8 × 8 tiles) whose SIZ subsamples the first, the
    chroma, the last or every component by 2 × 1, 1 × 2, 2 × 2 or 3 × 1
    (XRsiz / YRsiz patched): OpenJPEG's tile-components of the subsampled
    size (a tile narrower than a component's dx has no precinct: OpenJPEG
    fails it), Pillow's heuristic colour space (sYCC where the chroma is
    subsampled) and its unpackers' ``w / dx`` indexing (384 files: PIL
    reads 198, fails 186)."""
    rng = np.random.default_rng(0)
    counts = {"ok": 0, "error": 0}
    for mode, nb in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        for H, W in ((7, 9), (16, 16), (13, 20)):
            arr = rng.integers(0, 256, (H, W, nb)).astype(np.uint8)
            for kw in ({}, {"offset": (1, 3)}, {"tile_size": (8, 8)}):
                buf = io.BytesIO()
                try:
                    Image.fromarray(arr[..., 0] if nb == 1 else arr, mode).save(
                        buf, "JPEG2000", no_jp2=True, **kw)
                except OSError:  # PIL's encoder refuses tiles past a small image
                    continue
                siz = buf.getvalue().find(b"\xff\x51")
                for comps in ([0], [1, 2], [nb - 1], list(range(nb))):
                    for dx, dy in ((2, 1), (1, 2), (2, 2), (3, 1)):
                        d = bytearray(buf.getvalue())
                        for k in comps:
                            if k < nb:
                                d[siz + 41 + 3 * k], d[siz + 42 + 3 * k] = dx, dy
                        pil, fault = _outcome(bytes(d), tmp_path / "f")
                        assert fault == "", (mode, H, W, kw, comps, dx, dy, fault)
                        counts[pil] += 1
    assert counts == SUBSAMPLED_COUNTS


SUBSAMPLED_COUNTS = {"ok": 198, "error": 186}


# ------------------------------------------ the open: pass-on, sizes
OPEN_CASES = {
    "five components": lambda cs: cs[:40] + b"\x00\x05" + cs[42:],
    "SIZ cut short": lambda cs: cs[:30],
    "zero width": lambda cs: cs[:16] + cs[8:12] + cs[20:],
    "comment of length 0": lambda cs: (cs[:4 + struct.unpack(">H", cs[4:6])[0]] + b"\xff\x64\0\0"
                                       + cs[4 + struct.unpack(">H", cs[4:6])[0]:]),
    "JP2 without jp2h": lambda cs: _box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 \0\0\0\0"),
    "JP2 without ihdr": lambda cs: (_box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 \0\0\0\0")
                                    + _box(b"jp2h", _box(b"colr", b"\x01\0\0\0\0\0\x11"))
                                    + _box(b"jp2c", cs)),
    "JP2 of a short ihdr": lambda cs: (_box(b"jP  ", b"\r\n\x87\n") + _box(b"ftyp", b"jp2 \0\0\0\0")
                                       + _box(b"jp2h", _box(b"ihdr", b"\0\0\0\x06"))
                                       + _box(b"jp2c", cs)),
    "JP2 ihdr other than SIZ": lambda cs: _jp2(cs, 7, 5, 1, 7, 17),
    "JP2 of a box length 3": lambda cs: (_box(b"jP  ", b"\r\n\x87\n")
                                         + b"\0\0\0\x03ftypjp2 \0\0\0\0"),
}


@pytest.mark.parametrize("case", sorted(OPEN_CASES))
def test_open_passes_on_or_fails_as_pil(case, tmp_path):
    """Jpeg2KImageFile._open and BoxReader on files they reject: a
    SyntaxError (or struct.error) passes the file on, here to no plugin
    (``ValueError`` in the port, UnidentifiedImageError in PIL); an OSError
    or an assertion fails it; what opens but OpenJPEG refuses (an ihdr
    size other than SIZ's) is PIL's broken data stream."""
    buf = io.BytesIO()
    Image.new("L", (5, 6), 90).save(buf, "JPEG2000", no_jp2=True)
    data = OPEN_CASES[case](buf.getvalue())
    pil, fault = _outcome(data, tmp_path / "f")
    assert fault == ""


# ----------------------------------------------------------- refusals
def _patch_cod(cs: bytes, offset: int, value: int) -> bytes:
    at = cs.find(b"\xff\x52") + 4
    d = bytearray(cs)
    d[at + offset] = value
    return bytes(d)


REFUSALS = {
    "9/7 wavelet": (lambda: _saved(irreversible=True), "9/7"),
    "9/7 wavelet, JP2": (lambda: _saved(irreversible=True, no_jp2=False), "9/7"),
    "HT code-blocks": (lambda: _patch_cod(_saved(), 8, 0x40), "HT"),
    "Part 2 MCT marker": (lambda: _with_marker(_saved(), 0xFF74, b"\0\0\0\0"), "Part 2"),
}


def _saved(**kw) -> bytes:
    kw.setdefault("no_jp2", True)
    buf = io.BytesIO()
    Image.fromarray(np.arange(48, dtype=np.uint8).reshape(6, 8)).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _with_marker(cs: bytes, marker: int, body: bytes) -> bytes:
    at = cs.find(b"\xff\x90")
    return cs[:at] + struct.pack(">HH", marker, len(body) + 2) + body + cs[at:]


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_kinds_not_read_yet_are_refused_naming_their_roadmap_item(case, tmp_path):
    """The 9/7 wavelet (and ICT), HT code-blocks and a Part 2 marker:
    ``NotImplementedError`` naming JPEG 2000, the kind and its ROADMAP
    item, on ``decode_u8``, ``image_size`` (the main header names them)
    and ``read_gray``."""
    make, word = REFUSALS[case]
    data = make()
    path = tmp_path / "f"
    path.write_bytes(data)
    for call in (lambda: native.decode_u8(data), lambda: native.image_size(data),
                 lambda: png.read_gray(str(path))):
        with pytest.raises(NotImplementedError, match="JPEG 2000") as e:
            call()
        assert word in str(e.value) and "ROADMAP" in str(e.value)


def test_icns_of_jpeg2000_entries_reads_as_pil(tmp_path):
    """ICNS whose best size is a codestream or a JP2 file of L, LA, RGB and
    RGBA (PIL converts each to RGBA, then to L), and one whose entry is cut
    short: PIL's outcome."""
    import torch_make_image_kinds as mk

    n = 0
    for mode, nb in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        arr = np.stack([mk.scene(32, 32, nb + k) for k in range(nb)], -1)
        arr = arr[..., 0] if nb == 1 else arr
        for no_jp2 in (True, False):
            buf = io.BytesIO()
            Image.fromarray(arr, mode).save(buf, "JPEG2000", no_jp2=no_jp2)
            icon = mk.encode_icns([(b"is32", mk.icns_rgb(mk.scene(16, 16, 4, 3))),
                                   (b"ic11", buf.getvalue())])
            for data in (icon, icon[:len(icon) - 40]):
                assert _outcome(data, tmp_path / "f")[1] == ""
                n += 1
    assert n == 16
