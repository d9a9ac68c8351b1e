"""TIFF's LZMA (34925), ZSTD (50000) and ThunderScan (32809) compressions,
which PIL 12.1 reads through its bundled libtiff 4.7.1 (liblzma 5.8.2,
libzstd 1.5.7) and the port reads with its own C++
(``rspl_slam_tpu_torch/csrc/native_xz.h``, ``native_zstd.h``, and
``thunder_decode`` in ``native_tiff.h``); TIFF tags written twice, which
PIL reads by their last entry and libtiff by their first; and the two
compressions PIL refuses, WebP and SGILog.

PIL is the oracle: every file gives PIL's ``Image.open(p).convert("L")``
bit for bit through ``native.decode_u8`` and ``png.read_gray``, or raises
the exception PIL's failure maps to (PIL finding no plugin, or no mode for
the file's samples: ``ValueError`` or a named ``NotImplementedError``;
any other failure, libtiff's and the codecs' included: ``IOError`` or a
named ``NotImplementedError``).

- LZMA: the standard library's ``lzma`` at presets 0-9 and extreme, every
  check, delta distances and the BCJ filters it names, Pillow's liblzma
  (ctypes) for ARM64 and RISC-V, and streams assembled by hand around raw
  LZMA2 (uncompressed chunks, a chunk that resets the state and not the
  dictionary, two blocks with their sizes in the headers);
- ZSTD: Pillow's libzstd (ctypes) at levels -5, 1, 3 and 19, with and
  without the checksum, without a content size and a window of 2^27 or
  2^28 (past libzstd's streaming limit), and the writer of
  ``torch_make_image_kinds`` for what libzstd seldom writes on small
  strips (raw and RLE blocks, RLE and treeless literals, RLE and repeat
  sequence tables), a leading skippable frame, two frames in one strip;
- ThunderScan: a writer over every code (runs, 2- and 3-bit deltas with
  their skip codes, raw pixels), both 4-bit photometrics, fill order 2;
  other depths and tiles, which libtiff refuses;
- each in 8 and 16 bits (ThunderScan 4), predictors 1-3 (3 on floats),
  strips and tiles, both byte orders, and bit-flipped, truncated and
  lengthened copies;
- the repeated-tag corpus: a file of every compression the port reads,
  each libtiff-read tag it has written a second time with a random value.
"""

import io
import lzma
import struct
import zlib

import numpy as np
import pytest
import torch_make_image_kinds as mk
from PIL import Image, UnidentifiedImageError

from rspl_slam_tpu_torch import native, png

# the port's refusal where PIL reads: a raw mode whose rows are longer than
# libtiff's tile rows reads past Pillow's tile buffer (its pixels differ
# from one read to the next)
PIL_READS_REFUSED = ("past the end of its tile buffer",)


def _pil(data: bytes):
    try:
        with Image.open(io.BytesIO(data)) as im:
            return "ok", np.asarray(im.convert("L"))
    except UnidentifiedImageError as e:
        return "value", e
    except Exception as e:  # noqa: BLE001 - libtiff's failures come as many kinds
        return "error", e


def _port(route):
    try:
        return "ok", route()
    except NotImplementedError as e:
        return "refused", e
    except ValueError as e:
        return "value", e
    except OSError as e:
        return "error", e


def _agrees(data: bytes, path, allow_refused=False) -> str:
    """'' where both routes give PIL's outcome; 'refused' where PIL reads
    and the port refuses naming one of ``PIL_READS_REFUSED`` (with
    ``allow_refused``); else the fault."""
    path.write_bytes(data)
    a = _pil(data)
    for name, route in (("decode_u8", lambda: native.decode_u8(data)),
                        ("read_gray", lambda: png.read_gray(str(path)))):
        b = _port(route)
        if a[0] == "ok":
            if b[0] == "refused" and allow_refused and any(w in str(b[1])
                                                            for w in PIL_READS_REFUSED):
                return "refused"
            if b[0] != "ok" or not np.array_equal(a[1], b[1]):
                return f"{name}: PIL reads {a[1].shape}; the port: {b[0]} " \
                       f"{b[1] if b[0] != 'ok' else 'other pixels'}"
        elif a[0] == "value" and b[0] not in ("value", "refused"):
            return f"{name}: PIL identifies nothing ({a[1]}); the port: {b[0]}"
        elif a[0] == "error" and b[0] not in ("error", "refused"):
            return f"{name}: PIL raises {type(a[1]).__name__}: {a[1]}; the port: {b[0]}"
    return ""


def _ifd_at(data: bytes) -> int:
    return struct.unpack("<I" if data[:2] == b"II" else ">I", data[4:8])[0]


def _copies(rng, data: bytes, k: int) -> list:
    """``k`` copies of ``data`` (a classic TIFF whose IFD follows its image
    data, as ``encode_tiff`` writes it) with the image data damaged: bits
    flipped, a cut inside a strip or tile (the byte counts then reach past
    the file's end), bytes inserted before the IFD (the IFD's offset moved
    with them) or appended."""
    out = []
    end = _ifd_at(data)
    for _ in range(k):
        d = bytearray(data)
        r = rng.random()
        if r < 0.6:
            for _ in range(int(rng.integers(1, 3))):
                i = int(rng.integers(8, end))
                d[i] ^= 1 << int(rng.integers(8))
        elif r < 0.75:
            cut = int(rng.integers(8, end))
            d = d[:cut] + d[end:]
            d[4:8] = struct.pack("<I" if d[:2] == b"II" else ">I", cut)
        elif r < 0.9:
            i = int(rng.integers(8, end + 1))
            ins = bytes(rng.integers(0, 256, int(rng.integers(1, 6))).astype(np.uint8))
            d[i:i] = ins
            d[4:8] = struct.pack("<I" if d[:2] == b"II" else ">I", end + len(ins))
        else:
            d += bytes(rng.integers(0, 256, int(rng.integers(1, 40))).astype(np.uint8))
        out.append(bytes(d))
    return out


def _check(files, tmp_path, allow_refused=False):
    faults = [f"{name}: {r}" for name, data in files
              if (r := _agrees(data, tmp_path / "f.tif", allow_refused)) not in ("", "refused")]
    assert not faults, faults[:5]
    return len(files)


def _samples(rng, bits, H, W, float_=False):
    if float_:
        return rng.normal(0, 100, (H, W)).astype(np.float32)
    if rng.random() < 0.5:
        return (mk.scene(H, W, int(rng.integers(0, 1000))).astype(np.int64) << (bits - 8)) + \
            rng.integers(0, 1 << (bits - 8), (H, W))
    return rng.integers(0, 1 << bits, (H, W))


def _layout(rng, H):
    if rng.random() < 0.3:
        return {"tile": (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))}
    return {"rows_per_strip": int(rng.integers(1, H + 2))}


def _files(rng, compression, squeezers, n, damaged):
    """``n`` random files of ``compression`` (a random squeezer each), 8,
    16 or 32-bit float samples, predictors, layouts and byte orders, then
    ``damaged`` damaged copies of each."""
    out = []
    for i in range(n):
        H, W = int(rng.integers(1, 34)), int(rng.integers(1, 34))
        kind = int(rng.integers(0, 3))
        bits, sf = ((8, 1), (16, 1), (32, 3))[kind]
        predictor = int(rng.integers(1, 4)) if sf == 3 else int(rng.integers(1, 3))
        img = _samples(rng, bits, H, W, sf == 3)
        squeeze = squeezers[int(rng.integers(len(squeezers)))]
        data = mk.encode_tiff(img, bits=bits, sample_format=sf, compression=compression,
                              predictor=predictor, order=str(rng.choice(["<", ">"])),
                              squeeze=lambda b, s=squeeze: s(rng, b), **_layout(rng, H))
        out.append((f"{i}", data))
        out += [(f"{i} damaged {j}", d) for j, d in enumerate(_copies(rng, data, damaged))]
    return out


# ------------------------------------------------------------------ LZMA
def _xz_preset(rng, b):
    preset = int(rng.integers(0, 10)) | (lzma.PRESET_EXTREME if rng.random() < 0.3 else 0)
    check = int(rng.choice([lzma.CHECK_NONE, lzma.CHECK_CRC32, lzma.CHECK_CRC64,
                            lzma.CHECK_SHA256]))
    return mk.xz(b, check, preset)


def _xz_delta(rng, b):
    return mk.xz(b, filters=[{"id": lzma.FILTER_DELTA, "dist": int(rng.integers(1, 9))},
                             {"id": lzma.FILTER_LZMA2, "preset": int(rng.integers(0, 7))}])


BCJ = {"x86": lzma.FILTER_X86, "powerpc": lzma.FILTER_POWERPC, "ia64": lzma.FILTER_IA64,
       "arm": lzma.FILTER_ARM, "armthumb": lzma.FILTER_ARMTHUMB, "sparc": lzma.FILTER_SPARC,
       "arm64": 10, "riscv": 11}


def _bcj_data(rng, n: int) -> bytes:
    """Bytes dense in every BCJ filter's branch patterns."""
    pats = [b"\xe8", b"\xe9", b"\x48\x00\x00\x01", b"\x00\x00\x00\xeb", b"\x00\xf0\x00\xf8",
            b"\x40\x00", b"\x7f\xc0", b"\x00\x00\x00\x94", b"\x00\x00\x00\x90", b"\xef",
            b"\x17\x01", b"\x97\x02\x00\x00\x13\x05", b"\x11\x00\x00\x00\x00\x00\x00\x00"
            b"\x00\x00\x00\x00\x00\xa0\x00\x00"]
    out = bytearray()
    while len(out) < n:
        out += pats[int(rng.integers(len(pats)))] if rng.random() < 0.4 else \
            bytes(rng.integers(0, 256, int(rng.integers(1, 6))).astype(np.uint8))
    return bytes(out[:n])


@pytest.mark.parametrize("kind", ["preset", "delta"])
def test_random_lzma_tiffs_match_pil(kind, tmp_path):
    """Random LZMA TIFFs (presets 0-9 and extreme, every check; or the delta
    filter at distances 1-8) and their damaged copies: PIL's outcome."""
    rng = np.random.default_rng(["preset", "delta"].index(kind))
    sq = _xz_preset if kind == "preset" else _xz_delta
    assert _check(_files(rng, 34925, [sq], 24, 6), tmp_path) == 24 * 7


@pytest.mark.parametrize("name", sorted(BCJ))
def test_lzma_bcj_filters_match_pil(name, tmp_path):
    """A strip of branch-dense bytes through each BCJ filter liblzma 5.8.2
    decodes (the standard library's, or Pillow's liblzma for ARM64 and
    RISC-V), with a start offset, at a strip's end and in damaged copies:
    PIL reads what the port reads."""
    rng = np.random.default_rng(list(BCJ).index(name))
    fid = BCJ[name]
    files = []
    for i in range(6):
        H, W = int(rng.integers(2, 30)), int(rng.integers(2, 40))
        raw = np.frombuffer(_bcj_data(rng, H * W), np.uint8).reshape(H, W)
        if fid >= 10:
            sq = lambda b: mk.liblzma_xz(b, [fid], int(rng.choice([0, 1, 4, 10])))  # noqa: E731
        else:
            opts = {"id": fid}
            if i % 2:
                opts["start_offset"] = 16 * int(rng.integers(0, 100))
            sq = lambda b, o=opts: mk.xz(b, filters=[o, {"id": lzma.FILTER_LZMA2,  # noqa: E731
                                                          "preset": 1}])
        data = mk.encode_tiff(raw, compression=34925, squeeze=sq,
                              rows_per_strip=int(rng.integers(1, H + 1)))
        files.append((f"{name} {i}", data))
        files += [(f"{name} {i} damaged", d) for d in _copies(rng, data, 8)]
    assert _check(files, tmp_path) == 54


def _xz_wrap(lzma2: bytes, dict_byte: int = 16, sizes=None, check: int = 1,
             content: bytes = b"") -> bytes:
    """An .xz stream of one block around raw LZMA2 data (``sizes``: the
    compressed and uncompressed sizes written in the block header)."""
    flags = bytes([0, check])
    head = b"\xfd7zXZ\0" + flags + struct.pack("<I", zlib.crc32(flags))
    vli = lambda v: bytes([(v >> (7 * i) & 0x7F) | (0x80 if v >> (7 * (i + 1)) else 0)  # noqa
                           for i in range(max(1, (v.bit_length() + 6) // 7))])
    body = bytes([(0x40 | 0x80) if sizes else 0])
    if sizes:
        body += vli(sizes[0]) + vli(sizes[1])
    body += b"\x21\x01" + bytes([dict_byte])
    hsize = -(-(len(body) + 1 + 4) // 4) * 4
    bh = bytes([hsize // 4 - 1]) + body
    bh += bytes(hsize - 4 - len(bh))
    bh += struct.pack("<I", zlib.crc32(bh))
    pad = bytes(-len(lzma2) % 4)
    chk = struct.pack("<I", zlib.crc32(content)) if check == 1 else b""
    return head + bh + lzma2 + pad + chk


def _lzma2_raw(data: bytes) -> bytes:
    return lzma.compress(data, lzma.FORMAT_RAW, filters=[{"id": lzma.FILTER_LZMA2,
                                                            "preset": 6}])


def test_lzma2_chunk_kinds_by_hand_match_pil(tmp_path):
    """Streams assembled around raw LZMA2: uncompressed chunks with and
    without a dictionary reset, an LZMA chunk that resets the state but not
    the dictionary (its first control byte 0xE0 made 0xC0), a dictionary
    byte of 40, block headers stating the sizes (right and wrong), an
    unknown check id, a missing end marker; and damaged copies."""
    rng = np.random.default_rng(7)
    g = mk.scene(16, 32, 3)
    raw = g.tobytes()
    a, b = raw[:256], raw[256:]
    lz = _lzma2_raw(b)
    chunks = {
        "uncompressed": b"\x01" + struct.pack(">H", len(a) - 1) + a + b"\x02" +
        struct.pack(">H", len(b) - 1) + b + b"\0",
        "state reset after copy": b"\x01" + struct.pack(">H", len(a) - 1) + a + b"\xc0" + lz[1:],
        "dict reset": b"\x01" + struct.pack(">H", len(a) - 1) + a + lz,
        "no dict reset first": b"\x02" + struct.pack(">H", len(raw) - 1) + raw + b"\0",
        "no end marker": _lzma2_raw(raw)[:-1],
    }
    files = []
    for name, body in chunks.items():
        for kw in ({}, {"dict_byte": 40}, {"sizes": (len(body), len(raw))},
                   {"sizes": (len(body), len(raw) - 1)}, {"check": 3}, {"check": 0}):
            data = mk.encode_tiff(g, compression=34925,
                                  squeeze=lambda _, c=body, k=kw: _xz_wrap(c, content=raw, **k))
            files.append((f"{name} {kw}", data))
            files += [(f"{name} {kw} damaged", d) for d in _copies(rng, data, 3)]
    assert _check(files, tmp_path) == 120


def test_lzma_two_blocks_and_their_checks_match_pil(tmp_path):
    """A strip in two blocks, the first's CRC32 right or wrong, or no check:
    libtiff reads on into the second block only past a first block whose
    check liblzma verifies."""
    g = mk.scene(12, 40, 11)
    raw = g.tobytes()
    half = len(raw) // 2

    def two(check_one_ok, check):
        s1 = _xz_wrap(_lzma2_raw(raw[:half]), check=check, content=raw[:half])
        s2 = _xz_wrap(_lzma2_raw(raw[half:]), check=check, content=raw[half:])
        block1, block2 = s1[12:], s2[12:]
        if not check_one_ok:
            block1 = block1[:-1] + bytes([block1[-1] ^ 1])
        return s1[:12] + block1 + block2

    files = [(f"{ok} {c}", mk.encode_tiff(g, compression=34925,
                                          squeeze=lambda _, o=ok, c=c: two(o, c)))
             for ok, c in ((True, 1), (False, 1), (True, 0))]
    assert [_pil(d)[0] for _, d in files] == ["ok", "error", "ok"]
    assert _check(files, tmp_path) == 3


# ------------------------------------------------------------------ ZSTD
def _zstd_level(rng, b):
    return mk.zstd_compress(b, int(rng.choice([-5, 1, 3, 19])), bool(rng.random() < 0.5))


def _zstd_window(rng, b):
    return mk.zstd_compress(b, 3, bool(rng.random() < 0.5), int(rng.choice([10, 20, 27, 28])),
                            content_size=False)


def _zstd_writer(rng, b):
    return mk.zstd_writer_frame(rng, len(b))[0]


@pytest.mark.parametrize("kind", ["levels", "window", "writer"])
def test_random_zstd_tiffs_match_pil(kind, tmp_path):
    """Random ZSTD TIFFs: libzstd at levels -5, 1, 3 and 19 with and
    without a checksum; without a content size at windows of 2^10 to 2^28
    (libzstd's streaming path, which refuses past 2^27); the frame writer's
    blocks; and their damaged copies: PIL's outcome."""
    sq = {"levels": _zstd_level, "window": _zstd_window, "writer": _zstd_writer}[kind]
    rng = np.random.default_rng(["levels", "window", "writer"].index(kind) + 10)
    assert _check(_files(rng, 50000, [sq], 24, 6), tmp_path) == 24 * 7


def test_zstd_frames_around_the_strip_match_pil(tmp_path):
    """A skippable frame before the strip's frame (the stream then ends:
    "Not enough data"), a second frame after a frame that fills the strip
    or falls short of it, a dictionary ID, a frame shorter or longer than
    the strip, and a single segment a compressed block outgrows."""
    rng = np.random.default_rng(21)
    g = mk.scene(8, 24, 5)
    raw = g.tobytes()
    frame = mk.zstd_compress(raw, 3, True)
    half = mk.zstd_compress(raw[:len(raw) // 2], 3)
    blocks = mk.zstd_block("compressed", mk.zstd_literals(raw, "raw") + b"\0", True)
    cases = {
        "skippable first": mk.zstd_skippable(b"meta") + frame,
        "two frames": frame + mk.zstd_compress(raw[::-1], 1),
        "short then rest": half + mk.zstd_compress(raw[len(raw) // 2:], 1),
        "dictionary id": mk.zstd_frame(blocks, raw, True, 12, dict_id=7),
        "longer": mk.zstd_compress(raw + raw[:40], 3),
        "shorter": mk.zstd_compress(raw[:-9], 3),
        "single segment outgrown": mk.zstd_frame(blocks, raw, False),
        "window 28 sized": mk.zstd_frame(blocks, raw, False, 28),
    }
    files = []
    for name, fr in cases.items():
        data = mk.encode_tiff(g, compression=50000, squeeze=lambda _, f=fr: f)
        files.append((name, data))
        files += [(f"{name} damaged", d) for d in _copies(rng, data, 3)]
    assert _pil(files[0][1])[0] == "error"
    assert _check(files, tmp_path) == 32


# ----------------------------------------------------------- ThunderScan
def test_random_thunderscan_tiffs_match_pil(tmp_path):
    """Random 4-bit ThunderScan TIFFs over every code, both photometrics,
    fill order 2, strips of any height, and their damaged copies (runs past
    a row: "Too much data"; a strip's end inside a row: "Not enough
    data"); other depths and tiles, which libtiff refuses."""
    rng = np.random.default_rng(31)
    files = []
    for i in range(40):
        H, W = int(rng.integers(1, 30)), int(rng.integers(1, 40))
        img = mk.scene(H, W, i) // 16 if rng.random() < 0.5 else rng.integers(0, 16, (H, W))
        kw = {"photometric": int(rng.choice([0, 1])), "order": str(rng.choice(["<", ">"])),
              "rows_per_strip": int(rng.integers(1, H + 1))}
        if rng.random() < 0.2:
            kw["fill_order"] = 2
        if rng.random() < 0.1:
            kw["bits"] = int(rng.choice([1, 2, 8]))
        if rng.random() < 0.1:
            kw["tile"] = (16, 16)
            kw.pop("rows_per_strip")
        data = mk.encode_tiff_thunder(img, rng=rng, **kw)
        files.append((f"{i}", data))
        files += [(f"{i} damaged", d) for d in _copies(rng, data, 5)]
    assert _check(files, tmp_path) == 240


def test_thunderscan_reads_every_code():
    """The writer's output holds every ThunderScan code, and the port reads
    a strip of them as 17 · v gray, as PIL's "L;4" unpacks it."""
    rng = np.random.default_rng(5)
    img = (mk.scene(12, 21, 3) // 16).astype(np.int64)
    img[:, 10:15] = img[:, 9:10]
    img[3, ::2] = rng.integers(0, 16, 11)
    data = mk.thunder_encode(img, rng)
    assert {b >> 6 for b in data} == {0, 1, 2, 3}
    assert any(b >> 6 == 1 and 2 in ((b >> 4) & 3, (b >> 2) & 3, b & 3) for b in data)
    assert any(b >> 6 == 2 and 4 in ((b >> 3) & 7, b & 7) for b in data)
    tif = mk.encode_tiff_thunder(img, rng=rng)
    np.testing.assert_array_equal(native.decode_u8(tif), (img * 17).astype(np.uint8))


# ------------------------------------------------------ tags written twice
TAG_TYPES = {256: 4, 257: 4, 258: 3, 259: 3, 262: 3, 266: 3, 273: 4, 277: 3, 278: 4, 279: 4,
             284: 3, 292: 4, 293: 4, 317: 3, 322: 3, 323: 3, 324: 4, 325: 4, 338: 3, 339: 3,
             347: 7, 530: 3}


def _second_value(tag, rng, size):
    c = lambda *v: [int(rng.choice(v))]  # noqa: E731
    if tag in (256, 257):
        return [int(rng.integers(1, 40))]
    if tag == 258:
        return c(1, 2, 4, 8, 12, 16, 32) * int(rng.choice([1, 1, 3]))
    if tag == 259:
        return c(1, 2, 3, 4, 5, 6, 7, 8, 32773, 32809, 32946, 34676, 34925, 50000, 50001)
    if tag in (273, 324):
        return [int(rng.integers(8, size))] * int(rng.integers(1, 4))
    if tag in (279, 325):
        return [int(rng.integers(0, 400))] * int(rng.integers(1, 4))
    if tag == 347:
        return [int(v) for v in rng.integers(0, 256, 20)]
    if tag == 530:
        return c(1, 2, 4) + c(1, 2, 4)
    return c(*{262: (0, 1, 2, 3, 5, 6, 8), 266: (1, 2), 277: (1, 2, 3, 4),
               278: (1, 2, 3, 4, 8, 16, 1000), 284: (1, 2), 292: (0, 1, 4, 5), 293: (0, 1, 4, 5),
               317: (1, 2, 3), 322: (8, 16, 32), 323: (8, 16, 32), 338: (0, 1, 2),
               339: (1, 2, 3)}[tag])


def _bases(rng):
    """(name, build(tags)) of a file of each compression the port reads."""
    H, W = int(rng.integers(8, 33)), int(rng.integers(8, 33))
    g = mk.scene(H, W, int(rng.integers(0, 1000)))
    rgb = mk.scene(H, W, int(rng.integers(0, 1000)), 3)
    ycc = mk.rgb_to_ycbcr(rgb)
    rps = int(rng.integers(1, H + 1))
    out = []
    for comp in (1, 5, 8, 32773, 34925, 50000):
        pred = 2 if comp in (5, 8, 34925, 50000) else 1
        out += [
            (f"gray8 {comp}", lambda t, c=comp, p=pred: mk.encode_tiff(
                g, compression=c, rows_per_strip=rps, predictor=p, tags=t)),
            (f"gray16 {comp}", lambda t, c=comp: mk.encode_tiff(
                g.astype(np.int64) * 200, bits=16, compression=c, rows_per_strip=rps, tags=t)),
            (f"rgb tiles {comp}", lambda t, c=comp: mk.encode_tiff(
                rgb, photometric=2, compression=c, tile=(16, 16), tags=t)),
            (f"rgb planes {comp}", lambda t, c=comp: mk.encode_tiff(
                rgb, photometric=2, compression=c, planar=2, rows_per_strip=rps, tags=t))]
    out += [
        ("thunderscan", lambda t: mk.encode_tiff_thunder(g // 16, rows_per_strip=rps, tags=t)),
        ("jpeg ycbcr", lambda t: mk.encode_tiff_jpeg(ycc, 6, (2, 2), "all", rows_per_strip=16,
                                                     tags=t)),
        ("jpeg gray", lambda t: mk.encode_tiff_jpeg(g, 1, (1, 1), "dqt", rows_per_strip=8,
                                                    tags=t)),
        ("ojpeg", lambda t: mk.encode_tiff_ojpeg(ycc, 2, 2, tags=t)),
        ("group 4", lambda t: mk.encode_tiff_fax(g > 128, 4, 0, rows_per_strip=rps, tags=t)),
        ("group 3", lambda t: mk.encode_tiff_fax(g > 128, 3, 1, 5, rows_per_strip=rps, tags=t)),
        ("mh", lambda t: mk.encode_tiff_fax(g > 128, 2, 1, rows_per_strip=rps, tags=t)),
        ("ycbcr lzw", lambda t: mk.encode_tiff_ycbcr(ycc, 2, 2, 5, rows_per_strip=16, tags=t))]
    return out


def _ifd_tags(data: bytes) -> set:
    e = "<" if data[:2] == b"II" else ">"
    ifd = struct.unpack(e + "I", data[4:8])[0]
    n = struct.unpack(e + "H", data[ifd:ifd + 2])[0]
    return {struct.unpack(e + "H", data[ifd + 2 + 12 * i:ifd + 4 + 12 * i])[0]
            for i in range(n)}


def repeated_tag_corpus(seed: int, per_tag: int = 2):
    """(name, data) of the corpus: each base file with each libtiff-read
    tag it has written again after it, ``per_tag`` random values each."""
    rng = np.random.default_rng(seed)
    for name, build in _bases(rng):
        base = build([])
        present = _ifd_tags(base)
        for tag, typ in TAG_TYPES.items():
            if tag not in present:
                continue
            for _ in range(per_tag):
                vals = _second_value(tag, rng, len(base))
                yield f"{name}, {tag} again = {vals[:3]}", build([(tag, typ, vals)])


@pytest.mark.parametrize("seed", range(6))
def test_repeated_tag_corpus_matches_pil(seed, tmp_path):
    """Every compression the port reads, each libtiff-read tag its file has
    written a second time with a random value: PIL routes, sizes and
    unpacks by the last entry, libtiff decodes by the first, and the port
    gives PIL's outcome (a chunky tile row longer than libtiff's, which PIL
    reads past its tile buffer, is refused naming that)."""
    files = list(repeated_tag_corpus(seed))
    results = [_agrees(d, tmp_path / "f.tif", allow_refused=True) for _, d in files]
    faults = [f"{n}: {r}" for (n, _), r in zip(files, results) if r not in ("", "refused")]
    assert not faults, faults[:5]
    assert len(files) > 200 and results.count("refused") < len(files) // 20
    print({"seed": seed, "files": len(files), "refused_pil_reads": results.count("refused"),
           "disagreements": len(faults)})


MOTIVATION_ROWS = {
    **{f"raw, a second Compression {c}": (lambda g, c=c: mk.encode_tiff(g, tags=[(259, 3, [c])]),
                                          "ok") for c in (5, 7, 8, 2, 34925)},
    "LZW, a second Compression 8": (
        lambda g: mk.encode_tiff(g, compression=5, tags=[(259, 3, [8])]), "ok"),
    "Deflate, a second Compression 5": (
        lambda g: mk.encode_tiff(g, compression=8, tags=[(259, 3, [5])]), "ok"),
    "LZW with predictor 2, a second Predictor 1": (
        lambda g: mk.encode_tiff(g, compression=5, predictor=2, tags=[(317, 3, [1])]), "ok"),
    "LZW, a second RowsPerStrip 4": (
        lambda g: mk.encode_tiff(g, compression=5, tags=[(278, 4, [4])]), "ok"),
    "Deflate in 4-row strips, a second RowsPerStrip 16": (
        lambda g: mk.encode_tiff(g, compression=8, rows_per_strip=4, tags=[(278, 4, [16])]),
        "ok"),
    "16-bit LZW, a second BitsPerSample 8": (
        lambda g: mk.encode_tiff(g.astype(np.int64) * 200, bits=16, compression=5,
                                 tags=[(258, 3, [8])]), "error"),
}


@pytest.mark.parametrize("row", sorted(MOTIVATION_ROWS))
def test_repeated_tag_cases(row, tmp_path):
    """Named files of one repeated tag: an 8-bit 16 × 16 gray file (16-bit
    where named) reads as PIL reads it, the decoded pixels where PIL reads
    (libtiff's first entry decoding, PIL's last routing), an IOError where
    Pillow finds libtiff's rows another size than its raw mode's."""
    build, want = MOTIVATION_ROWS[row]
    g = mk.scene(16, 16, 1)
    data = build(g)
    assert _pil(data)[0] == want
    assert _agrees(data, tmp_path / "f.tif") == ""
    if want == "ok":
        np.testing.assert_array_equal(native.decode_u8(data), g)


# -------------------------------------------------------- damaged IFDs
def _patch_entry(data: bytes, tag: int, type_=None, count=None, value=None, new_tag=None):
    """``data`` with the first IFD entry of ``tag`` given another tag,
    type, count or value field (a classic TIFF)."""
    e = "<" if data[:2] == b"II" else ">"
    ifd = _ifd_at(data)
    n = struct.unpack(e + "H", data[ifd:ifd + 2])[0]
    d = bytearray(data)
    for i in range(n):
        at = ifd + 2 + 12 * i
        if struct.unpack(e + "H", d[at:at + 2])[0] != tag:
            continue
        if new_tag is not None:
            d[at:at + 2] = struct.pack(e + "H", new_tag)
        if type_ is not None:
            d[at + 2:at + 4] = struct.pack(e + "H", type_)
        if count is not None:
            d[at + 4:at + 8] = struct.pack(e + "I", count)
        if value is not None:
            d[at + 8:at + 12] = value
        return bytes(d)
    raise KeyError(tag)


# one IFD entry changed as a damaged file might change it, and what libtiff
# (its first-entry view, TIFFReadDirectory, TIFFFetchStripThing,
# EstimateStripByteCounts) or PIL (its Python values) then does
DAMAGED_IFD = {
    "SamplesPerPixel of 3 values": dict(tag=277, count=3),
    "PlanarConfiguration of 5": dict(tag=284, value=struct.pack("<HH", 5, 0)),
    "SamplesPerPixel as UNDEFINED": dict(tag=277, type_=7),
    "Photometric as BYTE": dict(tag=262, type_=1),
    "ImageWidth as SBYTE 0": dict(tag=256, type_=6, value=bytes(4)),
    "RowsPerStrip of 2^31": dict(tag=278, value=struct.pack("<I", 1 << 31)),
    "StripOffsets counted past the strips": dict(tag=273, count=40),
    "StripByteCounts renamed": dict(tag=279, new_tag=280),
    "StripByteCounts of 0": dict(tag=279, value=bytes(4)),
    "Predictor as ASCII": dict(tag=317, type_=2),
}


@pytest.mark.parametrize("case", sorted(DAMAGED_IFD))
@pytest.mark.parametrize("compression", [34925, 50000])
def test_damaged_ifd_cases(case, compression, tmp_path):
    """An LZMA or ZSTD strip file (one strip: 12 × 20 little-endian, with
    predictor 2) with one IFD entry changed: the port gives PIL's outcome
    (libtiff rejecting what it must read, dropping what it can recover
    from, reading no more strile values than strips, estimating missing
    byte counts; PIL holding a BYTE or ASCII value as bytes or str)."""
    g = mk.scene(12, 20, compression)
    data = mk.encode_tiff(g, compression=compression, predictor=2)
    assert _agrees(_patch_entry(data, **DAMAGED_IFD[case]), tmp_path / "f.tif") == ""


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("photometric", [0, 1, 2])
def test_webp_and_sgilog_are_refused_naming_them(photometric, tmp_path):
    """A TIFF of WebP strips (Pillow's libtiff has no WebP codec) and of
    SGILog on a photometric other than LogL / LogLuv (libtiff: "Inappropriate
    photometric interpretation"): PIL fails, the port raises
    NotImplementedError naming the compression; SGILog on LogL is PIL's
    unknown pixel mode (the port's ValueError-like refusal of the mode)."""
    g = mk.scene(8, 8, photometric)
    img = mk.scene(8, 8, 2, 3) if photometric == 2 else g
    webp = mk._pil_save(Image.fromarray(g), "WEBP", lossless=True)
    for compression, word, codec in ((50001, "WebP", lambda blk: webp),
                                     (34676, "SGILog", None), (34677, "SGILog", None)):
        data = mk.encode_tiff(img, photometric=photometric, compression=compression,
                              codec=codec or (lambda blk: blk.astype(np.uint8).tobytes()))
        assert _pil(data)[0] == "error"
        with pytest.raises(NotImplementedError, match=word) as e:
            native.decode_u8(data)
        assert "PIL reads it" not in str(e.value)
    logl = mk.encode_tiff(g, photometric=32844, compression=34676,
                          codec=lambda blk: blk.astype(np.uint8).tobytes())
    assert _pil(logl)[0] == "value"
    with pytest.raises(NotImplementedError, match="unknown pixel mode"):
        native.decode_u8(logl)


# ------------------------------------------------------------- fixtures
def test_tiff_compression_fixtures_regenerate_byte_for_byte():
    """The LZMA, ZSTD, ThunderScan, repeated-tag, WebP and SGILog fixtures
    and the ZSTD pair of the 752×480 sequence are what
    ``torch_make_image_kinds`` writes, byte for byte (libzstd, liblzma)."""
    import os

    root = os.path.join(os.path.dirname(__file__), "fixtures", "image_kinds")
    files = {**mk.tiff_compression_files(0), **mk.zstd_pair_files(mk.first_pair())}
    for name, (data, *_) in files.items():
        with open(os.path.join(root, name), "rb") as f:
            assert f.read() == data, name
