"""Random GIFs and WebPs through every CPU route of the port's reader
(``png.read_gray``, ``native.decode_u8``, ``native.image_size`` and a
``NativeStereoLoader``),
each held to PIL's ``Image.open(p).convert("L")`` bit for bit; where PIL
raises, every route raises.

GIFs come from PIL's writer (2-256 colours, interlaced, transparent,
animated) and from ``torch_make_image_kinds.encode_gif`` for what PIL never
writes: identity palettes (global and local), a local palette over a
global one, frame 0 past the screen or inside it, code sizes 2-8, no End
code, early End codes, cut streams, blocks before the image. WebPs come
from PIL's writer (lossless and lossy, quality 0-100, method 0-6, alpha
quality, exact, animated), from libwebp's own encoder through ctypes for
the VP8 options PIL cannot reach (the simple filter, sharpness, 2-8 token
partitions, one segment, filter strength 0, raw alpha; skipped where this
Pillow bundles no libwebp), from the numpy-only VP8L writer, and as
hand-built containers (frame 0 at an offset, and the container faults
libwebp's demuxer refuses).
"""

import io

import numpy as np
import pytest
import torch_make_image_kinds as mk
from PIL import Image

from rspl_slam_tpu_torch import native, png


def _pil(data: bytes):
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("L"))
    except Exception:
        return None


def _save(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _every_route(tmp_path, files):
    """Each (name, bytes) of ``files`` through the three routes: PIL's
    pixels exactly, or an error on each route where PIL raises."""
    for name, data in files:
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        ref = _pil(data)
        if ref is None:
            for call in (lambda: png.read_gray(path), lambda: native.decode_u8(data)):
                with pytest.raises((ValueError, OSError, NotImplementedError)):
                    call()
            try:  # a header that reads gives the loader its size; it then fails
                shape = tuple(max(2, v) for v in native.image_size(data))
            except (ValueError, OSError, NotImplementedError):
                shape = (8, 8)
            with pytest.raises((ValueError, OSError, NotImplementedError)):
                with native.NativeStereoLoader([path], [path], *shape) as loader:
                    next(loader)
            continue
        assert native.image_size(data) == ref.shape, name
        np.testing.assert_array_equal(png.read_gray(path), ref, err_msg=name)
        np.testing.assert_array_equal(native.decode_u8(data), ref, err_msg=name)
        if min(ref.shape) < 2:  # the loader takes frames of 2×2 and more
            continue
        with native.NativeStereoLoader([path], [path], *ref.shape) as loader:
            (_, left, right), = list(loader)
        np.testing.assert_array_equal(left, ref.astype(np.float32) / 255.0, err_msg=name)
        np.testing.assert_array_equal(right, left, err_msg=name)


# ------------------------------------------------------------------- GIF
def _random_gif(rng) -> bytes:
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    cs = int(rng.integers(2, 9))
    idx = rng.integers(0, 1 << cs, (h, w))
    if rng.random() < 0.3:
        idx = np.minimum(idx, int(rng.integers(1, 4)))
    n = 1 << int(rng.integers(1, 9))
    pal = rng.integers(0, 256, (n, 3))
    ident = np.stack([np.arange(n)] * 3, 1)
    kw = dict(code_size=cs, interlace=bool(rng.random() < 0.4))
    r = rng.random()
    if r < 0.25:
        kw["palette"] = ident
    elif r < 0.75:
        kw["palette"] = pal
    if rng.random() < 0.35:
        kw["local_palette"] = ident if rng.random() < 0.5 else pal[::-1]
    if rng.random() < 0.3:
        kw["transparency"] = int(rng.integers(0, 256))
    if rng.random() < 0.4:
        kw["screen"] = (int(rng.integers(1, 50)), int(rng.integers(1, 50)))
        kw["offset"] = (int(rng.integers(0, 10)), int(rng.integers(0, 10)))
    if rng.random() < 0.2:
        kw["end_code"] = False
    if rng.random() < 0.1:
        kw["end_after"] = int(rng.integers(1, 20))
    if rng.random() < 0.1:
        kw["cut"] = int(rng.integers(0, 30))
    if rng.random() < 0.2:
        kw["extensions"] = [(254, [b"a comment", b"!"]), (255, [b"NETSCAPE2.0", b"\x01\x00\x00"]),
                            (1, b"text"), (249, b"\x00\x0a\x00\x00")]
    if rng.random() < 0.1:
        kw["stray"] = b"\x07\x00"
    if rng.random() < 0.2:
        kw["frames"] = [(rng.integers(0, 4, (3, 3)), (1, 1))]
    return mk.encode_gif(idx, **kw)


@pytest.mark.parametrize("seed", range(12))
def test_random_gifs_from_the_encoder_match_pil(tmp_path, seed):
    """Eight random GIFs per seed from the encoder: identity palettes,
    local palettes, frame 0 off the screen's origin or past it, code sizes
    2-8, interlace, transparency fill, missing or early End codes, cut
    streams, extension blocks, a second frame."""
    rng = np.random.default_rng([18, seed])
    _every_route(tmp_path, [(f"g{i}.gif", _random_gif(rng)) for i in range(8)])


@pytest.mark.parametrize("colors", [2, 3, 16, 200, 256])
@pytest.mark.parametrize("kind", ["plain", "interlaced", "transparent", "animated"])
def test_pil_written_gifs_match_pil(tmp_path, colors, kind):
    """PIL's own GIFs of 2-256 colours: plain, interlaced, with a
    transparency index, and animated (frame 0)."""
    frames = [Image.fromarray(mk.scene(30, 41, colors + k, 3)).quantize(colors)
              for k in range(3)]
    kw = {"plain": {}, "interlaced": dict(interlace=True), "transparent": dict(transparency=1),
          "animated": dict(save_all=True, append_images=frames[1:], disposal=2)}[kind]
    _every_route(tmp_path, [("p.gif", _save(frames[0], "GIF", **kw))])


def test_gif_end_codes_as_pils_reads_feed_them(tmp_path):
    """An End code before the last row ends one call of PIL's decoder: with
    the file's rest read already, PIL raises ("image file is truncated");
    past its first 65536-byte read, the next read continues the code
    stream and the image fills, unless the stream runs out first."""
    rng = np.random.default_rng(18)
    small = rng.integers(0, 256, (20, 30))
    big = rng.integers(0, 256, (400, 400))
    pal = rng.integers(0, 256, (256, 3))
    files = [(f"s{k}.gif", mk.encode_gif(small, palette=pal, end_after=k)) for k in (1, 50)]
    files += [(f"b{k}.gif", mk.encode_gif(big, palette=pal, end_after=k))
              for k in (10, 60_000, 150_000)]
    assert _pil(files[0][1]) is None and _pil(files[2][1]) is not None
    assert _pil(files[-1][1]) is None
    _every_route(tmp_path, files)


# ------------------------------------------------------------------ WebP
@pytest.mark.parametrize("seed", range(16))
def test_random_webps_from_pil_match_pil(tmp_path, seed):
    """Four random WebPs per seed from PIL's writer: gray, RGB or RGBA,
    lossless or lossy, quality 0-100, method 0-6, alpha quality, exact, at
    random sizes (1-90 pixels a side), smooth or noisy content."""
    rng = np.random.default_rng([18, 1, seed])
    files = []
    for i in range(4):
        H, W = int(rng.integers(1, 70)), int(rng.integers(1, 90))
        ch = int(rng.choice([1, 3, 4]))
        a = mk.scene(H, W, seed * 10 + i, ch) if ch > 1 else mk.scene(H, W, seed * 10 + i)
        if rng.random() < 0.3:
            a = rng.integers(0, 256, a.shape, dtype=np.uint8)
        kw = dict(quality=int(rng.integers(0, 101)), method=int(rng.integers(0, 7)))
        if rng.random() < 0.3:
            kw["lossless"] = True
        if ch == 4 and rng.random() < 0.5:
            kw["alpha_quality"] = int(rng.integers(0, 101))
        if rng.random() < 0.3:
            kw["exact"] = True
        im = Image.fromarray(a, {1: "L", 3: "RGB", 4: "RGBA"}[ch])
        files.append((f"w{i}.webp", _save(im, "WEBP", **kw)))
    _every_route(tmp_path, files)


@pytest.mark.parametrize("kind", ["lossy", "lossless", "lossy_alpha"])
def test_animated_webps_read_frame_0(tmp_path, kind):
    """Frame 0 of an animation: PIL's own (three frames) and one assembled
    with frame 0 at an offset on a larger canvas, the rest of the canvas
    zero."""
    a = [mk.scene(30, 40, 60 + k, 4) for k in range(3)]
    mode = "RGBA" if kind == "lossy_alpha" else "RGB"
    frames = [Image.fromarray(x if mode == "RGBA" else x[..., :3], mode) for x in a]
    kw = dict(lossless=True) if kind == "lossless" else dict(quality=70)
    still = _save(frames[0], "WEBP", **kw)
    flags = 0x12 if kind == "lossy_alpha" else 0x02
    _every_route(tmp_path, [
        ("pil.webp", _save(frames[0], "WEBP", save_all=True, append_images=frames[1:], **kw)),
        ("offset.webp", mk.webp_animation((56, 44), [(still, 8, 12), (still, 0, 0)], flags))])


LIBWEBP = mk.libwebp()
VP8_OPTIONS = {
    "simple_filter": dict(filter_type=0, filter_strength=70),
    "simple_filter_sharp": dict(filter_type=0, filter_strength=100, filter_sharpness=5),
    "sharpness_7": dict(filter_sharpness=7, filter_strength=90),
    "partitions_2": dict(partitions=1, low_memory=1),
    "partitions_4": dict(partitions=2, method=1),
    "partitions_8_simple": dict(partitions=3, low_memory=1, filter_type=0),
    "one_segment": dict(segments=1),
    "filter_strength_0": dict(filter_strength=0),
    "raw_alpha": dict(alpha_compression=0, alpha_filtering=0),
    "alpha_filter_best": dict(alpha_filtering=2, alpha_quality=40),
}


@pytest.mark.skipif(LIBWEBP is None, reason="this Pillow bundles no libwebp to encode with")
@pytest.mark.parametrize("option", sorted(VP8_OPTIONS))
def test_vp8_features_pils_writer_cannot_reach_match_pil(tmp_path, option):
    """Lossy WebPs from libwebp's own encoder with options PIL's ``save``
    does not pass: each option at three qualities and sizes."""
    rng = np.random.default_rng([18, 2, sorted(VP8_OPTIONS).index(option)])
    files = []
    for i, q in enumerate((5.0, 50.0, 95.0)):
        H, W = int(rng.integers(8, 100)), int(rng.integers(8, 100))
        px = mk.scene(H, W, i, 4 if "alpha" in option else 3)
        files.append((f"v{i}.webp", mk.libwebp_encode(LIBWEBP, px, quality=q, **VP8_OPTIONS[option])))
    _every_route(tmp_path, files)


def test_the_vp8l_writer_matches_pil(tmp_path):
    """The numpy-only VP8L writer (the smoke writes its trees with it):
    flat, smooth and noisy gray frames."""
    rng = np.random.default_rng(18)
    frames = [np.full((5, 7), 77, np.uint8), mk.scene(33, 47, 1),
              rng.integers(0, 256, (20, 30), dtype=np.uint8), mk.scene(1, 1, 2)]
    _every_route(tmp_path, [(f"l{i}.webp", mk.encode_vp8l_gray(f)) for i, f in enumerate(frames)])


def test_webp_container_faults_as_libwebps_demuxer_sees_them(tmp_path):
    """The container: trailing bytes past the RIFF size, unknown and
    metadata chunks, an odd chunk's padding read; a file shorter than its
    RIFF size, a chunk past the RIFF, a still frame other than the VP8X
    canvas, an animation frame past the canvas, unknown VP8X flags, ALPH
    before VP8L, two images in a still file, ANMF before ANIM: PIL and the
    port both raise."""
    rgb = mk.scene(20, 30, 5, 3)
    lossy = _save(Image.fromarray(rgb), "WEBP", quality=60)
    lossless = _save(Image.fromarray(rgb), "WEBP", lossless=True)
    vp8 = dict(mk.webp_chunks(lossy))[b"VP8 "]
    vp8l = dict(mk.webp_chunks(lossless))[b"VP8L"]
    alpha = dict(mk.webp_chunks(_save(Image.fromarray(mk.scene(20, 30, 6, 4), "RGBA"), "WEBP",
                                      quality=60)))[b"ALPH"]

    def vp8x(flags, w=30, h=20):
        return mk.riff_chunk(b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
                             + (h - 1).to_bytes(3, "little"))

    C = mk.riff_chunk
    files = {
        "trailing": lossy + b"junk after the RIFF",
        "metadata": mk.riff_webp(vp8x(0x2C) + C(b"ICCP", b"icc") + C(b"EXIF", b"Exif\0\0")
                                 + C(b"ZZZZ", b"odd") + C(b"VP8 ", vp8) + C(b"XMP ", b"<x/>")),
        "odd_padding": mk.riff_webp(C(b"VP8L", vp8l + (b"" if len(vp8l) % 2 else b"\0"))),
        "short_file": lossy[:-5],
        "chunk_past_riff": lossy[:16] + (len(vp8) + 99).to_bytes(4, "little") + lossy[20:],
        "canvas_mismatch": mk.riff_webp(vp8x(0, 31, 20) + C(b"VP8 ", vp8)),
        "frame_past_canvas": mk.webp_animation((30, 20), [(lossy, 2, 0)]),
        "bad_flags": mk.riff_webp(vp8x(0x01) + C(b"VP8 ", vp8)),
        "alph_before_vp8l": mk.riff_webp(vp8x(0x10) + C(b"ALPH", alpha) + C(b"VP8L", vp8l)),
        "alph_dropped": mk.riff_webp(vp8x(0) + C(b"ALPH", b"\x03garbage") + C(b"VP8 ", vp8)),
        "two_images": mk.riff_webp(vp8x(0) + C(b"VP8 ", vp8) + C(b"VP8 ", vp8)),
        "anmf_first": mk.riff_webp(vp8x(0x02) + mk.webp_animation((30, 20), [(lossy, 0, 0)])[30:]),
    }
    assert _pil(files["trailing"]) is not None and _pil(files["short_file"]) is None
    _every_route(tmp_path, [(f"{k}.webp", v) for k, v in files.items()])


def test_full_size_frames_match_pil(tmp_path):
    """752×480 frames of the smoke's kind: GIF with an identity palette
    (gray), lossless WebP from the VP8L writer and from PIL, lossy WebP at
    quality 90 and 30."""
    g = mk.scene(480, 752, 18)
    ident = np.stack([np.arange(256)] * 3, 1)
    im = Image.fromarray(g)
    _every_route(tmp_path, [
        ("f.gif", mk.encode_gif(g, palette=ident)), ("w.webp", mk.encode_vp8l_gray(g)),
        ("l.webp", _save(im, "WEBP", lossless=True)), ("q90.webp", _save(im, "WEBP", quality=90)),
        ("q30.webp", _save(im, "WEBP", quality=30))])


MUTATED_BASES = ("lossy_8_partitions", "lossy_alpha", "lossless", "gif")


@pytest.mark.parametrize("base", MUTATED_BASES)
def test_mutated_files_agree_with_pil(tmp_path, base):
    """300 copies of one valid file, each with 1-3 bytes flipped or
    replaced (mostly past the headers): where PIL reads a copy, every
    route gives its pixels; where it raises, every route raises. Such
    flips found the two libwebp behaviours the port keeps (VP8
    coefficients past an encoder's range wrap in its 16-bit SIMD
    transform; an alpha plane on its 8-bit path may be read past its end
    once every pixel is decoded); the fixtures ``webp_coefficient_wrap``
    and ``webp_alpha_past_end`` pin one case of each."""
    rng = np.random.default_rng([18, 3, MUTATED_BASES.index(base)])
    rgb = mk.scene(60, 80, 7, 3)
    rgba = np.dstack([rgb, mk.scene(60, 80, 8)])
    data = {
        "lossy_8_partitions": lambda: _save(Image.fromarray(rgb), "WEBP", quality=40)
        if LIBWEBP is None else mk.libwebp_encode(LIBWEBP, rgb, quality=40.0, partitions=3,
                                                  low_memory=1),
        "lossy_alpha": lambda: _save(Image.fromarray(rgba, "RGBA"), "WEBP", quality=60,
                                     alpha_quality=30),
        "lossless": lambda: _save(Image.fromarray(rgb), "WEBP", lossless=True, method=6),
        "gif": lambda: mk.encode_gif(rng.integers(0, 256, (40, 50)),
                                     palette=rng.integers(0, 256, (256, 3)), interlace=True),
    }[base]()
    files = []
    for i in range(300):
        x = bytearray(data)
        lo = 40 if rng.random() < 0.8 else 0
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(lo, len(x)))
            if rng.random() < 0.8:
                x[k] ^= 1 << int(rng.integers(0, 8))
            else:
                x[k] = int(rng.integers(0, 256))
        files.append((f"m{i}", bytes(x)))
    _every_route(tmp_path, files)
