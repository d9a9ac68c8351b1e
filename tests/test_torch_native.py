"""The port's native runtime (``rspl_slam_tpu_torch/native.py``, host C++ in
``csrc/native_runtime.cpp``) against PIL and the JAX package's native
runtime: JAX's ``tests/test_native.py`` cases through both packages, and
every image kind the JAX package reads (through PIL) bit for bit.

What "bit for bit" means here. The port decodes to PIL's
``Image.open(p).convert("L")`` as 8-bit gray, and ``decode_gray`` divides
by 255 in float32 as ``datasets.EurocDataset`` does. The JAX package's
native ``decode_gray`` multiplies by ``1/255f`` instead, which lies one
float32 ulp away on 126 of the 256 levels: its frames are compared on the
8-bit levels they encode (``rint(x · 255)``). On colour and 16-bit files
the JAX native reader does not give PIL's frames at all (libpng's
simplified API converts to gray in linear light and gamma-encodes 16-bit
gray; libjpeg's ``JCS_GRAYSCALE`` returns the Y plane):
``test_jax_native_differs_from_pil_on_colour_and_16_bit`` asserts that
divergence as a measured fact, which the port does not copy (ROADMAP.md
§3).
"""

import hashlib
import io
import os
import re
import struct
import subprocess
import sys
import warnings
import zlib

import numpy as np
import pytest
import torch
from test_torch_common import report

from rspl_slam_tpu_torch import camera as tcamera
from rspl_slam_tpu_torch import native, png
from rspl_slam_tpu_torch.config import load_camera_config
from rspl_slam_tpu_torch.datasets import EurocDataset
from rspl_slam_tpu_torch.ops import lines as tl

Image = pytest.importorskip("PIL.Image")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHOTO = os.path.join(ROOT, "tests", "fixtures", "real_photo.jpg")
# sha256 of PIL's Image.open(PHOTO).convert("L") bytes, (600, 512) uint8;
# chip_smoke.py pins the same value for the card's machine, which has no PIL
REAL_PHOTO_L_SHA256 = "d6dc0d4bd9642ce0a87f5d9bcc25d30a934174aaadcec069e026a87da6604a10"


def _pil_gray(path_or_bytes) -> np.ndarray:
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    with Image.open(src) as im:
        return np.asarray(im.convert("L"))


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native runtime; skips where it cannot be built
    (its tests skip there too)."""
    from rspl_slam_tpu import native as jn

    if not jn.available():
        pytest.skip("the JAX package's native runtime is not built")
    return jn


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """JAX's fixture: six 48×64 random 8-bit gray PNGs written by PIL."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        img = (rng.uniform(size=(48, 64)) * 255).astype(np.uint8)
        p = str(d / f"{i}.png")
        Image.fromarray(img).save(p)
        paths.append((p, img))
    return paths


def _levels(x: np.ndarray) -> np.ndarray:
    return np.rint(x * 255.0).astype(np.uint8)


# ------------------------------------------------------------- PNG writer
def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _pack_rows(samples: np.ndarray, depth: int) -> list:
    """(rows, values) ints → each row's bytes at ``depth`` bits (MSB first)."""
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in samples]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in samples]
    per = 8 // depth
    out = []
    for r in samples:
        r = np.concatenate([r, np.zeros(-len(r) % per, r.dtype)]).reshape(-1, per)
        b = np.zeros(len(r), np.int64)
        for k in range(per):
            b |= r[:, k].astype(np.int64) << (8 - depth * (k + 1))
        out.append(b.astype(np.uint8).tobytes())
    return out


ADAM7 = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2)]


def png_bytes(arr: np.ndarray, depth: int, ctype: int, interlace: bool = False,
              plte: bytes = None, trns: bytes = None, seed: int = 0) -> bytes:
    """Any PNG kind PIL cannot write (16-bit colour, 1/2/4-bit gray, Adam7):
    rows filtered None or Sub at random, IDAT split in two."""
    rng = np.random.default_rng(seed)
    H, W = arr.shape[:2]
    ch = arr.shape[2] if arr.ndim == 3 else 1
    bpp = max(1, ch * depth // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else [(0, 0, 1, 1)]):
        sub = arr[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        for row in _pack_rows(sub.reshape(sub.shape[0], -1), depth):
            b = np.frombuffer(row, np.uint8).astype(np.int64)
            if rng.integers(2):
                raw += b"\x01" + ((b - np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]]))
                                  & 255).astype(np.uint8).tobytes()
            else:
                raw += b"\x00" + row
    z = zlib.compress(raw, 9)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                                             0, 0, int(interlace)))
    if plte is not None:
        out += _chunk(b"PLTE", plte)
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return (out + _chunk(b"IDAT", z[: len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
            + _chunk(b"IEND", b""))


def _decode_file(tmp_path, name: str, data: bytes) -> tuple:
    """(port's read_gray, PIL's convert("L")) of ``data`` written to a file."""
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return png.read_gray(p), _pil_gray(p)


# ------------------------------------------------------------------ decode
class TestDecode:
    def test_png_matches_jax_native_and_pil(self, png_dir, jax_native):
        """8-bit gray PNG (EuRoC's format): the port's decode equals PIL's
        bit for bit, its float frames are the 8-bit levels / 255 in float32
        (EurocDataset's frames), and JAX native's frames encode the same
        levels within one float32 ulp."""
        for p, img in png_dir:
            out = native.decode_gray(p, 48, 64)
            np.testing.assert_array_equal(_levels(out), img)
            np.testing.assert_array_equal(out, img.astype(np.float32) / 255.0)
            jx = jax_native.decode_gray(p, 48, 64)
            np.testing.assert_array_equal(_levels(jx), img)
            np.testing.assert_array_max_ulp(out, jx, maxulp=1)

    @pytest.mark.parametrize("subsampling", ["gray", "4:4:4", "4:2:2", "4:2:0"])
    @pytest.mark.parametrize("quality", [50, 95])
    def test_jpeg_matches_pil(self, subsampling, quality, tmp_path):
        """Baseline JPEGs written by PIL (odd sizes, so the last MCU row and
        column are partial; smooth content and noise; with and without
        restart markers) decode to PIL's convert("L") bit for bit."""
        rng = np.random.default_rng(quality)
        for H, W in ((29, 37), (45, 67), (3, 5)):
            ch = 1 if subsampling == "gray" else 3
            smooth = np.clip(np.cumsum(rng.normal(0, 8, (H, W, ch)), 1) + 128, 0, 255)
            noise = rng.integers(0, 256, (H, W, ch))
            for k, arr in enumerate((smooth, noise)):
                im = Image.fromarray(arr.astype(np.uint8).squeeze(-1) if ch == 1
                                     else arr.astype(np.uint8))
                kw = {} if ch == 1 else {"subsampling": subsampling}
                for rst in ({}, {"restart_marker_blocks": 2}):
                    buf = io.BytesIO()
                    im.save(buf, "JPEG", quality=quality, **kw, **rst)
                    got, ref = _decode_file(tmp_path, f"{H}_{k}.jpg", buf.getvalue())
                    np.testing.assert_array_equal(got, ref, err_msg=f"{H}×{W} {k} {rst}")

    def test_real_photo_matches_pil_and_its_hash(self):
        """The repo's photograph (baseline 4:2:0 RGB JPEG, 512×600): the
        port's decode equals PIL's bit for bit and hashes to the pinned
        REAL_PHOTO_L_SHA256, which chip_smoke.py checks on the card's
        machine."""
        got = png.read_gray(PHOTO)
        ref = _pil_gray(PHOTO)
        assert got.shape == (600, 512)
        np.testing.assert_array_equal(got, ref)
        assert hashlib.sha256(ref.tobytes()).hexdigest() == REAL_PHOTO_L_SHA256
        assert hashlib.sha256(got.tobytes()).hexdigest() == REAL_PHOTO_L_SHA256
        np.testing.assert_array_equal(native.decode_gray(PHOTO, 600, 512),
                                      got.astype(np.float32) / 255.0)
        with open(os.path.join(ROOT, "chip_smoke.py")) as f:
            pinned = re.search(r'^REAL_PHOTO_L_SHA256 = "([0-9a-f]+)"', f.read(), re.M)
        assert pinned and pinned.group(1) == REAL_PHOTO_L_SHA256

    def test_jax_native_differs_from_pil_on_colour_and_16_bit(self, tmp_path, jax_native):
        """The JAX package's native reader against PIL (its own dataset
        reader): equal on 8-bit gray PNG, different on RGB PNG, 16-bit gray
        PNG and the photo. The port equals PIL on all four."""
        rng = np.random.default_rng(3)
        files = {}
        Image.fromarray(rng.integers(0, 256, (32, 40), dtype=np.uint8)).save(
            str(tmp_path / "gray8.png"))
        Image.fromarray(rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)).save(
            str(tmp_path / "rgb8.png"))
        Image.fromarray(rng.integers(0, 65536, (32, 40), dtype=np.uint16)).save(
            str(tmp_path / "gray16.png"))
        for name in ("gray8.png", "rgb8.png", "gray16.png"):
            files[name] = str(tmp_path / name)
        files["real_photo.jpg"] = PHOTO
        lsb = {}
        for name, p in files.items():
            ref = _pil_gray(p)
            np.testing.assert_array_equal(png.read_gray(p), ref, err_msg=name)
            jx = _levels(jax_native.decode_gray(p, *ref.shape))
            lsb[name] = int(np.abs(jx.astype(int) - ref.astype(int)).max())
        report("jax_native_vs_pil_lsb", **lsb)
        assert lsb["gray8.png"] == 0
        assert lsb["rgb8.png"] > 0 and lsb["gray16.png"] > 0 and lsb["real_photo.jpg"] > 0

    @pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
    def test_png_kinds_match_pil(self, interlace, tmp_path):
        """Every colour type at every bit depth PNG allows (palette with a
        short PLTE and tRNS, 1/2/4/16-bit gray, 16-bit gray + alpha, RGB and
        RGBA), plain and Adam7-interlaced, at sizes below and above one
        8×8 interlace tile: PIL's convert("L") bit for bit."""
        rng = np.random.default_rng(int(interlace))
        n = 0
        for H, W in ((1, 1), (3, 5), (9, 13), (29, 37)):
            for depth in (1, 2, 4, 8, 16):
                a = rng.integers(0, 2 ** depth, (H, W))
                got, ref = _decode_file(tmp_path, "g.png", png_bytes(a, depth, 0, interlace))
                np.testing.assert_array_equal(got, ref, err_msg=f"gray{depth} {H}×{W}")
                n += 1
            for depth in (1, 2, 4, 8):
                npal = int(rng.integers(1, 2 ** depth + 1))
                a = rng.integers(0, npal, (H, W))
                plte = rng.integers(0, 256, 3 * npal, dtype=np.uint8).tobytes()
                with warnings.catch_warnings():  # PIL: "Palette images with Transparency"
                    warnings.simplefilter("ignore", UserWarning)
                    got, ref = _decode_file(tmp_path, "p.png",
                                            png_bytes(a, depth, 3, interlace, plte, b"\x00\x80"))
                np.testing.assert_array_equal(got, ref, err_msg=f"palette{depth} {H}×{W}")
                n += 1
            for depth in (8, 16):
                for ctype, ch in ((2, 3), (4, 2), (6, 4)):
                    a = rng.integers(0, 2 ** depth, (H, W, ch))
                    got, ref = _decode_file(tmp_path, "c.png",
                                            png_bytes(a, depth, ctype, interlace))
                    np.testing.assert_array_equal(got, ref, err_msg=f"ct{ctype}/{depth} {H}×{W}")
                    n += 1
        assert n == 4 * 15

    def test_16_bit_samples_as_pil_reads_them(self, tmp_path):
        """16-bit gray clips at 255 (PIL's I;16 → L); 16-bit RGB keeps the
        high byte of each sample before the luma."""
        got, ref = _decode_file(tmp_path, "g16.png", png_bytes(
            np.array([[0, 100, 255, 256, 1000, 65535]]), 16, 0))
        np.testing.assert_array_equal(got, [[0, 100, 255, 255, 255, 255]])
        np.testing.assert_array_equal(got, ref)
        got, ref = _decode_file(tmp_path, "c16.png", png_bytes(
            np.array([[[0x1234, 0xFF00, 0x00FF]]]), 16, 2))
        assert int(got[0, 0]) == (18 * 19595 + 255 * 38470 + 0 * 7471 + 0x8000) >> 16
        np.testing.assert_array_equal(got, ref)

    def test_unsupported_jpeg_raises(self, tmp_path):
        """A progressive JPEG, which raised before, reads as PIL reads it on
        both routes; a 12-bit and a DNL-height JPEG, which PIL refuses too,
        raise NotImplementedError naming the kind, and no other reader takes
        over (tests/test_torch_image_kinds.py holds every kind)."""
        p = str(tmp_path / "prog.jpg")
        img = np.random.default_rng(0).integers(0, 256, (16, 16, 3), dtype=np.uint8)
        Image.fromarray(img).save(p, progressive=True)
        ref = _pil_gray(p)
        np.testing.assert_array_equal(png.read_gray(p), ref)
        np.testing.assert_array_equal(native.decode_gray(p, 16, 16), ref.astype(np.float32) / 255)
        for name, word in (("jpeg_12bit.jpg", "not 8-bit"), ("jpeg_dnl.jpg", "DNL")):
            q = os.path.join(os.path.dirname(__file__), "fixtures", "image_kinds", name)
            with pytest.raises(NotImplementedError, match=word):
                png.read_gray(q)
            with pytest.raises(NotImplementedError, match=word):
                native.decode_gray(q, 48, 64)

    def test_wrong_size_fails(self, png_dir):
        p, _ = png_dir[0]
        with pytest.raises(IOError):
            native.decode_gray(p, 100, 100)
        with pytest.raises(IOError):
            native.decode_gray(p + ".missing", 48, 64)

    def test_corrupt_data_raises(self, png_dir):
        """A flipped byte in the compressed data breaks the zlib stream
        (the IDAT's CRC is not checked: PIL raises "broken data stream" on
        these bytes too); a truncated JPEG runs out of markers."""
        with open(png_dir[0][0], "rb") as f:
            data = bytearray(f.read())
        data[60] ^= 0xFF
        with pytest.raises(OSError):
            Image.open(io.BytesIO(bytes(data))).load()
        with pytest.raises(IOError):
            native.decode_u8(bytes(data))
        with open(PHOTO, "rb") as f:
            jpg = f.read()
        with pytest.raises(IOError):
            native.decode_u8(jpg[:200])


# ------------------------------------------------------------------- remap
class TestRemap:
    def test_matches_jax_native_and_port_remap(self, jax_native):
        rng = np.random.default_rng(2)
        src = rng.uniform(size=(40, 56)).astype(np.float32)
        x, y = np.meshgrid(np.arange(56, dtype=np.float32), np.arange(40, dtype=np.float32))
        maps = np.stack([x + rng.uniform(-2, 2, x.shape).astype(np.float32),
                         y + rng.uniform(-2, 2, y.shape).astype(np.float32)], -1)
        out = native.remap_bilinear(src, maps)
        ref = tcamera.remap_bilinear(torch.from_numpy(src), torch.from_numpy(maps)).numpy()
        jx = jax_native.remap_bilinear(src, maps)
        report("remap", max_vs_port=float(np.abs(out - ref).max()),
               max_vs_jax_native=float(np.abs(out - jx).max()),
               bit_equal_port=bool(np.array_equal(out, ref)))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(out, jx, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ loader
class TestLoader:
    def test_ordered_prefetch(self, png_dir):
        paths = [p for p, _ in png_dir]
        loader = native.NativeStereoLoader(paths, paths, 48, 64, depth=2, threads=3)
        seen = []
        for idx, left, right in loader:
            seen.append(idx)
            np.testing.assert_array_equal(left, right)
            np.testing.assert_array_equal(_levels(left), png_dir[idx][1])
        loader.close()
        assert seen == list(range(6))

    def test_many_workers_keep_order(self, png_dir):
        """More decode threads than cores, a buffer of one frame and a
        consumer that falls behind: every frame arrives once, in order,
        with its own pixels."""
        paths = [p for p, _ in png_dir] * 8
        with native.NativeStereoLoader(paths, paths[::-1], 48, 64, depth=1,
                                       threads=16) as loader:
            got = [(i, _levels(a), _levels(b)) for i, a, b in loader]
        assert [g[0] for g in got] == list(range(48))
        for i, a, b in got:
            np.testing.assert_array_equal(a, png_dir[i % 6][1])
            np.testing.assert_array_equal(b, png_dir[(47 - i) % 6][1])

    def test_missing_file_raises(self, png_dir):
        paths = [p for p, _ in png_dir[:2]]
        bad = paths + ["/nonexistent.png"]
        loader = native.NativeStereoLoader(bad, bad, 48, 64)
        it = iter(loader)
        next(it)
        next(it)
        with pytest.raises(IOError, match="frame 2"):
            next(it)
        loader.close()

    def test_with_identity_rectification(self, png_dir):
        paths = [p for p, _ in png_dir[:2]]
        x, y = np.meshgrid(np.arange(64, dtype=np.float32), np.arange(48, dtype=np.float32))
        ident = np.stack([x, y], -1)
        loader = native.NativeStereoLoader(paths, paths, 48, 64, map_l=ident, map_r=ident)
        idx, left, right = next(iter(loader))
        ref = native.decode_gray(paths[0], 48, 64)
        # identity remap reproduces the source (the clamp keeps the corner
        # at w-2 with weight 1: exact there too)
        np.testing.assert_array_equal(left, ref)
        loader.close()

    def test_rectifies_with_euroc_maps(self, tmp_path):
        """configs/euroc.yaml's maps (radial-tangential distortion, a
        rectifying rotation per eye) at 752×480: the loader's frames equal
        ``camera.remap_bilinear`` of the decoded frames (the port's device
        route) within 1e-6."""
        cam = load_camera_config(os.path.join(ROOT, "configs", "euroc.yaml"))
        H, W = cam.image_height, cam.image_width
        ml, mr = tcamera.build_rectify_maps(cam, "left"), tcamera.build_rectify_maps(cam, "right")
        rng = np.random.default_rng(5)
        lefts, rights = [], []
        for i in range(2):
            for side, lst in (("l", lefts), ("r", rights)):
                p = str(tmp_path / f"{side}{i}.png")
                png.write_png(p, rng.integers(0, 256, (H, W), dtype=np.uint8))
                lst.append(p)
        with native.NativeStereoLoader(lefts, rights, H, W, map_l=ml, map_r=mr) as loader:
            frames = list(loader)
        worst = 0.0
        for i, left, right in frames:
            for got, p, m in ((left, lefts[i], ml), (right, rights[i], mr)):
                src = torch.from_numpy(native.decode_gray(p, H, W))
                ref = tcamera.remap_bilinear(src, torch.from_numpy(m)).numpy()
                worst = max(worst, float(np.abs(got - ref).max()))
                np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        report("loader_euroc_rectification", max_vs_port_remap=worst)
        assert len(frames) == 2

    def test_frames_equal_euroc_dataset(self, tmp_path):
        """A raw-EuRoC tree (the port's PNG writer): the loader's frames
        equal ``EurocDataset``'s bit for bit, through either unfilter."""
        rng = np.random.default_rng(6)
        names = [f"{1403636579763555584 + 50_000_000 * i}.png" for i in range(4)]
        for cam in ("cam0", "cam1"):
            for n in names:
                png.write_png(str(tmp_path / "mav0" / cam / "data" / n),
                              rng.integers(0, 256, (24, 40), dtype=np.uint8))
        ds = EurocDataset(str(tmp_path))
        with native.NativeStereoLoader(*ds.file_lists(), 24, 40, threads=2) as loader:
            for i, left, right in loader:
                fr = ds[i]
                np.testing.assert_array_equal(left, fr.image_left)
                np.testing.assert_array_equal(right, fr.image_right)

    def test_dropped_loader_does_not_hang_exit(self, png_dir):
        """A loader dropped mid-stream (workers blocked on a full buffer) and
        one left alive at interpreter exit: the process ends promptly."""
        paths = [p for p, _ in png_dir] * 20
        code = ("import sys\n"
                "from rspl_slam_tpu_torch import native\n"
                f"paths = {paths!r}\n"
                "a = native.NativeStereoLoader(paths, paths, 48, 64, depth=1, threads=4)\n"
                "next(a)\n"
                "del a\n"
                "b = native.NativeStereoLoader(paths, paths, 48, 64, depth=1, threads=4)\n"
                "next(b)\n"
                "print('done')\n")
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=60, env=dict(os.environ, PYTHONPATH=ROOT))
        assert res.returncode == 0 and res.stdout.strip() == "done", res.stderr


# ------------------------------------------------------------- merge_lines
def _jax_cases():
    """JAX's ``TestNativeMergeLines.test_parity_random`` inputs."""
    rng = np.random.default_rng(7)
    for _ in range(60):
        n = int(rng.integers(2, 100))
        base = rng.uniform([0, 0, 0, 0], [752, 480, 752, 480], (max(n // 2, 1), 4))
        yield np.concatenate([base, base + rng.normal(0, 3, base.shape)])[:n]


class TestMergeLines:
    def test_parity_random(self, jax_native):
        """The compiled merge against JAX native and the port's numpy merge
        on JAX's 60 random cases: equal shapes, within 1e-9. Bits: the
        port's C++ is built without contracted FMAs and equals its numpy
        body on most cases; JAX's native build (``-march=native``, FMAs
        contracted) equals neither on most (counts printed by ``-s``)."""
        from rspl_slam_tpu.ops import lines as jl

        bits = {"vs_jax_native": 0, "vs_numpy": 0}
        for segs in _jax_cases():
            got = tl.merge_lines(segs, 0.1, 15.0, 30.0)
            jx = jl.merge_lines(segs, 0.1, 15.0, 30.0)
            ref = tl.merge_lines(segs, 0.1, 15.0, 30.0, force_numpy=True)
            for key, other in (("vs_jax_native", jx), ("vs_numpy", ref)):
                assert got.shape == other.shape, key
                np.testing.assert_allclose(got, other, rtol=0, atol=1e-9, err_msg=key)
                bits[key] += bool(np.array_equal(got, other))
        report("merge_lines_bit_equal_of_60", **bits)

    def test_edge_cases(self):
        empty = np.zeros((0, 4))
        assert len(tl.merge_lines(empty)) == 0
        one = np.array([[0.0, 0.0, 50.0, 0.0]])
        np.testing.assert_array_equal(tl.merge_lines(one), one)
        np.testing.assert_array_equal(native.merge_lines(one, 0.1, 15.0, 30.0), one)
        # two collinear overlapping segments merge into one
        two = np.array([[0.0, 0.0, 50.0, 0.0], [40.0, 0.5, 90.0, 0.5]])
        m = tl.merge_lines(two)
        assert m.shape == (1, 4)
        np.testing.assert_allclose(m, tl.merge_lines(two, force_numpy=True), rtol=0, atol=1e-9)
        # vertical segments (dx = 0) and far-apart ones stay apart
        apart = np.array([[10.0, 0.0, 10.0, 40.0], [300.0, 0.0, 300.0, 40.0]])
        np.testing.assert_array_equal(tl.merge_lines(apart), apart)

    def test_build_failure_raises(self, monkeypatch):
        """No quiet numpy fallback: a failing compiler raises from
        ``merge_lines``."""
        from rspl_slam_tpu_torch.ops import cuda_build

        monkeypatch.setattr(cuda_build, "_libs", {})
        monkeypatch.setattr(cuda_build, "HOST_FLAGS",
                            cuda_build.HOST_FLAGS + ["-DNATIVE_RUNTIME_TEST", "-fno-such-flag"])
        with pytest.raises(RuntimeError, match="failed for csrc/native_runtime.cpp"):
            tl.merge_lines(np.array([[0.0, 0.0, 50.0, 0.0], [40.0, 0.5, 90.0, 0.5]]))
