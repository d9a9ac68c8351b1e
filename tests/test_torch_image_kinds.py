"""Every JPEG and netpbm kind that the JAX package's reader takes (PIL's
``Image.open(p).convert("L")``, ``rspl_slam_tpu.datasets._load_gray``)
through every CPU route of the port's reader: ``png.read_gray``,
``native.decode_u8`` / ``decode_gray`` and the ``NativeStereoLoader``
threads, bit for bit; and the kinds PIL refuses raising
``NotImplementedError`` on every route, naming the kind.

The fixtures are ``tests/fixtures/image_kinds/`` (written by
``tests/torch_make_image_kinds.py``, whose encoder these tests also use
for random files): progressive (PIL's and partially refined ones, which
libjpeg-turbo smooths), arithmetic-coded, lossless, CMYK, YCCK, RGB,
4:1:1, netpbm P1-P6 at several maxvals, the refused 12-bit,
hierarchical, DNL and fractional-sampling files, and a 752×480
progressive stereo sequence. ``manifest.json`` pins each readable file's
PIL sha256.
"""

import hashlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch_make_image_kinds as mk
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image
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
REFUSED = sorted(n for n, e in MANIFEST.items() if e.get("refused"))
# the words the port's refusal names each refused fixture by
REFUSAL_WORDS = {"jpeg_12bit.jpg": "not 8-bit", "jpeg_hierarchical.jpg": "hierarchical",
                 "jpeg_dnl.jpg": "DNL", "jpeg_fractional_sampling.jpg": "fractional sampling"}


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
    H, W = mk.H_SMALL, mk.W_SMALL  # the size a caller expects (a DNL file's header says 0)
    word = REFUSAL_WORDS[name]
    for call in (lambda: png.read_gray(path), lambda: native.decode_u8(data, path),
                 lambda: native.decode_gray(path, H, W)):
        with pytest.raises(NotImplementedError, match=word):
            call()
    with native.NativeStereoLoader([path], [path], H, W) as loader:
        with pytest.raises(NotImplementedError, match=word):
            next(loader)


def test_refusals_name_the_format_they_refuse(tmp_path):
    """No netpbm refusal speaks of JPEG and no JPEG refusal of netpbm: a
    PFM file (which PIL reads, the port does not) names netpbm; a 16-bit
    P5 at maxval 1023 reads (it raised as a refused JPEG kind before); a
    lossless JPEG that declares YCbCr (JFIF) raises in PIL and names
    lossless in the port."""
    pfm = tmp_path / "f.pfm"
    pfm.write_bytes(b"Pf\n3 2\n-1.0\n" + np.zeros(6, "<f4").tobytes())
    for call in (lambda: png.read_gray(str(pfm)), lambda: native.decode_gray(str(pfm), 2, 3)):
        with pytest.raises(NotImplementedError, match="netpbm") as e:
            call()
        assert "JPEG" not in str(e.value)
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


MIXED = ("prog_gray.jpg", "arith_prog.jpg", "lossless_rgb_p7.jpg", "cmyk_prog.jpg", "ycck.jpg",
         "ycc_411.jpg", "p5_max1023.pgm", "p2.pgm", "p6_max1000.ppm", "p1.pbm")


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


def _cli_tree(root, frames, gt, ext):
    """A raw-EuRoC tree of ``frames`` under ``root``: progressive JPEGs
    written by PIL (``ext`` ".jpg") or PNG copies of PIL's decode of them
    (".png")."""
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
            else:
                png.write_png(path, _pil(buf.getvalue()))
    with open(os.path.join(seq, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        f.writelines(f"{ns},{ns}{ext}\n" for ns in names)
    os.makedirs(os.path.join(seq, "state_groundtruth_estimate0"))
    with open(os.path.join(seq, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.writelines(f"{ns},{T[0, 3]!r},{T[1, 3]!r},{T[2, 3]!r}\n" for ns, T in zip(names, gt))


def test_cli_run_on_progressive_jpegs_equals_its_png_copies(tmp_path, capsys):
    """``cli run --device cpu`` (the native prefetcher; the cosine matcher,
    lines off, to keep it short) on a 6-frame 320×240 tree of progressive
    JPEGs and on PNG copies of their pixels: the same trajectory, text for
    text."""
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
    text = {}
    for ext in (".jpg", ".png"):
        root = str(tmp_path / ext[1:])
        _cli_tree(root, frames, gt, ext)
        traj_path = str(tmp_path / f"traj{ext}.txt")
        tcli.main(["run", "--dataroot", root, "--config", str(tmp_path / "algo.yaml"),
                   "--camera-config", str(tmp_path / "cam.yaml"),
                   "--sp-weights", str(tmp_path / "sp.npz"), "--matcher", "cosine",
                   "--no-lines", "--device", "cpu",
                   "--traj-path", traj_path])
        assert "processed 6 frames" in capsys.readouterr().out
        with open(traj_path) as f:
            text[ext] = f.read()
    assert text[".jpg"] and text[".jpg"] == text[".png"]
