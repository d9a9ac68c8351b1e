"""The port's IO without PIL, PyYAML or matplotlib, against the JAX
package (which reads through PIL and PyYAML):

- the PyYAML-free config parser on every file in ``configs/``;
- the PNG/PGM reader against PIL's ``convert("L")``, the writer's round
  trip, and the numpy unfilter against the C++ loop's plain version
  (every filter);
- ``EurocDataset`` on every layout and time source, and the TUM
  trajectory reader, against the JAX reader;
- the visualization writers.

Tolerance 0 (bit for bit) unless a test says otherwise.
"""

import dataclasses
import glob
import os
import sys

import numpy as np
import pytest
import torch

from rspl_slam_tpu import config as jconfig
from rspl_slam_tpu import datasets as jdatasets
from rspl_slam_tpu_torch import config as tconfig
from rspl_slam_tpu_torch import datasets as tdatasets
from rspl_slam_tpu_torch import png
from rspl_slam_tpu_torch import visualization as viz

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))


# --------------------------------------------------------------------- YAML
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_mini_yaml_equals_pyyaml(path):
    """The fallback parser returns what PyYAML returns on the same stripped
    text (multi-line flow sequences included)."""
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        ref = yaml.safe_load(tconfig._strip_opencv(f.read()))
    assert tconfig._mini_yaml(path) == ref


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_camera_config_without_pyyaml_matches_jax(path, monkeypatch):
    """With ``yaml`` blocked, the port's camera and system configs equal
    the JAX package's read with PyYAML, field for field."""
    pytest.importorskip("yaml")
    jcam = jconfig.load_camera_config(path)
    jsys = jconfig.load_system_config(path, path)
    monkeypatch.setitem(sys.modules, "yaml", None)
    tcam = tconfig.load_camera_config(path)
    tsys = tconfig.load_system_config(path, path)
    assert dataclasses.asdict(tcam) == dataclasses.asdict(jcam)
    assert dataclasses.asdict(tsys) == dataclasses.asdict(jsys)
    assert len(tcam.left_P) == len(tcam.right_P) == 12
    assert len(tcam.left_R) == len(tcam.right_R) == 9


def test_euroc_yaml_algorithm_section_is_the_default(monkeypatch):
    """``configs/euroc.yaml``'s algorithm section is ``SystemConfig()``'s:
    a run with ``--config configs/euroc.yaml`` is the default main path."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = [p for p in CONFIGS if p.endswith("euroc.yaml")][0]
    assert tconfig.load_system_config(path, None) == tconfig.SystemConfig()


# ---------------------------------------------------------------------- PNG
def _image(rng, ch, H=37, W=53):
    """Noise with a smooth band and a flat block, so that encoders pick
    different filters on different rows."""
    img = rng.integers(0, 256, (H, W, ch), dtype=np.uint8)
    img[10:20] = np.linspace(0, 255, W, dtype=np.uint8)[None, :, None]
    img[25:30] = 77
    return img[..., 0] if ch == 1 else img


@pytest.mark.parametrize("mode,ch", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
def test_png_reader_equals_pil(mode, ch, tmp_path):
    """PIL-written files (PIL's own filter choice) and the port's writer's
    files with each filter forced decode to PIL's ``convert("L")``; the
    writer → reader round trip returns the samples unchanged."""
    Image = pytest.importorskip("PIL.Image")
    img = _image(np.random.default_rng(ch), ch)
    p = str(tmp_path / "pil.png")
    Image.fromarray(img, mode).save(p)
    np.testing.assert_array_equal(png.read_gray(p), np.asarray(Image.open(p).convert("L")))
    for ft in png.FILTERS + (None,):
        p = str(tmp_path / f"port_{ft}.png")
        png.write_png(p, img, ft)
        np.testing.assert_array_equal(png.read_gray(p),
                                      np.asarray(Image.open(p).convert("L")), err_msg=str(ft))
        with open(p, "rb") as f:
            np.testing.assert_array_equal(png.read_png(f.read()).reshape(img.shape), img)


def test_luma_and_pgm_equal_pil(tmp_path):
    """Every byte of PIL's fixed-point luma over random RGB, and a P5 PGM
    with a comment in its header."""
    Image = pytest.importorskip("PIL.Image")
    rgb = np.random.default_rng(0).integers(0, 256, (256, 256, 3), dtype=np.uint8)
    p = str(tmp_path / "rgb.png")
    Image.fromarray(rgb).save(p)
    np.testing.assert_array_equal(png.read_gray(p), np.asarray(Image.open(p).convert("L")))
    p = str(tmp_path / "g.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# a comment\n256 256\n255\n" + rgb[..., 1].tobytes())
    np.testing.assert_array_equal(png.read_gray(p), np.asarray(Image.open(p).convert("L")))


def test_png_unsupported_kinds_raise(tmp_path):
    """Palette, 16-bit and interlaced PNGs, baseline and progressive JPEGs,
    which raised before the native decoder, now read as PIL reads them; a
    12-bit JPEG, which PIL refuses too, raises NotImplementedError naming
    the kind (tests/test_torch_image_kinds.py holds every kind bit for
    bit)."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    cases = {"pal.png": Image.fromarray(img).convert("P"),
             "i16.png": Image.fromarray(img.astype(np.uint16) * 257),
             "jpg.jpg": Image.fromarray(img)}
    for name, im in cases.items():
        im.save(str(tmp_path / name))
    Image.fromarray(img).save(str(tmp_path / "inter.png"), interlace=1)
    Image.fromarray(img).save(str(tmp_path / "prog.jpg"), progressive=True)
    for name in ("pal.png", "i16.png", "jpg.jpg", "inter.png", "prog.jpg"):
        p = str(tmp_path / name)
        np.testing.assert_array_equal(png.read_gray(p), np.asarray(Image.open(p).convert("L")),
                                      err_msg=name)
    twelve = os.path.join(os.path.dirname(__file__), "fixtures", "image_kinds", "jpeg_12bit.jpg")
    with pytest.raises(NotImplementedError, match="not 8-bit"):
        png.read_gray(twelve)


@pytest.mark.parametrize("bpp", [1, 3])
def test_unfilter_numpy_on_every_filter(bpp):
    """The numpy unfilter inverts the writer's filtering for each of the
    five filters and for a per-row mix of them (the compiled loop is held
    against this function on the card: chip_smoke.py ``png_unfilter``)."""
    rng = np.random.default_rng(bpp)
    img = rng.integers(0, 256, (19, 23 * bpp), dtype=np.uint8)
    cand = png._filtered(img, bpp)
    for choice in [np.full(19, f) for f in range(5)] + [np.arange(19) % 5]:
        raw = np.concatenate([choice.astype(np.uint8)[:, None], cand[choice, np.arange(19)]], 1)
        np.testing.assert_array_equal(png.unfilter_numpy(raw.tobytes(), 19, 23 * bpp, bpp), img)


def test_compiled_unfilter_needs_a_build():
    """Without nvcc the compiled loop raises (it never falls back)."""
    from rspl_slam_tpu_torch.ops import cuda_build

    try:
        cuda_build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            png.unfilter_compiled(b"\x00" * 4, 1, 3, 1)
    else:
        pytest.skip("nvcc present: chip_smoke.py's png_unfilter phase checks the loop")


# ----------------------------------------------------------------- datasets
def _write_pairs(left, right, names, rng, H=12, W=16):
    os.makedirs(left, exist_ok=True)
    os.makedirs(right, exist_ok=True)
    for n in names:
        for d in (left, right):
            png.write_png(os.path.join(d, n), rng.integers(0, 256, (H, W), dtype=np.uint8))


LAYOUTS = {
    # converted EuRoC: filename-ns times
    "converted": ("cam0/data", "cam1/data", ["1403636579763555584.png", "1403636579813555456.png"]),
    # raw EuRoC nesting + data.csv times (names short, so the csv decides)
    "raw_csv": ("mav0/cam0/data", "mav0/cam1/data", ["000.png", "001.png", "002.png"]),
    # plain left/right: 20 Hz index times; a right-only frame is skipped
    "left_right": ("left", "right", ["a.png", "b.png"]),
    "kitti": ("image_0", "image_1", ["000000.png", "000001.png"]),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_euroc_dataset_matches_jax(layout, tmp_path):
    """Each layout and time source: the same names, times, file lists and
    images (float32 in [0, 1], bit for bit) as the JAX reader."""
    pytest.importorskip("PIL")
    ls, rs, names = LAYOUTS[layout]
    root = str(tmp_path)
    _write_pairs(os.path.join(root, ls), os.path.join(root, rs), names,
                 np.random.default_rng(len(names)))
    if layout == "left_right":
        png.write_png(os.path.join(root, rs, "z.png"), np.zeros((12, 16), np.uint8))
    if layout == "raw_csv":
        with open(os.path.join(root, "mav0", "cam0", "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i, n in enumerate(names):
                f.write(f"{1403636579763555584 + i * 50_000_000},{n}\n")
    td, jd = tdatasets.open_dataset(root), jdatasets.open_dataset(root)
    assert td.names == jd.names and len(td) == len(jd) == len(names)
    assert [td.timestamp(i) for i in range(len(td))] == [jd.timestamp(i) for i in range(len(jd))]
    assert td.file_lists() == jd.file_lists()
    for i in range(len(td)):
        a, b = td[i], jd[i]
        assert (a.index, a.time) == (b.index, b.time)
        assert a.image_left.dtype == np.float32
        np.testing.assert_array_equal(a.image_left, b.image_left)
        np.testing.assert_array_equal(a.image_right, b.image_right)


def test_open_dataset_without_images_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tdatasets.open_dataset(str(tmp_path))


def test_tum_trajectory_roundtrip_matches_jax(tmp_path):
    """The port writes and reads TUM files as JAX reads them: equal times
    and positions; rotations within 1e-6 (the JAX reader converts
    quaternions in f32)."""
    from rspl_slam_tpu_torch.evaluation import synthetic

    traj = synthetic.make_trajectory(9, step=0.1, yaw_rate=0.2)
    t = 1403636579.0 + 0.05 * np.arange(9)
    p = str(tmp_path / "t.txt")
    tdatasets.write_tum_trajectory(p, t, traj)
    ta, pa = tdatasets.read_tum_trajectory(p)
    tb, pb = jdatasets.read_tum_trajectory(p)
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(pa[:, :3, 3], pb[:, :3, 3])
    np.testing.assert_allclose(pa, pb, atol=1e-6)
    np.testing.assert_allclose(pa, traj, atol=1e-8)


# ------------------------------------------------------------ visualization
def test_visualization_writers(tmp_path):
    """Overlays, the rasterized trajectory plot and the PLY files: PNGs
    decode to what was drawn; the plot draws the estimate (blue) and the
    ground truth (black) inside its frame, axes equal."""
    rng = np.random.default_rng(0)
    img = viz.draw_features(rng.random((40, 60)).astype(np.float32),
                            np.array([[10.0, 10.0], [30.0, 20.0]]), np.array([True, False]),
                            lines=np.array([[0.0, 0.0, 50.0, 30.0]]), line_valid=np.array([True]))
    p = str(tmp_path / "o.png")
    viz.save_png(p, img)
    with open(p, "rb") as f:
        np.testing.assert_array_equal(png.read_png(f.read()), img)
    poses = np.tile(np.eye(4), (30, 1, 1))
    poses[:, 0, 3] = np.linspace(0.0, 2.0, 30)
    poses[:, 2, 3] = np.linspace(0.0, 1.0, 30)
    p = str(tmp_path / "traj.png")
    viz.save_trajectory_png(p, poses, gt=poses + 0.1)
    with open(p, "rb") as f:
        plot = png.read_png(f.read())
    blue = (plot[..., 2] == 255) & (plot[..., 0] == 0)
    black = plot.sum(-1) == 0
    assert blue.sum() > 100 and black.sum() > 50
    rows, cols = np.nonzero(blue)
    # x spans twice z: the blue track's extent keeps that ratio (equal axes)
    assert abs((cols.max() - cols.min()) / (rows.max() - rows.min()) - 2.0) < 0.1
    viz.save_ply_points(str(tmp_path / "p.ply"), rng.random((5, 3)))
    viz.save_ply_lines(str(tmp_path / "l.ply"), rng.random((3, 2, 3)))
    with open(str(tmp_path / "l.ply")) as f:
        assert "element edge 3" in f.read()


def test_frame_publisher_streams_poses(tmp_path):
    """FramePublisher appends a TUM pose per record and an overlay PNG
    for frames that carry an image."""
    from rspl_slam_tpu_torch.frontend.frontends import FrameFeatures
    from rspl_slam_tpu_torch.slam import FrameRecord

    pub = viz.FramePublisher(str(tmp_path), overlay_stride=1)
    ff = FrameFeatures(xy=np.zeros((4, 2), np.float32), valid=np.ones(4, bool),
                       image=np.zeros((16, 20), np.float32))
    for i in range(3):
        pub(FrameRecord(i, 0.1 * i, np.eye(4)), ff)
    pub.close()
    assert np.loadtxt(pub.pose_path).shape == (3, 8)
    assert os.path.exists(str(tmp_path / "frame_000002.png"))


def test_span_timer_and_trace(tmp_path):
    """SpanTimer summaries, and ``trace_to`` writes a Chrome trace."""
    from rspl_slam_tpu_torch.utils.timing import SpanTimer, trace_to

    st = SpanTimer()
    for _ in range(3):
        with st.span("x"):
            pass
    assert st.summary()["x"]["n"] == 3 and "x" in st.report()
    with trace_to(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert os.path.getsize(str(tmp_path / "tr" / "trace.json")) > 0
