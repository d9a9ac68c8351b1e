"""The port's command line against the JAX package's, on a tiny raw-EuRoC
tree: 8 rendered frames at 320×240 written as PNG (the port's writer),
``cam0/data.csv`` and the ground-truth csv, a camera YAML in the OpenCV
multi-line layout (identity R, zero D: the remap runs), an algorithm YAML
with 2 GNN layers, and the same ``.npz`` weights for both (random
SuperPoint, the descriptor-matcher SuperGlue, the hand-set RCF at ×0.125).

Both CLIs run in this process with f32 frontends (the CLIs build bf16
ones; f32 is what every parity test compares, so a subclass with an f32
default stands in for each package's ``NeuralFrontend``) and a small map
store (``_small_maps``). The port runs with ``--device cpu``; JAX with
``--no-native``.

Tolerances. Keyframes must be the same frames. Local BA is on (the CLI
default), so positions part where RANSAC's random streams differ (the two
packages draw from different generators): on this tree JAX against
itself with another RANSAC seed parts by 1.4 cm with the cosine matcher.
Hence keyframe positions within 3 cm with ``--matcher cosine`` and within
5 mm with SuperGlue (3.8 mm and 0.40 mm measured in this file's
one-thread setting; ``-s`` prints them), and the ATE within 1 cm. Here the
SuperGlue case is the tighter one: its scores pick the same matches in
both packages, where cosine matching of random-weight descriptors leaves
more ties to RANSAC. Lines are off in the parity runs (``--no-lines``;
the lines path runs in the map and resume tests).
"""

import dataclasses
import json
import os
import re
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_common import rendered_sequence, report, small_system_cfg

import rspl_slam_tpu.config as jconfig
import rspl_slam_tpu.frontend.frontends as jfrontends
import rspl_slam_tpu_torch.config as tconfig
import rspl_slam_tpu_torch.frontend.frontends as tfrontends
from rspl_slam_tpu import cli as jcli
from rspl_slam_tpu.backend.map_store import MapStore as JMapStore
from rspl_slam_tpu_torch import cli as tcli
from rspl_slam_tpu_torch import png
from rspl_slam_tpu_torch.backend.map_store import MapStore as TMapStore
from rspl_slam_tpu_torch.datasets import write_tum_trajectory
from rspl_slam_tpu_torch.models import rcf, superglue, superpoint
from rspl_slam_tpu_torch.models.weights import save_npz_pytree
from rspl_slam_tpu_torch.slam import INIT_POSE

N_FRAMES = 8
NS0 = 1_403_636_579_763_555_584
POS_TOL = {"cosine": 3e-2, "superglue": 5e-3}


class _JaxF32(jfrontends.NeuralFrontend):
    def __init__(self, *a, **k):
        k.setdefault("compute_dtype", jnp.float32)
        super().__init__(*a, **k)


class _PortF32(tfrontends.NeuralFrontend):
    def __init__(self, *a, **k):
        k.setdefault("compute_dtype", torch.float32)
        super().__init__(*a, **k)


def _small_maps(load):
    """``load_system_config`` with the map store cut to 64 keyframes, 16384
    points and 1024 lines: a default-capacity checkpoint holds ~1 GB of
    arrays, this one a few MB (the map logic is capacity-agnostic)."""
    def wrapped(*a, **k):
        cfg = load(*a, **k)
        return dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, max_map_keyframes=64, max_map_points=16384, max_map_lines=1024))
    return wrapped


@pytest.fixture(autouse=True)
def f32_frontends(monkeypatch):
    monkeypatch.setattr(jfrontends, "NeuralFrontend", _JaxF32)
    monkeypatch.setattr(tfrontends, "NeuralFrontend", _PortF32)
    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "load_system_config", _small_maps(mod.load_system_config))


def _fmt(v):
    return ", ".join(repr(float(x)) for x in v)


def write_tree(root, n=N_FRAMES):
    """The tiny raw-EuRoC tree, YAMLs and weights under ``root``; returns
    the frames (float images) and the ground-truth world poses."""
    cfg = small_system_cfg()
    cam = cfg.camera
    frames, traj = rendered_sequence(cfg, n)
    seq = os.path.join(root, "seqs", "MH_tiny", "mav0")
    names = [NS0 + i * 50_000_000 for i in range(n)]
    for i, pair in enumerate(frames):
        for c, im in zip(("cam0", "cam1"), pair):
            png.write_png(os.path.join(seq, c, "data", f"{names[i]}.png"),
                          (np.clip(im, 0, 1) * 255).astype(np.uint8))
    with open(os.path.join(seq, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        f.writelines(f"{ns},{ns}.png\n" for ns in names)
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    os.makedirs(os.path.join(seq, "state_groundtruth_estimate0"))
    with open(os.path.join(seq, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m]\n")
        f.writelines(f"{ns},{_fmt(T[:3, 3])}\n" for ns, T in zip(names, gt))
    write_tum_trajectory(os.path.join(root, "gt.tum"), np.asarray(names) * 1e-9, gt)
    K = [cam.fx, 0, cam.cx, 0, cam.fy, cam.cy, 0, 0, 1]
    with open(os.path.join(root, "cam.yaml"), "w") as f:
        f.write(f"%YAML:1.0\nimage_width: {cam.image_width}\n"
                f"image_height: {cam.image_height}\nbf: {float(cam.bf)!r}\n")
        for side, tx in (("LEFT", 0.0), ("RIGHT", -cam.bf)):
            P = [cam.fx, 0, cam.cx, tx, 0, cam.fy, cam.cy, 0, 0, 0, 1, 0]
            f.write(f"{side}.D: !!opencv-matrix\n  rows: 1\n  cols: 5\n  dt: d\n"
                    f"  data: [0.0, 0.0, 0.0, 0.0, 0.0]\n")
            f.write(f"{side}.K: !!opencv-matrix\n  rows: 3\n  cols: 3\n  dt: d\n"
                    f"  data: [{_fmt(K[:3])},\n         {_fmt(K[3:6])},\n"
                    f"         {_fmt(K[6:])}]\n")
            f.write(f"{side}.R: !!opencv-matrix\n  rows: 3\n  cols: 3\n  dt: d\n"
                    "  data: [1.0, 0.0, 0.0,\n         0.0, 1.0, 0.0,\n"
                    "         0.0, 0.0, 1.0]\n")
            f.write(f"{side}.P: !!opencv-matrix\n  rows: 3\n  cols: 4\n  dt: d\n"
                    f"  data: [{_fmt(P[:4])},\n         {_fmt(P[4:8])},\n"
                    f"         {_fmt(P[8:])}]\n")
    with open(os.path.join(root, "algo.yaml"), "w") as f:
        # the weights by config path too: batch and serve take no weight flags
        f.write(f"superpoint:\n  max_keypoints: {cfg.superpoint.max_keypoints}\n"
                f"  weights_path: {root}/sp.npz\n"
                f"superglue:\n  image_width: {cam.image_width}\n"
                f"  image_height: {cam.image_height}\n  num_gnn_layers: 2\n"
                f"  weights_path: {root}/sg.npz\n"
                # a keyframe every few frames; RCF off the detection scale
                # routes JAX through its correct line extraction
                "keyframe:\n  max_distance: 0.08\n"
                "line_detector:\n  rcf_at_detection_scale: 0\n"
                f"  rcf_weights_path: {root}/rcf.npz\n")
    save_npz_pytree(os.path.join(root, "sp.npz"), superpoint.init_params(0))
    save_npz_pytree(os.path.join(root, "sg.npz"), superglue.descriptor_matcher_params(
        cfg.superglue, 0, 2000.0, 1980.0))
    save_npz_pytree(os.path.join(root, "rcf.npz"), rcf.edge_detector_params(width_mult=0.125))
    return frames, gt


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc"))
    frames, gt = write_tree(root)
    return root, frames, gt


def _args(root, *extra):
    return ["--config", f"{root}/algo.yaml", "--camera-config", f"{root}/cam.yaml",
            "--sp-weights", f"{root}/sp.npz", "--sg-weights", f"{root}/sg.npz",
            "--rcf-weights", f"{root}/rcf.npz", *extra]


def _ate_line(out: str) -> dict:
    return json.loads(re.search(r"^ATE: (.*)$", out, re.M).group(1))


@pytest.fixture(scope="module")
def runs(tree):
    """``run`` of each CLI per matcher, once: {matcher: {pkg: (out, traj, map)}}."""
    root, _, _ = tree
    cache = {}

    def get(matcher, capsys):
        if matcher not in cache:
            res = {}
            for pkg, cli, extra in (("port", tcli, ["--device", "cpu"]),
                                    ("jax", jcli, ["--no-native"])):
                traj = f"{root}/{pkg}_{matcher}.txt"
                mp = f"{root}/{pkg}_{matcher}_map.npz"
                capsys.readouterr()
                cli.main(["run", "--dataroot", f"{root}/seqs/MH_tiny",
                          *_args(root, "--matcher", matcher, "--no-lines",
                                 "--gt", f"{root}/seqs/MH_tiny", "--traj-path", traj,
                                 "--save-map", mp, *extra)])
                res[pkg] = (capsys.readouterr().out, traj, mp)
            cache[matcher] = res
        return cache[matcher]

    return get


@pytest.mark.parametrize("matcher", ["cosine", "superglue"])
def test_run_matches_jax(matcher, runs, capsys):
    """``run`` on the tiny tree: the same frame count, the same keyframes
    (TUM times), keyframe positions within the module's tolerance, the ATE
    within 1 cm; then ``eval`` of the port's trajectory against the
    ground truth prints the same JSON in both CLIs."""
    res = runs(matcher, capsys)
    (out_t, traj_t, _), (out_j, traj_j, _) = res["port"], res["jax"]
    assert f"({N_FRAMES} frames)" in out_t and f"processed {N_FRAMES} frames" in out_t
    a, b = np.loadtxt(traj_t, ndmin=2), np.loadtxt(traj_j, ndmin=2)
    assert len(a) == len(b) >= 3
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    ate_t, ate_j = _ate_line(out_t), _ate_line(out_j)
    with capsys.disabled():
        report(f"cli_run_{matcher}", keyframes=len(a),
               keyframe_pos_max_m=float(np.abs(a[:, 1:4] - b[:, 1:4]).max()),
               ate_port=ate_t["rmse"], ate_jax=ate_j["rmse"])
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], atol=POS_TOL[matcher])
    assert ate_t["n"] == ate_j["n"] == len(a)
    assert abs(ate_t["rmse"] - ate_j["rmse"]) < 1e-2
    root = os.path.dirname(traj_t)
    outs = []
    for cli in (tcli, jcli):
        cli.main(["eval", "--traj", traj_t, "--gt", f"{root}/gt.tum"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and json.loads(outs[0])["n"] == len(a)


def test_map_checkpoints_load_in_both_packages(runs, capsys):
    """A map saved by either CLI's ``--save-map`` loads in the other
    package's ``MapStore.load`` with equal arrays."""
    res = runs("superglue", capsys)
    for pkg, other in (("port", JMapStore), ("jax", TMapStore)):
        path = res[pkg][2]
        mine = (TMapStore if pkg == "port" else JMapStore).load(path)
        theirs = other.load(path)
        assert mine.n_kf == theirs.n_kf >= 3 and mine.n_pt == theirs.n_pt > 0
        with np.load(path) as z:
            for k in z.files:
                if hasattr(mine, k) and isinstance(getattr(mine, k), np.ndarray):
                    np.testing.assert_array_equal(getattr(theirs, k), getattr(mine, k),
                                                  err_msg=k)


def test_resume_from_map_tracks_on_with_lines(tree, tmp_path, capsys):
    """The port's lines path through the CLI (``--save-map``,
    ``--save-map-text``, ``--viz-dir``), then ``--resume-map`` on the same
    frames: the resumed run re-anchors on the stored last keyframe and
    tracks on, its new keyframes past the stored frame ids."""
    root, _, _ = tree
    mp, viz = str(tmp_path / "map.npz"), str(tmp_path / "viz")
    tcli.main(["run", "--dataroot", f"{root}/seqs/MH_tiny", *_args(root),
               "--device", "cpu", "--max-frames", "5", "--traj-path", str(tmp_path / "a.txt"),
               "--save-map", mp, "--save-map-text", str(tmp_path / "text"), "--viz-dir", viz])
    out = capsys.readouterr().out
    stored = TMapStore.load(mp)
    assert stored.n_kf >= 2 and stored.n_ln > 0
    assert os.path.isdir(str(tmp_path / "text"))
    pngs = [f for f in os.listdir(viz) if f.endswith(".png")]
    assert "trajectory.png" in pngs and any(f.startswith("frame_") for f in pngs)
    for f in pngs:
        with open(os.path.join(viz, f), "rb") as fh:
            assert png.read_png(fh.read()).ndim == 3
    assert "visualization →" in out
    tcli.main(["run", "--dataroot", f"{root}/seqs/MH_tiny", *_args(root),
               "--device", "cpu", "--max-frames", "5", "--resume-map", mp,
               "--save-map", str(tmp_path / "b.npz"), "--traj-path", str(tmp_path / "b.txt")])
    out = capsys.readouterr().out
    assert f"resumed from {mp}: {stored.n_kf} keyframes" in out
    after = TMapStore.load(str(tmp_path / "b.npz"))
    first_new = int(stored.kf_frame_id[: stored.n_kf].max()) + 1
    assert after.n_kf > stored.n_kf
    assert (after.kf_frame_id[stored.n_kf: after.n_kf] >= first_new).all()
    assert np.isfinite(after.kf_pose[: after.n_kf]).all()


def test_batch_matches_jax(tree, tmp_path, capsys):
    """``batch`` over the tree's sequence root: the same per-sequence
    keyframes and table rows."""
    root, _, _ = tree
    outs = {}
    for pkg, cli, extra in (("port", tcli, ["--device", "cpu"]), ("jax", jcli, [])):
        od = str(tmp_path / pkg)
        cli.main(["batch", "--root", f"{root}/seqs", "--out-dir", od, "--max-frames", "6",
                  "--no-lines", *_args(root)[:4], *extra])
        outs[pkg] = (capsys.readouterr().out, np.loadtxt(f"{od}/MH_tiny.txt", ndmin=2))
    (ot, a), (oj, b) = outs["port"], outs["jax"]
    assert "=== MH_tiny (6 frames)" in ot and "ATE RMSE per sequence" in ot
    rmse = [float(re.search(r"MH_tiny\s+([0-9.]+) m", o).group(1)) for o in (ot, oj)]
    assert abs(rmse[0] - rmse[1]) < 1e-2
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], atol=POS_TOL["superglue"])


def test_synth_matches_jax(tmp_path, capsys):
    """``synth`` (OracleFrontend on the unfused tracking path): the same
    oracle observations (one numpy stream), so the same keyframes,
    mappoints and maplines; ATE within 1 mm of JAX's and trajectories
    within 1 cm (RANSAC streams differ)."""
    res = {}
    for pkg, cli, extra in (("port", tcli, ["--device", "cpu"]), ("jax", jcli, [])):
        traj = str(tmp_path / f"{pkg}.txt")
        cli.main(["synth", "--frames", "20", "--traj-path", traj, *extra])
        out = capsys.readouterr().out
        res[pkg] = (re.search(r"^keyframes=.*$", out, re.M).group(0), _ate_line(out),
                    np.loadtxt(traj, ndmin=2))
    (kt, at, tt), (kj, aj, tj) = res["port"], res["jax"]
    assert kt == kj
    assert at["n"] == aj["n"] == 20 and abs(at["rmse"] - aj["rmse"]) < 1e-3
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    np.testing.assert_allclose(tt[:, 1:4], tj[:, 1:4], atol=1e-2)


@pytest.mark.parametrize("model", ["superpoint", "superglue", "rcf"])
def test_convert_weights_matches_jax(model, tmp_path, capsys):
    """``convert-weights`` of a public-layout checkpoint: both CLIs write
    the same arrays (tolerance 0) and print the same count."""
    from test_torch_weights import _rcf_sd, _superglue_sd, _superpoint_sd

    from rspl_slam_tpu_torch.config import SuperGlueConfig

    rng = np.random.default_rng(0)
    sd = {"superpoint": lambda: _superpoint_sd(rng),
          "superglue": lambda: _superglue_sd(rng, SuperGlueConfig()),
          "rcf": lambda: _rcf_sd(rng)}[model]()
    pth = str(tmp_path / f"{model}.pth")
    torch.save(sd, pth)
    outs = []
    for pkg, cli in (("port", tcli), ("jax", jcli)):
        cli.main(["convert-weights", "--model", model, "--input", pth,
                  "--output", str(tmp_path / f"{pkg}.npz")])
        outs.append(capsys.readouterr().out.replace(pkg, ""))
    assert outs[0] == outs[1]
    with np.load(str(tmp_path / "port.npz")) as a, np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_serve_ingests_live_frames(tree, tmp_path, capsys):
    """``serve`` pairs frames as both halves appear (write-then-rename),
    drains the backlog, and stops on the stop file."""
    root, frames, _ = tree
    d0, d1 = tmp_path / "cam0" / "data", tmp_path / "cam1" / "data"
    d0.mkdir(parents=True)
    d1.mkdir(parents=True)

    def drop(i):
        name = f"{NS0 + i * 50_000_000}.png"
        for d, img in zip((d0, d1), frames[i]):
            tmp = str(d / (name + ".part"))
            png.write_png(tmp, (np.clip(img, 0, 1) * 255).astype(np.uint8))
            os.rename(tmp, str(d / name))

    for i in range(3):  # a backlog exists before the driver starts
        drop(i)

    def producer():
        for i in range(3, 6):
            time.sleep(0.2)
            drop(i)
        (tmp_path / "stop").touch()

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    traj = str(tmp_path / "live.tum")
    tcli.main(["serve", "--watch-dir", str(tmp_path), *_args(root)[:4], "--device", "cpu",
               "--traj-path", traj, "--matcher", "cosine", "--no-lines",
               "--idle-timeout", "60", "--cull-every", "1"])
    th.join()
    out = capsys.readouterr().out
    assert "served 6 frames" in out
    rows = np.loadtxt(traj, ndmin=2)
    assert len(rows) >= 1 and abs(rows[0, 0] - NS0 * 1e-9) < 1e-6


def test_serve_stops_when_idle(tree, tmp_path):
    root, _, _ = tree
    (tmp_path / "cam0" / "data").mkdir(parents=True)
    (tmp_path / "cam1" / "data").mkdir(parents=True)
    t0 = time.perf_counter()
    tcli.main(["serve", "--watch-dir", str(tmp_path), *_args(root)[:4], "--device", "cpu",
               "--traj-path", str(tmp_path / "t.tum"), "--no-lines",
               "--idle-timeout", "1", "--poll-ms", "20"])
    assert time.perf_counter() - t0 < 30


_EPILOGUE = re.compile(r"^(loop closures accepted|pose graph|global BA):.*$", re.M)


@pytest.mark.parametrize("flag", ["loop-closure", "pose-graph", "global-ba", "track-local-map"])
def test_global_options_match_jax(flag, tree, capsys):
    """``run --<flag>`` (SuperGlue, lines off) in both CLIs on the tiny
    tree: the same epilogue lines (no loop in 8 frames, so ``--pose-graph``
    prints the same "skipped" line in both; ``--global-ba`` refines the
    same keyframes, its final cost within 1%), the same keyframes, and
    keyframe positions within the module's SuperGlue tolerance."""
    root, _, _ = tree
    res = {}
    for pkg, cli, extra in (("port", tcli, ["--device", "cpu"]), ("jax", jcli, ["--no-native"])):
        traj = f"{root}/{pkg}_{flag}.txt"
        capsys.readouterr()
        cli.main(["run", "--dataroot", f"{root}/seqs/MH_tiny",
                  *_args(root, "--matcher", "superglue", "--no-lines", "--traj-path", traj,
                         f"--{flag}", *extra)])
        res[pkg] = (capsys.readouterr().out, np.loadtxt(traj, ndmin=2))
    (out_t, a), (out_j, b) = res["port"], res["jax"]
    ep_t = [m.group(0) for m in _EPILOGUE.finditer(out_t)]
    ep_j = [m.group(0) for m in _EPILOGUE.finditer(out_j)]
    with capsys.disabled():
        report(f"cli_{flag}", epilogue=[ep_t, ep_j], keyframes=len(a),
               keyframe_pos_max_m=float(np.abs(a[:, 1:4] - b[:, 1:4]).max()))
    assert len(ep_t) == len(ep_j) == (flag in ("pose-graph", "global-ba"))
    for lt, lj in zip(ep_t, ep_j):
        if lt.startswith("global BA: refined"):
            got = [re.match(r"global BA: refined (\d+) keyframes jointly \(final cost (\S+)\)$",
                            x).groups() for x in (lt, lj)]
            assert got[0][0] == got[1][0]
            np.testing.assert_allclose(float(got[0][1]), float(got[1][1]), rtol=1e-2)
        else:
            assert lt == lj
    assert len(a) == len(b) >= 3
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], atol=POS_TOL["superglue"])


@pytest.mark.parametrize("argv", [["pretrain", "--model", "rcf"]], ids=["pretrain"])
def test_unported_options_raise(argv):
    """``pretrain`` was the CLI's one unported command; it is ported now
    and, like every entry point, asks for the card by default: where none
    is visible it raises (no NotImplementedError, no silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argv)


PRETRAIN_ARGS = {"superpoint": ["--steps", "2", "--batch", "1"],
                 "rcf": ["--steps", "3"],
                 "superglue": ["--steps", "3", "--batch", "2"]}


@pytest.mark.parametrize("model", ["superpoint", "rcf", "superglue"])
def test_pretrain_matches_in_process_train(model, tmp_path, capsys):
    """``pretrain --device cpu`` exits cleanly, prints the JAX CLI's line,
    and writes the parameters an in-process ``train`` with the same recipe
    gives (bit for bit: the same CPU computation)."""
    from rspl_slam_tpu_torch.models.weights import flatten_pytree, load_params
    from rspl_slam_tpu_torch.training import rcf_train, superglue_train, superpoint_train

    out = str(tmp_path / f"{model}.npz")
    tcli.main(["pretrain", "--model", model, *PRETRAIN_ARGS[model], "--output", out,
               "--device", "cpu"])
    assert f"trained {model} → {out}" in capsys.readouterr().out
    cpu = torch.device("cpu")
    if model == "superpoint":
        ref = superpoint_train.train(steps=2, batch=1, verbose=False, device=cpu)
    elif model == "rcf":
        ref, _ = rcf_train.train(steps=3, batch=4, lr=1e-3, verbose=False, device=cpu)
    else:
        cfg = tconfig.SuperGlueConfig(image_width=320, image_height=240, num_gnn_layers=4,
                                      sinkhorn_iterations=20)
        ref, _ = superglue_train.train(cfg, steps=3, batch=2, K=64, verbose=False, device=cpu)
    got = flatten_pytree(load_params(out, model))
    ref = flatten_pytree(ref)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_default_device_is_the_card(tree):
    """Without ``--device`` the CLI runs on the card, and raises where
    none is visible."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    root, _, _ = tree
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["run", "--dataroot", f"{root}/seqs/MH_tiny", *_args(root)])
