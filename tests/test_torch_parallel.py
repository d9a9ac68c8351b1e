"""The port's ``parallel/`` against the JAX package's on the CPU: the mesh
and multihost helpers, ``pad_constraints``, the batched-window solve, the
landmark-sharded solve in one process and over 2 and 4 gloo processes
(``tests/test_torch_parallel_worker.py``) with its first reduced camera
system, and ``run_global_ba(mesh=)`` over 2 ranks.

Tolerances. Batched windows against JAX's vmapped solve: local BA's
parity tolerances (``test_torch_ba.py::test_optimize_local_map_matches_jax``:
rotation 1e-4, translation 2e-4, points 2e-3, lines up to Plücker scale
1e-3, cost 1e-3 relative + 1e-6, the same inlier flags); against the
port's own single solve of each window: Tcw within 1e-6 and the same
inlier flags (the same arithmetic; a padded segment plan
sums over more terms). The sharded solve sums S and g̃ over ranks in
another order than the single solve: Tcw within 1e-4 and points within
3e-3 of it, and JAX's own sharded-solve tolerances (Tcw 1e-3, points
1e-2) against JAX at 8 devices; the ranks of one run agree bit for bit.
The reduced camera system summed over ranks in f64 against the single
process's: within 1e-9 of its largest entry. Global BA over 2 ranks
against the single-process call: keyframe poses within 1e-3, cost within
1e-3 relative.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_local_ba as jba
import torch
import torch.distributed as dist
from test_torch_common import report
from test_torch_parallel_worker import map_cfg

from rspl_slam_tpu.geometry import plucker as jplk
from rspl_slam_tpu.parallel import dist_ba as jdist
from rspl_slam_tpu.parallel import mesh as jmesh
from rspl_slam_tpu.parallel import multihost as jmh
from rspl_slam_tpu_torch.backend import local_ba as tlb
from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
from rspl_slam_tpu_torch.evaluation import synthetic
from rspl_slam_tpu_torch.frontend.frontends import OracleFrontend
from rspl_slam_tpu_torch.parallel import dist_ba, mesh as tmesh, multihost
from rspl_slam_tpu_torch.slam import SLAMSystem

K = CameraIntrinsics(*jba.K)
WORKER = os.path.join(os.path.dirname(__file__), "test_torch_parallel_worker.py")
GLOBAL_SEED = 2
WORKER_TIMEOUT_S = 240


def _np(prob):
    return tlb.BAProblem(*[np.asarray(a) for a in tuple(prob)[:15]])


def _save(path, prob):
    np.savez(path, **{f: np.asarray(getattr(prob, f)) for f in tlb.BAProblem._fields[:15]})
    return str(path)


def _sharded_problem():
    """JAX's sharded-BA problem (``tests/test_parallel.py``): noise, 20% gross
    point outliers, lines."""
    prob, *_ = jba.build_problem(seed=5, noise_px=0.4, perturb=True, with_lines=True,
                                 outlier_frac=0.2)
    return prob


def _four_times(prob):
    """The problem with each point repeated 4 times (4P landmarks, the same
    poses): the sharded solve's floats per step must not change."""
    p = _np(prob)
    P = len(p.points)
    rep = lambda a: np.concatenate([a] * 4)  # noqa: E731
    return p._replace(points=rep(p.points), p_pose=rep(p.p_pose),
                      p_point=np.concatenate([p.p_point + k * P for k in range(4)]),
                      p_meas=rep(p.p_meas), p_stereo=rep(p.p_stereo), p_valid=rep(p.p_valid))


def _windows():
    return [jba.build_problem(seed=s, with_lines=True)[0] for s in range(4)]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(world, jobs, tmp):
    """Start ``world`` worker ranks on a free port; returns (procs, out dir)."""
    out = tmp / f"world{world}"
    out.mkdir()
    jobs_path = out / "jobs.json"
    jobs_path.write_text(json.dumps({"K": list(jba.K), **jobs}))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), str(port),
                               str(jobs_path), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    return procs, out


def _collect(procs, out):
    try:
        for p in procs:
            _, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(len(procs))]


def _global_map(tmp):
    """A perturbed 35-frame oracle map (BA off; ``tests/test_global_ba.py``'s
    scene and path), saved; and its system."""
    cfg = map_cfg()
    scene = synthetic.make_scene(num_points=900, seed=GLOBAL_SEED, num_lines=0,
                                 extent=(10.0, 6.0, 16.0))
    fe = OracleFrontend(cfg, scene, noise_px=0.6, seed=GLOBAL_SEED, device="cpu")
    fe.poses = synthetic.make_trajectory(35, step=0.05, yaw_rate=0.003)
    slam = SLAMSystem(cfg, fe, enable_ba=False)
    for i in range(35):
        slam.add_frame(i, i * 0.05, None, None)
    rng = np.random.default_rng(0)
    m = slam.map
    m.kf_pose[1: m.n_kf, :3, 3] += rng.standard_normal((m.n_kf - 1, 3)) * 0.01
    good = np.nonzero(m.pt_status[: m.n_pt] == 2)[0]
    m.pt_pos[good] += rng.standard_normal((len(good), 3)) * 0.02
    path = str(tmp / "map.npz")
    slam.save_map(path)
    return slam, path


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("par")
    prob = _sharded_problem()
    return {"tmp": tmp, "prob": prob, "P": _save(tmp / "p.npz", _np(prob)),
            "4P": _save(tmp / "p4.npz", _four_times(prob))}


@pytest.fixture(scope="module")
def gloo_runs(problems):
    """2 and 4 gloo ranks, started together: the sharded solve on the P and
    4P problems in both; the batched windows and global BA at 2 ranks."""
    tmp = problems["tmp"]
    windows = [_np(p) for p in _windows()]
    batched = tmp / "windows.npz"
    np.savez(batched, **{f: np.stack([getattr(w, f) for w in windows])
                         for f in tlb.BAProblem._fields[:15]})
    slam, map_path = _global_map(tmp)
    sharded = [problems["P"], problems["4P"]]
    runs = {2: _launch(2, {"sharded": sharded, "batched": str(batched), "system": sharded[0],
                           "global": {"map": map_path, "seed": GLOBAL_SEED}}, tmp),
            4: _launch(4, {"sharded": sharded, "system": sharded[0]}, tmp)}
    out = {w: _collect(*r) for w, r in runs.items()}
    return out, windows, slam


@pytest.fixture(scope="module")
def jax_sharded(problems):
    """JAX's sharded solve at 8 devices (its own test's setting)."""
    prob = jdist.pad_constraints(problems["prob"], 8)
    return jdist.sharded_constraints_ba(jba.K, prob, jmesh.make_mesh(n_data=8))


def _single(prob):
    return tlb.fetch_result(tlb.optimize_local_map(K, tlb.upload_problem(_np(prob), "cpu")))


def test_mesh_and_axis_names():
    """``make_mesh`` keeps JAX's axes; without a process group the mesh is
    this process alone, and a ``data`` axis of more ranks, the reserved
    model axis and an ``axis_name`` that is not a ``Mesh`` raise."""
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "model": 1} and not m.distributed and m.group is None
    assert m.data_slice(8) == slice(0, 8) and m.device == torch.device("cpu")
    with pytest.raises(ValueError, match="needs a process group of 4 ranks"):
        tmesh.make_mesh(n_data=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmesh.make_mesh(n_model=2, device="cpu")
    pt = tlb.upload_problem(_np(_windows()[0]), "cpu")
    for name in ("model", "data"):
        with pytest.raises(ValueError, match=r"takes a rspl_slam_tpu_torch\.parallel"):
            tlb.optimize_local_map(K, pt, axis_name=name)


def test_multihost_initialize_without_environment_is_a_noop(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert multihost.initialize(device="cpu") is None
    assert not dist.is_initialized() and not multihost.is_multihost()
    assert multihost.local_batch_slice(8) == slice(0, 8)
    assert multihost.choose_backend("cpu", 2) == "gloo"


@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_batch_slice_matches_jax(world, monkeypatch):
    """JAX's arithmetic for every rank of a world of 1, 2 and 4."""
    for rank in range(world):
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda: world)
        monkeypatch.setattr(dist, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        for n in (4, 7, 8, 12):
            assert multihost.local_batch_slice(n) == jmh.local_batch_slice(n), (world, rank, n)


def test_pad_constraints_matches_jax_bit_for_bit():
    prob = _sharded_problem()
    for ndev in (3, 8):
        got = dist_ba.pad_constraints(_np(prob), ndev)
        ref = jdist.pad_constraints(prob, ndev)
        for f in tlb.BAProblem._fields[:15]:
            a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert len(got.p_valid) % ndev == 0 and got.plan is None


def test_batched_windows_match_jax_and_single_solves():
    """Four windows (seeds 0-3, lines on) in one batched solve against JAX's
    ``batched_windows_ba`` on a 4-device mesh and against the port's single
    solve of each window."""
    windows = _windows()
    got = dist_ba.fetch_windows(dist_ba.batched_windows_ba(K, [_np(w) for w in windows],
                                                           device="cpu"))
    stacked = jax.tree.map(lambda *x: jnp.stack(x), *windows)
    ref = jdist.batched_windows_ba(jba.K, stacked, jmesh.make_mesh(n_data=4))
    rot = trans = pts = lns = cost = single = 0.0
    for w, win in enumerate(windows):
        jT = np.asarray(ref.Tcw[w])
        rot = max(rot, float(np.abs(got[w].Tcw[:, :3, :3] - jT[:, :3, :3]).max()))
        trans = max(trans, float(np.abs(got[w].Tcw[:, :3, 3] - jT[:, :3, 3]).max()))
        pts = max(pts, float(np.abs(got[w].points - np.asarray(ref.points[w])).max()))
        a = np.asarray(jplk.normalize(jnp.asarray(got[w].lines)))
        b = np.asarray(jplk.normalize(ref.lines[w]))
        lns = max(lns, float(np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1)).max()))
        jc = float(ref.cost[w])
        cost = max(cost, abs(float(got[w].cost) - jc) - 1e-3 * abs(jc))
        s = _single(win)
        single = max(single, float(np.abs(got[w].Tcw - s.Tcw).max()))
        np.testing.assert_array_equal(got[w].p_inlier, s.p_inlier)
        np.testing.assert_array_equal(got[w].l_inlier, s.l_inlier)
        np.testing.assert_array_equal(got[w].p_inlier, np.asarray(ref.p_inlier[w]))
    report("batched_windows_ba", rot=rot, trans=trans, points=pts, lines=lns,
           cost_over_rel_bound=cost, tcw_to_single=single)
    assert rot < 1e-4 and trans < 2e-4 and pts < 2e-3 and lns < 1e-3 and cost <= 1e-6
    assert single < 1e-6


def test_sharded_ba_one_rank_in_process(jax_sharded):
    """A mesh of one process is the single solve, bit for bit, on the
    mesh's device whatever the problem holds (numpy here), and holds JAX's
    8-device sharded solve to that test's tolerances."""
    prob = _sharded_problem()
    mesh = tmesh.make_mesh(n_data=1, device="cpu")
    res = dist_ba.sharded_constraints_ba(K, _np(prob), mesh)
    assert all(t.device == mesh.device for t in res)
    got = tlb.fetch_result(res)
    ref = _single(prob)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(got.Tcw, np.asarray(jax_sharded.Tcw), atol=1e-3)
    np.testing.assert_allclose(got.points, np.asarray(jax_sharded.points), atol=1e-2)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ba_over_gloo_ranks(world, gloo_runs, problems, jax_sharded):
    """The landmark-sharded solve in ``world`` processes: the ranks agree bit
    for bit; the result holds the single solve and JAX's; each LM step
    passes ``expected_collective_floats`` floats, on the problem at P and at
    4P landmarks alike."""
    ranks = gloo_runs[0][world]
    for r in ranks[1:]:
        for k in ranks[0]:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)
    got = ranks[0]
    ref = _single(problems["prob"])
    tcw, pts = float(np.abs(got["s0_Tcw"] - ref.Tcw).max()), float(
        np.abs(got["s0_points"] - ref.points).max())
    F = ref.Tcw.shape[0]
    report("sharded_ba", world=world, tcw_to_single=tcw, points_to_single=pts,
           floats_per_step=[int(got["s0_floats_per_step"]), int(got["s1_floats_per_step"])],
           expected=dist_ba.expected_collective_floats(F), lm_steps=int(got["s0_lm_steps"]),
           jax_floats=jdist.expected_collective_floats(F, 64, 8))
    assert tcw < 1e-4 and pts < 3e-3
    np.testing.assert_array_equal(got["s0_l_inlier"], ref.l_inlier)
    np.testing.assert_allclose(got["s0_Tcw"], np.asarray(jax_sharded.Tcw), atol=1e-3)
    np.testing.assert_allclose(got["s0_points"], np.asarray(jax_sharded.points), atol=1e-2)
    assert int(got["s0_lm_steps"]) == 15
    for i in (0, 1):
        assert int(got[f"s{i}_floats_per_step"]) == dist_ba.expected_collective_floats(F)
    # the 4P problem: each of the 4 copies of a point carries the same data
    four = _single(_four_times(problems["prob"]))
    assert float(np.abs(got["s1_Tcw"] - four.Tcw).max()) < 1e-4


@pytest.mark.parametrize("world", [2, 4])
def test_reduced_camera_system_over_gloo_ranks(world, gloo_runs, problems):
    """The first LM step's reduced camera system summed over ``world`` ranks,
    assembled in f64, against the single process's: S, g̃ and the cost
    within 1e-9 of the largest entry (the same function; only the order of
    the sums differs)."""
    S, g, c = tlb.reduced_camera_system(K, tlb.upload_problem(_np(problems["prob"]), "cpu"),
                                        dtype=torch.float64)
    S, g, c = S.numpy(), g.numpy(), float(c)
    for r in gloo_runs[0][world]:
        rel = {"S": float(np.abs(r["sys_S"] - S).max() / np.abs(S).max()),
               "g": float(np.abs(r["sys_g"] - g).max() / np.abs(g).max()),
               "cost": abs(float(r["sys_c"]) - c) / abs(c)}
        report("reduced_camera_system", world=world, **rel)
        assert max(rel.values()) <= 1e-9, rel
        assert r["sys_S"].dtype == np.float64


def test_batched_windows_over_two_ranks(gloo_runs):
    """Each of 2 ranks solves 2 of the 4 windows; every rank gets all 4,
    equal to one process's batched solve (Tcw 1e-6, same inliers)."""
    runs, windows, _ = gloo_runs
    ref = dist_ba.batched_windows_ba(K, windows, device="cpu")
    for r in runs[2]:
        assert float(np.abs(r["b_Tcw"] - ref.Tcw.numpy()).max()) < 1e-6
        np.testing.assert_array_equal(r["b_p_inlier"], ref.p_inlier.numpy())
    np.testing.assert_array_equal(runs[2][0]["b_Tcw"], runs[2][1]["b_Tcw"])


def test_run_global_ba_over_two_ranks(gloo_runs):
    """``run_global_ba(mesh=)`` on 2 gloo ranks against ``run_global_ba()``
    on the same perturbed oracle map."""
    runs, _, slam = gloo_runs
    cost = slam.run_global_ba()
    n = slam.map.n_kf
    for r in runs[2]:
        d = float(np.abs(r["g_kf_pose"] - slam.map.kf_pose[:n]).max())
        report("global_ba_mesh", keyframes=n, pose_max_diff=d,
               cost=[float(r["g_cost"]), cost])
        assert d < 1e-3
        assert abs(float(r["g_cost"]) - cost) <= 1e-3 * abs(cost)
