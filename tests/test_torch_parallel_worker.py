"""One rank of the port's multi-process BA runs (tests/test_torch_parallel.py
starts them): it joins a gloo process group on localhost, runs the jobs of
a JSON file and writes what it got to ``<out>/rank<r>.npz``. It imports the
port only, and does nothing when imported (pytest collects this file).

    python tests/test_torch_parallel_worker.py <rank> <world> <port> <jobs.json> <out>

Jobs (each optional):
  "sharded": problem .npz files (BAProblem fields by name): each through
             ``dist_ba.collective_traffic`` (the sharded solve and its
             float counts);
  "batched": a problem .npz with a leading window axis, through
             ``dist_ba.batched_windows_ba`` on the mesh;
  "global":  {"map": saved map, "seed": scene seed}: ``run_global_ba(mesh=)``
             on that map, the keyframe poses and cost out;
  "system":  a problem .npz: ``local_ba.reduced_camera_system`` on the
             mesh, assembled in f64.
"""

import json
import os
import sys


def _problem(path):
    import numpy as np

    from rspl_slam_tpu_torch.backend.local_ba import BAProblem

    with np.load(path) as z:
        return BAProblem(*[z[f] for f in BAProblem._fields[:15]])


def map_cfg():
    """The small-capacity config of the global-BA map (the parent test
    builds the map with it)."""
    from rspl_slam_tpu_torch.config import PipelineConfig, SuperPointConfig, SystemConfig

    return SystemConfig(superpoint=SuperPointConfig(max_keypoints=256),
                        pipeline=PipelineConfig(ba_max_points=512, ba_max_lines=16,
                                                max_map_keyframes=64, max_map_points=16384,
                                                max_map_lines=1024),
                        use_lines=False)


def main(rank: int, world: int, port: str, jobs_path: str, out: str) -> None:
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
    from rspl_slam_tpu_torch.parallel import dist_ba, multihost

    backend = multihost.initialize(f"tcp://localhost:{port}", world, rank, device="cpu",
                                   timeout_s=120.0)
    mesh = multihost.global_mesh(device="cpu")
    assert mesh.size == world and mesh.rank == rank and backend == "gloo"
    with open(jobs_path) as f:
        jobs = json.load(f)
    K = CameraIntrinsics(*jobs["K"])
    res = {}
    for i, path in enumerate(jobs.get("sharded", [])):
        t = dist_ba.collective_traffic(K, _problem(path), mesh)
        r = t["result"]
        res.update({f"s{i}_Tcw": r.Tcw.numpy(), f"s{i}_points": r.points.numpy(),
                    f"s{i}_lines": r.lines.numpy(), f"s{i}_p_inlier": r.p_inlier.numpy(),
                    f"s{i}_l_inlier": r.l_inlier.numpy(), f"s{i}_cost": r.cost.numpy(),
                    f"s{i}_floats_per_step": t["floats_per_step"],
                    f"s{i}_lm_steps": t["lm_steps"]})
    if "batched" in jobs:
        from rspl_slam_tpu_torch.backend.local_ba import BAProblem

        with np.load(jobs["batched"]) as z:
            stacked = [z[f] for f in BAProblem._fields[:15]]
        probs = [BAProblem(*[a[w] for a in stacked]) for w in range(len(stacked[0]))]
        r = dist_ba.batched_windows_ba(K, probs, mesh)
        res.update(b_Tcw=r.Tcw.numpy(), b_points=r.points.numpy(),
                   b_p_inlier=r.p_inlier.numpy(), b_cost=r.cost.numpy())
    if "system" in jobs:
        from rspl_slam_tpu_torch.backend import local_ba

        S, g, c = local_ba.reduced_camera_system(K, _problem(jobs["system"]), mesh,
                                                 torch.float64)
        res.update(sys_S=S.numpy(), sys_g=g.numpy(), sys_c=c.numpy())
    if "global" in jobs:
        from rspl_slam_tpu_torch.evaluation import synthetic
        from rspl_slam_tpu_torch.frontend.frontends import OracleFrontend
        from rspl_slam_tpu_torch.slam import SLAMSystem

        g = jobs["global"]
        cfg = map_cfg()
        scene = synthetic.make_scene(num_points=900, seed=g["seed"], num_lines=0,
                                     extent=(10.0, 6.0, 16.0))
        slam = SLAMSystem(cfg, OracleFrontend(cfg, scene, device="cpu"), enable_ba=False)
        slam.resume_from_map(g["map"])
        res["g_cost"] = slam.run_global_ba(mesh=mesh)
        res["g_kf_pose"] = slam.map.kf_pose[: slam.map.n_kf]
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
