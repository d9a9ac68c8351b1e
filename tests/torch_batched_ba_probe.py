"""How well determined each multi-sequence BA window is, on the card.

    python tests/torch_batched_ba_probe.py   # from the repo root, one CUDA card

Runs ``chip_smoke.py``'s ``multi_sequence`` phase, gathers each sequence's
last window as its ``batched_ba`` phase does, and prints one ``BA_DIAG``
line per window: camera positions (max |difference|, m) of the batched
solve against the single one, of the single solve repeated, with its
points nudged by 1e-7 (relative), on the CPU, and of an f64 solve against
the f32 single and batched ones, beside each solve's cost. Where the nudge
moves the single solve as far as the batched solve lies from it, the
window's f32 solution is only determined to that spread. Then runs the
``batched_ba`` phase itself on the same windows (its line holds the f64
solves and the first LM step's system, batched against single).
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from rspl_slam_tpu_torch.backend import local_ba  # noqa: E402
from rspl_slam_tpu_torch.parallel import dist_ba  # noqa: E402


def main() -> int:
    cs.phase_device()
    cs.phase_build()
    _, _, msq = cs.phase_multi_sequence(None)
    K, kw, dev = msq.slams[0].K, cs._ba_kw(msq.cfg), msq.slams[0].device
    probs, maps = [], []
    for slam in msq.slams:
        prob, mapping = slam.gather_ba_problem(int(slam.map.n_kf) - 1)
        if prob is not None:
            probs.append(prob)
            maps.append(mapping)
    got = dist_ba.fetch_windows(dist_ba.batched_windows_ba(K, probs, device=dev, **kw))

    def single(p, nudge=0.0, f64=False, device=dev):
        up = local_ba.upload_problem(p, device)
        if nudge:
            up = up._replace(points=up.points * (1 + nudge))
        if f64:
            up = up._replace(**{f: getattr(up, f).double() for f in up._fields
                                if torch.is_tensor(getattr(up, f))
                                and getattr(up, f).is_floating_point()})
        return local_ba.fetch_result(local_ba.optimize_local_map(K, up, **kw))

    def dist(a, b, n):
        pos = lambda T: np.linalg.inv(np.asarray(T, np.float64))[:n, :3, 3]  # noqa: E731
        return float(np.abs(pos(a.Tcw) - pos(b.Tcw)).max())

    for w, (p, m, g) in enumerate(zip(probs, maps, got)):
        n = len(m["frames"])
        s, s2, sn, sc, s64 = (single(p), single(p), single(p, nudge=cs.DIST_NUDGE),
                              single(p, device="cpu"), single(p, f64=True))
        print("BA_DIAG", {"window": w, "ncp": int(m["ncp"]), "ncl": int(m["ncl"]),
                          "batched_vs_single_m": dist(g, s, n),
                          "single_repeat_m": dist(s2, s, n),
                          "nudged_vs_single_m": dist(sn, s, n),
                          "cpu_vs_card_single_m": dist(sc, s, n),
                          "f64_vs_single_m": dist(s64, s, n),
                          "f64_vs_batched_m": dist(s64, g, n),
                          "costs_batched_single_nudged_cpu_f64": [
                              float(r.cost) for r in (g, s, sn, sc, s64)]}, flush=True)
    cs.phase_batched_ba(msq)
    return 0


if __name__ == "__main__":
    sys.exit(main())
