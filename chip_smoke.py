"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile  # every phase + a torch.profiler breakdown

Phases (one JSON line each):
  1. the card's name and power limit; build every kernel library from
     rspl_slam_tpu_torch/csrc/ with nvcc (one process per source, in
     parallel) and report the build time;
  2. per kernel, at the main path's shapes: the kernel against its plain
     PyTorch version on the same inputs (tolerance in the line), and CUDA
     event timings of the kernel, the plain version and, where one PyTorch
     call computes the same function, that call (a yardstick only);
  3. end to end: the port's SLAMSystem + NeuralFrontend on rendered stereo
     frames at 752×480 (K = 400, 18 GNN layers, 100 Sinkhorn iterations,
     no lines, no BA), with launch counters reset just before and read just
     after; checks initialization, inliers, finite poses and ATE;
  4. the {"kernels": [...]} summary; last line {"ok": true, "device": ...}.

Any failure raises and exits non-zero. The script imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, f32 without
# tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# end-to-end gates (see PERF.md for where the ATE bound comes from)
E2E_FRAMES = 30
E2E_MIN_INLIERS = 20
E2E_ATE_BOUND = 0.35


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(flops: float, nbytes: float, peak_ops: float):
    t_ops = flops / peak_ops * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # f32 stays f32: the port states its TF32 use explicitly
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build():
    from rspl_slam_tpu_torch.ops import cuda_build

    res = cuda_build.build_all()
    for name in cuda_build.SOURCES:
        cuda_build.library(name)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
             for n, log in cuda_build.build_log.items()}
    emit({"phase": "build", "build_s": res["build_s"], "ptxas": ptxas})


def _allclose_report(name, got, ref, rtol, atol, sel=None):
    import torch

    g = got.float()
    r = ref.float()
    if sel is not None:
        g, r = g[sel], r[sel]
    err = (g - r).abs()
    max_err = float(err.max())
    ok = bool(torch.isfinite(g).all()) and bool((err <= atol + rtol * r.abs()).all())
    return ok, max_err


def check_conv_stem(side: bool):
    import torch
    import torch.nn.functional as F

    from rspl_slam_tpu_torch.ops import conv_stem_cuda as cs

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1 if side else 0)
    # SuperPoint conv1b: (2, 480, 752, 64); RCF conv1_2 at ×0.5: (2, 240, 376, 64)
    B, H, W, C = (2, 240, 376, 64) if side else (2, 480, 752, 64)
    x = torch.rand((B, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((3, 3, C, C), generator=g, device=dev) * (2.0 / (9 * C)) ** 0.5
    b = torch.randn((C,), generator=g, device=dev) * 0.1
    sw = torch.randn((C,), generator=g, device=dev) * 0.1 if side else None
    got = cs.conv3x3_relu_pool(x, w, b, sw)
    ref = cs.conv3x3_relu_pool_plain(x, w, b, sw)
    torch.cuda.synchronize()
    rtol, atol = 2.0 ** -7, 1e-3  # one bf16 rounding of near-equal f32 sums
    if side:
        ok, err = _allclose_report("conv_stem", got[0], ref[0], rtol, atol)
        okS, errS = _allclose_report("side", got[1], ref[1], 1e-4,
                                     1e-4 * float(ref[1].abs().max()))
        ok, err = ok and okS, max(err, errS)
    else:
        ok, err = _allclose_report("conv_stem", got, ref, rtol, atol)
    kernel_ms = time_ms(lambda: cs.conv3x3_relu_pool(x, w, b, sw))
    plain_ms = time_ms(lambda: cs.conv3x3_relu_pool_plain(x, w, b, sw))
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory = channels_last
    wc = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bb = b.to(torch.bfloat16)
    library_ms = time_ms(lambda: F.conv2d(xc, wc, bb, padding=1))
    flops = 2.0 * B * H * W * C * 9 * C + (2.0 * B * H * W * C if side else 0.0)
    nbytes = (x.numel() * 2 + 9 * C * C * 4 + C * 4 + B * (H // 2) * (W // 2) * C * 2
              + ((C * 4 + B * H * W * 4) if side else 0))
    bms, by = bound_ms(flops, nbytes, PEAK_BF16)
    line = {"phase": "kernel", "name": "conv_stem_side" if side else "conv_stem",
            "shape": [B, H, W, C], "ok": ok, "max_abs_err": err,
            "tolerance": "|k-p| <= 2^-7|p| + 1e-3 (bf16 out)"
            + ("; side rtol 1e-4, atol 1e-4*max|side|" if side else ""),
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "F.conv2d bf16 channels_last (conv only)",
            "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes}
    emit(line)
    if not ok:
        raise AssertionError(f"conv_stem{'_side' if side else ''} disagrees: {err}")
    return line


def _random_layer(gen, C, dev):
    import torch

    def lin(cin, cout):
        return {"w": torch.randn((cin, cout), generator=gen, device=dev) * cin ** -0.5,
                "b": torch.randn((cout,), generator=gen, device=dev) * 0.1}

    layer = {n: lin(C, C) for n in ("q", "k", "v", "merge")}
    m0, m1 = lin(2 * C, 2 * C), lin(2 * C, C)
    m0["bn_scale"] = 1.0 + 0.1 * torch.randn((2 * C,), generator=gen, device=dev)
    m0["bn_shift"] = 0.1 * torch.randn((2 * C,), generator=gen, device=dev)
    m1["bn_scale"] = torch.ones(C, device=dev)
    m1["bn_shift"] = torch.zeros(C, device=dev)
    layer["mlp"] = [m0, m1]
    return layer


def check_superglue_layer():
    import torch

    from rspl_slam_tpu_torch.ops import attention_cuda as ac

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    n2, K, C = 2, 400, 256
    layer = ac.pack_layer(_random_layer(gen, C, dev), dev)
    x = torch.randn((n2, K, C), generator=gen, device=dev)
    masks = torch.arange(K, device=dev)[None] < torch.tensor([[K], [331]], device=dev)
    rtol, atol = 1e-3, 1e-3
    errs, ok = [], True
    for cross in (False, True):
        got = ac.superglue_layer(x, masks, layer, cross)
        ref = ac.superglue_layer_plain(x, masks, layer, cross)
        torch.cuda.synchronize()
        o, e = _allclose_report("superglue_layer", got, ref, rtol, atol)
        ok &= o
        errs.append(e)
    kernel_ms = time_ms(lambda: ac.superglue_layer(x, masks, layer, True))
    plain_ms = time_ms(lambda: ac.superglue_layer_plain(x, masks, layer, True))
    n = n2 * K
    flops = 2.0 * n * (C * 3 * C + K * C + K * C + C * C + 2 * C * 2 * C + 2 * C * C)
    nbytes = 4.0 * (2 * x.numel() + n + sum(int(v.numel()) for v in layer.values()))
    bms, by = bound_ms(flops, nbytes, PEAK_F32)
    line = {"phase": "kernel", "name": "superglue_layer", "shape": [n2, K, C],
            "ok": ok, "max_abs_err": max(errs), "max_abs_err_self_cross": errs,
            "tolerance": "rtol 1e-3, atol 1e-3 (f32, other summation order)",
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call computes a whole GNN layer",
            "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes}
    emit(line)
    if not ok:
        raise AssertionError(f"superglue_layer disagrees: {errs}")
    return line


def check_sinkhorn():
    import torch

    from rspl_slam_tpu_torch.ops import sinkhorn as sk
    from rspl_slam_tpu_torch.ops import sinkhorn_cuda as skc

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(3)
    B, M, N, iters = 1, 400, 400, 100
    scores = torch.randn((B, M, N), generator=gen, device=dev) * 3.0
    m0 = torch.arange(M, device=dev)[None] < 371
    m1 = torch.arange(N, device=dev)[None] < 352
    Z0, mu, nu, norm = sk.build_problem(scores, m0, m1, 1.0)
    got = skc.sinkhorn_iterations(Z0, mu, nu, iters) - norm[:, None, None]
    ref = sk.sinkhorn_iterations_plain(Z0, mu, nu, iters) - norm[:, None, None]
    torch.cuda.synchronize()
    mv = torch.cat([m0, torch.ones((B, 1), dtype=torch.bool, device=dev)], 1)
    nv = torch.cat([m1, torch.ones((B, 1), dtype=torch.bool, device=dev)], 1)
    sel = mv[:, :, None] & nv[:, None, :]
    ok, err = _allclose_report("sinkhorn", got, ref, 0.0, 1e-3, sel)
    kernel_ms = time_ms(lambda: skc.sinkhorn_iterations(Z0, mu, nu, iters))
    plain_ms = time_ms(lambda: sk.sinkhorn_iterations_plain(Z0, mu, nu, iters), n=5)
    elems = B * (M + 1) * (N + 1)
    flops = 4.0 * 2 * iters * elems
    nbytes = 4.0 * (2 * elems + B * (M + 1) + B * (N + 1))
    bms, by = bound_ms(flops, nbytes, PEAK_F32)
    line = {"phase": "kernel", "name": "sinkhorn", "shape": [B, M + 1, N + 1],
            "iters": iters, "ok": ok, "max_abs_err": err,
            "tolerance": "max |k-p| < 1e-3 on valid rows, columns and dustbins",
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call runs Sinkhorn",
            "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes}
    emit(line)
    if not ok:
        raise AssertionError(f"sinkhorn disagrees: {err}")
    return line


def _counters():
    from rspl_slam_tpu_torch.ops import attention_cuda, conv_stem_cuda, sinkhorn_cuda

    return {"conv_stem": conv_stem_cuda.launches,
            "conv_stem_side": conv_stem_cuda.side_launches,
            "superglue_layer": attention_cuda.launches,
            "sinkhorn": sinkhorn_cuda.launches}


def _reset_counters():
    from rspl_slam_tpu_torch.ops import attention_cuda, conv_stem_cuda, sinkhorn_cuda

    conv_stem_cuda.launches = conv_stem_cuda.side_launches = 0
    attention_cuda.launches = 0
    sinkhorn_cuda.launches = 0


def phase_end_to_end():
    """The port's SLAMSystem + NeuralFrontend on rendered EuRoC-size frames."""
    import torch

    from rspl_slam_tpu_torch.config import SystemConfig
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error, synthetic
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.models import superglue, superpoint
    from rspl_slam_tpu_torch.slam import INIT_POSE, SLAMSystem

    cfg = SystemConfig(use_lines=False)  # 752×480, K = 400, 18 layers, 100 iters
    cam = cfg.camera
    t0 = time.perf_counter()
    scene = synthetic.make_scene(num_points=600, num_lines=0, seed=1,
                                 extent=(6.0, 4.0, 6.0), on_line_frac=0.0)
    traj = synthetic.make_trajectory(E2E_FRAMES, step=0.05)
    frames = [synthetic.render_images(scene, cam, traj[i], seed=i)
              for i in range(E2E_FRAMES)]
    render_s = time.perf_counter() - t0
    sp = superpoint.init_params(0)
    sg = superglue.descriptor_matcher_params(cfg.superglue, 0, 2000.0, 1980.0)
    fe = NeuralFrontend(cfg, sp_params=sp, sg_params=sg)  # the card, bf16 convs
    warm = SLAMSystem(cfg, fe, enable_ba=False)  # first-call set-up, not timed
    for i in range(2):
        warm.add_frame(i, 0.05 * i, *frames[i])
    torch.cuda.synchronize()

    slam = SLAMSystem(cfg, fe, enable_ba=False)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    recs = [slam.add_frame(i, 0.05 * i, *frames[i]) for i in range(E2E_FRAMES)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counters()

    est = np.stack([r.Twc for r in recs])
    ts = np.arange(E2E_FRAMES) * 0.05
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    ate = absolute_trajectory_error(ts, est[:, :3, 3], ts, gt[:, :3, 3])["rmse"]
    inliers = [int(r.num_inliers) for r in recs[1:]]
    tracked = sum(n > E2E_MIN_INLIERS for n in inliers)
    med = {k: float(np.median(v)) * 1e3 for k, v in slam.timings.items()}
    line = {"phase": "end_to_end", "frames": E2E_FRAMES, "image": [cam.image_width,
            cam.image_height], "max_keypoints": cfg.superpoint.max_keypoints,
            "gnn_layers": cfg.superglue.num_gnn_layers,
            "sinkhorn_iters": cfg.superglue.sinkhorn_iterations,
            "initialized": slam.initialized, "keyframes": int(slam.map.n_kf),
            "inliers": inliers, "frames_over_min_inliers": tracked,
            "ate_rmse_m": float(ate), "ate_bound_m": E2E_ATE_BOUND,
            "frames_per_s": E2E_FRAMES / wall, "wall_s": wall,
            "stage_median_ms": med, "render_s": render_s,
            "max_memory_allocated_MB": torch.cuda.max_memory_allocated() / 2**20,
            "launches": launches}
    emit(line)
    if not slam.initialized:
        raise AssertionError("end to end: the map did not initialize")
    if tracked < 0.8 * len(inliers):
        raise AssertionError(f"end to end: too few tracked frames: {inliers}")
    if not np.isfinite(est).all():
        raise AssertionError("end to end: non-finite pose")
    if not ate < E2E_ATE_BOUND:
        raise AssertionError(f"end to end: ATE {ate} over the bound {E2E_ATE_BOUND}")
    for name in ("conv_stem", "superglue_layer", "sinkhorn"):
        if launches[name] <= 0:
            raise AssertionError(f"end to end: kernel {name} never launched")
    return line, launches, (cfg, fe, frames)


def phase_profile(cfg, fe, frames, n_warm: int = 3, n_prof: int = 3):
    """torch.profiler over a few tracked frames of a fresh run: device time
    by operator, the host↔device copies and synchronizations, and the
    device's busy share of the window (``--profile`` only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from rspl_slam_tpu_torch.slam import SLAMSystem

    slam = SLAMSystem(cfg, fe, enable_ba=False)
    for i in range(n_warm):
        slam.add_frame(i, 0.05 * i, *frames[i])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_warm, n_warm + n_prof):
            slam.add_frame(i, 0.05 * i, *frames[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev = sorted(ka, key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in ka) / 1e3
    host = {e.key: e.count for e in ka
            if e.key in ("cudaMemcpyAsync", "cudaStreamSynchronize", "cudaDeviceSynchronize",
                         "aten::_local_scalar_dense", "cudaLaunchKernel", "cudaLaunchKernelExC")}
    emit({"phase": "profile", "frames": n_prof, "wall_ms_per_frame": wall * 1e3 / n_prof,
          "device_ms_per_frame": device_ms / n_prof,
          "device_busy_share": device_ms / (wall * 1e3),
          "host_calls_per_frame": {k: v / n_prof for k, v in host.items()},
          "top_device_ms_per_frame": [
              [e.key[:60], e.self_device_time_total / 1e3 / n_prof, e.count // n_prof]
              for e in dev[:15]]})


SOURCES = {
    "conv_stem": ("rspl_slam_tpu_torch/csrc/conv_stem.cu",
                  "rspl_slam_tpu/ops/conv_stem_pallas.py:126"),
    "superglue_layer": ("rspl_slam_tpu_torch/csrc/superglue_layer.cu",
                        "rspl_slam_tpu/ops/attention_pallas.py:93"),
    "sinkhorn": ("rspl_slam_tpu_torch/csrc/sinkhorn.cu",
                 "rspl_slam_tpu/ops/sinkhorn_pallas.py:61"),
}
KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def phase_summary(lines, launches):
    kernels = []
    for name, (src, tpu) in SOURCES.items():
        k = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
             "launches": launches[name], **{key: lines[name][key] for key in KEYS}}
        if name == "conv_stem":  # the same kernel in RCF's side-output mode
            side = lines["conv_stem_side"]
            k["side_mode"] = {"launches": launches["conv_stem_side"],
                              "shape": side["shape"],
                              **{key: side[key] for key in KEYS}}
        kernels.append(k)
    emit({"kernels": kernels})


def main(argv) -> int:
    if not os.path.isdir(os.path.join(ROOT, "rspl_slam_tpu_torch")):
        print("chip_smoke: the rspl_slam_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    phase_device()
    phase_build()
    lines = {}
    lines["conv_stem"] = check_conv_stem(side=False)
    lines["conv_stem_side"] = check_conv_stem(side=True)
    lines["superglue_layer"] = check_superglue_layer()
    lines["sinkhorn"] = check_sinkhorn()
    e2e, launches, run = phase_end_to_end()
    if "--profile" in argv:
        phase_profile(*run)
    phase_summary(lines, launches)
    import torch

    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
