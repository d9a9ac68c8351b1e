"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile  # every phase + a torch.profiler breakdown
                                     # of the lines path and launches per BA window
    python3 chip_smoke.py --kernels  # device, build, kernel phases, summary

Phases (one JSON line each):
  1. the card's name and power limit; build every kernel library from
     rspl_slam_tpu_torch/csrc/ with nvcc (one process per source, in
     parallel) and report the build time;
  2. per kernel, at the main path's shapes: the kernel against its plain
     PyTorch version on the same inputs (tolerance in the line), and CUDA
     event timings of the kernel, the plain version and, where one PyTorch
     call computes the same function, that call (a yardstick only); K1 also
     in its side-output mode, K2 in its bf16 (main path) and f32 modes;
  3. ``local_ba_check``: local BA (``backend/local_ba.optimize_local_map``,
     no kernel of its own) on the card against the same function on CPU
     tensors, on the captured divergence window and on a synthetic window
     at the default capacities, the card's run under
     ``torch.cuda.set_sync_debug_mode("error")``; CUDA-event and host-issue
     ms per window;
  4. end to end, four paths, each with the launch counters reset just
     before and read just after: ``end_to_end_ba``, the true default
     ``SLAMSystem(SystemConfig(), fe)`` (752×480, K = 400, 18 GNN layers at
     bf16, 100 Sinkhorn iterations, RCF at ×0.5 through K1's side mode +
     the Hough detector on both eyes, keyframe maplines, async local BA
     with point and line terms after every keyframe) on a scene with 12
     dark segments and the hand-set edge weights; ``end_to_end_lines``, the
     same with ``enable_ba=False``; then ``end_to_end``, the point-only
     path (``use_lines=False``, BA off). Each checks initialization,
     inliers, finite poses and ATE; the lines paths also lines per frame,
     maplines with endpoints and one K1 side-mode launch per frame; the BA
     path also solved windows, line constraints in BA, and a finite map
     after the last ``flush_ba()``; ``end_to_end_ba`` runs twice and its
     ATE must repeat bit for bit (``ba_repeat``); then
     ``end_to_end_lazy``, the production loop as the JAX package's
     ``bench.py:measured_pipeline`` drives it: ``PipelinedRunner`` over
     ``SLAMSystem(SystemConfig(pipeline=PipelineConfig(
     lazy_right_extraction=True)), fe)`` (lines, async BA, the combined
     frame step) on the same frames quantized to 8 bits, gated also on the
     stereo completions (one per initialization attempt and per keyframe,
     no tracked-only frame downloading its descriptors), K1 launches in
     both modes = frames + completions, and fewer K3 launches than the BA
     path; the same frames through serial ``add_frame`` calls, then the
     runner once more, give the serial frames/s beside the runner's;
  5. the command line, as a user types it, in a subprocess that cannot
     import PyYAML, PIL or matplotlib (stub packages that raise on import
     come first on its path, as on a card machine without them):
     ``cli_run``, ``python -m rspl_slam_tpu_torch.cli run --config
     configs/euroc.yaml`` (the default main path: lines, async BA) on the
     BA path's 30 frames quantized to 8 bits and written as a raw-EuRoC
     PNG tree, with the smoke's weights as ``.npz`` and an OpenCV-layout
     camera file (identity R, zero D: the remap runs); gated on the exit,
     30 frames, the decoded frames equal to the written ones, the ATE,
     the trajectory file equal to an in-process ``PipelinedRunner`` run's,
     the map reloading and ``resume_from_map`` tracking 5 more frames,
     the visualization PNGs decoding, and the CLI's printed kernel launch
     counts (equal to the in-process run's); ``cli_synth``, ``synth
     --frames 100`` (the unfused tracking path) under an ATE bound from
     the JAX CLI's own run; ``cli_convert``, ``convert-weights`` of
     public-layout state dicts against the direct loaders. The PNG
     reader's compiled row unfilter (host code, no kernel) is held against
     the numpy one bit for bit in ``png_unfilter`` after the kernel
     checks, in every mode;
  6. the {"kernels": [...]} summary (launches from the BA path, the
     default main path; each path's counts in ``launches_by_path``, the
     CLI's as ``cli_run``; each path's ATE in ``ate_by_path``); last line
     {"ok": true, "device": ...}. With --kernels, phases 3-5 are skipped
     and the summary's launch counts are null.

Any failure raises and exits non-zero. The script imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM dense peaks (NVIDIA data sheet): bf16 tensor cores, f32 without
# tensor cores, HBM3 bandwidth; the SFU's exponentials: 16 per SM per clock
# on 132 SMs at the 1.98 GHz boost clock
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_SFU = 132 * 16 * 1.98e9

# end-to-end gates (see PERF.md for where the ATE bound comes from: the JAX
# package's ATE on each path's scene at 376×240 on the CPU, with margin:
# points 0.2229 m, lines scene 0.2123 m, lines scene with BA 0.2123 m,
# the lazy production loop 0.2046 m)
E2E_FRAMES = 30
E2E_MIN_INLIERS = 20
E2E_ATE_BOUND = 0.35
E2E_ATE_BOUND_LAZY = 0.35


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(flops: float, nbytes: float, peak_ops: float, sfu_ops: float = 0.0):
    """The least time of the work (ms) and what sets it: the bytes at the
    HBM rate, or the operations at their unit's peak (FMA-class work at
    ``peak_ops``; exponentials at the SFU rate), whichever is largest."""
    t_ops = max(flops / peak_ops, sfu_ops / PEAK_SFU) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def rates(line: dict) -> dict:
    """Achieved rate and bound fraction (bound_ms / ms) of a kernel line."""
    out = {"tflops": line["flops"] / line["ms"] * 1e-9,
           "bound_fraction": line["bound_ms"] / line["ms"]}
    if "elements" in line:
        out["elements_per_s"] = line["elements"] / line["ms"] * 1e3
    return out


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


def host_ms(fn, n: int = 20) -> float:
    """Host time (ms) to issue one call without waiting for the device.
    Where it nears :func:`time_ms` of the same calls, that event time is
    the host's issue rate, not the kernel's."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e3


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


def _conv_case(B, H, W, side: bool, seed: int):
    """K1 against its plain version on (B, H, W, 64) bf16 (with the side
    score in side mode), timed: the kernel line's fields."""
    import torch
    import torch.nn.functional as F

    from rspl_slam_tpu_torch.ops import conv_stem_cuda as cs

    dev = "cuda"
    C = 64
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((B, H, W, C), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((3, 3, C, C), generator=g, device=dev) * (2.0 / (9 * C)) ** 0.5
    b = torch.randn((C,), generator=g, device=dev) * 0.1
    sw = torch.randn((C,), generator=g, device=dev) * 0.1 if side else None
    wp = cs.pack_weights(w)  # once per weight tensor, as SuperPoint caches it
    got = cs.conv3x3_relu_pool(x, wp, b, sw)
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
    kernel_ms = time_ms(lambda: cs.conv3x3_relu_pool(x, wp, b, sw))
    wrapper_host_ms = host_ms(lambda: cs.conv3x3_relu_pool(x, wp, b, sw))
    plain_ms = time_ms(lambda: cs.conv3x3_relu_pool_plain(x, w, b, sw))
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory = channels_last
    wc = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    bb = b.to(torch.bfloat16)
    library_ms = time_ms(lambda: F.conv2d(xc, wc, bb, padding=1))
    flops = 2.0 * B * H * W * C * 9 * C + (2.0 * B * H * W * C if side else 0.0)
    nbytes = (x.numel() * 2 + 9 * C * C * 2 + C * 4 + B * (H // 2) * (W // 2) * C * 2
              + ((C * 4 + B * H * W * 4) if side else 0))
    bms, by = bound_ms(flops, nbytes, PEAK_BF16)
    line = {"shape": [B, H, W, C], "ok": ok, "max_abs_err": err,
            "ms": kernel_ms, "host_ms": wrapper_host_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bms, "bound_by": by,
            "flops": flops, "bytes": nbytes}
    line.update(rates(line))
    return line


def check_conv_stem(side: bool):
    """K1 at the eager path's B = 2 (the timed line) and at the lazy path's
    B = 1 (one eye per launch; listed in ``checks``)."""
    # SuperPoint conv1b: (B, 480, 752, 64); RCF conv1_2 at ×0.5: (B, 240, 376, 64)
    H, W = (240, 376) if side else (480, 752)
    seed = 1 if side else 0
    line = {"phase": "kernel", "name": "conv_stem_side" if side else "conv_stem",
            **_conv_case(2, H, W, side, seed),
            "tolerance": "|k-p| <= 2^-7|p| + 1e-3 (bf16 out)"
            + ("; side rtol 1e-4, atol 1e-4*max|side|" if side else ""),
            "library": "F.conv2d bf16 channels_last (conv only)"}
    one = _conv_case(1, H, W, side, seed + 10)
    line["checks"] = [{k: one[k] for k in ("shape", "ok", "max_abs_err", "ms", "plain_ms",
                                           "library_ms", "bound_ms", "bound_fraction")}]
    emit(line)
    if not (line["ok"] and one["ok"]):
        raise AssertionError(f"conv_stem{'_side' if side else ''} disagrees: "
                             f"{line['max_abs_err']}, B = 1: {one['max_abs_err']}")
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


def _layer_case(ac, gen, layer, K, valid, compute_dtype, rtol, atol):
    """K2 against its plain version at (2, K, 256), self and cross, with
    ``valid`` keys in the second set: (ok, [max error self, cross], x,
    masks, scratch)."""
    import torch

    dev = "cuda"
    x = torch.randn((2, K, 256), generator=gen, device=dev)
    masks = torch.arange(K, device=dev)[None] < torch.tensor([[K], [valid]], device=dev)
    scratch = ac.layer_scratch(x, masks, compute_dtype)
    errs, ok = [], True
    for cross in (False, True):
        got = ac.superglue_layer(x, masks, layer, cross, compute_dtype=compute_dtype,
                                 scratch=scratch)
        ref = ac.superglue_layer_plain(x, masks, layer, cross, compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        o, e = _allclose_report("superglue_layer", got, ref, rtol, atol)
        ok &= o
        errs.append(e)
    return ok, errs, x, masks, scratch


def check_superglue_layer(bf16: bool):
    """K2 in its bf16 or f32 mode at the main path's (2, 400, 256), timed;
    the bf16 mode also at ragged K = 48, 301 and OIVIO's 600 (listed in
    ``checks``)."""
    import torch

    from rspl_slam_tpu_torch.ops import attention_cuda as ac

    dev = "cuda"
    compute_dtype = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device=dev).manual_seed(2)
    n2, K, C = 2, 400, 256
    layer = ac.pack_layer(_random_layer(gen, C, dev), dev)
    if bf16:  # one bf16 intermediate on the other side of a rounding boundary
        rtol, atol = 2.0 ** -8, 4e-3
        tol = "|k-p| <= 2^-8|p| + 4e-3 (bf16 operands; another f32 summation order)"
    else:
        rtol, atol = 1e-3, 1e-3
        tol = "rtol 1e-3, atol 1e-3 (f32, other summation order)"
    ok, errs, x, masks, scratch = _layer_case(ac, gen, layer, K, 331, compute_dtype, rtol, atol)
    checks = []
    if bf16:
        for k, valid in ((48, 40), (301, 250), (600, 577)):
            o, e, *_ = _layer_case(ac, gen, layer, k, valid, compute_dtype, rtol, atol)
            ok &= o
            checks.append({"shape": [2, k, C], "valid": [k, valid], "ok": o,
                           "max_abs_err_self_cross": e})
    def kernel():
        return ac.superglue_layer(x, masks, layer, True, compute_dtype=compute_dtype,
                                  scratch=scratch)

    kernel_ms = time_ms(kernel)
    wrapper_host_ms = host_ms(kernel)  # K2's two launches are short: see host_ms
    plain_ms = time_ms(lambda: ac.superglue_layer_plain(x, masks, layer, True,
                                                        compute_dtype=compute_dtype))
    n = n2 * K
    flops = 2.0 * n * (C * 3 * C + K * C + K * C + C * C + 2 * C * 2 * C + 2 * C * C)
    # x in and out, the mask, and once each layer tensor this mode's kernels read
    nbytes = 4.0 * (2 * x.numel() + n) + sum(
        layer[k].numel() * layer[k].element_size() for k in ac.LAYER_KEYS[compute_dtype])
    bms, by = bound_ms(flops, nbytes, PEAK_BF16 if bf16 else PEAK_F32)
    line = {"phase": "kernel", "name": "superglue_layer" if bf16 else "superglue_layer_f32",
            "compute_dtype": str(compute_dtype).replace("torch.", ""),
            "shape": [n2, K, C], "valid": [K, 331],
            "ok": ok, "max_abs_err": max(errs), "max_abs_err_self_cross": errs,
            "tolerance": tol, "checks": checks,
            "ms": kernel_ms, "host_ms": wrapper_host_ms, "plain_ms": plain_ms,
            "library_ms": None,
            "library": "none: no single PyTorch call computes a whole GNN layer",
            "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes}
    line.update(rates(line))
    emit(line)
    if not ok:
        raise AssertionError(f"{line['name']} disagrees: {errs}, {checks}")
    return line


def _sinkhorn_case(gen, M, N, valid0, valid1, matcher: bool, iters: int = 100,
                   plain_n: int = 5):
    """K3 against the plain sweeps on one (1, M+1, N+1) problem: random
    scores ×3 with dustbin 1.0, or the matcher's own scale (2000·cos of
    unit descriptors, half of them matched across the sets, dustbin 1980,
    as descriptor_matcher_params sets SuperGlue up)."""
    import torch
    import torch.nn.functional as F

    from rspl_slam_tpu_torch.ops import sinkhorn as sk
    from rspl_slam_tpu_torch.ops import sinkhorn_cuda as skc

    dev = "cuda"
    if matcher:
        d0 = F.normalize(torch.randn((1, M, 256), generator=gen, device=dev), dim=-1)
        d1 = F.normalize(torch.randn((1, N, 256), generator=gen, device=dev), dim=-1)
        k = min(M, N) // 2
        perm = torch.randperm(N, generator=gen, device=dev)[:k]
        d1[:, perm] = F.normalize(
            d0[:, :k] + 0.1 * torch.randn((1, k, 256), generator=gen, device=dev), dim=-1)
        scores, bin_score = 2000.0 * d0 @ d1.transpose(1, 2), 1980.0
    else:
        scores, bin_score = torch.randn((1, M, N), generator=gen, device=dev) * 3.0, 1.0
    m0 = torch.arange(M, device=dev)[None] < valid0
    m1 = torch.arange(N, device=dev)[None] < valid1
    Z0, mu, nu, norm = sk.build_problem(scores, m0, m1, bin_score)
    got = skc.sinkhorn_iterations(Z0, mu, nu, iters) - norm[:, None, None]
    ref = sk.sinkhorn_iterations_plain(Z0, mu, nu, iters) - norm[:, None, None]
    torch.cuda.synchronize()
    one = torch.ones((1, 1), dtype=torch.bool, device=dev)
    sel = torch.cat([m0, one], 1)[:, :, None] & torch.cat([m1, one], 1)[:, None, :]
    ok, err = _allclose_report("sinkhorn", got, ref, 0.0, 1e-3, sel)
    kernel_ms = time_ms(lambda: skc.sinkhorn_iterations(Z0, mu, nu, iters))
    plain_ms = time_ms(lambda: sk.sinkhorn_iterations_plain(Z0, mu, nu, iters), n=plain_n)
    elems = (M + 1) * (N + 1)
    sweeps = 2 * iters * elems  # one exponential per element per sweep
    flops = 4.0 * sweeps
    nbytes = 4.0 * (2 * elems + (M + 1) + (N + 1))
    bms, by = bound_ms(flops, nbytes, PEAK_F32, sfu_ops=sweeps)
    plan = skc.cluster_plan(M + 1, N + 1)
    line = {"phase": "kernel", "name": "sinkhorn", "shape": [1, M + 1, N + 1],
            "iters": iters, "scores": "matcher 2000*cos, bin 1980" if matcher
            else "randn*3, bin 1", "valid": [valid0, valid1],
            "cluster_plan": plan._asdict(), "ok": ok, "max_abs_err": err,
            "tolerance": "max |k-p| < 1e-3 on valid rows, columns and dustbins",
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call runs Sinkhorn",
            "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes,
            "elements": float(sweeps)}
    line.update(rates(line))
    emit(line)
    if not ok:
        raise AssertionError(f"sinkhorn disagrees at {line['shape']} "
                             f"({line['scores']}): {err}")
    return line


def check_sinkhorn():
    """K3 at the main path's shape (the timed line), and at OIVIO's K = 600
    and the matcher's score scale (checks listed in the summary)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    line = _sinkhorn_case(gen, 400, 400, 371, 352, matcher=False)
    line["checks"] = [
        {k: c[k] for k in ("shape", "scores", "valid", "max_abs_err", "ms",
                           "bound_ms", "bound_fraction")}
        for c in (_sinkhorn_case(gen, 600, 600, 577, 541, matcher=False, plain_n=2),
                  _sinkhorn_case(gen, 400, 400, 200, 337, matcher=True, plain_n=2))]
    return line


def _counters():
    from rspl_slam_tpu_torch.ops import cuda_build

    return cuda_build.launch_counts()


def _reset_counters():
    from rspl_slam_tpu_torch.ops import attention_cuda, conv_stem_cuda, sinkhorn_cuda

    conv_stem_cuda.launches = conv_stem_cuda.side_launches = 0
    attention_cuda.launches = attention_cuda.f32_launches = 0
    sinkhorn_cuda.launches = 0


def phase_local_ba_check(profile: bool):
    """Local BA on the card against the same function on CPU tensors: the
    captured f32 divergence window (tests/fixtures/ba_divergence_case.npz)
    and a synthetic window at the default capacities (F = 10, P = 1536,
    L = 128, Cp = 6144, Cl = 512; 4 views per landmark, mono and stereo
    mixed, 0.3 px noise, 5% outliers; numpy seed 0). The card's solve runs
    under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
    CUDA-event ms and host-issue ms per window; with ``profile``, the
    kernel launches of one window."""
    import torch

    from rspl_slam_tpu_torch.backend import local_ba
    from rspl_slam_tpu_torch.backend.residuals import CameraIntrinsics
    from rspl_slam_tpu_torch.config import CameraConfig
    from rspl_slam_tpu_torch.evaluation import synthetic

    cam = CameraConfig()
    K = CameraIntrinsics(cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)
    fixture = dict(np.load(os.path.join(ROOT, "tests", "fixtures", "ba_divergence_case.npz")))
    synth, gt = synthetic.make_ba_window(cam, seed=0)
    out = []
    for name, prob_np in (("fixture", fixture), ("synthetic", synth)):
        prob = local_ba.BAProblem(**prob_np)
        t0 = time.perf_counter()
        cpu = local_ba.fetch_result(local_ba.optimize_local_map(
            K, local_ba.upload_problem(prob, "cpu")))
        cpu_s = time.perf_counter() - t0
        dev = local_ba.upload_problem(prob, "cuda")
        local_ba.optimize_local_map(K, dev)  # first call: library handles, not timed
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = local_ba.optimize_local_map(K, local_ba.upload_problem(prob, "cuda"))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        gpu = local_ba.fetch_result(res)

        def solve():
            return local_ba.optimize_local_map(K, dev)

        rows = len(gpu.p_inlier) + len(gpu.l_inlier)
        flips = int((gpu.p_inlier != cpu.p_inlier).sum() + (gpu.l_inlier != cpu.l_inlier).sum())
        cost_rel = abs(float(gpu.cost) - float(cpu.cost)) / float(cpu.cost)
        line = {"phase": "local_ba_check", "window": name,
                "shape": {"F": len(gpu.Tcw), "P": len(gpu.points), "L": len(gpu.lines),
                          "Cp": len(gpu.p_inlier), "Cl": len(gpu.l_inlier)},
                "valid_rows": [int(prob_np["p_valid"].sum()), int(prob_np["l_valid"].sum())],
                "cost": [float(gpu.cost), float(cpu.cost)], "cost_rel_err": cost_rel,
                "inliers": [int(gpu.p_inlier.sum()), int(cpu.p_inlier.sum())],
                "line_inliers": [int(gpu.l_inlier.sum()), int(cpu.l_inlier.sum())],
                "inlier_flips": flips,
                "pose_max_diff_m": float(np.abs(gpu.Tcw - cpu.Tcw)[:, :3, 3].max()),
                "tolerance": "finite; cost rel <= 0.25 (5 restarted quadratic LM "
                             "iterations accept steps by f32 sums); inlier flags differ "
                             "on <= max(2, 1%) of rows; poses <= 3e-2 m apart",
                "sync_free": True, "ms": time_ms(solve, n=5, warmup=1),
                "host_ms": host_ms(solve, n=5), "cpu_s": cpu_s}
        if name == "fixture":
            line["jax_assertions"] = "cost < 2000, inliers > 600"
        else:
            line["gt_pose_max_err_m"] = float(np.abs(gpu.Tcw - gt["Tcw"])[:, :3, 3].max())
            line["gt_point_median_err_m"] = float(np.median(
                np.linalg.norm(gpu.points - gt["points"], axis=-1)))
        if profile:
            from torch.profiler import ProfilerActivity, profile as torch_profile

            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                solve()
                torch.cuda.synchronize()
            ka = prof.key_averages()
            line["launches_per_window"] = sum(
                e.count for e in ka if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
            line["device_ms_profiler"] = sum(e.self_device_time_total for e in ka) / 1e3
        emit(line)
        ok = (np.isfinite(gpu.Tcw).all() and np.isfinite(gpu.points).all()
              and np.isfinite(gpu.lines).all() and np.isfinite(float(gpu.cost))
              and cost_rel <= 0.25 and flips <= max(2, 0.01 * rows)
              and line["pose_max_diff_m"] < 3e-2)
        if name == "fixture":
            ok = ok and float(gpu.cost) < 2000.0 and int(gpu.p_inlier.sum()) > 600
        else:
            ok = ok and line["gt_pose_max_err_m"] < 0.01
        if not ok:
            raise AssertionError(f"local_ba_check ({name}) failed: {line}")
        out.append(line)
    return out


def _scene(cfg, lines: bool):
    """The end-to-end scene's 30 rendered stereo pairs (with 12 dark
    segments on the lines paths), the ground-truth trajectory, and the
    render time."""
    from rspl_slam_tpu_torch.evaluation import synthetic

    t0 = time.perf_counter()
    scene = synthetic.make_scene(num_points=600, num_lines=12 if lines else 0, seed=1,
                                 extent=(6.0, 4.0, 6.0), on_line_frac=0.0)
    traj = synthetic.make_trajectory(E2E_FRAMES, step=0.05)
    frames = [synthetic.render_images(scene, cfg.camera, traj[i], seed=i)
              for i in range(E2E_FRAMES)]
    return frames, traj, time.perf_counter() - t0


def _frontend(cfg, lines: bool):
    """The card's NeuralFrontend (bf16) with the end-to-end weights: random
    SuperPoint (seed 0), the descriptor-matcher SuperGlue and, with lines,
    the hand-set RCF edge weights."""
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.models import rcf, superglue, superpoint

    sp = superpoint.init_params(0)
    sg = superglue.descriptor_matcher_params(cfg.superglue, 0, 2000.0, 1980.0)
    rp = rcf.edge_detector_params() if lines else None
    return NeuralFrontend(cfg, sp_params=sp, sg_params=sg, rcf_params=rp)


def _ate(recs, traj):
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error
    from rspl_slam_tpu_torch.slam import INIT_POSE

    est = np.stack([r.Twc for r in recs])
    ts = np.arange(len(recs)) * 0.05
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    return float(absolute_trajectory_error(ts, est[:, :3, 3], ts, gt[:, :3, 3])["rmse"])


def _keyframe_ate(m, traj):
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error
    from rspl_slam_tpu_torch.slam import INIT_POSE

    kf_t, kf_pose = m.keyframe_trajectory()
    if len(kf_t) <= 2:
        return None
    ts = np.arange(len(traj)) * 0.05
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    return float(absolute_trajectory_error(kf_t, kf_pose[:, :3, 3], ts, gt[:, :3, 3])["rmse"])


def phase_end_to_end(lines: bool, ba: bool = False, name: str | None = None):
    """The port's SLAMSystem + NeuralFrontend on rendered EuRoC-size frames:
    the true default (lines on, async local BA: ``SLAMSystem(cfg, fe)``),
    the same with BA off, or the point-only path with BA off."""
    import torch

    from rspl_slam_tpu_torch.config import SystemConfig
    from rspl_slam_tpu_torch.slam import SLAMSystem

    # 752×480, K = 400, 18 layers, 100 iterations; lines: RCF ×0.5, 128 lines
    cfg = SystemConfig(use_lines=lines)
    cam = cfg.camera
    frames, traj, render_s = _scene(cfg, lines)
    fe = _frontend(cfg, lines)  # the card, bf16

    def system():
        return SLAMSystem(cfg, fe) if ba else SLAMSystem(cfg, fe, enable_ba=False)

    warm = system()  # first-call set-up, not timed
    for i in range(2):
        warm.add_frame(i, 0.05 * i, *frames[i])
    warm.flush_ba()
    torch.cuda.synchronize()
    fe.timings.clear()

    slam = system()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    recs, lines_per_frame = [], []
    for i in range(E2E_FRAMES):
        recs.append(slam.add_frame(i, 0.05 * i, *frames[i]))
        if lines:
            lines_per_frame.append(int(slam._last_feats.line_valid.sum()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counters()
    slam.flush_ba()  # the last window (after the timed frames)

    est = np.stack([r.Twc for r in recs])
    ate = _ate(recs, traj)
    inliers = [int(r.num_inliers) for r in recs[1:]]
    tracked = sum(n > E2E_MIN_INLIERS for n in inliers)
    bound = E2E_ATE_BOUND
    timings = {**slam.timings, **fe.timings}
    med = {k: float(np.median(v)) * 1e3 for k, v in timings.items()}
    name = name or ("end_to_end_ba" if ba else "end_to_end_lines" if lines else "end_to_end")
    m = slam.map
    line = {"phase": name, "frames": E2E_FRAMES, "image": [cam.image_width,
            cam.image_height], "max_keypoints": cfg.superpoint.max_keypoints,
            "gnn_layers": cfg.superglue.num_gnn_layers,
            "sinkhorn_iters": cfg.superglue.sinkhorn_iterations,
            "use_lines": lines, "enable_ba": ba,
            "initialized": slam.initialized, "keyframes": int(m.n_kf),
            "inliers": inliers, "frames_over_min_inliers": tracked,
            "ate_rmse_m": float(ate), "ate_bound_m": bound,
            "frames_per_s": E2E_FRAMES / wall, "wall_s": wall,
            "stage_median_ms": med, "render_s": render_s,
            "max_memory_allocated_MB": torch.cuda.max_memory_allocated() / 2**20,
            "launches": launches}
    if lines:
        line.update({
            "stage_note": "rcf_hough: device ms of RCF + Hough (CUDA events); "
                          "lines_host: merge + assign + stereo match, host ms; "
                          "both inside extract"
                          + ("; local_ba: host ms to gather, upload and issue a window "
                             "(async); ba_device: CUDA-event ms of its solve on the side "
                             "stream; ba_apply: host ms of the flush" if ba else ""),
            "lines_per_frame": lines_per_frame,
            "lines_per_frame_median": float(np.median(lines_per_frame)),
            "maplines": int(m.n_ln),
            "maplines_with_endpoints": int(m.ln_has_endpoints[: m.n_ln].sum())})
    if ba:
        line.update({
            "ba_windows": len(slam.ba_windows),
            "ba_windows_with_lines": sum(w["ncl"] > 0 for w in slam.ba_windows),
            "ba_point_constraints": [w["ncp"] for w in slam.ba_windows],
            "ba_line_constraints": [w["ncl"] for w in slam.ba_windows],
            "keyframe_ate_rmse_m": _keyframe_ate(m, traj)})
    emit(line)
    if not slam.initialized:
        raise AssertionError(f"{name}: the map did not initialize")
    if tracked < 0.8 * len(inliers):
        raise AssertionError(f"{name}: too few tracked frames: {inliers}")
    if not np.isfinite(est).all():
        raise AssertionError(f"{name}: non-finite pose")
    if not ate < bound:
        raise AssertionError(f"{name}: ATE {ate} over the bound {bound}")
    for k in ("conv_stem", "superglue_layer", "sinkhorn"):
        if launches[k] <= 0:
            raise AssertionError(f"{name}: kernel {k} never launched")
    if lines:
        if not line["lines_per_frame_median"] > 0:
            raise AssertionError(f"{name}: no lines detected: {lines_per_frame}")
        if not line["maplines_with_endpoints"] > 0:
            raise AssertionError(f"{name}: no mapline was triangulated")
        if launches["conv_stem_side"] != E2E_FRAMES:
            raise AssertionError(f"{name}: K1 side mode launched "
                                 f"{launches['conv_stem_side']} times in {E2E_FRAMES} frames")
    elif launches["conv_stem_side"]:
        raise AssertionError(f"{name}: K1 side mode launched without lines")
    if ba:
        if line["ba_windows"] < 1:
            raise AssertionError(f"{name}: no BA window was solved")
        if line["ba_windows_with_lines"] < 1:
            raise AssertionError(f"{name}: no BA window had line constraints")
        if slam._pending_ba is not None:
            raise AssertionError(f"{name}: a BA window is still in flight after flush_ba")
        good = m.pt_status[: m.n_pt] == 2
        if not (np.isfinite(m.kf_pose[: m.n_kf]).all()
                and np.isfinite(m.pt_pos[: m.n_pt][good]).all()):
            raise AssertionError(f"{name}: non-finite keyframe pose or mappoint after BA")
    return line, launches, (cfg, fe, frames)


class _StereoFrames:
    """The frames as the runner's dataset: an indexable of StereoFrame."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        from rspl_slam_tpu_torch.datasets import StereoFrame

        return StereoFrame(i, 0.05 * i, *self.frames[i])


def phase_end_to_end_lazy(k3_ba: int):
    """The production loop: ``PipelinedRunner`` over the lazy-right
    ``SLAMSystem`` (lines, async BA, the combined frame step) on the BA
    path's 30 frames quantized to 8 bits as the JAX package's
    ``bench.py:measured_pipeline`` quantizes its renders; then the same
    frames through serial ``add_frame`` calls, and through the runner once
    more (frames/s only, bracketing the serial pass). ``k3_ba``: K3's launches on
    the BA path, which the lazy loop must undercut."""
    import torch

    from rspl_slam_tpu_torch.config import PipelineConfig, SystemConfig
    from rspl_slam_tpu_torch.pipeline import PipelinedRunner
    from rspl_slam_tpu_torch.slam import SLAMSystem

    cfg = SystemConfig(pipeline=PipelineConfig(lazy_right_extraction=True))
    cam = cfg.camera
    frames, traj, render_s = _scene(cfg, True)
    frames = [tuple((np.clip(im, 0, 1) * 255).astype(np.uint8) for im in f) for f in frames]
    fe = _frontend(cfg, True)
    warm = SLAMSystem(cfg, fe)  # first-call set-up, not timed
    PipelinedRunner(warm, _StereoFrames(frames[:2])).run()
    warm.flush_ba()
    torch.cuda.synchronize()

    slam = SLAMSystem(cfg, fe)
    torch.cuda.reset_peak_memory_stats()
    c0, d0 = fe.stereo_completions, fe.desc_downloads
    _reset_counters()
    t0 = time.perf_counter()
    recs = PipelinedRunner(slam, _StereoFrames(frames)).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counters()
    completions, downloads = fe.stereo_completions - c0, fe.desc_downloads - d0
    slam.flush_ba()  # the last window (after the timed frames)

    serial = SLAMSystem(cfg, fe)
    t0 = time.perf_counter()
    recs_s = [serial.add_frame(i, 0.05 * i, *f) for i, f in enumerate(frames)]
    torch.cuda.synchronize()
    serial_wall = time.perf_counter() - t0
    serial.flush_ba()
    again = SLAMSystem(cfg, fe)  # the runner once more, after the serial pass
    t0 = time.perf_counter()
    PipelinedRunner(again, _StereoFrames(frames)).run()
    torch.cuda.synchronize()
    again_wall = time.perf_counter() - t0
    again.flush_ba()

    m = slam.map
    est = np.stack([r.Twc for r in recs])
    ate = _ate(recs, traj)
    init = next((i + 1 for i, r in enumerate(recs) if r.is_keyframe), len(recs))
    inliers = [int(r.num_inliers) for r in recs[init:]]
    tracked = sum(n > E2E_MIN_INLIERS for n in inliers)
    lines_per_kf = m.kf_line_valid[: m.n_kf].sum(1).tolist()
    med = {k: float(np.median(v)) * 1e3 for k, v in slam.timings.items()}
    line = {"phase": "end_to_end_lazy", "frames": E2E_FRAMES,
            "image": [cam.image_width, cam.image_height], "upload": "uint8",
            "max_keypoints": cfg.superpoint.max_keypoints,
            "gnn_layers": cfg.superglue.num_gnn_layers,
            "sinkhorn_iters": cfg.superglue.sinkhorn_iterations,
            "initialized": slam.initialized, "init_attempts": init,
            "keyframes": int(m.n_kf), "inliers": inliers,
            "frames_over_min_inliers": tracked, "ate_rmse_m": ate,
            "ate_bound_m": E2E_ATE_BOUND_LAZY, "keyframe_ate_rmse_m": _keyframe_ate(m, traj),
            "frames_per_s": E2E_FRAMES / wall, "wall_s": wall,
            "serial_frames_per_s": E2E_FRAMES / serial_wall, "serial_wall_s": serial_wall,
            "runner_again_frames_per_s": E2E_FRAMES / again_wall,
            "serial_ate_rmse_m": _ate(recs_s, traj),
            "serial_keyframes_same": [r.is_keyframe for r in recs]
            == [r.is_keyframe for r in recs_s],
            "stage_median_ms": med, "render_s": render_s,
            "stage_note": "frame_combined: host ms of the combined step (extract + track, "
                          "one copy down); track_fused: frames the extract thread extracted "
                          "before the map initialized; complete_stereo: host ms of a "
                          "keyframe's right eye (inside kf_insert after initialization); "
                          "local_ba / ba_device / ba_apply as on the BA path",
            "stereo_completions": completions, "desc_downloads": downloads,
            "lines_per_keyframe": lines_per_kf, "maplines": int(m.n_ln),
            "maplines_with_endpoints": int(m.ln_has_endpoints[: m.n_ln].sum()),
            "ba_windows": len(slam.ba_windows),
            "ba_windows_with_lines": sum(w["ncl"] > 0 for w in slam.ba_windows),
            "max_memory_allocated_MB": torch.cuda.max_memory_allocated() / 2**20,
            "launches": launches}
    emit(line)
    if not slam.initialized:
        raise AssertionError("end_to_end_lazy: the map did not initialize")
    if tracked < 0.8 * len(inliers):
        raise AssertionError(f"end_to_end_lazy: too few tracked frames: {inliers}")
    if not np.isfinite(est).all():
        raise AssertionError("end_to_end_lazy: non-finite pose")
    if not ate < E2E_ATE_BOUND_LAZY:
        raise AssertionError(f"end_to_end_lazy: ATE {ate} over the bound {E2E_ATE_BOUND_LAZY}")
    if not (min(lines_per_kf) > 0 and line["maplines_with_endpoints"] > 0):
        raise AssertionError(f"end_to_end_lazy: lines per keyframe {lines_per_kf}, "
                             f"{line['maplines_with_endpoints']} maplines with endpoints")
    if line["ba_windows"] < 1:
        raise AssertionError("end_to_end_lazy: no BA window was solved")
    good = m.pt_status[: m.n_pt] == 2
    if slam._pending_ba is not None or not (np.isfinite(m.kf_pose[: m.n_kf]).all()
                                            and np.isfinite(m.pt_pos[: m.n_pt][good]).all()):
        raise AssertionError("end_to_end_lazy: non-finite map after flush_ba")
    if not completions == init + m.n_kf - 1 == downloads:
        raise AssertionError(f"end_to_end_lazy: {completions} stereo completions and "
                             f"{downloads} descriptor downloads for {init} initialization "
                             f"attempts and {m.n_kf} keyframes")
    for k in ("conv_stem", "conv_stem_side"):
        if launches[k] != E2E_FRAMES + completions:
            raise AssertionError(f"end_to_end_lazy: {k} launched {launches[k]} times for "
                                 f"{E2E_FRAMES} frames and {completions} completions")
    if not 0 < launches["sinkhorn"] < k3_ba or launches["superglue_layer"] <= 0:
        raise AssertionError(f"end_to_end_lazy: K3 {launches['sinkhorn']} launches "
                             f"(BA path {k3_ba}), K2 {launches['superglue_layer']}")
    return line, launches


def phase_ba_repeat(a: dict, b: dict):
    """The BA path run twice on the same frames: the trajectory's ATE, the
    keyframes' after the last flush and the inlier counts repeat bit for
    bit (local BA's fixed-order sums)."""
    keys = ("ate_rmse_m", "keyframe_ate_rmse_m", "inliers", "keyframes",
            "ba_point_constraints")
    same = {k: a[k] == b[k] for k in keys}
    emit({"phase": "ba_repeat", "ate_rmse_m": [a["ate_rmse_m"], b["ate_rmse_m"]],
          "keyframe_ate_rmse_m": [a["keyframe_ate_rmse_m"], b["keyframe_ate_rmse_m"]],
          "same": same})
    if not all(same.values()):
        raise AssertionError(f"end_to_end_ba does not repeat: {same}")


# ---------------------------------------------------------------- the CLI
WORK = os.path.join(ROOT, "_smoke_work")  # git-ignored; removed at the end
CLI_ATE_BOUND = E2E_ATE_BOUND
# cli_synth's bound: the JAX CLI's own `synth --frames 100` ATE (all frames)
# on the CPU, 0.00554 m (tests/torch_slice_reference.py --synth; the port's
# CLI on the CPU gives the same), times 2
SYNTH_FRAMES = 100
SYNTH_JAX_ATE = 0.00554
SYNTH_ATE_BOUND = 2 * SYNTH_JAX_ATE


# imported by the JAX package's IO, absent from a bare card machine: the
# CLI subprocess runs with each of them made to fail on import
HIDDEN_MODULES = ("yaml", "PIL", "matplotlib")


def _hidden_modules_dir() -> str:
    """A directory of stub packages whose import raises ImportError, put
    first on the CLI subprocess's path: the port then runs as on a machine
    without PyYAML, PIL or matplotlib, whatever this one has."""
    d = os.path.join(WORK, "hidden_modules")
    for name in HIDDEN_MODULES:
        os.makedirs(os.path.join(d, name), exist_ok=True)
        with open(os.path.join(d, name, "__init__.py"), "w") as f:
            f.write(f"raise ImportError('{name} is hidden from the CLI by chip_smoke.py')\n")
    return d


def _cli(*argv, timeout: int = 600) -> str:
    """``python -m rspl_slam_tpu_torch.cli`` in a subprocess from the
    checkout's root, as a user runs it, with PyYAML, PIL and matplotlib
    hidden; raises on a non-zero exit."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([_hidden_modules_dir(), ROOT])}
    res = subprocess.run([sys.executable, "-m", "rspl_slam_tpu_torch.cli", *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(f"cli {argv[0]} exited {res.returncode}:\n"
                             f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return res.stdout


def _camera_yaml(path, cam):
    """The camera as an OpenCV-layout calibration file: the rectified
    intrinsics as K and P (the right P with -bf), identity R, zero D, each
    matrix wrapped over several lines, so the rectification maps are built
    (and the remap runs on the card) and the wrapped matrices go through
    the PyYAML-free parser."""
    def mat(name, rows, cols, vals):
        body = ",\n         ".join(", ".join(repr(float(v)) for v in vals[r * cols:(r + 1) * cols])
                                   for r in range(rows))
        return (f"{name}: !!opencv-matrix\n  rows: {rows}\n  cols: {cols}\n  dt: d\n"
                f"  data: [{body}]\n")

    K = [cam.fx, 0, cam.cx, 0, cam.fy, cam.cy, 0, 0, 1]
    text = (f"%YAML:1.0\nimage_width: {cam.image_width}\nimage_height: {cam.image_height}\n"
            f"bf: {cam.bf!r}\ndepth_lower_thr: {cam.depth_lower_thr!r}\n"
            f"depth_upper_thr: {cam.depth_upper_thr!r}\nmax_y_diff: {cam.max_y_diff!r}\n"
            f"distortion_type: {cam.distortion_type}\n")
    for side, tx in (("LEFT", 0.0), ("RIGHT", -cam.bf)):
        text += (mat(f"{side}.D", 1, 5, [0.0] * 5) + mat(f"{side}.K", 3, 3, K)
                 + mat(f"{side}.R", 3, 3, [1, 0, 0, 0, 1, 0, 0, 0, 1])
                 + mat(f"{side}.P", 3, 4, [cam.fx, 0, cam.cx, tx, 0, cam.fy, cam.cy, 0,
                                           0, 0, 1, 0]))
    with open(path, "w") as f:
        f.write(text)


def _write_tree(root, frames_u8, gt):
    """A raw-EuRoC tree: mav0/cam{0,1}/data/<ns>.png (the port's PNG
    writer, filters chosen per row), cam0/data.csv and the ground-truth
    csv."""
    from rspl_slam_tpu_torch import png

    seq = os.path.join(root, "mav0")
    names = [1_403_636_579_763_555_584 + i * 50_000_000 for i in range(len(frames_u8))]
    for ns, pair in zip(names, frames_u8):
        for cam, im in zip(("cam0", "cam1"), pair):
            png.write_png(os.path.join(seq, cam, "data", f"{ns}.png"), im)
    with open(os.path.join(seq, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        f.writelines(f"{ns},{ns}.png\n" for ns in names)
    os.makedirs(os.path.join(seq, "state_groundtruth_estimate0"))
    with open(os.path.join(seq, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m]\n")
        f.writelines(f"{ns},{float(T[0, 3])!r},{float(T[1, 3])!r},{float(T[2, 3])!r}\n"
                     for ns, T in zip(names, gt))


def phase_png_unfilter():
    """The compiled host unfilter (csrc/png_unfilter.cu) against the numpy
    one, bit for bit, on 752×480 gray and RGB images written with each of
    the five filters and with the per-row choice."""
    from rspl_slam_tpu_torch import png

    rng = np.random.default_rng(0)
    os.makedirs(WORK, exist_ok=True)
    cases, ms = 0, {}
    for ch in (1, 3):
        img = rng.integers(0, 256, (480, 752, ch), dtype=np.uint8)
        img[100:200] = np.linspace(0, 255, 752, dtype=np.uint8)[None, :, None]
        for ft in png.FILTERS + (None,):
            path = os.path.join(WORK, f"unfilter_{ch}_{ft}.png")
            png.write_png(path, img, ft)
            with open(path, "rb") as f:
                data = f.read()
            t0 = time.perf_counter()
            a = png.read_png(data, compiled=True)
            t1 = time.perf_counter()
            b = png.read_png(data, compiled=False)
            t2 = time.perf_counter()
            if not (np.array_equal(a, b) and np.array_equal(a.reshape(img.shape), img)):
                raise AssertionError(f"png_unfilter: compiled and numpy disagree ({ch}, {ft})")
            ms[f"{ch}ch_{ft}"] = [(t1 - t0) * 1e3, (t2 - t1) * 1e3]
            cases += 1
    emit({"phase": "png_unfilter", "cases": cases, "bit_exact": True,
          "decode_ms_compiled_numpy": ms})


def _decode_ms_per_pair(root, compiled: bool, n: int) -> float:
    from rspl_slam_tpu_torch.datasets import open_dataset

    ds = open_dataset(root, compiled=compiled)
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    return (time.perf_counter() - t0) / n * 1e3


def phase_cli_run():
    """The user's command on the card: ``python -m rspl_slam_tpu_torch.cli
    run --config configs/euroc.yaml`` (the default main path: lines, async
    BA; the algorithm section equals ``SystemConfig()``) on the BA path's
    30 frames quantized to 8 bits and written as a raw-EuRoC tree, with the
    smoke's weights as ``.npz`` and an OpenCV camera file, in a subprocess.
    Gated on its exit, the frame count, the decoded frames, the ATE, the
    trajectory against an in-process ``PipelinedRunner`` run, the saved
    map (reload and resume), the visualization PNGs and the kernels."""
    import torch

    from rspl_slam_tpu_torch import config, png
    from rspl_slam_tpu_torch.backend.map_store import MapStore
    from rspl_slam_tpu_torch.config import SystemConfig, load_system_config
    from rspl_slam_tpu_torch.datasets import open_dataset
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.models import rcf, superglue, superpoint
    from rspl_slam_tpu_torch.models.weights import save_npz_pytree
    from rspl_slam_tpu_torch.pipeline import PipelinedRunner
    from rspl_slam_tpu_torch.slam import INIT_POSE, SLAMSystem

    euroc = os.path.join(ROOT, "configs", "euroc.yaml")
    if load_system_config(euroc, None) != SystemConfig():
        raise AssertionError("cli_run: configs/euroc.yaml's algorithm section is not SystemConfig()")
    cfg0 = SystemConfig()
    frames, traj, render_s = _scene(cfg0, True)
    frames_u8 = [tuple((np.clip(im, 0, 1) * 255).astype(np.uint8) for im in f) for f in frames]
    work = os.path.join(WORK, "cli_run")
    shutil.rmtree(work, ignore_errors=True)
    tree = os.path.join(work, "MH_smoke")
    t0 = time.perf_counter()
    _write_tree(tree, frames_u8, np.einsum("ij,njk->nik", INIT_POSE, traj))
    write_s = time.perf_counter() - t0
    cam_yaml = os.path.join(work, "camera.yaml")
    _camera_yaml(cam_yaml, cfg0.camera)
    w = {"sp": superpoint.init_params(0),
         "sg": superglue.descriptor_matcher_params(cfg0.superglue, 0, 2000.0, 1980.0),
         "rcf": rcf.edge_detector_params()}
    for k, params in w.items():
        save_npz_pytree(os.path.join(work, f"{k}.npz"), params)
    p = {k: os.path.join(work, k) for k in ("traj.txt", "map.npz", "map_text", "viz",
                                              "inproc.txt")}
    t0 = time.perf_counter()
    out = _cli("run", "--dataroot", tree, "--config", euroc, "--camera-config", cam_yaml,
               "--sp-weights", os.path.join(work, "sp.npz"),
               "--sg-weights", os.path.join(work, "sg.npz"),
               "--rcf-weights", os.path.join(work, "rcf.npz"), "--gt", tree,
               "--traj-path", p["traj.txt"], "--save-map", p["map.npz"],
               "--save-map-text", p["map_text"], "--viz-dir", p["viz"])
    cli_wall = time.perf_counter() - t0
    processed = re.search(r"^processed (\d+) frames in ([0-9.]+)s \(([0-9.]+) fps\)$", out, re.M)
    ate = json.loads(re.search(r"^ATE: (.*)$", out, re.M).group(1))
    launches = json.loads(re.search(r"^kernel launches: (.*)$", out, re.M).group(1))

    # the same config, weights and decoded frames through PipelinedRunner here
    cfg = load_system_config(euroc, cam_yaml)
    cfg = dataclasses.replace(
        cfg, superpoint=dataclasses.replace(cfg.superpoint, weights_path=os.path.join(work, "sp.npz")),
        superglue=dataclasses.replace(cfg.superglue, weights_path=os.path.join(work, "sg.npz")),
        line_detector=dataclasses.replace(cfg.line_detector,
                                          rcf_weights_path=os.path.join(work, "rcf.npz")))
    fe = NeuralFrontend(cfg)
    ds = open_dataset(tree, compiled=True)
    decoded_equal = all(
        np.array_equal(ds[i].image_left, frames_u8[i][0].astype(np.float32) / 255.0)
        and np.array_equal(ds[i].image_right, frames_u8[i][1].astype(np.float32) / 255.0)
        for i in range(len(frames_u8)))
    slam = SLAMSystem(cfg, fe)
    _reset_counters()
    t0 = time.perf_counter()
    PipelinedRunner(slam, ds, queue_depth=cfg.pipeline.queue_depth).run()
    torch.cuda.synchronize()
    inproc_wall = time.perf_counter() - t0
    inproc_launches = _counters()
    slam.save_trajectory(p["inproc.txt"])
    with open(p["traj.txt"]) as f, open(p["inproc.txt"]) as g:
        cli_traj, inproc_traj = f.read(), g.read()

    # the repaired YAML subset parser against PyYAML where this host has it
    # (the CLI above parsed both files without it)
    try:
        import yaml
    except ImportError:
        yaml = None
    mini_equal = None
    if yaml is not None:
        mini_equal = all(
            config._mini_yaml(f) == yaml.safe_load(config._strip_opencv(open(f).read()))
            for f in (euroc, cam_yaml))
    host_has = {}
    for name in HIDDEN_MODULES:
        try:
            __import__(name)
            host_has[name] = True
        except ImportError:
            host_has[name] = False

    stored = MapStore.load(p["map.npz"])
    resumed = SLAMSystem(cfg, fe)
    resumed.resume_from_map(p["map.npz"])
    recs = [resumed.add_frame(i, 10.0 + 0.05 * i, *frames_u8[E2E_FRAMES - 5 + i])
            for i in range(5)]
    resumed.flush_ba()
    resume_inliers = [int(r.num_inliers) for r in recs]
    viz_png = sorted(f for f in os.listdir(p["viz"]) if f.endswith(".png"))
    for f in viz_png:
        with open(os.path.join(p["viz"], f), "rb") as fh:
            png.read_png(fh.read(), compiled=True)
    line = {"phase": "cli_run", "frames": int(processed.group(1)) if processed else None,
            "image": [cfg.camera.image_width, cfg.camera.image_height],
            "max_keypoints": cfg.superpoint.max_keypoints,
            "gnn_layers": cfg.superglue.num_gnn_layers,
            "sinkhorn_iters": cfg.superglue.sinkhorn_iterations, "use_lines": cfg.use_lines,
            "async_ba": cfg.pipeline.async_ba, "rectify_maps": fe._rect_maps is not None,
            "cli_fps_printed": float(processed.group(3)) if processed else None,
            "cli_wall_s": cli_wall, "inproc_frames_per_s": E2E_FRAMES / inproc_wall,
            "keyframe_ate_rmse_m": ate["rmse"], "ate_n": ate["n"], "ate_bound_m": CLI_ATE_BOUND,
            "decoded_equal": decoded_equal,
            "trajectory_equal_inproc": cli_traj == inproc_traj,
            "keyframes": len(cli_traj.splitlines()),
            "map_keyframes": int(stored.n_kf), "map_points": int(stored.n_pt),
            "map_lines": int(stored.n_ln), "resume_inliers": resume_inliers,
            "viz_pngs": len(viz_png), "hidden_from_cli": list(HIDDEN_MODULES),
            "host_has": host_has, "mini_yaml_equals_pyyaml": mini_equal,
            "launches": launches,
            "inproc_launches": inproc_launches,
            "decode_ms_per_pair_compiled": _decode_ms_per_pair(tree, True, E2E_FRAMES),
            "decode_ms_per_pair_numpy": _decode_ms_per_pair(tree, False, 5),
            "render_s": render_s, "tree_write_s": write_s}
    emit(line)
    if not processed or int(processed.group(1)) != E2E_FRAMES:
        raise AssertionError(f"cli_run: expected {E2E_FRAMES} frames processed:\n{out}")
    if not decoded_equal:
        raise AssertionError("cli_run: the decoded PNG frames differ from the written arrays")
    if not ate["rmse"] < CLI_ATE_BOUND or ate["n"] < 3:
        raise AssertionError(f"cli_run: ATE {ate} over the bound {CLI_ATE_BOUND}")
    if cli_traj != inproc_traj:
        raise AssertionError("cli_run: the CLI's trajectory differs from the in-process "
                             f"runner's:\n{cli_traj}\n---\n{inproc_traj}")
    if stored.n_kf != len(cli_traj.splitlines()) or stored.n_pt <= 0:
        raise AssertionError(f"cli_run: the saved map holds {stored.n_kf} keyframes")
    if min(resume_inliers) <= E2E_MIN_INLIERS or not np.isfinite(
            np.stack([r.Twc for r in recs])).all():
        raise AssertionError(f"cli_run: resume_from_map then tracked {resume_inliers}")
    if mini_equal is False:
        raise AssertionError("cli_run: the YAML subset parser disagrees with PyYAML")
    if "trajectory.png" not in viz_png or not any(f.startswith("frame_") for f in viz_png):
        raise AssertionError(f"cli_run: visualization PNGs missing: {viz_png}")
    for k in ("conv_stem", "conv_stem_side", "superglue_layer", "sinkhorn"):
        if launches[k] <= 0:
            raise AssertionError(f"cli_run: kernel {k} never launched")
    if launches != inproc_launches:
        raise AssertionError(f"cli_run: launches {launches} against {inproc_launches} in process")
    return line, launches


def phase_cli_synth():
    """``synth --frames 100`` on the card: the oracle frontend on the
    unfused tracking path (host matching, PnP and pose-only LM on the
    card, lines, local BA)."""
    out = _cli("synth", "--frames", str(SYNTH_FRAMES))
    ate = json.loads(re.search(r"^ATE: (.*)$", out, re.M).group(1))
    m = re.search(r"^keyframes=(\d+) mappoints=(\d+) maplines=(\d+)$", out, re.M)
    fps = re.search(r"^\d+ frames in ([0-9.]+)s \(([0-9.]+) fps\)$", out, re.M)
    line = {"phase": "cli_synth", "frames": SYNTH_FRAMES, "ate_rmse_m": ate["rmse"],
            "ate_n": ate["n"], "ate_bound_m": SYNTH_ATE_BOUND,
            "jax_cpu_ate_rmse_m": SYNTH_JAX_ATE, "keyframes": int(m.group(1)),
            "mappoints": int(m.group(2)), "maplines": int(m.group(3)),
            "fps_printed": float(fps.group(2))}
    emit(line)
    if ate["n"] != SYNTH_FRAMES or not ate["rmse"] < SYNTH_ATE_BOUND:
        raise AssertionError(f"cli_synth: ATE {ate} over the bound {SYNTH_ATE_BOUND}")
    if line["keyframes"] < 2 or line["maplines"] <= 0:
        raise AssertionError(f"cli_synth: {m.group(0)}")


def _public_state_dicts():
    """Random state dicts in the public checkpoint layouts (key names,
    OIHW and Conv1d shapes, BatchNorm statistics) of the three models at
    their full sizes."""
    import torch

    from rspl_slam_tpu_torch.config import SuperGlueConfig
    from rspl_slam_tpu_torch.models import rcf, superpoint

    g = torch.Generator().manual_seed(0)

    def t(*shape, scale=0.1):
        return torch.randn(*shape, generator=g) * scale

    sp = {}
    for name, cin, cout, k in superpoint.LAYERS:
        sp[f"{name}.weight"], sp[f"{name}.bias"] = t(cout, cin, k, k), t(cout)
    cfg = SuperGlueConfig()
    d = cfg.descriptor_dim
    sg = {"bin_score": torch.tensor(1.0)}

    def conv1d(prefix, cin, cout):
        sg[f"{prefix}.weight"], sg[f"{prefix}.bias"] = t(cout, cin, 1), t(cout)

    def bn(prefix, ch):
        sg[f"{prefix}.weight"], sg[f"{prefix}.bias"] = 1.0 + t(ch), t(ch)
        sg[f"{prefix}.running_mean"] = t(ch)
        sg[f"{prefix}.running_var"] = 0.5 + torch.rand(ch, generator=g)
        sg[f"{prefix}.num_batches_tracked"] = torch.tensor(1000)

    chans = [3, *cfg.keypoint_encoder, d]
    for i, (cin, cout) in enumerate(zip(chans[:-1], chans[1:])):
        conv1d(f"kenc.encoder.{3 * i}", cin, cout)
        if i < len(chans) - 2:
            bn(f"kenc.encoder.{3 * i + 1}", cout)
    for li in range(cfg.num_gnn_layers):
        base = f"gnn.layers.{li}"
        for j in range(3):
            conv1d(f"{base}.attn.proj.{j}", d, d)
        conv1d(f"{base}.attn.merge", d, d)
        conv1d(f"{base}.mlp.0", 2 * d, 2 * d)
        bn(f"{base}.mlp.1", 2 * d)
        conv1d(f"{base}.mlp.3", 2 * d, d)
    conv1d("final_proj", d, d)
    rc = {}
    for si, (_, convs) in enumerate(rcf.STAGES, start=1):
        for i, (cin, cout) in enumerate(convs):
            rc[f"module.conv{si}_{i + 1}.weight"] = t(cout, cin, 3, 3)
            rc[f"module.conv{si}_{i + 1}.bias"] = t(cout)
            rc[f"module.conv{si}_{i + 1}_down.weight"] = t(rcf.SIDE_CH, cout, 1, 1)
            rc[f"module.conv{si}_{i + 1}_down.bias"] = t(rcf.SIDE_CH)
        rc[f"module.score_dsn{si}.weight"] = t(1, rcf.SIDE_CH, 1, 1)
        rc[f"module.score_dsn{si}.bias"] = t(1)
    rc["module.score_final.weight"], rc["module.score_final.bias"] = t(1, 5, 1, 1), t(1)
    return {"superpoint": sp, "superglue": sg, "rcf": {"epoch": 30, "state_dict": rc}}


def phase_cli_convert():
    """``convert-weights`` of each model's public-layout state dict (written
    with ``torch.save``) equals the direct ``.pth`` loader, array for
    array."""
    import torch

    from rspl_slam_tpu_torch import cli
    from rspl_slam_tpu_torch.models import rcf, superglue, superpoint
    from rspl_slam_tpu_torch.models.weights import flatten_pytree

    loaders = {"superpoint": superpoint.load_torch_weights,
               "superglue": superglue.load_torch_weights, "rcf": rcf.load_torch_weights}
    os.makedirs(WORK, exist_ok=True)
    arrays = {}
    for model, sd in _public_state_dicts().items():
        pth, npz = os.path.join(WORK, f"{model}.pth"), os.path.join(WORK, f"{model}.npz")
        torch.save(sd, pth)
        cli.main(["convert-weights", "--model", model, "--input", pth, "--output", npz])
        direct = flatten_pytree(loaders[model](pth))
        with np.load(npz) as z:
            if sorted(z.files) != sorted(direct) or not all(
                    np.array_equal(z[k], direct[k]) for k in z.files):
                raise AssertionError(f"cli_convert: {model} differs from the direct loader")
        arrays[model] = len(direct)
    emit({"phase": "cli_convert", "arrays": arrays, "equal": True})


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
    if fe.use_lines:
        _lines_breakdown(fe, frames[n_warm])
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
              for e in dev[:15]],
          "kernel_device_ms_per_frame": {
              name: sum(e.self_device_time_total for e in ka
                        if any(f in e.key for f in fns)) / 1e3 / n_prof
              for name, fns in PROFILE_NAMES.items()}})


def _lines_breakdown(fe, pair):
    """The lines path's pieces on one frame, each the frontend's own step:
    CUDA-event ms (and host issue ms) of the RCF edge maps of the pair and
    of the Hough detector on them, host ms of the merge."""
    import torch

    img = torch.from_numpy(np.stack(pair)).to(fe.device)
    edges = fe._edge_maps(img)
    segs, valid = fe._detect_lines(edges)
    sv = torch.cat([segs, valid[..., None].float()], -1).cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(10):
        merged = fe._merge_stack(sv)
    host_merge = (time.perf_counter() - t0) / 10 * 1e3
    emit({"phase": "lines_breakdown", "image": list(img.shape),
          "rcf_ms": time_ms(lambda: fe._edge_maps(img)),
          "rcf_host_ms": host_ms(lambda: fe._edge_maps(img)),
          "detect_ms": time_ms(lambda: fe._detect_lines(edges)),
          "detect_host_ms": host_ms(lambda: fe._detect_lines(edges)),
          "host_merge_ms": host_merge, "segments": int(valid.sum()),
          "merged": [len(m) for m in merged]})


# each port kernel's CUDA function name, as the profiler lists it
PROFILE_NAMES = {"conv_stem": ("conv3x3_relu_pool_kernel<false>",),
                 "conv_stem_side": ("conv3x3_relu_pool_kernel<true>",),
                 "superglue_layer": ("qkv_bf16_kernel", "layer_bf16_kernel"),
                 "superglue_layer_f32": ("qkv_kernel", "attn_kernel", "mlp_kernel"),
                 "sinkhorn": ("sinkhorn_cluster_kernel",)}

SOURCES = {
    "conv_stem": ("rspl_slam_tpu_torch/csrc/conv_stem.cu",
                  "rspl_slam_tpu/ops/conv_stem_pallas.py:126"),
    "superglue_layer": ("rspl_slam_tpu_torch/csrc/superglue_layer.cu",
                        "rspl_slam_tpu/ops/attention_pallas.py:93"),
    "sinkhorn": ("rspl_slam_tpu_torch/csrc/sinkhorn.cu",
                 "rspl_slam_tpu/ops/sinkhorn_pallas.py:61"),
}
# K1's side-output mode (RCF) and K2's f32 mode, listed under the main line
OTHER_MODES = {"conv_stem": ("side_mode", "conv_stem_side"),
               "superglue_layer": ("f32_mode", "superglue_layer_f32")}
KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "tflops", "bound_fraction")


def phase_summary(lines, by_path, ate_by_path):
    """``by_path`` maps each end-to-end path to its launch counts, the
    default main path (``end_to_end_ba``) first; empty with --kernels
    (no path ran: launch counts null). ``ate_by_path``: each path's ATE."""
    launches = by_path.get("end_to_end_ba")
    kernels = []
    for name, (src, tpu) in SOURCES.items():
        k = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
             "launches": launches and launches[name],
             "launches_by_path": {p: c[name] for p, c in by_path.items()},
             **{key: lines[name][key] for key in KEYS}}
        if name in OTHER_MODES:  # the same kernel in its other mode
            mode, line_name = OTHER_MODES[name]
            other = lines[line_name]
            k[mode] = {"launches": launches and launches[line_name],
                       "launches_by_path": {p: c[line_name] for p, c in by_path.items()},
                       "shape": other["shape"], **{key: other[key] for key in KEYS}}
            if other.get("checks"):
                k[mode]["checks"] = other["checks"]
        if name == "sinkhorn":
            k["elements_per_s"] = lines[name]["elements_per_s"]
        if lines[name].get("checks"):
            k["checks"] = lines[name]["checks"]
        kernels.append(k)
    emit({"kernels": kernels, "ate_by_path": ate_by_path})


def main(argv) -> int:
    if not os.path.isdir(os.path.join(ROOT, "rspl_slam_tpu_torch")):
        print("chip_smoke: the rspl_slam_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    phase_device()
    phase_build()
    lines = {}
    lines["conv_stem"] = check_conv_stem(side=False)
    lines["conv_stem_side"] = check_conv_stem(side=True)
    lines["superglue_layer"] = check_superglue_layer(bf16=True)
    lines["superglue_layer_f32"] = check_superglue_layer(bf16=False)
    lines["sinkhorn"] = check_sinkhorn()
    phase_png_unfilter()
    by_path, ate_by_path = {}, {}
    if "--kernels" not in argv:
        phase_local_ba_check("--profile" in argv)
        repeat = None
        for name, kw in (("end_to_end_ba", dict(lines=True, ba=True)),
                         ("end_to_end_ba_repeat", dict(lines=True, ba=True)),
                         ("end_to_end_lines", dict(lines=True)),
                         ("end_to_end", dict(lines=False))):
            line, counts, run = phase_end_to_end(name=name, **kw)
            if name == "end_to_end_ba_repeat":
                phase_ba_repeat(repeat, line)
            else:
                by_path[name] = counts
                ate_by_path[name] = line["ate_rmse_m"]
                repeat = line
            if name == "end_to_end_lines" and "--profile" in argv:
                phase_profile(*run)
            del run  # each path's frontend: the next path's peak memory is its own
            gc.collect()
            torch.cuda.empty_cache()
        line, by_path["end_to_end_lazy"] = phase_end_to_end_lazy(
            by_path["end_to_end_ba"]["sinkhorn"])
        ate_by_path["end_to_end_lazy"] = line["ate_rmse_m"]
        gc.collect()
        torch.cuda.empty_cache()
        line, by_path["cli_run"] = phase_cli_run()
        ate_by_path["cli_run"] = line["keyframe_ate_rmse_m"]
        phase_cli_synth()
        phase_cli_convert()
    shutil.rmtree(WORK, ignore_errors=True)
    phase_summary(lines, by_path, ate_by_path)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
