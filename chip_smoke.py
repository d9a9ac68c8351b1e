"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile  # every phase + a torch.profiler breakdown
                                     # of the lines path and launches per BA window
    python3 chip_smoke.py --kernels  # device, build, kernel phases, summary
    python3 chip_smoke.py --training # device, build, kernels, end_to_end_ba,
                                     # the training phases (6 below), summary

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
     then the global layer: ``end_to_end_loop``, ``PipelinedRunner`` over
     ``SLAMSystem(SystemConfig(pipeline=PipelineConfig(track_local_map=
     True)), fe, enable_loop_closure=True)`` (lines, async BA) on a lap
     of a circle through a corridor of structure (``loop_sequence``, 130
     8-bit frames), then ``run_pose_graph()`` and ``run_global_ba()``,
     gated on > 20 inliers on ≥ 80% of the frames, ≥ 1 accepted loop,
     ≥ 1 loop's Z within the JAX bound of the true relative pose (every
     loop's error reported), each pose-graph and global-BA LM ending no
     higher than it started, a finite map, the keyframe ATE under the
     JAX bound (itself under a frozen trajectory's score) and not raised
     by the closing passes, and K1 (both modes), K2 and K3 launched; the
     two closing passes repeat bit for bit on a deep copy of the map (and
     give launches per solve under torch.profiler);
     ``reloc``, the JAX package's kidnapped-robot run (oracle features,
     the EuRoC camera, BA on) gated on JAX's relocalization count and the
     error after it, beside the same kidnap with the neural frontend at
     full width on the circle (measured: random weights block the
     trigger in both packages), then relocalization's re-anchoring route
     forced on one of its wake-up frames (``reanchor``: the query, the
     re-match through K2 and K3, PnP + LM), gated on the error under the
     JAX bound;
     ``epipolar``, ``match_outlier_rejection`` on the BA path's frames
     (the unfused tracking route), gated as that path, then the filter
     alone on planted outliers (``planted_matches``): every outlier
     rejected, the inliers kept at the JAX package's rate;
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
     counts (equal to the in-process run's); ``cli_global``, ``run
     --loop-closure --pose-graph --global-ba --track-local-map`` on the
     same tree: the JAX CLI's epilogue lines and the trajectory equal to
     an in-process run with the same options; ``cli_synth``, ``synth
     --frames 100`` (the unfused tracking path) under an ATE bound from
     the JAX CLI's own run; ``cli_convert``, ``convert-weights`` of
     public-layout state dicts against the direct loaders. The PNG
     reader's compiled row unfilter (host code, no kernel) is held against
     the numpy one bit for bit in ``png_unfilter`` after the kernel
     checks, in every mode;
  6. training (``training/``: plain-PyTorch forwards with autograd, the
     kernels inference-only), each phase with its card name, power limit,
     ms per step (host data apart from the device step) and peak memory:
     ``train_superpoint``, the JAX package's slow-test recipe (160×120,
     120 Adam steps, batch 2, lr 1e-3), gated on the loss falling, recall
     @2 px rising by more than 0.08 and the median localization error
     falling (bf16 extraction through K1), then K1 on the trained conv1b
     against its plain version; ``train_rcf``, full width at 240×376, 40
     steps, gated on the loss falling, the trained weights through K1's
     side mode (against its plain version; beside the generic recipe);
     ``train_superglue`` (a) JAX's tier-1 overfit (2 layers, 10
     iterations, K = 16, 60 steps) gated on the loss under 0.3× its start,
     ``matching_accuracy`` through K2's f32 mode and K3 over 0.9 and
     equal to the plain version's, and the kernels' log plan within 1e-3
     of the plain forward's, (b) ``SuperGlueConfig()`` (18 layers, 100
     iterations) at K = 400, batch 8, 10 steps, gated on a finite falling
     loss, the bf16 decode (K2 bf16 + K3) equal to the plain forward's on
     ≥ 99% of rows, and on values: the kernels' log plan, and each of the
     18 layers through K2 at (16, 400, 256) on the plain forward's own
     input, within 2× the plain version's own spread (the same plain
     function on the CPU), the Sinkhorn through K3 at (8, 401, 401) within
     its kernel line's 1e-3; ``superglue_bank``, ``make_shift_pair_bank``
     on the card (8 shifted pairs of 240×376 crops of the BA path's
     frames, bf16 extraction through K1 at (8, 240, 376)) gated on its
     labels equal to a CPU bank's by keypoint position on ≥ 95% of rows;
     ``cli_pretrain``, ``pretrain --model superpoint|rcf|superglue --steps
     20`` in three parallel subprocesses without PyYAML/PIL/matplotlib,
     each ``.npz`` loaded and run once on the card; ``end_to_end_trained``,
     the BA path with the trained SuperPoint, gated on finite poses; ATE,
     inliers, the keypoints' 8-px grid share and the descriptors' cosines
     measured beside the random weights'. Peak memory is each phase's
     own: the most allocated above what was alive at its start;
  7. the {"kernels": [...]} summary (launches from the BA path, the
     default main path; each path's counts in ``launches_by_path``, the
     CLI's as ``cli_run``, the training phases' under their names; each
     path's ATE in ``ate_by_path``); last line {"ok": true, "device":
     ...}. With --kernels, phases 3-6 are skipped and the summary's launch
     counts are null; --training runs ``end_to_end_ba`` and phase 6 alone.

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


CARD = None  # the nvidia-smi name and power limit, which the training phases repeat


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
    global CARD
    CARD = smi
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


def _scene(cfg, lines: bool, n: int = E2E_FRAMES):
    """The end-to-end scene's first ``n`` (30) rendered stereo pairs (with
    12 dark segments on the lines paths), the ground-truth trajectory, and
    the render time."""
    from rspl_slam_tpu_torch.evaluation import synthetic

    t0 = time.perf_counter()
    scene = synthetic.make_scene(num_points=600, num_lines=12 if lines else 0, seed=1,
                                 extent=(6.0, 4.0, 6.0), on_line_frac=0.0)
    traj = synthetic.make_trajectory(E2E_FRAMES, step=0.05)
    frames = [synthetic.render_images(scene, cfg.camera, traj[i], seed=i) for i in range(n)]
    return frames, traj, time.perf_counter() - t0


def _frontend(cfg, lines: bool, sp_params=None):
    """The card's NeuralFrontend (bf16) with the end-to-end weights: random
    SuperPoint (seed 0) unless ``sp_params`` is given, the
    descriptor-matcher SuperGlue (set for random SuperPoint's nearly
    parallel descriptors: similarity 2000·cos against a dustbin of 1980)
    and, with lines, the hand-set RCF edge weights."""
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.models import rcf, superglue, superpoint

    sp = superpoint.init_params(0) if sp_params is None else sp_params
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


def phase_end_to_end(lines: bool, ba: bool = False, name: str | None = None,
                     sp_params=None):
    """The port's SLAMSystem + NeuralFrontend on rendered EuRoC-size frames:
    the true default (lines on, async local BA: ``SLAMSystem(cfg, fe)``),
    the same with BA off, or the point-only path with BA off. With
    ``sp_params`` (trained SuperPoint weights) only finite poses are gated;
    the rest is measured."""
    import torch

    from rspl_slam_tpu_torch.config import SystemConfig
    from rspl_slam_tpu_torch.slam import SLAMSystem

    # 752×480, K = 400, 18 layers, 100 iterations; lines: RCF ×0.5, 128 lines
    cfg = SystemConfig(use_lines=lines)
    cam = cfg.camera
    frames, traj, render_s = _scene(cfg, lines)
    fe = _frontend(cfg, lines, sp_params)  # the card, bf16

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
    if sp_params is not None:
        if not np.isfinite(est).all():
            raise AssertionError(f"{name}: non-finite pose")
        return line, launches, (cfg, fe, frames)
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


# ------------------------------------------------------------ the global layer
# end_to_end_loop's sequence: one lap of a 3 m circle through a corridor
# of structure (evaluation/synthetic.make_ring_scene, seed 5: 6000 blobs
# and 24 dark segments between radii 3.8-5.0 and inside 2.0 of the
# circle's centre, 0.8-3 m from the path: random SuperPoint keypoints sit
# on an 8-px grid, PERF.md §6, so close structure keeps the disparities
# large against it), 120 frames per lap and 10 more past the start, so the
# last keyframes see the first keyframe's place with landmarks of their own
LOOP_FRAMES = 130
LOOP_PER_LAP = 120
LOOP_MIN_GAP = 25  # LoopDetector's default
# the kidnap of the reloc phase: the circle's first frames tracked, black
# pairs (the track is lost), then frames back at early poses
RELOC_TRACK = 50
RELOC_BLACK = 5
RELOC_WAKE = tuple(range(4, 10))
RELOC_REANCHOR = RELOC_WAKE[-1]  # the wake-up frame the re-anchoring route is forced on
# the global layer's gates, from the JAX package's own runs of the same
# scenes at 376×240 on the CPU (tests/torch_slice_reference.py --loop,
# --reloc, --epipolar; PERF.md §6): its best accepted loop's Z within
# 0.1988 m and 3.002° of the truth (bounds 2×: at least one accepted loop
# must be as good; with random weights the detector accepts loops whose Z
# is near the identity, in the JAX package's code as in the port's,
# PERF.md), its keyframe ATE after the closing global passes 1.6979 m
# (1.6×: 2.72 m, under the 2.99 m a frozen trajectory scores), the oracle
# kidnap's 1 relocalization and wake-up errors up to 0.00314 m (2×), the
# neural re-anchoring route's error 0.1019 m (2×), the epipolar path's
# ATE 0.2269 m (1.6×) and the filter keeping every planted set's inliers
# (share 1.0) and none of its outliers
LOOP_Z_TRANS_BOUND = 0.40  # m
LOOP_Z_ROT_BOUND = 6.0  # degrees
LOOP_ATE_BOUND = 2.72  # m
RELOC_JAX_COUNT = 1
RELOC_ERR_BOUND = 0.0063  # m, every wake-up frame after the relocalization
RELOC_REANCHOR_BOUND = 0.204  # m, the neural re-anchoring route's error
EPI_ATE_BOUND = 0.36  # m
EPI_JAX_KEPT = (1.0, 1.0, 1.0, 1.0, 1.0)  # JAX's kept inlier share per planted set
EPI_KEPT_MARGIN = 0.02


def loop_sequence():
    """(scene, camera poses) of end_to_end_loop and reloc."""
    from rspl_slam_tpu_torch.evaluation import synthetic

    return (synthetic.make_ring_scene(num_points=6000, num_lines=24, outer=(3.8, 5.0),
                                      inner=2.0, seed=5),
            synthetic.make_loop_trajectory(LOOP_FRAMES, LOOP_PER_LAP))


def loop_z_error(lc, kf_frame_id, gt) -> dict:
    """An accepted loop's measured Z = Tcw_i·Twc_j against the true
    relative pose of its two keyframes' frames (``gt``: world poses), and
    the size of that true relative pose."""
    def angle(R):
        return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))))

    fi, fj = int(kf_frame_id[lc.i]), int(kf_frame_id[lc.j])
    Zt = np.linalg.inv(gt[fi]) @ gt[fj]
    return {"frames": [fi, fj], "z_trans_err_m": float(np.linalg.norm(lc.Z[:3, 3] - Zt[:3, 3])),
            "z_rot_err_deg": angle(lc.Z[:3, :3].T @ Zt[:3, :3]),
            "true_rel_m": float(np.linalg.norm(Zt[:3, 3])), "true_rel_deg": angle(Zt[:3, :3])}


def run_reloc(slam, frame, shape, gt) -> list:
    """The kidnap: ``frame(i)`` for the first RELOC_TRACK poses, RELOC_BLACK
    all-black pairs of ``shape``, then the RELOC_WAKE poses again. Returns
    the position errors of the wake-up frames against ``gt``."""
    idx = 0
    for i in range(RELOC_TRACK):
        slam.add_frame(idx, 0.05 * idx, *frame(i))
        idx += 1
    black = np.zeros(shape, np.uint8)
    for _ in range(RELOC_BLACK):
        slam.add_frame(idx, 0.05 * idx, black, black)
        idx += 1
    errs = []
    for i in RELOC_WAKE:
        rec = slam.add_frame(idx, 0.05 * idx, *frame(i))
        idx += 1
        errs.append(float(np.linalg.norm(rec.Twc[:3, 3] - gt[i][:3, 3])))
    slam.flush_ba()
    return errs


def reanchor(slam, feats, frame: int, gt) -> dict | None:
    """The re-anchoring route of relocalization as ``SLAMSystem._track``
    runs it after ``reloc_after`` lost frames, forced on one frame: the
    keyframe database queried with the frame's raw ``feats``, tracking
    re-anchored on the verified keyframe (its stored features, the 3D-3D
    fit's pose), the re-match (the frontend's ``match``: K2, K3 with the
    neural frontend) and the pose solve (PnP + LM). Returns None when no
    keyframe verifies; else the keyframe, the matches and inliers, and the
    position error of the solved pose (and of the 3D-3D fit's) against the
    keyframe's stored pose carried by the true relative motion from the
    keyframe's frame to ``frame`` (``gt``: world poses), which leaves the
    map's own drift out."""
    r = slam.loop_detector.relocalize(slam.map, feats.desc, feats.valid, feats.meas)
    if r is None:
        return None
    c, Twc_r, _ = r
    slam._ref_kf = int(c)
    slam._ref_feats = slam._features_from_keyframe(int(c))
    slam._last_Twc = np.asarray(Twc_r)
    i0 = np.asarray(slam.frontend.match(feats, slam._ref_feats))
    Twc, n_inl, _ = slam._pose_optimize(feats, i0)
    fc = int(slam.map.kf_frame_id[c])
    expect = slam.map.kf_pose[c] @ np.linalg.inv(gt[fc]) @ gt[frame]
    return {"keyframe": int(c), "keyframe_frame": fc, "matches": int((i0 >= 0).sum()),
            "inliers": int(n_inl),
            "error_m": float(np.linalg.norm(np.asarray(Twc)[:3, 3] - expect[:3, 3])),
            "fit_error_m": float(np.linalg.norm(np.asarray(Twc_r)[:3, 3] - expect[:3, 3]))}


def planted_matches(seed: int, n: int = 400, n_bad: int = 60):
    """Matches between two 752×480 views of a random cloud (EuRoC
    intrinsics, 0.1 rad yaw and 0.42 m apart, 0.3 px noise), ``n_bad`` of
    them planted outliers pushed 15-40 px off their epipolar line, ~10% of
    the rows unmatched: (xy0, xy1, matched, planted rows)."""
    from rspl_slam_tpu_torch.config import CameraConfig

    cam = CameraConfig()
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)
    X = rng.uniform([-3, -2, 3], [3, 2, 9], (n, 3))
    a = 0.1
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.4, 0.05, 0.1])

    def project(Xc):
        uv = Xc @ K.T
        return uv[:, :2] / uv[:, 2:] + rng.standard_normal((len(Xc), 2)) * 0.3

    p0, p1 = project(X), project(X @ R.T + t)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    F = np.linalg.inv(K).T @ tx @ R @ np.linalg.inv(K)
    bad = rng.choice(n, n_bad, replace=False)
    line = np.concatenate([p0[bad], np.ones((n_bad, 1))], -1) @ F.T
    normal = line[:, :2] / np.linalg.norm(line[:, :2], axis=1, keepdims=True)
    p1[bad] += normal * (rng.uniform(15, 40, (n_bad, 1)) * rng.choice([-1, 1], (n_bad, 1)))
    matched = rng.random(n) > 0.1
    return p0.astype(np.float32), p1.astype(np.float32), matched, bad


def _count_launches(prof) -> int:
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))


def _map_finite(m) -> bool:
    good = m.pt_status[: m.n_pt] == 2
    return bool(np.isfinite(m.kf_pose[: m.n_kf]).all()
                and np.isfinite(m.pt_pos[: m.n_pt][good]).all())


def global_ba_objective(slam) -> dict:
    """Global BA's problem (``slam.global_ba_problem()``) solved on the card
    as ``run_global_ba`` solves it: the robust phase-1 objective before and
    after, and the final cost."""
    from rspl_slam_tpu_torch.backend import local_ba

    prob, _ = slam.global_ba_problem()
    o = slam.cfg.optimization
    b = o.backend
    chi2 = dict(chi2_mono=b.mono_point, chi2_stereo=b.stereo_point,
                chi2_mono_line=b.mono_line, chi2_stereo_line=b.stereo_line)
    dev = local_ba.upload_problem(prob, slam.device)
    res = local_ba.optimize_local_map(slam.K, dev, iters1=o.ba_iters_phase1,
                                      iters2=o.ba_iters_phase2, **chi2)
    return {"initial_objective": float(local_ba.robust_objective(slam.K, dev, None, **chi2)),
            "objective": float(local_ba.robust_objective(slam.K, dev, res, **chi2)),
            "cost": float(local_ba.fetch_result(res).cost)}


def phase_end_to_end_loop():
    """The global layer at full width: ``SLAMSystem(SystemConfig(pipeline=
    PipelineConfig(track_local_map=True)), fe, enable_loop_closure=True)``
    (lines, async BA, relocalization on) through ``PipelinedRunner`` over
    :func:`loop_sequence` (8-bit frames), then ``run_pose_graph()`` and
    ``run_global_ba()`` as the CLI runs them at the end; those two passes
    again on a deep copy of the map must repeat bit for bit (and are
    counted by torch.profiler: launches per solve). Returns (line,
    launches, frames, ground truth) for the reloc phase."""
    import copy

    import torch
    from torch.profiler import ProfilerActivity, profile

    from rspl_slam_tpu_torch.config import PipelineConfig, SystemConfig
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error, synthetic
    from rspl_slam_tpu_torch.pipeline import PipelinedRunner
    from rspl_slam_tpu_torch.slam import INIT_POSE, SLAMSystem

    cfg = SystemConfig(pipeline=PipelineConfig(track_local_map=True))
    cam = cfg.camera
    scene, traj = loop_sequence()
    t0 = time.perf_counter()
    frames = [tuple((np.clip(im, 0, 1) * 255).astype(np.uint8)
                    for im in synthetic.render_images(scene, cam, traj[i], seed=i))
              for i in range(LOOP_FRAMES)]
    render_s = time.perf_counter() - t0
    gt = np.einsum("ij,njk->nik", INIT_POSE, traj)
    ts = np.arange(LOOP_FRAMES) * 0.05

    def kf_ate(m):
        kt, kp = m.keyframe_trajectory()
        return float(absolute_trajectory_error(kt, kp[:, :3, 3], ts, gt[:, :3, 3])["rmse"])

    def frozen_ate(m):
        """What a keyframe trajectory that never moved scores: after the
        rigid fit, the RMS distance of the keyframes' true positions from
        their centroid."""
        p = gt[m.kf_frame_id[: m.n_kf], :3, 3]
        return float(np.sqrt(((p - p.mean(0)) ** 2).sum(1).mean()))

    fe = _frontend(cfg, True)
    slam = SLAMSystem(cfg, fe, enable_loop_closure=True)
    slam.loop_detector.min_gap = LOOP_MIN_GAP
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    recs = PipelinedRunner(slam, _StereoFrames(frames)).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counters()
    slam.flush_ba()
    m = slam.map
    loops = [{"i": lc.i, "j": lc.j, "inliers": lc.n_inliers, "similarity": lc.similarity,
              **loop_z_error(lc, m.kf_frame_id, gt)} for lc in slam.loop_constraints]
    ate_before = kf_ate(m)
    during = list(slam.pose_graph_solves)
    snapshot, last_twc = copy.deepcopy(m), slam._last_Twc.copy()
    # the closing passes, as `cli run --pose-graph --global-ba` runs them;
    # global BA's problem is also solved here, to read the robust objective
    # before and after the same solve
    pg = slam.run_pose_graph()
    closing = slam.pose_graph_solves[len(during):]
    gba_check = global_ba_objective(slam)
    gba = slam.run_global_ba()
    ate_after = kf_ate(m)
    poses = m.kf_pose[: m.n_kf].copy()
    # the same passes on a deep copy of the map, under the profiler
    slam.map, slam._last_Twc = snapshot, last_twc
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_pg:
        pg2 = slam.run_pose_graph()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_gba:
        gba2 = slam.run_global_ba()
        torch.cuda.synchronize()
    repeat = {"pose_graph_cost": pg2 == pg, "global_ba_cost": gba2 == gba,
              "keyframe_ate": kf_ate(slam.map) == ate_after,
              "keyframe_poses": bool(np.array_equal(slam.map.kf_pose[: slam.map.n_kf], poses))}
    med = {k: float(np.median(v)) * 1e3 for k, v in slam.timings.items()}
    inliers = [int(r.num_inliers) for r in recs[1:]]
    tracked = sum(n > E2E_MIN_INLIERS for n in inliers)
    frozen = frozen_ate(m)
    line = {"phase": "end_to_end_loop", "frames": LOOP_FRAMES, "per_lap": LOOP_PER_LAP,
            "image": [cam.image_width, cam.image_height], "upload": "uint8",
            "max_keypoints": cfg.superpoint.max_keypoints,
            "gnn_layers": cfg.superglue.num_gnn_layers,
            "sinkhorn_iters": cfg.superglue.sinkhorn_iterations, "use_lines": cfg.use_lines,
            "track_local_map": True, "min_gap": LOOP_MIN_GAP, "initialized": slam.initialized,
            "keyframes": int(m.n_kf), "loops": loops,
            "z_bounds": [LOOP_Z_TRANS_BOUND, LOOP_Z_ROT_BOUND],
            "reloc_count": slam.reloc_count, "inliers": inliers,
            "frames_over_min_inliers": tracked,
            "keyframe_ate_rmse_m": ate_before, "keyframe_ate_after_global_m": ate_after,
            "keyframe_ate_frozen_m": frozen,
            "ate_bound_m": LOOP_ATE_BOUND, "solves_at_loops": during, "closing_solves": closing,
            "global_ba": gba_check,
            "pose_graph_ms": [1e3 * x for x in slam.timings.get("pose_graph", [])],
            "global_ba_ms": [1e3 * x for x in slam.timings.get("global_ba", [])],
            "loop_detect_ms_median": med.get("loop_detect"),
            "loop_detect_ms_max": 1e3 * max(slam.timings.get("loop_detect", [0.0])),
            "launches_per_pose_graph_solve": _count_launches(prof_pg),
            "launches_per_global_ba_solve": _count_launches(prof_gba),
            "repeat_on_map_copy": repeat, "frames_per_s": LOOP_FRAMES / wall, "wall_s": wall,
            "stage_median_ms": med, "render_s": render_s,
            "ba_windows": len(slam.ba_windows),
            "max_memory_allocated_MB": torch.cuda.max_memory_allocated() / 2**20,
            "launches": launches}
    emit(line)
    if not slam.initialized or not loops:
        raise AssertionError(f"end_to_end_loop: no loop accepted ({m.n_kf} keyframes)")
    if tracked < 0.8 * len(inliers):
        raise AssertionError(f"end_to_end_loop: too few tracked frames: {inliers}")
    if not any(lp["z_trans_err_m"] < LOOP_Z_TRANS_BOUND and lp["z_rot_err_deg"] < LOOP_Z_ROT_BOUND
               for lp in loops):
        raise AssertionError(f"end_to_end_loop: no loop's Z within the JAX bound: {loops}")
    if not (during and closing and pg is not None and gba is not None):
        raise AssertionError(f"end_to_end_loop: pose graph {pg} / global BA {gba} did not run")
    for s in during + closing:
        if not (np.isfinite([s["initial_cost"], s["cost"]]).all()
                and s["cost"] <= s["initial_cost"]):
            raise AssertionError(f"end_to_end_loop: pose graph ended above its start: {s}")
    if not (np.isfinite(list(gba_check.values())).all()
            and gba_check["objective"] <= gba_check["initial_objective"]
            and gba_check["cost"] == gba):
        raise AssertionError(f"end_to_end_loop: global BA ended above its start, or its "
                             f"solve differs from run_global_ba's ({gba}): {gba_check}")
    if not (_map_finite(m) and np.isfinite(np.stack([r.Twc for r in recs])).all()):
        raise AssertionError("end_to_end_loop: non-finite map")
    if not ate_after < LOOP_ATE_BOUND < frozen:
        raise AssertionError(f"end_to_end_loop: keyframe ATE {ate_after} over {LOOP_ATE_BOUND}, "
                             f"or that bound not below a frozen trajectory's {frozen}")
    if not ate_after <= ate_before:
        raise AssertionError(f"end_to_end_loop: the closing passes raised the keyframe ATE "
                             f"from {ate_before} to {ate_after}")
    for k in ("conv_stem", "conv_stem_side", "superglue_layer", "sinkhorn"):
        if launches[k] <= 0:
            raise AssertionError(f"end_to_end_loop: kernel {k} never launched")
    if not all(repeat.values()):
        raise AssertionError(f"end_to_end_loop: the global passes do not repeat: {repeat}")
    return line, launches, frames, gt


def _blackout(ff_cls, K: int, D: int = 256):
    """A frame without a single keypoint (the oracle kidnap's blackout)."""
    return ff_cls(xy=np.zeros((K, 2), np.float32), score=np.zeros(K, np.float32),
                  desc=np.zeros((K, D), np.float32), valid=np.zeros(K, bool),
                  meas=np.full((K, 3), -1.0, np.float32), depth=np.zeros(K, np.float32))


def phase_reloc(frames, gt):
    """Relocalization on the card. Gated: the kidnapped-robot run of the
    JAX package's ``tests/test_relocalization.py`` (the EuRoC camera,
    oracle features of a wide scene, K = 256, BA on: 50 frames of a yaw
    sweep, 5 frames without a keypoint, 6 frames back at early poses;
    tracking, PnP, LM and BA on the card), with JAX's relocalization count
    and the error after it under the bound from JAX's run. Measured beside
    it: the same kidnap with the neural frontend at full width on the
    circle (:func:`run_reloc`); with random weights SuperGlue matches
    ~130 of 400 keypoints between any two views, so the JAX package's
    trigger (fewer than ``min_num_match`` matches against the reference
    keyframe) never fires there, in either package (PERF.md). So the
    route it would take is then forced on the last wake-up frame
    (:func:`reanchor`) and gated: a keyframe verifies, > 20 inliers, the
    error under twice the JAX package's on the same route, K2 and K3
    launched."""
    import torch

    from rspl_slam_tpu_torch.config import PipelineConfig, SuperPointConfig, SystemConfig
    from rspl_slam_tpu_torch.evaluation import synthetic
    from rspl_slam_tpu_torch.frontend.frontends import FrameFeatures, OracleFrontend
    from rspl_slam_tpu_torch.slam import INIT_POSE, SLAMSystem

    K = 256
    cfg = SystemConfig(superpoint=SuperPointConfig(max_keypoints=K),
                       pipeline=PipelineConfig(ba_max_points=512, ba_max_lines=16))
    cam = cfg.camera
    scene = synthetic.make_scene(num_points=1500, num_lines=0, extent=(40.0, 6.0, 14.0), seed=5)
    traj = synthetic.make_trajectory(50, step=0.02, yaw_rate=0.032)
    fe = OracleFrontend(cfg, scene, noise_px=0.3, seed=1)
    slam = SLAMSystem(cfg, fe, enable_ba=True, enable_relocalization=True)
    t0 = time.perf_counter()
    idx = 0
    for i in range(50):
        slam.add_frame_features(idx, idx * 0.05, fe.observe(traj[i]))
        idx += 1
    for _ in range(5):
        slam.add_frame_features(idx, idx * 0.05, _blackout(FrameFeatures, K))
        idx += 1
    errs = []
    for k in range(6):
        rec = slam.add_frame_features(idx, idx * 0.05, fe.observe(traj[4 + k]))
        idx += 1
        errs.append(float(np.linalg.norm(rec.Twc[:3, 3] - (INIT_POSE @ traj[4 + k])[:3, 3])))
    slam.flush_ba()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    # the neural kidnap at full width (measured)
    ncfg = SystemConfig()
    ncam = ncfg.camera
    neural = SLAMSystem(ncfg, _frontend(ncfg, True), enable_relocalization=True)
    _reset_counters()
    t0 = time.perf_counter()
    nerrs = run_reloc(neural, lambda i: frames[i], (ncam.image_height, ncam.image_width), gt)
    torch.cuda.synchronize()
    nwall = time.perf_counter() - t0
    launches = _counters()
    # the re-anchoring route with the neural frontend, forced on one wake-up
    # frame: the query, the keyframe's features, the re-match (K2, K3), PnP + LM
    feats = neural.frontend.extract_pair(*frames[RELOC_REANCHOR])
    _reset_counters()
    ra = reanchor(neural, feats, RELOC_REANCHOR, gt)
    torch.cuda.synchronize()
    re_launches = _counters()
    line = {"phase": "reloc", "oracle": {
                "image": [cam.image_width, cam.image_height], "max_keypoints": K,
                "frames": len(slam.records), "reloc_count": slam.reloc_count,
                "jax_reloc_count": RELOC_JAX_COUNT, "errors_m": errs,
                "error_bound_m": RELOC_ERR_BOUND, "keyframes": int(slam.map.n_kf),
                "reloc_ms": [1e3 * x for x in slam.timings.get("reloc", [])], "wall_s": wall},
            "neural": {
                "image": [ncam.image_width, ncam.image_height], "frames": len(neural.records),
                "reloc_count": neural.reloc_count, "errors_m": nerrs,
                "inliers_wake": [int(r.num_inliers) for r in neural.records[-len(RELOC_WAKE):]],
                "reloc_calls": len(neural.timings.get("reloc", [])),
                "keyframes": int(neural.map.n_kf), "wall_s": nwall,
                "reanchor": {"frame": RELOC_REANCHOR, **(ra or {}),
                             "error_bound_m": RELOC_REANCHOR_BOUND,
                             "launches": re_launches}},
            "launches": launches}
    emit(line)
    if slam.reloc_count != RELOC_JAX_COUNT:
        raise AssertionError(f"reloc: {slam.reloc_count} relocalizations, JAX "
                             f"{RELOC_JAX_COUNT}: {line}")
    if not (np.isfinite(errs).all() and max(errs) < RELOC_ERR_BOUND):
        raise AssertionError(f"reloc: error after relocalization {errs} over {RELOC_ERR_BOUND}")
    if not (_map_finite(slam.map) and _map_finite(neural.map) and np.isfinite(nerrs).all()):
        raise AssertionError("reloc: non-finite map or pose")
    if ra is None or not (ra["inliers"] > E2E_MIN_INLIERS
                          and ra["error_m"] < RELOC_REANCHOR_BOUND):
        raise AssertionError(f"reloc: the neural re-anchoring route failed: {ra}")
    for k in ("superglue_layer", "sinkhorn"):
        if re_launches[k] <= 0:
            raise AssertionError(f"reloc: kernel {k} never launched on the re-anchoring route")
    for k in ("conv_stem", "conv_stem_side", "superglue_layer", "sinkhorn"):
        if launches[k] <= 0:
            raise AssertionError(f"reloc: kernel {k} never launched")
    return line, launches


def phase_epipolar():
    """``match_outlier_rejection`` on the BA path's 30 frames (lines, async
    BA; the unfused tracking route, every stereo and temporal match through
    K2, K3 and the epipolar filter), gated as the BA path; then the filter
    alone on the card on :func:`planted_matches` (its own generator): every
    planted outlier rejected, the inliers kept at JAX's rate."""
    import torch

    from rspl_slam_tpu_torch.config import PipelineConfig, SystemConfig
    from rspl_slam_tpu_torch.ops.matching import fundamental_ransac_inliers
    from rspl_slam_tpu_torch.slam import SLAMSystem

    cfg = SystemConfig(pipeline=PipelineConfig(match_outlier_rejection=True))
    cam = cfg.camera
    frames, traj, render_s = _scene(cfg, True)
    fe = _frontend(cfg, True)
    slam = SLAMSystem(cfg, fe)
    _reset_counters()
    t0 = time.perf_counter()
    recs = [slam.add_frame(i, 0.05 * i, *frames[i]) for i in range(E2E_FRAMES)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counters()
    slam.flush_ba()
    ate = _ate(recs, traj)
    inliers = [int(r.num_inliers) for r in recs[1:]]
    tracked = sum(n > E2E_MIN_INLIERS for n in inliers)
    planted = []
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for seed in range(len(EPI_JAX_KEPT)):
        p0, p1, matched, bad = planted_matches(seed)
        args = [torch.as_tensor(a, device=dev) for a in (p0, p1, matched)]
        ok = fundamental_ransac_inliers(*args, g).cpu().numpy()
        good = np.setdiff1d(np.nonzero(matched)[0], bad)
        planted.append({"kept_inlier_share": float(ok[good].mean()),
                        "kept_outliers": int(ok[bad].sum()), "kept_unmatched": int(ok[~matched].sum()),
                        "jax_kept_inlier_share": EPI_JAX_KEPT[seed]})
    args = [torch.as_tensor(a, device=dev) for a in planted_matches(0)[:3]]
    filter_ms = time_ms(lambda: fundamental_ransac_inliers(*args, g), n=5, warmup=1)
    med = {k: float(np.median(v)) * 1e3 for k, v in slam.timings.items()}
    line = {"phase": "epipolar", "frames": E2E_FRAMES, "image": [cam.image_width,
            cam.image_height], "fused_tracking": slam._fused_enabled,
            "initialized": slam.initialized, "keyframes": int(slam.map.n_kf),
            "inliers": inliers, "frames_over_min_inliers": tracked, "ate_rmse_m": ate,
            "ate_bound_m": EPI_ATE_BOUND, "keyframe_ate_rmse_m": _keyframe_ate(slam.map, traj),
            "planted": planted, "filter_ms": filter_ms, "frames_per_s": E2E_FRAMES / wall,
            "wall_s": wall, "stage_median_ms": med, "render_s": render_s,
            "ba_windows": len(slam.ba_windows), "launches": launches}
    emit(line)
    if slam._fused_enabled or not slam.initialized:
        raise AssertionError(f"epipolar: fused {slam._fused_enabled}, initialized "
                             f"{slam.initialized}")
    if tracked < 0.8 * len(inliers) or not np.isfinite(np.stack([r.Twc for r in recs])).all():
        raise AssertionError(f"epipolar: too few tracked frames: {inliers}")
    if not ate < EPI_ATE_BOUND:
        raise AssertionError(f"epipolar: ATE {ate} over the bound {EPI_ATE_BOUND}")
    if line["ba_windows"] < 1 or not _map_finite(slam.map):
        raise AssertionError("epipolar: no BA window or a non-finite map")
    for k in ("conv_stem", "conv_stem_side", "superglue_layer", "sinkhorn"):
        if launches[k] <= 0:
            raise AssertionError(f"epipolar: kernel {k} never launched")
    for p in planted:
        if p["kept_outliers"] or p["kept_unmatched"] or (
                p["kept_inlier_share"] < p["jax_kept_inlier_share"] - EPI_KEPT_MARGIN):
            raise AssertionError(f"epipolar: the filter on planted outliers: {planted}")
    return line, launches


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
    return line, launches, {"work": work, "tree": tree, "euroc": euroc, "cam_yaml": cam_yaml,
                            "cfg": cfg}


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


def phase_cli_global(ctx):
    """``cli run --loop-closure --pose-graph --global-ba --track-local-map
    --config configs/euroc.yaml`` on cli_run's tree, in the same kind of
    subprocess (PyYAML, PIL, matplotlib hidden): exit 0, the JAX CLI's
    epilogue lines, and the trajectory file equal to an in-process run with
    the same options (runner, then ``run_pose_graph`` and
    ``run_global_ba``)."""
    import torch

    from rspl_slam_tpu_torch.config import load_system_config
    from rspl_slam_tpu_torch.datasets import open_dataset
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.pipeline import PipelinedRunner
    from rspl_slam_tpu_torch.slam import SLAMSystem

    work, tree, euroc, cam_yaml = ctx["work"], ctx["tree"], ctx["euroc"], ctx["cam_yaml"]
    traj, inproc = os.path.join(work, "global.txt"), os.path.join(work, "global_inproc.txt")
    weights = [a for k in ("sp", "sg", "rcf")
               for a in (f"--{k}-weights", os.path.join(work, f"{k}.npz"))]
    t0 = time.perf_counter()
    out = _cli("run", "--dataroot", tree, "--config", euroc, "--camera-config", cam_yaml,
               *weights, "--traj-path", traj, "--loop-closure", "--pose-graph", "--global-ba",
               "--track-local-map")
    cli_wall = time.perf_counter() - t0
    epilogue = re.findall(r"^(?:loop closures accepted|pose graph|global BA):.*$", out, re.M)
    launches = json.loads(re.search(r"^kernel launches: (.*)$", out, re.M).group(1))

    cfg = ctx["cfg"]
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                track_local_map=True))
    slam = SLAMSystem(cfg, NeuralFrontend(cfg), enable_loop_closure=True)
    _reset_counters()
    PipelinedRunner(slam, open_dataset(tree, compiled=True),
                    queue_depth=cfg.pipeline.queue_depth).run()
    pg = slam.run_pose_graph()
    gba = slam.run_global_ba()
    torch.cuda.synchronize()
    inproc_launches = _counters()
    slam.save_trajectory(inproc)
    with open(traj) as f, open(inproc) as g:
        cli_traj, inproc_traj = f.read(), g.read()
    expect = ([f"loop closures accepted: {len(slam.loop_constraints)}"]
              if slam.loop_constraints else [])
    expect.append("pose graph: skipped — no verified loop constraints (the covisibility/odometry "
                  "graph is already at its optimum; enable --loop-closure to supply "
                  "measurements)" if pg is None else
                  f"pose graph: optimized {slam.map.n_kf} keyframes (final cost {pg:.3e})")
    expect.append(f"global BA: refined {slam.map.n_kf} keyframes jointly (final cost {gba:.3e})"
                  if gba is not None else "global BA: skipped (map too small)")
    line = {"phase": "cli_global", "epilogue": epilogue, "epilogue_inproc": expect,
            "loops": len(slam.loop_constraints), "pose_graph_cost": pg, "global_ba_cost": gba,
            "pose_graph_solves": slam.pose_graph_solves,
            "trajectory_equal_inproc": cli_traj == inproc_traj,
            "keyframes": len(cli_traj.splitlines()), "cli_wall_s": cli_wall,
            "launches": launches, "inproc_launches": inproc_launches}
    emit(line)
    if epilogue != expect or gba is None:
        raise AssertionError(f"cli_global: epilogue {epilogue} against {expect}")
    if cli_traj != inproc_traj:
        raise AssertionError("cli_global: the CLI's trajectory differs from the in-process "
                             f"run's:\n{cli_traj}\n---\n{inproc_traj}")
    for k in ("conv_stem", "conv_stem_side", "superglue_layer", "sinkhorn"):
        if launches[k] <= 0:
            raise AssertionError(f"cli_global: kernel {k} never launched")
    if launches != inproc_launches:
        raise AssertionError(f"cli_global: launches {launches} against {inproc_launches}")
    return line, launches


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


# training: the three trainers on the card, then their weights on the
# kernels (each phase's counters reset just before its own path and read
# just after; the kernel-vs-plain checks on trained weights come after)
TRAIN_SP_CAM = dict(image_width=160, image_height=120, fx=120.0, fy=120.0, cx=80.0,
                    cy=60.0, bf=12.0)
TRAIN_SP_STEPS = 120
TRAIN_SP_RECALL_GAIN = 0.08  # JAX's slow test: recall@2 px rises by more than this
TRAIN_RCF_STEPS = 40
TRAIN_RCF_HW = (240, 376)  # RCF's ×0.5 detection size of 752×480
TRAIN_SG_BIG_STEPS = 10
TRAIN_SG_DECODE_SHARE = 0.99
TRAIN_SG_F32_ATOL = 1e-3  # the f32 log plan, kernels vs plain (the card test's bound)
# bf16, 18 layers: the kernels may part from the plain forward by at most this
# many times the plain forward's own spread (the same function on the CPU:
# the same bf16 rounding points, another f32 summation order)
TRAIN_SG_BF16_SPREAD = 2.0
K3_ATOL = 1e-3  # K3's kernel line
BANK_PAIRS = 8
BANK_LABEL_SHARE = 0.95  # labels equal by keypoint position (bf16 ties reorder rows)
PRETRAIN_STEPS = 20


def _train_report(stats: dict) -> dict:
    """Median host-data and device-step ms of a ``train`` run's stats (the
    first step, with its one-time set-up, apart)."""
    return {"steps": len(stats["step_ms"]),
            "data_ms_median": float(np.median(stats["data_ms"][1:])),
            "step_ms_median": float(np.median(stats["step_ms"][1:])),
            "step_ms_first": stats["step_ms"][0] + stats["data_ms"][0],
            "host_share": float(np.sum(stats["data_ms"][1:])
                                / (np.sum(stats["data_ms"][1:]) + np.sum(stats["step_ms"][1:])))}


def _peak_start() -> int:
    """Reset the card's peak-memory counter; returns the bytes allocated
    now (tensors earlier phases keep alive), the phase's baseline."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_mb(base: int) -> dict:
    """The phase's own peak: the most allocated since :func:`_peak_start`
    above its baseline (MB), and the baseline."""
    import torch

    return {"peak_MB": (torch.cuda.max_memory_allocated() - base) / 2**20,
            "baseline_MB": base / 2**20}


def _grid_share(xy, valid) -> float:
    """Share of valid keypoints at their 8×8 cell's most common offset."""
    off = np.round(xy[valid]).astype(np.int64) % 8
    counts = np.bincount(off[:, 1] * 8 + off[:, 0], minlength=64)
    return float(counts.max() / max(counts.sum(), 1))


def _stem_check(w_a, b_a, w_b, b_b, images, side_w=None):
    """K1 on trained weights against its plain version on the same inputs
    (conv1a / conv1_1 as c_in = 1 first): the kernel line's tolerance,
    bf16 out rtol 2^-7 + atol 1e-3, side score rtol 1e-4 + 1e-4·max."""
    import torch

    from rspl_slam_tpu_torch.ops import conv_stem_cuda as cs

    with torch.no_grad():
        x = cs.conv1a(images, w_a, b_a, torch.bfloat16)
        wk = cs.pack_weights(w_b) if w_b.is_cuda else w_b  # K1's layout on the card
        got = cs.conv3x3_relu_pool(x, wk, b_b, side_w)
        ref = cs.conv3x3_relu_pool_plain(x, w_b, b_b, side_w)
        torch.cuda.synchronize()
    if side_w is None:
        return _allclose_report("k1", got, ref, 2.0 ** -7, 1e-3)
    ok, err = _allclose_report("k1", got[0], ref[0], 2.0 ** -7, 1e-3)
    ok_s, err_s = _allclose_report("k1 side", got[1], ref[1], 1e-4,
                                   1e-4 * float(ref[1].abs().max()))
    return ok and ok_s, max(err, err_s)


def phase_train_superpoint():
    """The JAX package's slow SuperPoint test on the card: 120 Adam steps
    (lr 1e-3, batch 2, seed 0) on rendered 160×120 scenes from a random
    init; gated on the loss falling, recall@2 px against the rendered
    keypoints rising by more than 0.08 and the median localization error
    falling (bf16 extraction through K1 before and after), then the trained
    conv1b through K1 against its plain version."""
    import torch

    from rspl_slam_tpu_torch.config import CameraConfig, SuperPointConfig
    from rspl_slam_tpu_torch.evaluation import synthetic
    from rspl_slam_tpu_torch.models import superpoint
    from rspl_slam_tpu_torch.models.weights import superpoint_from_numpy
    from rspl_slam_tpu_torch.training import superpoint_train

    cam = CameraConfig(**TRAIN_SP_CAM)
    cfg = SuperPointConfig(max_keypoints=100, keypoint_threshold=1e-4)
    imgs, gts = [], []
    for s in (11, 12, 13):
        scene = synthetic.make_scene(num_points=120, num_lines=0, seed=s, extent=(4.0, 3.0, 4.0))
        imgs.append(synthetic.render_images(scene, cam, np.eye(4), seed=s)[0])
        obs = synthetic.observe_points(scene, cam, np.eye(4))
        gts.append(obs["uv_left"][obs["visible"]])
    images = torch.as_tensor(np.stack(imgs)).cuda()

    def localization(params):
        f = superpoint.extract(superpoint_from_numpy(params), images, cfg)  # bf16: K1
        recalls, errs = [], []
        for b, gt in enumerate(gts):
            xy = f.xy[b][f.valid[b]].cpu().numpy()
            d = np.linalg.norm(gt[:, None] - xy[None], axis=-1).min(1)
            recalls.append(float((d < 2.0).mean()))
            errs.append(float(np.median(d)))
        return float(np.mean(recalls)), float(np.mean(errs))

    p0 = superpoint.init_params(0)
    base = _peak_start()
    _reset_counters()
    r0, e0 = localization(p0)
    stats = {}
    t0 = time.perf_counter()
    trained = superpoint_train.train(cam, steps=TRAIN_SP_STEPS, batch=2, lr=1e-3, seed=0,
                                     params=p0, verbose=False, device="cuda", stats=stats)
    wall = time.perf_counter() - t0
    r1, e1 = localization(trained)
    torch.cuda.synchronize()
    launches = _counters()
    peak = _peak_mb(base)
    t = {k: torch.as_tensor(v).cuda() for k, v in (
        ("w1a", trained["conv1a"]["w"]), ("b1a", trained["conv1a"]["b"]),
        ("w1b", trained["conv1b"]["w"]), ("b1b", trained["conv1b"]["b"]))}
    k1_ok, k1_err = _stem_check(t["w1a"], t["b1a"], t["w1b"], t["b1b"], images)
    hist = stats["loss"]
    line = {"phase": "train_superpoint", "card": CARD,
            "image": [cam.image_width, cam.image_height],
            "batch": 2, "lr": 1e-3, "wall_s": wall, **_train_report(stats),
            "loss_first": hist[0], "loss_last": hist[-1],
            "loss_first10_mean": float(np.mean(hist[:10])),
            "loss_last10_mean": float(np.mean(hist[-10:])),
            "recall_2px": [r0, r1], "median_err_px": [e0, e1],
            **peak, "launches": launches,
            "k1_trained_ok": k1_ok, "k1_trained_max_abs_err": k1_err}
    emit(line)
    if not np.isfinite(hist).all() or not np.mean(hist[-10:]) < np.mean(hist[:10]):
        raise AssertionError(f"train_superpoint: the loss did not fall: {hist[:3]} … {hist[-3:]}")
    if not r1 > r0 + TRAIN_SP_RECALL_GAIN:
        raise AssertionError(f"train_superpoint: recall@2px {r0} → {r1}")
    if not e1 < e0:
        raise AssertionError(f"train_superpoint: median error {e0} → {e1}")
    if launches["conv_stem"] != 2:
        raise AssertionError(f"train_superpoint: K1 launched {launches['conv_stem']} times")
    if not k1_ok:
        raise AssertionError(f"train_superpoint: K1 on the trained weights disagrees: {k1_err}")
    return line, launches, trained


def phase_train_rcf():
    """RCF at full width on rendered polygon scenes at 240×376 (the ×0.5
    detection size of 752×480): 40 Adam steps, batch 2, lr 3e-4; gated on
    the loss falling; then the trained weights' ``edge_logits`` on the card
    (stage 1 through K1's side mode, counted) beside the generic recipe
    (measured), and stage 1 through K1 against its plain version (gated)."""
    import torch

    from rspl_slam_tpu_torch.models import rcf
    from rspl_slam_tpu_torch.models.weights import rcf_from_numpy
    from rspl_slam_tpu_torch.training import rcf_train

    H, W = TRAIN_RCF_HW
    stats = {}
    base = _peak_start()
    _reset_counters()
    t0 = time.perf_counter()
    trained, hist = rcf_train.train(steps=TRAIN_RCF_STEPS, batch=2, hw=(H, W), width_mult=1.0,
                                    lr=3e-4, seed=0, params=rcf.init_params(0, 1.0),
                                    verbose=False, device="cuda", stats=stats)
    wall = time.perf_counter() - t0
    peak = _peak_mb(base)
    imgs, gts = rcf_train.make_batch(H, W, 2, 12345, "cuda")
    m = rcf_from_numpy(trained)
    got = rcf.edge_logits(m, imgs)  # bf16, K1 side mode
    torch.cuda.synchronize()
    launches = _counters()
    ref = rcf.edge_logits(m, imgs, use_pallas_stem=False)
    dev = float(((got - ref).abs() / (ref.abs() + 1.0)).max())
    edge_f1 = {}
    for name, logit in (("k1", got), ("generic", ref)):
        pred = torch.sigmoid(logit) > 0.5
        tp = float((pred & gts).sum())
        edge_f1[name] = 2 * tp / max(float(pred.sum() + gts.sum()), 1.0)
    t = {k: torch.as_tensor(v).cuda() for k, v in (
        ("w11", trained["conv1_1"]["w"]), ("b11", trained["conv1_1"]["b"]),
        ("w12", trained["conv1_2"]["w"]), ("b12", trained["conv1_2"]["b"]))}
    side = m.conv1_2_side
    k1_ok, k1_err = _stem_check(t["w11"].sum(2, keepdim=True), t["b11"], t["w12"], t["b12"],
                                imgs * 255.0, side)
    line = {"phase": "train_rcf", "card": CARD, "image": [W, H], "width_mult": 1.0,
            "batch": 2, "lr": 3e-4,
            "wall_s": wall, **_train_report(stats), "loss_first": hist[0],
            "loss_last": hist[-1], "loss_first5_mean": float(np.mean(hist[:5])),
            "loss_last5_mean": float(np.mean(hist[-5:])),
            **peak, "launches": launches,
            "k1_vs_generic_max_rel": dev, "edge_f1_at_0.5": edge_f1,
            "k1_trained_ok": k1_ok, "k1_trained_max_abs_err": k1_err}
    emit(line)
    if not np.isfinite(hist).all() or not np.mean(hist[-5:]) < np.mean(hist[:5]):
        raise AssertionError(f"train_rcf: the loss did not fall: {hist[:3]} … {hist[-3:]}")
    if launches["conv_stem_side"] != 1 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"train_rcf: K1 side mode launches {launches['conv_stem_side']}")
    if not k1_ok:
        raise AssertionError(f"train_rcf: K1 side mode on the trained weights disagrees: {k1_err}")
    return line, launches


def _plan_sel(v0, v1):
    """The log plan's valid entries: valid rows and columns and the dustbins."""
    import torch

    one = torch.ones((v0.shape[0], 1), dtype=torch.bool, device=v0.device)
    return torch.cat([v0, one], 1)[:, :, None] & torch.cat([v1, one], 1)[:, None, :]


def _decoded(params, batch, cfg, dtype):
    """The inference ``match_pair`` (the kernels) and the plain forward
    (``log_plan`` + decode) on the same batch: indices0 and log plan of
    each, kernels first."""
    import torch

    from rspl_slam_tpu_torch.models import superglue
    from rspl_slam_tpu_torch.models.weights import superglue_from_numpy, to_tensor_tree
    from rspl_slam_tpu_torch.ops.matching import mutual_match_decode
    from rspl_slam_tpu_torch.training import superglue_train

    arrays = batch[:8]
    res = superglue.match_pair(superglue_from_numpy(params, cfg, "cuda"), *arrays, cfg,
                               compute_dtype=dtype)
    with torch.no_grad():
        z = superglue_train.log_plan(to_tensor_tree(params, "cuda"), *arrays, cfg, dtype)
        ref = mutual_match_decode(z, arrays[3], arrays[7], cfg.match_threshold)[0]
    return res.indices0, ref, res.log_plan, z


def _kernels_on_plain_inputs(params, arrays, cfg):
    """``match_pair``'s kernels at bf16, each on the plain forward's own
    input: every GNN layer through K2 against ``superglue_layer_plain`` on
    the same x (the plain output goes on) and against the same plain layer
    on the CPU (its own spread), then the Sinkhorn iterations through K3
    against the plain sweeps on the same problem (the kernel line's 1e-3).
    Returns (per layer [K2 vs plain, CPU plain vs plain] max |error| over
    valid rows, K3's max |error| on valid entries)."""
    import torch

    from rspl_slam_tpu_torch.models.superglue import _apply_mlp
    from rspl_slam_tpu_torch.models.weights import superglue_from_numpy
    from rspl_slam_tpu_torch.ops import attention_cuda as ac
    from rspl_slam_tpu_torch.ops import sinkhorn as sk
    from rspl_slam_tpu_torch.ops import sinkhorn_cuda as skc
    from rspl_slam_tpu_torch.ops.matching import normalize_keypoints

    dt = torch.bfloat16
    sg = superglue_from_numpy(params, cfg, "cuda")
    xy0, sc0, d0, v0, xy1, sc1, d1, v1 = arrays
    B = d0.shape[0]
    with torch.no_grad():  # models/superglue.match_pair, one piece at a time
        enc = torch.cat([torch.cat([normalize_keypoints(xy, cfg.image_width, cfg.image_height),
                                    sc[..., None]], -1) for xy, sc in ((xy0, sc0), (xy1, sc1))])
        x = (torch.cat([d0, d1], 0) + _apply_mlp(sg.kenc, enc, dt)).contiguous()
        masks = torch.cat([v0, v1], 0)
        scratch = ac.layer_scratch(x, masks, dt)
        layer_errs = []
        for li, layer in enumerate(sg.gnn):
            kw = dict(cross=li % 2 == 1, num_heads=cfg.num_heads, compute_dtype=dt)
            got = ac.superglue_layer(x, masks, layer, scratch=scratch, **kw)
            cpu = ac.superglue_layer_plain(x.cpu(), masks.cpu(),
                                           {k: v.cpu() for k, v in layer.items()}, **kw)
            x = ac.superglue_layer_plain(x, masks, layer, **kw)
            layer_errs.append([float((got - x).abs()[masks].max()),
                               float((cpu - x.cpu()).abs()[masks.cpu()].max())])
        r = ac.round_operand
        md = r(r(x, dt) @ r(sg.final_w, dt) + sg.final_b, dt)
        sim = torch.einsum("bmc,bnc->bmn", md[:B], md[B:]) / cfg.descriptor_dim ** 0.5
        Z0, mu, nu, norm = sk.build_problem(sim, v0, v1, sg.bin_score)
        got = skc.sinkhorn_iterations(Z0, mu, nu, cfg.sinkhorn_iterations)
        ref = sk.sinkhorn_iterations_plain(Z0, mu, nu, cfg.sinkhorn_iterations)
        torch.cuda.synchronize()
    _, k3_err = _allclose_report("sinkhorn", got, ref, 0.0, K3_ATOL, _plan_sel(v0, v1))
    return layer_errs, k3_err


def phase_train_superglue():
    """(a) JAX's tier-1 overfit on the card: 2 layers, 10 iterations, K =
    16, one fixed batch of 2, 60 steps; gated on the final loss under 0.3×
    the first, ``matching_accuracy`` (K2 f32 + K3) over 0.9 and equal to
    the plain version's, and the kernels' f32 log plan within 1e-3 of the
    plain forward's on valid entries. (b) ``SuperGlueConfig()`` at 752×480
    (18 layers, 100 iterations), K = 400, batch 8, 10 steps; gated on a
    finite loss that falls, the bf16 decode (K2 bf16 + K3) of a fresh
    batch of 8 equal to the plain forward's on ≥ 99% of valid rows (after
    10 steps nothing may decode, so values are gated too): the kernels'
    log plan, and each layer through K2 on the plain forward's own input,
    within 2× the plain version's own spread (the same plain function on
    the CPU: bf16 rounding at the same points, another f32 summation
    order, whose flipped roundings the 18 layers carry on), and K3 on the
    plain forward's Sinkhorn problem within its kernel line's 1e-3. The
    plain forward's bf16-vs-f32 gap is reported beside them."""
    import torch

    from rspl_slam_tpu_torch.config import SuperGlueConfig
    from rspl_slam_tpu_torch.models.weights import to_tensor_tree
    from rspl_slam_tpu_torch.training import superglue_train

    # (a)
    cfg = SuperGlueConfig(image_width=160, image_height=120, num_gnn_layers=2,
                          sinkhorn_iterations=10)
    fixed = superglue_train.make_batch(np.random.default_rng(0), 2, 16, cfg, "cuda")
    stats = {}
    base = _peak_start()
    _reset_counters()
    params, hist = superglue_train.train(cfg, steps=60, batch=2, K=16, lr=1e-3,
                                         verbose=False, batch_fn=lambda *a: fixed,
                                         device="cuda", stats=stats)
    acc = superglue_train.matching_accuracy(params, fixed, cfg)
    torch.cuda.synchronize()
    launches_a = _counters()
    peak_a = _peak_mb(base)
    acc_plain = superglue_train.plain_accuracy(params, fixed, cfg)
    _, _, z_k, z_p = _decoded(params, fixed, cfg, torch.float32)
    sel = _plan_sel(fixed[3], fixed[7])
    z_ok, z_err = _allclose_report("log_plan", z_k, z_p, 0.0, TRAIN_SG_F32_ATOL, sel)
    line_a = {"phase": "train_superglue", "card": CARD, "part": "a", "layers": 2,
              "iters": 10, "K": 16,
              "batch": 2, **_train_report(stats), "loss_first": hist[0],
              "loss_last": hist[-1], "accuracy": acc, "accuracy_plain": acc_plain,
              "log_plan_max_abs_err": z_err, "log_plan_tolerance": TRAIN_SG_F32_ATOL,
              **peak_a, "launches": launches_a}
    emit(line_a)
    if not hist[-1] < 0.3 * hist[0]:
        raise AssertionError(f"train_superglue (a): loss {hist[0]} → {hist[-1]}")
    if not (acc > 0.9 and acc == acc_plain):
        raise AssertionError(f"train_superglue (a): accuracy {acc}, plain {acc_plain}")
    if not z_ok:
        raise AssertionError(f"train_superglue (a): f32 log plan off by {z_err}")
    if launches_a["superglue_layer_f32"] != 2 or launches_a["sinkhorn"] != 1:
        raise AssertionError(f"train_superglue (a): launches {launches_a}")

    # (b)
    cfg = SuperGlueConfig()
    stats = {}
    gc.collect()
    torch.cuda.empty_cache()
    base = _peak_start()
    _reset_counters()
    params, hist = superglue_train.train(cfg, steps=TRAIN_SG_BIG_STEPS, batch=8, K=400,
                                         lr=1e-3, seed=0, verbose=False, device="cuda",
                                         stats=stats)
    peak_b = _peak_mb(base)
    batch = superglue_train.make_batch(np.random.default_rng(1), 8, 400, cfg, "cuda")
    got, ref, z_k, z_p = _decoded(params, batch, cfg, torch.bfloat16)
    torch.cuda.synchronize()
    launches_b = _counters()
    valid = batch[3]
    share = float((got == ref)[valid].float().mean())
    sel = _plan_sel(batch[3], batch[7])
    z_err = float((z_k - z_p).abs()[sel].max())
    with torch.no_grad():
        z_f32 = superglue_train.log_plan(to_tensor_tree(params, "cuda"), *batch[:8], cfg)
        z_cpu = superglue_train.log_plan(to_tensor_tree(params, "cpu"),
                                         *(a.cpu() for a in batch[:8]), cfg, torch.bfloat16)
    bf16_gap = float((z_p - z_f32).abs()[sel].max())
    spread = float((z_cpu - z_p.cpu()).abs()[sel.cpu()].max())
    layer_errs, k3_err = _kernels_on_plain_inputs(params, batch[:8], cfg)
    layers_ok = all(k <= TRAIN_SG_BF16_SPREAD * c for k, c in layer_errs)
    gt = batch[-1]
    real = (gt >= 0) & (gt < 400)
    acc_b = float((got.long() == gt)[real].float().mean())
    line_b = {"phase": "train_superglue", "card": CARD, "part": "b", "layers": cfg.num_gnn_layers,
              "iters": cfg.sinkhorn_iterations, "K": 400, "batch": 8,
              "image": [cfg.image_width, cfg.image_height], **_train_report(stats),
              "loss": hist, "decode_equal_share": share,
              "decoded_matches": int((got >= 0).sum()), "accuracy_bf16": acc_b,
              "accuracy_plain_bf16": float((ref.long() == gt)[real].float().mean()),
              "log_plan_max_abs_err": z_err, "log_plan_cpu_plain_spread": spread,
              "plain_bf16_vs_f32_max_abs_diff": bf16_gap,
              "k2_layer_max_abs_err_vs_cpu_spread": layer_errs, "k3_max_abs_err": k3_err,
              "tolerance": f"log plan and each layer (16, 400, 256): |kernel - plain| <= "
                           f"{TRAIN_SG_BF16_SPREAD}x |plain on the CPU - plain| (max over "
                           f"valid entries); K3 (8, 401, 401) {K3_ATOL}",
              **peak_b, "launches": launches_b}
    emit(line_b)
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        raise AssertionError(f"train_superglue (b): loss {hist}")
    if not share >= TRAIN_SG_DECODE_SHARE:
        raise AssertionError(f"train_superglue (b): decodes equal on {share} of rows")
    if not (z_err <= TRAIN_SG_BF16_SPREAD * spread and layers_ok and k3_err <= K3_ATOL):
        raise AssertionError(f"train_superglue (b): log plan off by {z_err} (the plain "
                             f"version's spread {spread}); K2 layers [kernel, spread] "
                             f"{layer_errs}; K3 {k3_err}")
    if launches_b["superglue_layer"] != cfg.num_gnn_layers or launches_b["sinkhorn"] != 1:
        raise AssertionError(f"train_superglue (b): launches {launches_b}")
    counts = {k: launches_a[k] + launches_b[k] for k in launches_a}
    return [line_a, line_b], counts


def _labels_by_position(problem):
    """A bank problem's labels keyed by keypoint position: row i of view A
    → its match's position in view B, "dustbin" or "invalid"."""
    xy0, _, _, _, xy1, _, _, _, gt0 = problem
    K = len(gt0)
    return {tuple(np.round(xy0[i], 2)): "dustbin" if g == K else "invalid" if g < 0
            else tuple(np.round(xy1[g], 2)) for i, g in enumerate(gt0)}


def phase_superglue_bank():
    """``make_shift_pair_bank`` on the card, the self-labelled pairs the
    JAX bench distils its matcher from: 8 shifted pairs of 240×376 crops of
    the BA path's first left frames, random SuperPoint (seed 0) at bf16
    with K = 256 (K1 at (8, 240, 376), one launch per 8 crops); gated on
    the labels equal to the same bank built on the CPU by keypoint position
    on ≥ 95% of rows (bf16 score ties reorder rows), matched descriptors
    agreeing and two K1 launches; then K1 at the bank's shape against its
    plain version (gated, kernel line's tolerance) and timed beside it."""
    import torch

    from rspl_slam_tpu_torch.config import SuperPointConfig, SystemConfig
    from rspl_slam_tpu_torch.models import superpoint
    from rspl_slam_tpu_torch.ops import conv_stem_cuda as cs
    from rspl_slam_tpu_torch.training import superglue_train

    frames, _, _ = _scene(SystemConfig(), lines=True, n=4)
    images = [f[0] for f in frames]
    sp = superpoint.init_params(0)
    sp_cfg = SuperPointConfig(max_keypoints=256, keypoint_threshold=1e-4)
    kw = dict(n_pairs=BANK_PAIRS, K=256, crop_hw=(240, 376))
    _reset_counters()
    t0 = time.perf_counter()
    bank = superglue_train.make_shift_pair_bank(images, sp, sp_cfg,
                                                rng=np.random.default_rng(5), device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counters()
    ref = superglue_train.make_shift_pair_bank(images, sp, sp_cfg,
                                               rng=np.random.default_rng(5), device="cpu", **kw)
    same = rows = matched = 0
    sims = []
    for got, want in zip(bank, ref):
        xy0, sc0, d0, v0, xy1, sc1, d1, v1, gt0 = got
        m = (gt0 >= 0) & (gt0 < len(gt0))
        matched += int(m.sum())
        sims.extend(np.einsum("ij,ij->i", d0[m], d1[gt0[m]]).tolist())
        mine, theirs = _labels_by_position(got), _labels_by_position(want)
        same += sum(theirs.get(k) == v for k, v in mine.items())
        rows += len(gt0)
    crops = torch.as_tensor(np.stack([f[e][:240, :376] for f in frames for e in (0, 1)])).cuda()
    t = {k: torch.as_tensor(v).cuda() for k, v in (
        ("w1a", sp["conv1a"]["w"]), ("b1a", sp["conv1a"]["b"]),
        ("w1b", sp["conv1b"]["w"]), ("b1b", sp["conv1b"]["b"]))}
    k1_ok, k1_err = _stem_check(t["w1a"], t["b1a"], t["w1b"], t["b1b"], crops)
    with torch.no_grad():
        x = cs.conv1a(crops, t["w1a"], t["b1a"], torch.bfloat16)
        wk = cs.pack_weights(t["w1b"])
        k1_ms = time_ms(lambda: cs.conv3x3_relu_pool(x, wk, t["b1b"]))
        plain_ms = time_ms(lambda: cs.conv3x3_relu_pool_plain(x, t["w1b"], t["b1b"]), n=5)
    line = {"phase": "superglue_bank", "card": CARD, "pairs": BANK_PAIRS,
            "crop": [376, 240], "K": 256, "wall_s": wall, "rows": rows, "matched": matched,
            "labels_equal_cpu_share": same / rows,
            "matched_desc_cosine_mean": float(np.mean(sims)) if sims else None,
            "k1_input_shape": list(x.shape), "k1_ms": k1_ms, "k1_plain_ms": plain_ms,
            "k1_ok": k1_ok, "k1_max_abs_err": k1_err, "launches": launches}
    emit(line)
    if not (matched >= 20 and np.mean(sims) > 0.9):
        raise AssertionError(f"superglue_bank: {matched} matches, cosine {line}")
    if not same >= BANK_LABEL_SHARE * rows:
        raise AssertionError(f"superglue_bank: labels equal the CPU's on {same} of {rows} rows")
    if launches["conv_stem"] != 2 * BANK_PAIRS // 8:
        raise AssertionError(f"superglue_bank: K1 launched {launches['conv_stem']} times")
    if not k1_ok:
        raise AssertionError(f"superglue_bank: K1 at the bank's shape disagrees: {k1_err}")
    return line, launches


def phase_cli_pretrain():
    """``python -m rspl_slam_tpu_torch.cli pretrain --model M --steps 20``
    for the three models, in parallel subprocesses without PyYAML, PIL or
    matplotlib, otherwise the JAX CLI's defaults; gated on each exit and
    printed line, and on each ``.npz`` loading through
    ``models.weights.load_params`` and running one frame of its module on
    the card: SuperPoint ``extract`` of a 752×480 pair (K1), RCF
    ``edge_logits`` at 240×376 (the default width 0.25 has 16 stem
    channels, which K1 does not take, so the generic recipe), SuperGlue
    ``match_pair`` at bf16 on a K = 64 problem (K2, K3)."""
    import torch

    from rspl_slam_tpu_torch.config import SuperGlueConfig, SuperPointConfig, SystemConfig
    from rspl_slam_tpu_torch.models import rcf, superglue, superpoint
    from rspl_slam_tpu_torch.models.weights import (load_params, rcf_from_numpy,
                                                    superglue_from_numpy, superpoint_from_numpy)
    from rspl_slam_tpu_torch.training import superglue_train

    os.makedirs(WORK, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([_hidden_modules_dir(), ROOT])}
    out = {m: os.path.join(WORK, f"pretrain_{m}.npz") for m in ("superpoint", "rcf", "superglue")}
    t0 = time.perf_counter()
    procs = {m: subprocess.Popen([sys.executable, "-m", "rspl_slam_tpu_torch.cli", "pretrain",
                                  "--model", m, "--steps", str(PRETRAIN_STEPS), "--output", p],
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for m, p in out.items()}
    results = {m: p.communicate(timeout=600) + (p.returncode,) for m, p in procs.items()}
    wall = time.perf_counter() - t0
    for m, (stdout, stderr, rc) in results.items():
        if rc != 0 or f"trained {m} → {out[m]}" not in stdout:
            raise AssertionError(f"cli_pretrain {m} exited {rc}:\n{stdout[-3000:]}\n"
                                 f"{stderr[-3000:]}")
    _reset_counters()
    frames, _, _ = _scene(SystemConfig(), lines=True, n=1)  # the BA path's first pair
    pair = torch.as_tensor(np.stack(frames[0])).cuda()
    sp = superpoint_from_numpy(load_params(out["superpoint"], "superpoint"))
    f = superpoint.extract(sp, pair, SuperPointConfig())
    rp = load_params(out["rcf"], "rcf")
    half = torch.nn.functional.avg_pool2d(pair[:, None], 2)[:, 0]
    logits = rcf.edge_logits(rcf_from_numpy(rp), half, use_pallas_stem=False)
    cfg = SuperGlueConfig(image_width=320, image_height=240, num_gnn_layers=4,
                          sinkhorn_iterations=20)
    prob = superglue_train.make_batch(np.random.default_rng(7), 1, 64, cfg, "cuda")
    res = superglue.match_pair(superglue_from_numpy(load_params(out["superglue"], "superglue"),
                                                    cfg), *prob[:8], cfg,
                               compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    launches = _counters()
    line = {"phase": "cli_pretrain", "card": CARD, "steps": PRETRAIN_STEPS, "wall_s": wall,
            "last_loss_lines": {m: [ln for ln in r[0].splitlines() if ln.startswith("step")][-1:]
                                for m, r in results.items()},
            "keypoints": int(f.valid.sum()), "rcf_stem_channels": int(rp["conv1_1"]["w"].shape[3]),
            "rcf_logits_finite": bool(torch.isfinite(logits).all()),
            "matches": int((res.indices0 >= 0).sum()), "launches": launches}
    emit(line)
    if not (line["keypoints"] > 0 and line["rcf_logits_finite"]
            and bool(torch.isfinite(res.log_plan).all())):
        raise AssertionError(f"cli_pretrain: a trained model did not run: {line}")
    if not (launches["conv_stem"] == 1 and launches["superglue_layer"] == 4
            and launches["sinkhorn"] == 1):
        raise AssertionError(f"cli_pretrain: launches {launches}")
    return line, launches


def _descriptor_cosines(f) -> dict:
    """Median cosine of the left↔right mutual nearest neighbours of a
    stereo pair's descriptors, and of all left↔right pairs."""
    import torch

    d0, d1 = f.desc[0][f.valid[0]].float(), f.desc[1][f.valid[1]].float()
    cos = d0 @ d1.T
    best0, best1 = cos.argmax(1), cos.argmax(0)
    mutual = best1[best0] == torch.arange(len(d0), device=cos.device)
    return {"mutual_nn": float(cos.max(1).values[mutual].median()),
            "all_pairs": float(cos.median()), "mutual_count": int(mutual.sum())}


def phase_end_to_end_trained(sp_params, random_line):
    """The BA path's 30 frames with the SuperPoint ``train_superpoint``
    made, all else as ``end_to_end_ba`` (its matcher weights too: set for
    random SuperPoint's nearly parallel descriptors). Gated on finite poses
    only; measured: ATE, inliers, the share of keypoints at their cell's
    most common offset and the descriptors' cosines, beside the random
    weights' on the same frames."""
    import torch

    from rspl_slam_tpu_torch.models import superpoint
    from rspl_slam_tpu_torch.models.weights import superpoint_from_numpy

    line, counts, (cfg, fe, frames) = phase_end_to_end(lines=True, ba=True,
                                                       name="end_to_end_trained",
                                                       sp_params=sp_params)
    del fe
    pairs = torch.as_tensor(np.stack([np.stack(f) for f in frames[:5]])).cuda().flatten(0, 1)
    share, cosines = {}, {}
    for name, p in (("random", superpoint.init_params(0)), ("trained", sp_params)):
        f = superpoint.extract(superpoint_from_numpy(p), pairs, cfg.superpoint)
        share[name] = _grid_share(f.xy.cpu().numpy().reshape(-1, 2),
                                  f.valid.cpu().numpy().reshape(-1))
        cosines[name] = _descriptor_cosines(f)
    emit({"phase": "end_to_end_trained_vs_random", "card": CARD,
          "ate_rmse_m": {"random": random_line["ate_rmse_m"], "trained": line["ate_rmse_m"]},
          "initialized": {"random": random_line["initialized"],
                          "trained": line["initialized"]},
          "inliers_median": {"random": float(np.median(random_line["inliers"])),
                             "trained": float(np.median(line["inliers"]))},
          "keyframe_ate_rmse_m": {"random": random_line.get("keyframe_ate_rmse_m"),
                                  "trained": line.get("keyframe_ate_rmse_m")},
          "grid_share": share, "descriptor_cosine_frame0": cosines,
          "frames_for_grid_share": 10})
    return line, counts


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


def phase_training(by_path, ate_by_path, ba_line):
    """Phase 6: the trainers, ``pretrain`` and the trained SuperPoint on the
    BA path (``ba_line``: the random weights' run of it)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    _, by_path["train_superpoint"], sp_trained = phase_train_superpoint()
    _, by_path["train_rcf"] = phase_train_rcf()
    _, by_path["train_superglue"] = phase_train_superglue()
    _, by_path["superglue_bank"] = phase_superglue_bank()
    _, by_path["cli_pretrain"] = phase_cli_pretrain()
    gc.collect()
    torch.cuda.empty_cache()
    line, by_path["end_to_end_trained"] = phase_end_to_end_trained(sp_trained, ba_line)
    ate_by_path["end_to_end_trained"] = line["ate_rmse_m"]


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
    if "--training" in argv:
        ba_line, by_path["end_to_end_ba"], run = phase_end_to_end(lines=True, ba=True)
        ate_by_path["end_to_end_ba"] = ba_line["ate_rmse_m"]
        del run
        phase_training(by_path, ate_by_path, ba_line)
    elif "--kernels" not in argv:
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
            if name == "end_to_end_ba":
                ba_line = line
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
        line, by_path["end_to_end_loop"], frames, gt = phase_end_to_end_loop()
        ate_by_path["end_to_end_loop"] = line["keyframe_ate_after_global_m"]
        line, by_path["reloc"] = phase_reloc(frames, gt)
        del frames
        line, by_path["epipolar"] = phase_epipolar()
        ate_by_path["epipolar"] = line["ate_rmse_m"]
        gc.collect()
        torch.cuda.empty_cache()
        line, by_path["cli_run"], ctx = phase_cli_run()
        ate_by_path["cli_run"] = line["keyframe_ate_rmse_m"]
        _, by_path["cli_global"] = phase_cli_global(ctx)
        phase_cli_synth()
        phase_cli_convert()
        phase_training(by_path, ate_by_path, ba_line)
    shutil.rmtree(WORK, ignore_errors=True)
    phase_summary(lines, by_path, ate_by_path)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
