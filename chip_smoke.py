"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --profile  # every phase + a torch.profiler breakdown
                                     # of the lines path and launches per BA window
    python3 chip_smoke.py --kernels  # device, build, kernel phases, summary
    python3 chip_smoke.py --training # device, build, kernels, end_to_end_ba,
                                     # the training phases (6 below), summary
    python3 chip_smoke.py --parallel # device, build, kernels, end_to_end_loop
                                     # (dist_ba's map), the parallel/ phases
                                     # (4b below), summary
    python3 chip_smoke.py --native   # device, build, kernels, end_to_end_lines,
                                     # merge_ab, cli_run, native, image_kinds,
                                     # cli_photo, summary
    python3 chip_smoke.py --unequal  # device, build, kernels, unequal (4c
                                     # below), summary
    python3 chip_smoke.py --configs  # device, build, kernels, configs and
                                     # large_k (4d below), summary

Phases (one JSON line each):
  1. the card's name and power limit; build every library from
     rspl_slam_tpu_torch/csrc/, the kernels with nvcc and the native
     runtime with the host compiler (one process per source, in parallel)
     and report the build times;
  2. per kernel, at the main path's shapes: the kernel against its plain
     PyTorch version on the same inputs (tolerance in the line), and CUDA
     event timings of the kernel, the plain version and, where one PyTorch
     call computes the same function, that call (a yardstick only); K1 also
     in its side-output mode, K2 in its bf16 (main path) and f32 modes (the
     f32 mode: 3xTF32 on the tensor cores, K and V streamed in 64-key
     chunks, two launches; also at ragged K = 48 and 301; its line gives
     both bounds, f32 FMA and 3xTF32 at the TF32 peak, the design's tiles
     and shared bytes, a second run's bits, and the HMMA.1688.F32.TF32
     instructions ``cuobjdump -sass`` finds in each of its two kernels,
     gated on both holding some), and K2's two-set variant (SuperGlue with M != N: 400 keypoints over 300
     and 300 over 400) in both modes; K3 also on the rectangular plans
     (401, 301) and (301, 401); past the resident kernels' ceilings, K2's
     streamed bf16 kernel (sources past 752 keys: K and V through a ring
     of two 128-key chunks in two passes, the logits and probabilities in
     registers, two CTAs per SM) at K = 1024 (timed), 768, ragged 1100,
     2048 and 4096, both bf16 kernels at 400 and 752 (each timed beside
     the other), the two-set variant with a source past the ceiling and
     the f32 mode at 1024, 2048, 3309 (past its old ceiling) and 4096, each
     timed beside both bounds and run twice, equal bit for bit; K3's
     global-memory kernel (plans no
     cluster holds: one cooperative launch of persistent clusters of 8,
     each CTA a band of Z0 in shared memory, one grid barrier and two
     cluster barriers per iteration; the line gives its plan and the bytes
     exchanged per iteration) at (1, 1025, 1025) (timed), 921, 2049,
     (1025, 1201), (4, 1025, 1025) and 4097 (part of each band in device
     memory), every plan run twice and equal bit for bit, and both K3
     kernels at 601;
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
  4b. ``parallel/``: ``kernels_at_batch_n`` (every mode but --kernels,
     after the kernel checks) holds each kernel against its plain version
     at the multi-sequence path's batch N = 4: K1 over the 2N images of a
     step (8, 480, 752, 64), K2 bf16 on N stacked stereo problems (8, 400,
     256), K3 at (4, 401, 401); ``multi_sequence``, ``MultiSequenceSLAM``
     over 4 rendered sequences (scene seeds 1-4, yaw rates 0.002·(s + 1),
     24 uint8 frames each) at the main path's widths with lines and
     batched BA, gated on the batched features against serial
     ``extract_pair`` at step 0 (keypoints paired by position: ≥ 99% found,
     scores within 1e-3, stereo flags and uR within 1e-3 px on ≥ 95%;
     cuDNN rounds some of SuperPoint's convolutions differently at batch 8
     than at 2, so near-tied keypoints change rank: each stage fed one
     input at both batch sizes, K1's outputs must be equal bit for bit,
     every stage's difference on the line), one K1 launch over
     the 2N images and N side-mode launches per batched extraction, K2 and
     K3 launches per batched match equal to one single match's, every
     sequence's initialization, inliers and ATE (< 0.35 m), and a batched
     BA solve of ≥ 2 windows; ``batched_ba``, the sequences' last windows
     solved batched and one by one (the first LM step's system in f64
     within 1e-9 relative; positions within 1e-4 m in f32 on every window
     that a 1e-7 nudge moves less than that, and in f64 on every window;
     inlier flags equal on ≥ 99%; ms and launches of both); ``dist_ba``,
     2 ranks of this script (``--dist-ba-rank``) on the one card over gloo running
     the landmark-sharded solve and ``run_global_ba(mesh=)`` on the loop
     path's map (63 keyframes, saved by ``end_to_end_loop`` before its
     closing passes) and the sharded solve on the first sequence's map,
     against the single-process solve: results on the card; the small
     map's Tcw within 1e-3, points 1e-2; on the loop map the first step's
     summed system in f64 within 1e-9 relative, runs and ranks bit for
     bit, floats per LM step = ``expected_collective_floats``, the robust
     objective falling, ``run_global_ba(mesh=)`` equal to the sharded
     solve (the full schedule's distance from the single solve measured
     beside the single solve's own spread: f32 rounding on that map is of
     the order of S's entries);
  4c. ``unequal`` (after ``end_to_end_lazy``): SuperPoint's pixel-space
     path (``extract`` at ``nms_radius`` 2 and 10, K1 on the pair) and
     ``match_pair`` with M != N at ``SuperGlueConfig()`` (K2's two-set
     variant and K3 on the (M+1, N+1) plan), gated as ``phase_unequal``
     says;
  4d. ``configs`` (after ``unequal``): the four other shipped
     configurations (``CONFIGS``: OIVIO radtan 1280×720 K = 600, UMA
     fisheye 1024×768 K = 500, RealSense 848×480 K = 500, ZED2i 960×540 K =
     300), each from its own file (``load_system_config``), the default
     ``SLAMSystem(cfg, fe)`` (lines, async BA) at bf16 on 30 frames of
     ``config_scene`` (the lines scene shrunk into the camera's depth and
     baseline range) taken through the camera's own distortion and
     rectification (``raw_frames``, 8 bits), gated on the card's rectified
     frames equal to the CPU's ``remap_bilinear`` (1e-6), initialization,
     > 20 inliers on ≥ 80% of frames, finite poses, the ATE under 1.6× the
     JAX package's at half size (``CONFIG_JAX_ATE``), one K1 launch in
     each mode per frame, lines and maplines, and each kernel against its
     plain version at the configuration's shapes (timed beside its bound);
     OIVIO also through ``cli run --config configs/oivio.yaml`` on a PNG
     tree of its raw frames, native and ``--no-native``, the two routes'
     trajectories within ``NATIVE_ROUTE_POS_TOL``; ``large_k``:
     ``extract`` at ``max_keypoints`` 1024 and 2048 and ``match_pair`` with
     ``SuperGlueConfig()`` on the pair, gated on 18 streamed K2 launches and
     one global-memory K3 launch per match, a finite log plan, each layer
     nearer its plain version than plain bf16 is to plain f32, K3 within
     1e-3;
  5. the command line, as a user types it, in a subprocess that cannot
     import PyYAML, PIL or matplotlib (stub packages that raise on import
     come first on its path, as on a card machine without them):
     ``cli_run``, ``python -m rspl_slam_tpu_torch.cli run --config
     configs/euroc.yaml`` (the default main path: lines, async BA) on the
     BA path's 30 frames quantized to 8 bits and written as a raw-EuRoC
     PNG tree, with the smoke's weights as ``.npz`` and an OpenCV-layout
     camera file (identity R, zero D: the remap runs), by default (the
     native prefetcher decodes and rectifies on C++ threads) and with
     ``--no-native`` (``EurocDataset``, the remap on the card); gated on
     each exit, 30 frames, the ATE, each route's trajectory file and
     launch counts equal to an in-process run of the same route
     (``NativeStereoLoader`` feeding ``PipelinedRunner``; the runner over
     the dataset), the two routes within ``NATIVE_ROUTE_POS_TOL``, the
     decoded frames equal to the written ones, the map reloading and
     ``resume_from_map`` tracking 5 more frames and the visualization PNGs
     decoding; ``native``, the native runtime: its host build time, decode
     ms per pair of the loader (2 threads) against ``EurocDataset`` on that
     tree (frames equal), ``merge_lines`` ms per frame compiled against
     numpy on the lines path's own pre-merge segments (equal shapes,
     within 1e-9), and ``real_photo.jpg`` decoded to the pinned
     ``REAL_PHOTO_L_SHA256``; ``image_kinds``, every JPEG, netpbm, PFM,
     TIFF, BMP, DIB, GIF, WebP, QOI, Sun raster, PCX, SGI, TGA, ICO, CUR,
     DDS, PSD, DCX, BLP, FTEX, ICNS, MSP, XBM, XPM, IM, IMT, IPTC, SPIDER,
     GBR, McIDAS, PIXAR, XVThumb, FITS, FLI and PCD kind the JAX package
     reads through PIL: the
     committed fixtures of ``tests/fixtures/image_kinds`` (and three seeded
     PhotoCD files) on three decode
     routes against PIL's pinned hashes (the kinds PIL refuses, and those
     the port does not read yet, raising ``NotImplementedError``; a lossy
     752×480 WebP pair among them), ``cli_run``'s tree as 16-bit P5,
     16-bit LZW TIFF, gray GIF, RLE TGA and BRUN FLC (native route) and as
     plain P2, 8-bit BMP, VP8L WebP, RLE SGI and PackBits PSD
     (``--no-native``),
     trajectories and launches equal to
     its PNG runs, and a committed 752×480 progressive stereo sequence
     through ``cli run`` and ``cli serve``, equal to PNG copies of its
     pixels, with K1 (both modes), K2 and K3 launched; decode ms per pair
     of each kind;
     ``cli_photo``, the JAX CLI's real-photo case
     (10 stereo crops of the photograph, cosine matcher, no lines) through
     ``cli run`` here, gated as JAX gates it (n ≥ 3, rmse < 0.3 m);
     ``cli_global``, ``run
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
     ...}. K2's two-set variant takes its launches from ``unequal``,
     K2's streamed kernel and K3's global-memory kernel from ``large_k``.
     With --kernels, phases 3-6 are skipped and the summary's launch
     counts are null; --unequal runs ``unequal`` alone; --training runs
     ``end_to_end_ba`` and phase 6 alone; --configs runs 4d alone (the
     summary's launches: ``configs``' and ``large_k``'s); --parallel runs ``end_to_end_loop`` and phase 4b (the summary's
     launches are then ``multi_sequence``'s); --native runs
     ``end_to_end_lines``, ``merge_ab`` (the lines path with the numpy
     merge in place of the compiled one, in turns) and ``cli_run``,
     ``native``, ``image_kinds`` and ``cli_photo`` (launch counts null in
     the summary).

Scheduling (the default run, which must end well inside 20 minutes): each
phase line carries ``t_s``, seconds since the script started. After the
kernel checks, a pool of ``PRERENDER_WORKERS`` spawned processes renders
the seeded frames of the later phases (the BA scene, rendered once for
all its paths, the configurations' raw pairs, the loop sequence, the
multi-sequence runs) while the card runs the earlier ones. A CLI phase
starts its processes (``_cli_start``) and runs its in-process half beside
them: ``cli_run``'s three at once, OIVIO's two beside the other three
configurations, ``cli_global``'s beside its own in-process run, and
``cli_photo``, ``cli_synth`` and ``pretrain``, which need nothing of the
phases before them, from ``end_to_end_loop`` on; each is gated in its own
place (``_cli_wait``), and every process still running is killed on the
way out. Wall times of the paths that run beside such processes share the
host with them; the kernel lines are measured before any starts.

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
PEAK_TF32 = 495e12  # dense TF32 tensor cores: K2's f32 mode runs 3 TF32 products per product
PEAK_BYTES = 3.35e12
PEAK_SFU = 132 * 16 * 1.98e9
SM_SMEM_BYTES = 233_472  # shared memory of one H100 SM (228 KB)
CTA_RESERVED_SMEM = 1024  # shared memory the runtime reserves per CTA

# end-to-end gates (see PERF.md for where the ATE bound comes from: the JAX
# package's ATE on each path's scene at 376×240 on the CPU, with margin:
# points 0.2229 m, lines scene 0.2123 m, lines scene with BA 0.2123 m,
# the lazy production loop 0.2046 m)
E2E_FRAMES = 30
E2E_MIN_INLIERS = 20
E2E_ATE_BOUND = 0.35
E2E_ATE_BOUND_LAZY = 0.35

# sha256 of tests/fixtures/real_photo.jpg's 8-bit luma as PIL's
# Image.open(p).convert("L") gives it, (600, 512) uint8: the card's machine
# has no PIL, so the port's decode there is held to this pinned hash
# (tests/test_torch_native.py pins the same value and checks it against PIL)
REAL_PHOTO_L_SHA256 = "d6dc0d4bd9642ce0a87f5d9bcc25d30a934174aaadcec069e026a87da6604a10"
PHOTO = os.path.join(ROOT, "tests", "fixtures", "real_photo.jpg")


CARD = None  # the nvidia-smi name and power limit, which the training phases repeat
T0 = time.perf_counter()  # the script's start: each phase line's ``t_s`` counts from it


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
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
    emit({"phase": "build", "build_s": res["build_s"],
          "build_seconds": dict(cuda_build.build_seconds), "ptxas": ptxas})


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


def _layer_case(ac, gen, layer, K, valid, compute_dtype, rtol, atol, n2: int = 2):
    """K2 against its plain version at (n2, K, 256) (n2 / 2 stacked
    problems), self and cross, with ``valid`` keys in each problem's second
    set: (ok, [max error self, cross], x, masks, scratch)."""
    import torch

    dev = "cuda"
    x = torch.randn((n2, K, 256), generator=gen, device=dev)
    masks = torch.arange(K, device=dev)[None] < torch.tensor([[K], [valid]] * (n2 // 2),
                                                             device=dev)
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


def _layer_bound(ac, layer, x, compute_dtype):
    """(flops, bytes, bound ms, bound by) of one K2 layer on x (n2, K, C)."""
    import torch

    n2, K, C = x.shape
    n = n2 * K
    flops = 2.0 * n * (C * 3 * C + K * C + K * C + C * C + 2 * C * 2 * C + 2 * C * C)
    # x in and out, the mask, and once each layer tensor this mode's kernels read
    nbytes = 4.0 * (2 * x.numel() + n) + sum(
        layer[k].numel() * layer[k].element_size() for k in ac.LAYER_KEYS[compute_dtype])
    peak = PEAK_BF16 if compute_dtype == torch.bfloat16 else PEAK_F32
    return (flops, nbytes) + bound_ms(flops, nbytes, peak)


def _tf32_bound_ms(flops, nbytes):
    """The f32 mode's bound on the unit its design uses: three TF32
    products per product (3xTF32) at the dense TF32 peak, or the bytes."""
    return bound_ms(3.0 * flops, nbytes, PEAK_TF32)[0]


def _f32_design(ac):
    """The f32 layer kernel's tiles and shared memory (one size for any K)."""
    smem = ac.f32_smem_bytes()
    return {"products": "3xTF32: mma.sync.m16n8k8 tf32 (lo hi + hi lo + hi hi, f32 sums)",
            "launches_per_layer": 2, "qkv_tile": [ac.ROWS, 128],
            "query_rows_per_cluster": ac.ROWS, "keys_per_chunk": ac.F32_CHUNK,
            "ring_stages": ac.F32_STAGES, "key_groups": ac.KEY_GROUPS,
            "keys_per_warp_and_chunk": ac.F32_CHUNK // ac.KEY_GROUPS, "smem_bytes": smem,
            "ctas_per_sm_by_smem": SM_SMEM_BYTES // (smem + CTA_RESERVED_SMEM),
            "passes": "max and sum, then P V (K read twice, V once)"}


def _tf32_sass():
    """HMMA.1688.F32.TF32 instructions in each f32 kernel of the built K2
    library, as ``cuobjdump -sass`` lists them."""
    from rspl_slam_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(cuda_build._target("superglue_layer"))],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function : " in ln:
            fn = next((k for k in ("qkv_f32_kernel", "layer_f32_kernel") if k in ln), None)
        elif fn and "HMMA.1688.F32.TF32" in ln:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def check_superglue_layer(bf16: bool):
    """K2 in its bf16 or f32 mode at the main path's (2, 400, 256), timed;
    both modes also at ragged K = 48 and 301, the bf16 mode at OIVIO's 600
    (listed in ``checks``). The f32 line adds the 3xTF32 bound, the
    design, a second run's bits and the SASS's TF32 MMAs per kernel."""
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
        rtol, atol = K2_F32_TOL
        tol = K2_F32_TOL_TEXT
    ok, errs, x, masks, scratch = _layer_case(ac, gen, layer, K, 331, compute_dtype, rtol, atol)
    checks = []
    for k, valid in ((48, 40), (301, 250)) + (((600, 577),) if bf16 else ()):
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
    flops, nbytes, bms, by = _layer_bound(ac, layer, x, compute_dtype)
    line = {"phase": "kernel", "name": "superglue_layer" if bf16 else "superglue_layer_f32",
            "compute_dtype": str(compute_dtype).replace("torch.", ""),
            "shape": [n2, K, C], "valid": [K, 331],
            "ok": ok, "max_abs_err": max(errs), "max_abs_err_self_cross": errs,
            "tolerance": tol, "checks": checks,
            "ms": kernel_ms, "host_ms": wrapper_host_ms, "plain_ms": plain_ms,
            "library_ms": None,
            "library": "none: no single PyTorch call computes a whole GNN layer",
            "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes}
    if not bf16:
        first = kernel()
        line.update({"bound_3xtf32_ms": _tf32_bound_ms(flops, nbytes),
                     "repeats_bit_for_bit": bool(torch.equal(kernel(), first)),
                     "design": _f32_design(ac), "sass_hmma_1688_f32_tf32": _tf32_sass()})
        sass = line["sass_hmma_1688_f32_tf32"]
        ok &= line["repeats_bit_for_bit"] and all(
            sass.get(k, 0) > 0 for k in ("qkv_f32_kernel", "layer_f32_kernel"))
        line["ok"] = ok
    line.update(rates(line))
    emit(line)
    if not ok:
        raise AssertionError(f"{line['name']} disagrees: {errs}, {checks}, "
                             f"{line.get('sass_hmma_1688_f32_tf32')}")
    return line


def _sinkhorn_case(gen, M, N, valid0, valid1, matcher: bool, iters: int = 100,
                   plain_n: int = 5, B: int = 1, route: str | None = None,
                   emit_line: bool = True):
    """K3 against the plain sweeps on B (M+1, N+1) problems: random scores
    ×3 with dustbin 1.0, or (B = 1) the matcher's own scale (2000·cos of
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
        scores, bin_score = torch.randn((B, M, N), generator=gen, device=dev) * 3.0, 1.0
    m0 = (torch.arange(M, device=dev)[None] < valid0).expand(B, M)
    m1 = (torch.arange(N, device=dev)[None] < valid1).expand(B, N)
    Z0, mu, nu, norm = sk.build_problem(scores, m0, m1, bin_score)
    run = {None: skc.sinkhorn_iterations, "cluster": skc._launch_cluster,
           "global": skc._launch_global}[route]
    got = run(Z0, mu, nu, iters) - norm[:, None, None]
    again = run(Z0, mu, nu, iters) - norm[:, None, None]
    ref = sk.sinkhorn_iterations_plain(Z0, mu, nu, iters) - norm[:, None, None]
    torch.cuda.synchronize()
    one = torch.ones((B, 1), dtype=torch.bool, device=dev)
    sel = torch.cat([m0, one], 1)[:, :, None] & torch.cat([m1, one], 1)[:, None, :]
    ok, err = _allclose_report("sinkhorn", got, ref, 0.0, 1e-3, sel)
    kernel_ms = time_ms(lambda: run(Z0, mu, nu, iters))
    plain_ms = time_ms(lambda: sk.sinkhorn_iterations_plain(Z0, mu, nu, iters), n=plain_n,
                       warmup=1)
    elems = B * (M + 1) * (N + 1)
    sweeps = 2 * iters * elems  # one exponential per element per sweep
    flops = 4.0 * sweeps
    nbytes = 4.0 * (2 * elems + B * ((M + 1) + (N + 1)))
    bms, by = bound_ms(flops, nbytes, PEAK_F32, sfu_ops=sweeps)
    route = route or skc.sinkhorn_route(M + 1, N + 1)
    plan = skc.cluster_plan(M + 1, N + 1) if route == "cluster" else None
    line = {"phase": "kernel", "name": "sinkhorn", "shape": [B, M + 1, N + 1],
            "iters": iters, "scores": "matcher 2000*cos, bin 1980" if matcher
            else "randn*3, bin 1", "valid": [valid0, valid1],
            "cluster_plan": plan and plan._asdict(), "ok": ok, "max_abs_err": err,
            "repeats_bit_for_bit": bool(torch.equal(got, again)),
            "tolerance": "max |k-p| < 1e-3 on valid rows, columns and dustbins",
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call runs Sinkhorn",
            "bound_ms": bms, "bound_by": by, "flops": flops, "bytes": nbytes,
            "elements": float(sweeps)}
    line.update(rates(line))
    if not emit_line:
        return line
    emit(line)
    if not ok:
        raise AssertionError(f"sinkhorn disagrees at {line['shape']} "
                             f"({line['scores']}): {err}")
    return line


def check_sinkhorn():
    """K3 at the main path's shape (the timed line), and at OIVIO's K = 600,
    the matcher's score scale and the rectangular plans of M != N, 400 × 300
    and 300 × 400 (checks listed in the summary)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    line = _sinkhorn_case(gen, 400, 400, 371, 352, matcher=False)
    line["checks"] = [
        {k: c[k] for k in ("shape", "scores", "valid", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_fraction")}
        for c in (_sinkhorn_case(gen, 600, 600, 577, 541, matcher=False, plain_n=2),
                  _sinkhorn_case(gen, 400, 400, 200, 337, matcher=True, plain_n=2),
                  # SuperGlue with M != N: the rectangular (M+1, N+1) plans
                  _sinkhorn_case(gen, 400, 300, 371, 262, matcher=False, plain_n=2),
                  _sinkhorn_case(gen, 300, 400, 262, 371, matcher=False, plain_n=2))]
    return line


def _two_set_bound(ac, layer, B, M, N, compute_dtype):
    """(flops, bytes, bound ms, bound by) of one two-set K2 layer: B sets of
    M queries over sources of N (x and the source in, the output out, the
    source mask, each layer tensor of the mode once)."""
    import torch

    C = 256
    flops = 2.0 * B * (M * C * C + N * C * 2 * C + 2 * M * N * C + M * C * C
                       + M * 2 * C * 2 * C + M * 2 * C * C)
    nbytes = 4.0 * (2 * B * M * C + B * N * C + B * N) + sum(
        layer[k].numel() * layer[k].element_size() for k in ac.LAYER_KEYS[compute_dtype])
    peak = PEAK_BF16 if compute_dtype == torch.bfloat16 else PEAK_F32
    return (flops, nbytes) + bound_ms(flops, nbytes, peak)


def check_superglue_layer_two_set(bf16: bool):
    """K2's two-set variant (a query set over a source set of another
    length: SuperGlue's path for M != N) in its bf16 or f32 mode against
    its plain version, each set over the other (the source partly masked)
    and over itself: 400 keypoints over 300 (the line) and 300 over 400
    (in ``checks``), both timed over the other set; the bf16 mode also at a
    ragged 24 over 17."""
    import torch

    from rspl_slam_tpu_torch.ops import attention_cuda as ac

    dev = "cuda"
    dt = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device=dev).manual_seed(12)
    layer = ac.pack_layer(_random_layer(gen, 256, dev), dev)
    if bf16:
        rtol, atol = K2_BF16_TOL
        tol = "|k-p| <= 2^-8|p| + 4e-3 (bf16 operands; another f32 summation order)"
    else:
        rtol, atol = K2_F32_TOL
        tol = K2_F32_TOL_TEXT

    def case(M, N, timed=True):
        x = torch.randn((1, M, 256), generator=gen, device=dev)
        src = torch.randn((1, N, 256), generator=gen, device=dev)
        m_src = torch.arange(N, device=dev)[None] < N - N // 5
        m_x = torch.arange(M, device=dev)[None] < M - M // 7
        errs, ok = [], True
        for s, m in ((src, m_src), (x, m_x)):
            got = ac.superglue_layer_two_set(x, s, m, layer, compute_dtype=dt)
            ref = ac.superglue_layer_two_set_plain(x, s, m, layer, compute_dtype=dt)
            torch.cuda.synchronize()
            o, e = _allclose_report("superglue_layer_two_set", got, ref, rtol, atol)
            ok &= o
            errs.append(e)
        out = {"shape": [1, M, N], "valid_source": N - N // 5, "ok": ok,
               "max_abs_err": max(errs), "max_abs_err_other_self": errs}
        if timed:
            scratch = (ac.layer_scratch(x, None, dt), ac.layer_scratch(src, m_src, dt))
            flops, nbytes, bms, by = _two_set_bound(ac, layer, 1, M, N, dt)
            out.update({
                "ms": time_ms(lambda: ac.superglue_layer_two_set(
                    x, src, m_src, layer, compute_dtype=dt, scratch=scratch)),
                "host_ms": host_ms(lambda: ac.superglue_layer_two_set(
                    x, src, m_src, layer, compute_dtype=dt, scratch=scratch)),
                "plain_ms": time_ms(lambda: ac.superglue_layer_two_set_plain(
                    x, src, m_src, layer, compute_dtype=dt)),
                "library_ms": None, "bound_ms": bms, "bound_by": by, "flops": flops,
                "bytes": nbytes})
            if not bf16:
                out["bound_3xtf32_ms"] = _tf32_bound_ms(flops, nbytes)
            out.update(rates(out))
        return out

    main = case(400, 300)
    checks = [case(300, 400)] + ([case(24, 17, timed=False)] if bf16 else [])
    ok = main["ok"] and all(c["ok"] for c in checks)
    line = {"phase": "kernel",
            "name": "superglue_layer_two_set" if bf16 else "superglue_layer_two_set_f32",
            "compute_dtype": str(dt).replace("torch.", ""), **main, "ok": ok,
            "tolerance": tol, "checks": checks,
            "library": "none: no single PyTorch call computes a whole GNN layer"}
    emit(line)
    if not ok:
        raise AssertionError(f"{line['name']} disagrees: {main}, {checks}")
    return line


LARGE_K = (768, 1024, 1100, 2048, 4096)  # sources past K2's resident kernel (752)
LARGE_K_F32 = (1024, 2048, 3309, 4096)  # the f32 mode past 752, and past its old 3308


def check_superglue_layer_streamed():
    """K2's streamed bf16 kernel (sources past MAX_K_BF16 = 752: K and V
    through a ring of chunks, two passes, logits and probabilities in
    registers) against its plain version at K = 1024 (the timed line) and
    768, ragged 1100, 2048 and 4096 (``checks``, each timed beside its
    bound), self and cross; at K = 400 and 752, where both bf16 kernels
    apply, each against the plain version and timed (``checks``: the
    streamed kernel beside the resident one, a finding for the route's
    threshold); the two-set variant with a source past the ceiling (800
    over 1024, 1024 over 800: the second's source is resident, its line's
    route says so); and the f32 mode, which streams at every K, at K =
    1024, 2048, 3309 (past its old ceiling) and 4096 (``f32_checks``, each
    timed beside its f32 FMA and 3xTF32 bounds and run twice, equal bit for
    bit). The line gives the design's tiles: query rows per CTA, keys per
    chunk, ring stages, key groups (warps per query tile), shared bytes and
    CTAs per SM."""
    import torch

    from rspl_slam_tpu_torch.ops import attention_cuda as ac

    dev, bf16, f32 = "cuda", torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(13)
    layer = ac.pack_layer(_random_layer(gen, 256, dev), dev)
    rtol, atol = K2_BF16_TOL

    def layer_fn(route):  # the wrapper, or one bf16 attention kernel by name
        if route is None:
            return ac.superglue_layer
        return lambda x, masks, layer, cross, compute_dtype, scratch=None: ac._launch_layer(
            x, masks, layer, cross, 4, compute_dtype, scratch, route == "streamed")

    def stacked(K, route=None, dt=bf16, tol=(rtol, atol)):
        run = layer_fn(route)
        x = torch.randn((2, K, 256), generator=gen, device=dev)
        masks = torch.arange(K, device=dev)[None] < torch.tensor([[K], [K - K // 6]],
                                                                 device=dev)
        errs, ok = [], True
        for cross in (False, True):
            got = run(x, masks, layer, cross, compute_dtype=dt)
            ref = ac.superglue_layer_plain(x, masks, layer, cross, compute_dtype=dt)
            torch.cuda.synchronize()
            o, e = _allclose_report("superglue_layer_streamed", got, ref, *tol)
            ok &= o
            errs.append(e)
        out = {"shape": [2, K, 256], "route": route or ac.bf16_route(K) if dt == bf16
               else "f32", "ok": ok, "max_abs_err": max(errs), "max_abs_err_self_cross": errs}
        if dt == bf16:  # the kernel's time at this K beside its bound
            sc = ac.layer_scratch(x, masks, bf16)
            out["ms"] = time_ms(lambda: run(x, masks, layer, True, compute_dtype=bf16,
                                            scratch=sc))
            out["bound_ms"] = _layer_bound(ac, layer, x, bf16)[2]
        return out, x, masks

    main, x, masks = stacked(1024)
    scratch = ac.layer_scratch(x, masks, bf16)

    def kernel():
        return ac.superglue_layer(x, masks, layer, True, compute_dtype=bf16, scratch=scratch)

    flops, nbytes, bms, by = _layer_bound(ac, layer, x, bf16)
    main.update({"ms": time_ms(kernel), "host_ms": host_ms(kernel),
                 "plain_ms": time_ms(lambda: ac.superglue_layer_plain(
                     x, masks, layer, True, compute_dtype=bf16)),
                 "library_ms": None, "bound_ms": bms, "bound_by": by, "flops": flops,
                 "bytes": nbytes})
    main.update(rates(main))
    checks = [stacked(k)[0] for k in LARGE_K if k != 1024]
    checks += [stacked(k, route)[0] for k in (400, 752) for route in ("resident", "streamed")]
    for M, N in ((800, 1024), (1024, 800)):
        xq = torch.randn((1, M, 256), generator=gen, device=dev)
        src = torch.randn((1, N, 256), generator=gen, device=dev)
        m_src = torch.arange(N, device=dev)[None] < N - N // 5
        got = ac.superglue_layer_two_set(xq, src, m_src, layer, compute_dtype=bf16)
        ref = ac.superglue_layer_two_set_plain(xq, src, m_src, layer, compute_dtype=bf16)
        torch.cuda.synchronize()
        o, e = _allclose_report("superglue_layer_two_set", got, ref, rtol, atol)
        checks.append({"shape": [1, M, N], "route": ac.bf16_route(N), "two_set": True,
                       "ok": o, "max_abs_err": e})
    f32_checks = []
    for K in LARGE_K_F32:
        c, xf, mf = stacked(K, dt=f32, tol=K2_F32_TOL)
        flops_f, nbytes_f, bms_f, by_f = _layer_bound(ac, layer, xf, f32)
        sf = ac.layer_scratch(xf, mf, f32)

        def run_f32():
            return ac.superglue_layer(xf, mf, layer, True, compute_dtype=f32, scratch=sf)

        first = run_f32()
        c.update({"ms": time_ms(run_f32, n=5), "bound_ms": bms_f, "bound_by": by_f,
                  "bound_3xtf32_ms": _tf32_bound_ms(flops_f, nbytes_f),
                  "repeats_bit_for_bit": bool(torch.equal(run_f32(), first))})
        c["ok"] &= c["repeats_bit_for_bit"]
        f32_checks.append(c)
    ok = main["ok"] and all(c["ok"] for c in checks + f32_checks)
    line = {"phase": "kernel", "name": "superglue_layer_streamed", "compute_dtype": "bfloat16",
            **main, "ok": ok,
            "tolerance": "|k-p| <= 2^-8|p| + 4e-3 (bf16 operands; another f32 summation "
                         "order); f32 mode " + K2_F32_TOL_TEXT,
            "max_k_bf16_resident": ac.MAX_K_BF16,
            "streamed_smem_bytes": ac.bf16_streamed_smem_bytes(),
            "streamed_design": {
                "query_rows_per_cta": ac.ROWS, "keys_per_chunk": ac.CHUNK,
                "ring_stages": ac.STAGES, "key_groups": ac.KEY_GROUPS,
                "keys_per_warp_and_chunk": ac.CHUNK // ac.KEY_GROUPS,
                "ctas_per_sm_by_smem": SM_SMEM_BYTES // (ac.bf16_streamed_smem_bytes()
                                                         + CTA_RESERVED_SMEM),
                "passes": "max and sum, then P V (K read twice, V once)"},
            "checks": checks, "f32_checks": f32_checks,
            "library": "none: no single PyTorch call computes a whole GNN layer"}
    emit(line)
    if not ok:
        raise AssertionError(f"superglue_layer_streamed disagrees: {main}, {checks}, "
                             f"{f32_checks}")
    return line


def _global_exchange(skc, B, M1, N1):
    """The global K3 kernel's plan for B (M1, N1) problems on this card and
    what it exchanges per iteration: the grid-level and cluster barriers,
    the bytes written and read through device memory (each cluster's
    partial of (max, sum) per column, read by every cluster of its group)
    and through distributed shared memory (each CTA reads its cluster's 8
    band partials for its column slice and writes its slice of v into the
    8 CTAs), summed over the groups."""
    plan = skc.grid_plan(B, M1, N1, skc.global_clusters("cuda"))
    cpg, C = plan.clusters_per_group, skc.GLOBAL_CLUSTER
    return {"clusters_on_card": skc.global_clusters("cuda"), "grid_plan": plan._asdict(),
            "ctas": plan.groups * cpg * C, "grid_barriers_per_iteration": 1,
            "cluster_barriers_per_iteration": 2,
            "device_bytes_written_per_iteration": plan.groups * cpg * 2 * N1 * 4,
            "device_bytes_read_per_iteration": plan.groups * cpg * cpg * 2 * N1 * 4,
            "dsmem_bytes_per_iteration": plan.groups * cpg * C * 3 * N1 * 4,
            "rows_in_device_memory": plan.rows - plan.resident}


def check_sinkhorn_global():
    """K3's global-memory kernel (plans no cluster holds) against the plain
    sweeps at K = 1024, (1, 1025, 1025) (the timed line), and at 920 (the
    first square plan past a cluster of 16), 2048, the rectangular (1,
    1025, 1201), B = 4 at 1025² and 4097² (past shared memory: part of each
    band stays in device memory) (``checks``), all of them past every
    cluster, each run twice and equal bit for bit; and at OIVIO's (1, 601,
    601), which the cluster kernel takes, both kernels on one plan. Each
    global line gives its plan and exchange (:func:`_global_exchange`)."""
    import torch

    from rspl_slam_tpu_torch.ops import sinkhorn as sk
    from rspl_slam_tpu_torch.ops import sinkhorn_cuda as skc

    gen = torch.Generator(device="cuda").manual_seed(14)

    def case(M, N, plain_n=2, route=None, B=1):
        line = _sinkhorn_case(gen, M, N, M - M // 11, N - N // 13, matcher=False,
                              plain_n=plain_n, route=route or "global", emit_line=False, B=B)
        line["route"] = route or skc.sinkhorn_route(M + 1, N + 1)
        if line["route"] == "global":
            line.update(_global_exchange(skc, B, M + 1, N + 1))
            line["ok"] = line["ok"] and line["repeats_bit_for_bit"]
        return line

    line = case(1024, 1024, plain_n=3)
    keys = ("shape", "route", "valid", "ok", "max_abs_err", "repeats_bit_for_bit", "ms",
            "plain_ms", "bound_ms", "bound_fraction", "grid_plan",
            "device_bytes_read_per_iteration", "rows_in_device_memory")
    checks = [case(920, 920), case(2048, 2048, plain_n=1), case(1024, 1200),
              case(1024, 1024, plain_n=1, B=4), case(4096, 4096, plain_n=1),
              case(600, 600, route="global"), case(600, 600, route="cluster")]
    for c in checks[:5]:
        if c["route"] != "global":
            raise AssertionError(f"sinkhorn {c['shape']}: expected the global route")
    line.update({"name": "sinkhorn_global", "launches_per_call": 1,
                 "checks": [{k: c.get(k) for k in keys} for c in checks]})
    line["ok"] = line["ok"] and all(c["ok"] for c in checks)
    emit(line)
    if not line["ok"]:
        raise AssertionError(f"sinkhorn_global disagrees: {line}")
    return line


def _counters():
    from rspl_slam_tpu_torch.ops import cuda_build

    return cuda_build.launch_counts()


def _reset_counters():
    from rspl_slam_tpu_torch.ops import attention_cuda, conv_stem_cuda, sinkhorn_cuda

    conv_stem_cuda.launches = conv_stem_cuda.side_launches = 0
    attention_cuda.launches = attention_cuda.f32_launches = 0
    attention_cuda.two_set_launches = attention_cuda.two_set_f32_launches = 0
    attention_cuda.streamed_launches = 0
    sinkhorn_cuda.launches = sinkhorn_cuda.global_launches = 0


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


def _scene_frames(camera, lines: bool):
    """The end-to-end scene's 30 rendered stereo pairs (with 12 dark
    segments on the lines paths) through ``camera``."""
    from rspl_slam_tpu_torch.evaluation import synthetic

    scene = synthetic.make_scene(num_points=600, num_lines=12 if lines else 0, seed=1,
                                 extent=(6.0, 4.0, 6.0), on_line_frac=0.0)
    traj = synthetic.make_trajectory(E2E_FRAMES, step=0.05)
    return [synthetic.render_images(scene, camera, traj[i], seed=i) for i in range(E2E_FRAMES)]


_SCENES = {}  # (camera, lines) → the 30 pairs: each path gets its own copy


def _scene(cfg, lines: bool, n: int = E2E_FRAMES):
    """The end-to-end scene's first ``n`` (30) rendered stereo pairs (with
    12 dark segments on the lines paths), the ground-truth trajectory, and
    the seconds this call waited for the frames (rendered once per camera
    and scene, ahead in the prerender pool where the run started one)."""
    from rspl_slam_tpu_torch.config import SystemConfig
    from rspl_slam_tpu_torch.evaluation import synthetic

    t0 = time.perf_counter()
    key = (repr(cfg.camera), lines)
    if key not in _SCENES:
        _SCENES[key] = (_rendered(("scene", lines)) if cfg.camera == SystemConfig().camera
                        else _scene_frames(cfg.camera, lines))
    frames = [tuple(im.copy() for im in pair) for pair in _SCENES[key][:n]]
    traj = synthetic.make_trajectory(E2E_FRAMES, step=0.05)
    return frames, traj, time.perf_counter() - t0


# frames of the full run's later phases, rendered in a pool of spawned
# processes on the host's idle cores while the card runs the earlier ones
# (the renders are seeded: the same frames as rendered in line)
PRERENDER_WORKERS = 3
LOOP_RENDER_CHUNK = 26
_PRERENDER = {"pool": None, "jobs": {}}


def _render(key):
    """One render job (in a pool worker, or in line): the value
    :func:`_rendered` returns for ``key``."""
    from rspl_slam_tpu_torch.config import SystemConfig, load_system_config
    from rspl_slam_tpu_torch.evaluation import synthetic

    kind = key[0]
    if kind == "scene":  # ("scene", lines): _scene's pairs
        return _scene_frames(SystemConfig().camera, key[1])
    if kind == "config":  # ("config", path): the configuration's raw pairs
        full = os.path.join(ROOT, key[1])
        cam = load_system_config(full, full).camera
        frames, traj, scale = config_scene(cam, E2E_FRAMES)
        return raw_frames(cam, frames), traj, scale
    if kind == "loop":  # ("loop", first, end): 8-bit pairs of the loop sequence
        scene, traj = loop_sequence()
        cam = SystemConfig().camera
        return [tuple((np.clip(im, 0, 1) * 255).astype(np.uint8)
                      for im in synthetic.render_images(scene, cam, traj[i], seed=i))
                for i in range(key[1], key[2])]
    if kind == "ms":  # ("ms", s): sequence s of multi_sequence, and its trajectory
        return _ms_sequence(_ms_cfg(), key[1])
    raise ValueError(f"no render job {key}")


def _loop_keys():
    return [("loop", lo, min(lo + LOOP_RENDER_CHUNK, LOOP_FRAMES))
            for lo in range(0, LOOP_FRAMES, LOOP_RENDER_CHUNK)]


def start_prerender():
    """Submit every render of the full run's later phases, in the order the
    phases need them, to a pool of ``PRERENDER_WORKERS`` spawned processes."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    pool = ProcessPoolExecutor(max_workers=PRERENDER_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    _PRERENDER["pool"] = pool
    keys = [("scene", True), ("scene", False), *[("config", path) for _, path in CONFIGS],
            *_loop_keys(), *[("ms", s) for s in range(MS_SEQUENCES)]]
    for key in keys:
        _PRERENDER["jobs"][key] = pool.submit(_render, key)


def stop_prerender():
    """Cancel the renders no phase took and end the pool's processes."""
    pool = _PRERENDER["pool"]
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)
        _PRERENDER["pool"] = None
    _PRERENDER["jobs"].clear()


def _rendered(key):
    """The render ``key``: from the pool where it was submitted (once),
    else rendered here."""
    job = _PRERENDER["jobs"].pop(key, None)
    if job is None:
        return _render(key)
    out = job.result()
    if not _PRERENDER["jobs"]:  # the last one: the pool's processes end
        stop_prerender()
    return out


def scale_camera(cam, f: float):
    """The camera at ``f`` times its size: image size, rectified
    intrinsics, bf and the raw K and P scaled by ``f``; the distortion
    model, its coefficients and R unchanged (they act on normalized
    coordinates)."""
    def scaled(m, rows):
        if m is None:
            return None
        a = np.asarray(m, np.float64).reshape(rows, -1).copy()
        a[:2] *= f
        return tuple(a.ravel().tolist())

    return dataclasses.replace(
        cam, image_width=int(round(cam.image_width * f)),
        image_height=int(round(cam.image_height * f)),
        fx=cam.fx * f, fy=cam.fy * f, cx=cam.cx * f, cy=cam.cy * f, bf=cam.bf * f,
        left_K=scaled(cam.left_K, 3), right_K=scaled(cam.right_K, 3),
        left_P=scaled(cam.left_P, 3), right_P=scaled(cam.right_P, 3))


def _undistort(xd, yd, D, distortion_type: int):
    """Normalized raw coordinates → undistorted ones: the inverse of
    camera.build_rectify_maps' distortion model (radtan by fixed-point
    iteration, equidistant fisheye by Newton's method on θ)."""
    D = list(np.asarray(D if D is not None else [], np.float64).ravel())
    if distortion_type == 0:
        k1, k2, p1, p2, k3 = (D + [0.0] * 5)[:5]
        x, y = xd.copy(), yd.copy()
        for _ in range(30):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x, y = (xd - dx) / radial, (yd - dy) / radial
        return x, y
    k1, k2, k3, k4 = (D + [0.0] * 4)[:4]
    theta_d = np.sqrt(xd * xd + yd * yd)
    th = theta_d.copy()
    for _ in range(30):
        t2 = th * th
        f = th * (1.0 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3 + k4 * t2 ** 4) - theta_d
        df = 1.0 + 3.0 * k1 * t2 + 5.0 * k2 * t2 ** 2 + 7.0 * k3 * t2 ** 3 + 9.0 * k4 * t2 ** 4
        th = th - f / df
    scale = np.where(theta_d > 1e-12, np.tan(th) / np.maximum(theta_d, 1e-12), 1.0)
    return xd * scale, yd * scale


def raw_to_rectified_map(cam, side: str):
    """(H, W, 2) float64: the rectified (x, y) at which each raw pixel of
    ``side`` looks, the inverse of ``camera.build_rectify_maps``: the raw
    pixel through K⁻¹, undistorted, rotated by R into the rectified camera
    and projected by P. None where the camera has no raw calibration."""
    K, D, R, P = (getattr(cam, f"{side}_{m}") for m in "KDRP")
    if K is None or P is None:
        return None
    K = np.asarray(K, np.float64).reshape(3, 3)
    R = np.asarray(R if R is not None else np.eye(3), np.float64).reshape(3, 3)
    P = np.asarray(P, np.float64).reshape(3, 4)
    H, W = cam.image_height, cam.image_width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    x, y = _undistort((u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], D, cam.distortion_type)
    rays = R @ np.stack([x, y, np.ones_like(x)]).reshape(3, -1)
    xr = P[0, 0] * rays[0] / rays[2] + P[0, 2]
    yr = P[1, 1] * rays[1] / rays[2] + P[1, 2]
    return np.stack([xr, yr], -1).reshape(H, W, 2)


def _sample(img, xy):
    """Bilinear samples of ``img`` (H, W) at ``xy`` (..., 2), the border
    clamped."""
    H, W = img.shape
    x = np.clip(xy[..., 0], 0.0, W - 1.0)
    y = np.clip(xy[..., 1], 0.0, H - 1.0)
    x0 = np.minimum(np.floor(x).astype(np.int64), W - 2)
    y0 = np.minimum(np.floor(y).astype(np.int64), H - 2)
    wx, wy = x - x0, y - y0
    return (img[y0, x0] * (1 - wy) * (1 - wx) + img[y0, x0 + 1] * (1 - wy) * wx
            + img[y0 + 1, x0] * wy * (1 - wx) + img[y0 + 1, x0 + 1] * wy * wx)


def raw_frames(cam, frames):
    """Rendered rectified stereo pairs → the raw 8-bit pairs the camera
    would have taken: each raw pixel samples the render where it looks
    (``raw_to_rectified_map``), so rectification on the way in undoes the
    config's own distortion and rotation."""
    maps = [raw_to_rectified_map(cam, side) for side in ("left", "right")]
    out = []
    for pair in frames:
        out.append(tuple(
            (np.clip(im if m is None else _sample(im.astype(np.float64), m), 0, 1) * 255
             ).round().astype(np.uint8) for im, m in zip(pair, maps)))
    return out


EUROC_BASELINE = 47.90639384423901 / 435.2046959714599  # m, the end-to-end scene's camera


def config_scene(cam, n: int, num_lines: int = 12, closer: float = 1.0):
    """The end-to-end scene (600 blobs, ``num_lines`` dark segments, seed 1)
    and forward trajectory shrunk into what the camera can range: the box
    spans 2-8 m, so a camera whose ``depth_upper_thr`` is under 8.9 m sees
    it scaled by 0.9·depth_upper_thr / 8, and one with a shorter stereo
    baseline than EuRoC's by the ratio of the baselines (random
    SuperPoint puts its keypoints on an 8-px grid, so disparities must stay
    near EuRoC's), the step with it; the smaller scale wins, divided by
    ``closer`` (a run at a fraction of the camera's size keeps its
    disparities so). Rendered rectified with ``cam``: (frames, trajectory,
    scale)."""
    from rspl_slam_tpu_torch.evaluation import synthetic

    s = min(1.0, 0.9 * cam.depth_upper_thr / 8.0, cam.baseline / EUROC_BASELINE) / closer
    scene = synthetic.make_scene(num_points=600, num_lines=num_lines, seed=1,
                                 extent=(6.0 * s, 4.0 * s, 6.0 * s), depth_offset=2.0 * s,
                                 on_line_frac=0.0)
    traj = synthetic.make_trajectory(n, step=0.05 * s)
    frames = [synthetic.render_images(scene, cam, traj[i], seed=i) for i in range(n)]
    return frames, traj, s


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
                     sp_params=None, record_merge: list | None = None,
                     numpy_merge: bool = False):
    """The port's SLAMSystem + NeuralFrontend on rendered EuRoC-size frames:
    the true default (lines on, async local BA: ``SLAMSystem(cfg, fe)``),
    the same with BA off, or the point-only path with BA off. With
    ``sp_params`` (trained SuperPoint weights) only finite poses are gated;
    the rest is measured. ``record_merge``: a list that collects every
    ``ops/lines.merge_lines`` input of the timed frames (segments and
    thresholds), for the ``native`` phase; ``numpy_merge``: the lines path
    with the numpy merge (``force_numpy=True``) in place of the compiled
    one, for ``merge_ab``."""
    import torch

    from rspl_slam_tpu_torch.config import SystemConfig
    from rspl_slam_tpu_torch.ops import lines as lops
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
    merge = lops.merge_lines
    if record_merge is not None or numpy_merge:
        def patched(segs, *args):
            if record_merge is not None:
                record_merge.append((np.array(segs), args))
            return merge(segs, *args, force_numpy=numpy_merge)

        lops.merge_lines = patched
    try:
        for i in range(E2E_FRAMES):
            recs.append(slam.add_frame(i, 0.05 * i, *frames[i]))
            if lines:
                lines_per_frame.append(int(slam._last_feats.line_valid.sum()))
    finally:
        lops.merge_lines = merge
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


UNEQUAL_RADII = (2, 10)  # nms_radius outside 3..8: SuperPoint's pixel-space path
UNEQUAL_SETS = ((400, 300), (300, 400))  # SuperGlue's M != N shapes
UNEQUAL_MIN_KEYPOINTS = 100  # valid keypoints per image at radius 2
# K2's bf16 kernel lines: |k - p| <= 2^-8 |p| + 4e-3 (one bf16 intermediate
# on the other side of a rounding boundary after another f32 summation order)
K2_BF16_TOL = (2.0 ** -8, 4e-3)
# K2's f32 mode against its plain version: 3xTF32 products, f32 sums in
# another order (2.4e-6 at most measured, K = 48 to 4096); one TF32 product
# alone is ~3e-4 of the largest entry off a GEMM of the layer
# (tests/test_torch_kernel_plans.py), far outside it
K2_F32_TOL = (1e-5, 1e-5)
K2_F32_TOL_TEXT = "rtol 1e-5, atol 1e-5 (f32 accuracy, 3xTF32; another f32 summation order)"
UNEQUAL_TOLERANCE = (
    "bf16 log plan: |kernel - plain| <= 2x |plain on the CPU - plain| (max over valid "
    "entries); each layer on the plain forward's input: max |kernel - plain| <= max |plain "
    "bf16 - plain f32| over valid rows (the kernel nearer its plain version than the bf16 "
    "contract is to f32); K3 1e-3; f32 log plan: the larger of 2x its spread and 1e-3")


def _sets_equal(xy_a, sc_a, v_a, xy_b, sc_b, v_b) -> bool:
    """Two keypoint selections hold the same valid keypoints with equal
    scores (as sets: topk may order exactly-equal scores otherwise)."""
    def keyed(xy, sc, v):
        return {tuple(p): float(c) for p, c in zip(xy[v].tolist(), sc[v].tolist())}

    return all(keyed(xy_a[b], sc_a[b], v_a[b]) == keyed(xy_b[b], sc_b[b], v_b[b])
               for b in range(xy_a.shape[0]))


def _layers_on_plain_inputs(sg, arrays, cfg):
    """``match_pair``'s GNN at bf16 one layer at a time, on the plain
    forward's own inputs: each layer through its kernel (K2's two-set
    variant, each set over its source, where M != N; the stacked K2 where M
    == N) against its plain version on the same input (the plain output
    goes on), beside the same plain layer on the CPU (its own spread) and
    at f32 (what the bf16 contract itself changes); then K3 on the plain
    forward's (M+1, N+1) Sinkhorn problem against the plain sweeps.
    Returns (per layer [kernel vs plain, CPU plain vs plain, plain bf16 vs
    plain f32] max |difference| over valid query rows, K3's max |error| on
    valid entries, the first cross layer's inputs, the Sinkhorn problem)."""
    import torch

    from rspl_slam_tpu_torch.models.superglue import _apply_mlp, _final_proj
    from rspl_slam_tpu_torch.ops import attention_cuda as ac
    from rspl_slam_tpu_torch.ops import sinkhorn as sk
    from rspl_slam_tpu_torch.ops import sinkhorn_cuda as skc
    from rspl_slam_tpu_torch.ops.matching import normalize_keypoints

    dt = torch.bfloat16
    xy0, sc0, d0, v0, xy1, sc1, d1, v1 = arrays
    B, M = d0.shape[:2]

    def encoded(xy, sc, d):
        enc = torch.cat([normalize_keypoints(xy, cfg.image_width, cfg.image_height),
                         sc[..., None]], -1)
        return (d + _apply_mlp(sg.kenc, enc, dt)).contiguous()

    def diffs(got, ref, cpu, ref32, v):
        return [float((got - ref).abs()[v].max()), float((cpu - ref.cpu()).abs()[v.cpu()].max()),
                float((ref - ref32).abs()[v].max())]

    with torch.no_grad():
        x0, x1 = encoded(xy0, sc0, d0), encoded(xy1, sc1, d1)
        errs, cross_in = [], None
        for li, layer in enumerate(sg.gnn):
            cross = li % 2 == 1
            if cross and cross_in is None:
                cross_in = (x0, x1)
            lay_cpu = {k: v.cpu() for k, v in layer.items()}

            def run(lay, x, src, m, d, kernel=False):  # src None: the stacked layer
                if src is None:
                    f = ac.superglue_layer if kernel else ac.superglue_layer_plain
                    return f(x, m, lay, cross, compute_dtype=d)
                f = ac.superglue_layer_two_set if kernel else ac.superglue_layer_two_set_plain
                return f(x, src, m, lay, compute_dtype=d)

            if M == d1.shape[1]:  # stacked, as match_pair runs equal sets
                m = torch.cat([v0, v1])
                calls = [(torch.cat([x0, x1]).contiguous(), None, m, m)]
            else:
                calls = [(x0, x1 if cross else x0, v1 if cross else v0, v0),
                         (x1, x0 if cross else x1, v0 if cross else v1, v1)]
            err, outs = [0.0, 0.0, 0.0], []
            for x, src, m, v in calls:
                ref = run(layer, x, src, m, dt)
                cpu = run(lay_cpu, x.cpu(), None if src is None else src.cpu(), m.cpu(), dt)
                e = diffs(run(layer, x, src, m, dt, kernel=True), ref, cpu,
                          run(layer, x, src, m, torch.float32), v)
                err = [max(a, b) for a, b in zip(err, e)]
                outs.append(ref)
            x0, x1 = outs if len(outs) == 2 else (outs[0][:B], outs[0][B:])
            errs.append(err)
        sim = torch.einsum("bmc,bnc->bmn", _final_proj(sg, x0, dt),
                           _final_proj(sg, x1, dt)) / cfg.descriptor_dim ** 0.5
        Z0, mu, nu, _ = sk.build_problem(sim, v0, v1, sg.bin_score)
        got = skc.sinkhorn_iterations(Z0, mu, nu, cfg.sinkhorn_iterations)
        ref = sk.sinkhorn_iterations_plain(Z0, mu, nu, cfg.sinkhorn_iterations)
        torch.cuda.synchronize()
    _, k3_err = _allclose_report("sinkhorn", got, ref, 0.0, K3_ATOL, _plan_sel(v0, v1))
    return errs, k3_err, cross_in, (Z0, mu, nu)


def phase_unequal():
    """What the port runs beside the main path at full width, each path
    with the launch counters reset just before and read just after:
    (1) SuperPoint's pixel-space path, ``extract`` at ``nms_radius`` 2 and
    10 (bf16, random weights, seed 0) on the end-to-end scene's first
    752×480 pair: gated on one K1 launch per extraction, finite output,
    ≥ 100 valid keypoints per image at radius 2 and the NMS + top-K on the
    card equal to the plain versions on the CPU, on the card's own
    ``dense_heads`` map (same keypoints and scores), the descriptors
    sampled there within 1e-5 of the plain sampling on the CPU; (2) ``match_pair`` with ``SuperGlueConfig()`` (18
    layers, 100 iterations, random weights, seed 0) on the radius-2
    features cut to M = 400 against N = 300 and M = 300 against N = 400:
    gated at bf16 on 36 launches of K2's two-set variant and one of K3 on
    the (M+1, N+1) plan per match (the stacked K2 none), a finite log plan
    of that shape within 2× the plain version's own spread (the same plain
    function on the CPU) of the plain forward's, each layer through the
    variant on the plain forward's own input nearer its plain version than
    the plain version at bf16 is to the same at f32, K3 on the plain
    forward's problem within its kernel line's 1e-3; then the variant's f32
    mode
    through ``match_pair`` (36 f32 launches) within 2× the f32 plain
    spread, or 1e-3 where that is smaller. Each match line has the
    variant's CUDA-event ms on the first cross layer's inputs and K3's on
    the plan, beside their bounds. (3) The control: the stacked K2 at M = N
    = 400 on the same features, held by the same per-layer rule."""
    import torch

    from rspl_slam_tpu_torch.config import SuperGlueConfig, SystemConfig
    from rspl_slam_tpu_torch.models import superglue, superpoint
    from rspl_slam_tpu_torch.models.weights import (superglue_from_numpy, superpoint_from_numpy,
                                                    to_tensor_tree)
    from rspl_slam_tpu_torch.ops import attention_cuda as ac
    from rspl_slam_tpu_torch.ops import keypoints as kp
    from rspl_slam_tpu_torch.ops import sinkhorn_cuda as skc
    from rspl_slam_tpu_torch.ops.matching import mutual_match_decode
    from rspl_slam_tpu_torch.training import superglue_train

    cfg = SystemConfig()
    frames, _, _ = _scene(cfg, lines=False, n=1)
    imgs = torch.from_numpy(np.stack(frames[0])).to("cuda")
    sp = superpoint_from_numpy(superpoint.init_params(0), "cuda")
    counts_all, feats, sp_lines = {}, {}, []
    for r in UNEQUAL_RADII:
        spc = dataclasses.replace(cfg.superpoint, nms_radius=r)
        _reset_counters()
        f = superpoint.extract(sp, imgs, spc, torch.bfloat16)
        torch.cuda.synchronize()
        counts = _counters()
        feats[r] = f
        with torch.no_grad():
            scores, desc = superpoint.dense_heads(sp, imgs, torch.bfloat16)
            card = kp.top_k_keypoints(kp.simple_nms(scores, r), spc.max_keypoints,
                                      spc.keypoint_threshold, spc.remove_borders)
            plain = kp.top_k_keypoints(kp.simple_nms(scores.cpu(), r), spc.max_keypoints,
                                       spc.keypoint_threshold, spc.remove_borders)
            d_card = kp.sample_descriptors(card[0], desc, 8)
            d_plain = kp.sample_descriptors(card[0].cpu(), desc.cpu(), 8)
        nms_equal = _sets_equal(*(t.cpu() for t in card), *plain)
        v = card[2].cpu()
        desc_err = float((d_card.cpu()[v] - d_plain[v]).abs().max())
        same = f.valid.cpu() & card[2].cpu() & (f.xy.cpu() == card[0].cpu()).all(-1)
        n_valid = f.valid.sum(1).tolist()
        finite = all(bool(torch.isfinite(t).all()) for t in (f.xy, f.score, f.desc))
        line = {"phase": "unequal", "part": "superpoint", "card": CARD, "nms_radius": r,
                "image": list(imgs.shape), "valid_keypoints": n_valid,
                "nms_topk_equal_plain": nms_equal, "desc_max_abs_err": desc_err,
                "extract_equal_share": float(same.sum()) / max(1, int(f.valid.sum())),
                "ms": time_ms(lambda: superpoint.extract(sp, imgs, spc, torch.bfloat16), n=5),
                "launches": counts}
        emit(line)
        sp_lines.append(line)
        if not (finite and counts["conv_stem"] == 1 and nms_equal and desc_err <= 1e-5):
            raise AssertionError(f"unequal: extract at nms_radius {r}: {line}")
        if r == UNEQUAL_RADII[0] and min(n_valid) < UNEQUAL_MIN_KEYPOINTS:
            raise AssertionError(f"unequal: {n_valid} keypoints at nms_radius {r}")
        counts_all = {k: counts_all.get(k, 0) + c for k, c in counts.items()}

    sgc = SuperGlueConfig()
    params = superglue.init_params(sgc, 0)
    sg = superglue_from_numpy(params, sgc, "cuda")
    f = feats[UNEQUAL_RADII[0]]
    tree, tree_cpu = to_tensor_tree(params, "cuda"), to_tensor_tree(params, "cpu")
    match_lines = []
    for M, N in UNEQUAL_SETS:
        arrays = tuple(t[0:1, :M].contiguous() for t in (f.xy, f.score, f.desc, f.valid)) + \
            tuple(t[1:2, :N].contiguous() for t in (f.xy, f.score, f.desc, f.valid))
        v0, v1 = arrays[3], arrays[7]
        sel = _plan_sel(v0, v1)
        out = {}
        for dt in (torch.bfloat16, torch.float32):
            _reset_counters()
            res = superglue.match_pair(sg, *arrays, sgc, compute_dtype=dt)
            torch.cuda.synchronize()
            counts = _counters()
            with torch.no_grad():
                z_p = superglue_train.log_plan(tree, *arrays, sgc, dt)
                z_cpu = superglue_train.log_plan(tree_cpu, *(a.cpu() for a in arrays), sgc, dt)
                ref = mutual_match_decode(z_p, v0, v1, sgc.match_threshold)[0]
            out[dt] = {"counts": counts, "res": res, "z_p": z_p,
                       "err": float((res.log_plan - z_p).abs()[sel].max()),
                       "spread": float((z_cpu - z_p.cpu()).abs()[sel.cpu()].max()),
                       "decode_equal_share": float((res.indices0 == ref)[v0].float().mean()),
                       "ms": time_ms(lambda: superglue.match_pair(sg, *arrays, sgc,
                                                                  compute_dtype=dt), n=5)}
            counts_all = {k: counts_all.get(k, 0) + c for k, c in counts.items()}
        bf, f32 = out[torch.bfloat16], out[torch.float32]
        layer_errs, k3_err, (x0, x1), (Z0, mu, nu) = _layers_on_plain_inputs(sg, arrays, sgc)
        layers_ok = all(k <= g for k, _, g in layer_errs)
        bf16_gap = float((bf["z_p"] - f32["z_p"]).abs()[sel].max())
        layer = sg.gnn[1]
        k2_flops, k2_bytes, k2_bms, k2_by = _two_set_bound(ac, layer, 1, M, N, torch.bfloat16)
        scratch = (ac.layer_scratch(x0, None, torch.bfloat16),
                   ac.layer_scratch(x1, v1, torch.bfloat16))
        k2_ms = time_ms(lambda: ac.superglue_layer_two_set(
            x0, x1, v1, layer, compute_dtype=torch.bfloat16, scratch=scratch))
        sweeps = 2 * sgc.sinkhorn_iterations * (M + 1) * (N + 1)
        k3_bms, k3_by = bound_ms(4.0 * sweeps, 4.0 * (2 * (M + 1) * (N + 1) + M + N + 2),
                                 PEAK_F32, sfu_ops=sweeps)
        res = bf["res"]
        f32_tol = max(TRAIN_SG_BF16_SPREAD * f32["spread"], TRAIN_SG_F32_ATOL)
        line = {"phase": "unequal", "part": "match_pair", "card": CARD, "M": M, "N": N,
                "valid": [int(v0.sum()), int(v1.sum())], "layers": sgc.num_gnn_layers,
                "iters": sgc.sinkhorn_iterations, "log_plan_shape": list(res.log_plan.shape),
                "match_ms_bf16": bf["ms"], "match_ms_f32": f32["ms"],
                "launches_bf16": bf["counts"], "launches_f32": f32["counts"],
                "decoded_matches": int((res.indices0 >= 0).sum()),
                "decode_equal_share_bf16": bf["decode_equal_share"],
                "decode_equal_share_f32": f32["decode_equal_share"],
                "log_plan_max_abs_err_bf16": bf["err"], "log_plan_cpu_plain_spread_bf16":
                bf["spread"], "log_plan_max_abs_err_f32": f32["err"],
                "log_plan_cpu_plain_spread_f32": f32["spread"], "f32_tolerance": f32_tol,
                "plain_bf16_vs_f32_max_abs_diff": bf16_gap,
                "k2_layer_max_abs_diff_kernel_cpu_spread_bf16_vs_f32": layer_errs,
                "k3_max_abs_err": k3_err,
                "k2_two_set_ms": k2_ms, "k2_two_set_bound_ms": k2_bms, "k2_two_set_bound_by":
                k2_by, "k3_ms": time_ms(lambda: skc.sinkhorn_iterations(
                    Z0, mu, nu, sgc.sinkhorn_iterations)),
                "k3_bound_ms": k3_bms, "k3_bound_by": k3_by,
                "k2_layers_ok": layers_ok, "tolerance": UNEQUAL_TOLERANCE}
        emit(line)
        match_lines.append(line)
        n_layers = 2 * sgc.num_gnn_layers
        launches_ok = (bf["counts"]["superglue_layer_two_set"] == n_layers
                       and f32["counts"]["superglue_layer_two_set_f32"] == n_layers
                       and bf["counts"]["sinkhorn"] == f32["counts"]["sinkhorn"] == 1
                       and bf["counts"]["superglue_layer"] == 0
                       and f32["counts"]["superglue_layer_f32"] == 0)
        values_ok = (tuple(res.log_plan.shape) == (1, M + 1, N + 1)
                     and bool(torch.isfinite(res.log_plan).all())
                     and bf["err"] <= TRAIN_SG_BF16_SPREAD * bf["spread"]
                     and layers_ok and k3_err <= K3_ATOL and f32["err"] <= f32_tol)
        if not (launches_ok and values_ok):
            raise AssertionError(f"unequal: match_pair {M} against {N}: {line}")

    # the control: the stacked K2 on the same features at M = N = 400, held
    # by the same per-layer rule (random weights grow the residual stream
    # to |x| ~ 8 by the last layer, past what the kernel lines' N(0, 1)
    # inputs and their elementwise tolerance assume, for both kernels)
    arrays = tuple(t[b:b + 1].contiguous() for b in (0, 1)
                   for t in (f.xy, f.score, f.desc, f.valid))
    layer_errs, k3_err, _, _ = _layers_on_plain_inputs(sg, arrays, sgc)
    control = {"phase": "unequal", "part": "stacked_control", "card": CARD, "M": 400, "N": 400,
               "k2_layer_max_abs_diff_kernel_cpu_spread_bf16_vs_f32": layer_errs,
               "k2_layers_ok": all(k <= g for k, _, g in layer_errs), "k3_max_abs_err": k3_err,
               "tolerance": UNEQUAL_TOLERANCE}
    emit(control)
    if not (control["k2_layers_ok"] and k3_err <= K3_ATOL):
        raise AssertionError(f"unequal: the stacked control: {control}")
    return sp_lines + match_lines + [control], counts_all


# the four other shipped configurations, end to end at full size
CONFIGS = (("oivio", "configs/oivio.yaml"), ("uma", "configs/uma_bumblebee_indoor.yaml"),
           ("realsense", "configs/realsense.yaml"), ("zed2i", "configs/zed2i.yaml"))
# the JAX package's ATE (m) on each configuration's run at half size, on the
# CPU (tests/torch_slice_reference.py --config configs/<name>.yaml); the
# card's run at full size is held under CONFIG_ATE_FACTOR times it
CONFIG_JAX_ATE = {"oivio": 0.06486239829618877, "uma": 0.224040853627382,
                  "realsense": 0.10590892742590875, "zed2i": 0.11025068756446281}
CONFIG_ATE_FACTOR = 1.6
RECT_ATOL = 1e-6  # the card's rectified frames against the CPU's remap_bilinear


def _config_kernels(cfg, seed: int) -> dict:
    """Each kernel at this configuration's shapes against its plain
    version, timed beside its bound: K1 on SuperPoint's conv1b (2, H, W,
    64), K1's side mode on RCF's first stage (×0.5 where H and W are
    multiples of 8, else full size), K2 bf16 stacked (2, K, 256), K3 (1,
    K+1, K+1)."""
    import torch

    from rspl_slam_tpu_torch.ops import attention_cuda as ac

    cam, K = cfg.camera, cfg.superpoint.max_keypoints
    H, W = cam.image_height, cam.image_width
    half = H % 8 == 0 and W % 8 == 0 and cfg.line_detector.rcf_at_detection_scale
    Hs, Ws = (H // 2, W // 2) if half else (H, W)
    keys = ("shape", "ok", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    out = {"conv_stem": {k: v for k, v in _conv_case(2, H, W, False, seed).items()
                         if k in keys},
           "conv_stem_side": {k: v for k, v in _conv_case(2, Hs, Ws, True, seed + 1).items()
                              if k in keys}}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    layer = ac.pack_layer(_random_layer(gen, 256, "cuda"), "cuda")
    ok, errs, x, masks, scratch = _layer_case(ac, gen, layer, K, K - K // 9, torch.bfloat16,
                                              *K2_BF16_TOL)
    bms, by = _layer_bound(ac, layer, x, torch.bfloat16)[2:]
    out["superglue_layer"] = {
        "shape": list(x.shape), "route": ac.bf16_route(K), "ok": ok, "max_abs_err": max(errs),
        "ms": time_ms(lambda: ac.superglue_layer(x, masks, layer, True,
                                                 compute_dtype=torch.bfloat16,
                                                 scratch=scratch)),
        "plain_ms": time_ms(lambda: ac.superglue_layer_plain(
            x, masks, layer, True, compute_dtype=torch.bfloat16)),
        "bound_ms": bms, "bound_by": by}
    k3 = _sinkhorn_case(gen, K, K, K - K // 11, K - K // 13, matcher=False, plain_n=2,
                        emit_line=False)
    out["sinkhorn"] = {k: k3[k] for k in keys}
    return out


def phase_config(name: str, path: str, seed: int) -> tuple[dict, dict]:
    """One shipped configuration end to end on the card at full size: the
    file's algorithm and camera sections (``load_system_config``), the
    default ``SLAMSystem(cfg, fe)`` (lines, async local BA), bf16, the
    smoke's weights, 30 frames of ``config_scene`` taken through the
    camera's own distortion and rectification (``raw_frames``: 8-bit raw
    pairs the frontend rectifies on the card). Gated on the first pair's
    rectified frames equal to the CPU's ``remap_bilinear`` with the same
    maps (``RECT_ATOL``), initialization, > 20 inliers on ≥ 80% of frames,
    finite poses, the ATE under ``CONFIG_ATE_FACTOR`` × the JAX package's
    at half size, one K1 launch in each mode per extraction, the resident
    K2 and the cluster K3 (K ≤ 600) and every kernel within its tolerance
    of its plain version at this configuration's shapes. Returns the line
    and the counts."""
    import torch

    from rspl_slam_tpu_torch.camera import build_rectify_maps, remap_bilinear
    from rspl_slam_tpu_torch.config import load_system_config
    from rspl_slam_tpu_torch.frontend.frontends import _to_unit_float
    from rspl_slam_tpu_torch.slam import SLAMSystem

    full = os.path.join(ROOT, path)
    cfg = load_system_config(full, full)
    cam = cfg.camera
    t0 = time.perf_counter()
    raw, traj, scale = _rendered(("config", path))
    render_s = time.perf_counter() - t0
    fe = _frontend(cfg, lines=True)
    pair = np.stack(raw[0])
    maps = np.stack([build_rectify_maps(cam, "left"), build_rectify_maps(cam, "right")])
    card = fe._upload(pair, slice(0, 2)).cpu()
    cpu = remap_bilinear(_to_unit_float(torch.from_numpy(pair)), torch.from_numpy(maps))
    rect_err = float((card - cpu).abs().max())
    map_shift = float(np.abs(maps - np.stack(np.meshgrid(
        np.arange(cam.image_width), np.arange(cam.image_height)), -1)[None]).max())

    warm = SLAMSystem(cfg, fe)
    for i in range(2):
        warm.add_frame(i, 0.05 * i, *raw[i])
    warm.flush_ba()
    del warm
    torch.cuda.synchronize()
    fe.timings.clear()
    slam = SLAMSystem(cfg, fe)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    recs, lines_per_frame = [], []
    for i in range(E2E_FRAMES):
        recs.append(slam.add_frame(i, 0.05 * i, *raw[i]))
        lines_per_frame.append(int(slam._last_feats.line_valid.sum()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counters()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    slam.flush_ba()
    est = np.stack([r.Twc for r in recs])
    ate = _ate(recs, traj)
    inliers = [int(r.num_inliers) for r in recs[1:]]
    tracked = sum(n > E2E_MIN_INLIERS for n in inliers)
    jax_ate = CONFIG_JAX_ATE[name]
    bound = None if jax_ate is None else CONFIG_ATE_FACTOR * jax_ate
    timings = {**slam.timings, **fe.timings}
    matches = counts["sinkhorn"] + counts["sinkhorn_global"]
    kernels = _config_kernels(cfg, seed)
    m = slam.map
    line = {"phase": "configs", "config": name, "file": path, "card": CARD,
            "image": [cam.image_width, cam.image_height],
            "distortion_type": cam.distortion_type, "rect_map_max_shift_px": map_shift,
            "max_keypoints": cfg.superpoint.max_keypoints,
            "keyframe": dataclasses.asdict(cfg.keyframe),
            "chi2_tracking": dataclasses.asdict(cfg.optimization.tracking),
            "scene_scale": scale, "frames": E2E_FRAMES, "render_s": render_s,
            "rectified_max_abs_diff_card_cpu": rect_err, "rect_atol": RECT_ATOL,
            "initialized": slam.initialized, "keyframes": int(m.n_kf),
            "inliers": inliers, "frames_over_min_inliers": tracked,
            "ate_rmse_m": ate, "jax_ate_half_size_m": jax_ate, "ate_bound_m": bound,
            "keyframe_ate_rmse_m": _keyframe_ate(m, traj),
            "frames_per_s": E2E_FRAMES / wall, "wall_s": wall,
            "stage_median_ms": {k: float(np.median(v)) * 1e3 for k, v in timings.items()},
            "max_memory_allocated_MB": peak_mb, "launches": counts,
            "matches": matches,
            "k2_launches_per_match": counts["superglue_layer"] / max(1, matches),
            "k3_launches_per_match": counts["sinkhorn"] / max(1, matches),
            "lines_per_frame_median": float(np.median(lines_per_frame)),
            "maplines_with_endpoints": int(m.ln_has_endpoints[: m.n_ln].sum()),
            "ba_windows": len(slam.ba_windows), "kernels": kernels}
    emit(line)
    fails = []
    if not rect_err <= RECT_ATOL:
        fails.append(f"rectified frames {rect_err} from the CPU's")
    if not slam.initialized:
        fails.append("no initialization")
    if tracked < 0.8 * len(inliers):
        fails.append(f"too few tracked frames: {inliers}")
    if not np.isfinite(est).all():
        fails.append("non-finite pose")
    if bound is None or not ate < bound:
        fails.append(f"ATE {ate} over the bound {bound}")
    if counts["conv_stem"] != E2E_FRAMES or counts["conv_stem_side"] != E2E_FRAMES:
        fails.append(f"K1 launches {counts['conv_stem']} / side {counts['conv_stem_side']} "
                     f"in {E2E_FRAMES} extractions")
    if (counts["superglue_layer"] <= 0 or counts["sinkhorn"] <= 0
            or counts["superglue_layer_streamed"] or counts["sinkhorn_global"]):
        fails.append(f"K2 / K3 launches {counts}")
    if not (line["lines_per_frame_median"] > 0 and line["maplines_with_endpoints"] > 0):
        fails.append("no lines detected or no mapline triangulated")
    if not all(k["ok"] for k in kernels.values()):
        fails.append(f"a kernel disagrees with its plain version: {kernels}")
    if fails:
        raise AssertionError(f"configs {name}: " + "; ".join(fails))
    return line, counts, (cfg, raw, traj)


def start_config_cli(name: str, path: str, raw, traj) -> dict:
    """``cli run --config <file>`` on the configuration's raw frames written
    as a raw-EuRoC PNG tree (the file's own camera section rectifies them):
    by default (the native loader rectifies on the host with the config's
    maps) and with ``--no-native`` (the card rectifies), both processes
    started at once; :func:`phase_config_cli` gates them."""
    from rspl_slam_tpu_torch.config import load_system_config
    from rspl_slam_tpu_torch.models import rcf, superglue, superpoint
    from rspl_slam_tpu_torch.models.weights import save_npz_pytree
    from rspl_slam_tpu_torch.slam import INIT_POSE

    full = os.path.join(ROOT, path)
    cfg = load_system_config(full, full)
    work = os.path.join(WORK, f"cli_{name}")
    shutil.rmtree(work, ignore_errors=True)
    tree = os.path.join(work, "seq")
    _write_tree(tree, raw, np.einsum("ij,njk->nik", INIT_POSE, traj))
    for k, params in {"sp": superpoint.init_params(0),
                      "sg": superglue.descriptor_matcher_params(cfg.superglue, 0, 2000.0,
                                                                1980.0),
                      "rcf": rcf.edge_detector_params()}.items():
        save_npz_pytree(os.path.join(work, f"{k}.npz"), params)
    common = ("--dataroot", tree, "--config", full, "--camera-config", full,
              "--sp-weights", os.path.join(work, "sp.npz"),
              "--sg-weights", os.path.join(work, "sg.npz"),
              "--rcf-weights", os.path.join(work, "rcf.npz"), "--gt", tree)
    routes = {"native": (), "no_native": ("--no-native",)}
    return {"name": name, "work": work, "frames": len(raw), "routes": routes,
            "t0": time.perf_counter(),
            "started": _cli_start(*[("run", *common, "--traj-path",
                                     os.path.join(work, f"traj_{route}.txt"), *extra)
                                    for route, extra in routes.items()])}


def phase_config_cli(started: dict) -> dict:
    """:func:`start_config_cli`'s two runs, gated on both exits, 30 frames
    and the two routes' trajectories within ``NATIVE_ROUTE_POS_TOL``."""
    name, work = started["name"], started["work"]
    runs = {}
    for route, out in zip(started["routes"], _cli_wait(started["started"])):
        processed = re.search(r"^processed (\d+) frames in ([0-9.]+)s \(([0-9.]+) fps\)$", out,
                              re.M)
        with open(os.path.join(work, f"traj_{route}.txt")) as f:
            text = f.read()
        runs[route] = {"wall_s_until_gated": time.perf_counter() - started["t0"],
                       "frames": processed and int(processed.group(1)),
                       "printed_fps": processed and float(processed.group(3)),
                       "native_line": "using native prefetcher + rectification"
                       in out.splitlines(),
                       "ate": json.loads(re.search(r"^ATE: (.*)$", out, re.M).group(1)),
                       "launches": json.loads(re.search(r"^kernel launches: (.*)$", out,
                                                        re.M).group(1)),
                       "traj": text}
    dist = _traj_distance(runs["native"]["traj"], runs["no_native"]["traj"])
    line = {"phase": "configs_cli", "config": name, "card": CARD, "routes": dist,
            "route_pos_tol_m": NATIVE_ROUTE_POS_TOL,
            **{route: {k: v for k, v in r.items() if k != "traj"} for route, r in runs.items()}}
    emit(line)
    ok = (all(r["frames"] == started["frames"] for r in runs.values())
          and runs["native"]["native_line"] and not runs["no_native"]["native_line"]
          and dist["same_keyframes"]
          and dist["max_position_diff_m"] is not None
          and dist["max_position_diff_m"] <= NATIVE_ROUTE_POS_TOL)
    if not ok:
        raise AssertionError(f"configs_cli {name}: {line}")
    shutil.rmtree(work, ignore_errors=True)
    return line


def phase_configs():
    """The four other shipped configurations (OIVIO, UMA fisheye, RealSense,
    ZED2i), each through ``phase_config``; OIVIO also through ``cli run``
    (``start_config_cli``, gated after the four). Returns the launch counts
    summed over the four runs."""
    import torch

    total, cli = {}, None
    for i, (name, path) in enumerate(CONFIGS):
        gc.collect()
        torch.cuda.empty_cache()
        _, counts, (cfg, raw, traj) = phase_config(name, path, seed=20 + i)
        total = {k: total.get(k, 0) + c for k, c in counts.items()}
        if name == "oivio":  # its CLI runs beside the other configurations' runs
            cli = start_config_cli(name, path, raw, traj)
    phase_config_cli(cli)
    return total


LARGE_K_BUDGETS = (1024, 2048)  # SuperGlue's outdoor budget and twice it


def phase_large_k():
    """SuperGlue past the resident kernels' ceilings, as a user gets it with
    ``SuperPointConfig(max_keypoints=1024 or 2048)``: ``extract`` on the
    end-to-end scene's first 752×480 pair at that budget (bf16, random
    SuperPoint, seed 0; K1 once), then ``match_pair`` of the pair's two
    sets with ``SuperGlueConfig()`` (18 layers, 100 iterations, random
    weights, seed 0) at bf16, counters reset just before: gated on 18
    launches of K2's streamed kernel and one of K3's global-memory kernel
    (the resident K2 and the cluster K3 none), a finite log plan of shape
    (1, K+1, K+1), each layer on the plain forward's own input nearer its
    plain version than plain bf16 is to plain f32, and K3 on the plain
    forward's problem within its kernel line's 1e-3."""
    import torch

    from rspl_slam_tpu_torch.config import SuperGlueConfig, SystemConfig
    from rspl_slam_tpu_torch.models import superglue, superpoint
    from rspl_slam_tpu_torch.models.weights import superglue_from_numpy, superpoint_from_numpy

    cfg = SystemConfig()
    frames, _, _ = _scene(cfg, lines=False, n=1)
    imgs = torch.from_numpy(np.stack(frames[0])).to("cuda")
    sp = superpoint_from_numpy(superpoint.init_params(0), "cuda")
    sgc = SuperGlueConfig()
    sg = superglue_from_numpy(superglue.init_params(sgc, 0), sgc, "cuda")
    total, out = {}, []
    for K in LARGE_K_BUDGETS:
        spc = dataclasses.replace(cfg.superpoint, max_keypoints=K)
        _reset_counters()
        f = superpoint.extract(sp, imgs, spc, torch.bfloat16)
        arrays = tuple(t[b:b + 1].contiguous() for b in (0, 1)
                       for t in (f.xy, f.score, f.desc, f.valid))
        res = superglue.match_pair(sg, *arrays, sgc, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        counts = _counters()
        total = {k: total.get(k, 0) + c for k, c in counts.items()}
        match_ms = time_ms(lambda: superglue.match_pair(sg, *arrays, sgc,
                                                        compute_dtype=torch.bfloat16), n=3)
        layer_errs, k3_err, _, _ = _layers_on_plain_inputs(sg, arrays, sgc)
        line = {"phase": "large_k", "card": CARD, "max_keypoints": K,
                "valid_keypoints": f.valid.sum(1).tolist(),
                "log_plan_shape": list(res.log_plan.shape),
                "decoded_matches": int((res.indices0 >= 0).sum()), "match_ms": match_ms,
                "launches": counts,
                "k2_layer_max_abs_diff_kernel_cpu_spread_bf16_vs_f32": layer_errs,
                "k2_layers_ok": all(k <= g for k, _, g in layer_errs),
                "k3_max_abs_err": k3_err, "tolerance": UNEQUAL_TOLERANCE}
        emit(line)
        out.append(line)
        ok = (counts["conv_stem"] == 1 and counts["superglue_layer_streamed"] ==
              sgc.num_gnn_layers and counts["sinkhorn_global"] == 1
              and counts["superglue_layer"] == 0 and counts["sinkhorn"] == 0
              and tuple(res.log_plan.shape) == (1, K + 1, K + 1)
              and bool(torch.isfinite(res.log_plan).all())
              and line["k2_layers_ok"] and k3_err <= K3_ATOL)
        if not ok:
            raise AssertionError(f"large_k at {K}: {line}")
    return out, total


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
    from rspl_slam_tpu_torch.evaluation import absolute_trajectory_error
    from rspl_slam_tpu_torch.pipeline import PipelinedRunner
    from rspl_slam_tpu_torch.slam import INIT_POSE, SLAMSystem

    cfg = SystemConfig(pipeline=PipelineConfig(track_local_map=True))
    cam = cfg.camera
    _, traj = loop_sequence()
    t0 = time.perf_counter()
    frames = [pair for key in _loop_keys() for pair in _rendered(key)]
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
    save_compact_map(m, DIST_MAP)  # dist_ba's map: as mapping left it
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


# ------------------------------------------------------------- parallel/
# multi_sequence: 4 sequences in lockstep at the main path's widths, their
# scenes ``synthetic.make_scene`` seeds 1-4 (seed 1 is the BA path's scene)
# with 12 dark segments each, their yaw rates JAX's multi-sequence test's
# (0.002·(s + 1)), frames quantized to 8 bits
MS_SEQUENCES = 4
MS_FRAMES = 24
# batched against serial extraction at step 0, keypoints paired by position
MS_MEAS_ATOL_PX = 1e-3
MS_POSITION_SHARE = 0.99
MS_SCORE_ATOL = 1e-3
MS_STEREO_SHARE = 0.95
BATCHED_BA_POSE_ATOL_M = 1e-4
BATCHED_BA_INLIER_SHARE = 0.99
DIST_RANKS = 2
# JAX's sharded-solve tolerances (tests/test_parallel.py), held on the
# small map's full schedule; the loop map's gates: see phase_dist_ba
DIST_TCW_ATOL = 1e-3
DIST_POINTS_ATOL = 1e-2
DIST_SYSTEM_RTOL = 1e-9  # the summed S, g̃ and cost in f64 against the single solve's
DIST_NUDGE = 1e-7  # the relative nudge of the start that measures the single solve's spread
DIST_TIMEOUT_S = 300


def _ms_cfg():
    """The default SystemConfig with the map store cut to 64 keyframes,
    16384 points and 1024 lines (a default-capacity map checkpoint holds
    ~1 GB of arrays; ``dist_ba`` saves one): the map logic is
    capacity-agnostic."""
    from rspl_slam_tpu_torch.config import SystemConfig

    cfg = SystemConfig()
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, max_map_keyframes=64, max_map_points=16384, max_map_lines=1024))


def _ms_sequence(cfg, s: int):
    """Sequence ``s``'s 8-bit frames and ground-truth trajectory."""
    from rspl_slam_tpu_torch.evaluation import synthetic

    scene = synthetic.make_scene(num_points=600, num_lines=12, seed=1 + s,
                                 extent=(6.0, 4.0, 6.0), on_line_frac=0.0)
    traj = synthetic.make_trajectory(MS_FRAMES, step=0.05, yaw_rate=0.002 * (s + 1))
    return [tuple((np.clip(im, 0, 1) * 255).astype(np.uint8)
                  for im in synthetic.render_images(scene, cfg.camera, traj[i], seed=i))
            for i in range(MS_FRAMES)], traj


def _ms_sequences(cfg):
    """The sequences' 8-bit frames and ground-truth trajectories (the
    prerender pool's, where ``cfg`` has its camera)."""
    out = [_rendered(("ms", s)) if cfg.camera == _ms_cfg().camera else _ms_sequence(cfg, s)
           for s in range(MS_SEQUENCES)]
    return [f for f, _ in out], [t for _, t in out]


def _ms_frontends(cfg):
    """One frontend per sequence with the end-to-end weights (random
    SuperPoint seed 0, shared as one module; the descriptor-matcher
    SuperGlue; the hand-set RCF edge weights)."""
    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.models import rcf, superglue, superpoint

    sg = superglue.descriptor_matcher_params(cfg.superglue, 0, 2000.0, 1980.0)
    rp = rcf.edge_detector_params()
    fe0 = NeuralFrontend(cfg, sp_params=superpoint.init_params(0), sg_params=sg, rcf_params=rp)
    return [fe0] + [NeuralFrontend(cfg, sp_params=fe0.sp, sg_params=sg, rcf_params=rp)
                    for _ in range(MS_SEQUENCES - 1)]


def _launch_deltas(fn, log):
    """``fn`` with the launch counters' change over each call appended to
    ``log`` (counters move on the host at launch: no synchronization)."""
    def wrapped(*a, **k):
        c0 = _counters()
        out = fn(*a, **k)
        c1 = _counters()
        log.append({key: c1[key] - c0[key] for key in c0})
        return out
    return wrapped


def _step0_agreement(batched, serial) -> dict:
    """Batched against serial features of one step, keypoints paired by
    position (SuperPoint's cuDNN convolutions round differently at batch 8
    than at 2, so near-tied keypoints change rank, and a few change place):
    per sequence the share of the serial keypoints found at the same
    position, the largest score difference there, the share whose stereo
    flag (uR > 0) agrees, and the share of the pairs stereo in both whose
    uR agrees within ``MS_MEAS_ATOL_PX``."""
    out = {"position_share": [], "score_max_diff": [], "stereo_flag_share": [],
           "ur_share": [], "stereo_matches": []}
    for b, s in zip(batched, serial):
        at = {tuple(x): i for i, x in enumerate(b.xy[b.valid])}
        bi = np.nonzero(b.valid)[0]
        pairs = [(bi[at[tuple(x)]], j) for j, x in zip(np.nonzero(s.valid)[0], s.xy[s.valid])
                 if tuple(x) in at]
        ib, js = (np.asarray(v, np.int64) for v in zip(*pairs)) if pairs else (
            np.zeros(0, np.int64), np.zeros(0, np.int64))
        ub, us = b.meas[ib, 2], s.meas[js, 2]
        both = (ub > 0) & (us > 0)
        out["position_share"].append(len(pairs) / max(int(s.valid.sum()), 1))
        out["score_max_diff"].append(float(np.abs(b.score[ib] - s.score[js]).max(initial=0.0)))
        out["stereo_flag_share"].append(float(((ub > 0) == (us > 0)).mean()) if len(ib) else 0.0)
        out["ur_share"].append(float((np.abs(ub - us)[both] <= MS_MEAS_ATOL_PX).mean())
                               if both.any() else 0.0)
        out["stereo_matches"].append(int((b.depth > 0).sum()))
    return out


def _superpoint_batch_invariance(sp, pairs, dtype) -> dict:
    """SuperPoint's stages on the card at batch 2N against batch 2, each
    stage fed one input at both sizes: the step's 2N images in one call,
    and each sequence's stereo pair alone, as ``extract_pair`` runs it. Per
    stage, the largest difference between the two outputs (0.0: equal bit
    for bit). K1 computes every image alone, so its stage must be 0.0; the
    ``F.conv2d`` stages (cuDNN) and the heads' matmuls pick their
    algorithms by shape."""
    import torch
    import torch.nn.functional as F

    from rspl_slam_tpu_torch.frontend.frontends import _to_unit_float
    from rspl_slam_tpu_torch.ops import conv_stem_cuda as cs

    def conv(name, pool=False):
        def fn(t):
            y = sp._conv(t, name, dtype)
            return F.max_pool2d(y, 2) if pool else y
        return fn

    chain = [("conv1a (F.conv2d)", lambda t: cs.conv1a(t, sp.conv1a_hwio, sp.conv1a_b, dtype)),
             ("K1 conv1b + pool", lambda t: cs.conv3x3_relu_pool(t, sp._stem_w(), sp.conv1b_b)),
             ("conv2a (F.conv2d)", lambda t: sp._conv(t.permute(0, 3, 1, 2), "conv2a", dtype)),
             ("conv2b (F.conv2d) + pool", conv("conv2b", True)),
             ("conv3a (F.conv2d)", conv("conv3a")),
             ("conv3b (F.conv2d) + pool", conv("conv3b", True)),
             ("conv4a (F.conv2d)", conv("conv4a")), ("conv4b (F.conv2d)", conv("conv4b"))]
    heads = [("convPa (F.conv2d) + convPb (matmul)",
              lambda t: sp._head(sp._conv(t, "convPa", dtype), "convPb", dtype)),
             ("convDa (F.conv2d) + convDb (matmul)",
              lambda t: sp._head(sp._conv(t, "convDa", dtype), "convDb", dtype))]
    x = _to_unit_float(torch.from_numpy(np.stack([im for p in pairs for im in p])).cuda())
    out = {}

    def probe(name, fn, t):
        y = fn(t)
        y2 = torch.cat([fn(t[2 * s: 2 * s + 2]) for s in range(len(pairs))])
        out[name] = float((y.float() - y2.float()).abs().max())
        return y

    with torch.no_grad():
        for name, fn in chain:
            x = probe(name, fn, x)  # the next stage's input: the batch-2N output
        for name, fn in heads:
            probe(name, fn, x)
    return out


def phase_multi_sequence(ba_line):
    """``MultiSequenceSLAM`` over 4 sequences at the main path's widths (K =
    400, 18 layers at bf16, lines, batched BA), the counters reset just
    before the timed run. Gated: at step 0 the batched features agree with
    each frontend's serial ``extract_pair`` on the card
    (:func:`_step0_agreement`: ≥ 99% of the keypoints at the same position,
    their scores within 1e-3, stereo flags and uR within 1e-3 px on ≥ 95%),
    and K1 is batch-invariant (:func:`_superpoint_batch_invariance`: the
    pairing is loose because cuDNN's convolutions are not);
    every batched extraction launches K1 once over the 2N
    images and its side mode N times, and every batched match (stereo and
    temporal) launches K2 and K3 as often as one single match; every
    sequence initializes, passes the inlier gate and the ATE bound; at least
    one batched BA solve of ≥ 2 windows. Measured: aggregate frames/s beside
    the BA path's, stage medians."""
    import torch

    from rspl_slam_tpu_torch.parallel.multi_sequence import MultiSequenceSLAM

    cfg = _ms_cfg()
    t0 = time.perf_counter()
    seqs, trajs = _ms_sequences(cfg)
    render_s = time.perf_counter() - t0
    fes = _ms_frontends(cfg)
    # step 0: batched against serial, and one single match's launches
    pairs0 = [seqs[s][0] for s in range(MS_SEQUENCES)]
    warm = MultiSequenceSLAM(cfg, fes)  # first-call set-up, not timed
    for i in range(2):
        warm.step([(i, 0.05 * i, *seqs[s][i]) for s in range(MS_SEQUENCES)])
    del warm
    single = []
    serial = [_launch_deltas(fe.extract_pair, single)(*pairs0[s]) for s, fe in enumerate(fes)]
    batch_log = []
    batched = _launch_deltas(fes[0].extract_pairs_batched, batch_log)(pairs0, fes)
    step0 = _step0_agreement(batched, serial)
    invariance = _superpoint_batch_invariance(fes[0].sp, pairs0, fes[0].compute_dtype)
    one = single[0]
    torch.cuda.synchronize()

    msq = MultiSequenceSLAM(cfg, fes)
    extract_log, match_log = [], []
    fes[0].extract_pairs_batched = _launch_deltas(fes[0].extract_pairs_batched, extract_log)
    fes[0].match_batched = _launch_deltas(fes[0].match_batched, match_log)
    _reset_counters()
    t0 = time.perf_counter()
    for i in range(MS_FRAMES):
        msq.step([(i, 0.05 * i, *seqs[s][i]) for s in range(MS_SEQUENCES)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counters()
    del fes[0].extract_pairs_batched, fes[0].match_batched  # the instance wrappers

    per_seq = []
    for slam, traj in zip(msq.slams, trajs):
        inl = [int(r.num_inliers) for r in slam.records[1:]]
        per_seq.append({"initialized": slam.initialized, "keyframes": int(slam.map.n_kf),
                        "ate_rmse_m": _ate(slam.records, traj),
                        "keyframe_ate_rmse_m": _keyframe_ate(slam.map, traj),
                        "frames_over_min_inliers": sum(n > E2E_MIN_INLIERS for n in inl),
                        "inliers_min": min(inl), "maplines": int(slam.map.n_ln)})
    timings = dict(msq.timings)
    for slam in msq.slams:
        for k, v in slam.timings.items():
            timings.setdefault(k, []).extend(v)
    stage_keys = ("superglue_layer", "sinkhorn")
    bad_extract = [d for d in extract_log
                   if d["conv_stem"] != 1 or d["conv_stem_side"] != MS_SEQUENCES
                   or any(d[k] != one[k] for k in stage_keys)]
    bad_match = [d for d in match_log if any(d[k] != one[k] for k in stage_keys)]
    agg = MS_SEQUENCES * MS_FRAMES / wall
    line = {"phase": "multi_sequence", "sequences": MS_SEQUENCES, "frames": MS_FRAMES,
            "image": [cfg.camera.image_width, cfg.camera.image_height],
            "max_keypoints": cfg.superpoint.max_keypoints,
            "gnn_layers": cfg.superglue.num_gnn_layers, "use_lines": cfg.use_lines,
            "yaw_rates": [0.002 * (s + 1) for s in range(MS_SEQUENCES)],
            "step0": {**step0, "gates": {"position_share": MS_POSITION_SHARE,
                                         "score_atol": MS_SCORE_ATOL,
                                         "stereo_flag_share": MS_STEREO_SHARE,
                                         "ur_share": MS_STEREO_SHARE,
                                         "ur_atol_px": MS_MEAS_ATOL_PX}},
            "superpoint_batch_2n_vs_2_max_diff": invariance,
            "single_match_launches": one, "batched_extract_calls": len(extract_log),
            "batched_match_calls": len(match_log),
            "extract_launches_first": extract_log[0] if extract_log else None,
            "match_launches_first": match_log[0] if match_log else None,
            "extract_calls_off": bad_extract, "match_calls_off": bad_match,
            "ba_solves": msq.ba_solves, "sequences_detail": per_seq,
            "aggregate_frames_per_s": agg, "wall_s": wall,
            "end_to_end_ba_frames_per_s": ba_line["frames_per_s"] if ba_line else None,
            "stage_median_ms": {k: float(np.median(v)) * 1e3 for k, v in timings.items()},
            "stage_note": "extract / match / track / ba: host ms per step of "
                          "MultiSequenceSLAM's stages (extract and match end in their "
                          "one copy down); pose_opt, kf_insert: per sequence and frame",
            "render_s": render_s, "ate_bound_m": E2E_ATE_BOUND, "launches": launches}
    emit(line)
    fails = []
    if not (min(step0["position_share"]) >= MS_POSITION_SHARE
            and max(step0["score_max_diff"]) <= MS_SCORE_ATOL
            and min(step0["stereo_flag_share"]) >= MS_STEREO_SHARE
            and min(step0["ur_share"]) >= MS_STEREO_SHARE):
        fails.append(f"step 0 batched against serial: {step0}")
    if invariance["K1 conv1b + pool"] != 0.0:
        fails.append(f"K1 is not batch-invariant: {invariance}")
    if bad_extract or bad_match or len(extract_log) != MS_FRAMES:
        fails.append(f"launches per batched call: extract {bad_extract}, match {bad_match}")
    for s, d in enumerate(per_seq):
        if not d["initialized"] or d["frames_over_min_inliers"] < 0.8 * (MS_FRAMES - 1):
            fails.append(f"sequence {s} did not initialize or track: {d}")
        if not d["ate_rmse_m"] < E2E_ATE_BOUND:
            fails.append(f"sequence {s}: ATE {d['ate_rmse_m']} over {E2E_ATE_BOUND}")
    if not msq.ba_solves or max(msq.ba_solves) < 2:
        fails.append(f"no batched BA solve of >= 2 windows: {msq.ba_solves}")
    if fails:
        raise AssertionError("multi_sequence: " + "; ".join(fails))
    return line, launches, msq


def _ba_kw(cfg) -> dict:
    o, b = cfg.optimization, cfg.optimization.backend
    return dict(chi2_mono=b.mono_point, chi2_stereo=b.stereo_point,
                chi2_mono_line=b.mono_line, chi2_stereo_line=b.stereo_line,
                iters1=o.ba_iters_phase1, iters2=o.ba_iters_phase2)


def phase_batched_ba(msq):
    """Each sequence's last window (4 windows of one capacity, captured on
    the multi-sequence BA path) solved in one batched solve and one by one
    on the card. Gated, per window: the first LM step's reduced camera
    system (S, g̃, cost: ``local_ba.reduced_camera_system`` under the
    batched solve's ``vmap`` over ``dist_ba.upload_windows`` and alone),
    assembled in f64, within ``DIST_SYSTEM_RTOL`` (relative to the largest
    entry) of the single one's; camera positions within 1e-4 m of the
    single solve, in f32 where f32 determines the window to that (the
    single solve of its points nudged by ``DIST_NUDGE``, 1e-7 relative,
    moves less than 1e-4 m), and on every window with both solves run on
    the problem's f64 copy, where no f32 rounding can move the LM's
    accept decisions and the chi² gate; the f32 inlier flags equal on
    ≥ 99% of the valid constraints. Measured: the nudge spreads,
    CUDA-event ms and launches (torch.profiler) of the batched solve
    against the 4 single solves together."""
    import torch

    from rspl_slam_tpu_torch.backend import local_ba
    from rspl_slam_tpu_torch.parallel import dist_ba

    K, kw, dev = msq.slams[0].K, _ba_kw(msq.cfg), msq.slams[0].device
    chi2 = {k: kw[k] for k in ("chi2_mono", "chi2_stereo", "chi2_mono_line", "chi2_stereo_line")}
    probs, maps = [], []
    for slam in msq.slams:
        prob, mapping = slam.gather_ba_problem(int(slam.map.n_kf) - 1)
        if prob is not None:
            probs.append(prob)
            maps.append(mapping)

    def batched():
        return dist_ba.batched_windows_ba(K, probs, device=dev, **kw)

    def singles():
        return [local_ba.optimize_local_map(K, local_ba.upload_problem(p, dev), **kw)
                for p in probs]

    def f64(prob):
        return prob._replace(**{f: v.double() for f, v in zip(prob._fields, prob)
                                if torch.is_tensor(v) and v.is_floating_point()})

    got = dist_ba.fetch_windows(batched())
    ref = [local_ba.fetch_result(r) for r in singles()]
    nudged = [local_ba.fetch_result(local_ba.optimize_local_map(
        K, local_ba.upload_problem(p._replace(points=(np.asarray(p.points) * (1 + DIST_NUDGE))
                                              .astype(np.float32)), dev), **kw))
        for p in probs]
    # the batched solve's function (batched_windows_ba's vmap) on the f64 copy
    got64 = dist_ba.fetch_windows(torch.func.vmap(lambda p: local_ba._solve(
        K, p, tuple(chi2.values()), kw["iters1"], kw["iters2"]))(
            f64(dist_ba.upload_windows(probs, dev))))
    ref64 = [local_ba.fetch_result(local_ba.optimize_local_map(
        K, f64(local_ba.upload_problem(p, dev)), **kw)) for p in probs]
    sys_b = torch.func.vmap(lambda p: local_ba.reduced_camera_system(
        K, p, None, torch.float64, **chi2))(dist_ba.upload_windows(probs, dev))
    systems = []
    for w, p in enumerate(probs):
        one = local_ba.reduced_camera_system(K, local_ba.upload_problem(p, dev), None,
                                             torch.float64, **chi2)
        rel = [float((b[w] - o).abs().max() / o.abs().max().clamp_min(1e-300))
               for b, o in zip(sys_b, one)]
        systems.append(dict(zip(("S_rel", "g_rel", "cost_rel"), rel)))
    pos = lambda T: np.linalg.inv(T.astype(np.float64))[:, :3, 3]  # noqa: E731

    def dist(a, b, m):
        n = len(m["frames"])
        return float(np.abs(pos(a.Tcw[:n]) - pos(b.Tcw[:n])).max())

    pose_diffs = [dist(g, r, m) for g, r, m in zip(got, ref, maps)]
    spreads = [dist(q, r, m) for q, r, m in zip(nudged, ref, maps)]
    determined = [sp <= BATCHED_BA_POSE_ATOL_M for sp in spreads]
    pose_diffs64 = [dist(g, r, m) for g, r, m in zip(got64, ref64, maps)]
    agree = [float((g.p_inlier[: m["ncp"]] == r.p_inlier[: m["ncp"]]).mean())
             for g, r, m in zip(got, ref, maps)]
    ms_b = time_ms(batched, n=3, warmup=1)
    ms_s = time_ms(singles, n=3, warmup=1)
    counts = {}
    for name, fn in (("batched", batched), ("singles", singles)):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts[name] = _count_launches(prof)
    line = {"phase": "batched_ba", "windows": len(probs),
            "frames": [len(m["frames"]) for m in maps], "ncp": [int(m["ncp"]) for m in maps],
            "ncl": [int(m["ncl"]) for m in maps],
            "capacity": {"F": int(probs[0].Tcw.shape[0]), "P": int(probs[0].points.shape[0]),
                         "L": int(probs[0].lines.shape[0]), "Cp": int(len(probs[0].p_valid)),
                         "Cl": int(len(probs[0].l_valid))},
            "first_system_f64": systems, "system_rtol": DIST_SYSTEM_RTOL,
            "pose_diff_m": pose_diffs, "single_nudge_spread_m": spreads,
            "f32_determined": determined, "pose_diff_f64_m": pose_diffs64,
            "pose_atol_m": BATCHED_BA_POSE_ATOL_M, "nudge": DIST_NUDGE,
            "inlier_agreement": agree, "inlier_share_min": BATCHED_BA_INLIER_SHARE,
            "costs_batched": [float(g.cost) for g in got],
            "costs_single": [float(r.cost) for r in ref],
            "costs_f64_batched_single": [[float(g.cost), float(r.cost)]
                                         for g, r in zip(got64, ref64)],
            "ms_batched": ms_b, "ms_singles_sum": ms_s,
            "launches_batched": counts["batched"], "launches_singles_sum": counts["singles"]}
    emit(line)
    ok = (len(probs) >= 2
          and all(v <= DIST_SYSTEM_RTOL for s_ in systems for v in s_.values())
          and all(d <= BATCHED_BA_POSE_ATOL_M for d, det in zip(pose_diffs, determined) if det)
          and all(d <= BATCHED_BA_POSE_ATOL_M for d in pose_diffs64)
          and min(agree) >= BATCHED_BA_INLIER_SHARE)
    if not ok:
        raise AssertionError(f"batched_ba: {line}")
    return line


def _dist_system(cfg):
    """A SLAMSystem to load ``dist_ba``'s map into (its frontend unused)."""
    from rspl_slam_tpu_torch.evaluation import synthetic
    from rspl_slam_tpu_torch.frontend.frontends import OracleFrontend
    from rspl_slam_tpu_torch.slam import SLAMSystem

    scene = synthetic.make_scene(num_points=8, num_lines=0)
    return SLAMSystem(cfg, OracleFrontend(cfg, scene, device="cuda"), enable_ba=False)


def _dist_rank(argv) -> int:
    """One rank of ``dist_ba`` (``chip_smoke.py --dist-ba-rank <rank> <world>
    <port> <work dir>``): joins the process group on localhost, runs the
    sharded solve of ``problem.npz`` twice (``dist_ba.collective_traffic``)
    and its first reduced camera system, the sharded solve of
    ``small.npz``, then ``run_global_ba(mesh=)`` on ``map.npz``, and writes
    ``rank<r>.npz`` with the devices its results lie on."""
    rank, world, port, work = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    from rspl_slam_tpu_torch.backend import local_ba
    from rspl_slam_tpu_torch.backend.local_ba import BAProblem
    from rspl_slam_tpu_torch.parallel import dist_ba, multihost

    backend = multihost.initialize(f"tcp://localhost:{port}", world, rank, device="cuda",
                                   timeout_s=DIST_TIMEOUT_S)
    mesh = multihost.global_mesh(device="cuda")
    cfg = _ms_cfg()
    prob, small = ([z[f] for f in BAProblem._fields[:15]] for z in (
        np.load(os.path.join(work, name)) for name in ("problem.npz", "small.npz")))
    prob, small = BAProblem(*prob), BAProblem(*small)
    slam = _dist_system(cfg)
    kw = _ba_kw(cfg)
    runs, ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t = dist_ba.collective_traffic(slam.K, prob, mesh, **kw)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        runs.append(t)
    chi2 = {k: kw[k] for k in ("chi2_mono", "chi2_stereo", "chi2_mono_line", "chi2_stereo_line")}
    S, g, c = local_ba.reduced_camera_system(slam.K, prob, mesh, **chi2)
    S64, g64, c64 = local_ba.reduced_camera_system(slam.K, prob, mesh, torch.float64, **chi2)
    sm = dist_ba.sharded_constraints_ba(slam.K, small, mesh, **kw)
    slam.resume_from_map(os.path.join(work, "map.npz"))
    g_cost = slam.run_global_ba(mesh=mesh)
    results = [t["result"] for t in runs] + [sm, (S, g, c, S64, g64, c64)]
    out = {"backend": backend, "mesh_device": str(mesh.device), "ms": ms,
           "result_devices": sorted({str(x.device) for r in results for x in r}),
           **{k: v.cpu().numpy() for k, v in (("S", S), ("g", g), ("c", c), ("S64", S64),
                                              ("g64", g64), ("c64", c64))},
           "small_Tcw": sm.Tcw.cpu().numpy(), "small_points": sm.points.cpu().numpy(),
           "floats_per_step": runs[0]["floats_per_step"], "lm_steps": runs[0]["lm_steps"],
           "floats_total": runs[0]["floats_total"], "g_cost": g_cost,
           "g_kf_pose": slam.map.kf_pose[: slam.map.n_kf]}
    for i, t in enumerate(runs):
        r = t["result"]
        out.update({f"run{i}_{k}": getattr(r, k).cpu().numpy()
                    for k in ("Tcw", "points", "lines", "p_inlier", "l_inlier", "cost")})
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def save_compact_map(m, path) -> None:
    """Save map ``m`` with its capacities cut to the powers of two above
    what it holds, or kept where it is full (a default-capacity checkpoint
    holds ~1 GB of arrays, nearly all empty): every array sliced to the
    smaller store's shape."""
    from rspl_slam_tpu_torch.backend.map_store import MapStore

    def cap(n, full):  # the power of two above n, at most the capacity
        return min(1 << int(n).bit_length(), full)

    small = MapStore(m.K, m.LN, dataclasses.replace(
        m.cfg, max_map_keyframes=cap(m.n_kf, len(m.kf_valid)),
        max_map_points=cap(m.n_pt, len(m.pt_status)),
        max_map_lines=cap(m.n_ln, len(m.ln_valid))), desc_dim=m.pt_desc.shape[1])
    for k, v in vars(m).items():
        if isinstance(v, np.ndarray):
            dst = getattr(small, k)
            dst[...] = v[tuple(slice(0, n) for n in dst.shape)]
        elif k != "cfg":
            setattr(small, k, v)
    small.save(path)


def phase_dist_ba(small):
    """The landmark-sharded solve in 2 ranks on the one card (processes of
    this script, ``_dist_rank``; the backend named on the line) on two
    global BA problems, against the single-process solve of the same
    problem, run first, alone on the card: ``small``, the first sequence's
    map of ``multi_sequence`` (3 keyframes), and the loop path's map
    (:data:`DIST_MAP`, saved by that path, BA on, before its closing
    passes: the largest map of the smoke; the BA path's holds 5
    keyframes), on which ``run_global_ba(mesh=)`` runs too.

    Gated: every rank's results on the card; ``small``'s full schedule
    within JAX's sharded-solve tolerances of the single solve's (Tcw 1e-3,
    points 1e-2). On the loop map: the first LM step's summed reduced
    camera system S, g̃ and cost (``local_ba.reduced_camera_system``),
    assembled in f64, within 1e-9 (relative to the largest entry) of the
    single solve's, which proves the same function; the full schedule's two
    runs and the two ranks equal bit for bit, each LM step passing
    ``expected_collective_floats`` floats, its robust objective no higher
    than at the start, and ``run_global_ba(mesh=)``'s cost equal to it bit
    for bit (the same problem). The loop map's full schedule is not held to
    the single solve's poses: there the f32 system carries rounding errors
    of the order of its largest entries (S in f32 against S in f64 is on
    the line, for the single solve and the sharded one), and the LM's
    accept decisions and the chi² gate carry any change of summation order
    into the poses; its distance is measured beside the single solve's own
    under a 1e-7 nudge of its start."""
    import torch

    from rspl_slam_tpu_torch.backend import local_ba
    from rspl_slam_tpu_torch.parallel import dist_ba

    work = os.path.dirname(DIST_MAP)
    cfg = _ms_cfg()
    slam = _dist_system(cfg)
    slam.resume_from_map(DIST_MAP)
    prob, mapping = slam.global_ba_problem()
    for name, p in (("problem.npz", prob), ("small.npz", small)):
        np.savez(os.path.join(work, name),
                 **{f: np.asarray(getattr(p, f)) for f in local_ba.BAProblem._fields[:15]})
    kw = _ba_kw(cfg)
    chi2 = {k: kw[k] for k in ("chi2_mono", "chi2_stereo", "chi2_mono_line", "chi2_stereo_line")}

    def single(p=prob):
        return local_ba.fetch_result(local_ba.optimize_local_map(
            slam.K, local_ba.upload_problem(p, slam.device), **kw))

    single_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        ref = single()
        single_ms.append((time.perf_counter() - t0) * 1e3)
    nudged = single(prob._replace(points=(prob.points * (1 + DIST_NUDGE)).astype(np.float32)))
    small_ref = single(small)
    prob_dev = local_ba.upload_problem(prob, slam.device)
    S1, g1, c1 = local_ba.reduced_camera_system(slam.K, prob_dev, **chi2)
    S64, g64, c64 = local_ba.reduced_camera_system(slam.K, prob_dev, None, torch.float64,
                                                   **chi2)
    g_cost = slam.run_global_ba()
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                               "--dist-ba-rank", str(r), str(DIST_RANKS), str(port), work],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(DIST_RANKS)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=DIST_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"dist_ba: a rank exited {p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(DIST_RANKS)]
    r0 = ranks[0]
    F, P, L = (int(prob.Tcw.shape[0]), int(prob.points.shape[0]), int(prob.lines.shape[0]))
    fields = ("Tcw", "points", "lines", "p_inlier", "l_inlier", "cost")
    repeat = all(np.array_equal(r[f"run0_{k}"], r[f"run1_{k}"]) for r in ranks for k in fields)
    ranks_equal = all(np.array_equal(r[k], r0[k]) for r in ranks[1:] for k in r0 if k != "ms")
    devices = sorted({str(d) for r in ranks for d in r["result_devices"]})
    sharded = local_ba.BAResult(**{k: torch.as_tensor(r0[f"run0_{k}"], device=slam.device)
                                   for k in fields})
    objective = {k: float(local_ba.robust_objective(slam.K, prob_dev, r, **chi2))
                 for k, r in (("start", None), ("sharded", sharded))}
    err = lambda a, b: float(np.abs(np.asarray(a, np.float64) - b).max())  # noqa: E731
    S1, g1, c1, S64, g64, c64 = (x.cpu().double().numpy() for x in (S1, g1, c1, S64, g64, c64))
    S_max, g_max = float(np.abs(S64).max()), float(np.abs(g64).max())
    system = {"f64": {"S_rel": err(r0["S64"], S64) / S_max, "g_rel": err(r0["g64"], g64) / g_max,
                      "cost_rel": err(r0["c64"], c64) / abs(float(c64))},
              "f32": {"S_sharded_vs_single": err(r0["S"], S1), "S_single_vs_f64": err(S1, S64),
                      "S_sharded_vs_f64": err(r0["S"], S64),
                      "g_sharded_vs_single": err(r0["g"], g1), "g_single_vs_f64": err(g1, g64),
                      "cost": [float(r0["c"]), float(c1)]},
              "S_max": S_max, "g_max": g_max}

    def dist(a, b):  # full-schedule distance of result b from a
        return {"tcw": float(np.abs(a.Tcw - b["Tcw"]).max()),
                "points": float(np.abs(a.points - b["points"]).max()),
                "cost": [float(b["cost"]), float(a.cost)],
                "inlier_agreement": float((a.p_inlier == b["p_inlier"]).mean())}

    line = {"phase": "dist_ba", "ranks": DIST_RANKS, "backend": str(r0["backend"]),
            "mesh_devices": [str(r["mesh_device"]) for r in ranks],
            "result_devices": devices,
            "small": {"F": int(small.Tcw.shape[0]), "P": int(small.points.shape[0]),
                      "L": int(small.lines.shape[0]),
                      "tcw_max_diff": float(np.abs(r0["small_Tcw"] - small_ref.Tcw).max()),
                      "points_max_diff": float(np.abs(r0["small_points"]
                                                      - small_ref.points).max())},
            "map": {"source": "end_to_end_loop, before its closing passes",
                    "keyframes": int(slam.map.n_kf), "mappoints": int(slam.map.n_pt),
                    "maplines": int(slam.map.n_ln)},
            "problem": {"F": F, "P": P, "L": L, "Cp": int(len(prob.p_valid)),
                        "Cl": int(len(prob.l_valid)), "frames": len(mapping["frames"]),
                        "ncp": int(mapping["ncp"]), "ncl": int(mapping["ncl"])},
            "first_system": system, "system_rtol": DIST_SYSTEM_RTOL,
            "full_sharded_vs_single": dist(ref, {k: r0[f"run0_{k}"] for k in fields}),
            "full_single_nudged_vs_single": dist(ref, nudged._asdict()),
            "nudge": DIST_NUDGE, "robust_objective": objective,
            "global_ba_cost": {"mesh": float(r0["g_cost"]), "single": g_cost},
            "repeat_bit_for_bit": repeat, "ranks_bit_for_bit": ranks_equal,
            "floats_per_step": int(r0["floats_per_step"]),
            "bytes_per_step": 8 * int(r0["floats_per_step"]),
            "expected_floats_per_step": dist_ba.expected_collective_floats(F),
            "jax_psum_floats_per_step": F * 42 + P * (12 + 18 * F) + L * (20 + 24 * F) + 1,
            "lm_steps": int(r0["lm_steps"]), "floats_total": int(r0["floats_total"]),
            "sharded_ms": [float(x) for x in r0["ms"]], "single_ms": single_ms,
            "tolerance": f"small: Tcw {DIST_TCW_ATOL}, points {DIST_POINTS_ATOL}; loop map: "
                         f"S, g̃, cost in f64 within {DIST_SYSTEM_RTOL} relative"}
    emit(line)
    if not (all(d.startswith("cuda") for d in devices)
            and all(str(r["mesh_device"]).startswith("cuda") for r in ranks)
            and line["small"]["tcw_max_diff"] <= DIST_TCW_ATOL
            and line["small"]["points_max_diff"] <= DIST_POINTS_ATOL
            and max(system["f64"].values()) <= DIST_SYSTEM_RTOL
            and repeat and ranks_equal
            and line["floats_per_step"] == line["expected_floats_per_step"]
            and objective["sharded"] <= objective["start"]
            and float(r0["g_cost"]) == float(r0["run0_cost"])):
        raise AssertionError(f"dist_ba: {line}")
    return line


def phase_batch_kernels(lines):
    """Each kernel against its plain version at the multi-sequence path's
    batch (N = 4): K1 over the 2N images of a step (8, 480, 752, 64), K2
    bf16 on the N stacked stereo problems (8, 400, 256), K3 at (4, 401,
    401); each listed in its kernel line's ``checks``."""
    import torch

    from rspl_slam_tpu_torch.ops import attention_cuda as ac

    n = MS_SEQUENCES
    k1 = _conv_case(2 * n, 480, 752, False, 20)
    gen = torch.Generator(device="cuda").manual_seed(21)
    layer = ac.pack_layer(_random_layer(gen, 256, "cuda"), "cuda")
    ok2, errs, x, masks, scratch = _layer_case(ac, gen, layer, 400, 331, torch.bfloat16,
                                               2.0 ** -8, 4e-3, n2=2 * n)
    k2_ms = time_ms(lambda: ac.superglue_layer(x, masks, layer, True,
                                               compute_dtype=torch.bfloat16, scratch=scratch))
    k2_plain = time_ms(lambda: ac.superglue_layer_plain(x, masks, layer, True,
                                                        compute_dtype=torch.bfloat16))
    _, _, k2_bound, k2_by = _layer_bound(ac, layer, x, torch.bfloat16)
    k3 = _sinkhorn_case(gen, 400, 400, 371, 352, matcher=False, plain_n=2, B=n)
    checks = {
        "conv_stem": {k: k1[k] for k in ("shape", "ok", "max_abs_err", "ms", "plain_ms",
                                         "library_ms", "bound_ms", "bound_fraction")},
        "superglue_layer": {"shape": [2 * n, 400, 256], "valid": [400, 331], "ok": ok2,
                            "max_abs_err_self_cross": errs, "ms": k2_ms,
                            "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by": k2_by},
        "sinkhorn": {k: k3[k] for k in ("shape", "ok", "max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_fraction")}}
    emit({"phase": "kernels_at_batch_n", "sequences": n, **checks})
    for name, c in checks.items():
        lines[name].setdefault("checks", []).append({"batch_n": n, **c})
    if not (k1["ok"] and ok2 and k3["ok"]):
        raise AssertionError(f"kernels_at_batch_n disagree: {checks}")


# ---------------------------------------------------------------- the CLI
WORK = os.path.join(ROOT, "_smoke_work")  # git-ignored; removed at the end
DIST_MAP = os.path.join(WORK, "dist_ba", "map.npz")  # the loop path's map, for dist_ba
CLI_ATE_BOUND = E2E_ATE_BOUND
# the native route (host remap in f32 of float frames) against --no-native
# (the same remap on the card after the 8-bit upload): the largest keyframe
# position difference allowed, with the same keyframes. The two routes'
# frames differ by up to one f32 ulp (5.96e-8 on each of the 30 frames on
# an H100: PyTorch's CUDA division by a scalar multiplies by its
# reciprocal, the host divides), which a top-k or RANSAC decision can
# carry into the poses; 1 mm is what the CPU parity tests allow two
# implementations on the same frames (tests/test_torch_slam.py). Measured
# on the H100: equal trajectories.
NATIVE_ROUTE_POS_TOL = 1e-3
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


def _cli_concurrent(*argvs, timeout: int = 600) -> list:
    """``python -m rspl_slam_tpu_torch.cli`` in subprocesses from the
    checkout's root, as a user runs it, with PyYAML, PIL and matplotlib
    hidden: one per argument list, all at once on the one card; their
    outputs in order. Raises on a non-zero exit (or a timeout) and kills
    what still runs when it raises."""
    return _cli_wait(_cli_start(*argvs), timeout=timeout)


_STARTED = []  # every CLI process started: main kills what still runs on its way out


def _cli_start(*argvs) -> list:
    """Start :func:`_cli_concurrent`'s processes and return at once: a
    phase starts them, runs its in-process half beside them and gates them
    with :func:`_cli_wait`. Each writes to files of its own (no pipe fills
    while nobody reads it)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([_hidden_modules_dir(), ROOT])}
    logs = os.path.join(WORK, "cli_logs")
    os.makedirs(logs, exist_ok=True)
    started = []
    for a in argvs:
        n = len(_STARTED)
        out, err = (open(os.path.join(logs, f"{n}.{k}"), "w+") for k in ("out", "err"))
        proc = subprocess.Popen([sys.executable, "-m", "rspl_slam_tpu_torch.cli", *a], cwd=ROOT,
                                env=env, stdout=out, stderr=err, text=True)
        _STARTED.append(proc)
        started.append((a, proc, out, err))
    return started


def _cli_wait(started, timeout: int = 600) -> list:
    """The outputs of :func:`_cli_start`'s processes, in order, each
    waited for at most ``timeout`` s. Raises on a non-zero exit (or a
    timeout) and kills what still runs when it raises."""
    outs = []
    try:
        for argv, proc, out, err in started:
            proc.wait(timeout=timeout)
            out.seek(0)
            err.seek(0)
            text, etext = out.read(), err.read()
            if proc.returncode != 0:
                raise AssertionError(f"cli {argv[0]} exited {proc.returncode}:\n"
                                     f"{text[-4000:]}\n{etext[-4000:]}")
            outs.append(text)
    finally:
        for _, proc, out, err in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()
    return outs


def stop_background():
    """Kill every CLI process still running and end the prerender pool."""
    for proc in _STARTED:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stop_prerender()


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


def _native_fed(slam, tree, cfg):
    """The CLI's default route in process: ``native.NativeStereoLoader``
    (C++ decode threads, rectifying with both eyes' maps) feeding
    ``PipelinedRunner.feed`` / ``run_manual``; ``slam``'s frontend must
    not rectify again (``rectify=False``)."""
    import threading

    from rspl_slam_tpu_torch import native
    from rspl_slam_tpu_torch.camera import build_rectify_maps
    from rspl_slam_tpu_torch.datasets import open_dataset
    from rspl_slam_tpu_torch.pipeline import PipelinedRunner

    ds = open_dataset(tree)
    cam = cfg.camera
    runner = PipelinedRunner(slam, queue_depth=cfg.pipeline.queue_depth)
    with native.NativeStereoLoader(*ds.file_lists(), cam.image_height, cam.image_width,
                                   map_l=build_rectify_maps(cam, "left"),
                                   map_r=build_rectify_maps(cam, "right"),
                                   depth=cfg.pipeline.queue_depth) as loader:
        def feeder():
            try:
                for i, il, ir in loader:
                    runner.feed(i, ds.timestamp(i), il, ir)
            finally:
                runner.close_input()

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        records = runner.run_manual()
        th.join()
    return records


def _traj_distance(a: str, b: str) -> dict:
    """Two TUM trajectory texts: whether their keyframe times agree and the
    largest position difference (m) where they do."""
    ra = np.array([[float(v) for v in ln.split()] for ln in a.splitlines()]).reshape(-1, 8)
    rb = np.array([[float(v) for v in ln.split()] for ln in b.splitlines()]).reshape(-1, 8)
    same_times = ra.shape == rb.shape and np.array_equal(ra[:, 0], rb[:, 0])
    return {"keyframes": [len(ra), len(rb)], "same_keyframes": bool(same_times),
            "max_position_diff_m": float(np.abs(ra[:, 1:4] - rb[:, 1:4]).max())
            if same_times and len(ra) else None}


def phase_cli_run():
    """The user's command on the card: ``python -m rspl_slam_tpu_torch.cli
    run --config configs/euroc.yaml`` (the default main path: lines, async
    BA; the algorithm section equals ``SystemConfig()``) on the BA path's
    30 frames quantized to 8 bits and written as a raw-EuRoC tree, with the
    smoke's weights as ``.npz`` and an OpenCV camera file, in subprocesses
    run at once beside this process's own runs: twice by default (the
    native prefetcher decodes and rectifies on C++ threads) and once with
    ``--no-native`` (``EurocDataset``, rectification on the card). Each is
    gated on its exit, the frame count, the ATE and
    its trajectory and launches equal to an in-process run of the same
    route (``_native_fed``; ``PipelinedRunner`` over the dataset); the two
    routes' frames and trajectories are held to each other
    (``NATIVE_ROUTE_POS_TOL``); then the decoded frames, the saved map
    (reload and resume), the visualization PNGs and the kernels."""
    import torch

    from rspl_slam_tpu_torch import config, native, png
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
    p = {k: os.path.join(work, k) for k in ("traj.txt", "traj_no_native.txt", "traj_again.txt",
                                              "map.npz",
                                              "map_text", "viz", "inproc.txt",
                                              "inproc_native.txt")}
    common = ("--dataroot", tree, "--config", euroc, "--camera-config", cam_yaml,
              "--sp-weights", os.path.join(work, "sp.npz"),
              "--sg-weights", os.path.join(work, "sg.npz"),
              "--rcf-weights", os.path.join(work, "rcf.npz"), "--gt", tree)
    # the three CLI processes at once on the card, beside this process's
    # runs of both routes below: the native route runs twice and must repeat
    # its trajectory and launches whatever runs beside it
    routes = {"native": ("--traj-path", p["traj.txt"], "--save-map", p["map.npz"],
                         "--save-map-text", p["map_text"], "--viz-dir", p["viz"]),
              "no_native": ("--traj-path", p["traj_no_native.txt"], "--no-native"),
              "native_again": ("--traj-path", p["traj_again.txt"],)}
    t_cli = time.perf_counter()
    started = _cli_start(*[("run", *common, *extra) for extra in routes.values()])

    # the same config, weights and files through each route here
    cfg = load_system_config(euroc, cam_yaml)
    cfg = dataclasses.replace(
        cfg, superpoint=dataclasses.replace(cfg.superpoint, weights_path=os.path.join(work, "sp.npz")),
        superglue=dataclasses.replace(cfg.superglue, weights_path=os.path.join(work, "sg.npz")),
        line_detector=dataclasses.replace(cfg.line_detector,
                                          rcf_weights_path=os.path.join(work, "rcf.npz")))
    fe_native = NeuralFrontend(cfg, rectify=False)
    slam = SLAMSystem(cfg, fe_native)
    _reset_counters()
    t0 = time.perf_counter()
    _native_fed(slam, tree, cfg)
    torch.cuda.synchronize()
    inproc_native_wall = time.perf_counter() - t0
    inproc_native_launches = _counters()
    slam.save_trajectory(p["inproc_native.txt"])
    del slam, fe_native

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
    runs = {}
    for route, out in zip(routes, _cli_wait(started)):
        processed = re.search(r"^processed (\d+) frames in ([0-9.]+)s \(([0-9.]+) fps\)$", out,
                              re.M)
        runs[route] = {
            "out": out, "processed": processed,
            "native_line": "using native prefetcher + rectification" in out.splitlines(),
            "ate": json.loads(re.search(r"^ATE: (.*)$", out, re.M).group(1)),
            "launches": json.loads(re.search(r"^kernel launches: (.*)$", out, re.M).group(1))}
    cli_wall = time.perf_counter() - t_cli
    text = {}
    for k in ("traj.txt", "traj_no_native.txt", "traj_again.txt", "inproc.txt",
              "inproc_native.txt"):
        with open(p[k]) as f:
            text[k] = f.read()

    # the two routes' frames: the loader's host rectification against the
    # frontend's on the card (this camera file's maps lie off the identity
    # by up to 3e-14 px on one column per eye, so both remaps interpolate)
    cam = cfg.camera
    with native.NativeStereoLoader(*ds.file_lists(), cam.image_height, cam.image_width,
                                   map_l=fe._rect_maps[0].cpu().numpy(),
                                   map_r=fe._rect_maps[1].cpu().numpy()) as loader:
        frame_diff, frames_differing = 0.0, 0
        for i, il, ir in loader:
            dev = fe._upload(np.stack(frames_u8[i]), slice(0, 2)).cpu().numpy()
            d = np.abs(np.stack([il, ir]) - dev)
            frame_diff = max(frame_diff, float(d.max()))
            frames_differing += int((d > 0).any())
    route_dist = _traj_distance(text["traj.txt"], text["traj_no_native.txt"])

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
    nat, nn, again = runs["native"], runs["no_native"], runs["native_again"]
    launches = nat["launches"]
    line = {"phase": "cli_run", "frames": int(nat["processed"].group(1)) if nat["processed"] else None,
            "image": [cfg.camera.image_width, cfg.camera.image_height],
            "max_keypoints": cfg.superpoint.max_keypoints,
            "gnn_layers": cfg.superglue.num_gnn_layers,
            "sinkhorn_iters": cfg.superglue.sinkhorn_iterations, "use_lines": cfg.use_lines,
            "async_ba": cfg.pipeline.async_ba, "rectify_maps": fe._rect_maps is not None,
            "card": CARD,
            "native_prefetcher_printed": nat["native_line"],
            "cli_fps_printed": float(nat["processed"].group(3)) if nat["processed"] else None,
            "cli_fps_printed_no_native": float(nn["processed"].group(3))
            if nn["processed"] else None,
            "cli_fps_printed_native_again": float(again["processed"].group(3))
            if again["processed"] else None,
            "cli_wall_s": cli_wall,
            "inproc_frames_per_s": E2E_FRAMES / inproc_wall,
            "inproc_native_frames_per_s": E2E_FRAMES / inproc_native_wall,
            "keyframe_ate_rmse_m": nat["ate"]["rmse"], "ate_n": nat["ate"]["n"],
            "keyframe_ate_rmse_m_no_native": nn["ate"]["rmse"], "ate_bound_m": CLI_ATE_BOUND,
            "decoded_equal": decoded_equal,
            "trajectory_equal_inproc_native": text["traj.txt"] == text["inproc_native.txt"],
            "trajectory_equal_inproc_no_native": text["traj_no_native.txt"] == text["inproc.txt"],
            "trajectory_equal_routes": text["traj.txt"] == text["traj_no_native.txt"],
            "trajectory_equal_native_again": text["traj.txt"] == text["traj_again.txt"],
            "routes": route_dist, "route_pos_tol_m": NATIVE_ROUTE_POS_TOL,
            "route_frame_max_abs_diff": frame_diff,
            "route_frames_differing": frames_differing,
            "keyframes": len(text["traj.txt"].splitlines()),
            "map_keyframes": int(stored.n_kf), "map_points": int(stored.n_pt),
            "map_lines": int(stored.n_ln), "resume_inliers": resume_inliers,
            "viz_pngs": len(viz_png), "hidden_from_cli": list(HIDDEN_MODULES),
            "host_has": host_has, "mini_yaml_equals_pyyaml": mini_equal,
            "launches": launches, "launches_no_native": nn["launches"],
            "inproc_native_launches": inproc_native_launches,
            "inproc_launches": inproc_launches,
            "decode_ms_per_pair_compiled": _decode_ms_per_pair(tree, True, E2E_FRAMES),
            "decode_ms_per_pair_numpy": _decode_ms_per_pair(tree, False, 5),
            "render_s": render_s, "tree_write_s": write_s}
    emit(line)
    for route, r in runs.items():
        if not r["processed"] or int(r["processed"].group(1)) != E2E_FRAMES:
            raise AssertionError(f"cli_run ({route}): expected {E2E_FRAMES} frames "
                                 f"processed:\n{r['out']}")
        if not r["ate"]["rmse"] < CLI_ATE_BOUND or r["ate"]["n"] < 3:
            raise AssertionError(f"cli_run ({route}): ATE {r['ate']} over the bound "
                                 f"{CLI_ATE_BOUND}")
        for k in ("conv_stem", "conv_stem_side", "superglue_layer", "sinkhorn"):
            if r["launches"][k] <= 0:
                raise AssertionError(f"cli_run ({route}): kernel {k} never launched")
    if text["traj.txt"] != text["traj_again.txt"] or again["launches"] != launches:
        raise AssertionError("cli_run: the native route did not repeat its trajectory and "
                             "launches")
    if not nat["native_line"] or nn["native_line"] or not again["native_line"]:
        raise AssertionError("cli_run: the default run must use the native prefetcher and "
                             "--no-native must not")
    if not decoded_equal:
        raise AssertionError("cli_run: the decoded PNG frames differ from the written arrays")
    if text["traj.txt"] != text["inproc_native.txt"]:
        raise AssertionError("cli_run: the CLI's trajectory differs from the in-process "
                             f"native-fed runner's:\n{text['traj.txt']}\n---\n"
                             f"{text['inproc_native.txt']}")
    if text["traj_no_native.txt"] != text["inproc.txt"]:
        raise AssertionError("cli_run: the --no-native trajectory differs from the in-process "
                             f"runner's:\n{text['traj_no_native.txt']}\n---\n{text['inproc.txt']}")
    if not (route_dist["same_keyframes"]
            and route_dist["max_position_diff_m"] <= NATIVE_ROUTE_POS_TOL):
        raise AssertionError(f"cli_run: the native and --no-native routes part: {route_dist}")
    if stored.n_kf != len(text["traj.txt"].splitlines()) or stored.n_pt <= 0:
        raise AssertionError(f"cli_run: the saved map holds {stored.n_kf} keyframes")
    if min(resume_inliers) <= E2E_MIN_INLIERS or not np.isfinite(
            np.stack([r.Twc for r in recs])).all():
        raise AssertionError(f"cli_run: resume_from_map then tracked {resume_inliers}")
    if mini_equal is False:
        raise AssertionError("cli_run: the YAML subset parser disagrees with PyYAML")
    if "trajectory.png" not in viz_png or not any(f.startswith("frame_") for f in viz_png):
        raise AssertionError(f"cli_run: visualization PNGs missing: {viz_png}")
    if launches != inproc_native_launches:
        raise AssertionError(f"cli_run: launches {launches} against {inproc_native_launches} "
                             "in process (native route)")
    if nn["launches"] != inproc_launches:
        raise AssertionError(f"cli_run: --no-native launches {nn['launches']} against "
                             f"{inproc_launches} in process")
    return line, launches, {"work": work, "tree": tree, "euroc": euroc, "cam_yaml": cam_yaml,
                            "cfg": cfg}


def phase_native(tree, merge_inputs):
    """The native runtime (``native.py``, host C++): its build time; decode
    ms per pair over cli_run's 752×480 PNG tree, ``NativeStereoLoader``
    with 2 threads against ``EurocDataset(compiled=True)`` in turns (loader,
    dataset, dataset, loader), the loader's frames equal to the dataset's;
    ``merge_lines`` ms per frame, the compiled merge against the numpy one
    on the lines path's own pre-merge segments (``merge_inputs``), equal
    shapes and within 1e-9; ``real_photo.jpg`` decoded here hashing to
    ``REAL_PHOTO_L_SHA256``."""
    import hashlib

    from rspl_slam_tpu_torch import native, png
    from rspl_slam_tpu_torch.datasets import open_dataset
    from rspl_slam_tpu_torch.ops import cuda_build
    from rspl_slam_tpu_torch.ops import lines as lops

    ds = open_dataset(tree, compiled=True)
    n = len(ds)
    H, W = ds[0].image_left.shape

    def dataset_pass():
        t0 = time.perf_counter()
        got = [ds[i] for i in range(n)]
        return (time.perf_counter() - t0) / n * 1e3, [(f.image_left, f.image_right) for f in got]

    def loader_pass():
        t0 = time.perf_counter()
        with native.NativeStereoLoader(*ds.file_lists(), H, W, threads=2) as loader:
            got = [(il, ir) for _, il, ir in loader]
        return (time.perf_counter() - t0) / n * 1e3, got

    ms = {"loader": [], "dataset": []}
    for name, fn in (("loader", loader_pass), ("dataset", dataset_pass),
                     ("dataset", dataset_pass), ("loader", loader_pass)):
        t, got = fn()
        ms[name].append(t)
        if name == "loader":
            loader_frames = got
        else:
            dataset_frames = got
    frames_equal = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                       for a, b in zip(loader_frames, dataset_frames))

    results = {}
    for mode, force in (("compiled", False), ("numpy", True), ("compiled_2", False),
                        ("numpy_2", True)):
        t0 = time.perf_counter()
        results[mode] = [lops.merge_lines(segs, *args, force_numpy=force)
                         for segs, args in merge_inputs]
        results[mode + "_ms"] = (time.perf_counter() - t0) * 1e3
    frames_merged = len(merge_inputs) / 2  # one merge per eye
    merge_shapes_equal = all(a.shape == b.shape
                             for a, b in zip(results["compiled"], results["numpy"]))
    merge_max_diff = max((float(np.abs(a - b).max()) for a, b in
                          zip(results["compiled"], results["numpy"]) if a.shape == b.shape
                          and a.size), default=0.0)
    merge_bit_equal = sum(np.array_equal(a, b)
                          for a, b in zip(results["compiled"], results["numpy"]))

    photo = png.read_gray(PHOTO)
    photo_sha = hashlib.sha256(np.ascontiguousarray(photo).tobytes()).hexdigest()
    photo_float_equal = np.array_equal(native.decode_gray(PHOTO, *photo.shape),
                                       photo.astype(np.float32) / 255.0)
    line = {"phase": "native", "card": CARD,
            "host_build_s": cuda_build.build_seconds.get("native_runtime"),
            "image": [W, H], "pairs": n,
            "decode_ms_per_pair_loader_2_threads": ms["loader"],
            "decode_ms_per_pair_dataset_compiled": ms["dataset"],
            "loader_frames_equal_dataset": frames_equal,
            "merge_calls": len(merge_inputs), "merge_frames": frames_merged,
            "merge_segments_per_call_median": float(np.median([len(s) for s, _ in merge_inputs]))
            if merge_inputs else 0.0,
            "merge_ms_per_frame_compiled": [results[k] / frames_merged
                                            for k in ("compiled_ms", "compiled_2_ms")],
            "merge_ms_per_frame_numpy": [results[k] / frames_merged
                                         for k in ("numpy_ms", "numpy_2_ms")],
            "merge_shapes_equal": merge_shapes_equal, "merge_max_abs_diff": merge_max_diff,
            "merge_bit_equal_calls": int(merge_bit_equal),
            "photo_shape": list(photo.shape), "photo_sha256": photo_sha,
            "photo_sha256_pinned": REAL_PHOTO_L_SHA256,
            "photo_float_equal_u8_over_255": photo_float_equal}
    emit(line)
    if not frames_equal:
        raise AssertionError("native: the loader's frames differ from EurocDataset's")
    if not merge_inputs:
        raise AssertionError("native: the lines path handed merge_lines no segments")
    if not merge_shapes_equal or merge_max_diff > 1e-9:
        raise AssertionError(f"native: compiled merge_lines against numpy: shapes equal "
                             f"{merge_shapes_equal}, max diff {merge_max_diff}")
    if photo_sha != REAL_PHOTO_L_SHA256 or photo.shape != (600, 512) or not photo_float_equal:
        raise AssertionError(f"native: real_photo.jpg decoded to {photo_sha}, "
                             f"not {REAL_PHOTO_L_SHA256}")
    return line


IMAGE_KINDS = os.path.join(ROOT, "tests", "fixtures", "image_kinds")
IMAGE_KINDS_SEQ = "seq_prog"  # the 752×480 progressive stereo sequence
IMAGE_KINDS_SEQ_FRAMES = 6
IMAGE_KINDS_BASELINE = "seq_baseline"  # its first pair as baseline JPEGs
IMAGE_KINDS_WEBP = "seq_webp"  # its first pair as lossy WebPs at quality 90
IMAGE_KINDS_ZSTD = "seq_zstd"  # its first rendered pair as ZSTD TIFFs (libzstd; no zstd here)
DECODE_TIMING_PAIRS = 10  # pairs of each PGM / PNG / TIFF / BMP tree in the decode timing
# the sequence's keyframe trigger: fewer matches than this (every frame,
# at 400 keypoints) makes a keyframe
IMAGE_KINDS_ALL_KEYFRAMES = 1000


def _u8_sha256(u8) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(u8).tobytes()).hexdigest()


def _write_pgm(path, img, kind: str) -> None:
    """(H, W) uint8 as a 16-bit binary PGM (P5, maxval 65535, the same
    sample values: PIL reads them in mode "I" and ``convert("L")`` keeps
    every value up to 255) or as a plain one (P2, maxval 255, a comment in
    the header, fixed-width samples, one image row per line)."""
    H, W = img.shape
    if kind == "P5":
        data = b"P5\n%d %d\n65535\n" % (W, H) + img.astype(">u2").tobytes()
    else:
        v = img.astype(np.int64)
        text = np.full((H, W, 4), ord(" "), np.uint8)
        text[..., 0] = np.where(v >= 100, 48 + v // 100, 32)
        text[..., 1] = np.where(v >= 10, 48 + v // 10 % 10, 32)
        text[..., 2] = 48 + v % 10
        text[:, -1, 3] = ord("\n")
        data = b"P2\n# plain graymap\n%d %d\n255\n" % (W, H) + text.tobytes()
    with open(path, "wb") as f:
        f.write(data)


def _image_kinds_encoders():
    """``tests/torch_make_image_kinds.py``, the fixtures' TIFF and BMP
    encoders (numpy only: no PIL on the card's machine)."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_make_image_kinds

    return torch_make_image_kinds


# the TIFF kinds of image_kinds: (bits, compression, predictor) of a frame
TIFF_KINDS = {"tiff_16bit_lzw_pred2": (16, 5, 2), "tiff_lzma_pred2": (8, 34925, 2),
              "tiff_raw": (8, 1, 1), "tiff_lzw_pred2": (8, 5, 2), "tiff_deflate": (8, 8, 1)}


def _write_tiff(job) -> None:
    """One frame as a TIFF of ``TIFF_KINDS[kind]`` in 16-row strips (the
    LZW encoder is Python, LZMA the standard library's ``lzma``:
    image_kinds runs these in a process pool)."""
    path, kind, u8 = job
    bits, compression, predictor = TIFF_KINDS[kind]
    data = _image_kinds_encoders().encode_tiff(u8.astype(np.int64), bits=bits,
                                               compression=compression, predictor=predictor,
                                               rows_per_strip=16)
    with open(path, "wb") as f:
        f.write(data)


def _write_thunderscan(path, u8) -> None:
    """A frame's top 4 bits as a ThunderScan TIFF (16-row strips), every
    pixel a raw-pixel code (the fixtures' writer picks among all codes at
    random in Python, too slow for 752 × 480; this one is numpy)."""
    mk = _image_kinds_encoders()
    img4 = (u8 >> 4).astype(np.int64)
    data = mk.encode_tiff(img4, bits=4, compression=32809, rows_per_strip=16,
                          codec=lambda blk: (0xC0 | blk[..., 0]).astype(np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(data)


# pairs of the timing-only TIFF codecs (YCbCr LZW, old-style JPEG) that
# image_kinds writes; its (d) writes whole JPEG-in-TIFF and Group 4 trees
TIFF_CODEC_TIMING_PAIRS = 4


def _write_tiff_codec(job) -> None:
    """One frame as a TIFF of a libtiff codec (the encoders are Python:
    image_kinds runs these in a process pool), and, where ``png_path`` is
    given, the pixels PIL decodes from it as an 8-bit PNG there:

    - "jpeg_ycc420": YCbCr 4:2:0 new-style JPEG, 16-row strips, one
      JPEGTables stream of the quantization and Huffman tables (PNG: the
      port's decode of it; the fixture ``tiff_jpeg_ycc420.tif`` of this
      layout pins PIL's hash);
    - "ccitt_g4": the frame dithered as PIL's ``convert("1")`` dithers it,
      as one Group 4 strip (PNG: the dithered pixels, which PIL reads
      back);
    - "ycbcr22_lzw": YCbCr 2×2 under LZW, 16-row strips (libtiff's RGBA
      interface);
    - "ojpeg22": old-style JPEG 4:2:0 from JPEGQ/DC/ACTables, 16-row strips
      of one restart interval each."""
    from rspl_slam_tpu_torch import png

    path, kind, u8, png_path = job
    mk = _image_kinds_encoders()
    ycc = mk.rgb_to_ycbcr(np.dstack([u8] * 3))
    if kind == "jpeg_ycc420":
        data = mk.encode_tiff_jpeg(ycc, 6, (2, 2), "all", rows_per_strip=16)
    elif kind == "ccitt_g4":
        bits = mk.pil_dither(u8)
        data = mk.encode_tiff_fax(bits, 4, 1)
    elif kind == "ycbcr22_lzw":
        data = mk.encode_tiff_ycbcr(ycc, 2, 2, 5, rows_per_strip=16)
    else:
        data = mk.encode_tiff_ojpeg(ycc, 2, 2, rows_per_strip=16)
    with open(path, "wb") as f:
        f.write(data)
    if png_path is not None:
        png.write_png(png_path, np.where(bits, 255, 0).astype(np.uint8) if kind == "ccitt_g4"
                      else png.read_gray(path))


def _write_gif_or_vp8l(job) -> None:
    """One frame as a GIF with an identity palette (PIL reads it as mode L,
    the indices as grey levels) or as a lossless WebP from the fixtures'
    VP8L writer (subtract green, Huffman-coded green); the encoders are
    Python: image_kinds runs these in a process pool."""
    path, u8 = job
    mk = _image_kinds_encoders()
    data = (mk.encode_gif(u8, palette=np.stack([np.arange(256)] * 3, 1))
            if path.endswith(".gif") else mk.encode_vp8l_gray(u8))
    with open(path, "wb") as f:
        f.write(data)


# the formats read since QOI that image_kinds writes (the encoders are
# Python: it runs these in a process pool): (b)'s RLE TGA, RLE SGI,
# PackBits PSD and BRUN FLC trees, and the first pairs of the others for the
# decode timing, each with its file extension (an ICNS RLE icon is at most
# it32's 128 × 128: its pairs are the frames' top-left corners)
RASTER_TIMING = {"qoi": ".qoi", "pcx": ".pcx", "sun_rle": ".ras", "dds_bc1": ".dds",
                 "dds_bc7": ".dds", "psd_raw": ".psd", "blp2_dxt1": ".blp",
                 "ftex_dxt1": ".ftc", "icns_it32": ".icns", "fits_8": ".fits",
                 "fits_gzip": ".fits", "spider": ".spi", "im_l": ".im", "msp_lins": ".msp",
                 "xpm_2cpp": ".xpm"}
# PIL's sha256 of convert("L") of the PhotoCD files image_kinds writes
# (torch_make_image_kinds.pcd_sample(seed, orientation) for the keys; the
# card's machine has no PIL: tests/test_torch_pillow_raw_layouts.py holds
# these to PIL)
PCD_SAMPLES_SHA256 = {
    (0, 0): "406eb44fc0ace4e3c5bbb69d5a665c13750abdd7a379de8d06a25b07f09ceade",
    (1, 0): "a3004eac90f31dc34518947dc31cb8184bc8c92d65fb84caf5fc4dd25c133a5f",
    (2, 3): "d30bafe2ac81e3edc39c2c9e00dfd1969e30c02d05e601255299e6d719c9d242",
}
PCD_TIMING_PAIR = ((0, 0), (1, 0))  # two files of one orientation, one size
RASTER_TIMING_PAIRS = 2


def _write_raster(job) -> None:
    """One frame as an RLE TGA (type 11, bottom-up), an RLE SGI, a QOI (as
    RGB), an 8-bit PCX with a grey-ramp palette (PIL reads it as L), an RLE
    Sun raster, a DDS of BC1 or BC7 (mode 6) blocks of the frame as RGB, a
    gray PSD (PackBits or raw), a BLP2 or an FTEX of DXT1 blocks, an ICNS of
    the frame's top-left 128 × 128 as an it32 RLE icon, an FLC of one BRUN
    chunk under a COLOR_256 grey-ramp palette, a FITS of BITPIX 8 (raw, or a
    GZIP_1 tile), a SPIDER, an IM of mode L, an MSP LinS of the frame
    thresholded at 128, or an XPM of 256 grey colours at 2 characters a
    pixel (the block formats are lossy: the timing only). TGA, SGI, QOI,
    PCX, Sun, PSD, FLC, FITS, SPIDER, IM and XPM keep every pixel."""
    path, kind, u8 = job
    mk = _image_kinds_encoders()
    rgb = np.dstack([u8] * 3)
    H, W = u8.shape
    ramp = np.stack([np.arange(256)] * 3, 1)
    if kind == "flc_brun":
        data = mk.encode_fli(u8, ramp)
    elif kind == "fits_8":
        data = mk.encode_fits(u8[::-1], 8)
    elif kind == "fits_gzip":
        data = mk.encode_fits(u8[::-1], 8, gzip_tile=True)
    elif kind == "spider":
        data = mk.encode_spider(u8.astype(np.float32))
    elif kind == "im_l":
        data = mk.encode_im("Greyscale", (W, H), u8[::-1].tobytes())
    elif kind == "msp_lins":
        data = mk.encode_msp(u8 >= 128, b"LinS")
    elif kind == "xpm_2cpp":
        data = mk.encode_xpm(u8, [(i, i, i) for i in range(256)], 2)
    elif kind in ("psd_packbits", "psd_raw"):
        data = mk.encode_psd(u8, 1, compression=int(kind == "psd_packbits"))
    elif kind == "blp2_dxt1":
        data = mk.encode_blp(2, W, H, mk.bc1_blocks(rgb), encoding=2, alpha_encoding=0)
    elif kind == "ftex_dxt1":
        data = mk.encode_ftex(W, H, mk.bc1_blocks(rgb))
    elif kind == "icns_it32":
        data = mk.encode_icns([(b"it32", b"\0\0\0\0" + mk.icns_rgb(rgb[:128, :128]))])
    elif kind == "tga_rle":
        data = mk.encode_tga(u8, 11, 8)
    elif kind == "sgi_rle":
        data = mk.encode_sgi(u8, 1, rle=True)
    elif kind == "qoi":
        data = mk.encode_qoi(rgb)
    elif kind == "pcx":
        data = mk.encode_pcx(u8, 8, 1, palette256=np.stack([np.arange(256)] * 3, 1))
    elif kind == "sun_rle":
        data = mk.encode_sun(u8, 8, 2)
    elif kind == "dds_bc1":
        data = mk.encode_dds(mk.bc1_blocks(rgb), W, H)
    else:
        data = mk.encode_dds(mk.bc7_blocks(np.dstack([rgb, np.full_like(u8, 255)])), W, H,
                             fourcc=b"DX10", dxgi=98)
    with open(path, "wb") as f:
        f.write(data)


def _write_bmp(path, u8) -> None:
    """(H, W) uint8 as a bottom-up 8-bit BMP with a grey-ramp palette (PIL
    reads it as mode L, the bytes as grey levels)."""
    ramp = np.stack([np.arange(256)] * 3, 1)
    with open(path, "wb") as f:
        f.write(_image_kinds_encoders().encode_bmp(u8, 8, palette=ramp))


def _rewrite_tree(src_root, outputs) -> None:
    """A raw-EuRoC tree's frames rewritten: ``outputs`` maps each new
    tree's root to (extension, ``write``), ``write(path, u8)`` writing a
    file of the frame the port decodes (each frame read once);
    ``cam0/data.csv`` renamed to match, the ground truth copied."""
    from rspl_slam_tpu_torch import png

    src = os.path.join(src_root, "mav0")
    for cam in ("cam0", "cam1"):
        for dst_root in outputs:
            os.makedirs(os.path.join(dst_root, "mav0", cam, "data"))
        for name in sorted(os.listdir(os.path.join(src, cam, "data"))):
            u8 = png.read_gray(os.path.join(src, cam, "data", name))
            for dst_root, (ext, write) in outputs.items():
                stem = os.path.splitext(name)[0]
                write(os.path.join(dst_root, "mav0", cam, "data", stem + ext), u8)
    with open(os.path.join(src, "cam0", "data.csv")) as f:
        rows = f.read()
    for dst_root, (ext, _) in outputs.items():
        dst = os.path.join(dst_root, "mav0")
        with open(os.path.join(dst, "cam0", "data.csv"), "w") as f:
            f.write(re.sub(r"\.(png|jpg)$", ext, rows, flags=re.M))
        shutil.copytree(os.path.join(src, "state_groundtruth_estimate0"),
                        os.path.join(dst, "state_groundtruth_estimate0"))


def _cli_result(out: str) -> dict:
    processed = re.search(r"^(?:processed|served) (\d+) frames", out, re.M)
    return {"frames": int(processed.group(1)) if processed else None,
            "launches": json.loads(re.search(r"^kernel launches: (.*)$", out, re.M).group(1))}


def _decode_pair_ms(pairs, n_rep: int) -> float:
    """Mean ms to decode one stereo pair of files with ``native.decode_gray``
    (read, decode, u8 / 255) over ``pairs`` × ``n_rep``."""
    from rspl_slam_tpu_torch import native

    t0 = time.perf_counter()
    for _ in range(n_rep):
        for lp, rp, (H, W) in pairs:
            native.decode_gray(lp, H, W)
            native.decode_gray(rp, H, W)
    return (time.perf_counter() - t0) / (n_rep * len(pairs)) * 1e3


def phase_image_kinds(ctx, cli_line):
    """Every JPEG, netpbm, PFM, TIFF, BMP, GIF, WebP, DIB, QOI, Sun raster,
    PCX, SGI, TGA, ICO, CUR, DDS, PSD, DCX, BLP, FTEX, ICNS, MSP, XBM, XPM,
    IM, IMT, IPTC, SPIDER, GBR, McIDAS, PIXAR, XVThumb, FITS, FLI and PCD
    kind the JAX package reads through PIL,
    on the card's machine (no PIL there) and through the CLI at full width:

    (a) each committed fixture of ``tests/fixtures/image_kinds`` (its
    manifest pins PIL's sha256 of each readable file) through
    ``png.read_gray``, ``native.decode_u8`` and a ``NativeStereoLoader``,
    each hashing to the pinned value; each kind PIL refuses, and each kind
    or format PIL reads that the port does not yet, raising
    ``NotImplementedError`` on all three routes; the GIF and WebP fixtures
    (a lossy 752×480 pair among them) hash like the rest, and so do three
    PhotoCD files written from seeds (``PCD_SAMPLES_SHA256``: 786 KB each,
    too large to commit);
    (b) ``cli_run``'s 752×480 30-frame PNG tree rewritten as 16-bit P5, as
    plain P2, as 16-bit LZW TIFF with predictor 2 and as gray GIF with an
    identity palette (in a process pool: both LZW encoders are Python), as
    bottom-up 8-bit BMP, as VP8L WebP, as RLE TGA, as RLE SGI, as PackBits
    PSD, as FLC frame 0 (one BRUN chunk under a COLOR_256 grey ramp; the
    pool again) and as 8-bit LZMA TIFF with predictor 2 in 16-row strips
    (the standard library's ``lzma``, in the pool): ``cli run`` on the P5,
    TIFF, GIF, TGA, FLC and LZMA trees by the
    native route and on the P2, BMP, VP8L, SGI and PSD trees with
    ``--no-native``, the eleven processes at once, each trajectory and launch
    count equal to ``cli_run``'s PNG run of the same route (every value is
    at most 255, so PIL reads the same pixels from all of them: any
    difference is a decode fault);
    (c) the committed 752×480 progressive stereo sequence (6 pairs written
    by PIL from the port's renderer, with its ground truth): ``cli run``
    (native) on it and on PNG copies of its decoded pixels, trajectories
    and launches equal, K1 (both modes), K2 and K3 launched; then ``cli
    serve`` on a watch directory holding those ``.jpg`` frames and the stop
    file, its trajectory equal to the run's (each part's CLI processes run
    at once on the card; no camera file: no remap, so
    the serve route's frames are the native route's; the algorithm file
    holds the weight paths, which ``serve`` takes from it, and makes every
    frame a keyframe, so the trajectories compared hold every pose);
    (d) the frames as YCbCr 4:2:0 JPEG-in-TIFF (16-row strips, one
    JPEGTables stream) through ``cli run`` (native), and dithered as PIL's
    ``convert("1")`` dithers them as Group 4 TIFF through ``cli run
    --no-native``, each against a PNG tree of the pixels PIL decodes from
    them (the dithered pixels; the port's decode of the JPEG-in-TIFFs,
    whose layout the fixture ``tiff_jpeg_ycc420.tif`` ties to PIL's hash)
    on the same route, trajectories, keyframes and launches equal (the
    four runs beside (c)'s);
    then decode ms per 752×480 pair, progressive against baseline JPEG,
    16-bit P5 against 8-bit PNG, and TIFF (uncompressed, LZW with predictor
    2, Deflate, 16-bit LZW with predictor 2, LZMA with predictor 2, the
    committed ZSTD pair with predictor 2, 4-bit ThunderScan of raw-pixel
    codes, the JPEG-in-TIFF and Group 4
    trees, YCbCr 2×2 LZW and old-style JPEG), 8-bit BMP, GIF, VP8L WebP,
    the committed lossy WebP pair (quality 90), RLE TGA, RLE SGI, QOI, PCX,
    RLE Sun raster, DDS of BC1 and BC7 blocks, PackBits and raw PSD, BLP2
    and FTEX of DXT1 blocks, 128 × 128 ICNS it32 RLE icons (the largest
    RLE icon PIL reads), BRUN FLC, FITS of BITPIX 8 (raw and a GZIP_1 tile),
    SPIDER, IM of mode L, MSP LinS, XPM of 2 characters a pixel and the
    PhotoCD pair at its own 768 × 512 against 8-bit PNG, in turns."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    from rspl_slam_tpu_torch import native, png

    t_phase = time.perf_counter()
    with open(os.path.join(IMAGE_KINDS, "manifest.json")) as f:
        manifest = json.load(f)["files"]
    hashes_ok, refused_ok, bad = 0, 0, []
    for name, entry in sorted(manifest.items()):
        path = os.path.join(IMAGE_KINDS, name)
        with open(path, "rb") as f:
            data = f.read()
        if entry.get("refused"):
            raised = 0

            def through_loader():
                with native.NativeStereoLoader([path], [path], 48, 64) as loader:
                    next(loader)

            routes = (lambda: png.read_gray(path), lambda: native.decode_u8(data, path),
                      through_loader)
            for call in routes:
                try:
                    call()
                except NotImplementedError:
                    raised += 1
            if raised == len(routes):
                refused_ok += 1
            else:
                bad.append(f"{name}: refused on {raised} of {len(routes)} routes")
            continue
        H, W = native.image_size(data)
        with native.NativeStereoLoader([path], [path], H, W) as loader:
            (_, left, right), = list(loader)
        got = {"read_gray": png.read_gray(path), "decode_u8": native.decode_u8(data, path),
               "loader_left": np.round(left * 255).astype(np.uint8),
               "loader_right": np.round(right * 255).astype(np.uint8)}
        wrong = [k for k, v in got.items() if _u8_sha256(v) != entry["sha256"]]
        if wrong:
            bad.append(f"{name}: {wrong} differ from PIL's pinned hash")
        else:
            hashes_ok += 1

    work = os.path.join(WORK, "image_kinds")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    mk = _image_kinds_encoders()
    pcd_paths = {}
    for (seed, orientation), want in sorted(PCD_SAMPLES_SHA256.items()):
        path = pcd_paths[seed, orientation] = os.path.join(work, f"pcd_{seed}_{orientation}.pcd")
        with open(path, "wb") as f:
            f.write(mk.pcd_sample(seed, orientation))
        with open(path, "rb") as f:
            data = f.read()
        H, W = native.image_size(data)
        with native.NativeStereoLoader([path], [path], H, W) as loader:
            (_, left, _), = list(loader)
        got = {"read_gray": png.read_gray(path), "decode_u8": native.decode_u8(data, path),
               "loader": np.round(left * 255).astype(np.uint8)}
        wrong = [k for k, v in got.items() if _u8_sha256(v) != want]
        if wrong:
            bad.append(f"{os.path.basename(path)}: {wrong} differ from PIL's pinned hash")
        else:
            hashes_ok += 1
    cw = ctx["work"]
    weights = ("--sp-weights", os.path.join(cw, "sp.npz"), "--sg-weights",
               os.path.join(cw, "sg.npz"), "--rcf-weights", os.path.join(cw, "rcf.npz"))
    # (b) the PGM, TIFF and BMP trees against cli_run's PNG runs of the same
    # route; each part's CLI processes run at once (each repeats its
    # trajectory bit for bit whatever runs beside it: cli_run's native_again
    # gate)
    trees = {kind: os.path.join(work, f"tree_{kind}")
             for kind in ("P5", "P2", "TIFF16", "BMP8", "GIF", "VP8L", "TGA", "SGI", "PSD", "FLC",
                          "LZMA")}
    raster_timing = {k: os.path.join(work, f"timing_{k}") for k in RASTER_TIMING}
    # (d) the libtiff codecs' trees and their PNG copies, and the first
    # pairs of the timing-only codecs
    codec_trees = {k: os.path.join(work, f"tree_{k}")
                   for k in ("jpeg_ycc420", "jpeg_ycc420_png", "ccitt_g4", "ccitt_g4_png")}
    codec_timing = {k: os.path.join(work, f"timing_{k}") for k in ("ycbcr22_lzw", "ojpeg22")}
    # the other TIFF kinds: the first pairs only, for the decode timing
    timing_trees = {k: os.path.join(work, f"timing_{k}") for k in TIFF_KINDS
                    if k not in ("tiff_16bit_lzw_pred2", "tiff_lzma_pred2")}
    names = sorted(os.listdir(os.path.join(ctx["tree"], "mav0", "cam0", "data")))
    timing_stems = {os.path.splitext(nm)[0] for nm in names[:DECODE_TIMING_PAIRS]}
    codec_stems = {os.path.splitext(nm)[0] for nm in names[:TIFF_CODEC_TIMING_PAIRS]}
    raster_stems = {os.path.splitext(nm)[0] for nm in names[:RASTER_TIMING_PAIRS]}
    for root in (*timing_trees.values(), *codec_timing.values(), *raster_timing.values()):
        for cam in ("cam0", "cam1"):
            os.makedirs(os.path.join(root, "mav0", cam, "data"))
    t0 = time.perf_counter()
    # the pool writes (d)'s trees while (b)'s CLI processes run
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        tiff_jobs, codec_args = [], []

        def write_gif_or_vp8l(path, u8):
            tiff_jobs.append(pool.submit(_write_gif_or_vp8l, (path, u8)))

        def write_raster(path, u8):  # the TGA, SGI, PSD and FLC trees, the raster timing pairs
            kind = {".tga": "tga_rle", ".sgi": "sgi_rle", ".flc": "flc_brun"}.get(path[-4:],
                                                                                  "psd_packbits")
            tiff_jobs.append(pool.submit(_write_raster, (path, kind, u8)))
            stem, cam = os.path.splitext(os.path.basename(path))[0], path.split(os.sep)[-3]
            if kind == "tga_rle" and stem in raster_stems:
                for k, root in raster_timing.items():
                    tiff_jobs.append(pool.submit(_write_raster, (
                        os.path.join(root, "mav0", cam, "data", stem + RASTER_TIMING[k]), k, u8)))

        def write_tiffs(path, u8):  # in the pool, while this process writes the rest
            tiff_jobs.append(pool.submit(_write_tiff, (path, "tiff_16bit_lzw_pred2", u8)))
            stem, cam = os.path.splitext(os.path.basename(path))[0], path.split(os.sep)[-3]
            if stem in timing_stems:
                for k, root in timing_trees.items():
                    tiff_jobs.append(pool.submit(_write_tiff, (
                        os.path.join(root, "mav0", cam, "data", stem + ".tif"), k, u8)))
            # (d)'s jobs go in after every other one, to run beside (b)'s CLI
            for k in ("jpeg_ycc420", "ccitt_g4"):
                copy = os.path.join(codec_trees[k + "_png"], "mav0", cam, "data", stem + ".png")
                codec_args.append((os.path.join(codec_trees[k], "mav0", cam, "data",
                                                stem + ".tif"), k, u8, copy))
            if stem in codec_stems:
                for k, root in codec_timing.items():
                    codec_args.append((os.path.join(root, "mav0", cam, "data", stem + ".tif"),
                                       k, u8, None))

        def write_lzma(path, u8):  # the standard library's lzma: in the pool too
            tiff_jobs.append(pool.submit(_write_tiff, (path, "tiff_lzma_pred2", u8)))

        def written_in_the_pool(path, u8):
            pass

        _rewrite_tree(ctx["tree"], {
            **{trees[k]: (".pgm", lambda p, u8, k=k: _write_pgm(p, u8, k))
               for k in ("P5", "P2")},
            trees["TIFF16"]: (".tif", write_tiffs), trees["BMP8"]: (".bmp", _write_bmp),
            trees["GIF"]: (".gif", write_gif_or_vp8l), trees["VP8L"]: (".webp", write_gif_or_vp8l),
            trees["TGA"]: (".tga", write_raster), trees["SGI"]: (".sgi", write_raster),
            trees["PSD"]: (".psd", write_raster), trees["FLC"]: (".flc", write_raster),
            trees["LZMA"]: (".tif", write_lzma),
            **{root: (".png" if k.endswith("_png") else ".tif", written_in_the_pool)
               for k, root in codec_trees.items()}})
        codec_jobs = [pool.submit(_write_tiff_codec, a) for a in codec_args]
        del codec_args
        for job in tiff_jobs:
            job.result()
        trees_write_s = time.perf_counter() - t0
        routes = {"P5": (), "P2": ("--no-native",), "TIFF16": (), "BMP8": ("--no-native",),
                  "GIF": (), "VP8L": ("--no-native",), "TGA": (), "SGI": ("--no-native",),
                  "PSD": ("--no-native",), "FLC": (), "LZMA": ()}
        t0 = time.perf_counter()
        outs = _cli_concurrent(*[("run", "--dataroot", trees[k], "--config", ctx["euroc"],
                                  "--camera-config", ctx["cam_yaml"], *weights, "--gt", trees[k],
                                  "--traj-path", os.path.join(work, f"traj_{k}.txt"), *routes[k])
                                 for k in trees])
        trees_wall = time.perf_counter() - t0
        tree_runs = {}
        for kind, out in zip(trees, outs):
            with open(os.path.join(work, f"traj_{kind}.txt")) as f:
                text = f.read()
            with open(os.path.join(cw, "traj_no_native.txt" if routes[kind] else "traj.txt")) as f:
                ref = f.read()
            ref_launches = cli_line["launches_no_native" if routes[kind] else "launches"]
            tree_runs[kind] = {"route": "no_native" if routes[kind] else "native",
                               **_cli_result(out), "trajectory_equal_png": text == ref,
                               "keyframes": len(text.splitlines())}
            tree_runs[kind]["launches_equal_png"] = tree_runs[kind]["launches"] == ref_launches

        t0 = time.perf_counter()
        for job in codec_jobs:
            job.result()
        codec_write_wait_s = time.perf_counter() - t0
    # (d)'s frames: each TIFF's decode against its PNG copy (for Group 4
    # the dithered pixels PIL reads back; for JPEG the port's decode,
    # written by another process)
    codec_frames_equal = {}
    for k in ("jpeg_ycc420", "ccitt_g4"):
        same = 0
        for cam in ("cam0", "cam1"):
            data_dir = os.path.join(codec_trees[k], "mav0", cam, "data")
            for nm in sorted(os.listdir(data_dir)):
                copy = os.path.join(codec_trees[k + "_png"], "mav0", cam, "data",
                                    os.path.splitext(nm)[0] + ".png")
                same += bool(np.array_equal(png.read_gray(os.path.join(data_dir, nm)),
                                            png.read_gray(copy)))
        codec_frames_equal[k] = same

    # (c) the progressive sequence, its PNG copies, and serve
    seq = os.path.join(IMAGE_KINDS, IMAGE_KINDS_SEQ)
    copies = os.path.join(work, "seq_png")
    _rewrite_tree(seq, {copies: (".png", png.write_png)})
    # serve takes its weights from the algorithm file only: this one is
    # SystemConfig() (= configs/euroc.yaml) with the smoke's weights, and
    # every tracked frame a keyframe, so the trajectory files hold every
    # pose
    seq_yaml = os.path.join(work, "sequence.yaml")
    with open(seq_yaml, "w") as f:
        f.write(f"superpoint:\n  weights_path: {weights[1]}\nsuperglue:\n  weights_path: "
                f"{weights[3]}\nline_detector:\n  rcf_weights_path: {weights[5]}\n"
                f"keyframe:\n  max_num_match: {IMAGE_KINDS_ALL_KEYFRAMES}\n")
    watch = os.path.join(work, "serve")
    for cam in ("cam0", "cam1"):
        shutil.copytree(os.path.join(seq, "mav0", cam, "data"), os.path.join(watch, cam, "data"))
    open(os.path.join(watch, "stop"), "w").close()
    traj = {k: os.path.join(work, f"traj_seq_{k}.txt") for k in ("jpeg", "png_copies", "serve")}
    codec_routes = {"jpeg_ycc420": (), "jpeg_ycc420_png": (), "ccitt_g4": ("--no-native",),
                    "ccitt_g4_png": ("--no-native",)}
    t0 = time.perf_counter()
    outs = _cli_concurrent(
        *[("run", "--dataroot", root, "--config", seq_yaml, "--gt", root, "--traj-path", traj[k])
          for k, root in (("jpeg", seq), ("png_copies", copies))],
        ("serve", "--watch-dir", watch, "--config", seq_yaml, "--traj-path", traj["serve"],
         "--idle-timeout", "120"),
        *[("run", "--dataroot", codec_trees[k], "--config", ctx["euroc"], "--camera-config",
           ctx["cam_yaml"], *weights, "--gt", codec_trees[k], "--traj-path",
           os.path.join(work, f"traj_{k}.txt"), *codec_routes[k]) for k in codec_routes])
    seq_wall = time.perf_counter() - t0
    runs = {}
    for k, out in zip(traj, outs):
        with open(traj[k]) as f:
            ate = re.search(r"^ATE: (.*)$", out, re.M)
            runs[k] = {**_cli_result(out), "text": f.read(),
                       "ate": json.loads(ate.group(1)) if ate else None}
    codec_runs = {}
    for k, out in zip(codec_routes, outs[len(traj):]):
        with open(os.path.join(work, f"traj_{k}.txt")) as f:
            codec_runs[k] = {**_cli_result(out), "text": f.read()}
    codec_line = {}
    for k in ("jpeg_ycc420", "ccitt_g4"):
        r, c = codec_runs[k], codec_runs[k + "_png"]
        codec_line[k] = {"route": "no_native" if codec_routes[k] else "native",
                         "frames": r["frames"], "keyframes": len(r["text"].splitlines()),
                         "frames_decoded_equal_png_copies": codec_frames_equal[k],
                         "launches": r["launches"],
                         "trajectory_equal_png_copies": r["text"] == c["text"],
                         "keyframes_equal_png_copies":
                             len(r["text"].splitlines()) == len(c["text"].splitlines()),
                         "launches_equal_png_copies": r["launches"] == c["launches"]}

    # decode ms per 752×480 pair, in turns
    base = os.path.join(IMAGE_KINDS, IMAGE_KINDS_BASELINE)

    def with_size(lp, rp):
        with open(lp, "rb") as f:
            return lp, rp, native.image_size(f.read())

    def tree_pairs(root, n):
        names = sorted(os.listdir(os.path.join(root, "mav0", "cam0", "data")))
        return [with_size(os.path.join(root, "mav0", "cam0", "data", nm),
                          os.path.join(root, "mav0", "cam1", "data", nm)) for nm in names[:n]]

    # ThunderScan pairs of the first frames' top 4 bits (numpy: written here)
    thunder = os.path.join(work, "timing_thunderscan")
    _rewrite_tree(ctx["tree"], {thunder: (".tif", _write_thunderscan)})
    prog_pair = tree_pairs(seq, 1)
    base_pair = [with_size(os.path.join(base, "cam0.jpg"), os.path.join(base, "cam1.jpg"))]

    timing = {"progressive_jpeg": [], "baseline_jpeg": [], "p5_16bit": [], "png_8bit": []}
    sets = {"progressive_jpeg": prog_pair, "baseline_jpeg": base_pair,
            "p5_16bit": tree_pairs(os.path.join(work, "tree_P5"), DECODE_TIMING_PAIRS),
            "png_8bit": tree_pairs(ctx["tree"], DECODE_TIMING_PAIRS)}
    for a, b in (("progressive_jpeg", "baseline_jpeg"), ("p5_16bit", "png_8bit")):
        for k in (a, b, b, a):
            timing[k].append(_decode_pair_ms(sets[k], 20 if len(sets[k]) == 1 else 2))
    # TIFF, BMP, GIF and WebP against 8-bit PNG: the order forward, then back
    tb_sets = {"png_8bit": sets["png_8bit"],
               **{k: tree_pairs(root, DECODE_TIMING_PAIRS) for k, root in timing_trees.items()},
               "tiff_16bit_lzw_pred2": tree_pairs(trees["TIFF16"], DECODE_TIMING_PAIRS),
               "tiff_lzma_pred2": tree_pairs(trees["LZMA"], DECODE_TIMING_PAIRS),
               "tiff_zstd_pred2": [with_size(os.path.join(IMAGE_KINDS, IMAGE_KINDS_ZSTD, "cam0.tif"),
                                             os.path.join(IMAGE_KINDS, IMAGE_KINDS_ZSTD,
                                                          "cam1.tif"))],
               "tiff_thunderscan_4bit": tree_pairs(thunder, RASTER_TIMING_PAIRS),
               "bmp_8bit": tree_pairs(trees["BMP8"], DECODE_TIMING_PAIRS),
               "gif": tree_pairs(trees["GIF"], DECODE_TIMING_PAIRS),
               "webp_vp8l": tree_pairs(trees["VP8L"], DECODE_TIMING_PAIRS),
               "webp_lossy_q90": [with_size(os.path.join(IMAGE_KINDS, IMAGE_KINDS_WEBP, "cam0.webp"),
                                            os.path.join(IMAGE_KINDS, IMAGE_KINDS_WEBP,
                                                         "cam1.webp"))],
               "tiff_jpeg_ycc420": tree_pairs(codec_trees["jpeg_ycc420"], DECODE_TIMING_PAIRS),
               "tiff_ccitt_g4": tree_pairs(codec_trees["ccitt_g4"], DECODE_TIMING_PAIRS),
               **{f"tiff_{k}": tree_pairs(root, TIFF_CODEC_TIMING_PAIRS)
                  for k, root in codec_timing.items()},
               "tga_rle": tree_pairs(trees["TGA"], DECODE_TIMING_PAIRS),
               "sgi_rle": tree_pairs(trees["SGI"], DECODE_TIMING_PAIRS),
               "psd_packbits": tree_pairs(trees["PSD"], DECODE_TIMING_PAIRS),
               **{k: tree_pairs(root, RASTER_TIMING_PAIRS) for k, root in raster_timing.items()},
               "flc_brun": tree_pairs(trees["FLC"], DECODE_TIMING_PAIRS),
               "pcd_768x512": [with_size(pcd_paths[PCD_TIMING_PAIR[0]],
                                         pcd_paths[PCD_TIMING_PAIR[1]])]}
    tb_timing = {k: [] for k in tb_sets}
    for k in list(tb_sets) + list(tb_sets)[::-1]:
        tb_timing[k].append(_decode_pair_ms(tb_sets[k], 20 if len(tb_sets[k]) == 1 else 2))

    jl = runs["jpeg"]["launches"]
    line = {"phase": "image_kinds", "card": CARD,
            "fixtures": len(manifest) + len(PCD_SAMPLES_SHA256),
            "fixtures_hash_equal_pil": hashes_ok, "refused_raise": refused_ok,
            "fixture_faults": bad, "trees": tree_runs, "trees_write_s": trees_write_s,
            "trees_cli_wall_s": trees_wall, "libtiff_codec_trees": codec_line,
            "libtiff_codec_write_wait_s": codec_write_wait_s,
            "sequence": {"frames": runs["jpeg"]["frames"], "image": [752, 480],
                         "keyframes": len(runs["jpeg"]["text"].splitlines()),
                         "ate": runs["jpeg"]["ate"], "launches": jl,
                         "trajectory_equal_png_copies":
                             runs["jpeg"]["text"] == runs["png_copies"]["text"],
                         "launches_equal_png_copies":
                             jl == runs["png_copies"]["launches"],
                         "serve_frames": runs["serve"]["frames"],
                         "serve_trajectory_equal_run": runs["serve"]["text"] == runs["jpeg"]["text"],
                         "serve_launches": runs["serve"]["launches"], "cli_wall_s": seq_wall},
            "decode_ms_per_pair": timing,
            "decode_order": "progressive, baseline, baseline, progressive; P5, PNG, PNG, P5",
            "decode_ms_per_pair_vs_png": tb_timing,
            "decode_order_vs_png": ", ".join(tb_sets) + ", then back",
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    if bad or hashes_ok + refused_ok != len(manifest) + len(PCD_SAMPLES_SHA256):
        raise AssertionError(f"image_kinds: fixtures off PIL's pinned hashes: {bad}")
    for kind, r in tree_runs.items():
        if r["frames"] != E2E_FRAMES or not r["trajectory_equal_png"] or not r["launches_equal_png"]:
            raise AssertionError(f"image_kinds: the {kind} tree's {r['route']} run differs from "
                                 f"cli_run's PNG run: {r}")
    for kind, r in codec_line.items():
        if r["frames"] != E2E_FRAMES or r["frames_decoded_equal_png_copies"] != 2 * E2E_FRAMES \
                or not r["trajectory_equal_png_copies"] \
                or not r["keyframes_equal_png_copies"] or not r["launches_equal_png_copies"]:
            raise AssertionError(f"image_kinds: the {kind} tree's {r['route']} run differs from "
                                 f"its PNG copies': {r}")
        for k in ("conv_stem", "conv_stem_side", "superglue_layer", "sinkhorn"):
            if r["launches"][k] <= 0:
                raise AssertionError(f"image_kinds: kernel {k} never launched on the {kind} tree")
    seq_line = line["sequence"]
    if runs["jpeg"]["frames"] != IMAGE_KINDS_SEQ_FRAMES \
            or not seq_line["trajectory_equal_png_copies"] \
            or not seq_line["launches_equal_png_copies"]:
        raise AssertionError(f"image_kinds: the progressive sequence's run differs from its PNG "
                             f"copies': {seq_line}")
    if seq_line["keyframes"] < 3:
        raise AssertionError(f"image_kinds: the sequence made {seq_line['keyframes']} keyframes")
    for k in ("conv_stem", "conv_stem_side", "superglue_layer", "sinkhorn"):
        if jl[k] <= 0:
            raise AssertionError(f"image_kinds: kernel {k} never launched on the sequence")
    if runs["serve"]["frames"] != IMAGE_KINDS_SEQ_FRAMES \
            or not seq_line["serve_trajectory_equal_run"]:
        raise AssertionError(f"image_kinds: serve gave another trajectory:\n"
                             f"{runs['serve']['text']}\n---\n{runs['jpeg']['text']}")
    return line, jl


def phase_merge_ab(compiled_line):
    """The lines path (``end_to_end_lines``) with the numpy merge, twice,
    then with the compiled one again, after ``compiled_line``'s run: the
    merge's share of the path's frames/s and ``lines_host`` within one
    call (compiled, numpy, numpy, compiled)."""
    import torch

    runs = {"compiled": [compiled_line]}
    for name, numpy_merge in (("numpy", True), ("numpy", True), ("compiled", False)):
        line, _, run = phase_end_to_end(lines=True, name=f"end_to_end_lines_{name}_merge",
                                        numpy_merge=numpy_merge)
        runs.setdefault(name, []).append(line)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "merge_ab", "card": CARD, "order": "compiled, numpy, numpy, compiled",
          **{f"frames_per_s_{k}": [ln["frames_per_s"] for ln in v] for k, v in runs.items()},
          **{f"lines_host_ms_{k}": [ln["stage_median_ms"]["lines_host"] for ln in v]
             for k, v in runs.items()},
          **{f"ate_rmse_m_{k}": [ln["ate_rmse_m"] for ln in v] for k, v in runs.items()}})


def _crop(photo, oy: float, ox: float, H: int, W: int) -> np.ndarray:
    """Sub-pixel bilinear crop of the photo: the camera of the JAX package's
    plane-scene tests (``tests/test_real_image.py:crop``)."""
    ys = np.arange(H, dtype=np.float64) + oy
    xs = np.arange(W, dtype=np.float64) + ox
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    y0 = np.clip(y0, 0, photo.shape[0] - 2)
    x0 = np.clip(x0, 0, photo.shape[1] - 2)
    p00, p01 = photo[np.ix_(y0, x0)], photo[np.ix_(y0, x0 + 1)]
    p10, p11 = photo[np.ix_(y0 + 1, x0)], photo[np.ix_(y0 + 1, x0 + 1)]
    return ((1 - fy) * (1 - fx) * p00 + (1 - fy) * fx * p01
            + fy * (1 - fx) * p10 + fy * fx * p11).astype(np.float32)


PHOTO_FRAMES = 10


def start_cli_photo():
    """The repo's photograph through ``cli run`` on the card, as the JAX
    package's one-command CLI case (``tests/test_real_image.py::
    TestRealImageCLI``) drives it: 10 stereo crops of a fronto-parallel
    plane at Z = 3 m (376×240, bf/Z = 16 px) along 0.6 m of x, written as
    8-bit PNGs, ``--matcher cosine --no-lines`` with random SuperPoint, the
    native prefetcher; started, for :func:`phase_cli_photo` to gate."""
    from rspl_slam_tpu_torch import png
    from rspl_slam_tpu_torch.datasets import write_tum_trajectory
    from rspl_slam_tpu_torch.slam import INIT_POSE

    photo = png.read_gray(PHOTO).astype(np.float32) / 255.0
    fx, cx, cy, bf, Z, N = 300.0, 188.0, 120.0, 48.0, 3.0, PHOTO_FRAMES
    disp = bf / Z
    work = os.path.join(WORK, "cli_photo")
    shutil.rmtree(work, ignore_errors=True)
    seq = os.path.join(work, "seq")
    dx_m = np.linspace(0, 0.6, N)
    times = 1400000000 * 10**9 + np.arange(N, dtype=np.int64) * 50000000
    gt = np.tile(np.eye(4), (N, 1, 1))
    gt[:, 0, 3] = dx_m
    for i in range(N):
        ox = 40.0 + fx * dx_m[i] / Z
        for sub, oxe in (("cam0", ox), ("cam1", ox + disp)):
            img = _crop(photo, 100.0, oxe, 240, 376)
            png.write_png(os.path.join(seq, sub, "data", f"{int(times[i])}.png"),
                          (img * 255).astype(np.uint8))
    gt_file = os.path.join(work, "gt.tum")
    write_tum_trajectory(gt_file, times * 1e-9, np.einsum("ij,njk->nik", INIT_POSE, gt))
    cfg_file = os.path.join(work, "cfg.yaml")
    with open(cfg_file, "w") as f:
        f.write("superpoint:\n  max_keypoints: 300\n  keypoint_threshold: 0.0001\n"
                "keyframe:\n  max_distance: 0.15\n"
                f"image_width: 376\nimage_height: 240\nbf: {bf}\ndepth_upper_thr: 20.0\n"
                f"LEFT.P:\n  data: [{fx}, 0, {cx}, 0, 0, {fx}, {cy}, 0, 0, 0, 1, 0]\n")
    return time.perf_counter(), _cli_start(
        ("run", "--dataroot", seq, "--config", cfg_file, "--camera-config", cfg_file,
         "--matcher", "cosine", "--no-lines", "--traj-path", os.path.join(work, "est.tum"),
         "--gt", gt_file))


def phase_cli_photo(started=None):
    """:func:`start_cli_photo`'s run (started here without ``started``),
    gated as JAX's case gates it (ATE n ≥ 3, rmse < 0.3 m)."""
    t0, procs = started or start_cli_photo()
    out, = _cli_wait(procs)
    wall = time.perf_counter() - t0
    ate = json.loads(re.search(r"^ATE: (.*)$", out, re.M).group(1))
    launches = json.loads(re.search(r"^kernel launches: (.*)$", out, re.M).group(1))
    processed = re.search(r"^processed (\d+) frames in ([0-9.]+)s \(([0-9.]+) fps\)$", out, re.M)
    line = {"phase": "cli_photo", "frames": PHOTO_FRAMES, "image": [376, 240],
            "native_prefetcher_printed": "using native prefetcher" in out.splitlines(),
            "ate": ate, "ate_bound_m": 0.3, "cli_wall_s_until_gated": wall,
            "cli_fps_printed": float(processed.group(3)) if processed else None,
            "launches": launches}
    emit(line)
    if ate["n"] < 3 or not ate["rmse"] < 0.3:
        raise AssertionError(f"cli_photo: ATE {ate} (JAX's case: n ≥ 3, rmse < 0.3 m)")
    if not line["native_prefetcher_printed"]:
        raise AssertionError("cli_photo: the run did not use the native prefetcher")
    if launches["conv_stem"] <= 0:
        raise AssertionError("cli_photo: K1 never launched")
    return line, launches


def start_cli_synth():
    """``synth --frames 100`` on the card, started: the oracle frontend on
    the unfused tracking path (host matching, PnP and pose-only LM on the
    card, lines, local BA)."""
    return _cli_start(("synth", "--frames", str(SYNTH_FRAMES)))


def phase_cli_synth(started=None):
    """:func:`start_cli_synth`'s run (started here without ``started``),
    gated on its ATE, keyframes and maplines."""
    out, = _cli_wait(started or start_cli_synth())
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
    subprocess (PyYAML, PIL, matplotlib hidden), beside an in-process run
    with the same options (the native-fed runner, then ``run_pose_graph``
    and ``run_global_ba``): exit 0, the JAX CLI's epilogue lines, and the
    trajectory file equal to the in-process run's."""
    import torch

    from rspl_slam_tpu_torch.frontend.frontends import NeuralFrontend
    from rspl_slam_tpu_torch.slam import SLAMSystem

    work, tree, euroc, cam_yaml = ctx["work"], ctx["tree"], ctx["euroc"], ctx["cam_yaml"]
    traj, inproc = os.path.join(work, "global.txt"), os.path.join(work, "global_inproc.txt")
    weights = [a for k in ("sp", "sg", "rcf")
               for a in (f"--{k}-weights", os.path.join(work, f"{k}.npz"))]
    t0 = time.perf_counter()
    started = _cli_start(("run", "--dataroot", tree, "--config", euroc, "--camera-config",
                          cam_yaml, *weights, "--traj-path", traj, "--loop-closure",
                          "--pose-graph", "--global-ba", "--track-local-map"))

    cfg = ctx["cfg"]
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(cfg.pipeline,
                                                                track_local_map=True))
    slam = SLAMSystem(cfg, NeuralFrontend(cfg, rectify=False), enable_loop_closure=True)
    _reset_counters()
    _native_fed(slam, tree, cfg)  # the CLI's default route
    pg = slam.run_pose_graph()
    gba = slam.run_global_ba()
    torch.cuda.synchronize()
    inproc_launches = _counters()
    slam.save_trajectory(inproc)
    out, = _cli_wait(started)
    cli_wall = time.perf_counter() - t0
    epilogue = re.findall(r"^(?:loop closures accepted|pose graph|global BA):.*$", out, re.M)
    launches = json.loads(re.search(r"^kernel launches: (.*)$", out, re.M).group(1))
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
            "keyframes": len(cli_traj.splitlines()), "cli_wall_s_until_gated": cli_wall,
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


PRETRAIN_MODELS = ("superpoint", "rcf", "superglue")


def _pretrain_npz(model: str) -> str:
    return os.path.join(WORK, f"pretrain_{model}.npz")


def start_cli_pretrain():
    """``pretrain`` of the three models (:func:`phase_cli_pretrain`),
    started."""
    return time.perf_counter(), _cli_start(*[
        ("pretrain", "--model", m, "--steps", str(PRETRAIN_STEPS), "--output", _pretrain_npz(m))
        for m in PRETRAIN_MODELS])


def phase_cli_pretrain(started=None):
    """``python -m rspl_slam_tpu_torch.cli pretrain --model M --steps 20``
    for the three models, in parallel subprocesses without PyYAML, PIL or
    matplotlib (:func:`start_cli_pretrain`'s, started here without
    ``started``), otherwise the JAX CLI's defaults; gated on each exit and
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

    t0, procs = started or start_cli_pretrain()
    stdouts = dict(zip(PRETRAIN_MODELS, _cli_wait(procs)))
    wall = time.perf_counter() - t0
    out = {m: _pretrain_npz(m) for m in PRETRAIN_MODELS}
    for m, stdout in stdouts.items():
        if f"trained {m} → {out[m]}" not in stdout:
            raise AssertionError(f"cli_pretrain {m} did not report its weights:\n"
                                 f"{stdout[-3000:]}")
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
    line = {"phase": "cli_pretrain", "card": CARD, "steps": PRETRAIN_STEPS,
            "wall_s_until_gated": wall,
            "last_loss_lines": {m: [ln for ln in r.splitlines() if ln.startswith("step")][-1:]
                                for m, r in stdouts.items()},
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
                 "superglue_layer": ("qkv_bf16_kernel", "layer_bf16_kernel<false>"),
                 "superglue_layer_f32": ("qkv_f32_kernel", "layer_f32_kernel"),
                 "superglue_layer_streamed": ("layer_bf16_kernel<true>",),
                 "sinkhorn": ("sinkhorn_cluster_kernel",),
                 "sinkhorn_global": ("sinkhorn_global_kernel",)}

SOURCES = {
    "conv_stem": ("rspl_slam_tpu_torch/csrc/conv_stem.cu",
                  "rspl_slam_tpu/ops/conv_stem_pallas.py:126"),
    "superglue_layer": ("rspl_slam_tpu_torch/csrc/superglue_layer.cu",
                        "rspl_slam_tpu/ops/attention_pallas.py:93"),
    # K2's two-set variant (M != N), which the Pallas kernel's caller left
    # to XLA (models/superglue.py:311-336)
    "superglue_layer_two_set": ("rspl_slam_tpu_torch/csrc/superglue_layer.cu",
                                "rspl_slam_tpu/ops/attention_pallas.py:93"),
    "sinkhorn": ("rspl_slam_tpu_torch/csrc/sinkhorn.cu",
                 "rspl_slam_tpu/ops/sinkhorn_pallas.py:61"),
    # past the resident kernels' ceilings: K2's streamed attention (source
    # length > 752) and K3's global-memory kernel (no cluster holds Z0)
    "superglue_layer_streamed": ("rspl_slam_tpu_torch/csrc/superglue_layer.cu",
                                 "rspl_slam_tpu/ops/attention_pallas.py:93"),
    "sinkhorn_global": ("rspl_slam_tpu_torch/csrc/sinkhorn.cu",
                        "rspl_slam_tpu/ops/sinkhorn_pallas.py:61"),
}
# K1's side-output mode (RCF) and K2's f32 modes, listed under the main line
OTHER_MODES = {"conv_stem": ("side_mode", "conv_stem_side"),
               "superglue_layer": ("f32_mode", "superglue_layer_f32"),
               "superglue_layer_two_set": ("f32_mode", "superglue_layer_two_set_f32")}
# the path whose run gives a kernel's ``launches`` where it is not the
# default main path's
KERNEL_PATHS = {"superglue_layer_two_set": "unequal", "superglue_layer_streamed": "large_k",
                "sinkhorn_global": "large_k"}
KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "tflops", "bound_fraction")


def phase_summary(lines, by_path, ate_by_path):
    """``by_path`` maps each end-to-end path to its launch counts, the
    default main path (``end_to_end_ba``) first; empty with --kernels
    (no path ran: launch counts null). A kernel of ``KERNEL_PATHS`` takes
    its ``launches`` from its own path. ``ate_by_path``: each path's ATE."""
    main_launches = (by_path.get("end_to_end_ba") or by_path.get("multi_sequence")
                     or by_path.get("configs"))
    kernels = []
    for name, (src, tpu) in SOURCES.items():
        launches = by_path.get(KERNEL_PATHS[name]) if name in KERNEL_PATHS else main_launches
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
        if name in ("sinkhorn", "sinkhorn_global"):
            k["elements_per_s"] = lines[name]["elements_per_s"]
        if lines[name].get("checks"):
            k["checks"] = lines[name]["checks"]
        kernels.append(k)
    emit({"kernels": kernels, "ate_by_path": ate_by_path})


def phase_training(by_path, ate_by_path, ba_line, pretrain=None):
    """Phase 6: the trainers, ``pretrain`` (``pretrain``: its processes,
    where they were started earlier) and the trained SuperPoint on the BA
    path (``ba_line``: the random weights' run of it)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    _, by_path["train_superpoint"], sp_trained = phase_train_superpoint()
    _, by_path["train_rcf"] = phase_train_rcf()
    _, by_path["train_superglue"] = phase_train_superglue()
    _, by_path["superglue_bank"] = phase_superglue_bank()
    _, by_path["cli_pretrain"] = phase_cli_pretrain(pretrain)
    gc.collect()
    torch.cuda.empty_cache()
    line, by_path["end_to_end_trained"] = phase_end_to_end_trained(sp_trained, ba_line)
    ate_by_path["end_to_end_trained"] = line["ate_rmse_m"]


def phase_parallel(by_path, ate_by_path, ba_line):
    """The ``parallel/`` phases: ``multi_sequence`` (launch counters reset
    just before), then ``batched_ba`` on what it mapped and ``dist_ba`` on
    the loop path's map."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    line, by_path["multi_sequence"], msq = phase_multi_sequence(ba_line)
    ate_by_path["multi_sequence"] = [d["ate_rmse_m"] for d in line["sequences_detail"]]
    phase_batched_ba(msq)
    small, _ = msq.slams[0].global_ba_problem()
    del msq  # the frontends' networks: the next phase's memory is its own
    gc.collect()
    torch.cuda.empty_cache()
    phase_dist_ba(small)


def main(argv) -> int:
    if not os.path.isdir(os.path.join(ROOT, "rspl_slam_tpu_torch")):
        print("chip_smoke: the rspl_slam_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    if argv[:1] == ["--dist-ba-rank"]:
        return _dist_rank(argv[1:])
    sys.path.insert(0, ROOT)
    phase_device()
    try:
        return run_phases(argv)
    finally:
        stop_background()


def run_phases(argv) -> int:
    import torch

    phase_build()
    lines = {}
    lines["conv_stem"] = check_conv_stem(side=False)
    lines["conv_stem_side"] = check_conv_stem(side=True)
    lines["superglue_layer"] = check_superglue_layer(bf16=True)
    lines["superglue_layer_f32"] = check_superglue_layer(bf16=False)
    lines["superglue_layer_two_set"] = check_superglue_layer_two_set(bf16=True)
    lines["superglue_layer_two_set_f32"] = check_superglue_layer_two_set(bf16=False)
    lines["sinkhorn"] = check_sinkhorn()
    lines["superglue_layer_streamed"] = check_superglue_layer_streamed()
    lines["sinkhorn_global"] = check_sinkhorn_global()
    phase_png_unfilter()
    by_path, ate_by_path = {}, {}
    if "--kernels" not in argv and "--unequal" not in argv and "--configs" not in argv:
        phase_batch_kernels(lines)
    if "--unequal" in argv:
        _, by_path["unequal"] = phase_unequal()
    elif "--configs" in argv:
        by_path["configs"] = phase_configs()
        gc.collect()
        torch.cuda.empty_cache()
        _, by_path["large_k"] = phase_large_k()
    elif "--native" in argv:
        merge_inputs = []
        line, by_path["end_to_end_lines"], run = phase_end_to_end(
            lines=True, name="end_to_end_lines", record_merge=merge_inputs)
        ate_by_path["end_to_end_lines"] = line["ate_rmse_m"]
        del run
        phase_merge_ab(line)
        gc.collect()
        torch.cuda.empty_cache()
        line, by_path["cli_run"], ctx = phase_cli_run()
        ate_by_path["cli_run"] = line["keyframe_ate_rmse_m"]
        phase_native(ctx["tree"], merge_inputs)
        _, by_path["image_kinds"] = phase_image_kinds(ctx, line)
        _, by_path["cli_photo"] = phase_cli_photo()
    elif "--parallel" in argv:
        _, by_path["end_to_end_loop"], frames, _ = phase_end_to_end_loop()  # dist_ba's map
        del frames
        phase_parallel(by_path, ate_by_path, None)
    elif "--training" in argv:
        ba_line, by_path["end_to_end_ba"], run = phase_end_to_end(lines=True, ba=True)
        ate_by_path["end_to_end_ba"] = ba_line["ate_rmse_m"]
        del run
        phase_training(by_path, ate_by_path, ba_line)
    elif "--kernels" not in argv:
        start_prerender()  # the host's idle cores render the later phases' frames
        phase_local_ba_check("--profile" in argv)
        repeat, merge_inputs = None, []
        for name, kw in (("end_to_end_ba", dict(lines=True, ba=True)),
                         ("end_to_end_ba_repeat", dict(lines=True, ba=True)),
                         ("end_to_end_lines", dict(lines=True, record_merge=merge_inputs)),
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
        _, by_path["unequal"] = phase_unequal()
        gc.collect()
        torch.cuda.empty_cache()
        by_path["configs"] = phase_configs()
        gc.collect()
        torch.cuda.empty_cache()
        _, by_path["large_k"] = phase_large_k()
        gc.collect()
        torch.cuda.empty_cache()
        # CLI runs that need nothing of the phases before theirs run beside
        # the loop path and the phases after it, each gated in its place
        early = {"photo": start_cli_photo(), "synth": start_cli_synth(),
                 "pretrain": start_cli_pretrain()}
        line, by_path["end_to_end_loop"], frames, gt = phase_end_to_end_loop()
        ate_by_path["end_to_end_loop"] = line["keyframe_ate_after_global_m"]
        line, by_path["reloc"] = phase_reloc(frames, gt)
        del frames
        line, by_path["epipolar"] = phase_epipolar()
        ate_by_path["epipolar"] = line["ate_rmse_m"]
        phase_parallel(by_path, ate_by_path, ba_line)
        line, by_path["cli_run"], ctx = phase_cli_run()
        ate_by_path["cli_run"] = line["keyframe_ate_rmse_m"]
        phase_native(ctx["tree"], merge_inputs)
        _, by_path["image_kinds"] = phase_image_kinds(ctx, line)
        _, by_path["cli_photo"] = phase_cli_photo(early["photo"])
        _, by_path["cli_global"] = phase_cli_global(ctx)
        phase_cli_synth(early["synth"])
        phase_cli_convert()
        phase_training(by_path, ate_by_path, ba_line, early["pretrain"])
    shutil.rmtree(WORK, ignore_errors=True)
    phase_summary(lines, by_path, ate_by_path)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
