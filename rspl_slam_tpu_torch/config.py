"""Typed configuration for the SLAM engine.

Replaces the reference's header-only YAML structs (read_configs.h:9-85) with
frozen dataclasses. YAML files in the reference's format
(configs/configs_euroc.yaml + configs/euroc.yaml camera calibration) load
directly, so a user of the reference can reuse their configs unchanged.

Unlike the reference (which hard-fails on missing keys), every field has the
reference's shipped default so the engine is usable without any YAML at all.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence

import numpy as np

__all__ = [
    "SuperPointConfig",
    "SuperGlueConfig",
    "LineDetectorConfig",
    "KeyframeConfig",
    "TrackingThresholds",
    "OptimizationConfig",
    "CameraConfig",
    "PipelineConfig",
    "SystemConfig",
    "load_system_config",
    "load_camera_config",
]


@dataclass(frozen=True)
class SuperPointConfig:
    """SuperPoint extraction parameters (read_configs.h SuperPointConfig).

    ``max_keypoints`` doubles as the static keypoint capacity K of every
    on-device feature tensor: extraction always yields exactly K slots with
    a validity mask (TPU fixed-shape discipline), where the reference kept
    dynamic N and re-profiled TensorRT (super_point.cpp:47-53).
    """

    max_keypoints: int = 400
    keypoint_threshold: float = 0.004
    remove_borders: int = 4
    nms_radius: int = 4
    descriptor_dim: int = 256
    weights_path: str | None = None  # .pth / .npz; None → random init


@dataclass(frozen=True)
class SuperGlueConfig:
    """SuperGlue matcher parameters (read_configs.h SuperGlueConfig +
    convert2onnx/superglue.py default_config)."""

    image_width: int = 752
    image_height: int = 480
    descriptor_dim: int = 256
    keypoint_encoder: tuple[int, ...] = (32, 64, 128, 256)
    num_gnn_layers: int = 18  # alternating self/cross ×9
    num_heads: int = 4
    sinkhorn_iterations: int = 100
    match_threshold: float = 0.2  # exp-score gate (super_glue.cpp:355)
    weights_path: str | None = None


@dataclass(frozen=True)
class LineDetectorConfig:
    """Line extraction + merge parameters (read_configs.h LineDetectorConfig,
    line_processor.cc:455-665)."""

    length_threshold: int = 10
    distance_threshold: float = 1.414213562
    canny_th1: float = 200.0
    canny_th2: float = 250.0
    canny_aperture_size: int = 3
    do_merge: bool = True
    angle_thr: float = 0.1
    distance_thr: float = 15.0
    ep_thr: float = 30.0  # endpoint gap threshold (pixels)
    max_lines: int = 128  # static line capacity per frame (TPU fixed shape)
    rcf_weights_path: str | None = None
    # segment detection runs on a ×1/downsample edge map, endpoints scaled
    # back up — the reference resizes ×0.5 before FLD and rescales ×2
    # (line_processor.cc:460-466); 4× fewer pixels for the Hough stage
    downsample: int = 2
    # run RCF itself at the detection scale (downsample the IMAGE before the
    # net instead of the edge map after it). The edge map is only ever
    # consumed at ×1/downsample, and edge probability is scale-robust (the
    # RCF paper averages over {0.5, 1, 1.5}-scaled inputs), so this trades
    # nothing the detector sees for ~4× fewer conv FLOPs in the heaviest
    # network of the hot loop. False reproduces the reference order exactly
    # (RCF at full res, then resize — rcf.cpp:86, line_processor.cc:460).
    rcf_at_detection_scale: bool = True


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe trigger policy (read_configs.h KeyframeConfig,
    map_builder.cc:616-636)."""

    min_num_match: int = 10
    max_num_match: int = 80
    max_distance: float = 0.5
    max_angle: float = 0.52
    max_num_passed_frame: int = 300


@dataclass(frozen=True)
class TrackingThresholds:
    """Per-term chi² outlier gates (read_configs.h OptimizationConfig)."""

    mono_point: float = 50.0
    stereo_point: float = 75.0
    mono_line: float = 50.0
    stereo_line: float = 75.0
    rate: float = 0.5


@dataclass(frozen=True)
class OptimizationConfig:
    tracking: TrackingThresholds = field(default_factory=TrackingThresholds)
    backend: TrackingThresholds = field(default_factory=TrackingThresholds)
    # Solver shape/iteration structure (g2o_optimization.cc:171-210, 336-388)
    pose_rounds: int = 4
    pose_iters_per_round: int = 10
    ba_iters_phase1: int = 10
    ba_iters_phase2: int = 5
    pixel_sigma: float = 0.8
    line_info_scale: float = 0.1  # line information = 0.1·I (map.cc:696)
    max_window_keyframes: int = 10  # ≤9 covisible + 1 fixed (map.cc:472)


@dataclass(frozen=True)
class CameraConfig:
    """Rectified stereo pinhole camera (camera.cc:9-91).

    fx/fy/cx/cy come from the rectified projection matrix LEFT.P; ``bf`` is
    baseline×fx. Disparity gates derive from the depth range exactly like
    camera.cc:21-23.
    """

    image_width: int = 752
    image_height: int = 480
    fx: float = 435.2046959714599
    fy: float = 435.2046959714599
    cx: float = 367.4517211914062
    cy: float = 252.2008514404297
    bf: float = 47.90639384423901
    depth_lower_thr: float = 0.1
    depth_upper_thr: float = 10.0
    max_y_diff: float = 2.0
    distortion_type: int = 0  # 0 radtan, 1 fisheye/equidistant
    # Raw (pre-rectification) calibration, optional; used only to build
    # rectification maps for distorted input.
    left_K: tuple[float, ...] | None = None
    left_D: tuple[float, ...] | None = None
    left_R: tuple[float, ...] | None = None
    left_P: tuple[float, ...] | None = None
    right_K: tuple[float, ...] | None = None
    right_D: tuple[float, ...] | None = None
    right_R: tuple[float, ...] | None = None
    right_P: tuple[float, ...] | None = None

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def min_x_diff(self) -> float:
        return self.bf / self.depth_upper_thr

    @property
    def max_x_diff(self) -> float:
        return self.bf / self.depth_lower_thr


@dataclass(frozen=True)
class PipelineConfig:
    """Host pipeline / capacity knobs (no reference counterpart — replaces
    the thread+queue machinery of map_builder.h:77-88 with explicit async
    stage depths and static device capacities)."""

    queue_depth: int = 3  # ≙ _data_buffer cap (map_builder.cc:63)
    tracking_queue_depth: int = 2
    max_map_keyframes: int = 4096
    max_map_points: int = 1 << 17
    max_map_lines: int = 4096
    ba_max_points: int = 1536  # window landmark capacity for the BA kernel
    ba_max_lines: int = 128
    compute_dtype: str = "bfloat16"  # convnet/attention dtype
    # Extract right-image features lazily, only when a frame becomes a
    # keyframe — the reference's schedule (InsertKeyframe runs
    # ExtractFeatureAndMatch on the right image, map_builder.cc:639-682;
    # tracked frames carry left features only, so per-frame pose
    # optimization is mono). False = extract both eyes every frame
    # (richer stereo tracking; one batched dispatch).
    lazy_right_extraction: bool = False
    # Local-map association at keyframe insertion: project covisible
    # landmarks the temporal match missed into the new keyframe and
    # re-associate by descriptor (map_store.search_by_projection ≙ the
    # reference's defined-but-never-called TrackLocalMap machinery,
    # map_builder.cc:684-785 / map.cc:952-1005). Extra observations
    # tighten the BA window — this is a strict superset of the
    # reference's data association.
    track_local_map: bool = False
    # Epipolar outlier rejection on matches: the reference's optional
    # cv::findFundamentalMat(FM_RANSAC, 3, 0.99) pass after SuperGlue
    # (point_matching.cc:35-45; default OFF there too — its call sites
    # never enable it). On: every matcher output is filtered through
    # ops.matching.fundamental_ransac_inliers; the fused one-dispatch
    # paths fall back to the explicit multi-call schedule.
    match_outlier_rejection: bool = False
    # Combine extraction + tracking of a frame into ONE dispatch chain
    # (frame_step.CombinedTracker) when the frontend supports it
    # (lazy-right NeuralFrontend): strictly fewer host↔device round trips
    # per frame. Off → two fused chains (extract ∥ track threads).
    combined_frame_step: bool = True
    # Asynchronous local BA: dispatch the window solve at keyframe
    # insertion WITHOUT blocking on the result; fetch + scatter it at the
    # next keyframe (or at any global operation / save). Tracking between
    # keyframes runs against the pre-BA map — a one-keyframe staleness the
    # pose-only LM absorbs (oracle ATE parity pinned in
    # test_slam.TestAsyncBA). The reference blocks its tracking thread on
    # every local BA (map_builder.cc:187-262); async overlaps the whole
    # solve with tracking (+38% measured real-loop fps). ``false``
    # restores the reference's blocking schedule.
    async_ba: bool = True


@dataclass(frozen=True)
class SystemConfig:
    superpoint: SuperPointConfig = field(default_factory=SuperPointConfig)
    superglue: SuperGlueConfig = field(default_factory=SuperGlueConfig)
    line_detector: LineDetectorConfig = field(default_factory=LineDetectorConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    use_lines: bool = True


# ---------------------------------------------------------------------------
# YAML loading (reference-format compatible)
# ---------------------------------------------------------------------------


def _strip_opencv(text: str) -> str:
    """OpenCV YAML directives (%YAML:1.0) and ``!!opencv-matrix`` tags choke
    strict loaders: strip them to plain maps."""
    text = re.sub(r"^%YAML:.*$", "", text, flags=re.M)
    return text.replace("!!opencv-matrix", "")


def _load_yaml(path: str) -> dict:
    """Parse YAML. Uses PyYAML if present; falls back to :func:`_mini_yaml`,
    which reads the subset the repo's config files use."""
    try:
        import yaml  # type: ignore
    except ImportError:
        return _mini_yaml(path)
    with open(path) as f:
        return yaml.safe_load(_strip_opencv(f.read())) or {}


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment: one at the start or after whitespace, outside
    quotes (YAML's rule)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow_items(body: str) -> list:
    """The items of a flat flow sequence's body (between the brackets)."""
    return [_scalar(x) for x in body.split(",") if x.strip()]


def _mini_yaml(path: str) -> dict:
    """Indentation-based parser of the YAML subset the config files use,
    for machines without PyYAML: nested block maps, scalars resolved as
    PyYAML resolves them (YAML 1.1), flow sequences ``[a, b, ...]`` that
    may wrap over several lines (the OpenCV matrix blocks), block
    sequences of scalars, comments, ``%YAML`` directives and
    ``!!opencv-matrix`` tags. It returns what ``yaml.safe_load`` returns
    on the stripped text of those files."""
    with open(path) as f:
        lines = _strip_opencv(f.read()).splitlines()
    root: dict[str, Any] = {}
    stack: list[tuple[int, Any]] = [(-1, root)]
    last_key: str | None = None
    i = 0
    while i < len(lines):
        line = _strip_comment(lines[i]).rstrip()
        i += 1
        stripped = line.strip()
        if not stripped or stripped.startswith("%"):
            continue
        indent = len(line) - len(line.lstrip())
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if stripped.startswith("-") and stripped[1:2] in ("", " "):
            if isinstance(parent, dict) and last_key is not None:
                if parent.get(last_key) is None:
                    parent[last_key] = []
                parent[last_key].append(_scalar(stripped[1:]))
            continue
        if ":" not in stripped:
            raise ValueError(f"{path}:{i}: unsupported YAML line {stripped!r}")
        key, _, rest = stripped.partition(":")
        key = _scalar(key)
        rest = rest.strip()
        last_key = key
        if rest.startswith("["):
            # a flow sequence, possibly wrapped over the following lines
            while "]" not in rest:
                if i >= len(lines):
                    raise ValueError(f"{path}: unterminated flow sequence at {key!r}")
                rest += " " + _strip_comment(lines[i]).strip()
                i += 1
            parent[key] = _flow_items(rest[1:rest.index("]")])
        elif rest:
            parent[key] = _scalar(rest)
        else:
            # a nested map or a block sequence follows (None if neither)
            parent[key] = None
            child: dict = {}
            j = i
            while j < len(lines) and not _strip_comment(lines[j]).strip():
                j += 1
            if j < len(lines):
                nxt = _strip_comment(lines[j])
                nind = len(nxt) - len(nxt.lstrip())
                if nind > indent and not nxt.strip().startswith("- "):
                    parent[key] = child
                    stack.append((indent, child))
    return root


_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9_]+(?:[eE][-+][0-9]+)?
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"),
                         True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}


def _scalar(s: str):
    """A plain or quoted scalar, typed by YAML 1.1's rules as PyYAML applies
    them: ``1e-5`` (no dot) stays a string, ``1.0e-05`` is a float."""
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return s


def _filter_kwargs(cls, d: Mapping[str, Any]) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    out = {}
    for k, v in d.items():
        if k in names:
            if isinstance(v, list):
                v = tuple(v)
            out[k] = v
    return out


def _matrix(d: Mapping[str, Any] | Sequence[float] | None) -> tuple[float, ...] | None:
    if d is None:
        return None
    if isinstance(d, Mapping):
        data = d.get("data")
        if data is None:
            return None
        return tuple(float(x) for x in data)
    return tuple(float(x) for x in d)


def load_camera_config(path: str) -> CameraConfig:
    """Load a reference-format stereo calibration YAML (configs/euroc.yaml).

    Reads bf/depth-range/max_y_diff and the LEFT/RIGHT K,D,R,P matrices;
    the rectified intrinsics are taken from LEFT.P like camera.cc:44-47.
    """
    d = _load_yaml(path)
    P_l = _matrix(d.get("LEFT.P"))
    kwargs: dict[str, Any] = dict(
        image_width=int(d.get("image_width", 752)),
        image_height=int(d.get("image_height", 480)),
        bf=float(d.get("bf", 47.90639384423901)),
        depth_lower_thr=float(d.get("depth_lower_thr", 0.1)),
        depth_upper_thr=float(d.get("depth_upper_thr", 10.0)),
        max_y_diff=float(d.get("max_y_diff", 2.0)),
        distortion_type=int(d.get("distortion_type", 0)),
        left_K=_matrix(d.get("LEFT.K")),
        left_D=_matrix(d.get("LEFT.D")),
        left_R=_matrix(d.get("LEFT.R")),
        left_P=P_l,
        right_K=_matrix(d.get("RIGHT.K")),
        right_D=_matrix(d.get("RIGHT.D")),
        right_R=_matrix(d.get("RIGHT.R")),
        right_P=_matrix(d.get("RIGHT.P")),
    )
    if P_l is not None:
        kwargs.update(fx=P_l[0], fy=P_l[5], cx=P_l[2], cy=P_l[6])
    return CameraConfig(**kwargs)


def load_system_config(
    algo_yaml: str | None = None, camera_yaml: str | None = None
) -> SystemConfig:
    """Load the reference-format pair of YAMLs (algorithm + camera).

    Either path may be None, in which case defaults (EuRoC values) apply.
    """
    sp = SuperPointConfig()
    sg = SuperGlueConfig()
    ld = LineDetectorConfig()
    kf = KeyframeConfig()
    opt = OptimizationConfig()
    if algo_yaml is not None:
        d = _load_yaml(algo_yaml)
        sp = SuperPointConfig(**_filter_kwargs(SuperPointConfig, d.get("superpoint", {})))
        sg = SuperGlueConfig(**_filter_kwargs(SuperGlueConfig, d.get("superglue", {})))
        ld_raw = dict(d.get("line_detector", {}))
        if "do_merge" in ld_raw:
            ld_raw["do_merge"] = bool(ld_raw["do_merge"])
        ld = LineDetectorConfig(**_filter_kwargs(LineDetectorConfig, ld_raw))
        kf = KeyframeConfig(**_filter_kwargs(KeyframeConfig, d.get("keyframe", {})))
        od = d.get("optimization", {})
        opt = OptimizationConfig(
            tracking=TrackingThresholds(
                **_filter_kwargs(TrackingThresholds, od.get("tracking", {}))
            ),
            backend=TrackingThresholds(
                **_filter_kwargs(TrackingThresholds, od.get("backend", {}))
            ),
        )
    cam = load_camera_config(camera_yaml) if camera_yaml is not None else CameraConfig()
    return SystemConfig(
        superpoint=sp, superglue=sg, line_detector=ld, keyframe=kf,
        optimization=opt, camera=cam,
    )


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m`` (TPU lane/sublane alignment)."""
    return ((x + m - 1) // m) * m
