"""Visualization dumps (port of visualization.py): feature and line
overlays as PNG, PLY point and line maps, a top-down trajectory image, all
written on a background thread (:class:`AsyncDumper`) so that visualization
never holds up tracking; :class:`FramePublisher` is the per-frame
observability hook of the runner.

PNGs go through the port's own writer (``png.py``) and the trajectory plot
is rasterized here: neither PIL nor matplotlib is needed.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

from rspl_slam_tpu_torch import png

__all__ = ["draw_features", "keyframe_overlay", "save_png", "save_ply_points",
           "save_ply_lines", "save_trajectory_png", "AsyncDumper", "FramePublisher"]


def _color_for_track(tid: int):
    """Deterministic per-track color (utils.cc GenerateColor)."""
    rng = np.random.default_rng(tid * 2654435761 % (1 << 32))
    return rng.integers(64, 255, 3).tolist()


def draw_features(image: np.ndarray, xy: np.ndarray, valid: np.ndarray,
                  track_ids=None, lines=None, line_valid=None,
                  line_track_ids=None) -> np.ndarray:
    """Feature/line overlay ≙ DrawFeatures (utils.cc:35-69): keypoints as
    colored squares (color by track id); detected-but-unmatched lines in
    green, lines associated with a mapline drawn THICK in their track's
    color (the reference colors matched lines per line-track id,
    utils.cc:52-66). Returns an RGB uint8 image."""
    H, W = image.shape
    img = np.repeat((np.clip(image, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1)
    for i in np.nonzero(valid)[0]:
        x, y = int(round(xy[i, 0])), int(round(xy[i, 1]))
        c = _color_for_track(int(track_ids[i]) if track_ids is not None and track_ids[i] >= 0 else i)
        x0, x1 = max(0, x - 2), min(W, x + 3)
        y0, y1 = max(0, y - 2), min(H, y + 3)
        img[y0:y1, x0:x1] = c
    if lines is not None:
        for li in np.nonzero(line_valid)[0]:
            x1f, y1f, x2f, y2f = lines[li]
            tid = -1 if line_track_ids is None or li >= len(line_track_ids) \
                else int(line_track_ids[li])
            color = _color_for_track(1_000_003 + tid) if tid >= 0 \
                else [0, 255, 0]
            r = 1 if tid >= 0 else 0  # matched lines render thick
            n = int(max(abs(x2f - x1f), abs(y2f - y1f))) + 1
            for t in np.linspace(0, 1, n):
                x = int(round((1 - t) * x1f + t * x2f))
                y = int(round((1 - t) * y1f + t * y2f))
                if 0 <= x < W and 0 <= y < H:
                    img[max(0, y - r): y + r + 1,
                        max(0, x - r): x + r + 1] = color
    return img


def keyframe_overlay(m, kf: int, image: np.ndarray | None = None,
                     height: int | None = None,
                     width: int | None = None) -> np.ndarray:
    """Overlay of a STORED keyframe rendered straight from the map arrays:
    keypoints colored by mappoint track, detected lines green,
    mapline-matched lines thick in their track color — the qualitative
    check the reference's DrawFeatures/debug renderers provide
    (utils.cc:35-69, debug.h:19-253). ``image``: optional background
    (grayscale float [0,1]); otherwise a black canvas of (height, width) —
    oracle/synthetic runs keep no pixels but their geometry still needs
    eyeballing."""
    if image is None:
        image = np.zeros((height, width), np.float32)
    return draw_features(
        image, m.kf_meas[kf, :, :2], m.kf_kpt_valid[kf],
        track_ids=m.kf_track[kf],
        lines=m.kf_lines[kf], line_valid=m.kf_line_valid[kf],
        line_track_ids=m.kf_line_track[kf],
    )


def save_png(path: str, rgb: np.ndarray):
    """Write an (H, W) or (H, W, 3|4) uint8 image as PNG (``png.py``)."""
    png.write_png(path, rgb)


def save_ply_points(path: str, points: np.ndarray, colors: np.ndarray | None = None):
    """Mappoint cloud ≙ the PointCloud topic (ros_publisher.cc:95-130)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.5f} {points[i, 1]:.5f} {points[i, 2]:.5f}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


def save_ply_lines(path: str, endpoints: np.ndarray):
    """Mapline set ≙ the LINE_LIST marker topic (ros_publisher.cc:132-183).
    endpoints: (L, 2, 3)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    L = len(endpoints)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {2 * L}\nproperty float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {L}\nproperty int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for seg in endpoints:
            for p in seg:
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        for i in range(L):
            f.write(f"{2 * i} {2 * i + 1}\n")


def _raster_polyline(img: np.ndarray, pts: np.ndarray, color, dash: int = 0):
    """Draw a polyline of pixel coordinates (N, 2) [col, row] into ``img``,
    two pixels wide; ``dash`` > 0 leaves every other run of that many
    samples blank."""
    H, W = img.shape[:2]
    k = 0
    for a, b in zip(pts[:-1], pts[1:]):
        n = int(max(abs(b - a).max(), 1)) + 1
        for t in np.linspace(0.0, 1.0, n):
            k += 1
            if dash and (k // dash) % 2:
                continue
            c, r = np.round((1 - t) * a + t * b).astype(int)
            img[max(0, r - 1):min(H, r + 1), max(0, c - 1):min(W, c + 1)] = color


def save_trajectory_png(path: str, poses: np.ndarray, gt: np.ndarray | None = None,
                        size: int = 640, margin: int = 32):
    """Top-down trajectory plot, x against z with equal axes, rasterized
    without a plotting library: the estimate in blue, the ground truth
    (when given) dashed in black, on white inside a gray frame."""
    tracks = [np.asarray(poses)[:, [0, 2], 3]]
    if gt is not None:
        tracks.append(np.asarray(gt)[:, [0, 2], 3])
    allp = np.concatenate(tracks)
    lo, hi = allp.min(0), allp.max(0)
    span = max(float((hi - lo).max()), 1e-6)
    scale = (size - 2 * margin) / span  # one scale for both axes
    centre = (lo + hi) / 2
    img = np.full((size, size, 3), 255, np.uint8)
    img[margin - 2:size - margin + 2, [margin - 2, size - margin + 1]] = 160
    img[[margin - 2, size - margin + 1], margin - 2:size - margin + 2] = 160

    def to_px(p):  # x → column, z → row upward
        return np.stack([size / 2 + (p[:, 0] - centre[0]) * scale,
                         size / 2 - (p[:, 1] - centre[1]) * scale], -1)

    if gt is not None:
        _raster_polyline(img, to_px(tracks[1]), (0, 0, 0), dash=6)
    _raster_polyline(img, to_px(tracks[0]), (0, 0, 255))
    save_png(path, img)


class AsyncDumper:
    """Background writer thread with a bounded queue — visualization stays
    off the hot path like the reference's publisher threads."""

    def __init__(self, maxsize: int = 8):
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:
                pass

    def submit(self, fn, *args):
        """Non-blocking: drops the dump if the queue is full (visualization
        must never backpressure tracking)."""
        try:
            self.q.put_nowait((fn, args))
        except queue.Full:
            pass

    def submit_critical(self, fn, *args):
        """Blocking: for items that must not be dropped (pose stream —
        the reference's publisher queues are unbounded,
        thread_publisher.h:30-68). Cheap writers only."""
        self.q.put((fn, args))

    def close(self):
        self.q.put(None)
        self._thread.join(timeout=5)


def _quat_from_rot_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (w, x, y, z), pure numpy so the pose
    stream never dispatches to the device."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


class FramePublisher:
    """Per-frame observability — the counterpart of the reference's feature
    overlay + frame pose publishers (ros_publisher.cc:48-93, PublishFrame at
    map_builder.cc:238): every tracked frame appends its pose to a TUM
    stream and (every ``overlay_stride``-th frame) dumps a feature/line
    overlay PNG, all on the AsyncDumper thread so visualization never
    backpressures tracking."""

    def __init__(self, out_dir: str, overlay_stride: int = 1,
                 maxsize: int = 8):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.stride = max(1, overlay_stride)
        self.dumper = AsyncDumper(maxsize=maxsize)
        self.pose_path = os.path.join(out_dir, "poses.txt")
        open(self.pose_path, "w").close()
        self.n_published = 0

    # signature matches PipelinedRunner's on_record hook
    def __call__(self, rec, feats):
        self.publish(rec, feats)

    def publish(self, rec, feats):
        self.n_published += 1
        # pose stream is appended INLINE: the write is a one-line file append
        # (~µs) and must never be delayed behind slow PNG encodes on the
        # bounded dump queue — sharing that queue would let overlays
        # backpressure the tracking thread through this hook.
        self._append_pose(rec.time, rec.Twc)
        img = getattr(feats, "image", None)
        if img is not None and rec.frame_id % self.stride == 0:
            self.dumper.submit(self._overlay, rec.frame_id, feats)

    def _append_pose(self, t, Twc):
        w, x, y, z = _quat_from_rot_np(Twc[:3, :3])
        tx, ty, tz = Twc[:3, 3]
        with open(self.pose_path, "a") as f:
            f.write(f"{t:.9f} {tx:.9f} {ty:.9f} {tz:.9f} "
                    f"{x:.9f} {y:.9f} {z:.9f} {w:.9f}\n")

    def _overlay(self, fid, feats):
        img = draw_features(
            feats.image, feats.xy, feats.valid,
            lines=feats.lines, line_valid=feats.line_valid,
            # keyframes get their mapline associations stamped on by
            # SLAMSystem._insert_keyframe — matched lines render per-track
            line_track_ids=getattr(feats, "line_tracks", None))
        save_png(os.path.join(self.out_dir, f"frame_{fid:06d}.png"), img)

    def close(self):
        self.dumper.close()
