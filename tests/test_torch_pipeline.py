"""The port's PipelinedRunner on the CPU: the lazy production loop through
the runner gives the serial ``add_frame`` loop's records, manual feeding,
a dataset error surfacing in ``run``, and the per-frame hook."""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from test_torch_common import matcher_weights, rendered_sequence, small_system_cfg

from rspl_slam_tpu_torch.datasets import StereoFrame
from rspl_slam_tpu_torch.frontend.frontends import FrameFeatures, NeuralFrontend
from rspl_slam_tpu_torch.pipeline import PipelinedRunner
from rspl_slam_tpu_torch.slam import SLAMSystem


class _Frames:
    """Indexable of StereoFrame over rendered pairs."""

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return StereoFrame(index=i, time=0.05 * i, image_left=self.frames[i][0],
                           image_right=self.frames[i][1])


class _StubFrontend:
    device = torch.device("cpu")

    def extract_pair(self, il, ir):
        return ("feats", il)


class _StubSLAM:
    """Records what reaches the tracking side."""

    def __init__(self):
        self.frontend = _StubFrontend()
        self.device = self.frontend.device

    def add_frame_features(self, index, t, feats):
        return (index, t, feats)


@pytest.fixture(scope="module")
def lazy_loop():
    """A lazy-right config (points only, BA on, async), 5 rendered 8-bit
    frames, and a factory of systems on the CPU with the shared weights."""
    cfg = small_system_cfg()
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, lazy_right_extraction=True), keyframe=dataclasses.replace(
        cfg.keyframe, max_num_match=180))
    frames, _ = rendered_sequence(cfg, 5)
    frames = [tuple((np.clip(im, 0, 1) * 255).astype(np.uint8) for im in f) for f in frames]
    sp, sg = matcher_weights(cfg)

    def system():
        return SLAMSystem(cfg, NeuralFrontend(cfg, sp_params=sp, sg_params=sg,
                                              compute_dtype=torch.float32, device="cpu"))

    return frames, system


def test_runner_matches_serial_add_frame(lazy_loop):
    """The runner (prefetch and extract threads, the combined step on the
    tracking thread once the map is initialized) gives the serial loop's
    records: the same keyframes, inlier counts and poses, bit for bit (the
    RANSAC seed follows the tracked frame, whichever route it took), and
    the same keyframe poses after the last BA flush; ``on_record`` sees
    each frame once, in order, with its features."""
    frames, system = lazy_loop
    serial = system()
    recs_s = [serial.add_frame(i, 0.05 * i, *f) for i, f in enumerate(frames)]
    serial.flush_ba()
    piped = system()
    seen = []
    recs_p = PipelinedRunner(piped, _Frames(frames),
                             on_record=lambda r, ff: seen.append((r, ff))).run()
    piped.flush_ba()
    assert len(recs_p) == len(frames) and [r for r, _ in seen] == recs_p
    assert all(isinstance(ff, FrameFeatures) for _, ff in seen)
    assert [r.frame_id for r in recs_p] == list(range(len(frames)))
    assert [r.is_keyframe for r in recs_p] == [r.is_keyframe for r in recs_s]
    assert sum(r.is_keyframe for r in recs_s) >= 2
    assert [r.num_inliers for r in recs_p] == [r.num_inliers for r in recs_s]
    for a, b in zip(recs_p, recs_s):
        np.testing.assert_array_equal(a.Twc, b.Twc)
    n = serial.map.n_kf
    assert piped.map.n_kf == n and len(piped.ba_windows) == len(serial.ba_windows) >= 1
    np.testing.assert_array_equal(piped.map.kf_pose[:n], serial.map.kf_pose[:n])
    assert "frame_combined" in piped.timings


def test_run_max_frames(lazy_loop):
    """``run(max_frames)`` stops after that many frames."""
    frames, _ = lazy_loop
    recs = PipelinedRunner(_StubSLAM(), _Frames(frames)).run(max_frames=3)
    assert [r[0] for r in recs] == [0, 1, 2]


def test_manual_feed():
    """``feed`` from another thread, ``close_input``, ``run_manual``: every
    fed frame reaches tracking once, in order, through the extract stage."""
    runner = PipelinedRunner(_StubSLAM())

    def feeder():
        for i in range(10):
            runner.feed(i, 0.05 * i, i, -i)
        runner.close_input()

    th = threading.Thread(target=feeder)
    th.start()
    recs = runner.run_manual()
    th.join()
    assert [r[0] for r in recs] == list(range(10))
    assert all(r[2] == ("feats", r[0]) for r in recs)


def test_dataset_error_surfaces():
    """An error reading the dataset ends the run and is raised by ``run``."""

    class Bad:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            if i == 1:
                raise IOError("corrupt frame")
            return StereoFrame(index=i, time=0.0, image_left=None, image_right=None)

    with pytest.raises(IOError, match="corrupt"):
        PipelinedRunner(_StubSLAM(), Bad()).run()


def test_on_record_called_once_per_frame():
    """The hook sees every record once, in order, with its features."""
    seen = []

    class Seven:
        def __len__(self):
            return 7

        def __getitem__(self, i):
            return StereoFrame(index=i, time=float(i), image_left=i, image_right=None)

    recs = PipelinedRunner(_StubSLAM(), Seven(),
                           on_record=lambda rec, feats: seen.append((rec, feats))).run()
    assert [r for r, _ in seen] == recs and [r[0] for r in recs] == list(range(7))
    assert [f for _, f in seen] == [("feats", i) for i in range(7)]


def test_run_needs_a_dataset():
    with pytest.raises(ValueError, match="dataset"):
        PipelinedRunner(_StubSLAM()).run()


def test_runner_takes_the_systems_device():
    """The runner's device is the SLAM system's, which the system takes
    from its frontend: a frontend without ``device`` fails when the system
    is built, and no entry point falls back to the CPU for it."""

    class _NoDevice:
        matcher = "superglue"

    with pytest.raises(AttributeError, match="device"):
        SLAMSystem(small_system_cfg(), _NoDevice())
    slam = _StubSLAM()
    slam.device = torch.device("meta")  # not the frontend's: the runner reads the system's
    assert PipelinedRunner(slam)._device == torch.device("meta")
