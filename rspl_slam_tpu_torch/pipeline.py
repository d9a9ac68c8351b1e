"""Pipelined SLAM runner (port of pipeline.py): the reference's two-thread
pipeline (ExtractFeatureThread ∥ TrackingThread with bounded queues).

Three stages:

- **prefetch** thread: dataset reads into a bounded queue (depth 3);
- **extract** thread: ``frontend.extract_pair`` of each frame, issued on a
  CUDA stream of its own on a card; an event recorded after each frame goes
  with it down the feature queue (depth 2). Once the combined frame step
  applies (``SLAMSystem.wants_images``), the raw images go down instead and
  the tracking thread extracts and tracks them as one chain;
- **track** (the caller's thread): ``add_frame_features`` (or ``add_frame``
  for raw images), keyframes, mapping, BA. Before it touches a frame's
  device tensors it makes its current stream wait on the frame's event, and
  marks them as used on that stream (``record_stream``), so the caching
  allocator does not hand their memory back to the extract stream early.

Queues block on put (backpressure). On the CPU there are no streams.
"""

from __future__ import annotations

import contextlib
import queue
import threading

import torch

__all__ = ["PipelinedRunner"]

_SENTINEL = object()


class _RawImages:
    """Queue marker: an unextracted stereo pair headed for the combined
    extraction + tracking step (``SLAMSystem.add_frame``)."""

    __slots__ = ("il", "ir")

    def __init__(self, il, ir):
        self.il = il
        self.ir = ir


class _Slice:
    """The first ``n`` frames of a dataset."""

    def __init__(self, dataset, n: int):
        self.dataset = dataset
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i]


class PipelinedRunner:
    def __init__(self, slam, dataset=None, queue_depth: int = 3, feature_depth: int = 2,
                 on_record=None):
        """``slam``: a SLAMSystem. ``dataset``: an indexable of
        ``datasets.StereoFrame`` for the prefetch stage, or None to feed
        frames with :meth:`feed`. ``on_record(record, feats)``: called from
        the tracking thread after each frame."""
        self.slam = slam
        self.dataset = dataset
        self.on_record = on_record
        self._device = slam.device
        self._img_q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._feat_q: queue.Queue = queue.Queue(maxsize=feature_depth)
        self._extract_thread = threading.Thread(target=self._extract_loop, daemon=True)
        self._prefetch_thread = None
        self._error = None

    # ------------------------------------------------------------- plumbing
    def _prefetch_loop(self):
        try:
            for i in range(len(self.dataset)):
                fr = self.dataset[i]
                self._img_q.put((fr.index, fr.time, fr.image_left, fr.image_right))
        except Exception as e:  # surfaces in run()
            self._error = e
        finally:
            self._img_q.put(_SENTINEL)

    def _extract_loop(self):
        try:
            stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                while True:
                    item = self._img_q.get()
                    if item is _SENTINEL:
                        break
                    index, t, il, ir = item
                    if getattr(self.slam, "wants_images", lambda: False)():
                        self._feat_q.put((index, t, _RawImages(il, ir), None))
                        continue
                    feats = self.slam.frontend.extract_pair(il, ir)
                    ready = None
                    if stream is not None:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    self._feat_q.put((index, t, feats, ready))
        except Exception as e:  # surfaces in run()
            self._error = e
        finally:
            self._feat_q.put(_SENTINEL)

    def _consume(self):
        """Track every frame of the feature queue; the records."""
        records = []
        while True:
            item = self._feat_q.get()
            if item is _SENTINEL:
                break
            index, t, feats, ready = item
            if isinstance(feats, _RawImages):
                rec = self.slam.add_frame(index, t, feats.il, feats.ir)
                feats = self.slam._last_feats
            else:
                if ready is not None:
                    cur = torch.cuda.current_stream(self._device)
                    cur.wait_event(ready)
                    for x in feats.device_tensors():
                        x.record_stream(cur)
                rec = self.slam.add_frame_features(index, t, feats)
            if self.on_record is not None:
                self.on_record(rec, feats)
            records.append(rec)
        if self._error is not None:
            raise self._error
        return records

    # ------------------------------------------------------------------ api
    def feed(self, index: int, t: float, img_l, img_r):
        """Manual feeding (a live camera). Blocks when the pipeline is 3
        frames behind."""
        self._img_q.put((index, t, img_l, img_r))

    def close_input(self):
        self._img_q.put(_SENTINEL)

    def run(self, max_frames: int | None = None):
        """Process the whole dataset (or its first ``max_frames`` frames)
        through the pipeline. Returns the list of FrameRecords."""
        if self.dataset is None:
            raise ValueError("run() needs a dataset; use feed() and run_manual()")
        if max_frames is not None:
            self.dataset = _Slice(self.dataset, min(len(self.dataset), max_frames))
        self._prefetch_thread = threading.Thread(target=self._prefetch_loop, daemon=True)
        self._prefetch_thread.start()
        self._extract_thread.start()
        return self._consume()

    def run_manual(self):
        """Consume frames given to :meth:`feed` until :meth:`close_input`.
        Call from the tracking thread."""
        self._extract_thread.start()
        return self._consume()
