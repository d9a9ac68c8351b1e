"""Multi-sequence batched mapping (port of parallel/multi_sequence.py): N
sequences mapped in lockstep, their device work batched.

The reference processes one sequence per process; here N maps advance
together and every device stage is one batched call:

- extraction: all 2N stereo images in ONE SuperPoint call (K1 once over
  the 2N images) and the N stereo problems in ONE matcher call (K2 on the
  stacked sets, K3 at batch N), for neural frontends that share one
  SuperPoint module (``NeuralFrontend.extract_pairs_batched``); other
  frontends (the oracle's host work) loop;
- temporal matching: the N frame↔keyframe problems in ONE matcher call
  (``NeuralFrontend.match_batched``);
- bundle adjustment: the windows of the sequences that inserted a keyframe
  this step, solved together by ``dist_ba.batched_windows_ba`` on the
  sequences' device.

Tracking and the map bookkeeping stay per sequence (host numpy). Across
processes, run one MultiSequenceSLAM per rank on its own block of the
sequences (``multihost.local_batch_slice``): the ranks share nothing, so
no step waits on another rank. (The JAX package's ``mesh`` option spreads
one process's windows over its devices; a rank here drives one device, so
its windows are its own and the option has no counterpart.)
"""

from __future__ import annotations

import time

from rspl_slam_tpu_torch.config import SystemConfig
from rspl_slam_tpu_torch.parallel import dist_ba
from rspl_slam_tpu_torch.slam import SLAMSystem

__all__ = ["MultiSequenceSLAM"]


class MultiSequenceSLAM:
    def __init__(self, cfg: SystemConfig, frontends, batch_ba: bool = True):
        """``frontends``: one per sequence (oracle or neural; neural ones
        batch when they share one ``sp`` module, their per-sequence state
        apart). With ``batch_ba`` the sequences' own BA is off and their
        windows are solved together after each step."""
        self.cfg = cfg
        self.slams = [SLAMSystem(cfg, fe, enable_ba=not batch_ba) for fe in frontends]
        self.batch_ba = batch_ba
        self.ba_solves: list[int] = []  # windows per batched solve
        self.timings: dict[str, list] = {}  # host seconds per stage and step

    @property
    def n(self) -> int:
        return len(self.slams)

    def _t(self, name: str, t0: float):
        self.timings.setdefault(name, []).append(time.perf_counter() - t0)

    def step(self, frames) -> list:
        """``frames``: per sequence (index, t, img_l, img_r), or None for a
        sequence that has ended. Returns per-sequence FrameRecords (None
        where skipped)."""
        # stage 1: extraction + stereo association, batched where the
        # frontends share their SuperPoint
        t0 = time.perf_counter()
        active = [k for k, fr in enumerate(frames) if fr is not None]
        feats: list = [None] * self.n
        fes = [self.slams[k].frontend for k in active]
        can_batch = (len(active) > 1
                     and all(hasattr(f, "extract_pairs_batched") for f in fes)
                     and all(f.sp is fes[0].sp for f in fes))
        if can_batch:
            pairs = [(frames[k][2], frames[k][3]) for k in active]
            for k, f in zip(active, fes[0].extract_pairs_batched(pairs, fes)):
                feats[k] = f
        else:
            for k in active:
                feats[k] = self.slams[k].frontend.extract_pair(frames[k][2], frames[k][3])
        self._t("extract", t0)

        # stage 2: temporal matching, batched over the initialized sequences
        t0 = time.perf_counter()
        i0s = [None] * self.n
        match_idx = [k for k in active if self.slams[k].initialized]
        if can_batch and len(match_idx) > 1:
            pairs = [(feats[k], self.slams[k]._ref_feats) for k in match_idx]
            for k, i0 in zip(match_idx, fes[0].match_batched(pairs)):
                i0s[k] = i0
        else:
            for k in match_idx:
                i0s[k] = self.slams[k].frontend.match(feats[k], self.slams[k]._ref_feats)
        self._t("match", t0)

        # stage 3: per-sequence tracking + keyframe insertion (host)
        t0 = time.perf_counter()
        records, ba_requests = [], []
        for k, (s, fr) in enumerate(zip(self.slams, frames)):
            if fr is None:
                records.append(None)
                continue
            rec = s.add_frame_features(fr[0], fr[1], feats[k], i0s[k])
            records.append(rec)
            if self.batch_ba and rec.is_keyframe and s.map.n_kf >= 2:
                ba_requests.append((k, rec.kf_slot))
        self._t("track", t0)

        # stage 4: the requesting sequences' windows in one batched solve
        if ba_requests:
            t0 = time.perf_counter()
            self._run_batched_ba(ba_requests)
            self._t("ba", t0)
        return records

    def _run_batched_ba(self, requests):
        probs, metas = [], []
        for k, center in requests:
            prob, mapping = self.slams[k].gather_ba_problem(center)
            if prob is not None:
                probs.append(prob)
                metas.append((k, center, mapping))
        if not probs:
            return
        o = self.cfg.optimization
        b = o.backend
        kw = dict(chi2_mono=b.mono_point, chi2_stereo=b.stereo_point,
                  chi2_mono_line=b.mono_line, chi2_stereo_line=b.stereo_line,
                  iters1=o.ba_iters_phase1, iters2=o.ba_iters_phase2)
        res = dist_ba.batched_windows_ba(self.slams[0].K, probs,
                                         device=self.slams[0].device, **kw)
        self.ba_solves.append(len(probs))
        for r, (k, center, mapping) in zip(dist_ba.fetch_windows(res), metas):
            self.slams[k].apply_ba_result(r, mapping, center)
