"""Pretrained-checkpoint and dataset discovery (port of utils/artifacts.py).

Finds the three public checkpoints (SuperPoint ``superpoint_v1.pth``,
SuperGlue ``superglue_outdoor.pth``, the RCF BSDS+PASCAL model) and an
EuRoC-layout dataset root in standard places, so drivers pick them up
without code changes.

Weights, first hit wins: the per-model variables ``RSPL_SUPERPOINT_WEIGHTS``
/ ``RSPL_SUPERGLUE_WEIGHTS`` / ``RSPL_RCF_WEIGHTS``, then the directories
``extra_dirs``, ``$RSPL_WEIGHTS_DIR`` and ``<repo>/weights``, scanned for the
conventional file names below. Dataset root: ``extra_dirs``,
``$RSPL_DATA_DIR`` and ``<repo>/data``, each searched two levels deep for a
directory that ``datasets.open_dataset`` opens with at least one frame.
"""

from __future__ import annotations

import os

__all__ = ["find_pretrained", "find_dataset_root", "WEIGHT_FILENAMES"]

WEIGHT_FILENAMES = {
    # conventional public checkpoint names, most specific first
    "superpoint": ("superpoint_v1.pth", "superpoint.pth", "superpoint_v1.npz",
                   "superpoint.npz"),
    "superglue": ("superglue_outdoor.pth", "superglue_indoor.pth", "superglue.pth",
                  "superglue_outdoor.npz", "superglue.npz"),
    "rcf": ("bsds500_pascal_model.pth", "RCF-pytorch.pth", "rcf.pth", "rcf.npz"),
}

_ENV_VARS = {
    "superpoint": "RSPL_SUPERPOINT_WEIGHTS",
    "superglue": "RSPL_SUPERGLUE_WEIGHTS",
    "rcf": "RSPL_RCF_WEIGHTS",
}

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _dirs(extra_dirs, env: str, sub: str) -> list:
    dirs = list(extra_dirs)
    if os.environ.get(env):
        dirs.append(os.environ[env])
    return dirs + [os.path.join(_REPO, sub)]


def find_pretrained(extra_dirs=()) -> dict:
    """{"superpoint": path, "superglue": path, "rcf": path} for every model
    whose checkpoint was found; missing models are absent. The per-model
    variables win over directory scans."""
    found = {}
    for model, env in _ENV_VARS.items():
        p = os.environ.get(env)
        if p and os.path.isfile(p):
            found[model] = p
    for d in _dirs(extra_dirs, "RSPL_WEIGHTS_DIR", "weights"):
        if not os.path.isdir(d):
            continue
        for model, names in WEIGHT_FILENAMES.items():
            if model in found:
                continue
            for name in names:
                p = os.path.join(d, name)
                if os.path.isfile(p):
                    found[model] = p
                    break
    return found


def _is_dataset(path: str) -> bool:
    from rspl_slam_tpu_torch.datasets import open_dataset

    try:
        return len(open_dataset(path)) > 0
    except FileNotFoundError:
        return False


def find_dataset_root(extra_dirs=()) -> str | None:
    """The first directory (searched two levels deep under the roots) that
    ``datasets.open_dataset`` opens with ≥ 1 frame, or None."""
    for root in _dirs(extra_dirs, "RSPL_DATA_DIR", "data"):
        if not os.path.isdir(root):
            continue
        if _is_dataset(root):
            return root
        for sub in sorted(os.listdir(root)):
            p = os.path.join(root, sub)
            if not os.path.isdir(p):
                continue
            if _is_dataset(p):
                return p
            for sub2 in sorted(os.listdir(p)):
                q = os.path.join(p, sub2)
                if os.path.isdir(q) and _is_dataset(q):
                    return q
    return None
