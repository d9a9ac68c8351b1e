"""Weight bridge: the JAX package's parameter pytrees (nested dicts and
lists of numpy arrays, in the layouts of ``superpoint.init_params`` and
``superglue.init_params`` there) → the port's modules on a device.

``load_npz_pytree`` reads the flattened ``.npz`` pytree that the JAX CLI's
``convert-weights`` writes, with numpy alone. Conv weights arrive HWIO and
are laid out for ``F.conv2d`` and K1 by the SuperPoint module; SuperGlue's
head permutation is already absorbed in the pytree, so the bridge copies it
as it is.
"""

from __future__ import annotations

import numpy as np

from rspl_slam_tpu_torch.config import SuperGlueConfig

__all__ = ["load_npz_pytree", "to_numpy_tree", "superpoint_from_numpy",
           "superglue_from_numpy"]


def load_npz_pytree(path: str):
    """Rebuild the nested pytree of a flattened ``.npz`` (integer path
    components become list indices)."""
    data = np.load(path)
    root: dict = {}
    for key in data.files:
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(data[key])

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def to_numpy_tree(tree):
    """Any array-like leaves (numpy, or arrays exposing ``__array__``) →
    numpy, keeping the dict/list structure."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def superpoint_from_numpy(params, device="cuda"):
    from rspl_slam_tpu_torch.models.superpoint import SuperPoint

    return SuperPoint(to_numpy_tree(params)).to(device)


def superglue_from_numpy(params, cfg: SuperGlueConfig | None = None, device="cuda"):
    from rspl_slam_tpu_torch.models.superglue import SuperGlue

    return SuperGlue(to_numpy_tree(params), cfg or SuperGlueConfig(), device)


def load_params(path: str):
    """Parameters from a weight file: ``.npz`` pytrees only in this port."""
    if not str(path).endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz pytrees load in the port; the .pth loaders are "
            "queued in ROADMAP.md (modules to port)")
    return load_npz_pytree(path)
