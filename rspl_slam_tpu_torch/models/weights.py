"""Weight bridge: the JAX package's parameter pytrees (nested dicts and
lists of numpy arrays, in the layouts of ``superpoint.init_params`` and
``superglue.init_params`` and ``rcf.init_params`` there) → the port's
modules on a device.

``load_npz_pytree`` reads the flattened ``.npz`` pytree that either
package's ``convert-weights`` writes (``save_npz_pytree``), with numpy
alone; ``load_weights`` / ``load_params`` also read the public ``.pth``
checkpoints through each model's ``load_torch_weights``. Conv weights
arrive HWIO and are laid out for ``F.conv2d`` and K1 by the SuperPoint
and RCF modules (RCF also folds each side branch into its stage score);
SuperGlue's head permutation is already absorbed in the pytree, so the
bridge copies it as it is.

The trainers (``training/``) hold the same pytree as f32 leaf tensors
(``to_tensor_tree``, ``tree_leaves``) and hand it back as numpy
(``to_numpy_tree``), which every loader above and ``save_npz_pytree``
take.
"""

from __future__ import annotations

import numpy as np
import torch

from rspl_slam_tpu_torch.config import SuperGlueConfig

__all__ = ["flatten_pytree", "save_npz_pytree", "load_npz_pytree", "load_weights",
           "load_params", "to_numpy_tree", "to_tensor_tree", "tree_leaves",
           "superpoint_from_numpy", "superglue_from_numpy", "rcf_from_numpy"]


def flatten_pytree(params) -> dict:
    """Nested dict/list pytree → {"a/b/0/w": ndarray} flat dict."""
    flat = {}

    def rec(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                rec(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                rec(f"{prefix}/{i}", v)
        else:
            flat[prefix] = np.asarray(obj)

    rec("", params)
    return flat


def save_npz_pytree(path: str, params) -> int:
    """Write a pytree as a flattened, compressed ``.npz``; returns the
    number of arrays."""
    flat = flatten_pytree(params)
    np.savez_compressed(path, **flat)
    return len(flat)


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
    """Any array-like leaves (numpy, torch tensors on any device, or arrays
    exposing ``__array__``) → numpy, keeping the dict/list structure."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def to_tensor_tree(tree, device, requires_grad: bool = False):
    """The same structure with every leaf a new f32 tensor on ``device``
    (a leaf of autograd's graph with ``requires_grad``)."""
    if isinstance(tree, dict):
        return {k: to_tensor_tree(v, device, requires_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_tensor_tree(v, device, requires_grad) for v in tree]
    t = torch.tensor(to_numpy_tree(tree), dtype=torch.float32, device=device)
    return t.requires_grad_(requires_grad)


def tree_leaves(tree) -> list:
    """The leaves in :func:`flatten_pytree`'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def superpoint_from_numpy(params, device="cuda"):
    from rspl_slam_tpu_torch.models.superpoint import SuperPoint

    return SuperPoint(to_numpy_tree(params)).to(device)


def superglue_from_numpy(params, cfg: SuperGlueConfig | None = None, device="cuda"):
    from rspl_slam_tpu_torch.models.superglue import SuperGlue

    return SuperGlue(to_numpy_tree(params), cfg or SuperGlueConfig(), device)


def rcf_from_numpy(params, device="cuda"):
    from rspl_slam_tpu_torch.models.rcf import RCF

    return RCF(to_numpy_tree(params)).to(device)


def load_weights(path: str, torch_loader, *args):
    """Dispatch on extension: ``.npz`` → numpy pytree, else
    ``torch_loader(path, *args)``."""
    if str(path).endswith(".npz"):
        return load_npz_pytree(path)
    return torch_loader(path, *args)


def load_params(path: str, model: str, cfg: SuperGlueConfig | None = None):
    """Parameters of ``model`` ("superpoint", "superglue" or "rcf") from a
    ``.npz`` pytree or a public ``.pth`` checkpoint (``cfg``: SuperGlue's
    layout, for its head permutation)."""
    from rspl_slam_tpu_torch.models import rcf, superglue, superpoint

    if model == "superglue":
        return load_weights(path, superglue.load_torch_weights, cfg)
    loader = {"superpoint": superpoint.load_torch_weights,
              "rcf": rcf.load_torch_weights}[model]
    return load_weights(path, loader)
