"""Checkpoint / resume as numpy npz, in the JAX package's container layout.

Counterpart of `dpt_tpu/utils/checkpoint.py`.  One file holds:

  - `image` and `batch`: a progressive accumulation (an empty image for an
    optimisation run);
  - `n_extra` and `extra_<i>`: the leaves of a nested dict of tensors, in
    the order of sorted keys (the order `jax.tree_util.tree_flatten` gives
    a dict), used by `diff/optimize.py` for its parameters and optimizer
    state;
  - `meta_<k>`: an integrity guard (camera state + config key); a resume
    whose meta does not match starts fresh.

The file is written to a temporary name and renamed into place.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def flatten(tree) -> list:
    """Leaves of a nested dict, depth first in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    return [tree]


def unflatten(template, leaves, device):
    """The nested dict shaped like `template` with `leaves` (numpy arrays
    or tensors) as tensors on the template leaf's device (else `device`);
    the inverse of `flatten`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        a = next(it)
        dev = t.device if isinstance(t, torch.Tensor) else device
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return torch.as_tensor(np.array(a), device=dev)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more checkpoint leaves than the template holds")
    return out


class Checkpointer:
    def __init__(self, path: str):
        self.path = path

    def save(self, image, batch: int, extra: dict | None = None,
             meta: dict | None = None):
        arrs = {
            "image": np.asarray(image),
            "batch": np.asarray(batch, np.int64),
        }
        if extra:
            flat = flatten(extra)
            arrs["n_extra"] = np.asarray(len(flat))
            for i, a in enumerate(flat):
                if isinstance(a, torch.Tensor):
                    a = a.detach().cpu().numpy()
                arrs[f"extra_{i}"] = np.asarray(a)
        if meta:
            for k, v in meta.items():
                arrs[f"meta_{k}"] = np.asarray(v)
        tmp = self.path + ".tmp.npz"
        np.savez(tmp, **arrs)
        os.replace(tmp, self.path)

    def load(self):
        """(image ndarray, batch int, aux) or None; aux holds "extra" (the
        list of leaves as numpy arrays) and "meta" (a dict of arrays)."""
        if not os.path.exists(self.path):
            return None
        with np.load(self.path) as z:
            image = z["image"]
            batch = int(z["batch"])
            extras = []
            if "n_extra" in z:
                extras = [z[f"extra_{i}"] for i in range(int(z["n_extra"]))]
            meta = {k[len("meta_"):]: z[k] for k in z.files
                    if k.startswith("meta_")}
        return image, batch, {"extra": extras, "meta": meta}

    def exists(self) -> bool:
        return os.path.exists(self.path)


def meta_matches(meta: dict, camera_state, config_key: str) -> bool:
    """True iff a loaded checkpoint's meta matches the current framing.  A
    checkpoint without meta never matches."""
    if "camera_state" not in meta or "config_key" not in meta:
        return False
    same_cam = np.array_equal(
        np.asarray(meta["camera_state"], np.float64),
        np.asarray(camera_state, np.float64),
    )
    return same_cam and str(meta["config_key"]) == config_key
