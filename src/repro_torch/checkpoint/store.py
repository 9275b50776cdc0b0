"""Checkpoints of a port ``Model`` in the JAX package's format.

The write side of the JAX package's ``checkpoint/store.py``, without JAX:
``save_checkpoint(directory, model, step)`` writes ``ckpt_<step>.npz``
keyed by the JAX tree paths joined with ``/`` and a JSON manifest of each
entry's ``dtype`` and ``shape`` and the ``step``, so the JAX
``load_checkpoint`` reads it into the JAX ``Model``'s parameter tree (it
takes the structure from its ``like`` argument; ``treedef`` here is a
description).  The mapping is the inverse of ``bridge.params_from_jax``:
the layers of a homogeneous stack become one ``(L, ...)`` leaf per
parameter, the hybrid's per-layer list ``layers/<i>/...``; bf16 leaves are
stored as uint16 views.  Entries come in the JAX tree's flattening order
(dict keys sorted, list items by index).  ``entry_nbytes`` and
``manifest_nbytes`` are the JAX package's, copied.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.checkpoint.bridge import _jax_path
from repro_torch.models.model import Model


def _numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the stored array, the JAX dtype name); bf16 as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _order(path: str):
    """The JAX flattening order of a ``/``-joined path."""
    return [(0, int(p), "") if p.isdigit() else (1, 0, p)
            for p in path.split("/")]


def _jax_leaves(model: Model) -> dict[str, torch.Tensor]:
    """The model's parameters as the JAX tree's leaves, path -> tensor, in
    the JAX flattening order."""
    kinds = model.cfg.layer_types()
    stacked = all(k == kinds[0] for k in kinds)  # JAX's is_homogeneous
    leaves: dict[str, torch.Tensor] = {}
    rows: dict[str, list] = {}
    for name, param in model.named_parameters():
        path, layer = _jax_path(name, stacked)
        if layer is None:
            leaves[path] = param.detach()
        else:
            rows.setdefault(path, []).append((layer, param.detach()))
    for path, parts in rows.items():
        leaves[path] = torch.stack([t for _, t in sorted(
            parts, key=lambda lt: lt[0])])
    return {p: leaves[p] for p in sorted(leaves, key=_order)}


def save_checkpoint(directory: str, model: Model,
                    step: int | None = None) -> str:
    """Write the model's parameters as the JAX package would write its
    parameter tree; returns the npz path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}
    manifest = {"treedef": f"the JAX Model parameter tree of "
                           f"{model.cfg.name} (written by repro_torch)",
                "entries": [], "step": step}
    for key, leaf in _jax_leaves(model).items():
        arr, stored_dtype = _numpy(leaf)
        arrays[key] = arr
        manifest["entries"].append(
            {"key": key, "dtype": stored_dtype, "shape": list(arr.shape)})
    tag = f"ckpt_{step}" if step is not None else "ckpt"
    npz_path = os.path.join(directory, tag + ".npz")
    np.savez(npz_path, **arrays)
    with open(os.path.join(directory, tag + ".json"), "w") as f:
        json.dump(manifest, f)
    return npz_path


def entry_nbytes(entry: dict) -> int:
    """Stored bytes for one manifest entry.

    bf16 leaves are stored as uint16 views (2 bytes/elem); numpy has no
    ``bfloat16`` dtype, so map it explicitly instead of via ``np.dtype``.
    """
    n = 1
    for d in entry["shape"]:
        n *= int(d)
    dtype = entry["dtype"]
    itemsize = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
    return n * itemsize


def manifest_nbytes(directory: str, step: int | None = None) -> int:
    """Total checkpoint bytes recorded by a saved manifest.

    This is the restore payload the fabric's ``RestoreCostModel`` prices:
    bringing a model up on a fresh node means streaming these bytes from
    checkpoint storage before the node can serve.
    """
    tag = f"ckpt_{step}" if step is not None else "ckpt"
    with open(os.path.join(directory, tag + ".json")) as f:
        manifest = json.load(f)
    return sum(entry_nbytes(e) for e in manifest["entries"])
