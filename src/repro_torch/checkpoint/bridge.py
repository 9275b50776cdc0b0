"""Weights carried across from the JAX package into the port's ``Model``.

Two sources, both read without JAX (the machine with the card has none):

  * ``params_from_jax(tree, cfg)``: the JAX ``Model.init`` pytree as nested
    dicts of numpy arrays (``jax.tree.map(np.asarray, params)``);
  * ``load_jax_checkpoint(directory, step)``: the npz + JSON manifest that
    the JAX package's ``checkpoint/store.py`` writes, where bf16 leaves are
    stored as uint16 views.

JAX stacks the dense layers along a leading ``n_layers`` axis (its init is
``vmap``-ed); the bridge slices that axis per layer.  Every other layout
is the same in both packages, so leaves copy without transposes, and bf16
bits arrive unchanged (through an int16 view; no ``ml_dtypes`` needed).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model


def _to_torch(leaf) -> torch.Tensor:
    """numpy (bf16 included) or torch leaf -> CPU torch tensor, same bits."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.array(leaf)  # a writable copy: JAX hands out read-only arrays
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf(tree: dict, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _paths(tree: dict, prefix: str = ""):
    for key, node in tree.items():
        if isinstance(node, dict):
            yield from _paths(node, prefix + key + "/")
        else:
            yield prefix + key


def _jax_path(name: str) -> tuple[str, int | None]:
    """Port parameter name -> (JAX tree path, layer index or None).

    ``layers.<i>.<rest>`` is row i of the stacked ``layers/<rest>``.
    """
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["layers", *parts[2:]]), int(parts[1])
    return "/".join(parts), None


def params_from_jax(tree: dict, cfg: ModelConfig, *,
                    device="cuda") -> Model:
    """A port ``Model`` holding the JAX parameters ``tree``.

    The model dtype is that of the token embedding, as JAX's ``Model``
    keeps norms in fp32 and everything else in its dtype.
    """
    dtype = _to_torch(_leaf(tree, "embed/tok")).dtype
    model = Model(cfg, dtype=dtype, device=device)
    wanted = {_jax_path(n)[0] for n, _ in model.named_parameters()}
    given = set(_paths(tree))
    if wanted != given:
        raise ValueError(f"JAX tree does not match {cfg.name}: missing "
                         f"{sorted(wanted - given)}, extra "
                         f"{sorted(given - wanted)}")
    with torch.no_grad():
        for name, param in model.named_parameters():
            path, layer = _jax_path(name)
            src = _leaf(tree, path)
            src = _to_torch(src if layer is None else src[layer])
            if src.shape != param.shape or src.dtype != param.dtype:
                raise ValueError(
                    f"{name}: JAX leaf {tuple(src.shape)} {src.dtype} does "
                    f"not fit {tuple(param.shape)} {param.dtype}")
            param.copy_(src)
    return model


def load_jax_checkpoint(directory: str, step: int | None = None) -> dict:
    """Read a JAX-package checkpoint into nested dicts of CPU tensors.

    Keys are the manifest's ``/``-joined tree paths; bf16 leaves come back
    as ``torch.bfloat16`` with their stored bits.
    """
    tag = f"ckpt_{step}" if step is not None else "ckpt"
    with open(os.path.join(directory, tag + ".json")) as f:
        manifest = json.load(f)
    tree: dict = {}
    with np.load(os.path.join(directory, tag + ".npz")) as data:
        for entry in manifest["entries"]:
            arr = data[entry["key"]]
            if entry["dtype"] == "bfloat16":
                leaf = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            else:
                leaf = torch.from_numpy(arr)
            if list(leaf.shape) != entry["shape"]:
                raise ValueError(f"{entry['key']}: stored shape "
                                 f"{list(leaf.shape)} != {entry['shape']}")
            node = tree
            *parents, last = entry["key"].split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[last] = leaf
    return tree
