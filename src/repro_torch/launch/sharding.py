"""GSPMD sharding rules for every parameter / batch / cache leaf, as specs.

The port's counterpart of the JAX package's ``launch/sharding.py``.  The
rules and their order are JAX's, branch for branch; a spec is a tuple with
one entry per dimension (what ``tuple(PartitionSpec)`` is in JAX): ``None``
(replicated), an axis name, or a tuple of axis names.  Nothing here builds
a sharding: the port runs on one card, and the specs serve the dry run's
per-device bytes (``per_device_bytes``).

Policy (DESIGN.md §4):
  * tensor parallelism on the ``model`` axis: attention heads, FFN hidden,
    experts, vocab;
  * data parallelism on ``('pod', 'data')``: batch dims;
  * FSDP (ZeRO-3 style) on ``data`` for training and for the very large
    serving configs (``cfg.fsdp_serving``): weight d_model rows sharded on
    ``data``;
  * GQA KV with few heads: shard Hkv on ``model`` when divisible, else
    replicate.

Every rule degrades to replication when a dim is not divisible by the mesh
axis, so every division in ``per_device_bytes`` is exact.

The port's trees differ from JAX's in one way: JAX stacks the layers of a
homogeneous stack (dense, MoE, SSM) along a leading axis, the port keeps a
parameter and a cache per layer.  ``param_specs`` names each parameter by
its JAX leaf (``checkpoint/bridge.py::_jax_path``) and gives it JAX's spec
without the leading layer entry; the port's per-layer cache is named as
JAX names the hybrid's per-layer list (``layers``, ``[i]``, leaf), which
the cache rules already take.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.bridge import _jax_path
from repro_torch.models.config import ModelConfig


def _axis_size(mesh, name) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _fits(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    if isinstance(axis, tuple):
        size = 1
        for a in axis:
            size *= _axis_size(mesh, a)
    else:
        size = _axis_size(mesh, axis)
    return size > 1 and dim % size == 0


def dp_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def P(*entries) -> tuple:
    """A spec as ``tuple(PartitionSpec(*entries))`` gives it: a tuple of one
    axis becomes that axis, an empty one ``None``."""
    return tuple((e[0] if len(e) == 1 else e or None)
                 if isinstance(e, tuple) else e for e in entries)


def param_spec_for(names: list[str], shape: tuple[int, ...], mesh,
                   cfg: ModelConfig, fsdp: bool) -> tuple:
    """Spec for one parameter leaf, identified by its JAX tree path."""
    name = names[-1]
    stacked = names[0] == "layers" and not names[1].startswith("[")
    off = 1 if stacked else 0          # leading layer-stack dim
    d = [None] * len(shape)

    def set_dim(i, axis):
        if axis is not None and _fits(shape[i], mesh, axis):
            d[i] = axis

    fs = "data" if fsdp else None
    in_moe = "moe" in names

    if name == "tok":                         # (V, D)
        set_dim(0, "model")
        set_dim(1, fs)
    elif name == "head" and len(shape) == 2:  # (D, V)
        set_dim(0, fs)
        set_dim(1, "model")
    elif name == "wq":                        # (D, H, Dh)
        set_dim(off + 0, fs)
        set_dim(off + 1, "model")
    elif name in ("wk", "wv"):                # (D, Hkv, Dh)
        set_dim(off + 0, fs)
        if _fits(shape[off + 1], mesh, "model"):
            set_dim(off + 1, "model")
        # else: replicate heads over 'model' — the projection is tiny and a
        # head_dim (contracting) shard makes GSPMD replicate the k/v
        # activations per layer ("involuntary full rematerialization"),
        # blowing up train memory (§Perf pair A).
    elif name == "wo":                        # (H, Dh, D)
        set_dim(off + 0, "model")
        set_dim(off + 2, fs)
    elif name in ("w_gate", "w_up") and in_moe and len(shape) - off == 3:
        # expert weights (E, D, F): expert parallel
        set_dim(off + 0, "model")
        set_dim(off + 1, fs)
    elif name == "w_down" and in_moe and len(shape) - off == 3:
        set_dim(off + 0, "model")
        set_dim(off + 2, fs)
    elif name in ("w_gate", "w_up"):          # (D, F) mlp / rglru gate
        set_dim(off + 0, fs)
        set_dim(off + 1, "model")
    elif name == "w_down":                    # (F, D)
        set_dim(off + 0, "model")
        set_dim(off + 1, fs)
    elif name == "router":                    # (D, E) — replicated (small)
        pass
    elif name in ("w_z", "w_x"):              # ssm/rglru (D, Di|W)
        set_dim(off + 0, fs)
        set_dim(off + 1, "model")
    elif name == "w_dt":                      # (D, H)
        set_dim(off + 1, "model")
    elif name == "w_bc":                      # (D, 2N) — replicated
        pass
    elif name == "conv":                      # (K, Di|W)
        set_dim(off + 1, "model")
    elif name in ("a_log", "dt_bias", "d_skip", "lam"):  # (H,) / (W,)
        set_dim(off + 0, "model")
    elif name in ("w_r", "w_i"):              # (W, W) rglru gates
        set_dim(off + 0, "model")             # contracting dim
    elif name == "w_out":                     # (Di|W, D)
        set_dim(off + 0, "model")
        set_dim(off + 1, fs)
    elif name in ("scale", "bias"):           # norms — replicated
        pass
    return P(*d)


def is_stacked(cfg: ModelConfig) -> bool:
    """Whether JAX stacks this config's layers (its ``is_homogeneous``)."""
    kinds = cfg.layer_types()
    return all(k == kinds[0] for k in kinds)


def param_specs(model, mesh, *, fsdp: bool) -> dict:
    """Port parameter name -> its spec: JAX's spec of the leaf it is, or,
    for a row of a stacked JAX leaf, that spec without the layer entry."""
    cfg = model.cfg
    stacked = is_stacked(cfg)
    out = {}
    for name, p in model.named_parameters():
        path, layer = _jax_path(name, stacked)
        names = path.split("/")
        shape = tuple(p.shape)
        if layer is not None:                 # a row of (n_layers, ...)
            out[name] = param_spec_for(names, (cfg.n_layers, *shape), mesh,
                                       cfg, fsdp)[1:]
        else:
            if names[0] == "layers":          # the hybrid's list: [i]
                names[1] = f"[{names[1]}]"
            out[name] = param_spec_for(names, shape, mesh, cfg, fsdp)
    return out


def _leaves(tree, names=()):
    """(path names, leaf) of a tree of dicts and lists, JAX's naming: a
    dict key as itself, a list index as ``[i]``."""
    items = (((f"[{i}]", v) for i, v in enumerate(tree))
             if isinstance(tree, (list, tuple)) else tree.items())
    for key, node in items:
        if isinstance(node, (dict, list, tuple)):
            yield from _leaves(node, (*names, key))
        else:
            yield [*names, key], node


def _path(names) -> str:
    return "/".join(names)


def batch_shardings(cfg: ModelConfig, batch_tree, mesh) -> dict:
    """Shard every batch leaf's leading (batch) dim over the dp axes.
    Returns path -> spec."""
    dp = dp_axes(mesh)
    out = {}
    for names, leaf in _leaves(batch_tree):
        if leaf.ndim:
            b = leaf.shape[0]
            axis = dp if _fits(b, mesh, dp) else None
            out[_path(names)] = P(axis, *([None] * (leaf.ndim - 1)))
        else:
            out[_path(names)] = P()
    return out


def cache_shardings(cfg: ModelConfig, cache_tree, mesh) -> dict:
    """Decode-cache specs, path -> spec.

    The port's caches are per layer: attention (B, S, Hkv, Dh), SSM states
    (B, H, N, P) with heads on model, the convs' (B, K-1, Di|W), RG-LRU h
    (B, W) with W on model.  ``len`` is a Python int: replicated.
    """
    dp = dp_axes(mesh)
    out = {}
    for names, leaf in _leaves(cache_tree):
        name = names[-1]
        if name == "len" or not isinstance(leaf, torch.Tensor):
            out[_path(names)] = P()
            continue
        stacked = "[" not in "".join(names[:2])  # stacked pytree (scan archs)
        off = 1 if stacked else 0
        shape = leaf.shape
        d = [None] * leaf.ndim

        def set_dim(i, axis):
            if i < leaf.ndim and axis is not None and _fits(shape[i], mesh, axis):
                d[i] = axis

        if name in ("k", "v"):
            set_dim(off + 0, dp)            # batch
            if _fits(shape[off + 2], mesh, "model"):
                set_dim(off + 2, "model")   # kv heads
            else:
                set_dim(off + 3, "model")   # head_dim fallback
        elif name == "ssm":                 # (B, H, N, P)
            set_dim(off + 0, dp)
            set_dim(off + 1, "model")
        elif name == "conv":                # (B, K-1, Di|W)
            set_dim(off + 0, dp)
            set_dim(off + 2, "model")
        elif name == "h":                   # (B, W)
            set_dim(off + 0, dp)
            set_dim(off + 1, "model")
        out[_path(names)] = P(*d)
    return out


def opt_shardings(param_sh: dict, mesh) -> dict:
    """Optimizer-state specs, path -> spec (``training/optim.py``'s state:
    ``m/<name>``, ``v/<name>``, ``step``): moments follow params, step
    replicated."""
    return {**{f"{k}/{n}": s for k in ("m", "v") for n, s in param_sh.items()},
            "step": P()}


def replicated(mesh) -> tuple:
    return P()


def shards(spec, mesh) -> int:
    """How many pieces a spec cuts a leaf into: the product of the sizes of
    the axes that shard it."""
    n = 1
    for entry in spec:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                n *= _axis_size(mesh, axis)
    return n


def per_device_bytes(tree, specs: dict, mesh) -> int:
    """Bytes of ``tree`` on one device of ``mesh``: each tensor leaf's bytes
    divided by ``shards`` of its spec (``specs``: path -> spec, paths as
    ``_leaves`` names them, or a parameter name -> spec for a model's
    ``named_parameters``).  Exact: the rules shard only what divides."""
    if isinstance(tree, torch.nn.Module):
        leaves = tree.named_parameters()
    else:
        leaves = ((_path(n), leaf) for n, leaf in _leaves(tree))
    total = 0
    for path, leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            continue
        n = shards(specs[path], mesh)
        nbytes = leaf.numel() * leaf.element_size()
        if nbytes % n:
            raise ValueError(f"{path}: {nbytes} bytes do not split in {n}")
        total += nbytes // n
    return total

