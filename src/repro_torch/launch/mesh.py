"""Production meshes and sub-mesh carving, as shapes only.

The port's counterpart of the JAX package's ``launch/mesh.py``.  A JAX
mesh holds devices; this one holds only its axis names and sizes, which is
all the sharding rules (``launch/sharding.py``) and the dry run's
per-device bytes read.  ``torch.distributed.DeviceMesh`` is not used: it
needs a process group with a rank on every device, and the port runs on
one card, so a 256-chip mesh can only be described, not built.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device-free mesh: ``axis_names`` in order and ``shape``, a mapping
    from each axis to its size (``jax.sharding.Mesh``'s two attributes)."""
    axis_names: tuple[str, ...]
    shape: dict

    @classmethod
    def of(cls, sizes: tuple[int, ...], names: tuple[str, ...]) -> "Mesh":
        if len(sizes) != len(names):
            raise ValueError(f"mesh {sizes} needs one name an axis: {names}")
        return cls(tuple(names), dict(zip(names, sizes)))

    @property
    def name(self) -> str:
        """The dry run's label: the sizes joined by ``x``, e.g. ``16x16``."""
        return "x".join(str(self.shape[a]) for a in self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 chips) or 2x16x16 two-pod (512 chips) mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.of(shape, axes)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a production mesh ('pod' included if present)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def make_submesh(n_chips: int, *, model_axis: int = 16) -> Mesh:
    """A sub-mesh of ``n_chips`` chips (data x model).  ``n_chips`` must be
    a multiple of ``model_axis`` (contiguous rectangle constraint)."""
    assert n_chips % model_axis == 0, (n_chips, model_axis)
    return Mesh.of((n_chips // model_axis, model_axis), ("data", "model"))
