"""Device-mesh construction utilities.

The reference is strictly single-process / single-GPU (``devices[0]``,
``MyLdpc.cpp:235``); its only scaling axis is the in-batch codeword dimension.
Here the same batch axis (plus the SNR-sweep axis of BER campaigns) is laid
out over a ``jax.sharding.Mesh``; the only collective is a psum of the
per-SNR statistics (SURVEY.md §2.3).

Axis conventions used throughout the framework:

* ``"data"`` — codeword-batch sharding (the reference's NDRange dim 0).
* ``"snr"``  — SNR-sweep points of a waterfall campaign (optional axis).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = [
    "DATA_AXIS",
    "SNR_AXIS",
    "make_mesh",
    "data_sharding",
    "replicated",
]

DATA_AXIS = "data"
SNR_AXIS = "snr"


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    ``shape=None`` uses all devices on a single ``"data"`` axis.  A 2-D
    campaign mesh is e.g. ``make_mesh((n_snr, n_data), ("snr", "data"))``.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev, tuple(axis_names))


def data_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Sharding that splits the leading (batch) dimension over ``axis``."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
