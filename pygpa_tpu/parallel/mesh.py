"""Device-mesh helpers."""
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, axis_names=("batch",), shape=None):
    """Build a Mesh over the first n_devices devices.

    With one axis name the mesh is 1D (data parallel); pass shape for
    multi-axis layouts, e.g. make_mesh(8, ("batch", "k"), (2, 4)) to
    split image batches over one axis and k-candidates over the other.
    The layout follows the algorithm alone: the cards of one host are
    joined all to all (NVLink), so no axis is closer than another.
    """
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if shape is None:
        shape = (n_devices,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    dev_array = np.array(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def batch_sharding(mesh, axis="batch", ndim=3):
    """NamedSharding placing the leading (batch) axis on `axis` and
    replicating the rest."""
    spec = [None] * ndim
    spec[0] = axis
    return NamedSharding(mesh, P(*spec))
