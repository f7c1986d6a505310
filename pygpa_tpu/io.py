"""Checkpointing of pipeline intermediates.

The reference keeps everything in memory (SURVEY.md §5:
checkpoint/resume "none"). For large mosaic campaigns this
framework can persist the per-image intermediates (phases, weights,
u, k-vectors) and resume property extraction without re-running the
sweeps. Plain .npz by default; orbax (if installed) for sharded
multi-host arrays.
"""
import os

import numpy as np
import jax


def save_checkpoint(path, **arrays):
    """Save named arrays (device or host) to `path` (.npz)."""
    host = {k: np.asarray(jax.device_get(v)) for k, v in arrays.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **host)


def load_checkpoint(path, device_put=False):
    """Load a checkpoint dict; optionally place arrays on device."""
    with np.load(path) as f:
        out = {k: f[k] for k in f.files}
    if device_put:
        out = {k: jax.device_put(v) for k, v in out.items()}
    return out


def save_checkpoint_orbax(path, tree):
    """Orbax-backed checkpoint (sharded arrays, async); requires
    orbax-checkpoint."""
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), tree)
    ckptr.wait_until_finished()


def restore_checkpoint_orbax(path, abstract_tree=None):
    import orbax.checkpoint as ocp
    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(path), abstract_tree)
