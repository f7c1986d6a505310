"""pygpa_tpu — a JAX framework for Geometric Phase Analysis.

A from-scratch JAX/XLA rebuild of the capability set of
TAdeJong/pyGPA (reference mounted at /root/reference): spatial lock-in
GPA, windowed-Fourier-ridge adaptive GPA, weighted phase unwrapping,
displacement-field reconstruction, Lawler-Fujita undistortion, local
lattice property extraction (twist / heterostrain / anisotropy),
Kerelsky-style moire parameter fits, and drizzle unit-cell averaging.

Everything on the compute path is jit-compiled XLA (complex FFT lock-in,
lax.scan WFR sweeps, lax.while_loop CG unwrapping, closed-form batched
2x2 linear algebra) and vmappable over image stacks; multi-device scaling
goes through jax.sharding meshes (see pygpa_tpu.parallel).

Quick start (mirrors pyGPA's main entry points)::

    import pygpa_tpu as gt
    ks, _ = gt.gpa.extract_primary_ks(image)
    u = gt.gpa.extract_displacement_field(image, ks)
    undistorted = gt.gpa.undistort_image(image, u)
    props = gt.props.calc_props_from_kvecs4(ks)
"""

__version__ = "0.1.0"

# NOTE on matmul precision: on a GPU an unannotated float32 matmul may
# run in TF32 (~5e-4 relative error) — enough to corrupt k-vector
# geometry and coordinate transforms by whole pixels at image scale.
# EVERY contraction in this package therefore passes its precision
# explicitly (geometry, resampling and the zoom sweep's DFT dots at
# HIGHEST; see ops/wfr.py and solvers/unwrap.py); the global
# jax_default_matmul_precision is intentionally left untouched so
# importing this library never changes the numerics of the embedding
# application. chip_smoke.py checks the accuracy gates on the card.

from . import core  # noqa: F401
from . import lattices  # noqa: F401
from . import solvers  # noqa: F401
from . import ops  # noqa: F401
from . import gpa  # noqa: F401
from . import props  # noqa: F401
from . import ucell  # noqa: F401
from . import parallel  # noqa: F401
from . import imagetools  # noqa: F401
# pyGPA module-path compatibility surface
from . import mathtools  # noqa: F401
from . import geometric_phase_analysis  # noqa: F401
from . import phase_unwrap  # noqa: F401
from . import property_extract  # noqa: F401
from . import unit_cell_averaging  # noqa: F401
from . import tpugpa  # noqa: F401
