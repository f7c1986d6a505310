"""Multi-device scaling: device meshes, sharded batch pipelines, and the
distributed WFR k-sweep.

The reference's scaling story is dask chunking on one node
(/root/reference/pyGPA/geometric_phase_analysis.py:705-719,816-836;
property_extract.py:863-883). The device-mesh equivalents:

 - image stacks / mosaic tiles: data-parallel sharding of the batch
   axis over a jax.sharding.Mesh, one jit'd program;
 - the WFR candidate sweep: shard the k-candidate grid over devices,
   combine with an argmax tree of psum/pmax collectives (O(1) memory);
 - 8k^2+ single images: row-sharded end to end — pencil-decomposed
   distributed FFT (all_to_all) and a spatially-sharded WFR
   sweep where each device computes only its own row block
   (parallel/fft.py).
"""
from .mesh import make_mesh, batch_sharding  # noqa: F401
from .sharded import (  # noqa: F401
    extract_displacement_field_batch, wfr_sweep_sharded,
)
from .fft import (  # noqa: F401
    fft2_sharded, ifft2_sharded, wfr_sweep_spatial,
)
from .unwrap import (  # noqa: F401
    dct2n_sharded, idct2n_sharded, phase_unwrap_prediff_sharded,
    reconstruct_u_inv_from_demod_sharded,
    extract_displacement_field_sharded,
)
