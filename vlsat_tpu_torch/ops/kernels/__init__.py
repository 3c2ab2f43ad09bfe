"""The hand-written CUDA kernels and their PyTorch operators.

Importing this package registers ``vlsat::segment_max`` and
``vlsat::pointnet_encode`` (``torch.library.custom_op``): what a
``torch.export`` program of the port (``serving_export``) needs to load.
Nothing is built here: a kernel builds at its first launch (``build``).
"""

from vlsat_tpu_torch.ops.kernels import pointnet_kernel, segment_max  # noqa: F401
