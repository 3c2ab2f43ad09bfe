"""PyTorch/CUDA port of vlsat_tpu (3D-only MMGNet serving, dual-branch evaluation,
training, the data feed, the runner and its CLI: ``python -m vlsat_tpu_torch.main``).

Imports torch, numpy and the standard library only; nothing of JAX or of
the ``vlsat_tpu`` package.
"""

from vlsat_tpu_torch.scene import SceneBatch  # noqa: F401
