"""The port's model classes (``vlsat_tpu/models/__init__.py``'s names)."""

from vlsat_tpu_torch.models.layers import (  # noqa: F401
    AdapterModel,
    DenseStack,
    HeadMLP,
    MaskedBatchNorm,
    PointNetEncoder,
)
from vlsat_tpu_torch.models.transformer import DistanceBiasMLP, MultiHeadAttention  # noqa: F401
from vlsat_tpu_torch.models.gnn import FatEdgeAttention, GraphEdgeAttenNetwork  # noqa: F401
from vlsat_tpu_torch.models.mmg import MMG, MMGSingle  # noqa: F401
from vlsat_tpu_torch.models.mmgnet import MMGNet, MMGNetConfig, RelPredictor  # noqa: F401
