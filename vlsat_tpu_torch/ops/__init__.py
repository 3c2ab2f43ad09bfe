"""The port's array operations (``vlsat_tpu/ops/__init__.py``'s names)."""

from vlsat_tpu_torch.ops.descriptor import edge_descriptor, gen_descriptor  # noqa: F401
from vlsat_tpu_torch.ops.graph import (  # noqa: F401
    gather_edge_endpoints,
    scatter_edges_to_nodes,
)
from vlsat_tpu_torch.ops.attention import masked_attention, pairwise_distance_bias  # noqa: F401
from vlsat_tpu_torch.ops.pointnet import pointnet_encode  # noqa: F401
