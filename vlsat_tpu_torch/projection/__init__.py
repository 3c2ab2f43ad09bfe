from vlsat_tpu_torch.projection.multiview import (  # noqa: F401
    MultiViewFeatureExtractor,
    ViewCrop,
    crop_box,
    project_points,
    select_view_crops,
)
