from vlsat_tpu_torch.config.config import Config, load_config  # noqa: F401
from vlsat_tpu_torch.config.defaults import DEFAULT_CONFIG  # noqa: F401
