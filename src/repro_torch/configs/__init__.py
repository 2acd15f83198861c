"""Model configs: the token-LM architectures (``base.py``, ``archs.py`` and
one alias module an arch) and the paper's RSNN (``rsnn_timit.py``)."""

from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    ShapeConfig,
    shape_by_name,
)
from repro_torch.configs.archs import ALL_ARCHS  # noqa: F401
