"""Model configs: the token-LM architectures (``base.py``, ``archs.py`` and
one alias module an arch) and the paper's RSNN (``rsnn_timit.py``)."""

from repro_torch.configs.base import (  # noqa: F401
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
)
from repro_torch.configs.archs import ALL_ARCHS  # noqa: F401
