"""--arch stablelm_3b (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import STABLELM_3B as CONFIG  # noqa: F401
