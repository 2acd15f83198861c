"""--arch zamba2_7b (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import ZAMBA2_7B as CONFIG  # noqa: F401
