"""--arch kimi_k2_1t_a32b (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import KIMI_K2_1T as CONFIG  # noqa: F401
