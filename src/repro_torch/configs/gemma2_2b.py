"""--arch gemma2_2b (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import GEMMA2_2B as CONFIG  # noqa: F401
