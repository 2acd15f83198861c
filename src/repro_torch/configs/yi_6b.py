"""--arch yi_6b (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import YI_6B as CONFIG  # noqa: F401
