"""--arch deepseek_v3_671b (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import DEEPSEEK_V3_671B as CONFIG  # noqa: F401
