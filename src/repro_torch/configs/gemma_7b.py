"""--arch gemma_7b (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import GEMMA_7B as CONFIG  # noqa: F401
