"""--arch xlstm_350m (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import XLSTM_350M as CONFIG  # noqa: F401
