"""--arch whisper_base (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import WHISPER_BASE as CONFIG  # noqa: F401
