"""--arch internvl2_26b (see configs/archs.py for the full definition)."""
from repro_torch.configs.archs import INTERNVL2_26B as CONFIG  # noqa: F401
