"""The compression stack: pruning masks, int4 quantization and the
orchestration that hands a model to the packer (``core/sparse.py``)."""

from repro_torch.core.compression.pruning import (  # noqa: F401
    build_mask,
    channel_prune_mask,
    magnitude_prune_mask,
    nm_prune_mask,
    row_prune_mask,
    structured_prune_config,
    apply_masks,
    sparsity_of,
)
from repro_torch.core.compression.quantization import (  # noqa: F401
    fake_quant,
    quantize_tree,
    pack_int4,
    unpack_int4,
    QuantSpec,
)
from repro_torch.core.compression.compress import (  # noqa: F401
    CompressionConfig,
    CompressionState,
    PruneSpec,
    init_compression,
    materializer,
    compressed_size_bytes,
    pack_for_inference,
)
