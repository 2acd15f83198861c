"""Data sources for the port: the synthetic TIMIT-shaped speech stream
(``synthetic.py``) and the async featurization front end of the serving
loops (``featurize.py``)."""

from repro_torch.data.featurize import (AsyncFeaturizer, cpu_quantizer,
                                        prefetch_depth)

__all__ = ["AsyncFeaturizer", "cpu_quantizer", "prefetch_depth"]
