"""Device ops: the hand-written attention kernels (K1-K3, ``attention.py``),
the PHOC encoder as tensor ops (``phoc.py``) and weight-only int8 linears
(``quant.py``)."""

from ruart_tpu_torch.ops.attention import flash_attention
from ruart_tpu_torch.ops.phoc import encode_char_ids, phoc_from_char_ids
