from tepdist_tpu_torch.ops.ring_attention import (reference_attention,
                                                  ring_attention)
from tepdist_tpu_torch.ops.ulysses import ulysses_attention

__all__ = [
    "ring_attention",
    "ulysses_attention",
    "reference_attention",
]
