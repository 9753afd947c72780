"""Input pipeline: host-side token datasets and device prefetch, the port
of ``tepdist_tpu/data``: a memmapped token store (``tokens``) and a
background-thread host->device prefetcher (``prefetch``), so that step
N+1's input transfer overlaps step N's compute."""

from tepdist_tpu_torch.data.prefetch import (  # noqa: F401
    DevicePrefetcher,
    fake_input_iterator,
)
from tepdist_tpu_torch.data.tokens import (  # noqa: F401
    TokenDataset,
    encode_bytes,
    pack_token_file,
)
