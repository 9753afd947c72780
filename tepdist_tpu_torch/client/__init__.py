"""The client frontend over the RPC service (the port of
``tepdist_tpu/client/``)."""

from tepdist_tpu_torch.client.annotations import AnnotationBuilder, split
from tepdist_tpu_torch.client.session import TepdistSession

__all__ = ["AnnotationBuilder", "split", "TepdistSession"]
