"""apex_tpu_torch.mpmd — port of ``apex_tpu.mpmd``: so far only the
slow-link channel (:class:`LocalDcnChannel`) that the disaggregated
serving fleet ships KV blocks over.  The MPMD stage engine is not ported
yet."""

from apex_tpu_torch.mpmd.channel import DcnTimeout, Edge, LocalDcnChannel

__all__ = ["DcnTimeout", "Edge", "LocalDcnChannel"]
