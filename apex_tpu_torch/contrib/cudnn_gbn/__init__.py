"""Group batch norm, cudnn-frontend flavour — port of
``apex_tpu/contrib/cudnn_gbn/__init__.py``: apex's ``GroupBatchNorm2d``
surface over :mod:`apex_tpu_torch.contrib.groupbn` (the same feature: NHWC
batch norm whose statistics are shared across a group of ranks)."""

from __future__ import annotations

from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

__all__ = ["GroupBatchNorm2d"]


class GroupBatchNorm2d(BatchNorm2d_NHWC):
    """Reference ctor ``GroupBatchNorm2d(num_features, group_size=1,
    group_rank=..., fuse_relu=False)``; the group is ``process_group``
    (its size and this rank's place come from it)."""

    def __init__(self, num_features, group_size=1, group_rank=None,
                 bn_group=None, fuse_relu=False, process_group=None, **kw):
        del group_rank
        group = bn_group if bn_group is not None else group_size
        super().__init__(num_features, fuse_relu=fuse_relu, bn_group=group,
                         process_group=process_group, **kw)
