"""ResNet family — port of ``apex_tpu/models/resnet.py`` (the model of
apex's flagship example, ``examples/imagenet/main_amp.py``: bottleneck
ResNet-50, trained under amp with FusedSGD).

The layout is the reference's: images come in **NHWC** (``(N, H, W, 3)``,
as the JAX ``apply`` takes them); inside, the activations are NCHW tensors
in ``torch.channels_last`` memory, which is NHWC in memory (the reference's
layout choice, and cuDNN's fast case).  The names are the reference's:
``_ConvBN`` (conv, then batch norm, then ReLU) with parameters ``weight``
(OIHW), ``bn_weight`` and ``bn_bias`` (so amp O2's ``keep_batchnorm_fp32``
name rule keeps the BN parameters f32, as in JAX), ``_BottleneckBlock``
(``conv1``, ``conv2``, ``conv3``, ``downsample``), and ``ResNet`` with
``stem``, ``blocks`` and ``head``.  The batch-norm running statistics are
buffers of each ``_ConvBN``: ``forward`` returns the logits and, in
training mode, updates them (the JAX ``apply`` returns ``(logits,
new_state)``), as ``nn.BatchNorm2d`` does.

Convolutions pad as JAX's ``padding="SAME"``: at stride 2 SAME pads more
at the end than at the start (7x7/2 on 224: (2, 3)), which torch's
symmetric ``padding=`` cannot express, so an uneven pad is made explicitly
with ``F.pad`` and the convolution then runs unpadded; the 3x3/2 max pool
pads with -inf the same way.  The head is ``h @ W.T + b`` with every
operand cast to ``_f32``, the reference's f32 head (``resnet.py:212-213``),
with the weight stored ``(classes, features)`` as ``nn.Linear`` keeps it.

These are plain products, normalisations and pools: the JAX package runs
them through XLA with no Pallas kernel, and the port through cuDNN / cuBLAS.
The convolutions set nothing process-wide (``GPTModel`` and ``BertModel``
turn TF32 off for the whole process): under O0 an f32 convolution on the
card follows ``torch.backends.cudnn.allow_tf32`` as the caller leaves it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.parallel.sync_batchnorm import batch_norm_
from apex_tpu_torch.utils.device import resolve_device

_f32 = torch.float32

__all__ = ["ResNetConfig", "ResNet", "resnet50", "resnet26", "resnet18"]


@dataclasses.dataclass
class ResNetConfig:
    depths: Sequence[int] = (3, 4, 6, 3)       # ResNet-50
    width: int = 64
    num_classes: int = 1000
    axis_name: Optional[str] = None            # SyncBN over this mesh axis
    bn_momentum: float = 0.1
    bn_eps: float = 1e-5
    dtype: torch.dtype = _f32                  # activation/compute dtype
    param_dtype: torch.dtype = _f32

    def __post_init__(self):
        if self.axis_name is not None:
            raise NotImplementedError(
                "ResNetConfig.axis_name (SyncBN across devices) is not "
                "ported yet: it comes with the multi-GPU slice of "
                "apex_tpu_torch")

    @property
    def stage_channels(self):
        return [self.width * (2 ** i) for i in range(len(self.depths))]


def resnet50(device=None, **kw) -> "ResNet":
    return ResNet(ResNetConfig(depths=(3, 4, 6, 3), **kw), device=device)


def resnet26(device=None, **kw) -> "ResNet":
    """Bottleneck (2, 2, 2, 2) network: every block is a bottleneck with 4x
    expansion, so this is torchvision's *resnet26*-shaped network, not the
    basic-block ResNet-18."""
    return ResNet(ResNetConfig(depths=(2, 2, 2, 2), **kw), device=device)


def resnet18(device=None, **kw) -> "ResNet":
    """Alias of :func:`resnet26`, kept for recipe-name parity with the
    reference (its shapes differ from torchvision's basic-block
    ResNet-18)."""
    return resnet26(device=device, **kw)


def _same_pads(size, k, stride):
    """(before, after) padding of JAX's "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, stride, value=0.0):
    """``x`` (NCHW) and the symmetric padding left for the op: an uneven
    SAME pad is applied here (with ``value``) and 0 is left."""
    ph = _same_pads(x.shape[2], k, stride)
    pw = _same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


class _ConvBN(nn.Module):
    """conv -> BN (-> ReLU) unit."""

    def __init__(self, cfg, kh, kw, cin, cout, stride=1, device=None):
        super().__init__()
        self.cfg, self.kh, self.kw = cfg, kh, kw
        self.cin, self.cout, self.stride = cin, cout, stride
        self.weight = nn.Parameter(torch.zeros(
            (cout, cin, kh, kw), dtype=cfg.param_dtype, device=device))
        self.bn_weight = nn.Parameter(torch.ones(cout, device=device))
        self.bn_bias = nn.Parameter(torch.zeros(cout, device=device))
        self.register_buffer("running_mean", torch.zeros(cout, device=device))
        self.register_buffer("running_var", torch.ones(cout, device=device))
        self.register_buffer("num_batches_tracked", torch.zeros(
            (), dtype=torch.int32, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1 / fan_in) weights drawn in f32 on the CPU (the JAX
        ``_conv_init``), BN weight 1, bias 0, fresh running stats."""
        fan_in = self.kh * self.kw * self.cin
        w = torch.randn(self.weight.shape,
                        generator=generator) * fan_in ** -0.5
        with torch.no_grad():
            self.weight.copy_(w)
            self.bn_weight.fill_(1.0)
            self.bn_bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x, relu=True):
        x, pad = _pad_same(x, self.kh, self.stride)
        h = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                     padding=pad)
        h = batch_norm_(h, self.bn_weight, self.bn_bias, self.running_mean,
                        self.running_var, self.num_batches_tracked,
                        training=self.training, momentum=self.cfg.bn_momentum,
                        eps=self.cfg.bn_eps)
        return F.relu(h) if relu else h


class _BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) + residual, trainable BN
    (torchvision's Bottleneck)."""

    def __init__(self, cfg, cin, cmid, stride, device=None):
        super().__init__()
        cout = 4 * cmid
        self.conv1 = _ConvBN(cfg, 1, 1, cin, cmid, device=device)
        self.conv2 = _ConvBN(cfg, 3, 3, cmid, cmid, stride, device=device)
        self.conv3 = _ConvBN(cfg, 1, 1, cmid, cout, device=device)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = _ConvBN(cfg, 1, 1, cin, cout, stride,
                                      device=device)
        self.cout = cout

    def units(self):
        return [u for u in (self.conv1, self.conv2, self.conv3,
                            self.downsample) if u is not None]

    def forward(self, x):
        h = self.conv1(x)
        h = self.conv2(h)
        h = self.conv3(h, relu=False)
        r = x if self.downsample is None else self.downsample(x, relu=False)
        return F.relu(h + r)


class _Head(nn.Module):
    def __init__(self, feat, classes, dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((classes, feat), dtype=dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(classes, dtype=dtype,
                                             device=device))

    def forward(self, h):
        return (torch.matmul(h.to(_f32), self.weight.to(_f32).t())
                + self.bias.to(_f32))


class ResNet(nn.Module):
    """``forward(images_nhwc) -> logits`` (f32), updating the BN running
    stats in training mode; ``loss`` adds the mean softmax cross entropy
    over the classes."""

    def __init__(self, cfg: ResNetConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.stem = _ConvBN(cfg, 7, 7, 3, cfg.width, stride=2, device=dev)
        blocks = []
        cin = cfg.width
        for stage, (depth, cmid) in enumerate(zip(cfg.depths,
                                                  cfg.stage_channels)):
            for i in range(depth):
                stride = 2 if (i == 0 and stage > 0) else 1
                blk = _BottleneckBlock(cfg, cin, cmid, stride, device=dev)
                blocks.append(blk)
                cin = blk.cout
        self.blocks = nn.ModuleList(blocks)
        self.feat_dim = cin
        self.head = _Head(cin, cfg.num_classes, cfg.param_dtype, device=dev)

    def conv_units(self):
        """Every ``_ConvBN`` in the reference's tree order (stem, then each
        block's conv1, conv2, conv3, downsample)."""
        return [self.stem] + [u for b in self.blocks for u in b.units()]

    def init_params(self, generator: torch.Generator) -> "ResNet":
        """Random weights as the JAX ``init_params`` draws them (its shapes
        and scales; torch cannot replay ``jax.random``): conv weights
        N(0, 1/fan_in), head weight N(0, 1/feat), biases 0; the running
        statistics reset.  Returns ``self``."""
        for unit in self.conv_units():
            unit.reset_parameters(generator)
        w = torch.randn(self.head.weight.shape, generator=generator) \
            * self.feat_dim ** -0.5
        with torch.no_grad():
            self.head.weight.copy_(w)
            self.head.bias.zero_()
        return self

    def forward(self, x):
        x = x.permute(0, 3, 1, 2).to(self.cfg.dtype)   # channels_last NCHW
        x = x.contiguous(memory_format=torch.channels_last)
        h = self.stem(x)
        h, pad = _pad_same(h, 3, 2, value=float("-inf"))
        h = F.max_pool2d(h, 3, 2, padding=pad)
        for blk in self.blocks:
            h = blk(h)
        h = h.mean(dim=(2, 3))                           # global avg pool
        return self.head(h)

    def loss(self, x, labels):
        """Mean softmax cross entropy of ``forward(x)`` against integer
        ``labels`` (``(N,)``)."""
        logits = self(x)
        logp = F.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels[:, None].long())[:, 0].mean()
