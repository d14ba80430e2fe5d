"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu for an NVIDIA H100.

The package mirrors ``apex_tpu/`` file for file (``apex_tpu_torch/ops/
flash_attention.py`` is the counterpart of ``apex_tpu/ops/
flash_attention.py``) and keeps the JAX package's public layouts, so the
two can be compared on the same inputs.  It imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``apex_tpu``.

Every Pallas kernel the JAX package runs on a slice's path becomes a CUDA
C++ kernel for ``sm_90a`` under ``csrc/``, built at first use by
:mod:`apex_tpu_torch._kernels`.  Each kernel wrapper dispatches on its
tensor's device: the plain PyTorch version for a CPU tensor, the kernel
for a CUDA tensor.

Slice 1 is GPT serving: ``GPTModel.prefill`` / ``decode_step`` driven by
the continuous-batching ``InferenceEngine`` over a ``KVCache`` slot ring, on
three kernels (LayerNorm forward, causal flash-attention forward,
single-query decode attention).  Slice 2 is GPT training:
``GPTModel.loss`` and its backward, accumulated over micro-batches by
``transformer.pipeline_parallel.forward_backward_no_pipelining``, then
``optimizers.FusedAdam.step``, on four more kernels (LayerNorm backward,
flash-attention dq and dk/dv, multi-tensor Adam) and the flash forward with
attention dropout.  Slice 3 is BERT training under amp O2:
``amp.initialize``, ``models.bert.BertModel.loss`` and its backward through
the non-causal flash kernels, then ``optimizers.FusedLAMB.step`` with f32
master weights, on four more kernels (multi-tensor L2 norm, LAMB stages 1
and 2, and the multi-tensor scale of ``amp.LossScaler.unscale`` and
``contrib.clip_grad.clip_grad_norm_``).  Slice 4 is the fused LM head
(``ops.lm_head.fused_linear_cross_entropy``, on by default in both models'
losses as in JAX) on three more kernels: the logit-free forward and its
dX and dW backward.  Slice 5 is the fused bias-GELU FFN
(``ops.fused_ffn.fused_ffn``, with ``fused_ffn=True`` in both models and in
``mlp`` / ``fused_dense``) on three more kernels: its forward, dX and dW.
Slice 6 is ResNet-50 ImageNet training (``models.resnet``, batch norm from
``parallel.sync_batchnorm``, the example ``examples.imagenet.main_amp``)
under amp O1 (``amp.autocast`` over the cast lists of ``amp.lists``) and
O2 with ``optimizers.FusedSGD``, on the multi-tensor SGD kernel, with
``FusedAdagrad``, ``FusedNovoGrad`` and ``multi_tensor_axpby`` on three
more (Adagrad, NovoGrad, axpby).
"""

__version__ = "0.1.0"
