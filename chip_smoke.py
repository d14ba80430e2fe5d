#!/usr/bin/env python3
"""Drive apex_tpu_torch's serving and training paths (GPT serving, GPT
training, BERT training under amp O2, each also with the fused FFN and
under activation recompute, ResNet-50 ImageNet training under amp O1 and
O2, paged and int8 GPT serving, the serving fleet, data and tensor
parallelism over NCCL, Switch-GPT-350M/8 training and serving, the ring
pipeline and context parallelism, GPT-350M under the resilience layer:
checkpoints, the guarded step, elastic training, and its training telemetry,
collective accounting and cost-model autopilot, GPT-350M through the
cross-pod MPMD pipeline, and the Conformer RNN-T recipe at Conformer-M width
with the contrib ops) on one NVIDIA H100 and hold every kernel of the paths
against its plain PyTorch version.

    python3 chip_smoke.py [--out results.json] [--profile breakdown.txt]

Phases (any failure exits non-zero; nothing is caught):

1. build the CUDA kernels from ``apex_tpu_torch/csrc`` (nvcc, sm_90a) and
   log nvcc's registers and spills (by kernel name for the tensor-core dq
   and the FFN's GEMM mainloop);
2. for each kernel, at the shapes the paths give it: the kernel against its
   plain version on the same card inputs (max abs error and tolerance), the
   kernel's time, the plain version's time, one PyTorch library call
   computing the same function (a yardstick the port never calls) and the
   least time the card could take (bytes / 3.35 TB/s or operations / peak,
   whichever is larger); the LayerNorm forward (#1) also at hidden 48,
   1000, 1600, 4096 and 8192, one row, f16, f32, RMS and an x off the
   16-byte grid (each naming the body it took), and at 8192 rows with six
   inputs in turn (read from device memory, not L2); the LayerNorm
   backward (#2) likewise (both bodies, LN, RMS and from_y in bf16, f16
   and f32, dy off the 16-byte grid, each bitwise on a repeat), also with
   six input pairs in turn beside ``native_layer_norm_backward``'s; the
   flash forward, dq and dk/dv (#3-#5) at the training shape also with
   several input sets in turn (read from device memory) beside SDPA's, and
   at
   head_dim 16 and 32 on a ragged s = 200 (causal, dropout 0.1,
   kv_seqlens), in small f32 and f16 cases (the FMA instantiations), #4
   and #5 twice on the same inputs (bitwise equal) and a q one element off
   its 16-byte boundary (refused); the fused LM head (#8-#10) at GPT-350M's and
   BERT-large's head shapes in bf16 and GPT-350M's in f32, a peaked-softmax
   bf16 case off the token and vocab grids, a vocab off the 64-column grid
   over four chunks of the backward, 48 tokens, GPT-2 XL's head (H 1600),
   a hidden size off the 16-byte grid, and four small off-grid cases (f32,
   bf16, a mixed pair, an x off 16 bytes), the forward bitwise on a repeat
   with its product's route checked, the whole backward (``lm_head_bwd``)
   bitwise the dX and dW calls, its
   yardstick the two calls matmul + F.cross_entropy; the fused FFN
   (#11-#13) at GPT-350M's and BERT-large's micro-batch (bf16 x with f32
   W, bf16/bf16), the serving shapes (512 and 8 rows), GPT-2 XL's widths
   off the grids (1000 x 1600 -> 6400 -> 1600), GPT-350M's shape in f32
   and small cases, every output held entry by entry (``ffn_bounds``),
   also the whole backward's (``ffn_bwd``, dh once), every output bitwise
   equal on a repeat, each call's launches those of its path, its
   yardstick the unfused
   F.linear + gelu + F.linear chain; the multi-tensor axpby, SGD, Adagrad
   and NovoGrad (#16, #19, #22, #23) at GPT-350M's f32 list (291 tensors,
   as Adam), on a mixed list of 40 bf16 / f16 / f32 tensors with f32
   masters and model copies, and SGD at ResNet-50's O1 and O2 lists (161
   tensors; SGD also at 1, 7, 64 and 65,537 elements in five dtype
   signatures, at storage offset 1, under momentum_zero and noop, bitwise
   on a repeat, and over 2000 tensors, its launches ``sgd_launches``'s),
   LAMB stage 1 (#20) at BERT-large's O2 list (one launch) and at 1, 7,
   8, 9 and 65,537 elements in all nine (g, p) signatures, at storage
   offset 1 in every list and in each list alone, noop 1 and 0, bitwise on
   a repeat, and over GPT-350M's list (one launch) and 2000 tensors (its
   launches ``lamb_stage1_launches``'s), the multi-tensor scale (#15) at
   BERT-large's O2 list (one launch), GPT-350M's f32 masters into bf16
   copies and f16 gradients into f32 at BERT-large's sizes, and at 0, 1,
   7, 8, 9, 33 and 65,537 elements in all nine (in, out) dtype pairs, at
   storage offsets that give every scalar head 0-7 and none, in place,
   with inf / NaN in a head, a 16-byte step and a tail (the flag set), an
   f16-only overflow (no flag), bitwise on a repeat, and over 2000 tensors
   (its launches ``scale_launches``'s), their yardsticks
   ``SGD(fused=True)`` and
   ``Adagrad(foreach=True)``; the decode (#6) on a strided bf16 ring with
   ragged lengths, its yardstick SDPA + mask, and the paged decode (#7) on
   a 513-block bf16 pool through a shuffled table with shared blocks,
   ragged lengths and an inactive slot, also against #6 on the gathered
   cache (bitwise), its yardstick the table gather + SDPA, both with GB/s
   and the share of the bound, bitwise on a repeat, and in every dtype
   and head dim at the split pass's chunk edges (#7 at block sizes 8 and
   16, bitwise #6); the int8 dequant-GEMM (#14) over a
   whole GPT-350M decode step's 97 calls (8 rows, 353.6 MB of int8), the
   prefill's shapes at 512 rows (the f32 head among them), every token
   count at the TMA kernel's tile and split edges (k 1024 and 4096, n
   1030, bf16 and f32), f32 x spread over 1e-3 .. 1e3 (also against the
   f64 product) and with inf / nan entries, and off-grid cases, bitwise
   on a repeat, its yardstick ``F.linear`` on weights dequantized in
   advance;
3. GPT-350M (vocab 50304, hidden 1024, 24 layers, 16 heads, ffn 4096,
   max_seq 1024, bf16 activations, f32 params, random weights from seed 0)
   served by ``InferenceEngine`` (8 slots, bf16 cache): 10 greedy requests,
   prompts of 37..512 tokens, 32 new tokens each.  Every kernel's launch
   count is read around this run alone and checked against the count the
   path implies, and no plain version may be called; (3f) the same model
   with ``fused_ffn=True`` (its FFN is #11 in every prefill and decode
   step) serves the same requests under the same checks;
4. one request's prefill and 4 decode steps on the card against a CPU copy
   of the same model (the plain versions): logits within a bf16 tolerance,
   same greedy tokens; (4f) the same with ``fused_ffn=True``;
5. GPT-350M training (the fused LM head, micro-batch 8 x accumulation 2 x
   seq 1024 = 16,384 tokens per step, ``FusedAdam(lr=1e-4)`` AdamW: the
   configuration of bench.py's GPT leg) for 4 steps on one fixed batch
   from seed 0, through ``forward_backward_no_pipelining`` over ``GPTModel``'s loss and backward
   and ``FusedAdam.step``: losses finite and falling, step time, tokens/s,
   peak memory, exact launch counts per kernel, and no call of a plain
   version; (5f) the same with ``fused_ffn=True`` (#11-#13 in every layer),
   its step time, tokens/s and peak memory beside phase 5's; (5r) the
   same as phase 5 under activation recompute, ``remat_policy="full"``
   and ``"dots"``: exact launches (each layer's two LayerNorm forwards
   and flash forward run again in the backward), no plain version, each
   step's loss within 1e-6 relative of phase 5's (bit-equality printed),
   and the peak memory above each run's start ordered full < dots < no
   remat;
6. a small GPT (4 layers, hidden 256, vocab 50304, seq 256, attention
   dropout 0.1) trained 2 steps on the card and on a CPU copy, with the
   fused LM head, again with the f32-logits head (``fused_lm_head=False``)
   and again with ``fused_ffn=True``: loss, every gradient and the
   parameters within stated tolerances; (6r) the same under each remat
   policy;
7. BERT-large (vocab 30528, hidden 1024, 24 layers, 16 heads, ffn 4096,
   seq 512, the fused LM head) under ``amp.initialize(...,
   opt_level="O2")`` with ``FusedLAMB(lr=1e-3)``: micro-batch 16 x
   accumulation 2 x seq 512, 15% MLM labels from seed 0 (bench.py's
   recipe), 4 steps through ``forward_backward_no_pipelining`` over
   ``BertModel.loss`` and ``FusedLAMB.step``: losses, step time, tokens/s,
   peak memory, exact launch counts per kernel, no plain version called;
   (7f) the same with ``fused_ffn=True``; (7r) the same under
   ``remat_policy="dots"`` (bench.py's pairing), its losses and peak
   memory against phase 7's as in 5r; then (7b)
   ``LossScaler.unscale`` and ``clip_grad_norm_`` on phase 7's last step's
   gradients against their plain versions, their launches counted alone;
8. a small BERT (4 layers, hidden 256, seq 128, vocab 30528, the fused LM
   head) under O2 + FusedLAMB trained 2 steps on the card and on a CPU
   copy, and again with ``fused_ffn=True``: loss, every gradient, the
   masters, m and v within stated bounds; then (8b) a
   dynamic-loss-scale step with an inf in one gradient, skipped on the
   device;
9. ResNet-50 ImageNet through the ported example's ``main()``
   (``apex_tpu_torch/examples/imagenet/main_amp.py`` at its defaults:
   batch 256 x 224^2, 1000 classes, FusedSGD lr 0.1, momentum 0.9, wd
   1e-4, synthetic data from seed 0; a warm-up step, then 4) under amp O1:
   losses, step time, img/s, peak memory, the exact #19 launches and no
   plain version called; (9b) the same under O2 (f32 batch norm, FusedSGD
   with f32 masters); (9c) one step each with FusedAdagrad (#22) and
   FusedNovoGrad (#17 per-tensor sums, #23) on 9b's model; (9d) the
   example's hand-written SGD (#17 overflow check, #16 update);
10. resnet26 (width 16, 64 x 64, batch 8, 10 classes) trained 2 steps
   under O1 on the card and on a CPU copy (and in f32 on the CPU, the
   yardstick) with each of the three optimizers: losses, the first
   step's gradients, the parameters' moves and the running statistics
   within stated bounds; FusedSGD's card run again with the process-wide
   matmul flags as torch set them before the GPT phases;
11. GPT-350M with phase 3's weights served by ``PagedInferenceEngine``
   (8 slots, blocks of 16, bf16 pool, prefix sharing on) over phase 3's
   prompts stretched into the 512 bucket, half behind a 64-token system
   prompt, 64 new tokens each (``paged_prompts``): exact launches (#7 in
   every decode step, #3 per prefill), no plain version called, greedy
   tokens equal to the contiguous engine's on the same prompts, the
   prompt tokens served from the prefix trie; (11c) chunked prefill
   (agreement measured); (11p) a pool of 1 + 3 x 64 blocks that forces
   preemption, tokens equal to 11's; (11q) ``weight_quant="int8"``
   through both engines (#14 in every GEMM and the tied head, 4L+1 per
   prefill and step), weight bytes and peak memory against f32, card
   against a CPU copy as in phase 4, prefill and paged decode-step
   times; (11k) the int8 KV pool with chunked prefill on 4 prompts of at
   most 128 tokens (its plain PyTorch insert loop timed);
12. the ops without a kernel at full width, card against a CPU copy of a
   slice: ``FusedScaleMaskSoftmax`` with a padding mask at BERT-large's
   scores (16, 16, 512, 512) and causal at GPT-350M's (8, 16, 1024, 1024),
   bf16, forward and backward; ``SoftmaxCrossEntropyLoss`` at GPT-350M's
   logits (8192 x 50304 bf16, ``half_to_float``, smoothing 0.1, padded
   rows); and on phase 6's small GPT the legacy ``amp.init()`` +
   ``wrap_optimizer(FusedAdam)`` and ``FP16_Optimizer`` (dynamic scale)
   over ``network_to_half``, each skipping an injected overflow step bit
   for bit, no plain version called.  (Phase 12 runs after 8b.)
13. the serving fleet on phase 3's GPT-350M (after phase 11, on a virtual
   clock; every run counts its launches exactly, calls no plain version and
   answers no request with ``"error"``): (13a) ``tools/loadgen_torch.py``'s
   ``replica_kill`` over 3 ``PagedInferenceEngine(max_slots=4,
   block_size=16)`` replicas, 16 requests of 4..512 prompt tokens, about
   half behind one 64-token prefix, 32 new tokens, replica 1 crashing at
   tick 4: exactly once, the crash migrates work, only replica 1's health
   changes (suspect, then dead), tokens equal one uninterrupted paged
   engine's; (13b) ``bursty`` (bursts of 8, 2 queued a replica, no fleet
   retry budget): exactly once, every shed names its ``ShedReason``;
   (13c) two ``InferenceEngine(max_slots=8)``: ``export_inflight`` at
   decode step 8 and ``adopt`` give the uninterrupted tokens, or leave
   them only at a near-tie (top-2 gap under ``LOGITS_ATOL``: the re-prefill
   rounds in another order than the decode steps it replaces), a deadline
   and a timeout end ``"evicted"`` / ``"timeout"`` with their partial
   tokens; (13d) ``DisaggregatedFleet`` (1 prefill-only + 1 decode replica,
   chunked prefill, ``KvChannel``) with a bf16 pool, the int8 KV pool, and
   int8 KV with int8 weights (#14): every request ships (no handoff lost),
   each install is its payload bit for bit, the channel's bytes are the
   blocks shipped times ``block_bytes``, the prefill replica never decodes,
   and one request at a time the tokens equal the chunked paged engine's
   (at full concurrency the agreement is measured); (13e)
   ``PoolCapacityController`` moves one replica prefill -> decode under
   traffic: it commits, exactly once, ``audit()`` clean; (13f) 13a's merged
   trace passes ``check_flows`` (one connected chain per request, the
   migrated ones included), the engines' ``serving_*`` registry series
   match the responses, and the host time a tick with the tracers on and
   off.
14. data parallelism over NCCL (PR 20): ``torch.cuda.device_count()``
   ranks, spawned processes that join through ``parallel_state``, each on
   its rows of the same global batches as the single-process phases:
   (14a) BERT-large O2 at phase 7's recipe stepped by
   ``DistributedFusedLAMB`` (#17 over the rank's gradient segments, #20,
   #21 on its shard of the packed buckets), 4 steps, then 2 with
   ``allreduce_dtype="int8"``; (14b) GPT-350M at phase 5's recipe
   stepped by ``DistributedFusedAdam(message_size=10_000_000)`` (#18 on
   its 10 MB buckets; its reduce-scatter is the gradient reduction, so no
   DDP), 4 steps; (14c) ResNet-50 O1 through the example's distributed
   path (``--sync-bn``: statistics over the ranks, DDP, FusedSGD #19), a
   warm-up step and 4.  Each rank's launches are exact (the optimizer's
   from its own shard's segments), no plain version is called, its peak
   memory is logged beside the single-process phase's, and the ranks' mean
   losses are held against phases 7 and 5 (14b bit for bit), and 14c's
   against the example's recipe in one process with its batch norms on
   the same group path and no DDP (``DP_*_RTOL``; phase 9's cuDNN batch
   norm is logged beside it).  The ranks join through a ``file://`` store
   under ``build/phase14/``.  A rank that raises fails the run.  Phase 2 also holds #18 on GPT-350M's f32 bucket and #17, #20,
   #21 on BERT-large's O2 buckets in this packed segment form (one rank's
   shard at world 1) against their plain versions, timed beside the
   per-parameter lists.
15. tensor and sequence parallelism over NCCL: ``torch.cuda.device_count()``
   ranks, spawned processes joined through ``parallel_state.
   initialize_model_parallel(tp=ranks)``, each first running the
   one-process references (``axis_name=None``, ``fused_lm_head=False``),
   then at ``tensor_parallel_size`` = the ranks, ``axis_name="model"``,
   ``sequence_parallel=True``, ``fused_ffn=True`` and the f32
   vocab-parallel head: (15a) GPT-350M at phase 5's recipe with FusedAdam,
   4 steps; (15b) the same with ``overlap_chunks=2``, 2 steps; (15c)
   BERT-large O2 + FusedLAMB at phase 7's recipe with
   ``overlap_chunks=2``, 2 steps.  Each rank's launches of #1-#5, #11-#13
   and #18 (15c: #17, #20, #21) are exact, no plain version is called, no
   loss is non-finite, the peak memory is logged beside the reference's
   and phase 5's / 7's, and the losses are held against the references
   (``tp_loss_limits``: at one rank 15a bit for bit, 15b and 15c at a
   gate between a correct and a planted-fault reading of
   ``tools/tensor_parallel_torch.py --gates``; at 2 and 4 cards all three
   at such gates read on 2 / 4 cards; a count of ranks without readings
   raises).  Phase 2 also holds #3-#5
   at the local heads (8, 8, 1024, 64) and (8, 4, 1024, 64) and #11-#13 at
   the FFN shards 8192 x 1024 -> 2048 / 1024 -> 1024.
16. expert, pipeline and context parallelism over NCCL:
   ``torch.cuda.device_count()`` ranks (spawned processes under
   ``build/phase16/``, one on a one-card machine, where every hop and
   collective is local): (16a) Switch-GPT-350M/8 (phase 5's GPT-350M with
   8 experts a layer, top-1, capacity factor 1.25, aux weight 1e-2: 1.76
   billion parameters) trained through the ported example's ``main()``
   (``apex_tpu_torch/examples/moe/train_switch_gpt.py``: micro-batch 8 x
   2 x 1024 tokens, ``FusedAdam(lr=1e-4)``, a warm-up step and 4): losses,
   aux losses, step times, peak memory, exact launches of #1-#5, #8-#10
   and #18, no plain version; then one GShard (top-2) step at the same
   widths; (16p) a small Switch and GShard GPT (phase 6's widths, 8
   experts, f32: routing is discrete) 2 steps on the card and on a CPU
   copy under phase 6's gates, the experts' ``w1`` gradient in norm
   (ReLU's kink, ``PARITY_MOE``) at a gate between a correct and a
   planted-fault reading (``MOE_W1_NORM_TOL``);
   (16b) the trained Switch model serving phase 3's 10 requests through
   ``InferenceEngine``: exact #1, #3, #6 launches, no plain version, the
   share of the real tokens' token-choices the capacity dropped logged for
   the prefills and the decode steps apart (a decode step's 8 rows over 8
   experts have capacity 1: JAX's semantics), and a small
   f32 Switch GPT's prefill and decode on the card against a CPU copy
   under phase 4's gates; (16c) GPT-350M at phase 5's recipe through
   ``pipeline_step`` with ``n_virtual=2`` (interleaved chunks; at one rank
   the wrap hop is local), 4 steps, exact launches, the losses held
   against ``forward_backward_no_pipelining`` on the same weights and
   batch at a gate between a correct and a planted-fault reading
   (``MP_LOSS_RTOL``); (16d) the same model with ``context_axis``, 2 steps
   each with Ulysses and ring attention on the rank's sequence shard: at
   one rank both are the flash path, held bit for bit against 16c's
   reference.  ``tools/model_parallel_torch.py`` runs the same code at 2
   and 4 cards (EP, PP 1F1B and interleaved, PP x TP with SP, CP), each
   path held to its gate from the readings at that card count (a count
   without readings raises).
17. resilience on GPT-350M at phase 5's recipe and batch (``FusedAdam(lr=
   1e-4)``, weights from seed 0; checkpoints of 4.25 GB under a temporary
   directory of ``build/``, removed after; ``keep=2``, a save every 4
   steps): (17a) ``GuardedTrainStep`` over 13 steps of one
   ``FaultInjector`` schedule (an inf loss, a x64 gradient spike after the
   warm-up, three NaN-gradient steps in a row that roll back, the
   checkpoint before them corrupted so the rollback falls back to the one
   before it): the (skipped, anomaly, next step, rolled back, restored
   from) sequence equals the schedule's, a skipped step leaves the
   parameters, Adam's m and v and the step count bitwise unchanged, the
   rollback restores the checkpointed state bitwise, every clean step is
   bitwise an unguarded phase-5 step on a second model, and each step's
   launches are phase 5's plus #17's sum of squares; (17b)
   ``ElasticTrainer``: a ``HostSignals`` soft preemption checkpoints and
   stops, a fresh trainer resumes from disk and replans in place, and its
   final state is bitwise an uninterrupted run's; a ``save_async`` followed
   at once by a step restores to the pre-step state bitwise; (17c)
   ``DistributedFusedAdam`` through ``ZeROGuardAdapter`` at one rank: a
   checkpoint stamped dp=1 zero=1 restored and re-sharded onto the same
   plan bitwise, exact launches (#18 on the packed segments); (17d) the
   native host library must load, and every save and restore logs its
   bytes, seconds, GB/s and sha256 seconds.  ``tools/elastic_torch.py``
   runs ZeRO dp 4 -> 2 -> 4, 2 -> 1 -> 2 and a hard preemption while
   shrunk at 2 and 4 cards, each held to its gate from the readings at
   that card count.
18. training telemetry and the cost-model loop on GPT-350M (phase 17's
   recipe, batch and weights): (18a) phase 17's ``GuardedTrainStep``
   wrapped by ``TrainingMonitor`` (16,384 tokens a step, ``bench.py``'s
   6 N + 12 L h s FLOP a token, the peak calibrated on the card), 8 steps
   with one planted NaN gradient: each monitored step bit for bit an
   unmonitored guarded step from the same state on a second model, each
   step's launches phase 17a's, ``train_anomalies_total{kind=nonfinite}``
   1 and the guard's stats, every ``train_step`` record carrying the
   alerting keys; the calibrated peak (the products' rate: the chain of
   the rescales alone is taken off), tokens/s, MFU against it and against
   the dense bf16 peak, the monitored and unmonitored step medians and the monitor's host time logged beside the
   card's name and power limit; on ``torch.cuda.device_count()`` NCCL
   ranks (spawned processes): (18b) ``collective_stats`` of one ZeRO step
   (phase 14b's ``DistributedFusedAdam``, 10 MB buckets, stepped with the
   overflow flag) and of one DDP step, counts and bytes equal to their
   bucket layouts' (at one rank the groups of one rank still dispatch
   their collectives), each op's scope the range it ran under, and every
   ``c10d`` op name this torch dispatches for the probe's collectives,
   ``all_to_all``, the port's differentiable ``all_to_all`` and the
   compressed all-reduce mapped to a kind; (18c) ``ParallelismAutopilot``
   over a ZeRO ``ElasticTrainer`` of GPT-350M fed each real step's wall
   time and an injected ``cost_drift``: its refit count and the ticks its
   drift is confirmed at equal the same autopilot's over the reference's
   ``FakeTrainer`` recipe on the same schedule, ``audit() == []``, and at
   one rank (plan space dp 1) the outcome ``no_change``.
   ``tools/comms_probe_torch.py`` fits the NVLink alpha-beta profile and
   ``tools/autopilot_torch.py`` runs the commit and the rollback with real
   replans at 2 and 4 cards.
19. the cross-pod MPMD pipeline on GPT-350M (phase 5's weights and batch
   as 4 micro-batches of 4 x 1024 tokens, ``FusedAdam(lr=1e-4)``, two
   pods): (19a) ``MpmdPipeline`` at dp 1, pp 2, ``dcn_hiding``, traced,
   one scheduled ``dcn_fault``, 3 steps, step 0 as ``loss_and_grads`` and
   each stage's ``apply_grads``; (19c) its ``save_checkpoint``, a step,
   ``restore_stage(0)`` and ``restore_checkpoint``; (19b) pp 4, ``1f1b``,
   ``measure_ops``, 2 steps.  Each run's launches of #1-#5, #8-#10 and #18
   are exact (#18 from each stage's own list, ``table_launches``), no plain
   version is called, the two tied-embedding replicas are bit for bit
   equal after every step, the channel retries 19a's one fault and no
   other, the flow chains are unbroken (M + 1 complete a step), step 0's
   loss and every gradient are held against ``forward_backward_no_
   pipelining`` over the same micro-batches in one process at
   ``MPMD_GATES`` (bit for bit but the embedding's: gates from correct and
   planted-fault readings of ``tools/mpmd_torch.py --gates``), each
   stage's five attribution categories sum to its makespan within 1e-9
   relative, and 19c restores every stage bit for bit at the saved step.
   Step times, tokens/s, peak memory, the channel's bytes and seconds, the
   attribution table and the diff against ``simulate`` at the measured
   median op times are logged.  ``tools/mpmd_torch.py`` runs the same
   recipes with stage ``i`` on ``cuda:i`` at 2 and 4 cards.
20. the Conformer RNN-T recipe and the contrib ops: #3-#5 at its attention
   shape, (8, 4, 200, 64) f32 non-causal, against their plain versions,
   with their times, SDPA's on the same f32 operands and the bound; #1 and
   #2 at its LayerNorms' (1600 x 256 f32) and #17 and #23 over
   Conformer-M's parameter list likewise (``F.layer_norm``, aten's
   LayerNorm backward and ``torch._foreach_norm`` the library calls); (20a)
   the ported example's ``main()``
   (``apex_tpu_torch/examples/conformer/train_rnnt.py``) at Conformer-M
   width (hidden 256, 4 heads, 16 layers, a 640-wide LSTM predictor; 8
   utterances of 800 frames, 40 targets, vocab 128, f32,
   ``FusedNovoGrad(lr=1e-3)``, a warm-up step and 3): losses, step times,
   utt/s, peak memory, per step exactly 4L launches of #1 and #2, L of #3,
   #4 and #5, and NovoGrad's #17 and #23 table launches, no plain version
   called; (20b) 2 steps of a 2-layer model at the same encoder widths
   (hidden 256, 4 heads; a 256-wide LSTM, 2 utterances) on the card
   and on a CPU copy with the same weights and batches: losses, step 0's
   gradients and the parameters after each step within
   ``CONFORMER_GATES``, and each of ``CONFORMER_FAULTS`` planted in the
   card run (a swapped LSTM gate, the lattice read at ``y_len - 1``)
   outside every gate; (20c) ``EncdecMultiheadAttn`` (with and without
   dropout), ``fmha`` over ragged ``cu_seqlens`` (and causal),
   ``attention_core`` (flash, and with pair bias and mask),
   ``FastLayerNorm``, ``FusedAdamSWA`` (2 steps), ``GroupNorm``,
   ``BatchNorm2d_NHWC``, the four ``conv_bias_relu`` functions,
   ``focal_loss``, ``index_mul_2d`` and the packed transducer joint, once
   each on the card against a CPU run of the same inputs (outputs and
   gradients), with exact launches and no plain version in the card runs.

The last lines are the card's name and power limit, a ``{"kernels": ...}``
JSON line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import importlib
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
PEAK_BF16_FLOPS = 989e12       # dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12         # f32 outside the tensor cores

GPT350M = dict(vocab_size=50304, hidden_size=1024, num_layers=24,
               num_attention_heads=16, ffn_hidden_size=4096,
               max_seq_len=1024)
SLOTS = 8
HEADS, HEAD_DIM, HIDDEN, MAX_SEQ = 16, 64, 1024, 1024
# bench.py's GPT train step (bench_gpt_train_step)
MICRO, ACCUM, SEQ, LR, TRAIN_STEPS = 8, 2, 1024, 1e-4, 4
TRAIN_ROWS = MICRO * SEQ       # rows of every LayerNorm on that path
BF16_ATOL = BF16_RTOL = 2e-2   # one bf16 ulp at |y| <= 4 is 2**-6 = 0.0156
# f16 keeps 11 significant bits: one ulp at |y| <= 4 is 2**-9 = 0.002, and
# the f16 flash forward (FMA units) does not round p where its plain version
# rounds it to f16 before PV (at most one more ulp)
F16_ATOL = F16_RTOL = 4e-3
F32_ATOL = F32_RTOL = 1e-4     # f32 kernels: the same sums in other orders
# Whole path, card vs CPU, both bf16: the two runs round and reduce in other
# orders, so the final hidden state drifts by ~1-2% over 24 residual layers
# (bf16 keeps 8 significant bits): a logit error of ~0.01 on a logit std of
# ~0.64, whose maximum over the 5 x 50304 logits compared is ~5 sigma.
LOGITS_ATOL = 0.1              # max |logit diff|
LOGITS_MEAN_ATOL = 0.02        # mean |logit diff|
# Training, card vs CPU, bf16 activations: each gradient within 5e-2 of its
# largest entry (bf16 rounding places and sum orders differ; the same bound
# holds the port against JAX on the CPU); the loss within 2e-3 relative.
# Adam moves an entry by about lr per step whatever its gradient's size, so
# an entry whose gradient is at noise level (the key bias, which softmax
# ignores) may move the other way on one side.  At step 2 |m^ / sqrt(v^)|
# is at most 1.0014 lr (Cauchy-Schwarz over the two gradients), so after 2
# steps entries may differ by 4.003 lr: checked at 4.5 lr; 99% of entries
# agree to lr / 2.
TRAIN_GRAD_TOL = 5e-2
TRAIN_LOSS_RTOL = 2e-3
# bench.py's BERT-large + amp O2 + FusedLAMB step (_make_bert_lamb_step)
BERT_LARGE = dict(vocab_size=30528, hidden_size=1024, num_layers=24,
                  num_attention_heads=16, ffn_hidden_size=4096,
                  max_seq_len=512, type_vocab_size=2)
BERT_MICRO, BERT_ACCUM, BERT_SEQ, BERT_LR, BERT_STEPS = 16, 2, 512, 1e-3, 4
BERT_ROWS = BERT_MICRO * BERT_SEQ
LAMB_BETAS, LAMB_WD = (0.9, 0.999), 0.01
# Training, card vs CPU under LAMB: each leaf's whole move over the steps
# agrees, ||p_card - p_cpu|| <= MOVE_RTOL ||p_cpu - p0||.  The entry-wise
# bound of phase 8 admits a master that never moved (share 1) or moved at
# half the learning rate (0.5); the CPU tests against JAX see at most 0.2.
MOVE_RTOL = 0.35


def log(msg):
    print(msg, flush=True)


def time_ms(fns, rounds=5):
    """Device time per call: the calls in ``fns`` (one callable, or a list
    cycled through, e.g. one per cache layer so that inputs come from
    device memory and not from L2 as on the real path) captured in one
    CUDA graph and replayed ``rounds`` times; median of the mean per call.
    Host launch overhead is excluded (see ``call_ms``)."""
    fns = fns if isinstance(fns, list) else [fns] * 20
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up outside the capture
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / len(fns))
    del graph
    return statistics.median(samples)


def call_ms(fn, iters=50):
    """Time per eager call, back to back, by CUDA events: what a caller
    pays, host overhead included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, flops, peak):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_err(out, ref):
    return float((out.float() - ref.float()).abs().max())


def check_close(name, out, ref, atol, rtol):
    err = max_err(out, ref)
    ok = torch.allclose(out.float(), ref.float(), atol=atol, rtol=rtol)
    log(f"  {name}: max_abs_err={err:.3e} (tolerance |d| <= {atol} + "
        f"{rtol}*|ref|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def numbers(err, ms, plain, lib, bound, host):
    bms, by = bound
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, call_ms=host)


def log_numbers(name, n, lib_name):
    lib = ("" if n["library_ms"] is None
           else f" {n['library_ms']:.4f} ms")
    log(f"  {name}: {n['ms']:.4f} ms (eager call {n['call_ms']:.4f} ms), "
        f"plain {n['plain_ms']:.4f} ms, {lib_name}{lib}, "
        f"bound {n['bound_ms']:.5f} ms ({n['bound_by']})")


# -- phase 1 -----------------------------------------------------------------

# kernels whose registers and spills phase_build names one by one (the
# tensor-core dq, the GEMM mainloops of the FFN and the LM head, the
# LayerNorm backward's row-per-warp body and LAMB stage 1)
NAMED_REPORT = ("flash_bwd_dq_mma_kernel", "gemm_tma_kernel",
                "gemm_tma_rows_kernel", "gemm_nt_mma_kernel",
                "gemm_fma_kernel", "layer_norm_bwd_warp_kernel",
                "multi_tensor_lamb_stage1_kernel")


def _ptxas_by_kernel(text, wanted):
    """(demangled name, 'N registers, S bytes spill stores, L bytes spill
    loads') for each kernel of nvcc's ``-Xptxas -v`` report whose mangled
    name contains one of ``wanted``."""
    rows, name, spill = [], None, ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            if any(w in name for w in wanted):
                used = line.split("Used", 1)[1].split(",")[0].strip()
                rows.append((name, f"{used}; {spill}"))
            name = None
    try:
        out = subprocess.run(["c++filt"], input="\n".join(n for n, _ in rows),
                             capture_output=True, text=True, timeout=30)
        names = out.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) != len(rows):
        names = [n for n, _ in rows]
    return [(n, r) for n, (_, r) in zip(names, rows)]


def phase_build():
    from apex_tpu_torch import _kernels
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.lib()
    log(f"[1] built {path.name} in {time.perf_counter() - t0:.1f} s")
    report = path.with_suffix(".log")
    if report.exists():
        text = report.read_text()
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "wgmma" in line
                    or line.startswith("==")):
                log("    " + line.strip())
        for name, regs in _ptxas_by_kernel(text, NAMED_REPORT):
            log(f"    {name}: {regs}")


# -- phase 2 -----------------------------------------------------------------

def kernel_layer_norm(gen):
    from apex_tpu_torch.ops.layer_norm import (layer_norm_fwd,
                                               layer_norm_fwd_reference)
    dev = "cuda"
    w = (1 + 0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
    b = (0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
    w16, b16 = w.bfloat16(), b.bfloat16()
    rows_main = {}
    for rows in (SLOTS, 512, TRAIN_ROWS):
        x = torch.randn(rows, HIDDEN, generator=gen).to(dev, torch.bfloat16)
        err = 0.0
        for rms in (False, True):
            bias = None if rms else b
            y, mean, rstd = layer_norm_fwd(x, w, bias, 1e-5, rms)
            ry, rmean, rrstd = layer_norm_fwd_reference(x, w, bias, 1e-5, rms)
            torch.cuda.synchronize()
            tag = f"layer_norm_fwd rows={rows} {'rms' if rms else 'ln'}"
            err = max(err, check_close(tag + " y", y, ry, BF16_ATOL,
                                       BF16_RTOL))
            check_close(tag + " mean", mean, rmean, 1e-5, 1e-5)
            check_close(tag + " rstd", rstd, rrstd, 1e-5, 1e-4)
        n_bytes = 2 * rows * HIDDEN * 2 + 2 * HIDDEN * 4 + 2 * rows * 4
        n = numbers(
            err, time_ms(lambda: layer_norm_fwd(x, w, b, 1e-5, False)),
            time_ms(lambda: layer_norm_fwd_reference(x, w, b, 1e-5, False)),
            time_ms(lambda: F.layer_norm(x, (HIDDEN,), w16, b16, 1e-5)),
            bound_ms(n_bytes, 8 * rows * HIDDEN, PEAK_F32_FLOPS),
            call_ms(lambda: layer_norm_fwd(x, w, b, 1e-5, False)))
        log_numbers(f"layer_norm_fwd rows={rows}", n, "F.layer_norm")
        if rows == TRAIN_ROWS:
            # 20 replays of one 16 MB input read it from the 50 MB L2; six
            # inputs (96 MB) taken in turn are read from device memory
            xs = [torch.randn(rows, HIDDEN, generator=gen).to(
                dev, torch.bfloat16) for _ in range(6)]
            n["ms_l2_cold"] = time_ms(
                [lambda x=x: layer_norm_fwd(x, w, b, 1e-5, False)
                 for x in xs] * 4)
            n["library_ms_l2_cold"] = time_ms(
                [lambda x=x: F.layer_norm(x, (HIDDEN,), w16, b16, 1e-5)
                 for x in xs] * 4)
            log(f"  layer_norm_fwd rows={rows}, six inputs in turn (read "
                f"from device memory): {n['ms_l2_cold']:.4f} ms, "
                f"F.layer_norm {n['library_ms_l2_cold']:.4f} ms, bound "
                f"{n['bound_ms']:.5f} ms")
            del xs
        rows_main[rows] = n
    # BERT's MLM LayerNorm takes the f32 output of its transform (f32 in,
    # f32 out): the same math without the bf16 rounding of y, so the
    # kernel and its plain version differ only in their f32 sum orders
    x = torch.randn(TRAIN_ROWS, HIDDEN, generator=gen).to(dev)
    y, mean, rstd = layer_norm_fwd(x, w, b, 1e-5, False)
    ry, rmean, rrstd = layer_norm_fwd_reference(x, w, b, 1e-5, False)
    torch.cuda.synchronize()
    tag = f"layer_norm_fwd rows={TRAIN_ROWS} f32 ln"
    if y.dtype != torch.float32:
        raise AssertionError(f"{tag}: y is {y.dtype}, not f32")
    check_close(tag + " y", y, ry, 1e-5, 1e-5)
    check_close(tag + " mean", mean, rmean, 1e-5, 1e-5)
    check_close(tag + " rstd", rstd, rrstd, 1e-5, 1e-4)
    for hidden in (48, 1000, 1024, 1600, 4096, 8192):
        for rows in (1, 300):
            _ln_edge_case(gen, rows, hidden, torch.bfloat16, False)
        _ln_edge_case(gen, 300, hidden, torch.bfloat16, True)
    for dtype in (torch.float16, torch.float32):
        for hidden in (1000, 1024):
            for rms in (False, True):
                _ln_edge_case(gen, 300, hidden, dtype, rms)
    for dtype in (torch.bfloat16, torch.float32):
        _ln_edge_case(gen, 300, HIDDEN, dtype, False, offset=1)
    return rows_main


# phase-2 tolerances of #1's y by dtype (mean 1e-5 + 1e-5 |ref|, rstd 1e-5 +
# 1e-4 |ref| in every dtype)
LN_Y_TOL = {torch.bfloat16: (BF16_ATOL, BF16_RTOL),
            torch.float16: (F16_ATOL, F16_RTOL), torch.float32: (1e-5, 1e-5)}


def _ln_edge_case(gen, rows, hidden, dtype, rms, offset=0):
    """#1 against its plain version at one shape; ``offset`` puts x that
    many elements into its storage (off the 16-byte grid: the
    block-per-row body).  Logs the body ``layer_norm_fwd_path`` picked."""
    from apex_tpu_torch.ops.layer_norm import (layer_norm_fwd,
                                               layer_norm_fwd_path,
                                               layer_norm_fwd_reference)
    w = (1 + 0.1 * torch.randn(hidden, generator=gen)).to("cuda")
    b = None if rms else (0.1 * torch.randn(hidden, generator=gen)).to("cuda")
    x = _at_offset(torch.randn(rows, hidden, generator=gen).to("cuda", dtype),
                   offset)
    nv = layer_norm_fwd_path(hidden, dtype, x.data_ptr() % 16 == 0)
    y, mean, rstd = layer_norm_fwd(x, w, b, 1e-5, rms)
    ry, rmean, rrstd = layer_norm_fwd_reference(x, w, b, 1e-5, rms)
    torch.cuda.synchronize()
    tag = (f"layer_norm_fwd {rows}x{hidden} {str(dtype)[6:]} "
           f"{'rms' if rms else 'ln'}"
           + (f", x at storage offset {offset}" if offset else "")
           + (f" (row per warp, {nv} vectors a lane)" if nv
              else " (block per row)"))
    if y.dtype != dtype or y.shape != x.shape:
        raise AssertionError(f"{tag}: y is {y.dtype} {tuple(y.shape)}")
    check_close(tag + " y", y, ry, *LN_Y_TOL[dtype])
    check_close(tag + " mean", mean, rmean, 1e-5, 1e-5)
    check_close(tag + " rstd", rstd, rrstd, 1e-5, 1e-4)


def kernel_layer_norm_bwd(gen):
    """#2 at the training shape (8192 x 1024 bf16, LN from x; also with six
    inputs in turn, read from device memory), the same shape in f32 (BERT's
    MLM LayerNorm), small from_y / RMS / f32 cases, then both bodies at the
    edges of ``_ln_bwd_edges``."""
    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd,
                                               layer_norm_bwd_reference,
                                               layer_norm_fwd)
    dev = "cuda"
    out = {}
    cases = [(TRAIN_ROWS, torch.bfloat16, False, False),
             (TRAIN_ROWS, torch.float32, False, False),
             (512, torch.bfloat16, False, True), (512, torch.bfloat16, True,
                                                  False),
             (512, torch.bfloat16, True, True), (300, torch.float32, False,
                                                 True)]
    for rows, dt, rms, from_y in cases:
        w = (1 + 0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
        b = None if rms else (0.1 * torch.randn(HIDDEN, generator=gen)).to(dev)
        x = torch.randn(rows, HIDDEN, generator=gen).to(dev, dt)
        dy = torch.randn(rows, HIDDEN, generator=gen).to(dev, dt)
        y, mean, rstd = layer_norm_fwd(x, w, b, 1e-5, rms)
        res = y if from_y else x
        dx, dw, db = layer_norm_bwd(dy, res, w, b, mean, rstd, rms, from_y)
        rdx, rdw, rdb = layer_norm_bwd_reference(dy, res, w, b, mean, rstd,
                                                 rms, from_y)
        torch.cuda.synchronize()
        tag = (f"layer_norm_bwd rows={rows} {str(dt)[6:]} "
               f"{'rms' if rms else 'ln'}{' from_y' if from_y else ''}")
        err = _ln_bwd_check(tag, (dx, dw, db), (rdx, rdw, rdb), dt, rms)
        if (rows, dt, rms, from_y) != (TRAIN_ROWS, torch.bfloat16, False,
                                       False):
            continue
        x_, w16, b16 = x, w.bfloat16(), b.bfloat16()
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x_, [HIDDEN], w16,
                                                           b16, 1e-5)
        n_bytes = 3 * rows * HIDDEN * 2 + 2 * HIDDEN * 4 + 2 * rows * 4 \
            + 2 * HIDDEN * 4
        n = numbers(
            err,
            time_ms(lambda: layer_norm_bwd(dy, x, w, b, mean, rstd, False,
                                           False)),
            time_ms(lambda: layer_norm_bwd_reference(dy, x, w, b, mean, rstd,
                                                     False, False)),
            time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x_, [HIDDEN], lmean, lrstd, w16, b16, [True, True, True])),
            bound_ms(n_bytes, 12 * rows * HIDDEN, PEAK_F32_FLOPS),
            call_ms(lambda: layer_norm_bwd(dy, x, w, b, mean, rstd, False,
                                           False)))
        log_numbers(f"layer_norm_bwd rows={rows}", n,
                    "aten native_layer_norm_backward")
        # 20 replays of one (dy, x) pair (32 MB) read it from the 50 MB L2;
        # six pairs (192 MB) taken in turn are read from device memory
        sets = []
        for _ in range(6):
            xi = torch.randn(rows, HIDDEN, generator=gen).to(dev, dt)
            dyi = torch.randn(rows, HIDDEN, generator=gen).to(dev, dt)
            _, mi, ri = layer_norm_fwd(xi, w, b, 1e-5, False)
            _, lmi, lri = torch.ops.aten.native_layer_norm(xi, [HIDDEN], w16,
                                                           b16, 1e-5)
            sets.append((dyi, xi, mi, ri, lmi, lri))
        n["ms_l2_cold"] = time_ms(
            [lambda t=t: layer_norm_bwd(t[0], t[1], w, b, t[2], t[3], False,
                                        False) for t in sets] * 4)
        n["library_ms_l2_cold"] = time_ms(
            [lambda t=t: torch.ops.aten.native_layer_norm_backward(
                t[0], t[1], [HIDDEN], t[4], t[5], w16, b16,
                [True, True, True]) for t in sets] * 4)
        log(f"  layer_norm_bwd rows={rows}, six inputs in turn (read from "
            f"device memory): {n['ms_l2_cold']:.5f} ms, "
            f"native_layer_norm_backward {n['library_ms_l2_cold']:.5f} ms, "
            f"bound {n['bound_ms']:.5f} ms")
        del sets
        out = n
    _ln_bwd_edges(gen)
    return out


# phase-2 tolerances of #2's dx by dtype (dgamma / dbeta 1e-3 + 1e-4 |ref|
# in every dtype: f32 sums over the rows in another order)
LN_DX_TOL = {torch.bfloat16: (BF16_ATOL, BF16_RTOL),
             torch.float16: (F16_ATOL, F16_RTOL), torch.float32: (1e-4, 1e-4)}


def _ln_bwd_check(tag, got, ref, dtype, rms):
    """dx, dgamma and (not under RMS) dbeta of #2 against its plain
    version; returns dx's max error."""
    err = check_close(tag + " dx", got[0], ref[0], *LN_DX_TOL[dtype])
    check_close(tag + " dgamma", got[1], ref[1], 1e-3, 1e-4)
    if not rms:
        check_close(tag + " dbeta", got[2], ref[2], 1e-3, 1e-4)
    return err


def _ln_bwd_edge_case(gen, rows, hidden, dtype, rms, from_y, offset=0):
    """#2 against its plain version at one shape, and again on the same
    inputs (bitwise the first call); ``offset`` puts dy that many elements
    into its storage (off the 16-byte grid: the block body).  Logs the
    body ``layer_norm_bwd_path`` picked."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd,
                                               layer_norm_bwd_parts,
                                               layer_norm_bwd_path,
                                               layer_norm_bwd_reference,
                                               layer_norm_fwd)
    w = (1 + 0.1 * torch.randn(hidden, generator=gen)).to("cuda")
    b = None if rms else (0.1 * torch.randn(hidden, generator=gen)).to("cuda")
    x = torch.randn(rows, hidden, generator=gen).to("cuda", dtype)
    dy = _at_offset(torch.randn(rows, hidden, generator=gen).to(
        "cuda", dtype), offset)
    y, mean, rstd = layer_norm_fwd(x, w, b, 1e-5, rms)
    res = y if from_y else x
    nv = layer_norm_bwd_path(hidden, dtype, dy.data_ptr() % 16 == 0)
    parts = layer_norm_bwd_parts(rows, nv, _kernels.sm_count(0))
    got = layer_norm_bwd(dy, res, w, b, mean, rstd, rms, from_y)
    again = layer_norm_bwd(dy, res, w, b, mean, rstd, rms, from_y)
    ref = layer_norm_bwd_reference(dy, res, w, b, mean, rstd, rms, from_y)
    torch.cuda.synchronize()
    tag = (f"layer_norm_bwd {rows}x{hidden} {str(dtype)[6:]} "
           f"{'rms' if rms else 'ln'}{' from_y' if from_y else ''}"
           + (f", dy at storage offset {offset}" if offset else "")
           + (f" (row per warp, {nv} vectors a lane" if nv
              else " (block body") + f", {parts} blocks)")
    if got[0].dtype != dtype or got[0].shape != x.shape:
        raise AssertionError(f"{tag}: dx is {got[0].dtype} "
                             f"{tuple(got[0].shape)}")
    _ln_bwd_check(tag, got, ref, dtype, rms)
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"{tag}: a repeat differs")


def _ln_bwd_edges(gen):
    """#2's bodies at the edges #1 is held at: hidden 48, 1000, 1024, 1600,
    4096 and 8192 (the row per warp up to 1024, the block body above and
    off the 16-byte vectors), 1 and 300 rows, bf16, f16 and f32, LN, RMS
    and from_y, dy off the 16-byte grid."""
    for hidden in (48, 1000, 1024, 1600, 4096, 8192):
        for rows in (1, 300):
            _ln_bwd_edge_case(gen, rows, hidden, torch.bfloat16, False, False)
        _ln_bwd_edge_case(gen, 300, hidden, torch.bfloat16, True, False)
        _ln_bwd_edge_case(gen, 300, hidden, torch.bfloat16, False, True)
    for dtype in (torch.float16, torch.float32):
        for hidden in (1000, 1024):
            for rms, from_y in ((False, False), (True, False), (False, True),
                                (True, True)):
                _ln_bwd_edge_case(gen, 300, hidden, dtype, rms, from_y)
    for dtype in (torch.bfloat16, torch.float32):
        _ln_bwd_edge_case(gen, 300, HIDDEN, dtype, False, False, offset=1)


def _flash_bound(batch, s, causal, n_products, n_io, lens=None, heads=HEADS):
    """Bytes: n_io (b, h, s, d) bf16 tensors read or written once, plus the
    f32 row statistics; operations: n_products products of head_dim per
    (query, key) pair the masks leave."""
    if lens is not None:
        pairs = int(sum(min(int(n), s) for n in lens)) * s
    elif causal:
        pairs = batch * s * (s + 1) // 2
    else:
        pairs = batch * s * s
    flops = 2 * n_products * HEAD_DIM * pairs * heads
    n_bytes = n_io * batch * heads * s * HEAD_DIM * 2 + batch * heads * s * 4
    return bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)


def _qkv_views(gen, batch, s, heads=HEADS, hd=HEAD_DIM, dtype=torch.bfloat16):
    """q, k, v as the model gives them: strided (b, h, s, d) views of one
    (b, s, h, 3*hd) projection."""
    qkv = torch.randn(batch, s, heads, 3 * hd, generator=gen).to("cuda", dtype)
    return [t.transpose(1, 2) for t in qkv.split(hd, dim=-1)]


# Off the 64-row tiles of the tensor-core kernels (ragged s, head_dim 16
# and 32, dropout, kv_seqlens with a fully masked batch and a block of keys
# past its length), then the FMA instantiations (f32, f16) at a small shape:
# (tag, head_dim, seq, causal, dropout, seed, kv_seqlens, dtype, atol / rtol)
RAGGED_S = 200
FLASH_EDGE_CASES = (
    ("causal", 16, RAGGED_S, True, 0.0, None, None, torch.bfloat16, BF16_ATOL),
    ("causal dropout=0.1", 16, RAGGED_S, True, 0.1, 77, None, torch.bfloat16,
     BF16_ATOL),
    ("kv_seqlens", 16, RAGGED_S, False, 0.0, None, [77, 200], torch.bfloat16,
     BF16_ATOL),
    ("causal", 32, RAGGED_S, True, 0.0, None, None, torch.bfloat16, BF16_ATOL),
    ("causal dropout=0.1", 32, RAGGED_S, True, 0.1, 78, None, torch.bfloat16,
     BF16_ATOL),
    ("kv_seqlens", 32, RAGGED_S, False, 0.0, None, [0, 133], torch.bfloat16,
     BF16_ATOL),
    ("causal f32", 32, 100, True, 0.0, None, None, torch.float32, F32_ATOL),
    ("causal f16", 32, 100, True, 0.0, None, None, torch.float16, F16_ATOL),
)


def _edge_inputs(gen, hd, s, lens, dtype):
    q, k, v = _qkv_views(gen, 2, s, 4, hd, dtype)
    do = torch.randn(2, s, 4, hd, generator=gen).to("cuda", dtype).transpose(1, 2)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device="cuda")
    return q, k, v, do, kl


def _check_refuses_misaligned(kernel, fn):
    """fn passes q one element off a 16-byte boundary: the wrapper must
    raise ValueError naming q, before any launch."""
    try:
        fn()
    except ValueError as e:
        if f"{kernel}: q must start on a 16-byte boundary" not in str(e):
            raise
        log(f"  {kernel} refuses a misaligned q ({e}) ok")
        return
    raise AssertionError(f"{kernel} took a q one element off its 16-byte "
                         "boundary")


def _misaligned_q(gen, hd=32):
    """(q, k, v) of a (1, 64, 4, 3*hd) projection, q sliced one element
    late."""
    qkv = torch.randn(1, 64, 4, 3 * hd, generator=gen).to("cuda",
                                                          torch.bfloat16)
    k, v = (qkv[..., i * hd:(i + 1) * hd].transpose(1, 2) for i in (1, 2))
    return qkv[..., 1:1 + hd].transpose(1, 2), k, v


def kernel_flash(gen):
    from apex_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                                    flash_fwd,
                                                    flash_fwd_reference)
    scale = HEAD_DIM ** -0.5
    by_len = {}                  # JSON keys: "s=<len>", "train_dropout_<rate>"
    for s in (8, 136, 512):
        q, k, v = _qkv_views(gen, 1, s)
        o, _ = flash_fwd(q, k, v, True, scale)
        ref = flash_attention_reference(q, k, v, True, scale)
        torch.cuda.synchronize()
        err = check_close(f"flash_fwd causal s={s}", o, ref, BF16_ATOL,
                          BF16_RTOL)
        if s == 136:
            lens = torch.tensor([100], dtype=torch.int32, device="cuda")
            o2, _ = flash_fwd(q, k, v, False, scale, lens)
            ref2 = flash_attention_reference(q, k, v, False, scale, lens)
            check_close("flash_fwd kv_seqlens=100 s=136", o2, ref2,
                        BF16_ATOL, BF16_RTOL)
        n = numbers(
            err, time_ms(lambda: flash_fwd(q, k, v, True, scale)),
            time_ms(lambda: flash_attention_reference(q, k, v, True, scale)),
            time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)),
            _flash_bound(1, s, True, 2, 4),
            call_ms(lambda: flash_fwd(q, k, v, True, scale)))
        log_numbers(f"flash_fwd s={s}", n, "sdpa")
        by_len[f"s={s}"] = n
    # the training shape, without and with dropout (the hash mask is
    # compared through the plain version, which draws it densely)
    q, k, v = _qkv_views(gen, MICRO, SEQ)
    for rate in (0.0, 0.1):
        seed = 1234 if rate else None
        o, lse = flash_fwd(q, k, v, True, scale, None, rate, seed)
        ro, rlse = flash_fwd_reference(q, k, v, True, scale, None, rate, seed)
        torch.cuda.synchronize()
        tag = f"flash_fwd causal ({MICRO},{HEADS},{SEQ},{HEAD_DIM}) " \
              f"dropout={rate}"
        err = check_close(tag, o, ro, BF16_ATOL, BF16_RTOL)
        check_close(tag + " lse", lse, rlse, 1e-4, 1e-5)
        n = numbers(
            err, time_ms(lambda: flash_fwd(q, k, v, True, scale, None, rate,
                                           seed)),
            time_ms(lambda: flash_fwd_reference(q, k, v, True, scale, None,
                                                rate, seed)),
            time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)),
            _flash_bound(MICRO, SEQ, True, 2, 4),
            call_ms(lambda: flash_fwd(q, k, v, True, scale, None, rate,
                                      seed)))
        log_numbers(f"flash_fwd train dropout={rate}", n,
                    "sdpa (no dropout)")
        if not rate:
            # one input set (q, k, v: 48 MB) replayed stays in the 50 MB
            # L2; four sets taken in turn are read from device memory
            sets = [_qkv_views(gen, MICRO, SEQ) for _ in range(4)]
            n["ms_l2_cold"] = time_ms(
                [lambda t=t: flash_fwd(*t, True, scale) for t in sets] * 5)
            n["library_ms_l2_cold"] = time_ms(
                [lambda t=t: F.scaled_dot_product_attention(
                    *t, is_causal=True, scale=scale) for t in sets] * 5)
            log(f"  flash_fwd train, four inputs in turn (read from device "
                f"memory): {n['ms_l2_cold']:.5f} ms, sdpa "
                f"{n['library_ms_l2_cold']:.5f} ms")
            del sets
        by_len[f"train_dropout_{rate}"] = n
    # the BERT training shape: bidirectional (no mask)
    q, k, v = _qkv_views(gen, BERT_MICRO, BERT_SEQ)
    o, lse = flash_fwd(q, k, v, False, scale)
    ro, rlse = flash_fwd_reference(q, k, v, False, scale)
    torch.cuda.synchronize()
    tag = f"flash_fwd non-causal ({BERT_MICRO},{HEADS},{BERT_SEQ},{HEAD_DIM})"
    err = check_close(tag, o, ro, BF16_ATOL, BF16_RTOL)
    check_close(tag + " lse", lse, rlse, 1e-4, 1e-5)
    n = numbers(
        err, time_ms(lambda: flash_fwd(q, k, v, False, scale)),
        time_ms(lambda: flash_fwd_reference(q, k, v, False, scale)),
        time_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                       scale=scale)),
        _flash_bound(BERT_MICRO, BERT_SEQ, False, 2, 4),
        call_ms(lambda: flash_fwd(q, k, v, False, scale)))
    log_numbers("flash_fwd bert non-causal", n, "sdpa")
    by_len["bert_noncausal"] = n
    for tag, hd, s, causal, rate, seed, lens, dt, tol in FLASH_EDGE_CASES:
        q, k, v, _, kl = _edge_inputs(gen, hd, s, lens, dt)
        o, lse = flash_fwd(q, k, v, causal, hd ** -0.5, kl, rate, seed)
        ro, rlse = flash_fwd_reference(q, k, v, causal, hd ** -0.5, kl, rate,
                                       seed)
        torch.cuda.synchronize()
        name = f"flash_fwd (2,4,{s},{hd}) {tag}"
        check_close(name, o, ro, tol, tol)
        check_close(name + " lse", lse, rlse, 1e-4, 1e-5)
    q, k, v = _misaligned_q(gen)
    _check_refuses_misaligned("flash_fwd",
                              lambda: flash_fwd(q, k, v, True, scale))
    return by_len


def _flash_bwd_library_ms(sets, causal, scale):
    """SDPA computes dq, dk and dv in one backward: its time is the graph
    of forward + backward less the forward alone, over the ``(q, k, v,
    do)`` input sets taken in turn."""
    leaves = [[t.detach().clone().requires_grad_() for t in qkv]
              for *qkv, _ in sets]

    def sdpa_fwd(ql, kl, vl):
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal,
                                              scale=scale)

    def sdpa_fwd_bwd(ls, do):
        return torch.autograd.grad(sdpa_fwd(*ls), ls, do)

    rounds = -(-20 // len(sets))
    return (time_ms([lambda ls=ls, st=st: sdpa_fwd_bwd(ls, st[3])
                     for ls, st in zip(leaves, sets)] * rounds)
            - time_ms([lambda ls=ls: sdpa_fwd(*ls) for ls in leaves]
                      * rounds))


def kernel_flash_bwd(gen):
    """#4 / #5 at (8, 16, 1024, 64) bf16: causal with and without dropout,
    and kv_seqlens (non-causal); then at BERT's (16, 16, 512, 64),
    non-causal."""
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_dkv, flash_attention_dkv_reference, flash_attention_dq,
        flash_attention_dq_reference, flash_fwd)
    scale = HEAD_DIM ** -0.5
    q, k, v = _qkv_views(gen, MICRO, SEQ)
    # dO as autograd hands it back: a (b, h, s, d) view of (b, s, h*d)
    do = torch.randn(MICRO, SEQ, HEADS, HEAD_DIM, generator=gen).to(
        "cuda", torch.bfloat16).transpose(1, 2)
    lens = torch.tensor([1024, 700, 333, 1, 1024, 512, 64, 999],
                        dtype=torch.int32, device="cuda")
    out = {}
    for tag, causal, rate, seed, kl in (
            ("causal", True, 0.0, None, None),
            ("causal dropout=0.1", True, 0.1, 99, None),
            ("kv_seqlens", False, 0.0, None, lens)):
        o, lse = flash_fwd(q, k, v, causal, scale, kl, rate, seed)
        delta = (do.float() * o.float()).sum(-1).reshape(MICRO * HEADS, SEQ)
        args = (q, k, v, do, lse, delta, causal, scale, kl, rate, seed)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        rdq = flash_attention_dq_reference(*args)
        rdk, rdv = flash_attention_dkv_reference(*args)
        torch.cuda.synchronize()
        name = f"({MICRO},{HEADS},{SEQ},{HEAD_DIM}) {tag}"
        err_q = check_close(f"flash_attention_dq {name}", dq, rdq,
                            BF16_ATOL, BF16_RTOL)
        err_k = check_close(f"flash_attention_dkv {name} dk", dk, rdk,
                            BF16_ATOL, BF16_RTOL)
        err_v = check_close(f"flash_attention_dkv {name} dv", dv, rdv,
                            BF16_ATOL, BF16_RTOL)
        if tag != "causal":
            continue
        # no atomics: a second call gives the same bits
        dk2, dv2 = flash_attention_dkv(*args)
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError("flash_attention_dkv: two calls on the same "
                                 "inputs differ")
        log(f"  flash_attention_dkv {name}: two calls bitwise equal ok")
        if not torch.equal(dq, flash_attention_dq(*args)):
            raise AssertionError("flash_attention_dq: two calls on the same "
                                 "inputs differ")
        log(f"  flash_attention_dq {name}: two calls bitwise equal ok")
        lib_bwd = _flash_bwd_library_ms([(q, k, v, do)], True, scale)
        out["dq"] = numbers(
            err_q, time_ms(lambda: flash_attention_dq(*args)),
            time_ms(lambda: flash_attention_dq_reference(*args)), lib_bwd,
            _flash_bound(MICRO, SEQ, True, 3, 5),
            call_ms(lambda: flash_attention_dq(*args)))
        out["dkv"] = numbers(
            max(err_k, err_v), time_ms(lambda: flash_attention_dkv(*args)),
            time_ms(lambda: flash_attention_dkv_reference(*args)), lib_bwd,
            _flash_bound(MICRO, SEQ, True, 4, 6),
            call_ms(lambda: flash_attention_dkv(*args)))
        log_numbers("flash_attention_dq causal", out["dq"],
                    "sdpa backward (dq+dk+dv)")
        log_numbers("flash_attention_dkv causal", out["dkv"],
                    "sdpa backward (dq+dk+dv)")
        # one input set (q, k, v, dO: 64 MB) replayed sits largely in the
        # 50 MB L2; three sets taken in turn are read from device memory
        sets = []
        for _ in range(3):
            qi, ki, vi = _qkv_views(gen, MICRO, SEQ)
            doi = torch.randn(MICRO, SEQ, HEADS, HEAD_DIM, generator=gen).to(
                "cuda", torch.bfloat16).transpose(1, 2)
            oi, lsei = flash_fwd(qi, ki, vi, True, scale)
            deltai = (doi.float() * oi.float()).sum(-1).reshape(MICRO * HEADS,
                                                                SEQ)
            sets.append((qi, ki, vi, doi, lsei, deltai, True, scale))
            del oi
        lib_cold = _flash_bwd_library_ms([a[:4] for a in sets], True, scale)
        for key, fn in (("dq", flash_attention_dq),
                        ("dkv", flash_attention_dkv)):
            out[key]["ms_l2_cold"] = time_ms(
                [lambda a=a, fn=fn: fn(*a) for a in sets] * 7)
            out[key]["library_ms_l2_cold"] = lib_cold
            log(f"  flash_attention_{key} causal, three inputs in turn (read "
                f"from device memory): {out[key]['ms_l2_cold']:.5f} ms, sdpa "
                f"backward {lib_cold:.5f} ms")
        del sets
    # BERT: (16, 16, 512, 64), no mask
    q, k, v = _qkv_views(gen, BERT_MICRO, BERT_SEQ)
    do = torch.randn(BERT_MICRO, BERT_SEQ, HEADS, HEAD_DIM, generator=gen).to(
        "cuda", torch.bfloat16).transpose(1, 2)
    o, lse = flash_fwd(q, k, v, False, scale)
    delta = (do.float() * o.float()).sum(-1).reshape(BERT_MICRO * HEADS,
                                                     BERT_SEQ)
    args = (q, k, v, do, lse, delta, False, scale)
    dq = flash_attention_dq(*args)
    dk, dv = flash_attention_dkv(*args)
    rdq = flash_attention_dq_reference(*args)
    rdk, rdv = flash_attention_dkv_reference(*args)
    torch.cuda.synchronize()
    name = f"({BERT_MICRO},{HEADS},{BERT_SEQ},{HEAD_DIM}) non-causal"
    err_q = check_close(f"flash_attention_dq {name}", dq, rdq, BF16_ATOL,
                        BF16_RTOL)
    err_k = check_close(f"flash_attention_dkv {name} dk", dk, rdk, BF16_ATOL,
                        BF16_RTOL)
    err_v = check_close(f"flash_attention_dkv {name} dv", dv, rdv, BF16_ATOL,
                        BF16_RTOL)
    lib_bwd = _flash_bwd_library_ms([(q, k, v, do)], False, scale)
    out["dq_bert"] = numbers(
        err_q, time_ms(lambda: flash_attention_dq(*args)),
        time_ms(lambda: flash_attention_dq_reference(*args)), lib_bwd,
        _flash_bound(BERT_MICRO, BERT_SEQ, False, 3, 5),
        call_ms(lambda: flash_attention_dq(*args)))
    out["dkv_bert"] = numbers(
        max(err_k, err_v), time_ms(lambda: flash_attention_dkv(*args)),
        time_ms(lambda: flash_attention_dkv_reference(*args)), lib_bwd,
        _flash_bound(BERT_MICRO, BERT_SEQ, False, 4, 6),
        call_ms(lambda: flash_attention_dkv(*args)))
    log_numbers("flash_attention_dq bert non-causal", out["dq_bert"],
                "sdpa backward (dq+dk+dv)")
    log_numbers("flash_attention_dkv bert non-causal", out["dkv_bert"],
                "sdpa backward (dq+dk+dv)")
    for tag, hd, s, causal, rate, seed, lens, dt, tol in FLASH_EDGE_CASES:
        q, k, v, do, kl = _edge_inputs(gen, hd, s, lens, dt)
        o, lse = flash_fwd(q, k, v, causal, hd ** -0.5, kl, rate, seed)
        delta = (do.float() * o.float()).sum(-1).reshape(2 * 4, s)
        args = (q, k, v, do, lse, delta, causal, hd ** -0.5, kl, rate, seed)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        rdq = flash_attention_dq_reference(*args)
        rdk, rdv = flash_attention_dkv_reference(*args)
        torch.cuda.synchronize()
        name = f"(2,4,{s},{hd}) {tag}"
        check_close(f"flash_attention_dq {name}", dq, rdq, tol, tol)
        check_close(f"flash_attention_dkv {name} dk", dk, rdk, tol, tol)
        check_close(f"flash_attention_dkv {name} dv", dv, rdv, tol, tol)
        dk2, dv2 = flash_attention_dkv(*args)
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"flash_attention_dkv {name}: two calls on "
                                 "the same inputs differ")
        if not torch.equal(dq, flash_attention_dq(*args)):
            raise AssertionError(f"flash_attention_dq {name}: two calls on "
                                 "the same inputs differ")
    q, k, v = _misaligned_q(gen)
    o, lse = flash_fwd(q.contiguous(), k, v, True, 32 ** -0.5)
    delta = torch.zeros_like(lse)
    for kernel, fn in (("flash_attention_dq", flash_attention_dq),
                       ("flash_attention_dkv", flash_attention_dkv)):
        _check_refuses_misaligned(kernel, lambda fn=fn: fn(
            q, k, v, o, lse, delta, True, 32 ** -0.5))
    return out


# the local heads of GPT-350M's 16 at tensor-parallel sizes 2 and 4
TP_LOCAL_HEADS = (8, 4)


def kernel_flash_shards(gen):
    """#3-#5 at the tensor-parallel shard shapes of GPT-350M's training
    step, (8, 8, 1024, 64) and (8, 4, 1024, 64) causal bf16 (phase 15's
    local heads): each against its plain version at the phase's bf16
    tolerance, timed beside SDPA, with its bound."""
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_dkv, flash_attention_dkv_reference, flash_attention_dq,
        flash_attention_dq_reference, flash_attention_reference, flash_fwd)
    scale = HEAD_DIM ** -0.5
    out = {}
    for heads in TP_LOCAL_HEADS:
        q, k, v = _qkv_views(gen, MICRO, SEQ, heads)
        do = torch.randn(MICRO, SEQ, heads, HEAD_DIM, generator=gen).to(
            "cuda", torch.bfloat16).transpose(1, 2)
        o, lse = flash_fwd(q, k, v, True, scale)
        ro = flash_attention_reference(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(-1).reshape(MICRO * heads, SEQ)
        args = (q, k, v, do, lse, delta, True, scale)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        rdq = flash_attention_dq_reference(*args)
        rdk, rdv = flash_attention_dkv_reference(*args)
        torch.cuda.synchronize()
        name = f"({MICRO},{heads},{SEQ},{HEAD_DIM}) causal"
        err_o = check_close(f"flash_fwd {name}", o, ro, BF16_ATOL, BF16_RTOL)
        err_q = check_close(f"flash_attention_dq {name}", dq, rdq, BF16_ATOL,
                            BF16_RTOL)
        err_kv = max(check_close(f"flash_attention_dkv {name} dk", dk, rdk,
                                 BF16_ATOL, BF16_RTOL),
                     check_close(f"flash_attention_dkv {name} dv", dv, rdv,
                                 BF16_ATOL, BF16_RTOL))
        lib_bwd = _flash_bwd_library_ms([(q, k, v, do)], True, scale)
        out[f"fwd_h{heads}"] = numbers(
            err_o, time_ms(lambda: flash_fwd(q, k, v, True, scale)),
            time_ms(lambda: flash_attention_reference(q, k, v, True, scale)),
            time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=scale)),
            _flash_bound(MICRO, SEQ, True, 2, 4, heads=heads),
            call_ms(lambda: flash_fwd(q, k, v, True, scale)))
        out[f"dq_h{heads}"] = numbers(
            err_q, time_ms(lambda: flash_attention_dq(*args)),
            time_ms(lambda: flash_attention_dq_reference(*args)), lib_bwd,
            _flash_bound(MICRO, SEQ, True, 3, 5, heads=heads),
            call_ms(lambda: flash_attention_dq(*args)))
        out[f"dkv_h{heads}"] = numbers(
            err_kv, time_ms(lambda: flash_attention_dkv(*args)),
            time_ms(lambda: flash_attention_dkv_reference(*args)), lib_bwd,
            _flash_bound(MICRO, SEQ, True, 4, 6, heads=heads),
            call_ms(lambda: flash_attention_dkv(*args)))
        log_numbers(f"flash_fwd tp shard {name}", out[f"fwd_h{heads}"],
                    "sdpa")
        log_numbers(f"flash_attention_dq tp shard {name}",
                    out[f"dq_h{heads}"], "sdpa backward (dq+dk+dv)")
        log_numbers(f"flash_attention_dkv tp shard {name}",
                    out[f"dkv_h{heads}"], "sdpa backward (dq+dk+dv)")
        del q, k, v, do, o, ro, lse, delta, args, dq, dk, dv, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return out


def kernel_decode(gen):
    """#6 against its plain version at the serving shape (8 slots, 16 heads
    of 64, a bf16 ring of 1024 positions x 24 layers read through its
    strided per-layer views, ragged lengths; timed over the 24 layers),
    bitwise on a repeat, then at the chunk edges in every dtype and head
    dim."""
    from apex_tpu_torch.ops.flash_attention import (
        DECODE_HEAD_DIMS, flash_attention_decode,
        flash_attention_decode_reference)
    scale = HEAD_DIM ** -0.5
    layers = GPT350M["num_layers"]
    cache = torch.randn(SLOTS, layers, 2, MAX_SEQ, HEADS, HEAD_DIM,
                        generator=gen, dtype=torch.float32).to(
        "cuda", torch.bfloat16)
    # ragged lengths: one token, mid-block, half, full cache, ...
    lens = torch.tensor([1, 97, 512, 1024, 300, 640, 37, 800],
                        dtype=torch.int32, device="cuda")
    q = torch.randn(SLOTS, HEADS, HEAD_DIM, generator=gen).to(
        "cuda", torch.bfloat16)
    k, v = cache[:, 3, 0], cache[:, 3, 1]        # strided views of the ring
    assert not k.is_contiguous()
    o = flash_attention_decode(q, k, v, lens, scale)
    ref = flash_attention_decode_reference(q, k, v, lens, scale)
    torch.cuda.synchronize()
    err = check_close("flash_attention_decode ragged lens, strided cache",
                      o, ref, BF16_ATOL, BF16_RTOL)
    views = [(cache[:, li, 0], cache[:, li, 1]) for li in range(layers)]
    mask = (torch.arange(MAX_SEQ, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    total = int(lens.sum())
    n_bytes = 2 * total * HEADS * HEAD_DIM * 2 + 2 * q.numel() * 2 \
        + lens.numel() * 4
    n = numbers(
        err,
        time_ms([lambda k=k, v=v: flash_attention_decode(q, k, v, lens,
                                                         scale)
                 for k, v in views]),
        time_ms([lambda k=k, v=v: flash_attention_decode_reference(
            q, k, v, lens, scale) for k, v in views]),
        time_ms([lambda k=k, v=v: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=scale) for k, v in views]),
        bound_ms(n_bytes, 4 * HEAD_DIM * HEADS * total, PEAK_BF16_FLOPS),
        call_ms(lambda: flash_attention_decode(q, k, v, lens, scale)))
    log_numbers("flash_attention_decode", n, "sdpa + mask")
    log_rate("flash_attention_decode", n, n_bytes)
    if not torch.equal(o, flash_attention_decode(q, k, v, lens, scale)):
        raise AssertionError("flash_attention_decode: two calls on the same "
                             "inputs differ")
    log("  flash_attention_decode: two calls bitwise equal ok")
    del cache, views
    for dt in DECODE_EDGE_TOL:
        for hd in DECODE_HEAD_DIMS:
            _decode_edge_check(gen, dt, hd)
    return n


# the split-K decode kernels cut a row at 0, DECODE_SPLIT, ...: a row with
# no key, lengths on each side of the first chunk edge, the whole cache and
# a length past it, over a cache of 3 chunks
DECODE_EDGE_S = 3 * 128
DECODE_EDGE_TOL = {torch.bfloat16: BF16_ATOL, torch.float16: F16_ATOL,
                   torch.float32: F32_ATOL}


def decode_edge_lens(s):
    from apex_tpu_torch.ops.flash_attention import DECODE_SPLIT
    k = DECODE_SPLIT
    return [0, 1, k - 1, k, k + 1, s, s + 100]


def log_rate(name, n, n_bytes):
    """GB/s and the share of the bound beside a decode kernel's time."""
    n["gb_per_s"] = n_bytes / (n["ms"] * 1e-3) / 1e9
    n["bound_share"] = n["bound_ms"] / n["ms"]
    log(f"  {name}: {n['gb_per_s']:.1f} GB/s, {n['bound_share']:.1%} of the "
        "bound")


def _decode_edge_check(gen, dtype, hd):
    """#6 on a strided ring at ``decode_edge_lens``: against its plain
    version, bitwise on a repeat, the row of length 0 exactly 0."""
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_decode, flash_attention_decode_reference)
    lens_l = decode_edge_lens(DECODE_EDGE_S)
    b, h = len(lens_l), 2
    ring = torch.randn(b, 2, 2, DECODE_EDGE_S, h, hd, generator=gen).to(
        "cuda", dtype)
    q = torch.randn(b, h, hd, generator=gen).to("cuda", dtype)
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    k, v = ring[:, 1, 0], ring[:, 1, 1]
    o = flash_attention_decode(q, k, v, lens)
    ref = flash_attention_decode_reference(q, k, v, lens)
    torch.cuda.synchronize()
    tol = DECODE_EDGE_TOL[dtype]
    check_close(f"flash_attention_decode {str(dtype)[6:]} hd {hd} lens "
                f"{lens_l}", o, ref, tol, tol)
    if not torch.equal(o, flash_attention_decode(q, k, v, lens)):
        raise AssertionError("flash_attention_decode: a repeat differs")
    if o[0].any():
        raise AssertionError("flash_attention_decode: a row of length 0 is "
                             "not 0")

PAGED_BS = 16                  # the paged engine's block size on the path
PAGED_BLOCKS = MAX_SEQ // PAGED_BS
PAGED_POOL = 1 + SLOTS * PAGED_BLOCKS   # the engine's default pool


def paged_tables(lens, rng):
    """Block tables ``(slots, max_blocks)`` for these lengths over a pool
    of ``PAGED_POOL`` blocks, shuffled: each row's blocks are drawn without
    replacement, rows 2 and 3 share their first 4 blocks (a prefix the
    trie would share), entries past a row's blocks are the garbage block
    0, and a row of length 1 is an inactive slot (all zero)."""
    free = list(rng.permutation(np.arange(1, PAGED_POOL)))
    tables = np.zeros((len(lens), PAGED_BLOCKS), np.int32)
    for i, n in enumerate(lens):
        if n <= 1:
            continue
        need = -(-int(n) // PAGED_BS)
        tables[i, :need] = [free.pop() for _ in range(need)]
    tables[3, :4] = tables[2, :4]
    return tables


def kernel_decode_paged(gen):
    """#7 against its plain version (gather + the decode reference) and
    against #6 on the gathered cache, bit for bit (one body, one order of
    arithmetic), at the paged engine's shapes: 8 slots, 16 heads of 64,
    a bf16 pool of 513 blocks of 16 positions x 24 layers, read through
    its strided per-layer views, with ragged lengths, a shuffled table
    whose rows share blocks, and an inactive slot (all-zero table, length
    1).  Timed over the 24 layers' views; bitwise on a repeat; then at the
    chunk edges, at block sizes 8 and 16, in every dtype and head dim, each
    case also bitwise #6 on the gathered cache."""
    from apex_tpu_torch.ops.flash_attention import (
        DECODE_HEAD_DIMS, flash_attention_decode, flash_attention_decode_paged,
        flash_attention_decode_paged_reference, gather_paged_kv)
    scale = HEAD_DIM ** -0.5
    layers = GPT350M["num_layers"]
    pool = torch.randn(PAGED_POOL, layers, 2, PAGED_BS, HEADS, HEAD_DIM,
                       generator=gen, dtype=torch.float32).to(
        "cuda", torch.bfloat16)
    lens_np = np.array([1, 97, 512, 1024, 300, 640, 37, 800], np.int32)
    tables = torch.from_numpy(paged_tables(
        lens_np, np.random.RandomState(7))).to("cuda")
    lens = torch.from_numpy(lens_np).to("cuda")
    q = torch.randn(SLOTS, HEADS, HEAD_DIM, generator=gen).to(
        "cuda", torch.bfloat16)
    k, v = pool[:, 3, 0], pool[:, 3, 1]          # strided views of the pool
    assert not k.is_contiguous()
    o = flash_attention_decode_paged(q, k, v, tables, lens, scale)
    ref = flash_attention_decode_paged_reference(q, k, v, tables, lens,
                                                 scale)
    kg, vg = gather_paged_kv(k, tables), gather_paged_kv(v, tables)
    o6 = flash_attention_decode(q, kg, vg, lens, scale)
    torch.cuda.synchronize()
    err = check_close("flash_attention_decode_paged ragged lens, shared "
                      "blocks, strided pool", o, ref, BF16_ATOL, BF16_RTOL)
    same = torch.equal(o, o6)
    log(f"  flash_attention_decode_paged against #6 on the gathered cache: "
        f"{'bitwise equal' if same else 'DIFFERENT'} (max |d| "
        f"{max_err(o, o6):.3e})")
    if not same:
        raise AssertionError("#7 and #6 disagree on the same cache")
    views = [(pool[:, li, 0], pool[:, li, 1]) for li in range(layers)]
    mask = (torch.arange(MAX_SEQ, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    total = int(lens.sum())
    n_bytes = 2 * total * HEADS * HEAD_DIM * 2 + 2 * q.numel() * 2 \
        + tables.numel() * 4 + lens.numel() * 4

    def library(k, v):
        kg, vg = gather_paged_kv(k, tables), gather_paged_kv(v, tables)
        return F.scaled_dot_product_attention(
            q[:, :, None], kg.transpose(1, 2), vg.transpose(1, 2),
            attn_mask=mask, scale=scale)
    n = numbers(
        err,
        time_ms([lambda k=k, v=v: flash_attention_decode_paged(
            q, k, v, tables, lens, scale) for k, v in views]),
        time_ms([lambda k=k, v=v: flash_attention_decode_paged_reference(
            q, k, v, tables, lens, scale) for k, v in views]),
        time_ms([lambda k=k, v=v: library(k, v) for k, v in views]),
        bound_ms(n_bytes, 4 * HEAD_DIM * HEADS * total, PEAK_BF16_FLOPS),
        call_ms(lambda: flash_attention_decode_paged(q, k, v, tables, lens,
                                                     scale)))
    log_numbers("flash_attention_decode_paged", n,
                "pool[tables] gather + sdpa + mask")
    log_rate("flash_attention_decode_paged", n, n_bytes)
    if not torch.equal(o, flash_attention_decode_paged(q, k, v, tables, lens,
                                                       scale)):
        raise AssertionError("flash_attention_decode_paged: two calls on the "
                             "same inputs differ")
    log("  flash_attention_decode_paged: two calls bitwise equal ok")
    del pool, views, kg, vg
    for bs in (8, 16):
        for dt in DECODE_EDGE_TOL:
            for hd in DECODE_HEAD_DIMS:
                _decode_paged_edge_check(gen, dt, hd, bs)
    return n


def _decode_paged_edge_check(gen, dtype, hd, bs):
    """#7 at ``decode_edge_lens`` through a shuffled table of blocks of
    ``bs``: against its plain version, bitwise #6 on the gathered cache,
    bitwise on a repeat."""
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_decode, flash_attention_decode_paged,
        flash_attention_decode_paged_reference, gather_paged_kv)
    nb = DECODE_EDGE_S // bs
    lens_l = decode_edge_lens(DECODE_EDGE_S)
    b, h = len(lens_l), 2
    need = [min(-(-n // bs), nb) for n in lens_l]
    pool = torch.randn(1 + sum(need), 2, 2, bs, h, hd, generator=gen).to(
        "cuda", dtype)
    ids = list(np.random.RandomState(bs + hd).permutation(
        np.arange(1, 1 + sum(need))))
    tables_np = np.zeros((b, nb), np.int32)
    for i, n in enumerate(need):
        tables_np[i, :n] = [ids.pop() for _ in range(n)]
    tables = torch.from_numpy(tables_np).to("cuda")
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    q = torch.randn(b, h, hd, generator=gen).to("cuda", dtype)
    k, v = pool[:, 1, 0], pool[:, 1, 1]
    o = flash_attention_decode_paged(q, k, v, tables, lens)
    ref = flash_attention_decode_paged_reference(q, k, v, tables, lens)
    o6 = flash_attention_decode(q, gather_paged_kv(k, tables),
                                gather_paged_kv(v, tables), lens)
    torch.cuda.synchronize()
    tol = DECODE_EDGE_TOL[dtype]
    name = f"flash_attention_decode_paged bs {bs} {str(dtype)[6:]} hd {hd}"
    check_close(f"{name} lens {lens_l}", o, ref, tol, tol)
    if not torch.equal(o, o6):
        raise AssertionError(f"{name}: #7 and #6 disagree on the same cache "
                             f"(max |d| {max_err(o, o6):.3e})")
    if not torch.equal(o, flash_attention_decode_paged(q, k, v, tables,
                                                       lens)):
        raise AssertionError(f"{name}: a repeat differs")


def _qgemm_bounds(shapes, f32_peak=False):
    """Bound of a set of dequant-GEMM calls ``(m, n, k, x dtype)``: every
    int8 weight, scale, x and f32 y moved once, against the operations at
    the bf16 tensor cores' peak: f32 x as the three bf16 passes its kernel
    runs (``f32_peak``: f32 x's 2 m n k at the f32 peak instead, the
    figure kept beside it)."""
    n_bytes = sum(n * k + 4 * n + m * k * (2 if dt == torch.bfloat16 else 4)
                  + 4 * m * n for m, n, k, dt in shapes)
    t_ops = 0.0
    for m, n, k, dt in shapes:
        if dt == torch.bfloat16:
            t_ops += 2 * m * n * k / PEAK_BF16_FLOPS
        elif f32_peak:
            t_ops += 2 * m * n * k / PEAK_F32_FLOPS
        else:
            t_ops += 3 * 2 * m * n * k / PEAK_BF16_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gpt350m_gemm_shapes():
    """``(n, k)`` of the four int8 GEMMs of a GPT-350M layer, in order:
    qkv, proj, fc1, fc2; and the tied head's."""
    h, f = HIDDEN, GPT350M["ffn_hidden_size"]
    return [(3 * h, h), (h, h), (f, h), (h, f)], (GPT350M["vocab_size"], h)


# #14 against its plain version, entry by entry: the plain version rounds
# its product to x's type (bf16: 2**-8 relative, f16: 2**-11) and the
# kernel returns the f32 sum; in f32 (three bf16 parts of x, each product
# exact) only f32 rounding and the order of the sum over k differ
QGEMM_TOL = {torch.bfloat16: BF16_ATOL, torch.float16: 2e-3,
             torch.float32: 1e-4}
# token counts at every edge of the TMA kernel's BN (8 ... 128) and k split
QGEMM_EDGE_M = (1, 7, 8, 9, 16, 17, 63, 64, 65, 255, 256, 257, 512)
QGEMM_EDGE_N = 1030            # not a multiple of 128 (nor of 4)
# f32 x spread over 1e-3 .. 1e3: the kernel's f32 sum of exact bf16
# products may be at most this many times further from the f64 product
# than the plain version's f32 product (a two-part split of x, whose
# distance is logged beside, is 4.5-15x further at the checked shapes)
QGEMM_SPLIT_VS_PLAIN = 2.0


def _plan_tag(x, w8):
    from apex_tpu_torch.ops.quant_gemm import qgemm_plan_for
    p = qgemm_plan_for(x.reshape(-1, x.shape[-1]), w8)
    return (p.kernel if p.kernel != "qgemm_tma"
            else f"qgemm_tma bn {p.bn} ks {p.ks} parts {p.parts}")


def _qgemm_check(name, x, w8, scale):
    """#14 on (x, w8, scale) against its plain version within QGEMM_TOL,
    and bitwise on a repeat; returns the max abs error.  The plain version
    runs as the models run it (``GPTModel`` turns these flags off): no
    TF32, and bf16 products reduced in f32 as the JAX dots are (with
    torch's default bf16 reduction in cuBLAS's split-K partial sums an
    entry of |ref| < 1.8 at 65 x 1030 x 4096 lay 0.055 off the f32 sum of
    the same operands, where the kernel lay 1e-5).  bf16 x is also held
    within 1e-4 of the f32 product of the same bf16 operands, the
    kernel's arithmetic less its order of summation."""
    from apex_tpu_torch.ops.quant_gemm import (
        dequantize_weight, quant_gemm, quant_gemm_reference)
    got = quant_gemm(x, w8, scale)
    again = quant_gemm(x, w8, scale)
    flags = _matmul_flags()
    _set_matmul_flags((False, False, False))
    try:
        ref = quant_gemm_reference(x, w8, scale)
        f32 = (x.float() @ dequantize_weight(w8, scale).to(x.dtype).float()
               .t()) if x.dtype == torch.bfloat16 else None
    finally:
        _set_matmul_flags(flags)
    torch.cuda.synchronize()
    tol = QGEMM_TOL[x.dtype]
    tag = f"{name} [{_plan_tag(x, w8)}]"
    err = check_close(tag, got, ref, tol, tol)
    if f32 is not None:
        check_close(f"{tag} against the f32 product of its bf16 operands",
                    got, f32, F32_ATOL, F32_RTOL)
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: a repeat differs")
    return err


def _qgemm_split_checks(gen_cuda, weight):
    """f32 x through the three-part split: entries spread over 1e-3 ..
    1e3 (both signs) against the plain version within QGEMM_TOL and, next
    to the f64 product, within QGEMM_SPLIT_VS_PLAIN of the plain
    version's own error (a two-part split, emulated in f64, beside);
    then inf and nan entries, whose rows must match the plain version's
    inf / nan pattern.  The weights' scales are a hundredth of the path's, so
    |y| stays near 40: at the path's scales (|y| ~ 1e3 on such x) the
    plain version's own f32 rounding exceeds 1e-4."""
    from apex_tpu_torch.ops.quant_gemm import (
        quant_gemm, quant_gemm_reference, split_bf16x3_reference)
    out = {}
    for m, k in ((8, 1024), (64, 4096), (512, 1024)):
        n = QGEMM_EDGE_N
        w8, scale = weight(n, k)
        scale = scale * 1e-2
        mag = 10.0 ** (torch.rand(m, k, generator=gen_cuda, device="cuda")
                       * 6 - 3)
        x = torch.where(torch.rand(m, k, generator=gen_cuda, device="cuda")
                        < 0.5, -mag, mag)
        name = f"quant_gemm f32 spread 1e-3..1e3 {m}x{n}x{k}"
        err = _qgemm_check(name, x, w8, scale)
        wq = w8.double() * scale.double()[:, None]
        exact = x.double() @ wq.t()
        got = quant_gemm(x, w8, scale).double()
        plain = quant_gemm_reference(x, w8, scale).double()
        parts = split_bf16x3_reference(x).double()
        two = (parts[0] + parts[1]) @ wq.t()
        e_k, e_p, e_2 = (float((a - exact).abs().max())
                         for a in (got, plain, two))
        ok = e_k <= QGEMM_SPLIT_VS_PLAIN * e_p
        log(f"  {name} against the f64 product: kernel {e_k:.3e}, plain "
            f"version {e_p:.3e}, two-part split {e_2:.3e} (max |y| "
            f"{float(exact.abs().max()):.1f}; kernel <= "
            f"{QGEMM_SPLIT_VS_PLAIN} x plain) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: less accurate than its plain "
                                 f"version")
        out[f"{m}x{n}x{k}"] = dict(max_abs_err=err, vs_f64=e_k,
                                   plain_vs_f64=e_p, two_part_vs_f64=e_2)
        del wq, exact, got, plain, parts, two
    # one inf and one nan entry (rows 1 and 5 of 8; -inf in row 6 of 64)
    for m, bad in ((8, ((1, 3, float("inf")), (5, 700, float("nan")))),
                   (64, ((6, 0, float("-inf")),))):
        k = 1024
        w8, scale = weight(QGEMM_EDGE_N, k)
        x = torch.randn(m, k, generator=gen_cuda, device="cuda")
        for r, col, v in bad:
            x[r, col] = v
        got = quant_gemm(x, w8, scale)
        ref = quant_gemm_reference(x, w8, scale)
        torch.cuda.synchronize()
        same = (torch.equal(torch.isnan(got), torch.isnan(ref))
                and torch.equal(torch.isposinf(got), torch.isposinf(ref))
                and torch.equal(torch.isneginf(got), torch.isneginf(ref)))
        fin = torch.isfinite(ref)
        err = max_err(got[fin], ref[fin])
        ok = same and bool(torch.allclose(got[fin], ref[fin], atol=1e-4,
                                          rtol=1e-4))
        log(f"  quant_gemm f32 {m}x{QGEMM_EDGE_N}x{k} with {len(bad)} "
            f"non-finite x: nan {int(torch.isnan(ref).sum())}, inf "
            f"{int(torch.isinf(ref).sum())} entries as the plain version's "
            f"{'(same)' if same else '(DIFFERENT)'}, finite max_abs_err="
            f"{err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("quant_gemm disagrees with its plain "
                                 "version on non-finite x")
    return out


def kernel_quant_gemm(gen_cuda):
    """#14 against its plain version (dequantize to f32, cast to x's type,
    ``x @ w.T``, f32), entry by entry within ``QGEMM_TOL`` and bitwise on a
    repeat, with the kernel each call's plan names: at the int8 path's
    shapes (a whole decode step's 97 calls: 8 rows; 24 layers of qkv /
    proj / fc1 / fc2 in bf16, each layer its own weights, and the f32 tied
    head, 353.6 MB of int8; the prefill's shapes at 512 rows), at every
    token count of ``QGEMM_EDGE_M`` with k 1024 and 4096 and n 1030 in
    bf16 and f32, f32 x spread over 1e-3 .. 1e3 and with non-finite
    entries (``_qgemm_split_checks``), and off the TMA grid (5 x 130 x
    200, 33 x 130 x 200, bf16 and f32; 17 x 64 x 48 f16; x rows off 16
    bytes).  The yardstick is ``F.linear`` on a weight dequantized in
    advance to x's type."""
    from apex_tpu_torch.ops.quant_gemm import (
        dequantize_weight, quant_gemm, quant_gemm_reference)
    bf, f32 = torch.bfloat16, torch.float32
    out = {}

    def weight(n, k):
        w8 = torch.randint(-127, 128, (n, k), generator=gen_cuda,
                           device="cuda", dtype=torch.int8)
        scale = torch.rand(n, generator=gen_cuda, device="cuda") * 1e-3 \
            + 1e-4
        return w8, scale

    def act(m, k, dt):
        return torch.randn(m, k, generator=gen_cuda, device="cuda").to(dt)

    for m, n, k in ((5, 130, 200), (33, 130, 200)):
        for dt in (bf, f32):
            _qgemm_check(f"quant_gemm off-grid {m}x{n}x{k} {dt}",
                         act(m, k, dt), *weight(n, k))
    _qgemm_check("quant_gemm off-grid 17x64x48 float16",
                 act(17, 48, torch.float16), *weight(64, 48))
    # x rows 8 bytes off the 16-byte grid (a column slice)
    _qgemm_check("quant_gemm x rows off 16 bytes 16x512x512 bf16",
                 act(16, 516, bf)[:, 4:], *weight(512, 512))
    for k in (1024, 4096):
        w = weight(QGEMM_EDGE_N, k)
        for dt in (bf, f32):
            for m in QGEMM_EDGE_M:
                _qgemm_check(f"quant_gemm edge {m}x{QGEMM_EDGE_N}x{k} {dt}",
                             act(m, k, dt), *w)
    out["split"] = _qgemm_split_checks(gen_cuda, weight)

    layer_shapes, head = gpt350m_gemm_shapes()
    layers = GPT350M["num_layers"]
    weights = [[weight(n, k) for n, k in layer_shapes]
               for _ in range(layers)]
    head_w = weight(*head)
    for tag, m in (("decode", SLOTS), ("prefill", 512)):
        xs = {k: act(m, k, bf) for _, k in layer_shapes}
        xh = act(m, head[1], f32)
        err = 0.0
        for (n, k), (w8, scale) in zip(layer_shapes, weights[0]):
            err = max(err, _qgemm_check(f"quant_gemm {tag} {m}x{n}x{k} bf16",
                                        xs[k], w8, scale))
        err = max(err, _qgemm_check(
            f"quant_gemm {tag} head {m}x{head[0]}x{head[1]} f32", xh,
            *head_w))
        calls = [(xs[k], w) for ws in weights
                 for (_, k), w in zip(layer_shapes, ws)] + [(xh, head_w)]
        shapes = [(m, w[0].shape[0], w[0].shape[1], x.dtype)
                  for x, w in calls]
        lib_ws = [(x, dequantize_weight(*w).to(x.dtype)) for x, w in calls]
        kern = [lambda x=x, w=w: quant_gemm(x, *w) for x, w in calls]
        plain = [lambda x=x, w=w: quant_gemm_reference(x, *w)
                 for x, w in calls]
        library = [lambda x=x, w=w: F.linear(x, w) for x, w in lib_ws]
        rounds = 5 if tag == "decode" else 3
        total = len(calls)
        n = numbers(err, time_ms(kern, rounds) * total,
                    time_ms(plain, rounds) * total,
                    time_ms(library, rounds) * total,
                    _qgemm_bounds(shapes), call_ms(kern[0]))
        n["bound_f32_peak_ms"] = _qgemm_bounds(shapes, f32_peak=True)[0]
        log_numbers(f"quant_gemm, one {tag} step's {total} calls "
                    f"({m} rows)", n, "F.linear on pre-dequantized weights")
        log(f"    bound with the f32 head at the f32 peak "
            f"{n['bound_f32_peak_ms']:.5f} ms")
        out[tag] = n
        # each shape alone (layer 0's weights; the head)
        for (nn, k), w in zip(layer_shapes + [head],
                              weights[0] + [head_w]):
            x = xh if (nn, k) == head else xs[k]
            wd = dequantize_weight(*w).to(x.dtype)
            one = numbers(err, time_ms(lambda: quant_gemm(x, *w), rounds),
                          time_ms(lambda: quant_gemm_reference(x, *w), 3),
                          time_ms(lambda: F.linear(x, wd), rounds),
                          _qgemm_bounds([(m, nn, k, x.dtype)]),
                          call_ms(lambda: quant_gemm(x, *w)))
            one["bound_f32_peak_ms"] = _qgemm_bounds(
                [(m, nn, k, x.dtype)], f32_peak=True)[0]
            ms = one["ms"]
            one["tflops"] = 2 * m * nn * k / (ms * 1e-3) / 1e12
            one["gb_s"] = (nn * k + 4 * nn + m * k * x.element_size()
                           + 4 * m * nn) / (ms * 1e-3) / 1e9
            log_numbers(f"quant_gemm {tag} {m}x{nn}x{k} {x.dtype} "
                        f"[{_plan_tag(x, w[0])}]", one, "F.linear")
            log(f"    {one['tflops']:.1f} TFLOP/s (2 m n k), "
                f"{one['gb_s']:.0f} GB/s; bound at the f32 peak "
                f"{one['bound_f32_peak_ms']:.5f} ms")
            out[f"{tag}_{m}x{nn}x{k}"] = one
        del xs, xh, calls, lib_ws, kern, plain, library
        torch.cuda.empty_cache()
    del weights, head_w
    return out


def _lm_head_inputs(gen, n, h, v, x_dtype, w_dtype, masked=False,
                    w_std=0.02, offset=False):
    """x as a LayerNorm output, W as the N(0, 0.02) tied embedding (or
    N(0, w_std): at 0.1 and H 1024 the scores have a std of 3.2 and the
    softmax is peaked, so p carries most of the gradient), random targets;
    g = 1 per token (so the gradients are O(1e-2) and their check means
    something), 0 at 85% of the rows when ``masked`` (BERT's unmasked
    positions carry a zero cotangent).  ``offset``: x starts one element
    into its storage (contiguous, off the 16-byte grid)."""
    x = torch.randn(n, h, generator=gen).to("cuda", x_dtype)
    if offset:
        x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(n, h)
    w = (w_std * torch.randn(v, h, generator=gen)).to("cuda", w_dtype)
    t = torch.randint(0, v, (n,), generator=gen).to("cuda")
    g = torch.ones(n)
    if masked:
        g = (torch.rand(n, generator=gen) < 0.15).float()
    return x, w, t, g.to("cuda")


def _lm_head_library(x, w, t, g):
    """The two-call yardstick (never called by the port): a matmul to
    logits in the operands' dtype, then F.cross_entropy(reduction='none')
    in f32; forward alone, and forward + autograd backward."""
    xl, wl = (a.detach().clone().requires_grad_() for a in (x, w))

    def fwd():
        return F.cross_entropy((xl @ wl.t()).float(), t, reduction="none")

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (xl, wl), g)

    return fwd, fwd_bwd


# The dX and dW kernels against their plain versions, entry by entry:
#   |d| <= ulp |ref| + ulp (|dS near a midpoint| @ |B|) + SUM (|dS| @ |B|)
# where B is the other operand of the product (W for dX, X for dW).
# - Both round the f32 result once: one unit in the last place, 2**-7 |ref|
#   in bf16 (2**-23 in f32).
# - The bf16 kernels round dS to bf16 from their own f32 scores.  A dS entry
#   within 1e-4 (relative, in p) of a bf16 rounding midpoint may round to
#   the neighbouring value on one side, moving the result by one ulp of
#   that dS times B; the scores of the two sides differ by ~1e-5, so 1e-4
#   is a wide margin.  f32 and mixed pairs do not round dS.
# - Both sum the same terms in f32 in other orders (the tensor cores'
#   accumulation truncates): the sums differ by ~sqrt(K) 2**-23 of the
#   terms' magnitude sum (2.7e-5 at K = 50304); allowed 2.5e-4 of it.
# A wrong softmax term (p dropped or halved, or the lse of another row)
# moves entries by ~4e-4 |x| in dX, many times this bound at the GPT-350M
# and BERT-large shapes and in the peaked case.
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
       torch.float32: 2.0 ** -23}
MIDPOINT = 1e-4
SUM_ORDER = 2.5e-4


def _lm_head_grad_bounds(x, w, t, lse, g, rounds_ds):
    """Per entry of dX and of dW, the bound above less its ulp |ref| term:
    (dx_slack, dw_slack), f32, computed on the card from the plain
    version's f32 scores."""
    s = x.float() @ w.float().t()
    p = torch.exp(s - lse[:, None])
    del s
    hit = (torch.arange(w.shape[0], device=x.device)[None, :]
           == t[:, None]).float()
    gcol = g[:, None].float()
    ds = ((p - hit) * gcol).abs()
    sx = SUM_ORDER * (ds @ w.float().abs())
    sw = SUM_ORDER * (ds.t() @ x.float().abs())
    if rounds_ds:
        hi = ((p * (1 + MIDPOINT) - hit) * gcol).bfloat16()
        lo = ((p * (1 - MIDPOINT) - hit) * gcol).bfloat16()
        del p, hit
        ulp = ULP[torch.bfloat16]
        near = torch.where(hi != lo, ds, 0.0)
        del hi, lo, ds
        sx += ulp * (near @ w.float().abs())
        sw += ulp * (near.t() @ x.float().abs())
    return sx, sw


def check_entrywise(name, got, ref, slack, rows=None):
    """One output against its plain version entry by entry: |d| <= ulp
    |ref| + slack (the LM head's rule above, the FFN's below); ``rows`` (a
    bool mask) also reports those rows on their own.  Returns the max abs
    error."""
    if got.dtype != ref.dtype:
        raise AssertionError(f"{name}: dtype {got.dtype}, want {ref.dtype}")
    ulp = ULP[ref.dtype]
    ref32 = ref.float()
    d = (got.float() - ref32).abs()
    lim = ulp * ref32.abs() + slack
    ratio = torch.where(d > 0, d / lim, 0.0)   # d > 0 = lim: inf
    parts = [("", ratio, d, ref32)]
    if rows is not None:
        parts.append((f", the {int(rows.sum())} rows with no target",
                      ratio[rows], d[rows], ref32[rows]))
    for tag, r, dd, rr in parts:
        worst = float(r.max())
        share = float(dd.max() / rr.abs().max().clamp_min(1e-30))
        log(f"  {name}{tag}: max_abs_err={float(dd.max()):.3e} (max |d| / "
            f"max |ref| {share:.3e}; |d| <= {ulp:.3g} |ref| + slack, largest "
            f"share of it {worst:.3f}) {'ok' if worst <= 1 else 'FAIL'}")
        if not worst <= 1:
            raise AssertionError(f"{name}{tag} disagrees with its plain "
                                 f"version")
    return float(d.max())


def _no_target_rows(v, t, g):
    """dW's rows that no token with g != 0 targets: they hold only the
    softmax term sum_i g_i p_iv x_i."""
    free = torch.ones(v, dtype=torch.bool, device=t.device)
    free[t[(g != 0) & (t >= 0)]] = False
    return free


def _cuda_events(fn, ok):
    """The CUDA kernel events of a torch.profiler session over ``fn`` (after
    a warm-up call) for which ``ok(events)`` holds.  A session on the card
    has been seen to record none or only some of a run's launches (three
    sessions in a row once each dropped one of three launches), so up to
    six sessions, each opened with a small kernel of its own before ``fn``;
    returns the last one's events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    opener = torch.zeros(1, device="cuda")
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            opener.add_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if ok(events):
            break
    return events


def _launch_tflops(fn, flops):
    """torch.profiler over one call of ``fn``: each of its kernel launches
    in order as (kernel name, device ms, TFLOP/s), ``flops`` the launches'
    operation counts in the same order."""
    def gemms(events):
        return [e for e in events if "gemm_" in e.name]

    events = gemms(_cuda_events(fn, lambda ev: len(gemms(ev)) == len(flops)))
    if len(events) != len(flops):
        raise AssertionError(f"profiled {len(events)} GEMM launches, want "
                             f"{len(flops)}")
    return [(e.name, e.device_time_total / 1e3,
             f / (e.device_time_total * 1e-6) / 1e12)
            for e, f in zip(events, flops)]


def _log_bwd_launches(name, x, w, t, lse, g, plan):
    """lm_head_bwd's launches one by one: per chunk dS, dX, dW, each with
    2 N (padded chunk) H flops; logs the chunk count and each launch
    type's TFLOP/s over the chunks."""
    from apex_tpu_torch.ops.lm_head import lm_head_bwd
    n, h = x.shape
    flops = [2 * n * padded * h for _, _, padded in plan.chunks
             for _ in range(3)]
    rows = _launch_tflops(lambda: lm_head_bwd(x, w, t, lse, g), flops)
    for k, part in enumerate(("dS", "dX", "dW")):
        mine = rows[k::3]
        rates = [r for _, _, r in mine]
        log(f"    {name} {part}: {len(mine)} launches, "
            f"{sum(ms for _, ms, _ in mine):.4f} ms, TFLOP/s per chunk "
            f"{[round(r, 1) for r in rates]} ({mine[0][0][:90]})")
    return [dict(part=("dS", "dX", "dW")[k % 3], ms=ms, tflops=r)
            for k, (_, ms, r) in enumerate(rows)]


def _log_fwd_launches(name, x, w, t):
    """lm_head_fwd's two launches under torch.profiler over three calls:
    the product's route (the persistent TMA + wgmma kernel or the FMA
    tile), median ms and TFLOP/s (2 N V H flops), and the combine's median
    ms."""
    from apex_tpu_torch.ops.lm_head import lm_head_fwd
    calls = 3

    def split(events):
        return ([e for e in events if "gemm_" in e.name],
                [e for e in events if "lm_head_fwd_combine" in e.name])

    def run():
        for _ in range(calls):
            lm_head_fwd(x, w, t)

    events = _cuda_events(run, lambda ev: all(
        len(k) == calls for k in split(ev)))
    product, combine = split(events)
    if len(product) != calls or len(combine) != calls:
        raise AssertionError(
            f"{name}: profiled {len(product)} products and {len(combine)} "
            f"combines over {calls} calls: "
            f"{sorted({e.name[:60] for e in events})}")
    routes = {"TMA" if "gemm_tma_rows_kernel" in e.name else
              "FMA" if "gemm_fma_kernel" in e.name else e.name[:90]
              for e in product}
    if len(routes) != 1:
        raise AssertionError(f"{name}: the products ran on {routes}")
    (route,) = routes
    ms = statistics.median(e.device_time_total / 1e3 for e in product)
    tflops = 2 * x.shape[0] * w.shape[0] * x.shape[1] / (ms * 1e-3) / 1e12
    combine_ms = statistics.median(e.device_time_total / 1e3
                                   for e in combine)
    log(f"    {name} forward: product on {route}, {ms:.4f} ms, "
        f"{tflops:.1f} TFLOP/s; combine {combine_ms:.4f} ms")
    return dict(route=route, ms=ms, tflops=tflops, combine_ms=combine_ms)


def kernel_lm_head(gen):
    """#8, #9 and #10 against their plain versions: bf16 at GPT-350M's head
    (8192 x 1024 x 50304) and BERT-large's (8192 x 1024 x 30528, 85% of
    rows with g = 0), both timed; f32 at GPT-350M's head, timed (the f32
    instantiation an f32 model runs); bf16 at GPT-2 XL's head (1000 x 1600
    x 50257), timed; bf16 with a peaked softmax off the token and vocab
    grids (1000 x 1024 x 30522); the vocab off the 64-column grid over
    four backward chunks (8192 x 1024 x 30522, peaked, masked); 48 tokens
    (the backward's dS launch on its narrow tiles); small off-grid cases
    (200 x 96 x 1000: bf16, f32, bf16 x with f32 W, bf16 with x off the
    16-byte grid) and a hidden size off it (77 x 100 x 1000 bf16); the
    forward's product runs the GEMM's FMA tile off that grid and for
    non-bf16 pairs.  The off-grid cases carry a target of -1.  loss and lse
    within f32 tolerances and bitwise on a repeat, the product's route
    checked and its TFLOP/s logged; dX and dW of ``lm_head_dx``,
    ``lm_head_dw`` and ``lm_head_bwd`` entry by entry
    (``_lm_head_grad_bounds``), dW's rows with no target also reported on
    their own; ``lm_head_bwd`` bitwise the two calls and a repeat; each
    call's launches those of its chunk plan.  Timed cases also time the
    whole backward against the library's, and log each launch's TFLOP/s
    and the chunk count."""
    from apex_tpu_torch.ops.lm_head import (
        bwd_chunk_plan, lm_head_bwd, lm_head_bwd_reference, lm_head_dw,
        lm_head_dw_reference, lm_head_dx, lm_head_dx_reference, lm_head_fwd,
        lm_head_fwd_reference)
    out = {}
    bf, f32 = torch.bfloat16, torch.float32
    vg, vb = GPT350M["vocab_size"], BERT_LARGE["vocab_size"]
    # tag, n, h, v, x dtype, w dtype, masked, w std, timed (else off the
    # grids: a target of -1)
    cases = [("gpt", TRAIN_ROWS, HIDDEN, vg, bf, bf, False, 0.02, True),
             ("bert", BERT_ROWS, HIDDEN, vb, bf, bf, True, 0.02, True),
             ("gpt f32", TRAIN_ROWS, HIDDEN, vg, f32, f32, False, 0.02, True),
             ("peaked", 1000, HIDDEN, 30522, bf, bf, False, 0.1, False),
             ("chunked off-grid", TRAIN_ROWS, HIDDEN, 30522, bf, bf, True,
              0.1, False),
             ("48 tokens", 48, HIDDEN, vg, bf, bf, False, 0.02, False),
             ("gpt2-xl", 1000, 1600, 50257, bf, bf, False, 0.02, True),
             ("small bf16", 200, 96, 1000, bf, bf, True, 0.02, False),
             ("small f32", 200, 96, 1000, f32, f32, True, 0.02, False),
             ("small bf16 x f32 w", 200, 96, 1000, bf, f32, True, 0.02,
              False),
             ("small bf16 x off 16 bytes", 200, 96, 1000, bf, bf, True, 0.02,
              False),
             ("unaligned bf16", 77, 100, 1000, bf, bf, True, 0.02, False)]
    for tag, n, h, v, xdt, wdt, masked, w_std, timed in cases:
        offset = "off 16 bytes" in tag
        x, w, t, g = _lm_head_inputs(gen, n, h, v, xdt, wdt, masked, w_std,
                                     offset)
        off_grid = not timed
        if off_grid:
            t[3] = -1                        # matches no column: loss = lse
        name = f"lm_head {tag} ({n}x{h}x{v})"
        rloss, rlse = lm_head_fwd_reference(x, w, t)
        before = lm_head_fwd.launches
        loss, lse = lm_head_fwd(x, w, t)
        if lm_head_fwd.launches - before != 2:
            raise AssertionError("lm_head_fwd: expected 2 launches per call")
        torch.cuda.synchronize()
        # f32 scores summed in another order over H, then a logsumexp over V
        # in another order
        err_f = max(check_close(f"{name} loss", loss, rloss, 1e-4, 1e-5),
                    check_close(f"{name} lse", lse, rlse, 1e-4, 1e-5))
        # each (row, tile) partial comes from one block in a fixed order
        loss2, lse2 = lm_head_fwd(x, w, t)
        if not (torch.equal(loss2, loss) and torch.equal(lse2, lse)):
            raise AssertionError(f"{name}: lm_head_fwd differs on a repeat")
        fwd = _log_fwd_launches(name, x, w, t)
        # bf16 pairs on TMA's 16-byte grid take TMA + wgmma
        tma = xdt == wdt == bf and h % 8 == 0 and not offset
        if fwd["route"] != ("TMA" if tma else "FMA"):
            raise AssertionError(f"{name}: the product ran on {fwd['route']}")
        out[f"fwd_launch_{tag.replace(' ', '_')}"] = fwd
        del loss2, lse2
        dt = torch.bfloat16 if xdt == wdt == bf else f32
        plan = bwd_chunk_plan(n, v, dt.itemsize)
        before = (lm_head_dx.launches, lm_head_dw.launches)
        dx = lm_head_dx(x, w, t, lse, g)
        dw = lm_head_dw(x, w, t, lse, g)
        bdx, bdw = lm_head_bwd(x, w, t, lse, g)
        got = (lm_head_dx.launches - before[0],
               lm_head_dw.launches - before[1])
        want = tuple(map(sum, zip(*(plan.launches(c)
                                    for c in ("dx", "dw", "bwd")))))
        if got != want:
            raise AssertionError(f"{name}: launches (dx, dw) {got}, want "
                                 f"{want} ({len(plan.chunks)} chunks)")
        # every entry is summed by one block in a fixed order, and the
        # whole backward runs the two calls' launches
        rdx2, rdw2 = lm_head_bwd(x, w, t, lse, g)
        for label, a, b in (("lm_head_bwd against lm_head_dx", bdx, dx),
                            ("lm_head_bwd against lm_head_dw", bdw, dw),
                            ("lm_head_bwd dx on a repeat", rdx2, bdx),
                            ("lm_head_bwd dw on a repeat", rdw2, bdw)):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: {label} differ")
        del rdx2, rdw2
        log(f"  {name}: {len(plan.chunks)} chunks of {plan.width} columns; "
            f"launches (dx, dw) {got} as planned; lm_head_bwd bitwise "
            f"lm_head_dx / lm_head_dw and a repeat ok")
        rdx = lm_head_dx_reference(x, w, t, lse, g)
        rdw = lm_head_dw_reference(x, w, t, lse, g)
        torch.cuda.synchronize()
        # the kernels round dS to bf16 for a bf16 pair only
        slx, slw = _lm_head_grad_bounds(x, w, t, lse, g, xdt == wdt == bf)
        free = _no_target_rows(v, t, g)
        errs = dict(dx=check_entrywise(f"{name} dx", dx, rdx, slx),
                    dw=check_entrywise(f"{name} dw", dw, rdw, slw, free))
        errs["bwd"] = max(
            check_entrywise(f"{name} lm_head_bwd dx", bdx, rdx, slx),
            check_entrywise(f"{name} lm_head_bwd dw", bdw, rdw, slw, free))
        del slx, slw, bdx, bdw
        if off_grid:
            if float(loss[3]) != float(lse[3]):
                raise AssertionError(f"{name}: target -1 must give loss "
                                     f"= lse")
            continue
        out[f"chunks_{tag.replace(' ', '_')}"] = dict(
            width=plan.width, count=len(plan.chunks),
            launches=_log_bwd_launches(f"lm_head_bwd {tag}", x, w, t, lse, g,
                                       plan))
        ops = 2 * n * v * h
        isz = x.element_size()
        io = n * h * isz + v * h * w.element_size() + n * 8
        peak = PEAK_BF16_FLOPS if xdt == bf else PEAK_F32_FLOPS
        f32_case = xdt == f32            # slow: fewer calls per sample
        reps, rounds = (3, 3) if f32_case else (20, 5)
        lib_fwd, lib_bwd = _lm_head_library(x, w, t, g)
        t_fwd = time_ms([lib_fwd] * reps, rounds)
        lib_grad = time_ms([lib_bwd] * reps, rounds) - t_fwd
        plain = dict(fwd=lambda: lm_head_fwd_reference(x, w, t),
                     dx=lambda: lm_head_dx_reference(x, w, t, lse, g),
                     dw=lambda: lm_head_dw_reference(x, w, t, lse, g),
                     bwd=lambda: lm_head_bwd_reference(x, w, t, lse, g))
        kern = dict(fwd=lambda: lm_head_fwd(x, w, t),
                    dx=lambda: lm_head_dx(x, w, t, lse, g),
                    dw=lambda: lm_head_dw(x, w, t, lse, g),
                    bwd=lambda: lm_head_bwd(x, w, t, lse, g))
        io_part = dict(fwd=io + n * 8, dx=io + n * 8 + n * h * isz,
                       dw=io + n * 8 + v * h * w.element_size(),
                       bwd=io + n * 8 + n * h * isz + v * h * w.element_size())
        work = dict(fwd=ops, dx=2 * ops, dw=2 * ops, bwd=3 * ops)
        for part in ("fwd", "dx", "dw", "bwd"):
            key = f"{part}_{tag.replace(' ', '_')}"
            out[key] = numbers(
                err_f if part == "fwd" else errs[part],
                time_ms([kern[part]] * reps, rounds),
                time_ms([plain[part]] * 3, rounds=3),
                t_fwd if part == "fwd" else lib_grad,
                bound_ms(io_part[part], work[part], peak),
                call_ms(kern[part], iters=5 if f32_case else 50))
            log_numbers(f"lm_head_{part} {tag}", out[key],
                        "matmul + F.cross_entropy (two calls; "
                        + ("forward)" if part == "fwd"
                           else "backward, dX and dW together)"))
        del x, w, t, g, rloss, rlse, rdx, rdw, lib_fwd, lib_bwd, plain, kern
        torch.cuda.empty_cache()
    return out


# The fused FFN's outputs against their plain versions, entry by entry:
#   |d| <= ulp |ref| + SUM_ORDER (|A| @ |B|) + R
# for an output that is the product A B (A = h for y, dz for dX and dW1,
# gelu(z1) for dW2: the terms' magnitude sum gives the summation-order
# slack, as for the LM head).  R covers the one intermediate each kernel
# makes from f32 sums of its own and rounds to the activation dtype: the
# forward's h = gelu(x W1^T + b1) and the backward's dz = (dy W2) gelu'(z1).
# An entry within MIDPOINT (relative) of a rounding midpoint may round to
# the neighbouring value on one side, moving the output by one ulp of that
# entry times the other operand: R = (ulp |near entries|) @ |B|.  In f32
# nothing is rounded and the intermediate's own sum-order difference
# (within MIDPOINT of it) carries through: R = MIDPOINT |A| @ |B|.  Both
# sides read the same z1, so gelu(z1) and gelu'(z1) differ only in the f32
# tanh's last bits (within MIDPOINT).  z1 = x W1^T + b1 takes the SUM_ORDER
# term alone; db1 (f32 sums of the unrounded dz) takes (SUM_ORDER +
# MIDPOINT) of the sum of |dz|.  Wrong GELU' terms, dW2 taken from z
# instead of gelu(z) and a dropped b1 fail this rule by large factors
# (tests/test_torch_fused_ffn.py, on an emulation of the kernels).

def ffn_bounds(x, w1, b1, w2, dy, z1):
    """Per entry of each output, the slack of the rule above:
    ``{"z1", "y", "dx", "dw1", "db1", "dw2"}``, f32, from the plain
    version's own f32 intermediates on the inputs' device."""
    from apex_tpu_torch.ops.fused_ffn import _gelu, _gelu_grad
    dt = x.dtype
    xf, dyf = x.float(), dy.float()
    w1f, w2f = w1.to(dt).float(), w2.to(dt).float()
    ax, adj, aw1, aw2 = xf.abs(), dyf.abs(), w1f.abs(), w2f.abs()

    def carry(v):
        if dt == torch.float32:
            return MIDPOINT * v.abs()
        hi, lo = (v * (1 + MIDPOINT)).to(dt), (v * (1 - MIDPOINT)).to(dt)
        return torch.where(hi != lo, ULP[dt] * v.abs(), 0.0)

    out = dict(z1=SUM_ORDER * (ax @ aw1.t()))
    h = _gelu(xf @ w1f.t() + b1.float())
    out["y"] = (SUM_ORDER * h.abs() + carry(h)) @ aw2.t()
    del h
    z = z1.float()
    dz = (dyf @ w2f) * _gelu_grad(z)
    a = SUM_ORDER * dz.abs() + carry(dz)
    out["dx"] = a @ aw1
    out["dw1"] = a.t() @ ax
    out["db1"] = (SUM_ORDER + MIDPOINT) * dz.abs().sum(0)
    del a, dz
    h1 = _gelu(z)
    out["dw2"] = adj.t() @ (SUM_ORDER * h1.abs() + carry(h1))
    return out


def _ffn_inputs(gen, m, k, f, n, x_dtype, w_dtype):
    """x as a LayerNorm output, W1 and W2 N(0, 0.02) as the models draw
    them, b1 and b2 N(0, 0.1) (the models start them at 0: a random bias
    is what a check can see), dy N(0, 1)."""
    x = torch.randn(m, k, generator=gen).to("cuda", x_dtype)
    w1 = (0.02 * torch.randn(f, k, generator=gen)).to("cuda", w_dtype)
    b1 = (0.1 * torch.randn(f, generator=gen)).to("cuda", w_dtype)
    w2 = (0.02 * torch.randn(n, f, generator=gen)).to("cuda", w_dtype)
    b2 = (0.1 * torch.randn(n, generator=gen)).to("cuda", w_dtype)
    dy = torch.randn(m, n, generator=gen).to("cuda", x_dtype)
    return x, w1, b1, w2, b2, dy


def _ffn_library(x, w1, b1, w2, b2, dy):
    """The unfused cuBLAS chain (the yardstick; the port never calls it):
    F.linear, F.gelu(approximate="tanh"), F.linear on operands cast to the
    activation dtype beforehand; forward alone, and forward + autograd
    backward (dX, dW1, db1, dW2, db2 together)."""
    leaves = [a.detach().to(x.dtype).clone().requires_grad_()
              for a in (x, w1, b1, w2, b2) if a is not None]

    def fwd():
        h = F.gelu(F.linear(leaves[0], leaves[1], leaves[2]),
                   approximate="tanh")
        return F.linear(h, *leaves[3:])

    def fwd_bwd():
        return torch.autograd.grad(fwd(), leaves, dy)

    return fwd, fwd_bwd


# GPT-350M's FFN shards at tensor-parallel sizes 2 and 4 (phase 15): fc1's
# column shard and fc2's row shard, bf16 x with f32 W at the micro-batch
FFN_TP_CASES = [(f"gpt tp{t}", TRAIN_ROWS, HIDDEN,
                 GPT350M["ffn_hidden_size"] // t, HIDDEN, torch.bfloat16,
                 torch.float32, True) for t in (2, 4)]


def kernel_fused_ffn(gen, cases=None):
    """#11, #12 and #13 against their plain versions, entry by entry
    (``ffn_bounds``), and timed: bf16 x with f32 W at GPT-350M's
    micro-batch (8192 x 1024 -> 4096 -> 1024), bf16/bf16 at BERT-large's
    (the same shape, O2), at the serving shapes (prefill 512 rows; decode 8
    rows, timed over 24 weight sets so that W comes from device memory as
    on the path), GPT-2 XL's widths off the grids (1000 x 1600 -> 6400 ->
    1600, bf16), GPT-350M's shape in f32 (the FMA instantiation); small
    off-grid cases (200 x 96 -> 320 -> 80: f32, bf16, bf16 x f32 W, f16)
    and one off the 16-byte loads (77 x 100 -> 200 -> 36, bf16, no b2).
    The backward kernels read the forward kernel's z1 on both sides.  The
    whole backward (``ffn_bwd``) is held to ffn_dx_reference's and
    ffn_dw_reference's outputs by the same rule, and must give ffn_dx's
    and ffn_dw's bits; every output is bitwise equal on a repeat, and each
    call makes ``ffn_bwd_launches`` launches (the off-grid and f32 / f16
    cases run the FMA tile, the others TMA + wgmma).  ``cases``: other
    cases in the same form (``FFN_TP_CASES``: phase 15's shard shapes)."""
    from apex_tpu_torch.ops.fused_ffn import (
        ffn_bwd, ffn_bwd_reference, ffn_dw, ffn_dw_reference, ffn_dx,
        ffn_dx_reference, ffn_fwd, ffn_fwd_reference)
    out = {}
    bf, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    k, f, n = HIDDEN, GPT350M["ffn_hidden_size"], HIDDEN
    # tag, m, k, f, n, x dtype, w dtype, timed
    cases = cases or [
             ("gpt", TRAIN_ROWS, k, f, n, bf, f32, True),
             ("bert", BERT_ROWS, k, f, n, bf, bf, True),
             ("prefill", 512, k, f, n, bf, f32, True),
             ("decode", SLOTS, k, f, n, bf, f32, True),
             ("gpt2-xl", 1000, 1600, 6400, 1600, bf, bf, True),
             ("gpt f32", TRAIN_ROWS, k, f, n, f32, f32, True),
             ("small f32", 200, 96, 320, 80, f32, f32, False),
             ("small bf16", 200, 96, 320, 80, bf, bf, False),
             ("small bf16 x f32 w", 200, 96, 320, 80, bf, f32, False),
             ("small f16", 200, 96, 320, 80, f16, f16, False),
             ("unaligned bf16", 77, 100, 200, 36, bf, bf, False)]
    for tag, m, k, f, n, xdt, wdt, timed in cases:
        x, w1, b1, w2, b2, dy = _ffn_inputs(gen, m, k, f, n, xdt, wdt)
        if tag.startswith("unaligned"):
            b2 = None
        before = ffn_fwd.launches
        y, z1 = ffn_fwd(x, w1, b1, w2, b2)
        if ffn_fwd.launches - before != 2:
            raise AssertionError("ffn_fwd: expected 2 launches per call")
        # every entry is summed by one block in a fixed order
        y2, z12 = ffn_fwd(x, w1, b1, w2, b2)
        if not (torch.equal(y, y2) and torch.equal(z1, z12)):
            raise AssertionError(f"ffn_fwd {tag}: two calls on the same "
                                 "inputs differ")
        log(f"  ffn_fwd {tag}: y and z1 bitwise equal on a repeat ok")
        del y2, z12
        ry, rz1 = ffn_fwd_reference(x, w1, b1, w2, b2)
        before = (ffn_dx.launches, ffn_dw.launches)
        dx = ffn_dx(dy, z1, w1, w2)
        dws = ffn_dw(x, dy, z1, w1, w2)
        bwd = ffn_bwd(x, dy, z1, w1, w2)
        got = (ffn_dx.launches - before[0], ffn_dw.launches - before[1])
        want = tuple(map(sum, zip(*(ffn_bwd_launches(call)
                                    for call in ("dx", "dw", "bwd")))))
        if got != want:
            raise AssertionError(f"ffn backward {tag}: launches (dx, dw) "
                                 f"{got}, want {want}")
        rdx = ffn_dx_reference(dy, z1, w1, w2)
        rdw1, rdb1, rdw2 = ffn_dw_reference(x, dy, z1, w1, w2)
        # every entry is summed by one block in a fixed order, and the
        # whole backward runs ffn_dx's and ffn_dw's launches
        again = (ffn_dx(dy, z1, w1, w2),) + ffn_dw(x, dy, z1, w1, w2)
        bwd2 = ffn_bwd(x, dy, z1, w1, w2)
        for label, out_a, out_b in (("ffn_dx / ffn_dw", (dx,) + dws, again),
                                    ("ffn_bwd", bwd, bwd2),
                                    ("ffn_bwd against ffn_dx / ffn_dw", bwd,
                                     (dx,) + dws)):
            if not all(torch.equal(a, b) for a, b in zip(out_a, out_b)):
                raise AssertionError(f"{label} {tag}: outputs differ")
        log(f"  ffn backward {tag}: dx, dw1, db1, dw2 bitwise "
            f"equal on a repeat and between ffn_bwd and ffn_dx / ffn_dw ok")
        del again, bwd2
        torch.cuda.synchronize()
        name = f"fused_ffn {tag} ({m}x{k}->{f}->{n})"
        slack = ffn_bounds(x, w1, b1, w2, dy, z1)
        refs = dict(dx=rdx, dw1=rdw1, db1=rdb1, dw2=rdw2)
        pairs = [("z1", z1, rz1), ("y", y, ry)] + [
            (part, g, refs[part]) for part, g in zip(refs, (dx,) + dws)]
        errs = {part: check_entrywise(f"{name} {part}", g, ref, slack[part])
                for part, g, ref in pairs}
        errs["bwd"] = max(
            check_entrywise(f"{name} ffn_bwd {part}", g, refs[part],
                            slack[part])
            for part, g in zip(refs, bwd))
        del slack, ry, rz1, refs, pairs, rdx, rdw1, rdb1, rdw2, dx, dws, bwd
        if not timed:
            continue
        isz, wsz = x.element_size(), w1.element_size()
        w_bytes = (f * k + n * f) * wsz
        io = dict(fwd=m * k * isz + w_bytes + (f + n) * wsz
                  + (m * n + m * f) * isz,
                  dx=(m * n + m * f + m * k) * isz + w_bytes,
                  dw=(m * k + m * n + m * f) * isz + n * f * wsz + w_bytes
                  + f * 4,
                  bwd=(2 * m * k + m * n + m * f) * isz + 2 * w_bytes + f * 4)
        work = dict(fwd=2 * m * f * (k + n), dx=2 * m * f * (n + k),
                    dw=2 * m * f * (2 * n + k), bwd=4 * m * f * (n + k))
        peak = PEAK_BF16_FLOPS if xdt == bf else PEAK_F32_FLOPS
        f32_case = xdt == f32
        reps, rounds = (3, 3) if f32_case else (20, 5)
        sets = [(w1, b1, w2, b2)]
        if tag == "decode":              # one weight set per layer
            sets += [tuple((0.02 * torch.randn(a.shape, device="cuda")).to(
                wdt) for a in (w1, b1, w2, b2)) for _ in range(23)]
            reps = len(sets)

        def cycle(fn):
            return [lambda s=s: fn(*s) for s in sets] * (reps // len(sets))
        lib = [_ffn_library(x, *s, dy) for s in sets]
        t_fwd = time_ms([lf for lf, _ in lib] * (reps // len(sets)), rounds)
        t_bwd = time_ms([lb for _, lb in lib] * (reps // len(sets)),
                        rounds) - t_fwd
        kern = dict(
            fwd=cycle(lambda a, b, c, d: ffn_fwd(x, a, b, c, d)),
            dx=cycle(lambda a, b, c, d: ffn_dx(dy, z1, a, c)),
            dw=cycle(lambda a, b, c, d: ffn_dw(x, dy, z1, a, c)),
            bwd=cycle(lambda a, b, c, d: ffn_bwd(x, dy, z1, a, c)))
        plain = dict(
            fwd=cycle(lambda a, b, c, d: ffn_fwd_reference(x, a, b, c, d)),
            dx=cycle(lambda a, b, c, d: ffn_dx_reference(dy, z1, a, c)),
            dw=cycle(lambda a, b, c, d: ffn_dw_reference(x, dy, z1, a, c)),
            bwd=cycle(lambda a, b, c, d: ffn_bwd_reference(x, dy, z1, a, c)))
        err = dict(fwd=max(errs["y"], errs["z1"]), dx=errs["dx"],
                   dw=max(errs["dw1"], errs["db1"], errs["dw2"]),
                   bwd=errs["bwd"])
        for part in ("fwd", "dx", "dw", "bwd"):
            key = f"{part}_{tag.replace(' ', '_')}"
            out[key] = numbers(
                err[part], time_ms(kern[part], rounds),
                time_ms(plain[part][:3], rounds=3),
                t_fwd if part == "fwd" else t_bwd,
                bound_ms(io[part], work[part], peak),
                call_ms(kern[part][0], iters=5 if f32_case else 50))
            log_numbers(f"ffn_{part} {tag}", out[key],
                        "unfused F.linear + gelu + F.linear chain ("
                        + ("forward)" if part == "fwd" else
                           "backward: dX, dW1, db1, dW2, db2 together)"))
        del x, w1, b1, w2, b2, dy, y, z1, sets, lib, kern, plain
        torch.cuda.empty_cache()
    return out


def table_launches(numels, max_tensors=36, max_blocks=320, chunk=65536):
    """Launches of a multi-tensor kernel (csrc/multi_tensor.cuh) over
    tensors of these sizes: a table launches when its 320 blocks or 36
    tensors are full, carrying a tensor whose chunks are not all
    issued."""
    launches = nt = nb = 0
    for n in numels:
        if n <= 0:
            continue
        nt += 1
        chunks = -(-n // chunk)
        for c in range(chunks):
            nb += 1
            done = c == chunks - 1
            if nb == max_blocks or (nt == max_tensors and done):
                launches += 1
                nb = 0
                nt = 0 if done else 1
    return launches + (nb > 0)


def sumsq_launches(numels, per_tensor=False):
    """Launches of multi_tensor_sumsq: the table's first pass, then the
    fixed-order sums of its partials (csrc/multi_tensor_l2norm.cu), one
    launch per 480 tensors with per-tensor sums, else one."""
    return table_launches(numels) + (-(-len(numels) // 480) if per_tensor
                                     else 1)


def kernel_adam(gen_cuda):
    """#18 over the GPT-350M parameter list (291 f32 tensors), noop 0 and
    1, against its plain version on copies of the same tensors."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.ops.multi_tensor import (multi_tensor_adam,
                                                 multi_tensor_adam_reference)
    shapes = [p.shape for p in GPTModel(GPTConfig(**GPT350M),
                                        device="meta").parameters()]
    numels = [int(np.prod(s)) for s in shapes]

    def rand(shape, std, positive=False):
        t = torch.randn(shape, generator=gen_cuda, device="cuda") * std
        return t.abs() if positive else t

    # mixed dtypes (bf16 / f16 / f32 params and grads) over 40 tensors, so
    # the 36-tensor table limit and chunk carry-over are crossed too: the
    # params round once from the same f32 value, so one ulp of their dtype
    mixed = [(n, pdt, gdt) for n, pdt, gdt in zip(
        [70000, 65536, 1, 3, 200000, 129] * 7, [torch.bfloat16, torch.float16,
                                                 torch.float32] * 14,
        [torch.bfloat16, torch.float16, torch.bfloat16, torch.float32] * 10)]
    mg = [rand(n, 1e-3).to(gdt) for n, _, gdt in mixed]
    mp = [rand(n, 0.02).to(pdt) for n, pdt, _ in mixed]
    step1 = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.01, 0.1, 0.001, 0.5],
                         dtype=torch.float32, device="cuda")
    outs = []
    for fn in (multi_tensor_adam, multi_tensor_adam_reference):
        p = [t.clone() for t in mp]
        m = [torch.zeros(t.shape, device="cuda") for t in mp]
        v = [torch.zeros(t.shape, device="cuda") for t in mp]
        fn(mg, p, m, v, step1)
        outs.append((p, m, v))
    torch.cuda.synchronize()
    # relative ulp, and the absolute spacing of f16 subnormals
    ulp = {torch.bfloat16: (2 ** -7, 1e-9),
           torch.float16: (2 ** -10, 2 ** -24),
           torch.float32: (1e-6, 1e-9)}
    for (kp, km, kv), (rp, rm, rv), (_, pdt, _) in zip(
            zip(*outs[0]), zip(*outs[1]), mixed):
        rtol, atol = ulp[pdt]
        if not (torch.allclose(kp.float(), rp.float(), rtol=rtol, atol=atol)
                and torch.allclose(km, rm, rtol=1e-6, atol=1e-12)
                and torch.allclose(kv, rv, rtol=1e-6, atol=1e-15)):
            raise AssertionError(f"multi_tensor_adam disagrees with its plain "
                                 f"version on a {pdt} parameter")
    err_p = max(max_err(a, b) for a, b in zip(outs[0][0], outs[1][0]))
    log(f"  multi_tensor_adam {len(mixed)} mixed bf16/f16/f32 tensors: "
        f"max_abs_err p {err_p:.3e} (tolerance one ulp of the param dtype) "
        f"ok")
    del mg, mp, outs

    gs = [rand(s, 1e-3) for s in shapes]
    ps = [rand(s, 0.02) for s in shapes]
    ms = [rand(s, 1e-4) for s in shapes]
    vs = [rand(s, 1e-6, positive=True) for s in shapes]
    # step 3 of AdamW(lr=1e-4, betas=(0.9, 0.999), eps=1e-8, wd=0.01)
    scal = torch.tensor([LR, 0.9, 0.999, 1e-8, 0.01, 1 - 0.9 ** 3,
                         1 - 0.999 ** 3, 1.0], dtype=torch.float32,
                        device="cuda")
    err = 0.0
    for noop_v in (0, 1):
        noop = torch.tensor(noop_v, dtype=torch.int32, device="cuda")
        kp, km, kv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
        rp, rm, rv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
        before = multi_tensor_adam.launches
        multi_tensor_adam(gs, kp, km, kv, scal, noop)
        n_launch = multi_tensor_adam.launches - before
        multi_tensor_adam_reference(gs, rp, rm, rv, scal, noop)
        torch.cuda.synchronize()
        if n_launch != table_launches(numels):
            raise AssertionError(f"multi_tensor_adam made {n_launch} "
                                 f"launches, the table rule says "
                                 f"{table_launches(numels)}")
        for name, a, b in (("p", kp, rp), ("m", km, rm), ("v", kv, rv)):
            # f32 on both sides; FMA contraction on the card moves the
            # last bits: 1e-6 relative
            err = max(err, _check_lists(f"multi_tensor_adam noop={noop_v} "
                                        f"{name}", a, b, 1e-6, 1e-9))
        if noop_v and not all(torch.equal(x, y) for x, y in zip(kp, ps)):
            raise AssertionError("multi_tensor_adam noop=1 changed params")
        del kp, km, kv, rp, rm, rv
    noop = torch.tensor(0, dtype=torch.int32, device="cuda")
    lib_ps = [torch.nn.Parameter(p.clone()) for p in ps]
    for p, g in zip(lib_ps, gs):
        p.grad = g
    lib_opt = torch.optim.AdamW(lib_ps, lr=LR, weight_decay=0.01, fused=True)
    n_el = sum(numels)
    n = numbers(
        err, time_ms([lambda: multi_tensor_adam(gs, ps, ms, vs, scal, noop)]
                     * 5),
        time_ms([lambda: multi_tensor_adam_reference(gs, ps, ms, vs, scal,
                                                     noop)] * 2, rounds=3),
        call_ms(lib_opt.step, iters=10),
        bound_ms(7 * 4 * n_el, 15 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: multi_tensor_adam(gs, ps, ms, vs, scal, noop),
                iters=10))
    log_numbers(f"multi_tensor_adam {len(shapes)} tensors, {n_el} elements, "
                f"{table_launches(numels)} launches", n,
                "AdamW(fused=True).step (eager)")
    n["tensors"], n["elements"] = len(shapes), n_el
    n["launches_per_step"] = table_launches(numels)
    return n


def bert_param_specs():
    """(shape, dtype) of BERT-large's 299 parameters under amp O2: bf16,
    the LayerNorms f32."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.bert import BertConfig, BertModel
    model = BertModel(BertConfig(**BERT_LARGE), device="meta")
    amp.initialize(model, None, opt_level="O2")
    return [(tuple(p.shape), p.dtype) for p in model.parameters()]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _check_lists(name, got, ref, rtol, atol, scale_rtol=0.0):
    """Every pair within |d| <= atol + rtol*|ref| + scale_rtol*max|ref|
    (the largest entry of that tensor); returns the max error."""
    pairs = [(a, b) for a, b in zip(got, ref) if a is not None]
    err = max(max_err(a, b) for a, b in pairs)
    ok = all(torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol + (
        scale_rtol * float(b.float().abs().max()) if scale_rtol else 0.0))
        for a, b in pairs)
    scale = f" + {scale_rtol}*max|ref|" if scale_rtol else ""
    log(f"  {name}: max_abs_err={err:.3e} (tolerance |d| <= {atol} + "
        f"{rtol}*|ref|{scale}) {'ok' if ok else 'FAIL'}")
    if not ok:
        i, (a, b) = max(enumerate(pairs), key=lambda ip: max_err(*ip[1]))
        j = int((a.float() - b.float()).abs().argmax())
        log(f"    worst: tensor {i} {tuple(b.shape)} element {j}: got "
            f"{float(a.flatten()[j])!r}, plain {float(b.flatten()[j])!r}")
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def _check_found_inf(name, kernel_fn, plain_fn, tensors):
    """The found-inf flag of kernel and plain version, clean and with one
    inf in the middle of the list."""
    t = tensors[len(tensors) // 2].view(-1)
    saved = t[7].clone()
    flags = []
    for bad in (False, True):
        if bad:
            t[7] = float("inf")
        flags.append((float(kernel_fn()), float(plain_fn())))
    t[7] = saved
    log(f"  {name} found_inf clean / with an inf: kernel "
        f"{[f[0] for f in flags]}, plain {[f[1] for f in flags]}")
    if flags != [(0.0, 0.0), (1.0, 1.0)]:
        raise AssertionError(f"{name}: wrong found-inf flag")


def lamb_stage1_scal():
    """#20's scalars at step 3, clip 0.5: [beta1, beta2, eps, wd, bc1,
    bc2, grad_scale, clip, beta3]."""
    b1, b2 = LAMB_BETAS
    return torch.tensor([b1, b2, 1e-6, LAMB_WD, 1 - b1 ** 3, 1 - b2 ** 3,
                         1.0, 0.5, 1 - b1], dtype=torch.float32,
                        device="cuda")


def _lamb_stage1_check(tag, lists, scal, noop, offsets=(0,) * 5):
    """#20 on copies of ``lists`` (g, p, m, v; each list, and u, at its
    storage offset in ``offsets``) against its plain version, and the
    kernel again on fresh copies: launches as ``lamb_stage1_launches``
    says; u, m and v within 1e-6 relative + 1e-6 of each tensor's largest
    entry, the chunk partials within 1e-5 relative; under noop m and v
    untouched and u = 0, bit for bit; the repeat bitwise the first run.
    Returns (u's, m's and v's max error, the kernel's (u, m, v, u_sq,
    p_sq))."""
    from apex_tpu_torch.ops import multi_tensor as K
    grads, params, ms, vs = lists
    numels = [p.numel() for p in params]
    want = K.lamb_stage1_launches(numels)
    sides = []
    for f in (K.multi_tensor_lamb_stage1, K.multi_tensor_lamb_stage1_reference,
              K.multi_tensor_lamb_stage1):
        g, p, m, v = ([_at_offset(t, o) for t in lst]
                      for lst, o in zip(lists, offsets))
        u = [_at_offset(torch.empty_like(t, dtype=torch.float32), offsets[4])
             for t in params]
        before = K.multi_tensor_lamb_stage1.launches
        usq, psq = f(g, p, m, v, u, scal, noop)
        sides.append(((u, m, v, usq, psq),
                      K.multi_tensor_lamb_stage1.launches - before))
    torch.cuda.synchronize()
    (k, n_k), (r, n_r), (k2, n_k2) = sides
    if (n_k, n_r, n_k2) != (want, 0, want):
        raise AssertionError(f"{tag}: launches {n_k} / {n_k2} (plain {n_r}), "
                             f"lamb_stage1_launches says {want}")
    if not _bitwise([k[0], k[1], k[2], [k[3], k[4]]],
                    [k2[0], k2[1], k2[2], [k2[3], k2[4]]]):
        raise AssertionError(f"{tag}: a repeat differs")
    # f32 on both sides; the kernel rounds b1*m + b3*g once (an FMA) where
    # the plain version rounds twice, which moves an entry where the two
    # terms cancel by an ulp of the terms (not of the result), and u
    # divides it by sqrt(v): 1e-6 of each tensor's largest entry; the
    # chunk partials sum 64K terms in another order (1e-5 relative)
    err = 0.0
    for name, a, b in zip("umv", k, r):
        err = max(err, _check_lists(f"{tag} {name}", a, b, 1e-6, 0.0,
                                    scale_rtol=1e-6))
    check_close(f"{tag} chunk sums of u^2", k[3], r[3], 1e-30, 1e-5)
    check_close(f"{tag} chunk sums of p^2", k[4], r[4], 1e-30, 1e-5)
    if int(noop) and not (_bitwise([k[1], k[2]], [ms, vs])
                          and not any(bool(u.any()) for u in k[0])):
        raise AssertionError(f"{tag}: noop=1 changed the moments or wrote a "
                             f"nonzero u")
    return err, k


# #20's dtype signatures (g, p): all nine
LAMB_SIGNATURES = tuple((g, p) for g in (torch.float32, torch.bfloat16,
                                         torch.float16)
                        for p in (torch.float32, torch.bfloat16,
                                  torch.float16))
LAMB_EDGE_SIZES = (1, 7, 8, 9, 65537)


def kernel_lamb_edges(rand):
    """#20 beyond BERT-large's list: tensors of 1, 7, 8, 9 and 65,537
    elements in each (g, p) signature in one list, at offset 0, with every
    list at storage offset 1 (a scalar head of 7), and with each list
    alone at storage offset 1 (no head aligns them: scalar), noop 1 and 0;
    then GPT-350M's 291 f32 tensors (one launch) and 2000 f32 tensors of
    1-70,000 elements, whose launch counts (the C entry's) must be
    ``lamb_stage1_launches``'s (more than one table for 2000)."""
    from apex_tpu_torch.ops import multi_tensor as K
    scal = lamb_stage1_scal()
    lists = ([], [], [], [])
    for gdt, pdt in LAMB_SIGNATURES:
        for n in LAMB_EDGE_SIZES:
            for lst, t in zip(lists, (rand(n, 1e-2).to(gdt),
                                      rand(n, 0.02).to(pdt), rand(n, 1e-4),
                                      rand(n, 1e-8).abs())):
                lst.append(t)
    tag = f"multi_tensor_lamb_stage1 {len(lists[0])} tensors of " \
          f"{LAMB_EDGE_SIZES}"
    err = 0.0
    for offsets in [(0,) * 5, (1,) * 5] + [
            tuple(int(i == j) for i in range(5)) for j in range(5)]:
        where = ("" if not any(offsets) else " at storage offset 1" if all(
            offsets) else f", {'gpmvu'[offsets.index(1)]} at storage offset 1")
        for noop_v in (1, 0):
            noop = torch.tensor(noop_v, dtype=torch.int32, device="cuda")
            err = max(err, _lamb_stage1_check(
                f"{tag}{where} noop={noop_v}", lists, scal, noop,
                offsets)[0])
    noop = torch.tensor(0, dtype=torch.int32, device="cuda")
    shapes = gpt350m_shapes()
    gpt = ([rand(s, 1e-3) for s in shapes], [rand(s, 0.02) for s in shapes],
           [rand(s, 1e-4) for s in shapes],
           [rand(s, 1e-8).abs() for s in shapes])
    err = max(err, _lamb_stage1_check(
        f"multi_tensor_lamb_stage1 GPT-350M's {len(shapes)} f32 tensors "
        f"({K.lamb_stage1_launches([s.numel() for s in shapes])} launch)",
        gpt, scal, noop)[0])
    del gpt
    sizes = np.random.RandomState(5).randint(1, 70001, 2000)
    long = ([rand(int(n), 1e-2) for n in sizes],
            [rand(int(n), 0.02) for n in sizes],
            [rand(int(n), 1e-4) for n in sizes],
            [rand(int(n), 1e-8).abs() for n in sizes])
    err = max(err, _lamb_stage1_check(
        f"multi_tensor_lamb_stage1 2000 tensors of 1-70000 elements "
        f"({K.lamb_stage1_launches(sizes)} launches)", long, scal, noop)[0])
    return err


def kernel_multi_tensor_lamb(gen_cuda):
    """#17, #15, #20 and #21 over BERT-large's O2 tensor list (299
    tensors: bf16 gradients for bf16 parameters, f32 for the LayerNorms;
    f32 masters and moments), each against its plain version."""
    from apex_tpu_torch.ops import multi_tensor as K
    specs = bert_param_specs()
    numels = [int(np.prod(s)) for s, _ in specs]
    n_el, launches = sum(numels), table_launches(numels)

    def rand(shape, std, positive=False):
        t = torch.randn(shape, generator=gen_cuda, device="cuda") * std
        return t.abs() if positive else t

    grads = [rand(s, 1e-3).to(dt) for s, dt in specs]
    # f32 masters hold bf16 values at the start, as amp O2 makes them
    masters = [rand(s, 0.02).to(dt).float() for s, dt in specs]
    copies = [None if dt == torch.float32 else torch.empty(s, dtype=dt,
                                                           device="cuda")
              for s, dt in specs]
    out = {}

    # #17: sums of squares, global and per tensor
    total, per, _ = K.multi_tensor_sumsq(grads, per_tensor=True)
    rtotal, rper, _ = K.multi_tensor_sumsq_reference(grads, per_tensor=True)
    torch.cuda.synchronize()
    # f32 sums of 335M squares in other orders (chunk partials, then a
    # fixed tree): 1e-5 relative
    err = check_close("multi_tensor_sumsq total", total, rtotal, 0, 1e-5)
    check_close("multi_tensor_sumsq per tensor", per, rper, 0, 1e-5)
    _check_found_inf("multi_tensor_sumsq",
                     lambda: K.multi_tensor_sumsq(grads)[2],
                     lambda: K.multi_tensor_sumsq_reference(grads)[2],
                     grads)
    before = K.multi_tensor_sumsq.launches
    K.multi_tensor_sumsq(grads)
    if K.multi_tensor_sumsq.launches - before != sumsq_launches(numels):
        raise AssertionError("multi_tensor_sumsq launch count")
    g_bytes = _nbytes(grads)
    out["sumsq"] = numbers(
        err, time_ms([lambda: K.multi_tensor_sumsq(grads)] * 5),
        time_ms([lambda: K.multi_tensor_sumsq_reference(grads)] * 2,
                rounds=3),
        time_ms([lambda: torch._foreach_norm(grads)] * 5),
        bound_ms(g_bytes, 2 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_sumsq(grads), iters=10))
    log_numbers(f"multi_tensor_sumsq {len(specs)} tensors, {n_el} "
                f"elements, {sumsq_launches(numels)} launches", out["sumsq"],
                "torch._foreach_norm")

    # #15: out = x * s into the gradients' dtypes (the unscale)
    scale = torch.full((), 2.0 ** -10, device="cuda")
    kout = [torch.empty_like(g) for g in grads]
    rout = [torch.empty_like(g) for g in grads]
    before = K.multi_tensor_scale_.launches
    K.multi_tensor_scale_(grads, kout, scale)
    n_scale = K.multi_tensor_scale_.launches - before
    K.multi_tensor_scale_reference(grads, rout, scale)
    torch.cuda.synchronize()
    if n_scale != K.scale_launches(numels):
        raise AssertionError(f"multi_tensor_scale_ made {n_scale} launches, "
                             f"scale_launches says "
                             f"{K.scale_launches(numels)}")
    # the same f32 product rounded once: one ulp of bf16 at most
    err = _check_lists("multi_tensor_scale_ bf16/f32 outputs", kout, rout,
                       2.0 ** -8, 0.0)
    _check_found_inf("multi_tensor_scale_",
                     lambda: K.multi_tensor_scale_(grads, kout, scale),
                     lambda: K.multi_tensor_scale_reference(grads, rout,
                                                            scale), grads)
    out["scale"] = numbers(
        err, time_ms([lambda: K.multi_tensor_scale_(grads, kout, scale)] * 5),
        time_ms([lambda: K.multi_tensor_scale_reference(grads, rout, scale)]
                * 2, rounds=3),
        time_ms([lambda: torch._foreach_mul(grads, scale)] * 5),
        bound_ms(2 * g_bytes, n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_scale_(grads, kout, scale), iters=10))
    log_numbers(f"multi_tensor_scale_ {len(specs)} tensors, {n_el} "
                f"elements, {n_scale} launch", out["scale"],
                "torch._foreach_mul")
    del kout, rout

    # #20: stage 1 at step 3, clip 0.5, noop 0 and 1
    scal = lamb_stage1_scal()
    ms = [rand(s, 1e-4) for s, _ in specs]
    vs = [rand(s, 1e-8, positive=True) for s, _ in specs]
    err = 0.0
    for noop_v in (1, 0):
        noop = torch.tensor(noop_v, dtype=torch.int32, device="cuda")
        e, (ku, km, kv, kusq, kpsq) = _lamb_stage1_check(
            f"multi_tensor_lamb_stage1 noop={noop_v}",
            (grads, masters, ms, vs), scal, noop)
        err = max(err, e)
    s1_bytes = _nbytes(grads) + 6 * 4 * n_el
    out["stage1"] = numbers(
        err, time_ms([lambda: K.multi_tensor_lamb_stage1(
            grads, masters, km, kv, ku, scal, noop)] * 5),
        time_ms([lambda: K.multi_tensor_lamb_stage1_reference(
            grads, masters, km, kv, ku, scal, noop)], rounds=3),
        None, bound_ms(s1_bytes, 20 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_lamb_stage1(
            grads, masters, km, kv, ku, scal, noop), iters=10))
    log_numbers(f"multi_tensor_lamb_stage1 {len(specs)} tensors",
                out["stage1"], "no library call")
    del km, kv

    # #21: stage 2 on stage 1's u and partials, masters and bf16 copies
    lr = torch.full((), BERT_LR, device="cuda")
    err = 0.0
    for noop_v in (1, 0):
        noop = torch.tensor(noop_v, dtype=torch.int32, device="cuda")
        kp, rp = [t.clone() for t in masters], [t.clone() for t in masters]
        kc = [None if c is None else torch.zeros_like(c) for c in copies]
        rc = [None if c is None else torch.zeros_like(c) for c in copies]
        before = K.multi_tensor_lamb_stage2.launches
        K.multi_tensor_lamb_stage2(ku, kp, kc, kusq, kpsq, lr, noop)
        n_launch = K.multi_tensor_lamb_stage2.launches - before
        K.multi_tensor_lamb_stage2_reference(ku, rp, rc, kusq, kpsq, lr,
                                             noop)
        torch.cuda.synchronize()
        if n_launch != launches:
            raise AssertionError(f"multi_tensor_lamb_stage2 made {n_launch} "
                                 f"launches, the table rule says {launches}")
        tag = f"multi_tensor_lamb_stage2 noop={noop_v}"
        err = max(err, _check_lists(f"{tag} masters", kp, rp, 1e-6, 0.0,
                                    scale_rtol=1e-6))
        # the model copy is the new master rounded to nearest even, on both
        # sides (under noop: unchanged)
        for side, ps, cs in (("kernel", kp, kc), ("plain", rp, rc)):
            want = [None if c is None else (torch.zeros_like(c) if noop_v
                                            else p.to(c.dtype))
                    for p, c in zip(ps, cs)]
            _check_lists(f"{tag} {side} bf16 copies vs its masters", cs, want,
                         0.0, 0.0)
        if noop_v and not all(torch.equal(a, b) for a, b in zip(kp, masters)):
            raise AssertionError("multi_tensor_lamb_stage2 noop=1 changed "
                                 "the parameters")
        del rp, rc
    s2_bytes = 3 * 4 * n_el + _nbytes(kc)
    out["stage2"] = numbers(
        err, time_ms([lambda: K.multi_tensor_lamb_stage2(
            ku, kp, kc, kusq, kpsq, lr, noop)] * 5),
        time_ms([lambda: K.multi_tensor_lamb_stage2_reference(
            ku, kp, kc, kusq, kpsq, lr, noop)] * 2, rounds=3),
        None, bound_ms(s2_bytes, 3 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_lamb_stage2(
            ku, kp, kc, kusq, kpsq, lr, noop), iters=10))
    log_numbers(f"multi_tensor_lamb_stage2 {len(specs)} tensors",
                out["stage2"], "no library call")
    for n in out.values():
        n["tensors"], n["elements"], n["launches_per_call"] = (
            len(specs), n_el, launches)
    out["sumsq"]["launches_per_call"] = sumsq_launches(numels)
    out["scale"]["launches_per_call"] = K.scale_launches(numels)
    out["stage1"]["launches_per_call"] = K.lamb_stage1_launches(numels)
    out["stage1"]["edges_max_abs_err"] = kernel_lamb_edges(rand)
    del grads, masters, copies, ku, kp, kc
    torch.cuda.empty_cache()
    out["scale"].update(kernel_scale_shapes(rand, specs))
    out["scale"]["edges_max_abs_err"] = kernel_scale_edges(rand)
    return out


# #15's (in, out) dtype pairs: all nine
SCALE_PAIRS = LAMB_SIGNATURES
SCALE_EDGE_SIZES = (1, 7, 8, 9, 33, 65537)
# csrc/multi_tensor_list.cuh's head code of lists that no scalar head aligns
LIST_NO_VECTOR = 8


def list_vector_head(tensors):
    """csrc/multi_tensor_list.cuh's ``vector_head`` of one position of a
    whole-list kernel's lists: the fewest leading elements (0-7) after
    which every tensor's address is a multiple of 16 bytes, or
    ``LIST_NO_VECTOR`` when no count aligns them all."""
    for h in range(8):
        if all((t.data_ptr() + h * t.element_size()) % 16 == 0
               for t in tensors):
            return h
    return LIST_NO_VECTOR


def scale_region(i, n, head):
    """Where #15 takes element ``i`` of an ``n``-element tensor whose
    scalar head is ``head``: "head", "vector" (the 16-byte steps) or
    "tail", as ``scale_chunk`` splits each chunk."""
    from apex_tpu_torch.ops.multi_tensor import SCALE_CHUNK
    s = i // SCALE_CHUNK * SCALE_CHUNK
    e = min(n, s + SCALE_CHUNK)
    vs = e if head == LIST_NO_VECTOR else min(e, s + head)
    ve = vs + 8 * ((e - vs) // 8)
    return "head" if i < vs else "vector" if i < ve else "tail"


def _same_nonfinite(a, b):
    """The non-finite entries of a and b at the same places: NaN for NaN,
    each inf of the same sign."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.isposinf(), b.isposinf())
            and torch.equal(a.isneginf(), b.isneginf()))


def _scale_check(tag, xs, out_dtypes, scale, offsets=(0, 0), in_place=False,
                 want_flag=0.0):
    """#15 on copies of ``xs`` (at storage offset ``offsets[0]``) into new
    tensors of ``out_dtypes`` (at ``offsets[1]``), or in place, against its
    plain version, and the kernel again: launches as ``scale_launches``
    says; the found-inf flags ``want_flag`` on every side; non-finite
    outputs at the same places on both sides; the finite ones within 2**-8
    relative (the same f32 product rounded once to the output's dtype: one
    ulp of bf16 at most); the repeat bitwise the first run, NaNs included.
    Returns (the max error, each tensor's scalar head, None for an empty
    one)."""
    from apex_tpu_torch.ops import multi_tensor as K
    want = K.scale_launches([x.numel() for x in xs])
    sides = []
    for f in (K.multi_tensor_scale_, K.multi_tensor_scale_reference,
              K.multi_tensor_scale_):
        ins = [_at_offset(x, offsets[0]) for x in xs]
        outs = ins if in_place else [
            _at_offset(torch.empty_like(x, dtype=dt), offsets[1])
            for x, dt in zip(xs, out_dtypes)]
        before = K.multi_tensor_scale_.launches
        flag = float(f(ins, outs, scale))
        sides.append((outs, flag, K.multi_tensor_scale_.launches - before))
        if len(sides) == 1:
            heads = [list_vector_head((i, o)) if i.numel() else None
                     for i, o in zip(ins, outs)]
    torch.cuda.synchronize()
    (k, fk, nk), (r, fr, nr), (k2, fk2, nk2) = sides
    if (nk, nr, nk2) != (want, 0, want):
        raise AssertionError(f"{tag}: launches {nk} / {nk2} (plain {nr}), "
                             f"scale_launches says {want}")
    if (fk, fr, fk2) != (want_flag,) * 3:
        raise AssertionError(f"{tag}: found-inf kernel {fk} / {fk2}, plain "
                             f"{fr}, expected {want_flag}")
    if not _bitwise([k], [k2]):
        raise AssertionError(f"{tag}: a repeat differs")
    if not all(_same_nonfinite(a, b) for a, b in zip(k, r)):
        raise AssertionError(f"{tag}: non-finite outputs differ from the "
                             f"plain version's")
    finite = [[t.masked_fill(~torch.isfinite(t), 0) for t in side
               if t.numel()] for side in (k, r)]
    return _check_lists(tag, *finite, 2.0 ** -8, 0.0), heads


def kernel_scale_edges(rand):
    """#15 beyond the paths' lists: tensors of 1, 7, 8, 9, 33 and 65,537
    elements (and an empty one) in all nine (in, out) dtype pairs in one
    list, with both lists at storage offsets 0-7 (every scalar head 0-7)
    and with one list alone at offset 1 (no head aligns them: scalar); in
    place for the three pairs of one dtype; inf, -inf and NaN in a head, a
    16-byte step and a tail, and in a scalar-only tensor, each setting the
    flag; an f32 product that overflows f16 only (no flag) and one that
    overflows f32 (flag); then 2000 tensors of 1-70,000 elements, whose
    launches (the C entry's) must be ``scale_launches``'s (two tables),
    clean and with an inf in the last tensor.  Returns the largest
    error."""
    from apex_tpu_torch.ops import multi_tensor as K
    s37 = torch.full((), 0.37, device="cuda")
    xs, odts = [], []
    for idt, odt in SCALE_PAIRS:
        for n in SCALE_EDGE_SIZES:
            xs.append(rand(n, 1.0).to(idt))
            odts.append(odt)
    xs.insert(3, rand(0, 1.0))
    odts.insert(3, torch.float32)
    tag = f"multi_tensor_scale_ {len(xs)} tensors of {SCALE_EDGE_SIZES} " \
          f"and 0, nine (in, out) pairs"
    err, heads = 0.0, set()
    for offsets in [(o, o) for o in range(8)] + [(1, 0), (0, 1)]:
        e, h = _scale_check(f"{tag}, storage offsets {offsets}", xs, odts,
                            s37, offsets)
        err, heads = max(err, e), heads | set(h) - {None}
    log(f"  multi_tensor_scale_ scalar heads taken: {sorted(heads)} "
        f"({LIST_NO_VECTOR}: none aligns, scalar)")
    if heads != set(range(LIST_NO_VECTOR + 1)):
        raise AssertionError("multi_tensor_scale_: a scalar head was not "
                             "exercised")
    same = [x for x, dt in zip(xs, odts) if x.dtype == dt]
    for o in (0, 3):
        err = max(err, _scale_check(
            f"multi_tensor_scale_ in place, {len(same)} tensors of one "
            f"dtype each, storage offset {o}", same, [x.dtype for x in same],
            s37, (o, o), in_place=True)[0])
    n = SCALE_EDGE_SIZES[-1]
    for idt, odt in ((torch.bfloat16, torch.bfloat16),
                     (torch.float32, torch.float16)):
        x0 = rand(n, 1.0).to(idt)
        for offsets, i, where in (((3, 3), 2, "head"), ((3, 3), 100, "vector"),
                                  ((3, 3), n - 3, "tail"),
                                  ((1, 0), 40000, "head")):
            for v in (float("inf"), float("-inf"), float("nan")):
                x = x0.clone()
                x[i] = v
                t = (f"multi_tensor_scale_ {str(idt)[6:]} -> {str(odt)[6:]} "
                     f"{v} at {i} of {n}, storage offsets {offsets}")
                e, (_, h, _) = _scale_check(
                    t, [xs[0], x, xs[-1]], [odts[0], odt, odts[-1]], s37,
                    offsets, want_flag=1.0)
                if scale_region(i, n, h) != where:
                    raise AssertionError(f"{t}: element {i} is in the "
                                         f"{scale_region(i, n, h)}, not the "
                                         f"{where} (head {h})")
                err = max(err, e)
    log("  multi_tensor_scale_ inf / -inf / NaN in a head, a 16-byte step, "
        "a tail and a scalar-only tensor: flag 1.0 on both sides ok")
    two = torch.full((), 2.0, device="cuda")
    big = torch.full((9,), 6e4, device="cuda")
    _scale_check("multi_tensor_scale_ 6e4 * 2 into f16 (finite in f32)",
                 [big], [torch.float16], two)
    _scale_check("multi_tensor_scale_ 3e38 * 2 into bf16 (inf in f32)",
                 [big * 5e33], [torch.bfloat16], two, want_flag=1.0)
    sizes = np.random.RandomState(5).randint(1, 70001, 2000)
    long = [rand(int(m), 1.0) for m in sizes]
    t = f"multi_tensor_scale_ 2000 tensors of 1-70000 elements " \
        f"({K.scale_launches(sizes)} launches)"
    err = max(err, _scale_check(t, long, [torch.bfloat16] * len(long),
                                s37)[0])
    long[-1][-1] = float("inf")
    err = max(err, _scale_check(t + ", an inf in the last", long,
                                [torch.bfloat16] * len(long), s37,
                                want_flag=1.0)[0])
    return err


def kernel_scale_shapes(rand, bert_specs):
    """#15 at two more shapes its callers give it, each against its plain
    version with its launches (``scale_launches``): FusedAdam's copy of
    GPT-350M's 291 f32 masters into bf16 model copies
    (``master_weights=True``), and apex's fp16 O2 unscale, f16 gradients
    into f32 at BERT-large's sizes.  No single PyTorch call scales with a
    cast: no library time."""
    from apex_tpu_torch.ops import multi_tensor as K
    cases = (
        ("master_copy_gpt350m", "GPT-350M's f32 masters into bf16 copies",
         lambda: [rand(s, 0.02) for s in gpt350m_shapes()], torch.bfloat16,
         1.0),
        ("f16_unscale_bert_large", "BERT-large's gradients f16 into f32",
         lambda: [rand(s, 1.0).half() for s, _ in bert_specs],
         torch.float32, 2.0 ** -10))
    res = {}
    for key, name, make, odt, sv in cases:
        s = torch.full((), sv, device="cuda")
        xs = make()
        kout = [torch.empty_like(x, dtype=odt) for x in xs]
        rout = [torch.empty_like(x, dtype=odt) for x in xs]
        numels = [x.numel() for x in xs]
        before = K.multi_tensor_scale_.launches
        flag = float(K.multi_tensor_scale_(xs, kout, s))
        n_launch = K.multi_tensor_scale_.launches - before
        rflag = float(K.multi_tensor_scale_reference(xs, rout, s))
        torch.cuda.synchronize()
        if n_launch != K.scale_launches(numels) or (flag, rflag) != (0, 0):
            raise AssertionError(f"multi_tensor_scale_ {name}: launches "
                                 f"{n_launch} (scale_launches says "
                                 f"{K.scale_launches(numels)}), found-inf "
                                 f"{flag} / plain {rflag}")
        err = _check_lists(f"multi_tensor_scale_ {name}", kout, rout,
                           2.0 ** -8, 0.0)
        n_el = sum(numels)
        res[key] = numbers(
            err, time_ms([lambda: K.multi_tensor_scale_(xs, kout, s)] * 5),
            time_ms([lambda: K.multi_tensor_scale_reference(xs, rout, s)]
                    * 2, rounds=3), None,
            bound_ms(_nbytes(xs) + _nbytes(kout), n_el, PEAK_F32_FLOPS),
            call_ms(lambda: K.multi_tensor_scale_(xs, kout, s), iters=10))
        res[key].update(tensors=len(xs), elements=n_el,
                        launches_per_call=n_launch)
        log_numbers(f"multi_tensor_scale_ {name}: {len(xs)} tensors, {n_el} "
                    f"elements, {n_launch} launch", res[key],
                    "no library call")
        del xs, kout, rout
        torch.cuda.empty_cache()
    return res


def gpt350m_shapes():
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    return [p.shape for p in GPTModel(GPTConfig(**GPT350M),
                                      device="meta").parameters()]


def resnet50_specs(opt_level):
    """(shape, dtype) of ResNet-50's 161 parameters under ``amp.initialize``
    at ``opt_level``: f32 at O1, bf16 with f32 batch norms at O2."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.resnet import resnet50
    model = resnet50(device="meta", dtype=torch.bfloat16
                     if opt_level == "O2" else torch.float32)
    amp.initialize(model, None, opt_level=opt_level)
    return [(tuple(p.shape), p.dtype) for p in model.parameters()]


def opt_launches(kernel, numels):
    """Launches of one call of a multi-tensor optimizer kernel over tensors
    of these sizes: #19 by its own table (``sgd_launches``), the others by
    ``csrc/multi_tensor.cuh``'s."""
    from apex_tpu_torch.ops import multi_tensor as K
    return (K.sgd_launches(numels) if kernel is K.multi_tensor_sgd
            else table_launches(numels))


def _opt_kernel_check(tag, kernel, plain, run, params, state, copies,
                      numels):
    """``run(f, params, state, copies, noop)`` with ``f`` the kernel's
    wrapper against the same with its plain version, on clones of the same
    tensors, noop 1 then 0 (#19: and the kernel again, which must repeat
    its first run bit for bit): exact launches (``opt_launches``); f32
    params and state within 1e-6 relative plus 1e-6 of each tensor's
    largest entry (FMA contraction on the card rounds a product-sum once
    where the plain version rounds twice); each side's model copies equal
    its params rounded to nearest even (unchanged under noop); under noop
    nothing moves.  Returns the largest error."""
    from apex_tpu_torch.ops import multi_tensor as K
    err = 0.0
    want_launches = opt_launches(kernel, numels)
    repeat = kernel is K.multi_tensor_sgd
    for noop_v in (1, 0):
        noop = torch.tensor(noop_v, dtype=torch.int32, device="cuda")
        sides = []
        for f in (kernel, plain) + ((kernel,) if repeat else ()):
            kp = [t.clone() for t in params]
            ks = [t.clone() for t in state]
            kc = [None if c is None else torch.zeros_like(c) for c in copies]
            before = kernel.launches
            run(f, kp, ks, kc, noop)
            sides.append((kp, ks, kc, kernel.launches - before))
        torch.cuda.synchronize()
        (kp, ks, kc, n_launch), (rp, rs, rc, n_plain) = sides[:2]
        if n_launch != want_launches or n_plain:
            raise AssertionError(f"{tag} made {n_launch} launches (plain "
                                 f"{n_plain}), the table rule says "
                                 f"{want_launches}")
        if repeat and not _bitwise(sides[0][:3], sides[2][:3]):
            raise AssertionError(f"{tag} noop={noop_v}: a repeat differs")
        t = f"{tag} noop={noop_v}"
        err = max(err, _check_lists(f"{t} params", kp, rp, 1e-6, 0.0,
                                    scale_rtol=1e-6))
        _check_lists(f"{t} state", ks, rs, 1e-6, 0.0, scale_rtol=1e-6)
        for side, ps, cs in (("kernel", kp, kc), ("plain", rp, rc)):
            want = [None if c is None else (torch.zeros_like(c) if noop_v
                                            else p.to(c.dtype))
                    for p, c in zip(ps, cs)]
            if any(c is not None for c in cs):
                _check_lists(f"{t} {side} copies vs its params", cs, want,
                             0.0, 0.0)
        if noop_v and not (all(torch.equal(a, b) for a, b in zip(kp, params))
                           and all(torch.equal(a, b)
                                   for a, b in zip(ks, state))):
            raise AssertionError(f"{tag} noop=1 changed the parameters or "
                                 f"the state")
        del sides, kp, ks, kc, rp, rs, rc
    return err


def _bitwise(a, b):
    """Lists of lists of tensors (or None) equal bit for bit (NaNs
    included, which ``torch.equal`` tells apart)."""
    return all(x is y or (x is not None and y is not None and x.dtype
                          == y.dtype and x.shape == y.shape and torch.equal(
                              x.reshape(-1).view(torch.uint8),
                              y.reshape(-1).view(torch.uint8)))
               for la, lb in zip(a, b) for x, y in zip(la, lb))


def _mixed_opt_lists(rand):
    """40 tensors crossing the 36-tensor table limit and the chunk
    carry-over: bf16 / f16 grads of f32 masters with bf16 / f16 model
    copies, and f32 parameters without one."""
    sizes = [70000, 65536, 1, 3, 200000, 129] * 7
    out = []
    for i, n in enumerate(sizes[:40]):
        cdt = (torch.bfloat16, torch.float16, None)[i % 3]
        gdt = cdt or torch.float32
        master = rand(n, 0.02)
        if cdt is not None:
            master = master.to(cdt).float()
        out.append((rand(n, 1e-2).to(gdt), master,
                    None if cdt is None else master.to(cdt)))
    return out


# #19's dtype signatures (g, p, copy) as the optimizers pass them
SGD_SIGNATURES = ((torch.float32, torch.float32, None),
                  (torch.bfloat16, torch.float32, torch.bfloat16),
                  (torch.float16, torch.float32, torch.float16),
                  (torch.bfloat16, torch.bfloat16, None),
                  (torch.float16, torch.float16, None))
SGD_EDGE_SIZES = (1, 7, 64, 65537)
# a 16-bit parameter updated in place: the kernel's f32 value may differ
# from the plain version's in its last bit (FMA contraction), and a value
# next to a rounding midpoint then rounds to the neighbour: one ulp of the
# parameter's type, at most 2**-7 (bf16) or 2**-10 (f16) of the value
SGD_P_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7,
              torch.float16: 2.0 ** -10}


def _at_offset(t, off):
    """A copy of ``t`` that starts ``off`` elements into its own storage
    (off the 16-byte grid for ``off`` = 1)."""
    if t is None:
        return None
    v = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)[off:]
    return v.view(t.shape).copy_(t)


def _sgd_edge_check(tag, lists, offsets=(0, 0, 0, 0), **flags):
    """#19 on copies of ``lists`` (g, p, buf, copies; each list at its
    storage offset) against its plain version, noop 1 then 0, and the
    kernel again: launches as ``sgd_launches`` says, one per call when the
    C entry counts them; under noop nothing moves, bit for bit; p within
    ``SGD_P_RTOL`` of its type + 1e-6 of the tensor's largest entry, buf
    within 1e-6 relative + 1e-6 of its largest entry; each side's copies
    its p rounded to nearest even; with ``momentum_zero`` buf untouched,
    bit for bit; the repeat bitwise the first run."""
    from apex_tpu_torch.ops import multi_tensor as K
    scal = torch.tensor([0.1, 1e-4, 0.9, 0.1, 0.5], device="cuda")
    numels = [p.numel() for p in lists[1]]
    err = 0.0
    for noop_v in (1, 0):
        noop = torch.tensor(noop_v, dtype=torch.int32, device="cuda")
        sides = []
        for f in (K.multi_tensor_sgd, K.multi_tensor_sgd_reference,
                  K.multi_tensor_sgd):
            side = [[_at_offset(t, o) for t in lst]
                    for lst, o in zip(lists, offsets)]
            before = K.multi_tensor_sgd.launches
            f(*side, scal, noop, **flags)
            sides.append((side, K.multi_tensor_sgd.launches - before))
        torch.cuda.synchronize()
        (k, n_k), (r, n_r), (k2, n_k2) = sides
        t = f"{tag} noop={noop_v}"
        want = K.sgd_launches(numels)
        if (n_k, n_r, n_k2) != (want, 0, want):
            raise AssertionError(f"{t}: launches {n_k} / {n_k2} (plain "
                                 f"{n_r}), sgd_launches says {want}")
        if not _bitwise(k, k2):
            raise AssertionError(f"{t}: a repeat differs")
        if noop_v or flags.get("momentum_zero"):
            moved = [j for j in ((0, 1, 2, 3) if noop_v else (2,))
                     if not _bitwise([k[j]], [lists[j]])]
            if moved:
                raise AssertionError(f"{t}: lists {moved} changed")
        if noop_v:
            continue
        for dt in {p.dtype for p in lists[1]}:
            pick = [i for i, p in enumerate(lists[1]) if p.dtype == dt]
            err = max(err, _check_lists(
                f"{t} {str(dt)[6:]} params", [k[1][i] for i in pick],
                [r[1][i] for i in pick], SGD_P_RTOL[dt], 0.0,
                scale_rtol=1e-6))
        _check_lists(f"{t} buffers", k[2], r[2], 1e-6, 0.0, scale_rtol=1e-6)
        for side, (ps, cs) in (("kernel", k[1::2]), ("plain", r[1::2])):
            if any(c is not None for c in cs):
                _check_lists(f"{t} {side} copies vs its params", cs,
                             [None if c is None else p.to(c.dtype)
                              for p, c in zip(ps, cs)], 0.0, 0.0)
        del sides, k, r, k2
    return err


def kernel_sgd_edges(rand):
    """#19 beyond the paths' lists: tensors of 1, 7, 64 and 65,537
    elements in every signature of ``SGD_SIGNATURES`` in one list, at
    offset 0, with every list at storage offset 1 (a scalar head of 7 or
    3), with only g off the grid (no head aligns g and p: scalar), under
    ``momentum_zero`` and under nesterov + first_run + wd_after_momentum;
    then 2000 f32 tensors of 1-70,000 elements, whose launch count (the C
    entry's) must be ``sgd_launches``'s (more than one table)."""
    from apex_tpu_torch.ops import multi_tensor as K
    gs, ps, bs, cs = [], [], [], []
    for gdt, pdt, cdt in SGD_SIGNATURES:
        for n in SGD_EDGE_SIZES:
            p = rand(n, 0.02)
            if cdt is not None:
                p = p.to(cdt).float()
            gs.append(rand(n, 1e-2).to(gdt))
            ps.append(p.to(pdt))
            bs.append(rand(n, 1e-2))
            cs.append(None if cdt is None else p.to(cdt))
    lists = (gs, ps, bs, cs)
    tag = f"multi_tensor_sgd {len(ps)} tensors of {SGD_EDGE_SIZES}"
    err = _sgd_edge_check(tag, lists)
    err = max(err, _sgd_edge_check(tag + " at storage offset 1", lists,
                                   offsets=(1, 1, 1, 1)))
    err = max(err, _sgd_edge_check(tag + ", g at storage offset 1", lists,
                                   offsets=(1, 0, 0, 0)))
    err = max(err, _sgd_edge_check(tag + " momentum_zero", lists,
                                   momentum_zero=True))
    err = max(err, _sgd_edge_check(
        tag + " nesterov first_run wd_after_momentum", lists,
        nesterov=True, first_run=True, wd_after_momentum=True))
    sizes = np.random.RandomState(5).randint(1, 70001, 2000)
    long = ([rand(int(n), 1e-2) for n in sizes],
            [rand(int(n), 0.02) for n in sizes],
            [rand(int(n), 1e-2) for n in sizes], [None] * len(sizes))
    err = max(err, _sgd_edge_check(
        f"multi_tensor_sgd 2000 tensors of 1-70000 elements "
        f"({K.sgd_launches(sizes)} launches)", long))
    return err


def kernel_optimizers(gen_cuda):
    """#16, #19, #22 and #23 against their plain versions over GPT-350M's
    f32 parameter list (291 tensors, as #18), a mixed-dtype list with
    master weights and model copies, and over ResNet-50's lists as its
    paths run them: #19 at O1 (f32) and O2 (bf16 with f32 masters and
    copies, f32 batch norm), #16 in place at O1 (the hand-written SGD), #22
    and #23 at O2 (phase 9c)."""
    from apex_tpu_torch.ops import multi_tensor as K
    shapes = gpt350m_shapes()
    numels = [int(np.prod(s)) for s in shapes]
    n_el = sum(numels)

    def rand(shape, std, positive=False):
        t = torch.randn(shape, generator=gen_cuda, device="cuda") * std
        return t.abs() + 1e-3 if positive else t

    out = {}
    noop0 = torch.tensor(0, dtype=torch.int32, device="cuda")
    sgd_scal = torch.tensor([0.1, 1e-4, 0.9, 0.0, 0.5], device="cuda")
    ada_scal = torch.tensor([1e-2, 1e-10, 1e-4, 0.5], device="cuda")
    # NovoGrad at step 3: lr with the bias corrections folded in
    nv_scal = torch.tensor([1e-3 * (1 - 0.98 ** 3) ** 0.5 / (1 - 0.95 ** 3),
                            0.95, 1e-3, 1e-8, 0.5, 0.05], device="cuda")
    runs = {
        "sgd": (K.multi_tensor_sgd, K.multi_tensor_sgd_reference,
                lambda g, p, s, c, n, f: f(g, p, s, c, sgd_scal, n),
                dict(std=1e-3, positive=False)),
        "sgd_nesterov_wd_after": (
            K.multi_tensor_sgd, K.multi_tensor_sgd_reference,
            lambda g, p, s, c, n, f: f(g, p, s, c, sgd_scal, n,
                                       nesterov=True, wd_after_momentum=True),
            dict(std=1e-3, positive=False)),
        "adagrad": (K.multi_tensor_adagrad, K.multi_tensor_adagrad_reference,
                    lambda g, p, s, c, n, f: f(g, p, s, c, ada_scal, n),
                    dict(std=1e-4, positive=True)),
        "adagrad_w_mode": (
            K.multi_tensor_adagrad, K.multi_tensor_adagrad_reference,
            lambda g, p, s, c, n, f: f(g, p, s, c, ada_scal, n, True),
            dict(std=1e-4, positive=True)),
    }

    # the mixed list: masters and copies, every optimizer kernel
    mixed = _mixed_opt_lists(rand)
    mg, mp, mc = (list(x) for x in zip(*mixed))
    m_numels = [t.numel() for t in mp]
    for name, (kern, plain, call, st) in runs.items():
        ms = [rand(t.numel(), st["std"], st["positive"]) for t in mp]
        _opt_kernel_check(
            f"{kern.__name__} ({name}) {len(mp)} mixed tensors", kern, plain,
            lambda f, p, s, c, n, _c=call: _c(mg, p, s, c, n, f),
            mp, ms, mc, m_numels)
    v_mixed = rand(len(mp), 1e-4, positive=True)
    ms = [rand(t.numel(), 1e-4) for t in mp]
    _opt_kernel_check(
        f"multi_tensor_novograd {len(mp)} mixed tensors",
        K.multi_tensor_novograd, K.multi_tensor_novograd_reference,
        lambda f, p, s, c, n: f(mg, p, s, c, v_mixed, nv_scal, n, True),
        mp, ms, mc, m_numels)
    del mixed, mg, mp, mc, ms
    out["sgd_edges_max_abs_err"] = kernel_sgd_edges(rand)
    torch.cuda.empty_cache()

    # #16 axpby over the GPT list (f32), then a bf16 output
    xs = [rand(s, 1e-2) for s in shapes]
    ys = [rand(s, 1e-2) for s in shapes]
    kout = [torch.empty_like(x) for x in xs]
    rout = [torch.empty_like(x) for x in xs]
    before = K.multi_tensor_axpby_.launches
    K.multi_tensor_axpby_(xs, ys, kout, 0.9, -0.3)
    n_launch = K.multi_tensor_axpby_.launches - before
    K.multi_tensor_axpby_reference(xs, ys, rout, 0.9, -0.3)
    torch.cuda.synchronize()
    if n_launch != table_launches(numels):
        raise AssertionError("multi_tensor_axpby_ launch count")
    # a x + b y: FMA contraction rounds once where the plain version
    # rounds twice; where the two terms cancel that is an ulp of the terms
    err = _check_lists("multi_tensor_axpby_ f32", kout, rout, 1e-6, 0.0,
                       scale_rtol=1e-6)
    kb = [torch.empty_like(x, dtype=torch.bfloat16) for x in xs[:40]]
    rb = [torch.empty_like(x, dtype=torch.bfloat16) for x in xs[:40]]
    K.multi_tensor_axpby_(xs[:40], ys[:40], kb, 0.9, -0.3)
    K.multi_tensor_axpby_reference(xs[:40], ys[:40], rb, 0.9, -0.3)
    # the two f32 values may differ in their last bits (above), and a value
    # near a bf16 rounding midpoint then rounds to the neighbour: one bf16
    # ulp, up to 2**-7 of the result
    _check_lists("multi_tensor_axpby_ f32 -> bf16 outputs (one bf16 ulp)",
                 kb, rb, 2.0 ** -7, 0.0, scale_rtol=1e-6)
    del kb, rb
    _check_found_inf("multi_tensor_axpby_",
                     lambda: K.multi_tensor_axpby_(xs, ys, kout, 0.9, -0.3),
                     lambda: K.multi_tensor_axpby_reference(xs, ys, rout,
                                                            0.9, -0.3), xs)
    out["axpby"] = numbers(
        err, time_ms([lambda: K.multi_tensor_axpby_(xs, ys, kout, 0.9, -0.3)]
                     * 5),
        time_ms([lambda: K.multi_tensor_axpby_reference(xs, ys, rout, 0.9,
                                                        -0.3)] * 2, rounds=3),
        None, bound_ms(3 * 4 * n_el, 3 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_axpby_(xs, ys, kout, 0.9, -0.3),
                iters=10))
    log_numbers(f"multi_tensor_axpby_ {len(shapes)} tensors, {n_el} "
                f"elements, {table_launches(numels)} launches", out["axpby"],
                "no single library call for a x + b y")
    del xs, ys, kout, rout
    torch.cuda.empty_cache()

    # #19, #22, #23 over the GPT list (f32 g, p and state)
    gs = [rand(s, 1e-3) for s in shapes]
    ps = [rand(s, 0.02) for s in shapes]
    none = [None] * len(shapes)
    for name, (kern, plain, call, st) in runs.items():
        ss = [rand(s, st["std"], st["positive"]) for s in shapes]
        err = _opt_kernel_check(
            f"{kern.__name__} ({name}) {len(shapes)} tensors", kern, plain,
            lambda f, p, s, c, n, _c=call: _c(gs, p, s, c, n, f),
            ps, ss, none, numels)
        if name in ("sgd", "adagrad"):
            lib_ps = [torch.nn.Parameter(p.clone()) for p in ps]
            for p, g in zip(lib_ps, gs):
                p.grad = g
            lib = (torch.optim.SGD(lib_ps, lr=0.1, momentum=0.9,
                                   weight_decay=1e-4, fused=True)
                   if name == "sgd" else
                   torch.optim.Adagrad(lib_ps, lr=1e-2, weight_decay=1e-4,
                                       foreach=True))
            lib.step()
            out[name] = numbers(
                err, time_ms([lambda: call(gs, ps, ss, none, noop0, kern)]
                             * 5),
                time_ms([lambda: call(gs, ps, ss, none, noop0, plain)] * 2,
                        rounds=3),
                call_ms(lib.step, iters=10),
                bound_ms(5 * 4 * n_el, 10 * n_el, PEAK_F32_FLOPS),
                call_ms(lambda: call(gs, ps, ss, none, noop0, kern),
                        iters=10))
            lib_name = ("SGD(fused=True).step (eager)" if name == "sgd"
                        else "Adagrad(foreach=True).step (eager)")
            log_numbers(f"{kern.__name__} {len(shapes)} tensors, {n_el} "
                        f"elements, {opt_launches(kern, numels)} launches",
                        out[name], lib_name)
            del lib, lib_ps
        del ss
        torch.cuda.empty_cache()
    v = rand(len(shapes), 1e-6, positive=True)
    ms = [rand(s, 1e-4) for s in shapes]
    for reg in (False, True):
        err = _opt_kernel_check(
            f"multi_tensor_novograd (reg_inside_moment={reg}) "
            f"{len(shapes)} tensors", K.multi_tensor_novograd,
            K.multi_tensor_novograd_reference,
            lambda f, p, s, c, n, _r=reg: f(gs, p, s, c, v, nv_scal, n, _r),
            ps, ms, none, numels)
    out["novograd"] = numbers(
        err, time_ms([lambda: K.multi_tensor_novograd(gs, ps, ms, none, v,
                                                      nv_scal, noop0)] * 5),
        time_ms([lambda: K.multi_tensor_novograd_reference(
            gs, ps, ms, none, v, nv_scal, noop0)] * 2, rounds=3),
        None, bound_ms(5 * 4 * n_el + 4 * len(shapes), 10 * n_el,
                       PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_novograd(gs, ps, ms, none, v, nv_scal,
                                                noop0), iters=10))
    log_numbers(f"multi_tensor_novograd {len(shapes)} tensors, {n_el} "
                f"elements, {table_launches(numels)} launches",
                out["novograd"], "no single library call")
    del gs, ps, ms
    torch.cuda.empty_cache()
    for n in (out["axpby"], out["sgd"], out["adagrad"], out["novograd"]):
        n["tensors"], n["elements"] = len(shapes), n_el
        n["launches_per_call"] = table_launches(numels)
    out["sgd"]["launches_per_call"] = K.sgd_launches(numels)

    # #19 over ResNet-50's lists, as phase 9 steps them
    for level in ("O1", "O2"):
        specs = resnet50_specs(level)
        r_numels = [int(np.prod(s)) for s, _ in specs]
        gs = [rand(s, 1e-3).to(dt) for s, dt in specs]
        masters = [rand(s, 0.05).to(dt).float() for s, dt in specs]
        copies = [None if dt == torch.float32 else m.to(dt)
                  for m, (_, dt) in zip(masters, specs)]
        bufs = [rand(s, 1e-3) for s, _ in specs]
        err = _opt_kernel_check(
            f"multi_tensor_sgd ResNet-50 {level} {len(specs)} tensors",
            K.multi_tensor_sgd, K.multi_tensor_sgd_reference,
            lambda f, p, s, c, n: f(gs, p, s, c, sgd_scal, n),
            masters, bufs, copies, r_numels)
        r_el = sum(r_numels)
        lib_ps = [torch.nn.Parameter(m.clone()) for m in masters]
        for p, g in zip(lib_ps, gs):
            p.grad = g.float()
        lib = torch.optim.SGD(lib_ps, lr=0.1, momentum=0.9,
                              weight_decay=1e-4, fused=True)
        lib.step()
        key = f"sgd_resnet50_{level}"
        out[key] = numbers(
            err, time_ms([lambda: K.multi_tensor_sgd(
                gs, masters, bufs, copies, sgd_scal, noop0)] * 5),
            time_ms([lambda: K.multi_tensor_sgd_reference(
                gs, masters, bufs, copies, sgd_scal, noop0)] * 2, rounds=3),
            call_ms(lib.step, iters=10),
            bound_ms(_nbytes(gs) + 4 * 4 * r_el + _nbytes(copies),
                     10 * r_el, PEAK_F32_FLOPS),
            call_ms(lambda: K.multi_tensor_sgd(gs, masters, bufs, copies,
                                               sgd_scal, noop0), iters=10))
        log_numbers(f"multi_tensor_sgd ResNet-50 {level} {len(specs)} "
                    f"tensors, {r_el} elements, {K.sgd_launches(r_numels)} "
                    f"launches", out[key],
                    "SGD(fused=True).step on f32 copies (eager)")
        out[key].update(tensors=len(specs), elements=r_el,
                        launches_per_call=K.sgd_launches(r_numels))
        if level == "O1":
            # the hand-written SGD's update: #16 in place on the
            # parameters (outs = xs), a and b as f32 device scalars
            _axpby_in_place_check(
                f"multi_tensor_axpby_ ResNet-50 O1 {len(specs)} tensors, "
                f"in place", masters, bufs,
                torch.tensor(1.0 - 0.1 * 1e-4, device="cuda"),
                torch.tensor(-0.1, device="cuda"), r_numels)
        else:
            # phase 9c's steps: #22 and #23 on the O2 list, bf16 grads of
            # f32 masters with bf16 model copies, f32 batch norm
            for name in ("adagrad", "adagrad_w_mode"):
                kern, plain, call, st = runs[name]
                ss = [rand(s, st["std"], st["positive"]) for s, _ in specs]
                _opt_kernel_check(
                    f"{kern.__name__} ({name}) ResNet-50 O2 {len(specs)} "
                    f"tensors", kern, plain,
                    lambda f, p, s, c, n, _c=call: _c(gs, p, s, c, n, f),
                    masters, ss, copies, r_numels)
                del ss
            v = rand(len(specs), 1e-6, positive=True)
            ms = [rand(s, 1e-4) for s, _ in specs]
            for reg in (False, True):
                _opt_kernel_check(
                    f"multi_tensor_novograd (reg_inside_moment={reg}) "
                    f"ResNet-50 O2 {len(specs)} tensors",
                    K.multi_tensor_novograd,
                    K.multi_tensor_novograd_reference,
                    lambda f, p, s, c, n, _r=reg: f(gs, p, s, c, v, nv_scal,
                                                    n, _r),
                    masters, ms, copies, r_numels)
            del v, ms
        del gs, masters, copies, bufs, lib, lib_ps
        torch.cuda.empty_cache()
    return out


def _axpby_in_place_check(tag, xs, ys, a, b, numels):
    """#16 writing over its x (``outs=xs``) against its plain version, each
    on its own clones of ``xs``: exact table launches, the same found-inf
    flag, values as #16's f32 check in phase 2."""
    from apex_tpu_torch.ops import multi_tensor as K
    kx, rx = [x.clone() for x in xs], [x.clone() for x in xs]
    before = K.multi_tensor_axpby_.launches
    kf = K.multi_tensor_axpby_(kx, ys, kx, a, b)
    n_launch = K.multi_tensor_axpby_.launches - before
    rf = K.multi_tensor_axpby_reference(rx, ys, rx, a, b)
    torch.cuda.synchronize()
    if n_launch != table_launches(numels) or float(kf) != float(rf):
        raise AssertionError(f"{tag}: {n_launch} launches (the table rule "
                             f"says {table_launches(numels)}), found-inf "
                             f"{float(kf)} vs plain {float(rf)}")
    err = _check_lists(tag, kx, rx, 1e-6, 0.0, scale_rtol=1e-6)
    del kx, rx
    return err


# -- phase 3 -----------------------------------------------------------------

def build_model(device, **overrides):
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    cfg = GPTConfig(**dict(GPT350M, dtype=torch.bfloat16, **overrides))
    return GPTModel(cfg, device=device)


def phase_serve(model, rng, tag="[3]"):
    """Phase 3's 10 requests through ``InferenceEngine`` (``tag`` [3f]: the
    same with ``fused_ffn=True``, whose FFN runs #11 in every prefill and
    decode step): finish reasons, exact launches, no plain version
    called, then prefill(512) and decode-step times."""
    from apex_tpu_torch.inference import InferenceEngine, Request
    from apex_tpu_torch.ops.flash_attention import (flash_attention_decode,
                                                    flash_fwd)
    from apex_tpu_torch.ops.fused_ffn import ffn_fwd
    from apex_tpu_torch.ops.layer_norm import layer_norm_fwd
    counters = (layer_norm_fwd, flash_fwd, flash_attention_decode, ffn_fwd)
    cfg = model.cfg
    engine = InferenceEngine(model, max_slots=SLOTS, device="cuda")
    prompts = serving_prompts(rng, cfg.vocab_size)
    lens = [len(p) for p in prompts]
    for i, p in enumerate(prompts):
        engine.submit(Request(request_id=i, max_new_tokens=32, prompt=p))
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting_plain_versions() as plain_calls:
        responses = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {c.__name__: c.launches for c in counters}

    reasons = {r.request_id: r.finish_reason for r in responses}
    ffn = "fused FFN" if cfg.fused_ffn else "unfused FFN"
    log(f"{tag} served {len(responses)} requests ({ffn}) in {wall:.3f} s: "
        f"reasons {sorted(set(reasons.values()))}")
    errors = [r for r in responses if r.finish_reason == "error"]
    if errors:
        raise AssertionError(f"requests failed inside the engine: "
                             f"{[(r.request_id, r.error) for r in errors]}")
    if len(responses) != len(lens) or any(
            r.finish_reason not in ("eos", "length") for r in responses):
        raise AssertionError(f"unexpected responses: {reasons}")
    for r in responses:
        if len(r.tokens) != 32 or not all(0 <= t < cfg.vocab_size
                                          for t in r.tokens):
            raise AssertionError(f"request {r.request_id}: bad tokens "
                                 f"{r.tokens}")
    prefills, steps = len(lens), len(engine.metrics.occupancy)
    layers = cfg.num_layers
    expected = {"layer_norm_fwd": (2 * layers + 1) * (prefills + steps),
                "flash_fwd": layers * prefills,
                "flash_attention_decode": layers * steps,
                # the forward's two GEMM launches per layer and program
                "ffn_fwd": 2 * layers * (prefills + steps) * cfg.fused_ffn}
    log(f"    launches {launches} (expected {expected}: {prefills} "
        f"prefills, {steps} decode steps); plain-version calls "
        f"{dict(plain_calls)}")
    if launches != expected:
        raise AssertionError("kernel launch counts do not match the path")
    if sum(plain_calls.values()):
        raise AssertionError(f"the serving path called plain versions: "
                             f"{dict(plain_calls)}")
    summary = engine.metrics.summary()
    log("    metrics " + json.dumps(summary, sort_keys=True))

    # latency of the two device programs at the bench_gpt_decode shapes
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 512))).to(
        "cuda")
    prefill_s = _host_time(lambda: model.prefill(prompt))
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, SLOTS)).to(
        "cuda")
    positions = torch.full((SLOTS,), 512, dtype=torch.int32, device="cuda")
    step_s = _host_time(lambda: model.decode_step(tokens, engine.cache.data,
                                                  positions))
    log(f"    prefill(512 tokens) {prefill_s * 1e3:.3f} ms, decode_step("
        f"{SLOTS} slots at position 512) {step_s * 1e3:.3f} ms, "
        f"{SLOTS / step_s:.1f} decode tokens/s; weights "
        f"{engine.weight_bytes / 2 ** 30:.3f} GiB, peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    return dict(launches=launches, steps=steps, prefills=prefills,
                wall_s=wall, served_tokens_per_s=summary["tokens_per_s"],
                prefill_512_ms=prefill_s * 1e3, decode_step_ms=step_s * 1e3,
                decode_tokens_per_s=SLOTS / step_s, summary=summary,
                weight_bytes=engine.weight_bytes, peak_memory_bytes=peak)


def serving_prompts(rng, vocab):
    """Phase 3's 10 prompts: 37..512 tokens (the first two 37 and 512),
    uniform token ids, drawn from ``rng`` in this order."""
    lens = rng.randint(37, 513, size=10)
    lens[:2] = (37, 512)
    return [rng.randint(0, vocab, int(n)).tolist() for n in lens]


def _host_time(fn, iters=5, rounds=3):
    """Median over rounds of host time per call, ending in a sync."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / iters)
    return statistics.median(out)


# -- phase 4 -----------------------------------------------------------------

def _prefill_and_decode(model, prompt, steps, forced=None):
    """Prefill ``prompt`` into a one-slot cache, then ``steps`` decode
    steps.  Feeds ``forced`` tokens when given (else its own greedy
    picks); returns the stacked last-position logits on the CPU."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    cache = torch.zeros((1, cfg.num_layers, 2, cfg.max_seq_len, HEADS,
                         HEAD_DIM), dtype=cfg.dtype, device=dev)
    logits, kv = model.prefill(prompt.to(dev))
    n = prompt.shape[1]
    cache[0, :, :, :n] = kv[:, :, 0].to(cache.dtype)
    rows = [logits[0, n - 1]]
    for i in range(steps):
        tok = forced[i] if forced is not None else int(rows[-1].argmax())
        lg, cache = model.decode_step(
            torch.tensor([tok], device=dev), cache,
            torch.tensor([n + i], dtype=torch.int32, device=dev))
        rows.append(lg[0])
    return torch.stack(rows).float().cpu()


def phase_parity(model, rng, tag="[4]"):
    cpu_model = build_model("cpu", fused_ffn=model.cfg.fused_ffn,
                            weight_quant=model.cfg.weight_quant)
    state = model.state_dict()
    if model.quantized:
        cpu_model.load_quantized_({k: v.cpu() for k, v in state.items()})
    else:
        cpu_model.load_state_dict(state)
    prompt = torch.from_numpy(rng.randint(0, model.cfg.vocab_size, (1, 64)))
    card = _prefill_and_decode(model, prompt, 4)
    tokens = card.argmax(-1).tolist()
    cpu = _prefill_and_decode(cpu_model, prompt, 4, forced=tokens)
    diff = (card - cpu).abs()
    err, mean_err = float(diff.max()), float(diff.mean())
    if not bool(torch.isfinite(card).all()):
        raise AssertionError("non-finite logits on the card")
    top2 = cpu.topk(2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    log(f"{tag} card vs CPU, prefill(64) + 4 decode steps: max |logit diff| "
        f"{err:.3e} (tolerance {LOGITS_ATOL}), mean {mean_err:.3e} "
        f"(tolerance {LOGITS_MEAN_ATOL}); logit std "
        f"{float(cpu.std()):.3f}, smallest top-2 margin {margin:.3e}); "
        f"greedy card {tokens} cpu {cpu.argmax(-1).tolist()}")
    if err > LOGITS_ATOL or mean_err > LOGITS_MEAN_ATOL:
        raise AssertionError("card and CPU logits disagree")
    if cpu.argmax(-1).tolist() != tokens:
        raise AssertionError("card and CPU greedy tokens disagree")
    return dict(max_logit_diff=err, mean_logit_diff=mean_err,
                tolerance=LOGITS_ATOL, mean_tolerance=LOGITS_MEAN_ATOL,
                tokens=tokens, min_top2_margin=margin)


# -- phase 11 ----------------------------------------------------------------

SYSTEM_PROMPT = 64             # tokens of the shared system prompt
PAGED_NEW_TOKENS = 64
PRESSURE_POOL = 1 + 3 * PAGED_BLOCKS   # 11p: three full-length rows


def paged_prompts(vocab):
    """Phase 11's 10 prompts: phase 3's, each stretched or cut
    (``np.resize``) into the 512 prefill bucket, the even ones behind one
    64-token system prompt (64 + 321..448 tokens; the odd ones 385..512).
    One bucket keeps the shared system prompt's K/V bit for bit what each
    request's own prefill would write (the same GEMM shapes), so prefix
    sharing changes no token; with 64 new tokens each, 7 requests fill
    11p's pool of 192 blocks and their growth forces preemption."""
    base = serving_prompts(np.random.RandomState(0), vocab)
    system = np.random.RandomState(11).randint(0, vocab, SYSTEM_PROMPT)
    out = []
    for i, p in enumerate(base):
        if i % 2 == 0:
            body = np.resize(p, int(np.clip(len(p), 321, 448)))
            out.append(np.concatenate([system, body]).tolist())
        else:
            out.append(np.resize(p, int(np.clip(len(p), 385, 512))).tolist())
    return out


def _serving_counters():
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_decode, flash_attention_decode_paged, flash_fwd)
    from apex_tpu_torch.ops.layer_norm import layer_norm_fwd
    from apex_tpu_torch.ops.quant_gemm import quant_gemm
    return (layer_norm_fwd, flash_fwd, flash_attention_decode,
            flash_attention_decode_paged, quant_gemm)


def serve_counted(engine, prompts, tag, new_tokens=PAGED_NEW_TOKENS):
    """Serve greedy ``prompts`` on ``engine`` with the serving kernels'
    counters set to 0 just before and read just after, and plain-version
    calls counted; returns tokens, launches, the engine's device-program
    counts (prefills, prefill chunks, decode steps), time, the weights'
    bytes and the run's working set (peak device memory above what was
    allocated when it started: the engine's cache and every model already
    resident are not in it)."""
    from apex_tpu_torch.inference import Request
    counters = _serving_counters()
    chunks = [0]
    if hasattr(engine, "_chunk_forward"):
        inner = engine._chunk_forward

        def counted(*args, _inner=inner):
            chunks[0] += 1
            return _inner(*args)
        engine._chunk_forward = counted
    for i, p in enumerate(prompts):
        engine.submit(Request(request_id=i, prompt=p,
                              max_new_tokens=new_tokens))
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with counting_plain_versions() as plain_calls:
        responses = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    working = torch.cuda.max_memory_allocated() - start
    launches = {c.__name__: c.launches for c in counters}
    bad = [(r.request_id, r.finish_reason, r.error) for r in responses
           if r.finish_reason != "length"
           or len(r.tokens) != new_tokens]
    if bad or len(responses) != len(prompts):
        raise AssertionError(f"{tag} unexpected responses: {bad}")
    steps = len(engine.metrics.occupancy)
    requeued = engine.metrics.requeued
    prefills = (0 if getattr(engine, "chunked_prefill", False)
                else len(prompts) + requeued)
    summary = engine.metrics.summary()
    log(f"{tag} served {len(responses)} requests in {wall:.3f} s: "
        f"{prefills} prefills, {chunks[0]} prefill chunks, {steps} decode "
        f"steps, {requeued} requeued; {summary['tokens_per_s']:.1f} "
        f"tokens/s; weights {engine.weight_bytes / 2 ** 30:.3f} GiB, "
        f"working set {working / 2 ** 30:.3f} GiB; plain-version calls "
        f"{dict(plain_calls)}")
    if sum(plain_calls.values()):
        raise AssertionError(f"{tag} called plain versions: "
                             f"{dict(plain_calls)}")
    return dict(tokens={r.request_id: r.tokens for r in responses},
                launches=launches, prefills=prefills, chunks=chunks[0],
                steps=steps, requeued=requeued, wall_s=wall,
                tokens_per_s=summary["tokens_per_s"],
                working_set_bytes=working, weight_bytes=engine.weight_bytes,
                summary=summary)


def check_launches(tag, run, layers, paged, int8_weights=False,
                   int8_kv=False):
    """The exact launches the run implies: per prefill, prefill chunk and
    decode step 2L+1 LayerNorms (#1); per monolithic prefill L flash
    forwards (#3); per decode step L decode attentions (#7 paged, #6 on
    the ring; none on an int8 pool, whose attention is plain PyTorch as in
    JAX); with int8 weights 4L+1 dequant-GEMMs (#14) per prefill, chunk
    and step."""
    programs = run["prefills"] + run["chunks"] + run["steps"]
    attn = 0 if int8_kv else layers * run["steps"]
    expected = {
        "layer_norm_fwd": (2 * layers + 1) * programs,
        "flash_fwd": layers * run["prefills"],
        "flash_attention_decode": 0 if paged else attn,
        "flash_attention_decode_paged": attn if paged else 0,
        "quant_gemm": (4 * layers + 1) * programs * int8_weights}
    log(f"    launches {run['launches']} (expected {expected})")
    if run["launches"] != expected:
        raise AssertionError(f"{tag} kernel launch counts do not match the "
                             "path")


def _agreement(a, b):
    same = sum(x == y for i in a for x, y in zip(a[i], b[i]))
    total = sum(len(a[i]) for i in a)
    return same / total


def phase_paged(model, rng):
    """Phase 11 and its variants on GPT-350M (``model``, phase 3's
    weights): ``PagedInferenceEngine(max_slots=8, block_size=16)`` over
    ``paged_prompts`` (prefix sharing on) against the contiguous engine on
    the same prompts; (11c) chunked prefill; (11p) a pool of 1 + 3 x 64
    blocks that forces preemption; (11q) ``weight_quant="int8"`` through
    both engines, and its card against a CPU copy; (11k) the int8 KV pool
    with chunked prefill on 4 prompts of at most 128 tokens.  Exact
    launches everywhere, no plain version called; 11's and 11p's greedy
    tokens must equal the contiguous engine's."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.serving import PagedInferenceEngine
    cfg = model.cfg
    layers = cfg.num_layers
    prompts = paged_prompts(cfg.vocab_size)
    out = {}
    log(f"[11] prompts of {[len(p) for p in prompts]} tokens, "
        f"{PAGED_NEW_TOKENS} new tokens each")
    contiguous = serve_counted(InferenceEngine(model, max_slots=SLOTS),
                               prompts, "[11] contiguous engine")
    check_launches("[11] contiguous", contiguous, layers, paged=False)

    def paged(**kw):
        return PagedInferenceEngine(model, max_slots=SLOTS,
                                    block_size=PAGED_BS, **kw)
    engine = paged()
    run = serve_counted(engine, prompts, "[11] paged engine")
    check_launches("[11]", run, layers, paged=True)
    stats = engine.pool.stats()
    saved = stats["prefix_hit_tokens"] // PAGED_BS
    log(f"    pool {stats}: {stats['prefix_hit_tokens']} prompt tokens "
        f"served from the prefix trie, {saved} blocks not written")
    if stats["prefix_hit_tokens"] != (len(prompts) // 2 - 1) * SYSTEM_PROMPT:
        raise AssertionError("[11] the system prompt was not shared")
    same = run["tokens"] == contiguous["tokens"]
    log(f"    greedy tokens {'equal to' if same else 'DIFFER from'} the "
        f"contiguous engine's")
    if not same:
        raise AssertionError("[11] paged and contiguous tokens differ")
    out["paged"] = dict(run, pool=stats, blocks_saved=saved)
    out["contiguous"] = contiguous

    run = serve_counted(paged(chunked_prefill=True), prompts,
                        "[11c] paged engine, chunked prefill")
    check_launches("[11c]", run, layers, paged=True)
    agree = _agreement(run["tokens"], contiguous["tokens"])
    log(f"    greedy tokens agree with the contiguous engine's at "
        f"{agree:.4f} of positions (measured, not required: the chunk "
        "forward is another schedule than the bucketed prefill)")
    out["chunked"] = dict(run, agreement=agree)

    engine = paged(num_blocks=PRESSURE_POOL)
    run = serve_counted(engine, prompts,
                        f"[11p] paged engine, pool of {PRESSURE_POOL} blocks")
    check_launches("[11p]", run, layers, paged=True)
    same = run["tokens"] == out["paged"]["tokens"]
    log(f"    {run['requeued']} preemptions; greedy tokens "
        f"{'equal to' if same else 'DIFFER from'} 11's")
    if not run["requeued"]:
        raise AssertionError("[11p] the pool forced no preemption")
    if not same:
        diff = [i for i in run["tokens"]
                if run["tokens"][i] != out["paged"]["tokens"][i]]
        raise AssertionError(f"[11p] requests {diff} resumed with other "
                             "tokens")
    out["pressure"] = run
    del engine

    qmodel = build_model("cuda", weight_quant="int8")
    qmodel.load_state_dict(model.state_dict())
    qc = serve_counted(InferenceEngine(qmodel, max_slots=SLOTS), prompts,
                       "[11q] int8 weights, contiguous engine")
    check_launches("[11q] contiguous", qc, layers, paged=False,
                   int8_weights=True)
    qp = serve_counted(PagedInferenceEngine(qmodel, max_slots=SLOTS,
                                            block_size=PAGED_BS),
                       prompts, "[11q] int8 weights, paged engine")
    check_launches("[11q] paged", qp, layers, paged=True, int8_weights=True)
    agree = _agreement(qp["tokens"], out["paged"]["tokens"])
    gib = 2 ** 30

    def held(run):                   # weights + the run's working set
        return (run["weight_bytes"] + run["working_set_bytes"]) / gib
    log(f"    int8 weights {qp['weight_bytes'] / gib:.3f} GiB against f32 "
        f"{contiguous['weight_bytes'] / gib:.3f} GiB "
        f"({qp['weight_bytes'] / contiguous['weight_bytes']:.3f}x); "
        f"weights + working set {held(qc):.3f} GiB (contiguous) / "
        f"{held(qp):.3f} GiB (paged) against f32's {held(contiguous):.3f} "
        f"/ {held(out['paged']):.3f} GiB (phase 3's whole peak, its cache "
        "included, is in its own line); paged int8 and contiguous int8 "
        "tokens "
        f"{'equal' if qp['tokens'] == qc['tokens'] else 'DIFFER'}; int8 "
        f"tokens agree with f32's at {agree:.4f} of positions (measured)")
    if qp["tokens"] != qc["tokens"]:
        raise AssertionError("[11q] paged and contiguous int8 tokens differ")
    parity = phase_parity(qmodel, rng, tag="[11q]")
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 512))).to(
        "cuda")
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, SLOTS)).to(
        "cuda")
    positions = torch.full((SLOTS,), 512, dtype=torch.int32, device="cuda")
    pool = torch.zeros((PAGED_POOL, layers, 2, PAGED_BS, HEADS, HEAD_DIM),
                       dtype=cfg.dtype, device="cuda")
    tables = paged_step_tables()
    times = {}
    for name, m in (("f32", model), ("int8", qmodel)):
        times[name] = (_host_time(lambda: m.prefill(prompt)),
                       _host_time(lambda: m.decode_step_paged(
                           tokens, pool, tables, positions)))
        log(f"    {name} weights: prefill(512) {times[name][0] * 1e3:.3f} "
            f"ms, paged decode step (8 slots at position 512) "
            f"{times[name][1] * 1e3:.3f} ms, "
            f"{SLOTS / times[name][1]:.1f} decode tokens/s")
    out["int8_weights"] = dict(contiguous=qc, paged=qp, parity=parity,
                               agreement_with_f32=agree,
                               prefill_512_ms={k: v[0] * 1e3
                                               for k, v in times.items()},
                               paged_decode_step_ms={
                                   k: v[1] * 1e3 for k, v in times.items()})
    del pool

    short = [p[:128] for p in prompts[:4]]
    base = serve_counted(paged(), short, "[11k] reference: bf16 pool",
                         new_tokens=32)
    run = serve_counted(paged(chunked_prefill=True, kv_quant="int8"), short,
                        "[11k] int8 KV pool, chunked prefill",
                        new_tokens=32)
    check_launches("[11k]", run, layers, paged=True, int8_kv=True)
    agree = _agreement(run["tokens"], base["tokens"])
    log(f"    int8 KV tokens agree with the bf16 pool's at {agree:.4f} of "
        f"positions (measured); {run['wall_s']:.3f} s for "
        f"{sum(len(p) for p in short)} prompt and {4 * 32} new tokens, the "
        "per-token insert loop of the quantized chunk path")
    out["int8_kv"] = dict(run, agreement=agree, reference=base)
    return qmodel, out


def paged_step_tables():
    """Tables of 8 slots at position 512 over the default pool (slot s
    owns blocks 1 + 64 s ..): the paged decode step the profiles and step
    times take."""
    tables = np.zeros((SLOTS, PAGED_BLOCKS), np.int32)
    for s in range(SLOTS):
        tables[s, :513 // PAGED_BS + 1] = 1 + s * PAGED_BLOCKS + np.arange(
            513 // PAGED_BS + 1)
    return torch.from_numpy(tables).to("cuda")


# -- phase 5 -----------------------------------------------------------------

def _train_counters():
    from apex_tpu_torch.ops.flash_attention import (flash_attention_dkv,
                                                    flash_attention_dq,
                                                    flash_fwd)
    from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from apex_tpu_torch.ops.fused_ffn import ffn_dw, ffn_dx, ffn_fwd
    from apex_tpu_torch.ops.lm_head import lm_head_dw, lm_head_dx, lm_head_fwd
    from apex_tpu_torch.ops.multi_tensor import multi_tensor_adam
    return (layer_norm_fwd, layer_norm_bwd, flash_fwd, flash_attention_dq,
            flash_attention_dkv, multi_tensor_adam, lm_head_fwd, lm_head_dx,
            lm_head_dw, ffn_fwd, ffn_dx, ffn_dw)


_PLAIN_VERSIONS = {
    "apex_tpu_torch.ops.layer_norm": ("layer_norm_fwd_reference",
                                      "layer_norm_bwd_reference"),
    "apex_tpu_torch.ops.flash_attention": (
        "flash_fwd_reference", "flash_attention_reference",
        "flash_attention_dq_reference", "flash_attention_dkv_reference",
        "flash_attention_decode_reference",
        "flash_attention_decode_paged_reference"),
    "apex_tpu_torch.ops.quant_gemm": ("quant_gemm_reference",),
    "apex_tpu_torch.ops.multi_tensor": (
        "multi_tensor_adam_reference", "multi_tensor_scale_reference",
        "multi_tensor_sumsq_reference", "multi_tensor_lamb_stage1_reference",
        "multi_tensor_lamb_stage2_reference",
        "multi_tensor_axpby_reference", "multi_tensor_sgd_reference",
        "multi_tensor_adagrad_reference",
        "multi_tensor_novograd_reference"),
    "apex_tpu_torch.ops.lm_head": ("lm_head_fwd_reference",
                                   "lm_head_dx_reference",
                                   "lm_head_dw_reference",
                                   "lm_head_bwd_reference"),
    "apex_tpu_torch.ops.fused_ffn": ("ffn_fwd_reference", "ffn_dx_reference",
                                     "ffn_dw_reference", "ffn_bwd_reference",
                                     "fused_ffn_reference"),
}


@contextlib.contextmanager
def counting_plain_versions():
    """Count every call of a kernel's plain version while the block runs
    (the wrappers look their plain versions up by module attribute)."""
    calls = collections.Counter()
    saved = []
    for mod_name, names in _PLAIN_VERSIONS.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            fn = getattr(mod, name)

            def counted(*args, _fn=fn, _name=name, **kwargs):
                calls[_name] += 1
                return _fn(*args, **kwargs)
            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def train_step(model, opt, tokens, targets, dropout_seed=None):
    """One step of the slice: the schedule over the model's loss and
    backward (M micro-batches), then FusedAdam.  Returns the mean loss."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    opt.zero_grad()
    loss = forward_backward_no_pipelining(
        lambda m, x: m.backbone(m.embed(x), dropout_seed),
        lambda x, t: model.head_loss(x, t).mean(), model, tokens, targets)
    opt.step()
    return loss


def ffn_bwd_launches(call):
    """(#12, #13) launches of one ``ffn_dx``, ``ffn_dw`` or ``ffn_bwd``
    call: dh + dX, dh + dW1 + dW2 + db1, or dh + dX and dW1 + dW2 + db1
    (dh once)."""
    return dict(dx=(2, 0), dw=(0, 4), bwd=(2, 3))[call]


def lm_head_bwd_launches(calls, tokens, vocab):
    """#9 and #10 launches of ``calls`` backward passes of the fused head
    (one ``lm_head_bwd`` each: bf16 operands, dS once per vocab chunk) at
    ``tokens`` rows a micro-batch, from the wrappers' chunk plan."""
    from apex_tpu_torch.ops.lm_head import bwd_chunk_plan
    dx, dw = bwd_chunk_plan(tokens, vocab, 2).launches("bwd")
    return {"lm_head_dx": calls * dx, "lm_head_dw": calls * dw}


def ffn_launches(steps, micro, layers, fused):
    """#11-#13 launches of ``steps`` training steps at 8192 rows a
    micro-batch: per micro-batch and layer the forward (two GEMM
    launches) and one ``ffn_bwd`` on its GEMM launches."""
    n = steps * micro * layers * fused
    dx, dw = ffn_bwd_launches("bwd")
    return {"ffn_fwd": 2 * n, "ffn_dx": dx * n, "ffn_dw": dw * n}


def remat_launches(steps, micro, layers, remat_policy, fused_ffn):
    """Extra launches of each layer's recompute under ``remat_policy``
    (None: none).  Both policies rerun a layer's forward up to its last
    saved tensor: both LayerNorms (#1) and the flash forward (#3), and
    with the fused FFN its forward (#11, two launches); "dots" keeps only
    the 2-D products, which dispatch cannot see inside the kernels."""
    n = steps * micro * layers * (remat_policy is not None)
    return {"layer_norm_fwd": 2 * n, "flash_fwd": n,
            "ffn_fwd": 2 * n * fused_ffn}


def _remat_kw(remat_policy):
    return ({} if remat_policy is None
            else dict(remat=True, remat_policy=remat_policy))


def phase_train(fused_ffn=False, tag="[5]", remat_policy=None):
    """Phase 5 (``tag`` [5f]: with ``fused_ffn=True``; [5r]: with
    ``remat_policy``)."""
    from apex_tpu_torch.optimizers import FusedAdam
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    model = build_model("cuda", fused_ffn=fused_ffn,
                        **_remat_kw(remat_policy)).init_params(
        torch.Generator().manual_seed(0))
    opt = FusedAdam(model.parameters(), lr=LR)
    numels = [p.numel() for p in model.parameters()]
    rng = np.random.RandomState(0)
    shape = (ACCUM, MICRO, SEQ)
    tokens = torch.from_numpy(rng.randint(0, GPT350M["vocab_size"],
                                          shape)).to("cuda")
    targets = torch.from_numpy(rng.randint(0, GPT350M["vocab_size"],
                                           shape)).to("cuda")
    counters = _train_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    with counting_plain_versions() as plain_calls:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            loss = train_step(model, opt, tokens, targets)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    per_mb = 2 * GPT350M["num_layers"] + 1
    n_steps, layers = TRAIN_STEPS, GPT350M["num_layers"]
    expected = {"layer_norm_fwd": n_steps * ACCUM * per_mb,
                "layer_norm_bwd": n_steps * ACCUM * per_mb,
                "flash_fwd": n_steps * ACCUM * layers,
                "flash_attention_dq": n_steps * ACCUM * layers,
                "flash_attention_dkv": n_steps * ACCUM * layers,
                "multi_tensor_adam": n_steps * table_launches(numels),
                # the forward's split pass and its combine, then the
                # backward's chunks
                "lm_head_fwd": n_steps * ACCUM * 2,
                **lm_head_bwd_launches(n_steps * ACCUM, MICRO * SEQ,
                                       GPT350M["vocab_size"]),
                **ffn_launches(n_steps, ACCUM, layers, fused_ffn)}
    for name, extra in remat_launches(n_steps, ACCUM, layers, remat_policy,
                                      fused_ffn).items():
        expected[name] += extra
    step_s = statistics.median(times[1:])
    tokens_per_step = ACCUM * MICRO * SEQ
    ffn = "fused FFN" if fused_ffn else "unfused FFN"
    remat = "" if remat_policy is None else f", remat {remat_policy!r}"
    log(f"{tag} trained GPT-350M {n_steps} steps ({ACCUM} x {MICRO} x {SEQ} "
        f"tokens, fused LM head, {ffn}{remat}, FusedAdam lr={LR}): losses "
        f"{[round(x, 5) for x in losses]} (ln vocab = "
        f"{np.log(GPT350M['vocab_size']):.3f}); step times (s) "
        f"{[round(t, 4) for t in times]}, median of steps 2-{n_steps} "
        f"{step_s:.4f} s, {tokens_per_step / step_s:.1f} tokens/s; peak "
        f"memory {peak / 2 ** 30:.3f} GiB, "
        f"{(peak - start_bytes) / 2 ** 30:.3f} GiB above the phase's start")
    log(f"    launches {launches} (expected {expected}); per step "
        f"{ {k: v // n_steps for k, v in launches.items()} }; plain-version "
        f"calls {dict(plain_calls)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    if launches != expected:
        raise AssertionError("training launch counts do not match the path")
    if sum(plain_calls.values()):
        raise AssertionError(f"the training path called plain versions: "
                             f"{dict(plain_calls)}")
    return model, opt, tokens, targets, dict(
        losses=losses, step_times_s=times, median_step_s=step_s,
        tokens_per_s=tokens_per_step / step_s, peak_memory_bytes=peak,
        peak_above_start_bytes=peak - start_bytes, remat=remat_policy,
        launches=launches, launches_per_step={
            k: v // n_steps for k, v in launches.items()},
        adam_tensors=len(numels), adam_elements=sum(numels))


REMAT_POLICIES = ("full", "dots")


def log_remat_support():
    """Whether this PyTorch has selective checkpointing ("dots" raises
    naming it when it does not)."""
    import torch.utils.checkpoint as ckpt
    log(f"[5r] torch {torch.__version__}: torch.utils.checkpoint."
        f"create_selective_checkpoint_contexts "
        f"{hasattr(ckpt, 'create_selective_checkpoint_contexts')}, "
        f"CheckpointPolicy {hasattr(ckpt, 'CheckpointPolicy')}")


def check_remat(tag, base, runs):
    """``runs`` ({policy: result}) against the run without remat
    (``base``): each step's loss within 1e-6 relative (bit-equality
    printed), and the peak memory above each phase's start strictly
    ordered full < dots < none."""
    ordered = [runs[p] for p in ("full", "dots") if p in runs] + [base]
    for policy, run in runs.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                      base["losses"]))
        bitwise = run["losses"] == base["losses"]
        run.update(loss_rel_diff=rel, losses_bit_equal=bitwise)
        log(f"{tag} remat {policy!r}: losses {run['losses']} against "
            f"{base['losses']}: max relative diff {rel:.3e} (tolerance "
            f"1e-6), bit-equal {bitwise}; median step "
            f"{run['median_step_s']:.4f} s against "
            f"{base['median_step_s']:.4f} s "
            f"({run['median_step_s'] / base['median_step_s']:.3f}x)")
        if not rel <= 1e-6:
            raise AssertionError(f"{tag} remat {policy!r} changed the "
                                 "losses")
    peaks = [r["peak_above_start_bytes"] for r in ordered]
    names = [r["remat"] or "none" for r in ordered]
    log(f"{tag} peak memory above each phase's start: "
        + ", ".join(f"{n} {b / 2 ** 30:.3f} GiB ({b} bytes)"
                    for n, b in zip(names, peaks)))
    if not all(a < b for a, b in zip(peaks, peaks[1:])):
        raise AssertionError(f"{tag} peak memory not ordered "
                             f"{' < '.join(names)}: {peaks}")
    return dict(runs, peaks_above_start=dict(zip(names, peaks)))


# -- phase 6 -----------------------------------------------------------------

PARITY_TRAIN = dict(vocab_size=50304, hidden_size=256, num_layers=4,
                    num_attention_heads=4, ffn_hidden_size=1024,
                    max_seq_len=256, attention_dropout=0.1,
                    dtype=torch.bfloat16)


def phase_train_parity(fused_lm_head=True, fused_ffn=False,
                       remat_policy=None, tag="[6]"):
    """2 training steps of a small GPT with attention dropout on the card
    and on a CPU copy (the plain versions): loss, grads, params (``tag``
    [6r]: under ``remat_policy``)."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(**PARITY_TRAIN, fused_lm_head=fused_lm_head,
                    fused_ffn=fused_ffn, **_remat_kw(remat_policy))
    card = GPTModel(cfg, device="cuda").init_params(
        torch.Generator().manual_seed(1))
    cpu = GPTModel(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.RandomState(2)
    shape = (2, 2, PARITY_TRAIN["max_seq_len"])
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape))
    targets = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape))
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        dev = next(model.parameters()).device
        opt = FusedAdam(model.parameters(), lr=LR)
        losses, grads = [], None
        for step in range(2):
            losses.append(float(train_step(model, opt, tokens.to(dev),
                                           targets.to(dev), dropout_seed=3)))
            if step == 0:
                grads = {n: p.grad.float().cpu()
                         for n, p in model.named_parameters()}
        runs[name] = (losses, grads, {n: p.detach().float().cpu()
                                      for n, p in model.named_parameters()})
    (cl, cg, cp), (rl, rg, rp) = runs["card"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, rl))
    grad_err = max(float((cg[n] - rg[n]).abs().max() / rg[n].abs().max())
                   for n in rg)
    worst = max(rg, key=lambda n: float((cg[n] - rg[n]).abs().max()
                                        / rg[n].abs().max()))
    diffs = torch.sort(torch.cat([(cp[n] - rp[n]).abs().flatten()
                                  for n in rp])).values
    p_max = float(diffs[-1])
    p_q99 = float(diffs[int(0.99 * (diffs.numel() - 1))])
    head = "fused LM head" if fused_lm_head else "f32-logits head"
    head += ", fused FFN" if fused_ffn else ""
    head += "" if remat_policy is None else f", remat {remat_policy!r}"
    log(f"{tag} training card vs CPU (4 layers, hidden 256, dropout 0.1, "
        f"{head}, 2 steps): losses card {cl} cpu {rl}, max relative loss diff "
        f"{loss_err:.3e} (tolerance {TRAIN_LOSS_RTOL}); step-1 grads max "
        f"|diff| / max|grad| {grad_err:.3e} at {worst} (tolerance "
        f"{TRAIN_GRAD_TOL}); params after 2 steps max |diff| {p_max:.3e} "
        f"(tolerance {4.5 * LR}), 99th percentile {p_q99:.3e} (tolerance "
        f"{LR / 2})")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL
            and p_max <= 4.5 * LR and p_q99 <= LR / 2):
        raise AssertionError("card and CPU training disagree")
    return dict(losses_card=cl, losses_cpu=rl, loss_rel_err=loss_err,
                grad_rel_err=grad_err, worst_grad=worst, param_max_diff=p_max,
                param_q99_diff=p_q99)


# -- phase 7 -----------------------------------------------------------------

def _bert_counters():
    from apex_tpu_torch.ops.flash_attention import (flash_attention_dkv,
                                                    flash_attention_dq,
                                                    flash_fwd)
    from apex_tpu_torch.ops.layer_norm import layer_norm_bwd, layer_norm_fwd
    from apex_tpu_torch.ops.lm_head import lm_head_dw, lm_head_dx, lm_head_fwd
    from apex_tpu_torch.ops.multi_tensor import (multi_tensor_sumsq,
                                                 multi_tensor_lamb_stage1,
                                                 multi_tensor_lamb_stage2)
    from apex_tpu_torch.ops.fused_ffn import ffn_dw, ffn_dx, ffn_fwd
    return (layer_norm_fwd, layer_norm_bwd, flash_fwd, flash_attention_dq,
            flash_attention_dkv, multi_tensor_sumsq, multi_tensor_lamb_stage1,
            multi_tensor_lamb_stage2, lm_head_fwd, lm_head_dx, lm_head_dw,
            ffn_fwd, ffn_dx, ffn_dw)


def build_bert(device, cfg_overrides, lr, seed, loss_scale=None):
    """BERT under amp O2 with FusedLAMB, through ``amp.initialize``:
    bf16 parameters, f32 LayerNorms, f32 masters."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.bert import BertConfig, BertModel
    from apex_tpu_torch.optimizers import FusedLAMB
    cfg = BertConfig(**cfg_overrides, dtype=torch.bfloat16)
    model = BertModel(cfg, device=device).init_params(
        torch.Generator().manual_seed(seed))
    opt = FusedLAMB(model.parameters(), lr=lr, betas=LAMB_BETAS,
                    weight_decay=LAMB_WD)
    state = amp.initialize(model, opt, opt_level="O2", loss_scale=loss_scale)
    return model, opt, state


def mlm_batch(vocab, shape, seed):
    """Tokens and MLM labels as bench.py draws them: 15% masked positions
    carry a random id, -1 elsewhere."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, shape)
    labels = np.where(rng.rand(*shape) < 0.15,
                      rng.randint(0, vocab, shape), -1)
    return torch.from_numpy(tokens), torch.from_numpy(labels)


def bert_step(model, opt, tokens, labels, scaler=None):
    """One step of the slice: the schedule over ``BertModel.loss`` and its
    backward (M micro-batches), then ``FusedLAMB.step`` (or, with a
    scaler, the scaled loss and ``amp.unscale_step``).  Returns the mean
    loss."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    opt.zero_grad()
    if scaler is None:
        loss_fn = lambda x, t: model.loss(x, t)              # noqa: E731
    else:
        loss_fn = lambda x, t: amp.scale_loss(model.loss(x, t),  # noqa
                                              scaler)
    loss = forward_backward_no_pipelining(lambda m, x: x, loss_fn, model,
                                          tokens, labels)
    if scaler is None:
        opt.step()
        return loss
    amp.unscale_step(opt, scaler)
    return loss / scaler.loss_scale


def phase_bert_train(fused_ffn=False, tag="[7]", remat_policy=None):
    """4 steps of BERT-large O2 + FusedLAMB (``tag`` [7f]: with
    ``fused_ffn=True``; [7r]: with ``remat_policy``); losses, times,
    memory, exact launch counts, and no plain version called."""
    from apex_tpu_torch.ops import multi_tensor as K
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    model, opt, _ = build_bert("cuda", dict(BERT_LARGE, fused_ffn=fused_ffn,
                                            **_remat_kw(remat_policy)),
                               BERT_LR, 0)
    numels = [p.numel() for p in model.parameters()]
    shape = (BERT_ACCUM, BERT_MICRO, BERT_SEQ)
    tokens, labels = (t.to("cuda") for t in mlm_batch(
        BERT_LARGE["vocab_size"], shape, 0))
    counters = _bert_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    with counting_plain_versions() as plain_calls:
        for _ in range(BERT_STEPS):
            t0 = time.perf_counter()
            loss = bert_step(model, opt, tokens, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated()
    n, layers = BERT_STEPS, BERT_LARGE["num_layers"]
    per_mb = 2 * layers + 2           # embedding LN, 2 per layer, MLM LN
    table = table_launches(numels)
    expected = {"layer_norm_fwd": n * BERT_ACCUM * per_mb,
                "layer_norm_bwd": n * BERT_ACCUM * per_mb,
                "flash_fwd": n * BERT_ACCUM * layers,
                "flash_attention_dq": n * BERT_ACCUM * layers,
                "flash_attention_dkv": n * BERT_ACCUM * layers,
                "multi_tensor_sumsq": n * sumsq_launches(numels),
                "multi_tensor_lamb_stage1": n * K.lamb_stage1_launches(numels),
                "multi_tensor_lamb_stage2": n * table,
                "lm_head_fwd": n * BERT_ACCUM * 2,
                **lm_head_bwd_launches(n * BERT_ACCUM, BERT_ROWS,
                                       BERT_LARGE["vocab_size"]),
                **ffn_launches(n, BERT_ACCUM, layers, fused_ffn)}
    for name, extra in remat_launches(n, BERT_ACCUM, layers, remat_policy,
                                      fused_ffn).items():
        expected[name] += extra
    step_s = statistics.median(times[1:])
    tokens_per_step = BERT_ACCUM * BERT_MICRO * BERT_SEQ
    ffn = "fused FFN" if fused_ffn else "unfused FFN"
    remat = "" if remat_policy is None else f", remat {remat_policy!r}"
    log(f"{tag} trained BERT-large O2 + FusedLAMB {n} steps ({BERT_ACCUM} x "
        f"{BERT_MICRO} x {BERT_SEQ} tokens, fused LM head, {ffn}{remat}, "
        f"lr={BERT_LR}, "
        f"{len(numels)} "
        f"parameters, {sum(numels)} elements): losses "
        f"{[round(x, 5) for x in losses]} (ln vocab = "
        f"{np.log(BERT_LARGE['vocab_size']):.3f}); step times (s) "
        f"{[round(t, 4) for t in times]}, median of steps 2-{n} "
        f"{step_s:.4f} s, {tokens_per_step / step_s:.1f} tokens/s; peak "
        f"memory {peak / 2 ** 30:.3f} GiB, "
        f"{(peak - start_bytes) / 2 ** 30:.3f} GiB above the phase's start")
    log(f"    launches {launches} (expected {expected}); per step "
        f"{ {k: v // n for k, v in launches.items()} }; plain-version "
        f"calls {dict(plain_calls)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not (abs(losses[0] - np.log(BERT_LARGE["vocab_size"])) < 1.0
            and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not start near ln(vocab) and "
                             f"fall: {losses}")
    if launches != expected:
        raise AssertionError("BERT launch counts do not match the path")
    if sum(plain_calls.values()):
        raise AssertionError(f"the BERT path called plain versions: "
                             f"{dict(plain_calls)}")
    return model, opt, tokens, labels, dict(
        losses=losses, step_times_s=times, median_step_s=step_s,
        tokens_per_s=tokens_per_step / step_s, peak_memory_bytes=peak,
        peak_above_start_bytes=peak - start_bytes, remat=remat_policy,
        launches=launches, launches_per_step={
            k: v // n for k, v in launches.items()},
        lamb_tensors=len(numels), lamb_elements=sum(numels))


def phase_unscale_clip(model):
    """#15 and #17 on the last BERT step's real gradients, through
    ``LossScaler.unscale`` and ``clip_grad_norm_`` (counted alone), each
    against the plain versions on the same gradients."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
    from apex_tpu_torch.ops import multi_tensor as K
    params = [p for p in model.parameters() if p.grad is not None]
    grads = [p.grad for p in params]
    scaler = amp.LossScaler(init_scale=1024.0, device="cuda")
    ref_unscaled = [torch.empty_like(g) for g in grads]
    ref_clipped = [g.clone() for g in grads]
    K.multi_tensor_scale_reference(grads, ref_unscaled,
                                   1.0 / scaler.loss_scale)
    total, _, _ = K.multi_tensor_sumsq_reference(grads)
    ref_norm = torch.sqrt(total)
    max_norm = 0.5 * float(ref_norm)       # so that the clip rescales
    coef = torch.clamp(max_norm / (ref_norm + 1e-6), max=1.0)
    K.multi_tensor_scale_reference(grads, ref_clipped, coef)
    counters = (K.multi_tensor_scale_, K.multi_tensor_sumsq)
    for c in counters:
        c.launches = 0
    unscaled, found_inf = scaler.unscale(grads)
    norm = clip_grad_norm_(params, max_norm)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    numels = [g.numel() for g in grads]
    expected = {"multi_tensor_scale_": 2 * K.scale_launches(numels),
                "multi_tensor_sumsq": sumsq_launches(numels)}
    log(f"[7b] LossScaler.unscale and clip_grad_norm_(max_norm={max_norm:.4g})"
        f" on the last step's {len(grads)} gradients: launches {launches} "
        f"(expected {expected}); found_inf {float(found_inf)}; norm "
        f"{float(norm):.6g}, plain {float(ref_norm):.6g}")
    err_u = _check_lists("unscale vs plain", unscaled, ref_unscaled,
                         2.0 ** -8, 0.0)
    check_close("clip_grad_norm_ total norm vs plain", norm, ref_norm, 0,
                1e-5)
    err_c = _check_lists("clipped gradients vs plain", grads, ref_clipped,
                         2.0 ** -7, 0.0)
    if launches != expected or float(found_inf) != 0.0:
        raise AssertionError("the unscale / clip path did not run as "
                             "expected")
    return dict(launches=launches, max_norm=max_norm, norm=float(norm),
                unscale_err=err_u, clip_err=err_c)


# -- phase 8 -----------------------------------------------------------------

PARITY_BERT = dict(vocab_size=30528, hidden_size=256, num_layers=4,
                   num_attention_heads=4, ffn_hidden_size=1024,
                   max_seq_len=128)


def _cs_bound(t, b1=LAMB_BETAS[0], b2=LAMB_BETAS[1]):
    """max |m^ / sqrt(v^)| over gradient histories of length t
    (Cauchy-Schwarz): 1 at step 1, 1.0014 at step 2."""
    k = np.arange(1, t + 1)
    a = (1 - b1) * b1 ** (t - k) / (1 - b1 ** t)
    b = (1 - b2) * b2 ** (t - k) / (1 - b2 ** t)
    return float(np.sqrt(np.sum(a * a / b)))


def phase_bert_parity(fused_ffn=False):
    """2 steps of a small BERT under O2 + FusedLAMB on the card and on a
    CPU copy (the plain versions): losses, every gradient of both steps,
    then the masters, m and v.

    Tolerances: the loss 2e-3 relative and each gradient within 5e-2 of
    its largest entry (bf16 rounding places and sum orders differ; the
    bound of the CPU tests against JAX).  The optimizer's state follows
    from its update rule: m' = b1 m + (1 - b1) c g and v' = b2 v + (1 - b2)
    (c g)^2, with c the clip factor (within 1% on the two sides), bound
    |dm|, |dv| by the measured gradient differences E_t of each leaf; a
    master moves by lr r_t u with |u| <= C_t + wd |p| (C_t the
    Cauchy-Schwarz bound of |m^ / sqrt(v^)|) and r_t the leaf's trust
    ratio (the CPU run's, 5% allowed for the card's), and an entry whose
    gradient is noise may move the other way on one side: 2.1 lr r_t
    (C_t + wd |p|) per step.  That bound admits a master that never moved,
    so each leaf's move from its start p0 is held as a whole too (within
    MOVE_RTOL of the CPU run's move).
    """
    cfg = dict(PARITY_BERT, fused_ffn=fused_ffn)
    card, copt, _ = build_bert("cuda", cfg, BERT_LR, 1)
    cpu, popt, _ = build_bert("cpu", cfg, BERT_LR, 1)
    cpu.load_state_dict(card.state_dict())
    # the masters start as the parameters in f32
    p0 = {n: p.detach().float().cpu().clone()
          for n, p in card.named_parameters()}
    shape = (2, 2, PARITY_BERT["max_seq_len"])
    tokens, labels = mlm_batch(PARITY_BERT["vocab_size"], shape, 2)
    runs = {}
    for name, model, opt in (("card", card, copt), ("cpu", cpu, popt)):
        dev = next(model.parameters()).device
        losses, grads, ratios, clips = [], [], [], []
        for _ in range(2):
            before = {n: t.detach().cpu().clone() for n, t in zip(
                (n for n, _ in model.named_parameters()),
                opt.master_params())}
            losses.append(float(bert_step(model, opt, tokens.to(dev),
                                          labels.to(dev))))
            g = {n: (torch.zeros(p.shape) if p.grad is None
                     else p.grad.float().cpu())
                 for n, p in model.named_parameters()}
            grads.append(g)
            gnorm = float(torch.sqrt(sum(torch.sum(x * x)
                                         for x in g.values())))
            clips.append(min(1.0, 1.0 / gnorm))
            ratios.append({})
            for n, p in model.named_parameters():
                u = opt._updates[p].cpu()
                pn, un = float(before[n].norm()), float(u.norm())
                ratios[-1][n] = pn / un if pn > 0 and un > 0 else 1.0
        # m, v and the updated f32 value (the master, or the f32 param)
        state = {n: {"exp_avg": opt.state[p]["exp_avg"].cpu(),
                     "exp_avg_sq": opt.state[p]["exp_avg_sq"].cpu(),
                     "value": value.detach().cpu().clone()}
                 for (n, p), value in zip(model.named_parameters(),
                                          opt.master_params())}
        runs[name] = (losses, grads, state, ratios, clips)
    (cl, cg, cs, _, cc), (rl, rg, rs, rr, rc) = runs["card"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, rl))
    grad_err, worst, diffs = 0.0, None, []
    for t in range(2):
        diffs.append({})
        for n in rg[t]:
            d = float((cg[t][n] - rg[t][n]).abs().max())
            diffs[t][n] = d
            rel = d / max(float(rg[t][n].abs().max()), 1e-30)
            if worst is None or rel > grad_err:
                grad_err, worst = rel, (t + 1, n)
    b1, b2 = LAMB_BETAS
    state_ok, state_worst, move_worst = True, {}, (0.0, None)
    for n in rs:
        g_max = [float(rg[t][n].abs().max()) for t in range(2)]
        e = [diffs[t][n] for t in range(2)]
        dm = [(1 - b1) * rc[t] * (e[t] + 1e-2 * g_max[t]) for t in range(2)]
        dv = [1.02 * (1 - b2) * rc[t] ** 2 * (2 * g_max[t] + e[t])
              * (e[t] + 1e-2 * g_max[t]) for t in range(2)]
        tol = {"exp_avg": b1 * dm[0] + dm[1] + 1e-9,
               "exp_avg_sq": b2 * dv[0] + dv[1] + 1e-12}
        for key in rs[n]:
            d = (cs[n][key] - rs[n][key]).abs()
            if key == "value":
                bound = sum(2.1 * BERT_LR * rr[t][n]
                            * (_cs_bound(t + 1)
                               + LAMB_WD * rs[n]["value"].abs())
                            for t in range(2)) + 1e-7
                ok = bool((d <= bound).all())
                share = float((d / bound).max())
                moved = float((rs[n]["value"] - p0[n]).norm())
                off = float(d.norm())
                ok &= off <= MOVE_RTOL * moved + 1e-9
                move_share = off / moved if moved > 0 else (
                    0.0 if off == 0 else float("inf"))
                if move_share >= move_worst[0]:
                    move_worst = (move_share, n)
            else:
                ok = float(d.max()) <= tol[key]
                share = float(d.max()) / tol[key]
            state_worst[key] = max(state_worst.get(key, 0.0), share)
            state_ok &= ok
    ffn = ", fused FFN" if fused_ffn else ""
    log(f"[8] BERT O2 + FusedLAMB card vs CPU (4 layers, hidden 256, seq "
        f"128{ffn}, 2 steps): losses card {cl} cpu {rl}, max relative loss "
        f"diff "
        f"{loss_err:.3e} (tolerance {TRAIN_LOSS_RTOL}); grads max |diff| / "
        f"max|grad| {grad_err:.3e} at step {worst[0]} {worst[1]} (tolerance "
        f"{TRAIN_GRAD_TOL}); f32 values (masters), m, v: largest share of "
        f"their update-rule bounds {state_worst}; largest ||card - cpu|| / "
        f"||cpu - p0|| of a leaf {move_worst[0]:.4f} ({move_worst[1]}, "
        f"tolerance {MOVE_RTOL})")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_TOL
            and state_ok):
        raise AssertionError("card and CPU BERT training disagree")
    return dict(losses_card=cl, losses_cpu=rl, loss_rel_err=loss_err,
                grad_rel_err=grad_err, worst_grad=list(worst),
                state_bound_shares=state_worst, move_share=move_worst[0],
                move_worst_leaf=move_worst[1])


def phase_dynamic_skip():
    """A dynamic-loss-scale step with an inf injected into one gradient is
    skipped on the device: masters, m, v, the step count and the
    parameters unchanged bit for bit, and the scale halves."""
    from apex_tpu_torch import amp
    model, opt, state = build_bert("cuda", PARITY_BERT, BERT_LR, 3,
                                   loss_scale="dynamic")
    scaler = state.scaler
    tokens, labels = (t.to("cuda") for t in mlm_batch(
        PARITY_BERT["vocab_size"], (2, 2, PARITY_BERT["max_seq_len"]), 4))
    loss = float(bert_step(model, opt, tokens, labels, scaler))
    snap = {n: ({k: v.clone() for k, v in opt.state[p].items()},
                p.detach().clone()) for n, p in model.named_parameters()}
    step0, scale0 = int(opt.param_groups[0]["step"]), float(
        scaler.loss_scale)
    opt.zero_grad()
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    forward_backward_no_pipelining(
        lambda m, x: x,
        lambda x, t: amp.scale_loss(model.loss(x, t), scaler), model,
        tokens, labels)
    model.layers[1].fc1.weight.grad[3, 5] = float("inf")
    found_inf = amp.unscale_step(opt, scaler)
    torch.cuda.synchronize()
    same = all(torch.equal(p, snap[n][1]) and all(
        torch.equal(opt.state[p][k], v) for k, v in snap[n][0].items())
        for n, p in model.named_parameters())
    step1, scale1 = int(opt.param_groups[0]["step"]), float(
        scaler.loss_scale)
    log(f"[8b] dynamic loss scale: clean step (loss {loss:.5f}) then an inf "
        f"in layers.1.fc1.weight's gradient: found_inf "
        f"{float(found_inf)}, step count {step0} -> {step1}, scale {scale0} "
        f"-> {scale1}, masters/m/v/parameters unchanged bit for bit: {same}")
    if not (float(found_inf) == 1.0 and same and step1 == step0 == 1
            and scale1 == scale0 / 2):
        raise AssertionError("the overflow step was not skipped on the "
                             "device")
    return dict(found_inf=float(found_inf), step_before=step0,
                step_after=step1, scale_before=scale0, scale_after=scale1,
                unchanged=same)


# -- phase 12 ----------------------------------------------------------------

# BERT-large's attention scores (micro-batch 16, 16 heads, seq 512) and
# GPT-350M's (micro-batch 8, 16 heads, seq 1024); GPT-350M's head logits
SOFTMAX_PADDED = (16, 16, 512, 512)
SOFTMAX_CAUSAL = (8, 16, 1024, 1024)
XENT_ROWS, XENT_PAD = MICRO * SEQ, 0
# CPU copies take the first batch entry's first two heads, and the first
# 64 rows of the logits
SLICE_HEADS, XENT_SLICE = 2, 64


def _softmax_on_card_and_cpu(tag, module, x, mask, gen_cuda):
    """Forward and backward of ``module`` on the card, then on a CPU copy of
    the first batch entry's first heads: outputs within one bf16 ulp
    (2**-8 absolute, 2**-7 relative), input gradients within 2**-6
    relative and 1e-3 of the largest entry."""
    dy = torch.randn(x.shape, generator=gen_cuda, device="cuda",
                     dtype=x.dtype)
    xg = x.detach().clone().requires_grad_(True)
    y = module(xg, mask)
    y.backward(dy)
    rows = (slice(0, 1), slice(0, SLICE_HEADS))
    xc = x[rows].cpu().requires_grad_(True)
    mc = None if mask is None else mask[:1].cpu()
    yc = module(xc, mc)
    yc.backward(dy[rows].cpu())
    y_err = check_close(f"{tag} output", y[rows].detach().cpu(),
                        yc.detach(), 2.0 ** -8, 2.0 ** -7)
    ref = xc.grad
    dx_err = check_close(f"{tag} input gradient", xg.grad[rows].cpu(), ref,
                         1e-3 * max_err(ref, torch.zeros_like(ref)),
                         2.0 ** -6)
    fwd_ms = call_ms(lambda: module(x, mask), iters=10)

    def fwd_bwd():
        xg.grad = None
        module(xg, mask).backward(dy)
    step_ms = call_ms(fwd_bwd, iters=10)
    log(f"{tag} {tuple(x.shape)} {x.dtype}: forward {fwd_ms:.4f} ms, "
        f"forward + backward {step_ms:.4f} ms (eager, plain PyTorch)")
    return dict(shape=list(x.shape), output_max_abs_err=y_err,
                grad_max_abs_err=dx_err, forward_ms=fwd_ms,
                forward_backward_ms=step_ms)


def _xentropy_on_card_and_cpu(gen_cuda):
    """``SoftmaxCrossEntropyLoss`` at GPT-350M's head (8192 x 50304 bf16,
    smoothing 0.1, ``half_to_float``, padding index 0 on every 16th row
    and wherever a label is 0): padded rows give zero loss and gradient;
    the first 64 rows against a CPU copy (loss 1e-4 + 1e-5 relative, the
    bf16 gradient 2**-7 relative and 1e-6 of its largest entry)."""
    from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss
    vocab = GPT350M["vocab_size"]
    logits = 3 * torch.randn((XENT_ROWS, vocab), generator=gen_cuda,
                             device="cuda", dtype=torch.bfloat16)
    labels = torch.randint(0, vocab, (XENT_ROWS,), generator=gen_cuda,
                           device="cuda")
    labels[::16] = XENT_PAD
    dloss = torch.rand((XENT_ROWS,), generator=gen_cuda, device="cuda")
    args = (0.1, XENT_PAD, True)
    lg = logits.clone().requires_grad_(True)
    loss = SoftmaxCrossEntropyLoss.apply(lg, labels, *args)
    loss.backward(dloss)
    pad = labels == XENT_PAD
    if not (loss.dtype == torch.float32 and bool(torch.isfinite(loss).all())
            and float(loss[pad].abs().max()) == 0.0
            and float(lg.grad[pad].float().abs().max()) == 0.0):
        raise AssertionError("[12] xentropy: padded rows carry a loss or a "
                             "gradient, or the loss is not finite f32")
    lc = logits[:XENT_SLICE].cpu().requires_grad_(True)
    ref = SoftmaxCrossEntropyLoss.apply(lc, labels[:XENT_SLICE].cpu(), *args)
    ref.backward(dloss[:XENT_SLICE].cpu())
    loss_err = check_close("[12] xentropy loss",
                           loss[:XENT_SLICE].detach().cpu(), ref.detach(),
                           1e-4, 1e-5)
    grad_err = check_close(
        "[12] xentropy gradient", lg.grad[:XENT_SLICE].cpu(), lc.grad,
        1e-6 * max_err(lc.grad, torch.zeros_like(lc.grad)), 2.0 ** -7)
    fwd_ms = call_ms(lambda: SoftmaxCrossEntropyLoss.apply(logits, labels,
                                                           *args), iters=10)

    def fwd_bwd():
        lg.grad = None
        SoftmaxCrossEntropyLoss.apply(lg, labels, *args).backward(dloss)
    step_ms = call_ms(fwd_bwd, iters=10)
    log(f"[12] xentropy ({XENT_ROWS} x {vocab} bf16, smoothing 0.1, "
        f"half_to_float, {int(pad.sum())} padded rows): forward "
        f"{fwd_ms:.4f} ms, forward + backward {step_ms:.4f} ms (eager, plain "
        f"PyTorch)")
    return dict(loss_max_abs_err=loss_err, grad_max_abs_err=grad_err,
                padded_rows=int(pad.sum()), forward_ms=fwd_ms,
                forward_backward_ms=step_ms)


def _legacy_skip(tag, model, opt, step, state_of, scale_of):
    """A clean step, then one with an inf in one gradient: the second is
    skipped on the device (parameters, optimizer state and step count
    unchanged bit for bit) and the scale halves."""
    first = step(False)
    snap = {n: (p.detach().clone(),
                {k: v.clone() for k, v in state_of(p).items()})
            for n, p in model.named_parameters()}
    step0, scale0 = int(opt.param_groups[0]["step"]), scale_of()
    found_inf = float(step(True))
    torch.cuda.synchronize()
    same = all(torch.equal(p, snap[n][0]) and all(
        torch.equal(state_of(p)[k], v) for k, v in snap[n][1].items())
        for n, p in model.named_parameters())
    step1, scale1 = int(opt.param_groups[0]["step"]), scale_of()
    log(f"{tag} clean step (found_inf {first}), then an inf in "
        f"layers.1.mlp.fc1.weight's gradient: found_inf {found_inf}, step "
        f"count {step0} -> {step1}, scale {scale0} -> {scale1}, parameters "
        f"and optimizer state unchanged bit for bit: {same}")
    if not (first == 0.0 and found_inf == 1.0 and same
            and step1 == step0 == 1 and scale1 == scale0 / 2):
        raise AssertionError(f"{tag} the overflow step was not skipped")
    return dict(found_inf=found_inf, step_before=step0, step_after=step1,
                scale_before=scale0, scale_after=scale1, unchanged=same)


def _legacy_amp_on_card():
    """``amp.init()`` + ``wrap_optimizer(FusedAdam)`` and
    ``FP16_Optimizer(dynamic_loss_scale=True)`` over ``network_to_half``
    on phase 6's small GPT: each skips an injected overflow step."""
    from apex_tpu_torch import amp, fp16_utils
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(**PARITY_TRAIN)
    rng = np.random.RandomState(5)
    shape = (2, PARITY_TRAIN["max_seq_len"])
    tokens, targets = (torch.from_numpy(rng.randint(0, cfg.vocab_size, shape))
                       .to("cuda") for _ in range(2))

    def inject(model):
        model.layers[1].mlp.fc1.weight.grad[3, 5] = float("inf")

    out = {}
    model = GPTModel(cfg, device="cuda").init_params(
        torch.Generator().manual_seed(4))
    handle = amp.init(loss_scale="dynamic", device="cuda")
    opt = handle.wrap_optimizer(FusedAdam(model.parameters(), lr=LR))

    def legacy_step(bad):
        opt.zero_grad()
        with handle.scale_loss(model.loss(tokens, targets, 3)) as scaled:
            scaled.backward()
        if bad:
            inject(model)
        return float(opt.step())
    try:
        out["amp_init"] = _legacy_skip(
            "[12] amp.init + wrap_optimizer(FusedAdam):", model, opt,
            legacy_step, lambda p: opt.optimizer.state[p], handle.loss_scale)
    finally:
        handle._deactivate()
    out["amp_init"]["scaler"] = handle.scaler.stats()

    model = fp16_utils.network_to_half(GPTModel(cfg, device="cuda")
                                       .init_params(
        torch.Generator().manual_seed(4)))
    fopt = fp16_utils.FP16_Optimizer(FusedAdam(model.parameters(), lr=LR),
                                     dynamic_loss_scale=True)

    def fp16_step(bad):
        fopt.zero_grad()
        fopt.backward(model.loss(tokens, targets, 3))
        if bad:
            inject(model)
        return float(fopt.step())
    out["fp16_optimizer"] = _legacy_skip(
        "[12] network_to_half + FP16_Optimizer(FusedAdam, dynamic):", model,
        fopt, fp16_step, lambda p: fopt.optimizer.state[p],
        lambda: fopt.loss_scale)
    out["fp16_optimizer"]["scaler"] = fopt.loss_scaler.stats()
    return out


def phase_new_ops():
    """Phase 12: the fused softmax module and the softmax cross entropy at
    full width, card against CPU copies, and the legacy amp surface's
    overflow skip on the card (its kernels counted, no plain version)."""
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax
    gen_cuda = torch.Generator(device="cuda").manual_seed(12)
    out = {}
    b, _, _, s = SOFTMAX_PADDED
    x = torch.randn(SOFTMAX_PADDED, generator=gen_cuda, device="cuda",
                    dtype=torch.bfloat16) * 3
    lens = torch.randint(s // 4, s + 1, (b,), generator=gen_cuda,
                         device="cuda")
    mask = (torch.arange(s, device="cuda")[None, :] >= lens[:, None])[
        :, None, None, :]                       # True past each length
    out["padding"] = _softmax_on_card_and_cpu(
        "[12] FusedScaleMaskSoftmax padding", FusedScaleMaskSoftmax(
            attn_mask_type=AttnMaskType.padding, scale=0.125), x, mask,
        gen_cuda)
    del x, mask
    x = torch.randn(SOFTMAX_CAUSAL, generator=gen_cuda, device="cuda",
                    dtype=torch.bfloat16) * 3
    out["causal"] = _softmax_on_card_and_cpu(
        "[12] FusedScaleMaskSoftmax causal", FusedScaleMaskSoftmax(
            attn_mask_type=AttnMaskType.causal, scale=0.125), x, None,
        gen_cuda)
    del x
    torch.cuda.empty_cache()
    out["xentropy"] = _xentropy_on_card_and_cpu(gen_cuda)
    torch.cuda.empty_cache()
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    with counting_plain_versions() as plain_calls:
        out.update(_legacy_amp_on_card())
    launches = {c.__name__: c.launches for c in counters if c.launches}
    log(f"[12] legacy amp launches {launches}; plain-version calls "
        f"{dict(plain_calls)}")
    if sum(plain_calls.values()) or not (launches.get("multi_tensor_adam")
                                         and launches.get(
                                             "multi_tensor_sumsq")):
        raise AssertionError("[12] the legacy amp steps did not run the "
                             "Adam and found-inf kernels alone")
    out["legacy_launches"] = launches
    return out


# -- phase 9 -----------------------------------------------------------------

# examples/imagenet/main_amp.py at its defaults: ResNet-50, batch 256 at
# 224 x 224, 1000 classes, FusedSGD(lr 0.1, momentum 0.9, wd 1e-4),
# synthetic data from seed 0; a warm-up step, then 4 steps
RESNET_ARGV = ["--arch", "resnet50", "--batch-size", "256", "--image-size",
               "224", "--num-classes", "1000", "--steps", "4",
               "--print-freq", "4", "--seed", "0", "--lr", "0.1",
               "--momentum", "0.9", "--weight-decay", "1e-4"]
RESNET_STEPS = 1 + 4


def _all_counters():
    from apex_tpu_torch.ops import multi_tensor as K
    return tuple(dict.fromkeys(_train_counters() + _bert_counters() + (
        K.multi_tensor_scale_, K.multi_tensor_axpby_, K.multi_tensor_sgd,
        K.multi_tensor_adagrad, K.multi_tensor_novograd)))


def _launches_of(counters):
    return {c.__name__: c.launches for c in counters if c.launches}


def phase_resnet(opt_level, tag):
    """The ported ImageNet example's ``main()`` at ``opt_level``: losses,
    step times, img/s and peak memory; every kernel counter read around
    the run (only #19, exactly ``sgd_launches`` per step) and no plain
    version called.  Returns the trainer and the numbers."""
    from apex_tpu_torch.examples.imagenet import main_amp
    numels = [int(np.prod(s)) for s, _ in resnet50_specs(opt_level)]
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    with counting_plain_versions() as plain_calls:
        res = main_amp.main(RESNET_ARGV + ["--opt-level", opt_level])
    torch.cuda.synchronize()
    launches = _launches_of(counters)
    trainer = res.pop("trainer")
    batch = res.pop("batch")
    from apex_tpu_torch.ops.multi_tensor import sgd_launches
    per_step = sgd_launches(numels)
    expected = {"multi_tensor_sgd": RESNET_STEPS * per_step}
    step_s = statistics.median(res["step_times_s"])
    peak = res["peak_memory_bytes"]
    log(f"{tag} ResNet-50 ImageNet {opt_level} (examples/imagenet/main_amp,"
        f" batch 256 x 224^2, FusedSGD lr 0.1): warm-up loss "
        f"{res['warmup_loss']:.5f}, losses "
        f"{[round(x, 5) for x in res['losses']]}; step times (s) "
        f"{[round(t, 4) for t in res['step_times_s']]}, median "
        f"{step_s:.4f} s, {256 / step_s:.1f} img/s (main's "
        f"{res['images_per_s']:.1f}); peak memory {peak / 2 ** 30:.2f} GiB")
    log(f"    launches {launches} (expected {expected}: {per_step} per "
        f"step over {len(numels)} tensors); plain-version calls "
        f"{dict(plain_calls)}")
    if not np.all(np.isfinite(res["losses"] + [res["warmup_loss"]])):
        raise AssertionError(f"non-finite ResNet-50 loss: {res['losses']}")
    if launches != expected:
        raise AssertionError("ResNet-50 launch counts do not match the path")
    if sum(plain_calls.values()):
        raise AssertionError(f"the ResNet-50 path called plain versions: "
                             f"{dict(plain_calls)}")
    model, opt = trainer.model, trainer.optimizer
    if opt_level == "O2":
        f32 = {n for n, p in model.named_parameters()
               if p.dtype == torch.float32}
        if not (f32 and all("bn_" in n for n in f32)
                and all(("master" in opt.state[p])
                        == (p.dtype == torch.bfloat16)
                        for p in model.parameters())):
            raise AssertionError("O2: batch norm not f32 or masters missing")
        log(f"    O2: {len(f32)} batch-norm parameters f32, "
            f"{len(numels) - len(f32)} bf16 with f32 masters")
    res.update(median_step_s=step_s, launches=launches,
               launches_per_step={k: v // RESNET_STEPS
                                  for k, v in launches.items()},
               sgd_tensors=len(numels), sgd_elements=sum(numels))
    return trainer, batch, res


def phase_resnet_optimizers(trainer, batch, tag="[9c]"):
    """One step each with FusedAdagrad and FusedNovoGrad in place of
    FusedSGD on phase 9b's model (bf16 with f32 batch norm, masters): exact
    launches of #22, and of #17 (per-tensor sums) and #23."""
    from apex_tpu_torch.optimizers import FusedAdagrad, FusedNovoGrad
    model = trainer.model
    numels = [p.numel() for p in model.parameters()]
    table = table_launches(numels)
    out = {}
    for cls, kw, expected in (
            (FusedAdagrad, dict(lr=1e-3, weight_decay=1e-4),
             {"multi_tensor_adagrad": table}),
            (FusedNovoGrad, dict(lr=1e-3, weight_decay=1e-4),
             {"multi_tensor_sumsq": sumsq_launches(numels, per_tensor=True),
              "multi_tensor_novograd": table})):
        trainer.optimizer = cls(model.parameters(), master_weights=True,
                                **kw)
        counters = _all_counters()
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        with counting_plain_versions() as plain_calls:
            t0 = time.perf_counter()
            loss = float(trainer.step(*batch))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = _launches_of(counters)
        log(f"{tag} {cls.__name__} step on ResNet-50 O2: loss {loss:.5f}, "
            f"{dt:.4f} s; launches {launches} (expected {expected}); "
            f"plain-version calls {dict(plain_calls)}")
        if not np.isfinite(loss) or launches != expected or sum(
                plain_calls.values()):
            raise AssertionError(f"{cls.__name__} on ResNet-50: launches, "
                                 f"plain calls or loss")
        out[cls.__name__] = dict(loss=loss, step_s=dt, launches=launches)
    return out


def phase_resnet_baseline(tag="[9d]"):
    """The example's hand-written SGD (``--no-fused-sgd``) at O1, a warm-up
    step and one step: its overflow check is #17 and its parameter update
    #16, exact launches of both; no plain version called."""
    from apex_tpu_torch.examples.imagenet import main_amp
    numels = [int(np.prod(s)) for s, _ in resnet50_specs("O1")]
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    with counting_plain_versions() as plain_calls:
        res = main_amp.main(RESNET_ARGV + ["--opt-level", "O1", "--steps",
                                           "1", "--no-fused-sgd"])
    torch.cuda.synchronize()
    res.pop("trainer")
    res.pop("batch")
    launches = _launches_of(counters)
    expected = {"multi_tensor_sumsq": 2 * sumsq_launches(numels),
                "multi_tensor_axpby_": 2 * table_launches(numels)}
    log(f"{tag} ResNet-50 O1, hand-written SGD: losses "
        f"{[res['warmup_loss']] + res['losses']}, step "
        f"{res['step_times_s'][0]:.4f} s; launches {launches} (expected "
        f"{expected}); plain-version calls {dict(plain_calls)}")
    if (launches != expected or sum(plain_calls.values())
            or not np.all(np.isfinite(res["losses"]))):
        raise AssertionError("the hand-written SGD path: launches, plain "
                             "calls or losses")
    res["launches"] = launches
    return res


# -- phase 10 ----------------------------------------------------------------

PARITY_RESNET = dict(width=16, num_classes=10)
PARITY_IMAGES, PARITY_BATCH = 64, 8


def _matmul_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)


def _set_matmul_flags(flags):
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = \
        flags


def _resnet_two_steps(device, opt_level, cls, kw, x, y):
    """``resnet26`` (width 16) from seed 0 under ``opt_level``, 2 steps of
    ``cls`` on one batch: the losses, the first step's gradients (same
    parameters on every side), the parameters' moves and the BN running
    statistics after the steps, on the CPU."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.resnet import resnet26
    model = resnet26(device=device, **PARITY_RESNET).init_params(
        torch.Generator().manual_seed(0))
    p0 = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    opt = cls(model.parameters(), **kw)
    amp.initialize(model, opt, opt_level=opt_level)
    xd, yd = x.to(device), y.to(device)
    losses, grads = [], None
    for step in range(2):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(xd, yd)
        loss.backward()
        if step == 0:
            grads = {n: p.grad.detach().float().cpu()
                     for n, p in model.named_parameters()}
        opt.step()
        losses.append(float(loss.detach()))
    moves = {n: p.detach().float().cpu() - p0[n]
             for n, p in model.named_parameters()}
    stats = {n: b.detach().float().cpu() for n, b in model.named_buffers()
             if "running" in n}
    return dict(losses=losses, grads=grads, moves=moves, stats=stats)


# Card vs CPU under O1: both round the same values to bf16 (the
# convolutions' inputs) but sum the products in other orders, and a bf16
# rounding that flips is amplified by the batch norms (8 images, a 2 x 2
# map at stage 4): a gradient whose terms cancel (the BN parameters') moves
# by up to ~70% between bf16 and f32 on the CPU.  So the yardstick is the
# CPU's own O1-to-f32 distance d: each tensor (gradient, parameter move,
# running statistic) of the card within 3 d + a share of the f32 tensor's
# norm (1e-2; 1e-3 for the running statistics), the whole first-step
# gradient within d + 1e-2 of its norm, and each loss within 3 d + 2e-3 of
# it.  The card's bf16 convolutions land further from the CPU's than the
# CPU's from f32: on an H100 (700 W) a 2 d bound was 0.79-0.92 used by
# the losses and 0.72 by the moves, so the factor is 3.
PARITY_SHARE = {"grads": 1e-2, "moves": 1e-2, "stats": 1e-3}


def _parity_check(tag, card, cpu, f32):
    norm = np.linalg.norm
    worst = {}
    for key, share in PARITY_SHARE.items():
        ratio = 0.0
        for n in cpu[key]:
            a, b, c = (r[key][n].numpy().astype(np.float64)
                       for r in (card, cpu, f32))
            bound = 3 * norm(b - c) + share * norm(c)
            ratio = max(ratio, norm(a - b) / max(bound, 1e-30))
        worst[key] = float(ratio)
    cat = {k: np.concatenate([r["grads"][n].numpy().ravel()
                              for n in sorted(cpu["grads"])])
           for k, r in (("card", card), ("cpu", cpu), ("f32", f32))}
    worst["grads_global"] = float(norm(cat["card"] - cat["cpu"]) / (
        norm(cat["cpu"] - cat["f32"]) + 1e-2 * norm(cat["f32"])))
    worst["losses"] = max(abs(a - b) / (3 * abs(b - c) + 2e-3 * abs(c))
                          for a, b, c in zip(card["losses"], cpu["losses"],
                                             f32["losses"]))
    log(f"{tag} losses card {[round(v, 5) for v in card['losses']]} cpu "
        f"{[round(v, 5) for v in cpu['losses']]} cpu f32 "
        f"{[round(v, 5) for v in f32['losses']]}; worst share of the bound "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()))
    if max(worst.values()) > 1.0:
        raise AssertionError(f"{tag}: the card and the CPU disagree beyond "
                             f"the bound")
    return worst


def phase_resnet_parity(flags_at_start):
    """resnet26 (width 16, 64 x 64, batch 8, 10 classes) trained 2 steps
    under O1 on the card and on a CPU copy (and in f32 on the CPU, the
    yardstick), with each of FusedSGD, FusedAdagrad and FusedNovoGrad;
    then FusedSGD's card run again with the matmul flags as torch set them
    before any GPTModel turned them (TF32, bf16 reduced-precision
    reduction) process-wide."""
    from apex_tpu_torch.optimizers import (FusedAdagrad, FusedNovoGrad,
                                           FusedSGD)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(PARITY_BATCH, PARITY_IMAGES,
                                   PARITY_IMAGES, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, PARITY_BATCH))
    out = {}
    for cls, kw in ((FusedSGD, dict(lr=0.1, momentum=0.9,
                                    weight_decay=1e-4)),
                    (FusedAdagrad, dict(lr=1e-2, weight_decay=1e-4)),
                    (FusedNovoGrad, dict(lr=1e-2, weight_decay=1e-3))):
        card = _resnet_two_steps("cuda", "O1", cls, kw, x, y)
        cpu = _resnet_two_steps("cpu", "O1", cls, kw, x, y)
        f32 = _resnet_two_steps("cpu", "O0", cls, kw, x, y)
        out[cls.__name__] = _parity_check(f"[10] {cls.__name__} card vs "
                                          f"CPU, O1", card, cpu, f32)
        if cls is FusedSGD:
            now = _matmul_flags()
            _set_matmul_flags(flags_at_start)
            try:
                default = _resnet_two_steps("cuda", "O1", cls, kw, x, y)
            finally:
                _set_matmul_flags(now)
            diff = max(float((default[k][n] - card[k][n]).abs().max())
                       for k in ("grads", "moves", "stats")
                       for n in card[k])
            log(f"[10] matmul flags (tf32, cudnn tf32, bf16 reduced "
                f"reduction) as the GPT phases left them {now} against "
                f"torch's at start {flags_at_start}: losses "
                f"{card['losses']} vs {default['losses']}, largest "
                f"difference of a gradient, move or running statistic "
                f"{diff:.3e}")
            out["flags"] = dict(now=now, at_start=flags_at_start,
                                max_diff=diff,
                                losses=[card["losses"], default["losses"]])
    return out


# -- optional: where the time goes ------------------------------------------

_KERNEL_CLASSES = (("layer_norm_bwd", "layer_norm_bwd"),
                   # the row-per-warp body and the block-per-row one
                   ("layer_norm_fwd_", "layer_norm_fwd"),
                   ("flash_fwd_", "flash_fwd"),     # _mma_ (bf16), _fma_
                   ("flash_bwd_dq_", "flash_attention_dq"),   # _mma_, _fma_
                   ("flash_bwd_dkv_", "flash_attention_dkv"),
                   # the split-K pass and the combine of #7, then of #6
                   ("flash_decode_paged_", "flash_attention_decode_paged"),
                   ("flash_decode_", "flash_attention_decode"),
                   ("qgemm_", "quant_gemm"),
                   ("multi_tensor_adam_kernel", "multi_tensor_adam"),
                   ("multi_tensor_scale_kernel", "multi_tensor_scale_"),
                   ("multi_tensor_l2norm_kernel", "multi_tensor_sumsq"),
                   ("multi_tensor_sum_partials", "multi_tensor_sumsq"),
                   ("lamb_stage1_kernel", "multi_tensor_lamb_stage1"),
                   ("lamb_stage2_kernel", "multi_tensor_lamb_stage2"),
                   ("multi_tensor_axpby_kernel", "multi_tensor_axpby_"),
                   ("multi_tensor_sgd_kernel", "multi_tensor_sgd"),
                   ("multi_tensor_adagrad_kernel", "multi_tensor_adagrad"),
                   ("multi_tensor_novograd_kernel", "multi_tensor_novograd"),
                   ("lm_head_fwd", "lm_head_fwd"),
                   # csrc/gemm.cuh's launches by their epilogue type: the
                   # LM head's forward product (its row partials), dS (once
                   # a backward, filed under dX as its launches count), dX
                   # and dW;
                   # the forward's (BiasGelu, Bias); the backward's dh =
                   # dy W2 (DzFromDh, once a backward, filed under dX as
                   # its launch counts) and dX (DxOut); dW1, dW2 (DwOut)
                   ("ffn::Bias", "ffn_fwd"),
                   ("ffn::DzFromDh", "ffn_dx"),
                   ("ffn::DxOut", "ffn_dx"),
                   ("ffn::DwOut", "ffn_dw"),
                   ("lm_head::LseFromScores", "lm_head_fwd"),
                   ("lm_head::DsFromScores", "lm_head_dx"),
                   ("lm_head::DxOut", "lm_head_dx"),
                   ("lm_head::DwOut", "lm_head_dw"),
                   ("ffn_db1_kernel", "ffn_dw"))


def _kernel_class(name):
    for key, cls in _KERNEL_CLASSES:
        if key in name:
            return cls
    low = name.lower()
    if "batch_norm" in low or "batchnorm" in low:
        return "batch norm"
    if any(k in low for k in ("fprop", "dgrad", "wgrad", "conv")):
        return "convolution (cuDNN)"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul (cuBLAS)"
    return "other (elementwise, copies, indexing)"


def _profile_programs(programs, lines):
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, fn in programs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_class, by_name, n_kernels = {}, {}, 0
        for e in prof.events():
            # device kernels only: a user annotation (Optimizer.step's
            # range) spans kernels already counted
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or getattr(e, "is_user_annotation", False)):
                continue
            ms = e.device_time_total / 1e3
            n_kernels += 1
            cls = _kernel_class(e.name)
            by_class[cls] = by_class.get(cls, 0.0) + ms
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
        busy = sum(by_class.values())
        out[name] = dict(wall_ms=wall_ms, device_busy_ms=busy,
                         idle_share=1 - busy / wall_ms, kernels=n_kernels,
                         by_class=by_class)
        log(f"[p] {name}: wall {wall_ms:.3f} ms under the profiler, device "
            f"busy {busy:.3f} ms ({n_kernels} kernels), idle share "
            f"{1 - busy / wall_ms:.3f}; " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in sorted(
                    by_class.items(), key=lambda kv: -kv[1])))
        lines.append(f"== {name} wall {wall_ms:.3f} ms busy {busy:.3f} ms")
        lines += [f"{v:10.4f} ms  {k[:150]}" for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:25]]
    return out


def phase_profile_serving(model, rng, lines, suffix=""):
    """torch.profiler over one prefill(512) and one 8-slot decode step:
    device time by kernel class, and the device's idle share of the
    profiled wall time (``suffix`` tags the programs' names)."""
    cfg = model.cfg
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 512))).to(
        "cuda")
    cache = torch.zeros((SLOTS, cfg.num_layers, 2, cfg.max_seq_len, HEADS,
                         HEAD_DIM), dtype=cfg.dtype, device="cuda")
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, SLOTS)).to(
        "cuda")
    positions = torch.full((SLOTS,), 512, dtype=torch.int32, device="cuda")
    return _profile_programs(
        {"prefill_512" + suffix: lambda: model.prefill(prompt),
         "decode_step_8_slots" + suffix: lambda: model.decode_step(
             tokens, cache, positions)}, lines)


def phase_profile_paged(model, qmodel, lines):
    """torch.profiler over one paged decode step (8 slots at position 512)
    with f32 weights and with int8 weights, and one int8 prefill(512)."""
    cfg = model.cfg
    rng = np.random.RandomState(2)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 512))).to(
        "cuda")
    pool = torch.zeros((PAGED_POOL, cfg.num_layers, 2, PAGED_BS, HEADS,
                        HEAD_DIM), dtype=cfg.dtype, device="cuda")
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, SLOTS)).to(
        "cuda")
    positions = torch.full((SLOTS,), 512, dtype=torch.int32, device="cuda")
    tables = paged_step_tables()
    return _profile_programs(
        {"decode_step_paged_8_slots": lambda: model.decode_step_paged(
            tokens, pool, tables, positions),
         "decode_step_paged_8_slots_int8": lambda: qmodel.decode_step_paged(
             tokens, pool, tables, positions),
         "prefill_512_int8": lambda: qmodel.prefill(prompt)}, lines)


def phase_profile_train(model, opt, tokens, targets, lines,
                        name="train_step"):
    """torch.profiler over one whole training step (2 micro-batches of
    loss + backward, then FusedAdam)."""
    return _profile_programs(
        {name: lambda: train_step(model, opt, tokens, targets)}, lines)


def phase_profile_bert(model, opt, tokens, labels, lines,
                       name="bert_train_step"):
    """torch.profiler over one whole BERT-large step (2 micro-batches of
    loss + backward, then FusedLAMB)."""
    return _profile_programs(
        {name: lambda: bert_step(model, opt, tokens, labels)}, lines)


def log_fused_change(tag, base, fused):
    """Step time, tokens/s and peak memory of a fused_ffn=True training run
    beside the same path's unfused run (this process, this card)."""
    log(f"{tag} fused_ffn=True against False: median step "
        f"{fused['median_step_s']:.4f} s vs {base['median_step_s']:.4f} s "
        f"({fused['median_step_s'] / base['median_step_s']:.3f}x), "
        f"{fused['tokens_per_s']:.1f} vs {base['tokens_per_s']:.1f} "
        f"tokens/s, peak memory {fused['peak_memory_bytes'] / 2 ** 30:.2f} "
        f"vs {base['peak_memory_bytes'] / 2 ** 30:.2f} GiB")


# -- main --------------------------------------------------------------------

# -- phase 13 ----------------------------------------------------------------

FLEET_SLOTS = 4                # slots of each fleet replica (13a, 13b)
FLEET_NEW_TOKENS = 32
SEQ_NEW_TOKENS = 16            # 13d's one-at-a-time runs, 13e
FLEET_REASONS = ("eos", "length", "evicted", "timeout", "error", "preempted",
                 "migrated", "cancelled")


def _loadgen():
    """``tools/loadgen_torch.py``, the fleet's entry point, as a module."""
    tools = str(pathlib.Path(__file__).resolve().parent / "tools")
    sys.path.insert(0, tools)
    try:
        return importlib.import_module("loadgen_torch")
    finally:
        sys.path.remove(tools)


def fleet_args(scenario, **kw):
    """``tools/loadgen_torch.py``'s flags for phase 13's fleet: 3 replicas
    of 4 slots with blocks of 16, 16 requests of 4..512 prompt tokens
    (bounded Pareto) of which about half sit behind one 64-token prefix,
    32 new tokens each, arriving at once; replica 1 crashes at tick 4 for
    good (``replica_kill``).  Ticks are 0.02 s of a virtual clock."""
    base = dict(
        scenario=scenario, requests=16, rate=1e9, replicas=3,
        max_slots=FLEET_SLOTS, max_queue=64, max_queue_depth=8,
        burn_threshold=14.4, burn_window_s=60.0, ttft_slo_s=0.5,
        block_size=PAGED_BS, chunked=False, token_budget=64,
        client_retries=3, tick_s=0.02, e2e_slo_s=3.0, max_ticks=3000,
        retry_budget=4, hedge_after_s=None, ladder_step_down_s=0.5,
        kill_tick=4, kill_replica=1, kill_duration=10 ** 6, slow_tick=4,
        slow_s=0.1, slow_duration=40, burst_n=8, burst_gap_s=0.5,
        period_s=4.0, seed=0, min_prompt=4, pareto_shape=2.5,
        max_new=FLEET_NEW_TOKENS, shared_prefix_prob=0.5,
        shared_prefix_len=SYSTEM_PROMPT, num_prefixes=1,
        vocab=GPT350M["vocab_size"], hidden=HIDDEN,
        layers=GPT350M["num_layers"], heads=HEADS,
        max_seq=512 + FLEET_NEW_TOKENS + 1, device="cuda", trace=True)
    base.update(kw)
    return argparse.Namespace(**base)


@contextlib.contextmanager
def counting_programs():
    """Count the engines' device programs while the block runs: monolithic
    prefills (``prefill``) and prefill chunks (``chunk``) of every engine.
    Decode steps are each engine's ``metrics.occupancy`` entries."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.serving import PagedInferenceEngine
    counts = collections.Counter()
    patched = ((InferenceEngine, "_prefill_context", "prefill"),
               (PagedInferenceEngine, "_chunk_forward", "chunk"))
    saved = [(cls, name, cls.__dict__[name]) for cls, name, _ in patched]
    for (cls, name, key), (_, _, fn) in zip(patched, saved):
        def counted(self, *args, _fn=fn, _key=key):
            counts[_key] += 1
            return _fn(self, *args)
        setattr(cls, name, counted)
    try:
        yield counts
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)


def fleet_counted(tag, run, engines=None):
    """Run ``run()`` (which returns ``(result, engines)``) with the serving
    kernels' counters set to 0 just before and read just after, the
    engines' device programs and plain-version calls counted.  Returns
    ``(result, launches dict for check_launches)``; fails on a plain
    version called or an ``"error"`` response."""
    counters = _serving_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting_programs() as programs, \
            counting_plain_versions() as plain_calls:
        result, engines = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    if sum(plain_calls.values()):
        raise AssertionError(f"{tag} called plain versions: "
                             f"{dict(plain_calls)}")
    errors = [(r.request_id, r.error) for e in engines for r in e.completed
              if r.finish_reason == "error"]
    if errors:
        raise AssertionError(f"{tag} requests failed inside an engine: "
                             f"{errors}")
    steps = sum(len(e.metrics.occupancy) for e in engines)
    return result, dict(launches=launches, prefills=programs["prefill"],
                        chunks=programs["chunk"], steps=steps, wall_s=wall)


def _exactly_once(tag, rep):
    if rep["lost"] or rep["duplicated"] or rep["fleet_pending"] \
            or rep["responses"] != rep["submitted"]:
        raise AssertionError(
            f"{tag} exactly-once broken: {rep['submitted']} submitted, "
            f"{rep['responses']} answered, lost {rep['lost']}, duplicated "
            f"{rep['duplicated']}, pending {rep['fleet_pending']}")


def _registry_ledger(tag, engines, responses):
    """The engines' ``serving_requests_total`` and
    ``serving_finished_total{reason}`` against the responses: every request
    an engine took reached a terminal reason there, and the eos / length
    finishes are the fleet's eos / length responses."""
    took = finished = 0
    by_reason = collections.Counter()
    for e in engines:
        reg = e.metrics.registry
        took += reg.get("serving_requests_total").value()
        fin = reg.get("serving_finished_total")
        for reason in FLEET_REASONS:
            n = fin.value(reason=reason)
            by_reason[reason] += n
            finished += n
    answered = collections.Counter(r.finish_reason for r in responses)
    ok = took == finished and all(
        by_reason[r] == answered[r] for r in ("eos", "length"))
    nonzero = {k: v for k, v in by_reason.items() if v}
    log(f"    registry: serving_requests_total {took:g}, "
        f"serving_finished_total {nonzero}; responses {dict(answered)}")
    if not ok:
        raise AssertionError(f"{tag} the registry's serving series do not "
                             "match the responses")
    return dict(requests_total=took, finished_total=dict(by_reason))


def phase_fleet_kill(model, smi):
    """13a: ``replica_kill`` through ``tools/loadgen_torch.py`` on three
    replicas of GPT-350M, against one uninterrupted paged engine on the
    same prompts; then 13f's tracer-off run of the same scenario."""
    from apex_tpu_torch.inference import Request
    from apex_tpu_torch.observability import check_flows
    from apex_tpu_torch.serving import PagedInferenceEngine
    lg = _loadgen()
    args = fleet_args("replica_kill")
    work = lg.synthesize_scenario(args)
    lens = [len(r.prompt) for _, r in work]
    log(f"[13a] replica_kill: {args.replicas} x PagedInferenceEngine("
        f"max_slots={FLEET_SLOTS}, block_size={PAGED_BS}), {len(work)} "
        f"requests of {min(lens)}..{max(lens)} prompt tokens ({lens}), "
        f"{FLEET_NEW_TOKENS} new tokens, replica {args.kill_replica} "
        f"crashing at tick {args.kill_tick}")
    ref = PagedInferenceEngine(model, max_slots=FLEET_SLOTS,
                               block_size=PAGED_BS)
    for _, r in work:
        ref.submit(Request(r.request_id, list(r.prompt),
                           max_new_tokens=r.max_new_tokens))
    want = {r.request_id: r.tokens for r in ref.run()}
    del ref
    stack = {}

    def run():
        rep = lg.run_scenario(args, model=model, stack=stack)
        return rep, stack["replicas"]
    rep, counted = fleet_counted("[13a]", run)
    fleet, replicas = stack["fleet"], stack["replicas"]
    responses = fleet.completed
    got = {r.request_id: r.tokens for r in responses}
    check_launches("[13a]", counted, model.cfg.num_layers, paged=True)
    _exactly_once("[13a]", rep)
    trans = {i: [(a, b) for _, r, a, b in rep["health_log"] if r == i]
             for i in range(args.replicas)}
    rec = rep["recovery"]
    kill_t = (args.kill_tick - 1) * args.tick_s
    detect = rec["first_dead"]["tick"] - args.kill_tick \
        if rec["first_dead"] else None
    resumed = (rec["first_resumed_token"]["t"] - kill_t
               if rec["first_resumed_token"] else None)
    tok_s = rep["tokens"] / counted["wall_s"]
    log(f"    {rep['responses']}/{rep['submitted']} answered in "
        f"{rep['ticks']} ticks ({rep['virtual_s']:.2f} virtual s), "
        f"outcomes {rep['outcomes']}, {rep['migrations']} migrations, "
        f"{counted['prefills']} prefills, {counted['steps']} decode steps; "
        f"health {rep['health_log']}; fault log {rep['fault_log']}")
    log(f"    recovery {rec}: dead {detect} ticks after the crash, first "
        f"resumed token {resumed} virtual s after it; fleet wall "
        f"{counted['wall_s']:.3f} s, {rep['tokens']} tokens, {tok_s:.1f} "
        f"tokens/s ({smi})")
    if rep["migrations"] < 1:
        raise AssertionError("[13a] the crash migrated nothing")
    if trans[args.kill_replica] != [("healthy", "suspect"),
                                    ("suspect", "dead")] or any(
            trans[i] for i in trans if i != args.kill_replica):
        raise AssertionError(f"[13a] unplanned health changes: {trans}")
    diff = sorted(i for i in want if got.get(i) != want[i])
    log(f"    tokens {'equal to' if not diff else 'DIFFER from'} one "
        f"uninterrupted paged engine's" + (f" for {diff}" if diff else ""))
    if diff:
        raise AssertionError(f"[13a] requests {diff} resumed with other "
                             "tokens")
    # 13f: the merged trace and the registry
    fc = lg.fleet_collector(fleet, replicas)
    flows = check_flows(fc.events())
    migrated = sorted(t for t, c in flows["chains"].items()
                      if c["migrated"])
    log(f"[13f] check_flows over the merged timeline: "
        f"{len(flows['complete'])}/{len(flows['chains'])} chains complete, "
        f"{len(flows['broken'])} broken, {len(flows['orphans'])} orphans, "
        f"{len(migrated)} migrated ({migrated})")
    if (len(flows["chains"]) != len(work) or len(flows["complete"])
            != len(work) or flows["broken"] or flows["orphans"]
            or not migrated):
        raise AssertionError("[13f] the request flows are not one "
                             "connected chain each")
    ledger = _registry_ledger("[13f]", replicas, responses)
    untraced = {}

    def run_untraced():
        r = lg.run_scenario(fleet_args("replica_kill", trace=False),
                            model=model, stack=untraced)
        return r, untraced["replicas"]
    rep_off, counted_off = fleet_counted("[13f]", run_untraced)
    check_launches("[13f] untraced", counted_off, model.cfg.num_layers,
                   paged=True)
    same = ({r.request_id: r.tokens for r in untraced["fleet"].completed}
            == got and rep_off["ticks"] == rep["ticks"])
    on = counted["wall_s"] / rep["ticks"]
    off = counted_off["wall_s"] / rep_off["ticks"]
    log(f"    host time per fleet tick: {on * 1e3:.3f} ms traced, "
        f"{off * 1e3:.3f} ms untraced ({(on - off) * 1e3:+.3f} ms, "
        f"{on / off - 1:+.2%}; {smi}); the untraced run "
        f"{'answers the same' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("[13f] the untraced fleet served other tokens")
    return dict(report=rep, launches=counted["launches"],
                counts={k: counted[k] for k in ("prefills", "steps")},
                wall_s=counted["wall_s"], tokens_per_s=tok_s,
                detect_ticks=detect, resumed_virtual_s=resumed,
                flows=dict(chains=len(flows["chains"]),
                           complete=len(flows["complete"]),
                           migrated=migrated),
                registry=ledger, tick_ms_traced=on * 1e3,
                tick_ms_untraced=off * 1e3,
                untraced_launches=counted_off["launches"])


def phase_fleet_bursty(model, smi):
    """13b: ``bursty`` on the same fleet and model: bursts of 8 at once
    against a router bound of 2 queued per replica and no fleet retry
    budget, so the overflow is shed with a reason and the client backs off
    and resubmits; the degradation ladder follows the burn."""
    lg = _loadgen()
    args = fleet_args("bursty", max_queue_depth=2, burst_n=8,
                      burst_gap_s=0.1, retry_budget=0, client_retries=8)
    stack = {}

    def run():
        rep = lg.run_scenario(args, model=model, stack=stack)
        return rep, stack["replicas"]
    rep, counted = fleet_counted("[13b]", run)
    check_launches("[13b]", counted, model.cfg.num_layers, paged=True)
    _exactly_once("[13b]", rep)
    log(f"[13b] bursty: {rep['responses']}/{rep['submitted']} answered in "
        f"{rep['ticks']} ticks, outcomes {rep['outcomes']}, sheds by "
        f"reason {rep['shed_reasons']}, SLO attainment "
        f"{rep['slo_attainment']:.4f} (e2e p50 {rep['e2e_p50_s']:.3f} / "
        f"p99 {rep['e2e_p99_s']:.3f} virtual s), highest degradation level "
        f"{rep['degraded_max_level']}, {rep['retries']} retries; wall "
        f"{counted['wall_s']:.3f} s ({smi})")
    if None in rep["shed_reasons"]:
        raise AssertionError("[13b] a shed carried no ShedReason")
    return dict(report=rep, launches=counted["launches"],
                wall_s=counted["wall_s"])


def resumed_divergence(model, prompts, got, want):
    """Where each resumed stream first leaves the uninterrupted one:
    ``{request: (index, margin)}``, the margin being the uninterrupted
    run's top-2 logit gap at that index (one prefill of the prompt and the
    tokens before it).  A resumed request re-prefills its context, so its
    K / V and its next logits come from the prefill's GEMM shapes and the
    flash forward, where the uninterrupted run had decode steps: in bf16
    the two orders of rounding differ by up to LOGITS_ATOL (phase 4's
    bound for two such orders), and a greedy pick whose top-2 gap is below
    that may flip."""
    out = {}
    for i in want:
        g, w = got[i], want[i]
        if g == w:
            continue
        k = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        ctx = torch.tensor([list(prompts[i]) + w[:k]],
                           device=model.device)
        logits, _ = model.prefill(ctx)
        top2 = logits[0, -1].float().topk(2).values
        out[i] = (k, round(float(top2[0] - top2[1]), 5))
    return out


def phase_fleet_contiguous(model):
    """13c: two ``InferenceEngine(max_slots=8)`` (#6) on phase 3's prompts:
    ``export_inflight`` at decode step 8 and ``adopt`` on the second engine
    give the uninterrupted run's tokens up to, at most, one near-tie
    (``resumed_divergence``) a request; a request past its ``deadline``
    and one past its ``timeout`` end ``"evicted"`` / ``"timeout"`` with
    their partial tokens (a prefix of the uninterrupted ones)."""
    from apex_tpu_torch.inference import InferenceEngine, Request
    from apex_tpu_torch.serving import VirtualClock
    prompts = serving_prompts(np.random.RandomState(0),
                              model.cfg.vocab_size)
    new = SEQ_NEW_TOKENS

    def reqs(**kw):
        return [Request(i, p, max_new_tokens=new, **kw)
                for i, p in enumerate(prompts)]

    def run():
        ref = InferenceEngine(model, max_slots=SLOTS)
        for r in reqs():
            ref.submit(r)
        want = {r.request_id: r.tokens for r in ref.run()}
        src = InferenceEngine(model, max_slots=SLOTS)
        dst = InferenceEngine(model, max_slots=SLOTS)
        for r in reqs():
            src.submit(r)
        while len(src.metrics.occupancy) < 8:
            src.step()
        moved = src.export_inflight()
        for req, progress in moved:
            dst.adopt(req, progress)
        got = {r.request_id: r.tokens for r in src.completed + dst.run()}
        clock = VirtualClock()
        timed = InferenceEngine(model, max_slots=SLOTS, clock=clock)
        timed.submit(Request(0, prompts[0], max_new_tokens=new,
                             deadline=0.45))
        timed.submit(Request(1, prompts[1], max_new_tokens=new,
                             timeout=0.65))
        timed.submit(Request(2, prompts[2], max_new_tokens=new))
        while timed.queue_depth or timed.active_requests:
            timed.step()
            clock.advance(0.1)
        out = {r.request_id: r for r in timed.completed}
        return (want, got, moved, out), (ref, src, dst, timed)
    (want, got, moved, out), counted = fleet_counted("[13c]", run)
    check_launches("[13c]", counted, model.cfg.num_layers, paged=False)
    streamed = {r.request_id: len(p) for r, p in moved}
    splits = resumed_divergence(model, prompts, got, want)
    log(f"[13c] export_inflight at decode step 8 moved "
        f"{sorted(streamed.items())} (request, tokens streamed); adopted "
        f"tokens {'equal' if got == want else 'DIFFER from'} the "
        f"uninterrupted run's: {sum(got[i] == want[i] for i in want)} of "
        f"{len(want)} requests equal; first difference (request: index, "
        f"top-2 margin there) {splits}")
    bad = {i: d for i, d in splits.items()
           if d[0] < streamed.get(i, 0) or d[1] >= LOGITS_ATOL}
    if bad:
        raise AssertionError(f"[13c] adopted requests {sorted(bad)} resumed "
                             "with other tokens away from a near-tie")
    ends = {i: (r.finish_reason, len(r.tokens)) for i, r in out.items()}
    log(f"    deadline 0.45 / timeout 0.65 virtual s (0.1 a step): "
        f"{ends}")
    ok = (out[0].finish_reason == "evicted"
          and out[1].finish_reason == "timeout"
          and out[2].finish_reason == "length"
          and all(0 < len(out[i].tokens) < new for i in (0, 1))
          and all(out[i].tokens == want[i][:len(out[i].tokens)]
                  for i in (0, 1, 2)))
    if not ok:
        raise AssertionError("[13c] deadline / timeout outcomes wrong")
    return dict(moved=len(moved), ends=ends, launches=counted["launches"])


def _watch_handoffs(fleet):
    """Wrap the decode engines' ``adopt_kv`` to hold every install against
    its payload (``torch.equal`` on the pool rows the handoff filled, data
    and scales) and the channel's ``send`` to time each device -> host ->
    device copy.  Returns the log they fill."""
    seen = dict(blocks=0, installs=0, mismatched=0, sends=[])
    for _, eng in fleet.decode._live():
        inner = eng.adopt_kv

        def adopt(h, _eng=eng, _inner=inner):
            slot = _inner(h)
            seq = _eng._seqs[slot]
            start = seq.shared_tokens // _eng.pool.block_size
            ids = torch.tensor(seq.block_ids[start:],
                               device=_eng.pool.data.device)
            same = torch.equal(_eng.pool.data[ids], h.payload["data"][start:])
            if "scales" in h.payload:
                same = same and torch.equal(_eng.pool.scales[ids],
                                            h.payload["scales"][start:])
            seen["installs"] += 1
            seen["blocks"] += len(h.payload["data"])
            seen["mismatched"] += not same
            return slot
        eng.adopt_kv = adopt
    ch = fleet.channel
    send = ch.send

    def timed_send(value, *args, _send=send, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _send(value, *args, **kw)
        torch.cuda.synchronize()
        seen["sends"].append((ch._nbytes(value), time.perf_counter() - t0))
        return out
    ch.send = timed_send
    return seen


def _disagg_fleet(model, n_prefill=1, n_decode=1, slots=SLOTS, **kw):
    from apex_tpu_torch.serving import (DisaggregatedFleet, KvChannel,
                                        PagedInferenceEngine, VirtualClock)
    clock = VirtualClock()

    def engine(prefill_only):
        return PagedInferenceEngine(model, max_slots=slots,
                                    block_size=PAGED_BS, chunked_prefill=True,
                                    prefill_only=prefill_only, clock=clock,
                                    **kw)
    fleet = DisaggregatedFleet(
        [engine(True) for _ in range(n_prefill)],
        [engine(False) for _ in range(n_decode)], clock=clock,
        channel=KvChannel(), handoff_retry_ticks=64)
    return fleet, clock, engine


def _drive(fleet, clock, requests, one_at_a_time=False):
    batches = [[r] for r in requests] if one_at_a_time else [requests]
    for batch in batches:
        for r in batch:
            fleet.submit(r)
        for _ in range(20000):
            busy = fleet.step()
            clock.advance(0.01)
            if not busy and fleet.pending == 0:
                break
    return {r.request_id: r.tokens for r in fleet.completed}


def _disagg_run(tag, model, prompts, new, kv_quant, int8_weights,
                one_at_a_time):
    """One disaggregated run (1 prefill + 1 decode replica), counted and
    gated: every request shipped (handoffs = requests, nothing lost, no
    fallback), each install bitwise its payload, the channel's bytes the
    blocks shipped times ``block_bytes``, no #7 on the prefill replica."""
    from apex_tpu_torch.inference import Request
    fleet, clock, _ = _disagg_fleet(model, kv_quant=kv_quant)
    seen = _watch_handoffs(fleet)
    requests = [Request(i, p, max_new_tokens=new)
                for i, p in enumerate(prompts)]

    def run():
        toks = _drive(fleet, clock, requests, one_at_a_time)
        return toks, [e for r in (fleet.prefill, fleet.decode)
                      for _, e in r._live()]
    tokens, counted = fleet_counted(tag, run)
    check_launches(tag, counted, model.cfg.num_layers, paged=True,
                   int8_weights=int8_weights, int8_kv=kv_quant == "int8")
    ch = fleet.channel
    pool = fleet.decode.replicas[0].pool
    prefill_steps = sum(len(e.metrics.occupancy)
                        for _, e in fleet.prefill._live())
    big = max(seen["sends"])
    log(f"    {len(tokens)} answered; {fleet.handoffs} handoffs, "
        f"{ch.lost_handoffs} lost, {fleet.fallbacks} fallbacks, "
        f"{seen['installs']} installs ({seen['mismatched']} not bitwise), "
        f"{seen['blocks']} blocks x {pool.block_bytes} B = "
        f"{seen['blocks'] * pool.block_bytes} B against the channel's "
        f"{ch.handoff_bytes} B; prefill replica decode steps "
        f"{prefill_steps}; largest handoff {big[0]} B device -> host -> "
        f"device in {big[1] * 1e3:.3f} ms ({big[0] / big[1] / 1e9:.2f} "
        f"GB/s); wall {counted['wall_s']:.3f} s")
    if (len(tokens) != len(prompts) or fleet.handoffs != len(prompts)
            or ch.lost_handoffs or fleet.fallbacks or fleet.pending
            or fleet.duplicate_responses):
        raise AssertionError(f"{tag} not every request shipped once")
    if seen["installs"] != len(prompts) or seen["mismatched"]:
        raise AssertionError(f"{tag} an install is not its payload")
    if ch.handoff_bytes != seen["blocks"] * pool.block_bytes:
        raise AssertionError(f"{tag} handoff bytes do not match the blocks")
    if prefill_steps:
        raise AssertionError(f"{tag} the prefill replica decoded")
    return dict(tokens=tokens, launches=counted["launches"],
                handoffs=fleet.handoffs, handoff_bytes=ch.handoff_bytes,
                blocks=seen["blocks"], largest_handoff_bytes=big[0],
                largest_handoff_ms=big[1] * 1e3,
                largest_handoff_gb_s=big[0] / big[1] / 1e9,
                wall_s=counted["wall_s"])


def _paged_one_at_a_time(model, prompts, new, kv_quant):
    """The chunked paged engine's tokens with the requests admitted one at
    a time (the disaggregated fleet's chunk schedule)."""
    from apex_tpu_torch.inference import Request
    from apex_tpu_torch.serving import PagedInferenceEngine
    eng = PagedInferenceEngine(model, max_slots=SLOTS, block_size=PAGED_BS,
                               chunked_prefill=True, kv_quant=kv_quant)
    out = {}
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, max_new_tokens=new))
        out.update({r.request_id: r.tokens for r in eng.run()})
    return out


def phase_disagg(model, qmodel, paged, smi):
    """13d: ``DisaggregatedFleet`` (1 prefill-only + 1 decode replica, 8
    slots each, chunked prefill) over ``KvChannel``: a bf16 pool, the int8
    KV pool, and int8 KV with int8 weights (#14).  Full concurrency
    (agreement with phase 11's chunked runs measured) and one request at a
    time (tokens equal to the chunked paged engine's in the same order)."""
    prompts = paged_prompts(model.cfg.vocab_size)
    short = [p[:128] for p in prompts[:4]]          # 11k's prompts
    seq = [prompts[0][:96], prompts[2][:96]]        # both behind the prefix
    configs = (("bf16", model, None, prompts, PAGED_NEW_TOKENS,
                paged["chunked"]["tokens"]),
               ("int8 KV", model, "int8", short, 32,
                paged["int8_kv"]["tokens"]),
               ("int8 KV + int8 weights", qmodel, "int8", short, 32,
                paged["int8_kv"]["tokens"]))
    out = {}
    for name, m, kvq, full_prompts, new, ref in configs:
        int8_w = m.cfg.weight_quant == "int8"
        log(f"[13d] {name}: {len(full_prompts)} prompts of "
            f"{[len(p) for p in full_prompts]} tokens, {new} new tokens, "
            "all at once")
        full = _disagg_run(f"[13d] {name}", m, full_prompts, new, kvq,
                           int8_w, one_at_a_time=False)
        agree = sum(full["tokens"][i] == ref[i] for i in ref) / len(ref)
        log(f"    requests whose tokens equal phase 11's chunked paged "
            f"engine at full concurrency: {agree:.4f} (measured: the "
            "chunk schedules differ)")
        log(f"[13d] {name}: {len(seq)} prompts of {[len(p) for p in seq]} "
            f"tokens, {SEQ_NEW_TOKENS} new tokens, one at a time")
        one = _disagg_run(f"[13d] {name}, one at a time", m, seq,
                          SEQ_NEW_TOKENS, kvq, int8_w, one_at_a_time=True)
        want = _paged_one_at_a_time(m, seq, SEQ_NEW_TOKENS, kvq)
        same = one["tokens"] == want
        log(f"    tokens {'equal to' if same else 'DIFFER from'} the "
            "chunked paged engine's, one request at a time")
        if not same:
            raise AssertionError(f"[13d] {name}: tokens differ from the "
                                 "paged engine's")
        out[name] = dict(full=dict(full, agreement=agree), one=one)
    ratio = (out["int8 KV"]["one"]["handoff_bytes"]
             / out["bf16"]["one"]["handoff_bytes"])
    log(f"    int8 / bf16 handoff bytes on the same requests: {ratio:.4f} "
        f"({out['int8 KV']['one']['handoff_bytes']} / "
        f"{out['bf16']['one']['handoff_bytes']} B; {smi})")
    out["int8_over_bf16_bytes"] = ratio
    return out


def phase_pool_capacity(model):
    """13e: ``PoolCapacityController`` over a bf16 disaggregated fleet of 2
    prefill + 1 decode replicas with one forced ``request_shift``: it
    commits, the pools become 1 + 2, every request answered once, and
    ``audit()`` is clean."""
    from apex_tpu_torch.inference import Request
    from apex_tpu_torch.resilience import PoolCapacityController
    fleet, clock, engine = _disagg_fleet(model, n_prefill=2, n_decode=1)
    ctl = PoolCapacityController(
        {"prefill": fleet.prefill, "decode": fleet.decode},
        lambda pool: engine(pool == "prefill"), clock=clock,
        cooldown_s=1.0)
    prompts = [p[:128] for p in paged_prompts(model.cfg.vocab_size)[:4]]
    before = ctl.split

    def run():
        for i, p in enumerate(prompts):
            fleet.submit(Request(i, p, max_new_tokens=SEQ_NEW_TOKENS))
        ctl.request_shift("to_decode")
        for _ in range(5000):
            busy = fleet.step()
            ctl.tick()
            clock.advance(0.01)
            if not busy and fleet.pending == 0 and not ctl.shifting:
                break
        return fleet.completed, [e for r in (fleet.prefill, fleet.decode)
                                 for _, e in r._live()]
    responses, counted = fleet_counted("[13e]", run)
    check_launches("[13e]", counted, model.cfg.num_layers, paged=True)
    audit = ctl.audit()
    log(f"[13e] pools {before} -> {ctl.split}, stats "
        f"{ {k: v for k, v in ctl.stats.items() if k != 'last_shift'} }, "
        f"audit {audit}; {len(responses)}/{len(prompts)} answered "
        f"({collections.Counter(r.finish_reason for r in responses)}), "
        f"{fleet.handoffs} handoffs, {fleet.fallbacks} fallbacks")
    if (ctl.stats["shifts"] != 1 or ctl.stats["rollbacks"]
            or ctl.split != {"prefill": before["prefill"] - 1,
                             "decode": before["decode"] + 1}):
        raise AssertionError("[13e] the shift did not commit")
    if (len(responses) != len(prompts) or fleet.pending
            or fleet.duplicate_responses
            or any(r.finish_reason != "length" for r in responses)):
        raise AssertionError("[13e] exactly-once broken across the shift")
    if audit:
        raise AssertionError(f"[13e] audit found {audit}")
    return dict(split=ctl.split, stats={k: v for k, v in ctl.stats.items()
                                        if k != "last_shift"},
                launches=counted["launches"])


def phase_fleet(model, qmodel, paged, smi):
    """Phase 13 on GPT-350M (phase 3's weights, bf16): 13a + 13f, 13b,
    13c, 13d, 13e.  Returns the results and the runs whose launches the
    kernel line counts."""
    t0 = time.perf_counter()
    out = dict(kill=phase_fleet_kill(model, smi))
    torch.cuda.empty_cache()
    out["bursty"] = phase_fleet_bursty(model, smi)
    torch.cuda.empty_cache()
    out["contiguous"] = phase_fleet_contiguous(model)
    torch.cuda.empty_cache()
    out["disagg"] = phase_disagg(model, qmodel, paged, smi)
    torch.cuda.empty_cache()
    out["capacity"] = phase_pool_capacity(model)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    log(f"[13] phase 13 took {out['wall_s']:.1f} s")
    d = out["disagg"]
    runs = [out["kill"]["launches"], out["kill"]["untraced_launches"],
            out["bursty"]["launches"], out["contiguous"]["launches"],
            out["capacity"]["launches"]] + [
        d[k][w]["launches"] for k in d if isinstance(d[k], dict)
        for w in ("full", "one")]
    return out, runs


# -- the packed segment form of #17, #18, #20, #21 (phase 2, PR 20) ----------

def _segment_lists(specs, block_rows):
    """A one-rank shard of the packed bucket of each dtype in ``specs``
    ((shape, dtype) pairs): its meta and segments."""
    from apex_tpu_torch.multi_tensor_apply import bucketing as B
    out = []
    for dtype, idx in B.group_by_dtype(
            [torch.empty(0, dtype=dt) for _, dt in specs]).items():
        meta = B.bucket_meta([specs[i][0] for i in idx], dtype, block_rows)
        out.append((meta, B.shard_segments(meta, 0, meta.nrows)))
    return out


def _rows(meta, gen_cuda, std, dtype=torch.float32, positive=False):
    t = torch.randn((meta.nrows, 128), generator=gen_cuda,
                    device="cuda") * std
    return (t.abs() if positive else t).to(dtype)


def kernel_packed_segments(gen_cuda):
    """#18 on GPT-350M's f32 bucket and #17, #20, #21 on BERT-large's O2
    buckets (bf16 gradients with f32 masters, the f32 LayerNorms), each at
    one rank's shard of the packed layout (world 1: the whole bucket), as
    the ZeRO optimizers run them: the segments (each tensor's rows, one
    view each) against the plain versions on the same views, and the time
    beside the per-parameter list's."""
    from apex_tpu_torch.multi_tensor_apply import bucketing as B
    from apex_tpu_torch.ops import multi_tensor as K
    out = {}
    (meta, segs), = _segment_lists(
        [(tuple(s), torch.float32) for s in gpt350m_shapes()],
        B.DEFAULT_BLOCK_ROWS)
    numels = [(s.stop - s.start) * 128 for s in segs]
    bufs = [_rows(meta, gen_cuda, 1e-3), _rows(meta, gen_cuda, 0.02),
            _rows(meta, gen_cuda, 1e-4),
            _rows(meta, gen_cuda, 1e-6, positive=True)]
    scal = torch.tensor([LR, 0.9, 0.999, 1e-8, 0.01, 1 - 0.9 ** 3,
                         1 - 0.999 ** 3, 1.0], dtype=torch.float32,
                        device="cuda")
    views = [B.segment_views(b, segs) for b in bufs]
    ref = [[v.clone() for v in vs] for vs in views[1:]]
    before = K.multi_tensor_adam.launches
    K.multi_tensor_adam(views[0], *[[v.clone() for v in vs]
                                    for vs in views[1:]], scal)
    n_launch = K.multi_tensor_adam.launches - before
    got = [[v.clone() for v in vs] for vs in views[1:]]
    K.multi_tensor_adam(views[0], *got, scal)
    K.multi_tensor_adam_reference(views[0], *ref, scal)
    torch.cuda.synchronize()
    if n_launch != table_launches(numels):
        raise AssertionError("packed #18 launch count")
    err = max(_check_lists(f"multi_tensor_adam packed GPT-350M shard {k}",
                           a, b, 1e-6, 1e-9)
              for k, a, b in zip("pmv", got, ref))
    shapes = gpt350m_shapes()
    leaf = [[torch.randn(s, generator=gen_cuda, device="cuda") * std
             for s in shapes] for std in (1e-3, 0.02, 1e-4)]
    leaf.append([torch.randn(s, generator=gen_cuda, device="cuda").abs()
                 * 1e-6 for s in shapes])
    n_el = sum(numels)
    out["adam"] = dict(
        max_abs_err=err, segments=len(segs), elements=n_el,
        launches_per_call=n_launch,
        ms=time_ms([lambda: K.multi_tensor_adam(*views, scal)] * 5),
        per_leaf_ms=time_ms([lambda: K.multi_tensor_adam(*leaf, scal)] * 5),
        plain_ms=time_ms([lambda: K.multi_tensor_adam_reference(
            *views, scal)] * 2, rounds=3),
        bound_ms=bound_ms(7 * 4 * n_el, 15 * n_el, PEAK_F32_FLOPS)[0])
    log(f"  multi_tensor_adam packed (GPT-350M f32 bucket, {len(segs)} "
        f"segments, {n_el} elements, {n_launch} launches): "
        f"{out['adam']['ms']:.4f} ms, per-parameter list "
        f"{out['adam']['per_leaf_ms']:.4f} ms, plain "
        f"{out['adam']['plain_ms']:.4f} ms")
    del bufs, views, ref, got, leaf
    torch.cuda.empty_cache()

    specs = bert_param_specs()
    stage1 = stage2 = sumsq = 0.0
    times = collections.Counter()
    scal1 = lamb_stage1_scal()
    lr = torch.full((), BERT_LR, device="cuda")
    launches = collections.Counter()
    for meta, segs in _segment_lists(specs, B.DEFAULT_BLOCK_ROWS):
        numels = [(s.stop - s.start) * 128 for s in segs]
        g = _rows(meta, gen_cuda, 1e-3, meta.dtype)
        p = _rows(meta, gen_cuda, 0.02, meta.dtype).float()
        bufs = [g, p, _rows(meta, gen_cuda, 1e-4),
                _rows(meta, gen_cuda, 1e-6, positive=True),
                torch.empty((meta.nrows, 128), device="cuda")]
        views = [B.segment_views(b, segs) for b in bufs]
        total, _, _ = K.multi_tensor_sumsq(views[0])
        rtotal, _, _ = K.multi_tensor_sumsq_reference(views[0])
        sumsq = max(sumsq, check_close(
            f"multi_tensor_sumsq packed {meta.dtype} shard", total, rtotal,
            0, 1e-5))
        kin = [[v.clone() for v in vs] for vs in views[1:]]
        rin = [[v.clone() for v in vs] for vs in views[1:]]
        before = K.multi_tensor_lamb_stage1.launches
        ku, kp = K.multi_tensor_lamb_stage1(views[0], *kin, scal1)
        launches["multi_tensor_lamb_stage1"] += (
            K.multi_tensor_lamb_stage1.launches - before)
        ru, rp = K.multi_tensor_lamb_stage1_reference(views[0], *rin, scal1)
        torch.cuda.synchronize()
        stage1 = max(stage1, _check_lists(
            f"multi_tensor_lamb_stage1 packed {meta.dtype} shard (m, v, u)",
            kin[1] + kin[2] + kin[3], rin[1] + rin[2] + rin[3], 1e-6, 0.0,
            scale_rtol=1e-6))
        check_close(f"lamb stage 1 packed {meta.dtype} u^2 partials", ku, ru,
                    0, 1e-5)
        check_close(f"lamb stage 1 packed {meta.dtype} p^2 partials", kp, rp,
                    0, 1e-5)
        kpp, rpp = ([v.clone() for v in kin[0]] for _ in range(2))
        before = K.multi_tensor_lamb_stage2.launches
        K.multi_tensor_lamb_stage2(kin[3], kpp, [None] * len(segs), ku, kp,
                                   lr)
        launches["multi_tensor_lamb_stage2"] += (
            K.multi_tensor_lamb_stage2.launches - before)
        K.multi_tensor_lamb_stage2_reference(kin[3], rpp, [None] * len(segs),
                                             ku, kp, lr)
        torch.cuda.synchronize()
        stage2 = max(stage2, _check_lists(
            f"multi_tensor_lamb_stage2 packed {meta.dtype} shard", kpp, rpp,
            1e-6, 1e-9))
        if launches["multi_tensor_lamb_stage2"] and table_launches(
                numels) != K.multi_tensor_lamb_stage2.launches - before:
            raise AssertionError("packed #21 launch count")
        times["sumsq"] += time_ms([lambda: K.multi_tensor_sumsq(
            views[0])] * 5)
        times["stage1"] += time_ms([lambda: K.multi_tensor_lamb_stage1(
            *views, scal1)] * 5)
        u_sq, p_sq = K.multi_tensor_lamb_stage1(*views, scal1)
        times["stage2"] += time_ms([lambda: K.multi_tensor_lamb_stage2(
            views[4], views[1], [None] * len(segs), u_sq, p_sq, lr)] * 5)
        del bufs, views, kin, rin, kpp, rpp
        torch.cuda.empty_cache()
    grads = [torch.randn(s, generator=gen_cuda, device="cuda").to(dt)
             for s, dt in specs]
    masters = [torch.randn(s, generator=gen_cuda, device="cuda")
               for s, _ in specs]
    mv = [[torch.zeros(s, device="cuda") for s, _ in specs]
          for _ in range(3)]
    leaf_s1 = time_ms([lambda: K.multi_tensor_lamb_stage1(
        grads, masters, *mv, scal1)] * 5)
    u_sq, p_sq = K.multi_tensor_lamb_stage1(grads, masters, *mv, scal1)
    copies = [None] * len(specs)
    leaf_s2 = time_ms([lambda: K.multi_tensor_lamb_stage2(
        mv[2], masters, copies, u_sq, p_sq, lr)] * 5)
    leaf_sq = time_ms([lambda: K.multi_tensor_sumsq(grads)] * 5)
    out["lamb"] = dict(max_abs_err_stage1=stage1, max_abs_err_stage2=stage2,
                       max_abs_err_sumsq=sumsq, ms=dict(times),
                       per_leaf_ms=dict(sumsq=leaf_sq, stage1=leaf_s1,
                                        stage2=leaf_s2),
                       launches=dict(launches))
    log(f"  BERT-large O2 packed shard: #17 {times['sumsq']:.4f} ms "
        f"(per-parameter list {leaf_sq:.4f}), #20 {times['stage1']:.4f} ms "
        f"({leaf_s1:.4f}), #21 {times['stage2']:.4f} ms ({leaf_s2:.4f}); "
        f"launches {dict(launches)}")
    return out


# -- phase 14: data parallelism over NCCL (PR 20) -----------------------------

# Losses of the data-parallel runs against their single-process
# references, largest relative gap over the steps; each limit sits between
# the gap of the correct run and the gap a planted fault opens, both read
# by tools/dp_loss_gates.py at one rank (PERF.md, PR 20 finding):
# * 14b: DistributedFusedAdam's packed step is FusedAdam's per-parameter
#   step bit for bit at one rank (#18 is elementwise): exactly equal;
# * 14a: DistributedFusedLAMB sums its norms by shard segment, FusedLAMB
#   by tensor, so bf16 parameters may round the other way here and there;
# * 14c: against the example in one process with its batch norms on the
#   same group path (E[x^2] - mean^2 in f32) and no DDP.  Phase 9's cuDNN
#   batch norm is another formula, whose f32 differences flip bf16
#   roundings under O1 (a gap larger than a dropped bucket's): logged only.
DP_GPT_RTOL = 0.0
DP_BERT_RTOL = 1e-4
DP_RESNET_RTOL = 1e-4
DP_INT8_STEPS = 2


def _shard(t, rank, world, axis=1):
    k = t.shape[axis] // world
    return t.narrow(axis, rank * k, k).contiguous()


def zero_launches(opt, kernel_names):
    """Per step, the launches of a ZeRO optimizer's kernels from its
    layout: each bucket's segments in this rank's shard."""
    from apex_tpu_torch.ops import multi_tensor as K
    per = collections.Counter()
    all_segments = []
    for info in opt._layout().buckets:
        numels = [(s.stop - s.start) * 128 for s in opt._bucket(info)[1]]
        all_segments += numels
        if not numels:
            continue
        if "multi_tensor_adam" in kernel_names:
            per["multi_tensor_adam"] += table_launches(numels)
        if "multi_tensor_lamb_stage1" in kernel_names:
            per["multi_tensor_lamb_stage1"] += K.lamb_stage1_launches(numels)
            per["multi_tensor_lamb_stage2"] += table_launches(numels)
    if "multi_tensor_sumsq" in kernel_names and all_segments:
        per["multi_tensor_sumsq"] += sumsq_launches(all_segments)
    return per


def _dp_bert(rank, world):
    """14a: BERT-large O2, phase 7's recipe and batch (this rank's rows of
    each micro-batch), DistributedFusedLAMB; then int8 transport."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.bert import BertConfig, BertModel
    from apex_tpu_torch.parallel import DistributedFusedLAMB
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = BertModel(BertConfig(**BERT_LARGE, dtype=torch.bfloat16),
                      device="cuda").init_params(
        torch.Generator().manual_seed(0))
    opt = DistributedFusedLAMB(model.parameters(), lr=BERT_LR,
                               betas=LAMB_BETAS, weight_decay=LAMB_WD)
    amp.initialize(model, opt, opt_level="O2")
    tokens, labels = (_shard(t, rank, world).to("cuda") for t in mlm_batch(
        BERT_LARGE["vocab_size"], (BERT_ACCUM, BERT_MICRO, BERT_SEQ), 0))
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    losses, times = [], []
    with counting_plain_versions() as plain:
        for i in range(BERT_STEPS + DP_INT8_STEPS):
            if i == BERT_STEPS:
                opt.allreduce_dtype = "int8"
            t0 = time.perf_counter()
            losses.append(float(bert_step(model, opt, tokens, labels)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    n, layers = BERT_STEPS + DP_INT8_STEPS, BERT_LARGE["num_layers"]
    rows = tokens.shape[1] * BERT_SEQ
    per_mb = 2 * layers + 2
    expected = {"layer_norm_fwd": n * BERT_ACCUM * per_mb,
                "layer_norm_bwd": n * BERT_ACCUM * per_mb,
                "flash_fwd": n * BERT_ACCUM * layers,
                "flash_attention_dq": n * BERT_ACCUM * layers,
                "flash_attention_dkv": n * BERT_ACCUM * layers,
                "lm_head_fwd": n * BERT_ACCUM * 2,
                **lm_head_bwd_launches(n * BERT_ACCUM, rows,
                                       BERT_LARGE["vocab_size"])}
    per_step = zero_launches(opt, ("multi_tensor_sumsq",
                                   "multi_tensor_lamb_stage1"))
    for k, v in per_step.items():
        expected[k] = n * v
    return dict(losses=losses, step_times_s=times,
                launches=_launches_of(counters), expected=expected,
                launches_per_step_optimizer=dict(per_step),
                plain_calls=dict(plain),
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                buckets=len(opt._layout().buckets),
                state_shard_bytes=sum(t.numel() * t.element_size()
                                      for st in opt._shards.values()
                                      for t in st.values()))


def _dp_gpt(rank, world):
    """14b: GPT-350M, phase 5's recipe and batch (this rank's rows),
    stepped by DistributedFusedAdam over 10 MB buckets (its
    reduce-scatter is the gradient reduction: no DDP)."""
    from apex_tpu_torch.parallel import DistributedFusedAdam
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = build_model("cuda").init_params(torch.Generator().manual_seed(0))
    opt = DistributedFusedAdam(model.parameters(), lr=LR,
                               message_size=10_000_000)
    rng = np.random.RandomState(0)
    shape = (ACCUM, MICRO, SEQ)
    tokens = _shard(torch.from_numpy(rng.randint(
        0, GPT350M["vocab_size"], shape)), rank, world).to("cuda")
    targets = _shard(torch.from_numpy(rng.randint(
        0, GPT350M["vocab_size"], shape)), rank, world).to("cuda")
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    losses, times = [], []
    with counting_plain_versions() as plain:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(float(train_step(model, opt, tokens, targets)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    n, layers = TRAIN_STEPS, GPT350M["num_layers"]
    per_mb = 2 * layers + 1
    expected = {"layer_norm_fwd": n * ACCUM * per_mb,
                "layer_norm_bwd": n * ACCUM * per_mb,
                "flash_fwd": n * ACCUM * layers,
                "flash_attention_dq": n * ACCUM * layers,
                "flash_attention_dkv": n * ACCUM * layers,
                "lm_head_fwd": n * ACCUM * 2,
                **lm_head_bwd_launches(n * ACCUM, tokens.shape[1] * SEQ,
                                       GPT350M["vocab_size"])}
    per_step = zero_launches(opt, ("multi_tensor_adam",))
    for k, v in per_step.items():
        expected[k] = n * v
    return dict(losses=losses, step_times_s=times,
                launches=_launches_of(counters), expected=expected,
                launches_per_step_optimizer=dict(per_step),
                plain_calls=dict(plain),
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                buckets=len(opt._layout().buckets))


def resnet_group_path_reference(argv, group):
    """The ImageNet example's recipe (``argv`` with ``--sync-bn``) in one
    process on the whole global batch, its batch norms on the group path
    of ``group`` (a group of this rank alone: the E[x^2] - mean^2
    statistics of 14c) and no DDP: the losses of the warm-up step and the
    ``--steps`` after it."""
    from apex_tpu_torch.examples.imagenet import main_amp
    from apex_tpu_torch.parallel import convert_syncbn_model
    from apex_tpu_torch.utils.device import resolve_device
    args = main_amp.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    trainer = main_amp.Trainer(args, device)
    convert_syncbn_model(trainer.model, process_group=group)
    make_batch, put = main_amp.make_data(args, device)
    losses = []
    for _ in range(1 + args.steps):
        x, y, ready = put(*make_batch())
        if ready is not None:
            torch.cuda.current_stream(device).wait_event(ready)
        losses.append(float(trainer.step(x, y)))
    return losses


def _dp_resnet(rank, world):
    """14c: ResNet-50 O1 through the example's distributed path
    (``--sync-bn``, DDP, FusedSGD) on this rank's rows of the global
    batch; first its one-process reference
    (:func:`resnet_group_path_reference`, over a group of this rank
    alone)."""
    import torch.distributed as dist
    from apex_tpu_torch.examples.imagenet import main_amp
    from apex_tpu_torch.ops.multi_tensor import sgd_launches
    argv = RESNET_ARGV + ["--opt-level", "O1", "--sync-bn"]
    alone = [dist.new_group([r]) for r in range(world)][rank]
    reference = resnet_group_path_reference(argv, alone)
    torch.cuda.empty_cache()
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    with counting_plain_versions() as plain:
        res = main_amp.main(argv)
    torch.cuda.synchronize()
    numels = [int(np.prod(s)) for s, _ in resnet50_specs("O1")]
    return dict(losses=[res["warmup_loss"]] + res["losses"],
                reference=reference,
                step_times_s=res["step_times_s"],
                images_per_s=res["images_per_s"],
                launches=_launches_of(counters),
                expected={"multi_tensor_sgd": RESNET_STEPS
                          * sgd_launches(numels)},
                plain_calls=dict(plain), devices=res["devices"],
                peak_memory_bytes=res["peak_memory_bytes"])


def _dp_rank(rank, world, out_dir):
    """One rank of phase 14 (a spawned process): NCCL through a
    ``file://`` store in ``out_dir`` and ``parallel_state``, then 14a-14c;
    its results pickled into ``out_dir``.  An exception ends the process
    non-zero."""
    import pickle
    import torch.distributed as dist
    from apex_tpu_torch.transformer import parallel_state as ps
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"file://{pathlib.Path(out_dir).resolve()}/store",
        rank=rank, world_size=world)
    ps.initialize_model_parallel()
    out = {}
    for key, fn in (("bert", _dp_bert), ("gpt", _dp_gpt),
                    ("resnet", _dp_resnet)):
        out[key] = fn(rank, world)
        torch.cuda.empty_cache()
    with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    ps.destroy_model_parallel()
    dist.destroy_process_group()


def _dp_gap(tag, got, want, rtol=None):
    """The largest relative gap of ``got`` to ``want``, logged; beyond
    ``rtol`` (when given) it fails the phase."""
    gap = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    log(f"    {tag}: losses {got} against {want}: largest relative gap "
        f"{gap!r} ({'logged only' if rtol is None else f'limit {rtol}'})")
    if rtol is not None and not gap <= rtol:
        raise AssertionError(f"{tag}: losses leave their reference's by "
                             f"{gap!r}")
    return gap


def dp_loss_limits(world):
    """The loss gates of 14a-14c at ``world`` ranks: the readings' limits
    at one rank; at more, where the reduction sums in other orders and no
    reading bounds the gap yet, the card-vs-CPU training tolerance (14a,
    14b) and 2e-2 (14c, whose bf16 roundings then flip)."""
    if world == 1:
        return dict(bert=DP_BERT_RTOL, gpt=DP_GPT_RTOL, resnet=DP_RESNET_RTOL)
    return dict(bert=TRAIN_LOSS_RTOL, gpt=TRAIN_LOSS_RTOL, resnet=2e-2)


def phase_data_parallel(train, bert, resnet):
    """Phase 14: ``torch.cuda.device_count()`` ranks over NCCL (spawned
    processes), 14a-14c: exact launches, no plain version, peak memory
    beside the single-process phase's (7, 5, 9), and the ranks' mean
    losses held against phases 7 and 5 and 14c's one-process reference
    (phase 9's logged beside it)."""
    import pickle
    import torch.multiprocessing as mp
    world = torch.cuda.device_count()
    out_dir = pathlib.Path("build") / "phase14"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    # a rank that raises makes start_processes raise here (not caught)
    mp.start_processes(_dp_rank, args=(world, str(out_dir)),
                       nprocs=world, start_method="spawn", join=True)
    ranks = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    log(f"[14] data parallelism over NCCL, {world} rank(s) "
        f"({time.perf_counter() - t0:.1f} s)")
    res = dict(world=world, ranks=ranks, gaps={})
    limits = dp_loss_limits(world)
    singles = {"bert": ("[14a] BERT-large O2 + DistributedFusedLAMB", bert),
               "gpt": ("[14b] GPT-350M + DistributedFusedAdam", train),
               "resnet": ("[14c] ResNet-50 O1 --sync-bn DDP + FusedSGD",
                          resnet)}
    for key, (tag, single) in singles.items():
        for r, rank in enumerate(ranks):
            run = rank[key]
            log(f"{tag} rank {r}: step times (s) "
                f"{[round(t, 4) for t in run['step_times_s']]}; peak memory "
                f"{run['peak_memory_bytes'] / 2 ** 30:.3f} GiB (single "
                f"process {single['peak_memory_bytes'] / 2 ** 30:.3f} GiB)")
            log(f"    launches {run['launches']} (expected "
                f"{run['expected']}); plain-version calls "
                f"{run['plain_calls']}")
            if run["launches"] != run["expected"]:
                raise AssertionError(f"{tag}: launch counts do not match "
                                     "the path")
            if run["plain_calls"]:
                raise AssertionError(f"{tag}: a plain version was called")
            if not np.all(np.isfinite(run["losses"])):
                raise AssertionError(f"{tag}: non-finite loss")
        # the ranks' mean loss is the global batch's
        mean = [float(x) for x in np.mean(
            [rank[key]["losses"] for rank in ranks], axis=0)]
        if key == "resnet":
            res["gaps"]["resnet_phase9"] = _dp_gap(
                f"{tag} against phase 9 (cuDNN batch norm)", mean,
                [single["warmup_loss"]] + single["losses"])
            want = ranks[0][key]["reference"]
            tag += " against one process on the group path"
        else:
            want = single["losses"]
        n = min(len(mean), len(want))
        res["gaps"][key] = _dp_gap(tag, mean[:n], want[:n], limits[key])
    return res


# -- phase 15 ----------------------------------------------------------------

# The three runs of phase 15 at tensor-parallel size = the ranks: (key,
# tag, model, config overrides, steps).  Each holds its recipe's losses
# against the same configuration in one process with axis_name=None
# (reference_overrides; both take the f32 vocab-parallel head: the fused
# LM head serves the serial vocab only); 15b's reference is 15a's.
TP_RUNS = (
    ("gpt", "[15a] GPT-350M TP + SP + fused FFN + FusedAdam", "gpt",
     dict(sequence_parallel=True), 4),
    ("gpt_overlap", "[15b] GPT-350M TP + SP + overlap_chunks=2", "gpt",
     dict(sequence_parallel=True, overlap_chunks=2), 2),
    ("bert", "[15c] BERT-large O2 TP + SP + overlap_chunks=2 + FusedLAMB",
     "bert", dict(sequence_parallel=True, overlap_chunks=2), 2),
)
# The loss gates, each between a correct and a planted-fault reading of
# tools/tensor_parallel_torch.py --gates on the card at full width (every
# correct run reads the same on a repeat; PERF.md):
# * one rank: 15a bit for bit (the same operations as one process; 0
#   with every fault, which touch only the rings); 15b correct 4.91e-6,
#   ring_row 5.58e-5; 15c correct 1.34e-5, ring_row 9.53e-5 (ring_dw reads
#   1.7e-6 / 6.2e-6: Adam's normalized step hides a gradient missing one
#   token in 1024);
# * 2 / 4 cards: 15a correct 6.48e-5 / 3.13e-5, bias_copy 7.88e-5 /
#   9.62e-5; 15b correct 5.82e-5 / 2.52e-5, bias_copy 7.92e-5 / 5.25e-5,
#   ring_row 1.18e-4 / 2.70e-4; 15c correct 2.49e-4 / 4.73e-4, bias_copy
#   3.58e-4 / 7.00e-4, ring_row 4.84e-4 / 8.25e-4.  Single readings, and at
#   2 cards bias_copy reads only 1.2x the correct run after 4 steps: the
#   gloo tests against JAX (tests/test_torch_tensor_parallel*.py) are the
#   check of the wrappers, these gates a coarse one on the card.
TP_LOSS_RTOL = {
    1: dict(gpt=0.0, gpt_overlap=2e-5, bert=4e-5),
    2: dict(gpt=7e-5, gpt_overlap=7e-5, bert=3e-4),
    4: dict(gpt=6e-5, gpt_overlap=4e-5, bert=6e-4)}


def _tp_plant(fault):
    """A context manager planting ``fault`` (for the gate readings), or
    none for None: ``ring_dw``: the overlap rings' weight gradient skips
    each shard's last token; ``ring_row``: each product of the rings
    loses its last row (an off-by-one in the chunk placement);
    ``bias_copy``: the row layers' bias loses its ``copy_to`` wrapper
    under sequence parallelism (its gradient stays a rank's partial; the
    identity at one rank)."""
    from unittest import mock
    from apex_tpu_torch.transformer.tensor_parallel import layers as L
    from apex_tpu_torch.transformer.tensor_parallel import mappings as M
    if fault is None:
        return contextlib.nullcontext()
    if fault == "ring_dw":
        full = M._dw_f32
        return mock.patch.object(M, "_dw_f32", lambda g, x: full(
            g[..., :-1, :], x[..., :-1, :]))
    if fault == "ring_row":
        product = M._chunked_matmul

        def last_row_lost(block, w_t, chunks, seq_dim):
            y = product(block, w_t, chunks, seq_dim)
            y.narrow(seq_dim, y.shape[seq_dim] - 1, 1).zero_()
            return y
        return mock.patch.object(M, "_chunked_matmul", last_row_lost)
    if fault == "bias_copy":
        return mock.patch.object(L.RowParallelLinear, "_bias",
                                 lambda self: self.bias)
    raise ValueError(f"unknown fault {fault!r}")


def _tp_train(kind, device, overrides, steps):
    """``steps`` steps of phase 5's GPT recipe (fused FFN, FusedAdam) or
    phase 7's BERT O2 + FusedLAMB recipe (fused FFN), each with
    ``fused_lm_head=False`` and ``overrides``, on the card ``device``:
    losses, step times, peak memory, launches, plain-version calls and
    the optimizer's tensor sizes."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(fused_ffn=True, fused_lm_head=False, **overrides)
    if kind == "gpt":
        sizes, shape = GPT350M, (ACCUM, MICRO, SEQ)
        model = GPTModel(GPTConfig(**dict(sizes, dtype=torch.bfloat16, **kw)),
                         device=device).init_params(
            torch.Generator().manual_seed(0))
        opt = FusedAdam(model.parameters(), lr=LR)
        rng = np.random.RandomState(0)
        tokens, targets = (torch.from_numpy(rng.randint(
            0, sizes["vocab_size"], shape)).to(device) for _ in range(2))

        def step():
            opt.zero_grad()
            loss = forward_backward_no_pipelining(
                lambda m, x: x, lambda x, t: model.loss(x, t), model, tokens,
                targets)
            opt.step()
            return loss
    else:
        sizes, shape = BERT_LARGE, (BERT_ACCUM, BERT_MICRO, BERT_SEQ)
        model, opt, _ = build_bert(device, dict(sizes, **kw), BERT_LR, 0)
        tokens, targets = (t.to(device) for t in mlm_batch(
            sizes["vocab_size"], shape, 0))

        def step():
            return bert_step(model, opt, tokens, targets)
    numels = [p.numel() for p in model.parameters()]
    counters = _all_counters()
    for c in counters:
        c.launches = 0
    losses, times = [], []
    with counting_plain_versions() as plain:
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(step()))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    return dict(losses=losses, step_times_s=times,
                launches=_launches_of(counters), plain_calls=dict(plain),
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                numels=numels, rows=shape[1] * shape[2],
                layers=sizes["num_layers"], micro_batches=shape[0])


def tp_expected_launches(kind, run, steps):
    """The launches of one rank's run: the LayerNorms, flash and fused FFN
    kernels per micro-batch and layer, the optimizer's kernels over the
    rank's shards; no LM-head launch (the vocab-parallel head)."""
    from apex_tpu_torch.ops import multi_tensor as K
    n = steps * run["micro_batches"]
    layers = run["layers"]
    per_mb = 2 * layers + (1 if kind == "gpt" else 2)
    out = {"layer_norm_fwd": n * per_mb, "layer_norm_bwd": n * per_mb,
           "flash_fwd": n * layers, "flash_attention_dq": n * layers,
           "flash_attention_dkv": n * layers,
           **ffn_launches(steps, run["micro_batches"], layers, True)}
    if kind == "gpt":
        out["multi_tensor_adam"] = steps * table_launches(run["numels"])
    else:
        out.update(
            multi_tensor_sumsq=steps * sumsq_launches(run["numels"]),
            multi_tensor_lamb_stage1=steps * K.lamb_stage1_launches(
                run["numels"]),
            multi_tensor_lamb_stage2=steps * table_launches(run["numels"]))
    return out


def _tp_rank(rank, world, out_dir, fault=None):
    """One rank of phase 15 (a spawned process on card ``rank``): first
    the one-process references (axis_name=None) of 15a and 15c, then the
    ``model`` group of all the ranks (NCCL, a ``file://`` store in
    ``out_dir``) and 15a-15c, with ``fault`` planted in them; results
    pickled into ``out_dir``.  An exception ends the process non-zero."""
    import pickle
    import torch.distributed as dist
    from apex_tpu_torch.transformer import parallel_state as ps
    torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    dist.init_process_group(
        "nccl", init_method=f"file://{pathlib.Path(out_dir).resolve()}/store",
        rank=rank, world_size=world)
    reference = {}
    for key, _, kind, _, steps in TP_RUNS:
        if key != "gpt_overlap":
            reference[key] = _tp_train(kind, device, {}, steps)
            torch.cuda.empty_cache()
    reference["gpt_overlap"] = reference["gpt"]
    ps.initialize_model_parallel(world)
    out = {}
    with _tp_plant(fault):
        for key, _, kind, overrides, steps in TP_RUNS:
            out[key] = _tp_train(kind, device, dict(
                overrides, tensor_parallel_size=world, axis_name="model"),
                steps)
            out[key]["reference"] = reference[key]["losses"][:steps]
            out[key]["reference_peak_memory_bytes"] = \
                reference[key]["peak_memory_bytes"]
            torch.cuda.empty_cache()
    with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    ps.destroy_model_parallel()
    dist.destroy_process_group()


def run_tp_ranks(world, out_dir, fault=None):
    """Spawn ``world`` ranks of :func:`_tp_rank` and return their results
    (a rank that raises makes this raise)."""
    import pickle
    import torch.multiprocessing as mp
    out_dir = pathlib.Path(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    mp.start_processes(_tp_rank, args=(world, str(out_dir), fault),
                       nprocs=world, start_method="spawn", join=True)
    ranks = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def tp_loss_gaps(ranks):
    """Per run, the largest relative gap of the ranks' losses (equal on
    every rank: the loss is the whole batch's) to the reference's."""
    return {key: max(abs(a - b) / abs(b)
                     for rank in ranks
                     for a, b in zip(rank[key]["losses"],
                                     rank[key]["reference"]))
            for key, *_ in TP_RUNS}


def tp_loss_limits(world):
    """Phase 15's loss gates at ``world`` ranks (``TP_LOSS_RTOL``).  A
    world without readings raises: its gates are not guessed from
    another's."""
    if world not in TP_LOSS_RTOL:
        raise ValueError(
            f"phase 15 has no loss-gate readings at {world} ranks (it has "
            f"{sorted(TP_LOSS_RTOL)}): take them with python3 "
            f"tools/tensor_parallel_torch.py --gates --world {world}")
    return dict(TP_LOSS_RTOL[world])


def phase_tensor_parallel(single=None, world=None):
    """Phase 15: ``world`` (default ``torch.cuda.device_count()``) NCCL
    ranks (spawned processes), one ``model`` group: 15a-15c at
    tensor-parallel size = the ranks, each rank's launches exact, no plain
    version, finite losses held against the one-process references
    (``tp_loss_limits``), peak memory beside the reference's (and phase
    5's / 7's, ``single``)."""
    world = world or torch.cuda.device_count()
    limits = tp_loss_limits(world)
    t0 = time.perf_counter()
    ranks = run_tp_ranks(world, pathlib.Path("build") / "phase15")
    seconds = time.perf_counter() - t0
    log(f"[15] tensor and sequence parallelism over NCCL, tensor-parallel "
        f"size {world} ({seconds:.1f} s)")
    gaps = tp_loss_gaps(ranks)
    for key, tag, kind, _, steps in TP_RUNS:
        for r, rank in enumerate(ranks):
            run = rank[key]
            expected = tp_expected_launches(kind, run, steps)
            run["expected"] = expected
            extra = ""
            if single and key in single:
                extra = (f", phase {5 if kind == 'gpt' else 7} "
                         f"{single[key] / 2 ** 30:.3f} GiB")
            log(f"{tag} rank {r}: losses {run['losses']} (one process "
                f"{run['reference']}); step times (s) "
                f"{[round(t, 4) for t in run['step_times_s']]}; peak memory "
                f"{run['peak_memory_bytes'] / 2 ** 30:.3f} GiB (one process "
                f"{run['reference_peak_memory_bytes'] / 2 ** 30:.3f} GiB"
                f"{extra})")
            log(f"    launches {run['launches']} (expected {expected}); "
                f"plain-version calls {run['plain_calls']}")
            if run["launches"] != expected:
                raise AssertionError(f"{tag}: launch counts do not match "
                                     "the path")
            if run["plain_calls"]:
                raise AssertionError(f"{tag}: a plain version was called")
            if not np.all(np.isfinite(run["losses"])):
                raise AssertionError(f"{tag}: non-finite loss")
        log(f"    {tag}: largest relative loss gap {gaps[key]!r} (limit "
            f"{limits[key]})")
    # every run's gap is logged before a gate fails
    over = {key: gap for key, gap in gaps.items() if not gap <= limits[key]}
    if over:
        raise AssertionError(f"phase 15: losses leave the one-process "
                             f"runs' by {over} (limits {limits})")
    return dict(world=world, seconds=seconds, gaps=gaps, ranks=ranks)


# -- phase 16 ----------------------------------------------------------------

# Switch-GPT-350M/8 through the ported MoE example: bench.py's GPT-350M
# (phase 5's widths, micro-batch 8 x 2, seq 1024, FusedAdam lr 1e-4) with
# examples/moe/train_switch_gpt.py's expert settings
SWITCH_ARGV = ["--n-experts", "8", "--capacity-factor", "1.25",
               "--batch-per-device", str(MICRO),
               "--accum", str(ACCUM), "--seq-len", str(SEQ), "--hidden",
               str(HIDDEN), "--layers", str(GPT350M["num_layers"]),
               "--heads", str(HEADS), "--vocab", str(GPT350M["vocab_size"]),
               "--lr", str(LR), "--print-freq", "1", "--seed", "0"]
SWITCH_STEPS = 4               # timed steps after the example's warm-up
# 16p / 16b's small Switch GPT in f32: routing is discrete, and at bf16 the
# card's and the CPU's rounding of a token's hidden state flips its top
# choice wherever two gate probabilities lie within a bf16 ulp, moving
# that token's whole contribution to another expert (tools/
# moe_parity_torch.py --dtype bfloat16: 51 / 97 token-choices rerouted, 58%
# / 68% of the largest embedding gradient entry off); in f32 the two runs
# route the same tokens (the tool: none rerouted).  The experts' ReLU is a
# kink too: an entry of the first expert product within rounding of 0
# (|z| <= 5.3e-7, two a run) takes the other side, and its token's whole
# product row then enters or leaves ``w1``'s gradient (up to 10% of its
# largest entry, 3.1e-3 in norm), so ``w1`` is held in norm, every other
# gradient entry by entry
PARITY_MOE = dict(PARITY_TRAIN, n_experts=8, dtype=torch.float32)
# 16p's gate on the experts' w1 in norm, between the correct and the
# planted-fault readings of tools/model_parallel_torch.py --gates --parts
# parity on the card (PERF.md): correct 3.06e-3 (top-1) / 3.50e-4 (top-2),
# drop_slot (one token's row out of one expert's w1 gradient) 5.80e-2 /
# 5.08e-2, which the card-vs-CPU gradient tolerance would let pass
MOE_W1_NORM_TOL = 1e-2
# Phase 16's loss gates, each between a correct and a planted-fault
# reading of tools/model_parallel_torch.py --gates on the card at full
# width (PERF.md; every fault of MP_FAULTS planted in one run, each in its
# own path).  One rank: 16c the ring pipeline (n_virtual=2) against
# forward_backward_no_pipelining on the same weights and batch reads 0.0
# over 4 steps (bit for bit: the same kernels in the same order; only the
# tied embedding's two gradient terms are added in the other order, which
# commutes), drop_microbatch 3.46e-2, so the gate is bit for bit; 16d's
# Ulysses and ring at one rank are the flash path (the JAX functions'
# n == 1 branch), so both are held bit for bit against 16c's reference.
# 2 / 4 cards, correct against faulted: EP 2.37e-5 / 3.43e-5 against
# 1.85e-4 / 7.92e-4 (a2a_bwd_local), PP 1F1B and interleaved 0.0 against
# 3.46e-2 / 1.69e-2, PP x TP + SP (4 cards) 2.35e-6 against 3.45e-2,
# Ulysses 8.93e-8 against 3.20e-3 / 4.21e-3 (a2a_bwd_local), ring 2.37e-5
# / 3.14e-5 against 1.03e-3 / 2.48e-3 (ring_dkv).  Single readings (the
# correct ones equal an earlier run's); another rank count raises.
MP_LOSS_RTOL = {
    1: dict(pipeline_v2=0.0, ulysses=0.0, ring=0.0),
    2: dict(ep=6e-5, pipeline_v1=0.0, pipeline_v2=0.0, ulysses=1e-5,
            ring=1e-4),
    4: dict(ep=1.5e-4, pipeline_v1=0.0, pipeline_v2=0.0, pp_tp=1e-5,
            ulysses=1e-5, ring=1.5e-4)}
CP_STEPS = 2


def _mp_counters():
    from apex_tpu_torch.ops.flash_attention import flash_attention_decode
    return _all_counters() + (flash_attention_decode,)


def _reset(counters):
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0


def _gpt_train_expected(steps, micro, layers, numels, last=True,
                        rows=MICRO * SEQ, flash=True):
    """Launches of ``steps`` steps of ``micro`` micro-batches through
    ``layers`` layers (and, with ``last``, the final LayerNorm and the
    fused LM head), then FusedAdam over ``numels``."""
    n = steps * micro
    out = {"layer_norm_fwd": n * (2 * layers + last),
           "layer_norm_bwd": n * (2 * layers + last),
           "multi_tensor_adam": steps * table_launches(numels)}
    if flash:
        out.update(flash_fwd=n * layers, flash_attention_dq=n * layers,
                   flash_attention_dkv=n * layers)
    if last:
        out["lm_head_fwd"] = n * 2
        out.update(lm_head_bwd_launches(n, rows, GPT350M["vocab_size"]))
    return {k: v for k, v in out.items() if v}


def _switch_train(top_k, steps, ep_argv=()):
    """16a: the ported example's ``main()`` at Switch-GPT-350M/8 widths:
    losses, aux losses, step times, peak memory, exact launches (the MoE
    slots add none: dispatch, expert products and combine are plain
    PyTorch and cuBLAS), plain-version calls."""
    from apex_tpu_torch.examples.moe import train_switch_gpt as ex
    counters = _mp_counters()
    _reset(counters)
    with counting_plain_versions() as plain:
        res = ex.main(SWITCH_ARGV + ["--top-k", str(top_k), "--steps",
                                     str(steps), *ep_argv])
    torch.cuda.synchronize()
    model = res.pop("model")
    opt = res.pop("optimizer")
    launches = _launches_of(counters)
    # one more FusedAdam step on the last gradients, timed alone (#18 over
    # the whole list; after the counts were read)
    res["adam_step_ms"] = min(_cuda_ms(opt.step) for _ in range(3))
    del opt
    numels = [p.numel() for p in model.parameters()]
    res.update(launches=launches, plain_calls=dict(plain),
               expected=_gpt_train_expected(
                   steps + 1, ACCUM, GPT350M["num_layers"], numels),
               parameters=sum(numels))
    return model, res


def _cuda_ms(fn):
    """Device time of one call of ``fn`` by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _moe_counting(model, on):
    for layer in model.layers:
        mlp = layer.mlp
        mlp.count_drops = on
        mlp.count_rows = mlp.dropped = mlp.routed = mlp.chosen = None


def _count_real_rows(engine, model, into):
    """Wrap ``engine``'s prefill and ``model.decode_step`` so that each MoE
    slot counts the rows of real tokens only (a prompt's length of its
    bucket; the active decode slots), summed into ``into["prefill"]`` /
    ``into["decode"]`` as device tensors: the dropped and routed
    token-choices, and the busiest expert's share of a slot's first
    choices in one call (where the capacity bites), summed over the
    (slot, call) pairs, and its largest."""
    real_prefill, real_decode = engine._prefill_context, model.decode_step

    def counted(kind, rows, call, *args):
        mlps = [layer.mlp for layer in model.layers]
        for mlp in mlps:
            mlp.count_rows = rows
        out = call(*args)
        share = torch.stack([m.chosen.max() / m.chosen.sum() for m in mlps])
        got = dict(dropped=sum(m.dropped for m in mlps),
                   routed=sum(m.routed for m in mlps),
                   share_sum=share.sum(), share_max=share.max(),
                   slot_calls=len(mlps))
        acc = into.setdefault(kind, got)
        if acc is not got:
            for key in ("dropped", "routed", "share_sum", "slot_calls"):
                acc[key] = acc[key] + got[key]
            acc["share_max"] = torch.maximum(acc["share_max"],
                                             got["share_max"])
        _moe_counting(model, True)
        return out

    def prefill(ctx):
        rows = torch.arange(engine._bucket(len(ctx)),
                            device=engine.device) < len(ctx)
        return counted("prefill", rows, real_prefill, ctx)

    def decode(tokens, cache, positions):
        active = np.zeros((engine.cache.slots,), bool)
        active[list(engine._active)] = True
        rows = torch.from_numpy(active).to(engine.device)
        return counted("decode", rows, real_decode, tokens, cache,
                       positions)
    engine._prefill_context, model.decode_step = prefill, decode


def _switch_serve(model):
    """16b: phase 3's 10 greedy requests through ``InferenceEngine`` on the
    Switch model: exact #1 / #3 / #6 launches, no plain version, and the
    share of the real tokens' token-choices that the capacity dropped, in
    the prefills and in the decode steps (a decode step's 8 rows over 8
    experts give capacity 1: JAX's semantics), with the busiest expert's
    share of a MoE slot's real first choices in one call."""
    from apex_tpu_torch.inference import InferenceEngine, Request
    counters = _mp_counters()
    cfg = model.cfg
    engine = InferenceEngine(model, max_slots=SLOTS, device="cuda")
    prompts = serving_prompts(np.random.RandomState(0), cfg.vocab_size)
    for i, p in enumerate(prompts):
        engine.submit(Request(request_id=i, max_new_tokens=32, prompt=p))
    counts = {}
    _moe_counting(model, True)
    _count_real_rows(engine, model, counts)
    _reset(counters)
    t0 = time.perf_counter()
    try:
        with counting_plain_versions() as plain:
            responses = engine.run()
        torch.cuda.synchronize()
    finally:
        # the wrappers close over the engine: unbind them so the engine
        # and its cache are freed with this frame
        del model.decode_step, engine._prefill_context
        _moe_counting(model, False)
    wall = time.perf_counter() - t0
    drops = {}
    for kind, c in counts.items():
        drops[kind] = dict(
            dropped=int(c["dropped"]), routed=int(c["routed"]),
            share=int(c["dropped"]) / int(c["routed"]),
            busiest_mean=float(c["share_sum"]) / c["slot_calls"],
            busiest_max=float(c["share_max"]))
    prefills, steps, layers = len(prompts), len(engine.metrics.occupancy), \
        cfg.num_layers
    bad = [r.request_id for r in responses
           if r.finish_reason not in ("eos", "length") or len(r.tokens) != 32
           or not all(0 <= t < cfg.vocab_size for t in r.tokens)]
    return dict(
        wall_s=wall, responses=len(responses), bad=bad,
        launches=_launches_of(counters), plain_calls=dict(plain),
        expected={"layer_norm_fwd": (2 * layers + 1) * (prefills + steps),
                  "flash_fwd": layers * prefills,
                  "flash_attention_decode": layers * steps},
        prefills=prefills, decode_steps=steps, drops=drops,
        tokens_per_s=engine.metrics.summary()["tokens_per_s"])


def _plant_moe(fault):
    """``drop_slot`` (for the gate readings of ``MOE_W1_NORM_TOL``): the
    first slot of the first expert that holds a token carries no gradient
    through the experts' ReLU, so one token's row leaves that expert's
    ``w1`` gradient (and its path back); None plants nothing."""
    from unittest import mock
    if fault is None:
        return contextlib.nullcontext()
    if fault != "drop_slot":
        raise ValueError(f"unknown fault {fault!r}")
    relu = torch.relu

    def dropped(z):
        out = relu(z)
        if z.dim() != 3:                  # not the (E, cap, F) expert product
            return out
        e = int((z[:, 0] != 0).any(-1).nonzero()[0])
        keep = torch.ones_like(out)
        keep[e, 0] = 0
        return out * keep + (out * (1 - keep)).detach()
    return mock.patch.object(torch, "relu", dropped)


def _moe_train_parity(top_k, fault=None):
    """16p: a small Switch / GShard GPT (phase 6's widths, 8 experts) 2
    steps on the card (with ``fault`` planted there, for the gate
    readings) and on a CPU copy, with phase 6's gates."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    cfg = GPTConfig(**PARITY_MOE, moe_top_k=top_k)
    card = GPTModel(cfg, device="cuda").init_params(
        torch.Generator().manual_seed(1))
    cpu = GPTModel(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    rng = np.random.RandomState(2)
    shape = (2, 2, PARITY_MOE["max_seq_len"])
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape))
    targets = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape))
    runs = {}
    for name, model in (("card", card), ("cpu", cpu)):
        dev = next(model.parameters()).device
        opt = FusedAdam(model.parameters(), lr=LR)
        losses, grads = [], None
        for step in range(2):
            with _plant_moe(fault if name == "card" else None):
                losses.append(float(_loss_step(
                    model, opt, tokens.to(dev), targets.to(dev), seed=3)))
            if step == 0:
                grads = {n: p.grad.float().cpu()
                         for n, p in model.named_parameters()}
        runs[name] = (losses, grads)
    (cl, cg), (rl, rg) = runs["card"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(cl, rl))
    errs = {n: float((cg[n] - rg[n]).abs().max() / rg[n].abs().max())
            for n in rg}
    kinked = {n: float((cg[n] - rg[n]).norm() / rg[n].norm())
              for n in rg if n.endswith("mlp.w1")}
    entrywise = {n: e for n, e in errs.items() if n not in kinked}
    worst = max(entrywise, key=entrywise.get)
    worst_w1 = max(kinked, key=kinked.get)
    return dict(top_k=top_k, losses_card=cl, losses_cpu=rl,
                loss_rel_err=loss_err, grad_rel_err=entrywise[worst],
                worst_grad=worst, w1_norm_err=kinked[worst_w1],
                worst_w1=worst_w1, w1_entry_err=max(errs[n] for n in kinked))


def _loss_step(model, opt, tokens, targets, seed=None, reduce=None):
    """One step of ``forward_backward_no_pipelining`` over ``model.loss``
    (``reduce`` then sums the gradients where a group must), FusedAdam."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    opt.zero_grad()
    loss = forward_backward_no_pipelining(
        lambda m, x: x, lambda x, t: model.loss(x, t, dropout_seed=seed),
        model, tokens, targets)
    if reduce is not None:
        reduce(model)
    opt.step()
    return loss


def _moe_serve_parity():
    """16b's small-width check: a small Switch GPT's prefill(64) + 4 decode
    steps on the card and a CPU copy, with phase 4's gates."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    cfg = GPTConfig(**dict(PARITY_MOE, attention_dropout=0.0))
    card = GPTModel(cfg, device="cuda").init_params(
        torch.Generator().manual_seed(4))
    cpu = GPTModel(cfg, device="cpu")
    cpu.load_state_dict(card.state_dict())
    prompt = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (1, 64)))

    def run(model, forced=None):
        dev = next(model.parameters()).device
        cache = torch.zeros((1, cfg.num_layers, 2, cfg.max_seq_len,
                             cfg.num_attention_heads, cfg.head_dim),
                            dtype=cfg.dtype, device=dev)
        with torch.no_grad():
            logits, kv = model.prefill(prompt.to(dev))
            cache[0, :, :, :64] = kv[:, :, 0].to(cache.dtype)
            rows = [logits[0, 63]]
            for i in range(4):
                tok = forced[i] if forced is not None \
                    else int(rows[-1].argmax())
                lg, cache = model.decode_step(
                    torch.tensor([tok], device=dev), cache,
                    torch.tensor([64 + i], dtype=torch.int32, device=dev))
                rows.append(lg[0])
        return torch.stack(rows).float().cpu()

    got = run(card)
    tokens = got.argmax(-1).tolist()
    want = run(cpu, forced=tokens)
    diff = (got - want).abs()
    return dict(max_logit_diff=float(diff.max()),
                mean_logit_diff=float(diff.mean()), tokens=tokens,
                cpu_tokens=want.argmax(-1).tolist(),
                finite=bool(torch.isfinite(got).all()))


def _gpt350m_batch(rank=0, world=1, seq_axis=False, n_micro=ACCUM):
    """Phase 5's fixed batch (seed 0) as ``n_micro`` micro-batches of its
    16 rows (the interleaved schedule over S stages needs a multiple of
    S), this rank's sequence shard under context parallelism."""
    rng = np.random.RandomState(0)
    shape = (ACCUM, MICRO, SEQ)
    out = [torch.from_numpy(rng.randint(0, GPT350M["vocab_size"], shape))
           .reshape(n_micro, ACCUM * MICRO // n_micro, SEQ)
           for _ in range(2)]
    if seq_axis:
        out = [_shard(t, rank, world, axis=2) for t in out]
    return [t.to("cuda") for t in out]


# The faults planted for phase 16's gate readings, each in one path's own
# code (the references never run it: they take no pipeline engine and no
# collective), so one run with all of them planted reads every path's gap
MP_FAULTS = ("drop_microbatch", "ring_dkv", "a2a_bwd_local")


def _own_block_only(x, group, axis):
    """``x`` with its ``n`` blocks along ``axis`` zeroed but this rank's
    (what an exchange then delivers: the rank's own block, zeros from the
    others)."""
    import torch.distributed as dist
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[axis] // n
    mask = torch.zeros(x.shape[axis], dtype=x.dtype, device=x.device)
    mask[r * size:(r + 1) * size] = 1
    shape = [1] * x.dim()
    shape[axis] = -1
    return x * mask.view(shape)


def _plant_mp(faults):
    """Plant ``faults`` (for the gate readings): ``drop_microbatch``: the
    pipeline engine's last micro-batch loses its gradients (its loss still
    counts); ``ring_dkv``: ring attention's dK / dV accumulators do not
    travel the reverse ring (each hop delivers zeros, so a chunk keeps only
    its owner's last step); ``a2a_bwd_local``: the backward exchanges of
    the MoE ``all_to_all`` and of Ulysses' reshards deliver only the
    rank's own block."""
    from unittest import mock
    from apex_tpu_torch.transformer import context_parallel as cp
    from apex_tpu_torch.transformer import expert_parallel as ep
    from apex_tpu_torch.transformer.pipeline_parallel import ring
    stack = contextlib.ExitStack()
    for fault in faults:
        if fault not in MP_FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
    if "drop_microbatch" in faults:
        real = ring.pipeline_schedule_step

        def dropped(stage_fn, last_fn, stage_params, last_params, x0,
                    targets, **kw):
            m = len(targets)

            def last(lp, y, t, info):
                lm = last_fn(lp, y, t, info)
                return lm.detach() + 0 * lm if info.microbatch == m - 1 \
                    else lm
            return real(stage_fn, last, stage_params, last_params, x0,
                        targets, **kw)
        stack.enter_context(mock.patch.object(
            ring, "pipeline_schedule_step", dropped))
    if "ring_dkv" in faults:
        real_hop = cp._ring_hop

        def hop(tensors, group, step=1):
            out = real_hop(tensors, group, step)
            if len(tensors) == 4:           # the reverse ring's K, V, dK, dV
                out[2:] = [torch.zeros_like(t) for t in out[2:]]
            return out
        stack.enter_context(mock.patch.object(cp, "_ring_hop", hop))
    if "a2a_bwd_local" in faults:
        def a2a_backward(ctx, g):
            return ep._exchange(_own_block_only(g, ctx.group, 0),
                                ctx.group), None

        def reshard_backward(ctx, g):
            return (cp._tiled_all_to_all(
                _own_block_only(g, ctx.group, ctx.concat), ctx.group,
                ctx.concat, ctx.split), None, None, None)
        stack.enter_context(mock.patch.object(
            ep._AllToAll, "backward", staticmethod(a2a_backward)))
        stack.enter_context(mock.patch.object(
            cp._Reshard, "backward", staticmethod(reshard_backward)))
    return stack


def _pipeline_train(world, rank, n_virtual, steps, overrides=None,
                    n_micro=ACCUM):
    """16c: GPT-350M at phase 5's recipe through ``pipeline_step`` over
    ``world`` pipe ranks with ``n_virtual`` chunks a rank (this rank's
    stage model), FusedAdam; losses, launches and peak memory."""
    from apex_tpu_torch.models.gpt import (GPTConfig, GPTModel,
                                           pipeline_step)
    from apex_tpu_torch.optimizers import FusedAdam
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = GPTConfig(**dict(GPT350M, dtype=torch.bfloat16,
                           **(overrides or {})))
    model = GPTModel(cfg, device="cuda",
                     pipeline_stage=(world, n_virtual, rank)).init_params(
        torch.Generator().manual_seed(0))
    opt = FusedAdam(model.parameters(), lr=LR)
    tokens, targets = _gpt350m_batch(n_micro=n_micro)
    numels = [p.numel() for p in model.parameters()]
    counters = _mp_counters()
    _reset(counters)
    losses, times = [], []
    with counting_plain_versions() as plain:
        for _ in range(steps):
            t0 = time.perf_counter()
            opt.zero_grad()
            loss = pipeline_step(model, tokens, targets,
                                 n_virtual=n_virtual)
            opt.step()
            losses.append(float(loss))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    tp = cfg.tensor_parallel_size
    return dict(losses=losses, step_times_s=times,
                launches=_launches_of(counters), plain_calls=dict(plain),
                expected=_gpt_train_expected(
                    steps, n_micro, len(model.layers), numels,
                    last=rank == world - 1 or world == 1,
                    rows=ACCUM * MICRO // n_micro * SEQ)
                if tp == 1 else None,
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def _reference_train(steps, overrides=None, seq_rank=0, seq_world=1,
                     reduce=None, n_micro=ACCUM):
    """Phase 5's recipe through ``forward_backward_no_pipelining`` over
    ``GPTModel.loss`` (16c's reference; 16d with ``context_axis`` in
    ``overrides``, on this rank's sequence shard, its gradients summed over
    the context group by ``reduce``)."""
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = GPTConfig(**dict(GPT350M, dtype=torch.bfloat16,
                           **(overrides or {})))
    model = GPTModel(cfg, device="cuda").init_params(
        torch.Generator().manual_seed(0))
    opt = FusedAdam(model.parameters(), lr=LR)
    tokens, targets = _gpt350m_batch(seq_rank, seq_world,
                                     seq_axis=seq_world > 1, n_micro=n_micro)
    numels = [p.numel() for p in model.parameters()]
    counters = _mp_counters()
    _reset(counters)
    losses, times = [], []
    with counting_plain_versions() as plain:
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(_loss_step(model, opt, tokens, targets,
                                           reduce=reduce)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    ring = (overrides or {}).get("context_mechanism") == "ring"
    return dict(losses=losses, step_times_s=times,
                launches=_launches_of(counters), plain_calls=dict(plain),
                expected=_gpt_train_expected(
                    steps, n_micro, GPT350M["num_layers"], numels,
                    rows=ACCUM * MICRO // n_micro * SEQ // seq_world,
                    flash=not (ring and seq_world > 1)),
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def _context_grad_sum(group):
    """Sum every parameter's gradient over the context group (each rank
    differentiated its share of the pmean loss: JAX's psum of the
    partial gradients)."""
    import torch.distributed as dist

    def reduce(model):
        for p in model.parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad, group=group)
    return reduce


def _mp_rank(rank, world, out_dir, parts, faults=()):
    """One rank of phase 16 (a spawned process on card ``rank``, NCCL
    through a ``file://`` store in ``out_dir``): the ``parts`` of 16a,
    16p, 16b, 16c, 16d (and, for the tool, the EP and PP x TP runs), with
    ``faults`` planted (``_plant_mp``); results pickled into ``out_dir``.
    An exception ends the process non-zero."""
    with _plant_mp(faults):
        _mp_parts(rank, world, out_dir, parts)


def _mp_parts(rank, world, out_dir, parts):
    import pickle
    import torch.distributed as dist
    from apex_tpu_torch.transformer import parallel_state as ps
    torch.cuda.set_device(rank)
    out = {}
    if "ep_reference" in parts:
        # one process on this card: the per-shard golden of 16a's EP run
        # (the same global batch, each rank's rows its own micro-batches)
        model, out["ep_reference"] = _switch_train(
            1, SWITCH_STEPS, ["--accum", str(ACCUM * world)])
        del model
        torch.cuda.empty_cache()
    dist.init_process_group(
        "nccl", init_method=f"file://{pathlib.Path(out_dir).resolve()}/store",
        rank=rank, world_size=world)
    if "switch" in parts:
        model, out["switch"] = _switch_train(1, SWITCH_STEPS)
        ps.destroy_model_parallel()
        torch.cuda.empty_cache()
        if world == 1:
            model.zero_grad(set_to_none=True)
            out["serve"] = _switch_serve(model)
        del model
        torch.cuda.empty_cache()
        model, out["gshard"] = _switch_train(2, 1)
        ps.destroy_model_parallel()
        del model
        torch.cuda.empty_cache()
    if "parity" in parts:
        out["parity"] = [_moe_train_parity(k) for k in (1, 2)]
        out["serve_parity"] = _moe_serve_parity()
        torch.cuda.empty_cache()
    if "pipeline" in parts:
        ps.initialize_model_parallel(1, world)
        n_micro = max(ACCUM, world)
        out["reference"] = _reference_train(TRAIN_STEPS, n_micro=n_micro)
        torch.cuda.empty_cache()
        for v in parts["pipeline"]:
            out[f"pipeline_v{v}"] = _pipeline_train(
                world, rank, v, TRAIN_STEPS, n_micro=n_micro)
            torch.cuda.empty_cache()
        ps.destroy_model_parallel()
    if "pp_tp" in parts:
        # pipe 2 x model 2 with sequence parallelism, against the same
        # configuration without the pipeline
        ps.initialize_model_parallel(2, world // 2)
        sp = dict(tensor_parallel_size=2, axis_name="model",
                  sequence_parallel=True)
        out["pp_tp_reference"] = _reference_train(TRAIN_STEPS, sp)
        torch.cuda.empty_cache()
        out["pp_tp"] = _pipeline_train(world // 2, ps.
                                       get_pipeline_model_parallel_rank(),
                                       1, TRAIN_STEPS, sp)
        ps.destroy_model_parallel()
        torch.cuda.empty_cache()
    if "context" in parts:
        ps.initialize_model_parallel(context_parallel_size_=world)
        reduce = (_context_grad_sum(ps.get_context_parallel_group())
                  if world > 1 else None)
        for mech in ("ulysses", "ring"):
            out[mech] = _reference_train(
                CP_STEPS, dict(context_axis="context",
                               context_mechanism=mech), rank, world, reduce)
            torch.cuda.empty_cache()
        ps.destroy_model_parallel()
    with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def run_mp_ranks(world, out_dir, parts, faults=()):
    """Spawn ``world`` ranks of :func:`_mp_rank` and return their results
    (a rank that raises makes this raise)."""
    import pickle
    import torch.multiprocessing as mp
    out_dir = pathlib.Path(out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    mp.start_processes(_mp_rank, args=(world, str(out_dir), parts,
                                       tuple(faults)),
                       nprocs=world, start_method="spawn", join=True)
    ranks = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


PHASE16_PARTS = {"switch": True, "parity": True, "pipeline": (2,),
                 "context": True}


def _check_run(tag, run):
    """Exact launches, no plain version, finite losses."""
    log(f"    {tag}: launches {run['launches']} (expected "
        f"{run['expected']}); plain-version calls {run['plain_calls']}")
    if run["launches"] != run["expected"]:
        raise AssertionError(f"{tag}: launch counts do not match the path")
    if run["plain_calls"]:
        raise AssertionError(f"{tag}: a plain version was called")
    if "losses" in run and not np.all(np.isfinite(run["losses"])):
        raise AssertionError(f"{tag}: non-finite loss")


def _gap(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def mp_loss_limits(world):
    """Phase 16's loss gates at ``world`` ranks (``MP_LOSS_RTOL``).  A
    world without readings raises: its gates are not guessed from
    another's."""
    if world not in MP_LOSS_RTOL:
        raise ValueError(
            f"phase 16 has no loss-gate readings at {world} ranks (it has "
            f"{sorted(MP_LOSS_RTOL)}): take them with python3 "
            f"tools/model_parallel_torch.py --gates --world {world}")
    return dict(MP_LOSS_RTOL[world])


def gate_mp(gaps, world):
    """Hold every gap of :func:`report_mp` to its gate at ``world`` ranks
    (a gap without a gate raises)."""
    limits = mp_loss_limits(world)
    missing = sorted(set(gaps) - set(limits))
    if missing:
        raise ValueError(f"phase 16 has no loss-gate readings for "
                         f"{missing} at {world} ranks")
    over = {key: gap for key, gap in gaps.items() if not gap <= limits[key]}
    if over:
        raise AssertionError(f"phase 16: losses leave their references' by "
                             f"{over} (limits {limits})")


def report_mp(ranks, world, parts):
    """Log and check phase 16's results (launches, plain calls, 16p, 16b);
    returns the loss gaps to the references, for :func:`gate_mp`."""
    limits = MP_LOSS_RTOL.get(world, {})
    gaps = {}
    for r, rank in enumerate(ranks):
        if "switch" in rank:
            for key, tag in (("switch", "[16a] Switch-GPT-350M/8 (top-1)"),
                             ("gshard", "[16a] GShard-GPT-350M/8 (top-2)")):
                run = rank[key]
                steps = run["step_times_s"]
                log(f"{tag} rank {r} via examples/moe/train_switch_gpt "
                    f"main(): {run['parameters']:,} parameters on the rank; "
                    f"warm-up loss {run['warmup_loss']:.5f} (aux "
                    f"{run['warmup_aux']:.5f}), losses "
                    f"{[round(x, 5) for x in run['losses']]}, aux "
                    f"{[round(x, 5) for x in run['aux_losses']]}; step times "
                    f"(s) {[round(t, 4) for t in steps]}, median "
                    f"{statistics.median(steps):.4f} s, "
                    f"{run['tokens_per_s']:.1f} tokens/s; peak memory "
                    f"{run['peak_memory_bytes'] / 2 ** 30:.3f} GiB; one more "
                    f"FusedAdam step alone {run['adam_step_ms']:.3f} ms")
                _check_run(tag, run)
            if "ep_reference" in rank:
                ref = rank["ep_reference"]
                gap = _gap(rank["switch"]["losses"], ref["losses"])
                gaps["ep"] = max(gaps.get("ep", 0.0), gap)
                log(f"    EP {world} rank {r} against one process on the "
                    f"same global batch (per-shard micro-batches): losses "
                    f"{ref['losses']}, gap {gap!r}")
        if "serve" in rank:
            run = rank["serve"]
            log(f"[16b] Switch-GPT-350M/8 served {run['responses']} "
                f"requests in {run['wall_s']:.3f} s ({run['prefills']} "
                f"prefills, {run['decode_steps']} decode steps, "
                f"{run['tokens_per_s']:.1f} tokens/s); the real tokens' "
                f"token-choices dropped by capacity: " + "; ".join(
                    f"{kind} {d['dropped']} of {d['routed']} "
                    f"({d['share']:.4f}; the busiest expert took on "
                    f"average {d['busiest_mean']:.4f}, at most "
                    f"{d['busiest_max']:.4f}, of a slot's first choices in "
                    f"a call)"
                    for kind, d in run["drops"].items()))
            if run["bad"]:
                raise AssertionError(f"[16b] bad responses {run['bad']}")
            _check_run("[16b]", run)
        if "parity" in rank:
            for p in rank["parity"]:
                log(f"[16p] top-{p['top_k']} card vs CPU (4 layers, hidden "
                    f"256, 8 experts, dropout 0.1, f32, 2 steps): losses card "
                    f"{p['losses_card']} cpu {p['losses_cpu']}, relative "
                    f"{p['loss_rel_err']:.3e} (tolerance {TRAIN_LOSS_RTOL}); "
                    f"step-1 grads max |diff| / max|grad| "
                    f"{p['grad_rel_err']:.3e} at {p['worst_grad']} "
                    f"(tolerance {TRAIN_GRAD_TOL}); the experts' w1 "
                    f"||diff|| / ||grad|| {p['w1_norm_err']:.3e} at "
                    f"{p['worst_w1']} (tolerance {MOE_W1_NORM_TOL}; entry by "
                    f"entry {p['w1_entry_err']:.3e}, ReLU's kink)")
                if not (p["loss_rel_err"] <= TRAIN_LOSS_RTOL
                        and p["grad_rel_err"] <= TRAIN_GRAD_TOL
                        and p["w1_norm_err"] <= MOE_W1_NORM_TOL):
                    raise AssertionError("[16p] card and CPU disagree")
            s = rank["serve_parity"]
            log(f"[16b] small Switch GPT (f32) card vs CPU, prefill(64) + 4 "
                f"decode "
                f"steps: max |logit diff| {s['max_logit_diff']:.3e} "
                f"(tolerance {LOGITS_ATOL}), mean {s['mean_logit_diff']:.3e} "
                f"(tolerance {LOGITS_MEAN_ATOL}); greedy card {s['tokens']} "
                f"cpu {s['cpu_tokens']}")
            if not (s["finite"] and s["max_logit_diff"] <= LOGITS_ATOL
                    and s["mean_logit_diff"] <= LOGITS_MEAN_ATOL
                    and s["tokens"] == s["cpu_tokens"]):
                raise AssertionError("[16b] card and CPU serving disagree")
        if "reference" in rank:
            ref = rank["reference"]
            _check_run(f"[16c] reference rank {r}", ref)
            for v in parts.get("pipeline", ()):
                run = rank[f"pipeline_v{v}"]
                key = f"pipeline_v{v}"
                gaps[key] = max(gaps.get(key, 0.0),
                                _gap(run["losses"], ref["losses"]))
                log(f"[16c] GPT-350M pipeline_step over {world} stage(s), "
                    f"n_virtual={v}, rank {r}: losses {run['losses']} "
                    f"(forward_backward_no_pipelining {ref['losses']}); step "
                    f"times (s) {[round(t, 4) for t in run['step_times_s']]}"
                    f" (reference "
                    f"{[round(t, 4) for t in ref['step_times_s']]}); peak "
                    f"memory {run['peak_memory_bytes'] / 2 ** 30:.3f} GiB "
                    f"(reference {ref['peak_memory_bytes'] / 2 ** 30:.3f})")
                _check_run(f"[16c] v={v} rank {r}", run)
        if "pp_tp" in rank:
            run, ref = rank["pp_tp"], rank["pp_tp_reference"]
            gaps["pp_tp"] = max(gaps.get("pp_tp", 0.0),
                                _gap(run["losses"], ref["losses"]))
            log(f"[16c] PP x TP + SP rank {r}: losses {run['losses']} "
                f"(no pipeline {ref['losses']}); step times (s) "
                f"{[round(t, 4) for t in run['step_times_s']]}; peak memory "
                f"{run['peak_memory_bytes'] / 2 ** 30:.3f} GiB")
        for mech in ("ulysses", "ring"):
            if mech in rank:
                run = rank[mech]
                want = ranks[0].get("reference", {}).get("losses")
                log(f"[16d] GPT-350M context_axis ({mech}) over {world} "
                    f"rank(s), rank {r}: losses {run['losses']} (16c "
                    f"reference {want and want[:CP_STEPS]}); step times (s) "
                    f"{[round(t, 4) for t in run['step_times_s']]}; peak "
                    f"memory {run['peak_memory_bytes'] / 2 ** 30:.3f} GiB")
                _check_run(f"[16d] {mech} rank {r}", run)
                if want:
                    gaps[mech] = max(gaps.get(mech, 0.0),
                                     _gap(run["losses"], want[:CP_STEPS]))
    for key, gap in gaps.items():
        log(f"    phase 16 {key}: largest relative loss gap {gap!r} (limit "
            f"{limits.get(key)})")
    return gaps


def phase_model_parallel(world=None):
    """Phase 16 on ``world`` (default ``torch.cuda.device_count()``) NCCL
    ranks (spawned processes, ``build/phase16/``): 16a Switch-GPT-350M/8
    training through the ported example (and one GShard step), 16p small
    MoE card vs CPU, 16b Switch-GPT-350M/8 serving (one rank), 16c the
    ring pipeline (interleaved, ``n_virtual=2``) against
    ``forward_backward_no_pipelining``, 16d context parallelism (Ulysses
    and ring) against 16c's reference."""
    world = world or torch.cuda.device_count()
    mp_loss_limits(world)           # a world without readings stops here
    t0 = time.perf_counter()
    ranks = run_mp_ranks(world, pathlib.Path("build") / "phase16",
                         PHASE16_PARTS)
    seconds = time.perf_counter() - t0
    log(f"[16] expert, pipeline and context parallelism over NCCL, {world} "
        f"rank(s) ({seconds:.1f} s)")
    gaps = report_mp(ranks, world, PHASE16_PARTS)
    gate_mp(gaps, world)
    return dict(world=world, seconds=seconds, gaps=gaps, ranks=ranks)


# -- phase 17: resilience -------------------------------------------------------

RESILIENCE_KEEP = 2            # kept checkpoints (4.25 GB each at GPT-350M)
RESILIENCE_SAVE_EVERY = 4
# 17a's FaultInjector schedule: (step, kind, magnitude, once).  The save
# committed at step 8 is corrupted, so the rollback that the nan steps 8-10
# trigger (K = 3 in a row) falls back to the checkpoint of step 4; the
# spike fires once (a rolled-back re-run of step 6 would be clean)
GUARD_FAULTS = ((1, "inf_loss", 0.0, False), (6, "grad_spike", 64.0, True),
                (8, "corrupt_checkpoint", 0.0, False),
                (8, "nan_grads", 0.0, False), (9, "nan_grads", 0.0, False),
                (10, "nan_grads", 0.0, False))
# (step, skipped, anomaly, next_step, rolled_back, restored_from) per call
GUARD_EXPECTED = (
    (0, False, None, 1, False, None), (1, True, "nonfinite", 2, False, None),
    (2, False, None, 3, False, None), (3, False, None, 4, False, None),
    (4, False, None, 5, False, None), (5, False, None, 6, False, None),
    (6, True, "spike", 7, False, None), (7, False, None, 8, False, None),
    (8, True, "nonfinite", 9, False, None),
    (9, True, "nonfinite", 10, False, None),
    (10, True, "nonfinite", 4, True, 4),
    (4, False, None, 5, False, None), (5, False, None, 6, False, None))
GUARD_WARMUP = 3
# the states 17a keeps (4.25 GB each): after steps 3 (the checkpoint of step
# 4 that the rollback restores), 4 and 5 (what the re-run after it repeats)
GUARD_SNAPSHOTS = (4, 5, 6)
ELASTIC_STEPS = 6              # 17b's run length
ELASTIC_PREEMPT_AT = 2         # 17b's soft preemption (seen at this step)
ELASTIC_REPLAN_AT = 5          # 17b's in-place replan (seen at this step)


def _gpt_grad_fn(model, tokens, targets):
    """Phase 5's step without the optimizer: the schedule over the model's
    loss and backward (the guard's ``grad_fn``)."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    return forward_backward_no_pipelining(
        lambda m, x: m.backbone(m.embed(x), None),
        lambda x, t: model.head_loss(x, t).mean(), model, tokens, targets)


def _train_state(model, opt):
    """The tensors a checkpoint of (model, opt) holds: parameters, then the
    optimizer's state leaves (live references)."""
    from apex_tpu_torch.resilience import optimizer_state
    from apex_tpu_torch.resilience.checkpoint import (ShardedLeaf,
                                                      tree_flatten)
    leaves, _ = tree_flatten(optimizer_state(opt))
    return list(model.parameters()) + [
        leaf.data if isinstance(leaf, ShardedLeaf) else leaf
        for leaf in leaves]


def _clone_all(tensors):
    return [t.detach().clone() for t in tensors]


def _equal_all(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _trace_io(mgr, tag, into):
    """Record every save's and restore's statistics of ``mgr`` (the
    snapshot, hash, write and read seconds and rates) into ``into``."""
    commit, restore = mgr._commit, mgr.restore

    def traced_commit(*args, **kwargs):
        path = commit(*args, **kwargs)
        into.append(dict(mgr.last_save, tag=tag, op="save"))
        return path

    def traced_restore(*args, **kwargs):
        out = restore(*args, **kwargs)
        into.append(dict(mgr.last_restore, tag=tag, op="restore"))
        return out
    mgr._commit, mgr.restore = traced_commit, traced_restore
    return mgr


def _log_io(io):
    for e in io:
        extra = (f"snapshot {e['snapshot_s']:.3f} s, write+fsync "
                 f"{e['write_s']:.3f} s" if e["op"] == "save"
                 else f"read {e['read_s']:.3f} s")
        log(f"    {e['tag']} {e['op']} step {e['step']}: "
            f"{e['bytes'] / 1e9:.3f} GB in {e['seconds']:.3f} s "
            f"({e['gb_per_s']:.3f} GB/s; {extra}, sha256 "
            f"{e['sha256_s']:.3f} s)")


def _guard_expected(numels, steps):
    """Launches of ``steps`` guarded phase-5 steps: phase 5's and the
    guard's one #17 sum of squares over the gradients a step."""
    out = _gpt_train_expected(steps, ACCUM, GPT350M["num_layers"], numels)
    out["multi_tensor_sumsq"] = steps * sumsq_launches(numels)
    return out


def _phase17_batch():
    rng = np.random.RandomState(0)
    shape = (ACCUM, MICRO, SEQ)
    return tuple(torch.from_numpy(rng.randint(
        0, GPT350M["vocab_size"], shape)).to("cuda") for _ in range(2))


def _resilience_guard(init, batch, ckdir, io):
    """17a: the guarded GPT-350M step under one fault schedule, against an
    unguarded phase-5 loop on the same weights and batch."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.resilience import (CheckpointManager, Fault,
                                           FaultInjector, GuardedTrainStep)
    model = build_model("cuda")
    model.load_state_dict(init)
    opt = FusedAdam(model.parameters(), lr=LR)
    ref = build_model("cuda")
    ref.load_state_dict(init)
    ref_opt = FusedAdam(ref.parameters(), lr=LR)
    inj = FaultInjector([Fault(s, k, m, once) for s, k, m, once
                         in GUARD_FAULTS])
    mgr = _trace_io(CheckpointManager(ckdir, keep=RESILIENCE_KEEP,
                                      fault_injector=inj), "[17a]", io)
    guard = GuardedTrainStep(grad_fn=_gpt_grad_fn, optimizer=opt,
                             warmup_steps=GUARD_WARMUP, spike_factor=10.0,
                             max_consecutive=3, checkpoint=mgr,
                             fault_injector=inj)
    numels = [p.numel() for p in model.parameters()]
    per_step = _guard_expected(numels, 1)
    counters = _train_counters() + (_sumsq_counter(),)
    gstate = guard.init_state()
    seq, step_times, snaps, checks = [], [], {}, collections.Counter()
    ref_in_step, step = True, 0
    with counting_plain_versions() as plain:
        for _ in GUARD_EXPECTED:
            before = _clone_all(_train_state(model, opt))
            _reset(counters)
            t0 = time.perf_counter()
            res = guard(model, gstate, *batch, step=step)
            torch.cuda.synchronize()
            step_times.append(time.perf_counter() - t0)
            launches = _launches_of(counters)
            if launches != per_step:
                raise AssertionError(
                    f"[17a] step {step}: launches {launches}, expected "
                    f"{per_step}")
            gstate = res.guard_state
            seq.append((step, res.skipped, res.anomaly, res.next_step,
                        res.rolled_back, res.restored_from))
            state = _train_state(model, opt)
            if res.rolled_back:
                if not _equal_all(state, snaps[res.restored_from]):
                    raise AssertionError("[17a] the rollback did not "
                                         "restore the checkpointed state")
                checks["rollback_bitwise"] += 1
                ref_in_step = False
            elif res.skipped:
                if not _equal_all(state, before):
                    raise AssertionError(f"[17a] skipped step {step} moved "
                                         "the parameters or Adam's state")
                checks["skip_bitwise"] += 1
            elif ref_in_step:
                # the same clean step unguarded: bit for bit
                train_step(ref, ref_opt, *batch)
                if not _equal_all(state, _train_state(ref, ref_opt)):
                    raise AssertionError(f"[17a] clean step {step} differs "
                                         "from an unguarded step")
                checks["clean_bitwise"] += 1
            elif step + 1 in snaps:
                # after the rollback: the re-run equals the first pass
                if not _equal_all(state, snaps[step + 1]):
                    raise AssertionError(f"[17a] re-run of step {step} "
                                         "differs from its first pass")
                checks["rerun_bitwise"] += 1
            step = res.next_step
            if step in GUARD_SNAPSHOTS and ref_in_step:
                snaps[step] = _clone_all(state)
            if step % RESILIENCE_SAVE_EVERY == 0 and not res.rolled_back:
                guard.save(step, model, gstate)
    want = [tuple(e) for e in GUARD_EXPECTED]
    log(f"[17a] GuardedTrainStep over GPT-350M (phase 5's recipe, "
        f"FusedAdam lr={LR}, warm-up {GUARD_WARMUP}, spike x10, K 3, "
        f"keep {RESILIENCE_KEEP}, a save every {RESILIENCE_SAVE_EVERY}): "
        f"{len(seq)} steps, results {seq}; step times (s) "
        f"{[round(t, 4) for t in step_times]}; bitwise checks "
        f"{dict(checks)}; guard stats {guard.stats}; applied faults "
        f"{inj.log}; launches a step {per_step}; plain-version calls "
        f"{dict(plain)}")
    if seq != want:
        raise AssertionError(f"[17a] step results {seq} != {want}")
    if sum(plain.values()):
        raise AssertionError("[17a] a plain version was called")
    if checks != {"clean_bitwise": 6, "skip_bitwise": 4,
                  "rollback_bitwise": 1, "rerun_bitwise": 2}:
        raise AssertionError(f"[17a] bitwise checks {dict(checks)}")
    launches = {k: v * len(seq) for k, v in per_step.items()}
    return dict(results=seq, step_times_s=step_times, checks=dict(checks),
                stats=guard.stats, launches=launches)


def _sumsq_counter():
    from apex_tpu_torch.ops.multi_tensor import multi_tensor_sumsq
    return multi_tensor_sumsq


def _resilience_factory(init, counters_io=None):
    """17b's plan factory: GPT-350M from ``init``, FusedAdam, the guard over
    phase 5's step."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.resilience import ElasticComponents, GuardedTrainStep

    def factory(plan, ckpt, inj):
        model = build_model(plan.device)
        model.load_state_dict(init)
        guard = GuardedTrainStep(
            grad_fn=_gpt_grad_fn,
            optimizer=FusedAdam(model.parameters(), lr=LR),
            warmup_steps=GUARD_WARMUP, checkpoint=ckpt, fault_injector=inj,
            group=plan.group)
        return ElasticComponents(guard, model, guard.init_state())
    return factory


def _elastic_trainer(init, directory, io, tag, **kw):
    from apex_tpu_torch.resilience import (ElasticPlan, ElasticTrainer,
                                           TopologySpec)
    tr = ElasticTrainer(_resilience_factory(init),
                        ElasticPlan.build(TopologySpec(), device="cuda"),
                        directory=directory, keep=RESILIENCE_KEEP,
                        save_every=RESILIENCE_SAVE_EVERY, **kw)
    _trace_io(tr.checkpoint, tag, io)
    return tr


def _resilience_elastic(init, batch, root, io):
    """17b: soft preemption and resume, an in-place replan and save_async
    against an uninterrupted ElasticTrainer run."""
    from apex_tpu_torch.resilience import HostSignals, TopologySpec
    batch_fn = lambda step, plan: batch                 # noqa: E731
    ref = _elastic_trainer(init, os.path.join(root, "ref"), io, "[17b] ref")
    t0 = time.perf_counter()
    ref.train(batch_fn, ELASTIC_STEPS)
    ref_s = time.perf_counter() - t0
    want = _clone_all(_train_state(ref.model, ref.guard.optimizer))
    del ref
    _drop_checkpoints(os.path.join(root, "ref"))

    signals = HostSignals()

    def preempting(step, plan):
        if step == ELASTIC_PREEMPT_AT - 1:
            signals.request_preempt()
        return batch
    run = _elastic_trainer(init, os.path.join(root, "run"), io,
                           "[17b] preempted", signals=signals)
    first = run.train(preempting, ELASTIC_STEPS)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    signals = HostSignals()

    def replanning(step, plan):
        if step == ELASTIC_REPLAN_AT - 1:
            signals.request_replan(TopologySpec())
        return batch
    resumed = _elastic_trainer(init, os.path.join(root, "run"), io,
                               "[17b] resumed", signals=signals)
    second = resumed.train(replanning, ELASTIC_STEPS)
    got = _train_state(resumed.model, resumed.guard.optimizer)
    bitwise = _equal_all(got, want)
    log(f"[17b] ElasticTrainer, GPT-350M: uninterrupted {ELASTIC_STEPS} "
        f"steps {ref_s:.1f} s; soft preemption -> {first}; a fresh trainer "
        f"resumed from disk with an in-place replan at step "
        f"{ELASTIC_REPLAN_AT} -> {second} (stats {resumed.stats}); final "
        f"parameters and Adam state bitwise the uninterrupted run's: "
        f"{bitwise}")
    if first["status"] != "preempted" or first["step"] != ELASTIC_PREEMPT_AT:
        raise AssertionError(f"[17b] the soft preemption gave {first}")
    if second["status"] != "completed" or second["replans"] != 1 \
            or resumed.stats["resume_step"] != ELASTIC_REPLAN_AT:
        raise AssertionError(f"[17b] the resumed run gave {second}")
    if not bitwise:
        raise AssertionError("[17b] preempt/resume/replan is not bitwise "
                             "the uninterrupted run")
    # trap 1: an optimizer step right after save_async must not reach it
    snap = _clone_all(got)
    step = resumed.current_step
    resumed.guard.save(step, resumed.model, resumed.guard_state,
                       async_=True)
    resumed.step_once(batch_fn)
    resumed.checkpoint.wait()
    moved = not _equal_all(_train_state(resumed.model,
                                        resumed.guard.optimizer), snap)
    template = resumed.guard._template(resumed.model, resumed.guard_state)
    restored, at = resumed.checkpoint.restore(template, step=step)
    from apex_tpu_torch.resilience.checkpoint import tree_flatten
    tparams = [restored["params"][n] for n, _ in
               resumed.model.named_parameters()]
    tleaves, _ = tree_flatten(restored["opt"])
    async_ok = _equal_all(tparams + tleaves, snap)
    log(f"[17b] save_async at step {step} then a step at once: the live "
        f"state moved {moved}; the checkpoint restores the pre-step state "
        f"bitwise: {async_ok}")
    if not (moved and async_ok and at == step):
        raise AssertionError("[17b] save_async did not snapshot the state "
                             "before the next step")
    del resumed, restored
    torch.cuda.empty_cache()
    return dict(preempted=first, resumed=second, bitwise=bitwise,
                async_bitwise=async_ok, steps=ELASTIC_STEPS + 2 +
                (ELASTIC_STEPS - ELASTIC_PREEMPT_AT) + 1)


def _resilience_zero(init, batch, ckdir, io):
    """17c: DistributedFusedAdam through ZeROGuardAdapter at one rank; a
    checkpoint stamped dp=1 zero=1 restored and re-sharded onto the same
    plan, bit for bit."""
    from apex_tpu_torch.parallel import DistributedFusedAdam
    from apex_tpu_torch.resilience import (CheckpointManager, ElasticPlan,
                                           GuardedTrainStep, TopologySpec,
                                           ZeROGuardAdapter,
                                           reshard_optimizer_state)
    plan = ElasticPlan.build(TopologySpec(zero_shard=1), device="cuda")
    model = build_model("cuda")
    model.load_state_dict(init)
    zopt = DistributedFusedAdam(model.parameters(), lr=LR,
                                process_group=plan.groups["data"])
    mgr = _trace_io(CheckpointManager(ckdir, keep=RESILIENCE_KEEP,
                                      topology=plan.spec), "[17c]", io)
    guard = GuardedTrainStep(grad_fn=_gpt_grad_fn,
                             optimizer=ZeROGuardAdapter(zopt, plan),
                             warmup_steps=GUARD_WARMUP, checkpoint=mgr,
                             plan=plan)
    numels = [p.numel() for p in model.parameters()]
    counters = _train_counters() + (_sumsq_counter(),)
    gstate = guard.init_state()
    _reset(counters)
    with counting_plain_versions() as plain:
        for step in range(2):
            gstate = guard(model, gstate, *batch, step=step).guard_state
        torch.cuda.synchronize()
    launches = _launches_of(counters)
    expected = _gpt_train_expected(2, ACCUM, GPT350M["num_layers"], numels)
    expected.pop("multi_tensor_adam")
    for k, v in zero_launches(zopt, ("multi_tensor_adam",)).items():
        expected[k] = 2 * v
    # the guard's norm: #17 over the reduced gradient's shards
    expected["multi_tensor_sumsq"] = 2 * sumsq_launches(
        [zopt._local_rows(info) * 128 for info in zopt._layout().buckets])
    guard.save(2, model, gstate)
    want = _clone_all(_train_state(model, zopt))
    guard(model, gstate, *batch, step=2)            # moves the live state
    restored, _ = mgr.restore(guard._template(model, gstate),
                              topology=plan.spec)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(restored["params"][name])
    reshard_optimizer_state(restored["opt"], plan, plan, optimizer=zopt)
    bitwise = _equal_all(_train_state(model, zopt), want)
    stamp = mgr.topology_of(2)
    log(f"[17c] ZeRO DistributedFusedAdam ({len(zopt._layout().buckets)} "
        f"bucket(s)) under the guard at 1 rank: launches {launches} "
        f"(expected {expected}); plain-version calls {dict(plain)}; "
        f"checkpoint stamped {stamp}, restored and re-sharded onto the same "
        f"plan bitwise: {bitwise}")
    if launches != expected or sum(plain.values()):
        raise AssertionError("[17c] launch counts do not match the path")
    if stamp != TopologySpec(zero_shard=1).to_dict() or not bitwise:
        raise AssertionError("[17c] the ZeRO checkpoint did not restore "
                             "bitwise")
    return dict(launches=launches, bitwise=bitwise, stamp=stamp)


def _drop_checkpoints(directory):
    """A sub-phase's checkpoints go as soon as it ends (at most two kept
    and one being written, about 13 GB, are on disk at a time), and the
    page-locked host buffers of its managers with them."""
    shutil.rmtree(directory, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


def phase_resilience():
    """Phase 17: the guarded step (17a), elastic training (17b) and ZeRO
    under the guard (17c) on GPT-350M, checkpoints under a temporary
    directory of ``build/`` (removed after), every save and restore traced
    (17d)."""
    from apex_tpu_torch.utils import native
    lib = native.library_path()
    log(f"[17d] native host runtime: {lib}")
    if lib is None:
        raise AssertionError("[17d] the native host library did not load")
    t0 = time.perf_counter()
    model = build_model("cuda").init_params(torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    batch = _phase17_batch()
    pathlib.Path("build").mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="phase17_", dir="build")
    io, parts = [], {"init": time.perf_counter() - t0}
    try:
        t1 = time.perf_counter()
        guard = _resilience_guard(init, batch, os.path.join(root, "guard"),
                                  io)
        _drop_checkpoints(os.path.join(root, "guard"))
        parts["17a"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        elastic = _resilience_elastic(init, batch, os.path.join(root, "el"),
                                      io)
        _drop_checkpoints(os.path.join(root, "el"))
        parts["17b"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        zero = _resilience_zero(init, batch, os.path.join(root, "zero"), io)
        parts["17c"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"[17d] {len(io)} checkpoint operations (save: snapshot to the host "
        f"and write + fsync while a second thread hashes; restore: read, "
        f"then the copies to the card while a second thread hashes):")
    _log_io(io)
    log(f"[17] resilience on GPT-350M: {seconds:.1f} s "
        f"({ {k: round(v, 1) for k, v in parts.items()} } s)")
    launches = collections.Counter(guard["launches"])
    launches.update(zero["launches"])
    return dict(seconds=seconds, parts=parts, guard=guard, elastic=elastic,
                zero=zero, io=io, native=lib, launches=dict(launches))


# -- phase 18: training telemetry and the cost-model loop ---------------------

MONITOR_STEPS = 8              # 18a's monitored steps
MONITOR_NAN_AT = 3             # 18a's planted nan_grads (after the warm-up)
TOKENS_PER_STEP = ACCUM * MICRO * SEQ
# 18c: the autopilot over an ElasticTrainer on real step times; the profile
# is the reference tests' simulated dcn-class psum curve, the drift the
# reference day's 16x
AP_STEPS = 5
AP_DRIFT_AT = 1
AP_ALPHA, AP_BETA, AP_DRIFT = 2e-3, 1e-9, 16.0
AP_KW = dict(link_class="dcn", drift_threshold=0.3, confirm_windows=2,
             min_measurements=8, cooldown_s=0.0, gate_steps=2,
             gate_tolerance=1.2, min_dp=1)


def gpt_flops_per_token(n_params, cfg=GPT350M, seq=SEQ):
    """``bench.py``'s PaLM-style count per token: 6 N (forward and
    backward) plus the attention term 12 L h s."""
    return 6 * n_params + 12 * cfg["num_layers"] * cfg["hidden_size"] * seq


def _smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _same_float(a, b):
    """Equal, or both NaN (a NaN-gradient step's norm)."""
    return a == b or (a != a and b != b)


def _monitored_training(init, batch, smi):
    """18a: phase 17's guarded GPT-350M step wrapped by TrainingMonitor
    (calibrated peak), against the same step unmonitored on a second model
    from the same state, with one planted nan_grads each."""
    import io
    from apex_tpu_torch.observability import MetricsRegistry, TrainingMonitor
    from apex_tpu_torch.observability.train_monitor import _STEP_KEYS
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.resilience import (Fault, FaultInjector,
                                           GuardedTrainStep)

    def guarded():
        model = build_model("cuda")
        model.load_state_dict(init)
        opt = FusedAdam(model.parameters(), lr=LR)
        guard = GuardedTrainStep(
            grad_fn=_gpt_grad_fn, optimizer=opt, warmup_steps=GUARD_WARMUP,
            fault_injector=FaultInjector([Fault(MONITOR_NAN_AT,
                                                "nan_grads")]))
        return model, opt, guard
    model, opt, guard = guarded()
    ref, ref_opt, ref_guard = guarded()
    numels = [p.numel() for p in model.parameters()]
    flops = gpt_flops_per_token(sum(numels))
    stream = io.StringIO()
    reg = MetricsRegistry()
    reg.attach_stream(stream)
    mon = TrainingMonitor(reg, tokens_per_step=TOKENS_PER_STEP,
                          flops_per_token=flops, peak_flops="calibrated")
    t0 = time.perf_counter()
    peak = mon._resolve_peak()
    calibrate_s = time.perf_counter() - t0
    h = {"g": guard.init_state()}

    def step(*batch, step):
        r = guard(model, h["g"], *batch, step=step)
        h["g"] = r.guard_state
        return r
    monitored = mon.wrap(step)
    per_step = _guard_expected(numels, 1)
    counters = _train_counters() + (_sumsq_counter(),)
    gref = ref_guard.init_state()
    mon_dt, ref_dt, host_s, results = [], [], [], []
    with counting_plain_versions() as plain:
        for i in range(MONITOR_STEPS):
            _reset(counters)
            t0 = time.perf_counter()
            res = monitored(*batch, step=i)
            outer = time.perf_counter() - t0
            launches = _launches_of(counters)
            if launches != per_step:
                raise AssertionError(f"[18a] step {i}: launches {launches}, "
                                     f"expected {per_step}")
            dt = reg.get("train_step_time_s_last").value()
            mon_dt.append(dt)
            host_s.append(outer - dt)
            t0 = time.perf_counter()
            rres = ref_guard(ref, gref, *batch, step=i)
            ref_dt.append(time.perf_counter() - t0)
            gref = rres.guard_state
            same = (_equal_all(_train_state(model, opt),
                               _train_state(ref, ref_opt))
                    and _equal_all(list(h["g"]), list(gref))
                    and (res.skipped, res.anomaly, res.next_step)
                    == (rres.skipped, rres.anomaly, rres.next_step)
                    and _same_float(res.grad_norm, rres.grad_norm)
                    and _same_float(res.loss_value, rres.loss_value))
            if not same:
                raise AssertionError(f"[18a] monitored step {i} differs from "
                                     "the unmonitored step")
            results.append((i, res.skipped, res.anomaly))
    if sum(plain.values()):
        raise AssertionError("[18a] a plain version was called")
    records = [json.loads(ln) for ln in stream.getvalue().splitlines()]
    steps = [r for r in records if r.get("event") == "train_step"]
    missing = [sorted(set(_STEP_KEYS) - set(r)) for r in steps
               if not set(_STEP_KEYS) <= set(r)]
    nonfinite = reg.get("train_anomalies_total").value(kind="nonfinite")
    gstats = guard.stats
    tps = [r["tokens_per_s"] for r in steps]
    mfu = [r["mfu"] for r in steps]
    out = dict(peak_flops=peak, calibrate_s=calibrate_s,
               flops_per_token=flops, tokens_per_step=TOKENS_PER_STEP,
               results=results, step_times_s=mon_dt,
               unmonitored_step_times_s=ref_dt, monitor_host_s=host_s,
               tokens_per_s=tps, mfu=mfu,
               median_step_s=statistics.median(mon_dt),
               median_unmonitored_step_s=statistics.median(ref_dt),
               median_tokens_per_s=statistics.median(tps),
               median_mfu=statistics.median(mfu),
               mfu_dense_bf16=[t * flops / PEAK_BF16_FLOPS for t in tps],
               median_monitor_host_s=statistics.median(host_s),
               anomalies_nonfinite=nonfinite, guard_stats=gstats,
               monitor_stats=mon.stats,
               launches={k: v * MONITOR_STEPS for k, v in per_step.items()})
    log(f"[18a] TrainingMonitor around phase 17's GuardedTrainStep "
        f"(GPT-350M, {TOKENS_PER_STEP} tokens a step, {flops:.6e} FLOP a "
        f"token = 6 N + 12 L h s): {MONITOR_STEPS} steps, results {results}; "
        f"each step bit for bit an unmonitored guarded step from the same "
        f"state; launches a step {per_step}; guard stats {gstats}; "
        f"train_anomalies_total{{kind=nonfinite}} {nonfinite}")
    log(f"    calibrated peak (bf16 2048^3 chain of 32, a CUDA graph, the "
        f"rescales' own chain taken off): {peak!r} FLOP/s "
        f"({calibrate_s:.3f} s; {peak / PEAK_BF16_FLOPS!r} of the dense "
        f"bf16 {PEAK_BF16_FLOPS:.3e}) [{smi}]")
    log(f"    tokens/s per step {tps} (median {out['median_tokens_per_s']!r})"
        f" [{smi}]")
    log(f"    MFU per step {mfu} (median {out['median_mfu']!r}); against "
        f"the dense bf16 peak {out['mfu_dense_bf16']} (median "
        f"{statistics.median(out['mfu_dense_bf16'])!r}) [{smi}]")
    log(f"    step s monitored {mon_dt} (median {out['median_step_s']!r}), "
        f"unmonitored {ref_dt} (median "
        f"{out['median_unmonitored_step_s']!r}); the monitor's host time "
        f"a step {host_s} (median {out['median_monitor_host_s']!r}) [{smi}]")
    if missing:
        raise AssertionError(f"[18a] train_step records lack {missing}")
    if len(steps) != MONITOR_STEPS:
        raise AssertionError(f"[18a] {len(steps)} train_step records")
    want = [(i, i == MONITOR_NAN_AT, "nonfinite" if i == MONITOR_NAN_AT
             else None) for i in range(MONITOR_STEPS)]
    if results != want:
        raise AssertionError(f"[18a] step results {results} != {want}")
    if not (nonfinite == 1 == gstats["nonfinite"] == gstats["skipped"]
            == mon.stats["skipped"]):
        raise AssertionError("[18a] the anomaly counter disagrees with the "
                             "guard's stats")
    if not all(np.isfinite(tps)) or not all(0 < m < 1 for m in mfu):
        raise AssertionError(f"[18a] tokens/s {tps} or MFU {mfu} out of "
                             "range")
    return out


class _RecordTicks:
    """A recorder for the autopilot: (event, tick) of each record."""

    def __init__(self):
        self.events = []

    def record(self, source, what, tick=None, **kw):
        self.events.append((what, tick))

    def trigger(self, *args, **kw):
        pass


class FakeTrainer:
    """The reference tests' trainer recipe (``tests/test_autopilot.py``): a
    plan with a spec, the job's ranks (under ``pool``: the port's ranker
    reads ``_ranks``, JAX's ``_devices``), ``replan_to`` (whose first
    ``fail_replans`` calls raise) and the drain and re-shard stats; no
    model."""

    def __init__(self, spec, ranks, pool="_ranks", fail_replans=0):
        from types import SimpleNamespace
        self.plan = SimpleNamespace(spec=spec)
        setattr(self, pool, list(ranks))
        self.stats = {"last_checkpoint_s": 1e-3, "last_reshard_s": 2e-3}
        self.current_step = 0
        self.replans = []
        self.params = {}
        self._fail = fail_replans

    def replan_to(self, spec, **kw):
        from types import SimpleNamespace
        if self._fail > 0:
            self._fail -= 1
            raise RuntimeError("injected reshard failure")
        self.replans.append(spec)
        self.plan = SimpleNamespace(spec=spec)


def ap_profile():
    from apex_tpu_torch.observability.costmodel import (
        fit_cost_model, simulate_link_measurements)
    return fit_cost_model(simulate_link_measurements(
        AP_ALPHA, AP_BETA, link_class="dcn", ops=("psum",)),
        meta={"source": "simulated dcn psum"})


def zero_factory(init):
    """GPT-350M from ``init`` under ZeRO (``DistributedFusedAdam`` over the
    plan's data group through ``ZeROGuardAdapter``), the guard over phase
    5's step: the elastic plan factory of 18c and the autopilot tool."""
    from apex_tpu_torch.parallel import DistributedFusedAdam
    from apex_tpu_torch.resilience import (ElasticComponents,
                                           GuardedTrainStep,
                                           ZeROGuardAdapter)

    def factory(plan, ckpt, inj):
        model = build_model(plan.device)
        model.load_state_dict(init)
        zopt = DistributedFusedAdam(model.parameters(), lr=LR,
                                    process_group=plan.groups["data"])
        guard = GuardedTrainStep(
            grad_fn=_gpt_grad_fn, optimizer=ZeROGuardAdapter(zopt, plan),
            warmup_steps=GUARD_WARMUP, checkpoint=ckpt, fault_injector=inj,
            group=plan.group, plan=plan)
        return ElasticComponents(guard, model, guard.init_state())
    return factory


def _ticks_of(rec, what):
    return [t for w, t in rec.events if w == what]


def _autopilot_on_real_steps(world, init, batch, root):
    """18c: ``ParallelismAutopilot`` over an ``ElasticTrainer`` of GPT-350M
    (ZeRO, dp = the ranks) fed each real step's wall time, a cost_drift at
    ``AP_DRIFT_AT``; then the same autopilot over the reference's
    ``FakeTrainer`` recipe under the same schedule and step times."""
    from apex_tpu_torch.resilience import (ElasticPlan, ElasticTrainer,
                                           Fault, FaultInjector,
                                           ParallelismAutopilot,
                                           TopologySpec)
    spec = TopologySpec(dp=world, zero_shard=world)

    def injector():
        return FaultInjector([Fault(AP_DRIFT_AT, "cost_drift",
                                    magnitude=AP_DRIFT)])
    inj = injector()
    tr = ElasticTrainer(zero_factory(init),
                        ElasticPlan.build(spec, device="cuda"),
                        directory=os.path.join(root, "autopilot"),
                        fault_injector=inj, keep=RESILIENCE_KEEP,
                        save_every=1000)
    rec = _RecordTicks()
    ap = ParallelismAutopilot(tr, ap_profile(), injector=inj, recorder=rec,
                              **AP_KW)
    batch_fn = lambda step, plan: batch                 # noqa: E731
    dts = []
    for _ in range(AP_STEPS):
        t0 = time.perf_counter()
        tr.step_once(batch_fn)
        dt = time.perf_counter() - t0
        ap.record_step(dt)
        dts.append(dt)
        ap.tick()
        ap.tick()
    fake = FakeTrainer(spec, range(world))
    frec = _RecordTicks()
    fap = ParallelismAutopilot(fake, ap_profile(), injector=injector(),
                               recorder=frec, clock=lambda: 0.0,
                               grad_bytes=ap._grad_bytes
                               or sum(p.numel() * p.element_size()
                                      for p in tr.model.parameters()),
                               **AP_KW)
    for step, dt in enumerate(dts):
        fake.current_step = step + 1
        fap.record_step(dt)
        fap.tick()
        fap.tick()
    out = dict(step_times_s=dts, refits=ap.stats["refits"],
               fake_refits=fap.stats["refits"],
               confirm_ticks=_ticks_of(rec, "drift_confirmed"),
               fake_confirm_ticks=_ticks_of(frec, "drift_confirmed"),
               outcomes=[e["outcome"] for e in ap.adoption_log],
               fake_outcomes=[e["outcome"] for e in fap.adoption_log],
               audit=ap.audit(), faults=list(inj.log),
               final=tr.plan.spec.to_dict(), stats={
                   k: v for k, v in ap.stats.items()
                   if k not in ("last_adoption",)})
    del tr
    torch.cuda.empty_cache()
    return out


def _dispatched_names(group, world):
    """The ``c10d`` op names this torch dispatches for the probe's four
    collectives, ``all_to_all_single``, the port's differentiable
    ``all_to_all`` and the compressed (bf16, int8) all-reduce."""
    import torch.distributed as dist
    from apex_tpu_torch.observability import collective_stats
    from apex_tpu_torch.transformer.expert_parallel import all_to_all
    from apex_tpu_torch.utils import compressed_allreduce as CA
    x = torch.ones(world * 128, 128, device="cuda")

    def calls():
        dist.all_reduce(x.clone(), group=group)
        out = torch.empty(world * x.shape[0], 128, device="cuda")
        dist.all_gather_into_tensor(out, x, group=group)
        shard = torch.empty(x.shape[0] // world, 128, device="cuda")
        dist.reduce_scatter_tensor(shard, x, group=group)
        o = torch.empty_like(x)
        dist.all_to_all_single(o, x, group=group)
        all_to_all(x.clone().requires_grad_(), group).sum().backward()
        for mode in ("bf16", "int8"):
            CA.psum_compressed(x, mode=mode, process_group=group)
        if world > 1:
            rank = dist.get_rank(group)
            recv = torch.empty_like(x)
            for r in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (rank + 1) % world,
                               group=group),
                    dist.P2POp(dist.irecv, recv, (rank - 1) % world,
                               group=group)]):
                r.wait()
    st = collective_stats(calls)
    torch.cuda.synchronize()
    return st


def _ddp_step(model, ddp, opt, tokens, targets):
    """One DDP step over the micro-batches: the backward of each but the
    last under ``no_sync``, the last one's reducing every bucket."""
    from apex_tpu_torch.utils.profiling import annotate
    opt.zero_grad()
    m = tokens.shape[0]
    for i in range(m):
        ctx = ddp.no_sync() if i < m - 1 else contextlib.nullcontext()
        with ctx, annotate("ddp_backward"):
            x = model.backbone(model.embed(tokens[i]), None)
            loss = model.head_loss(x, targets[i]).mean()
            loss.backward(torch.full_like(loss, 1.0 / m))
    opt.step()


def _accounting(rank, world, init):
    """18b: ``collective_stats`` of one ZeRO GPT-350M step (phase 14b's
    optimizer and buckets, stepped with an overflow flag) and of one DDP
    step, each against its bucket layout; the weights ``init``."""
    from apex_tpu_torch.observability import collective_stats, format_stats
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import (DistributedDataParallel,
                                         DistributedFusedAdam)
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.utils.profiling import annotate
    rng = np.random.RandomState(0)
    shape = (ACCUM, MICRO, SEQ)
    tokens, targets = (_shard(torch.from_numpy(rng.randint(
        0, GPT350M["vocab_size"], shape)), rank, world).to("cuda")
        for _ in range(2))
    out = {"dispatched": _dispatched_names(ps.get_group("data"), world)}
    model = build_model("cuda")
    model.load_state_dict(init)
    opt = DistributedFusedAdam(model.parameters(), lr=LR,
                               message_size=10_000_000)
    flag = torch.zeros((), dtype=torch.int32, device="cuda")

    def zero_step():
        from apex_tpu_torch.transformer.pipeline_parallel import (
            forward_backward_no_pipelining)
        opt.zero_grad()
        forward_backward_no_pipelining(
            lambda m, x: m.backbone(m.embed(x), None),
            lambda x, t: model.head_loss(x, t).mean(), model, tokens,
            targets)
        with annotate("zero_step"):
            opt.step(noop_flag=flag)
    train_step(model, opt, tokens, targets)           # builds the shards
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = collective_stats(zero_step)
    torch.cuda.synchronize()
    zero_s = time.perf_counter() - t0
    buckets = opt._layout().buckets
    full = [int(info.meta.nrows) * 128 * 4 for info in buckets]
    out["zero"] = dict(stats=st, bucket_bytes=full, seconds=zero_s,
                       table=format_stats(st, by_scope=True))
    del model, opt
    torch.cuda.empty_cache()
    model = build_model("cuda")
    model.load_state_dict(init)
    ddp = DistributedDataParallel(model)
    dopt = FusedAdam(model.parameters(), lr=LR)
    _ddp_step(model, ddp, dopt, tokens, targets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = collective_stats(_ddp_step, model, ddp, dopt, tokens, targets)
    torch.cuda.synchronize()
    ddp_s = time.perf_counter() - t0
    out["ddp"] = dict(stats=st, seconds=ddp_s,
                      bucket_bytes=[int(b.meta.nrows) * 128
                                    * b.params[0].element_size()
                                    for b in ddp._buckets],
                      table=format_stats(st, by_scope=True))
    del model, ddp, dopt
    torch.cuda.empty_cache()
    return out


def _telemetry_rank(rank, world, out_dir):
    """One rank of phase 18b and 18c (a spawned process on card ``rank``):
    NCCL through a ``file://`` store in ``out_dir``; results pickled into
    ``out_dir``."""
    import pickle
    import torch.distributed as dist
    from apex_tpu_torch.transformer import parallel_state as ps
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"file://{pathlib.Path(out_dir).resolve()}/store",
        rank=rank, world_size=world)
    ps.initialize_model_parallel()
    model = build_model("cuda").init_params(torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    t0 = time.perf_counter()
    out = {"accounting": _accounting(rank, world, init)}
    ps.destroy_model_parallel()
    t1 = time.perf_counter()
    out["autopilot"] = _autopilot_on_real_steps(
        world, init, _phase17_batch(), str(out_dir))
    out["seconds"] = {"18b": t1 - t0, "18c": time.perf_counter() - t1}
    with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _check_zero_stats(tag, z, world):
    st, full = z["stats"], z["bucket_bytes"]
    got = {k: [o["bytes"] for o in st[k]["ops"]]
           for k in ("reduce_scatter", "all_gather", "all_reduce")}
    want = {"reduce_scatter": full, "all_gather": full, "all_reduce": [4]}
    scopes = {o["scope"] for k in got for o in st[k]["ops"]}
    groups = {o["group_size"] for k in got for o in st[k]["ops"]}
    log(f"{tag} ZeRO GPT-350M step (phase 14b's DistributedFusedAdam, "
        f"{len(full)} buckets of 10 MB, with the overflow flag): counts "
        f"{ {k: len(v) for k, v in got.items()} }, bytes "
        f"{ {k: sum(v) for k, v in got.items()} } (the layout's "
        f"{sum(full)} per reduce-scatter and all-gather, 4 for the flag), "
        f"scopes {sorted(scopes)}, group sizes {sorted(groups)} "
        f"({z['seconds']:.3f} s)")
    if got != want or st["collective_permute"]["count"] \
            or st["all_to_all"]["count"]:
        raise AssertionError(f"{tag} ZeRO step collectives {got} != the "
                             f"layout's {want}")
    if scopes != {"zero_step"} or groups != {world}:
        raise AssertionError(f"{tag} ZeRO step scopes {scopes} or groups "
                             f"{groups}")


def _check_ddp_stats(tag, d, world):
    st, full = d["stats"], d["bucket_bytes"]
    got = [o["bytes"] for o in st["all_reduce"]["ops"]]
    scopes = {o["scope"] for o in st["all_reduce"]["ops"]}
    log(f"{tag} DDP GPT-350M step ({ACCUM} micro-batches, the last "
        f"reducing): {len(got)} all-reduces of {sum(got)} bytes (the "
        f"layout: {len(full)} buckets, {sum(full)} bytes), scopes "
        f"{sorted(scopes)} ({d['seconds']:.3f} s)")
    if sorted(got) != sorted(full) or st["total"]["count"] != len(full):
        raise AssertionError(f"{tag} DDP all-reduces {got} != the layout's "
                             f"{full}")
    if scopes != {"ddp_backward"}:
        raise AssertionError(f"{tag} DDP scopes {scopes}")


def phase_telemetry(smi):
    """Phase 18: (18a) the monitored guarded GPT-350M step in this
    process; (18b) collective accounting and (18c) the autopilot on real
    step times on ``torch.cuda.device_count()`` NCCL ranks (spawned
    processes)."""
    import pickle
    import torch.multiprocessing as mp
    from apex_tpu_torch.observability.comms import _C10D_OPS
    t0 = time.perf_counter()
    model = build_model("cuda").init_params(torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    monitor = _monitored_training(init, _phase17_batch(), smi)
    del init
    gc.collect()
    torch.cuda.empty_cache()
    parts = {"18a": time.perf_counter() - t0}
    t1 = time.perf_counter()
    world = torch.cuda.device_count()
    out_dir = pathlib.Path("build") / "phase18"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    try:
        mp.start_processes(_telemetry_rank, args=(world, str(out_dir)),
                           nprocs=world, start_method="spawn", join=True)
        ranks = []
        for r in range(world):
            with open(out_dir / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
    finally:
        for sub in out_dir.iterdir():
            if sub.is_dir():
                shutil.rmtree(sub, ignore_errors=True)
    parts["18b+18c"] = time.perf_counter() - t1
    parts.update({k: v for k, v in ranks[0]["seconds"].items()})
    for r, rank in enumerate(ranks):
        tag = f"[18b] rank {r} of {world}:"
        acc = rank["accounting"]
        seen = acc["dispatched"]["dispatched"]
        log(f"{tag} c10d ops this torch dispatches for all_reduce, "
            f"all_gather_into_tensor, reduce_scatter_tensor, "
            f"all_to_all_single, the port's all_to_all, the compressed "
            f"all-reduce (bf16, int8)"
            f"{' and a batch_isend_irecv ring' if world > 1 else ''}: "
            f"{seen}")
        unknown = sorted(set(seen) - set(_C10D_OPS))
        if unknown:
            raise AssertionError(f"{tag} c10d ops without a kind: {unknown}")
        if world == 1:
            log(f"{tag} at one rank the ZeRO buckets still reduce-scatter "
                "and all-gather over a group of one rank (c10d dispatches "
                "them), so the expected counts are the layout's")
        _check_zero_stats(tag, acc["zero"], world)
        _check_ddp_stats(tag, acc["ddp"], world)
        a = rank["autopilot"]
        log(f"[18c] rank {r}: ParallelismAutopilot over ElasticTrainer "
            f"(GPT-350M, ZeRO dp {world}) on real step times "
            f"{a['step_times_s']} s, cost_drift x{AP_DRIFT} at step "
            f"{AP_DRIFT_AT}: refits {a['refits']} (FakeTrainer recipe "
            f"{a['fake_refits']}), drift confirmed at ticks "
            f"{a['confirm_ticks']} (FakeTrainer {a['fake_confirm_ticks']}), "
            f"outcomes {a['outcomes']} (FakeTrainer {a['fake_outcomes']}), "
            f"audit {a['audit']}, faults {a['faults']}, final plan "
            f"{a['final']}")
        if (a["refits"], a["confirm_ticks"]) != (a["fake_refits"],
                                                 a["fake_confirm_ticks"]) \
                or not a["confirm_ticks"] or a["audit"] != []:
            raise AssertionError("[18c] the autopilot on real step times "
                                 "departs from the FakeTrainer recipe's run")
        if world == 1 and (a["outcomes"] != ["no_change"]
                           or a["fake_outcomes"] != ["no_change"]):
            raise AssertionError(f"[18c] at one rank the outcome must be "
                                 f"no_change, got {a['outcomes']}")
    seconds = time.perf_counter() - t0
    log(f"[18] telemetry and the cost-model loop: {seconds:.1f} s "
        f"({ {k: round(v, 1) for k, v in parts.items()} } s)")
    return dict(seconds=seconds, parts=parts, world=world, monitor=monitor,
                ranks=ranks, launches=monitor["launches"])


# -- phase 19: the cross-pod MPMD pipeline ----------------------------------

MPMD_M = 4                     # micro-batches a step: 4 x (4 x 1024) tokens
MPMD_STEPS = {"19a": 3, "19b": 2}
# The planted faults of phase 19's gate readings, each in the MPMD engine's
# own code (the one-process reference runs neither)
MPMD_FAULTS = ("drop_head_grad", "mb_order")
# Phase 19's gates on step 0 against one process on the same weights and
# micro-batches (``_mpmd_gaps``: the loss's relative gap; for the layers,
# the final LayerNorm and the tied embedding (both replicas) the largest
# |difference| over the reference's largest entry), set from
# ``tools/mpmd_torch.py --gates`` on the card, correct against faulted, the
# same at pp 2 and pp 4: correct loss, layers and final LayerNorm 0 (the
# same kernels in the same order), the embedding 2.94e-8 (one pullback over
# the 16,384 tokens against the reference's four of 4096: another sum
# order); drop_head_grad the embedding 0.466; mb_order the layers 1.81e-7,
# the final LayerNorm 1.09e-7 (its loss 0: the four losses summed last
# first round alike here).  So bit for bit but the embedding, held at 1e-6.
MPMD_GATES = {"loss": 0.0, "layers": 0.0, "final_layernorm": 0.0,
              "embedding": 1e-6}


def _plant_mpmd(faults):
    """Plant ``faults`` in the MPMD engine (for the gate readings):
    ``drop_head_grad``: the first stage's embedding gradient leaves out the
    tied head's (the sync's merge dropped); ``mb_order``: every stage
    accumulates its micro-batches' gradients and losses last first (the
    engine runs all forwards, then the backwards from micro-batch M - 1
    down)."""
    from unittest import mock
    from apex_tpu_torch.mpmd import engine as mpmd_engine
    from apex_tpu_torch.mpmd.schedule import Op
    from apex_tpu_torch.mpmd.stage import StageProgram
    stack = contextlib.ExitStack()
    for fault in faults:
        if fault not in MPMD_FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
    if "drop_head_grad" in faults:
        real = StageProgram.run_embed_bwd

        def dropped(self, dx0, head_eg):
            return real(self, dx0, [torch.zeros_like(g) for g in head_eg])
        stack.enter_context(mock.patch.object(StageProgram, "run_embed_bwd",
                                              dropped))
    if "mb_order" in faults:
        real_init = mpmd_engine.MpmdPipeline.__init__

        def init(self, *args, **kw):
            real_init(self, *args, **kw)
            S, M = self.n_stages, self.M
            self.order = ([Op(s, "fwd", m) for m in range(M)
                           for s in range(S)]
                          + [Op(s, "bwd", m) for m in reversed(range(M))
                             for s in reversed(range(S))])
        stack.enter_context(mock.patch.object(mpmd_engine.MpmdPipeline,
                                              "__init__", init))
    return stack


def _mpmd_reference(init, tokens, targets):
    """The port's one-process GPT-350M on the same weights and
    micro-batches: ``forward_backward_no_pipelining`` over
    ``GPTModel.loss``; its loss and every gradient."""
    from apex_tpu_torch.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)
    model = build_model(tokens.device)
    model.load_state_dict(init)
    loss = forward_backward_no_pipelining(
        lambda m, x: x, lambda x, t: model.loss(x, t), model, tokens,
        targets)
    return float(loss), {n: p.grad for n, p in model.named_parameters()}


def _mpmd_gaps(loss, grads, eng, ref_loss, ref_grads):
    """Step 0 of the engine against the reference: the loss's relative gap,
    and for the layers, the final LayerNorm and the tied embedding (both
    replicas) the largest |difference| over the reference's largest
    entry."""
    from apex_tpu_torch.models.gpt import pipeline_layer_ids
    gaps = {"loss": abs(loss - ref_loss) / abs(ref_loss)}
    for i, g in enumerate(grads):
        ids = pipeline_layer_ids(GPT350M["num_layers"], eng.n_stages, 1, i)
        for name, t in g.items():
            key = name.split(".")[0]
            ref = name
            if key == "layers":
                j, rest = name[len("layers."):].split(".", 1)
                ref = f"layers.{ids[int(j)]}.{rest}"
            ref = ref_grads[ref]
            gap = float((t.to(ref.device, torch.float32) - ref.float()).abs()
                        .max() / ref.float().abs().max())
            gaps[key] = max(gaps.get(key, 0.0), gap)
    return gaps


def _step_anatomy_tool():
    """``tools/step_anatomy_torch.py`` (its ``predicted_from_measured``)."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parent / "tools" / \
        "step_anatomy_torch.py"
    spec = importlib.util.spec_from_file_location("step_anatomy_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _mpmd_anatomy(eng):
    """The newest traced step's measured timeline: the attribution (each
    stage's five categories sum to the makespan), its diff against
    ``simulate`` at the measured median op times, the channel's seconds."""
    from apex_tpu_torch.observability import anatomy
    tl = anatomy.reconstruct(eng.anatomy_events())
    attr = anatomy.attribute(tl)
    sums = [abs(st["total"] - attr["makespan"]) / attr["makespan"]
            for st in attr["per_stage"]]
    predicted = _step_anatomy_tool().predicted_from_measured(tl)
    diff = anatomy.diff_timelines(tl, predicted, fold_last_fwd=True)
    xfer = collections.defaultdict(float)
    for x in tl.xfers:
        xfer["sync" if x["mb"] < 0 else str(x["kind"])] += (
            x["end"] - x["start"])
    return dict(makespan_s=tl.makespan, busy_s=tl.busy,
                attribution={k: attr[k] for k in ("totals", "fractions")},
                sum_error=max(sums), drift_score=diff["drift_score"],
                median_ratio=diff["median_ratio"],
                unpredicted_bubble=diff["unpredicted_bubble_fraction"],
                predicted=predicted["priced_with"],
                predicted_makespan_s=predicted["makespan"],
                xfer_s=dict(xfer),
                table=anatomy.render_attribution_table(attr),
                diff=anatomy.render_diff(diff))


def _mpmd_run(init, batch, ref, *, pp, n_pods, schedule, steps,
              devices=None, trace=False, measure_ops=False,
              dcn_fault_at=None, keep=False):
    """``steps`` steps of GPT-350M through ``MpmdPipeline`` (stage ``i`` on
    ``devices[i]``, default every stage on the card): step 0 as
    ``loss_and_grads`` + each stage's ``apply_grads`` (its gaps to the
    reference ``ref`` read in between), the others ``train_step``.  Losses,
    step times, tokens/s, peak memory, launches, plain-version calls, the
    replicas' equality after every step, the channel's ledger, the flow
    chains and (``measure_ops``) the newest step's anatomy."""
    from apex_tpu_torch.mpmd import MpmdPipeline
    from apex_tpu_torch.parallel.plan import ParallelPlan
    from apex_tpu_torch.resilience.faults import Fault, FaultInjector
    tokens, targets = (t.reshape(-1, SEQ) for t in batch)
    inj = (FaultInjector([Fault(dcn_fault_at, "dcn_fault")])
           if dcn_fault_at is not None else None)
    cards = (sorted({torch.device(d).index or 0 for d in devices})
             if devices else [0])
    for c in cards:
        torch.cuda.synchronize(c)
        torch.cuda.reset_peak_memory_stats(c)
    eng = MpmdPipeline(
        dict(GPT350M, dtype=torch.bfloat16), init,
        ParallelPlan(pp=pp, n_pods=n_pods, n_microbatches=MPMD_M),
        device=None if devices else "cuda", devices=devices, lr=LR,
        fault_injector=inj, schedule=schedule, trace=trace,
        measure_ops=measure_ops)
    counters = _mp_counters()
    _reset(counters)
    losses, times, replicas, gaps = [], [], [], None
    with counting_plain_versions() as plain:
        for step in range(steps):
            t0 = time.perf_counter()
            if step == 0:
                loss, grads = eng.loss_and_grads(tokens, targets)
                for st, g in zip(eng.stages, grads):
                    st.apply_grads(g)
                eng.step_count += 1
            else:
                loss = eng.train_step(tokens, targets)
            for c in cards:
                torch.cuda.synchronize(c)
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
            if step == 0:
                gaps = _mpmd_gaps(losses[0], grads, eng, *ref)
                del grads
            first, last = (eng.stages[k].state["embedding.weight"]
                           for k in (0, -1))
            replicas.append(torch.equal(first, last.to(first.device)))
    launches = _launches_of(counters)
    expected = collections.Counter()
    for st in eng.stages:
        expected.update(_gpt_train_expected(
            steps, MPMD_M, len(st.model.layers),
            [p.numel() for p in st.state.values()], last=st.is_last,
            rows=tokens.shape[0] // MPMD_M * SEQ))
    step_s = statistics.median(times[1:] or times)
    run = dict(losses=losses, step_times_s=times, median_step_s=step_s,
               tokens_per_s=tokens.numel() / step_s,
               peak_memory_bytes=[torch.cuda.max_memory_allocated(c)
                                  for c in cards],
               launches=launches, expected=dict(expected),
               plain_calls=dict(plain), gaps=gaps, replicas_equal=replicas,
               retries=eng.channel.retries, sends=eng.channel.sends,
               bytes_sent=eng.channel.bytes_sent, steps=steps,
               measured=measure_ops,
               stage_adam_tensors=[len(st.state) for st in eng.stages])
    if eng.tracers is not None:
        cont = eng.collector().continuity()
        run["continuity"] = dict(broken=len(cont["broken"]),
                                 orphans=len(cont["orphans"]),
                                 complete=len(cont["complete"]))
        run["anatomy"] = _mpmd_anatomy(eng)
    if keep:
        run["engine"] = eng
    return run


def gate_mpmd(tag, gaps):
    """Hold step 0's gaps to ``MPMD_GATES``."""
    over = {k: v for k, v in gaps.items() if not v <= MPMD_GATES[k]}
    if over:
        raise AssertionError(f"{tag}: step 0 leaves the one-process "
                             f"reference by {over} (gates {MPMD_GATES})")


def check_mpmd(tag, run, retries):
    """Exact launches, no plain version, finite losses, the replicas equal
    after every step, ``retries`` retried sends, unbroken flow chains (M +
    1 complete a step) and step 0 within its gates."""
    _check_run(tag, run)
    if not all(run["replicas_equal"]):
        raise AssertionError(f"{tag}: the tied-embedding replicas differ "
                             f"after steps {run['replicas_equal']}")
    if run["retries"] != retries:
        raise AssertionError(f"{tag}: {run['retries']} retried sends, "
                             f"want {retries}")
    cont = run.get("continuity")
    if cont is not None and (cont["broken"] or cont["orphans"] or
                             cont["complete"] != run["steps"] * (MPMD_M + 1)):
        raise AssertionError(f"{tag}: flow chains {cont}")
    anat = run.get("anatomy")
    if anat is not None and not anat["sum_error"] <= 1e-9:
        raise AssertionError(f"{tag}: the attribution misses a stage's "
                             f"makespan by {anat['sum_error']} (relative)")
    gate_mpmd(tag, run["gaps"])


def _stage_tensors(st):
    """A stage's checkpointed tensors: its state's parameters, then its
    optimizer's state leaves (live references)."""
    from apex_tpu_torch.resilience.checkpoint import tree_flatten
    tree = st.checkpoint_state()
    return list(tree["state"].values()) + tree_flatten(tree["opt"])[0]


def _mpmd_checkpoint(eng, batch, root):
    """19c: ``save_checkpoint``, a step, ``restore_stage(0)`` (the other
    stages keep their moved state), ``restore_checkpoint``: each restored
    stage's parameters and optimizer state bit for bit the saved ones, the
    restored step the saved step."""
    tokens, targets = (t.reshape(-1, SEQ) for t in batch)
    shutil.rmtree(root, ignore_errors=True)
    step = eng.step_count
    try:
        with counting_plain_versions() as plain:
            t0 = time.perf_counter()
            eng.save_checkpoint(str(root), step)
            t_save = time.perf_counter() - t0
            saved = [_clone_all(_stage_tensors(st)) for st in eng.stages]
            eng.train_step(tokens, targets)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got0 = eng.restore_stage(0, str(root))
            t_stage = time.perf_counter() - t0
            first_back = _equal_all(_stage_tensors(eng.stages[0]), saved[0])
            others_moved = not any(
                _equal_all(_stage_tensors(st), want)
                for st, want in zip(eng.stages[1:], saved[1:]))
            t0 = time.perf_counter()
            got = eng.restore_checkpoint(str(root))
            t_all = time.perf_counter() - t0
            all_back = all(_equal_all(_stage_tensors(st), want)
                           for st, want in zip(eng.stages, saved))
        nbytes = sum(t.numel() * t.element_size()
                     for st in eng.stages for t in _stage_tensors(st))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = dict(step=step, restored_stage_step=got0, restored_step=got,
               step_count=eng.step_count, first_back=first_back,
               others_moved=others_moved, all_back=all_back,
               save_s=t_save, restore_stage_s=t_stage, restore_all_s=t_all,
               bytes=nbytes, plain_calls=dict(plain))
    log(f"[19c] save_checkpoint of {len(eng.stages)} stage trees "
        f"({nbytes / 1e9:.3f} GB) {t_save:.3f} s, restore_stage(0) "
        f"{t_stage:.3f} s, restore_checkpoint {t_all:.3f} s: stage 0 back "
        f"bit for bit {first_back}, the other stages kept their step "
        f"{others_moved}, all back {all_back}, restored step "
        f"{got0} / {got} (saved at {step}), step_count {eng.step_count}")
    if not (first_back and others_moved and all_back and got0 == step
            and got == step and eng.step_count == step) or plain:
        raise AssertionError(f"[19c] the restore departs from the saved "
                             f"state: {out}")
    return out


def log_mpmd(tag, run, what):
    peak = ", ".join(f"{b / 2 ** 30:.3f}" for b in run["peak_memory_bytes"])
    log(f"{tag} {what}: losses {[round(x, 5) for x in run['losses']]}; "
        f"step times (s) {[round(t, 4) for t in run['step_times_s']]}, "
        f"median of steps 2-{run['steps']} {run['median_step_s']:.4f} s, "
        f"{run['tokens_per_s']:.1f} tokens/s; peak memory {peak} GiB; "
        f"channel {run['sends']} sends, {run['bytes_sent'] / 1e6:.1f} MB "
        f"({run['bytes_sent'] / run['steps'] / 1e6:.1f} MB a step), "
        f"{run['retries']} retried; replicas equal after each step "
        f"{run['replicas_equal']}; flow chains {run.get('continuity')}")
    log(f"    step 0 against one process: {run['gaps']} (gates "
        f"{MPMD_GATES})")
    anat = run.get("anatomy")
    if anat is not None:
        spans = ("each op's span ends with a sync of its card"
                 if run["measured"] else "host spans: a transfer's includes "
                 "waiting for the kernels that produce its payload")
        log(f"    the last step's timeline ({spans}): makespan "
            f"{anat['makespan_s']:.4f} s, channel "
            f"{ {k: round(v, 4) for k, v in anat['xfer_s'].items()} } s, "
            f"predicted at the measured medians {anat['predicted']} -> "
            f"{anat['predicted_makespan_s']:.4f} s, attribution sums within "
            f"{anat['sum_error']:.2e}")
        log("    " + anat["table"].replace("\n", "\n    "))
        log("    " + anat["diff"].replace("\n", "\n    "))


def phase_mpmd(smi):
    """Phase 19: (19a) GPT-350M at phase 5's recipe through ``MpmdPipeline``
    at dp 1, pp 2, 2 pods, M 4, ``dcn_hiding``, traced, one scheduled
    ``dcn_fault``, 3 steps; (19c) its checkpoints; (19b) pp 4, 2 pods,
    ``1f1b``, ``measure_ops``, 2 steps, the step's anatomy."""
    t0 = time.perf_counter()
    model = build_model("cuda").init_params(torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    batch = _gpt350m_batch(n_micro=MPMD_M)
    ref = _mpmd_reference(init, *batch)
    torch.cuda.empty_cache()
    a = _mpmd_run(init, batch, ref, pp=2, n_pods=2, schedule="dcn_hiding",
                  steps=MPMD_STEPS["19a"], trace=True, dcn_fault_at=0,
                  keep=True)
    log_mpmd("[19a]", a, "GPT-350M through MpmdPipeline (dp 1, pp 2, 2 "
             "pods, M 4 x 4096 tokens, dcn_hiding, traced, a dcn_fault at "
             "step 0)")
    check_mpmd("[19a]", a, retries=1)
    ckpt = _mpmd_checkpoint(a.pop("engine"), batch,
                            pathlib.Path("build") / "phase19_ckpt")
    gc.collect()
    torch.cuda.empty_cache()
    b = _mpmd_run(init, batch, ref, pp=4, n_pods=2, schedule="1f1b",
                  steps=MPMD_STEPS["19b"], measure_ops=True)
    log_mpmd("[19b]", b, "GPT-350M through MpmdPipeline (dp 1, pp 4, 2 "
             "pods, M 4, 1f1b, measure_ops)")
    check_mpmd("[19b]", b, retries=0)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    launches = collections.Counter(a["launches"])
    launches.update(b["launches"])
    log(f"[19] the MPMD pipeline: {seconds:.1f} s on {smi}")
    return dict(seconds=seconds, a=a, b=b, checkpoint=ckpt,
                launches=dict(launches))


# -- phase 20 ----------------------------------------------------------------

# Conformer-M (Gulati et al. 2020, "Conformer", Table 1): encoder width 256,
# 4 heads, 16 layers, a 640-wide decoder; the recipe's stem and conv kernel
# of 5 (the reference has no other); 8 utterances of 800 frames (200 after
# the stem), 40 target tokens, 128 tokens + blank
CONFORMER_M_ARGV = ["--hidden", "256", "--heads", "4", "--layers", "16",
                    "--pred-hidden", "640", "--batch-size", "8",
                    "--audio-len", "800", "--target-len", "40",
                    "--vocab", "128", "--steps", "3", "--print-freq", "3",
                    "--seed", "0"]
CONFORMER_LAYERS = 16
CONFORMER_STEPS = 1 + 3         # the example's warm-up step, then 3
CONFORMER_SHAPE = (8, 4, 200, 64)   # 20a's attention: b, heads, s, head dim
# 20b: 2 layers at Conformer-M's encoder widths (hidden 256, 4 heads), a
# 256-wide LSTM (Conformer-M's is 640), 2 utterances of 200 frames
CONFORMER_PARITY_ARGV = ["--hidden", "256", "--heads", "4", "--layers", "2",
                         "--pred-hidden", "256", "--batch-size", "2",
                         "--audio-len", "200", "--target-len", "10",
                         "--vocab", "128", "--seed", "1"]
CONFORMER_FAULTS = ("lstm_gate", "lattice_end")
# 20b's gates, card vs CPU (f32 both), between the correct and the planted-
# fault readings that 20b takes on every run; at the first card run (PERF.md)
# correct 7.4e-8 / 1.8e-6 / 7.5e-9, the nearest fault (lstm_gate) 2.3e-5 /
# 5.0e-2 / 1.6e-6
CONFORMER_GATES = {"loss": 1e-6, "grads": 1e-4, "params": 1e-7}


@contextlib.contextmanager
def _plant_conformer(fault):
    """A fault in the port's conformer path: ``lstm_gate`` swaps the LSTM's
    i and f gates, ``lattice_end`` reads the lattice at ``y_len - 1``."""
    import apex_tpu_torch.contrib.transducer as ttr
    import apex_tpu_torch.RNN as trnn
    saved = (trnn._LSTM._cell, ttr._lattice_end)

    def swapped_cell(self, p, x_t, state):
        h, c = state
        f, i, gc, o = (p["i2h"](x_t) + p["h2h"](h)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gc)
        return torch.sigmoid(o) * torch.tanh(c), c

    def early_end(alphas, blank, f_len, y_len):
        return saved[1](alphas, blank, f_len, y_len - 1)
    if fault == "lstm_gate":
        trnn._LSTM._cell = swapped_cell
    elif fault == "lattice_end":
        ttr._lattice_end = early_end
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        trnn._LSTM._cell, ttr._lattice_end = saved


def phase_conformer_train(smi, tag="[20a]"):
    """The ported conformer RNN-T example's ``main()`` at Conformer-M width:
    losses, step times, utt/s and peak memory; exact launches of #1-#5,
    #17 and #23 per step and no plain version called."""
    from apex_tpu_torch.examples.conformer import train_rnnt
    counters = _all_counters()
    _reset(counters)
    torch.cuda.synchronize()
    with counting_plain_versions() as plain_calls:
        res = train_rnnt.main(CONFORMER_M_ARGV)
    torch.cuda.synchronize()
    launches = _launches_of(counters)
    trainer = res.pop("trainer")
    res.pop("batch")
    numels = [p.numel() for p in trainer.model.parameters()]
    n, steps = CONFORMER_LAYERS, CONFORMER_STEPS
    expected = {"layer_norm_fwd": 4 * n * steps,
                "layer_norm_bwd": 4 * n * steps, "flash_fwd": n * steps,
                "flash_attention_dq": n * steps,
                "flash_attention_dkv": n * steps,
                "multi_tensor_sumsq": steps * sumsq_launches(numels,
                                                             per_tensor=True),
                "multi_tensor_novograd": steps * table_launches(numels)}
    step_s = statistics.median(res["step_times_s"])
    utt = 8 / step_s
    log(f"{tag} Conformer-M RNN-T (examples/conformer/train_rnnt: hidden "
        f"256, 4 heads, 16 layers, LSTM 640, {sum(numels):,} parameters in "
        f"{len(numels)} tensors; 8 x 800 frames, 40 targets, vocab 128, "
        f"f32, FusedNovoGrad lr 1e-3) on {smi}: warm-up loss "
        f"{res['warmup_loss']:.5f}, losses "
        f"{[round(x, 5) for x in res['losses']]}; step times (s) "
        f"{[round(t, 4) for t in res['step_times_s']]}, median "
        f"{step_s:.4f} s, {utt:.1f} utt/s (main's "
        f"{res['utterances_per_s']:.1f}); peak memory above the recipe's "
        f"start {res['peak_memory_bytes'] / 2 ** 30:.3f} GiB")
    run = dict(launches=launches, expected=expected,
               plain_calls=dict(plain_calls),
               losses=[res["warmup_loss"]] + res["losses"])
    _check_run(tag, run)
    del trainer
    res.update(median_step_s=step_s, utt_per_s_median=utt,
               launches=launches, parameters=sum(numels),
               tensors=len(numels))
    return res


def _conformer_two_steps(device, init, batches, fault=None):
    """20b's model on ``device`` from the state dict ``init``, 2 steps of
    FusedNovoGrad on ``batches``: losses, step 0's gradients and the
    parameters after each step, on the CPU."""
    from apex_tpu_torch.examples.conformer import train_rnnt
    from apex_tpu_torch.optimizers import FusedNovoGrad
    args = train_rnnt.parse_args(CONFORMER_PARITY_ARGV)
    model = train_rnnt.ConformerRNNT(args, device)
    model.load_state_dict(init)
    opt = FusedNovoGrad(model.parameters(), lr=args.lr)
    losses, grads, params = [], None, []
    with _plant_conformer(fault):
        for step, batch in enumerate(batches):
            opt.zero_grad()
            loss = model.loss(*(t.to(device) for t in batch))
            loss.backward()
            if step == 0:
                grads = {n: p.grad.detach().cpu().clone()
                         for n, p in model.named_parameters()}
            opt.step()
            losses.append(float(loss.detach()))
            params.append({n: p.detach().cpu().clone()
                           for n, p in model.named_parameters()})
    return losses, grads, params


def conformer_parity_gaps(faults=CONFORMER_FAULTS):
    """20b's readings: the small conformer 2 steps on the card (correct,
    then with each planted fault) against one CPU run with the same
    weights and batches.  Gaps: the losses' largest relative difference,
    step 0's gradients' largest |diff| over each tensor's largest entry,
    the parameters' largest |diff| after either step."""
    from apex_tpu_torch.examples.conformer import train_rnnt
    args = train_rnnt.parse_args(CONFORMER_PARITY_ARGV)
    init = {k: v.cpu() for k, v in train_rnnt.ConformerRNNT(
        args, "cpu").init_params(torch.Generator().manual_seed(1))
        .state_dict().items()}
    make = train_rnnt.batches(args, "cpu")
    batches = [make(), make()]
    ref = _conformer_two_steps("cpu", init, batches)
    out = {}
    for fault in (None,) + tuple(faults):
        losses, grads, params = _conformer_two_steps("cuda", init, batches,
                                                     fault)
        out[fault or "correct"] = dict(
            losses=losses, loss=_gap(losses, ref[0]),
            grads=max(float((grads[n] - ref[1][n]).abs().max()
                            / ref[1][n].abs().max()) for n in grads),
            params=max(float((p[n] - r[n]).abs().max())
                       for p, r in zip(params, ref[2]) for n in r))
    out["cpu_losses"] = ref[0]
    return out


def phase_conformer_parity(tag="[20b]"):
    """20b: the card's losses, gradients and parameters within
    ``CONFORMER_GATES`` of the CPU's, and each planted fault outside
    every gate."""
    gaps = conformer_parity_gaps()
    for name in ("correct",) + CONFORMER_FAULTS:
        g = gaps[name]
        log(f"{tag} conformer card vs CPU (2 layers, hidden 256, 4 heads, "
            f"2 steps, f32), {name}: losses {g['losses']} (CPU "
            f"{gaps['cpu_losses']}); loss {g['loss']:.3e}, grads "
            f"{g['grads']:.3e}, params {g['params']:.3e} (gates "
            f"{CONFORMER_GATES})")
    if not all(gaps["correct"][k] <= v for k, v in CONFORMER_GATES.items()):
        raise AssertionError(f"{tag} card and CPU conformer steps disagree")
    for fault in CONFORMER_FAULTS:
        if not all(gaps[fault][k] > v for k, v in CONFORMER_GATES.items()):
            raise AssertionError(f"{tag} planted fault {fault} passes a "
                                 "gate")
    return gaps


def _f32_flash_bound(shape, n_products, n_io):
    """f32 operands: n_io (b, h, s, d) tensors read or written once plus
    the row statistics; n_products products of head_dim per (query, key)
    pair at the f32 peak."""
    b, h, s, d = shape
    return bound_ms(n_io * b * h * s * d * 4 + 2 * b * h * s * 4,
                    2 * n_products * d * b * h * s * s, PEAK_F32_FLOPS)


def kernel_flash_conformer(gen, tag="[20]"):
    """#3-#5 at the conformer's attention, (8, 4, 200, 64) f32 non-causal,
    as its MHA gives them (strided views of one (s, b, 3H) projection),
    four input sets in turn: against the plain versions, the plain
    versions' time, SDPA on the same f32 operands and the bound."""
    from apex_tpu_torch.ops.flash_attention import (
        flash_attention_dkv, flash_attention_dkv_reference,
        flash_attention_dq, flash_attention_dq_reference, flash_fwd,
        flash_fwd_reference)
    b, h, s, d = CONFORMER_SHAPE
    scale = d ** -0.5
    sets = []
    for _ in range(4):
        qkv = torch.randn(s, b, 3 * h * d, generator=gen).to("cuda")
        q, k, v = (t.reshape(s, b, h, d).permute(1, 2, 0, 3)
                   for t in qkv.chunk(3, dim=-1))
        do = torch.randn(s, b, h, d, generator=gen).to("cuda").permute(
            1, 2, 0, 3)
        sets.append((q, k, v, do))
    q, k, v, do = sets[0]
    o, lse = flash_fwd(q, k, v, False, scale)
    ro, rlse = flash_fwd_reference(q, k, v, False, scale)
    name = f"{CONFORMER_SHAPE} f32 non-causal"
    err = max(check_close(f"flash_fwd {name}", o, ro, F32_ATOL, F32_RTOL),
              check_close(f"flash_fwd {name} lse", lse, rlse, F32_ATOL,
                          F32_RTOL))
    out = {"fwd": numbers(
        err, time_ms([lambda st=st: flash_fwd(*st[:3], False, scale)
                      for st in sets] * 5),
        time_ms(lambda: flash_fwd_reference(q, k, v, False, scale), 3),
        time_ms([lambda st=st: F.scaled_dot_product_attention(
            *st[:3], scale=scale) for st in sets] * 5),
        _f32_flash_bound(CONFORMER_SHAPE, 2, 4),
        call_ms(lambda: flash_fwd(q, k, v, False, scale)))}
    bwd_args = []
    for q, k, v, do in sets:
        o, lse = flash_fwd(q, k, v, False, scale)
        delta = (do * o).sum(-1).reshape(b * h, s)
        bwd_args.append((q, k, v, do, lse, delta, False, scale))
    args = bwd_args[0]
    err_q = check_close(f"flash_attention_dq {name}", flash_attention_dq(
        *args), flash_attention_dq_reference(*args), F32_ATOL, F32_RTOL)
    dk, dv = flash_attention_dkv(*args)
    rdk, rdv = flash_attention_dkv_reference(*args)
    err_kv = max(check_close(f"flash_attention_dkv {name} dk", dk, rdk,
                             F32_ATOL, F32_RTOL),
                 check_close(f"flash_attention_dkv {name} dv", dv, rdv,
                             F32_ATOL, F32_RTOL))
    lib_bwd = _flash_bwd_library_ms(sets, False, scale)
    out["dq"] = numbers(
        err_q, time_ms([lambda a=a: flash_attention_dq(*a)
                        for a in bwd_args] * 5),
        time_ms(lambda: flash_attention_dq_reference(*args), 3), lib_bwd,
        _f32_flash_bound(CONFORMER_SHAPE, 3, 5),
        call_ms(lambda: flash_attention_dq(*args)))
    out["dkv"] = numbers(
        err_kv, time_ms([lambda a=a: flash_attention_dkv(*a)
                         for a in bwd_args] * 5),
        time_ms(lambda: flash_attention_dkv_reference(*args), 3), lib_bwd,
        _f32_flash_bound(CONFORMER_SHAPE, 4, 6),
        call_ms(lambda: flash_attention_dkv(*args)))
    for key, lib in (("fwd", "sdpa f32"), ("dq", "sdpa f32 backward "
                                                  "(dq+dk+dv)"),
                     ("dkv", "sdpa f32 backward (dq+dk+dv)")):
        log_numbers(f"{tag} flash {key} {name}", out[key], lib)
    return out


def kernel_ln_novograd_conformer(gen, gen_cuda, tag="[20]"):
    """#1 and #2 at the conformer's LayerNorms (the (8 * 200, 256) f32 rows
    of 20a's (B, T', H) activations) and #17 and #23 over Conformer-M's
    parameter list as its FusedNovoGrad steps it (per-tensor sums; lr 1e-3,
    betas 0.95 / 0.98, no weight decay, at step 3), each against its plain
    version at phase 2's f32 tolerances: times, plain times, library calls
    and bounds."""
    from apex_tpu_torch.examples.conformer import train_rnnt
    from apex_tpu_torch.ops import multi_tensor as K
    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd,
                                               layer_norm_bwd_reference,
                                               layer_norm_fwd,
                                               layer_norm_fwd_reference)
    b, _, s, _ = CONFORMER_SHAPE
    rows, hid = b * s, 256
    w = (1 + 0.1 * torch.randn(hid, generator=gen)).to("cuda")
    bias = (0.1 * torch.randn(hid, generator=gen)).to("cuda")
    x = torch.randn(rows, hid, generator=gen).to("cuda")
    dy = torch.randn(rows, hid, generator=gen).to("cuda")
    name = f"{rows}x{hid} f32 (the conformer's LayerNorms)"
    y, mean, rstd = layer_norm_fwd(x, w, bias, 1e-5, False)
    ry, rmean, rrstd = layer_norm_fwd_reference(x, w, bias, 1e-5, False)
    torch.cuda.synchronize()
    err = check_close(f"layer_norm_fwd {name} y", y, ry,
                      *LN_Y_TOL[torch.float32])
    check_close(f"layer_norm_fwd {name} mean", mean, rmean, 1e-5, 1e-5)
    check_close(f"layer_norm_fwd {name} rstd", rstd, rrstd, 1e-5, 1e-4)
    out = {"ln_fwd": numbers(
        err, time_ms(lambda: layer_norm_fwd(x, w, bias, 1e-5, False)),
        time_ms(lambda: layer_norm_fwd_reference(x, w, bias, 1e-5, False)),
        time_ms(lambda: F.layer_norm(x, (hid,), w, bias, 1e-5)),
        bound_ms(2 * rows * hid * 4 + 2 * hid * 4 + 2 * rows * 4,
                 8 * rows * hid, PEAK_F32_FLOPS),
        call_ms(lambda: layer_norm_fwd(x, w, bias, 1e-5, False)))}
    log_numbers(f"{tag} layer_norm_fwd {name}", out["ln_fwd"],
                "F.layer_norm f32")
    got = layer_norm_bwd(dy, x, w, bias, mean, rstd, False, False)
    ref = layer_norm_bwd_reference(dy, x, w, bias, mean, rstd, False, False)
    torch.cuda.synchronize()
    err = _ln_bwd_check(f"layer_norm_bwd {name}", got, ref, torch.float32,
                        False)
    _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [hid], w, bias,
                                                       1e-5)
    out["ln_bwd"] = numbers(
        err, time_ms(lambda: layer_norm_bwd(dy, x, w, bias, mean, rstd,
                                            False, False)),
        time_ms(lambda: layer_norm_bwd_reference(dy, x, w, bias, mean, rstd,
                                                 False, False)),
        time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [hid], lmean, lrstd, w, bias, [True, True, True])),
        bound_ms(3 * rows * hid * 4 + 4 * hid * 4 + 2 * rows * 4,
                 12 * rows * hid, PEAK_F32_FLOPS),
        call_ms(lambda: layer_norm_bwd(dy, x, w, bias, mean, rstd, False,
                                       False)))
    log_numbers(f"{tag} layer_norm_bwd {name}", out["ln_bwd"],
                "aten native_layer_norm_backward f32")

    model = train_rnnt.ConformerRNNT(train_rnnt.parse_args(CONFORMER_M_ARGV),
                                     "cuda")
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model
    numels = [int(np.prod(sh)) for sh in shapes]
    n_el = sum(numels)

    def rand(shape, std, positive=False):
        t = torch.randn(shape, generator=gen_cuda, device="cuda") * std
        return t.abs() + 1e-3 if positive else t
    gs = [rand(sh, 1e-3) for sh in shapes]
    ps = [rand(sh, 0.02) for sh in shapes]
    ms = [rand(sh, 1e-4) for sh in shapes]
    v = rand(len(shapes), 1e-6, positive=True)
    none = [None] * len(shapes)
    noop0 = torch.tensor(0, dtype=torch.int32, device="cuda")
    lst = f"Conformer-M's {len(shapes)} f32 tensors, {n_el} elements"
    total, per, _ = K.multi_tensor_sumsq(gs, per_tensor=True)
    rtotal, rper, _ = K.multi_tensor_sumsq_reference(gs, per_tensor=True)
    torch.cuda.synchronize()
    err = check_close(f"multi_tensor_sumsq {lst} total", total, rtotal, 0,
                      1e-5)
    check_close(f"multi_tensor_sumsq {lst} per tensor", per, rper, 0, 1e-5)
    before = K.multi_tensor_sumsq.launches
    K.multi_tensor_sumsq(gs, per_tensor=True)
    n_launch = K.multi_tensor_sumsq.launches - before
    if n_launch != sumsq_launches(numels, per_tensor=True):
        raise AssertionError(f"multi_tensor_sumsq {lst}: {n_launch} "
                             "launches")
    out["sumsq"] = numbers(
        err, time_ms([lambda: K.multi_tensor_sumsq(gs, per_tensor=True)]
                     * 5),
        time_ms([lambda: K.multi_tensor_sumsq_reference(
            gs, per_tensor=True)] * 2, rounds=3),
        time_ms([lambda: torch._foreach_norm(gs)] * 5),
        bound_ms(4 * n_el + 4 * len(shapes), 2 * n_el, PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_sumsq(gs, per_tensor=True), iters=10))
    log_numbers(f"{tag} multi_tensor_sumsq per tensor, {lst}, {n_launch} "
                "launches", out["sumsq"], "torch._foreach_norm")
    t = 3
    nv_scal = torch.tensor([1e-3 * (1 - 0.98 ** t) ** 0.5 / (1 - 0.95 ** t),
                            0.95, 0.0, 1e-8, 1.0, 0.05], device="cuda")
    err = _opt_kernel_check(
        f"multi_tensor_novograd {lst}", K.multi_tensor_novograd,
        K.multi_tensor_novograd_reference,
        lambda f, p, st, c, n: f(gs, p, st, c, v, nv_scal, n, False),
        ps, ms, none, numels)
    out["novograd"] = numbers(
        err, time_ms([lambda: K.multi_tensor_novograd(
            gs, ps, ms, none, v, nv_scal, noop0, False)] * 5),
        time_ms([lambda: K.multi_tensor_novograd_reference(
            gs, ps, ms, none, v, nv_scal, noop0, False)] * 2, rounds=3),
        None, bound_ms(5 * 4 * n_el + 4 * len(shapes), 10 * n_el,
                       PEAK_F32_FLOPS),
        call_ms(lambda: K.multi_tensor_novograd(gs, ps, ms, none, v, nv_scal,
                                                noop0, False), iters=10))
    log_numbers(f"{tag} multi_tensor_novograd {lst}, "
                f"{table_launches(numels)} launches", out["novograd"],
                "no single library call")
    for key in ("sumsq", "novograd"):
        out[key]["tensors"], out[key]["elements"] = len(shapes), n_el
    return out


def _rel_gap(got, want):
    """Largest |got - want| over the largest |want|."""
    got, want = got.detach().float().cpu(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _contrib_cases(rng):
    """20c's cases: (name, inputs (CPU tensors), run(device, inputs) ->
    {output or gradient name: tensor}, relative tolerance, expected
    launches).  Each run makes its module from seeded weights."""
    from apex_tpu_torch.contrib.conv_bias_relu import (
        ConvBias, ConvBiasMaskReLU, ConvBiasReLU, ConvFrozenScaleBiasReLU)
    from apex_tpu_torch.contrib.fmha import fmha
    from apex_tpu_torch.contrib.focal_loss import focal_loss
    from apex_tpu_torch.contrib.group_norm import GroupNorm
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
    from apex_tpu_torch.contrib.index_mul_2d import index_mul_2d
    from apex_tpu_torch.contrib.layer_norm import FastLayerNorm
    from apex_tpu_torch.contrib.multihead_attn import EncdecMultiheadAttn
    from apex_tpu_torch.contrib.openfold_triton import (FusedAdamSWA,
                                                        attention_core)
    from apex_tpu_torch.contrib.transducer import transducer_joint

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(
            np.float32))

    def grads(out, dy, named):
        out.backward(dy.to(out.device, out.dtype))
        return {n: v.grad for n, v in named.items()}

    def leaves(device, **kw):
        # copies: a CPU run must not touch the shared inputs
        return {n: v.detach().to(device, copy=True).requires_grad_()
                for n, v in kw.items()}

    def encdec(dropout):
        def run(dev, inp):
            m = EncdecMultiheadAttn(256, 4, dropout=dropout, bias=True,
                                    device=dev).init_params(
                torch.Generator().manual_seed(5))
            x = leaves(dev, q=inp["q"], mem=inp["mem"])
            y = m(x["q"], x["mem"], kv_seqlens=inp["lens"].to(dev),
                  dropout_seed=11 if dropout else None)
            return dict(y=y, **grads(y, inp["dy"], dict(
                x, **dict(m.named_parameters()))))
        return run
    mha_in = dict(q=t(200, 8, 256), mem=t(300, 8, 256), dy=t(200, 8, 256),
                  lens=torch.tensor([300, 211, 77, 300, 5, 256, 128, 299]))
    lens = [384, 211, 77, 500, 5, 256, 128, 512]
    cu = torch.tensor(np.cumsum([0] + lens), dtype=torch.int32)

    def packed(causal):
        def run(dev, inp):
            x = leaves(dev, qkv=inp["qkv"].bfloat16())
            y = fmha(x["qkv"], inp["cu"].to(dev), 512, causal=causal)
            return dict(y=y, **grads(y, inp["dy"], x))
        return run
    fmha_in = dict(qkv=t(sum(lens), 3, 16, 64), cu=cu,
                   dy=t(sum(lens), 16, 64))

    def core(bias):
        def run(dev, inp):
            x = leaves(dev, q=inp["q"], k=inp["k"], v=inp["v"])
            y = attention_core(x["q"], x["k"], x["v"],
                               mask=inp["mask"].to(dev) if bias else None,
                               bias=inp["bias"].to(dev) if bias else None)
            return dict(y=y, **grads(y, inp["dy"], x))
        return run
    mask = torch.ones(1, 32, 1, 1, 256)
    mask[..., 200:] = 0
    core_in = dict(q=t(1, 32, 8, 256, 32), k=t(1, 32, 8, 256, 32),
                   v=t(1, 32, 8, 256, 32), dy=t(1, 32, 8, 256, 32),
                   bias=t(1, 1, 8, 256, 256), mask=mask)

    def fast_ln(dev, inp):
        m = FastLayerNorm(1024, device=dev)
        with torch.no_grad():
            m.weight.copy_(inp["w"])
            m.bias.copy_(inp["b"])
        x = leaves(dev, x=inp["x"])
        y = m(x["x"])
        return dict(y=y, **grads(y, inp["dy"], dict(
            x, **dict(m.named_parameters()))))

    swa_shapes = [(256, 256), (256,), (1024, 256), (256, 1024), (128, 3),
                  (7,), (4096, 64), (64,)] * 3

    def swa(dev, inp):
        ps = [torch.nn.Parameter(p.to(dev, copy=True)) for p in inp["p"]]
        opt = FusedAdamSWA(ps, lr=1e-3, swa_start=0, swa_freq=1,
                           weight_decay=0.01)
        for gs in inp["g"]:
            for p, g in zip(ps, gs):
                p.grad = g.to(dev)
            opt.step()
        out = {f"p{i}": p.detach() for i, p in enumerate(ps)}
        out.update({f"swa{i}": s for i, s in enumerate(opt.swa_params())})
        return out
    swa_in = dict(p=[t(*s) for s in swa_shapes],
                  g=[[t(*s, scale=0.1) for s in swa_shapes]
                     for _ in range(2)])

    def gn(dev, inp):
        m = GroupNorm(32, 256, act="silu", device=dev)
        x = leaves(dev, x=inp["x"])
        y = m(x["x"])
        return dict(y=y, **grads(y, inp["dy"], dict(
            x, **dict(m.named_parameters()))))

    def bn(dev, inp):
        m = BatchNorm2d_NHWC(256, device=dev)
        x = leaves(dev, x=inp["x"], z=inp["z"])
        y = m(x["x"], x["z"])
        return dict(y=y, running_mean=m.running_mean,
                    running_var=m.running_var, **grads(y, inp["dy"], dict(
                        x, **dict(m.named_parameters()))))
    nhwc = dict(x=t(8, 56, 56, 256), z=t(8, 56, 56, 256),
                dy=t(8, 56, 56, 256))

    def conv(fn):
        def run(dev, inp):
            x = leaves(dev, x=inp["x"], w=inp["w"], b=inp["b"])
            extra = {ConvBiasMaskReLU: [inp["mask"].to(dev)],
                     ConvFrozenScaleBiasReLU: [inp["scale"].to(dev)]}
            args = [x["x"], x["w"]]
            if fn is ConvFrozenScaleBiasReLU:
                args += extra[fn]
            args.append(x["b"])
            if fn is ConvBiasMaskReLU:
                args += extra[fn]
            y = fn(*args, padding=1, stride=1)
            return dict(y=y, **grads(y, inp["dy"], x))
        return run
    conv_in = dict(x=t(8, 56, 56, 64), w=t(3, 3, 64, 64, scale=0.05),
                   b=t(64, scale=0.1), scale=t(64, scale=0.1) + 1.0,
                   mask=torch.from_numpy((rng.rand(8, 56, 56, 64) > 0.1)
                                         .astype(np.float32)),
                   dy=t(8, 56, 56, 64))

    def focal(dev, inp):
        x = leaves(dev, x=inp["x"])
        loss = focal_loss(x["x"], inp["t"].to(dev), inp["npos"], 90, 0.25,
                          2.0, 0.1)
        return dict(loss=loss, **grads(loss, torch.ones(()), x))
    targets = rng.randint(-2, 90, (2, 76725))
    focal_in = dict(x=t(2, 76725, 91), t=torch.from_numpy(targets),
                    npos=float((targets >= 0).sum()))

    def index_mul(dev, inp):
        x = leaves(dev, a=inp["a"], b=inp["b"])
        y = index_mul_2d(x["a"], x["b"], inp["idx"].to(dev))
        return dict(y=y, **grads(y, inp["dy"], x))
    idx_in = dict(a=t(65536, 64), b=t(262144, 64), dy=t(262144, 64),
                  idx=torch.from_numpy(rng.randint(0, 65536, 262144)))

    def joint(dev, inp):
        x = leaves(dev, f=inp["f"], g=inp["g"])
        y = transducer_joint(x["f"], x["g"], inp["f_len"].to(dev),
                             inp["g_len"].to(dev), pack_output=True,
                             relu=True, batch_offsets=inp["off"].to(dev),
                             packed_batch=inp["total"])
        return dict(y=y, **grads(y, inp["dy"], x))
    f_len = rng.randint(100, 201, 8)
    g_len = rng.randint(21, 42, 8)
    sizes = f_len * g_len
    joint_in = dict(f=t(8, 200, 256), g=t(8, 41, 256),
                    f_len=torch.from_numpy(f_len),
                    g_len=torch.from_numpy(g_len),
                    off=torch.from_numpy(np.cumsum([0] + list(sizes[:-1]))),
                    total=int(sizes.sum()), dy=t(int(sizes.sum()), 256))
    fl = {"flash_fwd": 1, "flash_attention_dq": 1, "flash_attention_dkv": 1}
    return [
        ("EncdecMultiheadAttn (200 x 8 x 256 queries, 300 keys, kv_seqlens)",
         mha_in, encdec(0.0), 1e-4, fl),
        ("EncdecMultiheadAttn, dropout 0.1, seed 11", mha_in, encdec(0.1),
         1e-4, fl),
        ("fmha (8 ragged sequences, max 512, 16 heads x 64, bf16)", fmha_in,
         packed(False), 2e-2, fl),
        ("fmha causal", fmha_in, packed(True), 2e-2, fl),
        ("attention_core flash (32 x 8 heads x 256 x 32)", core_in,
         core(False), 1e-4, fl),
        ("attention_core pair bias + mask", core_in, core(True), 1e-4, {}),
        ("FastLayerNorm (4096 x 1024)",
         dict(x=t(4096, 1024), dy=t(4096, 1024), w=t(1024, scale=0.1) + 1,
              b=t(1024, scale=0.1)), fast_ln, 1e-4,
         {"layer_norm_fwd": 1, "layer_norm_bwd": 1}),
        (f"FusedAdamSWA (2 steps, {len(swa_shapes)} tensors)", swa_in, swa,
         1e-5, {"multi_tensor_adam": 2 * table_launches(
             [int(np.prod(s)) for s in swa_shapes])}),
        ("GroupNorm (8 x 56 x 56 x 256, 32 groups, silu)", nhwc, gn, 1e-4,
         {}),
        ("BatchNorm2d_NHWC (8 x 56 x 56 x 256, residual)", nhwc, bn, 1e-4,
         {}),
        *[(f"{fn.__name__} (8 x 56 x 56 x 64, 3 x 3)", conv_in, conv(fn),
           1e-4, {}) for fn in (ConvBias, ConvBiasReLU, ConvBiasMaskReLU,
                                ConvFrozenScaleBiasReLU)],
        ("focal_loss (2 x 76725 anchors x 91 classes)", focal_in, focal,
         1e-4, {}),
        ("index_mul_2d (65536 x 64 rows, 262144 indices)", idx_in,
         index_mul, 1e-5, {}),
        ("TransducerJoint packed (8 x 200 x 41 x 256, ragged)", joint_in,
         joint, 1e-5, {})]


def phase_contrib_ops(tag="[20c]"):
    """20c: each contrib op once on the card against its CPU run on the
    same inputs (every output and gradient within the case's relative
    tolerance of its largest CPU entry); the card runs' launches exact and
    no plain version called in them."""
    counters = _all_counters()
    total = collections.Counter()
    flags = _matmul_flags()
    _set_matmul_flags((False, False, False))     # f32 convolutions in f32
    out = {}
    try:
        for name, inp, run, tol, expected in _contrib_cases(
                np.random.RandomState(20)):
            _reset(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counting_plain_versions() as plain_calls:
                card = run("cuda", inp)
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = _launches_of(counters)
            cpu = run("cpu", inp)
            gaps = {k: _rel_gap(card[k], cpu[k]) for k in cpu}
            worst = max(gaps, key=gaps.get)
            log(f"{tag} {name}: worst {worst} {gaps[worst]:.3e} of its "
                f"largest entry (tolerance {tol}); card {dt:.4f} s; launches "
                f"{launches} (expected {expected})")
            _check_run(f"{tag} {name}", dict(
                launches=launches, expected=expected,
                plain_calls=dict(plain_calls)))
            if gaps[worst] > tol:
                raise AssertionError(f"{tag} {name}: card and CPU disagree")
            total.update(launches)
            out[name] = dict(gaps=gaps, card_s=dt, launches=launches)
    finally:
        _set_matmul_flags(flags)
    return out, dict(total)


def phase_conformer(smi):
    """Phase 20: the conformer RNN-T recipe at Conformer-M width (20a),
    card-vs-CPU parity of a small one with planted faults (20b), the contrib
    ops on the card (20c); #3-#5 at the conformer's attention shape, #1 and
    #2 at its LayerNorms' and #17 and #23 over its parameter list."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(20)
    flash = kernel_flash_conformer(gen)
    torch.cuda.empty_cache()
    ln_opt = kernel_ln_novograd_conformer(
        gen, torch.Generator(device="cuda").manual_seed(20))
    torch.cuda.empty_cache()
    train = phase_conformer_train(smi)
    torch.cuda.empty_cache()
    parity = phase_conformer_parity()
    torch.cuda.empty_cache()
    contrib, contrib_launches = phase_contrib_ops()
    torch.cuda.empty_cache()
    launches = collections.Counter(train["launches"])
    launches.update(contrib_launches)
    seconds = time.perf_counter() - t0
    log(f"[20] the conformer RNN-T and the contrib ops: {seconds:.1f} s on "
        f"{smi}")
    return dict(seconds=seconds, flash=flash, ln_novograd=ln_opt,
                train=train, parity=parity, contrib=contrib,
                launches=dict(launches))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write all results to this JSON file")
    ap.add_argument("--profile", metavar="PATH",
                    help="also profile one prefill, one decode step and one "
                         "step of each training path, each with and without "
                         "the fused FFN and under remat, one ResNet-50 step "
                         "at O1 and O2, "
                         "one paged decode step with f32 and with int8 "
                         "weights and one int8 prefill, and write the "
                         "kernel breakdown to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import apex_tpu_torch  # noqa: F401  (fails outside a checkout)

    flags_at_start = _matmul_flags()
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} on {kind}")
    phase_build()

    gen = torch.Generator().manual_seed(0)
    log("[2] kernels against their plain versions on the card")
    ln = kernel_layer_norm(gen)
    ln_bwd = kernel_layer_norm_bwd(gen)
    fl = kernel_flash(gen)
    fl_bwd = kernel_flash_bwd(gen)
    fl_tp = kernel_flash_shards(gen)
    dec = kernel_decode(gen)
    dec_paged = kernel_decode_paged(gen)
    torch.cuda.empty_cache()
    qgemm = kernel_quant_gemm(torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.empty_cache()
    adam = kernel_adam(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.empty_cache()
    mt = kernel_multi_tensor_lamb(torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.empty_cache()
    lmh = kernel_lm_head(gen)
    torch.cuda.empty_cache()
    ffn = kernel_fused_ffn(gen)
    torch.cuda.empty_cache()
    ffn_tp = kernel_fused_ffn(gen, FFN_TP_CASES)
    torch.cuda.empty_cache()
    opts = kernel_optimizers(torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.empty_cache()
    packed = kernel_packed_segments(
        torch.Generator(device="cuda").manual_seed(4))
    torch.cuda.empty_cache()

    model = build_model("cuda").init_params(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    serve = phase_serve(model, rng)
    parity = phase_parity(model, rng)
    profile_lines, profiled = [], {}
    if args.profile:
        profiled.update(phase_profile_serving(model, rng, profile_lines))
    # the same weights with fused_ffn=True: the same requests (seed 0)
    fmodel = build_model("cuda", fused_ffn=True)
    fmodel.load_state_dict(model.state_dict())
    del model
    serve_f = phase_serve(fmodel, np.random.RandomState(0), tag="[3f]")
    parity_f = phase_parity(fmodel, rng, tag="[4f]")
    if args.profile:
        profiled.update(phase_profile_serving(fmodel, rng, profile_lines,
                                              "_ffn"))
    del fmodel
    torch.cuda.empty_cache()

    tmodel, topt, ttokens, ttargets, train = phase_train()
    if args.profile:
        profiled.update(phase_profile_train(tmodel, topt, ttokens, ttargets,
                                            profile_lines))
    del tmodel, topt
    torch.cuda.empty_cache()
    tmodel, topt, ttokens, ttargets, train_f = phase_train(True, "[5f]")
    if args.profile:
        profiled.update(phase_profile_train(tmodel, topt, ttokens, ttargets,
                                            profile_lines, "train_step_ffn"))
    log_fused_change("[5f] GPT-350M", train, train_f)
    del tmodel, topt
    torch.cuda.empty_cache()
    log_remat_support()
    train_remat = {}
    for policy in REMAT_POLICIES:
        tmodel, topt, ttokens, ttargets, train_remat[policy] = phase_train(
            tag="[5r]", remat_policy=policy)
        if args.profile:
            profiled.update(phase_profile_train(
                tmodel, topt, ttokens, ttargets, profile_lines,
                f"train_step_remat_{policy}"))
        del tmodel, topt
        torch.cuda.empty_cache()
    remat_gpt = check_remat("[5r]", train, train_remat)
    train_parity = phase_train_parity()
    train_parity_f32_head = phase_train_parity(fused_lm_head=False)
    train_parity_ffn = phase_train_parity(fused_ffn=True)
    train_parity_remat = {policy: phase_train_parity(
        remat_policy=policy, tag="[6r]") for policy in REMAT_POLICIES}
    torch.cuda.empty_cache()

    bmodel, bopt, btokens, blabels, bert = phase_bert_train()
    clip = phase_unscale_clip(bmodel)
    if args.profile:
        profiled.update(phase_profile_bert(bmodel, bopt, btokens, blabels,
                                           profile_lines))
    del bmodel, bopt
    torch.cuda.empty_cache()
    bmodel, bopt, btokens, blabels, bert_f = phase_bert_train(True, "[7f]")
    if args.profile:
        profiled.update(phase_profile_bert(bmodel, bopt, btokens, blabels,
                                           profile_lines,
                                           "bert_train_step_ffn"))
    log_fused_change("[7f] BERT-large O2", bert, bert_f)
    del bmodel, bopt
    torch.cuda.empty_cache()
    # bench.py builds BERT-large with remat_policy="dots" when it remats
    bmodel, bopt, btokens, blabels, bert_r = phase_bert_train(
        tag="[7r]", remat_policy="dots")
    if args.profile:
        profiled.update(phase_profile_bert(bmodel, bopt, btokens, blabels,
                                           profile_lines,
                                           "bert_train_step_remat_dots"))
    del bmodel, bopt
    torch.cuda.empty_cache()
    remat_bert = check_remat("[7r]", bert, {"dots": bert_r})
    bert_parity = phase_bert_parity()
    bert_parity_ffn = phase_bert_parity(fused_ffn=True)
    skip = phase_dynamic_skip()
    torch.cuda.empty_cache()
    new_ops = phase_new_ops()
    torch.cuda.empty_cache()

    resnet = {}
    for level, tag in (("O1", "[9]"), ("O2", "[9b]")):
        trainer, batch, resnet[level] = phase_resnet(level, tag)
        if args.profile:
            profiled.update(_profile_programs(
                {f"resnet50_{level}_step": lambda: trainer.step(*batch)},
                profile_lines))
        if level == "O1":
            del trainer, batch
            torch.cuda.empty_cache()
    resnet_opts = phase_resnet_optimizers(trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    resnet_baseline = phase_resnet_baseline()
    torch.cuda.empty_cache()
    resnet_parity = phase_resnet_parity(flags_at_start)
    torch.cuda.empty_cache()

    # phase 3's weights again (seed 0), for the paged and int8 serving tier
    model = build_model("cuda").init_params(torch.Generator().manual_seed(0))
    qmodel, paged = phase_paged(model, np.random.RandomState(1))
    if args.profile:
        profiled.update(phase_profile_paged(model, qmodel, profile_lines))
    torch.cuda.empty_cache()
    smi = _smi()
    # the serving fleet on the same weights
    fleet, fleet_runs = phase_fleet(model, qmodel, paged, smi)
    del model, qmodel
    torch.cuda.empty_cache()
    # data parallelism over NCCL, against phases 5, 7 and 9
    dp = phase_data_parallel(train, bert, resnet["O1"])
    torch.cuda.empty_cache()
    # tensor and sequence parallelism over NCCL, against one process
    tp = phase_tensor_parallel(single=dict(
        gpt=train["peak_memory_bytes"], gpt_overlap=train["peak_memory_bytes"],
        bert=bert["peak_memory_bytes"]))
    torch.cuda.empty_cache()
    # expert, pipeline and context parallelism over NCCL
    mp = phase_model_parallel()
    torch.cuda.empty_cache()
    # resilience: the guarded step, elastic training, ZeRO checkpoints
    resilience = phase_resilience()
    torch.cuda.empty_cache()
    # training telemetry, collective accounting and the autopilot
    telemetry = phase_telemetry(smi)
    torch.cuda.empty_cache()
    # the cross-pod MPMD pipeline
    mpmd = phase_mpmd(smi)
    torch.cuda.empty_cache()
    # the conformer RNN-T recipe and the contrib ops
    conformer = phase_conformer(smi)
    if args.profile:
        with open(args.profile, "w") as f:
            f.write("\n".join(profile_lines) + "\n")

    both = collections.Counter(serve["launches"])
    for launches in fleet_runs:
        both.update(launches)
    for rank in dp["ranks"] + tp["ranks"]:
        for run in rank.values():
            both.update(run["launches"])
    for rank in mp["ranks"]:
        for run in rank.values():
            if isinstance(run, dict) and "launches" in run:
                both.update(run["launches"])
    both.update(resilience["launches"])
    both.update(telemetry["launches"])
    both.update(mpmd["launches"])
    both.update(conformer["launches"])
    for run in (serve_f, train, train_f, *train_remat.values(), bert,
                bert_f, bert_r, clip, resnet["O1"],
                resnet["O2"], resnet_baseline, *resnet_opts.values(),
                paged["contiguous"], paged["paged"], paged["chunked"],
                paged["pressure"], paged["int8_weights"]["contiguous"],
                paged["int8_weights"]["paged"], paged["int8_kv"]):
        both.update(run["launches"])
    sources = {
        "layer_norm_fwd": ("apex_tpu_torch/csrc/layer_norm_fwd.cu",
                           "apex_tpu/ops/layer_norm.py:91", ln[TRAIN_ROWS]),
        "layer_norm_bwd": ("apex_tpu_torch/csrc/layer_norm_bwd.cu",
                           "apex_tpu/ops/layer_norm.py:102", ln_bwd),
        "flash_fwd": ("apex_tpu_torch/csrc/flash_fwd.cu",
                      "apex_tpu/ops/flash_attention.py:139",
                      fl["train_dropout_0.0"]),
        "flash_attention_dq": ("apex_tpu_torch/csrc/flash_bwd_dq.cu",
                               "apex_tpu/ops/flash_attention.py:238",
                               fl_bwd["dq"]),
        "flash_attention_dkv": ("apex_tpu_torch/csrc/flash_bwd_dkv.cu",
                                "apex_tpu/ops/flash_attention.py:282",
                                fl_bwd["dkv"]),
        "flash_attention_decode": ("apex_tpu_torch/csrc/flash_decode.cu",
                                   "apex_tpu/ops/flash_attention.py:586",
                                   dec),
        "multi_tensor_adam": ("apex_tpu_torch/csrc/multi_tensor_adam.cu",
                              "apex_tpu/ops/multi_tensor.py:214", adam),
        "multi_tensor_scale_": ("apex_tpu_torch/csrc/multi_tensor_scale.cu",
                                "apex_tpu/ops/multi_tensor.py:99",
                                mt["scale"]),
        "multi_tensor_sumsq": ("apex_tpu_torch/csrc/multi_tensor_l2norm.cu",
                               "apex_tpu/ops/multi_tensor.py:161",
                               mt["sumsq"]),
        "multi_tensor_lamb_stage1": ("apex_tpu_torch/csrc/multi_tensor_lamb.cu",
                                     "apex_tpu/ops/multi_tensor.py:352",
                                     mt["stage1"]),
        "multi_tensor_lamb_stage2": ("apex_tpu_torch/csrc/multi_tensor_lamb.cu",
                                     "apex_tpu/ops/multi_tensor.py:404",
                                     mt["stage2"]),
        "lm_head_fwd": ("apex_tpu_torch/csrc/lm_head_fwd.cu",
                        "apex_tpu/ops/lm_head.py:70", lmh["fwd_gpt"]),
        "lm_head_dx": ("apex_tpu_torch/csrc/lm_head_bwd.cu",
                       "apex_tpu/ops/lm_head.py:129", lmh["dx_gpt"]),
        "lm_head_dw": ("apex_tpu_torch/csrc/lm_head_bwd.cu",
                       "apex_tpu/ops/lm_head.py:157", lmh["dw_gpt"]),
        "ffn_fwd": ("apex_tpu_torch/csrc/ffn_fwd.cu",
                    "apex_tpu/ops/fused_ffn.py:110", ffn["fwd_gpt"]),
        "ffn_dx": ("apex_tpu_torch/csrc/ffn_bwd.cu",
                   "apex_tpu/ops/fused_ffn.py:137", ffn["dx_gpt"]),
        "ffn_dw": ("apex_tpu_torch/csrc/ffn_bwd.cu",
                   "apex_tpu/ops/fused_ffn.py:162", ffn["dw_gpt"]),
        "multi_tensor_axpby_": ("apex_tpu_torch/csrc/multi_tensor_axpby.cu",
                                "apex_tpu/ops/multi_tensor.py:131",
                                opts["axpby"]),
        "multi_tensor_sgd": ("apex_tpu_torch/csrc/multi_tensor_sgd.cu",
                             "apex_tpu/ops/multi_tensor.py:281", opts["sgd"]),
        "multi_tensor_adagrad": ("apex_tpu_torch/csrc/multi_tensor_adagrad.cu",
                                 "apex_tpu/ops/multi_tensor.py:446",
                                 opts["adagrad"]),
        "multi_tensor_novograd": (
            "apex_tpu_torch/csrc/multi_tensor_novograd.cu",
            "apex_tpu/ops/multi_tensor.py:499", opts["novograd"]),
        "flash_attention_decode_paged": (
            "apex_tpu_torch/csrc/flash_decode_paged.cu",
            "apex_tpu/ops/flash_attention.py:728", dec_paged),
        # one whole GPT-350M decode step's 97 dequant-GEMMs
        "quant_gemm": ("apex_tpu_torch/csrc/quant_gemm.cu",
                       "apex_tpu/ops/quant_gemm.py:112", qgemm["decode"])}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=both[name], **{k: nums[k] for k in keys})
               for name, (src, rep, nums) in sources.items()]
    if any(k["launches"] == 0 for k in kernels):
        raise AssertionError("a kernel of the paths was never launched")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=kind, nvidia_smi=smi, layer_norm=ln,
                           layer_norm_bwd=ln_bwd, flash=fl, flash_bwd=fl_bwd,
                           decode=dec, decode_paged=dec_paged,
                           quant_gemm=qgemm, paged_serving=paged,
                           fleet=fleet,
                           adam=adam, multi_tensor=mt,
                           lm_head=lmh, fused_ffn=ffn, optimizers=opts,
                           serve=serve,
                           parity=parity, serve_ffn=serve_f,
                           parity_ffn=parity_f, train=train,
                           train_ffn=train_f, train_remat=remat_gpt,
                           train_parity=train_parity,
                           train_parity_f32_head=train_parity_f32_head,
                           train_parity_ffn=train_parity_ffn,
                           train_parity_remat=train_parity_remat, bert=bert,
                           bert_ffn=bert_f, bert_remat=remat_bert,
                           new_ops=new_ops, unscale_clip=clip,
                           bert_parity=bert_parity,
                           bert_parity_ffn=bert_parity_ffn,
                           dynamic_skip=skip, resnet50=resnet,
                           resnet50_optimizers=resnet_opts,
                           resnet50_hand_written_sgd=resnet_baseline,
                           resnet_parity=resnet_parity,
                           packed_segments=packed, data_parallel=dp,
                           tensor_parallel=tp, model_parallel=mp,
                           resilience=resilience, telemetry=telemetry,
                           mpmd=mpmd, conformer=conformer,
                           flash_tp_shards=fl_tp,
                           fused_ffn_tp_shards=ffn_tp,
                           profile=profiled or None, kernels=kernels), f,
                      indent=1, sort_keys=True)
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
