#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

``python3 chip_smoke.py --train-only`` (``--multi-only``) builds the two
kernels phase 15 (16) runs and runs that phase alone, with no result
line; ``--tools-only`` does so for phase 17, ``--modes-only`` (every
kernel built) for phase 18, ``--pages-only`` (every kernel built) for
phase 19, ``--algebraic-only`` (shift-KV, attention and contiguous
decode built) for phase 20.  ``--multi-only --half-batch`` feeds every rank of phase 16's
data-parallel runs (16b, 16c, 16e) slice 0 of the batch, prints the
readings and fails unless the gates refuse each of them.

Phases (any failure exits non-zero; nothing is caught and skipped):
  1. the card's name and power limit (nvidia-smi), then the build of every
     CUDA kernel with nvcc from the sources in the checkout, and the
     package's exports (``from repro_torch.kernels import pasa_attention``
     gives the op);
  2. each kernel against its plain PyTorch version on the card, at the
     serving paths' shapes (qwen2-7b: H 28, KVH 4, G 7, D 128, block and
     page 128, fp16 PASA policy, beta 0.984497), and against a float64
     gold: max error, relative RMSE, and times (kernel, plain version,
     and one PyTorch call computing the same function - a
     scaled_dot_product_attention or a matmul - as a yardstick the port
     never calls).  The paged decode and prefill kernels, then shift-KV,
     the PASA attention kernel (with its FlashAttention-2 setting and the
     paper's fp16 overflow headline) and the contiguous decode kernel
     (bit for bit against its sequential walk and the paged one on the
     same rows, and at the op's default block of 256 rows against its
     plain version and its walk); shift-KV in each of its modes (bf16 and
     fp16 keys under fp16 operands, bf16 operands under the bf16_fp32
     policy, blocks 128 and 64); the paged decode kernel is timed also
     at a paged serve's decode call (batch 4, kv 1002/519/302/131) from
     each pool dtype, the contiguous one at the dense serve's (batch 4,
     kv 1002, 1040 rows);
     each of the four attention kernels also in its fp32 and bf16_fp32
     modes (the policies of the reference's flash impl) at the same
     fixtures and bars, at beta 0 (FlashAttention-2) and at the path's
     beta, output at the policy's dtype, timed beside SDPA at the
     policy's input dtype (contiguous decode again bit for bit against
     its walk and paged decode; FlashAttention-2 finite on the overflow
     inputs).  The quantized mode of the two paged kernels follows: the
     decode and prefill fixtures quantized per page to int8 and fp8_e4m3
     codes with scale/shift sidecars, each kernel against its plain
     version under the fp32, bf16_fp32, fp16_fp32 and fp16 policies,
     relative RMSE against float64 attention on the unquantized K/V
     within the per-dtype bounds (at fp32: the reference's own bar), and
     NaN debris past kv_len and NaN sidecars on dead pages inert bit for
     bit;
  3. the paged serving path: qwen2-7b at full width (28 layers, random
     weights) answers four requests through ServeEngine, with both paged
     kernels' launch counts checked per device call; the same requests
     served one at a time must give identical streams; then the same
     serve from an int8 and from an fp8_e4m3 page pool (the quantized
     kernels, 28 launches per call, batched == one-at-a-time streams);
  4. the dense serving path (the default route of launch/serve.py) with
     the same weights: four 1000-token prompts in one fused prefill, then
     greedy decode to 32 tokens each; shift-KV and PASA attention launch
     28 times per prefill call, the contiguous decode kernel 28 times per
     decode call, the paged kernels never; each prompt served alone gives
     the same stream as in the batch; the first step (the fused
     prefill's logits) through the kernels within DENSE_LOGIT_ATOL of
     the same step through their plain versions, and no farther from the
     plain versions at fp32 than DENSE_FP32_RATIO x theirs.  Shift-KV's
     launches are counted per mode: in the kernels line each mode has its
     own count, 0 for the modes the serve does not run;
  5. the reference's attention switch at impl="flash" (FlashAttention-2
     at its default policy, bf16_fp32) with the same weights: the paged
     serve from a bf16 pool and the dense serve again, each launch in the
     kernels' bf16_fp32 mode (28 per call), batched == one-at-a-time
     streams; how many greedy tokens equal the PASA serve's is reported.
     In the kernels line each new mode has its flash serve's count (0 for
     the fp32 modes, which no serve runs);
  6. the engine's other modes on the same weights' first FEATURE_LAYERS
     (8) of 28 layers (phases 6, 9, 10 and the tenant serve; first the
     paged phase's serve of that depth from each pool,
     ``serve_features_<pool>``, whose streams they are held to), each
     phase on a line of its own, every launch checked (one a layer per
     call, on the paged kernels only) and every stream held exactly:
     token-by-token mode
     (``serve_tbt``: prompts of 257 and 129 tokens through the paged
     decode kernel, no prefill call) against ``dense_greedy_reference``
     (the dense B=1 cache through the contiguous decode kernel); the
     prefix cache (``serve_prefix_<pool>`` at bf16, int8, fp8_e4m3: three
     prompts sharing a 768-token prefix, cold then hits, then a repeat)
     against ``chunked_cold_reference``, with the cached pages' bytes
     unchanged by the hits and TTFT hit against cold; preemption
     (``serve_preempt_<pool>`` at bf16 and int8: a 1000-token request
     paged out by a 900-token one in 12 pages, resumed by a partial hit,
     a re-prefill and a replay) against ``chunked_cold_reference``; and
     the paged phase's prompts under the SJF and Mixed policies (Mixed
     with a step token budget of 640) against the FCFS serve's streams.
     Before the serves, the paged prefill kernel is held bit for bit to
     itself across chunk starts at page boundaries that are not chunk
     boundaries (``prefill_chunk_starts``), as a prefix hit starts;
  7. the hybrid family: zamba2-1.2b at full width (HYBRID_LAYERS = 12 of
     its 38 Mamba-2 layers, a shared attention block applied twice,
     head_dim 64; random weights from seed 0) serves four 100-token
     prompts, 32 greedy tokens each, token by token through
     launch/serve.py's route on a 140-row cache (``serve_hybrid``): the
     contiguous decode kernel at head_dim 64 twice per step and no other
     kernel, batched == one-at-a-time
     streams, the first generated step's logits against the plain
     versions' on the card.  Before it, in phase 2, ``check_decode_hd64``
     holds both decode kernels at head_dim 64 (KVH 32, G 1 and KVH 4, G 8;
     all four policies; blocks 128 and 256; raw, int8 and fp8_e4m3 pools)
     to their plain versions and float64, contiguous == paged == walk bit
     for bit; in the kernels line each decode kernel has a ``/d64`` entry
     with the hybrid serve's count (0 for paged decode);
  8. the audio family: whisper-large-v3 at full width (32 encoder and
     WHISPER_LAYERS = 8 of 32 decoder layers, d 1280, 20 / 20 heads of
     64; random weights from seed 0) encodes four clips of 1,500 frame
     embeddings once into the cache's ``enc_out``, then serves four
     64-token prompts, 32 greedy tokens each, token by token
     (``serve_whisper``): per step 8 contiguous decodes, 8 shift-KV and 8
     attention launches (the cross-attention), per encode 32 + 32, all at head_dim
     64 and no other kernel; batched == one-at-a-time streams; the first
     generated step's logits against the plain versions' on the card.
     Before it, in phase 2, ``check_shift_kv_hd64`` (every shift mode at
     the encoder's keys) and ``check_attention_hd64`` (the four policies
     at beta 0 and BETA on the encoder's call with the column limit
     kv_valid 1500 of 1536 rows, the one-query cross call, a limit of S2
     - 127, no limit, causal), each timed beside its library call; in the
     kernels line ``shift_kv/d64`` and ``pasa_attention/d64`` have the
     whisper serve's count (its encode included), and one entry each
     gathers their other d64 modes;
  9. sampling and self-speculative decoding on the paged engine, qwen2-7b
     at FEATURE_LAYERS as phase 6.  In phase 2, ``check_verify`` holds
     ``pasa_paged_verify`` at W = K + 1 = 5 columns on the serve-shape
     decode pools (bf16, int8, fp8_e4m3): five decode-kernel launches a
     call, each column bit-equal to a one-token kernel decode at its
     position and within the decode bars of the plain version, timed
     beside five single decode calls.  ``serve_sample_<pool>`` (bf16,
     int8; temperature 0.8, top-k 50, seed 7, the paged phase's prompts):
     batched == one at a time, prefill chunk 256 == 512, preempt-resume ==
     each request alone, top-k 1 == the greedy serve, temperature 0 == the
     greedy serve, some token differs from greedy, the card's uniforms
     equal the CPU's (the CPU sampler's tokens on the same logits are
     counted).  ``serve_spec_<pool>`` (bf16, int8, fp8_e4m3; K = 4, prompts
     repeating one 64-token segment, 16 tokens each): with the n-gram
     drafter, and on bf16 and int8 also with an oracle drafter (every
     draft accepted) and a wrong one (every draft rolled back), streams
     and every non-null page of the pool equal the plain serve's bit for
     bit; on bf16 a sampled serve with speculation equals its serve
     without.  Every serve's launches are checked: one a layer per
     prefill call, per decode call and per verify sub-step (K + 1 per
     call);
 10. async pipelining and telemetry on the paged engine, qwen2-7b at
     FEATURE_LAYERS as phase 6.  ``serve_async_<pool>`` (bf16, int8, fp8_e4m3): the
     paged workload served sync, async (``pipeline_depth=1``), async,
     sync, each timed (tok/s, decode ms a step): every stream equal to
     ``serve_features_<pool>``'s, every non-null pool page equal between
     the depths,
     launches equal per kernel and per call, ``on_token`` in order and
     gapless, lagging the host's count at depth 1 only; every serve under
     ``torch.cuda.set_sync_debug_mode("warn")``, its synchronizing calls
     per step outside the engine's drain points held at 0 and printed
     beside the count in all.  ``serve_async_spec_bf16``: K = 4 at depth 1
     with the n-gram, oracle and wrong drafters, each equal to the depth-0
     serve without speculation in streams and pool pages.
     ``serve_async_preempt_bf16``: ``serve_preempt`` at depth 1.
     ``serve_cancel_bf16``: request 0 cancelled after 8 tokens at depth 1
     with the prefix cache (its prompt pages donated, free + resident ==
     allocatable, the other streams unchanged, the same prompt again a
     hit).  ``serve_telemetry_<pool>`` (bf16, int8): trace, metrics and
     the probe every 4 steps on against off at depths 0 and 1 (streams and
     pool pages equal; the Chrome trace's spans and lifecycle instants
     counted; each probe reading on the card equal to the numpy probe on
     the same pages copied out);
 11. the tenant policy and the qwen3 dense configs.  Right after phase
     10, qwen2-7b at FEATURE_LAYERS, ``serve_tenant_bf16``: the paged
     workload on 2 slots under TenantQuotaPolicy (requests 0 and 2
     tenant "interactive" at class "latency", 1 and 3 tenant "bulk" at
     "throughput", submitted first, with a page quota below their joint
     need and a prefill token cap a step; preemption armed): streams
     equal the FCFS streams of its depth, the latency requests admitted and
     given their first token before the bulk ones, the cap and the quota
     never exceeded, the quota made a bulk request wait with a slot free
     and caused no preemption, the per-tenant series sum to
     the aggregates, and the same at K = 4 (n-gram) and at depth 1.  After
     phase 8, ``check_groups``: each kernel at the GQA groups of the dense
     configs (head_dim 128; G 4 KVH 8 qwen3-4b, G 5 qwen3-14b, G 8
     qwen3-32b, G 1 KVH 40 qwen1.5-32b): both paged kernels and the
     contiguous decode at each group (contiguous == paged bit for bit), at
     G 4 also their 8-bit pools, shift-KV on 8 kv heads and the causal
     attention kernel (4, 32, 8, 1024, 128); each timed beside its plain
     version and library call.
     Then qwen3-4b at full width with its depth cut to QWEN3_LAYERS (6
     of its 36 layers since the smoke's time outgrew its aim; d 2560, 32
     / 8 heads, qk-norm, vocab 151,936; random weights from seed 0):
     ``serve_qwen3_4b_<pool>`` (bf16, int8, fp8_e4m3: phase 3's workload,
     one launch a layer a call, requests 0 and 3 alone == batched, every logit
     finite), ``serve_qwen3_4b_dense`` (phase 4's workload; its first
     step within DENSE_LOGIT_ATOL of the plain versions and no farther
     from them at fp32 than theirs, as qwen2-7b's in phase 4; its
     streams equal to the paged engine's on the same prompts up to each
     row's first flip, at a top-2 margin under STREAM_GUARD) and
     ``serve_qwen3_4b_tbt``
     (prompts of 129 / 17 tokens token by token ==
     ``dense_greedy_reference``).  In the kernels line each group entry has
     its qwen3-4b serve's count (0 at G 5, 8 and 1, which no serve runs).
 12. the vlm and ssm families, token by token.  ``check_vlm_cross``:
     shift-KV and the attention kernel at llama-3.2-vision-90b's image
     cross call (bf16 keys (4, 8, 1664, 128), 1,601 image tokens, rows
     past them zero; one query row padded to 64, 64 query heads over 8
     kv heads, G 8, kv_valid 1601; fp16 PASA at beta 0.984497 and FA2 at
     beta 0), each against its plain version and float64, NaN past
     kv_valid inert, timed beside its library call; and contiguous
     decode at G 8 at the self layers' call (kv 48 of a 72-row cache).
     ``serve_vlm``:
     llama-3.2-vision-90b at full width with its depth cut to 5 of its
     100 layers (a group of one cross and 4 self layers; random weights
     from seed 0, the tanh gates set to 0.5 - at the reference's init, 0,
     no cross layer would reach the logits), four 32-token prompts with
     their images (vision_embeds (4, 1601, 1280) from seed 0), 32 greedy
     tokens each: per step 4 contiguous decodes at G 8, 1 shift-KV and 1
     attention launch and no other kernel; batched == one-at-a-time
     streams; the first generated step within HYBRID_LOGIT_ATOL of the
     plain versions and no farther from them at fp32 than
     DENSE_FP32_RATIO x theirs; another image moves those logits.
     ``serve_falcon_mamba``: falcon-mamba-7b at full width (MAMBA_LAYERS
     = 16 of its 64 Mamba-1 layers; random weights from seed 0), four 64-token prompts,
     32 greedy tokens each: no kernel launched, batched == one-at-a-time,
     the last prompt step's decode logits within the reference's
     decode-vs-forward bar of ``_ssm_forward`` on the whole prompt.  In
     the kernels line the contiguous decode's G 8 entry has the vlm
     serve's count, and the three entries of ``check_vlm_cross`` their
     modes' counts;
 13. the moe family: olmoe-1b-7b at full width with its depth cut to 4
     of its 16 layers (d 2048, 16 / 16 heads of 128, qk-norm, 64 experts
     of width 1024, top-8; random weights from seed 0).  In phase 11 ``check_groups``
     holds each kernel at its KVH 16, G 1 (tag ``g1o``: both paged
     kernels, also from an int8 pool, contiguous decode, shift-KV and
     causal attention at the dense prefill).  At the published capacity
     factor 1.25: ``serve_olmoe_<pool>`` (bf16, int8; phase 3's
     workload) and ``serve_olmoe_dense`` (phase 4's), 8 launches a
     call, every logit finite; the dense first step within
     DENSE_LOGIT_ATOL of the plain versions and no farther from them at
     fp32 than DENSE_FP32_RATIO x theirs, with the kernels' routing
     pinned in the plain runs (the unpinned gaps reported); reported:
     the dropped slots per layer of the first prefill and decode calls
     and the (layer, token) top-k sets that differ from the plain
     versions' run.  No batched == alone there: capacity drops make a
     row depend on its call (ROADMAP C).  ``serve_olmoe_nodrop``: the
     bf16 paged serve at capacity factor E / k = 8 (nothing dropped,
     held): requests 0 and 3 alone == batched, async == sync
     (``serve_async``) and token by token == ``dense_greedy_reference``
     (prompts of 129 and 17).  In the kernels line the ``g1o`` entries
     have the olmoe serves' counts;
 14. serving across devices, right after phase 3 with its weights.
     ``serve_replicas_bf16``: phase 3's workload through an
     ``EngineReplicaGroup`` of two replicas on cuda:0 (a 2 x 1 mesh, one
     copy of the weights, each replica its own pool) under "least"
     routing: streams equal phase 3's, each paged kernel launched 28
     times per call of each replica (counted per replica), each replica's
     non-null pages equal a one-engine serve of its subset.
     ``serve_affinity_bf16``: eight requests sharing a 512-token system
     prompt plus a drawn tail of 64-300 tokens, the prefix cache on: the
     first served to its end, then the other seven as a burst - under
     "affinity" every one lands on the warm replica and hits its four
     system pages; routing counts, prefix hits and TTFT beside the same
     under "rr", whose streams are equal.  ``serve_replicas_async_bf16``:
     the group at ``pipeline_depth=1`` equals the sync group, 0
     synchronizing calls a step outside the drain points.  The paged
     kernels at the per-rank slice of a 1 x 2 model axis (KVH 2, G 7;
     ``check_kvh2_slices``) against their plain versions, timed beside
     SDPA.  ``serve_mesh_1x2_<pool>`` (bf16, int8): a gloo group of two
     spawned processes on cuda:0, each serving qwen2-7b at full width
     with its depth cut to MESH_LAYERS from a pool kv-head-sharded in
     halves: tokens and the whole pool's non-null pages equal a
     one-process serve's, each rank holds half the pool's bytes, the
     boundary's host-staging ms per call and each process's peak device
     memory beyond what was resident reported (the sharded engine gathers
     the whole pool and runs the one-device step at KVH 4, so the split
     at rest saves no peak memory and no compute); in the same group
     (``serve_mesh_1x2_ops``) the two sharded ops on phase 2's decode and
     prefill fixtures (each rank's kernels at KVH 2) bit-equal to the
     unsharded kernels, and ``core.ring_pasa_attention`` on the prefill
     fixture's first 3 kv heads within RMSE_MAX of float64 and
     RING_RMSE_RATIO x the one-device GEMM-form PASA's RMSE, and at the
     float64 policy within 1e-10 of it.  In the kernels line the paged
     kernels' counts include the replica serve's and both ranks' of the
     bf16 mesh serve; the KVH 2 slices, which no serve runs, have the
     sharded ops' launches over both ranks.
 15. training, last: ``check_train_attention`` holds
     ``kernels.train_attention.KernelAttention`` at qwen2-7b's training
     call (batch 2, 28 query heads over 4, 1,024 rows, head_dim 128,
     causal, bf16 inputs; fp16 PASA at BETA and FlashAttention-2 at
     bf16_fp32): its output equal to the op's and its input gradients
     equal to autograd of ``attention_plain`` bit for bit, one launch of
     the attention kernel (and of shift-KV) a forward, the forward plus
     backward timed beside the plain version's and SDPA's; the
     ``shift_kv/train`` and ``pasa_attention/train`` entries of the
     kernels line time both kernels at that call.  ``train_full_width``:
     qwen2-7b at full width with its depth cut to TRAIN_LAYERS (4 of 28,
     to keep the smoke in its time with phase 16; fp32 parameters,
     gradients and AdamW moments take 16 bytes a parameter), remat on, random weights from seed 0 on the card,
     ``DataPipeline(batch=2, seq=1024, seed=0)``; first the step-0
     batch's loss and gradients through the kernels against the
     whole-plain path (the plain attention forward, autograd) and both
     against the whole-plain path with its attention at fp32, forward
     and backward (TRAIN_* bars); then TRAIN_STEPS
     steps of ``make_train_step`` through ``FaultTolerantLoop`` with no
     checkpoint written: every loss and gradient norm finite, every
     parameter leaf moved, shift-KV and attention launched 2 x
     TRAIN_LAYERS times a step (each layer's forward and its remat
     recompute) and no other kernel; wall ms a step, peak memory and the
     loss trajectory reported.  ``train_restart``: ``python -m
     repro_torch.launch.train`` on the reduced qwen3-4b at the naive
     attention in fresh processes, one after the other: 10 steps
     straight, and a run from the straight run's
     step-5 checkpoint alone, their step-10 checkpoints equal leaf for
     leaf, bit for bit.  In the kernels line the two
     ``/train`` entries have the trainer's launches.
 16. training across processes, after phase 15: the one-device steps
     first (freed before the group starts), then two processes on the
     card in a gloo group, each with the trainer CLI's determinism
     settings.  16a, expert parallel (olmoe-1b-7b at full width, 2 of 16
     layers, capacity factor E / k, a 1 x 2 mesh): ``moe_ffn``'s a2a
     dispatch on each rank's 32 experts against ``moe_ffn_gspmd`` on all
     64, one layer, B 2 x S 1024 bf16 tokens, the output and every
     leaf's gradient within EP_FFN_TOL of their largest; then one train
     step of the whole model, its state placed by the plan (the experts,
     the attention's 8 of 16 heads, the embedding and head split over the
     model axis), against the one-device step (loss within
     MULTI_LOSS_ATOL, gradient norm MULTI_GNORM_RTOL), the replicated
     leaves the same bits on both ranks, each rank's bytes at rest the
     plan's.  16b, data parallel of whole replicated state (qwen3-4b, 2
     of 36 layers, a 2 x 1 mesh, global batch 2 x 1,024; the model run
     without a mesh on each rank's slice, every gradient all-reduced):
     MULTI_STEPS (2) steps against as many one-device steps on the whole
     batch (the same bars), the card's peak (both ranks' and what this
     process holds) at most MULTI_PEAK_GB.  16e, FSDP on the same 2 x 1
     mesh from the same seed: the state placed by the plan (ZeRO over
     the data axis: each layer gathered before it runs, the gradients
     reduce-scattered), step 1's loss the bits of 16b's and its gradient
     norm within FSDP_GNORM_RTOL of 16b's, every step within the bars of
     the one-device steps, each rank's bytes at rest the plan's count
     exactly.  16f, column-parallel on a 1 x 2 mesh (qwen3-4b as 16b,
     each rank 4 of 8 kv heads and their 16 query heads, 4,864 of 9,728
     MLP columns, the vocab-parallel embedding and loss on its 75,968 of
     151,936 rows and columns): MULTI_STEPS steps against the one-device
     steps at the same bars, the replicated leaves the same bits on both
     ranks, each rank's bytes at rest the plan's, its wire the bytes
     ``launch.roofline.collective_bytes`` reckons (no model-axis gather
     of the embedding or head).  16g, falcon-mamba-7b (2 of 64 layers,
     no attention) and 16h, zamba2-1.2b (2 of 38 layers and one
     application of the shared block, 16 of 32 kv heads a rank), the
     same on a 1 x 2 mesh with every Mamba layer on its rank's half of
     the channels and the vocab-parallel embedding and loss; 16b, 16e,
     16f, 16g and 16h each report their peak GB a rank.  16c: the
     same as 16b from the same state through the
     compressed step on a pod axis of 2: the losses and gradient norms
     within the bars of 16b and within COMP_LOSS_ATOL of the one-device
     steps', every parameter within COMP_PARAM_ATOL of 16b's, every
     parameter leaf crossing as int16 once a step (bytes counted); and
     ``compressed_psum`` on one leaf (COMP_LEAF_SHAPE), two rounds of
     error feedback, bit for bit the reference's leaf formula on the
     gathered gradients and residuals.  16d: ``row_parallel_matmul`` at
     qwen3-4b's w2 call, forward and weight gradient within ROWP_TOL of
     the plain product's largest, one bf16 sum on the wire.  Every
     rank's launches of shift-KV and attention are gated exactly (2 a
     layer a step: forward and remat recompute; 1 a step in 16h, whose
     shared block runs outside remat; none in 16g); the ``/train_dp``,
     ``/train_ep``, ``/train_col`` and ``/train_col_d64`` entries of the
     kernels line time both kernels at the ranks' call shapes (16b / 16c
     / 16e, 16a, 16f, 16h) and carry every rank's launches.
 17. the dry run's accounting held against the card
     (``launch.op_analysis``, ``launch.dryrun``, ``launch.roofline``), in
     two parts: ``tools_decode`` with phase 4's weights before they are
     freed (one dense decode call, batch 4, kv 1002 in a 1040-row cache)
     and ``tools_train`` after phase 16 (phase 15's cell).  The FLOPs the
     card's run counts equal the dry run's count of the same cell on the
     meta device, exactly; the state's bytes on the card, before the
     first step, within TOOLS_STATE_RTOL of the dry run's parameter and
     moment bytes; every share of a published H100 peak (the decode's
     byte bound over its time, the step's MFU and counted FLOPs over its
     time) below TOOLS_SHARE_MAX; each reading printed beside the card's
     name and power limit.  ``--tools-only`` builds the three kernels the
     phase runs, qwen2-7b's serving weights, and runs phase 17 alone.
 18. the kernels' other head widths, right after phase 2: head_dim 32 in
     all five kernels and head_dim 64 in paged prefill, at the reference's
     kernel-test shapes (``MODES_*``): attention (1, 5, 5, 384, 32),
     blocks 128 / 128, PASA and FlashAttention-2, causal and not, the four
     policies; shift-KV on those keys in its six modes; contiguous decode
     (2, 2, 512, 32) at kv 300 / 77, G 1 and 4, blocks 128 and 256, bit
     for bit its walk; paged decode (KVH 2, G 4, page 64, kv 100 / 37,
     shuffled pages) bit for bit contiguous decode on the same rows, from
     raw, int8 and fp8_e4m3 pools; paged prefill at head_dim 32 (H 4 over
     KVH 2, chunks of 64 at starts 32 and 0, page 16) and at 64 (phase 2's
     prefill fixture), raw and 8-bit pools.  Every case is launched once
     with the launch counts set to 0 just before and read just after,
     then held to its plain version (PERF.md §2's bars) and float64, stale
     pool bytes inert; each entry timed beside its plain version, one
     library call and its bound.  In the kernels line each entry has its
     launches in that pass (``/d32``, ``/d64`` modes), which no serve runs.
     ``--modes-only`` builds every kernel and runs phase 18 alone.
 19. every page size the reference serves, right after phase 3 with its
     weights: the paged decode kernel at pages 1, 8, 16, 48, 128 and 256
     and blocks 128 and 256 of the page-table view (PAGES_*), head_dim
     128 (KVH 4, G 7) and 64 (KVH 4, G 8), bf16, int8 and fp8_e4m3
     pools, fp16 PASA at BETA and bf16_fp32 FlashAttention-2, on a paged
     serve's decode rows (kv 1002 / 519 / 302 / 131): bit for bit
     contiguous decode at the same block on the same rows (an 8-bit
     pool's dequantized as the kernel loads them) and its walk, within
     the decode bars of the plain version; the paged prefill kernel at
     pages 8, 16, 48, 256, 257, 300, 512 and 1024 (256 and over:
     pasa_paged_prefill_wide.cu, over 256 in pieces of 256 rows) on phase
     2's prefill rows from each pool in both modes (pages over 256 also
     at head_dim 64 and 32, PAGES_WIDE_SHAPES), within the prefill bars
     of the plain version and the float64 RMSE bars, a pad row of zeros,
     bit-invariant to a page-aligned chunk cut; stale bytes (NaN past
     kv_len, 8-bit debris, NaN sidecars on dead pages) inert.  The
     cases run page by page, every launch count set to 0 just before a
     page's pass and read just after.  Then ``serve_pages``: qwen2-7b at
     full width with its depth cut to PAGES_LAYERS, block_kv 128, phase
     3's workload at pages 16, 128 and 512 (chunk 512) from a bf16 and an
     int8 pool (requests 0 and 3 alone == batched, every launch counted,
     tok/s, TTFT and decode ms side by side), the prefix cache at pages
     16 and 512 (hits == ``chunked_cold_reference``), the engine's chunk
     schedule at page 512 (chunks of 512 and 1024 rows, the same
     streams), and the page-16 and page-512 first steps (the first
     prefill call's logits) within DENSE_LOGIT_ATOL of the plain paged
     versions and no farther from them at fp32 than DENSE_FP32_RATIO x
     theirs.  Both paged kernels are timed at the serve's call shapes at
     pages 16 and 8 (prefill also 256 and 512, beside 128 and 1024)
     beside the plain version, SDPA and the bound.  In the kernels line
     each page entry has the page-16 / page-512 serve's count or its
     pass's count (page 8, 256).  ``--pages-only`` builds every kernel
     and runs phase 19 alone, the weights built at its depth.
 20. the algebraic-shift dense attention (``use_gemm_shift=False``), right
     after phase 19 with phase 3's weights: the shift kernel's algebraic
     mode at head_dim 128 / 64 / 32, blocks 128 / 64, each key / operand
     mode, against its plain version and the float64 algebraic shift; the
     attention kernel on its K' under the four policies, causal at the
     dense prefill's shape and with the column limit at whisper's encoder
     shape, against the plain ``blocked_attention(use_gemm_shift=False)``
     and float64; qwen2-7b's dense route at ALG_LAYERS of 28 layers with
     the flag (batched == alone, every launch counted, the first step's
     logits within DENSE_LOGIT_ATOL of the plain versions' and no farther
     from fp32 than DENSE_FP32_RATIO x theirs); one training step of
     phase 15's configuration with the flag (its gradients no farther from
     the fp32 plain path's than TRAIN_FP32_RATIO x the fp16 plain
     path's).  ``--algebraic-only`` runs phase 20 alone.
The line before the last is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the kernel bound and the attention ops' FLOP / byte formulas
from repro_torch.launch import roofline as R  # noqa: E402

BETA = 0.984497
SPIN_CYCLES_PER_S = 1.98e9      # H100 SXM boost clock: cycles of torch.cuda._sleep
DECODE_KV_LENS = (1, 127, 128, 1000, 4095)
PREFILL_STARTS = (0, 512, 1024)
PREFILL_CHUNK = 512
SERVE_PROMPTS = (1000, 517, 300, 129)
SERVE_GEN = 32
SERVE_DECODE_KV = (1002, 519, 302, 131)   # a paged serve decode call's kv
DENSE_BATCH, DENSE_PROMPT = 4, 1000
ATTN_SHAPE = (4, 28, 4, 1024, 128)   # B, H, KVH, S, D: the dense prefill's
# tolerances of the reference's own kernel tests: decode kernel vs oracle
# (tests/test_paged.py), prefill kernel vs oracle (tests/test_prefix_cache
# .py); both fp16 kernels within relative RMSE 0.03 of exact attention
DECODE_TOL = dict(atol=3e-3, rtol=3e-2)
PREFILL_TOL = dict(atol=1e-2, rtol=3e-2)
RMSE_MAX = 0.03
# the reference's own bars for the dense-route kernels (tests/test_kernels
# .py): shift-KV vs its oracle; attention vs its oracle, causal and not;
# FlashAttention-2 vs its oracle; PASA within relative RMSE 0.02 of exact
SHIFT_TOL = dict(atol=1e-2, rtol=0.0)
ATTN_CAUSAL_TOL = dict(atol=2e-3, rtol=2e-2)
ATTN_TOL = dict(atol=8e-3, rtol=2e-2)
FLASH_TOL = dict(atol=2e-3, rtol=2e-2)
ATTN_RMSE_MAX = 0.02
# shift-KV vs the float64 product with the same M (every mode) and, at
# fp16 operands, vs the float64 algebraic shift: the rounding of M's two
# entries and of the store, a few 1e-4 relative at fp16
SHIFT_RMSE_MAX = 1e-2
# quantized pools: relative RMSE vs float64 attention on the unquantized
# K/V at the fp16_fp32 policy (tests/test_kv_quant.py RMSE_BOUND); at the
# fp16 policy, within max(2 x the raw pool's RMSE, the bound)
QUANT_DTYPES = ("int8", "fp8_e4m3")
QUANT_RMSE_BOUND = {"int8": 0.03, "fp8_e4m3": 0.09}
# the fp32 and bf16_fp32 modes of the four attention kernels (fp16
# operands with fp32 scores, statistics and accumulator; bf16 operands and
# output with the rest fp32): held at the same bars, timed at beta = 0 (the
# flash route serves bf16_fp32 at beta 0) and at the path's beta
NEW_POLICIES = ("fp32", "bf16_fp32")
# the engine's features at full width (each with the weights every phase
# shares): token-by-token mode, two prompts against the dense B=1 oracle;
# the prefix cache, three prompts sharing a 768-token (six-page) prefix,
# the first served cold, the other two together, then the first again;
# preemption, a 1000-token prompt (9 pages) paged out by a 900-token one
# (8 pages) in 12 allocatable pages; the paged phase's prompts under the
# two other policies (mixed with a step token budget)
TBT_PROMPTS, TBT_GEN = (257, 129), 16
PREFIX_SHARED, PREFIX_SUFFIXES, PREFIX_GEN = 768, (232, 105, 40), 16
PREEMPT_PROMPTS, PREEMPT_GEN, PREEMPT_PAGES = (1000, 900), 32, 12
POLICY_SERVES = (("sjf", None), ("mixed", 640))
# the depth of qwen2-7b (of 28 layers) the engine's other modes run at
# (phases 6, 9, 10 and the tenant serve), each against a paged serve of
# that depth: every contract they hold is a bit-equality at any depth
# (28 until phase 16 gained 16e and 16f)
FEATURE_LAYERS = 8
# sampling and speculation on the paged engine: the verify op at
# W = SPEC_K + 1 columns on the serve-shape decode pools; the sampled
# serves at SAMPLE_KW on the paged workload; the speculative serves at
# K = SPEC_K on four prompts (the paged workload's lengths) repeating one
# 64-token segment drawn from seed 5, so that the n-gram drafter proposes,
# SPEC_GEN tokens each
SPEC_K = 4
SAMPLE_KW = dict(temperature=0.8, top_k=50, sample_seed=7)
SPEC_SEGMENT, SPEC_GEN = 64, 16
# async pipelining and telemetry on the paged engine: request 0 of the
# cancel serve hangs up after CANCEL_AFTER tokens; the telemetry serves
# probe every TELEMETRY_PROBE_EVERY steps
CANCEL_AFTER = 8
TELEMETRY_PROBE_EVERY = 4
# head_dim 64 (zamba2-1.2b's shared attention block): both decode kernels
# at zamba2's shape (KVH 32, G 1) and at a GQA group (KVH 4, G 8); the
# hybrid serve: four 100-token prompts, 32 greedy tokens each, token by
# token on a 140-row cache (block 128: decode crosses a block boundary),
# and its first generated step's logits held to the same step through the
# kernels' plain versions on the card within 0.1 (the bar of the CPU
# parity tests between two bf16 stacks, tests/test_torch_dense_route.py)
HD64_SHAPES = ((32, 1), (4, 8))
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_MAX_LEN = 4, 100, 140
HYBRID_ALONE = (0, 3)
# of zamba2's 38 layers: two applications of the shared block (38 and 7
# until phase 16 gained 16g and 16h)
HYBRID_LAYERS = 12
HYBRID_LOGIT_ATOL = 0.1
# head_dim 64 of shift-KV and attention (whisper-large-v3: 20 / 20 heads
# of 64): the encoder's shape, (B 4, H 20, 1536 rows, D 64) with the
# column limit at its 1500 frames; the cross-attention's, one query row
# padded to 64 against the same keys; a limit of S2 - block_kv + 1; no
# limit.  The whisper serve: four 64-token prompts, 32 greedy tokens each,
# token by token (95 steps) on a 104-row cache, from the encoder output of
# (4, 1500, 1280) frames drawn from seed 0, first-step logits held to the
# plain versions' within HYBRID_LOGIT_ATOL
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_S2 = 4, 1500, 1536
WHISPER_PROMPT, WHISPER_MAX_LEN = 64, 104
WHISPER_ALONE = (0, 3)
# of whisper's 32 decoder layers (the encoder keeps its 32; all 32 until
# phase 16 gained 16g and 16h)
WHISPER_LAYERS = 8
# PASA at bf16 operands (bf16_fp32, beta 0.984497) on the non-causal
# whisper fixtures: the reference's algorithm itself (the plain version)
# is 0.027 from float64 at the encoder's shape (queries of mean 0, keys of
# mean 2; measured on the CPU), 0.056 on one query row at a smaller shape,
# past ATTN_RMSE_MAX - K' rounded to bf16, its s-bar error multiplied by
# inva ~ 63, on a flat softmax whose output is small against V.  There
# the kernel is held to the plain version (ATTN_TOL) and within
# BF16_PASA_RMSE_RATIO x the plain version's RMSE, which is reported;
# every other mode within ATTN_RMSE_MAX
BF16_PASA_RMSE_RATIO = 1.25
# phase 11: the GQA groups of the dense configs at head_dim 128, (arch,
# KVH, G): qwen3-4b's 4, qwen3-14b's 5, qwen3-32b's 8, qwen1.5-32b's 1
# (KVH 40); qwen3-4b served at full width on both routes with its depth
# cut to QWEN3_LAYERS of 36 (36 until the smoke's time outgrew its aim,
# 12 until phase 19 came),
# the requests QWEN3_ALONE one at a time, token by token on
# QWEN3_TBT_PROMPTS;
# the tenant serve (qwen2-7b): requests TENANT_LATENCY are tenant
# "interactive" at class "latency", the others tenant "bulk" at
# "throughput" under TENANT_QUOTA (its two requests need 5 + 2 pages), on
# TENANT_SLOTS slots, so that the class rank decides who runs first
GROUP_SHAPES = (("qwen3-4b", 8, 4), ("qwen3-14b", 8, 5), ("qwen3-32b", 8, 8),
                ("qwen1.5-32b", 40, 1), ("olmoe-1b-7b", 16, 1))
# the served configs' group entries: their tag, and beside the raw pool
# the 8-bit pools their serves run, shift-KV and the causal attention
# kernel at their dense prefill (qwen3-4b phase 11, olmoe-1b-7b phase 13)
SERVED_GROUPS = {"qwen3-4b": ("g4", QUANT_DTYPES),
                 "olmoe-1b-7b": ("g1o", ("int8",))}
QWEN3_LAYERS = 6
QWEN3_ALONE = (0, 3)
QWEN3_TBT_PROMPTS = (129, 17)
# the dense route's first step (the fused prefill's logits, qwen2-7b and
# qwen3-4b) through the kernels held within DENSE_LOGIT_ATOL of the plain
# versions and no farther than DENSE_FP32_RATIO x the plain versions' own
# distance from the plain versions at fp32; qwen3-4b's dense streams held
# to the paged engine's (bf16 pool) on the same prompts: first-step
# logits within DENSE_PAGED_LOGIT_ATOL, each row equal up to its first
# flip, whose top-2 margin is under STREAM_GUARD.  On the H100: kernels vs
# plain 0.107 / 0.110 (qwen2-7b / qwen3-4b), the plain versions themselves
# 0.100 / 0.112 from fp32 and the kernels 0.102 / 0.112 (ratios 1.02 /
# 1.00); dense vs paged 0.109, flips at margins 0.052 / 0.045 / 0.010
DENSE_LOGIT_ATOL = 0.15
DENSE_FP32_RATIO = 1.25
DENSE_PAGED_LOGIT_ATOL = 0.15
STREAM_GUARD = 2 * DENSE_PAGED_LOGIT_ATOL
TENANT_LATENCY = (0, 2)
TENANT_QUOTA = dict(max_pages=6, max_step_tokens=256)
TENANT_SLOTS = 2
# phase 12: llama-3.2-vision-90b at full width with its depth cut to
# VLM_LAYERS of 100 (one group: a cross and 4 self layers, bf16 weights
# and an fp32 head; 20, then 10 layers until the smoke's time outgrew its
# aim, 100 would be ~180 GB), its gates set to
# VLM_GATE (at the reference's init, 0, no cross layer reaches the
# logits); its image cross call: one query row padded to 64, 64 query
# heads over 8 kv heads (G 8), VLM_IMAGE_TOKENS keys in VLM_S2 rows.  The
# serve: VLM_BATCH prompts of VLM_PROMPT tokens, SERVE_GEN greedy tokens
# each, token by token on a VLM_MAX_LEN-row cache, from vision_embeds
# (4, 1601, 1280) N(0, 1) drawn from seed 0; its first generated step
# through the kernels within HYBRID_LOGIT_ATOL of the plain versions and
# no farther from the plain versions at fp32 than DENSE_FP32_RATIO x
# theirs; another image moves those logits by more than HYBRID_LOGIT_ATOL.
# falcon-mamba-7b at full width and depth (64 Mamba-1 layers, no
# attention): MAMBA_BATCH prompts of MAMBA_PROMPT tokens, SERVE_GEN each;
# the last prompt step's logits through the decode within MAMBA_FWD_TOL
# (the reference's test_ssm_decode_matches_forward) of _ssm_forward on
# the whole prompt
VLM_LAYERS, VLM_GATE = 5, 0.5
VLM_IMAGE_TOKENS, VLM_S2 = 1601, 1664
VLM_BATCH, VLM_PROMPT, VLM_MAX_LEN = 4, 32, 72
VLM_ALONE = (0, 3)
MAMBA_BATCH, MAMBA_PROMPT = 4, 64
MAMBA_ALONE = (0, 3)
# of falcon-mamba-7b's 64 layers (all 64 until phase 16 gained 16g and 16h)
MAMBA_LAYERS = 16
MAMBA_FWD_TOL = dict(atol=0.25, rtol=0.1)
# phase 13: olmoe-1b-7b at full width with its depth cut to OLMOE_LAYERS
# of 16 (16 until the smoke's time outgrew its aim, 8 until phase 19
# came); at capacity factor
# E / k = 8 (nothing dropped) the requests OLMOE_ALONE are served one at
# a time and the prompts OLMOE_TBT_PROMPTS token by token
OLMOE_LAYERS = 4
OLMOE_ALONE = (0, 3)
OLMOE_TBT_PROMPTS = (129, 17)


def _kernel_module(name: str):
    """The module ``repro_torch.kernels.<name>``: the package binds the
    kernels' names to their ops, as ``repro.kernels`` does."""
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{name}")


def _cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time per call of ``fn``, from CUDA events around ``iters``
    calls.  The calls are queued behind a spin kernel that lasts twice the
    host's time to issue them, so the events time the device running them
    back to back and not the host's launch rate (a 10-microsecond kernel
    issued through a Python wrapper is otherwise timed as the wrapper)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * iters * host_s, 2.0) * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _rel_rmse(a, gold) -> float:
    return float((a.double() - gold).norm() / gold.norm())


def _close(name, got, want, atol, rtol) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {atol} rtol "
            f"{rtol}; max abs error {float(err.max()):.3e}"
        )
    return float(err.max())


# each kernel's CUDA source and the TPU kernel it replaces
KERNEL_FILES = {
    "pasa_paged_decode": ("src/repro_torch/kernels/csrc/pasa_paged_decode.cu",
                          "src/repro/kernels/pasa_paged_decode.py:196"),
    "pasa_paged_prefill": ("src/repro_torch/kernels/csrc/pasa_paged_prefill.cu",
                           "src/repro/kernels/pasa_paged_prefill.py:368"),
    "pasa_decode": ("src/repro_torch/kernels/csrc/pasa_decode.cu",
                    "src/repro/kernels/pasa_decode.py:268"),
    "pasa_attention": ("src/repro_torch/kernels/csrc/pasa_attention.cu",
                       "src/repro/kernels/pasa_attention.py:218"),
}


def _kernel_source(entry: str):
    """(source, replaces) of a kernels-line entry named ``kernel/tag``:
    paged decode builds one source a pool type, paged prefill one for bf16
    / fp16 and one for 8-bit pools, each again for the 256-row tile
    (pages over 128 rows, tags ``page256``, ``page512``)."""
    kernel, _, tag = entry.partition("/")
    if kernel == "shift_kv":
        return ("src/repro_torch/kernels/csrc/shift_kv.cu",
                "src/repro/kernels/shift_kv.py:48")
    source, replaces = KERNEL_FILES[kernel]
    pool = next((p for p in ("int8", "fp8") if p in tag), None)
    if kernel == "pasa_paged_decode" and pool:
        source = source.replace(".cu", f"_{pool}.cu")
    elif kernel == "pasa_paged_prefill":
        page = int(tag[4:].partition("_")[0]) if tag.startswith("page") else 0
        source = source.replace(".cu", ("_wide" if page > 128 else "")
                                + ("_q8" if pool else "") + ".cu")
    return source, replaces


def _caster(*tensors):
    """``at(policy)``: the tensors cast to the policy's input dtype, once
    per dtype (so a timed call does not time the cast)."""
    cast = {}

    def at(policy):
        op = policy.input_dtype
        if op not in cast:
            cast[op] = [x.to(op) for x in tensors]
        return cast[op]

    return at


def _sdpa_at(inputs, **kw):
    """SDPA on ``inputs`` (q, k, v) at a policy's input dtype."""
    import torch.nn.functional as F

    at = _caster(*inputs)
    return lambda policy: F.scaled_dot_product_attention(*at(policy), **kw)


def _is_hd64(entry) -> bool:
    """An entry of a decode kernel's head_dim 64 mode."""
    return entry["name"] in ("pasa_paged_decode/d64", "pasa_decode/d64")


def _is_new_mode(entry) -> bool:
    """An entry of the fp32 or bf16_fp32 mode of one of the four attention
    kernels (shift-KV's bf16_fp32 mode is one of its own modes)."""
    name, _, tag = entry["name"].partition("/")
    return name in KERNEL_FILES and tag in NEW_POLICIES


def _new_mode_entries(name, run, plain, gold, tol, rmse_max, library_of,
                      nbytes, flops, rows=slice(None), extra=None):
    """One ``kernels`` entry per new policy mode of a kernel.  For each
    policy, at beta 0 (FlashAttention-2, the flash route's setting) and at
    BETA: ``run(policy, beta)`` (the kernel) against ``plain(policy,
    beta)`` at ``tol``, the output at the policy's dtype, and both within
    relative RMSE ``rmse_max`` of ``gold`` (float64, over ``rows``);
    ``extra(policy)`` adds the kernel's own checks to the report.  Times:
    the kernel at beta 0 (``ms``) and at BETA (``ms_pasa``), the plain
    version and ``library_of(policy)`` (one PyTorch call computing the
    same function at the policy's input dtype) at beta 0."""
    import torch

    from repro_torch.core.precision import get_policy

    source, replaces = KERNEL_FILES[name]
    entries = []
    for tag in NEW_POLICIES:
        policy = get_policy(tag)
        rep = {}
        for case, beta in (("flash", 0.0), ("pasa", BETA)):
            got, want = run(policy, beta), plain(policy, beta)
            torch.cuda.synchronize()
            if got.dtype != policy.out_dtype:
                raise AssertionError(f"{name}/{tag}: output {got.dtype}")
            rep[f"max_abs_err_{case}"] = _close(f"{name}/{tag} ({case})",
                                                got, want, **tol)
            rmse = _rel_rmse(got[rows], gold)
            rmse_plain = _rel_rmse(want[rows], gold)
            if not (rmse < rmse_max and rmse_plain < rmse_max):
                raise AssertionError(f"{name}/{tag} ({case}) RMSE {rmse:.4f} "
                                     f"/ plain {rmse_plain:.4f}")
            rep[f"rmse_{case}"], rep[f"rmse_plain_{case}"] = rmse, rmse_plain
        if extra is not None:
            rep.update(extra(policy))
        entries.append(dict(
            name=f"{name}/{tag}", route="cuda", source=source,
            replaces=replaces,
            max_abs_err=max(rep["max_abs_err_flash"], rep["max_abs_err_pasa"]),
            rmse=rep["rmse_flash"], detail=rep,
            ms=_cuda_time_ms(lambda: run(policy, 0.0), 20),
            ms_pasa=_cuda_time_ms(lambda: run(policy, BETA), 20),
            plain_ms=_cuda_time_ms(lambda: plain(policy, 0.0), 3, warmup=1),
            library_ms=_cuda_time_ms(lambda: library_of(policy), 20),
            **R.bound(nbytes, flops),
        ))
    return entries


def _paged_pool(rng, seq_lens, kvh, d, page, mean_k, n_extra, dev):
    """Shuffled-page bf16 pool holding one sequence per entry of
    ``seq_lens``; every position at or past a sequence's length, and every
    unreferenced page, is NaN (stale bytes of recycled pages)."""
    import numpy as np
    import torch

    n_pages = [math.ceil(max(n, 1) / page) for n in seq_lens]
    mp = max(n_pages)
    total = 1 + sum(n_pages) + n_extra
    ids = rng.permutation(np.arange(1, total))
    table = np.zeros((len(seq_lens), mp), np.int32)
    k = np.full((total, page, kvh, d), np.nan, np.float32)
    v = np.full((total, page, kvh, d), np.nan, np.float32)
    nxt = 0
    for b, (n, npg) in enumerate(zip(seq_lens, n_pages)):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[b, j] = pid
            rows = max(0, min(page, n - j * page))
            k[pid, :rows] = rng.standard_normal((rows, kvh, d)) + mean_k
            v[pid, :rows] = rng.standard_normal((rows, kvh, d))
    to = lambda a, dt: torch.from_numpy(a).to(device=dev, dtype=dt)
    return to(k, torch.bfloat16), to(v, torch.bfloat16), to(table, torch.int32)


def _gathered(pages, table, n):
    """One sequence's first n positions: (KVH, n, D) float64."""
    import torch

    flat = pages[table.long()].reshape(-1, *pages.shape[2:])[:n]
    return flat.movedim(0, 1).to(torch.float64)


def _decode_fixture(dev):
    """The paged decode fixture: a shuffled bf16 pool of five sequences
    (kv_len DECODE_KV_LENS, KVH 4, D 128, page 128, keys of mean 30, NaN
    past kv_len); returns (rng, kp, vp, table, kv_len, gold_of)."""
    import numpy as np
    import torch

    kvh, d, page = 4, 128, 128
    rng = np.random.default_rng(1)
    kp, vp, table = _paged_pool(rng, DECODE_KV_LENS, kvh, d, page, 30.0, 3, dev)
    kv_len = torch.tensor(DECODE_KV_LENS, dtype=torch.int32, device=dev)

    def gold_of(q):
        golds = []
        for i, n in enumerate(DECODE_KV_LENS):
            kk = _gathered(kp, table[i], n)
            vv = _gathered(vp, table[i], n)
            s = q[i].double() @ kk.transpose(-1, -2) / math.sqrt(d)
            golds.append(torch.softmax(s, -1) @ vv)
        return torch.stack(golds)

    return rng, kp, vp, table, kv_len, gold_of


def _serve_shape_decode(dev, dtype):
    """The paged decode kernel at a paged serve's own decode call: batch 4,
    kv SERVE_DECODE_KV, KVH 4, G 7, page 128, a shuffled pool of
    ``dtype`` (bf16, or the bf16 pool quantized per page); kernel and
    SDPA (on the gathered, dequantized K/V, not timed) ms."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops
    mod = _kernel_module("pasa_paged_decode")

    kvh, g, d, page = 4, 7, 128, 128
    b = len(SERVE_DECODE_KV)
    rng = np.random.default_rng(6)
    kp, vp, table = _paged_pool(rng, SERVE_DECODE_KV, kvh, d, page, 2.0, 3, dev)
    kv_len = torch.tensor(SERVE_DECODE_KV, dtype=torch.int32, device=dev)
    q = _randn(rng, (b, kvh, g, d), 0.0, dev, torch.float16)
    quant = {}
    if dtype != "bf16":
        kp, vp, quant, _ = _quantize_pool(kp, vp, table, SERVE_DECODE_KV, dtype)
    ms = _cuda_time_ms(lambda: ops.pasa_paged_decode(
        q, kp, vp, table, kv_len, beta=BETA, policy=FP16, **quant), 50)
    mp = table.shape[1]
    kg, vg = (
        torch.nan_to_num(mod._gather_dequant(
            x, quant.get(f"{side}_scale"), quant.get(f"{side}_shift"), table,
            torch.float16).reshape(b, mp * page, kvh, d).movedim(1, 2)
        ).repeat_interleave(g, 1)
        for side, x in (("k", kp), ("v", vp))
    )
    mask = (torch.arange(mp * page, device=dev)[None, :] < kv_len[:, None])
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q.reshape(b, kvh * g, 1, d), kg, vg, attn_mask=mask[:, None, None, :]
    ), 20)
    return dict(serve_shape_ms=ms, serve_shape_library_ms=lib_ms)


def check_decode(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops
    mod = _kernel_module("pasa_paged_decode")

    kvh, g, d, page = 4, 7, 128, 128
    b = len(DECODE_KV_LENS)
    rng, kp, vp, table, kv_len, gold_of = _decode_fixture(dev)
    plain_args = lambda *t: mod.paged_decode_plain(
        *t, beta=BETA, policy=FP16, block_kv=page)

    stress = {}
    for q_mean in (1.0, 0.0):      # the held fixture last: timed below
        q = torch.from_numpy(
            rng.standard_normal((b, kvh, g, d)).astype(np.float32) + q_mean
        ).to(device=dev, dtype=torch.float16)
        got = ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                    policy=FP16)
        plain = plain_args(q, kp, vp, table, kv_len)
        cpu = plain_args(*(t.cpu() for t in (q, kp, vp, table, kv_len)))
        torch.cuda.synchronize()
        gold = gold_of(q)
        rmse, rmse_plain = _rel_rmse(got, gold), _rel_rmse(plain, gold)
        if not (rmse < RMSE_MAX and rmse_plain < RMSE_MAX):
            raise AssertionError(
                f"decode RMSE {rmse:.4f} / plain {rmse_plain:.4f}")
        err_cpu = float((got.cpu().float() - cpu.float()).abs().max())
        if q_mean == 0.0:
            # the held fixture: kernel vs plain on the card, at tolerance
            max_err = _close("pasa_paged_decode", got, plain, **DECODE_TOL)
            held = dict(rmse=rmse, rmse_plain=rmse_plain, err_cpu=err_cpu)
        else:
            # stress fixture (sbar ~ 5 at fp16: one ulp of sbar moves a
            # page's weight by exp(inva * ulp) ~ exp(0.25)); reported only
            stress = dict(
                q_mean=q_mean, rmse=rmse, rmse_plain=rmse_plain,
                max_abs_err=float((got.float() - plain.float()).abs().max()),
                max_abs_err_cpu_plain=err_cpu,
            )
    rmse, rmse_plain, err_cpu = held["rmse"], held["rmse_plain"], held["err_cpu"]

    call = lambda: ops.pasa_paged_decode(
        q, kp, vp, table, kv_len, beta=BETA, policy=FP16
    )
    ms = _cuda_time_ms(call, 50)
    plain_ms = _cuda_time_ms(lambda: mod.paged_decode_plain(
        q, kp, vp, table, kv_len, beta=BETA, policy=FP16, block_kv=page
    ), 3, warmup=1)
    # yardstick: SDPA over the gathered view (the gather is not timed)
    mp = table.shape[1]
    kg, vg = (
        torch.nan_to_num(x[table.long()].reshape(b, mp * page, kvh, d)
                         .movedim(1, 2).half()).repeat_interleave(g, 1)
        for x in (kp, vp)
    )
    mask = (torch.arange(mp * page, device=dev)[None, :] < kv_len[:, None])
    mask = mask[:, None, None, :]
    qh = q.reshape(b, kvh * g, 1, d)
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh, kg, vg, attn_mask=mask
    ), 20)
    nbytes, flops = R.paged_decode_cost(b, kvh, g, d, DECODE_KV_LENS,
                                        table.numel())
    main = dict(
        name="pasa_paged_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/pasa_paged_decode.cu",
        replaces="src/repro/kernels/pasa_paged_decode.py:196",
        max_abs_err=max_err, rmse=rmse, rmse_plain=rmse_plain,
        max_abs_err_cpu_plain=err_cpu, stress=stress,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **_serve_shape_decode(dev, "bf16"), **R.bound(nbytes, flops),
    )
    modes = _new_mode_entries(
        "pasa_paged_decode",
        lambda policy, beta: ops.pasa_paged_decode(
            q, kp, vp, table, kv_len, beta=beta, policy=policy),
        lambda policy, beta: mod.paged_decode_plain(
            q, kp, vp, table, kv_len, beta=beta, policy=policy,
            block_kv=page),
        gold_of(q), DECODE_TOL, RMSE_MAX,
        _sdpa_at((qh, kg, vg), attn_mask=mask), nbytes, flops)
    return [main, *modes]


# full chunks at 0 and 512, a ragged last chunk at 1024, one pad row
PREFILL_ROWS = (list(PREFILL_STARTS) + [0], [512, 1024, 1024 + 300, 0])


def _prefill_fixture(dev):
    """The paged prefill fixture: 4 rows x 28 heads x 512 queries of mean
    1 at PREFILL_ROWS, a shuffled bf16 pool (KVH 4, page 128, keys of mean
    2, NaN past kv_len), the pad row's table all null; returns (q, kp, vp,
    table, start, kv_len)."""
    import numpy as np
    import torch

    h, kvh, d, page, cs = 28, 4, 128, 128, PREFILL_CHUNK
    starts, kv_lens = PREFILL_ROWS
    rng = np.random.default_rng(2)
    kp, vp, table = _paged_pool(rng, kv_lens, kvh, d, page, 2.0, 2, dev)
    table[3] = 0                                   # pad row: all-null table
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    kv_len = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    q = torch.from_numpy(
        rng.standard_normal((len(starts), h, cs, d)).astype(np.float32) + 1.0
    ).to(device=dev, dtype=torch.float16)
    return q, kp, vp, table, start, kv_len


def _prefill_gold(q, kp, vp, table):
    """float64 causal attention of the three live rows of the prefill
    fixture over its bf16 K/V."""
    import torch

    starts, kv_lens = PREFILL_ROWS
    _, h, cs, d = q.shape
    g = h // kp.shape[2]
    golds = []
    for i in range(3):
        n = kv_lens[i]
        kk = _gathered(kp, table[i], n).repeat_interleave(g, 0)
        vv = _gathered(vp, table[i], n).repeat_interleave(g, 0)
        s = q[i].double() @ kk.transpose(-1, -2) / math.sqrt(d)
        qpos = starts[i] + torch.arange(cs, device=q.device)[:, None]
        s = s.masked_fill(qpos < torch.arange(n, device=q.device)[None, :],
                          -math.inf)
        golds.append(torch.softmax(s, -1) @ vv)
    return torch.stack(golds)


def check_prefill(dev):
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops
    mod = _kernel_module("pasa_paged_prefill")

    h, kvh, d, page, cs = 28, 4, 128, 128, PREFILL_CHUNK
    starts, kv_lens = PREFILL_ROWS
    b = len(starts)
    q, kp, vp, table, start, kv_len = _prefill_fixture(dev)

    got = ops.pasa_paged_prefill(q, kp, vp, table, start, kv_len, beta=BETA,
                                 policy=FP16)
    plain = mod.paged_prefill_plain(q, kp, vp, table, start, kv_len,
                                    beta=BETA, policy=FP16)
    cpu = mod.paged_prefill_plain(
        *(t.cpu() for t in (q, kp, vp, table, start, kv_len)),
        beta=BETA, policy=FP16)
    torch.cuda.synchronize()
    max_err = _close("pasa_paged_prefill", got, plain, **PREFILL_TOL)
    err_cpu = float((got.cpu().float() - cpu.float()).abs().max())
    if got[3].abs().max() != 0:
        raise AssertionError("prefill pad row (kv_len 0) is not zero")
    gold = _prefill_gold(q, kp, vp, table)
    rmse = _rel_rmse(got[:3], gold)
    rmse_plain = _rel_rmse(plain[:3], gold)
    if not (rmse < RMSE_MAX and rmse_plain < RMSE_MAX):
        raise AssertionError(f"prefill RMSE {rmse:.4f} / plain {rmse_plain:.4f}")
    # bits inside the port: the kernel is invariant to the chunk schedule
    # (check_prefill_starts: at every page boundary a prefix hit starts at)
    half = cs // 2
    a = ops.pasa_paged_prefill(q[:1, :, :half], kp, vp, table[:1], start[:1],
                               start[:1] + half, beta=BETA, policy=FP16)
    c = ops.pasa_paged_prefill(q[:1, :, half:], kp, vp, table[:1],
                               start[:1] + half, kv_len[:1], beta=BETA,
                               policy=FP16)
    if not torch.equal(torch.cat([a, c], 2), got[:1]):
        raise AssertionError("prefill kernel is not chunk-schedule invariant")

    call = lambda: ops.pasa_paged_prefill(q, kp, vp, table, start, kv_len,
                                          beta=BETA, policy=FP16)
    ms = _cuda_time_ms(call, 20)
    plain_ms = _cuda_time_ms(lambda: mod.paged_prefill_plain(
        q, kp, vp, table, start, kv_len, beta=BETA, policy=FP16
    ), 3, warmup=1)
    mp = table.shape[1]
    kg, vg = (
        torch.nan_to_num(x[table.long()].reshape(b, mp * page, kvh, d)
                         .movedim(1, 2).half()).repeat_interleave(h // kvh, 1)
        for x in (kp, vp)
    )
    col = torch.arange(mp * page, device=dev)
    qpos = start[:, None] + torch.arange(cs, device=dev)[None, :]
    mask = (col[None, None, :] <= qpos[:, :, None]) & (
        col[None, None, :] < kv_len[:, None, None])
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, kg, vg, attn_mask=mask[:, None]
    ), 10)
    nbytes, flops = R.paged_prefill_cost(b, h, cs, d, kvh, starts, kv_lens,
                                         table.numel())
    main = dict(
        name="pasa_paged_prefill", route="cuda",
        source="src/repro_torch/kernels/csrc/pasa_paged_prefill.cu",
        replaces="src/repro/kernels/pasa_paged_prefill.py:368",
        max_abs_err=max_err, rmse=rmse, rmse_plain=rmse_plain,
        max_abs_err_cpu_plain=err_cpu,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **R.bound(nbytes, flops),
    )

    def pad_row_zero(policy):
        run = ops.pasa_paged_prefill(q, kp, vp, table, start, kv_len,
                                     beta=0.0, policy=policy)
        if run[3].abs().max() != 0:
            raise AssertionError(f"prefill pad row not zero ({policy.name})")
        return {"pad_row_zero": True}

    qa = _caster(q)          # q at the policy's input dtype
    modes = _new_mode_entries(
        "pasa_paged_prefill",
        lambda policy, beta: ops.pasa_paged_prefill(
            *qa(policy), kp, vp, table, start, kv_len, beta=beta,
            policy=policy),
        lambda policy, beta: mod.paged_prefill_plain(
            *qa(policy), kp, vp, table, start, kv_len, beta=beta,
            policy=policy),
        gold, PREFILL_TOL, RMSE_MAX,
        _sdpa_at((q, kg, vg), attn_mask=mask[:, None]), nbytes,
        flops, rows=slice(0, 3), extra=pad_row_zero)
    return [main, *modes]


def _quantize_pool(kp, vp, table, kv_lens, dtype):
    """Quantize a fixture's pool per page with the port's quantize_kv_page
    (valid rows only; dead pages all invalid).  Returns (k codes, v codes,
    sidecars, valid (P, page) bool)."""
    import torch

    from repro_torch.runtime.paged_cache import quantize_kv_page

    page = kp.shape[1]
    valid = torch.zeros(kp.shape[:2], dtype=torch.bool, device=kp.device)
    tab = table.cpu().tolist()
    for b, n in enumerate(kv_lens):
        for j in range(math.ceil(n / page)):
            valid[tab[b][j], :min(page, n - j * page)] = True
    kq, ks, kh = quantize_kv_page(kp, valid, dtype)
    vq, vs, vh = quantize_kv_page(vp, valid, dtype)
    return kq, vq, dict(k_scale=ks, k_shift=kh, v_scale=vs, v_shift=vh), valid


def _poison(kq, vq, quant, valid):
    """The same pool with debris: codes past kv_len NaN (fp8) or 127
    (int8), every sidecar of a page with no valid row NaN."""
    import torch

    bad = float("nan") if kq.dtype == torch.float8_e4m3fn else 127.0
    stale = ~valid[..., None, None]
    kq2, vq2 = (torch.where(stale, bad, x.float()).to(x.dtype) for x in (kq, vq))
    dead = ~valid.any(1)
    q2 = {}
    for name, x in quant.items():
        q2[name] = torch.where(dead.reshape((-1,) + (1,) * (x.dim() - 1)),
                               float("nan"), x)
    return kq2, vq2, q2


def _mode_entry(name, per_mode, keys):
    """One entry for the other modes of a kernel in the ``kernels`` line
    (the quantized pools of the paged kernels, the other operand modes and
    block of shift-KV): kernel, plain and library times and the bound all
    of the mode whose kernel is slowest, the larger error and launch count
    (each mode's numbers under ``by_mode``)."""
    slower = max(per_mode, key=lambda k: k["ms"])
    entry = {key: slower[key] for key in keys}
    entry["name"] = f"{name}/" + "|".join(
        k["name"].partition("/")[2] for k in per_mode)
    for key in ("launches", "max_abs_err"):
        entry[key] = max(k[key] for k in per_mode)
    entry["by_mode"] = {
        k["name"].partition("/")[2]: {key: k[key] for key in (
            "launches", "max_abs_err", "ms", "plain_ms", "library_ms",
            "bound_ms")}
        for k in per_mode}
    return entry


def _quant_mode_entry(name, dtype, held, ms, plain_ms, lib_ms, nbytes, flops):
    source, replaces = _kernel_source(f"{name}/{dtype}")
    return dict(
        name=f"{name}/{dtype}", route="cuda", source=source,
        replaces=replaces,
        max_abs_err=held["max_abs_err_fp16"], rmse=held["rmse_fp16"],
        detail=held, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **R.bound(nbytes, flops),
    )


def _check_quant_policies(name, run, plain_of, gold, raw_fp16, dtype, tol,
                          rows=slice(None)):
    """Kernel vs plain version on the card under every policy the kernels
    run, and relative RMSE vs float64 attention on the unquantized K/V:
    within the dtype's bound at fp32 (the reference's own bar), bf16_fp32
    and fp16_fp32, within max(2 x the raw pool's RMSE, the bound) at
    fp16.  Returns the report and the fp16 output."""
    import torch

    from repro_torch.core.precision import BF16_FP32, FP16, FP16_FP32, FP32

    held = {}
    bound = QUANT_RMSE_BOUND[dtype]
    raw_rmse = _rel_rmse(raw_fp16[rows], gold)
    for tag, policy in (("fp32", FP32), ("bf16_fp32", BF16_FP32),
                        ("fp16_fp32", FP16_FP32), ("fp16", FP16)):
        got, plain = run(policy), plain_of(policy)
        torch.cuda.synchronize()
        held[f"max_abs_err_{tag}"] = _close(f"{name}/{dtype} ({tag})", got,
                                            plain, **tol)
        rmse, rmse_plain = _rel_rmse(got[rows], gold), _rel_rmse(plain[rows], gold)
        limit = bound if tag != "fp16" else max(2.0 * raw_rmse, bound)
        if not (rmse <= limit and rmse_plain <= limit):
            raise AssertionError(f"{name}/{dtype} ({tag}) RMSE {rmse:.4f} / "
                                 f"plain {rmse_plain:.4f} > {limit:.4f}")
        held[f"rmse_{tag}"] = rmse
        held[f"rmse_plain_{tag}"] = rmse_plain
    held["rmse_raw_pool_fp16"] = raw_rmse
    return held, got


def check_decode_quant(dev, dtype):
    """The quantized mode of the paged decode kernel on the decode fixture
    quantized per page (queries of mean 0)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops
    mod = _kernel_module("pasa_paged_decode")

    kvh, g, d, page = 4, 7, 128, 128
    b = len(DECODE_KV_LENS)
    rng, kp, vp, table, kv_len, gold_of = _decode_fixture(dev)
    q = torch.from_numpy(
        rng.standard_normal((b, kvh, g, d)).astype(np.float32)
    ).to(device=dev, dtype=torch.float16)
    kq, vq, quant, valid = _quantize_pool(kp, vp, table, DECODE_KV_LENS, dtype)
    run = lambda policy, kq=kq, vq=vq, quant=quant: ops.pasa_paged_decode(
        q, kq, vq, table, kv_len, beta=BETA, policy=policy, **quant)
    plain_of = lambda policy: mod.paged_decode_plain(
        q, kq, vq, table, kv_len, beta=BETA, policy=policy, block_kv=page,
        **quant)
    raw = ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                policy=FP16)
    held, got = _check_quant_policies("pasa_paged_decode", run, plain_of,
                                      gold_of(q), raw, dtype, DECODE_TOL)
    kq2, vq2, quant2 = _poison(kq, vq, quant, valid)
    if not torch.equal(run(FP16, kq2, vq2, quant2), got):
        raise AssertionError(f"pasa_paged_decode/{dtype}: debris past kv_len "
                             f"or dead-page sidecars changed the output")
    held["debris_inert"] = True

    ms = _cuda_time_ms(lambda: run(FP16), 50)
    plain_ms = _cuda_time_ms(lambda: plain_of(FP16), 3, warmup=1)
    # yardstick: SDPA over the gathered, already dequantized K/V (neither
    # the gather nor the dequantization is timed)
    mp = table.shape[1]
    kg, vg = (
        torch.nan_to_num(mod._gather_dequant(
            x, quant[f"{side}_scale"], quant[f"{side}_shift"], table,
            torch.float16).reshape(b, mp * page, kvh, d).movedim(1, 2)
        ).repeat_interleave(g, 1)
        for side, x in (("k", kq), ("v", vq))
    )
    mask = (torch.arange(mp * page, device=dev)[None, :] < kv_len[:, None])
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q.reshape(b, kvh * g, 1, d), kg, vg, attn_mask=mask[:, None, None, :]
    ), 20)
    nbytes, flops = R.paged_decode_cost(b, kvh, g, d, DECODE_KV_LENS,
                                        table.numel(), kv_itemsize=1,
                                        page=page)
    entry = _quant_mode_entry("pasa_paged_decode", dtype, held, ms, plain_ms,
                              lib_ms, nbytes, flops)
    entry.update(_serve_shape_decode(dev, dtype))
    return entry


def check_prefill_quant(dev, dtype):
    """The quantized mode of the paged prefill kernel on the prefill
    fixture quantized per page."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops
    from repro_torch.kernels.pasa_paged_decode import _gather_dequant
    mod = _kernel_module("pasa_paged_prefill")

    h, kvh, d, page, cs = 28, 4, 128, 128, PREFILL_CHUNK
    starts, kv_lens = PREFILL_ROWS
    b = len(starts)
    q, kp, vp, table, start, kv_len = _prefill_fixture(dev)
    kq, vq, quant, valid = _quantize_pool(kp, vp, table, kv_lens, dtype)
    run = lambda policy, kq=kq, vq=vq, quant=quant: ops.pasa_paged_prefill(
        q, kq, vq, table, start, kv_len, beta=BETA, policy=policy, **quant)
    plain_of = lambda policy: mod.paged_prefill_plain(
        q, kq, vq, table, start, kv_len, beta=BETA, policy=policy, **quant)
    raw = ops.pasa_paged_prefill(q, kp, vp, table, start, kv_len, beta=BETA,
                                 policy=FP16)
    held, got = _check_quant_policies(
        "pasa_paged_prefill", run, plain_of, _prefill_gold(q, kp, vp, table),
        raw, dtype, PREFILL_TOL, rows=slice(0, 3))
    if got[3].abs().max() != 0:
        raise AssertionError(f"pasa_paged_prefill/{dtype}: pad row not zero")
    kq2, vq2, quant2 = _poison(kq, vq, quant, valid)
    if not torch.equal(run(FP16, kq2, vq2, quant2), got):
        raise AssertionError(f"pasa_paged_prefill/{dtype}: debris past kv_len "
                             f"or dead-page sidecars changed the output")
    held["debris_inert"] = True

    ms = _cuda_time_ms(lambda: run(FP16), 20)
    plain_ms = _cuda_time_ms(lambda: plain_of(FP16), 3, warmup=1)
    mp = table.shape[1]
    kg, vg = (
        torch.nan_to_num(_gather_dequant(
            x, quant[f"{side}_scale"], quant[f"{side}_shift"], table,
            torch.float16).reshape(b, mp * page, kvh, d).movedim(1, 2)
        ).repeat_interleave(h // kvh, 1)
        for side, x in (("k", kq), ("v", vq))
    )
    col = torch.arange(mp * page, device=dev)
    qpos = start[:, None] + torch.arange(cs, device=dev)[None, :]
    mask = (col[None, None, :] <= qpos[:, :, None]) & (
        col[None, None, :] < kv_len[:, None, None])
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, kg, vg, attn_mask=mask[:, None]), 10)
    nbytes, flops = R.paged_prefill_cost(b, h, cs, d, kvh, starts, kv_lens,
                                         table.numel(), kv_itemsize=1,
                                         page=page)
    return _quant_mode_entry("pasa_paged_prefill", dtype, held, ms, plain_ms,
                             lib_ms, nbytes, flops)


def _randn(rng, shape, mean, dev, dtype):
    import numpy as np
    import torch

    x = rng.standard_normal(shape).astype(np.float32) + mean
    return torch.from_numpy(x).to(device=dev, dtype=dtype)


def check_shift_kv(dev):
    """The shift kernel in each of its modes at the dense prefill's keys
    (4, 4, 1024, 128), bf16 (B, S, KVH, D) read through strides (fp16 in
    the fp16-keys modes): the path's own (bf16 keys under fp16 operands,
    block 128) first, then fp16 keys and the bf16_fp32 policy's bf16
    operands, each at blocks 128 and 64.  Each against its plain version
    and the float64 product with the same rounded M; the fp16 modes also
    against the float64 algebraic shift (bf16's M rounds beta far enough
    to move that one: its plain version's figure is reported beside it).
    Timed beside torch.matmul(M, K blocks) on contiguous keys at the
    operand dtype and the bytes bound."""
    import numpy as np
    import torch

    from repro_torch.core.precision import BF16_FP32, FP16
    from repro_torch.core.shifting import shift_kv_reference
    from repro_torch.kernels import ops
    mod = _kernel_module("shift_kv")

    b, _, kvh, s, d = ATTN_SHAPE
    rng = np.random.default_rng(3)
    keys = _randn(rng, (b, s, kvh, d), 5.0, dev, torch.float32)
    modes = []
    for block in (128, 64):
        for tag, kdt, policy in (("", torch.bfloat16, FP16),
                                 ("fp16_keys", torch.float16, FP16),
                                 ("bf16_fp32", torch.bfloat16, BF16_FP32)):
            tag = "_".join(x for x in (tag, "" if block == 128 else
                                       f"block{block}") if x)
            op = policy.input_dtype
            k = keys.to(kdt).transpose(1, 2)
            m = mod.device_matrix(block, d, BETA, op, dev)
            run = lambda k=k, block=block, policy=policy: ops.shift_kv(
                k, beta=BETA, block_kv=block, policy=policy)
            plain_of = lambda k=k, m=m, block=block, op=op: mod.shift_kv_plain(
                m, k.to(op), block, out_dtype=op)
            got, plain = run(), plain_of()
            torch.cuda.synchronize()
            name = "shift_kv" + (f"/{tag}" if tag else "")
            max_err = _close(name, got, plain, **SHIFT_TOL)
            kb = k.to(op).contiguous().reshape(b, kvh, s // block, block, d)
            gold = torch.matmul(m.double(), kb.double()).reshape(got.shape)
            rmse = _rel_rmse(got, gold)
            ref = shift_kv_reference(k.to(op), d, BETA, block)
            rmse_alg, rmse_alg_plain = _rel_rmse(got, ref), _rel_rmse(plain, ref)
            if not rmse < SHIFT_RMSE_MAX or (
                    op == torch.float16 and not rmse_alg < SHIFT_RMSE_MAX):
                raise AssertionError(f"{name} RMSE {rmse:.2e} vs float64 "
                                     f"(algebraic shift {rmse_alg:.2e})")
            ms = _cuda_time_ms(run, 50)
            plain_ms = _cuda_time_ms(plain_of, 20)
            lib_ms = _cuda_time_ms(lambda m=m, kb=kb: torch.matmul(m, kb), 50)
            nbytes, flops = R.shift_kv_cost(k.numel(), k.element_size(),
                                            block)
            modes.append(dict(
                name=name, mode=mod.mode_name(kdt, op, block), route="cuda",
                source="src/repro_torch/kernels/csrc/shift_kv.cu",
                replaces="src/repro/kernels/shift_kv.py:48",
                max_abs_err=max_err, rmse=rmse, rmse_algebraic=rmse_alg,
                rmse_algebraic_plain=rmse_alg_plain, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, **R.bound(nbytes, flops),
            ))
    return modes


def _gold_attention(q, k, v, causal):
    """float64 softmax(q k^T / sqrt(d)) v, K/V expanded to q's heads, one
    batch row at a time (bounded memory)."""
    import torch

    g = q.shape[1] // k.shape[1]
    outs = []
    for i in range(q.shape[0]):
        qq = q[i].double()
        kk = k[i].double().repeat_interleave(g, 0)
        vv = v[i].double().repeat_interleave(g, 0)
        sc = qq @ kk.transpose(-1, -2) / math.sqrt(q.shape[-1])
        if causal:
            n = sc.shape[-1]
            sc = sc.masked_fill(
                torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1),
                -math.inf)
        outs.append(torch.softmax(sc, -1) @ vv)
    return torch.stack(outs)


def check_attention(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16, FP16_FP32
    from repro_torch.core.shifting import effective_invariance
    from repro_torch.kernels import ops
    mod = _kernel_module("pasa_attention")

    b, h, kvh, s, d = ATTN_SHAPE
    rng = np.random.default_rng(4)
    half = torch.float16
    k = _randn(rng, (b, kvh, s, d), 2.0, dev, half)
    v = _randn(rng, (b, kvh, s, d), 0.0, dev, half)
    report = {}
    # the held fixture has queries of mean 0; queries of mean 2 as well
    # (the reference's test_kernels fixture at 1/1000 of this size) are
    # reported only: there sbar ~ 0.7, one fp16 ulp of sbar moves a
    # block's weight by exp(inva * ulp) ~ 3 %, and the two GEMM summation
    # orders round a few sbar values apart
    for q_mean in (2.0, 0.0):
        q = _randn(rng, (b, h, s, d), q_mean, dev, half)
        for causal, tol in ((False, ATTN_TOL), (True, ATTN_CAUSAL_TOL)):
            got = ops.pasa_attention(q, k, v, beta=BETA, policy=FP16,
                                     causal=causal)
            plain = mod.attention_plain(q, k, v, beta=BETA, policy=FP16,
                                        block_kv=128, causal=causal)
            torch.cuda.synchronize()
            tag = ("causal" if causal else "full") + (
                "" if q_mean == 0.0 else f"_q_mean_{q_mean:g}")
            gold = _gold_attention(q, k, v, causal)
            report[f"rmse_{tag}"] = _rel_rmse(got, gold)
            report[f"rmse_plain_{tag}"] = _rel_rmse(plain, gold)
            del gold
            if q_mean != 0.0:
                err = (got.float() - plain.float()).abs()
                report[f"max_abs_err_{tag}"] = float(err.max())
                report[f"outside_tol_{tag}"] = int(
                    (err > tol["atol"] + tol["rtol"] * plain.float().abs())
                    .sum())
                continue
            report[f"max_abs_err_{tag}"] = _close(
                f"pasa_attention ({tag})", got, plain, **tol)
            if not report[f"rmse_{tag}"] < ATTN_RMSE_MAX:
                raise AssertionError(f"pasa_attention ({tag}) RMSE "
                                     f"{report[f'rmse_{tag}']:.4f}")
    # FlashAttention-2 at fp16_fp32 on zero-mean inputs (the reference's
    # flash test) against its plain version
    qf = _randn(rng, (b, h, s, d), 0.0, dev, half)
    kf = _randn(rng, (b, kvh, s, d), 0.0, dev, half)
    got = ops.flash_attention(qf, kf, v, policy=FP16_FP32, causal=True)
    plain = mod.attention_plain(qf, kf, v, beta=0.0, policy=FP16_FP32,
                                block_kv=128, causal=True)
    torch.cuda.synchronize()
    report["flash_max_abs_err"] = _close("flash_attention", got, plain,
                                         **FLASH_TOL)
    report["flash_ms"] = _cuda_time_ms(lambda: ops.flash_attention(
        qf, kf, v, policy=FP16_FP32, causal=True), 20)
    # the paper's headline on the card: inputs near 30 overflow the fp16
    # score store of FlashAttention-2; PASA at all-fp16 stays finite
    u = lambda: torch.from_numpy(rng.uniform(29.5, 30.5, (1, 2, 256, 128))
                                 .astype(np.float32)).to(dev, half)
    qo, ko, vo = u(), u(), u()
    bad = ops.flash_attention(qo, ko, vo, policy=FP16_FP32)
    good = ops.pasa_attention(qo, ko, vo, beta=BETA, policy=FP16)
    if bool(torch.isfinite(bad.float()).all()):
        raise AssertionError("FlashAttention-2 at fp16 did not overflow")
    if not bool(torch.isfinite(good.float()).all()):
        raise AssertionError("PASA at fp16 is not finite on inputs near 30")
    report["overflow_headline"] = "flash non-finite, pasa finite"

    # times on the path's call: the causal prefill; `ms` is the attention
    # kernel alone on the shifted keys, the plain version includes the
    # shift as ops.pasa_attention's oracle does
    k_sh = ops.shift_kv(k, beta=BETA, policy=FP16)
    inva = effective_invariance(128, d, BETA, torch.float16)
    ms = _cuda_time_ms(lambda: mod.kernel_call(
        q, k_sh, v, beta=BETA, inva=inva, policy=FP16, causal=True,
        block_q=128, block_kv=128), 20)
    plain_ms = _cuda_time_ms(lambda: mod.attention_plain(
        q, k, v, beta=BETA, policy=FP16, block_kv=128, causal=True), 3,
        warmup=1)
    ke, ve = (x.repeat_interleave(h // kvh, 1) for x in (k_sh, v))
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, is_causal=True), 20)
    nbytes, flops = R.attention_cost(b, h, s, kvh, s, d, causal=True)
    main = dict(
        name="pasa_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/pasa_attention.cu",
        replaces="src/repro/kernels/pasa_attention.py:218",
        max_abs_err=report["max_abs_err_causal"], rmse=report["rmse_causal"],
        rmse_plain=report["rmse_plain_causal"], detail=report,
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **R.bound(nbytes, flops),
    )

    # the new modes on the causal prefill, queries of mean 0: q, K, V
    # at the policy's input dtype before the calls, so ``ms`` at beta 0
    # is the FA2 kernel alone and ``ms_pasa`` shift-KV + the PASA kernel
    args = _caster(q, k, v)

    def run(policy, beta):
        if beta == 0.0:
            return ops.flash_attention(*args(policy), policy=policy,
                                       causal=True)
        return ops.pasa_attention(*args(policy), beta=beta, policy=policy,
                                  causal=True)

    def overflow_finite(policy):
        # inputs near 30: the fp32 score store keeps FA2 finite
        out = ops.flash_attention(qo, ko, vo, policy=policy)
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"FlashAttention-2 at {policy.name} is not "
                                 f"finite on inputs near 30")
        return {"overflow_headline": "flash finite"}

    ke = k.repeat_interleave(h // kvh, 1)
    ve = v.repeat_interleave(h // kvh, 1)
    modes = _new_mode_entries(
        "pasa_attention", run,
        lambda policy, beta: mod.attention_plain(
            *args(policy), beta=beta, policy=policy, block_kv=128,
            causal=True),
        _gold_attention(q, k, v, True), ATTN_CAUSAL_TOL, ATTN_RMSE_MAX,
        _sdpa_at((q, ke, ve), is_causal=True), nbytes, flops,
        extra=overflow_finite)
    return [main, *modes]


def check_contiguous_decode(dev):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops
    mod = _kernel_module("pasa_decode")

    kvh, g, d, block = 4, 7, 128, 128
    lens = DECODE_KV_LENS
    b, s2 = len(lens), max(lens) + 1
    rng = np.random.default_rng(5)
    # the dense route's cache: bf16 (B, S2, KVH, D), NaN past kv_len
    kc = rng.standard_normal((b, s2, kvh, d)).astype(np.float32) + 30.0
    vc = rng.standard_normal((b, s2, kvh, d)).astype(np.float32)
    for i, n in enumerate(lens):
        kc[i, n:] = np.nan
        vc[i, n:] = np.nan
    to = lambda a: torch.from_numpy(a).to(dev, torch.bfloat16)
    kc_t, vc_t = to(kc), to(vc)
    kview, vview = kc_t.transpose(1, 2), vc_t.transpose(1, 2)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    run = lambda q: ops.pasa_decode(q, kview, vview, kv_len, beta=BETA,
                                    policy=FP16, block_kv=block)
    plain_of = lambda q: mod.decode_plain(q, kview, vview, kv_len, beta=BETA,
                                          policy=FP16, block_kv=block)

    # the same rows in a shuffled page pool
    n_pages = [math.ceil(n / block) for n in lens]
    ids = rng.permutation(np.arange(1, 1 + sum(n_pages)))
    kp = torch.full((1 + sum(n_pages), block, kvh, d), float("nan"),
                    dtype=torch.bfloat16, device=dev)
    vp = kp.clone()
    table = np.zeros((b, max(n_pages)), np.int32)
    nxt = 0
    for i, npg in enumerate(n_pages):
        for j in range(npg):
            pid = int(ids[nxt])
            nxt += 1
            table[i, j] = pid
            rows = min(block, s2 - j * block)
            kp[pid, :rows] = kc_t[i, j * block:j * block + rows]
            vp[pid, :rows] = vc_t[i, j * block:j * block + rows]
    table = torch.from_numpy(table).to(dev)

    report = {}
    for q_mean in (1.0, 0.0):       # the held fixture last: timed below
        q = _randn(rng, (b, kvh, g, d), q_mean, dev, torch.float16)
        got = run(q)
        plain = plain_of(q)
        paged = ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                      policy=FP16)
        # the sequential walk: the oracle of both cluster kernels
        walk = mod._walk_call(q, kview, vview, kv_len, beta=BETA,
                              policy=FP16, block_kv=block)
        torch.cuda.synchronize()
        for name, other in (("the walk", walk), ("paged decode", paged)):
            if not torch.equal(got, other):
                diff = float((got.float() - other.float()).abs().max())
                raise AssertionError(
                    f"contiguous decode != {name} (q mean {q_mean}): max "
                    f"diff {diff:.3e}")
        if not torch.equal(paged, walk):
            raise AssertionError(f"paged decode != the walk (q mean {q_mean})")
        golds = []
        for i, n in enumerate(lens):
            kk = torch.from_numpy(kc[i, :n]).to(dev).to(torch.bfloat16)
            vv = torch.from_numpy(vc[i, :n]).to(dev).to(torch.bfloat16)
            sc = q[i].double() @ kk.double().permute(1, 2, 0) / math.sqrt(d)
            golds.append(torch.softmax(sc, -1) @ vv.double().transpose(0, 1))
        gold = torch.stack(golds)
        rmse, rmse_plain = _rel_rmse(got, gold), _rel_rmse(plain, gold)
        if not (rmse < RMSE_MAX and rmse_plain < RMSE_MAX):
            raise AssertionError(
                f"contiguous decode RMSE {rmse:.4f} / plain {rmse_plain:.4f}")
        if q_mean == 0.0:
            max_err = _close("pasa_decode", got, plain, **DECODE_TOL)
            report.update(rmse=rmse, rmse_plain=rmse_plain)
        else:
            report["stress"] = dict(
                q_mean=q_mean, rmse=rmse, rmse_plain=rmse_plain,
                max_abs_err=float((got.float() - plain.float()).abs().max()))
    # the op's defaults: block 256 (the reference's), beta and policy
    got = ops.pasa_decode(q, kview, vview, kv_len)
    plain = mod.decode_plain(q, kview, vview, kv_len, beta=BETA, policy=FP16,
                             block_kv=256)
    walk = mod._walk_call(q, kview, vview, kv_len, beta=BETA, policy=FP16,
                          block_kv=256)
    torch.cuda.synchronize()
    if not torch.equal(got, walk):
        raise AssertionError("contiguous decode at block 256 != the walk")
    report["block_256"] = dict(
        max_abs_err=_close("pasa_decode (block 256)", got, plain, **DECODE_TOL),
        rmse=_rel_rmse(got, gold), rmse_plain=_rel_rmse(plain, gold),
        walk_bit_equal=True,
        ms=_cuda_time_ms(lambda: ops.pasa_decode(q, kview, vview, kv_len), 50),
        walk_ms=_cuda_time_ms(lambda: mod._walk_call(
            q, kview, vview, kv_len, beta=BETA, policy=FP16, block_kv=256), 50))
    if not report["block_256"]["rmse"] < RMSE_MAX:
        raise AssertionError(
            f"contiguous decode at block 256 RMSE {report['block_256']['rmse']:.4f}")
    ms = _cuda_time_ms(lambda: run(q), 50)
    plain_ms = _cuda_time_ms(lambda: plain_of(q), 3, warmup=1)
    ke, ve = (torch.nan_to_num(x.half()).repeat_interleave(g, 1)
              for x in (kview, vview))
    mask = (torch.arange(s2, device=dev)[None, :] < kv_len[:, None])
    qh = q.reshape(b, kvh * g, 1, d)
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh, ke, ve, attn_mask=mask[:, None, None, :]), 20)
    walk_ms = _cuda_time_ms(lambda: mod._walk_call(
        q, kview, vview, kv_len, beta=BETA, policy=FP16, block_kv=block), 50)
    nbytes, flops = R.decode_cost(b, kvh, g, d, lens)
    main = dict(
        name="pasa_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/pasa_decode.cu",
        replaces="src/repro/kernels/pasa_decode.py:268",
        max_abs_err=max_err, walk_and_paged_bit_equal=True, ms=ms,
        walk_ms=walk_ms, plain_ms=plain_ms, library_ms=lib_ms,
        detail=report.pop("block_256"), **report,
        **_serve_shape_contiguous_decode(dev), **R.bound(nbytes, flops),
    )

    def bit_equal(policy):
        """contiguous == walk == paged at block 128, contiguous == walk at
        the op's default block 256, PASA and FlashAttention-2."""
        qp = q.to(policy.input_dtype)
        for beta in (0.0, BETA):
            for blk in (block, 256):
                got = ops.pasa_decode(q, kview, vview, kv_len, beta=beta,
                                      policy=policy, block_kv=blk)
                walk = mod._walk_call(qp, kview, vview, kv_len, beta=beta,
                                      policy=policy, block_kv=blk)
                others = [("the walk", walk)]
                if blk == block:
                    others.append(("paged decode", ops.pasa_paged_decode(
                        q, kp, vp, table, kv_len, beta=beta, policy=policy)))
                for what, other in others:
                    if not torch.equal(got, other):
                        raise AssertionError(
                            f"contiguous decode ({policy.name}, beta {beta}, "
                            f"block {blk}) != {what}")
        return {"walk_and_paged_bit_equal": True}

    modes = _new_mode_entries(
        "pasa_decode",
        lambda policy, beta: ops.pasa_decode(
            q, kview, vview, kv_len, beta=beta, policy=policy,
            block_kv=block),
        lambda policy, beta: mod.decode_plain(
            q, kview, vview, kv_len, beta=beta, policy=policy,
            block_kv=block),
        gold, DECODE_TOL, RMSE_MAX,
        _sdpa_at((qh, ke, ve), attn_mask=mask[:, None, None, :]), nbytes,
        flops, extra=bit_equal)
    return [main, *modes]


def _serve_shape_contiguous_decode(dev):
    """The contiguous decode kernel at the dense serve's own decode call:
    batch 4 at kv DENSE_PROMPT + 2 in a cache of DENSE_PROMPT + SERVE_GEN +
    8 rows (bf16 (B, S2, KVH, D), read through strides), G 7, block 128;
    kernel and SDPA (on the expanded K/V, not timed) ms."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops

    kvh, g, d = 4, 7, 128
    b, s2, n = DENSE_BATCH, DENSE_PROMPT + SERVE_GEN + 8, DENSE_PROMPT + 2
    rng = np.random.default_rng(7)
    kc = _randn(rng, (b, s2, kvh, d), 2.0, dev, torch.bfloat16).transpose(1, 2)
    vc = _randn(rng, (b, s2, kvh, d), 0.0, dev, torch.bfloat16).transpose(1, 2)
    q = _randn(rng, (b, kvh, g, d), 0.0, dev, torch.float16)
    kv_len = torch.full((b,), n, dtype=torch.int32, device=dev)
    ms = _cuda_time_ms(lambda: ops.pasa_decode(
        q, kc, vc, kv_len, beta=BETA, policy=FP16, block_kv=128), 50)
    ke, ve = (x[:, :, :n].half().repeat_interleave(g, 1) for x in (kc, vc))
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q.reshape(b, kvh * g, 1, d), ke, ve), 20)
    return dict(serve_shape_ms=ms, serve_shape_library_ms=lib_ms)


def check_decode_hd64(dev):
    """Both decode kernels at head_dim 64, at zamba2's shape (KVH 32, G 1)
    and a GQA group (KVH 4, G 8): the decode fixture's lengths (kv_len
    DECODE_KV_LENS, NaN past kv_len, keys of mean 30, queries of mean 0)
    in a shuffled bf16 page pool, and the same rows as a (B, S2, KVH, D)
    cache read through strides.  Under the four policies at beta 0 and
    BETA: paged decode and contiguous decode (blocks 128 and 256) against
    their plain versions (DECODE_TOL) and float64 (RMSE_MAX); contiguous
    == paged == the walk at block 128, contiguous == the walk at 256, bit
    for bit.  The paged kernel from int8 and fp8_e4m3 pools under the four
    policies (the quantized bars of ``_check_quant_policies``), debris
    inert.  Times at zamba2's shape (fp16 policy, BETA): both kernels,
    their plain versions, SDPA at the same shape, and the contiguous kernel
    at the hybrid serve's decode call (batch 4, kv HYBRID_PROMPT + 1 in a
    HYBRID_MAX_LEN-row cache, block 128).  Returns the two kernels'
    ``/d64`` entries."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import BF16_FP32, FP16, FP16_FP32, FP32
    from repro_torch.kernels import ops
    cmod = _kernel_module("pasa_decode")
    pmod = _kernel_module("pasa_paged_decode")

    d, page = 64, 128
    lens = DECODE_KV_LENS
    b = len(lens)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(8)
    detail = {"pasa_decode": {}, "pasa_paged_decode": {}}
    errs = {"pasa_decode": [], "pasa_paged_decode": []}
    for kvh, g in HD64_SHAPES:
        tag = f"kvh{kvh}_g{g}"
        kp, vp, table = _paged_pool(rng, lens, kvh, d, page, 30.0, 3, dev)
        n = table.shape[1] * page
        kc = kp[table.long()].reshape(b, n, kvh, d)
        vc = vp[table.long()].reshape(b, n, kvh, d)
        kview, vview = kc.transpose(1, 2), vc.transpose(1, 2)
        q = _randn(rng, (b, kvh, g, d), 0.0, dev, torch.float16)
        gold = []
        for i, n_i in enumerate(lens):
            kk, vv = _gathered(kp, table[i], n_i), _gathered(vp, table[i], n_i)
            sc = q[i].double() @ kk.transpose(-1, -2) / math.sqrt(d)
            gold.append(torch.softmax(sc, -1) @ vv)
        gold = torch.stack(gold)
        rmse = {}
        for policy in (FP16, FP16_FP32, FP32, BF16_FP32):
            qp = q.to(policy.input_dtype)
            for beta in (0.0, BETA):
                case = f"{tag} {policy.name} beta {beta}"
                paged = ops.pasa_paged_decode(q, kp, vp, table, kv_len,
                                              beta=beta, policy=policy)
                outs = {"pasa_paged_decode": (paged, pmod.paged_decode_plain(
                    q, kp, vp, table, kv_len, beta=beta, policy=policy,
                    block_kv=page))}
                for block in (page, 256):
                    got = ops.pasa_decode(q, kview, vview, kv_len, beta=beta,
                                          policy=policy, block_kv=block)
                    walk = cmod._walk_call(qp, kview, vview, kv_len,
                                           beta=beta, policy=policy,
                                           block_kv=block)
                    torch.cuda.synchronize()
                    if not torch.equal(got, walk):
                        raise AssertionError(f"pasa_decode/d64 ({case}, block "
                                             f"{block}) != the walk")
                    if block == page and not torch.equal(got, paged):
                        raise AssertionError(f"pasa_decode/d64 ({case}) != "
                                             f"paged decode")
                    outs[f"pasa_decode@{block}"] = (got, cmod.decode_plain(
                        q, kview, vview, kv_len, beta=beta, policy=policy,
                        block_kv=block))
                for key, (got, plain) in outs.items():
                    name = key.partition("@")[0]
                    if got.dtype != policy.out_dtype:
                        raise AssertionError(f"{key}/d64 ({case}): {got.dtype}")
                    errs[name].append(_close(f"{key}/d64 ({case})", got, plain,
                                             **DECODE_TOL))
                    r, rp = _rel_rmse(got, gold), _rel_rmse(plain, gold)
                    if not (r < RMSE_MAX and rp < RMSE_MAX):
                        raise AssertionError(f"{key}/d64 ({case}) RMSE {r:.4f}"
                                             f" / plain {rp:.4f}")
                    rmse[f"{key} {policy.name} beta {beta}"] = r
        detail["pasa_decode"][tag] = dict(
            walk_and_paged_bit_equal=True,
            rmse_max=max(v for k, v in rmse.items() if k.startswith("pasa_decode")))
        quant = {}
        raw = ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                    policy=FP16)
        for dtype in QUANT_DTYPES:
            kq, vq, sc, valid = _quantize_pool(kp, vp, table, lens, dtype)
            run = lambda policy, kq=kq, vq=vq, sc=sc: ops.pasa_paged_decode(
                q, kq, vq, table, kv_len, beta=BETA, policy=policy, **sc)
            plain_of = lambda policy, kq=kq, vq=vq, sc=sc: \
                pmod.paged_decode_plain(q, kq, vq, table, kv_len, beta=BETA,
                                        policy=policy, block_kv=page, **sc)
            held, got = _check_quant_policies(
                f"pasa_paged_decode/d64 {tag}", run, plain_of, gold, raw,
                dtype, DECODE_TOL)
            kq2, vq2, sc2 = _poison(kq, vq, sc, valid)
            if not torch.equal(run(FP16, kq2, vq2, sc2), got):
                raise AssertionError(f"pasa_paged_decode/d64 {tag} {dtype}: "
                                     f"debris changed the output")
            held["debris_inert"] = True
            quant[dtype] = held
            errs["pasa_paged_decode"].append(held["max_abs_err_fp16"])
        detail["pasa_paged_decode"][tag] = dict(
            rmse_max=max(v for k, v in rmse.items()
                         if k.startswith("pasa_paged_decode")), quantized=quant)
        if (kvh, g) != HD64_SHAPES[0]:
            continue
        # times at zamba2's shape, fp16 PASA (the hybrid serve's mode)
        qh = q.reshape(b, kvh * g, 1, d)
        ke, ve = (torch.nan_to_num(x.half()).repeat_interleave(g, 1)
                  for x in (kview, vview))
        mask = (torch.arange(n, device=dev)[None, :] < kv_len[:, None])
        lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qh, ke, ve, attn_mask=mask[:, None, None, :]), 20)
        bound = R.bound(*R.decode_cost(b, kvh, g, d, lens))
        timed = {
            "pasa_decode": dict(
                ms=_cuda_time_ms(lambda: ops.pasa_decode(
                    q, kview, vview, kv_len, beta=BETA, policy=FP16,
                    block_kv=page), 50),
                ms_block_256=_cuda_time_ms(lambda: ops.pasa_decode(
                    q, kview, vview, kv_len, beta=BETA, policy=FP16,
                    block_kv=256), 50),
                walk_ms=_cuda_time_ms(lambda: cmod._walk_call(
                    q, kview, vview, kv_len, beta=BETA, policy=FP16,
                    block_kv=page), 50),
                plain_ms=_cuda_time_ms(lambda: cmod.decode_plain(
                    q, kview, vview, kv_len, beta=BETA, policy=FP16,
                    block_kv=page), 3, warmup=1),
                rmse=rmse[f"pasa_decode@{page} fp16 beta {BETA}"],
                **_serve_shape_hybrid_decode(dev), **bound),
            "pasa_paged_decode": dict(
                ms=_cuda_time_ms(lambda: ops.pasa_paged_decode(
                    q, kp, vp, table, kv_len, beta=BETA, policy=FP16), 50),
                plain_ms=_cuda_time_ms(lambda: pmod.paged_decode_plain(
                    q, kp, vp, table, kv_len, beta=BETA, policy=FP16,
                    block_kv=page), 3, warmup=1),
                rmse=rmse[f"pasa_paged_decode fp16 beta {BETA}"],
                **bound),
        }
    entries = []
    for name in ("pasa_paged_decode", "pasa_decode"):
        source, replaces = KERNEL_FILES[name]
        entries.append(dict(
            name=f"{name}/d64", route="cuda", source=source, replaces=replaces,
            max_abs_err=max(errs[name]), library_ms=lib_ms, detail=detail[name],
            **timed[name]))
    return entries


def _serve_shape_hybrid_decode(dev):
    """The contiguous decode kernel at head_dim 64 at the hybrid serve's
    decode call: batch HYBRID_BATCH at kv HYBRID_PROMPT + 1 in a
    HYBRID_MAX_LEN-row cache (bf16 (B, S2, KVH, D) read through strides),
    KVH 32, G 1, block 128; kernel and SDPA ms."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops

    kvh, d, b, n = 32, 64, HYBRID_BATCH, HYBRID_PROMPT + 1
    rng = np.random.default_rng(9)
    shape = (b, HYBRID_MAX_LEN, kvh, d)
    kc = _randn(rng, shape, 2.0, dev, torch.bfloat16).transpose(1, 2)
    vc = _randn(rng, shape, 0.0, dev, torch.bfloat16).transpose(1, 2)
    q = _randn(rng, (b, kvh, 1, d), 0.0, dev, torch.float16)
    kv_len = torch.full((b,), n, dtype=torch.int32, device=dev)
    ms = _cuda_time_ms(lambda: ops.pasa_decode(
        q, kc, vc, kv_len, beta=BETA, policy=FP16, block_kv=128), 50)
    ke, ve = (x[:, :, :n].half() for x in (kc, vc))
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q.reshape(b, kvh, 1, d), ke, ve), 20)
    return dict(serve_shape_ms=ms, serve_shape_library_ms=lib_ms)


def check_shift_kv_hd64(dev):
    """The shift kernel at head_dim 64 in each of its modes at the
    whisper encoder's keys (4, 20, 1536, 64), bf16 (B, S, KVH, D) read
    through strides (fp16 in the fp16-keys modes): the path's mode (bf16
    keys under fp16 operands, block 128) first, then fp16 keys and the
    bf16_fp32 policy's bf16 operands, each at blocks 128 and 64.  Each
    against its plain version (SHIFT_TOL) and the float64 product with the
    same M (relative RMSE SHIFT_RMSE_MAX; the fp16 modes also against the
    float64 algebraic shift).  Timed beside torch.matmul(M, K blocks) on
    contiguous keys at the operand dtype and the bytes bound.  Each entry
    names the launch counter key of its mode (``whisper_mode``)."""
    import numpy as np
    import torch

    from repro_torch.core.precision import BF16_FP32, FP16
    from repro_torch.core.shifting import shift_kv_reference
    from repro_torch.kernels import ops
    mod = _kernel_module("shift_kv")

    b, kvh, s, d = WHISPER_BATCH, 20, WHISPER_S2, 64
    rng = np.random.default_rng(10)
    keys = _randn(rng, (b, s, kvh, d), 5.0, dev, torch.float32)
    modes = []
    for block in (128, 64):
        for tag, kdt, policy in (("", torch.bfloat16, FP16),
                                 ("fp16_keys", torch.float16, FP16),
                                 ("bf16_fp32", torch.bfloat16, BF16_FP32)):
            tag = "_".join(x for x in ("d64", tag, "" if block == 128 else
                                       f"block{block}") if x)
            op = policy.input_dtype
            k = keys.to(kdt).transpose(1, 2)
            m = mod.device_matrix(block, d, BETA, op, dev)
            run = lambda k=k, block=block, policy=policy: ops.shift_kv(
                k, beta=BETA, block_kv=block, policy=policy)
            plain_of = lambda k=k, m=m, block=block, op=op: mod.shift_kv_plain(
                m, k.to(op), block, out_dtype=op)
            got, plain = run(), plain_of()
            torch.cuda.synchronize()
            name = f"shift_kv/{tag}"
            max_err = _close(name, got, plain, **SHIFT_TOL)
            kb = k.to(op).contiguous().reshape(b, kvh, s // block, block, d)
            gold = torch.matmul(m.double(), kb.double()).reshape(got.shape)
            rmse = _rel_rmse(got, gold)
            ref = shift_kv_reference(k.to(op), d, BETA, block)
            rmse_alg, rmse_alg_plain = _rel_rmse(got, ref), _rel_rmse(plain, ref)
            if not rmse < SHIFT_RMSE_MAX or (
                    op == torch.float16 and not rmse_alg < SHIFT_RMSE_MAX):
                raise AssertionError(f"{name} RMSE {rmse:.2e} vs float64 "
                                     f"(algebraic shift {rmse_alg:.2e})")
            nbytes, flops = R.shift_kv_cost(k.numel(), k.element_size(),
                                            block)
            modes.append(dict(
                name=name, whisper_mode=("shift_kv", mod.mode_name(
                    kdt, op, block, d)),
                route="cuda", source="src/repro_torch/kernels/csrc/shift_kv.cu",
                replaces="src/repro/kernels/shift_kv.py:48",
                max_abs_err=max_err, rmse=rmse, rmse_algebraic=rmse_alg,
                rmse_algebraic_plain=rmse_alg_plain,
                ms=_cuda_time_ms(run, 50), plain_ms=_cuda_time_ms(plain_of, 20),
                library_ms=_cuda_time_ms(lambda m=m, kb=kb: torch.matmul(m, kb),
                                         50),
                **R.bound(nbytes, flops),
            ))
    return modes


def _hd64_cases(rng, dev):
    """check_attention_hd64's inputs: {case: (q, k, v, kv_valid, causal,
    block_q)}, fp16, queries of mean 0 and keys of mean 2, rows past
    kv_valid zero (the attention layer's padding)."""
    import torch

    b, h, s, d = WHISPER_BATCH, 20, WHISPER_S2, 64
    pad = lambda x, n: torch.nn.functional.pad(x[:, :, :n], (0, 0, 0, s - n))
    q = _randn(rng, (b, h, s, d), 0.0, dev, torch.float16)
    k = _randn(rng, (b, h, s, d), 2.0, dev, torch.float16)
    v = _randn(rng, (b, h, s, d), 0.0, dev, torch.float16)
    n, edge = WHISPER_FRAMES, s - 128 + 1
    q1 = torch.nn.functional.pad(q[:, :, :1], (0, 0, 0, 63))
    return {
        "encoder": (pad(q, n), pad(k, n), pad(v, n), n, False, 128),
        "cross": (q1, pad(k, n), pad(v, n), n, False, 64),
        "edge": (pad(q, edge), pad(k, edge), pad(v, edge), edge, False, 128),
        "unmasked": (q, k, v, None, False, 128),
        "causal": (pad(q, n), pad(k, n), pad(v, n), n, True, 128),
    }


def check_attention_hd64(dev):
    """The attention kernel at head_dim 64 with the column limit, at the
    whisper encoder's shape (4, 20, 1536, 64): ``encoder`` (kv_valid 1500,
    rows past it zero), ``cross`` (one query row padded to 64 rows,
    block_q 64, against the same keys), ``edge`` (kv_valid S2 - block_kv +
    1), ``unmasked`` (no limit) and ``causal`` (kv_valid 1500, causal).
    Under the four policies at beta 0 (FlashAttention-2) and BETA: against
    the plain version (ATTN_TOL, causal ATTN_CAUSAL_TOL) on the real rows
    and within relative RMSE ATTN_RMSE_MAX of float64 attention on the
    unpadded keys.  Times at the encoder's and the cross-attention's calls
    (fp16 PASA, the path's mode): the attention kernel alone on the
    shifted keys, the plain version (with its shift), and SDPA on the
    unpadded 1,500 keys.  Returns the path's entry and one per other
    policy mode, each naming its launch counter key."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import get_policy
    from repro_torch.core.shifting import effective_invariance
    from repro_torch.kernels import ops
    from repro_torch.kernels.pasa_paged_decode import mode_name
    mod = _kernel_module("pasa_attention")

    rng = np.random.default_rng(11)
    cases = _hd64_cases(rng, dev)
    errs, rmse = {}, {}
    for case, (q, k, v, valid, causal, bq) in cases.items():
        n = q.shape[2] if case == "unmasked" else valid
        rows = 1 if case == "cross" else n
        gold = _gold_attention(q[:, :, :rows], k[:, :, :n], v[:, :, :n],
                               causal)
        tol = ATTN_CAUSAL_TOL if causal else ATTN_TOL
        for tag in ("fp16", "fp16_fp32", "fp32", "bf16_fp32"):
            policy = get_policy(tag)
            for beta in (0.0, BETA):
                kw = dict(policy=policy, block_q=bq, causal=causal,
                          kv_valid=valid)
                got = (ops.pasa_attention(q, k, v, beta=beta, **kw) if beta
                       else ops.flash_attention(q, k, v, **kw))
                plain = mod.attention_plain(q, k, v, beta=beta, policy=policy,
                                            block_kv=128, causal=causal,
                                            kv_valid=valid)
                torch.cuda.synchronize()
                label = f"pasa_attention/d64 ({case}, {tag}, beta {beta})"
                if got.dtype != policy.out_dtype:
                    raise AssertionError(f"{label}: output {got.dtype}")
                key = (tag, beta)
                errs[key] = max(errs.get(key, 0.0), _close(
                    label, got[:, :, :rows], plain[:, :, :rows], **tol))
                r = _rel_rmse(got[:, :, :rows], gold)
                rp = _rel_rmse(plain[:, :, :rows], gold)
                if tag == "bf16_fp32" and beta:
                    held = r <= BF16_PASA_RMSE_RATIO * rp
                    rmse[f"{case} {tag} beta {beta} plain"] = rp
                else:
                    held = r < ATTN_RMSE_MAX and rp < ATTN_RMSE_MAX
                if not held:
                    raise AssertionError(f"{label} RMSE {r:.4f} / plain "
                                         f"{rp:.4f}")
                rmse[f"{case} {tag} beta {beta}"] = r
        del gold

    def timed(case):
        """kernel (shifted keys), plain, SDPA ms and the bound at a case,
        fp16 PASA."""
        q, k, v, valid, _, bq = cases[case]
        rows = 1 if case == "cross" else valid
        k_sh = ops.shift_kv(k, beta=BETA, policy=get_policy("fp16"))
        inva = effective_invariance(128, 64, BETA, torch.float16)
        fp16 = get_policy("fp16")
        ms = _cuda_time_ms(lambda: mod.kernel_call(
            q, k_sh, v, beta=BETA, inva=inva, policy=fp16, causal=False,
            block_q=bq, block_kv=128, kv_valid=valid), 20)
        plain_ms = _cuda_time_ms(lambda: mod.attention_plain(
            q, k, v, beta=BETA, policy=fp16, block_kv=128, kv_valid=valid),
            3, warmup=1)
        qs, ks, vs = (x[:, :, :n].contiguous()
                      for x, n in ((q, rows), (k, valid), (v, valid)))
        lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs), 20)
        # q and out over the real rows, K' and V over the valid ones, fp16
        b, h, _, d = q.shape
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    **R.bound(*R.attention_cost(b, h, rows, k.shape[1],
                                                k.shape[2], d, causal=False,
                                                kv_valid=valid)))

    enc, cross = timed("encoder"), timed("cross")
    source, replaces = KERNEL_FILES["pasa_attention"]
    path_key = ("pasa_attention", mode_name(get_policy("fp16"),
                                            torch.bfloat16, 64))
    entries = [dict(
        name="pasa_attention/d64", whisper_mode=path_key, route="cuda",
        source=source, replaces=replaces, max_abs_err=errs[("fp16", BETA)],
        rmse=rmse[f"encoder fp16 beta {BETA}"],
        detail=dict(rmse=rmse, cross_shape=cross,
                    cases={c: dict(kv_valid=x[3], causal=x[4], block_q=x[5])
                           for c, x in cases.items()}),
        **enc)]
    for tag in ("fp16_fp32", "fp32", "bf16_fp32"):
        policy = get_policy(tag)
        q, k, v, valid, _, _ = cases["encoder"]
        at = _caster(q, k, v)
        entries.append(dict(
            name=f"pasa_attention/d64_{tag}",
            whisper_mode=("flash_attention", mode_name(policy, torch.bfloat16,
                                                       64)),
            route="cuda", source=source, replaces=replaces,
            max_abs_err=max(errs[(tag, 0.0)], errs[(tag, BETA)]),
            rmse=rmse[f"encoder {tag} beta 0.0"],
            ms=_cuda_time_ms(lambda: ops.flash_attention(
                *at(policy), policy=policy, kv_valid=valid), 20),
            ms_pasa=_cuda_time_ms(lambda: ops.pasa_attention(
                *at(policy), beta=BETA, policy=policy, kv_valid=valid), 20),
            plain_ms=_cuda_time_ms(lambda: mod.attention_plain(
                *at(policy), beta=0.0, policy=policy, block_kv=128,
                kv_valid=valid), 3, warmup=1),
            library_ms=_cuda_time_ms(lambda: F.scaled_dot_product_attention(
                *(x[:, :, :valid] for x in at(policy))), 20),
            bound_ms=enc["bound_ms"], bound_by=enc["bound_by"]))
    return entries


def check_exports():
    """``from repro_torch.kernels import pasa_attention`` (and the other
    exported names) gives the op, as ``repro.kernels`` does."""
    import repro_torch.kernels as kernels
    from repro_torch.kernels import ops, pasa_attention

    if pasa_attention is not ops.pasa_attention:
        raise AssertionError("repro_torch.kernels.pasa_attention is not the op")
    for name in kernels.__all__:
        if getattr(kernels, name) is not getattr(ops, name):
            raise AssertionError(f"repro_torch.kernels.{name} is not the op")
    return sorted(kernels.__all__)


def _leaves(tree):
    """Every tensor of a (nested) parameter dict."""
    return [x for v in tree.values() for x in (
        _leaves(v) if isinstance(v, dict) else [v])]


def build_model(dev):
    """qwen2-7b at full width with random weights from seed 0, shared by
    both serving phases."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    bundle = build(get_config("qwen2-7b"))
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    return bundle, params, time.perf_counter() - t0


def _served_mode(cfg, cache_dtype) -> str:
    """The launch-counter key of the kernels' mode a serve of ``cfg``
    runs: its impl's policy (``pasa_policy`` for PASA, ``policy`` for
    flash) over a pool or cache of ``cache_dtype``."""
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels.pasa_paged_decode import mode_name
    from repro_torch.runtime.paged_cache import resolve_pool_dtype

    ac = cfg.attention
    policy = get_policy(ac.pasa_policy if ac.impl == "pasa" else ac.policy)
    return mode_name(policy, resolve_pool_dtype(cache_dtype))


def _by_mode(names):
    """Each named op's launch counts by mode, as plain dicts."""
    from repro_torch.kernels import ops

    return {name: dict(getattr(ops, name).launches_by_mode) for name in names}


def _flash_bundle(bundle):
    """The same model with the attention switch at impl="flash" (its
    default policy, bf16_fp32)."""
    import dataclasses

    from repro_torch.models.model_zoo import build

    return build(dataclasses.replace(bundle.cfg, attention=dataclasses.replace(
        bundle.cfg.attention, impl="flash")))


def _finite_bundle(bundle, finite):
    """The bundle with its serving steps recording whether their logits
    are finite (one device flag per call, read at the end)."""
    import dataclasses

    import torch

    def checked(step):
        def run(*a, **kw):
            logits, state = step(*a, **kw)
            finite.append(torch.isfinite(logits).all())
            return logits, state
        return run

    names = ("prefill", "serve_step", "paged_serve_step", "paged_prefill_step")
    return dataclasses.replace(bundle, **{
        name: checked(getattr(bundle, name)) for name in names
        if getattr(bundle, name) is not None})


def _paged_workload(cfg, cache_dtype, page=128):
    """The paged phase's four prompts (seed 0) and engine arguments, at
    ``page``-row pages."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in SERVE_PROMPTS]
    kw = dict(max_batch=4, page_size=page, prefill_chunk=512, prefill_batch=4,
              num_pages=1 + sum(math.ceil((n + SERVE_GEN - 1) / page)
                                for n in SERVE_PROMPTS),
              max_seq_len=max(SERVE_PROMPTS) + SERVE_GEN,
              cache_dtype=cache_dtype)
    return prompts, kw


def serve(dev, bundle, params, cache_dtype="bf16", alone=None, page=128):
    """The bundle's model (qwen2-7b, qwen3-4b) at full width through the
    engine from a ``cache_dtype`` pool of ``page``-row pages (the
    attention impl, policy and block of ``bundle.cfg``); the requests
    ``alone`` (default: all) served one at a time give their batched
    streams; returns the report."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeEngine, paged_bytes

    cfg = bundle.cfg
    torch.cuda.reset_peak_memory_stats()
    prompts, kw = _paged_workload(cfg, cache_dtype, page)

    finite = []
    bundle = _finite_bundle(bundle, finite)
    def run(prompt_list):
        eng = ServeEngine(bundle, params, **kw)
        reqs = [eng.submit(p, SERVE_GEN) for p in prompt_list]
        marks = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while not eng.idle:
            calls = (eng.prefill_calls, eng.decode_calls)
            eng.step()                     # ends in the step's readback
            marks.append((time.perf_counter() - t0, calls,
                          (eng.prefill_calls, eng.decode_calls)))
        return eng, reqs, marks

    # warm-up serve of one short request (cuBLAS and kernel first calls)
    run([prompts[-1][:64]])
    ops.reset_launches()
    eng, reqs, marks = run(prompts)
    launches = {"pasa_paged_prefill": ops.pasa_paged_prefill.launches,
                "pasa_paged_decode": ops.pasa_paged_decode.launches}
    n_layers = cfg.n_layers
    n_prefill, n_decode = eng.prefill_calls, eng.decode_calls
    if launches["pasa_paged_prefill"] != n_layers * n_prefill or \
            launches["pasa_paged_decode"] != n_layers * n_decode:
        raise AssertionError(
            f"{cache_dtype} pool: launch counts {launches} != {n_layers} x "
            f"({n_prefill} prefill, {n_decode} decode) calls"
        )
    if n_prefill == 0 or n_decode == 0:
        raise AssertionError("the serve made no prefill or no decode call")
    # every launch in the mode of the serve's impl, policy and pool
    by_mode = _by_mode(launches)
    mode = _served_mode(cfg, cache_dtype)
    for name, n in launches.items():
        if by_mode[name] != {mode: n}:
            raise AssertionError(f"{cache_dtype} pool: {name} launches by "
                                 f"mode {by_mode[name]} != {{{mode!r}: {n}}}")
    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{cache_dtype} pool: non-finite logits")
    streams = [r.generated for r in reqs]
    for s in streams:
        if len(s) != SERVE_GEN or not all(0 <= t < cfg.vocab_size for t in s):
            raise AssertionError(f"bad stream {s}")
    peak = torch.cuda.max_memory_allocated()
    wall = marks[-1][0]
    ttft = [marks[r.first_token_step][0] for r in reqs]
    decode_only = [
        marks[i][0] - (marks[i - 1][0] if i else 0.0)
        for i in range(len(marks))
        if marks[i][2][0] == marks[i][1][0] and marks[i][2][1] > marks[i][1][1]
    ]
    pool_bytes = paged_bytes(eng.pool)
    del eng
    # one at a time: identical streams
    for i in range(len(prompts)) if alone is None else alone:
        p, want = prompts[i], streams[i]
        _, (r,), _ = run([p])
        if r.generated != want:
            raise AssertionError(
                f"{cache_dtype} pool: batched vs one-at-a-time streams "
                f"differ: {want} vs {r.generated}"
            )
    n_tok = sum(len(s) for s in streams)
    return dict(
        arch=cfg.arch_id, layers=n_layers, d_model=cfg.d_model,
        impl=cfg.attention.impl, cache_dtype=cache_dtype, page=page,
        block_kv=cfg.attention.block_kv,
        pool_bytes=pool_bytes, prompts=list(SERVE_PROMPTS), gen=SERVE_GEN,
        steps=len(marks), prefill_calls=n_prefill, decode_calls=n_decode,
        served_alone=list(range(len(prompts)) if alone is None else alone),
        launches=launches, launches_by_mode=by_mode, wall_s=wall,
        tok_per_s=n_tok / wall,
        ttft_ms=[1e3 * t for t in ttft],
        decode_ms_per_step=1e3 * sum(decode_only) / max(len(decode_only), 1),
        peak_gb=peak / 1e9, streams=streams,
    )


def serve_dense(dev, bundle, params, alone=range(DENSE_BATCH)):
    """The dense route of launch/serve.py at full width: one fused prefill
    of four 1000-token prompts, then greedy decode steps on the dense
    cache (the attention impl and policy of ``bundle.cfg``); the prompts
    ``alone`` served one at a time give their batched streams; returns
    the report."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_serve_step

    cfg = bundle.cfg
    finite = []
    bundle = _finite_bundle(bundle, finite)
    step = make_serve_step(bundle)
    max_len = DENSE_PROMPT + SERVE_GEN + 8

    def run(prompts):
        """Fused prefill + SERVE_GEN - 1 decode steps, each call ended by
        its token's readback (as launch/serve.py's dense route)."""
        b = prompts.shape[0]
        cache = bundle.init_cache(b, max_len, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = bundle.prefill(params, prompts, cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok.cpu()]
        marks = [time.perf_counter() - t0]
        n = prompts.shape[1]
        for i in range(n, n + SERVE_GEN - 1):
            pos = torch.full((b,), i, dtype=torch.int32, device=dev)
            tok, _, cache = step(params, tok, pos, cache)
            out.append(tok.cpu())
            marks.append(time.perf_counter() - t0)
        return torch.stack(out, 1), marks

    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT), dtype=np.int32)).to(dev)
    run(prompts[:1, :256])                 # warm-up (cuBLAS first calls)
    torch.cuda.reset_peak_memory_stats()
    finite.clear()
    ops.reset_launches()
    streams, marks = run(prompts)
    launches = {name: getattr(ops, name).launches for name in (
        "shift_kv", "pasa_attention", "flash_attention", "pasa_decode",
        "pasa_paged_prefill", "pasa_paged_decode")}
    n_prefill, n_decode = 1, SERVE_GEN - 1
    # PASA: shift-KV then the PASA kernel; flash: FlashAttention-2 alone
    pasa = cfg.attention.impl == "pasa"
    prefill_ops = ("shift_kv", "pasa_attention") if pasa else ("flash_attention",)
    want = {name: cfg.n_layers * n_prefill if name in prefill_ops else 0
            for name in launches}
    want["pasa_decode"] = cfg.n_layers * n_decode
    if launches != want:
        raise AssertionError(f"dense launch counts {launches} != {want}")
    by_mode = _by_mode(launches)
    shift_by_mode = by_mode.pop("shift_kv")
    if sum(shift_by_mode.values()) != launches["shift_kv"]:
        raise AssertionError(f"shift_kv launches by mode {shift_by_mode} do "
                             f"not add up to {launches['shift_kv']}")
    mode = _served_mode(cfg, "bf16")
    for name, counts in by_mode.items():
        if counts != ({mode: launches[name]} if launches[name] else {}):
            raise AssertionError(f"dense {name} launches by mode {counts} "
                                 f"!= {mode!r}: {launches[name]}")
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits in the dense serve")
    if not bool(((streams >= 0) & (streams < cfg.vocab_size)).all()):
        raise AssertionError(f"bad dense streams {streams}")
    peak = torch.cuda.max_memory_allocated()
    for i in alone:
        one, _ = run(prompts[i:i + 1])
        if not torch.equal(one[0], streams[i]):
            raise AssertionError(
                f"dense batched vs one-at-a-time streams differ: "
                f"{streams[i].tolist()} vs {one[0].tolist()}")
    wall = marks[-1]
    steps = [b - a for a, b in zip(marks, marks[1:])]
    return dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=DENSE_BATCH,
        prompt_len=DENSE_PROMPT, gen=SERVE_GEN, max_len=max_len,
        impl=cfg.attention.impl, prefill_calls=n_prefill,
        decode_calls=n_decode, launches=launches,
        shift_kv_launches_by_mode=shift_by_mode, launches_by_mode=by_mode,
        wall_s=wall, tok_per_s=streams.numel() / wall,
        ttft_ms=1e3 * marks[0],
        decode_ms_per_step=1e3 * sum(steps) / len(steps),
        peak_gb=peak / 1e9, streams=streams.tolist(),
    )


def check_prefill_starts(dev):
    """The paged prefill kernel is invariant to where a chunk starts, bit
    for bit, at the page boundaries a prefix hit starts at: row 1 of the
    prefill fixture (queries 512..1023) split after 128, 256 and 384
    queries - second parts starting at 640, 768 and 896, page multiples
    that are not chunk multiples - equals the whole row, from the bf16
    pool and from its int8 and fp8_e4m3 quantization.  A query tile is
    128 rows, counted from the chunk's start: with 128-row pages every
    such split keeps each row in the tile it has in the whole call."""
    import torch

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops

    q, kp, vp, table, start, kv_len = _prefill_fixture(dev)
    pools = {"bf16": (kp, vp, {})}
    for dtype in QUANT_DTYPES:
        kq, vq, quant, _ = _quantize_pool(kp, vp, table, PREFILL_ROWS[1],
                                          dtype)
        pools[dtype] = (kq, vq, quant)
    q1, t1, s1, n1 = q[1:2], table[1:2], start[1:2], kv_len[1:2]
    held = {}
    for dtype, (k, v, quant) in pools.items():
        run = lambda qq, s0, n: ops.pasa_paged_prefill(
            qq, k, v, t1, s0, n, beta=BETA, policy=FP16, **quant)
        whole = run(q1, s1, n1)
        cuts = []
        for cut in (128, 256, 384):
            a = run(q1[:, :, :cut], s1, s1 + cut)
            c = run(q1[:, :, cut:], s1 + cut, n1)
            if not torch.equal(torch.cat([a, c], 2), whole):
                raise AssertionError(
                    f"pasa_paged_prefill/{dtype}: a chunk starting at "
                    f"{int(s1) + cut} differs from the whole chunk")
            cuts.append(int(s1) + cut)
        held[dtype] = cuts
    return held


def _launch_counts():
    from repro_torch.kernels import ops

    return {name: getattr(ops, name).launches
            for name in ("pasa_paged_prefill", "pasa_paged_decode",
                         "pasa_decode")}


def _check_engine_launches(tag, eng, cache_dtype):
    """Since the last reset: each paged kernel launched 28 times per call
    of the engine (the decode kernel 28 times per sub-step of a verify
    call: K + 1 per call), all in the mode of the served impl, policy and
    pool, and the contiguous decode kernel never."""
    launches = _launch_counts()
    n = eng.bundle.cfg.n_layers
    sub_steps = eng.decode_calls + (eng.speculate + 1) * eng.verify_calls
    want = {"pasa_paged_prefill": n * eng.prefill_calls,
            "pasa_paged_decode": n * sub_steps, "pasa_decode": 0}
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches} != {want} "
                             f"({eng.prefill_calls} prefill, "
                             f"{eng.decode_calls} decode, "
                             f"{eng.verify_calls} verify calls)")
    mode = _served_mode(eng.bundle.cfg, cache_dtype)
    by_mode = _by_mode(("pasa_paged_prefill", "pasa_paged_decode"))
    for name, counts in by_mode.items():
        if counts != ({mode: launches[name]} if launches[name] else {}):
            raise AssertionError(f"{tag}: {name} launches by mode {counts}")
    return launches


def _drive_calls(eng, check=None):
    """Step the engine until it drains (at any pipeline depth: ``idle``
    counts the steps in flight); per step the wall time (s) at its end
    (at depth 0 each step ends in its readback) and the (prefill, decode,
    verify) calls it made; ``check()`` runs after every step."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks = []
    while not eng.idle:
        before = (eng.prefill_calls, eng.decode_calls, eng.verify_calls)
        eng.step()
        after = (eng.prefill_calls, eng.decode_calls, eng.verify_calls)
        marks.append((time.perf_counter() - t0,
                      tuple(a - b for a, b in zip(after, before))))
        if check is not None:
            check()
    return marks


def _drive(eng):
    """:func:`_drive_calls`'s wall times alone."""
    return [t for t, _ in _drive_calls(eng)]


def _all_finite(tag, finite):
    import torch

    if not bool(torch.stack(finite).all()):
        raise AssertionError(f"{tag}: non-finite logits")
    finite.clear()


def serve_tbt(dev, bundle, params, lens=TBT_PROMPTS):
    """Token-by-token mode at full width: prompts of ``lens`` tokens (257
    and 129 by default), 16 greedy tokens each, all in one batch,
    teacher-forced one token per step through the
    paged decode kernel, no prefill call; each stream equals
    ``dense_greedy_reference``, the dense B=1 cache through the contiguous
    decode kernel, token for token (paged and contiguous decode are
    bit-identical, and norms and GEMMs run padded to 16 rows)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeEngine, dense_greedy_reference

    cfg = bundle.cfg
    finite = []
    bundle = _finite_bundle(bundle, finite)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    kw = dict(max_batch=len(lens), page_size=128, chunked_prefill=False,
              num_pages=1 + sum(math.ceil((n + TBT_GEN - 1) / 128)
                                for n in lens),
              max_seq_len=max(lens) + TBT_GEN)
    warm = ServeEngine(bundle, params, **kw)
    warm.submit(prompts[1][:4], 2)
    warm.run_to_completion()
    ops.reset_launches()
    eng = ServeEngine(bundle, params, **kw)
    reqs = [eng.submit(p, TBT_GEN) for p in prompts]
    marks = _drive(eng)
    launches = _check_engine_launches("serve_tbt", eng, "bf16")
    if eng.prefill_calls != 0 or eng.decode_calls != eng.steps:
        raise AssertionError(f"serve_tbt: {eng.prefill_calls} prefill calls, "
                             f"{eng.decode_calls} decode / {eng.steps} steps")
    _all_finite("serve_tbt", finite)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    oracle = [dense_greedy_reference(bundle, params, p, TBT_GEN)
              for p in prompts]
    oracle_s = time.perf_counter() - t0
    dense_steps = sum(n + TBT_GEN - 1 for n in lens)
    if _launch_counts() != {"pasa_paged_prefill": 0, "pasa_paged_decode": 0,
                            "pasa_decode": cfg.n_layers * dense_steps}:
        raise AssertionError(f"dense_greedy_reference launches "
                             f"{_launch_counts()} != {cfg.n_layers} x "
                             f"{dense_steps} contiguous decodes")
    _all_finite("dense_greedy_reference", finite)
    for r, want in zip(reqs, oracle):
        if r.generated != want:
            raise AssertionError(f"serve_tbt: request {r.req_id} "
                                 f"{r.generated} != dense_greedy_reference "
                                 f"{want}")
    wall = marks[-1]
    return dict(
        arch=cfg.arch_id, prompts=list(lens), gen=TBT_GEN,
        max_batch=len(lens),
        steps=eng.steps, decode_calls=eng.decode_calls,
        prefill_calls=eng.prefill_calls, launches=launches,
        wall_s=wall, tok_per_s=TBT_GEN * len(prompts) / wall,
        ms_per_step=1e3 * wall / len(marks),
        ttft_ms=[1e3 * marks[r.first_token_step] for r in reqs],
        oracle_wall_s=oracle_s, oracle_pasa_decode_launches=(
            cfg.n_layers * dense_steps),
        equal_to_dense_greedy_reference=True,
        streams=[r.generated for r in reqs],
    )


def _page_bytes(pool, pages):
    """Every pool leaf (K, V and an 8-bit pool's sidecars) at ``pages``,
    as bytes."""
    import torch

    idx = torch.tensor(pages, dtype=torch.long, device=pool["k"].device)
    return {name: x[:, idx].contiguous().view(torch.uint8).clone()
            for name, x in pool.items()}


def serve_prefix(dev, bundle, params, cache_dtype, page=128):
    """The prefix cache at full width from a ``cache_dtype`` pool of
    ``page``-row pages: three prompts sharing a 768-token prefix (suffixes
    232, 105, 40; 16 tokens each).  The first is served cold and donates
    its full prompt pages (seven at page 128); the other two hit the
    shared prefix's whole pages together (six at page 128: prefill chunks
    starting at 768, a page multiple but not a chunk multiple; one at page
    512); the first again hits all of its own.  Every stream equals ``chunked_cold_reference`` (a fresh engine,
    cache off), and the cached pages' bytes, sidecars included, are the
    same after the hits as after the cold serve."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeEngine, chunked_cold_reference

    cfg = bundle.cfg
    finite = []
    bundle = _finite_bundle(bundle, finite)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, PREFIX_SHARED).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in PREFIX_SUFFIXES]
    kw = dict(page_size=page, prefill_chunk=512, cache_dtype=cache_dtype)
    ops.reset_launches()
    eng = ServeEngine(bundle, params, max_batch=2, num_pages=40 * 128 // page,
                      max_seq_len=max(len(p) for p in prompts) + PREFIX_GEN,
                      prefix_cache=True, **kw)
    cold = eng.submit(prompts[0], PREFIX_GEN)
    m_cold = _drive(eng)
    nodes = eng.prefix_cache.match(prompts[0])
    cached = [n.page for n in nodes]
    eng.prefix_cache.release(nodes)
    before = _page_bytes(eng.pool, cached)
    s0 = eng.steps
    hits = [eng.submit(p, PREFIX_GEN) for p in prompts[1:]]
    m_hits = _drive(eng)
    s1 = eng.steps
    again = eng.submit(prompts[0], PREFIX_GEN)
    m_again = _drive(eng)
    launches = _check_engine_launches(f"serve_prefix_{cache_dtype}", eng,
                                      cache_dtype)
    _all_finite(f"serve_prefix_{cache_dtype}", finite)
    after = _page_bytes(eng.pool, cached)
    for name in before:
        if not torch.equal(before[name], after[name]):
            raise AssertionError(f"serve_prefix_{cache_dtype}: cached pages' "
                                 f"{name} bytes changed under the hits")
    shared_pages = PREFIX_SHARED // page * page
    want_cached = [0, shared_pages, shared_pages,
                   (len(prompts[0]) - 1) // page * page]
    reqs = [cold, *hits, again]
    if [r.cached_len for r in reqs] != want_cached:
        raise AssertionError(f"serve_prefix_{cache_dtype}: cached_len "
                             f"{[r.cached_len for r in reqs]} != {want_cached}")
    st = eng.stats()["prefix_cache"]
    if st["hits"] != sum(want_cached) // page or st["evictions"]:
        raise AssertionError(f"serve_prefix_{cache_dtype}: stats {st}")
    if len(cached) != len(prompts[0]) // page:
        raise AssertionError(f"serve_prefix_{cache_dtype}: {len(cached)} "
                             f"pages cached after the cold serve")
    # the oracle: each prompt alone on a fresh engine with the cache off
    for p, r in zip(prompts + [prompts[0]], reqs):
        want = chunked_cold_reference(bundle, params, p, PREFIX_GEN, **kw)
        if r.generated != want:
            raise AssertionError(f"serve_prefix_{cache_dtype}: request "
                                 f"{r.req_id} (cached {r.cached_len}) "
                                 f"{r.generated} != cold {want}")
    _all_finite(f"chunked_cold_reference ({cache_dtype})", finite)
    ttft = lambda marks, r, s: 1e3 * marks[r.first_token_step - s]
    n_tok = PREFIX_GEN * len(reqs)
    wall = m_cold[-1] + m_hits[-1] + m_again[-1]
    return dict(
        cache_dtype=cache_dtype, page=page, shared=PREFIX_SHARED,
        prompts=[len(p) for p in prompts], gen=PREFIX_GEN,
        cached_len=[r.cached_len for r in reqs],
        ttft_cold_ms=ttft(m_cold, cold, 0),
        ttft_hit_ms=ttft(m_again, again, s1),
        ttft_shared_hits_ms=[ttft(m_hits, r, s0) for r in hits],
        prefix_cache=st, cached_page_bytes_equal=True,
        equal_to_chunked_cold_reference=True,
        steps=eng.steps, prefill_calls=eng.prefill_calls,
        decode_calls=eng.decode_calls, launches=launches,
        wall_s=wall, tok_per_s=n_tok / wall,
        streams=[r.generated for r in reqs],
    )


def serve_preempt(dev, bundle, params, cache_dtype, depth=0):
    """Preemption at full width (the reference's test_scheduler.py
    preempt-resume case): max batch 2, 12 allocatable pages, prefix cache
    on, patience 2, ``pipeline_depth`` ``depth`` (at 1 the preemption
    drains the pipeline before it records the victim's tokens).  A (1000 + 32 tokens, 9 pages) decodes 4 tokens; B
    (900 + 32, 8 pages) arrives and is page-starved; A is paged out (its
    seven prompt pages donated), B evicts three of them and runs; A
    resumes with a partial hit, re-prefills its tail and replays its
    recorded tokens through the decode kernel.  Both streams equal
    ``chunked_cold_reference``."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeEngine, chunked_cold_reference

    cfg = bundle.cfg
    tag = f"serve_{'async_' if depth else ''}preempt_{cache_dtype}"
    finite = []
    bundle = _finite_bundle(bundle, finite)
    rng = np.random.default_rng(4)
    pa, pb = (rng.integers(0, cfg.vocab_size, n).tolist()
              for n in PREEMPT_PROMPTS)
    kw = dict(page_size=128, prefill_chunk=512, cache_dtype=cache_dtype)
    ops.reset_launches()
    eng = ServeEngine(bundle, params, max_batch=2,
                      num_pages=1 + PREEMPT_PAGES,
                      max_seq_len=max(PREEMPT_PROMPTS) + PREEMPT_GEN,
                      prefix_cache=True, preemption=True, preempt_patience=2,
                      pipeline_depth=depth, **kw)
    ra = eng.submit(pa, PREEMPT_GEN)
    marks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while len(ra.generated) < 4:
        eng.step()
        marks.append(time.perf_counter() - t0)
    rb = eng.submit(pb, PREEMPT_GEN)
    while not eng.idle:
        eng.step()
        marks.append(time.perf_counter() - t0)
    launches = _check_engine_launches(tag, eng, cache_dtype)
    _all_finite(tag, finite)
    if eng.preemptions < 1 or ra.preempt_count < 1:
        raise AssertionError(f"{tag}: no preemption ({eng.stats()})")
    if not ra.first_token_step < ra.preempt_step:
        raise AssertionError(f"{tag}: first token at {ra.first_token_step}, "
                             f"preempted at {ra.preempt_step}")
    for p, r in ((pa, ra), (pb, rb)):
        want = chunked_cold_reference(bundle, params, p, PREEMPT_GEN, **kw)
        if r.generated != want:
            raise AssertionError(f"{tag}: request {r.req_id} {r.generated} "
                                 f"!= uninterrupted {want}")
    _all_finite(f"chunked_cold_reference ({cache_dtype})", finite)
    wall = marks[-1]
    return dict(
        cache_dtype=cache_dtype, pipeline_depth=depth,
        prompts=list(PREEMPT_PROMPTS),
        gen=PREEMPT_GEN, allocatable_pages=PREEMPT_PAGES,
        preemptions=eng.preemptions, preempt_step=ra.preempt_step,
        resume_admit_step=ra.admit_step, resume_cached_len=ra.cached_len,
        replayed=len(ra.replay), prefix_cache=eng.stats()["prefix_cache"],
        first_token_step={"A": ra.first_token_step, "B": rb.first_token_step},
        finish_step={"A": ra.finish_step, "B": rb.finish_step},
        equal_to_chunked_cold_reference=True,
        steps=eng.steps, prefill_calls=eng.prefill_calls,
        decode_calls=eng.decode_calls, launches=launches,
        wall_s=wall, tok_per_s=2 * PREEMPT_GEN / wall,
        ttft_ms={"A": 1e3 * marks[ra.first_token_step],
                 "B": 1e3 * marks[rb.first_token_step]},
        streams=[ra.generated, rb.generated],
    )


def serve_policy(dev, bundle, params, scheduler, budget, fcfs_streams):
    """The paged phase's four prompts from a bf16 pool under ``scheduler``
    (and ``step_token_budget``): the streams equal the FCFS serve's
    (scheduling moves latency, never tokens), and no step spends more than
    the budget."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeEngine

    tag = f"serve_{scheduler}"
    finite = []
    bundle = _finite_bundle(bundle, finite)
    prompts, kw = _paged_workload(bundle.cfg, "bf16")
    ops.reset_launches()
    eng = ServeEngine(bundle, params, scheduler=scheduler,
                      step_token_budget=budget, **kw)
    reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
    marks = _drive(eng)
    launches = _check_engine_launches(tag, eng, "bf16")
    _all_finite(tag, finite)
    streams = [r.generated for r in reqs]
    if streams != fcfs_streams:
        raise AssertionError(f"{tag}: streams differ from the FCFS serve's")
    st = eng.stats()
    if budget is not None and st["max_step_tokens"] > budget:
        raise AssertionError(f"{tag}: a step spent {st['max_step_tokens']} "
                             f"tokens > budget {budget}")
    wall = marks[-1]
    return dict(
        scheduler=scheduler, step_token_budget=budget,
        max_step_tokens=st["max_step_tokens"], steps=eng.steps,
        prefill_calls=eng.prefill_calls, decode_calls=eng.decode_calls,
        launches=launches, wall_s=wall,
        tok_per_s=SERVE_GEN * len(prompts) / wall,
        ttft_ms=[1e3 * marks[r.first_token_step] for r in reqs],
        equal_to_fcfs_streams=True,
    )


def check_verify(dev):
    """``pasa_paged_verify`` at W = SPEC_K + 1 columns on the serve-shape
    decode pools (batch 4, kv 1002 / 519 / 302 / 131, KVH 4, G 7, page
    128; bf16 and the same pool quantized to int8 and fp8_e4m3), the
    columns ending at each row's last position: W launches of the paged
    decode kernel, each column bit-equal to a one-token kernel decode at
    its position and within the decode bars of the plain version; timed
    beside the W single decode calls."""
    import numpy as np
    import torch

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops
    mod = _kernel_module("pasa_paged_decode")

    kvh, g, d, page = 4, 7, 128, 128
    w = SPEC_K + 1
    b = len(SERVE_DECODE_KV)
    rng = np.random.default_rng(6)
    kp0, vp0, table = _paged_pool(rng, SERVE_DECODE_KV, kvh, d, page, 2.0, 3,
                                  dev)
    kv_len = torch.tensor(SERVE_DECODE_KV, dtype=torch.int32, device=dev)
    start = kv_len - w
    q = _randn(rng, (b, kvh, g, w, d), 0.0, dev, torch.float16)
    cols = [q[:, :, :, j].contiguous() for j in range(w)]
    lens = [start + 1 + j for j in range(w)]
    out = {}
    for dtype in ("bf16", *QUANT_DTYPES):
        kp, vp, quant = kp0, vp0, {}
        if dtype != "bf16":
            kp, vp, quant, _ = _quantize_pool(kp0, vp0, table,
                                              SERVE_DECODE_KV, dtype)
        verify = lambda: ops.pasa_paged_verify(
            q, kp, vp, table, start, beta=BETA, policy=FP16, **quant)
        n0 = ops.pasa_paged_decode.launches
        got = verify()
        if ops.pasa_paged_decode.launches - n0 != w:
            raise AssertionError(f"pasa_paged_verify/{dtype}: "
                                 f"{ops.pasa_paged_decode.launches - n0} "
                                 f"decode launches for {w} columns")
        max_err = 0.0
        for j in range(w):
            one = ops.pasa_paged_decode(cols[j], kp, vp, table, lens[j],
                                        beta=BETA, policy=FP16, **quant)
            if not torch.equal(got[:, :, :, j], one):
                raise AssertionError(f"pasa_paged_verify/{dtype}: column {j} "
                                     f"differs from a one-token decode")
            plain = mod.paged_decode_plain(
                cols[j], kp, vp, table, lens[j], beta=BETA, policy=FP16,
                block_kv=page, **quant)
            max_err = max(max_err, _close(
                f"pasa_paged_verify/{dtype} column {j}", one, plain,
                **DECODE_TOL))
        ms = _cuda_time_ms(verify, 20)
        singles_ms = _cuda_time_ms(lambda: [
            ops.pasa_paged_decode(cols[j], kp, vp, table, lens[j], beta=BETA,
                                  policy=FP16, **quant) for j in range(w)], 20)
        out[dtype] = dict(columns=w, launches_per_call=w,
                          columns_equal_to_decode=True, max_abs_err=max_err,
                          ms=ms, ms_of_w_decode_calls=singles_ms)
    return out


def _call_ms(marks):
    """Mean wall ms of the steps that made one decode call and no other,
    and of those that made one verify call and no other."""
    out = {}
    for name, calls in (("decode", (0, 1, 0)), ("verify", (0, 0, 1))):
        dts = [t - (marks[i - 1][0] if i else 0.0)
               for i, (t, c) in enumerate(marks) if c == calls]
        out[name] = 1e3 * sum(dts) / len(dts) if dts else None
    return out


def _pools_equal(a, b) -> bool:
    """Every leaf bit for bit on every page but the null page 0 (the
    write sink of idle rows)."""
    import torch

    return set(a) == set(b) and all(
        torch.equal(a[n][:, 1:].contiguous().view(torch.uint8),
                    b[n][:, 1:].contiguous().view(torch.uint8)) for n in a)


def _sampler_vs_cpu(calls):
    """The card's sampler against the CPU's on the recorded calls' logits
    and keys: the uniforms must be equal bit for bit; the tokens are
    counted (near-ties may part: ``log`` may round differently)."""
    import torch

    from repro_torch.runtime.engine import make_sampler, sample_uniforms

    seed = SAMPLE_KW["sample_seed"]
    cpu_sample = make_sampler(SAMPLE_KW["temperature"], SAMPLE_KW["top_k"],
                              seed)
    same = total = 0
    for logits, rids, idxs, toks in calls:
        vocab = logits.shape[-1]
        card_u = sample_uniforms(seed, rids, idxs, vocab).cpu()
        if not torch.equal(card_u, sample_uniforms(seed, rids.cpu(),
                                                   idxs.cpu(), vocab)):
            raise AssertionError("the sampler's uniforms differ between the "
                                 "card and the CPU")
        want = cpu_sample(logits.cpu(), rids.cpu(), idxs.cpu())
        same += int((toks.cpu() == want).sum())
        total += toks.numel()
    return f"{same}/{total}"


def serve_sample(dev, bundle, params, cache_dtype, greedy_streams):
    """Sampling (SAMPLE_KW) at full width on the paged workload from a
    ``cache_dtype`` pool.  Held exactly: batched (max batch 4) == one at a
    time (max batch 1, the same request ids); prefill chunk 256 == 512;
    preempt-resume (``serve_preempt``'s prompts and 12 pages) == each
    request served alone (``chunked_cold_reference`` with its request id);
    top-k 1 == the greedy serve (``greedy_streams``); temperature 0 == the
    greedy serve; some sampled token differs from the greedy one; the
    card's uniforms equal the CPU's on every call of the batched serve.
    Reported: how many of its sampled tokens the CPU sampler draws too on
    the same logits."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeEngine, chunked_cold_reference

    tag = f"serve_sample_{cache_dtype}"
    finite = []
    bundle = _finite_bundle(bundle, finite)
    prompts, kw = _paged_workload(bundle.cfg, cache_dtype)
    calls = []

    def run(record=False, **extra):
        ops.reset_launches()
        eng = ServeEngine(bundle, params, **{**kw, **SAMPLE_KW, **extra})
        if record:
            sample = eng._sampler

            def recorded(logits, rids, idxs):
                toks = sample(logits, rids, idxs)
                calls.append((logits.clone(), rids, idxs, toks))
                return toks
            eng._sampler = recorded
        reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
        marks = _drive_calls(eng)
        _check_engine_launches(tag, eng, cache_dtype)
        return [r.generated for r in reqs], eng, marks

    streams, eng, marks = run(record=True)
    wall, steps = marks[-1][0], eng.steps
    checks = {"max_batch_1": run(max_batch=1)[0],
              "prefill_chunk_256": run(prefill_chunk=256)[0]}
    for name, got in checks.items():
        if got != streams:
            raise AssertionError(f"{tag}: {name} streams differ from the "
                                 f"batched serve's")
    if run(top_k=1)[0] != greedy_streams:
        raise AssertionError(f"{tag}: top-k 1 differs from the greedy serve")
    greedy, _, greedy_marks = run(temperature=0.0)
    if greedy != greedy_streams:
        raise AssertionError(f"{tag}: temperature 0 differs from the greedy "
                             f"serve")
    differ = sum(a != b for s, g in zip(streams, greedy_streams)
                 for a, b in zip(s, g))
    if not differ:
        raise AssertionError(f"{tag}: every sampled token is the greedy one")
    cpu_equal = _sampler_vs_cpu(calls)
    calls.clear()
    # preempt-resume: A (1000 + 32) paged out by B (900 + 32) in 12 pages
    rng = np.random.default_rng(4)
    pa, pb = (rng.integers(0, bundle.cfg.vocab_size, n).tolist()
              for n in PREEMPT_PROMPTS)
    pkw = dict(page_size=128, prefill_chunk=512, cache_dtype=cache_dtype,
               **SAMPLE_KW)
    ops.reset_launches()
    peng = ServeEngine(bundle, params, max_batch=2,
                       num_pages=1 + PREEMPT_PAGES,
                       max_seq_len=max(PREEMPT_PROMPTS) + PREEMPT_GEN,
                       prefix_cache=True, preemption=True, preempt_patience=2,
                       **pkw)
    ra = peng.submit(pa, PREEMPT_GEN)
    while len(ra.generated) < 4:
        peng.step()
    rb = peng.submit(pb, PREEMPT_GEN)
    peng.run_to_completion()
    _check_engine_launches(f"{tag} preemption", peng, cache_dtype)
    if peng.preemptions < 1:
        raise AssertionError(f"{tag}: no preemption ({peng.stats()})")
    for p, r in ((pa, ra), (pb, rb)):
        want = chunked_cold_reference(bundle, params, p, PREEMPT_GEN,
                                      req_id=r.req_id, **pkw)
        if r.generated != want:
            raise AssertionError(f"{tag}: preempted request {r.req_id} "
                                 f"{r.generated} != uninterrupted {want}")
    _all_finite(tag, finite)
    n_tok = SERVE_GEN * len(prompts)
    return dict(
        cache_dtype=cache_dtype, **SAMPLE_KW, prompts=list(SERVE_PROMPTS),
        gen=SERVE_GEN, steps=steps, wall_s=wall, tok_per_s=n_tok / wall,
        ms_per_step=1e3 * wall / steps, tokens_per_step=n_tok / steps,
        ms_per_decode_call=_call_ms(marks)["decode"],
        greedy_ms_per_decode_call=_call_ms(greedy_marks)["decode"],
        greedy_wall_s=greedy_marks[-1][0],
        tokens_differing_from_greedy=f"{differ}/{n_tok}",
        card_tokens_equal_to_cpu_sampler=cpu_equal,
        uniforms_equal_to_cpu=True,
        equal_one_at_a_time=True, equal_prefill_chunk_256=True,
        top_k_1_equal_to_greedy=True, temperature_0_equal_to_greedy=True,
        preemptions=peng.preemptions, preempt_resume_equal_to_alone=True,
        streams=streams,
    )


def _spec_workload(cfg, cache_dtype):
    """The speculative serves' prompts (the paged workload's lengths, each
    one 64-token segment from seed 5 repeated) and engine arguments: all
    four admitted at step 0."""
    import numpy as np

    seg = np.random.default_rng(5).integers(
        0, cfg.vocab_size, SPEC_SEGMENT).tolist()
    prompts = [(seg * math.ceil(n / SPEC_SEGMENT))[:n] for n in SERVE_PROMPTS]
    kw = dict(max_batch=4, page_size=128, prefill_chunk=512, prefill_batch=4,
              num_pages=1 + sum(math.ceil((n + SPEC_GEN - 1) / 128)
                                for n in SERVE_PROMPTS),
              max_seq_len=max(SERVE_PROMPTS) + SPEC_GEN,
              cache_dtype=cache_dtype)
    return prompts, kw


def _known_drafter(kind, prompts, streams, vocab):
    """A drafter that knows the plain serve's streams: ``"oracle"``
    proposes their continuation (every draft accepted), ``"wrong"`` each
    of its tokens plus one (every draft rejected).  A history belongs to
    the request whose whole prompt it starts with (the prompts are
    prefixes of one another)."""
    from repro_torch.runtime.spec_decode import DraftProposer

    trajectories = [(len(p), p + g) for p, g in zip(prompts, streams)]

    class Known(DraftProposer):
        name = kind

        def propose(self, history, k, skip=0):
            for n, traj in trajectories:
                if len(history) >= n and history == traj[:len(history)]:
                    d = traj[len(history) + skip:len(history) + skip + k]
                    return [(t + 1) % vocab for t in d] if kind == "wrong" else d
            return []

    return Known()


def serve_spec(dev, bundle, params, cache_dtype, drafters=(), sampled=False):
    """Self-speculative decoding (K = SPEC_K) at full width from a
    ``cache_dtype`` pool on the speculative workload: with the n-gram
    drafter, and each of ``drafters`` ("oracle": the plain serve's own
    continuation, every draft accepted; "wrong": each token plus one,
    every draft rolled back), the token streams and every non-null page of
    the pool (codes and sidecars) equal the plain serve's bit for bit, and
    no page stays allocated; with ``sampled``, the same at SAMPLE_KW.
    Every launch is checked: 28 per prefill call, 28 per decode call and
    28 per verify sub-step (K + 1 per call)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeEngine

    tag = f"serve_spec_{cache_dtype}"
    finite = []
    bundle = _finite_bundle(bundle, finite)
    prompts, kw = _spec_workload(bundle.cfg, cache_dtype)

    def run(**extra):
        ops.reset_launches()
        eng = ServeEngine(bundle, params, **kw, **extra)
        reqs = [eng.submit(p, SPEC_GEN) for p in prompts]
        marks = _drive_calls(eng)
        launches = _check_engine_launches(tag, eng, cache_dtype)
        if eng.stats()["live_pages"]:
            raise AssertionError(f"{tag}: pages left allocated")
        return [r.generated for r in reqs], eng, marks, launches

    def report(eng, marks, launches, base):
        wall = marks[-1][0]
        n_tok = SPEC_GEN * len(prompts)
        st = eng.stats()
        return dict(
            steps=eng.steps, plain_steps=base.steps,
            prefill_calls=eng.prefill_calls, decode_calls=eng.decode_calls,
            verify_calls=eng.verify_calls, spec=st["spec"],
            launches=launches, wall_s=wall, tok_per_s=n_tok / wall,
            ms_per_step=1e3 * wall / eng.steps,
            ms_per_verify_call=_call_ms(marks)["verify"],
            tokens_per_step=n_tok / eng.steps,
        )

    plain, base, base_marks, _ = run()
    base_pool = {name: x.clone() for name, x in base.pool.items()}
    base_wall = base_marks[-1][0]
    out = dict(cache_dtype=cache_dtype, k=SPEC_K, prompts=list(SERVE_PROMPTS),
               segment=SPEC_SEGMENT, gen=SPEC_GEN, plain=dict(
                   steps=base.steps, wall_s=base_wall,
                   tok_per_s=SPEC_GEN * len(prompts) / base_wall,
                   ms_per_step=1e3 * base_wall / base.steps,
                   ms_per_decode_call=_call_ms(base_marks)["decode"]))
    vocab = bundle.cfg.vocab_size
    runs = [("ngram", "ngram")] + [
        (name, _known_drafter(name, prompts, plain, vocab))
        for name in drafters]
    for name, draft in runs:
        got, eng, marks, launches = run(speculate=SPEC_K, draft=draft)
        if got != plain:
            raise AssertionError(f"{tag}/{name}: streams differ from the "
                                 f"plain serve's: {got} vs {plain}")
        if not _pools_equal(eng.pool, base_pool):
            raise AssertionError(f"{tag}/{name}: pool bytes differ from the "
                                 f"plain serve's")
        sp = eng.stats()["spec"]
        if eng.verify_calls < 1 or sp["proposed"] < 1:
            raise AssertionError(f"{tag}/{name}: nothing was drafted ({sp})")
        if name == "oracle" and not sp["accepted"] == sp["proposed"] > 0:
            raise AssertionError(f"{tag}/oracle: {sp}")
        if name == "wrong" and not (sp["accepted"] == 0
                                    and sp["rollbacks"] > 0):
            raise AssertionError(f"{tag}/wrong: {sp}")
        out[name] = report(eng, marks, launches, base)
        del eng
    if sampled:
        want, _, _, _ = run(**SAMPLE_KW)
        got, eng, marks, launches = run(speculate=SPEC_K, **SAMPLE_KW)
        if got != want:
            raise AssertionError(f"{tag}/sampled: streams differ from the "
                                 f"sampled serve without speculation")
        if got == plain:
            raise AssertionError(f"{tag}/sampled: equal to the greedy serve")
        out["sampled"] = dict(**SAMPLE_KW, **report(eng, marks, launches,
                                                    base))
    _all_finite(tag, finite)
    del base_pool
    torch.cuda.empty_cache()
    out.update(streams_equal_to_plain=True, pools_equal_to_plain=True)
    return out


def _async_drive(eng, streamed=None):
    """:func:`_drive_calls`, holding the async contract after every step:
    no token is pending at depth 0, and the tokens ``on_token`` delivered
    so far (``streamed``: request id -> its tokens, from
    :func:`_streamer`) are the read-back ones.  Returns the marks and
    whether a token was ever pending after a step."""
    lagged = []

    def check():
        for r in [x for x in eng._slots if x is not None] + list(
                eng.finished.values()):
            if eng.pipeline_depth == 0 and r.pending:
                raise AssertionError(f"depth 0: request {r.req_id} has "
                                     f"{r.pending} tokens pending")
            lagged.append(r.pending > 0)
            if streamed is not None and len(streamed.get(r.req_id, ())) \
                    != len(r.generated) - r.pending:
                raise AssertionError(
                    f"request {r.req_id}: on_token delivered "
                    f"{len(streamed.get(r.req_id, ()))} of "
                    f"{len(r.generated) - r.pending} read-back tokens")

    return _drive_calls(eng, check), any(lagged)


def _streamer():
    """An ``on_token`` that holds each stream in order and gapless, and
    the per-request counts it delivered."""
    streams = {}

    def on_token(r, idx, tok):
        got = streams.setdefault(r.req_id, [])
        if idx != len(got) or not isinstance(tok, int):
            raise AssertionError(f"on_token: request {r.req_id} index {idx} "
                                 f"after {len(got)} tokens")
        got.append(tok)

    return on_token, streams


def serve_async(dev, bundle, params, cache_dtype, sync_streams):
    """Async pipelining (``pipeline_depth=1``) at full width on the paged
    workload from a ``cache_dtype`` pool, beside the synchronous serve of
    the same workload: sync, async, async, sync, each timed.  Held: every
    stream equals the sync serve's (``sync_streams``, the phase-3 serve)
    and every non-null pool page equals the first sync serve's bit for
    bit; each serve's launches are 28 per call, and the async serves'
    equal the sync serves' per kernel and per call; ``on_token`` delivers
    every stream in order and gapless, equal to ``generated``, lagging the
    host's count at depth 1 (never at depth 0).  Counted under
    ``torch.cuda.set_sync_debug_mode("warn")``: the synchronizing calls
    outside the engine's drain points (held at 0 at both depths) and in
    all.  Returns the report and the two depths' pools."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_steps import count_syncs
    from repro_torch.runtime import ServeEngine

    tag = f"serve_async_{cache_dtype}"
    finite = []
    bundle = _finite_bundle(bundle, finite)
    prompts, kw = _paged_workload(bundle.cfg, cache_dtype)
    runs, pools = [], {}
    for depth in (0, 1, 1, 0):
        on_token, streamed = _streamer()
        ops.reset_launches()
        eng = ServeEngine(bundle, params, pipeline_depth=depth,
                          on_token=on_token, **kw)
        reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
        with count_syncs(eng) as syncs:
            marks, lagged = _async_drive(eng, streamed)
        launches = _check_engine_launches(f"{tag}/depth {depth}", eng,
                                          cache_dtype)
        streams = [r.generated for r in reqs]
        if streams != sync_streams:
            raise AssertionError(f"{tag}/depth {depth}: streams differ from "
                                 f"the sync serve's")
        if [streamed.get(r.req_id) for r in reqs] != streams:
            raise AssertionError(f"{tag}/depth {depth}: on_token streams "
                                 f"differ from generated")
        if lagged != (depth == 1):
            raise AssertionError(f"{tag}/depth {depth}: emission lag "
                                 f"{lagged}")
        if syncs["outside"]:
            raise AssertionError(f"{tag}/depth {depth}: {syncs['outside']} "
                                 f"synchronizing calls outside the drain "
                                 f"points: {syncs['where']}")
        if depth not in pools:
            pools[depth] = {name: x.clone() for name, x in eng.pool.items()}
        elif not _pools_equal(eng.pool, pools[depth]):
            raise AssertionError(f"{tag}/depth {depth}: pool bytes differ "
                                 f"between two serves")
        wall = marks[-1][0]
        runs.append(dict(
            depth=depth, steps=eng.steps, prefill_calls=eng.prefill_calls,
            decode_calls=eng.decode_calls, launches=launches, wall_s=wall,
            tok_per_s=SERVE_GEN * len(prompts) / wall,
            decode_ms_per_step=_call_ms(marks)["decode"],
            syncs_per_step_outside_drain_points=syncs["outside"] / eng.steps,
            syncs_per_step_all=syncs["all"] / eng.steps,
            sync_sites=syncs["where"]))
        del eng
    if not _pools_equal(pools[0], pools[1]):
        raise AssertionError(f"{tag}: async pool bytes differ from sync")
    by_depth = {d: [r for r in runs if r["depth"] == d] for d in (0, 1)}
    for key in ("launches", "prefill_calls", "decode_calls"):
        if {str(r[key]) for r in runs} != {str(runs[0][key])}:
            raise AssertionError(f"{tag}: {key} differ between depths: "
                                 f"{[r[key] for r in runs]}")
    _all_finite(tag, finite)
    return dict(
        cache_dtype=cache_dtype, prompts=list(SERVE_PROMPTS), gen=SERVE_GEN,
        order="sync, async, async, sync", runs=runs,
        tok_per_s={d: [r["tok_per_s"] for r in by_depth[d]] for d in (0, 1)},
        decode_ms_per_step={d: [r["decode_ms_per_step"] for r in by_depth[d]]
                            for d in (0, 1)},
        syncs_per_step_outside_drain_points={
            d: max(r["syncs_per_step_outside_drain_points"]
                   for r in by_depth[d]) for d in (0, 1)},
        syncs_per_step_all={d: max(r["syncs_per_step_all"]
                                   for r in by_depth[d]) for d in (0, 1)},
        streams_equal_to_sync=True, pools_equal_to_sync=True,
        on_token_equal_to_generated=True,
    ), pools


def serve_async_spec(dev, bundle, params):
    """Speculation (K = SPEC_K) at depth 1 on the speculative workload from
    a bf16 pool, with the n-gram, oracle and wrong drafters: each serve's
    streams and non-null pool pages equal the depth-0 serve without
    speculation; launches 28 per prefill, decode call and verify
    sub-step; no synchronizing call outside the drain points (the
    verify's page capture and restore included)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_steps import count_syncs
    from repro_torch.runtime import ServeEngine

    tag = "serve_async_spec_bf16"
    finite = []
    bundle = _finite_bundle(bundle, finite)
    prompts, kw = _spec_workload(bundle.cfg, "bf16")

    def run(**extra):
        ops.reset_launches()
        eng = ServeEngine(bundle, params, **kw, **extra)
        reqs = [eng.submit(p, SPEC_GEN) for p in prompts]
        with count_syncs(eng) as syncs:
            marks, _ = _async_drive(eng)
        if syncs["outside"]:
            raise AssertionError(f"{tag}: {syncs['outside']} synchronizing "
                                 f"calls outside the drain points: "
                                 f"{syncs['where']}")
        launches = _check_engine_launches(tag, eng, "bf16")
        if eng.stats()["live_pages"]:
            raise AssertionError(f"{tag}: pages left allocated")
        return [r.generated for r in reqs], eng, marks, launches

    plain, base, _, _ = run()
    base_pool = {name: x.clone() for name, x in base.pool.items()}
    del base
    out = dict(k=SPEC_K, gen=SPEC_GEN, pipeline_depth=1)
    vocab = bundle.cfg.vocab_size
    for name in ("ngram", "oracle", "wrong"):
        draft = name if name == "ngram" else _known_drafter(
            name, prompts, plain, vocab)
        got, eng, marks, launches = run(speculate=SPEC_K, draft=draft,
                                        pipeline_depth=1)
        if got != plain:
            raise AssertionError(f"{tag}/{name}: streams differ from the "
                                 f"depth-0 serve without speculation")
        if not _pools_equal(eng.pool, base_pool):
            raise AssertionError(f"{tag}/{name}: pool bytes differ")
        sp = eng.stats()["spec"]
        if eng.verify_calls < 1:
            raise AssertionError(f"{tag}/{name}: no verify call ({sp})")
        if name == "oracle" and not sp["accepted"] == sp["proposed"] > 0:
            raise AssertionError(f"{tag}/oracle: {sp}")
        if name == "wrong" and not (sp["accepted"] == 0
                                    and sp["rollbacks"] > 0):
            raise AssertionError(f"{tag}/wrong: {sp}")
        wall = marks[-1][0]
        out[name] = dict(steps=eng.steps, verify_calls=eng.verify_calls,
                         decode_calls=eng.decode_calls, spec=sp,
                         launches=launches, wall_s=wall,
                         tok_per_s=SPEC_GEN * len(prompts) / wall)
        del eng
    _all_finite(tag, finite)
    out.update(streams_equal_to_depth_0=True, pools_equal_to_depth_0=True)
    return out


def serve_cancel(dev, bundle, params, sync_streams):
    """Cancellation at depth 1 on the paged workload from a bf16 pool with
    the prefix cache: request 0's client hangs up after CANCEL_AFTER
    tokens (``on_token`` flags it; the serve loop cancels between steps).
    Held: its full prompt pages are donated; its tokens are a prefix of
    the uncancelled stream; the other three streams equal the uncancelled
    serve's (``sync_streams``); free + resident pages == allocatable; the
    same prompt again hits the donated pages and streams as before."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import CANCELLED, ServeEngine

    tag = "serve_cancel_bf16"
    finite = []
    bundle = _finite_bundle(bundle, finite)
    prompts, kw = _paged_workload(bundle.cfg, "bf16")
    hangup = []

    def on_token(r, idx, tok):
        if r.req_id == 0 and idx + 1 >= CANCEL_AFTER and not hangup:
            hangup.append(r.req_id)

    ops.reset_launches()
    eng = ServeEngine(bundle, params, prefix_cache=True, pipeline_depth=1,
                      on_token=on_token, **kw)
    reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
    cancelled_at = None
    while not eng.idle:
        eng.step()
        if hangup and cancelled_at is None:
            if not eng.cancel(hangup[0]):
                raise AssertionError(f"{tag}: cancel returned False")
            cancelled_at = len(reqs[0].generated)
            resident = eng.prefix_cache.cached_pages
    eng.drain()
    if cancelled_at is None:
        raise AssertionError(f"{tag}: request 0 was never cancelled")
    victim = reqs[0]
    if victim.state != CANCELLED or eng.cancellations != 1:
        raise AssertionError(f"{tag}: state {victim.state}, "
                             f"{eng.cancellations} cancellations")
    n = len(victim.generated)
    if n < CANCEL_AFTER or victim.generated != sync_streams[0][:n]:
        raise AssertionError(f"{tag}: the cancelled stream {victim.generated}"
                             f" is not a prefix of {sync_streams[0]}")
    if n >= SERVE_GEN:
        raise AssertionError(f"{tag}: request 0 ran to its end")
    if resident < len(prompts[0]) // 128:
        raise AssertionError(f"{tag}: {resident} pages cached after the "
                             f"cancel")
    others = [r.generated for r in reqs[1:]]
    if others != sync_streams[1:]:
        raise AssertionError(f"{tag}: the other streams changed")
    allocatable = eng.num_pages - 1
    cached = eng.prefix_cache.cached_pages
    if eng.allocator.free_pages + cached != allocatable:
        raise AssertionError(f"{tag}: free {eng.allocator.free_pages} + "
                             f"cached {cached} != {allocatable}")
    again = eng.submit(prompts[0], SERVE_GEN)
    eng.run_to_completion()
    launches = _check_engine_launches(tag, eng, "bf16")
    want_hit = (len(prompts[0]) - 1) // 128 * 128
    if again.cached_len != want_hit or again.generated != sync_streams[0]:
        raise AssertionError(f"{tag}: the same prompt again: cached "
                             f"{again.cached_len}, stream {again.generated}")
    _all_finite(tag, finite)
    return dict(cancel_after=CANCEL_AFTER, tokens_at_cancel=cancelled_at,
                tokens_read_back=n, pages_resident_after_cancel=resident,
                free_plus_cached=eng.allocator.free_pages
                + eng.prefix_cache.cached_pages,
                allocatable=allocatable, again_cached_len=again.cached_len,
                cancellations=eng.cancellations, launches=launches,
                others_equal_to_uncancelled=True, again_equal=True)


def serve_telemetry(dev, bundle, params, cache_dtype, sync_streams, pools):
    """Telemetry fully on (trace, metrics, the probe every
    TELEMETRY_PROBE_EVERY steps) against fully off (``pools``: the async
    phase's pools at depths 0 and 1) on the paged workload from a
    ``cache_dtype`` pool: streams and non-null pool pages equal at both
    depths; the Chrome trace parses with one plan and one retire span per
    step and 4 submit / first-token / finish instants; every probe
    reading on the card equals the numpy probe on the same pages copied
    out; no synchronizing call outside the drain points (the probe's
    reads are inside one, counted in all)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_steps import count_syncs
    from repro_torch.runtime import NumericsProbe, ServeEngine, Telemetry

    tag = f"serve_telemetry_{cache_dtype}"
    finite = []
    bundle = _finite_bundle(bundle, finite)
    prompts, kw = _paged_workload(bundle.cfg, cache_dtype)
    out = dict(cache_dtype=cache_dtype, probe_every=TELEMETRY_PROBE_EVERY)
    for depth in (0, 1):
        tel = Telemetry(tracing=True, metrics=True,
                        numerics_every=TELEMETRY_PROBE_EVERY)
        checked = []
        sample = tel.probe.sample

        def probe_and_hold(pool, pages_valid, *, n_kv_heads):
            reading = sample(pool, pages_valid, n_kv_heads=n_kv_heads)
            pages = [(p, v) for p, v in pages_valid
                     if v > 0][:tel.probe.max_pages]
            if reading is None or not pages:
                return reading
            layer = tel.probe.layer
            idx = [p for p, _ in pages]
            host = {name: pool[name][layer:layer + 1][:, idx].cpu()
                    for name in ("k", "k_scale", "k_shift") if name in pool}
            want = NumericsProbe(max_pages=tel.probe.max_pages).sample(
                host, [(i, v) for i, (_, v) in enumerate(pages)],
                n_kv_heads=n_kv_heads)
            if want != reading:
                raise AssertionError(f"{tag}: the probe's reading on the "
                                     f"card {reading} != numpy's {want}")
            checked.append(reading)
            return reading

        tel.probe.sample = probe_and_hold
        ops.reset_launches()
        eng = ServeEngine(bundle, params, pipeline_depth=depth,
                          telemetry=tel, **kw)
        reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
        with count_syncs(eng) as syncs:
            marks, _ = _async_drive(eng)
        if syncs["outside"]:
            raise AssertionError(f"{tag}/depth {depth}: {syncs['outside']} "
                                 f"synchronizing calls outside the drain "
                                 f"points: {syncs['where']}")
        _check_engine_launches(f"{tag}/depth {depth}", eng, cache_dtype)
        if [r.generated for r in reqs] != sync_streams:
            raise AssertionError(f"{tag}/depth {depth}: streams differ")
        if not _pools_equal(eng.pool, pools[depth]):
            raise AssertionError(f"{tag}/depth {depth}: pool bytes differ "
                                 f"from the serve without telemetry")
        path = ROOT / "build" / f"smoke_trace_{cache_dtype}_d{depth}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        n_events = tel.tracer.write_chrome_trace(str(path))
        doc = json.loads(path.read_text())
        spans = [(e["name"], e["args"]["step"]) for e in doc["traceEvents"]
                 if e["ph"] == "X"]
        for name in ("plan", "retire"):
            got = sorted(st for n, st in spans if n == name)
            if got != list(range(eng.steps)):
                raise AssertionError(f"{tag}/depth {depth}: {name} spans at "
                                     f"steps {got}, {eng.steps} steps")
        instants = [e["name"] for e in doc["traceEvents"] if e["ph"] == "i"]
        life = {n: instants.count(n) for n in ("submit", "first_token",
                                               "finish")}
        if life != {"submit": 4, "first_token": 4, "finish": 4}:
            raise AssertionError(f"{tag}/depth {depth}: lifecycle {life}")
        if not checked:
            raise AssertionError(f"{tag}/depth {depth}: the probe never ran")
        snap = tel.metrics_snapshot()
        wall = marks[-1][0]
        out[f"depth_{depth}"] = dict(
            steps=eng.steps, wall_s=wall,
            tok_per_s=SERVE_GEN * len(prompts) / wall,
            trace_events=n_events, lifecycle=life,
            syncs_per_step_outside_drain_points=syncs["outside"] / eng.steps,
            syncs_per_step_all=syncs["all"] / eng.steps,
            probe_readings_checked=len(checked), last_reading=checked[-1],
            ttft_steps=snap["histograms"]["serve.ttft_steps"],
            step_seconds_p50=snap["histograms"]["serve.step_seconds"]["p50"],
            tokens_emitted=snap["counters"]["serve.tokens_emitted"]["value"])
        del eng
    _all_finite(tag, finite)
    out.update(streams_equal_to_off=True, pools_equal_to_off=True,
               probe_equal_to_numpy=True)
    return out


@contextlib.contextmanager
def _plain_decode(at=None):
    """``ops.pasa_decode`` replaced by its plain version (on any device)
    inside the block, at the policy ``at`` if one is given, else at the
    caller's: the model's dense decode then runs the plain PyTorch
    attention on the card."""
    from repro_torch.kernels import ops
    mod = _kernel_module("pasa_decode")

    kernel_op = ops.pasa_decode
    ops.pasa_decode = lambda q, k, v, kv_len, *, beta, policy, block_kv: (
        mod.decode_plain(q, k, v, kv_len, beta=beta, policy=at or policy,
                         block_kv=block_kv))
    try:
        yield
    finally:
        ops.pasa_decode = kernel_op


def serve_hybrid(dev):
    """zamba2-1.2b at full width (HYBRID_LAYERS of its 38 Mamba-2 layers,
    the shared attention block applied once every 6, head_dim 64) with
    random weights (seed 0): bf16
    weights, an fp32 lm_head and fp32 Mamba conv / SSM parameters.
    HYBRID_BATCH prompts of HYBRID_PROMPT tokens, SERVE_GEN greedy tokens
    each, through launch/serve.py's token-by-token route on a
    HYBRID_MAX_LEN-row cache.  Every logit finite; the contiguous decode
    kernel launched once per application per step, all at head_dim 64,
    and no other
    kernel; the prompts HYBRID_ALONE served alone give their batched
    streams; the first generated step's logits within HYBRID_LOGIT_ATOL of
    the same step through the kernels' plain versions on the card from the
    same cache.  Returns the report."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.pasa_paged_decode import mode_name
    from repro_torch.launch.serve import cache_bytes, token_by_token
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.hybrid import n_shared_apps
    from repro_torch.models.model_zoo import build

    cfg = dataclasses.replace(get_config("zamba2-1.2b"),
                              n_layers=HYBRID_LAYERS)
    bundle = build(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = _leaves(params)
    finite = []
    checked = _finite_bundle(bundle, finite)
    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (HYBRID_BATCH, HYBRID_PROMPT), dtype=np.int32)).to(dev)

    def run(rows):
        cache = bundle.init_cache(rows.shape[0], HYBRID_MAX_LEN, device=dev)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out, cache, times = token_by_token(checked, params, rows, SERVE_GEN,
                                           cache)
        return out, cache, [t - t_start for t in times]

    run(prompts[:1, :8])                  # warm-up (cuBLAS first calls)
    finite.clear()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    streams, cache, times = run(prompts)
    names = [w.__name__ for w in ops.WRAPPERS]
    launches = {name: getattr(ops, name).launches for name in names}
    by_mode = _by_mode(names)
    n_steps = HYBRID_PROMPT + SERVE_GEN - 1
    apps = n_shared_apps(cfg)
    want = {name: apps * n_steps if name == "pasa_decode" else 0
            for name in names}
    if launches != want:
        raise AssertionError(f"serve_hybrid: launch counts {launches} != "
                             f"{want}")
    mode = mode_name(get_policy(cfg.attention.pasa_policy), torch.bfloat16,
                     cfg.head_dim)
    if by_mode["pasa_decode"] != {mode: apps * n_steps}:
        raise AssertionError(f"serve_hybrid: contiguous decode launches by "
                             f"mode {by_mode['pasa_decode']} != {mode!r}")
    _all_finite("serve_hybrid", finite)
    if streams.shape != (HYBRID_BATCH, SERVE_GEN) or not (
            (streams >= 0) & (streams < cfg.vocab_size)).all():
        raise AssertionError(f"serve_hybrid: bad streams {streams}")
    peak = torch.cuda.max_memory_allocated()
    cache_mb = {part: cache_bytes(cache[part]) / 1e6 for part in cache}
    del cache
    for i in HYBRID_ALONE:
        alone, _, _ = run(prompts[i:i + 1])
        if not np.array_equal(alone[0], streams[i]):
            raise AssertionError(
                f"serve_hybrid: batched vs one-at-a-time streams differ: "
                f"{streams[i].tolist()} vs {alone[0].tolist()}")
    # the first generated step from one cache: the kernel, then the plain
    # versions on the card
    cache = bundle.init_cache(HYBRID_BATCH, HYBRID_MAX_LEN, device=dev)
    step = make_serve_step(bundle)
    for i in range(HYBRID_PROMPT - 1):
        pos = torch.full((HYBRID_BATCH,), i, dtype=torch.int32, device=dev)
        _, _, cache = step(params, prompts[:, i], pos, cache)
    saved = {part: {k: v.clone() for k, v in cache[part].items()}
             for part in cache}
    pos = torch.full((HYBRID_BATCH,), HYBRID_PROMPT - 1, dtype=torch.int32,
                     device=dev)
    kernel_logits, _ = bundle.serve_step(params, prompts[:, -1], pos, cache)
    with _plain_decode():
        plain_logits, _ = bundle.serve_step(params, prompts[:, -1], pos, saved)
    err = float((kernel_logits - plain_logits).abs().max())
    if not err <= HYBRID_LOGIT_ATOL:
        raise AssertionError(f"serve_hybrid: first-step logits differ from "
                             f"the plain route's by {err:.3e}")
    wall = times[-1]
    return dict(
        arch=cfg.arch_id, layers=cfg.n_layers, d_model=cfg.d_model,
        head_dim=cfg.head_dim, shared_block_applications=apps,
        params=sum(x.numel() for x in weights),
        param_gb=sum(x.numel() * x.element_size() for x in weights) / 1e9,
        weights_s=init_s, batch=HYBRID_BATCH, prompt_len=HYBRID_PROMPT,
        gen=SERVE_GEN, max_len=HYBRID_MAX_LEN, steps=n_steps,
        launches=launches, launches_by_mode=by_mode, wall_s=wall,
        tok_per_s=streams.size / wall, ms_per_step=1e3 * wall / n_steps,
        ttft_ms=1e3 * times[0],
        decode_ms_per_step=1e3 * (times[-1] - times[0]) / (SERVE_GEN - 1),
        peak_gb=peak / 1e9, cache_mb=cache_mb,
        first_step_logit_err_vs_plain=err, streams=streams.tolist(),
    )


@contextlib.contextmanager
def _plain_attention(at=None):
    """``ops.pasa_decode`` and ``ops.pasa_attention`` replaced by their
    plain versions (on any device) inside the block, at the policy ``at``
    if one is given: the model's decode and its whole-sequence attention
    (with its shift) then run the plain PyTorch attention on the card."""
    from repro_torch.kernels import ops
    amod = _kernel_module("pasa_attention")

    kernel_op = ops.pasa_attention
    ops.pasa_attention = lambda q, k, v, *, beta, policy, block_q, block_kv, \
        causal, kv_valid, gemm_shift=True: amod.attention_plain(
            q, k, v, beta=beta, policy=at or policy, block_kv=block_kv,
            causal=causal, kv_valid=kv_valid, gemm_shift=gemm_shift)
    try:
        with _plain_decode(at):
            yield
    finally:
        ops.pasa_attention = kernel_op


def serve_whisper(dev):
    """whisper-large-v3 at full width (32 encoder and WHISPER_LAYERS of 32
    decoder layers, d 1280, 20 / 20 heads of 64) with random weights
    (seed 0):
    bf16 weights, an fp32 lm_head.  WHISPER_BATCH clips of WHISPER_FRAMES
    frame embeddings (d_model wide, drawn from seed 0) encoded once into
    the cache's ``enc_out`` (shift-KV and the attention kernel at head_dim
    64 with kv_valid 1500 of 1536 rows, 32 each); then WHISPER_PROMPT-token
    prompts and SERVE_GEN greedy tokens each, token by token through
    launch/serve.py's route on a WHISPER_MAX_LEN-row cache: per step and
    decoder layer a contiguous decode (self-attention), a shift-KV and an
    attention launch (the cross-attention: one query row padded to 64,
    1,500 keys
    in 1,536 rows), all in the d64 modes, and no other kernel.  Every
    logit finite; the prompts WHISPER_ALONE served alone from their rows
    of ``enc_out`` give their batched streams; the first generated step's
    logits within HYBRID_LOGIT_ATOL of the same step through the kernels'
    plain versions on the card from the same cache.  Returns the report
    (TTFT counts the encode)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.pasa_paged_decode import mode_name
    from repro_torch.kernels.shift_kv import mode_name as shift_mode
    from repro_torch.launch.serve import cache_bytes, token_by_token
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.model_zoo import build
    from repro_torch.models.multimodal import whisper_encode

    cfg = dataclasses.replace(get_config("whisper-large-v3"),
                              n_layers=WHISPER_LAYERS)
    bundle = build(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = _leaves(params)
    finite = []
    checked = _finite_bundle(bundle, finite)
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal(
        (WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)).to(dev)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT),
        dtype=np.int32)).to(dev)
    names = [w.__name__ for w in ops.WRAPPERS]
    fp16 = get_policy(cfg.attention.pasa_policy)
    modes = {"pasa_decode": mode_name(fp16, torch.bfloat16, cfg.head_dim),
             "pasa_attention": mode_name(fp16, torch.bfloat16, cfg.head_dim),
             "shift_kv": shift_mode(torch.bfloat16, torch.float16,
                                    cfg.attention.block_kv, cfg.head_dim)}

    def check(tag, per_op):
        launches = {name: getattr(ops, name).launches for name in names}
        want = {name: per_op if name in per_op_names else 0
                for name in names}
        if launches != want:
            raise AssertionError(f"serve_whisper ({tag}): launch counts "
                                 f"{launches} != {want}")
        by_mode = _by_mode(names)
        for name in per_op_names:
            if by_mode[name] != ({modes[name]: per_op} if per_op else {}):
                raise AssertionError(f"serve_whisper ({tag}): {name} "
                                     f"launches by mode {by_mode[name]}")
        return launches, by_mode

    def encode(x):
        enc = whisper_encode(params, cfg, x)
        torch.cuda.synchronize()
        return enc

    def run(rows, enc_rows):
        cache = bundle.init_cache(rows.shape[0], WHISPER_MAX_LEN, device=dev)
        cache["enc_out"].copy_(enc_rows)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out, cache, times = token_by_token(checked, params, rows, SERVE_GEN,
                                           cache)
        return out, cache, [t - t_start for t in times]

    encode(frames[:1])                    # warm-up (cuBLAS first calls)
    run(prompts[:1, :8], torch.zeros(1, WHISPER_FRAMES, cfg.d_model,
                                     device=dev))
    finite.clear()
    torch.cuda.reset_peak_memory_stats()
    per_op_names = ("shift_kv", "pasa_attention")
    ops.reset_launches()
    t_enc = time.perf_counter()
    enc = encode(frames)
    encode_s = time.perf_counter() - t_enc
    enc_launches, enc_by_mode = check("encode", cfg.n_encoder_layers)
    if not bool(torch.isfinite(enc).all()):
        raise AssertionError("serve_whisper: non-finite encoder output")
    per_op_names = ("pasa_decode", "shift_kv", "pasa_attention")
    ops.reset_launches()
    streams, cache, times = run(prompts, enc)
    n_steps = WHISPER_PROMPT + SERVE_GEN - 1
    launches, by_mode = check("serve", cfg.n_layers * n_steps)
    _all_finite("serve_whisper", finite)
    if streams.shape != (WHISPER_BATCH, SERVE_GEN) or not (
            (streams >= 0) & (streams < cfg.vocab_size)).all():
        raise AssertionError(f"serve_whisper: bad streams {streams}")
    peak = torch.cuda.max_memory_allocated()
    cache_mb = {part: cache_bytes(cache[part]) / 1e6 for part in cache}
    del cache
    for i in WHISPER_ALONE:
        alone, _, _ = run(prompts[i:i + 1], enc[i:i + 1])
        if not np.array_equal(alone[0], streams[i]):
            raise AssertionError(
                f"serve_whisper: batched vs one-at-a-time streams differ: "
                f"{streams[i].tolist()} vs {alone[0].tolist()}")
    # the first generated step from one cache: the kernels, then the plain
    # versions on the card
    cache = bundle.init_cache(WHISPER_BATCH, WHISPER_MAX_LEN, device=dev)
    cache["enc_out"].copy_(enc)
    step = make_serve_step(bundle)
    for i in range(WHISPER_PROMPT - 1):
        pos = torch.full((WHISPER_BATCH,), i, dtype=torch.int32, device=dev)
        _, _, cache = step(params, prompts[:, i], pos, cache)
    saved = {k: v.clone() for k, v in cache.items()}
    pos = torch.full((WHISPER_BATCH,), WHISPER_PROMPT - 1, dtype=torch.int32,
                     device=dev)
    kernel_logits, _ = bundle.serve_step(params, prompts[:, -1], pos, cache)
    with _plain_attention():
        plain_logits, _ = bundle.serve_step(params, prompts[:, -1], pos, saved)
    err = float((kernel_logits - plain_logits).abs().max())
    if not err <= HYBRID_LOGIT_ATOL:
        raise AssertionError(f"serve_whisper: first-step logits differ from "
                             f"the plain route's by {err:.3e}")
    wall = times[-1]
    return dict(
        arch=cfg.arch_id, encoder_layers=cfg.n_encoder_layers,
        layers=cfg.n_layers, d_model=cfg.d_model, head_dim=cfg.head_dim,
        params=sum(x.numel() for x in weights),
        param_gb=sum(x.numel() * x.element_size() for x in weights) / 1e9,
        weights_s=init_s, batch=WHISPER_BATCH, frames=WHISPER_FRAMES,
        prompt_len=WHISPER_PROMPT, gen=SERVE_GEN, max_len=WHISPER_MAX_LEN,
        steps=n_steps, encode_launches=enc_launches,
        encode_launches_by_mode=enc_by_mode, launches=launches,
        launches_by_mode=by_mode, encode_ms=1e3 * encode_s, wall_s=wall,
        tok_per_s=streams.size / wall, ms_per_step=1e3 * wall / n_steps,
        ttft_ms=1e3 * (encode_s + times[0]),
        decode_ms_per_step=1e3 * (times[-1] - times[0]) / (SERVE_GEN - 1),
        peak_gb=peak / 1e9, cache_mb=cache_mb,
        first_step_logit_err_vs_plain=err, streams=streams.tolist(),
    )


# ---------------------------------------------------------------- phase 11 --


def _group_decode(dev, rng, kvh, g, lens):
    """A shuffled bf16 pool of sequences of ``lens`` (KVH ``kvh``, D 128,
    page 128, keys of mean 30, NaN past kv_len), the same rows as a
    (B, S2, KVH, D) cache read through strides, queries of mean 0 at
    group ``g``, and their float64 gold."""
    import torch

    d, page = 128, 128
    b = len(lens)
    kp, vp, table = _paged_pool(rng, lens, kvh, d, page, 30.0, 3, dev)
    n = table.shape[1] * page
    kview = kp[table.long()].reshape(b, n, kvh, d).transpose(1, 2)
    vview = vp[table.long()].reshape(b, n, kvh, d).transpose(1, 2)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = _randn(rng, (b, kvh, g, d), 0.0, dev, torch.float16)
    gold = []
    for i, n_i in enumerate(lens):
        kk, vv = _gathered(kp, table[i], n_i), _gathered(vp, table[i], n_i)
        sc = q[i].double() @ kk.transpose(-1, -2) / math.sqrt(d)
        gold.append(torch.softmax(sc, -1) @ vv)
    return kp, vp, table, kview, vview, kv_len, q, torch.stack(gold)


def _decode_library_ms(q, kview, vview, kv_len, quant=None, table=None):
    """SDPA over the expanded (and, from an 8-bit pool, dequantized) K/V,
    neither step timed."""
    import torch
    import torch.nn.functional as F

    b, kvh, g, d = q.shape
    if quant:
        mod = _kernel_module("pasa_paged_decode")
        mp, page = table.shape[1], kview.shape[1]
        kview, vview = (mod._gather_dequant(
            x, quant[f"{side}_scale"], quant[f"{side}_shift"], table,
            torch.float16).reshape(b, mp * page, kvh, d).movedim(1, 2)
            for side, x in (("k", kview), ("v", vview)))
    ke, ve = (torch.nan_to_num(x.half()).repeat_interleave(g, 1)
              for x in (kview, vview))
    s2 = ke.shape[2]
    mask = (torch.arange(s2, device=q.device)[None, :] < kv_len[:, None])
    return _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q.reshape(b, kvh * g, 1, d), ke, ve,
        attn_mask=mask[:, None, None, :]), 20)


def _group_entry(name, tag, arch, kvh, g, **fields):
    source, replaces = _kernel_source(f"{name}/{tag}")
    return dict(name=f"{name}/{tag}", route="cuda", source=source,
                replaces=replaces, arch=arch, kvh=kvh, group=g, **fields)


def check_groups(dev):
    """Each kernel at the GQA groups of the dense configs (GROUP_SHAPES,
    head_dim 128, fp16 PASA at BETA): the paged decode kernel at a paged
    serve's decode call (batch 4, kv SERVE_DECODE_KV, keys of mean 30,
    queries of mean 0), the contiguous decode kernel at the dense serve's
    kv (four rows at DENSE_PROMPT + 2, bit-equal to paged decode on the
    same rows), the paged prefill kernel on the prefill fixture's rows (4
    x 512 queries of mean 1 at starts 0 / 512 / 1024 and a pad row, keys
    of mean 2), each against its plain version (DECODE_TOL / PREFILL_TOL)
    and within RMSE_MAX of float64.  At the served configs' groups
    (SERVED_GROUPS: qwen3-4b's G 4, olmoe-1b-7b's G 1 over 16 kv heads)
    also both paged kernels from the 8-bit pools their serves run
    (``_check_quant_policies``, debris inert), shift-KV on their dense
    prefill's keys (4, KVH, 1024, 128) and the causal attention kernel at
    (4, KVH G, KVH, 1024, 128) (queries of mean 0, keys of mean 2).  Every
    entry timed beside its plain version and its library call, with its
    bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.core.shifting import effective_invariance
    from repro_torch.kernels import ops
    pmod = _kernel_module("pasa_paged_decode")
    cmod = _kernel_module("pasa_decode")
    fmod = _kernel_module("pasa_paged_prefill")
    smod = _kernel_module("shift_kv")
    amod = _kernel_module("pasa_attention")

    d, page = 128, 128
    rng = np.random.default_rng(11)
    entries = []
    for arch, kvh, g in GROUP_SHAPES:
        tag, pools = SERVED_GROUPS.get(arch, (f"g{g}", ()))
        # paged decode at the paged serve's call
        lens = SERVE_DECODE_KV
        b = len(lens)
        kp, vp, table, kview, vview, kv_len, q, gold = _group_decode(
            dev, rng, kvh, g, lens)
        run = lambda policy=FP16, kp=kp, vp=vp, quant={}: \
            ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                  policy=policy, **quant)
        plain_of = lambda policy=FP16, kp=kp, vp=vp, quant={}: \
            pmod.paged_decode_plain(q, kp, vp, table, kv_len, beta=BETA,
                                    policy=policy, block_kv=page, **quant)
        got, plain = run(), plain_of()
        torch.cuda.synchronize()
        err = _close(f"pasa_paged_decode/{tag}", got, plain, **DECODE_TOL)
        rmse, rmse_plain = _rel_rmse(got, gold), _rel_rmse(plain, gold)
        if not (rmse < RMSE_MAX and rmse_plain < RMSE_MAX):
            raise AssertionError(f"pasa_paged_decode/{tag} RMSE {rmse:.4f} / "
                                 f"plain {rmse_plain:.4f}")
        nbytes, flops = R.paged_decode_cost(b, kvh, g, d, lens, table.numel())
        entries.append(_group_entry(
            "pasa_paged_decode", tag, arch, kvh, g, max_abs_err=err,
            rmse=rmse, rmse_plain=rmse_plain, ms=_cuda_time_ms(run, 50),
            plain_ms=_cuda_time_ms(plain_of, 3, warmup=1),
            library_ms=_decode_library_ms(q, kview, vview, kv_len),
            **R.bound(nbytes, flops)))
        for dtype in pools:
            kq, vq, quant, valid = _quantize_pool(kp, vp, table, lens,
                                                  dtype)
            held, got_q = _check_quant_policies(
                f"pasa_paged_decode/{tag}", lambda p: run(p, kq, vq, quant),
                lambda p: plain_of(p, kq, vq, quant), gold, got, dtype,
                DECODE_TOL)
            kq2, vq2, quant2 = _poison(kq, vq, quant, valid)
            if not torch.equal(run(FP16, kq2, vq2, quant2), got_q):
                raise AssertionError(f"pasa_paged_decode/{tag}_{dtype}: "
                                     f"debris changed the output")
            qbytes, _ = R.paged_decode_cost(
                b, kvh, g, d, lens, table.numel(),
                kv_itemsize=kq.element_size(), page=page)
            entries.append(_group_entry(
                "pasa_paged_decode", f"{tag}_{dtype}", arch, kvh, g,
                max_abs_err=held["max_abs_err_fp16"],
                rmse=held["rmse_fp16"], detail=held,
                ms=_cuda_time_ms(lambda: run(FP16, kq, vq, quant), 50),
                plain_ms=_cuda_time_ms(
                    lambda: plain_of(FP16, kq, vq, quant), 3, warmup=1),
                library_ms=_decode_library_ms(q, kq, vq, kv_len, quant,
                                              table),
                **R.bound(qbytes, flops)))
        del kp, vp, kview, vview
        # contiguous decode at the dense serve's kv, == paged decode
        lens = (DENSE_PROMPT + 2,) * DENSE_BATCH
        b = len(lens)
        kp, vp, table, kview, vview, kv_len, q, gold = _group_decode(
            dev, rng, kvh, g, lens)
        run = lambda: ops.pasa_decode(q, kview, vview, kv_len, beta=BETA,
                                      policy=FP16, block_kv=page)
        plain_of = lambda: cmod.decode_plain(q, kview, vview, kv_len,
                                             beta=BETA, policy=FP16,
                                             block_kv=page)
        got, plain = run(), plain_of()
        paged = ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                      policy=FP16)
        torch.cuda.synchronize()
        if not torch.equal(got, paged):
            raise AssertionError(f"pasa_decode/{tag} != paged decode")
        err = _close(f"pasa_decode/{tag}", got, plain, **DECODE_TOL)
        rmse, rmse_plain = _rel_rmse(got, gold), _rel_rmse(plain, gold)
        if not (rmse < RMSE_MAX and rmse_plain < RMSE_MAX):
            raise AssertionError(f"pasa_decode/{tag} RMSE {rmse:.4f} / "
                                 f"plain {rmse_plain:.4f}")
        entries.append(_group_entry(
            "pasa_decode", tag, arch, kvh, g, max_abs_err=err, rmse=rmse,
            rmse_plain=rmse_plain, paged_bit_equal=True,
            ms=_cuda_time_ms(run, 50),
            plain_ms=_cuda_time_ms(plain_of, 3, warmup=1),
            library_ms=_decode_library_ms(q, kview, vview, kv_len),
            **R.bound(*R.decode_cost(b, kvh, g, d, lens))))
        del kp, vp, kview, vview
        # paged prefill on the prefill fixture's rows
        h, cs = kvh * g, PREFILL_CHUNK
        starts, kv_lens = PREFILL_ROWS
        b = len(starts)
        kp, vp, table = _paged_pool(rng, kv_lens, kvh, d, page, 2.0, 2, dev)
        table[3] = 0                               # pad row: all-null table
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        kv_len = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
        q = _randn(rng, (b, h, cs, d), 1.0, dev, torch.float16)
        run = lambda policy=FP16, kp=kp, vp=vp, quant={}: \
            ops.pasa_paged_prefill(q, kp, vp, table, start, kv_len,
                                   beta=BETA, policy=policy, **quant)
        plain_of = lambda policy=FP16, kp=kp, vp=vp, quant={}: \
            fmod.paged_prefill_plain(q, kp, vp, table, start, kv_len,
                                     beta=BETA, policy=policy, **quant)
        got, plain = run(), plain_of()
        torch.cuda.synchronize()
        err = _close(f"pasa_paged_prefill/{tag}", got, plain, **PREFILL_TOL)
        if got[3].abs().max() != 0:
            raise AssertionError(f"pasa_paged_prefill/{tag}: pad row not zero")
        gold = _prefill_gold(q, kp, vp, table)
        rmse, rmse_plain = _rel_rmse(got[:3], gold), _rel_rmse(plain[:3], gold)
        if not (rmse < RMSE_MAX and rmse_plain < RMSE_MAX):
            raise AssertionError(f"pasa_paged_prefill/{tag} RMSE {rmse:.4f} "
                                 f"/ plain {rmse_plain:.4f}")
        mp = table.shape[1]
        col = torch.arange(mp * page, device=dev)
        qpos = start[:, None] + torch.arange(cs, device=dev)[None, :]
        mask = ((col[None, None, :] <= qpos[:, :, None])
                & (col[None, None, :] < kv_len[:, None, None]))[:, None]

        def library(quant={}, kp=kp, vp=vp):
            kg, vg = (
                torch.nan_to_num(pmod._gather_dequant(
                    x, quant.get(f"{side}_scale"), quant.get(f"{side}_shift"),
                    table, torch.float16).reshape(b, mp * page, kvh, d)
                    .movedim(1, 2)).repeat_interleave(g, 1)
                for side, x in (("k", kp), ("v", vp)))
            return _cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, kg, vg, attn_mask=mask), 10)

        nbytes, flops = R.paged_prefill_cost(b, h, cs, d, kvh, starts,
                                             kv_lens, table.numel())
        entries.append(_group_entry(
            "pasa_paged_prefill", tag, arch, kvh, g, max_abs_err=err,
            rmse=rmse, rmse_plain=rmse_plain, ms=_cuda_time_ms(run, 20),
            plain_ms=_cuda_time_ms(plain_of, 3, warmup=1),
            library_ms=library(), **R.bound(nbytes, flops)))
        for dtype in pools:
            kq, vq, quant, valid = _quantize_pool(kp, vp, table, kv_lens,
                                                  dtype)
            held, got_q = _check_quant_policies(
                f"pasa_paged_prefill/{tag}",
                lambda p: run(p, kq, vq, quant),
                lambda p: plain_of(p, kq, vq, quant), gold, got, dtype,
                PREFILL_TOL, rows=slice(0, 3))
            kq2, vq2, quant2 = _poison(kq, vq, quant, valid)
            if not torch.equal(run(FP16, kq2, vq2, quant2), got_q):
                raise AssertionError(f"pasa_paged_prefill/{tag}_{dtype}: "
                                     f"debris changed the output")
            qbytes, _ = R.paged_prefill_cost(
                b, h, cs, d, kvh, starts, kv_lens, table.numel(),
                kv_itemsize=kq.element_size(), page=page)
            entries.append(_group_entry(
                "pasa_paged_prefill", f"{tag}_{dtype}", arch, kvh, g,
                max_abs_err=held["max_abs_err_fp16"],
                rmse=held["rmse_fp16"], detail=held,
                ms=_cuda_time_ms(lambda: run(FP16, kq, vq, quant), 20),
                plain_ms=_cuda_time_ms(
                    lambda: plain_of(FP16, kq, vq, quant), 3, warmup=1),
                library_ms=library(quant, kq, vq),
                **R.bound(qbytes, flops)))
        del kp, vp, q
        if arch not in SERVED_GROUPS:
            continue
        # shift-KV on the served config's dense-prefill keys: bf16 (B, S,
        # KVH, D) read through strides, fp16 operands, block 128
        b, s = DENSE_BATCH, ATTN_SHAPE[3]
        k = _randn(rng, (b, s, kvh, d), 5.0, dev,
                   torch.bfloat16).transpose(1, 2)
        m = smod.device_matrix(page, d, BETA, torch.float16, dev)
        run = lambda: ops.shift_kv(k, beta=BETA, block_kv=page, policy=FP16)
        plain_of = lambda: smod.shift_kv_plain(m, k.half(), page,
                                               out_dtype=torch.float16)
        got, plain = run(), plain_of()
        torch.cuda.synchronize()
        err = _close(f"shift_kv/{tag}", got, plain, **SHIFT_TOL)
        kb = k.half().contiguous().reshape(b, kvh, s // page, page, d)
        rmse = _rel_rmse(got, torch.matmul(m.double(), kb.double())
                         .reshape(got.shape))
        if not rmse < SHIFT_RMSE_MAX:
            raise AssertionError(f"shift_kv/{tag} RMSE {rmse:.2e}")
        entries.append(_group_entry(
            "shift_kv", tag, arch, kvh, g, max_abs_err=err, rmse=rmse,
            ms=_cuda_time_ms(run, 50), plain_ms=_cuda_time_ms(plain_of, 20),
            library_ms=_cuda_time_ms(lambda: torch.matmul(m, kb), 50),
            **R.bound(*R.shift_kv_cost(k.numel(), k.element_size(), page))))
        # causal attention at the served config's dense prefill
        q = _randn(rng, (b, h, s, d), 0.0, dev, torch.float16)
        k = _randn(rng, (b, kvh, s, d), 2.0, dev, torch.float16)
        v = _randn(rng, (b, kvh, s, d), 0.0, dev, torch.float16)
        got = ops.pasa_attention(q, k, v, beta=BETA, policy=FP16, causal=True)
        plain = amod.attention_plain(q, k, v, beta=BETA, policy=FP16,
                                     block_kv=page, causal=True)
        torch.cuda.synchronize()
        err = _close(f"pasa_attention/{tag}", got, plain, **ATTN_CAUSAL_TOL)
        gold = _gold_attention(q, k, v, True)
        rmse, rmse_plain = _rel_rmse(got, gold), _rel_rmse(plain, gold)
        del gold, plain
        if not (rmse < ATTN_RMSE_MAX and rmse_plain < ATTN_RMSE_MAX):
            raise AssertionError(f"pasa_attention/{tag} RMSE {rmse:.4f} / "
                                 f"plain {rmse_plain:.4f}")
        k_sh = ops.shift_kv(k, beta=BETA, policy=FP16)
        inva = effective_invariance(page, d, BETA, torch.float16)
        ke, ve = (x.repeat_interleave(g, 1) for x in (k_sh, v))
        entries.append(_group_entry(
            "pasa_attention", tag, arch, kvh, g,
            max_abs_err=err, rmse=rmse, rmse_plain=rmse_plain,
            ms=_cuda_time_ms(lambda: amod.kernel_call(
                q, k_sh, v, beta=BETA, inva=inva, policy=FP16, causal=True,
                block_q=page, block_kv=page), 20),
            plain_ms=_cuda_time_ms(lambda: amod.attention_plain(
                q, k, v, beta=BETA, policy=FP16, block_kv=page, causal=True),
                3, warmup=1),
            library_ms=_cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, ke, ve, is_causal=True), 20),
            **R.bound(*R.attention_cost(b, h, s, kvh, s, d, causal=True))))
        del q, k, v, k_sh, ke, ve
    torch.cuda.empty_cache()
    return entries


def build_qwen3(dev):
    """qwen3-4b at full width (d 2560, 32 / 8 heads of 128, qk-norm,
    vocab 151,936) with its depth cut to QWEN3_LAYERS of 36, random
    weights from seed 0."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    bundle = build(dataclasses.replace(get_config("qwen3-4b"),
                                       n_layers=QWEN3_LAYERS))
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    return bundle, params, time.perf_counter() - t0


def _dense_prompts(cfg, dev):
    """serve_dense's prompts (seed 1) on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT), dtype=np.int32)).to(dev)


def _first_step_gaps(first, tag, atol, plain_ops=None):
    """``first()`` (a first step's logits from fresh state) through the
    kernels, through their plain versions at the serve's policy and
    through the plain versions at fp32 (``plain_ops``, the dense route's
    ``_plain_attention`` by default).  Held: the kernels within ``atol``
    of the plain versions, and no farther from the fp32 ones than
    DENSE_FP32_RATIO x the plain versions' own distance.  Returns the
    report and the kernels' logits."""
    import torch

    from repro_torch.core.precision import FP32

    plain_ops = plain_ops or _plain_attention
    kernel = first()
    with plain_ops():
        plain = first()
    with plain_ops(FP32):
        plain32 = first()
    gap = lambda a, b: float((a - b).abs().max())
    rep = dict(first_step_logit_err_vs_plain=gap(kernel, plain),
               first_step_logit_err_vs_fp32_plain=gap(kernel, plain32),
               plain_logit_err_vs_fp32_plain=gap(plain, plain32),
               first_step_logit_absmax=float(kernel.abs().max()))
    if not all(bool(torch.isfinite(x).all()) for x in (kernel, plain, plain32)):
        raise AssertionError(f"{tag}: non-finite first-step logits")
    if not (rep["first_step_logit_err_vs_plain"] <= atol
            and rep["first_step_logit_err_vs_fp32_plain"] <= DENSE_FP32_RATIO
            * rep["plain_logit_err_vs_fp32_plain"]):
        raise AssertionError(f"{tag}: first step {rep}")
    return rep, kernel


def dense_first_step(dev, bundle, params):
    """The dense route's first step (the fused prefill's logits on
    serve_dense's prompts, each time from a fresh cache) held by
    ``_first_step_gaps`` at DENSE_LOGIT_ATOL.  Returns the report and the
    kernels' logits."""
    toks = _dense_prompts(bundle.cfg, dev)
    max_len = DENSE_PROMPT + SERVE_GEN + 8
    first = lambda: bundle.prefill(
        params, toks, bundle.init_cache(DENSE_BATCH, max_len, device=dev))[0]
    return _first_step_gaps(first, bundle.cfg.arch_id, DENSE_LOGIT_ATOL)


def dense_vs_paged(dev, bundle, params, dense_streams, dense_first):
    """The dense route's prompts served by the paged engine (bf16 pool;
    its chunks shift with the algebraic chunk-exact shift, the dense
    route's fused prefill with the GEMM, so near-ties may flip).  Held:
    the two routes' first-step logits (``dense_first``, the paged
    engine's last prefill call) within DENSE_PAGED_LOGIT_ATOL; the dense
    route, re-run with the top-2 margin of each step's logits, gives
    ``dense_streams`` again; each row's greedy stream equals the paged
    engine's up to its first flip, and the dense margin there is under
    STREAM_GUARD (two routes within a logit gap g can only part where
    the margin is under 2 g).  Returns the report."""
    import dataclasses

    import torch

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.runtime import ServeEngine

    prefills = []

    def recorded(*a):
        logits, pool = bundle.paged_prefill_step(*a)
        prefills.append(logits)
        return logits, pool

    toks = _dense_prompts(bundle.cfg, dev)
    eng = ServeEngine(dataclasses.replace(bundle, paged_prefill_step=recorded),
                      params, max_batch=DENSE_BATCH, page_size=128,
                      prefill_chunk=512, prefill_batch=DENSE_BATCH,
                      num_pages=1 + DENSE_BATCH * math.ceil(
                          (DENSE_PROMPT + SERVE_GEN - 1) / 128),
                      max_seq_len=DENSE_PROMPT + SERVE_GEN)
    reqs = [eng.submit(p, SERVE_GEN) for p in toks.tolist()]
    eng.run_to_completion()
    paged = [r.generated for r in reqs]
    del eng
    # four prompts of one length: the last call's rows are their last
    # chunks, in submission order
    paged_first = prefills[-1][:DENSE_BATCH]
    if torch.argmax(paged_first, -1).tolist() != [s[0] for s in paged]:
        raise AssertionError("dense_vs_paged: the paged prefill's logit rows "
                             "are not the requests' first tokens")
    step = make_serve_step(bundle)
    cache = bundle.init_cache(DENSE_BATCH, DENSE_PROMPT + SERVE_GEN + 8,
                              device=dev)
    logits, cache = bundle.prefill(params, toks, cache)
    out, margins = [], []
    for i in range(DENSE_PROMPT, DENSE_PROMPT + SERVE_GEN):
        top2 = torch.topk(logits, 2, dim=-1).values
        margins.append(top2[:, 0] - top2[:, 1])
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        if i < DENSE_PROMPT + SERVE_GEN - 1:
            pos = torch.full((DENSE_BATCH,), i, dtype=torch.int32, device=dev)
            _, logits, cache = step(params, tok, pos, cache)
    streams = torch.stack(out, 1).tolist()
    margins = torch.stack(margins, 1).tolist()
    if streams != [list(s) for s in dense_streams]:
        raise AssertionError("dense_vs_paged: the dense route's re-run "
                             "differs from its serve")
    # each row is compared up to its first flip (past it the two routes
    # feed different tokens); tokens there whose margin clears the guard
    # are the ones held
    before, flips, held = [], [], 0
    for row, (a, b) in enumerate(zip(streams, paged)):
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 SERVE_GEN)
        before.append(t)
        held += sum(m >= STREAM_GUARD for m in margins[row][:t + 1])
        if t < SERVE_GEN:
            flips.append(dict(row=row, step=t, dense_margin=margins[row][t]))
    gap = float((dense_first - paged_first).abs().max())
    rep = dict(
        first_step_logit_err_vs_paged=gap, tokens_before_first_flip=before,
        flips=flips, tokens_above_guard=held,
        smallest_dense_margin=min(min(m) for m in margins),
        tokens_equal_to_paged_bf16=sum(
            x == y for a, b in zip(streams, paged) for x, y in zip(a, b)))
    if not (gap <= DENSE_PAGED_LOGIT_ATOL
            and all(f["dense_margin"] < STREAM_GUARD for f in flips)):
        raise AssertionError(f"dense_vs_paged: {rep}")
    return rep


def serve_tenant(dev, bundle, params, fcfs_streams):
    """The paged workload (qwen2-7b, bf16 pool) under TenantQuotaPolicy at
    its default aging patience, on TENANT_SLOTS decode slots: requests
    TENANT_LATENCY are tenant "interactive" at class "latency", the
    others tenant "bulk" at "throughput", submitted first, with
    TENANT_QUOTA ("bulk" may hold fewer pages than its two requests need
    together, and gets at most its ``max_step_tokens`` prefill tokens a
    step); preemption armed at patience 1 on a pool that fits everything.
    Held: streams equal the FCFS serve's; the latency requests take the
    slots first (admitted, and given their first token, before any bulk
    request; in FIFO order the bulk ones would go first); no step grants
    "bulk" more than its cap or leaves its running requests holding more
    than its page quota; a bulk request was withheld on the quota while a
    slot was free, yet 0 preemptions; the per-tenant
    ``serve.tenant.<t>.*`` counters sum to the ``serve.*`` aggregates; the
    same serve with speculation (K = SPEC_K, n-gram) and at
    ``pipeline_depth=1`` gives the same streams.  Every launch checked."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import (
        ServeEngine,
        Telemetry,
        TenantQuota,
        TenantQuotaPolicy,
    )

    tag = "serve_tenant_bf16"
    finite = []
    bundle = _finite_bundle(bundle, finite)
    prompts, kw = _paged_workload(bundle.cfg, "bf16")
    kw.update(max_batch=TENANT_SLOTS, prefill_batch=TENANT_SLOTS)
    tenant_of = lambda i: "interactive" if i in TENANT_LATENCY else "bulk"
    cap, quota = TENANT_QUOTA["max_step_tokens"], TENANT_QUOTA["max_pages"]
    order = sorted(range(len(prompts)), key=lambda i: i in TENANT_LATENCY)

    def run(**extra):
        policy = TenantQuotaPolicy({"bulk": TenantQuota(**TENANT_QUOTA)})
        grants, withheld = [], []
        plan_prefill, plan_admission = policy.plan_prefill, policy.plan_admission

        def recorded(prefilling, **args):
            plan = plan_prefill(prefilling, **args)
            tenants = {v.req_id: v.tenant for v in prefilling}
            step = {}
            for rid, n in plan:
                step[tenants[rid]] = step.get(tenants[rid], 0) + n
            grants.append(step)
            return plan

        def admission(waiting, running, **args):
            # a bulk candidate left out of the plan while a slot is free
            # waits on its quota alone (the pool fits everything)
            plan = plan_admission(waiting, running, **args)
            placed = {v.req_id for v in plan}
            withheld.append(len(running) < TENANT_SLOTS and any(
                v.tenant == "bulk" and v.req_id not in placed
                for v in waiting))
            return plan

        policy.plan_prefill, policy.plan_admission = recorded, admission
        telemetry = Telemetry(tracing=False, metrics=True)
        ops.reset_launches()
        eng = ServeEngine(bundle, params, scheduler=policy, preemption=True,
                          preempt_patience=1, telemetry=telemetry, **kw,
                          **extra)
        reqs = [None] * len(prompts)
        for i in order:
            reqs[i] = eng.submit(prompts[i], SERVE_GEN, tenant=tenant_of(i),
                                 priority="latency" if i in TENANT_LATENCY
                                 else "throughput")
        pages = []

        def check():
            running = [r for r in eng._slots if r is not None]
            pages.append(sum(r.pages_needed(eng.page_size) for r in running
                             if r.tenant == "bulk"))

        marks = _drive_calls(eng, check)
        launches = _check_engine_launches(tag, eng, "bf16")
        return eng, reqs, marks, launches, grants, pages, withheld, telemetry

    eng, reqs, marks, launches, grants, pages, withheld, telemetry = run()
    _all_finite(tag, finite)
    streams = [r.generated for r in reqs]
    if streams != fcfs_streams:
        raise AssertionError(f"{tag}: streams differ from the FCFS serve's")
    bulk_grant = max(step.get("bulk", 0) for step in grants)
    if bulk_grant > cap or max(pages) > quota:
        raise AssertionError(f"{tag}: bulk granted {bulk_grant} tokens in a "
                             f"step (cap {cap}), held {max(pages)} pages "
                             f"(quota {quota})")
    if not any(withheld) or eng.preemptions:
        raise AssertionError(f"{tag}: quota wait {any(withheld)}, "
                             f"{eng.preemptions} preemptions")
    steps_of = lambda field, latency: [
        getattr(r, field) for i, r in enumerate(reqs)
        if (i in TENANT_LATENCY) == latency]
    for field in ("admit_step", "first_token_step"):
        if not max(steps_of(field, True)) < min(steps_of(field, False)):
            raise AssertionError(f"{tag}: {field} of the latency requests "
                                 f"{steps_of(field, True)}, of the bulk ones "
                                 f"{steps_of(field, False)}")
    snap = telemetry.metrics_snapshot()["counters"]
    series = {}
    for leaf, total in (("submitted", "serve.requests_submitted"),
                        ("finished", "serve.requests_finished"),
                        ("tokens_emitted", "serve.tokens_emitted")):
        parts = {t: snap[f"serve.tenant.{t}.{leaf}"]["value"]
                 for t in ("interactive", "bulk")}
        if sum(parts.values()) != snap[total]["value"]:
            raise AssertionError(f"{tag}: {leaf} by tenant {parts} != "
                                 f"{total} {snap[total]['value']}")
        series[leaf] = parts
    wall = marks[-1][0]
    out = dict(
        tenants={tenant_of(i): "latency" if i in TENANT_LATENCY
                 else "throughput" for i in range(len(prompts))},
        quota=dict(bulk=TENANT_QUOTA),
        bulk_pages_needed=sum(r.pages_needed(eng.page_size) for r in reqs
                              if r.tenant == "bulk"),
        slots=TENANT_SLOTS, submitted=order,
        admit_step=[r.admit_step for r in reqs],
        first_token_step=[r.first_token_step for r in reqs],
        max_bulk_step_grant=bulk_grant, max_bulk_pages=max(pages),
        quota_waits=sum(withheld), preemptions=eng.preemptions,
        per_tenant=series, steps=eng.steps, prefill_calls=eng.prefill_calls,
        decode_calls=eng.decode_calls, launches=launches, wall_s=wall,
        tok_per_s=SERVE_GEN * len(prompts) / wall,
        ttft_ms=[1e3 * marks[r.first_token_step][0] for r in reqs],
        equal_to_fcfs_streams=True)
    del eng
    for name, extra in (("spec", dict(speculate=SPEC_K, draft="ngram")),
                        ("depth_1", dict(pipeline_depth=1))):
        eng, reqs, marks, launches = run(**extra)[:4]
        if [r.generated for r in reqs] != streams:
            raise AssertionError(f"{tag}/{name}: streams differ")
        out[name] = dict(steps=eng.steps, verify_calls=eng.verify_calls,
                         spec=eng.stats()["spec"], launches=launches,
                         wall_s=marks[-1][0], equal=True)
        del eng
    _all_finite(tag, finite)
    return out


# ---------------------------------------------------------------- phase 12 --


def check_vlm_cross(dev):
    """Shift-KV and the attention kernel at llama-3.2-vision-90b's image
    cross call (fp16 PASA at BETA, the path's mode): bf16 keys (VLM_BATCH,
    VLM_S2, 8, 128) read through strides, rows past VLM_IMAGE_TOKENS zero
    (the attention layer's padding); one query row (mean 0) padded to 64
    rows, 64 query heads over the 8 kv heads (G 8), not causal, kv_valid
    VLM_IMAGE_TOKENS.  Shift-KV against its plain version (SHIFT_TOL) and
    the float64 product with the same M (SHIFT_RMSE_MAX); the attention
    kernel at BETA and at beta 0 (FlashAttention-2) against its plain
    version (ATTN_TOL) on the real row and within ATTN_RMSE_MAX of float64
    attention on the unpadded keys, NaN values past kv_valid inert bit for
    bit.  Timed: shift-KV beside torch.matmul(M, K blocks); the attention
    kernel alone on the shifted keys, its plain version (with its shift)
    and SDPA on the 1,601 keys expanded to the query heads.  Then the
    self layers' call: contiguous decode at G 8, (VLM_BATCH, 8, 8, 128)
    queries over a bf16 (VLM_BATCH, VLM_MAX_LEN, 1024) cache read through
    strides at kv VLM_PROMPT + SERVE_GEN / 2 (mid-serve), against its
    plain version (DECODE_TOL) and float64 (RMSE_MAX), timed beside SDPA.
    Each entry names the launch counter key of its mode (``vlm_mode``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.core.shifting import effective_invariance
    from repro_torch.kernels import ops
    from repro_torch.kernels.pasa_paged_decode import mode_name
    smod = _kernel_module("shift_kv")
    amod = _kernel_module("pasa_attention")
    cmod = _kernel_module("pasa_decode")

    b, kvh, g, d = VLM_BATCH, 8, 8, 128
    n, s2, h = VLM_IMAGE_TOKENS, VLM_S2, 8 * 8
    rng = np.random.default_rng(12)
    pad = lambda x: F.pad(x, (0, 0, 0, s2 - n))
    # shift-KV on the layer's keys: (B, S2, KVH, D) bf16 seen as (B, KVH,
    # S2, D), zero rows past the image tokens
    keys = pad(_randn(rng, (b, kvh, n, d), 2.0, dev, torch.bfloat16)
               ).transpose(1, 2).contiguous().transpose(1, 2)
    m = smod.device_matrix(128, d, BETA, torch.float16, dev)
    run = lambda: ops.shift_kv(keys, beta=BETA, block_kv=128, policy=FP16)
    plain_of = lambda: smod.shift_kv_plain(m, keys.half(), 128,
                                           out_dtype=torch.float16)
    got, plain = run(), plain_of()
    torch.cuda.synchronize()
    err = _close("shift_kv/vlm_cross", got, plain, **SHIFT_TOL)
    kb = keys.half().contiguous().reshape(b, kvh, s2 // 128, 128, d)
    rmse = _rel_rmse(got, torch.matmul(m.double(), kb.double())
                     .reshape(got.shape))
    if not rmse < SHIFT_RMSE_MAX:
        raise AssertionError(f"shift_kv/vlm_cross RMSE {rmse:.2e}")
    source, replaces = KERNEL_FILES["pasa_attention"]
    entries = [dict(
        name="shift_kv/vlm_cross", vlm_mode=("shift_kv", smod.mode_name(
            torch.bfloat16, torch.float16, 128)),
        route="cuda", source="src/repro_torch/kernels/csrc/shift_kv.cu",
        replaces="src/repro/kernels/shift_kv.py:48", max_abs_err=err,
        rmse=rmse, ms=_cuda_time_ms(run, 50),
        plain_ms=_cuda_time_ms(plain_of, 20),
        library_ms=_cuda_time_ms(lambda: torch.matmul(m, kb), 50),
        **R.bound(*R.shift_kv_cost(keys.numel(), keys.element_size(), 128)))]
    del got, plain, kb
    # the attention kernel at the cross call
    q = F.pad(_randn(rng, (b, h, 1, d), 0.0, dev, torch.float16),
              (0, 0, 0, 63))
    k = pad(_randn(rng, (b, kvh, n, d), 2.0, dev, torch.float16))
    v = pad(_randn(rng, (b, kvh, n, d), 0.0, dev, torch.float16))
    gold = _gold_attention(q[:, :, :1], k[:, :, :n], v[:, :, :n], False)
    kw = dict(policy=FP16, block_q=64, kv_valid=n)
    detail = {}
    for case, beta in (("flash", 0.0), ("pasa", BETA)):
        attend = (lambda vv, beta=beta: ops.pasa_attention(
            q, k, vv, beta=beta, **kw)) if beta else (
            lambda vv: ops.flash_attention(q, k, vv, **kw))
        got = attend(v)
        plain = amod.attention_plain(q, k, v, beta=beta, policy=FP16,
                                     block_kv=128, kv_valid=n)
        v_nan = v.clone()
        v_nan[:, :, n:] = float("nan")
        torch.cuda.synchronize()
        label = f"pasa_attention/vlm_cross ({case})"
        detail[f"max_abs_err_{case}"] = _close(label, got[:, :, :1],
                                               plain[:, :, :1], **ATTN_TOL)
        r, rp = _rel_rmse(got[:, :, :1], gold), _rel_rmse(plain[:, :, :1], gold)
        if not (r < ATTN_RMSE_MAX and rp < ATTN_RMSE_MAX):
            raise AssertionError(f"{label} RMSE {r:.4f} / plain {rp:.4f}")
        if not torch.equal(attend(v_nan), got):
            raise AssertionError(f"{label}: NaN past kv_valid changed the "
                                 f"output")
        detail[f"rmse_{case}"], detail[f"rmse_plain_{case}"] = r, rp
        del v_nan
    k_sh = ops.shift_kv(k, beta=BETA, policy=FP16)
    inva = effective_invariance(128, d, BETA, torch.float16)
    q1, ke, ve = (q[:, :, :1].contiguous(),
                  *(x[:, :, :n].repeat_interleave(g, 1) for x in (k, v)))
    entries.append(dict(
        name="pasa_attention/vlm_cross",
        vlm_mode=("pasa_attention", mode_name(FP16, torch.bfloat16)),
        route="cuda", source=source, replaces=replaces,
        max_abs_err=detail["max_abs_err_pasa"], rmse=detail["rmse_pasa"],
        detail=detail,
        ms=_cuda_time_ms(lambda: amod.kernel_call(
            q, k_sh, v, beta=BETA, inva=inva, policy=FP16, causal=False,
            block_q=64, block_kv=128, kv_valid=n), 50),
        plain_ms=_cuda_time_ms(lambda: amod.attention_plain(
            q, k, v, beta=BETA, policy=FP16, block_kv=128, kv_valid=n),
            3, warmup=1),
        library_ms=_cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q1, ke, ve), 50),
        # the real query row and its output, K' and V over the image tokens
        **R.bound(*R.attention_cost(b, h, 1, kvh, s2, d, causal=False,
                                    kv_valid=n))))
    del q, k, v, k_sh, ke, ve, gold
    # contiguous decode at the self layers' call
    live = VLM_PROMPT + SERVE_GEN // 2
    ck, cv = (_randn(rng, (b, VLM_MAX_LEN, kvh * d), mean, dev,
                     torch.bfloat16) for mean in (30.0, 0.0))
    kview, vview = (c.view(b, VLM_MAX_LEN, kvh, d).transpose(1, 2)
                    for c in (ck, cv))
    q = _randn(rng, (b, kvh, g, d), 0.0, dev, torch.float16)
    kv_len = torch.full((b,), live, dtype=torch.int32, device=dev)
    run = lambda: ops.pasa_decode(q, kview, vview, kv_len, beta=BETA,
                                  policy=FP16, block_kv=128)
    plain_of = lambda: cmod.decode_plain(q, kview, vview, kv_len, beta=BETA,
                                         policy=FP16, block_kv=128)
    got, plain = run(), plain_of()
    torch.cuda.synchronize()
    err = _close("pasa_decode/vlm_self", got, plain, **DECODE_TOL)
    kk, vv = (x[:, :, :live].double().repeat_interleave(g, 1)
              for x in (kview, vview))
    gold = torch.softmax(q.double().reshape(b, h, 1, d) @ kk.transpose(-1, -2)
                         / math.sqrt(d), -1) @ vv
    rmse = _rel_rmse(got.reshape(gold.shape), gold)
    rmse_plain = _rel_rmse(plain.reshape(gold.shape), gold)
    if not (rmse < RMSE_MAX and rmse_plain < RMSE_MAX):
        raise AssertionError(f"pasa_decode/vlm_self RMSE {rmse:.4f} / plain "
                             f"{rmse_plain:.4f}")
    source, replaces = KERNEL_FILES["pasa_decode"]
    entries.append(dict(
        name="pasa_decode/vlm_self",
        vlm_mode=("pasa_decode", mode_name(FP16, torch.bfloat16)),
        route="cuda", source=source, replaces=replaces, max_abs_err=err,
        rmse=rmse, detail=dict(rmse_plain=rmse_plain, kv_len=live),
        ms=_cuda_time_ms(run, 50), plain_ms=_cuda_time_ms(plain_of, 3,
                                                          warmup=1),
        library_ms=_decode_library_ms(q, kview, vview, kv_len),
        **R.bound(*R.decode_cost(b, kvh, g, d, (live,) * b))))
    del ck, cv, kview, vview, kk, vv, gold
    torch.cuda.empty_cache()
    return entries


def serve_vlm(dev):
    """llama-3.2-vision-90b at full width (d 8192, 64 / 8 heads of 128, G
    8, d_ff 28672, vocab 128,256) with its depth cut to VLM_LAYERS (a
    group of one image cross-attention layer and 4 self layers), random
    weights from seed 0 (bf16, an fp32 head and fp32 gates), the gates set
    to VLM_GATE.  VLM_BATCH prompts of VLM_PROMPT tokens and images
    (vision_embeds (B, 1601, 1280) in bf16, N(0, 1) from seed 0),
    SERVE_GEN greedy tokens each, token by token through launch/serve.py's
    route on a VLM_MAX_LEN-row cache: per step 4 contiguous decodes (the
    self layers, G 8), 1 shift-KV and 1 attention launch (the cross
    layers: one query row padded to 64, 1,601 keys in 1,664 rows), all
    fp16 PASA over bf16 at head_dim 128, and no other kernel.  Every logit
    finite; the prompts VLM_ALONE served alone from their images give
    their batched streams; the first generated step against the plain
    versions (``_first_step_gaps`` at HYBRID_LOGIT_ATOL, each from a copy
    of one cache); another image moves those logits by
    more than HYBRID_LOGIT_ATOL (the cross path is live).  Returns the
    report."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.pasa_paged_decode import mode_name
    from repro_torch.kernels.shift_kv import mode_name as shift_mode
    from repro_torch.launch.serve import cache_bytes, token_by_token
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.model_zoo import build

    full = get_config("llama-3.2-vision-90b")
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    bundle = build(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    for name in ("gate_attn", "gate_mlp"):
        params["cross"][name].fill_(VLM_GATE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = _leaves(params)
    n_params = sum(x.numel() for x in weights)
    param_gb = sum(x.numel() * x.element_size() for x in weights) / 1e9
    del weights
    finite = []
    checked = _finite_bundle(bundle, finite)
    rng = np.random.default_rng(0)
    image = lambda: torch.from_numpy(rng.standard_normal(
        (VLM_BATCH, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)
    ).to(dev, torch.bfloat16)
    vis = image()
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (VLM_BATCH, VLM_PROMPT), dtype=np.int32)).to(dev)
    names = [w.__name__ for w in ops.WRAPPERS]
    fp16 = get_policy(cfg.attention.pasa_policy)
    modes = {"pasa_decode": mode_name(fp16, torch.bfloat16),
             "pasa_attention": mode_name(fp16, torch.bfloat16),
             "shift_kv": shift_mode(torch.bfloat16, torch.float16,
                                    cfg.attention.block_kv)}
    groups = cfg.n_layers // cfg.cross_attn_every
    per_step = {"pasa_decode": groups * (cfg.cross_attn_every - 1),
                "shift_kv": groups, "pasa_attention": groups}

    def run(rows, images):
        cache = bundle.init_cache(rows.shape[0], VLM_MAX_LEN, device=dev)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out, cache, times = token_by_token(checked, params, rows, SERVE_GEN,
                                           cache, vision_embeds=images)
        return out, cache, [t - t_start for t in times]

    run(prompts[:1, :4], vis[:1])          # warm-up (cuBLAS first calls)
    finite.clear()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    streams, cache, times = run(prompts, vis)
    n_steps = VLM_PROMPT + SERVE_GEN - 1
    launches = {name: getattr(ops, name).launches for name in names}
    want = {name: per_step.get(name, 0) * n_steps for name in names}
    if launches != want:
        raise AssertionError(f"serve_vlm: launch counts {launches} != {want}")
    by_mode = _by_mode(names)
    for name, mode in modes.items():
        if by_mode[name] != {mode: want[name]}:
            raise AssertionError(f"serve_vlm: {name} launches by mode "
                                 f"{by_mode[name]}")
    _all_finite("serve_vlm", finite)
    if streams.shape != (VLM_BATCH, SERVE_GEN) or not (
            (streams >= 0) & (streams < cfg.vocab_size)).all():
        raise AssertionError(f"serve_vlm: bad streams {streams}")
    peak = torch.cuda.max_memory_allocated()
    cache_mb = cache_bytes(cache) / 1e6
    del cache
    for i in VLM_ALONE:
        alone, _, _ = run(prompts[i:i + 1], vis[i:i + 1])
        if not np.array_equal(alone[0], streams[i]):
            raise AssertionError(
                f"serve_vlm: batched vs one-at-a-time streams differ: "
                f"{streams[i].tolist()} vs {alone[0].tolist()}")
    # the first generated step from one cache: kernels, plain versions,
    # plain versions at fp32; then the kernels with another image
    cache = bundle.init_cache(VLM_BATCH, VLM_MAX_LEN, device=dev)
    step = make_serve_step(bundle)
    for i in range(VLM_PROMPT - 1):
        pos = torch.full((VLM_BATCH,), i, dtype=torch.int32, device=dev)
        _, _, cache = step(params, prompts[:, i], pos, cache,
                           vision_embeds=vis)
    pos = torch.full((VLM_BATCH,), VLM_PROMPT - 1, dtype=torch.int32,
                     device=dev)
    first = lambda images=vis: bundle.serve_step(
        params, prompts[:, -1], pos, {k: v.clone() for k, v in cache.items()},
        vision_embeds=images)[0]
    gaps, kernel_logits = _first_step_gaps(first, "serve_vlm",
                                           HYBRID_LOGIT_ATOL)
    other = first(image())
    moved = float((other - kernel_logits).abs().max())
    if not moved > HYBRID_LOGIT_ATOL:
        raise AssertionError(f"serve_vlm: another image moved the first-step "
                             f"logits by {moved:.3e} only")
    wall = times[-1]
    del params, cache, other, kernel_logits
    torch.cuda.empty_cache()
    return dict(
        arch=cfg.arch_id, layers=f"{cfg.n_layers} of {full.n_layers}",
        groups=groups, d_model=cfg.d_model, heads=cfg.n_heads,
        kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        image_tokens=cfg.n_image_tokens, gate=VLM_GATE,
        params=n_params, param_gb=param_gb, weights_s=init_s, batch=VLM_BATCH,
        prompt_len=VLM_PROMPT, gen=SERVE_GEN, max_len=VLM_MAX_LEN,
        steps=n_steps, launches=launches, launches_by_mode=by_mode,
        wall_s=wall, tok_per_s=streams.size / wall,
        ms_per_step=1e3 * wall / n_steps, ttft_ms=1e3 * times[0],
        decode_ms_per_step=1e3 * (times[-1] - times[0]) / (SERVE_GEN - 1),
        peak_gb=peak / 1e9, cache_mb=cache_mb,
        image_moves_first_step_logits_by=moved, **gaps,
        streams=streams.tolist(),
    )


def serve_falcon_mamba(dev):
    """falcon-mamba-7b at full width (MAMBA_LAYERS of its 64 Mamba-1
    layers, d 4096, d_inner 8192, state 16, vocab 65,024; no attention)
    with random
    weights from seed 0 (bf16, fp32 head, fp32 conv / dt / SSM
    parameters).  MAMBA_BATCH prompts of MAMBA_PROMPT tokens, SERVE_GEN
    greedy tokens each, token by token through launch/serve.py's route
    (the state is O(1) per sequence).  No kernel launched; every logit
    finite; the prompts MAMBA_ALONE served alone give their batched
    streams; the last prompt step's logits through the decode within
    MAMBA_FWD_TOL of ``_ssm_forward`` on the whole prompt.  Returns the
    report."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import cache_bytes, token_by_token
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import _ssm_forward, build

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              n_layers=MAMBA_LAYERS)
    bundle = build(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights = _leaves(params)
    n_params = sum(x.numel() for x in weights)
    param_gb = sum(x.numel() * x.element_size() for x in weights) / 1e9
    del weights
    finite = []
    checked = _finite_bundle(bundle, finite)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (MAMBA_BATCH, MAMBA_PROMPT), dtype=np.int32)).to(dev)
    names = [w.__name__ for w in ops.WRAPPERS]

    def run(rows):
        cache = bundle.init_cache(rows.shape[0], 0, device=dev)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out, cache, times = token_by_token(checked, params, rows, SERVE_GEN,
                                           cache)
        return out, cache, [t - t_start for t in times]

    run(prompts[:1, :4])                   # warm-up (cuBLAS first calls)
    finite.clear()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    streams, cache, times = run(prompts)
    n_steps = MAMBA_PROMPT + SERVE_GEN - 1
    launches = {name: getattr(ops, name).launches for name in names}
    if any(launches.values()):
        raise AssertionError(f"serve_falcon_mamba: kernels launched "
                             f"{launches}")
    _all_finite("serve_falcon_mamba", finite)
    if streams.shape != (MAMBA_BATCH, SERVE_GEN) or not (
            (streams >= 0) & (streams < cfg.vocab_size)).all():
        raise AssertionError(f"serve_falcon_mamba: bad streams {streams}")
    peak = torch.cuda.max_memory_allocated()
    cache_mb = {part: cache_bytes(cache[part]) / 1e6 for part in cache}
    del cache
    for i in MAMBA_ALONE:
        alone, _, _ = run(prompts[i:i + 1])
        if not np.array_equal(alone[0], streams[i]):
            raise AssertionError(
                f"serve_falcon_mamba: batched vs one-at-a-time streams "
                f"differ: {streams[i].tolist()} vs {alone[0].tolist()}")
    # the decode's logits at the last prompt token vs the whole-prompt
    # forward
    cache = bundle.init_cache(MAMBA_BATCH, 0, device=dev)
    for t in range(MAMBA_PROMPT):
        pos = torch.full((MAMBA_BATCH,), t, dtype=torch.int32, device=dev)
        decoded, cache = bundle.serve_step(params, prompts[:, t], pos, cache)
    h, _ = _ssm_forward(params, cfg, prompts)
    forward = L.matmuls(h[:, -1].float(), params["lm_head"].float())[0]
    err = (decoded - forward).abs()
    bad = err > MAMBA_FWD_TOL["atol"] + MAMBA_FWD_TOL["rtol"] * forward.abs()
    if bad.any() or not bool(torch.isfinite(forward).all()):
        raise AssertionError(f"serve_falcon_mamba: decode vs forward: "
                             f"{int(bad.sum())} logits outside "
                             f"{MAMBA_FWD_TOL}, max {float(err.max()):.3e}")
    wall = times[-1]
    del params, cache, h
    torch.cuda.empty_cache()
    return dict(
        arch=cfg.arch_id, layers=cfg.n_layers, d_model=cfg.d_model,
        d_inner=cfg.ssm.expand * cfg.d_model, state=cfg.ssm.state,
        params=n_params, param_gb=param_gb, weights_s=init_s,
        batch=MAMBA_BATCH, prompt_len=MAMBA_PROMPT, gen=SERVE_GEN,
        steps=n_steps, launches=launches, wall_s=wall,
        tok_per_s=streams.size / wall, ms_per_step=1e3 * wall / n_steps,
        ttft_ms=1e3 * times[0],
        decode_ms_per_step=1e3 * (times[-1] - times[0]) / (SERVE_GEN - 1),
        peak_gb=peak / 1e9, cache_mb=cache_mb,
        decode_vs_forward_logit_err=float(err.max()),
        forward_logit_absmax=float(forward.abs().max()),
        streams=streams.tolist(),
    )


# ---------------------------------------------------------------- phase 13 --


def build_olmoe(dev):
    """olmoe-1b-7b at full width (d 2048, 16 / 16 heads of 128, qk-norm,
    64 experts of width 1024, top-8, vocab 50,304) with its depth cut to
    OLMOE_LAYERS, random weights from seed 0, at its capacity factor 1.25,
    and the
    same model (the same weights) at capacity factor E / k, where every
    expert can take every token of a call."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    bundle = build(dataclasses.replace(get_config("olmoe-1b-7b"),
                                       n_layers=OLMOE_LAYERS))
    moe = bundle.cfg.moe
    nodrop = build(dataclasses.replace(bundle.cfg, moe=dataclasses.replace(
        moe, capacity_factor=moe.n_experts / moe.top_k)))
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    return bundle, nodrop, params, time.perf_counter() - t0


@contextlib.contextmanager
def _tap_routes():
    """Inside the block every moe layer call's experts, (T, k) on the
    device, in call order."""
    from repro_torch.models import moe

    route, seen = moe.route, []

    def tapped(xf, router, k):
        gate, top_e = route(xf, router, k)
        seen.append(top_e)
        return gate, top_e

    moe.route = tapped
    try:
        yield seen
    finally:
        moe.route = route


@contextlib.contextmanager
def _pinned_routes(experts):
    """Inside the block the i-th moe layer call routes its tokens to
    ``experts[i]`` (a run's ``_tap_routes``), each gate from the call's
    own router probabilities: a run's expert choices replayed, so that
    two runs differ only in their arithmetic."""
    import torch

    from repro_torch.models import moe

    route, pinned = moe.route, iter(experts)

    def replay(xf, router, k):
        top_e = next(pinned)
        probs = torch.softmax(xf.float() @ router.float(), dim=-1)
        gate = probs.gather(-1, top_e)
        return gate / gate.sum(dim=-1, keepdim=True), top_e

    moe.route = replay
    try:
        yield
    finally:
        moe.route = route


def _dropped(top_e, cfg) -> int:
    """The slots of one moe call past their expert's capacity."""
    import torch

    t, k = top_e.shape
    e = cfg.moe.n_experts
    cap = max(math.ceil(t * k / e * cfg.moe.capacity_factor), 1)
    counts = torch.bincount(top_e.reshape(-1), minlength=e)
    return int((counts - cap).clamp(min=0).sum())


def olmoe_first_step_drops(dev, bundle, params, cache_dtype="bf16"):
    """The paged engine's first step on the paged workload (one prefill
    call of four 512-token chunks, then the decode call of the two rows
    whose prompt ended, beside two rows still prefilling): each call's
    rows and dropped slots per layer."""
    from repro_torch.runtime import ServeEngine

    prompts, kw = _paged_workload(bundle.cfg, cache_dtype)
    eng = ServeEngine(bundle, params, **kw)
    for p in prompts:
        eng.submit(p, SERVE_GEN)
    with _tap_routes() as seen:
        eng.step()
    n = bundle.cfg.n_layers
    if eng.prefill_calls != 1 or eng.decode_calls != 1 or len(seen) != 2 * n:
        raise AssertionError(f"olmoe first step: {eng.prefill_calls} prefill "
                             f"and {eng.decode_calls} decode calls, "
                             f"{len(seen)} moe calls")
    del eng
    return {f"{call}_rows": seen[i * n].shape[0] for i, call in
            enumerate(("prefill", "decode"))} | {
        f"{call}_dropped_per_layer": [_dropped(x, bundle.cfg)
                                      for x in seen[i * n:(i + 1) * n]]
        for i, call in enumerate(("prefill", "decode"))}


def olmoe_dense_first_calls(dev, bundle, params):
    """The dense route's first prefill (the fused 4 x DENSE_PROMPT call)
    and first decode call (fed the kernels' first tokens), through the
    kernels and through their plain versions at the serve's policy.
    Held: ``_first_step_gaps`` at DENSE_LOGIT_ATOL and DENSE_FP32_RATIO
    with the kernels' routing pinned in the plain runs
    (``_pinned_routes``).  Reported: the gaps without the pin (a top-k
    set that flips on an attention rounding difference moves its token's
    FFN output by a whole expert's share), each call's dropped slots per
    layer and how many (layer, token) top-k sets differ between the two
    unpinned runs."""
    import torch

    from repro_torch.core.precision import FP32
    from repro_torch.launch.steps import make_serve_step

    cfg, n = bundle.cfg, bundle.cfg.n_layers
    toks = _dense_prompts(cfg, dev)
    step = make_serve_step(bundle)
    pos = torch.full((DENSE_BATCH,), DENSE_PROMPT, dtype=torch.int32,
                     device=dev)
    cache = lambda: bundle.init_cache(DENSE_BATCH, DENSE_PROMPT + 8,
                                      device=dev)
    first = lambda: bundle.prefill(params, toks, cache())[0]

    def calls(tok=None):
        """Both first calls: their experts and the prefill's logits."""
        with _tap_routes() as seen:
            logits, c = bundle.prefill(params, toks, cache())
            tok = torch.argmax(logits, -1).to(torch.int32) if tok is None \
                else tok
            step(params, tok, pos, c)
        return seen, logits, tok

    kernel, kernel_logits, tok = calls()

    def first_pinned():
        with _pinned_routes(kernel[:n]):
            return first()

    rep, _ = _first_step_gaps(first_pinned, f"{cfg.arch_id} (routing "
                              f"pinned)", DENSE_LOGIT_ATOL)
    with _plain_attention():
        plain, plain_logits, _ = calls(tok)
    with _plain_attention(FP32):
        plain32 = first()
    gap = lambda a, b: float((a - b).abs().max())
    sets = lambda x: x.sort(-1).values
    rep.update(routing_pinned=True,
               unpinned_logit_err_vs_plain=gap(kernel_logits, plain_logits),
               unpinned_logit_err_vs_fp32_plain=gap(kernel_logits, plain32),
               unpinned_plain_logit_err_vs_fp32_plain=gap(plain_logits,
                                                          plain32))
    routing = {}
    for i, call in enumerate(("prefill", "decode")):
        ks, ps = kernel[i * n:(i + 1) * n], plain[i * n:(i + 1) * n]
        routing[f"{call}_rows"] = ks[0].shape[0]
        routing[f"{call}_dropped_per_layer"] = [_dropped(x, cfg) for x in ks]
        routing[f"{call}_topk_sets_differing_vs_plain"] = sum(
            int((sets(a) != sets(b)).any(-1).sum()) for a, b in zip(ks, ps))
    rep["routing"] = routing
    return rep


def serve_olmoe(dev, bundle, nodrop, params):
    """olmoe-1b-7b at full width, OLMOE_LAYERS deep.  At its capacity
    factor 1.25:
    the paged workload from a bf16 and an int8 pool and the dense
    workload, every launch counted, every logit finite, the dense first
    step held as qwen2-7b's (DENSE_LOGIT_ATOL, DENSE_FP32_RATIO) with the
    routing pinned (``olmoe_dense_first_calls``); the drops of the first
    calls, the routing flips against the plain versions and the unpinned
    first-step gaps reported.  Batched == one at a time is not a contract
    there: a row's output depends on the rows sharing its call (ROADMAP
    C).
    At capacity factor E / k (``nodrop``: nothing dropped, held) on the
    bf16 pool: batched == the requests OLMOE_ALONE one at a time, async
    == sync (``serve_async``: streams, pool pages, launches, 0 syncs a
    step outside the drain points) and token by token ==
    ``dense_greedy_reference`` on OLMOE_TBT_PROMPTS.  Prints each report
    as it is made; returns them by name."""
    reps = {}
    for dtype in ("bf16", "int8"):
        rep = serve(dev, bundle, params, cache_dtype=dtype, alone=())
        rep["capacity_factor"] = bundle.cfg.moe.capacity_factor
        rep["first_step"] = olmoe_first_step_drops(dev, bundle, params,
                                                   dtype)
        reps[f"serve_olmoe_{dtype}"] = rep
        print(f"serve_olmoe_{dtype}: " + json.dumps(rep), flush=True)
    rep = serve_dense(dev, bundle, params, alone=())
    rep.update(olmoe_dense_first_calls(dev, bundle, params))
    reps["serve_olmoe_dense"] = rep
    print("serve_olmoe_dense: " + json.dumps(rep), flush=True)
    rep = serve(dev, nodrop, params, cache_dtype="bf16", alone=OLMOE_ALONE)
    rep["capacity_factor"] = nodrop.cfg.moe.capacity_factor
    rep["first_step"] = olmoe_first_step_drops(dev, nodrop, params)
    if any(sum(rep["first_step"][f"{c}_dropped_per_layer"])
           for c in ("prefill", "decode")):
        raise AssertionError(f"serve_olmoe_nodrop: slots dropped at "
                             f"capacity factor E / k: {rep['first_step']}")
    rep_async, _ = serve_async(dev, nodrop, params, "bf16", rep["streams"])
    rep["async"] = {key: rep_async[key] for key in (
        "order", "tok_per_s", "decode_ms_per_step",
        "syncs_per_step_outside_drain_points", "streams_equal_to_sync",
        "pools_equal_to_sync")}
    rep["tbt"] = serve_tbt(dev, nodrop, params, lens=OLMOE_TBT_PROMPTS)
    reps["serve_olmoe_nodrop"] = rep
    print("serve_olmoe_nodrop: " + json.dumps(rep), flush=True)
    return reps

# ------------------------------------------------------------ phase 14 --
# Serving across devices.  The data axis: EngineReplicaGroup, two
# replicas of qwen2-7b on cuda:0 sharing one copy of the weights (the
# replicas' own pools).  The model axis: a gloo group of two processes on
# cuda:0, each serving qwen2-7b at full width with its depth cut to
# MESH_LAYERS from a pool kv-head-sharded in halves.  The affinity burst:
# AFFINITY_BURST requests sharing an AFFINITY_SYSTEM-token system prompt
# (4 pages of 128) plus a drawn tail of AFFINITY_TAIL tokens, AFFINITY_GEN
# tokens each, the prefix cache on.
AFFINITY_SYSTEM, AFFINITY_BURST, AFFINITY_GEN = 512, 8, 16
AFFINITY_TAIL = (64, 300)
MESH_LAYERS = 2   # 4 until phase 16 gained 16e and 16f
MESH_TIMEOUT_S = 600
# ring PASA at fp16 against float64: at most this many times the RMSE of
# the one-device GEMM-form PASA on the same K/V (each rank folds the
# shards in its own order; tests/test_torch_ring.py's class)
RING_RMSE_RATIO = 2.0


def _replica_mesh():
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((2, 1), ("data", "model"))     # both cells on cuda:0


def _group_drive(grp):
    """Step every replica of ``grp`` (what ``grp.step()`` does), counting
    each replica's paged-kernel launches apart; returns the wall time (s)
    at each step's end and the per-replica counts."""
    import torch

    per = [{"pasa_paged_prefill": 0, "pasa_paged_decode": 0}
           for _ in grp.engines]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks = []
    while not grp.idle:
        for i, eng in enumerate(grp.engines):
            before = _launch_counts()
            eng.step()
            after = _launch_counts()
            for name in per[i]:
                per[i][name] += after[name] - before[name]
        marks.append(time.perf_counter() - t0)
    grp.drain()
    return marks, per


def serve_replicas(dev, bundle, params, streams):
    """``serve_replicas_bf16``: phase 3's workload through a group of two
    replicas on cuda:0 under "least" routing (the burst deals i::2).  Held:
    the streams equal phase 3's (``streams``); each replica launches each
    paged kernel 28 times per call of its own, counted apart; each
    replica's non-null pages equal a one-engine serve of its subset; the
    replicas share the one copy of the weights.  Returns the report and
    the group's streams, pools and launches."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime import EngineReplicaGroup, ServeEngine

    tag = "serve_replicas_bf16"
    prompts, kw = _paged_workload(bundle.cfg, "bf16")
    ops.reset_launches()
    grp = EngineReplicaGroup(bundle, params, _replica_mesh(), routing="least",
                             **kw)
    reqs = [grp.submit(p, SERVE_GEN) for p in prompts]
    marks, per = _group_drive(grp)
    n = bundle.cfg.n_layers
    for i, eng in enumerate(grp.engines):
        want = {"pasa_paged_prefill": n * eng.prefill_calls,
                "pasa_paged_decode": n * eng.decode_calls}
        if per[i] != want or not (eng.prefill_calls and eng.decode_calls):
            raise AssertionError(f"{tag}: replica {i} launches {per[i]} != "
                                 f"{want}")
        if eng.params is not params:
            raise AssertionError(f"{tag}: replica {i} copied the weights")
    total = _launch_counts()
    if total["pasa_decode"] or any(
            total[k] != sum(p[k] for p in per) for k in per[0]):
        raise AssertionError(f"{tag}: launches {total} != the replicas' {per}")
    got = [r.generated for r in reqs]
    if got != streams:
        raise AssertionError(f"{tag}: streams differ from phase 3's")
    owners = [grp.engines.index(grp._owner[r.req_id]) for r in reqs]
    for i, eng in enumerate(grp.engines):
        subset = [p for p, o in zip(prompts, owners) if o == i]
        alone = ServeEngine(bundle, params, **kw)
        for p in subset:
            alone.submit(p, SERVE_GEN)
        alone.run_to_completion()
        if not _pools_equal(eng.pool, alone.pool):
            raise AssertionError(f"{tag}: replica {i}'s pages differ from a "
                                 f"one-engine serve of its subset")
    st = grp.stats()
    pools = [{k: x.clone() for k, x in e.pool.items()} for e in grp.engines]
    wall = marks[-1]
    rep = dict(
        replicas=2, routing="least", owners=owners,
        launches_per_replica=per, prefill_calls=st["prefill_calls"],
        decode_calls=st["decode_calls"], steps=len(marks), wall_s=wall,
        tok_per_s=sum(len(s) for s in got) / wall,
        ttft_ms=[1e3 * marks[r.first_token_step] for r in reqs],
        cache_bytes=st["cache_bytes"], weights_shared=True,
        streams_equal_to_phase3=True, pages_equal_to_subset_serves=True)
    return rep, dict(streams=got, pools=pools, launches=total)


def _affinity_prompts(cfg):
    import numpy as np

    rng = np.random.default_rng(14)
    system = rng.integers(0, cfg.vocab_size, AFFINITY_SYSTEM).tolist()
    return [system + rng.integers(0, cfg.vocab_size, int(rng.integers(
        AFFINITY_TAIL[0], AFFINITY_TAIL[1] + 1))).tolist()
        for _ in range(AFFINITY_BURST)]


def serve_affinity(dev, bundle, params):
    """``serve_affinity_bf16``: the first request served to its end on a
    group of two replicas (its prompt pages donated to its replica's
    prefix cache), then the other AFFINITY_BURST - 1 as one burst, under
    "affinity" and again under "rr".  Held: under affinity every burst
    request lands on the warm replica and hits the 4 system pages; both
    routings give the same streams.  Reported: routing counts, prefix
    hits, TTFT (ms from the burst's submission) under each."""
    import numpy as np
    import torch

    from repro_torch.runtime import EngineReplicaGroup

    tag = "serve_affinity_bf16"
    prompts = _affinity_prompts(bundle.cfg)
    longest = AFFINITY_SYSTEM + AFFINITY_TAIL[1] + AFFINITY_GEN
    pages = math.ceil(longest / 128)
    kw = dict(max_batch=AFFINITY_BURST, page_size=128, prefill_chunk=512,
              num_pages=1 + AFFINITY_BURST * pages, max_seq_len=longest,
              prefix_cache=True)
    out, streams = {}, {}
    for routing in ("affinity", "rr"):
        grp = EngineReplicaGroup(bundle, params, _replica_mesh(),
                                 routing=routing, **kw)
        r0 = grp.submit(prompts[0], AFFINITY_GEN)
        warm = grp.engines.index(grp._owner[r0.req_id])
        grp.run_to_completion()
        step0 = grp.engines[0].steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        burst = [grp.submit(p, AFFINITY_GEN) for p in prompts[1:]]
        marks = []
        while not grp.idle:
            grp.step()
            marks.append(time.perf_counter() - t0)
        grp.drain()
        owners = [grp.engines.index(grp._owner[r.req_id]) for r in burst]
        hits = [e.stats()["prefix_cache"]["hits"] for e in grp.engines]
        ttft = [1e3 * marks[r.first_token_step - step0] for r in burst]
        streams[routing] = [r.generated for r in [r0] + burst]
        out[routing] = dict(
            warm_replica=warm,
            burst_per_replica=[owners.count(i) for i in range(2)],
            prefix_hits_per_replica=hits,
            prefill_calls=grp.stats()["prefill_calls"],
            ttft_ms=ttft, ttft_ms_mean=float(np.mean(ttft)),
            burst_wall_s=marks[-1])
        if routing == "affinity":
            if owners != [warm] * len(burst):
                raise AssertionError(f"{tag}: the burst went to {owners}, "
                                     f"not all to the warm replica {warm}")
            if hits[warm] < 4 * len(burst) or hits[1 - warm]:
                raise AssertionError(f"{tag}: prefix hits {hits}")
        del grp
    if streams["affinity"] != streams["rr"]:
        raise AssertionError(f"{tag}: routing changed a stream")
    return dict(burst=AFFINITY_BURST, system_tokens=AFFINITY_SYSTEM,
                tail=list(AFFINITY_TAIL), gen=AFFINITY_GEN,
                streams_equal_across_routings=True, **out)


def serve_replicas_async(dev, bundle, params, sync):
    """``serve_replicas_async_bf16``: the replica group of
    :func:`serve_replicas` at ``pipeline_depth=1``.  Held: streams, pools
    and launches equal the sync group's (``sync``), and no synchronizing
    call a step outside the replicas' drain points (``count_syncs``)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.profile_steps import count_syncs
    from repro_torch.runtime import EngineReplicaGroup

    tag = "serve_replicas_async_bf16"
    prompts, kw = _paged_workload(bundle.cfg, "bf16")
    ops.reset_launches()
    grp = EngineReplicaGroup(bundle, params, _replica_mesh(), routing="least",
                             pipeline_depth=1, **kw)
    reqs = [grp.submit(p, SERVE_GEN) for p in prompts]
    steps = 0
    with count_syncs(*grp.engines) as syncs:
        t0 = time.perf_counter()
        while not grp.idle:
            grp.step()
            steps += 1
        grp.drain()
        wall = time.perf_counter() - t0
    if [r.generated for r in reqs] != sync["streams"]:
        raise AssertionError(f"{tag}: streams differ from the sync group's")
    if not all(_pools_equal(e.pool, p)
               for e, p in zip(grp.engines, sync["pools"])):
        raise AssertionError(f"{tag}: pool bytes differ from the sync group's")
    if _launch_counts() != sync["launches"]:
        raise AssertionError(f"{tag}: launches {_launch_counts()} != "
                             f"{sync['launches']}")
    if syncs["outside"]:
        raise AssertionError(f"{tag}: {syncs['outside']} synchronizing calls "
                             f"outside the drain points: {syncs['where']}")
    return dict(pipeline_depth=1, steps=steps, wall_s=wall,
                tok_per_s=SERVE_GEN * len(prompts) / wall,
                syncs_per_step_outside_drain_points=syncs["outside"] / steps,
                syncs_per_step_all=syncs["all"] / steps,
                streams_equal_to_sync=True, pools_equal_to_sync=True)


def _mesh_model(dev):
    """qwen2-7b at full width, depth cut to MESH_LAYERS, weights from seed
    0 (the same draw in every process)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    bundle = build(dataclasses.replace(get_config("qwen2-7b"),
                                       n_layers=MESH_LAYERS))
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    return bundle, params


def _mesh_serve(bundle, params, cache_dtype, mesh=None):
    """Phase 3's workload at depth MESH_LAYERS (after a one-request warm-up
    serve), the launches checked per call; returns the report, with the
    device memory the serve took at its peak beyond what was resident
    before it (per process, so per rank on the model axis)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeEngine

    prompts, kw = _paged_workload(bundle.cfg, cache_dtype)
    warm = ServeEngine(bundle, params, mesh=mesh, **kw)
    warm.submit(prompts[-1][:64], 2)
    warm.run_to_completion()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ops.reset_launches()
    eng = ServeEngine(bundle, params, mesh=mesh, **kw)
    reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
    marks = _drive(eng)
    launches = _check_engine_launches(f"mesh {cache_dtype}", eng, cache_dtype)
    st = eng.stats()
    io = eng.pool_io
    return eng, dict(
        cache_dtype=cache_dtype, streams=[r.generated for r in reqs],
        launches=launches, prefill_calls=eng.prefill_calls,
        decode_calls=eng.decode_calls, wall_s=marks[-1],
        pool_bytes=st["cache_bytes"],
        pool_bytes_per_rank=st["cache_bytes_per_device"],
        peak_bytes_over_resident=torch.cuda.max_memory_allocated() - resident,
        staging_calls=io.calls if io else 0,
        staging_ms_per_call=1e3 * io.stage_s / io.calls if io else 0.0)


def _mesh_ops(dev, mesh):
    """The sharded ops on phase 2's decode and prefill fixtures (KVH 4,
    G 7: each rank runs the paged kernels on its KVH 2 slice) against the
    unsharded kernels, bit for bit, the launch counts set to 0 just before
    the sharded calls and read just after (``kvh2_launches``: the KVH 2
    rows of the kernels line); and ``core.ring_pasa_attention`` over the
    group on the prefill fixture's first 3 kv heads (live rows): at fp16
    within RMSE_MAX of float64 attention and within RING_RMSE_RATIO x the
    one-device GEMM-form PASA's RMSE (``core.blocked_attention``), at the
    float64 policy within the reference's 1e-10 of the one-device
    GEMM-form PASA at float64."""
    import numpy as np
    import torch

    from repro_torch.core import blocked_attention, ring_pasa_attention
    from repro_torch.core.collectives import all_gather, shard
    from repro_torch.core.precision import F64, FP16
    from repro_torch.kernels import ops
    from repro_torch.runtime.paged_cache import gather_pages

    rng, kp, vp, table, kv_len, _ = _decode_fixture(dev)
    q = torch.from_numpy(rng.standard_normal(
        (len(DECODE_KV_LENS), 4, 7, 128)).astype(np.float32)).to(
        device=dev, dtype=torch.float16)
    qp, kp2, vp2, table2, start, kv_len2 = _prefill_fixture(dev)
    whole = ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                  policy=FP16)
    whole_p = ops.pasa_paged_prefill(qp, kp2, vp2, table2, start, kv_len2,
                                     beta=BETA, policy=FP16)
    ops.reset_launches()
    split = ops.pasa_paged_decode_sharded(q, kp, vp, table, kv_len,
                                          mesh=mesh, beta=BETA, policy=FP16)
    split_p = ops.pasa_paged_prefill_sharded(
        qp, kp2, vp2, table2, start, kv_len2, mesh=mesh, beta=BETA,
        policy=FP16)
    kvh2 = {name: getattr(ops, name).launches
            for name in ("pasa_paged_decode", "pasa_paged_prefill")}
    torch.cuda.synchronize()
    if not (torch.equal(whole, split) and torch.equal(whole_p, split_p)):
        raise AssertionError("the sharded paged ops differ from the "
                             "unsharded kernels")
    # the ring: 3 kv heads (21 query heads), the table padded to an even
    # page count with the null page so each rank's KV shard is whole
    # pages, the columns past kv_len zeroed.  The ring is the paper's
    # GEMM-form PASA (K shifted by the rounded M over whole blocks), as
    # the reference's is, so it is held to the one-device GEMM-form PASA
    # on the same K/V and to float64 attention
    q3, k3, v3 = (qp[:, :21].contiguous(), kp2[:, :, :3].contiguous(),
                  vp2[:, :, :3].contiguous())
    t3 = torch.cat([table2, torch.zeros_like(table2[:, :1])], 1)
    t3 = t3[:, :t3.shape[1] - t3.shape[1] % 2]
    b, h, cs, d = q3.shape
    s2 = t3.shape[1] * 128
    live = (torch.arange(s2, device=dev)[None, :]
            < kv_len2[:, None])[:, None, None, :, None]
    q5 = q3.reshape(b, 3, 7, cs, d)
    kv5 = [torch.where(live, gather_pages(
        x.reshape(x.shape[0], 128, 3 * d).half(), t3).reshape(
        b, s2, 3, d).movedim(1, 2)[:, :, None], 0.0).half() for x in (k3, v3)]
    r, n = mesh.axis_rank("model"), mesh.shape["model"]
    group = mesh.axis_group("model")
    ring, one = {}, {}
    for policy in (FP16, F64):
        part = ring_pasa_attention(
            *(shard(x, 3, n, r) for x in (q5, *kv5)), group=group,
            beta=BETA, policy=policy, block_kv=128, causal=True,
            kv_len=kv_len2.to(torch.int32).reshape(b, 1, 1, 1, 1),
            q_offset=start.to(torch.int32).reshape(b, 1, 1, 1, 1))
        ring[policy.name] = all_gather(part, 3, group).reshape(
            b, h, cs, d)[:3]
        one[policy.name] = blocked_attention(
            q5, *kv5, beta=BETA, policy=policy, block_kv=128, causal=True,
            kv_len=kv_len2.reshape(b, 1, 1),
            q_offset=start.reshape(b, 1, 1, 1)).reshape(b, h, cs, d)[:3]
    gold = _prefill_gold(q3, k3, v3, t3)
    rmse = _rel_rmse(ring[FP16.name], gold)
    rmse_one = _rel_rmse(one[FP16.name], gold)
    if not (torch.isfinite(ring[FP16.name]).all() and rmse < RMSE_MAX
            and rmse <= RING_RMSE_RATIO * rmse_one):
        raise AssertionError(f"ring PASA: RMSE {rmse:.4f}, one-device "
                             f"GEMM-form PASA {rmse_one:.4f}")
    exact = _rel_rmse(ring[F64.name], one[F64.name].double())
    if not exact < 1e-10:
        raise AssertionError(f"ring PASA at f64: {exact:.2e} from the "
                             f"one-device GEMM-form PASA")
    return dict(decode_bit_equal=True, prefill_bit_equal=True,
                kvh2_launches=kvh2, ring_kvh=3, ring_rmse=rmse,
                ring_rmse_one_device_gemm_form=rmse_one,
                ring_f64_rmse_to_one_device=exact)


def _mesh_rank(rank, store, out_dir, device):
    """One rank of the world-2 model-axis group, both on ``device``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.collectives import all_gather
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    try:
        mesh = make_mesh((1, 2), ("data", "model"), devices=dev)
        bundle, params = _mesh_model(dev)
        res = {}
        for dtype in ("bf16", "int8"):
            eng, rep = _mesh_serve(bundle, params, dtype, mesh)
            sh = eng.pool.shardings
            group = mesh.axis_group("model")
            rep["pool"] = {n: all_gather(x, sh[n].dim, group).cpu()
                           for n, x in eng.pool.items()}
            res[dtype] = rep
            del eng
        ops_rep = _mesh_ops(dev, mesh)
        res["ops"] = ops_rep
        if rank:
            for dtype in ("bf16", "int8"):
                del res[dtype]["pool"]
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def serve_mesh(dev):
    """``serve_mesh_1x2_<pool>``: this process serves the
    depth-MESH_LAYERS model alone, then the world-2 group of two
    processes on ``dev`` (:func:`_mesh_rank`) serves it.  Held: each
    rank's tokens, and the whole pool's non-null pages, equal the
    one-process serve's; each rank's pool bytes are half of the whole;
    the sharded ops (in the group) as :func:`_mesh_ops` holds them; every
    child's failure fails the phase.  Reported: the boundary's
    host-staging ms per call."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    # the one-process serves first, so that the group's staging times
    # are taken on an otherwise idle card
    bundle, params = _mesh_model(dev)
    alone = {}
    for dtype in ("bf16", "int8"):
        eng, rep = _mesh_serve(bundle, params, dtype)
        rep["pool"] = {n: x.cpu() for n, x in eng.pool.items()}
        alone[dtype] = rep
        del eng
    del bundle, params
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="mesh", dir=ROOT / "build"))
    ctx = mp.spawn(_mesh_rank, nprocs=2, join=False, args=(
        str(out_dir / "store"), str(out_dir), str(dev)))
    deadline = time.monotonic() + MESH_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the mesh group ran past {MESH_TIMEOUT_S} s")
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    reps = {}
    for dtype in ("bf16", "int8"):
        tag = f"serve_mesh_1x2_{dtype}"
        want = alone[dtype]
        for r, res in enumerate(ranks):
            got = res[dtype]
            if got["streams"] != want["streams"]:
                raise AssertionError(f"{tag}: rank {r}'s streams differ from "
                                     f"the one-process serve's")
            if got["pool_bytes_per_rank"] * 2 != got["pool_bytes"] \
                    or got["pool_bytes"] != want["pool_bytes"]:
                raise AssertionError(f"{tag}: pool bytes {got['pool_bytes']} "
                                     f"/ {got['pool_bytes_per_rank']} a rank")
        if not _pools_equal(ranks[0][dtype]["pool"], want["pool"]):
            raise AssertionError(f"{tag}: page bytes differ from the "
                                 f"one-process serve's")
        reps[tag] = dict(
            layers=MESH_LAYERS, ranks=2,
            launches_all_ranks={name: sum(res[dtype]["launches"][name]
                                          for res in ranks)
                                for name in ranks[0][dtype]["launches"]},
            **{k: v for k, v in ranks[0][dtype].items()
               if k not in ("pool", "streams")},
            staging_ms_per_call_rank1=ranks[1][dtype]["staging_ms_per_call"],
            peak_bytes_over_resident_rank1=ranks[1][dtype][
                "peak_bytes_over_resident"],
            peak_bytes_over_resident_alone=want["peak_bytes_over_resident"],
            wall_s_alone=want["wall_s"], streams_equal_to_one_process=True,
            pages_equal_to_one_process=True)
    reps["serve_mesh_1x2_ops"] = [res["ops"] for res in ranks]
    return reps


def check_kvh2_slices(dev):
    """Each paged kernel on the per-rank slice of a 1x2 model axis: the
    first 2 kv heads (G 7) of phase 2's decode and prefill fixtures, each
    against its plain version, timed beside it and SDPA."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops

    kvh, g, d, page = 2, 7, 128, 128
    rng, kp, vp, table, kv_len, _ = _decode_fixture(dev)
    b = len(DECODE_KV_LENS)
    kp, vp = kp[:, :, :kvh].contiguous(), vp[:, :, :kvh].contiguous()
    q = torch.from_numpy(rng.standard_normal((b, kvh, g, d)).astype(
        np.float32)).to(device=dev, dtype=torch.float16)
    mod = _kernel_module("pasa_paged_decode")
    call = lambda: ops.pasa_paged_decode(q, kp, vp, table, kv_len, beta=BETA,
                                         policy=FP16)
    plain = lambda: mod.paged_decode_plain(q, kp, vp, table, kv_len,
                                           beta=BETA, policy=FP16,
                                           block_kv=page)
    err = _close("pasa_paged_decode/kvh2", call(), plain(), **DECODE_TOL)
    mp = table.shape[1]
    kg, vg = (torch.nan_to_num(x[table.long()].reshape(b, mp * page, kvh, d)
                               .movedim(1, 2).half()).repeat_interleave(g, 1)
              for x in (kp, vp))
    mask = (torch.arange(mp * page, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]
    qh = q.reshape(b, kvh * g, 1, d)
    dec = dict(
        name="pasa_paged_decode/kvh2", route="cuda",
        source="src/repro_torch/kernels/csrc/pasa_paged_decode.cu",
        replaces="src/repro/kernels/pasa_paged_decode.py:196",
        max_abs_err=err, ms=_cuda_time_ms(call, 50),
        plain_ms=_cuda_time_ms(plain, 3, warmup=1),
        library_ms=_cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask), 20),
        **R.bound(*R.paged_decode_cost(b, kvh, g, d, DECODE_KV_LENS,
                                       table.numel())))
    qp, kp2, vp2, table2, start, kv_len2 = _prefill_fixture(dev)
    h = kvh * g
    qp = qp[:, :h].contiguous()
    kp2, vp2 = kp2[:, :, :kvh].contiguous(), vp2[:, :, :kvh].contiguous()
    pmod = _kernel_module("pasa_paged_prefill")
    call = lambda: ops.pasa_paged_prefill(qp, kp2, vp2, table2, start,
                                          kv_len2, beta=BETA, policy=FP16)
    plain = lambda: pmod.paged_prefill_plain(qp, kp2, vp2, table2, start,
                                             kv_len2, beta=BETA, policy=FP16)
    err = _close("pasa_paged_prefill/kvh2", call(), plain(), **PREFILL_TOL)
    mp = table2.shape[1]
    kg, vg = (torch.nan_to_num(x[table2.long()].reshape(4, mp * page, kvh, d)
                               .movedim(1, 2).half()).repeat_interleave(g, 1)
              for x in (kp2, vp2))
    col = torch.arange(mp * page, device=dev)
    qpos = start[:, None] + torch.arange(PREFILL_CHUNK, device=dev)[None, :]
    pmask = (col[None, None, :] <= qpos[:, :, None]) & (
        col[None, None, :] < kv_len2[:, None, None])
    nbytes, flops = R.paged_prefill_cost(len(PREFILL_ROWS[0]), h,
                                         PREFILL_CHUNK, d, kvh, *PREFILL_ROWS,
                                         table2.numel())
    pre = dict(
        name="pasa_paged_prefill/kvh2", route="cuda",
        source="src/repro_torch/kernels/csrc/pasa_paged_prefill.cu",
        replaces="src/repro/kernels/pasa_paged_prefill.py:368",
        max_abs_err=err, ms=_cuda_time_ms(call, 20),
        plain_ms=_cuda_time_ms(plain, 3, warmup=1),
        library_ms=_cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qp, kg, vg, attn_mask=pmask[:, None]), 10),
        **R.bound(nbytes, flops))
    return [dec, pre]


# ------------------------------------------------------------ phase 15 --
# the training path: qwen2-7b at full width, its depth cut so that fp32
# parameters, gradients and AdamW moments fit the card, and the whole
# smoke, phase 16 included, its time
TRAIN_ARCH = "qwen2-7b"
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 8
TRAIN_HYPER = dict(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
# the attention's training call (B, H, KVH, S, D): causal over 1,024 rows
TRAIN_ATTN_SHAPE = (TRAIN_BATCH, 28, 4, TRAIN_SEQ, 128)
# the first step's loss and gradients through the kernels against the
# whole-plain path (the plain attention forward, autograd) from the same
# state: the two forwards differ by the fp16 attention's rounding only.
# At this random init the gradients of wq / wk (and the q / k biases)
# are small residuals of the softmax Jacobian's cancellation, which a
# rounding-sized change of the forward moves by tens of percent (first
# runs: cosine 0.92 between the two paths on wq / wk, 0.90 on bk, at a
# loss gap of 2.8e-4).  So the gradients are held to a yardstick, the
# same plain path with its attention at the fp32 policy, forward and
# backward (a bundle at pasa_policy "fp32"; the rest of the model at its
# bf16 compute dtype as in the other two): the kernels' distance from it,
# over all leaves and on each leaf holding TRAIN_LEAF_SHARE of its norm,
# no larger than TRAIN_FP32_RATIO (TRAIN_LEAF_RATIO) x the fp16 plain
# path's distance from it
TRAIN_LOSS_ATOL = 0.05
TRAIN_GNORM_RTOL = 0.02
TRAIN_FP32_RATIO = 1.25
TRAIN_LEAF_RATIO = 1.5
TRAIN_LEAF_SHARE = 0.01
# restart == straight through the CLI, on the reduced config
RESTART_ARGS = ("--arch", "qwen3-4b", "--reduced", "--attention-impl",
                "naive", "--batch", "4", "--seq", "32", "--warmup", "2",
                "--ckpt-every", "5", "--log-every", "1", "--seed", "0")
RESTART_STEPS, RESTART_AT = 10, 5
RESTART_TIMEOUT_S = 300


def check_train_attention(dev):
    """``kernels.train_attention.KernelAttention`` at the training call
    (TRAIN_ATTN_SHAPE, causal, bf16 q/k/v as the model hands them): fp16
    PASA at BETA and FlashAttention-2 at bf16_fp32.  Its output equals the
    op's (``ops.pasa_attention`` / ``ops.flash_attention``) bit for bit,
    and its input gradients equal ``torch.autograd.grad`` of
    ``attention_plain`` at the same inputs bit for bit; each forward
    launches the attention kernel once (and PASA's the shift kernel).
    Times of the forward (the op, the plain version, SDPA) and of forward
    plus backward (the Function, the plain version's autograd, SDPA's).
    Returns the report and the kernels-line entries of shift-KV and the
    attention kernel at the training call (launches filled in by the
    trainer's run)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import BF16_FP32, FP16
    from repro_torch.kernels import ops
    from repro_torch.kernels.train_attention import kernel_attention
    amod = _kernel_module("pasa_attention")
    smod = _kernel_module("shift_kv")

    b, h, kvh, s, d = TRAIN_ATTN_SHAPE
    rng = np.random.default_rng(15)
    bf = torch.bfloat16
    q = _randn(rng, (b, h, s, d), 0.0, dev, bf)
    k = _randn(rng, (b, kvh, s, d), 2.0, dev, bf)
    v = _randn(rng, (b, kvh, s, d), 0.0, dev, bf)
    report = {}
    for tag, flash, beta, policy in (("pasa_fp16", False, BETA, FP16),
                                     ("flash_bf16_fp32", True, 0.0,
                                      BF16_FP32)):
        op = ops.flash_attention if flash else ops.pasa_attention
        kw = dict(policy=policy, causal=True)
        if not flash:
            kw["beta"] = beta
        ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
        ops.reset_launches()
        out = kernel_attention(*ins, flash=flash, beta=beta, policy=policy,
                               causal=True)
        launches = {w.__name__: w.launches for w in ops.WRAPPERS}
        want = {w.__name__: 0 for w in ops.WRAPPERS}
        want[op.__name__] = 1
        if not flash:
            want["shift_kv"] = 1
        if launches != want:
            raise AssertionError(f"train attention ({tag}): launches "
                                 f"{launches} != {want}")
        with torch.no_grad():
            direct = op(q, k, v, **kw)
        if not torch.equal(out, direct):
            raise AssertionError(f"train attention ({tag}): forward differs "
                                 f"from the op")
        g = _randn(rng, tuple(out.shape), 0.0, dev, out.dtype)
        grads = torch.autograd.grad(out, ins, g)
        pins = [x.detach().requires_grad_(True) for x in (q, k, v)]
        plain = amod.attention_plain(*pins, beta=beta, policy=policy,
                                     block_kv=128, causal=True)
        want_g = torch.autograd.grad(plain, pins, g)
        for name, a, w in zip("qkv", grads, want_g):
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f"train attention ({tag}): d{name} "
                                     f"not finite")
            if not torch.equal(a, w):
                raise AssertionError(f"train attention ({tag}): d{name} "
                                     f"differs from the plain autograd")
        report[f"{tag}_max_abs_err_vs_plain_forward"] = float(
            (out.detach().float() - plain.detach().float()).abs().max())

        def fwd_bwd(fn, ins=ins):
            o = fn(*ins)
            torch.autograd.grad(o, ins, g)

        report[f"{tag}_fwd_bwd_ms"] = _cuda_time_ms(lambda: fwd_bwd(
            lambda *x: kernel_attention(*x, flash=flash, beta=beta,
                                        policy=policy, causal=True)), 3,
            warmup=1)
        report[f"{tag}_plain_fwd_bwd_ms"] = _cuda_time_ms(lambda: fwd_bwd(
            lambda *x: amod.attention_plain(*x, beta=beta, policy=policy,
                                            block_kv=128, causal=True)), 3,
            warmup=1)
        del ins, pins, out, plain, grads, want_g
    # SDPA forward and backward at bf16 on K/V expanded to the heads: the
    # library's fused backward, which the port does not have
    ke, ve = (x.repeat_interleave(h // kvh, 1) for x in (k, v))
    lins = [x.detach().requires_grad_(True) for x in (q, ke, ve)]
    g = torch.randn((b, h, s, d), dtype=bf, device=dev)
    report["sdpa_fwd_bwd_ms"] = _cuda_time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*lins, is_causal=True), lins, g), 5)
    del lins

    entries = _train_call_entries(dev, TRAIN_ATTN_SHAPE, "train", q, k, v)
    entries[1]["detail"] = report
    return report, entries


def _train_call_entries(dev, shape, tag, q=None, k=None, v=None):
    """The kernels-line entries of shift-KV and the PASA attention kernel
    at a training call ``shape`` (B, H, KVH, S, D), causal, fp16 at BETA:
    each held against its plain version (bf16 q / k / v drawn with keys of
    mean 2 unless given), timed beside it and beside the library call
    (SDPA on the shifted keys expanded to the heads; ``torch.matmul`` for
    the shift), with its bound.  Names ``<kernel>/<tag>``; launches are
    filled in by the caller."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.core.shifting import effective_invariance
    from repro_torch.kernels import ops
    amod = _kernel_module("pasa_attention")
    smod = _kernel_module("shift_kv")

    b, h, kvh, s, d = shape
    if q is None:
        rng = np.random.default_rng(16)
        bf = torch.bfloat16
        q = _randn(rng, (b, h, s, d), 0.0, dev, bf)
        k = _randn(rng, (b, kvh, s, d), 2.0, dev, bf)
        v = _randn(rng, (b, kvh, s, d), 0.0, dev, bf)
    qh, kh, vh = (x.to(torch.float16) for x in (q, k, v))
    k_sh = ops.shift_kv(k, beta=BETA, policy=FP16)
    inva = effective_invariance(128, d, BETA, torch.float16)
    run = lambda: amod.kernel_call(qh, k_sh, vh, beta=BETA, inva=inva,
                                   policy=FP16, causal=True, block_q=128,
                                   block_kv=128)
    got = run()
    plain = amod.attention_plain(q, k, v, beta=BETA, policy=FP16,
                                 block_kv=128, causal=True)
    torch.cuda.synchronize()
    err = _close(f"pasa_attention/{tag}", got, plain, **ATTN_CAUSAL_TOL)
    kx, vx = (x.repeat_interleave(h // kvh, 1) for x in (k_sh, vh))
    attn = dict(
        name=f"pasa_attention/{tag}", route="cuda",
        source=KERNEL_FILES["pasa_attention"][0],
        replaces=KERNEL_FILES["pasa_attention"][1], max_abs_err=err,
        ms=_cuda_time_ms(run, 20),
        plain_ms=_cuda_time_ms(lambda: amod.attention_plain(
            q, k, v, beta=BETA, policy=FP16, block_kv=128, causal=True), 3,
            warmup=1),
        library_ms=_cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qh, kx, vx, is_causal=True), 20),
        **R.bound(*R.attention_cost(b, h, s, kvh, s, d, causal=True)),
    )
    m = smod.device_matrix(128, d, BETA, torch.float16, dev)
    run_s = lambda: ops.shift_kv(k, beta=BETA, policy=FP16)
    plain_s = lambda: smod.shift_kv_plain(m, kh, 128, out_dtype=torch.float16)
    err_s = _close(f"shift_kv/{tag}", run_s(), plain_s(), **SHIFT_TOL)
    kb = kh.contiguous().reshape(b, kvh, s // 128, 128, d)
    shift = dict(
        name=f"shift_kv/{tag}", route="cuda",
        source="src/repro_torch/kernels/csrc/shift_kv.cu",
        replaces="src/repro/kernels/shift_kv.py:48", max_abs_err=err_s,
        ms=_cuda_time_ms(run_s, 50), plain_ms=_cuda_time_ms(plain_s, 20),
        library_ms=_cuda_time_ms(lambda: torch.matmul(m, kb), 50),
        **R.bound(*R.shift_kv_cost(k.numel(), k.element_size(), 128)),
    )
    ops.reset_launches()
    return [shift, attn]


def _grads_at(bundle, params, batch):
    """(loss, the gradient of every leaf of ``params``) of one batch."""
    import torch

    from repro_torch.optim.adamw import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = bundle.loss_fn(params, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _grads_vs_plain(bundle, params, batch, tag):
    """One batch's loss and gradients through the kernels (the launch
    counts set to 0 just before that pass, read just after) against the
    whole-plain path (the plain attention forward under autograd), both
    against the whole-plain path at the fp32 policy (its attention
    forward and backward at fp32), with no optimizer state beside the
    parameters (three gradient sets).  Held: the losses within
    TRAIN_LOSS_ATOL, the gradient norms within TRAIN_GNORM_RTOL, and the
    kernels' gradients no farther from the fp32 path's than
    TRAIN_FP32_RATIO x the fp16 plain path's (TRAIN_LEAF_RATIO on each
    leaf holding TRAIN_LEAF_SHARE of the norm).  Returns the report, the
    leaves' names and the kernels' pass launches by op and mode."""
    import dataclasses

    import torch

    from repro_torch.checkpoint.manager import _flatten_with_paths
    from repro_torch.kernels import ops
    from repro_torch.models.model_zoo import build

    cfg = bundle.cfg
    at_fp32 = build(dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, pasa_policy="fp32")))
    ops.reset_launches()
    loss_k, grads_k = _grads_at(bundle, params, batch)
    torch.cuda.synchronize()
    launches = {w.__name__: dict(w.launches_by_mode) for w in ops.WRAPPERS
                if w.launches}
    with _plain_attention():
        loss_p, grads_p = _grads_at(bundle, params, batch)
        loss_f, grads_f = _grads_at(at_fp32, params, batch)
    names = [k for k, _ in _flatten_with_paths(params)]
    leaf = {}
    for name, gk, gp, gf in zip(names, grads_k, grads_p, grads_f):
        kk, pp, ff = _dot(gk, gk), _dot(gp, gp), _dot(gf, gf)
        kp, kf, pf = _dot(gk, gp), _dot(gk, gf), _dot(gp, gf)
        dist = lambda aa, bb, ab: max(aa + bb - 2 * ab, 0.0) ** 0.5
        leaf[name] = dict(sq_k=kk, sq_p=pp, sq_f=ff,
                          cos_kp=kp / max((kk * pp) ** 0.5, 1e-300),
                          to_f32_k=dist(kk, ff, kf), to_f32_p=dist(pp, ff, pf),
                          k_to_p=dist(kk, pp, kp))
    del grads_f, grads_k, grads_p
    torch.cuda.empty_cache()
    total = lambda key: sum(v[key] for v in leaf.values()) ** 0.5
    gn_k, gn_p, gn_f = total("sq_k"), total("sq_p"), total("sq_f")
    d_k = sum(v["to_f32_k"] ** 2 for v in leaf.values()) ** 0.5
    d_p = sum(v["to_f32_p"] ** 2 for v in leaf.values()) ** 0.5
    d_kp = sum(v["k_to_p"] ** 2 for v in leaf.values()) ** 0.5
    for v in leaf.values():
        v["share"] = v["sq_f"] ** 0.5 / gn_f
        v["ratio"] = v["to_f32_k"] / max(v["to_f32_p"], 1e-300)
    held = {k: v for k, v in leaf.items() if v["share"] >= TRAIN_LEAF_SHARE}
    worst = max(held, key=lambda k: held[k]["ratio"])
    rep = dict(
        loss_kernels=float(loss_k), loss_plain=float(loss_p),
        loss_plain_fp32=float(loss_f), grad_norm_kernels=gn_k,
        grad_norm_plain=gn_p, grad_norm_plain_fp32=gn_f,
        dist_to_fp32_kernels=d_k / gn_f, dist_to_fp32_plain=d_p / gn_f,
        dist_kernels_to_plain=d_kp / gn_f,
        worst_leaf=worst, worst_leaf_ratio=held[worst]["ratio"],
        lowest_cos_leaves={k: {x: leaf[k][x] for x in (
            "cos_kp", "share", "ratio")} for k in sorted(
                leaf, key=lambda k: leaf[k]["cos_kp"])[:4]})
    if not (abs(rep["loss_kernels"] - rep["loss_plain"]) <= TRAIN_LOSS_ATOL
            and abs(gn_k - gn_p) <= TRAIN_GNORM_RTOL * gn_p
            and d_k <= TRAIN_FP32_RATIO * d_p
            and held[worst]["ratio"] <= TRAIN_LEAF_RATIO):
        raise AssertionError(f"{tag}: kernels vs plain {rep}")
    return rep, names, launches


def train_full_width(dev):
    """TRAIN_ARCH at full width with its depth cut to TRAIN_LAYERS, remat
    on: random fp32 parameters from seed 0 on the card, AdamW moments in
    fp32, ``DataPipeline(batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0)``.
    First the step-0 batch's loss and gradients through the kernels
    against the whole-plain path from the same parameters
    (``_grads_vs_plain``).  Then TRAIN_STEPS
    steps of ``make_train_step`` through ``FaultTolerantLoop`` (no
    checkpoint written), with the launch counts set to 0 just before:
    every loss and gradient norm finite, every parameter leaf moved, and
    shift-KV and the attention kernel launched 2 x TRAIN_LAYERS times a
    step (each layer's forward and its remat recompute), no other kernel.
    Returns the report."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (TrainHyper, batch_to_device,
                                          make_train_step)
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.runtime import FaultTolerantLoop

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    if not cfg.remat:
        raise AssertionError("the training config has remat off")
    bundle = build(cfg)
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev,
                         dtype=cfg.torch_param_dtype())
    torch.cuda.synchronize()
    rep = {"init_s": time.perf_counter() - t0, "layers": cfg.n_layers,
           "params": sum(p.numel() for p in tree_leaves(params))}
    pipe = DataPipeline(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        vocab=cfg.vocab_size, seed=0)
    first = batch_to_device(next(pipe), dev)
    pipe.restore({"step": 0, "seed": 0})

    # the kernels against the whole-plain path at the first batch
    grads_rep, names, _ = _grads_vs_plain(bundle, params, first,
                                          "train_full_width")
    rep.update(grads_rep)
    torch.cuda.empty_cache()
    state = {"params": params,
             "opt": adamw_init(params, cfg.torch_optimizer_dtype())}
    del params

    # the training run
    before = [p.detach().flatten()[:: max(p.numel() // 4096, 1)].clone()
              for p in tree_leaves(state["params"])]
    step_fn = make_train_step(bundle, TrainHyper(**TRAIN_HYPER))
    metrics = []
    times = []

    def on_step(step, m, dt):
        metrics.append({k: float(v) for k, v in m.items()})
        times.append(dt)

    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d)
        loop = FaultTolerantLoop(step_fn=step_fn, state=state, pipeline=pipe,
                                 ckpt=ckpt, ckpt_every=TRAIN_STEPS + 1,
                                 log=lambda s: print(f"  {s}"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        state = loop.run(TRAIN_STEPS, metrics_cb=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in ops.WRAPPERS}
        by_mode = _by_mode(list(launches))
        written = ckpt.available_steps()
    pipe.close()
    if written:
        raise AssertionError(f"train_full_width wrote checkpoints {written}")
    per_step = 2 * cfg.n_layers
    want = {name: per_step * TRAIN_STEPS
            if name in ("shift_kv", "pasa_attention") else 0
            for name in launches}
    if launches != want:
        raise AssertionError(f"train_full_width: launches {launches} != "
                             f"{want}")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"train_full_width: non-finite {m}")
    after = [p.detach().flatten()[:: max(p.numel() // 4096, 1)]
             for p in tree_leaves(state["params"])]
    still = [n for n, a, b in zip(names, before, after) if torch.equal(a, b)]
    if still:
        raise AssertionError(f"train_full_width: leaves did not move {still}")
    rep.update(
        launches=launches, launches_by_mode=by_mode,
        launches_per_step=per_step, steps=TRAIN_STEPS,
        batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        loss=[m["loss"] for m in metrics],
        grad_norm=[m["grad_norm"] for m in metrics],
        lr=[m["lr"] for m in metrics],
        step_ms=[t * 1e3 for t in times],
        step_ms_after_first=sum(times[1:]) / max(len(times) - 1, 1) * 1e3,
        wall_s=wall,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        tokens_per_s=TRAIN_BATCH * TRAIN_SEQ * (len(times) - 1)
        / max(sum(times[1:]), 1e-9),
    )
    del state, loop, step_fn
    torch.cuda.empty_cache()
    return rep


def _dot(a, b) -> float:
    """sum(a * b) in float64, 2**24 elements at a time (bounded memory)."""
    a, b = a.reshape(-1), b.reshape(-1)
    n = 1 << 24
    return float(sum((a[i:i + n].double() * b[i:i + n].double()).sum()
                     for i in range(0, a.numel(), n)))


def _train_cli(ckpt_dir, runs) -> str:
    """One ``python -m repro_torch.launch.train`` process on the card
    (RESTART_ARGS, RESTART_STEPS steps, ``--ckpt-dir ckpt_dir``): its
    determinism settings precede its first cuBLAS call.  Appends its
    record to ``runs``; returns its standard output."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *RESTART_ARGS,
           "--steps", str(RESTART_STEPS), "--ckpt-dir", str(ckpt_dir)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=RESTART_TIMEOUT_S)
    runs.append({"cmd": " ".join(cmd[2:]), "rc": proc.returncode,
                 "s": time.perf_counter() - t0,
                 "tail": proc.stdout.strip().splitlines()[-3:]})
    if proc.returncode != 0:
        raise AssertionError(f"train CLI failed ({proc.returncode}): "
                             f"{proc.stderr[-3000:]}")
    return proc.stdout


def train_restart():
    """Restart == straight through the CLI (RESTART_ARGS: the reduced
    qwen3-4b at the naive attention, which the card runs at head_dim 16),
    in fresh processes on the card, one after the other: RESTART_STEPS
    steps straight, writing checkpoints every RESTART_AT steps; then a
    process on a directory holding only the straight run's checkpoint at
    RESTART_AT.  Holds the resumed run to have restored at RESTART_AT
    (``restore_latest``, the pipeline rewound) and logged only the steps
    past it, and the two final checkpoints equal leaf for leaf, bit for
    bit.  Returns the report."""
    import shutil
    import tempfile

    import numpy as np

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        straight, resumed = Path(tmp) / "straight", Path(tmp) / "resumed"
        _train_cli(straight, runs)
        at = f"step_{RESTART_AT:010d}"
        resumed.mkdir()
        shutil.copytree(straight / at, resumed / at)
        log = _train_cli(resumed, runs)
        if f"restored step {RESTART_AT}" not in log or \
                f"step {RESTART_AT:5d} " in log or \
                f"step {RESTART_STEPS:5d} " not in log:
            raise AssertionError(f"train_restart: the resumed run did not "
                                 f"resume at {RESTART_AT}: {log[-2000:]}")
        last = f"step_{RESTART_STEPS:010d}"
        ma, mb = (json.loads((p / last / "manifest.json").read_text())
                  for p in (straight, resumed))
        if sorted(ma["leaves"]) != sorted(mb["leaves"]):
            raise AssertionError("train_restart: leaf sets differ")
        differ = []
        for key, ent in ma["leaves"].items():
            x = np.load(straight / last / "shard_00000" / ent["file"])
            y = np.load(resumed / last / "shard_00000"
                        / mb["leaves"][key]["file"])
            if x.shape != y.shape or x.tobytes() != y.tobytes():
                differ.append(key)
        if differ:
            raise AssertionError(f"train_restart: leaves differ {differ}")
    return {"leaves_equal": len(ma["leaves"]), "runs": runs}


def phase_train(dev):
    """Phase 15, training: the Function at the training call, then
    TRAIN_ARCH (depth TRAIN_LAYERS) trained with the launch counts set to
    0 just before its run, then restart == straight through the CLI.
    Prints the reports; returns (the kernels-line entries, the trainer's
    report)."""
    t0 = time.perf_counter()
    train_attn, entries = check_train_attention(dev)
    print("train_attention: " + json.dumps(train_attn))
    for k in entries:
        print(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e}, "
              f"{k['ms']:.4f} ms vs plain {k['plain_ms']:.3f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})")
    rep = train_full_width(dev)
    print("train_full_width: " + json.dumps(rep))
    print("train_restart: " + json.dumps(train_restart()))
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return entries, rep


# ------------------------------------------------------------ phase 16 --
# training across processes: two ranks on cuda:0 in a gloo group (NCCL
# will not put two ranks on one card), one process a rank
MULTI_TIMEOUT_S = 900
EP_ARCH, EP_LAYERS = "olmoe-1b-7b", 2
DP_ARCH, DP_LAYERS = "qwen3-4b", 2
# 16g / 16h: the Mamba-1 LM and the hybrid on a 1 x 2 mesh, each layer on
# its model-axis channels (zamba2's 2 layers hold one application of the
# shared block)
SSM_ARCH, SSM_LAYERS = "falcon-mamba-7b", 2
HYB_ARCH, HYB_LAYERS = "zamba2-1.2b", 2
MULTI_BATCH, MULTI_SEQ, MULTI_STEPS = 2, 1024, 2   # 3 until phase 19 came
# the hyper-parameters of the reference's compressed-step test
# (tests/test_launch.py): lr 0, 1e-5, 2e-5 over its three steps
MULTI_HYPER = dict(peak_lr=1e-3)
# moe_ffn_a2a against moe_ffn_gspmd on one layer: tests/test_torch_moe.py's
# bf16 bar, of each output's and each gradient's largest magnitude
EP_FFN_TOL = 2e-2
# a whole step across the ranks (16a, 16b, 16c) against the one-device
# step: between the sound runs' largest readings (|loss difference|
# 8.7e-5, gradient norm 0.17 % low: PR 28's chip runs) and a run whose
# every rank takes slice 0 of the batch (``--multi-only --half-batch``)
MULTI_LOSS_ATOL = 1e-3
MULTI_GNORM_RTOL = 5e-3
# the compressed step against the plain step: the reference's bars (at
# these learning rates they cannot fail: Adam moves an element by at most
# lr a step; the gradient norm above and the leaf check below can)
COMP_LOSS_ATOL, COMP_PARAM_ATOL = 0.05, 1e-3
# compressed_psum on one leaf of qwen3-4b's shape (an MLP w1), two rounds
# of error feedback, against the leaf formula of
# src/repro/optim/compression.py on the gathered gradients and residuals:
# the same operations on the same card, so bit for bit
COMP_LEAF_SHAPE = (2560, 9728)
# qwen3-4b's w2 call (rows x K) @ (K x N) at bf16: the sum of two bf16
# partial products rounds once more than the plain product
ROWP_SHAPE = (2048, 9728, 2560)
ROWP_TOL = 1e-2
MULTI_PEAK_GB = 70.0
# 16e against 16b from one state on one batch: the same forward, so step
# 1's loss is the same bits; the gradient norm sums the same squares in
# another order (bucketed by the axes that split each leaf)
FSDP_GNORM_RTOL = 1e-6
# the attention's call in each rank (B, H, KVH, S, D): qwen3-4b's batch
# row (2 x 1); olmoe's whole batch at this rank's 8 of 16 heads (1 x 2:
# column-parallel, G 1); qwen3-4b's whole batch at this rank's 4 of 8 kv
# heads and their 16 query heads (1 x 2)
DP_ATTN_SHAPE = (MULTI_BATCH // 2, 32, 8, MULTI_SEQ, 128)
EP_ATTN_SHAPE = (MULTI_BATCH, 8, 8, MULTI_SEQ, 128)
COL_ATTN_SHAPE = (MULTI_BATCH, 16, 4, MULTI_SEQ, 128)
# zamba2's shared block at a rank's 16 of 32 kv heads (16h)
HYB_ATTN_SHAPE = (MULTI_BATCH, 16, 16, MULTI_SEQ, 64)


def _multi_cfg(arch, layers):
    """``arch`` at full width with its depth cut to ``layers``; a moe at
    capacity factor E / k (nothing dropped, so the per-shard caps of the
    a2a dispatch and the one-device cap drop the same: nothing)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    return cfg


def _multi_batch(cfg, step, index=0, count=1):
    """Slice ``index`` of ``count`` of the global batch of ``step`` (seed
    0)."""
    from repro_torch.data import synthetic_batch

    return synthetic_batch(0, step, MULTI_BATCH, MULTI_SEQ, cfg.vocab_size,
                           index, count)


def _one_device_steps(dev, arch, layers, steps):
    """``steps`` one-device train steps of ``_multi_cfg(arch, layers)``
    from seed 0 on the whole batch: their losses, gradient norms, ms and
    the peak GB; the state is freed."""
    import torch

    from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                          make_train_step)
    from repro_torch.models.model_zoo import build

    cfg = _multi_cfg(arch, layers)
    bundle = build(cfg)
    state = init_train_state(bundle, torch.Generator(device=dev).manual_seed(0),
                             dev)
    step_fn = make_train_step(bundle, TrainHyper(**MULTI_HYPER))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"loss": [], "grad_norm": [], "step_ms": []}
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step_fn(state, _multi_batch(cfg, i))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, step_fn
    torch.cuda.empty_cache()
    return out


def _digests(leaves):
    """A fingerprint of each leaf's bits, computed on its device: the
    sums, wrapping in int64, of its 32-bit (16-bit) words, plain and
    weighted by their position mod 65,521 (plus one).  Two ranks' leaves
    that differ in a bit differ in one of the sums but for a vanishing
    share of patterns; equal leaves always agree."""
    import torch

    out = []
    for p in leaves:
        w = p.detach().reshape(-1)
        w = w.view(torch.int32 if w.element_size() == 4 else torch.int16)
        sums = torch.zeros(2, dtype=torch.int64, device=w.device)
        for a in range(0, w.numel(), 1 << 24):
            c = w[a:a + (1 << 24)].long()
            pos = torch.arange(a, a + c.numel(), device=c.device) % 65521 + 1
            sums += torch.stack([c.sum(), (c * pos).sum()])
        out.append(sums.tolist())
    return out


def _wire_report(wire):
    return {f"{op}/{dt}": v for (op, dt), v in wire.totals().items()}


def _whole_on(plan, mesh):
    """True for a leaf whose plan splits it over no axis of ``mesh``
    larger than 1 (every rank holds all of it)."""
    return not any(mesh.shape[a] > 1 for axes in plan if axes for a in axes)


def _rest_bytes(state):
    """This rank's bytes at rest of the parameters and both moments."""
    from repro_torch.optim.adamw import tree_leaves

    opt = state["opt"]
    return sum(x.numel() * x.element_size() for tree in (
        state["params"], opt.mu, opt.nu) for x in tree_leaves(tree))


def _plan_bytes(cfg, mesh):
    """The bytes of a device's parameters and both moments under
    ``launch.params.param_plan`` on ``mesh``'s shape: each leaf of the
    model's init on the meta device (its whole shape and dtype) over the
    plan's split count, the moments at ``cfg.optimizer_dtype``."""
    import torch

    from repro_torch.launch.params import param_plan, split_count
    from repro_torch.models.convert import _walk
    from repro_torch.models.model_zoo import build

    odt = torch.empty((), dtype=cfg.torch_optimizer_dtype()).element_size()
    total = 0
    for path, x in _walk(build(cfg).init(None, "meta",
                                         dtype=cfg.torch_param_dtype())):
        n = x.numel() // split_count(param_plan(path, x.shape, mesh.shape),
                                     mesh.shape)
        total += n * (x.element_size() + 2 * odt)
    return total


def _data_parallel_step(bundle, hyper, mesh):
    """The data-parallel step of whole replicated state (16b): the model
    run without a mesh on this rank's slice of the batch, every gradient
    summed over the data axes in rank order and averaged, AdamW on the
    whole leaves - the step FSDP (16e) is held to."""
    from repro_torch.launch import steps as S
    from repro_torch.launch.sharding import set_mesh

    grads_of = S._grads_fn(bundle, hyper)

    def step(state, batch):
        params, opt = state["params"], state["opt"]
        set_mesh(None)
        try:
            loss, grads = grads_of(params, S._leaves_for_grad(params),
                                   S.batch_to_device(batch, opt.step.device))
        finally:
            set_mesh(mesh)
        loss, grads = S._group_mean(loss, grads, mesh, mesh.dp_axes())
        params, opt, m = S._apply(hyper, params, opt, grads, None)
        return {"params": params, "opt": opt}, {"loss": loss, **m}

    return step


def _launches():
    from repro_torch.kernels import ops

    return {w.__name__: w.launches for w in ops.WRAPPERS}


def _ep_rank(dev):
    """16a in one rank of the 1 x 2 mesh: olmoe-1b-7b's first moe layer
    through ``moe_ffn`` (the a2a dispatch, this rank's 32 of 64 experts)
    against ``moe_ffn_gspmd`` on every expert, on the same bf16 tokens (B
    x S), forward and the gradient of sum(out^2) of each leaf; then one
    train step of the whole model (EP_LAYERS layers, the kernels
    forward), its state placed by the plan, with the launch counts set to
    0 just before it."""
    import numpy as np
    import torch

    from repro_torch.core.collectives import WIRE
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.launch.steps import TrainHyper, make_train_step
    from repro_torch.models import moe
    from repro_torch.models.convert import shard_dims, shard_params
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.kernels import ops

    cfg = _multi_cfg(EP_ARCH, EP_LAYERS)
    bundle = build(cfg)
    mesh = make_train_mesh((1, 2), ("data", "model"), devices=dev)
    mi = mesh.axis_rank("model")
    e_loc = cfg.moe.n_experts // 2
    full = bundle.init(torch.Generator(device=dev).manual_seed(0), dev,
                       dtype=cfg.torch_param_dtype())
    x = _randn(np.random.default_rng(16),
               (MULTI_BATCH, MULTI_SEQ, cfg.d_model), 0.0, dev,
               torch.bfloat16)
    layer = {k: v[0].detach() for k, v in full["blocks"]["moe"].items()}

    def run(fn, p):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        y = fn(x, leaves)
        g = torch.autograd.grad(y.float().square().sum(),
                                list(leaves.values()))
        return y.detach(), dict(zip(leaves, g))

    y_ref, g_ref = run(lambda x_, p: moe.moe_ffn_gspmd(x_, p, cfg), layer)
    # this rank's experts and the whole router, as the layer computes
    # with them
    experts = {k: v for k, v in layer.items() if k != "router"}
    local = dict(shard_params({"moe": experts}, mesh)["moe"],
                 router=layer["router"])
    set_mesh(mesh)
    WIRE.reset()
    t0 = time.perf_counter()
    y, g = run(lambda x_, p: moe.moe_ffn(x_, p, cfg), local)
    torch.cuda.synchronize()
    layer_s = time.perf_counter() - t0
    set_mesh(None)
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max())
    errs = {"out": rel(y, y_ref)}
    for k, gk in g.items():
        want = g_ref[k] if k == "router" else g_ref[k][mi * e_loc:
                                                       (mi + 1) * e_loc]
        errs[k] = rel(gk, want)
    rep = {"coords": dict(mesh.coords), "layer": dict(
        err_of_max=errs, wire=_wire_report(WIRE), fwd_bwd_s=layer_s,
        stage_s=WIRE.stage_s, wire_s=WIRE.wire_s,
        experts=tuple(local["w1"].shape))}
    del y, g, y_ref, g_ref, layer, local, x

    params = shard_params(full, mesh)
    del full
    torch.cuda.empty_cache()
    state = {"params": params,
             "opt": adamw_init(params, cfg.torch_optimizer_dtype())}
    del params
    step_fn = make_train_step(bundle, TrainHyper(**MULTI_HYPER))
    set_mesh(mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    WIRE.reset()
    t0 = time.perf_counter()
    state, m = step_fn(state, _multi_batch(cfg, 0))
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = _launches()
    set_mesh(None)
    leaves = tree_leaves(state["params"])
    whole = [_whole_on(plan, mesh)
             for plan in shard_dims(state["params"], cfg, mesh)]
    rep["step"] = dict(
        loss=loss, grad_norm=gnorm, step_ms=step_s * 1e3,
        launches=launches, wire=_wire_report(WIRE), wait_s=WIRE.wait_s,
        stage_s=WIRE.stage_s, wire_s=WIRE.wire_s,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        params=sum(p.numel() for p in leaves),
        rest_bytes=_rest_bytes(state), plan_bytes=_plan_bytes(cfg, mesh),
        replicated_digests=_digests(
            [p for p, w in zip(leaves, whole) if w]),
        sharded_leaves=whole.count(False))
    del state, leaves, step_fn
    torch.cuda.empty_cache()
    return rep


def _drive_steps(dev, cfg, mesh, step_fn, state, half_batch=False):
    """MULTI_STEPS steps of ``step_fn`` on this rank's slices of the
    global batches (slice 0 on every rank with ``half_batch``), the
    launch counts and the wire log set to 0 just before: (state, report
    with each step's loss, gradient norm, wall ms and its split - host
    seconds waiting for the device before a staging copy (compute),
    staging, gloo - the launches and the peak GB)."""
    import torch

    from repro_torch.core.collectives import WIRE
    from repro_torch.kernels import ops

    n = mesh.axis_size(mesh.dp_axes())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    WIRE.reset()
    rep = {k: [] for k in ("loss", "grad_norm", "step_ms", "wait_ms",
                           "stage_ms", "wire_ms")}
    for i in range(MULTI_STEPS):
        before = (WIRE.wait_s, WIRE.stage_s, WIRE.wire_s)
        t0 = time.perf_counter()
        index = 0 if half_batch else mesh.dp_rank()
        state, m = step_fn(state, _multi_batch(cfg, i, index, n))
        rep["loss"].append(float(m["loss"]))
        rep["grad_norm"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        rep["step_ms"].append((time.perf_counter() - t0) * 1e3)
        for key, b, a in zip(("wait_ms", "stage_ms", "wire_ms"), before,
                             (WIRE.wait_s, WIRE.stage_s, WIRE.wire_s)):
            rep[key].append((a - b) * 1e3)
    rep["launches"] = _launches()
    rep["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rep["wire"] = _wire_report(WIRE)
    return state, rep


def _dp_rank(dev, half_batch=False):
    """16b, 16e and 16c in one rank: DP_ARCH (DP_LAYERS layers) from seed
    0, MULTI_STEPS data-parallel steps of whole replicated state on a
    2 x 1 mesh, then as many FSDP steps (the state placed by the plan)
    on it, then the same from the same state through the compressed step
    on a pod axis of 2; the compressed run's parameters against the
    plain run's (kept on the host); then :func:`_comp_leaf` over the pod
    group."""
    import torch

    from repro_torch.core.collectives import WIRE
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                          make_compressed_train_step,
                                          make_train_step)
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import tree_leaves

    cfg = _multi_cfg(DP_ARCH, DP_LAYERS)
    bundle = build(cfg)
    hyper = TrainHyper(**MULTI_HYPER)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)

    mesh = make_train_mesh((2, 1), ("data", "model"), devices=dev)
    set_mesh(mesh)
    state = init_train_state(bundle, gen(), dev)
    state, plain = _drive_steps(dev, cfg, mesh,
                                _data_parallel_step(bundle, hyper, mesh),
                                state, half_batch)
    leaves = tree_leaves(state["params"])
    plain["params"] = sum(p.numel() for p in leaves)
    plain["rest_bytes"] = _rest_bytes(state)
    plain["digests"] = _digests(leaves)
    kept = [p.detach().cpu() for p in leaves]
    del state, leaves
    torch.cuda.empty_cache()

    state = init_train_state(bundle, gen(), dev, mesh=mesh)
    fsdp_rest = _rest_bytes(state)
    state, fsdp = _drive_steps(dev, cfg, mesh, make_train_step(bundle, hyper),
                               state, half_batch)
    set_mesh(None)
    fsdp.update(rest_bytes=fsdp_rest, plan_bytes=_plan_bytes(cfg, mesh))
    del state
    torch.cuda.empty_cache()

    mesh = make_train_mesh((2, 1, 1), ("pod", "data", "model"),
                           devices=dev)
    step_fn = make_compressed_train_step(bundle, hyper, mesh)
    state = init_train_state(bundle, gen(), dev, mesh=step_fn.mesh)
    state["comp"] = step_fn.init_comp(state["params"])
    state, comp = _drive_steps(dev, cfg, mesh, step_fn, state, half_batch)
    leaves = tree_leaves(state["params"])
    int16 = [e for e in WIRE.entries if e[1] == "int16"]
    comp.update(
        n_leaves=len(leaves), int16_calls=len(int16),
        int16_bytes=sum(e[2] for e in int16),
        int16_bytes_want=2 * sum(p.numel() for p in leaves) * MULTI_STEPS,
        max_param_diff_vs_plain=max(
            float((p.detach() - q.to(dev)).abs().max())
            for p, q in zip(leaves, kept)),
        digests=_digests(leaves))
    del state, leaves, kept
    torch.cuda.empty_cache()
    comp["leaf"] = _comp_leaf(dev, mesh.axis_group("pod"))
    return {"dp": plain, "fsdp": fsdp, "comp": comp}


def _col_rank(dev, arch, layers):
    """16f / 16g / 16h in one rank: ``arch`` (``layers`` layers) from seed
    0 on a 1 x 2 mesh, its state placed by the plan and each layer on its
    model-axis block (column-parallel attention and MLP, the
    vocab-parallel embedding and loss, the Mamba channels), MULTI_STEPS
    steps on the whole global batch; the wire log beside what
    ``launch.roofline.collective_bytes`` reckons for those steps."""
    import torch

    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.launch.steps import (TrainHyper, init_train_state,
                                          make_train_step)
    from repro_torch.models.convert import shard_dims
    from repro_torch.models.model_zoo import build
    from repro_torch.optim.adamw import tree_leaves

    cfg = _multi_cfg(arch, layers)
    bundle = build(cfg)
    mesh = make_train_mesh((1, 2), ("data", "model"), devices=dev)
    set_mesh(mesh)
    state = init_train_state(bundle, torch.Generator(device=dev).manual_seed(0),
                             dev, mesh=mesh)
    rest = _rest_bytes(state)
    state, col = _drive_steps(dev, cfg, mesh,
                              make_train_step(bundle, TrainHyper(**MULTI_HYPER)),
                              state)
    set_mesh(None)
    leaves = tree_leaves(state["params"])
    whole = [_whole_on(plan, mesh)
             for plan in shard_dims(state["params"], cfg, mesh)]
    reckoned = roofline.collective_bytes(
        cfg, "train", MULTI_BATCH, MULTI_SEQ, dict(mesh.shape),
        params=bundle.init(None, "meta", dtype=cfg.torch_param_dtype()))
    col.update(rest_bytes=rest, plan_bytes=_plan_bytes(cfg, mesh),
               sharded_leaves=whole.count(False),
               wire_reckoned={f"{op}/{dt}": n * MULTI_STEPS for (op, dt), n
                              in reckoned["by_op"].items()},
               wire_reckoned_by_kind=reckoned["bytes"],
               replicated_digests=_digests(
                   [p for p, w in zip(leaves, whole) if w]))
    del state, leaves
    torch.cuda.empty_cache()
    return col


def _comp_leaf(dev, group):
    """``compressed_psum`` on one fp32 leaf of COMP_LEAF_SHAPE, a
    different gradient on each rank (seeded by round and rank), two
    rounds with the residual carried, against the reference's leaf
    formula computed here from every rank's gradient and residual
    (gathered): the largest differences of the average and of this rank's
    residual (0: bit for bit), and the wire's int16 bytes."""
    import torch

    from repro_torch.core.collectives import (WIRE, all_gather, group_rank,
                                              group_size)
    from repro_torch.optim import compressed_psum, compression_init

    n, rank = group_size(group), group_rank(group)
    const = lambda v: torch.full((), v, dtype=torch.float32, device=dev)
    g = {"w": torch.zeros(COMP_LEAF_SHAPE, device=dev)}
    st = compression_init(g)
    out = {"avg_diff": [], "residual_diff": [], "int16_bytes": 0}
    for t in range(2):
        gen = torch.Generator(device=dev).manual_seed(100 * t + rank)
        g["w"] = torch.randn(COMP_LEAF_SHAPE, generator=gen, device=dev) * (
            1e-3 * (1 + rank))
        # every rank's gradient and residual, before the call writes
        # them in place
        gs = all_gather(g["w"][None], 0, group)
        rs = all_gather(st.residual["w"][None], 0, group)
        WIRE.reset()
        avg, st = compressed_psum(g, st, group)
        out["int16_bytes"] += sum(e[2] for e in WIRE.entries
                                  if e[1] == "int16")
        gf = gs + rs
        scale = gf.abs().max() / const(127.0) + 1e-12
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        want = q.to(torch.int32).sum(0).float() * scale / const(n)
        out["avg_diff"].append(float((avg["w"] - want).abs().max()))
        out["residual_diff"].append(float(
            (st.residual["w"] - (gf[rank] - q[rank] * scale)).abs().max()))
    out["int16_bytes_want"] = 2 * 2 * g["w"].numel()   # 2 rounds
    return out


def _rowp_rank(dev):
    """16d in one rank: ``row_parallel_matmul`` at qwen3-4b's w2 call
    (ROWP_SHAPE, bf16) on a 1 x 2 mesh, this rank's K / 2 rows of w,
    forward and the weight gradient, against the plain product on the
    whole w in this process."""
    import math

    import numpy as np
    import torch

    from repro_torch.core.collectives import WIRE
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.sharding import set_mesh
    from repro_torch.models.layers import row_parallel_matmul

    rows, kdim, n = ROWP_SHAPE
    bf = torch.bfloat16
    rng = np.random.default_rng(17)
    x = _randn(rng, (rows, kdim), 0.0, dev, bf)
    w = (_randn(rng, (kdim, n), 0.0, dev, torch.float32)
         / math.sqrt(kdim)).to(bf)
    g = _randn(rng, (rows, n), 0.0, dev, bf)
    mesh = make_train_mesh((1, 2), ("data", "model"), devices=dev)
    mi, kk = mesh.axis_rank("model"), kdim // 2
    wp = w.clone().requires_grad_(True)
    y_p = x @ wp
    (gw_p,) = torch.autograd.grad(y_p, wp, g)
    w_loc = w[mi * kk:(mi + 1) * kk].clone().requires_grad_(True)
    set_mesh(mesh)
    WIRE.reset()
    y = row_parallel_matmul(x, w_loc, bf)
    (gw,) = torch.autograd.grad(y, w_loc, g)
    wire = _wire_report(WIRE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        row_parallel_matmul(x, w_loc, bf)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    set_mesh(None)
    rel = lambda a, b: float((a.detach().float() - b.detach().float()).abs()
                             .max() / b.detach().float().abs().max())
    x_loc = x[:, mi * kk:(mi + 1) * kk].contiguous()
    return dict(
        err_out_of_max=rel(y, y_p),
        err_grad_of_max=rel(gw, gw_p[mi * kk:(mi + 1) * kk]),
        wire=wire, wall_ms=wall_ms,
        local_ms=_cuda_time_ms(lambda: x_loc @ w_loc.detach(), 20),
        plain_ms=_cuda_time_ms(lambda: x @ w, 20))


def _multi_rank(rank, store, out_dir, device, half_batch):
    """One rank of the world-2 group of phase 16, on ``device``: the
    determinism settings of the trainer CLI, then 16a, 16b / 16e / 16c
    (every rank on slice 0 of the batch with ``half_batch``), 16f, 16g,
    16h, 16d."""
    import os

    import torch
    import torch.distributed as dist

    # before the first cuBLAS call, as the trainer CLI sets them
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2)
    try:
        res = {"ep": _ep_rank(dev)}
        res.update(_dp_rank(dev, half_batch))
        res["col"] = _col_rank(dev, DP_ARCH, DP_LAYERS)
        res["ssm"] = _col_rank(dev, SSM_ARCH, SSM_LAYERS)
        res["hyb"] = _col_rank(dev, HYB_ARCH, HYB_LAYERS)
        res["rowp"] = _rowp_rank(dev)
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _readings(one, ranks):
    """The largest |loss difference| and relative gradient-norm
    difference of each rank's steps from the one-device steps', for 16a,
    16b, 16c, 16e, 16f, 16g and 16h: {"16a": [(loss, norm) a rank],
    ...}."""
    def worst(rep, ref):
        return (max(abs(a - b) for a, b in zip(rep["loss"], ref["loss"])),
                max(abs(a - b) / b for a, b in zip(rep["grad_norm"],
                                                   ref["grad_norm"])))

    ep = lambda res: {k: [res["ep"]["step"][k]] for k in
                      ("loss", "grad_norm")}
    return {"16a": [worst(ep(res), one["ep"]) for res in ranks],
            "16b": [worst(res["dp"], one["dp"]) for res in ranks],
            "16c": [worst(res["comp"], one["dp"]) for res in ranks],
            "16e": [worst(res["fsdp"], one["dp"]) for res in ranks],
            "16f": [worst(res["col"], one["dp"]) for res in ranks],
            "16g": [worst(res["ssm"], one["ssm"]) for res in ranks],
            "16h": [worst(res["hyb"], one["hyb"]) for res in ranks]}


def _refused(readings):
    """The tags of ``_readings`` whose steps leave the one-device bars on
    some rank."""
    return sorted(tag for tag, per_rank in readings.items()
                  if any(not (dl <= MULTI_LOSS_ATOL and dn <= MULTI_GNORM_RTOL)
                         for dl, dn in per_rank))


def _check_multi(one, ranks, resident_gb):
    """Phase 16's gates over the ranks' reports; returns the reports."""
    per_step = lambda layers: 2 * layers   # each layer's forward + remat
    want = lambda n: {name: n if name in ("shift_kv", "pasa_attention")
                      else 0 for name in ranks[0]["ep"]["step"]["launches"]}
    ep_steps = [r["ep"]["step"] for r in ranks]
    # every step of 16a / 16b / 16c / 16e / 16f against the one-device
    # steps
    readings = _readings(one, ranks)
    bad = _refused(readings)
    if bad:
        raise AssertionError(
            f"{', '.join(bad)}: off the one-device steps (bars: loss "
            f"{MULTI_LOSS_ATOL}, gradient norm {MULTI_GNORM_RTOL}): "
            f"{json.dumps({t: readings[t] for t in bad})}")
    for r, res in enumerate(ranks):
        lay, st = res["ep"]["layer"], res["ep"]["step"]
        bad = {k: v for k, v in lay["err_of_max"].items() if v > EP_FFN_TOL}
        if bad or not lay["wire"].get("all_to_all/bfloat16"):
            raise AssertionError(f"16a rank {r}: a2a vs gspmd {lay}")
        if st["launches"] != want(per_step(EP_LAYERS)):
            raise AssertionError(f"16a rank {r}: launches {st['launches']}")
        # the hybrid's shared block (one application) runs outside remat;
        # the Mamba-1 LM runs no kernel
        for tag, name, n in (
                ("dp", "16b", per_step(DP_LAYERS)),
                ("comp", "16c", per_step(DP_LAYERS)),
                ("fsdp", "16e", per_step(DP_LAYERS)),
                ("col", "16f", per_step(DP_LAYERS)), ("ssm", "16g", 0),
                ("hyb", "16h", 1)):
            rep = res[tag]
            if rep["launches"] != want(n * MULTI_STEPS):
                raise AssertionError(f"{name} rank {r}: launches "
                                     f"{rep['launches']}")
        # the state placed by the plan: each rank's bytes at rest
        for name, rep in (("16a", st), ("16e", res["fsdp"]),
                          ("16f", res["col"]), ("16g", res["ssm"]),
                          ("16h", res["hyb"])):
            if rep["rest_bytes"] != rep["plan_bytes"]:
                raise AssertionError(f"{name} rank {r}: {rep['rest_bytes']} "
                                     f"bytes at rest, the plan "
                                     f"{rep['plan_bytes']}")
        # each layer on its model-axis block: the wire carries what the
        # roofline reckons, which gathers no embedding, head or SSM
        # channel leaf over the model axis
        for name, tag in (("16f", "col"), ("16g", "ssm"), ("16h", "hyb")):
            rep = res[tag]
            got = {k: v["bytes"] for k, v in rep["wire"].items()}
            if got != rep["wire_reckoned"]:
                raise AssertionError(f"{name} rank {r}: wire {got}, the "
                                     f"roofline {rep['wire_reckoned']}")
        fsdp, dp = res["fsdp"], res["dp"]
        if not (fsdp["loss"][0] == dp["loss"][0]
                and abs(fsdp["grad_norm"][0] - dp["grad_norm"][0])
                <= FSDP_GNORM_RTOL * dp["grad_norm"][0]):
            raise AssertionError(f"16e rank {r} against 16b: loss "
                                 f"{fsdp['loss']} / {dp['loss']}, norm "
                                 f"{fsdp['grad_norm']} / {dp['grad_norm']}")
        comp, leaf = res["comp"], res["comp"]["leaf"]
        for i in range(MULTI_STEPS):
            if not abs(comp["loss"][i] - one["dp"]["loss"][i]) \
                    < COMP_LOSS_ATOL:
                raise AssertionError(f"16c rank {r} step {i}: {comp} vs "
                                     f"one device {one['dp']}")
        if not (comp["max_param_diff_vs_plain"] < COMP_PARAM_ATOL
                and comp["int16_calls"] == comp["n_leaves"] * MULTI_STEPS
                and comp["int16_bytes"] == comp["int16_bytes_want"]):
            raise AssertionError(f"16c rank {r}: {comp}")
        if not (max(leaf["avg_diff"] + leaf["residual_diff"]) == 0.0
                and leaf["int16_bytes"] == leaf["int16_bytes_want"]):
            raise AssertionError(f"16c rank {r}: compressed_psum vs the "
                                 f"leaf formula {leaf}")
        rp = res["rowp"]
        if not (rp["err_out_of_max"] <= ROWP_TOL
                and rp["err_grad_of_max"] <= ROWP_TOL
                and rp["wire"] == {"all_gather/bfloat16": {
                    "calls": 1,
                    "bytes": ROWP_SHAPE[0] * ROWP_SHAPE[2] * 2}}):
            raise AssertionError(f"16d rank {r}: {rp}")
    # the same bits on both ranks: the replicated leaves, the losses
    for key, a, b in (
            ("16a replicated leaves", ep_steps[0]["replicated_digests"],
             ep_steps[1]["replicated_digests"]),
            ("16a loss", ep_steps[0]["loss"], ep_steps[1]["loss"]),
            ("16b parameters", ranks[0]["dp"]["digests"],
             ranks[1]["dp"]["digests"]),
            ("16c parameters", ranks[0]["comp"]["digests"],
             ranks[1]["comp"]["digests"]),
            ("16f replicated leaves", ranks[0]["col"]["replicated_digests"],
             ranks[1]["col"]["replicated_digests"]),
            ("16g replicated leaves", ranks[0]["ssm"]["replicated_digests"],
             ranks[1]["ssm"]["replicated_digests"]),
            ("16h replicated leaves", ranks[0]["hyb"]["replicated_digests"],
             ranks[1]["hyb"]["replicated_digests"])):
        if a != b:
            raise AssertionError(f"{key} differ between the ranks")
    peak = sum(res["dp"]["peak_gb"] for res in ranks) + resident_gb
    if peak > MULTI_PEAK_GB:
        raise AssertionError(f"16b: {peak:.2f} GB on the card")
    for res in ranks:
        for tag in ("dp", "comp"):
            res[tag].pop("digests")
        res["ep"]["step"].pop("replicated_digests")
        for tag in ("col", "ssm", "hyb"):
            res[tag].pop("replicated_digests")
    return {
        "multi_ep": dict(one_device=one["ep"], ranks=[
            res["ep"] for res in ranks]),
        "multi_dp": dict(one_device=one["dp"], ranks=[
            res["dp"] for res in ranks], peak_gb_card=peak,
            resident_gb=resident_gb),
        "multi_comp": dict(ranks=[res["comp"] for res in ranks]),
        "multi_fsdp": dict(one_device=one["dp"], ranks=[
            res["fsdp"] for res in ranks]),
        "multi_col": dict(one_device=one["dp"], ranks=[
            res["col"] for res in ranks]),
        "multi_ssm": dict(one_device=one["ssm"], ranks=[
            res["ssm"] for res in ranks]),
        "multi_hyb": dict(one_device=one["hyb"], ranks=[
            res["hyb"] for res in ranks]),
        "multi_rowp": dict(shape=ROWP_SHAPE, ranks=[
            res["rowp"] for res in ranks]),
    }


def phase_multi(dev, half_batch=False):
    """Phase 16, training across processes, two ranks on ``dev`` in a
    gloo group (:func:`_multi_rank`): the one-device steps first (and
    freed), then the group's 16a (expert parallel: olmoe-1b-7b's a2a
    layer and a whole step on a 1 x 2 mesh), 16b (data parallel:
    qwen3-4b, MULTI_STEPS steps on a 2 x 1 mesh), 16e (FSDP on it), 16c
    (the compressed sync on a pod axis of 2), 16f / 16g / 16h (qwen3-4b,
    falcon-mamba-7b and zamba2-1.2b, each layer on its model-axis block
    of a 1 x 2 mesh) and 16d (the row-parallel w2 product), each gated
    (``_check_multi``); a failing rank fails the phase.  Then the kernels
    at the ranks' call shapes.  Prints the reports; returns the
    kernels-line entries (launches: every rank's, summed).

    ``half_batch``: every rank of 16b / 16c / 16e takes slice 0 of the
    global batch, as a wrong data rank would; the phase then fails unless
    the gates refuse each of the three, and returns no entries."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    one = {"ep": _one_device_steps(dev, EP_ARCH, EP_LAYERS, 1),
           "dp": _one_device_steps(dev, DP_ARCH, DP_LAYERS, MULTI_STEPS),
           "ssm": _one_device_steps(dev, SSM_ARCH, SSM_LAYERS, MULTI_STEPS),
           "hyb": _one_device_steps(dev, HYB_ARCH, HYB_LAYERS, MULTI_STEPS)}
    torch.cuda.empty_cache()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    (ROOT / "build").mkdir(exist_ok=True)
    out_dir = Path(tempfile.mkdtemp(prefix="multi", dir=ROOT / "build"))
    t_group = time.perf_counter()
    ctx = mp.spawn(_multi_rank, nprocs=2, join=False, args=(
        str(out_dir / "store"), str(out_dir), str(dev), half_batch))
    deadline = time.monotonic() + MULTI_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the phase-16 group ran past "
                                 f"{MULTI_TIMEOUT_S} s")
    group_s = time.perf_counter() - t_group
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    shutil.rmtree(out_dir, ignore_errors=True)
    readings = _readings(one, ranks)
    print("multi_readings: " + json.dumps(readings))
    if half_batch:
        refused = _refused(readings)
        print(f"half batch refused at {', '.join(refused)}")
        if not {"16b", "16c", "16e"} <= set(refused):
            raise AssertionError("the phase-16 gates let a half batch "
                                 "through")
        return []
    reps = _check_multi(one, ranks, resident_gb)
    reps["multi_dp"]["group_s"] = group_s
    for tag, r in reps.items():
        print(f"{tag}: " + json.dumps(r))
    entries = (_train_call_entries(dev, DP_ATTN_SHAPE, "train_dp")
               + _train_call_entries(dev, EP_ATTN_SHAPE, "train_ep")
               + _train_call_entries(dev, COL_ATTN_SHAPE, "train_col")
               + _train_call_entries(dev, HYB_ATTN_SHAPE, "train_col_d64"))
    runs = {"train_dp": lambda res: (res["dp"], res["comp"], res["fsdp"]),
            "train_ep": lambda res: (res["ep"]["step"],),
            "train_col": lambda res: (res["col"],),
            "train_col_d64": lambda res: (res["hyb"],)}
    for k in entries:
        name, _, tag = k["name"].partition("/")
        k["launches"] = sum(rep["launches"][name] for res in ranks
                            for rep in runs[tag](res))
        print(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e}, "
              f"{k['ms']:.4f} ms vs plain {k['plain_ms']:.3f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), launches {k['launches']}")
    print(f"phase 16: {time.perf_counter() - t0:.1f} s (the group "
          f"{group_s:.1f} s)")
    return entries


# ---------------------------------------------------------------------------
# phase 17: the dry run's accounting held against the card.  The FLOPs of
# one step (phase 15's qwen2-7b training step: TRAIN_LAYERS of 28 layers,
# TRAIN_BATCH x TRAIN_SEQ, fp32 state, remat) and of one dense decode call
# (phase 4's: full depth, batch 4, kv 1002 in the dense serve's 1040-row
# cache) counted by ``launch.op_analysis`` on the card equal the dry run's
# counts of the same cells on the meta device, exactly; the state's bytes
# on the card, after it is built and before the first step, are within
# TOOLS_STATE_RTOL of the dry run's parameter and moment bytes; and every
# share of a published H100 peak is below TOOLS_SHARE_MAX (a reading above
# it means a count is wrong).
TOOLS_DECODE_BATCH, TOOLS_DECODE_ROWS, TOOLS_DECODE_KV = 4, 1040, 1002
TOOLS_STATE_RTOL = 0.01
TOOLS_SHARE_MAX = 1.05
TOOLS_TIMED = 3


def _check_shares(tag, shares):
    bad = {k: v for k, v in shares.items() if not 0.0 < v < TOOLS_SHARE_MAX}
    if bad:
        raise AssertionError(f"{tag}: shares of a published peak out of "
                             f"(0, {TOOLS_SHARE_MAX}): {bad}")


def _count_fields(c) -> dict:
    return {"flops": c.flops, "bytes": c.bytes,
            "flops_by_op": c.flops_by_op, "calls_by_op": c.calls_by_op}


def tools_decode(dev, bundle, params):
    """Phase 17a: one dense decode call of ``bundle`` (qwen2-7b at full
    depth, serving weights ``params``) counted on the card against the dry
    run's count on meta (FLOPs and bytes by op, exactly); its wall ms and
    its device busy ms (``torch.profiler``: the union of its kernels'
    intervals); the shares of the byte bound (the counted bytes at 3.35
    TB/s) and of the analytic memory model's
    (``roofline.analytic_memory_bytes``, the weights at the dtype they
    are served at) in them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.dryrun import count_decode
    from repro_torch.launch.profile_steps import _busy_us

    b, rows, kv = TOOLS_DECODE_BATCH, TOOLS_DECODE_ROWS, TOOLS_DECODE_KV
    cfg = bundle.cfg
    cache = bundle.init_cache(b, rows, device=dev)
    card = count_decode(bundle, params, b, rows, kv, dev, cache=cache)
    meta = count_decode(bundle, bundle.init(None, "meta"), b, rows, kv,
                        "meta")
    if card.as_dict() != meta.as_dict():
        raise AssertionError(f"tools_decode: the card's count "
                             f"{_count_fields(card)} != the dry run's "
                             f"{_count_fields(meta)}")
    token = torch.zeros((b,), dtype=torch.int32, device=dev)
    pos = torch.full((b,), kv - 1, dtype=torch.int32, device=dev)

    def call():
        with torch.no_grad():
            bundle.serve_step(params, token, pos, cache)

    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TOOLS_TIMED):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / TOOLS_TIMED * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TOOLS_TIMED):
            call()
        torch.cuda.synchronize()
    device_ms = _busy_us(prof) / TOOLS_TIMED / 1e3
    bound = R.bound(card.bytes, card.flops)
    analytic = R.analytic_memory_bytes(cfg, "decode", b, kv, 1, 1,
                                       param_dtype=R.held_dtype(params))
    analytic_ms = analytic["bytes"] / R.HBM_BW * 1e3
    rep = dict(flops=card.flops, bytes=card.bytes,
               flops_equal_dry_run=True, bound_ms=bound["bound_ms"],
               bound_by=bound["bound_by"], wall_ms=wall_ms,
               device_ms=device_ms, analytic_bytes=analytic["bytes"],
               calls_by_op=card.calls_by_op)
    shares = {"memory_roofline_of_device_ms": bound["bound_ms"] / device_ms,
              "memory_roofline_of_wall_ms": bound["bound_ms"] / wall_ms,
              "analytic_memory_of_device_ms": analytic_ms / device_ms}
    _check_shares("tools_decode", shares)
    rep["shares"] = shares
    del cache
    torch.cuda.empty_cache()
    return rep


def tools_train(dev):
    """Phase 17b: phase 15's training cell.  The state built on the card
    (parameters from seed 0, AdamW moments) against the dry run's
    per-device parameter and moment bytes (``dryrun.state_bytes`` on a 1 x
    1 mesh, before any gradient exists); one step counted on the card
    against the dry run's count of the same step on meta (FLOPs exactly);
    then TOOLS_TIMED steps timed: the MFU (``roofline.model_flops`` 6 N T
    over the step's seconds at 989 TFLOP/s) and the counted FLOPs' share
    of the same peak."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.launch import op_analysis
    from repro_torch.launch.dryrun import count_train_step, state_bytes
    from repro_torch.launch.steps import (TrainHyper, batch_to_device,
                                          make_train_step)
    from repro_torch.models.model_zoo import build
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    bundle = build(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev,
                         dtype=cfg.torch_param_dtype())
    state = {"params": params,
             "opt": adamw_init(params, cfg.torch_optimizer_dtype())}
    del params
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    meta_params = bundle.init(None, "meta", dtype=cfg.torch_param_dtype())
    plan = state_bytes(cfg, meta_params, {"data": 1, "model": 1})["held"]
    want = plan["params"] + plan["moments"]
    if abs(held - want) > TOOLS_STATE_RTOL * want:
        raise AssertionError(f"tools_train: state {held} B on the card vs "
                             f"the dry run's {want} B")
    pipe = DataPipeline(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        vocab=cfg.vocab_size, seed=0)
    batches = [batch_to_device(next(pipe), dev)
               for _ in range(1 + TOOLS_TIMED)]
    pipe.close()
    step = make_train_step(bundle, TrainHyper(**TRAIN_HYPER))
    with op_analysis.count() as card:
        state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    meta_state = {"params": meta_params, "opt": adamw_init(
        meta_params, cfg.torch_optimizer_dtype())}
    meta = count_train_step(bundle, meta_state, TRAIN_BATCH, TRAIN_SEQ,
                            "meta")
    if card.flops != meta.flops or card.flops_by_op != meta.flops_by_op:
        raise AssertionError(f"tools_train: the card's count "
                             f"{_count_fields(card)} != the dry run's "
                             f"{_count_fields(meta)}")
    times = []
    for batch in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = sum(times) / len(times)
    pc = R.count_params(meta_params)
    mf = R.model_flops(pc["total"], pc["expert"], cfg.moe.top_k,
                       cfg.moe.n_experts, TRAIN_BATCH * TRAIN_SEQ,
                       kind="train")
    shares = {"mfu": mf / (step_s * R.PEAK_FLOPS),
              "counted_flops_share": card.flops / (step_s * R.PEAK_FLOPS)}
    _check_shares("tools_train", shares)
    rep = dict(layers=cfg.n_layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               params=pc["total"], state_bytes_on_card=held,
               state_bytes_dry_run=want,
               state_rel_gap=(held - want) / want, flops=card.flops,
               flops_equal_dry_run=True, flops_by_op=card.flops_by_op,
               model_flops=mf, step_ms=[t * 1e3 for t in times],
               loss=float(m["loss"]), shares=shares)
    del state, batches
    torch.cuda.empty_cache()
    return rep


# phase 18: head_dim 32 in every kernel and head_dim 64 in paged prefill,
# at the reference's kernel-test shapes: attention (B, H, KVH, S, D) of
# tests/test_kernels.py (blocks 128 / 128, queries of mean 0 and keys of
# mean 2); contiguous decode (B, KVH, S2, D) of tests/test_paged.py at kv
# 300 / 77, its one query head per kv head and a group of 4; paged decode
# (KVH, G, page, kv) of tests/test_paged.py; paged prefill (H, KVH, chunk,
# page, starts) of tests/test_prefix_cache.py; paged prefill at head_dim
# 64 on phase 2's prefill fixture (PREFILL_ROWS, 28 heads over KVH 4, page
# 128).  PASA runs on queries of mean 1 in the prefill cases and FA2 on
# queries of mean 0 (FA2 stores the raw scores at fp16 before its scale,
# as the card tests of the prefill kernel say)
MODES_ATTN_SHAPE = (1, 5, 5, 384, 32)
MODES_DECODE_SHAPE = (2, 2, 512, 32)
MODES_DECODE_KV = (300, 77)
MODES_DECODE_GROUPS = (1, 4)
MODES_PAGED = (2, 4, 64, (100, 37))
MODES_PREFILL = (4, 2, 64, 16, (32, 0))
MODES_POLICIES = ("fp16", "fp16_fp32", "fp32", "bf16_fp32")


def _modes_cases(dev):
    """Phase 18's cases: {(kernel entry, case): dict(run, plain, gold,
    tol, rmse_max, rows, same)}: ``run()`` a call of the op (a launch),
    ``plain()`` its plain version on the same inputs, ``gold`` float64 on
    the unquantized K/V over ``rows``, ``same()`` (optional) a second
    kernel whose output must equal run's bit for bit (the walk, contiguous
    decode on the paged rows).  Quantized pools are held by
    ``_check_quant_policies`` and listed under ``quant`` instead.  Also
    returns the timing inputs of each entry."""
    import functools

    import numpy as np
    import torch

    from repro_torch.core.precision import FP16, get_policy
    from repro_torch.kernels import ops
    amod = _kernel_module("pasa_attention")
    cmod = _kernel_module("pasa_decode")
    dmod = _kernel_module("pasa_paged_decode")
    pmod = _kernel_module("pasa_paged_prefill")
    smod = _kernel_module("shift_kv")

    rng = np.random.default_rng(18)
    cases, quant, timing = {}, {}, {}

    # attention and shift-KV at (1, 5, 5, 384, 32)
    b, h, kvh, s, d = MODES_ATTN_SHAPE
    q = _randn(rng, (b, h, s, d), 0.0, dev, torch.float16)
    k = _randn(rng, (b, kvh, s, d), 2.0, dev, torch.float16)
    v = _randn(rng, (b, kvh, s, d), 0.0, dev, torch.float16)
    for causal in (False, True):
        gold = _gold_attention(q, k, v, causal)
        for tag in MODES_POLICIES:
            policy = get_policy(tag)
            for beta in (0.0, BETA):
                op = (functools.partial(ops.pasa_attention, beta=BETA)
                      if beta else ops.flash_attention)
                args = (q, k, v)
                cases[("pasa_attention/d32", f"causal {causal} {tag} "
                       f"beta {beta}")] = dict(
                    run=lambda a=args, op=op, policy=policy, causal=causal:
                        op(*a, policy=policy, causal=causal),
                    plain=lambda a=args, beta=beta, policy=policy,
                    causal=causal: amod.attention_plain(
                        *a, beta=beta, policy=policy, block_kv=128,
                        causal=causal),
                    gold=gold, tol=ATTN_CAUSAL_TOL if causal else ATTN_TOL,
                    rmse_max=ATTN_RMSE_MAX,
                    # PASA at bf16 operands: within the ratio of the plain
                    # version's RMSE (check_attention_hd64's note)
                    rmse_ratio=BF16_PASA_RMSE_RATIO
                    if tag == "bf16_fp32" and beta else None)
    timing["pasa_attention/d32"] = dict(q=q, k=k, v=v)
    keys = _randn(rng, (b, s, kvh, d), 2.0, dev, torch.float32)
    for block in (128, 64):
        for ktag, kdt, tag in (("", torch.bfloat16, "fp16"),
                               ("fp16_keys", torch.float16, "fp16"),
                               ("bf16_fp32", torch.bfloat16, "bf16_fp32")):
            policy = get_policy(tag)
            op = policy.input_dtype
            kk = keys.to(kdt).transpose(1, 2)
            m = smod.device_matrix(block, d, BETA, op, dev)
            kb = kk.to(op).contiguous().reshape(b, kvh, s // block, block, d)
            name = "_".join(x for x in ("d32", ktag, "" if block == 128
                                        else f"block{block}") if x)
            cases[(f"shift_kv/{name}", "")] = dict(
                run=lambda kk=kk, block=block, policy=policy: ops.shift_kv(
                    kk, beta=BETA, block_kv=block, policy=policy),
                plain=lambda kk=kk, m=m, block=block, op=op:
                    smod.shift_kv_plain(m, kk.to(op), block, out_dtype=op),
                gold=torch.matmul(m.double(), kb.double()).reshape(
                    b, kvh, s, d),
                tol=SHIFT_TOL, rmse_max=SHIFT_RMSE_MAX)
            timing[f"shift_kv/{name}"] = dict(
                k=kk, m=m, kb=kb, block=block, policy=policy,
                mode=smod.mode_name(kdt, op, block, d))

    # contiguous decode at (2, 2, 512, 32), kv 300 / 77, NaN past kv_len
    b, kvh, s2, d = MODES_DECODE_SHAPE
    lens = MODES_DECODE_KV
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = (torch.arange(s2, device=dev)[None, :] < kv_len[:, None])[
        ..., None, None]
    kc = torch.where(live, _randn(rng, (b, s2, kvh, d), 2.0, dev,
                                  torch.float32), math.nan).to(torch.bfloat16)
    vc = torch.where(live, _randn(rng, (b, s2, kvh, d), 0.0, dev,
                                  torch.float32), math.nan).to(torch.bfloat16)
    kview, vview = kc.transpose(1, 2), vc.transpose(1, 2)
    for g in MODES_DECODE_GROUPS:
        qd = _randn(rng, (b, kvh, g, d), 1.0, dev, torch.float16)
        gold = torch.stack([
            torch.softmax(qd[i].double() @ kview[i, :, :n].double()
                          .transpose(-1, -2) / math.sqrt(d), -1)
            @ vview[i, :, :n].double() for i, n in enumerate(lens)])
        for tag in MODES_POLICIES:
            policy = get_policy(tag)
            qp = qd.to(policy.input_dtype)
            for beta in (0.0, BETA):
                for block in (128, 256):
                    kw = dict(beta=beta, policy=policy, block_kv=block)
                    args = (qd, kview, vview, kv_len)
                    cases[("pasa_decode/d32", f"g{g} {tag} beta {beta} block "
                           f"{block}")] = dict(
                        run=lambda a=args, kw=kw: ops.pasa_decode(*a, **kw),
                        plain=lambda a=args, kw=kw: cmod.decode_plain(*a, **kw),
                        same=lambda a=(qp, *args[1:]), kw=kw: cmod._walk_call(
                            *a, **kw),
                        gold=gold, tol=DECODE_TOL, rmse_max=RMSE_MAX)
        timing[f"pasa_decode/d32 g{g}"] = dict(q=qd)
    timing["pasa_decode/d32"] = dict(k=kview, v=vview, kv_len=kv_len,
                                     lens=lens)

    # paged decode: KVH 2, G 4, page 64, kv 100 / 37, shuffled pages, NaN
    # past kv_len and on unreferenced pages; raw, int8 and fp8_e4m3 pools
    kvh, g, page, lens = MODES_PAGED
    b = len(lens)
    kp, vp, table = _paged_pool(rng, lens, kvh, d, page, 2.0, 3, dev)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    qd = _randn(rng, (b, kvh, g, d), 1.0, dev, torch.float16)
    gold = torch.stack([
        torch.softmax(qd[i].double() @ _gathered(kp, table[i], n)
                      .transpose(-1, -2) / math.sqrt(d), -1)
        @ _gathered(vp, table[i], n) for i, n in enumerate(lens)])
    n_rows = table.shape[1] * page
    kcp = kp[table.long()].reshape(b, n_rows, kvh, d).transpose(1, 2)
    vcp = vp[table.long()].reshape(b, n_rows, kvh, d).transpose(1, 2)
    args = (qd, kp, vp, table, kv_len)
    for tag in MODES_POLICIES:
        policy = get_policy(tag)
        for beta in (0.0, BETA):
            kw = dict(beta=beta, policy=policy)
            cases[("pasa_paged_decode/d32", f"{tag} beta {beta}")] = dict(
                run=lambda a=args, kw=kw: ops.pasa_paged_decode(*a, **kw),
                plain=lambda a=args, kw=kw, page=page:
                    dmod.paged_decode_plain(*a, block_kv=page, **kw),
                same=lambda a=(qd, kcp, vcp, kv_len), kw=kw, page=page:
                    ops.pasa_decode(*a, block_kv=page, **kw),
                gold=gold, tol=DECODE_TOL, rmse_max=RMSE_MAX)
    timing["pasa_paged_decode/d32"] = dict(q=qd, kp=kp, vp=vp, table=table,
                                           kv_len=kv_len, lens=lens)
    raw = lambda a=args: ops.pasa_paged_decode(*a, beta=BETA, policy=FP16)
    for dtype in QUANT_DTYPES:
        kq, vq, side, valid = _quantize_pool(kp, vp, table, lens, dtype)
        args_q = (qd, kq, vq, table, kv_len)
        quant[f"pasa_paged_decode/d32_{dtype}"] = dict(
            base="pasa_paged_decode/d32", dtype=dtype, raw=raw, gold=gold,
            tol=DECODE_TOL,
            rows=slice(None), pools=(kq, vq, side, valid),
            run=lambda policy, a=args_q, side=side: ops.pasa_paged_decode(
                *a, beta=BETA, policy=policy, **side),
            plain=lambda policy, a=args_q, side=side, page=page:
                dmod.paged_decode_plain(*a, beta=BETA, policy=policy,
                                        block_kv=page, **side))

    # paged prefill at head_dim 32 (H 4 over KVH 2, chunks of 64 at starts
    # 32 and 0, page 16) and 64 (phase 2's fixture)
    h, kvh, cs, page, starts = MODES_PREFILL
    for d, rows in ((32, (starts, [st + cs for st in starts])),
                    (64, PREFILL_ROWS)):
        if d == 64:
            h, kvh, cs, page = 28, 4, PREFILL_CHUNK, 128
        st_l, lens = rows
        b = len(st_l)
        kp, vp, table = _paged_pool(rng, lens, kvh, d, page, 2.0, 2, dev)
        if d == 64:
            table[3] = 0                      # the pad row: all-null table
        start = torch.tensor(st_l, dtype=torch.int32, device=dev)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        live_rows = [i for i, n in enumerate(lens) if n]
        qs = {BETA: _randn(rng, (b, h, cs, d), 1.0, dev, torch.float16),
              0.0: _randn(rng, (b, h, cs, d), 0.0, dev, torch.float16)}
        golds = {beta: _modes_prefill_gold(qq, kp, vp, table, st_l, lens,
                                           live_rows)
                 for beta, qq in qs.items()}
        name = f"pasa_paged_prefill/d{d}"
        for tag in MODES_POLICIES:
            policy = get_policy(tag)
            for beta, qq in qs.items():
                kw = dict(beta=beta, policy=policy)
                args = (qq, kp, vp, table, start, kv_len)
                cases[(name, f"{tag} beta {beta}")] = dict(
                    run=lambda a=args, kw=kw: ops.pasa_paged_prefill(*a, **kw),
                    plain=lambda a=args, kw=kw: pmod.paged_prefill_plain(
                        *a, **kw),
                    gold=golds[beta], tol=PREFILL_TOL, rmse_max=RMSE_MAX,
                    rows=live_rows, zero_rows=[
                        i for i in range(b) if i not in live_rows])
        timing[name] = dict(q=qs[BETA], kp=kp, vp=vp, table=table,
                            start=start, kv_len=kv_len, starts=st_l,
                            lens=lens)
        args = (qs[BETA], kp, vp, table, start, kv_len)
        raw = lambda a=args: ops.pasa_paged_prefill(*a, beta=BETA,
                                                    policy=FP16)
        for dtype in QUANT_DTYPES:
            kq, vq, side, valid = _quantize_pool(kp, vp, table, lens, dtype)
            args_q = (qs[BETA], kq, vq, table, start, kv_len)
            quant[f"{name}_{dtype}"] = dict(
                base=name, dtype=dtype, raw=raw, gold=golds[BETA],
                tol=PREFILL_TOL,
                rows=live_rows, pools=(kq, vq, side, valid),
                run=lambda policy, a=args_q, side=side:
                    ops.pasa_paged_prefill(*a, beta=BETA, policy=policy,
                                           **side),
                plain=lambda policy, a=args_q, side=side:
                    pmod.paged_prefill_plain(*a, beta=BETA, policy=policy,
                                             **side))
    return cases, quant, timing


def _modes_prefill_gold(q, kp, vp, table, starts, kv_lens, live_rows):
    """float64 causal attention of the live rows of a prefill case over
    the pool's K/V."""
    import torch

    _, h, cs, d = q.shape
    g = h // kp.shape[2]
    golds = []
    for i in live_rows:
        n = kv_lens[i]
        kk = _gathered(kp, table[i], n).repeat_interleave(g, 0)
        vv = _gathered(vp, table[i], n).repeat_interleave(g, 0)
        sc = q[i].double() @ kk.transpose(-1, -2) / math.sqrt(d)
        qpos = starts[i] + torch.arange(cs, device=q.device)[:, None]
        sc = sc.masked_fill(qpos < torch.arange(n, device=q.device)[None, :],
                            -math.inf)
        golds.append(torch.softmax(sc, -1) @ vv)
    return torch.stack(golds)


def _modes_timed(dev, name, t):
    """Kernel, plain and library ms of a phase 18 entry at the fp16 PASA
    policy (shift-KV: its entry's mode), and its bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.core.shifting import effective_invariance
    from repro_torch.kernels import ops

    kernel = name.partition("/")[0]
    if kernel == "pasa_attention":
        q, k, v = t["q"], t["k"], t["v"]
        amod = _kernel_module("pasa_attention")
        b, h, s, d = q.shape
        k_sh = ops.shift_kv(k, beta=BETA, policy=FP16)
        inva = effective_invariance(128, d, BETA, torch.float16)
        return dict(
            ms=_cuda_time_ms(lambda: amod.kernel_call(
                q, k_sh, v, beta=BETA, inva=inva, policy=FP16, causal=False,
                block_q=128, block_kv=128), 50),
            plain_ms=_cuda_time_ms(lambda: amod.attention_plain(
                q, k, v, beta=BETA, policy=FP16, block_kv=128), 3, warmup=1),
            library_ms=_cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q, k.repeat_interleave(h // k.shape[1], 1),
                v.repeat_interleave(h // k.shape[1], 1)), 50),
            **R.bound(*R.attention_cost(b, h, s, k.shape[1], s, d,
                                        causal=False)))
    if kernel == "shift_kv":
        smod = _kernel_module("shift_kv")
        k, m, kb, block, policy = (t[x] for x in ("k", "m", "kb", "block",
                                                   "policy"))
        op = policy.input_dtype
        return dict(
            ms=_cuda_time_ms(lambda: ops.shift_kv(
                k, beta=BETA, block_kv=block, policy=policy), 50),
            plain_ms=_cuda_time_ms(lambda: smod.shift_kv_plain(
                m, k.to(op), block, out_dtype=op), 20),
            library_ms=_cuda_time_ms(lambda: torch.matmul(m, kb), 50),
            **R.bound(*R.shift_kv_cost(k.numel(), k.element_size(), block,
                                       out_itemsize=op.itemsize)))
    if kernel == "pasa_decode":
        cmod = _kernel_module("pasa_decode")
        k, v, kv_len, lens = t["k"], t["v"], t["kv_len"], t["lens"]
        q = t["q"]
        b, kvh, g, d = q.shape
        mask = torch.arange(k.shape[2], device=dev)[None, :] < kv_len[:, None]
        ke, ve = (torch.nan_to_num(x.half()).repeat_interleave(g, 1)
                  for x in (k, v))
        return dict(
            ms=_cuda_time_ms(lambda: ops.pasa_decode(
                q, k, v, kv_len, beta=BETA, policy=FP16, block_kv=128), 50),
            walk_ms=_cuda_time_ms(lambda: cmod._walk_call(
                q, k, v, kv_len, beta=BETA, policy=FP16, block_kv=128), 50),
            plain_ms=_cuda_time_ms(lambda: cmod.decode_plain(
                q, k, v, kv_len, beta=BETA, policy=FP16, block_kv=128), 3,
                warmup=1),
            library_ms=_cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q.reshape(b, kvh * g, 1, d), ke, ve,
                attn_mask=mask[:, None, None, :]), 50),
            **R.bound(*R.decode_cost(b, kvh, g, d, lens)))
    if kernel == "pasa_paged_decode":
        dmod = _kernel_module("pasa_paged_decode")
        q, kp, vp, table, kv_len = (t[x] for x in ("q", "kp", "vp", "table",
                                                   "kv_len"))
        side = t.get("side", {})
        b, kvh, g, d = q.shape
        page = kp.shape[1]
        n = table.shape[1] * page
        kg, vg = (torch.nan_to_num(dmod._gather_dequant(
            x, side.get(f"{s}_scale"), side.get(f"{s}_shift"), table,
            torch.float16).reshape(b, n, kvh, d).movedim(1, 2))
            .repeat_interleave(g, 1) for s, x in (("k", kp), ("v", vp)))
        mask = torch.arange(n, device=dev)[None, :] < kv_len[:, None]
        return dict(
            ms=_cuda_time_ms(lambda: ops.pasa_paged_decode(
                q, kp, vp, table, kv_len, beta=BETA, policy=FP16, **side),
                50),
            plain_ms=_cuda_time_ms(lambda: dmod.paged_decode_plain(
                q, kp, vp, table, kv_len, beta=BETA, policy=FP16,
                block_kv=page, **side), 3, warmup=1),
            library_ms=_cuda_time_ms(lambda: F.scaled_dot_product_attention(
                q.reshape(b, kvh * g, 1, d), kg, vg,
                attn_mask=mask[:, None, None, :]), 50),
            **R.bound(*R.paged_decode_cost(
                b, kvh, g, d, t["lens"], table.numel(),
                kv_itemsize=kp.element_size(),
                page=page if side else None)))
    pmod = _kernel_module("pasa_paged_prefill")
    q, kp, vp, table, start, kv_len = (t[x] for x in (
        "q", "kp", "vp", "table", "start", "kv_len"))
    side = t.get("side", {})
    b, h, cs, d = q.shape
    kvh, page = kp.shape[2], kp.shape[1]
    n = table.shape[1] * page
    kg, vg = (torch.nan_to_num(_kernel_module("pasa_paged_decode")
                               ._gather_dequant(
        x, side.get(f"{s}_scale"), side.get(f"{s}_shift"), table,
        torch.float16).reshape(b, n, kvh, d).movedim(1, 2))
        .repeat_interleave(h // kvh, 1) for s, x in (("k", kp), ("v", vp)))
    col = torch.arange(n, device=dev)
    qpos = start[:, None] + torch.arange(cs, device=dev)[None, :]
    mask = (col[None, None, :] <= qpos[:, :, None]) & (
        col[None, None, :] < kv_len[:, None, None])
    return dict(
        ms=_cuda_time_ms(lambda: ops.pasa_paged_prefill(
            q, kp, vp, table, start, kv_len, beta=BETA, policy=FP16, **side),
            20),
        plain_ms=_cuda_time_ms(lambda: pmod.paged_prefill_plain(
            q, kp, vp, table, start, kv_len, beta=BETA, policy=FP16, **side),
            3, warmup=1),
        library_ms=_cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, kg, vg, attn_mask=mask[:, None]), 20),
        **R.bound(*R.paged_prefill_cost(
            b, h, cs, d, kvh, t["starts"], t["lens"], table.numel(),
            kv_itemsize=kp.element_size(), page=page if side else None)))


def phase_modes(dev):
    """Phase 18 (``--modes-only``: this phase alone): head_dim 32 in every
    kernel and head_dim 64 in paged prefill (``MODES_*``).  Every case is
    launched once through its op with every launch count set to 0 just
    before the pass and read just after; then each output is held to its
    plain version on the card (the kernel's bar of PERF.md §2), to float64
    (RMSE_MAX, ATTN_RMSE_MAX, SHIFT_RMSE_MAX; the 8-bit pools by
    ``_check_quant_policies``), contiguous decode to its walk and paged
    decode to contiguous decode bit for bit; stale pool bytes inert (a raw
    pool's NaN past kv_len and on unreferenced pages replaced by 1e4, an
    8-bit pool's ``_poison``).  Each entry is timed at the fp16 PASA
    policy beside its plain version and one library call, with its bound;
    ``launches`` is the pass's count of the entry's kernel over its
    ``/d32`` (``/d64``) modes.  Returns the kernels-line entries."""
    import torch

    from repro_torch.core.precision import FP16, get_policy
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cases, quant, timing = _modes_cases(dev)
    torch.cuda.synchronize()
    # the driven pass: every case once, the counts read just after
    ops.reset_launches()
    outs = {key: c["run"]() for key, c in cases.items()}
    for c in quant.values():
        c["outs"] = {tag: c["run"](get_policy(tag)) for tag in MODES_POLICIES}
    torch.cuda.synchronize()
    counts = {w.__name__: dict(w.launches_by_mode) for w in ops.WRAPPERS}

    errs, rmses, detail = {}, {}, {}
    for key, c in cases.items():
        name, label = key
        got, plain = outs[key], c["plain"]()
        torch.cuda.synchronize()
        if "same" in c and not torch.equal(got, c["same"]()):
            raise AssertionError(f"{name} ({label}): the kernels differ")
        if got.dtype != plain.dtype:
            raise AssertionError(f"{name} ({label}): output {got.dtype}")
        if any(got[i].any() for i in c.get("zero_rows", ())):
            raise AssertionError(f"{name} ({label}): a pad row is not zero")
        errs[name] = max(errs.get(name, 0.0), _close(
            f"{name} ({label})", got, plain, **c["tol"]))
        rows = c.get("rows", slice(None))
        r, rp = _rel_rmse(got[rows], c["gold"]), _rel_rmse(plain[rows],
                                                           c["gold"])
        held = (r <= c["rmse_ratio"] * rp if c.get("rmse_ratio")
                else r < c["rmse_max"] and rp < c["rmse_max"])
        if not held:
            raise AssertionError(f"{name} ({label}) RMSE {r:.4f} / plain "
                                 f"{rp:.4f}")
        rmses.setdefault(name, {})[label] = r
    # stale bytes of raw pools: NaN past kv_len and on unreferenced pages
    # replaced by 1e4, bit for bit the same outputs
    for name in ("pasa_paged_decode/d32", "pasa_paged_prefill/d32",
                 "pasa_paged_prefill/d64"):
        t = timing[name]
        junk = [torch.nan_to_num(x, nan=1e4) for x in (t["kp"], t["vp"])]
        if name == "pasa_paged_decode/d32":
            run = lambda kp, vp: ops.pasa_paged_decode(
                t["q"], kp, vp, t["table"], t["kv_len"], beta=BETA,
                policy=FP16)
        else:
            run = lambda kp, vp: ops.pasa_paged_prefill(
                t["q"], kp, vp, t["table"], t["start"], t["kv_len"],
                beta=BETA, policy=FP16)
        if not torch.equal(run(t["kp"], t["vp"]), run(*junk)):
            raise AssertionError(f"{name}: stale pool bytes changed the "
                                 f"output")
        detail.setdefault(name, {})["stale_bytes_inert"] = True
    for name, c in quant.items():
        outs_q = c["outs"]
        held, got = _check_quant_policies(
            name, lambda policy: outs_q[policy.name], c["plain"], c["gold"],
            c["raw"](), c["dtype"], c["tol"], rows=c["rows"])
        kq, vq, side, valid = c["pools"]
        kq2, vq2, side2 = _poison(kq, vq, side, valid)
        t = timing[c["base"]]
        if name.startswith("pasa_paged_decode"):
            dirty = ops.pasa_paged_decode(t["q"], kq2, vq2, t["table"],
                                          t["kv_len"], beta=BETA,
                                          policy=FP16, **side2)
        else:
            dirty = ops.pasa_paged_prefill(t["q"], kq2, vq2, t["table"],
                                           t["start"], t["kv_len"],
                                           beta=BETA, policy=FP16, **side2)
        if not torch.equal(dirty, got):
            raise AssertionError(f"{name}: debris past kv_len or dead-page "
                                 f"sidecars changed the output")
        held["debris_inert"] = True
        errs[name] = held["max_abs_err_fp16"]
        rmses[name] = {"fp16": held["rmse_fp16"]}
        detail[name] = held
        timing[name] = dict(t, kp=kq, vp=vq, side=side)
    check_s = time.perf_counter() - t0

    entries = []
    names = list(dict.fromkeys([key[0] for key in cases] + list(quant)))
    for name in names:
        kernel, _, tag = name.partition("/")
        width = tag.partition("_")[0]         # d32 / d64
        t = dict(timing.get(name) or timing[f"{kernel}/{width}"])
        if kernel == "pasa_decode":
            t.update(timing[f"pasa_decode/d32 g{MODES_DECODE_GROUPS[-1]}"])
        if kernel == "shift_kv":
            launches = counts["shift_kv"].get(t["mode"], 0)
        elif kernel == "pasa_attention":
            launches = sum(n for op in ("pasa_attention", "flash_attention")
                           for mode, n in counts[op].items()
                           if mode.endswith(f"/{width}"))
        else:     # the modes of the pool or cache the entry reads
            pool = str(t["kp"].dtype if "kp" in t else t["k"].dtype)
            launches = sum(n for mode, n in counts[kernel].items()
                           if mode.endswith(f"/{width}")
                           and mode.split("/")[1] == pool.split(".")[1])
        if not launches:
            raise AssertionError(f"{name} was not launched in phase 18")
        source, replaces = _kernel_source(name)
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=errs[name],
            rmse=max(rmses[name].values()), detail=detail.get(name, {}),
            **_modes_timed(dev, name, t)))
    print("phase 18 launches by mode: " + json.dumps(counts))
    print(f"phase 18: {time.perf_counter() - t0:.1f} s (checks "
          f"{check_s:.1f} s)")
    return entries


# ---- phase 19: every page size the reference serves -------------------

PAGES_DECODE = (1, 8, 16, 48, 128, 256)
PAGES_BLOCKS = (128, 256)
PAGES_DECODE_SHAPES = ((128, 4, 7), (64, 4, 8))   # head_dim, KVH, G
PAGES_PREFILL = (8, 16, 48, 256, 257, 300, 512, 1024)
PAGES_PREFILL_HEADS = (28, 4)   # qwen2-7b's H and KVH at head_dim 128
# pages over 256 rows (the 256-row tile in pieces) also at head_dim 64 and
# 32: (head_dim, H, KVH)
PAGES_WIDE = (257, 300, 512, 1024)
PAGES_WIDE_SHAPES = ((64, 16, 4), (32, 8, 2))
PAGES_POOLS = ("bf16", *QUANT_DTYPES)
# the paper's fp16 PASA, and FlashAttention-2 at the flash impl's policy
PAGES_MODES = (("fp16", BETA), ("bf16_fp32", 0.0))
PAGES_LAYERS = 8          # of qwen2-7b's 28: the page-16 serve's depth
PAGES_SERVE = 16          # the serve's page (block_kv stays 128)
PAGES_SERVE_WIDE = 512    # the wide page's serve (chunk 512, block 128)
PAGES_TIMED = (16, 8)     # the pages timed at the serve's call shapes
PAGES_ALONE = (0, 3)      # requests served alone beside the batch
PAGES_PREFILL_ROWS = ((0, 0, 0, 0), (512, 512, 300, 129))  # the first call


def _rows_to_pages(kc, vc, lens, page, rng, n_extra=2):
    """The rows of (B, S, KVH, D) K and V (NaN past each length) in a
    shuffled bf16 pool of ``page``-row pages, page 0 and ``n_extra``
    pages unreferenced and NaN.  Returns the pools (P, page, KVH, D), the
    table (B, max_pages) and the valid rows (P, page)."""
    import numpy as np
    import torch

    b, s, kvh, d = kc.shape
    n_pages = [math.ceil(max(n, 1) / page) for n in lens]
    total = 1 + sum(n_pages) + n_extra
    ids = rng.permutation(np.arange(1, total))
    table = np.zeros((b, max(n_pages)), np.int32)
    nxt = 0
    for i, npg in enumerate(n_pages):
        for j in range(npg):
            table[i, j] = ids[nxt]
            nxt += 1
    dev = kc.device
    table = torch.from_numpy(table).to(dev)
    # view row r of sequence i lands at row r % page of page table[i, r // page]
    rows = torch.arange(max(n_pages) * page, device=dev)
    pid = table.long()[:, rows // page]                    # (B, rows)
    live = rows[None, :] < torch.tensor([npg * page for npg in n_pages],
                                        device=dev)[:, None]
    kp = torch.full((total, page, kvh, d), float("nan"), dtype=torch.bfloat16,
                    device=dev)
    vp = kp.clone()
    valid = torch.zeros((total, page), dtype=torch.bool, device=dev)
    pad = lambda x: torch.nn.functional.pad(
        x.float(), (0, 0, 0, 0, 0, rows.numel() - s), value=float("nan")
    ).to(torch.bfloat16) if rows.numel() > s else x[:, :rows.numel()]
    kcp, vcp = pad(kc), pad(vc)
    slot = (rows % page)[None, :].expand_as(pid)
    kp[pid[live], slot[live]] = kcp[live]
    vp[pid[live], slot[live]] = vcp[live]
    lens_t = torch.tensor(list(lens), device=dev)
    inside = live & (rows[None, :] < lens_t[:, None])
    valid[pid[inside], slot[inside]] = True
    return kp, vp, table, valid


def _pool_kinds(kp, vp, valid):
    """{pool: (K, V, sidecars)}: the bf16 pool and the same rows quantized
    per page to each 8-bit dtype (valid rows only)."""
    from repro_torch.runtime.paged_cache import quantize_kv_page

    kinds = {"bf16": (kp, vp, {})}
    for dtype in QUANT_DTYPES:
        kq, ks, kh = quantize_kv_page(kp, valid, dtype)
        vq, vs, vh = quantize_kv_page(vp, valid, dtype)
        kinds[dtype] = (kq, vq, dict(k_scale=ks, k_shift=kh, v_scale=vs,
                                     v_shift=vh))
    return kinds


def _view_rows(kp, vp, side, table, dtype):
    """A pool's rows in page-table order as (B, KVH, n, D) K and V: a bf16
    pool's as stored, an 8-bit pool's dequantized as the kernels load them
    (f32 product and sum, one rounding to ``dtype``)."""
    dmod = _kernel_module("pasa_paged_decode")
    return [dmod._gather_dequant(x, side.get(f"{s}_scale"),
                                 side.get(f"{s}_shift"), table,
                                 dtype if side else x.dtype).transpose(1, 2)
            for s, x in (("k", kp), ("v", vp))]


def _junk(kp, vp, side, valid):
    """The pool with stale bytes: a bf16 pool's NaN rows (past kv_len,
    unreferenced pages) at 1e4; an 8-bit pool's ``_poison``."""
    import torch

    if not side:
        return [torch.nan_to_num(x, nan=1e4) for x in (kp, vp)] + [{}]
    return list(_poison(kp, vp, side, valid))


def _pages_cases(dev):
    """Phase 19's cases, {key: dict(run, check)} with key (kernel, page,
    label): paged decode at every page of PAGES_DECODE, block of
    PAGES_BLOCKS, head width, pool and mode (PAGES_MODES); paged prefill at
    PAGES_PREFILL (head_dim 128), and at PAGES_WIDE also at the head
    widths of PAGES_WIDE_SHAPES, from each pool in each mode.  ``run()``
    is one call of the op (a launch); ``check(out)`` holds it and returns
    its max abs error against the plain version.  Also returns the pairs
    of calls that must give the same bits: each (kernel, page, pool)
    clean and with stale bytes, and prefill in one chunk and in two."""
    import numpy as np
    import torch

    from repro_torch.core.precision import FP16, get_policy
    from repro_torch.kernels import ops
    cmod = _kernel_module("pasa_decode")
    dmod = _kernel_module("pasa_paged_decode")

    rng = np.random.default_rng(19)
    cases, pairs = {}, {}
    lens = SERVE_DECODE_KV
    kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
    b, s = len(lens), max(lens)
    for d, kvh, g in PAGES_DECODE_SHAPES:
        live = (torch.arange(s, device=dev)[None, :] < kvl[:, None])[
            ..., None, None]
        kc = torch.where(live, _randn(rng, (b, s, kvh, d), 2.0, dev,
                                      torch.float32), math.nan)
        vc = torch.where(live, _randn(rng, (b, s, kvh, d), 0.0, dev,
                                      torch.float32), math.nan)
        kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
        q = _randn(rng, (b, kvh, g, d), 1.0, dev, torch.float16)
        for page in PAGES_DECODE:
            kp, vp, table, valid = _rows_to_pages(kc, vc, lens, page, rng)
            for pool, (k_, v_, side) in _pool_kinds(kp, vp, valid).items():
                for tag, beta in PAGES_MODES:
                    policy = get_policy(tag)
                    for block in PAGES_BLOCKS:
                        kw = dict(beta=beta, policy=policy, block_kv=block)
                        args = (q, k_, v_, table, kvl)

                        def check(out, args=args, kw=kw, side=side,
                                  label=f"d{d} page {page} {pool} {tag} "
                                        f"block {block}"):
                            q_, k_, v_, table_, kvl_ = args
                            op = kw["policy"].input_dtype
                            kview, vview = _view_rows(k_, v_, side, table_, op)
                            qq = q_.to(op)
                            for other in (ops.pasa_decode,
                                          cmod._walk_call):
                                if not torch.equal(out, other(
                                        qq, kview, vview, kvl_, **kw)):
                                    raise AssertionError(
                                        f"pasa_paged_decode ({label}): "
                                        f"{other.__name__} differs")
                            return _close(
                                f"pasa_paged_decode ({label})", out,
                                dmod.paged_decode_plain(*args, **kw, **side),
                                **DECODE_TOL)
                        cases[("pasa_paged_decode", page,
                               f"d{d} {pool} {tag} block {block}")] = dict(
                            run=lambda args=args, kw=kw, side=side:
                                ops.pasa_paged_decode(*args, **kw, **side),
                            check=check)
                pairs[("pasa_paged_decode", page, f"d{d} {pool}")] = (
                    lambda k_=k_, v_=v_, side=side, valid=valid, table=table,
                    q=q, kvl=kvl: [
                        ops.pasa_paged_decode(q, kk, vv, table, kvl,
                                              beta=BETA, policy=FP16,
                                              block_kv=128, **sd)
                        for kk, vv, sd in ((k_, v_, side),
                                           _junk(k_, v_, side, valid))])

    # prefill: phase 2's rows (4 x 28 heads x 512 queries at starts 0, 512,
    # 1024 and a pad row), float64 gold on the unquantized rows; pages over
    # 256 rows also at the narrower heads of PAGES_WIDE_SHAPES
    starts, lens = PREFILL_ROWS
    shapes = [(PAGES_PREFILL_HEADS, 128, PAGES_PREFILL)] + [
        ((h, kvh), d, PAGES_WIDE) for d, h, kvh in PAGES_WIDE_SHAPES]
    for (h, kvh), d, pages in shapes:
        _pages_prefill_cases(dev, rng, cases, pairs, h, kvh, d, pages,
                             starts, lens)
    return cases, pairs


def _pages_prefill_cases(dev, rng, cases, pairs, h, kvh, d, pages, starts,
                         lens):
    """``_pages_cases``' paged prefill at head width ``d`` (``h`` query
    heads over ``kvh``), at each page of ``pages``, from each pool in
    each mode; the chunk-schedule pair cuts row 1 at the last page
    boundary at or below the chunk width (none where that is its end).
    Keys carry the head width unless it is 128."""
    import torch

    from repro_torch.core.precision import FP16, get_policy
    from repro_torch.kernels import ops
    pmod = _kernel_module("pasa_paged_prefill")

    cs = PREFILL_CHUNK
    b, s = len(lens), max(lens)
    kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    live = (torch.arange(s, device=dev)[None, :] < kvl[:, None])[..., None,
                                                                 None]
    kc = torch.where(live, _randn(rng, (b, s, kvh, d), 2.0, dev,
                                  torch.float32), math.nan).to(torch.bfloat16)
    vc = torch.where(live, _randn(rng, (b, s, kvh, d), 0.0, dev,
                                  torch.float32), math.nan).to(torch.bfloat16)
    q = _randn(rng, (b, h, cs, d), 1.0, dev, torch.float16)
    q_all = _randn(rng, (1, h, lens[1], d), 1.0, dev, torch.float16)
    live_rows = [i for i, n in enumerate(lens) if n]
    gold = _pages_prefill_gold(q, kc, vc, starts, lens, live_rows)
    width = "" if d == 128 else f"d{d} "
    raw_rmse = {}
    for page in pages:
        kp, vp, table, valid = _rows_to_pages(kc, vc, lens, page, rng)
        table[3] = 0                          # the pad row: all-null table
        for pool, (k_, v_, side) in _pool_kinds(kp, vp, valid).items():
            for tag, beta in PAGES_MODES:
                policy = get_policy(tag)
                kw = dict(beta=beta, policy=policy)
                args = (q, k_, v_, table, st, kvl)

                def check(out, args=args, kw=kw, side=side, pool=pool,
                          key=(page, tag),
                          label=f"page {page} {width}{pool} {tag}"):
                    name = f"pasa_paged_prefill ({label})"
                    plain = pmod.paged_prefill_plain(*args, **kw, **side)
                    err = _close(name, out, plain, **PREFILL_TOL)
                    if out[3].any():
                        raise AssertionError(f"{name}: the pad row is not 0")
                    r, rp = (_rel_rmse(x[live_rows], gold)
                             for x in (out, plain))
                    if pool == "bf16":
                        raw_rmse[key] = r
                        limit = RMSE_MAX
                    else:
                        limit = max(2.0 * raw_rmse[key],
                                    QUANT_RMSE_BOUND[pool])
                    if not (r < limit and rp < limit):
                        raise AssertionError(f"{name}: RMSE {r:.4f} / plain "
                                             f"{rp:.4f} >= {limit:.4f}")
                    return err
                cases[("pasa_paged_prefill", page,
                       f"{width}{pool} {tag}")] = dict(
                    run=lambda args=args, kw=kw, side=side:
                        ops.pasa_paged_prefill(*args, **kw, **side),
                    check=check)
            pairs[("pasa_paged_prefill", page, f"{width}{pool}")] = (
                lambda k_=k_, v_=v_, side=side, valid=valid, table=table: [
                    ops.pasa_paged_prefill(q, kk, vv, table, st, kvl,
                                           beta=BETA, policy=FP16, **sd)
                    for kk, vv, sd in ((k_, v_, side),
                                       _junk(k_, v_, side, valid))])
            # the chunk schedule: row 1's positions (1,024) in one chunk,
            # or in two cut at the last page boundary at or below the chunk
            # width (512)
            cut = max(cs // page, 1) * page
            if cut >= lens[1]:
                continue
            one = lambda c0, c1, k_=k_, v_=v_, side=side, table=table: (
                ops.pasa_paged_prefill(
                    q_all[:, :, c0:c1], k_, v_, table[1:2],
                    torch.tensor([c0], dtype=torch.int32, device=dev),
                    torch.tensor([c1], dtype=torch.int32, device=dev),
                    beta=BETA, policy=FP16, **side))
            pairs[("chunks", page, f"{width}{pool}")] = (
                lambda one=one, cut=cut: [
                    one(0, lens[1]),
                    torch.cat([one(0, cut), one(cut, lens[1])], 2)])


def _pages_prefill_gold(q, kc, vc, starts, lens, live_rows):
    """float64 causal attention of the live rows of the prefill case over
    the (B, S, KVH, D) rows."""
    import torch

    _, h, cs, d = q.shape
    g = h // kc.shape[2]
    golds = []
    for i in live_rows:
        n = lens[i]
        kk = kc[i, :n].movedim(1, 0).double().repeat_interleave(g, 0)
        vv = vc[i, :n].movedim(1, 0).double().repeat_interleave(g, 0)
        sc = q[i].double() @ kk.transpose(-1, -2) / math.sqrt(d)
        qpos = starts[i] + torch.arange(cs, device=q.device)[:, None]
        sc = sc.masked_fill(qpos < torch.arange(n, device=q.device)[None, :],
                            -math.inf)
        golds.append(torch.softmax(sc, -1) @ vv)
    return torch.stack(golds)


def check_pages(dev):
    """Phase 19's kernel checks: every case of ``_pages_cases`` launched
    once, page by page, with every launch count set to 0 just before each
    page's pass and read just after; then each held (paged decode bit for
    bit equal to contiguous decode and its walk on the same rows, and
    within the decode bars of its plain version; paged prefill within the
    prefill bars of its plain version and the float64 RMSE bars, a pad
    row of zeros), stale bytes inert and the prefill bit-invariant to a
    page-aligned chunk cut.  Returns {page: launch counts by op and mode}
    and the report."""
    import torch

    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    cases, pairs = _pages_cases(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts, outs = {}, {}
    for page in sorted({key[1] for key in cases}):
        ops.reset_launches()
        outs.update({key: c["run"]() for key, c in cases.items()
                     if key[1] == page})
        torch.cuda.synchronize()
        counts[page] = {w.__name__: dict(w.launches_by_mode)
                        for w in ops.WRAPPERS if w.launches}
    errs = {}
    for key, c in cases.items():
        name = f"{key[0]}/page{key[1]}"
        errs[name] = max(errs.get(name, 0.0), c["check"](outs[key]))
    for key, fn in pairs.items():
        a, b = fn()
        if not torch.equal(a, b):
            raise AssertionError(f"{key}: stale bytes or the chunk schedule "
                                 f"changed the output")
    report = dict(cases=len(cases), stale_and_chunk_checks=len(pairs),
                  max_abs_err=errs, fixtures_s=build_s,
                  checks_s=time.perf_counter() - t0 - build_s)
    return counts, report


@contextlib.contextmanager
def _plain_paged(at=None):
    """``ops.pasa_paged_prefill`` and ``ops.pasa_paged_decode`` replaced by
    their plain versions (on any device) inside the block, at the policy
    ``at`` if one is given: the paged route then runs the plain PyTorch
    attention on the card."""
    from repro_torch.kernels import ops
    dmod = _kernel_module("pasa_paged_decode")
    pmod = _kernel_module("pasa_paged_prefill")

    ops_before = ops.pasa_paged_prefill, ops.pasa_paged_decode
    ops.pasa_paged_prefill = lambda *a, beta, policy, **side: \
        pmod.paged_prefill_plain(*a, beta=beta, policy=at or policy, **side)
    ops.pasa_paged_decode = lambda *a, beta, policy, block_kv, **side: \
        dmod.paged_decode_plain(*a, beta=beta, policy=at or policy,
                                block_kv=block_kv, **side)
    try:
        yield
    finally:
        ops.pasa_paged_prefill, ops.pasa_paged_decode = ops_before


def _depth_cut(bundle, params, layers):
    """The bundle's model with its first ``layers`` layers (the same
    weights: views of the stacked blocks)."""
    import dataclasses

    from repro_torch.models.model_zoo import build

    cut = build(dataclasses.replace(bundle.cfg, n_layers=layers))
    blocks = lambda t: {k: blocks(v) if isinstance(v, dict) else v[:layers]
                        for k, v in t.items()}
    return cut, dict(params, blocks=blocks(params["blocks"]))


def _paged_first_step(dev, bundle, params, cache_dtype, page):
    """The paged route's first call (4 rows x 512 queries at start 0, the
    serve's prompts) from a fresh ``page``-row pool, held by
    ``_first_step_gaps`` against the plain paged versions at
    DENSE_LOGIT_ATOL."""
    import numpy as np
    import torch

    cfg = bundle.cfg
    prompts, _ = _paged_workload(cfg, cache_dtype)
    lens = [min(len(p), PREFILL_CHUNK) for p in prompts]
    toks = torch.zeros((len(prompts), PREFILL_CHUNK), dtype=torch.int32)
    for i, (p, n) in enumerate(zip(prompts, lens)):
        toks[i, :n] = torch.tensor(p[:n])
    n_pages = PREFILL_CHUNK // page
    table = (torch.arange(len(prompts) * n_pages, dtype=torch.int32)
             .reshape(len(prompts), n_pages) + 1).to(dev)
    ints = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    first = lambda: bundle.paged_prefill_step(
        params, toks.to(dev), ints([0] * len(lens)), ints(lens),
        ints([n - 1 for n in lens]),
        bundle.init_paged_cache(1 + table.numel(), page, cache_dtype,
                                device=dev), table)[0]
    rep, _ = _first_step_gaps(first, f"page {page} {cache_dtype}",
                              DENSE_LOGIT_ATOL, plain_ops=_plain_paged)
    return rep


def serve_chunks(dev, bundle, params, cache_dtype, page):
    """The engine's chunk schedule at ``page``-row pages: phase 3's
    workload with prefill chunks of ``page`` rows and of twice that, every
    launch counted; the greedy streams equal (the paged prefill is
    bit-invariant to page-aligned chunk boundaries, and a decode row to
    its batch).  Returns the report."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import ServeEngine

    finite = []
    bundle = _finite_bundle(bundle, finite)
    prompts, kw = _paged_workload(bundle.cfg, cache_dtype, page)
    streams, calls = {}, {}
    for chunk in (page, 2 * page):
        ops.reset_launches()
        eng = ServeEngine(bundle, params, **dict(kw, prefill_chunk=chunk))
        reqs = [eng.submit(p, SERVE_GEN) for p in prompts]
        _drive(eng)
        _check_engine_launches(f"serve_chunks_{cache_dtype}", eng,
                               cache_dtype)
        streams[chunk] = [r.generated for r in reqs]
        calls[chunk] = eng.prefill_calls
        del eng
    _all_finite(f"serve_chunks_{cache_dtype}", finite)
    if streams[page] != streams[2 * page]:
        raise AssertionError(f"serve_chunks_{cache_dtype}: chunks of {page} "
                             f"and {2 * page} rows give other streams")
    return dict(cache_dtype=cache_dtype, page=page, chunks=list(calls),
                prefill_calls=list(calls.values()), streams_equal=True)


def serve_pages(dev, bundle, params):
    """qwen2-7b at full width with its depth cut to PAGES_LAYERS, block_kv
    128: phase 3's workload through the engine at page PAGES_SERVE, at
    page 128 and at page PAGES_SERVE_WIDE, from a bf16 and an int8 pool
    (requests PAGES_ALONE alone == batched, every launch counted, tok/s,
    TTFT and decode ms side by side); the prefix cache at pages
    PAGES_SERVE and PAGES_SERVE_WIDE (hits == cold); the chunk schedule at
    page PAGES_SERVE_WIDE; the first step at both pages within the plain
    versions' bars.  Returns the report."""
    import torch

    cut, cut_params = _depth_cut(bundle, params, PAGES_LAYERS)
    rep = {}
    for dtype in ("bf16", "int8"):
        for page in (PAGES_SERVE, 128, PAGES_SERVE_WIDE):
            rep[f"page{page}_{dtype}"] = serve(
                dev, cut, cut_params, cache_dtype=dtype, alone=PAGES_ALONE,
                page=page)
        for page in (PAGES_SERVE, PAGES_SERVE_WIDE):
            rep[f"prefix_page{page}_{dtype}"] = serve_prefix(
                dev, cut, cut_params, dtype, page=page)
            rep[f"first_step_page{page}_{dtype}"] = _paged_first_step(
                dev, cut, cut_params, dtype, page)
        rep[f"chunks_page{PAGES_SERVE_WIDE}_{dtype}"] = serve_chunks(
            dev, cut, cut_params, dtype, PAGES_SERVE_WIDE)
    del cut_params
    torch.cuda.empty_cache()
    return rep


def _pages_timed(dev, page, pool, kernel):
    """Kernel, plain and library (SDPA) ms of a paged kernel at a serve's
    call shape (decode: batch 4 at kv 1002 / 519 / 302 / 131; prefill: the
    first call, 4 rows x 512 queries at start 0 of prompts 1000 / 517 /
    300 / 129), qwen2-7b's heads, ``page``-row pages of ``pool``, fp16
    PASA (decode at block 128), and the bound of this run's data."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.precision import FP16
    from repro_torch.kernels import ops
    dmod = _kernel_module("pasa_paged_decode")
    pmod = _kernel_module("pasa_paged_prefill")

    rng = np.random.default_rng(20 + page)
    (h, kvh), d = PAGES_PREFILL_HEADS, 128
    if kernel == "pasa_paged_decode":
        starts, lens = None, SERVE_DECODE_KV
    else:
        starts, lens = PAGES_PREFILL_ROWS
    b, s = len(lens), max(lens)
    kc = _randn(rng, (b, s, kvh, d), 2.0, dev, torch.bfloat16)
    vc = _randn(rng, (b, s, kvh, d), 0.0, dev, torch.bfloat16)
    kp, vp, table, valid = _rows_to_pages(kc, vc, lens, page, rng)
    k_, v_, side = _pool_kinds(kp, vp, valid)[pool]
    kvl = torch.tensor(lens, dtype=torch.int32, device=dev)
    kview, vview = (x.to(torch.float16).nan_to_num()
                    .repeat_interleave(h // kvh, 1)
                    for x in _view_rows(k_, v_, side, table, torch.float16))
    col = torch.arange(kview.shape[2], device=dev)
    item = k_.element_size()
    if kernel == "pasa_paged_decode":
        q = _randn(rng, (b, kvh, h // kvh, d), 1.0, dev, torch.float16)
        args = (q, k_, v_, table, kvl)
        kw = dict(beta=BETA, policy=FP16, block_kv=128, **side)
        run = lambda: ops.pasa_paged_decode(*args, **kw)
        plain = lambda: dmod.paged_decode_plain(*args, **kw)
        mask = (col[None, :] < kvl[:, None])[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(
            q.reshape(b, h, 1, d), kview, vview, attn_mask=mask)
        cost = R.paged_decode_cost(b, kvh, h // kvh, d, lens, table.numel(),
                                   kv_itemsize=item,
                                   page=page if side else None)
        iters = 50
    else:
        q = _randn(rng, (b, h, PREFILL_CHUNK, d), 1.0, dev, torch.float16)
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        args = (q, k_, v_, table, st, kvl)
        kw = dict(beta=BETA, policy=FP16, **side)
        run = lambda: ops.pasa_paged_prefill(*args, **kw)
        plain = lambda: pmod.paged_prefill_plain(*args, **kw)
        qpos = st[:, None] + torch.arange(PREFILL_CHUNK, device=dev)[None, :]
        mask = (col[None, None, :] <= qpos[:, :, None]) & (
            col[None, None, :] < kvl[:, None, None])
        lib = lambda: F.scaled_dot_product_attention(q, kview, vview,
                                                     attn_mask=mask[:, None])
        cost = R.paged_prefill_cost(b, h, PREFILL_CHUNK, d, kvh, starts, lens,
                                    table.numel(), kv_itemsize=item,
                                    page=page if side else None)
        iters = 20
    out = run()
    err = _close(f"{kernel} page {page} {pool} (serve shape)", out, plain(),
                 **(DECODE_TOL if kernel == "pasa_paged_decode"
                    else PREFILL_TOL))
    return dict(ms=_cuda_time_ms(run, iters),
                plain_ms=_cuda_time_ms(plain, 3, warmup=1),
                library_ms=_cuda_time_ms(lib, iters), serve_shape_err=err,
                **R.bound(*cost))


def phase_pages(dev, bundle=None, params=None):
    """Phase 19 (``--pages-only``: this phase alone, the serving weights
    built at its depth): ``check_pages``, ``serve_pages`` and both paged
    kernels timed at the serve's call shapes at pages PAGES_TIMED.
    Returns the kernels-line entries: each paged kernel at page
    PAGES_SERVE from a bf16 and an int8 pool (the page-16 serves'
    launches), at page 8 and paged prefill at page 256 (the 256-row tile
    of ``pasa_paged_prefill_wide.cu``; both with check_pages' launches at
    that page), and paged prefill at page PAGES_SERVE_WIDE from both pools
    (the page-512 serves' launches; that tile in pieces)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    t0 = time.perf_counter()
    counts, rep = check_pages(dev)
    print("pages_kernels: " + json.dumps(rep))
    if bundle is None:
        import dataclasses

        bundle = build(dataclasses.replace(get_config("qwen2-7b"),
                                           n_layers=PAGES_LAYERS))
        params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    serves = serve_pages(dev, bundle, params)
    for tag, r in serves.items():
        print(f"serve_pages_{tag}: " + json.dumps(r))
    entries = []
    served = (PAGES_SERVE, PAGES_SERVE_WIDE)
    for name in ("pasa_paged_decode", "pasa_paged_prefill"):
        for page, pool in ((PAGES_SERVE, "bf16"), (PAGES_SERVE, "int8"),
                           (8, "bf16"), (256, "bf16"),
                           (PAGES_SERVE_WIDE, "bf16"),
                           (PAGES_SERVE_WIDE, "int8")):
            if name == "pasa_paged_decode" and page > 128:
                continue
            tag = f"page{page}" + ("" if pool == "bf16" else f"_{pool}")
            source, replaces = _kernel_source(f"{name}/{tag}")
            if page in served:
                launches = serves[f"page{page}_{pool}"]["launches"][name]
            else:
                launches = sum(counts[page].get(name, {}).values())
            if not launches:
                raise AssertionError(f"{name}/{tag} was not launched")
            entry = dict(
                name=f"{name}/{tag}", route="cuda", source=source,
                replaces=replaces, launches=launches,
                max_abs_err=rep["max_abs_err"][f"{name}/page{page}"],
                **_pages_timed(dev, page, pool, name))
            # page 128 at the same call, beside it (the wide page: and
            # page 1024)
            if page in served:
                entry["detail"] = {}
                for other in (128, 1024) if page > 256 else (128,):
                    at = _pages_timed(dev, other, pool, name)
                    entry["detail"].update(
                        {f"{key}_page{other}": at[key] for key in
                         ("ms", "plain_ms", "library_ms", "bound_ms")})
            entries.append(entry)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s")
    return entries


# ---- phase 20: the algebraic-shift dense attention ------------------------

ALG_LAYERS = 8            # of qwen2-7b's 28: the algebraic dense serve's depth
ALG_ALONE = (0, 3)        # requests served alone beside the batch
ALG_SHIFT_SHAPES = ((4, 4, 1024, 128), (4, 4, 1024, 64), (4, 4, 1024, 32))


def _algebraic(cfg):
    """``cfg`` with ``attention.use_gemm_shift`` off (the reference's
    algebraic shift)."""
    import dataclasses

    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, use_gemm_shift=False))


def check_algebraic_shift(dev):
    """The shift kernel's algebraic mode (``gemm_shift=False``) in each
    of its key / operand modes at the dense prefill's keys (4, 4, 1024,
    128) and at head widths 64 and 32, blocks 128 and 64, bf16 (B, S,
    KVH, D) keys of mean 5 read through strides (fp16 in the fp16-keys
    mode): each against its plain version (SHIFT_TOL) and within relative
    RMSE SHIFT_RMSE_MAX of the float64 algebraic shift.  Returns the
    path's entry (bf16 keys, fp16 operands, block 128, head_dim 128),
    timed beside torch.matmul(M, K blocks) (the same function as the
    GEMM) and the bytes bound, every mode's error in its detail."""
    import numpy as np
    import torch

    from repro_torch.core.precision import BF16_FP32, FP16
    from repro_torch.core.shifting import shift_kv_reference
    from repro_torch.kernels import ops
    mod = _kernel_module("shift_kv")

    rng = np.random.default_rng(20)
    detail, main = {}, None
    for b, kvh, s, d in ALG_SHIFT_SHAPES:
        keys = _randn(rng, (b, s, kvh, d), 5.0, dev, torch.float32)
        for block in (128, 64):
            for kdt, policy in ((torch.bfloat16, FP16), (torch.float16, FP16),
                                (torch.bfloat16, BF16_FP32)):
                op = policy.input_dtype
                k = keys.to(kdt).transpose(1, 2)
                run = lambda k=k, block=block, policy=policy: ops.shift_kv(
                    k, beta=BETA, block_kv=block, policy=policy,
                    gemm_shift=False)
                plain_of = lambda k=k, block=block, policy=policy: \
                    mod.shift_kv_mean_plain(k, BETA, block, policy)
                got, plain = run(), plain_of()
                torch.cuda.synchronize()
                mode = mod.mode_name(kdt, op, block, d, gemm_shift=False)
                name = f"shift_kv ({mode})"
                err = _close(name, got, plain, **SHIFT_TOL)
                ref = shift_kv_reference(k.to(op), d, BETA, block)
                rmse, rmse_plain = _rel_rmse(got, ref), _rel_rmse(plain, ref)
                if not (rmse < SHIFT_RMSE_MAX and rmse_plain < SHIFT_RMSE_MAX):
                    raise AssertionError(f"{name} RMSE {rmse:.2e} / plain "
                                         f"{rmse_plain:.2e} vs float64")
                detail[mode] = dict(max_abs_err=err, rmse=rmse,
                                    differing=int((got != plain).sum()),
                                    of=got.numel())
                if main is None:
                    m = mod.device_matrix(block, d, BETA, op, dev)
                    kb = k.to(op).contiguous().reshape(b, kvh, s // block,
                                                       block, d)
                    nbytes, flops = R.shift_kv_cost(
                        k.numel(), k.element_size(), block,
                        out_itemsize=op.itemsize, gemm_shift=False)
                    main = dict(
                        name="shift_kv/algebraic", mode=mode, route="cuda",
                        source="src/repro_torch/kernels/csrc/shift_kv.cu",
                        replaces="src/repro/kernels/shift_kv.py:48",
                        ms=_cuda_time_ms(run, 50),
                        plain_ms=_cuda_time_ms(plain_of, 20),
                        library_ms=_cuda_time_ms(
                            lambda m=m, kb=kb: torch.matmul(m, kb), 50),
                        **R.bound(nbytes, flops))
    main.update(max_abs_err=max(x["max_abs_err"] for x in detail.values()),
                rmse=max(x["rmse"] for x in detail.values()), detail=detail)
    return main


def check_algebraic_attention(dev):
    """``ops.pasa_attention(..., gemm_shift=False)`` - the shift kernel's
    algebraic mode, then the attention kernel on its K' at the ideal
    invariance beta / (1 - beta) - against the plain
    ``blocked_attention(use_gemm_shift=False)`` under the four policies:
    causal at the dense prefill's shape ATTN_SHAPE and not causal with
    the column limit at whisper's encoder shape (``_hd64_cases``' encoder:
    1,500 valid of 1,536 rows, the rest zero), queries of mean 0 and keys
    of mean 2 (check_attention's held fixture).  Each within
    ATTN_CAUSAL_TOL / ATTN_TOL of the plain version on the real rows, and
    within relative RMSE ATTN_RMSE_MAX of float64 attention (bf16_fp32:
    no more than BF16_PASA_RMSE_RATIO x the plain version's).  Timed at
    the causal call at fp16: the attention kernel alone on the algebraic
    K', the plain version (with its shift) and SDPA on K'.  Returns the
    entry."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.beta import ideal_invariance
    from repro_torch.core.precision import FP16, get_policy
    from repro_torch.kernels import ops
    mod = _kernel_module("pasa_attention")

    rng = np.random.default_rng(21)
    b, h, kvh, s, d = ATTN_SHAPE
    causal_case = (_randn(rng, (b, h, s, d), 0.0, dev, torch.float16),
                   _randn(rng, (b, kvh, s, d), 2.0, dev, torch.float16),
                   _randn(rng, (b, kvh, s, d), 0.0, dev, torch.float16),
                   None, True, s)
    q, k, v, valid, _, _ = _hd64_cases(rng, dev)["encoder"]
    cases = {"causal": causal_case, "encoder": (q, k, v, valid, False, valid)}
    errs, rmse = {}, {}
    for case, (q, k, v, valid, causal, n) in cases.items():
        gold = _gold_attention(q[:, :, :n], k[:, :, :n], v[:, :, :n], causal)
        tol = ATTN_CAUSAL_TOL if causal else ATTN_TOL
        for tag in ("fp16", "fp16_fp32", "fp32", "bf16_fp32"):
            kw = dict(beta=BETA, policy=get_policy(tag), causal=causal,
                      kv_valid=valid, gemm_shift=False)
            got = ops.pasa_attention(q, k, v, **kw)
            plain = mod.attention_plain(q, k, v, block_kv=128, **kw)
            torch.cuda.synchronize()
            label = f"pasa_attention/algebraic ({case}, {tag})"
            errs[f"{case} {tag}"] = _close(label, got[:, :, :n],
                                           plain[:, :, :n], **tol)
            r = _rel_rmse(got[:, :, :n], gold)
            rp = _rel_rmse(plain[:, :, :n], gold)
            held = (r <= BF16_PASA_RMSE_RATIO * rp if tag == "bf16_fp32"
                    else r < ATTN_RMSE_MAX and rp < ATTN_RMSE_MAX)
            if not held:
                raise AssertionError(f"{label} RMSE {r:.4f} / plain {rp:.4f}")
            rmse[f"{case} {tag}"], rmse[f"{case} {tag} plain"] = r, rp
        del gold
    q, k, v = causal_case[:3]
    k_sh = ops.shift_kv(k, beta=BETA, policy=FP16, gemm_shift=False)
    ms = _cuda_time_ms(lambda: mod.kernel_call(
        q, k_sh, v, beta=BETA, inva=ideal_invariance(BETA), policy=FP16,
        causal=True, block_q=128, block_kv=128), 20)
    plain_ms = _cuda_time_ms(lambda: mod.attention_plain(
        q, k, v, beta=BETA, policy=FP16, block_kv=128, causal=True,
        gemm_shift=False), 3, warmup=1)
    ke, ve = (x.repeat_interleave(h // kvh, 1) for x in (k_sh, v))
    lib_ms = _cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q, ke, ve, is_causal=True), 20)
    source, replaces = KERNEL_FILES["pasa_attention"]
    return dict(
        name="pasa_attention/algebraic", route="cuda", source=source,
        replaces=replaces, max_abs_err=max(errs.values()),
        rmse=rmse["causal fp16"], detail=dict(max_abs_err=errs, rmse=rmse),
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        **R.bound(*R.attention_cost(b, h, s, kvh, s, d, causal=True)))


def serve_algebraic(dev, bundle, params):
    """qwen2-7b at full width with its depth cut to ALG_LAYERS and
    ``use_gemm_shift=False``: serve_dense's workload (requests ALG_ALONE
    alone == batched, every launch counted: the shift kernel ALG_LAYERS
    times in its algebraic mode), and the first step's logits held by
    ``_first_step_gaps`` (within DENSE_LOGIT_ATOL of the plain versions
    and no farther than DENSE_FP32_RATIO x their distance from fp32).
    Returns the report."""
    import torch

    from repro_torch.models.model_zoo import build
    smod = _kernel_module("shift_kv")

    cut, cut_params = _depth_cut(bundle, params, ALG_LAYERS)
    alg = build(_algebraic(cut.cfg))
    rep = serve_dense(dev, alg, cut_params, alone=ALG_ALONE)
    mode = smod.mode_name(torch.bfloat16, torch.float16, 128,
                          alg.cfg.head_dim, gemm_shift=False)
    if rep["shift_kv_launches_by_mode"] != {mode: ALG_LAYERS}:
        raise AssertionError(f"serve_dense_algebraic: shift launches "
                             f"{rep['shift_kv_launches_by_mode']} != "
                             f"{{{mode!r}: {ALG_LAYERS}}}")
    gaps, _ = dense_first_step(dev, alg, cut_params)
    rep.update(gaps, shift_mode=mode)
    del cut_params
    torch.cuda.empty_cache()
    return rep


def train_algebraic(dev):
    """Phase 15's configuration (TRAIN_ARCH at TRAIN_LAYERS, remat on,
    random fp32 parameters from seed 0, the DataPipeline's first batch)
    with ``use_gemm_shift=False``: one step's loss and gradients through
    the kernels against the whole-plain path, both against it at fp32
    (``_grads_vs_plain``), the kernels' pass launching the shift kernel
    (its algebraic mode) and the attention kernel 2 x TRAIN_LAYERS times
    (each layer's forward and its remat recompute), no other kernel.
    Returns the report."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import batch_to_device
    from repro_torch.models.model_zoo import build

    cfg = _algebraic(dataclasses.replace(get_config(TRAIN_ARCH),
                                         n_layers=TRAIN_LAYERS))
    if not cfg.remat:
        raise AssertionError("the training config has remat off")
    bundle = build(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev,
                         dtype=cfg.torch_param_dtype())
    pipe = DataPipeline(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        vocab=cfg.vocab_size, seed=0)
    batch = batch_to_device(next(pipe), dev)
    pipe.close()
    rep, _, launches = _grads_vs_plain(bundle, params, batch,
                                       "train_algebraic")
    want = 2 * cfg.n_layers
    counts = {name: sum(by_mode.values()) for name, by_mode in launches.items()}
    if counts != {"shift_kv": want, "pasa_attention": want} or not all(
            "algebraic" in mode for mode in launches["shift_kv"]):
        raise AssertionError(f"train_algebraic: launches {launches}")
    rep.update(layers=cfg.n_layers, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               launches=counts, launches_by_mode=launches)
    del params, batch
    torch.cuda.empty_cache()
    return rep


def phase_algebraic(dev, bundle=None, params=None):
    """Phase 20 (``--algebraic-only``: this phase alone, the serving
    weights built at its depth): ``check_algebraic_shift``,
    ``check_algebraic_attention``, ``serve_algebraic`` (driven with the
    launch counts set to 0 just before it) and ``train_algebraic``.
    Returns the kernels-line entries ``shift_kv/algebraic`` and
    ``pasa_attention/algebraic``, each with the algebraic serve's launches
    (the training pass's in its detail)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build

    t0 = time.perf_counter()
    shift, attn = check_algebraic_shift(dev), check_algebraic_attention(dev)
    if bundle is None:
        bundle = build(dataclasses.replace(get_config("qwen2-7b"),
                                           n_layers=ALG_LAYERS))
        params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    rep = serve_algebraic(dev, bundle, params)
    print("serve_dense_algebraic: " + json.dumps(rep))
    rep_train = train_algebraic(dev)
    print("train_algebraic: " + json.dumps(rep_train))
    shift["detail"]["mode"] = shift.pop("mode")
    shift["launches"] = rep["shift_kv_launches_by_mode"][rep["shift_mode"]]
    attn["launches"] = rep["launches"]["pasa_attention"]
    for k in (shift, attn):
        name = k["name"].partition("/")[0]
        k["detail"]["launches_train_step"] = rep_train["launches"][name]
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched")
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")
    return [shift, attn]


def phase_tools(dev, bundle=None, params=None, parts=("decode", "train")):
    """Phase 17 (``--tools-only``: both parts, the serving weights built
    here): the readings printed beside the card's name and power limit."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    t0 = time.perf_counter()
    if "decode" in parts:
        if bundle is None:
            bundle, params, _ = build_model(dev)
        rep = tools_decode(dev, bundle, params)
        print(f"tools_decode ({smi}): " + json.dumps(rep))
        del bundle, params
        torch.cuda.empty_cache()
    if "train" in parts:
        print(f"tools_train ({smi}): " + json.dumps(tools_train(dev)))
    print(f"phase 17 ({', '.join(parts)}): {time.perf_counter() - t0:.1f} s")


def _print_entry(k) -> None:
    """A phase's kernel entry on one line, its detail on the next."""
    rmse = f", rmse {k['rmse']:.2e}" if "rmse" in k else ""
    print(f"{k['name']}: launches {k['launches']}, max_abs_err "
          f"{k['max_abs_err']:.3e}{rmse}, {k['ms']:.4f} ms "
          f"vs plain {k['plain_ms']:.3f} ms, library {k['library_ms']:.4f} "
          f"ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']})"
          + (f"; its walk {k['walk_ms']:.4f} ms" if "walk_ms" in k else ""))
    if k.get("detail"):
        print(f"  {k['name']} detail: {json.dumps(k['detail'])}")


def main(argv=None) -> int:
    """The whole smoke; ``--train-only`` / ``--multi-only`` /
    ``--tools-only`` / ``--modes-only`` / ``--pages-only`` /
    ``--algebraic-only``: the build of the kernels phase 15 / 16 / 17 / 18
    / 19 / 20 runs, and that phase alone, with no result line."""
    import torch

    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--train-only"], ["--multi-only"],
                    ["--multi-only", "--half-batch"], ["--tools-only"],
                    ["--modes-only"], ["--pages-only"],
                    ["--algebraic-only"]):
        print(f"usage: chip_smoke.py [--train-only | --multi-only "
              f"[--half-batch] | --tools-only | --modes-only | "
              f"--pages-only | --algebraic-only], got {argv}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.precision import get_policy
    from repro_torch.kernels import _build
    from repro_torch.kernels.pasa_paged_decode import mode_name

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    built = _build.build(
        None if argv in ([], ["--modes-only"], ["--pages-only"])
        else ("shift_kv", "pasa_attention", "pasa_decode")
        if argv in (["--tools-only"], ["--algebraic-only"])
        else ("shift_kv", "pasa_attention"))
    print(f"build: {time.perf_counter() - t0:.1f} s into "
          f"{_build.build_dir()}; seconds per source (one nvcc each, all "
          f"started together) " + json.dumps(
              {name: round(sec, 1) for name, sec in sorted(built.items())}))
    if argv == ["--train-only"]:
        phase_train(dev)
        return 0
    if argv[:1] == ["--multi-only"]:
        phase_multi(dev, half_batch="--half-batch" in argv)
        return 0
    if argv == ["--tools-only"]:
        phase_tools(dev)
        return 0
    if argv == ["--modes-only"]:
        for k in phase_modes(dev):
            _print_entry(k)
        print(smi)
        return 0
    if argv == ["--pages-only"]:
        for k in phase_pages(dev):
            _print_entry(k)
        print(smi)
        return 0
    if argv == ["--algebraic-only"]:
        for k in phase_algebraic(dev):
            _print_entry(k)
        print(smi)
        return 0
    # ptxas: each kernel instance's registers, stack and spills
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Compiling entry function" in line:
                    print(f"  {name}: {line.split(chr(39))[1]}")
                elif "registers" in line or "spill" in line:
                    print(f"  {name}:   {line.strip()}")

    print("exports: " + ", ".join(check_exports()))
    kernels = [*check_decode(dev), *check_prefill(dev), *check_shift_kv(dev),
               *check_attention(dev), *check_contiguous_decode(dev),
               *check_decode_hd64(dev), *check_shift_kv_hd64(dev),
               *check_attention_hd64(dev)]
    kernels += [check(dev, dtype) for dtype in QUANT_DTYPES
                for check in (check_decode_quant, check_prefill_quant)]
    print("prefill_chunk_starts: " + json.dumps(check_prefill_starts(dev)))
    print("check_verify: " + json.dumps(check_verify(dev)))
    for k in kernels:
        extra = (f"; max abs diff vs the plain version on the CPU "
                 f"{k['max_abs_err_cpu_plain']:.3e}"
                 if "max_abs_err_cpu_plain" in k else "")
        if "walk_ms" in k:
            extra += f"; its sequential walk {k['walk_ms']:.4f} ms"
        if "ms_block_256" in k:
            extra += f"; at block 256 {k['ms_block_256']:.4f} ms"
        if "serve_shape_ms" in k:
            extra += (f"; at the serve's decode shape {k['serve_shape_ms']:.4f}"
                      f" ms, library {k['serve_shape_library_ms']:.4f} ms")
        if "ms_pasa" in k:
            extra += f"; at beta {BETA} {k['ms_pasa']:.4f} ms"
        if "rmse_algebraic" in k:
            extra += (f"; rmse vs the algebraic shift {k['rmse_algebraic']:.2e}"
                      f" (plain {k['rmse_algebraic_plain']:.2e})")
        print(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e}, rmse "
              f"{k['rmse']:.2e}, {k['ms']:.4f} ms vs plain "
              f"{k['plain_ms']:.3f} ms, library {k['library_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}){extra}")
        for key in ("stress", "detail"):
            if k.get(key):
                print(f"  {k['name']} {key}: {json.dumps(k[key])}")
    # phase 18: head_dim 32 in every kernel, head_dim 64 in paged prefill,
    # driven with the launch counts set to 0 just before its pass
    modes = phase_modes(dev)
    for k in modes:
        _print_entry(k)

    bundle, params, init_s = build_model(dev)
    print(f"weights: {init_s:.1f} s")
    # each serving path is driven with every launch count set to 0 just
    # before it and read just after
    rep = serve(dev, bundle, params)
    print("serve: " + json.dumps(rep))
    reps = {"bf16": rep}
    for dtype in QUANT_DTYPES:
        rq = serve(dev, bundle, params, cache_dtype=dtype)
        same = sum(a == b for sa, sb in zip(rq["streams"], rep["streams"])
                   for a, b in zip(sa, sb))
        rq["tokens_equal_to_bf16_serve"] = f"{same}/{SERVE_GEN * len(SERVE_PROMPTS)}"
        rq["pool_bytes_vs_bf16"] = rq["pool_bytes"] / rep["pool_bytes"]
        print(f"serve_{dtype}: " + json.dumps(rq))
        reps[dtype] = rq
    # phase 19: every page size, with phase 3's weights cut to PAGES_LAYERS;
    # each serve driven with the launch counts set to 0 just before it
    pages = phase_pages(dev, bundle, params)
    for k in pages:
        _print_entry(k)
    # phase 20: the algebraic-shift dense attention, the serve on phase
    # 3's weights cut to ALG_LAYERS, driven with the launch counts set to
    # 0 just before it
    algebraic = phase_algebraic(dev, bundle, params)
    for k in algebraic:
        _print_entry(k)
    # phase 14: serving across devices with phase 3's weights - two
    # replicas on this card, then the model axis in a gloo group of two
    # processes - each serve driven with the launch counts set to 0 just
    # before it
    t_p14 = time.perf_counter()
    rep_replicas, replica_sync = serve_replicas(dev, bundle, params,
                                                rep["streams"])
    print("serve_replicas_bf16: " + json.dumps(rep_replicas))
    print("serve_affinity_bf16: "
          + json.dumps(serve_affinity(dev, bundle, params)))
    print("serve_replicas_async_bf16: " + json.dumps(
        serve_replicas_async(dev, bundle, params, replica_sync)))
    slices = check_kvh2_slices(dev)
    for k in slices:
        print(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e}, "
              f"{k['ms']:.4f} ms vs plain {k['plain_ms']:.3f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})")
    del replica_sync
    torch.cuda.empty_cache()
    mesh_reps = serve_mesh(dev)
    for tag, r in mesh_reps.items():
        print(f"{tag}: " + json.dumps(r))
    print(f"phase 14: {time.perf_counter() - t_p14:.1f} s")
    rep_dense = serve_dense(dev, bundle, params)
    rep_dense.update(dense_first_step(dev, bundle, params)[0])
    print("serve_dense: " + json.dumps(rep_dense))
    # the reference's attention switch at its default policy: impl="flash"
    # (FlashAttention-2 at bf16_fp32) with the same weights, on the paged
    # engine from a bf16 pool and on the dense route; how many greedy
    # tokens equal the PASA serve's is reported, not held
    flash = _flash_bundle(bundle)
    rep_fp = serve(dev, flash, params)
    rep_fd = serve_dense(dev, flash, params)
    for r, base in ((rep_fp, rep), (rep_fd, rep_dense)):
        same = sum(a == b for sa, sb in zip(r["streams"], base["streams"])
                   for a, b in zip(sa, sb))
        total = sum(len(x) for x in base["streams"])
        r["tokens_equal_to_pasa_serve"] = f"{same}/{total}"
    print("serve_flash: " + json.dumps(rep_fp))
    print("serve_dense_flash: " + json.dumps(rep_fd))
    # the engine's token-by-token mode, prefix cache, preemption and
    # policies, each driven with the launch counts set to 0 just before it
    # the engine's other modes (phases 6, 9 and 10 and the tenant policy)
    # on FEATURE_LAYERS of qwen2-7b's 28 layers (the same weights' first
    # layers), each held against the paged serve of that model from each
    # pool (batched == alone is phase 3's)
    feat, feat_params = _depth_cut(bundle, params, FEATURE_LAYERS)
    feat_reps = {}
    for dtype in ("bf16", *QUANT_DTYPES):
        feat_reps[dtype] = serve(dev, feat, feat_params, cache_dtype=dtype,
                                 alone=())
        print(f"serve_features_{dtype}: " + json.dumps(
            {k: feat_reps[dtype][k] for k in ("tok_per_s", "launches")}))
    t_new = time.perf_counter()
    print("serve_tbt: " + json.dumps(serve_tbt(dev, feat, feat_params)))
    for dtype in ("bf16", *QUANT_DTYPES):
        print(f"serve_prefix_{dtype}: "
              + json.dumps(serve_prefix(dev, feat, feat_params, dtype)))
    for dtype in ("bf16", "int8"):
        print(f"serve_preempt_{dtype}: "
              + json.dumps(serve_preempt(dev, feat, feat_params, dtype)))
    for scheduler, budget in POLICY_SERVES:
        print(f"serve_{scheduler}: " + json.dumps(serve_policy(
            dev, feat, feat_params, scheduler, budget,
            feat_reps["bf16"]["streams"])))
    print(f"engine features: {time.perf_counter() - t_new:.1f} s")
    # sampling and speculation on the paged engine, each serve driven with
    # the launch counts set to 0 just before it and checked just after
    t_spec = time.perf_counter()
    for dtype in ("bf16", "int8"):
        print(f"serve_sample_{dtype}: " + json.dumps(serve_sample(
            dev, feat, feat_params, dtype, feat_reps[dtype]["streams"])))
    for dtype in ("bf16", *QUANT_DTYPES):
        print(f"serve_spec_{dtype}: " + json.dumps(serve_spec(
            dev, feat, feat_params, dtype,
            drafters=("oracle", "wrong") if dtype != "fp8_e4m3" else (),
            sampled=dtype == "bf16")))
    print(f"sampling and speculation: {time.perf_counter() - t_spec:.1f} s")
    # async pipelining, cancellation and telemetry on the paged engine,
    # each serve driven with the launch counts set to 0 just before it and
    # checked just after
    t_async = time.perf_counter()
    async_pools = {}
    for dtype in ("bf16", *QUANT_DTYPES):
        rep_async, async_pools[dtype] = serve_async(
            dev, feat, feat_params, dtype, feat_reps[dtype]["streams"])
        print(f"serve_async_{dtype}: " + json.dumps(rep_async))
    print("serve_async_spec_bf16: "
          + json.dumps(serve_async_spec(dev, feat, feat_params)))
    print("serve_async_preempt_bf16: "
          + json.dumps(serve_preempt(dev, feat, feat_params, "bf16",
                                     depth=1)))
    print("serve_cancel_bf16: " + json.dumps(
        serve_cancel(dev, feat, feat_params, feat_reps["bf16"]["streams"])))
    for dtype in ("bf16", "int8"):
        print(f"serve_telemetry_{dtype}: " + json.dumps(serve_telemetry(
            dev, feat, feat_params, dtype, feat_reps[dtype]["streams"],
            async_pools[dtype])))
    del async_pools
    torch.cuda.empty_cache()
    print(f"async and telemetry: {time.perf_counter() - t_async:.1f} s")
    # phase 11, first part: the tenant policy on qwen2-7b's weights,
    # driven with the launch counts set to 0 just before each serve
    t_tenant = time.perf_counter()
    print("serve_tenant_bf16: " + json.dumps(serve_tenant(
        dev, feat, feat_params, feat_reps["bf16"]["streams"])))
    tenant_s = time.perf_counter() - t_tenant
    # the hybrid family (zamba2-1.2b) on the token-by-token dense route,
    # driven with the launch counts set to 0 just before it
    # phase 17, first part: the dense decode call's count against the dry
    # run's, with phase 4's weights
    phase_tools(dev, bundle, params, parts=("decode",))
    t_hybrid = time.perf_counter()
    del bundle, params, flash, feat, feat_params
    torch.cuda.empty_cache()
    rep_hybrid = serve_hybrid(dev)
    print("serve_hybrid: " + json.dumps(rep_hybrid))
    print(f"hybrid: {time.perf_counter() - t_hybrid:.1f} s")
    # the audio family (whisper-large-v3): one encode, then the
    # token-by-token dense route, each driven with the launch counts set
    # to 0 just before it
    t_whisper = time.perf_counter()
    torch.cuda.empty_cache()
    rep_whisper = serve_whisper(dev)
    print("serve_whisper: " + json.dumps(rep_whisper))
    print(f"whisper: {time.perf_counter() - t_whisper:.1f} s")
    # phase 11: the kernels at the dense configs' GQA groups, then
    # qwen3-4b on both routes, each serve driven with the launch counts
    # set to 0 just before it
    t_q3 = time.perf_counter()
    torch.cuda.empty_cache()
    groups = check_groups(dev)
    for k in groups:
        print(f"{k['name']} ({k['arch']}, KVH {k['kvh']}, G {k['group']}): "
              f"max_abs_err {k['max_abs_err']:.3e}, rmse {k['rmse']:.2e}, "
              f"{k['ms']:.4f} ms vs plain {k['plain_ms']:.3f} ms, library "
              f"{k['library_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']})")
    q3, q3_params, q3_init = build_qwen3(dev)
    print(f"qwen3-4b weights: {q3_init:.1f} s")
    q3_reps = {}
    for dtype in ("bf16", *QUANT_DTYPES):
        q3_reps[dtype] = serve(dev, q3, q3_params, cache_dtype=dtype,
                               alone=QWEN3_ALONE)
        print(f"serve_qwen3_4b_{dtype}: " + json.dumps(q3_reps[dtype]))
    q3_dense = serve_dense(dev, q3, q3_params, alone=QWEN3_ALONE)
    gaps, q3_first = dense_first_step(dev, q3, q3_params)
    q3_dense.update(gaps)
    q3_dense.update(dense_vs_paged(dev, q3, q3_params, q3_dense["streams"],
                                   q3_first))
    print("serve_qwen3_4b_dense: " + json.dumps(q3_dense))
    print("serve_qwen3_4b_tbt: " + json.dumps(serve_tbt(
        dev, q3, q3_params, lens=QWEN3_TBT_PROMPTS)))
    del q3, q3_params
    torch.cuda.empty_cache()
    print(f"phase 11: {tenant_s + time.perf_counter() - t_q3:.1f} s "
          f"(tenant {tenant_s:.1f} s)")
    # phase 12: the kernels at the vlm's image cross call, then
    # llama-3.2-vision-90b (depth VLM_LAYERS) and falcon-mamba-7b token by token,
    # each serve driven with the launch counts set to 0 just before it
    t_p12 = time.perf_counter()
    cross = check_vlm_cross(dev)
    for k in cross:
        print(f"{k['name']}: max_abs_err {k['max_abs_err']:.3e}, rmse "
              f"{k['rmse']:.2e}, {k['ms']:.4f} ms vs plain "
              f"{k['plain_ms']:.3f} ms, library {k['library_ms']:.4f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']})")
        if k.get("detail"):
            print(f"  {k['name']} detail: {json.dumps(k['detail'])}")
    rep_vlm = serve_vlm(dev)
    print("serve_vlm: " + json.dumps(rep_vlm))
    print("serve_falcon_mamba: " + json.dumps(serve_falcon_mamba(dev)))
    print(f"phase 12: {time.perf_counter() - t_p12:.1f} s")
    # phase 13: olmoe-1b-7b (the moe family) at full width, 8 layers, on
    # both routes, each serve driven with the launch counts set to 0 just
    # before it
    t_p13 = time.perf_counter()
    torch.cuda.empty_cache()
    olmoe, olmoe_nodrop, olmoe_params, olmoe_init = build_olmoe(dev)
    print(f"olmoe-1b-7b weights: {olmoe_init:.1f} s")
    olmoe_reps = serve_olmoe(dev, olmoe, olmoe_nodrop, olmoe_params)
    del olmoe, olmoe_nodrop, olmoe_params
    torch.cuda.empty_cache()
    print(f"phase 13: {time.perf_counter() - t_p13:.1f} s")
    train_entries, rep_train = phase_train(dev)
    # phase 16: training across processes, two ranks on this card, each
    # path driven with the launch counts set to 0 just before it
    multi_entries = phase_multi(dev)
    # phase 17, second part: the training step's count and state bytes
    # against the dry run's
    phase_tools(dev, parts=("train",))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # each mode of shift-KV has the dense serve's count of that mode (0 for
    # the modes the serve does not run); the paged kernels' quantized modes
    # have their own serve's count; the fp32 and bf16_fp32 modes the flash
    # serves' counts of that mode (the attention kernel's from both its ops)
    # the head_dim 64 entries of the decodes have the hybrid serve's count
    # of that mode (0 for paged decode, which no hybrid serve runs); those
    # of shift-KV and attention the whisper serve's count of their mode,
    # the encode's included (0 for the modes it does not run)
    for k in kernels:
        name, _, tag = k["name"].partition("/")
        if "whisper_mode" in k:
            op, mode = k["whisper_mode"]
            k["launches"] = (rep_whisper["launches_by_mode"][op].get(mode, 0)
                             + rep_whisper["encode_launches_by_mode"][op].get(
                                 mode, 0))
        elif _is_hd64(k):
            mode = mode_name(get_policy("fp16"), torch.bfloat16, 64)
            k["launches"] = rep_hybrid["launches_by_mode"][name].get(mode, 0)
        elif name == "shift_kv":
            k["launches"] = rep_dense["shift_kv_launches_by_mode"].get(
                k["mode"], 0)
        elif _is_new_mode(k):
            mode = mode_name(get_policy(tag), torch.bfloat16)
            by_mode = (rep_fp if name.startswith("pasa_paged_")
                       else rep_fd)["launches_by_mode"]
            names = (("pasa_attention", "flash_attention")
                     if name == "pasa_attention" else (name,))
            k["launches"] = sum(by_mode[n].get(mode, 0) for n in names)
            if tag == "bf16_fp32" and k["launches"] == 0:
                raise AssertionError(f"{k['name']} was not launched on the "
                                     f"flash serve")
        else:
            serve_rep = (reps[tag or "bf16"] if name.startswith("pasa_paged_")
                         else rep_dense)
            k["launches"] = serve_rep["launches"][name]
    line = [{key: k[key] for key in keys} for k in kernels if "/" not in k["name"]]
    # the paged kernels: the replica serve's launches too, and the bf16
    # mesh serve's of both ranks (phase 14; the sharded engine runs the
    # one-device step at KVH 4 on the gathered pool)
    for k in line:
        if k["name"] in rep_replicas["launches_per_replica"][0]:
            k["launches"] += sum(p[k["name"]] for p in
                                 rep_replicas["launches_per_replica"])
            k["launches"] += mesh_reps["serve_mesh_1x2_bf16"][
                "launches_all_ranks"][k["name"]]
    for k in line:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was not launched on its serve")
    line += [{key: k[key] for key in keys} for k in kernels if _is_new_mode(k)]
    for name in ("pasa_paged_decode", "pasa_paged_prefill", "shift_kv"):
        line.append(_mode_entry(name, [
            k for k in kernels if k["name"].startswith(name + "/")
            and not _is_new_mode(k) and not _is_hd64(k)
            and "whisper_mode" not in k], keys))
    hd64 = [{key: k[key] for key in keys} for k in kernels if _is_hd64(k)]
    if not any(k["launches"] for k in hd64 if k["name"] == "pasa_decode/d64"):
        raise AssertionError("pasa_decode/d64 was not launched on the hybrid "
                             "serve")
    line += hd64
    # head_dim 64 of shift-KV and attention: the whisper path's mode of
    # each, then the other modes of each in one entry
    for name in ("shift_kv", "pasa_attention"):
        path = [k for k in kernels if k["name"] == f"{name}/d64"]
        if not path or not path[0]["launches"]:
            raise AssertionError(f"{name}/d64 was not launched on the "
                                 f"whisper serve")
        line.append({key: path[0][key] for key in keys})
        line.append(_mode_entry(name, [
            k for k in kernels if "whisper_mode" in k
            and k["name"].startswith(f"{name}/d64_")], keys))
    # the GQA group entries: qwen3-4b's (G 4) and olmoe-1b-7b's (G 1, KVH
    # 16) their serves' counts (the paged kernels that of the pool in the
    # tag), contiguous decode at G 8 the vlm serve's count of its mode, 0
    # at the groups no serve runs
    served = {"qwen3-4b": (q3_reps, q3_dense),
              "olmoe-1b-7b": ({"bf16": olmoe_reps["serve_olmoe_bf16"],
                               "int8": olmoe_reps["serve_olmoe_int8"]},
                              olmoe_reps["serve_olmoe_dense"])}
    for k in groups:
        name, _, tag = k["name"].partition("/")
        if name == "pasa_decode" and k["group"] == 8:
            k["launches"] = rep_vlm["launches_by_mode"][name].get(
                mode_name(get_policy("fp16"), torch.bfloat16), 0)
            if not k["launches"]:
                raise AssertionError(f"{k['name']} was not launched on the "
                                     f"vlm serve")
            continue
        if k["arch"] not in served:
            k["launches"] = 0
            continue
        paged, dense = served[k["arch"]]
        rep_g = (paged[tag.partition("_")[2] or "bf16"]
                 if name.startswith("pasa_paged_") else dense)
        k["launches"] = rep_g["launches"][name]
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched on its "
                                 f"{k['arch']} serve")
    line += [{key: k[key] for key in keys} for k in groups]
    # the vlm's image cross call and its self layers' decode: each entry
    # the vlm serve's count of its mode
    for k in cross:
        op, mode = k["vlm_mode"]
        k["launches"] = rep_vlm["launches_by_mode"][op].get(mode, 0)
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched on the vlm "
                                 f"serve")
    line += [{key: k[key] for key in keys} for k in cross]
    # the per-rank KVH 2 slices: no serve runs them (the sharded engine
    # gathers the pool and runs the one-device step at KVH 4), so each
    # has the launches of the two sharded ops at KVH 4 over the 1x2 group,
    # summed over its ranks (``_mesh_ops``)
    for k in slices:
        k["launches"] = sum(
            rank_ops["kvh2_launches"][k["name"].partition("/")[0]]
            for rank_ops in mesh_reps["serve_mesh_1x2_ops"])
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched by the "
                                 f"sharded ops")
    line += [{key: k[key] for key in keys} for k in slices]
    # the training call's shift-KV and attention: the trainer's counts
    for k in train_entries:
        k["launches"] = rep_train["launches"][k["name"].partition("/")[0]]
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched by the "
                                 f"trainer")
    line += [{key: k[key] for key in keys} for k in train_entries]
    # the per-rank training calls of phase 16: every rank's launches
    for k in multi_entries:
        if not k["launches"]:
            raise AssertionError(f"{k['name']} was not launched by the "
                                 f"ranks")
    line += [{key: k[key] for key in keys} for k in multi_entries]
    # phase 18's entries, each with its pass's launches: shift-KV's path
    # mode (bf16 keys, fp16 operands, block 128) alone, its other d32
    # modes in one entry
    shift_other = [k for k in modes if k["name"].startswith("shift_kv/d32_")]
    line += [{key: k[key] for key in keys} for k in modes
             if k not in shift_other]
    line.append(_mode_entry("shift_kv", shift_other, keys))
    # phase 19's entries: the paged kernels at page 16 with the page-16
    # serves' launches, at page 8 (and prefill at page 256) with the
    # launches of check_pages' pass at that page, prefill at page 512 with
    # the page-512 serves'
    line += [{key: k[key] for key in keys} for k in pages]
    # phase 20's entries: the algebraic shift and the attention on its K'
    # with the algebraic dense serve's launches
    line += [{key: k[key] for key in keys} for k in algebraic]
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
