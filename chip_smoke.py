#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths (LLaMA,
ResNet-50, LeNet through ``Model.fit`` and BERT/ERNIE, functional and
eager) and its kernel experiments on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together), print the card's name and power
   limit, and the registers, shared memory and spills of every
   instance of ``flash_attention.cu``, ``blocked_matmul.cu`` (the four
   tiles), ``decode_attention.cu`` (q fp32 or bf16; the cache in q's
   type, int8 or fp8; exact instances at D 64 and 128 for one query head
   per kv head or up to eight, padded ones at widths 32, 64 and 128 for
   the other head dims of 8s, a one-byte cache's with 8-byte pieces),
   ``paged_attention.cu`` (the split-KV decode family in fp32 and bf16,
   exact and padded; the bf16 tensor-core prefill exact at 64 and 128 and
   padded at 32, 64 and 128, the fp32 prefill at 64 and 128 both ways),
   ``quant_matmul.cu`` (x fp32 or bf16, int8 or fp8 weights, 32
   or 128 columns a block, 16-byte or byte-wise copies), ``head_dx.cu``
   ``rope.cu`` (fp32 or bf16, 16-byte or one-value loads) and
   ``rms_norm.cu`` (both norms in fp32 or bf16, 16-byte or one-value
   loads, the row in registers or a strided loop) (a spill fails);
2. hold every kernel against its plain PyTorch version on the card, in
   bf16 and fp32, and time the kernel, the plain version and, where one
   PyTorch call computes the same function, that call: the tick kernels
   and ``ragged_decode_attention`` at the serving shape, a llama7b-width
   shape, a GQA shape and two head dims off 64 and 128 (cpu_small's D 16,
   D 96 in GQA), beside the launch floor (an empty kernel through the
   norms' ctypes path, replayed and eager); ``ragged_paged_attention`` on
   the serving decode tick, the serving admit prefill (256 rows at
   context 0 and 192), llama7b-width and GQA decode ticks, one
   mixed-q_len launch, admits of 512 and 2048 rows at llama7b width,
   decode ticks and prefills at D 16 and 96, and phase 3h's verify ticks
   (K 1, 4, 7, 8), a 64-row chunk off the page grid and a 2 x 64-row sp
   slab, each on a shuffled page table, beside gather + SDPA (two calls); the flash-attention forward
   and backward kernels (bf16; the backward in
   one launch of both roles, bit-identical to each role launched alone,
   and each role alone) at bench.py's training shape (B 44, S 512, 12
   heads of D 64, causal), at phase 5c's BERT shape (the same, not
   causal), at llama7b width (B 1, S 2048, 32 heads of D 128, causal) and
   one non-causal shape with a ragged edge, beside SDPA's forward and
   backward; their fp32 instance (``flash_attention_f32.cu``, 3xTF32 on
   the tensor cores) within 1e-4 of the plain versions at phase 6c's shape
   (B 8, S 512, 12 heads of D 64, not causal), a cross-attention shape
   (Sq 384, Sk 512) and D 128 causal, timed beside SDPA's fp32 forward and
   backward at each, its bound three TF32 passes at the TF32 tensor-core
   rate beside the fp32 CUDA-core bound;
   ``head_dx_softmax`` at the CE tail's shape (M 22528, V 32000, H 768)
   beside its GEMM alone; ``quant_matmul`` (int8 and fp8 weights, bf16
   x) at the decode tick's four projection shapes with B 8, lm_head with
   B 1 and B 8, and two ragged edges, beside dequantize + ``torch.mm``
   (the kernels line carries each shape of it and of the paged kernel);
   ``ragged_decode_attention``'s quant mode (int8 and fp8 caches with
   per-row scales) at the serving shape and at llama7b width, beside
   dequantize + SDPA; and ``multi_tensor_update`` at ResNet-50's 161
   parameters (one flat buffer, padding held at zero) in bf16 momentum
   (the main path), fp32 momentum, bf16 Nesterov, bf16 sgd, O2 AdamW
   (bf16 params, fp32 moments and master) and fp32 Lamb, beside
   ``torch._fused_sgd_`` / ``torch._fused_adamw_`` on the shaped list, and
   a step with skip = 1 that must leave every buffer bit-identical; the
   kernel experiments' kernels: ``blocked_matmul``'s four tile instances
   at the lm_head dx shape (22528 x 32000 x 768) beside ``torch.mm``, every
   flash-variant instance (``run_fwd`` / ``run_bwd`` causal and not over
   nsplit 1, 2, 4 and exp_bf16, ``run_fwd2``'s p_bf16 and in-kernel
   scale, the twelve ablations) at B 4 against its plain version, and the
   main variants (forward and backward at nsplit 1 and 4, ``run_fwd2``)
   timed at B 44, S 512, 12 heads of D 64 beside SDPA;
3. serve 32 requests of the mixed workload through ``ServingEngine`` at
   ``LlamaConfig.bert_base_equiv`` width in bf16 (random weights from a
   seeded generator) with its windowed drain (``run(fused=False)``),
   check every request's tokens, and check from the launch counters that
   every decode tick went through the four kernels;
3b. the same 32 requests through ``ServingEngine(paged=True)``: every
   attention through ``ragged_paged_attention`` (L per segment step),
   the tick kernels L or L + 1 times per decode step, no page leaked,
   one device read per segment and none while a segment is issued; then
   both engines' drains timed in turns;
3c. the serving benchmark's shared-prefix burst (16 requests, a 192-token
   prefix, 32-token tails) through ``OnlineScheduler`` with a
   ``PagedPrefixCache``: prefix hits by page reference, no COW break, no
   leak;
3f. a long admit: ``ServingEngine(paged=True, max_len=2048)`` with
   buckets up to 1024 serves a 1000-token prompt (one 1024-row prefill
   chunk through ``ragged_paged_attention``), and the same admit and four
   ticks teacher-forced against the plain path within the bf16 logit
   tolerance; then ``LlamaConfig.cpu_small`` (8 heads of D 16, fp32) end
   to end: the mixed workload through the contiguous and the paged
   engine (3's and 3b's checks) and 4's and 4b's teacher-forced ticks;
3g. the contiguous engine's other paths at the same width: (a) the same
   32 requests through its fused drain (``run()``): every request's
   count, the tick kernels L (the norm L + 1) times a decode tick, one
   fetch, and the share of requests whose tokens equal phase 3's (bf16
   admits batch differently, so it is printed); (b) phase 3c's burst
   through ``OnlineScheduler`` on the contiguous engine's segments with a
   row-copy ``PrefixCache(block=32)`` (at least one hit) and without a
   cache, each a warm pass then a measured one, TTFT and end-to-end
   percentiles printed side by side; (c) ``beam_search_generate`` (B 2,
   a 64-token prompt, 32 tokens, 4 beams, without and with EOS) and
   sampled ``generate`` (T 0.8, top-k 50, top-p 0.9): tokens in the
   vocabulary, one seed twice gives one stream, ``top_k=1`` equals greedy
   up to a tied top logit, and one tick a token; (d) preemption between
   segments and resume with a prefix cache, then ``abort`` with a
   segment in flight and resume, on both engines: every request's count,
   the kernels' launches, no page leaked;
3d. quantized serving: the 32 requests through
   ``ServingEngine(paged=True, quant="int8", quality_digest=True)``, every
   tick projection and lm_head through ``quant_matmul`` (7 L + 1 per
   decode step, 1 per admit) and no paged or decode attention kernel
   (the quantized pool attends through the dequantizing gather); one
   fetch per segment and none while one is issued; then the same
   requests through a bf16 paged engine with digests as the shadow, each
   request scored with ``compare_pair`` (printed: on random weights at
   this width two bf16 engines already disagree, see 3b's matched-prefix
   rate against the contiguous engine); then 8 requests through an fp8
   engine;
4. teacher-forced decode ticks through the kernel path and the plain path
   side by side, on the contiguous cache (4), on a shuffled page table
   (4b) and, with int8 weights and pool, on a quantized one (4c): logits
   within a stated bf16 tolerance;
5. training at ``bert_base_equiv`` width, bf16 compute with fp32 master
   weights (random, from a seeded generator) on tokens from
   ``np.random.RandomState(0)`` with labels = tokens, as bench.py trains:
   (a) at B 8, S 512 one ``loss_fn`` value and gradient through the
   kernels and through their plain versions, within stated budgets;
   (b) at B 44, S 512, two warm-up steps of ``make_train_step`` (AdamW,
   lr 1e-4), then ten timed ones: tokens/s, ms/step, peak memory, the
   device's busy share from a profiled step; (c) the loss after them is
   below the first step's; (d) each timed step launches the forward and
   the one-launch backward once per layer (the role-only backward entries
   never) and ``head_dx_softmax`` once;
3e. (after 5) quantized serving's quality bar on a confident model:
   phase 5's weights trained on over its batch until the loss is below
   0.3, cast to bf16, serve 32 continuations of its training sequences
   (the mixed workload's lengths) through the int8 and the bf16 paged
   engines with digests; the int8 serve's matched-prefix rate against the
   bf16 one must be at least 0.5, the JAX package's bar;
3h. (after 3e) the paged engine's other segment families at
   ``bert_base_equiv`` width in bf16, 8 slots, pages of 16, each path's
   launches counted (the paged kernel a layer a step; the tick kernels a
   layer a one-token tick; a K > 0 verify tick runs its K + 1 tokens a
   slot through the prefill path), tokens/s, wall and device ms a step
   (a profiled serve of 8 requests), busy share and fetches printed: (a)
   the 32 mixed requests, one every 20 ms, through ``OnlineScheduler``
   chunked (chunks of 16, 32 or 64) and unchunked: every count, no page
   leaked, one fetch a segment, TTFT and e2e percentiles, agreement, and
   chunked segments issued with no sync; (b) greedy ``speculative=4`` on
   the random weights, the first 8 of the 32 requests (against the same
   8 of (a)'s serve: divergences only at near ties; verify ticks,
   acceptance, reads a segment) and
   on 3e's memorized model: its first 16 continuations identical to its
   non-speculative serve, and 4 of a repeated-stretch class whose
   divergences must sit at near ties; some asserted class accepts
   drafts; (c) sampling (T 0.8, top-k 32) at K 0 and 4 on 4 requests:
   two serves with the same seeds equal, ``top_k=1`` equal to greedy up
   to near ties (the depth of (b) and (c) cut from 32, 32, 16 and 8
   requests, for the script's time); (d)
   ``seq_parallel=2`` with a 2000-token prompt and 7 requests behind it
   in segments of 8 steps: the prefill spans segments, TTFT against a
   chunked engine without sp (buckets to 2048), agreement; (e)
   ``ragged_paged_attention`` against its plain version at verify ticks
   (K 1, 4, 7, 8; dead slots past the window), chunks off the page grid
   and sp slabs sharing one table row;
3i. (after 3h, on its weights) the host KV tier behind the paged prefix
   cache and the SLO control plane: (a) 16 tenants x 3 rounds of a
   256-token prefix and a 32-token tail (32 tokens each, all at t = 0)
   through ``OnlineScheduler`` on a tight pool (96 pages, max_len 512)
   with a ``PagedPrefixCache(capacity_pages=48)`` over a
   ``HostTier(capacity_pages=1024)``: stages, spills and restores happen;
   under ``set_sync_debug_mode("warn")`` the serve's synchronising calls
   and CUDA event waits (``event_waits``) number exactly its fetches (one
   a segment, a wait on its event: the tier adds none); every
   restore leaves in its pages, each plane, the bytes staged for them;
   tokens equal a serve with no cache or part at a near tie; no page
   leaked after ``reset``; tokens/s, TTFT and admit-to-first-token by hit
   kind against an untiered cache of the same pool bound; one 16-page
   stage and restore timed against a plain pinned ``copy_``; (b) the same
   on an int8 pool (its ``ks``/``vs`` planes travel with the pages;
   tokens held to the int8 serve with no cache on the serve's own
   digests); (c) ``SLOScheduler`` under overload (long class-1 requests
   at t = 0, short class-0 ones with e2e deadlines from 50 ms on):
   preemptions, none of the same or a higher class, class 0's TTFT p99
   below class 1's, the report's sheds equal to the journal's
   ``shed_decision`` records; then, shedding off, the serve without
   monitors and with the SLO, perf and capacity monitors under the first
   one's decision clock fed back: identical tokens, fetches and launches;
3j. (after 3i, on 3e's trained model in bf16) the serving fleet and
   disaggregated prefill/decode: (a) a ``FleetRouter`` over two replicas
   of 3i's engine (quality digests on), each with a
   ``PagedPrefixCache`` over a ``HostTier``, the cache directory, queues
   of 4, and an int8 ``Shadow`` at sample_p 0.5, on 3i's trace at 2
   rounds: every request's count, both replicas used, directory hits and
   tier migrations, synchronising calls plus event waits equal to the
   primary and shadow fetches, the launches of both replicas and the
   shadow, no page leaked after ``reset``, tokens equal to one replica's
   or parted at a near tie, and a ``QualityMonitor`` pair for every
   mirrored request; the dispatch and ``t_sync`` stamps of the first
   turns are printed; two replicas against one timed in two pairs,
   the order alternating (tokens/s and medians); (b) the same fleet with
   ``FaultInjector(crash={1: 3})``: nothing lost, one failover, tokens
   held as in (a); (c) a ``DisaggRouter`` (one prefill and one decode
   replica, segments of 8 and 32) on the 32 mixed requests: every
   crossing within its reserved KV footprint, the handoff flushes the
   only synchronising calls, each drain's host time, the launches, and
   tokens held to a co-resident two-replica fleet;
3k. (after 3j, on the same model and engine geometry) the elastic fleet:
   (a) ``aot_warmup`` of one replica under its default envelope, 3k's
   (segments of 32 behind a prefix cache of page blocks) and a
   ``DisaggRouter``'s pool envelopes, keys and seconds by family; two
   pairs in turns of a cold engine's first segment against a warmed
   one's; the warmed replica serving 3j's trace with no library load,
   no split-KV ticket buffer and no key outside its envelope
   (``analysis.recompile``); (b) four replicas behind one
   ``Autoscaler`` (min 1, max 4, initial 1) on a trace shaped as the
   reference episode's: 1 -> 4 -> 1, nothing stranded, the scale-ups'
   warm seconds, drain requeues and migrations, the launches, tokens
   against one engine's or parted at a near tie; (c) the chip fit
   against the card: weights and pool bytes equal to the bytes the
   allocator was asked for at build (its rounded blocks beside), the
   transient estimate beside a serve's measured peak, and
   one journaled refusal;
6. ResNet-50 training, BASELINE config 1 (benchmarks/resnet50.py):
   ``resnet50(num_classes=1000, data_format="NHWC")`` from the port's
   initializers (seed 0), B 128 at 224x224 (``RandomState(0)`` images and
   labels), Momentum(0.1, 0.9, weight decay 1e-4), AMP O2 bf16,
   ``CrossEntropyLoss`` and ``fused_train_step``: (6.1) two steps through
   ``multi_tensor_update`` and two through its plain version from the
   same weights under deterministic cuDNN, losses, params and BN running
   statistics compared; (6.2) 2 warm-up and 10 timed steps: images/s,
   ms/step, peak memory, one profiled step's busy share and device time
   by kind; (6.3) exactly one ``multi_tensor_update`` launch per step
   (the 161 params are one bf16 group); (6.4) three O2
   ``AdamW(multi_precision=True)`` steps, one adam-with-master launch
   each;
6b. BASELINE config 0 (benchmarks/mnist_fit.py): ``Model(LeNet())`` on the
   6000-sample synthetic ``MNIST(mode="train")``, prepared with
   ``Adam(1e-3)``, ``CrossEntropyLoss`` and ``Accuracy``, ``fit(epochs=1,
   batch_size=256)``: (6b.1) two 4-step fits in order from the same
   seeded LeNet under deterministic cuDNN, through ``multi_tensor_update``
   and through its plain version: losses and every parameter within
   ``MTU_TOL``, 4 launches against 0; (6b.2) the recipe, one warm fit then
   one timed fit of 24 batches: samples/s, ms a step, the loader's and
   ``train_batch``'s ms a batch, launches a step (1: LeNet's 10 fp32
   params are one group), then a profiled fit (the busy share from its
   device time and its own wall; its host time inside ``train_batch``
   split by call: forward, loss, backward, update, pack, unpack, read,
   ...; host operators by self time), the synchronising calls a batch of
   a fit under ``set_sync_debug_mode("warn")`` (1: the loss and the
   accuracy matrix in one read) and ``evaluate`` on
   ``MNIST(mode="test")``; (6b.3) a fit with
   ``CosineAnnealingDecay`` stepped by the ``LRScheduler`` callback,
   ``ClipGradByGlobalNorm(1.0)`` and ``L2Decay(1e-4)``: one launch a step,
   each at ``lr.py``'s rate; (6b.4) ``Model.save``, ``load`` into a fresh
   model, equal ``evaluate`` logs;
5c. (after 6b) BASELINE config 2, BERT-base MLM pretraining
   (``models.bert``, ``BertConfig.bert_base``: V 30522, 12 layers, H 768,
   12 heads of D 64, F 3072, bf16 compute over fp32 master weights from
   seed 0, remat with attention outside the checkpointed halves): (a) at
   B 8 x S 512 one ``loss_fn`` value and gradient through the flash
   kernels and through their plain versions, within phase 5's budgets;
   (b) at bench.py's B 44 x S 512 (``random_mlm_batch``, seed 0) one warm
   and ten timed ``make_train_step`` steps (clip, AdamW 1e-4): ms a step,
   trained tokens/s, busy share of a profiled step, peak memory, and
   exactly 12 non-causal flash forwards and 12 one-launch backwards a
   step; (c) one ``ernie_base`` step (V 18000) beside a forward with four
   segment types, its launches counted;
6c. the eager stack at the same width: ``Embedding`` ->
   ``TransformerEncoder`` (12 x 768, 12 heads, 3072, gelu, post-LN,
   ``attn_dropout=0.0``) -> ``Linear`` to the vocabulary,
   ``nn.CrossEntropyLoss(ignore_index=-100)`` and ``optimizer.AdamW`` with
   ``apply_decay_param_fun``, ``loss.backward(); opt.step();
   opt.clear_grad()`` at B 8 x S 512 in fp32 (the fp32 flash instance)
   and under ``amp.auto_cast(dtype="bfloat16")`` (the bf16 kernels), a
   warm and three timed steps each: 12 forward and 12 backward launches of
   the dtype's flash kernels a step, the flat AdamW update's launches the
   same each step, ms a step and tokens/s;
6d. the PaddleClas zoo (after 6c): (6d.1) ``mobilenet_v3_large`` trained
   as phase 6 trains ResNet-50 but NCHW (B 128 at 224x224, O2 bf16,
   Momentum(0.1, 0.9, 1e-4), ``fused_train_step``): two steps through
   ``multi_tensor_update`` against two through its plain version under
   deterministic cuDNN (losses within ``RESNET_LOSS_ATOL``, every
   parameter and BN statistic within ``MTU_TOL``; the plain path run
   twice says whether the step itself is deterministic), then 2 + 10 timed
   steps (images/s, ms a step, peak memory, one launch a step for its one
   flat group), one profiled step's busy share and device time by kind
   (depthwise and other convolutions, batch norm, elementwise and
   activations, pools, the update, the pack); (6d.2) ``alexnet``,
   ``vgg16(batch_norm=True)``, ``squeezenet1_1``, ``mobilenet_v1``,
   ``mobilenet_v2``, ``mobilenet_v3_small``, ``shufflenet_v2_x1_0``,
   ``densenet121``, ``googlenet`` (224x224) and ``inception_v3``
   (299x299), each built on the CPU from seed 0: an fp32 eval forward at
   B 2 on the card within ``ZOO_FWD_RTOL`` of the CPU's, then two O2
   fused Momentum steps at B 32 (finite losses, one update launch a step
   for each flat group, ms of the second and peak memory); phase 2 also
   times the Momentum update at MobileNetV3-large's 174 parameters;
6e. the text models, the other optimizers and the losses (after 6d;
   ``paddle_tpu_torch.text.recipes``): (a) ``Model.fit`` of
   ``SentimentBiLSTM`` (``Embedding(5000, 128)``, a two-layer
   bidirectional ``LSTM`` of 198, the last step's 396 features ->
   ``Linear(396, 96)`` -> ``Tanh`` -> ``Linear(96, 2)``: 21 parameters,
   one flat group) on ``text.Imdb`` at its defaults with ``Adam``,
   ``CrossEntropyLoss`` and ``Accuracy``, batch 64: four steps in order
   through ``multi_tensor_update`` and through its plain version (losses
   and parameters within ``MTU_TOL``, 4 launches against 0), then two
   timed epochs (samples/s, ms a step, one launch a step, test accuracy
   after each; above 0.5 at the end) and a profiled stretch of 2 steps
   (busy share, the flat kernel's device ms a step); (b) ``NGramGRU`` on
   ``text.Imikolov`` (the 4 context words -> ``Embedding(2000, 128)`` ->
   ``GRU(128, 256)`` -> ``Linear(256, 2000)`` -> ``log_softmax`` ->
   ``NLLLoss``), ``RMSProp(centered=True, momentum=0.9)``, batch 256, one
   epoch: predicted tokens/s and the mean loss over the training set
   before and after, which must fall; (c)
   ``paddle_tpu_torch.experiments.parity.optimizer_parity``:
   each of the ten optimizers that step parameters one by one (``LBFGS``
   with ``"strong_wolfe"``) three full-batch steps on ``UCIHousing`` (a
   five-layer MLP) on the card and on the CPU from the same weights,
   within 1e-5, and its loss falling over 50 steps on the card; (d)
   ``parity.loss_parity``: every loss forward and backward on the card
   and on the CPU at B 64 within 1e-5 (``ctc_loss`` at T 200, B 32, C 30,
   label length 40); phase 2 also times the Adam update at the BiLSTM's
   21 parameters;
6f. the vision slice and quantization (after 6e): (a)
   ``paddle_tpu_torch.experiments.vision_quant.flowers_fit``: Flowers-102
   fine-tuning as PaddleClas's quick start sets it up
   (``vision.recipes``: ``resnet50(num_classes=102)`` under O2 bf16 with
   ``Momentum(0.0125, 0.9, 1e-4)``, ``RandomResizedCrop(224)``,
   ``RandomHorizontalFlip``, ``Normalize``; ``Resize(256)`` and
   ``CenterCrop(224)`` to evaluate) through ``Model.fit`` at batch 32 on
   the synthetic ``Flowers`` (1020 images of 3 x 96 x 96): first three
   steps on one batch through the flat update and through its plain
   version under deterministic cuDNN (losses within 1e-3 and falling,
   every parameter and BN statistic within the update's tolerance), then
   one epoch with a serial loader and one with four worker threads:
   images/s, ms a step,
   the loader's and ``train_batch``'s ms a batch, one flat update a step
   for the optimizer's one group, a profiled stretch's busy share, test
   accuracy, and the serial epoch's batches as the card received them
   equal bit for bit to the same epoch's transforms run again on the CPU
   under the same seed; (b) ``parity.detection_parity``: every
   ``vision.ops`` operator at PaddleDetection's widths (``generate_proposals``
   on a C4 RPN at 800 x 1333, ``nms`` at 6000 boxes and category-aware
   over 80 classes, ``distribute_fpn_proposals`` into per-level
   ``roi_align`` over FPN levels 2-5, ``roi_pool`` at Fast R-CNN VGG16's
   conv5, ``psroi_pool`` at R-FCN's 81 x 49 maps, ``yolo_box`` on
   YOLOv3's three heads at 608 x 608 and B 8, ``box_coder`` and
   ``prior_box`` at SSD300's six maps and 1000 x 81 decodes, DCNv2 3 x 3
   convolutions at C5 and C3 of 800 x 1333) on the card and on the CPU:
   kept indices, proposals and priors equal, outputs within 1e-5 (boxes
   in pixels in units of the image) and the RoI operators' gradients
   within 1e-5, the deformable convolutions' within 1e-5 by relative
   Frobenius error, each call's card ms (the per-level ``roi_align``
   compared on its first 32 RoIs an image and the level's tallest and
   widest, at the sampling ratio of the call timed over all); (c)
   ``vision_quant.qat_bert``: 6c's fp32 encoder under ``QAT`` (every
   ``Linear``, 73, with ``FakeQuanterWithAbsMax`` on activations and
   weights): three timed steps (12 fp32 flash forwards and backwards and
   the flat AdamW update's launches a step, the quanters' device reads a
   step), ``convert`` to ``Int8Linear`` (``torch._int_mm``, zero-padded)
   and the int8 forward against the fp32 one and against the same model
   on the CPU on one row (fed the card's codes: every int32 accumulator
   and the logits equal; on its own codes: the flipped codes by layer, and
   the logits within ``vision_quant.LOGIT_ERR`` of their largest
   magnitude), then PTQ (``AbsmaxObserver``, four calibration batches)
   and its int8 logits against the fp32 ones;
6g. the tensor core and the op corpus (``experiments/op_corpus.py``): (a)
   every one of the 303 names of ``all_ops()`` on the card and on the
   CPU on the same seeded inputs (1024^2 fp32; the decompositions on
   8 x 256^2; the products and reductions on zero-mean inputs), outputs
   and the gradients of every differentiable op within ``op_corpus.TOL``
   of the largest value (the spectra within ``op_corpus.SPECTRA_TOL``),
   the decompositions by their invariants, the sorts by integer-valued
   inputs that tie, the
   random ops by shape, dtype, range, moments and repetition under
   ``seed``; (b) ``README.md``'s quickstart (lines 10-29, the two import
   lines naming ``paddle_tpu_torch``) run on the card, then 20 AdamW
   steps of its model (784 -> 256 -> 10, batch 32) written with Tensor
   methods (run as a script's code, so that its two ``x.matmul`` take
   the reference's form, the op through ``run_op``: checked), each loss
   within ``op_corpus.LOSS_RTOL`` of the same steps on the CPU from the
   same weights; its AdamW updates 4 tensors, below the flat update's 9, so
   the path (``readme_quickstart``) launches no hand-written kernel, as
   the reference's runs no Pallas one;
6i. LLaMA's hybrid-parallel step (``experiments/mesh_train.py``): (a) a
   world of one on NCCL, ``create_hybrid_mesh()`` with every degree 1 and
   ``make_sharded_train_step`` from phase 5's initial weights on its B 44
   batch, each of 3 losses equal to phase 5's bit for bit, the flash
   forward and backward 12 times and ``head_dx_softmax`` once a step;
   (b) one world of 4 gloo ranks sharing the card (``spawn``: every join
   under a deadline; a failed rank fails the phase), three layouts in
   turn at ``bert_base_equiv`` width, B 8 x S 512, bf16, remat on, 2
   steps each: dp 2 x mp 2 at ZeRO stage 3, mp 2 x sep 2 with the ring
   and with Ulysses; step 0's loss held to one rank's ``loss_fn`` on the
   same weights, batch and loss arithmetic (``mesh_train.LOSS_ATOL``), and
   each gathered gradient's distance from the same step in fp32 to at
   most ``mesh_train.GRAD_RATIO`` times one bf16 rank's; every rank counts
   its launches from 0 before each layout and asserts the flash forward
   and backward once a layer and step (remat keeps attention outside the
   checkpoint), none for the ring (its chunks plain torch, as in the
   reference), the kernels line taking the four ranks' sum; the flash
   kernels on 6 local heads (dp 2 x mp 2) and on 3 heads of the whole
   sequence (Ulysses), and the calls the collective layer staged through
   the host under gloo counted;
6j. BASELINE config 3, Fleet data-parallel ResNet-50
   (``experiments/fleet_dp.py``), phase 6's configuration and batch in
   the PaddleClas eager loop (``loss.backward(); opt.step();
   opt.clear_grad()``): (a) ``fleet.init(is_collective=True)`` (a world
   of one on NCCL), ``distributed_model`` (the model itself) and
   ``distributed_optimizer``: 3 losses equal to the same loop's without
   Fleet bit for bit under deterministic cuDNN, one
   ``multi_tensor_update`` launch a flat plan and step, the ms a step and
   a profiled step's busy share; (b) 4 gloo ranks sharing the card (B 32
   a rank, the batch split in rank order), ``DataParallel`` through
   ``distributed_model`` with plain BatchNorm, 2 steps: each synced
   gradient against the mean of the four ranks' own (a ``no_sync``
   backward of each quarter, gathered and summed in fp32 in rank order:
   bit for bit, or within the bound of another fp32 sum order), the
   parameters' digests equal on every rank, one fp32 all-reduce a bucket
   and step, one ``multi_tensor_update`` launch a rank and step; (c) the
   same ranks with ``SyncBatchNorm.convert_sync_batchnorm``: step 0's
   loss, gradients and running statistics held to the one-process step on
   all 128 images (each distance from the same step in fp32 at most
   ``fleet_dp.ratio_bar`` times the one-process bf16 step's, the loss
   within ``fleet_dp.LOSS_ATOL``), bars that (b)'s per-rank statistics
   must fail on the loss and the running statistics;
7. the kernel experiments' entry points, as a user runs them
   (``paddle_tpu_torch.experiments.dot_variants`` and ``.flash_variants``
   at the reference's shapes): every blocked tile within two bf16 ulps
   of ``torch.mm``, every flash variant within four bf16 ulps of the
   largest value of the production kernels' outputs and gradients, each
   experiment's kernels launched (the flash variants once a call: 1112
   forward and 786 backward launches), and for each flash-variant
   instance the experiment times, its registers, shared memory and spill
   bytes from the build's ``-Xptxas -v`` report (a D 64 instance that
   spills fails);
8. print the kernels' JSON line, then the result line. Each path of
   3-3k, 5b, 5c, 6, 6b, 6c, 6d, 6e, 6f, 6g, 6h, 6i, 6j and 7 is driven with every launch
   count set to 0 just before it and read just after; a kernel's
   ``launches`` is its sum over those paths (the decode kernel's quant
   mode has no engine caller, as in the JAX package, so its count is 0
   there; the experiments' kernels run on phase 7's paths alone, as in
   the JAX package). ``check_paths`` guards the line: every path's counts
   are a dict of their own, and every kernel launched on each path of
   ``KERNEL_PATHS``, or the script exits non-zero.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. Imports nothing of JAX or of ``paddle_tpu``.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
TF32_OPS = 495e12             # dense TF32 tensor-core rate
PEAK_OPS = {"torch.bfloat16": 989e12,  # dense bf16 tensor-core rate
            "torch.float32": 67e12}    # fp32 outside the tensor cores
VECTOR_OPS = 67e12            # fp32 CUDA-core rate: norms and rope

# tolerances, kernel against its plain version on the same inputs. bf16:
# rtol 1.6e-2 is two bf16 ulps (torch's own bf16 default); atol 2e-2 is one
# ulp at the inputs' magnitude (~4), for outputs that cancel (rope's
# a - b) or sit near 0. fp32: sums run in another order than the plain
# version's, so 1e-5.
TOL = {"torch.bfloat16": (1.6e-2, 2e-2), "torch.float32": (1e-5, 1e-5)}
# teacher-forced logits, bf16 engine path against the plain path: the
# twelve layers' residual streams round at different points (online vs
# full softmax, sum orders), each worth about one bf16 ulp of the stream;
# the budget is 0.15 absolute on logits of magnitude ~4 (~4 % of the
# range), far below the gap that separates distinct greedy tokens on
# average but not on near-ties, which is why token agreement is printed,
# not asserted.
LOGIT_ATOL = 0.15
# lse is fp32, from the same bf16 products summed in another order, with
# exp2/log2 on the card's approximate units: 1e-4
LSE_TOL = 1e-4
# head_dx_softmax's outputs are far below the shared bf16 atol (a row's
# probabilities sum to at most 1 and W is drawn at 1/sqrt(H), so |out| is
# ~1e-2), so its limit is tied to the output's size: atol 2^-7 of the
# largest |output| (two bf16 ulps there) with rtol 1.6e-2, and the
# relative Frobenius error within 1e-2. The output's own bf16 rounding is
# ~2^-9 of it (rms); an output off by 2 % in scale moves it 2 %, and one
# dropped 64-column V tile of 32000 about 1.5 % (the probabilities of
# logits at scale 3 are heavy-tailed, so a tile carries more than 1/500).
HEAD_DX_ATOL_OF_MAX = 2.0 ** -7
HEAD_DX_FRO_RTOL = 1e-2
# the flash variants' base-2 lse, kernel against plain: exp2/log2 on the
# card's units and l summed in another order, on lse of magnitude ~10
VARIANT_LSE_TOL = 1e-3
# the experiments' parity, each flash variant against the production
# kernels (an online softmax on unscaled q with a natural-log lse): the
# variants round q * scale * log2(e) to bf16 and, with exp_bf16, exp2's
# argument, so outputs and gradients may differ by a few bf16 ulps of the
# largest value: 2^-6 of it (four ulps)
PARITY_OF_MAX = 2.0 ** -6
# quant_matmul against its plain version: both fp32, sums over K in
# another order and the scale applied once per column after the sum (the
# plain version scales each weight), a few fp32 ulps of outputs of
# magnitude ~1
QMM_TOL = 1e-4
# quantized serving's bar against its bf16 shadow: the JAX package's
# matched-prefix rate on random-init weights (tests/test_quantized_serving)
MATCHED_PREFIX_FLOOR = 0.5
# phase 3e trains on until its batch's loss is below this: a memorized
# batch, whose continuations the model predicts with margins far above
# quantization's logit error (random weights at vocab 32000 are near-ties
# everywhere, where two bf16 engines already diverge)
MEMO_LOSS = 0.3
# training, bf16 kernel path against the plain path on the same fp32
# master weights and tokens: the loss (~10.4 = ln 32000 at random weights)
# within 2e-2, about one bf16 ulp of a logit at magnitude 4, where the two
# paths' attention outputs round differently; each parameter's gradient
# within 5e-2 of its norm (relative Frobenius error: bf16 keeps 2^-8 per
# element, and the paths' rounding differences pass through twelve
# layers' backward)
TRAIN_LOSS_ATOL = 2e-2
TRAIN_GRAD_RTOL = 5e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def mixed_workload(rng, n, vocab):
    """The offline mixed workload of the serving benchmark: prompt lengths
    32..256 and generation lengths 16..128."""
    lens = rng.choice([32, 48, 64, 96, 128, 192, 256], size=n)
    gens = rng.choice([16, 32, 48, 64, 96, 128], size=n)
    return [(rng.randint(0, vocab, (int(l),)).astype(np.int32), int(g))
            for l, g in zip(lens, gens)]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def eager_ms(torch, fn, n_inputs=1, iters=100):
    """Mean ms per call of ``fn(i)`` issued eagerly, back to back: what a
    call costs the eager decode tick, the host's launch included."""
    from paddle_tpu_torch.experiments._timing import events_ms

    fn(0)
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fn(i % n_inputs)
    return events_ms(run) / iters


# library yardsticks at one shape, timed once per run: (what, shape) -> ms
_YARDSTICKS = {}


def yardstick_ms(key, measure):
    """``measure()``, the ms of a library call, taken once per run for each
    ``key`` (phase 2's flash rows and the flash variants' rows share
    SDPA's times at the bench shape)."""
    if key not in _YARDSTICKS:
        _YARDSTICKS[key] = measure()
    return _YARDSTICKS[key]


def bound_ms(nbytes, ops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check(torch, name, out, ref, dtype, atol_floor=0.0):
    rtol, atol = TOL[str(dtype)]
    atol = max(atol, atol_floor)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = 0.0
    for o, r in zip(outs, refs):
        torch.testing.assert_close(o.float(), r.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{name}: {m}")
        err = max(err, (o.float() - r.float()).abs().max().item())
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

SHAPES = [
    # name, B, nH, Hkv, D, max_len, L (cache layers cycled when timing)
    ("serving", 8, 12, 12, 64, 384, 12),
    ("llama7b", 8, 32, 32, 128, 2048, 4),
    ("gqa", 8, 32, 8, 128, 2048, 4),
    # head dims off 64 and 128: cpu_small's 8 heads of D 16, and D 96 in
    # GQA (the kernels' 32- and 128-wide instances)
    ("d16", 8, 8, 8, 16, 512, 16),
    ("d96", 8, 16, 4, 96, 1024, 8),
]


def timed(torch, name, err, kernel, plain, library, bound, n_inputs=1,
          plain_iters=100):
    """One kernel's row: its error against the plain version, the device
    times of the kernel, the plain version and the library call (None
    where there is none), the kernel's eager per-call time, its bound."""
    from paddle_tpu_torch.experiments._timing import time_ms

    b_ms, b_by = bound
    return dict(
        name=name, max_abs_err=err, ms=time_ms(kernel, n_inputs),
        eager_ms=eager_ms(torch, kernel, n_inputs),
        plain_ms=time_ms(plain, n_inputs, iters=plain_iters),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=(None if library is None
                    else time_ms(library, n_inputs)))


def launch_floor(torch, tf):
    """An empty kernel launched through the norms' host path
    (``tick_fusion.empty_launch``: the stream, one ctypes call, the error
    check): its device ms per launch in CUDA-graph replay (with
    programmatic dependent launch, as the norms, and without) and its
    eager ms per call, the least any launch of the tick's small kernels
    costs."""
    from paddle_tpu_torch.experiments._timing import time_ms

    dev = torch.cuda.current_device()

    def empty(i):
        tf.empty_launch(dev)
    row = {"name": "launch_floor", "shape": "empty", "dtype": "none",
           "ms": time_ms(empty), "eager_ms": eager_ms(torch, empty)}
    tf.set_pdl(False)  # a plain launch: no overlap with the one ahead
    row["ms_without_pdl"] = time_ms(empty)
    tf.set_pdl(True)
    return row


def kernel_checks(torch, F, da, tf, shape, dtype, gen):
    name, B, nH, Hkv, D, max_len, L = shape
    dev = DEVICE
    H = nH * D
    elt = torch.tensor([], dtype=dtype).element_size()
    peak = PEAK_OPS[str(dtype)]

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    rows = []
    x, y = randn(B, H, scale=2.0), randn(B, H, scale=2.0)
    w = (1.0 + 0.1 * torch.randn(H, generator=gen, device=dev)).to(dtype)
    eps = 1e-6

    # fused_rms_norm
    err = check(torch, "fused_rms_norm", tf.fused_rms_norm(x, w, eps),
                tf.rms_norm_plain(x, w, eps), dtype)
    rows.append(timed(
        torch, "fused_rms_norm", err,
        lambda i: tf.fused_rms_norm(x, w, eps),
        lambda i: tf.rms_norm_plain(x, w, eps),
        lambda i: F.rms_norm(x, (H,), w, eps),
        bound_ms((2 * B * H + H) * elt, 4 * B * H, VECTOR_OPS)))

    # fused_add_rms_norm
    err = check(torch, "fused_add_rms_norm",
                tf.fused_add_rms_norm(x, y, w, eps),
                tf.add_rms_norm_plain(x, y, w, eps), dtype)
    rows.append(timed(
        torch, "fused_add_rms_norm", err,
        lambda i: tf.fused_add_rms_norm(x, y, w, eps),
        lambda i: tf.add_rms_norm_plain(x, y, w, eps), None,
        bound_ms((4 * B * H + H) * elt, 5 * B * H, VECTOR_OPS)))

    # fused_rope_qk: positions mixed, including 0 and max_len - 1
    zq, zk = randn(B, H, scale=2.0), randn(B, Hkv * D, scale=2.0)
    pos = torch.randint(0, max_len, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, max_len - 1
    # an angle pos * freq near max_len carries an fp32 rounding of one ulp
    # of max_len; a one-ulp difference in freq (the kernel's libdevice pow
    # against torch's) moves it by that much, so the rotated values may
    # differ by two such ulps times the largest input
    ang_ulp = 2.0 ** (math.floor(math.log2(max_len - 1)) - 23)
    zmax = max(zq.abs().max().item(), zk.abs().max().item())
    err = check(torch, "fused_rope_qk",
                tf.fused_rope_qk(zq, zk, pos, D, 10000.0),
                tf.rope_qk_plain(zq, zk, pos, D, 10000.0), dtype,
                atol_floor=2 * ang_ulp * zmax)
    nz = B * (H + Hkv * D)
    rows.append(timed(
        torch, "fused_rope_qk", err,
        lambda i: tf.fused_rope_qk(zq, zk, pos, D, 10000.0),
        lambda i: tf.rope_qk_plain(zq, zk, pos, D, 10000.0), None,
        bound_ms(2 * nz * elt + 4 * B, 8 * nz, VECTOR_OPS)))

    # ragged_decode_attention over an [L, B, max_len, Hkv, D] cache, one
    # layer per call and the layers cycled, so the cache (113 MB at the
    # serving shape in bf16) exceeds the 50 MB L2 as on the decode tick
    kc = randn(L, B, max_len, Hkv, D)
    vc = randn(L, B, max_len, Hkv, D)
    q = randn(B, nH, D)
    err = check(torch, "ragged_decode_attention",
                da.ragged_decode_attention(q, kc[0], vc[0], pos),
                da.ragged_decode_attention_plain(q, kc[0], vc[0], pos),
                dtype)
    keys = int((pos.long() + 1).sum())
    nbytes = 2 * keys * Hkv * D * elt + 2 * B * nH * D * elt + 4 * B
    mask = (torch.arange(max_len, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    gqa = {"enable_gqa": True} if nH != Hkv else {}

    def sdpa(i):
        return F.scaled_dot_product_attention(
            qs, kc[i].transpose(1, 2), vc[i].transpose(1, 2),
            attn_mask=mask, **gqa)

    ref = da.ragged_decode_attention_plain(q, kc[0], vc[0], pos)
    row = timed(
        torch, "ragged_decode_attention", err,
        lambda i: da.ragged_decode_attention(q, kc[i], vc[i], pos),
        lambda i: da.ragged_decode_attention_plain(q, kc[i], vc[i], pos),
        sdpa, bound_ms(nbytes, 4 * keys * nH * D, peak), n_inputs=L,
        plain_iters=20)
    row["library_max_abs_err"] = (sdpa(0)[:, :, 0].float()
                                  - ref.float()).abs().max().item()
    rows.append(row)
    for r in rows:
        r["shape"], r["dtype"] = name, str(dtype).replace("torch.", "")
    return rows


FLASH_SHAPES = [
    # name, B, S, H, D, causal
    ("bench", 44, 512, 12, 64, True),        # bench.py's training shape
    ("bert", 44, 512, 12, 64, False),        # phase 5c's BERT-base step
    ("llama7b", 1, 2048, 32, 128, True),     # the TPU's blocked regime
    ("noncausal", 8, 1000, 12, 64, False),   # a ragged edge at 64 rows
]
# the fp32 instance (csrc/flash_attention_f32.cu): 3xTF32 on the tensor
# cores, so its bound counts three TF32 passes at the TF32 rate; the fp32
# CUDA-core bound (one pass at 67 TFLOP/s) is kept beside it
FLASH_F32_SHAPES = [
    # name, B, Sq, Sk, H, D, causal
    ("bert", 8, 512, 512, 12, 64, False),    # phase 6c's eager fp32 step
    ("cross", 8, 384, 512, 12, 64, False),   # cross attention, Sq != Sk
    ("d128_causal", 2, 1024, 1024, 8, 128, True),
]
# fp32 kernel against its plain version: ROADMAP's fp32 bar on outputs
# and gradients (sums in another order, exp2 of running maxima)
FLASH_F32_ATOL = 1e-4


def sdpa_ms(torch, F, q, k, v, do, causal):
    """SDPA's forward and backward ms (the flash rows' yardsticks) on
    [B, S, H, D] inputs, once per run for each shape."""
    from paddle_tpu_torch.experiments._timing import backward_ms, time_ms

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    key = (*q.shape, k.shape[1], str(q.dtype), causal)
    fwd = yardstick_ms(("sdpa forward", key), lambda: time_ms(
        lambda i: F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)))
    bwd = yardstick_ms(("sdpa backward", key), lambda: backward_ms(
        lambda *t: F.scaled_dot_product_attention(*t, is_causal=causal),
        (qt, kt, vt), do.transpose(1, 2).contiguous()))
    return fwd, bwd


def flash_checks(torch, F, fa, shape, gen):
    """The forward kernel and the backward kernel (dq, dk and dv in one
    launch, and each role alone) at one shape against their plain versions
    (the backward gets the plain forward's out, lse and delta; the
    one-launch gradients must equal the role launches' bit for bit), timed
    beside SDPA: its forward, and its backward (dq, dk and dv in one call),
    both as CUDA-graph replays like the kernels."""
    name, B, S, H, D, causal = shape
    dt = torch.bfloat16

    def randn():
        return torch.randn(B, S, H, D, generator=gen, device=DEVICE).to(dt)

    q, k, v, do = randn(), randn(), randn(), randn()
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    err_f = check(torch, "flash_attention_fwd", out, ref, dt)
    torch.testing.assert_close(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL)
    lse_err = (lse - ref_lse).abs().max().item()
    delta = fa.attention_delta(ref, do)
    bwd = (q, k, v, do, ref_lse, delta, causal)
    grads = fa.flash_attention_bwd(*bwd)
    err_b = check(torch, "flash_attention_bwd", grads,
                  fa.flash_attention_bwd_grads_plain(*bwd), dt)
    dq = fa.flash_attention_bwd_dq(*bwd)
    dkv = fa.flash_attention_bwd_dkv(*bwd)
    err_q = check(torch, "flash_attention_bwd_dq", dq,
                  fa.flash_attention_bwd_dq_plain(*bwd), dt)
    err_kv = check(torch, "flash_attention_bwd_dkv", dkv,
                   fa.flash_attention_bwd_dkv_plain(*bwd), dt)
    if not all(torch.equal(g, r) for g, r in zip(grads, (dq, *dkv))):
        raise AssertionError(f"flash_attention_bwd at {name}: the one-launch "
                             f"gradients differ from the role launches'")

    # bound: q, k, v, do read once, outputs written once, lse and delta
    # fp32; operations 2 * D per visible (query, key) pair and product
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    n = B * S * H * D * 2
    stats = 2 * B * H * S * 4
    peak = PEAK_OPS[str(dt)]

    rows = [
        timed(torch, "flash_attention_fwd", err_f,
              lambda i: fa.flash_attention_fwd(q, k, v, causal),
              lambda i: fa.flash_attention_fwd_plain(q, k, v, causal), None,
              bound_ms(4 * n + stats // 2, 4 * D * pairs, peak),
              plain_iters=3),
        timed(torch, "flash_attention_bwd", err_b,
              lambda i: fa.flash_attention_bwd(*bwd),
              lambda i: fa.flash_attention_bwd_grads_plain(*bwd), None,
              bound_ms(7 * n + stats, 10 * D * pairs, peak), plain_iters=3),
        timed(torch, "flash_attention_bwd_dq", err_q,
              lambda i: fa.flash_attention_bwd_dq(*bwd),
              lambda i: fa.flash_attention_bwd_dq_plain(*bwd), None,
              bound_ms(5 * n + stats, 6 * D * pairs, peak), plain_iters=3),
        timed(torch, "flash_attention_bwd_dkv", err_kv,
              lambda i: fa.flash_attention_bwd_dkv(*bwd),
              lambda i: fa.flash_attention_bwd_dkv_plain(*bwd), None,
              bound_ms(6 * n + stats, 8 * D * pairs, peak), plain_iters=3)]
    rows[0]["lse_max_abs_err"] = lse_err
    rows[1]["bit_identical_to_role_launches"] = True
    lib_fwd, lib_bwd = sdpa_ms(torch, F, q, k, v, do, causal)
    for r in rows[1:]:
        r["library_ms"] = lib_bwd
        r["library"] = "sdpa backward (dq, dk and dv in one call)"
    rows[0]["library_ms"] = lib_fwd
    rows[0]["library"] = "sdpa forward"
    for r in rows:
        r["shape"], r["dtype"] = name, "bfloat16"
    return rows


def flash_f32_checks(torch, F, fa, shape, gen):
    """The fp32 instance's forward, one-launch backward and each role
    alone at one shape against the plain versions (atol
    ``FLASH_F32_ATOL``; the one-launch gradients equal the role launches'
    bit for bit), timed beside SDPA's forward and backward on the same
    fp32 inputs. ``bound_ms``: three TF32 passes of the products at the
    TF32 tensor-core rate, or the bytes, whichever is larger;
    ``cuda_core_bound_ms``: one pass at the fp32 CUDA-core rate."""
    name, B, Sq, Sk, H, D, causal = shape
    dt = torch.float32

    def randn(S):
        return torch.randn(B, S, H, D, generator=gen, device=DEVICE)

    q, k, v, do = randn(Sq), randn(Sk), randn(Sk), randn(Sq)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()

    def err(got, want, what):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        worst = 0.0
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=FLASH_F32_ATOL,
                                       msg=lambda m: f"{what}: {m}")
            worst = max(worst, (g - w).abs().max().item())
        return worst

    err_f = err(out, ref, "flash_attention_fwd fp32")
    lse_err = err(lse, ref_lse, "flash_attention_fwd fp32 lse")
    bwd = (q, k, v, do, ref_lse, fa.attention_delta(ref, do), causal)
    grads = fa.flash_attention_bwd(*bwd)
    err_b = err(grads, fa.flash_attention_bwd_grads_plain(*bwd),
                "flash_attention_bwd fp32")
    dq = fa.flash_attention_bwd_dq(*bwd)
    dkv = fa.flash_attention_bwd_dkv(*bwd)
    err_q = err(dq, fa.flash_attention_bwd_dq_plain(*bwd),
                "flash_attention_bwd_dq fp32")
    err_kv = err(dkv, fa.flash_attention_bwd_dkv_plain(*bwd),
                 "flash_attention_bwd_dkv fp32")
    if not all(torch.equal(g, r) for g, r in zip(grads, (dq, *dkv))):
        raise AssertionError(f"flash_attention_bwd fp32 at {name}: the "
                             f"one-launch gradients differ from the role "
                             f"launches'")
    # bound: inputs read once, outputs written once, 4 bytes each; lse and
    # delta fp32; 2 * D operations a visible pair and product
    pairs = B * H * ((Sq * (Sq + 1) // 2 + (Sk - Sq) * Sq) if causal
                     else Sq * Sk)
    nq, nk = B * Sq * H * D * 4, B * Sk * H * D * 4
    stats = 2 * B * H * Sq * 4
    work = {  # name: (bytes, operations), its kernel and its plain version
        "flash_attention_fwd_f32": (
            2 * nq + 2 * nk + stats // 2, 4 * D * pairs,
            lambda i: fa.flash_attention_fwd(q, k, v, causal),
            lambda i: fa.flash_attention_fwd_plain(q, k, v, causal)),
        "flash_attention_bwd_f32": (
            3 * nq + 4 * nk + stats, 10 * D * pairs,
            lambda i: fa.flash_attention_bwd(*bwd),
            lambda i: fa.flash_attention_bwd_grads_plain(*bwd)),
        "flash_attention_bwd_dq_f32": (
            3 * nq + 2 * nk + stats, 6 * D * pairs,
            lambda i: fa.flash_attention_bwd_dq(*bwd),
            lambda i: fa.flash_attention_bwd_dq_plain(*bwd)),
        "flash_attention_bwd_dkv_f32": (
            2 * nq + 4 * nk + stats, 8 * D * pairs,
            lambda i: fa.flash_attention_bwd_dkv(*bwd),
            lambda i: fa.flash_attention_bwd_dkv_plain(*bwd))}
    errs = (max(err_f, lse_err), err_b, err_q, err_kv)
    rows = []
    for (kname, (nbytes, ops, kernel, plain)), e in zip(work.items(), errs):
        r = timed(torch, kname, e, kernel, plain, None,
                  bound_ms(nbytes, 3 * ops, TF32_OPS), plain_iters=3)
        r["bound_peak"] = ("3xTF32: three TF32 passes at the TF32 "
                           "tensor-core rate (495 TFLOP/s)")
        r["cuda_core_bound_ms"], r["cuda_core_bound_by"] = bound_ms(
            nbytes, ops, VECTOR_OPS)
        rows.append(r)
    lib_fwd, lib_bwd = sdpa_ms(torch, F, q, k, v, do, causal)
    rows[0]["library_ms"], rows[0]["library"] = lib_fwd, "sdpa forward fp32"
    for r in rows[1:]:
        r["library_ms"] = lib_bwd
        r["library"] = "sdpa backward fp32 (dq, dk and dv in one call)"
    for r in rows:
        r["shape"], r["dtype"] = name, "float32"
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["cuda_core_bound_share"] = r["cuda_core_bound_ms"] / r["ms"]
    rows[1]["bit_identical_to_role_launches"] = True
    return rows


def head_dx_checks(torch, hd, gen, M=22528, V=32000, H=768):
    """``head_dx_softmax`` at the CE tail's shape (bench.py's B 44 x S 512
    rows, the vocabulary, the hidden width) against its plain version,
    beside the GEMM alone on precomputed bf16 probabilities."""
    from paddle_tpu_torch.experiments._timing import time_ms

    dt = torch.bfloat16
    logits = (torch.randn(M, V, generator=gen, device=DEVICE) * 3).to(dt)
    m = logits.float().max(-1).values
    se = torch.exp(logits.float() - m[:, None]).sum(-1)
    scale = torch.rand(M, generator=gen, device=DEVICE) / se
    w = (torch.randn(H, V, generator=gen, device=DEVICE)
         / math.sqrt(H)).to(dt)
    out = hd.head_dx_softmax(logits, m, scale, w)
    ref = hd.head_dx_softmax_plain(logits, m, scale, w)
    torch.cuda.synchronize()
    ref_max = ref.float().abs().max().item()
    atol = HEAD_DX_ATOL_OF_MAX * ref_max
    torch.testing.assert_close(
        out.float(), ref.float(), rtol=TOL[str(dt)][0], atol=atol,
        msg=lambda m: f"head_dx_softmax: {m}")
    err = (out.float() - ref.float()).abs().max().item()
    fro = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    if not fro <= HEAD_DX_FRO_RTOL:
        raise AssertionError(f"head_dx_softmax: relative Frobenius error "
                             f"{fro} > {HEAD_DX_FRO_RTOL}")
    del ref
    p = (torch.exp(torch.clamp(logits.float() - m[:, None], max=0.0))
         * scale[:, None]).to(dt)
    row = timed(torch, "head_dx_softmax", err,
                lambda i: hd.head_dx_softmax(logits, m, scale, w),
                lambda i: hd.head_dx_softmax_plain(logits, m, scale, w),
                None, bound_ms(M * V * 2 + 2 * M * 4 + H * V * 2 + M * H * 2,
                               2 * M * V * H, PEAK_OPS[str(dt)]),
                plain_iters=3)
    row["gemm_only_ms"] = time_ms(lambda i: p @ w.t(), iters=20)
    row.update(shape="ce_tail", dtype="bfloat16", out_abs_max=ref_max,
               atol=atol, rtol=TOL[str(dt)][0], fro_rel_err=fro,
               fro_rtol=HEAD_DX_FRO_RTOL)
    return row


PAGED_SHAPES = [
    # name, B, Tq, nH, Hkv, D, max_pages, ctx (None: mixed, 0 and the
    # window's last row included), q_len (None: every row)
    ("serving_decode", 8, 1, 12, 12, 64, 24, None, None),
    ("serving_prefill_ctx0", 1, 256, 12, 12, 64, 24, [0], None),
    ("serving_prefill_ctx192", 1, 256, 12, 12, 64, 24, [192], None),
    ("llama7b_decode", 8, 1, 32, 32, 128, 128, None, None),
    ("gqa_decode", 8, 1, 32, 8, 128, 128, None, None),
    ("mixed_q_len", 4, 16, 12, 12, 64, 24, [0, 5, 200, 370],
     [1, 16, 9, 1]),
    # admits past 256 rows (an engine at max_len 2048), at llama7b width
    ("llama7b_prefill_512", 1, 512, 32, 32, 128, 40, [0], None),
    ("llama7b_prefill_2048", 1, 2048, 32, 32, 128, 128, [0], None),
    # head dims off 64 and 128, decode ticks and prefills past a page
    ("d16_decode", 8, 1, 8, 8, 16, 32, None, None),
    ("d16_prefill", 1, 256, 8, 8, 16, 32, [64], None),
    ("d96_decode", 8, 1, 16, 4, 96, 64, None, None),
    ("d96_prefill", 1, 256, 16, 4, 96, 64, [64], None),
    # phase 3h's shapes: verify ticks of K + 1 rows a slot (K = 8 crosses
    # into the prefill family), a prefill chunk off the page grid, an sp
    # slab of 2 x 64 rows near the end of a 2048-row window
    ("verify_k1", 8, 2, 12, 12, 64, 24, None, None),
    ("verify_k4", 8, 5, 12, 12, 64, 24, None, None),
    ("verify_k7", 8, 8, 12, 12, 64, 24, None, None),
    ("verify_k8", 8, 9, 12, 12, 64, 24, None, None),
    ("chunk64_at77", 1, 64, 12, 12, 64, 24, [77], None),
    ("sp2_slab64", 2, 64, 12, 12, 64, 128, [1900, 1964], None),
]
PAGE = 16
L2_BYTES = 50e6


def paged_checks(torch, F, pa, shape, dtype, gen):
    """``ragged_paged_attention`` at one shape: the pool is stacked over
    enough layers to exceed twice the L2 cache, and the timed calls cycle
    the layers, as the engine's layers do."""
    from paddle_tpu_torch.experiments._timing import time_ms

    name, B, Tq, nH, Hkv, D, max_pages, ctx, q_len = shape
    dev = DEVICE
    W = max_pages * PAGE
    P = B * max_pages + 1
    elt = torch.tensor([], dtype=dtype).element_size()
    layer_bytes = 2 * P * PAGE * Hkv * D * elt
    L = max(2, min(128, math.ceil(2 * L2_BYTES / layer_bytes)))
    kp = (torch.randn(L, P, PAGE, Hkv, D, generator=gen, device=dev)
          .to(dtype))
    vp = (torch.randn(L, P, PAGE, Hkv, D, generator=gen, device=dev)
          .to(dtype))
    q = torch.randn(B, Tq, nH, D, generator=gen, device=dev).to(dtype)
    pt = (torch.randperm(P - 1, generator=gen, device=dev)[:B * max_pages]
          + 1).to(torch.int32).reshape(B, max_pages)
    if ctx is None:
        c = torch.randint(0, W, (B,), generator=gen, device=dev)
        c[0], c[-1] = 0, W - 1
    else:
        c = torch.tensor(ctx, device=dev)
    c = c.to(torch.int32)
    ql = None if q_len is None else torch.tensor(q_len, dtype=torch.int32,
                                                 device=dev)
    rows = [Tq] * B if q_len is None else q_len
    ctx_h = c.tolist()

    def kernel(i):
        return pa.ragged_paged_attention(q, kp[i], vp[i], pt, c, ql)

    def plain(i):
        return pa.ragged_paged_attention_plain(q, kp[i], vp[i], pt, c, ql)

    out, ref = kernel(0), plain(0)
    torch.cuda.synchronize()
    err = 0.0
    for b in range(B):  # rows at or past q_len are padding
        err = max(err, check(torch, f"ragged_paged_attention {name}",
                             out[b, :rows[b]], ref[b, :rows[b]], dtype))
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"ragged_paged_attention {name}: non-finite")

    # the same function as two library calls: gather the slot's pages,
    # then SDPA with the causal mask in virtual positions
    idx = pt.long()
    qpos = c.long()[:, None] + torch.arange(Tq, device=dev)       # [B, Tq]
    mask = (torch.arange(W, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]                       # [B,1,Tq,W]
    gqa = {"enable_gqa": True} if nH != Hkv else {}

    def gather_sdpa(i):
        gk = kp[i][idx].reshape(B, W, Hkv, D).transpose(1, 2)
        gv = vp[i][idx].reshape(B, W, Hkv, D).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), gk, gv, attn_mask=mask, **gqa).transpose(1, 2)

    lib = gather_sdpa(0)
    lib_err = max((lib[b, :rows[b]].float() - ref[b, :rows[b]].float())
                  .abs().max().item() for b in range(B))
    # bound: each visible K/V row read once, q read and out written once;
    # 4 operations per (query row, visible key, head, dim): two products
    keys = sum(min(ctx_h[b] + rows[b], W) for b in range(B))
    pairs = sum(min(ctx_h[b] + t + 1, W) for b in range(B)
                for t in range(rows[b]))
    nbytes = (2 * keys * Hkv * D * elt + 2 * B * Tq * nH * D * elt
              + 4 * B * (max_pages + 2))
    row = timed(torch, "ragged_paged_attention", err, kernel, plain, None,
                bound_ms(nbytes, 4 * pairs * nH * D, PEAK_OPS[str(dtype)]),
                n_inputs=L, plain_iters=20)
    row["gather_sdpa_ms"] = time_ms(gather_sdpa, L, iters=20)
    row["gather_sdpa_max_abs_err"] = lib_err
    row["shape"], row["dtype"] = name, str(dtype).replace("torch.", "")
    row["pages_read"] = sum(min(pa.pages_read(ctx_h[b], rows[b], PAGE),
                                max_pages) for b in range(B))
    return row


QMM_SHAPES = [
    # name, B, K, N: the decode tick's projections (B = 8 slots), the
    # admit's and the tick's lm_head, and two ragged edges (N no multiple
    # of the 64-column block; then no multiple of 8 either, K of the
    # 256-row chunk)
    ("wq_wk_wv_wo", 8, 768, 768),
    ("w_gate_w_up", 8, 768, 3072),
    ("w_down", 8, 3072, 768),
    ("lm_head_admit", 1, 768, 32000),
    ("lm_head_tick", 8, 768, 32000),
    ("ragged_n", 8, 768, 1000),
    ("ragged_nk", 8, 770, 999),
]


def quant_matmul_checks(torch, qm, qs, mode, shape, gen):
    """``quant_matmul`` at one shape against its plain version, timed
    beside dequantize + ``torch.mm`` in bf16 (the two-call library path,
    which rounds the dequantized weights to bf16); the weight is one of
    enough copies to exceed twice the L2 cache, cycled, as the engine's
    layers are."""
    name, B, K, N = shape
    dt = torch.bfloat16
    copies = max(2, min(64, math.ceil(2 * L2_BYTES / (K * N))))
    ws, scs = [], []
    for _ in range(copies):
        w, sc = qs.quantize_weight(
            torch.randn(K, N, generator=gen, device=DEVICE) / math.sqrt(K),
            mode)
        ws.append(w)
        scs.append(sc)
    x = torch.randn(B, K, generator=gen, device=DEVICE).to(dt)
    out = qm.quant_matmul(x, ws[0], scs[0])
    ref = qm.quant_matmul_plain(x, ws[0], scs[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=QMM_TOL, atol=QMM_TOL,
                               msg=lambda m: f"quant_matmul {name}: {m}")
    err = (out - ref).abs().max().item()

    def library(i):
        return torch.mm(x, ws[i].to(dt) * scs[i].to(dt))

    lib_err = (library(0).float() - ref).abs().max().item()
    # bound: each weight byte, scale, x and output element once; 2 B K N
    # operations at the bf16 tensor-core rate (bytes bound it here)
    row = timed(torch, "quant_matmul", err,
                lambda i: qm.quant_matmul(x, ws[i], scs[i]),
                lambda i: qm.quant_matmul_plain(x, ws[i], scs[i]), library,
                bound_ms(K * N + 4 * N + 2 * B * K + 4 * B * N,
                         2 * B * K * N, PEAK_OPS[str(dt)]),
                n_inputs=copies, plain_iters=20)
    row.update(shape=name, dtype=mode, B=B, K=K, N=N,
               library="dequantize (bf16) + torch.mm, two calls",
               library_max_abs_err=lib_err)
    return row


DECODE_QUANT_SHAPES = [s for s in SHAPES if s[0] in ("serving", "llama7b")]


def decode_quant_checks(torch, F, da, qs, mode, shape, gen):
    """``ragged_decode_attention``'s quant mode at one shape, bf16 q, an
    [L, B, max_len, Hkv, D] narrow cache with its row scales (layers
    cycled, as in ``kernel_checks``), against its plain version and beside
    dequantize + SDPA."""
    name, B, nH, Hkv, D, max_len, L = shape
    dt = torch.bfloat16
    qdt = qs.quant_dtype(mode)
    kc, ks = qs.quantize_kv_rows(torch.randn(
        L, B, max_len, Hkv, D, generator=gen, device=DEVICE), qdt)
    vc, vs = qs.quantize_kv_rows(torch.randn(
        L, B, max_len, Hkv, D, generator=gen, device=DEVICE), qdt)
    q = torch.randn(B, nH, D, generator=gen, device=DEVICE).to(dt)
    pos = torch.randint(0, max_len, (B,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, max_len - 1

    def kernel(i):
        return da.ragged_decode_attention(q, kc[i], vc[i], pos, ks[i], vs[i])

    def plain(i):
        return da.ragged_decode_attention_plain(q, kc[i], vc[i], pos, ks[i],
                                                vs[i])

    out, ref = kernel(0), plain(0)
    torch.cuda.synchronize()
    err = check(torch, f"ragged_decode_attention quant {mode} {name}", out,
                ref, dt)
    mask = (torch.arange(max_len, device=DEVICE)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    gqa = {"enable_gqa": True} if nH != Hkv else {}

    def library(i):
        kd = kc[i].to(dt) * ks[i][..., None, None].to(dt)
        vd = vc[i].to(dt) * vs[i][..., None, None].to(dt)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, **gqa)

    lib_err = (library(0)[:, :, 0].float() - ref.float()).abs().max().item()
    keys = int((pos.long() + 1).sum())
    nbytes = (2 * keys * (Hkv * D + 4) + 2 * B * nH * D * 2 + 4 * B)
    row = timed(torch, "ragged_decode_attention_quant", err, kernel, plain,
                library, bound_ms(nbytes, 4 * keys * nH * D,
                                  PEAK_OPS[str(dt)]),
                n_inputs=L, plain_iters=20)
    row.update(shape=name, dtype=mode, q_dtype="bfloat16",
               library="dequantize (bf16) + SDPA",
               library_max_abs_err=lib_err)
    return row


# ---------------------------------------------------------------------------
# phase 2: multi_tensor_update
# ---------------------------------------------------------------------------

# multi_tensor_update at ResNet-50's parameter population (161 tensors in
# parameters() order). Kernel against plain on the same buffers: both round
# once per operation in the buffer's type; the bias corrections (powf on
# the card, torch.pow on the host) may differ in the last bit, so fp32 to
# rtol 1e-6 and bf16 to one ulp (rtol 2^-7), atol 1e-7 for entries near 0
MTU_TOL = {"torch.float32": (1e-6, 1e-7), "torch.bfloat16": (2.0 ** -7, 1e-7)}
_ADAM = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
MTU_VARIANTS = [
    # name, kind, hyper, param dtype, state dtype, master, library yardstick
    ("momentum_bf16", "momentum", {"momentum": 0.9}, "bfloat16",
     "bfloat16", False, "sgd"),
    ("momentum_fp32", "momentum", {"momentum": 0.9}, "float32", "float32",
     False, "sgd"),
    ("nesterov_bf16", "momentum", {"momentum": 0.9, "nesterov": True},
     "bfloat16", "bfloat16", False, "sgd"),
    ("sgd_bf16", "sgd", {}, "bfloat16", None, False, "sgd"),
    ("adamw_bf16_master", "adam", dict(_ADAM, decay=0.01, decoupled=True),
     "bfloat16", "float32", True, "adamw"),
    ("lamb_fp32", "lamb", dict(_ADAM, epsilon=1e-6, decay=0.01), "float32",
     "float32", False, None),
]
_MTU_STATE = {"sgd": (), "momentum": ("velocity",),
              "adam": ("moment1", "moment2"), "lamb": ("moment1", "moment2")}


def param_shapes(device_mod, build):
    """The parameter shapes of the model ``build()`` makes, in
    ``parameters()`` order (built on the CPU: only the shapes are kept)."""
    prev = device_mod.set_device("cpu")
    try:
        model = build()
    finally:
        device_mod.set_device(prev)
    return [tuple(p.shape) for p in model.parameters()]


def _mtu_buffers(torch, plan, shapes, kind, pdt, sdt, master, gen):
    """Params, grads and state of one group, packed by ``plan`` (tail lanes
    and rows zero), from a seeded generator."""
    def packed(scale, dtype, positive=False):
        ts = [torch.randn(s, generator=gen, device=DEVICE) * scale
              for s in shapes]
        return plan.pack([t.abs() if positive else t for t in ts],
                         dtype=dtype)

    pbuf, gbuf = packed(0.1, pdt), packed(0.01, pdt)
    sbufs = {k: packed(0.01, sdt, positive=True) for k in _MTU_STATE[kind]}
    if master:
        sbufs["master"] = pbuf.float()
    return pbuf, gbuf, sbufs


def _clone(bufs):
    p, g, s = bufs
    return p.clone(), g.clone(), {k: v.clone() for k, v in s.items()}


def multi_tensor_checks(torch, mtu, shapes, variant, gen,
                        shape_name="resnet50"):
    """One ``multi_tensor_update`` variant at a parameter population
    (ResNet-50's unless named): the
    kernel against its plain version on the same buffers (padding stays
    zero), then the kernel (in place, over and over), its plain version
    and, where one PyTorch call makes the same update on the shaped list,
    that call, timed. Bound: each buffer the kernel reads read once, each
    one it writes written once, over the parameters' own elements (the
    plan's padding lanes and rows are the kernel's choice, not the
    update's work)."""
    name, kind, hyper, pdt, sdt, master, lib = variant
    pdt = getattr(torch, pdt)
    sdt = getattr(torch, sdt) if sdt else None
    plan = mtu.FlatPlan(shapes)
    bufs = _mtu_buffers(torch, plan, shapes, kind, pdt, sdt, master, gen)
    kb, pb = _clone(bufs), _clone(bufs)
    r_k = mtu.multi_tensor_update(kind, *kb, hyper, 0.1, 3)
    r_p = mtu.flat_update_plain(kind, *pb, hyper, 0.1, 3)
    torch.cuda.synchronize()
    outs = [("p", kb[0], pb[0])] + [(k, kb[2][k], pb[2][k]) for k in kb[2]]
    if r_k is not None:
        outs.append(("r", r_k, r_p))
    err = 0.0
    used = torch.zeros(plan.total_rows * plan.LANES, dtype=torch.bool,
                       device=DEVICE)
    for i, n in enumerate(plan.sizes):
        r0 = int(plan.row_offsets[i]) * plan.LANES
        used[r0:r0 + n] = True
    for key, got, want in outs:
        rtol, atol = MTU_TOL[str(want.dtype)]
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name} {key}: {m}")
        err = max(err, (got.float() - want.float()).abs().max().item())
        if got.reshape(-1)[~used].any():
            raise AssertionError(f"{name} {key}: padding is not zero")
    elems = sum(plan.sizes)
    st = bufs[2]
    if kind == "lamb":  # reads the master or p, writes the moments and r
        reads = [st.get("master", bufs[0]), bufs[1], st["moment1"],
                 st["moment2"]]
        writes = [st["moment1"], st["moment2"], r_k]
    else:
        reads = [bufs[0], bufs[1], *st.values()]
        writes = [bufs[0], *st.values()]
    nbytes = sum(b.element_size() for b in reads + writes) * elems
    library = None
    if lib is not None:
        P = [torch.randn(s, generator=gen, device=DEVICE) * 0.1
             for s in shapes]
        G = [torch.randn(s, generator=gen, device=DEVICE) * 0.01
             for s in shapes]
        if lib == "sgd":
            P, G = [t.to(pdt) for t in P], [t.to(pdt) for t in G]
            V = [torch.zeros_like(t) for t in P] if kind == "momentum" else []

            def library(i):
                torch._fused_sgd_(
                    P, G, V, weight_decay=0.0,
                    momentum=hyper.get("momentum", 0.0), lr=0.1,
                    dampening=0.0, nesterov=bool(hyper.get("nesterov")),
                    maximize=False, is_first_step=False)
        elif lib == "adam":  # Adam on the fp32 shaped list: 28 B each
            M = [torch.zeros_like(t) for t in P]
            V2 = [torch.zeros_like(t) for t in P]
            steps = [torch.tensor(3.0, device=DEVICE) for _ in P]

            def library(i):
                torch._fused_adam_(
                    P, G, M, V2, [], steps, lr=0.1, beta1=0.9, beta2=0.999,
                    weight_decay=0.0, eps=1e-8, amsgrad=False,
                    maximize=False)
        else:  # AdamW on the fp32 master list: 28 B per element to our 30
            M = [torch.zeros_like(t) for t in P]
            V2 = [torch.zeros_like(t) for t in P]
            steps = [torch.tensor(3.0, device=DEVICE) for _ in P]

            def library(i):
                torch._fused_adamw_(
                    P, G, M, V2, [], steps, lr=0.1, beta1=0.9, beta2=0.999,
                    weight_decay=0.01, eps=1e-8, amsgrad=False,
                    maximize=False)
    row = timed(torch, "multi_tensor_update", err,
                lambda i: mtu.multi_tensor_update(kind, *kb, hyper, 0.1, 3),
                lambda i: mtu.flat_update_plain(kind, *pb, hyper, 0.1, 3),
                library, bound_ms(nbytes, 12 * elems, VECTOR_OPS),
                plain_iters=20)
    row.update(shape=shape_name, dtype=name, elements=elems,
               padded_elements=plan.total_rows * plan.LANES,
               bytes_per_element=nbytes / elems,
               library={"sgd": "torch._fused_sgd_ on the shaped list",
                        "adam": "torch._fused_adam_ on the shaped list",
                        "adamw": "torch._fused_adamw_ on the fp32 master "
                                 "list"}.get(lib, "none"))
    return row


def multi_tensor_skip_check(torch, mtu, shapes, gen):
    """skip = 1 (a device float the kernel reads): every buffer of every
    kind stays bit-identical."""
    out = {}
    for name, kind, hyper, pdt, sdt, master, _ in MTU_VARIANTS:
        plan = mtu.FlatPlan(shapes)
        bufs = _mtu_buffers(torch, plan, shapes, kind,
                            getattr(torch, pdt),
                            getattr(torch, sdt) if sdt else None, master, gen)
        kb = _clone(bufs)
        mtu.multi_tensor_update(kind, *kb, hyper, 0.1, 3,
                                skip=torch.ones((), device=DEVICE))
        torch.cuda.synchronize()
        same = torch.equal(kb[0], bufs[0]) and all(
            torch.equal(kb[2][k], v) for k, v in bufs[2].items())
        if not same:
            raise AssertionError(f"{name}: skip = 1 changed a buffer")
        out[name] = same
    return out


# ---------------------------------------------------------------------------
# phase 2: the kernel experiments' kernels
# ---------------------------------------------------------------------------

def blocked_matmul_checks(torch, bm, gen, M=22528, K=32000, N=768):
    """Every tile instance of ``blocked_matmul`` at the experiment's shape
    (the lm_head dx at the padded M) against its plain version, beside
    ``torch.mm`` (cuBLAS)."""
    from paddle_tpu_torch.experiments._timing import time_ms

    dt = torch.bfloat16
    a = torch.randn(M, K, generator=gen, device=DEVICE).to(dt)
    b = torch.randn(K, N, generator=gen, device=DEVICE).to(dt)
    mm = a @ b
    mm_ms = time_ms(lambda i: a @ b)
    rows = []
    for tile in bm.TILES:
        out = bm.blocked_matmul(a, b, *tile)
        ref = bm.blocked_matmul_plain(a, b, tile[2])
        torch.cuda.synchronize()
        err = check(torch, "blocked_matmul", out, ref, dt)
        del ref
        row = timed(torch, "blocked_matmul", err,
                    lambda i, t=tile: bm.blocked_matmul(a, b, *t),
                    lambda i, t=tile: bm.blocked_matmul_plain(a, b, t[2]),
                    None, bound_ms(2 * (M * K + K * N + M * N),
                                   2 * M * N * K, PEAK_OPS[str(dt)]),
                    plain_iters=2)
        row.update(shape="lm_head_dx", dtype="bm{}_bn{}_bk{}".format(*tile),
                   mm_max_abs_err=(out.float() - mm.float()).abs().max()
                   .item(), library_ms=mm_ms, library="torch.mm")
        rows.append(row)
    return rows


def _of_max(torch, name, out, ref):
    """bf16 to two ulps with the atol of two ulps of the largest |ref|
    (the ablations' outputs reach ~1e9: exp2 of unscaled scores)."""
    rtol = TOL["torch.bfloat16"][0]
    return check(torch, name, out, ref, torch.bfloat16,
                 atol_floor=rtol * ref.float().abs().max().item())


def variant_matrix(torch, fv, gen, B=4, S=512, H=12, D=64):
    """Every flash-variant instance at B 4 against its plain version:
    run_fwd and run_bwd (causal and not, nsplit 1, 2, 4, exp_bf16),
    run_fwd2 (p_bf16, in-kernel scale), the twelve ablations. Returns the
    largest errors by entry."""
    dt = torch.bfloat16

    def randn():
        return torch.randn(B, S, H, D, generator=gen, device=DEVICE).to(dt)

    q, k, v, do = randn(), randn(), randn(), randn()
    err = {"run_fwd": 0.0, "run_fwd_lse": 0.0, "run_bwd": 0.0,
           "run_fwd2": 0.0, "fwd_diag": 0.0, "bwd_diag": 0.0}

    def note(key, e):
        err[key] = max(err[key], e)

    for causal in (True, False):
        for nsplit in (1, 2, 4):
            for ebf in (False, True):
                out, lse = fv.run_fwd(q, k, v, causal, nsplit, ebf)
                ref, ref_lse = fv.run_fwd_plain(q, k, v, causal, nsplit, ebf)
                torch.cuda.synchronize()
                note("run_fwd", check(torch, "flash_variants_fwd", out, ref,
                                      dt))
                torch.testing.assert_close(lse, ref_lse, rtol=VARIANT_LSE_TOL,
                                           atol=VARIANT_LSE_TOL)
                note("run_fwd_lse", (lse - ref_lse).abs().max().item())
                args = (q, k, v, do, ref, ref_lse, causal, nsplit, ebf)
                note("run_bwd", check(torch, "flash_variants_bwd",
                                      fv.run_bwd(*args),
                                      fv.run_bwd_plain(*args), dt))
        for p_bf16, scale_in in ((True, False), (False, True), (True, True)):
            args = (q, k, v, causal, 1, p_bf16, scale_in)
            out, lse = fv.run_fwd2(*args)
            ref, ref_lse = fv.run_fwd2_plain(*args)
            note("run_fwd2", check(torch, "flash_variants_fwd", out, ref, dt))
            torch.testing.assert_close(lse, ref_lse, rtol=VARIANT_LSE_TOL,
                                       atol=VARIANT_LSE_TOL)
    for drop in fv.FWD_DROPS:
        out, lse = fv.fwd_diag(q, k, v, drop)
        ref, ref_lse = fv.fwd_diag_plain(q, k, v, drop)
        note("fwd_diag", _of_max(torch, "flash_variants_fwd", out, ref))
        torch.testing.assert_close(lse, ref_lse, rtol=VARIANT_LSE_TOL,
                                   atol=VARIANT_LSE_TOL)
    o, lse = fv.run_fwd_plain(q, k, v)
    for drop in fv.BWD_DROPS:
        args = (q, k, v, do, o, lse, drop)
        for g, w in zip(fv.bwd_diag(*args), fv.bwd_diag_plain(*args)):
            note("bwd_diag", _of_max(torch, "flash_variants_bwd", g, w))
    return err


def variant_rows(torch, F, fv, gen, B=44, S=512, H=12, D=64):
    """The main variants at the experiments' shape (causal), timed beside
    their plain versions and SDPA: the forward at nsplit 1 (the whole
    square, the experiment's baseline) and 4, ``run_fwd2`` with the scale
    in the kernel, the backward at nsplit 1 and 4."""
    dt = torch.bfloat16

    def randn():
        return torch.randn(B, S, H, D, generator=gen, device=DEVICE).to(dt)

    q, k, v, do = randn(), randn(), randn(), randn()
    out, lse = fv.run_fwd(q, k, v)
    ref, ref_lse = fv.run_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    err_f = check(torch, "flash_variants_fwd", out, ref, dt)
    lib_fwd, lib_bwd = sdpa_ms(torch, F, q, k, v, do, True)
    # bound: the function's work, whatever share of the square a variant
    # computes: inputs read once, outputs written once, the lse fp32;
    # operations 2 * D per visible (query, key) pair and product (two
    # products forward, five backward)
    peak = PEAK_OPS[str(dt)]
    pairs = B * H * S * (S + 1) // 2
    n = B * S * H * D * 2
    stats = B * H * S * 4
    fwd_bound = bound_ms(4 * n + stats, 4 * D * pairs, peak)
    bwd_bound = bound_ms(8 * n + stats, 10 * D * pairs, peak)
    rows = []
    for nsplit in (1, 4):
        if nsplit == 1:
            err = err_f
        else:
            err = check(torch, "flash_variants_fwd",
                        fv.run_fwd(q, k, v, True, nsplit)[0],
                        fv.run_fwd_plain(q, k, v, True, nsplit)[0], dt)
        r = timed(torch, "flash_variants_fwd", err,
                  lambda i, n_=nsplit: fv.run_fwd(q, k, v, True, n_),
                  lambda i, n_=nsplit: fv.run_fwd_plain(q, k, v, True, n_),
                  None, fwd_bound, plain_iters=2)
        r.update(dtype=f"run_fwd_nsplit{nsplit}", library_ms=lib_fwd,
                 library="sdpa forward")
        rows.append(r)
        args = (q, k, v, do, ref, ref_lse, True, nsplit)
        err = check(torch, "flash_variants_bwd", fv.run_bwd(*args),
                    fv.run_bwd_plain(*args), dt)
        r = timed(torch, "flash_variants_bwd", err,
                  lambda i, a=args: fv.run_bwd(*a),
                  lambda i, a=args: fv.run_bwd_plain(*a), None, bwd_bound,
                  plain_iters=2)
        r.update(dtype=f"run_bwd_nsplit{nsplit}", library_ms=lib_bwd,
                 library="sdpa backward (dq, dk and dv in one call)")
        rows.append(r)
    err = check(torch, "flash_variants_fwd", fv.run_fwd2(q, k, v)[0],
                fv.run_fwd2_plain(q, k, v)[0], dt)
    r = timed(torch, "flash_variants_fwd", err,
              lambda i: fv.run_fwd2(q, k, v),
              lambda i: fv.run_fwd2_plain(q, k, v), None, fwd_bound,
              plain_iters=2)
    r.update(dtype="run_fwd2_in_kernel_scale", library_ms=lib_fwd,
             library="sdpa forward")
    rows.append(r)
    for r in rows:
        r["shape"] = "bench"
    return rows


# phase 7's flash-variant launches (a launch captured into a graph counts
# at each replay): every timed entry is 5 warm-up calls and two replays of
# a 30-call graph, 65 launches. Forward: 6 parity calls, the timing
# inputs' forward, 6 run_fwd, 5 run_fwd2 and 6 ablation entries; backward:
# 6 parity calls, 6 run_bwd and 6 ablation entries.
FLASH_EXPERIMENT_LAUNCHES = {"flash_variants_fwd": 6 + 1 + 17 * 65,
                             "flash_variants_bwd": 6 + 12 * 65}

_FLAG_NAMES = (("causal", 1), ("exp_bf16", 2), ("p_bf16", 4),
               ("scale_in", 8), ("diag", 16), ("-mask", 32), ("-max", 64),
               ("-sum", 128), ("-exp", 256), ("-delta", 512), ("-ds", 1024))


def ptxas_rows(_build, log, instances, what):
    """For each (mangled-name key, label, fields, dynamic shared memory) of
    ``instances``: the one kernel of the build's ``-Xptxas -v`` ``log``
    whose name holds the key, with its registers (at launch), shared memory
    (the launch's dynamic bytes and ptxas's static) and spill bytes; prints
    each and raises on a spill."""
    report = _build.ptxas_report(log)
    rows = []
    for key, label, fields, smem in instances:
        found = [r for k, r in report.items() if key in k]
        if len(found) != 1:
            raise AssertionError(f"{what}: no ptxas report for the instance "
                                 f"{key}")
        r = found[0]
        rows.append(dict(**fields, registers=r["registers"],
                         smem_dynamic=smem, smem_static=r["smem"],
                         spill_stores=r["spill_stores"],
                         spill_loads=r["spill_loads"]))
        print(f"ptxas {label}: {r['registers']} registers, shared memory "
              f"{smem} B dynamic + {r['smem']} B static, spill stores "
              f"{r['spill_stores']} B, loads {r['spill_loads']} B")
    spilled = [r for r in rows if r["spill_stores"] or r["spill_loads"]]
    if spilled:
        raise AssertionError(f"{what} instances spill: {spilled}")
    return rows


def variant_build_report(fv, _build, logs, D=64):
    """The flash-variant instances phase 7 times, each with its ptxas
    report (``ptxas_rows``); raises on spills at head dim ``D``."""
    timed = {
        "fwd": sorted({fv.fwd_flags(True, e) for e in (False, True)}
                      | {fv.fwd_flags(True, p_bf16=p, in_kernel_scale=sc)
                         for p in (False, True) for sc in (False, True)}
                      | {fv.fwd_flags(drop=d) for d in fv.FWD_DROPS}),
        "bwd": sorted({fv.bwd_flags(True, e) for e in (False, True)}
                      | {fv.bwd_flags(drop=d) for d in fv.BWD_DROPS})}
    rows = []
    for kind, flags_list in timed.items():
        name = f"flash_variants_{kind}"
        smem = fv.smem_bytes(kind, D)
        instances = []
        for flags in flags_list:
            variant = " ".join(n for n, b in _FLAG_NAMES
                               if flags & b) or "full"
            instances.append((f"fv_{kind}ILi{D}ELi{flags}EE",
                              f"{name} D{D} flags {flags} ({variant})",
                              dict(kernel=name, D=D, flags=flags,
                                   variant=variant), smem))
        rows += ptxas_rows(_build, logs.get(name, ""), instances,
                           "timed flash-variant")
    return rows


def flash_build_report(fa, _build, logs):
    """Every instance of ``csrc/flash_attention.cu`` (forward and backward
    at D 64 and 128; phase 2 times all four), each with its ptxas report
    (``ptxas_rows``); raises on a spill."""
    instances = [(f"flash_{kind}ILi{D}EE", f"flash_{kind} D{D}",
                  dict(kernel=f"flash_{kind}", D=D), fa.smem_bytes(kind, D))
                 for kind in ("fwd", "bwd") for D in (64, 128)]
    return ptxas_rows(_build, logs.get("flash_attention", ""), instances,
                      "flash_attention")


def flash_f32_build_report(torch, fa, _build, logs):
    """Every instance of ``csrc/flash_attention_f32.cu`` (forward and
    backward at D 64 and 128), each with its ptxas report and the count of
    tensor-core instructions (HMMA, HGMMA) in its SASS; raises on a spill
    or on an instance without a tensor-core instruction."""
    instances = [(f"flash_{kind}_f32ILi{D}EE", f"flash_{kind}_f32 D{D}",
                  dict(kernel=f"flash_{kind}_f32", D=D),
                  fa.smem_bytes(kind, D, torch.float32))
                 for kind in ("fwd", "bwd") for D in (64, 128)]
    rows = ptxas_rows(_build, logs.get("flash_attention_f32", ""), instances,
                      "flash_attention_f32")
    sass = _build.sass_opcode_counts("flash_attention_f32", ("HMMA", "HGMMA"))
    for (key, label, _, _), r in zip(instances, rows):
        found = [n for k, n in sass.items() if key in k]
        if len(found) != 1 or found[0] == 0:
            raise AssertionError(f"flash_attention_f32: {label} has no "
                                 f"tensor-core instruction in its SASS "
                                 f"({found})")
        r["tensor_core_instructions"] = found[0]
        print(f"sass {label}: {found[0]} tensor-core instructions "
              f"(HMMA/HGMMA)")
    return rows


def rebuilt_build_report(torch, bm, da, pa, qm, hd, _build, logs):
    """Every instance of ``csrc/blocked_matmul.cu`` (the four tiles), of
    ``csrc/decode_attention.cu`` (q fp32 / bf16; the cache in q's type,
    int8 or fp8; exact D 64 and 128 at rep 1 or up to 8, and padded
    widths 32, 64 and 128 at up to 8, a one-byte cache's with 8-byte
    pieces; shared memory at the instance's largest rep), of
    ``csrc/paged_attention.cu`` (the split-KV decode family: fp32 / bf16,
    exact D 64 and 128 for one row or up to 8, padded widths 32, 64 and
    128 for up to 8; the bf16 tensor-core prefill, exact and padded, at
    32, 64 and 128, the fp32 prefill at 64 and 128), of
    ``csrc/quant_matmul.cu`` (x fp32 / bf16, int8 / fp8 weights, 32 or
    128 columns a block, 16-byte or byte-wise copies; shared memory at
    the tick's w_down for 32 columns and lm_head for 128), of
    ``csrc/head_dx.cu``, of ``csrc/rope.cu`` (fp32 / bf16, 16-byte or
    one-value loads; shared memory at D 64) and of ``csrc/rms_norm.cu``
    (both norms, fp32 / bf16, 16-byte or one-value loads, the row in
    registers at one or four pieces a thread, or a strided loop), each
    with its
    ptxas report (``ptxas_rows``); raises on a spill."""
    instances = [(f"blocked_mmILi{m}ELi{n}ELi{k}EE",
                  f"blocked_matmul {m}x{n}x{k}",
                  dict(kernel="blocked_matmul", tile=f"{m}x{n}x{k}"),
                  bm.smem_bytes(m, n, k)) for m, n, k in bm.TILES]
    rows = ptxas_rows(_build, logs.get("blocked_matmul", ""), instances,
                      "blocked_matmul")
    dts = (torch.float32, torch.bfloat16)
    # the main path's head dims have exact instances; every other head dim
    # of 8s takes a padded one of its width (up to 8 rows)
    kinds = [(64, 1), (128, 1), (32, 0), (64, 0), (128, 0)]
    instances = []
    for tc, dt in enumerate(dts):
        qname = str(dt).replace("torch.", "")
        for kc, kdt in enumerate((dt, torch.int8, torch.float8_e4m3fn)):
            kname = str(kdt).replace("torch.", "")
            for dp, exact in kinds:
                # a padded one-byte cache copies 8-byte pieces
                pb = 8 if kc and not exact else 16
                for rep in ((1, 8) if exact else (8,)):
                    instances.append((
                        f"8SlotRowsELi{tc}ELi{kc}ELi{dp}ELi{rep}ELi{pb}"
                        f"ELb{exact}EE",
                        f"ragged_decode_attention q {qname} cache {kname} "
                        f"{'D' if exact else 'D<='}{dp} rep "
                        f"{'1' if rep == 1 else '<= 8'} {pb}-byte pieces",
                        dict(kernel="ragged_decode_attention", q=qname,
                             cache=kname, width=dp, exact=bool(exact),
                             rep=rep, piece=pb),
                        da.smem_bytes(dt, kdt, dp, rep)))
    rows += ptxas_rows(_build, logs.get("decode_attention", ""), instances,
                       "ragged_decode_attention")
    instances = []
    for tc, dt in enumerate(dts):
        name = str(dt).replace("torch.", "")
        for dp, exact in kinds:
            width = f"{'D' if exact else 'D<='}{dp}"
            for r in ((1, 8) if exact else (8,)):
                instances.append((
                    f"9PagedRowsELi{tc}ELi0ELi{dp}ELi{r}ELi16ELb{exact}EE",
                    f"ragged_paged_attention decode {name} {width} rows "
                    f"{'1' if r == 1 else '<= 8'}",
                    dict(kernel="ragged_paged_attention", family="decode",
                         dtype=name, width=dp, exact=bool(exact), rows=r),
                    pa.smem_bytes(dt, dp, r)))
            if dt == torch.float32 and dp == 32:
                continue  # the fp32 prefill's narrowest width is 64
            key = ("paged_prefillILi" if dt == torch.bfloat16
                   else "paged_prefill_fp32ILi")
            instances.append((
                f"{key}{dp}ELb{exact}EE",
                f"ragged_paged_attention prefill {name} {width}",
                dict(kernel="ragged_paged_attention", family="prefill",
                     dtype=name, width=dp, exact=bool(exact), rows=64),
                pa.smem_bytes(dt, dp, 64)))
    rows += ptxas_rows(_build, logs.get("paged_attention", ""), instances,
                       "ragged_paged_attention")
    rows += ptxas_rows(_build, logs.get("head_dx", ""), [(
        "head_dx_kernel", "head_dx_softmax (128 x 256 tiles, 4 stages)",
        dict(kernel="head_dx_softmax"), hd.smem_bytes())], "head_dx_softmax")
    instances = []
    for key, dt, vec in (("rope_qkIfLi4EE", "float32", 4),
                         ("rope_qkIfLi1EE", "float32", 1),
                         ("rope_qkI13__nv_bfloat16Li8EE", "bfloat16", 8),
                         ("rope_qkI13__nv_bfloat16Li1EE", "bfloat16", 1)):
        # dynamic shared memory: a row's cos and sin in fp32 at D 64
        instances.append((key, f"fused_rope_qk {dt} {vec} a load",
                          dict(kernel="fused_rope_qk", dtype=dt, vec=vec),
                          4 * 64))
    rows += ptxas_rows(_build, logs.get("rope", ""), instances,
                       "fused_rope_qk")
    instances = []
    for t, dt, vec in (("f", "float32", 4), ("f", "float32", 1),
                       ("13__nv_bfloat16", "bfloat16", 8),
                       ("13__nv_bfloat16", "bfloat16", 1)):
        for add, name in ((0, "fused_rms_norm"), (1, "fused_add_rms_norm")):
            for key, family in ((f"norm_regsI{t}Li{vec}ELi1E", "regs 1"),
                                (f"norm_regsI{t}Li{vec}ELi4E", "regs 4"),
                                (f"norm_streamI{t}Li{vec}E", "loop")):
                instances.append((
                    f"{key}Lb{add}EE",
                    f"{name} {dt} {vec} a load, row in {family}",
                    dict(kernel=name, dtype=dt, vec=vec, family=family), 0))
    rows += ptxas_rows(_build, logs.get("rms_norm", ""), instances,
                       "rms_norm")
    instances = []
    for xc, xdt in enumerate(dts):
        for wc, mode in ((1, "int8"), (2, "fp8")):
            for nt, (K, N) in ((32, (3072, 768)), (128, (768, 32000))):
                for vec in (1, 0):
                    xname = str(xdt).replace("torch.", "")
                    instances.append((
                        f"quant_mmILi{xc}ELi{wc}ELi{nt}ELb{vec}EE",
                        f"quant_matmul x {xname} w {mode} {nt} columns "
                        f"{'16-byte' if vec else 'byte-wise'} copies",
                        dict(kernel="quant_matmul", x=xname, w=mode, nt=nt,
                             vec=bool(vec)),
                        qm.smem_bytes(xdt, K, N)))
    return rows + ptxas_rows(_build, logs.get("quant_matmul", ""),
                             instances, "quant_matmul")


def check_launched(launches, names, what):
    """Each kernel of ``names`` launched at least once on the path."""
    for n in names:
        if not launches[n] > 0:
            raise AssertionError(f"{n}: no launch on {what}")


def experiments(torch, fns, xdot, xfv):
    """Phase 7: the two experiments' entry points, each with every launch
    count set to 0 just before it and read just after; the blocked
    kernel's error against torch.mm and each flash variant's against the
    production kernels held to their bounds."""
    zero_counts(fns)
    dot = xdot.main(["20"])
    dlaunches = read_counts(fns)
    check_launched(dlaunches, ["blocked_matmul"], "the dot experiment")
    blocked = [r for r in dot if "tile" in r]
    if len(blocked) != 4:
        raise AssertionError(f"{len(blocked)} blocked rows, wanted 4")
    for r in blocked:
        limit = TOL["torch.bfloat16"][0] * r["out_abs_max"]
        if not r["max_abs_err"] <= limit:
            raise AssertionError(f"{r['tag']}: max |err| against torch.mm "
                                 f"{r['max_abs_err']} > {limit}")
    if not all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in dot):
        raise AssertionError(f"a dot variant's time is not finite: {dot}")
    zero_counts(fns)
    flash = xfv.main([])
    flaunches = read_counts(fns)
    check_launched(flaunches, ["flash_variants_fwd", "flash_variants_bwd",
                               "flash_attention_fwd", "flash_attention_bwd",
                               "flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv"],
                   "the flash experiment")
    for name, want in FLASH_EXPERIMENT_LAUNCHES.items():
        if flaunches[name] != want:
            raise AssertionError(f"{name}: {flaunches[name]} launches on "
                                 f"the flash experiment, wanted {want} "
                                 f"(one a call)")
    for r in flash["parity"]:
        for key, big in (("out_max_diff", "out_abs_max"),
                         ("grad_max_diff", "grad_abs_max")):
            if not r[key] <= PARITY_OF_MAX * r[big]:
                raise AssertionError(f"flash variant parity {r}: {key} > "
                                     f"{PARITY_OF_MAX} of {big}")
    if not all(math.isfinite(r["ms"]) and r["ms"] > 0
               for r in flash["timing"]):
        raise AssertionError("a flash variant's time is not finite")
    return {"dot_variants": dot, "flash_variants": flash}, dlaunches, \
        flaunches


# ---------------------------------------------------------------------------
# phase 3: the engine
# ---------------------------------------------------------------------------

def zero_counts(fns):
    for fn, attr in fns.values():
        setattr(fn, attr, 0)


def read_counts(fns):
    return {n: getattr(fn, attr) for n, (fn, attr) in fns.items()}


def serve(torch, ServingEngine, fns, params, cfg, reqs, max_len,
          fused=False):
    """Phase 3 (the windowed drain, ``run(fused=False)``) and 3g (a) (the
    fused drain, ``run()``): serve ``reqs`` once to warm up, then again
    with every launch count at 0; returns the timed run's stats, the
    launch counts and the tokens of each request. The fused drain must
    read the device once."""
    def engine():
        return ServingEngine(cfg, params, slots=8, max_len=max_len,
                             chunk=16, prompt_buckets=(64, 128, 256),
                             device=DEVICE)

    warm = engine()
    for p, g in reqs[:8]:
        warm.add_request(p, g)
    warm.run(fused=fused)
    torch.cuda.synchronize()

    eng = engine()
    rids = [eng.add_request(p, g) for p, g in reqs]
    zero_counts(fns)
    f0 = eng.fetches
    t0 = time.perf_counter()
    out = eng.run(fused=fused)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)

    check_tokens(out, rids, reqs, cfg)
    ticks = eng.last_run_ticks
    check_counts(launches, tick_counts(cfg.num_layers, ticks),
                 f"{ticks} ticks")
    fetches = eng.fetches - f0
    if fused and fetches != 1:
        raise AssertionError(f"the fused drain read the device {fetches} "
                             f"times, wanted once")
    new_tokens = sum(g for _, g in reqs)
    steps = ticks + len(reqs) if fused else None   # every admit a step
    return {"requests": len(reqs), "new_tokens": new_tokens,
            "wall_s": wall, "tokens_per_s": new_tokens / wall,
            "ticks": ticks, "chunks": eng.last_run_chunks,
            "fetches": fetches, "ms_per_tick": 1e3 * wall / max(1, ticks),
            "steps": steps,
            "ms_per_step": steps and 1e3 * wall / steps}, launches, \
        [out[r] for r in rids]


def tick_counts(L, ticks):
    """The launches ``ticks`` decode ticks on the contiguous cache need:
    the decode attention, rope and residual norm once a layer, the norm
    once more for the final norm."""
    return {"ragged_decode_attention": L * ticks,
            "fused_rms_norm": (L + 1) * ticks,
            "fused_add_rms_norm": L * ticks, "fused_rope_qk": L * ticks}


def check_tokens(out, rids, reqs, cfg):
    for rid, (p, g) in zip(rids, reqs):
        toks = out[rid]
        if len(toks) != g:
            raise AssertionError(f"request {rid}: {len(toks)} tokens, "
                                 f"wanted {g}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: token out of vocab")


def check_counts(launches, want, what):
    """Each kernel launched exactly as often as the path needs it (a kernel
    ``want`` does not name, never), and a kernel of the path at least
    once."""
    for n, c in launches.items():
        if c != want.get(n, 0):
            raise AssertionError(f"{n}: {c} launches on the main path, "
                                 f"wanted {want.get(n, 0)} ({what})")
    if not any(launches.values()):
        raise AssertionError(f"no kernel launched on the main path ({what})")


def serve_paged(torch, ServingEngine, fns, params, cfg, reqs, max_len):
    """Phase 3b: the same requests through the paged engine's segments
    (``run()`` drains in segments of 4 * chunk steps), after a warm-up
    run. Returns stats, launch counts and tokens."""
    def engine():
        return ServingEngine(cfg, params, slots=8, max_len=max_len,
                             chunk=16, prompt_buckets=(64, 128, 256),
                             paged=True, page_size=PAGE, device=DEVICE)

    warm = engine()
    for p, g in reqs[:8]:
        warm.add_request(p, g)
    warm.run()
    torch.cuda.synchronize()

    eng = engine()
    rids = [eng.add_request(p, g) for p, g in reqs]
    zero_counts(fns)
    f0 = eng.fetches
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)

    check_tokens(out, rids, reqs, cfg)
    leaks = eng.pager.leak_report()
    if leaks:
        raise AssertionError(f"paged drain leaked pages: {leaks}")
    steps = eng.last_run_ticks
    decode = steps - len(reqs)      # every request is admitted once
    L = cfg.num_layers
    check_counts(launches, {
        "ragged_paged_attention": L * steps, "ragged_decode_attention": 0,
        "fused_rms_norm": (L + 1) * decode,
        "fused_add_rms_norm": L * decode, "fused_rope_qk": L * decode},
        f"{steps} steps, {decode} decode steps")
    fetches = eng.fetches - f0
    if fetches != eng.last_run_chunks:
        raise AssertionError(f"{fetches} fetches for "
                             f"{eng.last_run_chunks} segments")
    # no host read inside a segment: issuing a segment's steps must not
    # synchronise with the card at all (PyTorch raises on any sync while
    # the debug mode is "error"); only finish_segment reads the device
    audit = engine()
    for p, g in reqs[:12]:
        audit.add_request(p, g)
    audited = 0
    while audit._queue or audit.free_slot_count() < audit.slots:
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = audit.dispatch_segment(64)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        audit.finish_segment(pending)
        audited += 1
    new_tokens = sum(g for _, g in reqs)
    return {"requests": len(reqs), "new_tokens": new_tokens,
            "wall_s": wall, "tokens_per_s": new_tokens / wall,
            "steps": steps, "decode_steps": decode, "admits": len(reqs),
            "segments": eng.last_run_chunks, "fetches": fetches,
            "sync_free_dispatches": audited,
            "ms_per_step": 1e3 * wall / max(1, steps),
            "pages": eng.pager.stats()}, launches, [out[r] for r in rids]


def prefix_burst(torch, sched, ServingEngine, fns, params, cfg, paged,
                 make_cache):
    """Phase 3c (a paged engine and a ``PagedPrefixCache``) and 3g (b) (a
    contiguous engine with a row-copy ``PrefixCache``, and without a
    cache): the serving benchmark's shared-prefix burst (16 requests of a
    192-token prefix and a 32-token tail, 32 generated tokens each, all at
    t = 0) through ``OnlineScheduler``. ``make_cache(engine)`` gives the
    cache, or None. The warm pass of ``serve(warm=True)`` runs first as
    its own call, so the launch counts cover the measured pass alone."""
    prefix = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (192,)).astype(np.int32)
    arrivals = sched.staggered_arrivals(0, 16, 0.0, cfg.vocab_size,
                                        prompt_lens=(32,), gen_lens=(32,),
                                        prefix=prefix)
    eng = ServingEngine(cfg, params, slots=8, max_len=384,
                        prompt_buckets=(32, 64, 128, 256), paged=paged,
                        page_size=PAGE, device=DEVICE)
    pc = make_cache(eng)
    sch = sched.OnlineScheduler(eng, seg_steps=16, prefix_cache=pc)
    sch.serve(arrivals)             # serve(warm=True) is this, reset, serve
    torch.cuda.synchronize()
    sch.reset()
    zero_counts(fns)
    rep = sch.serve(arrivals)
    torch.cuda.synchronize()
    launches = read_counts(fns)
    res = sch.results()
    what = "paged" if paged else "contiguous"
    if sorted(len(t) for t in res.values()) != [32] * 16:
        raise AssertionError(f"{what} prefix burst: a request got the "
                             f"wrong count")
    if pc is not None and rep.prefix["hits"] < 1:
        raise AssertionError(f"{what} prefix burst: no prefix hit")
    if paged and eng.pager.cow_breaks != 0:
        raise AssertionError(f"prefix burst: {eng.pager.cow_breaks} COW "
                             f"breaks")
    steps = rep.ticks
    decode = steps - len(arrivals)  # every request is admitted once
    L = cfg.num_layers
    check_counts(launches, paged_counts(L, steps, decode) if paged
                 else tick_counts(L, decode),
                 f"{what} prefix burst: {steps} steps, {decode} decode "
                 f"steps")
    if paged:
        pc.clear()
        leaks = eng.pager.leak_report()
        if leaks:
            raise AssertionError(f"prefix burst leaked pages: {leaks}")
    out = {k: getattr(rep, k) for k in (
        "n_requests", "total_tokens", "makespan_s", "throughput_tok_s",
        "ttft_p50_s", "ttft_p99_s", "e2e_p50_s", "e2e_p99_s",
        "queue_wait_p50_s", "slot_occupancy", "segments", "ticks")}
    out["prefix"] = rep.prefix
    # ``prefix["hits"]`` counts matches when a request is picked, so a
    # request picked, requeued for want of a slot and picked again counts
    # twice; this counts the requests that were admitted on a hit
    out["requests_admitted_on_a_hit"] = sum(
        r["prefix_hit_len"] > 0 for r in rep.per_request)
    out["decode_steps"] = decode
    out["pages"] = rep.pages
    return out, launches


def paged_counts(L, steps, decode, quant=False, projections=7):
    """The launches a paged drain of ``steps`` steps (``decode`` of them
    decode ticks, the rest admits) needs: the tick kernels on every decode
    tick; the paged kernel on every step of an unquantized pool, none on a
    quantized one (the dequantizing gather); on a quantized tree,
    ``quant_matmul`` for the tick's ``projections`` per layer (7, or 4
    with ``fused_weights``: wqkv, wo, w_gate_up, w_down) and lm_head, and
    the admit's lm_head."""
    want = {"fused_rms_norm": (L + 1) * decode,
            "fused_add_rms_norm": L * decode, "fused_rope_qk": L * decode,
            "ragged_paged_attention": 0 if quant else L * steps}
    if quant:
        want["quant_matmul"] = ((projections * L + 1) * decode
                                + (steps - decode))
    return want


def paged_engine(ServingEngine, params, cfg, max_len, **kw):
    """The paged engine of phases 3b-3e: 8 slots, pages of 16."""
    return ServingEngine(cfg, params, slots=8, max_len=max_len, chunk=16,
                         prompt_buckets=(64, 128, 256), paged=True,
                         page_size=PAGE, device=DEVICE, **kw)


def digest_drain(torch, fns, eng, cfg, rs):
    """``run()``'s drain of requests ``rs`` on a paged engine with quality
    digests, every launch count at 0 before it and read after, the
    finished requests (their digests) kept before ``collect_finished``
    hands back their tokens, as the JAX fleet's shadow harvest does.
    Checks the tokens, the pages, the launches and one fetch per segment.
    Returns (stats, launches, [(tokens, digests)] in request order)."""
    rids = [eng.add_request(p, g) for p, g in rs]
    zero_counts(fns)
    f0 = eng.fetches
    eng.last_run_ticks = eng.last_run_chunks = 0
    t0 = time.perf_counter()
    while eng._queue or eng.free_slot_count() < eng.slots:
        eng.run_segment(4 * eng.chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    finished = list(eng._finished)
    out = eng.collect_finished()
    digests = {r.rid: r.digests for r in finished}
    check_tokens(out, rids, rs, cfg)
    if eng.pager.leak_report():
        raise AssertionError(f"leaked pages: {eng.pager.leak_report()}")
    steps = eng.last_run_ticks
    decode = steps - len(rs)    # every request is admitted once
    check_counts(launches,
                 paged_counts(cfg.num_layers, steps, decode, eng.quant),
                 f"quant={eng.quant}: {steps} steps, {decode} decode")
    if eng.fetches - f0 != eng.last_run_chunks:
        raise AssertionError(f"{eng.fetches - f0} fetches for "
                             f"{eng.last_run_chunks} segments")
    new = sum(g for _, g in rs)
    stats = {"requests": len(rs), "new_tokens": new, "wall_s": wall,
             "tokens_per_s": new / wall, "steps": steps,
             "decode_steps": decode, "segments": eng.last_run_chunks,
             "fetches": eng.fetches - f0,
             "ms_per_step": 1e3 * wall / max(1, steps)}
    return stats, launches, [(out[r], digests[r]) for r in rids]


def score_pairs(compare_pair, prim, shad):
    """``compare_pair`` over requests: [(tokens, digests or None)] of the
    primary and of the shadow serve, aggregated. The matched-prefix rate
    is the matched tokens (up to each first divergence) over the tokens
    compared; KL mean is over all scored positions."""
    pairs = [compare_pair(pt, st, pd, sd)
             for (pt, pd), (st, sd) in zip(prim, shad)]
    compared = sum(r["compared"] for r in pairs)
    kl_pos = sum(r["kl_positions"] for r in pairs)
    return {"matched_prefix_rate": sum(r["tokens_matched"]
                                       for r in pairs) / compared,
            "requests_identical": sum(r["match"] for r in pairs),
            "requests": len(pairs),
            "logit_positions": sum(r["logit_positions"] for r in pairs),
            "logit_max_abs_err": max(
                (r["logit_max_abs_err"] for r in pairs
                 if r["logit_max_abs_err"] is not None), default=None),
            "kl_positions": kl_pos,
            "kl_mean": (sum(r["kl_mean"] * r["kl_positions"]
                            for r in pairs if r["kl_positions"])
                        / kl_pos if kl_pos else None),
            "kl_max": max((r["kl_max"] for r in pairs
                           if r["kl_max"] is not None), default=None)}


def quant_serve(torch, ServingEngine, compare_pair, fns, params, cfg, reqs,
                max_len):
    """Phase 3d: the requests through the int8 paged engine with quality
    digests (after a warm-up run), its launches and fetches checked and
    its segment dispatch audited for host syncs; the same requests through
    a bf16 paged engine with digests, the shadow, each request scored with
    ``compare_pair`` (reported: on these random weights the bar is not
    asserted, see ``quant_trained``); then an fp8 engine on the first 8
    requests."""
    warm = paged_engine(ServingEngine, params, cfg, max_len, quant="int8",
                        quality_digest=True)
    for p, g in reqs[:8]:
        warm.add_request(p, g)
    warm.run()
    torch.cuda.synchronize()
    eng = paged_engine(ServingEngine, params, cfg, max_len, quant="int8",
                       quality_digest=True)
    if not (eng.quant_kernel_active() and not eng.paged_kernel_active()):
        raise AssertionError("the int8 engine does not route its "
                             "projections to quant_matmul")
    stats, launches, primary = digest_drain(torch, fns, eng, cfg, reqs)
    # no host read while a segment is issued, digests included
    audited = 0
    for p, g in reqs[:12]:
        eng.add_request(p, g)
    while eng._queue or eng.free_slot_count() < eng.slots:
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = eng.dispatch_segment(64)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        eng.finish_segment(pending)
        audited += 1
    eng.collect_finished()
    stats["sync_free_dispatches"] = audited
    shadow, _, shadow_out = digest_drain(
        torch, fns, paged_engine(ServingEngine, params, cfg, max_len,
                                 quality_digest=True), cfg, reqs)
    fp8, fp8_launches, fp8_out = digest_drain(
        torch, fns, paged_engine(ServingEngine, params, cfg, max_len,
                                 quant="fp8", quality_digest=True), cfg,
        reqs[:8])
    fp8["quality_against_bf16"] = score_pairs(compare_pair, fp8_out,
                                              shadow_out[:8])
    return ({"int8": stats, "bf16_shadow": shadow, "fp8": fp8,
             "int8_against_bf16": score_pairs(compare_pair, primary,
                                              shadow_out)},
            launches, fp8_launches)


def memorize(torch, llama, params, cfg, tokens, lr=1e-4, max_steps=60):
    """Phase 3e's model: more AdamW steps on phase 5's batch (a fresh
    optimizer state) until its loss is below ``MEMO_LOSS`` or ``max_steps``
    ran; returns the losses. A model that has memorized its batch is
    confident on continuations of those sequences."""
    opt = llama.init_opt_state(params)
    step = llama.make_train_step(cfg, lr=lr)
    losses = []
    while len(losses) < max_steps and (not losses
                                       or losses[-1] >= MEMO_LOSS):
        losses.append(step(params, opt, tokens, tokens)[2].item())
    del opt
    return losses


def quant_trained(torch, ServingEngine, compare_pair, fns, params, cfg,
                  reqs, max_len):
    """Phase 3e: the quality bar on the memorized model (cast to bf16),
    served continuations of its training sequences: the requests through
    the int8 engine and through the bf16 engine, both with digests, each
    request scored with ``compare_pair``; the matched-prefix rate must be
    at least ``MATCHED_PREFIX_FLOOR``."""
    int8, launches, primary = digest_drain(
        torch, fns, paged_engine(ServingEngine, params, cfg, max_len,
                                 quant="int8", quality_digest=True), cfg,
        reqs)
    shadow, _, shadow_out = digest_drain(
        torch, fns, paged_engine(ServingEngine, params, cfg, max_len,
                                 quality_digest=True), cfg, reqs)
    quality = score_pairs(compare_pair, primary, shadow_out)
    if not quality["matched_prefix_rate"] >= MATCHED_PREFIX_FLOOR:
        raise AssertionError(f"int8 against bf16 on the trained weights: "
                             f"matched-prefix rate "
                             f"{quality['matched_prefix_rate']} < "
                             f"{MATCHED_PREFIX_FLOOR}")
    return {"int8": int8, "bf16_shadow": shadow,
            "int8_against_bf16": quality,
            "outputs": (primary, shadow_out)}, launches


def eager_and_device_ms(torch, step, iters):
    """ms per call of ``step()`` issued eagerly (host clock around
    ``iters`` calls and a synchronize), and the device ms of the same
    call captured in a CUDA graph and replayed."""
    from paddle_tpu_torch.experiments._timing import events_ms

    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        eager = 1e3 * (time.perf_counter() - t0) / iters
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph.replay()

        def replay():
            for _ in range(iters):
                graph.replay()
        device = events_ms(replay) / iters
        del graph
    return eager, device


def paged_step_breakdown(torch, llama, params, cfg, max_len, iters=50,
                         quant=None):
    """The paged engine's two kinds of step at the engine's shape: a
    decode tick over 8 slots (positions spread over the window, a
    shuffled page table) and an admit prefill ([1, 256] at context 0),
    each eager and as a CUDA-graph replay: the device's busy share of
    the eager step. ``quant``: a quantized tree's steps on a pool of that
    mode."""
    B = 8
    max_pages = max_len // PAGE
    P = B * max_pages + 1
    pool = llama.init_paged_pool(cfg, P, PAGE, DEVICE, quant=quant)
    pt = torch.from_numpy(np.random.RandomState(2).permutation(
        np.arange(1, P)).reshape(B, max_pages).astype(np.int32)).to(DEVICE)
    nxt = torch.arange(B, device=DEVICE)[:, None]
    pos = torch.linspace(0, max_len - 1, B, device=DEVICE).to(torch.int32)
    live = torch.ones(B, dtype=torch.bool, device=DEVICE)
    prompt = torch.arange(256, device=DEVICE)[None] % cfg.vocab_size
    zero = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    out = {}
    for name, step in (
            ("decode", lambda: llama.forward_with_pages(
                params, nxt, cfg, pool, pt, pos, live=live)),
            ("admit_prefill", lambda: llama.forward_with_pages(
                params, prompt, cfg, pool, pt[:1], zero, logit_pos=200))):
        eager, device = eager_and_device_ms(torch, step, iters)
        out[name] = {"eager_ms": eager, "device_ms": device,
                     "device_busy_share": device / eager}
    return out


def tick_breakdown(torch, llama, params, cfg, max_len, rows, iters=50):
    """One ragged decode tick at the engine's shape (8 slots, positions
    spread over the window): its eager time per tick, the device time of
    the same tick captured in a CUDA graph and replayed, and the four
    kernels' share of that device time, estimated from their per-call
    device times at the serving shape (bf16) times their launches per
    tick."""
    B, L = 8, cfg.num_layers
    cache = llama.init_kv_cache(cfg, B, max_len, DEVICE)
    nxt = torch.arange(B, device=DEVICE)[:, None]
    pos = torch.linspace(0, max_len - 1, B, device=DEVICE).to(torch.int32)
    eager, device = eager_and_device_ms(
        torch, lambda: llama.forward_with_cache(params, nxt, cfg, cache, pos),
        iters)
    per_tick = {"ragged_decode_attention": L, "fused_rms_norm": L + 1,
                "fused_add_rms_norm": L, "fused_rope_qk": L}
    kern = sum(n * next(r["ms"] for r in rows if r["name"] == name
                        and r["shape"] == "serving"
                        and r["dtype"] == "bfloat16")
               for name, n in per_tick.items())
    return {"eager_ms_per_tick": eager, "device_ms_per_tick": device,
            "device_busy_share": device / eager,
            "kernel_device_ms_per_tick": kern,
            "kernel_share_of_device": kern / device}


# ---------------------------------------------------------------------------
# phase 3f: a long admit, and a narrow head dim served end to end
# ---------------------------------------------------------------------------

# phase 3f's engine: max_len 2048 with a 1024 bucket, so a ~1000-token
# prompt is admitted as one [1, 1024] prefill chunk
LONG_MAX_LEN = 2048
LONG_BUCKETS = (64, 128, 256, 512, 1024)
LONG_PROMPT = 1000


def long_admit(torch, llama, pa, tf, ServingEngine, fns, params, cfg,
               new_tokens=16, ticks=4):
    """Phase 3f (1): ``ServingEngine(paged=True, max_len=2048)`` with a
    1024 bucket serves a 1000-token prompt (every launch count at 0 just
    before, read just after: the admit's 1024-row chunk and the ticks all
    through ``ragged_paged_attention``); then the same admit and ``ticks``
    ticks teacher-forced through the kernels and through their plain
    versions side by side, logits within ``LOGIT_ATOL``."""
    prompt = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                              LONG_PROMPT)
    eng = ServingEngine(cfg, params, slots=8, max_len=LONG_MAX_LEN,
                        chunk=16, prompt_buckets=LONG_BUCKETS, paged=True,
                        page_size=PAGE, device=DEVICE)
    rid = eng.add_request(prompt, new_tokens)
    zero_counts(fns)
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    check_tokens(out, [rid], [(prompt, new_tokens)], cfg)
    steps = eng.last_run_ticks
    check_counts(launches, paged_counts(cfg.num_layers, steps, steps - 1),
                 f"a {LONG_PROMPT}-token admit and {steps - 1} ticks")
    if eng.pager.leak_report():
        raise AssertionError("the long admit leaked pages")

    max_pages = LONG_MAX_LEN // PAGE
    pt = torch.from_numpy(np.random.RandomState(4).permutation(
        np.arange(1, max_pages + 1)).astype(np.int32)[None]).to(DEVICE)
    bucket = LONG_BUCKETS[-1]
    tok = torch.zeros(1, bucket, dtype=torch.int64, device=DEVICE)
    tok[0, :LONG_PROMPT] = torch.from_numpy(prompt)
    zero = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    plain = [mock.patch.object(tf, "fused_rms_norm", tf.rms_norm_plain),
             mock.patch.object(tf, "fused_add_rms_norm",
                               tf.add_rms_norm_plain),
             mock.patch.object(tf, "fused_rope_qk", tf.rope_qk_plain),
             mock.patch.object(pa, "ragged_paged_attention",
                               pa.ragged_paged_attention_plain)]

    def run(feed):
        """The admit, then the ticks fed ``feed`` (None: the path's own
        greedy tokens, returned for the other path to be fed)."""
        pool = llama.init_paged_pool(cfg, max_pages + 1, PAGE, DEVICE)
        logits = [llama.forward_with_pages(params, tok, cfg, pool, pt, zero,
                                           logit_pos=LONG_PROMPT - 1)[0]]
        fed = []
        for t in range(ticks):
            nxt = (logits[-1].argmax(-1)[:, None] if feed is None
                   else feed[t])
            fed.append(nxt)
            pos = torch.full((1,), LONG_PROMPT + t, dtype=torch.int32,
                             device=DEVICE)
            logits.append(llama.forward_with_pages(params, nxt, cfg, pool,
                                                   pt, pos)[0])
        return torch.cat(logits), fed

    with torch.no_grad():
        got, fed = run(None)  # the kernel path is the teacher
        for p in plain:
            p.start()
        try:
            want, _ = run(fed)
        finally:
            for p in plain:
                p.stop()
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite logits on the long admit")
    err = (got - want).abs().max().item()
    if err > LOGIT_ATOL:
        raise AssertionError(f"long admit: teacher-forced logits differ by "
                             f"{err} > {LOGIT_ATOL}")
    return {"prompt_tokens": LONG_PROMPT, "bucket": bucket,
            "max_len": LONG_MAX_LEN, "new_tokens": new_tokens,
            "steps": steps, "wall_s": wall,
            "teacher_forced_positions": 1 + ticks,
            "max_abs_logit_err": err, "logit_atol": LOGIT_ATOL}, launches


def cpu_small_serve(torch, llama, da, pa, tf, ServingEngine, fns,
                    max_len=384):
    """Phase 3f (2): ``LlamaConfig.cpu_small`` (8 heads of D 16, fp32,
    random weights from seed 0) served on the card: the mixed workload's
    32 requests (vocab 2048) through the contiguous engine and the paged
    engine, each drain with its launches counted (phases 3 and 3b's
    checks), then phase 4's and 4b's teacher-forced ticks on it."""
    cfg = llama.LlamaConfig.cpu_small()
    params = llama.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0), device=DEVICE)
    reqs = mixed_workload(np.random.RandomState(1), 32, cfg.vocab_size)
    stats, launches, toks_c = serve(torch, ServingEngine, fns, params, cfg,
                                    reqs, max_len)
    pstats, plaunches, toks_p = serve_paged(torch, ServingEngine, fns,
                                            params, cfg, reqs, max_len)
    tfc = teacher_forced(torch, llama, da, tf, params, cfg, reqs, max_len,
                         ticks=8)
    tfp = teacher_forced_paged(torch, llama, pa, tf, params, cfg, reqs,
                               max_len, ticks=8)
    same = sum(a == b for a, b in zip(toks_c, toks_p))
    return {"config": "cpu_small", "head_dim": cfg.head_dim,
            "dtype": "float32", "contiguous": stats, "paged": pstats,
            "requests_identical": same, "teacher_forced": tfc,
            "teacher_forced_paged": tfp}, launches, plaunches


# ---------------------------------------------------------------------------
# phase 3g: the contiguous engine's fused drain and segments, generation,
# preemption and abort
# ---------------------------------------------------------------------------

def timed_launches(torch, fns, run):
    """``run()`` with every launch count at 0 just before it: returns its
    result, the host seconds it took (to a synchronize) and the counts."""
    zero_counts(fns)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts(fns)


def generation(torch, llama, fns, params, cfg, B=2, S=64, T=32, beams=4):
    """Phase 3g (c): ``beam_search_generate`` (B 2, a 64-token prompt, 32
    tokens, 4 beams) without and with an EOS that the first run's best
    beam emits, and sampled ``generate`` (T 0.8, top-k 50, top-p 0.9)
    twice from one seed: tokens in the vocabulary, the seed replayed, and
    every decode tick through the tick kernels (beam search runs one a
    token, the first on the prompt's last token again; generate one a
    token after the first). Then sampling with ``top_k=1`` against greedy
    ``generate``: equal, or first apart where the step's top logit is
    tied (bf16 logits at vocab 32000 tie often, and top-k keeps ties), the
    sampled token one of the tied maxima. Returns (stats, {path:
    launches})."""
    from paddle_tpu_torch.models import llama as lmod

    prompt = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, S))
    L = cfg.num_layers
    out, launches = {}, {}

    def in_vocab(t, what):
        if not bool(((t >= 0) & (t < cfg.vocab_size)).all()):
            raise AssertionError(f"{what}: token out of vocab")

    eos = None
    for name in ("beam", "beam_eos"):
        toks, wall, n = timed_launches(torch, fns, lambda: (
            llama.beam_search_generate(params, prompt, cfg,
                                       max_new_tokens=T, num_beams=beams,
                                       eos_token_id=eos, device=DEVICE)))
        in_vocab(toks, name)
        check_counts(n, tick_counts(L, T), f"{name}: {T} ticks")
        out[name] = {"ms_per_token": 1e3 * wall / T,
                     "eos_token_id": eos,
                     "tokens_row0": toks[0].tolist()}
        launches[f"generate_{name}"] = n
        eos = int(toks[0, 4])
    kw = dict(max_new_tokens=T, temperature=0.8, top_k=50, top_p=0.9,
              seed=0, device=DEVICE)
    first, wall, n = timed_launches(torch, fns, lambda: llama.generate(
        params, prompt, cfg, **kw))
    check_counts(n, tick_counts(L, T - 1), f"sampled: {T - 1} ticks")
    launches["generate_sampled"] = n
    again = llama.generate(params, prompt, cfg, **kw)
    in_vocab(first, "sampled")
    if not torch.equal(first, again):
        raise AssertionError("sampled generate: one seed gave two streams")
    out["sampled"] = {"ms_per_token": 1e3 * wall / T,
                      "seed_replayed": True,
                      "tokens_row0": first[0].tolist()}
    greedy = llama.generate(params, prompt, cfg, max_new_tokens=T,
                            device=DEVICE)
    seen = []
    sample = lmod._sample

    def spy(logits, *args, **kwargs):
        seen.append(logits)
        return sample(logits, *args, **kwargs)

    with mock.patch.object(lmod, "_sample", spy):
        k1 = llama.generate(params, prompt, cfg, max_new_tokens=T,
                            temperature=0.8, top_k=1, seed=0, device=DEVICE)
    ties = 0
    for b in range(B):
        apart = (k1[b] != greedy[b]).nonzero()
        if len(apart) == 0:
            continue
        t = int(apart[0, 0])
        row = seen[t][b]
        top = row.max()
        g, k = int(greedy[b, t]), int(k1[b, t])
        if not (row[g] == top and row[k] == top):
            raise AssertionError(
                f"top_k=1 sampling left greedy at row {b} step {t} where "
                f"the top logit is not tied ({float(row[g])} / "
                f"{float(row[k])} / max {float(top)})")
        ties += 1
    out["top_k_1"] = {"rows_equal_to_greedy": B - ties,
                      "rows_apart_at_a_tie": ties}
    return out, launches


def preempt_and_abort(torch, ServingEngine, PrefixCache, PagedPrefixCache,
                      fns, params, cfg, reqs, max_len, paged):
    """Phase 3g (d), on one engine: 12 of the mixed requests through
    segments of 32 steps with a prefix cache; after the first segment the
    two live slots with the shortest prompt and tokens so far are
    preempted (their prompt and tokens parked in the cache) and requeued
    at the head, and the drain goes on; at least one resume must ride its
    parked prefix. Then 8 requests, one segment run and the next
    dispatched and never read: ``abort`` must return every request still
    owed, which then resume on the same engine. Every request gets its
    count, each decode tick (and, paged, each step) launches its kernels,
    and a paged pool leaks nothing. Returns (stats, {path: launches})."""
    what = "paged" if paged else "contiguous"
    eng = ServingEngine(cfg, params, slots=8, max_len=max_len, chunk=16,
                        prompt_buckets=(64, 128, 256), paged=paged,
                        page_size=PAGE, device=DEVICE)
    pc = (PagedPrefixCache(eng.pager, capacity_pages=512) if paged
          else PrefixCache(block=32))
    L = cfg.num_layers

    def want(steps, decode):
        return (paged_counts(L, steps, decode) if paged
                else tick_counts(L, decode))

    def drain(tally):
        while eng._queue or eng.free_slot_count() < eng.slots:
            ev = eng.run_segment(32, prefix_cache=pc)
            tally[0] += ev["steps"]
            tally[1] += len(ev["admitted"])
        return eng.collect_finished()

    sub = reqs[:12]
    tally = [0, 0]

    def preempted_run():
        rids = [eng.add_request(p, g) for p, g in sub]
        ev = eng.run_segment(32, prefix_cache=pc)
        tally[0], tally[1] = ev["steps"], len(ev["admitted"])
        # the two shortest resume views: a contiguous admit drops its hits
        # when the prefix and the segment's widest suffix overflow max_len
        live = sorted((s for s in range(eng.slots) if eng.can_preempt(s)),
                      key=lambda s: len(eng._active[s].resume_view()[0]))
        if len(live) < 2:
            raise AssertionError(f"{what} preemption: {len(live)} "
                                 f"preemptible slots after a segment")
        victims = [eng.preempt_slot(s, prefix_cache=pc) for s in live[:2]]
        eng._queue[:0] = victims
        return rids, victims, drain(tally)

    (rids, victims, res), wall, n_pre = timed_launches(torch, fns,
                                                      preempted_run)
    check_tokens(res, rids, sub, cfg)
    check_counts(n_pre, want(tally[0], tally[0] - tally[1]),
                 f"{what} preemption: {tally[0]} steps, {tally[1]} admits")
    resumed_on_hit = sum(v.prefix_hit_len > 0 for v in victims)
    if resumed_on_hit < 1:
        raise AssertionError(f"{what} preemption: no resume rode the "
                             f"parked prefix")
    out = {"requests": len(sub), "preempted": [v.rid for v in victims],
           "resumed_on_a_parked_prefix": resumed_on_hit,
           "steps": tally[0], "admits": tally[1], "wall_s": wall,
           "prefix": pc.stats()}
    if paged:
        pc.clear()
        leaks = eng.pager.leak_report()
        if leaks:
            raise AssertionError(f"paged preemption leaked pages: {leaks}")
        pc = PagedPrefixCache(eng.pager, capacity_pages=512)

    sub = reqs[12:20]
    tally = [0, 0]

    def aborted_run():
        rids = [eng.add_request(p, g) for p, g in sub]
        ev = eng.run_segment(32, prefix_cache=pc)
        tally[0], tally[1] = ev["steps"], len(ev["admitted"])
        done = eng.collect_finished()
        pending = eng.dispatch_segment(32, prefix_cache=pc)
        tally[0] += pending.steps          # issued, its log never read
        tally[1] += pending.qadm
        orphans = eng.abort()
        owed = sorted(r for r in rids if r not in done)
        if sorted(r.rid for r in orphans) != owed:
            raise AssertionError(f"{what} abort returned "
                                 f"{sorted(r.rid for r in orphans)}, owed "
                                 f"{owed}")
        eng._queue.extend(orphans)
        done.update(drain(tally))
        return rids, len(orphans), done

    (rids, n_orphans, res), wall, n_abort = timed_launches(torch, fns,
                                                           aborted_run)
    check_tokens(res, rids, sub, cfg)
    check_counts(n_abort, want(tally[0], tally[0] - tally[1]),
                 f"{what} abort: {tally[0]} steps, {tally[1]} admits")
    out["abort"] = {"requests": len(sub), "orphans": n_orphans,
                    "steps": tally[0], "admits": tally[1], "wall_s": wall}
    if paged:
        pc.clear()
        leaks = eng.pager.leak_report()
        if leaks:
            raise AssertionError(f"paged abort leaked pages: {leaks}")
    return out, {f"preempt_{what}": n_pre, f"abort_{what}": n_abort}


# ---------------------------------------------------------------------------
# phase 3h: the paged engine's chunked-prefill, speculative/sampled and
# sequence-parallel segments
# ---------------------------------------------------------------------------

FAMILY_CHUNKS = (16, 32, 64)
SPEC_K = 4
# 3h's depth, cut to keep the script near its 600 s aim: the memorized
# continuations and the repeated-stretch class of (b) on their first 16 and
# 4 requests (of 32 and 16), sampling in (c) on the first 4 (of 8); and
# (b)'s random-weights class on the first 8 of the 32 mixed requests,
# held against the same 8 of (a)'s unchunked serve: it was (b)'s longest
# serve (its near-tie checks forward every request that parts), and 8
# requests of the mixed lengths still fill the verify ticks' slots (the
# engine's 8 slots; it went from 16 to 8 for phase 6i). The
# repeated class went from 8 to 4 requests to make room for phase 6h: its
# prompts repeat a stretch of the memorized sequences, so each request
# drafts and accepts as the others do, and 4 still take the verify ticks
# through acceptance and rejection alike
SPEC_MEMORIZED, SPEC_REPEATED, SAMPLED_REQUESTS = 16, 4, 4
SPEC_RANDOM = 8
SAMPLED = {"temperature": 0.8, "top_k": 32}
SP = 2
SP_PROMPT = 2000
SP_MAX_LEN = 2048
SP_SEG_STEPS = 8


def family_engine(ServingEngine, params, cfg, max_len=384,
                  buckets=(64, 128, 256), **kw):
    """The paged engine of phase 3h: 8 slots, pages of 16."""
    return ServingEngine(cfg, params, slots=8, max_len=max_len, chunk=16,
                         prompt_buckets=buckets, paged=True, page_size=PAGE,
                         device=DEVICE, **kw)


def family_counts(L, steps, ticks, tick_kernels=True):
    """The launches of a serve of ``steps`` steps, ``ticks`` of them decode
    or verify ticks and the rest prefill chunks (T > 1): the paged kernel
    every step, once a layer; the tick kernels on every tick when it runs
    one token a slot (a decode tick, or a K = 0 verify tick; a K > 0
    verify tick runs K + 1 tokens a slot through the prefill path)."""
    n = ticks if tick_kernels else 0
    return {"ragged_paged_attention": L * steps,
            "fused_rms_norm": (L + 1) * n, "fused_add_rms_norm": L * n,
            "fused_rope_qk": L * n}


def family_serve(torch, sched, fns, eng, arrivals, seg_steps=32,
                 profile=True):
    """One serve of ``arrivals`` through ``OnlineScheduler`` on ``eng``,
    every launch count at 0 just before and read just after: each request
    gets its count, the pool ends empty. Then (``profile``) the trace's
    first 8 requests again under ``torch.profiler`` (``device_busy``):
    device ms a step and the busy share of that serve. Returns (stats, launches, tokens in arrival
    order)."""
    cfg = eng.cfg
    sch = sched.OnlineScheduler(eng, seg_steps=seg_steps,
                                max_queue=len(arrivals))
    f0, c0 = eng.fetches, eng.prefill_chunk_steps
    zero_counts(fns)
    t0 = time.perf_counter()
    rep = sch.serve(arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    reqs = [sch._reqs[r] for r in sorted(sch._reqs)]
    res = sch.results()
    toks = [res[r.rid] for r in reqs]
    check_tokens(res, [r.rid for r in reqs],
                 [(a.prompt, a.max_new_tokens) for a in arrivals], cfg)
    if eng.pager.leak_report():
        raise AssertionError(f"leaked pages: {eng.pager.leak_report()}")
    chunk_steps = eng.prefill_chunk_steps - c0
    stats = {"requests": rep.n_requests, "new_tokens": rep.total_tokens,
             "wall_s": wall, "tokens_per_s": rep.total_tokens / wall,
             "steps": rep.ticks, "admits": len(reqs),
             "chunk_steps": chunk_steps,
             "ticks": rep.ticks - len(reqs) - chunk_steps,
             "segments": rep.segments, "fetches": eng.fetches - f0,
             "ms_per_step": 1e3 * wall / rep.ticks,
             "ttft_p50_s": rep.ttft_p50_s, "ttft_p99_s": rep.ttft_p99_s,
             "e2e_p50_s": rep.e2e_p50_s, "e2e_p99_s": rep.e2e_p99_s}
    if eng.speculative:
        prop = sum(r.spec_proposed for r in reqs)
        acc = sum(r.spec_accepted for r in reqs)
        stats.update(proposed=prop, accepted=acc,
                     acceptance=acc / prop if prop else None,
                     spec_accept_ewma=eng.spec_accept_ewma)
    if profile:
        sch.reset()
        dev, wall_ms = device_busy(torch, lambda: sch.serve(arrivals[:8]))
        steps = eng.last_run_ticks
        sch.results()
        stats["device_ms_per_step"] = dev and dev / steps
        stats["profiled_wall_ms_per_step"] = wall_ms / steps
        stats["busy_share"] = dev and dev / wall_ms
    return stats, launches, toks


def device_busy(torch, run):
    """(device ms, wall ms) of ``run()``: the kernels' time from
    ``torch.profiler`` recording the card's activity alone (with the host
    operators' records a serve's profile takes minutes to reduce), the
    host clock around ``run()`` and a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.key.startswith(PROFILER_RECORDS))
    return (us / 1e3 if us else None), wall_ms


def near_tie(torch, llama, params, cfg, prompt, a, b):
    """Where greedy streams ``a`` and ``b`` of one prompt first differ:
    (index, the plain forward's logit gap between the two tokens there),
    or (None, 0.0) when they are equal. Two bf16 paths that round
    differently may part only where the gap is within ``LOGIT_ATOL``."""
    t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if t is None:
        return None, 0.0
    seq = np.concatenate([np.asarray(prompt, np.int64),
                          np.asarray(a[:t], np.int64)])
    with torch.no_grad():
        lg = llama.forward(params, torch.from_numpy(seq).to(DEVICE)[None],
                           cfg)[0, -1].float()
    return t, abs(float(lg[a[t]] - lg[b[t]]))


def parted_at_near_ties(torch, llama, params, cfg, prompts, xs, ys, what,
                        exact=False):
    """Hold greedy serves ``xs`` to ``ys`` request by request: each pair
    is identical or parts first at a near tie (``near_tie``), else raise;
    with ``exact`` every pair is identical. Returns the near ties."""
    ties = []
    for i, (p, a, b) in enumerate(zip(prompts, xs, ys)):
        t, gap = near_tie(torch, llama, params, cfg, p, a, b)
        if t is None:
            continue
        if exact or gap > LOGIT_ATOL:
            raise AssertionError(f"{what}: request {i} left the greedy serve "
                                 f"at token {t}, logit gap {gap} (LOGIT_ATOL "
                                 f"{LOGIT_ATOL})")
        ties.append({"token": t, "gap": gap})
    return ties


def agreement(xs, ys):
    """Requests and token positions two serves agree on."""
    same = sum(x == y for x, y in zip(xs, ys))
    pos = sum(u == v for x, y in zip(xs, ys) for u, v in zip(x, y))
    return {"requests_identical": same,
            "tokens_identical": pos / sum(len(x) for x in xs)}


def chunked_phase(torch, sched, ServingEngine, fns, params, cfg, reqs):
    """Phase 3h (a): the 32 mixed requests, one every 20 ms, through
    ``OnlineScheduler`` on a chunked engine (chunks of 16, 32 or 64 by the
    admit window) and on the unchunked one: launches, one fetch a
    segment, token agreement; then a few chunked segments issued under
    the sync-debug mode (no host read while a segment is issued)."""
    L = cfg.num_layers
    arrivals = [sched.Arrival(0.02 * i, p, g) for i, (p, g) in enumerate(reqs)]
    out, launches, toks = {}, {}, {}
    for key, kw in (("chunked", dict(chunked_prefill=True,
                                     prefill_chunks=FAMILY_CHUNKS)),
                    ("unchunked", {})):
        eng = family_engine(ServingEngine, params, cfg, **kw)
        st, n, toks[key] = family_serve(torch, sched, fns, eng, arrivals)
        check_counts(n, family_counts(L, st["steps"], st["ticks"]),
                     f"3h {key}: {st['steps']} steps, {st['ticks']} ticks")
        if st["fetches"] != st["segments"]:
            raise AssertionError(f"3h {key}: {st['fetches']} fetches for "
                                 f"{st['segments']} segments")
        out[key], launches[f"family_{key}"] = st, n
    if out["chunked"]["chunk_steps"] < 1:
        raise AssertionError("3h chunked: no prompt took more than one chunk")
    out["chunked_against_unchunked"] = agreement(toks["chunked"],
                                                 toks["unchunked"])
    audit = family_engine(ServingEngine, params, cfg, chunked_prefill=True,
                          prefill_chunks=FAMILY_CHUNKS)
    for p, g in reqs[:12]:
        audit.add_request(p, g)
    audited = 0
    while audit._queue or audit.free_slot_count() < audit.slots:
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = audit.dispatch_segment(32)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        audit.finish_segment(pending)
        audited += 1
    audit.collect_finished()
    out["chunked"]["sync_free_dispatches"] = audited
    return out, launches, toks["unchunked"]


def repeated_prompts(seqs, reqs):
    """Phase 3h (b)'s repeated-stretch class on the memorized model:
    request i's prompt is training sequence i's first c tokens (c half the
    mixed prompt's length) and then its first c // 2 again; a model that
    retrieved its sequence from the repeat would retrace tokens its
    history holds, which the n-gram draft hits. Returns [(prompt, g,
    c // 2)]: the sequence index the retrace would start at."""
    out = []
    for i, (p, g) in enumerate(reqs):
        c = len(p) // 2
        out.append((np.concatenate([seqs[i, :c], seqs[i, :c // 2]])
                    .astype(np.int32), g, c // 2))
    return out


def spec_phase(torch, sched, llama, ServingEngine, fns, params, cfg, reqs,
               plain, mparams, mreqs, seqs):
    """Phase 3h (b): greedy speculation, K = 4. On the random weights the
    first ``SPEC_RANDOM`` of the 32 mixed requests, against the same
    requests of (a)'s unchunked serve ``plain`` (whose verify ticks served
    all 32). On the memorized model, against its own
    non-speculative serve: the first ``SPEC_MEMORIZED`` of phase 3e's
    continuations ``mreqs`` (the sequences from position 0, which it
    follows), where the top logits are far apart, every request
    identical; and ``SPEC_REPEATED`` of the repeated-stretch class
    (``repeated_prompts``). The random and repeated serves are
    identical or part first at a near tie (the two tokens' logits within
    ``LOGIT_ATOL``, ``near_tie``). Some asserted class must accept drafts,
    so that ticks emitting several tokens a slot are held too."""
    L = cfg.num_layers
    rreqs = reqs[:SPEC_RANDOM]
    arrivals = [sched.Arrival(0.02 * i, p, g)
                for i, (p, g) in enumerate(rreqs)]
    out, launches = {}, {}
    eng = family_engine(ServingEngine, params, cfg, speculative=SPEC_K)
    # the verify step's device time comes from the memorized class's
    # profiled serve (the same ticks; a profile costs a serve's time again)
    st, n, toks = family_serve(torch, sched, fns, eng, arrivals,
                               profile=False)
    check_counts(n, family_counts(L, st["steps"], 0, False),
                 f"3h spec: {st['steps']} steps, {st['ticks']} verify ticks")
    ptoks = plain[0][:SPEC_RANDOM]
    st["against_plain"] = agreement(toks, ptoks)
    st["parted_at_near_ties"] = parted_at_near_ties(
        torch, llama, params, cfg, [p for p, _ in rreqs], toks, ptoks,
        "3h spec random")
    st["plain_ticks"] = f"{plain[1]['ticks']} (for all {len(reqs)})"
    out["random"], launches["family_spec"] = st, n

    mreqs = mreqs[:SPEC_MEMORIZED]
    rep = repeated_prompts(seqs, reqs[:SPEC_REPEATED])
    for key, rs, start_at in (
            ("memorized", mreqs, [len(q) for q, _ in mreqs]),
            ("repeated", [(q, g) for q, g, _ in rep],
             [c for _, _, c in rep])):
        arr = [sched.Arrival(0.0, q, g) for q, g in rs]
        serves = {}
        for which, kw in (("spec", dict(speculative=SPEC_K)), ("plain", {})):
            e = family_engine(ServingEngine, mparams, cfg, **kw)
            serves[which] = family_serve(torch, sched, fns, e, arr,
                                         profile=which == "spec"
                                         and key == "memorized")
        mst, n, mtoks = serves["spec"]
        pst, _, ptoks = serves["plain"]
        check_counts(n, family_counts(L, mst["steps"], 0, False),
                     f"3h spec {key}: {mst['steps']} steps")
        ties = parted_at_near_ties(torch, llama, mparams, cfg,
                                   [q for q, _ in rs], mtoks, ptoks,
                                   f"3h spec {key}", key == "memorized")
        mst["plain_ticks"] = pst["ticks"]
        mst["plain_tokens_per_s"] = pst["tokens_per_s"]
        mst["identical"] = len(rs) - len(ties)
        mst["parted_at_near_ties"] = ties
        # how far the serve follows its training sequence
        hit = sum(t == int(seqs[i, c + j])
                  for i, (c, ts) in enumerate(zip(start_at, mtoks))
                  for j, t in enumerate(ts))
        mst["sequence_token_rate"] = hit / sum(len(ts) for ts in mtoks)
        out[key], launches[f"family_spec_{key}"] = mst, n
    if not sum(out[k]["accepted"] for k in out):
        raise AssertionError("3h spec: no asserted class accepted a draft")
    return out, launches


def sampled_phase(torch, sched, llama, ServingEngine, fns, params, cfg,
                  reqs):
    """Phase 3h (c): sampling (T 0.8, top-k 32) at K = 0 and K = 4 on
    ``SAMPLED_REQUESTS`` of the mixed requests: each serve twice on fresh
    engines gives the
    same tokens (the per-request seeds replay), and ``top_k=1`` equals the
    greedy serve, or parts first at a near tie (``near_tie``)."""
    L = cfg.num_layers
    rs = reqs[:SAMPLED_REQUESTS]
    arrivals = [sched.Arrival(0.0, p, g) for p, g in rs]
    greedy = family_serve(torch, sched, fns,
                          family_engine(ServingEngine, params, cfg),
                          arrivals, profile=False)[2]
    out, launches = {}, {}
    for K in (0, SPEC_K):
        kw = dict(speculative=K, sampling=SAMPLED)
        # K 4's verify ticks are profiled in (b); K 0's ticks here
        st, n, toks = family_serve(
            torch, sched, fns, family_engine(ServingEngine, params, cfg,
                                             **kw), arrivals,
            profile=K == 0)
        check_counts(n, family_counts(L, st["steps"], st["ticks"], K == 0),
                     f"3h sampled K={K}: {st['steps']} steps")
        if st["fetches"] != st["segments"] and K == 0:
            raise AssertionError(f"3h sampled K=0: {st['fetches']} fetches "
                                 f"for {st['segments']} segments")
        again = family_serve(torch, sched, fns, family_engine(
            ServingEngine, params, cfg, **kw), arrivals, profile=False)[2]
        if again != toks:
            raise AssertionError(f"3h sampled K={K}: the same seeds gave "
                                 f"other tokens")
        k1 = family_serve(torch, sched, fns, family_engine(
            ServingEngine, params, cfg, speculative=K,
            sampling={"temperature": 0.8, "top_k": 1}), arrivals,
            profile=False)[2]
        ties = parted_at_near_ties(torch, llama, params, cfg,
                                   [p for p, _ in rs], k1, greedy,
                                   f"3h sampled K={K} top_k=1")
        st["ms_per_token"] = 1e3 * st["wall_s"] / st["new_tokens"]
        st["seed_replayed"] = True
        st["top_k_1"] = {"rows_equal_to_greedy": len(rs) - len(ties),
                         "parted_at_near_ties": ties}
        out[f"k{K}"], launches[f"family_sampled_k{K}"] = st, n
    return out, launches


def long_context_phase(torch, ServingEngine, fns, params, cfg, reqs):
    """Phase 3h (d): ``seq_parallel=2`` with chunked prefill (chunks of
    64, so slabs of 2 x 64 rows), ``long_buckets=(2048,)``, max_len 2048:
    one 2000-token prompt then 7 of the mixed requests behind it, in
    segments of 8 steps, so the long prefill spans segments holding its
    reservation; against a chunked engine without sp whose buckets reach
    2048 (segments of 64 steps: 32 chunks of 64 must fit twice)."""
    L = cfg.num_layers
    prompt = np.random.RandomState(5).randint(
        0, cfg.vocab_size, (SP_PROMPT,)).astype(np.int32)
    rs = [(prompt, 16)] + list(reqs[:7])
    kw = dict(chunked_prefill=True, prefill_chunks=(64,))

    def drain(eng, seg_steps):
        rids = [eng.add_request(p, g) for p, g in rs]
        carried = segments = 0
        ttft = None
        t0 = time.perf_counter()
        while eng._queue or eng.free_slot_count() < eng.slots:
            ev = eng.run_segment(seg_steps)
            segments += 1
            carried += bool(eng._sp_inflight)
            if ttft is None and rids[0] in ev["first_tokens"]:
                ttft = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = eng.collect_finished()
        check_tokens(res, rids, rs, cfg)
        if eng.pager.leak_report():
            raise AssertionError(f"3h long context leaked pages: "
                                 f"{eng.pager.leak_report()}")
        return [res[r] for r in rids], wall, segments, carried, ttft

    eng = family_engine(ServingEngine, params, cfg, max_len=SP_MAX_LEN,
                        seq_parallel=SP, long_buckets=(SP_MAX_LEN,), **kw)
    f0 = eng.fetches
    zero_counts(fns)
    toks, wall, segments, carried, ttft = drain(eng, SP_SEG_STEPS)
    launches = read_counts(fns)
    steps, chunk_steps = eng.last_run_ticks, eng.prefill_chunk_steps
    ticks = steps - len(rs) - chunk_steps
    check_counts(launches, family_counts(L, steps, ticks),
                 f"3h long context: {steps} steps, {ticks} ticks")
    fetches = eng.fetches - f0
    if fetches != segments:
        raise AssertionError(f"3h long context: {fetches} fetches for "
                             f"{segments} segments")
    if carried < 1:
        raise AssertionError("3h long context: the long prefill never "
                             "spanned segments")
    new = sum(g for _, g in rs)
    st = {"prompt_tokens": SP_PROMPT, "sp": SP, "slab_rows": SP * 64,
          "requests": len(rs), "new_tokens": new, "wall_s": wall,
          "tokens_per_s": new / wall, "steps": steps,
          "chunk_steps": chunk_steps, "ticks": ticks, "segments": segments,
          "segments_carried_over": carried, "fetches": fetches,
          "ttft_long_s": ttft, "ms_per_step": 1e3 * wall / steps}
    ref = family_engine(ServingEngine, params, cfg, max_len=SP_MAX_LEN,
                        buckets=(64, 128, 256, SP_MAX_LEN), **kw)
    rtoks, rwall, rsegs, _, rttft = drain(ref, 64)
    st["reference"] = {"wall_s": rwall, "segments": rsegs,
                       "ttft_long_s": rttft, "steps": ref.last_run_ticks}
    st["against_unsharded"] = agreement(toks, rtoks)
    # the profiled serve: the long prompt and one request behind it
    eng.reset_slots()
    rs = rs[:2]
    dev, wall_ms = device_busy(torch, lambda: drain(eng, SP_SEG_STEPS))
    st["device_ms_per_step"] = dev and dev / eng.last_run_ticks
    st["busy_share"] = dev and dev / wall_ms
    return st, launches


def family_kernel_checks(torch, pa, gen):
    """Phase 3h (e): ``ragged_paged_attention`` against its plain version
    within ``TOL`` at the phase's new shapes, bf16 and fp32, 12 heads of D
    64 on a shuffled pool: verify ticks [8, K + 1] for K in (1, 4, 7, 8)
    (K = 8 crosses into the prefill family) at ragged positions, the last
    two slots frozen at the window's end (their rows past it); prefill
    chunks of 8-64 rows at offsets off the page grid; and sp slabs of 2
    and 4 rows of 64 sharing one table row whose reservation ends inside
    the slab (the rows past it read the trash page 0, the last rows pass
    the window). Returns the largest error of each case."""
    errs = {}
    nH = Hkv = 12
    D = 64

    def case(name, B, Tq, max_pages, ctx, table=None):
        for dt in (torch.bfloat16, torch.float32):
            P = B * max_pages + 1
            kp = torch.randn(P, PAGE, Hkv, D, generator=gen,
                             device=DEVICE).to(dt)
            vp = torch.randn(P, PAGE, Hkv, D, generator=gen,
                             device=DEVICE).to(dt)
            q = torch.randn(B, Tq, nH, D, generator=gen, device=DEVICE).to(dt)
            pt = table if table is not None else (
                torch.randperm(P - 1, generator=gen, device=DEVICE)[
                    :B * max_pages] + 1).to(torch.int32).reshape(B, max_pages)
            c = torch.tensor(ctx, dtype=torch.int32, device=DEVICE)
            out = pa.ragged_paged_attention(q, kp, vp, pt, c)
            ref = pa.ragged_paged_attention_plain(q, kp, vp, pt, c)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"3h paged {name}: non-finite")
            errs[f"{name}_{str(dt)[6:]}"] = check(
                torch, f"3h ragged_paged_attention {name}", out, ref, dt)

    for K in (1, 4, 7, 8):
        case(f"verify_k{K}", 8, K + 1, 24,
             [0, 17, 100, 255, 301, 383 - K, 383, 384])
    for C, off in ((8, 29), (16, 37), (32, 45), (64, 77)):
        case(f"chunk{C}_at{off}", 1, C, 24, [off])
    for sp in (2, 4):
        max_pages, reserved, base = 128, 124, 1900
        row = torch.zeros(max_pages, dtype=torch.int32, device=DEVICE)
        row[:reserved] = (torch.randperm(sp * max_pages, generator=gen,
                                         device=DEVICE)[:reserved] + 1)
        case(f"sp{sp}_slab64", sp, 64, max_pages,
             [base + 64 * i for i in range(sp)],
             table=row[None].expand(sp, -1).contiguous())
    return errs


# ---------------------------------------------------------------------------
# phase 4: teacher-forced ticks, kernel path against plain path
# ---------------------------------------------------------------------------

def teacher_forced(torch, llama, da, tf, params, cfg, reqs, max_len, ticks):
    B = 8
    prompt = torch.tensor(np.stack([p[:64] for p, _ in reqs
                                    if len(p) >= 64][:B]),
                          dtype=torch.int64, device=DEVICE)
    if prompt.shape[0] != B:
        raise AssertionError("workload has too few prompts of >= 64 tokens")
    cache_k = llama.init_kv_cache(cfg, B, max_len, DEVICE)
    with torch.no_grad():
        llama.forward_with_cache(params, prompt, cfg, cache_k, 0)
    cache_p = {k: v.clone() for k, v in cache_k.items()}
    # ragged positions: row b continues after its first lens[b] tokens
    lens = torch.tensor([64, 1, 17, 33, 48, 63, 5, 40], dtype=torch.int32,
                        device=DEVICE)
    nxt = prompt[torch.arange(B, device=DEVICE), lens.long() - 1]
    plain = [mock.patch.object(tf, "fused_rms_norm", tf.rms_norm_plain),
             mock.patch.object(tf, "fused_add_rms_norm",
                               tf.add_rms_norm_plain),
             mock.patch.object(tf, "fused_rope_qk", tf.rope_qk_plain),
             mock.patch.object(da, "ragged_decode_attention",
                               da.ragged_decode_attention_plain)]
    max_err, agree = 0.0, 0
    pos = lens.clone()
    with torch.no_grad():
        for _ in range(ticks):
            lk, _ = llama.forward_with_cache(params, nxt[:, None], cfg,
                                             cache_k, pos)
            for p in plain:
                p.start()
            try:
                lp, _ = llama.forward_with_cache(params, nxt[:, None], cfg,
                                                 cache_p, pos)
            finally:
                for p in plain:
                    p.stop()
            if not torch.isfinite(lk).all():
                raise AssertionError("non-finite logits on the kernel path")
            max_err = max(max_err, (lk - lp).abs().max().item())
            agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
            nxt = lk.argmax(-1)          # the kernel path is the teacher
            pos = pos + 1
    if max_err > LOGIT_ATOL:
        raise AssertionError(f"teacher-forced logits differ by {max_err} > "
                             f"{LOGIT_ATOL}")
    return {"ticks": ticks, "max_abs_logit_err": max_err,
            "logit_atol": LOGIT_ATOL,
            "greedy_agreement": agree / (ticks * B)}


def teacher_forced_paged(torch, llama, pa, tf, params, cfg, reqs, max_len,
                         ticks):
    """Phase 4b: phase 4 on a paged pool behind a shuffled page table:
    the 8 prompts prefill at context 0 in one [8, 64] chunk, then ragged
    ticks run through the kernels and through the plain versions side
    by side."""
    B = 8
    max_pages = max_len // PAGE
    P = B * max_pages + 1
    prompt = torch.tensor(np.stack([p[:64] for p, _ in reqs
                                    if len(p) >= 64][:B]),
                          dtype=torch.int64, device=DEVICE)
    pt = torch.from_numpy(np.random.RandomState(1).permutation(
        np.arange(1, P)).reshape(B, max_pages).astype(np.int32)).to(DEVICE)
    pool_k = llama.init_paged_pool(cfg, P, PAGE, DEVICE)
    with torch.no_grad():
        llama.forward_with_pages(params, prompt, cfg, pool_k, pt,
                                 torch.zeros(B, dtype=torch.int32,
                                             device=DEVICE))
    pool_p = {k: v.clone() for k, v in pool_k.items()}
    lens = torch.tensor([64, 1, 17, 33, 48, 63, 5, 40], dtype=torch.int32,
                        device=DEVICE)
    nxt = prompt[torch.arange(B, device=DEVICE), lens.long() - 1]
    plain = [mock.patch.object(tf, "fused_rms_norm", tf.rms_norm_plain),
             mock.patch.object(tf, "fused_add_rms_norm",
                               tf.add_rms_norm_plain),
             mock.patch.object(tf, "fused_rope_qk", tf.rope_qk_plain),
             mock.patch.object(pa, "ragged_paged_attention",
                               pa.ragged_paged_attention_plain)]
    max_err, agree = 0.0, 0
    pos = lens.clone()
    with torch.no_grad():
        for _ in range(ticks):
            lk, _ = llama.forward_with_pages(params, nxt[:, None], cfg,
                                             pool_k, pt, pos)
            for p in plain:
                p.start()
            try:
                lp, _ = llama.forward_with_pages(params, nxt[:, None], cfg,
                                                 pool_p, pt, pos)
            finally:
                for p in plain:
                    p.stop()
            if not torch.isfinite(lk).all():
                raise AssertionError("non-finite logits on the kernel path")
            max_err = max(max_err, (lk - lp).abs().max().item())
            agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
            nxt = lk.argmax(-1)          # the kernel path is the teacher
            pos = pos + 1
    if max_err > LOGIT_ATOL:
        raise AssertionError(f"paged teacher-forced logits differ by "
                             f"{max_err} > {LOGIT_ATOL}")
    return {"ticks": ticks, "max_abs_logit_err": max_err,
            "logit_atol": LOGIT_ATOL,
            "greedy_agreement": agree / (ticks * B)}


def teacher_forced_quant(torch, llama, qm, qs, tf, params, cfg, reqs,
                         max_len, ticks, mode="int8"):
    """Phase 4c: phase 4b with the parameters quantized and a quantized
    pool: every tick projection and lm_head through ``quant_matmul`` and
    the tick kernels, against the same ticks with those swapped for their
    plain versions; attention is the dequantizing gather on both."""
    B = 8
    max_pages = max_len // PAGE
    P = B * max_pages + 1
    qparams = qs.quantize_llama_params(params, cfg, mode)
    prompt = torch.tensor(np.stack([p[:64] for p, _ in reqs
                                    if len(p) >= 64][:B]),
                          dtype=torch.int64, device=DEVICE)
    pt = torch.from_numpy(np.random.RandomState(1).permutation(
        np.arange(1, P)).reshape(B, max_pages).astype(np.int32)).to(DEVICE)
    pool_k = llama.init_paged_pool(cfg, P, PAGE, DEVICE, quant=mode)
    with torch.no_grad():
        llama.forward_with_pages(qparams, prompt, cfg, pool_k, pt,
                                 torch.zeros(B, dtype=torch.int32,
                                             device=DEVICE))
    pool_p = {k: v.clone() for k, v in pool_k.items()}
    lens = torch.tensor([64, 1, 17, 33, 48, 63, 5, 40], dtype=torch.int32,
                        device=DEVICE)
    nxt = prompt[torch.arange(B, device=DEVICE), lens.long() - 1]
    plain = [mock.patch.object(tf, "fused_rms_norm", tf.rms_norm_plain),
             mock.patch.object(tf, "fused_add_rms_norm",
                               tf.add_rms_norm_plain),
             mock.patch.object(tf, "fused_rope_qk", tf.rope_qk_plain),
             mock.patch.object(qm, "quant_matmul", qm.quant_matmul_plain)]
    max_err, agree = 0.0, 0
    pos = lens.clone()
    with torch.no_grad():
        for _ in range(ticks):
            lk, _ = llama.forward_with_pages(qparams, nxt[:, None], cfg,
                                             pool_k, pt, pos)
            for p in plain:
                p.start()
            try:
                lp, _ = llama.forward_with_pages(qparams, nxt[:, None], cfg,
                                                 pool_p, pt, pos)
            finally:
                for p in plain:
                    p.stop()
            if not torch.isfinite(lk).all():
                raise AssertionError("non-finite logits on the kernel path")
            max_err = max(max_err, (lk - lp).abs().max().item())
            agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
            nxt = lk.argmax(-1)          # the kernel path is the teacher
            pos = pos + 1
    if max_err > LOGIT_ATOL:
        raise AssertionError(f"quantized teacher-forced logits differ by "
                             f"{max_err} > {LOGIT_ATOL}")
    return {"mode": mode, "ticks": ticks, "max_abs_logit_err": max_err,
            "logit_atol": LOGIT_ATOL, "greedy_agreement": agree / (ticks * B)}


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

def plain_kernels(fa, hd):
    """Every training kernel swapped for its plain version."""
    return [mock.patch.object(fa, "flash_attention_fwd",
                              fa.flash_attention_fwd_plain),
            mock.patch.object(fa, "flash_attention_bwd",
                              fa.flash_attention_bwd_grads_plain),
            mock.patch.object(fa, "flash_attention_bwd_dq",
                              fa.flash_attention_bwd_dq_plain),
            mock.patch.object(fa, "flash_attention_bwd_dkv",
                              fa.flash_attention_bwd_dkv_plain),
            mock.patch.object(hd, "head_dx_softmax",
                              hd.head_dx_softmax_plain)]


PROFILER_RECORDS = ("Activity Buffer Request", "Runtime Triggered Module",
                    "Lazy Function Loading")
# device kernel names: the port's training kernels, cuBLAS's matmuls
HAND_WRITTEN = ("flash_fwd", "flash_bwd", "head_dx_kernel")
MATMUL = ("nvjet", "gemm", "xmma")


def train_vs_plain(torch, llama, fa, hd, params, cfg, tokens):
    """Phase 5a: one ``loss_fn`` value and gradient through the kernels and
    through their plain versions, on the same master weights and tokens."""
    def loss_and_grads():
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = llama.loss_fn(leaves, tokens, tokens, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), dict(zip(leaves, grads))

    lk, gk = loss_and_grads()
    patches = plain_kernels(fa, hd)
    for p in patches:
        p.start()
    try:
        lp, gp = loss_and_grads()
    finally:
        for p in patches:
            p.stop()
    errs = {k: ((gk[k] - g).norm() / g.norm()).item() for k, g in gp.items()}
    finite = all(torch.isfinite(g).all().item() for g in gk.values())
    out = {"batch": list(tokens.shape), "loss_kernels": lk, "loss_plain": lp,
           "loss_abs_err": abs(lk - lp), "loss_atol": TRAIN_LOSS_ATOL,
           "grad_rel_err": errs, "grad_rtol": TRAIN_GRAD_RTOL}
    if not (math.isfinite(lk) and finite):
        raise AssertionError("non-finite loss or gradient on the kernel path")
    if abs(lk - lp) > TRAIN_LOSS_ATOL:
        raise AssertionError(f"loss {lk} against the plain path's {lp}")
    worst = max(errs, key=errs.get)
    if errs[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"gradient of {worst} differs by "
                             f"{errs[worst]} of its norm")
    return out


def device_profile(torch, run, kinds=None, spans=()):
    """Device time of ``run()`` by kernel from ``torch.profiler``: total
    ms, its split by ``kinds`` (category -> substrings of kernel names, in
    order; by default the port's hand-written kernels and cuBLAS matmuls)
    and the rest (PyTorch's elementwise and reduction kernels), and the
    twelve largest entries (None where the profiler saw no device time). Only
    device entries count: the host operators that launch them report the
    same time again, and the profiler's own buffer and module-loading
    records are no kernels. ``wall_ms`` is the host clock around the same
    ``run()`` and its synchronize, so the busy share it gives reads device
    and wall time from one run (the profiler's host cost included).
    ``spans`` names ``record_function`` ranges (``host_spans``) whose host
    ms, inclusive and self, and calls are returned apart from the
    operators."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows, host, span_ms = [], [], {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.key in spans:  # a range, on the host (or its device mirror)
            if e.device_type == torch.autograd.DeviceType.CPU:
                span_ms[e.key] = {"host_ms": e.cpu_time_total / 1e3,
                                  "self_ms": e.self_cpu_time_total / 1e3,
                                  "calls": e.count}
        elif (e.device_type == torch.autograd.DeviceType.CUDA and us > 0
                and not e.key.startswith(PROFILER_RECORDS)):
            rows.append((e.key, us / 1e3, e.count))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    kinds = kinds or {"hand_written": HAND_WRITTEN, "matmul": MATMUL}
    split = {part: 0.0 for part in [*kinds, "other"]}
    largest = {part: [] for part in split}
    for k, ms, c in rows:
        part = next((part for part, names in kinds.items()
                     if any(n in k for n in names)), "other")
        split[part] += ms
        if len(largest[part]) < 3:
            largest[part].append({"name": k[:90], "ms": ms, "calls": c})
    return {"device_ms": sum(r[1] for r in rows), "wall_ms": wall_ms,
            "split_ms": split, "largest_by_kind": largest,
            "top": [{"name": k[:90], "ms": ms, "calls": c}
                    for k, ms, c in rows[:12]],
            "host_top": [{"name": k[:60], "self_ms": ms, "calls": c}
                         for k, ms, c in host[:10]],
            "spans": span_ms}


def host_spans(targets):
    """A context in which each call of ``getattr(obj, attr)``, for each
    ``(obj, attr, name)`` of ``targets``, runs inside
    ``torch.profiler.record_function(name)`` (so a profile splits the
    host time by the calls that spend it); the attributes are restored
    after."""
    from torch.profiler import record_function

    def wrap(inner, name):
        def wrapped(*args, **kwargs):
            with record_function(name):
                return inner(*args, **kwargs)
        return wrapped
    stack = contextlib.ExitStack()
    for obj, attr, name in targets:
        stack.enter_context(
            mock.patch.object(obj, attr, wrap(getattr(obj, attr), name)))
    return stack


def train_run(torch, llama, fns, params, cfg, tokens, lr=1e-4, warmup=2,
              steps=10):
    """Phases 5b-5d: ``make_train_step`` at bench.py's batch; two warm-up
    steps, then ``steps`` timed ones with every launch count at 0 before
    them; then one profiled step for the device's busy share: its device
    time over its own wall time."""
    opt = llama.init_opt_state(params)
    step = llama.make_train_step(cfg, lr=lr)
    losses = []
    for _ in range(warmup):
        losses.append(step(params, opt, tokens, tokens)[2].item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    timed_losses = []
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        timed_losses.append(step(params, opt, tokens, tokens)[2])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    L = cfg.num_layers
    check_counts(launches, {
        "flash_attention_fwd": L * steps, "flash_attention_bwd": L * steps,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
        "head_dx_softmax": steps},
        f"{steps} train steps")
    peak = torch.cuda.max_memory_allocated()
    losses += [t.item() for t in timed_losses]
    with torch.no_grad():
        final = llama.loss_fn(params, tokens, tokens, cfg).item()
    if not all(math.isfinite(x) for x in losses + [final]):
        raise AssertionError(f"non-finite training loss: {losses}, {final}")
    if not final < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses[0]} at step 0, "
                             f"{final} after {warmup + steps} steps")
    prof = device_profile(torch, lambda: step(params, opt, tokens, tokens))
    B, S = tokens.shape
    ms_step = 1e3 * wall / steps
    out = {"batch": [B, S], "lr": lr, "warmup_steps": warmup,
           "timed_steps": steps, "wall_s": wall, "ms_per_step": ms_step,
           "tokens_per_s": B * S * steps / wall,
           "event_ms_per_step": start.elapsed_time(end) / steps,
           "peak_memory_bytes": peak, "losses": losses,
           "loss_after": final}
    if prof is None:
        out["device_ms_per_step"] = "not measured"
    else:
        out["device_ms_per_step"] = prof["device_ms"]
        out["profiled_step_wall_ms"] = prof["wall_ms"]
        out["device_busy_share"] = prof["device_ms"] / prof["wall_ms"]
        out["device_split_ms"] = prof["split_ms"]
        out["device_top"] = prof["top"]
    return out, launches


# ---------------------------------------------------------------------------
# phase 6: ResNet-50 training
# ---------------------------------------------------------------------------

# BASELINE config 1, as benchmarks/resnet50.py pins it: ResNet-50
# NHWC, B 128 at 224x224, Momentum(0.1, 0.9, weight decay 1e-4), AMP O2
# bf16, CrossEntropyLoss, fused_train_step; inputs from RandomState(0)
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 128, 224, 1000
RESNET_LR, RESNET_MOMENTUM, RESNET_WD = 0.1, 0.9, 1e-4
# kernel path against plain path, two steps from the same weights under
# deterministic cuDNN (TF32 off, as set for the whole script): the update
# is the same arithmetic on both paths, so a first step that differs in
# any bit would show; bf16 params and fp32 statistics to the phase-2
# tolerances of the update
RESNET_LOSS_ATOL = 1e-3
# device kernel names by kind, for the step's time split
RESNET_KINDS = {
    "update": ("momentum_kernel", "adam_kernel", "sgd_kernel",
               "lamb_kernel"),
    "pack": ("CatArrayBatchedCopy",),
    "conv": ("xmma", "conv", "implicit_gemm", "wgrad", "dgrad", "fprop",
             "cutlass", "nhwcTo", "nchwTo", "Nhwc", "Nchw"),
    "batch_norm": ("batch_norm", "bn_fw", "bn_bw", "batchnorm", "welford"),
    "matmul": MATMUL,
}


def resnet_batch(torch):
    """Batch 0 of benchmarks/resnet50.py's three prepared host batches
    (its draws in its order: three image arrays, then three label
    arrays), on the card."""
    rng = np.random.RandomState(0)
    shape = (RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3)
    xs = [rng.rand(*shape).astype(np.float32) for _ in range(3)]
    ys = [rng.randint(0, RESNET_CLASSES, (RESNET_BATCH,)) for _ in range(3)]
    return (torch.from_numpy(xs[0]).to(DEVICE),
            torch.from_numpy(ys[0]).to(DEVICE))


def resnet_train(port, build=None):
    """The model (the port's initializers, seed 0; ResNet-50 NHWC unless
    ``build`` makes another), its optimizer under ``amp.decorate`` O2 and
    the ``fused_train_step`` over them."""
    port.seed(0)
    model = build() if build is not None else port.vision.models.resnet50(
        num_classes=RESNET_CLASSES, data_format="NHWC")
    model.train()
    opt = port.optimizer.Momentum(
        learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
        parameters=model.parameters(), weight_decay=RESNET_WD)
    model, opt = port.amp.decorate(models=model, optimizers=opt, level="O2",
                                   dtype="bfloat16")
    return model, opt, resnet_step(port, model, opt)


def resnet_step(port, model, opt):
    ce = port.nn.CrossEntropyLoss()

    def loss_fn(x, y):
        with port.amp.auto_cast(level="O2", dtype="bfloat16"):
            return ce(model(x), y)
    return port.jit.fused_train_step(loss_fn, opt, model=model)


def resnet_vs_plain(torch, port, mtu, fns, x, y, steps=2, build=None,
                    what="ResNet-50", repeat_plain=False):
    """Phase 6.1: two steps through the kernel and two through its plain
    version, each from the seed's weights, under deterministic cuDNN: the
    losses, every updated parameter and every BN running statistic
    (``build`` and ``what`` name another model). With ``repeat_plain``
    the plain path runs a second time, and ``plain_repeat_bit_identical``
    says whether the step itself is deterministic. Returns the comparison
    and the kernel path's (model, opt, step)."""
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for plain in (False, True, True)[:3 if repeat_plain else 2]:
            model, opt, step = resnet_train(port, build)
            zero_counts(fns)
            with (mock.patch.object(mtu, "multi_tensor_update",
                                    mtu.flat_update_plain) if plain
                  else contextlib.nullcontext()):
                losses = [step(x, y).item() for _ in range(steps)]
            n = read_counts(fns)["multi_tensor_update"]
            want = 0 if plain else steps * len(opt._plans)
            if n != want:
                raise AssertionError(f"{n} multi_tensor_update launches in "
                                     f"{steps} steps of the "
                                     f"{'plain' if plain else 'kernel'} path "
                                     f"of {what}, wanted {want}")
            runs.append((losses, {k: v.detach().clone() for k, v in
                                  model.state_dict().items()},
                         (model, opt, step)))
    finally:
        torch.backends.cudnn.deterministic = False
    (lk, sk, kernel_path), (lp, sp, _) = runs[:2]
    out = {"losses_kernel": lk, "losses_plain": lp,
           "loss_abs_err": max(abs(a - b) for a, b in zip(lk, lp)),
           "loss_atol": RESNET_LOSS_ATOL, "param_max_abs_err": 0.0,
           "bn_stat_max_abs_err": 0.0, "bit_identical": True}
    if repeat_plain:
        out["plain_repeat_bit_identical"] = runs[2][0] == lp and all(
            torch.equal(v, runs[2][1][k]) for k, v in sp.items())
    if not all(math.isfinite(v) for v in lk + lp):
        raise AssertionError(f"non-finite {what} loss: {lk}, {lp}")
    if out["loss_abs_err"] > RESNET_LOSS_ATOL:
        raise AssertionError(f"{what} losses {lk} against the plain "
                             f"path's {lp}")
    for k, got in sk.items():
        want = sp[k]
        out["bit_identical"] &= torch.equal(got, want)
        rtol, atol = MTU_TOL[str(want.dtype)]
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what} {k}: {m}")
        key = ("bn_stat_max_abs_err" if k.endswith(("._mean", "._variance"))
               else "param_max_abs_err")
        out[key] = max(out[key], (got.float() - want.float()).abs().max()
                       .item())
    return out, kernel_path


def resnet_run(torch, fns, step, x, y, warmup=2, steps=10,
               kinds=RESNET_KINDS, groups=1, what="ResNet-50"):
    """Phase 6.2-6.3: ``warmup`` then ``steps`` timed steps on the host
    clock with every launch count at 0 before them (exactly ``groups``
    ``multi_tensor_update`` launches a step: ResNet-50's 161 params are
    one bf16 group), then one profiled step for the busy share and the
    time split by ``kinds``."""
    for _ in range(warmup):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    t0 = time.perf_counter()
    losses = [step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    check_counts(launches, {"multi_tensor_update": steps * groups},
                 f"{steps} {what} steps")
    peak = torch.cuda.max_memory_allocated()
    losses = [t.item() for t in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite {what} loss: {losses}")
    prof = device_profile(torch, lambda: step(x, y), kinds=kinds)
    batch = x.shape[0]
    out = {"batch": batch, "size": x.shape[-2], "warmup_steps": warmup,
           "timed_steps": steps, "wall_s": wall,
           "ms_per_step": 1e3 * wall / steps,
           "images_per_s": batch * steps / wall,
           "peak_memory_bytes": peak, "losses": losses,
           "update_launches_per_step": launches["multi_tensor_update"]
           / steps, "flat_groups": groups}
    if prof is None:
        out["device_ms_per_step"] = "not measured"
    else:
        out["device_ms_per_step"] = prof["device_ms"]
        out["profiled_step_wall_ms"] = prof["wall_ms"]
        out["device_busy_share"] = prof["device_ms"] / prof["wall_ms"]
        out["device_split_ms"] = prof["split_ms"]
        out["update_kernel_share"] = (prof["split_ms"]["update"]
                                      / prof["device_ms"])
        out["device_top"] = prof["top"]
        out["device_largest_by_kind"] = prof["largest_by_kind"]
        out["host_top"] = prof["host_top"]
    return out, launches


def resnet_adamw(torch, port, fns, model, x, y, steps=3):
    """Phase 6.4: ``AdamW(multi_precision=True)`` on the O2 model, one
    adam-with-master launch per step; its state fp32 and flat."""
    opt = port.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                               parameters=model.parameters(),
                               multi_precision=True)
    step = resnet_step(port, model, opt)
    zero_counts(fns)
    losses = [step(x, y).item() for _ in range(steps)]
    launches = read_counts(fns)
    check_counts(launches, {"multi_tensor_update": steps},
                 f"{steps} ResNet-50 AdamW steps")
    st = opt._accumulators[id(model.parameters()[0])]
    if not (st["master"].dtype == st["moment1"].dtype == torch.float32
            and st["master"].dim() == 2):
        raise AssertionError("O2 AdamW state is not fp32 and flat")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite ResNet-50 AdamW loss: {losses}")
    return {"steps": steps, "losses": losses}, launches


# ---------------------------------------------------------------------------
# phase 6d: the PaddleClas zoo
# ---------------------------------------------------------------------------

# MobileNetV3-large trained as phase 6 trains ResNet-50, but NCHW (the
# family's layout in the JAX package): B 128 at 224x224, Momentum(0.1,
# 0.9, 1e-4), AMP O2 bf16, CrossEntropyLoss, fused_train_step; inputs
# from RandomState(0)
ZOO_BATCH, ZOO_SIZE, ZOO_CLASSES = 128, 224, 1000
# device kernel names by kind for MobileNetV3's step: depthwise
# convolutions apart from the others (PyTorch's own depthwise kernels
# name themselves so), the pools (the global average
# pools run as mean reductions), then the activations and other
# elementwise kernels and reductions
ZOO_KINDS = {
    "update": RESNET_KINDS["update"],
    "pack": RESNET_KINDS["pack"],
    "depthwise_conv": ("depthwise", "Depthwise"),
    "conv": RESNET_KINDS["conv"],
    "batch_norm": RESNET_KINDS["batch_norm"],
    "pool": ("pool", "Pool", "adaptive", "MeanOps"),
    "elementwise": ("elementwise", "vectorized", "unrolled", "hardswish",
                    "hardsigmoid", "threshold", "clamp", "Activation",
                    "CatArray", "where", "reduce_kernel"),
    "matmul": MATMUL,
}
# the other families, one builder each (pretrained=False, 1000 classes),
# at their own input sizes
ZOO_BUILDERS = [("alexnet", {}, 224), ("vgg16", {"batch_norm": True}, 224),
                ("squeezenet1_1", {}, 224), ("mobilenet_v1", {}, 224),
                ("mobilenet_v2", {}, 224), ("mobilenet_v3_small", {}, 224),
                ("shufflenet_v2_x1_0", {}, 224), ("densenet121", {}, 224),
                ("googlenet", {}, 224), ("inception_v3", {}, 299)]
ZOO_FWD_BATCH, ZOO_STEP_BATCH = 2, 32
# fp32 eval forward on the card against the same weights on the CPU, TF32
# off: the convolutions sum in other orders (cuDNN's algorithms against
# the CPU's), through up to 120 layers, each rounding at float32's 6e-8,
# so each logit within 1e-4 of the largest |logit|
ZOO_FWD_RTOL = 1e-4


def zoo_batch(torch, batch, size, classes):
    """NCHW images in [0, 1) and labels from ``RandomState(0)``, on the
    card."""
    rng = np.random.RandomState(0)
    x = rng.rand(batch, 3, size, size).astype(np.float32)
    y = rng.randint(0, classes, (batch,))
    return (torch.from_numpy(x).to(DEVICE), torch.from_numpy(y).to(DEVICE))


def zoo_mobilenet(torch, port, mtu, fns):
    """Phase 6d.1: ``mobilenet_v3_large`` trained as phase 6 trains
    ResNet-50: the kernel path against the plain path (the plain path
    twice, so a step that is not deterministic on the card shows apart
    from the update), then the timed and profiled steps."""
    def build():
        return port.vision.models.mobilenet_v3_large(num_classes=ZOO_CLASSES)

    x, y = zoo_batch(torch, ZOO_BATCH, ZOO_SIZE, ZOO_CLASSES)
    vsp, (model, opt, step) = resnet_vs_plain(
        torch, port, mtu, fns, x, y, build=build, what="MobileNetV3-large",
        repeat_plain=True)
    groups = len(opt._plans)
    run, launches = resnet_run(torch, fns, step, x, y, kinds=ZOO_KINDS,
                               groups=groups, what="MobileNetV3-large")
    run["parameters"] = len(model.parameters())
    run["parameter_elements"] = sum(p.numel() for p in model.parameters())
    return vsp, run, launches


def zoo_family(torch, port, device_mod, fns, name, kw, size):
    """Phase 6d.2 for one builder: built on the CPU (seed 0), an fp32 eval
    forward at B 2 there and on the card from the same weights, then one
    warm and one timed O2 fused Momentum step at B 32 with its update
    launches counted."""
    port.seed(0)
    prev = device_mod.set_device("cpu")
    try:
        model = getattr(port.vision.models, name)(num_classes=ZOO_CLASSES,
                                                  **kw)
    finally:
        device_mod.set_device(prev)
    model.eval()
    xf, _ = zoo_batch(torch, ZOO_FWD_BATCH, size, ZOO_CLASSES)
    with torch.no_grad():
        cpu = model(xf.cpu())
        model.to(DEVICE)
        card = model(xf)
    dev = torch.device(DEVICE).type
    if not (card.device.type == dev and all(p.device.type == dev
                                             for p in model.parameters())):
        raise AssertionError(f"{name}: the card's forward did not run there")
    card = card.cpu()
    err = (card - cpu).abs().max().item()
    scale = cpu.abs().max().item()
    if not (torch.isfinite(card).all() and err <= ZOO_FWD_RTOL * scale):
        raise AssertionError(f"{name}: the card's fp32 eval logits are "
                             f"{err:.3e} from the CPU's (largest |logit| "
                             f"{scale:.3e}, rtol {ZOO_FWD_RTOL})")
    model.train()
    opt = port.optimizer.Momentum(
        learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
        parameters=model.parameters(), weight_decay=RESNET_WD)
    model, opt = port.amp.decorate(models=model, optimizers=opt, level="O2",
                                   dtype="bfloat16")
    step = resnet_step(port, model, opt)
    x, y = zoo_batch(torch, ZOO_STEP_BATCH, size, ZOO_CLASSES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    first = step(x, y).item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = step(x, y).item()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = read_counts(fns)
    groups = len(opt._plans)
    check_counts(launches, {"multi_tensor_update": 2 * groups},
                 f"two {name} steps")
    if not (math.isfinite(first) and math.isfinite(loss)):
        raise AssertionError(f"{name}: non-finite O2 loss {first}, {loss}")
    return {"input": size, "fwd_max_abs_err": err, "fwd_max_abs_logit":
            scale, "losses": [first, loss], "ms_step": ms,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "flat_groups": groups,
            "update_launches_per_step": launches["multi_tensor_update"] / 2,
            "parameters": len(model.parameters())}, launches


# ---------------------------------------------------------------------------
# phase 6b: BASELINE config 0, Model.fit of LeNet on MNIST
# ---------------------------------------------------------------------------

# BASELINE config 0, as benchmarks/mnist_fit.py runs it: LeNet on the
# 6000-sample synthetic MNIST (the reference's RandomState(42) set),
# Model.prepare(Adam(1e-3), CrossEntropyLoss, Accuracy), fit(epochs=1,
# batch_size=256): 24 batches, the last of 112; LeNet's 10 fp32 params
# are one flat group, so each step makes one multi_tensor_update launch
MNIST_BATCH, MNIST_LR = 256, 1e-3
MNIST_BATCHES = 24      # ceil(6000 / 256)
MNIST_VS_PLAIN_STEPS = 4
# the scheduled, clipped fit: a cosine over the fit's 24 steps, a global
# norm of 1 and L2 decay of 1e-4 (PaddleClas' recipe shape at LeNet size)
MNIST_T_MAX, MNIST_CLIP, MNIST_L2 = MNIST_BATCHES, 1.0, 1e-4
# multi_tensor_update at LeNet's population (10 tensors of 61,610
# elements in 486 rows of 128, the plan padded to 496 rows: 63,488): fp32
# Adam, the fit's update, against torch._fused_adam_
LENET_VARIANT = ("adam_fp32", "adam", dict(_ADAM), "float32", "float32",
                 False, "adam")


def mnist_model(port, seed=0, **opt_kw):
    """The recipe's ``Model``: LeNet from the port's initializers under
    ``seed``, prepared with Adam (``MNIST_LR`` unless ``learning_rate`` is
    given), ``CrossEntropyLoss`` and ``Accuracy``."""
    port.seed(seed)
    net = port.vision.models.LeNet()
    model = port.Model(net)
    opt_kw.setdefault("learning_rate", MNIST_LR)
    model.prepare(port.optimizer.Adam(parameters=net.parameters(), **opt_kw),
                  port.nn.CrossEntropyLoss(), port.metric.Accuracy())
    return model


def mnist_recorder(port):
    """A callback that times each batch: the loader's share (from the end
    of one batch to the start of the next: the ``DataLoader``'s collate
    and the copy to the card), and records each batch's loss and the
    optimizer's learning rate."""

    class Recorder(port.callbacks.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            self.loader_s, self.losses, self.lrs = [], [], []
            self._t = time.perf_counter()

        def on_train_batch_begin(self, step, logs=None):
            self.loader_s.append(time.perf_counter() - self._t)
            self.lrs.append(self.model._optimizer.get_lr())

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self._t = time.perf_counter()
    return Recorder()


def timed_train_batch(model):
    """Wrap ``model.train_batch`` so each call's host seconds are kept in
    the returned list (the call ends in the batch's one device read, so
    its time covers the step on the card)."""
    times, inner = [], model.train_batch

    def train_batch(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return inner(*args, **kwargs)
        finally:
            times.append(time.perf_counter() - t0)
    model.train_batch = train_batch
    return times


def mnist_vs_plain(torch, port, mtu, fns, train):
    """Phase 6b.1: two fits of ``MNIST_VS_PLAIN_STEPS`` steps from the
    same seeded LeNet, in order and under deterministic cuDNN, one through
    the kernel and one through its plain version: every batch's loss and
    every parameter within ``MTU_TOL``, and exactly one launch a step on
    the kernel fit, none on the plain fit."""
    steps = MNIST_VS_PLAIN_STEPS
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for plain in (False, True):
            model = mnist_model(port)
            rec = mnist_recorder(port)
            zero_counts(fns)
            with (mock.patch.object(mtu, "multi_tensor_update",
                                    mtu.flat_update_plain) if plain
                  else contextlib.nullcontext()):
                model.fit(train, epochs=1, batch_size=MNIST_BATCH,
                          shuffle=False, verbose=0, num_iters=steps,
                          callbacks=[rec])
            n = read_counts(fns)
            if not plain:
                check_counts(n, {"multi_tensor_update": steps},
                             "the LeNet kernel fit")
            elif any(n.values()):
                raise AssertionError(f"launches on the plain LeNet fit: {n}")
            runs.append((rec.losses, {k: v.detach().clone() for k, v in
                                      model.network.state_dict().items()}))
    finally:
        torch.backends.cudnn.deterministic = False
    (lk, sk), (lp, sp) = runs
    out = {"steps": steps, "losses_kernel": lk, "losses_plain": lp,
           "param_max_abs_err": 0.0, "bit_identical": True}
    rtol, atol = MTU_TOL["torch.float32"]
    np.testing.assert_allclose(lk, lp, rtol=rtol, atol=atol,
                               err_msg="LeNet losses, kernel against plain")
    out["loss_max_abs_err"] = max(abs(a - b) for a, b in zip(lk, lp))
    for k, got in sk.items():
        want = sp[k]
        out["bit_identical"] &= torch.equal(got, want)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"LeNet {k}: {m}")
        out["param_max_abs_err"] = max(
            out["param_max_abs_err"], (got - want).abs().max().item())
    return out


# the calls a profiled fit's host time is split by (``host_spans``): one
# range each, nested as the calls are (the update holds the pack and the
# unpack; train_batch holds the rest). The kernel's launch is no range of
# its own (its wrapper counts launches through its module name, which a
# wrapper of ours would take): its host time is in the update's self time
MNIST_SPANS = ("mnist.train_batch", "mnist.to_device", "mnist.forward",
               "mnist.loss", "mnist.accuracy", "mnist.backward",
               "mnist.clip", "mnist.update", "mnist.pack", "mnist.unpack",
               "mnist.fetch", "mnist.metrics", "mnist.telemetry")


def mnist_span_targets(torch, port, mtu, model):
    """(object, attribute, span) for each of ``MNIST_SPANS``: the
    ``Model``'s batch and its parts, the fused step's ``autograd.grad``,
    the optimizer's clip and update, and inside the update the plan's
    pack and the unpack into views."""
    hapi_model = sys.modules[port.Model.__module__]
    opt = model._optimizer
    return [
        (model, "train_batch", "mnist.train_batch"),
        (hapi_model, "_as_tensor_batch", "mnist.to_device"),
        (model.network, "forward", "mnist.forward"),
        (model, "_compute_loss", "mnist.loss"),
        (model, "_traced_pres", "mnist.accuracy"),
        (torch.autograd, "grad", "mnist.backward"),
        (opt, "_clip", "mnist.clip"),
        (opt, "_update", "mnist.update"),
        (mtu.FlatPlan, "pack", "mnist.pack"),
        (mtu.FlatPlan, "unpack", "mnist.unpack"),
        (hapi_model, "_fetch", "mnist.fetch"),
        (model, "_update_metrics", "mnist.metrics"),
        (model, "_record_train_step", "mnist.telemetry")]


def mnist_recipe(torch, port, mtu, fns, train, test):
    """Phase 6b.2: benchmarks/mnist_fit.py's recipe, one warm fit then one
    timed fit (every count at 0 before it): samples/s, ms a step, the
    loader's and ``train_batch``'s ms a batch, launches; then one fit
    under the profiler, its host time split by ``MNIST_SPANS``, for the
    device's busy share and the host's bottlenecks, one under
    ``set_sync_debug_mode("warn")`` counting synchronising calls, and
    ``evaluate`` on the test set."""
    model = mnist_model(port)
    model.fit(train, epochs=1, batch_size=MNIST_BATCH, verbose=0)  # warm
    rec = mnist_recorder(port)
    step_s = timed_train_batch(model)
    torch.cuda.synchronize()
    zero_counts(fns)
    t0 = time.perf_counter()
    model.fit(train, epochs=1, batch_size=MNIST_BATCH, verbose=0,
              callbacks=[rec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    n = len(rec.losses)
    if n != MNIST_BATCHES:
        raise AssertionError(f"{n} batches in the MNIST fit, wanted "
                             f"{MNIST_BATCHES}")
    check_counts(launches, {"multi_tensor_update": n}, "the MNIST fit")
    if not all(math.isfinite(v) for v in rec.losses):
        raise AssertionError(f"non-finite MNIST loss: {rec.losses}")
    out = {"batches": n, "batch": MNIST_BATCH, "samples": len(train),
           "wall_s": wall, "samples_per_s": len(train) / wall,
           "ms_per_step": 1e3 * wall / n,
           "loader_ms_per_batch": 1e3 * sum(rec.loader_s) / n,
           "train_batch_ms_per_batch": 1e3 * sum(step_s) / n,
           "launches_per_step": launches["multi_tensor_update"] / n,
           "first_loss": rec.losses[0], "last_loss": rec.losses[-1]}
    step_s.clear()

    def fit():
        model.fit(train, epochs=1, batch_size=MNIST_BATCH, verbose=0)
    # one profiled fit gives the device time, its own wall (the busy share
    # reads both from that fit; the profiler's host cost is in its wall)
    # and the host time inside train_batch split by the calls that spend it
    with host_spans(mnist_span_targets(torch, port, mtu, model)):
        prof = device_profile(torch, fit, spans=MNIST_SPANS)
    if prof is None:
        out["device_ms"] = "not measured"
        out["device_busy_share"] = out["device_over_timed_wall"] = None
    else:
        out["device_ms"] = prof["device_ms"]
        out["profiled_fit_wall_ms"] = prof["wall_ms"]
        out["device_busy_share"] = prof["device_ms"] / prof["wall_ms"]
        # the same device time over the unprofiled fit's wall: a second
        # reading, across two fits
        out["device_over_timed_wall"] = prof["device_ms"] / (1e3 * wall)
        spans = prof["spans"]
        missing = [k for k in MNIST_SPANS if k not in spans]
        if missing:
            raise AssertionError(f"no host span recorded for {missing}")
        out["host_ms_per_batch"] = {
            k: {"host_ms": v["host_ms"] / n, "self_ms": v["self_ms"] / n,
                "calls_per_batch": v["calls"] / n}
            for k, v in sorted(spans.items(), key=lambda kv: -kv[1][
                "host_ms"])}
        out["host_top"] = prof["host_top"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fit()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    out["syncs_per_batch"] = syncs / MNIST_BATCHES
    logs = model.evaluate(test, batch_size=MNIST_BATCH, verbose=0)
    out["eval"] = logs
    if not 0.0 <= logs["acc"] <= 1.0 or not math.isfinite(logs["loss"]):
        raise AssertionError(f"MNIST evaluate: {logs}")
    return out, launches, model


def mnist_scheduled(torch, port, mtu, fns, train):
    """Phase 6b.3: a fit with ``CosineAnnealingDecay`` stepped by the
    ``LRScheduler`` callback, ``ClipGradByGlobalNorm`` and ``L2Decay``:
    one launch a step, and the rate each launch received equal to
    ``lr.py``'s sequence (read by a spy that passes every call on)."""
    lr = port.optimizer.lr
    model = mnist_model(
        port, learning_rate=lr.CosineAnnealingDecay(MNIST_LR, MNIST_T_MAX),
        grad_clip=port.nn.ClipGradByGlobalNorm(MNIST_CLIP),
        weight_decay=port.optimizer.L2Decay(MNIST_L2))
    rec = mnist_recorder(port)
    got, inner = [], mtu.apply_flat_update

    def spy(kind, plan, pvals, gvals, svals, hyper, lr_, step, skip=None):
        got.append(lr_)
        return inner(kind, plan, pvals, gvals, svals, hyper, lr_, step, skip)
    zero_counts(fns)
    with mock.patch.object(mtu, "apply_flat_update", spy):
        model.fit(train, epochs=1, batch_size=MNIST_BATCH, verbose=0,
                  callbacks=[port.callbacks.LRScheduler(), rec])
    launches = read_counts(fns)
    check_counts(launches, {"multi_tensor_update": MNIST_BATCHES},
                 "the scheduled MNIST fit")
    want = lr.CosineAnnealingDecay(MNIST_LR, MNIST_T_MAX)
    seq = []
    for _ in range(MNIST_BATCHES):
        seq.append(want.get_lr())
        want.step()
    if got != seq or rec.lrs != seq:
        raise AssertionError(f"scheduled rates {got} / logged {rec.lrs}, "
                             f"lr.py's {seq}")
    if not all(math.isfinite(v) for v in rec.losses):
        raise AssertionError(f"non-finite scheduled loss: {rec.losses}")
    return {"lrs": got, "losses": rec.losses,
            "launches_per_step": launches["multi_tensor_update"]
            / MNIST_BATCHES}, launches


def mnist_checkpoint(torch, port, model, test):
    """Phase 6b.4: ``Model.save`` into a directory of the checkout that is
    removed after, then ``load`` into a fresh model (other weights) and
    ``evaluate`` both under deterministic cuDNN: equal logs."""
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(dir=ROOT) as d:
            path = os.path.join(d, "final")
            model.save(path)
            want = model.evaluate(test, batch_size=MNIST_BATCH, verbose=0)
            fresh = mnist_model(port, seed=1)
            before = fresh.evaluate(test, batch_size=MNIST_BATCH,
                                    verbose=0)
            fresh.load(path)
            got = fresh.evaluate(test, batch_size=MNIST_BATCH, verbose=0)
    finally:
        torch.backends.cudnn.deterministic = False
    if got != want or before == want:
        raise AssertionError(f"checkpoint round trip: {got} against "
                             f"{want} (before loading {before})")
    if fresh._optimizer._step_count != model._optimizer._step_count:
        raise AssertionError("the optimizer state did not load")
    return {"eval": got, "fresh_eval_before_load": before,
            "optimizer_step": fresh._optimizer._step_count}


# ---------------------------------------------------------------------------
# phases 5c and 6c: BASELINE config 2, BERT/ERNIE-base MLM pretraining
# ---------------------------------------------------------------------------

# bench.py's config-2 batch; the kernel-against-plain and eager batches
BERT_BATCH, BERT_SEQ, BERT_VS_PLAIN_BATCH = 44, 512, 8
BERT_LR = 1e-4
# the kernel step's global gradient norm against the plain step's: the
# norm sums every parameter's squares, so bf16 rounding differences
# average out (1.2 % rounding noise of one gradient falls well inside)
BERT_GNORM_RTOL = 1e-2
EAGER_BATCH, EAGER_STEPS = 8, 3


def bert_vs_plain(torch, bert, fa, params, cfg, tokens, labels):
    """Phase 5c (a): one ``loss_fn`` value and gradient through the flash
    kernels, through their plain versions (``mock.patch``), and through
    the plain versions in fp32 (``cfg`` at fp32, the same master weights
    and batch), which both bf16 paths are held to. Budgets: the loss
    within ``TRAIN_LOSS_ATOL`` of the plain path's and the global gradient
    norm within ``BERT_GNORM_RTOL`` of it; each parameter's gradient no
    farther from the fp32 path's than the plain bf16 path's is, plus
    ``TRAIN_GRAD_RTOL`` (relative Frobenius errors). A gradient that sums
    every position (``type_embed``: all 4096 tokens of segment 0) cancels
    in bf16 on both paths alike, so the distance between the two bf16
    paths alone says nothing there."""
    import dataclasses

    def loss_and_grads(c, plain):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(mock.patch.object(
                    fa, "flash_attention_fwd", fa.flash_attention_fwd_plain))
                stack.enter_context(mock.patch.object(
                    fa, "flash_attention_bwd",
                    fa.flash_attention_bwd_grads_plain))
            loss = bert.loss_fn(leaves, tokens, labels, c)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), dict(zip(leaves, grads))

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    def gnorm(g):
        return math.sqrt(sum(x.float().square().sum().item()
                             for x in g.values()))

    lk, gk = loss_and_grads(cfg, False)
    lp, gp = loss_and_grads(cfg, True)
    lt, gt = loss_and_grads(dataclasses.replace(cfg, dtype=torch.float32),
                            True)
    errs = {k: {"kernel_vs_plain": rel(gk[k], gp[k]),
                "kernel_vs_fp32": rel(gk[k], gt[k]),
                "plain_vs_fp32": rel(gp[k], gt[k])} for k in gt}
    nk, np_ = gnorm(gk), gnorm(gp)
    if not (math.isfinite(lk) and all(torch.isfinite(g).all().item()
                                      for g in gk.values())):
        raise AssertionError("non-finite BERT loss or gradient on the "
                             "kernel path")
    if abs(lk - lp) > TRAIN_LOSS_ATOL:
        raise AssertionError(f"BERT loss {lk} against the plain path's {lp}")
    if abs(nk - np_) > BERT_GNORM_RTOL * np_:
        raise AssertionError(f"BERT gradient norm {nk} against the plain "
                             f"path's {np_}")
    for k, e in errs.items():
        if e["kernel_vs_fp32"] > e["plain_vs_fp32"] + TRAIN_GRAD_RTOL:
            raise AssertionError(f"BERT gradient of {k}: {e}")
    return {"batch": list(tokens.shape), "loss_kernels": lk,
            "loss_plain": lp, "loss_fp32": lt, "loss_abs_err": abs(lk - lp),
            "loss_atol": TRAIN_LOSS_ATOL, "grad_norm_kernels": nk,
            "grad_norm_plain": np_, "grad_norm_rtol": BERT_GNORM_RTOL,
            "grad_rel_err": errs, "grad_rtol": TRAIN_GRAD_RTOL}


def bert_run(torch, bert, fns, params, cfg, tokens, labels, warmup=1,
             steps=10):
    """Phase 5c (b): ``make_train_step`` (the global-norm clip, AdamW at
    ``BERT_LR``) at bench.py's batch; ``warmup`` steps, then ``steps``
    timed ones with every launch count at 0 before them (the flash forward
    and the one-launch backward once a layer a step, nothing else of the
    port's kernels), then one profiled step for the busy share."""
    opt = bert.init_opt_state(params)
    step = bert.make_train_step(cfg, lr=BERT_LR, device=DEVICE)
    losses = [step(params, opt, tokens, labels)[2].item()
              for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    timed_losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        timed_losses.append(step(params, opt, tokens, labels)[2])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    L = cfg.num_layers
    check_counts(launches, {"flash_attention_fwd": L * steps,
                            "flash_attention_bwd": L * steps},
                 f"{steps} BERT train steps")
    peak = torch.cuda.max_memory_allocated()
    losses += [t.item() for t in timed_losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite BERT loss: {losses}")
    prof = device_profile(torch, lambda: step(params, opt, tokens, labels))
    B, S = tokens.shape
    out = {"batch": [B, S], "lr": BERT_LR, "warmup_steps": warmup,
           "timed_steps": steps, "wall_s": wall,
           "ms_per_step": 1e3 * wall / steps,
           "tokens_per_s": B * S * steps / wall,
           "masked_tokens_per_step": int((labels != bert.IGNORE_INDEX)
                                         .sum().item()),
           "peak_memory_bytes": peak, "losses": losses}
    if prof is None:
        out["device_ms_per_step"] = "not measured"
    else:
        out["device_ms_per_step"] = prof["device_ms"]
        out["profiled_step_wall_ms"] = prof["wall_ms"]
        out["device_busy_share"] = prof["device_ms"] / prof["wall_ms"]
        out["device_split_ms"] = prof["split_ms"]
        out["device_top"] = prof["top"]
    return out, launches


def bert_phase(torch, bert, fa, fns):
    """Phase 5c: BERT-base MLM pretraining (``BertConfig.bert_base``: V
    30522, 12 layers, H 768, 12 heads of D 64, F 3072; bf16 compute over
    fp32 master weights from seed 0, remat on), kernel against plain at B
    8, then the timed run at B 44 x S 512 (``random_mlm_batch``, seed 0),
    then one ``ernie_base`` step (V 18000, 4 segment types) at the same
    batch with its launches counted."""
    cfg = bert.BertConfig.bert_base()
    params = bert.init_params(cfg, torch.Generator(device=DEVICE)
                              .manual_seed(0), device=DEVICE)
    tok8, lab8 = bert.random_mlm_batch(cfg, BERT_VS_PLAIN_BATCH, BERT_SEQ,
                                       seed=1, device=DEVICE)
    vs_plain = bert_vs_plain(torch, bert, fa, params, cfg, tok8, lab8)
    tokens, labels = bert.random_mlm_batch(cfg, BERT_BATCH, BERT_SEQ, seed=0,
                                           device=DEVICE)
    run, launches = bert_run(torch, bert, fns, params, cfg, tokens, labels)
    del params
    ecfg = bert.BertConfig.ernie_base()
    eparams = bert.init_params(ecfg, torch.Generator(device=DEVICE)
                               .manual_seed(0), device=DEVICE)
    etok, elab = bert.random_mlm_batch(ecfg, BERT_BATCH, BERT_SEQ, seed=0,
                                       device=DEVICE)
    types = torch.arange(BERT_SEQ, device=etok.device) * 4 // BERT_SEQ
    opt = bert.init_opt_state(eparams)
    zero_counts(fns)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the step with segment types: the trainer's loss has none, so the
    # forward with token_type_ids is checked apart, beside the step
    with torch.no_grad():
        elogits = bert.forward(eparams, etok[:2], ecfg,
                               token_type_ids=types.expand(2, -1))
    _, _, eloss = bert.train_step(eparams, opt, etok, elab, ecfg,
                                  lr=BERT_LR)
    eloss = eloss.item()
    torch.cuda.synchronize()
    ems = 1e3 * (time.perf_counter() - t0)
    elaunches = read_counts(fns)
    L = ecfg.num_layers
    check_counts(elaunches, {"flash_attention_fwd": 2 * L,
                             "flash_attention_bwd": L},
                 "one ernie_base step and a forward")
    if not (math.isfinite(eloss) and tuple(elogits.shape) == (
            2, BERT_SEQ, ecfg.vocab_size) and torch.isfinite(
                elogits.float()).all().item()):
        raise AssertionError(f"ernie_base: loss {eloss}, logits "
                             f"{tuple(elogits.shape)}")
    ernie = {"vocab_size": ecfg.vocab_size,
             "type_vocab_size": ecfg.type_vocab_size,
             "batch": [BERT_BATCH, BERT_SEQ], "loss": eloss,
             "first_step_ms_with_forward": ems}
    return {"vs_plain": vs_plain, "run": run, "ernie_base": ernie}, \
        launches, elaunches


def eager_bert(port, cfg):
    """Phase 6c's model: ``Embedding`` -> ``TransformerEncoder`` (12 x
    768, 12 heads, 3072, gelu, post-LN, hidden dropout 0.1,
    ``attn_dropout=0.0``) -> ``Linear`` to the vocabulary, and AdamW with
    BERT's decay rule (no decay on biases, norms and the embedding)."""
    port.seed(0)
    layer = port.nn.TransformerEncoderLayer(
        cfg.hidden_size, cfg.num_heads, cfg.intermediate_size, dropout=0.1,
        activation="gelu", attn_dropout=0.0)
    model = port.nn.Sequential(
        port.nn.Embedding(cfg.vocab_size, cfg.hidden_size),
        port.nn.TransformerEncoder(layer, cfg.num_layers),
        port.nn.Linear(cfg.hidden_size, cfg.vocab_size))
    decay = {p.name for n, p in model.named_parameters()
             if n.endswith("weight") and p.dim() == 2 and not n.startswith("0.")}
    opt = port.optimizer.AdamW(learning_rate=BERT_LR,
                               parameters=model.parameters(),
                               weight_decay=0.01,
                               apply_decay_param_fun=lambda n: n in decay)
    return model, opt


def eager_phase(torch, port, bert, fns):
    """Phase 6c: the eager stack at BERT-base width, fp32 (the fp32 flash
    instance) and under ``amp.auto_cast(dtype="bfloat16")`` (the bf16
    kernels): ``loss.backward(); opt.step(); opt.clear_grad()`` at B 8 x
    S 512 with ``nn.CrossEntropyLoss(ignore_index=-100)``, one warm step
    then ``EAGER_STEPS`` timed ones each, launches counted: 12 flash
    forwards and backwards a step of the dtype's kernels, the flat AdamW
    update's launches the same every step."""
    cfg = bert.BertConfig.bert_base()
    tokens, labels = bert.random_mlm_batch(cfg, EAGER_BATCH, BERT_SEQ,
                                           seed=2, device=DEVICE)
    tokens, labels = tokens.long(), labels.long()
    ce = port.nn.CrossEntropyLoss(ignore_index=-100)
    out, launches = {}, {}
    for mode in ("fp32", "bf16_auto_cast"):
        model, opt = eager_bert(port, cfg)
        amp = mode != "fp32"

        def step():
            with port.amp.auto_cast(enable=amp, dtype="bfloat16"):
                loss = ce(model(tokens), labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        zero_counts(fns)
        losses = [step().item()]
        torch.cuda.synchronize()
        warm = read_counts(fns)
        per_step = warm["multi_tensor_update"]
        if per_step < 1:
            raise AssertionError(f"6c {mode}: the AdamW step launched no "
                                 f"multi_tensor_update")
        torch.cuda.reset_peak_memory_stats()
        zero_counts(fns)
        t0 = time.perf_counter()
        timed_losses = [step() for _ in range(EAGER_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_counts(fns)
        L, k = cfg.num_layers, EAGER_STEPS
        sfx = "" if amp else "_f32"
        check_counts(n, {f"flash_attention_fwd{sfx}": L * k,
                         f"flash_attention_bwd{sfx}": L * k,
                         "multi_tensor_update": per_step * k},
                     f"{k} eager {mode} steps")
        losses += [t.item() for t in timed_losses]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"6c {mode}: non-finite loss {losses}")
        out[mode] = {"batch": [EAGER_BATCH, BERT_SEQ], "timed_steps": k,
                     "wall_s": wall, "ms_per_step": 1e3 * wall / k,
                     "tokens_per_s": EAGER_BATCH * BERT_SEQ * k / wall,
                     "multi_tensor_update_per_step": per_step,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "losses": losses}
        # the fp32 flash kernels apart from the other hand-written ones
        prof = device_profile(torch, step, kinds={
            "flash_f32": ("flash_fwd_f32", "flash_bwd_f32"),
            "hand_written": HAND_WRITTEN, "matmul": MATMUL})
        if prof is None:
            out[mode]["device_ms_per_step"] = "not measured"
        else:
            out[mode].update(
                flash_f32_device_ms=prof["split_ms"]["flash_f32"],
                device_ms_per_step=prof["device_ms"],
                profiled_step_wall_ms=prof["wall_ms"],
                device_busy_share=prof["device_ms"] / prof["wall_ms"],
                device_split_ms=prof["split_ms"], device_top=prof["top"][:6],
                host_top=prof["host_top"][:6])
        launches[f"eager_{mode}"] = n
        del model, opt
        torch.cuda.empty_cache()
    return out, launches


# phase 3i: the host KV tier behind the paged prefix cache, and the SLO
# control plane, at bert_base_equiv width in bf16
TIER_TENANTS = 16       # tenants, each with its own prefix
TIER_PREFIX = 256       # prefix tokens (16 pages)
TIER_TAIL = 32          # tail tokens of each request
TIER_ROUNDS = 3         # round-robin rounds over the tenants
TIER_GEN = 32           # tokens generated a request
TIER_MAX_LEN = 512
TIER_POOL_PAGES = 96    # usable pages of the tight pool (~57 MB)
TIER_CACHE_PAGES = 48   # the prefix cache's bound in pool pages
TIER_HOST_PAGES = 1024  # the host tier's bound (~604 MB pinned)
SLO_DEADLINE = 1.0      # class 0's e2e deadline (s)
SLO_TIGHT = 0.5         # the tight deadline of a few class-1 requests (s)
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def event_waits(torch):
    """Count ``torch.cuda.Event.synchronize`` calls in the block. An
    engine's segment fetch waits on the CUDA event recorded behind its
    staged copy, a wait that ``set_sync_debug_mode`` does not flag (torch
    flags stream and device synchronisation and blocking copies), so an
    audit counts both: flagged calls plus event waits. Yields [count,
    seconds spent waiting, the longest wait]."""
    n = [0, 0.0, 0.0]
    orig = torch.cuda.Event.synchronize

    def spy(self):
        t0 = time.perf_counter()
        orig(self)
        dt = time.perf_counter() - t0
        n[0] += 1
        n[1] += dt
        n[2] = max(n[2], dt)

    with mock.patch.object(torch.cuda.Event, "synchronize", spy):
        yield n


def tier_trace(sched, vocab, seed=0, rounds=TIER_ROUNDS):
    """Phase 3i's multi-tenant trace: ``TIER_ROUNDS`` rounds over
    ``TIER_TENANTS`` tenants, each request its tenant's prefix and a fresh
    tail, every arrival at t = 0 (the schedule is the queue's alone). The
    working set, 16 prefixes of 16 pages, is 5 times the cache's bound,
    so the tier carries the prefixes between rounds."""
    rng = np.random.RandomState(seed)
    prefs = [rng.randint(0, vocab, (TIER_PREFIX,)).astype(np.int32)
             for _ in range(TIER_TENANTS)]
    return [sched.Arrival(0.0, np.concatenate([
        prefs[t], rng.randint(0, vocab, (TIER_TAIL,)).astype(np.int32)]),
        TIER_GEN) for _ in range(rounds) for t in range(TIER_TENANTS)]


def tier_engine(ServingEngine, params, cfg, **kw):
    """The tight paged engine of phase 3i: 8 slots, pages of 16, a pool of
    ``TIER_POOL_PAGES`` (a request spans 20 pages)."""
    return ServingEngine(cfg, params, slots=8, max_len=TIER_MAX_LEN,
                         chunk=16, prompt_buckets=(64, 128, 256, 512),
                         paged=True, page_size=PAGE,
                         num_pages=TIER_POOL_PAGES + 1, device=DEVICE, **kw)


def tier_cache(PagedPrefixCache, kv_tiers, eng, tiered=True):
    return PagedPrefixCache(
        eng.pager, capacity_pages=TIER_CACHE_PAGES,
        host_tier=(kv_tiers.HostTier(eng.pager,
                                     capacity_pages=TIER_HOST_PAGES)
                   if tiered else None))


def _bits(torch, t):
    return t.contiguous().view(torch.uint8).cpu().numpy()


def tier_serve(torch, sched, kv_tiers, fns, eng, pc, arrivals,
               audit=False):
    """One serve of ``arrivals`` through ``OnlineScheduler`` (segments of
    32 steps), every launch count at 0 just before and read just after.
    With ``audit``, the serve runs under ``set_sync_debug_mode("warn")``
    with each synchronising call and event wait counted, and every
    restore's pages are
    copied on the device as the upload leaves them, to be held bit for bit
    against the host bytes that were staged for them (after the serve).
    Returns (stats, launches, tokens and requests in arrival order)."""
    sch = sched.OnlineScheduler(eng, seg_steps=32, max_queue=len(arrivals),
                                prefix_cache=pc)
    seen = []
    orig = kv_tiers.HostTier.upload

    def spy(self, pages, planes):
        orig(self, pages, planes)
        idx = self._index(pages)
        seen.append([(p, kv_tiers._raw(self.pager.pool[p])[:, idx].clone(),
                      planes[p]) for p in planes])

    f0 = eng.fetches
    patch = (mock.patch.object(kv_tiers.HostTier, "upload", spy) if audit
             else contextlib.nullcontext())
    with patch, event_waits(torch) as waits, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        zero_counts(fns)
        t0 = time.perf_counter()
        if audit:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            rep = sch.serve(arrivals)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(fns)
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    reqs = [sch._reqs[r] for r in sorted(sch._reqs)]
    res = sch.results()
    toks = [res[r.rid] for r in reqs]
    check_tokens(res, [r.rid for r in reqs],
                 [(a.prompt, a.max_new_tokens) for a in arrivals], eng.cfg)
    fetches = eng.fetches - f0
    if fetches != rep.segments:
        raise AssertionError(f"3i: {fetches} fetches for {rep.segments} "
                             f"segments")
    restored = [r for r in reqs if r.tier_pages]
    hbm_hit = [r for r in reqs if r.prefix_hit_len and not r.tier_pages]
    miss = [r for r in reqs if not r.prefix_hit_len]

    st = {"requests": rep.n_requests, "new_tokens": rep.total_tokens,
          "wall_s": wall, "tokens_per_s": rep.total_tokens / wall,
          "steps": rep.ticks, "admits": sum(1 + r.preemptions for r in reqs),
          "segments": rep.segments, "fetches": fetches,
          "ms_per_step": 1e3 * wall / rep.ticks,
          "ttft_p50_s": rep.ttft_p50_s, "ttft_p99_s": rep.ttft_p99_s,
          "e2e_p50_s": rep.e2e_p50_s, "e2e_p99_s": rep.e2e_p99_s,
          "hits": {"restored": len(restored), "hbm": len(hbm_hit),
                   "miss": len(miss)},
          "prefix": rep.prefix, "tiers": rep.tiers}
    st["ticks"] = st["steps"] - st["admits"]
    if audit:
        if syncs + waits[0] != fetches:
            raise AssertionError(f"3i: {syncs} synchronising calls and "
                                 f"{waits[0]} event waits in the tiered "
                                 f"serve, {fetches} fetches: the tier "
                                 f"synchronised")
        bad = [p for ups in seen for p, dev, host in ups
               if not np.array_equal(_bits(torch, dev), _bits(torch, host))]
        if not seen or bad:
            raise AssertionError(f"3i: {len(seen)} restores, planes whose "
                                 f"restored bytes differ from the staged "
                                 f"ones: {bad}")
        st["synchronising_calls"] = syncs
        st["event_waits"] = waits[0]
        st["restores_checked"] = len(seen)
        st["planes_checked"] = sorted({p for ups in seen for p, _, _ in ups})
    if pc is not None:
        pc.reset()
    leaks = eng.pager.leak_report()
    if leaks:
        raise AssertionError(f"3i: leaked pages after reset: {leaks}")
    return st, launches, toks, reqs


def digest_near_ties(xs, ys, digests, what):
    """Hold greedy serves ``xs`` to ``ys`` request by request on ``xs``'s
    own quality digests: each pair is identical or parts first where
    ``ys``'s token is in ``xs``'s top-k at that step within
    ``LOGIT_ATOL`` of its top logit (the engine's own logits, a quantized
    engine's included). Returns the near ties."""
    ties = []
    for i, (a, b, dig) in enumerate(zip(xs, ys, digests)):
        t = next((j for j, (u, v) in enumerate(zip(a, b)) if u != v), None)
        if t is None:
            continue
        _, ids, vals = dig[t]
        gap = (vals[0] - vals[ids.index(b[t])]) if b[t] in ids else None
        if gap is None or gap > LOGIT_ATOL:
            raise AssertionError(f"{what}: request {i} left the other serve "
                                 f"at token {t}, logit gap {gap}")
        ties.append({"token": t, "gap": gap})
    return ties


def tier_transfer_ms(torch, kv_tiers, eng, pages=16, iters=20):
    """Device time of one ``pages``-page stage (gather + non-blocking D2H
    into pinned memory, every plane) and one restore (non-blocking H2D +
    ``index_copy_``), CUDA events around ``iters`` calls each, beside a
    plain pinned ``copy_`` of the same bytes each way."""
    tier = kv_tiers.HostTier(eng.pager, capacity_pages=4 * pages)
    ids = list(range(1, pages + 1))
    nbytes = pages * tier.page_bytes()
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEVICE)
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def events(fn):
        for _ in range(3):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    def stage():
        tier.stage(b"timed", ids)
        tier.take_pending()

    tier.stage(b"probe", ids)
    tier.flush()
    planes = {p: a for p, a in tier.get(b"probe").items()
              if p in tier.planes()}
    out = {"pages": pages, "bytes": nbytes,
           "stage_ms": events(stage),
           "d2h_copy_ms": events(lambda: host.copy_(dev, non_blocking=True)),
           "restore_ms": events(lambda: tier.upload(ids, planes)),
           "h2d_copy_ms": events(lambda: dev.copy_(host, non_blocking=True))}
    tier.complete([])
    for k in ("stage", "restore"):
        out[k + "_gb_per_s"] = nbytes / out[k + "_ms"] / 1e6
    return out


def tier_phase(torch, sched, kv_tiers, llama, ServingEngine,
               PagedPrefixCache, fns, params, cfg):
    """Phase 3i (a) and (b): the multi-tenant trace on a tight pool with a
    host tier behind the cache, bf16 and int8. (a): an audited serve
    (synchronising calls counted, restored bytes against staged), a timed
    one, the same trace with an untiered cache of the same pool bound and
    with no cache (the token oracle), and the transfer times. (b): the
    int8 pool, tiered and with no cache, on quality digests."""
    L = cfg.num_layers
    arrivals = tier_trace(sched, cfg.vocab_size)
    prompts = [a.prompt for a in arrivals]
    out, launches = {}, {}

    def run(key, tiered=True, cached=True, audit=False, **kw):
        eng = tier_engine(ServingEngine, params, cfg, **kw)
        pc = tier_cache(PagedPrefixCache, kv_tiers, eng, tiered) \
            if cached else None
        st, n, toks, reqs = tier_serve(torch, sched, kv_tiers, fns, eng,
                                       pc, arrivals, audit=audit)
        quant = bool(kw.get("quant"))
        want = (paged_counts(L, st["steps"], st["ticks"], quant=True)
                if quant else family_counts(L, st["steps"], st["ticks"]))
        check_counts(n, want, f"3i {key}: {st['steps']} steps, "
                              f"{st['ticks']} ticks")
        launches[f"tier_{key}"] = n
        return st, toks, reqs

    out["audited"], atoks, _ = run("audited", audit=True)
    t = out["audited"]["tiers"]
    if not (t["stages"] and t["spills"] and t["restores"]):
        raise AssertionError(f"3i: the tier did not carry the prefixes: {t}")
    out["tiered"], ttoks, _ = run("tiered")
    out["untiered"], utoks, _ = run("untiered", tiered=False)
    out["no_cache"], ntoks, _ = run("no_cache", cached=False)
    ties = {}
    for key, xs in (("audited", atoks), ("tiered", ttoks),
                    ("untiered", utoks)):
        ties[key] = parted_at_near_ties(torch, llama, params, cfg, prompts,
                                        xs, ntoks, f"3i {key}")
    out["parted_at_near_ties"] = ties
    eng = tier_engine(ServingEngine, params, cfg)
    out["transfer"] = tier_transfer_ms(torch, kv_tiers, eng)
    del eng

    q, toks = {}, {}
    for key, cached in (("tiered", True), ("no_cache", False)):
        q[key], toks[key], reqs = run(f"int8_{key}", cached=cached,
                                      audit=cached, quant="int8",
                                      quality_digest=True)
        if cached:
            digests = [r.digests for r in reqs]
    t = q["tiered"]["tiers"]
    if not (t["stages"] and t["spills"] and t["restores"]):
        raise AssertionError(f"3i int8: the tier did not carry the "
                             f"prefixes: {t}")
    q["parted_at_near_ties"] = digest_near_ties(
        toks["tiered"], toks["no_cache"], digests, "3i int8 tiered")
    out["int8"] = q
    return out, launches


def slo_phase(torch, sched, journal, ServingEngine, fns, params, cfg):
    """Phase 3i (c): ``SLOScheduler`` under overload on the paged engine.
    Class 1 (12 requests of 256 prompt tokens and 64 new, 4 more with a
    tight deadline) arrives at t = 0 and fills the 8 slots; class 0 (16
    requests of 32 and 16, e2e deadline ``SLO_DEADLINE``) arrives from
    50 ms on, one every 10 ms, into busy slots. (With every arrival at
    t = 0 the class-ordered queue admits class 0 first and nothing is
    preempted.) A serve with shedding on and a journal: preemptions,
    never of the same or a higher class, class 0's TTFT p99 below class
    1's, the report's sheds equal to the journal's ``shed_decision``
    records. Then two serves with shedding off, without monitors (its
    decision clock recorded) and with the SLO, perf and capacity monitors
    under that clock fed back: the same decisions, so the tokens, the
    fetches and the launches must be identical. Every serve runs under
    ``set_sync_debug_mode("warn")``, and its synchronising calls and
    event waits must number its fetches: a monitor that read the device
    would add one."""
    from paddle_tpu_torch.observability.capacity import CapacityMonitor
    from paddle_tpu_torch.observability.perf import PerfMonitor
    from paddle_tpu_torch.observability.slo import Objective, SLOMonitor

    L = cfg.num_layers
    rng = np.random.RandomState(11)
    V = cfg.vocab_size
    arrivals = ([sched.Arrival(0.0, rng.randint(0, V, (256,)).astype(
        np.int32), 64, priority=1) for _ in range(12)]
        + [sched.Arrival(0.0, rng.randint(0, V, (128,)).astype(np.int32),
                         32, priority=1, deadline_s=SLO_TIGHT)
           for _ in range(4)]
        + [sched.Arrival(0.05 + 0.01 * i, rng.randint(0, V, (32,)).astype(
            np.int32), 16, priority=0, deadline_s=SLO_DEADLINE)
           for i in range(16)])

    def serve(shed, monitors=False, clock=None):
        eng = family_engine(ServingEngine, params, cfg, max_len=TIER_MAX_LEN,
                            buckets=(64, 128, 256, 512))
        kw = {}
        if monitors:
            kw = dict(
                slo_monitor=SLOMonitor({
                    0: Objective(ttft_target_s=0.5,
                                 e2e_target_s=SLO_DEADLINE),
                    1: Objective(e2e_target_s=10.0)}),
                perf_monitor=PerfMonitor(cfg, eng.params, batch=8,
                                         avg_pos=200.0),
                capacity_monitor=CapacityMonitor())
        sch = sched.SLOScheduler(eng, max_queue=len(arrivals), seg_steps=32,
                                 shed_deadlines=shed, **kw)
        j = journal.Journal()
        feed = (journal.feed_clock(clock) if clock is not None
                else contextlib.nullcontext())
        f0 = eng.fetches
        zero_counts(fns)
        t0 = time.perf_counter()
        with journal.attach(j), feed, event_waits(torch) as waits, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rep = sch.serve(arrivals)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_counts(fns)
        syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
        if syncs + waits[0] != eng.fetches - f0:
            raise AssertionError(f"3i SLO: {syncs} synchronising calls and "
                                 f"{waits[0]} event waits, "
                                 f"{eng.fetches - f0} fetches (monitors "
                                 f"{monitors})")
        recs = j.records()
        admits = sum(r["kind"] == "admit" for r in recs)
        steps = eng.last_run_ticks
        check_counts(n, family_counts(L, steps, steps - admits),
                     f"3i SLO: {steps} steps, {admits} admits")
        res = sch.results()
        served = sorted(res)
        check_tokens(res, served, [(sch._reqs[r].prompt,
                                    sch._reqs[r].max_new_tokens)
                                   for r in served], cfg)
        if eng.pager.leak_report():
            raise AssertionError(f"3i SLO leaked pages: "
                                 f"{eng.pager.leak_report()}")
        return {"rep": rep, "records": recs, "tokens": res, "launches": n,
                "fetches": eng.fetches - f0, "syncs": syncs,
                "event_waits": waits[0], "wall_s": wall,
                "clock": [r["c"] for r in recs if r["kind"] == "clock"]}

    a = serve(shed=True)
    rep = a["rep"]
    decisions = [r for r in a["records"] if r["kind"] == "preempt_decision"]
    if rep.preemptions < 1:
        raise AssertionError("3i SLO: nothing was preempted")
    if any(d["victim_priority"] <= d["head_priority"] for d in decisions):
        raise AssertionError("3i SLO: a preemption of the same or a higher "
                             "class")
    sheds = sum(r["kind"] == "shed_decision" for r in a["records"])
    if rep.shed != sheds:
        raise AssertionError(f"3i SLO: the report sheds {rep.shed}, the "
                             f"journal {sheds}")
    pc = rep.per_class
    if not pc[0]["ttft_p99_s"] < pc[1]["ttft_p99_s"]:
        raise AssertionError(f"3i SLO: class 0 TTFT p99 "
                             f"{pc[0]['ttft_p99_s']} not below class 1's "
                             f"{pc[1]['ttft_p99_s']}")
    off = serve(shed=False)
    on = serve(shed=False, monitors=True, clock=off["clock"])
    for key in ("tokens", "fetches", "launches"):
        if on[key] != off[key]:
            raise AssertionError(f"3i SLO: the monitors changed the serve's "
                                 f"{key}")
    r_on = on["rep"]
    st = {"requests": len(arrivals), "served": rep.n_requests,
          "preemptions": rep.preemptions, "shed": rep.shed,
          "shed_per_class": rep.shed_per_class,
          "per_class": rep.per_class, "segments": rep.segments,
          "fetches": a["fetches"], "wall_s": a["wall_s"],
          "tokens_per_s": rep.total_tokens / a["wall_s"],
          "journal_records": len(a["records"]),
          "synchronising_calls": a["syncs"], "event_waits": a["event_waits"],
          "monitors": {"fetches": on["fetches"],
                       "synchronising_calls": on["syncs"],
                       "event_waits": on["event_waits"],
                       "segments": r_on.segments,
                       "slo_worst_level": r_on.slo["worst_level"],
                       "slo_alerts": len(r_on.slo["alerts"]),
                       "perf": {k: r_on.perf[k] for k in (
                           "tok_s", "ceiling_tok_s", "roofline_fraction",
                           "mfu", "busy_fraction", "tick_ewma_s")},
                       "capacity_level": r_on.capacity["level"],
                       "capacity_alerts": len(r_on.capacity["alerts"])}}
    return st, {"slo_serve": a["launches"], "slo_monitored": on["launches"]}


FLEET_ROUNDS = 2        # rounds of the tenant trace in phase 3j
FLEET_MAX_QUEUE = 4     # each replica's intake bound in 3j's audited serves
FLEET_PAIRS = 2         # timed (two replicas, one replica) pairs
FLEET_SHADOW_P = 0.5    # the int8 shadow's sample rate
FLEET_CRASH = {1: 3}    # 3j (b): replica 1 crashes at its 4th segment
DISAGG_PREFILL_STEPS = 8
DISAGG_DECODE_STEPS = 32
DISAGG_MAX_LEN = 512


def fleet_router(fleet, kv_tiers, PagedPrefixCache, ServingEngine, params,
                 cfg, n, shadow=False, max_queue=None, **kw):
    """Phase 3j's fleet: ``n`` replicas of phase 3i's tight paged engine
    (8 slots, pages of 16, 96 pages; bf16 with quality digests), each
    with its own ``PagedPrefixCache`` over a ``HostTier``, behind a
    ``FleetRouter`` with the cache directory and segments of 32 steps;
    with ``shadow``, an int8 engine of the same geometry mirrors
    ``FLEET_SHADOW_P`` of the requests."""
    engines = [tier_engine(ServingEngine, params, cfg, quality_digest=True)
               for _ in range(n)]
    pcs = [tier_cache(PagedPrefixCache, kv_tiers, e) for e in engines]
    sh = (fleet.Shadow(tier_engine(ServingEngine, params, cfg, quant="int8",
                                   quality_digest=True),
                       sample_p=FLEET_SHADOW_P, seed=0) if shadow else None)
    return fleet.FleetRouter(engines, max_queue=max_queue or FLEET_MAX_QUEUE,
                             seg_steps=32,
                             prefix_caches=pcs, directory=True, shadow=sh,
                             **kw)


def fleet_serve(torch, journal, fns, router, arrivals):
    """One audited fleet serve: every launch count at 0 just before and
    read just after, a journal attached (its ``admit`` records count the
    admissions), and ``set_sync_debug_mode("warn")`` with each
    synchronising call and event wait counted: together they must number
    the primary and shadow fetches plus the counted tier flushes (a
    ``DisaggRouter``'s ``handoff_flushes``). Returns (report, stats,
    launches, records)."""
    engines = [r.engine for r in router._replicas]
    if router.shadow is not None:
        engines.append(router.shadow.engine)
    f0 = [e.fetches for e in engines]
    h0 = getattr(router, "handoff_flushes", 0)
    j = journal.Journal()
    zero_counts(fns)
    t0 = time.perf_counter()
    with journal.attach(j), event_waits(torch) as waits, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rep = router.serve(arrivals)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    fetches = sum(e.fetches - f for e, f in zip(engines, f0))
    flushes = getattr(router, "handoff_flushes", 0) - h0
    if syncs + waits[0] != fetches + flushes:
        raise AssertionError(f"3j: {syncs} synchronising calls and "
                             f"{waits[0]} event waits, {fetches} fetches "
                             f"and {flushes} tier flushes")
    recs = j.records()
    st = {"requests": rep.n_requests, "new_tokens": rep.total_tokens,
          "wall_s": wall, "tokens_per_s": rep.total_tokens / wall,
          "ttft_p50_s": rep.ttft_p50_s, "ttft_p99_s": rep.ttft_p99_s,
          "e2e_p50_s": rep.e2e_p50_s, "e2e_p99_s": rep.e2e_p99_s,
          "segments": rep.segments, "fetches": fetches,
          "synchronising_calls": syncs, "event_waits": waits[0],
          "event_wait_ms": {"total": 1e3 * waits[1], "max": 1e3 * waits[2]},
          "tier_flushes": flushes,
          "admits": sum(r["kind"] == "admit" and not r.get("shadow")
                        for r in recs),
          "steps": sum(r.engine.last_run_ticks for r in router._replicas),
          "assignment": [len(a) for a in router.assignment()],
          "dispatches": {"affinity": rep.dispatches_affinity,
                         "least_loaded": rep.dispatches_least_loaded,
                         "directory": rep.dispatches_directory},
          "backpressure_events": rep.backpressure_events,
          "tier_migrations": rep.tier_migrations,
          "failovers": rep.failovers, "requeued": rep.requeued}
    return rep, st, launches, recs


def fleet_tokens(router, arrivals, cfg, what):
    """Every request's count and vocabulary; tokens in arrival order."""
    res = router.results()
    rids = sorted(res)
    if len(rids) != len(arrivals):
        raise AssertionError(f"{what}: {len(rids)} requests served of "
                             f"{len(arrivals)}")
    check_tokens(res, rids, [(a.prompt, a.max_new_tokens)
                             for a in arrivals], cfg)
    return [res[r] for r in rids]


def sum_counts(*dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def fleet_phase(torch, sched, fleet, disagg, kv_tiers, journal, llama,
                ServingEngine, PagedPrefixCache, fns, params, cfg, reqs):
    """Phase 3j: the serving fleet and disaggregated prefill/decode.

    (a) two replicas with the cache directory and an int8 shadow on the
    tenant trace (``FLEET_ROUNDS`` rounds, queues bounded at
    ``FLEET_MAX_QUEUE`` so round 2 arrives at replicas that cached round
    1): every count, the assignment, directory dispatches and migrations,
    the fetch audit, the launches of both replicas and the shadow, no
    page leaked after ``reset``, tokens equal one replica serving the
    trace or parted at a near tie, and the shadow's ``QualityMonitor``
    report with a pair for every mirrored request. The per-replica
    dispatch and ``t_sync`` stamps of the first turns are kept. Then the
    two-replica fleet and one replica timed in turns (``FLEET_PAIRS``
    pairs, the order alternating, queues unbounded, no shadow). (b) the
    (a) fleet with ``FaultInjector(crash=FLEET_CRASH)``: nothing lost,
    one failover, tokens held as in (a). (c) a ``DisaggRouter`` with one
    prefill and one decode replica on the mixed trace ``reqs``: every
    crossing's bytes within its reserved footprint, the fetch audit with
    the handoff flushes its only synchronising calls, the launches, and
    tokens held to a co-resident two-replica fleet."""
    L = cfg.num_layers
    arrivals = tier_trace(sched, cfg.vocab_size, rounds=FLEET_ROUNDS)
    prompts = [a.prompt for a in arrivals]
    out, launches = {}, {}

    def build(n, **kw):
        return fleet_router(fleet, kv_tiers, PagedPrefixCache,
                            ServingEngine, params, cfg, n, **kw)

    # (a) the audited serve, with the dispatch / t_sync stamps of the turns
    router = build(2, shadow=True)
    stamps = []
    real_finish, real_stamp = (fleet.FleetRouter._finish_one,
                               fleet.FleetRouter._stamp)

    def finish_spy(self, rep, h, t_disp):
        stamps.append({"replica": rep.idx,
                       "t_disp_ms": 1e3 * (t_disp - self._serve_t0)})
        return real_finish(self, rep, h, t_disp)

    def stamp_spy(self, r, ev, t_sync):
        stamps[-1]["t_sync_ms"] = 1e3 * (t_sync - self._serve_t0)
        return real_stamp(self, r, ev, t_sync)

    with mock.patch.object(fleet.FleetRouter, "_finish_one", finish_spy), \
            mock.patch.object(fleet.FleetRouter, "_stamp", stamp_spy):
        rep, st, n, recs = fleet_serve(torch, journal, fns, router,
                                       arrivals)
    sh = router.shadow
    want = sum_counts(
        family_counts(L, st["steps"], st["steps"] - st["admits"]),
        paged_counts(L, sh.engine.last_run_ticks,
                     sh.engine.last_run_ticks - rep.shadow["mirrored"],
                     quant=True))
    check_counts(n, want, f"3j (a): {st['steps']} steps, {st['admits']} "
                          f"admits; shadow {sh.engine.last_run_ticks} "
                          f"steps, {rep.shadow['mirrored']} admits")
    launches["fleet"] = n
    atoks = fleet_tokens(router, arrivals, cfg, "3j (a)")
    if min(st["assignment"]) == 0:
        raise AssertionError(f"3j (a): a replica took no request: "
                             f"{st['assignment']}")
    if not (rep.directory["hits"] and rep.tier_migrations):
        raise AssertionError(f"3j (a): {rep.directory['hits']} directory "
                             f"hits, {rep.tier_migrations} prefixes "
                             f"migrated")
    mirrored = sum(sh.wants(rid) for rid in range(len(arrivals)))
    q = rep.quality
    if not (q["pairs"] == rep.shadow["mirrored"] == rep.shadow["compared"]
            == mirrored) or rep.shadow["dropped"]:
        raise AssertionError(f"3j (a): {q['pairs']} shadow pairs, shadow "
                             f"{rep.shadow}, {mirrored} drawn")
    router.reset()
    if router.leak_report():
        raise AssertionError(f"3j (a): leaked pages after reset: "
                             f"{router.leak_report()}")
    st["turns"] = stamps[:8]
    st["quality"] = {k: q[k] for k in (
        "level", "pairs", "pairs_mismatched", "tokens_compared",
        "token_match_rate", "logit_max_abs_err", "kl_sampled_max",
        "first_divergence_positions")}
    st["quality"]["alerts"] = len(q["alerts"])
    st["shadow"] = rep.shadow
    st["directory"] = rep.directory
    out["fleet"] = st
    del router

    # the two-replica fleet against one replica, in turns
    timed = {1: build(1, max_queue=len(arrivals)),
             2: build(2, max_queue=len(arrivals))}
    tps = {1: [], 2: []}
    toks = {}
    for i in range(FLEET_PAIRS):
        for k in ((2, 1) if i % 2 == 0 else (1, 2)):
            r = timed[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trep = r.serve(arrivals)
            torch.cuda.synchronize()
            tps[k].append(trep.total_tokens / (time.perf_counter() - t0))
            toks.setdefault(k, fleet_tokens(r, arrivals, cfg,
                                            f"3j timed {k}"))
            r.reset()
    one = toks[1]
    out["timed"] = {
        "pairs": FLEET_PAIRS,
        "tokens_per_s": {"two_replicas": tps[2], "one_replica": tps[1]},
        "median_tokens_per_s": {"two_replicas": float(np.median(tps[2])),
                                "one_replica": float(np.median(tps[1]))}}
    out["timed"]["median_ratio"] = (out["timed"]["median_tokens_per_s"]
                                    ["two_replicas"]
                                    / out["timed"]["median_tokens_per_s"]
                                    ["one_replica"])
    del timed
    ties = {"fleet": parted_at_near_ties(torch, llama, params, cfg, prompts,
                                         atoks, one, "3j (a)"),
            "timed_two_replicas": parted_at_near_ties(
                torch, llama, params, cfg, prompts, toks[2], one,
                "3j timed")}

    # (b) failover
    router = build(2, shadow=True,
                   fault_injector=fleet.FaultInjector(crash=FLEET_CRASH),
                   probe_after_s=60.0)
    rep, st, n, _ = fleet_serve(torch, journal, fns, router, arrivals)
    launches["fleet_failover"] = n
    btoks = fleet_tokens(router, arrivals, cfg, "3j (b)")
    if rep.failovers != 1 or rep.n_requests != len(arrivals):
        raise AssertionError(f"3j (b): {rep.failovers} failovers, "
                             f"{rep.n_requests} requests")
    ties["failover"] = parted_at_near_ties(torch, llama, params, cfg,
                                           prompts, btoks, one, "3j (b)")
    router.reset()
    if router.leak_report():
        raise AssertionError(f"3j (b): leaked pages after reset: "
                             f"{router.leak_report()}")
    st["replica_health"] = rep.replica_health
    st["fault_events"] = router.fault_injector.events
    out["failover"] = st
    del router

    # (c) disaggregated prefill/decode on the mixed trace
    marr = [sched.Arrival(0.0, p, g) for p, g in reqs]
    mprompts = [p for p, _ in reqs]

    def engine():
        return ServingEngine(cfg, params, slots=8, max_len=DISAGG_MAX_LEN,
                             chunk=16, prompt_buckets=(64, 128, 256, 512),
                             paged=True, page_size=PAGE, device=DEVICE)

    dis = disagg.DisaggRouter([engine()], [engine()],
                              prefill_seg_steps=DISAGG_PREFILL_STEPS,
                              decode_seg_steps=DISAGG_DECODE_STEPS,
                              max_queue=len(marr))
    drains, waited = [], [0.0]
    real_drain = disagg.DisaggRouter._drain_handoffs
    real_wait = kv_tiers.wait_for_stages

    def drain_spy(self):
        k = len(self._pending_handoffs)
        waited[0] = 0.0
        t0 = time.perf_counter()
        real_drain(self)
        if k:
            drains.append({"crossings": k,
                           "ms": 1e3 * (time.perf_counter() - t0),
                           "wait_ms": 1e3 * waited[0]})

    def wait_spy(tiers):
        t0 = time.perf_counter()
        real_wait(tiers)
        waited[0] += time.perf_counter() - t0

    with mock.patch.object(disagg.DisaggRouter, "_drain_handoffs",
                           drain_spy), \
            mock.patch.object(kv_tiers, "wait_for_stages", wait_spy):
        rep, st, n, _ = fleet_serve(torch, journal, fns, dis, marr)
    check_counts(n, family_counts(L, st["steps"], st["steps"] - st["admits"]),
                 f"3j (c): {st['steps']} steps, {st['admits']} admits")
    launches["disagg"] = n
    dtoks = fleet_tokens(dis, marr, cfg, "3j (c)")
    pb = dis._replicas[0].prefix_cache.host_tier.page_bytes()
    if not dis.handoffs or st["tier_flushes"] != dis.handoff_flushes:
        raise AssertionError(f"3j (c): {dis.handoffs} handoffs, "
                             f"{dis.handoff_flushes} flushes")
    bad = [h for h in dis.handoff_log
           if h["pages"] > h["pages_reserved"]
           or h["bytes"] > h["pages_reserved"] * pb
           or h["bytes"] != h["pages"] * pb]
    if bad:
        raise AssertionError(f"3j (c): crossings past their reserved KV "
                             f"footprint: {bad}")
    st["handoffs"] = {k: v for k, v in dis.handoff_report().items()
                      if k != "log"}
    st["handoff_bytes_per_crossing"] = [h["bytes"] for h in dis.handoff_log]
    st["page_bytes"] = pb
    st["drains"] = drains
    st["drain_ms_per_crossing"] = (sum(d["ms"] for d in drains)
                                   / max(1, sum(d["crossings"]
                                                for d in drains)))
    st["pool_stats"] = dis.pool_stats()
    dis.reset()
    if dis.leak_report():
        raise AssertionError(f"3j (c): leaked pages after reset: "
                             f"{dis.leak_report()}")
    out["disagg"] = st
    del dis
    co = fleet.FleetRouter([engine(), engine()], max_queue=len(marr),
                           seg_steps=DISAGG_DECODE_STEPS,
                           prefix_caches="auto")
    crep, cst, n, _ = fleet_serve(torch, journal, fns, co, marr)
    check_counts(n, family_counts(L, cst["steps"],
                                  cst["steps"] - cst["admits"]),
                 f"3j (c) co-resident: {cst['steps']} steps")
    launches["disagg_co_resident"] = n
    ctoks = fleet_tokens(co, marr, cfg, "3j (c) co-resident")
    out["co_resident"] = cst
    ties["disagg"] = parted_at_near_ties(torch, llama, params, cfg,
                                         mprompts, dtoks, ctoks, "3j (c)")
    out["parted_at_near_ties"] = ties
    del co
    return out, launches


# ---------------------------------------------------------------------------
# phase 3k: the elastic fleet: the program space and its warmup, the
# autoscaler's 1 -> 4 -> 1 episode, and the chip fit
# ---------------------------------------------------------------------------

ELASTIC_REPLICAS = 4
ELASTIC_PAIRS = 2       # (cold, warmed) first segments, in turns
ELASTIC_SEG_STEPS = 32
ELASTIC_QUEUE_HIGH = 8  # summed queue depth that asks for a replica


def elastic_envelope(eng):
    """3k's declared workload: segments of ``ELASTIC_SEG_STEPS`` steps
    behind a prefix cache of one-page blocks, prompts up to the largest
    bucket."""
    return eng.default_envelope(seg_steps=(ELASTIC_SEG_STEPS,),
                                prefix_block=PAGE)


def elastic_trace(sched, vocab, seed=1):
    """3k (b)'s trace, shaped as the reference episode's
    (tests/test_autoscaler.py) at 3i's widths (256-token prefixes, 32-token
    tails): a burst of 24 requests with fresh prefixes at t = 0 (queue
    pressure), a spread wave of 8 over 4 prefix groups from 1.0 s, a
    sparse repeat wave of 8 over the same groups from 6.0 s, 0.5 s apart,
    and 3 single requests 1.5 s apart from 14.0 s, whose idle gaps give
    the last drains their calm turns."""
    rng = np.random.RandomState(seed)

    def fresh():
        return rng.randint(0, vocab, (TIER_PREFIX,)).astype(np.int32)

    def req(pref, gen):
        return (np.concatenate([pref, rng.randint(
            0, vocab, (TIER_TAIL,)).astype(np.int32)]), gen)

    groups = [fresh() for _ in range(4)]
    return ([sched.Arrival(0.0, *req(fresh(), TIER_GEN))
             for _ in range(24)]
            + [sched.Arrival(1.0 + 0.1 * i, *req(groups[i % 4], TIER_GEN))
               for i in range(8)]
            + [sched.Arrival(6.0 + 0.5 * i, *req(groups[i % 4], 16))
               for i in range(8)]
            + [sched.Arrival(14.0 + 1.5 * i, *req(groups[i % 4], 8))
               for i in range(3)])


def fresh_tickets(da):
    """Set the process's split-KV ticket buffers aside (kept alive: a
    graph captured earlier may still name one), so the next call at each
    shape makes its own, as in a new process."""
    kept = list(da._TICKETS.values())
    da._TICKETS.clear()
    return kept


def first_segment(torch, recompile, eng, arrivals):
    """Wall ms of an engine's first segment (``run_segment`` of
    ``ELASTIC_SEG_STEPS`` steps over the first 8 requests, no cache), the
    card synchronised on both sides, and what it built."""
    for a in arrivals[:8]:
        eng.add_request(a.prompt, a.max_new_tokens)
    torch.cuda.synchronize()
    with recompile.CompileWatch() as cw:
        t0 = time.perf_counter()
        eng.run_segment(ELASTIC_SEG_STEPS)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    return ms, cw.as_dict()


def elastic_phase(torch, sched, fleet, disagg, autoscaler, kv_tiers,
                  journal, llama, ServingEngine, PagedPrefixCache,
                  PagedKVCache, CapacityMonitor, recompile, memory, da, fns,
                  params, cfg):
    """Phase 3k: the elastic fleet on 3j's model and engine geometry (8
    slots, pages of 16, a 96-page pool, a 48-page cache over a 1024-page
    host tier).

    (a) ``aot_warmup`` of one replica under its default envelope, 3k's
    envelope (segments of 32 behind the cache) and, through a
    ``DisaggRouter``, the pool envelopes: keys and seconds by family;
    then ``ELASTIC_PAIRS`` pairs in turns of a cold engine's first
    segment against a warmed one's (ticket buffers set aside before
    each, so each makes its own); then the warmed replica serves 3j's
    tenant trace under ``recompile.enforce_zero_compiles``: no library
    load, no ticket buffer, no key outside the envelope, and the
    launches its steps need. (b) the elastic episode: four replicas on
    the card, warmed under 3k's envelope, one ``Autoscaler`` (min 1, max
    4, initial 1; queue pressure and a ``CapacityMonitor``) on
    ``elastic_trace``: it must go 1 -> 4 -> 1, strand nothing, and meet
    nothing outside the envelope; warm seconds a scale-up, drain
    requeues and prefix migrations, the launches (the scale-ups'
    warmups included), and tokens against one engine serving the same
    requests. (c) the chip fit against the card (``mem_get_info``'s
    total): weights and pool bytes against the allocator's requested
    bytes at build (``memory_allocated``'s rounded blocks beside), the
    transient estimate beside the warmed serve's measured
    peak, and one refusal with ``hbm_bytes`` one byte below a replica's
    envelope, its journaled reason."""
    L = cfg.num_layers
    out, launches = {}, {}
    arrivals = tier_trace(sched, cfg.vocab_size, rounds=FLEET_ROUNDS)

    def engine():
        return tier_engine(ServingEngine, params, cfg)

    def families(rep):
        return {f: {"keys": r["keys"], "seconds": r["seconds"]}
                for f, r in rep.items()}

    # (a) warmups by envelope
    eng = engine()
    pc = tier_cache(PagedPrefixCache, kv_tiers, eng)
    env = elastic_envelope(eng)
    warm = {"default": families(eng.aot_warmup())}
    torch.cuda.synchronize()
    held = fresh_tickets(da)
    with recompile.CompileWatch() as cw:
        warm["elastic"] = families(eng.aot_warmup(env, prefix_cache=pc))
    warm["elastic_built"] = cw.as_dict()
    if not cw.tickets:
        raise AssertionError("3k (a): the warmup made no ticket buffer")
    pool_engines = [engine(), engine()]
    dis = disagg.DisaggRouter(
        pool_engines[:1], pool_engines[1:],
        prefill_caches=[tier_cache(PagedPrefixCache, kv_tiers,
                                   pool_engines[0])],
        decode_caches=[tier_cache(PagedPrefixCache, kv_tiers,
                                  pool_engines[1])],
        prefill_seg_steps=DISAGG_PREFILL_STEPS,
        decode_seg_steps=DISAGG_DECODE_STEPS)
    pools = dis.aot_warmup()
    warm["pools"] = {r.pool: {"envelope": journal.describe_envelope(
        dis.pool_envelope(r.pool)), "families": families(pools[r.idx])}
        for r in dis._replicas}
    del dis, pool_engines
    out["warmups"] = warm

    # a cold engine's first segment against a warmed one's, in turns
    pairs = {"cold": [], "warm": []}
    built = {"cold": [], "warm": []}
    for i in range(ELASTIC_PAIRS):
        for kind in (("cold", "warm") if i % 2 == 0 else ("warm", "cold")):
            e = engine()
            torch.cuda.synchronize()
            held += fresh_tickets(da)
            if kind == "warm":
                e.aot_warmup(env)
            ms, b = first_segment(torch, recompile, e, arrivals)
            pairs[kind].append(ms)
            built[kind].append(b)
            del e
    if any(any(b.values()) for b in built["warm"]):
        raise AssertionError(f"3k (a): a warmed engine's first segment "
                             f"built {built['warm']}")
    out["first_segment_ms"] = pairs
    out["first_segment_built"] = {k: v[0] for k, v in built.items()}
    out["first_segment_median_ms"] = {k: float(np.median(v))
                                      for k, v in pairs.items()}

    # the warmed replica serves within the zero budget
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with recompile.enforce_zero_compiles("3k (a) warmed serve") as cw:
        st, n, _, _ = tier_serve(torch, sched, kv_tiers, fns, eng, pc,
                                 arrivals)
    peak = torch.cuda.max_memory_allocated() - base
    check_counts(n, family_counts(L, st["steps"], st["ticks"]),
                 f"3k (a): {st['steps']} steps, {st['admits']} admits")
    launches["warmed_serve"] = n
    st["built"] = cw.as_dict()
    st["keys_used"] = {repr(k): v for k, v in eng.prog_key_hits.items()}
    out["warmed_serve"] = st

    # (b) the elastic episode
    trace = elastic_trace(sched, cfg.vocab_size)
    engines = [engine() for _ in range(ELASTIC_REPLICAS)]
    pcs = [tier_cache(PagedPrefixCache, kv_tiers, e) for e in engines]
    asc = autoscaler.Autoscaler(min_replicas=1, max_replicas=ELASTIC_REPLICAS,
                                initial_replicas=1,
                                queue_high=ELASTIC_QUEUE_HIGH, queue_low=0,
                                scale_down_after=2)
    router = fleet.FleetRouter(
        engines, max_queue=len(trace), seg_steps=ELASTIC_SEG_STEPS,
        prefix_caches=pcs, directory=True, autoscaler=asc,
        capacity_monitor=CapacityMonitor(warn_horizon=0.5,
                                         page_horizon=0.1))
    t0 = time.perf_counter()
    router.aot_warmup(env)
    standby_s = time.perf_counter() - t0
    j = journal.Journal()
    zero_counts(fns)
    t0 = time.perf_counter()
    with journal.attach(j), \
            recompile.enforce_zero_compiles("3k (b) episode") as cw:
        rep = router.serve(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    built = cw.as_dict()
    n = read_counts(fns)
    recs = j.records()
    decs = [r for r in recs if r["kind"] == "scale_decision"]
    warmed = [r for r in recs if r["kind"] == "replica_warmed"]
    admits = sum(r["kind"] == "admit" for r in recs)
    steps = sum(r.engine.last_run_ticks for r in router._replicas)
    keys = sum(r["keys"] for r in warmed)
    check_counts(n, family_counts(L, steps + 2 * keys,
                                  steps - admits + keys),
                 f"3k (b): {steps} steps, {admits} admits, {keys} keys "
                 f"warmed in the serve")
    launches["episode"] = n
    toks = fleet_tokens(router, trace, cfg, "3k (b)")
    peak_n = max(d["inputs"]["n_serving"] for d in decs) if decs else 1
    final = [r.lifecycle for r in router._replicas]
    if not (rep.scale_ups == ELASTIC_REPLICAS - 1
            and rep.scale_downs == ELASTIC_REPLICAS - 1
            and peak_n == ELASTIC_REPLICAS and asc.actual == 1
            and final == ["serving"] + ["offline"] * (ELASTIC_REPLICAS - 1)):
        raise AssertionError(f"3k (b): not 1 -> 4 -> 1: {rep.scale_ups} up, "
                             f"{rep.scale_downs} down, peak {peak_n}, "
                             f"lifecycles {final}, decisions "
                             f"{[(d['action'], d['replica']) for d in decs]}")
    if router.leak_report():
        raise AssertionError(f"3k (b): leaked pages: {router.leak_report()}")
    ref = engine()
    rpc = tier_cache(PagedPrefixCache, kv_tiers, ref)
    one = sched.OnlineScheduler(ref, seg_steps=ELASTIC_SEG_STEPS,
                                max_queue=len(trace), prefix_cache=rpc)
    one.serve([sched.Arrival(0.0, a.prompt, a.max_new_tokens)
               for a in trace])
    res1 = one.results()
    rtoks = [res1[r] for r in sorted(res1)]
    out["episode"] = {
        "requests": rep.n_requests, "stranded": len(trace) - len(toks),
        "new_tokens": rep.total_tokens, "wall_s": wall,
        "tokens_per_s": rep.total_tokens / wall,
        "ttft_p50_s": rep.ttft_p50_s, "ttft_p99_s": rep.ttft_p99_s,
        "e2e_p50_s": rep.e2e_p50_s, "e2e_p99_s": rep.e2e_p99_s,
        "segments": rep.segments, "steps": steps, "admits": admits,
        "scale_ups": rep.scale_ups, "scale_downs": rep.scale_downs,
        "peak_replicas": peak_n, "lifecycles": final,
        "decisions": [(d["action"], d["replica"],
                       d["inputs"]["queue_sum"]) for d in decs],
        "warm_s": [w["seconds"] for w in warmed],
        "warm_keys": [w["keys"] for w in warmed],
        "standby_warmup_s": standby_s,
        "drains": {r.idx: r.last_drain for r in router._replicas
                   if r.last_drain},
        "requeued": router.requeued,
        "prefixes_migrated": sum(1 for r in recs
                                 if r["kind"] == "tier_migrate"
                                 and r.get("rid") is None),
        "built": built,
        "against_one_engine": agreement(toks, rtoks),
        "parted_at_near_ties": parted_at_near_ties(
            torch, llama, params, cfg, [a.prompt for a in trace], toks,
            rtoks, "3k (b)")}
    del router, engines, pcs, one, ref, rpc

    # (c) the chip fit against the card
    hbm = torch.cuda.mem_get_info()[1]
    fit = memory.chip_fit(cfg, params, pool=eng.pager, hbm_bytes=hbm)
    fam = memory.family_envelopes(eng, env, hbm_bytes=hbm)
    # the allocator's two counts at each build: the bytes the tensors
    # asked for ("requested") and the blocks it handed out (``allocated``,
    # rounded: a block past 1 MiB that leaves less than 1 MiB over is not
    # split)
    def mem():
        torch.cuda.synchronize()
        return (torch.cuda.memory_stats()["requested_bytes.all.current"],
                torch.cuda.memory_allocated())

    m0 = mem()
    w = {k: v.clone() for k, v in params.items()}
    m1 = mem()
    pg = PagedKVCache(cfg, 8, PAGE, TIER_POOL_PAGES + 1,
                      TIER_MAX_LEN // PAGE, DEVICE)
    m2 = mem()
    measured = {"weights_bytes": m1[0] - m0[0], "pool_bytes": m2[0] - m1[0],
                "weights_allocated": m1[1] - m0[1],
                "pool_allocated": m2[1] - m1[1], "serve_peak_bytes": peak}
    if (measured["weights_bytes"], measured["pool_bytes"]) != (
            fit["weights_bytes"], fit["pool_bytes"]):
        raise AssertionError(f"3k (c): requested {measured} at build, the "
                             f"fit counts {fit['weights_bytes']} and "
                             f"{fit['pool_bytes']}")
    del w, pg
    asc = autoscaler.Autoscaler(min_replicas=1, max_replicas=2,
                                initial_replicas=1, queue_high=1,
                                hbm_bytes=fit["envelope_bytes"] - 1)
    router = fleet.FleetRouter([engine(), engine()],
                               seg_steps=ELASTIC_SEG_STEPS, autoscaler=asc)
    j = journal.Journal()
    with journal.attach(j):
        rep = router.serve([sched.Arrival(0.0, a.prompt, a.max_new_tokens)
                            for a in arrivals[:4]])
    refusals = [r for r in j.records() if r["kind"] == "scale_decision"
                and r["action"] == "refuse"]
    if (len(refusals) != 1 or rep.scale_ups
            or router._replicas[1].lifecycle != "offline"
            or rep.n_requests != 4):
        raise AssertionError(f"3k (c): refusals {refusals}, "
                             f"{rep.scale_ups} scale-ups")
    out["chip_fit"] = {
        "hbm_bytes": hbm, "fit": fit,
        "measured": measured,
        "family_transients": {f: {"widest_key": v["widest_key"],
                                  "transient_bytes": v["transient_bytes"],
                                  "envelope_bytes":
                                      v["fit"]["envelope_bytes"]}
                              for f, v in fam.items()},
        "refusal": {"reason": refusals[0]["reason"],
                    "fit": refusals[0]["fit"]}}
    del router, eng, pc, held
    return out, launches


# ---------------------------------------------------------------------------
# phase 6e: the text models through Model.fit, the other optimizers and the
# losses on the card
# ---------------------------------------------------------------------------

# Imdb at its defaults (2000 training documents of 64 tokens: 32 batches an
# epoch, the last of 16); the BiLSTM's 21 fp32 params are one flat group
IMDB_BATCH, IMDB_EPOCHS, IMDB_VS_PLAIN_STEPS, IMDB_PROFILED_STEPS = \
    64, 2, 4, 2
# Imikolov's 5000 training 4-grams: 20 batches, the last of 136
IMIKOLOV_BATCH, IMIKOLOV_LR = 256, 1e-3
# multi_tensor_update at the BiLSTM's population (21 tensors of 2,141,922
# elements, 2,144,256 padded): fp32 Adam, its fit's update, against torch._fused_adam_
BILSTM_VARIANT = LENET_VARIANT
# the BiLSTM's parameters, kernel path against plain path after
# IMDB_VS_PLAIN_STEPS Adam steps: within 1 % of one step's size (Adam's lr
# 1e-3). The kernel and its plain version differ in the last bit (powf
# against torch.pow for the bias corrections, contracted multiply-adds);
# the next steps' gradients carry that, and an embedding row whose
# gradient nearly cancels turns it into a visible share of its normalized
# step (on an H100 80GB HBM3: 6 of 640,000 embedding entries 9.5e-7 apart,
# the plain path deterministic)
IMDB_PARAM_ATOL = 1e-5
TEXT_KINDS = {"update": RESNET_KINDS["update"],
              "pack": RESNET_KINDS["pack"], "matmul": MATMUL}


def imdb_model(port, recipes):
    """6e(a)'s ``Model``: the BiLSTM from the port's initializers under
    seed 0, prepared with ``Adam``, ``CrossEntropyLoss`` and
    ``Accuracy``."""
    port.seed(0)
    net = recipes.SentimentBiLSTM()
    model = port.Model(net)
    model.prepare(port.optimizer.Adam(parameters=net.parameters()),
                  port.nn.CrossEntropyLoss(), port.metric.Accuracy())
    return model


def imdb_vs_plain(torch, port, recipes, mtu, fns, train):
    """6e(a.1): fits of ``IMDB_VS_PLAIN_STEPS`` steps in order from the
    same seeded BiLSTM under ``torch.use_deterministic_algorithms``, once
    through the kernel and twice through its plain version (the repeat
    says whether the step itself is deterministic on the card): every
    batch's loss within ``MTU_TOL``, and each parameter within
    ``IMDB_PARAM_ATOL`` of the plain run's, plus however far the second
    plain run is from the first; one launch a step on the kernel fit,
    none on the plain fits."""
    steps, runs = IMDB_VS_PLAIN_STEPS, []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for plain in (False, True, True):
                model = imdb_model(port, recipes)
                rec = mnist_recorder(port)
                zero_counts(fns)
                with (mock.patch.object(mtu, "multi_tensor_update",
                                        mtu.flat_update_plain) if plain
                      else contextlib.nullcontext()):
                    model.fit(train, epochs=1, batch_size=IMDB_BATCH,
                              shuffle=False, verbose=0, num_iters=steps,
                              callbacks=[rec])
                n = read_counts(fns)
                if not plain:
                    check_counts(n, {"multi_tensor_update": steps},
                                 "the BiLSTM kernel fit")
                elif any(n.values()):
                    raise AssertionError(f"launches on the plain BiLSTM "
                                         f"fit: {n}")
                runs.append((rec.losses, {
                    k: v.detach().clone()
                    for k, v in model.network.state_dict().items()}))
    finally:
        torch.use_deterministic_algorithms(False)
    (lk, sk), (lp, sp), (_, sp2) = runs
    rtol, atol = MTU_TOL["torch.float32"]
    np.testing.assert_allclose(lk, lp, rtol=rtol, atol=atol,
                               err_msg="BiLSTM losses, kernel against plain")
    repeat = all(torch.equal(v, sp2[k]) for k, v in sp.items())
    for k, got in sk.items():
        slack = (sp2[k] - sp[k]).abs() + IMDB_PARAM_ATOL + rtol * sp[
            k].abs()
        if not ((got - sp[k]).abs() <= slack).all():
            raise AssertionError(
                f"BiLSTM {k}: kernel against plain "
                f"{(got - sp[k]).abs().max().item():.3e}, plain against "
                f"plain {(sp2[k] - sp[k]).abs().max().item():.3e}")
    return {"steps": steps, "losses_kernel": lk, "losses_plain": lp,
            "loss_max_abs_err": max(abs(a - b) for a, b in zip(lk, lp)),
            "param_max_abs_err": max((v - sp[k]).abs().max().item()
                                     for k, v in sk.items()),
            "plain_repeat_max_abs_err": max(
                (v - sp[k]).abs().max().item() for k, v in sp2.items()),
            "plain_repeat_bit_identical": repeat,
            "bit_identical": all(torch.equal(v, sp[k])
                                 for k, v in sk.items())}


def imdb_fit(torch, port, recipes, fns, train, test):
    """6e(a.2): two timed epochs of the BiLSTM (every count at 0 before
    each): samples/s, ms a step, launches a step and the test set's
    ``evaluate`` after each; then ``IMDB_PROFILED_STEPS`` more steps under
    the profiler for the busy share and the flat update's device time a
    step."""
    model = imdb_model(port, recipes)
    batches = math.ceil(len(train) / IMDB_BATCH)
    epochs, launches = [], {}
    np.random.seed(0)  # the loader's shuffles
    for epoch in range(IMDB_EPOCHS):
        rec = mnist_recorder(port)
        torch.cuda.synchronize()
        zero_counts(fns)
        t0 = time.perf_counter()
        model.fit(train, epochs=1, batch_size=IMDB_BATCH, verbose=0,
                  callbacks=[rec])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = read_counts(fns)
        check_counts(n, {"multi_tensor_update": batches},
                     f"BiLSTM epoch {epoch}")
        launches = {k: launches.get(k, 0) + v for k, v in n.items()}
        if not all(math.isfinite(v) for v in rec.losses):
            raise AssertionError(f"non-finite BiLSTM loss: {rec.losses}")
        epochs.append({
            "samples_per_s": len(train) / wall,
            "ms_per_step": 1e3 * wall / batches,
            "loader_ms_per_batch": 1e3 * sum(rec.loader_s) / batches,
            "launches_per_step": n["multi_tensor_update"] / batches,
            "first_loss": rec.losses[0], "last_loss": rec.losses[-1],
            "test": model.evaluate(test, batch_size=IMDB_BATCH, verbose=0)})
    if not epochs[-1]["test"]["acc"] > 0.5:
        raise AssertionError(f"BiLSTM test accuracy after {IMDB_EPOCHS} "
                             f"epochs: {epochs[-1]['test']}")
    out = {"batches_per_epoch": batches, "epochs": epochs,
           "parameters": len(model.network.parameters())}
    prof = device_profile(torch, lambda: model.fit(
        train, epochs=1, batch_size=IMDB_BATCH, verbose=0,
        num_iters=IMDB_PROFILED_STEPS), kinds=TEXT_KINDS)
    if prof is None:
        out["device_busy_share"] = None
    else:
        n = IMDB_PROFILED_STEPS
        out.update(device_ms_per_step=prof["device_ms"] / n,
                   profiled_wall_ms_per_step=prof["wall_ms"] / n,
                   device_busy_share=prof["device_ms"] / prof["wall_ms"],
                   update_device_ms_per_step=prof["split_ms"]["update"] / n,
                   device_split_ms_per_step={
                       k: v / n for k, v in prof["split_ms"].items()},
                   device_top=prof["top"][:6], host_top=prof["host_top"])
    return out, launches


def lm_mean_loss(torch, port, net, data):
    """The mean NLL of ``NGramGRU`` over ``data`` (eval mode, no grad)."""
    net.eval()
    total = 0.0
    with torch.no_grad():
        for batch in port.io.DataLoader(data, batch_size=1024):
            total += port.nn.functional.nll_loss(
                net(*batch[:-1]), batch[-1].reshape(-1),
                reduction="sum").item()
    net.train()
    return total / len(data)


def imikolov_fit(torch, port, recipes, fns):
    """6e(b): one epoch of the n-gram GRU with centered RMSProp and
    momentum (no flat kind: no kernel launch): predicted tokens/s, the
    first and last batch's loss, and the mean loss over the training set
    before and after, which must fall."""
    port.seed(0)
    net = recipes.NGramGRU()
    model = port.Model(net)
    model.prepare(port.optimizer.RMSProp(
        learning_rate=IMIKOLOV_LR, centered=True, momentum=0.9,
        parameters=net.parameters()), recipes.NGramLoss())
    train = port.text.Imikolov(mode="train")
    before = lm_mean_loss(torch, port, net, train)
    rec = mnist_recorder(port)
    torch.cuda.synchronize()
    zero_counts(fns)
    t0 = time.perf_counter()
    model.fit(train, epochs=1, batch_size=IMIKOLOV_BATCH, verbose=0,
              callbacks=[rec])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(read_counts(fns).values()):
        raise AssertionError(f"kernel launches on the RMSProp fit: "
                             f"{read_counts(fns)}")
    after = lm_mean_loss(torch, port, net, train)
    if not after < before:
        raise AssertionError(f"the GRU LM's training loss did not fall: "
                             f"{before} -> {after}")
    return {"batches": len(rec.losses), "tokens_per_s": len(train) / wall,
            "ms_per_step": 1e3 * wall / len(rec.losses),
            "first_batch_loss": rec.losses[0],
            "last_batch_loss": rec.losses[-1],
            "mean_loss_before": before, "mean_loss_after": after}


def text_phase(torch, port, recipes, parity, mtu, fns):
    """Phase 6e: (a) the BiLSTM on Imdb, (b) the GRU LM on Imikolov, (c)
    the other optimizers and (d) the losses, each card against the CPU."""
    train = port.text.Imdb(mode="train")
    test = port.text.Imdb(mode="test")
    vsp = imdb_vs_plain(torch, port, recipes, mtu, fns, train)
    fit, launches = imdb_fit(torch, port, recipes, fns, train, test)
    lm = imikolov_fit(torch, port, recipes, fns)
    t0 = time.perf_counter()
    opts = parity.optimizer_parity(DEVICE)
    opt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    losses = parity.loss_parity(DEVICE)
    return {"imdb_vs_plain": vsp, "imdb_fit": fit, "imikolov": lm,
            "optimizers": opts, "optimizers_s": opt_s, "losses": losses,
            "losses_s": time.perf_counter() - t0}, launches


# ---------------------------------------------------------------------------
# phase 6f: vision.transforms, vision.ops and QAT/PTQ on the card
# ---------------------------------------------------------------------------

def corpus_phase(torch, op_corpus, fns, card):
    """Phase 6g: (a) every op of ``all_ops()`` on the card against the CPU
    (``op_corpus.op_sweep``: outputs, gradients, the decompositions'
    invariants, the random ops' distributions), (b) the README's
    quickstart on the card and ``op_corpus.STEPS`` AdamW steps of its
    model written with Tensor methods, each loss against the CPU's, no
    kernel launched (``op_corpus.readme_phase``). Prints each part;
    returns its stats and the launches of (b)'s steps."""
    counts = (lambda: zero_counts(fns), lambda: read_counts(fns))
    t6g = time.perf_counter()
    try:
        sweep = op_corpus.op_sweep(DEVICE)
    except AssertionError as e:
        fail(f"6g (a): {e}")
    errs = " ".join(
        f"{name}={r['err']:.1e}" + ("" if r["grad_err"] is None
                                    else f"/{r['grad_err']:.1e}")
        for name, r in sweep["ops"].items())
    print(f"6g (a) ops held, card against CPU ({card}; {op_corpus.N}^2 "
          f"fp32, decompositions {op_corpus.BATCH}x{op_corpus.K}^2; largest "
          f"difference over max(1, largest value), output/gradient): {errs}")
    print(f"6g (a) random ops on the card ({card}): "
          f"{json.dumps(sweep['random'])}")
    slow = sorted(sweep["ops"].items(), key=lambda kv: -(kv[1]["ms"] or 0))
    print(f"6g (a) {sweep['held']} ops held, largest error "
          f"{sweep['max_err']:.3e} ({sweep['worst']}; tolerance "
          f"{op_corpus.TOL}, the spectra's {op_corpus.SPECTRA_TOL}), "
          f"{sweep['seconds']} s; the card's slowest calls (ms, with the "
          f"backward, first calls included): "
          f"{json.dumps({k: v['ms'] for k, v in slow[:10]})}")
    readme = op_corpus.readme_phase(DEVICE, counts=counts)
    sc, launches = readme["script"], readme["launches"]
    if not (np.isfinite(sc["loss"]) and sc["loss_type"] == "Tensor"):
        fail(f"6g (b): the README script's loss {sc}")
    # the README's AdamW updates 4 tensors: below the flat update's 9, the
    # reference (paddle_tpu/optimizer/optimizer.py:204) and the port
    # (optimizer/optimizer.py:246) update each parameter apart, so no
    # hand-written kernel runs on this path
    if any(sc["launches"].values()) or any(launches.values()):
        fail(f"6g (b): the README's 4-tensor AdamW launched kernels: "
             f"{sc['launches']}, {launches}")
    # the step's two ``x.matmul`` took the reference's form (the op, through
    # ``run_op``) on the card
    if readme["step_ops"].count("matmul") != 2:
        fail(f"6g (b): the method step ran {readme['step_ops']} as ops")
    if not readme["loss_max_rel_err"] <= op_corpus.LOSS_RTOL:
        fail(f"6g (b): losses {readme['losses']} against the CPU's "
             f"{readme['losses_cpu']}")
    print(f"6g (b) README quickstart on the card ({card}): loss "
          f"{sc['loss']:.4f} ({sc['loss_type']}), no kernel launched (its "
          f"AdamW updates 4 tensors apart, as the reference's does below "
          f"9); {readme['steps']} AdamW steps written with Tensor methods "
          f"(ops through run_op in a step: {readme['step_ops']}) "
          f"at 784 -> 256 -> 10, batch 32: losses "
          f"{', '.join(f'{v:.5f}' for v in readme['losses'])}, largest "
          f"relative difference from the CPU's "
          f"{readme['loss_max_rel_err']:.3e} (<= {op_corpus.LOSS_RTOL}), "
          f"{readme['seconds']} s")
    secs = round(time.perf_counter() - t6g, 1)
    print(f"phase 6g (the tensor core and the op corpus): {secs} s")
    return {"sweep": sweep, "readme": readme, "seconds": secs}, launches


# phase 6h's bounds, set from the H100's readings (PERF.md): the
# fused bf16-gradient step's loss against phase 5's unfused fp32-gradient
# step, relative, over the 12 steps (read 3.146e-4 twice: the steps are
# deterministic; the bound is 3.2x); the first decode tick's logits of the
# fused tree against the unfused one's, int8 weights and bf16 through the
# paged kernel (read 0 in both: one bf16 ulp at the logits' magnitude,
# 4-8, is allowed, a single rounding that lands the other way)
FUSED_LOSS_RTOL = 1e-3
FUSED_INT8_LOGIT_ATOL = 2.0 ** -5
FUSED_BF16_LOGIT_ATOL = 2.0 ** -5
# 6h (c)'s drains: the first requests of the mixed workload. The int8
# pair (fused and unfused) went from 32 to 16 requests for phase 6i: its
# launches a decode step and its first tick's logits do not depend on
# how many requests the drain holds; the tokens of 16 are still compared
FUSED_INT8_REQUESTS = 16
FUSED_BF16_REQUESTS = 8


def llama_opts_phase(torch, llama, rlo, tf, qm, ServingEngine, fns, card,
                     train5, params5, tok5):
    """Phase 6h (``experiments/runtime_llama_opts.py``): (a) the runtime
    modules on the card; (b) bench.py's step with ``fused_weights`` and
    ``bf16_grads`` from phase 5's initial fp32 weights (``params5``, on
    the host) and batch (``tok5``), each loss against phase 5's
    (``train5``) and the launches a step; (c) the int8 paged drain of
    phase 3d's first ``FUSED_INT8_REQUESTS`` requests with
    ``fused_weights`` (49 ``quant_matmul``
    launches a decode step against 85), tokens against the unfused drain,
    and a short bf16 paged serve through the paged kernel, each with its
    first tick's logits against the unfused tree's, and ``quant_matmul``'s
    columns at both widths; and the rope on q and k read by their stride
    out of a fused product. Returns (stats, launches by path)."""
    counts = (lambda: zero_counts(fns), lambda: read_counts(fns))
    t6h, secs = time.perf_counter(), {}
    try:
        rt = rlo.runtime_checks(DEVICE)
    except AssertionError as e:
        fail(f"6h (a): {e}")
    secs["a"] = round(time.perf_counter() - t6h, 1)
    print(f"6h (a) runtime modules on the card ({card}): devices "
          f"{rt['devices']}; memory statistics equal torch.cuda's before, "
          f"holding 1 GiB and after its release (allocated "
          f"{rt['memory']['before'][0]} -> {rt['memory']['holding'][0]} -> "
          f"{rt['memory']['freed'][0]} B); a side-stream copy joined by "
          f"wait_stream right; Event.query {rt['event_query']}; "
          f"custom_relu built with g++ and run on "
          f"{rt['custom_relu']['device']} ({rt['custom_relu']['elements']} "
          f"elements, C backward equal to the plain gradient); dlpack "
          f"shares memory; the tensor checker named log; run_check: "
          f"{rt['run_check']!r}; version.cuda() {rt['version_cuda']}")

    cfg = llama.LlamaConfig.bert_base_equiv()
    params = {k: v.to(DEVICE) for k, v in params5.items()}
    L = cfg.num_layers
    fb, tlaunches = rlo.fused_train(
        llama, cfg, params, tok5, counts,
        profile=lambda run: device_profile(torch, run))
    del params
    steps = fb["timed_steps"]
    try:
        check_counts(tlaunches, {"flash_attention_fwd": L * steps,
                                 "flash_attention_bwd": L * steps,
                                 "head_dx_softmax": steps},
                     f"6h (b): {steps} fused bf16-gradient steps")
    except AssertionError as e:
        fail(str(e))
    gaps = [abs(a - b) / abs(b) for a, b in zip(fb["losses"],
                                                train5["losses"])]
    fb["loss_rel_gap"] = gaps
    fb["phase5_losses"] = train5["losses"]
    if len(gaps) != len(train5["losses"]) or max(gaps) > FUSED_LOSS_RTOL:
        fail(f"6h (b): fused bf16-gradient losses {fb['losses']} against "
             f"phase 5's {train5['losses']}: relative gaps {gaps}")
    secs["b"] = round(time.perf_counter() - t6h, 1)
    print(f"6h (b) bench.py's step with fused_weights and bf16_grads "
          f"({card}): B 44 S 512, {fb['warmup_steps']} + {steps} steps from "
          f"phase 5's initial weights (wq/wk/wv, w_gate/w_up concatenated): "
          f"losses {', '.join(f'{x:.5f}' for x in fb['losses'])}; largest "
          f"relative gap from phase 5's {max(gaps):.3e} (<= "
          f"{FUSED_LOSS_RTOL}); {fb['ms_per_step']:.3f} ms/step (phase 5 "
          f"{train5['ms_per_step']:.3f}), device "
          f"{fb.get('device_ms_per_step')} ms in one profiled step (phase 5 "
          f"{train5.get('device_ms_per_step')}); launches a step: flash "
          f"forward {tlaunches['flash_attention_fwd'] // steps}, backward "
          f"{tlaunches['flash_attention_bwd'] // steps}, head_dx_softmax "
          f"{tlaunches['head_dx_softmax'] // steps}")
    print(f"6h (b) device time (ms/step) by kind: "
          f"{json.dumps(fb.get('device_split_ms'))} (phase 5 "
          f"{json.dumps(train5.get('device_split_ms'))}); largest kernels: "
          f"{json.dumps(fb.get('device_top'))}")

    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    reqs = mixed_workload(np.random.RandomState(0), 32, cfg.vocab_size)
    need = max(len(p) + g - 1 for p, g in reqs)
    max_len = min(cfg.max_seq_len, -(-need // 128) * 128)
    serves, launches = {}, {}
    for key, path, rs, quant, atol in (
            ("int8", "quant_int8_fused_drain", reqs[:FUSED_INT8_REQUESTS],
             "int8",
             FUSED_INT8_LOGIT_ATOL),
            ("bf16", "paged_fused_drain", reqs[:FUSED_BF16_REQUESTS], None,
             FUSED_BF16_LOGIT_ATOL)):
        st, n = rlo.fused_serve(llama, ServingEngine, cfg, params, rs,
                                quant=quant, counts=counts, max_len=max_len,
                                page_size=PAGE)
        f = st["fused"]
        try:
            check_counts(n, paged_counts(L, f["steps"], f["decode_steps"],
                                         bool(quant), projections=4),
                         f"6h (c) {key}: {f['steps']} steps, "
                         f"{f['decode_steps']} decode")
        except AssertionError as e:
            fail(str(e))
        if not st["tick_logit_max_abs_err"] <= atol:
            fail(f"6h (c) {key}: the first tick's logits of the fused tree "
                 f"{st['tick_logit_max_abs_err']} from the unfused one's")
        serves[key], launches[path] = st, n
        tick_q = (n.get("quant_matmul", 0) - (f["steps"] - f["decode_steps"])
                  ) / max(1, f["decode_steps"])
        print(f"6h (c) {key} paged drain with fused_weights ({card}): "
              f"{st['requests']} requests, {st['new_tokens']} tokens, "
              f"{st['identical_requests']}/{st['requests']} identical to the "
              f"unfused drain (matched-prefix rate "
              f"{st['matched_prefix_rate']:.4f}); first tick's logits max "
              f"|err| {st['tick_logit_max_abs_err']:.3e} of "
              f"{st['tick_logit_max_abs']:.3e} (<= {atol}), argmax agreement "
              f"{st['tick_argmax_agree']:.4f}, prefill logits "
              f"{st['prefill_logit_max_abs_err']:.3e}; "
              f"{f['tokens_per_s']:.1f} tokens/s against "
              f"{st['unfused']['tokens_per_s']:.1f} unfused; "
              + (f"quant_matmul {tick_q:g} a decode step (85 unfused); "
                 if quant else "")
              + f"launches {json.dumps(n)}")
    col = rlo.quant_column_check(llama, qm, cfg, params)
    serves["int8"]["column_check"] = col
    print(f"6h (c) quant_matmul's columns at N {col['N'][0]} against the "
          f"same columns at N {col['N'][1]} ({card}; tiling (columns a "
          f"block, blocks along K) {col['tiling'][0]} and "
          f"{col['tiling'][1]}): fp32 outputs {col['fp32_max_abs_diff']:.3e} "
          f"apart, {col['rounded_differ_share']:.4f} of the entries differ "
          f"in bf16")
    del params
    from paddle_tpu_torch.experiments._timing import time_ms
    st = rlo.strided_rope_check(tf, DEVICE, cfg, timer=time_ms)
    if st["against_contiguous"] != 0.0 or not st["plain_ok"]:
        fail(f"6h: the rope on strided rows {st}")
    serves["strided_rope"] = st
    print(f"6h rope on q and k read by their row stride from a fused "
          f"[{st['rows']}, {st['width']}] bf16 product ({card}): equal to "
          f"the launch on contiguous copies, "
          f"{st['against_plain']:.3e} from the plain version (rtol 1.6e-2, "
          f"atol {st['plain_atol']:.3e}); {st['ms_strided']} ms a launch "
          f"on the strided rows, {st['ms_contiguous']} on contiguous rows, "
          f"{st['ms_copies_and_launch']} with the two copies")
    secs["c"] = round(time.perf_counter() - t6h, 1)
    print(f"phase 6h seconds to the end of each part: {json.dumps(secs)}")
    return ({"runtime": rt, "train": fb, "serve": serves,
             "seconds_to_end_of": secs},
            {"train_fused_bf16_grads": tlaunches, **launches})


# phase 6i: the mesh steps on phase 5's weights and batch
MESH_WORLD1_STEPS = 3
MESH_LAYOUT_BATCH = 8
MESH_LAYOUT_STEPS = 2
MESH_TIMEOUT_S = 240


def mesh_phase(torch, llama, mesh_train, fns, card, train5, params5, tok5):
    """Phase 6i (``experiments/mesh_train.py``): (a) a world of one (NCCL)
    and ``make_sharded_train_step`` on a mesh with every degree 1 from
    phase 5's initial weights and batch: each loss equal to phase 5's bit
    for bit, 12 / 12 / 1 launches a step; (b) one world of 4 gloo ranks
    sharing the card, dp 2 x mp 2 at ZeRO 3, mp 2 x sep 2 with the ring
    and with Ulysses, each against one rank's step on the same weights
    and batch. Returns (stats, launches by path)."""
    t6i, secs = time.perf_counter(), {}
    cfg = llama.LlamaConfig.bert_base_equiv()
    params = {k: v.to(DEVICE) for k, v in params5.items()}
    counts = (lambda: zero_counts(fns), lambda: read_counts(fns))
    w1 = mesh_train.world1_steps(llama, cfg, params, tok5,
                                 MESH_WORLD1_STEPS, counts)
    del params
    want = train5["losses"][:MESH_WORLD1_STEPS]
    L = cfg.num_layers
    for i, n in enumerate(w1["launches"]):
        try:
            check_counts(n, {"flash_attention_fwd": L,
                             "flash_attention_bwd": L,
                             "head_dx_softmax": 1}, f"6i (a) step {i}")
        except AssertionError as e:
            fail(str(e))
    if w1["losses"] != want:
        fail(f"6i (a): losses {w1['losses']} on a mesh of one against "
             f"phase 5's {want}")
    secs["a"] = round(time.perf_counter() - t6i, 1)
    print(f"6i (a) make_sharded_train_step on a mesh of one ({card}; "
          f"{w1['backend']}, world {w1['world_size']}): losses "
          f"{w1['losses']} equal to phase 5's bit for bit, launches a step "
          f"{json.dumps({k: v for k, v in w1['launches'][-1].items() if v})}"
          f", ms a step {[round(x, 3) for x in w1['ms_per_step']]} "
          f"(phase 5: {train5['ms_per_step']:.3f})")
    tok8 = tok5[:MESH_LAYOUT_BATCH].cpu().numpy()
    try:
        ranks = mesh_train.spawn(mesh_train.layouts_vs_single, 4,
                                 args=({}, tok8, MESH_LAYOUT_STEPS),
                                 device="cuda", backend="gloo",
                                 timeout=MESH_TIMEOUT_S)
    except RuntimeError as e:
        fail(f"6i (b): {e}")
    rep = ranks[0]["report"]
    one = rep.pop("one_rank")
    g3 = lambda d: {k: float(f"{v:.3e}") for k, v in d.items()}
    print(f"6i (b) one rank ({card}, B {MESH_LAYOUT_BATCH} S 512): loss "
          f"bf16 {one['loss_bf16']:.8f}, fp32 {one['loss_fp32']:.8f}, bf16 "
          f"with the custom CE tail {one['loss_ce_tail']:.8f}; the custom "
          f"tail's gradients against the plain CE's, relative to the norm "
          f"{json.dumps(g3(one['ce_tail_vs_plain']))}, against fp32 "
          f"{json.dumps(g3(one['ce_tail_vs_fp32']))}")
    launches = {"6i_world1": sum_counts(*w1["launches"])}
    for name, row in rep.items():
        per_rank = [r["launches"][name] for r in ranks]
        summed = sum_counts(*per_rank)
        print(f"6i (b) {name} ({card}, 4 gloo ranks on one card, B "
              f"{MESH_LAYOUT_BATCH} S 512 bf16, remat): losses "
              f"{row['losses']}, step 0 against one rank's "
              f"{row['loss_single']:.8f} (|err| {row['loss_abs_err']:.3e} "
              f"<= {mesh_train.LOSS_ATOL}); each gradient's distance from "
              f"the fp32 step at most {row['grad_ratio_worst']} times one "
              f"bf16 rank's (<= {mesh_train.GRAD_RATIO}); relative to the "
              f"norm, against one bf16 rank "
              f"{json.dumps(g3(row['grad_vs_one_rank']))}, against fp32 "
              f"{json.dumps(g3(row['grad_vs_fp32']))}, one bf16 rank "
              f"against fp32 {json.dumps(g3(row['one_rank_vs_fp32']))}; "
              f"flash launches a rank "
              f"{[(r['flash_attention_fwd'], r['flash_attention_bwd']) for r in per_rank]}"
              f" at (heads, rows) {row['flash_heads_rows']}; calls staged "
              f"through the host in step 0 {json.dumps(row['staged_step0'])}"
              f"; {row['seconds']:.1f} s")
        launches[f"6i_{name}"] = {k: summed.get(k, 0) for k in fns}
    heads = {n: r["flash_heads_rows"] for n, r in rep.items()}
    if heads != {"dp2_mp2_zero3": [(6, 512)], "mp2_sep2_ring": [],
                 "mp2_sep2_ulysses": [(3, 512)]}:
        fail(f"6i (b): the flash kernels ran at (heads, rows) {heads}")
    secs["b"] = round(time.perf_counter() - t6i, 1)
    print(f"phase 6i seconds to the end of each part: {json.dumps(secs)}")
    return {"world1": w1, "layouts": rep, "seconds_to_end_of": secs}, \
        launches


# phase 6j: BASELINE config 3, Fleet data-parallel ResNet-50, on phase 6's
# batch: a world of one, then 4 gloo ranks sharing the card (B 32 a rank)
FLEET_WORLD1_STEPS = 3
FLEET_RANKS = 4
FLEET_DP_STEPS = 2
FLEET_TIMEOUT_S = 300


def dp_fleet_phase(torch, port, fleet_dp, fns, card, x, y, rtrain):
    """Phase 6j (``experiments/fleet_dp.py``): (a) the PaddleClas eager
    loop through ``fleet.init`` (a world of one on NCCL),
    ``distributed_model`` and ``distributed_optimizer`` against the same
    loop without Fleet, bit for bit under deterministic cuDNN, one
    ``multi_tensor_update`` launch a flat plan and step; (b) 4 gloo ranks
    sharing the card, ``DataParallel`` with plain BatchNorm: each synced
    gradient against the mean of the four ranks' own (bit for bit, or
    within the sum-order bound), the parameters equal on every rank, one
    fp32 all-reduce a bucket and step; (c) the same ranks with
    ``SyncBatchNorm``: step 0's loss, gradients and running statistics
    held to the one-process step on the whole batch under
    ``fleet_dp.ratio_bar`` and ``LOSS_ATOL``, which (b)'s per-rank
    statistics must fail on the loss and the running statistics.
    Returns (stats, launches by path)."""
    counts = (lambda: zero_counts(fns), lambda: read_counts(fns))
    rep = fleet_dp.run_6j(
        port, x, y, counts,
        lambda run: device_profile(torch, run, kinds=RESNET_KINDS),
        FLEET_WORLD1_STEPS, FLEET_RANKS, FLEET_DP_STEPS,
        timeout=FLEET_TIMEOUT_S)
    w1, plain, sync = rep["world1"], rep["plain"], rep["sync"]
    held, mutant, per_rank = rep["held"], rep["mutant"], rep["launches"]
    prof = w1.pop("profile")
    busy = (None if prof is None else prof["device_ms"] / prof["wall_ms"])
    print(f"6j (a) Fleet ResNet-50 ({card}; {w1['backend']}, world "
          f"{w1['world_size']}; {' / '.join(w1['wrapped'])}): B "
          f"{x.shape[0]} {x.shape[1]}x{x.shape[2]} NHWC O2 bf16 eager loop, "
          f"losses {w1['losses']} equal to the loop without Fleet bit for "
          f"bit; ms a step over the {FLEET_WORLD1_STEPS} "
          f"{w1['ms_per_step']:.3f} (the loop without Fleet, run first: "
          f"{w1['plain_ms_per_step']:.3f}; phase 6's fused_train_step "
          f"{rtrain['ms_per_step']:.3f}); "
          f"profiled step: device "
          f"{'not measured' if prof is None else round(prof['device_ms'], 3)}"
          f" ms of {'not measured' if prof is None else round(prof['wall_ms'], 3)}"
          f" ms wall (busy share "
          f"{'not measured' if busy is None else f'{busy:.4f}'}); "
          f"multi_tensor_update launches a step "
          f"{[n['multi_tensor_update'] for n in w1['launches']]} for "
          f"{w1['plans']} flat plan")
    print(f"6j (b) DataParallel through fleet.distributed_model ({card}; "
          f"{FLEET_RANKS} gloo ranks on one card, B "
          f"{x.shape[0] // FLEET_RANKS} a rank, plain BatchNorm): losses "
          f"{plain['losses']}; {plain['buckets']} buckets, one fp32 "
          f"all_reduce each a step (calls a step {plain['calls'][0]}); "
          f"synced gradients against the mean of the four ranks' own "
          f"{json.dumps(plain['mean_checks'])}; parameters equal on every "
          f"rank after each step; multi_tensor_update launches a step by "
          f"rank {[[n['multi_tensor_update'] for n in r['plain']] for r in per_rank]}"
          f"; ms a synced step "
          f"{[round(v, 3) for v in plain['ms']]}")
    show = ("loss", "loss_bf16", "loss_fp32", "loss_abs_err", "loss_bar",
            "worst", "worst_grad", "worst_stat", "checked")
    print(f"6j (c) SyncBatchNorm over the 4 ranks ({card}): step 0 against "
          f"the one-process step on all {x.shape[0]} images "
          f"{json.dumps({k: held[k] for k in show})} (bars: gradients "
          f"{fleet_dp.GRAD_RATIO} + {fleet_dp.SPREAD} / sqrt(n), running "
          f"statistics {fleet_dp.GRAD_RATIO}, loss {fleet_dp.LOSS_ATOL}); "
          f"calls a step {sync['calls'][0]}; "
          f"ms a step {[round(v, 3) for v in sync['ms']]}; the mutation "
          f"(per-rank statistics, (b)'s step 0) fails on "
          f"{len(mutant['failing'])} of {mutant['checked']} readings and "
          f"the loss ({mutant['loss_abs_err']:.3e}), worst "
          f"{json.dumps(mutant['worst'])}; rank seconds "
          f"{[round(v, 1) for v in rep['rank_seconds']]}")
    secs = {k: round(v, 1) for k, v in rep["seconds_to_end_of"].items()}
    print(f"phase 6j seconds to the end of each part: {json.dumps(secs)}")
    for i, n in enumerate(w1["launches"]):
        try:
            check_counts(n, {"multi_tensor_update": w1["plans"]},
                         f"6j (a) step {i}")
        except AssertionError as e:
            fail(str(e))
    for r, counted in enumerate(per_rank):
        for part, what in (("plain", "b"), ("sync", "c")):
            for i, n in enumerate(counted[part]):
                try:
                    check_counts(n, {"multi_tensor_update": 1},
                                 f"6j ({what}) rank {r} step {i}")
                except AssertionError as e:
                    fail(str(e))
    if rep["faults"]:
        fail("6j " + "; ".join(rep["faults"]))
    launches = {"6j_world1": sum_counts(*w1["launches"]),
                "6j_dp4": sum_counts(*(n for r in per_rank
                                       for n in r["plain"] + r["sync"]))}
    return rep, launches


def vision_phase(torch, port, bert, parity, vision_quant, fns, eager_fp32,
                 card):
    """Phase 6f: (a) the PaddleClas input pipeline through ``Model.fit``
    (``vision_quant.flowers_fit``), (b) the detection operators card
    against CPU at PaddleDetection's widths (``parity.detection_parity``),
    (c) QAT and PTQ at BERT-base width (``vision_quant.qat_bert``), held
    against 6c's unquantized fp32 step ``eager_fp32``. Prints each part;
    returns its stats and the launches of each path."""
    counts = (lambda: zero_counts(fns), lambda: read_counts(fns))
    t6f, fsecs = time.perf_counter(), {}
    flowers, vlaunches = vision_quant.flowers_fit(
        counts, lambda run: device_profile(torch, run, kinds=RESNET_KINDS))
    fsecs["a"] = round(time.perf_counter() - t6f, 1)
    fp = flowers["against_plain"]
    print(f"6f (a) Flowers-102, {fp['steps']} steps on one batch, the flat "
          f"update against its plain version ({card}): losses "
          f"{fp['losses_kernel']} and {fp['losses_plain']}, largest "
          f"difference {fp['max_abs_err']:.3e}, bit-identical "
          f"{fp['bit_identical']}")
    for nw in (0, 4):
        st = flowers[f"workers_{nw}"]
        print(f"6f (a) Flowers-102 fit, num_workers={nw} ({card}): "
              f"resnet50(102) O2 bf16 Momentum, {flowers['batches']} "
              f"batches of {flowers['batch']} at 224x224: "
              f"{st['images_per_s']:.1f} images/s, {st['ms_per_step']:.3f} "
              f"ms/step (loader {st['loader_ms_per_batch']:.3f} ms, "
              f"train_batch {st['train_batch_ms_per_batch']:.3f} ms a "
              f"batch), multi_tensor_update launches a step "
              f"{st['launches_per_step']} for {flowers['flat_groups']} flat "
              f"groups, loss {st['first_loss']:.4f} -> {st['last_loss']:.4f}")
    fbusy = flowers.get("device_busy_share")
    print(f"6f (a) profiled {flowers.get('profiled_steps')} steps ({card}): "
          f"device {flowers.get('device_ms_per_step', 'not measured')} ms a "
          f"step of {flowers.get('profiled_wall_ms_per_step', 'not measured')}"
          f" ms wall (busy share "
          f"{'not measured' if fbusy is None else f'{fbusy:.4f}'}), by kind "
          f"{json.dumps(flowers.get('device_split_ms'))}; evaluate on "
          f"Flowers(mode='test'): {json.dumps(flowers['eval'])}; the serial "
          f"epoch replayed on the CPU: "
          f"{json.dumps(flowers['replayed_on_cpu'])}")
    print(f"launches on the Flowers fits: {json.dumps(vlaunches)}")
    det = parity.detection_parity(DEVICE)
    fsecs["b"] = round(time.perf_counter() - t6f, 1)
    fpn = det.pop("fpn")
    shown = ("ms", "ms_bwd", "max_abs_err", "max_abs_ref", "grad_max_abs_err",
             "grad_max_abs_ref")
    for name, r in det.items():
        bwd = (f", backward {r['ms_bwd']:.4f} ms (gradient max |err| "
               f"{r['grad_max_abs_err']:.3e} of {r['grad_max_abs_ref']:.3e})"
               if "ms_bwd" in r else "")
        rest = {k: v for k, v in r.items() if k not in shown}
        print(f"6f (b) {name} ({card}): forward {r['ms']:.4f} ms, max |err| "
              f"{r['max_abs_err']:.3e} of {r['max_abs_ref']:.3e}{bwd}; "
              f"{json.dumps(rest)}")
    print(f"6f (b) distribute_fpn_proposals ({card}): "
          f"{json.dumps(fpn['distribute_fpn_proposals'])}; roi_align by "
          f"level: {json.dumps(fpn['levels'])}")
    det["fpn"] = fpn
    bcfg = bert.BertConfig.bert_base()
    qtok, qlab = bert.random_mlm_batch(bcfg, EAGER_BATCH, BERT_SEQ, seed=2,
                                       device=DEVICE)
    qat, qatlaunches = vision_quant.qat_bert(
        lambda: eager_bert(port, bcfg), qtok.long(), qlab.long(), counts,
        lambda run: device_profile(torch, run, kinds={
            "flash_f32": ("flash_fwd_f32", "flash_bwd_f32"),
            "hand_written": HAND_WRITTEN, "matmul": MATMUL}),
        layers=bcfg.num_layers)
    fsecs["c"] = round(time.perf_counter() - t6f, 1)
    e32 = eager_fp32
    qbusy = qat.get("device_busy_share")
    print(f"6f (c) QAT at BERT-base width ({card}): {qat['quanted_linears']} "
          f"QuantedLinear, B {EAGER_BATCH} S {BERT_SEQ} fp32 AdamW, "
          f"{qat['timed_steps']} timed steps: {qat['ms_per_step']:.3f} ms a "
          f"step against 6c's unquantized fp32 {e32['ms_per_step']:.3f} "
          f"({qat['ms_per_step'] / e32['ms_per_step']:.3f}x), device "
          f"{qat.get('device_ms_per_step', 'not measured')} ms of "
          f"{qat.get('profiled_step_wall_ms', 'not measured')} ms wall (busy "
          f"share {'not measured' if qbusy is None else f'{qbusy:.4f}'}; 6c "
          f"{e32.get('device_busy_share')}), synchronising calls a step "
          f"{qat['syncs_per_step']}, multi_tensor_update launches a step "
          f"{qat['multi_tensor_update_per_step']}, losses "
          f"{', '.join(f'{v:.4f}' for v in qat['losses'])}")
    ic = qat["int8_against_cpu"]
    print(f"6f (c) int8 after QAT.convert ({card}): forward "
          f"{qat['int8_forward_ms']:.3f} ms against the fp32 forward's "
          f"{qat['fp32_forward_ms']:.3f} ms; PTQ (AbsmaxObserver): forward "
          f"{qat['ptq_int8_forward_ms']:.3f} ms, int8 logits against fp32 "
          f"{json.dumps(qat['ptq'])}")
    print(f"6f (c) the converted model against the CPU on {ic['rows']} "
          f"row(s) ({card}): {ic['products']} int8 products; fed the card's "
          f"codes, accumulators equal {ic['accumulators_equal']} and logits "
          f"equal {ic['pinned_logits_equal']}, the CPU's own codes flipped "
          f"{sum(ic['pinned_flips'])} of {sum(ic['codes'])} (largest share "
          f"of a layer {ic['pinned_max_flip_share']:.3e}, largest step "
          f"{ic['pinned_max_code_step']}); on its own codes "
          f"{sum(ic['free_flips'])} flipped (largest share "
          f"{ic['free_max_flip_share']:.3e}, step "
          f"{ic['free_max_code_step']}; by product "
          f"{ic['free_flips']}), logits max |err| "
          f"{ic['logit_max_abs_err']:.3e} of {ic['logit_max_abs']:.3e}, "
          f"top-1 agreement {ic['top1_agreement']:.4f}")
    print(f"launches on the QAT steps and the int8 forward: "
          f"{json.dumps(qatlaunches)}")
    print(f"phase 6f seconds to the end of each part: {json.dumps(fsecs)}")
    return ({"flowers": flowers, "detection": det, "qat": qat,
             "seconds_to_end_of": fsecs}, {**vlaunches, **qatlaunches})



# the driven paths on which each kernel must launch (the launches column of
# PERF.md's table of TPU kernels). Exceptions, launched on no engine or
# training path: the decode kernel's quant mode (no engine caller, in the
# JAX package as here), the bf16 backward's two roles alone (the flash
# experiment launches them; training launches both roles in one grid) and
# the fp32 backward's roles alone (held against plain in phase 2 only)
SERVE_TICK = ("contiguous_drain", "paged_drain", "prefix_burst",
              "long_admit", "cpu_small_contiguous_drain",
              "cpu_small_paged_drain", "quant_int8_drain", "quant_fp8_drain",
              "quant_int8_fused_drain", "paged_fused_drain",
              "quant_int8_trained_drain", "fused_drain",
              "contiguous_prefix_burst", "contiguous_burst_no_cache",
              "generate_beam", "generate_beam_eos", "generate_sampled",
              "preempt_contiguous", "abort_contiguous", "preempt_paged",
              "abort_paged", "family_chunked", "family_unchunked",
              "family_sampled_k0", "family_long_context", "tier_audited",
              "tier_tiered", "tier_untiered", "tier_no_cache",
              "tier_int8_tiered", "tier_int8_no_cache", "slo_serve",
              "slo_monitored", "3j_fleet", "3j_fleet_failover", "3j_disagg",
              "3j_disagg_co_resident", "3k_warmed_serve", "3k_episode")
CONTIGUOUS = ("contiguous_drain", "cpu_small_contiguous_drain",
              "fused_drain", "contiguous_prefix_burst",
              "contiguous_burst_no_cache", "generate_beam",
              "generate_beam_eos", "generate_sampled", "preempt_contiguous",
              "abort_contiguous")
PAGED = ("paged_drain", "prefix_burst", "long_admit", "cpu_small_paged_drain",
         "preempt_paged", "abort_paged", "family_chunked",
         "family_unchunked", "family_spec", "family_spec_memorized",
         "family_spec_repeated", "family_sampled_k0", "family_sampled_k4",
         "family_long_context", "tier_audited", "tier_tiered",
         "tier_untiered", "tier_no_cache", "slo_serve", "slo_monitored",
         "3j_fleet", "3j_fleet_failover", "3j_disagg",
         "3j_disagg_co_resident", "3k_warmed_serve", "3k_episode",
         "paged_fused_drain")
# LLaMA's trainers keep their own AdamW (as the JAX package's), so
# "train" and "train_fused_bf16_grads" are not flat-update paths
FLAT_UPDATE = ("resnet50_train", "resnet50_adamw", "mnist_fit",
               "mnist_fit_scheduled", "eager_fp32", "eager_bf16_auto_cast",
               "zoo_mobilenet_v3_large", "imdb_bilstm_fit",
               "flowers_fit_workers_0", "flowers_fit_workers_4", "bert_qat",
               "6j_world1", "6j_dp4")
KERNEL_PATHS = {
    "ragged_decode_attention": CONTIGUOUS,
    "fused_rms_norm": SERVE_TICK,
    "fused_add_rms_norm": SERVE_TICK,
    "fused_rope_qk": SERVE_TICK,
    "ragged_paged_attention": PAGED,
    "quant_matmul": ("quant_int8_drain", "quant_fp8_drain",
                     "quant_int8_trained_drain", "tier_int8_tiered",
                     "tier_int8_no_cache", "3j_fleet", "3j_fleet_failover",
                     "quant_int8_fused_drain"),
    "flash_attention_fwd": ("train", "bert_train", "ernie_step",
                            "eager_bf16_auto_cast", "flash_experiment",
                            "train_fused_bf16_grads", "6i_world1",
                            "6i_dp2_mp2_zero3", "6i_mp2_sep2_ulysses"),
    "flash_attention_bwd": ("train", "bert_train", "ernie_step",
                            "eager_bf16_auto_cast", "flash_experiment",
                            "train_fused_bf16_grads", "6i_world1",
                            "6i_dp2_mp2_zero3", "6i_mp2_sep2_ulysses"),
    "flash_attention_bwd_dq": ("flash_experiment",),
    "flash_attention_bwd_dkv": ("flash_experiment",),
    "flash_attention_fwd_f32": ("eager_fp32", "bert_qat",
                                "bert_qat_int8_forward"),
    "flash_attention_bwd_f32": ("eager_fp32", "bert_qat"),
    "flash_attention_bwd_dq_f32": (),
    "flash_attention_bwd_dkv_f32": (),
    "head_dx_softmax": ("train", "train_fused_bf16_grads", "6i_world1"),
    "multi_tensor_update": FLAT_UPDATE,
    "blocked_matmul": ("dot_experiment",),
    "flash_variants_fwd": ("flash_experiment",),
    "flash_variants_bwd": ("flash_experiment",),
}


def check_paths(by_path, kernels):
    """The guard on the kernels' line: every path's counts are an object
    of their own (two names bound to one dict would count one run twice
    and lose the other), every kernel of the line has its paths in
    ``KERNEL_PATHS``, and each launched on each of them. Exits non-zero
    otherwise."""
    seen = {}
    for path, counts in by_path.items():
        if id(counts) in seen:
            fail(f"the launch counts of {path!r} are those of "
                 f"{seen[id(counts)]!r} (one object under two paths)")
        seen[id(counts)] = path
    names = {k["name"] for k in kernels}
    if names != set(KERNEL_PATHS):
        fail(f"KERNEL_PATHS names {sorted(set(KERNEL_PATHS))}, the line "
             f"{sorted(names)}")
    missing = [f"{name} on {path}" for name, paths in KERNEL_PATHS.items()
               for path in paths if by_path.get(path, {}).get(name, 0) <= 0]
    if missing:
        fail(f"kernels with no launch on a path that runs them: "
             f"{missing}")


def kernels_line(rows, by_path):
    """The kernels' JSON line: for each kernel its route, source, the
    TPU kernel it replaces, its launches summed over the driven paths
    and its phase-2 row at the shape of the path that runs it."""
    meta = {
        "ragged_decode_attention": (
            "cuda", "paddle_tpu_torch/csrc/decode_attention.cu",
            "paddle_tpu/ops/pallas/decode_attention.py:220", "serving"),
        "fused_rms_norm": (
            "cuda", "paddle_tpu_torch/csrc/rms_norm.cu",
            "paddle_tpu/ops/pallas/tick_fusion.py:88", "serving"),
        "fused_add_rms_norm": (
            "cuda", "paddle_tpu_torch/csrc/rms_norm.cu",
            "paddle_tpu/ops/pallas/tick_fusion.py:111", "serving"),
        "fused_rope_qk": (
            "cuda", "paddle_tpu_torch/csrc/rope.cu",
            "paddle_tpu/ops/pallas/tick_fusion.py:159", "serving"),
        "ragged_paged_attention": (
            "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/pallas/paged_attention.py:194",
            "serving_decode"),
        "flash_attention_fwd": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:647", "bench"),
        "flash_attention_bwd": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:682", "bench"),
        "flash_attention_bwd_dq": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:442", "bench"),
        "flash_attention_bwd_dkv": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:458", "bench"),
        "flash_attention_fwd_f32": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention_f32.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:647", "bert"),
        "flash_attention_bwd_f32": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention_f32.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:682", "bert"),
        "flash_attention_bwd_dq_f32": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention_f32.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:442", "bert"),
        "flash_attention_bwd_dkv_f32": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention_f32.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:458", "bert"),
        "head_dx_softmax": (
            "cuda", "paddle_tpu_torch/csrc/head_dx.cu",
            "paddle_tpu/ops/pallas/head_dx.py:86", "ce_tail"),
        "quant_matmul": (
            "cuda", "paddle_tpu_torch/csrc/quant_matmul.cu",
            "paddle_tpu/ops/pallas/tick_fusion.py:213", "w_gate_w_up"),
        "multi_tensor_update": (
            "cuda", "paddle_tpu_torch/csrc/multi_tensor_update.cu",
            "paddle_tpu/ops/pallas/multi_tensor_update.py:288", "resnet50"),
        "blocked_matmul": (
            "cuda", "paddle_tpu_torch/csrc/blocked_matmul.cu",
            "benchmarks/dot_variants.py:67", "lm_head_dx"),
        "flash_variants_fwd": (
            "cuda", "paddle_tpu_torch/csrc/flash_variants_fwd.cu",
            "benchmarks/flash_variants.py:152", "bench"),
        "flash_variants_bwd": (
            "cuda", "paddle_tpu_torch/csrc/flash_variants_bwd.cu",
            "benchmarks/flash_variants.py:182", "bench"),
    }
    # the rows the line quotes: bf16 for the fp kernels, int8 weights for
    # quant_matmul, the main path's bf16 momentum for multi_tensor_update,
    # the fastest tile of blocked_matmul, the flash variants' baseline
    # (nsplit 1, the whole square)
    line_dtype = {"quant_matmul": "int8",
                  "multi_tensor_update": "momentum_bf16",
                  "blocked_matmul": "bm128_bn256_bk32",
                  "flash_variants_fwd": "run_fwd_nsplit1",
                  "flash_variants_bwd": "run_bwd_nsplit1",
                  "flash_attention_fwd_f32": "float32",
                  "flash_attention_bwd_f32": "float32",
                  "flash_attention_bwd_dq_f32": "float32",
                  "flash_attention_bwd_dkv_f32": "float32"}
    # other TPU kernels the same kernels serve: the blocked flash kernels
    # (S > 512), the flash experiments' fwd2 and ablations
    also = {"flash_attention_fwd": ["paddle_tpu/ops/pallas/flash_attention.py:246"],
            "flash_attention_bwd": ["paddle_tpu/ops/pallas/flash_attention.py:442",
                                    "paddle_tpu/ops/pallas/flash_attention.py:458"],
            "flash_variants_fwd": ["benchmarks/flash_variants.py:352",
                                   "benchmarks/flash_variants.py:465"],
            "flash_variants_bwd": ["benchmarks/flash_variants.py:365"],
            "flash_attention_fwd_f32": [
                "paddle_tpu/ops/pallas/flash_attention.py:246"],
            "flash_attention_bwd_f32": [
                "paddle_tpu/ops/pallas/flash_attention.py:442",
                "paddle_tpu/ops/pallas/flash_attention.py:458"]}
    kernels = []
    for name, (route, source, replaces, at) in meta.items():
        r = next(r for r in rows if r["name"] == name and r["shape"] == at
                 and r["dtype"] == line_dtype.get(name, "bfloat16"))
        k = {"name": name, "route": route, "source": source,
             "replaces": replaces,
             "launches": sum(c[name] for c in by_path.values()),
             "launches_by_path": {p: c[name] for p, c in by_path.items()},
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "eager_ms": r["eager_ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"]}
        if "gather_sdpa_ms" in r:
            k["gather_sdpa_ms_two_calls"] = r["gather_sdpa_ms"]
        if "gemm_only_ms" in r:
            k["gemm_only_ms"] = r["gemm_only_ms"]
        if name in also:
            k["also_replaces"] = also[name]
        if name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            # one role of the backward kernel, launched alone; training
            # launches both roles in one grid (flash_attention_bwd)
            k["role_of"] = "flash_attention_bwd"
        if name in ("flash_attention_bwd_dq_f32",
                    "flash_attention_bwd_dkv_f32"):
            k["role_of"] = "flash_attention_bwd_f32"
        if name.endswith("_f32"):
            # the fp32 instance: every shape phase 2 times, and its bound's
            # peak (3xTF32 on the tensor cores; the CUDA-core bound beside)
            k["bound_peak"] = r["bound_peak"]
            k["shapes"] = {
                v["shape"]: {key: v[key] for key in (
                    "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
                    "bound_by", "bound_share", "cuda_core_bound_ms",
                    "cuda_core_bound_share", "library_ms")}
                for v in rows if v["name"] == name}
        if name in line_dtype:
            k["shape"], k["mode"] = at, line_dtype[name]
        if name in ("multi_tensor_update", "blocked_matmul",
                    "flash_variants_fwd", "flash_variants_bwd"):
            # every variant held against its plain version in phase 2
            k["variants"] = {
                (v["dtype"] if v["shape"] in ("resnet50", "lenet")
                 else f"{v['shape']}:{v['dtype']}"): {key: v[key] for key in (
                    "shape", "max_abs_err", "ms", "eager_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms", "library")}
                for v in rows if v["name"] == name}
        if name in ("ragged_paged_attention", "quant_matmul"):
            # every shape phase 2 times: the paged kernel's decode ticks and
            # admit prefills (bf16), quant_matmul's projections (int8)
            k["shapes"] = {
                v["shape"]: {key: v.get(key) for key in (
                    "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "gather_sdpa_ms")
                    if key in v}
                for v in rows if v["name"] == name
                and v["dtype"] == line_dtype.get(name, "bfloat16")}
        if name in ("flash_attention_fwd", "flash_attention_bwd"):
            # every bf16 shape phase 2 times: BERT's non-causal one too
            k["shapes"] = {
                v["shape"]: {key: v[key] for key in (
                    "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}
                for v in rows if v["name"] == name
                and v["dtype"] == "bfloat16"}
        if name == "ragged_decode_attention":
            # the same kernel's quant mode (int8 pages with row scales, the
            # TPU kernel's k_scale / v_scale): no engine path calls it, in
            # the JAX package as here, so it is held by phase 2 alone
            q = next(r for r in rows if r["name"] == name + "_quant"
                     and r["shape"] == "serving" and r["dtype"] == "int8")
            k["quant_mode"] = {
                "launches": sum(c[name + "_quant"] for c in by_path.values()),
                "shape": "serving", "mode": "int8",
                **{key: q[key] for key in (
                    "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}}
        kernels.append(k)
    return kernels


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card")
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    import paddle_tpu_torch as port
    import paddle_tpu_torch.amp
    import paddle_tpu_torch.jit
    import paddle_tpu_torch.nn
    import paddle_tpu_torch.optimizer
    import paddle_tpu_torch.vision.models  # noqa: F401 (port.<module>)
    from paddle_tpu_torch import device as device_mod
    from paddle_tpu_torch.analysis import memory, recompile
    from paddle_tpu_torch.inference import (autoscaler, disagg, fleet,
                                            kv_tiers)
    from paddle_tpu_torch.inference.paged_kv import PagedKVCache
    from paddle_tpu_torch.inference import scheduler as sched
    from paddle_tpu_torch.inference.prefix_cache import (PagedPrefixCache,
                                                         PrefixCache)
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models import bert, llama
    from paddle_tpu_torch.observability import journal
    from paddle_tpu_torch.observability.capacity import CapacityMonitor
    from paddle_tpu_torch.observability.quality import compare_pair
    from paddle_tpu_torch.experiments import dot_variants as xdot
    from paddle_tpu_torch.experiments import flash_variants as xfv
    from paddle_tpu_torch.ops.kernels import _build, launch_counters
    from paddle_tpu_torch.ops.kernels import blocked_matmul as bm
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_variants as fv
    from paddle_tpu_torch.ops.kernels import head_dx as hd
    from paddle_tpu_torch.ops.kernels import multi_tensor_update as mtu
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    from paddle_tpu_torch.ops.kernels import tick_fusion as tf
    from paddle_tpu_torch.quantization import serving as qs
    from paddle_tpu_torch.experiments import op_corpus, parity, vision_quant
    from paddle_tpu_torch.experiments import fleet_dp, mesh_train
    from paddle_tpu_torch.experiments import runtime_llama_opts as rlo
    from paddle_tpu_torch.text import recipes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    # each phase's seconds, from its mark to the next one's
    laps, last = {}, [None, t_start]

    def lap(name):
        now = time.perf_counter()
        if last[0] is not None:
            laps[last[0]] = round(now - last[1], 1)
        last[:] = [name, now]
    card = smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    lap("1")
    # 1. build
    t0 = time.perf_counter()
    builds = _build.build_all()
    for b in builds:
        print(f"built {b['name']} in {b['seconds']:.2f} s")
        for line in str(b["log"]).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.2f} s")
    logs = {b["name"]: b["log"] for b in builds}
    flash_build = flash_build_report(fa, _build, logs)
    flash_build += flash_f32_build_report(torch, fa, _build, logs)
    rebuilt_build = rebuilt_build_report(torch, bm, da, pa, qm, hd, _build,
                                         logs)

    lap("2")
    # 2. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for r in kernel_checks(torch, F, da, tf, shape, dtype, gen):
                rows.append(r)
                lib = ("null" if r["library_ms"] is None
                       else f"{r['library_ms']:.6g}")
                print(f"kernel {r['name']:24s} {r['shape']:8s} "
                      f"{r['dtype']:9s} max_abs_err {r['max_abs_err']:.3e} "
                      f"ms {r['ms']:.6g} eager_ms {r['eager_ms']:.6g} "
                      f"plain_ms {r['plain_ms']:.6g} library_ms {lib} "
                      f"bound_ms {r['bound_ms']:.6g} ({r['bound_by']})")
    r = launch_floor(torch, tf)
    rows.append(r)
    print(f"launch floor (an empty kernel through the norms' ctypes path) "
          f"ms {r['ms']:.6g} (without programmatic dependent launch "
          f"{r['ms_without_pdl']:.6g}) eager_ms {r['eager_ms']:.6g}")
    for shape in PAGED_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            r = paged_checks(torch, F, pa, shape, dtype, gen)
            rows.append(r)
            print(f"kernel {r['name']:24s} {r['shape']:22s} "
                  f"{r['dtype']:9s} max_abs_err {r['max_abs_err']:.3e} "
                  f"ms {r['ms']:.6g} eager_ms {r['eager_ms']:.6g} "
                  f"plain_ms {r['plain_ms']:.6g} gather+sdpa_ms (two calls) "
                  f"{r['gather_sdpa_ms']:.6g} (err "
                  f"{r['gather_sdpa_max_abs_err']:.3e}) bound_ms "
                  f"{r['bound_ms']:.6g} ({r['bound_by']}) pages_read "
                  f"{r['pages_read']}")
    for shape in FLASH_SHAPES:
        for r in flash_checks(torch, F, fa, shape, gen):
            rows.append(r)
            print(f"kernel {r['name']:24s} {r['shape']:10s} bfloat16  "
                  f"max_abs_err {r['max_abs_err']:.3e} ms {r['ms']:.6g} "
                  f"eager_ms {r['eager_ms']:.6g} plain_ms "
                  f"{r['plain_ms']:.6g} library_ms {r['library_ms']:.6g} "
                  f"({r['library']}) bound_ms {r['bound_ms']:.6g} "
                  f"({r['bound_by']})")
    for shape in FLASH_F32_SHAPES:
        for r in flash_f32_checks(torch, F, fa, shape, gen):
            rows.append(r)
            print(f"kernel {r['name']:28s} {r['shape']:11s} float32   "
                  f"max_abs_err {r['max_abs_err']:.3e} ms {r['ms']:.6g} "
                  f"eager_ms {r['eager_ms']:.6g} plain_ms "
                  f"{r['plain_ms']:.6g} library_ms {r['library_ms']:.6g} "
                  f"({r['library']}) bound_ms {r['bound_ms']:.6g} "
                  f"({r['bound_by']}, {r['bound_peak']}; share "
                  f"{r['bound_share']:.4f}) fp32 CUDA-core bound_ms "
                  f"{r['cuda_core_bound_ms']:.6g} (share "
                  f"{r['cuda_core_bound_share']:.4f})")
    r = head_dx_checks(torch, hd, gen)
    rows.append(r)
    print(f"kernel {r['name']:24s} {r['shape']:10s} bfloat16  max_abs_err "
          f"{r['max_abs_err']:.3e} (atol {r['atol']:.3e} = 2^-7 of max "
          f"|out| {r['out_abs_max']:.3e}, rtol {r['rtol']}; relative "
          f"Frobenius error {r['fro_rel_err']:.3e} <= {r['fro_rtol']}) ms "
          f"{r['ms']:.6g} eager_ms "
          f"{r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} library_ms "
          f"null (none; its GEMM alone: {r['gemm_only_ms']:.6g}) bound_ms "
          f"{r['bound_ms']:.6g} ({r['bound_by']})")
    for mode in ("int8", "fp8"):
        for shape in QMM_SHAPES:
            r = quant_matmul_checks(torch, qm, qs, mode, shape, gen)
            rows.append(r)
            print(f"kernel {r['name']:24s} {r['shape']:14s} {mode:4s} B "
                  f"{r['B']} K {r['K']} N {r['N']} max_abs_err "
                  f"{r['max_abs_err']:.3e} ms {r['ms']:.6g} eager_ms "
                  f"{r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} "
                  f"library_ms (dequantize + mm) {r['library_ms']:.6g} "
                  f"(err {r['library_max_abs_err']:.3e}) bound_ms "
                  f"{r['bound_ms']:.6g} ({r['bound_by']})")
        for shape in DECODE_QUANT_SHAPES:
            r = decode_quant_checks(torch, F, da, qs, mode, shape, gen)
            rows.append(r)
            print(f"kernel {r['name']:30s} {r['shape']:8s} {mode:4s} "
                  f"max_abs_err {r['max_abs_err']:.3e} ms {r['ms']:.6g} "
                  f"eager_ms {r['eager_ms']:.6g} plain_ms "
                  f"{r['plain_ms']:.6g} library_ms (dequantize + sdpa) "
                  f"{r['library_ms']:.6g} (err "
                  f"{r['library_max_abs_err']:.3e}) bound_ms "
                  f"{r['bound_ms']:.6g} ({r['bound_by']})")
    models = port.vision.models
    mtu_shapes = param_shapes(device_mod, lambda: models.resnet50(
        num_classes=1000, data_format="NHWC"))
    for variant in MTU_VARIANTS:
        r = multi_tensor_checks(torch, mtu, mtu_shapes, variant, gen)
        rows.append(r)
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.6g}")
        print(f"kernel {r['name']:24s} {r['shape']:8s} {r['dtype']:18s} "
              f"{r['elements']} elements ({r['padded_elements']} padded) "
              f"{r['bytes_per_element']:.0f} B "
              f"each max_abs_err {r['max_abs_err']:.3e} ms {r['ms']:.6g} "
              f"eager_ms {r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} "
              f"library_ms {lib} ({r['library']}) bound_ms "
              f"{r['bound_ms']:.6g} ({r['bound_by']})")
    for build, variant, shape_name in (
            (models.LeNet, LENET_VARIANT, "lenet"),
            (lambda: models.mobilenet_v3_large(num_classes=ZOO_CLASSES),
             MTU_VARIANTS[0], "mobilenet_v3_large"),
            (recipes.SentimentBiLSTM, BILSTM_VARIANT, "bilstm")):
        r = multi_tensor_checks(torch, mtu, param_shapes(device_mod, build),
                                variant, gen, shape_name=shape_name)
        rows.append(r)
        print(f"kernel {r['name']:24s} {r['shape']:8s} {r['dtype']:18s} "
              f"{r['elements']} elements ({r['padded_elements']} padded) "
              f"{r['bytes_per_element']:.0f} B each "
              f"max_abs_err {r['max_abs_err']:.3e} ms {r['ms']:.6g} eager_ms "
              f"{r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} library_ms "
              f"{r['library_ms']:.6g} ({r['library']}) bound_ms "
              f"{r['bound_ms']:.6g} ({r['bound_by']})")
    mtu_skip = multi_tensor_skip_check(torch, mtu, mtu_shapes, gen)
    print(f"multi_tensor_update skip = 1 left every buffer bit-identical: "
          f"{json.dumps(mtu_skip)}")
    for r in blocked_matmul_checks(torch, bm, gen):
        rows.append(r)
        print(f"kernel {r['name']:24s} {r['shape']:10s} {r['dtype']:18s} "
              f"max_abs_err {r['max_abs_err']:.3e} (torch.mm "
              f"{r['mm_max_abs_err']:.3e}) ms {r['ms']:.6g} eager_ms "
              f"{r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} library_ms "
              f"{r['library_ms']:.6g} (torch.mm) bound_ms "
              f"{r['bound_ms']:.6g} ({r['bound_by']})")
    variant_errs = variant_matrix(torch, fv, gen)
    print(f"flash variants, every instance at B 4 against its plain "
          f"version, largest errors: {json.dumps(variant_errs)}")
    for r in variant_rows(torch, F, fv, gen):
        rows.append(r)
        print(f"kernel {r['name']:24s} {r['shape']:6s} {r['dtype']:26s} "
              f"max_abs_err {r['max_abs_err']:.3e} ms {r['ms']:.6g} "
              f"eager_ms {r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} "
              f"library_ms {r['library_ms']:.6g} ({r['library']}) bound_ms "
              f"{r['bound_ms']:.6g} ({r['bound_by']})")
    print(f"kernel checks passed ({card})")

    lap("3")
    # 3. the engine at bert_base_equiv width
    cfg = llama.LlamaConfig.bert_base_equiv()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    reqs = mixed_workload(np.random.RandomState(0), 32, cfg.vocab_size)
    need = max(len(p) + g - 1 for p, g in reqs)
    max_len = min(cfg.max_seq_len, -(-need // 128) * 128)
    fns = launch_counters()
    stats, launches, toks_c = serve(torch, ServingEngine, fns, params, cfg,
                                    reqs, max_len)
    print(f"engine ({card}): bert_base_equiv bf16 slots 8 chunk 16 "
          f"max_len {max_len}: {stats['requests']} requests, "
          f"{stats['new_tokens']} tokens in {stats['wall_s']:.3f} s = "
          f"{stats['tokens_per_s']:.1f} tokens/s, {stats['ticks']} ticks, "
          f"{stats['chunks']} chunks, {stats['ms_per_tick']:.3f} ms/tick")
    print(f"launches on the contiguous drain: {json.dumps(launches)}")
    tick = tick_breakdown(torch, llama, params, cfg, max_len, rows)
    print(f"decode tick ({card}): {json.dumps(tick)}")

    lap("3b")
    # 3b. the paged engine, same requests
    pstats, plaunches, toks_p = serve_paged(torch, ServingEngine, fns,
                                            params, cfg, reqs, max_len)
    same = sum(a == b for a, b in zip(toks_c, toks_p))
    pos_same = sum(x == y for a, b in zip(toks_c, toks_p)
                   for x, y in zip(a, b))
    pstats["requests_identical_to_contiguous"] = same
    pstats["tokens_identical_to_contiguous"] = pos_same / sum(
        len(a) for a in toks_c)
    # two bf16 engines whose kernels round differently: how near-tied the
    # random weights' greedy choices are (the baseline for phase 3d's rate)
    pstats["against_contiguous"] = score_pairs(
        compare_pair, [(t, None) for t in toks_p],
        [(t, None) for t in toks_c])
    print(f"paged engine ({card}): bert_base_equiv bf16 slots 8 page 16 "
          f"max_len {max_len}: {pstats['new_tokens']} tokens in "
          f"{pstats['wall_s']:.3f} s = {pstats['tokens_per_s']:.1f} "
          f"tokens/s, {pstats['steps']} steps ({pstats['admits']} admits), "
          f"{pstats['segments']} segments, {pstats['fetches']} fetches "
          f"({pstats['sync_free_dispatches']} more segments issued with no "
          f"sync), "
          f"{pstats['ms_per_step']:.3f} ms/step; greedy agreement with the "
          f"contiguous engine: {same}/{len(reqs)} requests, "
          f"{pstats['tokens_identical_to_contiguous']:.4f} of tokens, "
          f"matched-prefix rate "
          f"{pstats['against_contiguous']['matched_prefix_rate']:.4f}")
    print(f"launches on the paged drain: {json.dumps(plaunches)}")
    psteps = paged_step_breakdown(torch, llama, params, cfg, max_len)
    print(f"paged steps ({card}): {json.dumps(psteps)}")

    lap("3c")
    # 3c. the shared-prefix burst through the online scheduler
    burst, blaunches = prefix_burst(
        torch, sched, ServingEngine, fns, params, cfg, True,
        lambda eng: PagedPrefixCache(eng.pager, capacity_pages=512))
    print(f"prefix burst ({card}): {burst['total_tokens']} tokens, "
          f"{burst['throughput_tok_s']:.1f} tokens/s, ttft p50/p99 "
          f"{burst['ttft_p50_s']:.4f}/{burst['ttft_p99_s']:.4f} s, e2e "
          f"p50/p99 {burst['e2e_p50_s']:.4f}/{burst['e2e_p99_s']:.4f} s, "
          f"{burst['requests_admitted_on_a_hit']}/{burst['n_requests']} "
          f"requests admitted on a prefix hit ({burst['prefix']['hits']} "
          f"matches at picking, {burst['prefix']['hit_tokens']} hit tokens), "
          f"{burst['segments']} segments, {burst['ticks']} steps "
          f"({burst['decode_steps']} decode)")
    print(f"launches on the prefix burst: {json.dumps(blaunches)}")

    lap("3d")
    # 3d. quantized serving, scored against a bf16 shadow
    quant, qlaunches, f8launches = quant_serve(
        torch, ServingEngine, compare_pair, fns, params, cfg, reqs, max_len)
    quant["int8_steps"] = paged_step_breakdown(
        torch, llama, qs.quantize_llama_params(params, cfg, "int8"), cfg,
        max_len, quant="int8")
    q8, sh, f8 = quant["int8"], quant["bf16_shadow"], quant["fp8"]
    qual = quant["int8_against_bf16"]
    print(f"quantized engine ({card}): bert_base_equiv int8 weights and "
          f"pages, digests, slots 8 page 16 max_len {max_len}: "
          f"{q8['new_tokens']} tokens in {q8['wall_s']:.3f} s = "
          f"{q8['tokens_per_s']:.1f} tokens/s, {q8['steps']} steps, "
          f"{q8['ms_per_step']:.3f} ms/step, {q8['segments']} segments, "
          f"{q8['fetches']} fetches ({q8['sync_free_dispatches']} more "
          f"segments issued with no sync); bf16 shadow with digests "
          f"{sh['tokens_per_s']:.1f} tokens/s, {sh['ms_per_step']:.3f} "
          f"ms/step; fp8 (8 requests) {f8['tokens_per_s']:.1f} tokens/s")
    print(f"int8 against its bf16 shadow, random weights ({card}): "
          f"matched-prefix rate {qual['matched_prefix_rate']:.4f} (the bar "
          f"is held on a memorized model, phase 3e), "
          f"{qual['requests_identical']}/{len(reqs)} requests identical, "
          f"logit max abs err {qual['logit_max_abs_err']} over "
          f"{qual['logit_positions']} positions, KL mean {qual['kl_mean']} "
          f"max {qual['kl_max']} over {qual['kl_positions']}; fp8 (8 "
          f"requests): {json.dumps(f8['quality_against_bf16'])}")
    print(f"int8 paged steps ({card}): {json.dumps(quant['int8_steps'])}")
    print(f"launches on the int8 drain: {json.dumps(qlaunches)}")
    print(f"launches on the fp8 drain: {json.dumps(f8launches)}")

    lap("3f")
    # 3f. a long admit at max_len 2048, then cpu_small (D 16) end to end
    longa, llaunches = long_admit(torch, llama, pa, tf, ServingEngine, fns,
                                  params, cfg)
    print(f"long admit ({card}): bert_base_equiv bf16 paged max_len "
          f"{LONG_MAX_LEN}: a {longa['prompt_tokens']}-token prompt admitted "
          f"at bucket {longa['bucket']} and {longa['new_tokens']} tokens in "
          f"{longa['wall_s']:.3f} s ({longa['steps']} steps); teacher-forced "
          f"logits within {longa['max_abs_logit_err']:.4f} of the plain path "
          f"(<= {LOGIT_ATOL}) over {longa['teacher_forced_positions']} "
          f"positions")
    print(f"launches on the long admit: {json.dumps(llaunches)}")
    small, slaunches, splaunches = cpu_small_serve(
        torch, llama, da, pa, tf, ServingEngine, fns)
    print(f"cpu_small ({card}): fp32 8 heads of D 16: contiguous "
          f"{small['contiguous']['new_tokens']} tokens at "
          f"{small['contiguous']['tokens_per_s']:.1f} tokens/s, paged "
          f"{small['paged']['tokens_per_s']:.1f} tokens/s, "
          f"{small['requests_identical']}/32 requests identical; "
          f"teacher-forced logits within "
          f"{small['teacher_forced']['max_abs_logit_err']:.3e} (contiguous) "
          f"and {small['teacher_forced_paged']['max_abs_logit_err']:.3e} "
          f"(paged) of the plain path (<= {LOGIT_ATOL})")
    print(f"launches on the cpu_small drains: {json.dumps(slaunches)} / "
          f"{json.dumps(splaunches)}")

    lap("3g")
    # 3g. the contiguous engine's fused drain, its segments under the
    # online scheduler with a row-copy prefix cache, generation, and
    # preemption and abort on both engines
    fstats, flaunches_3g, toks_f = serve(torch, ServingEngine, fns, params,
                                         cfg, reqs, max_len, fused=True)
    fstats["requests_identical_to_windowed"] = sum(
        a == b for a, b in zip(toks_f, toks_c))
    print(f"fused drain ({card}): bert_base_equiv bf16 slots 8 max_len "
          f"{max_len}: {fstats['new_tokens']} tokens in "
          f"{fstats['wall_s']:.3f} s = {fstats['tokens_per_s']:.1f} "
          f"tokens/s, {fstats['steps']} steps ({fstats['ticks']} ticks, "
          f"{len(reqs)} admits), {fstats['ms_per_step']:.3f} ms/step, "
          f"{fstats['fetches']} fetch; windowed (phase 3) "
          f"{stats['tokens_per_s']:.1f} tokens/s, {stats['fetches']} "
          f"fetches; requests identical to the windowed drain's: "
          f"{fstats['requests_identical_to_windowed']}/{len(reqs)}")
    print(f"launches on the fused drain: {json.dumps(flaunches_3g)}")
    cbursts, cblaunches = {}, {}
    for key, make in (("prefix_cache", lambda eng: PrefixCache(block=32)),
                      ("no_cache", lambda eng: None)):
        cbursts[key], cblaunches[key] = prefix_burst(
            torch, sched, ServingEngine, fns, params, cfg, False, make)
    cb = cbursts["prefix_cache"]
    print(f"contiguous prefix burst ({card}): PrefixCache(block=32) "
          f"{cb['throughput_tok_s']:.1f} tokens/s, ttft p50/p99 "
          f"{cb['ttft_p50_s']:.4f}/{cb['ttft_p99_s']:.4f} s, e2e p50/p99 "
          f"{cb['e2e_p50_s']:.4f}/{cb['e2e_p99_s']:.4f} s, "
          f"{cb['requests_admitted_on_a_hit']}/{cb['n_requests']} requests "
          f"admitted on a prefix hit ({cb['prefix']['hits']} matches, "
          f"{cb['prefix']['hit_tokens']} hit tokens), {cb['ticks']} steps; "
          f"without a cache: "
          f"{cbursts['no_cache']['throughput_tok_s']:.1f} tokens/s, ttft "
          f"p50/p99 {cbursts['no_cache']['ttft_p50_s']:.4f}/"
          f"{cbursts['no_cache']['ttft_p99_s']:.4f} s, e2e p50/p99 "
          f"{cbursts['no_cache']['e2e_p50_s']:.4f}/"
          f"{cbursts['no_cache']['e2e_p99_s']:.4f} s, "
          f"{cbursts['no_cache']['ticks']} steps")
    print(f"launches on the contiguous prefix bursts: "
          f"{json.dumps(cblaunches)}")
    gen_stats, glaunches = generation(torch, llama, fns, params, cfg)
    print(f"generation ({card}): beam search (B 2, prompt 64, 32 tokens, 4 "
          f"beams) {gen_stats['beam']['ms_per_token']:.3f} ms/token, with "
          f"EOS {gen_stats['beam_eos']['eos_token_id']} "
          f"{gen_stats['beam_eos']['ms_per_token']:.3f}; sampled (T 0.8, "
          f"top-k 50, top-p 0.9) {gen_stats['sampled']['ms_per_token']:.3f} "
          f"ms/token, its seed replayed; top_k=1 against greedy: "
          f"{json.dumps(gen_stats['top_k_1'])}")
    print(f"launches on generation: {json.dumps(glaunches)}")
    preempt, plaunches3g = {}, {}
    for paged in (False, True):
        st, n = preempt_and_abort(torch, ServingEngine, PrefixCache,
                                  PagedPrefixCache, fns, params, cfg, reqs,
                                  max_len, paged)
        preempt["paged" if paged else "contiguous"] = st
        plaunches3g.update(n)
        print(f"preemption ({card}, {'paged' if paged else 'contiguous'}):"
              f" {json.dumps(st)}")
    print(f"launches on preemption and abort: {json.dumps(plaunches3g)}")

    lap("4")
    # 4. teacher-forced ticks, contiguous cache and paged pool
    tfc = teacher_forced(torch, llama, da, tf, params, cfg, reqs, max_len,
                         ticks=16)
    print(f"teacher-forced ({card}): {json.dumps(tfc)}")
    tfp = teacher_forced_paged(torch, llama, pa, tf, params, cfg, reqs,
                               max_len, ticks=16)
    print(f"teacher-forced paged ({card}): {json.dumps(tfp)}")
    tfq = teacher_forced_quant(torch, llama, qm, qs, tf, params, cfg, reqs,
                               max_len, ticks=16)
    print(f"teacher-forced quantized paged ({card}): {json.dumps(tfq)}")

    lap("5")
    # 5. training at bert_base_equiv width, fp32 master weights
    del params
    tcfg = llama.LlamaConfig.bert_base_equiv()
    tparams = llama.init_params(
        tcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
        dtype=torch.float32)
    # phase 6h (b) starts its fused steps from these weights
    params5 = {k: v.detach().cpu().clone() for k, v in tparams.items()}
    rng = np.random.RandomState(0)
    tok8 = torch.from_numpy(rng.randint(0, tcfg.vocab_size, (8, 512))
                            .astype(np.int32)).to(DEVICE)
    tvp = train_vs_plain(torch, llama, fa, hd, tparams, tcfg, tok8)
    print(f"train, kernels against plain ({card}): B 8 S 512 loss "
          f"{tvp['loss_kernels']:.6f} / {tvp['loss_plain']:.6f} (|err| "
          f"{tvp['loss_abs_err']:.3e} <= {TRAIN_LOSS_ATOL}), largest "
          f"gradient error {max(tvp['grad_rel_err'].values()):.3e} of its "
          f"norm (<= {TRAIN_GRAD_RTOL}): {json.dumps(tvp['grad_rel_err'])}")
    tok44 = torch.from_numpy(rng.randint(0, tcfg.vocab_size, (44, 512))
                             .astype(np.int32)).to(DEVICE)
    train, tlaunches = train_run(torch, llama, fns, tparams, tcfg, tok44)
    busy = train.get("device_busy_share")
    print(f"train ({card}): bert_base_equiv bf16/fp32 master, B 44 S 512, "
          f"{train['timed_steps']} timed AdamW steps: "
          f"{train['tokens_per_s']:.1f} tokens/s, "
          f"{train['ms_per_step']:.3f} ms/step (CUDA events "
          f"{train['event_ms_per_step']:.3f}), device "
          f"{train['device_ms_per_step']} ms in one profiled step of "
          f"{train.get('profiled_step_wall_ms', 'not measured')} ms wall "
          f"(busy share "
          f"{'not measured' if busy is None else f'{busy:.4f}'}), peak "
          f"memory {train['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
          f"{', '.join(f'{x:.4f}' for x in train['losses'])}, after "
          f"{train['loss_after']:.4f}")
    print(f"launches on the train steps: {json.dumps(tlaunches)}")
    print(f"train device time (ms/step) by kind: "
          f"{json.dumps(train.get('device_split_ms'))}; largest kernels: "
          f"{json.dumps(train.get('device_top'))}")

    lap("3e")
    # 3e. the quality bar of quantized serving, on a memorized model served
    # continuations of its training sequences (the mixed workload's
    # prompt and generation lengths)
    memo = memorize(torch, llama, tparams, tcfg, tok44)
    sparams = {k: v.detach().to(torch.bfloat16) for k, v in tparams.items()}
    seqs = tok44.cpu().numpy()
    mreqs = [(seqs[i, :len(p)].copy(), g) for i, (p, g) in enumerate(reqs)]
    del tparams, tok8
    qtrained, qtlaunches = quant_trained(
        torch, ServingEngine, compare_pair, fns, sparams, cfg, mreqs,
        max_len)
    # how far each serve follows the memorized sequence
    for key, outs in zip(("int8", "bf16_shadow"), qtrained.pop("outputs")):
        hit = sum(t == int(seqs[i, len(p) + j])
                  for i, ((p, _), (toks, _)) in enumerate(zip(mreqs, outs))
                  for j, t in enumerate(toks))
        qtrained[key]["memorized_token_rate"] = hit / sum(
            g for _, g in mreqs)
    qtrained["memorize_losses"] = memo
    qual = qtrained["int8_against_bf16"]
    print(f"memorized ({card}): {len(memo)} more AdamW steps on phase 5's "
          f"batch, loss {memo[0]:.4f} -> {memo[-1]:.4f}; tokens following "
          f"the training sequences: int8 "
          f"{qtrained['int8']['memorized_token_rate']:.4f}, bf16 "
          f"{qtrained['bf16_shadow']['memorized_token_rate']:.4f}")
    print(f"int8 against its bf16 shadow, memorized model ({card}): "
          f"matched-prefix rate {qual['matched_prefix_rate']:.4f} (>= "
          f"{MATCHED_PREFIX_FLOOR}), {qual['requests_identical']}/"
          f"{len(reqs)} requests identical, logit max abs err "
          f"{qual['logit_max_abs_err']} over {qual['logit_positions']} "
          f"positions, KL mean {qual['kl_mean']} max {qual['kl_max']} over "
          f"{qual['kl_positions']}; int8 "
          f"{qtrained['int8']['tokens_per_s']:.1f} tokens/s, bf16 "
          f"{qtrained['bf16_shadow']['tokens_per_s']:.1f} tokens/s")
    print(f"launches on the trained int8 drain: {json.dumps(qtlaunches)}")

    lap("3h")
    # 3h. the paged engine's chunked-prefill, speculative/sampled and
    # sequence-parallel segments, bert_base_equiv width in bf16: phase 3's
    # random weights again, and the memorized model
    fparams = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    family, hlaunches, hsecs = {}, {}, {}
    t3h = time.perf_counter()
    family["chunked"], n, plain_toks = chunked_phase(
        torch, sched, ServingEngine, fns, fparams, cfg, reqs)
    hlaunches.update(n)
    hsecs["a"] = round(time.perf_counter() - t3h, 1)
    for key in ("chunked", "unchunked"):
        st = family["chunked"][key]
        print(f"3h (a) {key} ({card}): 32 mixed requests through "
              f"OnlineScheduler: {st['tokens_per_s']:.1f} tokens/s, ttft "
              f"p50/p99 {st['ttft_p50_s']:.4f}/{st['ttft_p99_s']:.4f} s, "
              f"e2e p50/p99 {st['e2e_p50_s']:.4f}/{st['e2e_p99_s']:.4f} s, "
              f"{st['steps']} steps ({st['admits']} admits, "
              f"{st['chunk_steps']} more chunk steps, {st['ticks']} "
              f"ticks), {st['ms_per_step']:.3f} ms/step wall, "
              f"{st['device_ms_per_step']} ms/step device, busy "
              f"{st['busy_share']}, {st['segments']} segments, "
              f"{st['fetches']} fetches")
    print(f"3h (a) chunked against unchunked: "
          f"{json.dumps(family['chunked']['chunked_against_unchunked'])}; "
          f"{family['chunked']['chunked']['sync_free_dispatches']} chunked "
          f"segments issued with no sync")
    family["spec"], n = spec_phase(
        torch, sched, llama, ServingEngine, fns, fparams, cfg, reqs,
        (plain_toks, family["chunked"]["unchunked"]), sparams, mreqs, seqs)
    hlaunches.update(n)
    hsecs["b"] = round(time.perf_counter() - t3h, 1)
    for key in ("random", "memorized", "repeated"):
        st = family["spec"][key]
        print(f"3h (b) speculative K={SPEC_K} greedy, {key} weights "
              f"({card}): {st['tokens_per_s']:.1f} tokens/s, acceptance "
              f"{st['acceptance']:.4f} ({st['accepted']}/{st['proposed']} "
              f"drafts), {st['ticks']} verify ticks against the plain "
              f"serve's {st['plain_ticks']}, spec_accept_ewma "
              f"{st['spec_accept_ewma']:.4f}, {st['fetches']} fetches for "
              f"{st['segments']} segments, {st['ms_per_step']:.3f} ms/step "
              f"wall, {st.get('device_ms_per_step')} ms/step device, busy "
              f"{st.get('busy_share')}, ttft p50/p99 {st['ttft_p50_s']:.4f}"
              f"/{st['ttft_p99_s']:.4f} s")
    mem, rep = family["spec"]["memorized"], family["spec"]["repeated"]
    rnd = family["spec"]["random"]
    print(f"3h (b) random weights against the plain serve: "
          f"{json.dumps(rnd['against_plain'])}, parted at near ties "
          f"{json.dumps(rnd['parted_at_near_ties'])}; "
          f"memorized: {mem['identical']}/{SPEC_MEMORIZED} identical, "
          f"tokens following "
          f"the training sequence {mem['sequence_token_rate']:.4f}, plain "
          f"{mem['plain_tokens_per_s']:.1f} tokens/s; repeated stretch: "
          f"{rep['identical']}/{SPEC_REPEATED} identical, parted at near "
          f"ties "
          f"{json.dumps(rep['parted_at_near_ties'])}, tokens retracing the "
          f"sequence {rep['sequence_token_rate']:.4f}")
    family["sampled"], n = sampled_phase(torch, sched, llama, ServingEngine,
                                         fns, fparams, cfg, reqs)
    hlaunches.update(n)
    hsecs["c"] = round(time.perf_counter() - t3h, 1)
    for key, st in family["sampled"].items():
        print(f"3h (c) sampled T 0.8 top-k 32, {key} ({card}): "
              f"{st['tokens_per_s']:.1f} tokens/s, {st['ms_per_token']:.3f}"
              f" ms/token, {st['ms_per_step']:.3f} ms/step wall, "
              f"{st.get('device_ms_per_step', 'not measured')} ms/step "
              f"device, busy {st.get('busy_share', 'not measured')}, "
              f"{st['fetches']} fetches for "
              f"{st['segments']} segments; seeds replayed; top_k=1 against "
              f"greedy: {json.dumps(st['top_k_1'])}")
    family["long_context"], n = long_context_phase(
        torch, ServingEngine, fns, fparams, cfg, reqs)
    hlaunches["family_long_context"] = n
    hsecs["d"] = round(time.perf_counter() - t3h, 1)
    st = family["long_context"]
    print(f"3h (d) long context sp={SP} ({card}): a {SP_PROMPT}-token "
          f"prompt and 7 mixed requests in segments of {SP_SEG_STEPS}: "
          f"the prefill spanned {st['segments_carried_over']} segment "
          f"boundaries, ttft of the long prompt {st['ttft_long_s']:.4f} s "
          f"(unsharded chunked engine {st['reference']['ttft_long_s']:.4f}"
          f" s), {st['tokens_per_s']:.1f} tokens/s, {st['steps']} steps "
          f"({st['chunk_steps']} more chunk steps), {st['ms_per_step']:.3f}"
          f" ms/step wall, {st['device_ms_per_step']} device, busy "
          f"{st['busy_share']}, {st['fetches']} fetches for "
          f"{st['segments']} segments; against the unsharded engine "
          f"{json.dumps(st['against_unsharded'])}")
    family["kernel_errors"] = family_kernel_checks(torch, pa, gen)
    print(f"3h (e) ragged_paged_attention against its plain version at "
          f"the phase's shapes: {json.dumps(family['kernel_errors'])}")
    hsecs["e"] = round(time.perf_counter() - t3h, 1)
    family["seconds_to_end_of"] = hsecs
    print(f"launches on phase 3h: {json.dumps(hlaunches)}; seconds to the "
          f"end of each sub-phase: {json.dumps(hsecs)}")

    lap("3i")
    # 3i. the host KV tier behind the paged prefix cache, and the SLO
    # control plane, on 3h's random weights
    t3i = time.perf_counter()
    isecs = {}
    tiers, ilaunches = tier_phase(torch, sched, kv_tiers, llama,
                                  ServingEngine, PagedPrefixCache, fns,
                                  fparams, cfg)
    isecs["a_b"] = round(time.perf_counter() - t3i, 1)
    for key in ("audited", "tiered", "untiered", "no_cache"):
        st = tiers[key]
        print(f"3i (a) {key} ({card}): {TIER_TENANTS} tenants x "
              f"{TIER_ROUNDS} rounds, {TIER_PREFIX}-token prefixes, pool "
              f"{TIER_POOL_PAGES} pages, cache {TIER_CACHE_PAGES}: "
              f"{st['tokens_per_s']:.1f} tokens/s, ttft p50/p99 "
              f"{st['ttft_p50_s']:.4f}/{st['ttft_p99_s']:.4f} s, hits "
              f"{json.dumps(st['hits'])}, {st['steps']} steps "
              f"({st['admits']} admits), {st['ms_per_step']:.3f} ms/step, "
              f"{st['segments']} segments, {st['fetches']} fetches")
    au = tiers["audited"]
    print(f"3i (a) tier stats: {json.dumps(au['tiers'])}; prefix cache: "
          f"{json.dumps({k: v for k, v in au['prefix'].items() if k != 'tier'})}"
          f"; {au['synchronising_calls']} synchronising calls and "
          f"{au['event_waits']} event waits for {au['fetches']} fetches; "
          f"{au['restores_checked']} restores bit-"
          f"equal to their staged bytes in planes {au['planes_checked']}; "
          f"parted at near ties {json.dumps(tiers['parted_at_near_ties'])}")
    print(f"3i (a) one {tiers['transfer']['pages']}-page transfer "
          f"({tiers['transfer']['bytes']} B, {card}): "
          f"{json.dumps(tiers['transfer'])}")
    for key in ("tiered", "no_cache"):
        st = tiers["int8"][key]
        print(f"3i (b) int8 {key} ({card}): {st['tokens_per_s']:.1f} "
              f"tokens/s, ttft p50/p99 {st['ttft_p50_s']:.4f}/"
              f"{st['ttft_p99_s']:.4f} s, hits {json.dumps(st['hits'])}, "
              f"{st['segments']} segments, {st['fetches']} fetches"
              + (f"; tier {json.dumps(st['tiers'])}; "
                 f"{st['synchronising_calls']} synchronising calls, "
                 f"{st['event_waits']} event waits; "
                 f"{st['restores_checked']} restores bit-equal in planes "
                 f"{st['planes_checked']}" if key == "tiered" else ""))
    print(f"3i (b) int8 tiered against no cache: parted at near ties "
          f"{json.dumps(tiers['int8']['parted_at_near_ties'])}")
    slo, n = slo_phase(torch, sched, journal, ServingEngine, fns, fparams,
                       cfg)
    ilaunches.update(n)
    isecs["c"] = round(time.perf_counter() - t3i, 1)
    print(f"3i (c) SLOScheduler under overload ({card}): "
          f"{slo['requests']} requests, {slo['served']} served, "
          f"{slo['preemptions']} preemptions, {slo['shed']} shed "
          f"({json.dumps(slo['shed_per_class'])}), per class "
          f"{json.dumps(slo['per_class'])}, {slo['tokens_per_s']:.1f} "
          f"tokens/s, {slo['segments']} segments, {slo['fetches']} "
          f"fetches, {slo['synchronising_calls']} synchronising calls, "
          f"{slo['event_waits']} event waits; "
          f"with the monitors (same clock): "
          f"{json.dumps(slo['monitors'])}")
    tiers["slo"] = slo
    tiers["seconds_to_end_of"] = isecs
    print(f"launches on phase 3i: {json.dumps(ilaunches)}; seconds to the "
          f"end of each sub-phase: {json.dumps(isecs)}")
    del fparams

    lap("3j")
    # 3j. the serving fleet and disaggregated prefill/decode, on 3e's
    # trained model in bf16
    fleets, jlaunches = fleet_phase(torch, sched, fleet, disagg, kv_tiers,
                                    journal, llama, ServingEngine,
                                    PagedPrefixCache, fns, sparams, cfg,
                                    reqs)
    st = fleets["fleet"]
    print(f"3j (a) fleet ({card}): 2 replicas, {TIER_TENANTS} tenants x "
          f"{FLEET_ROUNDS} rounds, queues of {FLEET_MAX_QUEUE}, directory, "
          f"int8 shadow at {FLEET_SHADOW_P}: assignment "
          f"{st['assignment']}, dispatches {json.dumps(st['dispatches'])}, "
          f"{st['tier_migrations']} tier migrations, "
          f"{st['backpressure_events']} refusals, {st['segments']} "
          f"segments, {st['fetches']} fetches (shadow's included), "
          f"{st['synchronising_calls']} synchronising calls, "
          f"{st['event_waits']} event waits "
          f"({json.dumps(st['event_wait_ms'])} ms), "
          f"{st['tokens_per_s']:.1f} tokens/s, ttft p50/p99 "
          f"{st['ttft_p50_s']:.4f}/{st['ttft_p99_s']:.4f} s")
    print(f"3j (a) shadow quality (int8 against bf16, {card}): "
          f"{json.dumps(st['quality'])}; shadow {json.dumps(st['shadow'])}")
    print(f"3j (a) first turns, ms after the serve's start (replica, "
          f"dispatch, t_sync): "
          + ", ".join(f"({t['replica']}, {t['t_disp_ms']:.2f}, "
                      f"{t.get('t_sync_ms', float('nan')):.2f})"
                      for t in st["turns"]))
    tm = fleets["timed"]
    print(f"3j fleet against one replica ({card}), {tm['pairs']} pairs in "
          f"turns: two replicas {json.dumps(tm['tokens_per_s']['two_replicas'])}"
          f" tokens/s, one replica "
          f"{json.dumps(tm['tokens_per_s']['one_replica'])}; medians "
          f"{tm['median_tokens_per_s']['two_replicas']:.1f} against "
          f"{tm['median_tokens_per_s']['one_replica']:.1f} "
          f"(x{tm['median_ratio']:.3f})")
    st = fleets["failover"]
    print(f"3j (b) failover ({card}): crash {FLEET_CRASH}: "
          f"{st['failovers']} failover, {st['requeued']} requeued, health "
          f"{json.dumps(st['replica_health'])}, {st['requests']} requests "
          f"served, {st['fetches']} fetches, {st['synchronising_calls']} "
          f"synchronising calls, {st['event_waits']} event waits")
    st = fleets["disagg"]
    print(f"3j (c) disaggregated ({card}): 1 prefill + 1 decode replica, "
          f"32 mixed requests: handoffs {json.dumps(st['handoffs'])}, page "
          f"{st['page_bytes']} B, {st['drain_ms_per_crossing']:.3f} ms of "
          f"host drain a crossing (flush included; drains "
          f"{json.dumps(st['drains'])}), "
          f"{st['tokens_per_s']:.1f} tokens/s, ttft p50/p99 "
          f"{st['ttft_p50_s']:.4f}/{st['ttft_p99_s']:.4f} s, e2e p50/p99 "
          f"{st['e2e_p50_s']:.4f}/{st['e2e_p99_s']:.4f} s, {st['fetches']} "
          f"fetches, {st['synchronising_calls']} synchronising calls "
          f"({st['tier_flushes']} flushes), {st['event_waits']} event "
          f"waits; co-resident fleet "
          f"{fleets['co_resident']['tokens_per_s']:.1f} tokens/s, ttft "
          f"p50/p99 {fleets['co_resident']['ttft_p50_s']:.4f}/"
          f"{fleets['co_resident']['ttft_p99_s']:.4f} s")
    print(f"3j parted at near ties: "
          f"{json.dumps(fleets['parted_at_near_ties'])}")
    print(f"launches on phase 3j: {json.dumps(jlaunches)}")

    lap("3k")
    # 3k. the elastic fleet: the program space and its warmup, the
    # autoscaler's episode and the chip fit, on 3e's trained model
    elastic, klaunches = elastic_phase(
        torch, sched, fleet, disagg, autoscaler, kv_tiers, journal, llama,
        ServingEngine, PagedPrefixCache, PagedKVCache, CapacityMonitor,
        recompile, memory, da, fns, sparams, cfg)
    wm = elastic["warmups"]
    print(f"3k (a) aot_warmup ({card}), keys and seconds by family: "
          f"default envelope {json.dumps(wm['default'])}; segments of "
          f"{ELASTIC_SEG_STEPS} behind the cache {json.dumps(wm['elastic'])}"
          f" (built {json.dumps(wm['elastic_built'])}); pools "
          f"{json.dumps(wm['pools'])}")
    print(f"3k (a) first segment, {ELASTIC_PAIRS} pairs in turns ({card}): "
          f"{json.dumps(elastic['first_segment_ms'])} ms, medians "
          f"{json.dumps(elastic['first_segment_median_ms'])}; built (first "
          f"pair) {json.dumps(elastic['first_segment_built'])}")
    st = elastic["warmed_serve"]
    print(f"3k (a) warmed serve ({card}): {st['requests']} requests, "
          f"{st['tokens_per_s']:.1f} tokens/s, {st['steps']} steps, "
          f"{st['segments']} segments; built {json.dumps(st['built'])}; "
          f"keys used {json.dumps(st['keys_used'])}")
    st = elastic["episode"]
    print(f"3k (b) elastic episode ({card}): {st['requests']} requests, "
          f"{st['stranded']} stranded, scale-ups {st['scale_ups']}, "
          f"scale-downs {st['scale_downs']}, peak {st['peak_replicas']} "
          f"replicas, lifecycles {st['lifecycles']}; decisions (action, "
          f"replica, queue) {json.dumps(st['decisions'])}; warm s "
          f"{json.dumps(st['warm_s'])} for keys {json.dumps(st['warm_keys'])}"
          f" (standbys {st['standby_warmup_s']:.3f} s); drains "
          f"{json.dumps(st['drains'])}, {st['requeued']} requeued, "
          f"{st['prefixes_migrated']} prefixes migrated; built "
          f"{json.dumps(st['built'])}; {st['tokens_per_s']:.1f} tokens/s, "
          f"ttft p50/p99 {st['ttft_p50_s']:.4f}/{st['ttft_p99_s']:.4f} s, "
          f"wall {st['wall_s']:.3f} s; against one engine "
          f"{json.dumps(st['against_one_engine'])}, parted at near ties "
          f"{json.dumps(st['parted_at_near_ties'])}")
    cf = elastic["chip_fit"]
    print(f"3k (c) chip fit ({card}): hbm {cf['hbm_bytes']} B: weights "
          f"{cf['fit']['weights_bytes']} (requested at build "
          f"{cf['measured']['weights_bytes']}, allocated "
          f"{cf['measured']['weights_allocated']}), pool "
          f"{cf['fit']['pool_bytes']} (requested "
          f"{cf['measured']['pool_bytes']}, allocated "
          f"{cf['measured']['pool_allocated']}), transient estimate "
          f"{cf['fit']['transient_bytes']} against a measured serve peak "
          f"of {cf['measured']['serve_peak_bytes']}, envelope "
          f"{cf['fit']['envelope_bytes']} (utilization "
          f"{cf['fit']['utilization']}); per family "
          f"{json.dumps(cf['family_transients'])}; refusal: "
          f"{cf['refusal']['reason']}")
    print(f"launches on phase 3k: {json.dumps(klaunches)}")

    lap("6")
    # 6. ResNet-50 training, BASELINE config 1 at full shape
    del sparams
    x, y = resnet_batch(torch)
    rvp, (rmodel, ropt, rstep) = resnet_vs_plain(torch, port, mtu, fns, x,
                                                 y)
    print(f"ResNet-50, kernel against plain ({card}): B {RESNET_BATCH} "
          f"{RESNET_SIZE}x{RESNET_SIZE} NHWC O2 bf16 Momentum, losses "
          f"{rvp['losses_kernel']} / {rvp['losses_plain']} (|err| "
          f"{rvp['loss_abs_err']:.3e} <= {RESNET_LOSS_ATOL}), largest param "
          f"error {rvp['param_max_abs_err']:.3e}, BN statistics "
          f"{rvp['bn_stat_max_abs_err']:.3e}, bit-identical "
          f"{rvp['bit_identical']}")
    rtrain, rlaunches = resnet_run(torch, fns, rstep, x, y)
    rbusy = rtrain.get("device_busy_share")
    print(f"ResNet-50 train ({card}): B {RESNET_BATCH} {RESNET_SIZE}x"
          f"{RESNET_SIZE} NHWC O2 bf16, {rtrain['timed_steps']} timed "
          f"Momentum steps: {rtrain['images_per_s']:.1f} images/s, "
          f"{rtrain['ms_per_step']:.3f} ms/step, device "
          f"{rtrain['device_ms_per_step']} ms in one profiled step of "
          f"{rtrain.get('profiled_step_wall_ms', 'not measured')} ms wall "
          f"(busy share "
          f"{'not measured' if rbusy is None else f'{rbusy:.4f}'}), "
          f"multi_tensor_update share of the device time "
          f"{rtrain.get('update_kernel_share', 'not measured')}, peak "
          f"memory {rtrain['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
          f"{', '.join(f'{v:.4f}' for v in rtrain['losses'])}")
    print(f"launches on the ResNet-50 steps: {json.dumps(rlaunches)}")
    print(f"ResNet-50 device time (ms/step) by kind: "
          f"{json.dumps(rtrain.get('device_split_ms'))}; largest kernels "
          f"of each kind: {json.dumps(rtrain.get('device_largest_by_kind'))}"
          f"; host operators by self time (ms): "
          f"{json.dumps(rtrain.get('host_top'))}")
    del ropt, rstep
    radamw, alaunches = resnet_adamw(torch, port, fns, rmodel, x, y)
    print(f"ResNet-50 O2 AdamW(multi_precision) ({card}): "
          f"{radamw['steps']} steps, losses "
          f"{', '.join(f'{v:.4f}' for v in radamw['losses'])}")
    print(f"launches on the ResNet-50 AdamW steps: {json.dumps(alaunches)}")

    lap("6b")
    # 6b. BASELINE config 0: Model.fit of LeNet on MNIST
    mtrain = port.vision.datasets.MNIST(mode="train")
    mtest = port.vision.datasets.MNIST(mode="test")
    mvp = mnist_vs_plain(torch, port, mtu, fns, mtrain)
    print(f"MNIST LeNet, kernel against plain ({card}): "
          f"{mvp['steps']} Adam steps in order, losses "
          f"{mvp['losses_kernel']} / {mvp['losses_plain']} (largest |err| "
          f"{mvp['loss_max_abs_err']:.3e}), largest param error "
          f"{mvp['param_max_abs_err']:.3e} (fp32 MTU_TOL "
          f"{MTU_TOL['torch.float32']}), bit-identical "
          f"{mvp['bit_identical']}; launches {mvp['steps']} against 0")
    mfit, mlaunches, mmodel = mnist_recipe(torch, port, mtu, fns, mtrain,
                                           mtest)
    mbusy = mfit["device_busy_share"]
    mover = mfit["device_over_timed_wall"]
    print(f"MNIST LeNet fit ({card}): {mfit['batches']} batches of "
          f"{MNIST_BATCH}: {mfit['samples_per_s']:.1f} samples/s, "
          f"{mfit['ms_per_step']:.3f} ms/step (loader "
          f"{mfit['loader_ms_per_batch']:.3f} ms, train_batch "
          f"{mfit['train_batch_ms_per_batch']:.3f} ms a batch), device "
          f"{mfit['device_ms']} ms in a profiled fit of "
          f"{mfit.get('profiled_fit_wall_ms', 'not measured')} ms wall "
          f"(busy share "
          f"{'not measured' if mbusy is None else f'{mbusy:.4f}'}; the "
          f"same device time over the timed fit's wall "
          f"{'not measured' if mover is None else f'{mover:.4f}'}), "
          f"multi_tensor_update launches per step "
          f"{mfit['launches_per_step']}, synchronising calls per batch "
          f"{mfit['syncs_per_batch']}, loss {mfit['first_loss']:.4f} -> "
          f"{mfit['last_loss']:.4f}; evaluate on MNIST(mode='test'): "
          f"{json.dumps(mfit['eval'])}")
    print(f"launches on the MNIST fit: {json.dumps(mlaunches)}")
    print(f"MNIST LeNet profiled fit, host ms a batch by call (inclusive "
          f"and self, under the profiler): "
          f"{json.dumps(mfit.get('host_ms_per_batch'))}; host operators by "
          f"self time (ms, the fit's): {json.dumps(mfit.get('host_top'))}")
    msched, mslaunches = mnist_scheduled(torch, port, mtu, fns, mtrain)
    print(f"MNIST LeNet scheduled fit ({card}): CosineAnnealingDecay("
          f"{MNIST_LR}, {MNIST_T_MAX}) by step, ClipGradByGlobalNorm("
          f"{MNIST_CLIP}), L2Decay({MNIST_L2}): launches per step "
          f"{msched['launches_per_step']}, rates equal to lr.py's "
          f"(first {msched['lrs'][0]:.6g}, last {msched['lrs'][-1]:.6g}), "
          f"loss {msched['losses'][0]:.4f} -> {msched['losses'][-1]:.4f}")
    mckpt = mnist_checkpoint(torch, port, mmodel, mtest)
    print(f"MNIST LeNet checkpoint ({card}): a fresh model loaded from "
          f"Model.save evaluates {json.dumps(mckpt['eval'])}, equal to the "
          f"saved model's (before loading "
          f"{json.dumps(mckpt['fresh_eval_before_load'])})")
    mnist = {"vs_plain": mvp, "fit": mfit, "scheduled": msched,
             "checkpoint": mckpt}
    del mmodel

    lap("5c")
    # 5c. BASELINE config 2: BERT-base MLM pretraining on the non-causal
    # flash kernels
    x6, y6 = x.cpu(), y.cpu()  # phase 6's batch, again in 6j
    del rmodel, x, y
    torch.cuda.empty_cache()
    bstats, blaunches5c, elaunches5c = bert_phase(torch, bert, fa, fns)
    bvp, brun = bstats["vs_plain"], bstats["run"]
    worst = max(bvp["grad_rel_err"].items(),
                key=lambda kv: kv[1]["kernel_vs_plain"])
    print(f"BERT-base MLM, kernels against plain ({card}): B "
          f"{BERT_VS_PLAIN_BATCH} S {BERT_SEQ} loss "
          f"{bvp['loss_kernels']:.6f} / {bvp['loss_plain']:.6f} (|err| "
          f"{bvp['loss_abs_err']:.3e} <= {TRAIN_LOSS_ATOL}; fp32 "
          f"{bvp['loss_fp32']:.6f}), gradient norm "
          f"{bvp['grad_norm_kernels']:.6f} / {bvp['grad_norm_plain']:.6f} "
          f"(rtol {BERT_GNORM_RTOL}); largest kernel-against-plain "
          f"gradient error {worst[0]} {json.dumps(worst[1])}, each no "
          f"farther from the fp32 path than the plain path + "
          f"{TRAIN_GRAD_RTOL}: {json.dumps(bvp['grad_rel_err'])}")
    bbusy = brun.get("device_busy_share")
    print(f"BERT-base MLM train ({card}): bf16/fp32 master, remat, B "
          f"{BERT_BATCH} S {BERT_SEQ}, {brun['timed_steps']} timed AdamW "
          f"steps: {brun['tokens_per_s']:.1f} tokens/s "
          f"({brun['masked_tokens_per_step']} masked tokens a step), "
          f"{brun['ms_per_step']:.3f} ms/step, device "
          f"{brun['device_ms_per_step']} ms in one profiled step of "
          f"{brun.get('profiled_step_wall_ms', 'not measured')} ms wall "
          f"(busy share "
          f"{'not measured' if bbusy is None else f'{bbusy:.4f}'}), peak "
          f"memory {brun['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
          f"{', '.join(f'{v:.4f}' for v in brun['losses'])}")
    print(f"launches on the BERT train steps: {json.dumps(blaunches5c)}")
    print(f"BERT device time (ms/step) by kind: "
          f"{json.dumps(brun.get('device_split_ms'))}; largest kernels: "
          f"{json.dumps(brun.get('device_top'))}")
    print(f"ERNIE-base step ({card}): {json.dumps(bstats['ernie_base'])}; "
          f"launches {json.dumps(elaunches5c)}")

    lap("6c")
    # 6c. the eager transformer stack at BERT-base width, fp32 and bf16
    eager, elaunches6c = eager_phase(torch, port, bert, fns)
    for mode, st in eager.items():
        ebusy = st.get("device_busy_share")
        print(f"eager BERT-base encoder, {mode} ({card}): B {EAGER_BATCH} S "
              f"{BERT_SEQ}, {st['timed_steps']} timed AdamW steps: "
              f"{st['tokens_per_s']:.1f} tokens/s, {st['ms_per_step']:.3f} "
              f"ms/step, the fp32 flash kernels "
              f"{st.get('flash_f32_device_ms', 'not measured')} ms and "
              f"device {st['device_ms_per_step']} ms in one "
              f"profiled step of "
              f"{st.get('profiled_step_wall_ms', 'not measured')} ms wall "
              f"(busy share "
              f"{'not measured' if ebusy is None else f'{ebusy:.4f}'}; by "
              f"kind {json.dumps(st.get('device_split_ms'))}), "
              f"multi_tensor_update launches a step "
              f"{st['multi_tensor_update_per_step']}, peak memory "
              f"{st['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
              f"{', '.join(f'{v:.4f}' for v in st['losses'])}")
        print(f"eager {mode} largest kernels: "
              f"{json.dumps(st.get('device_top'))}; host operators by self "
              f"time: {json.dumps(st.get('host_top'))}")
    print(f"launches on the eager steps: {json.dumps(elaunches6c)}")

    lap("6d")
    # 6d. the PaddleClas zoo: MobileNetV3-large trained as ResNet-50 is,
    # then every other family's forward parity and one O2 step
    torch.cuda.empty_cache()
    t6d = time.perf_counter()
    zvp, zrun, zlaunches = zoo_mobilenet(torch, port, mtu, fns)
    print(f"MobileNetV3-large, kernel against plain ({card}): B {ZOO_BATCH} "
          f"{ZOO_SIZE}x{ZOO_SIZE} NCHW O2 bf16 Momentum, losses "
          f"{zvp['losses_kernel']} / {zvp['losses_plain']} (|err| "
          f"{zvp['loss_abs_err']:.3e} <= {RESNET_LOSS_ATOL}), largest param "
          f"error {zvp['param_max_abs_err']:.3e}, BN statistics "
          f"{zvp['bn_stat_max_abs_err']:.3e} (MTU_TOL), bit_identical "
          f"{zvp['bit_identical']}")
    if not zvp["plain_repeat_bit_identical"]:
        print("MobileNetV3-large: two plain-path runs from the same seed "
              "differ under deterministic cuDNN: the step's backward "
              "(depthwise convolutions) is not deterministic on this card")
    zbusy = zrun.get("device_busy_share")
    print(f"MobileNetV3-large train ({card}): {zrun['parameters']} params "
          f"({zrun['parameter_elements']} elements), B {ZOO_BATCH} "
          f"{ZOO_SIZE}x{ZOO_SIZE} NCHW O2 bf16, {zrun['timed_steps']} timed "
          f"Momentum steps: {zrun['images_per_s']:.1f} images/s, "
          f"{zrun['ms_per_step']:.3f} ms/step, device "
          f"{zrun['device_ms_per_step']} ms in one profiled step of "
          f"{zrun.get('profiled_step_wall_ms', 'not measured')} ms wall "
          f"(busy share "
          f"{'not measured' if zbusy is None else f'{zbusy:.4f}'}), peak "
          f"memory {zrun['peak_memory_bytes'] / 2**30:.2f} GiB, "
          f"multi_tensor_update launches a step "
          f"{zrun['update_launches_per_step']} for "
          f"{zrun['flat_groups']} flat groups, losses "
          f"{', '.join(f'{v:.4f}' for v in zrun['losses'])}")
    print(f"MobileNetV3-large device time (ms/step) by kind: "
          f"{json.dumps(zrun.get('device_split_ms'))}; largest kernels of "
          f"each kind: {json.dumps(zrun.get('device_largest_by_kind'))}; "
          f"host operators by self time (ms): "
          f"{json.dumps(zrun.get('host_top'))}")
    print(f"launches on the MobileNetV3-large steps: {json.dumps(zlaunches)}")
    del zrun["losses"]
    zoo, zflaunches = {}, {}
    for name, kw, size in ZOO_BUILDERS:
        zoo[name], zflaunches[name] = zoo_family(torch, port, device_mod,
                                                 fns, name, kw, size)
        z = zoo[name]
        print(f"zoo {name}{'' if not kw else json.dumps(kw)} ({card}): fp32 "
              f"eval B {ZOO_FWD_BATCH} at {size}x{size}, card against CPU "
              f"{z['fwd_max_abs_err']:.3e} (largest |logit| "
              f"{z['fwd_max_abs_logit']:.3e}, rtol {ZOO_FWD_RTOL}); O2 "
              f"Momentum step at B {ZOO_STEP_BATCH}: {z['ms_step']:.3f} ms, "
              f"peak memory {z['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
              f"{z['losses'][0]:.4f}, {z['losses'][1]:.4f}, "
              f"multi_tensor_update launches a step "
              f"{z['update_launches_per_step']} for {z['flat_groups']} flat "
              f"groups")
        torch.cuda.empty_cache()
    zoo_s = time.perf_counter() - t6d
    print(f"phase 6d (the PaddleClas zoo): {zoo_s:.1f} s")
    zoo_stats = {"mobilenet_v3_large_vs_plain": zvp,
                 "mobilenet_v3_large_train": zrun, "families": zoo,
                 "seconds": zoo_s}

    lap("6e")
    # 6e. the text models, the other optimizers and the losses
    torch.cuda.empty_cache()
    text, xlaunches = text_phase(torch, port, recipes, parity, mtu, fns)
    ivp, ifit, ilm = text["imdb_vs_plain"], text["imdb_fit"], text["imikolov"]
    print(f"Imdb BiLSTM, kernel against plain ({card}): {ivp['steps']} Adam "
          f"steps in order, losses {ivp['losses_kernel']} / "
          f"{ivp['losses_plain']} (largest |err| "
          f"{ivp['loss_max_abs_err']:.3e}), largest param error "
          f"{ivp['param_max_abs_err']:.3e} (two plain runs "
          f"{ivp['plain_repeat_max_abs_err']:.3e}; atol "
          f"{IMDB_PARAM_ATOL}), "
          f"bit-identical {ivp['bit_identical']} (plain repeat "
          f"{ivp['plain_repeat_bit_identical']}); launches {ivp['steps']} "
          f"against 0")
    for e, ep in enumerate(ifit["epochs"]):
        print(f"Imdb BiLSTM fit epoch {e + 1} ({card}): "
              f"{ifit['parameters']} params, {ifit['batches_per_epoch']} "
              f"batches of {IMDB_BATCH}: {ep['samples_per_s']:.1f} "
              f"samples/s, {ep['ms_per_step']:.3f} ms/step (loader "
              f"{ep['loader_ms_per_batch']:.3f} ms a batch), "
              f"multi_tensor_update launches a step "
              f"{ep['launches_per_step']}, loss {ep['first_loss']:.4f} -> "
              f"{ep['last_loss']:.4f}; evaluate on Imdb(mode='test'): "
              f"{json.dumps(ep['test'])}")
    ibusy = ifit.get("device_busy_share")
    print(f"Imdb BiLSTM profiled {IMDB_PROFILED_STEPS} steps ({card}): "
          f"device {ifit.get('device_ms_per_step', 'not measured')} ms a "
          f"step of {ifit.get('profiled_wall_ms_per_step', 'not measured')} "
          f"ms wall (busy share "
          f"{'not measured' if ibusy is None else f'{ibusy:.4f}'}), "
          f"multi_tensor_update "
          f"{ifit.get('update_device_ms_per_step', 'not measured')} ms a "
          f"step; by kind {json.dumps(ifit.get('device_split_ms_per_step'))}"
          f"; largest kernels {json.dumps(ifit.get('device_top'))}; host "
          f"operators by self time {json.dumps(ifit.get('host_top'))}")
    print(f"launches on the Imdb BiLSTM fit: {json.dumps(xlaunches)}")
    print(f"Imikolov GRU LM fit ({card}): {ilm['batches']} batches of "
          f"{IMIKOLOV_BATCH}, centered RMSProp with momentum: "
          f"{ilm['tokens_per_s']:.1f} predicted tokens/s, "
          f"{ilm['ms_per_step']:.3f} ms/step, batch loss "
          f"{ilm['first_batch_loss']:.4f} -> {ilm['last_batch_loss']:.4f}, "
          f"mean training loss {ilm['mean_loss_before']:.4f} -> "
          f"{ilm['mean_loss_after']:.4f}")
    print(f"optimizers on UCIHousing, card against CPU over 3 steps, and the "
          f"card's loss over 50 ({card}, {text['optimizers_s']:.1f} s): "
          f"{json.dumps(text['optimizers'])}")
    print(f"losses forward and backward, card against CPU, largest |err| "
          f"({card}, {text['losses_s']:.1f} s): "
          f"{json.dumps(text['losses'])}")

    lap("6f")
    # 6f. the vision slice and quantization
    torch.cuda.empty_cache()
    vision_stats, vqlaunches = vision_phase(torch, port, bert, parity,
                                            vision_quant, fns, eager["fp32"],
                                            card)

    lap("6g")
    # 6g. the tensor core and the op corpus, and the README's script
    torch.cuda.empty_cache()
    corpus, rqlaunches = corpus_phase(torch, op_corpus, fns, card)

    lap("6h")
    # 6h. the runtime modules, and LLaMA's single-device options trained
    # and served
    torch.cuda.empty_cache()
    llama_opts, olaunches = llama_opts_phase(torch, llama, rlo, tf, qm,
                                             ServingEngine, fns, card, train,
                                             params5, tok44)

    lap("6i")
    # 6i. LLaMA's hybrid-parallel step: a mesh of one, then three layouts
    # of 4 gloo ranks sharing the card
    torch.cuda.empty_cache()
    mesh_stats, milaunches = mesh_phase(torch, llama, mesh_train, fns, card,
                                        train, params5, tok44)
    del params5, tok44

    lap("6j")
    # 6j. BASELINE config 3: Fleet data-parallel ResNet-50 on phase 6's
    # batch, a world of one, then 4 gloo ranks sharing the card
    torch.cuda.empty_cache()
    fleet_stats, fjlaunches = dp_fleet_phase(
        torch, port, fleet_dp, fns, card, x6.to(DEVICE), y6.to(DEVICE),
        rtrain)
    del x6, y6

    lap("7")
    # 7. the kernel experiments' entry points, at the reference's shapes
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    exps, dlaunches, flaunches = experiments(torch, fns, xdot, xfv)
    print(f"experiments ({card}): dot_variants and flash_variants in "
          f"{time.perf_counter() - t0:.1f} s")
    exps["flash_variants_build"] = variant_build_report(
        fv, _build, {b["name"]: b["log"] for b in builds})
    print(f"launches on the dot experiment: {json.dumps(dlaunches)}")
    print(f"launches on the flash experiment: {json.dumps(flaunches)}")

    lap("8")
    # 8. results
    by_path = {"contiguous_drain": launches, "paged_drain": plaunches,
               "prefix_burst": blaunches, "long_admit": llaunches,
               "cpu_small_contiguous_drain": slaunches,
               "cpu_small_paged_drain": splaunches,
               "quant_int8_drain": qlaunches,
               "quant_fp8_drain": f8launches, "train": tlaunches,
               "quant_int8_trained_drain": qtlaunches,
               "resnet50_train": rlaunches, "resnet50_adamw": alaunches,
               "mnist_fit": mlaunches, "mnist_fit_scheduled": mslaunches,
               "bert_train": blaunches5c, "ernie_step": elaunches5c,
               **elaunches6c,
               "zoo_mobilenet_v3_large": zlaunches,
               "imdb_bilstm_fit": xlaunches, **vqlaunches,
               "readme_quickstart": rqlaunches, **olaunches, **milaunches,
               **fjlaunches,
               **{f"zoo_{n}": v for n, v in zflaunches.items()},
               "dot_experiment": dlaunches, "flash_experiment": flaunches,
               "fused_drain": flaunches_3g,
               "contiguous_prefix_burst": cblaunches["prefix_cache"],
               "contiguous_burst_no_cache": cblaunches["no_cache"],
               **glaunches, **plaunches3g, **hlaunches, **ilaunches,
               **{f"3j_{k}": v for k, v in jlaunches.items()},
               **{f"3k_{k}": v for k, v in klaunches.items()}}
    kernels = kernels_line(rows, by_path)
    check_paths(by_path, kernels)
    lap(None)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "kernel_rows": rows, "engine": stats,
                   "tick": tick, "paged_engine": pstats,
                   "paged_steps": psteps, "prefix_burst": burst,
                   "fused_drain": fstats,
                   "contiguous_prefix_bursts": cbursts,
                   "generation": gen_stats, "preemption": preempt,
                   "families": family, "tiers": tiers,
                   "fleets": fleets, "elastic": elastic,
                   "long_admit": longa, "cpu_small": small,
                   "quant": quant, "quant_trained": qtrained,
                   "launches": by_path,
                   "teacher_forced": tfc, "teacher_forced_paged": tfp,
                   "teacher_forced_quant": tfq, "train_vs_plain": tvp,
                   "train": train, "multi_tensor_skip": mtu_skip,
                   "resnet50_vs_plain": rvp, "resnet50_train": rtrain,
                   "resnet50_adamw": radamw, "mnist": mnist,
                   "bert": bstats, "eager_bert": eager, "zoo": zoo_stats,
                   "text": text, "vision_quant": vision_stats,
                   "op_corpus": corpus, "llama_opts": llama_opts,
                   "mesh": mesh_stats, "fleet_dp": fleet_stats,
                   "flash_variant_matrix_errors": variant_errs,
                   "flash_attention_build": flash_build,
                   "rebuilt_build": rebuilt_build,
                   "experiments": exps, "seconds_by_phase": laps}, f,
                  indent=1)
    print(f"seconds by phase: {json.dumps(laps)}")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
