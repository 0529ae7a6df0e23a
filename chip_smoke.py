#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``analytics_zoo_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failed check raises, so the
script exits non-zero and prints no result line:

1. device: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions;
2. build: compiles the port's CUDA kernels from ``csrc/`` (one ``nvcc``
   per source, in parallel) and prints ptxas's registers and spills;
3. kernels: every distinct shape each kernel gets on its path, held
   against its plain PyTorch version on the card, with kernel, plain,
   library-call and bound times: the eval folds (B5, B6) at ResNet-50's
   serving shapes (224x224, batch 1, 8 and 32; B5 with the model's f32
   weights in both activation dtypes, and with bf16 weights and a
   prologue), the training kernels (B1-B4) at its train-step shapes
   (batch 128, plus residual and ragged-M cases; B2 also at Cin 128 and
   256 on a small ragged M and stride 2 at an odd extent, B4 at K 64 /
   N 64 on a ragged M and K 2048 / N 512 with a residual and no
   affine), in f32 and bf16. B5's f32 product also meets an accuracy
   gate at every shape: against the fold in float64 from the same
   inputs, its max|error| at most twice cuBLAS f32's (TF32 off), and
   with a bf16 x at most twice as many elements of y rounded to bf16
   otherwise than that fold (plain TF32 the control that must fail); its
   bound is the least time of an f32-accurate product on this card,
   max(bytes / 3.35 TB/s, min(FLOP / 67 TFLOP/s, p FLOP / 495 TFLOP/s))
   with p the TF32 passes it needs (:func:`fold_passes`: 2 for a bf16 x
   without a prologue, else 3), the term named. B1's y and statistics repeat bit for bit. Then
   per-shape tables of B1 and B3 (the 16 train-step shapes), B5 (both
   activation dtypes) and B6 (batch 1, 8 and 32): launches, kernel,
   library and bound ms, and the rate against the bound's unit. The
   build prints each wgmma kernel's registers and spills, and any
   ptxas warning that a kernel's wgmmas are serialised;
4. serving: ``ImageClassifier("resnet-50", fused=True)`` at full width
   with seeded random weights and distinctive BatchNorm statistics,
   served by ``InferenceModel`` to requests from two threads at batch
   1, 8 and 32 in f32 and bf16; checks the launch counts (36 and 16 per
   forward), the f32 logits against the port's unfused graph (cuDNN
   convs) and the bf16 logits against the f32 ones; times the median
   request (images/s, with the requests' spread) beside the unfused
   graph's at batch 32 and profiles three batch-32 requests (device ms
   per request by kernel, B5 and B6 named);
5. training, through ``Estimator.train`` (SGD 0.1, momentum 0.9,
   softmax cross entropy; the input path prefetching and placing each
   batch through pinned buffers on a copy stream) at 224x224, 1000
   classes, on seeded numpy data: ``resnet50(fused=True)``, one f32 step
   held against the port's unfused graph on the same weights and batch
   (loss and a sample of the updated weights and moving statistics),
   then ``mixed_bfloat16`` at batch 128 with the default
   ``ZOO_TPU_PREFETCH`` and with 0 (launches 36/16/36/36 per step,
   finite losses, the first bf16 loss against the f32 one, the same
   losses either way), each timed over three epochs (images/s with its
   spread, model-FLOPs MFU) and profiled over three steps (device busy
   share, ms per kernel per step, the host-to-device copies by source,
   the ten largest rows left in "other"); then bench.py's flagship,
   ``resnet50(space_to_depth=True)`` with ``fused=True`` and
   ``fused="defer"`` (the stage layout on the fused model's weights),
   each one f32 step against the other and the s2d unfused graph, then
   the bf16 main path timed and profiled; and, between the two, the
   unfused graph's bf16 main path, timed in turns with the fused one
   (``MEASURED_WIN``'s evidence, with phase 4's unfused requests);
6. BERT fine-tune: BERT-base (vocab 30522, hidden 768, 12 blocks, 12
   heads, intermediate 3072) at T = 512 with ``remat=True`` and
   ``attention_impl="flash"``, under Lambda(pooled) → Dropout(0.1) →
   Dense(2, softmax), trained five steps by ``Estimator`` (Adam with
   warm-up, sparse categorical cross entropy, accuracy) at batch 16 on
   key-padding masks of seeded lengths, then ``evaluate`` and
   ``predict`` over two batches: the f32 flash kernels. One f32 step is
   held against the dense plain path (loss, every gradient); launches
   are checked (B8 24, B9 12, B10 12 per step, B7 12 per eval batch and
   none in training); samples/s and a profile of two steps;
7. BERT train steps as ``bench_bert.py`` runs them: 12 blocks, batch
   32, T = 128, params cast to bf16 inside the loss, Adam(5e-5): the
   bf16 kernels; finite losses, the first against the f32 loss on the
   same weights, launches, samples/s and a profile;
8. generation: ``TransformerLayer`` at GPT-1's widths (12 blocks,
   hidden 768, 12 heads, vocab 40990) with a 2048-token context and
   seeded random weights (the token embedding scaled by
   ``GEN_EMBED_SCALE``, so greedy streams vary), loaded by ``InferenceModel.load_generator``
   (8 slots, 16-token pages, f32 cache), warmed, and served by
   ``ContinuousBatcher`` to 16 greedy requests from 4 client threads
   with staggered arrivals (prompts of 17, 200, 700 and 1500 tokens,
   32-64 new tokens each); checks every budget, zero errors, slots and
   pages back to full, the launches (B11 12 per decode step, reading
   the pages in place, B7 12 per prefill at buckets >= 1024 and none
   below), eight teacher-forced
   decode steps through the kernels against the dense plain path (and
   the last against the uncached forward) within 1e-3 of max|logit|,
   and each served stream against the engine's sequential generate
   (a stream may part only where the top-2 margin is within that
   bound); tokens/s, median time to first token, the median decode
   step at 8 active slots and a profile of two steps (its B11 and
   page-table-gather rows printed);
9. the flash/dense crossover: fwd+bwd at B = 4, H = 16, D = 64, bf16,
   causal, Tk from 128 to 4096 (printed only);
10. the decode crossover: B11 against the dense decode at S 8, H 12,
   D 64, f32, T from 128 to 4096 (printed only);
11. recommendation: first ``Embedding``'s lookup of ids -1, n - 1, n
   and -n - 1 on the card, forward and backward, against the CPU's
   (the wrapped row, NaN rows, no gradient on the clamped rows; the
   phases after it show no device-side assert fired); then NeuralCF at
   ``bench_ncf.py``'s configuration (6040 users, 3706 items, 5 classes,
   embeddings 20, MLP 40-20-10, Adam 1e-3, ``class_nll``, f32) through
   ``compile``/``fit`` on 20 batches of 8192 ids drawn as bench_ncf
   draws them: its log-probabilities and first three losses against the
   CPU port on the same weights and batches (1e-5 of max(1, max|out|),
   1e-4 relative), train samples/s (median of three 20-step epochs, with
   their min-max), ms per step, the wait per step for input, a 3-step
   profile (busy share, device rows per step, the five largest) and
   ``recommend_for_user`` over 8192 pairs; then Wide&Deep
   (``wide_n_deep``, the ml-1m column layout of the port's example at
   6040 users and 3706 items): its forward and one Adam step against
   the CPU port, then ``examples/wide_and_deep.py``'s ``main`` once on
   the card. No kernel of the eleven lies on this path: their counts
   stay 0 over it;
12. the serving front end over HTTP (``InferenceServer`` on port 0,
   ``DynamicBatcher`` at bench_serving.py's settings: max batch 32,
   5 ms, queue 512): phase 4's ResNet-50 in f32 and bf16 (declared by
   an example batch of 8 in that dtype), 48 JSON requests of
   bench_serving's size mix (1, 1, 1, 2, 1, 4, 1, 2) from 8 client
   threads. Checked: every reply 200; every bucket execution equal bit
   for bit to ``predict`` of the same padded bucket, every reply to its
   rows of that bucket and, within 1e-3 (f32) or 2e-2 (bf16) of
   max(1, max|ref|), to the request served alone; the ladder warmed
   (6 buckets) and no library loaded nor bucket callable made after
   warm-up; B5 36 and B6 16 launches per bucket execution; a sent
   ``X-Zoo-Trace-Id`` echoed with its queue/pad/predict/scatter spans in
   ``/debug/traces``; ``/health``. Printed: images/s, request p50/p99,
   mean bucket fill. Then bench_serving's MLP tower (Dense
   256→4096→4096→512→10) in closed loops of 8 clients for 4 s, batched
   and per request (rows/s, p50/p99, their ratio, a reply per size
   against ``predict``), and in int8 (``quantize=True``) behind the
   batcher, held to the CPU port's ``QuantizedModel`` on the same
   weights and calibration (the first layer's int8 input and int32
   accumulator equal, replies within 1e-5 of max(1, max|out|)); then
   ``/generate`` on the same server, mounted on phase 8's engine: 8
   greedy requests (two prompts of 1500 tokens) from 8 threads beside
   tower traffic on ``/predict``, each stream against the sequential
   ``generate`` under phase 8's rule, B11 12 per decode step, B7 12 per
   prefill at buckets >= 1024, slots and pages back to full, no error;
13. generation's capacity levers on phase 8's model and weights, each
   through ``load_generator`` and a ``ContinuousBatcher``: chunked
   prefill (chunks of 256) serving phase 8's 16 requests from 4 clients,
   no kernel of the eleven in a chunk step (the chunk attends densely, as
   in the reference), B11 12 per decode step, no B7 (every prompt over
   256 is chunked), ``forward_chunk``'s last row for the 1500-token
   prompt in chunks against the uncached forward within 1e-3 of
   max|logit|, TTFT p50/p99 of the short (<= 200) and long (1500)
   prompts beside phase 8's; speculative decoding (k 4) with a drafter
   by bench_generate.py's rule (6 blocks, hidden 384, 6 heads, the
   vocabulary; seed 1) on 8 greedy requests (prompts 17-1500 twice, 32
   new tokens): B11 24 per round (the drafter's steps; the verify is
   dense), 12 per plain step, B7 12 + 6 per bucket prefill >= 1024,
   the accept rate (below 1) and tokens per target forward, at least a
   median of 4 distinct tokens per greedy stream; 2 sampled requests
   (temperature 0.8: budgets, the vocabulary, their accept rate); a
   ``kill`` armed at
   ``generation/decode_step`` fails the request in a round, its pages
   return and the next request is served; the target drafting for
   itself on 2 requests, every rejection at a top-2 margin of the
   verify's logits within 1e-3 of max|logit|; then the prefill/decode
   handoff, a ``role="prefill"`` and a ``role="decode"`` engine with
   pools of their own, each blob through ``submit_prefill``, the wire
   codec and JSON, and ``submit_handoff``, 8 requests in f32 pools and
   2 in int8 pools: B7 12 per prefill >= 1024 on the prefill pool, B11
   12 per step on the decode pool, no page leaked, both pools back to
   full, blob bytes and the JSON hop's and the splice's p50/p99. Every
   stream of the phase is held to the sequential ``generate`` under
   phase 8's rule, each engine call's launches are checked one by one,
   and the host ms of the chunk step, the decode step and the round are
   printed;
14. the Estimator's training surface on bench.py's flagship step
   (``resnet50(space_to_depth=True, fused="defer")``, 224x224, 1000
   classes, ``mixed_bfloat16`` from ``ZOO_TPU_DTYPE_POLICY``, batch 128,
   SGD 0.1 momentum 0.9) through ``compile``/``fit``: 3 epochs of 4
   steps with 256 held-out images validated every epoch, async
   checkpoints every 4 steps, clipping by global L2 norm, an injected
   recording TensorBoard writer, the ``LearningRate`` summary trigger and
   a profile of steps 3-5. Checked: launches per step (B1 36 with 8
   in_residual, B2 16, B3 36 with 8 dr, B4 36) and per validation batch
   (B5 36, B6 16), finite losses and validation metrics, ``val_*`` and
   ``goodput`` in the history (shares summing to 1), the summary tags,
   the profile's trace naming B1-B4, the device-memory gauges, the
   checkpoints written; the validation logits (fused, bf16) within a
   tenth of their spread over 256 images of stepped brightness of the
   unfused f32 graph's, and that bound failed by a batch-stride fault
   put into B6's output (two smaller faults printed); the step's FLOPs
   (``perf/flops.py``, counted inside the first step) within 5% of
   ``TRAIN_FLOP_PER_IMAGE`` x 128 and within 1% of the unfused graph's
   count (cuDNN/cuBLAS). Then
   resume: 8 steps against 4, ``save_checkpoint``, a fresh model and
   ``load_checkpoint`` (the state bit for bit) and 4 more (bit-equal
   losses, or within 1e-3 relative with each training kernel's and the
   stem's repeatability printed); the checkpoint's bytes and its write
   ms synchronous and async; an ``error`` armed at
   ``estimator/checkpoint_write`` under an async write raises at the
   wait, ``LATEST`` keeps the good file and a resume from it runs. Then
   one step of AdamW, RMSprop, Adagrad, Adadelta and Adamax on a small
   dense net against the CPU port (1e-6 relative), and the phase
   backward (``ops/conv_grad.py``) against cuDNN's strided backward at
   the unfused ResNet-50's strided convs (batch 128, bf16: gradients
   within 2e-2 of max|grad|, ms of each). Printed: images/s per epoch,
   the ledger's shares and MFU beside phase 5's model-FLOPs MFU;
15. image classification, at 224x224 and 1000 classes (LeNet-5 at
   28x28x1 and 10), no kernel of the eleven on the path (every count 0):
   LeNet-5 as ``examples/lenet_mnist.py`` trains it on ``datasets.
   mnist``'s synthetic stand-in (images/s; one epoch at dropout 0 held
   to the CPU port, losses 1e-4 relative); Inception-v1 served by
   ``InferenceModel`` in f32 and bf16 at batch 1, 8 and 32 (images/s,
   device busy share) and its logits at batch 4 held to the CPU port's
   (f32 1e-3, bf16 5e-2 of max(1, max|logit|), each bound below the
   logits' spread over the images, the head scaled so the logits reach
   10); trained through ``compile``/``fit`` (``mixed_bfloat16``, batch
   128, 3 epochs of 5 steps: images/s, the ledger's FLOPs per step and
   MFU, a profile of 3 steps) and one f32 step at batch 4 held to the
   CPU port (loss 1e-4, the head's and the last block's updates);
   transfer learning as ``examples/transfer_learning.py`` does it on
   Inception-v1 (frozen trainable leaves bit for bit, frozen BNs'
   moving statistics moved, the head moved); VGG-16/19, MobileNet,
   MobileNet-v2, DenseNet-121 and SqueezeNet: a bf16 forward at batch 32
   timed, f32 logits at batch 2 held to the CPU port, and one f32 step
   of MobileNet-v2 and DenseNet-121 at batch 2 (loss 1e-4);
16. text, no kernel of the eleven on the path (every count 0): the
   TextSet pipeline over a synthetic 20-class corpus of 2560 documents
   (host ms per stage); ``TextClassifier`` at 20 Newsgroups' widths
   (sequence 500, embedding 200 over 5000 words, encoder 256, 20
   classes) with each encoder (cnn, lstm, gru) trained through
   ``compile``/``fit`` at batch 128 in f32 and ``mixed_bfloat16`` (2
   epochs of 5 steps: samples/s, ms per step, peak memory, a profile of
   3 steps) and served by ``InferenceModel`` at batch 1 and 128; held to
   the CPU port: f32 probabilities at batch 4 (1e-4, the head scaled so
   the logits reach 10, the bound below half the probabilities'
   spread), two f32 Adam steps at batch 4 and dropout 0 (losses 1e-4
   relative), bf16 against f32 on the pre-embedded input (5e-2); the
   recurrent layers' time loop run under ``set_sync_debug_mode
   ("error")``. KNRM at its defaults (10 + 40 ids over 20000, embed 300,
   21 kernels) trained with ``rank_hinge`` at batch 256 in f32 (pairs/s)
   and held to the CPU port (scores at batch 8, two steps); the
   AnomalyDetector at its defaults on windows of 50 x 3 at batch 1024
   (samples/s), its predictions held to the CPU port;
17. Seq2seq and SSD300-VGG16, no kernel of the eleven on the path
   (every count 0): Seq2seq at 3+3 LSTM layers of 1024, a dense bridge,
   one-hot input over 10,000 words and a softmax generator, sequence 30
   (the scale of Sutskever et al. 2014's LSTMs), trained through
   ``compile``/``fit`` (Adam, batch 64) in f32 and ``mixed_bfloat16``
   (samples/s, ms per step, peak memory, a profile of 3 steps); greedy
   ``infer`` and ``generate_tokens`` at batch 1 and 64 (ms per token,
   tokens/s; the token loops under ``set_sync_debug_mode("error")``) and
   ``infer_beam`` at beam 4; held to the CPU port: f32 probabilities at
   batch 4 (1e-4, below half their spread, the generator scaled), two
   f32 Adam steps (losses 1e-4 relative), and the greedy ids equal to a
   host loop of full re-forwards on the card. SSD300-VGG16 at VOC's 21
   classes served through ``ObjectDetector.detect`` at batch 1, 8 and 32
   in f32 and bf16 (images/s, the network's time and
   ``DetectionOutput``'s host time, device busy share); its flat output
   at batch 2 held to the CPU port (f32 1e-3, bf16 5e-2 of max(1,
   max|out|), below half the outputs' spread) with the same detections;
   ``MultiBoxLoss`` at 8732 priors (value 1e-5 relative, gradient 1e-5
   of its largest) and the device ``nms`` (``_nms_numpy``'s choice);
   trained through ``compile_detection``/``fit`` (``mixed_bfloat16``,
   SGD 1e-3 momentum 0.9, batch 32, 2 epochs of 5 steps: images/s, the
   ledger's FLOPs per step and MFU, peak memory, a profile of 3 steps)
   and one f32 step at batch 2 held to the CPU port (losses 1e-4);
18. the image data path, with no PIL on it: 512 seeded 257x257x3
   images as raw pixel bytes through ``ImagePixelBytesToMat``,
   ``ImageHFlip``, ``ImageBrightness``, ``ImageSaturation``,
   ``ImageChannelNormalize``, ``ImageMatToTensor`` and
   ``ImageSetToSample`` (host images/s per stage), then
   ``to_feature_set`` in the DRAM, DIRECT and PMEM tiers (each tier's
   ``iter_batches`` images/s at batch 128; PMEM's arena removed after);
   ``examples/resnet_imagenet.py``'s augment (random resized crop to
   224x224, flip, brightness, saturation, normalisation) at batch 128,
   one call under ``set_sync_debug_mode("error")``, its device ms (the
   median of 21 CUDA-event timings), each op held to the CPU port's
   ``apply`` on the same draws (the flip bit for bit, the rest within
   1e-3); the recipe at full width (224, batch 128, 1000 classes, the s2d
   stem, ``fused="defer"``, ``mixed_bfloat16``, 512 synthetic images, 2
   epochs of 4 steps) with the augment and with ``augment=None`` on
   host-cropped data (B1-B4's launches per step, 36/16/36/36 with 8
   ``in_residual`` and 8 dr; images/s per epoch, the ledger's FLOPs per
   step and MFU, peak memory; the augment's FLOPs equal to its two
   products), ``fit`` from arrays against a ``FeatureSet`` in turns, and
   the ``rdd_ingest`` and ``image_classification`` examples;
19. the observability plane's judgement layer, on one ``InferenceServer``
   (ResNet-50 bf16 with ``fused=True`` behind a ``DynamicBatcher`` of
   buckets up to 32, and a GPT-1-width generator) with the SLO ticker at
   1 s, the event log rotating at 1 KB and the earlier phases' heap
   frozen out of the garbage collector's scans: 100 ``/predict`` of one
   image from one client leave every serving objective ``ok`` or
   ``no_data``; 48 requests of 3 images from 8 clients are judged
   against ``serving_latency_p99`` as shipped (a breach counted once,
   its anomaly once, both unmoved over 5 further ticks; the engine's p99
   in the bucket of the clients' p99 ranked as the engine ranks, over
   the requests of its window); ``/debug/metrics/history``'s deltas and
   counts equal the 48 requests exactly, and a bad window answers 400;
   8 ``/generate`` of 1700 + 256 tokens (a B7 prefill each) drain the
   page pool while the ``kv_pages`` ETA is finite, back to 1e9 once idle
   (the forecaster's window 15 s); ``/debug/dashboard`` serves the
   port's page; ``POST /debug/profile`` answers 200, then 503 during the
   capture, and the ``torch.profiler`` trace names B5's and B6's CUDA
   kernels; an armed ``batcher/dispatch`` fault gives one 500 with its
   ``faults/armed`` and ``faults/injected`` records; a
   ``TelemetryCollector`` over this server's URL merges its counters
   (twice ``/metrics/json``'s: the router's source is this process),
   advances the trace cursor with no span repeated and stitches a
   traced request's spans; the host costs of an engine tick, a history
   sample and a collector tick (medians of 21); the launches (B5/B6 36
   and 16 per bucket execution, B11 12 per decode step, B7 12 per
   prefill); then ``Estimator.train`` on the flagship (6 steps at batch
   128: B1-B4 36/16/36/36 per step) installs the training objectives,
   and the event log's segments and bytes gauge match the disk.
   ``python3 chip_smoke.py --plane`` runs phases 1, 2 and 19 only;
20. nnframes: BASELINE's metric, "nnframes ResNet-50 images/sec/chip",
   on bench.py's flagship (s2d stem, ``fused="defer"``, batch 128,
   ``mixed_bfloat16``, SGD 0.1 momentum 0.9): 512 rows of seeded uint8
   images in a pandas DataFrame, normalised by ``ArrayToTensor >>
   FnPreprocessing``, ``NNClassifier.fit`` for 2 epochs of 4 steps
   (B1-B4 36/16/36/36 per step, 8 ``in_residual`` and 8 dr) and
   ``NNClassifierModel.transform`` at batch 128 (B5/B6 36/16 per
   forward); the rows' host ms to a ``FeatureSet``, the median step's
   images/s and MFU from the Estimator's own ``train/step`` traces
   (host clock, ``ZOO_TPU_TRACE_SYNC=1``: a card sync per step),
   transform images/s; the prediction column held to the argmax
   of ``Estimator.predict`` with the same weights, and the fit's weights
   to ``Estimator.train`` of the same initial weights over the same
   arrays (2e-2 of max(1, max|w|); it reads bit for bit). Then the
   dogs-vs-cats app at BASELINE's configuration (Inception-v1 at 224, 2
   classes, every layer but the head frozen, ``--in-memory``): the
   frozen weights bit for bit, fit and transform images/s; then the
   slice's apps and examples at their defaults (``bert_finetune`` at
   BERT-base widths, T 128), each held to its CPU test's assertion.
   ``python3 chip_smoke.py --nnframes`` runs phases 1, 2 and 20 only;
21. the serving fleet (``pipeline/inference/fleet.py``,
   ``registry.py``): two in-process ResNet-50 bf16 replicas (seed 0,
   buckets up to 32) behind ``make_fleet_server`` (the stdlib front
   end, ``prefer_native=False``), the two sharing the
   one card: 64 ``/predict`` of 1-4 images from 8 clients, each reply
   bit for bit its bucket's rows, each bucket bit for bit its replica's
   ``predict`` at that bucket (and the other replica's), each reply
   within 5e-2 of max(1, max|logit|) of the request predicted alone; the
   router's host ms per dispatch (median of 21); one payload on one
   replica under ``hash``; ``fleet/replica_predict`` armed to kill r0
   mid-wave (all 200 and held, ``/debug/fleet`` shows r0 down, one
   ``tick`` re-admits it after healing, its probe one batch-8 forward,
   and it serves); both queues full behind wedged dispatchers (503,
   ``Retry-After``, the hint the minimum of the replicas'
   ``retry_hint_s``); the same load on one ``InferenceServer`` over the
   same model (p50/p99 beside the fleet's). Then a canary rollout from
   an in-memory ``ModelRegistry`` (v1 seed 0, v2 seed 1) under a load
   loop: an error burst on the canary rolls back, a clean re-roll
   promotes after its bake on the router's injected clock, the loop
   sees no failure, ``/debug/rollout`` reports both endings, and both
   replicas then serve a direct v2 forward's logits bit for bit. Then
   two ResNet-50 worker processes (``chip_smoke.py --fleet-worker
   resnet``, on the libraries phase 2 built) as ``HttpReplica``s: the
   collector's merged acked-request counter equals the router's own
   plus each worker's ``/metrics/json`` exactly, a worker SIGKILLed
   during a traced wave leaves every request 200 and within the bound,
   and a trace stitches the router's process and a worker's. Then
   ``DisaggRouter.for_engine`` on phase 8's GPT-1 (1 prefill, 2 decode
   engines): 8 greedy requests of 1024-1700-token prompts and 64 new
   tokens byte for byte a colocated ``ContinuousBatcher``'s, again with
   a decode replica poisoned mid-wave (no page leaked, every pool back
   to its total), TTFT and tokens/s beside the colocated ones, blob
   bytes and the splice; then the same over HTTP through 1 prefill and
   2 decode worker processes (``/generate/prefill``,
   ``/generate/handoff``), the prefill worker SIGKILLed mid-wave: every
   completed stream byte-exact, every failure a retryable transport
   error. The launches: B5/B6 36/16 per bucket execution of each
   in-process replica (and per probe forward), B7 12 per prefill, B11
   12 per decode step. Then ``apps/web_service_sample`` at its
   defaults. Every worker is SIGKILLed and reaped on every exit path,
   and exits when its parent does.
   ``python3 chip_smoke.py --fleet`` runs phases 1, 2 and 21 only;
22. the serving artifacts and the native front end
   (``InferenceModel.export_compiled``/``load_compiled``,
   ``ModelRegistry.register_export``, ``NativeInferenceServer``): the
   fleet's ResNet-50 (seed 0, distinctive BatchNorm statistics) exported
   in f32 and, through a ``ModelRegistry``, in bf16 (v1) and with seed 1
   (v2), each with a batch-32 example (bytes and seconds printed, beside
   ``load_keras_net`` and a first predict in process); a second process
   (``chip_smoke.py --artifact-worker``, on the libraries phase 2 built)
   loads the f32 and bf16 artifacts (timed), predicts batch 32 through
   ``program.pt2`` and batches 1, 8 and 32 through ``program_dyn.pt2``,
   each held to this process's eager predict (f32 1e-5, bf16 2e-2 of
   max(1, max|logit|); whether bit for bit printed), B5/B6 36/16 per
   forward counted there, each program's graph 36 and 16 operator nodes
   and nothing but aten and ``zoo_torch`` ops, and the f32 card artifact
   once on the CPU (1e-3); two replicas loaded from v1's artifact roll to
   v2's under a load loop (canary 50%, the bake on the router's clock)
   with no failure, each then v2's artifact's logits bit for bit;
   ``make_inference_server`` over the bf16 artifact must give a
   ``NativeInferenceServer``, driven with phase 12's HTTP load beside
   ``InferenceServer`` on the same model (p50/p99, images/s), ``/health``
   timed idle and with every worker held by a wedged dispatch, a trace id
   echoed, ``/metrics`` counting the requests. The worker is SIGKILLed
   and reaped on every exit path.
   ``python3 chip_smoke.py --artifact`` runs phases 1, 2 and 22 only;
23. model import (``pipeline/api/onnx``, ``net_load.py``): the unfused
   ResNet-50 (seed 0, distinctive BatchNorm statistics, its head scaled
   so the logits reach 10) written as an ONNX file with the port's
   ``helper`` (opset 13, NCHW; Conv, BatchNormalization, Relu, MaxPool,
   Add, GlobalAveragePool, Flatten, Gemm; ~100 MB) and loaded with
   ``OnnxLoader.load_model``; served through ``InferenceModel.
   load_keras_net`` at batches 1, 8 and 32 from two threads in f32, each
   within 1e-3 of max|logit| of the native net on the same weights and
   images (NHWC there), the batch-32 request timed beside the native
   unfused graph's; one f32 SGD step (0.01, momentum 0.9) at batch 8 held
   to the CPU's (the loss within 1e-4, the fc and the last block's
   initializers within 1e-5 of max|param| or twice the 1e-6 jitter), then
   three steps at batch 32 in f32 and under ``mixed_bfloat16`` (finite
   losses, the first bf16 loss within 2e-2 of the f32 one; ms per step
   and the device's busy share profiled); a Caffe LeNet-5 (prototxt and
   caffemodel), a BigDL ``.model`` and a ``torch.nn.Sequential`` conv
   net, each loaded through ``Net`` and served on the card within 1e-5 of
   its CPU run; ``ConvInteger``, ``MatMulInteger``, ``QLinearConv`` and
   ``QLinearMatMul`` on the card bit for bit the CPU's. No kernel of the
   eleven runs (``launches_import``, all 0).
   ``python3 chip_smoke.py --import`` runs phases 1, 2 and 23 only;
24. a ``{"kernels": [...]}`` JSON line (phase 19's launches as
   ``launches_plane`` and ``launches_plane_train``, phase 20's as
   ``launches_nnframes``, phase 21's as ``launches_fleet``, phase 22's
   second process's as ``launches_artifact``, phase 23's as
   ``launches_import``), then the card's name and power limit, then the
   result line ``{"ok": true, "device": {...}}``.

Phase 3 also holds the flash kernels (B7-B10) against their plain
versions at both BERT routes' shapes in f32 and bf16, and at dead key
tiles (samples of length 0, 1, 63, 64, 65, 129 and T), causal,
cross-length, dead-row and other head-dim cases, and the decode kernel
(B11) at the generation path's shape in f32 and bf16, reading one
block's pools in place through a permuted page table (f32, bf16 and
int8 pools, against gather_layer + dequantize_rows + the plain version)
and through the dense entry, with a slot that has no valid key, an
int8 cache and head dims 32 to 256, repeating bit for bit, each output
within 1e-3 (f32) or 2e-2 (bf16) of its own max|plain| (no floor at
1), with ``F.scaled_dot_product_attention`` timed beside them as the
library yardstick (never called by the port; its backward stands on
B9's row for the B9 + B10 pair, and B10's is null). It prints the route
and tile each flash kernel took (``fwd_route``/``fwd_tile`` for B7 and
B8, ``bwd_route``/``bwd_tile`` for B9 and B10). Every f32 flash kernel
(at D 64 and 128 three TF32 passes) meets an accuracy gate at every f32
case (:func:`flash_gate`): against its plain version run in float64 on
the same inputs, each output's max|error| (o; acc, m and l; dk, dv; dq)
at most twice the f32 plain version's plus one f32 ulp of the output's
max|float64|, plain TF32 the control that must fail; its bound is
max(bytes / 3.35 TB/s, min(FLOP / 67 TFLOP/s, 3 FLOP / 495 TFLOP/s))
(:func:`flash_passes`), the term named. The build phase checks that
the wrapper's route, tile and shared memory per head dim and dtype are
the library's (``fwd_config_on_card``, ``bwd_config_on_card``) and that
the backward's D-64 instances spill nothing.

Every kernel, plain and library time is the median of five windows of
CUDA events (:func:`time_window`), each kernel's with its min and max.
f32 comparisons run with TF32 off in both cuBLAS and cuDNN. Details go
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import zipfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
TRAIN_BATCH = 128
TRAIN_STEPS = 5
IMAGE = (224, 224, 3)
# ResNet-50 model FLOPs per trained image: 3 x 2 x 4.09 GMAC
TRAIN_FLOP_PER_IMAGE = 3 * 2 * 4.09e9
# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32 = 495e12     # tensor cores, tf32 (dense)
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-3, "bfloat16": 2e-2}
KERNELS = {
    "matmul_bn_apply": {
        "source": "analytics_zoo_tpu_torch/csrc/matmul_bn_apply.cu",
        "replaces": "analytics_zoo_tpu/ops/conv_bn.py:747",
        "path": "serve", "per_path": 36},
    "conv3x3_bn_apply": {
        "source": "analytics_zoo_tpu_torch/csrc/conv3x3_bn_apply.cu",
        "replaces": "analytics_zoo_tpu/ops/conv_bn.py:1005",
        "path": "serve", "per_path": 16},
    "matmul_bn": {
        "source": "analytics_zoo_tpu_torch/csrc/matmul_bn.cu",
        "replaces": "analytics_zoo_tpu/ops/conv_bn.py:201",
        "path": "train", "per_path": 36},
    "conv3x3_bn": {
        "source": "analytics_zoo_tpu_torch/csrc/conv3x3_bn.cu",
        "replaces": "analytics_zoo_tpu/ops/conv_bn.py:1124",
        "path": "train", "per_path": 16},
    "matmul_bn_dx": {
        "source": "analytics_zoo_tpu_torch/csrc/matmul_bn_dx.cu",
        "replaces": "analytics_zoo_tpu/ops/conv_bn.py:518",
        "path": "train", "per_path": 36},
    "matmul_bn_dw": {
        "source": "analytics_zoo_tpu_torch/csrc/matmul_bn_dw.cu",
        "replaces": "analytics_zoo_tpu/ops/conv_bn.py:552",
        "path": "train", "per_path": 36},
    "flash_fwd": {
        "source": "analytics_zoo_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "analytics_zoo_tpu/ops/flash_attention.py:185",
        "path": "bert_eval", "per_path": 12,
        "library_is": "SDPA forward"},
    "flash_block": {
        "source": "analytics_zoo_tpu_torch/csrc/flash_block.cu",
        "replaces": "analytics_zoo_tpu/ops/flash_attention.py:544",
        "path": "bert_train", "per_path": 24,
        "library_is": "SDPA forward"},
    "flash_bwd_dkdv": {
        "source": "analytics_zoo_tpu_torch/csrc/flash_bwd_dkdv.cu",
        "replaces": "analytics_zoo_tpu/ops/flash_attention.py:421",
        "path": "bert_train", "per_path": 12,
        "library_is": "SDPA backward (dq, dk and dv): the yardstick of "
                      "the B9 + B10 pair, counted on this row only"},
    "flash_bwd_dq": {
        "source": "analytics_zoo_tpu_torch/csrc/flash_bwd_dq.cu",
        "replaces": "analytics_zoo_tpu/ops/flash_attention.py:455",
        "path": "bert_train", "per_path": 12,
        "library_is": "none alone: SDPA's backward stands on "
                      "flash_bwd_dkdv for the pair"},
    "flash_decode": {
        "source": "analytics_zoo_tpu_torch/csrc/flash_decode.cu",
        "replaces": "analytics_zoo_tpu/ops/flash_attention.py:655",
        "path": "generate", "per_path": 12,
        "library_is": "SDPA with a boolean mask at (S, H, 1, T), on the "
                      "dense view (its gather not timed)"},
}
FLASH = ("flash_fwd", "flash_block", "flash_bwd_dkdv", "flash_bwd_dq")
PATHS = {"serve": f"one batch-{BATCH} bf16 forward",
         "train": f"one batch-{TRAIN_BATCH} bf16 train step",
         "bert_train": "one f32 BERT-base train step (batch 16, T 512, "
                       "remat)",
         "bert_eval": "one f32 BERT-base eval batch (batch 16, T 512)",
         "generate": "one f32 GPT-1 decode step at 8 slots (T 2048, the "
                     "paged path case's lengths)"}
# the path each kernel's summary times are summed over: B1-B6 bf16,
# B7-B11 f32 (the Estimator's route, the generation path; bf16 beside
# it under by_dtype)
HEAD_DTYPE = {name: "float32" if name in FLASH + ("flash_decode",)
              else "bfloat16" for name in KERNELS}
# GPT-1's widths (openai-gpt) at a 2048-token context, the reference
# TransformerLayer's defaults, served by 8 slots of 16-token pages
GPT = dict(n_block=12, hidden_size=768, n_head=12, vocab=40990,
           hidden_p_drop=0.0, attn_p_drop=0.0, embed_p_drop=0.0)
GEN_T, GEN_SLOTS, GEN_PAGE = 2048, 8, 16
GEN_PROMPTS = (17, 200, 700, 1500)
GEN_REQUESTS, GEN_CLIENTS = 16, 4
# the teacher-forced slots' prompt lengths (one >= 1024: bucket 2048)
GEN_TF_LENS = (1500, 17, 200, 700, 1100, 33, 400, 1023)
BERT = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
            intermediate_size=3072, n_token_types=2)
BERT_T, BERT_BATCH, BERT_STEPS = 512, 16, 5
BENCH_T, BENCH_BATCH = 128, 32
# bench_ncf.py's NeuralCF (the reference's ml-1m NCF example) and batch
NCF = dict(user_count=6040, item_count=3706, num_classes=5, user_embed=20,
           item_embed=20, hidden_layers=(40, 20, 10), mf_embed=20)
NCF_BATCH, NCF_STEPS = 8192, 20
# the serving front end (phase 12): bench_serving.py's size mix and
# closed-loop clients; ResNet-50 requests per dtype, the tower's window,
# the /generate requests
HTTP_MIX = (1, 1, 1, 2, 1, 4, 1, 2)
HTTP_CLIENTS, HTTP_REQUESTS, HTTP_GEN = 8, 48, 8
TOWER_SECONDS = 4.0
# generation's capacity levers (phase 13): bench_generate.py's flags
# (--prefill-chunk, --spec-k, --disagg) on phase 8's model; the drafter
# by its rule, "half-width, half-depth ... sharing the vocabulary"
# (bench_generate.py:131-139); the handoff in f32 and int8 pools
LEVER_CHUNK, LEVER_SPEC_K, SPEC_NEW = 256, 4, 32
DRAFT = dict(GPT, n_block=6, hidden_size=384, n_head=6)
# the generation models' token embeddings are scaled down from their
# seeded init: with tied logits and the init's scale, the residual
# stream is mostly the input token's own embedding and every greedy
# stream repeats one token. At 0.1 the blocks' outputs lead, greedy
# streams vary (22-24 distinct tokens in 24 on the CPU at GPT-1 widths)
# and a random drafter is rejected
GEN_EMBED_SCALE = 0.1
HANDOFF_F32, HANDOFF_INT8 = 8, 2
DEV = "cuda"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def reset_launches() -> None:
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    cb.reset_launches()
    fa.reset_launches()


def all_launches() -> dict:
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    return {**cb.launches, **fa.launches}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _ms(t) -> str:
    return "none" if t is None else f"{t:.4f} ms"


def time_window(fn, iters: int = 10, warmup: int = 3, windows: int = 5):
    """Device milliseconds per call of ``fn``: ``(median, min, max)`` over
    ``windows`` windows of ``iters`` calls each, timed by CUDA events,
    after ``warmup``. Before each window a spin kernel holds the stream
    while the calls are enqueued (for twice the slowest of two host
    passes), so the events time the device's work and not the host's
    launch cost, which dominates small kernels. A window above 1.5x the
    median (the host stalled past the spin while it enqueued) is timed
    again, up to twice, and its lowest reading kept."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    host_s = 0.0
    for _ in range(2):
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_s = max(host_s, time.perf_counter() - t)

    def window() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * host_s * 2e9))      # cycles at ~2 GHz
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    times = [window() for _ in range(windows)]
    med = statistics.median(times)
    for i, t in enumerate(times):
        for _ in range(2):
            if times[i] <= 1.5 * med:
                break
            times[i] = min(times[i], window())
    return statistics.median(times), min(times), max(times)


def timed(fn, **kw) -> dict:
    """A kernel record's timing entries: the median ms of
    :func:`time_window` and its windows' min and max."""
    med, lo, hi = time_window(fn, **kw)
    return {"ms": med, "ms_spread": [lo, hi]}


def _spread(rec) -> str:
    lo, hi = rec["ms_spread"]
    return f" [{lo:.4f}-{hi:.4f}]"


def time_ms(fn, iters: int = 10, warmup: int = 3) -> float:
    """The median of :func:`time_window`: what every bound ratio and
    A/B reads."""
    return time_window(fn, iters, warmup)[0]


def fused_blocks(model):
    """``(block, input shape, consumes a pending input)`` for every fused
    bottleneck of a ResNet in order: each FusedBottleneck layer, and
    each block inside a FusedStage, where a block consumes its
    predecessor's deferred tail in training if the predecessor defers
    (``stage_defers``)."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        FusedBottleneck, FusedStage)
    from analytics_zoo_tpu_torch.models.image.imageclassification.resnet \
        import stage_defers
    for lyr in model.layers:
        if isinstance(lyr, FusedBottleneck):
            yield lyr, lyr.input_shape, False
        elif isinstance(lyr, FusedStage):
            shape, pending = lyr.input_shape, False
            for blk, defers in zip(lyr.blocks, stage_defers(lyr.blocks)):
                yield blk, shape, pending
                shape, pending = blk.compute_output_shape(shape), defers


def path_shapes(model, batch):
    """Distinct kernel shapes of one forward of a fused ResNet, each with
    its launch count: B5 keys (B, H, W, K, N, stride, residual, relu),
    B6 keys (B, H, W, Cin, Cout, stride)."""
    b5, b6 = collections.Counter(), collections.Counter()
    for lyr, (h, w, c), _ in fused_blocks(model):
        f, s = lyr.filters, lyr.stride
        ho, wo = -(-h // s), -(-w // s)
        b5[(batch, h, w, c, f, 1, False, True)] += 1           # c1
        b6[(batch, h, w, f, f, s)] += 1                         # c2
        b5[(batch, ho, wo, f, 4 * f, 1, True, True)] += 1      # c3
        if lyr.downsample:
            b5[(batch, h, w, c, 4 * f, s, False, False)] += 1  # down
    return b5, b6


def kernel_cases(b5, b6):
    """(kernel, key, x dtype, weight dtype, prologue, launches per
    forward) for every serving-path shape in both dtypes, B5 (both x
    dtypes) and B6 (bf16) at serving's batch 1 and 8 too, and prologue
    cases (the serving path runs none), B5's with bf16 weights (B1's
    kernel with the fold epilogue for a bf16 x, the one-pass tf32 route
    for an f32 x)."""
    cases = []
    for dt in ("float32", "bfloat16"):
        # the model keeps f32 weights: the 1x1 fold multiplies in the
        # weights' type, the 3x3 fold in the activations'
        cases += [("matmul_bn_apply", k, dt, "float32", False, n)
                  for k, n in sorted(b5.items())]
        cases += [("conv3x3_bn_apply", k, dt, dt, False, n)
                  for k, n in sorted(b6.items())]
    # B5 and B6 at serving's other batches (B6's tile follows M)
    for bs in (1, 8):
        for dt in ("float32", "bfloat16"):
            cases += [("matmul_bn_apply", (bs,) + k[1:], dt, "float32",
                       False, 0) for k in sorted(b5)]
        cases += [("conv3x3_bn_apply", (bs,) + k[1:], "bfloat16",
                   "bfloat16", False, 0) for k in sorted(b6)]
    cases.append(("matmul_bn_apply", (BATCH, 28, 28, 512, 128, 1, True,
                                      True), "float32", "float32", True, 0))
    for dt in ("bfloat16", "float32"):
        cases.append(("matmul_bn_apply", (BATCH, 28, 28, 512, 128, 1, True,
                                          True), dt, "bfloat16", True, 0))
    cases.append(("conv3x3_bn_apply", (BATCH, 28, 28, 128, 128, 1),
                  "bfloat16", "bfloat16", True, 0))
    return cases


def run_case(case, gen, timing=True):
    """Kernel vs plain version on the card; returns the case's record
    (without its times and bound where ``timing`` is False)."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    name, key, dt, wdt, prologue, per_path = case
    dev = torch.device("cuda")
    xdt, wdtype = getattr(torch, dt), getattr(torch, wdt)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) *
                scale).to(dtype)

    if name == "matmul_bn_apply":
        b, h, w, k, n, stride, has_res, relu = key
        ksize, cin, cout = 1, k, n
    else:
        b, h, w, cin, cout, stride = key
        ksize, has_res, relu = 3, False, True
    ho, wo = -(-h // stride), -(-w // stride)
    m = b * ho * wo
    x = randn(b, h, w, cin, dtype=xdt)
    wt = randn(ksize, ksize, cin, cout, scale=(ksize * ksize * cin) ** -0.5,
               dtype=wdtype)
    os_ = 1.0 + randn(cout, scale=0.1)
    ot = randn(cout, scale=0.1)
    s = 1.0 + randn(cin, scale=0.1) if prologue else None
    t = randn(cin, scale=0.1) if prologue else None
    res = randn(b, ho, wo, cout, dtype=xdt) if has_res else None
    fold = dict(in_scale=s, in_shift=t, relu_in=prologue, out_scale=os_,
                out_shift=ot, relu_out=relu)
    if name == "matmul_bn_apply":
        def kernel():
            return cb.conv1x1_bn_apply(x, wt, stride=stride, residual=res,
                                       **fold)
        x2 = x[:, ::stride, ::stride].reshape(m, k)
        w2 = wt[0, 0]

        def plain():
            return cb.matmul_bn_apply_ref(
                x[:, ::stride, ::stride].reshape(m, k), w2, s, t, os_, ot,
                None if res is None else res.reshape(m, n), prologue,
                prologue, relu).reshape(b, ho, wo, n)
        a_lib = x2.to(wdtype).contiguous()

        def library():
            return torch.matmul(a_lib, w2)
        flops = 2.0 * m * k * n
        nbytes = (m * k + m * n * (2 if has_res else 1)) * x.element_size() \
            + k * n * wt.element_size()
    else:
        def kernel():
            return cb.conv3x3_bn_apply(x, wt, stride=stride, **fold)

        def plain():
            return cb.conv3x3_bn_apply_ref(x, wt, s, t, os_, ot, prologue,
                                           prologue, relu, stride)
        pt, pb, _ = cb.tf_same_pads(h, 3, stride)
        pl, pr, _ = cb.tf_same_pads(w, 3, stride)
        xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous(
            memory_format=torch.channels_last)
        wl = wt.to(xdt).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            return F.conv2d(xp, wl, stride=stride)
        flops = 2.0 * m * 9 * cin * cout
        nbytes = (b * h * w * cin + m * cout) * x.element_size() + \
            9 * cin * cout * x.element_size()
    # the 1x1 fold multiplies in the weights' type, the 3x3 fold in x's.
    # An f32-accurate product's least time on this card is the smaller
    # of f32 FMA (67 TFLOP/s) and the tf32 passes it needs (495 TFLOP/s).
    cdt = wdt if name == "matmul_bn_apply" else dt
    flop_ms = flops / PEAK_FLOPS[cdt] * 1e3
    term = "bf16 tensor cores" if cdt == "bfloat16" else "f32 FMA"
    passes = fold_passes(dt, prologue)
    if cdt == "float32" and name == "matmul_bn_apply" and \
            passes * flops / PEAK_TF32 < flops / PEAK_FLOPS["float32"]:
        flop_ms, term = passes * flops / PEAK_TF32 * 1e3, f"{passes}xTF32"
    nbytes += 4 * 2 * (cout + (cin if prologue else 0))
    y, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(tuple(y.shape) == (b, ho, wo, cout) and y.dtype == xdt,
          f"{name} {key}: got {tuple(y.shape)} {y.dtype}")
    check(bool(torch.isfinite(y.float()).all()), f"{name} {key}: non-finite")
    err = (y.float() - ref.float()).abs().max().item()
    scale = max(1.0, ref.float().abs().max().item())
    rec = {"kernel": name, "key": list(key), "dtype": dt, "w_dtype": wdt,
           "prologue": prologue, "per_path": per_path,
           "max_abs_err": err, "tol": TOL[dt] * scale}
    if timing:
        rec.update(**timed(kernel), plain_ms=time_ms(plain),
                   library_ms=time_ms(library), flops=flops, bytes=nbytes,
                   flop_ms=flop_ms, byte_ms=nbytes / PEAK_BYTES * 1e3)
        rec["bound_ms"] = max(rec["flop_ms"], rec["byte_ms"])
        rec["bound_by"] = "operations" if rec["flop_ms"] > rec["byte_ms"] \
            else "bytes"
        rec["bound_term"] = term if rec["bound_by"] == "operations" \
            else "bytes"
    gate = ""
    if name == "matmul_bn_apply" and wdt == "float32":
        # the f32 product's accuracy gate: against the fold in float64
        # from the same inputs, the kernel's max|error| at most twice the
        # plain version's (cuBLAS f32, TF32 off)
        y64 = fold64(x[:, ::stride, ::stride].reshape(m, k), w2, s, t, os_,
                     ot, None if res is None else res.reshape(m, n),
                     prologue, relu).reshape(b, ho, wo, n)
        e_k = (y.double() - y64).abs().max().item()
        e_p = (ref.double() - y64).abs().max().item()
        rec["gate"] = {"kernel_err": e_k, "plain_err": e_p,
                       "ratio": e_k / e_p if e_p else None}
        gate = f", vs f64 {e_k:.3e} (cuBLAS f32 {e_p:.3e})"
        check(e_k <= 2 * e_p, f"{name} {key} {dt}: max|err| against "
              f"float64 {e_k} > twice cuBLAS f32's {e_p}")
        if dt == "bfloat16":
            # a bf16 y hides the product's error from max|error|: count
            # the elements rounded to bf16 otherwise than the float64
            # fold, against cuBLAS f32's count and plain TF32's (the
            # control that must fail)
            y16 = y64.float().to(torch.bfloat16)
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = plain()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            n_k, n_p, n_t = (int((v != y16).sum().item())
                             for v in (y, ref, tf32))
            slack = 8 + y.numel() // 100000
            rec["gate"].update(misrounded=n_k, plain_misrounded=n_p,
                               tf32_misrounded=n_t)
            gate += f", misrounded {n_k} (cuBLAS f32 {n_p}, TF32 {n_t})"
            check(n_k <= 2 * n_p + slack and n_t > 2 * n_p + slack,
                  f"{name} {key} {dt}: bf16 misroundings {n_k}, cuBLAS "
                  f"f32 {n_p}, TF32 {n_t}")
    times = (f" kernel {rec['ms']:.4f}{_spread(rec)} ms, plain "
             f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} "
             f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_term']})"
             if timing else "")
    print(f"  {name} {dt}/{wdt}{' prologue' if prologue else ''} "
          f"{tuple(key)} x{per_path}: max|err| {err:.3e} "
          f"(tol {rec['tol']:.3e}){gate}{times}", flush=True)
    check(err <= rec["tol"], f"{name} {key} {dt}: max|err| {err} > "
          f"{rec['tol']}")
    return rec


def fold_passes(x_dtype: str, prologue: bool) -> int:
    """TF32 passes an f32-accurate 1x1 fold product with f32 weights
    needs: two where x is bf16 and there is no prologue (A is exact in
    TF32, so A_lo W_hi is zero), else three (A_lo W_hi + A_hi W_lo +
    A_hi W_hi)."""
    return 2 if x_dtype == "bfloat16" and not prologue else 3


def fold64(x, w, s, t, os_, ot, res, prologue, relu):
    """The 1x1 fold in float64 from the same inputs: the accuracy
    gate's reference for B5's f32 product."""
    import torch
    xd = x.double()
    if prologue:
        xd = torch.relu(xd * s.double() + t.double())
    y = xd @ w.double() * os_.double() + ot.double()
    if res is not None:
        y = y + res.double()
    return torch.relu(y) if relu else y


def train_shapes(model, batch):
    """Distinct training-kernel shapes of one train step of a fused
    ResNet (per-block or stage layout), each with its launch count per
    step: 1x1 keys (B, H, W, K, N, stride, prologue, residual) for B1 and
    its backward B3 + B4, 3x3 keys (B, H, W, Cin, Cout, stride) for B2
    (prologue always on). A c1 that consumes a deferred tail takes the
    previous bn3's fold and the residual in its prologue."""
    b1, b2 = collections.Counter(), collections.Counter()
    for lyr, (h, w, c), pending in fused_blocks(model):
        f, s = lyr.filters, lyr.stride
        ho, wo = -(-h // s), -(-w // s)
        b1[(batch, h, w, c, f, 1, pending, pending)] += 1      # c1
        b2[(batch, h, w, f, f, s)] += 1                         # c2
        b1[(batch, ho, wo, f, 4 * f, 1, True, False)] += 1     # c3
        if lyr.downsample:
            b1[(batch, h, w, c, 4 * f, s, False, False)] += 1  # down
    return b1, b2


def train_cases(b1, b2, deferred=()):
    """(kernel, key, dtype, launches per step) for every train-path shape
    in both dtypes, plus the in_residual prologue at every shape the
    deferred stage layout runs it (``deferred``) and at a ragged M (3
    images at 7x7); for B4 also K 64 / N 64 at a ragged M (its smallest
    tile) and K 2048 / N 512 with a residual and no affine; for B2 Cin
    128 and 256 at a small ragged M and stride 2 at an odd extent."""
    extra1 = sorted(set(deferred) | {(TRAIN_BATCH, 56, 56, 256, 64, 1,
                                      True, True)}) + \
        [(3, 7, 7, 2048, 512, 1, True, True)]
    extra4 = [(3, 7, 7, 64, 64, 1, True, False),
              (3, 7, 7, 2048, 512, 1, False, True)]
    extra2 = [(3, 7, 7, 512, 512, 1), (3, 9, 9, 128, 128, 1),
              (2, 10, 10, 256, 256, 1), (3, 7, 7, 256, 256, 2)]
    cases = []
    for dt in ("float32", "bfloat16"):
        for name in ("matmul_bn", "matmul_bn_dx", "matmul_bn_dw"):
            cases += [(name, k, dt, n) for k, n in sorted(b1.items())]
            cases += [(name, k, dt, 0) for k in extra1]
        cases += [("matmul_bn_dw", k, dt, 0) for k in extra4]
        cases += [("conv3x3_bn", k, dt, n) for k, n in sorted(b2.items())]
        cases += [("conv3x3_bn", k, dt, 0) for k in extra2]
    return cases


def run_train_case(case, gen, timing=True):
    """A training kernel vs its plain version on the card: every output
    (y and the two statistics; dx, ds, dt, dr; dW) within the dtype's
    tolerance of max(1, max|plain|). Returns the case's record (without
    its times and bound where ``timing`` is False)."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    name, key, dt, per_step = case
    dev = torch.device("cuda")
    xdt = getattr(torch, dt)
    esize = torch.tensor([], dtype=xdt).element_size()

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) *
                scale).to(dtype)

    if name == "conv3x3_bn":
        b, h, w, cin, cout, stride = key
        x = randn(b, h, w, cin, dtype=xdt)
        wt = randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
        s, t = 1.0 + randn(cin, scale=0.1), randn(cin, scale=0.1)
        sh = randn(cout, scale=0.1)
        pt, pb, ho = cb.tf_same_pads(h, 3, stride)
        pl, pr, wo = cb.tf_same_pads(w, 3, stride)
        m = b * ho * wo

        def kernel():
            return cb._conv3x3_bn_fwd(x, wt, s, t, sh, True, True, stride)

        def plain():
            return cb.conv3x3_bn_ref(x, wt, s, t, sh, True, True, stride)
        xp = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)).contiguous(
            memory_format=torch.channels_last)
        wl = wt.to(xdt).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            return F.conv2d(xp, wl, stride=stride)
        flops = 2.0 * m * 9 * cin * cout
        nbytes = (b * h * w * cin + m * cout + 9 * cin * cout) * esize + \
            4 * (2 * cin + 3 * cout)
        outs = ("y", "sum", "sumsq")
    else:
        b, h, w, k, n, stride, affine, res = key
        ho, wo = -(-h // stride), -(-w // stride)
        m = b * ho * wo
        x4 = randn(b, h, w, k, dtype=xdt)
        x2 = x4[:, ::stride, ::stride].reshape(m, k).contiguous()
        wt = randn(k, n, scale=k ** -0.5, dtype=xdt)
        s = 1.0 + randn(k, scale=0.1) if affine else None
        t = randn(k, scale=0.1) if affine else None
        r = randn(m, k, dtype=xdt) if res else None
        sh = randn(n, scale=0.1)
        vec_bytes = 4 * (2 * k * affine + 3 * n)
        if name == "matmul_bn":
            def kernel():
                return cb._matmul_bn_fwd(x4, wt, s, t, r, sh, stride,
                                         affine, affine)

            def plain():
                y, ssum, ssq = cb.matmul_bn_ref(
                    x4[:, ::stride, ::stride].reshape(m, k), wt, s, t, r,
                    sh, affine, affine)
                return y.reshape(b, ho, wo, n), ssum, ssq

            def library():
                return torch.matmul(x2, wt)
            nbytes = (m * k * (1 + res) + m * n + k * n) * esize + vec_bytes
            outs = ("y", "sum", "sumsq")
        else:
            y = randn(m, n, dtype=xdt)
            dy = randn(m, n, dtype=xdt)
            dsum, dsq = randn(n, scale=0.1), randn(n, scale=0.01)
            grads = (y, dy, dsum, dsq, affine, affine)
            g_lib = dy.contiguous()
            if name == "matmul_bn_dx":
                def kernel():
                    return cb._matmul_bn_dx(x2, wt, s, t, r, sh, *grads)

                def plain():
                    return cb.matmul_bn_dx_ref(x2, wt, s, t, r, sh, *grads)

                def library():
                    return torch.matmul(g_lib, wt.t())
                # x is read only for the prologue's mask and ds
                nbytes = (2 * m * n + m * k * (1 + (affine or res) +
                                               2 * res) + k * n) * \
                    esize + vec_bytes + 4 * 2 * k * affine
                outs = ("dx", "ds", "dt", "dr")
            else:
                def kernel():
                    return cb._matmul_bn_dw(x2, s, t, r, sh, *grads)

                def plain():
                    return cb.matmul_bn_dw_ref(x2, s, t, r, sh, *grads)

                def library():
                    return torch.matmul(x2.t(), g_lib)
                nbytes = (2 * m * n + m * k * (1 + res) + k * n) * esize + \
                    vec_bytes
                outs = ("dw",)
        flops = 2.0 * m * k * n
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    errs = {}
    for oname, a, b_ in zip(outs, got, want):
        if a is None and b_ is None:
            continue
        check(tuple(a.shape) == tuple(b_.shape) and a.dtype == b_.dtype,
              f"{name} {key} {oname}: got {tuple(a.shape)} {a.dtype}, "
              f"plain {tuple(b_.shape)} {b_.dtype}")
        check(bool(torch.isfinite(a.float()).all()),
              f"{name} {key} {oname}: non-finite")
        err = (a.float() - b_.float()).abs().max().item()
        tol = TOL[dt] * max(1.0, b_.float().abs().max().item())
        errs[oname] = (err, tol)
        check(err <= tol, f"{name} {key} {dt} {oname}: max|err| {err} > "
              f"{tol}")
    if name == "matmul_bn":
        # fixed-order sums: y and both statistics repeat bit for bit
        again = kernel()
        check(all(bool(torch.equal(a, b_)) for a, b_ in zip(got, again)),
              f"{name} {key} {dt}: a second launch differs")
    rec = {"kernel": name, "key": list(key), "dtype": dt, "w_dtype": dt,
           "prologue": name == "conv3x3_bn" or bool(key[6]),
           "per_path": per_step, "errors": errs,
           "max_abs_err": max(e for e, _ in errs.values())}
    times = ""
    if timing:
        rec.update(**timed(kernel), plain_ms=time_ms(plain),
                   library_ms=time_ms(library), flops=flops, bytes=nbytes,
                   flop_ms=flops / PEAK_FLOPS[dt] * 1e3,
                   byte_ms=nbytes / PEAK_BYTES * 1e3)
        rec["bound_ms"] = max(rec["flop_ms"], rec["byte_ms"])
        rec["bound_by"] = "operations" if rec["flop_ms"] > rec["byte_ms"] \
            else "bytes"
        times = (f"; kernel {rec['ms']:.4f}{_spread(rec)} ms, plain "
                 f"{rec['plain_ms']:.4f} ms, library "
                 f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f}"
                 f" ms ({rec['bound_by']})")
    print(f"  {name} {dt} {tuple(key)} x{per_step}: max|err| "
          + ", ".join(f"{o} {e:.2e}/{tl:.2e}" for o, (e, tl) in errs.items())
          + times, flush=True)
    return rec


def kernels_summary(records, launches):
    """Per kernel: its path's launches, the worst error over every case,
    and each time summed over one bf16 pass of its path (a batch-32
    forward for the eval folds, a batch-128 train step for the training
    kernels; f32 beside it under ``by_dtype``)."""
    out = []
    for name, meta in KERNELS.items():
        recs = [r for r in records if r["kernel"] == name]
        by_dtype = {}
        for dt in ("bfloat16", "float32"):
            on_path = [r for r in recs if r["dtype"] == dt and r["per_path"]]
            sums = {k: None if any(r[k] is None for r in on_path) else
                    sum(r[k] * r["per_path"] for r in on_path)
                    for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "flop_ms", "byte_ms")}
            sums["bound_by"] = "operations" if \
                sums["flop_ms"] > sums["byte_ms"] else "bytes"
            by_dtype[dt] = sums
        head = by_dtype[HEAD_DTYPE[name]]
        out.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "launches_per_path": meta["per_path"],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            **{k: meta[k] for k in ("library_is",) if k in meta},
            "times_are": "sum over " + PATHS[meta["path"]],
            "head_dtype": HEAD_DTYPE[name],
            "by_dtype": by_dtype})
    return out


def served_resnet():
    """ResNet-50 as phases 4 and 12 serve it: ``ImageClassifier(
    "resnet-50", fused=True)`` at 224x224 and 1000 classes on the
    context's card, its weights from the context's seed, with
    distinctive BatchNorm statistics and affine params (seed 1) so every
    fold matters."""
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier

    net = ImageClassifier("resnet-50", input_shape=IMAGE, classes=1000,
                          fused=True).model
    net.init_params()
    return distinct_bn(net, 1)


def distinct_bn(net, seed):
    """``net`` with its BatchNorm statistics and affine params drawn
    from ``torch.Generator().manual_seed(seed)``, so every fold
    matters."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for pname, buf in net.named_buffers():
            n = buf.shape[0]
            if pname.endswith("moving_mean"):
                buf.copy_(torch.randn(n, generator=g) * 0.1)
            elif pname.endswith("moving_var"):
                buf.copy_(torch.rand(n, generator=g) + 0.5)
        for pname, p in net.named_parameters():
            if pname.endswith("gamma"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape[0], generator=g))
            elif pname.endswith("beta"):
                p.copy_(0.1 * torch.randn(p.shape[0], generator=g))
    return net


def main_path(card, detail):
    """Phase 4: serve ResNet-50 through the port's entry points."""
    import numpy as np
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ImageClassifier, convert_resnet_params)
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    ctx = zoo.init_nncontext(seed=0)
    check(ctx.device.type == "cuda", f"context device {ctx.device}")
    t0 = time.perf_counter()
    net = served_resnet()
    im = InferenceModel(supported_concurrent_num=2).load_keras_net(net)
    print(f"  model built on {net.device} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rs = np.random.RandomState(0)
    images = {bs: rs.rand(bs, *IMAGE).astype(np.float32)
              for bs in (1, 8, BATCH)}
    requests = []
    for dt in (torch.float32, torch.bfloat16):
        for bs in (1, 8, BATCH):
            for rep in range(2):
                x = torch.from_numpy(images[bs]).to(ctx.device, dt)
                requests.append((dt, bs, rep, x))
    reset_launches()
    torch.cuda.synchronize()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(im.predict, r[3]) for r in requests]
        outs = [f.result() for f in futures]
    torch.cuda.synchronize()
    launches = all_launches()
    n_fwd = len(requests)
    print(f"  answered {n_fwd} requests from 2 threads; launches "
          f"{launches}", flush=True)
    for name, meta in KERNELS.items():
        want = meta["per_path"] * n_fwd if meta["path"] == "serve" else 0
        check(launches[name] == want,
              f"{name}: {launches[name]} launches for {n_fwd} forwards, "
              f"expected {want}")
    logits = {}
    for (dt, bs, rep, _), out in zip(requests, outs):
        check(out.shape == (bs, 1000) and np.isfinite(out).all(),
              f"bad logits {out.shape} for batch {bs} {dt}")
        logits[(dt, bs, rep)] = out

    # the port's unfused graph (cuDNN convs) on the same weights
    ref_clf = ImageClassifier("resnet-50", input_shape=IMAGE, classes=1000,
                              fused=False)
    ref = ref_clf.model
    ref.init_params()
    ref.load_params(convert_resnet_params(net.params(),
                                          params_to_numpy(ref)))
    checks = {}
    for bs in (1, 8, BATCH):
        want = ref.predict(images[bs], batch_size=BATCH)
        scale = max(1.0, float(np.abs(want).max()))
        for rep in range(2):
            got = logits[(torch.float32, bs, rep)]
            err = float(np.abs(got - want).max())
            checks[f"f32_vs_unfused_b{bs}_r{rep}"] = (err, 1e-3 * scale)
            f32 = logits[(torch.float32, bs, rep)]
            bf = logits[(torch.bfloat16, bs, rep)]
            err16 = float(np.abs(bf - f32).max())
            checks[f"bf16_vs_f32_b{bs}_r{rep}"] = (
                err16, 5e-2 * max(1.0, float(np.abs(f32).max())))
    for k, (err, tol) in checks.items():
        print(f"  {k}: max|err| {err:.4e} (tol {tol:.4e})", flush=True)
        check(err <= tol, f"{k}: {err} > {tol}")
    detail["logit_checks"] = checks

    rates, latency, profiles = {}, {}, {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        for bs in (1, BATCH):
            x = torch.from_numpy(images[bs]).to(ctx.device, dt)
            med, lo, hi = median_request_s(im, x)
            latency[f"{dname}_b{bs}_ms"] = med * 1e3
            latency[f"{dname}_b{bs}_ms_spread"] = [lo * 1e3, hi * 1e3]
            print(f"  {dname} batch {bs}: median {med * 1e3:.3f} ms per "
                  f"request ({lo * 1e3:.3f}-{hi * 1e3:.3f}), "
                  f"{bs / med:.1f} images/s on {card}", flush=True)
        rates[dname] = BATCH / (latency[f"{dname}_b{BATCH}_ms"] / 1e3)
        profiles[dname] = profile_requests(im, x)
    detail["images_per_s"] = rates
    detail["request_ms"] = latency
    detail["profile"] = profiles
    # the unfused graph (cuDNN convs, separate BN and ReLU) on the same
    # weights and requests: the serving half of MEASURED_WIN's evidence
    ref_im = InferenceModel(supported_concurrent_num=2).load_keras_net(ref)
    unfused = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        x = torch.from_numpy(images[BATCH]).to(ctx.device, dt)
        med, lo, hi = median_request_s(ref_im, x)
        unfused[f"{dname}_b{BATCH}_ms"] = med * 1e3
        unfused[f"{dname}_b{BATCH}_ms_spread"] = [lo * 1e3, hi * 1e3]
        print(f"  unfused {dname} batch {BATCH}: median {med * 1e3:.3f} ms "
              f"per request ({lo * 1e3:.3f}-{hi * 1e3:.3f}; fused "
              f"{latency[f'{dname}_b{BATCH}_ms']:.3f}) on {card}",
              flush=True)
    detail["unfused_request_ms"] = unfused
    return launches


def one_f32_step(ctx, net, x, y, w0=None):
    """One f32 ``Estimator.train`` step of ``net`` (from ``w0`` where
    given) on the first batch: its loss and the weights after it."""
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.pipeline.estimator import MaxIteration
    if w0 is not None:
        net.load_params(w0)
    est = train_estimator(ctx, net, "float32")
    res = est.train(x, y, batch_size=TRAIN_BATCH, end_trigger=MaxIteration(1))
    return res.history[-1]["losses"][0], params_to_numpy(net)


def train_estimator(ctx, net, policy):
    """bench.py's optimizer and loss: SGD 0.1 with momentum 0.9, softmax
    cross entropy."""
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    return Estimator(net, optimizer=SGD(lr=0.1, momentum=0.9),
                     loss="softmax_cross_entropy", dtype_policy=policy,
                     ctx=ctx)


def update_checks(label, got_after, ref_after, ref_jitter, ref_w0, sample,
                  bn_layers):
    """Sampled updated weights of a model (in the unfused graph's
    layout) against the unfused graph's after the same f32 step: the
    first step's gradient at random init is ill-conditioned in the early
    layers, so the unfused graph itself moves by several percent of an
    update there when its input moves by 1e-6 (relative); that movement,
    measured, bounds the difference. Moving statistics within 1e-4."""
    out = {}
    for layer, leaf in sample:
        want = ref_after[layer][leaf]
        noise = float(np.abs(ref_jitter[layer][leaf] - want).max())
        scale = float(np.abs(want - ref_w0[layer][leaf]).max())
        out[f"{label}_update_{layer}/{leaf}"] = (
            float(np.abs(got_after[layer][leaf] - want).max()),
            max(1e-3 * scale, 2.0 * noise))
    for layer in bn_layers:
        for leaf in ("moving_mean", "moving_var"):
            want = ref_after[layer]["_state"][leaf]
            out[f"{label}_{layer}/{leaf}"] = (
                float(np.abs(got_after[layer]["_state"][leaf] - want).max()),
                1e-4 * max(1.0, float(np.abs(want).max())))
    return out


def check_train_launches(launches, steps, what):
    for name, meta in KERNELS.items():
        want = meta["per_path"] * steps if meta["path"] == "train" else 0
        check(launches[name] == want,
              f"{what}: {name} {launches[name]} launches in {steps} steps, "
              f"expected {want}")


def timed_epochs(est, x, y, windows: int = 3) -> dict:
    """images/s of ``windows`` epochs of ``Estimator.train`` (each a
    timed window on the host clock, ending in a sync): the median and
    the min-max."""
    import torch
    rates = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t = time.perf_counter()
        est.train(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
        torch.cuda.synchronize()
        rates.append(len(x) / (time.perf_counter() - t))
    med = statistics.median(rates)
    return {"images_per_s": med, "images_per_s_spread": [min(rates),
                                                         max(rates)],
            "windows": rates, "step_ms": TRAIN_BATCH / med * 1e3,
            "mfu": med * TRAIN_FLOP_PER_IMAGE / PEAK_FLOPS["bfloat16"]}


def bf16_run(ctx, net, w0, x, y, label, card, profile=True):
    """The main path of one training configuration: ``mixed_bfloat16``
    from ``w0``, one epoch with the launches counted (returned, with its
    losses), then timed epochs and a profile."""
    import torch
    net.load_params(w0)
    est = train_estimator(ctx, net, "mixed_bfloat16")
    reset_launches()
    torch.cuda.synchronize()
    res = est.train(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    launches = all_launches()
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    residual = dict(cb.residual_launches)
    losses = res.history[-1]["losses"]
    print(f"  {label}: {len(losses)} bf16 steps at batch {TRAIN_BATCH}: "
          f"losses {[round(v, 4) for v in losses]}; launches {launches}",
          flush=True)
    check(len(losses) == TRAIN_STEPS, f"{label}: {len(losses)} steps taken")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    out = {"losses": losses, "residual_launches": residual,
           **timed_epochs(est, x, y)}
    lo, hi = out["images_per_s_spread"]
    print(f"  {label}: {out['step_ms']:.1f} ms per step, "
          f"{out['images_per_s']:.1f} images/s (median of "
          f"{len(out['windows'])} epochs; {lo:.1f}-{hi:.1f}), model-FLOPs "
          f"MFU {out['mfu']:.4f} (against 989 TFLOP/s) on {card}",
          flush=True)
    if profile:
        out["profile"] = profile_train_steps(est, x, y)
    return out, launches, est


def interleaved_epochs(ests, x, y, rounds: int = 3) -> dict:
    """images/s of each estimator's epochs timed in turns (A B B A ...,
    ``rounds`` epochs each), so the host's drift falls on both: the
    median and the min-max per estimator."""
    import torch
    rates = {k: [] for k in ests}
    order = list(ests)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ests[k].train(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
            torch.cuda.synchronize()
            rates[k].append(len(x) / (time.perf_counter() - t))
    return {k: {"images_per_s": statistics.median(v),
                "images_per_s_spread": [min(v), max(v)], "windows": v}
            for k, v in rates.items()}


def train_path(card, detail):
    """Phase 5: train ResNet-50 through the port's entry points; returns
    the kernels' launches over the bf16 run of the 7x7-stem fused model
    with the default prefetch."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        convert_resnet_params, resnet50)

    ctx = zoo.init_nncontext(seed=0)
    rs = np.random.RandomState(0)
    n = TRAIN_STEPS * TRAIN_BATCH
    x = rs.rand(n, *IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, size=(n, 1)).astype(np.int32)
    t0 = time.perf_counter()
    model = resnet50(input_shape=IMAGE, classes=1000, fused=True)
    model.init_params()
    w0 = params_to_numpy(model)
    print(f"  model built on {model.device} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    jitter = 1.0 + 1e-6 * np.random.RandomState(1).standard_normal(
        x.shape[1:]).astype(np.float32)

    # one f32 step, fused against the unfused graph (cuDNN convs, torch
    # BN) from the same weights on the same batch, and the unfused
    # graph's own movement under a 1e-6 input change
    loss32, fused_after = one_f32_step(ctx, model, x, y)
    ref = resnet50(input_shape=IMAGE, classes=1000, fused=False)
    ref.init_params()
    ref_w0 = convert_resnet_params(w0, params_to_numpy(ref))
    loss_ref, ref_after = one_f32_step(ctx, ref, x, y, ref_w0)
    _, ref_jitter = one_f32_step(ctx, ref, x * jitter, y, ref_w0)
    del ref
    torch.cuda.empty_cache()
    checks = {"f32_loss_vs_unfused": (abs(loss32 - loss_ref),
                                      1e-4 * max(1.0, abs(loss_ref)))}
    sample = [("stem", "kernel"), ("s0b0_c1", "kernel"),
              ("s1b0_c2", "kernel"), ("s1b0_down", "kernel"),
              ("s2b3_c3", "kernel"), ("s3b2_c1_bn", "gamma"),
              ("s3b2_c3_bn", "beta"), ("fc", "kernel")]
    bn_layers = ("s0b0_c1_bn", "s2b0_c2_bn", "s3b2_c3_bn")
    checks.update(update_checks(
        "f32", convert_resnet_params(fused_after, ref_after), ref_after,
        ref_jitter, ref_w0, sample, bn_layers))
    print(f"  f32 step 1: fused loss {loss32:.6f}, unfused {loss_ref:.6f}",
          flush=True)
    del ref_w0, ref_after, ref_jitter, fused_after

    # the main path: mixed_bfloat16 from the same starting weights, with
    # the default prefetch and with none (ZOO_TPU_PREFETCH=0)
    runs = {}
    for depth in ("default", "0"):
        label = f"7x7 fused, prefetch {depth}"
        if depth == "0":
            os.environ["ZOO_TPU_PREFETCH"] = "0"
        try:
            runs[depth], launches, fused_est = bf16_run(
                ctx, model, w0, x, y, label, card)
        finally:
            os.environ.pop("ZOO_TPU_PREFETCH", None)
        check_train_launches(launches, TRAIN_STEPS, label)
        if depth == "default":
            main_launches = launches
    losses = runs["default"]["losses"]
    checks["bf16_loss_vs_f32"] = (abs(losses[0] - loss32),
                                  5e-2 * max(1.0, abs(loss32)))
    # without prefetch, the same batches and arithmetic: the same losses
    # (cuDNN's stem backward may sum in another order)
    checks["bf16_prefetch_0_losses"] = (
        max(abs(a - b) for a, b in zip(runs["0"]["losses"], losses)),
        1e-3 * max(1.0, max(abs(v) for v in losses)))
    detail["train"] = {"prefetch_default": runs["default"],
                       "prefetch_0": runs["0"]}

    # the fused bottlenecks against the unfused graph (cuDNN convs,
    # separate BN and ReLU) on the same weights, the same bf16 main
    # path, then both timed in turns: the training half of
    # MEASURED_WIN's evidence
    ref = resnet50(input_shape=IMAGE, classes=1000, fused=False)
    ref.init_params()
    runs["unfused"], _, ref_est = bf16_run(
        ctx, ref, convert_resnet_params(w0, params_to_numpy(ref)), x, y,
        "7x7 unfused", card)
    ab = interleaved_epochs({"fused": fused_est, "unfused": ref_est}, x, y)
    for k, v in ab.items():
        lo, hi = v["images_per_s_spread"]
        print(f"  in turns, 7x7 {k}: {v['images_per_s']:.1f} images/s "
              f"(median of {len(v['windows'])} epochs; {lo:.1f}-{hi:.1f}) "
              f"on {card}", flush=True)
    detail["train"]["unfused"] = runs["unfused"]
    detail["train"]["fused_vs_unfused_in_turns"] = ab
    del ref, ref_est, fused_est
    torch.cuda.empty_cache()

    # bench.py's flagship: the space-to-depth stem, fused and the
    # deferred-apply stage layout, the latter on the former's weights
    del model
    torch.cuda.empty_cache()
    s2d = resnet50(input_shape=IMAGE, classes=1000, space_to_depth=True,
                   fused=True)
    s2d.init_params()
    s2d_w0 = params_to_numpy(s2d)
    defer = resnet50(input_shape=IMAGE, classes=1000, space_to_depth=True,
                     fused="defer")
    defer.init_params()
    defer_w0 = convert_resnet_params(s2d_w0, params_to_numpy(defer))
    ref = resnet50(input_shape=IMAGE, classes=1000, space_to_depth=True,
                   fused=False)
    ref.init_params()
    ref_w0 = convert_resnet_params(s2d_w0, params_to_numpy(ref))
    loss_f, s2d_after = one_f32_step(ctx, s2d, x, y, s2d_w0)
    loss_d, defer_after = one_f32_step(ctx, defer, x, y, defer_w0)
    loss_u, ref_after = one_f32_step(ctx, ref, x, y, ref_w0)
    _, ref_jitter = one_f32_step(ctx, ref, x * jitter, y, ref_w0)
    del ref
    torch.cuda.empty_cache()
    print(f"  s2d f32 step 1: fused loss {loss_f:.6f}, defer {loss_d:.6f}, "
          f"unfused {loss_u:.6f}", flush=True)
    checks["s2d_defer_f32_loss_vs_fused"] = (abs(loss_d - loss_f),
                                             1e-4 * max(1.0, abs(loss_f)))
    checks["s2d_fused_f32_loss_vs_unfused"] = (abs(loss_f - loss_u),
                                               1e-4 * max(1.0, abs(loss_u)))
    for label, after in (("s2d_fused", s2d_after), ("s2d_defer",
                                                    defer_after)):
        checks.update(update_checks(
            label, convert_resnet_params(after, ref_after), ref_after,
            ref_jitter, ref_w0, sample, bn_layers))
    del s2d_after, defer_after, ref_after, ref_jitter, ref_w0
    for label, net, w in (("s2d fused", s2d, s2d_w0),
                          ("s2d defer", defer, defer_w0)):
        key = label.replace(" ", "_")
        runs[key], launches, _ = bf16_run(ctx, net, w, x, y, label, card)
        check_train_launches(launches, TRAIN_STEPS, label)
        # the B1 and B3 launches given an in_residual, counted by the
        # wrappers: each consuming c1's forward and its dr, every step
        want = TRAIN_STEPS * sum(k_n for k, k_n in train_shapes(
            net, TRAIN_BATCH)[0].items() if k[7])
        got = runs[key]["residual_launches"]
        print(f"  {label}: in_residual launches {got} in {TRAIN_STEPS} "
              f"steps, expected {want} each", flush=True)
        check(want == (8 * TRAIN_STEPS if key == "s2d_defer" else 0) and
              got == {"matmul_bn": want, "matmul_bn_dx": want},
              f"{label}: in_residual launches {got}, expected {want} "
              f"of B1 and of B3")
        checks[f"{key}_bf16_loss_vs_f32"] = (
            abs(runs[key]["losses"][0] - loss_f),
            5e-2 * max(1.0, abs(loss_f)))
    detail["train"]["s2d_fused"] = runs["s2d_fused"]
    detail["train"]["s2d_defer"] = runs["s2d_defer"]
    detail["train"]["defer_residual_launches"] = \
        runs["s2d_defer"]["residual_launches"]
    del s2d, defer
    torch.cuda.empty_cache()

    for k, (err, tol) in checks.items():
        print(f"  {k}: |err| {err:.4e} (tol {tol:.4e})", flush=True)
    detail["train_checks"] = checks
    bad = [k for k, (err, tol) in checks.items() if not err <= tol]
    check(not bad, f"training checks failed: {bad}")
    detail["train_losses"] = {"f32_fused": loss32, "f32_unfused": loss_ref,
                              "s2d_f32": {"fused": loss_f, "defer": loss_d,
                                          "unfused": loss_u},
                              "bf16": losses}
    return main_launches


TRAIN_KERNEL_NAMES = (
    ("matmul_bn", r"matmul_bn_sm90_kernel<\d+, false|"
                  r"conv_bn_f32_kernel<[^,]+, 1, true>"),
    ("conv3x3_bn", r"conv3x3_bn(_s1)?_sm90_kernel<\d+, false>|"
                   r"conv_bn_f32_kernel<[^,]+, 3, true>"),
    ("matmul_bn_dx", r"matmul_bn_dx_sm90_kernel|conv_bn_dx_f32"),
    ("matmul_bn_dw", r"matmul_bn_dw_sm90_kernel|conv_bn_dw_f32"),
    ("colsum (B1-B4 second pass)", r"colsum_kernel"),
)
SERVE_KERNEL_NAMES = (
    ("matmul_bn_apply", r"matmul_bn_apply_sm90_kernel|"
                        r"matmul_bn_sm90_kernel<\d+, true"),
    ("conv3x3_bn_apply", r"conv3x3_bn(_s1)?_sm90_kernel<\d+, true>|"
                         r"conv_bn_f32_kernel<[^,]+, 3, false>"),
)


def profile_train_steps(est, x, y, steps: int = 3) -> dict:
    """Device time by kernel over one ``Estimator.train`` call of
    ``steps`` bf16 steps (its input pipeline's start included, as every
    epoch's), the port's kernels grouped by name (:func:`profile_steps`)."""
    from analytics_zoo_tpu_torch.pipeline.estimator import MaxIteration
    print("  profile bf16 train:", flush=True)
    out = profile_steps(
        lambda: est.train(x, y, batch_size=TRAIN_BATCH,
                          end_trigger=MaxIteration(est.step + steps)),
        1, TRAIN_KERNEL_NAMES, per=steps)
    out["batch"] = TRAIN_BATCH
    return out


def median_request_s(im, x, warmup: int = 3, iters: int = 10):
    """Host time of one ``predict`` (input on the card, logits back on
    the host) after warm-up: the median of ``iters`` requests, with
    their min and max."""
    import torch
    for _ in range(warmup):
        im.predict(x)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        im.predict(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times), min(times), max(times)


def profile_requests(im, x, n: int = 3) -> dict:
    """Device time by kernel over ``n`` requests (``torch.profiler``),
    the port's kernels grouped by name (:func:`profile_steps`), and the
    device's busy share of the window's wall time."""
    print(f"  profile {x.dtype} batch {int(x.shape[0])}, per request:",
          flush=True)
    out = profile_steps(lambda: im.predict(x), n, SERVE_KERNEL_NAMES)
    out.update(batch=int(x.shape[0]), dtype=str(x.dtype))
    return out


def shape_table(records, kernel, by, dtype="bfloat16"):
    """Prints one kernel's per-shape table (activations in ``dtype``)
    from phase 3's records: launches per path, kernel ms per launch, the
    library call's, the bound (b: bytes, o: operations) and the rate
    against that bound's unit; ``by`` keeps the records that belong (a
    batch filter). Returns the rows."""
    rows = []
    for r in records:
        if r["kernel"] != kernel or r["dtype"] != dtype or not by(r):
            continue
        rate = (f"{r['bytes'] / r['ms'] / 1e6:.0f} GB/s"
                if r["bound_by"] == "bytes"
                else f"{r['flops'] / r['ms'] / 1e9:.0f} TFLOP/s")
        rows.append({"key": r["key"], "per_path": r["per_path"],
                     "ms": r["ms"], "library_ms": r["library_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "rate": rate})
        print(f"    {tuple(r['key'])} x{r['per_path']}: {r['ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by'][0]}), {rate}",
              flush=True)
    return rows


# -- flash attention: B7-B10 against their plain versions --------------------

def flash_cases():
    """(tag, B, Tq, Tk, H, D, causal, mask, dtype, launches per path of
    B7/B8/B9/B10, q/k/v as slices of one projection): both BERT routes'
    shapes in f32 and bf16 (the Estimator's f32 at batch 16, T 512 with
    padding masks; bench_bert's bf16 at batch 32, T 128 with an all-ones
    mask), then dead key tiles (samples of length 0, 1, 63, 64, 65, 129
    and T), causal, cross-length, dead-row and head-dim cases."""
    est = (12, 24, 12, 12)
    bench = (0, 12, 12, 12)
    none = (0, 0, 0, 0)
    cases = [
        ("bert_estimator", BERT_BATCH, BERT_T, BERT_T, 12, 64, False,
         "lengths", "float32", est, True),
        ("bert_estimator", BERT_BATCH, BERT_T, BERT_T, 12, 64, False,
         "lengths", "bfloat16", none, True),
        ("bert_bench", BENCH_BATCH, BENCH_T, BENCH_T, 12, 64, False,
         "ones", "bfloat16", bench, True),
        ("bert_bench", BENCH_BATCH, BENCH_T, BENCH_T, 12, 64, False,
         "ones", "float32", none, True)]
    for dt in ("float32", "bfloat16"):
        cases += [
            ("dead_tiles", 7, 256, 256, 4, 64, False, "dead_tiles", dt,
             none, False),
            ("dead_tiles_causal", 7, 128, 256, 4, 128, True, "dead_tiles",
             dt, none, False),
            ("causal", 2, 1024, 1024, 8, 64, True, None, dt, none, False),
            ("cross_causal", 2, 256, 768, 8, 64, True, "lengths", dt, none,
             False),
            ("dead_rows", 2, 512, 256, 8, 64, True, None, dt, none, False),
            ("d32", 2, 256, 256, 8, 32, False, "lengths", dt, none, False),
            ("d128", 2, 256, 256, 8, 128, True, "lengths", dt, none, False),
            ("d256", 2, 256, 256, 4, 256, False, None, dt, none, False)]
    return cases


DEAD_TILE_LENS = (0, 1, 63, 64, 65, 129)


def _key_mask(b, tk, kind, dev):
    """None, all ones, padding at the tail with lengths drawn from numpy
    seed 0 in [128, tk] (the first sample full), or ("dead_tiles") the
    lengths :data:`DEAD_TILE_LENS` then tk, which leave whole key tiles
    of the backward dead (a sample of length 0 attends uniformly)."""
    import numpy as np
    import torch
    if kind is None:
        return None
    km = torch.ones(b, tk)
    if kind in ("lengths", "dead_tiles"):
        if kind == "lengths":
            lens = np.random.RandomState(0).randint(128, tk + 1, size=b)
            lens[0] = tk
        else:
            lens = (DEAD_TILE_LENS + (tk,) * b)[:b]
        for i, n in enumerate(lens):
            km[i, n:] = 0
    return km.to(dev)


def flash_err(got, want, dt):
    """(max |got - want|, tolerance, max|want|): the tolerance is the
    dtype's bound times this output's own max|want| over the finite
    entries, with no floor (attention's outputs and gradients are far
    below 1, so a floor would let a wrong kernel pass); the row max of a
    row that sees no key (-1e30) must match exactly (else its error is
    inf)."""
    g, w = got.float(), want.float()
    dead = w.abs() >= 1e29
    if bool((g[dead] != w[dead]).any()):
        return float("inf"), 0.0, 0.0
    live = ~dead
    if not bool(live.any()):
        return 0.0, 0.0, 0.0
    err = (g[live] - w[live]).abs().max().item()
    scale = w[live].abs().max().item()
    return err, TOL[dt] * scale, scale


def run_flash_case(case, gen):
    """B7, B8, B9 and B10 at one shape against their plain versions on
    the card; one record per kernel."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    tag, b, tq, tk, h, d, causal, mkind, dt, per_path, strided = case
    dev = torch.device(DEV)
    xdt = getattr(torch, dt)
    esize = torch.tensor([], dtype=xdt).element_size()

    def randn(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(xdt)
    if strided:          # column slices of one projection, as BERT has
        qkv = randn(b, tq, 3 * h * d)
        q, k, v = [t.reshape(b, tq, h, d) for t in qkv.split(h * d, -1)]
    else:
        q, k, v = randn(b, tq, h, d), randn(b, tk, h, d), randn(b, tk, h, d)
    dout = randn(b, tq, h, d)
    km = _key_mask(b, tk, mkind, dev)
    scale = d ** -0.5
    off = tk - tq
    _, m, l = fa.flash_block_ref(q, k, v, km, causal, scale, off)
    out = fa.flash_fwd_ref(q, k, v, km, causal, scale)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    bargs = (q, k, v, dout, km, m, l, delta, causal, scale, off)
    fargs = (q, k, v, km, causal, scale, off)
    fns = {
        "flash_fwd": (lambda: fa._flash_fwd(q, k, v, km, causal, scale),
                      lambda: fa.flash_fwd_ref(q, k, v, km, causal, scale),
                      ("out",)),
        "flash_block": (
            lambda: fa._block_partials(q, k, v, off, causal, scale, km),
            lambda: fa.flash_block_ref(q, k, v, km, causal, scale, off),
            ("acc", "m", "l")),
        "flash_bwd_dkdv": (lambda: fa._backward("flash_bwd_dkdv", *bargs),
                           lambda: fa.flash_bwd_dkdv_ref(*bargs),
                           ("dk", "dv")),
        "flash_bwd_dq": (lambda: fa._backward("flash_bwd_dq", *bargs),
                         lambda: fa.flash_bwd_dq_ref(*bargs), ("dq",)),
    }

    # the library yardstick: SDPA on (B, H, T, D) copies with a boolean
    # mask, forward for B7/B8, backward (fwd+bwd less fwd) for B9 + B10
    tq_idx = torch.arange(tq, device=dev)[:, None]
    vis = (tq_idx + off >= torch.arange(tk, device=dev)[None, :]) \
        if causal else torch.ones(tq, tk, dtype=torch.bool, device=dev)
    keep = vis[None] if km is None else vis[None] & (km[:, None, :] > 0)
    pairs = int(keep.sum().item()) * (h if km is not None else b * h)
    attn_mask = keep[:, None]
    lq, lk, lv = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    ldo = dout.transpose(1, 2).contiguous()
    lq_g, lk_g, lv_g = [t.clone().requires_grad_(True) for t in (lq, lk, lv)]

    def lib_fwd():
        return F.scaled_dot_product_attention(lq, lk, lv,
                                              attn_mask=attn_mask)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(lq_g, lk_g, lv_g,
                                           attn_mask=attn_mask)
        o.backward(ldo)
    lib_f = time_ms(lib_fwd)
    lib_b = max(time_ms(lib_fwd_bwd) - lib_f, 0.0)

    n_q, n_k = b * tq * h * d, b * tk * h * d
    stats = 4 * b * h * tq
    mask_b = 0 if km is None else 4 * b * tk
    work = {   # (flop, bytes): each input read once, each output once
        "flash_fwd": (4 * d * pairs, (2 * n_q + 2 * n_k) * esize + mask_b),
        "flash_block": (4 * d * pairs, (n_q + 2 * n_k) * esize + 4 * n_q +
                        2 * stats + mask_b),
        "flash_bwd_dkdv": (8 * d * pairs, (2 * n_q + 4 * n_k) * esize +
                           3 * stats + mask_b),
        "flash_bwd_dq": (6 * d * pairs, (3 * n_q + 2 * n_k) * esize +
                         3 * stats + mask_b),
    }
    records = []
    for i, name in enumerate(FLASH):
        kernel, plain, outs = fns[name]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        gate = {}
        if dt == "float32":
            gate = flash_gate(name, fargs if name in FWD else bargs, got,
                              want, plain)
        errs, rel = {}, {}
        for oname, a, b_ in zip(outs, got, want):
            check(tuple(a.shape) == tuple(b_.shape) and a.dtype == b_.dtype,
                  f"{name} {tag} {oname}: got {tuple(a.shape)} {a.dtype}, "
                  f"plain {tuple(b_.shape)} {b_.dtype}")
            check(bool(torch.isfinite(a.float()).all()),
                  f"{name} {tag} {dt} {oname}: non-finite")
            # (not `scale`: the kernels' lambdas read that after this loop)
            err, tol, top = flash_err(a, b_, dt)
            errs[oname] = (err, tol)
            rel[oname] = err / top if top else 0.0
            check(err <= tol, f"{name} {tag} {dt} {oname}: max|err| {err} "
                  f"> {tol} (max|plain| {top})")
        flops, nbytes = work[name]
        # an f32-accurate product's least time: the smaller of f32 FMA
        # and the TF32 passes the kernels' split needs
        flop_ms = flops / PEAK_FLOPS[dt] * 1e3
        term = "bf16 tensor cores" if dt == "bfloat16" else "f32 FMA"
        passes = flash_passes(dt)
        if dt == "float32" and \
                passes * flops / PEAK_TF32 < flops / PEAK_FLOPS[dt]:
            flop_ms, term = passes * flops / PEAK_TF32 * 1e3, \
                f"{passes}xTF32"
        rec = {"kernel": name, "key": [tag, b, tq, tk, h, d, causal, mkind],
               "dtype": dt, "per_path": per_path[i], "errors": errs,
               "rel_errors": rel,
               "max_abs_err": max(e for e, _ in errs.values()),
               **timed(kernel), "plain_ms": time_ms(plain, iters=3,
                                                          warmup=1),
               "library_ms": (lib_f, lib_f, lib_b, None)[i],
               "library_is": KERNELS[name]["library_is"],
               "flops": flops, "bytes": nbytes, "flop_ms": flop_ms,
               "byte_ms": nbytes / PEAK_BYTES * 1e3}
        rec["bound_ms"] = max(rec["flop_ms"], rec["byte_ms"])
        rec["bound_by"] = "operations" if rec["flop_ms"] > rec["byte_ms"] \
            else "bytes"
        rec["bound_term"] = term if rec["bound_by"] == "operations" \
            else "bytes"
        xdt = getattr(torch, dt)
        if name in BWD:
            rec["route"] = fa.bwd_route(d, xdt)
            rec["tile"] = list(fa.bwd_tile(name, d, xdt))
        else:
            rec["route"] = fa.fwd_route(d, xdt)
            rec["tile"] = list(fa.fwd_tile(name, d, xdt))
        extra = f" [{rec['route']}, tile {tuple(rec['tile'])}]"
        if gate:
            rec["gate"] = gate
            extra += "; vs f64 " + ", ".join(
                f"{o} {g['kernel_err']:.2e} (f32 {g['plain_err']:.2e}, "
                f"TF32 {g['tf32_err']:.2e})" for o, g in gate.items())
        print(f"  {name} {dt} {tag} ({b}, {tq}, {tk}, {h}, {d}"
              f"{', causal' if causal else ''}{', ' + mkind if mkind else ''}"
              f") x{per_path[i]}{extra}: max|err| "
              + ", ".join(f"{o} {e:.2e}/{tl:.2e} (rel {rel[o]:.2e})"
                          for o, (e, tl) in errs.items())
              + f"; kernel {rec['ms']:.4f}{_spread(rec)} ms, plain "
              f"{rec['plain_ms']:.4f} "
              f"ms, library {_ms(rec['library_ms'])}, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_term']})", flush=True)
        records.append(rec)
    return records


BWD = ("flash_bwd_dkdv", "flash_bwd_dq")
FWD = ("flash_fwd", "flash_block")


def flash_passes(dtype: str) -> int:
    """Tensor-core passes of the flash kernels' products (B7-B10): three
    TF32 passes for f32 (hi*hi + hi*lo + lo*hi of each operand's TF32
    split, an f32-accurate product), one for bf16."""
    return 3 if dtype == "float32" else 1


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


def flash_gate(name, args, got, want, plain):
    """The f32 flash kernels' accuracy gate (B7-B10): against the plain
    version run in float64 on the same inputs, each output's max|error|
    (o; acc, m and l; dk, dv; dq) at most twice the f32 plain version's
    (TF32 off) plus one f32 ulp of the output's max|float64|
    (``2^-23 max|y64|``, the slack for outputs whose f32 error is itself
    that small); plain TF32 is the control that must fail. The row max
    of a row that sees no key (-1e30) is left out of the maxima (it
    must match exactly, :func:`flash_err`). ``args``: B7's and B8's
    ``(q, k, v, key_mask, causal, scale, off)``, or B9's and B10's
    arguments. Returns the errors per output; raises if the gate
    fails."""
    import torch

    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    if name == "flash_fwd":
        want64 = fa.flash_fwd_ref(*args[:6], compute=torch.float64)
        outs = ("out",)
    elif name == "flash_block":
        want64 = fa.flash_block_ref(*args, compute=torch.float64)
        outs = ("acc", "m", "l")
    else:
        ref = fa.flash_bwd_dkdv_ref if name == "flash_bwd_dkdv" else \
            fa.flash_bwd_dq_ref
        want64 = ref(*args, compute=torch.float64)
        outs = ("dk", "dv") if name == "flash_bwd_dkdv" else ("dq",)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = plain()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    gate = {}
    for o, k_, p_, t_, r_ in zip(outs, _outs(got), _outs(want), _outs(tf32),
                                 _outs(want64)):
        live = r_.abs() < 1e29
        r_ = r_[live]
        e_k, e_p, e_t = ((x.double()[live] - r_).abs().max().item()
                         if r_.numel() else 0.0 for x in (k_, p_, t_))
        slack = 2.0 ** -23 * (r_.abs().max().item() if r_.numel() else 0.0)
        gate[o] = {"kernel_err": e_k, "plain_err": e_p, "tf32_err": e_t,
                   "slack": slack, "ratio": e_k / e_p if e_p else None}
        check(e_k <= 2 * e_p + slack,
              f"{name} {o}: max|err| against float64 {e_k} > twice the "
              f"f32 plain version's {e_p} + {slack}")
        check(e_t > 2 * e_p + slack,
              f"{name} {o}: plain TF32's error {e_t} passes the gate "
              f"(f32 {e_p}): the gate cannot tell")
    del want64, tf32
    return gate


# -- flash decode: B11 against its plain version ------------------------------

def decode_lens(s, t, seed):
    """Slot lengths from numpy ``seed`` in [1, t], the first slot 1 and
    the second full."""
    import numpy as np
    lens = np.random.RandomState(seed).randint(1, t + 1, size=s)
    lens[0], lens[1] = 1, t
    return [int(n) for n in lens]


def decode_cases():
    """(tag, S, T, H, D, dtype, lengths, int8 cache, launches per decode
    step, paged): the path shape (8 slots, T 2048, 12 heads, D 64, f32;
    its lengths mixed, 1 and 2048 among them) read through a permuted
    page table of 16-token pages as the decode step reads it (f32, bf16
    and an int8 pool), and the same through the dense entry, a slot with
    no valid key, an int8 cache, and head dims 32, 128 and 256."""
    path = decode_lens(GEN_SLOTS, GEN_T, 0)
    dead = [0] + path[1:]
    cases = [("paged_path", GEN_SLOTS, GEN_T, 12, 64, "float32", path,
              False, 12, True),
             ("paged_path", GEN_SLOTS, GEN_T, 12, 64, "bfloat16", path,
              False, 0, True),
             ("paged_int8", GEN_SLOTS, GEN_T, 12, 64, "float32", path, True,
              0, True),
             ("path", GEN_SLOTS, GEN_T, 12, 64, "float32", path, False, 0,
              False),
             ("path", GEN_SLOTS, GEN_T, 12, 64, "bfloat16", path, False, 0,
              False),
             ("no_valid_key", GEN_SLOTS, GEN_T, 12, 64, "float32", dead,
              False, 0, False),
             ("int8_cache", GEN_SLOTS, GEN_T, 12, 64, "float32", path, True,
              0, False)]
    for dt in ("float32", "bfloat16"):
        for d, h in ((32, 16), (128, 8), (256, 4)):
            cases.append((f"d{d}", 4, 1024, h, d, dt,
                          [1, 1024, 0, 613], False, 0, False))
    return cases


def decode_inputs(case, randn):
    """B11's operands at one decode case, the values drawn by
    ``randn(*shape)`` (in the case's dtype), as a dict: ``q`` (S, H, D),
    a column slice of a fused projection; ``k``, ``v``: for a paged case
    one block's pools (a quarter more pages than the slots use) with
    ``table``, a page table permuted by numpy seed 0, else dense (S, T,
    H, D) views; ``scales`` (int8: ``k_scales``, ``v_scales``); ``lens``
    and the key mask ``km`` (S, T) bool; ``dense``: the operands of the
    dense entry (q, k, v, km, scales), for a paged case gathered through
    the table; ``scale``."""
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.ops import kv_cache as kvc
    _, s, t, h, d, _, lens, int8, _, paged = case
    dev = torch.device(DEV)
    qkv = randn(s, 3 * h * d)
    q = qkv[:, :h * d].reshape(s, h, d)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    km = kvc.length_mask(lens_t, t)
    table = None
    if paged:
        pps = t // GEN_PAGE
        n_pages = s * pps + s * pps // 4
        k, v = randn(n_pages, GEN_PAGE, h, d), randn(n_pages, GEN_PAGE, h, d)
        table = torch.from_numpy(np.random.RandomState(0).permutation(
            n_pages)[:s * pps].reshape(s, pps).astype(np.int32)).to(dev)
    else:
        k, v = randn(s, t, h, d), randn(s, t, h, d)
    kw = {}
    if int8:
        (k, ks), (v, vs) = kvc.quantize_rows(k), kvc.quantize_rows(v)
        kw = dict(k_scales=ks, v_scales=vs)
    dense = (q, k, v, km, kw)
    if paged:
        dense = (q, kvc.gather_layer(k, table, t),
                 kvc.gather_layer(v, table, t), km,
                 {n: kvc.gather_layer(x, table, t) for n, x in kw.items()})
    return {"q": q, "k": k, "v": v, "table": table, "scales": kw,
            "lens": lens_t, "km": km, "dense": dense, "scale": d ** -0.5}


def run_decode_case(case, gen):
    """B11 at one shape against its plain version on the card, with
    ``F.scaled_dot_product_attention`` timed beside it (on the dense
    view; for a paged case the gather it needs is not timed); the bound
    counts the K and V rows a slot must read (its valid rows, or all T
    for a slot with none; int8 with their scales), q, the validity (the
    mask, or the lengths and the page table) and the output once."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.ops import kv_cache as kvc
    tag, s, t, h, d, dt, lens, int8, per_path, paged = case
    dev = torch.device(DEV)
    xdt = getattr(torch, dt)
    esize = torch.tensor([], dtype=xdt).element_size()

    def randn(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(xdt)
    x = decode_inputs(case, randn)
    q, scale = x["q"], x["scale"]
    _, dk, dv, km, dkw = x["dense"]

    def kernel():
        if paged:
            return fa.flash_decode_paged(q, x["k"], x["v"], x["table"],
                                         x["lens"], scale, **x["scales"])
        return fa.flash_decode_attention(q, x["k"], x["v"], km, scale,
                                         **x["scales"])
    if int8:       # the paged plain version: gather, dequantize, plain
        dk = kvc.dequantize_rows(dk, dkw["k_scales"], xdt)
        dv = kvc.dequantize_rows(dv, dkw["v_scales"], xdt)

    def plain():
        return fa.flash_decode_ref(q, dk, dv, km.float(), scale)
    lq = q[:, :, None].contiguous()                    # (S, H, 1, D)
    lk, lv = [y.transpose(1, 2).contiguous() for y in (dk, dv)]
    mask = km[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
    got, want, again = kernel(), plain(), kernel()
    torch.cuda.synchronize()
    check(tuple(got.shape) == (s, h, d) and got.dtype == xdt,
          f"flash_decode {tag}: got {tuple(got.shape)} {got.dtype}")
    check(torch.equal(got, again), f"flash_decode {tag} {dt}: a second "
          "launch gave other bits")
    check(bool(torch.isfinite(got.float()).all()),
          f"flash_decode {tag} {dt}: non-finite")
    err, tol, scl = flash_err(got, want, dt)
    check(err <= tol, f"flash_decode {tag} {dt}: max|err| {err} > {tol} "
          f"(max|plain| {scl})")
    rows = sum(n if n else t for n in lens)           # rows read per head
    kv_bytes = 2 * rows * h * d * (1 if int8 else esize) + \
        (2 * rows * h * 4 if int8 else 0)
    valid_bytes = 4 * s * (1 + t // GEN_PAGE) if paged else s * t
    nbytes = kv_bytes + 2 * s * h * d * esize + valid_bytes
    flops = 4.0 * d * rows * h
    rec = {"kernel": "flash_decode", "key": [tag, s, t, h, d, int8],
           "dtype": dt, "per_path": per_path, "lens": lens, "paged": paged,
           "errors": {"out": (err, tol)},
           "rel_errors": {"out": err / scl if scl else 0.0},
           "max_abs_err": err, **timed(kernel),
           "plain_ms": time_ms(plain, iters=3, warmup=1),
           "library_ms": time_ms(library),
           "library_is": KERNELS["flash_decode"]["library_is"],
           "flop_ms": flops / PEAK_FLOPS[dt] * 1e3,
           "byte_ms": nbytes / PEAK_BYTES * 1e3}
    rec["bound_ms"] = max(rec["flop_ms"], rec["byte_ms"])
    rec["bound_by"] = "operations" if rec["flop_ms"] > rec["byte_ms"] \
        else "bytes"
    print(f"  flash_decode {dt} {tag} (S {s}, T {t}, H {h}, D {d}"
          f"{', int8 cache' if int8 else ''}"
          f"{', paged' if paged else ''}, valid rows {rows}) "
          f"x{per_path}: max|err| {err:.2e}/{tol:.2e} (rel "
          f"{rec['rel_errors']['out']:.2e}); kernel {rec['ms']:.4f}"
          f"{_spread(rec)} ms, "
          f"plain {rec['plain_ms']:.4f} ms, library "
          f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    return rec


# -- BERT ---------------------------------------------------------------------

def bert_batch(n, t, vocab, seed=0, lengths=True):
    """Sentence-pair inputs shaped as the reference's bert_finetune
    example makes them: ids, segment ids, positions, and a key-padding
    mask with lengths from numpy ``seed`` in [128, t] (the first sample
    full), or all ones; labels from the first segment's mean id."""
    import numpy as np
    rs = np.random.RandomState(seed)
    tok = rs.randint(1, vocab, size=(n, t)).astype(np.int32)
    seg = (np.arange(t)[None, :] >= t // 2).astype(np.int32) * \
        np.ones((n, 1), np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (n, 1))
    mask = np.ones((n, t), np.float32)
    if lengths:
        lens = rs.randint(128, t + 1, size=n)
        lens[0] = t
        for i, ln in enumerate(lens):
            mask[i, ln:] = 0.0
    y = (tok[:, :t // 2].mean(axis=1) > vocab / 2).astype(np.int32)[:, None]
    return [tok, seg, pos, mask], y


def finetune_model(impl="flash", drop=0.1):
    """The reference example's classifier at BERT-base widths."""
    from analytics_zoo_tpu_torch.pipeline.api import autograd as ag
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    model = Sequential()
    model.add(L.BERT(seq_len=BERT_T, output_all_block=False, remat=True,
                     attention_impl=impl, hidden_p_drop=drop,
                     embed_p_drop=drop, name="bert",
                     input_shape=[(BERT_T,)] * 4, **BERT))
    model.add(ag.Lambda(lambda outs: outs[1], name="take_pooled",
                        output_shape=(BERT["hidden_size"],)))
    model.add(L.Dropout(drop))
    model.add(L.Dense(2, activation="softmax", name="classifier"))
    return model


# B7 and B8 are one template (flash_fwd_sm90_kernel<T, D, partial, ..>)
# at D 64 and 128, the old kernels (flash_fwd_<dtype>_kernel<D,
# partial>) at D 32 and 256
B7_KERNEL = (r"flash_fwd_sm90_kernel<\w+, \d+, false|"
             r"flash_fwd_\w+_kernel<\d+, false>")
B8_KERNEL = (r"flash_fwd_sm90_kernel<\w+, \d+, true|"
             r"flash_fwd_\w+_kernel<\d+, true>")
FLASH_KERNEL_NAMES = (
    ("flash_fwd", B7_KERNEL),
    ("flash_block", B8_KERNEL),
    ("flash_bwd_dkdv", r"flash_dkdv_"),
    ("flash_bwd_dq", r"flash_dq_"),
)


def profile_steps(step, steps, groups, per=1):
    """Device time by kernel over ``steps`` calls of ``step``
    (``torch.profiler``), each call ``per`` steps of the path, grouped by
    ``groups`` (name, regex); the device's busy share of the window's
    wall time; the ten largest rows left in "other"; and the host-to-
    device copies by source (a pageable copy runs on the compute stream
    and blocks the host, a pinned one on a copy stream)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    n = steps * per
    kernels = collections.Counter()
    calls = 0
    # the raw device events: key_averages() builds the host's event tree
    # first, tens of seconds over a recurrent step's ~25,000 rows
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA:
            kernels[evt.name()] += evt.duration_ns() / 1e3
            calls += 1
    busy_us = sum(kernels.values())
    by_name = collections.Counter()
    members = collections.defaultdict(set)
    other = collections.Counter()
    for key, us in kernels.items():
        group = next((g for g, pat in groups if re.search(pat, key)),
                     "other")
        by_name[group] += us
        if group != "other":
            members[group].add(key[:90])
        else:
            other[key] += us
    htod = {src: sum(us for key, us in kernels.items()
                     if key.startswith(f"Memcpy HtoD ({src}"))
            / n / 1e3 for src in ("Pageable", "Pinned")}
    out = {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
           "device_ms_per_step": busy_us / n / 1e3,
           "device_busy_share": busy_us / wall_us if busy_us else None,
           "device_rows_per_step": calls / n,
           "ms_per_step_by_kernel": {k: v / n / 1e3
                                     for k, v in by_name.most_common()},
           "top": [(k[:90], v / n / 1e3)
                   for k, v in kernels.most_common(12)],
           "other_top": [(k[:120], v / n / 1e3)
                         for k, v in other.most_common(10)],
           "htod_ms_per_step": htod,
           "kernels_by_group": {k: sorted(v) for k, v in members.items()}}
    print(f"  profile: device busy {out['device_ms_per_step']:.3f} of "
          f"{out['wall_ms_per_step']:.3f} ms per step (share "
          f"{out['device_busy_share']}), {out['device_rows_per_step']:.1f} "
          "device rows (kernels, copies, fills) per step", flush=True)
    for k, ms in out["ms_per_step_by_kernel"].items():
        names = "; ".join(sorted(members.get(k, ())))
        print(f"    {ms:9.3f} ms per step  {k}"
              + (f"  [{names}]" if names else ""), flush=True)
    print(f"    HtoD copies per step: pageable {htod['Pageable']:.3f} ms, "
          f"pinned {htod['Pinned']:.3f} ms", flush=True)
    print("    the ten largest rows in other:", flush=True)
    for k, ms in out["other_top"]:
        print(f"      {ms:9.3f} ms per step  {k}", flush=True)
    return out


def bert_estimator_path(card, detail):
    """Phase 6: fine-tune and evaluate BERT-base through the Estimator
    (the f32 kernels); returns the launches over train + evaluate +
    predict."""
    import numpy as np
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.ops import losses
    from analytics_zoo_tpu_torch.ops.optimizers import Adam, warmup
    from analytics_zoo_tpu_torch.pipeline.estimator import (
        Estimator, MaxIteration)

    ctx = zoo.init_nncontext(seed=0)
    n = BERT_STEPS * BERT_BATCH
    x, y = bert_batch(n, BERT_T, BERT["vocab"])
    t0 = time.perf_counter()
    model = finetune_model()
    model.init_params()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  BERT-base classifier ({n_params} params) built on "
          f"{model.device} in {time.perf_counter() - t0:.2f} s", flush=True)

    # one f32 step with dropout 0: flash kernels against the dense plain
    # path on the same weights and batch (loss and every gradient)
    xb = [torch.from_numpy(a[:BERT_BATCH]).to(ctx.device) for a in x]
    yb = torch.from_numpy(y[:BERT_BATCH]).to(ctx.device)

    def loss_and_grads(net):
        params = net.params()
        mask = net.trainable_mask(params)
        from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
            tree_leaves
        leaves = [p for p, on in zip(tree_leaves(params), tree_leaves(mask))
                  if on]
        for p in leaves:
            p.requires_grad_(True)
        try:
            out, _ = net.apply(params, xb, training=True)
            loss = losses.sparse_categorical_crossentropy(yb, out)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return loss.item(), grads
    checks = {}
    nets = {impl: finetune_model(impl, drop=0.0) for impl in ("flash", "xla")}
    for net in nets.values():
        net.init(torch.Generator().manual_seed(0))
        net.set_params(model.params())      # shares the card's tensors
    loss_f, g_f = loss_and_grads(nets["flash"])
    loss_d, g_d = loss_and_grads(nets["xla"])
    checks["f32_loss_flash_vs_dense"] = (abs(loss_f - loss_d),
                                         1e-4 * max(1.0, abs(loss_d)))
    worst = (0.0, "")
    for i, (a, b) in enumerate(zip(g_f, g_d)):
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        worst = max(worst, (rel, str(i)))
    checks["f32_grad_flash_vs_dense_worst_rel_norm"] = (worst[0], 1e-3)
    print(f"  f32 step: flash loss {loss_f:.6f}, dense {loss_d:.6f}; "
          f"worst gradient |g - g_dense| / |g_dense| {worst[0]:.3e} "
          f"(leaf {worst[1]} of {len(g_d)})", flush=True)
    del nets, g_f, g_d
    torch.cuda.empty_cache()

    est = Estimator(model, optimizer=Adam(lr=warmup(5e-5, 8, delta=(
        5e-4 - 5e-5) / 8)), loss="sparse_categorical_crossentropy",
        metrics=["accuracy"], ctx=ctx)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res = est.train(x, y, batch_size=BERT_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t
    trained = all_launches()
    reset_launches()
    n_eval = 2 * BERT_BATCH
    x_eval = [a[:n_eval] for a in x]
    scores = est.evaluate(x_eval, y[:n_eval], batch_size=BERT_BATCH)
    probs = est.predict(x_eval, batch_size=BERT_BATCH)
    torch.cuda.synchronize()
    evaluated = all_launches()
    launches = {k: trained[k] + evaluated[k] for k in trained}
    losses_ = res.history[-1]["losses"]
    print(f"  {len(losses_)} f32 steps at batch {BERT_BATCH}, T {BERT_T}: "
          f"losses {[round(v, 5) for v in losses_]} ({first_wall:.2f} s); "
          f"evaluate {scores}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    print(f"  launches in training {dict((k, trained[k]) for k in FLASH)}, "
          f"in evaluate + predict {dict((k, evaluated[k]) for k in FLASH)}",
          flush=True)
    check(len(losses_) == BERT_STEPS and all(np.isfinite(losses_)),
          f"losses {losses_}")
    check(probs.shape == (n_eval, 2) and np.isfinite(probs).all() and
          np.allclose(probs.sum(-1), 1.0, atol=1e-5),
          f"predict gave {probs.shape}")
    check(set(scores) == {"loss", "accuracy"} and
          np.isfinite(scores["loss"]) and 0 <= scores["accuracy"] <= 1,
          f"evaluate gave {scores}")
    nb = BERT["n_block"]       # B8 runs twice per block: remat
    want_train = {"flash_fwd": 0, "flash_block": 2 * nb * BERT_STEPS,
                  "flash_bwd_dkdv": nb * BERT_STEPS,
                  "flash_bwd_dq": nb * BERT_STEPS}
    want_eval = {"flash_fwd": nb * 4, "flash_block": 0,
                 "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}
    for name in KERNELS:
        check(trained[name] == want_train.get(name, 0),
              f"{name}: {trained[name]} launches in {BERT_STEPS} steps, "
              f"expected {want_train.get(name, 0)}")
        check(evaluated[name] == want_eval.get(name, 0),
              f"{name}: {evaluated[name]} launches in 2 eval + 2 predict "
              f"batches, expected {want_eval.get(name, 0)}")
    for k, (err, tol) in checks.items():
        print(f"  {k}: {err:.4e} (tol {tol:.4e})", flush=True)
    detail["bert_checks"] = checks
    bad = [k for k, (err, tol) in checks.items() if not err <= tol]
    check(not bad, f"BERT checks failed: {bad}")

    # steady state: another epoch on the host clock around a sync
    torch.cuda.synchronize()
    t = time.perf_counter()
    est.train(x, y, batch_size=BERT_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    print(f"  f32 BERT-base fine-tune: {wall / BERT_STEPS * 1e3:.1f} ms per "
          f"step, {n / wall:.2f} samples/s on {card}", flush=True)
    prof = profile_steps(
        lambda: est.train([a[:BERT_BATCH] for a in x], y[:BERT_BATCH],
                          batch_size=BERT_BATCH,
                          end_trigger=MaxIteration(est.step + 1)),
        2, FLASH_KERNEL_NAMES)
    print("  evaluate, one batch:", flush=True)
    prof_eval = profile_steps(
        lambda: est.evaluate([a[:BERT_BATCH] for a in x], y[:BERT_BATCH],
                             batch_size=BERT_BATCH), 2, FLASH_KERNEL_NAMES)
    detail["bert_estimator"] = {
        "losses": losses_, "evaluate": scores, "launches": launches,
        "samples_per_s": n / wall, "step_ms": wall / BERT_STEPS * 1e3,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "profile": prof, "profile_eval_batch": prof_eval}
    del est, model
    torch.cuda.empty_cache()
    return launches


def bert_bench_path(card, detail):
    """Phase 7: train steps as bench_bert.py runs them (params cast to
    bf16 inside the loss: the bf16 kernels); returns the launches."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.ops.optimizers import Adam
    from analytics_zoo_tpu_torch.ops.rng import fold_in
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L

    ctx = zoo.init_nncontext(seed=0)
    dev = ctx.device
    bert = L.BERT(seq_len=BENCH_T, output_all_block=False,
                  attention_impl="flash", input_shape=[(BENCH_T,)] * 4,
                  **BERT)
    gen = torch.Generator().manual_seed(0)
    bert.init(gen)
    bert.to(dev)
    head_w = (torch.randn(BERT["hidden_size"], 2, generator=gen) *
              0.02).to(dev)
    head_b = torch.zeros(2, device=dev)
    rs = np.random.RandomState(0)
    tok = torch.from_numpy(rs.randint(1, BERT["vocab"], (BENCH_BATCH,
                                                        BENCH_T))).to(dev)
    seg = torch.zeros_like(tok)
    pos = torch.arange(BENCH_T, device=dev).repeat(BENCH_BATCH, 1)
    msk = torch.ones(BENCH_BATCH, BENCH_T, dtype=torch.bfloat16, device=dev)
    yb = torch.from_numpy(rs.randint(0, 2, (BENCH_BATCH,))).to(dev)
    leaves = [p for p in bert.parameters()] + [head_w, head_b]
    opt = Adam(5e-5)
    state = opt.init(leaves)
    base = ctx.next_seed()

    def loss_fn(cast, rng):
        params = bert.params()
        if cast:
            params = _tree_map(params, lambda a: a.to(torch.bfloat16))
        _, pooled = bert.call(params, [tok, seg, pos, msk], training=True,
                              rng=rng)
        logits = pooled.float() @ head_w + head_b
        return F.cross_entropy(logits, yb)

    with torch.no_grad():
        loss32 = float(loss_fn(False, fold_in(base, 0)))

    def step(i):
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(True, fold_in(base, i))
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        opt.update(leaves, grads, state)
        return loss.detach()

    reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses_ = [step(i) for i in range(BERT_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = all_launches()
    losses_ = [float(v) for v in losses_]
    print(f"  {BERT_STEPS} bf16 steps at batch {BENCH_BATCH}, T {BENCH_T}: "
          f"losses {[round(v, 4) for v in losses_]}, f32 loss on the same "
          f"weights {loss32:.5f}; launches "
          f"{dict((k, launches[k]) for k in FLASH)}", flush=True)
    check(all(np.isfinite(losses_)), f"non-finite bf16 loss {losses_}")
    err = abs(losses_[0] - loss32)
    check(err <= 5e-2 * max(1.0, abs(loss32)),
          f"bf16 loss {losses_[0]} vs f32 {loss32}")
    nb = BERT["n_block"]
    want = {"flash_fwd": 0, "flash_block": nb * BERT_STEPS,
            "flash_bwd_dkdv": nb * BERT_STEPS, "flash_bwd_dq": nb * BERT_STEPS}
    for name in KERNELS:
        check(launches[name] == want.get(name, 0),
              f"{name}: {launches[name]} launches in {BERT_STEPS} bf16 "
              f"steps, expected {want.get(name, 0)}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(BERT_STEPS):
        step(BERT_STEPS + i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rate = BERT_STEPS * BENCH_BATCH / wall
    print(f"  bf16 bench_bert steps: {wall / BERT_STEPS * 1e3:.1f} ms per "
          f"step, {rate:.1f} samples/s on {card}", flush=True)
    it = iter(range(100, 200))
    prof = profile_steps(lambda: step(next(it)), 2, FLASH_KERNEL_NAMES)
    detail["bert_bench"] = {"losses": losses_, "f32_loss": loss32,
                            "launches": launches, "samples_per_s": rate,
                            "step_ms": wall / BERT_STEPS * 1e3,
                            "profile": prof}
    return launches


GEN_KERNEL_NAMES = (
    ("flash_decode (B11)", r"flash_decode_kernel"),
    ("flash_fwd (B7)", B7_KERNEL),
    ("cache writes (index_put)", r"index_put"),
    ("page-table gathers", r"index_kernel|gather"),
    ("products (cuBLAS)", r"gemm|gemv|xmma|cutlass"),
)


def gpt_net(impl=None):
    """The generation model: GPT-1's widths at a 2048-token context."""
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.transformer \
        import TransformerLayer
    return TransformerLayer(seq_len=GEN_T, attention_impl=impl, **GPT)


def gen_requests():
    """The served traffic from numpy seed 0: each prompt length of
    GEN_PROMPTS four times in a shuffled order (dense and B7 prefill
    buckets), a budget of 32-64 new tokens each, random token ids, and
    each client's delay before each of its submits."""
    import numpy as np
    rs = np.random.RandomState(0)
    reps = GEN_REQUESTS // len(GEN_PROMPTS)
    plens = rs.permutation(np.repeat(GEN_PROMPTS, reps))
    max_new = rs.randint(32, 65, size=GEN_REQUESTS)
    prompts = [rs.randint(1, GPT["vocab"], size=int(n)).tolist()
               for n in plens]
    delays = rs.uniform(0.0, 0.3, size=GEN_REQUESTS)
    return prompts, [int(m) for m in max_new], delays


def teacher_forced(net, params, prompt, tokens, cache_dtype=None):
    """Logits (1, V) after ``prompt`` + ``tokens`` on a fresh one-slot
    cache (of ``cache_dtype``, f32 by default): the prefill's when
    ``tokens`` is empty, else the last decode step's."""
    import torch
    dev = params["tok_embed"].device
    cache = net.init_kv_cache(1, GEN_T, page_size=GEN_PAGE,
                              dtype=cache_dtype, device=dev)
    with torch.no_grad():
        cache, lg = net.prefill(params, cache,
                                torch.tensor([prompt], device=dev),
                                torch.tensor([len(prompt)], device=dev))
        for tok in tokens:
            cache, lg = net.decode_step(params, cache,
                                        torch.tensor([tok], device=dev))
    return lg


def gen_engine():
    """The generation path's engine: ``gpt_net()`` with seeded random
    weights, loaded by ``InferenceModel.load_generator`` (8 slots of
    16-token pages, f32 cache) on the context's card and warmed. Returns
    ``(net, engine, warm seconds, the InferenceModel)``."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    ctx = zoo.init_nncontext(seed=0)
    t0 = time.perf_counter()
    net = gpt_net()
    params = net.build(torch.Generator().manual_seed(0), (GEN_T,))
    params["tok_embed"] = params["tok_embed"] * GEN_EMBED_SCALE
    im = InferenceModel().load_generator(net, params, max_slots=GEN_SLOTS,
                                         max_context=GEN_T,
                                         page_size=GEN_PAGE)
    eng = im.generator
    del params
    n_params = sum(v.numel() for v in eng.params.values()
                   if not isinstance(v, dict)) + \
        sum(v.numel() for v in eng.params["blocks"].values())
    pool_gb = 2 * eng.cache.k_pages.numel() * \
        eng.cache.k_pages.element_size() / 1e9
    print(f"  GPT-1 widths, T {GEN_T}: {n_params} params on {ctx.device}, "
          f"KV pool {pool_gb:.3f} GB ({eng.allocator.max_pages} pages of "
          f"{GEN_PAGE}), built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_prog = eng.warm()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"  warm: {n_prog} programs (buckets {eng.prompt_buckets} and the "
          f"step) in {warm_s:.2f} s", flush=True)
    check(n_prog == len(eng.prompt_buckets) + 1, f"warm ran {n_prog}")
    return net, eng, warm_s, im


class LaunchLog:
    """Records, for each call of the named methods of one engine, its
    arguments, the kernel launches it made (the counters' difference
    around the call), whether it raised, and its host seconds (each
    engine call ends by copying its tokens to the host, so they include
    the card's work). The batcher calls the engine from its one loop
    thread, so no other launch falls inside a call. :meth:`close`
    removes the wrappers."""

    def __init__(self, eng, names):
        self.eng = eng
        self.calls = {n: [] for n in names}
        for n in names:
            setattr(eng, n, self._wrap(n, getattr(type(eng), n)))

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            before = all_launches()
            rec = {"args": args, "error": None}
            t0 = time.perf_counter()
            try:
                return fn(self.eng, *args, **kw)
            except Exception as e:
                rec["error"] = type(e).__name__
                raise
            finally:
                rec["s"] = time.perf_counter() - t0
                after = all_launches()
                rec["launches"] = {k: after[k] - before[k] for k in after
                                   if after[k] != before[k]}
                self.calls[name].append(rec)
        return wrapped

    def median_ms(self, name):
        """The median host ms of the recorded calls of ``name``."""
        got = [c["s"] for c in self.calls.get(name, [])]
        return statistics.median(got) * 1e3 if got else None

    def buckets(self):
        """The prompt bucket of each ``admit`` call."""
        return [next(b for b in self.eng.prompt_buckets
                     if b >= max(len(r[0]) for r in c["args"][0]))
                for c in self.calls.get("admit", [])]

    def close(self):
        for n in self.calls:
            delattr(self.eng, n)


def serve_generation(eng, requests=None):
    """Serve ``requests`` (``(prompts, budgets, delays)``, default
    :func:`gen_requests`) through a ``ContinuousBatcher`` from
    GEN_CLIENTS threads; returns the streams, each request's time to
    first token (with its prompt length), the prefill buckets, the
    window's seconds, the kernel launches in it, each engine call's
    launches (``calls``), the decode iterations and the serving
    errors."""
    import torch

    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.pipeline.inference import ContinuousBatcher

    prompts, max_new, delays = requests or gen_requests()
    n_req = len(prompts)
    ttft, ttft_len = [], []

    class Batcher(ContinuousBatcher):
        """Keeps each request's time to first token (the value the
        batcher's TTFT histogram observes) for the percentiles."""

        def _token_out(self, e, tok, now):
            if not e.tokens:
                ttft.append(now - e.t_enq)
                ttft_len.append(e.prompt_len)
            return super()._token_out(e, tok, now)

    log = LaunchLog(eng, ("admit", "prefill_step", "step", "spec_step"))
    obs.reset_metrics()
    cb = Batcher(eng, queue_depth=64).start()

    def client(c):
        futs = []
        for i in range(c, n_req, GEN_CLIENTS):
            time.sleep(float(delays[i]))
            futs.append((i, cb.submit(prompts[i],
                                      max_new_tokens=max_new[i])))
        return [(i, f.result(timeout=600)) for i, f in futs]

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(GEN_CLIENTS) as pool:
            futures = [pool.submit(client, c) for c in range(GEN_CLIENTS)]
            results = dict(r for f in futures for r in f.result())
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
        launches = all_launches()
    finally:
        cb.stop()
        log.close()
    snap = obs.snapshot()
    steps = int(snap["zoo_tpu_serving_gen_steps_total"]["values"][0]
                ["value"])
    errors = sum(v["value"] for v in snap.get(
        "zoo_tpu_serving_errors_total", {"values": []})["values"])
    n_tok = sum(len(results[i]) for i in range(n_req))
    return {"results": results, "ttft": ttft, "ttft_len": ttft_len,
            "buckets": log.buckets(), "calls": log.calls, "log": log,
            "window": window, "launches": launches, "steps": steps,
            "errors": errors, "tokens": n_tok,
            "tokens_per_s": n_tok / window,
            "ttft_median_ms": statistics.median(ttft) * 1e3}


# the engine's sequential generate per (weights, prompt, pool dtype): a
# greedy stream of a smaller budget is a prefix of a larger one, so each
# prompt runs once at the largest budget asked (phases 8, 12 and 13 share
# phase 8's weights)
_SEQUENTIAL = {}


def sequential_ref(eng, prompt, budget):
    key = (eng.params["tok_embed"].data_ptr(), tuple(prompt),
           str(eng.cache_dtype))
    have = _SEQUENTIAL.get(key)
    if have is None or len(have) < budget:
        have = [int(t) for t in eng.generate(prompt,
                                             max_new_tokens=budget)[0]]
        _SEQUENTIAL[key] = have
    return have[:budget]


def check_streams(net, eng, prompts, max_new, results):
    """Each served greedy stream against the engine's sequential
    ``generate`` (:func:`sequential_ref`): a stream may part from it only
    at a step where the teacher-forced top-2 logit margin (on a cache of
    the engine's dtype) is within 1e-3 of max|logit| (a near tie the two
    routes' rounding may break either way). Returns the partings."""
    parted = []
    for i, (prompt, budget, got) in enumerate(zip(prompts, max_new,
                                                  results)):
        ref = sequential_ref(eng, prompt, budget)
        got = [int(t) for t in got]
        check(len(got) == budget, f"request {i}: {len(got)} tokens, "
              f"budget {budget}")
        if got == ref:
            continue
        j = next(n for n, (a, b) in enumerate(zip(got, ref)) if a != b)
        lg = teacher_forced(net, eng.params, prompt, got[:j],
                            eng.cache_dtype)[0]
        top2 = lg.topk(2).values
        margin = (top2[0] - top2[1]).item()
        tol = 1e-3 * lg.abs().max().item()
        parted.append({"request": i, "step": j, "margin": margin,
                       "tol": tol})
        check(margin <= tol, f"request {i} parts from sequential generate "
              f"at step {j} with top-2 margin {margin} > {tol}")
    print(f"  {len(parted)} of {len(results)} served streams part from "
          f"the sequential generate {parted}", flush=True)
    return parted


def decode_step_profile(eng, card):
    """The decode step at 8 active slots (prompt lengths GEN_PROMPTS in
    turn): the median host ms of 30 ``GenerationEngine.step`` calls and
    a ``torch.profiler`` window of two, with B11's and the page-table
    gathers' rows named (the latter 0 where B11 reads the pages in
    place)."""
    import numpy as np
    import torch
    prompts, _, _ = gen_requests()
    mix = [GEN_PROMPTS[i % len(GEN_PROMPTS)] for i in range(GEN_SLOTS)]
    admitted = eng.admit([(prompts[0][:1] * n, 64, 0.0) for n in mix])
    active = np.zeros((GEN_SLOTS,), np.bool_)
    for slot, _ in admitted:
        active[slot] = True
    for _ in range(2):
        eng.step(active)
    step_s = []
    for _ in range(30):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(active)
        step_s.append(time.perf_counter() - t0)
    step_ms = statistics.median(step_s) * 1e3
    print(f"  decode step at {GEN_SLOTS} active slots (lengths {mix}): "
          f"median {step_ms:.3f} ms (30 steps, {min(step_s) * 1e3:.3f}-"
          f"{max(step_s) * 1e3:.3f}) on {card}", flush=True)
    prof = profile_steps(lambda: eng.step(active), 2, GEN_KERNEL_NAMES)
    by = prof["ms_per_step_by_kernel"]
    print(f"  decode step rows: page-table gathers "
          f"{by.get('page-table gathers', 0.0):.3f} ms, B11 "
          f"{by.get('flash_decode (B11)', 0.0):.3f} ms of "
          f"{prof['device_ms_per_step']:.3f} device ms per step",
          flush=True)
    for slot, _ in admitted:
        eng.release(slot)
    return {"step_ms_8_slots": step_ms,
            "step_ms_all": [t * 1e3 for t in step_s], "profile": prof}


def generation_path(card, detail):
    """Phase 8: serve GPT-style generation through the port's entry
    points (``InferenceModel.load_generator`` → ``ContinuousBatcher``)
    at GPT-1's widths and a 2048-token context: B11 on every decode
    step, reading each block's pages in place, B7 on prefills at
    buckets >= 1024. Returns the launches of the serving run."""
    import numpy as np
    import torch

    net, eng, warm_s, im = gen_engine()
    dev = eng.device
    prompts, max_new, _ = gen_requests()
    served = serve_generation(eng)
    results, ttft, buckets = (served[k] for k in
                              ("results", "ttft", "buckets"))
    window, launches, steps, errors, n_tok = (
        served[k] for k in ("window", "launches", "steps", "errors",
                            "tokens"))
    n_b7 = sum(b >= 1024 for b in buckets)
    print(f"  served {GEN_REQUESTS} requests from {GEN_CLIENTS} threads: "
          f"{n_tok} tokens in {window:.3f} s ({n_tok / window:.1f} "
          f"tokens/s), {steps} decode steps, {len(buckets)} prefills at "
          f"buckets {buckets}; median TTFT "
          f"{statistics.median(ttft) * 1e3:.1f} ms; errors {errors}; "
          f"launches {launches}", flush=True)
    for i in range(GEN_REQUESTS):
        check(len(results[i]) == max_new[i],
              f"request {i}: {len(results[i])} tokens, budget {max_new[i]}")
    check(errors == 0, f"{errors} serving errors")
    check(len(ttft) == GEN_REQUESTS, f"{len(ttft)} first tokens")
    check(eng.slots_active == 0 and
          eng.free_pages == eng.allocator.max_pages,
          f"after serving: {eng.slots_active} slots active, "
          f"{eng.free_pages} of {eng.allocator.max_pages} pages free")
    nb = GPT["n_block"]
    want = {"flash_decode": nb * steps, "flash_fwd": nb * n_b7}
    check(n_b7 > 0, f"prefill buckets {buckets}: none runs B7")
    for name in KERNELS:
        check(launches[name] == want.get(name, 0),
              f"{name}: {launches[name]} launches in {steps} decode steps "
              f"and {n_b7} prefills at buckets >= 1024, expected "
              f"{want.get(name, 0)}")

    # numerics: teacher forcing through the kernels and the dense path
    rs = np.random.RandomState(1)
    lens = list(GEN_TF_LENS)
    ids = torch.zeros(GEN_SLOTS, GEN_T, dtype=torch.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = torch.from_numpy(rs.randint(1, GPT["vocab"], size=n))
    ids, plens = ids.to(dev), torch.tensor(lens, device=dev)
    dense_net = gpt_net("xla")
    p = eng.params
    checks = {}
    with torch.no_grad():
        reset_launches()
        cache_k = net.init_kv_cache(GEN_SLOTS, GEN_T, page_size=GEN_PAGE,
                                    device=dev)
        cache_k, lg_k = net.prefill(p, cache_k, ids, plens)
        cache_d = cache_k.clone()
        _, lg_pd = dense_net.prefill(
            p, dense_net.init_kv_cache(GEN_SLOTS, GEN_T, page_size=GEN_PAGE,
                                       device=dev), ids, plens)
        checks["prefill_B7_vs_dense"] = (
            (lg_k - lg_pd).abs().max().item(),
            1e-3 * lg_pd.abs().max().item())
        tok = lg_pd.argmax(-1).to(torch.int32)
        fed = [tok]
        for step in range(8):
            cache_k, lg_k = net.decode_step(p, cache_k, tok)
            cache_d, lg_d = dense_net.decode_step(p, cache_d, tok)
            checks[f"decode_step{step}_B11_vs_dense"] = (
                (lg_k - lg_d).abs().max().item(),
                1e-3 * lg_d.abs().max().item())
            tok = lg_d.argmax(-1).to(torch.int32)
            fed.append(tok)
        tf_launches = all_launches()
        prefix = torch.cat([ids[0, :lens[0]]] +
                           [t[:1] for t in fed[:-1]])[None]
        h = net.call(p, prefix)
        full = h[0, -1] @ p["tok_embed"].T
        checks["last_step_vs_uncached_forward"] = (
            (lg_k[0] - full).abs().max().item(),
            1e-3 * full.abs().max().item())
    check(tf_launches["flash_decode"] == 8 * nb and
          tf_launches["flash_fwd"] == nb,
          f"teacher forcing launches {tf_launches}")
    del cache_k, cache_d
    for k, (err, tol) in checks.items():
        print(f"  {k}: max|err| {err:.4e} (tol {tol:.4e})", flush=True)
    bad = [k for k, (err, tol) in checks.items() if not err <= tol]
    check(not bad, f"generation numerics failed: {bad}")

    # each served greedy stream against the engine's sequential generate
    parted = check_streams(net, eng, prompts, max_new,
                           [results[i] for i in range(GEN_REQUESTS)])

    # the decode step at 8 active slots: host time and a profile
    stepped = decode_step_profile(eng, card)
    detail["generation"] = {
        "tokens_per_s": n_tok / window, "window_s": window,
        "tokens": n_tok, "decode_steps": steps, "prefill_buckets": buckets,
        "ttft_ms": sorted(t * 1e3 for t in ttft),
        "ttft_by_prompt_ms": ttft_split(served),
        "ttft_median_ms": statistics.median(ttft) * 1e3,
        "warm_s": warm_s, "launches": launches, "checks": checks,
        "parted": parted, **stepped}
    return launches, im


def decode_crossover(card, detail):
    """Phase 10: B11 against the dense plain decode (device ms, through
    ``decode_attention``) at S 8, H 12, D 64, f32, every slot full, T
    from 128 to 4096 (printed only)."""
    import torch

    from analytics_zoo_tpu_torch.ops.attention import decode_attention
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    for t in (128, 256, 512, 1024, 2048, 4096):
        q = torch.randn(GEN_SLOTS, 12, 64, generator=gen, device=DEV)
        k, v = [torch.randn(GEN_SLOTS, t, 12, 64, generator=gen,
                            device=DEV) for _ in range(2)]
        lens = torch.full((GEN_SLOTS,), t, dtype=torch.int32, device=DEV)
        kern = time_ms(lambda: decode_attention(q, k, v, lens, impl="flash"))
        dense = time_ms(lambda: decode_attention(q, k, v, lens, impl="xla"))
        rows.append({"t": t, "kernel_ms": kern, "dense_ms": dense,
                     "dense_over_kernel": dense / kern})
        print(f"  T {t}: B11 {kern:.4f} ms, dense {dense:.4f} ms "
              f"(dense/B11 {dense / kern:.2f}) on {card}", flush=True)
        del q, k, v
    detail["decode_crossover"] = rows


def _tree_map(tree, fn):
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def crossover(card, detail):
    """Phase 8: flash vs dense fwd+bwd at the reference's crossover
    geometry (B 4, H 16, D 64, bf16, causal), printed for PERF.md."""
    import torch

    from analytics_zoo_tpu_torch.ops.attention import dot_product_attention
    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = []
    for t in (128, 256, 512, 1024, 2048, 4096):
        qkv = [(torch.randn(4, t, 16, 64, generator=gen, device=DEV)
                ).to(torch.bfloat16).requires_grad_(True) for _ in range(3)]

        def run(impl):
            def f():
                out = dot_product_attention(*qkv, causal=True, impl=impl)
                out.float().sum().backward()
            return f
        flash = time_ms(run("flash"), iters=5, warmup=2)
        dense = time_ms(run("xla"), iters=5, warmup=2)
        rows.append({"tk": t, "flash_ms": flash, "dense_ms": dense,
                     "dense_over_flash": dense / flash})
        print(f"  Tk {t}: flash {flash:.3f} ms, dense {dense:.3f} ms "
              f"(dense/flash {dense / flash:.2f}) on {card}", flush=True)
        del qkv
        torch.cuda.empty_cache()
    detail["crossover"] = rows


# -- recommendation: NeuralCF and Wide&Deep ---------------------------------

def embedding_trap(card, detail):
    """``Embedding``'s lookup at ids -1, n - 1, n and -n - 1 on the card,
    forward and backward, equal to the CPU's: the wrapped row, NaN rows,
    no gradient on the clamped rows. An id out of range that reached the
    gather would fire a device-side assert, which ends the process's
    CUDA context: the phases after this one show it did not."""
    import torch
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.embedding \
        import take_rows
    n = NCF["user_count"]
    table = torch.randn(n, 20, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([-1, n - 1, n, -n - 1, 0], dtype=torch.int32)
    w = torch.randn(5, 20, generator=torch.Generator().manual_seed(1))
    outs = {}
    for dev in ("cpu", DEV):
        t = table.to(dev).requires_grad_(True)
        out = take_rows(t, ids.to(dev))
        loss = torch.sum(torch.where(torch.isnan(out), 0.0, out) * w.to(dev))
        (g,) = torch.autograd.grad(loss, [t])
        outs[dev] = (out.detach().cpu(), g.cpu())
    torch.cuda.synchronize()
    (co, cg), (go, gg) = outs["cpu"], outs[DEV]
    nan_rows = torch.isnan(go).all(-1).tolist()
    check(nan_rows == [False, False, True, True, False],
          f"embedding: NaN rows {nan_rows}, expected ids n and -n-1 only")
    check(torch.equal(go[0], table[n - 1]) and torch.equal(go[1],
                                                          table[n - 1]),
          "embedding: id -1 did not give row n - 1")
    check(torch.equal(torch.nan_to_num(go), torch.nan_to_num(co)),
          "embedding: card rows differ from the CPU's")
    check(torch.equal(gg[n - 1], w[0] + w[1]) and torch.equal(gg[0], w[4]),
          "embedding: the clamped rows got a gradient from invalid ids")
    err = float((gg - cg).abs().max())
    check(err <= 1e-6, f"embedding: table gradient {err} from the CPU's")
    print(f"  Embedding ids (-1, n-1, n, -n-1, 0) at n {n}: rows and "
          f"gradient as on the CPU (gradient max|diff| {err}), NaN rows "
          f"{nan_rows}; no device assert on {card}", flush=True)
    detail["embedding_trap"] = {"nan_rows": nan_rows, "grad_err": err}


def ncf_data(n):
    """bench_ncf.py's draw at ``n`` samples: ``RandomState(0)``, users
    then items, label ``(u + i) % 5``."""
    rs = np.random.RandomState(0)
    users = rs.randint(0, NCF["user_count"], size=n)
    items = rs.randint(0, NCF["item_count"], size=n)
    x = np.stack([users, items], 1).astype(np.int32)
    return x, ((users + items) % 5)[:, None].astype(np.int32)


def on_cpu_and_card(build, compile_kw):
    """The same zoo model built and compiled twice, on the CPU and on
    the card, the card's weights (made first, from seed 0) loaded into
    the CPU's; returns (card model, CPU model)."""
    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    zoo.init_nncontext(seed=0, device="cpu")
    cpu = build().compile(**compile_kw)
    zoo.init_nncontext(seed=0)
    card = build().compile(**compile_kw)
    card.model.estimator._ensure_initialized()
    cpu.model.estimator.params = params_to_numpy(card.model)
    return card, cpu


def held_to_cpu(label, card_m, cpu_m, x, y, batch, steps):
    """``card_m``'s outputs on ``x[:batch]`` and its first ``steps``
    losses (one ``fit`` epoch over ``steps`` batches) against the CPU
    port's on the same weights and batches: outputs within 1e-5 of
    max(1, max|out|), each loss within 1e-4 relative."""
    first = (x[:batch] if isinstance(x, np.ndarray)
             else [a[:batch] for a in x])
    got = card_m.predict(first, batch_size=batch)
    want = cpu_m.predict(first, batch_size=batch)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    check(np.isfinite(got).all() and err <= 1e-5 * scale,
          f"{label}: card output {err} from the CPU's (scale {scale})")
    n = batch * steps
    xs = x[:n] if isinstance(x, np.ndarray) else [a[:n] for a in x]
    lc = card_m.fit(xs, y[:n], batch_size=batch, nb_epoch=1).history
    lp = cpu_m.fit(xs, y[:n], batch_size=batch, nb_epoch=1).history
    lc, lp = lc[-1]["losses"], lp[-1]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    check(len(lc) == steps and all(np.isfinite(lc)) and rel <= 1e-4,
          f"{label}: card losses {lc}, CPU {lp} (max rel {rel})")
    print(f"  {label}: output max|diff| {err:.3e} (scale {scale:.3f}); "
          f"losses card {[round(v, 6) for v in lc]}, CPU "
          f"{[round(v, 6) for v in lp]} (max rel {rel:.2e})", flush=True)
    return {"out_err": err, "out_scale": scale, "losses_card": lc,
            "losses_cpu": lp, "loss_rel": rel}


def ncf_path(card, detail):
    """NeuralCF at bench_ncf.py's configuration through the entry points
    a user calls: held to the CPU port, then timed, profiled and asked
    for recommendations."""
    import torch
    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.models.recommendation import (
        NeuralCF, UserItemFeature)
    from analytics_zoo_tpu_torch.ops.optimizers import Adam
    from analytics_zoo_tpu_torch.pipeline.estimator import MaxIteration
    out = {}
    x, y = ncf_data(NCF_BATCH * NCF_STEPS)
    compile_kw = dict(optimizer=Adam(lr=1e-3), loss="class_nll")
    ncf, cpu = on_cpu_and_card(lambda: NeuralCF(**NCF), compile_kw)
    n_params = sum(v.numel() for v in ncf.model.parameters())
    print(f"  NeuralCF {NCF}: {n_params} params, batch {NCF_BATCH}",
          flush=True)
    out["params"] = n_params
    out["vs_cpu"] = held_to_cpu("NCF", ncf, cpu, x, y, NCF_BATCH, 3)
    del cpu
    est = ncf.model.estimator
    reset_launches()
    torch.cuda.synchronize()
    hist = ncf.fit(x, y, batch_size=NCF_BATCH, nb_epoch=1).history
    torch.cuda.synchronize()
    launches = all_launches()
    check(not any(launches.values()),
          f"NCF: the eleven kernels launched on this path: {launches}")
    losses = hist[-1]["losses"]
    check(len(losses) == NCF_STEPS and all(np.isfinite(losses)),
          f"NCF: {len(losses)} steps, losses {losses}")
    rates = []
    obs.reset_metrics()
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ncf.fit(x, y, batch_size=NCF_BATCH, nb_epoch=1)
        torch.cuda.synchronize()
        rates.append(len(x) / (time.perf_counter() - t))
    wait = obs.snapshot()["zoo_tpu_train_data_wait_seconds"]["values"][0]
    med = statistics.median(rates)
    out.update(samples_per_s=med, samples_per_s_spread=[min(rates),
                                                       max(rates)],
               windows=rates, step_ms=NCF_BATCH / med * 1e3,
               data_wait_ms_per_step=wait["sum"] / wait["count"] * 1e3,
               losses=losses, launches=launches)
    print(f"  NCF train: {out['step_ms']:.3f} ms per step, {med:.1f} "
          f"samples/s (median of 3 epochs of {NCF_STEPS} steps; "
          f"{min(rates):.1f}-{max(rates):.1f}), data wait "
          f"{out['data_wait_ms_per_step']:.3f} ms per step over "
          f"{wait['count']} steps, on {card}", flush=True)
    print("  profile NCF train (3 steps):", flush=True)
    prof = profile_steps(
        lambda: est.train(x, y, batch_size=NCF_BATCH,
                          end_trigger=MaxIteration(est.step + 3)),
        1, (), per=3)
    out["profile"] = prof
    print("    the five largest device rows:", flush=True)
    for k, ms in prof["top"][:5]:
        print(f"      {ms:9.3f} ms per step  {k}", flush=True)
    pairs = [UserItemFeature(int(u), int(i), row)
             for (u, i), row in zip(x[:NCF_BATCH], x[:NCF_BATCH])]
    recs = ncf.recommend_for_user(pairs, max_items=10)
    check(len(recs) > 0 and all(np.isfinite(r.probability) for r in recs),
          "NCF: recommend_for_user gave no finite recommendation")
    times = []
    for _ in range(7):
        t = time.perf_counter()
        ncf.recommend_for_user(pairs, max_items=10)
        times.append(time.perf_counter() - t)
    out["recommend_ms"] = statistics.median(times) * 1e3
    out["recommend_ms_spread"] = [min(times) * 1e3, max(times) * 1e3]
    print(f"  recommend_for_user over {len(pairs)} pairs (top 10 of "
          f"{len({p.user_id for p in pairs})} users): median "
          f"{out['recommend_ms']:.2f} ms per request "
          f"({out['recommend_ms_spread'][0]:.2f}-"
          f"{out['recommend_ms_spread'][1]:.2f}, 7 requests) on {card}",
          flush=True)
    detail["ncf"] = out
    return launches


def wide_and_deep_path(card, detail):
    """``wide_n_deep`` at the ml-1m column layout of the port's example
    (6040 users, 3706 items): forward and one Adam step held to the CPU
    port, then the example's ``main`` once on the card."""
    import torch
    from analytics_zoo_tpu_torch.examples import wide_and_deep as ex
    from analytics_zoo_tpu_torch.models.recommendation import WideAndDeep
    from analytics_zoo_tpu_torch.ops.optimizers import Adam
    users, items, n = NCF["user_count"], NCF["item_count"], 4096
    info = ex.column_info(users, items)
    d = ex.synth_ml1m(n, users, items, np.random.RandomState(0))
    x = list(ex.assembly_feature(d, info))
    y = (d["rating"] - 1)[:, None].astype(np.int32)
    wnd, cpu = on_cpu_and_card(
        lambda: WideAndDeep("wide_n_deep", num_classes=5, column_info=info),
        dict(optimizer=Adam(lr=1e-2), loss="class_nll"))
    # the wide Dense starts at zero: give it weights to carry
    p = cpu.model.params()["wide_linear"]["kernel"]
    w = torch.randn(p.shape, generator=torch.Generator().manual_seed(2))
    for m in (wnd, cpu):
        m.model.params()["wide_linear"]["kernel"].copy_(w * 0.1)
    reset_launches()
    res = held_to_cpu("Wide&Deep", wnd, cpu, x, y, n, 1)
    check(not any(all_launches().values()),
          f"Wide&Deep: the eleven kernels launched: {all_launches()}")
    got = ex.main(["--users", str(users), "--items", str(items),
                   "--samples", "16384", "--batch-size", "1024",
                   "--epochs", "2"])
    check(np.isfinite(got["loss"]) and got["loss"] > 0,
          f"Wide&Deep example: loss {got['loss']}")
    print(f"  examples/wide_and_deep.py main on the card: loss "
          f"{got['loss']:.4f}, validation accuracy {got['accuracy']:.3f}",
          flush=True)
    detail["wide_and_deep"] = {**res, "example": got}


def percentile_ms(lat, q):
    return float(np.percentile(np.asarray(lat) * 1e3, q))


def post_json(port, path, body, headers=None, timeout=600):
    """``(status, response headers, parsed body, seconds)`` of one POST."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, headers=headers or {})
    t0 = time.perf_counter()
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
        code, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        code, hdrs, raw = e.code, e.headers, e.read()
    return code, hdrs, json.loads(raw), time.perf_counter() - t0


def get_json(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def served_counts():
    """The serving counters' totals now: bucket executions, padding
    rows and bucket callables made."""
    from analytics_zoo_tpu_torch.common import observability as obs
    snap = obs.snapshot()
    return {k: int(sum(v["value"] for v in snap.get(
        f"zoo_tpu_serving_{k}_total", {"values": []})["values"]))
        for k in ("batch_executions", "padding_rows", "bucket_compiles")}


def span_means(snap):
    """Mean milliseconds of the serving histograms in ``snap``: the
    handler's time per /predict request, the queue wait, the bucket
    execution (the ``serving/predict`` span: copies in, forward, copies
    out) and the padding."""
    out = {}
    for key, fam in (("request", "zoo_tpu_serving_request_seconds"),
                     ("queue_wait", "zoo_tpu_serving_queue_wait_seconds"),
                     ("predict", "zoo_tpu_serving_predict_seconds"),
                     ("pad", "zoo_tpu_serving_pad_seconds")):
        vals = [v for v in snap.get(fam, {"values": []})["values"]
                if v["labels"].get("path", "/predict") == "/predict"]
        n = sum(v["count"] for v in vals)
        if n:
            out[key] = sum(v["sum"] for v in vals) / n * 1e3
    return out


def recording_batcher():
    """A ``DynamicBatcher`` that keeps each bucket execution's live
    input rows and output rows, to hold them to ``predict`` after."""
    from analytics_zoo_tpu_torch.pipeline.inference import DynamicBatcher

    class Recording(DynamicBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.runs = []

        def _pad_and_run(self, sig, xs, n):
            outs, multi = super()._pad_and_run(sig, xs, n)
            bucket = next(b for b in self.buckets if b >= n)
            self.runs.append((xs[0], n, bucket, outs[0]))
            return outs, multi
    return Recording


def http_resnet(net, dtype, card, detail):
    """Phase 12, part 1: ResNet-50 (``net``, phase 4's weights) served
    over HTTP in ``dtype`` behind a DynamicBatcher (bench_serving's
    settings: max batch 32, 5 ms, queue 512) to HTTP_CLIENTS threads
    posting HTTP_REQUESTS JSON requests of bench_serving's size mix."""
    import torch

    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.ops import cuda_build
    from analytics_zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                            InferenceServer)
    dname = str(dtype).split(".")[-1]
    obs.reset_metrics()
    rs = np.random.RandomState(12)
    x8 = torch.from_numpy(rs.rand(8, *IMAGE).astype(np.float32))
    im = InferenceModel(supported_concurrent_num=2).load_keras_net(
        net, example_inputs=[x8.to(DEV, dtype)])
    batcher = recording_batcher()(im, max_batch_size=BATCH, max_wait_ms=5,
                                  queue_depth=512)
    # images as a client sends them: 3 decimals, one JSON body each
    sizes = [HTTP_MIX[i % len(HTTP_MIX)] for i in range(HTTP_REQUESTS)]
    images = [np.round(rs.rand(n, *IMAGE), 3) for n in sizes]
    bodies = [json.dumps({"inputs": x.tolist()}).encode() for x in images]
    images = [x.astype(np.float32) for x in images]
    t0 = time.perf_counter()
    srv = InferenceServer(im, port=0, batcher=batcher, gen_batcher=None)
    try:
        srv.start()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        health = get_json(srv.port, "/health")["batcher"]
        check(health["warmed_buckets"] == len(batcher.buckets) == 6 and
              health["buckets"] == list(batcher.buckets),
              f"{dname}: /health after warm-up {health}")
        libs, before = cuda_build.loaded(), served_counts()
        reset_launches()
        replies = [None] * HTTP_REQUESTS

        def client(c):
            for i in range(c, HTTP_REQUESTS, HTTP_CLIENTS):
                replies[i] = post_json(srv.port, "/predict", bodies[i])

        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            for f in [pool.submit(client, c) for c in range(HTTP_CLIENTS)]:
                f.result()
        window = time.perf_counter() - t0
        spans = span_means(obs.snapshot())
        # one traced request alone: 3 rows pad to the bucket of 4
        tid = f"smoke-resnet-{dname}"
        code, hdrs, _, _ = post_json(
            srv.port, "/predict",
            json.dumps({"inputs": np.round(rs.rand(3, *IMAGE), 3).tolist()}
                       ).encode(), {"X-Zoo-Trace-Id": tid})
        torch.cuda.synchronize()
        launches = all_launches()
        after = served_counts()
        check(cuda_build.loaded() == libs, f"{dname}: libraries loaded "
              f"after warm-up: {set(cuda_build.loaded()) - set(libs)}")
        traces = get_json(srv.port, "/debug/traces?n=50")["traces"]
        health = get_json(srv.port, "/health")
    finally:
        srv.stop()
    execs = after["batch_executions"] - before["batch_executions"]
    check(after["bucket_compiles"] == before["bucket_compiles"],
          f"{dname}: {after['bucket_compiles'] - before['bucket_compiles']}"
          " bucket callables made after warm-up")
    for name in KERNELS:
        want = {"matmul_bn_apply": 36 * execs,
                "conv3x3_bn_apply": 16 * execs}.get(name, 0)
        check(launches[name] == want, f"{dname}: {name} launched "
              f"{launches[name]} times in {execs} bucket executions, "
              f"expected {want}")
    check(code == 200 and hdrs["X-Zoo-Trace-Id"] == tid,
          f"{dname}: traced request {code}, header "
          f"{hdrs.get('X-Zoo-Trace-Id')}")
    ours = [t for t in traces if t["trace_id"] == tid]
    names = sorted(s["name"] for t in ours for s in t["spans"])
    check(names == sorted(["serving/request", "serving/queue_wait",
                           "serving/pad", "serving/predict",
                           "serving/scatter"]),
          f"{dname}: trace {tid} holds {names}")
    check(health["batcher"]["warmed_buckets"] == 6 and
          health["batcher"]["queue_depth"] == 0, f"/health {health}")
    codes = [r[0] for r in replies]
    check(codes == [200] * HTTP_REQUESTS, f"{dname}: statuses {codes}")

    # each bucket held to predict of the same padded bucket, bit for bit
    # (the traced request's is the last)
    for xs, n, bucket, out in batcher.runs:
        padded = np.concatenate(
            [xs, np.zeros((bucket - n,) + xs.shape[1:], xs.dtype)])
        check(np.array_equal(im.predict(padded)[:n], out),
              f"{dname}: a served bucket of {bucket} ({n} rows) differs "
              "from predict of the same padded bucket")
    # each request: its rows of the bucket it rode, bit for bit, and
    # within the serving bound of the request served alone
    where = {}
    for xs, n, _, out in batcher.runs:
        for r in range(n):
            where.setdefault(xs[r].ravel()[:64].tobytes(), []).append(
                (xs, out, r))
    worst = 0.0
    for i, (x, reply) in enumerate(zip(images, replies)):
        got = np.asarray(reply[2]["outputs"], np.float32)
        hits = [(out, r) for xs, out, r in
                where.get(x[0].ravel()[:64].tobytes(), [])
                if np.array_equal(xs[r:r + len(x)], x)]
        check(len(hits) == 1, f"{dname}: request {i} found in "
              f"{len(hits)} bucket executions")
        out, off = hits[0]
        check(np.array_equal(got, out[off:off + len(x)]),
              f"{dname}: request {i}'s reply is not its bucket's rows")
        alone = im.predict(x)
        err = float(np.abs(got - alone).max())
        tol = TOL[dname] * max(1.0, float(np.abs(alone).max()))
        check(err <= tol, f"{dname}: request {i} {err} from predict "
              f"alone (tol {tol})")
        worst = max(worst, err / tol)
    rows = sum(sizes)
    fill = sum(n for _, n, _, _ in batcher.runs[:-1]) / \
        sum(b for _, _, b, _ in batcher.runs[:-1])
    # the host's JSON work for one image, beside the spans: what a
    # request's handler time is made of
    decode = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.asarray(json.loads(bodies[0])["inputs"], np.float32)
        decode.append(time.perf_counter() - t0)
    decode_ms = statistics.median(decode) * 1e3
    encode = []
    for _ in range(5):
        t0 = time.perf_counter()
        json.dumps({"outputs": alone.tolist()})
        encode.append(time.perf_counter() - t0)
    lat = [r[3] for r in replies]
    rec = {"images": rows, "requests": HTTP_REQUESTS, "window_s": window,
           "images_per_s": rows / window,
           "p50_ms": percentile_ms(lat, 50), "p99_ms": percentile_ms(lat, 99),
           "bucket_executions": execs,
           "mean_bucket_fill": fill, "warm_s": warm_s,
           "worst_err_over_tol": worst, "span_mean_ms": spans,
           "json_decode_ms_per_image": decode_ms,
           "json_encode_ms_per_reply": statistics.median(encode) * 1e3,
           "launches": {k: v for k, v in launches.items() if v}}
    print(f"  ResNet-50 {dname} over HTTP: {HTTP_REQUESTS} requests "
          f"({rows} images) from {HTTP_CLIENTS} clients in {window:.3f} s: "
          f"{rows / window:.2f} images/s, request p50 {rec['p50_ms']:.1f} ms"
          f" p99 {rec['p99_ms']:.1f} ms, {execs} bucket executions, mean "
          f"fill {fill:.3f}, warm-up {warm_s:.2f} s; launches "
          f"{rec['launches']}; worst error {worst:.3f} of its bound; "
          f"on {card}", flush=True)
    print(f"    mean ms: handler {spans.get('request', 0):.2f}, queue wait "
          f"{spans.get('queue_wait', 0):.2f}, bucket execution "
          f"{spans.get('predict', 0):.2f}, pad {spans.get('pad', 0):.2f}; "
          f"JSON decode of one image {decode_ms:.2f} (host, median of 5) "
          f"on {card}", flush=True)
    detail.setdefault("http", {})[f"resnet_{dname}"] = rec
    return launches


def tower_net(device=None):
    """bench_serving.py's MLP tower (``bench_serving.py:70-75``): Dense
    256→4096→4096→512→10 with ReLUs, weights from the context's seed, on
    ``device`` (default: the context's card)."""
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    m = Sequential([L.Dense(4096, activation="relu", input_shape=(256,)),
                    L.Dense(4096, activation="relu"),
                    L.Dense(512, activation="relu"), L.Dense(10)])
    m.init_params(device=device)
    return m


def tower_bodies():
    """bench_serving's request bodies: ``randn(n, 256).round(3)`` for
    each size of its mix, from numpy seed 1."""
    rs = np.random.RandomState(1)
    xs = {n: rs.randn(n, 256).round(3) for n in sorted(set(HTTP_MIX))}
    return ({n: x.astype(np.float32) for n, x in xs.items()},
            {n: json.dumps({"inputs": x.tolist()}).encode()
             for n, x in xs.items()})


def closed_loop(port, bodies, seconds, clients=HTTP_CLIENTS):
    """bench_serving's closed loop: each client POSTs /predict back to
    back, cycling the size mix from its own offset, until the window
    closes. Returns rows, request latencies, non-200 replies, the
    window's seconds and one reply per size."""
    stop_at = time.perf_counter() + seconds
    lock = threading.Lock()
    lat, rows, errors, sample = [], [0], [], {}

    def client(cid):
        i = cid
        while time.perf_counter() < stop_at:
            n = HTTP_MIX[i % len(HTTP_MIX)]
            code, _, body, dt = post_json(port, "/predict", bodies[n])
            with lock:
                if code == 200:
                    lat.append(dt)
                    rows[0] += n
                    sample.setdefault(n, body["outputs"])
                else:
                    errors.append((code, body))
            i += 1

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(clients) as pool:
        for f in [pool.submit(client, c) for c in range(clients)]:
            f.result()
    return rows[0], lat, errors, time.perf_counter() - t0, sample


def tower_run(label, port, xs, bodies, ref, tol, card, detail):
    """One closed-loop run of the tower over HTTP: rows/s, p50/p99, no
    error, and one reply per size held to ``ref(x)`` within ``tol`` of
    max(1, max|ref|)."""
    rows, lat, errors, window, sample = closed_loop(port, bodies,
                                                    TOWER_SECONDS)
    check(not errors, f"tower {label}: {len(errors)} errors {errors[:2]}")
    check(set(sample) == set(xs), f"tower {label}: sizes {set(sample)}")
    worst = 0.0
    for n, out in sample.items():
        want = ref(xs[n])
        got = np.asarray(out, np.float32)
        err = float(np.abs(got - want).max())
        bound = tol * max(1.0, float(np.abs(want).max()))
        check(got.shape == want.shape and err <= bound,
              f"tower {label}: rows of {n} off by {err} (tol {bound})")
        worst = max(worst, err / bound)
    rec = {"rows": rows, "requests": len(lat), "window_s": window,
           "rows_per_s": rows / window, "p50_ms": percentile_ms(lat, 50),
           "p99_ms": percentile_ms(lat, 99), "errors": 0,
           "worst_err_over_tol": worst}
    print(f"  tower {label}: {len(lat)} requests, {rows} rows in "
          f"{window:.3f} s: {rec['rows_per_s']:.1f} rows/s, p50 "
          f"{rec['p50_ms']:.2f} ms, p99 {rec['p99_ms']:.2f} ms, 0 errors on "
          f"{card}", flush=True)
    detail.setdefault("http", {})[f"tower_{label}"] = rec
    return rec


def http_path(card, detail, gen_im):
    """Phase 12: the serving front end over HTTP on the card. ResNet-50
    in f32 and bf16 (:func:`http_resnet`); bench_serving's tower batched
    and per request, then in int8 held to the CPU port's; then
    ``/generate`` on phase 8's engine (``gen_im``, mounted by
    ``load_generator``) beside tower traffic on the same server.
    Returns the kernel launches of the ResNet and generation runs."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.pipeline.inference import (
        DynamicBatcher, InferenceModel, InferenceServer)

    zoo.init_nncontext(seed=0)
    obs.reset_metrics()
    net = served_resnet()
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        for k, v in http_resnet(net, dtype, card, detail).items():
            launches[k] = launches.get(k, 0) + v
    del net
    torch.cuda.empty_cache()

    # the tower: phase 8's InferenceModel takes it beside its generator,
    # so one server answers /predict and /generate
    tower = tower_net()
    xs, bodies = tower_bodies()
    calib = np.random.RandomState(2).randn(8, 256).astype(np.float32)
    gen_im.load_keras_net(tower, example_inputs=[calib])
    per_req = InferenceModel(supported_concurrent_num=2).load_keras_net(
        tower)
    int8 = InferenceModel(supported_concurrent_num=2).load_keras_net(
        tower, example_inputs=[calib], quantize=True)
    # the CPU port's QuantizedModel on the same weights and calibration
    cpu_net = tower_net(device="cpu")
    cpu_net.load_params(params_to_numpy(tower), device="cpu")
    cpu_q = InferenceModel().load_keras_net(cpu_net, example_inputs=[calib],
                                            quantize=True)
    qx = torch.from_numpy(xs[4])
    xq_card = int8.quantized.quantize_input(0, qx.to(DEV))
    xq_cpu = cpu_q.quantized.quantize_input(0, qx)
    check(torch.equal(xq_card.cpu(), xq_cpu),
          "int8: the first layer's quantized input differs from the CPU "
          "port's")
    acc_card = int8.quantized.accumulator(0, xq_card).cpu()
    acc_cpu = cpu_q.quantized.accumulator(0, xq_cpu)
    check(torch.equal(acc_card, acc_cpu), "int8: the first layer's int32 "
          "accumulators differ from the CPU port's")
    check([e["a_scale"] for e in int8.quantized.plan] ==
          [e["a_scale"] for e in cpu_q.quantized.plan],
          "int8: the activation scales differ from the CPU port's")

    servers = {
        "batched": InferenceServer(gen_im, port=0, batcher=DynamicBatcher(
            gen_im, max_batch_size=BATCH, max_wait_ms=5, queue_depth=512)),
        "unbatched": InferenceServer(per_req, port=0, batcher=None,
                                     gen_batcher=None),
        "int8": InferenceServer(int8, port=0, batcher=DynamicBatcher(
            int8, max_batch_size=BATCH, max_wait_ms=5, queue_depth=512),
            gen_batcher=None)}
    try:
        for srv in servers.values():
            srv.start()
        reset_launches()
        recs = {}
        for label in ("batched", "unbatched"):
            recs[label] = tower_run(label, servers[label].port, xs, bodies,
                                    per_req.predict, TOL["float32"], card,
                                    detail)
        recs["int8"] = tower_run("int8", servers["int8"].port, xs, bodies,
                                 cpu_q.predict, 1e-5, card, detail)
        tower_launches = all_launches()
        check(not any(tower_launches.values()),
              f"the tower launched kernels: {tower_launches}")
        f_bytes, q_bytes = int8.quantized.size_bytes()
        ratio = recs["batched"]["rows_per_s"] / \
            recs["unbatched"]["rows_per_s"]
        print(f"  tower batched / unbatched: {ratio:.3f}x rows/s; int8 "
              f"kernels {q_bytes} bytes (f32 {f_bytes}), "
              f"{recs['int8']['rows_per_s']:.1f} rows/s against f32 "
              f"batched {recs['batched']['rows_per_s']:.1f} on {card}",
              flush=True)
        detail["http"]["tower_ratio"] = ratio
        detail["http"]["int8_size_bytes"] = [f_bytes, q_bytes]
        gen = http_generate(servers["batched"], bodies, card, detail)
    finally:
        for srv in servers.values():
            srv.stop()
    for k, v in gen.items():
        launches[k] = launches.get(k, 0) + v
    return launches


def http_generate(srv, tower_bodies_, card, detail):
    """Phase 12, last part: 8 greedy requests posted to ``/generate`` on
    ``srv`` (phase 8's engine, prompts of 17 to 1500 tokens: two of them
    prefill at the bucket of 2048, through B7) from 8 threads while two
    clients post tower requests to ``/predict``; each stream against the
    engine's sequential generate, B11 12 per decode step, B7 12 per
    prefill at buckets >= 1024, slots and pages back to full."""
    import torch

    from analytics_zoo_tpu_torch.common import observability as obs
    eng = srv.model.generator
    net = eng.net
    prompts, max_new, _ = gen_requests()
    prompts, max_new = prompts[:HTTP_GEN], [32] * HTTP_GEN
    check(max(len(p) for p in prompts) >= 1024,
          f"prompt lengths {[len(p) for p in prompts]}")
    buckets = []

    def admit(reqs):            # records each prefill's bucket
        n = max(len(r[0]) for r in reqs)
        buckets.append(next(b for b in eng.prompt_buckets if b >= n))
        return type(eng).admit(eng, reqs)
    eng.admit = admit

    def steps_now():
        fam = obs.snapshot().get("zoo_tpu_serving_gen_steps_total")
        return 0 if fam is None else int(fam["values"][0]["value"])

    steps0 = steps_now()
    done = threading.Event()
    lock = threading.Lock()
    side = {"rows": 0, "errors": []}

    def tower_client(c):
        i = c
        while not done.is_set():
            n = HTTP_MIX[i % len(HTTP_MIX)]
            code, _, body, _ = post_json(srv.port, "/predict",
                                         tower_bodies_[n])
            with lock:
                if code == 200:
                    side["rows"] += n
                else:
                    side["errors"].append((code, body))
            i += 1

    def gen_client(i):
        return post_json(srv.port, "/generate", json.dumps(
            {"prompt": prompts[i], "max_new_tokens": max_new[i]}).encode())

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(HTTP_GEN + 2) as pool:
            towers = [pool.submit(tower_client, c) for c in range(2)]
            replies = [f.result() for f in
                       [pool.submit(gen_client, i) for i in range(HTTP_GEN)]]
            window = time.perf_counter() - t0
            done.set()
            for f in towers:
                f.result()
        torch.cuda.synchronize()
        launches = all_launches()
        steps = steps_now() - steps0
    finally:
        done.set()
        del eng.admit
    codes = [r[0] for r in replies]
    check(codes == [200] * HTTP_GEN, f"/generate statuses {codes}: "
          f"{[r[2] for r in replies if r[0] != 200][:2]}")
    check(not side["errors"], f"/predict beside /generate: "
          f"{len(side['errors'])} errors {side['errors'][:2]}")
    results = [r[2]["tokens"] for r in replies]
    for i, toks in enumerate(results):
        check(len(toks) == max_new[i], f"/generate {i}: {len(toks)} tokens")
    check(eng.slots_active == 0 and
          eng.free_pages == eng.allocator.max_pages,
          f"after /generate: {eng.slots_active} slots active, "
          f"{eng.free_pages} of {eng.allocator.max_pages} pages free")
    nb = GPT["n_block"]
    n_b7 = sum(b >= 1024 for b in buckets)
    check(n_b7 > 0, f"prefill buckets {buckets}: none runs B7")
    for name in KERNELS:
        want = {"flash_decode": nb * steps, "flash_fwd": nb * n_b7}.get(
            name, 0)
        check(launches[name] == want, f"/generate: {name} launched "
              f"{launches[name]} times in {steps} decode steps and {n_b7} "
              f"prefills at buckets >= 1024, expected {want}")
    parted = check_streams(net, eng, prompts, max_new, results)
    n_tok = sum(len(t) for t in results)
    lat = [r[3] for r in replies]
    rec = {"requests": HTTP_GEN, "tokens": n_tok, "window_s": window,
           "tokens_per_s": n_tok / window, "p50_ms": percentile_ms(lat, 50),
           "p99_ms": percentile_ms(lat, 99), "decode_steps": steps,
           "prefill_buckets": buckets, "parted": parted,
           "tower_rows_beside": side["rows"],
           "launches": {k: v for k, v in launches.items() if v}}
    print(f"  /generate over HTTP: {HTTP_GEN} requests, {n_tok} tokens in "
          f"{window:.3f} s ({n_tok / window:.1f} tokens/s), request p50 "
          f"{rec['p50_ms']:.1f} ms p99 {rec['p99_ms']:.1f} ms, {steps} "
          f"decode steps, prefills at {buckets}; {side['rows']} tower rows "
          f"served beside it, 0 errors; launches {rec['launches']} on "
          f"{card}", flush=True)
    detail.setdefault("http", {})["generate"] = rec
    return launches


# -- generation's capacity levers (phase 13) ---------------------------------

def ttft_split(served):
    """TTFT p50/p99 (ms) of the short (<= 200 tokens) and the long (1500)
    prompts of a :func:`serve_generation` record."""
    out = {}
    for name, keep in (("short", lambda n: n <= 200),
                       ("long", lambda n: n >= 1500)):
        lat = [t for t, n in zip(served["ttft"], served["ttft_len"])
               if keep(n)]
        out[name] = {"n": len(lat), "p50_ms": percentile_ms(lat, 50),
                     "p99_ms": percentile_ms(lat, 99)} if lat else None
    return out


def lever_engine(net, params, **kw):
    """A GPT engine at phase 8's geometry (8 slots of 16-token pages, T
    2048) with the given levers, through ``load_generator``, warmed.
    Returns ``(engine, warm seconds, programs warmed)``."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    eng = InferenceModel().load_generator(
        net, params, max_slots=GEN_SLOTS, max_context=GEN_T,
        page_size=GEN_PAGE, **kw).generator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_prog = eng.warm()
    torch.cuda.synchronize()
    check(n_prog == len(eng._programs()), f"warm ran {n_prog} programs of "
          f"{len(eng._programs())}")
    return eng, time.perf_counter() - t0, n_prog


def pools_full(eng, what):
    check(eng.slots_active == 0 and eng.free_pages == eng.allocator.max_pages,
          f"{what}: {eng.slots_active} slots active, {eng.free_pages} of "
          f"{eng.allocator.max_pages} pages free")


def calls_launch(calls, name, want, what):
    """Every recorded call of ``name`` launched exactly ``want(call)``."""
    for i, c in enumerate(calls.get(name, [])):
        exp = {k: v for k, v in want(c).items() if v}
        check(c["launches"] == exp, f"{what}: {name} call {i} launched "
              f"{c['launches']}, expected {exp}")


def levers_chunked(net, params, card, detail):
    """Phase 13, part 1: chunked prefill (C 256) serving phase 8's 16
    requests from 4 clients. Each chunk step launches nothing of the
    eleven (the chunk attends densely, as in the reference), each decode
    step B11 12 times, and no prefill runs B7 (every prompt over 256 is
    chunked); streams under phase 8's rule; forward_chunk's last row for
    the 1500-token prompt in 256-token chunks against the uncached
    forward within 1e-3 of max|logit|; TTFT beside phase 8's."""
    import torch
    nb = GPT["n_block"]
    eng, warm_s, n_prog = lever_engine(net, params, prefill_chunk=LEVER_CHUNK)
    prompts, max_new, _ = gen_requests()
    served = serve_generation(eng)
    calls, log = served["calls"], served["log"]
    calls_launch(calls, "prefill_step", lambda c: {}, "chunked")
    calls_launch(calls, "step", lambda c: {"flash_decode": nb}, "chunked")
    calls_launch(calls, "admit", lambda c: {}, "chunked")
    check(all(b <= LEVER_CHUNK for b in served["buckets"]),
          f"bucket prefills at {served['buckets']}")
    chunks, steps = len(calls["prefill_step"]), len(calls["step"])
    check(served["launches"].get("flash_decode") == nb * steps and
          not served["launches"].get("flash_fwd"),
          f"chunked serving launches {served['launches']}")
    check(served["errors"] == 0, f"{served['errors']} serving errors")
    check(chunks >= 6, f"{chunks} chunk steps")   # 1500 tokens: 6 chunks
    pools_full(eng, "after chunked serving")
    parted = check_streams(net, eng, prompts, max_new,
                           [served["results"][i]
                            for i in range(len(prompts))])

    # forward_chunk's last row against the uncached forward
    long_p = next(p for p in prompts if len(p) == max(GEN_PROMPTS))
    dev = eng.device
    with torch.no_grad():
        cache = net.init_kv_cache(1, GEN_T, page_size=GEN_PAGE, device=dev)
        for off in range(0, len(long_p), LEVER_CHUNK):
            part = long_p[off:off + LEVER_CHUNK]
            ids = torch.zeros(1, LEVER_CHUNK, dtype=torch.int32)
            ids[0, :len(part)] = torch.tensor(part)
            cache, lg = net.forward_chunk(eng.params, cache, ids.to(dev),
                                          [off], [len(part)])
        h = net.call(eng.params, torch.tensor([long_p], device=dev))
        full = h[0, -1] @ eng.params["tok_embed"].T
        err = (lg[0] - full).abs().max().item()
        tol = 1e-3 * full.abs().max().item()
    del cache, h
    print(f"  forward_chunk, {len(long_p)} tokens in chunks of "
          f"{LEVER_CHUNK}: last row against the uncached forward max|err| "
          f"{err:.4e} (tol {tol:.4e})", flush=True)
    check(err <= tol, f"forward_chunk last row {err} > {tol}")

    split = ttft_split(served)
    base = detail["generation"]["ttft_by_prompt_ms"]
    fmt = lambda r: "none" if r is None else \
        f"p50 {r['p50_ms']:.1f} p99 {r['p99_ms']:.1f} ms (n {r['n']})"
    print(f"  chunked (C {LEVER_CHUNK}): {served['tokens']} tokens in "
          f"{served['window']:.3f} s ({served['tokens_per_s']:.1f} tokens/s),"
          f" {steps} decode steps (median {_ms(log.median_ms('step'))}), "
          f"{chunks} chunk steps (median {_ms(log.median_ms('prefill_step'))}"
          f"), bucket prefills {served['buckets']}, warm {n_prog} programs "
          f"in {warm_s:.2f} s; "
          f"TTFT short {fmt(split['short'])}, long {fmt(split['long'])}; "
          f"phase 8 (whole prompts): short {fmt(base['short'])}, long "
          f"{fmt(base['long'])} on {card}", flush=True)
    rec = {"tokens_per_s": served["tokens_per_s"], "window_s":
           served["window"], "tokens": served["tokens"], "decode_steps":
           steps, "chunk_steps": chunks, "buckets": served["buckets"],
           "step_ms": log.median_ms("step"),
           "chunk_step_ms": log.median_ms("prefill_step"),
           "ttft": split, "ttft_phase8": base, "parted": parted,
           "launches": served["launches"], "warm_s": warm_s,
           "forward_chunk_err": err, "forward_chunk_tol": tol}
    del eng
    torch.cuda.empty_cache()
    return rec


class RecordingNet:
    """A net whose ``forward_chunk(all_logits=True)`` keeps its logits
    (the verify's), delegating everything else."""

    def __init__(self, net):
        self._net = net
        self.logits = None

    def __getattr__(self, name):
        return getattr(self._net, name)

    def forward_chunk(self, *args, all_logits=False, **kw):
        cache, lg = self._net.forward_chunk(*args, all_logits=all_logits,
                                            **kw)
        if all_logits:
            self.logits = lg
        return cache, lg


def levers_spec(net, params, card):
    """Phase 13, part 2: speculative decoding, k 4, with the drafter built
    by bench_generate's rule (6 blocks, hidden 384, 6 heads, the vocab),
    on 8 greedy requests (prompts 17, 200, 700 and 1500 twice, 32 new
    tokens). Each round launches B11 24 times (the drafter's 4 steps of 6
    blocks; the verify attends densely), each plain step 12, each bucket
    prefill at >= 1024 B7 12 + 6; streams under phase 8's rule. Then 2
    sampled requests (temperature 0.8), whose drafts the target rejects
    at times: budgets, the vocabulary, the accept rate. Then the
    target drafting for itself on 2 requests: every rejection at a
    top-2 margin of the verify's logits within 1e-3 of max|logit|. Then
    a ``kill`` at ``generation/decode_step`` in a round: the request
    fails, its pages return, the next request is served. Returns the
    record and the launches of the served run."""
    import torch

    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers.transformer \
        import TransformerLayer
    from analytics_zoo_tpu_torch.pipeline.inference import ContinuousBatcher
    from analytics_zoo_tpu_torch.pipeline.inference import \
        generation as gmod
    nb, nd, k = GPT["n_block"], DRAFT["n_block"], LEVER_SPEC_K
    dnet = TransformerLayer(seq_len=GEN_T, **DRAFT)
    dparams = dnet.build(torch.Generator().manual_seed(1), (GEN_T,))
    dparams["tok_embed"] = dparams["tok_embed"] * GEN_EMBED_SCALE
    eng, warm_s, n_prog = lever_engine(net, params, spec_k=k, drafter=dnet,
                                       drafter_params=dparams)
    del dparams
    prompts0, _, _ = gen_requests()
    prompts = [next(p for p in prompts0 if len(p) == n)
               for n in GEN_PROMPTS] * 2
    max_new = [SPEC_NEW] * len(prompts)
    delays = np.random.RandomState(3).uniform(0.0, 0.3, len(prompts))
    served = serve_generation(eng, (prompts, max_new, delays))
    calls, log = served["calls"], served["log"]
    calls_launch(calls, "spec_step", lambda c: {"flash_decode": k * nd},
                 "spec")
    calls_launch(calls, "step", lambda c: {"flash_decode": nb}, "spec")
    bucket = lambda c: next(b for b in eng.prompt_buckets
                            if b >= max(len(r[0]) for r in c["args"][0]))
    calls_launch(calls, "admit", lambda c: {
        "flash_fwd": (nb + nd) if bucket(c) >= 1024 else 0}, "spec")
    rounds, steps = len(calls["spec_step"]), len(calls["step"])
    n_b7 = sum(b >= 1024 for b in served["buckets"])
    check(n_b7 > 0 and rounds > 0, f"{rounds} rounds, buckets "
          f"{served['buckets']}")
    check(served["errors"] == 0, f"{served['errors']} serving errors")
    pools_full(eng, "after speculative serving")
    parted = check_streams(net, eng, prompts, max_new,
                           [served["results"][i]
                            for i in range(len(prompts))])
    st = eng.stats()
    distinct = [len(set(int(t) for t in served["results"][i]))
                for i in range(len(prompts))]
    # the streams must vary for the check above to test the decode path
    # beyond its top logit (ROADMAP C5), and a random drafter must miss
    check(statistics.median(distinct) >= 4,
          f"greedy streams hold a median of {statistics.median(distinct)} "
          f"distinct tokens (per stream {distinct}), expected >= 4")
    check(st["spec_accept_rate"] < 1.0,
          f"the random drafter's greedy accept rate is "
          f"{st['spec_accept_rate']}: its drafts agree with the target")
    # tokens after the first, per slot the target ran a forward for (a
    # round's verify or a plain step)
    decoded = served["tokens"] - len(prompts)
    per_forward = decoded / sum(int(np.asarray(c["args"][0]).sum())
                                for n in ("spec_step", "step")
                                for c in calls[n])
    print(f"  speculative (k {k}, drafter {nd} blocks x {DRAFT['hidden_size']}"
          f"): {served['tokens']} tokens in {served['window']:.3f} s "
          f"({served['tokens_per_s']:.1f} tokens/s), {rounds} rounds "
          f"(median {_ms(log.median_ms('spec_step'))}) and {steps} plain "
          f"steps, accept rate {st['spec_accept_rate']:.4f} "
          f"({st['spec_accepted']} of {st['spec_proposed']}), "
          f"{per_forward:.3f} tokens per target forward, distinct tokens "
          f"per stream {distinct}, bucket prefills "
          f"{served['buckets']}, warm {n_prog} programs in {warm_s:.2f} s "
          f"on {card}", flush=True)
    rec = {"tokens_per_s": served["tokens_per_s"], "window_s":
           served["window"], "tokens": served["tokens"], "rounds": rounds,
           "plain_steps": steps, "round_ms": log.median_ms("spec_step"),
           "accept_rate": st["spec_accept_rate"],
           "proposed": st["spec_proposed"], "accepted": st["spec_accepted"],
           "tokens_per_target_forward": per_forward,
           "distinct_tokens": distinct,
           "buckets": served["buckets"], "parted": parted,
           "launches": served["launches"], "warm_s": warm_s}

    # sampled rounds (temperature 0.8): the target's law rejects drafts,
    # so the residual's draw runs on the card
    before = eng.spec_proposed, eng.spec_accepted
    cb = ContinuousBatcher(eng, queue_depth=8).start()
    try:
        sampled = [[int(t) for t in f.result(600)] for f in
                   [cb.submit(p, max_new_tokens=SPEC_NEW, temperature=0.8)
                    for p in prompts[:2]]]
    finally:
        cb.stop()
    check(all(len(t) == SPEC_NEW and 0 <= min(t) and max(t) < GPT["vocab"]
              for t in sampled), f"sampled streams {sampled}")
    pools_full(eng, "after sampled speculation")
    proposed = eng.spec_proposed - before[0]
    accepted = eng.spec_accepted - before[1]
    print(f"  sampled (temperature 0.8) on 2 requests: accept rate "
          f"{accepted / proposed:.4f} ({accepted} of {proposed}), distinct "
          f"tokens per stream {[len(set(t)) for t in sampled]}", flush=True)
    rec["sampled"] = {"accept_rate": accepted / proposed,
                      "proposed": proposed, "accepted": accepted}

    # a kill at the head of a round fails its request and strands nothing
    cb = ContinuousBatcher(eng, queue_depth=8).start()
    log = LaunchLog(eng, ("spec_step",))
    try:
        faults.arm("generation/decode_step", "kill", times=1)
        try:
            cb.submit(prompts[1], max_new_tokens=SPEC_NEW).result(600)
            killed = None
        except faults.InjectedKillError as e:
            killed = e
        check(killed is not None, "the armed kill did not fail the request")
        check(log.calls["spec_step"][0]["error"] == "InjectedKillError",
              f"the kill fired outside a round: {log.calls['spec_step'][:1]}")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and \
                eng.free_pages != eng.allocator.max_pages:
            time.sleep(0.01)
        pools_full(eng, "after the kill")
        after = cb.submit(prompts[1], max_new_tokens=SPEC_NEW).result(600)
    finally:
        faults.disarm_all()
        cb.stop()
        log.close()
    check_streams(net, eng, prompts[1:2], [SPEC_NEW], [after])
    print(f"  kill at generation/decode_step in a round: the request failed "
          f"({type(killed).__name__}), pages back to "
          f"{eng.free_pages}/{eng.allocator.max_pages}, the next request "
          f"served ({len(after)} tokens)", flush=True)
    rec["kill"] = {"error": type(killed).__name__, "next_tokens": len(after)}
    del eng, dnet
    torch.cuda.empty_cache()

    # the target drafting for itself: rejections only at near ties
    rnet = RecordingNet(net)
    eng, _, _ = lever_engine(rnet, params, spec_k=k, drafter=net,
                             drafter_params=params)
    rejections, state = [], {}
    orig_accept = gmod.speculative_accept

    def accept(seed, p, q, drafts):
        n_acc, corrected = orig_accept(seed, p, q, drafts)
        for s in np.flatnonzero(state["active"]):
            j = int(n_acc[s])
            if j < k:
                row = rnet.logits[s, j].float()
                top2 = row.topk(2).values
                rejections.append({"slot": int(s), "pos": j, "margin": (
                    top2[0] - top2[1]).item(),
                    "tol": 1e-3 * row.abs().max().item()})
        return n_acc, corrected

    orig_round = type(eng).spec_step

    def spec_step(active):
        state["active"] = np.asarray(active, np.bool_)
        return orig_round(eng, active)

    self_prompts = [prompts[1], prompts[3]]
    gmod.speculative_accept = accept
    eng.spec_step = spec_step
    cb = ContinuousBatcher(eng, queue_depth=8).start()
    try:
        outs = [f.result(600) for f in
                [cb.submit(p, max_new_tokens=SPEC_NEW)
                 for p in self_prompts]]
    finally:
        gmod.speculative_accept = orig_accept
        cb.stop()
        del eng.spec_step
    st = eng.stats()
    print(f"  self-draft on {len(self_prompts)} requests: accept rate "
          f"{st['spec_accept_rate']:.4f} ({st['spec_accepted']} of "
          f"{st['spec_proposed']}), rejections {rejections}", flush=True)
    for r in rejections:
        check(r["margin"] <= r["tol"], f"self-draft rejection at top-2 "
              f"margin {r['margin']} > {r['tol']}")
    check_streams(net, eng, self_prompts, [SPEC_NEW] * 2, outs)
    rec["self_draft"] = {"accept_rate": st["spec_accept_rate"],
                         "rejections": rejections}
    del eng
    torch.cuda.empty_cache()
    return rec


def levers_handoff(net, params, card, kv, n_req):
    """Phase 13, part 3: a ``role="prefill"`` and a ``role="decode"``
    engine on the one card, each with its own pool (``kv``) behind its
    own ``ContinuousBatcher``. Every blob goes ``submit_prefill`` →
    ``handoff_to_wire`` → JSON → ``handoff_from_wire`` →
    ``submit_handoff``. The prefills run first (B7 12 per bucket >=
    1024, nothing else), then the decodes (B11 12 per step, nothing
    else); streams under phase 8's rule; no page leaked; both pools
    back to full."""
    import torch

    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.ops import kv_cache as kvc
    from analytics_zoo_tpu_torch.pipeline.inference import ContinuousBatcher
    nb = GPT["n_block"]
    pre, _, _ = lever_engine(net, params, role="prefill", cache_dtype=kv)
    dec, _, _ = lever_engine(net, params, role="decode", cache_dtype=kv)
    prompts, max_new, _ = gen_requests()
    # phase 12's first eight (two of 1500 tokens), or one prompt of each
    # length from the longest down
    pick = list(range(n_req)) if n_req == HTTP_GEN else [
        next(i for i, p in enumerate(prompts) if len(p) == n)
        for n in sorted(GEN_PROMPTS, reverse=True)][:n_req]
    prompts, max_new = [prompts[i] for i in pick], [max_new[i] for i in pick]
    spliced = []

    class DecodeBatcher(ContinuousBatcher):
        def _admit_handoffs(self, entries, done):
            super()._admit_handoffs(entries, done)
            now = time.monotonic()
            spliced.extend(now - e.t_enq for e in entries)

    obs.reset_metrics()
    pre_cb, dec_cb = ContinuousBatcher(pre).start(), DecodeBatcher(dec).start()
    plog = LaunchLog(pre, ("admit",))
    dlog = LaunchLog(dec, ("step", "admit_from_handoff"))
    try:
        reset_launches()
        t0 = time.perf_counter()
        blobs = [f.result(600) for f in
                 [pre_cb.submit_prefill(p, max_new_tokens=m)
                  for p, m in zip(prompts, max_new)]]
        prefill_s = time.perf_counter() - t0
        pre_launch = all_launches()
        wires, wire_s = [], []
        for b in blobs:
            t1 = time.perf_counter()
            wires.append(kvc.handoff_from_wire(json.loads(json.dumps(
                kvc.handoff_to_wire(b)))))
            wire_s.append(time.perf_counter() - t1)
        reset_launches()
        t0 = time.perf_counter()
        results = [f.result(600) for f in
                   [dec_cb.submit_handoff(w, max_new_tokens=m)
                    for w, m in zip(wires, max_new)]]
        decode_s = time.perf_counter() - t0
        dec_launch = all_launches()
        check(pre_cb.drain() and dec_cb.drain(), "drain timed out")
    finally:
        pre_cb.stop()
        dec_cb.stop()
        plog.close()
        dlog.close()
    snap = obs.snapshot()
    leaked = sum(v["value"] for v in snap.get(
        "zoo_tpu_serving_gen_handoff_pages_leaked",
        {"values": []})["values"])
    buckets = plog.buckets()
    n_b7 = sum(b >= 1024 for b in buckets)
    calls_launch(plog.calls, "admit", lambda c: {"flash_fwd": nb if next(
        b for b in pre.prompt_buckets if b >= max(len(r[0]) for r in
                                                  c["args"][0])) >= 1024
        else 0}, f"handoff {kv} prefill")
    calls_launch(dlog.calls, "step", lambda c: {"flash_decode": nb},
                 f"handoff {kv} decode")
    calls_launch(dlog.calls, "admit_from_handoff", lambda c: {},
                 f"handoff {kv} splice")
    steps = len(dlog.calls["step"])
    check(pre_launch.get("flash_fwd", 0) == nb * n_b7 and
          not pre_launch.get("flash_decode") and
          dec_launch.get("flash_decode", 0) == nb * steps and
          not dec_launch.get("flash_fwd"),
          f"handoff {kv}: prefill pool launched {pre_launch}, decode pool "
          f"{dec_launch}")
    check(leaked == 0, f"{leaked} handoff pages leaked")
    pools_full(pre, f"{kv} prefill pool")
    pools_full(dec, f"{kv} decode pool")
    parted = check_streams(net, dec, prompts, max_new, results)
    nbytes = [kvc.handoff_nbytes(b) for b in blobs]
    rec = {"kv_dtype": kv, "requests": n_req, "buckets": buckets,
           "blob_bytes": nbytes, "wire_ms": {
               "p50": percentile_ms(wire_s, 50),
               "p99": percentile_ms(wire_s, 99)},
           "splice_ms": {"p50": percentile_ms(spliced, 50),
                         "p99": percentile_ms(spliced, 99)},
           "prefill_s": prefill_s, "decode_s": decode_s,
           "decode_steps": steps, "step_ms": dlog.median_ms("step"),
           "splice_call_ms": dlog.median_ms("admit_from_handoff"),
           "leaked": leaked, "parted": parted,
           "launches": {"prefill": pre_launch, "decode": dec_launch}}
    print(f"  handoff, {kv} pools: {n_req} requests (prompts "
          f"{sorted(len(p) for p in prompts)}), blobs {min(nbytes)}-"
          f"{max(nbytes)} bytes, wire (encode, JSON, decode) p50 "
          f"{rec['wire_ms']['p50']:.1f} p99 {rec['wire_ms']['p99']:.1f} ms,"
          f" enqueue to spliced p50 {rec['splice_ms']['p50']:.1f} p99 "
          f"{rec['splice_ms']['p99']:.1f} ms; prefills {prefill_s:.3f} s "
          f"at {buckets}, decode {decode_s:.3f} s in {steps} steps (median "
          f"{_ms(dlog.median_ms('step'))}), a splice "
          f"{_ms(dlog.median_ms('admit_from_handoff'))}; leaked "
          f"{leaked} on {card}", flush=True)
    del pre, dec, blobs, wires
    torch.cuda.empty_cache()
    return rec


def levers_path(gen_eng, card, detail):
    """Phase 13: generation's capacity levers on phase 8's model and
    weights (``gen_eng``, whose sequential ``generate`` holds every
    stream): chunked prefill, speculative decoding with a drafter and a
    fault in a round, and the prefill/decode handoff in f32 and int8
    pools. Returns the launches of each part."""
    net, params = gen_eng.net, gen_eng.params
    rec = {"chunked": levers_chunked(net, params, card, detail)}
    rec["spec"] = levers_spec(net, params, card)
    rec["handoff"] = [levers_handoff(net, params, card, "f32", HANDOFF_F32),
                      levers_handoff(net, params, card, "int8",
                                     HANDOFF_INT8)]
    detail["levers"] = rec
    total = {}
    for part in (rec["chunked"]["launches"], rec["spec"]["launches"],
                 *(h["launches"][s] for h in rec["handoff"]
                   for s in ("prefill", "decode"))):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return total


# -- the Estimator's training surface (phase 14) -----------------------------

# bench.py's flagship step (s2d stem, fused="defer", mixed_bfloat16,
# batch 128, SGD 0.1 momentum 0.9) through compile/fit: 3 epochs of 4
# steps, 256 held-out images validated every epoch
SURFACE_STEPS, SURFACE_EPOCHS, SURFACE_VAL = 4, 3, 256
# the unfused ResNet-50's strided convs at batch 128 in bf16 (input NHWC,
# kernel, output channels): the 7x7 stem, the stride-2 3x3 of stages
# 1-3 (v1.5: the stride on the 3x3) and their 1x1 shortcuts
STRIDED_SHAPES = (
    ((TRAIN_BATCH, 224, 224, 3), 7, 64),
    ((TRAIN_BATCH, 56, 56, 128), 3, 128),
    ((TRAIN_BATCH, 28, 28, 256), 3, 256),
    ((TRAIN_BATCH, 14, 14, 512), 3, 512),
    ((TRAIN_BATCH, 56, 56, 256), 1, 512),
    ((TRAIN_BATCH, 28, 28, 512), 1, 1024),
    ((TRAIN_BATCH, 14, 14, 1024), 1, 2048),
)
SURFACE_OPTIMIZERS = ("AdamW", "RMSprop", "Adagrad", "Adadelta", "Adamax")


class RecordingWriter:
    """A TensorBoard writer's interface, recording what it is given (the
    phase does not depend on the ``tensorboard`` package)."""

    def __init__(self):
        self.scalars, self.hists = [], []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))

    def add_histogram(self, tag, values, step):
        self.hists.append((tag, int(step)))

    def flush(self):
        pass


def flagship_model(fused="defer"):
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        resnet50
    return resnet50(input_shape=IMAGE, classes=1000, space_to_depth=True,
                    fused=fused)


def compile_flagship(net):
    """bench.py's optimizer and loss through ``compile``, the
    ``mixed_bfloat16`` policy from ``ZOO_TPU_DTYPE_POLICY`` (the
    Estimator's env route)."""
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    os.environ["ZOO_TPU_DTYPE_POLICY"] = "mixed_bfloat16"
    try:
        net.compile(optimizer=SGD(lr=0.1, momentum=0.9),
                    loss="softmax_cross_entropy", metrics=["accuracy"])
    finally:
        os.environ.pop("ZOO_TPU_DTYPE_POLICY", None)
    check(net.estimator.dtype_policy == "mixed_bfloat16",
          f"policy {net.estimator.dtype_policy} from the environment")
    return net.estimator


def trace_kernels(log_dir):
    """The profile's trace file under ``log_dir`` and which of B1-B4's
    kernel name patterns its events name."""
    files = [os.path.join(root, f) for root, _, fs in os.walk(log_dir)
             for f in fs if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"profile traces under {log_dir}: {files}")
    with open(files[0]) as f:
        names = {e.get("name", "") for e in json.load(f).get(
            "traceEvents", [])}
    found = {label: any(re.search(pat, n) for n in names)
             for label, pat in TRAIN_KERNEL_NAMES[:4]}
    return files[0], found


def state_equal(a, b) -> bool:
    """Two checkpoint states (params tree, optax leaves, step) equal bit
    for bit."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [tree]
    pa, pb = leaves(a["params"]), leaves(b["params"])
    return (a["step"] == b["step"] and len(pa) == len(pb) and
            len(a["opt_state"]) == len(b["opt_state"]) and
            all(x.dtype == y.dtype and np.array_equal(x, y)
                for x, y in zip(pa + list(a["opt_state"]),
                                pb + list(b["opt_state"]))))


def determinism_probe(gen):
    """Each training kernel's wrapper and the s2d stem's cuDNN weight
    gradient run twice on the same inputs at a path shape: which repeat
    bit for bit."""
    import torch
    import torch.nn.functional as F

    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    dev, bf = "cuda", torch.bfloat16
    out = {}

    def twice(fn):
        a, b = fn(), fn()
        return all(torch.equal(x, y) for x, y in zip(a, b))

    x = torch.randn(TRAIN_BATCH, 28, 28, 512, device=dev, generator=gen,
                    dtype=bf)
    w = (torch.randn(512, 128, device=dev, generator=gen) * 0.05).to(bf)
    s = torch.rand(512, device=dev, generator=gen) + 0.5
    t = torch.randn(512, device=dev, generator=gen) * 0.1
    gy = torch.randn(TRAIN_BATCH, 28, 28, 128, device=dev, generator=gen,
                     dtype=bf)

    def b134():
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y, ssum, ssq = cb.conv1x1_bn(xx, ww, in_scale=s, in_shift=t,
                                     relu_in=True)
        dx, dw = torch.autograd.grad((y, ssum, ssq),
                                     (xx, ww), (gy, ssum * 0 + 1e-3,
                                                ssq * 0 + 1e-4))
        return y, ssum, ssq, dx, dw

    out["matmul_bn (B1) + matmul_bn_dx (B3) + matmul_bn_dw (B4)"] = \
        twice(b134)
    x3 = torch.randn(TRAIN_BATCH, 28, 28, 128, device=dev, generator=gen,
                     dtype=bf)
    w3 = (torch.randn(3, 3, 128, 128, device=dev, generator=gen) * 0.05)

    def b2():
        y, ssum, ssq = cb.conv3x3_bn(x3, w3.to(bf))
        return y, ssum, ssq

    out["conv3x3_bn (B2)"] = twice(b2)
    xs = torch.randn(TRAIN_BATCH, 12, 115, 115, device=dev, generator=gen,
                     dtype=bf)
    ws = (torch.randn(64, 12, 4, 4, device=dev, generator=gen) * 0.05).to(bf)
    gs = torch.randn(TRAIN_BATCH, 64, 112, 112, device=dev, generator=gen,
                     dtype=bf)

    def stem():
        wr = ws.clone().requires_grad_()
        return torch.autograd.grad(F.conv2d(xs, wr), wr, gs)

    out["the s2d stem's cuDNN wgrad"] = twice(stem)
    return out


def surface_kernels(net, gen):
    """Phase 14's six kernels against their plain versions at the shapes
    this path gives them, as phase 3 holds its cases but untimed: B1-B4
    at the flagship step's (batch 128, bf16), B5 and B6 at the
    validation pass's (batch 128, bf16 activations; B5 with the f32
    weights the model keeps). Returns the records."""
    b5, b6 = path_shapes(net, TRAIN_BATCH)
    b1, b2 = train_shapes(net, TRAIN_BATCH)
    check(sum(b5.values()) == 36 and sum(b6.values()) == 16 and
          sum(b1.values()) == 36 and sum(b2.values()) == 16,
          f"the flagship's shapes: B5 {sum(b5.values())}, B6 "
          f"{sum(b6.values())} per forward, B1 {sum(b1.values())}, B2 "
          f"{sum(b2.values())} per step; expected 36, 16, 36, 16")
    cases = [("matmul_bn_apply", k, "bfloat16", "float32", False, n)
             for k, n in sorted(b5.items())]
    cases += [("conv3x3_bn_apply", k, "bfloat16", "bfloat16", False, n)
              for k, n in sorted(b6.items())]
    recs = [run_case(c, gen, timing=False) for c in cases]
    cases = [(name, k, "bfloat16", n)
             for name in ("matmul_bn", "matmul_bn_dx", "matmul_bn_dw")
             for k, n in sorted(b1.items())]
    cases += [("conv3x3_bn", k, "bfloat16", n) for k, n in sorted(b2.items())]
    recs += [run_train_case(c, gen, timing=False) for c in cases]
    return recs


def spread_images(rs, n):
    """``n`` seeded images whose brightness steps from 0.25 to 2 across
    the batch, so the logits move with the image (uniform noise images
    of one brightness move a random net's logits by about 3% of their
    size, a bound above that cannot fail a wrong kernel)."""
    scale = np.linspace(0.25, 2.0, n).astype(np.float32)
    return rs.rand(n, *IMAGE).astype(np.float32) * scale[:, None, None,
                                                           None]


def spread_bound(want):
    """A tenth of the logits' spread over the images: the median over
    logit columns of each column's max - min. An output that ignores
    its image misses by up to the spread, so it fails."""
    spread = float(np.median(np.ptp(want, axis=0)))
    return 0.1 * spread, spread


class PerturbedB6:
    """Within the block, every B6 output (the 3x3 eval fold, as the
    fused ResNet calls it) passes through ``fault`` first."""

    def __init__(self, fault):
        self.fault = fault

    def __enter__(self):
        from analytics_zoo_tpu_torch.models.image.imageclassification \
            import resnet
        self.mod, self.orig = resnet, resnet.conv3x3_bn_apply
        resnet.conv3x3_bn_apply = \
            lambda *a, **kw: self.fault(self.orig(*a, **kw))
        return self

    def __exit__(self, *exc):
        self.mod.conv3x3_bn_apply = self.orig


def _scale_channel0(y):
    y = y.clone()
    y[..., 0] *= 1.01
    return y


# faults put into B6's output to show what the validation check fails;
# the first must fail it
B6_FAULTS = (
    ("every image's output replaced by the first's (a batch-stride "
     "fault)", lambda y: y[:1].expand_as(y).contiguous()),
    ("every channel x1.01", lambda y: y * 1.01),
    ("channel 0 x1.01", _scale_channel0),
)


def validation_held(net, est, xv):
    """The fused validation forward (B5 and B6 under ``mixed_bfloat16``)
    against the unfused graph (cuDNN, f32) on the same trained weights
    and images (:func:`spread_images`): every logit within a tenth of
    the logits' spread over the images (:func:`spread_bound`). Then the
    same forward with each of :data:`B6_FAULTS` in B6's output, held to
    the same bound: the first fault must fail it. Returns a record."""
    import torch

    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        convert_resnet_params
    got = est.predict(xv, batch_size=TRAIN_BATCH)
    ref = flagship_model(fused=False)
    ref.init_params()
    ref.load_params(convert_resnet_params(net.params(),
                                          params_to_numpy(ref)))
    want = ref.predict(xv, batch_size=TRAIN_BATCH)
    check(got.shape == want.shape == (len(xv), 1000) and
          np.isfinite(got).all(), f"validation logits {got.shape}")
    err = float(np.abs(got - want).max())
    bound, spread = spread_bound(want)
    print(f"  validation logits (fused, bf16) against the unfused graph "
          f"(f32) on the trained weights: max|err| {err:.4e}, bound "
          f"{bound:.4e} (a tenth of the spread {spread:.4e}, the median "
          f"column's max - min over {len(xv)} images; max|logit| "
          f"{float(np.abs(want).max()):.4e})", flush=True)
    check(err <= bound, f"validation logits: max|err| {err} > {bound}")
    faults = {}
    for label, fault in B6_FAULTS:
        with PerturbedB6(fault):
            bad = est.predict(xv, batch_size=TRAIN_BATCH)
        ferr = float(np.abs(bad - want).max())
        faults[label] = {"max_abs_err": ferr, "fails": ferr > bound}
        print(f"    B6 output with {label}: max|err| {ferr:.4e} -> "
              f"{'fails' if ferr > bound else 'passes'} the bound",
              flush=True)
    first = B6_FAULTS[0][0]
    check(faults[first]["fails"], f"validation check passed B6 with "
          f"{first}: it cannot fail a wrong kernel")
    del ref
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "bound": bound, "spread": spread,
            "faults": faults}


def surface_train(card, ctx, x, y, xv, yv, w0, tmp):
    """Phase 14, part 1: ``fit`` with the whole surface; returns the
    record and the launches of the run."""
    import torch

    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    from analytics_zoo_tpu_torch.perf import flops as flops_lib
    from analytics_zoo_tpu_torch.pipeline.estimator import SeveralIteration
    net = flagship_model()
    net.load_params(w0)
    est = compile_flagship(net)
    ckdir, profdir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "profile")
    net.set_checkpoint(ckdir, SeveralIteration(SURFACE_STEPS))
    net.set_gradient_clipping_by_l2_norm(1.0)
    writer = RecordingWriter()
    net.set_tensorboard(os.path.join(tmp, "tb"), "phase14")
    est._tb_writer = writer                 # injected: never closed
    net.set_summary_trigger("LearningRate", SeveralIteration(2))
    est.set_profile(profdir, start_step=3, n_steps=2)   # steps 3-5
    obs.reset_metrics()
    reset_launches()
    os.environ["ZOO_TPU_ASYNC_CKPT"] = "1"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=SURFACE_EPOCHS,
                      validation_data=(xv, yv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("ZOO_TPU_ASYNC_CKPT", None)
    launches = all_launches()
    residual = dict(cb.residual_launches)
    hist = res.history
    steps = SURFACE_STEPS * SURFACE_EPOCHS
    val_batches = SURFACE_EPOCHS * -(-SURFACE_VAL // TRAIN_BATCH)
    want = {"matmul_bn": 36 * steps, "conv3x3_bn": 16 * steps,
            "matmul_bn_dx": 36 * steps, "matmul_bn_dw": 36 * steps,
            "matmul_bn_apply": 36 * val_batches,
            "conv3x3_bn_apply": 16 * val_batches}
    want.update({k: 0 for k in launches if k not in want})
    print(f"  fit: {len(hist)} epochs, {est.step} steps in {wall:.2f} s; "
          f"launches {launches} (in_residual {residual}); per step B1 "
          f"{launches['matmul_bn'] / steps:g}, B2 "
          f"{launches['conv3x3_bn'] / steps:g}, B3 "
          f"{launches['matmul_bn_dx'] / steps:g}, B4 "
          f"{launches['matmul_bn_dw'] / steps:g}; per validation batch B5 "
          f"{launches['matmul_bn_apply'] / val_batches:g}, B6 "
          f"{launches['conv3x3_bn_apply'] / val_batches:g}", flush=True)
    check(launches == want, f"fit's launches {launches}, expected {want}")
    check(residual == {"matmul_bn": 8 * steps, "matmul_bn_dx": 8 * steps},
          f"in_residual launches {residual}, expected {8 * steps} each")
    check(est.step == steps, f"{est.step} steps, expected {steps}")
    losses = [v for h in hist for v in h["losses"]]
    vals = [(h["val_loss"], h["val_accuracy"]) for h in hist]
    print(f"  losses {[round(v, 4) for v in losses]}; validation (loss, "
          f"accuracy) {[(round(a, 4), round(b, 4)) for a, b in vals]}",
          flush=True)
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"losses {losses}")
    check(all(np.isfinite(v) for pair in vals for v in pair),
          f"validation {vals}")
    # the ledger: every epoch's summary, its shares summing to 1 (each is
    # rounded to 6 decimals: 4 x 5e-7), the live gauges exactly
    for h in hist:
        gp = h.get("goodput")
        check(gp is not None and gp["steps"] == SURFACE_STEPS,
              f"epoch {h['epoch']}: goodput {gp}")
        check(abs(sum(gp["shares"].values()) - 1.0) <= 2e-6,
              f"epoch {h['epoch']}: shares {gp['shares']}")
    snap = obs.snapshot()
    shares = sum(v["value"] for v in
                 snap["zoo_tpu_goodput_share"]["values"])
    check(abs(shares - 1.0) <= 1e-6, f"goodput share gauges sum {shares}")
    mem = {v["labels"]["kind"]: v["value"] for v in
           snap["zoo_tpu_device_memory_bytes"]["values"]}
    check(set(mem) == {"in_use", "peak", "limit"} and
          all(v > 0 for v in mem.values()), f"device memory gauges {mem}")
    for name in ("zoo_tpu_train_first_step_seconds", "zoo_tpu_learning_rate",
                 "zoo_tpu_train_throughput_examples_per_sec"):
        v = snap[name]["values"][0]["value"]
        check(v > 0, f"{name} = {v}")
    tags = collections.Counter(t for t, _, _ in writer.scalars)
    print(f"  summaries: {dict(tags)}", flush=True)
    check(tags["Loss"] == steps and tags["Throughput"] == SURFACE_EPOCHS and
          tags["Validation/loss"] == SURFACE_EPOCHS and
          tags["Validation/accuracy"] == SURFACE_EPOCHS and
          tags["LearningRate"] >= steps, f"summary tags {dict(tags)}")
    check(est._tb_writer is writer, "the injected writer was dropped")
    trace_file, found = trace_kernels(profdir)
    print(f"  profile {os.path.basename(trace_file)}: {found}", flush=True)
    check(all(found.values()), f"the profile misses kernels: {found}")
    # checkpoints: SeveralIteration(4) at steps 4, 8, 12
    ck = sorted(f for f in os.listdir(ckdir) if f.startswith("ckpt_"))
    with open(os.path.join(ckdir, "LATEST")) as f:
        latest = f.read().strip()
    check(ck == [f"ckpt_{s}.pkl" for s in (12, 4, 8)] and
          latest == f"ckpt_{steps}.pkl", f"checkpoints {ck}, LATEST {latest}")
    # the step's FLOPs, counted inside the first step
    flops_fused = est.flops_per_step
    want_flops = TRAIN_FLOP_PER_IMAGE * TRAIN_BATCH
    gps = [h["goodput"] for h in hist]
    rates = [h["throughput"] for h in hist]
    rec = {"wall_s": wall, "losses": losses, "validation": vals,
           "launches": launches, "residual_launches": residual,
           "goodput": gps, "device_memory_bytes": mem,
           "summary_tags": dict(tags), "profile": found,
           "flops_per_step": flops_fused,
           "top_ops": [o._asdict() for o in
                       flops_lib.top_ops(est.flop_ops, 8)],
           "images_per_s_epochs": rates}
    print(f"  flops per step (perf/flops.py, fused defer): "
          f"{flops_fused:.6e}, against TRAIN_FLOP_PER_IMAGE x "
          f"{TRAIN_BATCH} = {want_flops:.6e} "
          f"({flops_fused / want_flops:.4f}x)", flush=True)
    for o in flops_lib.top_ops(est.flop_ops, 5):
        print(f"    {o.name} {o.kind} {o.flops:.4e} {o.detail}", flush=True)
    check(abs(flops_fused / want_flops - 1.0) <= 0.05,
          f"counted {flops_fused:.4e} FLOPs per step, expected "
          f"{want_flops:.4e} within 5%")
    lo, hi = min(rates), max(rates)
    print(f"  images/s per epoch (step loop: epoch 1 holds the first "
          f"step's count and the profile, each epoch a checkpoint) "
          f"{[round(r, 1) for r in rates]}: median "
          f"{statistics.median(rates):.1f} ({lo:.1f}-{hi:.1f}) on {card}",
          flush=True)
    for h in hist:
        gp = h["goodput"]
        print(f"  epoch {h['epoch']} ledger: wall {gp['wall_s']:.4f} s, "
              f"shares {gp['shares']}, MFU {gp['mfu']} (peak "
              f"{gp['peak_flops']:.3e}, {gp['device_kind']})", flush=True)
    rec["validation_logits"] = validation_held(net, est, xv)
    net._estimator = None
    del net, est
    torch.cuda.empty_cache()
    return rec, launches


def surface_flops_unfused(w0):
    """The step's count on the unfused s2d graph (cuDNN and cuBLAS,
    which the dispatch mode sees), one step through ``fit``."""
    import torch

    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        convert_resnet_params
    from analytics_zoo_tpu_torch.pipeline.estimator import MaxIteration
    net = flagship_model(fused=False)
    net.init_params()
    net.load_params(convert_resnet_params(w0, params_to_numpy(net)))
    est = compile_flagship(net)
    rs = np.random.RandomState(5)
    x = rs.rand(TRAIN_BATCH, *IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, size=(TRAIN_BATCH, 1)).astype(np.int32)
    reset_launches()
    net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1,
            end_trigger=MaxIteration(1))
    launches = all_launches()
    check(not any(launches.values()), f"unfused launches {launches}")
    out = est.flops_per_step
    net._estimator = None
    del net, est
    torch.cuda.empty_cache()
    return out


def surface_resume(card, ctx, xa, ya, xb, yb, w0, tmp):
    """Phase 14, part 2: 8 steps uninterrupted against 4 steps, a
    checkpoint, a fresh model and Estimator, ``load_checkpoint`` and 4
    more; the checkpoint's bytes and write time, synchronous and async;
    then an ``error`` armed at ``estimator/checkpoint_write`` under
    an async write."""
    import torch

    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common.faults import InjectedFaultError
    from analytics_zoo_tpu_torch.common.safe_pickle import checked_load
    from analytics_zoo_tpu_torch.pipeline.estimator import MaxIteration

    def fresh():
        net = flagship_model()
        net.load_params(w0)
        return net, compile_flagship(net)

    def fit(net, x, y):
        return [v for h in net.fit(x, y, batch_size=TRAIN_BATCH,
                                   nb_epoch=1).history for v in h["losses"]]

    a, _ = fresh()
    uninterrupted = fit(a, xa, ya) + fit(a, xb, yb)
    a._estimator = None
    del a
    b, est_b = fresh()
    first = fit(b, xa, ya)
    d = os.path.join(tmp, "resume")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = est_b.save_checkpoint(d, block=True)
    sync_ms = (time.perf_counter() - t0) * 1e3
    nbytes = os.path.getsize(path)
    saved = checked_load(path)
    c, est_c = fresh()
    est_c.load_checkpoint(d)
    restored = est_c.checkpoint_state()
    check(state_equal(saved, restored), "the restored params, optimizer "
          "state and step differ from the saved ones")
    resumed = fit(c, xb, yb)
    bit_equal = resumed == uninterrupted[SURFACE_STEPS:]
    rel = max(abs(p - q) / max(abs(q), 1e-12) for p, q in
              zip(resumed, uninterrupted[SURFACE_STEPS:]))
    probe = determinism_probe(torch.Generator(device="cuda").manual_seed(7))
    print(f"  resume: uninterrupted {[round(v, 6) for v in uninterrupted]}, "
          f"resumed steps 5-8 {[round(v, 6) for v in resumed]}: bit-equal "
          f"{bit_equal} (max relative difference {rel:.3e}); first 4 "
          f"steps equal {first == uninterrupted[:SURFACE_STEPS]}; "
          f"repeats bit for bit: {probe}", flush=True)
    check(bit_equal or rel <= 1e-3, f"resumed losses differ by {rel:.3e}")
    # the write, synchronous (above) and async: the copy from the card
    # is synchronous, the pickle and the write on a thread
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est_c.save_checkpoint(d, block=False)
    return_ms = (time.perf_counter() - t0) * 1e3
    est_c.wait_for_checkpoint()
    async_ms = (time.perf_counter() - t0) * 1e3
    print(f"  checkpoint: {nbytes} bytes; synchronous write {sync_ms:.1f} "
          f"ms; async save returns in {return_ms:.1f} ms, written in "
          f"{async_ms:.1f} ms on {card}", flush=True)
    # a failed async write surfaces at the next wait; LATEST keeps the
    # last good file, and a resume from it runs
    good = f"ckpt_{est_c.step}.pkl"
    fit(c, xa[:TRAIN_BATCH], ya[:TRAIN_BATCH])
    faults.arm("estimator/checkpoint_write", "error", times=1)
    try:
        est_c.save_checkpoint(d, block=False)
        raised = False
        try:
            est_c.wait_for_checkpoint()
        except InjectedFaultError:
            raised = True
    finally:
        faults.disarm("estimator/checkpoint_write")
    with open(os.path.join(d, "LATEST")) as f:
        latest = f.read().strip()
    check(raised, "the armed checkpoint write did not raise at the wait")
    check(latest == good, f"LATEST names {latest} after the failed write, "
          f"expected {good}")
    c._estimator = None
    del b, c, est_b, est_c
    e, est_e = fresh()
    est_e.load_checkpoint(d)
    after = e.fit(xa[:TRAIN_BATCH], ya[:TRAIN_BATCH],
                  batch_size=TRAIN_BATCH, nb_epoch=1,
                  end_trigger=MaxIteration(est_e.step + 1)).history
    check(all(np.isfinite(h["loss"]) for h in after), f"resume {after}")
    print(f"  async write with estimator/checkpoint_write armed: raised at "
          f"the wait {raised}, LATEST {latest}, resumed from it at step "
          f"{est_e.step - 1}: loss {after[-1]['loss']:.6f}", flush=True)
    e._estimator = None
    del e, est_e
    torch.cuda.empty_cache()
    return {"uninterrupted": uninterrupted, "resumed": resumed,
            "bit_equal": bit_equal, "max_rel": rel, "repeats": probe,
            "checkpoint_bytes": nbytes, "sync_write_ms": sync_ms,
            "async_return_ms": return_ms, "async_write_ms": async_ms,
            "fault_raised": raised}


def surface_optimizers(card):
    """Phase 14, part 3: one step of each optimizer the slice adds,
    through ``fit`` of a small dense net on the card and on the CPU: the
    card's update against the CPU port's on the same params, state and
    gradients (1e-6 of each param's max|value|); the card's gradients
    against the CPU port's (1e-5 of each gradient's max|value|); and the
    whole step against the CPU port's step (1e-5 of each param's
    max|value|: cuBLAS against the CPU's products, whose rounding the
    adaptive methods scale up where a gradient is near 0; 3.09e-6 read
    for RMSprop on an H100)."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.ops import optimizers as topt
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Sequential
    from analytics_zoo_tpu_torch.pipeline.estimator import MaxIteration
    rs = np.random.RandomState(11)
    x = rs.randn(64, 32).astype(np.float32)
    y = rs.randn(64, 8).astype(np.float32)

    def rel(a, b):
        return float(np.abs(a - b).max() / max(float(np.abs(b).max()),
                                               1e-30))

    out = {}
    for name in SURFACE_OPTIMIZERS:
        after, seen = {}, {"cuda": {}, "cpu": {}}
        for dev in ("cuda", "cpu"):
            zoo.init_nncontext(seed=0, device=dev)
            m = Sequential()
            m.add(L.Dense(64, activation="tanh", input_shape=(32,)))
            m.add(L.Dense(8))
            opt = getattr(topt, name)(lr=0.01)
            m.compile(optimizer=opt, loss="mse")

            def spy(leaves, grads, state, update=opt.update, got=seen[dev]):
                host = lambda ts: [t.detach().cpu().clone() for t in ts]
                got.update(leaves=host(leaves), grads=host(grads),
                           state={k: v if k == "count" else host(v)
                                  for k, v in state.items()})
                update(leaves, grads, state)
                got["after"] = host(leaves)
            opt.update = spy
            m.fit(x, y, batch_size=64, nb_epoch=1,
                  end_trigger=MaxIteration(1))
            after[dev] = params_to_numpy(m)
        card_, cpu_ = seen["cuda"], seen["cpu"]
        # the CPU port's update on the card's own params, state and grads
        ref = getattr(topt, name)(lr=0.01)
        leaves = card_["leaves"]
        ref.update(leaves, card_["grads"], card_["state"])
        err = max(rel(a.numpy(), b.numpy())
                  for a, b in zip(card_["after"], leaves))
        grad_err = max(rel(a.numpy(), b.numpy())
                       for a, b in zip(card_["grads"], cpu_["grads"]))
        step_err = max(rel(after["cuda"][lyr][k], v)
                       for lyr, sub in after["cpu"].items()
                       for k, v in sub.items())
        out[name] = {"update": err, "grads": grad_err, "step": step_err}
        check(err <= 1e-6, f"{name}'s update on the card against the CPU "
              f"port's: relative {err:.3e}")
        check(grad_err <= 1e-5, f"{name}: the card's gradients against the "
              f"CPU port's: relative {grad_err:.3e}")
        check(step_err <= 1e-5, f"{name}'s step on the card against the CPU "
              f"port's: relative {step_err:.3e}")
    zoo.init_nncontext(seed=0)
    print("  optimizers, one step on the card against the CPU port's (max "
          "relative error per param or gradient): " + "; ".join(
              f"{k} update {v['update']:.2e} (on the same gradients), "
              f"gradients {v['grads']:.2e}, step {v['step']:.2e}"
              for k, v in out.items()) + f" on {card}", flush=True)
    return out


def surface_conv_grad(card, gen):
    """Phase 14, part 4: the phase-decomposed backward
    (``ZOO_TPU_PHASE_BWD=1``) against cuDNN's strided dgrad/wgrad at the
    unfused ResNet-50's strided convs, batch 128, bf16: gradients within
    2e-2 of max|grad|, the ms of each."""
    import torch

    from analytics_zoo_tpu_torch.ops import conv_grad
    bf = torch.bfloat16
    rows = []
    for xshape, k, cout in STRIDED_SHAPES:
        x = torch.randn(*xshape, device="cuda", generator=gen, dtype=bf)
        w = (torch.randn(k, k, xshape[-1], cout, device="cuda",
                         generator=gen) / (k * k * xshape[-1]) ** 0.5
             ).to(bf)
        grads, ms = {}, {}
        for label, phase in (("phase", True), ("cudnn", False)):
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = conv_grad.conv2d(xr, wr, 2, "SAME", phase_bwd=phase)
            g = torch.randn(y.shape, device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(3), dtype=bf)
            grads[label] = torch.autograd.grad(y, (xr, wr), g,
                                               retain_graph=True)
            ms[label] = time_ms(lambda: torch.autograd.grad(
                y, (xr, wr), g, retain_graph=True))
            del y
        errs = [float((a.float() - b.float()).abs().max() /
                      b.float().abs().max())
                for a, b in zip(grads["phase"], grads["cudnn"])]
        rows.append({"x": list(xshape), "k": k, "cout": cout,
                     "phase_ms": ms["phase"], "cudnn_ms": ms["cudnn"],
                     "dx_err": errs[0], "dw_err": errs[1]})
        print(f"  conv_grad {k}x{k}/2 x {xshape} -> {cout}: phase "
              f"{ms['phase']:.4f} ms, cuDNN {ms['cudnn']:.4f} ms "
              f"({ms['cudnn'] / ms['phase']:.2f}x), dx err {errs[0]:.2e}, "
              f"dw err {errs[1]:.2e} (of max|grad|)", flush=True)
        check(max(errs) <= 2e-2, f"phase backward at {xshape} k {k}: "
              f"errors {errs}")
        del x, w, grads
    wins = all(r["phase_ms"] < r["cudnn_ms"] for r in rows)
    print(f"  the phase backward wins on every shape in this run: {wins} "
          f"(PHASE_MEASURED_WIN = {conv_grad.PHASE_MEASURED_WIN}) on "
          f"{card}", flush=True)
    torch.cuda.empty_cache()
    return {"shapes": rows, "phase_wins_all": wins}


def surface_path(card, detail):
    """Phase 14: the Estimator's whole training surface on bench.py's
    flagship step; returns the launches of the ``fit`` run."""
    import tempfile

    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    ctx = zoo.init_nncontext(seed=0)
    rs = np.random.RandomState(14)
    n = SURFACE_STEPS * TRAIN_BATCH
    x = rs.rand(n, *IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, size=(n, 1)).astype(np.int32)
    xv = spread_images(rs, SURFACE_VAL)
    yv = rs.randint(0, 1000, size=(SURFACE_VAL, 1)).astype(np.int32)
    net = flagship_model()
    net.init_params()
    w0 = params_to_numpy(net)
    rec = {"kernel_cases": surface_kernels(
        net, torch.Generator(device="cuda").manual_seed(14))}
    del net
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "chiprun_out")
                                     ) as tmp:
        rec["fit"], launches = surface_train(card, ctx, x, y, xv, yv, w0,
                                             tmp)
        unfused = surface_flops_unfused(w0)
        fused = rec["fit"]["flops_per_step"]
        mfu5 = detail.get("train", {}).get("s2d_defer", {}).get("mfu")
        print(f"  flops per step: fused defer {fused:.6e}, unfused "
              f"(cuDNN/cuBLAS) {unfused:.6e} ({fused / unfused:.5f}x); the "
              f"ledger's MFU {rec['fit']['goodput'][-1]['mfu']} (last "
              f"epoch), phase 5's model-FLOPs MFU of the s2d defer step "
              f"{mfu5} on {card}", flush=True)
        check(abs(fused / unfused - 1.0) <= 0.01, f"fused count {fused:.4e} "
              f"against unfused {unfused:.4e}: more than 1% apart")
        rec["flops_unfused"] = unfused
        xb = rs.rand(n, *IMAGE).astype(np.float32)
        yb = rs.randint(0, 1000, size=(n, 1)).astype(np.int32)
        rec["resume"] = surface_resume(card, ctx, x, y, xb, yb, w0, tmp)
    del x, xv, xb
    rec["optimizers"] = surface_optimizers(card)
    rec["conv_grad"] = surface_conv_grad(
        card, torch.Generator(device="cuda").manual_seed(0))
    detail["surface"] = rec
    torch.cuda.empty_cache()
    return launches


# -- image classification (phase 15) ------------------------------------------

IC_SERVE = (1, 8, 32)
IC_TRAIN_STEPS, IC_TRAIN_EPOCHS = 5, 3
IC_TRANSFER_N, IC_TRANSFER_BATCH = 256, 32
IC_OTHERS = ("vgg-16", "vgg-19", "mobilenet", "mobilenet-v2",
             "densenet-121", "squeezenet")
# the archs whose f32 step is held too: the depthwise and the average
# pool backward
IC_OTHER_STEP = ("mobilenet-v2", "densenet-121")
# the scale the head's kernel is set to give the held logits
IC_LOGIT_MAX = 10.0


def logits_held(label, got, want, rel, what="logit"):
    """``got`` within ``rel`` of max(1, max|want|) of the CPU port's
    ``want``, a bound that must lie below the outputs' spread over the
    inputs (the median column's max - min), or the check could not fail
    an output that ignores its input. ``what`` names the outputs."""
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{label}: {what}s {got.shape}, want {want.shape}")
    err = float(np.abs(got - want).max())
    tol = rel * max(1.0, float(np.abs(want).max()))
    spread = spread_bound(want)[1]
    print(f"  {label}: max|err| {err:.4e} (tol {tol:.4e}, below the "
          f"{what}s' spread {spread:.4e}; max|{what}| "
          f"{float(np.abs(want).max()):.4e})", flush=True)
    check(tol < spread, f"{label}: tol {tol} is not below the spread "
          f"{spread}, so the check could not fail")
    check(err <= tol, f"{label}: max|err| {err} > {tol}")
    return {"max_abs_err": err, "tol": tol, "spread": spread}


def scale_head(net, x):
    """Scale the kernel of ``net``'s last layer with weights (its head)
    so that its logits on ``x`` reach :data:`IC_LOGIT_MAX`: at random
    init they are ~1e-3, below the max(1, ...) floor of every logit
    bound. Every net here is positively homogeneous in that kernel (a
    Dense, or SqueezeNet's conv10 before a ReLU). Returns the factor."""
    import torch
    head = [lyr for lyr in net.layers if "kernel" in lyr.params()][-1]
    peak = float(np.abs(net.predict(x, batch_size=len(x))).max())
    factor = IC_LOGIT_MAX / peak
    with torch.no_grad():
        head.params()["kernel"].mul_(factor)
    return factor


def cpu_twin(name, net):
    """``ImageClassifier(name)``'s net on the CPU with ``net``'s
    weights."""
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    cpu = ImageClassifier(name, input_shape=IMAGE, classes=1000).model
    cpu.load_params(params_to_numpy(net), device="cpu")
    return cpu


def f32_step(ctx, name, w0, x, y, jitter=0.0):
    """One f32 SGD step (0.1, momentum 0.9, softmax cross entropy) of
    ``ImageClassifier(name)`` from ``w0`` on ``(x, y)`` on ``ctx``'s
    device, every Dropout's rate 0 on this instance: the loss and the
    weights after it."""
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dropout
    from analytics_zoo_tpu_torch.pipeline.estimator import (Estimator,
                                                            MaxIteration)
    net = ImageClassifier(name, input_shape=IMAGE, classes=1000).model
    net.load_params(w0, device=ctx.device)
    for lyr in net.layers:
        if isinstance(lyr, Dropout):
            lyr.p = 0.0
    est = Estimator(net, optimizer=SGD(lr=0.1, momentum=0.9),
                    loss="softmax_cross_entropy", ctx=ctx)
    res = est.train(x * (1.0 + jitter), y, batch_size=len(x),
                    end_trigger=MaxIteration(1))
    return res.history[-1]["losses"][0], params_to_numpy(net)


def step_held(label, name, w0, x, y, held=(), shown=(), bn_layers=()):
    """One f32 step on the card (TF32 off) against the CPU port's from
    the same weights and batch: the loss within 1e-4 relative; each
    ``held`` leaf after the step within 1e-5 of its max|param|, or twice
    the card's own movement when its input moves by 1e-6 (relative),
    whichever is larger; moving statistics within 1e-4 of max(1,
    max|stat|). The ``shown`` leaves are printed beside that movement
    and not held: random init's first step is ill-conditioned in the
    early and middle layers (phase 5), where a 1e-6 change of the input
    moves an update as far as the card's rounding does."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    card_ctx = zoo.init_nncontext(seed=0)
    lc, pc = f32_step(card_ctx, name, w0, x, y)
    pj = f32_step(card_ctx, name, w0, x, y, jitter=1e-6)[1] \
        if held or shown else None
    torch.cuda.empty_cache()
    lp, pp = f32_step(zoo.init_nncontext(seed=0, device="cpu"), name, w0,
                      x, y)
    zoo.init_nncontext(seed=0)
    rel = abs(lc - lp) / abs(lp)
    print(f"  {label}: one f32 step at batch {len(x)}: loss card {lc:.6f}, "
          f"CPU {lp:.6f} (rel {rel:.2e}, tol 1e-4)", flush=True)
    check(np.isfinite(lc) and rel <= 1e-4, f"{label}: loss {lc} vs {lp}")
    out = {"loss_card": lc, "loss_cpu": lp, "loss_rel": rel}
    for layer, leaf in held + shown:
        got, want = pc[layer][leaf], pp[layer][leaf]
        err = float(np.abs(got - want).max())
        jit = float(np.abs(pj[layer][leaf] - got).max())
        peak = float(np.abs(want).max())
        if (layer, leaf) in held:
            tol = max(1e-5 * peak, 2.0 * jit)
            print(f"    {layer}/{leaf} after the step: max|card - CPU| "
                  f"{err:.4e} (tol {tol:.4e}: 1e-5 of max|param| "
                  f"{peak:.4e}, or twice the card's 1e-6 jitter "
                  f"{jit:.4e})", flush=True)
            check(err <= tol, f"{label}: {layer}/{leaf} {err} > {tol}")
            out[f"{layer}/{leaf}"] = (err, tol)
        else:
            print(f"    {layer}/{leaf} after the step (shown, not held): "
                  f"max|card - CPU| {err:.4e}, the card's 1e-6 jitter "
                  f"{jit:.4e}, max|param| {peak:.4e}", flush=True)
            out[f"{layer}/{leaf}"] = (err, jit)
    for layer in bn_layers:
        for leaf in ("moving_mean", "moving_var"):
            want = pp[layer]["_state"][leaf]
            err = float(np.abs(pc[layer]["_state"][leaf] - want).max())
            tol = 1e-4 * max(1.0, float(np.abs(want).max()))
            check(err <= tol, f"{label}: {layer}/{leaf} {err} > {tol}")
            out[f"{layer}/{leaf}"] = (err, tol)
    if bn_layers:
        worst = max(out[f"{b}/{leaf}"][0] for b in bn_layers
                    for leaf in ("moving_mean", "moving_var"))
        print(f"    moving statistics of {list(bn_layers)} within 1e-4 of "
              f"max(1, max|stat|): worst max|card - CPU| {worst:.4e}",
              flush=True)
    return out


def lenet_run(card):
    """Phase 15, part 1: LeNet-5 as ``examples/lenet_mnist.py`` trains
    it (SGD 0.01, momentum 0.9, batch 64, 2 epochs of 512 images), on
    ``datasets.mnist``'s synthetic stand-in; then one epoch of the card
    at ``dropout=0.0`` against the CPU port's."""
    import tempfile

    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        lenet5
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.api.keras.datasets import mnist
    with tempfile.TemporaryDirectory() as empty:   # no cache: synthetic
        (xtr, ytr), (xte, yte) = mnist.load_data(empty)
    x = (xtr[:512] / 255.0).astype(np.float32)
    y = ytr[:512].reshape(-1, 1).astype(np.int32)
    xv = (xte[:128] / 255.0).astype(np.float32)
    yv = yte[:128].reshape(-1, 1).astype(np.int32)

    def compiled(dropout):
        m = lenet5(input_shape=(28, 28, 1), classes=10, dropout=dropout)
        m.compile(optimizer=SGD(lr=0.01, momentum=0.9),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        return m

    zoo.init_nncontext(seed=0)
    m = compiled(0.5)
    torch.cuda.synchronize()
    t = time.perf_counter()
    hist = m.fit(x, y, batch_size=64, nb_epoch=2,
                 validation_data=(xv, yv)).history
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    metrics = m.evaluate(xv, yv, batch_size=64)
    losses = [v for h in hist for v in h["losses"]]
    rates = [h["throughput"] for h in hist]
    print(f"  lenet-5: {len(losses)} steps at batch 64 on mnist's "
          f"synthetic stand-in, epoch losses "
          f"{[round(h['loss'], 4) for h in hist]}, images/s per epoch "
          f"{[round(r, 1) for r in rates]} ({2 * len(x) / wall:.1f} over "
          f"both, validation included); test {metrics} on {card}",
          flush=True)
    check(len(losses) == 16 and np.isfinite(losses).all(),
          f"lenet-5 losses {losses}")
    card_m = compiled(0.0)
    card_m.estimator._ensure_initialized()
    w = params_to_numpy(card_m)
    zoo.init_nncontext(seed=0, device="cpu")
    cpu_m = compiled(0.0)
    cpu_m.estimator.params = w
    held = held_to_cpu("lenet-5 at dropout 0, one epoch, card against "
                       "the CPU port", card_m, cpu_m, x, y, 64, 8)
    zoo.init_nncontext(seed=0)
    return {"losses": losses, "images_per_s_epochs": rates,
            "images_per_s": 2 * len(x) / wall, "test": metrics,
            "held": held}


def inception_serving(card):
    """Phase 15, part 2: Inception-v1 served by ``InferenceModel`` in
    f32 and bf16 at batch 1, 8 and 32 (the median of 10 requests, the
    device's busy share over 3), and its logits at batch 4 against the
    CPU port's. Returns the record and the weights before the head was
    scaled."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    ctx = zoo.init_nncontext(seed=0)
    net = ImageClassifier("inception-v1", input_shape=IMAGE,
                          classes=1000).model
    net.init_params()
    w0 = params_to_numpy(net)
    rs = np.random.RandomState(15)
    x4 = spread_images(rs, 4)
    factor = scale_head(net, x4)
    im = InferenceModel(supported_concurrent_num=2).load_keras_net(net)
    rec = {"head_scale": factor}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        for bs in IC_SERVE:
            x = torch.from_numpy(spread_images(rs, bs)).to(ctx.device, dt)
            med, lo, hi = median_request_s(im, x)
            prof = profile_steps(lambda: im.predict(x), 3, ())
            rec[f"{dname}_b{bs}"] = {
                "images_per_s": bs / med, "ms": med * 1e3,
                "ms_spread": [lo * 1e3, hi * 1e3],
                "device_busy_share": prof["device_busy_share"],
                "device_ms": prof["device_ms_per_step"],
                "device_rows": prof["device_rows_per_step"],
                "top": prof["top"][:10]}
            print(f"  inception-v1 {dname} batch {bs}: {bs / med:.1f} "
                  f"images/s (median of 10 requests {med * 1e3:.3f} ms, "
                  f"{lo * 1e3:.3f}-{hi * 1e3:.3f}), device busy "
                  f"{prof['device_busy_share']} on {card}", flush=True)
    cpu = cpu_twin("inception-v1", net)
    want = cpu.predict(x4, batch_size=4)
    got = {dt: im.predict(torch.from_numpy(x4).to(ctx.device, dt))
           for dt in (torch.float32, torch.bfloat16)}
    rec["held_f32"] = logits_held(
        f"inception-v1 f32 logits at batch 4 against the CPU port (head "
        f"x{factor:.4g})", got[torch.float32], want, 1e-3)
    rec["held_bf16"] = logits_held(
        "inception-v1 bf16 logits at batch 4 against the CPU port's f32",
        got[torch.bfloat16], want, 5e-2)
    del net, im, cpu
    torch.cuda.empty_cache()
    return rec, w0


def inception_training(card, w0):
    """Phase 15, part 3: Inception-v1 through ``compile``/``fit``
    (``mixed_bfloat16``, SGD 0.1 momentum 0.9, batch 128, 3 epochs of 5
    steps): images/s per epoch, the goodput ledger's FLOPs per step and
    MFU, a profile of 3 steps (busy share, the ten largest device rows);
    then one f32 step at batch 4 against the CPU port's."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.estimator import MaxIteration
    zoo.init_nncontext(seed=0)
    rs = np.random.RandomState(16)
    n = TRAIN_BATCH * IC_TRAIN_STEPS
    x = rs.rand(n, *IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, (n, 1)).astype(np.int32)
    net = ImageClassifier("inception-v1", input_shape=IMAGE,
                          classes=1000).model
    net.load_params(w0)
    os.environ["ZOO_TPU_DTYPE_POLICY"] = "mixed_bfloat16"
    try:
        net.compile(optimizer=SGD(lr=0.1, momentum=0.9),
                    loss="softmax_cross_entropy")
    finally:
        os.environ.pop("ZOO_TPU_DTYPE_POLICY", None)
    est = net.estimator
    check(est.dtype_policy == "mixed_bfloat16", est.dtype_policy)
    hist = net.fit(x, y, batch_size=TRAIN_BATCH,
                   nb_epoch=IC_TRAIN_EPOCHS).history
    losses = [v for h in hist for v in h["losses"]]
    rates = [h["throughput"] for h in hist]
    gp = hist[-1]["goodput"]
    check(len(losses) == IC_TRAIN_STEPS * IC_TRAIN_EPOCHS and
          np.isfinite(losses).all(), f"inception-v1 losses {losses}")
    print(f"  inception-v1 training (mixed_bfloat16, batch {TRAIN_BATCH}): "
          f"losses {[round(v, 4) for v in losses]}; images/s per epoch "
          f"{[round(r, 1) for r in rates]}, median "
          f"{statistics.median(rates):.1f} ({min(rates):.1f}-"
          f"{max(rates):.1f}); the ledger: {gp['flops_per_step']:.6e} "
          f"FLOPs per step, MFU {gp['mfu']} (peak {gp['peak_flops']:.3e}), "
          f"shares {gp['shares']} on {card}", flush=True)
    print("  profile inception-v1 bf16 train, per step:", flush=True)
    prof = profile_steps(
        lambda: est.train(x, y, batch_size=TRAIN_BATCH,
                          end_trigger=MaxIteration(est.step + 3)),
        1, (), per=3)
    rec = {"losses": losses, "images_per_s_epochs": rates,
           "images_per_s": statistics.median(rates),
           "flops_per_step": gp["flops_per_step"], "mfu": gp["mfu"],
           "shares": gp["shares"], "profile": prof}
    net._estimator = None
    del net, est, x
    torch.cuda.empty_cache()
    x4 = spread_images(rs, 4)
    y4 = rs.randint(0, 1000, (4, 1)).astype(np.int32)
    rec["f32_step"] = step_held(
        "inception-v1", "inception-v1", w0, x4, y4,
        held=(("fc", "kernel"), ("fc", "bias"), ("i5b_1x1", "kernel")),
        shown=(("i4c_5x5", "kernel"), ("i3a_3x3", "kernel"),
               ("stem1", "kernel")),
        bn_layers=("stem1_bn", "i4c_5x5_bn", "i5b_pool_bn"))
    return rec


def inception_transfer(card):
    """Phase 15, part 4: transfer learning as
    ``examples/transfer_learning.py`` does it, on Inception-v1 at full
    width: ``new_graph`` at its global average pool, ``freeze_up_to``
    it, a fresh ``Dense(2, activation="softmax")`` head,
    ``copy_weights_from`` the backbone, and 2 epochs of synthetic
    two-class images at batch 32. Every frozen trainable leaf must come
    back bit for bit, every frozen BatchNorm's moving statistics must
    move (the reference folds a frozen BN's updates in), the head must
    move and the losses be finite."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import (
        BatchNormalization, Dense, GlobalAveragePooling2D)
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import Model
    zoo.init_nncontext(seed=0)
    backbone = ImageClassifier("inception-v1", input_shape=IMAGE,
                               classes=1000).model
    backbone.compile(optimizer="adam", loss="softmax_cross_entropy")
    backbone.estimator._ensure_initialized()
    gap = next(v.name for v in backbone._order
               if isinstance(v.layer, GlobalAveragePooling2D))
    trunk = backbone.new_graph([gap])
    trunk.freeze_up_to(gap)
    head = Dense(2, activation="softmax", name="cats_dogs")(
        trunk.outputs[0])
    tuned = Model(trunk.inputs, head, name="tuned")
    tuned.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    tuned.copy_weights_from(backbone)
    rs = np.random.RandomState(17)
    y = rs.randint(0, 2, (IC_TRANSFER_N, 1)).astype(np.int32)
    x = rs.rand(IC_TRANSFER_N, *IMAGE).astype(np.float32)
    x[..., 0] += 0.8 * y.reshape(-1, 1, 1)
    before = params_to_numpy(tuned)
    torch.cuda.synchronize()
    t = time.perf_counter()
    hist = tuned.fit(x, y, batch_size=IC_TRANSFER_BATCH, nb_epoch=2).history
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    after = params_to_numpy(tuned)
    losses = [v for h in hist for v in h["losses"]]
    check(np.isfinite(losses).all() and
          len(losses) == 2 * IC_TRANSFER_N // IC_TRANSFER_BATCH,
          f"transfer losses {losses}")
    frozen = [lyr for lyr in tuned.layers if not lyr.trainable]
    leaves = moved = 0
    for lyr in frozen:
        for k, v in before[lyr.name].items():
            if k == "_state":
                continue
            leaves += 1
            check(np.array_equal(after[lyr.name][k], v),
                  f"frozen {lyr.name}/{k} moved in fine-tuning")
        if isinstance(lyr, BatchNormalization):
            st0, st1 = before[lyr.name]["_state"], after[lyr.name]["_state"]
            moved += all(not np.array_equal(st0[s], st1[s]) for s in st0)
    bns = sum(isinstance(lyr, BatchNormalization) for lyr in frozen)
    check(bns > 0 and moved == bns, f"{moved} of {bns} frozen BNs' moving "
          "statistics moved")
    check(all(not np.array_equal(after["cats_dogs"][k], v)
              for k, v in before["cats_dogs"].items()), "the head is still")
    metrics = tuned.evaluate(x, y, batch_size=IC_TRANSFER_BATCH)
    rates = [h["throughput"] for h in hist]
    print(f"  transfer learning on inception-v1 (cut at {gap}): "
          f"{len(frozen)} frozen layers, {leaves} frozen trainable leaves "
          f"bit for bit after {len(losses)} steps, {moved} of {bns} frozen "
          f"BNs' moving statistics moved, the head moved; losses "
          f"{[round(v, 4) for v in losses]}; images/s per epoch "
          f"{[round(r, 1) for r in rates]} "
          f"({len(losses) * IC_TRANSFER_BATCH / wall:.1f} over both); "
          f"metrics {metrics} on {card}", flush=True)
    rec = {"frozen_layers": len(frozen), "frozen_leaves": leaves,
           "frozen_bns_moved": moved, "losses": losses,
           "images_per_s_epochs": rates, "metrics": metrics}
    del backbone, trunk, tuned
    torch.cuda.empty_cache()
    return rec


def other_archs(card):
    """Phase 15, part 5: the other six architectures, each built by
    ``ImageClassifier(name)``: a bf16 forward at batch 32 through
    ``InferenceModel`` (the median of 10 requests), the f32 logits at
    batch 2 against the CPU port's, and for MobileNet-v2 and
    DenseNet-121 one f32 step at batch 2 against the CPU port's."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    rs = np.random.RandomState(18)
    rec = {}
    for name in IC_OTHERS:
        ctx = zoo.init_nncontext(seed=0)
        net = ImageClassifier(name, input_shape=IMAGE, classes=1000).model
        net.init_params()
        w0 = params_to_numpy(net)
        x2 = spread_images(rs, 2)
        factor = scale_head(net, x2)
        im = InferenceModel(supported_concurrent_num=1).load_keras_net(net)
        x32 = torch.from_numpy(spread_images(rs, 32)).to(ctx.device,
                                                         torch.bfloat16)
        out = im.predict(x32)
        check(out.shape == (32, 1000) and np.isfinite(out).all(),
              f"{name} bf16 logits {out.shape}")
        med, lo, hi = median_request_s(im, x32)
        got = im.predict(torch.from_numpy(x2).to(ctx.device))
        cpu = cpu_twin(name, net)
        r = {"images_per_s_bf16_b32": 32 / med, "ms": med * 1e3,
             "ms_spread": [lo * 1e3, hi * 1e3], "head_scale": factor}
        print(f"  {name}: bf16 batch 32 {32 / med:.1f} images/s (median "
              f"{med * 1e3:.3f} ms, {lo * 1e3:.3f}-{hi * 1e3:.3f}) on "
              f"{card}", flush=True)
        r["held_f32"] = logits_held(
            f"{name} f32 logits at batch 2 against the CPU port (head "
            f"x{factor:.4g})", got, cpu.predict(x2, batch_size=2), 1e-3)
        del net, im, cpu
        torch.cuda.empty_cache()
        if name in IC_OTHER_STEP:
            r["f32_step"] = step_held(
                name, name, w0, spread_images(rs, 2),
                rs.randint(0, 1000, (2, 1)).astype(np.int32))
        rec[name] = r
    return rec


def image_classification_path(card, detail):
    """Phase 15: the image-classification family on the card; no kernel
    of the eleven on this path."""
    t0 = time.perf_counter()
    reset_launches()
    rec = {"lenet": lenet_run(card)}
    rec["inception_serving"], w0 = inception_serving(card)
    rec["inception_training"] = inception_training(card, w0)
    rec["transfer"] = inception_transfer(card)
    rec["others"] = other_archs(card)
    launches = all_launches()
    print(f"  no kernel of the eleven on this path: launches {launches}",
          flush=True)
    check(not any(launches.values()), f"phase 15 launched {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    print(f"  phase 15 in {rec['seconds']:.1f} s", flush=True)
    detail["image_classification"] = rec


# -- the text family (phase 16) ---------------------------------------------

# TextClassifier at the reference's defaults (text_classifier.py:24-26):
# 20 Newsgroups' 20 classes, GloVe 200d's width, encoder 256, sequence
# 500, over the upstream example's 5000-word vocabulary (max_words_num);
# the corpus is examples/text_classification.py's synth_corpus widened
# to 20 classes: 2560 documents of 400-599 words over 8000 words
TC = dict(class_num=20, token_length=200, sequence_length=500,
          encoder_output_dim=256)
TC_WORDS, TC_VOCAB_WORDS, TC_DOCS_PER_CLASS = 5000, 8000, 128
TC_BATCH, TC_STEPS, TC_EPOCHS = 128, 5, 2
TC_SERVE = (1, 128)
# the scale the head's kernel is set to give the held logits
TC_LOGIT_MAX = 10.0
# KNRM at its defaults (knrm.py:30-34) with examples/qa_ranker.py's
# lengths, over 20000 ids; batch 256 of alternating positive and
# negative rows
KNRM_CFG = dict(text1_length=10, text2_length=40, embed_size=300,
                kernel_num=21, sigma=0.1, exact_sigma=0.001)
KNRM_VOCAB, KNRM_QUESTIONS = 20000, 2560
KNRM_BATCH, KNRM_STEPS, KNRM_EPOCHS = 256, 10, 2
# AnomalyDetector at its defaults (anomaly_detector.py:30-31) over
# windows of 50 steps of 3 features at batch 1024 (the unroll and batch
# of upstream's NYC-taxi anomaly-detection app)
AD_CFG = dict(feature_shape=(50, 3), hidden_layers=(8, 32, 15),
              dropouts=(0.2, 0.2, 0.2))
AD_BATCH, AD_STEPS, AD_EPOCHS = 1024, 5, 2


def text_corpus():
    """The TextSet pipeline (tokenize, word2idx with ``max_words_num``
    5000, shape_sequence 500, generate_sample, to_arrays) over the
    synthetic 20-class corpus: ids (2560, 500) int32, labels, and each
    stage's host ms."""
    from analytics_zoo_tpu_torch.examples.text_classification import \
        synth_corpus
    from analytics_zoo_tpu_torch.feature.text import TextSet
    rs = np.random.RandomState(16)
    ms = {}
    t = time.perf_counter()
    texts, labels = synth_corpus(rs, TC_DOCS_PER_CLASS, TC["class_num"],
                                 vocab_words=TC_VOCAB_WORDS,
                                 length=(400, 600))
    ms["synth_corpus"] = (time.perf_counter() - t) * 1e3
    stages = (("from_texts", lambda _: TextSet.from_texts(texts, labels)),
              ("tokenize", lambda ts: ts.tokenize()),
              ("word2idx", lambda ts: ts.word2idx(max_words_num=TC_WORDS)),
              ("shape_sequence",
               lambda ts: ts.shape_sequence(TC["sequence_length"])),
              ("generate_sample", lambda ts: ts.generate_sample()),
              ("to_arrays", lambda ts: ts.to_arrays()))
    out = None
    for name, fn in stages:
        t = time.perf_counter()
        out = fn(out) if name != "to_arrays" else (out, fn(out))
        ms[name] = (time.perf_counter() - t) * 1e3
    ts, (x, y) = out
    words = len(ts.get_word_index())
    tokens = sum(len(f.tokens) for f in ts.features)
    pipeline = sum(v for k, v in ms.items() if k != "synth_corpus")
    print(f"  TextSet pipeline over {len(texts)} documents ({tokens} "
          f"tokens, {words} words kept of {TC_VOCAB_WORDS}): host ms "
          f"{ {k: round(v, 1) for k, v in ms.items()} }, "
          f"{pipeline:.1f} ms from from_texts to to_arrays "
          f"({tokens / pipeline * 1e3:.0f} tokens/s)", flush=True)
    check(x.shape == (len(texts), TC["sequence_length"]) and
          x.dtype == np.int32 and words == TC_WORDS and
          int(x.max()) == TC_WORDS, f"ids {x.shape} {x.dtype}, {words} "
          f"words, max id {x.max()}")
    return x, y.astype(np.int32), {"host_ms": ms, "tokens": tokens,
                                   "words": words}


def text_classifier(encoder, embedded=True):
    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Embedding
    emb = (Embedding(TC_WORDS + 2, TC["token_length"]) if embedded
           else None)
    return TextClassifier(encoder=encoder, embedding=emb, **TC)


def compiled(build, policy, loss, optimizer="adam"):
    """``build()`` compiled under the dtype ``policy`` (the
    ``ZOO_TPU_DTYPE_POLICY`` a user sets)."""
    os.environ["ZOO_TPU_DTYPE_POLICY"] = policy
    try:
        m = build().compile(optimizer=optimizer, loss=loss)
    finally:
        os.environ.pop("ZOO_TPU_DTYPE_POLICY", None)
    check(m.model.estimator.dtype_policy == policy,
          m.model.estimator.dtype_policy)
    return m


def rows(x) -> int:
    """The sample count of ``x``, an array or a list of them (a
    multi-input net's)."""
    return len(x[0]) if isinstance(x, list) else len(x)


def timed_fit(label, m, x, y, batch, epochs, card, unit="samples"):
    """``m.fit`` over ``x`` (whole batches) for ``epochs``: the losses
    (finite), the rate per epoch (history, host clock) with its min and
    max, ms per step, and a profile of 3 more steps (device busy share,
    rows per step)."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.estimator import MaxIteration
    torch.cuda.synchronize()
    t = time.perf_counter()
    hist = m.fit(x, y, batch_size=batch, nb_epoch=epochs).history
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    losses = [v for h in hist for v in h["losses"]]
    rates = [h["throughput"] for h in hist]
    steps = rows(x) // batch
    check(len(losses) == steps * epochs and np.isfinite(losses).all(),
          f"{label} losses {losses}")
    est = m.model.estimator
    # the first epoch holds the first step's FLOP count and first calls
    print(f"  {label}: losses {[round(v, 4) for v in losses]}; {unit}/s "
          f"per epoch {[round(r, 1) for r in rates]} ({min(rates):.1f}-"
          f"{max(rates):.1f}), the last {rates[-1]:.1f}: "
          f"{batch / rates[-1] * 1e3:.2f} ms per step "
          f"({wall / (steps * epochs) * 1e3:.2f} over the fit's wall, "
          f"first step included) on {card}", flush=True)
    t = time.perf_counter()
    prof = profile_steps(
        lambda: est.train(x, y, batch_size=batch,
                          end_trigger=MaxIteration(est.step + 3)),
        1, (), per=3)
    print(f"    fit {wall:.1f} s, the profile of 3 steps "
          f"{time.perf_counter() - t:.1f} s (its processing included)",
          flush=True)
    return {"losses": losses, "per_s_epochs": rates,
            "per_s": rates[-1], "ms_per_step": batch / rates[-1] * 1e3,
            "fit_wall_s": wall, "device_busy_share":
                prof["device_busy_share"],
            "device_ms_per_step": prof["device_ms_per_step"],
            "wall_ms_per_step": prof["wall_ms_per_step"],
            "device_rows_per_step": prof["device_rows_per_step"],
            "top": prof["top"][:8]}


def no_sync(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises at any host sync."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def no_sync_loop(lyr, params, x):
    """One forward and backward of the recurrent layer ``lyr`` under
    :func:`no_sync`: the time loop reads nothing back."""
    import torch
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    no_sync(lambda: torch.autograd.grad(
        lyr.call(p, x).float().square().sum(), list(p.values())))
    torch.cuda.synchronize()


def probs_held(label, got, want, rel, what="probabilities"):
    """``got`` within ``rel`` of max(1, max|want|) of ``want``, a bound
    that must lie below half the outputs' spread over the inputs: the
    largest column's max - min. Rows that ignore their input are one
    row, which misses that column's max or min by half the spread at
    least (the median column of 20 classes barely moves). ``what``
    names the outputs."""
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{label}: {what} {got.shape}, want {want.shape}")
    err = float(np.abs(got - want).max())
    tol = rel * max(1.0, float(np.abs(want).max()))
    spread = float(np.ptp(want, axis=0).max())
    print(f"  {label}: max|err| {err:.4e} (tol {tol:.4e}, below half the "
          f"{what}' spread {spread:.4e}; max "
          f"{float(want.max()):.4e})", flush=True)
    check(tol < spread / 2, f"{label}: tol {tol} is not below half the "
          f"spread {spread}, so the check could not fail")
    check(err <= tol, f"{label}: max|err| {err} > {tol}")
    return {"max_abs_err": err, "tol": tol, "spread": spread}


def scale_text_head(net, x):
    """Scale the last Dense (kernel and bias) so that the centred logits
    (log p less its row mean) on ``x`` reach :data:`TC_LOGIT_MAX`; at
    random init the probabilities sit near 1/20 and move by less than
    any bound. Returns the factor."""
    import torch
    p = net.predict(x, batch_size=len(x)).astype(np.float64)
    lp = np.log(p)
    peak = float(np.abs(lp - lp.mean(axis=1, keepdims=True)).max())
    factor = TC_LOGIT_MAX / peak
    head = net.layers[-1].params()
    with torch.no_grad():
        head["kernel"].mul_(factor)
        head["bias"].mul_(factor)
    return factor


def text_classifier_run(encoder, x, y, card):
    """Phase 16, part 1, one encoder: train through ``compile``/``fit``
    in f32 and ``mixed_bfloat16``, serve through ``InferenceModel`` at
    batch 1 and 128, then hold the card to the CPU port: f32
    probabilities at batch 4 (1e-4 of max(1, max|p|), below their
    spread, the head scaled), one f32 step at batch 4 and dropout 0
    (loss 1e-4 relative), and bf16 against f32 (5e-2) on the
    pre-embedded input."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dropout
    from analytics_zoo_tpu_torch.pipeline.estimator import Estimator
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    loss = "sparse_categorical_crossentropy"
    ctx = zoo.init_nncontext(seed=0)
    w0 = params_to_numpy(text_classifier(encoder).model.init_params())
    n = TC_BATCH * TC_STEPS
    rec = {}
    for policy in ("float32", "mixed_bfloat16"):
        m = compiled(lambda: text_classifier(encoder), policy, loss)
        m.model.load_params(w0)
        torch.cuda.reset_peak_memory_stats()
        rec[policy] = timed_fit(f"textclassifier {encoder} {policy} train "
                                f"(batch {TC_BATCH}, T "
                                f"{TC['sequence_length']})", m, x[:n],
                                y[:n], TC_BATCH, TC_EPOCHS, card)
        rec[policy]["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated()
        print(f"    peak device memory {torch.cuda.max_memory_allocated()}"
              " bytes", flush=True)
        del m
        torch.cuda.empty_cache()

    net = text_classifier(encoder).model
    net.load_params(w0)
    if encoder != "cnn":
        rnn = net.layers[1]
        emb = net.layers[0].params()["embeddings"]
        ids = torch.from_numpy(x[:16]).to(ctx.device).long()
        no_sync_loop(rnn, rnn.params(), emb[ids])
        kind = type(rnn).__name__
        print(f"  {encoder}: one forward and backward of the {kind} at "
              "batch 16, T 500 under set_sync_debug_mode('error'): no host "
              "sync in the time loop", flush=True)
    t = time.perf_counter()
    im = InferenceModel(supported_concurrent_num=1).load_keras_net(net)
    for bs in TC_SERVE:
        xt = torch.from_numpy(x[:bs]).to(ctx.device)
        med, lo, hi = median_request_s(im, xt)
        prof = profile_steps(lambda: im.predict(xt), 3, ())
        rec[f"serve_b{bs}"] = {
            "samples_per_s": bs / med, "ms": med * 1e3,
            "ms_spread": [lo * 1e3, hi * 1e3],
            "device_busy_share": prof["device_busy_share"],
            "device_ms": prof["device_ms_per_step"],
            "device_rows": prof["device_rows_per_step"]}
        print(f"  textclassifier {encoder} served at batch {bs}: "
              f"{bs / med:.1f} samples/s (median of 10 requests "
              f"{med * 1e3:.3f} ms, {lo * 1e3:.3f}-{hi * 1e3:.3f}), device "
              f"busy {prof['device_busy_share']} on {card}", flush=True)

    print(f"    serving {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    x4, y4 = x[:4], y[:4]
    factor = scale_text_head(net, x4)
    w_held = params_to_numpy(net)
    got = im.predict(x4)
    zoo.init_nncontext(seed=0, device="cpu")
    cpu = text_classifier(encoder).model
    cpu.load_params(w_held, device="cpu")
    rec["held_f32"] = probs_held(
        f"textclassifier {encoder} f32 probabilities at batch 4 against "
        f"the CPU port (head x{factor:.4g})", got, cpu.predict(x4), 1e-4)
    ctx = zoo.init_nncontext(seed=0)
    # mixed_bfloat16 casts float inputs only: the ids stay int32 and the
    # Embedding's f32 table feeds f32 activations, as in the reference
    same = Estimator(net, dtype_policy="mixed_bfloat16").predict(x4, 4)
    rec["mixed_with_ids_err"] = float(np.abs(same - got).max())
    print(f"  textclassifier {encoder} with ids under mixed_bfloat16: "
          f"max|p - f32 p| {rec['mixed_with_ids_err']:.3e} (the Embedding "
          "feeds f32 activations)", flush=True)
    pre = text_classifier(encoder, embedded=False).model
    pre.load_params({k: v for k, v in w_held.items()
                     if k != "embedding_1"})
    xe = w_held["embedding_1"]["embeddings"][x4]
    f32 = Estimator(pre, dtype_policy="float32").predict(xe, 4)
    bf16 = Estimator(pre, dtype_policy="mixed_bfloat16").predict(xe, 4)
    rec["held_bf16"] = probs_held(
        f"textclassifier {encoder} pre-embedded, mixed_bfloat16 against "
        "f32 on the card", bf16, f32, 5e-2)
    del net, im, pre
    torch.cuda.empty_cache()

    def dropout_0(m):
        for lyr in m.model.layers:
            if isinstance(lyr, Dropout):
                lyr.p = 0.0
        return m

    print(f"    probabilities held in {time.perf_counter() - t:.1f} s",
          flush=True)
    t = time.perf_counter()
    rec["f32_step"] = two_steps_held(
        f"textclassifier {encoder}, f32 at batch 4, T "
        f"{TC['sequence_length']}, dropout 0",
        lambda: dropout_0(text_classifier(encoder).compile(
            optimizer="adam", loss=loss)), w0, x4, y4)
    print(f"    two steps held in {time.perf_counter() - t:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    return rec


def two_steps_held(label, build, w, x, y):
    """Two f32 Adam steps (two epochs of one batch, ``x``) from the
    weights ``w`` on the card and on the CPU port: each loss within
    1e-4 relative. The second loss is taken after the first update, so
    it holds the step."""
    import analytics_zoo_tpu_torch as zoo
    losses = {}
    for dev in ("cuda", "cpu"):
        zoo.init_nncontext(seed=0, device=None if dev == "cuda" else dev)
        m = build()
        m.model.load_params(w)
        hist = m.fit(x, y, batch_size=rows(x), nb_epoch=2).history
        losses[dev] = [h["loss"] for h in hist]
    zoo.init_nncontext(seed=0)
    lc, lp = losses["cuda"], losses["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    print(f"  {label}: two steps, losses card "
          f"{[round(v, 7) for v in lc]}, CPU {[round(v, 7) for v in lp]} "
          f"(max rel {rel:.2e}, tol 1e-4)", flush=True)
    check(np.isfinite(lc).all() and rel <= 1e-4,
          f"{label}: losses {lc} vs {lp}")
    return {"losses_card": lc, "losses_cpu": lp, "rel": rel}


def knrm_data():
    """A WikiQA-shaped synthetic corpus over ``KNRM_VOCAB`` words: each
    question (10 words) has a positive answer sharing 5 of its words
    and a negative one (40 words each); the word index over both
    corpora, the TextSets shaped to 10 and 40, and the training rows
    ``from_relation_pairs(seed=0)`` gives (ids as float32, as
    ``qa_ranker`` carries them)."""
    from analytics_zoo_tpu_torch.feature.text import (Relation, TextFeature,
                                                      TextSet)
    rs = np.random.RandomState(17)
    words = np.array([f"w{i}" for i in range(KNRM_VOCAB)])
    qs, ans, rel = [], [], []
    for i in range(KNRM_QUESTIONS):
        q = rs.randint(0, KNRM_VOCAB, 10)
        qs.append(TextFeature(" ".join(words[q]), uri=f"q{i}"))
        for j in range(2):
            a = rs.randint(0, KNRM_VOCAB, 40)
            if j == 0:
                a[rs.choice(40, 5, replace=False)] = q[:5]
            ans.append(TextFeature(" ".join(words[a]), uri=f"a{i}_{j}"))
            rel.append(Relation(f"q{i}", f"a{i}_{j}", 1 - j))
    t = time.perf_counter()
    index = TextSet([TextFeature(f.text) for f in qs + ans]).tokenize() \
        .word2idx(max_words_num=KNRM_VOCAB - 1).get_word_index()
    q_set = TextSet(qs).tokenize().word2idx(existing_map=index) \
        .shape_sequence(KNRM_CFG["text1_length"])
    a_set = TextSet(ans).tokenize().word2idx(existing_map=index) \
        .shape_sequence(KNRM_CFG["text2_length"])
    x1, x2 = TextSet.from_relation_pairs(rel, q_set, a_set, seed=0)
    host_ms = (time.perf_counter() - t) * 1e3
    x = np.concatenate([x1, x2], axis=1).astype(np.float32)
    vocab = max(index.values()) + 1
    print(f"  KNRM data: {len(qs)} questions, {len(ans)} answers, "
          f"{len(rel)} relations, {len(x)} rows (alternating positive and "
          f"negative), vocabulary {vocab}; TextSet pipeline and pairs "
          f"{host_ms:.1f} host ms", flush=True)
    return x, vocab, host_ms


def knrm_run(card):
    """Phase 16, part 2: KNRM trained with ``rank_hinge`` at batch 256
    in f32 (ms per step, pairs/s, a profile of 3 steps), then its
    scores at batch 8 and one step held to the CPU port (1e-4 of
    max(1, max|score|), the loss 1e-4 relative)."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.textmatching import KNRM
    x, vocab, host_ms = knrm_data()
    y = np.zeros((len(x), 1), np.float32)    # rank_hinge ignores it

    def build():
        return KNRM(vocab_size=vocab, **KNRM_CFG)

    zoo.init_nncontext(seed=0)
    m = compiled(build, "float32", "rank_hinge")
    n = KNRM_BATCH * KNRM_STEPS
    rec = timed_fit(f"knrm train (f32, batch {KNRM_BATCH}, rank_hinge)",
                    m, x[:n], y[:n], KNRM_BATCH, KNRM_EPOCHS, card,
                    unit="rows")
    rec["pairs_per_s"] = rec["per_s"] / 2
    rec["vocab"], rec["pipeline_host_ms"] = vocab, host_ms
    print(f"    = {rec['pairs_per_s']:.1f} pairs/s", flush=True)
    w = params_to_numpy(m.model)
    got = m.predict(x[:8], batch_size=8)
    cpu_ctx = zoo.init_nncontext(seed=0, device="cpu")
    cpu = compiled(build, "float32", "rank_hinge")
    cpu.model.load_params(w, device="cpu")
    rec["held_scores"] = logits_held(
        "knrm scores at batch 8 against the CPU port", got,
        cpu.predict(x[:8], batch_size=8), 1e-4, what="score")
    del cpu_ctx, cpu, m
    rec["step"] = two_steps_held(
        "knrm, f32 at batch 8, rank_hinge",
        lambda: compiled(build, "float32", "rank_hinge"), w, x[:8], y[:8])
    torch.cuda.empty_cache()
    return rec


def anomaly_run(card):
    """Phase 16, part 3: the AnomalyDetector on windows of a synthetic
    three-feature series (a daily cycle, noise and spikes): 2 epochs of
    5 steps at batch 1024 (samples/s, a profile of 3 steps), predict,
    ``detect_anomalies``, and the predictions at batch 4 held to the CPU
    port (1e-4 of max(1, max|y|))."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.anomalydetection import \
        AnomalyDetector
    rs = np.random.RandomState(18)
    unroll, feats = AD_CFG["feature_shape"]
    n = AD_BATCH * AD_STEPS + unroll
    t = np.arange(n)[:, None]
    series = (np.sin(t / 24 * 2 * np.pi + np.arange(feats)) +
              0.1 * rs.randn(n, feats)).astype(np.float32)
    series[rs.choice(n, 20, replace=False), 0] += 3.0
    x, y = AnomalyDetector.to_arrays(AnomalyDetector.unroll(series, unroll))

    def build():
        return AnomalyDetector(**AD_CFG)

    zoo.init_nncontext(seed=0)
    m = compiled(build, "float32", "mse")
    rec = timed_fit(f"anomaly detector train (f32, batch {AD_BATCH}, "
                    f"windows {unroll}x{feats})", m, x, y, AD_BATCH,
                    AD_EPOCHS, card)
    pred = m.predict(x, batch_size=AD_BATCH)
    flagged, threshold = AnomalyDetector.detect_anomalies(y, pred, 20)
    check(np.isfinite(pred).all() and len(flagged) >= 20,
          f"anomaly predictions {pred.shape}, flagged {len(flagged)}")
    w = params_to_numpy(m.model)
    got = m.predict(x[:4], batch_size=4)
    zoo.init_nncontext(seed=0, device="cpu")
    cpu = compiled(build, "float32", "mse")
    cpu.model.load_params(w, device="cpu")
    want = cpu.predict(x[:4], batch_size=4)
    err = float(np.abs(got - want).max())
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    print(f"  anomaly detector: {len(flagged)} flagged (threshold "
          f"{threshold:.4f}); predictions at batch 4 against the CPU port: "
          f"max|err| {err:.3e} (tol {tol:.3e})", flush=True)
    check(err <= tol, f"anomaly predictions {err} > {tol}")
    rec.update(flagged=len(flagged), threshold=float(threshold),
               held={"max_abs_err": err, "tol": tol})
    zoo.init_nncontext(seed=0)
    del m, cpu
    torch.cuda.empty_cache()
    return rec


def text_path(card, detail):
    """Phase 16: the text family on the card; no kernel of the eleven
    on this path."""
    t0 = time.perf_counter()
    reset_launches()
    x, y, corpus = text_corpus()
    rec = {"corpus": corpus}
    parts = {"corpus": time.perf_counter() - t0}
    runs = [(e, lambda e=e: text_classifier_run(e, x, y, card))
            for e in ("cnn", "lstm", "gru")]
    for name, run in runs + [("knrm", lambda: knrm_run(card)),
                             ("anomaly", lambda: anomaly_run(card))]:
        t = time.perf_counter()
        rec[name] = run()
        parts[name] = time.perf_counter() - t
    print(f"  phase 16 seconds by part: "
          f"{ {k: round(v, 1) for k, v in parts.items()} }", flush=True)
    rec["seconds_by_part"] = parts
    launches = all_launches()
    print(f"  no kernel of the eleven on this path: launches {launches}",
          flush=True)
    check(not any(launches.values()), f"phase 16 launched {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    print(f"  phase 16 in {rec['seconds']:.1f} s", flush=True)
    detail["text"] = rec


# Seq2seq at a production dialog model's widths: 3 LSTM layers of 1024
# on each side, a dense bridge, one-hot input over 10,000 words, a
# softmax generator, sequence 30 (``infer``'s default ``max_seq_len``);
# the scale of Sutskever et al. 2014's translation LSTMs (4 layers of
# 1000 cells), on seeded synthetic dialogs
S2S = dict(rnn="lstm", layers=3, hidden=1024, vocab=10000, seq=30)
S2S_SOS, S2S_EOS = 1, 2
S2S_BATCH, S2S_STEPS, S2S_EPOCHS = 64, 3, 2
S2S_SERVE = (1, 64)
S2S_BEAM = 4
# SSD300-VGG16 at VOC's 21 classes; the detections kept above 0.3 (the
# default 0.01 passes every prior of every class at random weights)
# the generator scaled so that the centred log-probabilities reach this
S2S_LOGIT_MAX = 20.0
SSD_SERVE = (1, 8, 32)
SSD_CONF = 0.3
SSD_BATCH, SSD_STEPS, SSD_EPOCHS = 32, 5, 2
SSD_MAX_GT = 8


def seq2seq_model():
    from analytics_zoo_tpu_torch.models.seq2seq import (
        Bridge, RNNDecoder, RNNEncoder, Seq2seq)
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    c = S2S
    shape = (c["seq"], c["vocab"])
    return Seq2seq(encoder=RNNEncoder(c["rnn"], c["layers"], c["hidden"]),
                   decoder=RNNDecoder(c["rnn"], c["layers"], c["hidden"]),
                   input_shape=shape, output_shape=shape,
                   bridge=Bridge("dense"),
                   generator=Dense(c["vocab"], activation="softmax",
                                   name="generator"))


def one_hot(ids, vocab):
    out = np.zeros(ids.shape + (vocab,), np.float32)
    np.put_along_axis(out, ids[..., None], 1.0, axis=-1)
    return out


def dialogs(n, seed=18):
    """``n`` seeded synthetic dialogs as the chatbot example carries
    them: the utterance's ids (Zipf-like over the vocabulary), the reply
    (the utterance reversed, then the end token) teacher-forced behind
    the start token, one-hot ``(n, 30, 10000)`` each."""
    rs = np.random.RandomState(seed)
    v, t = S2S["vocab"], S2S["seq"]
    p = 1.0 / (np.arange(3, v) + 10.0)
    q = rs.choice(np.arange(3, v), (n, t), p=p / p.sum())
    reply = np.concatenate([q[:, ::-1][:, :t - 1],
                            np.full((n, 1), S2S_EOS)], axis=1)
    dec = np.concatenate([np.full((n, 1), S2S_SOS), reply[:, :-1]], axis=1)
    return one_hot(q, v), one_hot(dec, v), one_hot(reply, v)


def scale_generator(net, x):
    """Scale the generator (kernel and bias) so that the centred
    log-probabilities on ``x`` reach :data:`S2S_LOGIT_MAX`, as phase 16
    scales its heads: at random init the probabilities sit near 1/10000
    and move by less than any bound. Returns the factor."""
    import torch
    p = net.predict(x, batch_size=rows(x)).astype(np.float64)
    lp = np.log(p)
    peak = float(np.abs(lp - lp.mean(axis=-1, keepdims=True)).max())
    factor = S2S_LOGIT_MAX / peak
    with torch.no_grad():
        for v in net.generator.params().values():
            v.mul_(factor)
    return factor


def host_timed(fn, warmup=1, iters=5):
    """Median host seconds of ``fn()`` (synchronized both ends) with
    its min and max, and the last result."""
    import torch
    out = None
    for _ in range(warmup):
        out = fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times), min(times), max(times), out


def seq2seq_run(card):
    """Phase 17, part 1: Seq2seq trained through ``compile``/``fit``
    (Adam, categorical cross-entropy, batch 64) in f32 and
    ``mixed_bfloat16``; greedy ``infer`` and ``generate_tokens`` at
    batch 1 and 64, their token loops under
    ``set_sync_debug_mode("error")``; ``infer_beam`` at beam 4; then
    held to the CPU port (f32 probabilities at batch 4, 1e-4 of max(1,
    max|p|), the generator scaled; two f32 Adam steps, 1e-4 relative)
    and the greedy ids to a host loop of full re-forwards on the
    card."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    loss = "categorical_crossentropy"
    v, t = S2S["vocab"], S2S["seq"]
    ctx = zoo.init_nncontext(seed=0)
    n = S2S_BATCH * S2S_STEPS
    enc, dec, tgt = dialogs(n)
    w0 = params_to_numpy(seq2seq_model().model.init_params())
    n_params = sum(a.size for d in w0.values() for a in d.values())
    print(f"  seq2seq: {S2S}, dense bridge, {n_params} parameters; "
          f"{n} dialogs of one-hot {enc.shape[1:]} ({enc.nbytes} bytes "
          "per input)", flush=True)
    rec = {"params": n_params}
    m = None
    for policy in ("float32", "mixed_bfloat16"):
        m = compiled(seq2seq_model, policy, loss)
        m.model.load_params(w0)
        torch.cuda.reset_peak_memory_stats()
        rec[policy] = timed_fit(
            f"seq2seq {policy} train (batch {S2S_BATCH}, T {t}, V {v})", m,
            [enc, dec], tgt, S2S_BATCH, S2S_EPOCHS, card)
        rec[policy]["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated()
        print(f"    peak device memory {torch.cuda.max_memory_allocated()}"
              " bytes", flush=True)
        if policy == "float32":
            f32_model = m
    del m
    torch.cuda.empty_cache()

    s2s, net = f32_model, f32_model.model
    params = net.params()
    start = np.eye(v, dtype=np.float32)[S2S_SOS]
    for bs in S2S_SERVE:
        q = enc[:bs]
        q_dev = torch.from_numpy(q).to(ctx.device)
        start_dev = torch.from_numpy(start).to(ctx.device)
        with torch.inference_mode():
            gen = no_sync(lambda: net.generate(params, q_dev, start_dev, t))
            ids = no_sync(lambda: net.generate_tokens(params, q_dev, S2S_SOS,
                                                      t))
        med, lo, hi, out = host_timed(
            lambda: s2s.infer(q, start, max_seq_len=t))
        check(out.shape == (bs, 1 + t, v) and np.isfinite(out).all() and
              gen[1].tolist() == [1 + t] * bs, f"infer {out.shape}")

        def tokens():
            with torch.inference_mode():
                return net.generate_tokens(params, q_dev, S2S_SOS, t)

        tmed, tlo, thi, _ = host_timed(tokens)
        check(ids[1].tolist() == [1 + t] * bs, f"counts {ids[1].tolist()}")
        prof = profile_steps(tokens, 1, ())
        rec[f"serve_b{bs}"] = {
            "infer_ms": med * 1e3, "infer_spread_ms": [lo * 1e3, hi * 1e3],
            "infer_ms_per_token": med * 1e3 / t,
            "infer_tokens_per_s": bs * t / med,
            "generate_tokens_ms": tmed * 1e3,
            "generate_tokens_spread_ms": [tlo * 1e3, thi * 1e3],
            "generate_tokens_ms_per_token": tmed * 1e3 / t,
            "generate_tokens_per_s": bs * t / tmed,
            "device_busy_share": prof["device_busy_share"],
            "device_rows": prof["device_rows_per_step"]}
        print(f"  seq2seq greedy at batch {bs}, {t} tokens: infer (host "
              f"in and out) {med * 1e3:.2f} ms ({lo * 1e3:.2f}-"
              f"{hi * 1e3:.2f}), {med * 1e3 / t:.3f} ms per token, "
              f"{bs * t / med:.1f} tokens/s; generate_tokens "
              f"{tmed * 1e3:.2f} ms ({tlo * 1e3:.2f}-{thi * 1e3:.2f}), "
              f"{tmed * 1e3 / t:.3f} ms per token, {bs * t / tmed:.1f} "
              f"tokens/s, device busy {prof['device_busy_share']}; both "
              "token loops ran under set_sync_debug_mode('error') on "
              f"{card}", flush=True)

    # the holds run on the untrained weights: six Adam steps on the
    # Zipf-like dialogs teach every greedy stream one frequent token
    net.load_params(w0)
    x4, y4 = [enc[:4], dec[:4]], tgt[:4]
    factor = scale_generator(net, x4)
    params = net.params()
    med, lo, hi, (beam_ids, score) = host_timed(
        lambda: s2s.infer_beam(enc[0], S2S_SOS, beam_size=S2S_BEAM,
                               max_seq_len=t, stop_token=S2S_EOS),
        warmup=0, iters=1)
    check(np.isfinite(score) and all(0 <= i < v for i in beam_ids),
          f"beam {beam_ids} {score}")
    rec["beam"] = {"ms": med * 1e3, "ids": beam_ids, "score": score}
    print(f"  seq2seq infer_beam (beam {S2S_BEAM}, up to {t} tokens, "
          f"untrained weights, generator x{factor:.4g}): "
          f"{len(beam_ids)} ids, score "
          f"{score:.4f}, {med * 1e3:.1f} ms on {card}", flush=True)

    # greedy ids against a host loop of full re-forwards on the card
    enc4 = torch.from_numpy(enc[:4]).to(ctx.device)
    with torch.inference_mode():
        ids, counts = no_sync(lambda: net.generate_tokens(
            params, enc4, S2S_SOS, t))
        seqs = torch.full((4, 1), S2S_SOS, device=ctx.device)
        for _ in range(t):
            d = torch.zeros((4, seqs.shape[1], v), device=ctx.device)
            d.scatter_(2, seqs[..., None], 1.0)
            nxt = net.call(params, [enc4, d])[:, -1].argmax(-1)
            seqs = torch.cat([seqs, nxt[:, None]], dim=1)
    same = ids.tolist() == seqs.tolist()
    distinct = [len(set(r[1:])) for r in ids.tolist()]
    print(f"  seq2seq greedy ids at batch 4 against {t} full re-forwards "
          f"on the card: {'identical' if same else 'DIFFERENT'} "
          f"(distinct tokens per row {distinct})", flush=True)
    check(same, f"greedy ids {ids.tolist()} vs {seqs.tolist()}")
    # a stream of one repeated token would hold the loop's state to
    # little: the random decoder's streams vary
    check(statistics.median(distinct) >= 4,
          f"greedy streams of {distinct} distinct tokens, expected a "
          "median of 4 or more")
    rec["greedy_reforward_identical"] = same
    rec["greedy_distinct_tokens"] = distinct

    w_held = params_to_numpy(net)
    got = net.predict(x4, batch_size=4)
    zoo.init_nncontext(seed=0, device="cpu")
    cpu = seq2seq_model().compile(optimizer="adam", loss=loss).model
    cpu.load_params(w_held, device="cpu")
    rec["held_f32"] = probs_held(
        f"seq2seq f32 probabilities at batch 4 against the CPU port "
        f"(generator x{factor:.4g})", got, cpu.predict(x4, batch_size=4),
        1e-4)
    del cpu, f32_model, s2s, net, params
    zoo.init_nncontext(seed=0)
    torch.cuda.empty_cache()
    rec["f32_step"] = two_steps_held(
        "seq2seq, f32 at batch 4, Adam",
        lambda: seq2seq_model().compile(optimizer="adam", loss=loss),
        w0, x4, y4)
    torch.cuda.empty_cache()
    return rec


def ssd_images(rs, n):
    """``n`` seeded 300x300 images, mean-subtracted scale, brightness
    stepping across the batch."""
    scale = np.linspace(0.25, 2.0, n).astype(np.float32)
    return (rs.rand(n, 300, 300, 3).astype(np.float32) - 0.5) * 255 * \
        scale[:, None, None, None]


def ssd_targets(rs, n):
    """Packed ground truth: 1 to 4 boxes per image over VOC's 20
    object classes."""
    from analytics_zoo_tpu_torch.models.image.objectdetection import \
        ObjectDetector
    boxes, labels = [], []
    for _ in range(n):
        k = rs.randint(1, 5)
        lo = rs.uniform(0.0, 0.6, (k, 2))
        wh = rs.uniform(0.1, 0.4, (k, 2))
        boxes.append(np.concatenate([lo, lo + wh], 1).astype(np.float32))
        labels.append(rs.randint(0, 20, k).astype(np.int32))
    return ObjectDetector.pack_targets(boxes, labels, max_gt=SSD_MAX_GT)


def same_detections(a, b):
    """The same detections per image: classes in order, boxes within
    1e-4."""
    if [len(d) for d in a] != [len(d) for d in b]:
        return False
    return all(x.class_id == y.class_id and
               np.abs(np.asarray(x.box) - np.asarray(y.box)).max() <= 1e-4
               for da, db in zip(a, b) for x, y in zip(da, db))


def ssd_run(card):
    """Phase 17, part 2: SSD300-VGG16 (21 classes) served through
    ``ObjectDetector.detect`` at batch 1, 8 and 32 in f32 and bf16 (the
    network and ``DetectionOutput``'s host time apart); its flat output
    at batch 2 held to the CPU port (f32 1e-3, bf16 5e-2) with the same
    detections; ``MultiBoxLoss`` at 8732 priors and the device ``nms``
    held; trained through ``compile_detection``/``fit`` (SGD 1e-3
    momentum 0.9, SSD's own schedule start, ``mixed_bfloat16``, batch
    32, 2 epochs of 5 steps); one f32 step at batch 2 held to the CPU
    port."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.models.image.objectdetection import (
        DetectionOutput, MultiBoxLoss, ObjectDetector, bbox_util)
    from analytics_zoo_tpu_torch.models.image.objectdetection.detection \
        import _nms_numpy
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.estimator import MaxIteration
    ctx = zoo.init_nncontext(seed=0)
    rs = np.random.RandomState(19)
    det = ObjectDetector("ssd-vgg16-300x300")
    det.compile()
    net = det.model
    w0 = params_to_numpy(net.init_params())
    priors = det.priors
    p = priors.shape[0]
    n_params = sum(a.size for d in w0.values() for a in d.values())
    maps = tuple(s.feature_size for s in det._builder.specs)
    check(p == 8732 and net.output_shape == (p * 25,),
          f"SSD300 priors {p}, output {net.output_shape}")
    print(f"  ssd300-vgg16: {n_params} parameters, {p} priors over maps "
          f"{maps}, flat output {net.output_shape}", flush=True)
    rec = {"params": n_params}
    post = DetectionOutput(det.n_classes, conf_threshold=SSD_CONF,
                           nms_threshold=det.config.nms_threshold)
    x_all = ssd_images(rs, max(SSD_SERVE))
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        for bs in SSD_SERVE:
            xd = torch.from_numpy(x_all[:bs]).to(ctx.device, dt)
            nmed, nlo, nhi, flat = host_timed(
                lambda: net.predict(xd, batch_size=bs), iters=10)
            t = time.perf_counter()
            dets = post.from_flat(flat, priors)
            post_s = time.perf_counter() - t
            dmed, dlo, dhi, dets2 = host_timed(
                lambda: det.detect(xd, batch_size=bs,
                                   conf_threshold=SSD_CONF), iters=5)
            check(len(dets2) == bs and np.isfinite(flat).all(),
                  f"detect at batch {bs}")
            prof = profile_steps(
                lambda: det.detect(xd, batch_size=bs,
                                   conf_threshold=SSD_CONF), 3, ())
            n_det = sum(len(d) for d in dets)
            rec[f"serve_{name}_b{bs}"] = {
                "images_per_s": bs / dmed, "detect_ms": dmed * 1e3,
                "detect_spread_ms": [dlo * 1e3, dhi * 1e3],
                "network_ms": nmed * 1e3,
                "network_spread_ms": [nlo * 1e3, nhi * 1e3],
                "post_host_ms": post_s * 1e3, "detections": n_det,
                "device_busy_share": prof["device_busy_share"],
                "device_ms": prof["device_ms_per_step"]}
            print(f"  ssd300 {name} detect at batch {bs}: "
                  f"{bs / dmed:.1f} images/s (median {dmed * 1e3:.2f} ms, "
                  f"{dlo * 1e3:.2f}-{dhi * 1e3:.2f}): network and copy "
                  f"back {nmed * 1e3:.2f} ms, DetectionOutput "
                  f"{post_s * 1e3:.2f} host ms ({n_det} detections above "
                  f"{SSD_CONF}); device busy {prof['device_busy_share']} "
                  f"on {card}", flush=True)
            del xd
    torch.cuda.empty_cache()

    # the flat output at batch 2 against the CPU port, and the detections
    x2 = ssd_images(rs, 2)
    got32 = net.predict(x2, batch_size=2)
    got16 = net.predict(torch.from_numpy(x2).to(ctx.device, torch.bfloat16),
                        batch_size=2)
    zoo.init_nncontext(seed=0, device="cpu")
    cpu = ObjectDetector("ssd-vgg16-300x300")
    cpu.compile()
    cpu.model.load_params(w0, device="cpu")
    want = cpu.model.predict(x2, batch_size=2)
    rec["held_f32"] = probs_held("ssd300 f32 flat output at batch 2 "
                                 "against the CPU port", got32, want, 1e-3,
                                 what="outputs")
    rec["held_bf16"] = probs_held("ssd300 bf16 flat output at batch 2 "
                                  "against the CPU port's f32", got16, want,
                                  5e-2, what="outputs")
    d_card, d_cpu = post.from_flat(got32, priors), post.from_flat(want,
                                                                 priors)
    same = same_detections(d_card, d_cpu)
    print(f"  ssd300 f32 detections above {SSD_CONF} at batch 2: "
          f"{[len(d) for d in d_card]} on the card, "
          f"{[len(d) for d in d_cpu]} on the CPU port, "
          f"{'the same' if same else 'DIFFERENT'} (classes, boxes within "
          "1e-4)", flush=True)
    check(same and sum(len(d) for d in d_card) > 0, "ssd300 detections")
    rec["held_detections"] = [len(d) for d in d_card]

    # MultiBoxLoss at 8732 priors on seeded predictions, value and grads
    b = 8
    loc = rs.randn(b, p, 4).astype(np.float32)
    conf = rs.randn(b, p, det.n_classes).astype(np.float32)
    y = ssd_targets(rs, b)
    loss = MultiBoxLoss(det.n_classes).as_keras_loss(priors)
    flat_pred = np.concatenate([loc.reshape(b, -1), conf.reshape(b, -1)], 1)
    vals = {}
    for dev in ("cuda", "cpu"):
        yp = torch.from_numpy(flat_pred).to(dev).requires_grad_(True)
        val = loss(torch.from_numpy(y).to(dev), yp)
        (g,) = torch.autograd.grad(val, yp)
        vals[dev] = (val.item(), g.cpu().numpy())
    rel = abs(vals["cuda"][0] - vals["cpu"][0]) / abs(vals["cpu"][0])
    gerr = float(np.abs(vals["cuda"][1] - vals["cpu"][1]).max())
    gtol = 1e-5 * float(np.abs(vals["cpu"][1]).max())
    yp = torch.from_numpy(flat_pred).to(ctx.device).requires_grad_(True)
    yt = torch.from_numpy(y).to(ctx.device)
    lms = time_ms(lambda: torch.autograd.grad(loss(yt, yp), yp), iters=5)
    print(f"  MultiBoxLoss at {p} priors, batch {b}: card "
          f"{vals['cuda'][0]:.6f}, CPU port {vals['cpu'][0]:.6f} (rel "
          f"{rel:.2e}, tol 1e-5); the gradient max|err| {gerr:.3e} (tol "
          f"{gtol:.3e}); loss and gradient {lms:.3f} ms on the card",
          flush=True)
    check(rel <= 1e-5 and gerr <= gtol, "MultiBoxLoss against the CPU port")
    rec["loss_held"] = {"rel": rel, "grad_err": gerr, "grad_tol": gtol,
                        "ms": lms}

    # the device nms against the host's _nms_numpy
    boxes = bbox_util.clip_boxes(bbox_util.decode_boxes(
        torch.from_numpy(loc[0] * 0.5), torch.from_numpy(priors))).numpy()
    scores = rs.rand(p).astype(np.float32)
    bd, sd = (torch.from_numpy(boxes).to(ctx.device),
              torch.from_numpy(scores).to(ctx.device))
    idx, valid = no_sync(lambda: bbox_util.nms(bd, sd, 0.45, 200))
    kept = [i for i, ok in zip(idx.tolist(), valid.tolist()) if ok]
    t = time.perf_counter()
    host = _nms_numpy(boxes, scores, 0.45)
    host_ms = (time.perf_counter() - t) * 1e3
    nms_ms = time_ms(lambda: bbox_util.nms(bd, sd, 0.45, 200), iters=3)
    print(f"  nms over {p} boxes, 200 outputs: the card's {len(kept)} "
          f"kept {'equal' if kept == host[:200] else 'UNEQUAL'} to "
          f"_nms_numpy's first 200 of {len(host)}; {nms_ms:.3f} ms on the "
          f"card (no host sync in its loop), {host_ms:.1f} host ms for "
          "_nms_numpy", flush=True)
    check(kept == host[:200], "device nms against _nms_numpy")
    rec["nms"] = {"ms": nms_ms, "host_ms": host_ms, "kept": len(kept)}
    zoo.init_nncontext(seed=0)
    del cpu, bd, sd, yp, yt
    torch.cuda.empty_cache()

    # training, mixed_bfloat16
    n = SSD_BATCH * SSD_STEPS
    x = ssd_images(rs, n)
    y = ssd_targets(rs, n)

    def build():
        return ObjectDetector("ssd-vgg16-300x300").compile_detection(
            optimizer=SGD(lr=1e-3, momentum=0.9))

    os.environ["ZOO_TPU_DTYPE_POLICY"] = "mixed_bfloat16"
    try:
        m = build()
    finally:
        os.environ.pop("ZOO_TPU_DTYPE_POLICY", None)
    est = m.model.estimator
    check(est.dtype_policy == "mixed_bfloat16", est.dtype_policy)
    m.model.load_params(w0)
    torch.cuda.reset_peak_memory_stats()
    hist = m.fit(x, y, batch_size=SSD_BATCH, nb_epoch=SSD_EPOCHS).history
    losses = [v for h in hist for v in h["losses"]]
    rates = [h["throughput"] for h in hist]
    gp = hist[-1]["goodput"]
    peak_mem = torch.cuda.max_memory_allocated()
    check(len(losses) == SSD_STEPS * SSD_EPOCHS and
          np.isfinite(losses).all(), f"ssd300 losses {losses}")
    print(f"  ssd300 training (mixed_bfloat16, batch {SSD_BATCH}, SGD 1e-3 "
          f"momentum 0.9): losses {[round(v, 4) for v in losses]}; images/s "
          f"per epoch {[round(r, 1) for r in rates]}; the ledger: "
          f"{gp['flops_per_step']:.6e} FLOPs per step, MFU {gp['mfu']} "
          f"(peak {gp['peak_flops']:.3e}), shares {gp['shares']}; peak "
          f"device memory {peak_mem} bytes on {card}", flush=True)
    print("  profile ssd300 bf16 train, per step:", flush=True)
    prof = profile_steps(
        lambda: est.train(x, y, batch_size=SSD_BATCH,
                          end_trigger=MaxIteration(est.step + 3)),
        1, (), per=3)
    rec["train"] = {"losses": losses, "images_per_s_epochs": rates,
                    "flops_per_step": gp["flops_per_step"],
                    "mfu": gp["mfu"], "shares": gp["shares"],
                    "max_memory_allocated": peak_mem,
                    "device_busy_share": prof["device_busy_share"],
                    "device_ms_per_step": prof["device_ms_per_step"],
                    "wall_ms_per_step": prof["wall_ms_per_step"],
                    "top": prof["top"][:8]}
    m.model._estimator = None
    del m, est, x
    torch.cuda.empty_cache()
    rec["f32_step"] = two_steps_held(
        "ssd300, f32 at batch 2, SGD 1e-3 momentum 0.9", build, w0,
        ssd_images(rs, 2), ssd_targets(rs, 2))
    torch.cuda.empty_cache()
    return rec


def seq2seq_ssd_path(card, detail):
    """Phase 17: Seq2seq and SSD300 on the card; no kernel of the
    eleven on this path."""
    import torch
    t0 = time.perf_counter()
    reset_launches()
    rec, parts = {}, {}
    for name, run in (("seq2seq", seq2seq_run), ("ssd300", ssd_run)):
        t = time.perf_counter()
        rec[name] = run(card)
        parts[name] = time.perf_counter() - t
    print(f"  phase 17 seconds by part: "
          f"{ {k: round(v, 1) for k, v in parts.items()} }", flush=True)
    rec["seconds_by_part"] = parts
    launches = all_launches()
    print(f"  no kernel of the eleven on this path: launches {launches}",
          flush=True)
    check(not any(launches.values()), f"phase 17 launched {launches}")
    rec["launches"] = launches
    rec["seconds"] = time.perf_counter() - t0
    print(f"  phase 17 in {rec['seconds']:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes on {card}",
          flush=True)
    detail["seq2seq_ssd"] = rec


# -- the image data path (phase 18) ------------------------------------------

# ImageNet's ingest size for a 224 crop (the recipe's 1.15x: 257 x 257),
# 512 seeded images, batch 128
IMG_INGEST, IMG_N, IMG_CROP = 257, 512, 224
AUG_TIMINGS = 21
# the recipe's ops that must match the CPU port bit for bit; the rest
# within 1e-3 on the 0-255 scale
AUG_EXACT = ("random_crop", "center_crop", "random_hflip", "cutout")


def host_image_pipeline(card):
    """Phase 18, part 1: 512 seeded 257x257x3 images as raw pixel bytes
    through ImagePixelBytesToMat, ImageHFlip, ImageBrightness,
    ImageSaturation, ImageChannelNormalize, ImageMatToTensor and
    ImageSetToSample (host images/s per stage), then ``to_feature_set``
    in the DRAM, DIRECT and PMEM tiers (each tier's ``iter_batches``
    images/s over one shuffled epoch at batch 128; PMEM's arena removed
    afterwards, its reads warm in the page cache)."""
    import shutil

    from analytics_zoo_tpu_torch.feature.image import (
        ImageBrightness, ImageChannelNormalize, ImageFeature, ImageHFlip,
        ImageMatToTensor, ImagePixelBytesToMat, ImageSaturation, ImageSet,
        ImageSetToSample)
    rs = np.random.RandomState(18)
    pixels = rs.randint(0, 256, (IMG_N, IMG_INGEST, IMG_INGEST, 3),
                        dtype=np.uint8)
    labels = rs.randint(0, 1000, IMG_N)
    iset = ImageSet([ImageFeature(pixels[i].tobytes(), label=int(labels[i]))
                     for i in range(IMG_N)])
    stages = [ImagePixelBytesToMat(IMG_INGEST, IMG_INGEST, 3),
              ImageHFlip(seed=1), ImageBrightness(seed=2),
              ImageSaturation(seed=3),
              ImageChannelNormalize(123.68, 116.779, 103.939, 58.393, 57.12,
                                    57.375),
              ImageMatToTensor(), ImageSetToSample()]
    rates = {}
    for stage in stages:
        t = time.perf_counter()
        iset = iset.transform(stage)
        rates[type(stage).__name__] = IMG_N / (time.perf_counter() - t)
    check(len(iset) == IMG_N, f"the host pipeline kept {len(iset)} images")
    print(f"  host stages, images/s on 1 thread: "
          f"{ {k: round(v, 1) for k, v in rates.items()} } on {card}",
          flush=True)
    x0 = iset.features[0][ImageFeature.SAMPLE].feature
    check(x0.shape == (IMG_INGEST, IMG_INGEST, 3) and x0.dtype == np.float32
          and np.isfinite(x0).all(), f"sample {x0.shape} {x0.dtype}")
    tiers = {}
    for tier in ("dram", "direct", "pmem"):
        t = time.perf_counter()
        fs = iset.to_feature_set(tier)
        build_s = time.perf_counter() - t
        try:
            t = time.perf_counter()
            n = 0
            for xb, yb in fs.iter_batches(TRAIN_BATCH, shuffle=True, seed=1):
                check(xb.shape == (TRAIN_BATCH, IMG_INGEST, IMG_INGEST, 3)
                      and yb.shape == (TRAIN_BATCH,),
                      f"{tier} batch {xb.shape} {yb.shape}")
                n += len(xb)
            rate = n / (time.perf_counter() - t)
        finally:
            store = getattr(fs, "_store", None)
            if store is not None:
                del fs
                shutil.rmtree(store.dir)
        check(n == IMG_N, f"{tier}: {n} images batched")
        tiers[tier] = {"build_s": build_s, "iter_images_per_s": rate}
        print(f"  FeatureSet {tier}: built in {build_s:.2f} s, iter_batches "
              f"{rate:.1f} images/s at batch {TRAIN_BATCH}"
              f"{' (page cache warm)' if tier == 'pmem' else ''} on {card}",
              flush=True)
    return {"stage_images_per_s": rates, "tiers": tiers}, pixels


def device_augment_run(pixels, card):
    """Phase 18, part 2: the recipe's augment (``examples/resnet_imagenet.
    py``'s ``device_augment``) at batch 128 from 257x257 to 224x224 on the
    card: one call under ``set_sync_debug_mode("error")``, the median of
    21 CUDA-event timings, then each op held to the CPU port's ``apply``
    on the same drawn parameters (copied to the host untimed)."""
    import torch

    from analytics_zoo_tpu_torch.examples.resnet_imagenet import \
        device_augment
    from analytics_zoo_tpu_torch.ops.rng import fold_in
    x = torch.from_numpy(pixels[:TRAIN_BATCH]).to(DEV).float()
    aug = device_augment(IMG_CROP)
    aug(0, x)                     # each op's constants, copied once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = aug(1, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(tuple(out.shape) == (TRAIN_BATCH, IMG_CROP, IMG_CROP, 3) and
          bool(torch.isfinite(out).all()), f"augment out {tuple(out.shape)}")
    med, lo, hi = time_window(lambda: aug(2, x), iters=1, warmup=2,
                              windows=AUG_TIMINGS)
    print(f"  augment at batch {TRAIN_BATCH}, {IMG_INGEST}^2 -> {IMG_CROP}^2 "
          f"(no host sync under set_sync_debug_mode('error')): {med:.4f} ms "
          f"per batch (median of {AUG_TIMINGS} CUDA-event timings; "
          f"{lo:.4f}-{hi:.4f}) on {card}", flush=True)
    errs = {}
    cur = x
    for i, op in enumerate(aug.ops):
        params = op.sample(fold_in(3, i), cur)
        got = op.apply(cur, params)
        want = op.apply(cur.cpu(), {k: v.cpu() for k, v in params.items()})
        err = float((got.cpu() - want).abs().max())
        tol = 0.0 if op.name in AUG_EXACT else 1e-3
        errs[op.name] = err
        check(err <= tol, f"{op.name} on the card vs the CPU port: {err}")
        cur = got
    print(f"  each op on the card vs the CPU port on the same draws, max "
          f"|err|: {errs}", flush=True)
    return {"device_ms": med, "device_ms_spread": [lo, hi],
            "timings": AUG_TIMINGS, "op_errors": errs}


def recipe_run(card, label, augment=True):
    """``examples/resnet_imagenet.py``'s recipe at full width (224,
    batch 128, 1000 classes, ``fused="defer"``, ``mixed_bfloat16``, 512
    synthetic samples, 2 epochs of 4 steps), with its augment or with
    ``augment=None`` on the host-cropped 224x224 data: the losses, the
    kernels' launches, images/s per epoch, the ledger's FLOPs per step
    and MFU, peak device memory."""
    import torch

    from analytics_zoo_tpu_torch.examples import resnet_imagenet
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    args = resnet_imagenet.parse_args(
        ["--image-size", str(IMG_CROP), "--batch-per-device",
         str(TRAIN_BATCH), "--classes", "1000", "--fused", "defer",
         "--epochs", "2"])
    os.environ["ZOO_TPU_DTYPE_POLICY"] = "mixed_bfloat16"
    try:
        est, x, y, batch = resnet_imagenet.recipe(args)
    finally:
        os.environ.pop("ZOO_TPU_DTYPE_POLICY", None)
    check(x.shape == (IMG_N, IMG_INGEST, IMG_INGEST, 3) and
          est.dtype_policy == "mixed_bfloat16", f"recipe data {x.shape}")
    if not augment:
        est.augment = None
        x = np.ascontiguousarray(x[:, :IMG_CROP, :IMG_CROP])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hist = est.train(x, y, batch_size=batch, nb_epoch=args.epochs).history
    torch.cuda.synchronize()
    launches = all_launches()
    residual = dict(cb.residual_launches)
    steps = est.step
    losses = [v for h in hist for v in h["losses"]]
    check(steps == 8 and len(losses) == 8 and np.isfinite(losses).all(),
          f"{label}: {steps} steps, losses {losses}")
    check_train_launches(launches, steps, label)
    check(residual == {"matmul_bn": 8 * steps, "matmul_bn_dx": 8 * steps},
          f"{label}: in_residual/dr launches {residual}, expected "
          f"{8 * steps} each")
    rates = [h["throughput"] for h in hist]
    mfus = [h["goodput"]["mfu"] for h in hist]
    peak = torch.cuda.max_memory_allocated()
    print(f"  {label}: losses {[round(v, 4) for v in losses]}; launches per "
          f"step B1 {launches['matmul_bn'] // steps} ("
          f"{residual['matmul_bn'] // steps} in_residual), B2 "
          f"{launches['conv3x3_bn'] // steps}, B3 "
          f"{launches['matmul_bn_dx'] // steps} ({residual['matmul_bn_dx'] // steps} "
          f"dr), B4 {launches['matmul_bn_dw'] // steps}; images/s per epoch "
          f"{[round(r, 1) for r in rates]}; FLOPs per step "
          f"{est.flops_per_step:.6e}, MFU per epoch "
          f"{[round(m, 5) for m in mfus]}; peak memory {peak} bytes on "
          f"{card}", flush=True)
    return {"losses": losses, "launches": launches,
            "residual_launches": residual, "images_per_s_epochs": rates,
            "flops_per_step": est.flops_per_step, "mfu_epochs": mfus,
            "peak_bytes": peak}, est, x, y


def feature_set_vs_arrays(est, x, y, card):
    """Phase 18, part 4: the recipe's Estimator fed one epoch from arrays
    and one from ``FeatureSet.array`` in turns (A B B A): images/s of
    each (a FeatureSet's batches reach the placement as an ArrayDataset
    each, ``_whole_batches``)."""
    import torch

    from analytics_zoo_tpu_torch.feature import FeatureSet
    fs = FeatureSet.array(x, y)
    rates = {"arrays": [], "feature_set": []}
    # no FLOP count in a run's first step: every call here is a run
    os.environ["ZOO_TPU_GOODPUT_FLOPS"] = "0"
    try:
        for key in ("arrays", "feature_set", "feature_set", "arrays"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            hist = est.train(fs if key == "feature_set" else x,
                             None if key == "feature_set" else y,
                             batch_size=TRAIN_BATCH, nb_epoch=1).history
            torch.cuda.synchronize()
            rates[key].append(len(x) / (time.perf_counter() - t))
            check(np.isfinite(hist[-1]["losses"]).all(),
                  f"{key}: losses {hist[-1]['losses']}")
    finally:
        os.environ.pop("ZOO_TPU_GOODPUT_FLOPS", None)
    print(f"  fit from arrays {[round(r, 1) for r in rates['arrays']]} and "
          f"from a FeatureSet {[round(r, 1) for r in rates['feature_set']]} "
          f"images/s (epochs in turns A B B A, host clock) on {card}",
          flush=True)
    return rates


def image_examples(card):
    """Phase 18, part 5: ``examples/rdd_ingest.py`` at its defaults and
    ``examples/image_classification.py``'s synthetic branch with
    ResNet-50 at 224 and 1000 classes on the card."""
    from analytics_zoo_tpu_torch.examples import (image_classification,
                                                  rdd_ingest)
    reset_launches()
    metrics = rdd_ingest.main([])
    check(all(np.isfinite(v) for v in metrics.values()) and
          0 <= metrics["accuracy"] <= 1, f"rdd_ingest metrics {metrics}")
    top_n = 3
    results = image_classification.main(
        ["--model", "resnet-50", "--image-size", str(IMG_CROP),
         "--classes", "1000", "--top-n", str(top_n)])
    check(len(results) == 4 and all(
        len(top) == top_n and all(0 <= c < 1000 and np.isfinite(p)
                                  for c, p in top) for _, top in results),
          f"image_classification results {results}")
    launches = {k: v for k, v in all_launches().items() if v}
    print(f"  rdd_ingest metrics {metrics}; image_classification top-"
          f"{top_n} of 4 images printed; launches {launches} on {card}",
          flush=True)
    return {"rdd_ingest": metrics, "image_classification": results,
            "launches": launches}


def image_data_path(card, detail):
    """Phase 18: the image data path on the card; returns B1-B4's
    launches over the recipe's augmented run."""
    import torch
    t0 = time.perf_counter()
    rec, parts = {}, {}
    t = time.perf_counter()
    rec["host"], pixels = host_image_pipeline(card)
    parts["host"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["augment"] = device_augment_run(pixels, card)
    del pixels
    parts["augment"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["recipe"], est, x, y = recipe_run(card, "recipe with augment")
    parts["recipe"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["feature_set_vs_arrays"] = feature_set_vs_arrays(est, x, y, card)
    del est, x, y
    torch.cuda.empty_cache()
    parts["feature_set_vs_arrays"] = time.perf_counter() - t
    t = time.perf_counter()
    rec["recipe_plain"] = recipe_run(card, "recipe, augment=None",
                                     augment=False)[0]
    torch.cuda.empty_cache()
    parts["recipe_plain"] = time.perf_counter() - t
    aug_flops = (rec["recipe"]["flops_per_step"] -
                 rec["recipe_plain"]["flops_per_step"])
    # the resized crop's two products: (n, 224, 257) x (n, 257, 257 * 3),
    # then (n, 224, 257) x (n, 257, 224 * 3)
    want = (2 * TRAIN_BATCH * IMG_CROP * IMG_INGEST * IMG_INGEST * 3 +
            2 * TRAIN_BATCH * IMG_CROP * IMG_INGEST * IMG_CROP * 3)
    print(f"  FLOPs per step with the augment "
          f"{rec['recipe']['flops_per_step']:.6e}, without "
          f"{rec['recipe_plain']['flops_per_step']:.6e}: the augment's "
          f"{aug_flops:.6e} (its two products {want:.6e}, "
          f"{aug_flops / rec['recipe']['flops_per_step']:.4%} of the step); "
          f"images/s with it {rec['recipe']['images_per_s_epochs']}, "
          f"without {rec['recipe_plain']['images_per_s_epochs']} on {card}",
          flush=True)
    check(aug_flops == want, f"the augment's FLOPs {aug_flops}, expected "
          f"{want}")
    rec["augment_flops"] = aug_flops
    t = time.perf_counter()
    rec["examples"] = image_examples(card)
    parts["examples"] = time.perf_counter() - t
    check("PIL" not in sys.modules, "PIL was imported on phase 18's path")
    rec["seconds_by_part"] = parts
    rec["seconds"] = time.perf_counter() - t0
    print(f"  phase 18 seconds by part: "
          f"{ {k: round(v, 1) for k, v in parts.items()} }; in "
          f"{rec['seconds']:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes on {card}", flush=True)
    detail["image_data_path"] = rec
    return rec["recipe"]["launches"]


# -- the observability plane (phase 19) --------------------------------------

# /predict requests of the light stage (one client, one image each: at
# least 100, so that a p99 is not the slowest request) and of the load
# stage (HTTP_CLIENTS clients, PLANE_LOAD_IMAGES images each: under
# bench_serving's mix the p99 sits at 1.0 s, a bucket bound, where the
# handler's time and the clients' fall on either side of it)
PLANE_LIGHT, PLANE_LOAD, PLANE_LOAD_IMAGES = 100, 48, 3
# /generate: one prompt of this many tokens per slot (a prefill at the
# bucket of 2048 each, through B7), each with the batcher's largest
# budget: 123 pages a request, 984 of the pool's 1024 in all
PLANE_GEN_PROMPT, PLANE_GEN_NEW = 1700, 256
PLANE_TRAIN_STEPS = 6
PLANE_COST_N = 21          # the median of this many of each cost
# the forecaster's trend window (ZOO_TPU_FORECAST_WINDOW_S; 120 s by
# default): short enough that the pool's fall leaves it within the phase
PLANE_FORECAST_WINDOW_S = "15"
# the event log's rotation size (ZOO_TPU_EVENT_LOG_MAX_MB): a few events
PLANE_EVENT_LOG_MAX_MB = "0.001"
PLANE_TICK_S = "1"         # ZOO_TPU_SLO_TICK_S: the SLO ticker's period


def plane_value(snap, name, **labels):
    """Sum of the values of ``name``'s children whose labels hold
    ``labels`` in a registry snapshot (None when the family is absent)."""
    fam = snap.get(name)
    if fam is None:
        return None
    return sum(v.get("value", 0.0) for v in fam["values"]
               if all(v["labels"].get(k) == w for k, w in labels.items()))


def plane_get(port, path):
    """``(status, headers, body bytes)`` of one GET, errors included."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def plane_objectives(port, tick=True):
    """``{id: objective}`` from ``GET /debug/slo`` (a tick first)."""
    status = get_json(port, "/debug/slo" if tick else "/debug/slo?tick=0")
    return {o["id"]: o for o in status["objectives"]}


def plane_points(payload, **labels):
    """The points of the one series of a history payload whose labels
    are ``labels``."""
    got = [s["points"] for s in payload["series"] if s["labels"] == labels]
    check(len(got) == 1, f"{payload['family']}: series {labels} found "
          f"{len(got)} times")
    return got[0]


def plane_events(path):
    """The records of the event log at ``path``: its rotated segments
    (gzipped or raw) and the live file."""
    import glob
    import gzip
    out = []
    for seg in sorted(glob.glob(path + ".*")):
        opener = gzip.open if seg.endswith(".gz") else open
        with opener(seg, "rt", encoding="utf-8") as f:
            out += [json.loads(x) for x in f.read().splitlines()]
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            out += [json.loads(x) for x in f.read().splitlines()]
    return out


def plane_median_ms(fn, n=PLANE_COST_N):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def plane_serve(card, rec, tmp, log_path):
    """Phase 19, the server: ResNet-50 (bf16, fused) behind a
    DynamicBatcher and a GPT-1-width generator on one InferenceServer
    with the SLO ticker at 1 s; the light and load stages against the
    shipped objectives, the history's exact deltas, the KV-page
    forecast, the dashboard, a profile capture under traffic, an
    injected dispatch fault and a federation collector over this
    server; the costs. Returns the kernel launches of the run."""
    import glob

    import torch

    from analytics_zoo_tpu_torch.common import faults, federation, forecast
    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.common import slo, timeseries
    from analytics_zoo_tpu_torch.pipeline.inference import (
        DynamicBatcher, InferenceModel, InferenceServer, serving)
    parts = rec["seconds_by_part"]
    t = time.perf_counter()
    rs = np.random.RandomState(19)
    x8 = torch.from_numpy(rs.rand(8, *IMAGE).astype(np.float32))
    im = InferenceModel(supported_concurrent_num=2).load_keras_net(
        served_resnet(), example_inputs=[x8.to(DEV, torch.bfloat16)])
    gnet = gpt_net()
    params = gnet.build(torch.Generator().manual_seed(0), (GEN_T,))
    params["tok_embed"] = params["tok_embed"] * GEN_EMBED_SCALE
    im.load_generator(gnet, params, max_slots=GEN_SLOTS, max_context=GEN_T,
                      page_size=GEN_PAGE)
    del params
    eng = im.generator
    # one body per request size: the light stage's and the load
    # stage's; the traced request's 3 rows pad to 4
    bodies = {n: json.dumps({"inputs": np.round(rs.rand(n, *IMAGE), 3)
                             .tolist()}).encode()
              for n in sorted({1, PLANE_LOAD_IMAGES, 3})}
    srv = InferenceServer(im, port=0, batcher=DynamicBatcher(
        im, max_batch_size=BATCH, max_wait_ms=5, queue_depth=512))
    srv.start()
    port = srv.port
    parts["build_and_warm"] = time.perf_counter() - t
    buckets = []

    def admit(reqs):            # records each prefill's bucket
        n = max(len(r[0]) for r in reqs)
        buckets.append(next(b for b in eng.prompt_buckets if b >= n))
        return type(eng).admit(eng, reqs)
    eng.admit = admit
    # the host's full garbage collections while the server runs: (count,
    # longest ms), a stall the clients' latencies would show
    gc_pauses = [0, 0.0]
    gc_t0 = [0.0]

    def gc_watch(phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_pauses[0] += 1
            gc_pauses[1] = max(gc_pauses[1], round(
                (time.perf_counter() - gc_t0[0]) * 1e3, 3))
    gc.callbacks.append(gc_watch)
    try:
        engine = slo.get_engine()
        want_ids = sorted(d["id"] for d in slo.DEFAULT_SERVING_SLOS +
                          slo.DEFAULT_FORECAST_SLOS)
        check(sorted(o["id"] for o in engine.status()["objectives"]) ==
              want_ids and engine._thread is not None and
              engine._interval_s == float(PLANE_TICK_S),
              f"start() installed {engine.status()['objectives']}, ticker "
              f"{engine._interval_s}")
        check(forecast._on_sample in timeseries.get_history()._listeners,
              "start() did not wire the forecaster to the history")
        snap = obs.snapshot()
        check(plane_value(snap, "zoo_tpu_serving_gen_free_pages") ==
              eng.allocator.max_pages and plane_value(
                  snap, "zoo_tpu_serving_gen_queue_depth") == 0,
              "the generation gauges are not set before the first request")
        reset_launches()
        counts0 = served_counts()
        steps0 = plane_value(snap, "zoo_tpu_serving_gen_steps_total") or 0

        # -- light stage: the objectives as shipped stay healthy ----------
        t = time.perf_counter()
        lat_light = []
        for _ in range(PLANE_LIGHT):
            code, _, body, dt = post_json(port, "/predict", bodies[1])
            out = np.asarray(body["outputs"], np.float32) if code == 200 \
                else None
            check(code == 200 and out.shape == (1, 1000) and
                  np.isfinite(out).all(), f"light /predict {code}")
            lat_light.append(dt)
        objs = plane_objectives(port)
        serving_ids = [d["id"] for d in slo.DEFAULT_SERVING_SLOS]
        light = {k: (objs[k]["state"], objs[k]["value"]) for k in objs}
        slowest = sorted(range(PLANE_LIGHT), key=lambda i: -lat_light[i])[:3]
        print(f"  light stage ({PLANE_LIGHT} /predict of one image, one "
              f"client): {light}; the clients' p50 "
              f"{percentile_ms(lat_light, 50):.1f} ms, p99 "
              f"{percentile_ms(lat_light, 99):.1f} ms, the slowest "
              f"{[(i, round(lat_light[i] * 1e3, 1)) for i in slowest]} "
              f"(request, ms); full garbage collections so far "
              f"{gc_pauses} on {card}", flush=True)
        for k in serving_ids:
            check(objs[k]["state"] in ("ok", "no_data"),
                  f"light stage: {k} is {objs[k]['state']}")
        rec["light"] = {"objectives": light,
                        "client_p50_ms": percentile_ms(lat_light, 50),
                        "client_p99_ms": percentile_ms(lat_light, 99),
                        "client_max_ms": max(lat_light) * 1e3}
        parts["light"] = time.perf_counter() - t

        # -- load stage: serving_latency_p99 as shipped -------------------
        t = time.perf_counter()
        fam_req = "zoo_tpu_serving_requests_total"
        fam_lat = "zoo_tpu_serving_request_seconds"
        base = get_json(port, f"/debug/metrics/history?family={fam_req}")
        base_ts = plane_points(base, path="/predict",
                               status="200")[-1]["ts"]
        a0 = plane_value(obs.snapshot(), "zoo_tpu_anomalies_total",
                         kind="slo_breach") or 0.0
        sizes = [PLANE_LOAD_IMAGES] * PLANE_LOAD
        replies = [None] * PLANE_LOAD

        def client(c):
            for i in range(c, PLANE_LOAD, HTTP_CLIENTS):
                replies[i] = post_json(port, "/predict", bodies[sizes[i]])

        with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            for f in [pool.submit(client, c) for c in range(HTTP_CLIENTS)]:
                f.result()
        for i, r in enumerate(replies):
            check(r[0] == 200 and np.asarray(r[2]["outputs"]).shape ==
                  (sizes[i], 1000), f"load /predict {i}: {r[0]}")
        client_p99 = float(np.percentile([r[3] for r in replies], 99))
        objs = plane_objectives(port)
        lat = objs["serving_latency_p99"]
        check(lat["value"] is not None, f"load stage: no p99 {lat}")
        # the clients' p99 as the engine ranks it: over the requests its
        # 60 s window holds (the load stage and the light stage's latest;
        # the history's first sample may follow the first requests), the
        # ceil(0.99 n)-th smallest
        n_win = int(lat["window_results"][0]["events"])
        check(PLANE_LOAD < n_win <= PLANE_LIGHT + PLANE_LOAD, f"the "
              f"engine's window holds {n_win} /predict requests of "
              f"{PLANE_LIGHT + PLANE_LOAD} sent")
        ranked = sorted((lat_light + [r[3] for r in replies])[-n_win:])
        client_rank_p99 = ranked[-(-99 * n_win // 100) - 1]
        snap = obs.snapshot()
        breaches = plane_value(snap, "zoo_tpu_slo_breaches_total",
                               slo="serving_latency_p99") or 0.0
        a1 = plane_value(snap, "zoo_tpu_anomalies_total",
                         kind="slo_breach") or 0.0
        bounds = list(obs.DEFAULT_BUCKETS) + [float("inf")]
        b_eng = next(i for i, b in enumerate(bounds) if lat["value"] <= b)
        b_cli = next(i for i, b in enumerate(bounds)
                     if client_rank_p99 <= b)
        print(f"  load stage ({PLANE_LOAD} /predict of {sum(sizes)} images "
              f"from {HTTP_CLIENTS} clients): serving_latency_p99 "
              f"{lat['state']}, the engine's p99 {lat['value']:.4f} s "
              f"(windows {[(w['window_s'], w['value']) for w in lat['window_results']]}), "
              f"the clients' p99 {client_p99:.4f} s over the load stage "
              f"and {client_rank_p99:.4f} s ranked as the engine ranks "
              f"({n_win} requests), buckets up to {bounds[b_eng]} / "
              f"{bounds[b_cli]}; breaches {breaches}, "
              f"slo_breach anomalies {a0} -> {a1} on {card}", flush=True)
        check(b_eng == b_cli, f"the engine's p99 {lat['value']} and the "
              f"clients' {client_rank_p99} lie in different buckets")
        if lat["state"] == "breach":
            check(breaches == 1 and a1 == a0 + 1, f"one breach counted "
                  f"{breaches} times, anomalies {a0} -> {a1}")
            for k in range(5):
                objs = plane_objectives(port)
                snap = obs.snapshot()
                check(objs["serving_latency_p99"]["state"] == "breach" and
                      plane_value(snap, "zoo_tpu_slo_breaches_total",
                                  slo="serving_latency_p99") == 1 and
                      plane_value(snap, "zoo_tpu_anomalies_total",
                                  kind="slo_breach") == a1,
                      f"tick {k + 1} after the breach: "
                      f"{objs['serving_latency_p99']['state']}, counters "
                      "moved")
        print(f"    full garbage collections so far {gc_pauses} (count, "
              "longest ms)", flush=True)
        rec["load"] = {"state": lat["state"], "engine_p99_s": lat["value"],
                       "client_p99_s": client_p99,
                       "client_rank_p99_s": client_rank_p99,
                       "breaches": breaches,
                       "images": sum(sizes)}

        # -- history: exact deltas over the load stage --------------------
        hist = get_json(port, f"/debug/metrics/history?family={fam_req}"
                        "&window=600")
        sent = sum(p["value"] for p in plane_points(
            hist, path="/predict", status="200") if p["ts"] > base_ts)
        hist = get_json(port, f"/debug/metrics/history?family={fam_lat}"
                        "&window=600")
        counted = sum(p["count"] for p in plane_points(
            hist, path="/predict") if p["ts"] > base_ts)
        check(sent == counted == PLANE_LOAD, f"history after the load "
              f"stage: {sent} requests in the counter's deltas, {counted} "
              f"in the histogram's summaries, {PLANE_LOAD} sent")
        for q in ("window=0", "window=x"):
            code = plane_get(port, "/debug/metrics/history?family="
                             f"{fam_req}&{q}")[0]
            check(code == 400, f"history {q}: {code}")
        print(f"  history: the load stage's {PLANE_LOAD} requests in the "
              f"counter's deltas ({sent:g}) and the histogram's counts "
              f"({counted:g}); window=0 and window=x answer 400", flush=True)
        parts["load_and_history"] = time.perf_counter() - t

        # -- forecast: the page pool fills -------------------------------
        t = time.perf_counter()

        def eta_pages():
            snap = obs.snapshot()
            return (plane_value(snap, "zoo_tpu_forecast_eta_s",
                                resource="kv_pages"),
                    plane_value(snap, "zoo_tpu_serving_gen_free_pages"))

        eta0, pages0 = eta_pages()
        check(eta0 == forecast.NO_ETA and pages0 == eng.allocator.max_pages,
              f"before /generate: ETA {eta0}, {pages0} pages free")
        prompts = [rs.randint(1, GPT["vocab"], size=PLANE_GEN_PROMPT).tolist()
                   for _ in range(GEN_SLOTS)]
        readings, done = [], threading.Event()

        def sampler():
            while not done.is_set():
                readings.append((time.perf_counter(), *eta_pages()))
                time.sleep(0.1)

        def gen_client(i):
            time.sleep(0.4 * i)        # the pool falls over ~3 s
            return post_json(port, "/generate", json.dumps(
                {"prompt": prompts[i], "max_new_tokens": PLANE_GEN_NEW}
            ).encode())

        watcher = threading.Thread(target=sampler, daemon=True)
        watcher.start()
        with concurrent.futures.ThreadPoolExecutor(GEN_SLOTS) as pool:
            gen = [f.result() for f in [pool.submit(gen_client, i)
                                        for i in range(GEN_SLOTS)]]
        done.set()
        watcher.join()
        for i, r in enumerate(gen):
            check(r[0] == 200 and len(r[2]["tokens"]) == PLANE_GEN_NEW,
                  f"/generate {i}: {r[0]} {str(r[2])[:200]}")
        falling = [(e, p) for _, e, p in readings
                   if p is not None and p < eng.allocator.max_pages]
        finite = [e for e, p in falling if e < forecast.NO_ETA]
        min_pages = min(p for _, p in falling)
        check(finite, f"the kv_pages ETA never left {forecast.NO_ETA} while "
              f"free pages fell to {min_pages}")
        least = min(finite, default=None)
        objs = plane_objectives(port)
        kv_rule = objs["forecast_kv_pages_eta"]
        pending = objs["forecast_capacity_pending"]
        print(f"  forecast: free pages fell to {min_pages} of "
              f"{eng.allocator.max_pages}; the kv_pages ETA finite in "
              f"{len(finite)} of {len(falling)} readings while they fell, "
              f"least {least} s; forecast_kv_pages_eta "
              f"{kv_rule['state']} (breaches {kv_rule['breaches']}), "
              f"forecast_capacity_pending {pending['state']}; "
              f"{len(gen)} /generate of {PLANE_GEN_PROMPT} + "
              f"{PLANE_GEN_NEW} tokens, prefills at {buckets} on {card}",
              flush=True)
        rec["forecast"] = {"min_free_pages": min_pages,
                           "finite_readings": len(finite),
                           "falling_readings": len(falling),
                           "least_eta_s": least,
                           "kv_pages_eta": kv_rule["state"],
                           "kv_pages_eta_breaches": kv_rule["breaches"],
                           "capacity_pending": pending["state"]}
        parts["forecast"] = time.perf_counter() - t
        t_idle = time.perf_counter()

        # -- dashboard ----------------------------------------------------
        code, hdrs, raw = plane_get(port, "/debug/dashboard")
        check(code == 200 and hdrs["Content-Type"].startswith("text/html")
              and raw == serving._dashboard_html(),
              f"/debug/dashboard: {code} {hdrs['Content-Type']}, "
              f"{len(raw)} bytes")

        # -- profile under /predict traffic --------------------------------
        t = time.perf_counter()
        prof_dir = os.path.join(tmp, "profile")
        stop = threading.Event()
        side = {"ok": 0, "bad": []}

        def traffic():
            while not stop.is_set():
                code = post_json(port, "/predict", bodies[1])[0]
                if code == 200:
                    side["ok"] += 1
                else:
                    side["bad"].append(code)

        bg = threading.Thread(target=traffic, daemon=True)
        bg.start()
        while side["ok"] < 2 and not side["bad"]:
            time.sleep(0.01)
        body = json.dumps({"dir": prof_dir, "ms": 500}).encode()
        first = post_json(port, "/debug/profile", body)
        second = post_json(port, "/debug/profile", body)
        serving._profile_thread.join(timeout=120)
        stop.set()
        bg.join()
        check(first[0] == 200 and second[0] == 503 and not side["bad"],
              f"/debug/profile {first[0]} then {second[0]}; traffic "
              f"{side}")
        files = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
        check(len(files) == 1, f"profile traces {files}; events "
              f"{[e for e in plane_events(log_path) if 'profile' in e['event']]}")
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        check(kernels, "the capture holds no CUDA kernel event")
        found = {label: sum(bool(re.search(pat, n)) for n in kernels)
                 for label, pat in SERVE_KERNEL_NAMES}
        print(f"  profile: 200 then 503 during the capture; "
              f"{len(events)} events, {len(kernels)} CUDA kernels, B5/B6 "
              f"by name {found}; {side['ok']} /predict beside it on {card}",
              flush=True)
        check(all(found.values()), f"the capture misses {found}")
        rec["profile"] = {"events": len(events), "kernels": len(kernels),
                          "by_name": found}
        parts["profile"] = time.perf_counter() - t

        # -- an injected dispatch fault ------------------------------------
        faults.arm("batcher/dispatch", "error", times=1)
        failed = post_json(port, "/predict", bodies[1])
        after = post_json(port, "/predict", bodies[1])
        logged = [(e["event"], e.get("point")) for e in plane_events(log_path)
                  if e["event"].startswith("faults/")]
        check(failed[0] == 500 and after[0] == 200 and logged == [
            ("faults/armed", "batcher/dispatch"),
            ("faults/injected", "batcher/dispatch")],
            f"armed fault: {failed[0]}, then {after[0]}; log {logged}")

        # -- federation over this server ----------------------------------
        t = time.perf_counter()
        replica = type("Replica", (), {"name": "r0",
                                       "url": f"http://127.0.0.1:{port}"})()
        holder = type("Router", (), {})()
        holder.pool = type("Pool", (), {"replicas": [replica]})()
        col = federation.TelemetryCollector(holder, tick_s=0)
        col.tick()
        cursor0 = col.status()["sources"]["r0"]["trace_cursor"]
        tid = "smoke-plane-fed"
        code, hdrs, _, _ = post_json(port, "/predict", bodies[3],
                                     {"X-Zoo-Trace-Id": tid})
        check(code == 200 and hdrs["X-Zoo-Trace-Id"] == tid,
              f"traced /predict {code}")
        col.tick()
        cursor1 = col.status()["sources"]["r0"]["trace_cursor"]
        with col.aggregator._lock:
            spans = list(col.aggregator._buf)
        for src in ("router", "r0"):
            ids = [s["span_id"] for s in spans if s["source"] == src]
            check(len(ids) == len(set(ids)),
                  f"{src}: {len(ids) - len(set(ids))} spans repeated")
        stitched = col.aggregator.trace(tid)
        names = {s["name"] for s in stitched["spans"]
                 if s["source"] == "r0"}
        check(cursor1 > cursor0 and {
            "serving/request", "serving/queue_wait", "serving/pad",
            "serving/predict", "serving/scatter"} <= names,
            f"cursor {cursor0} -> {cursor1}; trace {tid} from r0 holds "
            f"{names}")
        col.tick()
        merged, conflicts = col.merged_snapshot()
        local = get_json(port, "/metrics/json")["metrics"]
        compared = 0
        for name, fam in local.items():
            if fam["type"] != "counter" or \
                    not name.startswith("zoo_tpu_serving_"):
                continue
            for child in fam["values"]:
                if child["labels"].get("path") in ("/metrics/json",
                                                   "/debug/traces"):
                    continue        # the collector's own scrapes
                got = plane_value(merged, name, **child["labels"])
                # two sources, one registry: the router's own process
                # and the replica's /metrics/json
                check(got == 2 * child["value"], f"merged {name}"
                      f"{child['labels']} {got}, /metrics/json "
                      f"{child['value']}")
                compared += 1
        snap = obs.snapshot()
        fed = {k: snap[k]["values"] for k in snap
               if k.startswith("zoo_tpu_fed_")}
        check(not conflicts and compared > 0 and
              plane_value(snap, "zoo_tpu_fed_sources") == 2 and
              plane_value(snap, "zoo_tpu_fed_scrapes_total", replica="r0",
                          ok="1") == 3 and
              "zoo_tpu_fed_latency_p99_seconds" in fed and
              "zoo_tpu_fed_error_ratio" in fed,
              f"federation: conflicts {conflicts}, {compared} counters, "
              f"fed metrics {sorted(fed)}")
        print(f"  federation: {compared} serving counters merged over the "
              f"router and r0 equal twice /metrics/json's; trace cursor "
              f"{cursor0} -> {cursor1}, no span repeated; {tid} stitched "
              f"with {sorted(names)}; {sorted(fed)}", flush=True)
        parts["federation"] = time.perf_counter() - t

        # -- costs on the host --------------------------------------------
        hist_store = timeseries.get_history()
        costs = {"slo_tick_ms": plane_median_ms(engine.tick),
                 "history_sample_ms": plane_median_ms(hist_store.sample),
                 "collector_tick_ms": plane_median_ms(col.tick),
                 "history_bytes": hist_store.stats()["resident_bytes"],
                 "objectives": len(engine.status()["objectives"]),
                 "families": len(obs.snapshot())}
        print(f"  costs (host, the median of {PLANE_COST_N}): "
              f"SLOEngine.tick() {costs['slo_tick_ms']:.3f} ms over "
              f"{costs['objectives']} objectives and {costs['families']} "
              f"families, MetricHistory.sample() (the forecaster "
              f"riding it) {costs['history_sample_ms']:.3f} ms, collector "
              f"tick (two HTTP scrapes and the merge) "
              f"{costs['collector_tick_ms']:.3f} ms; the history "
              f"{costs['history_bytes']} bytes resident "
              f"({hist_store.stats()['raw_samples']} raw samples) on {card}",
              flush=True)
        rec["costs"] = costs

        # -- the ETA back to its sentinel, idle ---------------------------
        t = time.perf_counter()
        while True:
            eta, pages = eta_pages()
            if eta == forecast.NO_ETA and pages == eng.allocator.max_pages:
                break
            check(time.perf_counter() - t_idle < 60, f"idle for "
                  f"{time.perf_counter() - t_idle:.1f} s: ETA {eta}, "
                  f"{pages} pages free")
            time.sleep(0.25)
        rec["forecast"]["idle_to_no_eta_s"] = time.perf_counter() - t_idle
        print(f"  the kv_pages ETA back to {forecast.NO_ETA:g} "
              f"{rec['forecast']['idle_to_no_eta_s']:.1f} s after the pool "
              f"refilled", flush=True)
        parts["idle_wait"] = time.perf_counter() - t
        torch.cuda.synchronize()
        launches = all_launches()
        counts1 = served_counts()
        steps = (plane_value(obs.snapshot(),
                             "zoo_tpu_serving_gen_steps_total") or 0) - steps0
    finally:
        gc.callbacks.remove(gc_watch)
        del eng.admit
        srv.stop()
    rec["full_gc"] = gc_pauses
    execs = counts1["batch_executions"] - counts0["batch_executions"]
    n_b7 = sum(b >= 1024 for b in buckets)
    nb = GPT["n_block"]
    want = {"matmul_bn_apply": 36 * execs, "conv3x3_bn_apply": 16 * execs,
            "flash_decode": nb * steps, "flash_fwd": nb * n_b7}
    want.update({k: 0 for k in launches if k not in want})
    print(f"  the server's launches {launches} in {execs} bucket "
          f"executions, {steps:g} decode steps and {n_b7} prefills at "
          f"buckets >= 1024", flush=True)
    check(launches == want and n_b7 > 0 and steps > 0,
          f"launches {launches}, expected {want}")
    return launches


def plane_train(card, rec):
    """Phase 19, training: ``Estimator.train`` on bench.py's flagship
    (s2d stem, ``fused="defer"``, batch 128, ``mixed_bfloat16``) installs
    the training objectives; B1-B4 launch 36/16/36/36 per step."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.common import slo
    zoo.init_nncontext(seed=0)
    n = PLANE_TRAIN_STEPS * TRAIN_BATCH
    gen = np.random.default_rng(19)
    x = gen.random((n, *IMAGE), dtype=np.float32)
    y = gen.integers(0, 1000, size=(n, 1)).astype(np.int32)
    net = flagship_model()
    net.init_params()
    compile_flagship(net)
    reset_launches()
    t0 = time.perf_counter()
    res = net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    steps = PLANE_TRAIN_STEPS
    want = {"matmul_bn": 36 * steps, "conv3x3_bn": 16 * steps,
            "matmul_bn_dx": 36 * steps, "matmul_bn_dw": 36 * steps}
    want.update({k: 0 for k in launches if k not in want})
    losses = res.history[-1]["losses"]
    check(launches == want and len(losses) == steps and
          np.isfinite(losses).all(), f"train: launches {launches} (expected"
          f" {want}), losses {losses}")
    objs = {o["id"]: o for o in slo.get_engine().tick()["objectives"]}
    rules = {d["id"]: (objs[d["id"]]["state"], objs[d["id"]]["value"])
             for d in slo.DEFAULT_TRAINING_SLOS if d["id"] in objs}
    check(len(rules) == 3, f"training objectives installed: {sorted(objs)}")
    print(f"  Estimator.train, {steps} steps at batch {TRAIN_BATCH} in "
          f"{wall:.2f} s: launches per step B1 {launches['matmul_bn'] / steps:g}"
          f", B2 {launches['conv3x3_bn'] / steps:g}, B3 "
          f"{launches['matmul_bn_dx'] / steps:g}, B4 "
          f"{launches['matmul_bn_dw'] / steps:g}; the training objectives "
          f"{rules} on {card}", flush=True)
    rec["train"] = {"wall_s": wall, "rules": rules,
                    "launches": {k: v for k, v in launches.items() if v}}
    del net, x
    torch.cuda.empty_cache()
    return launches


def plane_path(card, detail):
    """Phase 19: the observability plane's judgement layer on the card
    (:func:`plane_serve`, :func:`plane_train`), then the event log's
    rotation. Returns the serving and the training launches."""
    import glob
    import tempfile

    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.common import forecast, slo, timeseries
    from analytics_zoo_tpu_torch.common import observability as obs
    t0 = time.perf_counter()
    rec = {"seconds_by_part": {}}
    env = {"ZOO_TPU_SLO_TICK_S": PLANE_TICK_S,
           "ZOO_TPU_FORECAST_WINDOW_S": PLANE_FORECAST_WINDOW_S,
           "ZOO_TPU_EVENT_LOG_MAX_MB": PLANE_EVENT_LOG_MAX_MB}
    saved = {k: os.environ.get(k) for k in list(env) + ["ZOO_TPU_EVENT_LOG"]}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "chiprun_out")
                                     ) as tmp:
        log_path = os.path.join(tmp, "events.jsonl")
        env["ZOO_TPU_EVENT_LOG"] = log_path
        # the earlier phases' servers left an engine ticking: start clean
        for reset in (slo.reset_slo, forecast.reset_forecast,
                      timeseries.reset_history, obs.reset_metrics):
            reset()
        # the earlier phases' heap out of the collector's sight, as a
        # server's own process would start: a full collection of it took
        # 234-377 ms and stalled one light-stage request
        gc.collect()
        gc.freeze()
        print(f"  {gc.get_freeze_count()} objects of the earlier phases "
              "frozen out of the garbage collector's scans", flush=True)
        os.environ.update(env)
        try:
            zoo.init_nncontext(seed=0)
            served = plane_serve(card, rec, tmp, log_path)
            torch.cuda.empty_cache()
            t = time.perf_counter()
            trained = plane_train(card, rec)
            rec["seconds_by_part"]["train"] = time.perf_counter() - t
            # the event log, with no writer left: rotated, and its bytes
            # gauge the files on disk
            slo.get_engine().stop()
            rotated = sorted(os.path.basename(p)
                             for p in glob.glob(log_path + ".*"))
            on_disk = sum(os.path.getsize(p) for p in
                          glob.glob(log_path + ".*") + [log_path])
            gauge = plane_value(obs.snapshot(), "zoo_tpu_event_log_bytes")
            rotations = plane_value(obs.snapshot(),
                                    "zoo_tpu_event_log_rotations_total")
            events = collections.Counter(e["event"]
                                         for e in plane_events(log_path))
            print(f"  event log: {rotations:g} rotations, segments "
                  f"{rotated}, {gauge:g} bytes by the gauge and {on_disk} "
                  f"on disk; kept records {dict(events)}", flush=True)
            check("events.jsonl.1.gz" in rotated and gauge == on_disk,
                  f"event log: segments {rotated}, gauge {gauge}, disk "
                  f"{on_disk}")
            rec["event_log"] = {"rotations": rotations, "segments": rotated,
                                "bytes": on_disk, "kept": dict(events)}
        finally:
            gc.unfreeze()
            for reset in (slo.reset_slo, forecast.reset_forecast,
                          timeseries.reset_history, obs.reset_metrics):
                reset()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    rec["seconds"] = time.perf_counter() - t0
    print(f"  phase 19 seconds by part: "
          f"{ {k: round(v, 1) for k, v in rec['seconds_by_part'].items()} };"
          f" in {rec['seconds']:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes on {card}", flush=True)
    detail["plane"] = rec
    return served, trained


# -- nnframes (phase 20) ------------------------------------------------------

# BASELINE's metric, "nnframes ResNet-50 images/sec/chip", on bench.py's
# flagship: 512 rows, 2 epochs of 4 steps at batch 128
NN_ROWS, NN_EPOCHS = 512, 2
# dogs-vs-cats (BASELINE's second configuration): Inception-v1 at 224,
# 2 classes, everything but the head frozen; 64 images a class
DOGS_PER_CLASS, DOGS_BATCH, DOGS_EPOCHS = 64, 32, 2
# the nnframes fit against Estimator.train in bf16 (mixed_bfloat16)
NN_BF16_BOUND = 2e-2


def scale_pixels(a):
    """The flagship's input normalisation as a preprocessing stage."""
    return (a - 127.5) / 127.5


def step_traces():
    """The seconds of each training step that starts before ``close()``,
    read from the Estimator's own ``train/step`` traces with
    ``ZOO_TPU_TRACE_SYNC=1`` (a card sync closes each step, so a span is
    the step's time on the host clock, the host not running ahead); for
    the Estimator that ``fit`` makes itself."""
    from analytics_zoo_tpu_torch.common import tracing
    store = tracing.get_store()
    mark = store.latest_seq()
    prev = os.environ.get("ZOO_TPU_TRACE_SYNC")
    os.environ["ZOO_TPU_TRACE_SYNC"] = "1"

    def close():
        if prev is None:
            os.environ.pop("ZOO_TPU_TRACE_SYNC", None)
        else:
            os.environ["ZOO_TPU_TRACE_SYNC"] = prev
        _, recs = store.records_since(mark)
        return [r.dur_s for r in recs if r.name == "train/step"]

    return close


def nn_step_rates(step_s, batch, flop_per_image=None, dtype="bfloat16"):
    """The median step's images/s and, given the model's FLOPs per
    image, its MFU against ``dtype``'s peak; the first step (the builds
    and the FLOP count) left out."""
    med = statistics.median(step_s[1:])
    rate = batch / med
    out = {"step_s": step_s, "median_step_ms": med * 1e3,
           "images_per_s": rate}
    if flop_per_image is not None:
        out["mfu"] = rate * flop_per_image / PEAK_FLOPS[dtype]
    return out


def nnframes_resnet(card, rec):
    """Phase 20, part 1: ``NNClassifier.fit`` of bench.py's flagship from
    rows of uint8 images normalised by a preprocessing chain, then
    ``NNClassifierModel.transform``; the launches, the step rate and MFU,
    the prediction column against ``Estimator.predict`` and the trained
    weights against ``Estimator.train`` of the same initial weights over
    the same arrays. Returns the fit's and the transform's launches."""
    import torch

    import pandas as pd

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.feature.common import (ArrayToTensor,
                                                        FnPreprocessing)
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import tree_leaves
    from analytics_zoo_tpu_torch.pipeline.estimator import (Estimator,
                                                            _leaf_paths)
    from analytics_zoo_tpu_torch.pipeline.nnframes import NNClassifier
    zoo.init_nncontext(seed=0)
    rs = np.random.RandomState(20)
    images = rs.randint(0, 256, (NN_ROWS, *IMAGE)).astype(np.uint8)
    labels = rs.randint(0, 1000, NN_ROWS)
    df = pd.DataFrame({"features": list(images), "label": labels})
    print(f"  pandas {pd.__version__}: {NN_ROWS} rows in a DataFrame",
          flush=True)
    pre = ArrayToTensor(IMAGE) >> FnPreprocessing(scale_pixels)
    net = flagship_model()
    net.init_params()
    compile_flagship(net)
    w0 = params_to_numpy(net)
    clf = (NNClassifier(net, "softmax_cross_entropy", pre)
           .set_batch_size(TRAIN_BATCH).set_max_epoch(NN_EPOCHS)
           .set_optim_method(SGD(lr=0.1, momentum=0.9)))
    t = time.perf_counter()
    fs = clf._df_to_feature_set(df)
    host_ms = (time.perf_counter() - t) * 1e3
    check(fs.num_samples == NN_ROWS, f"FeatureSet of {fs.num_samples} rows")
    del fs
    os.environ["ZOO_TPU_DTYPE_POLICY"] = "mixed_bfloat16"
    try:
        torch.cuda.synchronize()
        reset_launches()
        close = step_traces()
        t = time.perf_counter()
        try:
            model = clf.fit(df)
        finally:
            step_s = close()
        fit_wall = time.perf_counter() - t
        fit_launches = all_launches()
        residual = dict(cb.residual_launches)
    finally:
        os.environ.pop("ZOO_TPU_DTYPE_POLICY", None)
    steps = model.estimator.step
    check(steps == NN_EPOCHS * NN_ROWS // TRAIN_BATCH and
          len(step_s) == steps, f"fit: {steps} steps, {len(step_s)} timed")
    check(model.estimator.dtype_policy == "mixed_bfloat16",
          f"fit's policy {model.estimator.dtype_policy}")
    check_train_launches(fit_launches, steps, "nnframes fit")
    check(residual == {"matmul_bn": 8 * steps, "matmul_bn_dx": 8 * steps},
          f"nnframes fit: in_residual/dr launches {residual}")
    rates = nn_step_rates(step_s, TRAIN_BATCH, TRAIN_FLOP_PER_IMAGE)
    print(f"  rows to FeatureSet {host_ms:.1f} ms on the host ({NN_ROWS} "
          f"rows of {IMAGE} uint8 through ArrayToTensor >> scale); fit "
          f"{steps} steps in {fit_wall:.2f} s: median step "
          f"{rates['median_step_ms']:.2f} ms (host clock, a card sync "
          f"per step), {rates['images_per_s']:.1f} images/s, model-FLOPs MFU "
          f"{rates['mfu']:.4f} (against 989 TFLOP/s); steps (s) "
          f"{[round(s, 4) for s in step_s]}; launches per step B1 "
          f"{fit_launches['matmul_bn'] / steps:g} "
          f"({residual['matmul_bn'] / steps:g} in_residual), B2 "
          f"{fit_launches['conv3x3_bn'] / steps:g}, B3 "
          f"{fit_launches['matmul_bn_dx'] / steps:g} "
          f"({residual['matmul_bn_dx'] / steps:g} dr), B4 "
          f"{fit_launches['matmul_bn_dw'] / steps:g} on {card}", flush=True)

    # transform: B5/B6 per forward, 4 forwards at batch 128
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    out = model.transform(df)
    pred = out["prediction"].to_numpy()
    torch.cuda.synchronize()
    tr_wall = time.perf_counter() - t
    tr_launches = all_launches()
    check(list(out.columns) == ["features", "label", "prediction"],
          f"transform columns {list(out.columns)}")
    fwd = -(-NN_ROWS // TRAIN_BATCH)
    want = {k: 0 for k in tr_launches}
    want.update({"matmul_bn_apply": 36 * fwd, "conv3x3_bn_apply": 16 * fwd})
    check(tr_launches == want, f"transform launches {tr_launches}, "
          f"expected {want}")
    print(f"  transform of {NN_ROWS} rows at batch {TRAIN_BATCH}: "
          f"{tr_wall:.2f} s, {NN_ROWS / tr_wall:.1f} images/s (host clock, "
          f"the preprocessing included); launches per forward B5 "
          f"{tr_launches['matmul_bn_apply'] / fwd:g}, B6 "
          f"{tr_launches['conv3x3_bn_apply'] / fwd:g}", flush=True)

    # the same weights through Estimator.predict on the stacked arrays
    x = scale_pixels(images.astype(np.float32))
    trained = params_to_numpy(model.params)
    net.load_params(trained)
    os.environ["ZOO_TPU_DTYPE_POLICY"] = "mixed_bfloat16"
    try:
        plain = Estimator(net, optimizer=SGD(lr=0.1, momentum=0.9),
                          loss="softmax_cross_entropy")
    finally:
        os.environ.pop("ZOO_TPU_DTYPE_POLICY", None)
    want_pred = np.argmax(plain.predict(x, batch_size=TRAIN_BATCH), -1)
    check(np.array_equal(pred, want_pred.astype(np.float64)),
          f"prediction column differs from Estimator.predict's argmax in "
          f"{int((pred != want_pred).sum())} rows")
    # Estimator.train of the same initial weights over the same arrays
    net.load_params(w0)
    plain.opt_state = None
    plain.train(x, labels.reshape(-1, 1).astype(np.float32),
                batch_size=TRAIN_BATCH, nb_epoch=NN_EPOCHS)
    got = params_to_numpy(net)
    worst, where = 0.0, None
    for path, a, b in zip(_leaf_paths(trained), tree_leaves(trained),
                          tree_leaves(got)):
        err = float(np.abs(a.astype(np.float64) - b).max()) / max(
            1.0, float(np.abs(b).max()))
        if err > worst:
            worst, where = err, "/".join(path)
    diff = (f"largest difference {worst:.3e} of max(1, max|w|) at {where}"
            if where else "bit for bit")
    print(f"  fit against Estimator.train from the same weights over the "
          f"same arrays: {diff} (bound {NN_BF16_BOUND}); the prediction "
          f"column is Estimator.predict's argmax in all {NN_ROWS} rows",
          flush=True)
    check(worst <= NN_BF16_BOUND, f"fit differs from Estimator.train by "
          f"{worst} at {where}")
    rec["resnet"] = {"host_ms_rows_to_feature_set": host_ms,
                     "fit_wall_s": fit_wall, "transform_wall_s": tr_wall,
                     "transform_images_per_s": NN_ROWS / tr_wall,
                     "fit_vs_train_max_rel": worst, **rates,
                     "launches_fit": {k: v for k, v in fit_launches.items()
                                      if v},
                     "launches_transform": {k: v for k, v in
                                            tr_launches.items() if v}}
    del net, model, plain, x, images, df, out
    torch.cuda.empty_cache()
    return fit_launches, tr_launches


def nnframes_dogs(card, rec):
    """Phase 20, part 2: the dogs-vs-cats app at BASELINE's
    configuration: Inception-v1 at 224 with 2 classes and every layer but
    the head frozen, through ``NNClassifier`` on seeded synthetic images
    kept as arrays (``--in-memory``): the frozen layers' weights bit for
    bit, the fit's and the transform's images/s."""
    import torch

    from analytics_zoo_tpu_torch.apps import dogs_vs_cats
    torch.cuda.synchronize()
    close = step_traces()
    try:
        r = dogs_vs_cats.main(
            ["--in-memory", "--arch", "inception-v1", "--image-size",
             str(IMAGE[0]), "--per-class", str(DOGS_PER_CLASS),
             "--batch-size", str(DOGS_BATCH), "--epochs", str(DOGS_EPOCHS)])
    finally:
        step_s = close()
    n = r["images"]
    rates = nn_step_rates(step_s, DOGS_BATCH)
    print(f"  dogs-vs-cats, Inception-v1 at {IMAGE[0]}: fit "
          f"{DOGS_EPOCHS} epochs of {n} images, "
          f"{DOGS_EPOCHS * n / r['fit_s']:.1f} images/s on the host clock "
          f"(the rows' preprocessing and the first step's builds included), "
          f"median step {rates['median_step_ms']:.2f} ms, "
          f"{rates['images_per_s']:.1f} images/s (host clock, a card sync "
          f"per step); "
          f"transform {n / r['transform_s']:.1f} images/s; frozen weights "
          f"unchanged bit for bit: {r['frozen_unchanged']}; train accuracy "
          f"{r['accuracy']:.3f} on {card}", flush=True)
    check(r["frozen_unchanged"], "a frozen layer's weights moved")
    check(len(step_s) == DOGS_EPOCHS * (n // DOGS_BATCH) and
          0.0 <= r["accuracy"] <= 1.0, f"dogs-vs-cats: {len(step_s)} steps, "
          f"accuracy {r['accuracy']}")
    rec["dogs"] = {"fit_images_per_s_host": DOGS_EPOCHS * n / r["fit_s"],
                   "transform_images_per_s": n / r["transform_s"],
                   **{k: v for k, v in r.items()}, **rates}
    torch.cuda.empty_cache()


# the apps and examples of phase 20, part 3: (kind, name, arguments)
NN_RUNS = [
    ("apps", "dogs_vs_cats", []),
    ("examples", "nnframes_classification", []),
    ("apps", "recommendation_ncf", []),
    ("apps", "recommendation_wide_n_deep", []),
    ("examples", "transformer_sentiment", []),
    ("examples", "autograd_custom", []),
    ("examples", "vae_mnist", []),
    ("examples", "bert_finetune", ["--hidden", "768", "--blocks", "12",
                                   "--seq-len", "128", "--epochs", "1"]),
]


def _result_line(r):
    if isinstance(r, dict):
        return {k: (round(float(v), 4) if np.ndim(v) == 0 and
                    isinstance(v, (int, float, np.floating)) else
                    f"<{type(v).__name__} {np.shape(v)}>"
                    if isinstance(v, np.ndarray) else
                    f"<{len(v)} items>" if isinstance(v, list) else v)
                for k, v in r.items()}
    return r


NN_CHECKS = {
    "dogs_vs_cats": lambda r: r["frozen_unchanged"] and
    0.0 <= r["accuracy"] <= 1.0,
    "nnframes_classification": lambda r: 0.0 <= r <= 1.0,
    "recommendation_ncf": lambda r: bool(
        np.isfinite(r["loss"]) and r["recommend_for_user"] and
        r["recommend_for_item"]),
    "recommendation_wide_n_deep": lambda r: bool(np.isfinite(r["loss"])),
    "transformer_sentiment": lambda r: bool(np.isfinite(r["loss"])),
    "autograd_custom": lambda r: r["mae"] < 0.2,
    "vae_mnist": lambda r: bool(np.isfinite(r["loss"]) and
                                r["samples"].shape == (4, 784)),
    "bert_finetune": lambda r: bool(np.isfinite(r["loss"]) and
                                    0 <= r["accuracy"] <= 1),
}


def nnframes_apps(card, rec):
    """Phase 20, part 3: the apps and examples of the slice at their
    defaults on the card (``bert_finetune`` at BERT-base widths), each
    with its result and wall time, each held to its check
    (:data:`NN_CHECKS`, the CPU tests' assertions). The dogs-vs-cats
    app's default writes and decodes a synthetic PNG folder (Pillow)."""
    import importlib

    import torch
    out = {}
    for kind, name, argv in NN_RUNS:
        mod = importlib.import_module(
            f"analytics_zoo_tpu_torch.{kind}.{name}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        line = _result_line(r)
        print(f"  {kind}/{name} {' '.join(argv)}: {line} in {wall:.2f} s",
              flush=True)
        check(NN_CHECKS[name](r), f"{name}: result {line}")
        out[name] = {"result": line, "wall_s": wall}
        torch.cuda.empty_cache()
    rec["apps"] = out


def nnframes_path(card, detail):
    """Phase 20: nnframes on the card (:func:`nnframes_resnet`,
    :func:`nnframes_dogs`, :func:`nnframes_apps`). Returns B1-B4's
    launches over the fit and B5/B6's over the transform."""
    import torch
    t0 = time.perf_counter()
    rec = {"seconds_by_part": {}}
    t = time.perf_counter()
    fit_launches, tr_launches = nnframes_resnet(card, rec)
    rec["seconds_by_part"]["resnet"] = time.perf_counter() - t
    t = time.perf_counter()
    nnframes_dogs(card, rec)
    rec["seconds_by_part"]["dogs"] = time.perf_counter() - t
    t = time.perf_counter()
    nnframes_apps(card, rec)
    rec["seconds_by_part"]["apps"] = time.perf_counter() - t
    rec["seconds"] = time.perf_counter() - t0
    print(f"  phase 20 seconds by part: "
          f"{ {k: round(v, 1) for k, v in rec['seconds_by_part'].items()} };"
          f" in {rec['seconds']:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes on {card}", flush=True)
    detail["nnframes"] = rec
    launches = {k: v for k, v in fit_launches.items() if v}
    launches.update({k: v for k, v in tr_launches.items() if v})
    return launches


# -- the serving fleet (phase 21) ---------------------------------------------

# the in-process fleet: two ResNet-50 replicas on the one card (the
# reference's ReplicaPool(replicas=[...]); replica_device_slices seats
# one replica per card), bench_serving's batcher settings, 64 requests
# of 1-4 images from 8 clients
FLEET_CLIENTS, FLEET_REQUESTS, FLEET_KILL_REQUESTS = 8, 64, 16
# the worker-process fleet's two waves (two JSON hops per request)
FLEET_PROC_REQUESTS = 8
FLEET_BATCHER = dict(max_batch_size=BATCH, max_wait_ms=5, queue_depth=512)
# the serving bound of a bf16 row against a forward at another bucket
FLEET_TOL = 5e-2
# the rollout: bake time on the injected clock, the canary's error burst
FLEET_BAKE_S, FLEET_BURST = 30.0, 3
# disaggregated generation: 8 greedy requests of 1024-1700-token prompts
# and 64 new tokens on GPT-1 at T 2048, one prefill and two decode pools
DISAGG_REQUESTS, DISAGG_NEW, DISAGG_PREFILL, DISAGG_DECODE = 8, 64, 1, 2
FLEET_WORKER_S = 300    # a worker process's start-up limit


def fleet_resnet(seed, device=DEV):
    """ResNet-50 as the fleet serves it, the same in every process:
    ``ImageClassifier("resnet-50", fused=True)`` at 224x224 and 1000
    classes, initialised from ``torch.Generator().manual_seed(seed)``,
    with distinctive BatchNorm statistics and affine params drawn from
    seed + 1 (:func:`distinct_bn`)."""
    import torch

    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier

    net = ImageClassifier("resnet-50", input_shape=IMAGE, classes=1000,
                          fused=True).model
    net.init_params(torch.Generator().manual_seed(seed), device=device)
    return distinct_bn(net, seed + 1)


def fleet_example():
    """The declared bf16 example (8 images): every replica serves bf16."""
    import torch
    x8 = np.random.RandomState(12).rand(8, *IMAGE).astype(np.float32)
    return torch.from_numpy(x8).to(DEV, torch.bfloat16)


def fleet_gpt(role="both"):
    """The generation model of phase 8 (GPT-1 widths, T 2048, seeded
    weights, the embedding scaled by GEN_EMBED_SCALE) behind an
    ``InferenceModel`` of ``role``: 8 slots of 16-token pages, an f32
    pool, whole-prompt prefill."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    net = gpt_net()
    params = net.build(torch.Generator().manual_seed(0), (GEN_T,))
    params["tok_embed"] = params["tok_embed"] * GEN_EMBED_SCALE
    im = InferenceModel().load_generator(
        net, params, max_slots=GEN_SLOTS, max_context=GEN_T,
        page_size=GEN_PAGE, prefill_chunk=0, role=role)
    return net, im


def fleet_worker(kind) -> int:
    """``chip_smoke.py --fleet-worker {resnet,prefill,decode}``: one
    replica process on the card, on the libraries phase 2 built. Serves
    the fleet's ResNet-50 (bf16, a DynamicBatcher of FLEET_BATCHER) or a
    GPT-1 pool engine of that role behind ``InferenceServer`` on a free
    port, prints ``{"port": N}`` and serves until its parent goes."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.pipeline.inference import (
        DynamicBatcher, InferenceModel, InferenceServer)
    parent = os.getppid()
    zoo.init_nncontext(seed=0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if kind == "resnet":
        im = InferenceModel().load_keras_net(
            fleet_resnet(0), example_inputs=[fleet_example()])
        srv = InferenceServer(im, port=0, batcher=DynamicBatcher(
            im, **FLEET_BATCHER), gen_batcher=None)
    elif kind in ("prefill", "decode"):
        _, im = fleet_gpt(kind)
        srv = InferenceServer(im, port=0, batcher=None)
    else:
        print(f"chip_smoke: unknown fleet worker {kind!r}", file=sys.stderr)
        return 2
    srv.start()
    print(json.dumps({"port": srv.port}), flush=True)
    while os.getppid() == parent:
        time.sleep(0.5)
    os._exit(0)


def fleet_worker_argv(kind):
    return [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
            "--fleet-worker", kind]


class FleetWorkers:
    """The phase's replica processes: started together, each one's port
    read from its first line; :meth:`kill` SIGKILLs one, :meth:`close`
    every one still running, and reaps them all."""

    def __init__(self, kinds):
        log_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(log_dir, exist_ok=True)
        self.procs, self.logs, self.ports = [], [], []
        for i, kind in enumerate(kinds):
            log = open(os.path.join(log_dir, f"fleet_worker_{i}_{kind}.log"),
                       "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                fleet_worker_argv(kind), stdout=subprocess.PIPE,
                stderr=log, text=True, cwd=ROOT))
        self.kinds = list(kinds)

    def wait_ports(self):
        with concurrent.futures.ThreadPoolExecutor(len(self.procs)) as pool:
            lines = [pool.submit(p.stdout.readline) for p in self.procs]
            for kind, fut in zip(self.kinds, lines):
                line = fut.result(timeout=FLEET_WORKER_S)
                check(bool(line), f"fleet worker {kind} exited before it "
                      "served (its log is in chiprun_out)")
                self.ports.append(json.loads(line)["port"])
        return self.ports

    def url(self, i):
        return f"http://127.0.0.1:{self.ports[i]}"

    def kill(self, i):
        import signal
        self.procs[i].send_signal(signal.SIGKILL)
        self.procs[i].wait(timeout=30)

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        for f in self.logs:
            f.close()


def fleet_bodies(rs, n):
    """``n`` /predict bodies of 1-4 images (3 decimals, as a client sends
    them) and their float32 images."""
    sizes = rs.randint(1, 5, size=n)
    images = [np.round(rs.rand(int(k), *IMAGE), 3) for k in sizes]
    bodies = [json.dumps({"inputs": x.tolist()}).encode() for x in images]
    return bodies, [x.astype(np.float32) for x in images]


def fleet_wave(port, bodies, clients=FLEET_CLIENTS, headers=None,
               during=None):
    """Post ``bodies`` to ``/predict`` from ``clients`` threads; returns
    each reply ``(status, headers, body, seconds)``. ``during(i)`` runs
    after reply ``i`` arrives (a fault armed mid-wave)."""
    replies = [None] * len(bodies)

    def client(c):
        for i in range(c, len(bodies), clients):
            replies[i] = post_json(port, "/predict", bodies[i],
                                   headers(i) if headers else None)
            if during is not None:
                during(i)

    with concurrent.futures.ThreadPoolExecutor(clients) as pool:
        for f in [pool.submit(client, c) for c in range(clients)]:
            f.result()
    return replies


def fleet_held(what, images, replies, runs, models):
    """Each reply held against the bucket execution that served it, bit
    for bit (``runs``: (replica, rows, n, bucket, outputs) of every
    execution), each execution against its replica's ``predict`` of the
    same padded bucket, bit for bit, and each reply within FLEET_TOL of
    max(1, max|logit|) of the request predicted alone. Returns the
    worst error over its bound and the executions per replica."""
    codes = [r[0] for r in replies]
    check(codes == [200] * len(replies), f"{what}: statuses {codes}")
    for name, xs, n, bucket, out in runs:
        padded = np.concatenate(
            [xs, np.zeros((bucket - n,) + xs.shape[1:], xs.dtype)])
        check(np.array_equal(models[name].predict(padded)[:n], out),
              f"{what}: {name}'s bucket of {bucket} ({n} rows) differs from "
              "predict of the same padded bucket")
    where = {}
    for name, xs, n, _, out in runs:
        for r in range(n):
            where.setdefault(xs[r].ravel()[:64].tobytes(), []).append(
                (xs, out, r))
    any_model = next(iter(models.values()))
    worst = 0.0
    for i, (x, reply) in enumerate(zip(images, replies)):
        got = np.asarray(reply[2]["outputs"], np.float32)
        hits = [(out, r) for xs, out, r in
                where.get(x[0].ravel()[:64].tobytes(), [])
                if np.array_equal(xs[r:r + len(x)], x)]
        check(len(hits) >= 1, f"{what}: request {i} found in no bucket "
              "execution")
        check(any(np.array_equal(got, out[r:r + len(x)]) for out, r in hits),
              f"{what}: request {i}'s reply is not its bucket's rows")
        alone = any_model.predict(x)
        err = float(np.abs(got - alone).max())
        tol = FLEET_TOL * max(1.0, float(np.abs(alone).max()))
        check(err <= tol, f"{what}: request {i} {err} from predict alone "
              f"(tol {tol})")
        worst = max(worst, err / tol)
    per = collections.Counter(name for name, *_ in runs)
    return worst, dict(per)


def fleet_recording(name, runs):
    """A replica's ``DynamicBatcher`` (FLEET_BATCHER, labelled by
    replica) that appends each bucket execution to ``runs``."""
    from analytics_zoo_tpu_torch.pipeline.inference import DynamicBatcher

    class Recording(DynamicBatcher):
        def _pad_and_run(self, sig, xs, n):
            outs, multi = super()._pad_and_run(sig, xs, n)
            bucket = next(b for b in self.buckets if b >= n)
            runs.append((name, xs[0], n, bucket, outs[0]))
            return outs, multi
    return Recording


def fleet_launches_held(what, launches, execs, forwards=0):
    """B5/B6 launched 36/16 per bucket execution (and per direct
    forward), nothing else."""
    n = execs + forwards
    for kname in KERNELS:
        want = {"matmul_bn_apply": 36 * n, "conv3x3_bn_apply": 16 * n
                }.get(kname, 0)
        check(launches.get(kname, 0) == want, f"{what}: {kname} launched "
              f"{launches.get(kname, 0)} times in {execs} bucket executions "
              f"and {forwards} forwards, expected {want}")


def fleet_inprocess(card, rec, clock, workers):
    """Phase 21, part a: two in-process ResNet-50 replicas behind
    ``make_fleet_server``: the main wave held bit for bit, hash affinity,
    a replica killed mid-wave and re-admitted by one tick, saturation's
    503, the router's dispatch cost, and the same load on one
    ``InferenceServer`` over the same model. Returns the router, its
    server, the replicas' models and the launches of the held waves."""
    import torch

    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.parallel import place_inference_params
    from analytics_zoo_tpu_torch.pipeline.inference import (
        FleetRouter, InferenceModel, InferenceServer, Replica, ReplicaPool,
        make_fleet_server)
    import copy
    x8 = fleet_example()
    template = fleet_resnet(0)
    runs, models, nets, replicas = [], {}, {}, []
    for name in ("r0", "r1"):
        # each replica its own copy of the net and of every tensor
        net = copy.deepcopy(template)
        net.load_params(place_inference_params(template.params(), [DEV]))
        im = InferenceModel().load_keras_net(net, example_inputs=[x8])
        models[name], nets[name] = im, net
        r = Replica(name, im, clock=clock, batcher=fleet_recording(
            name, runs)(im, labels={"replica": name}, **FLEET_BATCHER))
        r.version = "v1"
        replicas.append(r)
    shared = {t.data_ptr() for t in nets["r0"].parameters()} & \
        {t.data_ptr() for t in nets["r1"].parameters()}
    check(not shared, f"the replicas share {len(shared)} tensors")
    router = FleetRouter(ReplicaPool(replicas=replicas, clock=clock),
                         probe_interval_s=0, eject_after=1, max_retries=2)
    # the stdlib front end, which this phase measures and whose
    # Retry-After it reads (the native one sends none)
    srv = make_fleet_server(router, prefer_native=False)
    t0 = time.perf_counter()
    srv.start()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    health = get_json(srv.port, "/health")["batcher"]
    check(health["fleet"] and health["replicas_admitting"] == 2 and all(
        p["warmed_buckets"] == 6 for p in health["per_replica"].values()),
        f"fleet /health after warm-up {health}")
    # the worker processes started with the phase: no timed wave runs
    # while they are still starting on the host's cores
    t0 = time.perf_counter()
    workers.wait_ports()
    rec["worker_wait_s"] = time.perf_counter() - t0
    rs = np.random.RandomState(21)

    # the main wave
    bodies, images = fleet_bodies(rs, FLEET_REQUESTS)
    obs.reset_metrics()
    reset_launches()
    del runs[:]
    t0 = time.perf_counter()
    replies = fleet_wave(srv.port, bodies)
    window = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(all_launches())
    main_runs = list(runs)
    fleet_launches_held("fleet main wave", launches, len(main_runs))
    worst, per = fleet_held("fleet main wave", images, replies, main_runs,
                            models)
    check(len(per) == 2, f"the main wave ran on {per} only")
    # one replica's bucket against the other's predict, bit for bit
    name, xs, n, bucket, out = main_runs[0]
    other = "r1" if name == "r0" else "r0"
    padded = np.concatenate(
        [xs, np.zeros((bucket - n,) + xs.shape[1:], xs.dtype)])
    cross = bool(np.array_equal(models[other].predict(padded)[:n], out))
    check(cross, f"{name}'s bucket differs from {other}'s predict")
    lat = [r[3] for r in replies]
    rows = sum(len(x) for x in images)
    rec["main_wave"] = {
        "requests": FLEET_REQUESTS, "images": rows, "window_s": window,
        "p50_ms": percentile_ms(lat, 50), "p99_ms": percentile_ms(lat, 99),
        "bucket_executions": per, "worst_err_over_tol": worst,
        "bit_exact": "each reply equals its bucket's rows and each bucket "
                     "its replica's predict at that bucket (and the other "
                     "replica's); across buckets within the bound",
        "warm_s": warm_s}
    print(f"  fleet main wave: {FLEET_REQUESTS} requests ({rows} images) "
          f"from {FLEET_CLIENTS} clients in {window:.3f} s, request p50 "
          f"{rec['main_wave']['p50_ms']:.1f} p99 "
          f"{rec['main_wave']['p99_ms']:.1f} ms, bucket executions {per}; "
          f"replies bit for bit their buckets' rows, buckets bit for bit "
          f"predict at the same bucket (r0 against r1 too), worst "
          f"{worst:.3f} of the bound against predict alone; two replicas "
          f"sharing one card, {card}", flush=True)

    # the router's host cost of one dispatch: submit() alone, 21 times
    x1 = images[0][:1]
    dispatch = []
    for _ in range(21):
        t0 = time.perf_counter()
        fut = router.submit([x1])
        dispatch.append(time.perf_counter() - t0)
        fut.result(60)
    rec["dispatch_ms_median_of_21"] = statistics.median(dispatch) * 1e3
    print(f"  router host ms per dispatch (submit, median of 21): "
          f"{rec['dispatch_ms_median_of_21']:.3f} on {card}", flush=True)

    # hash affinity: one payload, one replica; payloads spread
    hrouter = FleetRouter(router.pool, policy="hash", probe_interval_s=0)
    before = {r.name: r.dispatches_total for r in router.pool.replicas}
    for _ in range(8):
        hrouter.submit([images[1]]).result(60)
    moved = {r.name: r.dispatches_total - before[r.name]
             for r in router.pool.replicas}
    home = hrouter._pick(len(images[1]), hrouter._affinity_key(
        [images[1]]), set()).name
    homes = {hrouter._pick(1, hrouter._affinity_key([x[:1]]), set()).name
             for x in images}
    check(moved[home] == 8 and sum(moved.values()) == 8 and len(homes) == 2,
          f"hash: dispatches {moved}, home {home}, homes {homes}")
    print(f"  hash policy: 8 requests of one payload all on {home}; "
          f"{len(images)} payloads over {sorted(homes)}", flush=True)

    # r0 killed mid-wave: every request still 200 and held, r0 down
    bodies, images = fleet_bodies(rs, FLEET_KILL_REQUESTS)
    armed = threading.Event()

    def kill_after(i):
        if i >= FLEET_KILL_REQUESTS // 4 and not armed.is_set():
            armed.set()
            faults.arm("fleet/replica_predict", "kill",
                       where={"replica": "r0"})

    del runs[:]
    reset_launches()
    replies = fleet_wave(srv.port, bodies, during=kill_after)
    torch.cuda.synchronize()
    launches_kill = dict(all_launches())
    kill_runs = list(runs)
    fleet_launches_held("fleet kill wave", launches_kill, len(kill_runs))
    worst_k, per_k = fleet_held("fleet kill wave", images, replies,
                                kill_runs, models)
    fleet = get_json(srv.port, "/debug/fleet")
    states = {r["name"]: r["state"] for r in fleet["replicas"]}
    check(states == {"r0": "down", "r1": "admitting"},
          f"/debug/fleet after the kill: {states}")
    faults.disarm_all()
    r0 = router._replica("r0")
    reset_launches()
    router.tick(now=r0.next_probe_at + 0.01)
    torch.cuda.synchronize()
    probe = dict(all_launches())
    check(r0.state == "admitting", f"r0 after one tick: {r0.state}")
    fleet_launches_held("the re-admission probe", probe, 0, forwards=1)
    before = r0.dispatches_total
    for x in images[:4]:
        router.submit([x]).result(60)
    check(r0.dispatches_total > before, "r0 took no request after "
          "re-admission")
    rec["kill_wave"] = {"requests": FLEET_KILL_REQUESTS,
                        "bucket_executions": per_k,
                        "worst_err_over_tol": worst_k,
                        "retries": plane_value(
                            obs.snapshot(),
                            "zoo_tpu_fleet_retries_total") or 0,
                        "r0_failed_dispatches": plane_value(
                            obs.snapshot(),
                            "zoo_tpu_fleet_replica_errors_total",
                            replica="r0") or 0,
                        "states_after": states}
    print(f"  r0 killed after {FLEET_KILL_REQUESTS // 4} of "
          f"{FLEET_KILL_REQUESTS} requests: all 200 and held (worst "
          f"{worst_k:.3f} of the bound), executions {per_k}, "
          f"{rec['kill_wave']['r0_failed_dispatches']:g} dispatches to r0 "
          f"failed over to r1 and {rec['kill_wave']['retries']:g} retried "
          f"after a failed execution, /debug/fleet "
          f"{states}; healed, one tick re-admitted r0 (its probe one "
          f"batch-8 forward), and r0 serves again", flush=True)

    # saturation: both queues of depth 1 full behind wedged dispatchers.
    # One request at a time: each dispatcher takes one (and wedges in
    # it), then each queue holds one; the next request finds both full
    for r in router.pool.replicas:
        r.batcher.queue_depth = 1
    faults.arm("batcher/dispatch", "wedge", seconds=60.0)
    one = json.dumps({"inputs": images[0][:1].tolist()}).encode()
    pool = concurrent.futures.ThreadPoolExecutor(4)
    held = []

    def settle(cond):
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not cond():
            time.sleep(0.002)
        check(cond(), "saturation: the queues did not reach their state")

    try:
        for n_taken in (1, 2):
            held.append(pool.submit(post_json, srv.port, "/predict", one))
            settle(lambda n=n_taken: sum(
                r.outstanding_rows == 1 and not r.batcher._q
                for r in router.pool.replicas) == n)
        for n_queued in (1, 2):
            held.append(pool.submit(post_json, srv.port, "/predict", one))
            settle(lambda n=n_queued: sum(
                len(r.batcher._q) == 1
                for r in router.pool.replicas) == n)
        hints = [r.retry_hint_s() for r in router.pool.replicas]
        code, hdrs, body, _ = post_json(srv.port, "/predict", one)
    finally:
        faults.disarm_all()
        for r in router.pool.replicas:
            r.batcher.queue_depth = FLEET_BATCHER["queue_depth"]
    codes = sorted(f.result(60)[0] for f in held)
    pool.shutdown()
    got = body.get("error", {}).get("retry_after_s")
    check(code == 503 and hdrs.get("Retry-After") is not None and
          got == round(min(hints), 3) and codes == [200] * 4,
          f"saturation: {code} {body}, Retry-After "
          f"{hdrs.get('Retry-After')}, hints {hints}, held {codes}")
    rec["saturation"] = {"status": code, "retry_after_s": got,
                         "replica_hints": hints,
                         "retry_after_header": hdrs.get("Retry-After")}
    print(f"  both queues full: 503, Retry-After {hdrs.get('Retry-After')}, "
          f"retry_after_s {got} = min of the replicas' hints {hints}; the "
          "held requests then 200", flush=True)

    # the same load on one InferenceServer over the same model
    bodies, images = fleet_bodies(np.random.RandomState(21), FLEET_REQUESTS)
    single_im = InferenceModel().load_keras_net(template,
                                                example_inputs=[x8])
    single = InferenceServer(single_im, port=0, batcher=fleet_recording(
        "single", [])(single_im, **FLEET_BATCHER), gen_batcher=None)
    single.start()
    try:
        replies = fleet_wave(single.port, bodies)
    finally:
        single.stop()
    codes = [r[0] for r in replies]
    check(codes == [200] * FLEET_REQUESTS, f"single server: {codes}")
    lat = [r[3] for r in replies]
    rec["single_server"] = {"p50_ms": percentile_ms(lat, 50),
                            "p99_ms": percentile_ms(lat, 99)}
    print(f"  the same {FLEET_REQUESTS} requests on one InferenceServer "
          f"over the same model: p50 {rec['single_server']['p50_ms']:.1f} "
          f"p99 {rec['single_server']['p99_ms']:.1f} ms, against the fleet's "
          f"{rec['main_wave']['p50_ms']:.1f} / "
          f"{rec['main_wave']['p99_ms']:.1f} ms (two replicas sharing one "
          f"card, no second card's capacity), {card}", flush=True)
    del single_im
    total = collections.Counter(launches)
    total.update(launches_kill)
    return router, srv, models, nets, template, dict(total)


def fleet_rollout(card, rec, router, srv, models, nets, template, clock):
    """Phase 21, part b: v1 (seed 0, served) and v2 (seed 1) as loader
    versions of an in-memory ``ModelRegistry``; ``rollout(v2,
    canary_pct=50)`` under a continuous load loop rolls back on an error
    burst injected on the canary, a clean re-roll promotes after the
    bake (the router's clock advanced, one tick), the loop sees no
    failure, and every replica then serves v2's logits bit for bit."""
    import torch

    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.parallel import place_inference_params
    from analytics_zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                            ModelRegistry)
    x8 = fleet_example()
    trees = {"v1": params_to_numpy(template), "v2": params_to_numpy(
        fleet_resnet(1))}

    net_of = {id(models[name]): net for name, net in nets.items()}

    def loader(version):
        def load(model):
            model.load_keras_net(net_of[id(model)],
                                 params=place_inference_params(
                                     trees[version], [DEV]),
                                 example_inputs=[x8])
        return load

    reg = ModelRegistry(root=None)
    reg.register("resnet-50", "v1", loader=loader("v1"))
    v2 = reg.register("resnet-50", "v2", loader=loader("v2"))
    router.eject_after = FLEET_BURST  # the burst, not one error, ejects
    stop, failures, served = threading.Event(), [], [0]
    one = json.dumps({"inputs": np.round(np.random.RandomState(3).rand(
        2, *IMAGE), 3).tolist()}).encode()

    def load_loop():
        while not stop.is_set():
            code, _, body, _ = post_json(srv.port, "/predict", one)
            out = np.asarray(body.get("outputs", []), np.float32)
            if code != 200 or out.shape != (2, 1000) or \
                    not np.isfinite(out).all():
                failures.append((code, body.get("error")))
            served[0] += 1

    def wait_served(n):
        target = served[0] + n
        deadline = time.monotonic() + 120
        while served[0] < target and time.monotonic() < deadline:
            time.sleep(0.01)

    loop = [threading.Thread(target=load_loop) for _ in range(2)]
    for t in loop:
        t.start()
    endings = []
    t0 = time.perf_counter()
    try:
        wait_served(4)
        ctl = router.rollout(v2, canary_pct=50, bake_s=FLEET_BAKE_S,
                             max_canary_errors=FLEET_BURST)
        check(ctl.state == "canary", f"rollout began in {ctl.state}")
        canary = ctl.canary_replicas[0]
        faults.arm("fleet/replica_predict", "error",
                   where={"replica": canary})
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and plane_value(
                obs.snapshot(), "zoo_tpu_rollout_errors_total",
                version="v2") < FLEET_BURST:
            time.sleep(0.01)
        router.tick(now=clock[0])
        faults.disarm_all()
        endings.append(get_json(srv.port, "/debug/rollout"))
        check(ctl.state == "rolled_back" and "error burst" in ctl.reason,
              f"rollout after the burst: {ctl.state} {ctl.reason}")
        wait_served(4)
        ctl = router.rollout(v2, canary_pct=50, bake_s=FLEET_BAKE_S,
                             max_canary_errors=FLEET_BURST)
        wait_served(8)
        clock[0] += FLEET_BAKE_S + 1.0
        router.tick(now=clock[0])
        endings.append(get_json(srv.port, "/debug/rollout"))
        check(ctl.state == "promoted", f"the re-roll ended {ctl.state}")
        wait_served(4)
    finally:
        stop.set()
        faults.disarm_all()
        for t in loop:
            t.join(timeout=600)
    seconds = time.perf_counter() - t0
    check(not failures, f"the load loop saw {len(failures)} failures: "
          f"{failures[:3]}")
    states = [[t["state"] for t in e["transitions"]] for e in endings]
    check(states == [["rolling", "canary", "rolling_back", "rolled_back"],
                     ["rolling", "canary", "promoting", "promoted"]] and
          set(endings[1]["replica_versions"].values()) == {"v2"},
          f"/debug/rollout endings {states}, versions "
          f"{endings[1]['replica_versions']}")
    # every replica's logits against a direct v2 forward, bit for bit
    direct = InferenceModel().load_keras_net(
        fleet_resnet(1), example_inputs=[x8])
    x = np.random.RandomState(5).rand(4, *IMAGE).astype(np.float32)
    want = direct.predict(x)
    for name, im in models.items():
        check(np.array_equal(im.predict(x), want),
              f"{name} after promotion differs from a direct v2 forward")
    rec["rollout"] = {"requests_in_loop": served[0], "failures": 0,
                      "endings": [{"state": e["state"],
                                   "reason": e.get("reason"),
                                   "transitions": s}
                                  for e, s in zip(endings, states)],
                      "seconds": seconds}
    print(f"  rollout under load: {served[0]} requests, 0 failures; an "
          f"error burst on {canary} rolled v2 back ({endings[0]['reason']}),"
          f" the clean re-roll promoted after a {FLEET_BAKE_S:g} s bake on "
          f"the router's clock; /debug/rollout {states}; both replicas' "
          f"logits bit for bit a direct v2 forward; {seconds:.1f} s",
          flush=True)
    del direct
    torch.cuda.empty_cache()


def fleet_processes(card, rec, workers, template):
    """Phase 21, part c: two ResNet-50 worker processes behind a router
    front door as ``HttpReplica``s with its ``TelemetryCollector``: the
    merged acked-request counter equals the router's own plus each
    worker's ``/metrics/json`` exactly; then one worker SIGKILLed during
    a traced wave, every request still 200 and within the bound, and a
    trace stitched from the router's process and a worker's."""
    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.pipeline.inference import (
        FleetRouter, HttpReplica, InferenceModel, ReplicaPool,
        make_fleet_server)
    obs.reset_metrics()
    router = FleetRouter(ReplicaPool(replicas=[
        HttpReplica(workers.url(i), name=f"w{i}") for i in range(2)]),
        probe_interval_s=0, max_retries=2)
    # the stdlib front end, as above; its collector ticks by hand here
    srv = make_fleet_server(router, prefer_native=False)
    srv.start()
    rs = np.random.RandomState(22)
    # the workers serve v1 (seed 0): the template's weights
    any_model = InferenceModel().load_keras_net(
        template, example_inputs=[fleet_example()])

    def held(what, images, replies):
        codes = [r[0] for r in replies]
        check(codes == [200] * len(replies), f"{what}: statuses {codes}")
        worst = 0.0
        for i, (x, reply) in enumerate(zip(images, replies)):
            got = np.asarray(reply[2]["outputs"], np.float32)
            alone = any_model.predict(x)
            err = float(np.abs(got - alone).max())
            tol = FLEET_TOL * max(1.0, float(np.abs(alone).max()))
            check(err <= tol, f"{what}: request {i} {err} (tol {tol})")
            worst = max(worst, err / tol)
        return worst

    try:
        bodies, images = fleet_bodies(rs, FLEET_PROC_REQUESTS)
        t0 = time.perf_counter()
        replies = fleet_wave(srv.port, bodies)
        window = time.perf_counter() - t0
        worst = held("process fleet", images, replies)
        per = []
        for i in range(2):
            snap = get_json(workers.ports[i], "/metrics/json")["metrics"]
            per.append(plane_value(snap, "zoo_tpu_serving_requests_total",
                                   path="/predict", status="200"))
        text = urllib_text(srv.port, "/metrics?fleet=1")
        merged, _ = router.telemetry.merged_snapshot()
        fed = plane_value(merged, "zoo_tpu_serving_requests_total",
                          path="/predict", status="200")
        own = plane_value(obs.snapshot(), "zoo_tpu_serving_requests_total",
                          path="/predict", status="200")
        m = re.search(r'^zoo_tpu_serving_requests_total\{[^}]*path="/predict"'
                      r'[^}]*status="200"[^}]*\} (\S+)', text, re.M)
        n = FLEET_PROC_REQUESTS
        check(fed == own + sum(per) and own == n and sum(per) == n and
              all(per) and m is not None and float(m.group(1)) == fed,
              f"federated acked requests {fed}, router {own}, workers "
              f"{per}, text {m.group(1) if m else None}")
        lat = [r[3] for r in replies]
        # the traced wave: worker 1 SIGKILLed after a quarter
        bodies, images = fleet_bodies(rs, n)
        killed = threading.Event()

        def kill_after(i):
            if i >= n // 4 and not killed.is_set():
                killed.set()
                workers.kill(1)

        replies = fleet_wave(srv.port, bodies,
                             headers=lambda i: {"X-Zoo-Trace-Id":
                                                f"fleet-proc-{i}"},
                             during=kill_after)
        worst_k = held("process fleet kill", images, replies)
        # a request the surviving worker served: its trace stitches the
        # router's spans and w0's (w1's died with it)
        trace = {"sources": [], "spans": []}
        for i in reversed(range(n)):
            trace = get_json(srv.port, f"/debug/trace/fleet-proc-{i}")
            if "w0" in trace["sources"]:
                break
        names = {s["name"] for s in trace["spans"]}
        check("router" in trace["sources"] and "w0" in trace["sources"] and
              {"fleet/remote_predict", "serving/request"} <= names,
              f"stitched trace: sources {trace['sources']}, spans "
              f"{sorted(names)}")
        fleet = get_json(srv.port, "/debug/fleet")
        states = {r["name"]: r["state"] for r in fleet["replicas"]}
        w1_failed = plane_value(obs.snapshot(),
                                "zoo_tpu_fleet_replica_errors_total",
                                replica="w1") or 0
    finally:
        srv.stop()
    rec["processes"] = {
        "acked": {"federated": fed, "router": own, "workers": per},
        "p50_ms": percentile_ms(lat, 50), "p99_ms": percentile_ms(lat, 99),
        "window_s": window, "worst_err_over_tol": worst,
        "kill_worst_err_over_tol": worst_k, "states_after_kill": states,
        "w1_failed_dispatches": w1_failed,
        "trace_sources": trace["sources"]}
    print(f"  two worker processes: {n} requests in {window:.3f} s (p50 "
          f"{rec['processes']['p50_ms']:.1f} p99 "
          f"{rec['processes']['p99_ms']:.1f} ms), federated acked requests "
          f"{fed:g} = router {own:g} + workers {per}; worker 1 SIGKILLed "
          f"mid-wave: {n} of {n} 200 (worst {worst_k:.3f} of the bound; "
          f"{w1_failed:g} dispatches to w1 failed over), /debug/fleet "
          f"{states}, a trace stitched from "
          f"{trace['sources']}; {card}", flush=True)


def urllib_text(port, path):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read().decode()


def disagg_requests():
    """8 greedy requests: prompts of 1024-1700 tokens (B7 prefills at
    bucket 2048) from numpy seed 21, 64 new tokens each."""
    rs = np.random.RandomState(21)
    lens = rs.randint(1024, 1701, size=DISAGG_REQUESTS)
    return [rs.randint(1, GPT["vocab"], size=int(n)).tolist() for n in lens]


def disagg_serve(submit, prompts, between=None):
    """Submit the prompts through ``submit``, all at once, or with
    ``between`` given the first half, then ``between()`` once the first
    request has resolved (a fault mid-wave), then the rest. Returns each
    request's tokens or its exception, and the window's seconds."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    half = len(prompts) // 2 if between is not None else len(prompts)
    futs = [submit(p) for p in prompts[:half]]
    if between is not None:
        futs[0].exception(600)
        between()
        futs += [submit(p) for p in prompts[half:]]
    out = []
    for f in futs:
        try:
            out.append([int(t) for t in f.result(600)])
        except Exception as e:
            out.append(e)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pool_calls(plogs, dlogs):
    """How many prefill admits and decode steps the pools' engines have
    made so far."""
    return (sum(len(p.calls["admit"]) for p in plogs),
            sum(len(d.calls["step"]) for d in dlogs))


def pool_calls_held(what, launches, plogs, dlogs, nb, since=(0, 0)):
    """The pools' engines run on threads of their own, so a call's
    counter difference can hold a sibling engine's launches: the window
    is held as a whole, B7 ``nb`` per prefill admit (every prompt at
    bucket 2048) and B11 ``nb`` per decode step, nothing else."""
    admits, steps = pool_calls(plogs, dlogs)
    admits, steps = admits - since[0], steps - since[1]
    want = {k: v for k, v in (("flash_fwd", nb * admits),
                              ("flash_decode", nb * steps)) if v}
    got = {k: v for k, v in launches.items() if v}
    check(got == want, f"{what}: launched {got} in {admits} prefill "
          f"admits and {steps} decode steps, expected {want}")
    errors = [c["error"] for lg in plogs + dlogs for calls in
              lg.calls.values() for c in calls if c["error"]]
    check(not errors, f"{what}: pool engine calls raised {errors}")


def fleet_disagg(card, rec, workers):
    """Phase 21, part d: disaggregated generation on GPT-1 at T 2048.
    A colocated ``ContinuousBatcher`` over the template engine sets the
    streams; ``DisaggRouter.for_engine`` (1 prefill, 2 decode engines)
    reproduces them byte for byte, again with a decode replica poisoned
    mid-wave (no page leaked, every pool back to its total); then the
    same requests through worker processes over ``/generate/prefill``
    and ``/generate/handoff``, the prefill worker SIGKILLed mid-wave:
    every stream that completes is byte-exact and every failure a
    retryable transport error. Returns the launches (B7 per prefill, B11
    per decode step) of the in-process legs."""
    import http.client
    from concurrent.futures import Future

    import torch

    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.ops import kv_cache as kvc
    from analytics_zoo_tpu_torch.pipeline.inference import (
        ContinuousBatcher, DisaggRouter, HttpDisaggReplica, QueueFullError)
    nb = GPT["n_block"]
    net, im = fleet_gpt()
    template = im.generator
    template.warm()
    prompts = disagg_requests()
    new = DISAGG_NEW

    # colocated: the template engine behind one ContinuousBatcher
    ttft_co = []

    class Colocated(ContinuousBatcher):
        def _token_out(self, e, tok, now):
            if not e.tokens:
                ttft_co.append(now - e.t_enq)
            return super()._token_out(e, tok, now)

    log = LaunchLog(template, ("admit", "step"))
    cb = Colocated(template).start()
    reset_launches()
    try:
        colocated, co_s = disagg_serve(
            lambda p: cb.submit(p, max_new_tokens=new), prompts)
    finally:
        cb.stop()
        log.close()
    co_launch = dict(all_launches())
    calls_launch(log.calls, "admit", lambda c: {"flash_fwd": nb},
                 "colocated prefill")
    calls_launch(log.calls, "step", lambda c: {"flash_decode": nb},
                 "colocated decode")
    check(all(isinstance(s, list) and len(s) == new for s in colocated),
          f"colocated streams {[type(s).__name__ for s in colocated]}")

    # disaggregated, in process
    obs.reset_metrics()
    router = DisaggRouter.for_engine(template, n_prefill=DISAGG_PREFILL,
                                     n_decode=DISAGG_DECODE, eject_after=1)
    router.start()
    engines = [r.engine for r in router.prefill + router.decode]
    for eng in engines:
        check(eng.prefill_chunk == 0, f"{eng.role} engine chunks")
    plogs = [LaunchLog(r.engine, ("admit", "export_handoff"))
             for r in router.prefill]
    dlogs = [LaunchLog(r.engine, ("step", "admit_from_handoff"))
             for r in router.decode]
    # each prefill leg's blob size and time (the disaggregated TTFT:
    # the first token is known when the blob is), over the first wave
    blob_bytes, ttft_dis, blobs, first_wave = [], [], [], [True]
    for r in router.prefill:
        orig = r.prefill

        def prefill(ids, mx, temp, orig=orig):
            t_sub = time.perf_counter()
            f = orig(ids, mx, temp)

            def done(f, t_sub=t_sub):
                if f.exception() is None and first_wave[0]:
                    ttft_dis.append(time.perf_counter() - t_sub)
                    blob_bytes.append(kvc.handoff_nbytes(f.result()))
                    if not blobs:
                        blobs.append(f.result())
            f.add_done_callback(done)
            return f
        r.prefill = prefill
    reset_launches()
    submit = lambda p: router.submit(p, max_new_tokens=new)  # noqa: E731
    try:
        disagg, dis_s = disagg_serve(submit, prompts)
        dis_launch = dict(all_launches())
        pool_calls_held("disaggregated wave", dis_launch, plogs, dlogs, nb)
        exact = disagg == colocated
        check(exact, "disaggregated streams differ from the colocated "
              f"ones at requests {[i for i, (a, b) in enumerate(zip(disagg, colocated)) if a != b]}")
        first_wave[0] = False
        # a decode replica poisoned mid-wave: the one the router would
        # pick next (the most free pages)
        victims = []

        def dying(blob, mx, eos):
            f = Future()
            f.set_exception(ConnectionError("poisoned decode replica"))
            return f

        def poison():
            victim = max(router.decode, key=lambda r: r.free_pages())
            victim.decode = dying
            victims.append(victim.name)

        counts = pool_calls(plogs, dlogs)
        reset_launches()
        poisoned, _ = disagg_serve(submit, prompts, between=poison)
        poison_launch = dict(all_launches())
        pool_calls_held("poisoned wave", poison_launch, plogs, dlogs, nb,
                        since=counts)
        check(poisoned == colocated, "streams after the poisoned decode "
              "replica differ from the colocated ones")
        check(router.drain(), "the disaggregated fleet did not drain")
        leaked = plane_value(obs.snapshot(),
                             "zoo_tpu_serving_gen_handoff_pages_leaked") or 0
        retries = plane_value(
            obs.snapshot(), "zoo_tpu_serving_gen_handoff_retries_total") or 0
        check(retries >= 1, f"no handoff retried after {victims} was "
              "poisoned")
        for eng in engines:
            pools_full(eng, f"{eng.role} pool after the drain")
        check(leaked == 0, f"{leaked} handoff pages leaked")
        st = router.fleet_status()
        lat = {r["name"]: r for r in st["replicas"]}
        splice_ms = statistics.median(
            [c["s"] for d in dlogs for c in d.calls["admit_from_handoff"]]
        ) * 1e3
        prefills = sum(len(p.calls["admit"]) for p in plogs)
        steps = sum(len(d.calls["step"]) for d in dlogs)
    finally:
        for lg in plogs + dlogs:
            lg.close()
        router.stop()
    tokens = DISAGG_REQUESTS * new
    rec["disagg"] = {
        "exact": True, "requests": DISAGG_REQUESTS, "new_tokens": new,
        "prompt_lens": sorted(len(p) for p in prompts),
        "colocated": {"seconds": co_s, "tokens_per_s": tokens / co_s,
                      "ttft_median_ms": statistics.median(ttft_co) * 1e3},
        "disaggregated": {"seconds": dis_s, "tokens_per_s": tokens / dis_s,
                          "ttft_median_ms": statistics.median(ttft_dis)
                          * 1e3},
        "blob_bytes": [min(blob_bytes), max(blob_bytes)],
        "splice_ms_median": splice_ms, "handoff_retries": retries,
        "leaked": leaked, "poisoned": victims, "prefill_calls": prefills,
        "decode_steps": steps,
        "states_after": {k: v["state"] for k, v in lat.items()}}
    print(f"  disaggregated (1 prefill, 2 decode engines) against colocated: "
          f"{DISAGG_REQUESTS} greedy requests (prompts "
          f"{rec['disagg']['prompt_lens']}, {new} new tokens) byte for byte "
          f"equal; TTFT median {rec['disagg']['disaggregated']['ttft_median_ms']:.1f}"
          f" ms (prefill leg) against {rec['disagg']['colocated']['ttft_median_ms']:.1f}"
          f" ms, {tokens / dis_s:.1f} against {tokens / co_s:.1f} tokens/s; "
          f"blobs {min(blob_bytes)}-{max(blob_bytes)} bytes, a splice "
          f"{splice_ms:.2f} ms; a decode replica poisoned mid-wave: streams "
          f"exact, {retries:g} re-prefills, {leaked:g} pages leaked, every "
          f"pool back to its total; {card}", flush=True)
    launches = collections.Counter(co_launch)
    launches.update(dis_launch)
    launches.update(poison_launch)

    # the same over HTTP: worker processes behind the pools' routes
    hrouter = DisaggRouter(
        [HttpDisaggReplica(workers.url(2), "prefill", name="wprefill")],
        [HttpDisaggReplica(workers.url(3), "decode", name="wdecode0"),
         HttpDisaggReplica(workers.url(4), "decode", name="wdecode1")],
        eject_after=1)
    hrouter.start()
    try:
        # one wave: the first half, the prefill worker SIGKILLed once the
        # first of them has resolved, then the second half
        served, http_s = disagg_serve(
            lambda p: hrouter.submit(p, max_new_tokens=new), prompts,
            between=lambda: workers.kill(2))
    finally:
        hrouter.stop()
    ok = [i for i, s in enumerate(served) if isinstance(s, list)]
    failed = [s for s in served if not isinstance(s, list)]
    check(ok and all(served[i] == colocated[i] for i in ok),
          f"streams over HTTP: {len(ok)} completed, not all the colocated "
          "ones")
    check(all(isinstance(e, (OSError, http.client.HTTPException,
                             QueueFullError)) for e in failed),
          f"non-retryable failures {[type(e).__name__ for e in failed]}")
    # the wire codec of one blob, once (seconds of host time each)
    blob = blobs[0]
    t0 = time.perf_counter()
    kvc.handoff_from_wire(json.loads(json.dumps(kvc.handoff_to_wire(blob))))
    codec_ms = (time.perf_counter() - t0) * 1e3
    rec["disagg"]["http"] = {
        "wave_s": http_s, "exact": len(ok),
        "failed": [type(e).__name__ for e in failed],
        "wire_ms_one_run": codec_ms,
        "wire_blob_bytes": kvc.handoff_nbytes(blob),
        "wire_seq_len": int(blob["seq_len"])}
    print(f"  over HTTP (1 prefill, 2 decode worker processes), the prefill "
          f"worker SIGKILLed mid-wave: {len(ok)} of {DISAGG_REQUESTS} "
          f"streams byte for byte the colocated ones, {len(failed)} failed "
          f"with {sorted({type(e).__name__ for e in failed})} (retryable), "
          f"in {http_s:.2f} s; the wire codec (encode, JSON, decode) of a "
          f"{int(blob['seq_len'])}-token blob of {kvc.handoff_nbytes(blob)} "
          f"bytes {codec_ms:.1f} ms (host, one run); {card}", flush=True)
    del router, hrouter, template, im
    torch.cuda.empty_cache()
    return dict(launches)


def fleet_path(card, detail):
    """Phase 21: the serving fleet on the card. The replica processes
    start first, in parallel with the in-process parts' set-up; every
    process is SIGKILLed and reaped on every exit path. Returns the
    launches of the held windows (B5/B6 per bucket execution of the
    in-process replicas, B7 per prefill and B11 per decode step of the
    colocated and disaggregated legs)."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.apps import web_service_sample
    from analytics_zoo_tpu_torch.common import slo
    t0 = time.perf_counter()
    rec = {"seconds_by_part": {}}
    saved = {k: os.environ.get(k) for k in ("ZOO_TPU_SLO_TICK_S",
                                            "ZOO_TPU_FED_TICK_S")}
    os.environ.update({"ZOO_TPU_SLO_TICK_S": "0", "ZOO_TPU_FED_TICK_S": "0"})
    slo.reset_slo()
    zoo.init_nncontext(seed=0)
    workers = FleetWorkers(["resnet", "resnet", "prefill", "decode",
                            "decode"])
    clock = [1000.0]
    router = srv = None
    try:
        t = time.perf_counter()
        router, srv, models, nets, template, launches = fleet_inprocess(
            card, rec, lambda: clock[0], workers)
        rec["seconds_by_part"]["inprocess"] = time.perf_counter() - t
        t = time.perf_counter()
        fleet_rollout(card, rec, router, srv, models, nets, template,
                      clock)
        rec["seconds_by_part"]["rollout"] = time.perf_counter() - t
        srv.stop()
        srv = None
        torch.cuda.empty_cache()
        t = time.perf_counter()
        fleet_processes(card, rec, workers, template)
        rec["seconds_by_part"]["processes"] = time.perf_counter() - t
        del models, nets, template
        torch.cuda.empty_cache()
        t = time.perf_counter()
        gen = fleet_disagg(card, rec, workers)
        rec["seconds_by_part"]["disagg"] = time.perf_counter() - t
        for k, v in gen.items():
            launches[k] = launches.get(k, 0) + v
        t = time.perf_counter()
        r = web_service_sample.main([])
        check(r["errors"] == 0 and r["health"]["status"] == "ok",
              f"web_service_sample: {r}")
        rec["seconds_by_part"]["web_service_sample"] = \
            time.perf_counter() - t
        print(f"  apps/web_service_sample at its defaults: {r['requests']} "
              f"concurrent requests served, 0 errors", flush=True)
    finally:
        if srv is not None:
            srv.stop()
        workers.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        slo.reset_slo()
    rec["seconds"] = time.perf_counter() - t0
    rec["launches"] = {k: v for k, v in launches.items() if v}
    print(f"  phase 21 launches {rec['launches']}; seconds by part "
          f"{ {k: round(v, 1) for k, v in rec['seconds_by_part'].items()} }"
          f" (the in-process fleet waited {rec.get('worker_wait_s', 0):.1f} s"
          f" for the workers once warm); in {rec['seconds']:.1f} s, peak "
          f"device memory "
          f"{torch.cuda.max_memory_allocated()} bytes on {card}", flush=True)
    detail["fleet"] = rec
    return rec["launches"]


# -- artifacts and the native front end (phase 22) ----------------------------

# the artifact worker's time limit (its start, two loads and the forwards)
ARTIFACT_WORKER_S = 600
ARTIFACT_BATCHES = (1, 8, BATCH)
ARTIFACT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def artifact_worker(d) -> int:
    """``chip_smoke.py --artifact-worker DIR``: the second process. On
    the libraries phase 2 built, ``load_compiled`` each artifact that
    ``DIR/request.json`` names (timed), a first predict at batch 32
    (``program.pt2``), then batches 1, 8 and 32 of ``DIR/x<b>.npy``
    through ``program_dyn.pt2``; the f32 artifact once more on the CPU
    (its program moved there) at batch 1. Writes the logits to
    ``DIR/worker_out.npz`` and prints one JSON line: the seconds, each
    program's operator nodes and the launches of its forwards."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    from analytics_zoo_tpu_torch.pipeline.api.keras.models import to_numpy
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    zoo.init_nncontext(seed=0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(d, "request.json")) as f:
        req = json.load(f)
    images = {b: np.load(os.path.join(d, f"x{b}.npy"))
              for b in ARTIFACT_BATCHES}
    out = {"load_s": {}, "first_predict_s": {}, "graph": {},
           "forwards": 0}
    arrays = {}
    reset_launches()
    for dname, art in req["artifacts"].items():
        t0 = time.perf_counter()
        im = InferenceModel(2).load_compiled(art)
        out["load_s"][dname] = time.perf_counter() - t0
        t0 = time.perf_counter()
        arrays[f"{dname}_b{BATCH}_static"] = im.predict(images[BATCH])
        out["first_predict_s"][dname] = time.perf_counter() - t0
        out["forwards"] += 1
        for pname, gm in im.programs.items():
            targets = [str(n.target) for n in gm.graph.nodes
                       if n.op == "call_function"]
            out["graph"][f"{dname}/{pname}"] = {
                "matmul_bn_apply": targets.count(
                    "zoo_torch.matmul_bn_apply.default"),
                "conv3x3_bn_apply": targets.count(
                    "zoo_torch.conv3x3_bn_apply.default"),
                "nodes": len(targets),
                "foreign": sorted({t for t in targets if not (
                    t.startswith(("aten.", "zoo_torch.")) or
                    t == "<built-in function getitem>")})}
        dyn = im.programs["program_dyn.pt2"]
        cast = torch.bfloat16 if dname == "bfloat16" else torch.float32
        with torch.inference_mode():
            for b in ARTIFACT_BATCHES:
                x = torch.from_numpy(images[b]).to(DEV).to(cast)
                arrays[f"{dname}_b{b}"] = to_numpy(dyn(x))
                out["forwards"] += 1
        torch.cuda.synchronize()
    out["launches"] = {k: v for k, v in all_launches().items() if v}
    t0 = time.perf_counter()
    cpu_im = InferenceModel().load_compiled(req["artifacts"]["float32"],
                                            device="cpu")
    arrays["float32_b1_cpu"] = cpu_im.predict(images[1])
    out["cpu_load_and_predict_s"] = time.perf_counter() - t0
    out["inductor_imported"] = "torch._inductor" in sys.modules
    np.savez(os.path.join(d, "worker_out.npz"), **arrays)
    print(json.dumps(out), flush=True)
    return 0


def artifact_export(card, rec, tmp, nets, images):
    """Phase 22, part a: ``export_compiled`` of ResNet-50 in f32 and,
    through ``ModelRegistry.register_export``, in bf16 (v1, seed 0) and
    v2 (seed 1), each with a batch-32 example; the eager model's own
    predict at batches 1, 8 and 32 (and its load and first predict
    timed) for the worker to be held to."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                            ModelRegistry)
    reg = ModelRegistry(root=os.path.join(tmp, "registry"))
    arts, eager, rec["export"] = {}, {}, {}
    for dname, seed in (("float32", 0), ("bfloat16", 0), ("v2", 1)):
        dt = torch.float32 if dname == "float32" else torch.bfloat16
        x32 = torch.from_numpy(images[BATCH]).to(DEV, dt)
        t0 = time.perf_counter()
        im = InferenceModel(2).load_keras_net(nets[seed],
                                              example_inputs=[x32])
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        first = im.predict(images[BATCH])
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if dname == "float32":
            arts[dname] = im.export_compiled(os.path.join(tmp, "f32.zip"))
        else:
            version = "v1" if dname == "bfloat16" else "v2"
            arts[dname] = reg.register_export(
                "resnet-50", version, im,
                metadata={"seed": seed}).artifact
        export_s = time.perf_counter() - t0
        size = os.path.getsize(arts[dname])
        with zipfile.ZipFile(arts[dname]) as z:
            members = sorted(z.namelist())
        check(members == ["meta.json", "program.pt2", "program_dyn.pt2"],
              f"{dname}: the artifact holds {members}")
        rec["export"][dname] = {"bytes": size, "export_s": export_s,
                                "load_keras_net_s": load_s,
                                "first_predict_s": first_s}
        print(f"  export {dname} (seed {seed}): {size} bytes in "
              f"{export_s:.2f} s; in-process load_keras_net "
              f"{load_s:.3f} s, first predict {first_s:.3f} s, on {card}",
              flush=True)
        if dname != "v2":
            eager[dname] = {b: im.predict(images[b]) if b != BATCH
                            else first for b in ARTIFACT_BATCHES}
    return reg, arts, eager


def artifact_in_worker(card, rec, tmp, arts, eager, images):
    """Phase 22, part b: the artifacts served by a second process
    (``--artifact-worker``), held to the eager model of this one."""
    import signal
    with open(os.path.join(tmp, "request.json"), "w") as f:
        json.dump({"artifacts": {k: arts[k] for k in ("float32",
                                                      "bfloat16")}}, f)
    for b in ARTIFACT_BATCHES:
        np.save(os.path.join(tmp, f"x{b}.npy"), images[b])
    log_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(log_dir, "artifact_worker.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
             "--artifact-worker", tmp], stdout=subprocess.PIPE, stderr=log,
            text=True, cwd=ROOT)
        try:
            stdout, _ = proc.communicate(timeout=ARTIFACT_WORKER_S)
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the artifact worker exited "
          f"{proc.returncode} (its log: chiprun_out/artifact_worker.log)")
    out = json.loads(stdout.strip().splitlines()[-1])
    got = np.load(os.path.join(tmp, "worker_out.npz"))
    held = {}
    for dname in ("float32", "bfloat16"):
        for b in ARTIFACT_BATCHES:
            want = eager[dname][b]
            tol = ARTIFACT_TOL[dname] * max(1.0, float(np.abs(want).max()))
            for key in (f"{dname}_b{b}",) + (
                    (f"{dname}_b{b}_static",) if b == BATCH else ()):
                y = got[key]
                err = float(np.abs(y - want).max())
                held[key] = {"bit_for_bit": bool(np.array_equal(y, want)),
                             "max_abs_err": err, "tol": tol}
                check(y.shape == want.shape and err <= tol,
                      f"{key}: the worker's logits {err} from the eager "
                      f"ones (tol {tol})")
    want = eager["float32"][1]
    cpu_err = float(np.abs(got["float32_b1_cpu"] - want).max())
    cpu_tol = 1e-3 * max(1.0, float(np.abs(want).max()))
    check(cpu_err <= cpu_tol, f"the f32 artifact on the CPU: {cpu_err} "
          f"from the card's eager logits (tol {cpu_tol})")
    n = out["forwards"]
    launches = out["launches"]
    check(launches == {"matmul_bn_apply": 36 * n,
                       "conv3x3_bn_apply": 16 * n},
          f"the worker launched {launches} in {n} forwards, expected "
          "B5/B6 36/16 per forward")
    for key, g in out["graph"].items():
        check(g["matmul_bn_apply"] == 36 and g["conv3x3_bn_apply"] == 16
              and not g["foreign"], f"{key}: the loaded graph holds {g}")
    rec["worker"] = dict(out, held=held, wall_s=wall,
                         cpu_max_abs_err=cpu_err)
    print(f"  second process ({wall:.2f} s in all): load_compiled "
          f"{ {k: round(v, 3) for k, v in out['load_s'].items()} } s, "
          f"first predict "
          f"{ {k: round(v, 3) for k, v in out['first_predict_s'].items()} }"
          f" s; {n} forwards launched {launches}; graphs "
          f"{ {k: (g['matmul_bn_apply'], g['conv3x3_bn_apply']) for k, g in out['graph'].items()} }"
          f"; torch._inductor imported: {out['inductor_imported']}; on "
          f"{card}", flush=True)
    for key, h in held.items():
        print(f"    {key}: bit for bit {h['bit_for_bit']}, max|err| "
              f"{h['max_abs_err']:.4e} (tol {h['tol']:.4e})", flush=True)
    print(f"    the f32 card artifact on the CPU at batch 1: max|err| "
          f"{cpu_err:.4e} (tol {cpu_tol:.4e}), load and predict "
          f"{out['cpu_load_and_predict_s']:.2f} s", flush=True)
    return launches


def artifact_rollout(card, rec, reg):
    """Phase 22, part c: two replicas loaded from v1's artifact behind a
    ``FleetRouter`` roll to v2's (``rollout(canary_pct=50)``, the bake on
    the router's clock) under a load loop with no failure; each then
    serves v2's artifact's own logits bit for bit."""
    import torch

    from analytics_zoo_tpu_torch.pipeline.inference import (
        DynamicBatcher, FleetRouter, InferenceModel, Replica, ReplicaPool)
    clock = [1000.0]
    v1, v2 = reg.get("resnet-50", "v1"), reg.get("resnet-50", "v2")
    replicas, models = [], {}
    for name in ("r0", "r1"):
        im = InferenceModel()
        v1.load_into(im)
        models[name] = im
        r = Replica(name, im, clock=lambda: clock[0],
                    batcher=DynamicBatcher(im, labels={"replica": name},
                                           **FLEET_BATCHER))
        r.version = "v1"
        replicas.append(r)
    router = FleetRouter(ReplicaPool(replicas=replicas,
                                     clock=lambda: clock[0]),
                         probe_interval_s=0).start()
    x2 = np.random.RandomState(3).rand(2, *IMAGE).astype(np.float32)
    stop, failures, served = threading.Event(), [], [0]

    def load_loop():
        while not stop.is_set():
            try:
                out = np.asarray(router.submit([x2]).result(timeout=120))
                if out.shape != (2, 1000) or not np.isfinite(out).all():
                    failures.append(f"bad output {out.shape}")
            except Exception as e:
                failures.append(repr(e))
            served[0] += 1

    def wait_served(n):
        target, deadline = served[0] + n, time.monotonic() + 120
        while served[0] < target and time.monotonic() < deadline:
            time.sleep(0.01)

    loop = [threading.Thread(target=load_loop) for _ in range(2)]
    t0 = time.perf_counter()
    try:
        for t in loop:
            t.start()
        wait_served(4)
        ctl = router.rollout(v2, canary_pct=50, bake_s=FLEET_BAKE_S)
        wait_served(8)
        clock[0] += FLEET_BAKE_S + 1.0
        router.tick(now=clock[0])
        wait_served(4)
    finally:
        stop.set()
        for t in loop:
            t.join(timeout=600)
        router.stop()
    seconds = time.perf_counter() - t0
    check(ctl.state == "promoted", f"the rollout ended {ctl.state} "
          f"({ctl.reason})")
    check(not failures, f"the load loop saw {len(failures)} failures: "
          f"{failures[:3]}")
    status = router.rollout_status()
    check(set(status["replica_versions"].values()) == {"v2"},
          f"replica versions {status['replica_versions']}")
    direct = InferenceModel().load_compiled(v2.artifact)
    x = np.random.RandomState(5).rand(4, *IMAGE).astype(np.float32)
    want = direct.predict(x)
    for name, im in models.items():
        check(np.array_equal(im.predict(x), want),
              f"{name} after the rollout differs from v2's artifact")
    states = [t["state"] for t in status["transitions"]]
    rec["rollout"] = {"requests_in_loop": served[0], "failures": 0,
                      "transitions": states, "seconds": seconds}
    print(f"  rollout v1 -> v2 from the registry's artifacts under load: "
          f"{served[0]} requests, 0 failures, {states}; both replicas "
          f"serve v2's artifact's logits bit for bit; {seconds:.1f} s",
          flush=True)
    del direct, models
    torch.cuda.empty_cache()


def artifact_http(card, rec, art):
    """Phase 22, part d: ``make_inference_server`` over the bf16 artifact
    (loaded here) must be the native front end; phase 12's HTTP load
    (HTTP_REQUESTS JSON requests of bench_serving's mix from
    HTTP_CLIENTS threads, a DynamicBatcher of max batch 32, 5 ms, queue
    512) on it and on ``InferenceServer`` over the same model, in turns;
    ``/health`` answered while every worker is held in a wedged
    dispatch; a trace id echoed; ``/metrics`` counting the requests."""
    import torch

    from analytics_zoo_tpu_torch.common import faults
    from analytics_zoo_tpu_torch.common import observability as obs
    from analytics_zoo_tpu_torch.pipeline.inference import (
        DynamicBatcher, InferenceModel, InferenceServer,
        NativeInferenceServer, make_inference_server)
    # one native worker per client: the native front end serves as many
    # requests at once as the model's concurrency
    im = InferenceModel(HTTP_CLIENTS).load_compiled(art)
    rs = np.random.RandomState(12)
    sizes = [HTTP_MIX[i % len(HTTP_MIX)] for i in range(HTTP_REQUESTS)]
    images = [np.round(rs.rand(n, *IMAGE), 3) for n in sizes]
    bodies = [json.dumps({"inputs": x.tolist()}).encode() for x in images]
    alone = [im.predict(x.astype(np.float32)) for x in images]

    def batcher():
        return DynamicBatcher(im, max_batch_size=BATCH, max_wait_ms=5,
                              queue_depth=512)

    def served_count(port):
        text = urllib_text(port, "/metrics")
        key = 'zoo_tpu_serving_requests_total{path="/predict",status="200"}'
        return sum(float(line.split()[-1]) for line in text.splitlines()
                   if line.startswith(key + " "))

    def wave(srv, label):
        replies = [None] * HTTP_REQUESTS

        def client(c):
            for i in range(c, HTTP_REQUESTS, HTTP_CLIENTS):
                replies[i] = post_json(srv.port, "/predict", bodies[i])
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(HTTP_CLIENTS) as pool:
            for f in [pool.submit(client, c) for c in range(HTTP_CLIENTS)]:
                f.result()
        window = time.perf_counter() - t0
        worst = 0.0
        for i, r in enumerate(replies):
            check(r[0] == 200, f"{label}: request {i} answered {r[0]}")
            got = np.asarray(r[2]["outputs"], np.float32)
            tol = TOL["bfloat16"] * max(1.0, float(np.abs(alone[i]).max()))
            err = float(np.abs(got - alone[i]).max())
            check(err <= tol, f"{label}: request {i} {err} from predict "
                  f"alone (tol {tol})")
            worst = max(worst, err / tol)
        lat = [r[3] for r in replies]
        return {"images_per_s": sum(sizes) / window, "window_s": window,
                "p50_ms": percentile_ms(lat, 50),
                "p99_ms": percentile_ms(lat, 99),
                "worst_err_over_tol": worst}

    out = {}
    srv = make_inference_server(im, batcher=batcher())
    check(isinstance(srv, NativeInferenceServer),
          f"make_inference_server gave {type(srv).__name__}")
    try:
        srv.start()
        before = served_count(srv.port)
        out["native"] = wave(srv, "native")
        after = served_count(srv.port)
        check(after - before == HTTP_REQUESTS,
              f"/metrics counted {after - before} of {HTTP_REQUESTS} "
              "requests")
        idle_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            get_json(srv.port, "/health")
            idle_ms.append((time.perf_counter() - t0) * 1e3)
        out["health_idle_ms"] = idle_ms
        tid = "smoke-native-artifact"
        code, hdrs, _, _ = post_json(srv.port, "/predict", bodies[0],
                                     {"X-Zoo-Trace-Id": tid})
        check(code == 200 and hdrs["X-Zoo-Trace-Id"] == tid,
              f"the traced request {code}, header "
              f"{hdrs.get('X-Zoo-Trace-Id')}")
        # every worker held in a request the wedged dispatcher keeps
        faults.arm("batcher/dispatch", "wedge", seconds=60)
        held = [threading.Thread(target=post_json, args=(
            srv.port, "/predict", bodies[0])) for _ in range(HTTP_CLIENTS)]
        for t in held:
            t.start()
        deadline = time.monotonic() + 60
        while (plane_value(obs.snapshot(), "zoo_tpu_serving_in_flight")
               or 0) < HTTP_CLIENTS and time.monotonic() < deadline:
            time.sleep(0.01)
        # the handlers decode their bodies under the GIL first (tens of
        # ms an image: phase 12's JSON decode), which a client in this
        # process waits for too
        time.sleep(2.0)
        health_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            health = get_json(srv.port, "/health")
            health_ms.append((time.perf_counter() - t0) * 1e3)
        busy = plane_value(obs.snapshot(), "zoo_tpu_serving_in_flight")
        faults.disarm_all()
        for t in held:
            t.join(timeout=120)
        check(busy == HTTP_CLIENTS and health["status"] == "ok",
              f"/health with {busy} of {HTTP_CLIENTS} workers busy: "
              f"{health}")
        out["health_while_busy_ms"] = health_ms
    finally:
        faults.disarm_all()
        srv.stop()
    srv = InferenceServer(im, port=0, batcher=batcher())
    try:
        srv.start()
        out["stdlib"] = wave(srv, "stdlib")
    finally:
        srv.stop()
    rec["http"] = out
    for label in ("native", "stdlib"):
        r = out[label]
        print(f"  ResNet-50 bf16 from the artifact over HTTP, {label} front"
              f" end: {HTTP_REQUESTS} requests ({sum(sizes)} images) from "
              f"{HTTP_CLIENTS} clients: {r['images_per_s']:.2f} images/s, "
              f"p50 {r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms, worst "
              f"error {r['worst_err_over_tol']:.3f} of its bound, on {card}",
              flush=True)
    print(f"  native /health: median "
          f"{statistics.median(out['health_while_busy_ms']):.2f} ms of 5 "
          f"with all {HTTP_CLIENTS} workers held (idle "
          f"{statistics.median(out['health_idle_ms']):.2f} ms); the trace "
          f"id echoed; /metrics counted {HTTP_REQUESTS} of {HTTP_REQUESTS}",
          flush=True)
    del im
    torch.cuda.empty_cache()


def artifact_path(card, detail):
    """Phase 22: full-width ResNet-50 (seed-0 weights, distinctive
    BatchNorm statistics) exported, served from its artifact by a second
    process, rolled between registry versions and behind the native
    front end. The artifacts go to a temporary directory, removed at the
    end; the worker is SIGKILLed and reaped on every exit path. Returns
    the worker's launches."""
    import shutil
    import tempfile

    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.common import slo
    t0 = time.perf_counter()
    rec = {}
    saved = os.environ.get("ZOO_TPU_SLO_TICK_S")
    os.environ["ZOO_TPU_SLO_TICK_S"] = "0"
    slo.reset_slo()
    zoo.init_nncontext(seed=0)
    tmp = tempfile.mkdtemp(prefix="zoo_artifacts_")
    try:
        rs = np.random.RandomState(22)
        images = {b: rs.rand(b, *IMAGE).astype(np.float32)
                  for b in ARTIFACT_BATCHES}
        nets = {0: fleet_resnet(0), 1: fleet_resnet(1)}
        reg, arts, eager = artifact_export(card, rec, tmp, nets, images)
        del nets
        torch.cuda.empty_cache()
        launches = artifact_in_worker(card, rec, tmp, arts, eager, images)
        artifact_rollout(card, rec, reg)
        artifact_http(card, rec, arts["bfloat16"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved is None:
            os.environ.pop("ZOO_TPU_SLO_TICK_S", None)
        else:
            os.environ["ZOO_TPU_SLO_TICK_S"] = saved
        slo.reset_slo()
    rec["seconds"] = time.perf_counter() - t0
    print(f"  phase 22 in {rec['seconds']:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes on {card}", flush=True)
    detail["artifact"] = rec
    return launches


# -- phase 23: model import ---------------------------------------------------

IMPORT_BATCHES = (1, 8, BATCH)
IMPORT_STEPS = 3
# the imported graph's convolutions, products and reductions by library
# kernel family (cuDNN, cuBLAS and PyTorch's own)
IMPORT_KERNEL_NAMES = (
    ("convolutions (cuDNN)", r"(?i)conv|xmma|implicit|winograd|dgrad|wgrad"),
    ("products (cuBLAS)", r"(?i)gemm|sm90_xmma_gemm|cutlass"),
    ("reductions", r"(?i)reduce|norm"),
    ("elementwise", r"(?i)elementwise|vectorized|unrolled"),
)


def resnet_onnx(net, image=IMAGE):
    """The unfused ResNet-50 ``net`` (``ImageClassifier("resnet-50",
    fused=False)``) as an ONNX ``ModelProto`` built with the port's
    ``helper``: opset 13, NCHW, Conv (TF "SAME" as explicit pads),
    BatchNormalization, Relu, MaxPool, Add, GlobalAveragePool, Flatten
    and Gemm, its weights the net's. Walks the net's own graph."""
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.ops.conv_bn import tf_same_pads
    from analytics_zoo_tpu_torch.pipeline.api.keras import layers as L
    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import \
        _InputLayer
    from analytics_zoo_tpu_torch.pipeline.api.onnx import helper
    from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_pb import \
        TensorProto

    params = params_to_numpy(net)
    nodes, inits, names = [], [], {}

    def init(name, arr):
        inits.append(helper.make_tensor(name, np.ascontiguousarray(
            arr, np.float32)))
        return name

    def same_pads(v, kernel, stride):
        h, w = v.shape[0], v.shape[1]
        (t, b, _), (l, r, _) = (tf_same_pads(h, kernel[0], stride[0]),
                                tf_same_pads(w, kernel[1], stride[1]))
        return [t, l, b, r]

    for v in net._order:
        lyr = v.layer
        if isinstance(lyr, _InputLayer):
            names[id(v)] = "image"
            continue
        ins = [names[id(p)] for p in v.parents]
        out = lyr.name
        p = params.get(lyr.name, {})
        if isinstance(lyr, L.Convolution2D):
            check(lyr.border_mode == "same" and not lyr.use_bias and
                  lyr.groups == 1, f"{lyr.name}: unexpected conv")
            w = init(f"{out}.weight", p["kernel"].transpose(3, 2, 0, 1))
            nodes.append(helper.make_node(
                "Conv", [ins[0], w], [out],
                kernel_shape=list(lyr.kernel_size),
                strides=list(lyr.subsample),
                pads=same_pads(v.parents[0], lyr.kernel_size,
                               lyr.subsample)))
        elif isinstance(lyr, L.BatchNormalization):
            st = p["_state"]
            nodes.append(helper.make_node(
                "BatchNormalization",
                [ins[0], init(f"{out}.gamma", p["gamma"]),
                 init(f"{out}.beta", p["beta"]),
                 init(f"{out}.mean", st["moving_mean"]),
                 init(f"{out}.var", st["moving_var"])], [out],
                epsilon=lyr.epsilon))
        elif isinstance(lyr, L.Activation):
            nodes.append(helper.make_node("Relu", ins, [out]))
        elif isinstance(lyr, L.MaxPooling2D):
            nodes.append(helper.make_node(
                "MaxPool", ins, [out], kernel_shape=list(lyr.pool_size),
                strides=list(lyr.strides),
                pads=same_pads(v.parents[0], lyr.pool_size, lyr.strides)))
        elif isinstance(lyr, L.Add):
            nodes.append(helper.make_node("Add", ins, [out]))
        elif isinstance(lyr, L.GlobalAveragePooling2D):
            nodes.append(helper.make_node("GlobalAveragePool", ins,
                                          [out + ".pool"]))
            nodes.append(helper.make_node("Flatten", [out + ".pool"], [out],
                                          axis=1))
        elif isinstance(lyr, L.Dense):
            nodes.append(helper.make_node(
                "Gemm", [ins[0], init(f"{out}.weight", p["kernel"]),
                         init(f"{out}.bias", p["bias"])], [out]))
        else:
            raise AssertionError(f"no ONNX mapping for {lyr.name}")
        names[id(v)] = out
    h, w, c = image
    graph = helper.make_graph(
        nodes, "resnet50",
        [helper.make_tensor_value_info("image", TensorProto.FLOAT,
                                       ["N", c, h, w])],
        [helper.make_tensor_value_info(names[id(net.outputs[0])],
                                       TensorProto.FLOAT, ["N", 1000])],
        inits)
    return helper.make_model(graph, opset_version=13)


def onnx_steps(device, proto, x, y, steps, policy="float32"):
    """``steps`` SGD steps (0.01, momentum 0.9, softmax cross entropy)
    of ``proto`` imported on ``device`` at batch ``len(x) // steps``:
    the losses, the params after them, the Estimator."""
    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.bridge import params_to_numpy
    from analytics_zoo_tpu_torch.ops.optimizers import SGD
    from analytics_zoo_tpu_torch.pipeline.api.onnx import OnnxLoader
    from analytics_zoo_tpu_torch.pipeline.estimator import (Estimator,
                                                            MaxIteration)
    ctx = zoo.init_nncontext(seed=0, device=device)
    net = OnnxLoader.load_model(proto)
    net.init_params()
    est = Estimator(net, optimizer=SGD(lr=0.01, momentum=0.9),
                    loss="softmax_cross_entropy", dtype_policy=policy,
                    ctx=ctx)
    res = est.train(x, y, batch_size=len(x) // steps,
                    end_trigger=MaxIteration(steps))
    losses = [float(v) for h in res.history for v in h["losses"]]
    return losses, params_to_numpy(net)[net.layers[0].name]["w"], est


IMPORT_LENET_PROTOTXT = '''
name: "LeNet"
input: "data"
input_dim: 1 input_dim: 1 input_dim: 28 input_dim: 28
layer { name: "conv1" type: "Convolution" bottom: "data" top: "conv1"
        convolution_param { num_output: 20 kernel_size: 5 stride: 1 } }
layer { name: "pool1" type: "Pooling" bottom: "conv1" top: "pool1"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "conv2" type: "Convolution" bottom: "pool1" top: "conv2"
        convolution_param { num_output: 50 kernel_size: 5 } }
layer { name: "bn2" type: "BatchNorm" bottom: "conv2" top: "conv2" }
layer { name: "sc2" type: "Scale" bottom: "conv2" top: "conv2" }
layer { name: "pool2" type: "Pooling" bottom: "conv2" top: "pool2"
        pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip1" type: "InnerProduct" bottom: "pool2" top: "ip1"
        inner_product_param { num_output: 500 } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "ip1" }
layer { name: "ip2" type: "InnerProduct" bottom: "ip1" top: "ip2"
        inner_product_param { num_output: 10 } }
layer { name: "prob" type: "Softmax" bottom: "ip2" top: "prob" }
'''


def caffe_lenet_files(tmp, rs):
    """Caffe's LeNet-5 (20 and 50 filters of 5x5, 500 hidden, 10
    classes) as a prototxt and a binary caffemodel with seeded weights."""
    from analytics_zoo_tpu_torch.pipeline.api import caffe_load as cl
    w = lambda *s: (rs.randn(*s) * 0.1).astype(np.float32)  # noqa: E731

    def layer(name, *arrays):
        return cl.CaffeLayerParameter(name=name, blobs=[
            cl.BlobProto(shape=cl.BlobShape(dim=list(a.shape)),
                         data=a.reshape(-1).tolist()) for a in arrays])
    model = cl.NetParameter(name="LeNet", layer=[
        layer("conv1", w(20, 1, 5, 5), w(20)),
        layer("conv2", w(50, 20, 5, 5), w(50)),
        layer("bn2", w(50), rs.rand(50).astype(np.float32) + 0.5,
              np.array([1.0], np.float32)),
        layer("sc2", rs.rand(50).astype(np.float32) + 0.5, w(50)),
        layer("ip1", w(500, 800), w(500)), layer("ip2", w(10, 500), w(10))])
    proto = os.path.join(tmp, "lenet.prototxt")
    with open(proto, "w") as f:
        f.write(IMPORT_LENET_PROTOTXT)
    weights = os.path.join(tmp, "lenet.caffemodel")
    with open(weights, "wb") as f:
        f.write(model.SerializeToString())
    return proto, weights


def bigdl_model_file(tmp, rs):
    """A BigDL ``.model`` of LeNet-5 at the reference fixture's widths
    (a Reshape to 1x28x28, 6 and 12 filters of 5x5 with a BatchNorm,
    100 hidden, 5 classes, a LogSoftMax head), seeded weights."""
    from analytics_zoo_tpu_torch.pipeline.api import bigdl_pb as pb
    nn_ = "com.intel.analytics.bigdl.nn."
    w = lambda *s: (rs.randn(*s) * 0.2).astype(np.float32)  # noqa: E731

    def tensor(a):
        a = np.asarray(a, np.float32)
        return pb.BigDLTensor(
            datatype=pb.DT_FLOAT, size=list(a.shape), offset=1,
            dimension=a.ndim, nElements=a.size,
            storage=pb.TensorStorage(datatype=pb.DT_FLOAT,
                                     float_data=a.reshape(-1).tolist()))

    def module(kind, name, weight=None, bias=None, subs=(), extra=(), **kw):
        attrs = [pb.AttrEntry(key=k, value=pb.AttrValue(
            arrayValue=pb.ArrayValue(i32=list(v)))
            if isinstance(v, list) else pb.AttrValue(int32Value=v))
            for k, v in kw.items()] + list(extra)
        return pb.BigDLModule(
            name=name, moduleType=nn_ + kind, subModules=list(subs),
            weight=None if weight is None else tensor(weight),
            bias=None if bias is None else tensor(bias), attr=attrs)
    stats = [pb.AttrEntry(key="runningMean", value=pb.AttrValue(
        tensorValue=tensor(w(6)))),
        pb.AttrEntry(key="runningVar", value=pb.AttrValue(
            tensorValue=tensor(rs.rand(6) + 0.5)))]
    root = module("Sequential", "lenet", subs=[
        module("Reshape", "reshape", size=[1, 28, 28]),
        module("SpatialConvolution", "conv1", w(6, 1, 5, 5), w(6),
               nOutputPlane=6, kernelW=5, kernelH=5),
        module("SpatialBatchNormalization", "bn1", rs.rand(6) + 0.5, w(6),
               extra=stats),
        module("Tanh", "tanh1"),
        module("SpatialMaxPooling", "pool1", kW=2, kH=2, dW=2, dH=2),
        module("SpatialConvolution", "conv2", w(12, 6, 5, 5), w(12),
               nOutputPlane=12, kernelW=5, kernelH=5),
        module("Tanh", "tanh2"),
        module("SpatialMaxPooling", "pool2", kW=2, kH=2, dW=2, dH=2),
        module("Reshape", "flat", size=[12 * 4 * 4]),
        module("Linear", "fc1", w(100, 192), w(100), outputSize=100),
        module("Tanh", "tanh3"),
        module("Linear", "fc2", w(5, 100), w(5), outputSize=5),
        module("LogSoftMax", "out")])
    path = os.path.join(tmp, "lenet.model")
    with open(path, "wb") as f:
        f.write(root.SerializeToString())
    return path


def torch_convnet():
    """A torch conv net of the importer's modules (seeded; BatchNorm
    statistics from three training batches)."""
    import torch
    import torch.nn as nn
    torch.manual_seed(0)
    m = nn.Sequential(
        nn.Conv2d(3, 32, 3, padding=1), nn.BatchNorm2d(32), nn.ReLU(),
        nn.MaxPool2d(3, stride=2, ceil_mode=True),
        nn.Conv2d(32, 64, 3, stride=2, padding=1, groups=4), nn.ELU(),
        nn.AvgPool2d(2), nn.Conv2d(64, 64, 1), nn.LeakyReLU(0.1),
        nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(64, 10))
    m.train()
    with torch.no_grad():
        for _ in range(3):
            m(torch.randn(16, 3, 32, 32))
    return m.eval()


def import_others(card, rec, tmp):
    """The Caffe, BigDL and torch importers and the four integer ONNX
    ops, each on the card against its own CPU run."""
    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch import Net
    from analytics_zoo_tpu_torch.pipeline.api.onnx import helper
    from analytics_zoo_tpu_torch.pipeline.api.onnx.onnx_loader import \
        run_node
    rs = np.random.RandomState(23)
    caffe = caffe_lenet_files(tmp, rs)
    bigdl = bigdl_model_file(tmp, rs)
    tm = torch_convnet()
    cases = {
        "caffe LeNet-5": (lambda: Net.load_caffe(*caffe),
                          rs.randn(64, 1, 28, 28).astype(np.float32)),
        "BigDL LeNet-5 (.model)": (lambda: Net.load_bigdl(bigdl),
                                   rs.randn(64, 784).astype(np.float32)),
        "torch conv net": (lambda: Net.load_torch(tm, (3, 32, 32)),
                           rs.randn(64, 3, 32, 32).astype(np.float32)),
    }
    out = {}
    for label, (load, x) in cases.items():
        zoo.init_nncontext(seed=0)
        t = time.perf_counter()
        net = load()
        load_s = time.perf_counter() - t
        check(net.device.type == "cuda", f"{label}: on {net.device}")
        got = net.predict(x, batch_size=32)
        zoo.init_nncontext(seed=0, device="cpu")
        want = load().predict(x, batch_size=32)
        err = float(np.abs(got - want).max())
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        print(f"  {label}: loaded on the card in {load_s:.3f} s; served "
              f"{got.shape} against the CPU: max|err| {err:.3e} (tol "
              f"{tol:.1e})", flush=True)
        check(np.isfinite(got).all() and err <= tol,
              f"{label}: card vs CPU {err} > {tol}")
        out[label] = {"max_abs_err": err, "tol": tol, "load_s": load_s}
        if label == "torch conv net":
            with torch.no_grad():
                ref = tm(torch.from_numpy(x)).numpy()
            err_m = float(np.abs(got - ref).max())
            print(f"    against the module's own CPU forward: max|err| "
                  f"{err_m:.3e}", flush=True)
            check(err_m <= 1e-4 * max(1.0, float(np.abs(ref).max())),
                  f"{label}: vs module {err_m}")
            out[label]["vs_module"] = err_m
    zoo.init_nncontext(seed=0)
    u8 = lambda *s: rs.randint(0, 256, s).astype(np.uint8)  # noqa: E731
    s32 = lambda v: np.array(v, np.float32)  # noqa: E731
    z8 = lambda v: np.array(v, np.uint8)  # noqa: E731
    x8, w8 = u8(8, 64, 56, 56), u8(64, 64, 3, 3)
    a8, b8 = u8(4, 512, 1024), u8(1024, 256)
    wscale = (rs.rand(64) * 0.02).astype(np.float32)
    ops = {
        "ConvInteger": (helper.make_node(
            "ConvInteger", ["x", "w", "xz", "wz"], ["y"],
            kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
            [x8, w8, z8(120), z8(128)]),
        "MatMulInteger": (helper.make_node(
            "MatMulInteger", ["a", "b", "az", "bz"], ["y"]),
            [a8, b8, z8(7), z8(9)]),
        "QLinearConv": (helper.make_node(
            "QLinearConv", ["x", "xs", "xz", "w", "ws", "wz", "ys", "yz",
                            "b"], ["y"], kernel_shape=[3, 3],
            pads=[1, 1, 1, 1], strides=[2, 2]),
            [x8, s32(0.02), z8(120), w8, wscale, z8(128), s32(0.5), z8(100),
             rs.randint(-5000, 5000, (64,)).astype(np.int32)]),
        "QLinearMatMul": (helper.make_node(
            "QLinearMatMul", ["a", "sa", "za", "b", "sb", "zb", "sy", "zy"],
            ["y"]), [a8, s32(0.02), z8(120), b8, s32(0.03), z8(130),
                     s32(5.0), z8(128)]),
    }
    for name, (node, inputs) in ops.items():
        got = run_node(node, inputs, device="cuda")[0]
        want = run_node(node, inputs, device="cpu")[0]
        same = got.dtype == want.dtype and np.array_equal(got, want)
        print(f"  {name} {tuple(got.shape)} {got.dtype}: card bit for bit "
              f"the CPU's: {same}", flush=True)
        check(same, f"{name}: the card's result differs from the CPU's")
        out[name] = {"shape": list(got.shape), "bit_for_bit": same}
    rec["others"] = out


def import_path(card, detail):
    """Phase 23: full-width ResNet-50 imported from an ONNX file, served
    and fine-tuned on the card; the Caffe, BigDL and torch importers and
    the integer ONNX ops against the CPU. Returns the kernel launches."""
    import tempfile

    import torch

    import analytics_zoo_tpu_torch as zoo
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.pipeline.api.onnx import (OnnxLoader,
                                                           onnx_pb)
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = detail.setdefault("import", {})
    reset_launches()
    zoo.init_nncontext(seed=0)
    rs = np.random.RandomState(0)
    images = {bs: rs.rand(bs, *IMAGE).astype(np.float32)
              for bs in IMPORT_BATCHES}
    native = ImageClassifier("resnet-50", input_shape=IMAGE, classes=1000,
                             fused=False).model
    native.init_params()
    distinct_bn(native, 1)
    factor = scale_head(native, images[8])
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        proto = resnet_onnx(native)
        path = os.path.join(tmp, "resnet50.onnx")
        onnx_pb.save_model(proto, path)
        built_s = time.perf_counter() - t
        size = os.path.getsize(path)
        t = time.perf_counter()
        net = OnnxLoader.load_model(path)
        parse_s = time.perf_counter() - t
        net.init_params()
        load_s = time.perf_counter() - t
        n_nodes = len(proto.graph.node)
        ops = sorted({n.op_type for n in proto.graph.node})
        print(f"  ResNet-50 as ONNX (opset 13, {n_nodes} nodes: "
              f"{', '.join(ops)}; head scaled by {factor:.3g}): "
              f"{size / 1e6:.1f} MB written in {built_s:.2f} s, loaded "
              f"onto {net.device} in {load_s:.2f} s (the file read and "
              f"parsed in {parse_s:.2f} s, then the shape pass and the "
              "weights' copy)", flush=True)
        check(net.device.type == "cuda", f"imported net on {net.device}")
        rec.update(onnx_bytes=size, build_s=built_s, load_s=load_s,
                   parse_s=parse_s, nodes=n_nodes, ops=ops)

        im = InferenceModel(supported_concurrent_num=2).load_keras_net(net)
        ref_im = InferenceModel(
            supported_concurrent_num=2).load_keras_net(native)
        requests = [(bs, rep) for bs in IMPORT_BATCHES for rep in range(2)]
        nchw = {bs: torch.from_numpy(images[bs].transpose(0, 3, 1, 2)
                                     .copy()).to("cuda")
                for bs in IMPORT_BATCHES}
        torch.cuda.synchronize()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futures = [pool.submit(im.predict, nchw[bs])
                       for bs, _ in requests]
            outs = [f.result() for f in futures]
        checks = {}
        for (bs, rep), got in zip(requests, outs):
            want = native.predict(images[bs], batch_size=BATCH)
            err = float(np.abs(got - want).max())
            tol = 1e-3 * float(np.abs(want).max())
            checks[f"b{bs}_r{rep}"] = (err, tol)
            print(f"  served batch {bs} (request {rep}) against the native "
                  f"net: max|err| {err:.4e} (tol {tol:.4e}, 1e-3 of "
                  f"max|logit| {float(np.abs(want).max()):.3f})",
                  flush=True)
            check(got.shape == (bs, 1000) and np.isfinite(got).all() and
                  err <= tol, f"imported batch {bs}: {err} > {tol}")
        rec["logit_checks"] = checks
        # the graph's shape arithmetic stays on the host: one forward
        # under the sync debug mode, which raises on a device read
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.inference_mode():
                net.call(net.params(), nchw[BATCH])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print("  a batch-32 forward of the imported graph ran under "
              "torch.cuda.set_sync_debug_mode('error'): no device read "
              f"between its {n_nodes} nodes", flush=True)
        x32 = torch.from_numpy(images[BATCH]).to("cuda")
        rates = {}
        for label, model, x in (("imported", im, nchw[BATCH]),
                                ("native", ref_im, x32),
                                ("imported again", im, nchw[BATCH])):
            med, lo, hi = median_request_s(model, x)
            rates[label] = {"ms": med * 1e3, "ms_spread": [lo * 1e3,
                                                           hi * 1e3],
                            "images_per_s": BATCH / med}
            print(f"  {label} f32 batch {BATCH}: median {med * 1e3:.3f} ms "
                  f"per request ({lo * 1e3:.3f}-{hi * 1e3:.3f}), "
                  f"{BATCH / med:.1f} images/s on {card}", flush=True)
        rec["serving"] = rates
        rec["profile_serving"] = profile_steps(
            lambda: im.predict(nchw[BATCH]), 3, IMPORT_KERNEL_NAMES)
        # fine-tuning starts from the head as drawn: scaled, the first
        # steps' gradients would be the head's scale times larger
        head = native.graph_layers["fc"].params()["kernel"]
        with torch.no_grad():
            head.div_(factor)
        proto = resnet_onnx(native)
        del im, ref_im, native, head
        torch.cuda.empty_cache()

        # fine-tune: one f32 step at batch 8 on the card and on the CPU
        x8 = images[8].transpose(0, 3, 1, 2).copy()
        y8 = rs.randint(0, 1000, (8,)).astype(np.int32)
        lc, pc, _ = onnx_steps("cuda", proto, x8, y8, 1)
        lj, pj, _ = onnx_steps("cuda", proto, x8 * (1.0 + 1e-6), y8, 1)
        torch.cuda.empty_cache()
        lp, pp, _ = onnx_steps("cpu", proto, x8, y8, 1)
        zoo.init_nncontext(seed=0)
        rel = abs(lc[0] - lp[0]) / abs(lp[0])
        print(f"  one f32 step at batch 8: loss card {lc[0]:.6f}, CPU "
              f"{lp[0]:.6f} (rel {rel:.2e}, tol 1e-4)", flush=True)
        check(np.isfinite(lc[0]) and rel <= 1e-4,
              f"imported step loss {lc[0]} vs {lp[0]}")
        step = {"loss_card": lc[0], "loss_cpu": lp[0], "loss_rel": rel}
        for leaf in ("fc.weight", "fc.bias", "s3b2_c3.weight",
                     "s3b2_c3_bn.gamma"):
            err = float(np.abs(pc[leaf] - pp[leaf]).max())
            jit = float(np.abs(pj[leaf] - pc[leaf]).max())
            peak = float(np.abs(pp[leaf]).max())
            tol = max(1e-5 * peak, 2.0 * jit)
            print(f"    {leaf} after the step: max|card - CPU| {err:.4e} "
                  f"(tol {tol:.4e}: 1e-5 of max|param| {peak:.4e}, or "
                  f"twice the card's 1e-6 jitter {jit:.4e})", flush=True)
            check(err <= tol, f"imported {leaf}: {err} > {tol}")
            step[leaf] = (err, tol)
        rec["f32_step"] = step
        del pc, pj, pp

        # three steps at batch 32, f32 and mixed_bfloat16
        xs = rs.rand(IMPORT_STEPS * BATCH, *IMAGE).astype(np.float32) \
            .transpose(0, 3, 1, 2).copy()
        ys = rs.randint(0, 1000, (len(xs),)).astype(np.int32)
        fit = {}
        for policy in ("float32", "mixed_bfloat16"):
            losses, _, est = onnx_steps("cuda", proto, xs, ys,
                                        IMPORT_STEPS, policy)
            print(f"  {policy}: {IMPORT_STEPS} steps at batch {BATCH}, "
                  f"losses {[round(v, 5) for v in losses]}", flush=True)
            check(len(losses) == IMPORT_STEPS and
                  all(np.isfinite(v) for v in losses),
                  f"{policy} losses {losses}")
            from analytics_zoo_tpu_torch.pipeline.estimator import \
                MaxIteration
            print(f"  profile {policy} train, {IMPORT_STEPS} steps:",
                  flush=True)
            prof = profile_steps(
                lambda: est.train(xs, ys, batch_size=BATCH,
                                  end_trigger=MaxIteration(
                                      est.step + IMPORT_STEPS)),
                1, IMPORT_KERNEL_NAMES, per=IMPORT_STEPS)
            print(f"  {policy} step: {prof['wall_ms_per_step']:.2f} ms, "
                  f"device busy share {prof['device_busy_share']:.3f} on "
                  f"{card}", flush=True)
            fit[policy] = {"losses": losses, "profile": prof}
            del est
            torch.cuda.empty_cache()
        f32, bf = fit["float32"]["losses"][0], \
            fit["mixed_bfloat16"]["losses"][0]
        rel16 = abs(bf - f32) / abs(f32)
        print(f"  first loss bf16 {bf:.5f} vs f32 {f32:.5f}: rel "
              f"{rel16:.2e} (tol {TOL['bfloat16']})", flush=True)
        check(rel16 <= TOL["bfloat16"], f"bf16 loss {bf} vs f32 {f32}")
        rec["fit"] = fit
        import_others(card, rec, tmp)
    launches = all_launches()
    print(f"  launches in phase 23: {launches}", flush=True)
    check(not any(launches.values()),
          f"the import path launched a kernel of the eleven: {launches}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--fleet-worker"] and len(sys.argv) == 3:
        return fleet_worker(sys.argv[2])
    if sys.argv[1:2] == ["--artifact-worker"] and len(sys.argv) == 3:
        return artifact_worker(sys.argv[2])
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        ImageClassifier, resnet50)
    from analytics_zoo_tpu_torch.ops import conv_bn as cb
    from analytics_zoo_tpu_torch.ops import cuda_build
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    detail = {}

    print("[1] device", flush=True)
    card = card_line()
    print(card)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    detail["card"] = card

    print("[2] build", flush=True)
    t0 = time.perf_counter()
    # every library at once: one nvcc per source, all started together
    built = cuda_build.build(list(cb._SIGNATURES) + list(fa._SIGNATURES))
    print(f"  built {built} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    detail["build_s"] = built
    for name in built:
        # nvcc -Xptxas=-v's report, kept beside each library
        with open(cuda_build.library_path(name) + ".log") as f:
            log = f.read()
        regs = sorted({int(r) for r in
                       re.findall(r"Used (\d+) registers", log)})
        spills = sum(int(b) for b in
                     re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}: registers per thread {regs}, spill stores "
              f"{spills} bytes", flush=True)
        for warn in sorted(set(re.findall(r"\(C75\d\d\)[^\n]*", log))):
            print(f"    ptxas: {warn[:160]}", flush=True)
        for entry in log.split("Compiling entry function '")[1:]:
            fn = entry.split("'", 1)[0]
            if "_sm90_kernel" not in fn and "flash_decode_kernel" not in fn:
                continue
            used = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            print(f"    {fn}: {used.group(1) if used else '?'} registers,"
                  f" spill stores {spill.group(1) if spill else '?'} "
                  "bytes", flush=True)
            # the D-64 instances of the backward (BERT, GPT) spill nothing
            if re.search(r"flash_d\w*_sm90_kernelI.*Li64E", fn):
                check(spill is not None and int(spill.group(1)) == 0,
                      f"{fn} spills {spill.group(1) if spill else '?'} "
                      "bytes")
    # the flash kernels' route and tile per head dim and dtype, the
    # library's own answer against the wrapper's helpers
    for name in FWD + BWD:
        fwd = name in FWD
        route, tile, smem, on_card = (
            (fa.fwd_route, fa.fwd_tile, fa.fwd_smem, fa.fwd_config_on_card)
            if fwd else
            (fa.bwd_route, fa.bwd_tile, fa.bwd_smem, fa.bwd_config_on_card))
        for d in (32, 64, 128, 256):
            for dt in (torch.float32, torch.bfloat16):
                card_cfg = on_card(name, d, dt)
                want = (route(d, dt).startswith("wgmma"),
                        *tile(name, d, dt), smem(name, d, dt))
                print(f"  {name} D {d} {str(dt)[6:]}: route {route(d, dt)}, "
                      f"tile (warpgroups, rows{', keys' if fwd else ''}) "
                      f"{want[1:-1]}, shared memory {want[-1]} bytes",
                      flush=True)
                check(card_cfg == want, f"{name} D {d} {dt}: the library "
                      f"runs {card_cfg}, the wrapper expects {want}")

    # B11's lanes per key and keys per block iteration, the library's
    # own answer against the wrapper's plan
    for d in (32, 64, 128, 256):
        for kv in (torch.float32, torch.bfloat16, torch.int8):
            want = (fa.decode_lanes(d, kv), fa.decode_keys(d, kv))
            got = fa.decode_config_on_card(d, kv)
            check(got == want, f"flash_decode D {d} {kv}: the library runs "
                  f"{got} (lanes, keys per iteration), the plan expects "
                  f"{want}")
    print(f"  flash_decode plan at the path shape (S {GEN_SLOTS}, T {GEN_T}, "
          f"H 12, D 64): chunk, chunks = "
          f"{fa.decode_plan(GEN_SLOTS, 12, GEN_T, 64, torch.float32)}",
          flush=True)

    if sys.argv[1:] == ["--plane"]:
        # phase 19 alone, on the built libraries; no result line
        print("[19] the observability plane's judgement layer", flush=True)
        plane_path(card, detail)
        print(card)
        return 0
    if sys.argv[1:] == ["--nnframes"]:
        # phase 20 alone, on the built libraries; no result line
        print("[20] nnframes", flush=True)
        print(f"  {nnframes_path(card, detail)}", flush=True)
        print(card)
        return 0
    if sys.argv[1:] == ["--fleet"]:
        # phase 21 alone, on the built libraries; no result line
        print("[21] the serving fleet", flush=True)
        fleet_path(card, detail)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_fleet.json"),
                  "w") as f:
            json.dump(detail, f, indent=1, default=str)
        print(card)
        return 0
    if sys.argv[1:] == ["--artifact"]:
        # phase 22 alone, on the built libraries; no result line
        print("[22] artifacts and the native front end", flush=True)
        artifact_path(card, detail)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_artifact.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        print(card)
        return 0

    if sys.argv[1:] == ["--import"]:
        # phase 23 alone, on the built libraries; no result line
        print("[23] model import", flush=True)
        import_path(card, detail)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_import.json"), "w") as f:
            json.dump(detail, f, indent=1, default=str)
        print(card)
        return 0

    print("[3] kernels against their plain versions", flush=True)
    shapes_net = ImageClassifier("resnet-50", input_shape=IMAGE,
                                 classes=1000, fused=True).model
    shapes_net.init(torch.Generator().manual_seed(0))
    b5, b6 = path_shapes(shapes_net, BATCH)
    check(sum(b5.values()) == 36 and sum(b6.values()) == 16,
          f"ResNet-50 has {sum(b5.values())} 1x1 and {sum(b6.values())} "
          "3x3 folds per forward, expected 36 and 16")
    b1, b2 = train_shapes(shapes_net, TRAIN_BATCH)
    check(sum(b1.values()) == 36 and sum(b2.values()) == 16,
          f"ResNet-50 trains {sum(b1.values())} 1x1 and {sum(b2.values())} "
          "3x3 convs per step, expected 36 and 16")
    # the deferred stage layout: the same launches, 8 of its c1s (every
    # stage's blocks after the second) with the in_residual prologue
    defer_net = resnet50(input_shape=IMAGE, classes=1000,
                         space_to_depth=True, fused="defer")
    defer_net.init(torch.Generator().manual_seed(0))
    d1, d2 = train_shapes(defer_net, TRAIN_BATCH)
    deferred = {k: n for k, n in d1.items() if k[7]}
    print(f"  fused=\"defer\" per step: B1 {sum(d1.values())} launches "
          f"({sum(deferred.values())} with in_residual: {deferred}), B2 "
          f"{sum(d2.values())}", flush=True)
    check(sum(d1.values()) == 36 and sum(d2.values()) == 16 and
          sum(deferred.values()) == 8,
          f"the defer layout trains {sum(d1.values())} 1x1 "
          f"({sum(deferred.values())} with in_residual) and "
          f"{sum(d2.values())} 3x3 convs per step, expected 36 (8), 16")
    detail["defer_train_shapes"] = {"b1": [list(k) + [n] for k, n in
                                           sorted(d1.items())]}
    del defer_net
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = [run_case(c, gen) for c in kernel_cases(b5, b6)]
    records += [run_train_case(c, gen)
                for c in train_cases(b1, b2, deferred)]
    for c in flash_cases():
        records += run_flash_case(c, gen)
    records += [run_decode_case(c, gen) for c in decode_cases()]
    detail["kernel_cases"] = records
    tables = {}
    for kname, label in (("matmul_bn", "B1"), ("matmul_bn_dx", "B3")):
        print(f"  {label} {kname} per shape (bf16, train step, batch "
              f"{TRAIN_BATCH}):", flush=True)
        tables[kname] = shape_table(records, kname,
                                    lambda r: r["per_path"] > 0)
    for dt in ("bfloat16", "float32"):
        for bs in (1, 8, BATCH):
            print(f"  B5 matmul_bn_apply per shape ({dt} activations, f32 "
                  f"weights, serving batch {bs}):", flush=True)
            tables[f"matmul_bn_apply_{dt}_b{bs}"] = shape_table(
                records, "matmul_bn_apply",
                lambda r, bs=bs: r["key"][0] == bs and not r["prologue"]
                and r["w_dtype"] == "float32", dt)
    for bs in (1, 8, BATCH):
        print(f"  B6 conv3x3_bn_apply per shape (bf16, serving batch {bs}):",
              flush=True)
        tables[f"conv3x3_bn_apply_b{bs}"] = shape_table(
            records, "conv3x3_bn_apply",
            lambda r, bs=bs: r["key"][0] == bs and not r["prologue"])
    detail["shape_tables"] = tables
    del shapes_net
    torch.cuda.empty_cache()

    print("[4] main path: ResNet-50 serving", flush=True)
    launches = {}
    served = main_path(card, detail)
    torch.cuda.empty_cache()

    print("[5] main path: ResNet-50 training", flush=True)
    trained = train_path(card, detail)
    torch.cuda.empty_cache()

    print("[6] main path: BERT-base fine-tune and evaluate (f32 kernels)",
          flush=True)
    bert_est = bert_estimator_path(card, detail)

    print("[7] main path: BERT-base bench_bert steps (bf16 kernels)",
          flush=True)
    bert_bench = bert_bench_path(card, detail)
    torch.cuda.empty_cache()

    print("[8] main path: GPT-style generation (paged KV cache, "
          "continuous batcher, B11)", flush=True)
    generated, gen_im = generation_path(card, detail)
    gen_eng = gen_im.generator

    print("[9] flash/dense crossover (fwd+bwd, bf16, causal)", flush=True)
    crossover(card, detail)

    print("[10] decode crossover (B11 vs dense, f32)", flush=True)
    decode_crossover(card, detail)

    print("[11] recommendation: NeuralCF at bench_ncf.py's configuration "
          "and Wide&Deep (no kernel of the eleven on this path)", flush=True)
    embedding_trap(card, detail)
    ncf_path(card, detail)
    wide_and_deep_path(card, detail)
    torch.cuda.empty_cache()

    by_path = {"serve": served, "train": trained, "generate": generated}
    for name, meta in KERNELS.items():
        launches[name] = by_path.get(meta["path"], bert_est)[name]

    print("[12] the serving front end over HTTP: ResNet-50 (f32, bf16), "
          "bench_serving's tower (batched, per request, int8) and "
          "/generate", flush=True)
    over_http = http_path(card, detail, gen_im)
    del gen_im
    torch.cuda.empty_cache()

    print("[13] generation's capacity levers: chunked prefill, speculative "
          "decoding with a drafter, the prefill/decode handoff", flush=True)
    levers = levers_path(gen_eng, card, detail)
    del gen_eng
    torch.cuda.empty_cache()

    print("[14] the Estimator's training surface on bench.py's flagship "
          "step: validation, checkpoints and resume, clipping, summaries, "
          "profiling, the goodput ledger and FLOP count, the optimizers, "
          "the phase backward", flush=True)
    surface = surface_path(card, detail)

    print("[15] image classification: LeNet-5 on MNIST's stand-in, "
          "Inception-v1 serving, training and transfer learning, VGG-16/19, "
          "MobileNet v1/v2, DenseNet-121, SqueezeNet (no kernel of the "
          "eleven on this path)", flush=True)
    image_classification_path(card, detail)

    print("[16] text: TextClassifier (cnn, lstm, gru) at 20 Newsgroups' "
          "widths through the TextSet pipeline, KNRM, the AnomalyDetector "
          "(no kernel of the eleven on this path)", flush=True)
    text_path(card, detail)

    print("[17] Seq2seq at a production dialog model's widths (3 LSTM "
          "layers of 1024, 10,000 words) and SSD300-VGG16 object "
          "detection (no kernel of the eleven on this path)", flush=True)
    seq2seq_ssd_path(card, detail)

    print("[18] the image data path: ImageSet and the host transforms, "
          "FeatureSet's tiers, the recipe's augment on the card, "
          "examples/resnet_imagenet.py at full width, rdd_ingest and "
          "image_classification", flush=True)
    recipe = image_data_path(card, detail)

    print("[19] the observability plane's judgement layer: the SLO "
          "engine, metric history, capacity forecast, federation, the "
          "event log's rotation and /debug/slo, /debug/metrics/history, "
          "/debug/dashboard and /debug/profile on ResNet-50 and GPT-1 "
          "widths, then the training objectives on bench.py's flagship",
          flush=True)
    plane_served, plane_trained = plane_path(card, detail)

    print("[20] nnframes: NNClassifier.fit and transform of bench.py's "
          "flagship (BASELINE's nnframes ResNet-50 metric), the dogs-vs-cats "
          "app with Inception-v1 at 224, the recommendation apps and the "
          "slice's examples (bert_finetune at BERT-base widths)", flush=True)
    nnframes = nnframes_path(card, detail)

    print("[21] the serving fleet: two ResNet-50 replicas behind a "
          "FleetRouter (hash affinity, a kill, saturation), a canary "
          "rollout from a ModelRegistry, a fleet of worker processes with "
          "its collector, and disaggregated GPT-1 generation in process "
          "and over HTTP; apps/web_service_sample", flush=True)
    fleet = fleet_path(card, detail)

    print("[22] artifacts and the native front end: ResNet-50 (f32, bf16) "
          "exported, served by a second process from its artifact (B5/B6 "
          "as torch operators), rolled between registry versions, and "
          "behind the native C++ front end", flush=True)
    artifact = artifact_path(card, detail)

    print("[23] model import: ResNet-50 from an ONNX file served and "
          "fine-tuned (f32, bf16), the Caffe, BigDL and torch importers "
          "and the integer ONNX ops against the CPU (no kernel of the "
          "eleven on this path)", flush=True)
    imported = import_path(card, detail)

    print("[24] summary", flush=True)
    summary = kernels_summary(records, launches)
    for rec in summary:
        rec["launches_import"] = imported.get(rec["name"], 0)
        if artifact.get(rec["name"]):
            rec["launches_artifact"] = artifact[rec["name"]]
        if fleet.get(rec["name"]):
            rec["launches_fleet"] = fleet[rec["name"]]
        if plane_served.get(rec["name"]):
            rec["launches_plane"] = plane_served[rec["name"]]
        if plane_trained.get(rec["name"]):
            rec["launches_plane_train"] = plane_trained[rec["name"]]
        if nnframes.get(rec["name"]):
            rec["launches_nnframes"] = nnframes[rec["name"]]
        if recipe.get(rec["name"]):
            rec["launches_recipe"] = recipe[rec["name"]]
        if surface.get(rec["name"]):
            rec["launches_surface"] = surface[rec["name"]]
            # phase 14's cases at its path's shapes count in the worst
            # error too
            rec["max_abs_err_surface"] = max(
                r["max_abs_err"] for r in detail["surface"]["kernel_cases"]
                if r["kernel"] == rec["name"])
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     rec["max_abs_err_surface"])
        if rec["name"] in FLASH:
            rec["launches_bf16_path"] = bert_bench[rec["name"]]
        if over_http.get(rec["name"]):
            rec["launches_http"] = over_http[rec["name"]]
        if levers.get(rec["name"]):
            rec["launches_levers"] = levers[rec["name"]]
    detail["kernels"] = summary
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(detail, f, indent=1, default=str)
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
