#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``bigdl_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, one GPU

Phases (each raises on failure; the script exits 0 only if all pass):

  1. build    — compile every kernel of the port from ``bigdl_tpu_torch/csrc``
                with nvcc for sm_90a (one nvcc per source, all at once);
                print ptxas's registers and spills (a spill in K1, K2 or
                K3 fails) and the HMMA instructions of K1, K2 and K3 from
                ``cuobjdump -sass`` (a kernel without any fails).
  2. kernels  — each kernel against its plain PyTorch version on the card,
                on the same inputs, with the tolerance stated; times of the
                kernel, the plain version and one PyTorch library call,
                and the bound for the work at the main path's shape:
                K1 flash_fwd (ten cases, one with q/k/v one element into
                their storage so that the kernel takes 4-byte copies; the
                plain forward on TF32 must fail K1's f32 limit; f32 and
                bf16 times beside SDPA's and the split-TF32 floor); K2
                flash_bwd_dkv and K3 flash_bwd_dq (thirteen cases, three
                with q/k/v/do one or two elements into their storage, so
                that the kernels take 4-byte copies or the wrapper copies
                a bf16 operand below 4-byte alignment; the plain backward
                on TF32 must fail the f32 limit; two runs on the same
                inputs must give the same bits; f32 and bf16 times beside
                SDPA's backward and the split-TF32 floor); K4
                fused_adam (bitwise, Adam and AdamW: single leaves, all
                111 of base's leaf shapes in one launch, more leaves than
                one table holds, a leaf at a 4-byte offset, ragged tails,
                an empty leaf and channels-last conv gradients, with
                their launch counts; timed by events with the host, with
                the host queued ahead and cold, beside
                torch.optim.AdamW(fused=True) read the same ways, with
                the wrapper's host time by part); K5 fused_sgd_mom and K6
                fused_sgd_plain (bitwise, over every static choice:
                dampening, nesterov, weight decay; one leaf at a time,
                and trees of many leaves with their launch counts: six
                shapes in one launch, leaves at a 4-byte offset,
                channels-last conv gradients read in place, and more
                leaves than one launch's table holds).  K5, K6 and their
                library call are also timed on the device with a cold
                L2 (a 256 MB read before each call), beside the rate a
                plain copy reaches, back to back over two alternating
                trees (events beside CUPTI), and the profiler's raw device
                records of one cold call.  One SGD.update and one
                AdamW.update run under
                ``torch.cuda.set_sync_debug_mode("error")``: neither may
                synchronize the host.
  3. serving  — TransformerLM ``base`` (d_model 768, 12 layers, 6 heads of
                128, vocab 32000, fp32, weights from a seed) registered in
                a ``ModelRegistry`` and served by ``ServingEngine(max_batch=8)``
                to 12 requests of 1-5 rows of 512 tokens from 3 client
                threads.  Every answer is checked against the same model
                run directly on the card with the plain attention.  The
                launch counts show that every batch went through K1.
  4. decode   — the same ``base`` (fp32, TF32 off, seed 0) served token by
                token by ``DecodeEngine(slots=8, page_size=16,
                max_context=1024, max_prompt=512, max_new_tokens=64)``
                after a warmup of its 10 prefill buckets and its decode
                step: 16 greedy requests with prompts of 16-512 tokens
                from 3 client threads, half through ``stream()`` and half
                through ``submit()``.  Every output is the prompt + 64
                tokens, nothing runs a new shape after warmup, the pool
                ends empty and consistent, and no hand kernel launches
                (the reference's decode is XLA einsums, not Pallas).
                Every engine token is held against the contiguous cache
                (``init_cache`` + one ``apply_with_cache`` over the prompt
                and the engine's tokens, teacher-forced): its logit within
                the stated limit of the maximum logit.  Paged
                ``decode_tokens`` logits against the contiguous path's
                for 2 prompts over 16 steps (max
                |err| and whether the bits agree).  The same 16 requests
                again, submitted at once, with a pool of 96 of the 512
                pages: evictions and readmissions must happen, and every
                token must be bitwise the uncontended run's.  One ``generate_beam`` (beam 4, 2
                prompts of 64, 32 new tokens; scores against the
                sequences' log-probs) and one ``int8_kv=True`` engine run
                (relative logit drift of the paged path in (0, 0.05)).
                Readings: tokens/s, TTFT and inter-token p50/p99, the
                decode step (8 live slots) and each prefill bucket by the
                host clock, peak device memory, and the device's time by
                class and busy share over 2 steady steps.
  5. training — the same ``base`` trained by ``SpmdTrainer`` with
                ``AdamW(learning_rate=3e-4, fused=True)`` for 6 steps on
                one repeated batch of 8 x 512 tokens, and again from the
                same weights with the plain attention (forward and
                backward) and ``fused=False``.  Step-1 gradients and every
                step's loss of the two runs agree within the stated
                tolerance, the loss falls, and the launch counts show that
                each step ran K1, K2 and K3 once a layer and K4 once
                (one multi-tensor launch per table of
                fused_optim.ADAM_CAPACITY leaves).  The same steps with the matmuls on TF32 must fall
                outside the limits, so that the limits can see a drop
                below fp32.  Then the same ``base`` at
                ``dtype="bfloat16"`` (bf16 compute over fp32 parameters
                and Adam state) for the same steps on the kernels,
                counted from 0, against the plain attention with
                ``fused=False`` within the bf16 band (every loss within
                5e-3 relative, step-1 gradients within 5e-2 of each
                leaf's largest); its step, tokens/s and device time by
                class.
  6. stream   — train→serve on one card.  ``SpmdTrainer`` trains a fresh
                ``base`` (seed 0) with ``AdamW(learning_rate=3e-4,
                fused=True)`` on 8 x 512 random tokens while a
                ``WeightStreamPublisher(every_steps=4)`` ships owning
                device snapshots through a ``CanaryPublisher`` into a
                2-replica ``build_decode_replica_set`` of the same model
                (the engine of phase 4), which answers an open-loop
                ``steady`` trace (``serving.arrivals``, 4 requests/s for
                4 s, prompts of 16-512 tokens, 64 new tokens each)
                replayed against the wall clock.  A firing while a publish
                is in flight is skipped, as the stream is built to do; the
                trainer runs at least 12 steps, and on until 2 publishes
                have fired and every request has been answered (at most
                400 steps); then the last publish lands.  Checks: after 3 steps (K4 has
                written base in place) each replica's golden decode is
                bitwise its pre-training decode; >= 2 publishes; after the
                last, each replica's golden decode is bitwise that of an
                independent engine loaded with it; the set delivers every
                request exactly once (its own completions, counted) or it
                is shed with its reason, no client error, 0
                recompiles; the launches are exactly the trainer's K1-K4
                (the decode replicas launch none).  Then a NaN-poisoned
                publish must be rejected with a bitwise rollback; a
                ``serving.decode_step`` delay wedges one replica, which
                must be ejected, fail its requests over, have its late
                results dropped and be probed back in (by counts); and a
                2-replica ``build_replica_set`` of ``ServingEngine`` (K1)
                takes the trainer's last snapshot through a float canary
                (the drift gate), its logits within 1e-3 of base with the
                plain attention.  Readings: tokens/s, TTFT and inter-token
                p50/p99 through the set while training, the trainer's step
                beside phase 5's, the snapshot and publish times,
                skipped publishes, the card's busy share over 4 decode
                steps while both run, peak memory.
  7. classifier — ResNet-50 (ImageNet, NHWC, 1000 classes, full width and
                depth, fp32, weights from a seed) trained by
                ``LocalOptimizer`` with ``SGD(learning_rate=0.1,
                momentum=0.9, weight_decay=1e-4, fused=True)`` for 6 steps
                on one repeated batch of 64 synthetic 224x224x3 images,
                and again from the same weights with ``fused=False`` (twice,
                for the run-to-run noise) and with TF32 convolutions, which
                must fall outside the training phase's loss limit (2e-5);
                the fp32 runs must agree to the last bit.  K5 must launch
                once a step over all 161 leaves (one multi-tensor launch
                per table of fused_optim.SGD_CAPACITY leaves) and the loss
                must fall; K5 is also held bitwise on the model's own
                step-1 gradients, whose 17 channels-last conv gradients
                must be read in place (no copy).  Then LeNet-5 with
                ``SGD(learning_rate=0.05, fused=True)`` at batch 128 over
                512 images for 2 epochs on K6 (one launch a step over its
                8 leaves), against ``fused=False`` (bitwise).  cuDNN runs
                deterministic algorithms chosen without benchmarking.
  8. distri   — the reference's headline: the same ResNet-50 in bf16
                mixed precision (fp32 parameters and optimizer state) at
                batch 256, one epoch over 4 distinct synthetic batches.
                First the training BN (``_BNTrain``, the reference's
                closed-form backward) against autograd through the fp32
                formula at ResNet-50's widths, fp32 and bf16, and the peak
                memory of one step with the old BN and the new.  Then
                ``LocalOptimizer`` in bf16 at batch 64 and 256, K5 against
                ``fused=False`` (bitwise); bf16 against fp32 at batch 64
                within a band (a run without the input cast must fall
                below it); fp32 at batch 256 if it fits.  Then the main
                path, ``DistriOptimizer(mesh=create_mesh({"dp": 1}),
                fused_optim=True)`` over NCCL at world size 1 with
                ``set_mixed_precision()``, ``set_prefetch(2)`` and
                ``set_validation`` (every epoch, 512 held-out images,
                Top1/Top5/Loss), counted from 0: bitwise equal to
                LocalOptimizer's losses, weights and BN state; no batch
                read before its copy's event completed; validation equal
                to ``Evaluator.test`` and to numpy on ``Predictor``'s
                outputs.  dp without prefetch, fsdp, zero1 and 4 MB
                buckets must be bitwise too, and the bf16/fp16 wire finite
                within its limit; K5 launches exactly once a step in every
                run.  Readings: step medians and images/s, dp=1 beside
                LocalOptimizer, H2D per step with and without prefetch,
                the bf16 step's device time by class and under batch
                norm's forward and backward, peak memory, busy share.
                Also measured, changing nothing: cuDNN's training BN (``F.batch_norm``, bf16 input,
                fp32 statistics) against ``_BNTrain``, forward plus
                backward by CUDA events at ResNet-50's 53 BN shapes at
                b256, each with its error against the fp32 formula.
  9. recipe   — BigDL's ImageNet recipe from records on disk: 2048 training
                records (4 files) and 512 held out (1 file), each a 4-byte
                little-endian 1-based label and 256x256x3 uint8 BGR
                pixels from a seeded generator (labels 1..16, each with a
                stripe of its own), written to a temporary directory; the
                port's native runtime built by g++ from its own sources.
                Checks: the ring returns the plain reader's multiset of
                records; ``prepare_image_batch`` equals its plain version
                bitwise; ``DeviceAugment`` at the host transformers' draws
                equals BGRImgCropper -> HFlip -> BGRImgNormalizer bitwise
                (fp32, and bf16 as one rounding of it).  The same
                ResNet-50 (seed 0, an L2Regularizer(1e-4) on its Linear)
                through ``DistriOptimizer(mesh=create_mesh({"dp": 1}),
                fused_optim=True)`` over NCCL on ``FileRecordDataSet(...,
                n_workers=2) >> SampleToMiniBatch(256)`` (uint8 on the
                wire), ``set_prefetch(2)``, ``set_mixed_precision()``,
                ``set_device_augment(DeviceAugment(crop=(224, 224),
                flip=True, BGR mean/std, NHWC, bf16))``, ``SGD(0.1,
                momentum=0.9, weight_decay=1e-4)`` under
                ``SequentialSchedule(Warmup(0.0125), Poly(0.5, 8))``,
                clipping by the median norm of an unclipped epoch, and
                validation every epoch, for 2 epochs (16 steps), counted
                from 0: K5 once a step, each record once an epoch, each
                step's rate on the device equal to the closed form, the
                clipped norm <= c where clipping fired and the gradients
                untouched where it did not (both must happen), the loss
                finite and falling, validation (half the held-out labels
                the model's own classes) equal to ``Evaluator.test``.  One
                epoch with one worker, fused and plain, bitwise; 4 steps
                of accumulation 2 x 128 with the first stage frozen
                (bitwise unchanged, K5 once a step).  Readings: step
                median and images/s beside ``phase_distri``'s prefetch
                run, H2D of a uint8 and an fp32 batch, the host's ms a
                batch (ring pop, decode, batching), the ring's records/s,
                the native prep and the numpy chain a batch, the device's
                time by class with the augmentation's share and busy
                share over an epoch's first 2 steps, peak memory.
 10. vgg      — the rest of the nn shell.  (a) BigDL's VGG-16 for
                CIFAR-10 at the reference's benchmark setting
                (``bench.py`` ``bench_vgg16``): ``vgg.build(class_num=10,
                dataset="cifar10", format="NHWC", seed=0)`` with dropout,
                bf16 over fp32 masters, batch 512, ``SGD(0.1,
                momentum=0.9, weight_decay=1e-4, fused=True)`` through
                ``LocalOptimizer`` on synthetic CIFAR-10 (``data/cifar.py``,
                normalized) for one epoch of 6 steps with validation on 512
                held-out images, counted from 0: K5 once a step, bitwise
                the ``fused=False`` run at the same seed (the masks come
                from the loop's generator), another seed's losses differ,
                two evaluations give the same bits, the loss falls; one
                Dropout(0.4) on a 512x32x32x64 bf16 tensor zeroes
                0.4 +- 0.005 and keeps x / bf16(0.6) exactly.  (b) LeNet-5
                as a ``Graph`` against the ``Sequential`` (the same seed
                draws the same weights): 8 steps of the Torch-shell loop
                and 2 epochs of ``LocalOptimizer`` with ``SGD(fused=True)``
                (K6 once a step), each bitwise.  (c) ResNet-50 ImageNet
                NHWC bf16 b256 through ``DistriOptimizer`` at dp=1 over
                NCCL, 4 steps: A plain, B ``remat=True`` (bitwise A in
                losses, weights and BN state; peak memory below A's), C
                ``stem="s2d", remat=True, sync_bn_axis="dp"`` (within 2e-2
                of A at every step); K5 once a step.  Readings: VGG's step
                median, images/s, device time by class, busy share and
                peak memory; step and peak of A, B, C and B at b512.
 11. durable  — BigDL's durable training on ``phase_distri``'s main path
                (ResNet-50 ImageNet NHWC, seed 0, bf16 over fp32 masters,
                batch 256, ``DistriOptimizer(mesh=create_mesh({"dp": 1}),
                fused_optim=True)`` over NCCL, ``set_prefetch(2)``,
                ``SGD(0.1, momentum=0.9, weight_decay=1e-4)`` on K5, 2
                epochs of 4 steps over 1024 synthetic images) with
                ``set_checkpoint(dir, Trigger.several_iteration(4),
                keep_last=2, handle_preemption=True)``,
                ``set_telemetry(Recorder(sinks=[JsonlSink]), health=True)``,
                ``set_health(policy="rollback", flight_dir=...)``,
                ``set_auto_retry(1)`` and ``set_trace_context``; each run in
                a process of its own (``chip_smoke.py --durable-child``,
                the model built first, so its module names agree).  (a)
                the run with durability off, then on; (b) the same run
                sent SIGTERM once it printed iteration 4: it commits
                ``preempt_iter_<k>`` and exits 0, and a fresh process
                resumes it, bitwise (a) in parameters, momentum, BN state
                and the resumed steps' losses; (c) LeNet-5 with
                ``SGD(0.05, fused=True)`` on K6 killed by the checkpoint
                fault plane midway through a shard of its third
                checkpoint (exit 42): the resume falls back to the second
                and ends bitwise the uninterrupted run; (d) the same
                LeNet-5 with one NaN batch under ``policy="rollback"``:
                the sentinel trips there, one rollback, the iteration
                seen twice, finite losses after, one flight dump, the
                planned end.  K5 exactly once a step in every ResNet-50
                run, counted from 0.  Readings: the step median with
                durability off and on, ``checkpoint.blocking`` a save
                (device→host copy, writer backpressure), the writer's ms
                a checkpoint by part, MB a checkpoint, restore ms by
                part, the health scalars' device ms a step, host syncs a
                step, busy share and peak memory.
 12. lm_long  — the rest of TransformerLM training at ``long8k``'s width
                (d_model 1024, 8 heads of 128, vocab 32000, S 8192, bf16
                over fp32 parameters, weights from a seed).  With 2
                layers: (a) step-1 loss and gradients with the kernels
                against the plain attention, fp32 with TF32 off (phase 5's
                limits: 2e-5, 1e-4 of each leaf's largest) and bf16
                (5e-3 relative, 5e-2); (b) ``remat`` against no remat in
                bf16, bitwise (a leaf that does not repeat itself without
                remat, under deterministic algorithms, would be named and
                held to 1e-6 of its largest); (c) ``loss_chunk=1024``
                against the full loss in fp32 (1e-5 relative, 1e-4).
                (d) The main path: ``long8k`` at full depth (16 layers,
                remat, 334,005,248 parameters in 147 leaves) through
                ``SpmdTrainer(AdamW(3e-4, fused=True), loss_chunk=1024)
                .fit`` for 1 + 4 steps on one batch of 4 x 8192 tokens
                with a ``TrainSummary``, then ``evaluate`` on 2 batches
                with a ``ValidationSummary``, both read back with
                ``read_scalar``, counted from 0: K1 32, K2 16, K3 16 and
                K4 1 launches a step, K1 16 an evaluated batch; the loss
                falls.  Readings: step median, tokens/s, the share of the
                dense bf16 peak from the operations a token needs, peak
                memory, the device's time by class and busy share over 1
                profiled step, and K1-K4 at these shapes against their
                plain versions, beside SDPA forward and backward and
                ``torch.optim.AdamW(fused=True)``, with their bounds.
                (e) Durability on the reference recipe's own preset
                (``examples/transformer_spmd.py``: ``tiny``, remat,
                ``loss_chunk=32``, batch 2 x 64) with dropout 0.1 and
                seed 3, each run in a process of its own
                (``chip_smoke.py --lm-durable-child``): 12 steps
                uninterrupted (host syncs counted); checkpoints every 4
                steps, SIGTERM once the child prints step 6, and a
                resume, bitwise the uninterrupted run in parameters, Adam
                moments and the resumed losses; a NaN batch at step 6
                under ``policy="rollback"``: one rollback to step 4.
 13. predictor — BigDL's inference facade and int8 serving.  (a)
                ``examples/serving_predictor.py`` at its widths (SEQ 12,
                EMB 16, 32 filters, 3 classes, 512 synthetic documents):
                ``LocalOptimizer`` with ``Adam(2e-3, fused=True)`` for 4
                epochs (K4, one launch an update; a second identical run
                must end bitwise), ``PredictionService`` (the demo rows
                >= 3/4, 4 concurrent callers, logits within 1e-4 of the
                CPU's), then ``model.quantize(calibration_data=...)``
                behind a second service (the same labels; each
                QuantizedLinear's int32 accumulator bitwise its float64
                product).  (b) ResNet-50 (ImageNet, 224, 1000 classes,
                fp32 logits) in ``build_replica_set(int8_degrade=True)``
                with 2 replicas: every quantized layer's accumulator
                bitwise its float64 version, int8 logits within 0.05 of
                float, a forced brownout served by ``.int8``, a canary
                publish that refreshes ``.int8`` on both replicas, and
                float and int8 times at b32 with their profiles.  (c)
                TransformerLM ``base`` weight-only int8: bytes < 0.5x,
                greedy ``generate`` of 32 tokens, next-token agreement
                on the fp32 context >= 0.8 and the loss within 0.05,
                tokens/s and peak memory.  K4 and K1 against their plain
                versions at this path's shapes.
 14. spmd     — the composed dp×fsdp×tp×sp path on one card.  (a) ``base``
                through ``compose.build_trainer(ComposedConfig(
                "dp1,fsdp1,tp1,sp1"))`` with ``AdamW(fused=True)``
                over NCCL at world size 1 for 10 steps at phase 5's
                batch, K1–K4 launches counted from 0, bitwise against
                the one-device
                ``SpmdTrainer`` on the same weights.  (b) K1 and K2+K3 at
                the per-rank shapes of tp=2 (``base``: 8 × 3 × 512 × 128
                f32; ``long8k``: 1 × 4 × 8192 × 128 bf16, causal), and K4
                over one fsdp=2 and one zero1 dp=2 rank's local shards of
                ``base`` (bitwise).  (c) The ring's merge of two chunks at
                sp=2, in one process, at long8k's 1 × 8 × 8192 × 128 bf16
                causal, against K1.  (d) K4, K5 and K6 over a tree of f32
                and bf16 leaves at ``base``'s shapes, each bitwise, one
                launch per dtype, timed beside the plain update and the
                library's.
 15. pipeline_moe — the GPipe trainer and MoE on one card.  (a) ``base``
                through ``PipelineLMTrainer(mesh={"pp": 1},
                n_microbatches=4, fused_optim=True)`` with AdamW over
                NCCL at world size 1 for 6 steps at phase 5's batch,
                launches counted from 0 (K1–K3 once a block a
                microbatch: 288; K4 6), against the one-device
                ``SpmdTrainer`` on the same weights (loss and parameter
                bands), and with ``overlap_grad_chunks=2, clip_norm=1.0``
                against the same trainer on the plain attention and
                plain AdamW (LOSS_TOL a step).  (b) ``base`` with 8
                experts (``SwitchFFN``, top-2, capacity 1.25) through the
                one-device ``SpmdTrainer`` with ``AdamW(fused=True)``, 6
                steps (K1–K3 72, K4 6), against the plain run: routed
                freely (step 1's loss; the tokens whose top-k set flips
                and the loss gap each step, reported), and routed as the
                kernels' run routed (step 1's gradients a leaf, every
                step's loss); the aux term in the loss, the step time,
                tokens/s and peak memory.
 16. data_elastic — the sharded data plane, module files and the
                elastic supervisor.  (a) ``base`` at its widths with 4
                layers through ``SpmdTrainer``
                with ``AdamW(3e-4, fused=True)``, fed by
                ``ShardedRecordDataSet`` over 16 TFRecord shards x 512
                records of 513 int32 tokens written from a numpy seed (4
                workers, staging 2, ``HostToDevice`` on the staging
                thread), 8 steps at batch 8 x 512 with a manifest
                checkpoint at the end (and at the preemption) and the
                data cursor in it; each run
                in a process of its own
                (``chip_smoke.py --data-elastic-child``): uninterrupted,
                SIGTERM as batch 5 is pulled (``preempt_step_5``), and a
                resume: losses and parameters bitwise, record ids
                exactly once, K1 = K2 = K3 = 4 and K4 = 1 a step.
                Readings: step ms fed by the pipeline beside the same
                trainer fed from memory, ``data/input_stall_seconds`` a
                step, the pipeline's records/s alone, the device's busy
                share over 2 pipeline-fed steps (torch.profiler).
                (b) The trained model's module file (``save_module``),
                loaded in a fresh process (``load_module``) and served
                through ``ServingEngine`` (8 one-row requests): logits
                bitwise the trained model's served the same way, equal
                ``topology_dict``; MB, save s, load s.  (c)
                ``ElasticSupervisor`` at world size 1 over NCCL (``base``
                widths, 4 layers): uninterrupted, then SIGTERM after step
                4, a final checkpoint, replan ``{"dp": 1}``, resume:
                losses bitwise, ``elastic/*`` counters as the
                reference's, the ranks' launches K1 = K2 = K3 = 4 and K4
                = 1 a step.  (d) LeNet-5 through ``LocalOptimizer`` with
                ``SGD(0.05)`` (K6) on ``ShardedRecordDataSet(fmt=
                "fixed")``, SIGTERM as batch 6 is pulled and a resume:
                parameters bitwise, records exactly once.
 17. operate  — the read side of telemetry on the main path: ``base``
                (fp32, seed 0) at 8 x 512 through ``SpmdTrainer(AdamW(
                3e-4, fused=True))`` for 8 steps with ``set_telemetry``
                (a ``TensorBoardSink``, the first step's cost capture,
                the device-memory poller), ``set_health(stall_factor=1)``,
                ``set_trace_every(4)`` and ``serve_metrics``: /metrics
                and /healthz (200) scraped while it trains, the loop held
                after its last step until /healthz reads 503, /records
                read; the losses bitwise the same steps with telemetry
                off, the TensorBoard losses equal, the Chrome traces of
                steps 0 and 4 holding K1–K4 and the ``train_step``
                range, K1 = K2 = K3 = 96 and K4 = 8, the captured FLOPs
                within 2 % of the analytic count (attention included),
                ``perf/mfu`` against the specs table's H100 row.  Then a
                ``ServingEngine`` with ``serve_metrics`` answers 8
                requests: its /metrics request counter equals the
                engine's own, /trace parses as Chrome JSON.  Every server
                and watchdog stopped; no ``introspection:*`` thread left.

Before its last lines ``main()`` lists what still runs (threads other
than the main one that are not daemons, the servers' and watchdogs'
threads, child processes, an initialised ``torch.distributed`` group) and
fails if anything does.

Output: a ``{"slice": {...}}`` line, a ``{"decode": {...}}`` line, a
``{"training": {...}}`` line, a ``{"stream": {...}}`` line, a
``{"classifier": {...}}`` line, a ``{"distri": {...}}`` line, a
``{"recipe": {...}}`` line, a ``{"vgg": {...}}`` line, a
``{"durable": {...}}`` line, a ``{"lm_long": {...}}`` line, a
``{"host_sync": {...}}`` line, a ``{"predictor": {...}}`` line, a
``{"spmd": {...}}`` line, a ``{"pipeline_moe": {...}}`` line, a
``{"data_elastic": {...}}`` line, an ``{"operate": {...}}`` line, a
``{"phase_s": ...}`` line (each phase's seconds, ``total_s`` from after
CUDA's init and ``process_s`` from the process's start), a
``{"kernels": [...]}`` line (all six kernels; K1-K4 also with their
``long8k`` readings, K4-K6 with their ``bf16_leaves`` readings), the
card's name and power limit as nvidia-smi gives them, and
last ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repo, it exits with
another code and prints no result.

fp32 matmuls and convolutions run in full fp32: TF32 is switched off
explicitly for cuBLAS and cuDNN (the models' dtype is float32).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time
from typing import Optional

# the process's clock, before numpy's and torch's imports: main() logs the
# seconds since here beside total_s (which starts after CUDA's init)
PROCESS_T0 = time.monotonic()

import numpy as np  # noqa: E402
import torch  # noqa: E402

H100_FP32_FLOPS = 67e12       # data sheet, SXM, CUDA cores, 700 W
H100_BF16_FLOPS = 989e12      # data sheet, SXM, dense tensor cores, 700 W
H100_TF32_FLOPS = 495e12      # data sheet, SXM, dense tensor cores, 700 W
H100_HBM_BYTES_S = 3.35e12    # data sheet, SXM
N_REQUESTS, N_CLIENTS, SEQ = 12, 3, 512
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 6, 3e-4
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
KERNEL_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),
              torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
LSE_TOL = dict(rtol=1e-4, atol=1e-3)
# K2/K3 against the plain backward: both sum fp32 products, in another
# order, over up to 512 terms (gradients are O(1)-O(10) at these inputs);
# bf16 outputs are one bf16 rounding (8 bits of mantissa) of the sum.
# The f32 limits are about 20x the worst reading of a sound run; a TF32
# run of the plain version must read above them (see tf32 below).
BWD_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
           torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
# per gradient, max |d - d_plain| <= BWD_REL_TOL * max |d_plain|: for
# gradients far below 1 (those of a training step's mean loss)
BWD_REL_TOL = 1e-5
# kernel run against plain run of the training step (fp32, TF32 off): the
# attention differs by fp32 rounding only (~1e-6), which the 12 layers,
# the head and 6 AdamW steps carry into the loss (~10.9 at step 1, where
# one ulp is 9.5e-7).  Both limits are about 20x a sound run's reading
# and must fail a run with the model's matmuls on TF32.
GRAD_REL_TOL = 1e-4          # per leaf, max |dg| <= GRAD_REL_TOL * max |g|
LOSS_TOL = 2e-5              # |loss_kernel - loss_plain| per step


def log(msg: str) -> None:
    """One line, stamped with the seconds since the process started."""
    print(f"[chip_smoke {time.monotonic() - PROCESS_T0:.1f}s] {msg}",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def queued_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Device time per call of ``fn`` by CUDA events, with the host ahead:
    the card first spins for ~30 ms, in which the host queues all ``iters``
    calls, so the host's time between calls is not counted where it is
    the slower side (as :func:`cuda_ms` counts it)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10 * SPIN_CYCLES)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def attention_bound(b, h, sq, sk, d, causal, dtype):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (q, k, v read once, out and lse written once) over the HBM rate
    and the multiply-adds of the (q, k) pairs this mask attends (two
    products, 4·D operations a pair) over the peak rate of the dtype."""
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 4 * b * h * d * pairs
    item = torch.tensor([], dtype=dtype).element_size()
    nbytes = item * b * h * d * (2 * sq + 2 * sk) + 4 * b * h * sq
    peak = H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / H100_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def split_tf32_floor(b, h, sq, sk, d, causal):
    """The least time of the f32 forward on the tensor cores as K1 does
    it: three TF32 products for each fp32 one, at the TF32 peak."""
    flops = 4 * b * h * d * _pairs(sq, sk, causal)
    return 3 * flops / H100_TF32_FLOPS * 1e3


# --------------------------------------------------------------------- #
SOURCES = ("flash_fwd", "flash_bwd", "fused_adam", "fused_sgd")
MMA_SOURCES = ("flash_fwd", "flash_bwd")     # on the tensor cores


def phase_build():
    from bigdl_tpu_torch.ops import _build
    t0 = time.monotonic()
    libs = _build.build_all(SOURCES)
    secs = time.monotonic() - t0
    log(f"build: {secs:.1f} s")
    spills = []
    for name in SOURCES:
        for line in _build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling" in line):
                log(f"  ptxas [{name}]: {line.strip()}")
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            if (name in MMA_SOURCES and found
                    and found.groups() != ("0", "0")):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError(f"a tensor-core kernel spills registers: "
                             f"{spills}")
    for name in MMA_SOURCES:
        log(f"sass of {name}: {sass_mma_counts(libs[name], name)}")
    return secs


def sass_mma_counts(lib, name: str) -> dict:
    """``{kernel: HMMA instructions}`` in the SASS of a built library, from
    ``cuobjdump -sass``; raises if a kernel has none."""
    import shutil
    from pathlib import Path
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"cuobjdump": "not found"}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    if not counts or not all(counts.values()):
        raise AssertionError(f"{name}: a kernel without HMMA: {counts}")
    return counts


def _offset_view(shape, dtype, g, offset):
    """A contiguous randn tensor ``offset`` elements into its storage."""
    n = int(np.prod(shape))
    flat = torch.randn(n + offset, generator=g, device="cuda").to(dtype)
    return flat[offset:].view(*shape)


def _qkv(b, h, sq, sk, d, dtype, seed, layout="contig"):
    """q, k, v of shape (B, H, S, D).  ``layout``: "contig" (all three
    contiguous), "strided" (all three (B, S, H, D) storage seen as
    (B, H, S, D)), "main" (the model's own: RoPE hands q and k over
    contiguous, v is the strided view of its projection), "offset" or
    "offset2" (all three contiguous views one or two elements into their
    storage)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def one(s, strided):
        if layout in OFFSETS:
            return _offset_view((b, h, s, d), dtype, g, OFFSETS[layout])
        if strided:
            t = torch.randn((b, s, h, d), generator=g, device="cuda")
            return t.to(dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=g, device="cuda").to(dtype)
    qk_strided = layout == "strided"
    v_strided = layout in ("strided", "main")
    return (one(sq, qk_strided), one(sk, qk_strided), one(sk, v_strided))


OFFSETS = {"offset": 1, "offset2": 2}


def fwd_ok(out, lse, ref, ref_lse):
    """``out`` and ``lse`` within K1's limits of the plain forward's."""
    return bool(torch.isfinite(out.float()).all().item()
                and torch.allclose(out.float(), ref.float(),
                                   **KERNEL_TOL[ref.dtype])
                and torch.allclose(lse, ref_lse, **LSE_TOL))


def _compare(fa, q, k, v, causal):
    """flash_fwd against its plain version on one input:
    (max_abs_err, lse_max_abs_err, tolerance, ok, plain out and lse)."""
    out, lse = fa.flash_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_forward_plain(q, k, v, causal=causal)
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    return (err, lse_err, KERNEL_TOL[q.dtype],
            fwd_ok(out, lse, ref, ref_lse), (ref, ref_lse))


def tf32_fwd_reading(fa, q, k, v, causal, want):
    """The plain forward with its matmuls on TF32 tensor cores (one pass),
    read against K1's limits: a kernel that dropped below fp32 this way
    must fail them.  Returns (max_abs_err, lse_max_abs_err, passes)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out, lse = fa.flash_forward_plain(q, k, v, causal=causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ref, ref_lse = want
    return ((out.float() - ref.float()).abs().max().item(),
            (lse - ref_lse).abs().max().item(),
            fwd_ok(out, lse, ref, ref_lse))


def phase_kernels(card: str):
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    cases = [
        # (label, B, H, Sq, Sk, D, dtype, causal, layout)
        ("slice f32 causal", 8, 6, 512, 512, 128, torch.float32, True,
         "main"),
        ("slice bf16 causal", 8, 6, 512, 512, 128, torch.bfloat16, True,
         "main"),
        ("slice f32 causal, q/k/v all strided", 8, 6, 512, 512, 128,
         torch.float32, True, "strided"),
        ("f32 non-causal", 8, 6, 512, 512, 128, torch.float32, False,
         "contig"),
        ("ragged S=300 f32 causal", 2, 6, 300, 300, 128, torch.float32, True,
         "contig"),
        ("ragged S=300 bf16 non-causal", 2, 6, 300, 300, 128, torch.bfloat16,
         False, "contig"),
        ("head_dim 64 f32 causal", 4, 8, 512, 512, 64, torch.float32, True,
         "contig"),
        ("head_dim 64 bf16 ragged S=300 causal", 2, 4, 300, 300, 64,
         torch.bfloat16, True, "strided"),
        ("cross Sq=128 Sk=384 f32 causal", 2, 2, 128, 384, 128,
         torch.float32, True, "contig"),
        ("slice f32 causal, q/k/v one element into their storage", 8, 6,
         512, 512, 128, torch.float32, True, "offset"),
    ]
    results = []
    for i, (label, b, h, sq, sk, d, dt, causal, layout) in enumerate(cases):
        q, k, v = _qkv(b, h, sq, sk, d, dt, seed=100 + i, layout=layout)
        width = fa.copy_bytes(q, k, v)
        err, lse_err, tol, ok, want = _compare(fa, q, k, v, causal)
        case = {"case": label, "shape": [b, h, sq, sk, d],
                "dtype": str(dt).replace("torch.", ""), "causal": causal,
                "layout": layout, "copy_bytes": width, "max_abs_err": err,
                "lse_max_abs_err": lse_err, "tolerance": tol, "ok": ok}
        if i == 0:
            case["tf32"] = tf32_fwd_reading(fa, q, k, v, causal, want)
        results.append(case)
        log(f"kernel vs plain [{label}]: {width}-byte copies, max_abs_err "
            f"{err:.3e} (lse {lse_err:.3e}) tol {tol} -> "
            f"{'ok' if ok else 'FAIL'}")
        del want
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_fwd disagrees with its plain version: "
                             f"{bad}")
    widths = {r["copy_bytes"] for r in results}
    if widths != {4, 16}:
        raise AssertionError(f"flash_fwd cases took copy widths {widths}, "
                             f"not both 16 and 4 bytes")
    tf32_err, tf32_lse_err, tf32_passes = results[0]["tf32"]
    check_tf32_fails("K1 [slice f32 causal]",
                     {"max_abs_err": tf32_err, "lse_max_abs_err":
                      tf32_lse_err}, tf32_passes,
                     {"out": KERNEL_TOL[torch.float32], "lse": LSE_TOL})

    # times at the serving shape (B=8 bucket, H=6, S=512, D=128, causal)
    q, k, v = _qkv(8, 6, SEQ, SEQ, 128, torch.float32, seed=7, layout="main")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(lambda: fa.flash_forward(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: fa.flash_forward_plain(q, k, v, causal=True),
                       iters=5)
    library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    bf16_ms = cuda_ms(lambda: fa.flash_forward(qb, kb, vb, causal=True))
    bf16_library_ms = cuda_ms(lambda: sdpa(qb, kb, vb, is_causal=True))
    bound_ms, bound_by = attention_bound(8, 6, SEQ, SEQ, 128, True,
                                         torch.float32)
    tc_floor_ms = split_tf32_floor(8, 6, SEQ, SEQ, 128, True)
    bf16_bound, bf16_by = attention_bound(8, 6, SEQ, SEQ, 128, True,
                                          torch.bfloat16)
    log(f"flash_fwd f32 (8,6,512,128) causal: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}), split-TF32 tensor-core floor {tc_floor_ms:.4f} "
        f"ms; bf16 kernel {bf16_ms:.4f} ms, sdpa {bf16_library_ms:.4f} ms, "
        f"bound {bf16_bound:.4f} ms ({bf16_by}); {card}")
    main = results[0]
    return {"name": "flash_fwd", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "bigdl_tpu/ops/flash_attention.py:212",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "tolerance": main["tolerance"], "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_call": "torch.nn.functional.scaled_dot_product_attention"
                            "(is_causal=True), f32",
            "shape": [8, 6, SEQ, SEQ, 128], "dtype": "float32",
            "split_tf32_floor_ms": tc_floor_ms,
            "bf16_ms": bf16_ms, "bf16_bound_ms": bf16_bound,
            "bf16_library_ms": bf16_library_ms,
            "cases": results, "card": card}


# --------------------------------------------------------------------- #
def _pairs(sq, sk, causal):
    return sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk


def bwd_bounds(b, h, sq, sk, d, causal, dtype):
    """{kernel: (bound_ms, bound_by)} for K2 and K3: the larger of the
    bytes each must move (q, k, v, do, lse and delta read once, its
    gradients written once) over the HBM rate, and its multiply-adds over
    the attended pairs (K2: four products, 8·D operations a pair; K3:
    three, 6·D) over the peak rate of the dtype."""
    item = torch.tensor([], dtype=dtype).element_size()
    pairs = _pairs(sq, sk, causal) * b * h
    peak = H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
    qs, ks = b * h * sq * d * item, b * h * sk * d * item
    rows = 2 * 4 * b * h * sq
    out = {}
    for name, flops, nbytes in (
            ("flash_bwd_dkv", 8 * d * pairs, 2 * qs + 2 * ks + rows + 2 * ks),
            ("flash_bwd_dq", 6 * d * pairs, 2 * qs + 2 * ks + rows + qs)):
        t_ops = flops / peak * 1e3
        t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def _grad_out(q, layout, seed):
    """A random output gradient of q's shape; for the model's layouts it
    is the (B, S, H, D)-storage view autograd hands the backward."""
    b, h, s, d = q.shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    if layout in OFFSETS:
        return _offset_view(q.shape, q.dtype, g, OFFSETS[layout])
    if layout in ("main", "strided"):
        t = torch.randn((b, s, h, d), generator=g, device="cuda")
        return t.to(q.dtype).transpose(1, 2)
    return torch.randn((b, h, s, d), generator=g, device="cuda").to(q.dtype)


def grad_errors(got, want):
    """{name: (max |got - want|, max |want|)} for dq, dk, dv."""
    return {name: ((a.float() - r.float()).abs().max().item(),
                   r.float().abs().max().item())
            for name, a, r in zip(("dq", "dk", "dv"), got, want)}


def bwd_ok(got, want, errs, relative):
    """Finite and within BWD_TOL (allclose), or, when ``relative``, within
    BWD_REL_TOL of each gradient's own largest value."""
    if not all(torch.isfinite(a.float()).all().item() for a in got):
        return False
    if relative:
        return all(e <= BWD_REL_TOL * m for e, m in errs.values())
    tol = BWD_TOL[want[0].dtype]
    return all(torch.allclose(a.float(), r.float(), **tol)
               for a, r in zip(got, want))


def compare_bwd(fa, q, k, v, do, causal, relative=False):
    """K2 + K3 against the plain backward on one (q, k, v, out, lse, do):
    (max_abs_err over dq/dk/dv, {grad: (err, max |ref|)}, tolerance, ok,
    the plain backward's result)."""
    out, lse = fa.flash_forward_plain(q, k, v, causal=causal)
    got = fa.flash_backward(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    want = fa.flash_backward_plain(q, k, v, out, lse, do, causal=causal)
    errs = grad_errors(got, want)
    tol = ({"max_abs_err/max_abs_ref": BWD_REL_TOL} if relative
           else BWD_TOL[q.dtype])
    ok = bwd_ok(got, want, errs, relative)
    return max(e for e, _ in errs.values()), errs, tol, ok, want


def tf32_bwd_reading(fa, q, k, v, do, causal, want, relative=False):
    """The plain backward with its matmuls on TF32 tensor cores, read
    against the same limit as K2/K3: a variant that dropped below fp32
    this way must fail the check.  Returns (errors, passes_the_limit)."""
    out, lse = fa.flash_forward_plain(q, k, v, causal=causal)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = fa.flash_backward_plain(q, k, v, out, lse, do, causal=causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = grad_errors(got, want)
    return errs, bwd_ok(got, want, errs, relative)


def bwd_split_tf32_floors(b, h, sq, sk, d, causal):
    """{kernel: least time of the f32 backward on the tensor cores as K2
    and K3 do it}: three TF32 products for each fp32 one (K2 8·D
    operations a pair, K3 6·D), at the TF32 peak."""
    pairs = _pairs(sq, sk, causal) * b * h
    return {"flash_bwd_dkv": 3 * 8 * d * pairs / H100_TF32_FLOPS * 1e3,
            "flash_bwd_dq": 3 * 6 * d * pairs / H100_TF32_FLOPS * 1e3}


BWD_KERNELS = ("flash_bwd_dkv", "flash_bwd_dq")


def bwd_times(fa, q, k, v, do):
    """{kernel: ms} of K2 and K3 on one causal input, and what the library
    takes for dq, dk and dv: SDPA's backward alone, through autograd from
    one forward whose graph is kept; all by events with the host queued
    ahead.  (By cuda_ms, SDPA's forward + backward less its forward, or
    its backward alone, read 0.43 to 0.76 ms for f32 and 0.11 to 0.72 ms
    for bf16 on one H100: the host's time through autograd, not SDPA's.)"""
    out, lse = fa.flash_forward_plain(q, k, v, causal=True)
    call = fa._bwd_prepare(q, k, v, out, lse, do, fa._config(q, True, None))
    ms = {name: queued_ms(lambda n=name: fa._bwd_launch(call, n))
          for name in BWD_KERNELS}
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    o = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg,
                                                         is_causal=True)
    library_ms = queued_ms(lambda: torch.autograd.grad(
        o, (qg, kg, vg), do, retain_graph=True))
    return ms, library_ms, (out, lse)


def bwd_repeats_bitwise(fa, q, k, v, do):
    """K2 + K3 twice on the same inputs: the same bits (no atomics)."""
    out, lse = fa.flash_forward_plain(q, k, v, causal=True)
    first = fa.flash_backward(q, k, v, out, lse, do, causal=True)
    second = fa.flash_backward(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def phase_flash_bwd(card: str):
    """K2 and K3 against the plain backward, their repeatability, and
    their times."""
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    cases = [
        # (label, B, H, Sq, Sk, D, dtype, causal, layout)
        ("slice f32 causal", 8, 6, 512, 512, 128, torch.float32, True,
         "main"),
        ("slice bf16 causal", 8, 6, 512, 512, 128, torch.bfloat16, True,
         "main"),
        ("f32 non-causal", 8, 6, 512, 512, 128, torch.float32, False,
         "contig"),
        ("ragged S=300 f32 causal", 2, 6, 300, 300, 128, torch.float32, True,
         "contig"),
        ("ragged S=300 bf16 non-causal", 2, 6, 300, 300, 128, torch.bfloat16,
         False, "strided"),
        ("head_dim 64 f32 causal", 4, 8, 512, 512, 64, torch.float32, True,
         "contig"),
        ("head_dim 64 bf16 ragged S=300 causal", 2, 4, 300, 300, 64,
         torch.bfloat16, True, "strided"),
        ("cross Sq=128 Sk=384 f32 causal", 2, 2, 128, 384, 128,
         torch.float32, True, "contig"),
        ("cross Sq=384 Sk=128 f32 causal", 2, 2, 384, 128, 128,
         torch.float32, True, "contig"),
        ("cross Sq=200 Sk=328 bf16 non-causal", 2, 2, 200, 328, 64,
         torch.bfloat16, False, "contig"),
        ("slice f32 causal, q/k/v/do one element into their storage", 8, 6,
         512, 512, 128, torch.float32, True, "offset"),
        ("ragged S=300 bf16 causal, q/k/v/do one element into their "
         "storage (copied by the wrapper)", 2, 6, 300, 300, 128,
         torch.bfloat16, True, "offset"),
        ("ragged S=300 bf16 non-causal head_dim 64, q/k/v/do two elements "
         "into their storage", 2, 4, 300, 300, 64, torch.bfloat16, False,
         "offset2"),
    ]
    results = []
    for i, (label, b, h, sq, sk, d, dt, causal, layout) in enumerate(cases):
        q, k, v = _qkv(b, h, sq, sk, d, dt, seed=200 + i, layout=layout)
        do = _grad_out(q, layout, seed=300 + i)
        width = fa.bwd_copy_bytes(q, k, v, do)
        err, errs, tol, ok, want = compare_bwd(fa, q, k, v, do, causal)
        case = {"case": label, "shape": [b, h, sq, sk, d],
                "dtype": str(dt).replace("torch.", ""), "causal": causal,
                "layout": layout, "copy_bytes": width, "max_abs_err": err,
                "errors_and_max_ref": errs, "tolerance": tol, "ok": ok}
        if i == 0:
            case["tf32"], case["tf32_passes"] = tf32_bwd_reading(
                fa, q, k, v, do, causal, want)
        results.append(case)
        log(f"K2+K3 vs plain [{label}]: {width}-byte copies, max_abs_err "
            f"{err:.3e} (err, max|ref|) {errs} tol {tol} -> "
            f"{'ok' if ok else 'FAIL'}")
        del want
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_bwd disagrees with its plain version: "
                             f"{bad}")
    widths = {r["copy_bytes"] for r in results}
    if widths != {4, 16}:
        raise AssertionError(f"flash_bwd cases took copy widths {widths}, "
                             f"not both 16 and 4 bytes")
    check_tf32_fails("K2+K3 [slice f32 causal]", results[0]["tf32"],
                     results[0]["tf32_passes"], BWD_TOL[torch.float32])

    # times at the training shape (B=8, H=6, S=512, D=128, causal, f32)
    b, h, d = TRAIN_BATCH, 6, 128
    q, k, v = _qkv(b, h, SEQ, SEQ, d, torch.float32, seed=9, layout="main")
    do = _grad_out(q, "main", seed=10)
    bitwise = bwd_repeats_bitwise(fa, q, k, v, do)
    log(f"K2+K3 twice on the slice's f32 inputs: "
        f"{'the same bits' if bitwise else 'DIFFERENT bits'}")
    if not bitwise:
        raise AssertionError("K2+K3 are not deterministic")
    ms, library_ms, (out, lse) = bwd_times(fa, q, k, v, do)
    delta_ms = cuda_ms(lambda: (do.float() * out.float()).sum(-1))
    plain_ms = cuda_ms(lambda: fa.flash_backward_plain(q, k, v, out, lse, do,
                                                       causal=True), iters=5)
    bf16_ms, bf16_library_ms, _ = bwd_times(
        fa, *(t.to(torch.bfloat16) for t in (q, k, v, do)))
    bounds = bwd_bounds(b, h, SEQ, SEQ, d, True, torch.float32)
    floors = bwd_split_tf32_floors(b, h, SEQ, SEQ, d, True)
    bf16_bounds = bwd_bounds(b, h, SEQ, SEQ, d, True, torch.bfloat16)
    for name in BWD_KERNELS:
        log(f"{name} f32 ({b},{h},{SEQ},{d}) causal: {ms[name]:.4f} ms "
            f"(bound {bounds[name][0]:.4f} {bounds[name][1]}, split-TF32 "
            f"floor {floors[name]:.4f}); bf16 {bf16_ms[name]:.4f} ms "
            f"(bound {bf16_bounds[name][0]:.4f} {bf16_bounds[name][1]})")
    log(f"K2+K3 f32 {sum(ms.values()):.4f} ms, delta {delta_ms:.4f} ms, "
        f"plain backward {plain_ms:.4f} ms, SDPA backward {library_ms:.4f} "
        f"ms; bf16 K2+K3 {sum(bf16_ms.values()):.4f} ms, SDPA backward "
        f"{bf16_library_ms:.4f} ms; {card}")
    main = results[0]
    replaces = {"flash_bwd_dkv": "bigdl_tpu/ops/flash_attention.py:285",
                "flash_bwd_dq": "bigdl_tpu/ops/flash_attention.py:325"}
    return [{"name": name, "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": replaces[name], "launches": None,
             "max_abs_err": main["max_abs_err"],
             "tolerance": main["tolerance"], "ms": ms[name],
             "kernel_ms": ms[name], "plain_ms": plain_ms,
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
             "split_tf32_floor_ms": floors[name],
             "library_ms": library_ms,
             "library_call": "autograd.grad of torch.nn.functional."
                             "scaled_dot_product_attention(is_causal=True)'s"
                             " output, its graph kept: the backward alone, "
                             "f32",
             "plain_and_library_cover": "dq, dk and dv (K2 and K3 "
                                        "together, delta included)",
             "bf16_ms": bf16_ms[name], "bf16_bound_ms": bf16_bounds[name][0],
             "bf16_library_ms": bf16_library_ms,
             "repeat_bitwise": bitwise,
             "delta_ms": delta_ms, "shape": [b, h, SEQ, SEQ, d],
             "dtype": "float32", "cases": results, "card": card}
            for name in BWD_KERNELS]


def check_tf32_fails(what, reading, passes, limit):
    """The check has teeth only if a TF32 variant fails it."""
    log(f"tf32 variant of {what}: {reading} against {limit} -> "
        f"{'passes (the check cannot see TF32)' if passes else 'fails'}")
    if passes:
        raise AssertionError(f"{what}: the limit {limit} does not tell a "
                             f"TF32 run from fp32: {reading}")


# --------------------------------------------------------------------- #
def _ulps(a, b):
    """Largest distance in units in the last place between two f32
    tensors of one sign pattern (0 when bitwise equal)."""
    ai, bi = a.view(torch.int32).long(), b.view(torch.int32).long()
    return int((ai - bi).abs().max().item()) if a.numel() else 0


def _preset_shapes(preset):
    """The shapes of a TransformerLM preset's leaves, in the order of its
    parameter dict (built on the meta device: no weights)."""
    from bigdl_tpu_torch.models import transformer as T
    with torch.device("meta"):
        model = T.TransformerLM(T.TransformerConfig(**T.PRESETS[preset]),
                                torch.Generator().manual_seed(0))
    return [tuple(p.shape) for sub in model.param_dict().values()
            for p in sub.values()]


def _adam_trees(fo, kw, p0s, g0s, m0s, v0s):
    """The fused update (the kernel) and the plain one over one tree of
    leaves, on copies of (p0s, m0s, v0s) at their offsets, with the
    gradients g0s as they are: ([p, m, v] kernel, [p, m, v] plain, the
    kernel's launches), each of p, m and v all the tree's leaves end to
    end."""
    out, launches = [], None
    for fn in (fo.fused_adam_update, fo.fused_adam_update_plain):
        ps, ms, vs = ({f"l{i}": _copy_at(t) for i, t in enumerate(ts)}
                      for ts in (p0s, m0s, v0s))
        gs = {f"l{i}": t for i, t in enumerate(g0s)}
        before = fo._build.launch_counts().get(fo.KERNEL_NAME, 0)
        fn(ps, gs, ms, vs, **kw)
        torch.cuda.synchronize()
        if launches is None:
            launches = fo._build.launch_counts().get(fo.KERNEL_NAME, 0) \
                - before
        out.append([torch.cat([t.flatten() for t in tree.values()])
                    for tree in (ps, ms, vs)])
    return out[0], out[1], launches


def _adam_tree_cases(fo):
    """The trees of phase_adam: (label, shapes, float offset of each leaf
    from a 16-byte boundary, channels-last gradients, launches).  Each
    leaf's p, g, m and v lie at its offset."""
    cap = fo.ADAM_CAPACITY
    cl = [(512, 512, 3, 3), (64, 3, 7, 7)]
    lm = {name: _preset_shapes(name) for name in ("tiny", "base", "long8k")}
    return [
        ("n=1", [(1,)], [0], False, 1),
        ("n=127", [(127,)], [0], False, 1),
        ("n=768", [(768,)], [0], False, 1),
        ("n=3072*768", [(3072 * 768,)], [0], False, 1),
        (f"TransformerLM base's {len(lm['base'])} leaves", lm["base"], None,
         False, 1),
        (f"{cap + 1} leaves (capacity {cap})",
         [(int(n),) for n in np.random.RandomState(8).randint(
             1, 301, size=cap + 1)], None, False, 2),
        ("a leaf at a 4-byte offset", [(768,), (1_000_003,)], [0, 1], False,
         1),
        ("n % 4 != 0 (ragged tails)", [(4099,), (3,), (4097 * 3,)], None,
         False, 1),
        ("an empty leaf", [(0,), (768,)], None, False, 1),
        ("channels-last 3x3 and 7x7 conv gradients", cl, None, True, 1),
        *((f"TransformerLM {name}'s {len(lm[name])} leaves", lm[name],
           None, False, 1) for name in ("tiny", "long8k")),
    ]


def phase_adam(card: str):
    """K4 against the plain update, bitwise, on Adam and AdamW at steps 1
    and 1000: single leaves of 1, 127, 768 and 3072*768 values, all the
    leaf shapes of TransformerLM tiny, base and long8k (147 leaves, 334 M
    values) in one call each, more leaves than one
    table holds (two launches), a leaf at a 4-byte offset (the scalar
    path), ragged tails, an empty leaf (skipped) and channels-last conv
    gradients (read in place), each with its launch count."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.optim import Adam, AdamW
    results = []
    gen = torch.Generator(device="cuda")
    for method in (Adam(learning_rate=1e-3, fused=True),
                   AdamW(learning_rate=TRAIN_LR, fused=True)):
        for step in (1, 1000):
            state = {"step": torch.tensor(step - 1, dtype=torch.int32,
                                          device="cuda")}
            kw = method.update_scalars(state)
            for i, (case, shapes, shifts, channels_last, want) in \
                    enumerate(_adam_tree_cases(fo)):
                gen.manual_seed(step * 100 + i)
                shifts = shifts or [0] * len(shapes)

                def rnd(shape, scale, shift):
                    """randn of ``shape`` at ``shift`` floats past an
                    aligned address."""
                    n = int(np.prod(shape))
                    base = torch.randn(n + shift, generator=gen,
                                       device="cuda")
                    return base[shift:].mul_(scale).view(shape)
                p0s, g0s, m0s, v0s = ([rnd(s, scale, k) for s, k in
                                       zip(shapes, shifts)]
                                      for scale in (0.05, 1e-2, 1e-3, 1e-3))
                v0s = [t.square_() for t in v0s]
                if channels_last:
                    g0s = [t.contiguous(memory_format=torch.channels_last)
                           for t in g0s]
                leaves = [leaf for leaf in zip(p0s, g0s, m0s, v0s)
                          if leaf[0].numel()]
                tables, kept = fo.leaf_tables(leaves, fo.KERNEL_NAME,
                                              ("p", "m", "v"))
                meta = _meta_rows(tables)
                plan = {"tables": len(tables),
                        "scalar_path": int((meta[:, 4] == 0).sum()),
                        "channels_last_in_place": int((meta[:, 2] > 0)
                                                      .sum()),
                        "copies": len(kept)}
                del tables, kept, leaves
                kern, plain, launches = _adam_trees(fo, kw, p0s, g0s, m0s,
                                                    v0s)
                del p0s, g0s, m0s, v0s
                ulps = {name: _ulps(a, b) for name, a, b in
                        zip(("p", "m", "v"), kern, plain)}
                err = max(((a - b).abs().max().item() if a.numel() else 0.0)
                          for a, b in zip(kern, plain))
                ok = all(torch.equal(a, b) for a, b in zip(kern, plain))
                want_plan = (want, want, sum(1 for k in shifts if k),
                             len(shapes) if channels_last else 0, 0)
                planned = (launches, plan["tables"], plan["scalar_path"],
                           plan["channels_last_in_place"], plan["copies"])
                label = f"{type(method).__name__} step {step} {case}"
                results.append({"case": label, "max_abs_err": err,
                                "ulps": ulps, "bitwise": ok,
                                "launches": launches,
                                "launches_expected": want, **plan,
                                "ok": ok and planned == want_plan})
                log(f"K4 vs plain [{label}]: max_abs_err {err:.3e} ulps "
                    f"{ulps}, {launches} launch(es), plan {plan} -> "
                    f"{'bitwise' if ok else 'FAIL'}"
                    f"{'' if planned == want_plan else f'; expected {want_plan}'}")
                del kern, plain
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"fused_adam is not bitwise equal to its plain "
                             f"version, or did not launch as planned: "
                             f"{bad}")
    # a leaf the kernel does not take (fp16; bf16 leaves have their own
    # instantiation, phase_spmd (d)) raises on the card, before any launch
    xb = torch.ones(8, dtype=torch.float16, device="cuda")
    before = fo._build.launch_counts().get(fo.KERNEL_NAME, 0)
    try:
        fo.fused_adam_update({"x": xb}, {"x": xb}, {"x": xb.clone()},
                             {"x": xb.clone()}, **kw)
    except NotImplementedError as e:
        log(f"K4 on an fp16 leaf raises: {e}")
    else:
        raise AssertionError("fused_adam took an fp16 leaf on the card")
    if fo._build.launch_counts().get(fo.KERNEL_NAME, 0) != before \
            or not torch.equal(xb, torch.ones_like(xb)):
        raise AssertionError("fused_adam touched an fp16 leaf it refused")
    torch.cuda.empty_cache()
    return {"name": "fused_adam", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/fused_adam.cu",
            "replaces": "bigdl_tpu/kernels/fused_optim.py:124",
            "launches": None, "max_abs_err": max(r["max_abs_err"]
                                                 for r in results),
            "tolerance": "bitwise", "cases": results, "card": card}


def time_adam(k4: dict, leaves, card: str):
    """K4, its plain version and torch.optim.AdamW(fused=True) over leaves
    of the shapes of ``leaves`` (all of the model's), one update each: by
    CUDA events with the host (``cuda_ms``), with the host queued ahead
    (``queued_ms``), cold on the device (``cold_ms``: events and CUPTI),
    with the launches an update makes and the wrapper's host time by
    part."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.optim import AdamW
    shapes = [tuple(p.shape) for p in leaves]
    n = sum(int(np.prod(s)) for s in shapes)
    g = torch.Generator(device="cuda").manual_seed(11)
    tree = {f"l{i}": {"w": torch.randn(s, generator=g, device="cuda") * 0.05}
            for i, s in enumerate(shapes)}
    grads = {k: {"w": torch.randn_like(v["w"]) * 1e-2}
             for k, v in tree.items()}
    method = AdamW(learning_rate=TRAIN_LR, fused=True)
    state = method.init_state(tree)
    kw = method.update_scalars(state)
    m, v = state["m"], state["v"]

    def kernel_run():
        fo.fused_adam_update(tree, grads, m, v, **kw)
    before = fo._build.launch_counts().get(fo.KERNEL_NAME, 0)
    kernel_run()
    per_update = fo._build.launch_counts().get(fo.KERNEL_NAME, 0) - before
    ms = cuda_ms(kernel_run, iters=10)
    q_ms = queued_ms(kernel_run, iters=10)
    cold = cold_ms(kernel_run, "fused_adam_kernel")
    plain_ms = cuda_ms(lambda: fo.fused_adam_update_plain(tree, grads, m, v,
                                                          **kw), iters=3)
    # the wrapper's host time, part by part (the launch is the rest)
    trs = (tree, grads, m, v)
    flat = fo.zip_leaves(*trs)
    in_place = ("p", "m", "v")
    (ptrs, meta, count), = fo.leaf_tables(flat, fo.KERNEL_NAME, in_place)[0]
    fn = fo._adam_fn()
    stream = torch.cuda.current_stream().cuda_stream
    args = (*(kw[k].data_ptr() for k in ("clr", "bc1", "bc2")), 0.9, 0.1,
            0.999, 0.001, 1e-8, 0.01, 1, stream)

    def c_call():
        fn(ptrs.buffer_info()[0], meta.buffer_info()[0], count, *args)
    host = {"update": _host_us(kernel_run, 50),
            "zip_leaves": _host_us(lambda: fo.zip_leaves(*trs)),
            "f32_check": _host_us(lambda: fo._kernel_takes(flat,
                                                           fo.KERNEL_NAME)),
            "leaf_tables": _host_us(lambda: fo.leaf_tables(
                flat, fo.KERNEL_NAME, in_place)),
            "c_call_and_launch": _host_us(c_call, 20, idle=True)}
    torch.cuda.synchronize()
    del flat, ptrs, meta
    params = [t["w"].clone().requires_grad_() for t in tree.values()]
    for p_, gt in zip(params, (t["w"] for t in grads.values())):
        p_.grad = gt
    ref = torch.optim.AdamW(params, lr=TRAIN_LR, weight_decay=0.01,
                            fused=True)
    library_ms = cuda_ms(ref.step, iters=10)
    library_queued_ms = queued_ms(ref.step, iters=10)
    library_cold = cold_ms(ref.step, "adam")
    del ref, tree, grads, m, v, params
    torch.cuda.empty_cache()
    bound_ms = n * 28 / H100_HBM_BYTES_S * 1e3
    log(f"fused_adam over {len(shapes)} leaves, {n} params: {per_update} "
        f"launch(es) an update; kernel {ms:.4f} ms by events, queued "
        f"{q_ms:.4f} ms, cold {cold}; plain {plain_ms:.4f} ms; "
        f"torch.optim.AdamW(fused) {library_ms:.4f} ms by events, queued "
        f"{library_queued_ms:.4f} ms, cold {library_cold}; bound "
        f"{bound_ms:.4f} ms (bytes); host µs {host}; {card}")
    k4.update(ms=ms, kernel_ms=ms, queued_ms=q_ms, device_cold=cold,
              plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
              library_ms=library_ms, library_queued_ms=library_queued_ms,
              library_cold=library_cold,
              library_call="torch.optim.AdamW(fused=True).step(), f32",
              leaves=len(shapes), params=n,
              launches_per_update=per_update, host_us=host)


# --------------------------------------------------------------------- #
def phase_slice(card: str):
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    from bigdl_tpu_torch.ops.flash_attention import flash_forward_plain
    from bigdl_tpu_torch.serving import ModelRegistry, ServingEngine

    t0 = time.monotonic()
    model = T.build("base", device="cuda", seed=0)
    cfg = model.cfg
    n_layers = cfg.n_layers
    reg = ModelRegistry()
    reg.register("lm", model, input_shape=(SEQ,), dtype=np.int32)
    eng = ServingEngine(reg, max_batch=8)
    log(f"model built on {reg.get('lm').device}: {cfg}, "
        f"{sum(p.numel() for p in model.parameters())} params, "
        f"{time.monotonic() - t0:.1f} s")

    rs = np.random.RandomState(0)
    rows = rs.randint(1, 6, N_REQUESTS)
    xs = [rs.randint(0, cfg.vocab_size, (int(n), SEQ)).astype(np.int32)
          for n in rows]
    results = [None] * N_REQUESTS
    errors = []

    def client(c):
        try:
            for i in range(c, N_REQUESTS, N_CLIENTS):
                results[i] = eng.submit("lm", xs[i]).result(timeout=300)
        except Exception as e:   # reported below, fails the phase
            errors.append(repr(e))

    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from 0, warmup included
    fa.reset_launch_count()
    t_w = time.monotonic()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t_w
    warm_launches = fa.launch_count()
    t_s = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(N_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.monotonic() - t_s
    launches = fa.launch_count()
    st = eng.stats()
    eng.shutdown(drain=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serving failed: {errors}")
    n_buckets = len(eng.ladder)
    if warm_launches != n_layers * n_buckets:
        raise AssertionError(f"warmup launched flash_fwd {warm_launches} "
                             f"times, expected {n_layers} x {n_buckets}")
    if st["recompiles"] != 0 or st["errors"] != 0:
        raise AssertionError(f"serving stats: {st}")
    served = launches - warm_launches
    if served != n_layers * st["batches"] or st["batches"] < 1:
        raise AssertionError(f"flash_fwd launched {served} times after "
                             f"warmup for {st['batches']} batches; expected "
                             f"{n_layers} per batch")

    # every answer against the same model with the plain attention; the
    # first layer's q, k, v of the largest request are kept, to hold the
    # kernel against its plain version on exactly what the model hands it
    captured = {}

    def plain_attention(q, k, v):
        return flash_forward_plain(q, k, v, causal=True)[0]

    def plain_attention_capture(q, k, v):
        if q.shape[0] == int(rows.max()) and not captured:
            captured.update(q=q.clone(memory_format=torch.preserve_format),
                            k=k.clone(memory_format=torch.preserve_format),
                            v=v.clone(memory_format=torch.preserve_format))
        return plain_attention(q, k, v)

    for blk in model.blocks:
        blk.attn.attention_fn = plain_attention
    model.blocks[0].attn.attention_fn = plain_attention_capture
    worst = 0.0
    with torch.inference_mode():
        params = model.param_dict()
        for i, (x, y) in enumerate(zip(xs, results)):
            if y.shape != (len(x), SEQ, cfg.vocab_size):
                raise AssertionError(f"request {i}: shape {y.shape}")
            got = torch.from_numpy(y).cuda()
            if not torch.isfinite(got).all():
                raise AssertionError(f"request {i}: non-finite logits")
            want, _ = model.run(params, torch.from_numpy(x).cuda())
            worst = max(worst, (got - want).abs().max().item())
            if not torch.allclose(got, want, **MODEL_TOL):
                raise AssertionError(f"request {i}: served logits differ "
                                     f"from the plain-attention run by "
                                     f"{worst:.3e}")
            results[i] = None
    for blk in model.blocks:
        blk.attn.attention_fn = None
    q, k, v = captured["q"], captured["k"], captured["v"]
    with torch.inference_mode():
        err, lse_err, tol, ok, _ = _compare(fa, q, k, v, causal=True)
    layer_case = {"case": "served layer 0 q/k/v",
                  "shape": [q.shape[0], q.shape[1], SEQ, SEQ, q.shape[3]],
                  "dtype": "float32", "causal": True,
                  "strides": [list(t.stride()) for t in (q, k, v)],
                  "max_abs_err": err, "lse_max_abs_err": lse_err,
                  "tolerance": tol, "ok": ok}
    log(f"kernel vs plain [served layer 0 q/k/v, strides "
        f"{layer_case['strides']}]: max_abs_err {err:.3e} (lse "
        f"{lse_err:.3e}) tol {tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_fwd disagrees with its plain version on "
                             "the served layer's q, k, v")
    del captured, q, k, v

    # where a full batch's time goes (after the counts were read)
    with torch.inference_mode():
        x8 = torch.from_numpy(
            rs.randint(0, cfg.vocab_size, (8, SEQ)).astype(np.int32)).cuda()
        fwd_ms = cuda_ms(lambda: model.run(params, x8), iters=5, warm=1)
        y8, _ = model.run(params, x8)
        d2h_ms = cuda_ms(lambda: y8.cpu(), iters=3, warm=1)
        pinned = torch.empty(y8.shape, dtype=y8.dtype, pin_memory=True)
        pinned_d2h_ms = cuda_ms(lambda: pinned.copy_(y8), iters=3, warm=1)
        del y8, pinned
    breakdown = {"forward_ms_b8": fwd_ms, "d2h_pageable_ms_b8": d2h_ms,
                 "d2h_pinned_ms_b8": pinned_d2h_ms,
                 "execute_span_s": eng.recorder.span_value("serving.execute")}
    tokens = int(rows.sum()) * SEQ
    out = {"requests": N_REQUESTS, "rows": int(rows.sum()),
           "batches": int(st["batches"]), "batch_fill": st.get("batch_fill"),
           "recompiles": int(st["recompiles"]), "warmup_s": warm_s,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "p50_ms": st.get("p50_ms"), "p99_ms": st.get("p99_ms"),
           "launches": launches, "launches_after_warmup": served,
           "max_abs_err_vs_plain": worst, "tolerance": MODEL_TOL,
           "peak_mem_gb": peak_gb, "breakdown": breakdown,
           "layer_case": layer_case, "card": card}
    log(f"slice: {json.dumps(out)}")
    return out


# --------------------------------------------------------------------- #
KERNEL_CLASSES = (("flash_fwd", "K1 flash_fwd"),
                  ("flash_bwd_dkv", "K2 flash_bwd_dkv"),
                  ("flash_bwd_dq", "K3 flash_bwd_dq"),
                  ("fused_adam_kernel", "K4 fused_adam"),
                  ("gemm", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"),
                  ("reduce", "reductions"), ("elementwise", "elementwise"))


def _device_us(ev):
    if getattr(ev, "is_user_annotation", False):
        # a range the profiler draws on the GPU's track (for example
        # torch.optim's "Optimizer.step#SGD.step"), not device work: it
        # spans the kernels it holds, which count on their own
        return 0.0
    us = getattr(ev, "device_time_total", None)
    if us is None:
        us = getattr(ev, "cuda_time_total", 0.0)
    return us if ev.device_type == torch.autograd.DeviceType.CUDA else 0.0


def profile_steps(run_steps, steps: int = 2, classes=KERNEL_CLASSES,
                  top: int = 0, ranges=()):
    """Device time by kernel class, the device records (kernels and
    copies) a step and the device's busy share over ``run_steps()``, which
    runs ``steps`` steps, from torch.profiler (CUPTI); with ``top``, also
    the ``top`` kernels by device time; with ``ranges``, the device time
    of the kernels launched under each host range of that exact name (an
    autograd Function's forward and backward, for example)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_steps()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_class, by_name, device_us, records = {}, {}, 0.0, 0
    by_range = {}
    for ev in prof.key_averages():
        if ev.key in ranges:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = getattr(ev, "cuda_time_total", 0.0)
            by_range[ev.key] = by_range.get(ev.key, 0.0) + total / 1e3 / steps
        us = _device_us(ev)
        if not us:
            continue
        device_us += us
        records += ev.count
        name = ev.key.lower()
        cls = next((c for key, c in classes if key in name), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us / 1e3 / steps
        by_name[ev.key[:120]] = us / 1e3 / steps
    if device_us == 0.0:
        log("profile: the profiler saw no device time (not measured)")
        return None
    busy = device_us / 1e3 / wall_ms
    out = {"steps": steps, "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": device_us / 1e3 / steps,
           "device_records_per_step": records / steps,
           "device_busy_share": busy,
           "device_ms_by_class": dict(sorted(by_class.items(),
                                             key=lambda kv: -kv[1]))}
    if top:
        out["top_kernels_ms_per_step"] = dict(sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top])
    if ranges:
        out["device_ms_by_range"] = by_range
    log(f"profile: {json.dumps(out)}")
    return out


L2_FLUSH_BYTES = 256 << 20   # read before each cold call: > 5x the 50 MB L2
SPIN_CYCLES = 6_000_000      # ~3 ms at the H100's clock: the host gets ahead


def cold_ms(fn, key: Optional[str] = None, iters: int = 10) -> dict:
    """Device time of one call of ``fn`` with a cold L2.  Before each call
    the card spins (so that the host queues the rest ahead of the card)
    and then reads a 256 MB buffer, which evicts every line the previous
    call left in L2 (writing back the dirty ones) and leaves only clean
    lines there.  ``events_ms``: median by CUDA events around the call.
    With ``key``, also ``profiler_ms``: the device time per call of the
    kernels whose name holds ``key``, from torch.profiler (CUPTI), and
    ``records``, the kernel records it saw.  What the call leaves dirty in
    L2 when it ends is written back outside its time, as in any kernel
    timing: at most 50 MB."""
    from torch.profiler import ProfilerActivity, profile
    buf = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    out = torch.empty((), device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for e0, e1 in pairs:
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.sum(buf, dim=0, out=out)
            e0.record()
            fn()
            e1.record()
        torch.cuda.synchronize()
    res = {"events_ms": float(np.median([e0.elapsed_time(e1)
                                         for e0, e1 in pairs]))}
    if key is not None:
        evs = [ev for ev in prof.key_averages()
               if key in ev.key.lower() and _device_us(ev)]
        res["profiler_ms"] = (sum(map(_device_us, evs)) / 1e3 / iters
                              if evs else None)
        res["records"] = sum(ev.count for ev in evs)
    del buf
    return res


def device_ms(fns, key: str, iters: int = 6) -> dict:
    """Time per call of ``fns`` (a callable, or a list of callables run in
    turn, so that consecutive calls can touch disjoint bytes), back to
    back after one warm call of each: ``cupti_ms``, the device time of the
    kernels whose name holds ``key`` from torch.profiler (CUPTI; None when
    it saw none), and ``events_ms``, CUDA events around the same calls."""
    from torch.profiler import ProfilerActivity, profile
    fns = fns if isinstance(fns, (list, tuple)) else [fns]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e0.record()
        for i in range(iters):
            fns[i % len(fns)]()
        e1.record()
        torch.cuda.synchronize()
    us = sum(_device_us(ev) for ev in prof.key_averages()
             if key in ev.key.lower())
    return {"cupti_ms": us / 1e3 / iters if us else None,
            "events_ms": e0.elapsed_time(e1) / iters}


def kernel_records(fn, key: str) -> dict:
    """One call of ``fn`` with a cold L2 (as :func:`cold_ms` makes it)
    under torch.profiler: the raw device records it saw (name, stream,
    start and end in µs), and for the records whose name holds ``key``
    the sum of their durations (annotations left out), the span from the
    first start to the last end and what ``key_averages()`` makes of them,
    beside CUDA events around the call."""
    from torch.profiler import ProfilerActivity, profile
    buf = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    out = torch.empty((), device="cuda")
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.sum(buf, dim=0, out=out)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
    del buf
    recs = sorted(({"name": ev.name, "stream": getattr(
                        ev, "device_resource_id", None),
                    "annotation": getattr(ev, "is_user_annotation", None),
                    "start_us": ev.time_range.start,
                    "end_us": ev.time_range.end}
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: r["start_us"])
    mine = [r for r in recs if key in r["name"].lower()
            and not r["annotation"]]
    for r in recs:
        r["name"] = r["name"][:60]
    avg_us = sum(_device_us(ev) for ev in prof.key_averages()
                 if key in ev.key.lower())
    return {"events_ms": e0.elapsed_time(e1),
            "records_sum_ms": sum(r["end_us"] - r["start_us"]
                                  for r in mine) / 1e3,
            "records_span_ms": (mine[-1]["end_us"] - mine[0]["start_us"])
            / 1e3 if mine else None,
            "key_averages_ms": avg_us / 1e3, "records": recs}


def phase_training(card: str, k4: dict):
    """SpmdTrainer on base: the kernel run (counted), the plain run from
    the same weights, step-1 gradients of both, and the breakdown."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    from bigdl_tpu_torch.optim import AdamW, make_accum_grads
    from bigdl_tpu_torch.parallel import SpmdTrainer

    t0 = time.monotonic()
    model = T.build("base", device="cuda", seed=0)
    cfg = model.cfg
    params = model.param_dict()
    leaves = [p for sub in params.values() for p in sub.values()]
    w0 = [p.detach().clone() for p in leaves]
    n_leaves = len(leaves)
    log(f"training model built: {n_leaves} leaves, "
        f"{sum(p.numel() for p in leaves)} params, "
        f"{time.monotonic() - t0:.1f} s")
    rs = np.random.RandomState(1)
    ids = rs.randint(0, cfg.vocab_size, (TRAIN_BATCH, SEQ + 1)).astype(
        np.int32)
    tokens, targets = ids[:, :-1], ids[:, 1:]
    tok_d = torch.from_numpy(tokens).cuda()
    tgt_d = torch.from_numpy(targets).cuda()

    def set_attention(fn):
        for blk in model.blocks:
            blk.attn.attention_fn = fn

    def plain_attention(q, k, v):
        return fa.flash_attention_plain(q, k, v, causal=True)

    captured = {}

    def capture_attention(q, k, v):
        captured.update(q=q.detach().clone(
            memory_format=torch.preserve_format),
            k=k.detach().clone(memory_format=torch.preserve_format),
            v=v.detach().clone(memory_format=torch.preserve_format))
        o = plain_attention(q, k, v)
        o.register_hook(lambda g: captured.update(
            do=g.detach().clone(memory_format=torch.preserve_format)))
        return o

    grads_fn = make_accum_grads(
        lambda p, st, x, y: (model.loss(p, x, y, training=True), st), 1)

    # step-1 gradients: kernels against the plain attention
    (loss_k, _), g_k = grads_fn(params, {}, tok_d, tgt_d)
    set_attention(plain_attention)
    model.blocks[0].attn.attention_fn = capture_attention
    (loss_p, _), g_p = grads_fn(params, {}, tok_d, tgt_d)
    set_attention(None)

    def worst_rel_diff(g_a):
        worst_rel, worst_leaf = 0.0, None
        for name, sub in g_p.items():
            for pname, gp in sub.items():
                ga = g_a[name][pname]
                if not torch.isfinite(ga).all():
                    raise AssertionError(f"non-finite gradient "
                                         f"{name}.{pname}")
                rel = ((ga - gp).abs().max() /
                       gp.abs().max().clamp(min=1e-30)).item()
                if rel > worst_rel:
                    worst_rel, worst_leaf = rel, f"{name}.{pname}"
        return worst_rel, worst_leaf

    worst_rel, worst_leaf = worst_rel_diff(g_k)
    log(f"step-1 gradients, kernels vs plain attention: loss "
        f"{loss_k.item():.6f} vs {loss_p.item():.6f}; worst leaf "
        f"{worst_leaf} max|dg|/max|g| {worst_rel:.3e} (tol {GRAD_REL_TOL})")
    if worst_rel > GRAD_REL_TOL:
        raise AssertionError(f"step-1 gradients differ: {worst_leaf} "
                             f"{worst_rel:.3e}")
    del g_k
    # the same kernel step with the model's matmuls on TF32 tensor cores
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        (loss_t, _), g_t = grads_fn(params, {}, tok_d, tgt_d)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_rel, tf32_leaf = worst_rel_diff(g_t)
    del g_t, g_p
    check_tf32_fails("step-1 gradients", {"worst_leaf": tf32_leaf,
                                          "max_rel_diff": tf32_rel},
                     tf32_rel <= GRAD_REL_TOL, GRAD_REL_TOL)

    # K2/K3 on exactly what layer 0 of a training step hands them: its
    # gradients are far below 1, so each is held relative to its own size
    q, k, v, do = (captured[n] for n in ("q", "k", "v", "do"))
    err, errs, tol, ok, want = compare_bwd(fa, q, k, v, do, causal=True,
                                           relative=True)
    tf32_errs, tf32_passes = tf32_bwd_reading(fa, q, k, v, do, True, want,
                                              relative=True)
    layer_case = {"case": "training layer 0 q/k/v/do",
                  "shape": [q.shape[0], q.shape[1], SEQ, SEQ, q.shape[3]],
                  "dtype": "float32", "causal": True,
                  "strides": [list(t.stride()) for t in (q, k, v, do)],
                  "max_abs_err": err, "errors_and_max_ref": errs,
                  "tolerance": tol, "ok": ok, "tf32": tf32_errs,
                  "tf32_passes": tf32_passes}
    log(f"K2+K3 vs plain [training layer 0 q/k/v/do, strides "
        f"{layer_case['strides']}]: max_abs_err {err:.3e} (err, max|ref|) "
        f"{errs} tol {tol} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_bwd disagrees with its plain version on "
                             "the training layer's q, k, v, do")
    check_tf32_fails("K2+K3 [training layer 0]", tf32_errs, tf32_passes, tol)
    del captured, q, k, v, do, want

    # the main path: counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    _build.reset_launch_counts()
    trainer = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR, fused=True))
    losses_k, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t_s = time.monotonic()
        losses_k.append(trainer.step(tokens, targets))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t_s)
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses_k = [float(x) for x in losses_k]
    want = {"flash_fwd": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            # one K4 launch an update per table of ADAM_CAPACITY leaves
            "fused_adam": -(-n_leaves // fo.ADAM_CAPACITY) * TRAIN_STEPS}
    got = {name: launches.get(name, 0) for name in want}
    log(f"training launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"training launches {got}, expected {want}")

    # the same steps from the same weights on the plain versions
    def restore_weights():
        with torch.no_grad():
            for p_, w in zip(leaves, w0):
                p_.copy_(w)
    restore_weights()
    set_attention(plain_attention)
    plain_trainer = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR,
                                             fused=False))
    losses_p = [float(plain_trainer.step(tokens, targets))
                for _ in range(TRAIN_STEPS)]
    set_attention(None)
    if _build.launch_counts() != launches:
        raise AssertionError("the plain run launched a kernel")
    diffs = [abs(a - b) for a, b in zip(losses_k, losses_p)]
    log(f"losses kernels {losses_k}; plain {losses_p}; max |diff| "
        f"{max(diffs):.3e} (tol {LOSS_TOL})")
    if not all(np.isfinite(losses_k + losses_p)):
        raise AssertionError("non-finite loss")
    if max(diffs) > LOSS_TOL:
        raise AssertionError(f"kernel and plain runs differ: {diffs}")
    if not losses_k[-1] < losses_k[0]:
        raise AssertionError(f"loss did not fall: {losses_k}")
    del plain_trainer

    # the kernel run again with the model's matmuls on TF32 (after the
    # counts were read): the loss limit must tell it from fp32
    restore_weights()
    del w0
    tf32_trainer = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR,
                                            fused=True))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        losses_t = [float(tf32_trainer.step(tokens, targets))
                    for _ in range(TRAIN_STEPS)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    tf32_diffs = [abs(a - b) for a, b in zip(losses_t, losses_p)]
    check_tf32_fails("the losses", {"max_diff": max(tf32_diffs),
                                    "diffs": tf32_diffs},
                     max(tf32_diffs) <= LOSS_TOL, LOSS_TOL)
    del tf32_trainer

    # where a step's time goes (after the counts were read)
    state = trainer.opt_state
    opt = trainer.optim

    def part_times():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = model.loss(params, tok_d, tgt_d, training=True)
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
        ev[2].record()
        it = iter(grads)
        tree = {n: {k: next(it) for k in sub} for n, sub in params.items()}
        opt.update(tree, params, state)
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    parts = [part_times() for _ in range(3)]
    fwd_ms, bwd_ms, opt_ms = (float(np.median([p[i] for p in parts]))
                              for i in range(3))
    profile = profile_steps(lambda: [trainer.step(tokens, targets)
                                     for _ in range(2)])
    time_adam(k4, leaves, card)
    step_ms = float(np.median(step_s)) * 1e3
    out = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq": SEQ,
           "tokens_per_step": TRAIN_BATCH * SEQ,
           "step_ms_median": step_ms,
           "step_ms": [x * 1e3 for x in step_s],
           "tokens_per_s": TRAIN_BATCH * SEQ / (step_ms / 1e3),
           "losses": losses_k, "losses_plain": losses_p,
           "max_loss_diff": max(diffs), "loss_tol": LOSS_TOL,
           "grad_max_rel_diff": worst_rel, "grad_worst_leaf": worst_leaf,
           "grad_rel_tol": GRAD_REL_TOL, "launches": got,
           "tf32": {"grad_max_rel_diff": tf32_rel, "grad_worst_leaf":
                    tf32_leaf, "step1_loss": loss_t.item(),
                    "losses": losses_t, "max_loss_diff": max(tf32_diffs)},
           "peak_mem_gb": peak_gb, "resident_before_gb": resident_gb,
           "breakdown_ms": {"forward": fwd_ms, "backward": bwd_ms,
                            "optimizer": opt_ms},
           "profile": profile,
           "layer_case": layer_case, "card": card}
    log(f"training: {json.dumps(out)}")
    del trainer, model, params, leaves, state
    torch.cuda.empty_cache()
    return out

TRAIN_BF16_LOSS_REL = 5e-3      # bf16 kernels vs plain attention, a step
TRAIN_BF16_GRAD_REL = 5e-2      # step-1 gradients, per leaf


def phase_training_bf16(card: str):
    """ROADMAP A2's measure-first reading: the same ``base`` at
    ``dtype="bfloat16"`` (bf16 compute over fp32 parameters and Adam
    state), SpmdTrainer with ``AdamW(fused=True)`` for TRAIN_STEPS steps
    on phase 5's batch, counted from 0, against the same steps with the
    plain attention and ``fused=False`` within the bf16 band; step-1
    gradients too; the step's device time by class."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer
    model = T.build("base", device="cuda", seed=0, dtype="bfloat16")
    cfg = model.cfg
    params = model.param_dict()
    leaves = [p for sub in params.values() for p in sub.values()]
    w0 = [p.detach().clone() for p in leaves]
    rs = np.random.RandomState(1)
    ids = rs.randint(0, cfg.vocab_size, (TRAIN_BATCH, SEQ + 1)).astype(
        np.int32)
    tokens, targets = ids[:, :-1], ids[:, 1:]
    tok_d, tgt_d = (torch.from_numpy(a).cuda() for a in (tokens, targets))
    loss_k, g_k = _lm_grads(model, tok_d, tgt_d)
    loss_p, g_p = _lm_grads(model, tok_d, tgt_d, plain=True)
    grad_rel, grad_leaf = _worst_leaf(g_k, g_p)
    del g_k, g_p
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    trainer = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR, fused=True))
    losses_k, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t_s = time.monotonic()
        losses_k.append(trainer.step(tokens, targets))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t_s)
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses_k = [float(x) for x in losses_k]
    want = {"flash_fwd": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dkv": cfg.n_layers * TRAIN_STEPS,
            "flash_bwd_dq": cfg.n_layers * TRAIN_STEPS,
            "fused_adam": -(-len(leaves) // fo.ADAM_CAPACITY) * TRAIN_STEPS}
    got = {name: launches.get(name, 0) for name in want}
    profile = profile_steps(lambda: [trainer.step(tokens, targets)
                                     for _ in range(2)],
                            classes=LONG_CLASSES)
    with torch.no_grad():
        for p_, w in zip(leaves, w0):
            p_.copy_(w)
    del w0
    for blk in model.blocks:
        blk.attn.attention_fn = lambda q, k, v: fa.flash_attention_plain(
            q, k, v, causal=True)
    plain = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR, fused=False))
    losses_p = [float(plain.step(tokens, targets))
                for _ in range(TRAIN_STEPS)]
    for blk in model.blocks:
        blk.attn.attention_fn = None
    rel = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p)]
    step_ms = float(np.median(step_s)) * 1e3
    out = {"dtype": "bfloat16", "steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
           "seq": SEQ, "step_ms_median": step_ms,
           "step_ms": [x * 1e3 for x in step_s],
           "tokens_per_s": TRAIN_BATCH * SEQ / (step_ms / 1e3),
           "losses": losses_k, "losses_plain": losses_p,
           "loss_rel_diff_max": max(rel), "loss_rel_tol": TRAIN_BF16_LOSS_REL,
           "step1_loss": loss_k.item(), "step1_loss_plain": loss_p.item(),
           "grad_max_rel_diff": grad_rel, "grad_worst_leaf": grad_leaf,
           "grad_rel_tol": TRAIN_BF16_GRAD_REL, "launches": got,
           "peak_mem_gb": peak_gb, "profile": profile, "card": card}
    log(f"training bf16: {json.dumps(out)}")
    if got != want:
        raise AssertionError(f"bf16 training launches {got}, expected "
                             f"{want}")
    if not (all(np.isfinite(losses_k + losses_p))
            and max(rel) <= TRAIN_BF16_LOSS_REL
            and grad_rel <= TRAIN_BF16_GRAD_REL
            and losses_k[-1] < losses_k[0]):
        raise AssertionError(f"bf16 training outside its band: {out}")
    del trainer, plain, model, params, leaves
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------- #
SGD_CONFIGS = (
    # (label, SGD keywords without weight decay); K5 when momentum > 0
    ("K5 momentum 0.9, dampening 0.9 (default)", dict(momentum=0.9)),
    ("K5 momentum 0.9, dampening 0", dict(momentum=0.9, dampening=0.0)),
    ("K5 nesterov", dict(momentum=0.9, dampening=0.0, nesterov=True)),
    ("K6", dict()),
)
SGD_SHAPES = ((1,), (127,), (768,), (3072 * 768,), (64, 3, 7, 7),
              (2048, 512, 1, 1))


def _copy_at(t):
    """A contiguous copy of ``t`` at ``t``'s offset from a 16-byte
    boundary (a fresh tensor is aligned; a view need not be)."""
    shift = (t.data_ptr() % 16) // t.element_size()
    base = torch.empty(t.numel() + shift, dtype=t.dtype, device=t.device)
    out = base[shift:].view(t.shape)
    out.copy_(t)
    return out


def _sgd_trees(fo, method, clr, p0s, g0s, v0s):
    """The fused update (the kernel) and the plain one of ``method`` over
    one tree of leaves, on copies of (p0s, v0s) at their offsets, with
    the gradients g0s as they are: ([p, v] kernel, [p, v] plain, the
    kernel's launches), each p and v all the tree's leaves end to end."""
    kw = dict(clr=clr, momentum=method.momentum,
              dampening=method.dampening, nesterov=method.nesterov,
              weight_decay=method.weight_decay)
    name = fo.SGD_MOM if method.momentum > 0 else fo.SGD_PLAIN
    out, launches = [], None
    for fn in (fo.fused_sgd_update, fo.fused_sgd_update_plain):
        ps = {f"l{i}": _copy_at(t) for i, t in enumerate(p0s)}
        vs = {f"l{i}": _copy_at(t) for i, t in enumerate(v0s)}
        gs = {f"l{i}": t for i, t in enumerate(g0s)}
        before = fo._build.launch_counts().get(name, 0)
        fn(ps, gs, vs if method.momentum > 0 else None, **kw)
        torch.cuda.synchronize()
        if launches is None:
            launches = fo._build.launch_counts().get(name, 0) - before
        out.append([torch.cat([t.flatten() for t in tree.values()])
                    for tree in (ps, vs)])
    return out[0], out[1], launches


def _meta_rows(tables):
    """fused_optim.leaf_tables' meta of every leaf, one row a leaf: n,
    first chunk, I and H*W of a channels-last gradient, float4 flag."""
    return np.concatenate([np.asarray(m).reshape(-1, 5)
                           for _, m, _ in tables])


def _sgd_tree_cases(fo, rnd):
    """The multi-leaf trees of phase_sgd: (label, p0s, g0s, v0s, leaves
    that must take the scalar path, leaves whose channels-last gradient
    is read in place, launches)."""
    cap = fo.SGD_CAPACITY
    p_off = [rnd((1_000_003,), 0.05, 1), rnd((768,), 0.05),
             rnd((127,), 0.05, 1)]
    cl = [(512, 512, 3, 3), (64, 3, 7, 7)]
    sizes = np.random.RandomState(5).randint(1, 301, size=2000)
    return [
        ("six SGD_SHAPES in one tree", [rnd(s, 0.05) for s in SGD_SHAPES],
         [rnd(s, 1e-2) for s in SGD_SHAPES],
         [rnd(s, 1e-3) for s in SGD_SHAPES], 0, 0, 1),
        ("4-byte offsets (two of three leaves)", p_off,
         [rnd(t.shape, 1e-2, 1 if t.data_ptr() % 16 else 0)
          for t in p_off],
         [rnd(t.shape, 1e-3, 1 if t.data_ptr() % 16 else 0)
          for t in p_off], 2, 0, 1),
        ("channels-last 3x3 and 7x7 conv gradients",
         [rnd(s, 0.05) for s in cl],
         [rnd(s, 1e-2).contiguous(memory_format=torch.channels_last)
          for s in cl], [rnd(s, 1e-3) for s in cl], 0, 2, 1),
        (f"{len(sizes)} leaves of 1-300 values (capacity {cap})",
         [rnd((int(n),), 0.05) for n in sizes],
         [rnd((int(n),), 1e-2) for n in sizes],
         [rnd((int(n),), 1e-3) for n in sizes], 0, 0,
         -(-len(sizes) // cap)),
    ]


def _bitwise(label, kern, plain, results):
    ulps = {name: _ulps(a, b) for name, a, b in zip(("p", "v"), kern, plain)}
    err = max((a - b).abs().max().item() for a, b in zip(kern, plain))
    ok = all(torch.equal(a, b) for a, b in zip(kern, plain))
    results.append({"case": label, "max_abs_err": err, "ulps": ulps,
                    "bitwise": ok, "ok": ok})
    log(f"SGD kernel vs plain [{label}]: max_abs_err {err:.3e} ulps {ulps}"
        f" -> {'bitwise' if ok else 'FAIL'}")
    return results[-1]


def phase_sgd(card: str):
    """K5 and K6 against the plain update, bitwise: momentum with the
    reference's default dampening, dampening 0 and nesterov (K5), none
    (K6); weight decay 0 and 1e-4.  One leaf at a time: sizes 1, 127,
    768, 3072*768 and ResNet-50's (64, 3, 7, 7) and (2048, 512, 1, 1),
    steps 1 and 1000 (a per-step learning-rate decay makes clr differ).
    Then trees of many leaves, with their launch counts: the six shapes
    in one launch; leaves at a 4-byte offset (the scalar path); conv
    leaves whose gradient is channels-last (read in place, no copy); and
    more leaves than one table holds (ceil(leaves / capacity) launches)."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.optim import SGD
    results = {fo.SGD_MOM: [], fo.SGD_PLAIN: []}
    for label, kw in SGD_CONFIGS:
        for wd in (0.0, 1e-4):
            method = SGD(learning_rate=0.1, learning_rate_decay=1e-4,
                         weight_decay=wd, **kw)
            kernel = fo.SGD_MOM if method.momentum > 0 else fo.SGD_PLAIN
            for step in (1, 1000):
                clr = method.get_learning_rate({"step": torch.tensor(
                    step - 1, dtype=torch.int32, device="cuda")})
                for i, shape in enumerate(SGD_SHAPES):
                    g = torch.Generator(device="cuda").manual_seed(
                        step * 10 + i)

                    def rnd(scale):
                        return torch.randn(shape, generator=g,
                                           device="cuda") * scale
                    p0, g0, v0 = rnd(0.05), rnd(1e-2), rnd(1e-3)
                    kern, plain, _ = _sgd_trees(fo, method, clr, [p0],
                                                [g0], [v0])
                    _bitwise(f"{label} wd {wd} step {step} "
                             f"{list(shape)}", kern, plain,
                             results[kernel])
            gen = torch.Generator(device="cuda").manual_seed(77)

            def rnd(shape, scale, shift=0):
                """randn of ``shape`` at ``shift`` floats past an aligned
                address."""
                n = int(np.prod(shape))
                base = torch.randn(n + shift, generator=gen, device="cuda")
                return base[shift:].mul_(scale).view(shape)
            for case, p0s, g0s, v0s, scalar, in_place, want in \
                    _sgd_tree_cases(fo, rnd):
                leaves = list(zip(p0s, g0s, v0s))
                tables, kept = fo.leaf_tables(leaves, kernel, ("p", "v"))
                meta = _meta_rows(tables)
                plan = {"tables": len(tables),
                        "scalar_path": int((meta[:, 4] == 0).sum()),
                        "channels_last_in_place": int((meta[:, 2] > 0)
                                                      .sum()),
                        "copies": len(kept)}
                kern, plain, launches = _sgd_trees(fo, method, clr, p0s,
                                                   g0s, v0s)
                r = _bitwise(f"{label} wd {wd} {case}", kern, plain,
                             results[kernel])
                r.update(plan, launches=launches, launches_expected=want)
                if (launches, plan["tables"], plan["scalar_path"],
                        plan["channels_last_in_place"], plan["copies"]) \
                        != (want, want, scalar, in_place, 0):
                    r["ok"] = False
                    log(f"  FAIL: {launches} launches, plan {plan}; "
                        f"expected {want} launches, {scalar} scalar, "
                        f"{in_place} channels-last in place, 0 copies")
    bad = [r["case"] for rs in results.values() for r in rs if not r["ok"]]
    if bad:
        raise AssertionError(f"fused_sgd is not bitwise equal to its plain "
                             f"version, or did not launch as planned: "
                             f"{bad}")
    # a leaf the kernels do not take (fp16; bf16 leaves have their own
    # instantiations, phase_spmd (d)) raises on the card, before any launch
    xb = torch.ones(8, dtype=torch.float16, device="cuda")
    clr = torch.ones((), device="cuda")
    for kernel, vel in ((fo.SGD_MOM, {"x": xb.clone()}),
                        (fo.SGD_PLAIN, None)):
        before = fo._build.launch_counts().get(kernel, 0)
        try:
            fo.fused_sgd_update({"x": xb}, {"x": xb}, vel, clr=clr,
                                momentum=0.9 if vel else 0.0)
        except NotImplementedError as e:
            log(f"{kernel} on an fp16 leaf raises: {e}")
        else:
            raise AssertionError(f"{kernel} took an fp16 leaf on the card")
        if fo._build.launch_counts().get(kernel, 0) != before \
                or not torch.equal(xb, torch.ones_like(xb)):
            raise AssertionError(f"{kernel} touched an fp16 leaf it "
                                 f"refused")
    replaces = {fo.SGD_MOM: "bigdl_tpu/kernels/fused_optim.py:174",
                fo.SGD_PLAIN: "bigdl_tpu/kernels/fused_optim.py:186"}
    return [{"name": name, "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/fused_sgd.cu",
             "replaces": replaces[name], "launches": None,
             "max_abs_err": max(r["max_abs_err"] for r in results[name]),
             "tolerance": "bitwise", "cases": results[name], "card": card}
            for name in (fo.SGD_MOM, fo.SGD_PLAIN)]


def _host_us(fn, iters: int = 200, idle: bool = False) -> float:
    """Host time of ``fn`` in µs a call (host clock); with ``idle``, the
    median of calls each made on an idle device, so that a launch is not
    held back by the ones queued before it."""
    fn()
    if idle:
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e6
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def time_sgd(k5: dict, k6: dict, resnet_shapes, lenet_shapes, card: str):
    """K5 and K6, their plain versions and torch.optim.SGD(fused=True)
    over leaves of ResNet-50's shapes (one update each: K5 with momentum
    0.9, dampening 0.9, wd 1e-4; K6 with none), by CUDA events and by
    device time, with the launches an update makes and the host time of
    the wrapper's parts; and K6 against the library at LeNet-5's 8
    leaves."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.optim import SGD
    n = sum(int(np.prod(s)) for s in resnet_shapes)
    g = torch.Generator(device="cuda").manual_seed(12)

    def trees(shapes):
        p = {f"l{i}": {"w": torch.randn(s, generator=g, device="cuda")
                       * 0.05} for i, s in enumerate(shapes)}
        grads = {k: {"w": torch.randn_like(v["w"]) * 1e-2}
                 for k, v in p.items()}
        return p, grads

    def library_step(params, grads, lib_kw):
        """torch.optim.SGD(fused=True).step on copies of params."""
        flat = [t["w"].clone().requires_grad_() for t in params.values()]
        for p_, gt in zip(flat, (t["w"] for t in grads.values())):
            p_.grad = gt
        ref = torch.optim.SGD(flat, fused=True, **lib_kw)
        ref.step()                               # builds its momentum buffers
        return ref.step

    def library_ms(params, grads, other, lib_kw):
        """The library step on copies of params: (ms by events, its
        :func:`device_ms` (its kernels are named *FusedSgd*) alternating
        with the second tree ``other``, its :func:`cold_ms` and the raw
        records of one cold call)."""
        step = library_step(params, grads, lib_kw)
        return (cuda_ms(step, iters=10),
                device_ms([step, library_step(*other, lib_kw)], "sgd"),
                cold_ms(step, "sgd"), kernel_records(step, "sgd"))

    # the rate a plain copy reaches on this card, cold: what the bound's
    # data-sheet rate is worth in practice
    src = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = cold_ms(lambda: dst.copy_(src))["events_ms"]
    copy_tb_s = 2 * L2_FLUSH_BYTES / copy_ms / 1e9
    del src, dst
    log(f"copy of {L2_FLUSH_BYTES >> 20} MB, cold: {copy_ms:.4f} ms, "
        f"{copy_tb_s:.3f} TB/s read + write; {card}")

    for k, kw, lib_kw, nbytes in (
            (k5, dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4),
             dict(lr=0.1, momentum=0.9, dampening=0.9, weight_decay=1e-4),
             20),
            (k6, dict(learning_rate=0.05), dict(lr=0.05), 12)):
        method = SGD(fused=True, **kw)
        params, grads = trees(resnet_shapes)
        state = method.init_state(params)
        clr = method.get_learning_rate(state)
        upd = dict(clr=clr, momentum=method.momentum,
                   dampening=method.dampening, nesterov=method.nesterov,
                   weight_decay=method.weight_decay)
        vel = state.get("velocity")
        # a second tree, so that back-to-back calls can alternate between
        # disjoint bytes
        params_b, grads_b = trees(resnet_shapes)
        vel_b = method.init_state(params_b).get("velocity")

        def kernel_run():
            fo.fused_sgd_update(params, grads, vel, **upd)

        def kernel_run_b():
            fo.fused_sgd_update(params_b, grads_b, vel_b, **upd)
        before = fo._build.launch_counts().get(k["name"], 0)
        kernel_run()
        per_update = fo._build.launch_counts().get(k["name"], 0) - before
        ms = cuda_ms(kernel_run, iters=10)
        dev_ms = device_ms(kernel_run, "sgd_")
        dev_alt = device_ms([kernel_run, kernel_run_b], "sgd_")
        cold = cold_ms(kernel_run, "sgd_")
        records = kernel_records(kernel_run, "sgd_")
        plain_ms = cuda_ms(lambda: fo.fused_sgd_update_plain(
            params, grads, vel, **upd), iters=3)
        lib_ms, lib_dev_ms, lib_cold, lib_records = library_ms(
            params, grads, (params_b, grads_b), lib_kw)
        # the wrapper's host time, part by part (the launch is the rest)
        trs = (params, grads, vel) if vel is not None else (params, grads)
        leaves = fo.zip_leaves(*trs)
        in_place = ("p", "v") if vel is not None else ("p",)
        (ptrs, meta, count), = fo.leaf_tables(leaves, k["name"],
                                              in_place)[0]
        fn = fo._sgd_fn(vel is not None)
        stream = torch.cuda.current_stream().cuda_stream
        args = (clr.data_ptr(), *((0.9, 0.1, 1e-4, 1, 0) if vel is not None
                                  else (0.0, 0)), stream)

        def c_call():
            fn(ptrs.buffer_info()[0], meta.buffer_info()[0], count, *args)
        host = {"update": _host_us(kernel_run),
                "zip_leaves": _host_us(lambda: fo.zip_leaves(*trs)),
                "f32_check": _host_us(lambda: fo._kernel_takes(
                    leaves, k["name"])),
                "leaf_tables": _host_us(lambda: fo.leaf_tables(
                    leaves, k["name"], in_place)),
                "c_call_and_launch": _host_us(c_call, 50, idle=True)}
        torch.cuda.synchronize()
        del params, grads, state, vel, leaves, params_b, grads_b, vel_b
        bound_ms = n * nbytes / H100_HBM_BYTES_S * 1e3
        for who, rec in (("kernel", records), ("library", lib_records)):
            log(f"{k['name']} raw device records of one cold {who} call: "
                f"events {rec['events_ms']:.4f} ms, records sum "
                f"{rec['records_sum_ms']:.4f} ms, span "
                f"{rec['records_span_ms']} ms, key_averages "
                f"{rec['key_averages_ms']:.4f} ms; {rec['records']}")
        k.update(ms=ms, kernel_ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                 device_ms_alternating=dev_alt, device_cold=cold,
                 cold_records=records, library_cold_records=lib_records,
                 bound_ms=bound_ms, bound_by="bytes",
                 copy_tb_s=copy_tb_s, library_ms=lib_ms,
                 library_device_ms=lib_dev_ms, library_cold=lib_cold,
                 library_call=f"torch.optim.SGD({lib_kw}, fused=True)"
                              f".step(), f32",
                 leaves=len(resnet_shapes), params=n,
                 launches_per_update=per_update, host_us=host)
        log(f"{k['name']} over {len(resnet_shapes)} leaves, {n} params: "
            f"{per_update} launch(es) an update; kernel {ms:.4f} ms by "
            f"events, back to back {dev_ms} on one tree and {dev_alt} "
            f"alternating two, cold L2 {cold}, plain {plain_ms:.4f} ms, "
            f"torch.optim.SGD(fused) {lib_ms:.4f} ms (back to back "
            f"alternating two trees {lib_dev_ms}, cold L2 {lib_cold}), bound "
            f"{bound_ms:.4f} ms (bytes); host µs {host}; {card}")
    params, grads = trees(lenet_shapes)
    clr = torch.full((), 0.05, device="cuda")
    lenet_ms = cuda_ms(lambda: fo.fused_sgd_update(params, grads, clr=clr),
                       iters=50)
    k6["lenet_ms_per_update"] = lenet_ms
    k6["lenet_library_ms"] = cuda_ms(library_step(params, grads,
                                                  dict(lr=0.05)), iters=50)
    k6["lenet_bound_ms"] = sum(int(np.prod(s)) for s in lenet_shapes) \
        * 12 / H100_HBM_BYTES_S * 1e3
    log(f"fused_sgd_plain at LeNet-5's {len(lenet_shapes)} leaves: "
        f"{lenet_ms:.4f} ms an update, torch.optim.SGD(fused) "
        f"{k6['lenet_library_ms']:.4f} ms (bound "
        f"{k6['lenet_bound_ms']:.6f} ms); {card}")


def _syncs(fn) -> Optional[str]:
    """None when ``fn()`` runs under ``torch.cuda.set_sync_debug_mode
    ("error")`` without a synchronizing call, else the error it raised."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        return str(e).splitlines()[0][:200]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return None


def phase_host_sync() -> dict:
    """One SGD.update (K5), one AdamW.update (K4) and one SGD.update under
    ``SequentialSchedule(Warmup, Poly)`` behind clipping by L2 norm (the
    recipe's) on the card must make no host sync: each runs under
    ``set_sync_debug_mode("error")`` after a warm update.  The mode must catch a read of a device value
    (``.item()``), so that the check can see a sync at all; whether it
    also reports a device scalar made from a host float, as the updates
    built theirs before (``torch.as_tensor(rate, device=...)``), is
    logged."""
    from bigdl_tpu_torch.optim import SGD, AdamW
    from bigdl_tpu_torch.optim.optimizer import _ClippedOptim
    g = torch.Generator(device="cuda").manual_seed(14)

    def tree():
        return {"a": {"w": torch.randn(4096, generator=g, device="cuda")},
                "b": {"w": torch.randn(64, 64, generator=g, device="cuda")}}
    out = {}
    for name, method in (
            ("SGD(0.1, momentum=0.9, weight_decay=1e-4, fused=True)",
             SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                 fused=True)),
            ("AdamW(3e-4, fused=True)", AdamW(learning_rate=3e-4,
                                              fused=True)),
            ("SGD(0.1, momentum=0.9, SequentialSchedule(Warmup, Poly), "
             "fused=True) clipped by L2 norm 1.0",
             _ClippedOptim(SGD(learning_rate=0.1, momentum=0.9, fused=True,
                               learning_rate_schedule=_recipe_schedule()),
                           clip_norm=1.0))):
        params, grads = tree(), tree()
        state = [method.init_state(params)]
        state[0] = method.update(grads, params, state[0])[1]

        def update():
            state[0] = method.update(grads, params, state[0])[1]
        out[name] = _syncs(update)
    out["control: .item() of a device value"] = _syncs(
        lambda: torch.ones((), device="cuda").item())
    out["torch.as_tensor(0.1, device='cuda')"] = _syncs(
        lambda: torch.as_tensor(0.1, dtype=torch.float32, device="cuda"))
    log(f"host sync under set_sync_debug_mode('error') (None: no sync): "
        f"{out}")
    if out["control: .item() of a device value"] is None:
        raise AssertionError("set_sync_debug_mode did not report .item()")
    bad = [k for k in list(out)[:3] if out[k] is not None]
    if bad:
        raise AssertionError(f"an optimizer update synchronizes the host: "
                             f"{ {k: out[k] for k in bad} }")
    return out


# --------------------------------------------------------------------- #
CLS_BATCH, CLS_EPOCHS = 64, 6          # ResNet-50: 6 steps on one batch
LENET_BATCH, LENET_ROWS, LENET_EPOCHS = 128, 512, 2
RESNET_SGD = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
LENET_SGD = dict(learning_rate=0.05)
# kernel run against plain run of a classifier (fp32, TF32 off,
# deterministic cuDNN): K5/K6 are bitwise equal to the plain update and
# every other op is deterministic, so the runs must agree to the last bit
# (they did on an H100: 0.0 between kernel and plain, and between two
# plain runs).  The TF32 run is read against the training phase's loss
# limit, about 20x a sound fp32 reading there, and must fall outside it.
CLS_LOSS_TOL = 2e-5                  # |loss_tf32 - loss_plain|, some step
CLS_CLASSES = (("sgd_mom", "K5 fused_sgd_mom"),
               ("sgd_plain", "K6 fused_sgd_plain"),
               ("memcpy htod", "memcpy H2D"), ("memcpy", "memcpy, other"),
               ("dgrad", "cuDNN conv backward"),
               ("wgrad", "cuDNN conv backward"),
               ("bprop", "cuDNN conv backward"),
               ("fprop", "cuDNN conv forward"),
               ("conv", "cuDNN conv, other"), ("gemm", "matmul (cuBLAS)"),
               ("reduce", "reductions"), ("pool", "pooling"),
               ("elementwise", "elementwise (BN, ReLU, add)"))


def _classifier_run(model, data, method, epochs, w0, s0):
    """Train ``model`` from the weights ``w0`` and BN state ``s0`` with
    LocalOptimizer and ``method`` for ``epochs`` epochs; returns (losses,
    step ms by CUDA events between the ends of consecutive steps)."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import LocalOptimizer, Trigger

    class Recording(LocalOptimizer):
        """Keeps each step's loss (on the device) and an event at its
        end."""
        def _fire_mid_epoch(self):
            self.losses.append(self.state.loss)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            return super()._fire_mid_epoch()

    with torch.no_grad():
        for dst, src in zip(model.get_weights() + model.state_list(),
                            w0 + s0):
            dst.copy_(src)
    x, y, batch = data
    opt = Recording(model, (x, y), ClassNLLCriterion(), batch_size=batch)
    opt.losses, opt.events = [], [torch.cuda.Event(enable_timing=True)]
    opt.set_optim_method(method).set_end_when(Trigger.max_epoch(epochs))
    opt.events[0].record()
    opt.optimize()
    torch.cuda.synchronize()
    ev = opt.events
    return ([float(v) for v in opt.losses],
            [ev[i].elapsed_time(ev[i + 1]) for i in range(len(ev) - 1)])


def _check_losses(what, losses_k, losses_p, limit):
    diffs = [abs(a - b) for a, b in zip(losses_k, losses_p)]
    log(f"{what}: losses {losses_k}; against {losses_p}; max |diff| "
        f"{max(diffs):.3e} ({limit})")
    if not all(np.isfinite(losses_k + losses_p)):
        raise AssertionError(f"{what}: non-finite loss")
    return diffs


def phase_classifier(card: str, k5: dict, k6: dict):
    """ResNet-50 (ImageNet, NHWC, fp32) through LocalOptimizer with
    SGD(momentum, fused=True) on K5, and LeNet-5 with SGD(fused=True) on
    K6; each against the same run with fused=False, with exact launch
    counts, and ResNet-50's breakdown."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import lenet, resnet
    from bigdl_tpu_torch.nn import ClassNLLCriterion, Ctx
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import SGD

    t0 = time.monotonic()
    model = resnet.build(class_num=1000, depth=50, dataset="imagenet",
                         format="NHWC", seed=0)
    w0 = [w.clone() for w in model.get_weights()]
    s0 = [s.clone() for s in model.state_list()]
    n_leaves, n_params = len(w0), sum(w.numel() for w in w0)
    log(f"ResNet-50 built: {n_leaves} leaves, {n_params} params, "
        f"{len(s0)} BN state tensors, {time.monotonic() - t0:.1f} s")
    rs = np.random.RandomState(2)
    x = rs.randn(CLS_BATCH, 224, 224, 3).astype(np.float32)
    y = (rs.randint(0, 1000, CLS_BATCH) + 1).astype(np.float32)
    data = (x, y, CLS_BATCH)

    # the main path: counts from 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses_k, step_ms = _classifier_run(
        model, data, SGD(fused=True, **RESNET_SGD), CLS_EPOCHS, w0, s0)
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # one K5 launch an update per table of SGD_CAPACITY leaves
    per_update = -(-n_leaves // fo.SGD_CAPACITY)
    want = {fo.SGD_MOM: per_update * CLS_EPOCHS, fo.SGD_PLAIN: 0}
    got = {name: launches.get(name, 0) for name in want}
    log(f"ResNet-50 launches {launches}, expected {want}")
    if got != want or sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"ResNet-50 launches {launches}, expected "
                             f"{want}")

    # the same steps on the plain update, twice (run-to-run noise), and
    # with TF32 convolutions and matmuls
    losses_p, _ = _classifier_run(model, data, SGD(**RESNET_SGD),
                                  CLS_EPOCHS, w0, s0)
    losses_p2, _ = _classifier_run(model, data, SGD(**RESNET_SGD),
                                   CLS_EPOCHS, w0, s0)
    if _build.launch_counts() != launches:
        raise AssertionError("the plain runs launched a kernel")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        losses_t, _ = _classifier_run(model, data,
                                      SGD(fused=True, **RESNET_SGD),
                                      CLS_EPOCHS, w0, s0)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    noise = _check_losses("ResNet-50 plain vs plain", losses_p2, losses_p,
                          "bitwise")
    diffs = _check_losses("ResNet-50 kernel vs plain", losses_k, losses_p,
                          "bitwise")
    tf32_diffs = _check_losses("ResNet-50 TF32 vs plain", losses_t,
                               losses_p, f"must exceed {CLS_LOSS_TOL}")
    bitwise_runs = {"plain_vs_plain": losses_p2 == losses_p,
                    "kernel_vs_plain": losses_k == losses_p}
    log(f"ResNet-50 losses bitwise equal: {bitwise_runs}")

    # K5 on the model's own step-1 gradients (channels-last conv weight
    # gradients included), two updates, against the plain update
    with torch.no_grad():
        for dst, src in zip(model.get_weights() + model.state_list(),
                            w0 + s0):
            dst.copy_(src)
    params = model.param_dict()
    leaves = [p for sub in params.values() for p in sub.values()]
    xd = torch.from_numpy(x).cuda()
    yd = torch.from_numpy(y).cuda()
    crit = ClassNLLCriterion()

    def loss_and_grads():
        ctx = Ctx(state=model.initial_state(), training=True)
        loss = crit.loss(model.apply(params, xd, ctx), yd)
        return loss, torch.autograd.grad(loss, leaves)
    _, grads = loss_and_grads()
    layouts = sum(not gr.is_contiguous() for gr in grads)
    # the channels-last conv gradients are read in place: no copy
    tables, kept = fo.leaf_tables(
        [(w, gr, w) for w, gr in zip(leaves, grads)], fo.SGD_MOM, ("p", "v"))
    in_place = int((_meta_rows(tables)[:, 2] > 0).sum())
    copies = len(kept)
    del tables, kept
    method = SGD(**RESNET_SGD)
    clr = method.get_learning_rate(method.init_state(params))
    upd = dict(clr=clr, momentum=method.momentum, dampening=method.dampening,
               nesterov=method.nesterov, weight_decay=method.weight_decay)
    runs = []
    for fn in (fo.fused_sgd_update, fo.fused_sgd_update_plain):
        p = {f"l{i}": {"w": w.detach().clone()} for i, w in enumerate(leaves)}
        v = {k: {"w": torch.zeros_like(t["w"])} for k, t in p.items()}
        gtree = {f"l{i}": {"w": gr} for i, gr in enumerate(grads)}
        for _ in range(2):
            fn(p, gtree, v, **upd)
        torch.cuda.synchronize()
        runs.append([t["w"] for t in p.values()] + [t["w"] for t in
                                                    v.values()])
    step1_ok = all(torch.equal(a, b) for a, b in zip(*runs))
    step1_err = max((a - b).abs().max().item() for a, b in zip(*runs))
    log(f"K5 vs plain on ResNet-50's step-1 gradients ({layouts} of "
        f"{len(grads)} not contiguous, {in_place} read in place, {copies} "
        f"copied), two updates: max_abs_err {step1_err:.3e} -> "
        f"{'bitwise' if step1_ok else 'FAIL'}")
    k5["cases"].append({"case": "ResNet-50 step-1 gradients, two updates",
                        "max_abs_err": step1_err, "bitwise": step1_ok,
                        "ok": step1_ok,
                        "non_contiguous_grads": layouts,
                        "channels_last_in_place": in_place,
                        "copies": copies})
    del runs, grads

    # where a step's time goes (after the counts were read)
    opt = SGD(fused=True, **RESNET_SGD)
    opt_state = opt.init_state(params)

    def part_times():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        xb = torch.from_numpy(x).to("cuda")
        yb = torch.from_numpy(y).to("cuda")
        ev[1].record()
        ctx = Ctx(state=model.initial_state(), training=True)
        loss = crit.loss(model.apply(params, xb, ctx), yb)
        ev[2].record()
        gr = torch.autograd.grad(loss, leaves)
        ev[3].record()
        it = iter(gr)
        gtree = {n: {k: next(it) for k in sub} for n, sub in params.items()}
        opt.update(gtree, params, opt_state)
        ev[4].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    parts = [part_times() for _ in range(3)]
    h2d_ms, fwd_ms, bwd_ms, opt_ms = (float(np.median([p[i] for p in parts]))
                                      for i in range(4))
    profile = profile_steps(
        lambda: _classifier_run(model, data, SGD(fused=True, **RESNET_SGD),
                                2, w0, s0),
        steps=2, classes=CLS_CLASSES, top=15)
    shapes = [tuple(w.shape) for w in w0]
    del model, params, leaves, opt_state, xd, yd, w0, s0
    torch.cuda.empty_cache()

    # LeNet-5 on K6: labels a fixed function of the images, so that two
    # epochs can lower the loss
    lnet = lenet.build(10, seed=0)
    lw0 = [w.clone() for w in lnet.get_weights()]
    rs = np.random.RandomState(3)
    lx = rs.randn(LENET_ROWS, 1, 28, 28).astype(np.float32)
    proj = rs.randn(784, 10).astype(np.float32)
    ly = (np.argmax(lx.reshape(LENET_ROWS, -1) @ proj, 1) + 1).astype(
        np.float32)
    ldata = (lx, ly, LENET_BATCH)
    lenet_steps = LENET_EPOCHS * LENET_ROWS // LENET_BATCH
    _build.reset_launch_counts()
    l_losses_k, l_step_ms = _classifier_run(
        lnet, ldata, SGD(fused=True, **LENET_SGD), LENET_EPOCHS, lw0, [])
    l_launches = _build.launch_counts()
    l_want = {fo.SGD_PLAIN: -(-len(lw0) // fo.SGD_CAPACITY) * lenet_steps}
    log(f"LeNet-5 launches {l_launches}, expected {l_want}")
    if l_launches != l_want:
        raise AssertionError(f"LeNet-5 launches {l_launches}, expected "
                             f"{l_want}")
    l_losses_p, _ = _classifier_run(lnet, ldata, SGD(**LENET_SGD),
                                    LENET_EPOCHS, lw0, [])
    if _build.launch_counts() != l_launches:
        raise AssertionError("the plain LeNet-5 run launched a kernel")
    l_diffs = _check_losses("LeNet-5 kernel vs plain", l_losses_k,
                            l_losses_p, "bitwise")
    lenet_shapes = [tuple(w.shape) for w in lw0]
    del lnet, lw0

    time_sgd(k5, k6, shapes, lenet_shapes, card)
    if profile:
        k5["device_ms_per_step"] = profile["device_ms_by_class"].get(
            "K5 fused_sgd_mom")

    # every check, after every reading was taken
    fails = []
    if not all(bitwise_runs.values()):
        fails.append(f"ResNet-50 runs are not bitwise equal: {bitwise_runs}"
                     f"; kernel vs plain {diffs}, plain vs plain {noise}")
    if max(tf32_diffs) <= CLS_LOSS_TOL:
        fails.append(f"ResNet-50: the limit {CLS_LOSS_TOL} does not tell a "
                     f"TF32 run from fp32: {tf32_diffs}")
    if not losses_k[-1] < losses_k[0]:
        fails.append(f"ResNet-50 loss did not fall: {losses_k}")
    if not step1_ok:
        fails.append("K5 is not bitwise equal to the plain update on "
                     "ResNet-50's step-1 gradients")
    if copies or in_place != layouts or not layouts:
        fails.append(f"ResNet-50's {layouts} non-contiguous gradients: "
                     f"{in_place} read in place, {copies} copied")
    if l_losses_k != l_losses_p:
        fails.append(f"LeNet-5 kernel and plain runs are not bitwise equal:"
                     f" {l_diffs}")
    if not l_losses_k[-1] < l_losses_k[0]:
        fails.append(f"LeNet-5 loss did not fall: {l_losses_k}")

    step_med = float(np.median(step_ms))
    out = {"resnet50": {
               "config": "resnet.build(class_num=1000, depth=50, dataset="
                         "'imagenet', format='NHWC', seed=0), fp32, "
                         "LocalOptimizer, SGD(learning_rate=0.1, momentum="
                         "0.9, weight_decay=1e-4, fused=True)",
               "leaves": n_leaves, "params": n_params, "batch": CLS_BATCH,
               "steps": CLS_EPOCHS, "step_ms": step_ms,
               "step_ms_median": step_med,
               "images_per_s": CLS_BATCH / (step_med / 1e3),
               "losses": losses_k, "losses_plain": losses_p,
               "losses_plain_again": losses_p2,
               "max_loss_diff": max(diffs),
               "max_loss_noise_plain_vs_plain": max(noise),
               "bitwise": bitwise_runs, "loss_limit": "bitwise",
               "tf32": {"losses": losses_t, "max_loss_diff":
                        max(tf32_diffs), "must_exceed": CLS_LOSS_TOL},
               "launches": got, "peak_mem_gb": peak_gb,
               "breakdown_ms": {"h2d": h2d_ms, "forward": fwd_ms,
                                "backward": bwd_ms, "optimizer": opt_ms},
               "profile": profile},
           "lenet5": {
               "config": "lenet.build(10, seed=0), LocalOptimizer, "
                         "SGD(learning_rate=0.05, fused=True)",
               "batch": LENET_BATCH, "rows": LENET_ROWS,
               "steps": lenet_steps, "step_ms": l_step_ms,
               "step_ms_median": float(np.median(l_step_ms)),
               "losses": l_losses_k, "losses_plain": l_losses_p,
               "max_loss_diff": max(l_diffs),
               "bitwise": l_losses_k == l_losses_p,
               "launches": l_launches},
           "launches": {fo.SGD_MOM: got[fo.SGD_MOM],
                        fo.SGD_PLAIN: l_launches.get(fo.SGD_PLAIN, 0)},
           "card": card}
    log(f"classifier: {json.dumps(out)}")
    if fails:
        raise AssertionError("classifier phase: " + "; ".join(fails))
    return out


# --------------------------------------------------------------------- #
# phase_distri: bf16, prefetch, validation and DistriOptimizer at dp=1  #
# --------------------------------------------------------------------- #
DISTRI_IMAGES, DISTRI_VAL, DISTRI_EPOCHS = 1024, 512, 1
DISTRI_B64_IMAGES = 256          # batch 64: 4 steps an epoch, as b256
DISTRI_PROFILE_STEPS = 2         # profiled, at b256
# the new BN against autograd through the fp32 formula (on the same
# values), at ResNet-50's widths, relative to each output's largest
# entry: fp32 outputs differ by reduction order (~1e-6); the statistics,
# dgamma and dbeta are fp32 sums of the same values in bf16 too.  bf16 dx
# is one rounding of fp32 math (at most 2^-8 of its value); bf16 y, as
# the reference computes it, is four (scale, shift, product, sum): at
# most 4 * 2^-8 of the largest entry, the limit for both
BN_F32_REL = 2e-5
BN_BF16_OUT_REL = 2 ** -6
# bf16 against fp32 from the same weights on the same batches: a bf16
# run must differ from the fp32 run by more than the classifier's fp32
# loss limit at some step (a run that did not cast its inputs reads 0:
# fp32 is bitwise reproducible here) and by at most BF16_LOSS_REL
# (relative) at every step
BF16_LOSS_REL = 2e-2
# the 16-bit wire at dp=1 rounds each gradient to 16 bits once:
# finite losses within WIRE16_LOSS_REL of the fp32 wire's, every step
WIRE16_LOSS_REL = 2e-2
VAL_LOSS_REL = 1e-6
DISTRI_CLASSES = (("sgd_mom", "K5 fused_sgd_mom"),
                  ("memcpy htod", "memcpy H2D"), ("memcpy", "memcpy, other"),
                  ("dgrad", "cuDNN conv backward"),
                  ("wgrad", "cuDNN conv backward"),
                  ("bprop", "cuDNN conv backward"),
                  ("fprop", "cuDNN conv forward"),
                  ("conv", "cuDNN conv, other"), ("gemm", "matmul (cuBLAS)"),
                  ("nchw", "layout transposes"), ("nhwc", "layout transposes"),
                  ("reduce", "reductions (BN statistics, sums)"),
                  ("pool", "pooling"), ("nccl", "NCCL"),
                  ("copy", "casts and copies"),
                  ("elementwise", "elementwise (BN, ReLU, add)"))


def _old_bn(x, gamma, beta, axis, eps):
    """Training BN as the port had it before ``_BNTrain``: the forward
    formula, differentiated by autograd (with an fp32 copy of x saved)."""
    axes = tuple(i for i in range(x.ndim) if i != axis)
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    xf = x.float()
    mean = xf.mean(dim=axes)
    var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    y = (x * (gamma * inv).reshape(shape).to(x.dtype)
         + (beta - gamma * mean * inv).reshape(shape).to(x.dtype))
    return y, mean.detach(), var.detach()


def _bn_case(shape, dtype, seed):
    """The new BN against autograd through the fp32 formula (on the same
    values, upcast): max |err| / max |ref| of y, mean, var, dx, dgamma,
    dbeta."""
    from bigdl_tpu_torch.nn.normalization import _BNTrain
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 1).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
    c = shape[-1]
    gamma = torch.rand(c, device="cuda", generator=g) + 0.5
    beta = torch.randn(c, device="cuda", generator=g)
    outs = []
    for fn, xx, dd in ((_BNTrain.apply, x, dy),
                       (_old_bn, x.float(), dy.float())):
        xx = xx.detach().requires_grad_()
        gg, bb = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
        y, mean, var = fn(xx, gg, bb, 3, 1e-5)
        grads = torch.autograd.grad(y, (xx, gg, bb), dd)
        outs.append([t.detach().float() for t in (y, mean, var, *grads)])
    return {name: ((a - b).abs().max() / b.abs().max()).item()
            for name, a, b in zip(("y", "mean", "var", "dx", "dgamma",
                                   "dbeta"), *outs)}


def _step_peak_gb(model, x, y, mixed, old_bn):
    """Peak device memory of one training forward and backward (the
    classifier's loss) from a reset, with the new BN or the old one."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion, Ctx
    from bigdl_tpu_torch.nn import normalization as norm
    keep = norm._BNTrain.apply
    params = model.param_dict()
    leaves = [p for sub in params.values() for p in sub.values()]
    try:
        if old_bn:
            norm._BNTrain.apply = _old_bn
        xd = torch.from_numpy(x).cuda()
        if mixed:
            xd = xd.bfloat16()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ctx = Ctx(state=model.initial_state(), training=True)
        out = model.apply(params, xd, ctx)
        loss = ClassNLLCriterion().loss(out.float(), torch.from_numpy(y)
                                        .cuda())
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        del out, loss, grads, ctx, xd
    finally:
        norm._BNTrain.apply = keep
    torch.cuda.empty_cache()
    return peak


def _train_run(model, w0, s0, data, batch, *, mixed=True, fused=True,
               mesh=None, prefetch=0, val=None, audit=False, no_cast=False,
               keep_opt=False, seed=0, **distri_kw):
    """One training run of a classifier (ResNet-50, VGG-16) from the
    weights ``w0`` and BN state ``s0`` for DISTRI_EPOCHS epochs:
    LocalOptimizer, or DistriOptimizer over ``mesh``, with the loop's
    ``seed``.  Returns losses, step ms (CUDA events between the ends of
    consecutive steps), K5 launches, and the optimizer."""
    from bigdl_tpu_torch.data.device_loader import HostToDevice
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, LocalOptimizer,
                                       Loss, Top1Accuracy, Top5Accuracy,
                                       Trigger)
    from bigdl_tpu_torch.optim import optimizer as optmod
    with torch.no_grad():
        for dst, src in zip(model.get_weights() + model.state_list(),
                            w0 + s0):
            dst.copy_(src)
    x, y = data
    if mesh is None:
        opt = LocalOptimizer(model, (x, y), ClassNLLCriterion(),
                             batch_size=batch, seed=seed)
        method = SGD(fused=fused, **RESNET_SGD)
    else:
        opt = DistriOptimizer(model, (x, y), ClassNLLCriterion(),
                              batch_size=batch, mesh=mesh, fused_optim=True,
                              seed=seed, **distri_kw)
        method = SGD(**RESNET_SGD)
    opt.set_optim_method(method).set_end_when(Trigger.max_epoch(
        DISTRI_EPOCHS))
    if mixed:
        opt.set_mixed_precision()
    if prefetch:
        opt.set_prefetch(prefetch)
        opt._h2d = HostToDevice(opt.device, prefetch, audit=audit)
    if val is not None:
        opt.set_validation(Trigger.every_epoch(), val,
                           [Top1Accuracy(), Top5Accuracy(), Loss()])
    losses, events = [], [torch.cuda.Event(enable_timing=True)]
    fire = opt._fire_mid_epoch

    def hook():
        losses.append(opt.state.loss)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return fire()
    opt._fire_mid_epoch = hook
    keep = optmod.to_bf16
    if no_cast:
        optmod.to_bf16 = lambda a: a
    before = _build.launch_counts()
    try:
        events[0].record()
        opt.optimize()
        torch.cuda.synchronize()
    finally:
        optmod.to_bf16 = keep
    after = _build.launch_counts()
    launches = {k: after.get(k, 0) - before.get(k, 0) for k in after
                if after.get(k, 0) != before.get(k, 0)}
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(len(events) - 1)]
    out = {"losses": [float(v) for v in losses], "step_ms": step_ms,
           "launches": launches}
    if keep_opt:
        out["opt"] = opt
    return out


def _steady(run, batch):
    """Step median over every step but the first (warm-up), and images/s."""
    med = float(np.median(run["step_ms"][1:]))
    return {"step_ms_median": med, "images_per_s": batch / (med / 1e3),
            "step_ms": run["step_ms"]}


def _same_bits(model, want):
    got = model.get_weights() + model.state_list()
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _max_rel(a, b):
    return max(abs(u - v) / abs(v) for u, v in zip(a, b))


def _numpy_scores(logits, y, batch):
    """Top1, Top5 (a stable sort, as the methods take it) and the mean
    ClassNLL loss of log-probs ``logits`` in batches of ``batch``, in
    numpy."""
    t = y.astype(np.int64)
    top1 = int((np.argmax(logits, 1) + 1 == t).sum())
    order = np.argsort(-logits, axis=1, kind="stable")[:, :5] + 1
    top5 = int((order == t[:, None]).any(1).sum())
    total = 0.0
    for i in range(0, len(t), batch):
        lp = logits[i:i + batch]
        picked = lp[np.arange(len(lp)), t[i:i + batch] - 1]
        total += float(np.mean(-picked, dtype=np.float32)) * len(lp)
    return top1, top5, total / len(t)


# ResNet-50's 53 training BNs at batch 256, NHWC: (H, W, C) -> count
RESNET50_BN_SHAPES = {(112, 112, 64): 1, (56, 56, 64): 6, (56, 56, 256): 4,
                      (56, 56, 128): 1, (28, 28, 128): 7, (28, 28, 512): 5,
                      (28, 28, 256): 1, (14, 14, 256): 11,
                      (14, 14, 1024): 7, (14, 14, 512): 1, (7, 7, 512): 5,
                      (7, 7, 2048): 4}


def _bn_fwd_bwd(kind, x, dy, gamma, beta):
    """One training BN forward and backward of the NHWC bf16 ``x``:
    ``_BNTrain`` (the port's, fp32 statistics and closed-form backward) or
    cuDNN's through ``F.batch_norm`` (the same bf16 values as an NCHW
    channels-last view, fp32 affine and running statistics).  Returns
    (y, dx, dgamma, dbeta)."""
    import torch.nn.functional as F
    from bigdl_tpu_torch.nn.normalization import _BNTrain
    xx = x.detach().requires_grad_()
    gg, bb = gamma.detach().requires_grad_(), beta.detach().requires_grad_()
    if kind == "bntrain":
        y = _BNTrain.apply(xx, gg, bb, 3, 1e-5)[0]
    else:
        c = x.shape[-1]
        rm = torch.zeros(c, device=x.device)
        rv = torch.ones(c, device=x.device)
        y = F.batch_norm(xx.permute(0, 3, 1, 2), rm, rv, gg, bb,
                         training=True, momentum=0.1, eps=1e-5) \
            .permute(0, 2, 3, 1)
    return (y, *torch.autograd.grad(y, (xx, gg, bb), dy))


def bn_cudnn_vs_bntrain(card: str) -> dict:
    """cuDNN's training BN (``F.batch_norm``) against ``_BNTrain`` at
    ResNet-50's BN shapes at batch 256 in bf16: forward plus backward by
    CUDA events (median of 10 after 2 warm), summed over the 53 layers of
    one step, and each one's max error against autograd through the fp32
    formula (relative to the largest entry) at one shape.  Measures only:
    the model keeps ``_BNTrain``."""
    g = torch.Generator(device="cuda").manual_seed(23)
    per_shape, totals = {}, {"bntrain": 0.0, "cudnn": 0.0}
    for (h, w, c), count in RESNET50_BN_SHAPES.items():
        shape = (256, h, w, c)
        x = (torch.randn(shape, device="cuda", generator=g) * 2 + 1) \
            .bfloat16()
        dy = torch.randn(shape, device="cuda", generator=g).bfloat16()
        gamma = torch.rand(c, device="cuda", generator=g) + 0.5
        beta = torch.randn(c, device="cuda", generator=g)
        row = {}
        for kind in ("bntrain", "cudnn"):
            row[kind] = cuda_ms(lambda: _bn_fwd_bwd(kind, x, dy, gamma, beta),
                                iters=10, warm=2)
            totals[kind] += row[kind] * count
        per_shape[f"{h}x{w}x{c} x{count}"] = row
        del x, dy
    shape = (256, 28, 28, 512)
    x = (torch.randn(shape, device="cuda", generator=g) * 2 + 1).bfloat16()
    dy = torch.randn(shape, device="cuda", generator=g).bfloat16()
    gamma = torch.rand(512, device="cuda", generator=g) + 0.5
    beta = torch.randn(512, device="cuda", generator=g)
    xf = x.float().requires_grad_()
    gf, bf = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    yf = _old_bn(xf, gf, bf, 3, 1e-5)[0]
    ref = (yf, *torch.autograd.grad(yf, (xf, gf, bf), dy.float()))
    errors = {}
    for kind in ("bntrain", "cudnn"):
        got = _bn_fwd_bwd(kind, x, dy, gamma, beta)
        errors[kind] = {name: ((a.float() - b).abs().max()
                               / b.abs().max()).item()
                        for name, a, b in zip(("y", "dx", "dgamma", "dbeta"),
                                              got, ref)}
    out = {"ms_per_step": totals, "per_shape_ms": per_shape,
           "rel_err_vs_fp32_formula_at_256x28x28x512": errors,
           "layers": sum(RESNET50_BN_SHAPES.values()), "card": card}
    log(f"BN, cuDNN against _BNTrain (bf16 b256, fwd+bwd): "
        f"{json.dumps(out)}")
    return out


def phase_distri(card: str):
    """ResNet-50 at the reference's headline (bf16 mixed precision, batch
    256) through LocalOptimizer and DistriOptimizer at dp=1 over NCCL,
    with prefetch and validation; the new BN on the card; K5 counted."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import Evaluator, Loss, Predictor
    from bigdl_tpu_torch.optim import Top1Accuracy, Top5Accuracy
    from bigdl_tpu_torch.parallel import mesh as mesh_lib

    fails = []
    # 1. the new BN at ResNet-50's widths, fp32 and bf16
    bn = {}
    for dtype, shape in ((torch.float32, (64, 56, 56, 256)),
                         (torch.bfloat16, (256, 28, 28, 512))):
        errs = _bn_case(shape, dtype, 7)
        bn[str(dtype).replace("torch.", "")] = {"shape": list(shape),
                                                "rel_err": errs}
        for name, err in errs.items():
            limit = BN_BF16_OUT_REL if dtype == torch.bfloat16 and name in (
                "y", "dx") else BN_F32_REL
            if not err <= limit:
                fails.append(f"BN {dtype} {shape} {name}: {err:.3e} > "
                             f"{limit:.3e}")
    log(f"BN against autograd through the fp32 formula: {json.dumps(bn)}")
    bn_cudnn = bn_cudnn_vs_bntrain(card)

    model = resnet.build(class_num=1000, depth=50, dataset="imagenet",
                         format="NHWC", seed=0)
    n_bn = sum(type(m).__name__ == "SpatialBatchNormalization"
               for m in model.modules())
    if n_bn != sum(RESNET50_BN_SHAPES.values()):
        fails.append(f"the BN timing's table holds "
                     f"{sum(RESNET50_BN_SHAPES.values())} layers, the model "
                     f"{n_bn}")
    w0 = [w.clone() for w in model.get_weights()]
    s0 = [s.clone() for s in model.state_list()]
    n_leaves = len(w0)
    per_update = -(-n_leaves // fo.SGD_CAPACITY)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((DISTRI_IMAGES, 224, 224, 3), dtype=np.float32)
    y = (rng.integers(0, 1000, DISTRI_IMAGES) + 1).astype(np.float32)
    xv = rng.standard_normal((DISTRI_VAL, 224, 224, 3), dtype=np.float32)
    yv = (rng.integers(0, 1000, DISTRI_VAL) + 1).astype(np.float32)
    d256 = (x, y)
    d64 = (x[:DISTRI_B64_IMAGES], y[:DISTRI_B64_IMAGES])
    steps256 = DISTRI_EPOCHS * DISTRI_IMAGES // 256
    steps64 = DISTRI_EPOCHS * DISTRI_B64_IMAGES // 64

    # peak memory of one step, the old BN against the new
    peaks = {}
    for label, xb, yb, mixed in (("fp32_b64", x[:64], y[:64], False),
                                 ("bf16_b256", x[:256], y[:256], True)):
        peaks[label] = {"old_bn_gb": _step_peak_gb(model, xb, yb, mixed,
                                                    True),
                        "new_bn_gb": _step_peak_gb(model, xb, yb, mixed,
                                                    False)}
    log(f"peak memory of one forward+backward: {json.dumps(peaks)}")

    # 2. bf16 through LocalOptimizer: fused against plain, bitwise in the
    # losses and the final weights and state; against fp32 within the
    # bf16 band
    runs, finals = {}, {}
    for name, data, batch, kw in (
            ("bf16_b64", d64, 64, {}),
            ("bf16_b64_plain", d64, 64, dict(fused=False)),
            ("fp32_b64", d64, 64, dict(mixed=False)),
            ("no_cast_b64", d64, 64, dict(no_cast=True)),
            ("bf16_b256", d256, 256, {}),
            ("bf16_b256_plain", d256, 256, dict(fused=False))):
        runs[name] = _train_run(model, w0, s0, data, batch, **kw)
        if name in ("bf16_b64", "bf16_b256"):
            finals[name] = [t.clone() for t in
                            model.get_weights() + model.state_list()]
        if name.endswith("_plain"):
            runs[name]["bitwise"] = _same_bits(model, finals[name[:-6]])
        if name == "bf16_b256":
            # half the held-out labels are the trained model's own
            # classes, so that Top1 and Top5 read far from 0 (every run
            # below that must be bitwise this one ends on these weights)
            yv[:DISTRI_VAL // 2] = Predictor(model, batch_size=128) \
                .predict_class(xv[:DISTRI_VAL // 2])
        log(f"{name}: losses {runs[name]['losses']}; launches "
            f"{runs[name]['launches']}")
    want_bits = finals["bf16_b256"]
    try:
        runs["fp32_b256"] = _train_run(model, w0, s0, d256, 256,
                                       mixed=False)
        fp32_b256 = _steady(runs["fp32_b256"], 256)
    except torch.cuda.OutOfMemoryError as e:
        fp32_b256 = {"fits": False, "error": str(e)[:200]}
        torch.cuda.empty_cache()
    log(f"fp32 b256: {json.dumps(fp32_b256)}")
    for a, b in (("bf16_b64", "bf16_b64_plain"),
                 ("bf16_b256", "bf16_b256_plain")):
        if runs[a]["losses"] != runs[b]["losses"] or not runs[b]["bitwise"]:
            fails.append(f"{a}: fused and plain differ: losses "
                         f"{runs[a]['losses']} vs {runs[b]['losses']}, "
                         f"weights bitwise {runs[b]['bitwise']}")
    bf16_vs_fp32 = _max_rel(runs["bf16_b64"]["losses"],
                            runs["fp32_b64"]["losses"])
    bf16_vs_fp32_abs = max(abs(u - v) for u, v in zip(
        runs["bf16_b64"]["losses"], runs["fp32_b64"]["losses"]))
    no_cast_abs = max(abs(u - v) for u, v in zip(
        runs["no_cast_b64"]["losses"], runs["fp32_b64"]["losses"]))
    band = {"bf16_vs_fp32_max_rel": bf16_vs_fp32,
            "bf16_vs_fp32_max_abs": bf16_vs_fp32_abs,
            "no_cast_vs_fp32_max_abs": no_cast_abs,
            "must_exceed_abs": CLS_LOSS_TOL, "at_most_rel": BF16_LOSS_REL}
    log(f"bf16 against fp32 at b64: {json.dumps(band)}")
    if not (bf16_vs_fp32_abs > CLS_LOSS_TOL and bf16_vs_fp32 <=
            BF16_LOSS_REL):
        fails.append(f"bf16 against fp32 outside its band: {band}")
    # the variant without the input cast must fall below the band
    if no_cast_abs > CLS_LOSS_TOL:
        fails.append(f"the run without the input cast differs from fp32 by "
                     f"{no_cast_abs:.3e}: the band cannot tell it")
    for name, run in runs.items():
        want = {fo.SGD_MOM: (steps64 if "b64" in name else steps256)
                * per_update} if "plain" not in name else {}
        if run["launches"] != want:
            fails.append(f"{name}: launches {run['launches']}, expected "
                         f"{want}")

    # 3. DistriOptimizer at dp=1 over NCCL
    store = tempfile.mkdtemp(prefix="distri_", dir=str(_build.BUILD_DIR))
    mesh_lib.init_distributed(f"file://{store}/store", 0, 1)
    mesh = mesh_lib.create_mesh({"dp": 1})
    log(f"mesh {mesh}")
    val = (xv, yv)
    distri = {}
    try:
        # the main path: counts from 0, peak memory from a reset
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        distri["main"] = _train_run(model, w0, s0, d256, 256, mesh=mesh,
                                    prefetch=2, val=val, audit=True,
                                    keep_opt=True)
        main_launches = _build.launch_counts()
        main_peak = torch.cuda.max_memory_allocated() / 1e9
        main_opt = distri["main"].pop("opt")
        main_bits = _same_bits(model, want_bits)
        # validation against Evaluator and numpy on Predictor's outputs
        named = main_opt.last_validation
        got_val = [r.result() for _, r in named]
        ev = Evaluator(model, batch_size=128).test(
            val, [Top1Accuracy(), Top5Accuracy(), Loss()])
        ev_val = [r.result() for _, r in ev]
        logits = Predictor(model, batch_size=128).predict(xv)
        top1, top5, nll = _numpy_scores(logits, yv, 128)
        validation = {"set_validation": got_val, "evaluator": ev_val,
                      "numpy": [top1, top5, nll],
                      "score": main_opt.state.score}
        log(f"validation: {json.dumps(validation)}")
        if got_val != ev_val:
            fails.append(f"set_validation {got_val} != Evaluator {ev_val}")
        if (named[0][1].correct, named[1][1].correct) != (top1, top5):
            fails.append(f"accuracies {named[0][1].correct}, "
                         f"{named[1][1].correct} != numpy {top1}, {top5}")
        if abs(got_val[2][0] - nll) > VAL_LOSS_REL * abs(nll):
            fails.append(f"validation loss {got_val[2][0]} vs numpy {nll}")
        if not DISTRI_VAL // 2 <= top1 <= top5:
            fails.append(f"the planted half of the labels reads Top1 {top1},"
                         f" Top5 {top5} of {DISTRI_VAL}")
        audit = main_opt._h2d.audit
        early = [c.elapsed_time(u) for c, u in audit
                 if c.elapsed_time(u) < 0]
        log(f"prefetch: {len(audit)} batches taken, read before their copy "
            f"completed: {len(early)}")
        if len(audit) != steps256 or early:
            fails.append(f"prefetch audit: {len(audit)} batches, {early} "
                         f"read early")
        del named, ev, logits, main_opt
        for name, kw in (("dp", dict(val=val)), ("fsdp", dict(fsdp=True)),
                         ("zero1", dict(zero1=True)),
                         ("buckets", dict(bucket_bytes=4 << 20)),
                         ("bf16_wire", dict(compress="bf16")),
                         ("fp16_wire", dict(compress="fp16"))):
            distri[name] = _train_run(model, w0, s0, d256, 256, mesh=mesh,
                                      **kw)
            distri[name]["bitwise"] = _same_bits(model, want_bits)
            log(f"dp=1 {name}: losses {distri[name]['losses']}; launches "
                f"{distri[name]['launches']}; bitwise to Local "
                f"{distri[name]['bitwise']}")
        distri["main"]["bitwise"] = main_bits
        # where the bf16 b256 step's time goes, with and without prefetch,
        # over the first DISTRI_PROFILE_STEPS steps
        d_prof = (x[:256 * DISTRI_PROFILE_STEPS],
                  y[:256 * DISTRI_PROFILE_STEPS])
        profiles = {
            "local": profile_steps(lambda: _train_run(
                model, w0, s0, d_prof, 256), steps=DISTRI_PROFILE_STEPS,
                classes=DISTRI_CLASSES, top=12,
                ranges=("_BNTrain", "_BNTrainBackward")),
            "dp1_prefetch": profile_steps(lambda: _train_run(
                model, w0, s0, d_prof, 256, mesh=mesh, prefetch=2),
                steps=DISTRI_PROFILE_STEPS, classes=DISTRI_CLASSES),
            "dp1": profile_steps(lambda: _train_run(
                model, w0, s0, d_prof, 256, mesh=mesh),
                steps=DISTRI_PROFILE_STEPS, classes=DISTRI_CLASSES)}
    finally:
        torch.distributed.destroy_process_group()
        mesh_lib.set_mesh(None)
        shutil.rmtree(store, ignore_errors=True)

    for name in ("main", "dp", "fsdp", "zero1", "buckets"):
        run = distri[name]
        if run["losses"] != runs["bf16_b256"]["losses"] or not run["bitwise"]:
            fails.append(f"dp=1 {name} is not bitwise LocalOptimizer's: "
                         f"{run['losses']} vs {runs['bf16_b256']['losses']}")
    for name in ("bf16_wire", "fp16_wire"):
        ls = distri[name]["losses"]
        rel = _max_rel(ls, distri["dp"]["losses"])
        distri[name]["max_rel_vs_fp32_wire"] = rel
        # a run that ignored compress would read 0 and the same weights
        if not (all(np.isfinite(ls)) and 0 < rel <= WIRE16_LOSS_REL
                and not distri[name]["bitwise"]):
            fails.append(f"{name}: losses {ls}, {rel:.3e} from the fp32 "
                         f"wire's, weights bitwise "
                         f"{distri[name]['bitwise']}")
    want = {fo.SGD_MOM: steps256 * per_update}
    for name, run in distri.items():
        if run["launches"] != want:
            fails.append(f"dp=1 {name}: launches {run['launches']}, "
                         f"expected {want}")
    if main_launches != want:
        fails.append(f"main path launches {main_launches}, expected {want}")
    if not runs["bf16_b256"]["losses"][-1] < runs["bf16_b256"]["losses"][0]:
        fails.append(f"bf16 b256 loss did not fall: "
                     f"{runs['bf16_b256']['losses']}")

    def h2d(p):
        return None if p is None else p["device_ms_by_class"].get(
            "memcpy H2D")
    readings = {
        "fp32_b64": _steady(runs["fp32_b64"], 64),
        "bf16_b64": _steady(runs["bf16_b64"], 64),
        "bf16_b256": _steady(runs["bf16_b256"], 256),
        "fp32_b256": fp32_b256,
        "dp1_b256": _steady(distri["dp"], 256),
        "dp1_b256_prefetch": _steady(distri["main"], 256),
        "fsdp1_b256": _steady(distri["fsdp"], 256),
        "zero1_b256": _steady(distri["zero1"], 256),
        "h2d_ms_per_step": {"no_prefetch": h2d(profiles["dp1"]),
                            "prefetch": h2d(profiles["dp1_prefetch"])},
        "peak_mem_gb": {"main_path": main_peak, "one_step": peaks},
        "profile": profiles}
    out = {"config": "resnet.build(class_num=1000, depth=50, dataset="
                     "'imagenet', format='NHWC', seed=0); DistriOptimizer("
                     "batch_size=256, mesh=create_mesh({'dp': 1}), "
                     "fused_optim=True), SGD(0.1, momentum=0.9, weight_decay"
                     "=1e-4), set_mixed_precision(), set_prefetch(2), "
                     "set_validation(every_epoch, 512 images, [Top1, Top5, "
                     "Loss]); NCCL at world size 1",
           "bn": bn, "bn_cudnn": bn_cudnn, "bf16_band": band,
           "validation": validation,
           "launches": main_launches, "readings": readings,
           "local": {k: {"losses": v["losses"], "launches": v["launches"]}
                     for k, v in runs.items()},
           "distri": {k: {kk: vv for kk, vv in v.items() if kk != "step_ms"}
                      for k, v in distri.items()},
           "card": card}
    log(f"distri: {json.dumps(out)}")
    if fails:
        raise AssertionError("distri phase: " + "; ".join(fails))
    return out


# --------------------------------------------------------------------- #
# phase_recipe: BigDL's ImageNet recipe from records on disk            #
# --------------------------------------------------------------------- #
RECIPE_TRAIN, RECIPE_VAL = 2048, 512          # records, in 4 and 1 files
RECIPE_TRAIN_FILES = 4
RECIPE_HW, RECIPE_CROP, RECIPE_BATCH = 256, 224, 256
RECIPE_RECORD = 4 + RECIPE_HW * RECIPE_HW * 3   # LE int32 label + BGR u8
RECIPE_CLASSES = 16             # labels 1..16, each with its own stripe
RECIPE_EPOCHS = 2               # 8 steps an epoch
# ImageNet's mean and std in 0..255 units, in the records' BGR order: the
# model sees BGR, as the reference's OpenCV pipeline feeds it
RECIPE_MEAN = (103.53, 116.28, 123.675)
RECIPE_STD = (57.375, 57.12, 58.395)
RECIPE_SGD = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
RECIPE_WARMUP = 0.0125          # 0.1 -> 0.1875 over the first 8 steps
RECIPE_L2 = 1e-4                # on the classifier's Linear
RECIPE_LR_REL = 1e-6            # device rate against the closed form
RECIPE_CLIP_REL = 1e-6          # clipped norm <= c * (1 + this)
RECIPE_ACCUM_STEPS = 4
RECIPE_PROFILE_STEPS = 2        # profiled
RECIPE_CLASSES_PROFILE = (("sgd_mom", "K5 fused_sgd_mom"),
                          ("memcpy htod", "memcpy H2D"),
                          ("memcpy", "memcpy, other"),
                          ("index", "augment gather (crop)"),
                          ("dgrad", "cuDNN conv backward"),
                          ("wgrad", "cuDNN conv backward"),
                          ("bprop", "cuDNN conv backward"),
                          ("fprop", "cuDNN conv forward"),
                          ("conv", "cuDNN conv, other"),
                          ("gemm", "matmul (cuBLAS)"),
                          ("nchw", "layout transposes"),
                          ("nhwc", "layout transposes"),
                          ("reduce", "reductions (BN statistics, norms)"),
                          ("pool", "pooling"), ("nccl", "NCCL"),
                          ("copy", "casts and copies"),
                          ("elementwise", "elementwise"))


def _recipe_schedule():
    from bigdl_tpu_torch.optim import Poly, SequentialSchedule, Warmup
    return SequentialSchedule(8).add(Warmup(RECIPE_WARMUP), 8) \
        .add(Poly(0.5, 8), 8)


def _recipe_rate(step: int) -> float:
    """The schedule's closed form (float64): lr + δ·s for s < 8, then
    lr·(1 − min((s − 8)/8, 1))^0.5."""
    lr = RECIPE_SGD["learning_rate"]
    if step < 8:
        return lr + RECIPE_WARMUP * step
    return lr * (1.0 - min((step - 8) / 8, 1.0)) ** 0.5


def _write_recipe_records(d, n, n_files, seed, prefix):
    """``n`` records of RECIPE_RECORD bytes in ``n_files`` files: a 1-based
    label, then 256x256x3 uint8 pixels from a seeded generator with a
    bright stripe whose rows and channel the label sets.  Returns the
    paths and the labels in file order."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, RECIPE_CLASSES + 1, n).astype(np.int32)
    per = n // n_files
    paths = []
    for f in range(n_files):
        px = rng.integers(0, 256, (per, RECIPE_HW, RECIPE_HW, 3),
                          dtype=np.uint8)
        lab = labels[f * per:(f + 1) * per]
        for i, c in enumerate(lab):
            row = 16 + 14 * (int(c) - 1)
            px[i, row:row + 10, :, int(c) % 3] = 255
        rec = np.empty((per, RECIPE_RECORD), np.uint8)
        rec[:, :4] = lab.astype("<i4").view(np.uint8).reshape(per, 4)
        rec[:, 4:] = px.reshape(per, -1)
        p = f"{d}/{prefix}{f}.bin"
        rec.tofile(p)
        paths.append(p)
    return paths, labels


def _recipe_decode(seen=None):
    """Record bytes -> ``Sample(uint8 HWC, label)``; appends each label
    to ``seen`` when given."""
    from bigdl_tpu_torch.data import Sample

    def decode(rec):
        label = int(np.frombuffer(rec, "<i4", 1)[0])
        if seen is not None:
            seen.append(label)
        px = np.frombuffer(rec, np.uint8, offset=4).reshape(
            RECIPE_HW, RECIPE_HW, 3)
        return Sample(px, np.float32(label))
    return decode


def _recipe_augment(dtype=None, out_format="NHWC"):
    from bigdl_tpu_torch.data import DeviceAugment
    return DeviceAugment(crop=(RECIPE_CROP, RECIPE_CROP), flip=True,
                         mean=RECIPE_MEAN, std=RECIPE_STD,
                         out_format=out_format,
                         dtype=dtype or torch.bfloat16)


class _Batches:
    """A dataset over fixed MiniBatches (for ``Evaluator.test``)."""

    def __init__(self, batches):
        self.batches = batches

    def data(self, train=False, epoch=None):
        return iter(self.batches)


def _recipe_run(model, w0, s0, mesh, train_paths, *, epochs, workers=2,
                fused=True, clip=None, val_ds=None, seen=None, accum=1,
                freeze=None, weight_decay=RECIPE_SGD["weight_decay"],
                probe=False, max_iter=None, profile_range=False):
    """One run of the recipe from the weights ``w0`` and BN state ``s0``:
    ``DistriOptimizer`` over ``mesh`` on the records through the native
    ring (``workers`` threads) at batch 256, bf16, prefetch 2, the device
    augment, ``SGD(0.1, momentum 0.9)`` under
    ``SequentialSchedule(Warmup, Poly)``, an L2 regularizer on the
    classifier and clipping by norm ``clip``.  Returns per-step losses,
    step ms (CUDA events), K5 launches, the rate, pre-clip and post-clip
    gradient norms the update saw each step (device scalars), and the
    optimizer."""
    from bigdl_tpu_torch.data import FileRecordDataSet, SampleToMiniBatch
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, Loss,
                                       Top1Accuracy, Top5Accuracy, Trigger)
    with torch.no_grad():
        for dst, src in zip(model.get_weights() + model.state_list(),
                            w0 + s0):
            dst.copy_(src)
    model.unfreeze()
    if freeze is not None:
        model.freeze(freeze)
    ds = FileRecordDataSet(train_paths, RECIPE_RECORD, _recipe_decode(seen),
                           n_workers=workers) >> SampleToMiniBatch(
                               RECIPE_BATCH)
    aug = _recipe_augment()
    if profile_range:
        plain_aug = aug

        def aug(x, gen=None, training=True):
            with torch.profiler.record_function("DeviceAugment"):
                return plain_aug(x, gen, training)
    opt = (DistriOptimizer(model, ds, ClassNLLCriterion(), mesh=mesh,
                           fused_optim=fused)
           .set_optim_method(SGD(learning_rate_schedule=_recipe_schedule(),
                                 **dict(RECIPE_SGD,
                                        weight_decay=weight_decay)))
           .set_end_when(Trigger.max_iteration(max_iter) if max_iter
                         else Trigger.max_epoch(epochs))
           .set_prefetch(2).set_mixed_precision().set_device_augment(aug)
           .set_gradient_accumulation(accum))
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    if val_ds is not None:
        opt.set_validation(Trigger.every_epoch(), val_ds,
                           [Top1Accuracy(), Top5Accuracy(), Loss()])
    seen_by_update = {"lr": [], "pre": [], "post": []}
    wrap = opt._wrap_optim

    def keep(params):
        clipped = wrap(params)
        sgd = clipped.inner
        orig = sgd.update

        def update(grads, p, state):
            # device scalars only: no host sync in the step
            seen_by_update["lr"].append(sgd.get_learning_rate(state))
            seen_by_update["pre"].append(clipped.last_norm)
            if not probe:
                seen_by_update["post"].append(
                    torch.sqrt(clipped._sum_sq(grads)))
            return orig(grads, p, state)
        sgd.update = update
        return clipped
    if clip is not None:
        opt._wrap_optim = keep
    losses, events = [], [torch.cuda.Event(enable_timing=True)]
    fire = opt._fire_mid_epoch

    def hook():
        losses.append(opt.state.loss)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return fire()
    opt._fire_mid_epoch = hook
    before = _build.launch_counts()
    events[0].record()
    opt.optimize()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    launches = {k: after.get(k, 0) - before.get(k, 0) for k in after
                if after.get(k, 0) != before.get(k, 0)}
    return {"losses": [float(v) for v in losses],
            "step_ms": [events[i].elapsed_time(events[i + 1])
                        for i in range(len(events) - 1)],
            "launches": launches, "opt": opt,
            "lr": [float(v) for v in seen_by_update["lr"]],
            "pre_norm": [float(v) for v in seen_by_update["pre"]],
            "post_norm": [float(v) for v in seen_by_update["post"]]}


def _host_parts(paths, batches):
    """Host time a batch by part over ``batches`` batches read through the
    ring with 2 workers: ring pop, decode, batching (ms a batch)."""
    from bigdl_tpu_torch.data import samples_to_minibatch
    from bigdl_tpu_torch.native import NativePrefetcher
    decode = _recipe_decode()
    pf = NativePrefetcher(paths, RECIPE_RECORD, n_workers=2)
    parts = {"ring_pop": 0.0, "decode": 0.0, "batching": 0.0}
    try:
        for _ in range(batches):
            buf = []
            for _ in range(RECIPE_BATCH):
                t0 = time.perf_counter()
                rec = pf.next()
                t1 = time.perf_counter()
                buf.append(decode(rec))
                t2 = time.perf_counter()
                parts["ring_pop"] += t1 - t0
                parts["decode"] += t2 - t1
            t0 = time.perf_counter()
            samples_to_minibatch(buf)
            parts["batching"] += time.perf_counter() - t0
    finally:
        pf.close()
    return {k: v * 1e3 / batches for k, v in parts.items()}


def _host_routes(images, batches, card):
    """The two host routes to a normalized fp32 NCHW batch of crops,
    without training: the native ``prepare_image_batch`` (4 threads) and
    the numpy transformer chain; ms a batch of 256."""
    from bigdl_tpu_torch.data import image as img
    from bigdl_tpu_torch.native import prepare_image_batch
    rng = np.random.default_rng(5)
    n = RECIPE_BATCH
    span = RECIPE_HW - RECIPE_CROP + 1
    t_native = []
    for b in range(batches):
        x = images[b * n:(b + 1) * n]
        offs = rng.integers(0, span, (n, 2)).astype(np.int32)
        flips = rng.integers(0, 2, n).astype(np.uint8)
        t0 = time.perf_counter()
        prepare_image_batch(x, RECIPE_CROP, RECIPE_CROP, offs, flips,
                            RECIPE_MEAN, RECIPE_STD, n_threads=4)
        t_native.append(time.perf_counter() - t0)
    chain = (img.BytesToBGRImg() >> img.BGRImgCropper(RECIPE_CROP,
                                                      RECIPE_CROP, seed=1)
             >> img.HFlip(0.5, seed=2)
             >> img.BGRImgNormalizer(RECIPE_MEAN, RECIPE_STD)
             >> img.BGRImgToBatch(n, to_rgb=False))
    t_chain = []
    for b in range(batches):
        x = images[b * n:(b + 1) * n]
        t0 = time.perf_counter()
        for _ in chain(zip(x, np.ones(n))):
            pass
        t_chain.append(time.perf_counter() - t0)
    out = {"native_prepare_4_threads_ms": float(np.median(t_native)) * 1e3,
           "numpy_chain_ms": float(np.median(t_chain)) * 1e3,
           "batches": batches, "card": card}
    log(f"host routes a batch of {n}: {json.dumps(out)}")
    return out


def _h2d_ms(card):
    """H2D of one batch from pinned memory by CUDA events (median of 5):
    uint8 records (256x256x256x3) against fp32 host-prepared crops
    (256x3x224x224)."""
    out = {}
    for name, shape, dtype in (
            ("uint8_256x256x256x3", (RECIPE_BATCH, RECIPE_HW, RECIPE_HW, 3),
             torch.uint8),
            ("fp32_256x3x224x224", (RECIPE_BATCH, 3, RECIPE_CROP,
                                    RECIPE_CROP), torch.float32)):
        host = torch.zeros(shape, dtype=dtype, pin_memory=True)
        dev = torch.empty(shape, dtype=dtype, device="cuda")
        out[name] = {"ms": cuda_ms(lambda: dev.copy_(host, non_blocking=True),
                                   iters=5, warm=1),
                     "mb": host.numel() * host.element_size() / 1e6}
        del host, dev
    out["card"] = card
    log(f"H2D a batch: {json.dumps(out)}")
    return out


def _augment_checks(images, fails):
    """DeviceAugment at the host transformers' draws against the host
    chain (BGRImgCropper -> HFlip -> BGRImgNormalizer -> BGRImgToBatch,
    BGR kept), bitwise: the crop and flip move the same bytes, and the
    normalization is the same IEEE fp32 subtract and divide on the same
    integer values on both sides (PyTorch builds its CUDA kernels without
    fast math).  The bf16 NHWC output of the main path is that fp32
    value rounded once: bitwise the host's fp32 cast to bf16.  Also
    ``prepare_image_batch`` against its plain version, bitwise."""
    from bigdl_tpu_torch.data import image as img
    from bigdl_tpu_torch.native import (prepare_image_batch,
                                        prepare_image_batch_plain)
    n = 32
    x = images[:n]
    host = (img.BytesToBGRImg() >> img.BGRImgCropper(
        RECIPE_CROP, RECIPE_CROP, seed=31) >> img.HFlip(0.5, seed=32)
        >> img.BGRImgNormalizer(RECIPE_MEAN, RECIPE_STD)
        >> img.BGRImgToBatch(n, to_rgb=False))
    (mb,) = list(host(zip(x, np.ones(n))))
    crop_rng, flip_rng = np.random.RandomState(31), np.random.RandomState(32)
    span = RECIPE_HW - RECIPE_CROP + 1
    oy, ox, flips = [], [], []
    for _ in range(n):
        oy.append(crop_rng.randint(0, span))
        ox.append(crop_rng.randint(0, span))
        flips.append(flip_rng.uniform() < 0.5)
    xd = torch.from_numpy(x).cuda()
    draws = [torch.tensor(v, device="cuda") for v in (oy, ox, flips)]
    f32 = _recipe_augment(torch.float32, "NCHW").apply(xd, *draws)
    bf16 = _recipe_augment().apply(xd, *draws)
    want = torch.from_numpy(mb.get_input())
    res = {"fp32_bitwise": torch.equal(f32.cpu(), want),
           "fp32_max_abs_err": (f32.cpu() - want).abs().max().item(),
           "bf16_nhwc_bitwise": torch.equal(
               bf16.cpu(), want.permute(0, 2, 3, 1).bfloat16()),
           "flips": int(sum(flips))}
    rng = np.random.default_rng(33)
    offs = rng.integers(0, span, (RECIPE_BATCH, 2)).astype(np.int32)
    fl = rng.integers(0, 2, RECIPE_BATCH).astype(np.uint8)
    a = prepare_image_batch(images[:RECIPE_BATCH], RECIPE_CROP, RECIPE_CROP,
                            offs, fl, RECIPE_MEAN, RECIPE_STD, n_threads=4)
    b = prepare_image_batch_plain(images[:RECIPE_BATCH], RECIPE_CROP,
                                  RECIPE_CROP, offs, fl, RECIPE_MEAN,
                                  RECIPE_STD)
    res["prepare_image_batch_bitwise"] = bool(np.array_equal(a, b))
    log(f"augment against the host chain: {json.dumps(res)}")
    for k in ("fp32_bitwise", "bf16_nhwc_bitwise",
              "prepare_image_batch_bitwise"):
        if not res[k]:
            fails.append(f"augment check {k} failed: {res}")
    return res


def phase_recipe(card: str, distri_prefetch: dict) -> dict:
    """BigDL's ImageNet recipe on ResNet-50 from records on disk: the
    native ring, decode and batching on the host, uint8 on the wire, the
    augmentation on the card, DistriOptimizer at dp=1 over NCCL in bf16 at
    batch 256 with SequentialSchedule(Warmup, Poly), an L2 regularizer,
    clipping by norm and validation, K5 counted."""
    import collections
    import shutil
    import tempfile

    from bigdl_tpu_torch import native
    from bigdl_tpu_torch.data import FileRecordDataSet, SampleToMiniBatch
    from bigdl_tpu_torch.data.minibatch import MiniBatch
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import (Evaluator, L2Regularizer, Loss,
                                       Top1Accuracy, Top5Accuracy)
    from bigdl_tpu_torch.parallel import mesh as mesh_lib

    fails = []
    t0 = time.monotonic()
    lib = native.load()
    built = {"library": str(_build.native_target().relative_to(
        _build.NATIVE_DIR.parents[1])), "sources": [
        str((_build.NATIVE_SRC / f"{n}.cpp").relative_to(
            _build.NATIVE_DIR.parents[1])) for n in _build.NATIVE_SOURCES]}
    if lib._name != str(_build.native_target()) \
            or any("bigdl_tpu/" in s for s in built["sources"]):
        fails.append(f"native runtime not built from the port's sources: "
                     f"{built}")
    log(f"native runtime: {json.dumps(built)}")
    work = tempfile.mkdtemp(prefix="recipe_", dir=str(_build.BUILD_DIR))
    try:
        train_paths, train_labels = _write_recipe_records(
            work, RECIPE_TRAIN, RECIPE_TRAIN_FILES, 12, "train")
        val_paths, _ = _write_recipe_records(work, RECIPE_VAL, 1, 13, "val")
        write_s = time.monotonic() - t0
        # the ring against the plain reader: the same multiset of records
        t1 = time.monotonic()
        pf = native.NativePrefetcher(train_paths, RECIPE_RECORD, n_workers=2)
        ring = list(pf)
        pf.close()
        ring_s = time.monotonic() - t1
        plain = list(native.read_records_plain(train_paths, RECIPE_RECORD))
        ring_ok = collections.Counter(ring) == collections.Counter(plain)
        images = np.stack([np.frombuffer(r, np.uint8, offset=4).reshape(
            RECIPE_HW, RECIPE_HW, 3) for r in plain[:2 * RECIPE_BATCH]])
        del ring, plain
        if not ring_ok:
            fails.append("the ring's records are not read_records_plain's")
        log(f"records written in {write_s:.1f} s; ring: {RECIPE_TRAIN} "
            f"records in {ring_s:.3f} s, same multiset as the plain reader "
            f"{ring_ok}")
        augment = _augment_checks(images, fails)
        host_parts = _host_parts(train_paths, 2)
        routes = _host_routes(images, 2, card)
        h2d = _h2d_ms(card)

        model = resnet.build(class_num=1000, depth=50, dataset="imagenet",
                             format="NHWC", seed=0)
        fc = [m for m in model.modules() if type(m).__name__ == "Linear"][-1]
        fc.w_regularizer = L2Regularizer(RECIPE_L2)
        first_stage = [m for m in model.modules()
                       if type(m).__name__ == "Sequential"][1].name
        w0 = [w.clone() for w in model.get_weights()]
        s0 = [s.clone() for s in model.state_list()]
        init = {n: {k: v.detach().clone() for k, v in sub.items()}
                for n, sub in model.param_dict().items()}
        per_update = -(-len(w0) // fo.SGD_CAPACITY)
        store = tempfile.mkdtemp(prefix="recipe_pg_",
                                 dir=str(_build.BUILD_DIR))
        mesh_lib.init_distributed(f"file://{store}/store", 0, 1)
        mesh = mesh_lib.create_mesh({"dp": 1})
        try:
            # the clipping norm: the median of an unclipped epoch's global
            # gradient norms (an infinite c computes them and scales by 1)
            probe = _recipe_run(model, w0, s0, mesh, train_paths, epochs=1,
                                clip=float("inf"), probe=True)
            clip = float(np.median(probe["pre_norm"]))
            log(f"probe: norms {probe['pre_norm']}; clip at {clip}")
            # bitwise: one worker (file order), fused on and off
            bitwise = {}
            finals = {}
            for fused in (True, False):
                run = _recipe_run(model, w0, s0, mesh, train_paths, epochs=1,
                                  workers=1, fused=fused, clip=clip)
                finals[fused] = [t.clone() for t in model.get_weights()
                                 + model.state_list()]
                bitwise[f"fused={fused}"] = {
                    "losses": run["losses"], "launches": run["launches"]}
            same = bitwise["fused=True"]["losses"] == \
                bitwise["fused=False"]["losses"] and all(
                    torch.equal(a, b) for a, b in zip(finals[True],
                                                      finals[False]))
            del finals
            log(f"n_workers=1, fused on/off: bitwise {same}; "
                f"{json.dumps(bitwise)}")
            if not same:
                fails.append(f"fused and plain runs differ: {bitwise}")
            if bitwise["fused=True"]["launches"] != {fo.SGD_MOM:
                                                     8 * per_update} \
                    or bitwise["fused=False"]["launches"]:
                fails.append(f"bitwise runs' launches: {bitwise}")

            # the main path: counts from 0, peak memory from a reset
            val_ds = FileRecordDataSet(val_paths, RECIPE_RECORD,
                                       _recipe_decode(), n_workers=1) \
                >> SampleToMiniBatch(128)
            seen = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            main = _recipe_run(model, w0, s0, mesh, train_paths,
                               epochs=RECIPE_EPOCHS, clip=clip,
                               val_ds=val_ds, seen=seen)
            main_launches = _build.launch_counts()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            main_opt = main.pop("opt")
            steps = RECIPE_EPOCHS * RECIPE_TRAIN // RECIPE_BATCH
            want_counts = collections.Counter(train_labels.tolist())
            per_epoch = [collections.Counter(seen[e * RECIPE_TRAIN:
                                                  (e + 1) * RECIPE_TRAIN])
                         for e in range(RECIPE_EPOCHS)]
            once = len(seen) == RECIPE_EPOCHS * RECIPE_TRAIN and all(
                c == want_counts for c in per_epoch)
            if not once:
                fails.append(f"records read {len(seen)} times in "
                             f"{RECIPE_EPOCHS} epochs, not once an epoch")
            if main_launches != {fo.SGD_MOM: steps * per_update} \
                    or main["launches"] != main_launches:
                fails.append(f"main path launches {main_launches}, "
                             f"expected {steps * per_update}")
            lr_err = max(abs(got - _recipe_rate(s)) / _recipe_rate(s)
                         for s, got in enumerate(main["lr"])
                         if _recipe_rate(s) > 0)
            if len(main["lr"]) != steps or lr_err > RECIPE_LR_REL:
                fails.append(f"learning rates {main['lr']} off the closed "
                             f"form by {lr_err:.3e}")
            fired = [p > clip for p in main["pre_norm"]]
            clip_bad = [s for s, (f, pre, post) in enumerate(zip(
                fired, main["pre_norm"], main["post_norm"]))
                if (f and not post <= clip * (1 + RECIPE_CLIP_REL))
                or (not f and post != pre)]
            if clip_bad or all(fired) or not any(fired):
                fails.append(f"clipping at {clip}: fired {fired}, steps "
                             f"{clip_bad} wrong (pre {main['pre_norm']}, "
                             f"post {main['post_norm']})")
            ls = main["losses"]
            if not (all(np.isfinite(ls)) and ls[-1] < ls[0]):
                fails.append(f"recipe losses {ls}")

            # validation against Evaluator.test on the same records, half
            # of the labels set to the trained model's own classes (the
            # validation's eval step runs the augment's center crop and
            # normalization itself; Evaluator gets them applied)
            eval_step = main_opt._eval_step
            params, state = model.param_dict(), model.initial_state()
            in_run = [r.result() for _, r in main_opt.last_validation]
            aug = _recipe_augment()
            batches, preds = [], []
            for mb in val_ds.data(train=False):
                raw = torch.from_numpy(mb.get_input()).cuda()
                preds.append(torch.argmax(eval_step(params, state, raw)
                                          .float(), 1).cpu().numpy() + 1)
                batches.append([aug(raw, training=False), mb.get_target()])
            preds = np.concatenate(preds)
            records = np.fromfile(val_paths[0], np.uint8).reshape(
                RECIPE_VAL, RECIPE_RECORD)
            half = RECIPE_VAL // 2
            records[:half, :4] = preds[:half].astype("<i4").view(
                np.uint8).reshape(half, 4)
            records.tofile(val_paths[0])
            k = 0
            for b in batches:
                n = b[0].shape[0]
                labels = b[1].copy()
                top = max(0, min(n, half - k))
                labels[:top] = preds[k:k + top]
                b[1] = labels
                k += n
            named = main_opt._validate(
                main_opt._params_for_eval(params), state)
            got_val = [r.result() for _, r in named]
            ev = Evaluator(model, batch_size=128).test(
                _Batches([MiniBatch(x, y) for x, y in batches]),
                [Top1Accuracy(), Top5Accuracy(), Loss()])
            ev_val = [r.result() for _, r in ev]
            validation = {"in_run_epoch_2": in_run,
                          "set_validation": got_val, "evaluator": ev_val,
                          "score": main_opt.state.score}
            log(f"recipe validation: {json.dumps(validation)}")
            if got_val != ev_val:
                fails.append(f"validation {got_val} != Evaluator {ev_val}")
            if not half <= named[0][1].correct <= named[1][1].correct:
                fails.append(f"the planted half reads Top1 "
                             f"{named[0][1].correct}, Top5 "
                             f"{named[1][1].correct} of {RECIPE_VAL}")
            del main_opt, named, ev, batches

            # accumulation 2 x 128 with the first stage frozen (no weight
            # decay: SGD's decay moves frozen weights, as the reference's)
            accum = _recipe_run(model, w0, s0, mesh, train_paths, epochs=1,
                                clip=clip, accum=2, freeze=[first_stage],
                                weight_decay=0.0,
                                max_iter=RECIPE_ACCUM_STEPS)
            accum.pop("opt")
            frozen = model.frozen_param_names()
            moved_frozen = [f"{n}.{kk}" for n, sub in
                            model.param_dict().items() if n in frozen
                            for kk, v in sub.items()
                            if not torch.equal(v, init[n][kk])]
            moved_other = sum(not torch.equal(v, init[n][kk])
                              for n, sub in model.param_dict().items()
                              if n not in frozen for kk, v in sub.items())
            model.unfreeze()
            accum_res = {"losses": accum["losses"],
                         "launches": accum["launches"],
                         "frozen_modules": len(frozen),
                         "frozen_moved": moved_frozen,
                         "others_moved": moved_other}
            log(f"accumulation 2 x 128 with {first_stage} frozen: "
                f"{json.dumps(accum_res)}")
            if moved_frozen or not moved_other or accum["launches"] != {
                    fo.SGD_MOM: RECIPE_ACCUM_STEPS * per_update} or not all(
                    np.isfinite(accum["losses"])):
                fails.append(f"accumulation/freeze run: {accum_res}")

            # where the device time goes: the first steps of an epoch
            # under the profiler
            profile = profile_steps(lambda: _recipe_run(
                model, w0, s0, mesh, train_paths, epochs=1, clip=clip,
                profile_range=True, max_iter=RECIPE_PROFILE_STEPS),
                steps=RECIPE_PROFILE_STEPS,
                classes=RECIPE_CLASSES_PROFILE, ranges=("DeviceAugment",))
        finally:
            torch.distributed.destroy_process_group()
            mesh_lib.set_mesh(None)
            shutil.rmtree(store, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    steady = _steady(main, RECIPE_BATCH)
    readings = {
        "step_ms_median": steady["step_ms_median"],
        "images_per_s": steady["images_per_s"],
        "step_ms": main["step_ms"],
        "beside_phase_distri_prefetch": distri_prefetch,
        "h2d_a_batch": h2d,
        "host_ms_a_batch": host_parts,
        "ring_records_per_s": RECIPE_TRAIN / ring_s,
        "host_routes": routes,
        "profile": profile,
        "peak_mem_gb": peak_gb,
        "phase_s": time.monotonic() - t0}
    out = {"config": "resnet.build(class_num=1000, depth=50, dataset="
                     "'imagenet', format='NHWC', seed=0), L2Regularizer(1e-4)"
                     " on fc1000; DistriOptimizer(FileRecordDataSet(4 files "
                     "of 512 records, n_workers=2) >> SampleToMiniBatch(256), "
                     "mesh=create_mesh({'dp': 1}), fused_optim=True), SGD(0.1,"
                     " momentum=0.9, weight_decay=1e-4, SequentialSchedule(8)"
                     ".add(Warmup(0.0125), 8).add(Poly(0.5, 8), 8)), "
                     "set_mixed_precision(), set_prefetch(2), "
                     "set_device_augment(DeviceAugment(crop=(224, 224), "
                     "flip=True, BGR mean/std, NHWC, bf16)), "
                     "set_gradient_clipping_by_l2_norm(median of an unclipped"
                     " epoch), set_validation(every_epoch, 512 records, "
                     "[Top1, Top5, Loss]); 2 epochs; NCCL at world size 1",
           "channel_order": "BGR (records as stored; mean/std given BGR)",
           "clip_norm": clip, "probe_norms": probe["pre_norm"],
           "losses": main["losses"], "lr": main["lr"],
           "pre_clip_norm": main["pre_norm"],
           "post_clip_norm": main["post_norm"],
           "lr_max_rel_err": lr_err, "records_once_an_epoch": once,
           "ring_same_multiset": ring_ok, "augment": augment,
           "bitwise_workers1": bitwise, "validation": validation,
           "accumulation_freeze": accum_res, "launches": main_launches,
           "readings": readings, "card": card}
    log(f"recipe: {json.dumps(out)}")
    if fails:
        raise AssertionError("recipe phase: " + "; ".join(fails))
    return out


# --------------------------------------------------------------------- #
# phase_vgg: the nn shell on the card (VGG-16 CIFAR-10, LeNet's Graph,  #
# ResNet-50 with the s2d stem, Remat and sync BN)                       #
# --------------------------------------------------------------------- #
VGG_BATCH, VGG_STEPS_PER_EPOCH, VGG_VAL = 512, 6, 512   # one epoch
VGG_DROPOUT_SHAPE = (512, 32, 32, 64)   # the first Dropout(0.3)'s input
VGG_DROPOUT_P, VGG_DROPOUT_SHARE_TOL = 0.4, 0.005
RES_IMAGES, RES_BATCH = 1024, 256       # leg (c): one epoch of 4 steps
RES_BIG_BATCH, RES_BIG_IMAGES = 512, 1024   # and B at b512, one epoch of 2
RES_BAND_REL = BF16_LOSS_REL            # C against A, every step
# leg (c)'s parts on their own, at the shapes C gives them.  The s2d stem
# against the plain 7x7/2 conv on the same weights, fp32 with TF32 off,
# relative to the largest entry: both are fp32 sums of the same 147
# products a pixel in other orders (~1e-6); the weight gradient sums 3.2 M
# of them a tap, held to the repo's per-leaf gradient rule.  A planted
# fault (the kernel regrouped in the order (0, 5, 3, 1, 2, 4)) must fail
# S2D_REL.
S2D_SHAPE = (256, 224, 224, 3)
S2D_REL, S2D_DW_REL = 1e-5, 1e-4
# sync BN at world size 1 against _BNTrain on C's first BN: in fp32 both
# compute max(E[x²] − mean², 0) in fp32, so every output and the running
# statistics within BN_F32_REL; in bf16, against autograd through the
# fp32 formula, y and dx within _BNTrain's limit BN_BF16_OUT_REL, and
# dgamma and dbeta within the bf16 band BF16_LOSS_REL: autodiff rounds
# the cotangents of the bf16 scale and shift to bf16 before they combine,
# as the reference's sync path does
SYNC_BN_SHAPE = (256, 112, 112, 64)


def _cifar_nhwc(n, seed):
    """``n`` images of ``data/cifar.py``'s synthetic CIFAR-10, normalized
    by its per-channel mean and std, NHWC fp32, with 1-based labels."""
    from bigdl_tpu_torch.data import cifar
    x, y = cifar._synthetic(n, seed)
    mean = np.asarray(cifar.TRAIN_MEAN, np.float32)[:, None, None]
    std = np.asarray(cifar.TRAIN_STD, np.float32)[:, None, None]
    xf = ((x.astype(np.float32) - mean) / std).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(xf), (y.astype(np.float32) + 1)


def _dropout_check(fails):
    """One Dropout(0.4) forward on a bf16 tensor of VGG's first stage:
    the zeroed share, and every kept value x / bf16(0.6) rounded to
    bf16."""
    from bigdl_tpu_torch.nn import Ctx, Dropout
    g = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.rand(VGG_DROPOUT_SHAPE, device="cuda", generator=g)
         + 0.5).to(torch.bfloat16)
    d = Dropout(VGG_DROPOUT_P)
    y = d.apply({}, x, Ctx(training=True, generator=g))
    zero = float((y == 0).float().mean())
    kept = y != 0
    want = (x.float() / torch.tensor(1 - VGG_DROPOUT_P,
                                     dtype=torch.bfloat16).float()
            ).to(torch.bfloat16)
    exact = bool(torch.equal(y[kept], want[kept]))
    fp32_scale = bool(torch.equal(y[kept], (x.float() / (1 - VGG_DROPOUT_P))
                                  .to(torch.bfloat16)[kept]))
    out = {"shape": list(VGG_DROPOUT_SHAPE), "p": VGG_DROPOUT_P,
           "zero_share": zero, "kept_bitwise_x_over_bf16_keep": exact,
           "kept_equal_fp32_division": fp32_scale}
    log(f"dropout: {json.dumps(out)}")
    if abs(zero - VGG_DROPOUT_P) > VGG_DROPOUT_SHARE_TOL or not exact:
        fails.append(f"Dropout({VGG_DROPOUT_P}) on bf16: {out}")
    return out


def _shell_run(model, w0, data, steps, lr):
    """``steps`` steps of the Torch-shell loop (forward,
    Criterion.forward/backward, backward, update_parameters,
    zero_grad_parameters) from the weights ``w0``; returns the losses and
    the final weights."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    x, y, batch = data
    with torch.no_grad():
        for dst, src in zip(model.get_weights(), w0):
            dst.copy_(src)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    crit = ClassNLLCriterion()
    model.train()
    losses = []
    for i in range(steps):
        lo = (i * batch) % len(x)
        xb, yb = xd[lo:lo + batch], yd[lo:lo + batch]
        out = model.forward(xb)
        losses.append(crit.forward(out, yb).detach())
        model.backward(xb, crit.backward(out, yb))
        model.update_parameters(lr)
        model.zero_grad_parameters()
    model.evaluate()
    return ([float(v) for v in losses],
            [w.detach().clone() for w in model.get_weights()])


def _vgg_leg(card, fails):
    """Leg (a): VGG-16 CIFAR-10 at the reference's benchmark setting."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import vgg
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import Evaluator, Predictor, Top1Accuracy

    model = vgg.build(class_num=10, dataset="cifar10", format="NHWC",
                      seed=0)
    w0 = [w.clone() for w in model.get_weights()]
    s0 = [s.clone() for s in model.state_list()]
    n_params = sum(w.numel() for w in w0)
    n_drop = sum(type(m).__name__ == "Dropout" for m in model.modules())
    log(f"VGG-16 CIFAR-10 built: {len(w0)} leaves, {n_params} params, "
        f"{n_drop} Dropout layers")
    x, y = _cifar_nhwc(VGG_BATCH * VGG_STEPS_PER_EPOCH, 0)
    xv, yv = _cifar_nhwc(VGG_VAL, 1)
    steps = DISTRI_EPOCHS * VGG_STEPS_PER_EPOCH
    per_update = -(-len(w0) // fo.SGD_CAPACITY)
    dropout = _dropout_check(fails)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    main = _train_run(model, w0, s0, (x, y), VGG_BATCH, val=(xv, yv),
                      keep_opt=True)
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    opt = main.pop("opt")
    val = [r.result() for _, r in opt.last_validation]
    final = [t.clone() for t in model.get_weights() + model.state_list()]
    # inference twice: dropout is off, so the same bits
    p1 = Predictor(model, batch_size=VGG_VAL).predict(xv)
    p2 = Predictor(model, batch_size=VGG_VAL).predict(xv)
    ev1 = [r.result() for _, r in Evaluator(model, VGG_VAL).test(
        (xv, yv), [Top1Accuracy()])]
    ev2 = [r.result() for _, r in Evaluator(model, VGG_VAL).test(
        (xv, yv), [Top1Accuracy()])]
    plain = _train_run(model, w0, s0, (x, y), VGG_BATCH, fused=False)
    plain_bits = _same_bits(model, final)
    other = _train_run(model, w0, s0, (x, y), VGG_BATCH, seed=1)
    if _build.launch_counts() != {fo.SGD_MOM: 2 * steps * per_update}:
        fails.append(f"VGG: the plain run launched, or the seed=1 run did "
                     f"not: {_build.launch_counts()}")
    n_prof = 2 * VGG_BATCH                  # 2 steps profiled
    profile = profile_steps(lambda: _train_run(
        model, w0, s0, (x[:n_prof], y[:n_prof]), VGG_BATCH), steps=2,
        classes=DISTRI_CLASSES, top=12,
        ranges=("_BNTrain", "_BNTrainBackward"))
    want = {fo.SGD_MOM: steps * per_update}
    if launches != want:
        fails.append(f"VGG launches {launches}, expected {want}")
    if main["losses"] != plain["losses"] or not plain_bits:
        fails.append(f"VGG fused and plain differ: {main['losses']} vs "
                     f"{plain['losses']}, weights bitwise {plain_bits}")
    if other["losses"] == main["losses"]:
        fails.append("VGG: the seed=1 run gave the seed=0 losses: the "
                     "dropout draws do not reach the model")
    if not (np.array_equal(p1, p2) and ev1 == ev2):
        fails.append(f"VGG: two evaluations differ: Top1 {ev1} vs {ev2}")
    if not all(np.isfinite(main["losses"])) or not \
            main["losses"][-1] < main["losses"][0]:
        fails.append(f"VGG loss did not fall: {main['losses']}")
    if not (np.isfinite(p1).all() and p1.shape == (VGG_VAL, 10)):
        fails.append(f"VGG predictions {p1.shape}, finite "
                     f"{np.isfinite(p1).all()}")
    return {"config": "vgg.build(class_num=10, dataset='cifar10', format="
                      "'NHWC', seed=0), dropout on; LocalOptimizer(batch_"
                      "size=512, seed=0), set_mixed_precision(), SGD(0.1, "
                      "momentum=0.9, weight_decay=1e-4, fused=True), one "
                      "epoch of 6 steps on synthetic CIFAR-10, "
                      "set_validation(every_epoch, 512 images, [Top1, Top5,"
                      " Loss])",
            "leaves": len(w0), "params": n_params, "dropout_layers": n_drop,
            "losses": main["losses"], "losses_plain": plain["losses"],
            "losses_seed1": other["losses"],
            "fused_vs_plain_bitwise": main["losses"] == plain["losses"]
            and plain_bits, "validation": val, "top1_twice": [ev1, ev2],
            "dropout": dropout, "launches": launches,
            "readings": {**_steady(main, VGG_BATCH), "peak_mem_gb": peak,
                         "profile": profile}}


def _lenet_graph_leg(fails):
    """Leg (b): LeNet-5 as a Graph against the Sequential, through the
    Torch shell and through LocalOptimizer on K6."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import SGD

    seq, graph = lenet.build(10, seed=0), lenet.build_graph(10, seed=0)
    w0 = [w.clone() for w in seq.get_weights()]
    same_init = all(torch.equal(a, b) for a, b in zip(
        w0, graph.get_weights()))
    rs = np.random.RandomState(3)
    lx = rs.randn(LENET_ROWS, 1, 28, 28).astype(np.float32)
    proj = rs.randn(784, 10).astype(np.float32)
    ly = (np.argmax(lx.reshape(LENET_ROWS, -1) @ proj, 1) + 1).astype(
        np.float32)
    data = (lx, ly, LENET_BATCH)
    steps = LENET_EPOCHS * LENET_ROWS // LENET_BATCH
    shell = {name: _shell_run(m, w0, data, steps, LENET_SGD["learning_rate"])
             for name, m in (("sequential", seq), ("graph", graph))}
    shell_bits = (shell["sequential"][0] == shell["graph"][0] and all(
        torch.equal(a, b) for a, b in zip(shell["sequential"][1],
                                          shell["graph"][1])))
    loop, launches = {}, {}
    for name, m in (("graph", graph), ("sequential", seq)):
        _build.reset_launch_counts()
        loop[name], _ = _classifier_run(m, data, SGD(fused=True,
                                                     **LENET_SGD),
                                        LENET_EPOCHS, w0, [])
        launches[name] = _build.launch_counts()
    loop_bits = loop["graph"] == loop["sequential"] and all(
        torch.equal(a, b) for a, b in zip(seq.get_weights(),
                                          graph.get_weights()))
    want = {fo.SGD_PLAIN: -(-len(w0) // fo.SGD_CAPACITY) * steps}
    if not same_init:
        fails.append("lenet.build_graph(seed=0) drew other weights than "
                     "lenet.build(seed=0)")
    if not shell_bits:
        fails.append(f"LeNet Torch shell: Graph {shell['graph'][0]} vs "
                     f"Sequential {shell['sequential'][0]}")
    if not loop_bits:
        fails.append(f"LeNet LocalOptimizer: Graph {loop['graph']} vs "
                     f"Sequential {loop['sequential']}")
    if any(v != want for v in launches.values()):
        fails.append(f"LeNet launches {launches}, expected {want} each")
    for name, losses in (("shell", shell["graph"][0]),
                         ("loop", loop["graph"])):
        if not losses[-1] < losses[0]:
            fails.append(f"LeNet {name} loss did not fall: {losses}")
    return {"config": "lenet.build_graph(10, seed=0) against lenet.build("
                      "10, seed=0): 8 steps of the Torch shell at lr 0.05, "
                      "then LocalOptimizer SGD(0.05, fused=True)",
            "shell_losses": shell["graph"][0],
            "shell_bitwise": shell_bits, "loop_losses": loop["graph"],
            "loop_bitwise": loop_bits, "launches_by_run": launches,
            "launches": launches["graph"]}


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()
            ).item()


def _s2d_check(fails):
    """``SpaceToDepthConvolution`` against ``SpatialConvolution`` on the
    same weights at ResNet-50's stem (S2D_SHAPE, fp32): the output and the
    weight gradient; then the planted wrong regroup order."""
    from bigdl_tpu_torch.nn import (Ctx, SpaceToDepthConvolution,
                                    SpatialConvolution)
    args = (3, 64, 7, 7, 2, 2, 3, 3)
    conv = SpatialConvolution(*args, with_bias=False, format="NHWC")
    s2d = SpaceToDepthConvolution(*args, with_bias=False, format="NHWC")
    g = torch.Generator(device="cuda").manual_seed(5)
    w = conv.weight.detach().cuda().requires_grad_()
    x = torch.randn(S2D_SHAPE, device="cuda", generator=g)
    dy = torch.randn((S2D_SHAPE[0], 112, 112, 64), device="cuda",
                     generator=g)

    def run(m):
        y = m.apply({m.name: {"weight": w}}, x, Ctx())
        return y.detach(), torch.autograd.grad(y, w, dy)[0]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        (y0, g0), (y1, g1) = run(conv), run(s2d)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    permute = torch.Tensor.permute

    def swapped(t, *dims):
        return permute(t, *((0, 5, 3, 1, 2, 4) if dims == (0, 3, 5, 1, 2, 4)
                            else dims))
    torch.Tensor.permute = swapped
    try:
        with torch.no_grad():
            y2 = s2d.apply({s2d.name: {"weight": w}}, x, Ctx())
    finally:
        torch.Tensor.permute = permute
    out = {"shape": list(S2D_SHAPE), "y_rel": _rel(y1, y0),
           "dw_rel": _rel(g1, g0), "planted_y_rel": _rel(y2, y0),
           "limits": [S2D_REL, S2D_DW_REL]}
    log(f"s2d stem against the plain conv: {json.dumps(out)}")
    if not (out["y_rel"] <= S2D_REL and out["dw_rel"] <= S2D_DW_REL):
        fails.append(f"s2d stem against the plain conv: {out}")
    if not out["planted_y_rel"] > S2D_REL:
        fails.append(f"the planted s2d regroup passed: {out}")
    return out


def _bn_train_pass(sync, x, dy, gamma, beta):
    """One training pass of an NHWC ``SpatialBatchNormalization``, with
    ``sync_axis="dp"`` or on ``_BNTrain``: y, dx, dgamma, dbeta and the new
    running mean and variance, in fp32."""
    from bigdl_tpu_torch.nn import Ctx, SpatialBatchNormalization
    m = SpatialBatchNormalization(x.shape[-1], format="NHWC",
                                  sync_axis="dp" if sync else None).cuda()
    xx = x.detach().requires_grad_()
    gg, bb = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    ctx = Ctx(state=m.initial_state(), training=True)
    y = m.apply({m.name: {"weight": gg, "bias": bb}}, xx, ctx)
    grads = torch.autograd.grad(y, (xx, gg, bb), dy)
    st = ctx.new_state[m.name]
    return [t.detach().float() for t in (y, *grads, st["running_mean"],
                                         st["running_var"])]


def _sync_bn_check(fails):
    """Sync BN at world size 1 (NCCL) against ``_BNTrain`` on C's first BN
    (SYNC_BN_SHAPE), fp32 and bf16; inside the current dp mesh."""
    g = torch.Generator(device="cuda").manual_seed(9)
    c = SYNC_BN_SHAPE[-1]
    x = torch.randn(SYNC_BN_SHAPE, device="cuda", generator=g) * 2 + 1
    dy = torch.randn(SYNC_BN_SHAPE, device="cuda", generator=g)
    gamma = torch.rand(c, device="cuda", generator=g) + 0.5
    beta = torch.randn(c, device="cuda", generator=g)
    names = ("y", "dx", "dgamma", "dbeta", "running_mean", "running_var")
    sync = _bn_train_pass(True, x, dy, gamma, beta)
    plain = _bn_train_pass(False, x, dy, gamma, beta)
    f32 = {n: _rel(a, b) for n, a, b in zip(names, sync, plain)}
    xb, dyb = x.bfloat16(), dy.bfloat16()
    xf = xb.float().requires_grad_()
    gf, bf = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    yf = _old_bn(xf, gf, bf, 3, 1e-5)[0]
    ref = (yf, *torch.autograd.grad(yf, (xf, gf, bf), dyb.float()))
    bf16 = {kind: {n: _rel(a, b) for n, a, b in zip(
        names, _bn_train_pass(kind == "sync", xb, dyb, gamma, beta), ref)}
        for kind in ("sync", "bntrain")}
    out = {"shape": list(SYNC_BN_SHAPE), "fp32_sync_vs_bntrain": f32,
           "bf16_vs_fp32_formula": bf16,
           "limits": {"fp32": BN_F32_REL, "bf16_y_dx": BN_BF16_OUT_REL,
                      "bf16_dgamma_dbeta": BF16_LOSS_REL}}
    log(f"sync BN against _BNTrain: {json.dumps(out)}")
    bad = [f"fp32 {n} {e:.3e}" for n, e in f32.items() if not e <= BN_F32_REL]
    bad += [f"bf16 {n} {bf16['sync'][n]:.3e}" for n, limit in (
        ("y", BN_BF16_OUT_REL), ("dx", BN_BF16_OUT_REL),
        ("dgamma", BF16_LOSS_REL), ("dbeta", BF16_LOSS_REL))
        if not bf16["sync"][n] <= limit]
    if bad:
        fails.append(f"sync BN against _BNTrain: {', '.join(bad)}")
    return out


def _resnet_leg(card, fails):
    """Leg (c): the s2d stem and sync BN on their own, then ResNet-50
    ImageNet NHWC bf16 b256 through DistriOptimizer at dp=1: A conv stem,
    B + remat, C s2d stem + remat + sync BN."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.parallel import mesh as mesh_lib

    s2d = _s2d_check(fails)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(13)
    x = rng.standard_normal((max(RES_IMAGES, RES_BIG_IMAGES), 224, 224, 3),
                            dtype=np.float32)
    y = (rng.integers(0, 1000, len(x)) + 1).astype(np.float32)
    d256 = (x[:RES_IMAGES], y[:RES_IMAGES])
    d512 = (x[:RES_BIG_IMAGES], y[:RES_BIG_IMAGES])
    d_prof = (x[:2 * RES_BATCH], y[:2 * RES_BATCH])   # profiled: 2 steps
    variants = {"A": dict(), "B": dict(remat=True),
                "C": dict(stem="s2d", remat=True, sync_bn_axis="dp")}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    store = tempfile.mkdtemp(prefix="vgg_", dir=str(_build.BUILD_DIR))
    mesh_lib.init_distributed(f"file://{store}/store", 0, 1)
    mesh = mesh_lib.create_mesh({"dp": 1})
    runs, finals, launches, peaks, profiles = {}, {}, {}, {}, {}
    steps = DISTRI_EPOCHS * RES_IMAGES // RES_BATCH
    try:
        sync_bn = _sync_bn_check(fails)
        torch.cuda.empty_cache()
        w0 = s0 = None
        for name, kw in variants.items():
            model = resnet.build(class_num=1000, depth=50, format="NHWC",
                                 seed=0, **kw)
            if w0 is None:
                w0 = [w.clone() for w in model.get_weights()]
                s0 = [s.clone() for s in model.state_list()]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            runs[name] = _train_run(model, w0, s0, d256, RES_BATCH,
                                    mesh=mesh)
            launches[name] = _build.launch_counts()
            peaks[name] = torch.cuda.max_memory_allocated() / 1e9
            finals[name] = [t.clone() for t in
                            model.get_weights() + model.state_list()]
            log(f"ResNet-50 {name} {kw}: losses {runs[name]['losses']}; "
                f"peak {peaks[name]:.2f} GB; launches {launches[name]}")
            if name == "C":
                profiles[name] = profile_steps(
                    lambda: _train_run(model, w0, s0, d_prof, RES_BATCH,
                                       mesh=mesh),
                    steps=DISTRI_EPOCHS * 2, classes=DISTRI_CLASSES)
            if name == "B":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                runs["B_b512"] = _train_run(model, w0, s0, d512,
                                            RES_BIG_BATCH, mesh=mesh)
                peaks["B_b512"] = torch.cuda.max_memory_allocated() / 1e9
            del model
    finally:
        torch.distributed.destroy_process_group()
        mesh_lib.set_mesh(None)
        shutil.rmtree(store, ignore_errors=True)
    want = {fo.SGD_MOM: steps * -(-len(w0) // fo.SGD_CAPACITY)}
    for name in variants:
        if launches[name] != want:
            fails.append(f"ResNet-50 {name} launches {launches[name]}, "
                         f"expected {want}")
    b_bits = runs["B"]["losses"] == runs["A"]["losses"] and all(
        torch.equal(a, b) for a, b in zip(finals["A"], finals["B"]))
    if not b_bits:
        fails.append(f"ResNet-50 remat is not bitwise the plain run: "
                     f"{runs['B']['losses']} vs {runs['A']['losses']}")
    band = _max_rel(runs["C"]["losses"], runs["A"]["losses"])
    if not (all(np.isfinite(runs["C"]["losses"])) and band <= RES_BAND_REL):
        fails.append(f"ResNet-50 s2d + sync BN outside the bf16 band of A: "
                     f"{band:.3e} > {RES_BAND_REL}")
    if not peaks["B"] < peaks["A"]:
        fails.append(f"remat did not lower the peak: B {peaks['B']:.2f} GB "
                     f"vs A {peaks['A']:.2f} GB")
    for name in ("A", "C"):
        if not runs[name]["losses"][-1] < runs[name]["losses"][0]:
            fails.append(f"ResNet-50 {name} loss did not fall: "
                         f"{runs[name]['losses']}")
    readings = {name: {**_steady(runs[name], RES_BIG_BATCH if name ==
                                 "B_b512" else RES_BATCH),
                       "peak_mem_gb": peaks[name]} for name in runs}
    total = {}
    for name in variants:
        for k, v in launches[name].items():
            total[k] = total.get(k, 0) + v
    return {"config": "resnet.build(class_num=1000, depth=50, format="
                      "'NHWC', seed=0) + A: stem='conv'; B: remat=True; C: "
                      "stem='s2d', remat=True, sync_bn_axis='dp'; "
                      "DistriOptimizer(batch_size=256, mesh=create_mesh("
                      "{'dp': 1}), fused_optim=True), set_mixed_precision(),"
                      " SGD(0.1, momentum=0.9, weight_decay=1e-4), one "
                      "epoch of 4 steps; B again at batch 512, one epoch of "
                      "2; "
                      "NCCL at world size 1",
            "s2d_check": s2d, "sync_bn_check": sync_bn,
            "losses": {k: v["losses"] for k, v in runs.items()},
            "remat_bitwise": b_bits, "s2d_sync_vs_conv_max_rel": band,
            "band": RES_BAND_REL, "launches_by_run": launches,
            "launches": total, "readings": readings, "profiles": profiles}


def phase_vgg(card: str):
    """The rest of the nn shell on the card: (a) VGG-16 CIFAR-10 at the
    reference's benchmark configuration on K5, (b) LeNet-5 as a Graph
    through the Torch shell and on K6, (c) ResNet-50 with Remat and with
    the s2d stem and sync BN on K5."""
    fails = []
    t0 = time.monotonic()
    vgg = _vgg_leg(card, fails)
    log(f"vgg leg (a): {time.monotonic() - t0:.1f} s")
    lenet_graph = _lenet_graph_leg(fails)
    log(f"vgg leg (b): {time.monotonic() - t0:.1f} s")
    resnet_variants = _resnet_leg(card, fails)
    log(f"vgg leg (c): {time.monotonic() - t0:.1f} s")
    launches = {}
    for leg in (vgg, lenet_graph, resnet_variants):
        for k, v in leg["launches"].items():
            launches[k] = launches.get(k, 0) + v
    out = {"vgg16_cifar10": vgg, "lenet_graph": lenet_graph,
           "resnet50_variants": resnet_variants, "launches": launches,
           "seconds": time.monotonic() - t0, "card": card}
    log(f"vgg: {json.dumps(out)}")
    if fails:
        raise AssertionError("vgg phase: " + "; ".join(fails))
    return out


# --------------------------------------------------------------------- #
DECODE_ENGINE = dict(slots=8, page_size=16, max_context=1024, max_prompt=512,
                     max_new_tokens=64)
DECODE_REQUESTS, DECODE_CLIENTS, DECODE_NEW = 16, 3, 64
DECODE_CONTENDED_PAGES = 96      # of the 512 the uncontended pool holds
# the engine's tokens come from the paged cache, the check's logits from
# the contiguous one: the same fp32 ops at other batch and window shapes,
# so the engine's token may trail the contiguous argmax only by their
# float-rounding distance (about 20x the sound reading)
DECODE_TOKEN_TOL = 2e-4
PAGED_LOGIT_TOL = 2e-4           # max |paged - contiguous| logit
BEAM_SCORE_TOL = 3e-4            # beam score against the sequence log-prob
BEAM_AFTER_REQUESTS = 24         # the beam prompts' place in their stream
INT8_DRIFT_MAX = 0.05            # the reference's documented int8 envelope
DECODE_CLASSES = KERNEL_CLASSES[:4] + (
    ("gemm", "matmul (cuBLAS)"), ("cutlass", "matmul (cuBLAS)"),
    ("index", "index / gather / scatter"), ("gather", "index / gather / "
                                            "scatter"),
    ("scatter", "index / gather / scatter"), ("softmax", "softmax"),
    ("reduce", "reductions"), ("memcpy", "copies"), ("copy", "copies"),
    ("elementwise", "elementwise"))


def _decode_clients(eng, prompts):
    """Every prompt through ``eng`` from DECODE_CLIENTS threads, even ones
    through ``stream()`` (whose tokens must be the result's tail), odd ones
    through ``submit()``; returns (outputs, wall seconds)."""
    results = [None] * len(prompts)
    errors = []

    def client(c):
        try:
            for i in range(c, len(prompts), DECODE_CLIENTS):
                if i % 2 == 0:
                    st = eng.stream("lm", prompts[i])
                    toks = list(st.tokens())
                    out = st.result(timeout=600)
                    if toks != out[len(prompts[i]):].tolist():
                        raise AssertionError(f"request {i}: streamed "
                                             f"tokens differ from result")
                else:
                    out = eng.submit("lm", prompts[i]).result(timeout=600)
                results[i] = out
        except Exception as e:   # reported below, fails the phase
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(DECODE_CLIENTS)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"decode clients failed: {errors}")
    for i, (p, out) in enumerate(zip(prompts, results)):
        if out.shape != (len(p) + DECODE_NEW,) \
                or not np.array_equal(out[:len(p)], p):
            raise AssertionError(f"request {i}: output {out.shape} is not "
                                 f"the prompt + {DECODE_NEW} tokens")
    return results, wall


def _check_pool_empty(eng, what):
    eng.kv.check_invariants()
    if eng.kv.pages_in_use():
        raise AssertionError(f"{what}: {eng.kv.pages_in_use()} pages still "
                             f"held after every request finished")


def _paged_logits(model, params, kv, prompts, steps, feed=None):
    """Each prompt prefilled into slot i of ``kv`` (bucketed, as the engine
    does), then ``steps`` decode steps of all of them together through
    ``decode_tokens``.  Returns per prompt the (steps + 1, V) logits; the
    tokens fed are the paged argmax, or ``feed[i]`` (steps,) per prompt."""
    pool = kv.init_pool()
    n = len(prompts)
    rows = [[] for _ in range(n)]
    lengths = np.zeros(kv.n_slots, np.int32)
    last = np.zeros(kv.n_slots, np.int32)
    for i, p in enumerate(prompts):
        L = len(p)
        if not kv.alloc_for(i, L):
            raise AssertionError("paged check: pool too small")
        b = 1 << (L - 1).bit_length()
        toks = np.zeros((1, b), np.int32)
        toks[0, :L] = p
        cache = model.init_cache(1, cache_len=b)
        lg, cache = model.apply_with_cache(
            params, torch.from_numpy(toks).cuda(), cache, 0)
        table = np.full(-(-b // kv.page_size), -1, np.int32)
        m = min(table.size, kv.max_pages_per_slot)
        table[:m] = kv.tables[i, :m]
        for name in kv.layer_names:
            kv.write_prefill(pool[name], torch.from_numpy(table).cuda(),
                             cache[name]["k"], cache[name]["v"])
        rows[i].append(lg[0, L - 1])
        lengths[i] = L
        last[i] = int(lg[0, L - 1].argmax())
    for j in range(steps):
        if feed is not None:
            last[:n] = [f[j] for f in feed]
        for i in range(n):
            kv.alloc_for(i, int(lengths[i]) + 1)
        tb = torch.from_numpy(kv.tables.copy()).cuda()
        ln = torch.from_numpy(lengths.copy()).cuda()

        def kv_io(name, k, v):
            kv.write_token(pool[name], tb, ln, k, v)
            return kv.gather_window(pool[name], tb)

        lg = model.decode_tokens(params, torch.from_numpy(last).cuda(), ln,
                                 kv_io)
        for i in range(n):
            rows[i].append(lg[i])
        last[:n] = lg[:n].argmax(-1).cpu().numpy()
        lengths[:n] += 1
    return [torch.stack(r) for r in rows]


def _contiguous_logits(model, params, prompt, fed, cache_len):
    """The contiguous path (``init_cache`` + ``apply_with_cache``): the
    prompt, then the tokens ``fed`` one at a time; (len(fed) + 1, V)."""
    L = len(prompt)
    cache = model.init_cache(1, cache_len=cache_len)
    lg, cache = model.apply_with_cache(
        params, torch.from_numpy(prompt[None]).cuda(), cache, 0)
    rows = [lg[0, -1]]
    fed_d = torch.from_numpy(np.asarray(fed, np.int32)).cuda()
    for j in range(len(fed)):
        lg, cache = model.apply_with_cache(params, fed_d[j:j + 1][None],
                                           cache, L + j)
        rows.append(lg[0, 0])
    return torch.stack(rows)


def _teacher_forced_logits(model, params, prompt, fed, cache_len):
    """The contiguous path (``init_cache`` + ``apply_with_cache``) over the
    prompt and the tokens ``fed`` in one call, each position attending to
    the ones before it; the logits at the prompt's last position and
    after each fed token, (len(fed) + 1, V)."""
    seq = np.concatenate([prompt, np.asarray(fed, np.int32)])
    cache = model.init_cache(1, cache_len=cache_len)
    lg, _ = model.apply_with_cache(
        params, torch.from_numpy(seq[None]).cuda(), cache, 0)
    return lg[0, len(prompt) - 1:]


def _beam_prompts(vocab: int) -> np.ndarray:
    """The 2 × 64 beam prompts, fixed whatever ``DECODE_REQUESTS`` is:
    the draw of ``RandomState(9)`` that follows 24 requests' lengths and
    tokens, one decode step's tokens and one prompt per prefill bucket,
    the prompts the beam-over-greedy check was first held on.  Beam
    search does not guarantee that check (ROADMAP C10), so its data
    stays put while the requests before it change."""
    from bigdl_tpu_torch.serving import BucketLadder
    rs = np.random.RandomState(9)
    lens = rs.randint(16, DECODE_ENGINE["max_prompt"] + 1,
                      BEAM_AFTER_REQUESTS)
    for n in lens:
        rs.randint(0, vocab, int(n))
    rs.randint(0, vocab, DECODE_ENGINE["slots"])
    for b in BucketLadder(DECODE_ENGINE["max_prompt"]):
        rs.randint(0, vocab, (1, b))
    return rs.randint(0, vocab, (2, 64)).astype(np.int32)


def phase_decode(card: str):
    """Token streaming on base: DecodeEngine over the paged cache, checked
    against the contiguous cache, under contention, with beam search and
    int8 KV; the readings of the uncontended run."""
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.serving import (DecodeEngine, ModelRegistry,
                                         PagedKVCache)

    t0 = time.monotonic()
    model = T.build("base", device="cuda", seed=0)
    cfg = model.cfg
    params = model.param_dict()
    rs = np.random.RandomState(9)
    lens = rs.randint(16, DECODE_ENGINE["max_prompt"] + 1, DECODE_REQUESTS)
    prompts = [rs.randint(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]

    def engine(**kw):
        reg = ModelRegistry()
        reg.register("lm", model)
        return DecodeEngine(reg, "lm", **{**DECODE_ENGINE, **kw})

    torch.cuda.reset_peak_memory_stats()
    eng = engine()
    t_w = time.monotonic()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t_w
    # the main path: every kernel count from 0 just before, read just after
    _build.reset_launch_counts()
    outs, wall = _decode_clients(eng, prompts)
    launches = _build.launch_counts()
    st = eng.stats()
    eng.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if st["recompiles"] != 0 or st["errors"] != 0 \
            or st["warmup_compiles"] != len(eng.ladder) + 1:
        raise AssertionError(f"decode stats: {st}")
    if any(launches.values()):
        raise AssertionError(f"the decode path launched hand kernels: "
                             f"{launches}")
    _check_pool_empty(eng, "uncontended run")
    n_tokens = DECODE_REQUESTS * DECODE_NEW
    log(f"decode: {n_tokens} tokens in {wall:.2f} s, warmup {warm_s:.1f} s, "
        f"{st}")

    # the readings: the decode step with every slot live, each prefill
    # bucket, and the device's view of a few steady steps
    snap = eng.registry.get("lm").snapshot
    kv = eng.kv
    mid = DECODE_ENGINE["max_prompt"] + DECODE_NEW // 2
    with eng._on_device():
        prog = eng._program("decode")
        for s in range(eng.slots):
            kv.alloc_for(s, mid + 1)
        toks = rs.randint(0, cfg.vocab_size, eng.slots).astype(np.int32)
        lengths = np.full(eng.slots, mid, np.int32)
        greedy = np.zeros(eng.slots, np.float32)

        def step(i=0):
            return prog(snap.params, eng._pool, toks, lengths, kv.tables,
                        greedy, i)

        step_ms = []
        for i in range(23):
            t1 = time.perf_counter()
            step(i)
            step_ms.append((time.perf_counter() - t1) * 1e3)
        step_ms = step_ms[3:]
        prof = profile_steps(lambda: [step(i) for i in range(2)], steps=2,
                             classes=DECODE_CLASSES, top=8)
        for s in range(eng.slots):
            kv.free_slot(s)
        prefill_ms = {}
        table_of = {b: np.full(-(-b // kv.page_size), -1, np.int32)
                    for b in eng.ladder}
        for b in eng.ladder:
            pre = eng._program("prefill", b)
            x = rs.randint(0, cfg.vocab_size, (1, b)).astype(np.int32)
            times = []
            for _ in range(4):
                t1 = time.perf_counter()
                pre(snap.params, eng._pool, x, b, table_of[b], 0.0, 0)
                times.append((time.perf_counter() - t1) * 1e3)
            prefill_ms[b] = float(np.median(times[1:]))
    log(f"decode step {np.median(step_ms):.3f} ms (median of 20, 8 live "
        f"slots at length {mid}); prefill ms by bucket {prefill_ms}")

    # fidelity: every request through the contiguous cache, teacher-forced
    # on the engine's own tokens
    worst_gap, exact, positions = 0.0, 0, 0
    t_f = time.monotonic()
    with torch.inference_mode():
        for i, (p, out) in enumerate(zip(prompts, outs)):
            gen = out[len(p):]
            rows = _teacher_forced_logits(model, params, p, gen[:-1],
                                          len(p) + DECODE_NEW)
            got = torch.from_numpy(gen).cuda().long()
            gap = rows.max(-1).values - rows.gather(1, got[:, None])[:, 0]
            worst_gap = max(worst_gap, gap.max().item())
            exact += int((rows.argmax(-1) == got).sum())
            positions += len(gen)
    log(f"decode vs contiguous: worst logit gap {worst_gap:.3e}, argmax "
        f"equal at {exact}/{positions} positions "
        f"({time.monotonic() - t_f:.1f} s)")
    if not worst_gap <= DECODE_TOKEN_TOL:
        raise AssertionError(f"an engine token trails the contiguous "
                             f"argmax by {worst_gap:.3e} > "
                             f"{DECODE_TOKEN_TOL}")

    # paged decode_tokens against contiguous logits, two prompts, 16 steps
    names = [b.attn.name for b in model.blocks]
    geo = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim, n_pages=160,
               page_size=DECODE_ENGINE["page_size"],
               n_slots=DECODE_ENGINE["slots"],
               max_context=DECODE_ENGINE["max_context"], device="cuda")
    pair = [prompts[0], prompts[1]]
    with torch.inference_mode():
        paged = _paged_logits(model, params, PagedKVCache(names, **geo),
                              pair, 16)
        paged_err, bitwise = 0.0, True
        for p, rows in zip(pair, paged):
            fed = rows[:-1].argmax(-1).cpu().numpy()
            want = _contiguous_logits(model, params, p, fed,
                                      DECODE_ENGINE["max_context"])
            paged_err = max(paged_err, (rows - want).abs().max().item())
            bitwise = bitwise and torch.equal(rows, want)
    log(f"paged vs contiguous logits: max |err| {paged_err:.3e} (limit "
        f"{PAGED_LOGIT_TOL}), bitwise {bitwise}")
    if not paged_err <= PAGED_LOGIT_TOL:
        raise AssertionError("paged decode_tokens disagrees with the "
                             "contiguous cache")

    # contended: a fifth of the pool and all 16 requests at once, so that
    # prompts fill the pool and growth must evict; the same tokens, bitwise
    eng_c = engine(pool_pages=DECODE_CONTENDED_PAGES).warmup()
    t_c = time.monotonic()
    futs = [eng_c.submit("lm", p) for p in prompts]
    outs_c = [f.result(timeout=900) for f in futs]
    wall_c = time.monotonic() - t_c
    st_c = eng_c.stats()
    eng_c.shutdown()
    ev = eng_c.recorder.counter_value("kv/evictions")
    re_ = eng_c.recorder.counter_value("decode/readmissions")
    _check_pool_empty(eng_c, "contended run")
    if not (ev > 0 and re_ > 0):
        raise AssertionError(f"contended run: evictions {ev}, readmissions "
                             f"{re_}; the pool must be made to evict")
    same = [np.array_equal(a, b) for a, b in zip(outs, outs_c)]
    if not all(same):
        raise AssertionError(f"contended tokens differ from uncontended for "
                             f"requests {[i for i, ok in enumerate(same) if not ok]}")
    log(f"contended ({DECODE_CONTENDED_PAGES} pages): {ev:.0f} evictions, "
        f"{re_:.0f} readmissions, "
        f"{eng_c.recorder.counter_value('decode/replayed_tokens'):.0f} "
        f"replayed tokens, {wall_c:.2f} s, every token bitwise")

    # beam search: 2 prompts of 64, beam 4, 32 new tokens
    bp = _beam_prompts(cfg.vocab_size)
    seq, scores = model.generate_beam(params, bp, 32, beam_size=4)
    greedy_seq = model.generate(params, bp, 32)
    with torch.inference_mode():
        def seq_logprob(tokens):
            cache = model.init_cache(2, cache_len=tokens.shape[1])
            lg, _ = model.apply_with_cache(params, tokens, cache, 0)
            logp = torch.log_softmax(lg[:, :-1], -1)
            per = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
            return per[:, -32:].sum(1)
        lp_beam, lp_greedy = seq_logprob(seq), seq_logprob(greedy_seq)
    beam_err = (scores - lp_beam).abs().max().item()
    if seq.shape != (2, 96) or not torch.isfinite(scores).all() \
            or beam_err > BEAM_SCORE_TOL \
            or not bool((lp_beam >= lp_greedy - BEAM_SCORE_TOL).all()):
        raise AssertionError(f"beam: shape {tuple(seq.shape)}, scores "
                             f"{scores.tolist()}, against the sequence "
                             f"log-prob {lp_beam.tolist()} (greedy "
                             f"{lp_greedy.tolist()})")

    # int8 KV: an engine run, and the logit drift of the paged path
    eng8 = engine(int8_kv=True).warmup()
    outs8, _ = _decode_clients(eng8, prompts[:8])
    eng8.shutdown()
    _check_pool_empty(eng8, "int8 run")
    agree8 = float(np.mean([np.mean(a[len(p):] == b[len(p):]) for p, a, b
                            in zip(prompts, outs, outs8)]))
    with torch.inference_mode():
        fp = _paged_logits(model, params, PagedKVCache(names, **geo),
                           pair[:1], 16)[0]
        fed = [fp[:-1].argmax(-1).cpu().numpy()]
        q8 = _paged_logits(model, params,
                           PagedKVCache(names, int8=True, **geo), pair[:1],
                           16, feed=fed)[0]
    drift = ((fp - q8).abs().max() / fp.abs().max()).item()
    log(f"int8 KV: relative logit drift {drift:.4f} (limit "
        f"{INT8_DRIFT_MAX}); engine tokens equal to fp32 KV's at "
        f"{agree8:.3f} of positions")
    if not 0.0 < drift < INT8_DRIFT_MAX:
        raise AssertionError(f"int8 KV drift {drift} outside (0, "
                             f"{INT8_DRIFT_MAX})")

    out = {"model": "base", "engine": DECODE_ENGINE,
           "requests": DECODE_REQUESTS, "clients": DECODE_CLIENTS,
           "prompt_lens": [int(n) for n in lens], "new_tokens": DECODE_NEW,
           "warmup_s": warm_s, "wall_s": wall,
           "tokens_per_s": n_tokens / wall,
           "ttft_p50_ms": st.get("ttft_p50_ms"),
           "ttft_p99_ms": st.get("ttft_p99_ms"),
           "intertoken_p50_ms": st.get("intertoken_p50_ms"),
           "intertoken_p99_ms": st.get("intertoken_p99_ms"),
           "steps": st["steps"], "occupancy": st["occupancy"],
           "step_span_mean_ms": eng.recorder.span_value("decode.step")
           / max(st["steps"], 1) * 1e3,
           "step_ms_median_8_live": float(np.median(step_ms)),
           "step_ms_8_live": step_ms, "prefill_ms_by_bucket": prefill_ms,
           "recompiles": int(st["recompiles"]),
           "warmup_compiles": int(st["warmup_compiles"]),
           "peak_mem_gb": peak_gb, "profile": prof, "launches": launches,
           "fidelity": {"worst_logit_gap": worst_gap, "limit":
                        DECODE_TOKEN_TOL, "argmax_equal": exact,
                        "positions": positions},
           "paged_vs_contiguous": {"max_abs_err": paged_err,
                                   "limit": PAGED_LOGIT_TOL,
                                   "bitwise": bitwise},
           "contended": {"pool_pages": DECODE_CONTENDED_PAGES,
                         "evictions": ev, "readmissions": re_,
                         "replayed_tokens": eng_c.recorder.counter_value(
                             "decode/replayed_tokens"),
                         "wall_s": wall_c, "tokens_per_s": n_tokens / wall_c,
                         "ttft_p99_ms": st_c.get("ttft_p99_ms"),
                         "bitwise_equal": True},
           "beam": {"scores": scores.tolist(), "max_abs_err_vs_logprob":
                    beam_err, "beam_minus_greedy_logprob":
                    (lp_beam - lp_greedy).tolist()},
           "int8": {"relative_drift": drift, "limit": INT8_DRIFT_MAX,
                    "token_agreement_vs_fp32": agree8},
           "card": card}
    log(f"decode: {json.dumps(out)}")
    return out


# --------------------------------------------------------------------- #
STREAM_STEPS, STREAM_EVERY = 12, 4       # least trainer steps; a publish every 4
STREAM_MAX_STEPS = 400                   # the trainer's steps at most
STREAM_RATE, STREAM_SECONDS = 4.0, 4.0   # open-loop steady trace, req/s, s
STREAM_SEED = 12
STREAM_GOLDEN_LEN = 64                   # the canary's golden prompt
STREAM_SET = dict(wedge_after=2.0, probe_deadline_ms=60000.0)
STREAM_QUIESCE_S = 60.0                  # a canary's live slots drain first
STREAM_PROFILED_STEP = 6                 # profiled with the decode replicas
# the float canary's drift bound, relative to the golden logits' maximum:
# the trainer's last publication (130-170 steps of AdamW(3e-4) on an H100)
# moves base's golden logits by ~1.2-1.3x their maximum, so the
# reference's default (0.5) must reject it and a bound of 2.0 must pass
# it.  At 2.0 the gate catches only a non-finite or exploded update: the
# leg's correctness check is the set's logits against base with the plain
# attention (MODEL_TOL)
STREAM_DRIFT_RTOL = 2.0
CHAOS_DELAY_MS, CHAOS_REQUESTS = 6000, 8
REPLICA_GOLDEN_ROWS, REPLICA_REQUESTS = 2, 6


def _wait_for(cond, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout:.0f} s waiting "
                                 f"for {what}")
        time.sleep(0.05)


def _replay_open_loop(rset, prompts, arrivals_s, ctxs, results, errors):
    """Replay ``arrivals_s`` (virtual seconds) against the wall clock into
    ``rset.submit``: each request's future, or its shed, lands in
    ``results[i]`` as ("ok", future, [monotonic time it resolved]) /
    ("shed", reason); anything else is a client error."""
    from bigdl_tpu_torch.serving import LoadShedError
    t0 = time.monotonic()
    for i, (t, p) in enumerate(zip(arrivals_s, prompts)):
        delay = t0 + t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            fut, done_at = rset.submit("lm", p, trace_ctx=ctxs[i]), []
            fut.add_done_callback(
                lambda _, d=done_at: d.append(time.monotonic()))
            results[i] = ("ok", fut, done_at)
        except LoadShedError as e:
            results[i] = ("shed", e.reason)
        except Exception as e:       # reported by the caller, fails the phase
            errors.append(f"request {i}: {e!r}")


def _ring_latencies(engines, trace_ids):
    """TTFT and inter-token ms of the requests whose trace id is in
    ``trace_ids``, from the engines' request traces (admit → first token;
    one ``token`` span per step after it)."""
    ttft, inter = [], []
    for eng in engines:
        for tr in eng.trace_ring.traces():
            if tr.trace_id not in trace_ids:
                continue
            admit = [t0 for name, t0, _, _ in tr.spans if name == "admit"]
            toks = [(t0, t1) for name, t0, t1, _ in tr.spans
                    if name == "token"]
            if admit and toks:
                ttft.append((toks[0][0] - admit[0]) * 1e3)
                inter.extend((t1 - t0) * 1e3 for t0, t1 in toks[1:])
    return ttft, inter


def _profiler_warm():
    """The profiler's first use in a process sets up CUPTI, which holds
    every thread's launches for seconds: pay that before replicas serve,
    or their wedge watchdog reads the pause as a wedged replica."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _pct(xs, q):
    return float(np.percentile(xs, q)) if xs else None


def phase_stream(card: str, train_alone_ms: float):
    """Train→serve on one card: SpmdTrainer trains base with K1–K4 while a
    WeightStreamPublisher ships owning snapshots through a CanaryPublisher
    into a 2-replica decode ReplicaSet of base that answers open-loop
    traffic; then a poisoned publish, a wedged replica, and a ServingEngine
    replica set whose float canary runs the drift gate."""
    from bigdl_tpu_torch import faults
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.observability import TraceContext
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops.flash_attention import flash_forward_plain
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer
    from bigdl_tpu_torch.serving import (CanaryPublisher, CanaryRejectedError,
                                         DecodeEngine, ModelRegistry,
                                         WeightStreamPublisher, arrivals,
                                         build_decode_replica_set,
                                         build_replica_set)
    from bigdl_tpu_torch.serving.registry import owning_copy

    _profiler_warm()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = T.build("base", device="cuda", seed=0)
    cfg = model.cfg
    n_leaves = sum(len(sub) for sub in model.param_dict().values())
    w0 = owning_copy(model.param_dict())     # the pre-training weights
    rs = np.random.RandomState(STREAM_SEED)
    golden = rs.randint(0, cfg.vocab_size, STREAM_GOLDEN_LEN).astype(np.int32)
    rset = build_decode_replica_set(model, 2, name="lm", probe_prompt=golden,
                                    engine_kw=DECODE_ENGINE, **STREAM_SET)
    rset.warmup()
    engines = [r.engine for r in rset.replicas]
    pre = [e.predict("lm", golden, timeout=600) for e in engines]
    pub = CanaryPublisher(rset, {"lm": golden},
                          quiesce_timeout=STREAM_QUIESCE_S,
                          validate_timeout=600.0)
    wsp = WeightStreamPublisher(pub, "lm", every_steps=STREAM_EVERY)
    trainer = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR, fused=True))
    trainer.set_weight_stream(wsp)
    ids = np.random.RandomState(STREAM_SEED + 1).randint(
        0, cfg.vocab_size, (STREAM_MAX_STEPS, TRAIN_BATCH, SEQ + 1)
    ).astype(np.int32)

    # open-loop traffic: a steady trace in virtual time, replayed against
    # the wall clock; prompts of 16-512 tokens, 64 new tokens each
    arr = list(arrivals.virtual_arrivals(
        np.random.RandomState(STREAM_SEED), STREAM_RATE,
        arrivals.TRACES["steady"], STREAM_SECONDS))
    lens = rs.randint(16, DECODE_ENGINE["max_prompt"] + 1, len(arr))
    prompts = [rs.randint(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in lens]
    ctxs = [TraceContext.new_root() for _ in arr]
    results, errors = [None] * len(arr), []
    client = threading.Thread(target=_replay_open_loop,
                              args=(rset, prompts, arr, ctxs, results, errors))
    rec0 = engines[0].recorder
    # exactly-once by the set's own accounting: every completion it makes
    # (True: delivered; False: refused, a late result) and every
    # dispatch's resolution, counted where the set makes them
    delivered, refused, resolved = {}, [0], [0]
    set_complete, set_inner_done = rset._complete, rset._on_inner_done

    def counted_complete(flight, result=None, exc=None):
        ok = set_complete(flight, result=result, exc=exc)
        if ok:
            key = id(flight.future)
            delivered[key] = delivered.get(key, 0) + 1
        else:
            refused[0] += 1
        return ok

    def counted_inner_done(*a):
        resolved[0] += 1
        return set_inner_done(*a)
    rset._complete, rset._on_inner_done = counted_complete, counted_inner_done

    def exactly_once(futs, what, since):
        """Each of ``futs`` delivered once by the set, nothing else
        delivered, every dispatch since ``since`` resolved once, and no
        refusal the set did not count as a stale result."""
        st = rset.stats()
        disp = st["dispatches"] - since["dispatches"]
        stale = st["stale_results"] - since["stale_results"]
        per = [delivered.get(id(f), 0) for f in futs]
        n_del = sum(delivered.values()) - since["delivered"]
        if any(c != 1 for c in per) or n_del != len(futs) \
                or resolved[0] - since["resolved"] != disp \
                or refused[0] - since["refused"] > stale:
            raise AssertionError(
                f"{what}: deliveries per request {per}, {n_del} delivered "
                f"for {len(futs)} requests, {resolved[0] - since['resolved']}"
                f" of {disp} dispatches resolved, "
                f"{refused[0] - since['refused']} refused, {stale} stale")

    def accounts():
        st = rset.stats()
        return {"dispatches": st["dispatches"],
                "stale_results": st["stale_results"],
                "delivered": sum(delivered.values()),
                "resolved": resolved[0], "refused": refused[0]}

    def traffic_done():
        return not client.is_alive() and all(
            r is None or r[0] != "ok" or r[1].done() for r in results)

    def train_step(k):
        trainer.fit([(ids[k - 1, :, :-1], ids[k - 1, :, 1:])])   # syncs

    def profiled_step(k):
        # one training step and at least 4 decode steps of replica 0, all
        # on the card at once: the device's busy share while it trains and
        # serves (every kernel of every thread counted)
        start = rec0.counter_value("decode/steps")
        train_step(k)
        _wait_for(lambda: rec0.counter_value("decode/steps") >= start + 4,
                  600, "4 decode steps")

    # the main path: every kernel count from 0 just before, read just after
    acc0 = accounts()
    _build.reset_launch_counts()
    t_run = time.monotonic()
    client.start()
    step_ms, untouched, prof, serving_ms = [], None, None, []
    rec = wsp.recorder
    k = 0
    # the trainer's own cadence: a firing while a publish is in flight is
    # skipped (stream/skipped_busy); train on until 2 publishes fired and
    # the traffic is answered, so all of it meets a training card; the
    # last publish lands after (wsp.wait below)
    while k < STREAM_MAX_STEPS and not (
            k >= STREAM_STEPS and traffic_done()
            and rec.counter_value("stream/snapshots") >= 2):
        k += 1
        if k == STREAM_PROFILED_STEP:
            prof = profile_steps(lambda: profiled_step(k), steps=1,
                                 classes=DECODE_CLASSES, top=8)
            continue
        live = not traffic_done()
        t_s = time.monotonic()
        train_step(k)
        step_ms.append((time.monotonic() - t_s) * 1e3)
        if live:
            serving_ms.append(step_ms[-1])
        if k == STREAM_EVERY - 1:
            # K4 has written base's parameters in place 3 times: the
            # registered snapshots must not have moved
            untouched = [e.predict("lm", golden, timeout=600)
                         for e in engines]
    n_steps = k
    train_s = time.monotonic() - t_run
    wsp.wait(600)
    client.join(STREAM_SECONDS + 600)
    log(f"stream: {n_steps} trainer steps "
        f"{[round(x, 1) for x in step_ms]} ms; set "
        f"{ {k: v for k, v in rset.stats().items() if k != 'replicas'} }")
    futures = [r[1] for r in results if r is not None and r[0] == "ok"]
    outs = []
    for i, f in enumerate(futures):
        try:
            outs.append(f.result(timeout=900))
        except Exception as e:
            errors.append(f"future {i}: {e!r}")
    # the traffic's span: the replay's start to its last answer (the
    # trainer may run on after it, until its second publish lands); a
    # future's callbacks run just after its result is visible
    _wait_for(lambda: all(r[2] for r in results
                          if r is not None and r[0] == "ok"), 60,
              "the requests' completion times")
    wall = max(r[2][0] for r in results
               if r is not None and r[0] == "ok") - t_run
    launches = _build.launch_counts()
    sheds = {}
    for r in results:
        if r is not None and r[0] == "shed":
            sheds[r[1]] = sheds.get(r[1], 0) + 1
    st_set = rset.stats()
    log(f"stream: {len(arr)} requests over {wall:.2f} s, trainer "
        f"{train_s:.2f} s; sheds {sheds}; stream counters "
        f"{ {k: rec.counter_value(k) for k in ('stream/snapshots', 'stream/published', 'stream/rejected', 'stream/skipped_busy', 'stream/errors')} }")

    # 1. before the first publish: bitwise the pre-training decode
    for i, (a, b) in enumerate(zip(pre, untouched)):
        if not np.array_equal(a, b):
            raise AssertionError(f"replica {i}: the golden decode changed "
                                 f"while training, before any publish: the "
                                 f"trainer wrote into a registered snapshot")
    # 2. publications
    published = rec.counter_value("stream/published")
    if published < 2 or rec.counter_value("stream/errors") \
            or rec.counter_value("stream/rejected"):
        raise AssertionError(f"stream: {published} published, "
                             f"{rec.counter_value('stream/rejected')} "
                             f"rejected, {rec.counter_value('stream/errors')} "
                             f"errors")
    # 3. bitwise an independent engine loaded with the last publication
    version, last = wsp.last_published
    reg_i = ModelRegistry()
    reg_i.register("lm", model)
    reg_i.swap_weights("lm", last, version=version)
    eng_i = DecodeEngine(reg_i, "lm", **DECODE_ENGINE).warmup()
    want = eng_i.predict("lm", golden, timeout=600)
    eng_i.shutdown()
    del eng_i, reg_i
    after = [e.predict("lm", golden, timeout=600) for e in engines]
    for i, (e, a) in enumerate(zip(engines, after)):
        got_v = e.registry.get("lm").snapshot.version
        if got_v != version or not np.array_equal(a, want):
            raise AssertionError(f"replica {i} serves {got_v}; its golden "
                                 f"decode is not the decode of {version} "
                                 f"by an independent engine")
    # 5. every request once, or shed with its reason; no client error
    if errors or any(r is None for r in results):
        raise AssertionError(f"stream clients: {errors}")
    exactly_once(futures, "stream traffic", acc0)
    for i, out in enumerate(outs):
        if out.shape[0] - DECODE_NEW < 16 or out.dtype != np.int32:
            raise AssertionError(f"request {i}: output {out.shape}")
    # 6. no recompiles; 7. K1-K4 on this path, none from decode
    for i, e in enumerate(engines):
        s = e.stats()
        if s["recompiles"] or s["errors"]:
            raise AssertionError(f"replica {i}: {s}")
    want_l = {"flash_fwd": cfg.n_layers * n_steps,
              "flash_bwd_dkv": cfg.n_layers * n_steps,
              "flash_bwd_dq": cfg.n_layers * n_steps,
              "fused_adam": -(-n_leaves // fo.ADAM_CAPACITY) * n_steps}
    got_l = {name: launches.get(name, 0) for name in want_l}
    log(f"stream launches {launches}, the trainer's alone {want_l}")
    if got_l != want_l or set(launches) - set(want_l):
        raise AssertionError(f"stream launches {launches}: K1-K4 must be the "
                             f"trainer's exactly ({want_l}); the decode "
                             f"replicas launch no hand kernel")
    _build.reset_launch_counts()
    ids_set = {c.trace_id for c in ctxs}
    ttft, inter = _ring_latencies(engines, ids_set)
    n_tokens = len(outs) * DECODE_NEW

    # 4. a NaN-poisoned publish: rejected, rolled back bitwise
    poisoned = {m: {k: torch.full_like(t, float("nan")) for k, t in sub.items()}
                for m, sub in last.items()}
    try:
        pub.publish("lm", poisoned)
        raise AssertionError("a NaN-poisoned publish was promoted")
    except CanaryRejectedError as e:
        reason = e.reason
    del poisoned
    rolled = [e.predict("lm", golden, timeout=600) for e in engines]
    if rset.recorder.counter_value("serving/canary_rejected") != 1 \
            or not all(np.array_equal(a, b) for a, b in zip(after, rolled)):
        raise AssertionError("poisoned publish: not rejected once, or the "
                             "golden decode after rollback is not bitwise")
    log(f"poisoned publish rejected ({reason}); rollback bitwise")

    # chaos: wedge one replica's decode step; the set ejects it, fails its
    # requests over, drops its late results and probes it back in
    chaos = rs.randint(0, cfg.vocab_size, (CHAOS_REQUESTS, 64)).astype(
        np.int32)
    base_counts = {k: rset.recorder.counter_value(k) for k in (
        "replica/wedged", "replica/ejected", "replica/failovers",
        "replica/stale_results", "replica/readmitted")}
    acc1 = accounts()
    faults.arm(f"serving.decode_step:delay:{CHAOS_DELAY_MS}@0")
    try:
        futs = [rset.submit("lm", p) for p in chaos]
        chaos_outs = [f.result(timeout=600) for f in futs]
        recr = rset.recorder
        _wait_for(lambda: recr.counter_value("replica/stale_results")
                  > base_counts["replica/stale_results"], 600,
                  "the wedged replica's late results")
        _wait_for(lambda: recr.counter_value("replica/readmitted")
                  > base_counts["replica/readmitted"], 600,
                  "the probe's readmission")
        fired = faults.injected_total("serving.decode_step")
        # the wedged replica's dispatches resolve late: wait until every
        # dispatch has, then hold the set's accounting
        _wait_for(lambda: resolved[0] - acc1["resolved"]
                  >= rset.stats()["dispatches"] - acc1["dispatches"], 600,
                  "every chaos dispatch to resolve")
        exactly_once(futs, "chaos", acc1)
    finally:
        faults.reset()
    delta = {k: rset.recorder.counter_value(k) - v
             for k, v in base_counts.items()}
    log(f"chaos: {delta}")
    if fired != 1 \
            or not (delta["replica/wedged"] >= 1
                    or delta["replica/ejected"] >= 1) \
            or delta["replica/failovers"] < 1 \
            or delta["replica/stale_results"] < 1 \
            or delta["replica/readmitted"] < 1:
        raise AssertionError(f"chaos leg counts {delta}")
    for p, out in zip(chaos, chaos_outs):
        if out.shape != (64 + DECODE_NEW,) or not np.array_equal(out[:64], p):
            raise AssertionError("a failed-over request's output is wrong")
    if any(_build.launch_counts().values()):
        raise AssertionError(f"the decode set launched hand kernels: "
                             f"{_build.launch_counts()}")
    st_after = {i: e.stats() for i, e in enumerate(engines)}
    rset.shutdown()
    del rset, engines, pub

    # a ServingEngine replica set (K1) from the pre-training weights; the
    # trainer's last snapshot published through a float canary (drift gate)
    model.load_param_dict(w0)
    del w0
    sset = build_replica_set(model, 2, name="lm", input_shape=(SEQ,),
                             dtype=np.int32, engine_kw=dict(max_batch=8))
    sset.warmup()
    gold_s = rs.randint(0, cfg.vocab_size, (REPLICA_GOLDEN_ROWS, SEQ)).astype(
        np.int32)
    _build.reset_launch_counts()
    gold_v1 = sset.replicas[0].engine.predict("lm", gold_s, timeout=600)
    strict = CanaryPublisher(sset, {"lm": gold_s}, quiesce_timeout=600.0,
                             validate_timeout=600.0)
    try:
        strict.publish("lm", last, version=version)
        raise AssertionError("the default drift bound passed the "
                             "trainer's last publication")
    except CanaryRejectedError as e:
        strict_reason = e.reason
    if strict_reason != "drift" or not np.array_equal(
            sset.replicas[0].engine.predict("lm", gold_s, timeout=600),
            gold_v1):
        raise AssertionError(f"float canary: rejected ({strict_reason}) "
                             f"without a bitwise rollback")
    spub = CanaryPublisher(sset, {"lm": gold_s}, quiesce_timeout=600.0,
                           validate_timeout=600.0,
                           drift_rtol=STREAM_DRIFT_RTOL)
    snap = spub.publish("lm", last, version=version)
    gold_v2 = sset.replicas[1].engine.predict("lm", gold_s, timeout=600)
    drift = float(np.max(np.abs(gold_v2 - gold_v1)))
    drift_bound = spub.drift_atol + spub.drift_rtol * float(
        np.max(np.abs(gold_v1)))
    log(f"float canary: golden drift {drift:.4g} within bound "
        f"{drift_bound:.4g}; promoted {snap.version}")
    xs = [rs.randint(0, cfg.vocab_size, (int(n), SEQ)).astype(np.int32)
          for n in rs.randint(1, 4, REPLICA_REQUESTS)]
    ys = [f.result(timeout=600) for f in
          [sset.submit("lm", x) for x in xs]]
    k1_serving = _build.launch_counts()
    batches = sum(r.engine.stats()["batches"] for r in sset.replicas)
    warm = sum(r.engine.stats()["warmup_compiles"] for r in sset.replicas)
    recompiles = sum(r.engine.stats()["recompiles"] for r in sset.replicas)
    sset.shutdown()
    for blk in model.blocks:
        blk.attn.attention_fn = lambda q, k, v: flash_forward_plain(
            q, k, v, causal=True)[0]
    worst = 0.0
    with torch.inference_mode():
        for x, y in zip(xs, ys):
            w, _ = model.run(last, torch.from_numpy(x).cuda())
            got = torch.from_numpy(y).cuda()
            worst = max(worst, (got - w).abs().max().item())
            if not torch.allclose(got, w, **MODEL_TOL):
                raise AssertionError(f"replica-set logits differ from base "
                                     f"with the plain attention by {worst}")
    for blk in model.blocks:
        blk.attn.attention_fn = None
    if snap.version != version or recompiles \
            or k1_serving != {"flash_fwd": cfg.n_layers * batches}:
        raise AssertionError(f"replica serving: version {snap.version}, "
                             f"recompiles {recompiles}, launches "
                             f"{k1_serving} for {batches} batches")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model, sset, spub, trainer, wsp

    spans = {k: rec.span_value(k) for k in ("stream.snapshot",
                                            "stream.publish")}
    n_snap = rec.counter_value("stream/snapshots")
    out = {"model": "base", "replicas": 2, "engine": DECODE_ENGINE,
           "trainer": {"steps": n_steps, "batch": TRAIN_BATCH,
                       "seq": SEQ, "optimizer": "AdamW(3e-4, fused=True)",
                       "step_ms": step_ms,
                       "step_ms_median": float(np.median(step_ms)),
                       "step_ms_median_serving": float(np.median(serving_ms)),
                       "steps_serving": len(serving_ms),
                       "step_ms_median_alone": train_alone_ms,
                       "wall_s": train_s},
           "traffic": {"trace": "steady", "rate_per_s": STREAM_RATE,
                       "seconds": STREAM_SECONDS, "requests": len(arr),
                       "completed": len(outs), "shed": sheds,
                       "prompt_lens": [int(n) for n in lens],
                       "new_tokens": DECODE_NEW, "wall_s": wall,
                       "tokens_per_s": n_tokens / wall,
                       "ttft_p50_ms": _pct(ttft, 50),
                       "ttft_p99_ms": _pct(ttft, 99),
                       "intertoken_p50_ms": _pct(inter, 50),
                       "intertoken_p99_ms": _pct(inter, 99)},
           "stream": {"every_steps": STREAM_EVERY,
                      **{k.split("/")[1]: rec.counter_value(k) for k in (
                          "stream/snapshots", "stream/published",
                          "stream/rejected", "stream/skipped_busy",
                          "stream/errors")},
                      "snapshot_ms_mean": spans["stream.snapshot"]
                      / max(n_snap, 1) * 1e3,
                      "publish_ms_mean": spans["stream.publish"]
                      / max(n_snap, 1) * 1e3,
                      "last_version": version},
           "set": {k: st_set[k] for k in st_set if k != "replicas"},
           "replica_stats": st_after,
           "poisoned": {"reason": reason, "rollback_bitwise": True},
           "chaos": {"delay_ms": CHAOS_DELAY_MS, "requests": CHAOS_REQUESTS,
                     "fired": fired, **delta},
           "replica_serving": {"batches": batches, "warmup_compiles": warm,
                               "golden_drift": drift,
                               "drift_bound": drift_bound,
                               "default_bound_rejects": strict_reason,
                               "launches": k1_serving,
                               "max_abs_err_vs_plain": worst,
                               "tolerance": MODEL_TOL},
           "launches": launches, "profile": prof,
           "peak_mem_gb": peak_gb, "card": card}
    log(f"stream: {json.dumps(out)}")
    return out


# --------------------------------------------------------------------- #
# phase 11: durable training                                            #
# --------------------------------------------------------------------- #
DURABLE_IMAGES, DURABLE_BATCH, DURABLE_EPOCHS = 1024, 256, 2  # 4 steps/epoch
# checkpoint trigger and retention; every 8 iterations, not 4: when the
# writer deflated its entries it needed ~10.7 s a ResNet-50 checkpoint
# (~19 MB/s), and at 4 the runs (a) and (b) alone took ~165 s of the
# phase's ~150 s budget
DURABLE_EVERY, DURABLE_KEEP = 4, 2
DURABLE_PREEMPT_AT = 4          # SIGTERM once the child prints this iteration
DURABLE_LENET = dict(images=512, batch=64, epochs=2, every=4, poison_at=5,
                     kill="2:bytes:2000")   # (c): mid-shard, third save
DURABLE_CHILD_TIMEOUT = 420
HEALTH_RANGES = ("health.before", "health.after")


def _durable_setup(device):
    """A process's numerics for the phase: fp32 without TF32,
    deterministic cuDNN; on the CPU (a rehearsal) one thread, so that the
    parent and the children reduce in the same order."""
    if device == "cpu":
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def _durable_resnet_data(n):
    rng = np.random.default_rng(17)
    x = rng.standard_normal((n, 224, 224, 3), dtype=np.float32)
    y = (rng.integers(0, 1000, n) + 1).astype(np.float32)
    return x, y


def _durable_lenet_data():
    rng = np.random.default_rng(19)
    n = DURABLE_LENET["images"]
    x = rng.standard_normal((n, 784), dtype=np.float32)
    y = (rng.integers(0, 10, n) + 1).astype(np.float32)
    return x, y


def _durable_opt(model, data, *, device, mesh=None, durable, ckpt=None,
                 flight=None, preempt=False, epochs, batch, every,
                 sgd, prefetch=0, mixed=False, health_policy="rollback",
                 sink_path=None, capture_cost=False):
    """The optimizer of one run: ``DistriOptimizer`` over ``mesh`` (the
    main path) or ``LocalOptimizer``; with ``durable`` the loop features:
    checkpoints every ``every`` iterations (``keep_last``, preemption),
    telemetry to a JSONL sink with the health scalars, the health
    sentinels under ``health_policy`` with a flight recorder, one retry
    and a trace context."""
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.observability import (JsonlSink, Recorder,
                                               TraceContext)
    from bigdl_tpu_torch.optim import (SGD, DistriOptimizer, LocalOptimizer,
                                       Trigger)
    if mesh is not None:
        opt = DistriOptimizer(model, data, ClassNLLCriterion(),
                              batch_size=batch, mesh=mesh, fused_optim=True)
        opt.set_optim_method(SGD(**sgd))
    else:
        opt = LocalOptimizer(model, data, ClassNLLCriterion(),
                             batch_size=batch, device=device)
        opt.set_optim_method(SGD(fused=device != "cpu", **sgd))
    opt.set_end_when(Trigger.max_epoch(epochs))
    if mixed:
        opt.set_mixed_precision()
    if prefetch:
        opt.set_prefetch(prefetch)
    if durable:
        sinks = [JsonlSink(sink_path)] if sink_path else []
        # the cost capture runs before the first step's record opens;
        # b2's run keeps it, the others leave it out for time
        opt.set_telemetry(Recorder(sinks=sinks), health=True,
                          capture_cost=capture_cost)
        opt.set_checkpoint(ckpt, Trigger.several_iteration(every),
                           keep_last=DURABLE_KEEP, handle_preemption=preempt)
        opt.set_health(policy=health_policy, flight_dir=flight)
        opt.set_auto_retry(1)
        opt.set_trace_context(TraceContext.new_root())
    return opt


def _durable_drive(opt, announce=False):
    """Run ``opt.optimize()`` with the launch counts set to 0 just before
    and read just after; each iteration's loss (by iteration), the step
    ms between consecutive steps' ends (CUDA events), and with
    ``announce`` an ``iter <n>`` line each iteration (the parent times
    its SIGTERM on them)."""
    from bigdl_tpu_torch.ops import _build
    cuda = opt.device.type == "cuda"
    losses, events = {}, []
    fire = opt._fire_mid_epoch

    def hook():
        losses[opt.state.iteration] = opt.state.loss
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        if announce:
            print(f"iter {opt.state.iteration}", flush=True)
        return fire()
    opt._fire_mid_epoch = hook
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.monotonic()
    opt.optimize()
    if cuda:
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _build.launch_counts()
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(len(events) - 1)]
    return {"losses": {int(k): float(v) for k, v in losses.items()},
            "step_ms": step_ms, "launches": launches, "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9
            if cuda else None}


def _durable_arrays(model, opt):
    from bigdl_tpu_torch.parallel.allreduce import tree_leaves
    vel = opt.opt_state.get("velocity")
    return ([w.detach().cpu().numpy() for w in model.get_weights()]
            + [s.detach().cpu().numpy() for s in model.state_list()]
            + ([] if vel is None else
               [t.detach().cpu().numpy() for t in tree_leaves(vel)]))


def _ckpt_counters(opt):
    snap = opt.recorder.snapshot()["counters"]
    return {k: v for k, v in snap.items()
            if k.startswith(("checkpoint/", "retry/", "health/", "fault/"))}


def _profile_health(model, data, device, mesh, batch):
    """Two durable-config steps (telemetry and health on, no checkpoint)
    under the profiler, the health probe's two halves under named host
    ranges; and the host syncs of the same two steps counted by
    ``torch.cuda.set_sync_debug_mode``."""
    import warnings

    from bigdl_tpu_torch.optim import Trigger, optimizer as optmod
    x, y = data
    small = (x[:2 * batch], y[:2 * batch])
    probe = optmod._HealthProbe
    before, after = probe.before, probe.after

    def named(fn, label):
        def wrapped(self, *a):
            with torch.profiler.record_function(label):
                return fn(self, *a)
        return wrapped

    def run():
        opt = _durable_opt(model, small, device=device, mesh=mesh,
                           durable=False, epochs=1, batch=batch,
                           every=DURABLE_EVERY, sgd=RESNET_SGD, prefetch=2,
                           mixed=True)
        from bigdl_tpu_torch.observability import Recorder
        # the cost capture's pass would fall inside the profiled steps
        opt.set_telemetry(Recorder(), health=True, capture_cost=False)
        opt.set_end_when(Trigger.max_iteration(2))
        opt.optimize()
    probe.before = named(before, HEALTH_RANGES[0])
    probe.after = named(after, HEALTH_RANGES[1])
    try:
        _profiler_warm()    # its first use stalls launches for seconds
        prof = profile_steps(run, steps=2, classes=DISTRI_CLASSES,
                             ranges=HEALTH_RANGES)
    finally:
        probe.before, probe.after = before, after
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:80] for w in caught
             if "synchroniz" in str(w.message)]
    return prof, {"steps": 2, "epoch_ends": 1, "host_syncs": len(syncs)}


def durable_child(spec: dict) -> None:
    """One run of ``phase_durable`` in a process of its own (the model
    built first, so that its module names are the same in every child):
    ``kind`` ``"a"`` (the main path with durability off, then on, then
    the health probe profiled), ``"b"`` (on, preemptible, or resuming),
    ``"c"`` (LeNet-5 on K6, killed by the armed checkpoint fault)."""
    from bigdl_tpu_torch.parallel import mesh as mesh_lib
    device = spec.get("device", "cuda")
    _durable_setup(device)
    work = spec["work"]
    out = {"kind": spec["kind"], "pid": os.getpid()}
    if spec["kind"] == "c":
        from bigdl_tpu_torch.models import lenet
        model = lenet.build(10, device=device, seed=0)
        opt = _durable_opt(model, _durable_lenet_data(), device=device,
                           durable=True, ckpt=spec["ckpt"],
                           flight=os.path.join(work, "flight_c"),
                           epochs=DURABLE_LENET["epochs"],
                           batch=DURABLE_LENET["batch"],
                           every=DURABLE_LENET["every"], sgd=LENET_SGD)
        _durable_drive(opt, announce=True)
        raise AssertionError("the armed checkpoint fault did not fire")
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.parallel.allreduce import tree_leaves
    if spec.get("small"):       # a CPU rehearsal: CIFAR ResNet-8
        build = lambda: resnet.build(class_num=10, depth=8,
                                     dataset="cifar10", format="NHWC",
                                     seed=0, device=device)
        rng = np.random.default_rng(17)
        data = (rng.standard_normal((spec["images"], 32, 32, 3),
                                    dtype=np.float32),
                (rng.integers(0, 10, spec["images"]) + 1)
                .astype(np.float32))
    else:
        build = lambda: resnet.build(class_num=1000, depth=50,
                                     dataset="imagenet", format="NHWC",
                                     seed=0, device=device)
        data = None
    model = build()
    out["n_leaves"] = len(tree_leaves(model.param_dict()))
    if data is None:
        data = _durable_resnet_data(spec["images"])
    store = os.path.join(work, f"store_{spec['name']}")
    mesh_lib.init_distributed(f"file://{store}", 0, 1, device=device)
    mesh = mesh_lib.create_mesh({"dp": 1}, device=device)
    common = dict(device=device, mesh=mesh, epochs=DURABLE_EPOCHS,
                  batch=spec["batch"],
                  every=DURABLE_EVERY, sgd=RESNET_SGD, prefetch=2,
                  mixed=device != "cpu")
    try:
        if spec["name"] == "b2":
            # the capture's once-a-process cost (its first dispatch mode
            # imports torch._dynamo), paid while b2 waits for b1
            from bigdl_tpu_torch.observability.profile import capture_step
            t_w = time.perf_counter()
            capture_step(lambda: torch.ones(1, device=device) + 1,
                         device=device)
            out["capture_first_use_s"] = time.perf_counter() - t_w
        _await_go(spec)
        if spec["kind"] == "a":
            off_model = model
            out["off"] = _durable_drive(_durable_opt(
                off_model, data, durable=False, **common))
            model = build()
        opt = _durable_opt(model, data, durable=True, ckpt=spec["ckpt"],
                           flight=os.path.join(work, f"flight_{spec['name']}"),
                           preempt=spec.get("preempt", False),
                           sink_path=os.path.join(work,
                                                  f"{spec['name']}.jsonl"),
                           capture_cost=spec["name"] == "b2", **common)
        out["on"] = _durable_drive(opt, announce=spec.get("preempt", False))
        out["on"]["iteration"] = opt.state.iteration
        prof = opt.recorder.recent_records(rec_type="profile")
        if prof:
            cost = prof[-1]["cost"]
            out["capture"] = {"capture_s": prof[-1]["capture_s"], **{
                k: cost.get(k) for k in ("flops", "bytes_accessed",
                                         "peak_hbm_bytes", "unavailable")}}
        out["counters"] = _ckpt_counters(opt)
        if out["counters"].get("checkpoint/restored"):
            # optimize() restored once; its first step follows that one
            out["resumed_from"] = min(out["on"]["losses"]) - 1
        kept = [os.path.join(spec["ckpt"], e)
                for e in sorted(os.listdir(spec["ckpt"]))
                if e.startswith("ckpt_")]
        out["ckpt_mb"] = {os.path.basename(d): sum(
            os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 1e6
            for d in kept}
        from bigdl_tpu_torch.observability.tracing import get_tracer
        out["trace_spans"] = sorted(
            s.name for s in get_tracer().store.spans()
            if s.subsystem == "checkpoint"
            and s.trace_id == opt._trace_ctx.trace_id)
        np.savez(os.path.join(work, f"{spec['name']}.npz"),
                 *_durable_arrays(model, opt))
        # the timed runs are over: the parent starts (b) beside the rest
        print("A TIMED", flush=True)
        if spec["kind"] == "a" and device != "cpu":
            out["profile"], out["syncs"] = _profile_health(
                build(), data, device, mesh, spec["batch"])
    finally:
        torch.distributed.destroy_process_group()
        mesh_lib.set_mesh(None)
    with open(os.path.join(work, f"{spec['name']}.json"), "w") as f:
        json.dump(out, f)
    print("CHILD DONE", flush=True)


def _await_go(spec):
    """A child started ahead of its turn (``spec["wait_for"]``), its
    process, model and data set up, waits here until the parent creates
    that file: the run before it has ended."""
    path = spec.get("wait_for")
    if not path:
        return
    deadline = time.monotonic() + DURABLE_CHILD_TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no go from the parent: {path}")
        time.sleep(0.05)


def _spawn_child(spec, fault=None, sigterm_at=None, flag="--durable-child",
                 on_line=None):
    """Run ``durable_child(spec)`` (``flag="--lm-durable-child"``:
    ``lm_durable_child``) in a new process of this script; with
    ``sigterm_at``, send it SIGTERM once it prints ``iter <n>``;
    ``on_line(line)`` sees each line it prints.  Returns ``(exit code,
    output)``."""
    import signal
    env = dict(os.environ)
    env.pop("BIGDL_CKPT_FAULT", None)
    if fault:
        env["BIGDL_CKPT_FAULT"] = fault
    if flag in ("--lm-durable-child", "--data-elastic-child"):
        # cuBLAS's deterministic workspace: the LM child asks for
        # deterministic algorithms (set before its first CUDA call)
        env.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                          flag, json.dumps(spec)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    lines = []
    # a child that hangs without printing is killed at the deadline: the
    # read below then ends, and the phase fails on the exit code
    killer = threading.Timer(DURABLE_CHILD_TIMEOUT, p.kill)
    killer.daemon = True
    killer.start()
    try:
        deadline = time.monotonic() + DURABLE_CHILD_TIMEOUT
        for line in p.stdout:
            lines.append(line)
            if on_line is not None:
                on_line(line)
            if (sigterm_at is not None
                    and line.strip() == f"iter {sigterm_at}"):
                p.send_signal(signal.SIGTERM)
                sigterm_at = None
            if time.monotonic() > deadline:
                break
        p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        killer.cancel()
        killer.join(5.0)
        if p.poll() is None:
            p.kill()
            p.wait(30)
        p.stdout.close()
    text = "".join(lines)
    log(f"{flag[2:]} {spec['name']}: exit {p.returncode}; "
        + " | ".join(l.strip() for l in lines[-6:]))
    return p.returncode, text


def _npz(path):
    with np.load(path) as z:
        return [z[k] for k in z.files]


def _lenet_leg(work, device, fails):
    """(c) a torn newest checkpoint and (d) a rollback, on LeNet-5 with
    SGD(0.05) on K6 through LocalOptimizer: the killed child, then here
    the resume and the uninterrupted run (bitwise), and the poisoned run
    under ``policy="rollback"``."""
    import shutil

    from bigdl_tpu_torch.checkpoint import scan
    from bigdl_tpu_torch.checkpoint.faults import KILL_EXIT_CODE
    from bigdl_tpu_torch.data.dataset import DataSet
    from bigdl_tpu_torch.data.minibatch import MiniBatch
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.observability.health import read_flight
    L = DURABLE_LENET
    data = _durable_lenet_data()
    out = {}
    _durable_setup(device)
    # (c) torn newest: killed mid-shard in its third save
    ck = os.path.join(work, "lenet_ck")
    rc, text = _spawn_child({"kind": "c", "name": "c", "work": work,
                             "ckpt": ck, "device": device}, fault=L["kill"])
    intact = [m.meta["iteration"] for _, m in scan(ck)]
    torn = sorted(d for d in os.listdir(ck) if d.startswith("ckpt_")
                  and not os.path.exists(os.path.join(ck, d,
                                                      "MANIFEST.json")))
    if rc != KILL_EXIT_CODE:
        fails.append(f"(c) the child exited {rc}, not the kill's "
                     f"{KILL_EXIT_CODE}: {text[-400:]}")
    if intact != [L["every"], 2 * L["every"]] or not torn:
        fails.append(f"(c) after the kill: intact {intact}, torn {torn}")

    def lenet_run(ckpt, poison=False, policy="rollback", every=L["every"]):
        model = lenet.build(10, device=device, seed=0)
        ds = DataSet.minibatch_arrays(*data, L["batch"])
        if poison:
            ds = _PoisonOnceDS(ds, L["poison_at"], MiniBatch)
        opt = _durable_opt(model, ds, device=device, durable=ckpt is not None,
                           ckpt=ckpt, flight=os.path.join(work, "flight_d"),
                           epochs=L["epochs"], batch=L["batch"], every=every,
                           sgd=LENET_SGD, health_policy=policy)
        if ckpt is not None:
            from bigdl_tpu_torch.observability import InMemorySink
            opt.recorder.add_sink(InMemorySink())
        try:
            run = _durable_drive(opt)
        finally:
            if opt._flight is not None:     # this process's hooks
                opt._flight.uninstall()
        return model, opt, run

    m_res, o_res, r_res = lenet_run(ck)
    m_ref, _, r_ref = lenet_run(None)
    if o_res.recorder.counter_value("checkpoint/failed"):
        fails.append("(c) a checkpoint write of the resumed run failed")
    same = all(torch.equal(a, b) for a, b in zip(
        m_res.get_weights(), m_ref.get_weights()))
    resumed_at = min(r_res["losses"]) - 1
    if not same or resumed_at != 2 * L["every"]:
        fails.append(f"(c) resume from iteration {resumed_at} is not "
                     f"bitwise the uninterrupted run ({same})")
    out["torn"] = {"exit": rc, "intact_after_kill": intact, "torn": torn,
                   "resumed_from": resumed_at, "bitwise": same,
                   "launches": r_res["launches"]}
    # (d) rollback: a NaN batch once, a checkpoint every 2 steps
    shutil.rmtree(os.path.join(work, "flight_d"), ignore_errors=True)
    m_d, o_d, r_d = lenet_run(os.path.join(work, "lenet_rollback"),
                              poison=True, every=2)
    if o_d.recorder.counter_value("checkpoint/failed"):
        fails.append("(d) a checkpoint write failed")
    steps = [r for r in o_d.recorder.sinks[-1].records
             if r.get("type") == "step"]
    seen = [r["step"] for r in steps]
    k = L["poison_at"] + 1
    mon = o_d._health_monitor
    tripped = [e["step"] for e in mon.events]
    flights = [read_flight(os.path.join(work, "flight_d", f))["reason"]
               for f in sorted(os.listdir(os.path.join(work, "flight_d")))]
    after = [r["scalars"]["loss"] for r in steps[seen.index(k) + 1:]]
    planned = L["epochs"] * L["images"] // L["batch"]
    ok = (mon.rollbacks == 1 and set(tripped) == {k} and seen.count(k) == 2
          and all(np.isfinite(after)) and flights == ["divergence"]
          and o_d.state.iteration == planned and seen[-1] == planned)
    if not ok:
        fails.append(f"(d) rollback: rollbacks {mon.rollbacks}, tripped "
                     f"{tripped}, seen {seen}, flights {flights}, ended at "
                     f"{o_d.state.iteration}")
    out["rollback"] = {"rollbacks": mon.rollbacks, "tripped_at": tripped,
                       "steps_seen": seen, "flight_dumps": flights,
                       "ended_at": o_d.state.iteration,
                       "launches": r_d["launches"]}
    return out


class _PoisonOnceDS:
    """A NaN into batch ``at`` (0-based) of the first epoch, once."""

    def __init__(self, inner, at, mb_cls):
        self.inner, self.at, self.mb_cls, self.armed = inner, at, mb_cls, True

    def data(self, train=True, epoch=None):
        for i, mb in enumerate(self.inner.data(train=train, epoch=epoch)):
            if self.armed and i == self.at:
                self.armed = False
                xx = np.array(mb.get_input())
                xx[0, 0] = np.nan
                mb = self.mb_cls(xx, mb.get_target())
            yield mb


def _per_save(counters, saves):
    """ms a checkpoint of each writer part, from the child's counters."""
    return {part: counters.get(f"checkpoint/{key}_seconds", 0.0) * 1e3
            / max(saves, 1)
            for part, key in (("encode", "encode"),
                              ("crc32c", "crc"), ("write_fsync", "io"),
                              ("commit_gc", "commit"),
                              ("writer_total", "write"),
                              ("blocking_d2h", "d2h"),
                              ("blocking_backpressure", "backpressure"))}


def phase_durable(card: str, device: str = "cuda", small: bool = False):
    """BigDL's durable training on the main path (ResNet-50 ImageNet NHWC
    bf16 b256 through DistriOptimizer at dp=1 over NCCL, K5): (a) one run
    with durability off and one on, (b) preempted by SIGTERM and resumed
    (bitwise (a)), each in a process of its own; (c) a torn newest
    checkpoint and (d) a rollback on LeNet-5 (K6).  ``device="cpu",
    small=True`` rehearses it on the CPU (CIFAR ResNet-8, 128 images at
    batch 16, the same 2 × 8 steps)."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.checkpoint import scan
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.ops import _build
    t0 = time.monotonic()
    fails = []
    if device != "cpu":
        torch.cuda.empty_cache()    # the children need the card's memory
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="durable_", dir=str(_build.BUILD_DIR))
    batch = 16 if small else DURABLE_BATCH
    images = 8 * batch if small else DURABLE_IMAGES
    extra = {"device": device, "work": work, "small": small,
             "batch": batch, "images": images}
    try:
        from concurrent.futures import ThreadPoolExecutor
        runs, codes = {}, {}

        def child(name, kind, kw, on_line=None):
            codes[name], _ = _spawn_child(
                {"name": name, "kind": kind,
                 "ckpt": os.path.join(work, f"ck_{kind}"), **extra, **kw},
                sigterm_at=DURABLE_PREEMPT_AT if kw else None,
                on_line=on_line)
            with open(os.path.join(work, f"{name}.json")) as f:
                runs[name] = json.load(f)

        def b_runs():
            # b2 starts with b1 and waits, set up, for b1's end
            go = os.path.join(work, "go_b2")
            b2 = pool.submit(child, "b2", "b", {"wait_for": go})
            try:
                child("b1", "b", dict(preempt=True))
                # before b2's retention removes it
                tags = [m.tag for _, m in scan(os.path.join(work, "ck_b"))]
            finally:
                open(go, "w").close()
            b2.result(timeout=DURABLE_CHILD_TIMEOUT + 60)
            return tags
        # (b) starts once (a)'s timed runs are over (its health profile
        # then runs beside b1), and (c) and (d) here beside (b): nothing
        # timed among them is read against another run
        pool = ThreadPoolExecutor(2)
        started = {}

        def a_line(line):
            if line.strip() == "A TIMED" and "b" not in started:
                started["b"] = pool.submit(b_runs)
        try:
            child("a", "a", {}, on_line=a_line)
            if "b" not in started:
                started["b"] = pool.submit(b_runs)
            lenet = _lenet_leg(work, device, fails)
            preempt_tags = started["b"].result(
                timeout=2 * DURABLE_CHILD_TIMEOUT + 60)
        finally:
            pool.shutdown()
        for name in ("a", "b1", "b2"):
            if codes[name] != 0:
                fails.append(f"child {name} exited {codes[name]}")
            if runs[name]["counters"].get("checkpoint/failed"):
                fails.append(f"child {name}: a checkpoint write failed")
        a, b1, b2 = runs["a"], runs["b1"], runs["b2"]
        steps = DURABLE_EPOCHS * images // batch
        k = b1["on"]["iteration"]
        if not (DURABLE_PREEMPT_AT <= k < steps
                and b2.get("resumed_from") == k
                and preempt_tags[-1:] == [f"preempt_iter_{k}"]):
            fails.append(f"(b) preempted at {k}, resumed from "
                         f"{b2.get('resumed_from')}, committed "
                         f"{preempt_tags}")
        bits = all(np.array_equal(u, v) for u, v in zip(
            _npz(os.path.join(work, "a.npz")),
            _npz(os.path.join(work, "b2.npz"))))
        la = {int(i): v for i, v in a["on"]["losses"].items()}
        lb = {**{int(i): v for i, v in b1["on"]["losses"].items()},
              **{int(i): v for i, v in b2["on"]["losses"].items()}}
        loss_bits = all(lb[i] == la[i] for i in range(k + 1, steps + 1))
        if not (bits and loss_bits and b2["on"]["iteration"] == steps):
            fails.append(f"(b) resumed run against (a): state bitwise "
                         f"{bits}, losses equal {loss_bits}")
        per = -(-a["n_leaves"] // fo.SGD_CAPACITY)
        for name, run, want in (("a off", a["off"], steps),
                                ("a on", a["on"], steps),
                                ("b1", b1["on"], k),
                                ("b2", b2["on"], steps - k)):
            got = run["launches"].get(fo.SGD_MOM, 0)
            if device != "cpu" and got != want * per:
                fails.append(f"{name}: K5 launched {got}, expected "
                             f"{want * per}")
        if a["trace_spans"].count("ckpt.write") != steps // DURABLE_EVERY:
            fails.append(f"trace spans {a['trace_spans']}")
        cap = dict(b2.get("capture") or {},
                   first_use_s=b2.get("capture_first_use_s"))
        if not (cap.get("flops") or 0) > 0 or cap.get("unavailable") != (
                ["memory_analysis"] if device == "cpu" else None):
            fails.append(f"b2's first-step cost capture: {cap}")
        saves = a["counters"].get("checkpoint/committed", 0)
        readings = {
            "card": card,
            "step_ms_median_off": float(np.median(a["off"]["step_ms"][1:]))
            if a["off"]["step_ms"] else None,
            "step_ms_median_on": float(np.median(a["on"]["step_ms"][1:]))
            if a["on"]["step_ms"] else None,
            "wall_s_off": a["off"]["wall_s"], "wall_s_on": a["on"]["wall_s"],
            "checkpoints": saves,
            "ms_per_checkpoint": _per_save(a["counters"], saves),
            "mb_per_checkpoint": a["ckpt_mb"],
            "restore_ms": {p: b2["counters"].get(
                f"checkpoint/restore_{p}_seconds", 0.0) * 1e3
                for p in ("scan", "verify", "decode", "h2d")},
            "peak_mem_gb_off": a["off"]["peak_mem_gb"],
            "peak_mem_gb_on": a["on"]["peak_mem_gb"],
            "cost_capture": cap,
            "profile": a.get("profile"), "host_syncs": a.get("syncs"),
            "retry_attempts": a["counters"].get("retry/attempts", 0.0)}
        prof = a.get("profile") or {}
        if prof.get("device_ms_by_range"):
            readings["health_device_ms_per_step"] = sum(
                prof["device_ms_by_range"].get(r, 0.0)
                for r in HEALTH_RANGES)
        launches = {}
        for run in (a["on"], b1["on"], b2["on"],
                    lenet["torn"], lenet["rollback"]):
            for kk, v in run["launches"].items():
                launches[kk] = launches.get(kk, 0) + v
        out = {"config": "resnet.build(class_num=1000, depth=50, "
                         "format='NHWC', seed=0), DistriOptimizer(batch_size"
                         "=256, mesh=create_mesh({'dp': 1}), fused_optim="
                         "True), set_mixed_precision(), set_prefetch(2), "
                         "SGD(0.1, momentum=0.9, weight_decay=1e-4), 2 "
                         "epochs of 4 steps over 1024 synthetic images; "
                         f"set_checkpoint(several_iteration({DURABLE_EVERY}),"
                         " keep_last=2, handle_preemption=True), "
                         "set_telemetry(health="
                         "True), set_health('rollback', flight_dir), "
                         "set_auto_retry(1), set_trace_context; NCCL at "
                         "world size 1; (c), (d) LeNet-5, SGD(0.05), K6",
               "preempted_at": k, "resumed_bitwise": bits,
               "resumed_losses_equal": loss_bits,
               "losses_a": la, "lenet": lenet, "readings": readings,
               "launches": launches,
               "launches_by_run": {"a_off": a["off"]["launches"],
                                   "a_on": a["on"]["launches"],
                                   "b1": b1["on"]["launches"],
                                   "b2": b2["on"]["launches"]},
               "seconds": time.monotonic() - t0}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"durable: {json.dumps(out)}")
    if fails:
        raise AssertionError("durable phase: " + "; ".join(fails))
    return out



# --------------------------------------------------------------------- #
# 12. lm_long: the rest of TransformerLM training at long8k's full width
LONG = dict(preset="long8k", batch=4, seq=8192, check_layers=2, chunk=1024,
            warm=1, timed=4, lr=3e-4, eval_batches=2, check_batch=1)
# a CPU rehearsal (device="cpu", small=True): tiny widths and depth
LONG_SMALL = dict(preset="tiny", batch=2, seq=128, check_layers=2, chunk=32,
                  warm=1, timed=2, lr=3e-4, eval_batches=2, check_batch=1)
# (a) in bf16: kernels against the plain attention, both bf16 over fp32
# parameters (PERF.md, written before the first run)
LONG_BF16_LOSS_REL = 5e-3        # |loss_k - loss_p| / loss_p, step 1
LONG_BF16_GRAD_REL = 5e-2        # per leaf max |dg| <= this * max |g|
# (b) remat against no remat where no remat does not repeat itself
LONG_NONDET_REL = 1e-6           # per leaf max |dg| <= this * max |g|
# (c) loss_chunk against the full loss, fp32
CHUNK_LOSS_REL = 1e-5
# (e) the reference recipe's own preset (examples/transformer_spmd.py)
# with dropout and a seed
LM_RECIPE = dict(preset="tiny", remat=True, dropout=0.1, loss_chunk=32,
                 seed=3, batch=2, seq=64, steps=12, every=4, preempt_at=6,
                 poison_at=6, lr=3e-4)
LONG_CLASSES = KERNEL_CLASSES[:4] + (("nvjet", "matmul (cuBLAS)"),) \
    + KERNEL_CLASSES[4:]


def _lm_batch(rs, vocab, b, s):
    ids = rs.randint(0, vocab, (b, s + 1)).astype(np.int32)
    return ids[:, :-1], ids[:, 1:]


def _lm_grads(model, tok, tgt, *, loss_chunk=None, plain=False):
    """Step-1 loss and gradients (by leaf name) of ``model`` on one batch,
    with the kernels or, with ``plain``, the plain attention."""
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    fn = (lambda q, k, v: fa.flash_attention_plain(q, k, v, causal=True)) \
        if plain else None
    for blk in model.blocks:
        blk.attn.attention_fn = fn
    try:
        params = model.param_dict()
        names = [f"{n}.{k}" for n, sub in params.items() for k in sub]
        leaves = [p for sub in params.values() for p in sub.values()]
        loss = model.loss(params, tok, tgt, loss_chunk=loss_chunk,
                          training=True)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for blk in model.blocks:
            blk.attn.attention_fn = None
    return loss.detach(), dict(zip(names, grads))


def _worst_leaf(got, want):
    """(max over leaves of max |got - want| / max |want|, that leaf)."""
    worst, leaf = 0.0, None
    for name, w in want.items():
        g = got[name]
        if not torch.isfinite(g).all():
            raise AssertionError(f"non-finite gradient {name}")
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max().clamp(min=1e-30)).item()
        if rel > worst:
            worst, leaf = rel, name
    return worst, leaf


def _long_checks(cfg, device, fails):
    """(a) kernels against the plain attention (fp32 with TF32 off, and
    bf16), (b) remat against no remat (bf16, kernels in both), (c) the
    chunked loss against the full one (fp32), at the preset's widths and
    sequence length with ``check_layers`` layers and ``check_batch``
    sequences (the plain attention's blockwise loop is slow at S 8192)."""
    from bigdl_tpu_torch.models import transformer as T
    out = {}
    rs = np.random.RandomState(21)
    vocab = T.PRESETS[cfg["preset"]]["vocab_size"]
    tok, tgt = (torch.from_numpy(a).to(device) for a in _lm_batch(
        rs, vocab, cfg["check_batch"], cfg["seq"]))
    common = dict(device=device, seed=0, n_layers=cfg["check_layers"],
                  remat=False)
    # (a) fp32, and (c) on the same model
    model = T.build(cfg["preset"], dtype="float32", **common)
    loss_k, g_k = _lm_grads(model, tok, tgt, loss_chunk=cfg["chunk"])
    loss_p, g_p = _lm_grads(model, tok, tgt, loss_chunk=cfg["chunk"],
                            plain=True)
    rel, leaf = _worst_leaf(g_k, g_p)
    dl = abs(loss_k.item() - loss_p.item())
    out["a_fp32"] = {"loss_kernels": loss_k.item(),
                     "loss_plain": loss_p.item(), "loss_diff": dl,
                     "loss_tol": LOSS_TOL, "grad_max_rel_diff": rel,
                     "grad_worst_leaf": leaf, "grad_rel_tol": GRAD_REL_TOL}
    log(f"lm_long (a) fp32 kernels vs plain: {json.dumps(out['a_fp32'])}")
    if not (dl <= LOSS_TOL and rel <= GRAD_REL_TOL):
        fails.append(f"(a) fp32: loss diff {dl:.3e}, grads {rel:.3e}")
    del g_p
    loss_f, g_f = _lm_grads(model, tok, tgt, loss_chunk=None)
    rel, leaf = _worst_leaf(g_k, g_f)
    dl = abs(loss_k.item() - loss_f.item()) / abs(loss_f.item())
    out["c_chunk"] = {"chunk": cfg["chunk"], "loss_chunked": loss_k.item(),
                      "loss_full": loss_f.item(), "loss_rel_diff": dl,
                      "loss_rel_tol": CHUNK_LOSS_REL,
                      "grad_max_rel_diff": rel, "grad_worst_leaf": leaf,
                      "grad_rel_tol": GRAD_REL_TOL}
    log(f"lm_long (c) chunked vs full: {json.dumps(out['c_chunk'])}")
    if not (dl <= CHUNK_LOSS_REL and rel <= GRAD_REL_TOL):
        fails.append(f"(c) chunked: loss {dl:.3e}, grads {rel:.3e}")
    del model, g_k, g_f
    # (a) bf16 and (b) on one bf16 model
    model = T.build(cfg["preset"], dtype="bfloat16", **common)
    loss_k, g_k = _lm_grads(model, tok, tgt, loss_chunk=cfg["chunk"])
    loss_p, g_p = _lm_grads(model, tok, tgt, loss_chunk=cfg["chunk"],
                            plain=True)
    rel, leaf = _worst_leaf(g_k, g_p)
    dl = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    out["a_bf16"] = {"loss_kernels": loss_k.item(),
                     "loss_plain": loss_p.item(), "loss_rel_diff": dl,
                     "loss_rel_tol": LONG_BF16_LOSS_REL,
                     "grad_max_rel_diff": rel, "grad_worst_leaf": leaf,
                     "grad_rel_tol": LONG_BF16_GRAD_REL}
    log(f"lm_long (a) bf16 kernels vs plain: {json.dumps(out['a_bf16'])}")
    if not (dl <= LONG_BF16_LOSS_REL and rel <= LONG_BF16_GRAD_REL):
        fails.append(f"(a) bf16: loss {dl:.3e}, grads {rel:.3e}")
    del g_p
    # (b): no remat twice (what does not repeat itself), then remat
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss_k2, g_k2 = _lm_grads(model, tok, tgt, loss_chunk=cfg["chunk"])
        model.cfg.remat = True
        loss_r, g_r = _lm_grads(model, tok, tgt, loss_chunk=cfg["chunk"])
    finally:
        model.cfg.remat = False
        torch.use_deterministic_algorithms(False)
    nondet = sorted(n for n in g_k if not torch.equal(g_k[n], g_k2[n]))
    differ = sorted(n for n in g_k if not torch.equal(g_k[n], g_r[n]))
    held = {n: _worst_leaf({n: g_r[n]}, {n: g_k[n]})[0] for n in nondet}
    out["b_remat"] = {
        "loss_no_remat": loss_k.item(), "loss_remat": loss_r.item(),
        "loss_bitwise": bool(torch.equal(loss_k, loss_r)),
        "repeat_loss_bitwise": bool(torch.equal(loss_k, loss_k2)),
        "leaves": len(g_k), "leaves_differing": differ,
        "leaves_not_repeating": nondet, "not_repeating_max_rel": held,
        "not_repeating_rel_tol": LONG_NONDET_REL}
    log(f"lm_long (b) remat vs no remat: {json.dumps(out['b_remat'])}")
    if (not out["b_remat"]["loss_bitwise"]
            or set(differ) - set(nondet)
            or any(v > LONG_NONDET_REL for v in held.values())):
        fails.append(f"(b) remat: loss bitwise "
                     f"{out['b_remat']['loss_bitwise']}, differing "
                     f"{differ}, not repeating {nondet}")
    del model, g_k, g_k2, g_r
    return out


def _long_flops_per_token(model, seq):
    """The matmuls' operations a token of one training step (forward and
    backward: 6 a parameter, the embedding a gather), the blocks' forward
    again (remat), each loss chunk's head again (its checkpoint), and
    causal attention: 2·S·d a layer forward, 2.5× that backward, and the
    forward again under remat."""
    cfg = model.cfg
    n = sum(p.numel() for p in model.parameters())
    n_embed = model.embed.weight.numel()
    n_head = n_embed if model.head is None else model.head.weight.numel()
    n_blocks = sum(p.numel() for b in model.blocks for p in b.parameters())
    attn = 2 * seq * cfg.d_model * cfg.n_layers
    parts = {"matmuls": 6 * (n - n_embed), "remat_forward": 2 * n_blocks,
             "chunk_head_again": 2 * n_head,
             "attention": attn * (1 + 2.5 + (1 if cfg.remat else 0))}
    return sum(parts.values()), parts


def _long_kernel_times(cfg, trainer, card, fails):
    """K1–K4 at the main path's shapes, each held against its plain
    version there (K4 bitwise on copies of the trained parameters and
    moments), then timed by CUDA events with the host queued ahead,
    beside the plain versions, SDPA forward and backward and
    ``torch.optim.AdamW(fused=True)``, with the bounds."""
    import copy

    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    from bigdl_tpu_torch.parallel.allreduce import tree_leaves, tree_map
    mcfg = trainer.model.cfg
    b, h, s, d = cfg["batch"], mcfg.n_heads, cfg["seq"], mcfg.head_dim
    dt = torch.bfloat16
    q, k, v = _qkv(b, h, s, s, d, dt, seed=31, layout="main")
    do = _grad_out(q, "main", 32)
    err, lse_err, tol, ok, _ = _compare(fa, q, k, v, True)
    k1_bound, k1_by = attention_bound(b, h, s, s, d, True, dt)
    k1 = {"shape": [b, h, s, s, d], "dtype": "bfloat16", "causal": True,
          "max_abs_err": err, "lse_max_abs_err": lse_err, "tolerance": tol,
          "ok": ok,
          "ms": queued_ms(lambda: fa.flash_forward(q, k, v, causal=True),
                          iters=10),
          "plain_ms": queued_ms(lambda: fa.flash_forward_plain(
              q, k, v, causal=True), iters=2, warm=1),
          "library_ms": queued_ms(
              lambda: torch.nn.functional.scaled_dot_product_attention(
                  q, k, v, is_causal=True), iters=10),
          "bound_ms": k1_bound, "bound_by": k1_by, "card": card}
    err, errs, tol, ok2, _ = compare_bwd(fa, q, k, v, do, causal=True)
    ms, library_ms, (out, lse) = bwd_times(fa, q, k, v, do)
    plain_ms = queued_ms(lambda: fa.flash_backward_plain(
        q, k, v, out, lse, do, causal=True), iters=2, warm=1)
    bounds = bwd_bounds(b, h, s, s, d, True, dt)
    k23 = {name: {"shape": [b, h, s, s, d], "dtype": "bfloat16",
                  "causal": True, "max_abs_err": err,
                  "errors_and_max_ref": errs, "tolerance": tol, "ok": ok2,
                  "ms": ms[name], "plain_ms_dq_dk_dv": plain_ms,
                  "library_ms_dq_dk_dv": library_ms,
                  "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
                  "card": card} for name in BWD_KERNELS}
    if not (ok and ok2):
        fails.append(f"K1 {ok}, K2+K3 {ok2} against the plain versions at "
                     f"the main path's shapes")
    del q, k, v, do, out, lse
    # K4 on the trained parameters, the moments and random gradients
    params, state = trainer.params, trainer.opt_state
    leaves = [p for sub in params.values() for p in sub.values()]
    g = torch.Generator(device="cuda").manual_seed(33)
    grads = {n: {kk: torch.randn(p.shape, generator=g, device="cuda")
                 * 1e-3 for kk, p in sub.items()}
             for n, sub in params.items()}
    n_par = sum(p.numel() for p in leaves)
    nbytes = 28 * n_par        # p, g, m, v read; p, m, v written (f32)
    plain = copy.copy(trainer.optim)
    plain.fused = False
    runs = []
    for method in (trainer.optim, plain):
        p_c, s_c = tree_map(torch.clone, params), tree_map(torch.clone,
                                                            state)
        before = _build.launch_counts().get("fused_adam", 0)
        p_c, s_c = method.update(grads, p_c, s_c)
        torch.cuda.synchronize()
        runs.append((tree_leaves(p_c) + tree_leaves(s_c),
                     _build.launch_counts().get("fused_adam", 0) - before))
    (got, k4_launches), (want, _) = runs
    k4_err = max((a.float() - b.float()).abs().max().item()
                 for a, b in zip(got, want) if a.numel())
    k4_bitwise = len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    del runs, got, want, p_c, s_c
    if not (k4_bitwise and k4_launches == 1):
        fails.append(f"K4 on the main path's {len(leaves)} leaves: bitwise "
                     f"{k4_bitwise}, max_abs_err {k4_err}, "
                     f"{k4_launches} launch(es)")
    k4 = {"leaves": len(leaves), "params": n_par, "max_abs_err": k4_err,
          "tolerance": "bitwise", "bitwise": k4_bitwise,
          "check_launches": k4_launches,
          "ms": queued_ms(lambda: trainer.optim.update(grads, params,
                                                       state), iters=5),
          "plain_ms": queued_ms(lambda: plain.update(grads, params, state),
                                iters=2, warm=1),
          "bound_ms": nbytes / H100_HBM_BYTES_S * 1e3, "bound_by": "bytes",
          "card": card}
    for p, (n, kk) in zip(leaves, ((n, kk) for n, sub in grads.items()
                                   for kk in sub)):
        p.grad = grads[n][kk]
    lib = torch.optim.AdamW(leaves, lr=cfg["lr"], fused=True)
    k4["library_ms"] = queued_ms(lib.step, iters=5)
    for p in leaves:
        p.grad = None
    del lib, grads
    torch.cuda.empty_cache()
    out = {"flash_fwd": k1, **k23, "fused_adam": k4}
    log(f"lm_long kernels at the main path's shapes: {json.dumps(out)}")
    return out


def _long_main_path(cfg, device, fails, card):
    """(d): the preset at full depth through SpmdTrainer.fit with a
    TrainSummary, then evaluate with a ValidationSummary, both read back;
    the readings; launches counted from 0 around fit and evaluate."""
    import shutil

    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer
    from bigdl_tpu_torch.visualization import (TrainSummary,
                                               ValidationSummary)
    cuda = device != "cpu"
    t0 = time.monotonic()
    model = T.build(cfg["preset"], device=device, seed=0)
    mcfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    n_leaves = sum(1 for _ in model.parameters())
    log(f"lm_long model: {cfg['preset']} {n_params} params in {n_leaves} "
        f"leaves, {mcfg.dtype}, remat {mcfg.remat}, "
        f"{time.monotonic() - t0:.1f} s")
    trainer = SpmdTrainer(model, AdamW(learning_rate=cfg["lr"],
                                       fused=cuda),
                          device=device, loss_chunk=cfg["chunk"])
    logs = os.path.join(str(_build.BUILD_DIR), "lm_long_summaries")
    shutil.rmtree(logs, ignore_errors=True)
    train_sum = TrainSummary(logs, cfg["preset"])
    val_sum = ValidationSummary(logs, cfg["preset"])
    trainer.set_train_summary(train_sum).set_val_summary(val_sum)
    rs = np.random.RandomState(23)
    batch = _lm_batch(rs, mcfg.vocab_size, cfg["batch"], cfg["seq"])
    evals = [_lm_batch(rs, mcfg.vocab_size, cfg["batch"], cfg["seq"])
             for _ in range(cfg["eval_batches"])]
    steps = cfg["warm"] + cfg["timed"]
    marks = []

    def feed():
        for _ in range(steps):
            if cuda:
                torch.cuda.synchronize()
            marks.append(time.monotonic())
            yield batch
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses = trainer.fit(feed())
    if cuda:
        torch.cuda.synchronize()
    marks.append(time.monotonic())
    launches = _build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    step_s = [b - a for a, b in zip(marks, marks[1:])][cfg["warm"]:]
    _build.reset_launch_counts()
    res = trainer.evaluate(iter(evals))
    eval_launches = _build.launch_counts()
    tables = -(-n_leaves // fo.ADAM_CAPACITY)
    want = {"flash_fwd": 2 * mcfg.n_layers * steps,
            "flash_bwd_dkv": mcfg.n_layers * steps,
            "flash_bwd_dq": mcfg.n_layers * steps,
            "fused_adam": tables * steps} if cuda else {}
    got = {name: launches.get(name, 0) for name in want}
    want_eval = {"flash_fwd": mcfg.n_layers * cfg["eval_batches"]} \
        if cuda else {}
    got_eval = {name: eval_launches.get(name, 0) for name in want_eval}
    log(f"lm_long launches: fit {got} (expected {want}); evaluate "
        f"{got_eval} (expected {want_eval})")
    if got != want or got_eval != want_eval:
        fails.append(f"launches fit {got} / {want}, evaluate {got_eval} / "
                     f"{want_eval}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fails.append(f"losses not finite or not falling: {losses}")
    tokens = cfg["batch"] * cfg["seq"]
    if not (np.isfinite(res["loss"]) and res["tokens"] == tokens
            * cfg["eval_batches"]):
        fails.append(f"evaluate: {res}")
    # the summaries, read back
    got_loss = train_sum.read_scalar("Loss")
    thru = train_sum.read_scalar("Throughput")
    got_val = val_sum.read_scalar("Loss")
    summaries = {
        "loss_steps": [s for s, _, _ in got_loss],
        "loss_equal": [v for _, v, _ in got_loss]
        == [float(np.float32(x)) for x in losses],
        "throughput": [[s, v] for s, v, _ in thru],
        "val_loss": [[s, v] for s, v, _ in got_val],
        "val_perplexity": [[s, v] for s, v, _ in
                           val_sum.read_scalar("Perplexity")]}
    log(f"lm_long summaries: {json.dumps(summaries)}")
    if (summaries["loss_steps"] != list(range(1, steps + 1))
            or not summaries["loss_equal"] or not thru
            or [s for s, _, _ in got_val] != [steps]
            or got_val[0][1] != float(np.float32(res["loss"]))):
        fails.append(f"summaries: {summaries}")
    train_sum.close()
    val_sum.close()
    shutil.rmtree(logs, ignore_errors=True)
    step_ms = float(np.median(step_s)) * 1e3
    flops, flop_parts = _long_flops_per_token(model, cfg["seq"])
    out = {"preset": cfg["preset"], "params": n_params, "leaves": n_leaves,
           "dtype": mcfg.dtype, "remat": mcfg.remat,
           "batch": cfg["batch"], "seq": cfg["seq"],
           "loss_chunk": cfg["chunk"], "steps": steps,
           "timed_steps": cfg["timed"], "losses": losses,
           "step_ms": [x * 1e3 for x in step_s], "step_ms_median": step_ms,
           "tokens_per_s": tokens / (step_ms / 1e3),
           "flops_per_token": flops, "flops_per_token_parts": flop_parts,
           "bf16_peak_share": tokens / (step_ms / 1e3) * flops
           / H100_BF16_FLOPS,
           "peak_mem_gb": peak_gb, "launches": got,
           "eval": res, "eval_launches": got_eval,
           "summaries": summaries, "card": card}
    if cuda:
        out["profile"] = profile_steps(
            lambda: [trainer.step(*batch) for _ in range(1)], steps=1,
            classes=LONG_CLASSES, top=8)
        t_k = time.monotonic()
        out["kernels"] = _long_kernel_times(cfg, trainer, card, fails)
        out["kernels_s"] = time.monotonic() - t_k
    log(f"lm_long main path: {json.dumps(out)}")
    return out


def _lm_recipe_batches():
    rs = np.random.RandomState(29)
    r = LM_RECIPE
    return [_lm_batch(rs, 256, r["batch"], r["seq"])
            for _ in range(r["steps"])]


def lm_durable_child(spec: dict) -> None:
    """One run of ``phase_lm_long`` (e) in a process of its own: the
    recipe's trainer (``tiny``, remat, ``loss_chunk=32``, dropout 0.1,
    seed 3, batch 2 x 64, ``AdamW(fused=True)`` on the card) with
    telemetry and health to a JSONL sink; ``kind`` ``"a"`` (12 steps
    uninterrupted, host syncs counted), ``"b1"`` (checkpoints every 4
    steps, preemptible: the parent sends SIGTERM), ``"b2"`` (resumed
    from b1's checkpoint), ``"c"`` (a NaN batch at step 6 under
    ``policy="rollback"``)."""
    import warnings

    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.observability import JsonlSink, Recorder
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer
    device = spec.get("device", "cuda")
    cuda = device != "cpu"
    if not cuda:
        torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the embedding's backward accumulates rows: its deterministic kernel
    torch.use_deterministic_algorithms(True, warn_only=True)
    r, kind, work = LM_RECIPE, spec["kind"], spec["work"]
    model = T.build(r["preset"], device=device, seed=0, remat=r["remat"],
                    dropout=r["dropout"])
    tr = SpmdTrainer(model, AdamW(learning_rate=r["lr"], fused=cuda),
                     device=device, mesh={"dp": 1, "fsdp": 1}, fsdp=True,
                     min_fsdp_size=1, loss_chunk=r["loss_chunk"],
                     seed=r["seed"])
    # no cost capture: (a) counts the loop's own host syncs
    tr.set_telemetry(Recorder(sinks=[JsonlSink(
        os.path.join(work, f"{kind}.jsonl"))]), health=True,
        capture_cost=False)
    batches = _lm_recipe_batches()
    _await_go(spec)
    if kind in ("b1", "b2", "c"):
        tr.set_checkpoint(spec["ckpt"], every_steps=r["every"],
                          handle_preemption=kind == "b1")
    if kind == "c":
        tr.set_health(policy="rollback", install_crash_hooks=False)
        tok = batches[r["poison_at"] - 1][0].copy()
        tok[0, 0] = 10 ** 6        # out of range: a NaN embedding row
        batches[r["poison_at"] - 1] = (tok, batches[r["poison_at"] - 1][1])
    if kind == "b2":
        tr.load_checkpoint(spec["ckpt"])
    start = tr._step_count

    def feed():
        for i in range(start, r["steps"]):
            if i > start:
                print(f"iter {tr._step_count}", flush=True)
            yield batches[i]
    _build.reset_launch_counts()
    if cuda and kind == "a":
        # switched on before the recording starts: the switch reports
        # itself as a synchronizing call (torch.cuda.set_sync_debug_mode;
        # the 14th sync of ROADMAP C2c), which is not the loop's
        torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            got = tr.fit(feed())
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
    if cuda:
        torch.cuda.synchronize()
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    # where each sync came from (file:line of the call that made it)
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    tr.recorder.flush()
    with open(os.path.join(work, f"{kind}.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps_seen = [rec["step"] for rec in recs if rec.get("type") == "step"]
    mon = tr._health_monitor
    out = {"kind": kind, "start": start, "step_count": tr._step_count,
           "losses": got, "records": steps_seen,
           "launches": _build.launch_counts(),
           "host_syncs": syncs if cuda and kind == "a" else None,
           "host_sync_sites": sites if cuda and kind == "a" else None,
           "rollbacks": None if mon is None else mon.rollbacks}
    arrays = {}
    for n, sub in tr.params.items():
        for k, v in sub.items():
            arrays[f"p{n[n.index('.'):]}.{k}"] = v.detach().cpu().numpy()
    for which in ("m", "v"):
        for n, sub in tr.opt_state[which].items():
            for k, v in sub.items():
                arrays[f"{which}{n[n.index('.'):]}.{k}"] = \
                    v.detach().cpu().numpy()
    np.savez(os.path.join(work, f"{kind}.npz"), **arrays)
    with open(os.path.join(work, f"{kind}.json"), "w") as f:
        json.dump(out, f)
    print("CHILD DONE", flush=True)


def _recipe_kernel_checks(fails):
    """K1 and K2 + K3 against their plain versions at the shapes the
    children of (e) give them (the recipe's batch, heads, sequence and
    head_dim; fp32, causal); K4 at tiny's leaves is phase_adam's."""
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    r, pre = LM_RECIPE, T.PRESETS[LM_RECIPE["preset"]]
    b, h, s = r["batch"], pre["n_heads"], r["seq"]
    d = pre["d_model"] // pre["n_heads"]
    q, k, v = _qkv(b, h, s, s, d, torch.float32, seed=41, layout="main")
    do = _grad_out(q, "main", 42)
    err, lse_err, tol, ok, _ = _compare(fa, q, k, v, True)
    b_err, _, b_tol, b_ok, _ = compare_bwd(fa, q, k, v, do, causal=True)
    out = {"shape": [b, h, s, s, d], "dtype": "float32", "causal": True,
           "fwd_max_abs_err": err, "lse_max_abs_err": lse_err,
           "fwd_tolerance": tol, "bwd_max_abs_err": b_err,
           "bwd_tolerance": b_tol, "ok": ok and b_ok}
    log(f"lm_long (e) kernels at the recipe's shapes: {json.dumps(out)}")
    if not out["ok"]:
        fails.append(f"(e) K1 {ok}, K2+K3 {b_ok} against the plain "
                     f"versions at the recipe's shapes")
    return out


def _lm_durable_leg(device, fails):
    """(e): the recipe's trainer in processes of its own: uninterrupted
    (a), preempted by SIGTERM (b1) and resumed (b2, bitwise a in
    parameters, Adam moments and the resumed losses), and a NaN batch
    rolled back once (c).  All four start at once; b2, set up, waits for
    b1's end."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from bigdl_tpu_torch.checkpoint import scan
    from bigdl_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="lm_durable_", dir=str(_build.BUILD_DIR))
    r = LM_RECIPE
    kernels = _recipe_kernel_checks(fails) if device != "cpu" else None

    go = os.path.join(work, "go_b2")

    def child(kind):
        ckpt = os.path.join(work, "ck_c" if kind == "c" else "ck_b")
        rc, _ = _spawn_child(
            {"name": kind, "kind": kind, "work": work, "ckpt": ckpt,
             "device": device, "wait_for": go if kind == "b2" else None},
            sigterm_at=r["preempt_at"] if kind == "b1" else None,
            flag="--lm-durable-child")
        return kind, rc, ckpt
    try:
        runs, tags = {}, []
        # all four at once; b2, set up, waits for b1's end (and the scan
        # of b1's checkpoints, before b2's retention removes one)
        with ThreadPoolExecutor(4) as pool:
            futs = {k: pool.submit(child, k) for k in ("a", "b1", "c", "b2")}
            try:
                _, rc, ckpt = futs["b1"].result(
                    timeout=DURABLE_CHILD_TIMEOUT + 60)
                if rc == 0:
                    tags = [m.tag for _, m in scan(ckpt)]
            finally:
                open(go, "w").close()
            done = [futs[k].result(timeout=2 * DURABLE_CHILD_TIMEOUT)
                    for k in ("a", "b1", "c", "b2")]
        for kind, rc, ckpt in done:
            if rc != 0:
                fails.append(f"lm child {kind} exited {rc}")
                return {"children": runs, "kernels": kernels}
            with open(os.path.join(work, f"{kind}.json")) as f:
                runs[kind] = json.load(f)
            if kind == "b1":
                runs[kind]["tags"] = tags
        a, b1, b2, c = (runs[k] for k in ("a", "b1", "b2", "c"))
        arr = {k: np.load(os.path.join(work, f"{k}.npz"))
               for k in ("a", "b2")}
        cut = b1["step_count"]
        same = {
            "b1_losses_are_a": b1["losses"] == a["losses"][:cut],
            "b2_resumed_at": b2["start"],
            "b2_losses_are_a": b2["losses"] == a["losses"][cut:],
            "b2_arrays_are_a": sorted(arr["a"].files)
            == sorted(arr["b2"].files) and all(
                np.array_equal(arr["a"][n], arr["b2"][n])
                for n in arr["a"].files),
            "arrays": len(arr["a"].files)}
        for z in arr.values():
            z.close()
        checks = {
            "a_finite": bool(np.all(np.isfinite(a["losses"]))),
            "a_records": a["records"] == list(range(r["steps"])),
            "a_host_syncs": a["host_syncs"],
            "a_host_sync_sites": a.get("host_sync_sites"),
            "preempted_at": cut, "b1_tags": b1["tags"], **same,
            "c_rollbacks": c["rollbacks"], "c_losses": c["losses"],
            "c_records": c["records"], "c_step_count": c["step_count"]}
        log(f"lm_long (e) durability: {json.dumps(checks)}")
        if not (checks["a_finite"] and checks["a_records"]
                and r["preempt_at"] <= cut < r["steps"]
                and f"preempt_step_{cut}" in b1["tags"]
                and b2["start"] == cut and same["b1_losses_are_a"]
                and same["b2_losses_are_a"] and same["b2_arrays_are_a"]):
            fails.append(f"(e) preempt/resume: {checks}")
        c_want = (list(range(r["poison_at"]))
                  + list(range(r["every"], r["steps"] - 2)))
        if not (c["rollbacks"] == 1 and len(c["losses"]) == r["steps"] - 1
                and np.all(np.isfinite(c["losses"]))
                and c["records"] == c_want
                and c["step_count"] == r["steps"] - 2):
            fails.append(f"(e) rollback: {checks}")
        launches = {}
        for run in runs.values():
            for name, n in run["launches"].items():
                launches[name] = launches.get(name, 0) + n
        return {"checks": checks, "launches": launches, "kernels": kernels,
                "children": {k: {kk: v.get(kk) for kk in (
                    "start", "step_count", "launches", "host_syncs",
                    "rollbacks")} for k, v in runs.items()}}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_lm_long(card: str, device: str = "cuda", small: bool = False):
    """The rest of TransformerLM training: (a)–(c) at long8k's widths with
    2 layers, (d) long8k at full depth (remat, bf16 over fp32 params,
    batch 4 × 8192, loss_chunk 1024) through SpmdTrainer.fit and
    evaluate with summaries, (e) durability on the recipe's tiny preset.
    ``device="cpu", small=True`` rehearses it on the CPU at tiny widths
    (no launch counts, times or profile there)."""
    t0 = time.monotonic()
    cfg = LONG_SMALL if small else LONG
    fails = []
    if device != "cpu":
        torch.cuda.empty_cache()
    legs_s = {}
    checks = _long_checks(cfg, device, fails)
    legs_s["a_b_c"] = time.monotonic() - t0
    main = _long_main_path(cfg, device, fails, card)
    legs_s["d"] = time.monotonic() - t0 - legs_s["a_b_c"]
    if device != "cpu":
        torch.cuda.empty_cache()    # the children need the card's memory
    durable = _lm_durable_leg(device, fails)
    legs_s["e"] = time.monotonic() - t0 - legs_s["a_b_c"] - legs_s["d"]
    log(f"lm_long legs: {json.dumps(legs_s)}")
    out = {**main, "checks": checks, "durable": durable, "legs_s": legs_s,
           "phase_s": time.monotonic() - t0}
    if fails:
        raise AssertionError(f"lm_long: {fails}")
    log(f"lm_long phase: {time.monotonic() - t0:.1f} s")
    return out


# --------------------------------------------------------------------- #
# 13. predictor: the inference facade and int8 serving                  #
# --------------------------------------------------------------------- #
# examples/serving_predictor.py at its own widths (its copy: the script
# imports nothing of the reference)
SP_CLASSES = ("alt.atheism", "comp.graphics", "rec.autos")
SP_SEQ, SP_EMB, SP_FILTERS, SP_DOCS = 12, 16, 32, 512
SP_EPOCHS, SP_BATCH, SP_LR = 4, 32, 2e-3
SP_TOPIC_WORDS = (
    "belief religion atheism church god doctrine faith secular",
    "graphics image pixel render shader texture polygon driver",
    "engine car wheel brake gearbox motor exhaust sedan")
SP_NOISE = "the a of and to in for on with is are was this that".split()
SP_ROWS = ("the church doctrine and secular belief",
           "render the texture with a new shader driver",
           "the brake and the gearbox of the sedan",
           "image pixel polygon graphics")
SP_EXPECTED = ("alt.atheism", "comp.graphics", "rec.autos", "comp.graphics")
SP_CPU_TOL = 1e-4            # logits on the card against the CPU, same weights
PRED_INT8_REL = 0.05         # the reference's band, int8 against float logits
PRED_CALIB_BATCHES, PRED_CALIB_BATCH = 2, 8
PRED_TIME_BATCH = 32
PRED_LM_BATCH, PRED_LM_PROMPT, PRED_LM_NEW = 4, 32, 32
PRED_LM_AGREE = 0.8          # greedy tokens agreeing, the reference's 0.8
PRED_LM_LOSS_REL = 5e-3      # int8 against fp32 loss, random weights
# the fine-tune before the greedy check: AdamW steps on the rows until the
# loss is below PRED_LM_FIT_LOSS, at most PRED_LM_FIT_STEPS
PRED_LM_LR, PRED_LM_FIT_LOSS, PRED_LM_FIT_STEPS = 1e-3, 0.1, 150
PRED_WQ_RATIO = 0.5          # int8 bytes / fp32 bytes must stay below
PRED_PROFILE_CLASSES = (("s8", "int8 GEMM"), ("i8", "int8 GEMM"),
                        ("imma", "int8 GEMM"), ("conv", "convolution"),
                        ("gemm", "matmul"), ("copy", "copies (im2col)"),
                        ("elementwise", "elementwise"),
                        ("reduce", "reductions"))


def _sp_corpus(n, rng):
    """``synthesize_corpus`` of examples/serving_predictor.py."""
    docs, labels = [], []
    for _ in range(n):
        label = rng.randint(0, len(SP_CLASSES))
        words = SP_TOPIC_WORDS[label].split()
        body = [words[rng.randint(0, len(words))] if rng.rand() < 0.6
                else SP_NOISE[rng.randint(0, len(SP_NOISE))]
                for _ in range(SP_SEQ)]
        docs.append(" ".join(body))
        labels.append(float(label + 1))
    return docs, np.asarray(labels, np.float32)


def _sp_vectorize(docs, vocab, tok):
    out = np.zeros((len(docs), SP_SEQ), np.float32)
    for i, d in enumerate(docs):
        ids = [vocab.get_index(w) + 1 for w in tok.tokenize(d)][:SP_SEQ]
        out[i, :len(ids)] = ids
    return out


def _sp_model(vocab_size, device):
    from bigdl_tpu_torch import nn
    return nn.Sequential(
        nn.LookupTable(vocab_size + 1, SP_EMB),
        nn.TemporalConvolution(SP_EMB, SP_FILTERS, 3), nn.ReLU(),
        nn.TemporalMaxPooling(SP_SEQ - 2, 1), nn.Squeeze(2),
        nn.Linear(SP_FILTERS, len(SP_CLASSES)), nn.LogSoftMax()).to(device)


def _conv_plain_acc(m, qx):
    """The float64 convolution of the codes ``qx`` with ``m``'s int8
    weight: the accumulator's plain version (exact below 2**53)."""
    import torch.nn.functional as F
    xc = qx.double() if m.format == "NCHW" else \
        qx.double().permute(0, 3, 1, 2)
    (top, bottom), (left, right) = m._pads(tuple(xc.shape[2:4]))
    y = F.conv2d(F.pad(xc, (left, right, top, bottom)), m.qweight.double(),
                 stride=m.stride, dilation=m.dilation, groups=m.n_group)
    return y if m.format == "NCHW" else y.permute(0, 2, 3, 1)


def _acc_checks(qmodel, x, fails):
    """One inference forward of the int8 model on ``x``; each quantized
    convolution's and linear layer's int32 accumulator, on the codes of
    the activation it is given, against its float64 version.  Returns
    the counts checked."""
    from bigdl_tpu_torch import quantized as tq
    targets = [m for m in qmodel.modules()
               if isinstance(m, tq.QuantizedModule)]
    counts = {"conv": 0, "linear": 0}
    for m in targets:
        def wrapped(p, a, ctx, _m=m, _orig=m.apply):
            qx, _ = _m.quantize_input(a)
            acc = _m.accumulate(qx)
            if isinstance(_m, tq.QuantizedSpatialConvolution):
                plain, kind = _conv_plain_acc(_m, qx), "conv"
            else:
                plain, kind = qx.double() @ _m.qweight.double().t(), "linear"
            if acc.dtype != torch.int32 or acc.shape != plain.shape \
                    or not torch.equal(acc.double(), plain):
                fails.append(f"{_m.name}: int32 accumulator differs from "
                             f"its float64 version")
            counts[kind] += 1
            return _orig(p, a, ctx)
        m.apply = wrapped
    try:
        with torch.inference_mode():
            qmodel.run(qmodel.param_dict(), x, state=qmodel.initial_state())
    finally:
        for m in targets:
            m.__dict__.pop("apply", None)
    return counts


def _pred_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _pred_text(device, fails):
    """(a): the example's flow: train (K4), serve float and int8."""
    import concurrent.futures as cf
    import copy
    from bigdl_tpu_torch import quantized as tq
    from bigdl_tpu_torch.data.text import Dictionary, SentenceTokenizer
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import (Adam, LocalOptimizer,
                                       PredictionService, Trigger)

    rng = np.random.RandomState(0)
    docs, labels = _sp_corpus(SP_DOCS, rng)
    tok = SentenceTokenizer()
    vocab = Dictionary([tok.tokenize(d) for d in docs])
    x = _sp_vectorize(docs, vocab, tok)
    torch.manual_seed(0)
    model = _sp_model(vocab.get_vocab_size(), device)
    twin = copy.deepcopy(model)

    def train(m):
        t = time.monotonic()
        (LocalOptimizer(m, (x, labels), ClassNLLCriterion(),
                        batch_size=SP_BATCH, device=device)
         .set_optim_method(Adam(learning_rate=SP_LR, fused=True))
         .set_end_when(Trigger.max_epoch(SP_EPOCHS))).optimize()
        if device != "cpu":
            torch.cuda.synchronize()
        return time.monotonic() - t
    before = _build.launch_counts().get("fused_adam", 0)
    train_s = train(model)
    k4 = _build.launch_counts().get("fused_adam", 0) - before
    want_k4 = SP_EPOCHS * (SP_DOCS // SP_BATCH)      # one launch an update
    if device != "cpu" and k4 != want_k4:
        fails.append(f"text: K4 launched {k4} times, expected {want_k4}")
    train(twin)
    same = all(torch.equal(a, b) for a, b in zip(model.get_weights(),
                                                 twin.get_weights()))
    if not same:
        fails.append("text: two identical training runs ended with other "
                     "weights")
    del twin

    ids = _sp_vectorize(list(SP_ROWS), vocab, tok)
    service = PredictionService(model)
    qmodel = model.quantize(calibration_data=[x[:64]])
    qservice = PredictionService(qmodel)
    try:
        def classify(text, svc=service):
            scores = np.asarray(svc.predict(_sp_vectorize([text], vocab,
                                                          tok)))[0]
            return SP_CLASSES[int(scores.argmax())]
        labels_f = [classify(r) for r in SP_ROWS]
        with cf.ThreadPoolExecutor(4) as pool:
            concurrent = list(pool.map(classify, SP_ROWS))
        correct = sum(a == b for a, b in zip(labels_f, SP_EXPECTED))
        if correct < 3:
            fails.append(f"text: {correct}/4 demo rows right: {labels_f}")
        if concurrent != labels_f:
            fails.append("text: concurrent callers got other labels")
        logits = np.asarray(service.predict(ids))
        cpu = copy.deepcopy(model).to("cpu")
        cpu_err = float(np.abs(logits - cpu.predict(ids)).max())
        if cpu_err > SP_CPU_TOL:
            fails.append(f"text: logits {cpu_err:.3g} from the CPU's")
        labels_q = [classify(r, qservice) for r in SP_ROWS]
        if labels_q != labels_f:
            fails.append(f"text: int8 labels {labels_q} != {labels_f}")
        counts = [_acc_checks(qmodel, torch.from_numpy(a).to(device), fails)
                  for a in (x[:64], ids)]
        checked = sum(c["linear"] for c in counts)
        calibrated = all(m.act_absmax is not None for m in qmodel.modules()
                         if isinstance(m, tq.QuantizedModule))
        if counts != [{"conv": 0, "linear": 1}] * 2 or not calibrated:
            fails.append(f"text: accumulators checked {counts}, "
                         f"calibrated {calibrated}")
        qlogits = np.asarray(qservice.predict(ids))
    finally:
        service.shutdown()
        qservice.shutdown()
    return {"vocab": vocab.get_vocab_size(), "train_s": train_s,
            "leaf_shapes": [tuple(w.shape) for w in model.get_weights()],
            "k4_launches": k4, "labels": labels_f, "demo_correct": correct,
            "int8_labels": labels_q, "cpu_max_abs_err": cpu_err,
            "int8_logit_rel": _pred_rel(qlogits, logits),
            "two_runs_bitwise": same, "linear_acc_checked": checked}


def _pred_resnet(device, small, fails, card):
    """(b): ResNet-50 behind a 2-replica set with the int8 brownout
    entry; accumulators, the band, the brownout route, the canary's
    refresh and times."""
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.serving import CanaryPublisher, build_replica_set
    from bigdl_tpu_torch.serving.registry import owning_copy

    hw, classes = (32, 10) if small else (224, 1000)
    t0 = time.monotonic()
    model = resnet.build(class_num=classes, depth=20 if small else 50,
                         dataset="cifar10" if small else "imagenet",
                         with_logsoftmax=False, device=device, seed=0)
    rs = np.random.RandomState(5)
    calib = [rs.randn(PRED_CALIB_BATCH, 3, hw, hw).astype(np.float32)
             for _ in range(PRED_CALIB_BATCHES)]
    xq = rs.randn(PRED_CALIB_BATCH, 3, hw, hw).astype(np.float32)
    sset = build_replica_set(
        model, 2, name="resnet", input_shape=(3, hw, hw),
        int8_degrade=True, calibration_data=calib, wedge_after=600.0,
        engine_kw=dict(max_batch=PRED_CALIB_BATCH, max_delay_ms=1.0))
    sset.warmup()
    build_s = time.monotonic() - t0
    out = {"build_and_warm_s": build_s}
    try:
        reg0 = sset.replicas[0].engine.registry
        q8 = reg0.get("resnet.int8").model
        counts = _acc_checks(q8, torch.from_numpy(xq).to(device), fails)
        want_convs = 21 if small else 53
        if counts != {"conv": want_convs, "linear": 1}:
            fails.append(f"resnet: accumulators checked {counts}")
        out["acc_checked"] = counts
        y_f = np.asarray(sset.predict("resnet", xq, timeout=600))
        sset.controller.browned = True
        y_8 = np.asarray(sset.predict("resnet", xq, timeout=600))
        sset.controller.browned = False
        out["int8_rel"] = _pred_rel(y_8, y_f)
        if not out["int8_rel"] < PRED_INT8_REL:
            fails.append(f"resnet: int8 logits {out['int8_rel']:.4g} from "
                         f"float, band {PRED_INT8_REL}")
        out["brownout_requests"] = sset.recorder.counter_value(
            "serving/brownout_requests")
        if out["brownout_requests"] < 1:
            fails.append("resnet: the forced brownout served no request")
        # a publish whose classifier is 1.5x: the int8 entry must follow
        fc = [m for m in model.modules() if type(m).__name__ == "Linear"][-1]
        new = owning_copy(reg0.get("resnet").snapshot.params)
        for k in new[fc.name]:
            new[fc.name][k] = new[fc.name][k] * 1.5
        pub = CanaryPublisher(sset, {"resnet": xq[:2]}, drift_rtol=100.0,
                              quiesce_timeout=600.0, validate_timeout=600.0)
        t = time.monotonic()
        snap = pub.publish("resnet", new)
        out["publish_with_refresh_s"] = time.monotonic() - t
        versions = [r.engine.registry.get("resnet.int8").snapshot.version
                    for r in sset.replicas]
        refreshed = sset.recorder.counter_value("serving/degrade_refreshed")
        if versions != [snap.version] * 2 or refreshed != 2 \
                or sset.recorder.counter_value(
                    "serving/degrade_refresh_failures"):
            fails.append(f"resnet: int8 entries {versions} after publishing "
                         f"{snap.version}, refreshed {refreshed}")
        y_f2 = np.asarray(sset.predict("resnet", xq, timeout=600))
        sset.controller.browned = True
        y_82 = [np.asarray(r.engine.predict("resnet.int8", xq, timeout=600))
                for r in sset.replicas]
        sset.controller.browned = False
        out["int8_rel_after_publish"] = max(_pred_rel(y, y_f2) for y in y_82)
        out["int8_moved_rel"] = _pred_rel(y_82[0], y_8)
        if not out["int8_rel_after_publish"] < PRED_INT8_REL \
                or not out["int8_moved_rel"] > 0.2:
            fails.append(f"resnet: after the publish the int8 answer is "
                         f"{out['int8_rel_after_publish']:.4g} from float "
                         f"and moved {out['int8_moved_rel']:.4g}")
        out["versions"] = versions
        q8 = sset.replicas[0].engine.registry.get("resnet.int8").model
        f32 = sset.replicas[0].engine.registry.get("resnet")
    finally:
        sset.shutdown(drain=True)
    # one batch of 32, float against int8, on the same device
    xb = torch.from_numpy(rs.randn(PRED_TIME_BATCH, 3, hw, hw).astype(
        np.float32)).to(device)
    fsnap = f32.snapshot
    qp, qs = q8.param_dict(), q8.initial_state()

    def run_f():
        f32.model.run(fsnap.params, xb, state=fsnap.state)

    def run_q():
        q8.run(qp, xb, state=qs)
    if device != "cpu":
        with torch.inference_mode():
            times = {"float_ms": [], "int8_ms": []}
            for fn, key in ((run_f, "float_ms"), (run_q, "int8_ms"),
                            (run_q, "int8_ms"), (run_f, "float_ms")):
                times[key].append(cuda_ms(fn, iters=5, warm=2))
            for fn, key in ((run_f, "float"), (run_q, "int8")):
                torch.cuda.synchronize()
                start = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                out[f"{key}_peak_gb_above_start_b32"] = (
                    torch.cuda.max_memory_allocated() - start) / 1e9
            out["profile_int8_b32"] = profile_steps(
                run_q, steps=1, classes=PRED_PROFILE_CLASSES, top=8)
            out["profile_float_b32"] = profile_steps(
                run_f, steps=1, classes=PRED_PROFILE_CLASSES, top=4)
        out.update(times)
        log(f"resnet b{PRED_TIME_BATCH}: float {times['float_ms']} ms, "
            f"int8 {times['int8_ms']} ms ({card})")
    return out


def _pred_lm(device, small, fails, card):
    """(c): weight-only int8 for TransformerLM ``generate``.  The loss is
    held on the random weights, with random tokens and targets, as the
    reference's test holds it.  Greedy tokens are held after a fine-tune
    in which the model learns to continue the 4 rows from their prompts:
    random weights leave the top logits within int8's rounding of each
    other, so one flipped argmax would send the rest of a row elsewhere."""
    from bigdl_tpu_torch import quantized as tq
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer

    lm = T.build("tiny" if small else "base", device=device, seed=0)
    params = lm.param_dict()
    rs = np.random.RandomState(7)
    seq = PRED_LM_PROMPT + PRED_LM_NEW

    def ids(n):
        return torch.from_numpy(rs.randint(
            0, lm.cfg.vocab_size, (PRED_LM_BATCH, n))).to(device)

    def deq(p):
        return tq.dequantize_weights(p, torch.float32)
    t = time.monotonic()
    qp = tq.quantize_weights_only(params, min_size=4096)
    quant_s = time.monotonic() - t
    ratio = tq.quantized_bytes(qp) / tq.quantized_bytes(params)
    if not ratio < PRED_WQ_RATIO:
        fails.append(f"lm: int8 bytes ratio {ratio:.4f}")
    tokens, targets = ids(seq), ids(seq)
    with torch.inference_mode():
        loss_fp = float(lm.loss(params, tokens, targets))
        loss_q = float(lm.loss(deq(qp), tokens, targets))
    loss_rel = abs(loss_q - loss_fp) / loss_fp
    if not loss_rel < PRED_LM_LOSS_REL:
        fails.append(f"lm: int8 loss {loss_q} against fp32 {loss_fp}, "
                     f"{loss_rel:.3g} relative (gate {PRED_LM_LOSS_REL})")

    rows = ids(seq + 1)
    trainer = SpmdTrainer(lm, AdamW(learning_rate=PRED_LM_LR, fused=True),
                          device=device)
    fit = []
    t = time.monotonic()
    while len(fit) < PRED_LM_FIT_STEPS \
            and (not fit or fit[-1] > PRED_LM_FIT_LOSS):
        fit.append(float(trainer.step(rows[:, :-1], rows[:, 1:])))
    fit_s = time.monotonic() - t
    params = trainer.params
    del trainer
    qp = tq.quantize_weights_only(params, min_size=4096)
    prompt = rows[:, :PRED_LM_PROMPT]

    def gen(p, transform, n=PRED_LM_NEW):
        """(tokens, seconds, peak GB above what was allocated before)"""
        if device != "cpu":
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        with torch.inference_mode():
            out = lm.generate(p, prompt, n, params_transform=transform)
        if device != "cpu":
            torch.cuda.synchronize()
        dt = time.monotonic() - t
        peak = (torch.cuda.max_memory_allocated() - start) / 1e9 \
            if device != "cpu" else None
        return out, dt, peak
    gen(params, None, 2)                     # warm the shapes
    gen(qp, deq, 2)
    # in turns, fp32 / int8 / int8 / fp32: host-bound steps vary by call
    runs = {"fp32": [], "int8": []}
    for key in ("fp32", "int8", "int8", "fp32"):
        runs[key].append(gen(params, None) if key == "fp32"
                         else gen(qp, deq))
    out_fp, out_q = runs["fp32"][0][0], runs["int8"][0][0]
    # the reference's measure: every token of the rows, prompt and new
    agree = float((out_fp == out_q).float().mean())
    agree_new = float((out_fp[:, PRED_LM_PROMPT:]
                       == out_q[:, PRED_LM_PROMPT:]).float().mean())
    recalled = float((out_fp[:, PRED_LM_PROMPT:]
                      == rows[:, PRED_LM_PROMPT:seq]).float().mean())
    if not agree >= PRED_LM_AGREE:
        fails.append(f"lm: greedy int8 tokens agree {agree:.3f} with fp32's "
                     f"(gate {PRED_LM_AGREE}; {agree_new:.3f} of the new)")
    new_tokens = PRED_LM_BATCH * PRED_LM_NEW
    timed = {key: {"s": [r[1] for r in rs_],
                   "tokens_per_s": [new_tokens / r[1] for r in rs_],
                   "peak_gb_above_start": [r[2] for r in rs_]}
             for key, rs_ in runs.items()}
    res = {"preset": "tiny" if small else "base", "bytes_ratio": ratio,
           "n_layers": lm.cfg.n_layers, "heads": lm.cfg.n_heads,
           "head_dim": lm.cfg.head_dim, "quantize_s": quant_s,
           "loss_fp32_random": loss_fp, "loss_int8_random": loss_q,
           "loss_rel": loss_rel, "fit_steps": len(fit),
           "fit_losses": [fit[0], fit[-1]], "fit_s": fit_s,
           "recalled_fp32": recalled, "agree": agree, "agree_new": agree_new,
           **timed}
    log(f"lm weight-only int8: {json.dumps(res)} ({card})")
    return res


def _pred_kernel_checks(text, lm, fails):
    """The kernels this path launched, against their plain versions at
    its shapes, after its counts were read: K4 bitwise in one launch over
    the text model's leaves (Adam) and the LM's (AdamW); K1 and K2 + K3
    at the LM's (batch, heads, prompt + new, head_dim), fp32 causal, the
    shape of its fine-tune steps and of its two loss calls."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    from bigdl_tpu_torch.optim import Adam, AdamW
    gen = torch.Generator(device="cuda").manual_seed(16)
    out = {}
    for label, method, shapes in (
            ("text", Adam(learning_rate=SP_LR, fused=True),
             [tuple(s) for s in text["leaf_shapes"]]),
            ("lm", AdamW(learning_rate=PRED_LM_LR, fused=True),
             _preset_shapes(lm["preset"]))):
        kw = method.update_scalars(
            {"step": torch.tensor(63, dtype=torch.int32, device="cuda")})
        p0s, g0s, m0s, v0s = ([torch.randn(s, generator=gen, device="cuda")
                               .mul_(scale) for s in shapes]
                              for scale in (0.05, 1e-2, 1e-3, 1e-3))
        v0s = [t.square_() for t in v0s]
        kern, plain, launches = _adam_trees(fo, kw, p0s, g0s, m0s, v0s)
        k4 = {"leaves": len(shapes), "launches": launches,
              "bitwise": all(torch.equal(a, b) for a, b in zip(kern, plain)),
              "max_abs_err": max((a - b).abs().max().item()
                                 for a, b in zip(kern, plain))}
        if not k4["bitwise"] or launches != 1:
            fails.append(f"K4 at the {label} model's leaves: {k4}")
        out[f"K4 fused_adam {label}"] = k4
        del kern, plain, p0s, g0s, m0s, v0s
    s = PRED_LM_PROMPT + PRED_LM_NEW
    shape = (PRED_LM_BATCH, lm["heads"], s, s, lm["head_dim"])
    q, k, v = _qkv(*shape, torch.float32, 16, layout="main")
    do = _grad_out(q, "main", 17)
    err, lse_err, tol, ok, _ = _compare(fa, q, k, v, True)
    b_err, _, b_tol, b_ok, _ = compare_bwd(fa, q, k, v, do, causal=True)
    out["K1-K3 flash"] = {
        "shape": list(shape), "dtype": "float32", "causal": True,
        "fwd_max_abs_err": err, "lse_max_abs_err": lse_err,
        "fwd_tolerance": tol, "bwd_max_abs_err": b_err,
        "bwd_tolerance": b_tol, "ok": ok and b_ok}
    if not ok or not b_ok:
        fails.append(f"K1 {ok}, K2+K3 {b_ok} against the plain versions at "
                     f"the LM's shape {shape}")
    log(f"predictor kernels: {json.dumps(out)}")
    return out


def phase_predictor(card: str, device: str = "cuda", small: bool = False):
    """BigDL's inference facade and int8 serving.  (a) The text classifier
    of examples/serving_predictor.py (SEQ 12, EMB 16, 32 filters, 3
    classes, 512 documents) trained 4 epochs by ``LocalOptimizer`` with
    ``Adam(2e-3, fused=True)`` (K4, one launch an update; a second
    identical run must end bitwise), served through ``PredictionService``
    (the demo rows, 4 concurrent callers, logits against the CPU's) and,
    quantized with calibration, through a second one (the same labels;
    each QuantizedLinear's accumulator bitwise its float64 product).  (b)
    ResNet-50 (ImageNet, 224, 1000 classes, fp32 logits) in a 2-replica
    set with the int8 brownout entry (calibrated on 2 batches of 8):
    every quantized layer's accumulator bitwise its float64 version, int8
    within 0.05 of float, a forced brownout, a canary publish refreshing
    the int8 entry on both replicas, and b32 times.  (c) TransformerLM
    ``base`` weight-only int8: bytes and the loss against fp32 on the
    random weights; then a fine-tune (AdamW, K1-K4) that teaches it 4
    rows, and greedy ``generate`` on the dequantized weights agreeing with
    fp32's, tokens/s and peak memory.  The launches are counted exactly,
    and each kernel is then held against its plain version at this path's
    shapes.  ``device="cpu", small=True`` rehearses it on the CPU
    (ResNet-20 at 32x32, ``tiny``)."""
    from bigdl_tpu_torch.ops import _build
    t0 = time.monotonic()
    fails = []
    if device != "cpu":
        torch.cuda.empty_cache()
    _build.reset_launch_counts()
    legs_s = {}
    t = time.monotonic()
    text = _pred_text(device, fails)
    legs_s["text"] = time.monotonic() - t
    t = time.monotonic()
    res = _pred_resnet(device, small, fails, card)
    legs_s["resnet"] = time.monotonic() - t
    t = time.monotonic()
    lm = _pred_lm(device, small, fails, card)
    legs_s["lm"] = time.monotonic() - t
    launches = _build.launch_counts()
    kernels = {}
    if device != "cpu":
        # the text model's 2 runs, an update each; the LM's fine-tune
        # steps (every layer a forward and a backward) and 2 loss calls
        n, steps = lm["n_layers"], lm["fit_steps"]
        want = {"fused_adam": text["k4_launches"] * 2 + steps,
                "flash_fwd": n * (steps + 2), "flash_bwd_dkv": n * steps,
                "flash_bwd_dq": n * steps}
        got = {name: launches.get(name, 0) for name in want}
        if got != want:
            fails.append(f"launches {got}, expected {want}")
        kernels = _pred_kernel_checks(text, lm, fails)
    out = {"card": card, "text": text, "resnet": res, "lm": lm,
           "launches": launches, "kernel_checks": kernels, "legs_s": legs_s,
           "phase_s": time.monotonic() - t0}
    if fails:
        raise AssertionError(f"predictor: {fails}")
    log(f"predictor phase: {time.monotonic() - t0:.1f} s")
    return out


# --------------------------------------------------------------------- #
# 14. spmd: the composed mesh's path on one card, and K4–K6 on bf16      #
# --------------------------------------------------------------------- #
SPMD_STEPS = 10
SPMD_TEMPLATE = "dp1,fsdp1,tp1,sp1"
# the ring's merge in bf16 against K1, the band tests/test_torch_port_
# spmd.py states for it on the CPU (the bf16 kernel limit of K1 itself)
RING_BF16_TOL = KERNEL_TOL[torch.bfloat16]
SPMD_SMALL = dict(preset="tiny", batch=4, seq=64, long=(1, 2, 256, 64),
                  base_tp2=(2, 1, 64, 64))
SPMD_FULL = dict(preset="base", batch=TRAIN_BATCH, seq=SEQ,
                 long=(1, 4, 8192, 128), base_tp2=(TRAIN_BATCH, 3, SEQ, 128))


def _spmd_main_path(cfg, device, fails):
    """(a): ``base`` through compose.build_trainer over a process group of
    one rank (NCCL on the card), SPMD_STEPS steps counted from 0, then the
    one-device SpmdTrainer from the same weights; both must agree bit for
    bit (every axis of a mesh of one rank has size 1, so no collective
    runs).  Both run with
    deterministic algorithms on: the embedding's backward accumulates
    rows, and its default kernel does not repeat itself."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _spmd_runs(cfg, device, fails)
    finally:
        torch.use_deterministic_algorithms(False)


def _spmd_steps(trainer, tok, tgt, device):
    """SPMD_STEPS steps: (their losses, the host's ms a step over all but
    the first, which also starts NCCL's communicator and the caches)."""
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    losses = [trainer.step(tok, tgt)]
    sync()
    t = time.monotonic()
    losses += [trainer.step(tok, tgt) for _ in range(SPMD_STEPS - 1)]
    sync()
    return losses, (time.monotonic() - t) * 1e3 / (SPMD_STEPS - 1)


def _spmd_runs(cfg, device, fails):
    import tempfile

    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer
    from bigdl_tpu_torch.parallel import mesh as mesh_lib
    from bigdl_tpu_torch.parallel.compose import ComposedConfig, build_trainer

    rs = np.random.RandomState(1)
    vocab = T.PRESETS[cfg["preset"]]["vocab_size"]
    ids = rs.randint(0, vocab, (cfg["batch"], cfg["seq"] + 1)).astype(
        np.int32)
    tok = torch.from_numpy(ids[:, :-1]).to(device)
    tgt = torch.from_numpy(ids[:, 1:]).to(device)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    store = tempfile.mkdtemp(prefix="spmd_", dir=str(_build.BUILD_DIR))
    mesh_lib.init_distributed(f"file://{store}/store", 0, 1, device=device)
    runs = {}
    try:
        model = T.build(cfg["preset"], device=device, seed=0)
        n_layers = model.cfg.n_layers
        tr = build_trainer(model, AdamW(learning_rate=TRAIN_LR, fused=True),
                           ComposedConfig(SPMD_TEMPLATE), device=device)
        tr.init()
        backend = torch.distributed.get_backend()
        log(f"spmd mesh {tr._m} ({backend}), fsdp {tr.fsdp}, ring "
            f"{tr.ring}, zero1 {tr.zero1}")
        if device != "cpu":
            torch.cuda.synchronize()
        _build.reset_launch_counts()
        losses, steady_ms = _spmd_steps(tr, tok, tgt, device)
        host = torch.stack(losses).tolist()
        runs["mesh"] = {"losses": host, "steady_step_ms": steady_ms,
                        "launches": _build.launch_counts()}
        mesh_params = [p.detach().clone() for sub in tr.params.values()
                       for p in sub.values()]
    finally:
        torch.distributed.destroy_process_group()
        mesh_lib.set_mesh(None)
    del tr, model
    model = T.build(cfg["preset"], device=device, seed=0)
    one = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR, fused=True),
                      device=device)
    losses, steady_ms = _spmd_steps(one, tok, tgt, device)
    host1 = torch.stack(losses).tolist()
    runs["one_device"] = {"losses": host1, "steady_step_ms": steady_ms}
    one_params = [p.detach() for sub in one.params.values()
                  for p in sub.values()]
    bitwise = host == host1 and all(torch.equal(a, b) for a, b in
                                    zip(mesh_params, one_params))
    worst = max((a - b).abs().max().item()
                for a, b in zip(mesh_params, one_params))
    runs.update(bitwise=bitwise, params_max_abs_diff=worst,
                backend=backend, n_layers=n_layers, steps=SPMD_STEPS)
    log(f"spmd (a): losses {host[0]:.6f} -> {host[-1]:.6f}; against one "
        f"device bitwise {bitwise} (params max |d| {worst:.3e}); steady "
        f"step {runs['mesh']['steady_step_ms']:.2f} ms on the mesh, "
        f"{runs['one_device']['steady_step_ms']:.2f} ms on one device")
    if not bitwise:
        fails.append(f"(a) the mesh of one rank against one device: "
                     f"losses {host} vs {host1}, params max |d| {worst}")
    if not host[-1] < host[0]:
        fails.append(f"(a) the loss did not fall: {host}")
    if device != "cpu":
        want = {"flash_fwd": n_layers * SPMD_STEPS,
                "flash_bwd_dkv": n_layers * SPMD_STEPS,
                "flash_bwd_dq": n_layers * SPMD_STEPS,
                "fused_adam": SPMD_STEPS}
        got = {k: runs["mesh"]["launches"].get(k, 0) for k in want}
        if got != want or set(runs["mesh"]["launches"]) - set(want):
            fails.append(f"(a) launches {runs['mesh']['launches']}, "
                         f"expected {want}")
    del one, model, mesh_params, one_params
    return runs


def _spmd_attention(fa, shape, dtype, card, fails, what):
    """K1 and K2+K3 at one rank's shapes, each against its plain version,
    with their times and bounds."""
    b, h, s, d = shape
    q, k, v = _qkv(b, h, s, s, d, dtype, seed=41, layout="main")
    do = _grad_out(q, "main", 42)
    err, lse_err, tol, ok, (ref, _) = _compare(fa, q, k, v, True)
    err2, errs, tol2, ok2, _ = compare_bwd(fa, q, k, v, do, causal=True)
    ms, library_ms, _ = bwd_times(fa, q, k, v, do)
    bound, by = attention_bound(b, h, s, s, d, True, dtype)
    bounds = bwd_bounds(b, h, s, s, d, True, dtype)
    out = {"shape": [b, h, s, s, d], "dtype": str(dtype).split(".")[-1],
           "causal": True, "flash_fwd": {
               "max_abs_err": err, "lse_max_abs_err": lse_err,
               "tolerance": tol, "ok": ok,
               "ms": queued_ms(lambda: fa.flash_forward(q, k, v,
                                                        causal=True),
                               iters=10),
               "plain_ms": queued_ms(lambda: fa.flash_forward_plain(
                   q, k, v, causal=True), iters=2, warm=1),
               "library_ms": queued_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       q, k, v, is_causal=True), iters=10),
               "bound_ms": bound, "bound_by": by}}
    for name in BWD_KERNELS:
        out[name] = {"max_abs_err": err2, "errors_and_max_ref": errs,
                     "tolerance": tol2, "ok": ok2, "ms": ms[name],
                     "library_ms_dq_dk_dv": library_ms,
                     "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1]}
    if not (ok and ok2):
        fails.append(f"(b) {what}: K1 {ok}, K2+K3 {ok2} against the plain "
                     f"versions")
    log(f"spmd (b) {what} {shape} {out['dtype']}: K1 err {err:.3e}, K2+K3 "
        f"err {err2:.3e}")
    return out, (q, k, v, ref)


def _local_tree(specs, params, axes, coords, g, device):
    """Random f32 leaves of the local shapes ``specs`` give a rank."""
    from bigdl_tpu_torch.parallel import spmd
    out = {}
    for mod, sub in params.items():
        out[mod] = {}
        for k, p in sub.items():
            b = spmd.block(specs[mod][k], tuple(p.shape), axes, coords)
            shape = tuple(sl.stop - sl.start for sl in b)
            out[mod][k] = torch.randn(shape, generator=g,
                                      device=device) * 1e-2
    return out


def _update_pair(method, plain, trees, kernel):
    """``method.update`` (the kernel) and ``plain.update`` on copies of
    ``trees`` (params, grads): (bitwise, max_abs_err, kernel launches)."""
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.parallel.allreduce import tree_leaves, tree_map
    params, grads = trees
    runs = []
    for m in (method, plain):
        p = tree_map(torch.clone, params)
        st = m.init_state(p)
        st = tree_map(lambda t: t + 1e-3 if t.dim() else t, st)
        before = _build.launch_counts().get(kernel, 0)
        p, st = m.update(grads, p, st)
        if tree_leaves(params)[0].is_cuda:
            torch.cuda.synchronize()
        runs.append((tree_leaves(p) + [t for t in tree_leaves(st)
                                       if t.dim()],
                     _build.launch_counts().get(kernel, 0) - before))
    (got, n), (want, _) = runs
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want) if a.numel())
    return (all(torch.equal(a, b) for a, b in zip(got, want)), err, n)


def _spmd_k4_shards(model, device, fails):
    """(b) K4 over one fsdp=2 rank's and one zero1 dp=2 rank's local
    shards of ``model`` (``base``'s parameters on the meta device),
    bitwise against its plain update."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import spmd
    params = model.param_dict()
    g = torch.Generator(device=device).manual_seed(43)
    out = {}
    fsdp_specs = spmd.param_shardings(model, params, {"fsdp": 2}, True)
    dp_specs = spmd.param_shardings(model, params, {"dp": 2}, False)
    z1 = spmd.zero1_opt_shardings(params, dp_specs, params, {"dp": 2})
    z1_specs = {mod: {k: z1.get((mod, k), dp_specs[mod][k]) for k in sub}
                for mod, sub in params.items()}
    for name, specs, axes in (("fsdp2_rank0", fsdp_specs, {"fsdp": 2}),
                              ("zero1_dp2_rank0", z1_specs, {"dp": 2})):
        coords = {a: 0 for a in axes}
        p = _local_tree(specs, params, axes, coords, g, device)
        gr = _local_tree(specs, params, axes, coords, g, device)
        fused = AdamW(learning_rate=TRAIN_LR, fused=True)
        plain = AdamW(learning_rate=TRAIN_LR)
        bitwise, err, n = _update_pair(fused, plain, (p, gr), fo.KERNEL_NAME)
        n_par = sum(t.numel() for sub in p.values() for t in sub.values())
        out[name] = {"params": n_par, "bitwise": bitwise,
                     "max_abs_err": err, "check_launches": n,
                     "sharded_leaves": sum(
                         any(e for e in specs[mod][k])
                         for mod, sub in params.items() for k in sub)}
        if not (bitwise and n == 1):
            fails.append(f"(b) K4 on {name}'s shards: bitwise {bitwise}, "
                         f"max_abs_err {err}, {n} launch(es)")
    log(f"spmd (b) K4 on local shards: {json.dumps(out)}")
    return out


def _spmd_ring(fa, q, k, v, k1_out, fails):
    """(c) the ring's merge of two chunks in ring order, in one process,
    at long8k's (1, 8, 8192, 128) bf16 causal, against K1's output."""
    from bigdl_tpu_torch.parallel.ring_attention import ring_attention_merge
    t = time.monotonic()
    got = ring_attention_merge(q, k, v, 2, causal=True, block_k=1024)
    torch.cuda.synchronize()
    merge_s = time.monotonic() - t
    err = (got.float() - k1_out.float()).abs().max().item()
    ok = bool(torch.isfinite(got.float()).all().item() and torch.allclose(
        got.float(), k1_out.float(), **RING_BF16_TOL))
    if not ok:
        fails.append(f"(c) ring merge at sp=2 against K1: max |d| {err}")
    log(f"spmd (c) ring merge sp=2 {tuple(q.shape)}: max |d| against K1 "
        f"{err:.3e} (tol {RING_BF16_TOL}), {merge_s:.2f} s")
    return {"shape": list(q.shape), "dtype": "bfloat16", "sp": 2,
            "block_k": 1024, "max_abs_err": err, "tolerance": RING_BF16_TOL,
            "ok": ok, "s": merge_s}


# bf16 leaves beside base's: ragged tails, a gradient one element into its
# storage (the scalar path) and a channels-last conv gradient (read in
# place), as phase_adam and phase_sgd hold the f32 kernels
SPMD_BF16_EXTRA = (("ragged", (4099,), 0, False), ("tail3", (3,), 0, False),
                   ("offset", (1_000_003,), 1, False),
                   ("conv", (64, 3, 7, 7), 0, True))


def _mixed_tree(params, g, device):
    """``base``'s leaf shapes, every other leaf (in order) cast to bf16 (the
    reference test's ``w16`` kind), and the bf16 leaves of
    SPMD_BF16_EXTRA: (params, grads)."""
    p, gr = {}, {}
    i = 0
    for mod, sub in params.items():
        p[mod], gr[mod] = {}, {}
        for k, t in sub.items():
            dt = torch.bfloat16 if i % 2 else torch.float32
            p[mod][k] = torch.randn(t.shape, generator=g,
                                    device=device).to(dt)
            gr[mod][k] = (torch.randn(t.shape, generator=g, device=device)
                          * 1e-2).to(dt)
            i += 1
    p["extra"], gr["extra"] = {}, {}
    for name, shape, offset, channels_last in SPMD_BF16_EXTRA:
        n = int(np.prod(shape))
        p["extra"][name] = torch.randn(shape, generator=g,
                                       device=device).bfloat16()
        flat = torch.randn(n + offset, generator=g, device=device) * 1e-2
        gg = flat.bfloat16()[offset:].view(shape)
        if channels_last:
            gg = gg.contiguous(memory_format=torch.channels_last)
        gr["extra"][name] = gg
    return p, gr


def _spmd_bf16(model, device, card, fails):
    """(d) K4, K5 and K6 over a tree of f32 and bf16 leaves at the leaf
    shapes of ``model`` (``base`` on the meta device), each bitwise
    against its plain version, one launch per dtype, with times beside
    the plain update and the library's."""
    from bigdl_tpu_torch.kernels import fused_optim as fo
    from bigdl_tpu_torch.optim import SGD, AdamW
    from bigdl_tpu_torch.parallel.allreduce import tree_leaves, tree_map
    params = model.param_dict()
    g = torch.Generator(device=device).manual_seed(44)
    p, gr = _mixed_tree(params, g, device)
    leaves = tree_leaves(p)
    nbf = sum(t.numel() for t in leaves if t.dtype == torch.bfloat16)
    nf = sum(t.numel() for t in leaves if t.dtype == torch.float32)
    out = {}
    for name, make, kernel, library, slots in (
            ("fused_adam", lambda f: AdamW(learning_rate=TRAIN_LR,
                                           fused=f),
             fo.KERNEL_NAME, lambda ps: torch.optim.AdamW(
                 ps, lr=TRAIN_LR, fused=True), 7),
            ("fused_sgd_mom", lambda f: SGD(learning_rate=0.1,
                                            momentum=0.9,
                                            weight_decay=1e-4, fused=f),
             fo.SGD_MOM, lambda ps: torch.optim.SGD(
                 ps, lr=0.1, momentum=0.9, weight_decay=1e-4, fused=True),
             5),
            ("fused_sgd_plain", lambda f: SGD(learning_rate=0.1, fused=f),
             fo.SGD_PLAIN, lambda ps: torch.optim.SGD(ps, lr=0.1,
                                                      fused=True), 3)):
        bitwise, err, n = _update_pair(make(True), make(False), (p, gr),
                                       kernel)
        fused, plain = make(True), make(False)
        pk = tree_map(torch.clone, p)
        sk, sp_ = fused.init_state(pk), plain.init_state(pk)
        # bytes: each input read once, each output written once
        nbytes = slots * (4 * nf + 2 * nbf)
        rec = {"leaves": len(leaves), "f32_params": nf, "bf16_params": nbf,
               "bitwise": bitwise, "max_abs_err": err, "tolerance": "bitwise",
               "check_launches": n,
               "ms": queued_ms(lambda: fused.update(gr, pk, sk), iters=5),
               "plain_ms": queued_ms(lambda: plain.update(gr, pk, sp_),
                                     iters=2, warm=1),
               "bound_ms": nbytes / H100_HBM_BYTES_S * 1e3,
               "bound_by": "bytes", "card": card}
        # the library over base's leaves (its fused step takes no
        # strided gradient)
        base_p = {m: sub for m, sub in p.items() if m != "extra"}
        base_g = {m: sub for m, sub in gr.items() if m != "extra"}
        lib_leaves = [t.detach().clone() for t in tree_leaves(base_p)]
        for t, gg in zip(lib_leaves, tree_leaves(base_g)):
            t.grad = gg
        lib = library(lib_leaves)
        rec["library_ms"] = queued_ms(lib.step, iters=5)
        del lib, lib_leaves, pk, sk, sp_
        out[name] = rec
        if not (bitwise and n == 2):
            fails.append(f"(d) {name} on the mixed tree: bitwise {bitwise}, "
                         f"max_abs_err {err}, {n} launch(es) (one per "
                         f"dtype expected)")
    log(f"spmd (d) K4-K6 on f32+bf16 leaves: {json.dumps(out)}")
    return out


def phase_spmd(card: str, device: str = "cuda", small: bool = False):
    """The composed-parallelism path on one card.  (a) ``base`` (d 768, 12
    layers, 6 heads) through ``compose.build_trainer(ComposedConfig(
    "dp1,fsdp1,tp1,sp1"))`` with ``AdamW(fused=True)`` over NCCL at world
    size 1,
    SPMD_STEPS steps at phase_training's batch with K1–K4 launches counted
    from 0, against the one-device SpmdTrainer on the same weights (bit
    for bit).  (b) K1 and K2+K3 at the per-rank shapes of tp=2 (``base``:
    3 heads, S 512, f32; ``long8k``: 1 × 4 × 8192 × 128, bf16, causal), and
    K4 over one fsdp=2 and one zero1 dp=2 rank's local shards of ``base``
    (bitwise), each against its plain version.  (c) The ring's merge at
    sp=2 in one process at long8k's (1, 8, 8192, 128) bf16 causal against
    K1.  (d) K4, K5 and K6 over a tree of f32 and bf16 leaves at ``base``'s
    shapes, bitwise, one launch per dtype.  ``device="cpu", small=True``
    rehearses (a) on the CPU over gloo at ``tiny`` (no kernels there)."""
    t0 = time.monotonic()
    cfg = SPMD_SMALL if small else SPMD_FULL
    fails = []
    legs_s = {}
    main = _spmd_main_path(cfg, device, fails)
    legs_s["a"] = time.monotonic() - t0
    out = {"main": main, "launches": main["mesh"]["launches"]}
    if device != "cpu":
        from bigdl_tpu_torch.models import transformer as T
        from bigdl_tpu_torch.ops import flash_attention_mod as fa
        torch.cuda.empty_cache()
        t = time.monotonic()
        base_tp2, _ = _spmd_attention(fa, cfg["base_tp2"], torch.float32,
                                      card, fails, "base tp=2")
        long_tp2, _ = _spmd_attention(fa, cfg["long"], torch.bfloat16, card,
                                      fails, "long8k tp=2")
        meta = T.build("base", device="meta")
        k4_shards = _spmd_k4_shards(meta, "cuda", fails)
        legs_s["b"] = time.monotonic() - t
        t = time.monotonic()
        b, h, s, d = cfg["long"]
        q, k, v = _qkv(b, 2 * h, s, s, d, torch.bfloat16, seed=45,
                       layout="main")
        k1_out, _ = fa.flash_forward(q, k, v, causal=True)
        ring = _spmd_ring(fa, q, k, v, k1_out, fails)
        del q, k, v, k1_out
        torch.cuda.empty_cache()
        legs_s["c"] = time.monotonic() - t
        t = time.monotonic()
        bf16 = _spmd_bf16(meta, "cuda", card, fails)
        legs_s["d"] = time.monotonic() - t
        out.update(kernels_tp2={"base": base_tp2, "long8k": long_tp2},
                   k4_shards=k4_shards, ring=ring, bf16=bf16)
    out.update(legs_s=legs_s, phase_s=time.monotonic() - t0)
    if fails:
        raise AssertionError(f"spmd: {fails}")
    log(f"spmd phase: {time.monotonic() - t0:.1f} s")
    return out


# --------------------------------------------------------------------- #
# 15. pipeline_moe: the GPipe trainer and MoE over ep on one card        #
# --------------------------------------------------------------------- #
PIPE_STEPS = 6
PIPE_MICRO = 4
# (a) against the one-device SpmdTrainer from the same weights: the
# microbatches sum their gradients in another order; each Adam step moves
# an element by at most about lr, so two runs part by at most 2·lr a step
PIPE_LOSS_ABS = 1e-4
PIPE_PARAM_ABS = 2 * PIPE_STEPS * TRAIN_LR
PIPE_SMALL = dict(preset="tiny", batch=4, seq=64, moe=dict(moe_experts=4,
                                                          moe_top_k=2))
PIPE_FULL = dict(preset="base", batch=TRAIN_BATCH, seq=SEQ,
                 moe=dict(moe_experts=8, moe_top_k=2))


def _pipe_batch(cfg, device):
    from bigdl_tpu_torch.models import transformer as T
    rs = np.random.RandomState(1)
    vocab = T.PRESETS[cfg["preset"]]["vocab_size"]
    ids = rs.randint(0, vocab, (cfg["batch"], cfg["seq"] + 1)).astype(
        np.int32)
    return (torch.from_numpy(ids[:, :-1]).to(device),
            torch.from_numpy(ids[:, 1:]).to(device))


def _set_plain_attention(model, plain: bool):
    from bigdl_tpu_torch.ops import flash_attention_mod as fa
    for blk in model.blocks:
        blk.attn.attention_fn = (lambda q, k, v: fa.flash_attention_plain(
            q, k, v, causal=True)) if plain else None


def _pipe_run(model, w0, mesh, tok, tgt, device, *, plain=False, **kw):
    """PIPE_STEPS steps of PipelineLMTrainer from the weights ``w0``:
    (losses, launches, the host's ms a step after the first, final
    parameters)."""
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel.pipeline import PipelineLMTrainer
    with torch.no_grad():
        for p, w in zip(_leaves(model), w0):
            p.copy_(w)
    _set_plain_attention(model, plain)
    try:
        tr = PipelineLMTrainer(model, AdamW(learning_rate=TRAIN_LR), mesh,
                               n_microbatches=PIPE_MICRO,
                               fused_optim=not plain, device=device, **kw)
        tr.init()
        sync = torch.cuda.synchronize if device != "cpu" else \
            (lambda: None)
        sync()
        _build.reset_launch_counts()
        losses = [tr.step(tok, tgt)]
        sync()
        t = time.monotonic()
        losses += [tr.step(tok, tgt) for _ in range(PIPE_STEPS - 1)]
        sync()
        step_ms = (time.monotonic() - t) * 1e3 / (PIPE_STEPS - 1)
        launches = _build.launch_counts()
    finally:
        _set_plain_attention(model, False)
    return (torch.stack(losses).tolist(), launches, step_ms,
            [p.detach().clone() for p in _leaves(model)])


def _leaves(model):
    return [p for sub in model.param_dict().values() for p in sub.values()]


def _pipeline_leg(cfg, device, fails):
    """(a): ``cfg``'s model through PipelineLMTrainer({"pp": 1},
    PIPE_MICRO microbatches, fused_optim) over a process group of one
    rank, against the one-device SpmdTrainer on the same weights and
    batch; then with overlap_grad_chunks=2 and clip_norm=1.0 against the
    same trainer on the plain attention and plain AdamW."""
    import tempfile

    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer
    from bigdl_tpu_torch.parallel import mesh as mesh_lib

    tok, tgt = _pipe_batch(cfg, device)
    model = T.build(cfg["preset"], device=device, seed=0)
    n_layers = model.cfg.n_layers
    w0 = [p.detach().clone() for p in _leaves(model)]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    store = tempfile.mkdtemp(prefix="pipe_", dir=str(_build.BUILD_DIR))
    mesh_lib.init_distributed(f"file://{store}/store", 0, 1, device=device)
    out = {"n_layers": n_layers, "microbatches": PIPE_MICRO,
           "steps": PIPE_STEPS, "backend": torch.distributed.get_backend()}
    try:
        mesh = mesh_lib.create_mesh({"pp": 1}, device=device)
        losses, launches, step_ms, p_pipe = _pipe_run(model, w0, mesh, tok,
                                                      tgt, device)
        out["main"] = {"losses": losses, "launches": launches,
                       "steady_step_ms": step_ms,
                       "tokens_per_s": tok.numel() / step_ms * 1e3}
        ov, ov_launches, ov_ms, _ = _pipe_run(
            model, w0, mesh, tok, tgt, device, overlap_grad_chunks=2,
            clip_norm=1.0)
        ov_plain, _, ov_plain_ms, _ = _pipe_run(
            model, w0, mesh, tok, tgt, device, plain=True,
            overlap_grad_chunks=2, clip_norm=1.0)
    finally:
        torch.distributed.destroy_process_group()
        mesh_lib.set_mesh(None)
    with torch.no_grad():
        for p, w in zip(_leaves(model), w0):
            p.copy_(w)
    one = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR, fused=True),
                      device=device)
    one_losses, one_ms = _spmd_steps(one, tok, tgt, device)
    one_losses = torch.stack(one_losses).tolist()
    p_one = [p.detach() for p in _leaves(model)]
    loss_gap = max(abs(a - b) for a, b in zip(losses, one_losses))
    param_gap = max((a - b).abs().max().item()
                    for a, b in zip(p_pipe, p_one))
    ov_gap = max(abs(a - b) for a, b in zip(ov, ov_plain))
    out.update(one_device_losses=one_losses, one_device_step_ms=one_ms,
               loss_max_abs_gap=loss_gap,
               param_max_abs_gap=param_gap,
               bands={"loss": PIPE_LOSS_ABS, "param": PIPE_PARAM_ABS},
               overlap_clip={"losses": ov, "plain_losses": ov_plain,
                             "loss_max_abs_gap": ov_gap,
                             "tolerance": LOSS_TOL, "launches": ov_launches,
                             "steady_step_ms": ov_ms,
                             "plain_steady_step_ms": ov_plain_ms})
    log(f"pipeline (a): losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"against one device: loss gap {loss_gap:.3e} (band "
        f"{PIPE_LOSS_ABS}), params max |d| {param_gap:.3e} (band "
        f"{PIPE_PARAM_ABS}); overlap+clip against plain: {ov_gap:.3e} "
        f"(tol {LOSS_TOL}); steady step {step_ms:.2f} ms, one device "
        f"{one_ms:.2f} ms")
    if loss_gap > PIPE_LOSS_ABS or param_gap > PIPE_PARAM_ABS:
        fails.append(f"(a) against one device: loss gap {loss_gap}, "
                     f"params {param_gap}")
    if ov_gap > LOSS_TOL:
        fails.append(f"(a) overlap+clip against plain: {ov} vs {ov_plain}")
    if not losses[-1] < losses[0]:
        fails.append(f"(a) the loss did not fall: {losses}")
    if device != "cpu":
        want = {"flash_fwd": n_layers * PIPE_MICRO * PIPE_STEPS,
                "flash_bwd_dkv": n_layers * PIPE_MICRO * PIPE_STEPS,
                "flash_bwd_dq": n_layers * PIPE_MICRO * PIPE_STEPS,
                "fused_adam": PIPE_STEPS}
        for what, got in (("main", launches), ("overlap", ov_launches)):
            if got != want:
                fails.append(f"(a) {what} launches {got}, expected {want}")
    del one, model, w0, p_pipe, p_one
    return out


class _Routing:
    """The routing choices of a model's SwitchFFN blocks, recorded or
    replayed: while a block's ``apply`` runs, ``torch.argmax`` (called
    there only by the top-k loop, once a k) is wrapped so that each call's
    indices are kept (``record``) or replaced by those a recorded run took
    at the same step, block and k (``replay``), so that a run on the plain
    versions can route as the kernels' run routed.  ``picks[step]`` lists
    every call's indices in order."""

    def __init__(self, model, replay=None):
        self.picks, self._replay = [], replay
        self._model, self._saved = model, []

    def __enter__(self):
        real = torch.argmax
        for blk in self._model.blocks:
            ffn, orig = blk.mlp, blk.mlp.apply

            def apply(params, x, ctx, orig=orig):
                step = self.picks[-1]
                given = None if self._replay is None else \
                    iter(self._replay[len(self.picks) - 1][len(step):])

                def argmax(t, dim=None, keepdim=False):
                    idx = real(t, dim=dim, keepdim=keepdim) if given is None \
                        else next(given)
                    step.append(idx)
                    return idx
                torch.argmax = argmax
                try:
                    return orig(params, x, ctx)
                finally:
                    torch.argmax = real
            ffn.apply = apply
            self._saved.append(ffn)
        return self

    def next_step(self):
        self.picks.append([])

    def __exit__(self, *exc):
        for ffn in self._saved:
            del ffn.apply
        return False


def _topk_sets(step_picks, top_k):
    """A step's recorded argmax calls as each block's sorted top-k sets."""
    return [torch.sort(torch.stack(step_picks[i:i + top_k], dim=-1),
                       dim=-1).values
            for i in range(0, len(step_picks), top_k)]


def _moe_run(model, w0, tok, tgt, device, plain, replay=None):
    """PIPE_STEPS SpmdTrainer steps of the MoE model from ``w0`` (kernels,
    or the plain attention and plain AdamW; ``replay``: route as that
    recorded run did): losses, launches, the host's ms a step after the
    first, peak memory, and the routing's record."""
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer
    with torch.no_grad():
        for p, w in zip(_leaves(model), w0):
            p.copy_(w)
    _set_plain_attention(model, plain)
    try:
        with _Routing(model, replay) as routing:
            tr = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR,
                                          fused=not plain), device=device)
            sync = torch.cuda.synchronize if device != "cpu" else \
                (lambda: None)
            if device != "cpu":
                torch.cuda.reset_peak_memory_stats()
            sync()
            _build.reset_launch_counts()
            routing.next_step()
            losses = [tr.step(tok, tgt)]
            sync()
            t = time.monotonic()
            for _ in range(PIPE_STEPS - 1):
                routing.next_step()
                losses.append(tr.step(tok, tgt))
            sync()
            step_ms = (time.monotonic() - t) * 1e3 / (PIPE_STEPS - 1)
            launches = _build.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
                if device != "cpu" else None
    finally:
        _set_plain_attention(model, False)
    return (torch.stack(losses).tolist(), launches, step_ms, peak,
            routing.picks)


def _moe_step1_grads(model, w0, tok, tgt, plain, replay=None):
    """Step 1's loss (CE + aux), its CE alone, every leaf's gradient and
    the routing's record, on the kernels or the plain attention
    (``replay``: routed as that record)."""
    from bigdl_tpu_torch.nn.module import Ctx
    with torch.no_grad():
        for p, w in zip(_leaves(model), w0):
            p.copy_(w)
    _set_plain_attention(model, plain)
    try:
        with _Routing(model, replay) as routing:
            routing.next_step()
            params = model.param_dict()
            ctx = Ctx(state={}, training=True)
            ce = model.loss(params, tok, tgt, ctx=ctx)
            loss = ce + sum(ctx.side_losses)
            grads = torch.autograd.grad(loss, _leaves(model))
    finally:
        _set_plain_attention(model, False)
    return loss.item(), ce.item(), grads, routing.picks


def _moe_leg(cfg, device, fails):
    """(b): ``cfg``'s model with MoE blocks through the one-device
    SpmdTrainer with AdamW(fused=True), against the same run on the plain
    attention and plain AdamW: routed freely (step 1's loss held; each
    step's top-k flips and loss gaps reported), and routed as the kernels'
    run routed (step 1's gradients and every step's loss held)."""
    from bigdl_tpu_torch.models import transformer as T
    tok, tgt = _pipe_batch(cfg, device)
    t = time.monotonic()
    model = T.build(cfg["preset"], device=device, seed=0, **cfg["moe"])
    n_layers, top_k = model.cfg.n_layers, model.cfg.moe_top_k
    n_params = sum(p.numel() for p in _leaves(model))
    w0 = [p.detach().clone() for p in _leaves(model)]
    build_s = time.monotonic() - t
    loss_k, ce_k, g_k, r1 = _moe_step1_grads(model, w0, tok, tgt, False)
    loss_p, _, g_p, _ = _moe_step1_grads(model, w0, tok, tgt, True, r1)
    names = [f"{mod}.{k}" for mod, sub in model.param_dict().items()
             for k in sub]
    worst, worst_leaf = 0.0, None
    for name, a, b in zip(names, g_k, g_p):
        rel = ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
        if rel > worst:
            worst, worst_leaf = rel, name
    del g_k, g_p
    losses, launches, step_ms, peak, rec_k = _moe_run(model, w0, tok, tgt,
                                                      device, plain=False)
    free, _, plain_ms, _, rec_p = _moe_run(model, w0, tok, tgt, device,
                                           plain=True)
    pinned, _, _, _, _ = _moe_run(model, w0, tok, tgt, device, plain=True,
                                  replay=rec_k)
    flips = [sum(int((a != b).any(dim=-1).sum()) for a, b in
                 zip(_topk_sets(sk, top_k), _topk_sets(sp, top_k)))
             for sk, sp in zip(rec_k, rec_p)]
    free_gaps = [abs(a - b) for a, b in zip(losses, free)]
    pinned_gaps = [abs(a - b) for a, b in zip(losses, pinned)]
    n_tok = tok.numel()
    out = {"n_layers": n_layers, "params": n_params,
           "experts": model.cfg.moe_experts, "top_k": top_k,
           "capacity_factor": model.cfg.moe_capacity_factor,
           "build_s": build_s, "losses": losses,
           "free_plain_losses": free, "free_loss_abs_gaps": free_gaps,
           "topk_flips_per_step": flips,
           "pinned_plain_losses": pinned,
           "pinned_loss_abs_gaps": pinned_gaps,
           "step1": {"loss": loss_k, "pinned_plain_loss": loss_p,
                     "ce": ce_k, "aux": loss_k - ce_k,
                     "grad_worst_rel": worst, "grad_worst_leaf": worst_leaf},
           "tolerances": {"loss": LOSS_TOL, "grad_rel": GRAD_REL_TOL},
           "launches": launches, "steady_step_ms": step_ms,
           "plain_steady_step_ms": plain_ms,
           "tokens_per_s": n_tok / step_ms * 1e3, "peak_gb": peak}
    log(f"moe (b): {n_params} params, {n_layers} layers; losses "
        f"{losses[0]:.6f} -> {losses[-1]:.6f}; step 1 CE {ce_k:.6f} + aux "
        f"{loss_k - ce_k:.3e}; routed freely: top-k flips a step {flips}, "
        f"loss gaps {[f'{g:.2e}' for g in free_gaps]}; routed as the "
        f"kernels: step-1 grads worst {worst_leaf} {worst:.3e} (tol "
        f"{GRAD_REL_TOL}), loss gaps max {max(pinned_gaps):.3e} (tol "
        f"{LOSS_TOL}); step {step_ms:.1f} ms, {n_tok / step_ms * 1e3:.0f} "
        f"tokens/s, peak {peak} GB")
    if free_gaps[0] > LOSS_TOL:
        fails.append(f"(b) step-1 loss {losses[0]} against plain {free[0]}")
    if worst > GRAD_REL_TOL:
        fails.append(f"(b) step-1 gradients routed alike: {worst_leaf} "
                     f"{worst}")
    if max(pinned_gaps) > LOSS_TOL:
        fails.append(f"(b) losses routed alike: gaps {pinned_gaps}")
    if not (loss_k > ce_k and abs(losses[0] - loss_k) <= LOSS_TOL):
        fails.append(f"(b) the step loss {losses[0]} is not CE {ce_k} + "
                     f"the aux term ({loss_k})")
    if not losses[-1] < losses[0]:
        fails.append(f"(b) the loss did not fall: {losses}")
    if device != "cpu":
        want = {"flash_fwd": n_layers * PIPE_STEPS,
                "flash_bwd_dkv": n_layers * PIPE_STEPS,
                "flash_bwd_dq": n_layers * PIPE_STEPS,
                "fused_adam": PIPE_STEPS}
        if launches != want:
            fails.append(f"(b) launches {launches}, expected {want}")
    if device != "cpu":
        out["layer_forward_ms"] = _moe_layer_times(model, n_tok)
        log(f"moe (b) one layer's forward by part: "
            f"{out['layer_forward_ms']}")
    del model, w0
    return out


def _moe_layer_times(model, n_tok):
    """One SwitchFFN layer's forward products at the run's shapes, by CUDA
    events: the dense dispatch ``(N, E, C) × (N, D)``, the three expert
    products and the dense combine (their values do not change the
    work)."""
    ffn = model.blocks[0].mlp
    p = ffn.own(model.param_dict())
    e, c = ffn.n_experts, ffn._capacity(n_tok)
    g = torch.Generator(device="cuda").manual_seed(5)
    slot = (torch.rand((n_tok, e, c), generator=g, device="cuda")
            < 1.0 / c).float()
    x = torch.randn((n_tok, ffn.d_model), generator=g, device="cuda")
    xe = torch.einsum("nec,nd->ecd", slot, x)
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xe, p["w1"]))
    ye = torch.einsum("ecf,efd->ecd", h, p["w2"])
    with torch.no_grad():
        parts = {
            "dispatch": cuda_ms(lambda: torch.einsum("nec,nd->ecd", slot,
                                                     x), iters=10),
            "experts": cuda_ms(lambda: torch.einsum(
                "ecf,efd->ecd", torch.nn.functional.silu(torch.einsum(
                    "ecd,edf->ecf", xe, p["w1"])) * torch.einsum(
                    "ecd,edf->ecf", xe, p["w3"]), p["w2"]), iters=10),
            "combine": cuda_ms(lambda: torch.einsum("nec,ecd->nd", slot,
                                                    ye), iters=10)}
    parts["dense_share"] = (parts["dispatch"] + parts["combine"]) / sum(
        parts[k] for k in ("dispatch", "experts", "combine"))
    parts["capacity"] = c
    del slot, x, xe, h, ye
    return parts


def phase_pipeline_moe(card: str, device: str = "cuda", small: bool = False):
    """The pipeline engine and MoE on one card.  (a) ``base`` (d 768, 12
    layers, 6 heads, vocab 32000, f32) through ``PipelineLMTrainer(mesh=
    {"pp": 1}, n_microbatches=4, fused_optim=True)`` with AdamW over NCCL
    at world size 1, PIPE_STEPS steps at phase_training's batch with
    launches counted from 0 (K1–K3 once a block a microbatch, K4 once a
    step), against the one-device SpmdTrainer (bands PIPE_*), and again
    with overlap_grad_chunks=2 and clip_norm=1.0 against the same trainer
    on the plain attention and plain AdamW (LOSS_TOL a step).  (b)
    ``base`` with 8 experts, top-2, capacity 1.25 through the one-device
    SpmdTrainer with AdamW(fused=True), against the plain run routed
    freely (step 1's loss within LOSS_TOL; each step's top-k flips and
    loss gap reported) and routed as the kernels' run routed (step 1's
    gradients within GRAD_REL_TOL a leaf, every step's loss within
    LOSS_TOL), the aux term in the loss, the step time, tokens/s and peak
    memory.
    ``device="cpu", small=True`` rehearses both at ``tiny`` over gloo."""
    t0 = time.monotonic()
    cfg = PIPE_SMALL if small else PIPE_FULL
    fails = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        pipe = _pipeline_leg(cfg, device, fails)
        legs_s = {"a": time.monotonic() - t0}
        if device != "cpu":
            torch.cuda.empty_cache()
        t = time.monotonic()
        moe = _moe_leg(cfg, device, fails)
        legs_s["b"] = time.monotonic() - t
    finally:
        torch.use_deterministic_algorithms(False)
    if device != "cpu":
        torch.cuda.empty_cache()
    out = {"pipeline": pipe, "moe": moe, "legs_s": legs_s,
           "launches": {"pipeline": pipe["main"]["launches"],
                        "moe": moe["launches"]},
           "phase_s": time.monotonic() - t0}
    if fails:
        raise AssertionError(f"pipeline_moe: {fails}")
    log(f"pipeline_moe phase: {time.monotonic() - t0:.1f} s")
    return out


# --------------------------------------------------------------------- #
# phase_data_elastic: the sharded data plane, module files, the elastic  #
# supervisor                                                            #
# --------------------------------------------------------------------- #
# (a)/(b)/(c) at TransformerLM base: 16 TFRecord shards x 512 records of
# 513 int32 tokens (an int32 record id in front), 4 workers, staging 2;
# (d) LeNet-5 over fixed-length records.
DE = dict(preset="base", layers=4, batch=8, seq=512, shards=16,
          per_shard=512, workers=4, staging=2, steps=8, every=8,
          preempt_after=5,
          lr=3e-4, requests=8, lenet_files=4, lenet_per_file=256,
          lenet_batch=32, lenet_steps=16, lenet_every=4, lenet_preempt=6,
          pipeline_batches=64)
DE_SMALL = dict(DE, preset="tiny", layers=None, seq=64, shards=4,
                per_shard=24, workers=2, lenet_per_file=64, lenet_batch=8,
                pipeline_batches=16)
LENET_IMG = 28 * 28


def _de_cfg(small):
    return DE_SMALL if small else DE


def _de_shards(work, cfg, vocab):
    """The phase's TFRecord shards, from a numpy seed."""
    from bigdl_tpu_torch.utils.tfrecord import write_tfrecords
    rs = np.random.RandomState(19)
    paths, gid = [], 0
    for f in range(cfg["shards"]):
        toks = rs.randint(0, vocab, (cfg["per_shard"], cfg["seq"] + 1)) \
            .astype(np.int32)
        recs = []
        for row in toks:
            recs.append(np.int32(gid).tobytes() + row.tobytes())
            gid += 1
        p = os.path.join(work, f"shard{f:02d}.tfr")
        write_tfrecords(p, recs)
        paths.append(p)
    return paths


def _de_decode(b):
    t = np.frombuffer(b, np.int32)
    return t[1:-1], t[2:], int(t[0])


def _de_collate(samples):
    xs, ys, ids = zip(*samples)
    return np.stack(xs), np.stack(ys), np.array(ids)


def _de_dataset(paths, cfg, device, recorder=None):
    """The pipeline: workers decode, the stager copies each batch to the
    card (``HostToDevice``: pinned buffers, a side stream, one event a
    batch); the record ids ride beside, on the host."""
    from bigdl_tpu_torch.data.device_loader import HostToDevice
    from bigdl_tpu_torch.data.sharded import ShardedRecordDataSet
    h2d = HostToDevice(device, cfg["staging"] + 1)

    def place(batch):
        x, y, ids = batch
        return h2d((x, y)), ids
    return ShardedRecordDataSet(
        paths, "tfrecord", _de_decode, batch_size=cfg["batch"],
        n_workers=cfg["workers"], staging_depth=cfg["staging"], seed=7,
        collate=_de_collate, place_fn=place, recorder=recorder)


def _de_feed(ds, ids_log, events, sigterm_after=None):
    """``fit``'s feed: each batch taken on this thread (the stream waits
    on its copy), its record ids logged and an event recorded as the
    trainer pulls it; with ``sigterm_after``, SIGTERM to this process as
    that batch is pulled (the step still runs, then fit stops)."""
    import signal
    for staged, ids in ds.stream():
        x, y = staged.take()
        ids_log.append([int(i) for i in ids])
        if events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        if sigterm_after is not None and len(ids_log) == sigterm_after:
            signal.raise_signal(signal.SIGTERM)
        yield x, y


def _de_trainer(cfg, device, n_layers=None, mesh=None):
    """The phase's trainer: ``cfg``'s preset at ``n_layers`` (default
    ``cfg["layers"]``; None: the preset's depth)."""
    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer
    n_layers = cfg["layers"] if n_layers is None else n_layers
    kw = {} if n_layers is None else {"n_layers": n_layers}
    model = T.build(cfg["preset"], device=device, seed=0, **kw)
    return SpmdTrainer(model, AdamW(learning_rate=cfg["lr"],
                                    fused=str(device) != "cpu"),
                       mesh=mesh, device=device)


def _params_digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _digest(arr) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _de_serve(model, cfg, vocab, device):
    """8 requests of one row each through ServingEngine, one at a time
    (the same batches in any run): the logits, the K1 launches and the
    wall time."""
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.serving import ModelRegistry, ServingEngine
    rs = np.random.RandomState(23)
    xs = [rs.randint(0, vocab, (1, cfg["seq"])).astype(np.int32)
          for _ in range(cfg["requests"])]
    reg = ModelRegistry()
    reg.register("lm", model, input_shape=(cfg["seq"],), dtype=np.int32)
    eng = ServingEngine(reg, max_batch=8)
    try:
        eng.warmup()
        _build.reset_launch_counts()
        t = time.monotonic()
        out = [np.asarray(eng.submit("lm", x).result(timeout=300))
               for x in xs]
        wall = time.monotonic() - t
        launches = _build.launch_counts()
    finally:
        eng.shutdown(drain=True)
    return np.stack(out), launches, wall


def _de_step_ms(events):
    """Device ms between consecutive pulls (each is one step on the
    card's timeline, a wait for the host included); the first step
    (warm-up) is left out."""
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(events[1:-1], events[2:])]
    return float(np.median(ms)) if ms else float("nan"), ms


def data_elastic_child(spec: dict) -> None:
    """One run of ``phase_data_elastic`` in a process of its own: the
    uninterrupted run (a), the run preempted after step 5 (b1), its
    resume (b2), or the module file loaded and served (load)."""
    from bigdl_tpu_torch.observability import Recorder
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.utils import serializer
    device, kind, work = spec["device"], spec["kind"], spec["work"]
    cfg = _de_cfg(spec["small"])
    cuda = device != "cpu"
    _durable_setup(device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {"kind": kind}
    vocab = spec["vocab"]
    if kind == "load":
        t = time.monotonic()
        model = serializer.load_module(spec["module"], device=device)
        if cuda:
            torch.cuda.synchronize()
        out["load_s"] = time.monotonic() - t
        logits, launches, wall = _de_serve(model, cfg, vocab, device)
        out.update(logits=_digest(logits), logits_shape=logits.shape,
                   topology=serializer.topology_dict(model),
                   serve_launches=launches, serve_s=wall)
    else:
        rec = Recorder()
        tr = _de_trainer(cfg, device)
        ds = _de_dataset(spec["paths"], cfg, device, rec)
        tr.set_data_pipeline(ds)
        _await_go(spec)
        tr.set_checkpoint(spec["ckpt"], every_steps=cfg["every"], keep=2,
                          handle_preemption=kind == "b1")
        if kind == "b2":
            tr.load_checkpoint(spec["ckpt"])
        start = tr._step_count
        ids, events = [], [] if cuda else None
        _build.reset_launch_counts()
        t = time.monotonic()
        losses = tr.fit(_de_feed(ds, ids, events,
                                 cfg["preempt_after"] if kind == "b1"
                                 else None), steps=cfg["steps"] - start)
        if cuda:
            torch.cuda.synchronize()
        out.update(start=start, step_count=tr._step_count, losses=losses,
                   ids=ids, fit_s=time.monotonic() - t,
                   launches=_build.launch_counts(),
                   stall_s=rec.counter_value("data/input_stall_seconds"),
                   digest=_params_digest(tr.model))
        if cuda:
            out["step_ms_median"], out["step_ms"] = _de_step_ms(events)
        if kind == "a":
            if cuda:
                out["memory"] = _de_memory_run(cfg, device, spec["paths"])
                out["profile"] = _de_pipeline_profile(cfg, device,
                                                      spec["paths"])
            # the timed part is over: the parent starts b1 beside the rest
            print("A TRAINED", flush=True)
            logits, launches, wall = _de_serve(tr.model, cfg, vocab, device)
            out.update(logits=_digest(logits), logits_shape=logits.shape,
                       logits_finite=bool(np.isfinite(logits).all()))
            t = time.monotonic()
            serializer.save_module(tr.model, spec["module"])
            out.update(save_s=time.monotonic() - t,
                       module_mb=os.path.getsize(spec["module"]) / 1e6,
                       topology=serializer.topology_dict(tr.model),
                       serve_launches=launches, serve_s=wall)
    with open(os.path.join(work, f"{kind}.json"), "w") as f:
        json.dump(out, f)
    print("CHILD DONE", flush=True)


def _de_memory_run(cfg, device, paths):
    """The same trainer fed from memory: the first ``steps`` batches of
    the same stream, already on the card; device ms a step as above."""
    from bigdl_tpu_torch.data.sharded import ShardedRecordDataSet
    host = ShardedRecordDataSet(paths, "tfrecord", _de_decode,
                                batch_size=cfg["batch"],
                                n_workers=cfg["workers"], seed=7,
                                collate=_de_collate)
    batches = []
    for x, y, _ in host.stream():
        batches.append((torch.as_tensor(x, device=device),
                        torch.as_tensor(y, device=device)))
        if len(batches) == cfg["steps"]:
            break
    tr = _de_trainer(cfg, device)
    events = []

    def feed():
        for b in batches:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            yield b
    tr.fit(feed())
    med, ms = _de_step_ms(events)
    return {"step_ms_median": med, "step_ms": ms}


def _de_pipeline_profile(cfg, device, paths, warm=1, steps=2):
    """The device's busy share (torch.profiler) over ``steps`` steps of a
    fresh trainer fed by the pipeline, after ``warm`` steps."""
    import itertools
    tr = _de_trainer(cfg, device)
    feed = _de_feed(_de_dataset(paths, cfg, device), [], None)
    try:
        tr.fit(itertools.islice(feed, warm))
        return profile_steps(lambda: tr.fit(itertools.islice(feed, steps)),
                             steps=steps)
    finally:
        feed.close()


def _de_pipeline_alone(paths, cfg, device):
    """The pipeline's records/s with nothing consuming but the drain."""
    ds = _de_dataset(paths, cfg, device)
    n, t = 0, time.monotonic()
    for staged, ids in ds.stream():
        staged.take()
        n += len(ids)
        if n >= cfg["pipeline_batches"] * cfg["batch"]:
            break
    if str(device) != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t
    return {"records": n, "wall_s": wall, "records_per_s": n / wall}


def _de_elastic_factory(mesh):
    """(c)'s trainer on the supervisor's mesh: ``base`` widths, depth
    ``DE_ELASTIC_LAYERS`` (module-level: each rank imports it)."""
    cfg = _de_cfg(mesh.device.type == "cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    if mesh.device.type == "cpu":
        torch.set_num_threads(1)
    return _de_trainer(cfg, mesh.device, n_layers=DE_ELASTIC_LAYERS,
                       mesh=mesh)


DE_ELASTIC_LAYERS = 4


def _warm_forkserver():
    """Start the elastic supervisor's forkserver now, with the modules it
    preloads, so that its imports overlap child a's start rather than
    (c): the supervisor finds it running."""
    import multiprocessing
    from multiprocessing import forkserver

    from bigdl_tpu_torch.elastic import supervisor
    multiprocessing.get_context("forkserver").set_forkserver_preload(
        ["torch", supervisor.__name__, "bigdl_tpu_torch.parallel.spmd",
         _de_elastic_factory.__module__])
    forkserver.ensure_running()


def _de_elastic(work, cfg, vocab, device, fails):
    """(c) ``ElasticSupervisor`` at world size 1, SIGTERM after step 4 (a
    final checkpoint, replan ``{"dp": 1}``, resume): losses bitwise the
    same trainer run uninterrupted here on one device (a mesh of one
    rank over NCCL is bitwise one device, as ``phase_spmd`` holds), the
    ``elastic/*`` counters as the reference's, and on the card the
    ranks' launches K1 = K2 = K3 = layers x steps and K4 = 1 a step."""
    import signal

    from bigdl_tpu_torch.elastic import ElasticSupervisor
    from bigdl_tpu_torch.observability import InMemorySink, Recorder
    rs = np.random.RandomState(31)
    data = [rs.randint(0, vocab, (cfg["batch"], cfg["seq"] + 1))
            .astype(np.int32) for _ in range(cfg["steps"])]

    def batch(s):
        return data[s][:, :-1], data[s][:, 1:]

    def run(name, sigterm_at=None):
        rec = Recorder(sinks=[InMemorySink()])
        fired = []

        def batch_fn(s):
            if s == sigterm_at and not fired:
                fired.append(s)
                signal.raise_signal(signal.SIGTERM)
            return batch(s)
        sup = ElasticSupervisor(
            _de_elastic_factory, os.path.join(work, f"elastic_{name}"),
            {"dp": 1}, capacity_fn=lambda: 1, recorder=rec,
            ckpt_every=cfg["steps"], replan_every=0, handle_sigterm=True,
            device=device)
        t = time.monotonic()
        losses = sup.run(batch_fn, steps=cfg["steps"])
        return losses, rec, time.monotonic() - t, sup.kernel_launches

    t = time.monotonic()
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        tr = _de_trainer(cfg, device, n_layers=DE_ELASTIC_LAYERS)
        base = tr.fit(batch(s) for s in range(cfg["steps"]))
        del tr
    finally:
        torch.use_deterministic_algorithms(prev)
    base_s = time.monotonic() - t
    got, rec, got_s, launches = run("preempted",
                                    sigterm_at=cfg["preempt_after"] - 1)
    kinds = [r["kind"] for r in rec.recent_records()
             if r.get("type") == "elastic_event"]
    counters = {k: rec.counter_value(k) for k in (
        "elastic/preemptions", "elastic/resumes", "elastic/shrinks",
        "elastic/regrows", "elastic/failures", "elastic/reshards")}
    out = {"layers": DE_ELASTIC_LAYERS, "uninterrupted_s": base_s,
           "preempted_s": got_s, "losses_bitwise": got == base,
           "events": kinds, "counters": counters, "losses": got,
           "launches": launches}
    if device != "cpu":
        # the ranks' launches: every step of both segments on K1–K4
        per_layer = DE_ELASTIC_LAYERS * cfg["steps"]
        want = {"flash_fwd": per_layer, "flash_bwd_dkv": per_layer,
                "flash_bwd_dq": per_layer, "fused_adam": cfg["steps"]}
        out["launches_ok"] = all(launches.get(n) == c
                                 for n, c in want.items())
    log(f"data_elastic (c) elastic: {json.dumps(out)}")
    if not (got == base and len(got) == cfg["steps"]
            and kinds == ["preemption", "resume"]
            and counters["elastic/preemptions"] == 1
            and counters["elastic/resumes"] == 1
            and counters["elastic/shrinks"] == 0
            and counters["elastic/failures"] == 0
            and counters["elastic/reshards"] == 0
            and out.get("launches_ok", True)):
        fails.append(f"(c) elastic: {out}")
    return out


def _lenet_shards(work, cfg):
    rs = np.random.RandomState(37)
    paths, gid = [], 0
    for f in range(cfg["lenet_files"]):
        p = os.path.join(work, f"lenet{f}.bin")
        with open(p, "wb") as fh:
            for _ in range(cfg["lenet_per_file"]):
                fh.write(rs.randint(0, 256, LENET_IMG).astype(np.uint8)
                         .tobytes())
                fh.write(np.array([gid, gid % 10 + 1], np.int32).tobytes())
                gid += 1
        paths.append(p)
    return paths


def _lenet_decode(b):
    x = np.frombuffer(b[:LENET_IMG], np.uint8).reshape(28, 28)
    return (x / np.float32(255)).astype(np.float32), \
        np.float32(np.frombuffer(b[-4:], np.int32)[0])


def _de_lenet(work, cfg, device, fails):
    """(d) LeNet-5 through LocalOptimizer with plain SGD (K6), fed by
    ``ShardedRecordDataSet(fmt="fixed")``: uninterrupted, then SIGTERM as
    batch ``lenet_preempt`` is pulled (a final checkpoint) and a resume
    by a fresh optimizer; parameters bitwise, records exactly once."""
    import signal

    from bigdl_tpu_torch.checkpoint import scan
    from bigdl_tpu_torch.data.sharded import ShardedRecordDataSet
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    paths = _lenet_shards(work, cfg)
    rec_bytes = LENET_IMG + 8

    class Preempting(ShardedRecordDataSet):
        """SIGTERM to this process as the ``at``-th batch is pulled."""
        at = None

        def data(self, train=True, epoch=None):
            it = super().data(train, epoch)
            if not train or self.at is None:
                return it
            return _PullCounter(it, self)

    class _PullCounter:
        def __init__(self, it, ds):
            self.it, self.ds = it, ds

        def __iter__(self):
            return self

        def __next__(self):
            b = next(self.it)
            self.ds.pulled = getattr(self.ds, "pulled", 0) + 1
            if self.ds.pulled == self.ds.at:
                signal.raise_signal(signal.SIGTERM)
            return b

        def close(self):
            self.it.close()

    def optimizer(ckpt, at=None):
        model = lenet.build(10, device=device, seed=0)
        ds = Preempting(paths, "fixed", _lenet_decode,
                        batch_size=cfg["lenet_batch"], record_bytes=rec_bytes,
                        n_workers=2, seed=1)
        ds.at = at
        opt = LocalOptimizer(model, ds, ClassNLLCriterion(), device=device)
        opt.set_optim_method(SGD(learning_rate=0.05, fused=True)) \
            .set_end_when(Trigger.max_iteration(cfg["lenet_steps"]))
        if ckpt is not None:
            opt.set_checkpoint(ckpt, Trigger.several_iteration(
                cfg["lenet_every"]), handle_preemption=True)
        return model, opt

    ck = os.path.join(work, "lenet_ck")
    # deterministic cuDNN convolutions: three runs compared bit for bit
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    t = time.monotonic()
    _build.reset_launch_counts()
    ma, oa = optimizer(None)
    oa.optimize()
    launches = _build.launch_counts()
    _, ob1 = optimizer(ck, at=cfg["lenet_preempt"])
    ob1.optimize()
    ob1._preemption.uninstall()
    tags = [m.tag for _, m in scan(ck)]
    cursor = scan(ck)[-1][1].meta["data_cursor"]
    mb, ob2 = optimizer(ck)
    ob2.optimize()
    ob2._preemption.uninstall()
    same = all(torch.equal(a, b) for a, b in zip(
        [v for _, v in sorted(ma.state_dict().items())],
        [v for _, v in sorted(mb.state_dict().items())]))

    def drain(ds, n, epoch):
        out = []
        while len(out) < n:
            for x, _ in ds.data(train=True, epoch=epoch):
                out.append(x.reshape(len(x), -1)[:, 0].tolist())
                if len(out) == n:
                    break
            epoch += 1
        return out

    def ids_ds():
        return ShardedRecordDataSet(
            paths, "fixed", lambda b: (np.frombuffer(
                b[LENET_IMG:LENET_IMG + 4], np.int32).copy(), None),
            batch_size=cfg["lenet_batch"], record_bytes=rec_bytes,
            n_workers=2, seed=1)
    k = cfg["lenet_preempt"]
    want = drain(ids_ds(), cfg["lenet_steps"], 1)
    rest = drain(ids_ds().restore(cursor), cfg["lenet_steps"] - k,
                 cursor["epoch"])
    n = cfg["lenet_files"] * cfg["lenet_per_file"]
    first = [i for b in want[:n // cfg["lenet_batch"]] for i in b]
    out = {"preempt_tag": tags[-1], "params_bitwise": same,
           "exactly_once": want[:k] + rest == want
           and len(set(first)) == len(first),
           "iterations": ob2.state.iteration, "launches": launches,
           "s": time.monotonic() - t}
    log(f"data_elastic (d) lenet: {json.dumps(out)}")
    if not (same and out["exactly_once"]
            and tags[-1] == f"preempt_iter_{k}"
            and ob2.state.iteration == cfg["lenet_steps"]
            and (device == "cpu" or launches.get("fused_sgd_plain")
                 == cfg["lenet_steps"])):
        fails.append(f"(d) lenet: {out}")
    return out


def phase_data_elastic(card: str, device: str = "cuda", small: bool = False):
    """The sharded data plane, module files and the elastic supervisor on
    the card: (a) TransformerLM ``base`` at 4 layers trained 8 steps
    through SpmdTrainer fed by ShardedRecordDataSet, uninterrupted,
    preempted after step 5 and resumed (each in a process of its own; bitwise,
    exactly once, K1–K4 counted); (b) its module file loaded in a fresh
    process and served (bitwise logits, equal topology); (c)
    ElasticSupervisor at world size 1 over NCCL; (d) LeNet-5 through
    LocalOptimizer on fixed-length records (K6).  ``device="cpu",
    small=True`` rehearses it on the CPU (``tiny``, no launch counts or
    device times)."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.ops import _build
    t0 = time.monotonic()
    cfg = _de_cfg(small)
    fails = []
    cuda = device != "cpu"
    threads = torch.get_num_threads()
    if cuda:
        torch.cuda.empty_cache()    # the children need the card's memory
    else:
        # (c) and (d) compare runs of this process with the children's
        # and each other bit for bit: one thread, as the children run
        torch.set_num_threads(1)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="data_elastic_",
                            dir=str(_build.BUILD_DIR))
    vocab = T.PRESETS[cfg["preset"]]["vocab_size"]
    legs_s = {}
    try:
        _warm_forkserver()
        paths = _de_shards(work, cfg, vocab)
        alone = _de_pipeline_alone(paths, cfg, device)
        legs_s["shards_and_pipeline"] = time.monotonic() - t0
        module = os.path.join(work, "base.bigdl")
        spec = {"device": device, "work": work, "small": small,
                "paths": paths, "vocab": vocab, "module": module,
                "ckpt": os.path.join(work, "ck_b")}

        def child(kind, on_line=None, wait_for=None):
            rc, _ = _spawn_child({**spec, "name": kind, "kind": kind,
                                  "wait_for": wait_for,
                                  "ckpt": os.path.join(
                                      work, "ck_a" if kind == "a"
                                      else "ck_b")},
                                 flag="--data-elastic-child", on_line=on_line)
            if rc != 0:
                raise AssertionError(f"data_elastic child {kind} exited {rc}")
            with open(os.path.join(work, f"{kind}.json")) as f:
                return json.load(f)
        # b1, b2 and (c) here start once a's timed runs are over (a then
        # serves and writes its module file, on the host mostly); b2, set
        # up, waits for b1's end, and the module file's load follows a:
        # nothing timed among them is read against another run
        pool = ThreadPoolExecutor(5)
        started, trained = {}, threading.Event()
        wait_s = DURABLE_CHILD_TIMEOUT + 60
        go = os.path.join(work, "go_b2")

        def a_line(line):
            if line.strip() == "A TRAINED" and "b1" not in started:
                started["b1"] = pool.submit(child, "b1")
                started["b2"] = pool.submit(child, "b2", wait_for=go)
                trained.set()

        def b_then_load():
            try:
                out = {"a": fut_a.result(timeout=wait_s)}
                load = pool.submit(child, "load")
                if "b1" not in started:
                    raise AssertionError("child a never reported its "
                                         "timed runs over")
                out["b1"] = started["b1"].result(timeout=wait_s)
            finally:
                open(go, "w").close()
            out["b2"] = started["b2"].result(timeout=wait_s)
            out["load"] = load.result(timeout=wait_s)
            return out
        try:
            fut_a = pool.submit(child, "a", a_line)
            deadline = time.monotonic() + wait_s
            while not trained.wait(0.5) and not fut_a.done() \
                    and time.monotonic() < deadline:
                pass
            legs_s["a_timed"] = time.monotonic() - t0 - sum(legs_s.values())
            # a pool thread of its own; b2 and load take a's and b1's
            rest = pool.submit(b_then_load)
            t = time.monotonic()
            try:
                elastic = _de_elastic(work, cfg, vocab, device, fails)
            finally:
                legs_s["c"] = time.monotonic() - t
                runs = rest.result(timeout=3 * wait_s)
            legs_s["b_load_c"] = time.monotonic() - t
        finally:
            pool.shutdown()
        a, b1, b2, ld = (runs[k] for k in ("a", "b1", "b2", "load"))
        steps, k = cfg["steps"], cfg["preempt_after"]
        flat = [i for b in a["ids"] for i in b]
        per_epoch = cfg["shards"] * cfg["per_shard"] // cfg["batch"]
        checks = {
            "b1_stopped_at": b1["step_count"], "b2_start": b2["start"],
            "losses_bitwise": b1["losses"] == a["losses"][:k]
            and b2["losses"] == a["losses"][k:],
            "params_bitwise": b2["digest"] == a["digest"],
            "ids_exactly_once": b1["ids"][:k] + b2["ids"] == a["ids"]
            and len(a["ids"]) == steps
            and len(set(flat[:per_epoch * cfg["batch"]]))
            == min(steps, per_epoch) * cfg["batch"],
            "module_logits_bitwise": a["logits"] == ld["logits"]
            and a["logits_finite"]
            and a["logits_shape"] == [cfg["requests"], 1, cfg["seq"], vocab],
            "topology_equal": a["topology"] == ld["topology"]}
        n_layers = cfg["layers"] or T.PRESETS[cfg["preset"]]["n_layers"]
        launches = a["launches"]
        if cuda:
            want = {"flash_fwd": n_layers * steps,
                    "flash_bwd_dkv": n_layers * steps,
                    "flash_bwd_dq": n_layers * steps, "fused_adam": steps}
            checks["launches"] = launches
            checks["launches_ok"] = all(launches.get(n) == c
                                        for n, c in want.items())
            checks["serve_launches_ok"] = (
                a["serve_launches"].get("flash_fwd")
                == ld["serve_launches"].get("flash_fwd")
                == n_layers * cfg["requests"])
        log(f"data_elastic (a)(b): {json.dumps(checks)}")
        if not (b1["step_count"] == k and b2["start"] == k
                and all(v for n, v in checks.items()
                        if n.endswith(("bitwise", "once", "equal", "_ok")))):
            fails.append(f"(a)/(b): {checks}")
        readings = {
            "pipeline_alone": alone, "fit_s": a["fit_s"],
            "stall_s_per_step": a["stall_s"] / steps,
            "module_mb": a["module_mb"], "save_s": a["save_s"],
            "load_s": ld["load_s"], "serve_s": ld["serve_s"]}
        if cuda:
            mem, prof = a["memory"], a["profile"] or {}
            readings.update(
                step_ms_median=a["step_ms_median"],
                memory_step_ms_median=mem["step_ms_median"],
                memory_over_pipeline_step=mem["step_ms_median"]
                / a["step_ms_median"],
                device_busy_share=prof.get("device_busy_share"),
                profile=a["profile"],
                step_ms=a["step_ms"], memory_step_ms=mem["step_ms"])
        log(f"data_elastic readings: {json.dumps(readings)}; {card}")
        t = time.monotonic()
        lenet_out = _de_lenet(work, cfg, device, fails)
        legs_s["d"] = time.monotonic() - t
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.set_num_threads(threads)
    log(f"data_elastic legs: {json.dumps(legs_s)}")
    if fails:
        raise AssertionError(f"data_elastic: {fails}")
    out = {"checks": checks, "readings": readings, "elastic": elastic,
           "lenet": lenet_out, "legs_s": legs_s,
           "launches": {"data_elastic": launches,
                        "data_elastic_supervisor": elastic["launches"],
                        "data_elastic_serve": ld["serve_launches"],
                        "data_elastic_lenet": lenet_out["launches"]},
           "phase_s": time.monotonic() - t0}
    log(f"data_elastic phase: {time.monotonic() - t0:.1f} s")
    return out


# --------------------------------------------------------------------- #
# 17. operate: the read side of telemetry on base                       #
# --------------------------------------------------------------------- #
OPERATE = dict(preset="base", batch=TRAIN_BATCH, seq=SEQ, steps=8,
               trace_every=4, requests=8)
OPERATE_SMALL = dict(OPERATE, preset="tiny", batch=2, seq=64)
OPERATE_FLOP_REL = 0.02          # captured FLOPs against the analytic count
OPERATE_HOLD_S = 30.0            # the longest wait for /healthz's 503
OPERATE_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                   "fused_adam")


def _get(url, timeout=30.0):
    """(status, body) of one GET; an HTTP error status is returned, not
    raised."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _prom_value(text, metric):
    """The value of an unlabeled sample ``metric`` in a Prometheus text
    exposition (None when absent)."""
    for line in text.splitlines():
        if line.startswith(metric + " "):
            return float(line.split()[1])
    return None


def _lm_flops(cfg, batch, seq):
    """A TransformerLM step's FLOPs by formula: 6 a token a matmul
    parameter (every block's projections and the head; the embedding is
    a gather), and attention's four matmuls forward and eight backward
    at 2·S²·head_dim a head, the causal mask counted in full."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    matmul = cfg.n_layers * (4 * d * d + 3 * d * f) + d * v
    attention = cfg.n_layers * 12 * batch * cfg.n_heads * seq * seq \
        * cfg.head_dim
    return 6.0 * batch * seq * matmul + attention


def _trace_names(path):
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [str(e.get("name", "")) for e in events]


def phase_operate(card: str, device: str = "cuda", small: bool = False):
    """The operate plane on the main path: ``base`` (fp32, seed 0) at 8 x
    512 through ``SpmdTrainer(AdamW(3e-4, fused=True))`` for 8 steps with
    ``set_telemetry`` (a ``TensorBoardSink``, the cost capture, the memory
    poller), ``set_health(stall_factor=1)``, ``set_trace_every(4)`` and
    ``serve_metrics``: /metrics and /healthz (200) scraped while it
    trains, the loop held after its last step until /healthz reads 503,
    /records read; the losses bitwise the same 8 steps with telemetry
    off; the traces of steps 0 and 4 hold K1–K4 and the train_step
    range; K1 = K2 = K3 = 96, K4 = 8; the captured FLOPs within 2 % of
    the analytic count; ``perf/mfu`` against the specs table's H100 row.
    Then a ``ServingEngine`` with ``serve_metrics`` answers 8 requests:
    its /metrics request counter equals the engine's own, /trace parses
    as Chrome JSON.  Every server and watchdog is stopped at the end.
    ``device="cpu", small=True`` rehearses it on the CPU (``tiny``; no
    launch counts, no kernels in the traces)."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.models import transformer as T
    from bigdl_tpu_torch.observability import (Recorder, TensorBoardSink,
                                               profile)
    from bigdl_tpu_torch.ops import _build
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel import SpmdTrainer
    from bigdl_tpu_torch.serving import ModelRegistry, ServingEngine
    from bigdl_tpu_torch.visualization.event_writer import read_scalar
    t0 = time.monotonic()
    cfg = OPERATE_SMALL if small else OPERATE
    cuda = device != "cpu"
    fails = []
    threads_before = set(threading.enumerate())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = tempfile.mkdtemp(prefix="operate_", dir=str(_build.BUILD_DIR))
    model = T.build(cfg["preset"], device=device, seed=0)
    mcfg = model.cfg
    w0 = {m: {k: t.detach().clone() for k, t in sub.items()}
          for m, sub in model.param_dict().items()}
    ids = np.random.RandomState(41).randint(
        0, mcfg.vocab_size, (cfg["steps"], cfg["batch"], cfg["seq"] + 1)
    ).astype(np.int32)
    batches = [(b[:, :-1], b[:, 1:]) for b in ids]
    tr = eng = None
    try:
        # the same steps with telemetry off: the losses to hold
        plain = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR, fused=cuda),
                            device=device)
        want = plain.fit(batches)
        del plain
        model.load_param_dict(w0)

        tr = SpmdTrainer(model, AdamW(learning_rate=TRAIN_LR, fused=cuda),
                         device=device)
        tb_dir = os.path.join(work, "tb")
        rec = Recorder(sinks=[TensorBoardSink(tb_dir)])
        tr.set_telemetry(rec)
        tr.set_health(policy="record", stall_factor=1.0)
        tr.set_trace_every(cfg["trace_every"], os.path.join(work, "traces"))
        srv = tr.serve_metrics()
        seen = {}

        def feed():
            for i, b in enumerate(batches):
                if i == 2:
                    seen["metrics"] = _get(srv.url("/metrics"))
                    seen["healthz"] = _get(srv.url("/healthz"))
                yield b
            # every step ran and fit still loops: the step loop is held
            # until the watchdog's budget runs out
            t_hold = time.monotonic()
            while time.monotonic() - t_hold < OPERATE_HOLD_S:
                code, body = _get(srv.url("/healthz"))
                if code == 503:
                    break
                time.sleep(0.2)
            seen["held"] = (code, json.loads(body),
                            time.monotonic() - t_hold)
            seen["records"] = _get(srv.url("/records?n=4&type=step"))

        _build.reset_launch_counts()
        got = tr.fit(feed())
        launches = _build.launch_counts()
        rec.flush()
        seen["after"] = _get(srv.url("/healthz"))
        checks = {"losses_bitwise": got == want,
                  "metrics_200": seen["metrics"][0] == 200
                  and "bigdl_tokens_total" in seen["metrics"][1],
                  "healthz_200": seen["healthz"][0] == 200,
                  "healthz_held_503": seen["held"][0] == 503
                  and seen["held"][1]["stalled"],
                  "healthz_after_200": seen["after"][0] == 200}
        recs = json.loads(seen["records"][1])
        checks["records"] = seen["records"][0] == 200 and [
            r["step"] for r in recs] == list(range(cfg["steps"] - 4,
                                                   cfg["steps"]))
        tb = [v for _, v, _ in read_scalar(tb_dir, "telemetry/loss")]
        rec.close()
        checks["tensorboard_losses"] = tb == [float(np.float32(v))
                                              for v in got]
        # the traces of steps 0 and 4
        traces = {}
        for path in rec.trace_files:
            names = _trace_names(path)
            want_names = ("train_step",) + (OPERATE_KERNELS if cuda else ())
            traces[os.path.basename(path)] = {
                n: sum(n in x for x in names) for n in want_names}
        checks["traces"] = sorted(traces) == [
            f"trace_step{k}.json" for k in range(0, cfg["steps"],
                                                 cfg["trace_every"])] \
            and all(all(c > 0 for c in t.values()) for t in traces.values())
        # the cost capture against the analytic count
        prof = rec.recent_records(rec_type="profile")
        cost = prof[-1]["cost"] if prof else {}
        analytic = _lm_flops(mcfg, cfg["batch"], cfg["seq"])
        flop_rel = abs(cost.get("flops", 0.0) - analytic) / analytic
        checks["flops_within"] = flop_rel <= OPERATE_FLOP_REL
        checks["cost_complete"] = not cost.get("unavailable") \
            if cuda else cost.get("unavailable") == ["memory_analysis"]
        last = rec.recent_records(rec_type="step")[-1]["scalars"]
        spec = profile.device_spec(device)
        perf = {k: v for k, v in last.items()
                if k.startswith(("perf/", "mem/"))}
        if cuda:
            checks["launches"] = launches
            checks["launches_ok"] = launches == {
                "flash_fwd": mcfg.n_layers * cfg["steps"],
                "flash_bwd_dkv": mcfg.n_layers * cfg["steps"],
                "flash_bwd_dq": mcfg.n_layers * cfg["steps"],
                "fused_adam": cfg["steps"]}
            checks["mfu_reported"] = "perf/mfu" in last \
                and spec.peak_flops == 989e12
        log(f"operate training: {json.dumps(checks)}; cost "
            f"{json.dumps(cost)}; analytic {analytic:.6g} FLOPs "
            f"(rel {flop_rel:.3e}); step {cfg['steps'] - 1} {perf}, "
            f"against {spec}; held {seen['held'][2]:.2f} s for the 503; "
            f"traces {traces}; {card}")
        tr.stop_metrics()

        # serving: the engine's counters against its /metrics
        reg = ModelRegistry()
        reg.register("lm", model, input_shape=(cfg["seq"],), dtype=np.int32)
        eng = ServingEngine(reg, max_batch=8)
        eng.warmup()
        esrv = eng.serve_metrics()
        xs = np.random.RandomState(43).randint(
            0, mcfg.vocab_size, (cfg["requests"], 1, cfg["seq"])
        ).astype(np.int32)
        _build.reset_launch_counts()
        outs = [np.asarray(eng.submit("lm", x).result(timeout=300))
                for x in xs]
        serve_launches = _build.launch_counts()
        code, text = _get(esrv.url("/metrics"))
        tcode, tbody = _get(esrv.url("/trace"))
        trace_doc = json.loads(tbody) if tcode == 200 else {}
        served = eng.recorder.counter_value("serving.requests")
        serving = {
            "metrics_requests": _prom_value(text,
                                            "bigdl_serving_requests_total"),
            "engine_requests": served,
            "trace_events": len(trace_doc.get("traceEvents", ())),
            "outputs_finite": all(np.isfinite(o).all() for o in outs)}
        checks["serving_counters_equal"] = code == 200 \
            and serving["metrics_requests"] == served == cfg["requests"]
        checks["serving_trace_json"] = tcode == 200 \
            and serving["trace_events"] > 0
        checks["serving_outputs_finite"] = serving["outputs_finite"]
        if cuda:
            serving["launches"] = serve_launches
            checks["serving_launches_ok"] = serve_launches == {
                "flash_fwd": mcfg.n_layers * cfg["requests"]}
        log(f"operate serving: {json.dumps(serving)}")
    finally:
        if eng is not None:
            eng.shutdown(drain=True, timeout=60)
        if tr is not None:
            tr.stop_metrics()
        shutil.rmtree(work, ignore_errors=True)
    left = [t.name for t in set(threading.enumerate()) - threads_before
            if t.name.startswith(_STOPPED_THREADS)]
    checks["threads_left"] = left
    if left:
        fails.append(f"threads left running: {left}")
    bad = [k for k, v in checks.items()
           if isinstance(v, bool) and not v]
    if bad:
        fails.append(f"checks failed: {bad}")
    out = {"config": f"TransformerLM {cfg['preset']} fp32 seed 0, "
                     f"{cfg['batch']} x {cfg['seq']}, SpmdTrainer(AdamW("
                     f"{TRAIN_LR}, fused={cuda}), {cfg['steps']} steps, "
                     "set_telemetry(Recorder([TensorBoardSink])), "
                     "set_health('record', stall_factor=1), set_trace_every"
                     f"({cfg['trace_every']}), serve_metrics(); "
                     "ServingEngine(max_batch=8).serve_metrics(), "
                     f"{cfg['requests']} one-row requests",
           "checks": checks, "cost": cost, "analytic_flops": analytic,
           "flops_rel_err": flop_rel, "perf": perf,
           "capture_s": prof[-1].get("capture_s") if prof else None,
           "spec": {"name": spec.name, "peak_flops": spec.peak_flops,
                    "peak_hbm_bw": spec.peak_hbm_bw},
           "held_503_after_s": seen["held"][2], "traces": traces,
           "serving": serving,
           "launches": {"operate": launches if cuda else {},
                        "operate_serving": serve_launches if cuda else {}},
           "seconds": time.monotonic() - t0, "card": card}
    log(f"operate: {time.monotonic() - t0:.1f} s")
    if fails:
        raise AssertionError("operate phase: " + "; ".join(fails))
    return out



# threads that a phase must stop before it returns, daemon or not
_STOPPED_THREADS = ("introspection:", "health-watchdog")


def _child_pids() -> list:
    """``(pid, command line)`` of this process's child processes, from
    ``/proc`` (empty where the kernel does not list them)."""
    pids = set()
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/children") as f:
                pids.update(int(p) for p in f.read().split())
        except OSError:
            pass
    out = []
    for pid in sorted(pids):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            cmd = "?"
        out.append((pid, cmd.strip()[:160]))
    return out


def leftovers() -> list:
    """What still runs when the script is about to end: threads other than
    the main one that are not daemons (and the server and watchdog
    threads, which a phase must stop), child processes, and an initialised
    ``torch.distributed`` default group.  multiprocessing's own helpers
    (the elastic supervisor's forkserver and the resource tracker it
    starts) are stopped first."""
    import multiprocessing
    from multiprocessing import forkserver, resource_tracker
    for helper, pid_attr in ((getattr(forkserver, "_forkserver", None),
                              "_forkserver_pid"),
                             (getattr(resource_tracker, "_resource_tracker",
                                      None), "_pid")):
        if getattr(helper, pid_attr, None) is not None \
                and hasattr(helper, "_stop"):
            helper._stop()
    out = [f"thread {t.name}" for t in threading.enumerate()
           if t is not threading.main_thread()
           and (not t.daemon or t.name.startswith(_STOPPED_THREADS))]
    out += [f"child {p.name} (pid {p.pid})"
            for p in multiprocessing.active_children()]
    out += [f"child process {pid}: {cmd}" for pid, cmd in _child_pids()]
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        out.append("the torch.distributed default group")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a "
              "GPU", file=sys.stderr)
        return 1
    # the model's dtype is float32: full-precision matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    phase_s = {}

    def timed(fn, *args):
        """``fn(*args)``, its wall time kept under the phase's name."""
        t = time.monotonic()
        out = fn(*args)
        phase_s[fn.__name__] = time.monotonic() - t
        log(f"{fn.__name__}: {phase_s[fn.__name__]:.1f} s")
        return out
    build_s = timed(phase_build)
    k1 = timed(phase_kernels, card)
    k1["build_s"] = build_s
    k23 = timed(phase_flash_bwd, card)
    k4 = timed(phase_adam, card)
    k5, k6 = timed(phase_sgd, card)
    host_sync = timed(phase_host_sync)
    slice_ = timed(phase_slice, card)
    k1["cases"].append(slice_["layer_case"])
    decode = timed(phase_decode, card)
    train = timed(phase_training, card, k4)
    train["bf16"] = timed(phase_training_bf16, card)
    stream = timed(phase_stream, card, train["step_ms_median"])
    if train["profile"]:
        # K4's own device time a step (one launch), without host gaps
        k4["device_ms_per_step"] = train["profile"]["device_ms_by_class"] \
            .get("K4 fused_adam")
    for k in k23:
        k["cases"].append(train["layer_case"])
    # image classifiers: deterministic cuDNN algorithms, chosen without
    # benchmarking, so that two runs can be compared step by step
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    classifier = timed(phase_classifier, card, k5, k6)
    distri = timed(phase_distri, card)
    prefetch_run = distri["readings"]["dp1_b256_prefetch"]
    recipe = timed(phase_recipe, card, {k: prefetch_run[k] for k in (
        "step_ms_median", "images_per_s")})
    vgg = timed(phase_vgg, card)
    durable = timed(phase_durable, card)
    lm_long = timed(phase_lm_long, card)
    predictor = timed(phase_predictor, card)
    spmd = timed(phase_spmd, card)
    pipe_moe = timed(phase_pipeline_moe, card)
    data_elastic = timed(phase_data_elastic, card)
    operate = timed(phase_operate, card)
    by_path = {"serving": {"flash_fwd": slice_["launches"]},
               "decode": decode["launches"],
               "training": train["launches"],
               "training_bf16": train["bf16"]["launches"],
               "stream": stream["launches"],
               "replica_serving": stream["replica_serving"]["launches"],
               "classifier": classifier["launches"],
               "distri": distri["launches"],
               "recipe": recipe["launches"],
               "vgg": vgg["launches"],
               "durable": durable["launches"],
               "lm_long": lm_long["launches"],
               "lm_long_eval": lm_long["eval_launches"],
               "lm_durable": lm_long["durable"]["launches"],
               "predictor": predictor["launches"],
               "spmd": spmd["launches"],
               "pipeline": pipe_moe["launches"]["pipeline"],
               "moe": pipe_moe["launches"]["moe"],
               **data_elastic["launches"], **operate["launches"]}
    kernels = [k1, *k23, k4, k5, k6]
    for k in kernels:
        k["launches_by_path"] = {path: counts.get(k["name"], 0)
                                 for path, counts in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["name"] in lm_long["kernels"]:
            # the same kernel at long8k's shapes (bf16, S 8192)
            k["long8k"] = lm_long["kernels"][k["name"]]
        if k["name"] in spmd["bf16"]:
            # the same kernel over a tree of f32 and bf16 leaves
            k["bf16_leaves"] = spmd["bf16"][k["name"]]
    left = leftovers()
    log(f"left running at the end: {left or 'nothing'}")
    if left:
        raise AssertionError(f"still running at the end: {left}")
    total_s = time.monotonic() - t0
    process_s = time.monotonic() - PROCESS_T0
    log(f"total {total_s:.1f} s; {process_s:.1f} s since the process "
        f"started")
    print(json.dumps({"slice": slice_}), flush=True)
    print(json.dumps({"decode": decode}), flush=True)
    print(json.dumps({"training": train}), flush=True)
    print(json.dumps({"stream": stream}), flush=True)
    print(json.dumps({"classifier": classifier}), flush=True)
    print(json.dumps({"distri": distri}), flush=True)
    print(json.dumps({"recipe": recipe}), flush=True)
    print(json.dumps({"vgg": vgg}), flush=True)
    print(json.dumps({"durable": durable}), flush=True)
    print(json.dumps({"lm_long": {k: v for k, v in lm_long.items()
                                  if k != "kernels"}}), flush=True)
    print(json.dumps({"host_sync": host_sync}), flush=True)
    print(json.dumps({"predictor": predictor}), flush=True)
    print(json.dumps({"spmd": spmd}), flush=True)
    print(json.dumps({"pipeline_moe": pipe_moe}), flush=True)
    print(json.dumps({"data_elastic": data_elastic}), flush=True)
    print(json.dumps({"operate": operate}), flush=True)
    print(json.dumps({"phase_s": phase_s, "total_s": total_s,
                      "process_s": process_s}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--durable-child":
        durable_child(json.loads(sys.argv[2]))
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--lm-durable-child":
        lm_durable_child(json.loads(sys.argv[2]))
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--data-elastic-child":
        data_elastic_child(json.loads(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
