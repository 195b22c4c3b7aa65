"""On-card smoke run of the PyTorch/CUDA port (kf_benchmarks_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printed on its own line and none guarded -- any failure ends
the run with a non-zero exit and no result line:

  1. build   -- compile csrc/*.cu (one nvcc per source, in parallel),
                print ptxas's registers, shared memory and spills of every
                kernel, and for the wgmma/TMA kernels (K-A, K-B, the flash
                forward, the flash backward's dK/dV and dQ) and the decode
                kernel their HGMMA, UTMALDG, LDGSTS and LDG SASS counts
                read with cuobjdump (each wgmma/TMA kernel function but
                K-B's partial-sum helper must have HGMMA and UTMALDG, and
                none of these libraries may spill);
  2. conv    -- K-A conv3x3_same against its plain version at the four
                ResNet-50 stage shapes (stage 3 is the TPU probe's own)
                and one with a ragged last tile;
  3. unit    -- K-B bn_relu_conv3x3_stats against its plain version at the
                same shapes (half the channels with relu(sh) > 0, so a
                padding row left non-zero fails), two launches bitwise
                equal, timed through the entry the fused unit calls;
                then the FusedBnReluConv3x3 gradients against autograd
                through the plain forward at batch 32;
  4. train   -- the port's BenchmarkCNN: ResNet-50 v1.5, batch 256, bf16,
                Nesterov momentum, 5 warmup + 20 timed steps, with the
                launch counts of both kernels set to 0 just before that
                run and read just after;
  5. parity  -- one training step at batch 8 from the same init and the
                same batch on the card (kernels, bf16), on the card's
                plain-op path (cuDNN, bf16) and on the CPU (plain, f32);
  6. flash   -- the flash-attention forward kernel against its plain
                version at the LM's shape (B 8, L 2048, H 8, D 64, causal),
                the same with random documents as segment ids, Lq 256
                against Lk 1024 with a kv-only mask (the decode mode's
                structure), a ragged L of 1000, and the LM's shape through
                the qkv.unbind(2) views of one packed projection
                (lm_causal_strided), then the D = 128 instantiations at a
                small shape;
  7. flash_grad -- dQ, dK, dV of the FlashAttention Function (the dK/dV
                and dQ kernels) against autograd through the plain forward
                at every flash shape (the packed one through its views),
                two launches bitwise equal; the two kernels timed at the
                LM's shape beside the plain di op;
  8. lm_train -- the port's BenchmarkCNN on transformer_lm (vocab 32768,
                L 2048, d 512, 6 layers, 8 heads, batch 8, bf16, SGD) with
                KF_TRANSFORMER_LM_ATTN=flash, 5 warmup + 20 timed steps,
                the launch counts set to 0 just before and read just after;
  9. lm_parity -- one LM step at batch 2 from one init and one batch on the
                card (flash kernels, bf16), the card's tiled plain ops
                (bf16) and the CPU (plain, f32), and one packed forward;
 10. decode  -- the decode-attention kernel (flash_decode, one launch)
                against its plain version and the plain model of its
                cluster merge at the serving LM's ring (T 2048, H 8, D 64,
                bf16) for B 1, 16, 64 and 256, seeded positions from
                [0, 2T) with 0 and T-1, two launches bitwise equal, NaN in
                every slot past pos invisible (bit-identical output); timed
                per call (back-to-back CUDA events, which the host paces)
                and on the device alone (24 calls captured in a CUDA graph
                and replayed), against the bound, the plain version and
                SDPA with the boolean kpos <= pos mask timed both ways;
                then D = 128 at the serving ring's B 16 and a small ring;
 11. serve   -- the port's ServingEngine at the zoo LM's full size (bf16
                over f32 params, flash attention, ladder 1/4/16/64/256):
                warm(), then two replays of the seeded poisson_workload, 128
                requests with 32 new tokens each, at 16 requests/s (the JAX
                bench's chip configuration) and at 1000/s with a queue of
                128 (capacity), each with the launch counts set to 0 just
                before and read just after: every request completes, none is
                shed, the decode kernel launches 6 x the decode steps and
                the forward kernel 6 x the prefill waves;
 12. serve_parity -- two seeded 64-token prompts packed and prefilled, then
                16 teacher-forced decode steps at full size: the card with
                the kernels (bf16), the card's tiled plain ops (bf16) and
                the CPU (plain, f32), and the card's decode logits against
                the rows of its full forward (the KV-cache oracle);
 13. dp      -- data parallel: a world-1 NCCL process group and the ResNet-50
                step of phase 4 (batch 256, bf16, Nesterov) through the rank
                entry, 3 steps from the seed under replicated, kungfu
                sync_sgd, sma and async_sgd (losses and weights bitwise equal
                to the single-device step's, which has no process group) and
                collective_all_reduce with --all_reduce_spec=psum:32k:rsag,
                whose packed path rides a bf16 wire: each step's packed
                reduction is held against the per-tensor all-reduce mean of
                the same gradients (every element within 2^-7 of it
                relative, twice bf16's unit roundoff, and not all equal),
                its losses within 1e-2 of the single-device step's; the
                same 3 steps again as one --steps_per_dispatch=3 dispatch
                (the step captured as a CUDA graph with its NCCL
                collectives and replayed) bitwise equal to the eager ones;
                13 K-A and 13 K-B launches a step in
                every run; then 2 warmup + 4 timed steps of BenchmarkCNN
                under each, beside the single-device run's images/sec, and
                the time of one reduction of the full gradient set, per
                tensor and packed (back-to-back CUDA events: the host paces
                these many small collectives, so it is host time as much as
                device time). The sharded and overlapped modes at world 1:
                ResNet-50 under --shard_optimizer_state, under
                --shard_optimizer_state --shard_params and under
                --overlap_gradient_reduction (f32 wire), and transformer_lm
                at its published size (batch 8, bf16, flash, Nesterov)
                under --shard_optimizer_state --shard_params and under
                --overlap_gradient_reduction, each held against its model's
                single-device step, eager and as one captured dispatch:
                bitwise, but the LM under FSDP with weight decay (its block
                stack's L2 reassociated: losses and weights within
                DP_FSDP_LM_RTOL); 13 + 13 K-A / K-B launches a ResNet step,
                12 + 6 + 6 flash launches an LM step; each with its
                images/sec from 2 warmup + 4 timed steps (sequences/sec
                from 3 + 8), the peak memory its build and checked steps add,
                and its bucket count;
 14. zoo     -- BASELINE configs 4 and 5's models: BenchmarkCNN on
                ResNet-152 v1.5 and on Inception-v3 (kungfu async_sgd, pair
                averaging, world 1 over NCCL), batch 128, bf16, Nesterov,
                5 warmup + 20 timed steps each: images/sec, peak memory,
                and 47 + 47 and 2 + 2 K-A + K-B launches a step, the counts
                set to 0 just before the two runs and read just after;
                every shape the two runs gave K-A and K-B (noted at each
                call: ResNet-152's four stages at batch 128, Inception-v3's
                x [128,8,8,448] -> 384 and its 384 -> 448 input gradient;
                K-A also at K-B's shapes) then checked against the plain
                versions and timed as in phases conv and unit;
 15. elastic -- BASELINE config 5's command (ResNet-152, batch 128, bf16,
                kungfu, --elastic --adaptive_batch_size, --train_dir, and
                --sync_on_finish: the coordinator's exit barrier)
                through `python -m kf_benchmarks_tpu_torch.kfrun -np 1`, no
                warmup: 6 steps twice uninterrupted and 3 steps and a
                checkpoint, the three launches at once, then 3 more in a
                new process resumed from it (beside phase faults' launch
                and phase aot's exports when those phases run, EARLY);
                the resumed state at step 6 (parameters, batch-norm
                averages, momentum buffers, step) bitwise equal to the
                first uninterrupted run's if the two uninterrupted runs are
                bitwise equal, else no tensor farther from it than the
                second uninterrupted run is; the batch holds at world 1
                (no noise-scale estimate); 47 + 47 launches a step in every
                worker (read from its log); checkpoint save and restore
                times;
 16. infer   -- --forward_only through BenchmarkCNN: ResNet-50 v1.5 at batch
                256, bf16, and transformer_lm (flash attention) at batch 8,
                5 warmup + 12 timed steps each, the counts set to 0 just
                before each run and read just after (13 K-B and 0 K-A a
                ResNet step; 6 flash-forward launches an LM step, no
                backward kernel); images/sec, sequences/sec, peak memory;
                K-B at every shape the ResNet run gave it and the flash
                forward on the LM run's own q, k, v against their plain
                versions; ResNet-50 trained 3 steps on the card, then its
                eval-mode logits at batch 8 on the card (bf16, kernels)
                against the CPU (f32, plain) from the same weights;
 17. eval    -- ResNet-50 at batch 256 trains 6 steps in a process of its
                own, saving at steps 3 and 6; a second process runs --eval
                over that directory (one poll, 4 eval batches): it must
                score the step-6 checkpoint with 13 K-B launches a batch and
                the top-1 / top-5 of the eval step in this process on the
                same restored weights and batch; while the training
                process runs, 6 steps in this process with
                --eval_during_training_every_n_steps=2 evaluate after steps
                2, 4 and 6 and end bitwise at the state of the same run
                without evals (if two such runs are bitwise equal);
 18. optim   -- ResNet-50 at batch 256, bf16, 3 warmup + 10 timed steps
                under momentum and under rmsprop, adam and lars (each with
                --gradient_clip=1.0, a piecewise rate and
                --print_training_accuracy; 13 + 13 launches a step),
                images/sec beside momentum's; each optimizer's 3 steps at
                batch 8 on the card against the CPU under a warmup rate;
                and the auto loss scale from 2^127 at batch 256: every
                skipped step halves the scale and leaves the weights,
                optimizer buffers and batch-norm averages bitwise as they
                were, until an applied step; then a planted overflow after
                it is skipped with the momentum buffers unchanged;
 19. dispatch -- --steps_per_dispatch through BenchmarkCNN: ResNet-50
                (batch 256, bf16, momentum) and transformer_lm (batch 8,
                flash), 16 warmup + 12 timed steps each at K = 1 (eager
                steps) and K = 8 (the step captured as a CUDA graph and
                replayed, train_step.TrainChunk) from one seed: per-step
                losses and final weights bitwise equal, equal launches a
                step; images/sec or sequences/sec, compile_s,
                dispatch_overhead_s, peak memory, and the busy share of 4
                more steps of each arm, as torch.profiler's kernel time
                and as the card's time for them queued behind a spin
                kernel (the host's share hidden), over their wall; then
                ResNet-50 under --variable_update=parameter_server
                --staged_vars and under --variable_consistency=relaxed,
                4 warmup + 8 timed steps at K = 1 and K = 8: bitwise
                equal, K-A and K-B 13 + 13 a step, images/sec beside
                the plain step's;
 20. accum   -- --num_grad_accum: ResNet-50 (batch 256) at M = 1 and at
                M = 4 under K = 1 and K = 4 (losses bitwise equal between
                the two, peak memory below M = 1's, K-A and K-B 4 x 13 a
                step), 4 warmup + 8 timed steps each, then K-A and K-B
                against their plain versions at every shape the M = 4
                runs gave them (batch 64); transformer_lm at M = 2
                against M = 1 (each loss within 1e-4 relative) and
                against M = 2 at half the rate (a planted double division
                by M, which must fall outside it), and the flash kernels
                against their plain versions on the M = 2 run's own
                inputs (batch 4);
 21. serve_graph -- replay (a) through the serving engine with its
                programs eager and captured (one CUDA graph per program and
                bucket, the default on the card): tokens/sec, TTFT, token
                latency, launches 6 a decode step and 6 a prefill wave, at
                most len(ladder) decode captures in the compile ledger; on
                a virtual clock (both engines then form the same batches)
                every generated token identical; 20 decode steps at bucket
                64 of each arm, their busy share read as in dispatch;
 22. fp16_vars -- --fp16_vars (bf16 parameters and optimizer state):
                ResNet-50 (batch 256) and transformer_lm (batch 8, flash),
                4 warmup + 8 timed steps at K = 1 and K = 8, and without
                the flag at K = 8, each through BenchmarkCNN with the counts
                set to 0 just before and read just after: every parameter
                and optimizer buffer bf16, 13 + 13 K-A / K-B and 12 + 6 + 6
                flash launches a step, K = 8 bitwise K = 1 (losses and
                weights), no cast of a weight (an aten::_to_copy of a
                parameter's shape of two or more dimensions) in
                torch.profiler over 2 eager steps (the run without the flag
                shows them), K-A and K-B against their plain versions on
                the inputs the bf16-weight run gave them (one call of each
                shape: its activations and bf16 weights); one Nesterov
                momentum step from bf16-rounded weights (ResNet-50 at batch
                8, the LM at batch 2) against the same step with f32
                parameters on the card and on the CPU (f32, plain
                versions): the loss bitwise and within 2e-2, every tensor's
                new weights within one bf16 ulp plus 2^-7 of the update of
                the f32-parameter step (a doubled update must fail it
                where it moves a weight 2 ulps), the head's update against
                the CPU's, the momentum buffers bf16 (the LM's timed runs
                train with SGD, which keeps none); images/sec,
                sequences/sec and peak memory with the flag and without;
 23. health  -- ResNet-50 at batch 256 with --health_stats --train_dir, 4
                warmup + 8 timed steps at K = 1 and K = 8 and with the
                stats off at K = 8: one flight-recorder row a timed step
                and the run-end dump, the rows' health vectors and the
                losses of K = 8 bitwise K = 1, grad_norm within 1e-4 of
                the norm recomputed on the card from the gradients of an
                eager step, images/sec with the stats on and off; then 8
                steps with --fault_schedule=heartbeat_delay@4:secs=8: a
                watchdog diagnostic, and the run ends normally;
 24. faults  -- `python -m kf_benchmarks_tpu_torch.kfrun -np 1
                --restart-on-failure` on ResNet-50 (batch 256, bf16,
                Nesterov, a checkpoint every 2 steps) with
                --fault_schedule=corrupt_ckpt@6,kill@7 over 9 steps: the
                worker is killed after step 7 and rejoined, which resumes
                at step 6 (step 4's checkpoint torn on disk) and takes 9
                more; its state at step 15 held as phase elastic holds its
                resume, against two uninterrupted runs of 15 steps (in
                this process; the launch runs in phase elastic, or here
                beside them); 13 + 13 launches a step in every run that
                ran to its end;
 25. input   -- the real-data input path (data/): builds the port's JPEG
                codec and image-operation libraries with g++ and checks the
                pinned SHA-256 of the decode of one fixed port-encoded
                image, and that a progressive (SOF2) fixture PIL wrote
                (tests/fixtures/progressive_97x61.jpg) decodes to the
                SHA-256 of PIL's pixels; writes 1024 train and 256
                validation TFRecords (64
                distinct textured 500x375 JPEGs at quality 90, the port's
                generator) into a temporary directory; times one host
                thread's decode and train preprocessing a image; checks
                that the first batch on the card is bitwise the CPU
                preprocessor's from the same seed (normalised, bf16), and
                that --input_preprocessor=multiprocess's first batch is
                bitwise the host's serial decode of the same records on
                the same streams; trains ResNet-50 (batch 256, bf16,
                momentum) on the records through BenchmarkCNN, 4 warmup +
                8 timed steps at K = 1 and K = 8 (losses bitwise equal,
                13 + 13 launches a step), at K = 8 with
                --datasets_repeat_cached_sample, and through the process
                pool at K = 1 and K = 8 (its worker count, dispatch ms a
                batch; losses of its two arms bitwise equal) and at K = 8
                with 7 workers (--datasets_num_private_threads=7); one
                --eval pass over the validation records (it stops at their
                end); K-A and K-B against their plain versions on the
                inputs the K = 1 run gave them; images/sec,
                feed_stall_fraction, queue depth and the host's CPU counts;
 26. aot     -- the frozen forward (aot.py): ResNet-50 v1.5 at batch 256,
                bf16, exported by the CLI (--forward_only --aot_save_path)
                at --trt_mode=FP16 and INT8 in a process each, the two at
                once (in phase elastic when it runs; artifact bytes, INT8
                under 0.35x FP16), each loaded, one after the other, in a
                fresh process (--aot_load_path), captured as a CUDA graph
                and timed, 3 warmup + 10 timed steps, beside phase infer's
                in-process (eager) rate when it ran:
                13 K-B and no K-A a forward, read from the process's log;
                loading the INT8 export as the float mode fails on the
                sidecar diff; in this process each program's
                logits on one batch against the in-process eval forward
                (FP16; INT8 against the forward on its dequantized
                weights, within 2e-2 of the largest logit) and K-B
                against its plain version on the loaded INT8 program's
                own inputs at its four shapes;
 27. serve_variants -- the serving engine at the full-size LM (bf16,
                flash) as dense, INT8 weights, the paged KV cache (page
                128), speculative decoding (k 4, draft 2) and all three,
                each on phase serve's two replays (32 requests, 32 new
                tokens, 16/s and capacity) with the counts set to 0 just
                before each and read just after; the INT8 gate on the
                workload's first 8 prompts printed (the INT8 arms are
                served directly: on random weights the gate fails); per
                arm tokens/sec, TTFT and token latency p50/p99, the
                captured decode step (and verify) at bucket 64 on the
                device, peak memory, KV bytes against the dense slab,
                captured programs, launches as the arm's path makes them
                (6 a target layer stack, 2 a draft one; the paged decode
                launches no decode kernel), acceptance, and the share of
                requests with the dense arm's tokens; the INT8 step's
                weight pass against the dense step's weight casts, each
                alone in a CUDA graph; flash_decode on the INT8 arm's own
                cache and the flash forward on the composed arm's own
                verify rows (B 64 x 2048) against their plain versions.
 28. models  -- the image-classification zoo through BenchmarkCNN, bf16
                (--use_fp16), 2 warmup + 3 timed steps each at its
                published image size and default batch: vgg16 (224, 64),
                alexnet (227, 512), overfeat (231, 32), lenet (28, 32),
                googlenet (224, 32), inception4 (299, 32), mobilenet (224,
                32), official_resnet18 and official_resnet50 (224, 32),
                and on CIFAR-10 alexnet (32, 128; at rate 0.001: its own
                0.1 diverges on the synthetic images, in the JAX package
                too), densenet40_k12 (32, 64),
                resnet56 and resnet56_v2 (32, 128), with the counts set to
                0 just before the runs and read just after: images/sec,
                peak memory, finite loss, K-A / K-B launches a step equal
                to the fused units each network has (0, 8, 13, 9; written
                down before the first run); then each network's bf16
                card forward against the port's f32 CPU forward at the
                same weights (batch 8, batch norms on batch statistics,
                dropout off; cosine >= 0.9, and the card's f32 forward
                with plain convs >= 0.9999: phase models_cosines, beside
                phase elastic in a full run); then K-A and K-B against
                their plain versions at every shape the runs gave them.
                Also NASNet-A mobile (224, 32), large (331, 16) and CIFAR
                (32, 32), NCF (ids, 2048) and SSD300 (300, 32, on
                synthetic COCO targets; 13 fused units), and, outside the
                counted window, AlexNet, VGG16, MobileNet and NASNet-CIFAR
                at --steps_per_dispatch=8: 8 steps as one captured
                dispatch bitwise 8 single steps, losses and parameters;
 29. detect  -- SSD300 at batch 32 on 384 + 64 generated COCO records (the
                port's generator, data/coco_record_generator.py): one
                step saved as a checkpoint, then 2 warmup + 8 timed steps
                warm-started from it (--backbone_model_path), K-A and K-B
                13 a step, images/sec and the feed stall; then --eval of
                that run's checkpoint over the validation records: the
                per-image predictions, NMS and the COCO mAP through the
                numpy evaluator (near 0 on untrained weights; the check is
                that the path runs end to end), K-B 13 a batch.
 30. speech  -- DeepSpeech2 (models/deepspeech.py) at its published sizes
                through BenchmarkCNN: batch 128, 3494 x 161 frames, five
                bidirectional LSTM layers of 800, bf16, 2 warmup + 3
                timed steps on the synthetic batch: examples/sec, peak
                memory, a finite loss, no kernel of ours launched, one
                step and the CTC loss's forward and backward by CUDA
                events (its share of the step), and the recurrence's
                kernels in torch.profiler (cuDNN's bf16 cell kernels,
                no fallback); the bf16 and f32 card forwards against the
                port's f32 CPU forward (batch 2, the full frames; cosine
                floors of phase models); the eager step twice from one
                state (bitwise) and 8 steps at K = 8 against 8 single
                steps at batch 16 (bitwise: cuDNN's RNN and the CTC
                recursion captured); then 384 + 128 utterances from the
                port's generator (data/librispeech_record_generator.py),
                3 steps at batch 128 (examples/sec, feed_stall_fraction,
                the losses of optax's log-epsilon path) and one eval
                batch.
 31. observe -- the observability flags through BenchmarkCNN: ResNet-50 at
                batch 256, bf16, momentum, K = 8, 16 warmup + 12 timed
                steps, once with --trace_file, --tfprof_file,
                --graph_file, --partitioned_graph_file_prefix,
                --trace_events_file, --benchmark_log_dir, the summaries
                (--summary_verbosity=1, --save_summaries_steps=4,
                --train_dir), --run_store_dir, --metrics_port and
                --compilation_cache_dir and once without them (phase
                dispatch's ResNet-50 K = 8 arm when it ran; the health
                stats off in both), the counts set to 0 just before each
                run and read just after: losses and final weights bitwise
                equal, K-A / K-B 13 + 13 a step in both, the traced
                dispatch (the last warmup one) a CUDA-graph replay, a
                mid-run /metrics scrape valid Prometheus text carrying the
                live lanes and /healthz answering, the span timeline a
                valid Chrome trace, the run record valid with platform
                gpu, 13 K-B nodes in the torch.export program text; then
                the traced replay's measured per-op table
                (observability.measured_per_op_table), K-A's and K-B's
                shares of its kernel time and its busy share, the counted
                FLOPs a step, the MFU and both runs' images/sec.
 32. audit   -- every golden contract of the port (analysis/
                contracts.py: the step traced on fake tensors in a fake
                process group, with this machine's torch) through every
                rule of analysis/audit.py: 0 violations, 0 golden diffs,
                no schedule drift. Untimed, on the CPU: in a full run a
                process of its own started beside phase elastic.
 33. tune    -- the autotuner (analysis/autotune.py) on ResNet-50 at
                batch 256, bf16, world 1: a seeded 12-candidate grid over
                K, M and the prefetch depth, each distinct step traced and
                pruned against the card's memory, ranked by the cost
                model, the default and the top 2 probed (the differential
                pair of windows, twice; images/sec of each beside the
                default's), the table written to a temporary directory;
                then 12 steps under --autotuned_config: the table's knobs
                applied, the stats' and the run record's provenance, and
                the contract's K-A / K-B calls a step times the steps
                launched (13 + 13 a microbatch).
 34. allreduce -- all_reduce_benchmark.py over NCCL at world 1: ResNet-50's
                161 gradient shapes through the per-tensor mean and
                psum:32k:rsag (values held, ms a reduction), and a sweep
                (psum, reduce_scatter, all_gather at 256 KiB and 4 MiB).
                At world 1 a row times NCCL's own call, not a wire.

Every process it starts shares one bytecode cache under build/pycache
(``_use_bytecode_cache``). When phase elastic is in the run, phases
parity, lm_parity and serve_parity, which time nothing, run in this
process while elastic waits for its launches (BESIDE_ELASTIC), not in
their own place, and neither does models_cosines; phase audit runs in a
process of its own started there. Before the last line it prints the
card's name
and power limit and one JSON line with every kernel's error, time, bound
and library time. The
last line is {"ok": true, "device": {...}}. ``--phases=build,conv`` runs a
subset (the result line is printed only when every phase ran);
``--phases=build,profile`` traces three ResNet-50 training steps with
torch.profiler and prints the measured per-op table of their Chrome trace
(observability.measured_per_op_table, as phase observe does) with the
hand-written kernels' shares, ``--phases=build,lm_profile`` one dispatch
of three captured transformer_lm steps, ``--phases=build,serve_profile``
20 serving decode steps at bucket 64, ``--phases=build,conv_tiles``
times K-A and K-B at every tile shape of theirs at every STAGES shape, and
``--phases=build,first_steps`` times NASNet-A's and MobileNet's build and
first training step in fresh processes, with the depthwise convs through
cuDNN and through torch's own kernel, and ``--phases=build,observe_pairs``
runs phase observe's ResNet-50 with the observability flags off, on, and
on but --trace_file, twice each in mirrored order (images/sec of each).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time


def _use_bytecode_cache() -> None:
  """Keeps compiled bytecode under build/pycache in the checkout (git
  ignores build/) for this process and every process it starts. Where
  the interpreter is told to write none (PYTHONDONTWRITEBYTECODE) and its
  site-packages ship none, each process compiles torch's Python sources
  anew: about 10 s of a CLI process's start on an H100 host, which this
  script starts some twenty of."""
  cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "pycache")
  sys.pycache_prefix = cache
  sys.dont_write_bytecode = False
  os.environ["PYTHONPYCACHEPREFIX"] = cache
  os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


if __name__ == "__main__":
  _use_bytecode_cache()

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

ALL_PHASES = ("build", "conv", "unit", "train", "parity", "flash",
              "flash_grad", "lm_train", "lm_parity", "decode", "serve",
              "serve_parity", "dp", "zoo", "elastic", "infer", "eval",
              "optim", "dispatch", "accum", "serve_graph", "fp16_vars",
              "health", "faults", "input", "aot", "serve_variants",
              "models", "models_cosines", "detect", "speech", "observe",
              "audit", "tune", "allreduce")
EXTRA_PHASES = ("profile", "lm_profile", "serve_profile", "conv_tiles",
                "first_steps", "observe_pairs")

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# (name, N, H, W, C): the stride-1 3x3 convs of ResNet-50 at batch 256,
# and stage 5 at the parity phase's batch 8, where N*H*W = 392 leaves a
# ragged last tile of the kernels' 128 output pixels.
STAGES = (("stage2", 256, 56, 56, 64), ("stage3", 256, 28, 28, 128),
          ("stage4", 256, 14, 14, 256), ("stage5", 256, 7, 7, 512),
          ("stage5_b8", 8, 7, 7, 512))
# (name, B, Lq, Lk, causal, mask): the flash phase's shapes. "docs" gives
# q and kv the same random-length documents as segment ids; "kv" gives q
# ids of 1 and kv ids marking each row's valid keys (the decode mode's
# SegmentIds(q=1, kv=kpos <= pos[b]), sequence.py:664-677).
LM_B, LM_L, LM_H, LM_D = 8, 2048, 8, 64
FLASH_SHAPES = (("lm_causal", LM_B, LM_L, LM_L, True, None),
                ("lm_segments", LM_B, LM_L, LM_L, True, "docs"),
                ("decode_kv_mask", LM_B, 256, 1024, False, "kv"),
                ("ragged_1000", LM_B, 1000, 1000, True, None),
                ("lm_causal_strided", LM_B, LM_L, LM_L, True, None))
# FLASH_SHAPES cases whose q, k and v are the qkv.unbind(2) views of one
# packed (B, L, 3, H, D) projection, as the LM passes them.
PACKED_QKV = ("lm_causal_strided",)

# The shape each kernel's headline numbers come from: the TPU probes' own
# shape for the conv kernels, the LM's for the attention kernels.
HEADLINE = {"conv3x3_same": "stage3", "bn_relu_conv3x3_stats": "stage3",
            "flash_attention_fwd": "lm_causal",
            "flash_attention_bwd_dkv": "lm_causal",
            "flash_attention_bwd_dq": "lm_causal",
            "flash_decode": "b64"}
# The decode phase: the serving LM's ring length and decode batches.
DECODE_T = 2048
DECODE_BATCHES = (1, 16, 64, 256)

_FA_LIB = "jax/experimental/pallas/ops/tpu/flash_attention.py"
KERNELS = {
    "conv3x3_same": {
        "route": "cuda",
        "source": "kf_benchmarks_tpu_torch/csrc/conv3x3_same.cu",
        "replaces": "experiments/pallas_conv_probe.py:35",
    },
    "bn_relu_conv3x3_stats": {
        "route": "cuda",
        "source": "kf_benchmarks_tpu_torch/csrc/bn_relu_conv3x3_stats.cu",
        "replaces": "experiments/pallas_fused_chain_probe.py:129 and "
                    "experiments/pallas_stage2_probe.py:112",
    },
    "flash_attention_fwd": {
        "route": "cuda",
        "source": "kf_benchmarks_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": f"{_FA_LIB}:589 (_flash_attention_impl, pallas_call "
                    ":758), via kf_benchmarks_tpu/parallel/sequence.py:763",
    },
    "flash_attention_bwd_dkv": {
        "route": "cuda",
        "source": "kf_benchmarks_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": f"{_FA_LIB}:941 (_flash_attention_bwd_dkv, pallas_call "
                    ":1121), via kf_benchmarks_tpu/parallel/sequence.py:763",
    },
    "flash_attention_bwd_dq": {
        "route": "cuda",
        "source": "kf_benchmarks_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": f"{_FA_LIB}:1287 (_flash_attention_bwd_dq, pallas_call "
                    ":1456), via kf_benchmarks_tpu/parallel/sequence.py:763",
    },
    "flash_decode": {
        "route": "cuda",
        "source": "kf_benchmarks_tpu_torch/csrc/flash_decode.cu",
        "replaces": f"{_FA_LIB}:589 (_flash_attention_impl, pallas_call "
                    ":758) in decode mode, via kf_benchmarks_tpu/parallel/"
                    "sequence.py:554 decode_attention (:664-677)",
    },
}


def log(msg: str) -> None:
  print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
  """Mean device time of fn() over iters launches, by CUDA events."""
  for _ in range(warmup):
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


def bound(flops: float, nbytes: float):
  """(bound_ms, bound_by): the larger of the operations and bytes lines."""
  t_ops = flops / PEAK_BF16_FLOPS * 1e3
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def conv_cost(n, h, w, c, co, extra_bytes=0):
  flops = 2.0 * n * h * w * 9 * c * co
  nbytes = 2.0 * (n * h * w * c + 9 * c * co + n * h * w * co) + extra_bytes
  return bound(flops, nbytes)


def reset_launches() -> None:
  """Every hand-written kernel's launch count to 0."""
  from kf_benchmarks_tpu_torch.ops import conv_bn, flash_attention
  conv_bn.reset_launches()
  flash_attention.reset_launches()


def check(ok: bool, what: str) -> None:
  if not ok:
    raise AssertionError(what)


def inputs(n, h, w, c, co, seed):
  g = torch.Generator(device="cuda").manual_seed(seed)
  x = torch.randn(n, h, w, c, generator=g, device="cuda").to(torch.bfloat16)
  wt = (torch.randn(3, 3, c, co, generator=g, device="cuda") *
        (2.0 / (9 * c)) ** 0.5).to(torch.bfloat16)
  sc = torch.rand(c, generator=g, device="cuda") + 0.5
  sh = torch.randn(c, generator=g, device="cuda") * 0.5
  return x, wt, sc, sh


def bf16_close(out, ref):
  """Max abs error and the check used for a bf16 output against its plain
  version on the same bf16 inputs: both are roundings of f32 sums that
  differ only in order, so an element may differ by one bf16 ulp
  (<= 2^-7 |ref|), plus 1e-3 of the largest output for sums that cancel."""
  out, ref = out.float(), ref.float()
  err = (out - ref).abs()
  tol = 2.0 ** -7 * ref.abs() + 1e-3 * ref.abs().max()
  return float(err.max()), bool((err <= tol).all())


# -- phases --------------------------------------------------------------------

# The libraries redesigned for Hopper's wgmma and TMA: the build phase
# reads their SASS and holds every kernel function in them to at least one
# HGMMA and one TMA load, and ptxas to no spills. SM90_HELPERS names the
# helper kernels there that run no product (K-B's fixed-order sum of its
# statistics partials), which are exempt from the HGMMA/TMA rule.
SM90_KERNELS = ("conv3x3_same", "bn_relu_conv3x3_stats",
                "flash_attention_fwd", "flash_attention_bwd")
SM90_HELPERS = ("reduce_partials",)
# The decode kernel streams K and V with plain 16-byte loads (no products
# worth a tensor core at one query row): its SASS counts are printed, and
# ptxas must report no spill.
PLAIN_LOAD_KERNELS = ("flash_decode",)


def sass_counts(so_path):
  """{function: {instruction: count}} of HGMMA, UTMALDG, LDGSTS and LDG in
  a built library, read with the cuobjdump beside nvcc; None when there is
  no cuobjdump."""
  from kf_benchmarks_tpu_torch.ops import _build
  tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
  if not os.path.exists(tool):
    return None
  out = subprocess.run([tool, "-sass", so_path], capture_output=True,
                       text=True, check=True).stdout
  counts, fn = {}, None
  for line in out.splitlines():
    if "Function :" in line:
      fn = line.split("Function :", 1)[1].strip()
      counts[fn] = {"HGMMA": 0, "UTMALDG": 0, "LDGSTS": 0, "LDG": 0}
    elif fn is not None:
      for op in counts[fn]:
        if op + "." in line or op + " " in line:
          counts[fn][op] += 1
  return counts


def phase_build(res):
  from kf_benchmarks_tpu_torch.ops import _build
  t0 = time.time()
  out_dir = _build.build_all()
  for name in _build._SIGNATURES:
    _build.load(name)
  log(f"build: {time.time() - t0:.1f} s into {out_dir}")
  for name in sorted(_build._SIGNATURES):
    with open(os.path.join(out_dir, name + ".log")) as f:
      for line in f:
        if "registers" in line or "spill" in line or (
            name in SM90_KERNELS and ("warning" in line or
                                      "Compiling entry" in line)):
          log(f"build: {name}: {line.strip()}")
  for name in SM90_KERNELS + PLAIN_LOAD_KERNELS:
    counts = sass_counts(os.path.join(out_dir, name + ".so"))
    if counts is None:
      log(f"build: {name}: sass: no cuobjdump beside nvcc, SASS not read")
      continue
    for fn, c in counts.items():
      log(f"build: {name}: sass {fn}: HGMMA {c['HGMMA']}, UTMALDG "
          f"{c['UTMALDG']}, LDGSTS {c['LDGSTS']}, LDG {c['LDG']}")
    if name in PLAIN_LOAD_KERNELS:
      continue
    lacking = {fn: c for fn, c in counts.items()
               if (c["HGMMA"] == 0 or c["UTMALDG"] == 0) and
               not any(helper in fn for helper in SM90_HELPERS)}
    check(counts and not lacking,
          f"build: {name}: kernels without wgmma or TMA loads: {lacking}")
  for name in SM90_KERNELS + PLAIN_LOAD_KERNELS:
    with open(os.path.join(out_dir, name + ".log")) as f:
      spills = [line.strip() for line in f if re.search(
          r"[1-9]\d* bytes spill (stores|loads)", line)]
    check(not spills, f"build: {name} spills: {spills}")


def phase_conv(res):
  """K-A against its plain version; timed, as the main path calls it, on
  the K-major weights (the backward makes them), beside F.conv2d."""
  from kf_benchmarks_tpu_torch.ops import conv_bn
  shapes = []
  for i, (stage, n, h, w, c) in enumerate(STAGES):
    x, wt, _, _ = inputs(n, h, w, c, c, seed=10 + i)
    w_k = conv_bn.kmajor(wt)
    y = conv_bn.conv3x3_same(x, wt)
    ref = conv_bn.conv3x3_same_plain(x, wt)
    torch.cuda.synchronize()
    err, ok = bf16_close(y, ref)
    rel = err / float(ref.float().abs().max())
    check(ok, f"conv3x3_same {stage}: max abs err {err} out of tolerance")
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    ms = time_ms(lambda: conv_bn.conv3x3_same_kmajor(x, w_k))
    plain_ms = time_ms(lambda: conv_bn.conv3x3_same_plain(x, wt), iters=5)
    lib_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1))
    b_ms, b_by = conv_cost(n, h, w, c, c)
    shapes.append(dict(stage=stage, shape=[n, h, w, c, c], max_abs_err=err,
                       max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       library="F.conv2d (cuDNN)"))
    log(f"conv: {stage} x[{n},{h},{w},{c}] w[3,3,{c},{c}]: max abs err "
        f"{err:.3g} (rel {rel:.2g}; tol 2^-7|ref| + 1e-3 max|ref|) "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, F.conv2d "
        f"{lib_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    del x, wt, w_k, y, ref
  res["conv3x3_same"] = shapes


def phase_conv_tiles(res):
  """Not in the default run: K-A at every tile shape it instantiates, each
  with the A box the cost model gives it, at every STAGES shape, beside the
  shape's pick and F.conv2d -- the data conv_bn.conv_tile's cost is fitted
  to; then K-B the same way over its own tiles (conv_bn.kb_tile), each
  checked against its plain version."""
  from kf_benchmarks_tpu_torch.ops import conv_bn
  all_tiles = conv_bn.CONV_TILES
  for i, (stage, n, h, w, c) in enumerate(STAGES):
    x, wt, _, _ = inputs(n, h, w, c, c, seed=10 + i)
    w_k = conv_bn.kmajor(wt)
    ref = conv_bn.conv3x3_same_plain(x, wt)
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    lib_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1))
    pick = tuple(conv_bn.conv_tile(n, h, w, c, 132))[:5]
    parts = [f"F.conv2d {lib_ms:.4f} ms", f"pick {pick}"]
    for bm, bn in all_tiles:
      if c % bn:
        continue
      conv_bn.CONV_TILES = ((bm, bn),)
      conv_bn.conv_tile.cache_clear()
      t = conv_bn.conv_tile(n, h, w, c, 132)
      y = conv_bn.conv3x3_same_kmajor(x, w_k)
      torch.cuda.synchronize()
      err, ok = bf16_close(y, ref)
      check(ok, f"conv_tiles {stage} {bm}x{bn}: max abs err {err}")
      ms = time_ms(lambda: conv_bn.conv3x3_same_kmajor(x, w_k))
      parts.append(f"{bm}x{bn} box {t.wb}x{t.hb}x{t.nb} {ms:.4f} ms")
    conv_bn.CONV_TILES = all_tiles
    conv_bn.conv_tile.cache_clear()
    log(f"conv_tiles: {stage}: " + " | ".join(parts))
    del ref
    _, _, sc, sh = inputs(n, h, w, c, c, seed=20 + i)
    y_ref, _ = conv_bn.bn_relu_conv3x3_stats_plain(x, sc, sh, wt)
    kb_all = conv_bn.KB_TILES
    parts = [f"pick {tuple(conv_bn.kb_tile(n, h, w, c, 132))[:5]}"]
    for bm, bn in kb_all:
      if c % bn:
        continue
      conv_bn.KB_TILES = ((bm, bn),)
      conv_bn.kb_tile.cache_clear()
      t = conv_bn.kb_tile(n, h, w, c, 132)
      y, _ = conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w_k)
      torch.cuda.synchronize()
      err, ok = bf16_close(y, y_ref)
      check(ok, f"kb_tiles {stage} {bm}x{bn}: max abs err {err}")
      ms = time_ms(lambda: conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w_k))
      parts.append(f"{bm}x{bn} box {t.wb}x{t.hb}x{t.nb} {ms:.4f} ms")
    conv_bn.KB_TILES = kb_all
    conv_bn.kb_tile.cache_clear()
    log(f"kb_tiles: {stage}: " + " | ".join(parts))
    del x, wt, w_k, y_ref


def _bn_relu_stats_library(x_nchw, w_oihw, sc, sh):
  """cuDNN conv plus PyTorch BN-apply, ReLU and statistics: the unit as
  library calls, a yardstick only."""
  xn = torch.relu(x_nchw.float() * sc[:, None, None] + sh[:, None, None])
  y = F.conv2d(xn.to(torch.bfloat16), w_oihw, padding=1)
  yf = y.float()
  return y, torch.stack([yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))])


def phase_unit(res):
  """K-B against its plain version at every STAGES shape (sh ~ N(0, 0.5):
  about half the channels have relu(sh) > 0, so a padding row left at
  relu(sh) instead of 0 fails the y check), two launches bitwise equal;
  timed through the one entry the fused unit calls, on the K-major weights
  the ResNet builds in its bf16 cast, beside the library composition.
  Then the Function's gradients at batch 32."""
  from kf_benchmarks_tpu_torch.ops import conv_bn
  shapes = []
  for i, (stage, n, h, w, c) in enumerate(STAGES):
    x, wt, sc, sh = inputs(n, h, w, c, c, seed=20 + i)
    w_k = conv_bn.kmajor(wt)
    y, st = conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w_k)
    y2, st2 = conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w_k)
    y_ref, st_ref = conv_bn.bn_relu_conv3x3_stats_plain(x, sc, sh, wt)
    torch.cuda.synchronize()
    check(torch.equal(y, y2) and torch.equal(st, st2),
          f"bn_relu_conv3x3_stats {stage}: two launches differ")
    err, ok = bf16_close(y, y_ref)
    check(ok, f"bn_relu_conv3x3_stats {stage}: y max abs err {err}")
    # Statistics: f32 sums of the same bf16 values in another order, plus
    # the sums over elements whose bf16 y differs by one ulp.
    yf = y_ref.float()
    scale = torch.stack([yf.abs().sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
    st_err = float(((st - st_ref).abs() / scale.clamp_min(1e-30)).max())
    check(st_err <= 1e-3, f"bn_relu_conv3x3_stats {stage}: stats rel err "
          f"{st_err} > 1e-3")
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    ms = time_ms(lambda: conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w_k))
    plain_ms = time_ms(
        lambda: conv_bn.bn_relu_conv3x3_stats_plain(x, sc, sh, wt), iters=5)
    lib_ms = time_ms(lambda: _bn_relu_stats_library(x_nchw, w_oihw, sc, sh))
    b_ms, b_by = conv_cost(n, h, w, c, c, extra_bytes=4.0 * (2 * c + 2 * c))
    shapes.append(dict(stage=stage, shape=[n, h, w, c, c], max_abs_err=err,
                       stats_rel_err=st_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       library="F.conv2d (cuDNN) + torch BN-apply, ReLU "
                       "and statistics (no single call computes the unit)"))
    log(f"unit: {stage} x[{n},{h},{w},{c}]: y max abs err {err:.3g}, stats "
        f"rel err {st_err:.2g} (tol 1e-3), two launches bitwise equal; "
        f"tile {tuple(conv_bn.kb_tile(n, h, w, c, 132))}; kernel {ms:.3f} "
        f"ms, plain {plain_ms:.3f} ms, cuDNN conv + torch BN/ReLU/stats {lib_ms:.3f} "
        f"ms, bound {b_ms:.3f} ms ({b_by})")
    del x, wt, w_k, y, y2, y_ref
  res["bn_relu_conv3x3_stats"] = shapes

  # Gradients of the Function (K-B forward, K-A input gradient) against
  # autograd through the plain forward, same bf16 inputs, batch 32.
  # Tolerance: 3e-2 of each gradient's largest magnitude -- the two paths
  # round the bf16 cotangent and the bf16 input gradient at other places.
  for i, (stage, _, h, w, c) in enumerate(STAGES[:2]):
    x, wt, sc, sh = inputs(32, h, w, c, c, seed=30 + i)
    g = torch.Generator(device="cuda").manual_seed(40 + i)
    gy = torch.randn(32, h, w, c, generator=g, device="cuda").to(
        torch.bfloat16)
    gs = torch.randn(2, c, generator=g, device="cuda") * 1e-3

    def grads(fn):
      leaves = [t.clone().requires_grad_() for t in (x, sc, sh, wt)]
      y, st = fn(*leaves)
      loss = (y.float() * gy.float()).sum() + (st * gs).sum()
      return torch.autograd.grad(loss, leaves)

    got = grads(lambda x, sc, sh, w: conv_bn.fused_bn_relu_conv3x3(
        x, sc, sh, conv_bn.kmajor(w)))
    ref = grads(conv_bn.bn_relu_conv3x3_stats_plain)
    for label, a, b in zip(("x", "sc", "sh", "w"), got, ref):
      e = float((a.float() - b.float()).abs().max())
      m = float(b.float().abs().max())
      check(e <= 3e-2 * m, f"Function grad d{label} at {stage}: err {e} "
            f"> 3e-2 * {m}")
      log(f"unit: grad {stage} batch 32 d{label}: max abs err {e:.3g} "
          f"(max |ref| {m:.3g}, tol 3e-2 of it)")


def phase_train(res):
  """The port's main path as a user runs it, with the kernel launch counts
  set to 0 just before and read just after."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import params as params_lib
  from kf_benchmarks_tpu_torch.ops import conv_bn
  params = params_lib.make_params(
      model="resnet50", batch_size=256, use_fp16=True, optimizer="momentum",
      num_batches=20, num_warmup_batches=5, display_every=5, device="gpu")
  bench = benchmark.BenchmarkCNN(params)
  torch.cuda.reset_peak_memory_stats()
  reset_launches()
  stats = bench.run()
  counts = benchmark.kernel_launches()
  res["counts"].update({k: counts[k] for k in conv_bn.LAUNCHES})
  res.setdefault("counts_by_path", {})["train"] = counts
  res["train"] = stats
  steps = stats["steps_run"]
  log(f"train: {steps} steps (5 warmup + 20 timed), kernel launches "
      f"{counts}, peak memory "
      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
      f"{stats['images_per_sec']:.2f} images/sec")
  check(np.isfinite(stats["last_average_loss"]), "train: loss not finite")
  for name in conv_bn.LAUNCHES:
    check(counts[name] == 13 * steps,
          f"train: {name} launched {counts[name]} times in {steps} steps, "
          f"want 13 per step")


def phase_parity(res):
  """One training step at batch 8 from one init and one batch: the card
  (bf16, kernels) against the CPU (f32, plain versions), and against the
  card's plain-op path (bf16, cuDNN convs, no fused units)."""
  from kf_benchmarks_tpu_torch import optimizers
  from kf_benchmarks_tpu_torch import params as params_lib
  from kf_benchmarks_tpu_torch import train_step
  from kf_benchmarks_tpu_torch.models import resnet_model
  from kf_benchmarks_tpu_torch.ops import conv_bn
  model = resnet_model.create_resnet50_model()
  gen = torch.Generator().manual_seed(7)
  init = model.make_module(1001, torch.float32, generator=gen).state_dict()
  rng = np.random.default_rng(7)
  images = (np.clip(rng.normal(size=(8, 224, 224, 3)), -2, 2) * 60.0 +
            127.0).astype(np.float32)
  labels = rng.integers(0, 1001, 8)
  p = params_lib.make_params(optimizer="momentum", device="cpu")
  out = {}
  for arm, device, dtype, fused in (("card", "cuda", torch.bfloat16, True),
                                    ("card_plain", "cuda", torch.bfloat16,
                                     False),
                                    ("cpu", "cpu", torch.float32, True)):
    module = model.make_module(1001, dtype).to(device)
    module.load_state_dict(init)
    for block in module.blocks:
      block.fused = block.fused and fused
    opt = optimizers.get_optimizer(p, module.parameters())
    grads = {}

    def snapshot(*_):
      # Before the update: SGD's multi-tensor Nesterov path (the CUDA
      # default) adds the momentum buffer into .grad in place.
      grads.update({k: q.grad.detach().float().cpu()
                    for k, q in module.named_parameters()})

    opt.register_step_pre_hook(snapshot)
    step = train_step.TrainStep(model, module, opt, lambda s: 0.1, 4e-5)
    before = dict(conv_bn.LAUNCHES)
    m = step(torch.from_numpy(images).to(device),
             torch.from_numpy(labels).to(device))
    launched = {k: conv_bn.LAUNCHES[k] - before[k] for k in before}
    out[arm] = (float(m["base_loss"]), grads, launched)
  check(out["card"][2] == {"conv3x3_same": 13, "bn_relu_conv3x3_stats": 13},
        f"parity: card step launched {out['card'][2]}")
  check(sum(out["card_plain"][2].values()) == 0,
        "parity: plain-op arm launched a kernel")
  # Loss: bf16 activations through ~50 layers, ~2^-8 per rounding.
  loss = {arm: v[0] for arm, v in out.items()}
  for ref in ("cpu", "card_plain"):
    rel = abs(loss["card"] - loss[ref]) / abs(loss[ref])
    log(f"parity: cross-entropy card {loss['card']:.5f} {ref} "
        f"{loss[ref]:.5f} (rel {rel:.2g}, tol 2e-2)")
    check(rel <= 2e-2, f"parity: loss differs from {ref}")
  # Gradients. Below the classifier, much of the bf16 gradient at init is
  # rounding: batch norm cancels most of a raw-pixel ResNet's gradient,
  # and what is left is near the level of bf16 noise (cosines against f32
  # of ~0.1 for the early layers here at full size, printed for the
  # record). tests/test_torch_bf16_parity.py holds the port's bf16 path to
  # the JAX package's on the CPU at the (1, 2, 1, 1) net: there each
  # framework's cosines against its own f32 run agree within 0.1 for every
  # parameter, and a whole-model gradient scale fault fails it, though a
  # fault local to the early layers hides in bf16 noise at that size; the
  # JAX package's cosines at this full size are not measured. The
  # classifier's gradient is held: norm within 5e-2 and cosine >= 0.98
  # against both references.
  for key in ("conv_stem.weight", "blocks.1.b.weight", "blocks.7.b.weight",
              "blocks.13.b_bn.scale", "blocks.15.c.weight", "affine0.weight",
              "affine0.bias"):
    a = out["card"][1][key]
    parts = []
    for ref in ("cpu", "card_plain"):
      b = out[ref][1][key]
      n_rel = abs(float(a.norm()) - float(b.norm())) / float(b.norm())
      cos = float((a * b).sum() / (a.norm() * b.norm()))
      parts.append(f"{ref} {float(b.norm()):.4g} (rel {n_rel:.2g}, "
                   f"cosine {cos:.4f})")
      if key.startswith("affine0"):
        check(n_rel <= 5e-2 and cos >= 0.98,
              f"parity: classifier gradient {key} differs from {ref}")
    log(f"parity: grad norm {key}: card {float(a.norm()):.4g}, " +
        ", ".join(parts))


def profile_window(step, n):
  """(wall s of n calls of step() without the profiler, kernel s of n more
  under torch.profiler, the profile), after n warm calls."""
  from torch.profiler import ProfilerActivity, profile
  for _ in range(n):
    step()
  torch.cuda.synchronize()
  t0 = time.time()
  for _ in range(n):
    step()
  torch.cuda.synchronize()
  wall = time.time() - t0
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(n):
      step()
    torch.cuda.synchronize()
  device_us = sum(e.self_device_time_total for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
  return wall, device_us / 1e6, prof


def device_behind_spin_s(fn, n, wall_s):
  """(seconds, hidden): the card's time for n calls of fn() queued behind
  a spin kernel that outlasts their queueing (twice their wall without it,
  plus 50 ms), so that the card runs them back to back: their own device
  time, the gaps between their kernels included, with the host's share
  taken out. hidden is False where the spin ended before the host had
  queued them all (fn waits on the card, or its launches filled the
  launch queue): the card may then have waited on the host inside the
  span, which bounds its busy time from above."""
  cal0, cal1, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(4))
  cal0.record()
  torch.cuda._sleep(10 ** 7)
  cal1.record()
  torch.cuda.synchronize()
  cycles_per_ms = 1e7 / cal0.elapsed_time(cal1)
  torch.cuda._sleep(int(cycles_per_ms * (2e3 * wall_s + 50)))
  start.record()
  for _ in range(n):
    fn()
  end.record()
  hidden = not start.query()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / 1e3, hidden


def spin_share(device_s, hidden, wall_s):
  """The busy share device_s / wall_s as text, marked where it is only an
  upper bound."""
  return f"{device_s / wall_s:.3f}" + (
      "" if hidden else " (upper bound: the host queued past the spin)")


def kernel_of(symbol: str):
  """The hand-written kernel a CUDA kernel symbol of a trace belongs to,
  or None. K-A and K-B are one template (csrc/conv3x3_sm90.cuh) with the
  Identity and the BnRelu prologue; K-B's partial sums finish in
  reduce_partials_kernel."""
  if "conv3x3_wgmma_kernel" in symbol:
    return ("bn_relu_conv3x3_stats" if "BnRelu" in symbol
            else "conv3x3_same")
  for part, name in (("reduce_partials_kernel", "bn_relu_conv3x3_stats"),
                     ("flash_fwd_kernel", "flash_attention_fwd"),
                     ("flash_bwd_dkv_kernel", "flash_attention_bwd_dkv"),
                     ("flash_bwd_dq_kernel", "flash_attention_bwd_dq"),
                     ("flash_decode_kernel", "flash_decode")):
    if part in symbol:
      return name
  return None


def kernel_report(label, trace_path, top_n=40):
  """Prints the measured per-op table of the torch.profiler Chrome trace at
  trace_path (observability.measured_per_op_table: the table --tfprof_file
  writes) and each hand-written kernel's share of its kernel time; returns
  {kernel_s: summed kernel time, extent_s: first kernel's start to last
  kernel's end, shares: {kernel: share}}."""
  from kf_benchmarks_tpu_torch import observability
  kind, events = observability.load_trace_op_events(trace_path)
  check(kind == "kernel", f"{label}: the trace holds no kernel event")
  for line in observability.measured_per_op_table(
      trace_path, top_n=top_n).splitlines():
    log(f"{label}: " + line)
  total = sum(float(e["dur"]) for e in events)
  extent = (max(float(e["ts"]) + float(e["dur"]) for e in events) -
            min(float(e["ts"]) for e in events))
  ours = {}
  for e in events:
    name = kernel_of(e["name"])
    if name:
      ours[name] = ours.get(name, 0.0) + float(e["dur"])
  shares = {k: v / total for k, v in sorted(ours.items())}
  log(f"{label}: kernel time {total / 1e3:.3f} ms over a {extent / 1e3:.3f} "
      "ms extent (busy share of the extent "
      f"{total / max(extent, 1e-9):.4f}); shares of kernel time: " +
      ", ".join(f"{k} {v:.4f} ({ours[k] / 1e3:.3f} ms)"
                for k, v in shares.items()))
  return {"kernel_s": total / 1e6, "extent_s": extent / 1e6,
          "shares": shares}


def profile_steps(label, step, n=3):
  """torch.profiler over n calls of step() after n warm ones, its Chrome
  trace printed as kernel_report's table, with the busy share against the
  wall time of the same n calls run without the profiler."""
  wall, _, prof = profile_window(step, n)
  with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    rep = kernel_report(label, path)
  log(f"{label}: {n} calls, wall without the profiler {wall * 1e3:.1f} ms, "
      f"kernel time under it {rep['kernel_s'] * 1e3:.1f} ms (busy share "
      f"{rep['kernel_s'] / wall:.3f})")
  return rep


def phase_profile(res):
  """Not in the default run: torch.profiler over 3 steps of the ResNet-50
  path."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import params as params_lib
  params = params_lib.make_params(
      model="resnet50", batch_size=256, use_fp16=True, optimizer="momentum",
      device="gpu")
  _, step, images, labels = benchmark.BenchmarkCNN(params).build()
  profile_steps("profile", lambda: step(images, labels))


# -- flash attention -----------------------------------------------------------

def attn_segments(b, lq, lk, mask, seed):
  """(q_seg, kv_seg) int32 on the card for a FLASH_SHAPES mask kind, made
  with numpy from ``seed``."""
  if mask is None:
    return None, None
  rng = np.random.default_rng(seed)
  if mask == "docs":  # contiguous random-length documents, padding 0 last
    seg = np.zeros((b, lq), np.int32)
    for row in range(b):
      pos, doc = 0, 1
      while pos < lq - 64:
        n = int(rng.integers(16, 512))
        seg[row, pos:pos + n] = doc
        pos, doc = pos + n, doc + 1
    seg = torch.from_numpy(seg).to("cuda")
    return seg, seg
  last = rng.integers(lk // 4, lk, size=b)  # each row's last valid key
  kv = (np.arange(lk)[None, :] <= last[:, None]).astype(np.int32)
  return (torch.ones(b, lq, dtype=torch.int32, device="cuda"),
          torch.from_numpy(kv).to("cuda"))


def attn_inputs(b, lq, lk, seed, h=LM_H, d=LM_D):
  g = torch.Generator(device="cuda").manual_seed(seed)
  mk = lambda n: torch.randn(b, n, h, d, generator=g,
                             device="cuda").to(torch.bfloat16)
  return mk(lq), mk(lk), mk(lk), mk(lq)


def admissible_pairs(b, lq, lk, causal, q_seg, kv_seg):
  """(query, key) pairs the mask admits, over the batch: the work this
  run's data needs."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  mask = fa.admissible(lq, lk, causal, q_seg, kv_seg, device="cuda")
  if mask is None:
    return b * lq * lk
  return int(mask.expand(b, 1, lq, lk).sum())


def sdpa_mask(b, lq, lk, causal, q_seg, kv_seg):
  """(attn_mask, is_causal) for F.scaled_dot_product_attention."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  if q_seg is None:
    return None, causal
  return fa.admissible(lq, lk, causal, q_seg, kv_seg, device="cuda"), False


def phase_flash(res):
  """The forward kernel against its plain version; times against its
  bound, the plain version and F.scaled_dot_product_attention."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  shapes = []
  for i, (stage, b, lq, lk, causal, mask) in enumerate(FLASH_SHAPES):
    if stage in PACKED_QKV:
      g = torch.Generator(device="cuda").manual_seed(50 + i)
      qkv = torch.randn(b, lq, 3, LM_H, LM_D, generator=g,
                        device="cuda").to(torch.bfloat16)
      q, k, v = qkv.unbind(2)
    else:
      q, k, v, _ = attn_inputs(b, lq, lk, seed=50 + i)
    q_seg, kv_seg = attn_segments(b, lq, lk, mask, seed=60 + i)
    scale = LM_D ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, q_seg, kv_seg)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                  q_seg, kv_seg)
    torch.cuda.synchronize()
    err, ok = bf16_close(o, o_ref)
    check(ok, f"flash_attention_fwd {stage}: o max abs err {err}")
    # lse: f32 sums of the same exponentials in another order; relative to
    # max(|lse|, 1), as a row's lse may be near 0.
    lse_err = float(((lse - lse_ref).abs() /
                     lse_ref.abs().clamp_min(1.0)).max())
    check(lse_err <= 1e-3, f"flash_attention_fwd {stage}: lse rel err "
          f"{lse_err} > 1e-3")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    am, is_causal = sdpa_mask(b, lq, lk, causal, q_seg, kv_seg)
    ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal, scale,
                                                q_seg, kv_seg))
    plain_ms = time_ms(lambda: fa.flash_attention_fwd_plain(
        q, k, v, causal, scale, q_seg, kv_seg), iters=5)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=am, is_causal=is_causal, scale=scale))
    pairs = admissible_pairs(b, lq, lk, causal, q_seg, kv_seg)
    seg_bytes = 0 if q_seg is None else 4.0 * b * (lq + lk)
    b_ms, b_by = bound(4.0 * pairs * LM_H * LM_D,
                       2.0 * LM_H * LM_D * b * (2 * lq + 2 * lk) +
                       4.0 * b * LM_H * lq + seg_bytes)
    shapes.append(dict(stage=stage, shape=[b, lq, lk, LM_H, LM_D],
                       causal=causal, mask=mask, max_abs_err=err,
                       lse_rel_err=lse_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       library="F.scaled_dot_product_attention"))
    log(f"flash: {stage} q[{b},{lq},{LM_H},{LM_D}] kv len {lk} "
        f"causal={causal} mask={mask}: o max abs err {err:.3g} (tol one "
        f"bf16 ulp + 1e-3 max|ref|), lse rel err {lse_err:.2g} (tol 1e-3) "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA {lib_ms:.3f} ms, "
        f"bound {b_ms:.3f} ms ({b_by})")
    del q, k, v, o, o_ref
  res["flash_attention_fwd"] = shapes
  check_head_dim_128()


def check_head_dim_128():
  """The kernels' D = 128 instantiations (the TPU kernel takes D <= 128;
  the LM runs 64): forward and gradients against the plain versions at a
  small ragged shape with segment ids. Checked, not timed."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  b, t, h, d = 2, 300, 2, 128
  q, k, v, do = attn_inputs(b, t, t, seed=80, h=h, d=d)
  seg, _ = attn_segments(b, t, t, "docs", seed=81)
  o, _ = fa.flash_attention_fwd(q, k, v, True, d ** -0.5, seg, seg)
  o_ref, _ = fa.flash_attention_fwd_plain(q, k, v, True, d ** -0.5, seg, seg)
  err, ok = bf16_close(o, o_ref)
  check(ok, f"flash_attention_fwd D=128: o max abs err {err}")

  def grads(fn):
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    return torch.autograd.grad(fn(*leaves), leaves, do)

  got = grads(lambda *x: fa.flash_attention(*x, causal=True, q_seg=seg,
                                            kv_seg=seg))
  ref = grads(lambda *x: fa.flash_attention_fwd_plain(*x, True, None, seg,
                                                      seg)[0])
  errs = []
  for label, a, r in zip(("dq", "dk", "dv"), got, ref):
    e = float((a.float() - r.float()).abs().max())
    m = float(r.float().abs().max())
    check(e <= 3e-2 * m, f"flash D=128 {label}: err {e} > 3e-2 * {m}")
    errs.append(f"{label} {e:.3g} of {m:.3g}")
  log(f"flash: D=128 q[{b},{t},{h},{d}] causal, docs: o max abs err "
      f"{err:.3g}; grads max abs err {', '.join(errs)} (tol 3e-2 of max)")


def flash_grad_inputs(i, stage, b, lq, lk):
  """(q, k, v, do, qkv): seeded inputs of FLASH_SHAPES case i; for a
  PACKED_QKV case q, k, v are the qkv.unbind(2) views of one packed
  (B, L, 3, H, D) projection (qkv, else None), as the LM passes them."""
  q, k, v, do = attn_inputs(b, lq, lk, seed=70 + i)
  if stage not in PACKED_QKV:
    return q, k, v, do, None
  qkv = torch.stack((q, k, v), dim=2)
  return (*qkv.unbind(2), do, qkv)


def phase_flash_grad(res):
  """The Function's gradients (dK/dV and dQ kernels) against autograd
  through the plain forward at every FLASH_SHAPES case; two launches on
  the same inputs bitwise equal; at the headline shape the two backward
  kernels timed against their bounds, their plain versions and the SDPA
  backward, beside the plain di op."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  dkv_rows, dq_rows = [], []
  for i, (stage, b, lq, lk, causal, mask) in enumerate(FLASH_SHAPES):
    q, k, v, do, qkv = flash_grad_inputs(i, stage, b, lq, lk)
    q_seg, kv_seg = attn_segments(b, lq, lk, mask, seed=60 + i)
    scale = LM_D ** -0.5

    def grads(fn):
      if qkv is not None:  # through the views, as the LM's backward runs
        leaf = qkv.clone().requires_grad_()
        return torch.autograd.grad(fn(*leaf.unbind(2)), leaf,
                                   do)[0].unbind(2)
      leaves = [t.clone().requires_grad_() for t in (q, k, v)]
      return torch.autograd.grad(fn(*leaves), leaves, do)

    got = grads(lambda *x: fa.flash_attention(*x, causal=causal,
                                              scale=scale, q_seg=q_seg,
                                              kv_seg=kv_seg))
    ref = grads(lambda *x: fa.flash_attention_fwd_plain(
        *x, causal, scale, q_seg, kv_seg)[0])
    errs = {}
    # 3e-2 of each gradient's largest magnitude: the two paths round P and
    # dS to bf16 at other places (the plain autograd rounds neither).
    for label, a, r in zip(("dq", "dk", "dv"), got, ref):
      e = float((a.float() - r.float()).abs().max())
      m = float(r.float().abs().max())
      errs[label] = e
      check(math.isfinite(e) and e <= 3e-2 * m,
            f"flash_grad {stage} {label}: err {e} > 3e-2 * {m}")
      log(f"flash_grad: {stage} {label}: max abs err {e:.3g} (max |ref| "
          f"{m:.3g}, tol 3e-2 of it)")
    del got, ref

    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, q_seg, kv_seg)
    di_op = lambda: (o.float() * do.float()).sum(-1).transpose(
        1, 2).contiguous()
    di = di_op()
    args = (q, k, v, do, lse, di, causal, scale, q_seg, kv_seg)
    # No atomics: each block owns its output rows, so two launches on the
    # same inputs give the same bits.
    first = (*fa.flash_attention_bwd_dkv(*args), fa.flash_attention_bwd_dq(
        *args))
    again = (*fa.flash_attention_bwd_dkv(*args), fa.flash_attention_bwd_dq(
        *args))
    for label, a, r in zip(("dk", "dv", "dq"), first, again):
      check(torch.equal(a, r), f"flash_grad {stage} {label}: two launches "
            f"differ")
    log(f"flash_grad: {stage}: dK, dV, dQ of two launches bitwise equal")
    del first, again
    base = dict(stage=stage, shape=[b, lq, lk, LM_H, LM_D], causal=causal,
                mask=mask)
    if stage != HEADLINE["flash_attention_bwd_dkv"]:
      dkv_rows.append(dict(base, max_abs_err=max(errs["dk"], errs["dv"])))
      dq_rows.append(dict(base, max_abs_err=errs["dq"]))
      continue

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    am, is_causal = sdpa_mask(b, lq, lk, causal, q_seg, kv_seg)
    out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                         is_causal=is_causal, scale=scale)
    do_t = do.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), do_t,
                                                 retain_graph=True))
    di_ms = time_ms(di_op)
    pairs = admissible_pairs(b, lq, lk, causal, q_seg, kv_seg)
    elems = LM_H * LM_D * b
    in_bytes = 2.0 * elems * (2 * lq + 2 * lk) + 8.0 * b * LM_H * lq
    for name, rows, fn, plain, products, out_bytes in (
        ("flash_attention_bwd_dkv", dkv_rows, fa.flash_attention_bwd_dkv,
         fa.flash_attention_bwd_dkv_plain, 4, 4.0 * elems * lk),
        ("flash_attention_bwd_dq", dq_rows, fa.flash_attention_bwd_dq,
         fa.flash_attention_bwd_dq_plain, 3, 2.0 * elems * lq)):
      ms = time_ms(lambda: fn(*args))
      plain_ms = time_ms(lambda: plain(*args), iters=5)
      # The kernel's own products: S, dP and dV, dK (dK/dV) or dQ (dQ).
      b_ms, b_by = bound(2.0 * products * pairs * LM_H * LM_D,
                         in_bytes + out_bytes)
      rows.append(dict(base,
                       max_abs_err=errs["dq"] if name.endswith("dq") else
                       max(errs["dk"], errs["dv"]), ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms,
                       library="SDPA backward (dQ, dK and dV together)"))
      log(f"flash_grad: {stage} {name}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, SDPA backward {lib_ms:.3f} ms, bound "
          f"{b_ms:.3f} ms ({b_by})")
    # The backward as one function: five products over the admissible
    # pairs (S, dP, dV, dK, dQ), 2.5 x the forward's work.
    both_ms, both_by = bound(10.0 * pairs * LM_H * LM_D, in_bytes +
                             2.0 * elems * (lq + 2 * lk))
    pair_ms = dkv_rows[-1]["ms"] + dq_rows[-1]["ms"]
    log(f"flash_grad: {stage} backward (dK/dV + dQ) kernels "
        f"{pair_ms:.3f} ms ({pair_ms / lib_ms:.2f}x the SDPA backward "
        f"{lib_ms:.3f} ms), plain di op {di_ms:.3f} ms, bound "
        f"{both_ms:.3f} ms ({both_by})")
    del out, qt, kt, vt
  res["flash_attention_bwd_dkv"] = dkv_rows
  res["flash_attention_bwd_dq"] = dq_rows


# -- transformer LM ------------------------------------------------------------

@contextlib.contextmanager
def lm_attention(impl):
  """KF_TRANSFORMER_LM_ATTN set to ``impl`` inside the block."""
  saved = os.environ.get("KF_TRANSFORMER_LM_ATTN")
  os.environ["KF_TRANSFORMER_LM_ATTN"] = impl
  try:
    yield
  finally:
    if saved is None:
      os.environ.pop("KF_TRANSFORMER_LM_ATTN", None)
    else:
      os.environ["KF_TRANSFORMER_LM_ATTN"] = saved


def lm_params(**kw):
  from kf_benchmarks_tpu_torch import params as params_lib
  return params_lib.make_params(model="transformer_lm", use_fp16=True,
                                device="gpu", **kw)


def phase_lm_train(res):
  """The LM's training path as a user runs it (flash attention), with every
  launch count set to 0 just before and read just after."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch.models import transformer_lm as lm
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  with lm_attention("flash"):
    bench = benchmark.BenchmarkCNN(lm_params(
        num_batches=20, num_warmup_batches=5, display_every=5))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stats = bench.run()
    counts = benchmark.kernel_launches()
  res["counts"].update({k: counts[k] for k in fa.LAUNCHES})
  res.setdefault("counts_by_path", {})["lm_train"] = counts
  res["lm_train"] = stats
  steps = stats["steps_run"]
  seq_per_s = stats["images_per_sec"]
  log(f"lm_train: {steps} steps (5 warmup + 20 timed), kernel launches "
      f"{counts}, peak memory "
      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
      f"{seq_per_s:.2f} sequences/sec, {seq_per_s * lm.SEQ_LEN:.0f} "
      f"tokens/sec, step {stats['average_wall_time'] * 1e3:.2f} ms")
  check(np.isfinite(stats["last_average_loss"]), "lm_train: loss not finite")
  # Per step: 6 forward launches, 6 more when each block's checkpoint
  # recomputes it in the backward, and one dK/dV and one dQ per layer.
  want = {"flash_attention_fwd": 12, "flash_attention_bwd_dkv": 6,
          "flash_attention_bwd_dq": 6, "conv3x3_same": 0,
          "bn_relu_conv3x3_stats": 0, "flash_decode": 0}
  for name, per_step in want.items():
    check(counts[name] == per_step * steps,
          f"lm_train: {name} launched {counts[name]} times in {steps} "
          f"steps, want {per_step} per step")


def lm_batch(b, seed, packed=False):
  """Tokens (or the packed (B, 3, T) stack) and next-token labels, numpy."""
  from kf_benchmarks_tpu_torch.models import transformer_lm as lm
  rng = np.random.default_rng(seed)
  tokens = rng.integers(0, lm.VOCAB, (b, lm.SEQ_LEN))
  if not packed:
    return tokens, np.roll(tokens, -1, axis=1)
  seg = np.zeros((b, lm.SEQ_LEN), np.int64)
  pos = np.zeros((b, lm.SEQ_LEN), np.int64)
  for row in range(b):
    at, doc = 0, 1
    while at < lm.SEQ_LEN - 100:
      n = min(int(rng.integers(50, 700)), lm.SEQ_LEN - 100 - at)
      seg[row, at:at + n] = doc
      pos[row, at:at + n] = np.arange(n)
      at, doc = at + n, doc + 1
  labels = np.where(seg == np.roll(seg, -1, axis=1),
                    np.roll(tokens, -1, axis=1), 0)
  return np.stack([tokens, seg, pos], axis=1), labels


def phase_lm_parity(res):
  """One LM step at batch 2, full width and depth, from one init and one
  batch: the card with the flash kernels (bf16), the card's tiled plain
  ops (bf16) and the CPU with the plain versions (f32); then one packed
  forward on the card against the CPU."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch.models import transformer_lm as lm
  model = lm.TransformerLMModel()
  with lm_attention("flash"):
    init = model.make_module(0, torch.float32, torch.Generator().manual_seed(
        5)).state_dict()
  tokens, labels = lm_batch(2, seed=11)
  out = {}
  for arm, device, dtype, impl in (("card", "cuda", torch.bfloat16, "flash"),
                                   ("card_plain", "cuda", torch.bfloat16,
                                    "tiled"),
                                   ("cpu", "cpu", torch.float32, "flash")):
    with lm_attention(impl):
      module = model.make_module(0, dtype).to(device)
    module.load_state_dict(init)
    before = benchmark.kernel_launches()
    loss = model.loss_function(module(torch.from_numpy(tokens).to(device)),
                               torch.from_numpy(labels).to(device))
    names, leaves = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    launched = {k: v - before[k] for k, v in benchmark.kernel_launches().items()}
    out[arm] = (float(loss.detach()), {n: g.detach().float().cpu()
                              for n, g in zip(names, grads)}, launched)
    del module, grads
  check(out["card"][2] == {"conv3x3_same": 0, "bn_relu_conv3x3_stats": 0,
                           "flash_attention_fwd": 12,
                           "flash_attention_bwd_dkv": 6,
                           "flash_attention_bwd_dq": 6,
                           "flash_decode": 0},
        f"lm_parity: card step launched {out['card'][2]}")
  check(sum(out["card_plain"][2].values()) == 0,
        "lm_parity: tiled arm launched a kernel")
  # Loss: bf16 activations through 6 blocks and a 32768-way softmax.
  for ref in ("cpu", "card_plain"):
    rel = abs(out["card"][0] - out[ref][0]) / abs(out[ref][0])
    log(f"lm_parity: cross-entropy card {out['card'][0]:.5f} {ref} "
        f"{out[ref][0]:.5f} (rel {rel:.2g}, tol 2e-2)")
    check(rel <= 2e-2, f"lm_parity: loss differs from {ref}")
  for key in ("lm_head", "embed.weight", "pos_embedding", "blocks.0.qkv.weight",
              "blocks.5.attn_out.weight", "blocks.5.mlp_down.weight",
              "ln_f.weight"):
    a = out["card"][1][key].double()  # f64: a cosine over 16.8M terms
    parts = []
    for ref in ("cpu", "card_plain"):
      r = out[ref][1][key].double()
      n_rel = abs(float(a.norm()) - float(r.norm())) / float(r.norm())
      cos = float((a * r).sum() / (a.norm() * r.norm()))
      parts.append(f"{ref} {float(r.norm()):.4g} (rel {n_rel:.2g}, "
                   f"cosine {cos:.4f})")
      if key in ("lm_head", "embed.weight"):
        check(n_rel <= 5e-2 and cos >= 0.98,
              f"lm_parity: gradient {key} differs from {ref}")
    log(f"lm_parity: grad norm {key}: card {float(a.norm()):.4g}, " +
        ", ".join(parts))

  # One packed forward (numpy documents and positions): the kernels with
  # segment ids on the card against the plain versions on the CPU.
  packed, plabels = lm_batch(2, seed=12, packed=True)
  losses = {}
  for arm, device, dtype in (("card", "cuda", torch.bfloat16),
                             ("cpu", "cpu", torch.float32)):
    with lm_attention("flash"):
      module = model.make_module(0, dtype).to(device)
    module.load_state_dict(init)
    before = benchmark.kernel_launches()
    with torch.no_grad():
      losses[arm] = float(model.loss_function(
          module(torch.from_numpy(packed).to(device)),
          torch.from_numpy(plabels).to(device)))
    fwd = benchmark.kernel_launches()["flash_attention_fwd"] - \
        before["flash_attention_fwd"]
    if device == "cuda":
      check(fwd == 6, f"lm_parity: packed forward launched {fwd} forward "
            "kernels, want 6")
    del module
  rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
  log(f"lm_parity: packed forward cross-entropy card {losses['card']:.5f} "
      f"cpu {losses['cpu']:.5f} (rel {rel:.2g}, tol 2e-2)")
  check(rel <= 2e-2, "lm_parity: packed loss differs from the CPU")


# -- decode attention ----------------------------------------------------------

def decode_inputs(b, t, seed, h=LM_H, d=LM_D):
  """q (B, 1, H, D) as a view of a (B, 1, 3, H, D) projection, the layers of
  (L, B, T, H, D) K and V caches (as many as make up > 2x the 50 MB L2, so
  timings that cycle through them find each layer cold, as a decode step
  does), and pos (B,) int32 drawn from [0, 2T) with 0 (for B > 1) and
  T - 1 included: both unwrapped and wrapped rings."""
  g = torch.Generator(device="cuda").manual_seed(seed)
  per_layer = 2 * b * t * h * d * 2
  layers = max(2, -(-100 * 2**20 // per_layer))
  qkv = torch.randn(b, 1, 3, h, d, generator=g, device="cuda").to(
      torch.bfloat16)
  ck = torch.randn(layers, b, t, h, d, generator=g, device="cuda").to(
      torch.bfloat16)
  cv = torch.randn(layers, b, t, h, d, generator=g, device="cuda").to(
      torch.bfloat16)
  rng = np.random.default_rng(seed)
  pos = rng.integers(0, 2 * t, b)
  pos[-1] = t - 1
  if b > 1:
    pos[0] = 0
  pos = torch.from_numpy(pos.astype(np.int32)).to("cuda")
  return qkv[:, :, 0], ck, cv, pos


def time_layers_ms(fn, layers, iters=24):
  """time_ms of fn(layer) cycling through the cache layers."""
  it = [0]

  def step():
    fn(it[0] % layers)
    it[0] += 1

  return time_ms(step, iters=iters)


def graph_layers_ms(fn, layers, calls=24, replays=10):
  """Device-only time of one fn(layer) call: ``calls`` calls cycling
  through the cache layers, captured in one CUDA graph and replayed
  ``replays`` times between CUDA events, so no host work paces the
  launches (time_layers_ms times the same calls as the host issues them).
  The ctypes kernels launch on torch.cuda.current_stream(), which is the
  capture stream while capturing."""
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for j in range(3):
      fn(j % layers)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for j in range(calls):
      fn(j % layers)
  graph.replay()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(replays):
    graph.replay()
  end.record()
  torch.cuda.synchronize()
  ms = start.elapsed_time(end) / (replays * calls)
  del graph
  return ms


def check_decode_case(label, q, k, v, pos, scale):
  """flash_decode against its plain version, a second launch bitwise equal
  to the first, and with NaN in every slot past pos bit-identical to the
  clean run. Returns (o, max abs err)."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  o = fa.flash_decode(q, k, v, pos, scale)
  again = fa.flash_decode(q, k, v, pos, scale)
  o_ref = fa.flash_decode_plain(q, k, v, pos, scale)
  torch.cuda.synchronize()
  err, ok = bf16_close(o, o_ref)
  check(ok, f"flash_decode {label}: o max abs err {err} out of tolerance")
  check(torch.equal(o, again), f"flash_decode {label}: two launches differ")
  stale = ~fa.decode_admitted(pos, k.shape[1])
  k2, v2 = k.clone(), v.clone()
  k2[stale] = float("nan")
  v2[stale] = float("nan")
  o2 = fa.flash_decode(q, k2, v2, pos, scale)
  torch.cuda.synchronize()
  check(torch.equal(o, o2), f"flash_decode {label}: NaN past pos changed "
        "the output")
  del k2, v2
  return o, err


def phase_decode(res):
  """The decode kernel against its plain version at the serving LM's ring
  (T 2048, H 8, D 64) for B in DECODE_BATCHES: two launches bitwise equal,
  NaN past pos invisible, and the plain model of its cluster merge at the
  plan's split count; timed per call (as the host issues it) and on the
  device alone (graph replay) against the bound, the plain version and
  SDPA with the boolean kpos <= pos mask. Then D = 128 at the serving
  ring's B 16 and at a small ragged ring."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  n_sm = torch.cuda.get_device_properties(0).multi_processor_count
  rows = []
  scale = LM_D ** -0.5
  t, h, d = DECODE_T, LM_H, LM_D
  for i, b in enumerate(DECODE_BATCHES):
    q, ck, cv, pos = decode_inputs(b, t, seed=90 + i)
    layers = ck.shape[0]
    k, v = ck[1], cv[1]
    stage = f"b{b}"
    o, err = check_decode_case(stage, q, k, v, pos, scale)
    splits = fa.decode_plan(b, h, t, n_sm)
    merged = fa.decode_merge_plain(
        *fa.decode_partials_plain(q, k, v, pos, scale, splits),
        torch.bfloat16)
    merge_err, ok = bf16_close(o, merged)
    check(ok, f"flash_decode {stage}: max abs err {merge_err} against the "
          f"plain merge of {splits} splits")

    kl = lambda j: (ck[j], cv[j])
    call = lambda j: fa.flash_decode(q, *kl(j), pos, scale)
    ms = time_layers_ms(call, layers)
    dev_ms = graph_layers_ms(call, layers)
    plain_ms = time_layers_ms(
        lambda j: fa.flash_decode_plain(q, *kl(j), pos, scale), layers,
        iters=6)
    qt = q.transpose(1, 2)
    mask = fa.decode_admitted(pos, t)[:, None, None, :]
    sdpa = lambda j: F.scaled_dot_product_attention(
        qt, ck[j].transpose(1, 2), cv[j].transpose(1, 2), attn_mask=mask,
        scale=scale)
    lib_ms = time_layers_ms(sdpa, layers)
    lib_dev_ms = graph_layers_ms(sdpa, layers)
    # The work this run's data needs: the admitted slots only.
    admitted = int(torch.clamp(pos.long() + 1, max=t).sum())
    nbytes = 2.0 * 2 * b * h * d + 4.0 * b + 2.0 * 2 * admitted * h * d
    b_ms, b_by = bound(4.0 * admitted * h * d, nbytes)
    rows.append(dict(
        stage=stage, shape=[b, t, h, d], splits=splits, max_abs_err=err,
        merge_err=merge_err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
        library_device_ms=lib_dev_ms,
        library="F.scaled_dot_product_attention, boolean kpos <= pos mask"))
    log(f"decode: B {b} T {t} H {h} D {d} (S {splits}, {admitted} admitted "
        f"slots): o max abs err {err:.3g} (tol one bf16 ulp + 1e-3 "
        f"max|ref|), against the plain {splits}-split merge {merge_err:.3g}, "
        f"two launches bitwise equal, NaN past pos invisible; flash_decode "
        f"per call {ms:.4f} ms, device only (graph replay) {dev_ms:.4f} ms; "
        f"SDPA per call {lib_ms:.4f} ms, device only {lib_dev_ms:.4f} ms; "
        f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, "
        f"{b_ms / dev_ms:.0%} of it on the device)")
    del q, ck, cv, k, v
  res["flash_decode"] = rows
  # D = 128: the serving ring at B 16 (a head-dim-128 model's decode), and
  # a small ragged ring with strided layers.
  for label, (b, t_, h_, seed) in (("D=128 B 16", (16, DECODE_T, LM_H, 98)),
                                   ("D=128 ring 300", (4, 300, 2, 99))):
    q, ck, cv, pos = decode_inputs(b, t_, seed=seed, h=h_, d=128)
    _, err = check_decode_case(label, q, ck[1], cv[1], pos, 128 ** -0.5)
    log(f"decode: {label}: q[{b},1,{h_},128] ring {t_}: o max abs err "
        f"{err:.3g}, two launches bitwise equal, NaN past pos invisible")
    del q, ck, cv


def phase_lm_profile(res):
  """Not in the default run: torch.profiler over one dispatch of 3 captured
  LM training steps (flash attention; train_step.TrainChunk replays), the
  table of kernel time by name and the flash kernels' shares."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import train_step as train_step_lib
  with lm_attention("flash"):
    _, step, tokens, labels = benchmark.BenchmarkCNN(lm_params()).build()
    chunk = train_step_lib.TrainChunk(step, 3)
    chunk(tokens, labels, 3)  # the capture
    res["lm_profile"] = profile_steps(
        "lm_profile", lambda: chunk(tokens, labels, 3), n=1)



# -- serving -------------------------------------------------------------------

# The serving phases' LM: the zoo transformer_lm at full size (vocab 32768,
# d 512, 6 layers, 8 heads, d_ff 2048, ring 2048), bf16 over f32 params,
# flash attention, the default ladder (1, 4, 16, 64, 256).
# 32 requests: a quarter of the JAX bench's 128 (bench.py:336), a depth
# cut that keeps the whole run within its time limit.
SERVE_REQUESTS, SERVE_MAX_NEW = 32, 32
# (label, offered requests/s, queue bound): the JAX bench's own chip
# configuration (bench.py:336), and the capacity replay, which offers the
# same requests at once with a queue that sheds none.
SERVE_REPLAYS = (("offered", 16.0, 64), ("capacity", 1000.0, 128))


def serve_spec(impl="flash", dtype=torch.bfloat16):
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  return decode_lib.LMSpec(attn_impl=impl, dtype=dtype)


def phase_serve(res):
  """The port's serving engine as the serving bench drives it: warm() over
  the ladder, then each replay of the seeded poisson_workload with every
  launch count set to 0 just before and read just after."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import metrics as metrics_lib
  from kf_benchmarks_tpu_torch import tracing
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  from kf_benchmarks_tpu_torch.serving import engine as engine_lib
  spec = serve_spec()
  variables = decode_lib.init_variables(spec, seed=0)
  res["serve"] = {}
  for label, rate, depth in SERVE_REPLAYS:
    cfg = engine_lib.EngineConfig(spec=spec, max_new_tokens=SERVE_MAX_NEW,
                                  max_queue_depth=depth)
    workload = engine_lib.poisson_workload(SERVE_REQUESTS, rate, spec,
                                           seed=0,
                                           max_new_tokens=SERVE_MAX_NEW)
    trace = tracing.activate(tracing.RunTrace(keep_spans=True))
    metrics_lib.activate(metrics_lib.MetricRegistry())
    try:
      engine = engine_lib.ServingEngine(cfg, variables=variables,
                                        device="cuda")
      t0 = time.time()
      n_warm = engine.warm()
      warm_s = time.time() - t0
      torch.cuda.reset_peak_memory_stats()
      reset_launches()
      t0 = time.time()
      results = engine.replay(workload)
      wall = time.time() - t0
      counts = benchmark.kernel_launches()
      stats = engine.stats()
    finally:
      tracing.deactivate()
      metrics_lib.deactivate()
    waves = [s for s in trace.spans
             if (s["sub"], s["name"]) == ("serving", "prefill")]
    steps = stats["serving/decode_steps"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    res.setdefault("counts_by_path", {})[f"serve_{label}"] = counts
    res["serve"][label] = dict(stats=stats, waves=len(waves),
                               warm_s=warm_s, wall_s=wall, peak_gib=peak)
    log(f"serve: {label}: {SERVE_REQUESTS} requests at {rate:g}/s, "
        f"max_new_tokens {SERVE_MAX_NEW}, queue bound {depth}: warm() "
        f"prepared {n_warm} programs in {warm_s:.1f} s; replay {wall:.2f} s, "
        f"completed {stats['serving/completed']}, shed "
        f"{stats['serving/shed']}, {stats['serving/tokens_per_sec']:.1f} "
        f"tokens/sec, TTFT p50 {stats['serving/ttft_p50'] * 1e3:.1f} ms p99 "
        f"{stats['serving/ttft_p99'] * 1e3:.1f} ms, token latency p50 "
        f"{stats['serving/token_latency_p50'] * 1e3:.2f} ms p99 "
        f"{stats['serving/token_latency_p99'] * 1e3:.2f} ms, decode steps "
        f"{steps}, prefill waves {len(waves)} (pack buckets "
        f"{sorted(set(w['args']['bucket'] for w in waves))}), batch fill "
        f"{stats['serving/batch_fill_fraction']:.3f}, peak memory "
        f"{peak:.2f} GiB; launches {counts}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    check(stats["serving/completed"] == SERVE_REQUESTS and
          stats["serving/shed"] == 0,
          f"serve {label}: {stats['serving/completed']} completed, "
          f"{stats['serving/shed']} shed")
    for r in results:
      check(r.status == "ok" and len(r.tokens) == SERVE_MAX_NEW and
            all(0 <= t < spec.vocab for t in r.tokens),
            f"serve {label}: request {r.rid} gave {r.status} {r.tokens}")
    # 6 layers: each decode step launches the decode kernel once a layer,
    # each prefill wave the forward kernel once a layer; nothing else.
    want = {"flash_decode": 6 * steps, "flash_attention_fwd": 6 * len(waves)}
    for name, n in counts.items():
      check(n == want.get(name, 0), f"serve {label}: {name} launched {n} "
            f"times, want {want.get(name, 0)} ({steps} decode steps, "
            f"{len(waves)} prefill waves)")
  res["counts"]["flash_decode"] = \
      res["counts_by_path"]["serve_offered"]["flash_decode"]


def serve_logits(spec, variables, device, prompts, forced):
  """(first tokens (2,), per-step decode logits (2, 16, V) f32 on the CPU,
  the launch counts of the run): the two prompts packed into one row and
  prefilled, then the forced tokens decoded one step at a time."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch.data import packing
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  module = decode_lib.load_module(spec, variables, device)
  images, placements = packing.pack_prompts(list(prompts), spec.max_len, 2)
  rows = torch.tensor([p[0] for p in placements], dtype=torch.int32)
  offsets = torch.tensor([p[1] for p in placements], dtype=torch.int32)
  lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
  before = benchmark.kernel_launches()
  first, ek, ev = decode_lib.prefill_fn(spec)(
      module, torch.from_numpy(images).to(device), rows,
      offsets + lengths - 1, offsets)
  cache = decode_lib.install_prefill(
      decode_lib.init_cache(spec, 2, device), ek, ev, first, lengths,
      torch.arange(2, dtype=torch.int32))
  del ek, ev
  steps = []
  with torch.no_grad():
    for j in range(forced.shape[1]):
      tok = torch.from_numpy(forced[:, j]).to(device)
      logits, _ = module.decode(tok, cache.k, cache.v, cache.pos)
      steps.append(logits[:, 0].float().cpu())
      cache.pos.add_(1)
  launched = {k: v - before[k] for k, v in benchmark.kernel_launches().items()}
  return first.cpu(), torch.stack(steps, 1), launched, module


def logit_gap(a, r):
  """(max |a - r| / max |r|, cosine) over all logits, in f64."""
  a, r = a.double(), r.double()
  rel = float((a - r).abs().max() / r.abs().max())
  cos = float((a * r).sum() / (a.norm() * r.norm()))
  return rel, cos


def phase_serve_parity(res):
  """Two seeded 64-token prompts, packed and prefilled, then 16
  teacher-forced decode steps at full size: the card with the kernels
  (bf16), the card with the tiled plain ops (bf16) and the CPU (f32, plain)
  from one init; and the card's decode logits against the matching rows of
  the card's full forward (the KV-cache oracle)."""
  from kf_benchmarks_tpu_torch.models import transformer_lm as lm
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  rng = np.random.default_rng(21)
  prompts = rng.integers(0, lm.VOCAB, (2, 64)).astype(np.int32)
  forced = rng.integers(0, lm.VOCAB, (2, 16)).astype(np.int32)
  variables = decode_lib.init_variables(serve_spec(), seed=3)
  out = {}
  for arm, device, spec in (
      ("card", "cuda", serve_spec()),
      ("card_tiled", "cuda", serve_spec("tiled")),
      ("cpu", "cpu", serve_spec("flash", torch.float32))):
    first, logits, launched, module = serve_logits(spec, variables, device,
                                                   prompts, forced)
    out[arm] = (first, logits, launched)
    if arm == "card":
      seq = np.zeros((2, spec.max_len), np.int32)
      seq[:, :64], seq[:, 64:80] = prompts, forced
      module.fused_head = False
      with torch.no_grad():
        full, _ = module(torch.from_numpy(seq).to(device))
      oracle = full[:, 64:80].float().cpu()
      del full
    del module
  check(out["card"][2] == {"conv3x3_same": 0, "bn_relu_conv3x3_stats": 0,
                           "flash_attention_fwd": 6,
                           "flash_attention_bwd_dkv": 0,
                           "flash_attention_bwd_dq": 0,
                           "flash_decode": 6 * 16},
        f"serve_parity: card run launched {out['card'][2]}")
  check(sum(out["card_tiled"][2].values()) == 0,
        "serve_parity: tiled arm launched a kernel")
  # bf16 activations through 6 blocks and a 32768-wide head against f32 (or
  # another bf16 rounding order): max |delta| within 5e-2 of max |logit|,
  # cosine >= 0.999 over the 2 x 16 x 32768 logits.
  card = out["card"][1]
  for ref, r in (("cpu", out["cpu"][1]), ("card_tiled", out["card_tiled"][1]),
                 ("full_forward", oracle)):
    rel, cos = logit_gap(card, r)
    log(f"serve_parity: decode logits card vs {ref}: max |delta| / max "
        f"|logit| {rel:.3g} (max |logit| {float(r.abs().max()):.3g}), cosine "
        f"{cos:.6f} (tol 5e-2, 0.999)")
    check(rel <= 5e-2 and cos >= 0.999, f"serve_parity: card vs {ref}")
  agree = {arm: float((out[arm][1].argmax(-1) == card.argmax(-1)).double()
                      .mean()) for arm in ("cpu", "card_tiled")}
  log(f"serve_parity: prefill first tokens card {out['card'][0].tolist()} "
      f"cpu {out['cpu'][0].tolist()} card_tiled "
      f"{out['card_tiled'][0].tolist()}; greedy agreement of the 32 decode "
      f"steps with the card's: {agree}")


def phase_serve_profile(res):
  """Not in the default run: torch.profiler over 20 decode steps at bucket
  64, every slot decoding, with positions drawn like the workload's prompt
  lengths; printed as a kernel-time table and the busy share."""
  from kf_benchmarks_tpu_torch.data import packing
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  spec = serve_spec()
  module = decode_lib.load_module(
      spec, decode_lib.init_variables(spec, seed=0), "cuda")
  cache = decode_lib.init_cache(spec, 64, "cuda")
  g = torch.Generator(device="cuda").manual_seed(0)
  cache.k.normal_(generator=g)
  cache.v.normal_(generator=g)
  lengths = packing.sample_document_lengths(
      np.random.default_rng(0), 64, spec.max_len, mean_fraction=0.2)
  cache.pos.copy_(torch.from_numpy(lengths.astype(np.int32)))
  step = decode_lib.decode_fn(spec)
  active = torch.ones(64, dtype=torch.bool, device="cuda")
  state = {"tok": cache.tok, "pos": cache.pos}

  def one_step():
    nxt, _, _, pos = step(module, cache.k, cache.v, state["pos"],
                          state["tok"], active)
    nxt.cpu()  # the engine's value fetch
    state["tok"], state["pos"] = nxt, pos

  profile_steps("serve_profile", one_step, n=20)


# -- data parallel -------------------------------------------------------------

# (label, --variable_update flags, check against the single-device step:
# "bitwise", or the largest relative loss difference; a case with a packed
# path is also held to PACKED_WIRE_TOL).
DP_CASES = (
    ("replicated", dict(variable_update="replicated"), "bitwise"),
    ("kungfu_sync_sgd", dict(variable_update="kungfu",
                             kungfu_option="sync_sgd"), "bitwise"),
    ("kungfu_sma", dict(variable_update="kungfu", kungfu_option="sma"),
     "bitwise"),
    ("kungfu_async_sgd", dict(variable_update="kungfu",
                              kungfu_option="async_sgd"), "bitwise"),
    ("collective_psum_32k_rsag",
     dict(variable_update="collective_all_reduce",
          all_reduce_spec="psum:32k:rsag"), 1e-2),
    ("zero", dict(shard_optimizer_state=True), "bitwise"),
    ("zero_fsdp", dict(shard_optimizer_state=True, shard_params=True),
     "bitwise"),
    # The f32 wire: the bf16 one (--compact_gradient_transfer under
    # --use_fp16) rounds every gradient once, as the packed case above.
    ("overlap", dict(overlap_gradient_reduction=True,
                     compact_gradient_transfer=False), "bitwise"),
)
# transformer_lm at its published size (label, flags, check): the LM's FSDP
# step sums its block stack's L2 shard-locally and all-reduces it (the JAX
# package's _l2_loss_mixed), the exact value reassociated, so its losses
# and weights are held within DP_FSDP_LM_RTOL relative (the CPU test of the
# two-layer LM measures 9.6e-8 and 1.3e-8).
DP_LM_CASES = (
    ("lm_zero_fsdp", dict(shard_optimizer_state=True, shard_params=True),
     "rtol"),
    ("lm_overlap", dict(overlap_gradient_reduction=True,
                        compact_gradient_transfer=False), "bitwise"),
)
DP_FSDP_LM_RTOL = 1e-6
DP_STEPS = 3
# At world 1 the all_reduce of one rank is exact, so the packed path's one
# change is the bf16 wire: each gradient rounded to bf16 once, within the
# unit roundoff 2^-8 of itself relative (8 significant bits, round to
# nearest); the limit is twice that.
PACKED_WIRE_TOL = 2.0 ** -7


@contextlib.contextmanager
def packed_wire_errors(errors):
  """Holds every CollectivePlanner.reduce of the block against the
  per-tensor all-reduce mean (kungfu.allreduce_mean) of copies of the same
  gradients, and appends to ``errors`` each call's (largest elementwise
  error over |reference| (at least the smallest normal f32), relative L2
  distance)."""
  from kf_benchmarks_tpu_torch.ops import allreduce
  from kf_benchmarks_tpu_torch.parallel import kungfu
  orig = allreduce.CollectivePlanner.reduce

  def reduce(self, tensors):
    out = orig(self, tensors)
    ref = [t.detach().clone() for t in tensors]
    kungfu.allreduce_mean(ref)
    got = torch.cat([o.reshape(-1).float() for o in out])
    want = torch.cat([r.reshape(-1).float() for r in ref])
    diff = (got - want).abs()
    errors.append((float((diff / want.abs().clamp_min(2.0 ** -126)).max()),
                   float(diff.norm() / want.norm())))
    return out

  allreduce.CollectivePlanner.reduce = reduce
  try:
    yield errors
  finally:
    allreduce.CollectivePlanner.reduce = orig


def check_packed_wire(label, errors, steps):
  """Every step reduced through the planner, within PACKED_WIRE_TOL of the
  per-tensor mean elementwise and in L2, and not equal to it (the wire was
  compacted)."""
  check(len(errors) == steps,
        f"dp {label}: {len(errors)} packed reductions in {steps} steps")
  elem = [e for e, _ in errors]
  l2 = [d for _, d in errors]
  ok = all(e <= PACKED_WIRE_TOL for e in elem) and \
      all(0 < d <= PACKED_WIRE_TOL for d in l2)
  log(f"dp {label}: packed reduction against the per-tensor mean, {steps} "
      f"steps: largest elementwise relative error {elem!r}, relative L2 "
      f"{l2!r} (limit {PACKED_WIRE_TOL!r}, and > 0)")
  check(ok, f"dp {label}: the packed reduction is not the per-tensor mean "
        "on a bf16 wire")
  return {"max_elementwise_rel": elem, "rel_l2": l2}


def dp_params(**flags):
  from kf_benchmarks_tpu_torch import params as params_lib
  return params_lib.make_params(
      model="resnet50", batch_size=256, use_fp16=True, optimizer="momentum",
      num_batches=4, num_warmup_batches=2, display_every=10, device="gpu",
      **flags)


def dp_steps(params, info=None):
  """DP_STEPS steps of BenchmarkCNN's step from the seed: (losses, flat
  weights (gathered under --shard_params), the module), with the kernel
  launches of those steps. ``info`` (a dict) gets the peak memory the
  build and the steps added to what was allocated before them, and the
  step's bucket count."""
  from kf_benchmarks_tpu_torch import benchmark
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  # What earlier cases left allocated (communicator and graph-pool
  # blocks) is not this case's.
  base = torch.cuda.memory_allocated()
  module, step, images, labels = benchmark.BenchmarkCNN(params).build()
  before = benchmark.kernel_launches()
  losses = [float(step(images, labels)["total_loss"])
            for _ in range(DP_STEPS)]
  after = benchmark.kernel_launches()
  launched = {k: after[k] - before[k] for k in after}
  if info is not None:
    info["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    info["before_gib"] = base / 2**30
    info["buckets"] = dp_buckets(step)
  weights = torch.cat([q.reshape(-1) for q in step.full_weights()])
  return losses, weights, module, launched


def dp_buckets(step):
  """The buckets of the step's collectives: the in-backward reduction's,
  or the FSDP gathers' (builder-layer buckets and blocks), or under ZeRO
  alone its per-tensor scatters and gathers (the tensor count)."""
  if step._reducer is not None:
    return len(step._reducer.buckets)
  if step.sharding is None:
    return 0
  if step.sharding.shard_params:
    return len(step.sharding.buckets) + len(step.sharding.block_buckets)
  return len(step.sharding.shards)


def dp_chunk_steps(params):
  """The same DP_STEPS steps as one dispatch of BenchmarkCNN's TrainChunk
  at K = DP_STEPS (--steps_per_dispatch): its first step eager, the others
  replays of the captured step, collectives included. (losses, flat
  weights, launches)."""
  from kf_benchmarks_tpu_torch import benchmark, train_step
  _, step, images, labels = benchmark.BenchmarkCNN(params).build()
  chunk = train_step.TrainChunk(step, DP_STEPS)
  before = benchmark.kernel_launches()
  losses = chunk(images, labels, DP_STEPS)["total_loss"].tolist()
  after = benchmark.kernel_launches()
  weights = torch.cat([q.reshape(-1) for q in step.full_weights()])
  return losses, weights, {k: after[k] - before[k] for k in after}


def dp_images_per_sec(params):
  from kf_benchmarks_tpu_torch import benchmark
  stats = benchmark.BenchmarkCNN(params).run()
  check(np.isfinite(stats["last_average_loss"]), "dp: loss not finite")
  return stats


def check_dp_launches(label, launched, steps):
  for name in ("conv3x3_same", "bn_relu_conv3x3_stats"):
    check(launched.get(name) == 13 * steps,
          f"dp {label}: {name} launched {launched.get(name)} times in "
          f"{steps} steps, want 13 a step")


def phase_dp(res):
  """The data-parallel path at world 1 over NCCL against the single-device
  step of the same seed. Each strategy's 3 checked steps run in a group
  made here; its timed run goes through cli.rank_main, the entry every
  spawned rank runs (which makes and ends its own group)."""
  import torch.distributed as dist
  from kf_benchmarks_tpu_torch import benchmark, cli, train_step
  from kf_benchmarks_tpu_torch.ops import allreduce, conv_bn
  from kf_benchmarks_tpu_torch.parallel import kungfu, mesh
  check(not mesh.is_distributed(), "dp: a process group is already up")
  ref_info = {}
  ref_losses, ref_weights, _, launched = dp_steps(dp_params(), ref_info)
  check_dp_launches("single-device", launched, DP_STEPS)
  ref_ips = dp_images_per_sec(dp_params())["images_per_sec"]
  log(f"dp: single-device (no process group): losses {ref_losses}, "
      f"{ref_ips:.2f} images/sec")
  out = {"single_device_images_per_sec": ref_ips}
  reset_launches()
  total_steps = 0
  for label, flags, want in DP_CASES:
    params = dp_params(**flags)
    info = {}
    mesh.init_process_group("gpu", 1, 0, mesh.local_init_method())
    try:
      check(dist.get_backend() == "nccl", "dp: the group is not NCCL")
      wire_errors = []
      with (packed_wire_errors(wire_errors) if want != "bitwise"
            else contextlib.nullcontext()):
        losses, weights, module, launched = dp_steps(params, info)
      if want != "bitwise":
        out[f"{label}_packed_wire"] = check_packed_wire(label, wire_errors,
                                                        DP_STEPS)
      c_losses, c_weights, c_launched = dp_chunk_steps(params)
      check_dp_launches(f"{label} captured", c_launched, DP_STEPS)
      captured_ok = c_losses == losses and torch.equal(c_weights, weights)
      log(f"dp {label}: the {DP_STEPS} steps as one K={DP_STEPS} dispatch "
          f"(captured step, NCCL collectives in the graph): losses "
          f"{c_losses}, {'bitwise equal' if captured_ok else 'DIFFERENT'} "
          "against the eager steps")
      check(captured_ok, f"dp {label}: the captured steps differ")
      del c_weights
      if label == "replicated":
        # One reduction of the full gradient set: per tensor (the default
        # path), and packed by the spec planner (bf16 wire).
        grads = [q.grad for q in module.parameters()]
        stats = train_step.batch_stats(module)
        nbytes = sum(g.numel() * g.element_size() for g in grads)
        planner = allreduce.build_planner(dp_params(
            variable_update="collective_all_reduce",
            all_reduce_spec="psum:32k:rsag"))
        per_leaf_ms = time_ms(lambda: kungfu.allreduce_mean(grads), iters=10)
        packed_ms = time_ms(lambda: planner.reduce(grads), iters=10)
        stats_ms = time_ms(lambda: kungfu.allreduce_mean(stats), iters=10)
        log(f"dp reduction: {len(grads)} gradients, {nbytes / 1e6:.1f} MB: "
            f"per tensor {per_leaf_ms:.3f} ms, packed psum:32k:rsag (bf16 "
            f"wire) {packed_ms:.3f} ms; batch-norm statistics "
            f"({len(stats)} tensors) {stats_ms:.3f} ms")
        out["reduction"] = {"tensors": len(grads), "bytes": nbytes,
                            "per_tensor_ms": per_leaf_ms,
                            "packed_ms": packed_ms,
                            "batch_stats_ms": stats_ms}
      del module
    finally:
      mesh.destroy_process_group()
    check_dp_launches(label, launched, DP_STEPS)
    if want == "bitwise":
      ok = losses == ref_losses and torch.equal(weights, ref_weights)
      verdict = "bitwise equal" if ok else "DIFFERENT"
    else:
      rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
      ok = rel <= want and bool(torch.isfinite(weights).all())
      verdict = f"losses within {rel:.3g} (tol {want:g})"
    del weights
    log(f"dp {label}: NCCL world 1, losses {losses}: {verdict} against "
        "the single-device step")
    check(ok, f"dp {label}: differs from the single-device step")
    before = benchmark.kernel_launches()
    stats = cli.rank_main(0, params, mesh.local_init_method())
    after = benchmark.kernel_launches()
    check(not mesh.is_distributed(), "dp: rank_main left its group up")
    check(np.isfinite(stats["last_average_loss"]), "dp: loss not finite")
    check_dp_launches(label, {k: after[k] - before[k] for k in after},
                      stats["steps_run"])
    total_steps += 2 * DP_STEPS + stats["steps_run"]
    ips = stats["images_per_sec"]
    log(f"dp {label}: {ips:.2f} images/sec ({ips / ref_ips:.4f} of the "
        f"single-device run's {ref_ips:.2f}), num_workers "
        f"{stats['num_workers']}, peak memory of its build and checked "
        f"steps {info['peak_gib']:.3f} GiB above {info['before_gib']:.3f} "
        f"(single device {ref_info['peak_gib']:.3f}), buckets "
        f"{info['buckets']}")
    out[label] = {"images_per_sec": ips, "losses": losses, **info}
  total_lm = phase_dp_lm(out)
  counts = benchmark.kernel_launches()
  res.setdefault("counts_by_path", {})["dp"] = counts
  for name in conv_bn.LAUNCHES:
    check(counts[name] == 13 * total_steps,
          f"dp: {name} launched {counts[name]} times in {total_steps} "
          "steps, want 13 a step")
  for name, per_step in LM_LAUNCHES.items():
    check(counts[name] == per_step * total_lm,
          f"dp: {name} launched {counts[name]} times in {total_lm} LM "
          f"steps, want {per_step} a step")
  log(f"dp: kernel launches {counts} over {total_steps} ResNet-50 steps "
      f"of {len(DP_CASES)} strategies and {total_lm} LM steps of "
      f"{len(DP_LM_CASES)} modes")
  res["dp"] = out


def phase_dp_lm(out):
  """transformer_lm at its published size (flash attention) under the
  DP_LM_CASES at world 1 over NCCL, against its single-device step: eager
  and as one captured dispatch, the launches of each run, then a short
  timed run. Returns the LM steps run."""
  import torch.distributed as dist
  from kf_benchmarks_tpu_torch import cli
  from kf_benchmarks_tpu_torch.models import transformer_lm as lm
  from kf_benchmarks_tpu_torch.parallel import mesh
  total = 0
  with lm_attention("flash"):
    base = dict(optimizer="momentum", num_batches=8, num_warmup_batches=3,
                display_every=10)
    ref_info = {}
    ref_losses, ref_weights, _, launched = dp_steps(lm_params(**base),
                                                    ref_info)
    check_launches("dp lm single-device", launched, LM_LAUNCHES, DP_STEPS)
    total += DP_STEPS
    ref_sps = dp_images_per_sec(lm_params(**base))
    total += ref_sps["steps_run"]
    ref_sps = ref_sps["images_per_sec"]
    log(f"dp lm: single-device: losses {ref_losses}, {ref_sps:.2f} "
        f"sequences/sec, peak memory of its build and checked steps "
        f"{ref_info['peak_gib']:.3f} GiB")
    out["lm_single_device"] = {"sequences_per_sec": ref_sps, **ref_info}
    for label, flags, want in DP_LM_CASES:
      params = lm_params(**base, **flags)
      info = {}
      mesh.init_process_group("gpu", 1, 0, mesh.local_init_method())
      try:
        check(dist.get_backend() == "nccl", "dp: the group is not NCCL")
        losses, weights, _, launched = dp_steps(params, info)
        check_launches(f"dp {label}", launched, LM_LAUNCHES, DP_STEPS)
        c_losses, c_weights, c_launched = dp_chunk_steps(params)
        check_launches(f"dp {label} captured", c_launched, LM_LAUNCHES,
                       DP_STEPS)
        captured_ok = c_losses == losses and torch.equal(c_weights, weights)
        log(f"dp {label}: the {DP_STEPS} steps as one K={DP_STEPS} "
            f"dispatch: losses {c_losses}, "
            f"{'bitwise equal' if captured_ok else 'DIFFERENT'} against the "
            "eager steps")
        check(captured_ok, f"dp {label}: the captured steps differ")
        del c_weights
      finally:
        mesh.destroy_process_group()
      total += 2 * DP_STEPS
      if want == "bitwise":
        ok = losses == ref_losses and torch.equal(weights, ref_weights)
        verdict = "bitwise equal" if ok else "DIFFERENT"
      else:
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        w_rel = float((weights - ref_weights).norm() / ref_weights.norm())
        ok = rel <= DP_FSDP_LM_RTOL and w_rel <= DP_FSDP_LM_RTOL
        verdict = (f"losses within {rel:.3g} and weights within "
                   f"{w_rel:.3g} relative (tol {DP_FSDP_LM_RTOL:g})")
      del weights
      log(f"dp {label}: NCCL world 1, losses {losses}: {verdict} against "
          "the single-device step")
      check(ok, f"dp {label}: differs from the single-device step")
      stats = cli.rank_main(0, params, mesh.local_init_method())
      check(not mesh.is_distributed(), "dp: rank_main left its group up")
      check(np.isfinite(stats["last_average_loss"]), "dp: loss not finite")
      total += stats["steps_run"]
      sps = stats["images_per_sec"]
      log(f"dp {label}: {sps:.2f} sequences/sec ({sps / ref_sps:.4f} of "
          f"the single-device run's {ref_sps:.2f}; "
          f"{sps * lm.SEQ_LEN:.0f} tokens/sec), peak memory of its build and "
          f"checked steps {info['peak_gib']:.3f} GiB above "
          f"{info['before_gib']:.3f} (single device "
          f"{ref_info['peak_gib']:.3f}), buckets {info['buckets']}")
      out[label] = {"sequences_per_sec": sps, "losses": losses, **info}
  return total


# -- the zoo: ResNet-152 and Inception-v3 (BASELINE configs 4 and 5) ------------

ZOO_RUNS = (
    # (label, model, fused units a step, extra flags)
    ("resnet152", "resnet152", 47, {}),
    ("inception3", "inception3", 2, dict(variable_update="kungfu",
                                         kungfu_option="async_sgd")),
)
ZOO_BATCH = 128


def zoo_params(model, **flags):
  from kf_benchmarks_tpu_torch import params as params_lib
  return params_lib.make_params(
      model=model, batch_size=ZOO_BATCH, use_fp16=True, optimizer="momentum",
      num_batches=20, num_warmup_batches=5, display_every=10, device="gpu",
      **flags)


def check_conv_at(label, n, h, w, c, co, seed, given=None):
  """K-A against its plain version at one shape, timed as in phase conv,
  on seeded inputs or on ``given`` (x, HWIO weights) of a real run."""
  from kf_benchmarks_tpu_torch.ops import conv_bn
  x, wt = given if given is not None else inputs(n, h, w, c, co, seed)[:2]
  w_k = conv_bn.kmajor(wt)
  y = conv_bn.conv3x3_same(x, wt)
  ref = conv_bn.conv3x3_same_plain(x, wt)
  torch.cuda.synchronize()
  err, ok = bf16_close(y, ref)
  rel = err / float(ref.float().abs().max())
  check(ok, f"conv3x3_same {label}: max abs err {err} out of tolerance")
  x_nchw = x.permute(0, 3, 1, 2)
  w_oihw = wt.permute(3, 2, 0, 1).contiguous(
      memory_format=torch.channels_last)
  ms = time_ms(lambda: conv_bn.conv3x3_same_kmajor(x, w_k))
  plain_ms = time_ms(lambda: conv_bn.conv3x3_same_plain(x, wt), iters=5)
  lib_ms = time_ms(lambda: F.conv2d(x_nchw, w_oihw, padding=1))
  b_ms, b_by = conv_cost(n, h, w, c, co)
  log(f"zoo conv: {label} x[{n},{h},{w},{c}] w[3,3,{c},{co}]: max abs err "
      f"{err:.3g} (rel {rel:.2g}; tol 2^-7|ref| + 1e-3 max|ref|) kernel "
      f"{ms:.4f} ms, plain {plain_ms:.3f} ms, F.conv2d {lib_ms:.4f} ms, "
      f"bound {b_ms:.4f} ms ({b_by})")
  return dict(stage=label, shape=[n, h, w, c, co], max_abs_err=err,
              max_rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
              bound_by=b_by, library_ms=lib_ms, library="F.conv2d (cuDNN)")


def check_unit_at(label, n, h, w, c, co, seed, given=None):
  """K-B against its plain version at one shape, with the checks and
  timings of phase unit, on seeded inputs or on ``given`` (x, HWIO
  weights, sc, sh) of a real run."""
  from kf_benchmarks_tpu_torch.ops import conv_bn
  x, wt, sc, sh = (given if given is not None
                   else inputs(n, h, w, c, co, seed))
  w_k = conv_bn.kmajor(wt)
  y, st = conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w_k)
  y2, st2 = conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w_k)
  y_ref, st_ref = conv_bn.bn_relu_conv3x3_stats_plain(x, sc, sh, wt)
  torch.cuda.synchronize()
  check(torch.equal(y, y2) and torch.equal(st, st2),
        f"bn_relu_conv3x3_stats {label}: two launches differ")
  err, ok = bf16_close(y, y_ref)
  check(ok, f"bn_relu_conv3x3_stats {label}: y max abs err {err}")
  yf = y_ref.float()
  scale = torch.stack([yf.abs().sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))])
  st_err = float(((st - st_ref).abs() / scale.clamp_min(1e-30)).max())
  check(st_err <= 1e-3, f"bn_relu_conv3x3_stats {label}: stats rel err "
        f"{st_err} > 1e-3")
  x_nchw = x.permute(0, 3, 1, 2)
  w_oihw = wt.permute(3, 2, 0, 1).contiguous(
      memory_format=torch.channels_last)
  ms = time_ms(lambda: conv_bn.bn_relu_conv3x3_stats(x, sc, sh, w_k))
  plain_ms = time_ms(
      lambda: conv_bn.bn_relu_conv3x3_stats_plain(x, sc, sh, wt), iters=5)
  lib_ms = time_ms(lambda: _bn_relu_stats_library(x_nchw, w_oihw, sc, sh))
  b_ms, b_by = conv_cost(n, h, w, c, co, extra_bytes=4.0 * (2 * c + 2 * co))
  log(f"zoo unit: {label} x[{n},{h},{w},{c}] -> {co}: y max abs err "
      f"{err:.3g}, stats rel err {st_err:.2g} (tol 1e-3), two launches "
      f"bitwise equal; tile {tuple(conv_bn.kb_tile(n, h, w, co, 132))}; "
      f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, cuDNN conv + torch "
      f"BN/ReLU/stats {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
  return dict(stage=label, shape=[n, h, w, c, co], max_abs_err=err,
              stats_rel_err=st_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
              bound_by=b_by, library_ms=lib_ms,
              library="F.conv2d (cuDNN) + torch BN-apply, ReLU and "
              "statistics (no single call computes the unit)")


@contextlib.contextmanager
def noting_unit_shapes(shapes):
  """Notes the (N, H, W, C, CO) of every call the fused unit makes while
  the block runs: K-B's in shapes["bn_relu_conv3x3_stats"], K-A's (the
  input gradient) in shapes["conv3x3_same"]. The unit's Function looks
  both wrappers up in ops/conv_bn.py at each call; the wrappers' own
  launch counts are untouched."""
  from kf_benchmarks_tpu_torch.ops import conv_bn
  kb, ka = conv_bn.bn_relu_conv3x3_stats, conv_bn.conv3x3_same_kmajor

  def kb_noted(x, sc, sh, w_k):
    shapes["bn_relu_conv3x3_stats"].add((*x.shape, w_k.shape[0]))
    return kb(x, sc, sh, w_k)

  def ka_noted(x, w_k):
    shapes["conv3x3_same"].add((*x.shape, w_k.shape[0]))
    return ka(x, w_k)

  conv_bn.bn_relu_conv3x3_stats = kb_noted
  conv_bn.conv3x3_same_kmajor = ka_noted
  try:
    yield
  finally:
    conv_bn.bn_relu_conv3x3_stats, conv_bn.conv3x3_same_kmajor = kb, ka


@contextlib.contextmanager
def capturing_unit_inputs(calls):
  """Keeps clones of the inputs of the first call at each (N, H, W, C, CO)
  that the fused unit makes of K-B (calls["bn_relu_conv3x3_stats"]: x, the
  HWIO weights, sc, sh) and of K-A (calls["conv3x3_same"]: x, the HWIO
  weights) while the block runs: the activations and the weights of the
  path itself. The calls go through; the wrappers' launch counts are
  untouched."""
  from kf_benchmarks_tpu_torch.ops import conv_bn
  kb, ka = conv_bn.bn_relu_conv3x3_stats, conv_bn.conv3x3_same_kmajor

  def keep(name, x, w_k, *rest):
    key = (*x.shape, w_k.shape[0])
    if key not in calls[name]:
      calls[name][key] = (x.clone(), w_k.permute(1, 2, 3, 0).clone(),
                          *(t.clone() for t in rest))

  def kb_kept(x, sc, sh, w_k):
    keep("bn_relu_conv3x3_stats", x, w_k, sc, sh)
    return kb(x, sc, sh, w_k)

  def ka_kept(x, w_k):
    keep("conv3x3_same", x, w_k)
    return ka(x, w_k)

  conv_bn.bn_relu_conv3x3_stats = kb_kept
  conv_bn.conv3x3_same_kmajor = ka_kept
  try:
    yield
  finally:
    conv_bn.bn_relu_conv3x3_stats, conv_bn.conv3x3_same_kmajor = kb, ka


def phase_zoo(res):
  """BASELINE configs 4 and 5's models: BenchmarkCNN on ResNet-152 v1.5
  and on Inception-v3 (the latter under kungfu async_sgd, pair averaging,
  at world 1 over NCCL through the rank entry), batch 128, bf16, Nesterov
  momentum, 5 warmup + 20 timed steps each, with the launch counts set to
  0 just before the two runs and read just after. Then K-A and K-B
  against their plain versions at every shape the runs gave them, and K-A
  at K-B's shapes too (phase elastic runs ResNet-152 at the same batch,
  so these are its shapes as well)."""
  from kf_benchmarks_tpu_torch import benchmark, cli
  from kf_benchmarks_tpu_torch.parallel import mesh
  out = {}
  shapes = {label: {"conv3x3_same": set(), "bn_relu_conv3x3_stats": set()}
            for label, *_ in ZOO_RUNS}
  reset_launches()
  for label, model, fused, flags in ZOO_RUNS:
    params = zoo_params(model, **flags)
    before = benchmark.kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    with noting_unit_shapes(shapes[label]):
      if flags:
        stats = cli.rank_main(0, params, mesh.local_init_method())
        check(not mesh.is_distributed(), "zoo: rank_main left its group up")
      else:
        stats = benchmark.BenchmarkCNN(params).run()
    after = benchmark.kernel_launches()
    launched = {k: after[k] - before[k] for k in after}
    steps = stats["steps_run"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"zoo {label}: batch {ZOO_BATCH}, {steps} steps (5 warmup + 20 "
        f"timed), {stats['images_per_sec']:.2f} images/sec, peak memory "
        f"{peak:.2f} GiB, kernel launches {launched} ({fused} + {fused} a "
        f"step wanted)")
    check(np.isfinite(stats["last_average_loss"]),
          f"zoo {label}: loss not finite")
    for name in ("conv3x3_same", "bn_relu_conv3x3_stats"):
      check(launched[name] == fused * steps,
            f"zoo {label}: {name} launched {launched[name]} times in "
            f"{steps} steps, want {fused} a step")
    out[label] = {"images_per_sec": stats["images_per_sec"],
                  "peak_gib": peak, "launches": launched,
                  "shapes": {k: sorted(v) for k, v in shapes[label].items()}}
  res.setdefault("counts_by_path", {})["zoo"] = benchmark.kernel_launches()
  res["zoo"] = out
  seed = 60
  for label, *_ in ZOO_RUNS:
    noted = shapes[label]
    for name in noted:
      check(noted[name], f"zoo {label}: no {name} call noted")
    # K-A also at K-B's shapes: the same conv without the prologue
    # (Inception's forward 448 -> 384 beside its gradient's 384 -> 448).
    todo = (("conv3x3_same", check_conv_at,
             noted["conv3x3_same"] | noted["bn_relu_conv3x3_stats"]),
            ("bn_relu_conv3x3_stats", check_unit_at,
             noted["bn_relu_conv3x3_stats"]))
    for name, check_at, at in todo:
      for n, h, w, c, co in sorted(at):
        res.setdefault(name, []).append(check_at(
            f"{label}_{h}x{w}_{c}_{co}", n, h, w, c, co, seed=seed))
        seed += 1


# -- launches of later phases made early ---------------------------------------

# Phase elastic's second round (one worker) leaves most of the card's memory
# and of the host's cores idle. When phases faults and aot are in the run,
# that round also runs faults' faulted launch and aot's two exports, and
# the phase waits for all of them, so none of their work overlaps a timed
# phase. name -> the finished launch's results (and its directory, which
# the consuming phase removes).
EARLY = {}

# Phases that time nothing, run by phase elastic in this process while it
# waits for its launches (when both are in the run), not in their own
# place: their card work is small beside the workers' and their checks
# are numeric, so sharing the card and the host's cores changes no check.
BESIDE_ELASTIC = ("parity", "lm_parity", "serve_parity", "models_cosines")


def timed_waits(waits):
  """{name: zero-argument function waiting for a process} -> {name:
  (its result, seconds from now until it returned)}: the waits run on
  threads, so each is timed to its own end; a failed one raises here."""
  import concurrent.futures
  t0 = time.time()
  with concurrent.futures.ThreadPoolExecutor(len(waits)) as pool:
    futures = {name: pool.submit(lambda fn=fn: (fn(), time.time() - t0))
               for name, fn in waits.items()}
    return {name: f.result() for name, f in futures.items()}


def early_waits(phases):
  """Starts the launches of faults and aot that ``phases`` will consume;
  returns their waits for ``timed_waits``, which store their results in
  EARLY."""
  waits = {}
  if "faults" in phases:
    root = tempfile.mkdtemp(prefix="faults_early_")
    started = fault_start(root, "faulted", FAULT_STEPS,
                          "corrupt_ckpt@6,kill@7")

    def faults_wait(started=started, root=root):
      out, err = fault_finish(started)
      return dict(out=out, err=err, root=root)
    waits["faults"] = faults_wait
  if "aot" in phases:
    root = tempfile.mkdtemp(prefix="aot_early_")
    paths = aot_paths(root)
    for mode, started in aot_exports(paths).items():
      waits[f"aot_{mode}"] = (
          lambda started=started, path=paths[mode], root=root:
          dict(text=aot_finish(started), path=path, root=root))
  return waits


def store_early(done):
  """Files timed_waits' results of early_waits' launches in EARLY."""
  for name, (result, seconds) in done.items():
    EARLY[name] = dict(result, seconds=seconds)


def drop_early():
  """Removes what no phase consumed (a run that ended early)."""
  import shutil
  for entry in EARLY.values():
    shutil.rmtree(entry["root"], ignore_errors=True)
  EARLY.clear()


# -- elastic: BASELINE config 5 through kfrun -----------------------------------

ELASTIC_STEPS = 6


def elastic_start(root, name, num_batches):
  """Starts one launch of BASELINE config 5's command through ``python -m
  kf_benchmarks_tpu_torch.kfrun -np 1``: ResNet-152, batch 128, bf16,
  kungfu, --elastic --adaptive_batch_size, its checkpoints in
  root/<name>, no warmup steps. Returns what ``elastic_finish`` reads."""
  from kf_benchmarks_tpu_torch.parallel import mesh
  train_dir = os.path.join(root, name)
  logdir = os.path.join(root, name + "_logs")
  os.makedirs(logdir, exist_ok=True)
  cmd = [sys.executable, "-m", "kf_benchmarks_tpu_torch.kfrun", "-np", "1",
         "--logdir", logdir, "--", sys.executable, "-m",
         "kf_benchmarks_tpu_torch.cli", "--model=resnet152",
         f"--batch_size={ZOO_BATCH}", "--use_fp16", "--optimizer=momentum",
         "--variable_update=kungfu", "--elastic", "--adaptive_batch_size",
         "--elastic_check_every_n_steps=2", "--num_warmup_batches=0",
         "--sync_on_finish",
         f"--num_batches={num_batches}", "--display_every=1",
         f"--train_dir={train_dir}",
         "--worker_hosts=" + mesh.local_init_method()[len("tcp://"):]]
  # A worker killed by a signal leaves its Python stack in its log.
  env = {**os.environ, "PYTHONFAULTHANDLER": "1"}
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, env=env)
  return name, logdir, proc


def elastic_finish(started):
  """Waits for a launch of ``elastic_start``; the worker's stdout."""
  name, logdir, proc = started
  try:
    _, kf_err = proc.communicate(timeout=300)
  except subprocess.TimeoutExpired:
    proc.kill()
    _, kf_err = proc.communicate()
  with open(os.path.join(logdir, "127.0.0.1.10000.stdout.log")) as f:
    out = f.read()
  with open(os.path.join(logdir, "127.0.0.1.10000.stderr.log")) as f:
    err = f.read()
  check(proc.returncode == 0, f"elastic {name}: kfrun exited "
        f"{proc.returncode}\nkfrun: {kf_err[-2000:]}\nworker stdout: "
        f"{out[-2000:]}\nworker stderr: {err[-4000:]}")
  return out


def state_distances(a, b):
  """{tensor: max |a - b|} over a snapshot's module state (parameters and
  batch-norm averages) and optimizer buffers; the step must match."""
  check(a["step"] == b["step"], f"elastic: steps {a['step']} != "
        f"{b['step']}")
  out = {}
  for k, v in a["model"].items():
    out[f"module {k}"] = float((v.double() - b["model"][k].double()).abs()
                               .max()) if v.numel() else 0.0
  for i, st in a["optimizer"]["state"].items():
    for k, v in st.items():
      out[f"optimizer {i}/{k}"] = float(
          (v.double() - b["optimizer"]["state"][i][k].double()).abs().max())
  return out


def launches_in(log_text):
  m = re.findall(r"^Kernel launches: (.*)$", log_text, re.M)
  check(len(m) == 1, "elastic: no kernel launch line")
  return {k: int(v) for k, v in (x.rsplit(" ", 1) for x in m[0].split(", "))}


def phase_elastic(res):
  """BASELINE config 5 through kfrun at -np 1: ResNet-152 run for 6
  steps twice uninterrupted, and 3 + 3 with a checkpoint and a resume in
  between (a new process); the resumed state at step 6 -- parameters,
  batch-norm averages, momentum buffers, step -- held to the limit the
  card gives: bitwise if the two uninterrupted runs are bitwise equal,
  else within their distance of each other, tensor by tensor. World 1
  gives no noise-scale estimate, so the batch must hold."""
  import gc
  import tempfile
  from kf_benchmarks_tpu_torch import checkpoint
  # The workers are other processes: leave them the card's memory.
  gc.collect()
  torch.cuda.empty_cache()
  free, total = torch.cuda.mem_get_info()
  log(f"elastic: this process holds {torch.cuda.memory_allocated() / 2**30:.2f}"
      f" GiB ({torch.cuda.memory_reserved() / 2**30:.2f} reserved); the card "
      f"has {free / 2**30:.1f} of {total / 2**30:.1f} GiB free")
  # Four ResNet-152 checkpoints of 460 MiB: removed when read.
  with tempfile.TemporaryDirectory(prefix="elastic_") as root:
    half = ELASTIC_STEPS // 2

    def launches():
      """The two uninterrupted runs and the first arc share the card (three
      workers of 19 GiB at their peak); the second arc resumes beside the
      early launches (EARLY). Phase audit's process (host CPU alone) runs
      beside both rounds."""
      audit = audit_start() if "audit" in res.get("phases", ()) else None
      started = [elastic_start(root, "whole_a", ELASTIC_STEPS),
                 elastic_start(root, "whole_b", ELASTIC_STEPS),
                 elastic_start(root, "arcs", half)]
      logs = dict(zip(("whole_a", "whole_b", "arc_1"),
                      [elastic_finish(s) for s in started]))
      arc_2 = elastic_start(root, "arcs", half)
      waits = {"arc_2": lambda: elastic_finish(arc_2),
               **early_waits(res.get("phases", ()))}
      if audit is not None:
        waits["audit"] = lambda: audit_finish(audit)
      done = timed_waits(waits)
      logs["arc_2"] = done.pop("arc_2")[0]
      return logs, done

    # This process waits on the launches' thread; meanwhile it runs the
    # untimed phases of BESIDE_ELASTIC.
    import concurrent.futures
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
      future = pool.submit(launches)
      for name in res.get("beside_elastic", ()):
        run_phase(name, res)
      logs, done = future.result()
    store_early(done)
    if done:
      log(f"elastic: the second arc ran beside {', '.join(done)} (made "
          f"early): " + ", ".join(
              f"{k} {v:.1f} s" for k, (_, v) in done.items()))
    # The port runs this path in the workers: their counts, each from 0.
    from kf_benchmarks_tpu_torch import benchmark
    counts = dict.fromkeys(benchmark.kernel_launches(), 0)
    for label, text in logs.items():
      launched = launches_in(text)
      steps = half if label.startswith("arc") else ELASTIC_STEPS
      for name in ("conv3x3_same", "bn_relu_conv3x3_stats"):
        check(launched.get(name) == 47 * steps,
              f"elastic {label}: {name} launched {launched.get(name)} times "
              f"in {steps} steps, want 47 a step")
      for k, v in launched.items():
        counts[k] += v
      check("track_grad_noise_scale: needs >= 2 devices" in text and
            "Elastic reshape" not in text,
            f"elastic {label}: the batch did not hold at world 1")
    res.setdefault("counts_by_path", {})["elastic"] = counts
    check(f"Restored checkpoint at global step {half}" in logs["arc_2"],
          "elastic: the second arc did not resume at step 3")
    save_s = [float(x) for t in logs.values() for x in re.findall(
        r"Saved checkpoint at global step \d+ in ([\d.]+) s", t)]
    restore_s = float(re.findall(
        r"Restored checkpoint at global step \d+ in ([\d.]+) s",
        logs["arc_2"])[0])
    snaps = {}
    for name in ("whole_a", "whole_b", "arcs"):
      snaps[name], _, step = checkpoint.load_latest_checkpoint(
          os.path.join(root, name))
      check(step == ELASTIC_STEPS, f"elastic {name}: last step {step}")
    nbytes = os.path.getsize(checkpoint.latest_checkpoint(
        os.path.join(root, "arcs"))[0])
  noise = state_distances(snaps["whole_b"], snaps["whole_a"])
  resumed = state_distances(snaps["arcs"], snaps["whole_a"])
  bitwise = max(noise.values()) == 0.0
  over = {k: (v, noise[k]) for k, v in resumed.items() if v > noise[k]}
  log(f"elastic: two uninterrupted runs {'bitwise equal' if bitwise else 'differ'} "
      f"(largest tensor distance {max(noise.values()):.3g}); resumed run "
      f"against the first: largest tensor distance "
      f"{max(resumed.values()):.3g}, {len(over)} of {len(resumed)} tensors "
      f"over the uninterrupted pair's distance")
  log(f"elastic: checkpoint {nbytes / 2 ** 20:.1f} MiB, save "
      f"{min(save_s):.3f}-{max(save_s):.3f} s over {len(save_s)} saves, "
      f"restore {restore_s:.3f} s; kernel launches {counts}")
  check(not over, f"elastic: resumed state beyond the card's own spread: "
        f"{dict(list(over.items())[:5])}")
  res["elastic"] = {"bitwise": bitwise, "noise_max": max(noise.values()),
                    "resumed_max": max(resumed.values()),
                    "save_s": save_s, "restore_s": restore_s,
                    "checkpoint_bytes": nbytes}


# -- infer: forward-only ResNet-50 and transformer_lm ----------------------------

INFER_STEPS = (5, 12)  # warmup, timed


@contextlib.contextmanager
def capturing_flash_inputs(calls):
  """Notes the inputs of the first flash-forward call of each distinct
  shape made while the block runs (clones: the real activations of the
  path), and lets the call through; the wrapper's launch count is
  untouched."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  fwd = fa.flash_attention_fwd

  def noted(q, k, v, causal=False, scale=None, q_seg=None, kv_seg=None):
    key = (tuple(q.shape), tuple(k.shape), q.stride(), causal)
    if key not in calls:
      clone = lambda t: None if t is None else t.clone()
      # q, k and v keep their strides (the LM's qkv.unbind(2) views).
      qkv = torch.stack([q, k, v], dim=2).unbind(2)
      calls[key] = (*qkv, causal, scale, clone(q_seg), clone(kv_seg))
    return fwd(q, k, v, causal, scale, q_seg, kv_seg)

  fa.flash_attention_fwd = noted
  try:
    yield
  finally:
    fa.flash_attention_fwd = fwd


def eval_logits(module, images):
  """The module's eval-mode logits under the eval step's grad mode."""
  module.eval()
  try:
    with torch.no_grad():
      return module(images).float()
  finally:
    module.train()


def phase_infer(res):
  """--forward_only through BenchmarkCNN: ResNet-50 v1.5 at batch 256,
  bf16, and transformer_lm (flash attention) at batch 8, 5 warmup + 12
  timed steps each, with the launch counts set to 0 just before each run
  and read just after (K-B 13 a ResNet step and K-A 0; the flash forward
  6 an LM step, no checkpoint recompute under no_grad). K-B at every shape
  the ResNet run gave it, and the flash forward on the LM run's own
  inputs, against their plain versions. Then eval-mode logits of
  ResNet-50 at batch 8 after 3 training steps on the card: the card
  (bf16, kernels) against the CPU (f32, plain versions) from the same
  weights and averages."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import params as params_lib
  from kf_benchmarks_tpu_torch.models import transformer_lm as lm
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  warm, timed = INFER_STEPS
  out = {}
  shapes = {"conv3x3_same": set(), "bn_relu_conv3x3_stats": set()}
  params = params_lib.make_params(
      model="resnet50", batch_size=256, use_fp16=True, forward_only=True,
      num_batches=timed, num_warmup_batches=warm, display_every=10,
      device="gpu")
  bench = benchmark.BenchmarkCNN(params)
  torch.cuda.reset_peak_memory_stats()
  reset_launches()
  with noting_unit_shapes(shapes):
    stats = bench.run()
  counts = benchmark.kernel_launches()
  steps = warm + timed
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  log(f"infer resnet50: batch 256, {steps} forward-only steps ({warm} "
      f"warmup + {timed} timed), {stats['images_per_sec']:.2f} images/sec, "
      f"peak memory {peak:.2f} GiB, kernel launches {counts}")
  check(np.isfinite(stats["last_average_loss"]), "infer: loss not finite")
  want = {"bn_relu_conv3x3_stats": 13, "conv3x3_same": 0,
          "flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0,
          "flash_attention_bwd_dq": 0, "flash_decode": 0}
  for name, per_step in want.items():
    check(counts[name] == per_step * steps,
          f"infer resnet50: {name} launched {counts[name]} times in {steps} "
          f"steps, want {per_step} a step")
  resnet_counts = counts
  out["resnet50"] = {"images_per_sec": stats["images_per_sec"],
                     "peak_gib": peak, "launches": counts,
                     "kb_shapes": sorted(shapes["bn_relu_conv3x3_stats"])}
  check(shapes["bn_relu_conv3x3_stats"] and not shapes["conv3x3_same"],
        f"infer: noted unit shapes {shapes}")
  for i, (n, h, w, c, co) in enumerate(
      sorted(shapes["bn_relu_conv3x3_stats"])):
    res.setdefault("bn_relu_conv3x3_stats", []).append(check_unit_at(
        f"infer_{h}x{w}_{c}_{co}", n, h, w, c, co, seed=90 + i))
  del bench
  # transformer_lm forward-only, flash attention.
  calls = {}
  with lm_attention("flash"):
    bench = benchmark.BenchmarkCNN(lm_params(
        forward_only=True, num_batches=timed, num_warmup_batches=warm,
        display_every=10))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with capturing_flash_inputs(calls):
      stats = bench.run()
    counts = benchmark.kernel_launches()
  peak = torch.cuda.max_memory_allocated() / 2 ** 30
  seq_per_s = stats["images_per_sec"]
  log(f"infer transformer_lm: batch 8, {steps} forward-only steps, "
      f"{seq_per_s:.2f} sequences/sec, {seq_per_s * lm.SEQ_LEN:.0f} "
      f"tokens/sec, peak memory {peak:.2f} GiB, kernel launches {counts}")
  check(np.isfinite(stats["last_average_loss"]),
        "infer lm: loss not finite")
  want = {"flash_attention_fwd": 6, "flash_attention_bwd_dkv": 0,
          "flash_attention_bwd_dq": 0, "conv3x3_same": 0,
          "bn_relu_conv3x3_stats": 0, "flash_decode": 0}
  for name, per_step in want.items():
    check(counts[name] == per_step * steps,
          f"infer lm: {name} launched {counts[name]} times in {steps} "
          f"steps, want {per_step} a step")
  check(len(calls) == 1, f"infer lm: flash shapes {list(calls)}")
  for (qs, ks, stride, causal), args in calls.items():
    o, lse = fa.flash_attention_fwd(*args)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(*args)
    torch.cuda.synchronize()
    err, ok = bf16_close(o, o_ref)
    lse_err = float(((lse - lse_ref).abs() /
                     lse_ref.abs().clamp_min(1.0)).max())
    log(f"infer lm: flash forward on the run's own q{list(qs)} (strides "
        f"{stride}) causal={causal}: o max abs err {err:.3g} (tol one bf16 "
        f"ulp + 1e-3 max|ref|), lse rel err {lse_err:.2g} (tol 1e-3)")
    check(ok and lse_err <= 1e-3, "infer lm: flash forward differs from "
          "its plain version on the run's inputs")
  out["transformer_lm"] = {"sequences_per_sec": seq_per_s,
                           "peak_gib": peak, "launches": counts}
  res.setdefault("counts_by_path", {})["infer"] = {
      k: resnet_counts[k] + counts[k] for k in counts}
  del bench
  out["eval_logits"] = infer_parity()
  res["infer"] = out


def infer_parity():
  """ResNet-50 trained 3 steps on the card (batch 8, bf16, momentum), then
  eval-mode logits of a new batch of 8 on the card (kernels, bf16) and on
  the CPU (plain versions, f32) from the trained weights and averages:
  the loss within phase parity's 2e-2, the logits' norm within 5e-2 and
  their cosine >= 0.98 (phase parity's classifier limits)."""
  from kf_benchmarks_tpu_torch import optimizers
  from kf_benchmarks_tpu_torch import params as params_lib
  from kf_benchmarks_tpu_torch import train_step
  from kf_benchmarks_tpu_torch.models import resnet_model
  from kf_benchmarks_tpu_torch.ops import conv_bn
  model = resnet_model.create_resnet50_model()
  gen = torch.Generator(device="cuda").manual_seed(8)
  with torch.device("cuda"):
    card = model.make_module(1001, torch.bfloat16, generator=gen)
  opt = optimizers.get_optimizer(
      params_lib.make_params(optimizer="momentum", device="cpu"),
      card.parameters())
  step = train_step.TrainStep(model, card, opt, lambda s: 0.01, 4e-5)
  rng = np.random.default_rng(8)

  def batch():
    images = (np.clip(rng.normal(size=(8, 224, 224, 3)), -2, 2) * 60.0 +
              127.0).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(
        rng.integers(0, 1001, 8))

  for _ in range(3):
    x, y = batch()
    step(x.cuda(), y.cuda())
  cpu = model.make_module(1001, torch.float32)
  cpu.load_state_dict({k: v.float().cpu() for k, v in
                       card.state_dict().items()})
  x, y = batch()
  before = dict(conv_bn.LAUNCHES)
  # In double: with batch-norm averages three steps from their initial
  # values, the eval-mode activations of raw pixels grow large.
  got = eval_logits(card, x.cuda()).cpu().double()
  launched = {k: conv_bn.LAUNCHES[k] - before[k] for k in before}
  ref = eval_logits(cpu, x).double()
  loss = {k: float(F.cross_entropy(v, y)) for k, v in
          (("card", got), ("cpu", ref))}
  rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
  n_rel = abs(float(got.norm()) - float(ref.norm())) / float(ref.norm())
  cos = float((got * ref).sum() / (got.norm() * ref.norm()))
  top1 = {k: float((v.argmax(-1) == y).float().mean())
          for k, v in (("card", got), ("cpu", ref))}
  log(f"infer parity: ResNet-50 after 3 card steps, eval logits at batch 8: "
      f"cross-entropy card {loss['card']:.6g} cpu {loss['cpu']:.6g} (rel "
      f"{rel:.2g}, tol 2e-2), logits norm rel {n_rel:.2g} (tol 5e-2), "
      f"cosine {cos:.5f} (tol 0.98), top-1 card {top1['card']} cpu "
      f"{top1['cpu']}, card launches {launched}")
  check(launched == {"conv3x3_same": 0, "bn_relu_conv3x3_stats": 13},
        f"infer parity: the card's eval forward launched {launched}")
  check(rel <= 2e-2 and n_rel <= 5e-2 and cos >= 0.98,
        "infer parity: card eval logits differ from the CPU's")
  return {"loss_rel": rel, "norm_rel": n_rel, "cosine": cos}


# -- eval: --eval over checkpoints, mid-training eval --------------------------

EVAL_STEPS = 6
EVAL_BATCHES = 4
# The eval process's mean loss against the in-process eval step's on the
# same weights and batch: the same kernels on the same inputs, so all
# that may separate them is the log line's 6 decimals.
EVAL_LOSS_RTOL = 1e-4


def resnet_start(*flags):
  """Starts ``python -m kf_benchmarks_tpu_torch.cli`` on ResNet-50 v1.5 at
  batch 256, bf16, Nesterov momentum, with ``flags``; ``resnet_finish``
  waits for it."""
  cmd = [sys.executable, "-m", "kf_benchmarks_tpu_torch.cli",
         "--model=resnet50", "--batch_size=256", "--use_fp16",
         "--optimizer=momentum", *flags]
  return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)


def resnet_finish(started):
  """The stdout of a ``resnet_start`` process, which must exit 0."""
  cmd, proc = started
  try:
    out, err = proc.communicate(timeout=600)
  except subprocess.TimeoutExpired:
    proc.kill()
    out, err = proc.communicate()
  check(proc.returncode == 0, f"eval: {' '.join(cmd[2:])} exited "
        f"{proc.returncode}\n{out[-2000:]}\n{err[-3000:]}")
  return out


def resnet_cli(*flags):
  """``resnet_start`` and ``resnet_finish``: one process run to its end."""
  return resnet_finish(resnet_start(*flags))


def resnet_params(**flags):
  """ResNet-50 v1.5 at batch 256, bf16, Nesterov momentum (unless
  ``flags`` name another optimizer), on the card."""
  from kf_benchmarks_tpu_torch import params as params_lib
  return params_lib.make_params(**{
      "model": "resnet50", "batch_size": 256, "use_fp16": True,
      "optimizer": "momentum", "device": "gpu", **flags})


def phase_eval(res):
  """ResNet-50 at batch 256: 6 training steps at rate 0.1 in a process of
  their own with a checkpoint every 3; a second process with --eval over
  that directory (one poll) must score the step-6 checkpoint, with top-1
  and top-5 equal to the eval step's in this process on the same restored
  weights and batch and its mean loss within EVAL_LOSS_RTOL of that
  step's (the seeded init's loss lies farther off, so a missing or partial
  restore fails), and 13 K-B launches an eval batch; while the training
  process runs, 6 steps in
  this process with --eval_during_training_every_n_steps=2 must evaluate
  after steps 2, 4 and 6 and end with the batch-norm averages (and every
  other tensor) of the same run without the evals: bitwise if two runs
  without evals are bitwise equal, else no farther from it than they
  are from each other."""
  import tempfile
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import checkpoint
  from kf_benchmarks_tpu_torch import train_step
  out = {}
  with tempfile.TemporaryDirectory(prefix="eval_") as root:
    train_dir = os.path.join(root, "ckpt")
    t0 = time.time()
    # A rate that moves every weight well past rounding in 6 steps (the
    # model's own is still warming up). The process runs while the runs
    # with and without mid-training evals take their steps here.
    training = resnet_start(
        f"--num_batches={EVAL_STEPS}", "--num_warmup_batches=0",
        "--init_learning_rate=0.1", f"--train_dir={train_dir}",
        "--save_model_steps=3", "--display_every=3")
    runs = {}
    for name, flags in (("plain_a", {}), ("plain_b", {}),
                        ("evals", dict(eval_during_training_every_n_steps=2))):
      stats = benchmark.BenchmarkCNN(resnet_params(
          num_batches=EVAL_STEPS, num_warmup_batches=0, display_every=2,
          train_dir=os.path.join(root, name), **flags)).run()
      runs[name], _, _ = checkpoint.load_latest_checkpoint(
          os.path.join(root, name))
      if flags:
        steps = [e["step"] for e in stats["eval_results"]]
        log(f"eval: mid-training evals after steps {steps}: " + ", ".join(
            f"top-1 {e['top_1_accuracy']:.4f}" for e in
            stats["eval_results"]))
        check(steps == [2, 4, 6], f"eval: evals after steps {steps}")
    gc.collect()
    torch.cuda.empty_cache()
    resnet_finish(training)
    train_s = time.time() - t0
    check([s for s, _ in checkpoint.all_checkpoints(train_dir)] == [3, 6],
          "eval: the training process did not save steps 3 and 6")
    t0 = time.time()
    text = resnet_cli("--eval", f"--train_dir={train_dir}",
                      "--eval_interval_secs=0",
                      f"--num_eval_batches={EVAL_BATCHES}")
    eval_s = time.time() - t0
    check("Evaluating checkpoint at global step 6" in text,
          "eval: the step-6 checkpoint was not scored")
    m = re.findall(r"^Accuracy @ 1 = ([\d.]+) Accuracy @ 5 = ([\d.]+) "
                   r"\[(\d+) examples\]$", text, re.M)
    check(len(m) == 1 and int(m[0][2]) == 256 * EVAL_BATCHES,
          f"eval: accuracy lines {m}")
    top1, top5 = float(m[0][0]), float(m[0][1])
    m_loss = re.findall(r"^Eval loss = ([\d.]+) \[(\d+) examples\]$",
                        text, re.M)
    check(len(m_loss) == 1 and m_loss[0][1] == m[0][2],
          f"eval: loss lines {m_loss}")
    loss = float(m_loss[0][0])
    launched = launches_in(text)
    check(launched.get("bn_relu_conv3x3_stats") == 13 * EVAL_BATCHES and
          not launched.get("conv3x3_same"),
          f"eval: launches {launched}, want 13 K-B an eval batch")
    bench = benchmark.BenchmarkCNN(resnet_params(
        eval=True, train_dir=train_dir, eval_interval_secs=0))
    module, gen = bench._make_module()
    images, labels = bench._synthetic_batch(gen)
    eval_step = train_step.EvalStep(bench.model, module)
    init = {k: v.clone() for k, v in module.state_dict().items()}
    init_loss = float(eval_step(images, labels)["base_loss"])
    snap, _, step = checkpoint.load_latest_checkpoint(train_dir)
    check(step == 6, f"eval: newest checkpoint at step {step}")
    checkpoint.restore_model(module, snap)
    unmoved = [k for k, v in module.state_dict().items()
               if torch.equal(v, init[k])]
    check(not unmoved, f"eval: restored tensors equal to the seeded init: "
          f"{unmoved[:5]}")
    acc = eval_step(images, labels)
    here = (float(acc["top_1_accuracy"]), float(acc["top_5_accuracy"]))
    here_loss = float(acc["base_loss"])
    log(f"eval: training process (6 steps, checkpoints at 3 and 6; beside "
        f"the three runs in this process) {train_s:.1f} s, eval process "
        f"{eval_s:.1f} s: step 6 scored "
        f"top-1 {top1:.4f} top-5 {top5:.4f} loss {loss:.6f} over "
        f"{m[0][2]} examples; in-process eval step on the restored "
        f"weights top-1 {here[0]:.4f} top-5 {here[1]:.4f} loss "
        f"{here_loss:.6f} (on the seeded init {init_loss:.6f}); "
        f"launches {launched}")
    for a, b in zip((top1, top5), here):
      check(abs(a - b) <= 1 / 256 + 5e-5,
            "eval: the eval process's accuracy differs from the eval step's")
    check(abs(loss - here_loss) <= EVAL_LOSS_RTOL * abs(here_loss),
          f"eval: the eval process's loss {loss} differs from the eval "
          f"step's {here_loss}")
    check(abs(init_loss - here_loss) > 100 * EVAL_LOSS_RTOL * abs(here_loss),
          f"eval: the seeded init's loss {init_loss} is within 100 "
          f"tolerances of the restored weights' {here_loss}")
    del bench, module, snap, init
  noise = state_distances(runs["plain_b"], runs["plain_a"])
  got = state_distances(runs["evals"], runs["plain_a"])
  bitwise = max(noise.values()) == 0.0
  over = {k: (v, noise[k]) for k, v in got.items() if v > noise[k]}
  bn = [k for k in got if k.endswith(".mean") or k.endswith(".var")]
  log(f"eval: two runs without evals {'bitwise equal' if bitwise else 'differ'}"
      f" (largest distance {max(noise.values()):.3g}); the run with evals "
      f"against the first: largest distance {max(got.values()):.3g} "
      f"({max(got[k] for k in bn):.3g} over {len(bn)} batch-norm "
      f"averages), {len(over)} tensors over the pair's distance")
  check(not over, f"eval: mid-training evals moved the state: "
        f"{dict(list(over.items())[:5])}")
  out.update(top_1=top1, top_5=top5, in_process=here, loss=loss,
             in_process_loss=here_loss, init_loss=init_loss, bitwise=bitwise,
             train_s=train_s, eval_s=eval_s)
  res.setdefault("counts_by_path", {})["eval"] = {
      k: launched.get(k, 0) for k in KERNELS}
  res["eval"] = out


# -- optim: rmsprop, adam and lars; the auto loss scale -------------------------

OPTIM_STEPS = (3, 10)
# Per optimizer: its rate flags (validation forbids a piecewise schedule
# beside warmup flags, so the timed runs take the schedule and the card-vs
# CPU runs the warmup).
OPTIM_RUNS = {
    "rmsprop": dict(rate=1e-3),
    "adam": dict(rate=1e-3),
    "lars": dict(rate=1.0),
}


def optim_flags(optimizer, rate, schedule):
  flags = dict(optimizer=optimizer, gradient_clip=1.0,
               print_training_accuracy=True)
  if schedule == "piecewise":
    flags["piecewise_learning_rate_schedule"] = f"{rate};1;{rate / 10}"
  else:
    flags.update(init_learning_rate=rate, num_learning_rate_warmup_epochs=1)
  return flags


def phase_optim(res):
  """ResNet-50 at batch 256, bf16, 3 warmup + 10 timed steps under
  momentum and under rmsprop, adam and lars (each with --gradient_clip=1.0,
  a piecewise schedule and --print_training_accuracy), the counts set to 0
  just before the four runs and read just after (13 + 13 a step); each
  optimizer's 3 steps at batch 8 on the card against the CPU (under a
  warmup rate); then the auto loss scale from 2^127."""
  from kf_benchmarks_tpu_torch import benchmark
  warm, timed = OPTIM_STEPS
  out = {}
  reset_launches()
  total_steps = 0
  for name in ("momentum", *OPTIM_RUNS):
    flags = (dict(optimizer="momentum") if name == "momentum" else
             optim_flags(name, OPTIM_RUNS[name]["rate"], "piecewise"))
    before = benchmark.kernel_launches()
    stats = benchmark.BenchmarkCNN(resnet_params(**{
        **flags, "num_batches": timed, "num_warmup_batches": warm,
        "display_every": 5})).run()
    after = benchmark.kernel_launches()
    launched = {k: after[k] - before[k] for k in after}
    steps = stats["steps_run"]
    total_steps += steps
    out[name] = {"images_per_sec": stats["images_per_sec"],
                 "launches": launched}
    log(f"optim {name}: batch 256, {steps} steps, "
        f"{stats['images_per_sec']:.2f} images/sec (momentum "
        f"{out['momentum']['images_per_sec']:.2f}), launches {launched}")
    check(np.isfinite(stats["last_average_loss"]),
          f"optim {name}: loss not finite")
    for kernel in ("conv3x3_same", "bn_relu_conv3x3_stats"):
      check(launched[kernel] == 13 * steps,
            f"optim {name}: {kernel} launched {launched[kernel]} times in "
            f"{steps} steps")
  res.setdefault("counts_by_path", {})["optim"] = benchmark.kernel_launches()
  for name, run in OPTIM_RUNS.items():
    out[name]["parity"] = optim_parity(name, run["rate"])
  out["loss_scale"] = loss_scale_overflow()
  res["optim"] = out


def optim_parity(name, rate):
  """3 steps of ``name`` (clip 1.0, warmup rate, accuracy printed) at
  batch 8 from one init and one batch: the card (bf16, kernels) against
  the CPU (f32, plain versions). Each step's loss within phase parity's
  2e-2; the classifier's total update with its norm within 5e-2 and its
  cosine >= 0.98."""
  from kf_benchmarks_tpu_torch import learning_rate
  from kf_benchmarks_tpu_torch import optimizers
  from kf_benchmarks_tpu_torch import params as params_lib
  from kf_benchmarks_tpu_torch import train_step
  from kf_benchmarks_tpu_torch.models import resnet_model
  model = resnet_model.create_resnet50_model()
  gen = torch.Generator().manual_seed(9)
  init = model.make_module(1001, torch.float32, generator=gen).state_dict()
  rng = np.random.default_rng(9)
  images = torch.from_numpy((np.clip(rng.normal(size=(8, 224, 224, 3)), -2,
                                     2) * 60.0 + 127.0).astype(np.float32))
  labels = torch.from_numpy(rng.integers(0, 1001, 8))
  p = params_lib.make_params(device="cpu",
                             **optim_flags(name, rate, "warmup"))
  got = {}
  for arm, device, dtype in (("card", "cuda", torch.bfloat16),
                             ("cpu", "cpu", torch.float32)):
    module = model.make_module(1001, dtype).to(device)
    module.load_state_dict(init)
    opt = optimizers.get_optimizer(p, module.parameters())
    # An epoch of 3 steps: the warmup rate changes at every step.
    lr_fn = learning_rate.make_learning_rate_fn(p, model, 8, 24)
    step = train_step.TrainStep(model, module, opt, lr_fn, 4e-5,
                                gradient_clip=p.gradient_clip,
                                print_accuracy=True)
    losses = [float(step(images.to(device), labels.to(device))["base_loss"])
              for _ in range(3)]
    upd = (module.affine0.weight.detach().float().cpu() -
           init["affine0.weight"])
    got[arm] = (losses, upd)
  (lc, uc), (lr_, ur) = got["card"], got["cpu"]
  uc, ur = uc.double(), ur.double()
  rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lr_))
  n_rel = abs(float(uc.norm()) - float(ur.norm())) / float(ur.norm())
  cos = float((uc * ur).sum() / (uc.norm() * ur.norm()))
  log(f"optim parity {name}: losses card {[round(x, 5) for x in lc]} cpu "
      f"{[round(x, 5) for x in lr_]} (max rel {rel:.3g}, tol 2e-2); "
      f"classifier update norm rel {n_rel:.2g} (tol 5e-2), cosine {cos:.4f} "
      f"(tol 0.98)")
  check(rel <= 2e-2 and n_rel <= 5e-2 and cos >= 0.98,
        f"optim parity {name}: the card differs from the CPU")
  return {"loss_rel": rel, "update_norm_rel": n_rel, "update_cosine": cos}


def loss_scale_overflow():
  """ResNet-50 at batch 256, bf16, Nesterov momentum, the auto loss scale
  from 2^127 (--fp16_enable_auto_loss_scale --fp16_loss_scale=2**127):
  the first steps' gradients are non-finite. Every skipped step must leave
  the weights, the optimizer's buffers and the batch-norm averages bitwise
  as they were and halve the scale, and the run must reach an applied
  step; then an overflow planted after that (the scale set back to 2^127)
  must be skipped with the momentum buffers unchanged too."""
  from kf_benchmarks_tpu_torch import benchmark
  _, step, images, labels = benchmark.BenchmarkCNN(resnet_params(
      fp16_enable_auto_loss_scale=True, fp16_loss_scale=2.0 ** 127,
      fp16_inc_loss_scale_every_n=1000)).build()
  module, opt = step.module, step.optimizer

  def state():
    from kf_benchmarks_tpu_torch import train_step
    return ([q.detach().clone() for q in module.parameters()] +
            [b.clone() for b in train_step.batch_stats(module)] +
            [v.clone() for st in opt.state.values() for v in st.values()
             if isinstance(v, torch.Tensor)])

  trace = []
  skipped_unchanged = []
  planted = None
  for i in range(24):
    if step.update_count == 1 and planted is None:
      planted = i
      step.loss_scale = 2.0 ** 127  # the planted overflow
    scale = step.loss_scale
    before = state()
    count = step.update_count
    step(images, labels)
    skipped = step.update_count == count
    trace.append((math.log2(scale), skipped))
    if skipped:
      after = state()
      skipped_unchanged.append(len(before) == len(after) and all(
          torch.equal(a, b) for a, b in zip(before, after)))
      check(step.loss_scale == scale / 2,
            f"loss scale: {scale} -> {step.loss_scale} on a skipped step")
    if step.update_count == 2:
      break
  log(f"loss scale: (log2 scale, skipped) per step {trace}; "
      f"{sum(s for _, s in trace)} skipped steps, each bitwise unchanged: "
      f"{all(skipped_unchanged)}; momentum buffers held over the planted "
      f"overflow: {len(opt.state)} tensors")
  check(trace[0][1], "loss scale: the first step was not skipped")
  check(all(skipped_unchanged), "loss scale: a skipped step changed state")
  check(step.update_count == 2, "loss scale: no applied step after the "
        "planted overflow")
  check(trace[planted][1], "loss scale: the planted overflow was not "
        "skipped")
  return {"trace": trace, "skipped": sum(s for _, s in trace)}


# -- multi-step dispatch, accumulation, captured serving programs -------------

DISPATCH_K = 8
# Two warmup dispatches at K = 8: phase observe's twin run is the ResNet-50
# K = 8 arm, whose last warmup dispatch is then a replay.
DISPATCH_WARMUP, DISPATCH_STEPS = 2 * DISPATCH_K, 12
# The busy share's window: this many steps of each arm (one dispatch of
# them at K = 8), profiled after as many warm and as many timed.
BUSY_STEPS = 4
# Launches of each kernel a training step (one microbatch).
RESNET_LAUNCHES = {"conv3x3_same": 13, "bn_relu_conv3x3_stats": 13}
LM_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd_dkv": 6,
               "flash_attention_bwd_dq": 6}
# The step's stale modes in phase dispatch: (label, flags), each at K = 1
# and K = 8 for STALE_WARMUP + STALE_STEPS steps.
STALE_ARMS = (("staged_vars", dict(variable_update="parameter_server",
                                   staged_vars=True)),
              ("relaxed", dict(variable_update="replicated",
                               variable_consistency="relaxed")))
STALE_WARMUP, STALE_STEPS = 4, 8


def resnet_train_params(**kw):
  from kf_benchmarks_tpu_torch import params as params_lib
  return params_lib.make_params(model="resnet50", batch_size=256,
                                use_fp16=True, optimizer="momentum",
                                device="gpu", **kw)


def bench_arm(params):
  """BenchmarkCNN(params).run() with every launch count set to 0 just
  before and read just after: (bench, stats, counts, peak GiB)."""
  from kf_benchmarks_tpu_torch import benchmark
  bench = benchmark.BenchmarkCNN(params)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  reset_launches()
  stats = bench.run()
  counts = benchmark.kernel_launches()
  return bench, stats, counts, torch.cuda.max_memory_allocated() / 2**30


def check_launches(label, counts, per_step, steps):
  """Every kernel launched per_step[name] times a step, the others not."""
  for name, n in counts.items():
    want = per_step.get(name, 0) * steps
    check(n == want, f"{label}: {name} launched {n} times in {steps} steps, "
          f"want {per_step.get(name, 0)} a step")


def phase_dispatch(res):
  """--steps_per_dispatch through BenchmarkCNN: ResNet-50 (batch 256, bf16,
  momentum) and transformer_lm (batch 8, flash), each 16 warmup + 12 timed
  steps at K = 1 (eager steps) and at K = 8 (one CUDA graph replayed a
  step) from the same seed; losses and final weights bitwise equal, equal
  launches a step; the rate, compile_s, dispatch_overhead_s, peak memory
  and the busy share of 4 more steps of each arm."""
  res["dispatch"] = {}
  runs = (("resnet50", resnet_train_params, RESNET_LAUNCHES, "images/sec"),
          ("transformer_lm", lm_params, LM_LAUNCHES, "sequences/sec"))
  for model, make, per_step, unit in runs:
    arms = {}
    with lm_attention("flash"):
      for k in (1, DISPATCH_K):
        label = f"dispatch: {model} K={k}"
        bench, stats, counts, peak = bench_arm(make(
            num_batches=DISPATCH_STEPS, num_warmup_batches=DISPATCH_WARMUP,
            display_every=DISPATCH_STEPS, steps_per_dispatch=k))
        final = bench.final
        weights = [q.detach().clone() for q in final["module"].parameters()]
        steps = stats["steps_run"]
        res.setdefault("counts_by_path", {})[
            f"dispatch_{model}_k{k}"] = counts
        check_launches(label, counts, per_step, steps)
        if k == 1:
          fn, n = (lambda: final["step"](final["images"], final["labels"]),
                   BUSY_STEPS)
        else:
          fn, n = (lambda: final["chunk"](final["images"], final["labels"],
                                          BUSY_STEPS), 1)
        wall, kern, _ = profile_window(fn, n)
        dev, hidden = device_behind_spin_s(fn, n, wall)
        arms[k] = dict(losses=stats["losses"], weights=weights,
                       rate=stats["images_per_sec"],
                       compile_s=stats["compile_s"],
                       dispatch_overhead_s=stats["dispatch_overhead_s"],
                       wall_ms=wall * 1e3, profiler_kernel_ms=kern * 1e3,
                       profiler_busy=kern / wall,
                       device_ms=dev * 1e3, device_busy=dev / wall,
                       device_hidden=hidden,
                       peak_gib=peak,
                       launches_per_step={n: c // steps
                                          for n, c in counts.items() if c})
        log(f"{label}: {stats['images_per_sec']:.2f} {unit}, compile_s "
            f"{stats['compile_s']:.3f}, dispatch_overhead_s "
            f"{stats['dispatch_overhead_s'] * 1e3:.3f} ms, "
            f"{stats['num_dispatches']} timed dispatches, peak memory "
            f"{peak:.2f} GiB, launches a step "
            f"{arms[k]['launches_per_step']}; {BUSY_STEPS} more steps: wall "
            f"{wall * 1e3:.1f} ms; torch.profiler's kernel time "
            f"{kern * 1e3:.1f} ms (share {kern / wall:.3f}); device time "
            f"behind a spin {dev * 1e3:.1f} ms (share "
            f"{spin_share(dev, hidden, wall)})")
        log(f"{label}: losses {stats['losses']}")
        if (model == "resnet50" and k == DISPATCH_K and
            "observe" in res.get("phases", ())):
          # Phase observe's flags-off twin, when it runs.
          res["observe_twin"] = dict(stats=stats, counts=counts,
                                     weights=weights)
        del bench, final
    one, many = arms[1], arms[DISPATCH_K]
    same_weights = all(torch.equal(a, b) for a, b in
                       zip(one["weights"], many["weights"]))
    spun = [spin_share(a["device_ms"], a["device_hidden"], a["wall_ms"])
            for a in (one, many)]
    log(f"dispatch: {model}: K={DISPATCH_K} against K=1: losses "
        f"{'bitwise equal' if one['losses'] == many['losses'] else 'DIFFER'}"
        f", final weights {'bitwise equal' if same_weights else 'DIFFER'}; "
        f"{unit} {many['rate'] / one['rate']:.3f}x; busy share by "
        f"torch.profiler K=1 {one['profiler_busy']:.3f}, K={DISPATCH_K} "
        f"{many['profiler_busy']:.3f}; by device time behind a spin K=1 "
        f"{spun[0]}, K={DISPATCH_K} {spun[1]}")
    check(one["losses"] == many["losses"],
          f"dispatch {model}: K={DISPATCH_K} losses differ from K=1")
    check(same_weights, f"dispatch {model}: K={DISPATCH_K} weights differ "
          "from K=1")
    check(one["launches_per_step"] == many["launches_per_step"],
          f"dispatch {model}: launches a step differ")
    for arm in arms.values():
      del arm["weights"]
    res["dispatch"][model] = arms
    torch.cuda.empty_cache()
  # The stale modes (ROADMAP Queue 1 item 12) on ResNet-50: K = 8 bitwise 8
  # single steps, K-A and K-B 13 + 13 a step, the rate beside the plain
  # step's.
  plain = res["dispatch"]["resnet50"]
  for label, flags in STALE_ARMS:
    arms = {}
    for k in (1, DISPATCH_K):
      bench, stats, counts, peak = bench_arm(resnet_train_params(
          num_batches=STALE_STEPS, num_warmup_batches=STALE_WARMUP,
          display_every=STALE_STEPS, steps_per_dispatch=k, **flags))
      res.setdefault("counts_by_path", {})[f"dispatch_{label}_k{k}"] = \
          counts
      check_launches(f"dispatch: {label} K={k}", counts, RESNET_LAUNCHES,
                     stats["steps_run"])
      arms[k] = dict(losses=stats["losses"], rate=stats["images_per_sec"],
                     peak_gib=peak, weights=[
                         q.detach().clone()
                         for q in bench.final["module"].parameters()])
      del bench
    one, many = arms[1], arms[DISPATCH_K]
    same = (one["losses"] == many["losses"] and all(
        torch.equal(a, b) for a, b in zip(one["weights"], many["weights"])))
    check(same, f"dispatch {label}: K={DISPATCH_K} differs from K=1")
    log(f"dispatch: resnet50 {label} ({flags}): {STALE_WARMUP} warmup + "
        f"{STALE_STEPS} timed steps; K={DISPATCH_K} bitwise K=1 (losses and "
        f"weights), K-A / K-B 13 + 13 a step; images/sec K=1 "
        f"{one['rate']:.2f} (plain step {plain[1]['rate']:.2f}), "
        f"K={DISPATCH_K} {many['rate']:.2f} (plain step "
        f"{plain[DISPATCH_K]['rate']:.2f}); peak memory "
        f"{one['peak_gib']:.2f} / {many['peak_gib']:.2f} GiB (plain "
        f"{plain[1]['peak_gib']:.2f} / {plain[DISPATCH_K]['peak_gib']:.2f})")
    for arm in arms.values():
      del arm["weights"]
    res["dispatch"][label] = arms
    torch.cuda.empty_cache()


# Phase observe: ResNet-50 at phase dispatch's K = 8 arm with every
# observability flag on, against that arm (or, when phase dispatch is not in
# the run, the same run made here). Two warmup dispatches, so that the last,
# which --trace_file profiles, is a replay outside the timed window.
OBSERVE_SUMMARY_EVERY = 4


def free_port() -> int:
  import socket
  with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    return sock.getsockname()[1]


def scrape_while(port, stop, out):
  """Polls /metrics on 127.0.0.1:port until a scrape carries the live
  training lanes (kf_step), then reads /healthz once; files both in
  out. Ends when ``stop`` is set."""
  import urllib.request
  while not stop.is_set():
    try:
      with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                  timeout=2) as r:
        text = r.read().decode()
      if "\nkf_step " in "\n" + text:
        out["metrics"] = text
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=2) as r:
          out["healthz"] = json.loads(r.read().decode())
        return
    except OSError:
      pass
    stop.wait(0.05)


def observe_flags(root, port):
  """Every observability flag, its files under root."""
  from kf_benchmarks_tpu_torch.ops import _build
  f = lambda name: os.path.join(root, name)
  return dict(trace_file=f("step_trace.json"), tfprof_file=f("tfprof.json"),
              graph_file=f("graph.txt"),
              partitioned_graph_file_prefix=f("partitioned"),
              trace_events_file=f("events.json"),
              benchmark_log_dir=f("benchmark_log"), train_dir=f("train"),
              summary_verbosity=1,
              save_summaries_steps=OBSERVE_SUMMARY_EVERY,
              run_store_dir=f("store"), metrics_port=port,
              compilation_cache_dir=_build.build_root(),
              # Off as in the twin (the --train_dir would turn them on).
              health_stats=False)


# Phase observe_pairs: the arms, run in this order and then in reverse.
OBSERVE_PAIR_ARMS = ("off", "on", "on_without_trace_file")


def phase_observe_pairs(res):
  """Not in the default run: phase observe's ResNet-50 run (K = 8, 16
  warmup + 12 timed steps) with every observability flag off, all on, and
  all on but --trace_file, in the order off, on, on without the trace,
  then the reverse, nothing scraping /metrics: each run's images/sec, so
  that the flags' own cost can be told from the spread between runs."""
  import shutil
  common = dict(num_batches=DISPATCH_STEPS,
                num_warmup_batches=DISPATCH_WARMUP,
                display_every=DISPATCH_STEPS, steps_per_dispatch=DISPATCH_K)
  rates = {}
  for arm in OBSERVE_PAIR_ARMS + OBSERVE_PAIR_ARMS[::-1]:
    root = tempfile.mkdtemp(prefix="observe_pairs_")
    try:
      flags = {} if arm == "off" else observe_flags(root, free_port())
      if arm == "on_without_trace_file":
        del flags["trace_file"]
      _, stats, counts, _ = bench_arm(resnet_train_params(**common, **flags))
      check_launches(f"observe_pairs ({arm})", counts, RESNET_LAUNCHES,
                     stats["steps_run"])
      rates.setdefault(arm, []).append(stats["images_per_sec"])
      log(f"observe_pairs: {arm}: {stats['images_per_sec']:.2f} images/sec")
    finally:
      shutil.rmtree(root, ignore_errors=True)
  log("observe_pairs: images/sec by arm (first pass, second pass): " +
      "; ".join(f"{arm} " + ", ".join(f"{r:.2f}" for r in rates[arm])
                for arm in OBSERVE_PAIR_ARMS))
  res["observe_pairs"] = rates


def phase_observe(res):
  """The observability flags through BenchmarkCNN: ResNet-50 (batch 256,
  bf16, momentum) at K = 8, 16 warmup + 12 timed steps, once with
  --trace_file, --tfprof_file, --graph_file,
  --partitioned_graph_file_prefix, --trace_events_file,
  --benchmark_log_dir, --summary_verbosity=1 --save_summaries_steps=4 (with
  the --train_dir that needs), --run_store_dir, --metrics_port and
  --compilation_cache_dir on and once with them all off (phase dispatch's
  K = 8 arm when it ran), the health stats off in both: losses and final weights bitwise equal, 13 + 13 K-A / K-B
  launches a step in both, the traced dispatch a replay outside the timed
  window, a mid-run /metrics scrape valid Prometheus text with the live
  lanes and /healthz answering, the span timeline a valid Chrome trace,
  the run record valid with platform gpu, 13 K-B nodes in the program
  text; then the traced replay's measured per-op table, K-A's and K-B's
  shares of its kernel time, the counted FLOPs a step, the MFU and both
  runs' images/sec."""
  import threading
  from kf_benchmarks_tpu_torch import metrics as metrics_lib
  from kf_benchmarks_tpu_torch import observability
  from kf_benchmarks_tpu_torch import tracing
  common = dict(num_batches=DISPATCH_STEPS,
                num_warmup_batches=DISPATCH_WARMUP,
                display_every=DISPATCH_STEPS, steps_per_dispatch=DISPATCH_K)
  arms = {"off": res.pop("observe_twin", None)}
  if arms["off"] is None:
    bench, stats, counts, _ = bench_arm(resnet_train_params(**common))
    arms["off"] = dict(stats=stats, counts=counts, weights=[
        q.detach().clone() for q in bench.final["module"].parameters()])
    del bench
  root = tempfile.mkdtemp(prefix="observe_")
  try:
    port = free_port()
    on = observe_flags(root, port)
    scraped, stop = {}, threading.Event()
    scraper = threading.Thread(target=scrape_while,
                               args=(port, stop, scraped), daemon=True)
    scraper.start()
    try:
      bench, stats, counts, _ = bench_arm(resnet_train_params(**common,
                                                              **on))
    finally:
      stop.set()
      scraper.join(timeout=10)
    arms["on"] = dict(stats=stats, counts=counts, weights=[
        q.detach().clone() for q in bench.final["module"].parameters()])
    del bench
    for arm in ("off", "on"):
      a = arms[arm]
      res.setdefault("counts_by_path", {})[
          "observe" if arm == "on" else "observe_off"] = a["counts"]
      check_launches(f"observe ({arm})", a["counts"], RESNET_LAUNCHES,
                     a["stats"]["steps_run"])
    off, on_ = arms["off"], arms["on"]
    same = (off["stats"]["losses"] == on_["stats"]["losses"] and all(
        torch.equal(a, b) for a, b in zip(off["weights"], on_["weights"])))
    check(same, "observe: the flags-on run's losses or weights differ")
    traced = on_["stats"]["traced_dispatch"]
    check(bool(traced) and traced["replay"] and not traced["timed"],
          f"observe: the traced dispatch {traced} is not an untimed replay")
    check("metrics" in scraped, "observe: no mid-run /metrics scrape "
          "carried the live lanes")
    problems = metrics_lib.validate_prometheus_text(scraped["metrics"])
    check(not problems, f"observe: /metrics: {problems[:3]}")
    check(scraped["healthz"].get("status") == "ok",
          f"observe: /healthz {scraped['healthz']}")
    with open(on["trace_events_file"]) as fh:
      timeline = json.load(fh)
    problems = tracing.validate_chrome_trace(timeline)
    check(not problems, f"observe: span timeline: {problems[:3]}")
    lanes = sorted({e.get("cat") for e in timeline["traceEvents"]
                    if e.get("ph") != "M"})
    records = metrics_lib.RunStore(on["run_store_dir"]).records()
    check(len(records) == 1 and not metrics_lib.validate_record(records[0])
          and records[0]["platform"] == "gpu",
          f"observe: run store {records}")
    with open(on["graph_file"]) as fh:
      kb_nodes = fh.read().count("torch.ops.kf_torch.bn_relu_conv3x3_stats"
                                 ".default(")
    check(kb_nodes == RESNET_LAUNCHES["bn_relu_conv3x3_stats"],
          f"observe: {kb_nodes} K-B nodes in the program text, want 13")
    rep = kernel_report("observe", on["trace_file"])
    flops = on_["stats"]["step_flops"]
    rates = {arm: arms[arm]["stats"]["images_per_sec"] for arm in arms}
    ledger = on_["stats"]["compile_ledger"]
    log(f"observe: losses and final weights bitwise equal flags on and off; "
        f"K-A / K-B 13 + 13 a step in both; traced dispatch {traced} (a "
        f"replay of {traced['steps']} steps, outside the timed window); "
        f"/metrics scrape {len(scraped['metrics'])} bytes, valid, "
        f"/healthz {scraped['healthz'].get('status')}; span lanes {lanes}; "
        f"run record valid (platform gpu, {records[0]['device_name']}); "
        f"{kb_nodes} K-B nodes in the program text; compile ledger "
        f"{ledger['shapes']} shape(s), {ledger['total_compile_s']:.3f} s, "
        f"cache_hit {[e.get('cache_hit') for e in ledger['entries']]}")
    log(f"observe: counted FLOPs a step {flops:.4e}; "
        + observability.mfu_line(flops, 256 / rates["on"], source="measured"))
    log(f"observe: images/sec flags off {rates['off']:.2f}, flags on "
        f"{rates['on']:.2f} ({rates['on'] / rates['off']:.4f}x); traced "
        f"replay: kernel time {rep['kernel_s'] * 1e3:.3f} ms, busy share of "
        f"its extent {rep['kernel_s'] / rep['extent_s']:.4f}; K-A share "
        f"{rep['shares'].get('conv3x3_same', 0.0):.4f}, K-B share "
        f"{rep['shares'].get('bn_relu_conv3x3_stats', 0.0):.4f}")
    res["observe"] = dict(rates=rates, flops=flops, traced=traced,
                          shares=rep["shares"], kernel_s=rep["kernel_s"],
                          extent_s=rep["extent_s"])
  finally:
    import shutil
    shutil.rmtree(root, ignore_errors=True)


ACCUM_WARMUP, ACCUM_STEPS = 4, 8
# The LM at M = 2 against M = 1 (no batch norm): bf16 activations, the
# batch's mean loss split in two; each step's loss within 1e-4 relative.
# A planted fault that divides the accumulated gradient by M twice halves
# every SGD update, which is the M = 2 run at half the rate: the phase
# runs that too and wants its last losses outside the limit.
ACCUM_LM_RTOL = 1e-4
ACCUM_LM_RATE = 0.05  # the LM's own (transformer_lm.py), halved below


def check_flash_at(label, args, seed):
  """The flash forward and the Function's gradients (dK/dV and dQ
  kernels) against their plain versions on one call's own inputs (q, k
  and v the qkv.unbind(2) views, as the LM passes them), with phase
  flash's and phase flash_grad's tolerances; rows for the three
  kernels."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  q, k, v, causal, scale, q_seg, kv_seg = args
  o, lse = fa.flash_attention_fwd(*args)
  o_ref, lse_ref = fa.flash_attention_fwd_plain(*args)
  err, ok = bf16_close(o, o_ref)
  lse_err = float(((lse - lse_ref).abs() /
                   lse_ref.abs().clamp_min(1.0)).max())
  check(ok and lse_err <= 1e-3, f"flash {label}: forward o max abs err "
        f"{err}, lse rel err {lse_err}")
  g = torch.Generator(device="cuda").manual_seed(seed)
  do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
  qkv = torch.stack((q, k, v), dim=2)

  def grads(fn):
    leaf = qkv.clone().requires_grad_()
    return torch.autograd.grad(fn(*leaf.unbind(2)), leaf, do)[0].unbind(2)

  got = grads(lambda *x: fa.flash_attention(*x, causal=causal, scale=scale,
                                            q_seg=q_seg, kv_seg=kv_seg))
  ref = grads(lambda *x: fa.flash_attention_fwd_plain(
      *x, causal, scale, q_seg, kv_seg)[0])
  errs = {}
  for name, a, r in zip(("dq", "dk", "dv"), got, ref):
    e = float((a.float() - r.float()).abs().max())
    m = float(r.float().abs().max())
    errs[name] = e
    check(math.isfinite(e) and e <= 3e-2 * m,
          f"flash {label} {name}: err {e} > 3e-2 * {m}")
  b, lq, h, d = q.shape
  log(f"flash {label}: the run's own q[{b},{lq},{h},{d}] (strides "
      f"{q.stride()}) causal={causal}: o max abs err {err:.3g} (tol one "
      f"bf16 ulp + 1e-3 max|ref|), lse rel err {lse_err:.2g} (tol 1e-3); "
      f"dq / dk / dv max abs err {errs['dq']:.3g} / {errs['dk']:.3g} / "
      f"{errs['dv']:.3g} (tol 3e-2 of each max |ref|)")
  base = dict(stage=label, shape=[b, lq, k.shape[1], h, d], causal=causal,
              mask=None if q_seg is None else "segments")
  return {"flash_attention_fwd": dict(base, max_abs_err=err,
                                      lse_rel_err=lse_err),
          "flash_attention_bwd_dkv": dict(base, max_abs_err=max(
              errs["dk"], errs["dv"])),
          "flash_attention_bwd_dq": dict(base, max_abs_err=errs["dq"])}


def phase_accum(res):
  """--num_grad_accum through BenchmarkCNN: ResNet-50 (batch 256, bf16,
  momentum) at M = 1, and at M = 4 under K = 1 and K = 4 (losses bitwise
  equal between the two; peak memory below M = 1's; K-A and K-B 4 x 13 a
  step), each 4 warmup + 8 timed steps; K-A and K-B against their plain
  versions at every shape the M = 4 runs gave them (batch 64).
  transformer_lm (batch 8, flash) at M = 2 against M = 1, and against M =
  2 at half the rate (a planted fault's reading); the flash kernels
  against their plain versions on the M = 2 run's own inputs (batch 4)."""
  res["accum"] = {}
  arms = {}
  shapes = {"conv3x3_same": set(), "bn_relu_conv3x3_stats": set()}
  for m, k in ((1, 1), (4, 1), (4, 4)):
    label = f"accum: resnet50 M={m} K={k}"
    noting = (noting_unit_shapes(shapes) if m > 1
              else contextlib.nullcontext())
    with noting:
      _, stats, counts, peak = bench_arm(resnet_train_params(
          num_batches=ACCUM_STEPS, num_warmup_batches=ACCUM_WARMUP,
          display_every=ACCUM_STEPS, num_grad_accum=m, steps_per_dispatch=k))
    steps = stats["steps_run"]
    res.setdefault("counts_by_path", {})[f"accum_resnet50_m{m}_k{k}"] = \
        counts
    check_launches(label, counts,
                   {n: m * c for n, c in RESNET_LAUNCHES.items()}, steps)
    arms[(m, k)] = dict(losses=stats["losses"], peak_gib=peak,
                        rate=stats["images_per_sec"])
    log(f"{label}: {stats['images_per_sec']:.2f} images/sec, peak memory "
        f"{peak:.3f} GiB, launches {counts} in {steps} steps; losses "
        f"{stats['losses']}")
  check(arms[(4, 1)]["losses"] == arms[(4, 4)]["losses"],
        "accum: M=4 losses differ between K=1 and K=4")
  check(arms[(4, 1)]["peak_gib"] < arms[(1, 1)]["peak_gib"],
        "accum: peak memory at M=4 not below M=1")
  log(f"accum: resnet50 M=4 K=4 losses bitwise equal to M=4 K=1; peak "
      f"memory M=1 {arms[(1, 1)]['peak_gib']:.3f} GiB, M=4 "
      f"{arms[(4, 1)]['peak_gib']:.3f} GiB")
  res["accum"]["resnet50"] = {f"m{m}_k{k}": v for (m, k), v in arms.items()}
  res["accum"]["resnet50_shapes"] = {n: sorted(v) for n, v in shapes.items()}
  # The kernels at the microbatch's shapes; K-A also at K-B's, as in
  # phase zoo.
  micro = 256 // 4
  for name, check_at, at in (
      ("conv3x3_same", check_conv_at,
       shapes["conv3x3_same"] | shapes["bn_relu_conv3x3_stats"]),
      ("bn_relu_conv3x3_stats", check_unit_at,
       shapes["bn_relu_conv3x3_stats"])):
    check(at and all(n == micro for n, *_ in at),
          f"accum: {name} shapes {sorted(at)}, want batch {micro}")
    for i, (n, h, w, c, co) in enumerate(sorted(at)):
      res.setdefault(name, []).append(check_at(
          f"accum_{h}x{w}_{c}_{co}", n, h, w, c, co, seed=120 + i))
  lm = {}
  calls = {}
  with lm_attention("flash"):
    for arm, m, rate in (("m1", 1, None), ("m2", 2, None),
                         ("m2_half_rate", 2, ACCUM_LM_RATE / 2)):
      noting = (capturing_flash_inputs(calls) if arm == "m2"
                else contextlib.nullcontext())
      with noting:
        _, stats, counts, peak = bench_arm(lm_params(
            num_batches=ACCUM_STEPS, num_warmup_batches=ACCUM_WARMUP,
            display_every=ACCUM_STEPS, num_grad_accum=m,
            init_learning_rate=rate))
      res["counts_by_path"][f"accum_lm_{arm}"] = counts
      check_launches(f"accum: transformer_lm {arm}", counts,
                     {n: m * c for n, c in LM_LAUNCHES.items()},
                     stats["steps_run"])
      lm[arm] = dict(losses=stats["losses"], peak_gib=peak,
                     rate=stats["images_per_sec"])
      log(f"accum: transformer_lm {arm}: {stats['images_per_sec']:.2f} "
          f"sequences/sec, peak memory {peak:.3f} GiB; losses "
          f"{stats['losses']}")
  gap = lambda a: max(abs(x - y) / abs(y) for x, y in zip(
      lm[a]["losses"], lm["m1"]["losses"]))
  rel, planted = gap("m2"), gap("m2_half_rate")
  first, last = lm["m1"]["losses"][0], lm["m1"]["losses"][-1]
  log(f"accum: transformer_lm M=2 against M=1: largest relative loss "
      f"difference {rel:.3g} (tol {ACCUM_LM_RTOL:.3g}); M=2 at half the "
      f"rate (a gradient divided by M twice) {planted:.3g}; M=1's loss "
      f"moves {abs(first - last) / abs(first):.3g} relative over the "
      f"{len(lm['m1']['losses'])} timed steps")
  check(rel <= ACCUM_LM_RTOL, "accum: transformer_lm M=2 losses differ")
  check(planted > ACCUM_LM_RTOL, "accum: transformer_lm M=2 at half the "
        "rate within the limit: the limit cannot see a halved update")
  res["accum"]["transformer_lm"] = lm
  check(len(calls) == 1 and all(key[0][0] == 8 // 2 for key in calls),
        f"accum: transformer_lm M=2 flash shapes {list(calls)}")
  for (qs, _, _, _), args in calls.items():
    for name, row in check_flash_at(f"accum_lm_b{qs[0]}", args,
                                    seed=130).items():
      res.setdefault(name, []).append(row)
  torch.cuda.empty_cache()


def tick_clock(tick_s=1e-3):
  """(time_fn, sleep_fn) of a virtual clock: each read advances it by
  tick_s, a sleep by its length. An engine reads it the same number of
  times a tick whatever runs its programs, so two engines replay one
  workload into the same waves and batches."""
  t = [0.0]

  def now():
    t[0] += tick_s
    return t[0]

  def sleep(s):
    t[0] += max(0.0, s)

  return now, sleep


def phase_serve_graph(res):
  """Replay (a) -- 32 requests at 16/s, 32 new tokens each -- through the
  engine with its programs eager and with them captured (the default on
  the card). On the wall clock: tokens/sec, TTFT and token latency of
  both, launches 6 a decode step and 6 a prefill wave, at most
  len(ladder) decode captures. The batches a wall-clock replay forms
  follow the engine's speed, and a bucket's bf16 products round per
  batch width, so the two are also replayed on a virtual clock
  (``tick_clock``), where both form the same batches: there every
  generated token must be identical. Then 20 decode steps at bucket 64 of
  each, profiled."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import metrics as metrics_lib
  from kf_benchmarks_tpu_torch import tracing
  from kf_benchmarks_tpu_torch.data import packing
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  from kf_benchmarks_tpu_torch.serving import engine as engine_lib
  spec = serve_spec()
  variables = decode_lib.init_variables(spec, seed=0)
  _, rate, depth = SERVE_REPLAYS[0]
  cfg = engine_lib.EngineConfig(spec=spec, max_new_tokens=SERVE_MAX_NEW,
                                max_queue_depth=depth)
  lengths = packing.sample_document_lengths(
      np.random.default_rng(0), 64, spec.max_len,
      mean_fraction=0.2).astype(np.int32)
  arms = {}
  for arm, eager in (("eager", True), ("graph", False)):
    workload = engine_lib.poisson_workload(SERVE_REQUESTS, rate, spec,
                                           seed=0,
                                           max_new_tokens=SERVE_MAX_NEW)
    trace = tracing.activate(tracing.RunTrace(keep_spans=True))
    metrics_lib.activate(metrics_lib.MetricRegistry())
    try:
      engine = engine_lib.ServingEngine(cfg, variables=variables,
                                        device="cuda",
                                        _eager_programs=eager)
      t0 = time.time()
      engine.warm()
      warm_s = time.time() - t0
      reset_launches()
      results = engine.replay(workload)
      counts = benchmark.kernel_launches()
      stats = engine.stats()
      ledger = trace.compile_ledger()["entries"]
    finally:
      tracing.deactivate()
      metrics_lib.deactivate()
    waves = sum(1 for s in trace.spans
                if (s["sub"], s["name"]) == ("serving", "prefill"))
    steps = stats["serving/decode_steps"]
    res.setdefault("counts_by_path", {})[f"serve_graph_{arm}"] = counts
    want = {"flash_decode": 6 * steps, "flash_attention_fwd": 6 * waves}
    for name, n in counts.items():
      check(n == want.get(name, 0), f"serve_graph {arm}: {name} launched "
            f"{n} times, want {want.get(name, 0)} ({steps} decode steps, "
            f"{waves} prefill waves)")
    captures = [e for e in ledger if e["program"] == "serving_decode"]
    check(len(captures) <= len(cfg.bucket_ladder) and
          all(e["captured"] == (not eager) for e in ledger),
          f"serve_graph {arm}: compile ledger {ledger}")
    check(stats["serving/completed"] == SERVE_REQUESTS,
          f"serve_graph {arm}: {stats['serving/completed']} completed")
    arms[arm] = dict(
        tokens=[(r.rid, r.status, list(r.tokens)) for r in results],
        tokens_per_sec=stats["serving/tokens_per_sec"],
        ttft_p50=stats["serving/ttft_p50"], ttft_p99=stats["serving/ttft_p99"],
        token_latency_p50=stats["serving/token_latency_p50"],
        token_latency_p99=stats["serving/token_latency_p99"],
        warm_s=warm_s, prepared=len(ledger), decode_steps=steps,
        waves=waves)
    # 20 decode steps at bucket 64, every slot decoding, positions drawn
    # like the workload's prompt lengths; each step ends in the engine's
    # value fetch.
    exe = engine._decode_exe(64)
    engine._ring_state().pos[:64].copy_(torch.from_numpy(lengths))
    engine._active_buf[:64].fill_(True)
    wall, kern, _ = profile_window(lambda: exe()[0].cpu(), 20)
    dev, hidden = device_behind_spin_s(exe, 20, wall)
    arms[arm].update(
        decode64_wall_ms=wall * 1e3 / 20,
        decode64_profiler_kernel_ms=kern * 1e3 / 20,
        decode64_profiler_busy=kern / wall,
        decode64_device_ms=dev * 1e3 / 20, decode64_device_busy=dev / wall,
        decode64_device_hidden=hidden)
    del engine, exe
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve_graph: {arm}: warm() {warm_s:.1f} s for {len(ledger)} "
        f"programs ({len(captures)} decode); replay (a) "
        f"{stats['serving/tokens_per_sec']:.1f} tokens/sec, TTFT p50 "
        f"{stats['serving/ttft_p50'] * 1e3:.1f} ms p99 "
        f"{stats['serving/ttft_p99'] * 1e3:.1f} ms, token latency p50 "
        f"{stats['serving/token_latency_p50'] * 1e3:.2f} ms p99 "
        f"{stats['serving/token_latency_p99'] * 1e3:.2f} ms, {steps} decode "
        f"steps, {waves} prefill waves; launches {counts}; 20 decode steps "
        f"at bucket 64: wall {wall * 1e3:.1f} ms, torch.profiler's kernel "
        f"time {kern * 1e3:.1f} ms (share {kern / wall:.3f}), device time "
        f"behind a spin (no value fetch) {dev * 1e3:.1f} ms (share "
        f"{spin_share(dev, hidden, wall)})")
  agree = sum(a == b for a, b in zip(arms["eager"]["tokens"],
                                     arms["graph"]["tokens"]))
  log(f"serve_graph: wall-clock replays: {agree} of {SERVE_REQUESTS} "
      f"requests generated the same tokens ({arms['eager']['decode_steps']}"
      f" and {arms['graph']['decode_steps']} decode steps)")
  virtual = {}
  for arm, eager in (("eager", True), ("graph", False)):
    now, sleep = tick_clock()
    engine = engine_lib.ServingEngine(cfg, variables=variables,
                                      device="cuda", _eager_programs=eager,
                                      time_fn=now, sleep_fn=sleep)
    engine.warm()
    results = engine.replay(engine_lib.poisson_workload(
        SERVE_REQUESTS, rate, spec, seed=0, max_new_tokens=SERVE_MAX_NEW))
    virtual[arm] = ([(r.rid, r.status, list(r.tokens)) for r in results],
                    engine.stats()["serving/decode_steps"])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
  same = virtual["eager"][0] == virtual["graph"][0]
  log(f"serve_graph: virtual-clock replays ({virtual['eager'][1]} and "
      f"{virtual['graph'][1]} decode steps): the graph engine's tokens "
      f"{'identical to' if same else 'DIFFER from'} the eager engine's "
      f"({SERVE_REQUESTS} requests, "
      f"{sum(len(t) for _, _, t in virtual['graph'][0])} tokens)")
  check(virtual["eager"][1] == virtual["graph"][1] and same,
        "serve_graph: graph engine tokens differ from eager")
  eager, graph = arms["eager"], arms["graph"]
  log(f"serve_graph: decode step at bucket 64: wall "
      f"{eager['decode64_wall_ms']:.3f} -> {graph['decode64_wall_ms']:.3f} "
      f"ms; busy share by torch.profiler "
      f"{eager['decode64_profiler_busy']:.3f} -> "
      f"{graph['decode64_profiler_busy']:.3f}, by device time behind a "
      f"spin " + " -> ".join(
          spin_share(a["decode64_device_ms"], a["decode64_device_hidden"],
                     a["decode64_wall_ms"]) for a in (eager, graph)))
  for arm in arms.values():
    del arm["tokens"]
  res["serve_graph"] = arms


# -- fp16_vars, health, faults ---------------------------------------------------

FP16_WARMUP, FP16_STEPS = 4, 8


def weight_casts(module, fn, n=2):
  """(casts of a weight, all aten::_to_copy) in n calls of fn() under
  torch.profiler: a cast of a weight is an aten::_to_copy whose input has
  the shape of a parameter of two or more dimensions (the per-call
  f32 -> bf16 weight copy; 1-D parameters, batch norm's and layer norm's,
  are upcast by design)."""
  from torch.profiler import ProfilerActivity, profile
  shapes = {tuple(q.shape) for q in module.parameters() if q.dim() >= 2}
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
  copies = [e for e in prof.events() if e.name == "aten::_to_copy"]
  casts = [e for e in copies
           if e.input_shapes and tuple(e.input_shapes[0]) in shapes]
  return len(casts), len(copies)


# One momentum step under --fp16_vars, held against the same step with f32
# parameters on the card and on the CPU (fp16_vars_step).
FP16_STEP_LR = 0.1
FP16_STEP_LOSS_RTOL = 2e-2  # against the CPU: bf16 activations (phase parity)
FP16_STEP_HEAD_NORM_RTOL = 5e-2  # the head's update against the CPU's
FP16_STEP_HEAD_COSINE = 0.98


def bf16_ulp(x):
  """The spacing of bf16 numbers at |x| (8 significant bits), 0 at 0."""
  _, exp = torch.frexp(x)
  return torch.where(x == 0, torch.zeros_like(x),
                     torch.ldexp(torch.ones_like(x), exp - 8))


def update_excess(new, start, update):
  """max |new - (start + update)| / (one bf16 ulp of start + update, plus
  2^-7 |update|): how far bf16 weights ``new`` lie from an f32 update
  rounded to bf16, where the update itself was computed in bf16 (a
  rounded gradient, momentum and step: three roundings of 2^-9). 1 or
  less passes."""
  target = start + update
  err = (new - target).abs()
  bound = bf16_ulp(target) + 2.0 ** -7 * update.abs()
  return float(torch.where(err == 0, torch.zeros_like(err), err / bound)
               .max())


def fp16_vars_step(label, model, module_fn, inputs, labels, head):
  """One training step under --fp16_vars on the card (bf16 compute over
  bf16 weights and bf16 Nesterov momentum, the kernels) from bf16-rounded
  weights, held against the same step from the same weights with f32
  parameters, on the card (the same compute and kernels: phase parity's
  path) and on the CPU (f32 compute, the plain versions). Held: the loss
  within FP16_STEP_LOSS_RTOL of the CPU's and bitwise the f32-parameter
  step's; every tensor's new weights within one bf16 ulp
  plus 2^-7 of the update of the f32-parameter step's (``update_excess``),
  a bound that the same step's update doubled must break in every tensor
  where it moves a weight by 2 bf16 ulps; the head's update (``head``) against the CPU's rounded to
  bf16, norm within FP16_STEP_HEAD_NORM_RTOL and cosine at least
  FP16_STEP_HEAD_COSINE, as phase parity holds the classifier; the
  momentum buffers bf16."""
  from kf_benchmarks_tpu_torch import optimizers
  from kf_benchmarks_tpu_torch import params as params_lib
  from kf_benchmarks_tpu_torch import train_step
  from kf_benchmarks_tpu_torch.models import model as model_lib
  init = module_fn(torch.float32).state_dict()
  init = {k: v.to(torch.bfloat16).float() if v.is_floating_point() and
          not k.endswith((".mean", ".var")) else v for k, v in init.items()}
  p = params_lib.make_params(optimizer="momentum", device="cpu")
  out = {}
  for arm, device, dtype, param_dtype in (
      ("card", "cuda", torch.bfloat16, torch.bfloat16),
      ("card_f32", "cuda", torch.bfloat16, torch.float32),
      ("cpu", "cpu", torch.float32, torch.float32)):
    module = module_fn(dtype).to(device)
    module.load_state_dict(init)
    model_lib.cast_params(module, param_dtype)
    # Every arm's weights in f32 on the card, where they are compared.
    start = {k: q.detach().to("cuda", torch.float32, copy=True)
             for k, q in module.named_parameters()}
    opt = optimizers.get_optimizer(p, module.parameters())
    step = train_step.TrainStep(model, module, opt,
                                lambda s: FP16_STEP_LR, 4e-5)
    m = step(torch.from_numpy(inputs).to(device),
             torch.from_numpy(labels).to(device))
    state = {str(v.dtype) for st in opt.state.values() for v in st.values()}
    out[arm] = (float(m["base_loss"]), start,
                {k: q.detach().to("cuda", torch.float32, copy=True)
                 for k, q in module.named_parameters()}, state)
    del module, opt, step, m
  loss = {arm: v[0] for arm, v in out.items()}
  rel = {ref: abs(loss["card"] - loss[ref]) / abs(loss[ref])
         for ref in ("cpu", "card_f32")}
  log(f"fp16_vars: {label} step loss card (bf16 weights, kernels) "
      f"{loss['card']:.6f}, card f32 weights {loss['card_f32']:.6f} (rel "
      f"{rel['card_f32']:.3g}, want 0), CPU (f32, plain) {loss['cpu']:.6f} "
      f"(rel {rel['cpu']:.3g}, tol {FP16_STEP_LOSS_RTOL})")
  check(rel["cpu"] <= FP16_STEP_LOSS_RTOL,
        f"fp16_vars: {label} card loss differs from the CPU")
  # The same kernels on the same values: the forward is the same.
  check(loss["card"] == loss["card_f32"],
        f"fp16_vars: {label} card loss differs from the f32-parameter step")
  check(out["card"][3] == {"torch.bfloat16"} and
        out["card_f32"][3] == {"torch.float32"},
        f"fp16_vars: {label} momentum buffers {out['card'][3]} / "
        f"{out['card_f32'][3]}")
  _, w0, new, _ = out["card"]
  check(all(torch.equal(w0[k], out[a][1][k]) for a in ("card_f32", "cpu")
            for k in w0), f"fp16_vars: {label} arms start apart")
  worst, worst_key, planted_missed = 0.0, None, []
  moved = total = sensitive = 0
  for k in w0:
    upd = out["card_f32"][2][k] - w0[k]
    excess = update_excess(new[k], w0[k], upd)
    if worst_key is None or excess > worst:
      worst, worst_key = excess, k
    moved += int((new[k] != w0[k]).sum())
    total += new[k].numel()
    # Where the update moves a weight by 2 ulps or more, bf16 can show it
    # doubled: there the bound must break.
    if bool((upd.abs() >= 2.0 * bf16_ulp(w0[k])).any()):
      sensitive += 1
      if update_excess(new[k], w0[k], 2.0 * upd) <= 1.0:
        planted_missed.append(k)
  log(f"fp16_vars: {label} new weights against the f32-parameter step's "
      f"update: worst {worst:.3g} of the bound ({worst_key}), {moved} of "
      f"{total} weights moved ({moved / total:.3g}); the update doubled "
      f"passes in {len(planted_missed)} of the {sensitive} of {len(w0)} "
      f"tensors it moves 2 ulps somewhere {planted_missed[:4]}")
  check(worst <= 1.0, f"fp16_vars: {label} {worst_key} new weights "
        f"{worst:.3g}x the bound off the f32-parameter step's")
  check(not planted_missed, f"fp16_vars: {label} a doubled update passes "
        f"in {planted_missed}: the check cannot see a scale fault")
  heads = {}
  for key in head:
    got = (new[key] - w0[key]).double()
    cpu = out["cpu"][2][key]
    ref = (cpu.to(torch.bfloat16).float() - w0[key]).double()
    n_rel = abs(float(got.norm()) - float(ref.norm())) / float(ref.norm())
    cos = float((got * ref).sum() / (got.norm() * ref.norm()))
    heads[key] = dict(norm_rel=n_rel, cosine=cos)
    log(f"fp16_vars: {label} update {key}: card {float(got.norm()):.4g}, "
        f"CPU rounded to bf16 {float(ref.norm()):.4g} (rel {n_rel:.2g}, "
        f"cosine {cos:.4f})")
    check(n_rel <= FP16_STEP_HEAD_NORM_RTOL and cos >= FP16_STEP_HEAD_COSINE,
          f"fp16_vars: {label} update {key} differs from the CPU's")
  return dict(loss=loss, loss_rel=rel, worst_excess=worst,
              worst_tensor=worst_key, moved_share=moved / total,
              sensitive_tensors=sensitive, tensors=len(w0),
              planted_missed=planted_missed, head=heads)


def phase_fp16_vars(res):
  """--fp16_vars on ResNet-50 (batch 256) and transformer_lm (batch 8):
  see the module docstring, item 22."""
  from kf_benchmarks_tpu_torch.models import resnet_model
  from kf_benchmarks_tpu_torch.models import transformer_lm as lm
  res["fp16_vars"] = {}
  calls = {"conv3x3_same": {}, "bn_relu_conv3x3_stats": {}}
  runs = (("resnet50", resnet_train_params, RESNET_LAUNCHES, "images/sec"),
          ("transformer_lm", lm_params, LM_LAUNCHES, "sequences/sec"))
  for model, make, per_step, unit in runs:
    arms = {}
    with lm_attention("flash"):
      for fv, k in ((True, 1), (True, DISPATCH_K), (False, DISPATCH_K)):
        arm = f"k{k}" + ("" if fv else "_off")
        label = f"fp16_vars: {model} {arm}"
        keeping = (capturing_unit_inputs(calls) if fv and k == 1
                   else contextlib.nullcontext())
        with keeping:
          bench, stats, counts, peak = bench_arm(make(
              num_batches=FP16_STEPS, num_warmup_batches=FP16_WARMUP,
              display_every=FP16_STEPS, steps_per_dispatch=k,
              fp16_vars=fv))
        steps = stats["steps_run"]
        res.setdefault("counts_by_path", {})[f"fp16_vars_{model}_{arm}"] = \
            counts
        check_launches(label, counts, per_step, steps)
        final = bench.final
        module, step = final["module"], final["step"]
        dtypes = {str(q.dtype) for q in module.parameters()}
        opt_dtypes = {str(v.dtype) for st in step.optimizer.state.values()
                      for v in st.values()}
        if fv:
          # The LM's runs train with SGD, which keeps no buffer: its
          # momentum buffers' dtype is held in fp16_vars_step.
          check(dtypes == {"torch.bfloat16"} and
                opt_dtypes == ({"torch.bfloat16"} if model == "resnet50"
                               else set()),
                f"{label}: parameters {dtypes}, optimizer state "
                f"{opt_dtypes}")
        weights = [q.detach().clone() for q in module.parameters()]
        casts = copies = None
        if k == 1 or not fv:
          # Profiled steps move the weights on: they were kept above.
          casts, copies = weight_casts(
              module, lambda: step(final["images"], final["labels"]))
        arms[arm] = dict(
            losses=stats["losses"], rate=stats["images_per_sec"],
            peak_gib=peak, param_dtypes=sorted(dtypes),
            optimizer_dtypes=sorted(opt_dtypes), weight_casts=casts,
            to_copies=copies, weights=weights)
        log(f"{label}: {stats['images_per_sec']:.2f} {unit}, peak memory "
            f"{peak:.3f} GiB, launches {counts} in {steps} steps, params "
            f"{sorted(dtypes)}, optimizer state {sorted(opt_dtypes)}"
            + (f", weight casts in 2 eager steps {casts} of {copies} "
               "aten::_to_copy" if casts is not None else ""))
        del bench, final, module, step, weights
        gc.collect()
        torch.cuda.empty_cache()
    one, many, off = arms["k1"], arms[f"k{DISPATCH_K}"], \
        arms[f"k{DISPATCH_K}_off"]
    same = all(torch.equal(a, b) for a, b in zip(one["weights"],
                                                   many["weights"]))
    check(one["losses"] == many["losses"] and same,
          f"fp16_vars: {model} K={DISPATCH_K} differs from K=1")
    check(one["weight_casts"] == 0, f"fp16_vars: {model}: "
          f"{one['weight_casts']} weight casts in 2 steps")
    check(off["weight_casts"] > 0, f"fp16_vars: {model}: the run without "
          "the flag shows no weight cast: the check cannot see one")
    log(f"fp16_vars: {model}: K={DISPATCH_K} bitwise K=1 (losses, "
        f"weights); {unit} with the flag {many['rate']:.2f} against "
        f"{off['rate']:.2f} without ({many['rate'] / off['rate']:.4f}x); "
        f"peak memory {many['peak_gib']:.3f} against "
        f"{off['peak_gib']:.3f} GiB; weight casts in 2 eager steps "
        f"{one['weight_casts']} against {off['weight_casts']}")
    for arm in arms.values():
      del arm["weights"]
    res["fp16_vars"][model] = arms
  # K-A and K-B against their plain versions on the inputs the bf16-weight
  # run gave them: its activations, its bf16 weights in K-major and
  # flipped form, K-B's scale and shift folded from bf16 parameters.
  for name, check_at in (("conv3x3_same", check_conv_at),
                         ("bn_relu_conv3x3_stats", check_unit_at)):
    at = calls[name]
    check(at and all(n == 256 for n, *_ in at),
          f"fp16_vars: {name} shapes {sorted(at)}")
    for (n, h, w, c, co), given in sorted(at.items()):
      check(given[1].dtype == torch.bfloat16,
            f"fp16_vars: {name} weights {given[1].dtype}")
      res.setdefault(name, []).append(check_at(
          f"fp16_vars_{h}x{w}_{c}_{co}", n, h, w, c, co, None,
          given=given))
    calls[name] = None
  rn = resnet_model.create_resnet50_model()
  rng = np.random.default_rng(11)
  images = (np.clip(rng.normal(size=(8, 224, 224, 3)), -2, 2) * 60.0 +
            127.0).astype(np.float32)
  res["fp16_vars"]["resnet50_step"] = fp16_vars_step(
      "resnet50 batch 8", rn,
      lambda dt: rn.make_module(1001, dt,
                                generator=torch.Generator().manual_seed(11)),
      images, rng.integers(0, 1001, 8), ("affine0.weight", "affine0.bias"))
  with lm_attention("flash"):
    lmm = lm.TransformerLMModel()
    tokens, labels = lm_batch(2, 12)
    res["fp16_vars"]["lm_step"] = fp16_vars_step(
        "transformer_lm batch 2", lmm,
        lambda dt: lmm.make_module(
            1, dt, generator=torch.Generator().manual_seed(12)),
        tokens, labels, ("lm_head", "embed.weight"))


def read_rows(path):
  with open(path) as f:
    return [json.loads(line) for line in f if line.strip()]


def phase_health(res):
  """--health_stats on ResNet-50 at batch 256: see the module docstring,
  item 23."""
  import tempfile
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import metrics as metrics_lib
  from kf_benchmarks_tpu_torch import telemetry
  res["health"] = {}
  arms = {}
  with tempfile.TemporaryDirectory(prefix="health_") as root:
    for arm, k, health in (("k1", 1, True), (f"k{DISPATCH_K}", DISPATCH_K,
                                             True),
                           (f"k{DISPATCH_K}_off", DISPATCH_K, False)):
      train_dir = os.path.join(root, arm)
      bench, stats, counts, peak = bench_arm(resnet_train_params(
          num_batches=FP16_STEPS, num_warmup_batches=FP16_WARMUP,
          display_every=FP16_STEPS, steps_per_dispatch=k,
          health_stats=health, train_dir=train_dir))
      steps = stats["steps_run"]
      res.setdefault("counts_by_path", {})[f"health_{arm}"] = counts
      check_launches(f"health {arm}", counts, RESNET_LAUNCHES, steps)
      keys = [metrics_lib.health_key(h) for h in telemetry.HEALTH_KEYS]
      rows = []
      if health:
        rows = [r for r in read_rows(os.path.join(
            train_dir, "flight_recorder.jsonl")) if "loss" in r]
        dump = read_rows(os.path.join(train_dir,
                                      "flight_recorder.dump.jsonl"))
        check([r["step"] for r in rows] ==
              list(range(FP16_WARMUP + 1, steps + 1)),
              f"health {arm}: recorder rows for steps "
              f"{[r['step'] for r in rows]}")
        check(dump and dump[0]["flight_recorder_dump"] == "run end",
              f"health {arm}: no run-end dump")
        check(all(key in r for r in rows for key in keys),
              f"health {arm}: rows without the health keys")
      else:
        check(stats["health"] is None and not os.path.exists(
            os.path.join(train_dir, "flight_recorder.jsonl")),
              f"health {arm}: a telemetry session with the stats off")
      arms[arm] = dict(losses=stats["losses"], rate=stats["images_per_sec"],
                       peak_gib=peak, summary=stats["health"],
                       health=[[r[key] for key in keys] for r in rows]
                       if health else None)
      log(f"health {arm}: {stats['images_per_sec']:.2f} images/sec, peak "
          f"memory {peak:.3f} GiB, {len(rows)} recorder rows, summary "
          f"{stats['health']}")
      if arm == "k1":
        # One more eager step: its grad_norm against the norm of the
        # gradients it applied, recomputed on the card in f64.
        final = bench.final
        m = final["step"](final["images"], final["labels"])
        grads = [q.grad for q in final["module"].parameters()
                 if q.grad is not None]
        ref = float(torch.sqrt(sum((g.double() ** 2).sum()
                                   for g in grads)))
        got = float(m["health"][0])
        rel = abs(got - ref) / ref
        log(f"health: grad_norm {got:.6g} against {ref:.6g} recomputed on "
            f"the card: rel {rel:.3g} (tol 1e-4); update_ratio "
            f"{float(m['health'][1]):.4g}")
        check(rel <= 1e-4, "health: grad_norm differs from the recomputed "
              "norm")
        arms[arm]["grad_norm_rel"] = rel
        del final, m, grads
      del bench
      gc.collect()
      torch.cuda.empty_cache()
    one, many = arms["k1"], arms[f"k{DISPATCH_K}"]
    off = arms[f"k{DISPATCH_K}_off"]
    check(one["losses"] == many["losses"] and one["health"] ==
          many["health"], f"health: K={DISPATCH_K} differs from K=1")
    log(f"health: K={DISPATCH_K} bitwise K=1 (losses and health rows); "
        f"images/sec with the stats {many['rate']:.2f} against "
        f"{off['rate']:.2f} without ({many['rate'] / off['rate']:.4f}x)")
    # The watchdog: an 8 s heartbeat gap (past its 5 s floor) mid-run.
    logs = []
    orig = benchmark.log_fn
    benchmark.log_fn = lambda line: (logs.append(line), log(line))
    try:
      _, stats, _, _ = bench_arm(resnet_train_params(
          num_batches=8, num_warmup_batches=2, display_every=8,
          train_dir=os.path.join(root, "stall"), stall_watchdog_factor=2.0,
          fault_schedule="heartbeat_delay@4:secs=8"))
    finally:
      benchmark.log_fn = orig
    stalls = [line for line in logs if "stall watchdog: no dispatch" in line]
    check(stalls and stats["num_steps"] == 8 and
          stats["health"]["watchdog_stalls"] >= 1,
          f"health: no watchdog diagnostic ({stats['health']})")
    arms["stall"] = {"diagnostics": stalls,
                     "watchdog_stalls": stats["health"]["watchdog_stalls"]}
  res["health"] = arms


FAULT_STEPS = 9


def fault_start(root, name, num_batches, schedule=None):
  """Starts one launch of ResNet-50 (batch 256, bf16, Nesterov, a
  checkpoint every 2 steps, no warmup) through ``kfrun -np 1
  --restart-on-failure``; ``fault_finish`` waits for it."""
  train_dir = os.path.join(root, name)
  logdir = os.path.join(root, name + "_logs")
  os.makedirs(logdir, exist_ok=True)
  cmd = [sys.executable, "-m", "kf_benchmarks_tpu_torch.kfrun", "-np", "1",
         "--restart-on-failure", "--logdir", logdir, "--",
         sys.executable, "-m", "kf_benchmarks_tpu_torch.cli",
         "--model=resnet50", "--batch_size=256", "--use_fp16",
         "--optimizer=momentum", "--num_warmup_batches=0",
         "--save_model_steps=2", "--max_ckpts_to_keep=3",
         f"--num_batches={num_batches}",
         "--display_every=1", f"--train_dir={train_dir}"]
  if schedule:
    cmd.append(f"--fault_schedule={schedule}")
  env = {**os.environ, "PYTHONFAULTHANDLER": "1"}
  return name, logdir, subprocess.Popen(
      cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def fault_finish(started):
  """The worker's stdout and kfrun's stderr of a ``fault_start`` launch."""
  name, logdir, proc = started
  try:
    _, err = proc.communicate(timeout=300)
  except subprocess.TimeoutExpired:
    proc.kill()
    _, err = proc.communicate()
  with open(os.path.join(logdir, "127.0.0.1.10000.stdout.log")) as f:
    out = f.read()
  check(proc.returncode == 0, f"faults {name}: kfrun exited "
        f"{proc.returncode}\nkfrun: {err[-2000:]}\nworker: "
        f"{out[-3000:]}")
  return out, err


def phase_faults(res):
  """kfrun --restart-on-failure with corrupt_ckpt@6,kill@7: see the module
  docstring, item 24. The two uninterrupted runs are BenchmarkCNN in this
  process (same seed, same checkpoints), with their counts set to 0 just
  before each and read just after."""
  import shutil
  import tempfile
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import checkpoint
  gc.collect()
  torch.cuda.empty_cache()
  total = 6 + FAULT_STEPS
  early = EARLY.pop("faults", None)
  with tempfile.TemporaryDirectory(prefix="faults_") as root:
    # The faulted launch ran in phase elastic (EARLY), or runs in its own
    # processes while the two uninterrupted runs take their steps here.
    faulted_root = early["root"] if early else root
    if early is None:
      t0 = time.time()
      started = fault_start(root, "faulted", FAULT_STEPS,
                            "corrupt_ckpt@6,kill@7")
    counts = {}
    for name in ("whole_a", "whole_b"):
      _, stats, launched, _ = bench_arm(resnet_train_params(
          num_batches=total, num_warmup_batches=0, display_every=total,
          save_model_steps=2, max_ckpts_to_keep=3,
          train_dir=os.path.join(root, name)))
      check_launches(f"faults {name}", launched, RESNET_LAUNCHES, total)
      counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
      gc.collect()
      torch.cuda.empty_cache()
    if early is None:
      out, err = fault_finish(started)
      faulted_s = time.time() - t0
    else:
      out, err, faulted_s = early["out"], early["err"], early["seconds"]
    check("worker died (exit 9); rejoining np=1" in err,
          f"faults: kfrun did not rejoin the killed worker: {err[-1000:]}")
    check("fault injected: kill at step 7" in out and
          "fault corrupt_ckpt: truncated model.ckpt-4.pt" in out,
          "faults: the faults did not fire")
    check(re.findall(r"Restored checkpoint at global step (\d+)", out) ==
          ["6"], "faults: the rejoined worker did not resume at step 6")
    # The worker that ran to its end (the killed one prints no counts).
    launched = launches_in(out)
    check_launches("faults faulted", launched, RESNET_LAUNCHES, FAULT_STEPS)
    counts = {k: counts.get(k, 0) + v for k, v in launched.items()}
    res.setdefault("counts_by_path", {})["faults"] = counts
    snaps = {}
    for name in ("faulted", "whole_a", "whole_b"):
      snaps[name], _, step = checkpoint.load_latest_checkpoint(
          os.path.join(faulted_root if name == "faulted" else root, name))
      check(step == total, f"faults {name}: last step {step}")
  if early:
    shutil.rmtree(early["root"], ignore_errors=True)
  noise = state_distances(snaps["whole_b"], snaps["whole_a"])
  resumed = state_distances(snaps["faulted"], snaps["whole_a"])
  bitwise = max(noise.values()) == 0.0
  over = {k: (v, noise[k]) for k, v in resumed.items() if v > noise[k]}
  log(f"faults: killed after step 7 and rejoined from step 6 (step 4's "
      f"checkpoint torn): {faulted_s:.1f} s for both generations ("
      f"{'in phase elastic' if early else 'beside the two runs here'}); "
      f"two "
      f"uninterrupted runs {'bitwise equal' if bitwise else 'differ'} "
      f"(largest tensor distance {max(noise.values()):.3g}); the rejoined "
      f"run against the first: largest {max(resumed.values()):.3g}, "
      f"{len(over)} of {len(resumed)} tensors over the uninterrupted "
      f"pair's distance; launches {counts}")
  check(not over, f"faults: rejoined state beyond the card's own spread: "
        f"{dict(list(over.items())[:5])}")
  res["faults"] = {"bitwise": bitwise, "noise_max": max(noise.values()),
                   "resumed_max": max(resumed.values()),
                   "faulted_s": faulted_s}


# -- main ----------------------------------------------------------------------

# Phase input: the records it writes and the steps of each run.
INPUT_TRAIN, INPUT_VALIDATION, INPUT_DISTINCT = 1024, 256, 64
INPUT_WARMUP, INPUT_STEPS = 4, 8
# The decode of jpeg.encode(textured_image(RandomState(0)), quality=90)
# (kf_benchmarks_tpu_torch/data; tests/test_torch_jpeg.py pins it too).
PINNED_DECODE_SHA256 = (
    "30d6f913c0d32b98ccf6f763fe104d1606a07d092067fc6139f89eea04097b50")
# A progressive (SOF2) 97x61 4:2:0 file with restart intervals that PIL
# wrote, and the SHA-256 of PIL's RGB pixels of it
# (tests/test_torch_jpeg_progressive.py holds both against PIL).
PROGRESSIVE_FIXTURE = os.path.join("tests", "fixtures",
                                   "progressive_97x61.jpg")
PROGRESSIVE_PIL_SHA256 = (
    "036969b271c389484c1cb94d7aa3c30b6996a56789ee912bebfd8e716be30412")


def input_params(data_dir, **kw):
  return resnet_train_params(data_dir=data_dir, data_name="imagenet",
                             display_every=INPUT_STEPS, **kw)


def host_ms_per_image(fn, items):
  t0 = time.perf_counter()
  for i, item in enumerate(items):
    fn(i, item)
  return (time.perf_counter() - t0) / len(items) * 1e3


def phase_input(res):
  """The real-data input path: see the module docstring, item 25."""
  import hashlib
  import random
  import tempfile
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch.data import datasets
  from kf_benchmarks_tpu_torch.data import device_feed
  from kf_benchmarks_tpu_torch.data import image_ops
  from kf_benchmarks_tpu_torch.data import jpeg
  from kf_benchmarks_tpu_torch.data import preprocessing
  from kf_benchmarks_tpu_torch.data import tfrecord
  from kf_benchmarks_tpu_torch.data import tfrecord_image_generator as gen
  out = res["input"] = {}
  t0 = time.time()
  jpeg.library()
  image_ops.library()
  out["build_s"] = time.time() - t0
  fixed = jpeg.encode(gen.textured_image(np.random.RandomState(0)),
                      quality=90)
  digest = hashlib.sha256(jpeg.decode(fixed).tobytes()).hexdigest()
  check(digest == PINNED_DECODE_SHA256,
        f"input: decode digest {digest}, pinned {PINNED_DECODE_SHA256}")
  with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         PROGRESSIVE_FIXTURE), "rb") as f:
    progressive = f.read()
  check(progressive[progressive.index(b"\xff\xc2") + 1] == 0xC2,
        "input: the progressive fixture has no SOF2 frame")
  digest = hashlib.sha256(jpeg.decode(progressive).tobytes()).hexdigest()
  check(digest == PROGRESSIVE_PIL_SHA256,
        f"input: progressive decode digest {digest}, PIL's "
        f"{PROGRESSIVE_PIL_SHA256}")
  cpus = os.cpu_count()
  affinity = len(os.sched_getaffinity(0))
  out.update(cpu_count=cpus, sched_getaffinity=affinity)
  log(f"input: codec and image ops built in {out['build_s']:.1f} s; pinned "
      f"decode digest matches; the progressive fixture "
      f"({PROGRESSIVE_FIXTURE}, {len(progressive)} bytes) decodes to PIL's "
      f"pixels (SHA-256); host os.cpu_count() {cpus}, "
      f"len(os.sched_getaffinity(0)) {affinity}")
  calls = {"conv3x3_same": {}, "bn_relu_conv3x3_stats": {}}
  with tempfile.TemporaryDirectory(prefix="kf_input_") as tmp:
    data_dir = os.path.join(tmp, "imagenet")
    t0 = time.time()
    gen.write_textured_records(
        data_dir, num_train=INPUT_TRAIN, num_validation=INPUT_VALIDATION,
        num_distinct=INPUT_DISTINCT, quality=90)
    out["write_s"] = time.time() - t0
    shard = tfrecord.list_shards(data_dir, "train")[0]
    parsed = [preprocessing.parse_example_proto(r)
              for _, r in zip(range(INPUT_DISTINCT),
                              tfrecord.read_records(shard))]
    sizes = [len(p[0]) for p in parsed]
    decode_ms = host_ms_per_image(lambda i, p: jpeg.decode(p[0]), parsed)
    rng = random.Random(0)
    train_ms = host_ms_per_image(
        lambda i, p: preprocessing.train_image(p[0], 224, 224, p[2], i,
                                               "bilinear", False, rng),
        parsed)
    out.update(decode_ms=decode_ms, train_image_ms=train_ms,
               jpeg_bytes_mean=float(np.mean(sizes)))
    log(f"input: {INPUT_TRAIN} + {INPUT_VALIDATION} records written in "
        f"{out['write_s']:.1f} s (JPEGs {np.mean(sizes) / 1024:.1f} KiB "
        f"mean); one host thread: full 500x375 decode {decode_ms:.3f} ms "
        f"a image, train preprocessing to 224 (draft decode, crop, "
        f"bilinear resize, flip) {train_ms:.3f} ms a image")
    # The first batch on the card against the CPU preprocessor's.
    bench = benchmark.BenchmarkCNN(input_params(data_dir, num_batches=1))
    images, labels = bench._open_input("train")()
    torch.cuda.synchronize()
    bench._stop_input()
    host = preprocessing.RecordInputImagePreprocessor(
        batch_size=bench.batch_size, output_shape=(224, 224, 3), train=True,
        seed=1234,
        shift_ratio=0.0, num_threads=16).minibatches(
            datasets.ImagenetDataset(data_dir), "train")
    host_images, host_labels = next(host)
    host.close()
    ref = device_feed.normalize(torch.from_numpy(host_images), "unit",
                                torch.bfloat16)
    check(images.dtype == torch.bfloat16 and
          torch.equal(images.cpu(), ref) and
          torch.equal(labels.cpu(), torch.from_numpy(host_labels).long()),
          "input: the first batch on the card is not the CPU "
          "preprocessor's")
    log(f"input: first batch on the card ({tuple(images.shape)} bf16, "
        "normalised there) bitwise the CPU preprocessor's from the same "
        "seed")
    # The process pool's first batch against the host's serial decode of
    # the same records on the same streams.
    serial = preprocessing.RecordInputImagePreprocessor(
        batch_size=bench.batch_size, output_shape=(224, 224, 3), train=True,
        seed=1234, shift_ratio=0.0, num_threads=1).minibatches(
            datasets.ImagenetDataset(data_dir), "train")
    serial_images, serial_labels = next(serial)
    serial.close()
    del bench, images, labels
    bench = benchmark.BenchmarkCNN(input_params(
        data_dir, num_batches=1, input_preprocessor="multiprocess"))
    images, labels = bench._open_input("train")()
    torch.cuda.synchronize()
    workers = bench.preprocessor.num_processes
    bench._stop_input()
    ref = device_feed.normalize(torch.from_numpy(serial_images), "unit",
                                torch.bfloat16)
    check(torch.equal(images.cpu(), ref) and
          torch.equal(labels.cpu(), torch.from_numpy(serial_labels).long()),
          "input: the process pool's first batch on the card is not the "
          "host's serial decode")
    log(f"input: the process pool's ({workers} workers) first batch on the "
        "card bitwise the host's serial decode of the same records on the "
        "same streams")
    del bench, images, labels, ref
    arms = {}
    pool = {"input_preprocessor": "multiprocess"}
    for label, k, extra in (("k1", 1, {}), ("k8", DISPATCH_K, {}),
                            ("k8_cached", DISPATCH_K,
                             {"datasets_repeat_cached_sample": True}),
                            ("mp_k1", 1, pool), ("mp_k8", DISPATCH_K, pool),
                            ("mp_k8_w7", DISPATCH_K,
                             dict(pool, datasets_num_private_threads=7))):
      keeping = (capturing_unit_inputs(calls) if label == "k1"
                 else contextlib.nullcontext())
      with keeping:
        bench, stats, counts, peak = bench_arm(input_params(
            data_dir, num_batches=INPUT_STEPS,
            num_warmup_batches=INPUT_WARMUP, steps_per_dispatch=k, **extra))
      steps = stats["steps_run"]
      res.setdefault("counts_by_path", {})[f"input_{label}"] = counts
      check_launches(f"input: {label}", counts, RESNET_LAUNCHES, steps)
      fs = stats["feed_stats"]
      check(fs is not None and fs["fetches"] > 0,
            f"input: {label}: no feed stats")
      arms[label] = dict(rate=stats["images_per_sec"],
                         losses=stats["losses"], feed=fs, peak_gib=peak)
      pre = bench.preprocessor
      if extra.get("input_preprocessor") == "multiprocess":
        arms[label].update(
            workers=pre.num_processes, dispatch_calls=pre.dispatch_calls,
            dispatch_ms_a_batch=(1e3 * pre.dispatch_seconds /
                                 max(pre.dispatch_calls, 1)))
        log(f"input: {label}: process pool of {pre.num_processes} workers "
            f"(os.cpu_count() {cpus}, len(os.sched_getaffinity(0)) "
            f"{affinity}), dispatch {arms[label]['dispatch_ms_a_batch']:.3f}"
            f" ms a batch over {pre.dispatch_calls} batches")
      log(f"input: {label}: {stats['images_per_sec']:.2f} images/sec, "
          f"feed_stall_fraction {fs['feed_stall_fraction']:.4f}, queue "
          f"depth {fs['queue_depth_mean']:.2f} mean / "
          f"{fs['queue_depth_max']} max (prefetch "
          f"{fs['prefetch_batches']} batches), {fs['fetches']} fetches, "
          f"peak memory {peak:.2f} GiB, launches {counts} in {steps} "
          "steps")
      log(f"input: {label}: losses {stats['losses']}")
      del bench
      gc.collect()
      torch.cuda.empty_cache()
    check(arms["k1"]["losses"] == arms["k8"]["losses"],
          f"input: K={DISPATCH_K} losses differ from K=1")
    check(arms["mp_k1"]["losses"] == arms["mp_k8"]["losses"],
          f"input: the pool's K={DISPATCH_K} losses differ from its K=1")
    log(f"input: process pool: K={DISPATCH_K} losses bitwise K=1; "
        f"images/sec K=1 {arms['mp_k1']['rate']:.2f} (thread pool "
        f"{arms['k1']['rate']:.2f}), K={DISPATCH_K} "
        f"{arms['mp_k8']['rate']:.2f} (thread pool "
        f"{arms['k8']['rate']:.2f}; 7 workers "
        f"{arms['mp_k8_w7']['rate']:.2f}); feed_stall_fraction K=1 "
        f"{arms['mp_k1']['feed']['feed_stall_fraction']:.4f}, "
        f"K={DISPATCH_K} {arms['mp_k8']['feed']['feed_stall_fraction']:.4f} "
        f"(7 workers {arms['mp_k8_w7']['feed']['feed_stall_fraction']:.4f})")
    log(f"input: K={DISPATCH_K} losses bitwise K=1; images/sec K=1 "
        f"{arms['k1']['rate']:.2f}, K={DISPATCH_K} "
        f"{arms['k8']['rate']:.2f}, K={DISPATCH_K} with "
        f"--datasets_repeat_cached_sample {arms['k8_cached']['rate']:.2f}")
    out["arms"] = arms
    bench = benchmark.BenchmarkCNN(input_params(
        data_dir, eval=True, num_eval_batches=4))
    reset_launches()
    stats = bench.run()
    counts = benchmark.kernel_launches()
    res["counts_by_path"]["input_eval"] = counts
    check(stats["num_eval_batches"] == INPUT_VALIDATION // bench.batch_size,
          f"input: eval scored {stats['num_eval_batches']} batches of "
          f"{INPUT_VALIDATION} records")
    check(counts.get("bn_relu_conv3x3_stats") == 13 and
          not counts.get("conv3x3_same"),
          f"input: eval launches {counts}")
    out["eval"] = {k: stats[k] for k in ("top_1_accuracy", "top_5_accuracy",
                                         "num_eval_batches")}
    log(f"input: --eval over {INPUT_VALIDATION} validation records: "
        f"{stats['num_eval_batches']} batch(es) of {bench.batch_size} (asked "
        f"4: the stream ended), top-1 {stats['top_1_accuracy']:.4f}, "
        f"launches {counts}")
    del bench
  for name, check_at in (("conv3x3_same", check_conv_at),
                         ("bn_relu_conv3x3_stats", check_unit_at)):
    at = calls[name]
    check(at and all(n == 256 for n, *_ in at),
          f"input: {name} shapes {sorted(at)}")  # the run's batch
    for (n, h, w, c, co), given in sorted(at.items()):
      res.setdefault(name, []).append(check_at(
          f"input_{h}x{w}_{c}_{co}", n, h, w, c, co, None, given=given))
    calls[name] = None


# -- models: the image-classification zoo -------------------------------------

MODELS_RUNS = (
    # (label, model, dataset, image size, batch, fused units a step, extra
    # flags): the fused units are the stride-1 3x3s that follow a conv's
    # batch norm and ReLU with 64-aligned channels (builder.fusable_conv3x3
    # and ConvNetBuilder.finish), each launching K-B once and K-A once a
    # step.
    ("vgg16", "vgg16", "imagenet", 224, 64, 0, {}),
    ("alexnet", "alexnet", "imagenet", 227, 512, 0, {}),
    ("overfeat", "overfeat", "imagenet", 231, 32, 0, {}),
    ("lenet", "lenet", "imagenet", 28, 32, 0, {}),
    ("googlenet", "googlenet", "imagenet", 224, 32, 0, {}),
    ("inception4", "inception4", "imagenet", 299, 32, 0, {}),
    ("mobilenet", "mobilenet", "imagenet", 224, 32, 0, {}),
    ("official_resnet18", "official_resnet18", "imagenet", 224, 32, 8, {}),
    ("official_resnet50", "official_resnet50", "imagenet", 224, 32, 13, {}),
    # The CIFAR AlexNet has no batch norm: at its own rate, 0.1 (or 0.01),
    # the synthetic images in [0, 255] drive its loss to 1e20 and past
    # within 10 steps, the JAX package's on the CPU as the port's.
    ("alexnet_cifar10", "alexnet", "cifar10", 32, 128, 0,
     dict(init_learning_rate=0.001)),
    ("densenet40_k12", "densenet40_k12", "cifar10", 32, 64, 0, {}),
    ("resnet56", "resnet56", "cifar10", 32, 128, 9, {}),
    ("resnet56_v2", "resnet56_v2", "cifar10", 32, 128, 9, {}),
    # NASNet-A mobile, large and CIFAR, NCF and SSD300 (ROADMAP Queue 1
    # item 7b). NCF has no image size. SSD300's 13 basic blocks each run
    # their second 3x3 as the fused unit (models/ssd_model.py).
    ("nasnet", "nasnet", "imagenet", 224, 32, 0, {}),
    ("nasnetlarge", "nasnetlarge", "imagenet", 331, 16, 0, {}),
    ("nasnet_cifar10", "nasnet", "cifar10", 32, 32, 0, {}),
    ("ncf", "ncf", "imagenet", None, 2048, 0, {}),
    ("ssd300", "ssd300", "coco", 300, 32, 13, {}),
)
MODELS_WARMUP, MODELS_STEPS = 2, 3
MODELS_COSINE_BATCH = 8
# The bf16 card forward against the f32 CPU forward, and the f32 card
# forward (every conv plain) against the same. bf16 rounding grows through
# a deep random network's batch norms at batch 8, in the JAX package as in
# the port: on the CPU (tests/test_torch_zoo_bf16.py) the JAX package's own
# bf16 forward reads cosine 0.933527 against its f32 forward on
# Inception-v4 (the port's 0.934769), 0.991754 on official_resnet50 and
# 0.993694 on mobilenet, and the port's bf16 logits lie no further from
# JAX's than JAX's bf16 from its f32. So 0.9 stays the floor: the drift is
# bf16's, not the port's. f32 rounding does not grow so.
MODELS_COSINE_MIN = {"bf16": 0.9, "f32": 0.9999}
# Captured steps of the networks that draw dropout or drop path (label,
# model, dataset, batch): K = 8 bitwise eight single steps.
MODELS_CAPTURED = (("alexnet", "alexnet", "imagenet", 512),
                   ("vgg16", "vgg16", "imagenet", 64),
                   ("mobilenet", "mobilenet", "imagenet", 32),
                   ("nasnet_cifar10", "nasnet", "cifar10", 32))
MODELS_CAPTURED_K = 8


def models_params(model, data_name, batch, **flags):
  from kf_benchmarks_tpu_torch import params as params_lib
  kw = dict(num_batches=MODELS_STEPS, num_warmup_batches=MODELS_WARMUP,
            display_every=MODELS_STEPS, device="gpu")
  kw.update(flags)
  return params_lib.make_params(
      model=model, data_name=data_name, batch_size=batch, use_fp16=True,
      **kw)


def models_cosine(model, nclass, seed, batch=MODELS_COSINE_BATCH):
  """{"bf16", "f32"}: the cosine of the card's bf16 forward's logits, and
  of its f32 forward's (every conv plain: the kernels are bf16), against
  the port's own f32 CPU forward at the same weights and images (``batch``
  of them): the batch norms on batch statistics, dropout off."""
  from kf_benchmarks_tpu_torch.models import builder
  gen = torch.Generator(device="cuda").manual_seed(seed)
  with torch.device("cuda"):
    card = model.make_module(nclass, torch.bfloat16, generator=gen)
    card32 = model.make_module(nclass, torch.float32)
  cpu = model.make_module(nclass, torch.float32)
  state = card.state_dict()
  card32.load_state_dict(state)
  cpu.load_state_dict({k: v.cpu() for k, v in state.items()})
  if isinstance(card32, builder.GraphNet):
    card32.fuse = False
  old = model.get_batch_size()
  model.set_batch_size(batch)
  images, _ = model.get_synthetic_inputs(gen, nclass, torch.device("cuda"))
  model.set_batch_size(old)
  outs = []
  for net, x in ((card, images), (card32, images), (cpu, images.cpu())):
    net.eval()
    for m in net.modules():
      if isinstance(m, builder.CompactBatchNorm):
        m.train()
    with torch.no_grad():
      y = net(x)
    outs.append((y[0] if isinstance(y, tuple) else y).float().cpu()
                .flatten().double())
  ref = outs[-1]
  return {k: float(o @ ref / (o.norm() * ref.norm()))
          for k, o in zip(("bf16", "f32"), outs)}


def models_captured(label, model, data_name, batch):
  """MODELS_CAPTURED_K steps of ``model`` as one captured dispatch
  (--steps_per_dispatch) against the same steps one at a time, from one
  seed: the losses and every parameter bitwise equal (the dropout and
  drop-path draws read the step counter on the device)."""
  from kf_benchmarks_tpu_torch import benchmark
  k = MODELS_CAPTURED_K
  runs = {}
  for kk in (1, k):
    bench = benchmark.BenchmarkCNN(models_params(
        model, data_name, batch, steps_per_dispatch=kk,
        num_batches=k, num_warmup_batches=0, display_every=k))
    stats = bench.run()
    runs[kk] = (stats, [q.detach().clone() for q in
                        bench.final["module"].parameters()])
    del bench
  (s1, p1), (sk, pk) = runs[1], runs[k]
  same_losses = list(s1["losses"]) == list(sk["losses"])
  same_params = all(torch.equal(a, b) for a, b in zip(p1, pk))
  check(len(s1["losses"]) == k and same_losses and same_params,
        f"models {label}: K = {k} captured steps differ from {k} single "
        f"steps (losses {s1['losses']} / {sk['losses']}, parameters equal "
        f"{same_params})")
  check(len(set(s1["losses"])) > 1,
        f"models {label}: the {k} steps' losses are all equal")
  log(f"models {label}: {k} steps at K = {k} (one captured dispatch) "
      f"bitwise {k} single steps: losses {[round(v, 6) for v in s1['losses']]}"
      f", {len(p1)} parameter tensors equal")
  gc.collect()
  torch.cuda.empty_cache()
  return {"k": k, "losses": list(s1["losses"]), "bitwise": True}


def phase_models_cosines(res):
  """Each MODELS_RUNS network's bf16 and f32 card forward against the f32
  CPU forward at batch MODELS_COSINE_BATCH, from the same weights (seeded
  70 + its index): untimed, so it runs beside phase elastic."""
  from kf_benchmarks_tpu_torch.data import datasets
  from kf_benchmarks_tpu_torch.models import model_config
  out = res.setdefault("models_cosines", {})
  for i, (label, model, data_name, *_rest) in enumerate(MODELS_RUNS):
    m = model_config.get_model_config(model, None, data_name)
    cos = models_cosine(m, datasets.create_dataset(None, data_name)
                        .num_classes, 70 + i)
    out[label] = cos
    for kind, floor in MODELS_COSINE_MIN.items():
      check(cos[kind] >= floor,
            f"models {label}: {kind} card forward's cosine {cos[kind]:.6f} "
            f"against the f32 CPU forward, want >= {floor}")
    log(f"models {label}: card forward against the f32 CPU forward "
        f"(batch {MODELS_COSINE_BATCH}, same weights): cosine bf16 "
        f"{cos['bf16']:.6f}, f32 (plain convs) {cos['f32']:.8f}")
    gc.collect()
    torch.cuda.empty_cache()


def phase_models(res):
  """The image-classification zoo (ROADMAP Queue 1 item 7a): see the
  module docstring, item 28."""
  from kf_benchmarks_tpu_torch import benchmark
  out = res["models"] = {}
  shapes = {label: {"conv3x3_same": set(), "bn_relu_conv3x3_stats": set()}
            for label, *_ in MODELS_RUNS}
  reset_launches()
  for label, model, data_name, size, batch, fused, flags in MODELS_RUNS:
    params = models_params(model, data_name, batch, **flags)
    bench = benchmark.BenchmarkCNN(params)
    got_size = getattr(bench.model, "image_size", None)
    check(got_size == size and bench.batch_size == batch,
          f"models {label}: image size {got_size}, batch "
          f"{bench.batch_size}, want {size} and {batch}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = benchmark.kernel_launches()
    with noting_unit_shapes(shapes[label]):
      stats = bench.run()
    after = benchmark.kernel_launches()
    launched = {k: after[k] - before[k] for k in after}
    steps = stats["steps_run"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(np.isfinite(stats["last_average_loss"]),
          f"models {label}: loss not finite")
    for name in ("conv3x3_same", "bn_relu_conv3x3_stats"):
      check(launched[name] == fused * steps,
            f"models {label}: {name} launched {launched[name]} times in "
            f"{steps} steps, want {fused} a step")
    for name, n in launched.items():
      if name not in ("conv3x3_same", "bn_relu_conv3x3_stats"):
        check(not n, f"models {label}: {name} launched {n} times")
    out[label] = dict(model=bench.model.get_name(), dataset=data_name,
                      image_size=size, batch=batch, steps=steps,
                      images_per_sec=stats["images_per_sec"],
                      peak_gib=peak, launches=launched,
                      loss=stats["last_average_loss"],
                      fused_a_step=fused)
    log(f"models {label}: {bench.model.get_name()} on {data_name}, "
        f"{f'{size}x{size}' if size else 'ids'}, batch {batch}, {steps} "
        f"steps ({MODELS_WARMUP} "
        f"warmup + {MODELS_STEPS} timed), {stats['images_per_sec']:.2f} "
        f"images/sec, peak memory {peak:.2f} GiB, loss "
        f"{stats['last_average_loss']:.4f}, launches {launched} ({fused} + "
        f"{fused} a step wanted)")
    del bench
    gc.collect()
    torch.cuda.empty_cache()
  res.setdefault("counts_by_path", {})["models"] = \
      benchmark.kernel_launches()
  for label, model, data_name, batch in MODELS_CAPTURED:
    out[label]["captured"] = models_captured(label, model, data_name, batch)
  # Outside the counted window: the kernels at the new shapes (the forward
  # cosines are phase models_cosines).
  if "models_cosines" not in res.get("phases", ()):
    phase_models_cosines(res)
  seed = 90
  for label, *_ in MODELS_RUNS:
    noted = shapes[label]
    todo = (("conv3x3_same", check_conv_at,
             noted["conv3x3_same"] | noted["bn_relu_conv3x3_stats"]),
            ("bn_relu_conv3x3_stats", check_unit_at,
             noted["bn_relu_conv3x3_stats"]))
    for name, check_at, at in todo:
      for n, h, w, c, co in sorted(at):
        res.setdefault(name, []).append(check_at(
            f"models_{label}_{h}x{w}_{c}_{co}", n, h, w, c, co, seed=seed))
        seed += 1



# The first training step of the depthwise networks, each run in a fresh
# process (cuDNN's plans live in the process): as the port runs them, and
# with the depthwise convs through torch's own CUDA kernel (NCHW in and
# out) in place of cuDNN's NHWC one. The second "cudnn" run of each asks
# whether anything of the first outlives its process.
FIRST_STEP_RUNS = (("nasnet", "cudnn"), ("nasnet", "cudnn"),
                   ("nasnet", "native"), ("mobilenet", "cudnn"),
                   ("mobilenet", "native"))
_FIRST_STEP_CODE = """
import sys
import torch
import torch.nn.functional as F
from kf_benchmarks_tpu_torch import cli
from kf_benchmarks_tpu_torch.models import builder
if sys.argv[1] == "native":
  cudnn_forward = builder.Conv.forward
  def forward(self, x):
    if self.groups == 1 or not x.is_cuda:
      return cudnn_forward(self, x)
    t, b, l, r = self.pads(x.shape[2], x.shape[3])
    x = F.pad(x.contiguous(), (l, r, t, b))
    w = self.weight.to(x.dtype).contiguous()
    bias = None if self.bias is None else self.bias.to(x.dtype)
    y = F.conv2d(x, w, bias, stride=self.stride, groups=self.groups)
    return y.contiguous(memory_format=torch.channels_last)
  builder.Conv.forward = forward
sys.exit(cli.main(sys.argv[2:]))
"""


def phase_first_steps(res):
  """Build + first step and the rate of the next 5 steps, FIRST_STEP_RUNS
  one process at a time."""
  out = res["first_steps"] = []
  for model, route in FIRST_STEP_RUNS:
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-c", _FIRST_STEP_CODE, route, f"--model={model}",
         "--batch_size=32", "--use_fp16", "--num_warmup_batches=1",
         "--num_batches=5", "--display_every=5", "--device=gpu"],
        capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"first_steps {model} {route}: "
          f"{proc.stderr[-3000:]}")
    first = float(re.search(r"Build \+ warmup \(1 steps\): ([\d.]+) s",
                            proc.stdout).group(1))
    rate = float(re.search(r"total images/sec: ([\d.]+)",
                           proc.stdout).group(1))
    out.append(dict(model=model, route=route, first_s=first,
                    images_per_sec=rate, process_s=time.time() - t0))
    log(f"first_steps {model} ({route} depthwise): build + first step "
        f"{first:.1f} s, then {rate:.2f} images/sec over 5 steps, process "
        f"{time.time() - t0:.1f} s")


# -- detect: SSD300 on generated COCO records ----------------------------------

DETECT_RECORDS = (384, 64)  # train, validation
DETECT_BATCH = 32
DETECT_WARMUP, DETECT_STEPS = 2, 8
DETECT_LAUNCHES = {"conv3x3_same": 13, "bn_relu_conv3x3_stats": 13}


def detect_params(data_dir, **kw):
  from kf_benchmarks_tpu_torch import params as params_lib
  return params_lib.make_params(
      model="ssd300", data_name="coco", data_dir=data_dir,
      batch_size=DETECT_BATCH, use_fp16=True, optimizer="momentum",
      device="gpu", display_every=DETECT_STEPS, **kw)


def phase_detect(res):
  """SSD300 on generated COCO records: see the module docstring, item
  29."""
  from kf_benchmarks_tpu_torch import benchmark, checkpoint
  from kf_benchmarks_tpu_torch.data import coco_record_generator
  out = res["detect"] = {}
  with tempfile.TemporaryDirectory() as root:
    data_dir = os.path.join(root, "coco")
    t0 = time.time()
    coco_record_generator.write_fake_coco(
        data_dir, num_train=DETECT_RECORDS[0],
        num_validation=DETECT_RECORDS[1])
    log(f"detect: wrote {DETECT_RECORDS[0]} + {DETECT_RECORDS[1]} COCO "
        f"records (300x300) and the annotation file in "
        f"{time.time() - t0:.1f} s")
    # The checkpoint the warm start reads: one step of another run.
    first = benchmark.BenchmarkCNN(detect_params(
        data_dir, num_batches=1, num_warmup_batches=0,
        train_dir=os.path.join(root, "backbone")))
    first.run()
    backbone, _ = checkpoint.latest_checkpoint(os.path.join(root,
                                                            "backbone"))
    saved = first.final["module"].state_dict()
    del first
    bench, stats, counts, peak = bench_arm(detect_params(
        data_dir, num_batches=DETECT_STEPS,
        num_warmup_batches=DETECT_WARMUP, backbone_model_path=backbone,
        train_dir=os.path.join(root, "run")))
    steps = stats["steps_run"]
    check(np.isfinite(stats["last_average_loss"]),
          "detect: SSD300's loss is not finite")
    check_launches("detect train", counts, DETECT_LAUNCHES, steps)
    stall = stats["feed_stall_fraction"]
    log(f"detect: SSD300 on the records, batch {DETECT_BATCH}, bf16, "
        f"{steps} steps ({DETECT_WARMUP} warmup + {DETECT_STEPS} timed), "
        f"warm-started from {os.path.basename(backbone)} "
        f"({len(saved)} tensors): {stats['images_per_sec']:.2f} images/sec, "
        f"feed stall {stall if stall is None else round(stall, 4)}, peak "
        f"memory {peak:.2f} GiB, loss {stats['last_average_loss']:.4f}, "
        f"launches {counts} (13 + 13 a step wanted)")
    del bench
    gc.collect()
    torch.cuda.empty_cache()
    # Evaluation on the validation records: the trained run's checkpoint,
    # the per-image predictions and the mAP.
    before = benchmark.kernel_launches()
    ev = benchmark.BenchmarkCNN(detect_params(
        data_dir, eval=True, train_dir=os.path.join(root, "run")))
    results = ev.run()
    eval_counts = {k: v - before[k]
                   for k, v in benchmark.kernel_launches().items()}
    n = results.get("num_eval_images", 0)
    check(n == DETECT_RECORDS[1] and "COCO/AP" in results and
          np.isfinite(results["COCO/AP"]),
          f"detect: eval scored {n} images, results {sorted(results)}")
    batches = -(-DETECT_RECORDS[1] // DETECT_BATCH)
    check_launches("detect eval", eval_counts,
                   {"bn_relu_conv3x3_stats": 13}, batches)
    log(f"detect: eval of {n} validation images ({batches} batches, "
        f"{results['eval_images_per_sec']:.2f} images/sec): COCO mAP "
        f"{results['COCO/AP']:.4f}, AP50 {results['COCO/AP50']:.4f} "
        f"({results.get('coco_evaluator')} evaluator; untrained weights: "
        f"near 0 is expected), K-B launches {eval_counts}")
  res.setdefault("counts_by_path", {})["detect"] = {
      k: counts[k] + eval_counts[k] for k in counts}
  out.update(images_per_sec=stats["images_per_sec"], feed_stall=stall,
             steps=steps, launches=counts, eval_launches=eval_counts,
             coco_ap=results["COCO/AP"], coco_ap50=results["COCO/AP50"],
             evaluator=results.get("coco_evaluator"), peak_gib=peak)


# -- speech: DeepSpeech2 and the LibriSpeech path -----------------------------

SPEECH_BATCH = 128
SPEECH_WARMUP, SPEECH_STEPS = 2, 3
# Forward cosines at the full 3494 frames, batch 2: the card's bf16 and
# f32 forwards against the port's f32 CPU forward from one init.
SPEECH_COSINE_BATCH = 2
# K = 8 against 8 single steps at a batch that keeps the phase short.
SPEECH_CAPTURED_BATCH = 16
# Generated records (train, validation) and steps on them.
SPEECH_RECORDS = (384, 128)
SPEECH_RECORD_STEPS = 3


def speech_params(batch=SPEECH_BATCH, **kw):
  from kf_benchmarks_tpu_torch import params as params_lib
  return params_lib.make_params(
      model="deepspeech2", data_name="librispeech", batch_size=batch,
      use_fp16=True, device="gpu", **kw)


def speech_recurrence_kernels(module, images):
  """The CUDA kernel names of one eval-mode forward whose name marks an RNN
  kernel, by torch.profiler: cuDNN's carry the cell and the dtype."""
  from torch.profiler import ProfilerActivity, profile
  module.eval()
  try:
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as p:
      module(images)
      torch.cuda.synchronize()
  finally:
    module.train()
  return sorted({e.key for e in p.key_averages()
                 if "rnn" in e.key.lower() or "lstm" in e.key.lower()})


def speech_events_ms(fn):
  """ms of one call of fn() (warm already) by CUDA events."""
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  torch.cuda.synchronize()
  start.record()
  fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end)


def phase_speech(res):
  """DeepSpeech2 and the LibriSpeech path: see the module docstring, item
  30."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch.data import librispeech_record_generator
  from kf_benchmarks_tpu_torch.models import deepspeech
  out = res["speech"] = {}
  # (a) Synthetic, at the published sizes.
  bench, stats, counts, peak = bench_arm(speech_params(
      num_batches=SPEECH_STEPS, num_warmup_batches=SPEECH_WARMUP,
      display_every=SPEECH_STEPS))
  model = bench.model
  check(model.rnn_hidden_size == 800 and model.num_rnn_layers == 5 and
        model.max_time_steps == 3494 and bench.batch_size == SPEECH_BATCH,
        "speech: not the published DeepSpeech2 sizes")
  check(np.isfinite(stats["last_average_loss"]), "speech: loss not finite")
  check_launches("speech", counts, {}, stats["steps_run"])
  final = bench.final
  module, step = final["module"], final["step"]
  images, labels = final["images"], final["labels"]
  step_ms = speech_events_ms(lambda: step(images, labels))
  with torch.no_grad():
    logits = module(images)
  x = logits.detach().requires_grad_()
  ctc_ms = speech_events_ms(
      lambda: model.loss_function(x, labels).backward())
  kernels = speech_recurrence_kernels(module, images)
  check(any("bfloat16" in k for k in kernels) and
        not any("thnn" in k for k in kernels),
        f"speech: the bf16 recurrence is not cuDNN's: {kernels}")
  res.setdefault("counts_by_path", {})["speech"] = counts
  out.update(examples_per_sec=stats["images_per_sec"], peak_gib=peak,
             loss=stats["last_average_loss"], step_ms=step_ms, ctc_ms=ctc_ms,
             ctc_share=ctc_ms / step_ms, launches=counts,
             recurrence_kernels=kernels)
  log(f"speech: DeepSpeech2 (5 bidirectional LSTM layers of 800, 3494 x "
      f"161 frames, batch {SPEECH_BATCH}, bf16), {SPEECH_WARMUP} warmup + "
      f"{SPEECH_STEPS} timed steps: {stats['images_per_sec']:.2f} "
      f"examples/sec, peak memory {peak:.2f} GiB, loss "
      f"{stats['last_average_loss']:.4f}, launches {counts}; one step "
      f"{step_ms:.1f} ms by CUDA events, the CTC loss's forward and "
      f"backward {ctc_ms:.1f} ms of it (share {ctc_ms / step_ms:.3f}); the "
      f"bf16 recurrence's kernels: {kernels}")
  del bench, final, module, step, logits, x
  gc.collect()
  torch.cuda.empty_cache()
  # (b) Forward cosines against the f32 CPU forward.
  t0 = time.time()
  cos = models_cosine(deepspeech.DeepSpeech2Model(), 29, 31,
                      batch=SPEECH_COSINE_BATCH)
  out["forward_cosine"] = cos
  for kind, floor in MODELS_COSINE_MIN.items():
    check(cos[kind] >= floor, f"speech: {kind} card forward's cosine "
          f"{cos[kind]:.6f} against the f32 CPU forward, want >= {floor}")
  log(f"speech: card forward against the f32 CPU forward (batch "
      f"{SPEECH_COSINE_BATCH}, 3494 frames, same weights; "
      f"{time.time() - t0:.1f} s): cosine bf16 {cos['bf16']:.6f}, f32 "
      f"{cos['f32']:.8f}")
  gc.collect()
  torch.cuda.empty_cache()
  # (c) From one state: the eager step twice, 8 single steps, and 8 steps
  # of the step captured (train_step.TrainChunk at K = 8, as
  # --steps_per_dispatch=8 runs it).
  from kf_benchmarks_tpu_torch import train_step as train_step_lib
  b = benchmark.BenchmarkCNN(speech_params(SPEECH_CAPTURED_BATCH))
  m, st, im, lb = b.build()
  held = list(m.parameters()) + train_step_lib.batch_stats(m)
  state = [t.detach().clone() for t in held]

  def run(steps):
    """Losses and weights of ``steps()`` from the held state, and its ms by
    CUDA events."""
    with torch.no_grad():
      for t, v in zip(held, state):
        t.copy_(v)
    st.global_step, st.update_count = 0, 0
    got = []
    ms = speech_events_ms(lambda: got.extend(steps()))
    return ([float(v) for v in got],
            [q.detach().clone() for q in m.parameters()], ms)

  after_one = []

  def singles():
    losses = []
    for _ in range(DISPATCH_K):
      losses.append(st(im, lb)["total_loss"])
      if not after_one:
        after_one.append([q.detach().clone() for q in m.parameters()])
    return losses

  first = run(lambda: [st(im, lb)["total_loss"]])
  single = run(singles)
  check(first[0][0] == single[0][0] and all(
      torch.equal(x, y) for x, y in zip(first[1], after_one[0])),
      "speech: two eager steps from one state differ")
  chunk = train_step_lib.TrainChunk(st, DISPATCH_K)
  # The first call captures; the second only replays, and is timed.
  captured, replayed = (
      run(lambda: chunk(im, lb, DISPATCH_K)["total_loss"].tolist())
      for _ in range(2))
  for got in (captured, replayed):
    check(single[0] == got[0] and all(
        torch.equal(x, y) for x, y in zip(single[1], got[1])),
        f"speech: K = {DISPATCH_K} captured steps differ from {DISPATCH_K} "
        f"single steps ({single[0]} / {got[0]})")
  eager_ms, graph_ms = single[2] / DISPATCH_K, replayed[2] / DISPATCH_K
  out["captured"] = dict(batch=SPEECH_CAPTURED_BATCH, k=DISPATCH_K,
                         losses=single[0], bitwise=True,
                         eager_repeat_bitwise=True, eager_step_ms=eager_ms,
                         captured_step_ms=graph_ms)
  log(f"speech: the eager step twice from one state (batch "
      f"{SPEECH_CAPTURED_BATCH}): bitwise equal; {DISPATCH_K} steps at K = "
      f"{DISPATCH_K} (cuDNN's RNN and the CTC recursion captured as one "
      f"CUDA graph), captured and replayed, bitwise {DISPATCH_K} single "
      f"steps: losses {[round(v, 4) for v in single[0]]}; a step by CUDA "
      f"events {eager_ms:.1f} ms eager, {graph_ms:.1f} ms replayed "
      f"({SPEECH_CAPTURED_BATCH * 1000 / eager_ms:.2f} and "
      f"{SPEECH_CAPTURED_BATCH * 1000 / graph_ms:.2f} examples/sec)")
  del b, m, st, im, lb, held, state, chunk, first, after_one, single
  del captured, replayed
  gc.collect()
  torch.cuda.empty_cache()
  # (d) Generated LibriSpeech records.
  with tempfile.TemporaryDirectory() as root:
    t0 = time.time()
    librispeech_record_generator.write_fake_librispeech(
        root, num_train=SPEECH_RECORDS[0], num_validation=SPEECH_RECORDS[1])
    gen_s = time.time() - t0
    bench, stats, counts, peak = bench_arm(speech_params(
        data_dir=root, num_batches=SPEECH_RECORD_STEPS,
        num_warmup_batches=0, display_every=SPEECH_RECORD_STEPS))
    check(np.isfinite(stats["last_average_loss"]),
          "speech records: loss not finite")
    check_launches("speech records", counts, {}, stats["steps_run"])
    stall = stats["feed_stall_fraction"]
    del bench
    ev = benchmark.BenchmarkCNN(speech_params(
        data_dir=root, eval=True, num_eval_batches=1))
    results = ev.run()
    check(results.get("num_eval_batches") == 1 and
          np.isfinite(results["base_loss"]),
          f"speech records: eval gave {results}")
    del ev
  out["records"] = dict(examples_per_sec=stats["images_per_sec"],
                        feed_stall=stall, loss=stats["last_average_loss"],
                        losses=list(stats["losses"]), peak_gib=peak,
                        eval_loss=results["base_loss"],
                        eval_top_1=results["top_1_accuracy"],
                        generate_s=gen_s)
  log(f"speech records: {SPEECH_RECORDS[0]} + {SPEECH_RECORDS[1]} generated "
      f"utterances ({gen_s:.1f} s to write), batch {SPEECH_BATCH}, "
      f"{stats['steps_run']} steps: {stats['images_per_sec']:.2f} "
      f"examples/sec, feed_stall_fraction "
      f"{stall if stall is None else round(stall, 4)}, losses "
      f"{[round(v, 2) for v in stats['losses']]} (optax's log-epsilon path "
      f"for the utterances whose labels outnumber their CTC frames), peak "
      f"memory {peak:.2f} GiB; one eval batch: loss "
      f"{results['base_loss']:.2f}, non-blank frame share "
      f"{results['top_1_accuracy']:.4f}")


# -- the frozen forward and the serving variants ----------------------------------

AOT_STEPS = (3, 10)  # warmup, timed of each loaded program


class _NotingOps(TorchDispatchMode):
  """Keeps clones of the inputs of the first call at each shape of the
  kernels' custom ops made while the mode is on (the loaded program calls
  them through the dispatcher, not through the wrappers), and lets the
  calls through."""

  def __init__(self, calls):
    super().__init__()
    self.calls = calls

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    name = str(func.name())
    if name.startswith("kf_torch::"):
      key = (name, tuple(tuple(a.shape) for a in args
                         if isinstance(a, torch.Tensor)))
      if key not in self.calls:
        self.calls[key] = tuple(a.clone() if isinstance(a, torch.Tensor)
                                else a for a in args)
    return func(*args, **(kwargs or {}))


def aot_start(*flags):
  """Starts ``python -m kf_benchmarks_tpu_torch.cli`` forward-only on
  ResNet-50 v1.5 at batch 256, bf16; ``aot_finish`` waits for it."""
  cmd = [sys.executable, "-m", "kf_benchmarks_tpu_torch.cli",
         "--model=resnet50", "--batch_size=256", "--use_fp16",
         "--forward_only", *flags]
  return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)


def aot_finish(started):
  """The stdout of the process of ``aot_start``, which must exit 0."""
  cmd, proc = started
  try:
    out, err = proc.communicate(timeout=600)
  except subprocess.TimeoutExpired:
    proc.kill()
    out, err = proc.communicate()
  check(proc.returncode == 0, f"aot: {' '.join(cmd[2:])} exited "
        f"{proc.returncode}\n{out[-2000:]}\n{err[-3000:]}")
  return out


def phase_aot(res):
  """The frozen forward: ResNet-50 v1.5 at batch 256, bf16, exported by the
  CLI at --trt_mode=FP16 and INT8 (one process each, the two at once, each
  then running one forward-only step), each loaded in a fresh process
  alone, captured as a CUDA graph and timed (AOT_STEPS, its launch counts
  read from its log: 13 K-B and no K-A a forward), beside phase infer's
  in-process eager rate. In this process: an
  INT8 load asked for the float mode must fail on the sidecar diff; each
  loaded program's logits on one batch against the in-process eval forward
  of the same weights (the FP16 program: bf16 rounding only; the INT8
  program against the forward on its dequantized weights, and its
  distance from the float forward), and K-B against its plain version on
  the loaded INT8 program's own inputs. The artifacts live in a temporary
  directory for the phase."""
  warm, timed = AOT_STEPS
  out = {}
  with tempfile.TemporaryDirectory() as root:
    _aot_in(res, out, root)
  res["aot"] = out


def aot_paths(root):
  """{mode: the export's path under ``root``}."""
  return {m: os.path.join(root, f"resnet50_{m.lower()}.pt2")
          for m in ("FP16", "INT8")}


def aot_exports(paths):
  """Starts the two exports at once: {mode: ``aot_start``'s launch}."""
  return {mode: aot_start(f"--trt_mode={mode}", f"--aot_save_path={path}",
                          "--num_batches=1", "--num_warmup_batches=0")
          for mode, path in paths.items()}


def _aot_in(res, out, root):
  """Phase aot's work, its artifacts under ``root`` (or where phase
  elastic's early exports left them)."""
  import shutil
  from kf_benchmarks_tpu_torch import aot
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import convert
  from kf_benchmarks_tpu_torch import quantization
  warm, timed = AOT_STEPS
  # The two exports run at once (each timed to its own end), here or in
  # phase elastic (EARLY); each load below runs alone, as it is timed.
  early = {m: EARLY.pop(f"aot_{m}", None) for m in ("FP16", "INT8")}
  if all(early.values()):
    paths = {m: e["path"] for m, e in early.items()}
    texts = {m: (e["text"], e["seconds"]) for m, e in early.items()}
  else:
    paths = aot_paths(root)
    texts = timed_waits({
        mode: (lambda started=started: aot_finish(started))
        for mode, started in aot_exports(paths).items()})
  for mode, path in paths.items():
    text, seconds = texts[mode]
    check(f"Exported frozen forward program to {path}" in text,
          f"aot: no export line\n{text[-2000:]}")
    out[mode] = {"bytes": os.path.getsize(path), "export_s": seconds,
                 "sidecar": aot.read_signature(path)}
  ratio = out["INT8"]["bytes"] / out["FP16"]["bytes"]
  log(f"aot: export (two CLI processes at once"
      f"{', in phase elastic' if all(early.values()) else ''}, build + "
      f"export + 1 step, each until it ended): FP16 "
      f"{out['FP16']['bytes']} bytes in {out['FP16']['export_s']:.1f} s, "
      f"INT8 {out['INT8']['bytes']} bytes in {out['INT8']['export_s']:.1f} "
      f"s: INT8 / FP16 = {ratio:.4f}")
  check(ratio < 0.35, f"aot: INT8 artifact {ratio:.3f} of the FP16 one")
  infer = res.get("infer", {}).get("resnet50", {}).get("images_per_sec")
  counts = dict.fromkeys(benchmark.kernel_launches(), 0)
  for mode, path in paths.items():
    text = aot_finish(aot_start(
        f"--trt_mode={mode}", f"--aot_load_path={path}",
        f"--num_batches={timed}", f"--num_warmup_batches={warm}",
        "--display_every=10"))
    m = re.search(r"^total images/sec: ([\d.]+)$", text, re.M)
    check(m and "Loaded frozen forward program" in text and
          "Captured the loaded program as a CUDA graph" in text,
          f"aot: load {mode}\n{text[-2000:]}")
    launched = launches_in(text)
    steps = warm + timed
    rate = float(m.group(1))
    out[mode].update(images_per_sec=rate, launches=launched)
    log(f"aot: loaded {mode} program (fresh process, replayed as a CUDA "
        f"graph): {rate:.2f} images/sec "
        f"({warm} warmup + {timed} timed at batch 256; phase infer's "
        f"in-process forward-only: "
        f"{'%.2f' % infer if infer else 'not run in this call'}), launches "
        f"{launched} = {launched.get('bn_relu_conv3x3_stats', 0) / steps:g} "
        f"K-B a forward")
    check(launched.get("bn_relu_conv3x3_stats") == 13 * steps and
          not launched.get("conv3x3_same"),
          f"aot {mode}: launches {launched}, want 13 K-B a forward")
    for name, n in launched.items():
      counts[name] += n
  res.setdefault("counts_by_path", {})["aot"] = counts
  # The entry the CLI's load goes through, asked for the float mode.
  diff = "quantize_mode: sidecar='int8', requested=None"
  try:
    aot.load_forward(paths["INT8"], expect_quantize=None, device="cuda")
    check(False, "aot: a float load of the INT8 export did not fail")
  except ValueError as e:
    check(diff in str(e), f"aot: a float load of the INT8 export: {e}")
  log(f"aot: loading the INT8 export as the float mode fails with the "
      f"sidecar diff ({diff})")
  # Logits on one batch against the in-process forward of the same weights
  # (the export's weights come from --tf_random_seed, as here).
  bench = benchmark.BenchmarkCNN(resnet_params(forward_only=True))
  module, _, images, _ = bench.build()
  module.eval()
  with torch.no_grad():
    live = module(images).float()
    fp16 = aot.load_forward(paths["FP16"], device="cuda")(images).float()
    calls = {}
    int8_fn = aot.load_forward(paths["INT8"], expect_quantize="int8",
                               device="cuda")
    with _NotingOps(calls):
      int8 = int8_fn(images).float()
    state = quantization.quantize_variables(
        module.state_dict(), lambda k, t: convert.flax_source(k, t, module))
    module.load_state_dict(quantization.dequantize_variables(state))
    dq = module(images).float()
  torch.cuda.synchronize()
  scale = float(live.abs().max())
  errs = {"fp16_vs_live": float((fp16 - live).abs().max()),
          "int8_vs_dequantized": float((int8 - dq).abs().max()),
          "int8_vs_live": float((int8 - live).abs().max())}
  top1 = float((int8.argmax(1) == live.argmax(1)).float().mean())
  log(f"aot: logits on one batch of 256 (max |logit| {scale:.4g}): FP16 "
      f"program vs in-process forward max abs err {errs['fp16_vs_live']:.4g}"
      f"; INT8 program vs the forward on its dequantized weights "
      f"{errs['int8_vs_dequantized']:.4g}, vs the float forward "
      f"{errs['int8_vs_live']:.4g} (top-1 agreement {top1:.4f})")
  for key in ("fp16_vs_live", "int8_vs_dequantized"):
    check(errs[key] <= 2e-2 * scale and math.isfinite(errs[key]),
          f"aot: {key} max abs err {errs[key]} (tol 2e-2 max|logit|)")
  out.update(logit_errs=errs, int8_top1_agreement=top1, logit_scale=scale)
  kb = [(key, args) for key, args in calls.items()
        if key[0] == "kf_torch::bn_relu_conv3x3_stats"]
  check(len(kb) == 4, f"aot: K-B shapes in the loaded program {list(calls)}")
  for i, (key, (x, sc, sh, w_k)) in enumerate(kb):
    n, h, w, c = x.shape
    res.setdefault("bn_relu_conv3x3_stats", []).append(check_unit_at(
        f"aot_{h}x{w}_{c}", n, h, w, c, w_k.shape[0], seed=0,
        given=(x, w_k.permute(1, 2, 3, 0).contiguous(), sc, sh)))
  del bench, module
  for e in early.values():
    if e:
      shutil.rmtree(e["root"], ignore_errors=True)


SERVE_VARIANTS = (
    ("dense", {}),
    ("int8", {"quantize": "int8"}),
    ("paged", {"kv_page_size": 128}),
    ("speculative", {"speculative_k": 4, "draft_n_layers": 2}),
    ("all3", {"quantize": "int8", "kv_page_size": 128, "speculative_k": 4,
              "draft_n_layers": 2}),
)


@contextlib.contextmanager
def capturing_decode_inputs(calls):
  """Keeps clones of the first flash_decode call's inputs of each shape
  made while the block runs, and lets the calls through."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  dec = fa.flash_decode

  def noted(q, k, v, pos, scale=None):
    key = (tuple(q.shape), tuple(k.shape))
    if key not in calls:
      calls[key] = (q.clone(), k.clone(), v.clone(), pos.clone(), scale)
    return dec(q, k, v, pos, scale)

  fa.flash_decode = noted
  try:
    yield
  finally:
    fa.flash_decode = dec


def variant_launches(kw, stats, waves):
  """The kernel launches an arm's replay must make: 6 layers a target
  program, 2 a draft one; the paged decode runs the tiled gather (no
  kernel has a block-table mode), so it launches no decode kernel."""
  steps = stats["serving/decode_steps"]
  rounds = stats["serving/spec_rounds"] or 0
  layers = kw.get("draft_n_layers") or 6
  return {"flash_decode": 0 if kw.get("kv_page_size") else layers * steps,
          "flash_attention_fwd": layers * waves + 6 * rounds}


def phase_serve_variants(res):
  """The serving engine's decode-cost variants at the full-size LM (bf16,
  flash, ladder 1/4/16/64/256): dense, INT8 weights, the paged KV cache
  (page 128), speculative decoding (k 4, a 2-layer draft) and all three,
  each on phase serve's two replays of the seeded poisson_workload (32
  requests, 32 new tokens, at 16/s and at capacity), warm() first and the
  launch counts set to 0 just before each replay and read just after. The
  INT8 arms are served by the engine directly: on random weights the INT8
  gate (decode.quantize_agreement on the workload's first 8 prompts) is
  meant to fail, and the serving bench would fall back to dense; its
  agreement and logit delta are printed. For each arm: tokens/sec, TTFT
  and token latency, the captured decode step at bucket 64 (and verify at
  bucket 64) on the device, peak memory, KV bytes against the dense slab,
  captured programs, launches, acceptance, and the share of requests
  whose tokens equal the dense arm's; the INT8 step's weight pass against
  the dense step's casts; then flash_decode on the INT8 arm's own last
  decode step and the flash forward on the composed arm's own last verify
  rows (B x 2048), each against its plain version."""
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import metrics as metrics_lib
  from kf_benchmarks_tpu_torch import tracing
  from kf_benchmarks_tpu_torch.data import packing
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  from kf_benchmarks_tpu_torch.serving import engine as engine_lib
  base = serve_spec()
  variables = decode_lib.init_variables(base, seed=0)
  lengths = packing.sample_document_lengths(
      np.random.default_rng(0), 64, base.max_len,
      mean_fraction=0.2).astype(np.int32)
  workloads = {label: engine_lib.poisson_workload(
      SERVE_REQUESTS, rate, base, seed=0, max_new_tokens=SERVE_MAX_NEW)
      for label, rate, _ in SERVE_REPLAYS}
  qspec = dataclasses.replace(base, quantize="int8")
  probe = [r.prompt for _, r in workloads["offered"][:8]]
  gate = decode_lib.quantize_agreement(qspec, variables, probe,
                                       max_new_tokens=8, device="cuda")
  log(f"serve_variants: INT8 gate on the workload's first 8 prompts: "
      f"agreement {gate['agreement']:.4f} over {gate['total']} positions "
      f"(bar {decode_lib.QUANTIZE_AGREEMENT_BAR}), max logit delta "
      f"{gate['max_logit_delta']:.4g} of logit scale "
      f"{gate['logit_scale']:.4g}: {'passed' if gate['passed'] else 'FAILED'}"
      f" (the INT8 arms below are served directly)")
  out = {"gate": gate}
  dense_tokens = {}
  counts_all = {}
  slab = None
  for arm, kw in SERVE_VARIANTS:
    spec = dataclasses.replace(base, **kw)
    out[arm] = {}
    for label, rate, depth in SERVE_REPLAYS:
      cfg = engine_lib.EngineConfig(spec=spec, max_new_tokens=SERVE_MAX_NEW,
                                    max_queue_depth=depth)
      exe = vexe = None
      trace = tracing.activate(tracing.RunTrace(keep_spans=True))
      metrics_lib.activate(metrics_lib.MetricRegistry())
      try:
        torch.cuda.reset_peak_memory_stats()
        engine = engine_lib.ServingEngine(cfg, variables=variables,
                                          device="cuda")
        t0 = time.time()
        n_warm = engine.warm()
        warm_s = time.time() - t0
        reset_launches()
        results = engine.replay([(t, dataclasses.replace(r))
                                 for t, r in workloads[label]])
        counts = benchmark.kernel_launches()
        stats = engine.stats()
        ledger = trace.compile_ledger()["entries"]
      finally:
        tracing.deactivate()
        metrics_lib.deactivate()
      peak = torch.cuda.max_memory_allocated() / 2 ** 30
      waves = sum(1 for s in trace.spans
                  if (s["sub"], s["name"]) == ("serving", "prefill"))
      ring = engine._ring_state()
      kv_bytes = ring.k.nbytes + ring.v.nbytes
      if arm == "dense" and label == "offered":
        slab = kv_bytes
      tokens = {r.rid: list(r.tokens) for r in results if r.status == "ok"}
      if arm == "dense":
        dense_tokens[label] = tokens
      same = sum(tokens.get(rid) == t
                 for rid, t in dense_tokens[label].items())
      want = variant_launches(kw, stats, waves)
      for name, n in counts.items():
        check(n == want.get(name, 0), f"serve_variants {arm} {label}: {name} "
              f"launched {n} times, want {want.get(name, 0)}")
        counts_all[name] = counts_all.get(name, 0) + n
      check(stats["serving/completed"] + stats["serving/shed"] ==
            SERVE_REQUESTS and stats["serving/completed"] >=
            SERVE_REQUESTS - SERVE_REQUESTS // 16,
            f"serve_variants {arm} {label}: {stats['serving/completed']} "
            f"completed, {stats['serving/shed']} shed")
      for r in results:
        check(r.status != "ok" or (len(r.tokens) == SERVE_MAX_NEW and all(
            0 <= t < spec.vocab for t in r.tokens)),
            f"serve_variants {arm} {label}: request {r.rid} gave {r.tokens}")
      check(all(e["captured"] for e in ledger) and
            len(ledger) == n_warm <= (3 if spec.speculative_k else 2) * 5,
            f"serve_variants {arm}: compile ledger {ledger}")
      draft, accepted = (stats["serving/draft_tokens"],
                         stats["serving/accepted_tokens"])
      row = dict(
          tokens_per_sec=stats["serving/tokens_per_sec"],
          ttft_p50=stats["serving/ttft_p50"], ttft_p99=stats["serving/ttft_p99"],
          token_latency_p50=stats["serving/token_latency_p50"],
          token_latency_p99=stats["serving/token_latency_p99"],
          completed=stats["serving/completed"], shed=stats["serving/shed"],
          decode_steps=stats["serving/decode_steps"],
          spec_rounds=stats["serving/spec_rounds"], waves=waves,
          accept_rate=(accepted / draft if draft else None),
          kv_pages_peak=stats["serving/kv_pages_in_use"],
          same_as_dense=same, peak_gib=peak, kv_bytes=kv_bytes,
          programs=len(ledger), warm_s=warm_s, launches=counts)
      if label == "offered":
        # The captured programs on the device at bucket 64: every slot
        # decoding at positions drawn like the workload's prompts (paged:
        # 64 x 16 distinct pages), and the verify over 64 rows.
        exe = engine._decode_exe(64)
        ring.pos[:64].copy_(torch.from_numpy(lengths))
        engine._active_buf[:64].fill_(True)
        if engine._pps:
          engine._table_buf[:64].copy_(torch.arange(
              1, 1 + 64 * engine._pps, dtype=torch.int32).reshape(64, -1))
        row["decode64_ms"] = time_ms(exe, iters=20)
        if spec.speculative_k:
          vexe, _ = engine._verify_exe(64)
          row["verify64_ms"] = time_ms(vexe, iters=5)
        if arm == "int8":
          row["decode_check"] = serve_decode_check(engine, spec)
          row.update(weight_pass_ms(engine, spec))
        if arm == "all3":
          row["verify_check"] = serve_verify_check(engine)
      out[arm][label] = row
      log(f"serve_variants: {arm} {label}: {row['completed']} completed, "
          f"{row['shed']} shed, {row['tokens_per_sec']:.1f} tokens/sec, TTFT "
          f"p50 {row['ttft_p50'] * 1e3:.1f} ms p99 {row['ttft_p99'] * 1e3:.1f}"
          f" ms, token latency p50 {row['token_latency_p50'] * 1e3:.2f} ms "
          f"p99 {row['token_latency_p99'] * 1e3:.2f} ms; "
          + (f"decode step at bucket 64 {row['decode64_ms']:.4f} ms; "
             if "decode64_ms" in row else "")
          + (f"verify at bucket 64 {row['verify64_ms']:.3f} ms; "
             if "verify64_ms" in row else "")
          + f"peak {peak:.2f} GiB, KV {kv_bytes / 2 ** 30:.3f} GiB "
          f"({kv_bytes / slab:.3f} of the dense slab); {len(ledger)} "
          f"captured programs in {warm_s:.1f} s; {row['decode_steps']} decode"
          f" steps, {row['spec_rounds']} verify rounds, {waves} prefill "
          f"waves; acceptance {row['accept_rate']}; tokens equal to the "
          f"dense arm's for {same} of {len(dense_tokens[label])} requests; "
          f"launches {counts}")
      del engine, exe, vexe
      gc.collect()
      torch.cuda.empty_cache()
    if kw.get("kv_page_size"):
      check(out[arm]["offered"]["kv_bytes"] < slab,
            f"serve_variants {arm}: paged KV not under the dense slab")
  res.setdefault("counts_by_path", {})["serve_variants"] = counts_all
  res["serve_variants"] = out


def graph_ms(fn, replays=20):
  """Device time of fn's work alone: captured once as a CUDA graph, the
  mean over back-to-back replays by CUDA events."""
  fn()
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    fn()
  return time_ms(graph.replay, iters=replays)


def weight_pass_ms(engine, spec):
  """The device time of the INT8 decode step's weight pass (each quantized
  block and head weight and the position table dequantized to bf16, as
  ``_serving_view`` does inside the step; the embedding's 64 rows) against
  the dense step's (the same weights cast whole from f32 to bf16; the
  dense step gathers its embedding rows), each alone in a CUDA graph."""
  from kf_benchmarks_tpu_torch import quantization
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  qvars = {k: v for k, v in engine.module.qvars.items()
           if k != "embed.weight"}
  dense = [quantization.dequantize(v) for v in qvars.values()
           if quantization.is_quantized(v)]
  out = {"dequantize_ms": graph_ms(
      lambda: decode_lib._serving_view(spec, qvars)),
         "dense_cast_ms": graph_ms(
      lambda: [v.to(spec.dtype) for v in dense])}
  log(f"serve_variants: the INT8 decode step's weight pass (every "
      f"quantized weight but the embedding dequantized to bf16, "
      f"{sum(v.numel() for v in dense)} elements) "
      f"{out['dequantize_ms']:.4f} ms against the dense step's f32 -> bf16 "
      f"casts of the same weights {out['dense_cast_ms']:.4f} ms (device "
      f"time, each captured alone)")
  return out


def serve_decode_check(engine, spec):
  """flash_decode against its plain version on the inputs of one more
  eager decode step of the engine's own cache at bucket 64 (the run's
  weights, K/V and positions)."""
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  calls = {}
  view = engine._bucket_view(64)
  active = engine._active_buf[:64]
  with capturing_decode_inputs(calls):
    decode_lib.decode_fn(spec)(engine.module, view.k, view.v, view.pos,
                               view.tok, active)
  key, args = next(iter(calls.items()))
  res_row = {}
  _, err = check_decode_case("serve_variants_int8_b64", *args)
  log(f"serve_variants: flash_decode on the INT8 arm's own cache at q "
      f"{list(key[0])} k {list(key[1])}: max abs err {err:.3g} (tol one "
      f"bf16 ulp + 1e-3 max|ref|), two launches bitwise equal, NaN past pos"
      f" invisible")
  res_row["max_abs_err"] = err
  return res_row


def serve_verify_check(engine):
  """The flash forward against its plain version on the inputs of one
  eager verify of the composed arm's own last rows at bucket 64 (the
  target's int8 weights and the run's histories and proposals): the
  B x 2048 causal shape."""
  from kf_benchmarks_tpu_torch.ops import flash_attention as fa
  from kf_benchmarks_tpu_torch.serving import decode as decode_lib
  _, rows = engine._verify_exe(64)
  calls = {}
  with capturing_flash_inputs(calls):
    decode_lib.verify_fn(engine.spec)(engine.target, rows)
  (qs, _, stride, causal), args = next(iter(calls.items()))
  o, lse = fa.flash_attention_fwd(*args)
  o_ref, lse_ref = fa.flash_attention_fwd_plain(*args)
  torch.cuda.synchronize()
  err, ok = bf16_close(o, o_ref)
  lse_err = float(((lse - lse_ref).abs() / lse_ref.abs().clamp_min(1.0)).max())
  log(f"serve_variants: flash forward on the composed arm's own verify "
      f"q{list(qs)} (strides {stride}) causal={causal}: o max abs err "
      f"{err:.3g} (tol one bf16 ulp + 1e-3 max|ref|), lse rel err "
      f"{lse_err:.2g} (tol 1e-3)")
  check(ok and lse_err <= 1e-3, "serve_variants: flash forward differs "
        "from its plain version on the verify's inputs")
  return {"max_abs_err": err, "lse_rel_err": lse_err, "shape": list(qs)}


def device_line() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def kernels_line(res, counts):
  rows = []
  for name, meta in KERNELS.items():
    shapes = res.get(name, [])
    probe = next((s for s in shapes if s["stage"] == HEADLINE[name]), None)
    row = {"name": name, **meta, "launches": counts.get(name),
           "launches_by_path": {path: c.get(name) for path, c in
                                res.get("counts_by_path", {}).items()}}
    for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library"):
      row[key] = probe[key] if probe else None
    for key in ("device_ms", "library_device_ms"):  # decode only
      if probe and key in probe:
        row[key] = probe[key]
    row["shape"] = probe["shape"] if probe else None
    row["by_shape"] = shapes
    rows.append(row)
  return {"kernels": rows}


# -- phases tune, allreduce and audit (item 10's second half) -----------------

# The tune phase's search: ResNet-50 at batch 256, bf16, world 1, over K, M
# and the prefetch depth, seeded, at most TUNE_CANDIDATES candidates and
# TUNE_TOP_K probed beside the default; each probe's short window is
# TUNE_PROBE_STEPS steps (probe_steps), so every K probes the same work.
TUNE_BASE = dict(model="resnet50", batch_size=256, use_fp16=True,
                 optimizer="momentum", device="gpu")
TUNE_AXES = (("steps_per_dispatch", (1, 2, 4, 8)),
             ("num_grad_accum", (1, 2)),
             ("input_prefetch_depth", (None, 2, 4)))
TUNE_CANDIDATES, TUNE_TOP_K, TUNE_PROBE_STEPS = 12, 2, 8
TUNE_WARMUP, TUNE_STEPS = 2, 10  # the tuned run: 12 steps


def phase_tune(res):
  """The autotuner (analysis/autotune.py) behind --autotuned_config:
  enumerate TUNE_AXES through the port's validation, trace each distinct
  step on fake tensors (the contract's peak live bytes against the card's
  memory less a reserve, its kernel calls and FLOPs), rank by the cost
  model, probe the default and the top TUNE_TOP_K on the card (the
  differential pair of windows, twice), write the table to a temporary
  directory; then 12 steps of ResNet-50 under --autotuned_config: the
  applied knobs, the record's provenance and the launches a step the
  contract predicts (13 + 13 K-A / K-B a microbatch)."""
  import collections
  from kf_benchmarks_tpu_torch import benchmark
  from kf_benchmarks_tpu_torch import metrics as metrics_lib
  from kf_benchmarks_tpu_torch import params as params_lib
  from kf_benchmarks_tpu_torch.analysis import autotune
  from kf_benchmarks_tpu_torch.analysis.__main__ import card_info
  out = res["tune"] = {}
  budget = autotune.hbm_budget_bytes()
  tracer = autotune.make_tracer(world=1)
  t0 = time.time()
  lines = []
  with tempfile.TemporaryDirectory(prefix="tune_") as root:
    path = os.path.join(root, autotune.TABLE_FILENAME)
    table = autotune.autotune_configs(
        [TUNE_BASE], out=path, seed=0, axes=collections.OrderedDict(
            TUNE_AXES), max_candidates=TUNE_CANDIDATES, top_k=TUNE_TOP_K,
        probe_steps=TUNE_PROBE_STEPS, hbm_budget=budget, tracer=tracer,
        card=card_info(), log=lambda m: (lines.append(m), log("tune: " + m)))
    search_s = time.time() - t0
    (key, entry), = table["entries"].items()
    problems, warnings = autotune.validate_table(
        autotune.load_table(path))
    check(not problems, f"tune: the written table has problems {problems}")
    probes = entry["probes"]
    check(entry["probed"] == len(probes) and 2 <= len(probes) <=
          TUNE_TOP_K + 1, f"tune: {entry['probed']} probes")
    check(entry["tuned_images_per_sec"] >= entry["default_images_per_sec"],
          "tune: the pick measured below the default")
    for p in probes:
      log(f"tune: probe {json.dumps(p['knobs'], sort_keys=True)}: "
          f"{p['images_per_sec']:.2f} images/sec (spread "
          f"{100 * p['spread']:.1f}%) beside the default's "
          f"{entry['default_images_per_sec']:.2f}")
    log(f"tune: {entry['candidates']} candidates, {entry['invalid']} "
        f"invalid, {entry['pruned']} pruned, {entry['probed']} probed in "
        f"{search_s:.1f} s; pick {json.dumps(entry['tuned'], sort_keys=True)}"
        f" at {entry['tuned_images_per_sec']:.2f} images/sec (default "
        f"{entry['default_images_per_sec']:.2f}, probe spread "
        f"{100 * entry['probe_spread']:.1f}%, dispatch "
        f"{entry['dispatch_overhead_s']} s), HBM budget {budget} B, "
        f"{entry['device_name']}, {entry['power_limit']}")
    # The tuned run: the table's knobs over the base flags.
    store = os.path.join(root, "store")
    params = params_lib.make_params(
        **TUNE_BASE, autotuned_config=path, num_batches=TUNE_STEPS,
        num_warmup_batches=TUNE_WARMUP, display_every=5,
        run_store_dir=store)
    bench = benchmark.BenchmarkCNN(params)
    tuned = {k: getattr(bench.params, k) for k in entry["tuned"]}
    check(tuned == {k: v if v is not None else getattr(
        params_lib.make_params(), k) for k, v in entry["tuned"].items()},
          f"tune: applied {tuned}, the table says {entry['tuned']}")
    check(bench.tuned_provenance == {"path": path, "entry": key},
          f"tune: provenance {bench.tuned_provenance}")
    contract = tracer(autotune.static_overrides(autotune.merged_overrides(
        TUNE_BASE, entry["tuned"])), "train_step")
    reset_launches()
    stats = bench.run()
    counts = benchmark.kernel_launches()
    res.setdefault("counts_by_path", {})["tune"] = counts
    steps = stats["steps_run"]
    check(steps == TUNE_WARMUP + TUNE_STEPS, f"tune: ran {steps} steps")
    for name in ("conv3x3_same", "bn_relu_conv3x3_stats"):
      want = contract.kernel_calls.get(name, 0)
      check(counts[name] == want * steps,
            f"tune: {name} launched {counts[name]} times in {steps} steps, "
            f"the contract calls it {want} times a step")
    check(stats["tuned_config"] == {"path": path, "entry": key},
          f"tune: stats provenance {stats['tuned_config']}")
    (record,) = metrics_lib.RunStore(store).records()
    snap = record["snapshot"]
    check(snap.get("tuned_config_path") == path and
          snap.get("tuned_config_entry") == key,
          f"tune: the run record's provenance {snap}")
    check(np.isfinite(stats["last_average_loss"]), "tune: loss not finite")
  out.update(entry=entry, search_s=search_s, tuned_run_images_per_sec=stats[
      "images_per_sec"], launches=counts, steps=steps,
      contract_kernel_calls=contract.kernel_calls,
      contract_flops=contract.aux.get("flops"),
      contract_peak_live_bytes=contract.peak_live_bytes)
  log(f"tune: tuned run {steps} steps at {json.dumps(tuned, sort_keys=True)}"
      f": {stats['images_per_sec']:.2f} images/sec, launches {counts} "
      f"({contract.kernel_calls} a step by the contract), record provenance "
      f"entry {key}; contract FLOPs a step {contract.aux.get('flops'):.4e}, "
      f"peak live {contract.peak_live_bytes / 2**30:.2f} GiB")


ALLREDUCE_SPECS = (None, "psum:32k:rsag")
ALLREDUCE_ITERS, ALLREDUCE_STEPS = 5, 10


def phase_allreduce(res):
  """all_reduce_benchmark.py over NCCL at world 1 (one card): ResNet-50's
  161 gradient shapes through the per-tensor all-reduce mean and one
  packed spec, five chained reductions a step, the reduced values held to
  the inputs (a world-1 mean is the identity plus the chain's 1e-6
  steps); then a short sweep (psum, reduce_scatter, all_gather at 256 KiB
  and 4 MiB). At world 1 each row times NCCL's own call, not a wire."""
  import torch.distributed as dist
  from kf_benchmarks_tpu_torch import all_reduce_benchmark as arb
  from kf_benchmarks_tpu_torch import params as params_lib
  from kf_benchmarks_tpu_torch.models import model_config
  from kf_benchmarks_tpu_torch.parallel import mesh
  out = res["allreduce"] = {}
  check(not dist.is_initialized(), "allreduce: a process group is alive")
  mesh.init_process_group("gpu", 1, 0, mesh.local_init_method())
  try:
    shapes = arb.get_var_shapes(model_config.get_model_config(
        "resnet50", params_lib.make_params(), "imagenet"))
    check(len(shapes) == 161, f"allreduce: {len(shapes)} ResNet-50 shapes")
    for spec in ALLREDUCE_SPECS:
      params = params_lib.make_params(
          model="resnet50", device="gpu", num_batches=ALLREDUCE_STEPS,
          num_warmup_batches=2, all_reduce_spec=spec)
      reduce = arb.make_reduce(params)
      g = torch.Generator(device="cuda").manual_seed(0)
      xs = [torch.randn(s, generator=g, device="cuda") for s in shapes]
      ys = arb.chained_reduce([x.clone() for x in xs], ALLREDUCE_ITERS,
                              reduce)
      err = max(float((y - x).abs().max()) for x, y in zip(xs, ys))
      check(err <= ALLREDUCE_ITERS * 1e-6 + 1e-6,
            f"allreduce {spec}: a world-1 mean moved a value by {err}")
      stats = arb.run_benchmark(params, ALLREDUCE_ITERS)
      label = spec or "per_tensor"
      out[label] = dict(stats, max_abs_err=err)
      log(f"allreduce [{label}]: {stats['num_tensors']} tensors, "
          f"{stats['bytes_per_replica'] / 1e6:.2f} MB, world "
          f"{stats['world']}: {stats['average_all_reduce_time'] * 1e3:.4f} "
          f"ms a reduction ({stats['average_time_per_step'] * 1e3:.4f} ms a "
          f"step of {ALLREDUCE_ITERS}); max abs err {err:.3g}; "
          f"{arb.wire_note()}")
    rows = arb.run_sweep(params_lib.make_params(
        device="gpu", num_batches=ALLREDUCE_STEPS, num_warmup_batches=2),
        ALLREDUCE_ITERS, "psum,reduce_scatter,all_gather", "256k,4m")
    check(len(rows) == 6 and all(r["step_ms"] > 0 for r in rows),
          f"allreduce: sweep rows {rows}")
    out["sweep"] = rows
  finally:
    mesh.destroy_process_group()


def audit_start():
  """Phase audit in a process of its own (``--phases=audit``), started
  beside phase elastic; ``audit_finish`` waits for it."""
  root = tempfile.mkdtemp(prefix="audit_early_")
  proc = subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), "--phases=audit"],
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
  return root, proc


def audit_finish(started):
  root, proc = started
  try:
    out, err = proc.communicate(timeout=600)
  except subprocess.TimeoutExpired:
    proc.kill()
    out, err = proc.communicate()
  check(proc.returncode == 0, f"audit: its process exited "
        f"{proc.returncode}\n{out[-2000:]}\n{err[-4000:]}")
  return dict(text=out, root=root)


def phase_audit(res):
  """The audit's result: from its own process when phase elastic started
  it (EARLY), else the audit run here (``audit_here``)."""
  early = EARLY.pop("audit", None)
  if early is None:
    audit_here(res)
    return
  import shutil
  shutil.rmtree(early["root"], ignore_errors=True)
  lines = [line for line in early["text"].splitlines()
           if line.startswith("audit: ")]
  check(len(lines) == 1 and " 0 violations, 0 golden diffs, no schedule "
        "drift" in lines[0], f"audit: {early['text'][-2000:]}")
  res["audit"] = {"seconds": early["seconds"], "line": lines[0]}
  log(f"{lines[0]}; its own process beside phase elastic, "
      f"{early['seconds']:.1f} s")


def audit_here(res):
  """Every golden contract of the port through every rule, on the CPU
  (fake process group, fake tensors: nothing runs on the card) with the
  card's torch: 0 violations, 0 golden diffs, no schedule drift. (The
  sharded goldens at worlds 2, 4 and 8 are the CPU tests' and the CLI's:
  another 40 s of host CPU.) Untimed: in a full run its own process runs
  it beside phase elastic."""
  from kf_benchmarks_tpu_torch.analysis import audit, baseline, contracts
  from kf_benchmarks_tpu_torch.analysis import spmd
  t0 = time.time()
  known = dict(contracts.GOLDEN_CONFIGS)
  known.update(contracts.SERVING_GOLDEN_CONFIGS)
  tracer = audit.make_memo_tracer()
  report = audit.audit_configs(known, tracer=tracer)
  bad = {n: e["violations"] for n, e in report["configs"].items()
         if e["violations"]}
  check(not bad, f"audit: rule violations {bad}")
  diffs = {n: baseline.check_against_golden(
      n, tracer(dict(c), audit.program_of(c))) for n, c in known.items()}
  diffs = {n: d for n, d in diffs.items() if d}
  check(not diffs, f"audit: golden diffs {diffs}")
  drift = {n: spmd.schedule_drift(n, tracer(dict(c), audit.program_of(c)))
           for n, c in known.items()}
  drift = {n: d for n, d in drift.items() if d}
  check(not drift, f"audit: schedule drift {drift}")
  res["audit"] = {"configs": len(known), "seconds": time.time() - t0}
  log(f"audit: {len(known)} golden contracts, {len(audit.RULES)} rules: 0 "
      f"violations, 0 golden diffs, no schedule drift "
      f"({time.time() - t0:.1f} s on the CPU)")


PHASES = {"build": phase_build, "conv": phase_conv, "unit": phase_unit,
          "train": phase_train, "parity": phase_parity,
          "flash": phase_flash, "flash_grad": phase_flash_grad,
          "lm_train": phase_lm_train, "lm_parity": phase_lm_parity,
          "decode": phase_decode, "serve": phase_serve,
          "serve_parity": phase_serve_parity, "dp": phase_dp,
          "zoo": phase_zoo, "elastic": phase_elastic,
          "infer": phase_infer, "eval": phase_eval, "optim": phase_optim,
          "dispatch": phase_dispatch, "accum": phase_accum,
          "serve_graph": phase_serve_graph,
          "fp16_vars": phase_fp16_vars, "health": phase_health,
          "faults": phase_faults, "input": phase_input,
          "aot": phase_aot, "serve_variants": phase_serve_variants,
          "models": phase_models, "detect": phase_detect,
          "speech": phase_speech, "observe": phase_observe,
          "tune": phase_tune, "allreduce": phase_allreduce,
          "audit": phase_audit, "models_cosines": phase_models_cosines,
          "observe_pairs": phase_observe_pairs,
          "serve_profile": phase_serve_profile,
          "conv_tiles": phase_conv_tiles,
          "first_steps": phase_first_steps,
          "profile": phase_profile, "lm_profile": phase_lm_profile}


def run_phase(name, res):
  t0 = time.time()
  log(f"== phase {name}")
  PHASES[name](res)
  # What a phase kept alive -- CUDA graphs' private pools, engines'
  # rings -- goes before the next one.
  gc.collect()
  torch.cuda.empty_cache()
  log(f"== phase {name} done in {time.time() - t0:.1f} s")


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--phases", default=",".join(ALL_PHASES),
                  help="comma-separated subset of " + ",".join(ALL_PHASES))
  args = ap.parse_args(argv)
  phases = [p for p in args.phases.split(",") if p]
  unknown = set(phases) - set(ALL_PHASES) - set(EXTRA_PHASES)
  if unknown:
    raise SystemExit(f"unknown phases {sorted(unknown)}")
  if not torch.cuda.is_available():
    log("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    return 1
  # The plain versions and library yardsticks run in full f32 / bf16:
  # no TF32 anywhere in this run.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  log(f"chip_smoke: torch {torch.__version__}, CUDA {torch.version.cuda}, "
      f"{torch.cuda.get_device_name(0)}")
  res = {"counts": {}, "phases": phases,
         "beside_elastic": [p for p in BESIDE_ELASTIC
                            if p in phases and "elastic" in phases]}
  try:
    for name in phases:
      if name not in res["beside_elastic"]:
        run_phase(name, res)
  finally:
    drop_early()
  log(device_line())
  log(json.dumps(kernels_line(res, res["counts"])))
  if phases != list(ALL_PHASES):
    log("chip_smoke: partial run, no result line")
    return 0
  log(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
