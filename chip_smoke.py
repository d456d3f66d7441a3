#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (singa_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab OTHER_CHECKOUT
    python3 chip_smoke.py --ab-train OTHER_CHECKOUT
    python3 chip_smoke.py --pp-drift
    python3 chip_smoke.py --repeat-20c N

The third form only times the train steps of the two checkouts in the
same turns: phase 6's bench GPT (eager and as a graph), and phase 7's
ResNet-50 (as a graph) in a checkout
that has the SINGA Tensor API (host clock, each step fenced by
loss.item(); 2 warm-up steps, then 7). The second form only times the kernels K1 (flash forward), K2a (fused
backward), K2b and K2c (the split backward's dQ and dK/dV), K3
(flash-decode) and K4 (paged decode) of this checkout against another
checkout's (for example the parent commit, unpacked with `git archive`),
bf16, in turns (other, this, this, other), each turn in its own process
building its checkout's sources: K1 (causal) at the serving prefill
(8, 12, 128, 64), a 16-token prompt and the bench GPT's training shape
(8, 16, 1024, 128), K2a at the training shape, K2b and K2c at the
long-context shape (1, 16, 16384, 128), K3 and K4
at phase 2's decode shape (N 8, Hp 6, PD 128, T 1024, page 16) with an
fp cache single, int8 single and int4 on the 5-token ladder, and fp
single at their main path's shape and lengths (MAIN_DECODE); each as
device time, as CUDA events around the call and as the host's median
issue time (the wrapper's call until it returns).

The fourth form only follows phase 19a's models over PP_DRIFT_STEPS
free-running steps under bf16 amp and in fp32, printing each step's
loss difference from the serial model's (`pp_drift`).

The fifth form only builds the kernels and runs phase 20c (the router's
kill-and-replace A/B) N times, printing each run's wall, how often the
kill trigger froze the victim and thawed it again, and its verdict; it
exits non-zero if any run failed (`repeat_20c`).

Phases, each of which exits non-zero on failure:

1. Environment: the card's name and power limit, torch/CUDA/nvcc
   versions, and the build of every kernel (one nvcc per source, all
   started together) with its time, per source too, and ptxas's
   registers and spills (the flash and decode kernels must not spill).
2. Each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes: the error against the stated
   tolerance, and the kernel's device time beside the plain version's,
   its bound and the one-call library yardstick where there is one; the
   flash kernels also with achieved TFLOP/s and bound / time, and (text
   only, not in the JSON line) the time the CUDA-core design that their
   bf16 paths replaced took at the shapes where it was measured. K1 and
   K2a in bf16 also run ragged shapes (S 300, 1023, 100). The backward
   kernels (K2a fused, K2b dQ + K2c dK/dV split) run both routes of the
   dispatch, forced through `_FUSED_DQ_BYTES_CAP`, against
   `flash_bwd_reference`, with dq, dk and dv compared separately, causal
   and (bf16, S 1023 and 100) not; the split route must give bitwise-equal
   results in two runs and, in bf16, dk and dv bitwise equal to the fused
   route's (K2c runs K2a's body without its dQ branch). The
   decode kernels (K3, K4) run every cache mode (fp32, bf16, int8, int4)
   and the verify ladder (q_tokens 5), a GQA ladder past 16 rows,
   inactive slots under the ladder, 64 rows x 256 lanes (the largest
   workspace of partials) in fp32 and bf16, each kernel at its main
   path's shape and lengths (bf16, fp and int8 single, at the middle and
   last step of phase 4's `generate` and phase 5's engine), rows of 72 and
   36 bytes (plain loads, not cp.async) and, paged, page size 48.
3. Full-width GPT-2-small (random weights from a seed), teacher-forced:
   prefill + token_step on the kernels against use_kernel=False in fp32
   (dense and paged), and the bf16 logit drift and top-1 agreement.
   3b. The same in fp32 with int8 and int4 caches, and the k = 5 verify
   steps (dense and paged) against five sequential steps: logits, and
   the caches' values within one quantization step.
4. The serving main path, two entry points run one after the other:
   GPT.generate (batch 8, prompt 128, 128 new tokens, bf16), then a
   ServingEngine answering 16 requests. Every kernel launch counter is
   reset just before each and read just after it, and each path's
   counts must be exactly one launch per layer per prefill or step.
   4b. The engine in fp32 on the card: its greedy tokens on the kernels
   must equal its tokens with use_kernel=False and fp32 GPT.generate's.
   4c. The quantized and speculative entry points, bf16, each in its own
   launch window with exact counts, also by cache mode and ladder:
   generate (+QUANT_NEW) with int8 and int4 caches and with int8 weights,
   speculative generate (spec_k 4) with a clone draft and with a small
   random draft, generate_beam (4 beams) over an int4 cache, an engine
   with int8 pools and a speculative engine with int4 pools
   (SPEC_ENGINE_REQS requests).
   4d. fp32 on the card: speculative generate, generate_beam with one
   beam and the speculative engine against plain greedy, the int8 and
   int4 engines against dense generate with the same caches, token for
   token (a divergence only where the reference's top-2 logit gap is
   below 1e-4, printed). int8 weights: teacher-forced logits with fp32
   activations over the int8 weights, kernels against plain within 1e-3
   while the bf16 weights' logits lie over 1e-2 away; and the int8-weight
   engine (bf16) on the kernels against use_kernel=False (ties within
   twice the bf16 kernel-vs-plain logit difference, printed).
6. The training main path: the repo's GPT training benchmark model
   (vocab 8192, dim 2048, 16 heads, 8 layers; random weights from a seed)
   through Model.compile(amp="bfloat16") and `m(ids, targets)` with SGD,
   batch 8 x 1024: one warm step, then timed steps with exact launch
   counts per step (K1 and K2a once per layer); then save_states,
   load_states into a fresh model, identical logits.
   6b. fp32 training on the card against the same steps on the CPU (plain
   versions), from identical weights: losses and parameters.
   6c. Long-context training (S = 16384, 2 layers, bf16), where the
   backward takes the split pair K2b + K2c, with exact launch counts; one
   step under torch.profiler, which must show the tensor-core K1, K2b and
   K2c; and one layer's backward on both routes (K2a forced) held against
   `flash_bwd_reference` and timed beside each other.
5. Where the time goes: device time by kernel under torch.profiler for a
   short generate call, a short engine run, a short speculative engine
   run and one training step; the serving profiles must show their decode
   kernel and its merge (counted as attention), the training step the
   tensor-core flash kernels, all printed with the top kernels.
7. The SINGA API's main path at the bench's width: ResNet-50 (b32 x 224
   x 224, 10 classes, random weights from a seed, seeded numpy inputs)
   through models.create_model, tensor.Tensor, compile(use_graph=True,
   amp="bfloat16") and `m(tx, ty)` with SGD(0.1, 0.9, wd 1e-5): 2 warm-up
   steps, 5 timed (median step ms, img/s, peak memory, TFLOP/s and the
   share of the bf16 peak from the conv and linear shapes), 20 in all
   for the loss check (finite, and below its start by the last five);
   then one step under torch.profiler by category (conv, batch norm,
   matmul, the rest, and the optimizer's `opt.apply_updates` range) with
   the device's idle share. No hand-written kernel runs on this path.
   7b. fp32 on the card against the CPU: a small ResNet (Bottleneck,
   [1, 1, 1, 1], b8 x 64 x 64) from the same weights, two SGD steps:
   losses (relative) and parameters and running stats (absolute) within
   1e-4.
   7c. autograd.attention on CUDA Tensors, fp32 and bf16, in a counted
   window: K1 and K2a launch once each per dtype, and the output and
   dq/dk/dv agree with use_kernel=False at phase 2's tolerances; the
   counts join the kernels line as the `tensor_attention` path.
8. The training paths as CUDA graphs (compile(use_graph=True)): the fp32
   GPT of 6b, graph against eager from the same weights, 6 steps, losses
   (relative) and parameters within 1e-5, printed bitwise or not; the
   two models then in eval mode, the graph one's forward buffered per
   batch bucket, logits within 1e-5 of eager's over batches of 2, 2, 2,
   1, 2 rows, one K1 launch per layer in the last call (a replay); the
   bench GPT eager and graph in one process, in turns (step ms median,
   tokens/s), exactly 8 + 8 K1/K2a launches per replayed step, the graph
   step under torch.profiler (busy and idle beside phase 5's eager
   step); and 6c's long-context step as a graph, exactly 2 + 2 + 2
   K1/K2b/K2c launches per replay.
   8b. ResNet-50 b32 bf16 graph against eager in turns (step ms, img/s),
   the graph step profiled beside phase 7's eager one; the fp32 small
   ResNet of 7b, graph against eager, both on cuDNN's deterministic
   algorithms, losses, parameters and running statistics within 1e-5
   (two eager runs on cuDNN's default algorithms printed beside: those
   are not reproducible run to run).
   8c. The trainer's pipeline: FIT_BATCHES seeded batches of the bench
   GPT cut to 4 layers (FIT_GPT) written with io.RecordWriter (the
   native backend required), Model.fit over an io.RecordReader-backed
   dataset in graph mode with prefetch_to_device=2,
   save_checkpoint(async_save=True) after epoch 1 with epoch 2
   overlapping the write (exactly 16 + 16 launches), then
   load_checkpoint into a fresh model and its epoch 2; the fp32 GPT's
   resumed epoch 2 held to the uninterrupted run within 1e-5; a
   SNAP_SHARE-th of the model's state bytes copied to the host, then
   written and read through snapshot.Snapshot, native and npz (the plain
   version), MB/s each.
9. MoE-GPT training: GPT-2-small's width and depth with 8 experts, top-2,
   capacity factor 1.25 (README.md's MoE-GPT; ~560 M parameters), b8 x
   1024, bf16 amp (the experts and router fp32, as in the JAX package),
   SGD: 1 warm-up and 5 timed eager steps, then a model from the same
   seed as a CUDA graph (warm-up, capture) and 5 replays; exactly 12 + 12
   K1/K2a launches a step in both windows; the router losses in the loss;
   ms a step, tokens/s, peak memory and each layer's overflow; the graph
   step under the profiler (expert bmm, router/dispatch/combine, flash
   kernels, matmul, the rest) and one layer's experts timed alone.
   9b. fp32 MoE-GPT (dim 512, 2 layers, 4 experts, top-2, cf 1.25, so
   routes drop; b4 x 256) on the card against the CPU, 3 SGD steps
   (losses relative, parameters absolute, 1e-4), then its graph step
   against its eager step over 6 steps (1e-5).
   9c. MoE-GPT serving, phase 9's configuration: generate b8, prompt 128,
   +MOE_NEW, bf16 at the layers' capacity factor and at 8 (no drops), with
   int8 weights and with an int4 cache; the engine, 8 requests of prompt
   256, +32, 8 slots, page 16; exact K1/K3/K4 counts; both under the
   profiler; fp32 teacher-forced logits, dense and paged, kernels against
   plain (LOGIT_TOL); then a random GPT-2-convention state dict through
   load_gpt2_weights into GPT-2-small on the card and on the CPU, logits
   within LOGIT_TOL.
10. The recurrences, fp32: lstm_scan and gru_scan forward and backward at
   bench_ops.py's shape (T 128, B 32, F 512, H 512) on the card against
   the CPU (1e-4 of max|ref|), timed beside cuDNN's torch.nn.LSTM/GRU at
   the same shape; examples/rnn/char_rnn.py's model (Embedding,
   CudnnRNN(128), Linear; b32 x 100, vocab 65) 5 steps eager and 5 as a
   CUDA graph from the same weights (1e-5), ms a step and tokens/s.
11. ONNX export and import (sonnx), fp32: 11a GPT-2-small (phase 3's
   model) traced on the tape by sonnx.export on ids b2 x 128, exactly 12
   K1 launches in a window around the export call (`onnx_export`), the
   graph's MatMul/Softmax/Tanh/LayerNormalization/Gather and its one
   input, then load_model and prepare on the card, the imported logits
   against the raw forward within ONNX_TOL of max |ref|; the file's MB
   and the export, save, load and prepare seconds and the run's ms. 11b
   the zoo's ResNet-50 (b8 x 224) exported and imported, eval logits
   within ONNX_TOL, then a SONNXModel subclass retrained with SGD 6 steps
   eagerly and 6 as a CUDA graph from the file on cuDNN's deterministic
   algorithms (losses finite, graph against eager within 1e-5), ms a
   step. 11c a ResNet-18 at ImageNet widths exported by torch's
   TorchScript exporter (sonnx.interop), imported on the card against
   torch's forward within ONNX_TOL. NonZero runs eagerly and refuses a
   capture.
12. observe (metrics and spans) on the main paths. 12a phase 5's engine
   (GPT-2-small bf16, 8 slots, page 16, 8 requests of prompt 256, +32)
   with observe on, under torch.profiler: exact K1/K4 counts; requests,
   admissions, tokens, prefills, steps and the TTFT histogram's count
   equal to the run's own; the profiler's `serving.engine_prefill` and
   `serving.engine_step` ranges as many as the span histogram counts;
   the exposition parsed line by line; then the run with observe on and
   off in three same-call turns (wall ms, tokens/s; printed only). 12b
   the bench GPT step as a CUDA graph at Device.SetVerbosity(1),
   SetSkipIteration(1), 6 steps: singa_steps_total and `model.step` 6,
   exactly 8 + 8 K1/K2a a step, 5 fenced step times, the singa_hbm_*
   gauges from the caching allocator, PrintTimeProfiling; then the
   replayed step with observe on and off in turns. 12c mlp/native.py,
   hfl/fedavg.py (two client processes), qabot/qabot_train.py and
   cnn/train_cnn.py --dist --dist-option sparseTopK (mnist's synthetic
   set), unmodified, through tests/test_torch_examples.py's alias runner on
   the card, each within its own time limit and printing its last line
   of work (model_selection/ms_mlp.py needs scikit-learn, which the
   card's host lacks).
13. slo, health and fault injection on the main paths. 13a slo's A/B
   on a ServingEngine (GPT-2-small bf16, 8 slots, page 16,
   steps_per_sync 2): `prewarm` over the workload's prompt lengths, an
   SLOTracker (TTFT p99 0.25 s, availability 0.9, windows 2 s / 20 s,
   burn threshold 2, sustain 2, min_requests 5, evaluated every 0.1 s),
   `serving.poisson_workload(seed=7, 16 requests, 6 rps, prompts 64-256,
   +16-64)` plus one long anchor request; the clean arm at 100%
   ttft_p99 attainment with no breach, the degraded arm (a FaultPlan
   delay of 0.4 s on every "serving.engine_step") breaching within
   sustain + 3 burning evaluations with a KIND_SLO anomaly on the active
   monitor; in both the request trace passes `slo._check_flow_trace`
   and the chosen request's syncs lie inside the `serving.engine_step`
   spans; exact K1/K4 counts against the engine's own prefills and
   steps; a clean p99 TTFT above half the target scales the target and
   the delay by one printed factor. 13b GPT.generate greedy (b8, prompt
   256, +32, bf16) with a tracker installed and observe off: one
   `note_decode`, 8 records, exact K1/K3, no non-finite logit booked;
   then observe on and +inf in one element of the output head:
   `singa_health_nan_logits_total{kind="greedy"}` equal to a plain
   recount. 13c the bench GPT step as a CUDA graph with
   `compile(health=HealthMonitor("skip_step"))`, 6 steps: finite stats,
   grad_norm and the group norms within 1e-2 of the eager health steps,
   8 + 8 K1/K2a a step; +inf in a block weight between replays: the
   replay reports the anomaly and keeps every parameter, slot and the
   step counter bitwise; restored, the next step is clean and steps the
   counter; the replayed step with health off, warn and skip_step in
   same-call turns (median of 15 each); halt raising HealthError with a
   bundle that `load_flight_bundle` reads.
14. watchdog, memory and goodput on the main paths. 14a 13a's engine
   after its prewarm under a calibrated watchdog (action "abort", floor
   0.25 s) and a warn monitor: the Poisson workload clean (no breach,
   a calibrated `decode` deadline, printed); a fresh engine with a
   FaultPlan delay of (abort_at + 1) x that deadline on its first sync
   and the workload submitted at once: warn, dump and abort, the hang
   bundle's wedged thread the engine's inside the fault point's delay,
   HangError ending the loop with every request evicted (the error in
   each detail), a KIND_HANG anomaly; a fresh engine clean again; exact
   K1/K4 counts in all three. 14b 13c's bench GPT step as a CUDA graph
   (health warn) under a static 0.02 s step deadline installed before
   the first call: the warm-up and the capture tainted by model.build,
   no breach; the diagnostic wgmma_probe library deleted and rebuilt by
   `_build.lib` inside a step guard: tainted by its introspect.build
   span, its time in goodput's `compile`; then at a 0.3 s deadline a
   torch.cuda._sleep stall of (abort_at + 1) x the deadline before a
   replay: HangError from the step, the wedged thread this one inside
   the stats read; the next replay clean (8 + 8 K1/K2a); the replayed
   step with the watchdog off and on in same-call turns. 14c the memory
   ledger on the card (memory_allocated as the total) with its
   LeakDetector over 30 graph steps of 13c's step: every snapshot
   reconciled, params / opt_state / flight_snapshot exact, build count
   1, no leak; a 64 MB tensor kept a step flagged within 20 steps as
   `unattributed`; the engine's kv_cache equal to its pools and to
   `slo.fleet_serve_snapshot`; `estimate_fit` with the card's limit;
   last a real OOM (an eager fp32 step at a batch whose logits exceed
   the free memory) leaving a bundle `load_flight_bundle` reads, the
   model's parameters among its top arrays, then a normal step. 14d
   goodput over `fit` of the bench GPT as a graph with health
   skip_step: a clean epoch of 12 batches, then one with four 0.05 s
   "data.next" delays and a poisoned step, a checkpoint and an eval
   call: compile at least the first call's build, data_wait at least
   0.2 s and within [the delayed fetches' spans, those + the clean
   epoch's data_wait], health_skip exactly the poisoned
   step, checkpoint and eval above 0, the buckets equal to the wall
   time within 1% with no overlap.
15. introspect and the supervised training loop. 15a introspect on 13c's
   bench GPT graph step (observe on, an EventLog and capture_hlo in a
   temporary directory, verbosity 1): the first three calls give one
   `compile` record for `step` (trace > 0, lower 0.0, compile = the
   capture > 0), an op listing naming 8 flash_fwd and 8 flash_bwd_fused
   launches and a .dot of the graph; the counted flops within 1% of the
   shape count (matmuls x 3 + K1's and K2a's formulas), the bytes above
   the states'; MFU in (0, 100] against the H100 SXM peak and
   PrintTimeProfiling's GFLOP and MFU lines; ten more calls write only
   `step` records (8 + 8 K1/K2a a replay); the replayed step with the
   MFU callback set and cleared in same-call turns (printed);
   estimate_fit from the executable beside a replayed step's peak; one
   call at batch 12: one batch_bucket recompile "arg `arg0` batch 8->12
   crossed bucket 8->16"; an eval build; flight and hang bundles
   carrying the step build; GPT-2-small bf16 generate b8 (prompt 128,
   +32) twice: one serving.prefill and one serving.decode_scan build;
   13a's engine: serving.engine_prefill and serving.engine_step builds;
   K1/K3/K4 exact. 15b fit_resilient on the bench GPT cut to 4 layers
   (FR_GPT; 8 seeded batches, a save every 4 steps, keep 2, async) under
   a failing first save and a failing step 6: completed, one retry, one
   restart from step 4 replaying without stepping, step_4 and step_8
   manifested and valid, 10 model calls of 4 + 4 K1/K2a, the losses
   within 2e-2 of a plain run; then a second controller with a static
   0.3 s step deadline (abort) and a 0.9 s stall at step 5: HangError, a
   hang_restart from step 4, the hang report cleared, completed. 15c
   8c's fp32 GPT preempted by a real SIGTERM at step 5 (manifest status
   "preempt"), resumed by a fresh model at step 5, its losses within
   1e-5 of an uninterrupted run's. Every checkpoint lies in a temporary
   directory, deleted at the end of its part.
16. Data parallelism on the card, NCCL at world size 1 (the host has one
   card, and NCCL takes one rank a device). 16a `distributed.init()`
   from SINGA_COORDINATOR (a free localhost port), SINGA_NPROCS=1,
   SINGA_PROC_ID=0: every verb of `parallel.Communicator` on random CUDA
   tensors in fp32 and bf16 against its plain math, exact at one rank
   (half: x.bfloat16(); top-K and threshold: out + residual == x
   bitwise), each verb's device time at a 64 MB payload. 16b the bench
   GPT (b8 x 1024, bf16 amp) as a CUDA graph under DistOpt with each
   strategy (plain, half, partial over 4 partitions, top-K 0.05,
   threshold): 8 + 8 K1/K2a exactly a replay; each build's op listing
   (capture_hlo) holds one all-reduce per parameter and the loss's mean
   (plain, half), one per parameter of the tag's partition in each of 4
   builds (partial), two all-gathers per parameter and no dense
   all-reduce (sparse); plain's losses within 2e-2 of the model without
   DistOpt, the NCCL kernels of a replay counted (printed only); each
   strategy's replayed step beside the plain graph step's; then 8's
   fp32 GPT, plain DistOpt against none, within 1e-5. 16c ResNet-50
   b32 bf16 as a graph through Classifier.train_one_batch with plain and
   sparseTopK on cuDNN's deterministic algorithms: finite losses,
   plain's states and sparseTopK's first running statistics within 1e-5
   of the run without DistOpt. 16d skip_step under DistOpt plain on 16b's
   step: a poisoned weight keeps every parameter, slot and the counter
   bitwise. 16e fit_resilient of 15c's fp32 GPT under DistOpt top-K with
   sparse_residuals=True: the manifest's mesh {"data": 1}, 1-row
   residual stacks in res.npz, a fresh model resumed within 1e-5. 16f
   the per-rank random stream (a multi-rank step's, forced at one rank)
   under a CUDA graph: a dropout layer's masks over 4 steps equal, bitwise,
   those of the same model stepped eagerly, differ from step to step and
   from the shared stream's. `distributed.shutdown()` ends the phase.
17. Tensor and vocab parallelism, NCCL at world size 1 on a {data 1,
   tp 1} mesh (the collectives run through the groups). 17a the bench
   GPT (b8 x 1024, bf16 amp, graph mode) built with tp_axis="tp" under
   DistOpt(SGD) on "data": 8 + 8 K1/K2a exactly a replay, the build's op
   listing holds 4 tp all-reduces a layer beside DistOpt's one a
   parameter and the loss's mean, the capture issues all 4 a layer (the
   backward's 2 too) on its capturing stream, losses within 2e-2 of the
   same weights without TP, the replayed step beside the no-TP step's in
   turns. 17b
   the fp32 vocab-parallel GPT (dim 512, 2 layers, S 256, vocab 8000
   padded to 8064, the head tied) on the mesh against the same model off
   it (the serial path): losses and gathered parameters within 1e-5;
   with vocab_tp_return_logits=False the (B, S) int32 argmax equals the
   serial argmax. 17c `parallel.tp_mlp` through NCCL against the dense
   MLP in fp32 within 1e-5.
18. Sequence and expert parallelism, NCCL at world size 1. 18a the
   bench GPT (b8 x 1024, bf16 amp, graph mode) built with seq_axis="sp"
   under DistOpt(SGD) on a {data 1, sp 1} mesh: exactly 8 + 8 K1/K2a a
   replay (the one-hop ring: one causal K1 a layer), no P2P call, losses
   within 2e-2 of the same weights without seq_axis (bitwise equality
   printed), the replayed step beside the other's in turns. 18b the
   loopback ring (every rank of an n-rank ring in one process) on the
   kernels: causal (1, 16, 16384, 128) over n 4 (K2a a hop), causal
   (1, 16, 32768, 128) over n 2 (K2b + K2c a hop), non-causal (1, 16,
   16384, 128) over n 4, and fp32 (1, 16, 4096, 128) causal over n 4:
   exactly n (n + 1) / 2 hops of each kernel causal, n^2 not; the
   output and dq, dk, dv against the whole sequence's kernels within
   phase 2's tolerances (the first case also against the ring on the
   plain versions); the ring's device ms beside the whole sequence's.
   18c phase 8's fp32 GPT with seq_axis on the mesh against its serial
   path, learned positions and RoPE, within 1e-5. 18d the MoE-GPT
   (phase 9's) with ep_axis="ep" under DistOpt(SGD, axis=("data",
   "ep")) on {data 1, ep 1}: exactly 12 + 12 K1/K2a a replay, the
   build's listing two all-to-alls a MoE layer forward and two backward,
   losses within 2e-2 of the same weights without ep_axis, each step
   from the other model's parameters (free-running, K2a's atomics and
   the routes they flip part the two: printed); then phase 9b's fp32
   MoE-GPT at ep 1 against its serial path within 1e-5.
19. Pipeline parallelism, NCCL at world size 1. 19a the bench-width
   PipelinedGPT (BENCH_GPT's widths, b8 x 1024, bf16 amp, graph mode)
   under DistOpt(SGD) on a {data 1, pp 1} mesh at n_micro 4, on gpipe
   and on 1f1b, against the same weights off the mesh (the serial layer
   loop), in turns: both replay as CUDA graphs, exactly 32 K1 and 32 K2a
   a gpipe replay and 64 K1 (the remat) and 32 K2a a 1f1b replay, no
   P2P call, the replayed steps' median ms in turns; then two steps
   from one state (the serial model's parameters, momentum zeroed), each
   on a batch no model has seen: losses within 2e-5 of the serial
   model's and the parameter change within 1e-4 (gpipe) and 1e-2 (1f1b)
   of its, relative L2 (the free-running difference printed). 19b the
   loopback pipeline (4
   stages in one process, 8 microbatches) on the kernels: gpipe, 1f1b
   and interleave 2 against the serial layer loop at the bench width in
   bf16 (8 layers; outputs within 2e-2, the stacks' and input's
   gradients within 3e-2 of max|ref|) and at SP_FP32's widths over 5
   layers in fp32 (2e-4 and 2e-3); exact launch counts; the peak memory
   of 1f1b against gpipe.
20. Multi-replica serving (router, fleet, diag). 20a GPT-2-small bf16 in
   two ServingEngines (8 slots, page 16) behind two ReplicaControls and
   one Router in this process: 16 seeded requests routed, exactly 12 K1
   a prefill and 12 K4 a step of the engines' own counts; 16 more with
   one replica drained while they run (nothing lost or evicted, every
   handed-back request completed on the other); /routerz?json=1 and
   /metrics of the diag server against Router.snapshot(); routed TTFT
   and tokens/s beside one direct engine's (printed). 20b one replica
   process (`spawn_replica`, dim 512, 2 layers, vocab 50257, fp32): it
   holds the card's device file and nvidia-smi counts it, and a routed
   request's tokens equal the same seeded model's in this process; a
   head width the kernels do not take raises. 20c the kill-and-replace
   A/B (`router.main(["--ab", ...])`, 2 replicas, 16 requests at 8/s,
   up to 64 new tokens): every field of its record, and where the kill
   arm's tokens part from the clean arm's, a tie (the clean arm's top-2
   gap below TIE_GAP,
   teacher-forced on the same model here). 20d the fleet straggler A/B
   (`fleet.main(["--ab", ...])`, 3 workers training on the card): its
   record's `ok`.
21. The SLO and hang A/Bs and the capacity and audit observatories, each
   through its command line on the card (AB_MODEL: dim 512, 2 layers,
   vocab 50257, fp32) with its record's `ok`. 21a `slo.main(["--ab",
   ...])`: the clean leg at 100% attainment, the degraded leg breached
   within sustain + 3 evaluations, health warn, the trace's flow linked;
   K1 and K4 (only) launched over it. 21b `watchdog.main(["--ab", ...])`:
   three worker processes training on the card, one wedged in its
   collective, aborted, restored and completed with every peer restored
   too, /fleetz marking and then clearing it, the loss curves within
   1e-4. 21c `capacity.main(["--ab", ...])`: scale-up within 5 polls of
   sustained burn, scale-down on the cooldown leg, at most one direction
   change a leg, a ledger with every decision and a score; K1 and K4
   (only) launched over it. 21d one fingerprint tick's time at REPLICA's
   widths, its checksums equal to the CPU's for the same weights, a
   corruption moving only its layer group and changing served tokens;
   then `audit.main(["--ab", ...])` over three replica processes: zero
   lost, zero false positives on the clean arm (strict token
   comparison), the victim quarantined by the fingerprint and one more
   leg within the probe budget, the cap not hit.
22. The `kernels` JSON line (the decode kernels with a `modes` entry per
   cache mode and ladder; `launches_by_path` adds `moe_train`,
   `moe_generate`, `moe_engine`, `onnx_export`, `observe_engine`,
   `observe_train`, `slo_clean`, `slo_degraded`, `slo_generate`,
   `health_train`, `wd_clean`, `wd_aborted`, `wd_fresh`, `wd_train`,
   `mem_train`, `mem_engine`, `goodput_fit`, `introspect_first`,
   `introspect_replays`, `introspect_generate`, `introspect_engine`,
   `fit_resilient`, `hang_restart`, `preempt_resume`, `dp_train`,
   `tp_train`, `sp_train`, `ring_loopback`, `ep_train`, `pp_train`,
   `pp_loopback`, `router_engines`, `router_drain`, `slo_ab` and
   `capacity_ab`), then the card line, then the result line.

Needs one CUDA card; with none it prints no result and exits 1.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import weakref

import numpy as np

# tolerances of a kernel against its plain version on the same inputs:
# fp32 differs by summation order only; a bf16 kernel rounds O to bf16
# (held against the plain version evaluated in fp32 on the same values)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# flash backward against flash_bwd_reference, dq/dk/dv each: fp32 max abs
# error (the JAX package's flash-grad tolerance); bf16 max abs error over
# max |ref| (the pre-scaled q and the outputs round to bf16; the fused
# kernel's atomic dQ sums also change order from run to run)
BWD_TOL = {"float32": 2e-3, "bfloat16": 3e-2}
# fp32 teacher-forced GPT-2-small logits, kernels against plain versions
LOGIT_TOL = 1e-3
# fp32 training on the card against the CPU: relative loss, absolute param
TRAIN_TOL = 1e-4
HBM_BYTES_S = 3.35e12                  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,      # dense tensor cores
              "float32": 67e12}        # fp32 outside the tensor cores
GPT2_SMALL = dict(vocab_size=50257, max_seq=1024, dim=768, num_heads=12,
                  num_layers=12, attn_bias=True)
# the repo's GPT training benchmark (bench.py): ~436 M parameters, D = 128
BENCH_GPT = dict(vocab_size=8192, max_seq=1024, dim=2048, num_heads=16,
                 num_layers=8)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 5
LONG_S, LONG_LAYERS = 16384, 2
SEED = 0
DEVICE = "cuda"
REPLACES = {
    "flash_decode": "singa_tpu/ops/attention.py:1237 _flash_decode_kernel",
    "paged_attention": "singa_tpu/ops/attention.py:1019 _paged_fwd_kernel"}
# sources whose kernels must build without register spills
NO_SPILL = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv",
            "flash_decode", "paged_attention")
# bf16 times (ms) of the CUDA-core design (fp32 products from shared
# memory) that the tensor-core K1 and K2a replaced, by (kernel, shape),
# as this script's phase 2 took them before it timed device work (CUDA
# events around the call) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md's
# kernel table). Printed for reference only: not measured in this run.
CUDA_CORE_EVENTS_MS = {("flash_fwd", (8, 12, 128, 64)): 0.0410,
           ("flash_fwd", (8, 16, 1024, 128)): 2.2700,
           ("flash_bwd_fused", (8, 16, 1024, 128)): 4.3216}
# the tensor-core kernels, which the training step's profile must show
TC_KERNELS = ("flash_fwd_kernel_tc", "flash_bwd_fused_tc_kernel")
# and those the long-context step's profile must show (the split backward)
LONG_TC_KERNELS = ("flash_fwd_kernel_tc", "flash_bwd_dq_tc_kernel",
                   "flash_bwd_dkv_tc_kernel")
# SM cycles a second at the H100's boost clock: sizes time_ms's GPU sleep
SM_HZ = 1.98e9
# --ab: the flash shapes timed for two checkouts, and the decode modes
# (cache mode, q_tokens) at phase 2's decode shape
AB_FWD = ((8, 12, 128, 64), (1, 12, 16, 64), (8, 16, 1024, 128))
AB_BWD = (8, 16, 1024, 128)
AB_LONG = (1, 16, 16384, 128)   # the split pair K2b + K2c
AB_DECODE = (("fp", 1), ("int8", 1), ("int4", 5))


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def host_ms(torch, fn, n=5):
    """Median host ms to issue `fn` (until its call returns, the device's
    work not waited for) over n calls, each after a synchronize."""
    host_s = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(host_s) * 1e3


def time_ms(torch, fn, n=25, warm=3, device=True):
    """Median device ms of `fn` over n calls, CUDA events around each.
    Each call is queued behind a GPU sleep of three times the host's
    median issue time (`host_ms`, five samples), so the events time the
    device's work and not the host's launch overhead, which at small
    shapes is the larger of the two. device=False leaves out the sleep:
    the events then also time the host's launch path."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    issue_s = host_ms(torch, fn) / 1e3 if device else 0.0
    cycles = int(max(1e-4, 3 * issue_s) * SM_HZ)
    evs = []
    for _ in range(n):
        if device:
            torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def bound_ms(nbytes, flops, dtype):
    tb, tf = nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype]
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
def phase_env(torch, build):
    print("== phase 1: environment")
    print(f"card: {card_line()}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, nvcc: {nvcc.splitlines()[-1]}")
    print(f"device: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({len(build.SOURCES)} sources, parallel nvcc); per source: "
          + ", ".join(f"{n} {t:.2f} s"
                      for n, t in build.BUILD_SECONDS.items()))
    from singa_tpu_torch import native
    t0 = time.perf_counter()
    native.recordio()
    native.snapshot()
    print(f"native host libraries (g++: recordio.cc, snapshot.cc): "
          f"{time.perf_counter() - t0:.2f} s")
    spills = []
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
            if (name in NO_SPILL and "spill stores" in line
                    and not line.strip().startswith("0 bytes stack frame, "
                                                    "0 bytes spill")):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        fail("kernels spill registers: " + "; ".join(spills))


def _case(torch, rows, name, route_src, replaces, dtype, shape, out, ref,
          plain_fn, kernel_fn, library_fn, nbytes, flops, err=None,
          tol=None, extra=None):
    """One kernel case: its error against the plain version (`err`, or
    out against ref) within `tol` (default TOL), its time, the plain
    version's, the library call's and the bound; appended to `rows`
    with the `extra` keys."""
    if err is None:
        err = float((out.float() - ref.float()).abs().max())
    tol = TOL[dtype] if tol is None else tol
    extra = extra or {}
    ms = time_ms(torch, kernel_fn)
    plain_ms = time_ms(torch, plain_fn)
    lib_ms = time_ms(torch, library_fn) if library_fn else None
    b_ms, b_by = bound_ms(nbytes, flops, dtype)
    ok = err <= tol and np.isfinite(err)
    label = f" [{extra['label']}]" if "label" in extra else ""
    if name == "flash_fwd":
        extra = dict(extra, **_rates(name, dtype, shape, ms, b_ms, flops))
    print(f"  {name}{label} {dtype} {shape}: max_abs_err {err:.3e} (tol "
          f"{tol}) {'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
          f"{'%.4f ms' % lib_ms if lib_ms is not None else 'none'}"
          + _rates_text(extra, name, dtype, shape))
    rows.append(dict(name=name, route="cuda", source=route_src,
                     replaces=replaces, dtype=dtype, shape=shape,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                     **extra))
    if not ok:
        fail(f"{name}{label} {dtype} {shape} disagrees with its plain "
             "version")


def _rates(name, dtype, shape, ms, b_ms, flops):
    """A flash kernel's achieved TFLOP/s and bound / time."""
    return dict(tflops=flops / ms / 1e9, bound_frac=b_ms / ms)


def _rates_text(r, name, dtype, shape):
    """The rates as text and, where the replaced CUDA-core design was
    timed at this shape, that time, marked with its timer (not measured in
    this run)."""
    if "tflops" not in r:
        return ""
    prev = (CUDA_CORE_EVENTS_MS.get((name, tuple(shape)))
            if dtype == "bfloat16" else None)
    prev = (f"; the CUDA-core kernel it replaced {prev:.4f} ms (events "
            "around the call, not this run)" if prev is not None else "")
    return (f"; {r['tflops']:.1f} TFLOP/s, bound / time "
            f"{r['bound_frac']:.3f}{prev}")


def phase_kernels(torch, A):
    """Each kernel against its plain version at the slice's shapes."""
    import torch.nn.functional as F
    print("== phase 2: kernels against their plain versions")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    # K1: flash-attention forward, causal, D=64, the prefill shapes
    for B, S in ((1, 16), (1, 128), (1, 1023), (8, 128)):
        H, D = 12, 64
        for dn, dt in dts.items():
            q, k, v = (torch.randn((B, H, S, D), generator=g, device=dev)
                       .to(dt) for _ in range(3))
            out = A.flash_attention(q, k, v, True)
            torch.cuda.synchronize()
            ref = A.attention_reference(q.float(), k.float(), v.float(),
                                        True)
            el = q.element_size()
            _case(torch, rows, "flash_fwd",
                  "singa_tpu_torch/csrc/flash_fwd.cu",
                  "singa_tpu/ops/attention.py:112 _flash_fwd_kernel", dn,
                  [B, H, S, D], out, ref,
                  lambda: A.attention_reference(q, k, v, True),
                  lambda: A.flash_attention(q, k, v, True),
                  lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True),
                  4 * B * H * S * D * el + 4 * B * H * S,
                  4 * B * H * D * S * (S + 1) / 2)
    # K3 / K4: decode at N=8 slots, Hp=6, Q=2, PD=128, T=1024
    N, Hp, Q, PD, T, ps, n_pages = 8, 6, 2, 128, 1024, 16, 512
    lens_l = [1, 17, 512, 1024, 100, 333, 777, 64]
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    M = T // ps
    perm = torch.randperm(n_pages, generator=g, device=dev)
    pt = perm[:N * M].reshape(N, M).to(torch.int32).contiguous()
    live = sum(lens_l)
    pages_live = sum(-(-n // ps) for n in lens_l)
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None,
                                                                  None, :]
    for dn, dt in dts.items():
        el = torch.tensor([], dtype=dt).element_size()
        q = torch.randn((N, Hp, Q, PD), generator=g, device=dev).to(dt)
        K, V = (torch.randn((N, Hp, T, PD), generator=g, device=dev).to(dt)
                for _ in range(2))
        out = A.flash_decode(q, K, V, lens, scale=0.125)
        torch.cuda.synchronize()
        ref = A.flash_decode_reference(q.float(), K.float(), V.float(),
                                       lens, 0.125)
        io_bytes = 2 * N * Hp * Q * PD * el + 4 * N
        flops = 4 * Hp * Q * PD * live
        _case(torch, rows, "flash_decode",
              "singa_tpu_torch/csrc/flash_decode.cu",
              REPLACES["flash_decode"], dn,
              [N, Hp, Q, PD, T], out, ref,
              lambda: A.flash_decode(q, K, V, lens, 0.125, use_kernel=False),
              lambda: A.flash_decode(q, K, V, lens, 0.125),
              lambda: F.scaled_dot_product_attention(q, K, V, attn_mask=mask,
                                                     scale=0.125),
              io_bytes + 2 * live * Hp * PD * el, flops)
        kp, vp = (torch.randn((n_pages, Hp, ps, PD), generator=g,
                              device=dev).to(dt) for _ in range(2))
        out = A.paged_attention(q, kp, vp, pt, lens, ps, scale=0.125)
        torch.cuda.synchronize()
        ref = A.paged_attention_reference(q.float(), kp.float(), vp.float(),
                                          pt, lens, ps, 0.125)
        _case(torch, rows, "paged_attention",
              "singa_tpu_torch/csrc/paged_attention.cu",
              REPLACES["paged_attention"], dn,
              [N, Hp, Q, PD, ps, n_pages], out, ref,
              lambda: A.paged_attention(q, kp, vp, pt, lens, ps, 0.125,
                                        use_kernel=False),
              lambda: A.paged_attention(q, kp, vp, pt, lens, ps, 0.125),
              None,
              io_bytes + 2 * live * Hp * PD * el + 4 * pages_live, flops)
    phase_decode_modes(torch, A, rows, g)
    # K1 at the training shapes (bench GPT, D=128; the MoE GPT at
    # GPT-2-small's width, D=64), and at D=128 with a ragged S (partial q
    # and key tiles of the tensor-core kernel)
    for B, H, S, D in ((TRAIN_B, 16, TRAIN_S, 128), (TRAIN_B, 12, TRAIN_S, 64),
                       (1, 2, 300, 128)):
        q, k, v = (torch.randn((B, H, S, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        out = A.flash_attention(q, k, v, True)
        torch.cuda.synchronize()
        ref = A.attention_reference(q.float(), k.float(), v.float(), True)
        _case(torch, rows, "flash_fwd", "singa_tpu_torch/csrc/flash_fwd.cu",
              "singa_tpu/ops/attention.py:112 _flash_fwd_kernel",
              "bfloat16", [B, H, S, D], out, ref,
              lambda: A.attention_reference(q, k, v, True),
              lambda: A.flash_attention(q, k, v, True),
              lambda: F.scaled_dot_product_attention(q, k, v,
                                                     is_causal=True),
              4 * B * H * S * D * 2 + 4 * B * H * S,
              4 * B * H * D * S * (S + 1) / 2)
        del q, k, v, out, ref
    # K2a / K2b / K2c: the backward, both routes, at the training shapes
    # and, in bf16, at ragged S (rows and keys past S in the tensor-core
    # tiles) and without the causal mask
    for shape, dn in (((TRAIN_B, 16, TRAIN_S, 128), "bfloat16"),
                      ((TRAIN_B, 12, TRAIN_S, 64), "bfloat16"),
                      ((1, 16, TRAIN_S, 128), "float32"),
                      ((1, 16, 4096, 128), "bfloat16"),
                      ((1, 2, 1023, 128), "bfloat16"),
                      ((1, 3, 100, 64), "bfloat16")):
        bwd_case(torch, A, rows, g, shape, dn)
    for shape in ((1, 2, 1023, 128), (1, 3, 100, 64)):
        bwd_case(torch, A, rows, g, shape, "bfloat16", causal=False)
    return rows


def _bwd_bound(shape, el, n_products, n_out, causal=True):
    """(bound ms, by, flops) of a backward kernel: it reads q, k, v, dO and
    the two fp32 row statistics once, writes n_out (B, H, S, D) tensors,
    and does n_products score-sized products over the (causal) pairs."""
    B, H, S, D = shape
    pairs = B * H * (S * (S + 1) / 2 if causal else S * S)
    nbytes = (4 + n_out) * B * H * S * D * el + 2 * B * H * S * 4
    flops = n_products * 2 * D * pairs
    return (*bound_ms(nbytes, flops, "bfloat16" if el == 2 else "float32"),
            flops)


def bwd_case(torch, A, rows, g, shape, dn, routes=("fused", "split"),
             n=10, n_plain=5, causal=True):
    """The flash backward at one shape: each route of the dispatch (forced
    through _FUSED_DQ_BYTES_CAP, as the JAX package's test forces it)
    against flash_bwd_reference on the same q, k, v, O, lse and dO; the
    split route run twice must give bitwise-equal dq, dk and dv (it has no
    atomics), and in bf16 its dk and dv must equal the fused route's bit for
    bit (K2c is K2a's body without the dQ branch). Then the kernels' times,
    the plain version's, the bounds and SDPA's backward (forward + backward
    less forward), the one library call for the whole backward, which the
    split rows carry too; with both routes, which is faster."""
    import torch.nn.functional as F
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dn]
    dev = torch.device("cuda")
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = A._flash_fwd(q, k, v, causal, scale)
    ref = A.flash_bwd_reference(q, k, v, o, lse, do, causal, scale)
    tol = BWD_TOL[dn]
    errs, grads = {}, {}
    cap = A._FUSED_DQ_BYTES_CAP
    what = f"{dn} {list(shape)}{'' if causal else ' non-causal'}"
    try:
        for route in routes:
            A._FUSED_DQ_BYTES_CAP = (1 << 60) if route == "fused" else 0
            got = grads[route] = A._flash_bwd(q, k, v, o, lse, do, causal,
                                              scale)
            torch.cuda.synchronize()
            for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                d = float((a.float() - b.float()).abs().max())
                rel = d / float(b.float().abs().max())
                errs[route, name] = (d, rel)
                bad = not (rel if dn == "bfloat16" else d) <= tol
                print(f"  flash_bwd {route} {what} {name}: max abs err "
                      f"{d:.3e}, / max|ref| {rel:.3e} (tol {tol} "
                      f"{'relative' if dn == 'bfloat16' else 'absolute'}) "
                      f"{'FAIL' if bad else 'ok'}")
                if bad:
                    fail(f"flash_bwd {route} {what} {name} disagrees with "
                         "flash_bwd_reference")
            if route == "split":
                again = A._flash_bwd(q, k, v, o, lse, do, causal, scale)
                torch.cuda.synchronize()
                diff = [name for name, a, b in zip(("dq", "dk", "dv"), got,
                                                   again)
                        if not torch.equal(a, b)]
                print(f"  flash_bwd split {what}: two runs bitwise equal "
                      f"{'FAIL ' + str(diff) if diff else 'ok'}")
                if diff:
                    fail(f"flash_bwd split {what}: {diff} differ between "
                         "two runs")
    finally:
        A._FUSED_DQ_BYTES_CAP = cap
    if dn == "bfloat16" and {"fused", "split"} <= grads.keys():
        diff = [name for name, a, b in zip(("dk", "dv"), grads["split"][1:],
                                           grads["fused"][1:])
                if not torch.equal(a, b)]
        print(f"  flash_bwd {what}: split dk, dv bitwise equal to fused "
              f"{'FAIL ' + str(diff) if diff else 'ok'}")
        if diff:
            fail(f"flash_bwd {what}: split {diff} differ from the fused "
                 "route's")
    del grads
    qf, delta = A._bwd_prepare(q, k, v, o, lse, do, scale)
    args = (qf, k, v, do, lse, delta, causal)
    plain_ms = time_ms(torch, lambda: A.flash_bwd_reference(
        q, k, v, o, lse, do, causal, scale), n=n_plain, warm=1)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
    lib_ms = (time_ms(torch, lambda: torch.autograd.grad(
        sdpa(), (ql, kl, vl), do), n=n, warm=2)
        - time_ms(torch, sdpa, n=n, warm=2))
    el = q.element_size()
    kernels = {"fused": [("flash_bwd_fused", "flash_bwd_fused.cu",
                          "351 _flash_bwd_fused_kernel", 5, 3,
                          ("dq", "dk", "dv"),
                          lambda: A._flash_bwd_fused(*args, scale))],
               "split": [("flash_bwd_dq", "flash_bwd_dq.cu",
                          "269 _flash_bwd_dq_kernel", 3, 1, ("dq",),
                          lambda: A._flash_bwd_dq(*args, scale)),
                         ("flash_bwd_dkv", "flash_bwd_dkv.cu",
                          "308 _flash_bwd_dkv_kernel", 4, 2, ("dk", "dv"),
                          lambda: A._flash_bwd_dkv(*args))]}
    route_ms = {}
    for route in routes:
        for name, src, line, n_prod, n_out, outs, fn in kernels[route]:
            ms = time_ms(torch, fn, n=n, warm=2)
            route_ms[route] = route_ms.get(route, 0.0) + ms
            b_ms, b_by, flops = _bwd_bound(shape, el, n_prod, n_out, causal)
            err = max(errs[route, o_][0] for o_ in outs)
            rel = max(errs[route, o_][1] for o_ in outs)
            rates = _rates(name, dn, shape, ms, b_ms, flops)
            print(f"  {name} {what}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms (whole backward), bound {b_ms:.4f} ms "
                  f"({b_by}), library {lib_ms:.4f} ms (SDPA backward, "
                  "whole: dq, dk, dv)"
                  + _rates_text(rates, name, dn, shape))
            rows.append(dict(
                name=name, route="cuda", source=f"singa_tpu_torch/csrc/{src}",
                replaces=f"singa_tpu/ops/attention.py:{line}", dtype=dn,
                shape=list(shape), causal=causal, max_abs_err=err,
                rel_err=rel, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms,
                library_call="SDPA backward, whole (dq, dk, dv)", **rates))
    if "split" in routes:
        ratio = (f" ({route_ms['split'] / lib_ms:.2f}x)" if lib_ms > 0
                 else "")
        print(f"  split pair {what}: K2b + K2c {route_ms['split']:.4f} ms, "
              f"SDPA backward {lib_ms:.4f} ms{ratio}")
    if len(route_ms) == 2:
        fast = min(route_ms, key=route_ms.get)
        print(f"  route {what}: split (K2b + K2c) {route_ms['split']:.4f} "
              f"ms, fused (the K2a call: workspace, kernel, scale-and-cast) "
              f"{route_ms['fused']:.4f} "
              f"ms: {fast} is faster")


# ---------------------------------------------------------------------------
# phase 2, the decode kernels' other branches: quantized caches and the
# verify ladder, at the serving shape (N 8, Hp 6, PD 128, T 1024, page 16)
DEC_N, DEC_HP, DEC_D, DEC_T, DEC_PS = 8, 6, 64, 1024, 16
DEC_LENS = [1, 17, 512, 1024, 100, 333, 777, 64]
# the JAX tests' KERNEL_ATOL for fp32 and quantized caches (the plain
# version dequantizes the same bytes and folds the same scales, so only
# summation order differs); bf16 rounds O to bf16
QTOL = {"float32": 2e-5, "bfloat16": 2e-2}
# each decode kernel at its main path's shape and lengths: (whose steps,
# horizon T, the lengths of its middle and last step). Every row of a step
# has one length. Phase 4's `generate` (8 prompts of 128, +128) keeps a
# dense cache of T = 128 + 128 positions, and its step i < 127 attends
# 128 + i + 1 of them (129..255). Phase 5's engine (8 requests of prompt
# 256, +32, in step) gives each of its 8 slots a table of 64 pages of 16
# (max_ctx 1024), and its steps attend 257..287 positions.
MAIN_DECODE = {"flash_decode": ("generate's", 256, (192, 255)),
               "paged_attention": ("the engine's", 1024, (272, 287))}


def main_decode_label(kernel, mode, n):
    """The phase-2 label of a decode kernel's main-path case."""
    who, T, _ = MAIN_DECODE[kernel]
    where = f"T {T}" if kernel == "flash_decode" else f"{T // DEC_PS} pages"
    return f"{mode} single, {who} step at length {n} ({where})"


def _quantize(torch, A, P, mode):
    """(…, T, P*D) fp32 -> (cache rows, scales (…, T, P) fp32), per
    (position, lane block) as serving._DecodeCore._quant_kv does."""
    from singa_tpu_torch.ops.attention import nibble_pack
    qmax = 7.0 if mode == "int4" else 127.0
    A5 = A.reshape(*A.shape[:-1], P, -1)
    s = torch.clamp(A5.abs().amax(-1), min=1e-8) / qmax
    q = torch.clamp(torch.round(A5 / s[..., None]), -qmax, qmax).to(
        torch.int8).reshape(A.shape)
    if mode == "int4":
        q = nibble_pack(q)
    return q.contiguous(), s.contiguous()


def _paged(torch, C, ps, perm):
    """Dense (n, Hp, T, ·) -> a page pool holding the same rows at the
    pages `perm` gives, in time order per sequence."""
    n, Hp, T, W = C.shape
    pages = C.reshape(n, Hp, T // ps, ps, W).transpose(1, 2) \
        .reshape(n * (T // ps), Hp, ps, W)
    pool = torch.empty_like(pages)
    pool[perm] = pages
    return pool


def _pools_from_dense(torch, caches, ps, g):
    """Dense per-block caches (fp (K, V) or quantized ((K8, Ks), (V8,
    Vs))) -> page pools holding the same rows under one random page
    table."""
    from singa_tpu_torch import serving
    n, _, T, _ = serving.tree_leaves(caches)[0].shape
    perm = torch.randperm(n * (T // ps), generator=g,
                          device=serving.tree_leaves(caches)[0].device)
    pools = serving._tree_map(lambda a: _paged(torch, a, ps, perm), caches)
    return pools, perm.reshape(n, T // ps).to(torch.int32).contiguous()


def decode_case(torch, A, rows, g, kernel, mode, dn, q_tokens, P=2, G=1,
                lens_l=DEC_LENS, label="", T=DEC_T, D=DEC_D, ps=DEC_PS):
    """One K3/K4 variant against its plain version on the card: `mode`
    fp/int8/int4 caches, `q_tokens` (> 1: the verify ladder), P*G rows a
    token, P*D lanes, T positions (paged: T / ps pages of ps a
    sequence). Rows whose ladder limit is <= 0 (an inactive slot) are left
    out of the comparison: the kernel writes finite values there, the
    plain version NaN, and the caller discards both."""
    import torch.nn.functional as F
    dev = torch.device(DEVICE)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dn]
    N, Hp = DEC_N, DEC_HP
    PD, Q = P * D, q_tokens * P * G
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    q = torch.randn((N, Hp, Q, PD), generator=g, device=dev).to(dt)
    Kf, Vf = (torch.randn((N, Hp, T, PD), generator=g, device=dev)
              for _ in range(2))
    if mode == "fp":
        K, V, ks, vs = Kf.to(dt), Vf.to(dt), None, None
    else:
        (K, ks), (V, vs) = _quantize(torch, Kf, P, mode), \
            _quantize(torch, Vf, P, mode)
    ops = [K, V, ks, vs]
    if kernel == "paged_attention":
        M = T // ps
        perm = torch.randperm(N * M, generator=g, device=dev)
        ops = [None if a is None else _paged(torch, a, ps, perm)
               for a in ops]
        pt = perm.reshape(N, M).to(torch.int32).contiguous()

        def call(qq, cache, uk):
            return A.paged_attention(qq, cache[0], cache[1], pt, lens, ps,
                                     0.125, cache[2], cache[3], G,
                                     use_kernel=uk, q_tokens=q_tokens)
    else:
        def call(qq, cache, uk):
            return A.flash_decode(qq, cache[0], cache[1], lens, 0.125,
                                  cache[2], cache[3], G, use_kernel=uk,
                                  q_tokens=q_tokens)
    out = call(q, ops, None)
    torch.cuda.synchronize()
    # the plain version in fp32 on the same values
    ref = call(q.float(), [a.float() if a is not None and mode == "fp"
                           else a for a in ops], False)
    lim = A._row_limits(lens, Q, Q // q_tokens, q_tokens)      # (N, Q)
    live = lim > 0
    err = float((out.float() - ref).abs()[live[:, None, :, None]
                                          .expand_as(ref)].max())
    tol = QTOL[dn] if (mode != "fp" or q_tokens > 1 or dn == "bfloat16") \
        else TOL[dn]
    el = q.element_size()
    W = K.shape[-1]
    kv_el = K.element_size()
    rows_live = [min(n, T) for n in lens_l]
    pos = int(torch.clamp(lim, 0, T).sum())
    nbytes = (2 * N * Hp * Q * PD * el + 4 * N
              + 2 * Hp * sum(rows_live) * (W * kv_el
                                           + (0 if mode == "fp" else 4 * P)))
    if kernel == "paged_attention":
        nbytes += 4 * sum(-(-n // ps) for n in rows_live)
    library = None
    if kernel == "flash_decode" and mode == "fp":
        mask = (torch.arange(T, device=dev)[None, None, :]
                < lim[:, :, None])[:, None]                   # (N,1,Q,T)

        def library():
            return F.scaled_dot_product_attention(q, K, V, attn_mask=mask,
                                                  scale=0.125)
    shape = [N, Hp, Q, PD, T] + ([ps, N * (T // ps)]
                                 if kernel == "paged_attention" else [])
    _case(torch, rows, kernel,
          f"singa_tpu_torch/csrc/{kernel}.cu", REPLACES[kernel], dn, shape,
          None, None, lambda: call(q, ops, False), lambda: call(q, ops, None),
          library, nbytes, 4 * Hp * PD * pos, err=err, tol=tol,
          extra=dict(mode=mode, q_tokens=q_tokens, groups=G,
                     label=label or f"{mode} "
                     f"{'ladder' if q_tokens > 1 else 'single'}"))


def phase_decode_modes(torch, A, rows, g):
    """K3 and K4 in every cache mode and the ladder (q_tokens 5, the
    verify step of spec_k = 4) at the serving shape; one GQA ladder case
    past 16 rows; one case with inactive slots under the ladder; the
    largest workspace (Q 64 x PD 256: a 4-token ladder, P 4, G 4); each
    kernel at its main path's own shape and lengths (MAIN_DECODE; bf16, fp
    and int8 single); then the plain-load path (P 1, D 72: rows of 72 int8
    or 36 int4 bytes, no multiple of 16) and, paged, a page size that does
    not divide 64 (48: chunks of lcm(64, 48) = 192 positions)."""
    for kernel in ("flash_decode", "paged_attention"):
        for dn in ("float32", "bfloat16"):
            for mode, qt in (("fp", 5), ("int8", 1), ("int4", 1),
                             ("int8", 5), ("int4", 5)):
                decode_case(torch, A, rows, g, kernel, mode, dn, qt)
        decode_case(torch, A, rows, g, kernel, "int8", "float32", 5, G=2,
                    label="GQA ladder, P 2 G 2, 20 rows")
        decode_case(torch, A, rows, g, kernel, "int4", "float32", 5,
                    lens_l=[1, 3, 512, 1, 100, 2, 777, 64],
                    label="inactive slots under the ladder")
        for dn in ("float32", "bfloat16"):
            decode_case(torch, A, rows, g, kernel, "fp", dn, 4, P=4, G=4,
                        label="Q 64 x PD 256, ladder, P 4 G 4")
        _, T, steps = MAIN_DECODE[kernel]
        for n in steps:
            for mode in ("fp", "int8"):
                decode_case(torch, A, rows, g, kernel, mode, "bfloat16", 1,
                            lens_l=[n] * DEC_N, T=T,
                            label=main_decode_label(kernel, mode, n))
        edge_lens = [1, 17, 512, 1000, 100, 333, 777, 64]
        edge_T = 1000 if kernel == "flash_decode" else DEC_T
        decode_case(torch, A, rows, g, kernel, "int8", "bfloat16", 1, P=1,
                    D=72, T=edge_T, lens_l=edge_lens,
                    label="int8 single, P 1 D 72: 72-byte rows, plain loads")
        decode_case(torch, A, rows, g, kernel, "int4", "float32", 5, P=1,
                    D=72, T=edge_T, lens_l=edge_lens,
                    label="int4 ladder, P 1 D 72: 36-byte rows, plain loads")
        if kernel == "paged_attention":
            for mode, dn, qt in (("fp", "bfloat16", 1),
                                 ("int8", "float32", 5)):
                decode_case(torch, A, rows, g, kernel, mode, dn, qt,
                            T=1056, ps=48, label=f"{mode} "
                            f"{'ladder' if qt > 1 else 'single'}, page 48: "
                            "chunks of 192")


def phase_teacher_forced(torch, model, serving):
    print("== phase 3: GPT-2-small teacher-forced, kernels against plain")
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    n, S0, steps, ps = 4, 128, 64, 16
    prompt = torch.randint(0, model.vocab_size, (n, S0), generator=g,
                           device=dev)
    feed = torch.randint(0, model.vocab_size, (n, steps), generator=g,
                         device=dev)
    core = serving._decode_core(model, S0, steps)

    def dense(p, use_kernel):
        logits, caches = core.prefill(p, prompt, n, use_kernel)
        out = [logits]
        for i in range(steps):
            logits, caches = core.token_step(p, feed[:, i], caches, i, n,
                                             use_kernel)
            out.append(logits)
        return torch.stack(out, 1).float()

    def paged(p, use_kernel):
        _, caches = core.prefill(p, prompt, n, use_kernel)
        pools, pt = _pools_from_dense(
            torch, caches, ps, torch.Generator(device=dev).manual_seed(7))
        active = torch.ones(n, dtype=torch.bool, device=dev)
        out = []
        for i in range(steps):
            lens = torch.full((n,), S0 + i, dtype=torch.int32, device=dev)
            logits, pools = core.paged_token_step(
                p, feed[:, i], pools, pt, lens, active, n, ps, use_kernel)
            out.append(logits)
        return torch.stack(out, 1).float()

    with torch.no_grad():
        p32 = serving.decode_state(model, None)
        dk, dp = dense(p32, None), dense(p32, False)
        pk, pp = paged(p32, None), paged(p32, False)
        torch.cuda.synchronize()
        d_err = float((dk - dp).abs().max())
        p_err = float((pk - pp).abs().max())
        x_err = float((pk - dk[:, 1:]).abs().max())
        print(f"  fp32 dense: max |dlogit| kernel vs plain {d_err:.3e} "
              f"(tol {LOGIT_TOL}), logit range "
              f"[{float(dk.min()):.2f}, {float(dk.max()):.2f}]")
        print(f"  fp32 paged: max |dlogit| kernel vs plain {p_err:.3e} "
              f"(tol {LOGIT_TOL}); paged kernel vs dense kernel "
              f"{x_err:.3e}")
        for what, e in (("dense", d_err), ("paged", p_err),
                        ("paged vs dense", x_err)):
            if not (e <= LOGIT_TOL):
                fail(f"fp32 {what} teacher-forced logits differ by {e}")
        pb = serving.decode_state(model, "bfloat16")
        bk, bp = dense(pb, None), dense(pb, False)
        if not torch.isfinite(bk).all():
            fail("non-finite bf16 logits")
        top1 = float((bk.argmax(-1) == bp.argmax(-1)).float().mean())
        print(f"  bf16 dense: max |dlogit| kernel vs plain "
              f"{float((bk - bp).abs().max()):.3e}, top-1 agreement "
              f"{top1:.4f}; vs fp32 kernel max |dlogit| "
              f"{float((bk - dk).abs().max()):.3e}")


#: phase 4's printed engine-vs-generate comparison: the first requests
#: (one batch-1 `generate` each; all 16 took ~35 s of host time)
ENGINE_VS_GENERATE = 4


def seeded_requests(vocab):
    """The main path's inputs from one numpy seed: the generate batch,
    and 16 engine requests as (prompt, max_new) with prompts of 8-512
    tokens and max_new of 16-128."""
    rng = np.random.RandomState(SEED)
    prompts = rng.randint(0, vocab, (8, 128)).astype(np.int32)
    specs = [(int(rng.randint(8, 513)), int(rng.randint(16, 129)))
             for _ in range(16)]
    reqs_in = [(rng.randint(0, vocab, (s,)).astype(np.int32), mn)
               for s, mn in specs]
    return prompts, reqs_in


def check_launches(path, got, want):
    """Fail unless one path's launch counts are exactly the expected
    ones (a kernel the path runs launches once per layer per call; a
    kernel `want` does not name, zero times)."""
    want = {k: want.get(k, 0) for k in got}
    print(f"  launches on {path}: {got} (expected {want})")
    if got != want:
        fail(f"{path} launched {got}, expected {want}")


def serve(engine, model, reqs_in, timeout_s=600, **kw):
    """One ServingEngine answering `reqs_in`; fails unless every request
    completes with its token count, every page is back on the free
    list and the thread is joined after stop(). Returns (requests, wall
    seconds, report before stop, steps after stop)."""
    eng = engine.ServingEngine(model, page_size=16, max_ctx=1024,
                               steps_per_sync=4, **kw).start()
    t0 = time.perf_counter()
    try:
        reqs = [eng.submit(pr, mn) for pr, mn in reqs_in]
        for r in reqs:
            if not r.wait(timeout_s):
                fail(f"request {r.id} did not finish")
        wall = time.perf_counter() - t0
        rep = eng.report()
        free_ok = sorted(eng._free_pages) == list(range(eng.num_pages))
    finally:
        eng.stop()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("torch-serve") and t.is_alive()]
    bad = [(r.id, r.outcome, len(r.tokens), mn)
           for r, (_, mn) in zip(reqs, reqs_in)
           if r.outcome != "completed" or len(r.tokens) != mn]
    if bad:
        fail(f"requests not completed with their token counts: {bad}")
    if not free_ok or rep["pages_in_use"] != 0:
        fail(f"pages leaked: {rep}")
    if alive or eng.running():
        fail(f"engine thread still alive after stop(): {alive}")
    return reqs, wall, rep, eng.report()["steps"]


def phase_main_path(torch, model, engine, serving, A):
    """The two user entry points, each its own path: every counter is
    reset just before the path runs and read just after it."""
    print("== phase 4: main path (GPT.generate, then ServingEngine), bf16")
    prompts, reqs_in = seeded_requests(model.vocab_size)
    (B, S0), new = prompts.shape, 128
    L = len(model.blocks)
    # warm (cuBLAS handles, the decode-param tree) and time one prefill,
    # all before the counted runs
    model.generate(prompts[:, :8], 2, dtype="bfloat16")
    core = serving._decode_core(model, S0, new)
    p = serving.decode_state(model, "bfloat16")
    pt = torch.as_tensor(prompts.astype(np.int64), device=model.device)
    with torch.no_grad():
        pre_ms = time_ms(torch, lambda: core.prefill(p, pt, B), n=5, warm=1)
    torch.cuda.synchronize()

    A.reset_launches()
    t0 = time.perf_counter()
    out = model.generate(prompts, new, dtype="bfloat16")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen = dict(A.LAUNCHES)
    gen_modes = {k: v for k, v in A.LAUNCHES_BY_MODE.items() if v}
    if out.shape != (B, S0 + new) or not (out >= 0).all() \
            or not (out < model.vocab_size).all():
        fail(f"generate returned {out.shape} / out-of-vocab tokens")
    print(f"  generate: batch {B}, prompt {S0}, {new} new: "
          f"{gen_s:.3f} s, {B * new / gen_s:.1f} tok/s, prefill "
          f"{pre_ms:.3f} ms")
    # one prefill, then new - 1 dense steps
    check_launches("generate", gen, {"flash_fwd": L,
                                     "flash_decode": L * (new - 1),
                                     "paged_attention": 0})

    A.reset_launches()
    reqs, wall, rep, steps = serve(engine, model, reqs_in, max_slots=8,
                                   dtype="bfloat16")
    torch.cuda.synchronize()
    eng = dict(A.LAUNCHES)
    eng_modes = {k: v for k, v in A.LAUNCHES_BY_MODE.items() if v}
    ntok = sum(len(r.tokens) for r in reqs)
    ttft = statistics.median(r.ttft_s for r in reqs)
    print(f"  engine: {len(reqs)} requests completed, {ntok} tokens, "
          f"{wall:.3f} s, {ntok / wall:.1f} tok/s, median TTFT "
          f"{ttft * 1e3:.1f} ms, {steps} steps, pages leaked 0, "
          f"thread joined")
    # one prefill per request, one paged step per engine step
    check_launches("the engine", eng, {"flash_fwd": L * len(reqs),
                                       "flash_decode": 0,
                                       "paged_attention": L * steps})
    # engine tokens against GPT.generate on the same prompts, for the
    # first ENGINE_VS_GENERATE requests (bf16: batch shape and bucket
    # padding change rounding, so print only; phase 4b holds the engine
    # to exact tokens in fp32)
    same_seq = same_tok = n_tok = 0
    picked = list(zip(reqs, reqs_in))[:ENGINE_VS_GENERATE]
    for r, (pr, _) in picked:
        want = model.generate(pr[None, :], r.max_new,
                              dtype="bfloat16")[0, len(pr):]
        got = np.asarray(r.tokens)
        same_seq += int((got == want).all())
        same_tok += int((got == want).sum())
        n_tok += len(got)
    print(f"  engine vs generate (bf16), the first {len(picked)} requests: "
          f"{same_seq}/{len(picked)} sequences identical, {same_tok}/{n_tok}"
          f" tokens at equal positions")
    return ({"generate": gen, "engine": eng},
            {"generate": gen_modes, "engine": eng_modes})


def phase_engine_fp32(torch, model, engine):
    """The engine on the card in fp32, off the counted runs: its greedy
    tokens on the kernels must equal its tokens on the plain versions
    (use_kernel=False) and fp32 GPT.generate's on the same prompts. Four
    slots for six requests make admission reuse slots and pages."""
    print("== phase 4b: ServingEngine fp32 on the card, exact tokens")
    _, reqs_in = seeded_requests(model.vocab_size)
    picks = [(pr, min(mn, 32)) for pr, mn in reqs_in[:6]]
    runs = {}
    for use_kernel in (None, False):
        reqs, wall, _, steps = serve(engine, model, picks, max_slots=4,
                                     use_kernel=use_kernel)
        runs[use_kernel] = [np.asarray(r.tokens) for r in reqs]
        print(f"  engine fp32 use_kernel={use_kernel}: {len(reqs)} "
              f"requests, {sum(len(r.tokens) for r in reqs)} tokens, "
              f"{steps} steps, {wall:.3f} s")
    gen = [model.generate(pr[None, :], mn)[0, len(pr):] for pr, mn in picks]
    bad = []
    for i, (k, pl, g) in enumerate(zip(runs[None], runs[False], gen)):
        for what, other in (("plain", pl), ("generate", g)):
            if not np.array_equal(k, other):
                at = int(np.argmax(k != other))
                bad.append(f"request {i} vs {what}: first differs at "
                           f"{at} ({k[at]} != {other[at]})")
    print(f"  engine fp32 on the kernels vs plain engine and vs fp32 "
          f"generate: {len(picks) * 2 - len(bad)}/{len(picks) * 2} "
          f"sequence pairs identical")
    if bad:
        fail("fp32 engine tokens differ: " + "; ".join(bad))
    return picks, runs[None]


# ---------------------------------------------------------------------------
# phases 3b, 4c and 4d: quantized and speculative serving
SPEC_K = 4
# the small random draft: bench_decode.py's draft width (dim // 4) and
# depth (1 layer); D = 64, so its prefill runs on K1
DRAFT_SMALL = dict(GPT2_SMALL, dim=GPT2_SMALL["dim"] // 4, num_heads=3,
                   num_layers=1)
# fp32 scales of a verify step's cache rows against sequential steps'
CACHE_SCALE_RTOL = 1e-5
# a divergence between two fp32 token streams counts as a tie when the
# reference's top-2 logit gap at that position is below this
TIE_GAP = 1e-4
# beam search on the main path: beams per prompt and new tokens
BEAMS, BEAM_NEW = 4, 32
# 4c's depth: new tokens of each quantized and speculative `generate`
# (cut from 128 to make room for phase 20), and the requests of its
# speculative engine (cut from 16)
QUANT_NEW, SPEC_ENGINE_REQS = 32, 8


def _cache_diff(torch, A, serving, a, b):
    """(values that differ, values compared, the largest difference in
    quantization steps, the largest relative difference of the scales)
    between two quantized caches."""
    n_diff, n_all, steps, rel = 0, 0, 0, 0.0
    for x, y in zip(serving.tree_leaves(a), serving.tree_leaves(b)):
        if x.is_floating_point():
            rel = max(rel, float(((x - y).abs()
                                  / y.abs().clamp(min=1e-30)).max()))
            continue
        if x.dtype == torch.uint8:
            x, y = A.nibble_unpack(x), A.nibble_unpack(y)
        d = (x.float() - y.float()).abs()
        n_diff += int((d > 0).sum())
        n_all += d.numel()
        steps = max(steps, int(d.max()))
    return n_diff, n_all, steps, rel


def phase_quant_teacher_forced(torch, model, serving, A):
    """GPT-2-small fp32 with int8 and int4 caches, teacher-forced: the
    dense and paged steps on the kernels against use_kernel=False, and
    the k = 5 verify steps against 5 sequential steps on the kernels."""
    print("== phase 3b: GPT-2-small fp32, int8/int4 caches, teacher-forced")
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    n, S0, k, ps = 4, 128, SPEC_K + 1, 16
    prompt = torch.randint(0, model.vocab_size, (n, S0), generator=g,
                           device=dev)
    feed = torch.randint(0, model.vocab_size, (n, k), generator=g,
                         device=dev)
    p = serving.decode_state(model, None)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    clone = lambda c: serving._tree_map(torch.clone, c)  # noqa: E731
    with torch.no_grad():
        for kvd in ("int8", "int4"):
            core = serving._decode_core(model, S0, 2 * ps, kv_dtype=kvd)
            _, caches = core.prefill(p, prompt, n)
            pools0, pt = _pools_from_dense(
                torch, caches, ps, torch.Generator(device=dev).manual_seed(7))
            seq, runs = {}, {}
            for uk in (None, False):
                c, pl = clone(caches), clone(pools0)
                out_d, out_p = [], []
                for i in range(k):
                    lg, c = core.token_step(p, feed[:, i], c, i, n, uk)
                    out_d.append(lg)
                    lens = torch.full((n,), S0 + i, dtype=torch.int32,
                                      device=dev)
                    lg, pl = core.paged_token_step(p, feed[:, i], pl, pt,
                                                   lens, active, n, ps, uk)
                    out_p.append(lg)
                runs[uk] = (torch.stack(out_d, 1), torch.stack(out_p, 1))
                seq[uk] = (c, pl)
            vd, cv = core.verify_step(p, feed, clone(caches),
                                      torch.full((n,), S0, dtype=torch.int32,
                                                 device=dev), active, n, k)
            vp, pv = core.paged_verify_step(
                p, feed, clone(pools0), pt,
                torch.full((n,), S0, dtype=torch.int32, device=dev), active,
                n, ps, k)
            torch.cuda.synchronize()
            errs = {
                "dense kernel vs plain": (runs[None][0] - runs[False][0]),
                "paged kernel vs plain": (runs[None][1] - runs[False][1]),
                "dense verify vs 5 steps": (vd - runs[None][0]),
                "paged verify vs 5 steps": (vp - runs[None][1])}
            diffs = {"dense": _cache_diff(torch, A, serving, cv, seq[None][0]),
                     "paged": _cache_diff(torch, A, serving, pv,
                                          seq[None][1])}
            print(f"  {kvd}: " + ", ".join(
                f"{w} {float(e.abs().max()):.3e}" for w, e in errs.items())
                + f" (tol {LOGIT_TOL}); verify caches against the steps': "
                + ", ".join(f"{w} {nd} of {na} values differ (at most "
                            f"{st} step), scales {r:.2e} relative"
                            for w, (nd, na, st, r) in diffs.items()))
            for w, e in errs.items():
                if not float(e.abs().max()) <= LOGIT_TOL:
                    fail(f"{kvd} {w}: logits differ by "
                         f"{float(e.abs().max())}")
            # a batched product may round a K/V value an ulp apart from
            # a one-row product, and a value on a rounding boundary then
            # lands one quantization step over; more is a fault
            for w, (nd, _, st, r) in diffs.items():
                if st > 1 or not r <= CACHE_SCALE_RTOL:
                    fail(f"{kvd} {w} verify caches differ from the "
                         f"sequential steps': {nd} values, {st} steps, "
                         f"scales {r}")


def window(torch, A, fn):
    """Run `fn` with every launch counter reset just before it and read
    just after it: (its result, LAUNCHES, the nonzero LAUNCHES_BY_MODE)."""
    A.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(A.LAUNCHES), {k: v for k, v in
                                   A.LAUNCHES_BY_MODE.items() if v}


def check_modes(path, got, want):
    want = {k: v for k, v in want.items() if v}
    print(f"  launches by mode on {path}: "
          + ", ".join(f"{'/'.join(k)} {v}" for k, v in sorted(got.items())))
    if got != want:
        fail(f"{path} launched by mode {got}, expected {want}")


def phase_spec_main_path(torch, model, drafts, engine, serving, A):
    """The quantized and speculative serving entry points, bf16, each in
    its own launch window with exact counts."""
    print("== phase 4c: main path, quantized and speculative serving, bf16")
    prompts, reqs_in = seeded_requests(model.vocab_size)
    (B, S0), new, K = prompts.shape, QUANT_NEW, SPEC_K
    L = len(model.blocks)
    counts, modes = {}, {}
    runs = [("generate kv int8", dict(kv_dtype="int8"), None),
            ("generate kv int4", dict(kv_dtype="int4"), None),
            ("generate int8 weights", dict(dtype="int8"), None),
            ("spec generate, clone draft", {}, "clone"),
            ("spec generate, random draft, kv int8", dict(kv_dtype="int8"),
             "random")]
    for path, kw, dname in runs:
        kw = dict(kw)
        kw.setdefault("dtype", "bfloat16")
        if dname is not None:
            kw.update(draft_model=drafts[dname], spec_k=K)
        # warm (cuBLAS handles, the decode-param trees) off the window
        model.generate(prompts[:, :8], 2, **kw)
        t0 = time.perf_counter()
        out, got, by_mode = window(torch, A, lambda: model.generate(
            prompts, new, **kw))
        wall = time.perf_counter() - t0
        if out.shape != (B, S0 + new) or not (out >= 0).all() \
                or not (out < model.vocab_size).all():
            fail(f"{path} returned {out.shape} / out-of-vocab tokens")
        kvm = serving.kv_label(kw.get("kv_dtype"))
        line = f"  {path}: {wall:.3f} s, {B * new / wall:.1f} tok/s"
        if dname is None:
            want = {"flash_fwd": L, "flash_decode": L * (new - 1)}
            want_modes = {("flash_decode", kvm, "single"): L * (new - 1)}
        else:
            st = model.spec_stats
            Ld = len(drafts[dname].blocks)
            R = st["rounds"]
            want = {"flash_fwd": L + Ld,
                    "flash_decode": R * (Ld * (K + 1) + L)}
            want_modes = {("flash_decode", "fp", "single"): R * Ld * (K + 1),
                          ("flash_decode", kvm, "ladder"): R * L}
            line += (f", {R} rounds, acceptance "
                     f"{st['accepted'] / st['drafted']:.3f} ({st})")
        print(line)
        check_launches(path, got, want)
        check_modes(path, by_mode, want_modes)
        counts[path], modes[path] = got, by_mode

    # beam search over an int4 cache: one prefill at batch B, then every
    # step at B * BEAMS rows, the cache rows reordered by parent beam
    path, kw = "generate_beam int4", dict(num_beams=BEAMS, kv_dtype="int4",
                                          dtype="bfloat16")
    model.generate_beam(prompts[:, :8], 2, **kw)
    t0 = time.perf_counter()
    out, got, by_mode = window(torch, A, lambda: model.generate_beam(
        prompts, BEAM_NEW, **kw))
    wall = time.perf_counter() - t0
    if out.shape != (B, S0 + BEAM_NEW) or not (out >= 0).all() \
            or not (out < model.vocab_size).all():
        fail(f"{path} returned {out.shape} / out-of-vocab tokens")
    print(f"  {path}: batch {B} x {BEAMS} beams, {BEAM_NEW} new: "
          f"{wall:.3f} s, {B * BEAM_NEW / wall:.1f} tok/s")
    check_launches(path, got, {"flash_fwd": L,
                               "flash_decode": L * (BEAM_NEW - 1)})
    check_modes(path, by_mode,
                {("flash_decode", "int4", "single"): L * (BEAM_NEW - 1)})
    counts[path], modes[path] = got, by_mode

    # the engine: int8 pools (half the requests), then int4 pools with
    # the clone draft
    for path, picks, kw in (
            ("engine kv int8", reqs_in[:8], dict(kv_dtype="int8")),
            ("spec engine kv int4, clone draft", reqs_in[:SPEC_ENGINE_REQS],
             dict(kv_dtype="int4", draft_model=drafts["clone"], spec_k=K))):
        (reqs, wall, rep, steps), got, by_mode = window(
            torch, A, lambda: serve(engine, model, picks, max_slots=8,
                                    dtype="bfloat16", **kw))
        ntok = sum(len(r.tokens) for r in reqs)
        ttft = statistics.median(r.ttft_s for r in reqs)
        kvm = kw["kv_dtype"]
        line = (f"  {path}: {len(reqs)} requests, {ntok} tokens, "
                f"{wall:.3f} s, {ntok / wall:.1f} tok/s, median TTFT "
                f"{ttft * 1e3:.1f} ms, pool {rep['pool_bytes']} bytes")
        if "draft_model" not in kw:
            want = {"flash_fwd": L * len(reqs), "paged_attention": L * steps}
            want_modes = {("paged_attention", kvm, "single"): L * steps}
        else:
            Ld, R = len(drafts["clone"].blocks), rep["spec"]["rounds"]
            want = {"flash_fwd": (L + Ld) * len(reqs),
                    "paged_attention": R * (Ld * (K + 1) + L)}
            want_modes = {
                ("paged_attention", "fp", "single"): R * Ld * (K + 1),
                ("paged_attention", kvm, "ladder"): R * L}
            line += (f", draft pool {rep['draft_pool_bytes']} bytes, "
                     f"{R} rounds, acceptance {rep['spec_acceptance']:.3f} "
                     f"({rep['spec']})")
        print(line)
        check_launches(path, got, want)
        check_modes(path, by_mode, want_modes)
        counts[path], modes[path] = got, by_mode

    # the int4 pools hold half the int8 pools' bytes; the scales are equal
    split = {}
    for kvd in ("int8", "int4"):
        e = engine.ServingEngine(model, page_size=16, max_ctx=1024,
                                 max_slots=8, kv_dtype=kvd)
        leaves = serving.tree_leaves(e._alloc_pools(e.core, model))
        split[kvd] = (sum(t.numel() for t in leaves
                          if not t.is_floating_point()),
                      sum(t.numel() * 4 for t in leaves
                          if t.is_floating_point()))
        del leaves
    torch.cuda.empty_cache()
    print(f"  pool bytes, 8 slots x 1024: int8 rows {split['int8'][0]} + "
          f"scales {split['int8'][1]}; int4 rows {split['int4'][0]} + "
          f"scales {split['int4'][1]}")
    if split["int8"][0] != 2 * split["int4"][0] \
            or split["int8"][1] != split["int4"][1]:
        fail(f"int4 pools are not half the int8 pools' bytes: {split}")
    return counts, modes


def _gap(torch, model, serving, prompt, ref, at, kv_dtype=None,
         dtype=None, use_kernel=None):
    """Top-2 logit gap of the dense greedy decode of `prompt` (S0,) in
    serving dtype `dtype` (fp32 by default), teacher-forced on its
    reference tokens `ref`, at generated index `at`."""
    S0 = len(prompt)
    core = serving._decode_core(model, S0, len(ref), kv_dtype=kv_dtype)
    p = serving.decode_state(model, dtype)
    dev = model.device
    with torch.no_grad():
        lg, c = core.prefill(p, torch.as_tensor(
            prompt[None].astype(np.int64), device=dev), 1, use_kernel)
        for i in range(at):
            lg, c = core.token_step(p, torch.as_tensor(
                [int(ref[i])], device=dev), c, i, 1, use_kernel)
    top = torch.topk(lg[0].float(), 2).values
    return float(top[0] - top[1])


def _same_or_tie(torch, model, serving, what, prompt, got, ref,
                 kv_dtype=None, dtype=None, use_kernel=None, tie=TIE_GAP):
    """'' when `got` equals `ref` or first parts from it at a tie (the
    reference's top-2 gap there below `tie`, printed), else what
    differs."""
    got, ref = np.asarray(got), np.asarray(ref)
    if np.array_equal(got, ref):
        return ""
    at = int(np.argmax(got != ref))
    gap = _gap(torch, model, serving, prompt, ref, at, kv_dtype, dtype,
               use_kernel)
    if gap < tie:
        print(f"  {what}: first differs at {at}, a tie (top-2 gap "
              f"{gap:.3e} < {tie:.3e})")
        return ""
    return f"{what}: first differs at {at} ({got[at]} != {ref[at]}, gap " \
           f"{gap:.3e})"


def _f32_tree(tree):
    """A decode-param tree with every floating leaf in fp32 (the int8
    values of the int8-weight tree stay int8, its scales fp32)."""
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32_tree(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def _int8_weights_teacher_forced(torch, model, serving):
    """Teacher-forced logits (prefill + 5 steps, GPT-2-small, batch 4,
    prompt 128) of the int8-weight tree on the kernels and on the plain
    versions, and of the bf16 tree (plain), as served (bf16 activations)
    and with every floating leaf of both trees taken to fp32 (the same
    int8 weights and scales, fp32 activations). Returns {"bfloat16" |
    "float32": (the kernels' largest difference from the plain versions,
    the int8 tree's from the bf16 tree's)}."""
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    n, S0, k = 4, 128, 5
    prompt = torch.randint(0, model.vocab_size, (n, S0), generator=g,
                           device=dev)
    feed = torch.randint(0, model.vocab_size, (n, k), generator=g,
                         device=dev)
    core = serving._decode_core(model, S0, k)

    def logits(p, uk):
        lg, c = core.prefill(p, prompt, n, uk)
        out = [lg.float()]
        for i in range(k - 1):
            lg, c = core.token_step(p, feed[:, i], c, i, n, uk)
            out.append(lg.float())
        return torch.stack(out, 1)

    p8, pb = (serving.decode_state(model, d) for d in ("int8", "bfloat16"))
    res = {}
    with torch.no_grad():
        for prec, (t8, tb) in (("bfloat16", (p8, pb)),
                               ("float32", (_f32_tree(p8), _f32_tree(pb)))):
            plain = logits(t8, False)
            res[prec] = (float((logits(t8, None) - plain).abs().max()),
                         float((plain - logits(tb, False)).abs().max()))
    torch.cuda.synchronize()
    return res


def phase_spec_exact(torch, model, drafts, engine, serving, fp32_engine):
    """fp32 on the card: speculative, beam and quantized tokens against
    plain greedy; int8 weights (bf16 activations, so no fp32 run) on the
    kernels against the plain versions. `fp32_engine` is phase 4b's
    (requests, tokens)."""
    print("== phase 4d: exactness, speculative, beam and quantized serving")
    picks, eng_tokens = fp32_engine
    rng = np.random.RandomState(SEED + 9)
    prompts = rng.randint(0, model.vocab_size, (4, 64)).astype(np.int32)
    bad = []
    greedy = model.generate(prompts, 32)
    beam1 = model.generate_beam(prompts, 32, num_beams=1)
    for i in range(len(prompts)):
        bad.append(_same_or_tie(torch, model, serving,
                                f"generate_beam num_beams 1 row {i}",
                                prompts[i], beam1[i, 64:], greedy[i, 64:]))
    print(f"  generate_beam fp32, num_beams 1, against greedy: "
          f"{sum(not b for b in bad)}/{len(prompts)} rows identical or ties")
    for dname in ("clone", "random"):
        out = model.generate(prompts, 32, draft_model=drafts[dname],
                             spec_k=SPEC_K)
        st = model.spec_stats
        for i in range(len(prompts)):
            bad.append(_same_or_tie(torch, model, serving,
                                    f"spec generate ({dname}) row {i}",
                                    prompts[i], out[i, 64:],
                                    greedy[i, 64:]))
        print(f"  spec generate fp32, {dname} draft: {st['rounds']} rounds, "
              f"acceptance {st['accepted'] / st['drafted']:.3f}")
    runs = {"spec engine, clone draft": dict(draft_model=drafts["clone"],
                                             spec_k=SPEC_K),
            "engine kv int8": dict(kv_dtype="int8"),
            "engine kv int4": dict(kv_dtype="int4")}
    for what, kw in runs.items():
        reqs, wall, rep, _ = serve(engine, model, picks, max_slots=4, **kw)
        kvd = kw.get("kv_dtype")
        for i, (r, (pr, mn)) in enumerate(zip(reqs, picks)):
            ref = eng_tokens[i] if kvd is None else model.generate(
                pr[None, :], mn, kv_dtype=kvd)[0, len(pr):]
            bad.append(_same_or_tie(torch, model, serving,
                                    f"{what} request {i}", pr, r.tokens,
                                    ref, kvd))
        extra = (f", acceptance {rep['spec_acceptance']:.3f}"
                 if rep["spec_k"] else "")
        print(f"  {what} fp32: {len(reqs)} requests, "
              f"{sum(len(r.tokens) for r in reqs)} tokens, {wall:.3f} s"
              + extra + "; against "
              + ("the fp32 greedy engine" if kvd is None
                 else f"dense generate kv {kvd}"))

    # int8 weights. In fp32 activations over the same int8 weights the
    # kernels must give the plain versions' logits (LOGIT_TOL) while the
    # bf16 weights' logits stay far off (so the check sees the int8
    # tree). As served (bf16 activations) the two routes round the
    # attention output apart and the logits part by a few bf16 steps,
    # as in phase 3; printed. The int8 engine's tokens on the kernels
    # must equal its tokens on the plain versions, or part at a tie: a
    # top-2 gap within twice that bf16 difference
    d = _int8_weights_teacher_forced(torch, model, serving)
    for prec, (kp, q) in d.items():
        print(f"  int8 weights, teacher-forced logits, {prec} activations: "
              f"kernels vs plain {kp:.3e}, int8 vs bf16 weights {q:.3e}")
    kp32, q32 = d["float32"]
    if not (kp32 <= LOGIT_TOL and q32 > 10 * LOGIT_TOL):
        bad.append(f"int8 weights, fp32 activations: kernels vs plain {kp32} "
                   f"(tol {LOGIT_TOL}), int8 vs bf16 weights {q32} (must "
                   f"exceed {10 * LOGIT_TOL})")
    tie8 = max(2 * d["bfloat16"][0], TIE_GAP)
    runs = {}
    for uk in (None, False):
        reqs, wall, _, _ = serve(engine, model, picks, max_slots=4,
                                 dtype="int8", use_kernel=uk)
        runs[uk] = reqs
        print(f"  engine int8 weights use_kernel={uk}: {len(reqs)} requests, "
              f"{sum(len(r.tokens) for r in reqs)} tokens, {wall:.3f} s")
    for i, (rk, rp, (pr, _)) in enumerate(zip(runs[None], runs[False],
                                              picks)):
        bad.append(_same_or_tie(torch, model, serving,
                                f"engine int8 weights request {i}", pr,
                                rk.tokens, rp.tokens, dtype="int8",
                                use_kernel=False, tie=tie8))
    bad = [b for b in bad if b]
    if bad:
        fail("speculative/beam/quantized tokens differ: " + "; ".join(bad))


_GEMM = ("gemm", "nvjet", "cutlass", "xmma")
# the decode kernels' names match their merge kernels' too
# (flash_decode_kernel_merge, paged_kernel_merge)
SERVE_CATS = (("attention kernels", ("flash_fwd_kernel", "flash_decode_kernel",
                                     "paged_kernel")),)
# the kernels each serving profile must show: a decode call's split kernel
# and its merge
K3_KERNELS = ("flash_decode_kernel<", "flash_decode_kernel_merge")
K4_KERNELS = ("paged_kernel<", "paged_kernel_merge")
# profiler ranges (torch.profiler.record_function) that the port opens:
# the optimizer's updates
#: observe.span's profiler ranges are named SPAN_TRACE_PREFIX + the span's
#: path ("singa.span/model.step/opt.apply_updates"); observe.py's
#: SPAN_TRACE_PREFIX, kept here so the script imports no module of the
#: port before its checks
SPAN_PREFIX = "singa.span/"
TRAIN_CATS = (("flash fwd", ("flash_fwd_kernel",)),
              ("flash bwd", ("flash_bwd_", "scale_cast_kernel")))


#: (device busy ms or None, wall ms) of every _breakdown, by its `what`
PROFILES = {}


def _breakdown(torch, what, fn, cats=SERVE_CATS, require=(), spans=()):
    """Device time by kernel over one call of `fn` under torch.profiler:
    busy share of the wall time (profiler on), and the time split into
    the named kernel categories, matrix products and the rest. The top
    kernels are printed, and those named in `require`, which must have
    run; `spans` names observe spans (their profiler ranges are
    SPAN_PREFIX + the span's path; a span matches at any depth) whose
    kernels' device time is printed too (they are also counted in the
    categories)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    # device-side events only (kernels, copies): a CPU op's own device
    # time counts the kernels it launched a second time. An observe span's
    # range also shows on the device as one event spanning first to last
    # kernel, idle gaps included: not a kernel
    rows = [(e.device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0
            and not e.key.startswith(SPAN_PREFIX)]
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"  {what}: wall {wall_ms:.2f} ms; device time not measured "
              "(the profiler saw no device activity)")
        PROFILES[what] = (None, wall_ms)
        return PROFILES[what]
    totals = {label: 0.0 for label, _ in cats}
    totals.update({"matmul": 0.0, "other": 0.0})
    for ms, _, name in rows:
        cat = next((label for label, keys in cats
                    if any(k in name for k in keys)), None)
        if cat is None:
            cat = ("matmul" if any(k in name.lower() for k in _GEMM)
                   else "other")
        totals[cat] += ms
    print(f"  {what}: wall {wall_ms:.2f} ms (profiler on), device busy "
          f"{busy:.2f} ms ({busy / wall_ms:.1%}), idle "
          f"{1 - busy / wall_ms:.1%}; "
          + ", ".join(f"{k} {v:.2f} ms ({v / busy:.1%})"
                      for k, v in totals.items()))
    for k in require:
        ms = sum(r[0] for r in rows if k in r[2])
        print(f"    required {k}: {ms:.3f} ms ({ms / busy:.1%}), "
              f"{sum(r[1] for r in rows if k in r[2])} launches")
    ranked = sorted(rows, reverse=True)
    for rank, (ms, count, name) in enumerate(ranked, 1):
        if rank <= 6 or any(k in name for k in require):
            print(f"    #{rank:<3d}{ms:9.3f} ms {ms / busy:6.1%} x{count:<5d} "
                  f"{name[:70]}")
    for span in spans:
        # the kernels launched inside the range (its host-side event's
        # device time), and the range's extent on the device's timeline
        def is_span(name):
            return name.startswith(SPAN_PREFIX) and (
                name == SPAN_PREFIX + span or name.endswith("/" + span))
        ms = sum(e.device_time_total for e in prof.events()
                 if is_span(e.name) and e.device_type == DeviceType.CPU) / 1e3
        extent = sum(e.device_time_total for e in prof.key_averages()
                     if is_span(e.key) and e.device_type == DeviceType.CUDA)
        print(f"    range {span}: kernels {ms:.3f} ms of device time "
              f"({ms / busy:.1%}); on the device's timeline it spans "
              f"{extent / 1e3:.3f} ms" if ms else
              f"    range {span}: device time not measured (the profiler "
              "gave the range none)")
    missing = [k for k in require if not any(k in r[2] for r in rows)]
    if missing:
        fail(f"{what}: no device time in {missing}")
    PROFILES[what] = (busy, wall_ms)
    return PROFILES[what]


def phase_profile(torch, model, engine, train_step, drafts):
    """Where the time goes on the card, for both serving entry points
    (bf16), a speculative engine (int4 pools, the clone draft) and one
    training step at the bench width."""
    print("== phase 5: device time by kernel (torch.profiler)")
    rng = np.random.RandomState(SEED + 2)
    prompts = rng.randint(0, model.vocab_size, (8, 128)).astype(np.int32)
    _breakdown(torch, "generate b8 prompt 128 +32",
               lambda: model.generate(prompts, 32, dtype="bfloat16"),
               require=K3_KERNELS)
    reqs_in = [(rng.randint(0, model.vocab_size, (256,)).astype(np.int32),
                32) for _ in range(8)]
    _breakdown(torch, "engine 8 requests prompt 256 +32",
               lambda: serve(engine, model, reqs_in, timeout_s=300,
                             max_slots=8, dtype="bfloat16"),
               require=K4_KERNELS)
    _breakdown(torch, f"spec engine 8 requests prompt 256 +8, kv int4, "
               f"clone draft, spec_k {SPEC_K}",
               lambda: serve(engine, model, [(p, 8) for p, _ in reqs_in],
                             timeout_s=300, max_slots=8, dtype="bfloat16",
                             kv_dtype="int4", draft_model=drafts["clone"],
                             spec_k=SPEC_K),
               require=K4_KERNELS)
    _breakdown(torch, "train step b8 s1024 bf16 (bench width)", train_step,
               TRAIN_CATS, require=TC_KERNELS)


def _train_batch(torch, vocab, B, S, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, S)).astype(np.int64)
    tgt = np.roll(ids, -1, axis=1)
    return torch.as_tensor(ids), torch.as_tensor(tgt)


def _steps(torch, m, tx, ty, n):
    """n training steps, each fenced by loss.item(): (losses, ms)."""
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        _, loss = m(tx, ty)
        losses.append(loss.item())
        ms.append((time.perf_counter() - t0) * 1e3)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    return losses, ms


def phase_train(torch, models, opt, A):
    """The training main path at the bench width: counters reset just
    before the timed steps and read just after them."""
    print("== phase 6: GPT training, bench width, bf16 amp, SGD")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))
    t0 = time.perf_counter()
    m = models.create_model("gpt", device="cuda", seed=SEED, **BENCH_GPT)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    m.compile([tx], is_train=True, use_graph=False, amp="bfloat16")
    print(f"  model: {sum(p.numel() for p in m.parameters())} parameters, "
          f"built in {time.perf_counter() - t0:.2f} s; batch {TRAIN_B} x "
          f"{TRAIN_S}; eager (phase 8 runs the step as a CUDA graph)")
    warm, warm_ms = _steps(torch, m, tx, ty, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.reset_launches()
    losses, ms = _steps(torch, m, tx, ty, TRAIN_STEPS)
    counts = dict(A.LAUNCHES)
    step = statistics.median(ms)
    print(f"  warm step {warm_ms[0]:.1f} ms, loss {warm[0]:.4f}; "
          f"{TRAIN_STEPS} timed steps: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; step ms {', '.join(f'{x:.2f}' for x in ms)}; median "
          f"{step:.2f} ms, {TRAIN_B * TRAIN_S / step * 1e3:.0f} tokens/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_launches("training", counts, {"flash_fwd": L * TRAIN_STEPS,
                                        "flash_bwd_fused": L * TRAIN_STEPS})

    # checkpoint round trip: a fresh model loading the zip gives the same
    # logits bit for bit
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "gpt.zip")
        t0 = time.perf_counter()
        m.save_states(path)
        save_s, size = time.perf_counter() - t0, os.path.getsize(path)
        fresh = models.create_model("gpt", device="cuda", seed=SEED + 1,
                                    **BENCH_GPT)
        fresh.compile([tx], is_train=False, amp="bfloat16")
        t0 = time.perf_counter()
        fresh.load_states(path)
        load_s = time.perf_counter() - t0
    m.eval()
    same = torch.equal(m(tx[:2]), fresh(tx[:2]))
    m.train()
    print(f"  save_states {size / 2**30:.2f} GiB in {save_s:.1f} s, "
          f"load_states into a fresh model {load_s:.1f} s; logits "
          f"identical: {same}")
    if not same:
        fail("logits differ after save_states/load_states")
    del fresh
    torch.cuda.empty_cache()
    return m, (tx, ty), counts


def phase_train_fp32(torch, models, opt, transformer):
    """Three fp32 SGD steps on the card (kernels) and on the CPU (plain
    versions) from identical weights."""
    print("== phase 6b: fp32 training, card against CPU")
    cfg = dict(vocab_size=8192, max_seq=256, dim=512, num_heads=8,
               num_layers=2)
    tx, ty = _train_batch(torch, cfg["vocab_size"], 2, 256, SEED + 4)
    mc = models.create_model("gpt", device="cpu", seed=SEED + 5, **cfg)
    mg = models.create_model("gpt", device="cuda", seed=SEED + 6, **cfg)
    transformer.load_singa_params(mg, {k: p.detach().numpy()
                                       for k, p in mc._raw_params().items()})
    runs = []
    for m in (mc, mg):
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([tx], is_train=True)
        dev = next(m.parameters()).device
        runs.append(_steps(torch, m, tx.to(dev), ty.to(dev), 3)[0])
    lc, lg = runs
    rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    pc = mc._raw_params()
    perr = max(float((p.detach().cpu() - pc[k].detach()).abs().max())
               for k, p in mg._raw_params().items())
    print(f"  losses card {[round(x, 6) for x in lg]}, CPU "
          f"{[round(x, 6) for x in lc]}: max relative difference "
          f"{rel:.3e}; params after 3 steps max abs difference {perr:.3e} "
          f"(tol {TRAIN_TOL} each)")
    if not (rel <= TRAIN_TOL and perr <= TRAIN_TOL):
        fail("fp32 training on the card differs from the CPU")


def phase_train_long(torch, models, opt, A, rows, g):
    """Long-context training, where the backward takes K2b + K2c; counters
    reset just before its steps and read just after them. Then one step
    under torch.profiler, which must show the tensor-core K1, K2b and K2c,
    and one layer's backward at its shape on both routes (K2a forced)
    against flash_bwd_reference, timed beside each other."""
    print(f"== phase 6c: long-context training, S {LONG_S}, "
          f"{LONG_LAYERS} layers, bf16 amp")
    cfg = dict(BENCH_GPT, max_seq=LONG_S, num_layers=LONG_LAYERS)
    tx, ty = (t.cuda() for t in _train_batch(torch, cfg["vocab_size"], 1,
                                             LONG_S, SEED + 6))
    m = models.create_model("gpt", device="cuda", seed=SEED + 6, **cfg)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    m.compile([tx], is_train=True, amp="bfloat16")
    A.reset_launches()
    losses, ms = _steps(torch, m, tx, ty, 2)
    counts = dict(A.LAUNCHES)
    print(f"  2 steps: losses {', '.join(f'{x:.4f}' for x in losses)}; step "
          f"ms {', '.join(f'{x:.1f}' for x in ms)} (the first includes "
          f"warm-up), {LONG_S / ms[-1] * 1e3:.0f} tokens/s at the second")
    check_launches("long-context training", counts, {
        "flash_fwd": 2 * LONG_LAYERS, "flash_bwd_dq": 2 * LONG_LAYERS,
        "flash_bwd_dkv": 2 * LONG_LAYERS})
    _breakdown(torch, f"long-context train step S {LONG_S}, {LONG_LAYERS} "
               "layers, bf16 amp", lambda: m(tx, ty)[1].item(), TRAIN_CATS,
               require=LONG_TC_KERNELS)
    del m
    torch.cuda.empty_cache()
    bwd_case(torch, A, rows, g, (1, 16, LONG_S, 128), "bfloat16",
             routes=("split", "fused"), n=3, n_plain=2)
    return counts


RESNET_B, RESNET_HW, RESNET_CLASSES = 32, 224, 10   # bench.py's ResNet-50
# 2 warm-up steps, 5 timed, then more on the same batch for the loss
# check: at lr 0.1 with momentum the loss first climbs for a few steps
# (on a CPU rehearsal at b8 x 64 x 64 it peaked at step 2 and fell below
# its start by step 12), so the check looks at the last 5 of 20
RESNET_WARM, RESNET_STEPS, RESNET_ALL = 2, 5, 20
# kernel names of the ResNet step's categories, in the order they are
# tried: cuDNN's convolutions (and its layout transposes), batch norm
RESNET_CATS = (("conv", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                         "implicit_gemm", "xmma", "nchwToNhwc",
                         "nhwcToNchw")),
               ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw",
                               "welford")))


def _conv_linear_flops(torch, layer, m, tx):
    """Training FLOPs of one step counted from the model's conv and linear
    shapes, seen by forward hooks over one eval-mode forward: 2 x output
    elements x (input channels / group) x kernel area per conv, 2 x
    output elements x in features per linear; the step takes three times
    the forward (the data and weight gradients), the first conv two (its
    input takes no gradient)."""
    fwd = []

    def hook(mod, inputs, out):
        W = mod.W
        per_out = W[0].numel() if isinstance(mod, layer.Conv2d) \
            else W.shape[0]
        fwd.append(2 * out.data.numel() * per_out)

    hooks = [mod.register_forward_hook(hook) for mod in m.modules()
             if isinstance(mod, (layer.Conv2d, layer.Linear))]
    m.eval()
    m(tx)
    m.train()
    for h in hooks:
        h.remove()
    return 3 * sum(fwd) - fwd[0], fwd


def phase_resnet(torch, models, opt, tensor, device, layer):
    """The SINGA API's main path at the bench's width: ResNet-50 b32 x 224
    x 224, 10 classes, bf16 amp, SGD(0.1, 0.9, wd 1e-5), through
    models.create_model, tensor.Tensor and compile(use_graph=True), the
    inputs seeded numpy as in bench.py."""
    print(f"== phase 7: ResNet-50 through the SINGA API, b{RESNET_B} x "
          f"{RESNET_HW}x{RESNET_HW}, bf16 amp, SGD(0.1, 0.9, wd 1e-5)")
    dev = device.best_device()
    dev.SetRandSeed(SEED)
    rng = np.random.RandomState(SEED + 11)
    x = rng.randn(RESNET_B, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, RESNET_B).astype(np.int32)
    tx = tensor.Tensor(data=x, device=dev)
    ty = tensor.from_numpy(y, device=dev)
    t0 = time.perf_counter()
    m = models.create_model("resnet50", num_channels=3,
                            num_classes=RESNET_CLASSES)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    m.compile([tx], is_train=True, use_graph=False, amp="bfloat16")
    n_params = sum(p.numel() for p in m._raw_params().values())
    print(f"  model: {n_params} parameters on {next(m.parameters()).device}, "
          f"built and compiled in {time.perf_counter() - t0:.2f} s; "
          "eager (phase 8b runs the step as a CUDA graph)")
    flops, _ = _conv_linear_flops(torch, layer, m, tx)
    warm, warm_ms = _steps(torch, m, tx, ty, RESNET_WARM)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = _steps(torch, m, tx, ty, RESNET_STEPS)
    step = statistics.median(ms)
    share = flops / (step / 1e3) / PEAK_FLOPS["bfloat16"]
    print(f"  warm steps {', '.join(f'{v:.1f}' for v in warm_ms)} ms, "
          f"losses {', '.join(f'{v:.4f}' for v in warm)}; {RESNET_STEPS} "
          f"timed steps: losses {', '.join(f'{v:.4f}' for v in losses)}; "
          f"step ms {', '.join(f'{v:.2f}' for v in ms)}; median {step:.2f} "
          f"ms, {RESNET_B / step * 1e3:.1f} img/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"{flops / 1e9:.1f} GFLOP a step (conv and linear shapes), "
          f"{flops / (step / 1e3) / 1e12:.2f} TFLOP/s, {share:.2%} of the "
          "bf16 peak")
    all_losses = warm + losses + _steps(
        torch, m, tx, ty, RESNET_ALL - RESNET_WARM - RESNET_STEPS)[0]
    print(f"  losses over {RESNET_ALL} steps on the fixed batch: "
          + ", ".join(f"{v:.3f}" for v in all_losses))
    if not min(all_losses[-5:]) < all_losses[0]:
        fail("ResNet-50 loss does not fall on the fixed batch")
    _breakdown(torch, f"ResNet-50 train step b{RESNET_B} bf16",
               lambda: m(tx, ty)[1].item(), RESNET_CATS,
               spans=("opt.apply_updates",))
    del m
    torch.cuda.empty_cache()


def phase_resnet_fp32(torch, models, opt, tensor, device):
    """fp32 on the card against the CPU: a small ResNet (Bottleneck,
    [1, 1, 1, 1], b8 x 64 x 64), the CPU model's initial states carried
    to the card, two SGD steps each."""
    print("== phase 7b: small ResNet fp32 training, card against CPU")
    from singa_tpu_torch.models import resnet
    rng = np.random.RandomState(SEED + 12)
    x = rng.randn(8, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    built = []
    for dev in (device.create_cpu_device(), device.best_device()):
        m = resnet.ResNet(resnet.Bottleneck, [1, 1, 1, 1])
        m.set_optimizer(opt.SGD(lr=0.01, momentum=0.9, weight_decay=1e-5))
        tx = tensor.Tensor(data=x, device=dev)
        ty = tensor.from_numpy(y, device=dev)
        m.compile([tx], is_train=True, use_graph=False)
        built.append((m, tx, ty))
    (mc, _, _), (mg, _, _) = built
    mg.set_states(mc._raw_states())
    lc, lg = (_steps(torch, m, tx, ty, 2)[0] for m, tx, ty in built)
    rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    sc = mc._raw_states()
    serr = max(float((t.detach().cpu() - sc[k].detach()).abs().max())
               for k, t in mg._raw_states().items())
    print(f"  losses card {[round(v, 6) for v in lg]}, CPU "
          f"{[round(v, 6) for v in lc]}: max relative difference {rel:.3e}; "
          f"parameters and running stats after 2 steps max abs difference "
          f"{serr:.3e} (tol {TRAIN_TOL} each)")
    if not (rel <= TRAIN_TOL and serr <= TRAIN_TOL):
        fail("fp32 ResNet training on the card differs from the CPU")


def phase_tensor_attention(torch, A, autograd, tensor, device):
    """autograd.attention on CUDA Tensors (the tape): a counted window in
    which it launches K1 forward and K2a backward, fp32 and bf16; outputs
    and gradients held against use_kernel=False at phase 2's tolerances.
    Returns the window's counts."""
    print("== phase 7c: autograd.attention on Tensors (K1 + K2a)")
    dev = device.best_device()
    shape = (2, 8, 256, 64)
    rng = np.random.RandomState(SEED + 13)
    arrays = [rng.randn(*shape).astype(np.float32) for _ in range(4)]

    def run(dtype, use_kernel):
        qkv = [tensor.Tensor(data=a, device=dev, dtype=dtype,
                             stores_grad=True) for a in arrays[:3]]
        w = tensor.Tensor(data=arrays[3], device=dev, dtype=dtype,
                          requires_grad=False)
        prev = autograd.training
        autograd.training = True
        try:
            out = autograd.attention(*qkv, causal=True,
                                     use_kernel=use_kernel)
            g = autograd.gradients(autograd.reduce_sum(
                autograd.mul(out, w), None, False))
        finally:
            autograd.training = prev
        return [out.data.float()] + [g[t].data.float() for t in qkv]

    ref = {dt: run(dt, False) for dt in ("float32", "bfloat16")}
    torch.cuda.synchronize()
    A.reset_launches()
    got = {dt: run(dt, None) for dt in ("float32", "bfloat16")}
    torch.cuda.synchronize()
    counts = dict(A.LAUNCHES)
    check_launches("Tensor attention", counts,
                   {"flash_fwd": 2, "flash_bwd_fused": 2})
    bad = []
    for dt in ("float32", "bfloat16"):
        (o, *gs), (ro, *rgs) = got[dt], ref[dt]
        ferr = float((o - ro).detach().abs().max())
        gerr = [float((a - b).detach().abs().max())
                for a, b in zip(gs, rgs)]
        if dt == "bfloat16":
            gerr = [e / float(b.abs().max()) for e, b in zip(gerr, rgs)]
        print(f"  {dt} {tuple(shape)} causal: out max abs error {ferr:.3e} "
              f"(tol {TOL[dt]}), dq/dk/dv error "
              + ", ".join(f"{e:.3e}" for e in gerr)
              + f" ({'over max |ref|, ' if dt == 'bfloat16' else ''}"
              f"tol {BWD_TOL[dt]})")
        if ferr > TOL[dt] or max(gerr) > BWD_TOL[dt]:
            bad.append(dt)
    if bad:
        fail(f"autograd.attention on Tensors disagrees with the plain "
             f"version: {bad}")
    return counts


# ---- phases 8-8c: the buffered graph, fit, checkpoints, record IO -----------
GRAPH_TOL = 1e-5        # graph against eager, fp32: losses (relative), states
EXACT_STEPS = 6         # steps of each fp32 exactness run
GRAPH_STEPS = 5         # steps per timed turn, and in the counted window
GPT_TRAIN_PROFILE = "train step b8 s1024 bf16 (bench width)"
RESNET_PROFILE = f"ResNet-50 train step b{RESNET_B} bf16"
FIT_BATCHES = 4         # batches in phase 8c's record file (cut from 8)
#: 8c's model: the bench GPT cut to 4 of its 8 layers, and the share of
#: its states' bytes that goes through snapshot.Snapshot (1/4, cut from
#: all of them); the cuts make room for phase 20
FIT_GPT = dict(BENCH_GPT, num_layers=4)
SNAP_SHARE = 4


def _turns(torch, built, tx, ty, n=GRAPH_STEPS):
    """Step ms of each model in `built` in turns (first, second, second,
    first), n steps a turn, each fenced by loss.item()."""
    ms = {k: [] for k in built}
    for label in list(built) + list(built)[::-1]:
        ms[label] += _steps(torch, built[label], tx, ty, n)[1]
    return ms


def _idle_line(what, eager_key, graph_prof):
    """The eager profile (an earlier phase's, this process) beside the
    graph one: device busy and idle share."""
    parts = []
    for label, (busy, wall) in (("eager", PROFILES.get(eager_key,
                                                       (None, None))),
                                ("graph", graph_prof)):
        parts.append(f"{label} busy {busy:.2f} of {wall:.2f} ms, idle "
                     f"{1 - busy / wall:.1%}" if busy else
                     f"{label} device time not measured")
    print(f"  {what} under the profiler: " + "; ".join(parts))


def _compare_states(torch, a, b):
    """(max abs difference, bitwise equal) over two {name: tensor}."""
    err = max(float((a[k].detach().float() - b[k].detach().float())
                    .abs().max()) for k in a)
    return err, all(torch.equal(a[k], b[k]) for k in a)


def phase_graph_gpt(torch, models, opt, A):
    """The GPT step as a CUDA graph: the fp32 GPT of phase 6b, eager
    against graph from the same weights (6 steps each, the losses kept as
    the steps returned them, so a reused output buffer shows); then the
    bench GPT, eager and graph in turns, exact launches per replayed step
    and the graph step under the profiler; then phase 6c's long-context
    step as a graph, whose backward is the split pair K2b + K2c, with
    exact launches per replay. Returns the two counted windows' sum."""
    print("== phase 8: GPT training as a CUDA graph (use_graph=True)")
    cfg = dict(vocab_size=8192, max_seq=256, dim=512, num_heads=8,
               num_layers=2)
    tx, ty = (t.cuda() for t in _train_batch(torch, cfg["vocab_size"], 2,
                                             256, SEED + 4))
    runs = {}
    for graph in (False, True):
        m = models.create_model("gpt", device="cuda", seed=SEED + 5, **cfg)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([tx], is_train=True, use_graph=graph)
        kept = [m(tx, ty)[1] for _ in range(EXACT_STEPS)]
        runs[graph] = (m, torch.stack(kept).tolist())
    (me, le), (mg, lg) = runs[False], runs[True]
    if mg.graph_backend != "cuda_graph":
        fail(f"graph mode on the card ran {mg.graph_backend!r}, not a CUDA "
             "graph")
    rel = max(abs(a - b) / abs(a) for a, b in zip(le, lg))
    serr, same = _compare_states(torch, me._raw_states(), mg._raw_states())
    print(f"  fp32 GPT (dim 512, 2 layers, S 256), {EXACT_STEPS} steps: "
          f"losses eager {[round(v, 6) for v in le]}, graph "
          f"{[round(v, 6) for v in lg]}: max relative difference {rel:.3e}; "
          f"parameters max abs difference {serr:.3e} (tol {GRAPH_TOL} "
          f"each); bitwise equal: {same and le == lg}")
    if not (rel <= GRAPH_TOL and serr <= GRAPH_TOL):
        fail("the GPT's CUDA-graph step differs from its eager step")
    phase_graph_eval(torch, A, me, mg, tx, cfg["num_layers"])
    del runs, me, mg
    torch.cuda.empty_cache()

    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))
    built = {}
    for label, graph in (("eager", False), ("graph", True)):
        m = models.create_model("gpt", device="cuda", seed=SEED, **BENCH_GPT)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([tx], is_train=True, use_graph=graph, amp="bfloat16")
        losses, ms = _steps(torch, m, tx, ty, 2)
        print(f"  bench GPT {label}: first two steps {ms[0]:.1f}, "
              f"{ms[1]:.1f} ms (graph: eager warm-up, then capture and "
              f"first replay), losses {losses[0]:.4f}, {losses[1]:.4f}")
        built[label] = m
    ms = _turns(torch, built, tx, ty)
    med = {k: statistics.median(v) for k, v in ms.items()}
    for k, v in ms.items():
        print(f"  bench GPT b{TRAIN_B} x {TRAIN_S} bf16 {k}: step ms "
              f"{', '.join(f'{x:.2f}' for x in v)}; median {med[k]:.2f} ms, "
              f"{TRAIN_B * TRAIN_S / med[k] * 1e3:.0f} tokens/s")
    print(f"  graph / eager step: {med['graph'] / med['eager']:.3f}")
    g = built["graph"]
    torch.cuda.synchronize()
    A.reset_launches()
    _steps(torch, g, tx, ty, GRAPH_STEPS)
    counts = dict(A.LAUNCHES)
    check_launches("graph training (replays)", counts,
                   {"flash_fwd": L * GRAPH_STEPS,
                    "flash_bwd_fused": L * GRAPH_STEPS})
    prof = _breakdown(torch, "graph train step b8 s1024 bf16 (bench width)",
                      lambda: g(tx, ty)[1].item(), TRAIN_CATS,
                      require=TC_KERNELS)
    _idle_line("bench GPT step", GPT_TRAIN_PROFILE, prof)
    del built, g
    torch.cuda.empty_cache()

    # the split backward (K2b + K2c) inside a graph: phase 6c's step
    cfg = dict(BENCH_GPT, max_seq=LONG_S, num_layers=LONG_LAYERS)
    tx, ty = (t.cuda() for t in _train_batch(torch, cfg["vocab_size"], 1,
                                             LONG_S, SEED + 6))
    m = models.create_model("gpt", device="cuda", seed=SEED + 6, **cfg)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    m.compile([tx], is_train=True, use_graph=True, amp="bfloat16")
    _steps(torch, m, tx, ty, 2)
    torch.cuda.synchronize()
    A.reset_launches()
    losses, ms = _steps(torch, m, tx, ty, 2)
    long_counts = dict(A.LAUNCHES)
    print(f"  long-context step (S {LONG_S}, {LONG_LAYERS} layers) as a "
          f"graph: replayed steps {', '.join(f'{x:.1f}' for x in ms)} ms, "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}")
    check_launches("long-context graph training (replays)", long_counts, {
        "flash_fwd": 2 * LONG_LAYERS, "flash_bwd_dq": 2 * LONG_LAYERS,
        "flash_bwd_dkv": 2 * LONG_LAYERS})
    del m
    torch.cuda.empty_cache()
    return {k: v + long_counts[k] for k, v in counts.items()}


EVAL_ROWS = (2, 2, 2, 1, 2)   # eval batch sizes: warm-up, capture, replays


def phase_graph_eval(torch, A, me, mg, tx, L):
    """The eval step as a CUDA graph: the two trained fp32 GPTs of phase 8
    in eval mode, the graph one buffered per batch bucket, over batches of
    EVAL_ROWS rows; the logits held to the eager model's within
    GRAPH_TOL (absolute), and the last call, a replay, counted: one K1
    launch per layer."""
    me.eval()
    mg.eval()
    errs = []
    for i, n in enumerate(EVAL_ROWS):
        want = me(tx[:n])
        if i == len(EVAL_ROWS) - 1:
            torch.cuda.synchronize()
            A.reset_launches()
        got = mg(tx[:n])
        errs.append(float((got - want).abs().max()))
    torch.cuda.synchronize()
    counts = dict(A.LAUNCHES)
    print(f"  fp32 GPT eval as a graph ({mg.graph_backend}), batches of "
          f"{list(EVAL_ROWS)} rows: logits max abs difference from eager "
          f"{max(errs):.3e} (tol {GRAPH_TOL}); bitwise equal: "
          f"{max(errs) == 0.0}; eval graphs built {mg._eval_trace_count}, "
          f"per-sample probe {mg._eval_per_sample}")
    check_launches("graph eval (a replay)", counts, {"flash_fwd": L})
    if mg.graph_backend != "cuda_graph" or max(errs) > GRAPH_TOL:
        fail("the GPT's CUDA-graph eval step differs from its eager one")


def phase_graph_resnet(torch, models, opt, tensor, device):
    """ResNet-50 b32 bf16 as a CUDA graph against phase 7's eager step in
    turns, and the graph step under the profiler; then the fp32 small
    ResNet of phase 7b, eager against graph from the same states, on
    cuDNN's deterministic algorithms."""
    print(f"== phase 8b: ResNet-50 b{RESNET_B} bf16 as a CUDA graph")
    dev = device.best_device()
    rng = np.random.RandomState(SEED + 11)
    x = rng.randn(RESNET_B, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, RESNET_B).astype(np.int32)
    tx = tensor.Tensor(data=x, device=dev)
    ty = tensor.from_numpy(y, device=dev)
    built = {}
    for label, graph in (("eager", False), ("graph", True)):
        dev.SetRandSeed(SEED)
        m = models.create_model("resnet50", num_channels=3,
                                num_classes=RESNET_CLASSES)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([tx], is_train=True, use_graph=graph, amp="bfloat16")
        losses, ms = _steps(torch, m, tx, ty, 2)
        print(f"  ResNet-50 {label}: first two steps {ms[0]:.1f}, "
              f"{ms[1]:.1f} ms, losses {losses[0]:.4f}, {losses[1]:.4f}")
        built[label] = m
    if built["graph"].graph_backend != "cuda_graph":
        fail("ResNet-50 in graph mode did not run a CUDA graph")
    ms = _turns(torch, built, tx, ty)
    med = {k: statistics.median(v) for k, v in ms.items()}
    for k, v in ms.items():
        print(f"  ResNet-50 {k}: step ms {', '.join(f'{x:.2f}' for x in v)};"
              f" median {med[k]:.2f} ms, {RESNET_B / med[k] * 1e3:.1f} img/s")
    print(f"  graph / eager step: {med['graph'] / med['eager']:.3f}")
    g = built["graph"]
    prof = _breakdown(torch, f"graph ResNet-50 train step b{RESNET_B} bf16",
                      lambda: g(tx, ty)[1].item(), RESNET_CATS)
    _idle_line("ResNet-50 step", RESNET_PROFILE, prof)
    del built, g
    torch.cuda.empty_cache()

    rng = np.random.RandomState(SEED + 12)
    x = rng.randn(8, 3, 64, 64).astype(np.float32)
    y = rng.randint(0, 10, 8).astype(np.int32)
    tx = tensor.Tensor(data=x, device=dev)
    ty = tensor.from_numpy(y, device=dev)
    # cuDNN's default algorithms are not reproducible run to run, so the
    # graph is held to the eager step with both on its deterministic
    # algorithms; two eager runs on the default ones are printed beside
    deterministic = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        rel, serr, same = _small_resnet_pair(torch, opt, tx, ty,
                                             (False, False))
        print(f"  fp32 small ResNet (Bottleneck [1, 1, 1, 1], b8 x 64 x "
              f"64), cuDNN's default algorithms, eager against eager, "
              f"{EXACT_STEPS} steps: max relative loss difference "
              f"{rel:.3e}, states {serr:.3e}; bitwise equal: {same}")
        torch.backends.cudnn.deterministic = True
        rel, serr, same = _small_resnet_pair(torch, opt, tx, ty,
                                             (False, True))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"  the same, cuDNN deterministic, eager against graph: max "
          f"relative loss difference {rel:.3e}; parameters and running "
          f"stats max abs difference {serr:.3e} (tol {GRAPH_TOL} each); "
          f"bitwise equal: {same}")
    if not (rel <= GRAPH_TOL and serr <= GRAPH_TOL):
        fail("the small ResNet's CUDA-graph step differs from its eager step")


def _small_resnet_pair(torch, opt, tx, ty, graphs):
    """Two small fp32 ResNets (Bottleneck, [1, 1, 1, 1]) from the same
    states, with use_graph as `graphs` says, EXACT_STEPS SGD steps each:
    (max relative loss difference, max abs state difference, bitwise
    equal)."""
    from singa_tpu_torch.models import resnet
    pair = []
    for graph in graphs:
        m = resnet.ResNet(resnet.Bottleneck, [1, 1, 1, 1])
        m.set_optimizer(opt.SGD(lr=0.01, momentum=0.9, weight_decay=1e-5))
        m.compile([tx], is_train=True, use_graph=graph)
        if pair:
            m.set_states(pair[0]._raw_states())
        pair.append(m)
    out = []
    for m in pair:
        kept = [m(tx, ty)[1] for _ in range(EXACT_STEPS)]
        out.append(([float(v.data.detach()) for v in kept], m._raw_states()))
    (la, sa), (lb, sb) = out
    rel = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
    serr, same = _compare_states(torch, sa, sb)
    return rel, serr, same and la == lb


class RecordBatches:
    """A dataset over a record file of (B, S) int64 token ids: each
    iteration reads the file through io.RecordReader and yields (ids,
    next-token targets) as CPU tensors."""

    def __init__(self, sio, path, B, S):
        self.sio, self.path, self.shape = sio, path, (B, S)

    def __iter__(self):
        import torch
        with self.sio.RecordReader(self.path) as r:
            for _key, val in r:
                ids = torch.from_numpy(np.frombuffer(val, np.int64).copy()
                                       .reshape(self.shape))
                yield ids, torch.roll(ids, -1, 1)


def _write_records(sio, path, n, B, S, vocab, seed):
    rng = np.random.RandomState(seed)
    with sio.RecordWriter(path) as w:
        for i in range(n):
            w.write(f"batch{i}", rng.randint(0, vocab, (B, S))
                    .astype(np.int64).tobytes())
        return w.backend


def phase_pipeline(torch, models, opt, sio, overlap, snapshot, A, root):
    """The trainer's pipeline on the card: records written and read back
    through io (native), Model.fit over them in graph mode with
    prefetch_to_device=2, an async save_checkpoint after epoch 1 while
    epoch 2 runs, load_checkpoint into a fresh model and its epoch 2; the
    resumed fp32 GPT's epoch-2 loss held to the uninterrupted run's; the
    bench GPT's states copied to the host, then through snapshot.Snapshot
    (native, then npz). Returns the counted window (epoch 2 of the bench
    GPT)."""
    print("== phase 8c: fit over record files, async checkpoints, resume")
    L, V = FIT_GPT["num_layers"], FIT_GPT["vocab_size"]
    rec = os.path.join(root, "gpt.rio")
    t0 = time.perf_counter()
    backend = _write_records(sio, rec, FIT_BATCHES, TRAIN_B, TRAIN_S, V,
                             SEED + 14)
    print(f"  {FIT_BATCHES} batches of {TRAIN_B} x {TRAIN_S} ids written in "
          f"{time.perf_counter() - t0:.2f} s, record backend {backend}")
    if backend != "native":
        fail(f"record IO ran the {backend} backend, not the native one")
    ds = RecordBatches(sio, rec, TRAIN_B, TRAIN_S)
    m = models.create_model("gpt", device="cuda", seed=SEED, **FIT_GPT)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    m.compile([next(iter(ds))[0].cuda()], is_train=True, use_graph=True,
              amp="bfloat16")
    t0 = time.perf_counter()
    h1 = m.fit(ds, 1, prefetch_to_device=2)
    e1 = time.perf_counter() - t0
    ckdir = os.path.join(root, "ckpt")
    t0 = time.perf_counter()
    path = m.save_checkpoint(ckdir, step=FIT_BATCHES, async_save=True)
    save_s = time.perf_counter() - t0
    pending = overlap.pending_checkpoints()
    torch.cuda.synchronize()
    A.reset_launches()
    t0 = time.perf_counter()
    h2 = m.fit(ds, 1, prefetch_to_device=2)
    e2 = time.perf_counter() - t0
    counts = dict(A.LAUNCHES)
    t0 = time.perf_counter()
    overlap.wait_for_checkpoints()
    wait_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))
    print(f"  bench GPT fit, graph mode ({m.graph_backend}), prefetch 2: "
          f"epoch 1 loss {h1[0]:.4f} in {e1:.2f} s (warm-up and capture "
          f"included); save_checkpoint(async) returned in {save_s:.2f} s "
          f"with {pending} write pending; epoch 2 loss {h2[0]:.4f} in "
          f"{e2:.2f} s ({FIT_BATCHES * TRAIN_B * TRAIN_S / e2:.0f} tokens/s, "
          f"the write overlapping); the write done {wait_s:.2f} s later, "
          f"{size / 2**30:.2f} GiB")
    check_launches("fit epoch 2 (replays)", counts,
                   {"flash_fwd": L * FIT_BATCHES,
                    "flash_bwd_fused": L * FIT_BATCHES})
    fresh = models.create_model("gpt", device="cuda", seed=SEED + 1,
                                **FIT_GPT)
    fresh.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    fresh.compile([next(iter(ds))[0].cuda()], is_train=True, use_graph=True,
                  amp="bfloat16")
    t0 = time.perf_counter()
    fresh.load_checkpoint(path)
    load_s = time.perf_counter() - t0
    h2r = fresh.fit(ds, 1, prefetch_to_device=2)
    print(f"  load_checkpoint into a fresh bench GPT {load_s:.2f} s; its "
          f"epoch 2 loss {h2r[0]:.6f} against {h2[0]:.6f} uninterrupted "
          f"(bf16, printed only: relative difference "
          f"{abs(h2r[0] - h2[0]) / abs(h2[0]):.3e})")
    del fresh
    states = m._raw_states()
    # the snapshot's rows: the states in name order up to a SNAP_SHARE-th
    # of their bytes
    total = sum(t.numel() * t.element_size() for t in states.values())
    kept, nbytes = {}, 0
    for k in sorted(states):
        if nbytes and nbytes + states[k].numel() * states[k].element_size() \
                > total / SNAP_SHARE:
            break
        kept[k] = states[k]
        nbytes += states[k].numel() * states[k].element_size()
    print(f"  snapshot rows: {len(kept)} of {len(states)} states, "
          f"{nbytes / 2**20:.0f} of {total / 2**20:.0f} MiB")
    states = kept
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = {k: t.detach().cpu() for k, t in states.items()}
    d2h_s = time.perf_counter() - t0
    print(f"  the bench GPT's {len(states)} states, {nbytes / 2**20:.0f} "
          f"MiB, device to host in {d2h_s:.2f} s "
          f"({nbytes / 2**20 / d2h_s:.0f} MB/s)")
    for backend, snap in (("native", os.path.join(root, "gpt_states")),
                          ("npz", os.path.join(root, "gpt_states.npz"))):
        t0 = time.perf_counter()
        with snapshot.Snapshot(snap, True) as sn:
            for k, t in host.items():
                sn.write(k, t)
        w_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = snapshot.Snapshot(snap, False)
        r_s = time.perf_counter() - t0
        bad = [k for k, t in host.items() if not torch.equal(back.read(k)
                                                             .data, t)]
        print(f"  snapshot.Snapshot ({backend}) from host copies: written "
              f"in {w_s:.2f} s ({nbytes / 2**20 / w_s:.0f} MB/s), read in "
              f"{r_s:.2f} s ({nbytes / 2**20 / r_s:.0f} MB/s); equal: "
              f"{not bad}")
        if bad:
            fail(f"snapshot round trip ({backend}) changed {bad[:3]}")
        del back
    if not os.path.exists(os.path.join(root, "gpt_states.bin")):
        fail("the snapshot did not take the native (.bin) backend")
    del m, states, host
    torch.cuda.empty_cache()

    # the resumed run held to the uninterrupted one: the fp32 GPT of 6b
    cfg = dict(vocab_size=8192, max_seq=256, dim=512, num_heads=8,
               num_layers=2)
    rec = os.path.join(root, "small.rio")
    _write_records(sio, rec, 4, 2, 256, cfg["vocab_size"], SEED + 15)
    ds = RecordBatches(sio, rec, 2, 256)

    def build(seed):
        g = models.create_model("gpt", device="cuda", seed=seed, **cfg)
        g.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        g.compile([next(iter(ds))[0].cuda()], is_train=True, use_graph=True)
        return g

    full = build(SEED + 5).fit(ds, 2, prefetch_to_device=2)
    a = build(SEED + 5)
    first = a.fit(ds, 1, prefetch_to_device=2)
    path = a.save_checkpoint(os.path.join(root, "ckpt_small"), step=4)
    b = build(SEED + 8)
    b.load_checkpoint(path)
    resumed = b.fit(ds, 1, prefetch_to_device=2)
    rel = abs(resumed[0] - full[1]) / abs(full[1])
    print(f"  fp32 GPT (dim 512, 2 layers, S 256), 4 batches: "
          f"uninterrupted epochs {[round(v, 6) for v in full]}; epoch 1 "
          f"{first[0]:.6f}, then save, load into a fresh model, epoch 2 "
          f"{resumed[0]:.6f}: relative difference {rel:.3e} (tol "
          f"{GRAPH_TOL}); bitwise equal: {resumed[0] == full[1]}")
    if not rel <= GRAPH_TOL:
        fail("the resumed run's loss differs from the uninterrupted run's")
    return counts


# ---------------------------------------------------------------------------
# phases 9-10: MoE-GPT training and serving, the recurrences
# README.md's MoE-GPT (8 experts, top-2, capacity factor 1.25) at
# GPT-2-small's width and depth: ~560 M parameters
MOE_GPT = dict(GPT2_SMALL, moe_experts=8, moe_k=2, moe_capacity_factor=1.25)
MOE_STEPS = 5
# kernel categories of the MoE step's profile, tried in order: the flash
# kernels, the fp32 GEMMs (the experts' bmm and the router's product:
# TF32 is off, and the attention and head products are bf16), and the
# routing's indexing, sort, scan and softmax kernels
MOE_CATS = (("flash kernels", ("flash_fwd_kernel", "flash_bwd_",
                               "scale_cast_kernel")),
            ("expert bmm (fp32 gemm)", ("sgemm", "f32f32", "simt",
                                        "gemm_f32", "gemmSN")),
            ("router/dispatch/combine", ("index", "gather", "scatter",
                                         "Sort", "sort", "scan", "Scan",
                                         "cumsum", "softmax", "logsumexp",
                                         "one_hot")))
# bench_ops.py's LSTM and GRU cases: T 128, B 32, F 512, H 512, fp32
RNN_T, RNN_B, RNN_F, RNN_H = 128, 32, 512, 512
# examples/rnn/char_rnn.py's model and batch (vocab: a 65-symbol corpus)
CHAR_V, CHAR_H, CHAR_B, CHAR_S = 65, 128, 32, 100


def _overflows(m):
    return [round(float(b.moe.overflow), 4) for b in m.blocks]


def phase_moe_train(torch, models, opt, A):
    """MoE-GPT training at full width, bf16 amp, SGD: 1 warm-up and
    MOE_STEPS timed eager steps with exact K1/K2a counts, then a second
    model from the same seed as a CUDA graph (warm-up, capture) and
    MOE_STEPS replays with exact counts per replay; the graph step under
    the profiler, and one layer's expert FFN (forward and backward) timed
    alone. Returns the two counted windows' sum."""
    print("== phase 9: MoE-GPT training (GPT-2-small, 8 experts, top-2, "
          "cf 1.25), bf16 amp, SGD")
    L, V = MOE_GPT["num_layers"], MOE_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 11))
    runs, counts = {}, {}
    for graph in (False, True):
        t0 = time.perf_counter()
        m = models.create_model("gpt", device="cuda", seed=SEED, **MOE_GPT)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([tx], is_train=True, use_graph=graph, amp="bfloat16")
        label = "graph" if graph else "eager"
        first, first_ms = _steps(torch, m, tx, ty, 2 if graph else 1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        losses, ms = _steps(torch, m, tx, ty, MOE_STEPS)
        counts[label] = dict(A.LAUNCHES)
        step = statistics.median(ms)
        print(f"  {label}: {sum(p.numel() for p in m.parameters())} "
              f"parameters, built in {time.perf_counter() - t0:.1f} s "
              f"with its first steps; first steps "
              f"{', '.join(f'{x:.1f}' for x in first_ms)} ms"
              + (" (eager warm-up, then capture and first replay)"
                 if graph else " (warm-up)")
              + f"; {MOE_STEPS} {'replays' if graph else 'timed steps'}: "
              f"losses {', '.join(f'{x:.4f}' for x in losses)}; step ms "
              f"{', '.join(f'{x:.2f}' for x in ms)}; median {step:.2f} ms, "
              f"{TRAIN_B * TRAIN_S / step * 1e3:.0f} tokens/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"overflow by layer {_overflows(m)}")
        check_launches(f"MoE training ({label})", counts[label],
                       {"flash_fwd": L * MOE_STEPS,
                        "flash_bwd_fused": L * MOE_STEPS})
        if graph and m.graph_backend != "cuda_graph":
            fail(f"graph mode ran {m.graph_backend!r}, not a CUDA graph")
        # the router losses are in the loss: it exceeds the bare
        # cross-entropy of the same forward by their weighted sum
        with torch.no_grad():
            m.eval()
            logits = m(tx)
            ce = float(m.sce(logits.reshape(-1, V), ty.reshape(-1)))
            extra = float(m._moe_losses(torch.zeros((), device="cuda")))
            m.train()
        print(f"    eval forward: cross-entropy {ce:.4f}, router losses "
              f"aux*{m.moe_aux_weight} + z*{m.moe_z_weight} summed over "
              f"the blocks {extra:.5f}")
        if not (extra > 0 and np.isfinite(ce)):
            fail("the MoE router losses are not in the training loss")
        runs[label] = first + losses
        if not graph:
            del m
            torch.cuda.empty_cache()
    le, lg, mg = runs["eager"], runs["graph"], m
    rel = max(abs(a - b) / abs(a) for a, b in zip(le, lg))
    print(f"  eager against graph from the same weights, bf16: losses "
          f"max relative difference {rel:.3e} (printed: phase 8's rule "
          f"holds fp32 steps to {GRAPH_TOL}, phase 9b does so for MoE)")
    _breakdown(torch, "MoE graph train step b8 s1024 bf16",
               lambda: mg(tx, ty)[1].item(), MOE_CATS, require=TC_KERNELS)
    del mg, m
    torch.cuda.empty_cache()
    # one layer's experts alone, at this step's capacity: forward and
    # backward of the two fp32 bmm and the GELU
    from singa_tpu_torch.parallel import moe as pmoe
    E, D = MOE_GPT["moe_experts"], MOE_GPT["dim"]
    C = int(TRAIN_B * TRAIN_S * 2 * 1.25 / E)
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    xs = [torch.randn(s, generator=g, device="cuda", requires_grad=True)
          for s in ((E, C, D), (E, D, 4 * D), (E, 4 * D), (E, 4 * D, D),
                    (E, D))]

    def experts():
        out = pmoe._expert_ffn(*xs, pmoe._gelu)
        torch.autograd.grad(out.sum(), xs)

    ms = time_ms(torch, experts, n=5, warm=1)
    flops = 6 * 2 * E * C * D * 4 * D
    print(f"  one layer's expert FFN fwd+bwd alone (E {E}, C {C}, D {D}, "
          f"H {4 * D}, fp32): {ms:.2f} ms, {flops / ms / 1e9:.1f} TFLOP/s; "
          f"x{L} layers {ms * L:.1f} ms a step")
    del xs
    torch.cuda.empty_cache()
    return {k: counts["eager"][k] + counts["graph"][k]
            for k in counts["eager"]}


def phase_moe_fp32(torch, models, opt, transformer):
    """fp32 MoE-GPT (dim 512, 2 layers, 4 experts, top-2, cf 1.25, so
    routes drop) on the card against the CPU from identical weights,
    three SGD steps (TRAIN_TOL); then the card's graph step against its
    eager step, six steps (GRAPH_TOL)."""
    print("== phase 9b: fp32 MoE-GPT, card against CPU, graph against "
          "eager")
    cfg = dict(vocab_size=8192, max_seq=256, dim=512, num_heads=8,
               num_layers=2, moe_experts=4, moe_k=2,
               moe_capacity_factor=1.25)
    tx, ty = _train_batch(torch, cfg["vocab_size"], 4, 256, SEED + 13)
    mc = models.create_model("gpt", device="cpu", seed=SEED + 14, **cfg)
    weights = {k: p.detach().numpy().copy()
               for k, p in mc._raw_params().items()}
    runs = {}
    for label, dev, graph in (("cpu", "cpu", False), ("card", "cuda", False),
                              ("card graph", "cuda", True)):
        m = mc if dev == "cpu" else models.create_model(
            "gpt", device=dev, seed=SEED + 15, **cfg)
        transformer.load_singa_params(m, weights)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([tx.to(dev)], is_train=True, use_graph=graph)
        runs[label] = (m, _steps(torch, m, tx.to(dev), ty.to(dev), 3)[0])
        if label == "card":
            # the CPU's 3 steps against the card's, then 3 more for the
            # graph comparison
            rel = max(abs(a - b) / abs(a)
                      for a, b in zip(runs["cpu"][1], runs["card"][1]))
            pc = mc._raw_params()
            perr = max(float((q.detach().cpu() - pc[k].detach()).abs().max())
                       for k, q in m._raw_params().items())
            print(f"  losses card {[round(x, 6) for x in runs['card'][1]]}, "
                  f"CPU {[round(x, 6) for x in runs['cpu'][1]]}: max "
                  f"relative difference {rel:.3e}; params after 3 steps "
                  f"max abs difference {perr:.3e} (tol {TRAIN_TOL} each); "
                  f"overflow by layer at the last step: CPU "
                  f"{_overflows(mc)}, card {_overflows(m)}")
            if not (rel <= TRAIN_TOL and perr <= TRAIN_TOL):
                fail("fp32 MoE training on the card differs from the CPU")
        if dev == "cuda":
            runs[label][1].extend(_steps(torch, m, tx.to(dev), ty.to(dev),
                                         EXACT_STEPS - 3)[0])
    (me, le), (mg, lg) = runs["card"], runs["card graph"]
    if mg.graph_backend != "cuda_graph":
        fail(f"graph mode ran {mg.graph_backend!r}, not a CUDA graph")
    grel = max(abs(a - b) / abs(a) for a, b in zip(le, lg))
    serr, same = _compare_states(torch, me._raw_states(), mg._raw_states())
    print(f"  card graph against eager, {EXACT_STEPS} steps: losses max "
          f"relative difference {grel:.3e}, parameters max abs difference "
          f"{serr:.3e} (tol {GRAPH_TOL} each); bitwise equal: "
          f"{same and le == lg}")
    if not (grel <= GRAPH_TOL and serr <= GRAPH_TOL):
        fail("the MoE-GPT's CUDA-graph step differs from its eager step")
    del runs, mc, me, mg, m
    torch.cuda.empty_cache()


def _gpt2_state(cfg, seed):
    """A random GPT-2-convention state dict (torch layouts) for `cfg`."""
    rng = np.random.default_rng(seed)
    E, V, L = cfg["dim"], cfg["vocab_size"], cfg["num_layers"]

    def r(*shape, scale=0.02):
        return (rng.standard_normal(shape, dtype=np.float32) * scale)

    st = {"wte.weight": r(V, E), "wpe.weight": r(cfg["max_seq"], E,
                                                 scale=0.01),
          "ln_f.weight": 1.0 + r(E, scale=0.1), "ln_f.bias": r(E)}
    for i in range(L):
        p = f"blocks.{i}."
        st.update({p + "ln1.weight": 1.0 + r(E, scale=0.1),
                   p + "ln1.bias": r(E), p + "ln2.weight": 1.0 + r(E,
                                                                  scale=0.1),
                   p + "ln2.bias": r(E), p + "attn.weight": r(3 * E, E),
                   p + "attn.bias": r(3 * E), p + "proj.weight": r(E, E),
                   p + "proj.bias": r(E), p + "ff1.weight": r(4 * E, E),
                   p + "ff1.bias": r(4 * E), p + "ff2.weight": r(E, 4 * E),
                   p + "ff2.bias": r(E)})
    return st


#: 9c's depth: new tokens of `generate` at both capacity factors (cut
#: from 128 to make room for phase 20)
MOE_NEW = 32


def phase_moe_serve(torch, models, engine, serving, transformer, A):
    """MoE-GPT serving at phase 9's width, random weights from SEED:
    generate (b8, prompt 128, +MOE_NEW, bf16) at the layers' capacity factor
    and at 8 (no drops), +32 with int8 weights and with an int4 cache; the
    engine (8 requests of prompt 256, +32, 8 slots, page 16); exact K1,
    K3 and K4 counts; fp32 teacher-forced logits, kernels against plain;
    then a random GPT-2-convention state through load_gpt2_weights into
    GPT-2-small on the card and on the CPU."""
    print("== phase 9c: MoE-GPT serving, bf16")
    part = Clock()
    model = models.create_model("gpt", device="cuda", seed=SEED, **MOE_GPT)
    L, V = MOE_GPT["num_layers"], MOE_GPT["vocab_size"]
    E = MOE_GPT["moe_experts"]
    rng = np.random.RandomState(SEED + 16)
    prompts = rng.randint(0, V, (8, 128)).astype(np.int32)
    B, S0 = prompts.shape
    model.generate(prompts[:, :8], 2, dtype="bfloat16")
    part.lap("9c: model and warm-up")
    counts = {}
    # +MOE_NEW at both capacity factors, +32 with int8 weights and an
    # int4 cache
    for what, new, kw in (
            ("generate", MOE_NEW, {}),
            ("generate cf 8", MOE_NEW, {"moe_capacity_factor": float(E)}),
            ("generate int8 weights", 32, {"dtype": "int8"}),
            ("generate kv int4", 32, {"kv_dtype": "int4"})):
        kw = dict({"dtype": "bfloat16"}, **kw)
        t0 = time.perf_counter()
        out, got, _ = window(torch, A, lambda: model.generate(prompts, new,
                                                              **kw))
        s = time.perf_counter() - t0
        if out.shape != (B, S0 + new) or not ((out >= 0) & (out < V)).all():
            fail(f"MoE {what} returned {out.shape} / out-of-vocab tokens")
        print(f"  MoE {what}: b{B}, prompt {S0}, +{new}: {s:.3f} s, "
              f"{B * new / s:.1f} tok/s")
        check_launches(f"MoE {what}", got, {"flash_fwd": L,
                                            "flash_decode": L * (new - 1)})
        counts[what] = got
    part.lap("9c: generate")
    gen = {k: sum(c[k] for c in counts.values()) for k in A.LAUNCHES}
    reqs_in = [(rng.randint(0, V, (256,)).astype(np.int32), 32)
               for _ in range(8)]
    (reqs, wall, _, steps), eng, _ = window(
        torch, A, lambda: serve(engine, model, reqs_in, max_slots=8,
                                dtype="bfloat16"))
    ntok = sum(len(r.tokens) for r in reqs)
    print(f"  MoE engine: {len(reqs)} requests, {ntok} tokens, {wall:.3f} "
          f"s, {ntok / wall:.1f} tok/s, median TTFT "
          f"{statistics.median(r.ttft_s for r in reqs) * 1e3:.1f} ms, "
          f"{steps} steps")
    check_launches("MoE engine", eng, {"flash_fwd": L * len(reqs),
                                       "paged_attention": L * steps})
    part.lap("9c: engine")
    # +8: the profiler's cost grows with a run's events, and at +32
    # these two profiles took most of the phase's time
    _breakdown(torch, "MoE generate b8 prompt 128 +8",
               lambda: model.generate(prompts, 8, dtype="bfloat16"),
               require=K3_KERNELS)
    _breakdown(torch, "MoE engine 8 requests prompt 256 +8",
               lambda: serve(engine, model,
                             [(p, 8) for p, _ in reqs_in], timeout_s=300,
                             max_slots=8, dtype="bfloat16"),
               require=K4_KERNELS)
    part.lap("9c: profiles")

    # fp32 teacher-forced: kernels against plain, dense and paged
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    n, S0, steps_tf, ps = 4, 128, 32, 16
    prompt = torch.randint(0, V, (n, S0), generator=g, device=dev)
    feed = torch.randint(0, V, (n, steps_tf), generator=g, device=dev)
    core = serving._decode_core(model, S0, steps_tf)

    def dense(p, use_kernel):
        logits, caches = core.prefill(p, prompt, n, use_kernel)
        out = [logits]
        for i in range(steps_tf):
            logits, caches = core.token_step(p, feed[:, i], caches, i, n,
                                             use_kernel)
            out.append(logits)
        return torch.stack(out, 1).float(), caches

    def paged(p, caches, use_kernel):
        pools, pt = _pools_from_dense(
            torch, caches, ps, torch.Generator(device=dev).manual_seed(7))
        active = torch.ones(n, dtype=torch.bool, device=dev)
        out = []
        for i in range(steps_tf):
            lens = torch.full((n,), S0 + i, dtype=torch.int32, device=dev)
            logits, pools = core.paged_token_step(
                p, feed[:, i], pools, pt, lens, active, n, ps, use_kernel)
            out.append(logits)
        return torch.stack(out, 1).float()

    with torch.no_grad():
        p32 = serving.decode_state(model, None)
        (dk, _), (dp, _) = dense(p32, None), dense(p32, False)
        _, pre = core.prefill(p32, prompt, n)
        pk = paged(p32, [tuple(t.clone() for t in c) for c in pre], None)
        pp = paged(p32, pre, False)
        torch.cuda.synchronize()
    d_err = float((dk - dp).abs().max())
    p_err = float((pk - pp).abs().max())
    print(f"  MoE fp32 teacher-forced (prefill {n} x {S0}, {steps_tf} "
          f"steps): dense kernel vs plain {d_err:.3e}, paged kernel vs "
          f"plain {p_err:.3e} (tol {LOGIT_TOL})")
    if not (d_err <= LOGIT_TOL and p_err <= LOGIT_TOL):
        fail("MoE fp32 teacher-forced logits differ, kernels vs plain")
    del model, p32
    torch.cuda.empty_cache()
    part.lap("9c: teacher-forced")

    # load_gpt2_weights: GPT-2-small on the card and on the CPU
    st = _gpt2_state(GPT2_SMALL, SEED + 18)
    x = rng.randint(0, GPT2_SMALL["vocab_size"], (2, 64)).astype(np.int64)
    logits = {}
    for dev in ("cuda", "cpu"):
        m = models.create_model("gpt", device=dev, seed=SEED + 19,
                                **GPT2_SMALL)
        transformer.load_gpt2_weights(m, st)
        with torch.no_grad():
            logits[dev] = m(torch.as_tensor(x, device=dev)).float().cpu()
        del m
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    print(f"  load_gpt2_weights into GPT-2-small: logits card vs CPU max "
          f"abs difference {err:.3e} (tol {LOGIT_TOL})")
    if not err <= LOGIT_TOL:
        fail("GPT-2 weights give different logits on the card and CPU")
    torch.cuda.empty_cache()
    part.lap("9c: load_gpt2_weights")
    return gen, eng


def _rnn_inputs(torch, name, w_std=None):
    """A recurrence's inputs at bench_ops.py's shape, from SEED + 20:
    x N(0, 1), states N(0, 0.25), bias 0.1, the weights at their
    initializers' scale (1/sqrt(fan_in)) or, with `w_std`, N(0, w_std^2);
    and the (T, B, H) weights of the scalar loss."""
    g = torch.Generator().manual_seed(SEED + 20)
    gates = 4 if name == "lstm_scan" else 3
    shapes = [(RNN_T, RNN_B, RNN_F), (RNN_B, RNN_H), (RNN_B, RNN_H),
              (RNN_F, gates * RNN_H), (RNN_H, gates * RNN_H),
              (gates * RNN_H,)]
    scale = [1.0, 0.5, 0.5, w_std or RNN_F ** -0.5, w_std or RNN_H ** -0.5,
             0.1]
    if name != "lstm_scan":
        shapes.pop(2)
        scale.pop(2)
    host = [torch.randn(s, generator=g) * c for s, c in zip(shapes, scale)]
    return host, torch.randn((RNN_T, RNN_B, RNN_H), generator=g)


def _rnn_grads(torch, run, host, w, dev, dtype):
    """The outputs and the gradients of sum(ys * w) with respect to every
    input, on `dev` in `dtype`, returned in fp64 on the CPU."""
    xs = [t.to(dev, dtype).requires_grad_() for t in host]
    ys = run(*xs)[0]
    grads = torch.autograd.grad((ys * w.to(dev, dtype)).sum(), xs)
    return [t.detach().cpu().double() for t in (ys,) + tuple(grads)]


def _rel(a, b):
    """max over the tensors of max|a - b| / max|b|."""
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def _rnn_errors(torch, run, host, w):
    """(card vs CPU, card vs CPU fp64, CPU vs CPU fp64, the largest fp64
    gradient): `run`'s outputs and gradients, card and CPU in fp32."""
    card = _rnn_grads(torch, run, host, w, "cuda", torch.float32)
    cpu = _rnn_grads(torch, run, host, w, "cpu", torch.float32)
    ref = _rnn_grads(torch, run, host, w, "cpu", torch.float64)
    return (_rel(card, cpu), _rel(card, ref), _rel(cpu, ref),
            max(float(t.abs().max()) for t in ref[1:]))


def _rnn_case(torch, name, run, lib):
    """One recurrence at bench_ops.py's shape: forward and backward on
    the card against the CPU in fp32 and against the CPU in fp64 (each
    1e-4 of max|ref|), its time beside the cuDNN module's at the same
    shape (library_ms). For lstm_scan also, printed, the same three
    comparisons at weights of std 0.5: there the recurrence is chaotic
    over 128 steps (gradients ~1e13), and fp32 on the CPU parts from fp64
    as far as the card does, so the checked run uses the initializers'
    scale."""
    host, w = _rnn_inputs(torch, name)
    err, err64, cpu64, _ = _rnn_errors(torch, run, host, w)
    xs = [t.cuda().requires_grad_() for t in host]
    wc = w.cuda()

    def ours():
        torch.autograd.grad((run(*xs)[0] * wc).sum(), xs)

    mod = lib(RNN_F, RNN_H).cuda()
    xl = xs[0].detach().clone().requires_grad_()

    def cudnn():
        out = mod(xl)[0]
        torch.autograd.grad((out * wc).sum(), [xl] + list(mod.parameters()))

    ms, lib_ms = time_ms(torch, ours, n=5, warm=1), time_ms(torch, cudnn,
                                                            n=5, warm=1)
    tok = RNN_T * RNN_B
    print(f"  {name} fwd+bwd (T {RNN_T}, B {RNN_B}, F {RNN_F}, H {RNN_H}, "
          f"fp32): card vs CPU {err:.3e}, card vs CPU fp64 {err64:.3e}, CPU "
          f"vs CPU fp64 {cpu64:.3e} of max|ref| (tol {TRAIN_TOL}); "
          f"{ms:.2f} ms ({tok / ms * 1e3:.0f} tokens/s), library "
          f"(cuDNN torch.nn.{lib.__name__}) {lib_ms:.2f} ms")
    if not (err <= TRAIN_TOL and err64 <= TRAIN_TOL):
        fail(f"{name} on the card differs from the CPU")
    if name != "lstm_scan":
        return
    err, err64, cpu64, big = _rnn_errors(torch, run,
                                         *_rnn_inputs(torch, name, 0.5))
    print(f"    weights std 0.5 (printed): card vs CPU {err:.3e}, card vs "
          f"CPU fp64 {err64:.3e}, CPU vs CPU fp64 {cpu64:.3e} of max|ref|; "
          f"largest fp64 gradient {big:.3e}")


def phase_rnn(torch, layer, model, opt, autograd, tensor, device):
    """The recurrences: lstm_scan and gru_scan at bench_ops.py's shape,
    card against CPU and beside cuDNN; then examples/rnn/char_rnn.py's
    model (Embedding, CudnnRNN, Linear) trained 5 steps eager and 5 as a
    CUDA graph from the same weights (GRAPH_TOL), ms a step."""
    print("== phase 10: the recurrences (ops.rnn, CudnnRNN), fp32")
    from singa_tpu_torch.ops import rnn
    _rnn_case(torch, "lstm_scan", rnn.lstm_scan, torch.nn.LSTM)
    _rnn_case(torch, "gru_scan", rnn.gru_scan, torch.nn.GRU)

    class CharRNN(model.Model):
        def __init__(self):
            super().__init__()
            self.embed = layer.Embedding(CHAR_V, CHAR_H)
            self.lstm = layer.CudnnRNN(CHAR_H)
            self.dense = layer.Linear(CHAR_V)
            self.sce = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            ys, _, _ = self.lstm(self.embed(x))
            return self.dense(autograd.reshape(ys, (-1, CHAR_H)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.sce(out, y)
            self.optimizer(loss)
            return out, loss

    dev = device.best_device()
    rng = np.random.RandomState(SEED + 21)
    data = rng.randint(0, CHAR_V, CHAR_B * CHAR_S + 1).astype(np.int32)
    x = np.ascontiguousarray(data[:-1].reshape(CHAR_B, CHAR_S).T)
    y = np.ascontiguousarray(data[1:].reshape(CHAR_B, CHAR_S).T.ravel())
    tx, ty = tensor.from_numpy(x, device=dev), tensor.from_numpy(y,
                                                                 device=dev)
    runs, states = {}, None
    for graph in (False, True):
        m = CharRNN()
        m.set_optimizer(opt.SGD(lr=0.5, momentum=0.9))
        m.compile([tx], is_train=True, use_graph=graph)
        if states is None:
            states = {k: v.detach().clone() for k, v in
                      m._raw_states().items()}
        else:
            m.set_states(states)
        losses, ms = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            losses.append(float(m(tx, ty)[1].numpy()))
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[graph] = (m, losses, ms)
    (me, le, mse), (mg, lg, msg) = runs[False], runs[True]
    if mg.graph_backend != "cuda_graph" or not np.isfinite(le + lg).all():
        fail(f"char-RNN graph ran {mg.graph_backend!r}, losses {le} {lg}")
    rel = max(abs(a - b) / abs(a) for a, b in zip(le, lg))
    serr, _ = _compare_states(torch, me._raw_states(), mg._raw_states())
    tok = CHAR_B * CHAR_S
    for label, ls, ms in (("eager", le, mse), ("graph", lg, msg)):
        print(f"  char-RNN (vocab {CHAR_V}, CudnnRNN({CHAR_H}), b{CHAR_B} x "
              f"{CHAR_S}) {label}: losses "
              f"{', '.join(f'{v:.4f}' for v in ls)}; step ms "
              f"{', '.join(f'{v:.2f}' for v in ms)}; last 3 median "
              f"{statistics.median(ms[2:]):.2f} ms, "
              f"{tok / statistics.median(ms[2:]) * 1e3:.0f} tokens/s")
    print(f"  char-RNN graph against eager: losses max relative difference "
          f"{rel:.3e}, states max abs difference {serr:.3e} (tol "
          f"{GRAPH_TOL} each)")
    if not (rel <= GRAPH_TOL and serr <= GRAPH_TOL):
        fail("the char-RNN's CUDA-graph step differs from its eager step")


# ---- phase 11: ONNX export and import (sonnx) --------------------------------
# imported graph against the exporting model's (or torch's) forward, max
# abs error over max |ref|, fp32 with TF32 off: the same math in another
# order (MatMul/Softmax in place of K1, a folded batch norm in 11c)
ONNX_TOL = 1e-4
ONNX_B, ONNX_S = 2, 128          # 11a's GPT-2-small batch
ONNX_RESNET_B = 8                # 11b's ResNet-50 batch (224 x 224)
ONNX_STEPS = 6                   # 11b's SGD steps, eager and as a graph
ONNX_GPT_OPS = {"MatMul", "Softmax", "Tanh", "LayerNormalization", "Gather"}


def _max_rel(got, ref):
    """max |got - ref| / max |ref| (fp32)."""
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).abs().max() / ref.abs().max())


def _run_eval(autograd, rep, xs):
    prev = autograd.training
    autograd.training = False
    try:
        return rep.run(xs)
    finally:
        autograd.training = prev


def _onnx_gpt(torch, model, sonnx, tensor, autograd, A, dev, root):
    """11a: GPT-2-small traced on the tape and exported (K1 once per layer
    in the trace, counted in its own window), read back and run on the
    card against the raw forward."""
    L = GPT2_SMALL["num_layers"]
    print(f"  11a: GPT-2-small ({sum(p.numel() for p in model.parameters())} "
          f"parameters, random weights from seed {SEED}), ids b{ONNX_B} x "
          f"{ONNX_S}, fp32")
    rng = np.random.RandomState(SEED + 21)
    ids = rng.randint(0, GPT2_SMALL["vocab_size"],
                      (ONNX_B, ONNX_S)).astype(np.int32)
    with torch.no_grad():
        ref = model.forward(torch.from_numpy(ids).to(model.device))
    tx = tensor.from_numpy(ids, device=dev)
    path = os.path.join(root, "gpt2_small.onnx")
    torch.cuda.synchronize()
    A.reset_launches()
    t0 = time.perf_counter()
    proto = sonnx.export(model, [tx], path)
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    counts = dict(A.LAUNCHES)
    check_launches("onnx_export (sonnx.export of GPT-2-small)", counts,
                   {"flash_fwd": L})
    # the codec's write alone: the same model saved a second time over
    # the file export wrote
    t0 = time.perf_counter()
    sonnx.save_model(proto, path)
    t_save = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    ops = {n.op_type for n in proto.graph.node}
    print(f"  exported {len(proto.graph.node)} nodes, "
          f"{len(proto.graph.initializer)} initializers, "
          f"{len(proto.graph.input)} graph input(s); {mb:.1f} MB")
    if not ONNX_GPT_OPS <= ops or len(proto.graph.input) != 1:
        fail(f"GPT-2-small's graph lacks {sorted(ONNX_GPT_OPS - ops)} or "
             f"has {len(proto.graph.input)} inputs")
    del proto
    t0 = time.perf_counter()
    loaded = sonnx.load_model(path)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = sonnx.prepare(loaded, dev)
    torch.cuda.synchronize()
    t_prepare = time.perf_counter() - t0
    out = _run_eval(autograd, rep, [tx])[0]
    run_ms = time_ms(torch, lambda: _run_eval(autograd, rep, [tx]), n=5,
                     warm=1, device=False)
    err = _max_rel(out.data, ref)
    print(f"  export (trace, graph and file) {t_export:.2f} s; the save "
          f"alone, a second write of the same model, {t_save:.2f} s; "
          f"load {t_load:.2f} s; prepare "
          f"{t_prepare:.2f} s; imported run {run_ms:.2f} ms (events "
          f"around the call); logits max abs error {err:.3e} of max "
          f"|ref| (tol {ONNX_TOL})")
    if not err <= ONNX_TOL:
        fail("the imported GPT-2-small disagrees with the model")
    del rep, loaded
    os.remove(path)
    return counts


def _retrainer(sonnx, layer, proto, dev):
    class Retrain(sonnx.SONNXModel):
        def __init__(self):
            super().__init__(proto, dev)
            self.sce = layer.SoftMaxCrossEntropy()

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.sce(out, y)
            self.optimizer(loss)
            return out, loss
    return Retrain()


def _onnx_resnet(torch, models, opt, layer, tensor, autograd, sonnx, dev,
                 root):
    """11b: the zoo's ResNet-50 exported and imported (eval logits
    against its own forward), then retrained as a SONNXModel, eagerly and
    as a CUDA graph from the same file, on cuDNN's deterministic
    algorithms."""
    B = ONNX_RESNET_B
    print(f"  11b: ResNet-50 (zoo, {RESNET_CLASSES} classes), b{B} x 3 x "
          f"{RESNET_HW} x {RESNET_HW}, fp32")
    rng = np.random.RandomState(SEED + 22)
    x = rng.randn(B, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, B).astype(np.int32)
    tx = tensor.Tensor(data=x, device=dev)
    ty = tensor.from_numpy(y, device=dev)
    dev.SetRandSeed(SEED)
    m = models.create_model("resnet50", num_channels=3,
                            num_classes=RESNET_CLASSES)
    m.compile([tx], is_train=False, use_graph=False)
    ref = m(tx).data
    path = os.path.join(root, "resnet50.onnx")
    t0 = time.perf_counter()
    proto = sonnx.export(m, [tx], path)
    t_export = time.perf_counter() - t0
    del m
    rep = sonnx.prepare(sonnx.load_model(path), dev)
    err = _max_rel(_run_eval(autograd, rep, [tx])[0].data, ref)
    print(f"  exported {len(proto.graph.node)} nodes, "
          f"{os.path.getsize(path) / 1e6:.1f} MB in {t_export:.2f} s; "
          f"imported eval logits max abs error {err:.3e} of max |ref| "
          f"(tol {ONNX_TOL})")
    if not err <= ONNX_TOL:
        fail("the imported ResNet-50 disagrees with the model")
    del rep
    deterministic = torch.backends.cudnn.deterministic
    runs = {}
    try:
        torch.backends.cudnn.deterministic = True
        for label, graph in (("eager", False), ("graph", True)):
            rm = _retrainer(sonnx, layer, sonnx.load_model(path), dev)
            rm.set_optimizer(opt.SGD(lr=0.01, momentum=0.9))
            rm.compile([tx], is_train=True, use_graph=graph)
            losses, ms = _steps(torch, rm, tx, ty, ONNX_STEPS)
            runs[label] = (losses, ms, rm._raw_states(), rm.graph_backend)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (la, ma, sa, _), (lb, mb, sb, backend) = runs["eager"], runs["graph"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(la, lb))
    serr, same = _compare_states(torch, sa, sb)
    print(f"  SONNXModel retrain, SGD(0.01, 0.9), {ONNX_STEPS} steps, cuDNN "
          f"deterministic: eager losses "
          + ", ".join(f"{v:.5f}" for v in la)
          + f"; graph ({backend}) max relative loss difference {rel:.3e}, "
          f"parameters and running stats max abs difference {serr:.3e} "
          f"(tol {GRAPH_TOL} each); bitwise equal: {same and la == lb}")
    print(f"  ms a step (steps 3-{ONNX_STEPS}, host clock fenced by "
          f"loss.item()): eager {statistics.median(ma[2:]):.2f}, graph "
          f"{statistics.median(mb[2:]):.2f}")
    if backend != "cuda_graph":
        fail("the SONNXModel in graph mode did not run a CUDA graph")
    if not (rel <= GRAPH_TOL and serr <= GRAPH_TOL):
        fail("the SONNXModel's CUDA-graph steps differ from its eager steps")
    os.remove(path)


def _torch_resnet18(torch):
    """ResNet-18 at ImageNet widths as examples/onnx/resnet18.py builds it
    (its own copy: this script imports nothing from examples/)."""
    nn = torch.nn

    class Basic(nn.Module):
        def __init__(self, cin, cout, stride=1):
            super().__init__()
            self.c1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.b1 = nn.BatchNorm2d(cout)
            self.c2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.b2 = nn.BatchNorm2d(cout)
            self.down = None
            if stride != 1 or cin != cout:
                self.down = nn.Sequential(
                    nn.Conv2d(cin, cout, 1, stride, bias=False),
                    nn.BatchNorm2d(cout))

        def forward(self, x):
            idt = self.down(x) if self.down else x
            y = torch.relu(self.b1(self.c1(x)))
            return torch.relu(self.b2(self.c2(y)) + idt)

    class ResNet18(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                nn.Conv2d(3, 64, 7, 2, 3, bias=False), nn.BatchNorm2d(64),
                nn.ReLU(True), nn.MaxPool2d(3, 2, 1))
            blocks = []
            cin = 64
            for cout, stride in [(64, 1), (64, 1), (128, 2), (128, 1),
                                 (256, 2), (256, 1), (512, 2), (512, 1)]:
                blocks.append(Basic(cin, cout, stride))
                cin = cout
            self.blocks = nn.Sequential(*blocks)
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(512, 1000)

        def forward(self, x):
            y = self.pool(self.blocks(self.stem(x)))
            return self.fc(torch.flatten(y, 1))

    return ResNet18()


def _onnx_torch_resnet18(torch, sonnx, tensor, autograd, dev, root):
    """11c: a file from an independent producer: torch's TorchScript
    exporter (through sonnx.interop) writes a ResNet-18, the port imports
    and runs it on the card against torch's own forward."""
    from singa_tpu_torch.sonnx.interop import export_torch_module
    torch.manual_seed(SEED)
    tm = _torch_resnet18(torch)
    x = np.random.RandomState(SEED + 23).randn(2, 3, 224, 224) \
        .astype(np.float32)
    path = os.path.join(root, "resnet18_torch.onnx")
    t0 = time.perf_counter()
    export_torch_module(tm, torch.from_numpy(x), path, opset=13)
    t_export = time.perf_counter() - t0
    tm = tm.to(dev.torch_device).eval()
    with torch.no_grad():
        ref = tm(torch.from_numpy(x).to(dev.torch_device))
    loaded = sonnx.load_model(path)
    ops = sorted({n.op_type for n in loaded.graph.node})
    rep = sonnx.prepare(loaded, dev)
    out = _run_eval(autograd, rep, [tensor.Tensor(data=x, device=dev)])[0]
    err = _max_rel(out.data, ref)
    print(f"  11c: torch's ResNet-18 (ImageNet widths, b2 x 224 x 224) "
          f"exported by torch {torch.__version__} in {t_export:.2f} s, "
          f"{len(loaded.graph.node)} nodes ({', '.join(ops)}); imported "
          f"on the card: max abs error {err:.3e} of max |ref| against "
          f"torch's forward (tol {ONNX_TOL})")
    if not err <= ONNX_TOL:
        fail("the torch-exported ResNet-18 disagrees with torch")
    os.remove(path)


def _onnx_nonzero(torch, autograd, tensor, dev):
    """NonZero runs eagerly on the card and refuses a CUDA-graph
    capture with its message."""
    a = np.array([[0.0, 1.5, 0.0], [2.0, 0.0, -1.0]], np.float32)
    t = tensor.Tensor(data=a, device=dev)
    got = autograd.nonzero(t).data.cpu().numpy()
    if not np.array_equal(got, np.array(np.nonzero(a))):
        fail(f"NonZero on the card gave {got.tolist()}")
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            autograd.nonzero(t)
    except RuntimeError as e:
        if "cannot be captured" not in str(e):
            raise
        print(f"  NonZero eager on the card: {got.tolist()}; under a "
              f"capture it raises: {str(e)[:60]}...")
    else:
        fail("a CUDA graph captured NonZero")


def phase_onnx(torch, model, models, opt, layer, tensor, autograd, device,
               A, root):
    """Phase 11 (see the module's docstring); returns the export window's
    launch counts."""
    from singa_tpu_torch import sonnx
    print("== phase 11: ONNX export and import (sonnx)")
    dev = device.best_device()
    counts = _onnx_gpt(torch, model, sonnx, tensor, autograd, A, dev, root)
    _onnx_resnet(torch, models, opt, layer, tensor, autograd, sonnx, dev,
                 root)
    torch.cuda.empty_cache()
    _onnx_torch_resnet18(torch, sonnx, tensor, autograd, dev, root)
    _onnx_nonzero(torch, autograd, tensor, dev)
    return counts


# ---- phase 12: observe (metrics, spans) on the main paths -----------------

OBS_TURNS = 3                 # same-call turns of observe on and off
OBS_TRAIN_STEPS = 6           # 12b's graph-mode steps (skip 1 -> 5 fenced)
#: 12c: (example, its smallest arguments, timeout seconds, a line its run
#: must print), run unmodified through tests/test_torch_examples.py's
#: runner on the card: the examples that the API faults broke.
#: model_selection/ms_mlp.py is not among them: it reads scikit-learn's
#: digits, and the card's host has no scikit-learn; hfl/fedavg.py, which
#: fault 2 broke the same way, runs in its place (its clients are two
#: processes on the one card)
OBS_EXAMPLES = (("mlp/native.py", ["-m", "20"], 300, "epoch 19:"),
                ("hfl/fedavg.py", ["--clients", "2", "--rounds", "1",
                                   "--port", "{port}"], 300,
                 "[client0] round 0 local loss="),
                ("qabot/qabot_train.py", ["--epochs", "1"], 300,
                 "top-1 retrieval acc"),
                # the data-parallel example at one rank (no process
                # group: DistOpt is the identity); mnist is its synthetic
                # set there, digits needs scikit-learn
                ("cnn/train_cnn.py", ["cnn", "mnist", "-m", "1", "--dist",
                                      "--dist-option", "sparseTopK"], 300,
                 "epoch 0: eval acc="))
_PROM_SAMPLE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+$")


def _prometheus_lines(text):
    """Parse the exposition line by line (tests/test_observe.py's
    grammar): every line a # HELP/# TYPE header or a sample whose family
    has a # TYPE before it. Returns the number of samples; fails on any
    other line."""
    typed, n = set(), 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            if kind not in ("counter", "gauge", "histogram"):
                fail(f"exposition: bad # TYPE line {line!r}")
            typed.add(name)
            continue
        if line.startswith("# HELP "):
            continue
        base = line.split("{")[0].split(" ")[0]
        family = re.sub(r"_(bucket|sum|count)$", "", base)
        if not _PROM_SAMPLE.match(line) or not (base in typed
                                                or family in typed):
            fail(f"exposition: unparseable sample line {line!r}")
        n += 1
    return n


def _value(observe, name, **labels):
    m = observe.get_registry().get(name)
    if m is None:
        fail(f"metric {name} was never registered")
    return m.count(**labels) if m.kind == "histogram" else m.value(**labels)


def phase_observe_serve(torch, model, engine, observe, A):
    """12a: phase 5's engine run (GPT-2-small bf16, 8 slots, page 16, 8
    requests of prompt 256, +32) with observe on, under torch.profiler:
    exact K1/K4 counts, the singa_serve_* counts against the run, the
    engine spans in the profiler's events against the span histogram,
    the exposition parsed line by line; then the same run with observe
    on and off in turns (printed only: the engine is host-bound)."""
    print("== phase 12a: observe on the serving engine")
    from torch.profiler import ProfilerActivity, profile
    L = len(model.blocks)
    rng = np.random.RandomState(SEED + 12)
    reqs_in = [(rng.randint(0, model.vocab_size, (256,)).astype(np.int32),
                32) for _ in range(8)]
    kw = dict(timeout_s=300, max_slots=8, dtype="bfloat16")
    serve(engine, model, reqs_in[:1], **kw)        # warm
    observe.enable(True)
    observe.get_registry().reset()
    torch.cuda.synchronize()
    A.reset_launches()
    # the spans open on the engine's own thread: the profiler's
    # callbacks are per thread unless told to profile all threads
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=every_thread) as prof:
        reqs, wall, rep, steps = serve(engine, model, reqs_in, **kw)
        torch.cuda.synchronize()
    counts = dict(A.LAUNCHES)
    check_launches("observe serving", counts,
                   {"flash_fwd": L * len(reqs_in),
                    "paged_attention": L * steps})
    ntok = sum(len(r.tokens) for r in reqs)
    want = {("singa_serve_requests_total", "completed"): len(reqs_in),
            ("singa_serve_admitted_total", None): len(reqs_in),
            ("singa_serve_tokens_total", None): ntok,
            ("singa_serve_prefills_total", None): counts["flash_fwd"] // L,
            ("singa_serve_ttft_seconds", None): len(reqs_in),
            ("singa_serve_steps_total", None): steps}
    got = {k: _value(observe, k[0], **({"outcome": k[1]} if k[1] else {}))
           for k in want}
    print(f"  registry: {got} (expected {want})")
    if got != want:
        fail(f"singa_serve_* counts {got}, expected {want}")
    from torch.autograd import DeviceType
    h = observe.get_registry().get("singa_span_seconds")
    spans = {}
    for path in ("serving.engine_prefill", "serving.engine_step"):
        # the host-side range (the profiler also mirrors each range as
        # an event on the device's timeline)
        n_prof = sum(1 for e in prof.events()
                     if e.name == SPAN_PREFIX + path
                     and e.device_type == DeviceType.CPU)
        spans[path] = (n_prof, h.count(span=path))
    print(f"  spans (profiler events, histogram count): {spans}")
    if any(a != b or a == 0 for a, b in spans.values()):
        fail(f"profiler ranges and span histogram disagree: {spans}")
    n = _prometheus_lines(observe.to_prometheus_text())
    print(f"  exposition: {n} sample lines parse; {ntok} tokens in "
          f"{wall:.3f} s (profiler on), {steps} steps")
    turns = {"on": [], "off": []}
    for _ in range(OBS_TURNS):
        for label in ("on", "off"):
            observe.enable(label == "on")
            t0 = time.perf_counter()
            rs, _, _, _ = serve(engine, model, reqs_in, **kw)
            turns[label].append((time.perf_counter() - t0,
                                 sum(len(r.tokens) for r in rs)))
    observe.enable(True)
    for label, ts in turns.items():
        print(f"  engine, observe {label}: wall ms "
              f"{', '.join(f'{w * 1e3:.2f}' for w, _ in ts)}; tokens/s "
              f"{', '.join(f'{n / w:.1f}' for w, n in ts)}")
    return counts


def phase_observe_train(torch, models, opt, device, observe, A):
    """12b: the bench GPT step as a CUDA graph (phase 8's model) at
    Device.SetVerbosity(1) and SetSkipIteration(1), OBS_TRAIN_STEPS
    steps: singa_steps_total and the model.step spans count every call,
    K1/K2a launch 8 + 8 a step (the warm-up live, the capture's counts at
    each replay), dev.step_times holds the fenced steps past the first,
    the singa_hbm_* gauges come from the caching allocator; then the
    replayed step with observe on and off in turns."""
    print("== phase 12b: observe on the graph-mode training step")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))
    dev = device.best_device()
    saved = (dev.verbosity, dev.skip_iteration)
    dev.step_times.clear()
    dev.SetVerbosity(1)
    dev.SetSkipIteration(1)
    observe.enable(True)
    observe.get_registry().reset()
    try:
        m = models.create_model("gpt", device="cuda", seed=SEED, **BENCH_GPT)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([tx], is_train=True, use_graph=True, amp="bfloat16")
        torch.cuda.synchronize()
        A.reset_launches()
        losses, ms = _steps(torch, m, tx, ty, OBS_TRAIN_STEPS)
        counts = dict(A.LAUNCHES)
        if m.graph_backend != "cuda_graph":
            fail(f"12b ran {m.graph_backend!r}, not a CUDA graph")
        check_launches("observe graph training", counts,
                       {"flash_fwd": L * OBS_TRAIN_STEPS,
                        "flash_bwd_fused": L * OBS_TRAIN_STEPS})
        h = observe.get_registry().get("singa_span_seconds")
        got = {"singa_steps_total": _value(observe, "singa_steps_total"),
               "model.step": h.count(span="model.step"),
               "step_times": len(dev.step_times),
               "singa_step_fenced_seconds":
                   _value(observe, "singa_step_fenced_seconds")}
        want = {"singa_steps_total": OBS_TRAIN_STEPS,
                "model.step": OBS_TRAIN_STEPS,
                "step_times": OBS_TRAIN_STEPS - 1,
                "singa_step_fenced_seconds": OBS_TRAIN_STEPS - 1}
        print(f"  counts {got} (expected {want}); step ms "
              f"{', '.join(f'{x:.2f}' for x in ms)}; fenced "
              f"{', '.join(f'{t * 1e3:.2f}' for t in dev.step_times)} ms")
        if got != want:
            fail(f"12b counts {got}, expected {want}")
        stats = torch.cuda.memory_stats()
        hbm = {k: _value(observe, k) for k in (
            "singa_hbm_bytes_in_use", "singa_hbm_peak_bytes_in_use",
            "singa_hbm_bytes_limit")}
        print(f"  hbm gauges {hbm}; allocator now "
              f"{stats['allocated_bytes.all.current']}, reserved peak "
              f"{stats['reserved_bytes.all.peak']}")
        limit = torch.cuda.get_device_properties(0).total_memory
        if not (0 < hbm["singa_hbm_bytes_in_use"]
                <= hbm["singa_hbm_peak_bytes_in_use"] <= limit
                and hbm["singa_hbm_bytes_limit"] == limit):
            fail(f"singa_hbm_* gauges not set from memory_stats: {hbm}")
        dev.PrintTimeProfiling()
        dev.SetVerbosity(0)
        turns = {"on": [], "off": []}
        for _ in range(OBS_TURNS):
            for label in ("on", "off"):
                observe.enable(label == "on")
                turns[label] += _steps(torch, m, tx, ty, GRAPH_STEPS)[1]
        observe.enable(True)
        for label, v in turns.items():
            print(f"  graph step, observe {label}: ms "
                  f"{', '.join(f'{x:.2f}' for x in v)}; median "
                  f"{statistics.median(v):.2f}")
    finally:
        dev.verbosity, dev.skip_iteration = saved
        dev.step_times.clear()
        observe.enable(True)
    del m
    torch.cuda.empty_cache()
    return counts


def phase_observe_examples(root):
    """12c: the examples the API faults broke, unmodified, through the
    test suite's alias runner on the card (`best_device` left as the
    card), all at once (a process each); each must exit 0 within its
    own time limit and print its line."""
    print("== phase 12c: the repaired examples on the card")
    sys.path.insert(0, os.path.join(root, "tests"))
    from test_torch_examples import run_case

    def run(case):
        example, args, limit, _line = case
        t0 = time.perf_counter()
        rc, out = run_case(example, args, limit, device="cuda")
        return rc, out, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(OBS_EXAMPLES)) as pool:
        runs = list(pool.map(run, OBS_EXAMPLES))
    for (example, args, _limit, line), (rc, out, secs) in zip(OBS_EXAMPLES,
                                                              runs):
        tail = out.strip().splitlines()[-2:]
        print(f"  {example}: exit {rc} in {secs:.1f} s; {' | '.join(tail)}")
        if rc != 0 or line not in out:
            fail(f"{example} {args} exited {rc} (expected 0 and a line with "
                 f"{line!r}):\n{out[-3000:]}")


# ---- phase 13: slo, health and fault injection on the main paths ----------

#: 13a: the SLO A/B's settings (slo._ab_leg's): the workload of
#: serving.poisson_workload plus one long anchor request, the engine
SLO_WORKLOAD = dict(seed=7, n_req=16, rps=6.0, vocab=50257,
                    prompt_lens=(64, 256), new_lens=(16, 64))
SLO_ENGINE = dict(max_slots=8, page_size=16, steps_per_sync=2,
                  max_ctx=1024, dtype="bfloat16")
SLO_TTFT, SLO_DELAY = 0.25, 0.4     # p99 TTFT target, injected sync delay
SLO_EVAL_S = 0.1                    # the evaluation cadence
HEALTH_STEPS = 6                    # 13c's steps per model
HEALTH_TURN_STEPS = 5               # 13c's steps per timed turn (3 turns)
HEALTH_TOL = 1e-2                   # graph against eager stats, bf16 amp


def _slo_config(slo, target):
    return slo.SLOConfig(ttft_p99_s=target, availability=0.9,
                         window_s=20.0, fast_window_s=2.0,
                         slow_window_s=20.0, burn_threshold=2.0, sustain=2,
                         min_requests=5, eval_interval_s=1e9)


def _slo_arm(torch, model, engine, serving, slo, health, resilience,
             observe, A, target, delay):
    """One arm of 13a (slo._ab_leg on one engine): a fresh engine,
    prewarmed over the workload's prompt lengths, then the tracker, then
    the anchor and the Poisson arrivals while the tracker is evaluated
    every SLO_EVAL_S; `delay` (None for the clean arm) stalls every sync
    through a FaultPlan. The launch counters and the span ring are reset
    after the prewarm and read after the run."""
    L = len(model.blocks)
    wl = serving.poisson_workload(**SLO_WORKLOAD)
    prompts, new_lens = wl["prompts"], wl["new_lens"]
    n_hi = SLO_WORKLOAD["new_lens"][1]
    eng = engine.ServingEngine(model, queue_limit=4 * len(prompts),
                               **SLO_ENGINE).start()
    mon = health.HealthMonitor(policy="warn")
    health.set_active_monitor(mon)
    anomalies = observe.counter("singa_health_anomaly_total",
                                "training anomalies by kind")
    slo0 = anomalies.value(kind=health.KIND_SLO)
    rec = {}
    try:
        buckets, _ = eng.prewarm([len(p) for p in prompts], max_new=2,
                                 timeout_s=300)
        torch.cuda.synchronize()
        tracker = slo.SLOTracker(_slo_config(slo, target)).install()
        if delay is not None:
            resilience.install_fault_plan(resilience.FaultPlan().delay(
                "serving.engine_step", delay, times=10 ** 9))
        observe.enable_span_records(8192)
        steps0, pre0 = eng.report()["steps"], len(eng.timelines())
        A.reset_launches()
        t0 = time.perf_counter()
        handles = [eng.submit(prompts[0], n_hi)]
        for i in range(1, len(prompts)):
            dt = t0 + float(wl["arrivals"][i]) - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
            handles.append(eng.submit(prompts[i], int(new_lens[i])))
        breach_eval = None
        burning = idle = 0
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline:
            time.sleep(SLO_EVAL_S)
            v = tracker.evaluate()
            if any(o["burning"] or o["breach"]
                   for o in v["objectives"].values()):
                burning += 1
            if v["breaching"] and breach_eval is None:
                breach_eval = burning
            if all(h.done() for h in handles):
                idle += 1
                if breach_eval is not None or delay is None or idle > 40:
                    break
        stuck = [h.id for h in handles if not h.wait(600)]
        wall = time.perf_counter() - t0
        if stuck:
            fail(f"13a: requests {stuck} stalled")
        torch.cuda.synchronize()
        counts = dict(A.LAUNCHES)
        rep = eng.report()
        v = tracker.evaluate()
        rec.update(
            wall=wall, tokens=sum(len(h.tokens) for h in handles),
            ttfts=sorted(h.ttft_s for h in handles), report=rep,
            verdict=v, breach_eval=breach_eval,
            status=mon.verdict()["status"],
            slo_anomalies=anomalies.value(kind=health.KIND_SLO) - slo0,
            outcomes=[h.outcome for h in handles], buckets=buckets)
        # the engine's own prefills (an admit event each) and steps
        prefills = sum(1 for t in eng.timelines()[pre0:]
                       if any(ev[0] == "admit" for ev in t["events"]))
        check_launches(f"13a {'degraded' if delay else 'clean'} engine",
                       counts, {"flash_fwd": L * prefills,
                                "paged_attention":
                                    L * (rep["steps"] - steps0)})
        rec["counts"] = counts
        trace = slo.engine_trace_events(eng)
        res = slo._check_flow_trace(trace, eng)
        spans = [r for r in observe.span_records()
                 if r["name"] == "serving.engine_step"]
        chosen = next(t for t in eng.timelines()
                      if t["syncs"] and t["outcome"] == "completed"
                      and not t["synthetic"])
        by_id = {s["sync"]: s for s in eng.sync_records()}
        inside = all(any(r["tid"] == s["tid"] and r["t0"] <= s["t0"]
                         and s["t0"] + s["dur"] <= r["t0"] + r["dur"]
                         for r in spans)
                     for s in (by_id[i] for i in chosen["syncs"]))
        rec["trace"] = dict(res, syncs_in_spans=inside,
                            chosen_syncs=len(chosen["syncs"]))
        if not (res["schema_ok"] and res["flow_ok"] and inside):
            fail(f"13a: the request trace's flow links fail: "
                 f"{rec['trace']}")
    finally:
        resilience.clear_fault_plan()
        observe.disable_span_records()
        eng.stop()
        slo.reset()
        health.set_active_monitor(None)
    return rec


def _arm_line(label, r):
    t = r["ttfts"]
    p50, p99 = t[len(t) // 2], t[min(len(t) - 1, int(0.99 * len(t)))]
    tok_s = r["report"]["decode_tok_s"]
    att = r["verdict"]["objectives"]["ttft_p99"]["attainment"]
    print(f"  {label}: wall {r['wall']:.3f} s, {r['tokens']} tokens, "
          f"{r['tokens'] / r['wall']:.1f} tok/s, TTFT p50 {p50 * 1e3:.1f} "
          f"ms p99 {p99 * 1e3:.1f} ms, decode_tok_s {tok_s}, ttft_p99 "
          f"attainment {att}, breaching {r['verdict']['breaching']}, "
          f"breach after {r['breach_eval']} burning evaluations, monitor "
          f"{r['status']}, trace {r['trace']}")
    return p99


def phase_slo_engine(torch, model, engine, serving, slo, health, resilience,
                     observe, A):
    """13a: slo's A/B on one ServingEngine (GPT-2-small bf16, 8 slots,
    page 16, steps_per_sync 2): the clean arm at 100% ttft_p99
    attainment and no breach, the degraded arm (a FaultPlan delay on every
    sync) breaching within sustain + 3 burning evaluations with a KIND_SLO
    anomaly on the active monitor; in both the request trace's flow links
    inside sync records inside the serving.engine_step spans, and exact
    K1/K4 counts against the engine's own prefills and steps. A clean p99
    TTFT above half the target scales the target and the delay by one
    factor (printed)."""
    print("== phase 13a: SLO burn rates on the serving engine (clean and "
          "degraded arms)")
    args = (torch, model, engine, serving, slo, health, resilience,
            observe, A)
    factor = 1.0
    clean = _slo_arm(*args, SLO_TTFT, None)
    p99 = _arm_line("clean", clean)
    if p99 > SLO_TTFT / 2:
        factor = round(2.0 * p99 / SLO_TTFT * 1.25, 3)
        print(f"  clean p99 TTFT {p99 * 1e3:.1f} ms is above half the "
              f"target: target and delay scaled by {factor}")
        clean = _slo_arm(*args, SLO_TTFT * factor, None)
        _arm_line("clean (scaled)", clean)
    print(f"  TTFT factor {factor}: target {SLO_TTFT * factor:.3f} s, "
          f"delay {SLO_DELAY * factor:.3f} s")
    deg = _slo_arm(*args, SLO_TTFT * factor, SLO_DELAY * factor)
    _arm_line("degraded", deg)
    c_att = clean["verdict"]["objectives"]["ttft_p99"]["attainment"]
    if c_att != 1.0 or clean["verdict"]["breaching"] \
            or clean["slo_anomalies"] or \
            any(o != "completed" for o in clean["outcomes"]):
        fail(f"13a clean arm: attainment {c_att}, breaching "
             f"{clean['verdict']['breaching']}, anomalies "
             f"{clean['slo_anomalies']}, outcomes {clean['outcomes']}")
    sustain = _slo_config(slo, 1.0).sustain
    if deg["breach_eval"] is None or deg["breach_eval"] > sustain + 3 \
            or "ttft_p99" not in deg["verdict"]["breaching"] \
            or deg["slo_anomalies"] < 1 or deg["status"] != "warn":
        fail(f"13a degraded arm: breach after {deg['breach_eval']} "
             f"evaluations (limit {sustain + 3}), breaching "
             f"{deg['verdict']['breaching']}, KIND_SLO anomalies "
             f"{deg['slo_anomalies']}, monitor {deg['status']}")
    return clean["counts"], deg["counts"]


def phase_slo_generate(torch, model, serving, slo, health, observe, A):
    """13b: GPT.generate greedy (b8, prompt 256, +32, bf16) with an SLO
    tracker installed and observe disabled: exactly one note_decode per
    call (8 records), no non-finite logit booked, K1/K3 as phase 4 counts
    them; then observe enabled and +inf in one element of the output
    head: singa_health_nan_logits_total{kind="greedy"} rises by exactly
    the non-finite logits a plain recount of the call finds (the output
    ids teacher-forced through the plain prefill)."""
    print("== phase 13b: the dense decode path feeds the SLO tracker")
    L, V = len(model.blocks), model.vocab_size
    B, S0, new = 8, 256, 32
    prompts = np.random.RandomState(SEED + 13).randint(
        0, V, (B, S0)).astype(np.int32)
    model.generate(prompts[:, :8], 2, dtype="bfloat16")     # warm
    calls = []
    note = slo.note_decode

    def counted(*a, **k):
        calls.append(a[0])
        return note(*a, **k)

    observe.enable(False)
    observe.get_registry().reset()
    tracker = slo.SLOTracker(slo.SLOConfig(latency_p99_s=600.0,
                                           eval_interval_s=1e9)).install()
    slo.note_decode = counted
    try:
        torch.cuda.synchronize()
        A.reset_launches()
        t0 = time.perf_counter()
        out = model.generate(prompts, new, dtype="bfloat16")
        wall = time.perf_counter() - t0
        counts = dict(A.LAUNCHES)
        recs = tracker.window_records(window_s=1e9)
    finally:
        slo.note_decode = note
        slo.reset()
        observe.enable(True)
    print(f"  generate b{B} prompt {S0} +{new}: {wall:.3f} s; note_decode "
          f"calls {calls}, tracker records {len(recs)} (ttft "
          f"{recs[0]['ttft_s'] if recs else None}, total "
          f"{recs[0]['total_s'] if recs else None})")
    if calls != ["greedy"] or len(recs) != B or out.shape != (B, S0 + new):
        fail(f"13b: note_decode calls {calls}, {len(recs)} records")
    if observe.get_registry().get("singa_health_nan_logits_total"):
        fail("13b: a non-finite logit was booked on the healthy call")
    check_launches("13b generate (tracker installed)", counts,
                   {"flash_fwd": L, "flash_decode": L * (new - 1)})
    W = model.head.W
    i, j = 5, 7
    with torch.no_grad():
        old = W[i, j].clone()
        W[i, j] = float("inf")
    try:
        observe.get_registry().reset()
        bad = model.generate(prompts, new, dtype="bfloat16")
        c = observe.get_registry().get("singa_health_nan_logits_total")
        booked = c.value(kind="greedy") if c is not None else 0.0
        # the plain recount: the same ids teacher-forced through the plain
        # prefill with the same (poisoned) bf16 decode params
        p = serving.decode_state(model, "bfloat16")
        core = serving._decode_core(model, S0 + new, 1)
        ids = torch.as_tensor(bad[:, :S0 + new - 1].astype(np.int64),
                              device=model.device)
        with torch.no_grad():
            h, _ = core.prefill_parts(p, ids, B, use_kernel=False)
            logits = core.head(p, h[:, S0 - 1:])
            recount = int((~torch.isfinite(logits)).sum())
    finally:
        with torch.no_grad():
            W[i, j] = old
    print(f"  +inf at head.W[{i}, {j}]: booked {booked:.0f} non-finite "
          f"logits (kind greedy), plain recount {recount}")
    if booked != recount or recount <= 0:
        fail(f"13b: booked {booked} non-finite logits, recount {recount}")
    return counts


def _health_run(torch, models, opt, health, tx, ty, use_graph, mon, n):
    """The bench GPT (seed SEED) compiled with `mon`, n steps: (model,
    the monitor's ring, the losses)."""
    m = models.create_model("gpt", device="cuda", seed=SEED, **BENCH_GPT)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    m.compile([tx], is_train=True, use_graph=use_graph, amp="bfloat16",
              health=mon)
    losses = [m(tx, ty)[1].item() for _ in range(n)]
    return m, list(mon.recorder.ring) if mon is not None else None, losses


def _opt_snapshot(torch, m):
    return ([t.detach().clone() for t in m._raw_states().values()]
            + [t.detach().clone() for t in m.optimizer.state_arrays()])


def _opt_equal(torch, m, snap):
    now = list(m._raw_states().values()) + m.optimizer.state_arrays()
    return len(now) == len(snap) and all(
        torch.equal(a, b) for a, b in zip(now, snap))


def phase_health_train(torch, models, opt, health, observe, A, root):
    """13c: the bench GPT step as a CUDA graph with
    compile(health=HealthMonitor("skip_step")): 6 steps with finite
    stats, grad_norm and the group norms within HEALTH_TOL of the same
    model's eager health steps, exactly 8 + 8 K1/K2a a step; +inf written
    into a block weight between replays: the next replay reports the
    anomaly and leaves every parameter, optimizer slot and the step
    counter bitwise as they were; the element restored, the next step is
    clean and steps the counter; the replayed step with health off, warn
    and skip_step in same-call turns (median of 15 each); halt raising
    HealthError with a bundle that load_flight_bundle reads."""
    print("== phase 13c: training health on the graph-mode step")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))
    observe.enable(True)
    em, ering, elosses = _health_run(
        torch, models, opt, health, tx, ty, False,
        health.HealthMonitor(policy="warn", out_dir=root), HEALTH_STEPS)
    del em
    torch.cuda.empty_cache()
    mon = health.HealthMonitor(policy="skip_step", out_dir=root)
    torch.cuda.synchronize()
    A.reset_launches()
    gm, gring, glosses = _health_run(torch, models, opt, health, tx, ty,
                                     True, mon, HEALTH_STEPS)
    counts = dict(A.LAUNCHES)
    if gm.graph_backend != "cuda_graph":
        fail(f"13c ran {gm.graph_backend!r}, not a CUDA graph")
    check_launches("13c graph training with health", counts,
                   {"flash_fwd": L * HEALTH_STEPS,
                    "flash_bwd_fused": L * HEALTH_STEPS})
    worst = 0.0
    for e, g in zip(ering, gring):
        vals = [(e["grad_norm"], g["grad_norm"])] + [
            (e["groups"][k][s], g["groups"][k][s]) for k in e["groups"]
            for s in ("param_norm", "update_norm")]
        if not all(np.isfinite(b) for _, b in vals) or g["anomaly_kinds"]:
            fail(f"13c: non-finite or anomalous graph-mode stats {g}")
        worst = max([worst] + [abs(a - b) / max(abs(a), 1e-12)
                               for a, b in vals])
    print(f"  {HEALTH_STEPS} steps, {len(gring[0]['groups'])} groups: "
          f"grad_norm eager {[round(r['grad_norm'], 4) for r in ering]}, "
          f"graph {[round(r['grad_norm'], 4) for r in gring]}; max relative "
          f"difference of the norms {worst:.3e} (tol {HEALTH_TOL}); losses "
          f"eager {[round(x, 4) for x in elosses]}, graph "
          f"{[round(x, 4) for x in glosses]}")
    if worst > HEALTH_TOL or len(ering) != len(gring) != HEALTH_STEPS:
        fail("13c: graph-mode health stats differ from the eager step's")
    W = gm.blocks[0].attn.Wq
    with torch.no_grad():
        old = W[0, 0].clone()
        W[0, 0] = float("inf")
    snap = _opt_snapshot(torch, gm)
    counter = float(gm.optimizer.step_counter)
    _, loss = gm(tx, ty)
    kept = _opt_equal(torch, gm, snap)
    last = mon.recorder.ring[-1]
    print(f"  +inf in TransformerBlock_0.attn.Wq[0, 0], replayed step: "
          f"action {mon.last_action}, anomaly {last['anomaly_kinds']}, "
          f"non-finite grads {last['nonfinite_grads']}; every parameter, "
          f"slot and step_counter bitwise kept: {kept} (counter "
          f"{counter} -> {float(gm.optimizer.step_counter)})")
    if mon.last_action != "skip" or not kept or \
            float(gm.optimizer.step_counter) != counter:
        fail("13c: the skip_step replay did not keep the pre-step state")
    with torch.no_grad():
        W[0, 0] = old
    _, loss = gm(tx, ty)
    if mon.last_action != "ok" or not np.isfinite(loss.item()) or \
            float(gm.optimizer.step_counter) != counter + 1:
        fail(f"13c: the step after the restore: {mon.last_action}, loss "
             f"{loss.item()}, counter {float(gm.optimizer.step_counter)}")
    print(f"  restored: next step ok, loss {loss.item():.4f}, counter "
          f"{float(gm.optimizer.step_counter)}")
    built = {"off": _health_run(torch, models, opt, health, tx, ty, True,
                                None, 2)[0],
             "warn": _health_run(torch, models, opt, health, tx, ty, True,
                                 health.HealthMonitor(policy="warn",
                                                      out_dir=root), 2)[0],
             "skip_step": gm}
    ms = {k: [] for k in built}
    order = list(built) + list(built)[::-1] + list(built)
    for label in order:
        ms[label] += _steps(torch, built[label], tx, ty,
                            HEALTH_TURN_STEPS)[1]
    med = {k: statistics.median(v) for k, v in ms.items()}
    for k, v in ms.items():
        print(f"  replayed step, health {k}: ms "
              f"{', '.join(f'{x:.2f}' for x in v)}; median {med[k]:.2f}")
    print(f"  health overhead: warn {med['warn'] / med['off'] - 1:+.2%}, "
          f"skip_step {med['skip_step'] / med['off'] - 1:+.2%} of the "
          f"step (median of {len(ms['off'])} each)")
    del built
    hm = health.HealthMonitor(policy="halt", out_dir=root)
    gm.set_health_monitor(hm)
    gm(tx, ty)
    gm(tx, ty)
    with torch.no_grad():
        W[0, 0] = float("inf")
    try:
        gm(tx, ty)
        fail("13c: halt did not raise")
    except health.HealthError as e:
        bundle = health.load_flight_bundle(e.bundle_path)
        print(f"  halt: HealthError at step {bundle['header']['step']} "
              f"({bundle['header']['reason']}), bundle with "
              f"{len(bundle['steps'])} steps and {len(bundle['events'])} "
              "events")
        if bundle["header"].get("kind") != "flight_header" \
                or not bundle["steps"]:
            fail(f"13c: the halt bundle does not load: {bundle}")
    finally:
        gm.set_health_monitor(None)
    del gm
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 14: watchdog, memory ledger and goodput on the engine and the
# graph-mode step
WD_POLL_S = 0.01          # the watchdog checker's poll
WD_FLOOR_S = 0.25         # 14a: the calibrated decode deadline's floor
WD_FIRST_S = 0.02         # 14b: the static step deadline over the first calls
WD_STEP_S = 0.3           # 14b: the static step deadline over the replays
WD_TURN_STEPS = 5         # 14b: steps per timed turn (3 turns each)
MEM_STEPS = 30            # 14c: clean graph steps under the ledger
MEM_LEAK_MB = 64          # 14c: the tensor kept from each leaking step
MEM_LEAK_LIMIT = 20       # 14c: steps within which the leak is flagged
GP_BATCHES = 12           # 14d: batches of each fit epoch
GP_DELAY_S, GP_DELAYS = 0.05, 4   # 14d: the data.next delays
GP_POISON = 5             # 14d: the batch whose step is poisoned


def _counter_sum(observe, name, **labels):
    c = observe.get_registry().get(name)
    return c.value(**labels) if c is not None else 0.0


def _wd_counts(observe, op):
    return {k: _counter_sum(observe, f"singa_watchdog_{k}_total", op=op)
            for k in ("breach", "dump", "abort", "hard_abort")}


def _engine_run(torch, model, engine, resilience, A, wl, burst=False,
                plan=None):
    """One ServingEngine (13a's configuration) over the Poisson workload
    `wl` (its arrivals, or every request at once with `burst`), with
    `plan` installed before the first submission. Returns (handles, wall
    seconds, launch counts, the engine's prefills and steps of the run,
    the engine, still running)."""
    prompts, new_lens = wl["prompts"], wl["new_lens"]
    eng = engine.ServingEngine(model, queue_limit=4 * len(prompts),
                               **SLO_ENGINE).start()
    try:
        torch.cuda.synchronize()
        steps0, pre0 = eng.report()["steps"], len(eng.timelines())
        if plan is not None:
            resilience.install_fault_plan(plan)
        A.reset_launches()
        t0 = time.perf_counter()
        handles = [eng.submit(prompts[0], SLO_WORKLOAD["new_lens"][1])]
        for i in range(1, len(prompts)):
            dt = t0 + float(wl["arrivals"][i]) - time.perf_counter()
            if dt > 0 and not burst:
                time.sleep(dt)
            handles.append(eng.submit(prompts[i], int(new_lens[i])))
        stuck = [h.id for h in handles if not h.wait(600)]
        wall = time.perf_counter() - t0
        if stuck:
            fail(f"phase 14: requests {stuck} stalled")
        torch.cuda.synchronize()
        counts = dict(A.LAUNCHES)
        prefills = sum(1 for t in eng.timelines()[pre0:]
                       if any(ev[0] == "admit" for ev in t["events"]))
        steps = eng.report()["steps"] - steps0
    except BaseException:
        eng.stop()
        raise
    finally:
        resilience.clear_fault_plan()
    return handles, wall, counts, prefills, steps, eng


def phase_watchdog_engine(torch, model, engine, serving, health, resilience,
                          watchdog, observe, A, root):
    """14a: the watchdog on 13a's engine (GPT-2-small bf16, 8 slots, page
    16, steps_per_sync 2): after the prewarm, a calibrated watchdog
    (action "abort", floor WD_FLOOR_S) and a warn monitor; the Poisson
    workload clean (no breach, every request completed, a calibrated
    `decode` deadline); then a fresh engine with a FaultPlan delay of
    (abort_at + 1) x the deadline on its first sync and the workload
    submitted at once: warn, dump and abort, the bundle's wedged thread
    the engine's, inside the fault point's delay, HangError ending the
    loop with every request evicted, a KIND_HANG anomaly; then a fresh
    engine clean again. Exact K1/K4 counts against each run's own
    prefills and steps (the aborted sync's decode launches)."""
    print("== phase 14a: the watchdog on the serving engine")
    L = len(model.blocks)
    wl = serving.poisson_workload(**SLO_WORKLOAD)
    mon = health.HealthMonitor(policy="warn", out_dir=root)
    health.set_active_monitor(mon)
    wd = None
    by_path = {}
    try:
        eng = engine.ServingEngine(model, queue_limit=64, **SLO_ENGINE)
        eng.start()
        try:
            eng.prewarm([len(p) for p in wl["prompts"]], max_new=2,
                        timeout_s=300)
        finally:
            eng.stop()
        wd = watchdog.install_watchdog(action="abort", floor_s=WD_FLOOR_S,
                                       poll_interval_s=WD_POLL_S,
                                       out_dir=root)
        hs, wall, counts, pre, steps, eng = _engine_run(
            torch, model, engine, resilience, A, wl)
        eng.stop()
        dl = wd.op_state("decode").deadline()
        c0 = _wd_counts(observe, "decode")
        print(f"  clean: {len(hs)} requests in {wall:.3f} s, "
              f"{len(wd.op_state('decode').samples)} decode samples, "
              f"calibrated decode deadline {dl} s (p99 x "
              f"{wd.op_state('decode').multiplier}, floor {WD_FLOOR_S}); "
              f"watchdog counts {c0}")
        if dl is None or any(c0.values()) or \
                any(h.outcome != "completed" for h in hs):
            fail(f"14a clean: deadline {dl}, counts {c0}, outcomes "
                 f"{[h.outcome for h in hs]}")
        check_launches("14a clean engine (watchdog armed)", counts,
                       {"flash_fwd": L * pre, "paged_attention": L * steps})
        by_path["wd_clean"] = counts
        delay = (wd.abort_at + 1.0) * dl
        hang0 = _counter_sum(observe, "singa_health_anomaly_total",
                             kind=health.KIND_HANG)
        t0 = time.perf_counter()
        hs, wall, counts, pre, steps, eng = _engine_run(
            torch, model, engine, resilience, A, wl, burst=True,
            plan=resilience.FaultPlan().delay("serving.engine_step", delay,
                                              times=1))
        # the loop re-raises after its drain: the thread ends just after
        t = eng._thread
        t.join(timeout=30)
        alive = t.is_alive()
        eng.stop()
        c1 = {k: v - c0[k] for k, v in _wd_counts(observe, "decode").items()}
        lb = dict(wd.last_breach or {})
        b = watchdog.load_hang_bundle(wd.last_bundle)
        wedged = [t for t in b["threads"] if t["wedged"]]
        inner = wedged[0]["frames"][-1] if wedged else {}
        details = {h.detail for h in hs}
        hangs = _counter_sum(observe, "singa_health_anomaly_total",
                             kind=health.KIND_HANG) - hang0
        loop_err = [e for e in observe.get_registry().recent
                    if e.get("event") == "loop_error"]
        print(f"  delayed sync (+{delay:.3f} s = (abort_at + 1) x deadline): "
              f"{len(hs)} requests in {wall:.3f} s; counts {c1}; last "
              f"breach stage {lb.get('stage')} at {lb.get('seconds')} s "
              f"(deadline {lb.get('deadline')}); bundle "
              f"{os.path.basename(wd.last_bundle)}: {len(b['threads'])} "
              f"threads, wedged {[t['name'] for t in wedged]} in "
              f"{inner.get('func')} ({inner.get('code')}); outcomes "
              f"{sorted({h.outcome for h in hs})}; KIND_HANG +{hangs:.0f}; "
              f"loop alive {alive}")
        if c1["breach"] < 1 or c1["dump"] < 1 or c1["abort"] < 1 \
                or c1["hard_abort"] or lb.get("stage") != "abort":
            fail(f"14a: the delayed sync did not climb warn, dump and abort: "
                 f"{c1}, {lb}")
        if len(wedged) != 1 or not wedged[0]["name"].startswith(
                "torch-serve-") or inner.get("func") != "fire":
            fail(f"14a: the hang bundle names {wedged}")
        if any(h.outcome != "evicted" for h in hs) or \
                any("HangError" not in (d or "") for d in details) or \
                not loop_err or alive or hangs != 1:
            fail(f"14a: the loop's drain: outcomes "
                 f"{[h.outcome for h in hs]}, details {details}, "
                 f"loop_error {bool(loop_err)}, alive {alive}, "
                 f"KIND_HANG {hangs}")
        check_launches("14a aborted engine", counts,
                       {"flash_fwd": L * pre, "paged_attention":
                            L * (steps + SLO_ENGINE["steps_per_sync"])})
        by_path["wd_aborted"] = counts
        hs, wall, counts, pre, steps, eng = _engine_run(
            torch, model, engine, resilience, A, wl)
        eng.stop()
        c2 = {k: v - c0[k] - c1[k]
              for k, v in _wd_counts(observe, "decode").items()}
        print(f"  fresh engine, clean: {len(hs)} requests in {wall:.3f} s, "
              f"new watchdog counts {c2}, deadline "
              f"{wd.op_state('decode').deadline()} s")
        if any(c2.values()) or any(h.outcome != "completed" for h in hs):
            fail(f"14a fresh engine: counts {c2}, outcomes "
                 f"{[h.outcome for h in hs]}")
        check_launches("14a fresh engine", counts,
                       {"flash_fwd": L * pre, "paged_attention": L * steps})
        by_path["wd_fresh"] = counts
    finally:
        resilience.clear_fault_plan()
        watchdog.uninstall_watchdog()
        health.set_active_monitor(None)
    return by_path


def _bench_graph(torch, models, opt, health, tx, root, policy="warn",
                 seed=SEED):
    m = models.create_model("gpt", device="cuda", seed=seed, **BENCH_GPT)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    m.compile([tx], is_train=True, use_graph=True, amp="bfloat16",
              health=health.HealthMonitor(policy=policy, out_dir=root))
    return m


def _sleep_rate(torch):
    """SM cycles a second that torch.cuda._sleep spins at on this card,
    from one 0.05 s sleep timed by CUDA events."""
    cycles = int(0.05 * SM_HZ)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / (a.elapsed_time(b) / 1e3)


def phase_watchdog_train(torch, models, opt, health, watchdog, goodput,
                         observe, A, build, root):
    """14b: the watchdog on 13c's bench GPT step as a CUDA graph
    (health warn). A static step deadline of WD_FIRST_S installed before
    the first call: the warm-up and the capture (under model.build) are
    tainted and do not breach; then the diagnostic wgmma_probe library,
    deleted from .kernel_build/, built by `_build.lib` inside a step
    guard at the same deadline: tainted by its introspect.build span, no
    breach, its time booked to goodput's `compile`. With a deadline of
    WD_STEP_S: a device stall (torch.cuda._sleep) of (abort_at + 1) x
    the deadline queued before a replay breaches at the step's fence,
    HangError from the step with the bundle's wedged thread this one,
    inside the stats read; the next step clean, 8 + 8 K1/K2a a replay;
    the replayed step with the watchdog off and on in same-call turns
    (median of 15 each). Returns the launch counts and a weak reference
    to the model, which the stall's HangError keeps alive in a dead
    reference cycle (its traceback holds the step's frames) until the
    cyclic collector frees it: 14c checks that this happens outside its
    capture."""
    print("== phase 14b: the watchdog on the graph-mode training step")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))
    counts = {}
    tracker = goodput.install()
    wd = watchdog.install_watchdog(deadlines={"step": WD_FIRST_S},
                                   action="abort",
                                   poll_interval_s=WD_POLL_S, out_dir=root)
    try:
        m = _bench_graph(torch, models, opt, health, tx, root)
        first = []
        for _ in range(2):                  # the warm-up, the capture
            t0 = time.perf_counter()
            m(tx, ty)[1].item()
            first.append(time.perf_counter() - t0)
        cb = _wd_counts(observe, "step")
        print(f"  static step deadline {WD_FIRST_S} s: warm-up "
              f"{first[0]:.3f} s and capture {first[1]:.3f} s, both under "
              f"model.build; counts {cb}; backend {m.graph_backend}")
        if m.graph_backend != "cuda_graph" or any(cb.values()) or \
                min(first) <= WD_FIRST_S * wd.abort_at:
            fail(f"14b: the first calls breached or were too short to "
                 f"show the taint: {first}, {cb}")
        name = "wgmma_probe"
        path = build._lib_path(name)
        build._libs.pop(name, None)
        if os.path.exists(path):
            os.remove(path)
        comp0 = tracker.snapshot()["buckets"]["compile"]
        t0 = time.perf_counter()
        with watchdog.guard("step"):
            build.lib(name)
        nvcc_s = time.perf_counter() - t0
        gained = tracker.snapshot()["buckets"]["compile"] - comp0
        cn = _wd_counts(observe, "step")
        print(f"  {name} built and loaded inside a step guard "
              f"({WD_FIRST_S} s): {nvcc_s:.3f} s (nvcc "
              f"{build.BUILD_SECONDS.get(name, 0.0):.3f} s); counts {cn}; "
              f"goodput compile +{gained:.3f} s")
        if any(cn.values()) or nvcc_s <= WD_FIRST_S * wd.abort_at or \
                gained < 0.99 * nvcc_s or name not in build.BUILD_SECONDS:
            fail(f"14b: the kernel build was not tainted or not booked: "
                 f"{cn}, {nvcc_s}, {gained}")
        watchdog.uninstall_watchdog()
        wd = watchdog.install_watchdog(deadlines={"step": WD_STEP_S},
                                       action="abort",
                                       poll_interval_s=WD_POLL_S,
                                       out_dir=root)
        ms = _steps(torch, m, tx, ty, 3)[1]
        if max(ms) > WD_STEP_S * 1e3 / 2:
            fail(f"14b: replays of {ms} ms leave no room under the "
                 f"{WD_STEP_S} s deadline")
        rate = _sleep_rate(torch)
        stall = (wd.abort_at + 1.0) * WD_STEP_S
        torch.cuda.synchronize()
        A.reset_launches()
        torch.cuda._sleep(int(stall * rate))
        t0 = time.perf_counter()
        err = None
        try:
            m(tx, ty)
        except watchdog.HangError as e:
            err = e
        took = time.perf_counter() - t0
        counts["stall"] = dict(A.LAUNCHES)
        cs = _wd_counts(observe, "step")
        if err is None:
            fail(f"14b: the stalled replay ({took:.3f} s) raised nothing; "
                 f"counts {cs}")
        b = watchdog.load_hang_bundle(err.bundle_path)
        wedged = [t for t in b["threads"] if t["wedged"]]
        inner = wedged[0]["frames"][-1] if wedged else {}
        me = threading.current_thread().name
        print(f"  device stall {stall:.3f} s ({int(stall * rate)} cycles at "
              f"{rate / 1e9:.3f} GHz) before a replay: HangError({err.op}, "
              f"{err.seconds:.3f} s) after {took:.3f} s; counts {cs}; "
              f"wedged {[t['name'] for t in wedged]} in "
              f"{inner.get('func')} ({inner.get('code')})")
        if err.op != "step" or cs["breach"] != 1 or cs["dump"] != 1 or \
                cs["abort"] != 1 or cs["hard_abort"] or len(wedged) != 1 \
                or wedged[0]["name"] != me \
                or inner.get("func") != "_train_step" \
                or "packed.cpu()" not in (inner.get("code") or ""):
            fail(f"14b: the stall's breach: {err.op}, {cs}, {wedged}")
        check_launches("14b stalled replay", counts["stall"],
                       {"flash_fwd": L, "flash_bwd_fused": L})
        A.reset_launches()
        _, loss = m(tx, ty)
        counts["clean"] = dict(A.LAUNCHES)
        if _wd_counts(observe, "step") != cs or not np.isfinite(loss.item()):
            fail("14b: the step after the stall was not clean")
        check_launches("14b next replay", counts["clean"],
                       {"flash_fwd": L, "flash_bwd_fused": L})
        ms = {"off": [], "on": []}
        for label in ("off", "on", "on", "off", "off", "on"):
            wd.enabled = label == "on"
            ms[label] += _steps(torch, m, tx, ty, WD_TURN_STEPS)[1]
        wd.enabled = True
        med = {k: statistics.median(v) for k, v in ms.items()}
        for k, v in ms.items():
            print(f"  replayed step, watchdog {k}: ms "
                  f"{', '.join(f'{x:.2f}' for x in v)}; median {med[k]:.2f}")
        print(f"  watchdog overhead: {med['on'] / med['off'] - 1:+.2%} of "
              f"the step (median of {len(ms['on'])} each); step deadline "
              f"samples {len(wd.op_state('step').samples)} (static)")
        ref = weakref.ref(m)
        del m
    finally:
        watchdog.uninstall_watchdog()
        goodput.uninstall()
    torch.cuda.empty_cache()
    return {k: sum(c[k] for c in counts.values()) for k in A.LAUNCHES}, ref


def _reconciles(s):
    return (sum(s["regions"].values()) == s["total_bytes"]
            and s["regions"]["unattributed"] >= 0
            and sum(s["counts"].values()) == s["n_arrays"])


def phase_memory(torch, models, opt, health, memory, engine, serving, slo,
                 resilience, observe, A, gpt2, prev, root):
    """14c: the memory ledger on the card (total: the caching allocator's
    memory_allocated) with its LeakDetector: 13c's graph step (health
    skip_step) for MEM_STEPS steps, every snapshot reconciled, one taken
    directly equal to memory_allocated(), params / opt_state /
    flight_snapshot equal to the model's distinct parameter storages, the
    optimizer's state_arrays() and the retained batch, the build count 1,
    no leak verdict; then a MEM_LEAK_MB tensor kept from each step, the
    leak flagged within MEM_LEAK_LIMIT steps naming `unattributed`; 14a's
    engine served under the ledger, kv_cache equal to its pools and to
    slo.fleet_serve_snapshot()["kv_cache_bytes"]; estimate_fit with the
    card's limit; last, a real OOM: an eager fp32 step of a fresh bench
    GPT at a batch whose logits alone exceed the free memory, the
    OutOfMemoryError propagating, a flight_oom_step bundle that
    load_flight_bundle reads with the model's parameters among its
    top_arrays, singa_mem_oom_dumps_total + 1, and after
    torch.cuda.empty_cache() a normal step. First of all, the capture
    of the first graph step: the cyclic collector off inside it, and
    `prev` (14b's model, in a dead reference cycle, with its CUDA graph)
    freed by then, as Model's capture collects before it (a graph
    destroyed inside another's capture invalidates that capture)."""
    print("== phase 14c: the memory ledger on the card")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))
    counts = {}
    led = memory.install_ledger(out_dir=root)
    try:
        m = _bench_graph(torch, models, opt, health, tx, root,
                         policy="skip_step")
        n0 = len(led.timeline)
        collector = []

        def probe(path, _seconds, _attrs):
            if path.endswith("opt.apply_updates") \
                    and torch.cuda.is_current_stream_capturing():
                collector.append(gc.isenabled())

        alive = prev() is not None
        observe.add_span_listener(probe)
        A.reset_launches()
        t0 = time.perf_counter()
        try:
            for _ in range(MEM_STEPS):
                m(tx, ty)
            torch.cuda.synchronize()
        finally:
            observe.remove_span_listener(probe)
        wall = time.perf_counter() - t0
        print(f"  14b's model (a dead reference cycle with its CUDA graph) "
              f"alive before the capture {alive}, after it "
              f"{prev() is not None}; the cyclic collector on inside the "
              f"capture: {collector}")
        if prev() is not None or collector != [False]:
            fail("14c: the capture ran with the cyclic collector on, or "
                 "14b's dead model outlived it")
        counts["train"] = dict(A.LAUNCHES)
        snaps = list(led.timeline)[n0:]
        s = led.snapshot()
        alloc = torch.cuda.memory_allocated()
        params = sum({p.untyped_storage().data_ptr():
                      p.untyped_storage().nbytes()
                      for p in m._raw_params().values()}.values())
        opt_b = sum(a.numel() * a.element_size()
                    for a in m.optimizer.state_arrays())
        batch_b = sum(t.numel() * t.element_size() for t in (tx, ty))
        r = s["regions"]
        leak0 = _counter_sum(observe, "singa_health_anomaly_total",
                             kind=health.KIND_MEM_LEAK)
        print(f"  {MEM_STEPS} graph steps in {wall:.3f} s, {len(snaps)} step "
              f"snapshots, all reconciled {all(map(_reconciles, snaps))}; "
              f"direct snapshot: total {s['total_bytes']} = "
              f"memory_allocated {alloc}; regions (MB) "
              + ", ".join(f"{k} {v / 1e6:.3f}" for k, v in r.items())
              + f"; {s['n_arrays']} blocks; build count {m._build_count}; "
              f"leak verdicts {len(led.leak.verdicts)}, slope "
              f"{led.leak.slope:.1f} B/step")
        if len(snaps) != MEM_STEPS or not all(map(_reconciles, snaps)) \
                or not _reconciles(s) or s["total_bytes"] != alloc:
            fail("14c: a snapshot is missing or does not reconcile")
        if (r["params"], r["opt_state"], r["flight_snapshot"]) != \
                (params, opt_b, batch_b):
            fail(f"14c: regions {r} against params {params}, opt_state "
                 f"{opt_b}, flight_snapshot {batch_b}")
        if m._build_count != 1 or led.leak.verdicts or leak0:
            fail(f"14c: build count {m._build_count}, verdicts "
                 f"{led.leak.verdicts}")
        check_launches("14c graph steps under the ledger", counts["train"],
                       {"flash_fwd": L * MEM_STEPS,
                        "flash_bwd_fused": L * MEM_STEPS})
        kept = []
        A.reset_launches()
        for i in range(MEM_LEAK_LIMIT + 5):
            kept.append(torch.empty(MEM_LEAK_MB << 20, dtype=torch.uint8,
                                    device="cuda"))
            m(tx, ty)
            if led.leak.verdicts:
                break
        counts["leak"] = dict(A.LAUNCHES)
        v = led.leak.verdicts[0] if led.leak.verdicts else {}
        leaks = _counter_sum(observe, "singa_health_anomaly_total",
                             kind=health.KIND_MEM_LEAK)
        print(f"  {MEM_LEAK_MB} MB kept a step: flagged after {i + 1} "
              f"steps, suspect {v.get('suspect_region')} "
              f"(+{v.get('suspect_delta_bytes')} B over {v.get('window')} "
              f"snapshots, slope {v.get('slope_bytes_per_step')} B/step), "
              f"action {v.get('action')}, KIND_MEM_LEAK {leaks:.0f}")
        if not v or i + 1 > MEM_LEAK_LIMIT or leaks != 1 or \
                v["suspect_region"] != "unattributed":
            fail(f"14c: the leak was not flagged within {MEM_LEAK_LIMIT} "
                 f"steps: {v}")
        check_launches("14c leaking steps", counts["leak"],
                       {"flash_fwd": L * (i + 1),
                        "flash_bwd_fused": L * (i + 1)})
        del kept
        fit = memory.estimate_fit(m)
        limit = torch.cuda.mem_get_info()[1]
        print(f"  estimate_fit: estimated {fit['estimated_peak_bytes']} B, "
              f"limit {fit['limit_bytes']} B, fits {fit['fits']}, headroom "
              f"{fit['headroom_frac']}, source {fit['source']}")
        if fit["limit_bytes"] != limit or fit["fits"] is not True:
            fail(f"14c: estimate_fit {fit}")
        del m
        torch.cuda.empty_cache()
        wl = serving.poisson_workload(**SLO_WORKLOAD)
        n1 = len(led.timeline)
        hs, wall, ecounts, pre, steps, eng = _engine_run(
            torch, gpt2, engine, resilience, A, wl, burst=True)
        try:
            esnaps = list(led.timeline)[n1:]
            s = led.snapshot()
            pools = eng.pool_bytes() + eng.draft_pool_bytes()
            kv_slo = slo.fleet_serve_snapshot()["kv_cache_bytes"]
        finally:
            eng.stop()
        counts["engine"] = ecounts
        print(f"  engine under the ledger: {len(hs)} requests in "
              f"{wall:.3f} s, {len(esnaps)} engine snapshots (prefill and "
              f"sync spans), all reconciled {all(map(_reconciles, esnaps))}; "
              f"kv_cache {s['regions']['kv_cache']} B = pools {pools} B = "
              f"fleet_serve_snapshot {kv_slo} B")
        if not esnaps or not all(map(_reconciles, esnaps)) or \
                s["regions"]["kv_cache"] != pools or kv_slo != pools or \
                any(h.outcome != "completed" for h in hs):
            fail("14c: the engine's kv_cache region")
        Lg = len(gpt2.blocks)
        check_launches("14c engine under the ledger", ecounts,
                       {"flash_fwd": Lg * pre, "paged_attention": Lg * steps})
        oom0 = _counter_sum(observe, "singa_mem_oom_dumps_total")
        mo = models.create_model("gpt", device="cuda", seed=SEED + 1,
                                 **BENCH_GPT)
        mo.set_optimizer(opt.SGD(lr=0.1))
        mo.compile([tx], is_train=True, use_graph=False)
        free = torch.cuda.mem_get_info()[0]
        B = free // (TRAIN_S * V * 4) + 8
        bx = torch.randint(0, V, (B, TRAIN_S), device="cuda")
        t0 = time.perf_counter()
        caught = None
        try:
            mo(bx, bx)
        except torch.OutOfMemoryError as e:
            caught = str(e).splitlines()[0][:160]
        took = time.perf_counter() - t0
        del bx
        bundles = sorted((f for f in os.listdir(root)
                          if f.startswith("flight_oom_step")),
                         key=lambda f: os.path.getmtime(
                             os.path.join(root, f)))
        b = health.load_flight_bundle(os.path.join(root, bundles[-1])) \
            if bundles else {"header": {}}
        oom = b["header"].get("oom") or {}
        shapes = {(tuple(p.shape), p.numel() * p.element_size())
                  for p in mo._raw_params().values()}
        top = oom.get("top_arrays") or []
        hits = [t for t in top if (tuple(t["shape"]), t["nbytes"]) in shapes]
        dumps = _counter_sum(observe, "singa_mem_oom_dumps_total") - oom0
        print(f"  eager fp32 step at batch {B} (free {free} B): "
              f"OutOfMemoryError {caught is not None} after {took:.3f} s "
              f"({caught}); bundle {bundles[-1] if bundles else None}: "
              f"reason {b['header'].get('reason')}, key "
              f"{oom.get('executable_key')}, total {oom.get('total_bytes')} "
              f"B, {len(top)} top arrays, {len(hits)} of them the model's "
              f"parameters; oom dumps +{dumps:.0f}")
        if caught is None or b["header"].get("reason") != "oom" or \
                oom.get("executable_key") != "step" or not hits or \
                dumps != 1 or \
                sum(oom.get("regions", {}).values()) != oom["total_bytes"]:
            fail("14c: the OOM left no loadable bundle")
        torch.cuda.empty_cache()
        _, loss = mo(tx, ty)
        print(f"  after empty_cache: an eager step at batch {TRAIN_B}, loss "
              f"{loss.item():.4f}")
        if not np.isfinite(loss.item()):
            fail("14c: the step after the OOM")
        del mo
    finally:
        memory.uninstall_ledger()
    torch.cuda.empty_cache()
    return ({k: counts["train"][k] + counts["leak"][k] for k in A.LAUNCHES},
            counts["engine"])


class _FitBatches:
    """GP_BATCHES seeded batches, each built on the host and moved to the
    card at its fetch. Before batch GP_POISON's step `w[0, 0]` is set to
    `value` (None: its own value, so a clean epoch's fetches do the same
    work as a poisoned one's) and restored at the next fetch."""

    def __init__(self, torch, seed, w, value=None):
        self.torch, self.seed, self.w, self.value = torch, seed, w, value

    def __iter__(self):
        torch = self.torch
        V = BENCH_GPT["vocab_size"]
        old = None
        for i in range(GP_BATCHES):
            with torch.no_grad():
                if i == GP_POISON:
                    old = self.w[0, 0].clone()
                    self.w[0, 0] = old if self.value is None else self.value
                elif i == GP_POISON + 1:
                    self.w[0, 0] = old
            x, y = _train_batch(torch, V, TRAIN_B, TRAIN_S, self.seed + i)
            yield x.cuda(), y.cuda()


def phase_goodput_fit(torch, models, opt, health, goodput, overlap,
                      resilience, observe, A, root):
    """14d: goodput over `fit` of 13c's bench GPT as a CUDA graph with
    health skip_step: a clean epoch of GP_BATCHES batches, then an epoch
    with FaultPlan delays of GP_DELAY_S on the first GP_DELAYS
    "data.next" fetches and batch GP_POISON's step poisoned (+inf in a
    block weight), then one save_checkpoint (waited for) and one eval
    call. compile holds at least the first call's build; the faulted
    epoch's data_wait is at least the delays requested, equals its fit
    fetches' data.wait spans (booked once), and lies in [slept, slept +
    the clean epoch's], where slept is the delayed fetches' spans: the
    delays as they ran with the fetch around each (a sleep overshoots
    its request, and the woken thread's fetch runs slower); health_skip
    is exactly the poisoned step's span, checkpoint and eval are above 0,
    and the buckets (other included) add up to the run's wall time
    within 1% with overlap_s 0. Exact K1/K2a counts over both epochs."""
    print("== phase 14d: goodput over fit")
    L = BENCH_GPT["num_layers"]
    goodput.uninstall()
    tracker = goodput.install()
    t_run = time.perf_counter()
    spans = []

    def on_span(path, seconds, _attrs):
        # fit's steps run inside its model.fit_epoch span
        if path.endswith("model.step"):
            spans.append(("model.step", seconds))
        elif path.endswith("model.fit_epoch/data.wait"):
            spans.append(("data.wait", seconds))
        elif path.endswith("model.step/model.build"):
            spans.append(("model.build", seconds))

    observe.add_span_listener(on_span)
    try:
        m = models.create_model("gpt", device="cuda", seed=SEED,
                                **BENCH_GPT)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        w = m.blocks[0].attn.Wq
        x0, _ = _train_batch(torch, BENCH_GPT["vocab_size"], TRAIN_B,
                             TRAIN_S, SEED + 40)
        x0 = x0.cuda()
        m.compile([x0], is_train=True, use_graph=True, amp="bfloat16",
                  health=health.HealthMonitor(policy="skip_step",
                                              out_dir=root))
        A.reset_launches()
        s0 = tracker.snapshot()
        m.fit(_FitBatches(torch, SEED + 40, w), epochs=1)
        s1 = tracker.snapshot()
        n1 = sum(1 for p, _ in spans if p == "model.step")
        w1 = sum(1 for p, _ in spans if p == "data.wait")
        plan = resilience.FaultPlan().delay("data.next", GP_DELAY_S,
                                            times=GP_DELAYS)
        fired = []
        fire = plan.fire

        def timed_fire(point, **ctx):
            # the delays as they ran: a sleep overshoots its request
            t0 = time.perf_counter()
            try:
                return fire(point, **ctx)
            finally:
                fired.append(time.perf_counter() - t0)

        plan.fire = timed_fire
        resilience.install_fault_plan(plan)
        try:
            m.fit(_FitBatches(torch, SEED + 40, w, float("inf")),
                  epochs=1)
        finally:
            resilience.clear_fault_plan()
        s2 = tracker.snapshot()
        counts = dict(A.LAUNCHES)
        steps = [s for p, s in spans if p == "model.step"]
        builds = [s for p, s in spans if p == "model.build"]
        poisoned = steps[n1 + GP_POISON]
        m.save_checkpoint(os.path.join(root, "gp_ckpt"), step=2 * GP_BATCHES)
        overlap.wait_for_checkpoints()
        m.eval()
        with torch.no_grad():
            m(x0)
        m.train()
        snap = tracker.snapshot(final=True)
        wall = time.perf_counter() - t_run
    finally:
        observe.remove_span_listener(on_span)
        goodput.uninstall()
    bk = snap["buckets"]
    clean_dw = s1["buckets"]["data_wait"] - s0["buckets"]["data_wait"]
    dw = s2["buckets"]["data_wait"] - s1["buckets"]["data_wait"]
    delays = GP_DELAY_S * GP_DELAYS
    # the faulted epoch's fetches that ran a delay (their fault point took
    # the delay), as their data.wait spans: the delays as they ran, with
    # the fetch around each
    fw = [x for p, x in spans if p == "data.wait"][w1:]
    slow = [i for i, f in enumerate(fired) if f >= GP_DELAY_S]
    slept = sum(fw[i] for i in slow)
    total = sum(bk.values())
    waits = [x * 1e3 for p, x in spans if p == "data.wait"]
    print("  " + tracker.report().replace("\n", "\n  "))
    print(f"  fit's data.wait spans (ms), clean epoch: "
          f"{', '.join(f'{x:.3f}' for x in waits[:w1])}; faulted epoch: "
          f"{', '.join(f'{x:.3f}' for x in waits[w1:])}; the fault points "
          f"(ms): {', '.join(f'{x * 1e3:.3f}' for x in fired)}")
    print(f"  goodput ratio {snap['goodput_ratio']:.4f}; wall {wall:.3f} s "
          f"(tracker {snap['wall_s']:.3f} s), bucket sum {total:.3f} s, "
          f"overlap {snap['overlap_s']}; first call's build "
          f"{builds[0]:.3f} s, all builds {sum(builds):.3f} s, compile "
          f"{bk['compile']:.3f} s; data_wait clean epoch {clean_dw:.6f} s, "
          f"faulted epoch {dw:.6f} s (its spans {sum(fw):.6f} s; the "
          f"{len(slow)} delayed fetches {slept:.6f} s, {delays:.3f} s "
          f"requested); poisoned step {poisoned:.6f} s, health_skip "
          f"{bk['health_skip']:.6f} s")
    if bk["compile"] < builds[0] or dw < delays or len(slow) != GP_DELAYS \
            or abs(dw - sum(fw)) > 1e-9 * dw \
            or not slept <= dw < slept + clean_dw \
            or bk["health_skip"] != poisoned or bk["checkpoint"] <= 0 \
            or bk["eval"] <= 0 or snap["overlap_s"] != 0 \
            or abs(total - wall) > 0.01 * wall:
        fail("14d: the goodput buckets do not account for the run")
    check_launches("14d fit, two epochs", counts,
                   {"flash_fwd": 2 * L * GP_BATCHES,
                    "flash_bwd_fused": 2 * L * GP_BATCHES})
    del m
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 15: build introspection and the supervised training loop
INTRO_REPLAYS = 10        # 15a: calls after the first three
INTRO_TURN_STEPS = 15     # 15a: steps per arm of the callback turns
INTRO_FLOP_TOL = 0.01     # 15a: counted against the shape count, relative
# 15b's depth, cut to make room for phase 20 (from 12 batches, a save
# every 6 steps, the failing step 9 and all 8 layers)
FR_BATCHES = 8            # 15b: seeded batches of fit_resilient
FR_SAVE = 4               # 15b: save_every_steps
FR_FAIL = 6               # 15b: the step that fails
FR_GPT = dict(BENCH_GPT, num_layers=4)   # 15b: 4 of the bench GPT's layers
FR_TOL = 2e-2             # 15b: bf16 amp losses against the plain run
HANG_STEPS, HANG_SAVE, HANG_AT = 8, 4, 5    # 15b's hang controller
PREEMPT_CFG = dict(vocab_size=8192, max_seq=256, dim=512, num_heads=8,
                   num_layers=2)            # 15c: 8c's fp32 GPT
PREEMPT_BATCHES, PREEMPT_SAVE, PREEMPT_AT = 8, 3, 5


def _gpt_step_flops(m, B, S):
    """The GPT training step's FLOPs from its shapes: 3 x 2 x B x S x
    in x out for each attention projection, fc1, fc2 and the head (every
    matmul's input needs its gradient), plus per layer K1's 4 D and K2a's
    10 D flops over the causal pairs. Returns (total, matmul forward)."""
    mm = sum(2 * B * S * p.shape[0] * p.shape[1]
             for n, p in m.named_parameters()
             if p.dim() == 2 and n.rsplit(".", 1)[-1] in
             ("Wq", "Wk", "Wv", "Wo", "W") and "embed" not in n)
    H, L = m.num_heads, len(m.blocks)
    pairs = B * H * S * (S + 1) / 2
    return 3 * mm + L * 14 * (m.dim // H) * pairs, mm


def _records(observe, since, kinds=("compile", "recompile")):
    return [r for r in list(observe.get_registry().recent)[since:]
            if r.get("kind") in kinds]


def _check_execs(what, execs, fp):
    got = [e for e in execs or () if e.get("key") == "step"]
    pairs = [(e["key"], e["fingerprint"]) for e in execs or ()]
    print(f"  {what} executables: {pairs}")
    if not got or got[-1]["fingerprint"] != fp:
        fail(f"15a: the {what} does not carry the step build {fp}")


def phase_introspect(torch, models, opt, device, introspect, observe,
                     memory, health, watchdog, engine, serving, resilience,
                     A, root):
    """15a: introspect on the bench GPT graph step (b8 x 1024, bf16 amp,
    SGD, observe on, an EventLog and capture_hlo in `root`, verbosity 1):
    the first three calls give exactly one `compile` record for `step`,
    its record trace > 0, lower 0.0, compile (the capture) > 0, an op
    listing naming L flash_fwd and L flash_bwd_fused launches and a .dot
    of the graph; the counted flops within INTRO_FLOP_TOL of the shape
    count, the bytes above the parameters' and optimizer states'; MFU in
    (0, 100] against the H100 SXM peak and PrintTimeProfiling's GFLOP and
    MFU lines at verbosity 2; ten more calls add only `step` records,
    8 + 8 K1/K2a a replay; the replayed step with the MFU callback set and
    cleared in same-call turns; estimate_fit from the executable beside a
    replayed step's peak; one call at batch 12: one batch_bucket
    recompile; an eval build; flight and hang bundles carrying the step
    build; then GPT-2-small bf16 generate b8 (prompt 128, +32) twice (one
    serving.prefill and one serving.decode_scan build) and 13a's engine
    (serving.engine_prefill, serving.engine_step), with exact K1/K3/K4
    counts. Returns the counted windows."""
    import contextlib
    import io as _io
    print("== phase 15a: introspect on the bench GPT graph step")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    by_path = {}
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))
    introspect.reset()
    observe.enable(True)
    observe.get_registry().reset()
    log = os.path.join(root, "events.jsonl")
    observe.set_event_log(log)
    hlo = os.path.join(root, "hlo")
    introspect.capture_hlo(hlo)
    m = models.create_model("gpt", device="cuda", seed=SEED, **BENCH_GPT)
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    m.compile([tx], is_train=True, use_graph=True, amp="bfloat16")
    dev = device.of(m._device)
    dev.SetVerbosity(1)
    dev.SetSkipIteration(0)
    dev.step_times = []
    try:
        torch.cuda.synchronize()
        A.reset_launches()
        t0 = time.perf_counter()
        for _ in range(3):
            m(tx, ty)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        counts = dict(A.LAUNCHES)
        check_launches("15a first three calls", counts,
                       {"flash_fwd": 3 * L, "flash_bwd_fused": 3 * L})
        by_path["introspect_first"] = counts
        rec = introspect.last_build("step")
        builds = [r for r in observe.EventLog.read(log)
                  if r["kind"] in ("compile", "recompile")]
        ph = rec["phases"]
        with open(rec["hlo_path"]) as f:
            text = f.read()
        n_fwd = text.count("kernel flash_fwd(")
        n_bwd = text.count("kernel flash_bwd_fused(")
        dot = rec.get("graph_path")
        print(f"  first three calls {first_s:.2f} s; build records "
              f"{[(r['kind'], r['key']) for r in builds]}; phases trace "
              f"{ph['trace']:.3f} s, lower {ph['lower']}, compile (capture) "
              f"{ph['compile']:.3f} s; op listing "
              f"{os.path.basename(rec['hlo_path'])}: "
              f"{text.count(chr(10))} lines, {n_fwd} flash_fwd + {n_bwd} "
              f"flash_bwd_fused launches; graph dump "
              f"{os.path.basename(dot) if dot else None} "
              f"({os.path.getsize(dot) if dot and os.path.exists(dot) else 0}"
              f" bytes)")
        if [(r["kind"], r["key"]) for r in builds] != [("compile", "step")] \
                or not ph["trace"] > 0 or ph["lower"] != 0.0 \
                or not ph["compile"] > 0 or n_fwd != L or n_bwd != L \
                or not dot or not os.path.exists(dot) \
                or not os.path.getsize(dot):
            fail(f"15a: the step build {rec['phases']}, records {builds}")
        # the count against the shapes
        flops = rec["cost"]["flops"]
        want, mm = _gpt_step_flops(m, TRAIN_B, TRAIN_S)
        held = m._step_state_bytes()
        nbytes = rec["cost"]["bytes accessed"]
        print(f"  counted {flops / 1e12:.4f} TFLOP a step against "
              f"{want / 1e12:.4f} from the shapes (matmuls {3 * mm / 1e12:.4f}"
              f", K1 + K2a {(want - 3 * mm) / 1e12:.4f}): relative "
              f"difference {abs(flops - want) / want:.3e} (tol "
              f"{INTRO_FLOP_TOL}); {nbytes / 1e9:.3f} GB accessed, the "
              f"parameters, buffers and optimizer states {held / 1e9:.3f} GB"
              f"; {rec['cost']['aten ops']:.0f} aten ops, "
              f"{rec['cost']['kernel launches']:.0f} kernel launches "
              f"booked; memory {rec['memory']}")
        if abs(flops - want) > INTRO_FLOP_TOL * want or nbytes <= held:
            fail("15a: the counted cost disagrees with the shapes")
        mfu = observe.get_registry().get("singa_mfu_pct")
        peak = introspect.peak_tflops()
        print(f"  singa_mfu_pct {mfu.value() if mfu else None} against "
              f"{peak} TFLOP/s ({torch.cuda.get_device_name(0)})")
        if mfu is None or not 0 < mfu.value() <= 100:
            fail("15a: no MFU in (0, 100]")
        # the cached path (its fenced times are PrintTimeProfiling's)
        n_log = len(observe.EventLog.read(log))
        dev.step_times = []
        torch.cuda.synchronize()
        A.reset_launches()
        for _ in range(INTRO_REPLAYS):
            m(tx, ty)
        torch.cuda.synchronize()
        counts = dict(A.LAUNCHES)
        kinds = [r["kind"] for r in observe.EventLog.read(log)[n_log:]]
        print(f"  {INTRO_REPLAYS} more calls: EventLog kinds "
              f"{sorted(set(kinds))} x {len(kinds)}")
        if kinds != ["step"] * INTRO_REPLAYS:
            fail(f"15a: the cached path wrote {kinds}")
        check_launches("15a replays", counts,
                       {"flash_fwd": L * INTRO_REPLAYS,
                        "flash_bwd_fused": L * INTRO_REPLAYS})
        by_path["introspect_replays"] = counts
        dev.SetVerbosity(2)
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            dev.PrintTimeProfiling()
        dev.SetVerbosity(1)
        print("  " + buf.getvalue().strip().replace("\n", "\n  "))
        if "GFLOP/step" not in buf.getvalue() or "MFU:" not in \
                buf.getvalue():
            fail("15a: PrintTimeProfiling printed no GFLOP or MFU line")
        arms = {"set": [], "cleared": []}
        for arm in ("set", "cleared", "cleared", "set"):
            observe.set_step_callback(
                introspect._mfu_callback if arm == "set" else None)
            for _ in range(INTRO_TURN_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m(tx, ty)
                torch.cuda.synchronize()
                arms[arm].append((time.perf_counter() - t0) * 1e3)
        observe.set_step_callback(introspect._mfu_callback)
        med = {k: statistics.median(v) for k, v in arms.items()}
        print(f"  replayed step, MFU callback set {med['set']:.3f} ms, "
              f"cleared {med['cleared']:.3f} ms (median of "
              f"{2 * INTRO_TURN_STEPS} each, same-call turns; overhead "
              f"{med['set'] - med['cleared']:+.3f} ms, recorded)")
        # the fit estimate against a replayed step's peak
        fit = memory.estimate_fit(m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m(tx, ty)
        torch.cuda.synchronize()
        peak_b = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_reserved()
        print(f"  estimate_fit: source {fit['source']}, estimated "
              f"{fit['estimated_peak_bytes'] / 2**30:.3f} GiB (arguments "
              f"{fit['exec_arguments_bytes'] / 2**30:.3f}, outputs "
              f"{fit['exec_outputs_bytes'] / 2**30:.3f}, temps "
              f"{(fit['exec_temps_bytes'] or 0) / 2**30:.3f} GiB), fits "
              f"{fit['fits']}; a replayed step's peak allocation "
              f"{peak_b / 2**30:.3f} GiB (the process's; a replay "
              f"allocates nothing, its graph's pool is reserved: "
              f"{reserved / 2**30:.3f} GiB reserved)")
        if fit["source"] != "executable" or not fit["exec_temps_bytes"] \
                or fit["fits"] is not True:
            fail(f"15a: estimate_fit {fit}")
        # blame
        since = len(observe.get_registry().recent)
        x12, y12 = (t.cuda() for t in _train_batch(torch, V, 12, TRAIN_S,
                                                   SEED + 4))
        m(x12, y12)
        recs = _records(observe, since)
        c = observe.get_registry().get("singa_recompile_total")
        n_bb = c.value(reason="batch_bucket", key="step") if c else 0
        got = [(r["kind"], r["reason"], r["detail"]) for r in recs]
        print(f"  one call at batch 12: {got}; "
              f"singa_recompile_total{{batch_bucket, step}} {n_bb}")
        if [(r["kind"], r["key"], r["reason"], r["detail"]) for r in recs] \
                != [("recompile", "step", "batch_bucket",
                     "arg `arg0` batch 8->12 crossed bucket 8->16")] \
                or n_bb != 1:
            fail("15a: the batch-12 call's blame")
        del x12, y12
        # eval
        since = len(observe.get_registry().recent)
        m.eval()
        with torch.no_grad():
            out = m(tx)
        m.train()
        recs = _records(observe, since)
        print(f"  m.eval(); m(tx): {[(r['kind'], r['key']) for r in recs]}, "
              f"logits {tuple(out.shape)}")
        if not recs or any(r["key"] != "eval" for r in recs):
            fail("15a: the eval call registered no eval build")
        del out
        # the bundles
        fp = introspect.latest_fingerprint("step")
        fr = health.FlightRecorder(out_dir=root)
        fr.record({"step": 1, "loss": 1.0})
        _check_execs("flight bundle", health.load_flight_bundle(
            fr.dump(reason="nonfinite_grad", step=1))["header"]
            ["executables"], fp)
        wd = watchdog.install_watchdog(action="warn", out_dir=root)
        try:
            path = wd.dump_hang_bundle("step", 1.0)
        finally:
            watchdog.uninstall_watchdog()
        _check_execs("hang bundle", watchdog.load_hang_bundle(path)[
            "header"]["executables"], fp)
    finally:
        dev.SetVerbosity(0)
        dev.step_times = []
        introspect.capture_hlo(None)
        observe.set_event_log(None)
    del m
    torch.cuda.empty_cache()

    # serving: generate, then 13a's engine
    gm = models.create_model("gpt", device="cuda", seed=SEED, **GPT2_SMALL)
    Lg = len(gm.blocks)
    prompts = np.random.RandomState(SEED + 15).randint(
        0, gm.vocab_size, (8, 128)).astype(np.int32)
    since = len(observe.get_registry().recent)
    torch.cuda.synchronize()
    A.reset_launches()
    t0 = time.perf_counter()
    a = gm.generate(prompts, 32, dtype="bfloat16")
    t1 = time.perf_counter()
    b = gm.generate(prompts, 32, dtype="bfloat16")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = dict(A.LAUNCHES)
    recs = _records(observe, since)
    keys = [(r["kind"], r["key"]) for r in recs]
    print(f"  GPT-2-small generate b8 prompt 128 +32, bf16, twice: "
          f"{t1 - t0:.3f} s (the build: counted), {t2 - t1:.3f} s; builds "
          f"{keys}; equal tokens {bool((a == b).all())}; scan build "
          f"{introspect.last_build('serving.decode_scan')['cost']}")
    if sorted(keys) != [("compile", "serving.decode_scan"),
                        ("compile", "serving.prefill")]:
        fail(f"15a: generate's builds {keys}")
    check_launches("15a generate x 2", counts,
                   {"flash_fwd": 2 * Lg, "flash_decode": 2 * Lg * 31})
    by_path["introspect_generate"] = counts
    wl = serving.poisson_workload(**SLO_WORKLOAD)
    since = len(observe.get_registry().recent)
    hs, wall, counts, pre, steps, eng = _engine_run(
        torch, gm, engine, resilience, A, wl)
    eng.stop()
    keys = sorted({r["key"] for r in _records(observe, since)})
    print(f"  13a's engine: {len(hs)} requests in {wall:.3f} s, {pre} "
          f"prefills, {steps} steps; build keys {keys}")
    if keys != ["serving.engine_prefill", "serving.engine_step"] or any(
            h.outcome != "completed" for h in hs):
        fail(f"15a: the engine's builds {keys}")
    check_launches("15a engine", counts, {"flash_fwd": Lg * pre,
                                          "paged_attention": Lg * steps})
    by_path["introspect_engine"] = counts
    del gm, eng, hs
    torch.cuda.empty_cache()
    return by_path


def _timed(obj, name, sink):
    """Wrap obj.name to append each call's seconds to `sink`."""
    fn = getattr(obj, name)

    def wrapper(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            sink.append(time.perf_counter() - t0)
    setattr(obj, name, wrapper)


def _plain_losses(torch, m, batches):
    out = [m(*b)[1] for b in batches]
    return torch.stack([o.float() for o in out]).cpu().tolist()


def phase_fit_resilient(torch, models, opt, resilience, watchdog, observe,
                        A, root):
    """15b: fit_resilient on the bench GPT graph step (b8 x 1024, bf16 amp)
    over FR_BATCHES seeded batches, save_every_steps FR_SAVE, keep 2,
    async saves, under FaultPlan().fail("ckpt.save", nth=1).fail("step",
    step=FR_FAIL): completed, 1 restart, final step FR_BATCHES, as many
    history entries, one retry, the restore at step FR_SAVE replaying
    without stepping, step_FR_SAVE and step_FR_BATCHES manifested (read
    and validated, fingerprints naming the step build), L + L K1/K2a a
    model call (FR_BATCHES + FR_FAIL - FR_SAVE calls) on the bench GPT
    cut to FR_GPT's layers; the losses within FR_TOL
    of a plain run of the same seeded model and batches. Then a second
    controller over a fresh directory with a static step deadline
    (action abort) and a FaultPlan delay past abort_at at step HANG_AT:
    HangError restarts it from step HANG_SAVE, hang_restart emitted, the
    hang report cleared, completed. Returns the counted windows."""
    import shutil
    print("== phase 15b: fit_resilient on the bench GPT graph step "
          f"({FR_GPT['num_layers']} layers)")
    L, V = FR_GPT["num_layers"], FR_GPT["vocab_size"]
    batches = [tuple(t.cuda() for t in _train_batch(torch, V, TRAIN_B,
                                                    TRAIN_S, SEED + 40 + i))
               for i in range(FR_BATCHES)]

    def build():
        g = models.create_model("gpt", device="cuda", seed=SEED,
                                **FR_GPT)
        g.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        g.compile([batches[0][0]], is_train=True, use_graph=True,
                  amp="bfloat16")
        return g

    ref_m = build()
    ref = _plain_losses(torch, ref_m, batches)
    del ref_m
    torch.cuda.empty_cache()
    m = build()
    saves, loads = [], []
    _timed(m, "save_checkpoint", saves)
    _timed(m, "load_checkpoint", loads)
    ck = os.path.join(root, "fr")
    observe.get_registry().reset()
    since = len(observe.get_registry().recent)
    plan = resilience.install_fault_plan(resilience.FaultPlan().fail(
        "ckpt.save", nth=1).fail("step", step=FR_FAIL))
    torch.cuda.synchronize()
    A.reset_launches()
    t0 = time.perf_counter()
    try:
        rep = resilience.fit_resilient(
            m, batches, ck, save_every_steps=FR_SAVE, keep=2,
            async_save=True, handle_signals=False, retry_seed=SEED,
            backoff_s=0.05)
    finally:
        resilience.clear_fault_plan()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = dict(A.LAUNCHES)
    reg = observe.get_registry()
    events = [r["event"] for r in list(reg.recent)[since:]
              if r.get("kind") == "resilience"]
    retries = reg.get("singa_resilience_retries_total")
    retry_s = reg.get("singa_resilience_retry_seconds_total")
    hist = dict(rep["history"])
    worst = max(abs(hist[k] - ref[k]) / abs(ref[k]) for k in range(
        FR_BATCHES)) if sorted(hist) == list(range(FR_BATCHES)) else None
    print(f"  report: status {rep['status']}, restarts {rep['restarts']}, "
          f"final step {rep['final_step']}, resumed step "
          f"{rep['resumed_step']}, {len(rep['history'])} history entries; "
          f"{wall:.2f} s; fired {plan.fired}; events {events}")
    print(f"  retries {retries.value() if retries else 0} "
          f"({retry_s.value() if retry_s else 0:.3f} s slept); save "
          f"blocking s {[round(x, 3) for x in saves]}; restore s "
          f"{[round(x, 3) for x in loads]}")
    got = [round(hist.get(k, float("nan")), 4) for k in range(FR_BATCHES)]
    print(f"  losses {got} "
          f"against a plain run {[round(x, 4) for x in ref]}: largest "
          f"relative difference {worst} (tol {FR_TOL})")
    if rep["status"] != "completed" or rep["restarts"] != 1 \
            or rep["final_step"] != FR_BATCHES \
            or len(rep["history"]) != FR_BATCHES \
            or not retries or retries.value() != 1 \
            or events.count("restart") != 1 or "resume" not in events \
            or worst is None or worst > FR_TOL:
        fail(f"15b: fit_resilient {rep}")
    resumed = [r for r in list(reg.recent)[since:]
               if r.get("event") == "resume"]
    if resumed[-1]["resumed_step"] != FR_SAVE:
        fail(f"15b: restored step {resumed[-1]['resumed_step']}")
    for s in (FR_SAVE, FR_BATCHES):
        d = os.path.join(ck, f"step_{s}")
        man = resilience.read_manifest(d)
        probs = resilience.validate_manifest(man, m) if man else ["none"]
        keys = [h["key"] for h in (man or {}).get("hlo_fingerprints", [])]
        print(f"  step_{s}: manifest status {man and man['status']}, "
              f"problems {probs}, fingerprints {keys}")
        if man is None or probs or "step" not in keys:
            fail(f"15b: the manifest of step_{s}")
    calls = FR_BATCHES + (FR_FAIL - FR_SAVE)
    check_launches(f"15b fit_resilient ({FR_BATCHES} steps + "
                   f"{FR_FAIL - FR_SAVE} after the restore)",
                   counts, {"flash_fwd": L * calls,
                            "flash_bwd_fused": L * calls})
    by_path = {"fit_resilient": counts}
    shutil.rmtree(ck, ignore_errors=True)

    # a hang: the watchdog aborts a stalled step, the controller restarts
    dl = WD_STEP_S
    wd = watchdog.install_watchdog(action="abort", dump_at=1.5,
                                   abort_at=2.0, hard_at=100.0,
                                   poll_interval_s=WD_POLL_S,
                                   deadlines={"step": dl}, out_dir=root)
    delay = (wd.abort_at + 1.0) * dl
    since = len(observe.get_registry().recent)
    loads.clear()
    resilience.install_fault_plan(resilience.FaultPlan().delay(
        "step", delay, step=HANG_AT))
    torch.cuda.synchronize()
    A.reset_launches()
    t0 = time.perf_counter()
    try:
        rep = resilience.TrainController(
            m, os.path.join(root, "hang"), save_every_steps=HANG_SAVE,
            max_restarts=1, handle_signals=False).fit(batches[:HANG_STEPS])
        report = watchdog.hang_report()
        lb = dict(wd.last_breach or {})
    finally:
        resilience.clear_fault_plan()
        watchdog.uninstall_watchdog()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = dict(A.LAUNCHES)
    ev = [r for r in list(observe.get_registry().recent)[since:]
          if r.get("kind") == "resilience"]
    names = [r["event"] for r in ev]
    res = [r for r in ev if r["event"] == "resume"]
    print(f"  hang: static step deadline {dl} s, delay {delay:.3f} s at "
          f"step {HANG_AT}: status {rep['status']}, restarts "
          f"{rep['restarts']}, final step {rep['final_step']}, restored "
          f"step {res[-1]['resumed_step'] if res else None} in "
          f"{[round(x, 3) for x in loads]} s; {wall:.2f} s; last breach "
          f"stage {lb.get('stage')} at {lb.get('seconds')} s; events "
          f"{names}; hang_report after {report}")
    if rep["status"] != "completed" or rep["restarts"] != 1 \
            or "hang_restart" not in names or report is not None \
            or not res or res[-1]["resumed_step"] != HANG_SAVE:
        fail(f"15b: the hang restart {rep}")
    calls = HANG_STEPS + (HANG_AT + 1 - HANG_SAVE)
    check_launches("15b hang restart", counts,
                   {"flash_fwd": L * calls, "flash_bwd_fused": L * calls})
    by_path["hang_restart"] = counts
    shutil.rmtree(os.path.join(root, "hang"), ignore_errors=True)
    del m, batches
    torch.cuda.empty_cache()
    return by_path


def phase_preempt_resume(torch, models, opt, resilience, A, root):
    """15c: 8c's fp32 GPT (dim 512, 2 layers, S 256) under a controller
    with save_every_steps PREEMPT_SAVE and a real SIGTERM at step
    PREEMPT_AT (FaultPlan.send_signal, while the controller's handler is
    installed): preempted, the final manifest's status "preempt"; a fresh
    model from the same seed with a new controller over the directory
    resumes at PREEMPT_AT and completes, its losses within GRAPH_TOL of
    an uninterrupted run's. Returns the counted window."""
    import signal
    print("== phase 15c: preempt and resume (fp32)")
    cfg, L = PREEMPT_CFG, PREEMPT_CFG["num_layers"]
    batches = [tuple(t.cuda() for t in _train_batch(
        torch, cfg["vocab_size"], 2, cfg["max_seq"], SEED + 60 + i))
        for i in range(PREEMPT_BATCHES)]

    def build():
        g = models.create_model("gpt", device="cuda", seed=SEED + 5, **cfg)
        g.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        g.compile([batches[0][0]], is_train=True, use_graph=True)
        return g

    ref = _plain_losses(torch, build(), batches)
    ck = os.path.join(root, "preempt")
    prev = signal.getsignal(signal.SIGTERM)
    resilience.install_fault_plan(resilience.FaultPlan().send_signal(
        "step", signal.SIGTERM, step=PREEMPT_AT))
    torch.cuda.synchronize()
    A.reset_launches()
    try:
        r1 = resilience.TrainController(
            build(), ck, save_every_steps=PREEMPT_SAVE,
            handle_signals=True).fit(batches)
    finally:
        resilience.clear_fault_plan()
    if signal.getsignal(signal.SIGTERM) is not prev:
        fail("15c: the SIGTERM handler was not restored")
    _path, man = resilience.latest_checkpoint(ck)
    ctrl = resilience.TrainController(build(), ck,
                                      save_every_steps=PREEMPT_SAVE,
                                      handle_signals=False)
    r2 = ctrl.fit(batches)
    torch.cuda.synchronize()
    counts = dict(A.LAUNCHES)
    hist = dict(r2["history"])
    rel = max(abs(hist[k] - ref[k]) / abs(ref[k]) for k in hist)
    print(f"  first run: {r1['status']} at step {r1['final_step']}, "
          f"manifest step {man['step']} status {man['status']}; resumed "
          f"at {r2['resumed_step']} (resume_restore_s "
          f"{r2['resume_restore_s']}), {r2['status']}, losses from step "
          f"{PREEMPT_AT} {[round(hist[k], 6) for k in sorted(hist)]} "
          f"against uninterrupted {[round(x, 6) for x in ref[PREEMPT_AT:]]}"
          f": relative difference {rel:.3e} (tol {GRAPH_TOL})")
    if r1["status"] != "preempted" or r1["final_step"] != PREEMPT_AT \
            or man["status"] != "preempt" or man["step"] != PREEMPT_AT \
            or r2["status"] != "completed" \
            or r2["resumed_step"] != PREEMPT_AT \
            or sorted(hist) != list(range(PREEMPT_AT, PREEMPT_BATCHES)) \
            or not rel <= GRAPH_TOL:
            fail(f"15c: preempt {r1}, resume {r2}")
    check_launches("15c preempt and resume", counts,
                   {"flash_fwd": L * PREEMPT_BATCHES,
                    "flash_bwd_fused": L * PREEMPT_BATCHES})
    import shutil
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 16: data parallel on the card (NCCL at world size 1: the host has
# one card, and NCCL refuses two ranks on one device)
DP_PAYLOAD = 16 * 2**20      # 16a: fp32 elements of the timed 64 MB payload
DP_STEPS = 5                 # 16b: replayed steps of each strategy
DP_TOL = 2e-2                # 16b: bf16 amp losses, DistOpt against none
#: 16b: each strategy as the DistOpt call the GPT's step makes
DP_STRATEGIES = {
    "plain": lambda o, loss: o.backward_and_update(loss),
    "half": lambda o, loss: o.backward_and_update_half(loss),
    "partial": lambda o, loss: o.backward_and_partial_update(
        loss, num_partitions=4),
    "topk": lambda o, loss: o.backward_and_sparse_update(
        loss, spars=0.05, topK=True),
    "threshold": lambda o, loss: o.backward_and_sparse_update(
        loss, spars=1e-3, topK=False),
}
#: 16b: calls before the timed replays (partial: a warm-up and a capture
#: for each of its 4 tags)
DP_WARM = {"partial": 8}


def _dist_opt(opt, mesh, strategy, **kw):
    """A DistOpt(SGD(0.1, 0.9, wd 1e-5)) over `mesh` whose call (the
    GPT's `self.optimizer(loss)`) runs `strategy`."""
    run = DP_STRATEGIES[strategy]

    class Strategy(opt.DistOpt):
        def __call__(self, loss):
            return run(self, loss)

    return Strategy(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5),
                    mesh=mesh, **kw)


def _init_world1(distributed):
    """distributed.init() as one process: SINGA_COORDINATOR a free
    localhost port, SINGA_NPROCS=1, SINGA_PROC_ID=0."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(SINGA_COORDINATOR=f"127.0.0.1:{port}",
                      SINGA_NPROCS="1", SINGA_PROC_ID="0")
    distributed.init()


def phase_dp_comm(torch, distributed, parallel):
    """16a: distributed.init() over NCCL from SINGA_COORDINATOR (a free
    localhost port), SINGA_NPROCS=1, SINGA_PROC_ID=0; every verb of the
    communicator on random CUDA tensors (fp32 and bf16) against its plain
    math, exact at one rank (the half path is x.bfloat16(), topk's and
    threshold's out + residual is x bitwise); each verb's device time at a
    64 MB fp32 payload. Returns the data mesh."""
    print("== phase 16a: the communicator over NCCL (world size 1)")
    t0 = time.perf_counter()
    _init_world1(distributed)
    mesh = parallel.data_parallel_mesh()
    comm = parallel.Communicator(mesh=mesh)
    print(f"  init: backend {torch.distributed.get_backend()}, rank "
          f"{distributed.process_index()} of {distributed.process_count()}, "
          f"mesh {dict(mesh.shape)}, {time.perf_counter() - t0:.2f} s")
    if torch.distributed.get_backend() != "nccl" or comm.group is None \
            or comm.world_size != 1:
        fail("16a: distributed.init() did not form a one-rank NCCL group")
    g = torch.Generator(device="cuda").manual_seed(SEED + 70)
    bad = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(4096, 64, generator=g, device="cuda").to(dtype)
        got = {"all_reduce": (comm.all_reduce(x), x),
               "all_reduce_half": (comm.all_reduce_half(x),
                                   x.bfloat16().to(dtype)),
               "all_gather": (comm.all_gather(x), x),
               "broadcast": (comm.broadcast(x), x),
               "reduce_scatter": (comm.reduce_scatter(x), x),
               "all_reduce_max": (comm.all_reduce_max(x), x)}
        out, res = comm.sparse_all_reduce_topk(x, 0.05)
        got["topk out+res"] = (out + res, x)
        if int((out != 0).sum()) != int(x.numel() * 0.05):
            bad.append(f"{dtype} topk sent {int((out != 0).sum())}")
        out, res = comm.sparse_all_reduce_threshold(x, 1.0)
        got["threshold out+res"] = (out + res, x)
        flags = (bool(comm.agree_any(torch.tensor(True, device="cuda"))),
                 bool(comm.agree_any(torch.tensor(False, device="cuda"))))
        if flags != (True, False):
            bad.append(f"agree_any {flags}")
        for name, (a, b) in got.items():
            if a.shape != b.shape or not torch.equal(a, b):
                bad.append(f"{dtype} {name}")
    print(f"  every verb on (4096, 64) fp32 and bf16 against its plain "
          f"math at one rank: {'exact' if not bad else bad}")
    if bad:
        fail(f"16a: {bad}")
    x = torch.randn(DP_PAYLOAD, generator=g, device="cuda")
    timed = {"all_reduce": lambda: comm.all_reduce(x),
             "all_reduce_half": lambda: comm.all_reduce_half(x),
             "all_gather": lambda: comm.all_gather(x),
             "broadcast": lambda: comm.broadcast(x),
             "reduce_scatter": lambda: comm.reduce_scatter(x),
             "all_reduce_max": lambda: comm.all_reduce_max(x),
             "sparse_all_reduce_topk 0.05":
                 lambda: comm.sparse_all_reduce_topk(x, 0.05),
             "sparse_all_reduce_threshold 1.0":
                 lambda: comm.sparse_all_reduce_threshold(x, 1.0)}
    for name, fn in timed.items():
        print(f"  {name} of 64 MB fp32 at one rank: "
              f"{time_ms(torch, fn, n=10):.4f} ms device time")
    return mesh


def _dp_listing(path):
    """{build file: [op listing lines]} of the builds under `path`."""
    out = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".ops.txt"):
            with open(os.path.join(path, f)) as fh:
                out[f] = fh.read()
    return out


def _dp_check_listing(utils, strategy, texts, n_params):
    """The c10d ops of each build: plain and half one all-reduce per
    parameter (plus the loss's mean), partial one per parameter of the
    tag's partition in each of its 4 builds, sparse two all-gathers per
    parameter (plus the logits') and no dense all-reduce."""
    dense = [utils.dense_allreduce_types(t) for t in texts.values()]
    lines = [t.splitlines() for t in texts.values()]
    scalars = [sum(ln.startswith("c10d.allreduce_") for ln in ls) - len(d)
               for ls, d in zip(lines, dense)]
    gathers = [sum(ln.startswith("c10d.allgather_") for ln in ls)
               for ls in lines]
    print(f"  {strategy}: {len(texts)} build(s); dense all-reduces "
          f"{[len(d) for d in dense]}, scalar all-reduces {scalars}, "
          f"all-gathers {gathers} ({n_params} parameters)")
    if strategy == "partial":
        want = sorted(len(range(t, n_params, 4)) for t in range(4))
        ok = len(texts) == 4 and sorted(len(d) for d in dense) == want
    elif strategy in ("topk", "threshold"):
        ok = len(texts) == 1 and not dense[0] \
            and gathers[0] == 2 * n_params + 1
    else:
        ok = len(texts) == 1 and len(dense[0]) == n_params \
            and scalars[0] == 1
    if not ok:
        fail(f"16b: {strategy}'s builds hold other collectives")


def _nccl_kernels(torch, fn):
    """Launches of kernels named nccl* in one call of `fn` under the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "nccl" in e.key.lower())


def phase_dp_train(torch, models, opt, introspect, utils, mesh, A, root):
    """16b: the bench GPT (b8 x 1024, bf16 amp) as a CUDA graph under
    DistOpt with each strategy (plain, half, partial over 4 partitions,
    top-K 0.05, threshold): 2 calls (partial 8) then DP_STEPS replays,
    exactly 8 + 8 K1/K2a a replay, each build's op listing checked
    (`_dp_check_listing`); plain's losses within DP_TOL of the same model
    without DistOpt; the replayed step's median beside the plain graph
    step's (before and after); NCCL kernels of one replay counted from
    the profiler (printed, not required). Then phase 8's fp32 GPT, plain
    DistOpt against none, as graphs: within GRAPH_TOL. Returns the
    replays' launch counts."""
    print("== phase 16b: the bench GPT under DistOpt (NCCL, world size 1)")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))

    # the bench GPT's six models are copies of one drawn on the card (a
    # draw of its ~438 M normals takes seconds on the host; 19a's
    # `_pp_built` does the same)
    fresh = models.create_model("gpt", device="cuda", seed=SEED,
                                **BENCH_GPT)

    def build(strategy, cfg=None, amp="bfloat16", seed=SEED, x=tx):
        m = (copy.deepcopy(fresh) if cfg is None else
             models.create_model("gpt", device="cuda", seed=seed, **cfg))
        m.set_optimizer(
            _dist_opt(opt, mesh, strategy) if strategy else
            opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([x], is_train=True, use_graph=True, amp=amp)
        return m

    base = build(None)
    bl = _steps(torch, base, tx, ty, 2)[0]
    bl2, bms = _steps(torch, base, tx, ty, DP_STEPS)
    base_losses = bl + bl2
    n_params = len(base._raw_params())
    med, total = {}, {}
    for strategy in DP_STRATEGIES:
        d = os.path.join(root, f"dp_{strategy}")
        m = build(strategy)
        introspect.capture_hlo(d)
        try:
            warm = _steps(torch, m, tx, ty, DP_WARM.get(strategy, 2))[0]
        finally:
            introspect.capture_hlo(None)
        if m.graph_backend != "cuda_graph":
            fail(f"16b {strategy} ran {m.graph_backend!r}")
        torch.cuda.synchronize()
        A.reset_launches()
        losses, ms = _steps(torch, m, tx, ty, DP_STEPS)
        counts = dict(A.LAUNCHES)
        check_launches(f"16b {strategy} replays", counts,
                       {"flash_fwd": L * DP_STEPS,
                        "flash_bwd_fused": L * DP_STEPS})
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        _dp_check_listing(utils, strategy, _dp_listing(d), n_params)
        med[strategy] = statistics.median(ms)
        print(f"  {strategy}: builds {m._build_count}, losses "
              f"{[round(v, 4) for v in warm + losses]}; replayed step ms "
              f"{', '.join(f'{x:.2f}' for x in ms)}, median "
              f"{med[strategy]:.2f}")
        if strategy == "plain":
            rel = max(abs(a - b) / abs(a)
                      for a, b in zip(base_losses, warm + losses))
            print(f"  plain DistOpt against no DistOpt, {len(losses) + 2} "
                  f"steps: largest relative loss difference {rel:.3e} "
                  f"(tol {DP_TOL}); NCCL kernels in one replay: "
                  f"{_nccl_kernels(torch, lambda: m(tx, ty))}")
            if not rel <= DP_TOL:
                fail("16b: plain DistOpt's losses part from the model's "
                     "without DistOpt")
        del m
        torch.cuda.empty_cache()
    bms += _steps(torch, base, tx, ty, DP_STEPS)[1]
    med["none"] = statistics.median(bms)
    print("  replayed step median ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
          + f" (no DistOpt, two turns of {DP_STEPS}, before and after)")
    del base, fresh
    torch.cuda.empty_cache()

    cfg = dict(vocab_size=8192, max_seq=256, dim=512, num_heads=8,
               num_layers=2)
    fx, fy = (t.cuda() for t in _train_batch(torch, cfg["vocab_size"], 2,
                                             256, SEED + 4))
    runs = {}
    for strategy in (None, "plain"):
        m = build(strategy, cfg, None, SEED + 5, fx)
        runs[strategy] = (m, torch.stack([m(fx, fy)[1]
                                          for _ in range(EXACT_STEPS)])
                          .tolist())
    (m0, l0), (m1, l1) = runs[None], runs["plain"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(l0, l1))
    serr, same = _compare_states(torch, m0._raw_states(), m1._raw_states())
    print(f"  fp32 GPT (dim 512, 2 layers, S 256), graphs, plain DistOpt "
          f"against none, {EXACT_STEPS} steps: relative loss difference "
          f"{rel:.3e}, parameters {serr:.3e} (tol {GRAPH_TOL}); bitwise: "
          f"{same and l0 == l1}")
    if not (rel <= GRAPH_TOL and serr <= GRAPH_TOL):
        fail("16b: fp32 plain DistOpt differs from the step without it")
    del runs, m0, m1
    torch.cuda.empty_cache()
    return total


def phase_dp_resnet(torch, models, opt, tensor, device, mesh):
    """16c: ResNet-50 b32 bf16 as a CUDA graph through
    Classifier.train_one_batch(x, y, dist_option) with plain and
    sparseTopK under DistOpt, and without DistOpt, on cuDNN's
    deterministic algorithms: 3 steps each, finite losses; plain's
    losses, parameters and running statistics within GRAPH_TOL of the
    run without DistOpt; sparseTopK's running statistics after its first
    step (computed before any update) within GRAPH_TOL of it; the
    replayed step times."""
    print(f"== phase 16c: ResNet-50 b{RESNET_B} bf16 through "
          "Classifier's dist_option")
    dev = device.best_device()
    rng = np.random.RandomState(SEED + 11)
    x = rng.randn(RESNET_B, 3, RESNET_HW, RESNET_HW).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, RESNET_B).astype(np.int32)
    tx = tensor.Tensor(data=x, device=dev)
    ty = tensor.from_numpy(y, device=dev)

    def stats(m):
        return {k: v.detach().clone() for k, v in m._raw_states().items()
                if "running" in k}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    try:
        for option in (None, "plain", "sparseTopK"):
            dev.SetRandSeed(SEED)
            m = models.create_model("resnet50", num_channels=3,
                                    num_classes=RESNET_CLASSES)
            sgd = opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5)
            m.set_optimizer(opt.DistOpt(sgd, mesh=mesh) if option else sgd)
            m.compile([tx], is_train=True, use_graph=True, amp="bfloat16")
            args = (tx, ty) if option is None else (tx, ty, option, None)
            first = m(*args)[1].item()
            s1 = stats(m)
            losses, ms = [first], []
            for _ in range(4):
                t0 = time.perf_counter()
                losses.append(m(*args)[1].item())
                ms.append((time.perf_counter() - t0) * 1e3)
            runs[option] = (m, losses, s1)
            print(f"  {option or 'no DistOpt'}: losses "
                  f"{[round(v, 4) for v in losses]}; steps 2-5 ms "
                  f"{', '.join(f'{v:.1f}' for v in ms)} (2: the capture)")
            if not all(np.isfinite(losses)):
                fail(f"16c: {option} losses {losses}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (m0, l0, s0), (mp, lp, _), (ms_, _, ss) = (runs[None], runs["plain"],
                                               runs["sparseTopK"])
    rel = max(abs(a - b) / abs(a) for a, b in zip(l0, lp))
    serr, same = _compare_states(torch, m0._raw_states(), mp._raw_states())
    first_err = max(float((s0[k].float() - ss[k].float()).abs().max())
                    for k in s0)
    print(f"  plain against no DistOpt: relative loss difference {rel:.3e}, "
          f"states {serr:.3e} (tol {GRAPH_TOL}), bitwise {same}; "
          f"sparseTopK's running statistics after its first step "
          f"{first_err:.3e} from no DistOpt's")
    if not (rel <= GRAPH_TOL and serr <= GRAPH_TOL
            and first_err <= GRAPH_TOL):
        fail("16c: the Classifier's DistOpt runs part from the plain run")
    del runs, m0, mp, ms_
    torch.cuda.empty_cache()


def phase_dp_health(torch, models, opt, health, mesh, root):
    """16d: health skip_step under DistOpt plain on 16b's graph step: an
    inf written into a block weight between replays; the agreed flag
    skips the step, every parameter, optimizer slot and the step counter
    bitwise as they were; restored, the next step is ok."""
    print("== phase 16d: skip_step under DistOpt (graph step)")
    V = BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))
    mon = health.HealthMonitor(policy="skip_step", out_dir=root)
    m = models.create_model("gpt", device="cuda", seed=SEED, **BENCH_GPT)
    m.set_optimizer(_dist_opt(opt, mesh, "plain"))
    m.compile([tx], is_train=True, use_graph=True, amp="bfloat16",
              health=mon)
    _steps(torch, m, tx, ty, 3)
    W = m.blocks[0].attn.Wq
    with torch.no_grad():
        old = W[0, 0].clone()
        W[0, 0] = float("inf")
    snap = _opt_snapshot(torch, m)
    counter = float(m.optimizer.step_counter)
    m(tx, ty)
    kept = _opt_equal(torch, m, snap)
    last = mon.recorder.ring[-1]
    print(f"  +inf in TransformerBlock_0.attn.Wq[0, 0]: action "
          f"{mon.last_action}, anomaly {last['anomaly_kinds']}, non-finite "
          f"grads {last['nonfinite_grads']}; parameters, slots and counter "
          f"bitwise kept: {kept}")
    if mon.last_action != "skip" or not kept or \
            float(m.optimizer.step_counter) != counter:
        fail("16d: the skip_step replay under DistOpt changed the state")
    with torch.no_grad():
        W[0, 0] = old
    _, loss = m(tx, ty)
    if mon.last_action != "ok" or not np.isfinite(loss.item()):
        fail(f"16d: after the restore: {mon.last_action}, {loss.item()}")
    m.set_health_monitor(None)
    del m
    torch.cuda.empty_cache()


def phase_dp_resilience(torch, models, opt, resilience, mesh, root):
    """16e: fit_resilient of 15c's fp32 GPT under DistOpt top-K 0.05 with
    sparse_residuals=True (a CUDA graph): three steps, a final save; the
    manifest's mesh {"data": 1} over one process, res.npz's 1-row
    residual stacks; a fresh model resumes at step 3 and its losses are
    within GRAPH_TOL of an uninterrupted run's."""
    print("== phase 16e: fit_resilient under DistOpt (sparse residuals)")
    cfg = PREEMPT_CFG
    batches = [tuple(t.cuda() for t in _train_batch(
        torch, cfg["vocab_size"], 2, cfg["max_seq"], SEED + 80 + i))
        for i in range(6)]

    def build():
        g = models.create_model("gpt", device="cuda", seed=SEED + 5, **cfg)
        g.set_optimizer(_dist_opt(opt, mesh, "topk",
                                  sparse_residuals=True))
        g.compile([batches[0][0]], is_train=True, use_graph=True)
        return g

    ref = _plain_losses(torch, build(), batches)
    ck = os.path.join(root, "dp_resume")
    r1 = resilience.fit_resilient(build(), batches[:3], ck,
                                  save_every_steps=3, handle_signals=False)
    path, man = resilience.latest_checkpoint(ck)
    with np.load(os.path.join(path, "res.npz")) as z:
        rows = sorted({z[k].shape[0] for k in z.files})
        n_res = len(z.files)
    r2 = resilience.fit_resilient(build(), batches, ck, save_every_steps=3,
                                  handle_signals=False)
    hist = dict(r2["history"])
    rel = max(abs(hist[k] - ref[k]) / abs(ref[k]) for k in hist)
    print(f"  first run {r1['status']} at step {r1['final_step']}; manifest "
          f"mesh {man['mesh']}; res.npz: {n_res} stacks of rows {rows}; "
          f"resumed at {r2['resumed_step']}, {r2['status']}, losses "
          f"{[round(hist[k], 6) for k in sorted(hist)]} against "
          f"uninterrupted {[round(v, 6) for v in ref[3:]]}: relative "
          f"difference {rel:.3e} (tol {GRAPH_TOL})")
    if man["mesh"].get("axes") != {"data": 1} \
            or man["mesh"].get("n_processes") != 1 or rows != [1] \
            or not n_res or r2["resumed_step"] != 3 \
            or r2["status"] != "completed" \
            or sorted(hist) != [3, 4, 5] or not rel <= GRAPH_TOL:
        fail(f"16e: first run {r1}, manifest {man['mesh']}, resumed {r2}")
    import shutil
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_dp_streams(torch, model_mod, layer, opt, tensor, device, mesh):
    """16f: the data-parallel step's per-rank random stream on the card.
    One rank folds nothing (as the JAX package's mesh of one device), so
    a model whose step folds its rank at any size (`_folds_rank`) runs
    the multi-rank path: its graph registers the rank's generator and
    each replay draws from the seed the host gave it before the replay.
    Over 4 steps (a warm-up, a capture, two replays) the dropout masks
    equal, bitwise, those of the same model stepped eagerly
    (`graph(sequential=True)`) from the same seed; they differ from step
    to step, and from a model that draws from the shared stream."""
    print("== phase 16f: per-rank random streams in a CUDA graph")
    dev = device.best_device()
    rng = np.random.RandomState(SEED + 90)
    tx = tensor.from_numpy(rng.randn(64, 256).astype(np.float32), dev)
    ty = tensor.from_numpy(rng.randint(0, 8, 64).astype(np.int32), dev)

    class Drop(model_mod.Model):
        folds = True

        def __init__(self):
            super().__init__()
            self.l1 = layer.Linear(512)
            self.drop = layer.Dropout(0.5)
            self.l2 = layer.Linear(8)
            self.sce = layer.SoftMaxCrossEntropy()

        def _folds_rank(self, comm):
            return self.folds

        def forward(self, x):
            return self.l2(self.drop(self.l1(x)))

        def train_one_batch(self, x, y):
            h = self.drop(self.l1(x))
            loss = self.sce(self.l2(h), y)
            self._optimizer(loss)
            return h, loss

    def masks(folds, sequential):
        dev.SetRandSeed(SEED)
        m = Drop()
        m.folds = folds
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1), mesh=mesh))
        m.compile([tx], is_train=True, use_graph=True)
        m.graph(True, sequential=sequential)
        out = [(m(tx, ty)[0].data != 0).cpu() for _ in range(4)]
        return out, m.graph_backend

    graph, backend = masks(True, False)
    eager, eager_backend = masks(True, True)
    shared, _ = masks(False, False)
    same = all(torch.equal(a, b) for a, b in zip(graph, eager))
    moves = all(not torch.equal(a, b) for a, b in zip(graph, graph[1:]))
    folded = all(not torch.equal(a, b) for a, b in zip(graph, shared))
    kept = float(torch.stack(graph).float().mean())
    print(f"  {backend} against {eager_backend}: masks equal {same}; "
          f"differ step to step {moves}; differ from the shared stream's "
          f"{folded}; kept {kept:.4f}")
    if backend != "cuda_graph" or not (same and moves and folded) \
            or not 0.45 < kept < 0.55:
        fail("16f: the per-rank stream does not replay in the graph")
    torch.cuda.empty_cache()


# ---- phase 17: tensor and vocab parallelism (NCCL at world size 1) --------
TP_TOL = 2e-2                # 17a: bf16 amp losses, TP against no TP
TP_MESH = {"data": 1, "tp": 1}
#: 17b's fp32 vocab-parallel GPT (phase 8's fp32 GPT, the vocab padded)
TP_VOCAB = dict(vocab_size=8000, max_seq=256, dim=512, num_heads=8,
                num_layers=2, tp_axis="tp", vocab_tp=True,
                vocab_pad_multiple=128)


def phase_tp_train(torch, models, opt, introspect, utils, mesh, A, root):
    """17a: the bench GPT (b8 x 1024, bf16 amp, graph mode) built with
    tp_axis="tp" under DistOpt(SGD) on "data" over a {data 1, tp 1} mesh
    of NCCL groups, against the same weights in the GPT with no TP and no
    DistOpt: turns of DP_STEPS replays (none, TP, none, TP); 8 + 8 K1/K2a
    exactly a TP replay; the build's op listing holds 4 dense tp
    all-reduces a layer (the forward's two `g`s, the backward's two
    `f`s) beside DistOpt's one a parameter and the loss's mean; every tp
    collective of the capture, the backward's included, is issued on the
    capturing stream (`parallel.tp._psum` wrapped over the build); losses
    within TP_TOL of the model without TP. Returns the TP replays'
    launch counts."""
    print("== phase 17a: the bench GPT with tp_axis under DistOpt "
          "(NCCL, {data 1, tp 1})")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))

    def build(tp):
        m = models.create_model(
            "gpt", device="cuda", seed=SEED,
            **dict(BENCH_GPT, tp_axis="tp" if tp else None))
        sgd = opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5)
        m.set_optimizer(opt.DistOpt(sgd, axis="data", mesh=mesh) if tp
                        else sgd)
        m.compile([tx], is_train=True, use_graph=True, amp="bfloat16")
        return m

    base, tpm = build(False), build(True)
    d = os.path.join(root, "tp_bench")
    losses = {"none": _steps(torch, base, tx, ty, 2)[0]}
    # every tp collective of the build (its warm-up and its capture), as
    # issued: capturing or not, on which stream, and from a backward node
    from singa_tpu_torch.parallel import tp as tp_mod
    psum, issued = tp_mod._psum, []

    def recorded(x, ax, op=None):
        issued.append((torch.cuda.is_current_stream_capturing(),
                       torch.cuda.current_stream().cuda_stream,
                       torch._C._current_autograd_node() is not None))
        return psum(x, ax, op)

    introspect.capture_hlo(d)
    tp_mod._psum = recorded
    try:
        losses["tp"] = _steps(torch, tpm, tx, ty, 2)[0]
    finally:
        tp_mod._psum = psum
        introspect.capture_hlo(None)
    if tpm.graph_backend != "cuda_graph" or not tpm._placements:
        fail(f"17a: the TP step ran {tpm.graph_backend!r}, sharded "
             f"{len(tpm._placements)} parameters")
    ms = {"none": [], "tp": []}
    counts = {}
    for turn in ("none", "tp", "none", "tp"):
        m = base if turn == "none" else tpm
        torch.cuda.synchronize()
        A.reset_launches()
        got, t = _steps(torch, m, tx, ty, DP_STEPS)
        if turn == "tp":
            for k, v in A.LAUNCHES.items():
                counts[k] = counts.get(k, 0) + v
        losses[turn] += got
        ms[turn] += t
    check_launches("17a TP replays", counts,
                   {"flash_fwd": 2 * L * DP_STEPS,
                    "flash_bwd_fused": 2 * L * DP_STEPS})
    text = "".join(_dp_listing(d).values())
    dense = utils.dense_allreduce_types(text)
    n_params = len(tpm._raw_params())
    scalars = sum(ln.startswith("c10d.allreduce_")
                  for ln in text.splitlines()) - len(dense)
    print(f"  build listing: {len(dense)} dense all-reduces (want "
          f"{4 * L} tp + {n_params} DistOpt), {scalars} scalar (want 1); "
          f"{len(tpm._placements)} sharded parameters")
    if len(dense) != 4 * L + n_params or scalars != 1:
        fail("17a: the TP step's build holds other collectives")
    # the capture's collectives: one stream, the capture's, for the
    # forward's gs and the backward's fs alike
    held = [r for r in issued if r[0]]
    streams = {r[1] for r in held}
    bwd = sum(r[2] for r in held)
    print(f"  tp collectives issued: {len(issued)} (want {8 * L}, warm-up "
          f"and capture); in the capture {len(held)} (want {4 * L}), "
          f"{bwd} from the backward (want {2 * L}), on {len(streams)} "
          "capturing stream(s) (want 1)")
    if len(issued) != 8 * L or len(held) != 4 * L or bwd != 2 * L \
            or len(streams) != 1:
        fail("17a: a tp collective of the captured step left the capture "
             "stream")
    rel = max(abs(a - b) / abs(a)
              for a, b in zip(losses["none"], losses["tp"]))
    print(f"  TP against no TP, {len(losses['tp'])} steps: largest "
          f"relative loss difference {rel:.3e} (tol {TP_TOL})")
    print("  replayed step median ms in turns (none, tp, none, tp): none "
          f"{statistics.median(ms['none']):.2f}, tp "
          f"{statistics.median(ms['tp']):.2f}")
    if not rel <= TP_TOL:
        fail("17a: the TP GPT's losses part from the model without TP")
    del base, tpm
    torch.cuda.empty_cache()
    return counts


def phase_tp_vocab(torch, models, opt, mesh):
    """17b: the fp32 vocab-parallel GPT (TP_VOCAB, b2 x 256, graph mode)
    on the {data 1, tp 1} mesh under DistOpt(SGD) against the same model
    off the mesh (SGD: the serial path, the table whole and the head tied),
    EXACT_STEPS steps: losses and the gathered parameters within
    GRAPH_TOL; the mesh model with vocab_tp_return_logits=False returns
    (B, S) int32 argmax predictions equal to the serial model's argmax at
    the first step."""
    print("== phase 17b: the fp32 vocab-parallel GPT on the mesh against "
          "the serial path")
    fx, fy = (t.cuda() for t in _train_batch(torch, TP_VOCAB["vocab_size"],
                                             2, 256, SEED + 4))

    def build(on_mesh, logits=True):
        m = models.create_model("gpt", device="cuda", seed=SEED + 5,
                                vocab_tp_return_logits=logits, **TP_VOCAB)
        sgd = opt.SGD(lr=0.1, momentum=0.9)
        m.set_optimizer(opt.DistOpt(sgd, axis="data", mesh=mesh)
                        if on_mesh else sgd)
        m.compile([fx], is_train=True, use_graph=True)
        return m

    runs = {}
    for on_mesh in (False, True):
        m = build(on_mesh)
        outs = [m(fx, fy) for _ in range(EXACT_STEPS)]
        runs[on_mesh] = (m, [loss.item() for _, loss in outs],
                         outs[0][0].argmax(-1))
    (m0, l0, a0), (m1, l1, _) = runs[False], runs[True]
    rel = max(abs(a - b) / abs(a) for a, b in zip(l0, l1))
    p0, p1 = m0.get_params(), m1.get_params()
    perr = max(float((p0[k].data - p1[k].data).detach().abs().max())
               for k in p0)
    table = tuple(p1["tok_embed.W"].shape)
    m = TP_VOCAB["vocab_pad_multiple"]
    padded = -(-TP_VOCAB["vocab_size"] // m) * m
    print(f"  {EXACT_STEPS} graph steps, mesh against serial: relative "
          f"loss difference {rel:.3e}, gathered parameters {perr:.3e} "
          f"(tol {GRAPH_TOL}); table {table}, sharded "
          f"{len(m1._placements)} parameters, head {m1.head}")
    if not (rel <= GRAPH_TOL and perr <= GRAPH_TOL) or m1.head is not None \
            or table != (padded, TP_VOCAB["dim"]) or not m1._placements:
        fail("17b: the vocab-parallel GPT on the mesh parts from the "
             "serial path")
    del runs, m0, m1, p0, p1
    mp = build(True, logits=False)
    preds = mp(fx, fy)[0]
    same = preds.dtype == torch.int32 and tuple(preds.shape) == (2, 256) \
        and torch.equal(preds, a0.to(torch.int32))
    print(f"  argmax predictions {tuple(preds.shape)} {preds.dtype}: equal "
          f"to the serial logits' argmax {same}")
    if not same:
        fail("17b: the vocab-parallel argmax differs from the serial one")
    del mp
    torch.cuda.empty_cache()


def phase_tp_mlp(torch, parallel):
    """17c: parallel.tp_mlp through NCCL on a {tp 1} mesh (x (1024,
    2048), H 8192, fp32) against the dense MLP: within GRAPH_TOL of
    max|ref|."""
    print("== phase 17c: tp_mlp over NCCL against the dense MLP")
    g = torch.Generator(device="cuda").manual_seed(SEED + 80)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    x, W1, b1 = r(1024, 2048), r(2048, 8192, scale=0.02), r(8192)
    W2, b2 = r(8192, 2048, scale=0.02), r(2048)
    with parallel.make_mesh({"tp": 1}).bind():
        y = parallel.tp_mlp(x, W1, b1, W2, b2, "tp")
    ref = torch.nn.functional.gelu(x @ W1 + b1, approximate="tanh") @ W2 + b2
    err = float((y - ref).abs().max() / ref.abs().max())
    print(f"  (1024, 2048) x H 8192: max |tp - dense| / max |dense| "
          f"{err:.3e} (tol {GRAPH_TOL}); bitwise {torch.equal(y, ref)}")
    if not err <= GRAPH_TOL:
        fail("17c: tp_mlp parts from the dense MLP")


# ---- phase 18: sequence and expert parallelism (NCCL at world size 1) -----
SP_TOL = 2e-2                # 18a, 18d: bf16 amp losses, sp/ep against none
SP_MESH = {"data": 1, "sp": 1}
EP_MESH = {"data": 1, "ep": 1}
#: 18b: the loopback ring's cases: (label, (B, H, S, D), ranks, causal,
#: dtype, compared with the ring on the plain versions)
RING_CASES = (
    ("causal, n 4 (S_local 4096: K2a a hop)", (1, 16, 16384, 128), 4,
     True, "bfloat16", True),
    ("causal, n 2 (S_local 16384: K2b + K2c a hop)", (1, 16, 32768, 128),
     2, True, "bfloat16", False),
    ("non-causal, n 4", (1, 16, 16384, 128), 4, False, "bfloat16", False),
    ("causal, n 4, fp32", (1, 16, 4096, 128), 4, True, "float32", False),
)
#: 18c: phase 8's fp32 GPT
SP_FP32 = dict(vocab_size=8192, max_seq=256, dim=512, num_heads=8,
               num_layers=2)
#: 18d: phase 9b's fp32 MoE-GPT
EP_FP32 = dict(vocab_size=8192, max_seq=256, dim=512, num_heads=8,
               num_layers=2, moe_experts=4, moe_k=2,
               moe_capacity_factor=1.25)


@contextlib.contextmanager
def _counting_p2p(torch):
    """The calls of torch.distributed.batch_isend_irecv (the one P2P entry
    of the ring and the pipeline, `parallel.communicator._p2p`) while the
    block runs, as a list that grows."""
    dist = torch.distributed
    orig, calls = dist.batch_isend_irecv, []

    def counted(ops):
        calls.append(len(ops))
        return orig(ops)

    dist.batch_isend_irecv = counted
    try:
        yield calls
    finally:
        dist.batch_isend_irecv = orig


def _in_turns(torch, built, tx, ty, A, steps=DP_STEPS):
    """Replayed steps of each model of `built` in turns (every model
    once, then again), `steps` a turn: (losses, ms, launches) by label,
    the launches counted from zero at each turn's start."""
    losses = {k: [] for k in built}
    ms = {k: [] for k in built}
    counts = {k: {} for k in built}
    for label in list(built) * 2:
        torch.cuda.synchronize()
        A.reset_launches()
        got, t = _steps(torch, built[label], tx, ty, steps)
        for k, v in A.LAUNCHES.items():
            counts[label][k] = counts[label].get(k, 0) + v
        losses[label] += got
        ms[label] += t
    return losses, ms, counts


def phase_sp_train(torch, models, opt, A, mesh):
    """18a: the bench GPT (b8 x 1024, bf16 amp, graph mode) built with
    seq_axis="sp" under DistOpt(SGD) on a {data 1, sp 1} mesh, against
    the same weights and DistOpt without seq_axis: turns of DP_STEPS
    replays (none, sp, none, sp); exactly 8 + 8 K1/K2a a sp replay (the
    one-hop ring is one causal K1 and one K2a a layer); no P2P call over
    the build and the replays; losses within SP_TOL, bitwise equality
    printed. Returns the sp replays' launch counts."""
    print("== phase 18a: the bench GPT with seq_axis under DistOpt "
          "(NCCL, {data 1, sp 1})")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 3))

    def build(sp):
        m = models.create_model(
            "gpt", device="cuda", seed=SEED,
            **dict(BENCH_GPT, seq_axis="sp" if sp else None))
        m.set_optimizer(opt.DistOpt(
            opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5), axis="data",
            mesh=mesh))
        m.compile([tx], is_train=True, use_graph=True, amp="bfloat16")
        return m

    built = {"none": build(False), "sp": build(True)}
    with _counting_p2p(torch) as p2p:
        first = {k: _steps(torch, m, tx, ty, 2)[0] for k, m in built.items()}
        losses, ms, counts = _in_turns(torch, built, tx, ty, A)
    counts = counts["sp"]
    if built["sp"].graph_backend != "cuda_graph":
        fail(f"18a: the sp step ran {built['sp'].graph_backend!r}")
    check_launches("18a sp replays", counts,
                   {"flash_fwd": 2 * L * DP_STEPS,
                    "flash_bwd_fused": 2 * L * DP_STEPS})
    ln, ls = first["none"] + losses["none"], first["sp"] + losses["sp"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(ln, ls))
    print(f"  P2P calls over the build and {4 * DP_STEPS} replays: "
          f"{len(p2p)} (want 0 at sp 1)")
    print(f"  sp against no sp, {len(ls)} steps: largest relative loss "
          f"difference {rel:.3e} (tol {SP_TOL}); bitwise equal {ln == ls}")
    print("  replayed step median ms in turns (none, sp, none, sp): none "
          f"{statistics.median(ms['none']):.2f}, sp "
          f"{statistics.median(ms['sp']):.2f}")
    if p2p or not rel <= SP_TOL:
        fail("18a: the sequence-parallel GPT parts from the model without "
             "seq_axis, or its one-hop ring made a P2P call")
    del built
    torch.cuda.empty_cache()
    return counts


def _ring_case(torch, A, g, shape, n, causal, dtype, with_plain):
    """One 18b case: the loopback ring's forward and backward on the
    kernels (exact launch counts) against the whole sequence's K1 and
    backward kernels (and, `with_plain`, against the ring on the plain
    versions); device ms of both. Returns the ring's launches."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(*shape, generator=g, device="cuda")
                   .to(dt) for _ in range(4))
    scale = shape[-1] ** -0.5
    from singa_tpu_torch.parallel.communicator import _Loopback
    ring = _Loopback(n)
    qs, ks, vs, dos = ([b.contiguous() for b in t.chunk(n, dim=2)]
                       for t in (q, k, v, do))

    def ring_fwd(use_kernel=None):
        return A._ring_fwd(qs, ks, vs, ring, causal, scale, use_kernel)

    def ring_bwd(outs, lses, use_kernel=None):
        return A._ring_bwd(qs, ks, vs, outs, lses, dos, ring, causal, scale,
                           use_kernel)

    torch.cuda.synchronize()
    A.reset_launches()
    outs, lses = ring_fwd()
    grads = ring_bwd(outs, lses)
    torch.cuda.synchronize()
    counts = dict(A.LAUNCHES)
    hops = n * (n + 1) // 2 if causal else n * n
    fused = shape[2] // n * shape[3] * 4 <= A._FUSED_DQ_BYTES_CAP
    want = {"flash_fwd": hops}
    want.update({"flash_bwd_fused": hops} if fused
                else {"flash_bwd_dq": hops, "flash_bwd_dkv": hops})
    check_launches(f"18b ring {tuple(shape)} n {n}", counts, want)
    o_ref, lse_ref = A._flash_fwd(q, k, v, causal, scale)
    g_ref = A._flash_bwd(q, k, v, o_ref, lse_ref, do, causal, scale)
    got = [torch.cat(outs, 2)] + [torch.cat(t, 2) for t in grads]
    errs = [_max_rel(a, b) for a, b in zip(got, [o_ref, *g_ref])]
    ftol, btol = TOL[dtype], BWD_TOL[dtype]
    bad = errs[0] > ftol or max(errs[1:]) > btol
    text = (f"out {errs[0]:.3e} (tol {ftol}), dq {errs[1]:.3e}, dk "
            f"{errs[2]:.3e}, dv {errs[3]:.3e} (tol {btol})")
    if with_plain:
        p_outs, p_lses = ring_fwd(False)
        p_grads = ring_bwd(p_outs, p_lses, False)
        perr = [_max_rel(a, torch.cat(b, 2)) for a, b in
                zip(got, [p_outs, *p_grads])]
        bad = bad or perr[0] > ftol or max(perr[1:]) > btol
        text += (f"; against the ring on the plain versions out "
                 f"{perr[0]:.3e}, dq {perr[1]:.3e}, dk {perr[2]:.3e}, dv "
                 f"{perr[3]:.3e}")
        del p_outs, p_lses, p_grads
    print(f"  ring against the whole sequence's kernels: {text}")
    ms = {"ring fwd": time_ms(torch, ring_fwd, n=5, warm=1),
          "whole K1": time_ms(torch, lambda: A._flash_fwd(
              q, k, v, causal, scale), n=5, warm=1),
          "ring bwd": time_ms(torch, lambda: ring_bwd(outs, lses), n=5,
                              warm=1),
          "whole bwd": time_ms(torch, lambda: A._flash_bwd(
              q, k, v, o_ref, lse_ref, do, causal, scale), n=5, warm=1)}
    print("  device ms: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f"; ring / whole: forward {ms['ring fwd'] / ms['whole K1']:.3f}"
          f", backward {ms['ring bwd'] / ms['whole bwd']:.3f}")
    if bad:
        fail(f"18b: the ring {tuple(shape)} n {n} parts from the whole "
             "sequence")
    return counts


def phase_ring_loopback(torch, A):
    """18b: the loopback ring (`parallel.communicator._Loopback`: every
    rank of an n-rank ring in this process, in lock step) on the kernels at
    long-context widths, RING_CASES: a causal ring runs n (n + 1) / 2
    forward and as many backward hops, a non-causal one n^2, exactly;
    the output within TOL and dq, dk, dv within BWD_TOL of the whole
    sequence's K1 and backward kernels (bf16 2e-2 and 3e-2, fp32 2e-4
    and 2e-3 of max|ref|); the first case also against the ring on the
    plain versions (use_kernel=False); device ms of the ring beside the
    whole sequence's kernels. Returns the rings' launch counts."""
    print("== phase 18b: the loopback ring on K1/K2 at long context")
    g = torch.Generator(device="cuda").manual_seed(SEED + 90)
    total = {k: 0 for k in A.LAUNCHES}
    for label, shape, n, causal, dtype, with_plain in RING_CASES:
        print(f"  {label}: {tuple(shape)} {dtype}")
        for k, v in _ring_case(torch, A, g, shape, n, causal, dtype,
                               with_plain).items():
            total[k] += v
        torch.cuda.empty_cache()
    return total


def _exact_pair(torch, models, opt, cfg, mesh, tx, ty, axis, **par):
    """Phase 8's check for a parallel config: the fp32 model `cfg` with
    `par` under DistOpt on `mesh` against the same weights with plain
    SGD (the serial path), EXACT_STEPS graph steps each: (loss relative
    difference, parameter difference, bitwise)."""
    runs = []
    for on_mesh in (False, True):
        m = models.create_model("gpt", device="cuda", seed=SEED + 5,
                                **dict(cfg, **(par if on_mesh else {})))
        sgd = opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5)
        m.set_optimizer(opt.DistOpt(sgd, axis=axis, mesh=mesh)
                        if on_mesh else sgd)
        m.compile([tx], is_train=True, use_graph=True)
        runs.append((m, [m(tx, ty)[1].item() for _ in range(EXACT_STEPS)]))
    (m0, l0), (m1, l1) = runs
    rel = max(abs(a - b) / abs(a) for a, b in zip(l0, l1))
    err, same = _compare_states(torch, m0._raw_states(), m1._raw_states())
    if m1.graph_backend != "cuda_graph":
        fail(f"the {par} model ran {m1.graph_backend!r}")
    return rel, err, same and l0 == l1


def phase_sp_fp32(torch, models, opt, mesh):
    """18c: phase 8's fp32 GPT (dim 512, 2 layers, S 256, b2) with
    seq_axis="sp" under DistOpt on the {data 1, sp 1} mesh against the
    serial path (no seq_axis, SGD), learned positions and RoPE, as
    graphs: losses and parameters within GRAPH_TOL."""
    print("== phase 18c: the fp32 sequence-parallel GPT against its "
          "serial path")
    tx, ty = (t.cuda() for t in _train_batch(torch, SP_FP32["vocab_size"],
                                             2, 256, SEED + 4))
    for pe in ("learned", "rope"):
        rel, err, same = _exact_pair(
            torch, models, opt, dict(SP_FP32, pos_encoding=pe), mesh, tx,
            ty, "data", seq_axis="sp")
        print(f"  {pe}: {EXACT_STEPS} graph steps, sp against serial: "
              f"relative loss difference {rel:.3e}, parameters {err:.3e} "
              f"(tol {GRAPH_TOL}); bitwise {same}")
        if not (rel <= GRAPH_TOL and err <= GRAPH_TOL):
            fail(f"18c: the fp32 sp GPT ({pe}) parts from its serial path")
        torch.cuda.empty_cache()


def phase_ep_train(torch, models, opt, introspect, utils, A, mesh, root):
    """18d: the MoE-GPT (MOE_GPT: GPT-2-small, 8 experts, top-2, cf 1.25;
    b8 x 1024, bf16 amp, graph mode) built with ep_axis="ep" under
    DistOpt(SGD, axis=("data", "ep")) on a {data 1, ep 1} mesh, against
    the same weights and DistOpt without ep_axis, in turns: exactly
    12 + 12 K1/K2a a replay; the build's op listing holds two all-to-alls
    a MoE layer forward and two backward; EXACT_STEPS more steps, the ep
    model set to the other's parameters before each: losses within
    SP_TOL (the free-running turns' difference printed). Then
    phase 9b's fp32 MoE-GPT at ep 1 against its serial path within
    GRAPH_TOL. Returns the ep replays' launch counts."""
    print("== phase 18d: the MoE-GPT with ep_axis under DistOpt "
          "(NCCL, {data 1, ep 1})")
    L, V = MOE_GPT["num_layers"], MOE_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 11))

    def build(ep):
        m = models.create_model(
            "gpt", device="cuda", seed=SEED,
            **dict(MOE_GPT, ep_axis="ep" if ep else None))
        m.set_optimizer(opt.DistOpt(
            opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5),
            axis=("data", "ep"), mesh=mesh))
        m.compile([tx], is_train=True, use_graph=True, amp="bfloat16")
        return m

    built = {"none": build(False), "ep": build(True)}
    d = os.path.join(root, "ep_moe")
    first = {"none": _steps(torch, built["none"], tx, ty, 2)[0]}
    introspect.capture_hlo(d)
    try:
        first["ep"] = _steps(torch, built["ep"], tx, ty, 2)[0]
    finally:
        introspect.capture_hlo(None)
    if built["ep"].graph_backend != "cuda_graph":
        fail(f"18d: the ep step ran {built['ep'].graph_backend!r}")
    losses, ms, counts = _in_turns(torch, built, tx, ty, A)
    counts = counts["ep"]
    check_launches("18d ep replays", counts,
                   {"flash_fwd": 2 * L * DP_STEPS,
                    "flash_bwd_fused": 2 * L * DP_STEPS})
    # the check's losses, step by step from one state: before each step
    # the ep model takes the other's parameters. Free-running, the two
    # part through K2a's atomic dQ order and the routes it flips (by
    # 2.8e-2 over 12 steps in one run; printed, not held)
    synced = []
    for _ in range(EXACT_STEPS):
        with torch.no_grad():
            for a, b in zip(built["none"]._raw_states().values(),
                            built["ep"]._raw_states().values()):
                b.copy_(a)
        synced.append((built["none"](tx, ty)[1].item(),
                       built["ep"](tx, ty)[1].item()))
    text = "".join(_dp_listing(d).values())
    lines = text.splitlines()
    a2a = sum(ln.startswith("c10d.alltoall") for ln in lines)
    dense = len(utils.dense_allreduce_types(text))
    scalars = sum(ln.startswith("c10d.allreduce_") for ln in lines) - dense
    print(f"  build listing: {a2a} all-to-alls (want {4 * L}: 2 a MoE "
          f"layer forward, 2 backward); all-reduces: {dense} dense "
          f"({len(built['ep']._raw_params())} parameters), {scalars} "
          "scalar")
    ln, le = first["none"] + losses["none"], first["ep"] + losses["ep"]
    free = max(abs(a - b) / abs(a) for a, b in zip(ln, le))
    rel = max(abs(a - b) / abs(a) for a, b in synced)
    print(f"  ep against no ep, {len(synced)} steps each from the other's "
          f"parameters: largest relative loss difference {rel:.3e} (tol "
          f"{SP_TOL}); bitwise equal {all(a == b for a, b in synced)}; "
          f"free-running over {len(le)} steps {free:.3e} (bitwise "
          f"{ln == le})")
    print("  replayed step median ms in turns (none, ep, none, ep): none "
          f"{statistics.median(ms['none']):.2f}, ep "
          f"{statistics.median(ms['ep']):.2f}")
    if a2a != 4 * L or not rel <= SP_TOL:
        fail("18d: the expert-parallel MoE-GPT's build or losses part from "
             "the model without ep_axis")
    del built
    torch.cuda.empty_cache()
    tx, ty = (t.cuda() for t in _train_batch(torch, EP_FP32["vocab_size"],
                                             4, 256, SEED + 13))
    rel, err, same = _exact_pair(torch, models, opt, EP_FP32, mesh, tx, ty,
                                 ("data", "ep"), ep_axis="ep")
    print(f"  fp32 MoE-GPT (dim 512, 2 layers, 4 experts), {EXACT_STEPS} "
          f"graph steps, ep 1 against serial: relative loss difference "
          f"{rel:.3e}, parameters {err:.3e} (tol {GRAPH_TOL}); bitwise "
          f"{same}")
    if not (rel <= GRAPH_TOL and err <= GRAPH_TOL):
        fail("18d: the fp32 ep MoE-GPT parts from its serial path")
    torch.cuda.empty_cache()
    return counts


# ---- phase 19: pipeline parallelism (NCCL at world size 1) ---------------
PP_MESH = {"data": 1, "pp": 1}
PP_MICRO = 4                 # 19a: n_micro
PP_TURN_STEPS = 3            # 19a: replays a model a turn (2 turns)
PP_HELD_STEPS = 2            # 19a: steps from one state, each on a new batch
#: 19a's held steps, against the serial model's: losses (relative), and
#: the parameter change (relative L2) by schedule; set from my chip call
#: 5 of PR 18's readings (losses gpipe 0, 1f1b <= 4.315e-06 over calls
#: 2-5; changes gpipe <= 1.683e-05, 1f1b <= 2.996e-03: its fp32 loss
#: island against the serial model's bf16 head)
PP_LOSS_TOL = 2e-5
PP_UPDATE_TOL = {"gpipe": 1e-4, "1f1b": 1e-2}
PP_DRIFT_STEPS = 12          # --pp-drift: free-running steps a model
#: 19b: the loopback pipeline's cases: (label, dim, heads, layers, S,
#: dtype); 4 stages, 8 microbatches of one sequence each, interleave 2
PP_LOOP_STAGES, PP_LOOP_MICRO, PP_LOOP_CHUNKS = 4, 8, 2
PP_LOOP_CASES = (
    ("bench width, bf16", BENCH_GPT["dim"], BENCH_GPT["num_heads"],
     BENCH_GPT["num_layers"], TRAIN_S, "bfloat16"),
    ("SP_FP32's widths, 5 layers (non-uniform), fp32", SP_FP32["dim"],
     SP_FP32["num_heads"], 5, SP_FP32["max_seq"], "float32"),
)


def _pp_built(torch, models, opt, mesh, tx, amp="bfloat16"):
    """The bench-width PipelinedGPT as {"serial", "gpipe", "1f1b"}, graph
    mode under `amp`: one model drawn (its stacks are ~400 M normals from
    the host's RandomState, the JAX package's draw) and copied on the
    card; SGD(0.1, momentum 0.9, weight decay 1e-5), under DistOpt on
    `mesh` at n_micro PP_MICRO for the pipelined two, plain and off the
    mesh (the serial layer loop) for "serial"."""
    base = models.create_model("gpt_pipe", device="cuda", seed=SEED,
                               **BENCH_GPT)

    def build(sched):
        m = copy.deepcopy(base)
        sgd = opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5)
        m.set_optimizer(opt.DistOpt(sgd, axis="data", mesh=mesh)
                        if sched else sgd)
        pipe = dict(pipeline_axis="pp", n_micro=PP_MICRO,
                    pipeline_schedule=sched) if sched else {}
        m.compile([tx], is_train=True, use_graph=True, amp=amp, **pipe)
        return m

    return {"serial": build(None), "gpipe": build("gpipe"),
            "1f1b": build("1f1b")}


def _opt_slots(m):
    """The optimizer state tensors of model m (DistOpt's inner SGD's)."""
    o = m._optimizer
    o = getattr(o, "opt", o)
    return [v for st in o._states.values() for v in st.values()]


def _held_steps(torch, built, V):
    """PP_HELD_STEPS steps from one common state: before each, the
    pipelined models take the serial one's parameters and every model's
    momentum is zeroed (so a step's change is -lr (g + wd p)), and the
    step runs on a batch none of them has seen (a cotangent or a
    gradient left from an earlier replay would show). Returns ({label:
    losses}, {pipelined label: the relative L2 difference of its
    parameter change from serial's, a step})."""
    losses = {k: [] for k in built}
    upd = {k: [] for k in built if k != "serial"}
    params = {k: list(m._raw_params().values()) for k, m in built.items()}
    for i in range(PP_HELD_STEPS):
        hx, hy = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                                 SEED + 190 + i))
        with torch.no_grad():
            for k in upd:
                for a, b in zip(params["serial"], params[k]):
                    b.copy_(a)
            for m in built.values():
                for v in _opt_slots(m):
                    v.zero_()
            p0 = [a.detach().clone() for a in params["serial"]]
        for k, m in built.items():
            losses[k].append(m(hx, hy)[1].item())
        with torch.no_grad():
            ref = [a - b for a, b in zip(params["serial"], p0)]
            den = sum(d.double().square().sum() for d in ref)
            for k in upd:
                num = sum(((a - b) - d).double().square().sum()
                          for a, b, d in zip(params[k], p0, ref))
                upd[k].append(float((num / den).sqrt()))
        del p0, ref
    return losses, upd


def phase_pp_train(torch, models, opt, A, mesh):
    """19a: the bench-width PipelinedGPT (`_pp_built`: BENCH_GPT's widths,
    b8 x 1024, bf16 amp, graph mode) on a {data 1, pp 1} mesh at n_micro
    PP_MICRO, on gpipe and on 1f1b, against the same weights off the
    mesh, in turns of PP_TURN_STEPS replays (serial, gpipe, 1f1b, twice):
    both pipelined steps replay as CUDA graphs, exactly L n_micro K1 and
    K2a a gpipe replay and 2 L n_micro K1 (the 1F1B remat) and L n_micro
    K2a a 1f1b replay, no P2P call over the builds and the replays (pp
    1), the replayed step's median ms in turns. Then `_held_steps`: the
    losses within PP_LOSS_TOL of the serial model's and each step's
    parameter change within PP_UPDATE_TOL (relative L2) of the serial
    model's; the free-running difference over the turns is printed
    (`--pp-drift` follows it further: under bf16 amp it grows with
    training's own instability, in fp32 it stays at fp32's rounding).
    The stacks compute in fp32, as the JAX package's functional blocks
    do; amp casts the embedding and the caller-facing head, and 1f1b's
    loss island (final LN, head, CE) runs in fp32. Returns the pipelined
    replays' launch counts."""
    print("== phase 19a: the bench PipelinedGPT under DistOpt "
          "(NCCL, {data 1, pp 1})")
    L, V = BENCH_GPT["num_layers"], BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 19))
    built = _pp_built(torch, models, opt, mesh, tx)
    with _counting_p2p(torch) as p2p:
        first = {k: _steps(torch, m, tx, ty, 2)[0] for k, m in built.items()}
        losses, ms, counts = _in_turns(torch, built, tx, ty, A,
                                       PP_TURN_STEPS)
        held, upd = _held_steps(torch, built, V)
    for k in ("gpipe", "1f1b"):
        if built[k].graph_backend != "cuda_graph":
            fail(f"19a: the {k} step ran {built[k].graph_backend!r}")
    replays = 2 * PP_TURN_STEPS
    check_launches("19a gpipe replays", counts["gpipe"],
                   {"flash_fwd": L * PP_MICRO * replays,
                    "flash_bwd_fused": L * PP_MICRO * replays})
    check_launches("19a 1f1b replays", counts["1f1b"],
                   {"flash_fwd": 2 * L * PP_MICRO * replays,
                    "flash_bwd_fused": L * PP_MICRO * replays})
    print("  K1/K2a a replay: " + ", ".join(
        f"{k} {counts[k]['flash_fwd'] // replays}/"
        f"{counts[k]['flash_bwd_fused'] // replays}" for k in built))
    print(f"  P2P calls over the builds and "
          f"{3 * (replays + PP_HELD_STEPS)} replays: {len(p2p)} (want 0 "
          "at pp 1)")
    bad = bool(p2p)

    def rel(a, b):
        return max(abs(x - y) / abs(x) for x, y in zip(a, b))

    free = {k: first[k] + losses[k] for k in built}
    for k in ("gpipe", "1f1b"):
        dl = [abs(a - b) / abs(a) for a, b in zip(held["serial"], held[k])]
        print(f"  {k} against serial, {PP_HELD_STEPS} steps each from one "
              f"state on a new batch: relative loss difference "
              f"{', '.join(f'{d:.3e}' for d in dl)} (tol {PP_LOSS_TOL}), "
              f"parameter change {', '.join(f'{u:.3e}' for u in upd[k])} "
              f"(relative L2, tol {PP_UPDATE_TOL[k]}); free-running over "
              f"{len(free[k])} steps {rel(free['serial'], free[k]):.3e}")
        bad = bad or not (max(dl) <= PP_LOSS_TOL
                          and max(upd[k]) <= PP_UPDATE_TOL[k])
    print("  replayed step median ms in turns (serial, gpipe, 1f1b, "
          "twice): " + ", ".join(f"{k} {statistics.median(v):.2f}"
                                 for k, v in ms.items()))
    if bad:
        fail("19a: a pipelined GPT parts from its serial path, or pp 1 "
             "made a P2P call")
    del built
    torch.cuda.empty_cache()
    return {k: counts["gpipe"].get(k, 0) + counts["1f1b"].get(k, 0)
            for k in A.LAUNCHES}


def _pp_stacks(torch, g, E, heads, L, lp, dt):
    """Block stacks of a (L, dim E) transformer in the PipelinedGPT's
    order, padded with zero rows to `lp` rows, leaves that require
    grad."""
    H = 4 * E
    shapes = (("g", (E,)), ("b", (E,)), ("w", (E, E)), ("w", (E, E)),
              ("w", (E, E)), ("w", (E, E)), ("g", (E,)), ("b", (E,)),
              ("w", (E, H)), ("b", (H,)), ("w", (H, E)), ("b", (E,)))
    out = []
    for kind, shape in shapes:
        r = torch.randn((L,) + shape, generator=g, device="cuda")
        v = {"g": 1 + 0.1 * r, "b": 0.1 * r,
             "w": r * shape[0] ** -0.5}[kind]
        full = torch.zeros((lp,) + shape, device="cuda")
        full[:L] = v
        out.append(full.to(dt).requires_grad_(True))
    return out


def _pp_loop_case(torch, A, transformer, pipeline, g, E, heads, L, S,
                  dtype):
    """One 19b case: gpipe, 1f1b and interleave 2 on the loopback group
    against the serial layer loop: outputs within TOL and the stacks' and
    the input's gradients within BWD_TOL of max|ref|, exact launch counts,
    peak memory above the inputs. Returns the schedules' launches."""
    n, M, V = PP_LOOP_STAGES, PP_LOOP_MICRO, PP_LOOP_CHUNKS
    dt = getattr(torch, dtype)
    per, pc = -(-L // n), -(-L // (n * V))
    lp = n * per
    assert lp == n * V * pc
    stacks = _pp_stacks(torch, g, E, heads, L, lp, dt)
    x = torch.randn((M, 1, S, E), generator=g, device="cuda").to(dt)
    x.requires_grad_(True)
    do = torch.randn(x.shape, generator=g, device="cuda").to(dt)
    w = torch.randn((E,), generator=g, device="cuda") * E ** -0.5
    tgt = torch.randn((M, 1, S), generator=g, device="cuda")

    def last_fn(lpar, y, t):
        return ((y.float() @ lpar[0]) - t).square().mean()

    ser = transformer._PipelineBlocks(heads, total_layers=L)
    y_ref = ser(x.reshape(M, S, E), *stacks).reshape(x.shape)
    loss_ref = torch.stack([last_fn((w,), y_ref[m], tgt[m])
                            for m in range(M)]).mean()
    g_loss = torch.autograd.grad(loss_ref, stacks + [x], retain_graph=True)
    g_ref = torch.autograd.grad(y_ref, stacks + [x], do)
    y_ref, loss_ref = y_ref.detach(), loss_ref.detach()
    grp = pipeline._Loopback(n)
    stage_fn = transformer._make_stage_fn(heads, grp, L)
    chunk_fn = transformer._make_chunk_fn(heads, grp, L, pc)
    by_stage = [[st[s * per:(s + 1) * per] for st in stacks]
                for s in range(n)]
    by_chunk = [[st.reshape((V, n * pc) + tuple(st.shape[1:]))[
        :, d * pc:(d + 1) * pc] for st in stacks] for d in range(n)]
    ftol, btol = TOL[dtype], BWD_TOL[dtype]
    total = {k: 0 for k in A.LAUNCHES}
    bad = False

    def run(label, fn, want):
        nonlocal bad
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        t0 = time.perf_counter()
        y, grads, loss = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(A.LAUNCHES)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        check_launches(f"19b {label}", counts, want)
        for k, v in counts.items():
            total[k] += v
        ref_g = g_loss if loss is not None else g_ref
        errs = [_max_rel(y, y_ref)] + [_max_rel(a, b) for a, b in
                                       zip(grads, ref_g)]
        text = (f"out {errs[0]:.3e} (tol {ftol}), stacks and x "
                f"{max(errs[1:]):.3e} (tol {btol})")
        if loss is not None:
            lerr = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
            text += f", loss {lerr:.3e}"
            bad = bad or not lerr <= ftol
        bad = bad or not (errs[0] <= ftol and max(errs[1:]) <= btol)
        print(f"  {label}: {text}; peak memory above the inputs "
              f"{peak:.3f} GiB; {wall:.1f} ms host clock")
        return peak

    def gpipe():
        outs = pipeline.gpipe(stage_fn, by_stage, x, grp)
        return outs[-1].detach(), torch.autograd.grad(
            outs[-1], stacks + [x], do), None

    def interleaved():
        outs = pipeline.gpipe_interleaved(chunk_fn, by_chunk, x, grp, V)
        return outs[-1].detach(), torch.autograd.grad(
            outs[-1], stacks + [x], do), None

    def one_f_one_b():
        loss, outs, ds, _, dx = pipeline.one_f_one_b(
            stage_fn, last_fn, [[s.detach() for s in p] for p in by_stage],
            (w,), x.detach(), tgt, grp)
        grads = [torch.cat([d[i] for d in ds]) for i in range(len(stacks))]
        return outs[-1], grads + [dx[0]], loss

    mem = {"gpipe": run("gpipe", gpipe, {"flash_fwd": L * M,
                                         "flash_bwd_fused": L * M})}
    mem["1f1b"] = run("1f1b", one_f_one_b, {"flash_fwd": 2 * L * M,
                                            "flash_bwd_fused": L * M})
    run(f"interleave {V}", interleaved, {"flash_fwd": L * M,
                                         "flash_bwd_fused": L * M})
    print(f"  peak activation memory, 1f1b / gpipe: "
          f"{mem['1f1b'] / mem['gpipe']:.3f}")
    if bad:
        fail("19b: a loopback schedule parts from the serial layer loop")
    return total


def phase_pp_loopback(torch, A, transformer, pipeline):
    """19b: the loopback pipeline (`parallel.communicator._Loopback`:
    every stage of a PP_LOOP_STAGES-stage pipeline in this process) on
    K1/K2a, PP_LOOP_MICRO microbatches of one sequence: gpipe, 1f1b (its
    loss mean((y w - t)^2)) and interleave PP_LOOP_CHUNKS through the
    PipelinedGPT's stage functions, against the serial layer loop on the
    same stacks (`_PipelineBlocks` off the mesh), PP_LOOP_CASES: the
    bench width in bf16 within 2e-2 and 3e-2 of max|ref| (outputs;
    gradients of the stacks and the input), SP_FP32's widths over 5
    layers (padded stages) in fp32 within 2e-4 and 2e-3; exact launch
    counts (L n_micro K1 and K2a a schedule, twice the K1 under 1f1b);
    the peak memory of gpipe against 1f1b. Returns the launches."""
    print("== phase 19b: the loopback pipeline (4 stages in this process) "
          "on K1/K2a")
    g = torch.Generator(device="cuda").manual_seed(SEED + 191)
    total = {k: 0 for k in A.LAUNCHES}
    for label, E, heads, L, S, dtype in PP_LOOP_CASES:
        print(f"  {label}: dim {E}, {heads} heads, {L} layers, S {S}")
        for k, v in _pp_loop_case(torch, A, transformer, pipeline, g, E,
                                  heads, L, S, dtype).items():
            total[k] += v
        torch.cuda.empty_cache()
    return total


# ---- phase 20: multi-replica serving (router, fleet, diag) -----------------
ROUTE_ENGINE = dict(max_slots=8, page_size=16, max_ctx=1024,
                    steps_per_sync=4, dtype="bfloat16")   # 20a, phase 4's
#: 20b's and 20c's replicas: the A/B's command-line defaults at dim 512
#: (4 heads of 128, a width K1 takes), GPT-2's vocab, fp32, and up to 64
#: new tokens (the default 24 lasts ~30 ms on the card, shorter than the
#: kill trigger's shard poll, so the SIGKILL could miss every request)
REPLICA = dict(vocab=50257, dim=512, layers=2, prompt_lo=4, prompt_hi=12,
               new_hi=64, slots=4, page_size=8, publish_interval=0.1)
AB_ROUTER = ["--replicas", "2", "--requests", "16", "--rps", "8",
             "--dim", str(REPLICA["dim"]), "--layers",
             str(REPLICA["layers"]), "--vocab", str(REPLICA["vocab"]),
             "--new-hi", str(REPLICA["new_hi"]), "--timeout", "120",
             "--device", "cuda"]
AB_FLEET = ["--workers", "3", "--mesh-devices", "1", "--device", "cuda",
            "--timeout", "180"]


def _url(url):
    """(status, body) of one GET."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _sample(text, name, **labels):
    """One sample's value from Prometheus text (0 when absent)."""
    want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    key = f"{name}{{{want}}}" if want else name
    for ln in text.splitlines():
        if ln.split(" ")[0] == key:
            return float(ln.split(" ")[1])
    return 0.0


def _compute_apps():
    """nvidia-smi's compute processes on the card (their pids as the
    host's namespace numbers them, which a container's pids need not
    match)."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.split()


def _nvidia_fds(pid):
    """The NVIDIA device files process `pid` holds open (/proc/<pid>/fd):
    a process with a CUDA context on the card holds /dev/nvidia<N>."""
    out = set()
    d = f"/proc/{pid}/fd"
    for fd in os.listdir(d):
        try:
            t = os.readlink(os.path.join(d, fd))
        except OSError:
            continue
        if t.startswith("/dev/nvidia"):
            out.add(t)
    return sorted(out)


def _engine_delta(before, after):
    """(prefills, steps, evicted) the engines ran between two report()
    lists: each admitted request prefilled once and completed."""
    return (sum(a["finished"].get("completed", 0)
                - b["finished"].get("completed", 0)
                for b, a in zip(before, after)),
            sum(a["steps"] - b["steps"] for b, a in zip(before, after)),
            sum(a["finished"].get("evicted", 0)
                - b["finished"].get("evicted", 0)
                for b, a in zip(before, after)))


def _routed_window(torch, A, r, engines, reqs_in, L, what, during=None):
    """Submit `reqs_in` through the router with every launch counter reset
    just before and read just after; `during(handles)` runs while they are
    in flight. Fails unless every request completes with its token count
    and K1/K4 match the engines' own prefills and steps exactly. Returns
    (handles, wall s, launches, what `during` returned)."""
    before = [e.report() for e in engines]
    A.reset_launches()
    t0 = time.perf_counter()
    hs = [r.submit(pr, mn) for pr, mn in reqs_in]
    extra = during(hs) if during is not None else None
    for h in hs:
        if not h.wait(600):
            fail(f"{what}: routed request {h.id} did not finish")
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    got = dict(A.LAUNCHES)
    prefills, steps, evicted = _engine_delta(
        before, [e.report() for e in engines])
    bad = [(h.id, h.outcome, h.detail, len(h.tokens), mn)
           for h, (_, mn) in zip(hs, reqs_in)
           if h.outcome != "completed" or len(h.tokens) != mn]
    if bad or evicted:
        fail(f"{what}: requests lost or evicted: {bad}, evicted {evicted}")
    if prefills != len(reqs_in):
        fail(f"{what}: {prefills} prefills for {len(reqs_in)} requests")
    check_launches(what, got, {"flash_fwd": L * prefills,
                               "paged_attention": L * steps})
    return hs, wall, got, extra


def phase_router_engines(torch, models, engine, router, diag, goodput, A):
    """20a: GPT-2-small bf16 in two ServingEngines (8 slots, page 16)
    behind two ReplicaControls and one Router, in this process. 16 seeded
    requests routed, K1/K4 exactly 12 a prefill and 12 a step of the
    engines' own counts; then 16 more with one replica drained while they
    run: nothing lost or evicted, every handed-back request completed on
    the other; /routerz?json=1 and /metrics of the diag server against
    Router.snapshot(). Routed TTFT and tokens/s beside one direct
    engine's on the same requests (printed). Returns the two windows'
    launches."""
    print("== phase 20a: a Router over two ServingEngines in this "
          "process, GPT-2-small bf16")
    model = models.create_model("gpt", device="cuda", seed=SEED,
                                **GPT2_SMALL)
    L = len(model.blocks)
    _, reqs_in = seeded_requests(model.vocab_size)
    # the direct engine (and the model's prefill builds for every
    # bucket), off the counted windows
    d_eng = engine.ServingEngine(model, **ROUTE_ENGINE).start()
    try:
        d_eng.prewarm([len(p) for p, _ in reqs_in])
        t0 = time.perf_counter()
        direct = [d_eng.submit(pr, mn) for pr, mn in reqs_in]
        for d in direct:
            if not d.wait(600) or d.outcome != "completed":
                fail(f"direct engine request {d.id}: {d.outcome}")
        d_wall = time.perf_counter() - t0
    finally:
        d_eng.stop()
    engines = [engine.ServingEngine(model, **ROUTE_ENGINE).start()
               for _ in range(2)]
    ctls = [router.ReplicaControl(e) for e in engines]
    r = router.Router(retry_seed=SEED).start()
    srv = diag.start_diag_server(port=0)
    try:
        for i, c in enumerate(ctls):
            r.add_replica(f"e{i}", c.url, host=f"e{i}")
        for e in engines:    # cuBLAS and the pools' first use, off the window
            e.prewarm([8])
        hs, wall, got, _ = _routed_window(torch, A, r, engines, reqs_in, L,
                                          "20a routed")
        ntok = sum(len(h.tokens) for h in hs)
        d_tok = sum(len(d.tokens) for d in direct)
        card = card_line()
        print(f"  routed over 2 engines: {len(hs)} requests, {ntok} tokens, "
              f"{wall:.3f} s, {ntok / wall:.1f} tok/s, TTFT p50 "
              f"{engine.pctile([h.ttft_s for h in hs], 0.5) * 1e3:.1f} ms "
              f"p99 {engine.pctile([h.ttft_s for h in hs], 0.99) * 1e3:.1f}"
              f" ms, by replica {sorted({h.replica for h in hs})} ({card})")
        print(f"  one engine direct: {len(direct)} requests, {d_tok} tokens,"
              f" {d_wall:.3f} s, {d_tok / d_wall:.1f} tok/s, TTFT p50 "
              f"{engine.pctile([d.ttft_s for d in direct], 0.5) * 1e3:.1f} "
              f"ms p99 "
              f"{engine.pctile([d.ttft_s for d in direct], 0.99) * 1e3:.1f}"
              f" ms ({card})")
        same = sum(int(h.tokens == list(d.tokens))
                   for h, d in zip(hs, direct))
        print(f"  routed vs direct tokens (bf16, other batches: printed "
              f"only): {same}/{len(hs)} sequences identical")

        def drain(hs2):
            # drain while e0's engine still queues requests it has not
            # admitted, so that some are handed back (bounded wait)
            deadline = time.monotonic() + 10.0
            while engines[0].report()["queue_depth"] < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.0005)
            return r.drain_replica("e0", timeout_s=300.0)

        hs2, wall2, got2, out = _routed_window(
            torch, A, r, engines, reqs_in, L, "20a drain", during=drain)
        handed = set(out.get("handed_back") or [])
        by_id = {h.id: h for h in hs2}
        wrong = [(i, by_id[i].replica) for i in handed
                 if by_id[i].replica != "e1"]
        state = r.get_replica("e0").state
        if not out.get("ok") or state != "dead" or wrong:
            fail(f"20a drain: {out}, e0 {state}, handed back not served "
                 f"by e1: {wrong}")
        snap = r.snapshot()
        print(f"  drain of e0 mid-traffic: {len(hs2)} requests completed in "
              f"{wall2:.3f} s, {len(handed)} handed back (all completed on "
              f"e1), evicted 0, e0 {state}; failovers {snap['failovers']}, "
              f"retries {snap['retries']} ({card_line()})")
        st, body = _url(srv.url + "/routerz?json=1")
        rj = json.loads(body)["snapshot"]
        keys = ("queue_depth", "queue_limit", "pending", "terminal",
                "reasons", "failovers", "retries")
        if st != 200 or any(rj[k] != snap[k] for k in keys) \
                or [(p["name"], p["state"], p["dispatched"],
                     p["completed"]) for p in rj["replicas"]] \
                != [(p["name"], p["state"], p["dispatched"], p["completed"])
                    for p in snap["replicas"]]:
            fail(f"/routerz?json=1 {st} disagrees with snapshot: {rj} vs "
                 f"{snap}")
        st, text = _url(srv.url + "/metrics")
        _prometheus_lines(text)
        live = sum(p["state"] == "live" for p in snap["replicas"])
        mets = {
            "completed": (_sample(text, "singa_route_requests_total",
                                  outcome="completed"),
                          snap["terminal"]["completed"]),
            "failover drain": (_sample(text, "singa_route_failover_total",
                                       reason="drain"),
                               snap["failovers"]["drain"]),
            "retries": (_sample(text, "singa_route_retries_total"),
                        snap["retries"]),
            "replicas live": (_sample(text, "singa_route_replicas_live"),
                              live)}
        print(f"  /metrics against snapshot: {mets}")
        if st != 200 or any(a != b for a, b in mets.values()):
            fail(f"/metrics disagrees with Router.snapshot(): {mets}")
    finally:
        r.stop()
        router.reset()
        for c in ctls:
            c.stop()
        for e in engines:
            e.stop()
        diag.stop_diag_server()
        goodput.uninstall()
    del model
    torch.cuda.empty_cache()
    return got, got2


def phase_replica_process(torch, router, engine, root):
    """20b: one replica process on the card (`spawn_replica`, REPLICA's
    widths, fp32): its pid holds /dev/nvidia<N> open and nvidia-smi
    counts one more compute process while it runs (nvidia-smi names the
    host's pids, not this container's) and one fewer once it is killed;
    a routed request's greedy tokens equal to those of the same seeded
    model in an
    engine of the same configuration in this process. A head width the
    kernels do not take raises, on the card, before anything runs."""
    from types import SimpleNamespace
    print("== phase 20b: a replica process on the card "
          "(dim 512, 2 layers, vocab 50257, fp32)")
    try:
        router._build_replica_model(211, 64, 2, 36, "cuda")
        fail("a replica of head width 16 built on the card")
    except ValueError as e:
        print(f"  dim 64 (head width 16) on the card raises: {e}")
    args = SimpleNamespace(**REPLICA, device="cuda")
    T = REPLICA["prompt_hi"] + REPLICA["new_hi"]
    torch.zeros(1, device="cuda")   # this process's own context first
    before = _compute_apps()
    t0 = time.perf_counter()
    proc, ready = router.spawn_replica("c0", os.path.join(root, "spool"),
                                       args, ready_timeout_s=300.0)
    r, e = None, None
    try:
        print(f"  spawn to ready {time.perf_counter() - t0:.2f} s, startup "
              f"{ready['startup']}, spawn to first token "
              f"{ready.get('spawn_to_first_token_s')} s, device "
              f"{ready.get('device')} ({card_line()})")
        apps = _compute_apps()
        nv = _nvidia_fds(ready["pid"])
        print(f"  nvidia-smi compute apps {before} before the spawn, {apps} "
              f"with the replica (pids as the host numbers them: this "
              f"process is {os.getpid()}, the replica {ready['pid']}); the "
              f"replica holds {nv} open")
        if len(apps) != len(before) + 1 or not any(
                d.startswith("/dev/nvidia") and d[11:].isdigit()
                for d in nv):
            fail(f"replica pid {ready['pid']} is not on the card: apps "
                 f"{before} -> {apps}, its device files {nv}")
        r = router.Router(retry_seed=SEED).start()
        r.add_replica("c0", f"http://127.0.0.1:{ready['ctl_port']}",
                      host="c0", proc=proc)
        prompt = np.random.RandomState(SEED + 20).randint(
            0, REPLICA["vocab"], 10).astype(np.int32)
        h = r.submit(prompt, 20)
        if not h.wait(300) or h.outcome != "completed":
            fail(f"20b routed request: {h.outcome} ({h.detail})")
        m = router._build_replica_model(REPLICA["vocab"], REPLICA["dim"],
                                        REPLICA["layers"], T, "cuda")
        e = engine.ServingEngine(
            m, max_slots=REPLICA["slots"], page_size=REPLICA["page_size"],
            max_ctx=T, queue_limit=128, steps_per_sync=2).start()
        d = e.submit(prompt, 20)
        if not d.wait(300) or d.outcome != "completed":
            fail(f"20b parent engine: {d.outcome}")
        print(f"  routed tokens {h.tokens}; this process's engine "
              f"{list(d.tokens)}")
        if h.tokens != list(d.tokens):
            fail("the replica's greedy tokens differ from the same model's "
                 "in this process")
    finally:
        if r is not None:
            r.stop()       # kills and reaps the replica
        else:
            proc.kill()
            proc.wait(timeout=30)
        router.reset()
        if e is not None:
            e.stop()
    deadline = time.monotonic() + 30.0
    while len(after := _compute_apps()) != len(before) \
            and time.monotonic() < deadline:
        time.sleep(0.2)
    print(f"  compute apps after the replica was killed: {after}")
    if len(after) != len(before):
        fail(f"the killed replica still holds the card: {after}")


def phase_router_ab(torch, router, serving, root):
    """20c: `router.main(["--ab", ...])` on the card, AB_ROUTER: every
    field of its record (zero lost, failovers, the victim dead, the
    standby serving, router rows on /fleetz, decode the fault arm's top
    bucket, every startup phase, cold spawn-to-first-token above warm
    TTFT, the attribution sums, the merged trace) but token identity,
    which holds by TIE_GAP: where the kill arm parts from the clean arm,
    the clean arm's top-2 logit gap there, teacher-forced on the same
    seeded model in this process, must be a tie."""
    print("== phase 20c: the kill-and-replace A/B on the card "
          f"({' '.join(AB_ROUTER)})")
    out = os.path.join(root, "SERVE_chip.json")
    t0 = time.perf_counter()
    rc = router.main(["--ab", *AB_ROUTER, "--out", out])
    wall = time.perf_counter() - t0
    with open(out, encoding="utf-8") as f:
        rec = [json.loads(x) for x in f if x.strip()][-1]
    n = 16
    checks = {
        "clean and kill arms completed": rec["clean_completed"]
        == rec["kill_completed"] == n,
        "zero lost": rec["lost_requests"] == 0,
        "failovers >= 1": rec["failovers"] >= 1,
        "victim dead": rec["victim_marked_dead"],
        "standby served": rec["standby_served"],
        "router rows on /fleetz": rec["fleetz_has_router_rows"],
        "decode the fault arm's top bucket":
            rec["fault_top_bucket"] == "decode",
        "every startup phase":
            set(rec["startup_phases"]) == set(router.STARTUP_PHASES),
        "cold spawn-to-first-token above warm TTFT":
            (rec["cold_warm_first_token_delta_s"] or 0.0) > 0.0,
        "attribution sums": rec["attr_sum_ok"]
        and rec["attr_checked_requests"] >= 2 * n,
        "merged trace": bool((rec["trace"] or {}).get("ok")),
        "p99 TTFT both arms": rec["ttft_p99_clean_s"] is not None
        and rec["ttft_p99_kill_s"] is not None}
    card = card_line()
    print(f"  rc {rc}, {wall:.1f} s ({card}); lost {rec['lost_requests']},"
          f" failovers {rec['failovers']}, retries {rec['retries']}, "
          f"killed at {rec['killed_at_s']:.3f} s; TTFT p99 clean "
          f"{rec['ttft_p99_clean_s'] * 1e3:.1f} ms, kill "
          f"{rec['ttft_p99_kill_s'] * 1e3:.1f} ms; cold spawn to first "
          f"token {rec['cold_spawn_first_token_s']:.3f} s (warm TTFT "
          f"{rec['cold_warm_first_token_delta_s']:.3f} s less); fault arm "
          f"top bucket {rec['fault_top_bucket']}; startup of r0 "
          f"{rec['startup_phases']}")
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"20c: {bad}; record {rec}")
    why = []
    if not rec["tokens_match_clean_arm"]:
        # the A/B's replicas: REPLICA's widths and lengths
        T = REPLICA["prompt_hi"] + REPLICA["new_hi"]
        m = router._build_replica_model(REPLICA["vocab"], REPLICA["dim"],
                                        REPLICA["layers"], T, "cuda")
        for mm in rec["token_mismatches"]:
            why.append(_same_or_tie(
                torch, m, serving, f"kill arm request {mm['id']}",
                np.asarray(mm["prompt"], np.int32), mm["kill"] or [],
                mm["clean"]))
        del m
        torch.cuda.empty_cache()
    why = [w for w in why if w]
    if rec["tokens_match_clean_arm"]:
        print("  tokens equal to the clean arm's: True")
    elif not why:
        print(f"  tokens equal to the clean arm's: False, "
              f"{len(rec['token_mismatches'])} requests parted, each at a "
              f"tie")
    if why:
        fail(f"20c: the kill arm parted from the clean arm past a tie: "
             f"{why}")
    if rc != 0 and rec["tokens_match_clean_arm"]:
        fail(f"20c: rc {rc} with every check passed")


def phase_fleet_ab(fleet, root):
    """20d: `fleet.main(["--ab", ...])` in model mode on the card
    (AB_FLEET: 3 workers, each a process training the resilience MLP, one
    with a 50 ms FaultPlan delay on its collectives): the record's `ok`
    (detected within 5 steps, every host on /fleetz, one trace track a
    worker, the gap visible on the slow track)."""
    print(f"== phase 20d: the fleet straggler A/B on the card "
          f"({' '.join(AB_FLEET)})")
    out = os.path.join(root, "FLEET_chip.json")
    t0 = time.perf_counter()
    rc = fleet.main(["--ab", *AB_FLEET, "--out", out])
    wall = time.perf_counter() - t0
    with open(out, encoding="utf-8") as f:
        rec = json.load(f)
    print(f"  rc {rc}, {wall:.1f} s ({card_line()}); mode {rec['mode']}, "
          f"detected {rec['detected']} at step "
          f"{rec['steps_at_detection']}, scores {rec['scores_at_detection']},"
          f" tracks {rec['trace_tracks']}, slow gap {rec['slow_gap_ms']} ms,"
          f" worker rcs {rec['worker_rcs']}")
    if rc != 0 or not rec["ok"] or rec["mode"] != "model":
        fail(f"20d: {rec}")


# ---- phase 21: the SLO and hang A/Bs, the capacity and audit observatories --
#: the serving A/Bs' model: REPLICA's widths (dim 512: 4 heads of 128, a
#: width K1 takes; GPT-2's vocab; fp32), each A/B's own defaults otherwise
AB_MODEL = ["--dim", str(REPLICA["dim"]), "--layers", str(REPLICA["layers"]),
            "--vocab", str(REPLICA["vocab"]), "--device", "cuda"]
AB_AUDIT = ["--timeout", "120", "--corrupt-after", "40", "--requests", "12"]


def _ab_record(path):
    """The A/B record: a JSON object, or the last line of a JSONL file."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return [json.loads(x) for x in text.splitlines() if x.strip()][-1]


def _ab_launches(torch, A, what, run):
    """Run one in-process A/B with every launch counter reset just before
    and read just after; fails unless K1 and K4 launched and no other
    kernel did. Returns (rc, wall s, launches)."""
    A.reset_launches()
    t0 = time.perf_counter()
    rc = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(A.LAUNCHES)
    ran = {k for k, v in got.items() if v}
    print(f"  launches on {what}: {got}")
    if ran != {"flash_fwd", "paged_attention"}:
        fail(f"{what} launched {got}: K1 and K4 only, each at least once")
    return rc, wall, got


def phase_slo_ab(torch, slo, A, root):
    """21a: `slo.main(["--ab", ...])` on the card at AB_MODEL's widths: the
    record's `ok` (the clean leg at 100% attainment, the degraded leg
    breached within sustain + 3 evaluations with the monitor at warn, the
    merged trace's flow linked), K1/K4 counted over the whole A/B."""
    print(f"== phase 21a: the SLO burn-rate A/B on the card "
          f"({' '.join(AB_MODEL)})")
    out = os.path.join(root, "SLO_torch.json")
    rc, wall, got = _ab_launches(
        torch, A, "21a slo A/B",
        lambda: slo.main(["--ab", *AB_MODEL, "--out", out]))
    rec = _ab_record(out)
    clean, deg = rec["clean"], rec["degraded"]
    print(f"  rc {rc}, {wall:.1f} s ({card_line()}); clean attainment "
          f"{clean['attainment']}, degraded {deg['attainment']} breached "
          f"after {deg['breach_after_evals']} evaluations (bound "
          f"{rec['max_evals']}), health {clean['health_status']} -> "
          f"{deg['health_status']}, trace {deg['trace']}")
    if rc != 0 or not rec["ok"] or rec["device"] != "cuda":
        fail(f"21a: rc {rc}, record {rec}")
    return got


def phase_hang_ab(watchdog, root):
    """21b: `watchdog.main(["--ab", ...])`: three worker processes training
    on the card, one with a wedged collective: the record's `ok` (the hang
    op `collective`, the wedged worker restarted and completed, every peer
    restarted with it, /fleetz marked the wedged host and then cleared
    it, the loss curves within the harness's 1e-4)."""
    print("== phase 21b: the hang A/B on the card (3 workers)")
    out = os.path.join(root, "HANG_torch.json")
    t0 = time.perf_counter()
    rc = watchdog.main(["--ab", "--device", "cuda", "--timeout", "240",
                        "--out", out])
    wall = time.perf_counter() - t0
    rec = _ab_record(out)
    print(f"  rc {rc}, {wall:.1f} s ({card_line()}); hang op "
          f"{rec.get('hang_op')}, detected at {rec.get('detected_wall_s')} s"
          f", aborted after {rec.get('abort_after_s')} s, wedged restarts "
          f"{rec.get('wedged_restarts')}, peer restarts "
          f"{rec.get('peer_restarts')}, steps lost {rec.get('steps_lost')}, "
          f"max loss delta {rec.get('max_abs_loss_delta')} over "
          f"{rec.get('compared_steps')} steps, worker rcs "
          f"{rec.get('worker_rcs')}")
    if rc != 0 or not rec["ok"] or rec["device"] != "cuda":
        fail(f"21b: rc {rc}, record {rec}")


def phase_capacity_ab(torch, capacity, A, root):
    """21c: `capacity.main(["--ab", ...])` on the card at AB_MODEL's widths:
    the record's `ok` (scale-up within 5 polls of sustained burn,
    scale-down on the cooldown leg, at most one direction change a leg, a
    ledger holding every decision and at least one score), K1/K4 counted
    over the whole A/B."""
    print(f"== phase 21c: the capacity shadow-autoscaler A/B on the card "
          f"({' '.join(AB_MODEL)})")
    out = os.path.join(root, "CAPACITY_torch.json")
    rc, wall, got = _ab_launches(
        torch, A, "21c capacity A/B",
        lambda: capacity.main(["--ab", *AB_MODEL, "--out", out]))
    rec = _ab_record(out)
    ledger = capacity.read_ledger(
        os.path.join(root, "CAPACITY_torch_ledger.jsonl"))
    print(f"  rc {rc}, {wall:.1f} s ({card_line()}); warm TTFT p50 "
          f"{rec.get('warm_ttft_p50_s')} s, SLO {rec.get('slo_ttft_s')} s, "
          f"sustained burn at poll {rec.get('first_sustained_burn_poll')}, "
          f"scale-up delay {rec.get('scale_up_delay_polls')} polls, "
          f"scale-down at poll {rec.get('first_scale_down_poll')}, "
          f"direction changes {rec.get('ramp_direction_changes')}/"
          f"{rec.get('cool_direction_changes')}, ledger "
          f"{rec.get('ledger_decisions')} decisions + "
          f"{rec.get('ledger_scores')} scores ({len(ledger)} lines), "
          f"accuracy {rec.get('accuracy')}")
    if rc != 0 or not rec["ok"] or rec["device"] != "cuda" \
            or len(ledger) != rec["ledger_decisions"] + rec["ledger_scores"]:
        fail(f"21c: rc {rc}, record {rec}")
    return got


def _fingerprint_checks(torch, router, audit, engine, serving):
    """21d's in-process part at REPLICA's widths: one fingerprint tick's
    time on the card (5 ticks after a warm one, fenced); the card's
    checksums equal to the same weights' on the CPU; a corruption
    through `_corrupt` changes exactly its layer group and the engine's
    served tokens; the fingerprint moves no compile counter."""
    T = REPLICA["prompt_hi"] + REPLICA["new_hi"]
    m = router._build_replica_model(REPLICA["vocab"], REPLICA["dim"],
                                    REPLICA["layers"], T, "cuda")
    eng = engine.ServingEngine(m, max_slots=REPLICA["slots"],
                               page_size=REPLICA["page_size"], max_ctx=T,
                               steps_per_sync=2).start()
    try:
        prompt = np.random.RandomState(SEED).randint(
            0, REPLICA["vocab"], 8).astype(np.int32)

        def served():
            h = eng.submit(prompt, 16)
            if not h.wait(120) or h.outcome != "completed":
                fail(f"21d: fingerprint probe {h.outcome}")
            return list(h.tokens)

        before_tokens = served()
        fp = audit.ParamFingerprinter(m, eng)
        first = fp.compute()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fp.compute()
        torch.cuda.synchronize()
        tick_ms = (time.perf_counter() - t0) / 5 * 1e3
        n = sum(p.numel() for p in m._raw_params().values())

        class _OnCpu:
            def _raw_params(self):
                return {k: v.detach().cpu()
                        for k, v in m._raw_params().items()}

        cpu = audit.ParamFingerprinter(_OnCpu()).compute()
        fp._corrupt("21d: card check")
        after = fp.compute()
        after_tokens = served()
    finally:
        eng.stop()
    group = fp.corrupted["param"].split(".", 1)[0]
    moved = [g for (g, a), (_, b) in zip(first, after) if a != b]
    print(f"  fingerprint tick {tick_ms:.3f} ms over {n} parameters "
          f"({len(first)} groups) on the card ({card_line()}); card == "
          f"CPU: {first == cpu}; corrupting {fp.corrupted['param']} moved "
          f"{moved}; served tokens changed: {before_tokens != after_tokens}")
    if first != cpu or moved != [group] or before_tokens == after_tokens:
        fail(f"21d: fingerprint on the card {first} vs CPU {cpu}, moved "
             f"{moved} for {group}, tokens {before_tokens} -> "
             f"{after_tokens}")
    del m, eng
    torch.cuda.empty_cache()
    return tick_ms


def phase_audit_ab(torch, router, audit, engine, serving, root):
    """21d: the fingerprint on the card (`_fingerprint_checks`), then
    `audit.main(["--ab", ...])` over replica processes on the card at
    AB_MODEL's widths: the record's `ok` (zero lost, zero false positives
    on the clean arm by strict token comparison, the victim quarantined
    by the fingerprint and at least one more leg within the probe budget,
    the cap not hit)."""
    print(f"== phase 21d: the audit A/B on the card "
          f"({' '.join(AB_MODEL + AB_AUDIT)})")
    tick_ms = _fingerprint_checks(torch, router, audit, engine, serving)
    out = os.path.join(root, "AUDIT_torch.json")
    t0 = time.perf_counter()
    rc = audit.main(["--ab", *AB_MODEL, *AB_AUDIT, "--out", out])
    wall = time.perf_counter() - t0
    rec = _ab_record(out)
    print(f"  rc {rc}, {wall:.1f} s ({card_line()}); lost "
          f"{rec['lost_requests']}, clean-arm false positives "
          f"{rec['false_positives_clean_arm']} ({rec['clean_canary_probes']}"
          f" canaries, {rec['clean_replays']} replays), legs "
          f"{rec['legs_detected']}, victim {rec['victim']} "
          f"{rec['victim_state']} (capped {rec['quarantine_capped']}), "
          f"probes at detection {rec['probes_at_detect']}, corrupt-arm "
          f"canaries {rec['corrupt_canary_probes']}, replays "
          f"{rec['corrupt_replays']}, mismatches {rec['corrupt_mismatches']}")
    if rc != 0 or not rec["ok"] or rec["device"] != "cuda" \
            or rec["false_positives_clean_arm"] != 0:
        fail(f"21d: rc {rc}, record {rec}")
    return tick_ms


def decode_modes(A, rows, name, by_mode):
    """The `modes` entries of a decode kernel's JSON row: per (cache mode,
    single/ladder), the phase-2 case at the main path's dtype (bf16) and
    the serving layout (the case with that mode's own label, or none),
    and its launches over the serving windows of
    phases 4 and 4c. Fails unless the int8, int4 and ladder modes each
    launched."""
    out = []
    for (kn, mode, lad) in A.LAUNCHES_BY_MODE:
        if kn != name:
            continue
        qt = 1 if lad == "single" else SPEC_K + 1
        cand = [c for c in rows if c["name"] == name
                and c["dtype"] == "bfloat16"
                and c.get("mode", "fp") == mode
                and c.get("label", f"{mode} {lad}") == f"{mode} {lad}"
                and c.get("q_tokens", 1) == qt and c.get("groups", 1) == 1]
        entry = {k: cand[-1][k] for k in (
            "shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
        entry.update(mode=mode, ladder=lad, launches=sum(
            m.get((name, mode, lad), 0) for m in by_mode.values()))
        out.append(entry)
    for need in ("int8", "int4", "ladder"):
        if not sum(e["launches"] for e in out if need in (e["mode"],
                                                          e["ladder"])):
            fail(f"{name}: no {need} launch on the main path")
    return out


class Clock:
    """Prints each phase's wall seconds as it ends."""

    def __init__(self):
        self.start = self.t = time.perf_counter()

    def lap(self, what):
        now = time.perf_counter()
        print(f"  [{what}: {now - self.t:.1f} s, {now - self.start:.1f} s "
              "in all]")
        self.t = now


# ---------------------------------------------------------------------------
def ab_turn(torch, root, tag):
    """One turn of --ab: K1 and K2a (causal), K2b and K2c (causal, at the
    long-context shape AB_LONG), then K3 and K4 (the
    AB_DECODE modes at phase 2's decode shape, and fp single at their main
    path's shape and lengths, MAIN_DECODE), of the checkout at `root` (its
    own sources, built in that checkout), bf16, as device time, as CUDA
    events around the call and as the host's median issue time."""
    sys.path.insert(0, os.path.abspath(root))
    from singa_tpu_torch.ops import _build
    from singa_tpu_torch.ops import attention as A
    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def line(what, shape, fn, n):
        print(f"{tag} {what} bf16 {list(shape)}: device "
              f"{time_ms(torch, fn, n=n):.4f} ms, events around the call "
              f"{time_ms(torch, fn, n=n, device=False):.4f} ms, host issue "
              f"{host_ms(torch, fn, n=n):.4f} ms", flush=True)
    for shape in AB_FWD:
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        line("flash_fwd", shape, lambda: A.flash_attention(q, k, v, True), 25)
    q, k, v, do = (torch.randn(AB_BWD, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = AB_BWD[-1] ** -0.5
    o, lse = A._flash_fwd(q, k, v, True, scale)
    qf, delta = A._bwd_prepare(q, k, v, o, lse, do, scale)
    line("flash_bwd_fused", AB_BWD, lambda: A._flash_bwd_fused(
        qf, k, v, do, lse, delta, True, scale), 10)
    q, k, v, do = (torch.randn(AB_LONG, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = A._flash_fwd(q, k, v, True, scale)
    qf, delta = A._bwd_prepare(q, k, v, o, lse, do, scale)
    line("flash_bwd_dq", AB_LONG, lambda: A._flash_bwd_dq(
        qf, k, v, do, lse, delta, True, scale), 5)
    line("flash_bwd_dkv", AB_LONG, lambda: A._flash_bwd_dkv(
        qf, k, v, do, lse, delta, True), 5)
    del q, k, v, do, o, lse, qf, delta
    N, Hp, T, ps, P = DEC_N, DEC_HP, DEC_T, DEC_PS, 2
    lens = torch.tensor(DEC_LENS, dtype=torch.int32, device="cuda")
    perm = torch.randperm(N * (T // ps), generator=g, device="cuda")
    pt = perm.reshape(N, T // ps).to(torch.int32).contiguous()
    for mode, qt in AB_DECODE:
        shape = [N, Hp, qt * P, P * DEC_D, T]
        q = torch.randn(shape[:4], generator=g, device="cuda").to(
            torch.bfloat16)
        Kf, Vf = (torch.randn((N, Hp, T, P * DEC_D), generator=g,
                              device="cuda") for _ in range(2))
        if mode == "fp":
            dense = [Kf.to(torch.bfloat16), Vf.to(torch.bfloat16), None, None]
        else:
            (K, ks), (V, vs) = (_quantize(torch, Kf, P, mode),
                                _quantize(torch, Vf, P, mode))
            dense = [K, V, ks, vs]
        pools = [None if a is None else _paged(torch, a, ps, perm)
                 for a in dense]
        what = f"{mode} {'ladder' if qt > 1 else 'single'}"
        line(f"flash_decode {what}", shape, lambda: A.flash_decode(
            q, dense[0], dense[1], lens, 0.125, dense[2], dense[3],
            q_tokens=qt), 25)
        line(f"paged_attention {what}", shape + [ps],
             lambda: A.paged_attention(q, pools[0], pools[1], pt, lens, ps,
                                       0.125, pools[2], pools[3],
                                       q_tokens=qt), 25)
    for kernel, (_, Tm, steps) in MAIN_DECODE.items():
        q = torch.randn((N, Hp, P, P * DEC_D), generator=g,
                        device="cuda").to(torch.bfloat16)
        K, V = (torch.randn((N, Hp, Tm, P * DEC_D), generator=g,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        shape = [N, Hp, P, P * DEC_D, Tm]
        if kernel == "paged_attention":
            perm = torch.randperm(N * (Tm // ps), generator=g, device="cuda")
            K, V = _paged(torch, K, ps, perm), _paged(torch, V, ps, perm)
            pt = perm.reshape(N, Tm // ps).to(torch.int32).contiguous()
            shape += [ps]
        for n in steps:
            lens = torch.full((N,), n, dtype=torch.int32, device="cuda")
            if kernel == "paged_attention":
                def fn():
                    return A.paged_attention(q, K, V, pt, lens, ps, 0.125)
            else:
                def fn():
                    return A.flash_decode(q, K, V, lens, 0.125)
            line(f"{kernel} {main_decode_label(kernel, 'fp', n)}", shape,
                 fn, 25)


def ab_train_turn(torch, root, tag):
    """One turn of --ab-train: the bench GPT's train step (phase 6's
    model, batch and optimizer, bf16 amp), eager and as a CUDA graph, of
    the checkout at `root`, and
    ResNet-50's (phase 7's) where that checkout has the SINGA Tensor API;
    2 warm-up steps, then the median of 7, each fenced by loss.item()."""
    sys.path.insert(0, os.path.abspath(root))
    import importlib.util
    from singa_tpu_torch import models, opt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def line(what, m, tx, ty):
        _steps(torch, m, tx, ty, 2)
        ms = _steps(torch, m, tx, ty, 7)[1]
        print(f"{tag} {what} step ms {', '.join(f'{v:.2f}' for v in ms)}; "
              f"median {statistics.median(ms):.2f}", flush=True)

    tx, ty = (t.cuda() for t in _train_batch(
        torch, BENCH_GPT["vocab_size"], TRAIN_B, TRAIN_S, SEED + 3))
    for graph in (False, True):
        m = models.create_model("gpt", device="cuda", seed=SEED,
                                **BENCH_GPT)
        m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([tx], is_train=True, use_graph=graph, amp="bfloat16")
        line(f"bench GPT b{TRAIN_B} x {TRAIN_S} "
             f"{'graph' if graph else 'eager'}", m, tx, ty)
        del m
        torch.cuda.empty_cache()
    if importlib.util.find_spec("singa_tpu_torch.tensor") is None:
        return
    from singa_tpu_torch import device, tensor
    rng = np.random.RandomState(SEED + 11)
    dev = device.best_device()
    rx = tensor.Tensor(data=rng.randn(RESNET_B, 3, RESNET_HW, RESNET_HW)
                       .astype(np.float32), device=dev)
    ry = tensor.from_numpy(rng.randint(0, RESNET_CLASSES, RESNET_B)
                           .astype(np.int32), device=dev)
    r = models.create_model("resnet50", num_channels=3,
                            num_classes=RESNET_CLASSES)
    r.set_optimizer(opt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    r.compile([rx], is_train=True, use_graph=True, amp="bfloat16")
    line(f"ResNet-50 b{RESNET_B}", r, rx, ry)


def pp_drift(torch):
    """--pp-drift: how 19a's free-running losses part. 19a's models
    (`_pp_built`) and batch, first under bf16 amp and then in fp32 (amp
    off: the serial head and 1f1b's fp32 loss island then compute
    alike), PP_DRIFT_STEPS replayed steps each from the same weights;
    prints every step's loss and its relative difference from the serial
    model's."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from singa_tpu_torch import distributed, models, opt, parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    _init_world1(distributed)
    mesh = parallel.make_mesh(PP_MESH)
    V = BENCH_GPT["vocab_size"]
    tx, ty = (t.cuda() for t in _train_batch(torch, V, TRAIN_B, TRAIN_S,
                                             SEED + 19))
    for amp in ("bfloat16", None):
        built = _pp_built(torch, models, opt, mesh, tx, amp)
        losses = {k: _steps(torch, m, tx, ty, PP_DRIFT_STEPS)[0]
                  for k, m in built.items()}
        print(f"amp {amp}: losses by step, serial: " + ", ".join(
            f"{x:.6f}" for x in losses["serial"]))
        for k in ("gpipe", "1f1b"):
            print(f"amp {amp}: {k} relative difference from serial by "
                  "step: " + ", ".join(
                      f"{abs(a - b) / abs(a):.3e}"
                      for a, b in zip(losses["serial"], losses[k])),
                  flush=True)
        del built
        torch.cuda.empty_cache()
    del mesh
    distributed.shutdown()


def run_ab(other, turn="--ab-turn"):
    """--ab (and --ab-train with turn="--ab-train-turn"): turns other,
    this, this, other, each in its own process."""
    here = os.path.dirname(os.path.abspath(__file__))
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    for root, tag in ((other, "other"), (here, "this"), (here, "this"),
                      (other, "other")):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        turn, root, tag], check=True, timeout=900)
    print(f"total {time.perf_counter() - t0:.1f} s")


def repeat_20c(torch, n):
    """--repeat-20c N: phase 1's build, then phase 20c N times, each in a
    temporary directory. The kill trigger's freezes are its calls of
    `router._freeze_holding`, its thaws those that found no request
    held. Returns 1 if any run failed, else 0."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from singa_tpu_torch import router, serving
    from singa_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_env(torch, _build)
    freeze = router._freeze_holding
    seen = {"freezes": 0, "thaws": 0}

    def counted(*a, **k):
        held = freeze(*a, **k)
        seen["freezes"] += 1
        seen["thaws"] += not held
        return held

    router._freeze_holding = counted
    failed = 0
    try:
        for k in range(n):
            seen.update(freezes=0, thaws=0)
            t0 = time.perf_counter()
            try:
                with tempfile.TemporaryDirectory() as root:
                    phase_router_ab(torch, router, serving, root)
                verdict = "ok"
            except RuntimeError as e:
                failed += 1
                verdict = f"FAILED {e}"
            print(f"[20c run {k + 1} of {n}: "
                  f"{time.perf_counter() - t0:.1f} s; freezes "
                  f"{seen['freezes']}, thaws {seen['thaws']}; {verdict}]",
                  flush=True)
    finally:
        router._freeze_holding = freeze
    print(f"20c: {failed} of {n} runs failed ({card_line()})")
    return 1 if failed else 0


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ab-turn"] and len(sys.argv) == 4:
        ab_turn(torch, sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        run_ab(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--ab-train-turn"] and len(sys.argv) == 4:
        ab_train_turn(torch, sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--ab-train"] and len(sys.argv) == 3:
        run_ab(sys.argv[2], "--ab-train-turn")
        return 0
    if sys.argv[1:] == ["--pp-drift"]:
        pp_drift(torch)
        return 0
    if sys.argv[1:2] == ["--repeat-20c"] and len(sys.argv) == 3:
        return repeat_20c(torch, int(sys.argv[2]))
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from singa_tpu_torch import (autograd, device, engine, goodput, health,
                                 introspect, layer, memory, models, observe,
                                 opt, overlap, resilience, serving, slo,
                                 snapshot, tensor, watchdog)
    from singa_tpu_torch import model as model_mod
    from singa_tpu_torch import io as sio
    from singa_tpu_torch.models import transformer
    from singa_tpu_torch.ops import _build
    from singa_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = Clock()
    phase_env(torch, _build)
    clock.lap("phase 1")
    rows = phase_kernels(torch, A)
    clock.lap("phase 2")
    t0 = time.perf_counter()
    model = models.create_model("gpt", device="cuda", seed=SEED,
                                **GPT2_SMALL)
    print(f"GPT-2-small built on {model.device} in "
          f"{time.perf_counter() - t0:.2f} s, "
          f"{sum(p.numel() for p in model.parameters())} parameters")
    drafts = {"clone": models.create_model("gpt", device="cuda", seed=SEED,
                                           **GPT2_SMALL),
              "random": models.create_model("gpt", device="cuda",
                                            seed=SEED + 9, **DRAFT_SMALL)}
    phase_teacher_forced(torch, model, serving)
    clock.lap("models and phase 3")
    phase_quant_teacher_forced(torch, model, serving, A)
    clock.lap("phase 3b")
    by_path, by_mode = phase_main_path(torch, model, engine, serving, A)
    clock.lap("phase 4")
    fp32_engine = phase_engine_fp32(torch, model, engine)
    clock.lap("phase 4b")
    spec_counts, spec_modes = phase_spec_main_path(torch, model, drafts,
                                                   engine, serving, A)
    by_path.update(spec_counts)
    by_mode.update(spec_modes)
    clock.lap("phase 4c")
    phase_spec_exact(torch, model, drafts, engine, serving, fp32_engine)
    clock.lap("phase 4d")
    train_model, (tx, ty), by_path["train"] = phase_train(torch, models,
                                                          opt, A)
    clock.lap("phase 6")
    phase_profile(torch, model, engine,
                  lambda: train_model(tx, ty)[1].item(), drafts)
    clock.lap("phase 5")
    del drafts
    del train_model
    torch.cuda.empty_cache()
    phase_train_fp32(torch, models, opt, transformer)
    clock.lap("phase 6b")
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    by_path["train_long"] = phase_train_long(torch, models, opt, A, rows, g)
    clock.lap("phase 6c")
    phase_resnet(torch, models, opt, tensor, device, layer)
    clock.lap("phase 7")
    phase_resnet_fp32(torch, models, opt, tensor, device)
    clock.lap("phase 7b")
    by_path["tensor_attention"] = phase_tensor_attention(torch, A, autograd,
                                                         tensor, device)
    clock.lap("phase 7c")
    by_path["train_graph"] = phase_graph_gpt(torch, models, opt, A)
    clock.lap("phase 8")
    phase_graph_resnet(torch, models, opt, tensor, device)
    clock.lap("phase 8b")
    with tempfile.TemporaryDirectory() as root:
        by_path["fit"] = phase_pipeline(torch, models, opt, sio, overlap,
                                        snapshot, A, root)
    clock.lap("phase 8c")
    by_path["moe_train"] = phase_moe_train(torch, models, opt, A)
    clock.lap("phase 9")
    phase_moe_fp32(torch, models, opt, transformer)
    clock.lap("phase 9b")
    by_path["moe_generate"], by_path["moe_engine"] = phase_moe_serve(
        torch, models, engine, serving, transformer, A)
    clock.lap("phase 9c")
    phase_rnn(torch, layer, model_mod, opt, autograd, tensor, device)
    clock.lap("phase 10")
    with tempfile.TemporaryDirectory() as root:
        by_path["onnx_export"] = phase_onnx(torch, model, models, opt, layer,
                                            tensor, autograd, device, A,
                                            root)
    clock.lap("phase 11")
    by_path["observe_engine"] = phase_observe_serve(torch, model, engine,
                                                    observe, A)
    clock.lap("phase 12a")
    by_path["observe_train"] = phase_observe_train(torch, models, opt,
                                                   device, observe, A)
    clock.lap("phase 12b")
    phase_observe_examples(os.path.dirname(os.path.abspath(__file__)))
    clock.lap("phase 12c")
    by_path["slo_clean"], by_path["slo_degraded"] = phase_slo_engine(
        torch, model, engine, serving, slo, health, resilience, observe, A)
    clock.lap("phase 13a")
    by_path["slo_generate"] = phase_slo_generate(torch, model, serving, slo,
                                                 health, observe, A)
    clock.lap("phase 13b")
    with tempfile.TemporaryDirectory() as root:
        by_path["health_train"] = phase_health_train(torch, models, opt,
                                                     health, observe, A,
                                                     root)
    clock.lap("phase 13c")
    with tempfile.TemporaryDirectory() as root:
        by_path.update(phase_watchdog_engine(
            torch, model, engine, serving, health, resilience, watchdog,
            observe, A, root))
    clock.lap("phase 14a")
    with tempfile.TemporaryDirectory() as root:
        by_path["wd_train"], wd_model = phase_watchdog_train(
            torch, models, opt, health, watchdog, goodput, observe, A,
            _build, root)
    clock.lap("phase 14b")
    with tempfile.TemporaryDirectory() as root:
        by_path["mem_train"], by_path["mem_engine"] = phase_memory(
            torch, models, opt, health, memory, engine, serving, slo,
            resilience, observe, A, model, wd_model, root)
    clock.lap("phase 14c")
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        by_path["goodput_fit"] = phase_goodput_fit(
            torch, models, opt, health, goodput, overlap, resilience,
            observe, A, root)
    clock.lap("phase 14d")
    with tempfile.TemporaryDirectory() as root:
        by_path.update(phase_introspect(
            torch, models, opt, device, introspect, observe, memory, health,
            watchdog, engine, serving, resilience, A, root))
    clock.lap("phase 15a")
    with tempfile.TemporaryDirectory() as root:
        by_path.update(phase_fit_resilient(torch, models, opt, resilience,
                                           watchdog, observe, A, root))
    clock.lap("phase 15b")
    with tempfile.TemporaryDirectory() as root:
        by_path["preempt_resume"] = phase_preempt_resume(
            torch, models, opt, resilience, A, root)
    clock.lap("phase 15c")
    from singa_tpu_torch import distributed, parallel, utils
    mesh = phase_dp_comm(torch, distributed, parallel)
    clock.lap("phase 16a")
    with tempfile.TemporaryDirectory() as root:
        by_path["dp_train"] = phase_dp_train(torch, models, opt, introspect,
                                             utils, mesh, A, root)
    clock.lap("phase 16b")
    phase_dp_resnet(torch, models, opt, tensor, device, mesh)
    clock.lap("phase 16c")
    with tempfile.TemporaryDirectory() as root:
        phase_dp_health(torch, models, opt, health, mesh, root)
    clock.lap("phase 16d")
    with tempfile.TemporaryDirectory() as root:
        phase_dp_resilience(torch, models, opt, resilience, mesh, root)
    clock.lap("phase 16e")
    phase_dp_streams(torch, model_mod, layer, opt, tensor, device, mesh)
    clock.lap("phase 16f")
    tp_mesh = parallel.make_mesh(TP_MESH)
    with tempfile.TemporaryDirectory() as root:
        by_path["tp_train"] = phase_tp_train(torch, models, opt, introspect,
                                             utils, tp_mesh, A, root)
    clock.lap("phase 17a")
    phase_tp_vocab(torch, models, opt, tp_mesh)
    clock.lap("phase 17b")
    phase_tp_mlp(torch, parallel)
    clock.lap("phase 17c")
    sp_mesh = parallel.make_mesh(SP_MESH)
    by_path["sp_train"] = phase_sp_train(torch, models, opt, A, sp_mesh)
    clock.lap("phase 18a")
    by_path["ring_loopback"] = phase_ring_loopback(torch, A)
    clock.lap("phase 18b")
    phase_sp_fp32(torch, models, opt, sp_mesh)
    clock.lap("phase 18c")
    with tempfile.TemporaryDirectory() as root:
        by_path["ep_train"] = phase_ep_train(
            torch, models, opt, introspect, utils, A,
            parallel.make_mesh(EP_MESH), root)
    clock.lap("phase 18d")
    from singa_tpu_torch.parallel import pipeline
    by_path["pp_train"] = phase_pp_train(torch, models, opt, A,
                                         parallel.make_mesh(PP_MESH))
    clock.lap("phase 19a")
    by_path["pp_loopback"] = phase_pp_loopback(torch, A, transformer,
                                               pipeline)
    clock.lap("phase 19b")
    del mesh, tp_mesh, sp_mesh
    distributed.shutdown()
    from singa_tpu_torch import diag, fleet, router
    by_path["router_engines"], by_path["router_drain"] = \
        phase_router_engines(torch, models, engine, router, diag, goodput, A)
    clock.lap("phase 20a")
    with tempfile.TemporaryDirectory() as root:
        phase_replica_process(torch, router, engine, root)
    clock.lap("phase 20b")
    with tempfile.TemporaryDirectory() as root:
        phase_router_ab(torch, router, serving, root)
    clock.lap("phase 20c")
    with tempfile.TemporaryDirectory() as root:
        phase_fleet_ab(fleet, root)
    clock.lap("phase 20d")
    from singa_tpu_torch import audit, capacity
    with tempfile.TemporaryDirectory() as root:
        by_path["slo_ab"] = phase_slo_ab(torch, slo, A, root)
    clock.lap("phase 21a")
    with tempfile.TemporaryDirectory() as root:
        phase_hang_ab(watchdog, root)
    clock.lap("phase 21b")
    with tempfile.TemporaryDirectory() as root:
        by_path["capacity_ab"] = phase_capacity_ab(torch, capacity, A, root)
    clock.lap("phase 21c")
    with tempfile.TemporaryDirectory() as root:
        phase_audit_ab(torch, router, audit, engine, serving, root)
    clock.lap("phase 21d")

    # the JSON line reports each kernel at its main path's shape and
    # dtype (the decode kernels: fp single at their main path's middle
    # step, by label); `launches` sums the paths' counted runs
    main_shape = {"flash_fwd": [8, 12, 128, 64],
                  "flash_bwd_fused": [TRAIN_B, 16, TRAIN_S, 128],
                  "flash_bwd_dq": [1, 16, LONG_S, 128],
                  "flash_bwd_dkv": [1, 16, LONG_S, 128]}
    main_label = {k: main_decode_label(k, "fp", steps[0])
                  for k, (_, _, steps) in MAIN_DECODE.items()}
    kernels = []
    for name in A.LAUNCHES:
        cands = [r for r in rows if r["name"] == name
                 and r["dtype"] == "bfloat16"
                 and r["shape"] == main_shape.get(name, r["shape"])
                 and r.get("label") == main_label.get(name, r.get("label"))
                 and r.get("mode", "fp") == "fp"
                 and r.get("q_tokens", 1) == 1]
        r = dict(cands[-1])
        r["launches_by_path"] = {k: v[name] for k, v in by_path.items()}
        r["launches"] = sum(r["launches_by_path"].values())
        if r["launches"] <= 0:
            fail(f"kernel {name} was not launched on the main path")
        if name in REPLACES:
            r["modes"] = decode_modes(A, rows, name, by_mode)
        kernels.append(r)
    print(f"total {time.perf_counter() - clock.start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
