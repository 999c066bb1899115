#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure makes the exit code 1):

1. the card's name and power limit (nvidia-smi), then the build of every
   kernel from the sources in the checkout (one nvcc per source, all
   started together), and the host's Python, torch and CUDA versions and
   optional modules (grpc, matplotlib, ml_dtypes, triton);
2. kernel K1 (wire quantize) against its plain PyTorch version on the
   card, tolerance 0 (torch.equal): the multi-tensor kernel
   (``wire_quantize_multi``, one launch per push of up to 64 tensors)
   over the 62 ResNet-18 parameter shapes at levels 127 and 7 with
   random, half-step and clipping inputs, each shape on its own through
   the one-tensor surface (``wire_quantize_flat``, a push of one tensor),
   over a push that mixes levels, one whose largest entry is a misaligned
   view x[1:] and one table of 124 entries (two launches). Times one
   whole push host-issued by CUDA events (before and after the plain
   version's runs), and the kernel's device time a push by
   torch.profiler, against the bound; and the wrapper's host time a
   push, step by step;
3. kernels K2, K3 and K4 (block-wise int8) against their plain versions,
   torch.equal at tolerance 0: the ResNet-18 ring chunk at N=4 as a batch
   of 4 rows of 2,805,033 values (rows 0, 4, 8 and 12 bytes past a
   16-byte boundary), 3 rows of 513, exactly 2 x 32,768, an all-zero
   block, an empty input, a 1000-valued outlier in block 0, 2 rows of
   32,769 (a last block 1 value deep), a view with an odd row stride,
   blocks that take the exact division (scales beyond 2^-40 and 2^40,
   values below scale * 2^-60), and one block of 4,096 C values for each
   cluster size C = 1..8; K3 at 3 seeds. On the chunk, K3's mean rounding
   error (in scales) must be near 0 and every code floor or floor + 1 of
   x / scale. Times each kernel on the chunk by CUDA events and by
   torch.profiler (K2 and K3 beside their first design's device times),
   and its plain version; K2's and K3's bound counts their SASS by pipe
   (cuobjdump) at the card's highest SM clock;
4. the CUDA device codec on a full-width ResNet-18 gradient tree: int8 and
   int4 with error feedback over 3 pushes, with and without shared
   scales, plus a top-k push, byte-for-byte against the NumPy
   ``compress_push``;
5. the async path: full ResNet-18 (100 classes, bf16 compute) trained by
   2 async workers through ``ParameterStore(push_codec="int8")`` for one
   epoch of synthetic CIFAR-100, eval on, host batches prefetched 2
   ahead (the worker's default). K1's launch count is reset
   just before and read just after: the multi-tensor kernel must have
   launched ceil(62 / 64) = 1 time per push made;
6. a shorter run of the async path under torch.profiler: device time by
   kernel, the multi-tensor K1's device time a push and the device's busy
   share of the wall;
7. the sync path: ``SyncTrainer`` with full ResNet-18 (bf16), 4 worker
   slots on the card, batch 128 per slot, ``compression="int8"``, one
   epoch of 16 steps, eval on 1,000 test images. K2-K4's counts are reset
   just before and read just after: K3 must have launched 4 times and K4
   7 times per step (one launch over all slots per hop), K2 never (the
   ring rounds stochastically; K2 is on no main path). Then, from the
   trained state, the ring on one step's real per-slot gradient rows
   ``[4, 11,220,132]`` on the card must equal, bit for bit, the same ring
   on a CPU copy (the plain versions), with the same seed; and one step
   each with ``compression="none"`` and with the int8 ring, whose params
   must be within rtol 0.05 / atol 1e-3 of each other;
8. a few sync steps under torch.profiler: device busy share and top
   device kernels;
9. the single-device baseline (``BaselineTrainer``, full ResNet-18 on
   ``compositional_cifar100(12_800, 2_000)``, batch 128, 100 steps an
   epoch): (a) one eager step, augment off, on the card against the
   same step on the CPU from the same weights: in float64 params, batch
   statistics and momentum within atol 1e-5 / rtol 1e-3; in fp32 the
   loss and batch statistics within it, the params' and momentum's
   differences reported beside each run's distance from float64; (b) the
   epoch loop captured in a CUDA graph against the same loop run eagerly
   on the card, fp32, augment on, cuDNN deterministic, 3 epochs of 4
   steps with milestones (1, 2): params, momentum and batch statistics
   within atol 1e-6 / rtol 1e-5 (bit equality reported), equal augment
   draws and generator states, and the graph's learning rate 0.1,
   0.010000001, 0.001 bit for bit;
   (c) the reference recipe in bf16 with augmentation, 2 epochs with the
   per-batch host loop and 2 with the captured loop: epoch seconds, img/s
   over the second epoch, loss, accuracies, peak memory, and 5 steps of
   each under torch.profiler; each must learn (test accuracy above 2 %
   after epoch 2, epoch 2's loss below epoch 1's);
10. the flash kernels against their plain versions: the wgmma forward
   ``flash_fwd_wgmma`` (K5 on bf16 inputs), the fused backward
   ``flash_bwd`` (K6 + K7 in one kernel, bf16 inputs) and the first
   versions of K5 (forward), K6 (dQ) and K7 (dK/dV), which the path runs
   on fp32 inputs. At the SP path's hop shape [192, 2048, 64] bf16 in,
   fp32 out, O, LSE, dQ, dK and dV within atol/rtol 5e-3 (2e-2 where the
   output is bf16); in fp32 within 2e-3; each case reports the mean
   magnitude its limit is compared against; T = 197 padded to 256
   (kv_len masking); causal with offsets (128, 0); two slots with their
   own offsets in one launch; D = 128; the wgmma forward and the fused
   backward on every bf16 case. A wholly-future block (0, 2048) must give
   O = 0, LSE <= -1e29 and all-zero gradients, in fp32 and in bf16 (the
   wgmma forward's too). Two launches on one input must give bit-equal O
   and LSE (wgmma forward) and dK and dV (fused backward; dQ's
   launch-to-launch difference is reported). Times each kernel, its plain
   version and the library call (``aten._scaled_dot_product_flash_
   attention`` and its backward) by CUDA events at the hop shape, each
   redesign in turns with its first version and the library's call;
11. the SP path: ``SPTrainer`` with ViT-B/16 (768 wide, 12 layers, 12
   heads, 1,000 classes, bf16) on synthetic ImageNet at 1024 x 1024
   (4,096 tokens) over 2 sequence slots of 2,048 tokens, batch 8, 2 steps
   and one eval batch. The flash counts are reset just before and read
   just after: the wgmma forward must have launched 24 x (steps + eval
   batches) times, the fused backward 24 x steps (12 layers x 2 hops, one
   launch over both slots a hop), the first versions of K5, K6 and K7
   never. Then one layer's ring on real
   activations with the kernels against the same ring with plain hops on
   the card, output and gradients (bf16) within atol 5e-3 and rtol 2^-7,
   one bf16 step;
12. one SP step under torch.profiler: device busy share, the flash
   kernels', the wgmma forward's and the fused backward's device time,
   top device kernels;
13. the CLI verb ``train`` in async mode at its default codec, in sync
   mode with the int8 ring, in baseline mode, and in sp mode on ViT-B/16
   at 1024 x 1024;
14. the gRPC path, phase 5's configuration over the wire: (a) in one
   process, the port's ``serve()`` on 127.0.0.1 at a free port and 2
   ``PSWorker`` threads on the card, each through its own ``RemoteStore``;
   K1's count reset just before and read just after: the multi-tensor
   kernel once a push; no push answered
   ``duplicate``, no frame refused as corrupt, every push frame carrying
   a valid CRC-32 trailer; the store's params moved; each worker's first
   push frame byte-equal to the port's ``encode_tensor_dict`` of the NumPy
   ``compress_push`` of the same gradients. Reports img/s, each RPC's
   median ms, bytes a push and a fetch, ``not_modified`` fetches, the
   store's staleness counts, and the device's idle share over a shorter
   profiled run; (b) across processes, ``cli serve --mode async
   --workers 2 --push-codec int8`` and 2 ``cli worker --synthetic
   --num-train 2048 --num-test 256 --epochs 1 --profile-dir`` on the
   card, the workers once the server is up: every process exits 0 within
   its timeout (one still alive then is killed, and the phase fails),
   the server reports a step above 0, and each worker's capture,
   attributed, holds one ``quantize-pack`` event and one K1 launch a
   push it made; the wall's split (spawn to 'up', each worker's spawn to
   its epoch, the epoch, the exits) is reported;
15. the gRPC path with the store options and the worker's modes on: (a)
   ``serve()`` on 127.0.0.1 over ``StoreConfig(mode="async",
   total_workers=2, push_codec="int8", staleness_bound=5,
   fetch_codec="bf16", worker_timeout=30)`` and 2 ``PSWorker`` threads,
   each through its own ``RemoteStore``, with
   ``WorkerConfig(k_step_mode="local_sgd", sync_steps=4, overlap=True,
   heartbeat_interval=1.0)`` over 4,096 images (16 steps, 4 pushes a
   worker). K1's count reset just before and read just after: one launch
   a push (8); every push frame with a valid CRC-32 trailer and none a
   duplicate; every full fetch reply within 0.45-0.55 of phase 14's; one
   fetch decoded by a fresh client equal, bit for bit, to the store's
   params cast to bf16 and back; the comms pipeline's depth sampled
   never above 1 (and above 0 at times); heartbeats on both workers; the
   params moved. Reports img/s, the RPC medians, bytes a push and a
   fetch, the overlap-saved seconds (sum and median) and the device's
   idle share over a profiled shorter run, each beside phase 14 (a)'s
   from the same run, and img/s with overlap off and on in turns (off,
   on, on, off; 8 steps a worker, eval off). (b) With
   ``cudnn.deterministic``, one worker: ``local_sgd`` with K=1 pushes an
   int8 frame byte-equal to ``faithful``'s at the same params and batch,
   and ``overlap=True``
   leaves the store's params bit-equal to ``overlap=False``'s. (c) A
   resume drill: one worker with ``reconnect_timeout=60``; the server is
   stopped just before the worker's 3rd push leaves, and a new one
   starts on the same port from ``load_snapshot`` of the old store's
   snapshot: the worker finishes with one reconnect, and each of its 4
   pushes is applied once (2 in the snapshot, 2 on the new server, the
   stranded one re-sent under its own token);
16. the device-resident store at full width: (a) phase 5's configuration
   with ``make_store("device", ...)`` on the card (async, staleness bound
   5, no codec). K1's count reset just before and read just after: 0
   launches. Reports img/s, the median grad step and the store's mean
   apply seconds (sampled every ``update_time_wait_every`` updates), each
   beside phase 5's python-store value from the same call, then img/s of
   the python and the device store again in turns with every cache warm
   (eval off); (b) a shorter run under torch.profiler: the device's idle
   share, the apply's device time against its byte bound (3 x 44,880,528
   bytes at 3.35 TB/s) and the host<->device bytes a step from the trace's
   memcpy events: host to device the batch's 393,216 bytes plus under 16
   KiB, device to host under 16 KiB, so no parameter or gradient crosses;
   (c) real gradients of one step drive two async pushes (the second one
   step stale) and one full sync round of 2 workers through the device
   store on the card and on the CPU: every return and param bit-equal;
17. checkpoints on the card: (a) ``serve()`` on 127.0.0.1 over a device
   store with a ``PeriodicStoreCheckpointer`` and one worker; after the
   server applies the worker's 2nd push its reply is lost: a snapshot
   (params and push-token journal) is flushed and the server stopped, and
   a new one on the same port is restored with ``restore_server_state``.
   The worker's retry under its old token must be answered as a duplicate
   at the restored step 2, the store's params equal to the snapshot's npz
   bit for bit, and each of the 4 pushes applied once; (b)
   ``BaselineTrainer(device_loop=True)`` (ResNet-18, bf16, deterministic
   cuDNN) for 2 epochs of 2,048 images with a checkpoint each epoch; a
   fresh trainer restored from epoch 1 (copied into the tensors its graph
   replays over) must end epoch 2 with params, momentum, BatchNorm
   statistics, step and loss bit-equal to the uninterrupted run's;
18. the cluster health layer on the main path: (a) phase 14 (a)'s run
   with the port's service wired as ``cli serve --remediate`` wires it (a
   ``ClusterMonitor`` with the JAX defaults and the SLO evaluator, a
   ``RemediationEngine`` that is not a dry run, ``reject_nonfinite``). K1's
   count reset just before and read just after: once a push; both
   workers in the monitor's view with step, loss, grad norm and push
   codec ``int8+ef``; every reported grad norm within 1e-4 (relative) of
   the pushed window's norm recomputed on the card in float64; no health
   rule fires, no directive is posted, no push is quarantined, and an SLO
   burn rule fires only where the evaluator's own fetch-latency numbers
   breach it (reported). Then img/s with the monitor off and on in turns
   (off, on, on, off; 2 steps a worker, eval off), the health note's host
   µs a boundary,
   and the device->host copies it adds a boundary (at most 1) from two
   profiled runs' memcpy events. (b) The self-heal drill: fp16 pushes,
   worker 1 poisons its 3rd step with NaN; its push is answered
   ``accepted: false, quarantined: true`` and never applied, both
   non-finite rules fire against it alone, the engine quarantines it and
   posts ``quarantine`` (steps 3) and ``refetch_params``, which it
   applies, skipping 3 pushes; worker 0's pushes all apply, worker 1's
   after the windows apply again, every parameter stays finite; the
   seconds from the NaN push's reply to the directive being applied. (c)
   One int8 worker with error feedback and deterministic cuDNN gets a
   ``quarantine`` directive (steps 2) after its 2nd push: the next 2
   windows push nothing (K1 once a push sent), the device codec's
   residuals are empty right after the directive, and the first push
   after it is byte-equal to ``compress_push`` of its gradients under a
   fresh ``ErrorFeedback`` (and differs from the carried one's);
19. every registry model under the data-parallel modes, on
   ``synthetic_imagenet(512, 256)`` at 224 x 224, 1,000 classes, bf16:
   (a) ResNet-50 (the ImageNet stem) through ``BaselineTrainer``, 2
   epochs of 4 steps of 128 eager and 2 graphed, each profiled over 2
   steps (img/s, step ms, idle share, peak GiB); one step at batch 2 on
   the card against the CPU in float64, params, batch statistics and
   momentum within atol 1e-5 / rtol 1e-3; ResNet-18 with the ImageNet
   stem for 4 eager steps. (b) ``SyncTrainer`` on ResNet-50, 4 slots of
   64, int8, 4 steps: K3 4 and K4 7 launches a step, replicas identical,
   each slot handing 6 payloads of ``ring_payload_bytes(6,389,258)`` a
   step; then K3 and K4 on one step's real gradient rows at the ring's
   first hop (4 x 6,389,258) against their plain versions on the card,
   torch.equal, timed against their bounds. (c) ``AsyncTrainer`` on
   ResNet-50 with an int8 store, 2 workers of 64, 4 pushes each: K1 3
   launches a push (161 tensors, at most 64 a launch); the first push K1
   quantized equal, byte for byte, to ``wire_quantize_multi_plain`` on
   the same inputs, and its device time against the 127,785,160-byte
   bound. (d) ViT-B/16: ``SyncTrainer`` with bf16 and with int8, 4
   slots of 32, 4 steps (K3/K4 as in (b) at 21,641,914 values a slot),
   then ``AsyncTrainer`` with int8 pushes, 2 workers of 32, 2 pushes
   each (K1 3 a push, 152 tensors); the flash kernels' counts reset
   before (d) and read after it must be 0 (197 tokens take the dense
   core). (e) phase 14 (a)'s topology with ResNet-50: ``serve()`` and 2
   ``PSWorker`` threads, int8 pushes, 2 pushes each, eval off: K1 3 a
   push, no duplicate, each RPC's median ms and the bytes of a push and a
   full fp32 fetch;
20. the perf observatory and the process surfaces: (a) ``cli train
   --mode baseline --profile-dir D`` (ResNet-18, batch 128, bf16, 4
   steps and an eval batch) and ``cli perf profile`` on D: basis
   ``device_lanes``, the classes' fractions summing to 1, conv above 0,
   the ten largest kernels with their class; then 6 eager steps and 6
   CUDA-graph replays, each timed by CUDA events without the profiler
   and then captured: each capture's attributed device time within 15 %
   of the captured replays' CUDA-event time (the replays run back to
   back, so that is the steps' device time), ``step_cost`` of one step
   and the MFU of both at 989.4 TFLOP/s, and ``cli perf diff`` between
   the two artifacts; (b) ``cli serve --push-codec int8 --telemetry
   --metrics-port 0 --incidents-dir --profile-triggers --profiles-dir
   --journal-dir`` on a thread of this process with 2 ``PSWorker``
   threads (ResNet-18, 8 pushes each, K1 once a push): ``/metrics``,
   ``/healthz`` and ``/cluster`` answer 200 mid-run, the cluster view's
   memory block carries the card's allocated bytes and name, snapshot
   lines reach stdout and the journal, and one ``slo_burn`` edge forced
   through the armed ``ProfileTrigger`` while the workers push gives one
   ``PROFILE_*.json`` attributed on the card's lanes with K1's launches
   in ``quantize-pack``; then the phase 18 NaN drill through ``cli serve
   --push-codec fp16 --remediate --incidents-dir --journal-dir --trace``
   must freeze an incident bundle with the journal window, the cluster
   view and the flight-recorder tail; and img/s with the surfaces off
   (``--no-memory-telemetry``) and on, in 2 pairs of turns (off, on, on,
   off) of 8 pushes a worker, so that each on turn spans about
   one of the monitor's 5 s ticks and memory samples, with the
   spread of the off turns beside the difference. Its journal and the
   drill's bundles are left for phase 27 (b);
21. sync data parallelism over several processes, one per card
   (``parallel/multihost.py``), full ResNet-18 (CIFAR stem, bf16), batch
   128 a slot, int8, 8 steps: (a) one rank over NCCL, 4 slots, against
   the one-process step over the same 4 slots, int8 and bf16, with
   deterministic cuDNN: every param and batch statistic bit-equal; K2-K4's
   counts reset just before the NCCL rank's int8 run and read just after:
   K3 4 and K4 7 a step; it runs while (b)'s rank processes start. (b)
   Two rank processes on the one card, 2 slots
   each, gloo with every collective copied through the host (NCCL refuses
   two ranks on one device; the ranks say so on stderr): over the two
   ranks first the ring alone on seeded rows [4, 11,220,132], whose rows
   must equal one process's 4-row ring on the card and on the CPU (the
   plain versions) bit for bit, and one int8 step, within rtol 0.05 /
   atol 1e-3 of one process's step over the 4 slots; then ``cli train
   --mode sync --multihost --dist-backend gloo`` for 2 epochs of 4 steps:
   every rank's params bit-identical at the end, the ring's rows
   identical, each slot handing 6 payloads of ``ring_payload_bytes(
   2,805,033)`` a step, K3 32 and K4 56 launches in each rank (counts
   read in each rank process around its CLI run), and the params within
   twice the drift of one process's own variants of the same run (2
   slots of 256 int8, 4 slots uncompressed) from one process's 4-slot
   run of the same command. Reports img/s summed and step ms over epoch
   2 beside one process's and phase 7's img/s. (c) The same over NCCL
   on two cards where ``torch.cuda.device_count() >= 2``; otherwise a
   line says it was not run for want of a second card. Each bf16 run
   reports ``wire_bytes_per_slot`` from the byte recorder
   (``utils/collective_bytes.py``) beside the int8 ring's: 0 over (a)'s
   one rank, the all-reduce's 2 x 11,220,132 bytes over (b)'s two ranks;
22. sequence parallelism over several processes (``SPTrainer(group=)``,
   phase 11's ViT-B/16 at 1024 x 1024, bf16, batch 8, 2 global slots):
   (a) one NCCL rank over the 2 slots against one process's phase 11
   trainer from the same weights, 2 steps and an eval batch: the
   forward's logits bit-equal, layer 0's ring (seeded q/k/v at its
   shapes) bit-equal in out, dK and dV (dQ's fp32 partial sums are added
   atomically, in an order that varies; its distance is reported beside
   one process's own run-to-run distance), the params within rtol 0.05 /
   atol 1e-3 (beside the distance between two runs of one process, which
   dQ's order makes nonzero), 72 wgmma forwards and 48 fused
   backwards (24 a step, 24 the eval batch), and the step's collectives
   counted as the shapes predict (0 bytes over one rank). (b) Two rank
   processes on the one card, one slot each, gloo staged through the
   host (they say so): layer 0's ring over the ranks bit-equal in out,
   dK and dV to one process's ring on the card, and within phase 11's
   tolerance of plain hops; one step (one epoch of one batch and an eval
   batch) whose params are bit-identical on both ranks and within rtol
   0.05 / atol 1e-3 of one process's step over the 2 slots; 1 more step
   timed (step ms and img/s beside one process's); 24 wgmma forwards and
   24 fused backwards a step in each rank; the bytes each rank's step
   moved (0.6 GB of forward hops, 3.0 GB of backward hops, the gradient
   all-reduce) equal to the shapes' count. (c) The same over NCCL on two
   cards where there are two; otherwise a line says it was not run. The
   phase reports its own seconds.
23. Switch-MoE expert parallelism (``parallel/moe.py``, ``MoETrainer``):
   (a) one MoE layer at ViT-B/16 width (4 experts, D 768, H 3,072, 6,272
   tokens = 32 x 196, capacity 784) on the card in float64 against the
   port's own CPU run of the same call: routing indices, positions,
   load and drop fraction identical, the output and the gradients of
   sum(out * cot) + aux (params and tokens) within rtol/atol 1e-9; in
   fp32 at a capacity that drops nothing against ``dense_reference``
   within 1e-4 of the reference's largest value; the layer's fp32
   forward + backward timed (CUDA events) beside its expert GEMMs'
   FLOPs and their bound at 67 TFLOP/s fp32 (TF32 is off). (b)
   ``MoETrainer`` with ViT-B/16 (1,000 classes, bf16, gap pool, 196
   tokens), 4 experts, batch 32, on ``synthetic_imagenet`` at 224 px:
   one epoch of 4 steps and one eval batch with every kernel count reset
   just before and read just after (all 0: the dense core and no codec),
   then 3 steps timed one by one (median step ms, img/s), peak GiB, 3
   profiled steps (idle share, top device kernels), and the three MoE
   metrics, finite, the drop fraction in [0, 1].
24. GPipe/1F1B pipeline parallelism (``parallel/pipeline.py``,
   ``PipelineTrainer``): (a) ``make_pipeline_train_step`` over four
   ViT-B/16 ``EncoderStage``s of 3 blocks, M = 8 microbatches of 4 x 197
   x 768, fp32, under ``gpipe`` and ``1f1b``: loss and stacked gradients
   against each other and against the four stages run in sequence on
   the whole batch, within 1e-4 of the reference's largest value; each
   schedule's step ms and peak GiB above its inputs. (b)
   ``PipelineTrainer``, 4 stages x 8 microbatches, batch 32, bf16,
   ViT-B/16 at 224 px: an epoch of 2 steps and an eval batch (kernel
   counts all 0), 2 steps timed, img/s, peak GiB, one profiled step.
25. tensor parallelism and the multi-axis mesh (``parallel/tensor.py``,
   ``TPTrainer``, dp x ep, dp x tp x pp): (a) one ViT-B/16
   ``EncoderBlock`` (D 768, 12 heads, MLP 3,072, batch 8 x 197 tokens),
   forward and backward, at tp 2, 4 and 8 (8 splits ``out``'s input
   columns inside a head) against the unsplit block with the same
   weights: float64 TP − unsplit on the card and card − CPU within 1e-12
   of the largest value, each slot's views of the parameters with the
   rule table's shard shapes (views of the parameters themselves), fp32
   within 1e-4 and bf16 within 2e-2, and each form's bf16 forward +
   backward ms. (b) ``TPTrainer`` ViT-B/16 bf16 batch 32 at data x model
   1 x 1 (the yardstick), 2 x 2, 1 x 4 and 1 x 1 again, in turns: an
   epoch of 2 steps and an eval batch (kernel counts all 0), 3 steps
   timed (median step ms, img/s, against the two 1 x 1 turns' mean), peak
   GiB, one profiled step (idle share, top
   kernels), and the TP glue's share of device time (one block's
   concatenation, slot sums and their backward copies and sums, timed
   alone at the step's shapes, times 12, over the profiled busy ms). (c)
   dp x ep: a data 2 x 4 experts layer at ViT-B/16 width (6,272 tokens)
   at a capacity that drops nothing against ``dense_reference`` within
   1e-4, load and importance summing to 1; ``MoETrainer`` dp 2 x 4
   experts batch 32 timed. dp x tp x pp: ``PipelineTrainer`` 2 x 2 x 4
   stages x 8 microbatches, one fp32 step's loss and gradients against
   plain pp (1 x 1 x 4) on the card within 1e-4; then bf16, 2 steps
   timed and one profiled.
26. the sharded parameter-server tier and the C++ arena (``ps/sharding.py``,
   ``comms/sharded.py``, ``native/``): (a) ResNet-18's 62 tensors split
   over 2 shard primaries by ``partition_keys`` beside one unsharded
   primary, all in this process on 127.0.0.1; 4 real gradient sets from
   the card pushed by 2 workers through ``ShardedRemoteStore`` and
   through ``RemoteStore`` (async with one push 2 steps stale, and one
   sync round): codec none over ``DeviceParameterStore``s on the card,
   then int8 over host stores, each worker's push encoded once by its
   ``DeviceCodec`` (K1, counted: one launch a push). After every push the
   union of the shards is bit-equal to the unsharded store; each shard's
   tensors and bytes and push/fetch ms. (b) 2 ``cli serve --shard-count
   2`` primaries (int8) and 2 ``cli worker --shards`` processes under
   ``--profile-dir``: each shard's global step, img/s, the workers' idle
   share and K1 events off their captures, beside phase 14 (b)'s
   unsharded pair; the primaries run ``--telemetry --metrics-port`` for
   phase 27 (a), whose probe runs while they serve. (c), before (b): the
   arena built from ``native/ps_core.cpp`` into ``build/torch_native/``;
   ``cli serve --store-backend native`` with one ``cli worker`` for 4
   steps, on a thread from the phase's start beside (a) and the
   sequences; async (fp16, int8, a stale push and a refused one) and
   sync sequences on real gradients against the NumPy store (bit-equal;
   async int8 bit-equal to the arena's own order and within rtol 1e-6 of
   the NumPy store's); the tracked files under ``native/`` unchanged.
27. the fleet observatory, incident forensics and the experiment matrix,
   host Python over the paths above (no kernel of their own): (a) while
   phase 26 (b)'s 2 primaries serve, a ``FleetCollector`` with
   ``start_fleet_server`` ticks over their metrics ports every 0.1 s and
   ``cli observe --journal-dir`` runs on a thread of this process: both
   shards found through their ``sharding`` blocks, the merged
   fetch-latency histogram's count equal to the primaries' own
   ``/metrics`` counts read just before and just after one scrape, the
   fleet SLO evaluated, ``status --via-fleet`` (exit 0), ``top --url
   --json`` (one frame, 2 primaries) and ``goodput --url`` answering,
   each primary's step seen at 16, then ``top --replay`` over observe's
   journal; (b) ``incident list``, ``show`` and ``report`` of every
   bundle phase 20 (b)'s NaN drill froze (each trigger's alert
   re-derived from the journal, in order), and ``query --percentiles
   --slo --goodput`` over its first session's journal, the percentiles
   equal to the last snapshot its registry printed; (c) ``cli
   experiments --modes sync,async --worker-counts 2 --epochs 1
   --synthetic --num-train 512 --no-plots`` in this process on the card:
   each record with exactly ``analysis.RECORD_KEYS``, its ``device``
   naming the card, the server's steps the workers' pushes. Every verb
   runs through the port's ``cli.main``;
28. the serve tier, host code over the paths above (no kernel of its
   own): (a) on phase 26 (b)'s topology, primary 1 runs ``--autoscale
   --autoscale-min 1 --autoscale-max 2`` (its pool spawns ``cli replica``
   children) and, from the 'up' lines on, ``cli replica --primary P0
   --canary`` (R1) and ``--parent R1`` (R2) serve; after 27 (a) read the
   primaries' counts, ``--primary P0 --staleness-bound 1
   --reparent-after 1000000`` (R3). A push
   to R1 is redirected to P0; P0's ``/cluster`` lists R1 at tier 1 and
   R2 at tier 2 under R1; ``cli loadgen`` (in this process) runs full
   and delta against R1 and R2, full against P0 and, held at its final
   step by a registration of this process, delta against P1, each with
   no error; while the workers train, ``cli infer`` rounds of
   quality 0.9 make R1 promote a candidate, and after the last step
   rounds of quality 0.1 roll that step back, never served as the
   canary again; at each primary's final step every replica (the
   pool's too) serves the primary's payload bytes; primary 1's
   autoscaler grew to its floor, then under loadgen's QPS, and its
   children are gone with it; R3 refuses fetches within 2.5 s of its
   primary's exit. (b) one
   ResNet-18 worker on the card pushing int8 (K1, one launch a push)
   through a ``RemoteStore`` whose 3rd fetch fails to a service that
   drops the replies of pushes 2 and 5: each push applied once, the
   store bit-equal to a NumPy store replaying the recorded pushes, each
   injector's counters equal to its ``schedule_preview``;
29. live resharding and the worker supervisor: (a) two shard-primary
   ``ParameterService``s on 127.0.0.1 over ResNet-18's halves, once with
   ``DeviceParameterStore``s on the card (fp32 pushes: that store takes
   no wire codec) and once with NumPy stores taking int8 (K1 once a
   push), each beside a one-store control of the same backend: 2 pushes
   through a ``ShardedRemoteStore``, ``cli.main(["reshard", ...])`` in
   this process moving shard 0's range facing shard 1 (≥ 25 % of its
   bytes, ≥ 8 tensors), 2 more pushes; after every push the union of the
   primaries is bit-equal to the control; the moved tensors live only on
   the recipient, both map versions moved by one, exported = adopted =
   dropped, and the last pre-move push re-sent to the new owner is a
   duplicate there. (b) on (a)'s NumPy primaries, ``cli reshard``
   processes: each crash point (``--crash-after``: exit 21) then
   ``--resume`` (rolled forward, from ``export`` or ``apply_ranges``),
   the lease drill (``--lease-ttl 1.5``: the donor unfreezes by itself,
   ``dps_reshard_lease_expired_total`` 1, a push applies on it,
   ``--resume`` rolls the recipient back, the map unchanged), ``--abort``
   after export (0) and after the donor's publish (4, then ``--resume``),
   one int8 push and the union check after each. (c) from the phase's
   start, on a thread: ``cli supervise --workers 2 --slot-faults
   "0:seed=7;push.kill@n=2"`` with ``cli worker`` children on the card
   against an async int8 elastic service of this process: slot 0's child
   killed at its 2nd push and respawned, both slots done, no push token
   applied twice, the children (not the supervisor) holding the CUDA
   library, the seconds from the death to the replacement's first push;
30. multi-job tenancy: (a) a ``ParameterService`` with a ``JobManager``
   of two async jobs beside ``default`` on 127.0.0.1 and one
   ``RemoteStore(job=...)`` a job, both with the same push nonce: 2
   int8 pushes a job of real ResNet-18 gradients (batch 128), each
   encoded by the job's ``DeviceCodec`` (K1, one launch a push); each
   job's store bit-equal to a solo store fed the same frames, each fetch
   the job's own params, ``default`` untouched, each job's journal only
   its own token; push/fetch ms by job. (b) from the phase's start, on a
   thread: ``cli serve --jobs 'joba:mode=sync,total_workers=1;jobb:
   weight=3,mode=async,staleness_bound=4' --push-codec int8
   --checkpoint-dir D`` and two ``cli worker --job`` processes on the
   card (4 steps each), ``cli loadgen --job joba,jobb --fetch-mode
   delta`` (each job's QPS and p50/p99), ``SubmitJob`` and a drain of a
   third job; SIGTERM (exit 143), each job's lineage at its worker's
   steps with only its own token, a cross-job restore refused, then
   ``serve ... --restore``: each job's step and params served again
   (seconds to restore);
31. MoE experts and pipeline stages over several processes
   (``MoETrainer(group=)``, ``PipelineTrainer(group=)``; ViT-B/16 at 224
   px, batch 32, 4 experts, 4 stages x 8 microbatches, no augmentation):
   (b) two gloo rank processes sharing the card (``mp_rank``, collectives
   staged through the host), 2 experts and 2 stages a rank, start first;
   (a) runs in this process meanwhile: one fp32 step of each trainer on
   one process, then through a one-rank NCCL group, cuDNN
   deterministic, bit-equal, with the predicted byte counts. (b): one
   fp32 step of each, and one 1F1B step (``make_pipeline_train_step``) on
   the pipeline's fresh stages and seeded activations, held to (a)'s
   one-process steps within 1e-4 of the largest value; the ranks' shared
   leaves (all but the experts' rows; the prologue and epilogue)
   bit-identical; then each trainer in bf16: its epoch (kernel counts all
   0: 196 / 197 tokens take the dense core), 1 step timed (median step
   ms, img/s), one profiled step a rank (idle share), the ranks' losses
   and MoE metrics equal, and the step's collective bytes a rank equal to
   ``collective_bytes.moe_step_bytes`` / ``pipeline_step_bytes``. (c) the
   same as (b) with NCCL between two cards, where there are two.
   Each phase reports its own seconds, and the script its total.

Last, no process that the run started may outlive it: every one carries
``CHIP_SMOKE_RUN`` in its environment, and any still alive 15 s after the
last phase is listed, killed, and fails the run.

Then one JSON line of kernels and, last, the device line. Without a CUDA
device, or outside a checkout of the repo, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

H100_BYTES_PER_S = 3.35e12    # HBM3, NVIDIA's H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12   # fp32 outside the tensor cores, same sheet
# Results a clock an SM of compute capability 9.0, by the pipe that runs
# each SASS opcode (CUDA C++ Programming Guide, throughput table of the
# arithmetic instructions): fp32 add, multiply, FMA, min/max and compare
# 128; 32-bit integer add, multiply-add, logic, shift, compare and select
# 64; conversions and the special-function unit 16. Moves, loads,
# stores, barriers and branches are left out, so the bound stays a least
# time.
SASS_PIPES = {
    "fp32": (128, ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL",
                   "FSET")),
    "int32": (64, ("IADD3", "IADD", "IMAD", "IMUL", "LOP3", "LOP", "SHF",
                   "SHL", "SHR", "ISETP", "IMNMX", "VIMNMX", "LEA", "IABS",
                   "PRMT", "SEL", "I2FP", "BMSK", "SGXT")),
    "conversion": (16, ("MUFU", "F2I", "I2F", "FRND", "F2F")),
}
H100_BF16_OPS_PER_S = 989e12  # dense tensor-core bf16, same sheet


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


#: Set by main() to a value of this run's own and inherited by every
#: process the run starts (children and their children alike).
RUN_MARK = "CHIP_SMOKE_RUN"
STRAY_GRACE_S = 15.0


def _marked_processes(mark: str) -> dict:
    """pid -> command line of each live process other than this one
    whose environment holds ``RUN_MARK=mark`` (zombies left out)."""
    want, found = f"{RUN_MARK}={mark}".encode(), {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit() or int(d.name) == os.getpid():
            continue
        try:
            if want not in (d / "environ").read_bytes().split(b"\0"):
                continue
            if (d / "stat").read_text().rsplit(")", 1)[1].split()[0] \
                    in ("Z", "X"):
                continue
            found[int(d.name)] = (d / "cmdline").read_bytes().replace(
                b"\0", b" ").decode(errors="replace")[:300]
        except (OSError, IndexError):
            continue
    return found


def stop_strays(mark: str) -> dict:
    """Waits up to ``STRAY_GRACE_S`` for the run's processes to end,
    then kills and returns those still alive."""
    deadline = time.perf_counter() + STRAY_GRACE_S
    strays = _marked_processes(mark)
    while strays and time.perf_counter() < deadline:
        time.sleep(0.25)
        strays = _marked_processes(mark)
    for pid in strays:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    return strays


def resnet18_shapes(num_classes: int = 100) -> dict:
    """Flax-layout shapes of ResNet-18's 62 parameter tensors."""
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import ResNet18
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    params, _ = params_to_jax(ResNet18(num_classes))
    return {k: v.shape for k, v in params.items()}


def cuda_time_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after two warm-up runs."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build(state: dict) -> None:
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    state["card"] = card
    names = ["wire_quantize", "block_quantize", "flash_attention"]
    cached = {n: _build.library_path(n).exists() for n in names}
    t0 = time.perf_counter()
    # One nvcc per source, all started together.
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))
    seconds = round(time.perf_counter() - t0, 3)
    for n in names:
        _build.load(n)
    emit({"phase": "build", "kernels": names, "seconds": seconds,
          "cached": cached})
    emit({"phase": "environment", **host_environment()})


def host_environment() -> dict:
    """Versions of Python, torch and CUDA, and of the optional modules
    later slices need on this host (None where one is missing)."""
    import importlib
    import importlib.util
    import platform

    import torch

    def version(name):
        if importlib.util.find_spec(name) is None:
            return None
        return getattr(importlib.import_module(name), "__version__", "")

    return {"python": platform.python_version(), "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "modules": {m: version(m) for m in
                        ("grpc", "matplotlib", "ml_dtypes", "triton")}}


def device_ms_per_call(fn, reps: int, kernel: str,
                       launches_per_call: int = 1) -> tuple:
    """Device time of ``fn``'s ``launches_per_call`` launches of the
    kernels whose name holds ``kernel``, from torch.profiler's kernel
    durations over ``reps`` calls after one warm-up call, and the
    launches the trace recorded a call. The time is the mean of the
    recorded launches, never their sum over ``reps``: a trace may drop
    kernel records, and a sum would then read low by the share dropped.
    A trace that recorded none gives no time (None), never 0."""
    import torch

    fn()
    torch.cuda.synchronize()
    with captured() as cap:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in cap["events"] if kernel in e.key]
    recorded = sum(e.count for e in events)
    ms = (sum(e.self_device_time_total for e in events) / 1e3 / recorded
          * launches_per_call if recorded else None)
    return ms, recorded / reps


def k1_push(gen, shapes: dict, levels: list) -> tuple[list, list]:
    """One push of gradient-like tensors of ``shapes`` at ``levels`` (one
    per tensor), each with an eighth of its values at exact
    half-steps (round-half-to-even decides them) and an eighth far beyond
    +-levels*scale (the clamp); and each tensor's fp32 scale."""
    import torch

    xs, scales = [], []
    for shape, lv in zip(shapes.values(), levels):
        x = torch.randn(shape, generator=gen, device="cuda") * 1e-2
        flat = x.view(-1)
        scale = float(np.float32(float(flat.abs().max()) / lv))
        k = max(1, flat.numel() // 8)
        codes = torch.randint(-lv - 2, lv + 2, (k,), generator=gen,
                              device="cuda")
        flat[:k] = (codes.float() + 0.5) * scale
        flat[-k:] = torch.sign(flat[-k:]) * 3 * lv * scale
        xs.append(x)
        scales.append(scale)
    return xs, scales


def k1_host_breakdown(xs, scales, levels, rounds: int = 7,
                      reps: int = 50) -> dict:
    """Host microseconds per push of each step of ``wire_quantize_multi``'s
    CUDA route, and of the whole call, by ``time.perf_counter``: every
    round times ``reps`` calls of each step in turn; the median round of
    each. ``views_by_split`` is the views' first way (a split of the buffer
    with a piece per padding gap, then a ``view`` an entry), timed beside
    the ``as_strided`` way the wrapper takes."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    ns = [x.numel() for x in xs]
    offsets, total, groups = Q.wire_multi_layout(ns)
    offsets_list = offsets.tolist()
    flat = torch.empty(total, dtype=torch.int8, device=xs[0].device)
    table = Q._wire_table(xs, ns, offsets, scales, levels)

    def views_by_split():
        sizes, keep = [], []
        gaps = (np.diff(offsets, append=total) - ns).tolist()
        for n, gap in zip(ns, gaps):
            keep.append(len(sizes))
            sizes.append(n)
            if gap:
                sizes.append(gap)
        parts = torch.split(flat, sizes)
        return [parts[i].view(x.shape) for i, x in zip(keep, xs)]

    steps = {
        "checks": lambda: Q._check_wire_inputs(xs),
        "sizes": lambda: [x.numel() for x in xs],
        "layout": lambda: Q.wire_multi_layout(ns),
        "alloc": lambda: torch.empty(total, dtype=torch.int8,
                                     device=xs[0].device),
        "table": lambda: Q._wire_table(xs, ns, offsets, scales, levels),
        "launch": lambda: Q._wire_launch(table, groups, ns, flat),
        "offsets_list": lambda: offsets.tolist(),
        "views": lambda: Q._views(flat, xs, offsets_list),
        "views_by_split": views_by_split,
        "whole": lambda: Q.wire_quantize_multi(xs, scales, levels),
    }
    runs = {name: [] for name in steps}
    for _ in range(rounds):
        for name, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            runs[name].append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return {name: sorted(r)[len(r) // 2] for name, r in runs.items()}


def phase_kernel(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    shapes = resnet18_shapes()
    assert len(shapes) == 62, len(shapes)
    n_total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_err = {"wire_quantize_multi": 0}
    mismatched = []

    def check(case, got, want):
        torch.cuda.synchronize()
        if got.numel():
            max_err["wire_quantize_multi"] = max(
                max_err["wire_quantize_multi"],
                int((got.int() - want.int()).abs().max()))
        if not torch.equal(got, want):
            mismatched.append(case)

    # The kernel against its plain version on every ResNet-18 shape: tensor
    # by tensor through the one-tensor surface (a push of one tensor), and
    # over the whole push (its flat buffer, padding included).
    for levels in (127, 7):
        xs, scales = k1_push(gen, shapes, [levels] * len(shapes))
        for name, x, scale in zip(shapes, xs, scales):
            check(("wire_quantize_flat", name, levels),
                  Q.wire_quantize_flat(x, scale, levels),
                  Q.wire_quantize_plain(x, scale, levels))
        check(("wire_quantize_multi", levels),
              Q.wire_quantize_multi(xs, scales, [levels] * len(xs))[0],
              Q.wire_quantize_multi_plain(xs, scales, [levels] * len(xs))[0])
    # One push that mixes levels; one whose largest entry is a view x[1:]
    # off 16-byte alignment (the scalar path); a table of 124 entries (two
    # launches of at most 64).
    mixed = [127 if i % 2 else 7 for i in range(len(shapes))]
    xs, scales = k1_push(gen, shapes, mixed)
    check(("wire_quantize_multi", "mixed_levels"),
          Q.wire_quantize_multi(xs, scales, mixed)[0],
          Q.wire_quantize_multi_plain(xs, scales, mixed)[0])
    big = max(range(len(xs)), key=lambda i: xs[i].numel())
    shifted = torch.cat([xs[big].new_zeros(1), xs[big].reshape(-1)])
    xs_m = list(xs)
    xs_m[big] = shifted[1:]
    check(("wire_quantize_multi", "misaligned_view"),
          Q.wire_quantize_multi(xs_m, scales, mixed)[0],
          Q.wire_quantize_multi_plain(xs_m, scales, mixed)[0])
    before = Q.wire_quantize_multi.launches
    check(("wire_quantize_multi", "124_entries"),
          Q.wire_quantize_multi(xs + xs, scales + scales, mixed + mixed)[0],
          Q.wire_quantize_multi_plain(xs + xs, scales + scales,
                                      mixed + mixed)[0])
    if Q.wire_quantize_multi.launches - before != 2:
        mismatched.append(("wire_quantize_multi", "124_entries_launches",
                           Q.wire_quantize_multi.launches - before))
    del xs_m, shifted

    # One whole int8 push of gradient-like tensors: host-issued by CUDA
    # events (twice, around the plain version's runs), and the kernel's
    # device time from torch.profiler.
    xs = [torch.randn(s, generator=gen, device="cuda") * 1e-2
          for s in shapes.values()]
    scales = [float(np.float32(float(x.abs().max()) / 127)) for x in xs]
    int8 = [127] * len(xs)
    pushes = {
        "wire_quantize_multi": lambda: Q.wire_quantize_multi(xs, scales,
                                                             int8)}
    turns = {"wire_quantize_multi": [cuda_time_ms(
        pushes["wire_quantize_multi"], 20)]}
    plain = [cuda_time_ms(lambda: Q.wire_quantize_multi_plain(
        xs, scales, int8), 20) for _ in range(2)]
    turns["wire_quantize_multi"].append(cuda_time_ms(
        pushes["wire_quantize_multi"], 20))
    device = {name: device_ms_per_call(
        fn, 20, f"::{name}_kernel",
        launches_per_call=-(-len(xs) // Q.WIRE_MAX_ENTRIES))
        for name, fn in pushes.items()}
    host_us = k1_host_breakdown(xs, scales, int8)
    # Least time for the same work: each input read once and each output
    # written once (4 + 1 bytes per element), or the fp32 operations
    # (divide, round, two clamps per element) at the fp32 peak.
    bytes_ms = 5 * n_total / H100_BYTES_PER_S * 1e3
    ops_ms = 4 * n_total / H100_FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    state["k1"] = {name: {
        "ms": min(turns[name]), "device_ms": device[name][0],
        "plain_ms": min(plain), "bound_ms": bound_ms,
        "max_abs_err": max_err[name],
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        for name in pushes}
    emit({"phase": "kernel_vs_plain", "kernel": "wire_quantize_multi",
          "shapes": len(shapes), "levels": [127, 7, "mixed"],
          "cases": ["resnet18_127", "resnet18_7", "per_tensor_127",
                    "per_tensor_7", "mixed_levels", "misaligned_view",
                    "124_entries"],
          "elements_per_push": n_total, "max_abs_err": max_err,
          "mismatched": mismatched,
          "push_ms_turns": turns, "plain_push_ms_runs": plain,
          "device_ms_per_push": {n: d[0] for n, d in device.items()},
          "profiled_launches_per_push": {n: d[1]
                                         for n, d in device.items()},
          "share_of_bound_device": {n: bound_ms / d[0]
                                    for n, d in device.items() if d[0]},
          "share_of_bound_host_issued": {n: bound_ms / min(t)
                                         for n, t in turns.items()},
          "bound_ms": bound_ms, "bytes_bound_ms": bytes_ms,
          "ops_bound_ms": ops_ms, "card": state["card"]})
    steps = ("checks", "sizes", "layout", "alloc", "table", "launch",
             "offsets_list", "views")
    emit({"phase": "k1_host_breakdown", "kernel": "wire_quantize_multi",
          "host_us_per_push": host_us,
          "sum_of_steps_us": sum(host_us[k] for k in steps),
          "card": state["card"]})
    if mismatched:
        raise AssertionError(f"K1 differs from its plain version on "
                             f"{mismatched}")


def ring_chunk_rows(n_slots: int = 4) -> tuple[int, int]:
    """(slots, values per slot) of the ResNet-18 ring chunk."""
    return n_slots, -(-11_220_132 // n_slots)


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(smi.stdout.split()[0]) * 1e6


def sass_pipe_counts(symbol: str) -> dict:
    """SASS instructions one thread of the block-quantize kernel whose
    mangled name holds ``symbol`` issues for one quantization block, by
    pipe (SASS_PIPES), from ``cuobjdump -sass`` of the built library: the
    body of the kernel's loop over blocks, from the target of the last
    backward branch before the last EXIT to that branch. The loop is
    straight-line code over a thread's 16 values (four Philox groups);
    the rarely taken paths (a slice past n, the exact division) are calls
    to functions outside it, and the warp-divergence fallbacks sit after
    the EXIT. The code before the loop (once a CTA) is not counted."""
    import re

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        _build

    tool = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    text = subprocess.run(
        [tool, "-sass", str(_build.library_path("block_quantize"))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    funcs = [f for f in re.split(r"^\s*Function : ", text, flags=re.M)[1:]
             if symbol in f.split("\n", 1)[0]]
    if len(funcs) != 1:
        raise AssertionError(f"{len(funcs)} SASS functions match {symbol}")
    ins = [(int(m[1], 16), m[2], re.findall(r"0x([0-9a-f]+)", m[3]))
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+"
                                r"\s+)?([A-Z][A-Z0-9]*)\S*\s*([^;]*);",
                                funcs[0])]
    last_exit = max(i for i, x in enumerate(ins) if x[1] == "EXIT")
    back = max(i for i in range(last_exit) if ins[i][1] == "BRA"
               and ins[i][2] and int(ins[i][2][-1], 16) < ins[i][0])
    head = int(ins[back][2][-1], 16)
    body = [op for addr, op, _ in ins[:back + 1] if addr >= head]
    counts = {pipe: sum(op in ops for op in body)
              for pipe, (_, ops) in SASS_PIPES.items()}
    counts["issued"] = len(body)
    return counts


def block_bound(n_rows: int, n: int, kernel: str,
                sass: dict | None = None) -> tuple[float, str, dict]:
    """Least time for a block kernel's work on ``n_rows`` rows of ``n``
    values: each input read once and each output written once at the
    memory rate, against the operations at their pipes' rates; the
    largest, whether bytes or operations bound it, and each part in ms.

    K2/K3: ``sass`` is :func:`sass_pipe_counts` of the kernel, instructions
    a thread (16 values, padding included), priced per pipe at SASS_PIPES'
    lanes x the SMs x the highest SM clock. K4: a convert and a multiply a
    value at the fp32 peak."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    rows_padded, _, n_blocks = Q.block_layout(n)
    payload = n_rows * (rows_padded * Q.LANES + 4 * n_blocks)
    values = n_rows * n
    parts = {}
    if kernel == "block_dequantize":
        parts["bytes"] = (payload + 4 * values) / H100_BYTES_PER_S * 1e3
        parts["fp32"] = 2 * values / H100_FP32_OPS_PER_S * 1e3
    else:
        parts["bytes"] = (4 * values + payload) / H100_BYTES_PER_S * 1e3
        threads = n_rows * rows_padded * Q.LANES // 16
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = sm_clock_hz()
        for pipe, (lanes, _) in SASS_PIPES.items():
            parts[pipe] = sass[pipe] * threads / (lanes * sms * clock) * 1e3
    bound = max(parts.values())
    return bound, ("bytes" if parts["bytes"] >= bound else "operations"), \
        parts


# K2's and K3's device times on the ring chunk in their first design (one
# thread block a quantization block, two passes over its values), on
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6).
BLOCK_QUANTIZE_FIRST_DESIGN_DEVICE_MS = {"block_quantize": 0.044241,
                                         "block_quantize_stochastic": 0.045867}


def phase_kernel_int8(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    gen = torch.Generator(device="cuda").manual_seed(3)
    n_slots, chunk = ring_chunk_rows()
    ring = torch.randn((n_slots, chunk), generator=gen, device="cuda") * 1e-2
    zero_block = torch.randn((1, 2 * 32768), generator=gen,
                             device="cuda") * 1e-2
    zero_block[:, 32768:] = 0.0
    outlier = torch.randn((1, 2 * 32768), generator=gen, device="cuda") * 1e-2
    outlier[0, 0] = 1000.0
    cases = {
        "ring_chunk_4x2805033": ring,
        # rows 1 and 2 start off 16-byte alignment
        "rows3_n513": torch.randn((3, 513), generator=gen, device="cuda"),
        "n65536": torch.randn((1, 2 * 32768), generator=gen, device="cuda"),
        "zero_block": zero_block,
        "empty": torch.zeros((1, 0), device="cuda"),
        "outlier_block0": outlier,
        # the last block's cluster holds 1 value and 7 CTAs past n
        "n32769": torch.randn((2, 32_769), generator=gen, device="cuda"),
        # a view with the odd row stride 20,003 starting one value in: its
        # rows start 4, 0, 12 and 8 bytes past a 16-byte boundary
        "strided_4x20001": torch.randn(
            (4, 20_003), generator=gen, device="cuda")[:, 1:20_002],
    }
    # Blocks that take the kernels' exact division: a block scale below
    # 2^-40, one above 2^40, and values below scale * 2^-60.
    exact = torch.randn((2, 3 * 32_768 + 1), generator=gen, device="cuda")
    exact[:, :32_768] *= 1e-20
    exact[:, 32_768:65_536] *= 1e15
    exact[:, 65_536::97] = 1e-30 * torch.sign(exact[:, 65_536::97])
    cases["exact_division"] = exact
    # One block of block_elems = 4096 C values, C = 1..8: every cluster size.
    for n in (513, 5_000, 10_000, 15_000, 20_000, 24_000, 28_000, 32_768):
        cases[f"cluster{Q.block_layout(n)[1] * Q.LANES // 4096}_n{n}"] = \
            torch.randn((1, n), generator=gen, device="cuda")
    seeds = [[0x5EED0000 + 64 * k + r for r in range(n_slots)]
             for k in range(3)]
    err = {"block_quantize": 0, "block_quantize_stochastic": 0,
           "block_dequantize": 0.0}
    mismatched = []
    for name, x in cases.items():
        rows = x.shape[0]
        runs = [("block_quantize", Q.block_quantize(x),
                 Q.quantize_int8_plain(x))]
        for sd in seeds:
            runs.append(("block_quantize_stochastic",
                         Q.block_quantize_stochastic(x, sd[:rows]),
                         Q.quantize_int8_plain(x, sd[:rows],
                                               stochastic=True)))
        torch.cuda.synchronize()
        for kernel, got, want in runs:
            if got[0].numel():
                err[kernel] = max(err[kernel], int(
                    (got[0].int() - want[0].int()).abs().max()))
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                mismatched.append((kernel, name))
            back_plain = Q.dequantize_int8_plain(*got, x.shape[1])
            back = Q.block_dequantize(*got, x.shape[1])
            torch.cuda.synchronize()
            if back.numel():
                err["block_dequantize"] = max(err["block_dequantize"], float(
                    (back - back_plain).abs().max()))
            if not torch.equal(back, back_plain):
                mismatched.append(("block_dequantize", name))
    row_offsets = {name: sorted({x[r].data_ptr() % 16
                                 for r in range(x.shape[0])})
                   for name, x in cases.items() if x.numel()}

    # K3 on the chunk: unbiased, and every code floor or floor + 1.
    v, sc = Q.block_quantize_stochastic(ring, seeds[0])
    rows_padded, br, _ = Q.block_layout(chunk)
    scale = sc.repeat_interleave(br * Q.LANES, dim=1)[:, :chunk]
    scaled = ring / scale
    q = v.reshape(n_slots, -1)[:, :chunk].float()
    fl = torch.floor(scaled)
    floor_ok = bool(((q == fl.clamp(-127, 127))
                     | (q == (fl + 1).clamp(-127, 127))).all())
    mean_err = float((q - scaled).mean())   # in units of the block scale
    # Per value the error lies in (-1, 1) with sd <= 1/2: the mean of 11.2M
    # values has sd <= 1.5e-4; 2e-3 is over 13 sd.
    unbiased = abs(mean_err) < 2e-3

    payload = Q.block_quantize(ring)
    # K4's library call: one torch.mul of the int8 blocks by their scales
    # (int8 -> fp32 is exact, then one fp32 multiply, as K4 computes it),
    # which also writes the padding K4 crops; bit-equal to K4 on the chunk.
    n_blocks = payload[1].numel()

    def k4_library():
        return torch.mul(payload[0].view(n_blocks, -1),
                         payload[1].view(n_blocks, 1))

    lib_out = k4_library().view(n_slots, -1)[:, :chunk]
    k4_out = Q.block_dequantize(*payload, chunk)
    torch.cuda.synchronize()
    if not torch.equal(lib_out, k4_out):
        mismatched.append(("block_dequantize", "library_torch_mul"))
    fns = {
        "block_quantize": (lambda: Q.block_quantize(ring),
                           lambda: Q.quantize_int8_plain(ring)),
        "block_quantize_stochastic": (
            lambda: Q.block_quantize_stochastic(ring, seeds[0]),
            lambda: Q.quantize_int8_plain(ring, seeds[0], stochastic=True)),
        "block_dequantize": (
            lambda: Q.block_dequantize(*payload, chunk),
            lambda: Q.dequantize_int8_plain(*payload, chunk)),
    }
    sass = {"block_quantize": sass_pipe_counts("block_quantize_kernelILb0E"),
            "block_quantize_stochastic": sass_pipe_counts(
                "block_quantize_kernelILb1E")}
    state["block_sass"] = sass
    # Each kernel twice by CUDA events (host-issued, 50 calls), then its
    # device time per call (one launch) from torch.profiler's kernel
    # durations.
    ms = {kernel: [cuda_time_ms(fk, 50) for _ in range(2)]
          for kernel, (fk, _) in fns.items()}
    state["block"] = {}
    library = [cuda_time_ms(k4_library, 50) for _ in range(2)]
    for kernel, (fk, fp) in fns.items():
        plain = [cuda_time_ms(fp, 10), cuda_time_ms(fp, 10)]
        device_ms, recorded = device_ms_per_call(
            fk, 50, "::block_dequantize_kernel"
            if kernel == "block_dequantize" else "::block_quantize_kernel")
        bound_ms, bound_by, parts = block_bound(n_slots, chunk, kernel,
                                                sass.get(kernel))
        state["block"][kernel] = {
            "ms": min(ms[kernel]), "device_ms": device_ms,
            "plain_ms": min(plain), "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err[kernel],
            "library_ms": min(library) if kernel == "block_dequantize"
            else None}
        emit({"phase": "kernel_int8_vs_plain", "kernel": kernel,
              "shape": [n_slots, chunk], "ms_runs": ms[kernel],
              "device_ms": device_ms,
              "profiled_launches_per_call": recorded,
              "first_design_device_ms":
                  BLOCK_QUANTIZE_FIRST_DESIGN_DEVICE_MS.get(kernel),
              "plain_ms_runs": plain, "bound_ms": bound_ms,
              "library_ms_runs": library
              if kernel == "block_dequantize" else None,
              "library_bit_equal": kernel == "block_dequantize"
              and ("block_dequantize", "library_torch_mul")
              not in mismatched,
              "bound_by": bound_by, "bound_parts_ms": parts,
              "sass_per_thread_16_values": sass.get(kernel),
              "share_of_bound_device": bound_ms / device_ms
              if device_ms else None,
              "max_abs_err": err[kernel], "card": state["card"]})
    emit({"phase": "kernel_int8_vs_plain", "cases": list(cases),
          "row_offsets_mod_16": row_offsets,
          "k3_seeds": len(seeds), "mismatched": mismatched,
          "k3_mean_error_in_scales": mean_err, "k3_unbiased": unbiased,
          "k3_codes_floor_or_floor_plus_1": floor_ok,
          "sm_clock_max_hz": sm_clock_hz(), "card": state["card"]})
    if mismatched:
        raise AssertionError(f"K2-K4 differ from their plain versions on "
                             f"{mismatched}")
    if not (unbiased and floor_ok):
        raise AssertionError(f"K3 rounding: mean error {mean_err} scales, "
                             f"floor/floor+1 {floor_ok}")


def _payload_equal(a: dict, b: dict) -> str | None:
    if list(a) != list(b):
        return f"key order differs: {list(a)[:4]} vs {list(b)[:4]}"
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or x.shape != y.shape \
                or x.tobytes() != y.tobytes():
            return f"entry {k!r} differs ({x.dtype}{x.shape} vs " \
                   f"{y.dtype}{y.shape})"
        if getattr(a[k], "logical_shape", None) \
                != getattr(b[k], "logical_shape", None):
            return f"entry {k!r}: int4 logical shape differs"
    return None


def phase_codec(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .compression import ErrorFeedback, compress_push
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec

    shapes = resnet18_shapes()
    rng = np.random.default_rng(7)
    cases = [("int8", False), ("int8", True), ("int4", False),
             ("int4", True)]
    checked = 0
    for kind, shared in cases:
        plan = {name: kind for name in shapes}
        codec = DeviceCodec(error_feedback=True, device="cuda")
        ef = ErrorFeedback()
        for push in range(3):
            grads = {n: (rng.standard_normal(s) * 1e-2).astype(np.float32)
                     for n, s in shapes.items()}
            scales = {n: float(np.abs(g).max()) * 0.7
                      for n, g in grads.items()} if shared else None
            want = compress_push(grads, plan, scales=scales, ef=ef)
            dev = {n: torch.from_numpy(g).cuda() for n, g in grads.items()}
            got = codec.encode_now(dev, plan, scales=scales)
            diff = _payload_equal(got, want)
            if diff:
                raise AssertionError(f"codec {kind} shared={shared} push "
                                     f"{push}: {diff}")
            checked += 1
    # Top-k: magnitudes unique by construction (boundary ties are
    # unspecified in the reference), one push without EF.
    plan = {n: ("topk" if math.prod(s) >= 4096 else "int8")
            for n, s in shapes.items()}
    grads = {}
    for n, s in shapes.items():
        size = math.prod(s)
        mags = (rng.permutation(size) + 1).astype(np.float32) * 2.0 ** -22
        signs = np.where(rng.random(size) < 0.5, -1.0, 1.0)
        grads[n] = (mags * signs).astype(np.float32).reshape(s)
    want = compress_push(grads, plan)
    got = DeviceCodec(error_feedback=False, device="cuda").encode_now(
        {n: torch.from_numpy(g).cuda() for n, g in grads.items()}, plan)
    diff = _payload_equal(got, want)
    if diff:
        raise AssertionError(f"codec topk: {diff}")
    checked += 1
    emit({"phase": "codec_bytes", "pushes_checked": checked,
          "cases": [f"{k}{'+shared' if s else ''} x3 EF" for k, s in cases]
          + ["topk+int8 x1"], "equal": True})


N_WORKERS, BATCH = 2, 128


def main_path(steps_per_worker: int, n_test: int, seed: int):
    """The main path's pieces: synthetic CIFAR-100 for ``steps_per_worker``
    batches per worker, full ResNet-18 (100 classes, bf16 compute) on the
    card, and an async int8 store holding its params. Returns
    ``(dataset, model, store, initial params)``."""
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_cifar100
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig)
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    ds = synthetic_cifar100(n_train=N_WORKERS * BATCH * steps_per_worker,
                            n_test=n_test)
    model = get_model("resnet18", num_classes=100, dtype="bfloat16",
                      device="cuda", seed=seed)
    init, _ = params_to_jax(model)
    store = ParameterStore(init, StoreConfig(
        mode="async", total_workers=N_WORKERS, push_codec="int8",
        staleness_bound=5))
    return ds, model, store, init


def grad_step_times(ds, params: dict) -> list:
    """Grad-step times at the main path's shapes: one worker's step over a
    batch of 128, bf16, from ``params`` (NumPy), by CUDA events, 20 runs
    after 5 warm-up runs."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .steps import make_grad_step
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    gs_model = get_model("resnet18", num_classes=100, dtype="bfloat16",
                         device="cuda", seed=1)
    grad_step = make_grad_step(gs_model, augment=True)
    params = {k: torch.from_numpy(np.asarray(v)).cuda()
              for k, v in params.items()}
    _, init_stats = params_to_jax(gs_model)
    stats = {k: torch.from_numpy(v).cuda() for k, v in init_stats.items()}
    xb, yb = ds.x_train[:BATCH], ds.y_train[:BATCH]
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = []
    for i in range(25):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        grad_step(params, stats, xb, yb, gen)
        b.record()
        torch.cuda.synchronize()
        if i >= 5:
            times.append(a.elapsed_time(b))
    return times


def phase_main_path(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        WorkerConfig, run_workers)
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import get_registry

    n_workers, batch = N_WORKERS, BATCH
    ds, model, store, init = main_path(steps_per_worker=8, n_test=1000,
                                       seed=0)
    cfg = WorkerConfig(batch_size=batch, num_epochs=1, device="cuda")
    Q.wire_quantize_multi.launches = 0
    t0 = time.perf_counter()
    results = run_workers(store, model, ds, n_workers, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"wire_quantize_multi": Q.wire_quantize_multi.launches}
    state["k1_launches"] = launches

    pushes = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    errors = [repr(r.error) for r in results if r.error is not None]
    losses = [v for r in results for v in r.train_loss_per_epoch]
    final, step = store.snapshot()
    moved = sum(not np.array_equal(final[k], init[k]) for k in init)
    # Worker-seconds by goodput category (the workers' wall ledger).
    goodput = {k.split("=")[1].rstrip("}"): round(v, 4) for k, v in
               get_registry().snapshot()["counters"].items()
               if k.startswith("dps_goodput_seconds_total{")}
    images = sum(r.local_steps_completed for r in results) * batch
    train_s = max(sum(r.epoch_times) for r in results)

    times = grad_step_times(ds, final)
    state["grad_step_ms"] = float(np.median(times))
    state["main_path_img_per_s"] = images / train_s
    state["main_path_store"] = store.metrics()

    emit({"phase": "main_path", "model": "resnet18", "dtype": "bfloat16",
          "workers": n_workers, "batch_size": batch,
          "push_codec": "int8", "prefetch_batches": cfg.prefetch_batches,
          "global_step": step, "pushes": pushes,
          "pushes_rejected": sum(r.pushes_rejected for r in results),
          "k1_launches": launches, "train_loss_per_epoch": losses,
          "test_accuracies": [r.test_accuracies for r in results],
          "tensors_moved": moved, "images": images,
          "img_per_s": images / train_s, "train_seconds": train_s,
          "run_seconds": wall,
          "grad_step_ms_median": state["grad_step_ms"],
          "grad_step_ms_runs": times, "store": store.metrics(),
          "goodput_worker_seconds": goodput,
          "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")
    if step <= 0 or pushes <= 0:
        raise AssertionError(f"no training happened (step {step}, "
                             f"pushes {pushes})")
    # One launch of the multi-tensor K1 per 64 of a push's 62 tensors.
    want = {"wire_quantize_multi": -(-62 // Q.WIRE_MAX_ENTRIES) * pushes}
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times for {pushes} "
                             f"pushes; expected {want}")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if moved == 0:
        raise AssertionError("the store's params did not move")


@dataclasses.dataclass
class DeviceOp:
    """One device op of a capture (a kernel, copy or set), summed by name:
    its microseconds on the card and its launches."""
    key: str
    self_device_time_total: float
    count: int


@contextlib.contextmanager
def captured():
    """``with captured() as cap: body``: the body under the port's
    ``telemetry.profiler.capture`` into a temporary directory. After the
    block ``cap["events"]`` holds the capture's device ops as
    :class:`DeviceOp` rows (``analysis.top_device_ops``: the card's
    kernel, memcpy and memset events summed by name; a host operator's
    own time never counts) and ``cap["trace"]`` the Chrome trace; the
    directory is removed."""
    import shutil
    import tempfile

    from distributed_parameter_server_for_ml_training_tpu_torch.analysis \
        import load_chrome_trace, top_device_ops
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        .profiler import capture, find_profile_dumps

    logdir = tempfile.mkdtemp(prefix="capture-")
    cap: dict = {}
    try:
        with capture(logdir):
            yield cap
        paths = find_profile_dumps(logdir)
        if len(paths) != 1:
            raise AssertionError(f"the capture wrote {paths}")
        cap["trace"] = load_chrome_trace(paths[0])
        cap["events"] = [
            DeviceOp(op["name"], op["time_s"] * 1e6, op["events"])
            for op in top_device_ops(cap["trace"], 10 ** 9)]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)


def phase_profile(state: dict) -> None:
    """Where the time goes on the main path: the same 2-worker int8 run,
    shorter and without eval, under torch.profiler — device time by kernel
    and the device's busy share of the wall."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        WorkerConfig, run_workers)

    ds, model, store, _ = main_path(steps_per_worker=4, n_test=10, seed=2)
    cfg = WorkerConfig(batch_size=BATCH, num_epochs=1, device="cuda",
                       eval_each_epoch=False)
    torch.cuda.synchronize()
    with captured() as cap:
        t0 = time.perf_counter()
        run_workers(store, model, ds, N_WORKERS, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = cap["events"]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    k1 = [e for e in events if "::wire_quantize_multi_kernel" in e.key]
    k1_launches = sum(e.count for e in k1)
    emit({"phase": "profile", "steps": store.global_step,
          "wall_s": wall, "device_busy_s": device_us / 1e6,
          "device_idle_share": (1 - device_us / 1e6 / wall)
          if device_us else None,
          "wire_quantize_multi_launches": k1_launches,
          "wire_quantize_multi_device_ms_per_push": sum(
              e.self_device_time_total for e in k1) / 1e3 / k1_launches
          if k1_launches else None,
          "top_device_ms": [[e.key[:160], round(e.self_device_time_total
                                               / 1e3, 3), e.count]
                            for e in top],
          "card": state["card"]})


SYNC_SLOTS, SYNC_STEPS = 4, 16


def sync_trainer(steps: int, n_test: int, compression: str = "int8",
                 seed: int = 0):
    """The sync path's trainer: full ResNet-18 (bf16) on the card, 4 slots
    of batch 128, ``steps`` steps of synthetic CIFAR-100 in one epoch."""
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_cifar100
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .distributed import DistributedConfig, SyncTrainer

    ds = synthetic_cifar100(n_train=SYNC_SLOTS * BATCH * steps,
                            n_test=n_test)
    return SyncTrainer(ds, DistributedConfig(
        mode="sync", num_workers=SYNC_SLOTS, batch_size=BATCH, num_epochs=1,
        compression=compression, dtype="bfloat16", device="cuda",
        seed=seed))


def _reset_block_counts():
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    Q.block_quantize.launches = 0
    Q.block_quantize_stochastic.launches = 0
    Q.block_dequantize.launches = 0


def _block_counts() -> dict:
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    return {"block_quantize": Q.block_quantize.launches,
            "block_quantize_stochastic": Q.block_quantize_stochastic.launches,
            "block_dequantize": Q.block_dequantize.launches}


def phase_sync_path(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data.cifar \
        import standardize, to_float
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_sync_dp_step, shard_batch
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .sync_dp import (_int8_ring_allreduce_mean, make_slot_grad_fn,
                         ravel_slots)

    trainer = sync_trainer(SYNC_STEPS, n_test=1000)
    init = {k: v.clone() for k, v in trainer.state.params.items()}
    torch.cuda.synchronize()
    _reset_block_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _block_counts()
    state["sync_counts"] = counts
    steps = trainer.global_steps
    size = sum(v.numel() for v in init.values())
    moved = sum(not torch.equal(init[k], v)
                for k, v in trainer.state.params.items())
    finite = all(math.isfinite(v) for v in trainer.train_loss_per_epoch) \
        and all(bool(torch.isfinite(v).all())
                for v in trainer.state.params.values())
    images = steps * SYNC_SLOTS * BATCH
    train_s = sum(trainer.train_seconds)
    rows_padded, _, n_blocks = Q.block_layout(-(-size // SYNC_SLOTS))
    wire_model = 2 * (SYNC_SLOTS - 1) / SYNC_SLOTS * size \
        + 2 * (SYNC_SLOTS - 1) * 4 * n_blocks

    # Step time at the path's shapes, by CUDA events, on one batch.
    xb = trainer.dataset.x_train[:SYNC_SLOTS * BATCH]
    yb = trainer.dataset.y_train[:SYNC_SLOTS * BATCH]
    bi, bl = shard_batch(trainer.mesh, (xb, yb))
    st = trainer.state
    times = []
    for i in range(13):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st, _ = trainer._step(st, bi, bl, 1)
        b.record()
        torch.cuda.synchronize()
        if i >= 3:
            times.append(a.elapsed_time(b))

    # The ring on one step's real per-slot gradient rows, on the card and
    # on a CPU copy (the plain versions), with the same seed.
    base = trainer.state
    grads, *_ = make_slot_grad_fn(trainer.model)(
        base.params, base.batch_stats, standardize(to_float(bi)), bl.long())
    flat, _ = ravel_slots(grads)
    ring = _int8_ring_allreduce_mean(flat, 0x5EED)
    ring_plain = _int8_ring_allreduce_mean(flat.cpu(), 0x5EED)
    ring_equal = torch.equal(ring.cpu(), ring_plain)
    ring_vs_mean = float((ring[0] - flat.mean(0)).abs().max())
    ring_shape = list(flat.shape)
    del grads, flat, ring, ring_plain

    # One step each from the trained state, uncompressed and int8, the
    # same batch and seed.
    out = {}
    for comp in ("none", "int8"):
        step = make_sync_dp_step(trainer.mesh, trainer.model,
                                 compression=comp, augment=False)
        out[comp], _ = step(base, bi, bl, 7)
    torch.cuda.synchronize()
    worst = [k for k, v in out["int8"].params.items()
             if not torch.allclose(v, out["none"].params[k], rtol=0.05,
                                   atol=1e-3)]
    emit({"phase": "sync_path", "model": "resnet18", "dtype": "bfloat16",
          "slots": SYNC_SLOTS, "batch_per_slot": BATCH,
          "compression": "int8", "steps": steps, "images": images,
          "launches": counts,
          "launches_per_step": {k: v / max(steps, 1)
                                for k, v in counts.items()},
          "train_loss_per_epoch": trainer.train_loss_per_epoch,
          "test_accuracies": trainer.test_accuracies,
          "tensors_moved": moved, "params": size,
          "ring_replicas_identical": trainer.ring_replicas_identical,
          "img_per_s": images / train_s, "train_seconds": train_s,
          "run_seconds": wall,
          "step_ms_median": float(np.median(times)), "step_ms_runs": times,
          "wire_bytes_per_slot_per_step": trainer.wire_bytes_per_slot_step,
          "wire_bytes_model": wire_model,
          "ring_on_card_equals_plain": ring_equal,
          "ring_rows": ring_shape,
          "ring_max_abs_err_vs_exact_mean": ring_vs_mean,
          "int8_vs_none_params_outside_tolerance": worst,
          "card": state["card"]})
    state["sync_img_per_s"] = images / train_s
    want = {"block_quantize": 0,
            "block_quantize_stochastic": SYNC_SLOTS * steps,
            "block_dequantize": (2 * SYNC_SLOTS - 1) * steps}
    if steps != SYNC_STEPS or counts != want:
        raise AssertionError(f"{steps} steps launched {counts}; expected "
                             f"{want}")
    if not finite or moved == 0:
        raise AssertionError(f"losses finite {finite}, tensors moved {moved}")
    if trainer.ring_replicas_identical is not True:
        raise AssertionError("the ring's per-slot results differ")
    if not ring_equal:
        raise AssertionError("the ring on the card differs from the ring "
                             "on the CPU (plain versions)")
    if worst:
        raise AssertionError(f"the int8 step is outside rtol 0.05 / atol "
                             f"1e-3 of the uncompressed step: {worst}")


def phase_sync_profile(state: dict) -> None:
    """Where the time goes on the sync path: 6 int8 steps under
    torch.profiler (eval on 8 images)."""
    import torch

    trainer = sync_trainer(6, n_test=8, seed=2)
    torch.cuda.synchronize()
    with captured() as cap:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = cap["events"]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    emit({"phase": "sync_profile", "steps": trainer.global_steps,
          "wall_s": wall, "device_busy_s": device_us / 1e6,
          "device_idle_share": (1 - device_us / 1e6 / wall)
          if device_us else None,
          "top_device_ms": [[e.key[:160], round(e.self_device_time_total
                                               / 1e3, 3), e.count]
                            for e in top],
          "card": state["card"]})


# -- the single-device baseline ---------------------------------------------

BASELINE_EPOCHS = 2          # (c): eager and graphed, bf16
# The set: 100 steps an epoch of batch 128, and a test set of 2,000.
BASELINE_TRAIN, BASELINE_TEST = 12_800, 2_000
BASELINE_PROFILE_STEPS = 5    # (c): steps in each profile


def _baseline_parts(dtype: str, device: str, milestones, steps_per_epoch,
                    augment: bool, seed: int = 0, name: str = "resnet18",
                    num_classes: int = 100, image_size: int = 32):
    """A full-width registry model (ResNet-18, 100 classes, unless asked)
    with its in-place state and steps."""
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .optimizers import baseline_optimizer
    from distributed_parameter_server_for_ml_training_tpu_torch.train.steps \
        import make_eval_step, make_train_step
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .train_state import module_train_state

    model = get_model(name, num_classes=num_classes, dtype=dtype,
                      image_size=image_size, device=device, seed=seed)
    state = module_train_state(model, baseline_optimizer(
        milestones=milestones, steps_per_epoch=steps_per_epoch))
    ev = make_eval_step(model)
    return (model, state, make_train_step(model, augment=augment),
            lambda x, y: ev({}, {}, x, y)[0])


def _state_diff(a, b) -> dict:
    """Per part of two train states (b the reference): the largest
    absolute difference, the largest relative norm of a tensor's
    difference, and the tensors outside atol 1e-5 / rtol 1e-3."""
    import torch

    out = {}
    for part in ("params", "batch_stats", "momentum"):
        x, y = ((s.opt_state.trace if part == "momentum" else
                 getattr(s, part)) for s in (a, b))
        pairs = [(k, x[k].cpu().double(), y[k].cpu().double()) for k in y]
        out[part] = {
            "max_abs_err": max(float((u - v).abs().max())
                               for _, u, v in pairs),
            "max_rel_norm": max(float((u - v).norm() / v.norm())
                                for _, u, v in pairs if v.norm() > 0),
            "outside": [k for k, u, v in pairs
                        if not torch.allclose(u, v, atol=1e-5, rtol=1e-3)]}
    return out


def _profile_steps(fn, steps: int) -> dict:
    """``fn()`` ``steps`` times under torch.profiler: wall, device busy
    and idle share, device ms by CUDA events, top device kernels."""
    import torch

    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with captured() as cap:
        t0 = time.perf_counter()
        a.record()
        for _ in range(steps):
            fn()
        b.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = cap["events"]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    return {"steps": steps, "wall_s": wall,
            "ms_per_step_by_events": a.elapsed_time(b) / steps,
            "device_busy_s": device_us / 1e6,
            "device_idle_share": (1 - device_us / 1e6 / wall)
            if device_us else None,
            "top_device_ms": [[e.key[:120], round(e.self_device_time_total
                                                 / 1e3, 3), e.count]
                              for e in top]}


def phase_baseline(state: dict) -> None:
    """The single-device baseline (``BaselineTrainer``) on
    ``compositional_cifar100(BASELINE_TRAIN, BASELINE_TEST)``: (a) one
    eager step on the card against the same step on the CPU, in float64
    and in fp32;
    (b) the captured epoch loop against the eager one over the same
    permutations, fp32, augment on, 3 epochs of 4 steps across
    milestones (1, 2); (c) the reference recipe in bf16, 2 epochs eager
    and 2 graphed, each profiled over 5 steps."""
    import itertools

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import Dataset, compositional_cifar100, make_batches
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .baseline import BaselineConfig, BaselineTrainer
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .device_loop import DeviceEpochLoop, prefetch_to_device

    bs = BATCH
    t0 = time.perf_counter()
    ds = compositional_cifar100(BASELINE_TRAIN, BASELINE_TEST, seed=0)
    data_s = time.perf_counter() - t0
    steps_per_epoch = len(ds.x_train) // bs
    out = {"phase": "baseline", "model": "resnet18", "batch_size": bs,
           "dataset": f"compositional_cifar100({BASELINE_TRAIN}, "
                      f"{BASELINE_TEST}, seed=0)",
           "data_seconds": data_s, "steps_per_epoch": steps_per_epoch,
           "card": state["card"]}
    failures = []

    # (a) One eager step, augment off, card against CPU from the same
    # weights on the first batch. In float64 the two compute the same
    # function to rounding: params, batch statistics and momentum within
    # atol 1e-5 / rtol 1e-3. In fp32 the loss and the batch statistics
    # hold that tolerance, and the params' and momentum's differences are
    # reported beside each fp32 run's distance from the float64 one: at
    # full width an fp32 rounding difference flips the sign of a few
    # pre-ReLU activations within rounding of zero, which moves the
    # gradients of every earlier layer by tenths of a percent on either
    # device.
    xb, yb = ds.x_train[:bs], ds.y_train[:bs]
    runs = {}
    for dtype in ("float32", torch.float64):
        for device in ("cuda", "cpu"):
            model, st, step, _ = _baseline_parts(
                dtype, device, (10, 15), steps_per_epoch, False)
            if runs:
                model.load_state_dict(weights)
            else:
                weights = {k: v.cpu() for k, v in model.state_dict().items()}
            _, m = step(st, xb, yb)
            runs[(str(dtype), device)] = (st, float(m["loss"]))
            del model
    f32, f64 = "float32", str(torch.float64)
    a64 = _state_diff(runs[(f64, "cuda")][0], runs[(f64, "cpu")][0])
    a32 = _state_diff(runs[(f32, "cuda")][0], runs[(f32, "cpu")][0])
    losses = {f"{d}/{dev}": loss for (d, dev), (_, loss) in runs.items()}
    out["a_card_vs_cpu"] = {
        "tolerance": "atol 1e-5, rtol 1e-3",
        "float64": a64, "float32": a32, "losses": losses,
        "float32_vs_float64_rel_norm": {
            dev: {part: v["max_rel_norm"] for part, v in _state_diff(
                runs[(f32, dev)][0], runs[(f64, "cpu")][0]).items()}
            for dev in ("cuda", "cpu")}}
    bad = [f"float64 {p}" for p, v in a64.items() if v["outside"]]
    if a32["batch_stats"]["outside"]:
        bad.append("float32 batch_stats")
    l32 = [losses[f"{f32}/cuda"], losses[f"{f32}/cpu"]]
    if abs(l32[0] - l32[1]) > 1e-5 + 1e-3 * abs(l32[1]):
        bad.append(f"float32 loss {l32}")
    if bad:
        failures.append(f"(a) card against CPU outside atol 1e-5 / rtol "
                        f"1e-3: {bad}")
    del runs

    # (b) The captured loop against the eager loop, fp32, augment on,
    # with cuDNN's deterministic algorithms: the default ones sum some
    # gradients in an order that changes from launch to launch, and at
    # full width that alone moves two eager runs apart by more than the
    # tolerance within two steps (ReLU sign flips, as in (a)).
    small = Dataset(ds.x_train[:4 * bs], ds.y_train[:4 * bs],
                    ds.x_test[:1000], ds.y_test[:1000])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = {}
    for graph in (True, False):
        model, st, step, ev = _baseline_parts("float32", "cuda", (1, 2), 4,
                                              True)
        gen = torch.Generator(device="cuda").manual_seed(1)
        runs[graph] = [DeviceEpochLoop(small, step, ev, batch_size=bs,
                                       generator=gen, graph=graph), st, gen,
                       [], []]
    draws_equal = gen_equal = True
    for _ in range(3):
        for graph, run in runs.items():
            run[1], m = run[0].run_epoch(run[1])
            run[3].append(m["learning_rate"])
            run[4].append(m["loss"])
        draws_equal &= torch.equal(runs[True][0].draws, runs[False][0].draws)
        gen_equal &= torch.equal(runs[True][2].get_state(),
                                 runs[False][2].get_state())
    torch.backends.cudnn.deterministic = deterministic
    gs, es = runs[True][1], runs[False][1]
    bit_equal = all(torch.equal(a, b)
                    for a, b in zip(gs.tensors(), es.tensors()))
    close = all(torch.allclose(a.float(), b.float(), atol=1e-6, rtol=1e-5)
                for a, b in zip(gs.tensors(), es.tensors()))
    b_errs = {part: v["max_abs_err"]
              for part, v in _state_diff(gs, es).items()}
    lr_bits = [[hex(int(v)) for v in
                np.array(e, np.float32).view(np.uint32)]
               for e in runs[True][3]]
    want_bits = [["0x3dcccccd"] * 4, ["0x3c23d70b"] * 4, ["0x3a83126f"] * 4]
    out["b_graph_vs_eager"] = {
        "epochs": 3, "steps_per_epoch": 4, "cudnn_deterministic": True,
        "bit_equal": bit_equal,
        "within_tolerance": close, "tolerance": "atol 1e-6, rtol 1e-5",
        "max_abs_err": b_errs, "draws_equal": draws_equal,
        "generator_states_equal": gen_equal,
        "graph_lr_bits": lr_bits,
        "eager_lr_equal": runs[True][3] == runs[False][3],
        "graph_losses": runs[True][4], "eager_losses": runs[False][4],
        "step_counts": [gs.step, es.step, int(gs.opt_state.count)]}
    if not (close and draws_equal and gen_equal and lr_bits == want_bits
            and runs[True][3] == runs[False][3]):
        failures.append(f"(b) graph against eager: {out['b_graph_vs_eager']}")
    del runs, gs, es

    # (c) The reference recipe at full size, bf16, eager then graphed.
    paths = {}
    for name, device_loop in (("eager", False), ("graph", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer = BaselineTrainer(ds, BaselineConfig(
            num_epochs=BASELINE_EPOCHS, device_loop=device_loop,
            device="cuda"))
        met = trainer.train()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        images = steps_per_epoch * bs
        if device_loop:
            loop = trainer._device_loop

            def step_fn(loop=loop):
                loop._cuda_graph.replay()
            loop._slot.zero_()
        else:
            batches = prefetch_to_device(make_batches(
                ds.x_train, ds.y_train, bs, seed=12345), depth=2)
            batches = itertools.cycle(list(itertools.islice(
                batches, BASELINE_PROFILE_STEPS + 3)))
            for _ in range(3):     # the profile starts with warm steps
                trainer._train_step(trainer.state, *next(batches),
                                    trainer._gen)

            def step_fn(trainer=trainer, batches=batches):
                trainer._train_step(trainer.state, *next(batches),
                                    trainer._gen)
        prof = _profile_steps(step_fn, BASELINE_PROFILE_STEPS)
        paths[name] = {
            "epoch_seconds": met.epoch_times,
            "train_seconds": trainer.train_seconds,
            "img_per_s_epoch2": images / trainer.train_seconds[-1],
            "train_loss": met.train_losses,
            "train_accuracy_pct": met.train_accuracies,
            "test_accuracy_pct": met.test_accuracies,
            "peak_memory_gib": peak, "profile": prof}
        learned = met.test_accuracies[-1] > 2.0 \
            and met.train_losses[-1] < met.train_losses[0]
        paths[name]["learned"] = learned
        if not learned:
            failures.append(f"(c) {name} did not learn: loss "
                            f"{met.train_losses}, test "
                            f"{met.test_accuracies}")
        del trainer
    out["c_full_size"] = {"dtype": "bfloat16", "augment": True,
                          "epochs": BASELINE_EPOCHS, **paths}
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


# -- flash attention (K5-K7) and the SP path ----------------------------------

HOP = (192, 2048, 64)           # [N*B*H, T/N, D] of the SP path's ring hops


def _flash_case(bh: int, t: int, d: int, dtype, out_dtype, *, kv_len=None,
                causal=False, q_offset=0, k_offset=0, seed=0):
    """K5, K6 and K7 and their plain versions on one input, and on bf16
    inputs the wgmma forward (``flash_fwd_wgmma``, outputs ``O_wgmma``,
    ``LSE_wgmma``) and the fused backward (``flash_bwd``, outputs
    ``dQ_fused``, ``dK_fused``, ``dV_fused``): returns ``{output:
    (kernel's, plain version's)}`` over the unpadded rows, and the
    forwards' ``{wrapper: (O, LSE)}``."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((bh, t, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    kv_len = kv_len or t
    for x in (q, k, v, do):       # padded rows are zeros, as the caller pads
        x[:, kv_len:] = 0
    kw = dict(out_dtype=out_dtype, causal=causal, q_offset=q_offset,
              k_offset=k_offset)
    o, lse = fa.flash_fwd(q, k, v, kv_len, **kw)
    fwd = {"flash_fwd": (o, lse)}
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, kv_len, **kw)
    delta = (do.float() * o_p.float()).sum(-1, keepdim=True)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, kv_len, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, kv_len,
                              q_len=kv_len, **kw)
    dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, do, lse_p, delta, kv_len,
                                          **kw)
    rows = slice(0, kv_len)
    pairs = {"O": (o[:, rows], o_p[:, rows]),
             "LSE": (lse[:, rows], lse_p[:, rows]),
             "dQ": (dq[:, rows], dq_p[:, rows]),
             "dK": (dk, dk_p), "dV": (dv, dv_p)}
    if dtype == torch.bfloat16:
        ow, lsew = fwd["flash_fwd_wgmma"] = fa.flash_fwd_wgmma(q, k, v,
                                                               kv_len, **kw)
        fq, fk, fv = fa.flash_bwd(q, k, v, do, lse_p, delta, kv_len,
                                  q_len=kv_len, **kw)
        pairs.update({"O_wgmma": (ow[:, rows], o_p[:, rows]),
                      "LSE_wgmma": (lsew[:, rows], lse_p[:, rows]),
                      "dQ_fused": (fq[:, rows], dq_p[:, rows]),
                      "dK_fused": (fk, dk_p), "dV_fused": (fv, dv_p)})
    torch.cuda.synchronize()
    return {name: (a.float(), b.float()) for name, (a, b) in pairs.items()}, \
        fwd


#: Operations of each flash kernel's work, in units of BH T^2 D.
FLASH_MATS = {"flash_fwd_wgmma": 4, "flash_fwd": 4, "flash_bwd": 10,
              "flash_bwd_dq": 6, "flash_bwd_dkv": 8}


def _flash_bounds(bh: int, t: int, d: int) -> dict:
    """Least time of each kernel's work at ``[bh, t, d]`` bf16 in, fp32
    out, non-causal: max(FLOPs at the bf16 tensor-core peak, bytes (each
    input read once, each output written once) at the HBM rate). The
    fused backward's work is S, dP, dV, dK and dQ, 10 BH T^2 D."""
    mat = bh * t * t * d
    io_in, row = 2 * bh * t * d, 4 * bh * t
    fwd = (4 * mat, 3 * io_in + 4 * bh * t * d + row)
    work = {"flash_fwd_wgmma": fwd, "flash_fwd": fwd,
            "flash_bwd": (10 * mat,
                          4 * io_in + 2 * row + 12 * bh * t * d),
            "flash_bwd_dq": (6 * mat, 4 * io_in + 2 * row + 4 * bh * t * d),
            "flash_bwd_dkv": (8 * mat,
                              4 * io_in + 2 * row + 8 * bh * t * d)}
    out = {}
    for name, (flops, nbytes) in work.items():
        ops_ms = flops / H100_BF16_OPS_PER_S * 1e3
        bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
        out[name] = (max(ops_ms, bytes_ms),
                     "operations" if ops_ms >= bytes_ms else "bytes")
    return out


def phase_kernel_flash(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    bh, t, d = HOP
    # name: (args, kwargs, tolerance). bf16 in, fp32 out: 5e-3, about 3x
    # the largest error seen; 2e-2 only where the output itself is bf16.
    cases = {
        "hop_bf16_fp32out": ((bh, t, d, bf16, f32), {}, 5e-3),
        "hop_fp32": ((bh, t, d, f32, f32), {}, 2e-3),
        "t197_padded256_bf16": ((64, 256, 64, bf16, bf16),
                                dict(kv_len=197), 2e-2),
        "t197_padded256_fp32": ((64, 256, 64, f32, f32),
                                dict(kv_len=197), 2e-3),
        "causal_128_0_bf16": ((64, 256, 64, bf16, f32),
                              dict(causal=True, q_offset=128), 5e-3),
        "causal_128_0_fp32": ((64, 256, 64, f32, f32),
                              dict(causal=True, q_offset=128), 2e-3),
        "two_slots_causal_fp32": ((64, 256, 64, f32, f32),
                                  dict(causal=True, q_offset=[0, 256],
                                       k_offset=[0, 0]), 2e-3),
        "d128_bf16": ((48, 512, 128, bf16, f32), {}, 5e-3),
        "d128_fp32": ((48, 512, 128, f32, f32), dict(causal=True), 2e-3),
        # bf16 out: slot 0's first rows see 1-64 keys, where rounding dS
        # to bf16 (the TPU kernel's rounding, which the first version's
        # K6/K7 share) alone can exceed the 5e-3 limit of an fp32 output.
        "two_slots_causal_bf16": ((64, 256, 64, bf16, bf16),
                                  dict(causal=True, q_offset=[0, 256],
                                       k_offset=[0, 0]), 2e-2),
    }
    errors, typical, bad = {}, {}, []
    hop_err = {}
    for name, (args, kw, tol) in cases.items():
        pairs, _ = _flash_case(*args, **kw)
        errors[name], typical[name] = {}, {}
        for out, (a, b) in pairs.items():
            errors[name][out] = float((a - b).abs().max())
            typical[name][out] = float(b.abs().mean())
            if not torch.allclose(a, b, atol=tol, rtol=tol):
                bad.append((name, out))
        if name == "hop_bf16_fp32out":
            hop_err = errors[name]
        del pairs
        torch.cuda.empty_cache()
    # A block wholly in the future of every query: no key tile runs, every
    # output is exactly 0 (LSE -1e30), in fp32 (K5-K7) and in bf16 (K5, the
    # wgmma forward and the fused backward).
    future = {}
    for dtype in (f32, bf16):
        pairs, fwd = _flash_case(64, 256, 64, dtype, f32, causal=True,
                                 k_offset=2048)
        grads = {n: float(a.abs().max()) for n, (a, _) in pairs.items()
                 if n.startswith("d")}
        future[str(dtype)] = {"grad_max_abs": grads}
        for wrapper, (o, lse) in fwd.items():
            future[str(dtype)][wrapper] = {"O_max_abs": float(o.abs().max()),
                                           "LSE_max": float(lse.max())}
            if float(o.abs().max()) != 0.0 or float(lse.max()) > -1e29:
                bad.append(("future_block", str(dtype), wrapper))
        if any(x != 0.0 for x in grads.values()):
            bad.append(("future_block", str(dtype), "gradients"))

    # Times at the hop shape, bf16 in and fp32 out, as the ring runs them.
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((bh, t, d), generator=gen,
                               device="cuda").to(bf16) for _ in range(4))
    # Two launches on one input: the wgmma forward's O and LSE and the
    # fused backward's dK and dV are summed in a fixed order (bit-equal);
    # dQ's fp32 partial sums arrive in an order that varies.
    o, lse = fa.flash_fwd_wgmma(q, k, v, t, out_dtype=f32)
    o2, lse2 = fa.flash_fwd_wgmma(q, k, v, t, out_dtype=f32)
    delta = (do.float() * o).sum(-1, keepdim=True)
    a = fa.flash_bwd(q, k, v, do, lse, delta, t, out_dtype=f32)
    b = fa.flash_bwd(q, k, v, do, lse, delta, t, out_dtype=f32)
    torch.cuda.synchronize()
    repeat = {"O_wgmma_bit_equal": bool(torch.equal(o, o2)),
              "LSE_wgmma_bit_equal": bool(torch.equal(lse, lse2)),
              "dK_bit_equal": bool(torch.equal(a[1], b[1])),
              "dV_bit_equal": bool(torch.equal(a[2], b[2])),
              "dQ_max_abs_diff": float((a[0] - b[0]).abs().max())}
    if not all(x for n, x in repeat.items() if n.endswith("bit_equal")):
        bad.append(("repeat", repeat))
    del a, b, o2, lse2
    q4, k4, v4, do4 = (x.view(bh // 12, 12, t, d) for x in (q, k, v, do))
    lib = torch.ops.aten._scaled_dot_product_flash_attention(q4, k4, v4)
    kernels = {
        "flash_fwd_wgmma": lambda: fa.flash_fwd_wgmma(q, k, v, t,
                                                      out_dtype=f32),
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, t, out_dtype=f32),
        "flash_bwd": lambda: fa.flash_bwd(q, k, v, do, lse, delta, t,
                                          out_dtype=f32),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, t,
                                                out_dtype=f32),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta,
                                                  t, out_dtype=f32)}
    # The backward kernels' plain version is one function, the dense
    # backward (dQ, dK and dV together), as is the library's backward call.
    plain = {"fwd": lambda: fa.flash_fwd_plain(q, k, v, t, out_dtype=f32),
             "bwd": lambda: fa.flash_bwd_plain(q, k, v, do, lse, delta, t,
                                               out_dtype=f32)}
    library = {
        "fwd": lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            q4, k4, v4),
        "bwd": lambda: torch.ops.aten
        ._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, lib[0], lib[1], lib[2], lib[3], lib[4], lib[5],
            0.0, False, lib[6], lib[7])}
    bounds = _flash_bounds(bh, t, d)
    err = {"flash_fwd_wgmma": max(hop_err["O_wgmma"], hop_err["LSE_wgmma"]),
           "flash_fwd": max(hop_err["O"], hop_err["LSE"]),
           "flash_bwd": max(hop_err["dQ_fused"], hop_err["dK_fused"],
                            hop_err["dV_fused"]),
           "flash_bwd_dq": hop_err["dQ"],
           "flash_bwd_dkv": max(hop_err["dK"], hop_err["dV"])}
    # Each redesign against its first version and the library, in turns
    # (new, old, library, library, old, new) in this one call.
    redesigns = {"fwd": ("flash_fwd_wgmma", "first_version_k5",
                         kernels["flash_fwd"]),
                 "bwd": ("flash_bwd", "first_version_k6_k7",
                         lambda: (kernels["flash_bwd_dq"](),
                                  kernels["flash_bwd_dkv"]()))}
    turns, lib_ms, ms = {}, {}, {}
    for key, (new, old, old_fn) in redesigns.items():
        fns = {new: kernels[new], old: old_fn, "library": library[key]}
        turns[key] = {name: [] for name in fns}
        for name in (new, old, "library", "library", old, new):
            turns[key][name].append(cuda_time_ms(fns[name], 20))
        lib_ms[key] = turns[key]["library"]
        ms[new] = turns[key][new]
        if key == "fwd":
            ms["flash_fwd"] = turns[key][old]
        mats = FLASH_MATS[new] * bh * t * t * d
        emit({"phase": "kernel_flash_vs_plain", "redesign": new,
              "shape": list(HOP), "dtype": "bfloat16 in, float32 out",
              "turns_ms": turns[key], "bound_ms": bounds[new][0],
              f"tflops_{FLASH_MATS[new]}_mats": {
                  n: mats / min(x) / 1e9 for n, x in turns[key].items()},
              "share_of_bound": bounds[new][0] / min(turns[key][new]),
              "faster_than_first_version_in_every_turn": max(
                  turns[key][new]) < min(turns[key][old]),
              "repeat": repeat, "card": state["card"]})
    plain_ms = {key: [cuda_time_ms(fn, 3)] for key, fn in plain.items()}
    state["flash"] = {}
    for name, fk in kernels.items():
        key = "fwd" if name.startswith("flash_fwd") else "bwd"
        if name not in ms:
            ms[name] = [cuda_time_ms(fk, 20), cuda_time_ms(fk, 20)]
        plain_ms[key].append(cuda_time_ms(plain[key], 3))
        bound_ms, bound_by = bounds[name]
        state["flash"][name] = {
            "ms": min(ms[name]), "plain_ms": min(plain_ms[key]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": min(lib_ms[key]), "max_abs_err": err[name]}
        emit({"phase": "kernel_flash_vs_plain", "kernel": name,
              "shape": list(HOP), "dtype": "bfloat16 in, float32 out",
              "ms_runs": ms[name], "plain_ms_runs": plain_ms[key],
              "library_ms_runs": lib_ms[key],
              "library_call": ("aten._scaled_dot_product_flash_attention"
                               if key == "fwd" else
                               "aten._scaled_dot_product_flash_attention_"
                               "backward (dQ, dK and dV together)"),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "tflops": FLASH_MATS[name] * bh * t * t * d / min(ms[name])
              / 1e9,
              "card": state["card"]})
    emit({"phase": "kernel_flash_vs_plain", "cases": errors,
          "mean_abs_plain": typical,
          "tolerance": {name: tol for name, (_, _, tol) in cases.items()},
          "future_block": future, "outside_tolerance": bad,
          "card": state["card"]})
    if bad:
        raise AssertionError(f"the flash kernels differ from their plain "
                             f"versions: {bad}")
    if max(ms["flash_fwd_wgmma"]) >= min(ms["flash_fwd"]):
        raise AssertionError(f"the wgmma forward is not faster than the "
                             f"first version in every turn: "
                             f"{turns['fwd']}")


SP_STEPS, SP_BATCH, SP_SLOTS, SP_IMAGE = 2, 8, 2, 1024
RING_ATOL, RING_RTOL = 5e-3, 2.0 ** -7


#: The SP path's synthetic sets by (steps, n_test, seed): the host draws
#: a 1024 x 1024 set in ~4 s, and phases 11 and 22 (a) train on the same
#: one four times (each trainer only reads it).
_SP_SETS: dict = {}


def sp_trainer(steps: int, n_test: int, seed: int = 0, group=None):
    """The SP path's trainer: ViT-B/16 (bf16, 1,000 classes) on synthetic
    ImageNet at 1024 x 1024 over 2 sequence slots, batch 8 (over
    ``group``'s ranks where one is given)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.data import \
        synthetic_imagenet
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import ModelParallelConfig, SPTrainer

    key = (steps, n_test, seed)
    if key not in _SP_SETS:
        _SP_SETS[key] = synthetic_imagenet(
            n_train=SP_BATCH * steps, n_test=n_test, image_size=SP_IMAGE,
            seed=seed)
    ds = _SP_SETS[key]
    return SPTrainer(ds, ModelParallelConfig(
        model="vit_b16", num_workers=SP_SLOTS, batch_size=SP_BATCH,
        num_epochs=1, num_classes=ds.num_classes, dtype="bfloat16",
        device="cuda", seed=seed), group=group)


def _flash_counts() -> dict:
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as fa

    return {"flash_fwd_wgmma": fa.flash_fwd_wgmma.launches,
            "flash_fwd": fa.flash_fwd.launches,
            "flash_bwd": fa.flash_bwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def _reset_flash_counts() -> None:
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as fa

    fa.flash_fwd_wgmma.launches = 0
    fa.flash_fwd.launches = 0
    fa.flash_bwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def phase_sp_path(state: dict) -> None:
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data.cifar \
        import standardize, to_float
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .ring_attention import make_ring_flash_attention

    trainer = sp_trainer(SP_STEPS, n_test=SP_BATCH)
    if not trainer.flash or trainer.tokens != 4096:
        raise AssertionError(f"SP path not on the flash ring (flash "
                             f"{trainer.flash}, {trainer.tokens} tokens)")
    model = trainer.model
    init = {k: v.clone() for k, v in trainer.state.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_flash_counts()
    t0 = time.perf_counter()
    metrics = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _flash_counts()
    state["sp_counts"] = counts
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = trainer.global_steps
    eval_batches = -(-len(trainer.dataset.x_test) // 1000)
    moved = sum(not torch.equal(init[k], v)
                for k, v in trainer.state.params.items())
    finite = all(math.isfinite(v) for v in trainer.train_loss_per_epoch) \
        and all(bool(torch.isfinite(v).all())
                for v in trainer.state.params.values())

    # Step time at the path's shapes, by CUDA events.
    xb, yb = trainer.dataset.x_train[:SP_BATCH], \
        trainer.dataset.y_train[:SP_BATCH]
    gen = torch.Generator(device="cuda").manual_seed(3)
    times = []
    for i in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        trainer._step(trainer.state, xb, yb, gen)
        b.record()
        torch.cuda.synchronize()
        if i:
            times.append(a.elapsed_time(b))

    # One layer's ring on real activations: kernels against plain hops.
    # The input of block 0's attention, from one forward of the model.
    captured = {}
    hook = model.block_0.attn.register_forward_pre_hook(
        lambda mod, args: captured.setdefault("x", args[0]))
    with torch.no_grad():
        model(standardize(to_float(torch.as_tensor(xb, device="cuda"))))
        hook.remove()
        qkv = model.block_0.attn.qkv(captured.pop("x")).view(
            SP_BATCH, trainer.tokens, 3, 12, 64)
    ring_err = {}
    outs = {}
    cot = torch.randn((SP_BATCH, 4096, 12, 64), device="cuda",
                      generator=gen).to(torch.bfloat16)
    for kind in ("kernel", "plain"):
        ring = make_ring_flash_attention(trainer.mesh,
                                         use_kernel=kind == "kernel")
        q, k, v = (qkv[:, :, i].detach().clone().requires_grad_()
                   for i in range(3))
        out = ring(q, k, v)
        (out.float() * cot.float()).sum().backward()
        outs[kind] = [out.detach().float(), q.grad.float(), k.grad.float(),
                      v.grad.float()]
        del q, k, v, out
        torch.cuda.empty_cache()
    # The ring returns bf16: a one-step rounding difference is 2^-7 of
    # the value, so rtol is one bf16 step and atol covers values near 0.
    ring_ok, ring_typical = True, {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), outs["kernel"],
                          outs["plain"]):
        ring_err[name] = float((a - b).abs().max())
        ring_typical[name] = float(b.abs().mean())
        ring_ok &= bool(torch.allclose(a, b, atol=RING_ATOL,
                                       rtol=RING_RTOL))
    del outs
    torch.cuda.empty_cache()

    images = steps * SP_BATCH
    train_s = sum(trainer.train_seconds)
    state["sp_step_ms"] = float(np.median(times))
    emit({"phase": "sp_path", "model": "vit_b16", "dtype": "bfloat16",
          "image_size": SP_IMAGE, "tokens": trainer.tokens,
          "seq_slots": SP_SLOTS, "tokens_per_slot": trainer.tokens // SP_SLOTS,
          "batch_size": SP_BATCH, "steps": steps,
          "eval_batches": eval_batches, "launches": counts,
          "train_loss_per_epoch": trainer.train_loss_per_epoch,
          "test_accuracies": trainer.test_accuracies,
          "tensors_moved": moved, "metrics": metrics,
          "img_per_s": images / train_s, "train_seconds": train_s,
          "run_seconds": wall, "step_ms_median": state["sp_step_ms"],
          "step_ms_runs": times, "peak_memory_gib": peak_gb,
          "ring_layer0_kernel_vs_plain_max_abs_err": ring_err,
          "ring_layer0_plain_mean_abs": ring_typical,
          "card": state["card"]})
    # One wgmma forward and one fused backward a hop; the first versions
    # of K5, K6 and K7 (fp32 inputs) are on no step of this bf16 path.
    want = {"flash_fwd_wgmma": 24 * (steps + eval_batches), "flash_fwd": 0,
            "flash_bwd": 24 * steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if steps != SP_STEPS or counts != want:
        raise AssertionError(f"{steps} steps launched {counts}; expected "
                             f"{want}")
    if not finite or moved == 0:
        raise AssertionError(f"losses finite {finite}, tensors moved {moved}")
    if not ring_ok:
        raise AssertionError(f"the ring with the kernels is outside atol "
                             f"{RING_ATOL} / rtol {RING_RTOL} of the ring "
                             f"with plain hops: {ring_err}")


def phase_sp_profile(state: dict) -> None:
    """Where the time goes on the SP path: one step under torch.profiler."""
    import torch

    trainer = sp_trainer(1, n_test=1, seed=2)
    xb, yb = trainer.dataset.x_train, trainer.dataset.y_train
    gen = torch.Generator(device="cuda").manual_seed(0)
    trainer._step(trainer.state, xb, yb, gen)           # warm-up
    torch.cuda.synchronize()
    with captured() as cap:
        t0 = time.perf_counter()
        trainer._step(trainer.state, xb, yb, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = cap["events"]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:15]
    flash_us = sum(e.self_device_time_total for e in events
                   if "flash_" in e.key and "kernel" in e.key)
    fused = [e for e in events if "flash_bwd_kernel" in e.key]
    forward = [e for e in events if "flash_fwd_wgmma_kernel" in e.key]
    emit({"phase": "sp_profile", "steps": 1, "wall_s": wall,
          "device_busy_s": device_us / 1e6,
          "device_idle_share": (1 - device_us / 1e6 / wall)
          if device_us else None,
          "flash_kernels_device_s": flash_us / 1e6,
          "flash_bwd_device_ms": sum(e.self_device_time_total
                                     for e in fused) / 1e3,
          "flash_bwd_launches": sum(e.count for e in fused),
          "flash_fwd_wgmma_device_ms": sum(e.self_device_time_total
                                           for e in forward) / 1e3,
          "flash_fwd_wgmma_launches": sum(e.count for e in forward),
          "top_device_ms": [[e.key[:160], round(e.self_device_time_total
                                               / 1e3, 3), e.count]
                            for e in top],
          "card": state["card"]})


def phase_cli(state: dict) -> None:
    from distributed_parameter_server_for_ml_training_tpu_torch import cli

    runs = {"async": ["train", "--mode", "async", "--workers", "2",
                      "--epochs", "1", "--synthetic", "--num-train", "1024",
                      "--num-test", "500", "--emit-metrics"],
            "sync_int8": ["train", "--mode", "sync", "--workers", "4",
                          "--compression", "int8", "--epochs", "1",
                          "--synthetic", "--num-train", "2048",
                          "--num-test", "500", "--emit-metrics"],
            "baseline": ["train", "--mode", "baseline", "--epochs", "1",
                         "--synthetic", "--num-train", "2048",
                         "--num-test", "500", "--emit-metrics"],
            "sp_vit_b16_1024": ["train", "--mode", "sp", "--model", "vit_b16",
                                "--dataset", "imagenet-synth",
                                "--image-size", "1024", "--workers", "2",
                                "--batch-size", "8", "--num-train", "8",
                                "--num-test", "8", "--epochs", "1",
                                "--emit-metrics"]}
    for name, argv in runs.items():
        t0 = time.perf_counter()
        rc = cli.main(argv)
        emit({"phase": "cli", "run": name, "rc": rc,
              "seconds": round(time.perf_counter() - t0, 3)})
        if rc != 0:
            raise AssertionError(f"cli {' '.join(argv)} returned {rc}")


# Phases 14 (b), 26 (b), (c): each `cli worker` process, start to exit,
# and each `cli serve`, after its workers exit.
GRPC_WORKER_TIMEOUT_S = 420
GRPC_SERVER_TIMEOUT_S = 60


def _rpc_timer(remote, times: dict) -> None:
    """Time every call of ``remote``'s method stubs into ``times[rpc]``
    (milliseconds), beside the client's own histograms."""
    for name, call in list(remote._call.items()):
        def timed(request, timeout=None, call=call, name=name):
            t0 = time.perf_counter()
            try:
                return call(request, timeout=timeout)
            finally:
                times.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
        remote._call[name] = timed


def _grpc_run(steps_per_worker: int, n_test: int, seed: int,
              eval_each_epoch: bool, record: bool, store_kw=None,
              worker_kw=None, probe=None, service=None, worker_kw_of=None,
              parts=None, batch: int = BATCH):
    """Phase 5's configuration through the port's gRPC service on
    127.0.0.1: the server in this process, 2 ``PSWorker`` threads on the
    card, each through its own ``RemoteStore``. ``store_kw`` and
    ``worker_kw`` add StoreConfig and WorkerConfig options (phase 15),
    ``worker_kw_of(i)`` options of worker i alone (phase 18), and
    ``service(store)`` builds the service (phase 18: with a monitor).
    With ``record``, the service keeps every push request and fetch
    reply, and the device codec the first gradients of each worker.
    ``probe(workers, done)`` runs on a thread of its own while the
    workers train. ``parts`` replaces phase 5's ``(dataset, model, store,
    initial params)`` and ``batch`` its batch (phase 19). Returns a dict
    of the run's pieces."""
    import threading

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, PSWorker, StoreConfig, WorkerConfig)

    ds, model, store, init = parts or main_path(steps_per_worker, n_test,
                                                seed)
    if store_kw:
        store = ParameterStore(init, StoreConfig(**{
            "mode": "async", "total_workers": N_WORKERS,
            "push_codec": "int8", "staleness_bound": 5, **store_kw}))
    svc = service(store) if service else ParameterService(store)
    pushes, fetches, first_grads = [], [], {}
    encode = DeviceCodec.encode
    if record:
        push_body, fetch_body = svc.push_gradrients, svc.fetch_parameters

        def push_rec(request, ctx):
            reply = push_body(request, ctx)
            pushes.append((bytes(request), reply))
            return reply

        def fetch_rec(request, ctx):
            reply = fetch_body(request, ctx)
            fetches.append((len(request), reply))
            return reply
        svc.push_gradrients, svc.fetch_parameters = push_rec, fetch_rec

        def encode_spy(self, flat, plan=None, scales=None):
            wid = threading.current_thread().result.worker_id
            if wid not in first_grads:
                first_grads[wid] = (
                    {k: v.detach().float().cpu().numpy()
                     for k, v in flat.items()},
                    dict(plan or {}), dict(scales or {}))
            return encode(self, flat, plan=plan, scales=scales)
        DeviceCodec.encode = encode_spy
    server, port = serve(store, port=0, service=svc, host="127.0.0.1")
    rpc_ms: dict = {}
    remotes = [RemoteStore(f"127.0.0.1:{port}") for _ in range(N_WORKERS)]
    for r in remotes:
        _rpc_timer(r, rpc_ms)
    workers = [PSWorker(r, model, ds, WorkerConfig(
        batch_size=batch, num_epochs=1, device="cuda",
        eval_each_epoch=eval_each_epoch, **(worker_kw or {}),
        **(worker_kw_of(i) if worker_kw_of else {})),
        worker_name=f"grpc-{i}") for i, r in enumerate(remotes)]
    done = threading.Event()
    prober = threading.Thread(target=probe, args=(workers, done),
                              daemon=True) if probe else None
    try:
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        if prober is not None:
            prober.start()
        for w in workers:
            w.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        done.set()
        if prober is not None:
            prober.join(10)
        DeviceCodec.encode = encode
        for r in remotes:
            r.close()
        server.stop(grace=None).wait(10)
    return {"store": store, "init": init, "results": [w.result
                                                      for w in workers],
            "remotes": remotes, "wall": wall, "pushes": pushes,
            "fetches": fetches, "first_grads": first_grads,
            "rpc_ms": rpc_ms, "address": f"127.0.0.1:{port}",
            "service": svc, "workers": workers}


def _grpc_in_process(state: dict) -> None:
    import collections

    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .wire import encode_tensor_dict, frame_checksum_ok
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .compression import ErrorFeedback, compress_push
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import get_registry

    corrupt = get_registry().counter("dps_wire_corrupt_total")
    corrupt0 = corrupt.value
    Q.wire_quantize_multi.launches = 0
    run = _grpc_run(steps_per_worker=8, n_test=1000, seed=0,
                    eval_each_epoch=True, record=True)
    launches = {"wire_quantize_multi": Q.wire_quantize_multi.launches}
    state["grpc_k1_launches"] = launches
    store, results = run["store"], run["results"]
    errors = [repr(r.error) for r in results if r.error is not None]
    n_push = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    final, step = store.snapshot()
    moved = sum(not np.array_equal(final[k], run["init"][k])
                for k in run["init"])
    replies = [unpack_msg(reply)[0] for _, reply in run["pushes"]]
    duplicates = sum(bool(m.get("duplicate")) for m in replies)
    refused = sum(bool(m.get("corrupt")) for m in replies)
    frames = [unpack_msg(req) for req, _ in run["pushes"]]
    trailer_ok = sum(frame_checksum_ok(f) is True for _, f in frames)
    # Each worker's first push against the NumPy codec on the same
    # gradients: a fresh error feedback, the same plan and scales.
    frame_checks = {}
    for wid, (grads, plan, scales) in sorted(run["first_grads"].items()):
        want = encode_tensor_dict(
            compress_push(grads, plan, scales=scales or None,
                          ef=ErrorFeedback()), checksum=True)
        got = [bytes(f) for m, f in frames if m["worker_id"] == wid
               and m["push_token"].endswith(":1")]
        frame_checks[wid] = {"bytes": len(want),
                             "equal": got == [want]}
    fetch_meta = [unpack_msg(r)[0] for _, r in run["fetches"]]
    full = [len(r) for (_, r), m in zip(run["fetches"], fetch_meta)
            if not m.get("not_modified")]
    nm = [len(r) for (_, r), m in zip(run["fetches"], fetch_meta)
          if m.get("not_modified")]
    hist = get_registry().snapshot()["histograms"]
    rpc_hist = {k.split("rpc=")[1].rstrip("}"): {
        "count": h["count"],
        "mean_ms": h["sum"] / h["count"] * 1e3 if h["count"] else None}
        for k, h in hist.items() if k.startswith("dps_rpc_client_seconds")
        and h["count"]}
    images = sum(r.local_steps_completed for r in results) * BATCH
    train_s = max(sum(r.epoch_times) for r in results)
    state["grpc_a"] = {
        "img_per_s": images / train_s,
        "rpc_ms_median": {k: float(np.median(v))
                          for k, v in sorted(run["rpc_ms"].items())},
        "push_request_bytes": sorted(set(len(q) for q, _ in run["pushes"])),
        "fetch_reply_bytes_full": sorted(set(full))}
    emit({"phase": "grpc_path", "form": "in_process", "model": "resnet18",
          "workers": N_WORKERS, "batch_size": BATCH, "push_codec": "int8",
          "global_step": step, "pushes": n_push,
          "pushes_rejected": sum(r.pushes_rejected for r in results),
          "k1_launches": launches, "duplicates": duplicates,
          "refused_corrupt": refused,
          "corrupt_counter": corrupt.value - corrupt0,
          "push_frames_with_valid_crc": trailer_ok,
          "first_push_frame_vs_compress_push": frame_checks,
          "tensors_moved": moved,
          "train_loss_per_epoch": [v for r in results
                                   for v in r.train_loss_per_epoch],
          "test_accuracies": [r.test_accuracies for r in results],
          "images": images, "img_per_s": images / train_s,
          "train_seconds": train_s, "run_seconds": run["wall"],
          "phase5_img_per_s": state.get("main_path_img_per_s"),
          "rpc_ms_median": {k: float(np.median(v))
                            for k, v in sorted(run["rpc_ms"].items())},
          "rpc_calls": {k: len(v) for k, v in sorted(run["rpc_ms"].items())},
          "rpc_client_histograms": rpc_hist,
          "push_request_bytes": sorted(set(len(q) for q, _ in run["pushes"])),
          "push_reply_bytes": sorted(set(len(r) for _, r in run["pushes"])),
          "push_frame_bytes": sorted(set(len(f) for _, f in frames)),
          "fetch_request_bytes": sorted(set(n for n, _ in run["fetches"])),
          "fetch_reply_bytes_full": sorted(set(full)),
          "fetch_reply_bytes_not_modified": sorted(set(nm)),
          "fetches_full": len(full), "fetches_not_modified": len(nm),
          "wire_stats": [r.wire for r in results],
          "store": store.metrics(),
          "staleness_counts": dict(sorted(collections.Counter(
              store.stats.staleness_values).items())),
          "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")
    if step <= 0 or n_push != N_WORKERS * 8:
        raise AssertionError(f"step {step}, {n_push} pushes; expected "
                             f"a step above 0 and {N_WORKERS * 8} pushes")
    want = {"wire_quantize_multi": -(-62 // Q.WIRE_MAX_ENTRIES) * n_push}
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times for {n_push} "
                             f"pushes; expected {want}")
    if duplicates or refused or corrupt.value != corrupt0:
        raise AssertionError(f"{duplicates} duplicate and {refused} "
                             f"corrupt push replies")
    if trailer_ok != n_push or len(frames) != n_push:
        raise AssertionError(f"{trailer_ok} of {len(frames)} push frames "
                             f"carry a valid CRC trailer; {n_push} pushes")
    if len(frame_checks) != N_WORKERS or not all(
            c["equal"] for c in frame_checks.values()):
        raise AssertionError(f"push frames differ from compress_push's: "
                             f"{frame_checks}")
    if moved == 0:
        raise AssertionError("the store's params did not move")


def _grpc_profile(state: dict) -> None:
    """The same path, shorter and without eval, under torch.profiler."""
    import torch

    torch.cuda.synchronize()
    with captured() as cap:
        run = _grpc_run(steps_per_worker=4, n_test=10, seed=2,
                        eval_each_epoch=False, record=False)
    events = cap["events"]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    errors = [repr(r.error) for r in run["results"] if r.error is not None]
    state["grpc_idle_share"] = (1 - device_us / 1e6 / run["wall"]) \
        if device_us else None
    emit({"phase": "grpc_path", "form": "profile",
          "steps": run["store"].global_step, "wall_s": run["wall"],
          "device_busy_s": device_us / 1e6,
          "device_idle_share": state["grpc_idle_share"],
          "top_device_ms": [[e.key[:120], round(e.self_device_time_total
                                               / 1e3, 3), e.count]
                            for e in top],
          "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")


def _metrics_rows(text: str) -> list:
    return [json.loads(line.split("METRICS_JSON:", 1)[1])
            for line in text.splitlines() if "METRICS_JSON:" in line]


def _grpc_processes(state: dict, profiles: str) -> list:
    """The reference's topology: ``cli serve`` and 2 ``cli worker``
    processes on the card, over gRPC on 127.0.0.1, each worker under
    ``--profile-dir <profiles>/w<i>``. Returns each worker's METRICS_JSON
    rows."""
    port = _free_port()
    run = _cli_topology(
        [["--mode", "async", "--workers", "2", "--push-codec", "int8",
          "--port", str(port)]],
        [["--server", f"127.0.0.1:{port}", "--worker-name", f"proc-{i}",
          "--synthetic", "--num-train", "2048", "--num-test", "256",
          "--epochs", "1"]
         for i in range(2)], profiles)
    if run["late"]:
        raise AssertionError(
            f"{run['late']}; killed. Output tails: {run['worker_err']} "
            f"{[e[-1500:] for e in run['server_err']]}")
    rows, srv = run["worker_rows"], run["server_rows"][0]
    rcs = {"server": run["rcs"]["servers"][0],
           "workers": run["rcs"]["workers"]}
    img_s = _worker_img_s(rows)
    sm = srv[-1] if srv else {}
    # Beside phase 26 (b)'s sharded numbers.
    state["grpc_b_profiled"] = {
        "workers_img_per_s": img_s, "img_per_s_summed": sum(img_s),
        "wall_seconds": run["wall_seconds"],
        "global_steps": sm.get("global_steps_completed")}
    emit({"phase": "grpc_path", "form": "b_processes_profiled",
          "port": port,
          "rcs": rcs, "wall_seconds": run["wall_seconds"],
          "wall_split": run["wall_split"],
          "workers_img_per_s": img_s, "img_per_s_summed": sum(img_s),
          "worker_metrics": [r[-1] if r else None for r in rows],
          "server_metrics": sm,
          "server_apply_seconds": sm.get("average_update_time_seconds", 0)
          * sm.get("total_parameter_updates", 0),
          "card": state["card"]})
    if rcs != {"server": 0, "workers": [0, 0]}:
        tails = run["worker_err"] + [e[-2000:] for e in run["server_err"]]
        raise AssertionError(f"process exit codes {rcs}: {tails}")
    if not sm or sm.get("global_steps_completed", 0) <= 0:
        raise AssertionError(f"server metrics report no step: {sm}")
    if len(img_s) != 2:
        raise AssertionError(f"worker metrics missing: {rows}")
    return rows


def _worker_captures(state: dict) -> None:
    """Phase 14 (b): ``_grpc_processes`` with each ``cli worker``
    process under ``--profile-dir``; its capture, attributed, must hold
    one ``quantize-pack`` event a push it made (ResNet-18's 62 tensors:
    one K1 launch a push), or a worker that fell off the kernel route
    passes. The same run's exit codes, server step and img/s are phase
    14 (b)'s; phase 26 (b) stands beside them."""
    import os
    import shutil
    import tempfile

    from distributed_parameter_server_for_ml_training_tpu_torch.analysis \
        import attribute_profile, load_chrome_trace, top_device_ops
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        .profiler import find_profile_dumps

    out, failures = [], []
    profiles = tempfile.mkdtemp(prefix="worker-profiles-")
    try:
        rows = _grpc_processes(state, profiles)
        for i, r in enumerate(rows):
            logdir = os.path.join(profiles, f"w{i}")
            prof = attribute_profile(logdir)["profile"]
            k1 = sum(op["events"] for path in find_profile_dumps(logdir)
                     for op in top_device_ops(load_chrome_trace(path),
                                              10 ** 6)
                     if "wire_quantize_multi_kernel" in op["name"])
            pushes = r[-1]["rpc_counts"].get("PushGradrients", 0)
            qp = prof["op_classes"].get("quantize-pack", {})
            out.append({"worker": i, "pushes": pushes, "basis":
                        prof["basis"], "quantize_pack_events":
                        qp.get("events", 0), "k1_kernel_events": k1,
                        "quantize_pack_s": qp.get("time_s", 0.0),
                        "total_attributed_s": prof["total_attributed_s"]})
            if prof["basis"] != "device_lanes" or pushes <= 0 \
                    or qp.get("events", 0) < pushes or k1 != pushes:
                failures.append(out[-1])
    finally:
        shutil.rmtree(profiles, ignore_errors=True)
    emit({"phase": "grpc_path", "form": "b_worker_captures",
          "workers": out, "card": state["card"]})
    if failures:
        raise AssertionError(f"worker captures off the kernel route: "
                             f"{failures}")


def phase_grpc_path(state: dict) -> None:
    """Phase 14: the gRPC path, in one process and across processes."""
    _grpc_in_process(state)
    _grpc_profile(state)
    _worker_captures(state)


# Phase 15: the store options and the worker's modes over gRPC.
MODES_STORE = dict(fetch_codec="bf16", worker_timeout=30)
MODES_WORKER = dict(k_step_mode="local_sgd", sync_steps=4, overlap=True,
                    heartbeat_interval=1.0)
MODES_STEPS = 16          # batches of 128 a worker: 4,096 images, 4 pushes
MODES_TURN_STEPS = 8      # each overlap off/on turn: 2 pushes


def _saved_values(names):
    """Have the registry hand out, for the named histograms, proxies that
    keep every observed value (the workers create theirs at start);
    returns (values by histogram name, restore)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import get_registry
    reg = get_registry()
    orig = reg.histogram
    kept = {name: [] for name in names}

    class Keeping:
        def __init__(self, inner, box):
            self._inner, self._box = inner, box

        def observe(self, v, *args, **kwargs):
            self._box.append(float(v))
            return self._inner.observe(v, *args, **kwargs)

        def __getattr__(self, name):
            return getattr(self._inner, name)

    def histogram(name, *args, **kwargs):
        h = orig(name, *args, **kwargs)
        return Keeping(h, kept[name]) if name in kept else h

    reg.histogram = histogram

    def restore():
        del reg.histogram
    return kept, restore


def _modes_levers(state: dict) -> None:
    """(a) The reference topology with the JAX package's levers on, beside
    phase 14 (a) from the same run; then the same run with overlap off,
    and a profiled shorter one."""
    import ml_dtypes
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .wire import frame_checksum_ok
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    depth = {"max": 0, "samples": 0, "busy": 0}

    def sample_depth(workers, done):
        while not done.is_set():
            for w in workers:
                pipe = w._pipe
                if pipe is not None:
                    d = int(pipe._tm_depth.value)   # the depth gauge
                    depth["max"] = max(depth["max"], d)
                    depth["samples"] += 1
                    depth["busy"] += d
            time.sleep(0.0005)

    saved, restore = _saved_values(("dps_worker_overlap_saved_seconds",
                                    "dps_worker_d2h_overlap_saved_seconds"))
    Q.wire_quantize_multi.launches = 0
    try:
        run = _grpc_run(steps_per_worker=MODES_STEPS, n_test=1000, seed=0,
                        eval_each_epoch=True, record=True,
                        store_kw=MODES_STORE, worker_kw=MODES_WORKER,
                        probe=sample_depth)
    finally:
        restore()
    launches = Q.wire_quantize_multi.launches
    state["modes_k1_launches"] = {"wire_quantize_multi": launches}
    store, results = run["store"], run["results"]
    errors = [repr(r.error) for r in results if r.error is not None]
    n_push = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    final, step = store.snapshot()
    moved = sum(not np.array_equal(final[k], run["init"][k])
                for k in run["init"])
    replies = [unpack_msg(reply)[0] for _, reply in run["pushes"]]
    duplicates = sum(bool(m.get("duplicate")) for m in replies)
    frames = [unpack_msg(req)[1] for req, _ in run["pushes"]]
    crc_ok = sum(frame_checksum_ok(f) is True for f in frames)
    fetch_meta = [unpack_msg(r)[0] for _, r in run["fetches"]]
    full = [len(r) for (_, r), m in zip(run["fetches"], fetch_meta)
            if not m.get("not_modified")]
    nm = sum(bool(m.get("not_modified")) for m in fetch_meta)
    # One fetch decoded by a fresh client, against the store's params
    # cast to bf16 and back, bit for bit (the run is over: no push races
    # it).
    server, port = serve(store, port=0, service=ParameterService(store),
                         host="127.0.0.1")
    try:
        probe_client = RemoteStore(f"127.0.0.1:{port}")
        probe_client.register_worker("probe")
        fetched, fstep = probe_client.fetch()
        probe_client.close()
    finally:
        server.stop(grace=None).wait(10)
    want, wstep = store.snapshot()
    fetch_bits = fstep == wstep and list(fetched) == sorted(want) and all(
        fetched[k].tobytes() == want[k].astype(ml_dtypes.bfloat16)
        .astype(np.float32).tobytes() for k in want)
    images = sum(r.local_steps_completed for r in results) * BATCH
    train_s = max(sum(r.epoch_times) for r in results)
    img_s = images / train_s
    ov = saved["dps_worker_overlap_saved_seconds"]
    d2h = saved["dps_worker_d2h_overlap_saved_seconds"]
    heartbeats = [r.heartbeats for r in results]

    # The same configuration, unrecorded and eval off, with overlap off
    # and on in turns (off, on, on, off): what the pipeline hides.
    turns = {False: [], True: []}
    s_err = []
    for overlap in (False, True, True, False):
        t_run = _grpc_run(steps_per_worker=MODES_TURN_STEPS, n_test=10,
                          seed=0,
                          eval_each_epoch=False, record=False,
                          store_kw=MODES_STORE,
                          worker_kw={**MODES_WORKER, "overlap": overlap})
        t_res = t_run["results"]
        s_err += [repr(r.error) for r in t_res if r.error is not None]
        turns[overlap].append(
            sum(r.local_steps_completed for r in t_res) * BATCH
            / max(sum(r.epoch_times) for r in t_res))

    # A shorter run, eval off, under torch.profiler: the idle share.
    torch.cuda.synchronize()
    with captured() as cap:
        prof_run = _grpc_run(steps_per_worker=8, n_test=10, seed=2,
                             eval_each_epoch=False, record=False,
                             store_kw=MODES_STORE, worker_kw=MODES_WORKER)
    events = cap["events"]
    device_us = sum(e.self_device_time_total for e in events)
    idle = (1 - device_us / 1e6 / prof_run["wall"]) if device_us else None
    p_err = [repr(r.error) for r in prof_run["results"]
             if r.error is not None]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    p14 = state.get("grpc_a", {})
    emit({"phase": "grpc_modes", "form": "levers", "model": "resnet18",
          "workers": N_WORKERS, "batch_size": BATCH,
          "store": {"mode": "async", "push_codec": "int8",
                    "staleness_bound": 5, **MODES_STORE},
          "worker": MODES_WORKER, "images_per_worker": MODES_STEPS * BATCH,
          "global_step": step, "pushes": n_push,
          "pushes_rejected": sum(r.pushes_rejected for r in results),
          "k1_launches": launches, "duplicates": duplicates,
          "push_frames_with_valid_crc": crc_ok,
          "fetch_decoded_equals_bf16_of_store": fetch_bits,
          "pipeline_depth_max": depth["max"],
          "pipeline_depth_samples": depth["samples"],
          "pipeline_busy_share": depth["busy"] / max(depth["samples"], 1),
          "heartbeats": heartbeats,
          "heartbeat_errors": [r.heartbeat_errors for r in results],
          "tensors_moved": moved,
          "train_loss_per_epoch": [v for r in results
                                   for v in r.train_loss_per_epoch],
          "test_accuracies": [r.test_accuracies for r in results],
          "img_per_s": img_s, "train_seconds": train_s,
          "img_per_s_turns_overlap_on": turns[True],
          "img_per_s_turns_overlap_off": turns[False],
          "phase14_img_per_s": p14.get("img_per_s"),
          "rpc_ms_median": {k: float(np.median(v))
                            for k, v in sorted(run["rpc_ms"].items())},
          "rpc_calls": {k: len(v) for k, v in sorted(run["rpc_ms"].items())},
          "phase14_rpc_ms_median": p14.get("rpc_ms_median"),
          "push_request_bytes": sorted(set(len(q) for q, _ in run["pushes"])),
          "phase14_push_request_bytes": p14.get("push_request_bytes"),
          "fetch_reply_bytes_full": sorted(set(full)),
          "phase14_fetch_reply_bytes_full": p14.get(
              "fetch_reply_bytes_full"),
          "fetches_full": len(full), "fetches_not_modified": nm,
          "overlap_saved_s": {"sum": float(sum(ov)), "count": len(ov),
                              "median": float(np.median(ov)) if ov
                              else None},
          "d2h_saved_s": {"sum": float(sum(d2h)), "count": len(d2h)},
          "device_idle_share": idle,
          "phase14_device_idle_share": state.get("grpc_idle_share"),
          "profiled_steps": prof_run["store"].global_step,
          "profiled_wall_s": prof_run["wall"],
          "top_device_ms": [[e.key[:100], round(
              e.self_device_time_total / 1e3, 3), e.count] for e in top],
          "store_metrics": store.metrics(),
          "card": state["card"]})
    if errors or s_err or p_err:
        raise AssertionError(f"worker errors: {errors} {s_err} {p_err}")
    pushes_want = N_WORKERS * MODES_STEPS // MODES_WORKER["sync_steps"]
    if n_push != pushes_want or launches != n_push:
        raise AssertionError(f"{n_push} pushes and {launches} K1 launches;"
                             f" expected {pushes_want} of each")
    if duplicates or crc_ok != n_push or len(frames) != n_push:
        raise AssertionError(f"{duplicates} duplicates, {crc_ok} of "
                             f"{len(frames)} frames with a valid CRC")
    p14_full = (p14.get("fetch_reply_bytes_full") or [44_885_549])[0]
    if not full or not all(0.45 < n / p14_full < 0.55 for n in full):
        raise AssertionError(f"full bf16 fetch replies {sorted(set(full))}"
                             f" are not about half of {p14_full}")
    if not fetch_bits:
        raise AssertionError("a decoded bf16 fetch differs from the "
                             "store's params cast to bf16")
    if depth["max"] > 1 or depth["busy"] == 0:
        raise AssertionError(f"pipeline depth {depth}")
    if min(heartbeats) <= 0 or moved == 0:
        raise AssertionError(f"heartbeats {heartbeats}, {moved} tensors "
                             f"moved")


def _one_worker(store, model, ds, **worker_kw):
    """One PSWorker on the card against an in-process store whose pushes
    it records; returns (pushes, result)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        PSWorker, WorkerConfig)

    class Recording:
        def __init__(self, inner):
            self._inner, self.pushes = inner, []

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def push(self, wid, grads, step):
            self.pushes.append({k: np.array(v) for k, v in grads.items()})
            return self._inner.push(wid, grads, step)

    rec = Recording(store)
    w = PSWorker(rec, model, ds, WorkerConfig(
        batch_size=BATCH, num_epochs=1, device="cuda",
        eval_each_epoch=False, **worker_kw))
    w.run()
    if w.result.error is not None:
        raise w.result.error
    return rec.pushes, w.result


def _modes_bits(state: dict) -> None:
    """(b) Bit checks on the card, one worker, deterministic cuDNN:
    local_sgd with K=1 pushes the faithful step's int8 frame, and
    overlap=True leaves the store bit-equal to overlap=False."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .wire import encode_tensor_dict
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig)

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        # 512 images: 4 batches for the one worker, 2 pushes at K=2.
        ds, model, _, init = main_path(2, 10, 3)

        def store():
            return ParameterStore(init, StoreConfig(
                mode="async", total_workers=1, push_codec="int8",
                staleness_bound=5))
        one = dataclasses.replace(ds, x_train=ds.x_train[:BATCH],
                                  y_train=ds.y_train[:BATCH])
        faithful, _ = _one_worker(store(), model, one)
        local, _ = _one_worker(store(), model, one, k_step_mode="local_sgd",
                               sync_steps=1)
        frames = [encode_tensor_dict(p[0], checksum=True)
                  for p in (faithful, local)]
        k1_equal = frames[0] == frames[1]
        runs = {}
        for overlap in (False, True):
            st = store()
            pushes, res = _one_worker(st, model, ds, k_step_mode="local_sgd",
                                      sync_steps=2, overlap=overlap)
            runs[overlap] = (st.snapshot(), pushes, res)
        (sp, sstep), _, _ = runs[False]
        (pp, pstep), _, _ = runs[True]
        overlap_equal = sstep == pstep and all(
            sp[k].tobytes() == pp[k].tobytes() for k in sp)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev
    emit({"phase": "grpc_modes", "form": "bits", "cudnn_deterministic": True,
          "local_sgd_k1_frame_bytes": len(frames[1]),
          "local_sgd_k1_frame_equals_faithful": k1_equal,
          "overlap_store_equals_serial": overlap_equal,
          "overlap_steps": [sstep, pstep], "card": state["card"]})
    if not k1_equal:
        raise AssertionError("local_sgd K=1's int8 frame differs from "
                             "faithful's")
    if not overlap_equal or sstep != 2:
        raise AssertionError(f"overlap=True's store differs from "
                             f"overlap=False's (steps {sstep}, {pstep})")


def _modes_resume(state: dict) -> None:
    """(c) A resume drill: the server is stopped just before the worker's
    3rd push leaves and a new one starts on the same port from
    ``load_snapshot`` of the old store's snapshot."""
    import threading

    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, PSWorker, StoreConfig, WorkerConfig)

    # MODES_STEPS batches for the one worker: its 4 pushes.
    ds, model, _, init = main_path(MODES_STEPS // N_WORKERS, 10, 4)

    def store():
        return ParameterStore(init, StoreConfig(
            mode="async", total_workers=1, push_codec="int8",
            staleness_bound=5, **MODES_STORE))
    store1 = store()
    server1, port = serve(store1, port=0, host="127.0.0.1",
                          service=ParameterService(store1))
    client = RemoteStore(f"127.0.0.1:{port}", rpc_timeout=10.0,
                         rpc_retries=1, rpc_backoff=0.05)
    worker = PSWorker(client, model, ds, WorkerConfig(
        batch_size=BATCH, num_epochs=1, device="cuda", eval_each_epoch=False,
        reconnect_timeout=60.0, reconnect_backoff=0.05, **MODES_WORKER))
    killed, restarted = threading.Event(), threading.Event()
    holder = {}

    def restart_after_kill():
        killed.wait(120)
        time.sleep(0.3)
        params, step = holder["snapshot"]
        store2 = store()
        store2.load_snapshot(params, step)
        server2, bound = serve(store2, port=port, host="127.0.0.1",
                               service=ParameterService(store2))
        holder.update(server2=server2, store2=store2, bound=bound)
        restarted.set()

    inner_push = client._call["PushGradrients"]

    def push_with_kill(request, timeout=None):
        push_with_kill.calls += 1
        if push_with_kill.calls == 3 and not killed.is_set():
            holder["snapshot"] = store1.snapshot()
            server1.stop(grace=None).wait(10)
            killed.set()
        return inner_push(request, timeout=timeout)

    push_with_kill.calls = 0
    client._call["PushGradrients"] = push_with_kill
    t = threading.Thread(target=restart_after_kill, daemon=True)
    t0 = time.perf_counter()
    t.start()
    worker.start()
    worker.join(300)
    t.join(120)
    wall = time.perf_counter() - t0
    try:
        r = worker.result
        store2 = holder.get("store2")
        total = MODES_STEPS // MODES_WORKER["sync_steps"]
        snap_step = holder["snapshot"][1] if "snapshot" in holder else None
        emit({"phase": "grpc_modes", "form": "resume",
              "error": repr(r.error) if r.error else None,
              "reconnects": r.reconnects, "pushes": total,
              "pushes_accepted": r.pushes_accepted,
              "snapshot_step": snap_step,
              "restored_port_bound": holder.get("bound") == port,
              "new_store_step": store2.global_step if store2 else None,
              "new_store_pushes_applied":
                  store2.stats.gradients_processed if store2 else None,
              "wall_s": wall, "card": state["card"]})
        if r.error is not None or worker.is_alive():
            raise AssertionError(f"worker failed: {r.error!r}")
        if not (killed.is_set() and restarted.is_set()
                and holder["bound"] == port):
            raise AssertionError("the server was not restarted on its port")
        # Each push applied exactly once: 2 before the stop (in the
        # snapshot), the rest — the stranded one re-sent under its own
        # token included — on the new server.
        if (r.reconnects, r.pushes_accepted, snap_step,
                store2.global_step, store2.stats.gradients_processed) != (
                1, total, 2, total, total - 2):
            raise AssertionError("a push was lost or applied twice")
    finally:
        if "server2" in holder:
            holder["server2"].stop(grace=None).wait(10)
        client.close()


def phase_grpc_modes(state: dict) -> None:
    """Phase 15: the store options and the worker's modes over gRPC."""
    _modes_levers(state)
    _modes_bits(state)
    _modes_resume(state)


# -- phase 16: the device-resident store -------------------------------------

# Bytes one async apply over ResNet-18 must move: read p, read g, write p,
# 11,220,132 fp32 values each.
APPLY_BYTES = 3 * 4 * 11_220_132
# A step's host-to-device bytes beside its batch: the labels and scalars.
SMALL_COPY_BYTES = 16_384


def _device_store_setup(steps_per_worker: int, n_test: int, seed: int,
                        backend: str = "device"):
    """Phase 5's configuration over ``make_store(backend, ...)``: the
    device store on the card, or (``python``) phase 5's int8 host store.
    Returns (dataset, model, store, initial params); the model's upload
    and the store's are done here, outside any measured run."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        StoreConfig, make_store)

    ds, model, store, init = main_path(steps_per_worker, n_test, seed)
    if backend == "device":
        store = make_store("device", init, StoreConfig(
            mode="async", total_workers=N_WORKERS, staleness_bound=5),
            device="cuda")
    torch.cuda.synchronize()
    return ds, model, store, init


def _device_store_run(model, store, ds, eval_each_epoch: bool):
    """The 2 workers' run over ``store``: (results, wall seconds)."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        WorkerConfig, run_workers)

    cfg = WorkerConfig(batch_size=BATCH, num_epochs=1, device="cuda",
                       eval_each_epoch=eval_each_epoch)
    t0 = time.perf_counter()
    results = run_workers(store, model, ds, N_WORKERS, cfg)
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def _img_per_s(results) -> float:
    """Images over the slowest worker's training seconds (eval out)."""
    images = sum(r.local_steps_completed for r in results) * BATCH
    return images / max(sum(r.epoch_times) for r in results)


def _device_store_async(state: dict) -> None:
    """(a) Phase 5's run with the device store: K1 must not launch. Then
    phase 5's python-store run again and the device store's again, in
    turns, with every cache warm (eval off)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    ds, model, store, init = _device_store_setup(8, 1000, 0)
    Q.wire_quantize_multi.launches = 0
    results, wall = _device_store_run(model, store, ds, True)
    k1 = Q.wire_quantize_multi.launches
    pushes = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    errors = [repr(r.error) for r in results if r.error is not None]
    losses = [v for r in results for v in r.train_loss_per_epoch]
    final, step = store.snapshot()
    moved = sum(not np.array_equal(final[k], init[k]) for k in init)
    train_s = max(sum(r.epoch_times) for r in results)
    times = grad_step_times(ds, final)
    metrics = store.metrics()
    python = state.get("main_path_store", {})
    turns = {}
    for backend in ("python", "device"):
        tds, tmodel, tstore, _ = _device_store_setup(8, 10, 0, backend)
        turns[backend] = _img_per_s(_device_store_run(
            tmodel, tstore, tds, False)[0])
    emit({"phase": "device_store", "form": "async", "model": "resnet18",
          "dtype": "bfloat16", "workers": N_WORKERS, "batch_size": BATCH,
          "global_step": step, "pushes": pushes, "k1_launches": k1,
          "img_per_s": _img_per_s(results),
          "img_per_s_python_store": state.get("main_path_img_per_s"),
          "img_per_s_turns_eval_off": turns,
          "train_seconds": train_s, "run_seconds": wall,
          "grad_step_ms_median": float(np.median(times)),
          "grad_step_ms_median_python_store": state.get("grad_step_ms"),
          "apply_s_mean": metrics["average_update_time_seconds"],
          "apply_samples": len(store.stats.update_times),
          "update_time_wait_every": metrics.get("update_time_wait_every"),
          "apply_s_mean_python_store":
              python.get("average_update_time_seconds"),
          "train_loss_per_epoch": losses,
          "test_accuracies": [r.test_accuracies for r in results],
          "tensors_moved": moved, "store": metrics, "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")
    if step <= 0 or step != pushes:
        raise AssertionError(f"step {step} for {pushes} pushes")
    if k1 != 0:
        raise AssertionError(f"K1 launched {k1} times on the device-store "
                             f"path, which has no codec")
    if not losses or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if moved == 0:
        raise AssertionError("the store's params did not move")


def _memcpy_bytes(trace: dict) -> dict:
    """Bytes and count of a capture's memory copies by kind (HtoD, DtoH,
    DtoD, ...), from its Chrome trace's memcpy events."""
    out: dict = {}
    for ev in trace.get("traceEvents", []):
        name = str(ev.get("name", ""))
        if not name.startswith("Memcpy") or ev.get("ph") != "X":
            continue
        kind = name.split()[1]
        n = (ev.get("args") or {}).get("bytes")
        if n is None:
            raise AssertionError(f"memcpy event without a byte count: "
                                 f"{ev}")
        row = out.setdefault(kind, {"bytes": 0, "count": 0})
        row["bytes"] += int(n)
        row["count"] += 1
    return out


def _device_store_profile(state: dict) -> None:
    """(b) A shorter run under torch.profiler: idle share, the apply's
    device time against its byte bound, and the host<->device bytes a
    step: the batches only, no parameter or gradient."""

    ds, model, store, _ = _device_store_setup(4, 10, 2)
    with captured() as cap:
        results, wall = _device_store_run(model, store, ds, False)
    events = cap["events"]
    device_us = sum(e.self_device_time_total for e in events)
    applies = store.global_step
    apply_ev = [e for e in events if "multi_tensor_apply_kernel" in e.key]
    apply_us = sum(e.self_device_time_total for e in apply_ev) / applies
    bound_us = APPLY_BYTES / H100_BYTES_PER_S * 1e6
    copies = _memcpy_bytes(cap["trace"])
    steps = sum(r.local_steps_completed for r in results)
    batch_bytes = BATCH * 32 * 32 * 3
    htod = copies.get("HtoD", {}).get("bytes", 0) / steps
    dtoh = copies.get("DtoH", {}).get("bytes", 0) / steps
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    emit({"phase": "device_store", "form": "profile", "steps": steps,
          "applies": applies, "wall_s": wall,
          "device_busy_s": device_us / 1e6,
          "device_idle_share": 1 - device_us / 1e6 / wall,
          "apply_device_us": apply_us,
          "apply_kernel_launches": sum(e.count for e in apply_ev),
          "apply_bound_us": bound_us, "apply_bound_by": "bytes",
          "apply_share_of_bound": bound_us / apply_us if apply_us else None,
          "memcpy": copies, "htod_bytes_per_step": htod,
          "dtoh_bytes_per_step": dtoh, "batch_bytes": batch_bytes,
          "top_device_ms": [[e.key[:120], round(e.self_device_time_total
                                               / 1e3, 3), e.count]
                            for e in top],
          "card": state["card"]})
    if not apply_ev:
        raise AssertionError("no apply kernel in the profile")
    if not batch_bytes <= htod <= batch_bytes + SMALL_COPY_BYTES:
        raise AssertionError(f"{htod} host-to-device bytes a step; the "
                             f"batch is {batch_bytes}")
    if dtoh > SMALL_COPY_BYTES:
        raise AssertionError(f"{dtoh} device-to-host bytes a step")


def _device_store_parity(state: dict) -> None:
    """(c) Real gradients of one step drive two async pushes (the second
    one step stale) and one full sync round of 2 workers, through the
    device store on the card and on the CPU: bit-equal (tolerance 0)."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        DeviceParameterStore, StoreConfig)
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .steps import make_grad_step
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    ds, model, _, init = main_path(1, 10, 5)
    grad_step = make_grad_step(model, augment=False)
    params = {k: torch.from_numpy(v).cuda() for k, v in init.items()}
    _, stats = params_to_jax(model)
    stats = {k: torch.from_numpy(v).cuda() for k, v in stats.items()}
    grads = [grad_step(params, stats, ds.x_train[i:i + BATCH],
                       ds.y_train[i:i + BATCH])[0]
             for i in (0, BATCH)]

    def script(device, gs):
        a = DeviceParameterStore(init, StoreConfig(
            mode="async", total_workers=2, staleness_bound=5),
            device=device)
        a.register_worker()
        a.register_worker()
        out = [a.push(0, gs[0], 0), a.push(1, gs[1], 0)]
        mid, step = a.snapshot()
        r = DeviceParameterStore(mid, StoreConfig(mode="sync",
                                                  total_workers=2),
                                 device=device)
        r.register_worker()
        r.register_worker()
        out += [r.push(0, gs[0], step), r.push(1, gs[1], step)]
        final, fstep = r.snapshot()
        return out + [step, fstep], mid, final

    card = script("cuda", grads)
    cpu = script("cpu", [{k: v.cpu() for k, v in g.items()}
                         for g in grads])
    diffs = {name: max(float(np.max(np.abs(a[k] - b[k]))) for k in a)
             for name, a, b in (("async", card[1], cpu[1]),
                                ("sync_round", card[2], cpu[2]))}
    equal = all(a[k].tobytes() == b[k].tobytes()
                for a, b in ((card[1], cpu[1]), (card[2], cpu[2]))
                for k in a)
    emit({"phase": "device_store", "form": "parity",
          "returns": card[0], "returns_cpu": cpu[0], "bit_equal": equal,
          "max_abs_diff": diffs, "tolerance": 0.0, "card": state["card"]})
    if card[0] != cpu[0] or card[0] != [True, True, True, True, 2, 1]:
        raise AssertionError(f"returns {card[0]} != {cpu[0]}")
    if not equal:
        raise AssertionError(f"card and CPU differ: {diffs}")


def phase_device_store(state: dict) -> None:
    """Phase 16: the device-resident store at full width."""
    _device_store_async(state)
    _device_store_profile(state)
    _device_store_parity(state)


# -- phase 17: checkpoints on the card ---------------------------------------

def _lost_reply(state: dict) -> None:
    """(a) A push the server applied whose reply was lost: a snapshot is
    flushed, the server stopped, and a new one on the same port restored
    with its push-token journal answers the worker's retry as a
    duplicate, at the restored step, its params the snapshot's."""
    import shutil
    import tempfile
    import threading

    from distributed_parameter_server_for_ml_training_tpu_torch.checkpoint \
        import (PeriodicStoreCheckpointer, load_store_record,
                restore_server_state)
    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        PSWorker, StoreConfig, WorkerConfig, make_store)

    # 4 batches for the one worker: 4 pushes.
    ds, model, _, init = main_path(4 // N_WORKERS, 10, 6)

    def store():
        return make_store("device", init, StoreConfig(
            mode="async", total_workers=1, staleness_bound=5),
            device="cuda")
    ckpt_dir = tempfile.mkdtemp(prefix="dps-ckpt-")
    store1 = store()
    svc1 = ParameterService(store1)
    ckpt = PeriodicStoreCheckpointer(store1, ckpt_dir, interval=3600.0,
                                     journal_fn=svc1.journal_snapshot)
    ckpt.start()
    server1, port = serve(store1, port=0, host="127.0.0.1", service=svc1)
    client = RemoteStore(f"127.0.0.1:{port}", rpc_timeout=10.0,
                         rpc_retries=1, rpc_backoff=0.05)
    worker = PSWorker(client, model, ds, WorkerConfig(
        batch_size=BATCH, num_epochs=1, device="cuda", eval_each_epoch=False,
        reconnect_timeout=60.0, reconnect_backoff=0.05))
    killed, restarted = threading.Event(), threading.Event()
    holder: dict = {}

    def restart_after_kill():
        killed.wait(120)
        time.sleep(0.3)
        store2 = store()
        svc2 = ParameterService(store2)
        t_restore = time.perf_counter()
        holder["restored"] = restore_server_state(store2, svc2, ckpt_dir)
        holder["restore_s"] = time.perf_counter() - t_restore
        npz, meta = load_store_record(ckpt_dir)
        holder["npz_bytes"] = meta["npz_size"]
        push_body = svc2.push_gradrients

        def first_push_seen(request, ctx):
            # The new server's first push is the worker's retry: its
            # reply, and the store's step and params as it answers.
            reply = push_body(request, ctx)
            if "retry" not in holder:
                params, step = store2.snapshot()
                holder["retry"] = (unpack_msg(reply)[0], step, all(
                    params[k].tobytes() == npz[k].tobytes() for k in npz))
            return reply
        svc2.push_gradrients = first_push_seen
        server2, bound = serve(store2, port=port, host="127.0.0.1",
                               service=svc2)
        holder.update(server2=server2, store2=store2, bound=bound)
        restarted.set()

    inner_push = client._call["PushGradrients"]

    def push_losing_reply(request, timeout=None):
        push_losing_reply.calls += 1
        if push_losing_reply.calls == 2 and not killed.is_set():
            inner_push(request, timeout=timeout)      # applied ...
            t_flush = time.perf_counter()
            ckpt.stop(final_snapshot=True)            # ... and journaled
            holder["snapshot_s"] = time.perf_counter() - t_flush
            server1.stop(grace=None).wait(10)
            killed.set()                              # the reply is lost
        return inner_push(request, timeout=timeout)

    push_losing_reply.calls = 0
    client._call["PushGradrients"] = push_losing_reply
    t = threading.Thread(target=restart_after_kill, daemon=True)
    t0 = time.perf_counter()
    t.start()
    worker.start()
    worker.join(300)
    t.join(120)
    wall = time.perf_counter() - t0
    try:
        r = worker.result
        store2 = holder.get("store2")
        meta, retry_step, retry_equal = holder.get("retry",
                                                   ({}, None, None))
        emit({"phase": "checkpoints", "form": "lost_reply",
              "error": repr(r.error) if r.error else None,
              "reconnects": r.reconnects,
              "pushes_accepted": r.pushes_accepted,
              "restored": holder.get("restored"),
              "retry_reply": {k: meta.get(k) for k in
                              ("received", "accepted", "duplicate",
                               "global_step")},
              "step_at_retry": retry_step,
              "params_equal_snapshot_npz": retry_equal,
              "new_store_step": store2.global_step if store2 else None,
              "new_store_pushes_applied":
                  store2.stats.gradients_processed if store2 else None,
              "snapshot_s": holder.get("snapshot_s"),
              "snapshot_npz_bytes": holder.get("npz_bytes"),
              "restore_s": holder.get("restore_s"),
              "wall_s": wall, "card": state["card"]})
        if r.error is not None or worker.is_alive():
            raise AssertionError(f"worker failed: {r.error!r}")
        if r.reconnects != 1 or holder.get("bound") != port:
            raise AssertionError("the server was not restarted on its port")
        restored_step, journaled = holder["restored"]
        if (restored_step, meta.get("duplicate"), meta.get("global_step"),
                retry_step, retry_equal) != (2, True, 2, 2, True) \
                or journaled < 1:
            raise AssertionError("the retried push was not answered as a "
                                 "duplicate of the restored state")
        # 4 pushes: 2 in the snapshot, the retried 2nd a duplicate, the
        # 3rd and 4th applied on the new server.
        if (r.pushes_accepted, store2.global_step,
                store2.stats.gradients_processed) != (4, 4, 2):
            raise AssertionError("a push was lost or applied twice")
    finally:
        if "server2" in holder:
            holder["server2"].stop(grace=None).wait(10)
        client.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _graphed_resume(state: dict) -> None:
    """(b) ``BaselineTrainer(device_loop=True)`` with deterministic cuDNN,
    2 epochs of 2,048 images, a checkpoint each epoch: a fresh trainer
    restored from epoch 1 (copied into the tensors its graph replays
    over) trains epoch 2 bit-equal to the uninterrupted run."""
    import shutil
    import tempfile

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.checkpoint \
        import CheckpointManager
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_cifar100
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .baseline import BaselineConfig, BaselineTrainer

    ds = synthetic_cifar100(n_train=2048, n_test=1000)

    def trainer(epochs):
        model = get_model("resnet18", num_classes=100, dtype="bfloat16",
                          device="cuda", seed=7)
        return BaselineTrainer(ds, BaselineConfig(
            batch_size=BATCH, num_epochs=epochs, device_loop=True,
            device="cuda", seed=7), model=model)

    def tensors(st):
        out = [*st.params.values(), *st.batch_stats.values(),
               *st.opt_state.trace.values(), st.opt_state.count]
        return [t.detach().cpu() for t in out]

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    root = tempfile.mkdtemp(prefix="dps-ckpt-")
    t0 = time.perf_counter()
    try:
        full = trainer(2)
        whole = full.train(checkpoint_dir=f"{root}/a")
        trainer(1).train(checkpoint_dir=f"{root}/b")
        resumed = trainer(2)
        again = resumed.train(checkpoint_dir=f"{root}/b", resume=True)
        graphed = resumed._device_loop._cuda_graph is not None
        a, b = tensors(full.state), tensors(resumed.state)
        equal = len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
        diff = max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b))
        # One train-state checkpoint's cost: save, then restore in place.
        mgr = CheckpointManager(f"{root}/c")
        t1 = time.perf_counter()
        mgr.save(resumed.state)
        save_s = time.perf_counter() - t1
        ckpt_bytes = sum(f.stat().st_size for f in Path(root, "c").iterdir())
        t1 = time.perf_counter()
        mgr.restore(resumed.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "checkpoints", "form": "graphed_resume",
          "cudnn_deterministic": True, "steps": full.state.step,
          "resumed_step": resumed.state.step, "graph_replayed": graphed,
          "state_bit_equal": equal, "max_abs_diff": diff,
          "losses": whole.train_losses, "resumed_losses": again.train_losses,
          "checkpoint_save_s": save_s, "checkpoint_bytes": ckpt_bytes,
          "checkpoint_restore_s": restore_s,
          "wall_s": time.perf_counter() - t0, "card": state["card"]})
    if not graphed or not equal or full.state.step != resumed.state.step:
        raise AssertionError(f"the resumed graphed run differs (max "
                             f"{diff})")
    if again.train_losses != whole.train_losses[1:]:
        raise AssertionError(f"epoch 2 loss {again.train_losses} != "
                             f"{whole.train_losses[1:]}")


def phase_checkpoints(state: dict) -> None:
    """Phase 17: checkpoints on the card."""
    _lost_reply(state)
    _graphed_resume(state)


def _health_stack(store, parts: dict, quarantine_s: float = 30.0,
                  evaluate_on_push: bool = False):
    """The port's service over ``store`` wired as ``cli serve --remediate``
    wires it: a ``ClusterMonitor`` with the JAX defaults (5 s tick) and the
    SLO evaluator, a ``RemediationEngine`` that is not a dry run, and
    ``reject_nonfinite`` on. ``parts`` receives the monitor, the engine,
    the service, every alert edge event, the monitor's view as the first
    worker says goodbye (both workers still members), and, with
    ``evaluate_on_push``, each push reply and its time; the monitor then
    also evaluates right after each push (the tick, at the push)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms import \
        ParameterService
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import (ClusterMonitor, RemediationEngine, RemediationPolicy,
                SloEvaluator)

    monitor = ClusterMonitor(store)
    monitor.slo = SloEvaluator()
    # The registry's RPC histograms are process-global and hold earlier
    # phases' calls: the evaluator's baseline is their state now, stamped
    # before both burn windows, as a fresh serve process starts from 0.
    monitor.slo.evaluate(time.time() - monitor.slo.windows[-1].window_s - 1)
    svc = ParameterService(store, monitor=monitor, reject_nonfinite=True)
    engine = RemediationEngine(store, service=svc, policy=RemediationPolicy(
        quarantine_s=quarantine_s))
    monitor.remediation = engine
    monitor.add_listener(engine.handle_events)
    events, views, replies = [], [], []
    monitor.add_listener(events.extend)
    goodbye = svc.job_finished

    def job_finished(request, ctx):
        if not views:
            views.append(monitor.cluster_view())
        return goodbye(request, ctx)
    svc.job_finished = job_finished
    if evaluate_on_push:
        push_body = svc.push_gradrients

        def push(request, ctx):
            wid = int(unpack_msg(request)[0]["worker_id"])
            # The drill lifts a quarantine whose windows the worker has
            # served, so its later pushes apply again.
            if svc.is_quarantined(wid) and any(
                    w.result.worker_id == wid
                    and w.result.pushes_quarantined >= 3
                    for w in parts.get("workers", ())):
                svc.unquarantine(wid)
                parts["drill_unquarantined"] = wid
            reply = push_body(request, ctx)
            replies.append((wid, unpack_msg(reply)[0], time.perf_counter()))
            monitor.evaluate()
            return reply
        svc.push_gradrients = push
    parts.update(monitor=monitor, engine=engine, service=svc,
                 events=events, views=views, replies=replies)
    monitor.start()
    return svc


#: (a): batches of 128 a worker in each monitor off/on turn.
HEALTH_TURN_STEPS = 2


def _health_main(state: dict) -> None:
    """(a) Health on the main path: phase 14 (a)'s run with the monitor,
    the SLO evaluator and the remediation engine; K1 once a push; every
    report's grad norm against the pushed window's norm on the card in
    float64; no alert, directive or quarantine. Then img/s with the
    monitor off and on in turns, and the device->host copies the note
    adds a boundary, from two profiled runs' memcpy events."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
        worker as W

    notes = []
    note = W.PSWorker._note_health

    def note_spy(self, loss, grads, epoch, grad_scale=1.0):
        # Synchronized first, so the time is the note's own, not the
        # step's compute it would otherwise wait for.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        note(self, loss, grads, epoch, grad_scale)
        host_us = (time.perf_counter() - t0) * 1e6
        ref = float(torch.linalg.vector_norm(torch.cat(
            [g.detach().double().flatten() for g in grads.values()]))) \
            * grad_scale
        with self._health_lock:
            notes.append((self.result.worker_id, dict(self._health), ref,
                          host_us))

    parts: dict = {}
    W.PSWorker._note_health = note_spy
    Q.wire_quantize_multi.launches = 0
    try:
        run = _grpc_run(steps_per_worker=8, n_test=1000, seed=0,
                        eval_each_epoch=True, record=True,
                        service=lambda st: _health_stack(st, parts))
    finally:
        W.PSWorker._note_health = note
        if "monitor" in parts:
            parts["monitor"].stop(final=False)
    k1 = Q.wire_quantize_multi.launches
    state["health_k1_launches"] = {"wire_quantize_multi": k1}
    results, svc, engine = run["results"], parts["service"], parts["engine"]
    errors = [repr(r.error) for r in results if r.error is not None]
    n_push = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    view = parts["views"][0] if parts["views"] else {"workers": []}
    rows = {r["worker"]: r for r in view["workers"]}
    ids = sorted(r.worker_id for r in results)
    fired = [(e["rule"], e["worker"]) for e in parts["events"]
             if e["state"] == "fired"]
    # The SLO rules watch the server's RPC latency, not training: a
    # fetch-latency burn is held to the objective's own window numbers
    # (reported); every other rule must stay silent.
    slo = view.get("slo") or {}
    slo_fired = sorted({r for r, _ in fired if r.startswith("slo_burn")})
    slo_backed = sorted({b["rule"] for b in slo.get("breaches", ())
                         if b["objective"] == "fetch_latency"
                         and b["bad"] > 0
                         and b["burn"] >= b["burn_threshold"]})
    health_fired = [(r, w) for r, w in fired if not r.startswith("slo_")]
    rel = [abs(rep["grad_norm"] - ref) / ref for _, rep, ref, _ in notes
           if isinstance(rep.get("grad_norm"), float) and ref > 0]
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    quarantined = sum(bool(unpack_msg(r)[0].get("quarantined"))
                      for _, r in run["pushes"])

    # img/s with the monitor off and on, in turns; eval off.
    turns: dict = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        p: dict = {}
        try:
            r = _grpc_run(steps_per_worker=HEALTH_TURN_STEPS, n_test=10,
                          seed=0,
                          eval_each_epoch=False, record=False,
                          service=(lambda st, p=p: _health_stack(st, p))
                          if label == "on" else None)
        finally:
            if "monitor" in p:
                p["monitor"].stop(final=False)
        turns[label].append(_img_per_s(r["results"]))
    # Device->host copies a boundary: the same short run with the
    # monitor off and on under torch.profiler.
    copies, boundaries = {}, {}
    for label in ("off", "on"):
        p = {}
        torch.cuda.synchronize()
        try:
            with captured() as cap:
                r = _grpc_run(steps_per_worker=4, n_test=10, seed=2,
                              eval_each_epoch=False, record=False,
                              service=(lambda st, p=p: _health_stack(st, p))
                              if label == "on" else None)
        finally:
            if "monitor" in p:
                p["monitor"].stop(final=False)
        copies[label] = _memcpy_bytes(cap["trace"])
        boundaries[label] = sum(x.pushes_accepted + x.pushes_rejected
                                + x.pushes_quarantined
                                for x in r["results"])
    dtoh = {k: v.get("DtoH", {}).get("count", 0) for k, v in copies.items()}
    per_boundary = (dtoh["on"] - dtoh["off"]) / boundaries["on"]
    host_us = [n[3] for n in notes]
    state["health"] = {
        "img_per_s_off": turns["off"], "img_per_s_on": turns["on"],
        "note_host_us_median": float(np.median(host_us)) if host_us
        else None, "dtoh_copies_per_boundary": per_boundary}
    emit({"phase": "health", "form": "main_path", "model": "resnet18",
          "workers": N_WORKERS, "batch_size": BATCH, "push_codec": "int8",
          "pushes": n_push, "k1_launches": k1,
          "register_health_report": [r.supports_health_report
                                     for r in run["remotes"]],
          "reports": {str(k): {f: v.get(f) for f in (
              "step", "epoch", "loss", "grad_norm", "push_codec",
              "examples_per_s", "goodput_fraction")}
              for k, v in sorted(rows.items())},
          "notes": len(notes),
          "grad_norm_rel_err_max": max(rel) if rel else None,
          "note_host_us_median": state["health"]["note_host_us_median"],
          "note_host_us_max": max(host_us) if host_us else None,
          "alerts_fired": fired, "health_rules_fired": health_fired,
          "slo_rules_fired": slo_fired,
          "directives_posted": svc._directive_seq,
          "remediation_events": list(engine.events),
          "quarantined_replies": quarantined,
          "slo": slo,
          "img_per_s_turns_eval_off": turns,
          "phase14_img_per_s": state.get("grpc_a", {}).get("img_per_s"),
          "dtoh_copies": dtoh, "boundaries": boundaries,
          "dtoh_copies_per_boundary": per_boundary,
          "memcpy": copies, "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")
    if not all(r.supports_health_report for r in run["remotes"]):
        raise AssertionError("the register reply did not advertise "
                             "health_report")
    if n_push != N_WORKERS * 8 or k1 != n_push:
        raise AssertionError(f"K1 launched {k1} times for {n_push} pushes; "
                             f"expected {N_WORKERS * 8} of each")
    for wid in ids:
        row = rows.get(wid, {})
        if not all(isinstance(row.get(f), (int, float))
                   for f in ("step", "loss", "grad_norm")) \
                or row.get("push_codec") != "int8+ef":
            raise AssertionError(f"worker {wid}'s row in the cluster view: "
                                 f"{row}")
    if len(notes) != n_push or len(rel) != len(notes) or max(rel) > 1e-4:
        raise AssertionError(f"{len(notes)} notes for {n_push} pushes; "
                             f"grad norm relative error {max(rel or [0])}")
    if health_fired or svc._directive_seq or quarantined or engine.events:
        raise AssertionError(f"a healthy run fired {fired}, posted "
                             f"{svc._directive_seq} directives, refused "
                             f"{quarantined} pushes")
    if not set(slo_fired) <= set(slo_backed):
        raise AssertionError(f"SLO rules fired {slo_fired}; the "
                             f"evaluator's fetch-latency breaches: "
                             f"{slo.get('breaches')}")
    if per_boundary > 1:
        raise AssertionError(f"the health note adds {per_boundary} "
                             f"device->host copies a boundary")


def _health_drill(state: dict) -> None:
    """(b) The self-heal drill: fp16 pushes, worker 1 poisons its 3rd step
    with NaN. Its push is refused before the apply, both non-finite rules
    fire against it alone, the engine quarantines it and posts the
    quarantine and refetch directives, the worker skips 3 windows, and
    once the quarantine is lifted (by the engine when the worker's next
    report resolves the alerts, else by the drill after the windows) its
    pushes apply again."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
        worker as W

    parts: dict = {}
    applied = []
    apply = W.PSWorker._apply_directive

    def apply_spy(self, d):
        applied.append((time.perf_counter(), self.result.worker_id,
                        d.get("action"), dict(d)))
        return apply(self, d)

    def probe(workers, done):
        parts["workers"] = workers

    W.PSWorker._apply_directive = apply_spy
    try:
        run = _grpc_run(
            steps_per_worker=8, n_test=10, seed=1, eval_each_epoch=False,
            record=False, store_kw={"push_codec": "fp16"}, probe=probe,
            worker_kw_of=lambda i: {"nan_inject_step": 2} if i == 1 else {},
            service=lambda st: _health_stack(st, parts,
                                             evaluate_on_push=True))
    finally:
        W.PSWorker._apply_directive = apply
        if "monitor" in parts:
            parts["monitor"].stop(final=False)
    healthy, poisoned = run["workers"]
    hid, pid = healthy.result.worker_id, poisoned.result.worker_id
    store = run["store"]
    errors = [repr(w.result.error) for w in run["workers"]
              if w.result.error is not None]
    q_replies = [(wid, m, t) for wid, m, t in parts["replies"]
                 if m.get("quarantined")]
    fired = [(e["rule"], e["worker"]) for e in parts["events"]
             if e["state"] == "fired"]
    nonfinite = sorted({w for rule, w in fired
                        if rule in ("nonfinite_loss", "nonfinite_grad")})
    actions = [(e["action"], e["worker"], e["outcome"])
               for e in parts["engine"].events]
    final, step = store.snapshot()
    finite = all(np.isfinite(v).all() for v in final.values())
    accepted = healthy.result.pushes_accepted \
        + poisoned.result.pushes_accepted
    t_nan = q_replies[0][2] if q_replies else None
    t_apply = min((t for t, wid, a, _ in applied
                   if wid == pid and a == "quarantine"), default=None)
    seconds = t_apply - t_nan if t_nan and t_apply else None
    state["health_drill_s"] = seconds
    emit({"phase": "health", "form": "self_heal", "push_codec": "fp16",
          "poisoned_worker": pid, "healthy_worker": hid,
          "quarantined_replies": [(w, m) for w, m, _ in q_replies],
          "alerts_fired": fired, "remediation_actions": actions,
          "directives_applied": {
              str(w.result.worker_id): w.result.directives_applied
              for w in run["workers"]},
          "pushes_quarantined": poisoned.result.pushes_quarantined,
          "pushes_accepted": {str(hid): healthy.result.pushes_accepted,
                              str(pid): poisoned.result.pushes_accepted},
          "pushes_rejected": {str(hid): healthy.result.pushes_rejected,
                              str(pid): poisoned.result.pushes_rejected},
          "quarantine_lifted_by": "drill" if parts.get(
              "drill_unquarantined") is not None else "engine" if (
              "quarantine", pid, "lifted") in actions else None,
          "quarantined_at_end": parts["service"].is_quarantined(pid),
          "global_step": step, "params_finite": finite,
          "nan_push_to_directive_applied_s": seconds,
          "card": state["card"]})
    if errors:
        raise AssertionError(f"worker errors: {errors}")
    if len(q_replies) != 1 or q_replies[0][0] != pid \
            or q_replies[0][1].get("accepted") is not False:
        raise AssertionError(f"quarantined replies: {q_replies}")
    if nonfinite != [pid] or {r for r, w in fired if w == pid} \
            < {"nonfinite_loss", "nonfinite_grad"}:
        raise AssertionError(f"alerts fired: {fired}")
    if ("quarantine", pid, "ok") not in actions \
            or ("refetch", pid, "ok") not in actions:
        raise AssertionError(f"remediation actions: {actions}")
    if poisoned.result.directives_applied != {"quarantine": 1,
                                              "refetch_params": 1} \
            or poisoned.result.pushes_quarantined != 3 \
            or any(d.get("steps") != 3 for _, wid, a, d in applied
                   if a == "quarantine"):
        raise AssertionError(f"worker {pid} applied "
                             f"{poisoned.result.directives_applied}, "
                             f"skipped {poisoned.result.pushes_quarantined}")
    if healthy.result.pushes_accepted != 8 \
            or poisoned.result.pushes_accepted != 8 - 1 - 3:
        raise AssertionError("pushes accepted: "
                             f"{healthy.result.pushes_accepted} and "
                             f"{poisoned.result.pushes_accepted}")
    if step != accepted or not finite:
        raise AssertionError(f"step {step} for {accepted} accepted pushes; "
                             f"params finite: {finite}")


def _health_carry(state: dict) -> None:
    """(c) The quarantine directive drops the device codec's carry: one
    int8 worker with error feedback; after its 2nd push the drill posts
    ``quarantine`` with steps=2. The next 2 windows push nothing (K1 runs
    once a push sent), the residuals are empty right after the directive,
    and the first push after it is byte-equal to ``compress_push`` of its
    gradients under a fresh ``ErrorFeedback``."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .wire import encode_tensor_dict
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .compression import ErrorFeedback, compress_push
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, PSWorker, StoreConfig, WorkerConfig)
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import \
        worker as W

    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # 768 images: 6 batches for the one worker.
    ds, model, _, init = main_path(3, 10, 4)
    store = ParameterStore(init, StoreConfig(
        mode="async", total_workers=1, push_codec="int8", staleness_bound=5))
    svc = ParameterService(store)
    frames, encoded, residuals = [], [], []
    push_body = svc.push_gradrients

    def push(request, ctx):
        meta, payload = unpack_msg(request)
        frames.append(bytes(payload))
        reply = push_body(request, ctx)
        if len(frames) == 2:
            svc.post_directive(int(meta["worker_id"]), "quarantine",
                               steps=2)
        return reply
    svc.push_gradrients = push
    encode = DeviceCodec.encode

    def encode_spy(self, flat, plan=None, scales=None):
        encoded.append(({k: v.detach().float().cpu().numpy()
                         for k, v in flat.items()},
                        dict(plan or {}), dict(scales or {})))
        return encode(self, flat, plan=plan, scales=scales)
    apply = W.PSWorker._apply_directive

    def apply_spy(self, d):
        before = len(self._device_codec._residual)
        apply(self, d)
        residuals.append((d.get("action"), before,
                          len(self._device_codec._residual)))
    DeviceCodec.encode, W.PSWorker._apply_directive = encode_spy, apply_spy
    server, port = serve(store, port=0, service=svc, host="127.0.0.1")
    remote = RemoteStore(f"127.0.0.1:{port}")
    Q.wire_quantize_multi.launches = 0
    try:
        worker = PSWorker(remote, model, ds, WorkerConfig(
            batch_size=BATCH, num_epochs=1, device="cuda",
            eval_each_epoch=False), worker_name="carry")
        worker.run()
        k1 = Q.wire_quantize_multi.launches
    finally:
        DeviceCodec.encode, W.PSWorker._apply_directive = encode, apply
        remote.close()
        server.stop(grace=None).wait(10)
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev
    res = worker.result
    checks = {}
    if len(encoded) == len(frames) == 4:
        def frame(grads, plan, scales, ef):
            return encode_tensor_dict(compress_push(
                grads, plan, scales=scales or None, ef=ef), checksum=True)
        checks["after_quarantine_equals_fresh_ef"] = \
            frames[2] == frame(*encoded[2], ErrorFeedback())
        carried = ErrorFeedback()
        for g in encoded[:2]:
            frame(*g, carried)
        checks["carried_ef_frame_differs"] = \
            frames[2] != frame(*encoded[2], carried)
        checks["first_push_equals_fresh_ef"] = \
            frames[0] == frame(*encoded[0], ErrorFeedback())
    emit({"phase": "health", "form": "carry_reset", "push_codec": "int8",
          "cudnn_deterministic": True, "steps": res.local_steps_completed,
          "pushes_sent": len(frames), "k1_launches": k1,
          "pushes_quarantined": res.pushes_quarantined,
          "directives_applied": res.directives_applied,
          "residual_tensors_before_after": residuals, "frame_checks": checks,
          "card": state["card"]})
    if res.error is not None:
        raise res.error
    if len(frames) != 4 or res.pushes_quarantined != 2 or k1 != 4:
        raise AssertionError(f"{len(frames)} pushes sent, "
                             f"{res.pushes_quarantined} skipped, K1 {k1}; "
                             f"expected 4, 2 and 4")
    if len(residuals) != 1 or residuals[0][0] != "quarantine" \
            or residuals[0][1] == 0 or residuals[0][2] != 0:
        raise AssertionError(f"residuals around the directive: {residuals}")
    if not checks or not all(checks.values()):
        raise AssertionError(f"frame checks: {checks}")


def phase_health(state: dict) -> None:
    """Phase 18: the cluster health monitor, the non-finite guard,
    quarantine and the directive loop on the main path."""
    _health_main(state)
    _health_drill(state)
    _health_carry(state)


# -- phase 19: every registry model under the data-parallel modes ------------

MODELS_TRAIN, MODELS_TEST = 512, 256     # synthetic ImageNet, 224 px
MODELS_PROFILE_STEPS = 2                 # of an epoch of the baseline's 4
R50_VALUES, VIT_VALUES = 25_557_032, 86_567_656


def _device_ms_per_launch(fn, reps: int, kernel: str) -> dict:
    """:func:`device_ms_per_call` of one launch, beside the launches the
    trace recorded a call."""
    ms, launches = device_ms_per_call(fn, reps, kernel)
    return {"device_ms_per_launch": ms,
            "profiled_launches_per_call": launches}


def _subset(ds, n_train: int, n_test: int):
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import Dataset

    return Dataset(ds.x_train[:n_train], ds.y_train[:n_train],
                   ds.x_test[:n_test], ds.y_test[:n_test],
                   num_classes=ds.num_classes, synthetic=True)


def _models_baseline(state: dict, ds, out: dict, failures: list) -> None:
    """(a) ResNet-50 through ``BaselineTrainer``, 2 epochs eager and 2
    graphed (4 steps each), each profiled over 2 steps; one
    step
    card against CPU in float64 at batch 2; ResNet-18 with the ImageNet
    stem for 4 eager steps."""
    import itertools

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import make_batches
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .baseline import BaselineConfig, BaselineTrainer
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .device_loop import prefetch_to_device

    bs = BATCH
    steps = len(ds.x_train) // bs
    paths = {}
    for name, device_loop in (("eager", False), ("graph", True)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = BaselineTrainer(ds, BaselineConfig(
            model="resnet50", num_classes=1000, num_epochs=2,
            device_loop=device_loop, device="cuda"))
        if not trainer.model.imagenet_stem:
            failures.append("(a) ResNet-50 at 224 px without the ImageNet "
                            "stem")
        met = trainer.train()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if device_loop:
            loop = trainer._device_loop

            def step_fn(loop=loop):
                loop._cuda_graph.replay()
            loop._slot.zero_()
        else:
            batches = itertools.cycle(list(prefetch_to_device(make_batches(
                ds.x_train, ds.y_train, bs, seed=12345), depth=2)))
            for _ in range(2):     # the profile starts with warm steps
                trainer._train_step(trainer.state, *next(batches),
                                    trainer._gen)

            def step_fn(trainer=trainer, batches=batches):
                trainer._train_step(trainer.state, *next(batches),
                                    trainer._gen)
        prof = _profile_steps(step_fn, MODELS_PROFILE_STEPS)
        paths[name] = {
            "epoch_seconds": met.epoch_times,
            "train_seconds": trainer.train_seconds,
            "img_per_s_epoch2": steps * bs / trainer.train_seconds[-1],
            "step_ms": prof["ms_per_step_by_events"],
            "device_idle_share": prof["device_idle_share"],
            "train_loss": met.train_losses,
            "test_accuracy_pct": met.test_accuracies,
            "peak_memory_gib": peak, "profile": prof}
        if not all(math.isfinite(v) for v in met.train_losses):
            failures.append(f"(a) {name}: losses {met.train_losses}")
        del trainer, step_fn
    out["a_baseline_resnet50"] = {"batch_size": bs, "steps_per_epoch": steps,
                                  "dtype": "bfloat16", **paths}

    # One step, augment off, card against CPU from the same weights in
    # float64 (phase 9 (a)'s check at ResNet-50's shapes).
    xb, yb = ds.x_train[:2], ds.y_train[:2]
    runs = {}
    for device in ("cuda", "cpu"):
        model, st, step, _ = _baseline_parts(
            torch.float64, device, (10, 15), steps, False, name="resnet50",
            num_classes=1000, image_size=224)
        if runs:
            model.load_state_dict(weights)
        else:
            weights = {k: v.cpu() for k, v in model.state_dict().items()}
        _, m = step(st, xb, yb)
        runs[device] = (st, float(m["loss"]))
        del model
    diff = _state_diff(runs["cuda"][0], runs["cpu"][0])
    out["a_card_vs_cpu_float64"] = {
        "batch_size": 2, "tolerance": "atol 1e-5, rtol 1e-3", **diff,
        "losses": {d: loss for d, (_, loss) in runs.items()}}
    bad = [p for p, v in diff.items() if v["outside"]]
    if bad:
        failures.append(f"(a) card against CPU in float64 outside atol "
                        f"1e-5 / rtol 1e-3: {bad}")
    del runs, weights

    # ResNet-18 with the ImageNet stem: 4 eager steps.
    model, st, step, _ = _baseline_parts(
        "bfloat16", "cuda", (10, 15), steps, True, name="resnet18",
        num_classes=1000, image_size=224)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses, times = [], []
    for i in range(4):
        xb = torch.as_tensor(ds.x_train[i * bs:(i + 1) * bs], device="cuda")
        yb = torch.as_tensor(ds.y_train[i * bs:(i + 1) * bs], device="cuda")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st, m = step(st, xb, yb, gen)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
    out["a_resnet18_imagenet_stem"] = {
        "imagenet_stem": model.imagenet_stem,
        "stem_kernel": list(model.stem_conv.kernel_size), "losses": losses,
        "step_ms": times}
    if not (model.imagenet_stem and all(map(math.isfinite, losses))):
        failures.append(f"(a) ResNet-18 ImageNet stem: "
                        f"{out['a_resnet18_imagenet_stem']}")
    del model, st, step


def _ring_rows_vs_plain(state: dict, model, params, stats, bi, bl) -> dict:
    """One step's real per-slot gradient rows at the ring's first hop
    (each slot's own chunk): K3 and K4 against their plain versions on
    the card, bit for bit, and their device times against their bounds at
    this chunk."""
    import torch
    import torch.nn.functional as F

    from distributed_parameter_server_for_ml_training_tpu_torch.data.cifar \
        import standardize, to_float
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .sync_dp import make_slot_grad_fn, mix_seed, ravel_slots

    grads, *_ = make_slot_grad_fn(model)(params, stats,
                                         standardize(to_float(bi)),
                                         bl.long())
    flat, _ = ravel_slots(grads)
    del grads
    n, size = flat.shape
    chunk = -(-size // n)
    slots = torch.arange(n, device=flat.device)
    x = F.pad(flat, (0, n * chunk - size)).view(n, n, chunk)[slots, slots]
    del flat
    seeds = [mix_seed(0x5EED, s, 0) for s in range(n)]
    v, sc = Q.block_quantize_stochastic(x, seeds)
    pv, psc = Q.quantize_int8_plain(x, seeds, stochastic=True)
    back = Q.block_dequantize(v, sc, chunk)
    pback = Q.dequantize_int8_plain(v, sc, chunk)
    torch.cuda.synchronize()
    k3_equal = torch.equal(v, pv) and torch.equal(sc, psc)
    k4_equal = torch.equal(back, pback)
    del pv, psc, pback
    sass = state.get("block_sass") or {
        "block_quantize_stochastic": sass_pipe_counts(
            "block_quantize_kernelILb1E")}
    fns = {"block_quantize_stochastic": (
        lambda: Q.block_quantize_stochastic(x, seeds),
        lambda: Q.quantize_int8_plain(x, seeds, stochastic=True),
        "::block_quantize_kernel"),
        "block_dequantize": (lambda: Q.block_dequantize(v, sc, chunk),
                             lambda: Q.dequantize_int8_plain(v, sc, chunk),
                             "::block_dequantize_kernel")}
    kernels = {}
    for kernel, (fk, fp, sym) in fns.items():
        bound_ms, bound_by, parts = block_bound(n, chunk, kernel,
                                                sass.get(kernel))
        prof = _device_ms_per_launch(fk, 50, sym)
        kernels[kernel] = {
            "device_ms": prof["device_ms_per_launch"], **prof,
            "ms": cuda_time_ms(fk, 20), "plain_ms": cuda_time_ms(fp, 3),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_parts": parts}
    return {"rows": [n, chunk], "k3_bit_equal": k3_equal,
            "k4_bit_equal": k4_equal, "kernels": kernels}


def _models_sync(state: dict, ds, name: str, slots: int, batch: int,
                 compression: str, epochs: int) -> dict:
    """``SyncTrainer`` on ``name`` at 224 px, 1,000 classes, bf16: counts
    reset just before ``train()`` and read just after; the step's time by
    CUDA events; with int8 the ring's kernels on real rows against their
    plain versions."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import shard_batch
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .sync_dp import ring_payload_bytes
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .distributed import DistributedConfig, SyncTrainer

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = SyncTrainer(ds, DistributedConfig(
        mode="sync", model=name, num_workers=slots, batch_size=batch,
        num_epochs=epochs, compression=compression, num_classes=1000,
        dtype="bfloat16", device="cuda"))
    init = {k: v.clone() for k, v in trainer.state.params.items()}
    size = sum(v.numel() for v in init.values())
    torch.cuda.synchronize()
    _reset_block_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _block_counts()
    steps = trainer.global_steps
    moved = sum(not torch.equal(init[k], v)
                for k, v in trainer.state.params.items())
    del init
    finite = all(math.isfinite(v) for v in trainer.train_loss_per_epoch)
    images = steps * slots * batch
    bi, bl = shard_batch(trainer.mesh, (ds.x_train[:slots * batch],
                                        ds.y_train[:slots * batch]))
    st = trainer.state
    times = []
    for i in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st, _ = trainer._step(st, bi, bl, 1)
        b.record()
        torch.cuda.synchronize()
        if i >= 2:
            times.append(a.elapsed_time(b))
    del st
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    chunk = -(-size // slots)
    res = {"model": name, "slots": slots, "batch_per_slot": batch,
           "compression": compression, "params": size, "steps": steps,
           "images": images, "launches": counts,
           "img_per_s": images / sum(trainer.train_seconds),
           "train_seconds": trainer.train_seconds, "run_seconds": wall,
           "step_ms_median": float(np.median(times)), "step_ms_runs": times,
           "train_loss_per_epoch": trainer.train_loss_per_epoch,
           "tensors_moved": moved, "peak_memory_gib": peak,
           "ring_replicas_identical": trainer.ring_replicas_identical,
           "wire_bytes_per_slot_per_step": trainer.wire_bytes_per_slot_step,
           "ring_payload_bytes": ring_payload_bytes(chunk), "chunk": chunk}
    if compression == "int8":
        res["ring_rows_vs_plain"] = _ring_rows_vs_plain(
            state, trainer.model, trainer.state.params,
            trainer.state.batch_stats, bi, bl)
    del trainer, bi, bl
    torch.cuda.empty_cache()
    problems = []
    want = {"block_quantize": 0,
            "block_quantize_stochastic": slots * steps,
            "block_dequantize": (2 * slots - 1) * steps} \
        if compression == "int8" else {k: 0 for k in counts}
    if counts != want:
        problems.append(f"{steps} steps launched {counts}; expected {want}")
    if not finite or moved == 0:
        problems.append(f"losses {res['train_loss_per_epoch']}, tensors "
                        f"moved {moved}")
    if compression == "int8":
        ring = res["ring_rows_vs_plain"]
        if res["wire_bytes_per_slot_per_step"] != \
                2 * (slots - 1) * res["ring_payload_bytes"]:
            problems.append(f"wire bytes {res['wire_bytes_per_slot_per_step']}"
                            f" a slot a step; expected {2 * (slots - 1)} x "
                            f"{res['ring_payload_bytes']}")
        if res["ring_replicas_identical"] is not True:
            problems.append("the ring's per-slot results differ")
        if not (ring["k3_bit_equal"] and ring["k4_bit_equal"]):
            problems.append(f"K3/K4 against their plain versions at "
                            f"{ring['rows']}: K3 {ring['k3_bit_equal']}, "
                            f"K4 {ring['k4_bit_equal']}")
    res["problems"] = problems
    return res


def _models_async(state: dict, ds, name: str, batch: int,
                  pushes_per_worker: int) -> dict:
    """``AsyncTrainer`` on ``name`` (2 workers) over a store with int8
    pushes: K1's count reset just before ``train()`` and read just after;
    the first push K1 quantized, against its plain version byte for
    byte, and its device time against the byte bound."""
    import threading

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        device_codec as DC, quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        StoreConfig, make_store)
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .distributed import AsyncTrainer, DistributedConfig

    workers = N_WORKERS
    sub = _subset(ds, workers * batch * pushes_per_worker, 64)
    trainer = AsyncTrainer(sub, DistributedConfig(
        mode="async", model=name, num_workers=workers, batch_size=batch,
        num_epochs=1, num_classes=1000, dtype="bfloat16", device="cuda"))
    init, _ = trainer.store.snapshot()
    # The trainer's store with the int8 push codec (phase 5's store).
    trainer.store = make_store("python", init, StoreConfig(
        mode="async", total_workers=workers, push_codec="int8",
        staleness_bound=5))
    rec, lock = {}, threading.Lock()
    kernel = DC.wire_quantize_multi

    def spy(xs, scales, levels):
        out = kernel(xs, scales, levels)
        with lock:
            if "xs" not in rec:
                rec.update(xs=[x.detach().clone() for x in xs],
                           scales=list(scales), levels=list(levels),
                           codes=out[0].clone())
        return out
    DC.wire_quantize_multi = spy
    Q.wire_quantize_multi.launches = 0
    try:
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        DC.wire_quantize_multi = kernel
    launches = Q.wire_quantize_multi.launches
    results = trainer.results
    pushes = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    errors = [repr(r.error) for r in results if r.error is not None]
    final, step = trainer.store.snapshot()
    moved = sum(not np.array_equal(final[k], init[k]) for k in init)
    images = sum(r.local_steps_completed for r in results) * batch
    train_s = max(sum(r.epoch_times) for r in results)
    values = sum(x.numel() for x in rec.get("xs", []))
    res = {"model": name, "workers": workers, "batch_size": batch,
           "push_codec": "int8", "pushes": pushes, "global_step": step,
           "tensors": len(init), "k1_launches": launches,
           "k1_launches_per_push": launches / max(pushes, 1),
           "images": images, "img_per_s": images / train_s,
           "train_seconds": train_s, "run_seconds": wall,
           "tensors_moved": moved, "pushed_values": values,
           "train_loss_per_epoch": [v for r in results
                                    for v in r.train_loss_per_epoch]}
    problems = []
    if errors:
        problems.append(f"worker errors: {errors}")
    want = -(-len(init) // Q.WIRE_MAX_ENTRIES) * pushes
    if pushes != workers * pushes_per_worker or launches != want:
        problems.append(f"K1 launched {launches} times for {pushes} pushes; "
                        f"expected {want} for "
                        f"{workers * pushes_per_worker}")
    if moved == 0:
        problems.append("the store's params did not move")
    if rec:
        xs, scales, levels = rec["xs"], rec["scales"], rec["levels"]
        plain = Q.wire_quantize_multi_plain(xs, scales, levels)[0]
        res["first_push_equal_plain"] = torch.equal(rec["codes"], plain)
        before = Q.wire_quantize_multi.launches
        Q.wire_quantize_multi(xs, scales, levels)
        per_call = Q.wire_quantize_multi.launches - before
        # The trace's mean a launch times the wrapper's own launches a
        # push.
        prof = _device_ms_per_launch(
            lambda: Q.wire_quantize_multi(xs, scales, levels), 20,
            "::wire_quantize_multi_kernel")
        per_launch = prof["device_ms_per_launch"]
        bound = (4 * values + values) / H100_BYTES_PER_S * 1e3
        res["k1_push"] = {
            "entries": len(xs), "values": values,
            "device_ms": None if per_launch is None
            else per_launch * per_call, **prof,
            "launches_per_call": per_call,
            "ms": cuda_time_ms(lambda: Q.wire_quantize_multi(
                xs, scales, levels), 20),
            "plain_ms": cuda_time_ms(lambda: Q.wire_quantize_multi_plain(
                xs, scales, levels), 3),
            "bound_ms": bound, "bound_by": "bytes",
            "max_abs_err": int((rec["codes"].int() - plain.int()).abs().max())}
        if not res["first_push_equal_plain"] or per_call != -(
                -len(xs) // Q.WIRE_MAX_ENTRIES):
            problems.append(f"a push through K1: equal to plain "
                            f"{res['first_push_equal_plain']}, launches "
                            f"{per_call}")
        del plain
    else:
        problems.append("no push went through K1")
    del trainer, rec
    torch.cuda.empty_cache()
    res["problems"] = problems
    return res


def _models_grpc(state: dict, ds) -> dict:
    """(e) ``serve()`` on 127.0.0.1 and 2 ``PSWorker`` threads through
    their own ``RemoteStore``s, ResNet-50 with int8 pushes, 2 pushes a
    worker, eval off."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig)
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    batch, per_worker = 64, 2
    model = get_model("resnet50", num_classes=1000, dtype="bfloat16",
                      image_size=224, device="cuda", seed=0)
    init, _ = params_to_jax(model)
    store = ParameterStore(init, StoreConfig(
        mode="async", total_workers=N_WORKERS, push_codec="int8",
        staleness_bound=5))
    sub = _subset(ds, N_WORKERS * batch * per_worker, 64)
    Q.wire_quantize_multi.launches = 0
    run = _grpc_run(steps_per_worker=per_worker, n_test=0, seed=0,
                    eval_each_epoch=False, record=True,
                    parts=(sub, model, store, init), batch=batch)
    launches = Q.wire_quantize_multi.launches
    results = run["results"]
    errors = [repr(r.error) for r in results if r.error is not None]
    n_push = sum(r.pushes_accepted + r.pushes_rejected for r in results)
    final, step = store.snapshot()
    moved = sum(not np.array_equal(final[k], init[k]) for k in init)
    replies = [unpack_msg(reply)[0] for _, reply in run["pushes"]]
    duplicates = sum(bool(m.get("duplicate")) for m in replies)
    fetch_meta = [unpack_msg(r)[0] for _, r in run["fetches"]]
    full = [len(r) for (_, r), m in zip(run["fetches"], fetch_meta)
            if not m.get("not_modified")]
    images = sum(r.local_steps_completed for r in results) * batch
    train_s = max(sum(r.epoch_times) for r in results)
    res = {"model": "resnet50", "workers": N_WORKERS, "batch_size": batch,
           "push_codec": "int8", "global_step": step, "pushes": n_push,
           "k1_launches": launches, "duplicates": duplicates,
           "tensors_moved": moved, "images": images,
           "img_per_s": images / train_s, "train_seconds": train_s,
           "run_seconds": run["wall"],
           "rpc_ms_median": {k: float(np.median(v))
                             for k, v in sorted(run["rpc_ms"].items())},
           "rpc_calls": {k: len(v) for k, v in sorted(run["rpc_ms"].items())},
           "push_request_bytes": sorted(set(len(q)
                                            for q, _ in run["pushes"])),
           "fetch_reply_bytes_full": sorted(set(full)),
           "fetches_full": len(full)}
    problems = []
    if errors:
        problems.append(f"worker errors: {errors}")
    want = -(-len(init) // Q.WIRE_MAX_ENTRIES) * n_push
    if n_push != N_WORKERS * per_worker or launches != want:
        problems.append(f"K1 launched {launches} times for {n_push} pushes; "
                        f"expected {want}")
    if duplicates or moved == 0:
        problems.append(f"{duplicates} duplicates, {moved} tensors moved")
    res["problems"] = problems
    del run, model, store
    return res


def phase_models(state: dict) -> None:
    """Phase 19: ResNet-50 with the ImageNet stem and ViT-B/16 at 224 px
    (1,000 classes, bf16) on synthetic ImageNet (512 training images):
    (a) the baseline, (b) sync int8 ResNet-50, (c) async int8 pushes of
    ResNet-50, (d) ViT-B/16 sync (bf16 and int8) and async, with the
    flash kernels' counts at 0 (197 tokens take the dense core), (e) the
    gRPC path with ResNet-50. The counts each sub-phase's checks read are
    reset just before its run and read just after."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_imagenet

    t0 = time.perf_counter()
    ds = synthetic_imagenet(n_train=MODELS_TRAIN, n_test=MODELS_TEST,
                            num_classes=1000, image_size=224, seed=0)
    out = {"phase": "models", "dataset": f"synthetic_imagenet("
           f"{MODELS_TRAIN}, {MODELS_TEST}, 1000 classes, 224 px)",
           "data_seconds": time.perf_counter() - t0, "card": state["card"]}
    failures: list = []
    timings = {}

    def sub(key, fn):
        t = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — reported, fails the phase
            traceback.print_exc()
            failures.append(f"({key}) raised {e!r}")
        timings[key] = time.perf_counter() - t
        torch.cuda.empty_cache()

    sub("a", lambda: _models_baseline(state, ds, out, failures))

    def sync_r50():
        out["b_sync_resnet50"] = res = _models_sync(
            state, ds, "resnet50", 4, 64, "int8", epochs=2)
        failures.extend(f"(b) {p}" for p in res["problems"])
    sub("b", sync_r50)

    def async_r50():
        out["c_async_resnet50"] = res = _models_async(
            state, ds, "resnet50", 64, 4)
        failures.extend(f"(c) {p}" for p in res["problems"])
    sub("c", async_r50)

    def vit():
        _reset_flash_counts()
        small = _subset(ds, 4 * 32 * 4, 64)
        for comp in ("bf16", "int8"):
            res = _models_sync(state, small, "vit_b16", 4, 32, comp,
                               epochs=1)
            out[f"d_sync_vit_b16_{comp}"] = res
            failures.extend(f"(d) sync {comp}: {p}"
                            for p in res["problems"])
        res = _models_async(state, ds, "vit_b16", 32, 2)
        out["d_async_vit_b16"] = res
        failures.extend(f"(d) async: {p}" for p in res["problems"])
        flash = _flash_counts()
        out["d_flash_launches"] = flash
        if any(flash.values()):
            failures.append(f"(d) flash kernels launched at 197 tokens: "
                            f"{flash}")
    sub("d", vit)

    def grpc():
        out["e_grpc_resnet50"] = res = _models_grpc(state, ds)
        failures.extend(f"(e) {p}" for p in res["problems"])
    sub("e", grpc)

    out["sub_phase_seconds"] = timings
    # The launches of the path's runs, for the kernels line.
    state["models_k1_launches"] = sum(
        out.get(k, {}).get("k1_launches", 0) for k in (
            "c_async_resnet50", "d_async_vit_b16", "e_grpc_resnet50"))
    state["models_block_counts"] = {
        name: sum(out.get(k, {}).get("launches", {}).get(name, 0) for k in (
            "b_sync_resnet50", "d_sync_vit_b16_bf16", "d_sync_vit_b16_int8"))
        for name in ("block_quantize", "block_quantize_stochastic",
                     "block_dequantize")}
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


# -- the perf observatory and the process surfaces (phase 20) -----------------

OBS_STEPS = 6            # (a): steps in each capture, within an epoch of 8
OBS_SERVE_STEPS = 8      # (b): batches of 128 a worker in a serve session
# (b): batches of 128 a worker in each surfaces off/on turn: at ~450 img/s
# a turn's epoch lasts ~4.5 s, about one of the monitor's 5 s ticks and
# memory samples.
OBS_TURN_STEPS = 8
OBS_TURNS = (False, True, True, False)   # surfaces on?
OBS_OVERHEAD_BOUND = 0.10   # the prediction: on within +-10 % of off


class _Tee:
    """A text stream that keeps what it is given and, with ``echo``, also
    passes it on: the ports ``cli serve`` prints on stderr are read from
    it, and the snapshot lines of its stdout kept off this script's."""

    def __init__(self, echo=None):
        import threading
        self.echo, self.parts, self._lock = echo, [], threading.Lock()

    def write(self, text: str) -> int:
        with self._lock:
            self.parts.append(text)
        if self.echo is not None:
            self.echo.write(text)
        return len(text)

    def flush(self) -> None:
        if self.echo is not None:
            self.echo.flush()

    def text(self) -> str:
        with self._lock:
            return "".join(self.parts)


def _cli_json(argv: list) -> dict:
    """``cli.main(argv)`` with stdout kept: rc and the printed JSON."""
    import contextlib
    import io

    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return {"rc": rc, "out": json.loads(buf.getvalue()) if rc == 0 else None}


def _observe_profile(state: dict) -> None:
    """(a) ``cli train --mode baseline --profile-dir`` (ResNet-18, batch
    128, bf16) and ``cli perf profile`` on it; then the eager step and
    the graphed step each captured over the same steps, timed by CUDA
    events; ``step_cost`` and MFU of both; ``cli perf diff`` between
    them."""
    import contextlib
    import os
    import shutil
    import tempfile

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.analysis \
        import load_chrome_trace, top_device_ops
    from distributed_parameter_server_for_ml_training_tpu_torch.data import \
        make_batches, synthetic_cifar100
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        .profiler import capture, find_profile_dumps, mfu, prune_capture, \
        step_cost
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .baseline import BaselineConfig, BaselineTrainer
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .device_loop import prefetch_to_device

    kind = torch.cuda.get_device_name(0)
    root = tempfile.mkdtemp(prefix="observe-")
    failures, out = [], {"phase": "observability", "form": "a_profile",
                         "card": state["card"], "device_kind": kind}
    try:
        # The CLI run: 4 steps and one eval batch, captured whole.
        cli_dir, dumps = os.path.join(root, "cli"), os.path.join(root, "t")
        os.makedirs(dumps)
        t0 = time.perf_counter()
        rc = cli.main(["train", "--mode", "baseline", "--model", "resnet18",
                       "--batch-size", str(BATCH), "--dtype", "bfloat16",
                       "--synthetic", "--num-train", str(4 * BATCH),
                       "--num-test", str(BATCH), "--epochs", "1",
                       "--profile-dir", cli_dir])
        train_s = time.perf_counter() - t0
        (dump,) = find_profile_dumps(cli_dir)
        trace_bytes = os.path.getsize(dump)
        top = top_device_ops(load_chrome_trace(dump), 10)
        rep = _cli_json(["perf", "profile", "--profile-dir", cli_dir,
                         "--trace-dump-dir", dumps, "--json"])
        prof = rep["out"]["profile"] if rep["out"] else {}
        out["cli"] = {"rc": rc, "perf_rc": rep["rc"], "train_s": train_s,
                      "trace_bytes": trace_bytes,
                      "pruned": not find_profile_dumps(cli_dir),
                      "profile": prof,
                      "top_kernels": [[r["name"][:150], r["class"],
                                       r["time_s"], r["events"]]
                                      for r in top]}
        fractions = sum(r["fraction"] for r in
                        prof.get("op_classes", {}).values())
        if rc != 0 or rep["rc"] != 0 or prof.get("basis") != "device_lanes" \
                or abs(fractions - 1.0) > 1e-3 \
                or prof["op_classes"].get("conv", {}).get("time_s", 0) <= 0:
            failures.append(f"cli capture: rc {rc}/{rep['rc']}, {prof}")

        # The same steps in this process: eager, then graphed.
        ds = synthetic_cifar100(8 * BATCH, BATCH, 100, seed=0)
        eager = BaselineTrainer(ds, BaselineConfig(num_epochs=1,
                                                   device="cuda"))
        batches = list(prefetch_to_device(make_batches(
            ds.x_train, ds.y_train, BATCH, seed=1), depth=2))
        for xb, yb in batches[:2]:
            eager.state, _ = eager._train_step(eager.state, xb, yb,
                                               eager._gen)
        cost = step_cost(eager._train_step, eager.state, *batches[2],
                         eager._gen)
        graph = BaselineTrainer(ds, BaselineConfig(num_epochs=1,
                                                   device="cuda",
                                                   device_loop=True))
        graph.train()
        loop = graph._device_loop
        def timed(step, logdir=None) -> float:
            """CUDA-event ms of OBS_STEPS steps, under a capture into
            ``logdir`` when one is given."""
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            with capture(logdir) if logdir else contextlib.nullcontext():
                a.record()
                for k in range(OBS_STEPS):
                    step(k)
                b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b)

        runs = {}
        for name in ("eager", "graph"):
            if name == "graph":
                def step(k):
                    if k == 0:
                        loop._slot.zero_()
                    loop._cuda_graph.replay()
            else:
                def step(k):
                    eager.state, _ = eager._train_step(
                        eager.state, *batches[k], eager._gen)
            # MFU at the rate of a run without the profiler; the
            # attribution from a captured run of the same steps.
            ms = timed(step)
            logdir = os.path.join(root, name)
            profiled_ms = timed(step, logdir)
            art = os.path.join(root, f"{name}.json")
            rep = _cli_json(["perf", "profile", "--profile-dir", logdir,
                             "--json", "--out", art])
            prof = rep["out"]["profile"] if rep["out"] else {}
            steps_per_s = OBS_STEPS / (ms / 1e3)
            runs[name] = {"perf_rc": rep["rc"], "events_ms": ms,
                          "profiled_events_ms": profiled_ms,
                          "steps_per_s": steps_per_s,
                          "img_per_s": steps_per_s * BATCH,
                          "attributed_s": prof.get("total_attributed_s"),
                          "basis": prof.get("basis"),
                          "op_classes": prof.get("op_classes"),
                          "mfu": mfu(cost["flops"], steps_per_s, kind),
                          "artifact": art}
            if rep["rc"] != 0 or prof.get("basis") != "device_lanes":
                failures.append(f"{name} capture: {runs[name]}")
        # The graph replays back to back: its CUDA-event time is the
        # steps' device time. Both captures must attribute it (the eager
        # step runs the same kernels, its host issue between them).
        device_s = runs["graph"]["profiled_events_ms"] / 1e3
        for name, run in runs.items():
            run["attributed_over_graph_events"] = \
                (run["attributed_s"] or 0.0) / device_s
            if abs(run["attributed_over_graph_events"] - 1.0) > 0.15:
                failures.append(f"{name}: attributed {run['attributed_s']}"
                                f" s against {device_s} s by CUDA events")
        diff = _cli_json(["perf", "diff", runs["eager"]["artifact"],
                          runs["graph"]["artifact"], "--json"])
        if diff["rc"] != 0:
            failures.append(f"perf diff rc {diff['rc']}")
        out.update({"step_cost": cost, "steps": OBS_STEPS,
                    "eager": runs["eager"], "graph": runs["graph"],
                    "diff": diff["out"]})
        state["observe_mfu"] = {n: r["mfu"] for n, r in runs.items()}
        for logdir in (os.path.join(root, "eager"),
                       os.path.join(root, "graph")):
            prune_capture(logdir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


def _serve_session(argv: list, workers_kw: list, steps: int, probe=None):
    """``cli serve --mode async --workers 2 --port 0`` + ``argv`` on a
    thread of this process and 2 ``PSWorker`` threads on the card
    through their own ``RemoteStore``s (ResNet-18, bf16, batch 128,
    ``steps`` batches each, eval off). ``probe(ports, workers)`` runs on
    this thread while they train. Returns the run's pieces: its stdout
    and stderr, the probe's result, the workers' results, img/s."""
    import re
    import threading

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import RemoteStore
    from distributed_parameter_server_for_ml_training_tpu_torch.data import \
        synthetic_cifar100
    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        PSWorker, WorkerConfig)

    ds = synthetic_cifar100(n_train=N_WORKERS * BATCH * steps, n_test=10)
    model = get_model("resnet18", num_classes=100, dtype="bfloat16",
                      device="cuda", seed=0)
    stdout, stderr = _Tee(), _Tee(echo=sys.stderr)
    real = sys.stdout, sys.stderr
    result: dict = {}

    def run_serve():
        try:
            result["rc"] = cli.main(["serve", "--mode", "async",
                                     "--workers", str(N_WORKERS),
                                     "--port", "0", *argv])
        except BaseException as e:  # noqa: BLE001 — reported below
            result["error"] = repr(e)

    sys.stdout, sys.stderr = stdout, stderr
    server = threading.Thread(target=run_serve, daemon=True)
    remotes, workers, probed = [], [], None
    try:
        server.start()
        deadline = time.perf_counter() + 60
        ports = {}
        while time.perf_counter() < deadline and server.is_alive():
            text = stderr.text()
            for key, pat in (("grpc", r"parameter server up on :(\d+)"),
                             ("metrics", r"serving /metrics on :(\d+)")):
                m = re.search(pat, text)
                if m:
                    ports[key] = int(m.group(1))
            if "grpc" in ports and ("metrics" in ports
                                    or "--metrics-port" not in argv):
                break
            time.sleep(0.05)
        if "grpc" not in ports:
            raise AssertionError(f"cli serve never came up: {result}, "
                                 f"{stderr.text()[-2000:]}")
        remotes = [RemoteStore(f"127.0.0.1:{ports['grpc']}")
                   for _ in range(N_WORKERS)]
        workers = [PSWorker(r, model, ds, WorkerConfig(
            batch_size=BATCH, num_epochs=1, device="cuda",
            eval_each_epoch=False, **kw), worker_name=f"obs-{i}")
            for i, (r, kw) in enumerate(zip(remotes, workers_kw))]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        if probe is not None:
            probed = probe(ports, workers)
        for w in workers:
            w.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        server.join(60)
    finally:
        sys.stdout, sys.stderr = real
        for r in remotes:
            r.close()
    if server.is_alive() or result.get("rc") != 0:
        raise AssertionError(f"cli serve did not end with 0: {result}, "
                             f"{stderr.text()[-2000:]}")
    results = [w.result for w in workers]
    images = sum(r.local_steps_completed for r in results) * BATCH
    return {"stdout": stdout.text(), "stderr": stderr.text(),
            "probe": probed, "results": results, "wall_s": wall,
            "img_per_s": images / wall}


def _get_json(port: int, path: str):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _observe_serve(state: dict) -> None:
    """(b) ``cli serve`` with every surface on and two int8 ResNet-18
    workers (K1 once a push): ``/metrics``, ``/healthz`` and ``/cluster``
    scraped mid-run (the memory block read off the card), the snapshot
    stream on stdout and in the journal, one ``slo_burn`` edge forced
    through the armed ``ProfileTrigger`` while the workers push (its
    window attributed on the card's lanes, K1 in ``quantize-pack``); the
    phase 18 NaN drill (fp16, ``--remediate``) freezing an incident
    bundle; img/s with the surfaces off and on, in turns."""
    import os
    import shutil
    import tempfile

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import disable_tracing, get_cluster_monitor, read_journal

    kind = torch.cuda.get_device_name(0)
    root = tempfile.mkdtemp(prefix="observe-serve-")
    failures = []
    out = {"phase": "observability", "form": "b_serve",
           "card": state["card"]}
    d = {k: os.path.join(root, k) for k in ("i", "p", "j", "i2", "j2")}
    # The SLO and goodput thresholds are set where a healthy run stays,
    # so the one capture is the forced edge's (a natural one would start
    # a second profiler session).
    surfaces = ["--telemetry", "--telemetry-interval", "1",
                "--metrics-port", "0", "--profile-triggers",
                "--profile-window", "1.0", "--slo-fetch-p99-ms", "60000",
                "--goodput-drop-threshold", "0.01"]

    def probe(ports, workers):
        # Wait for the first pushes, then scrape and force the edge while
        # the workers keep pushing.
        deadline = time.perf_counter() + 60
        while sum(w.result.pushes_accepted for w in workers) < 2 \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        pages = {p: _get_json(ports["metrics"], p)
                 for p in ("/metrics", "/healthz", "/cluster")}
        trig = get_cluster_monitor().profile_trigger
        k0 = Q.wire_quantize_multi.launches
        t0 = time.perf_counter()
        trig.on_alert_events([{"state": "fired", "rule": "slo_burn_fast",
                               "severity": "warning", "worker": None}])
        return {"pages": pages, "capture_s": time.perf_counter() - t0,
                "k1_in_window": Q.wire_quantize_multi.launches - k0}

    try:
        Q.wire_quantize_multi.launches = 0
        run = _serve_session(
            ["--push-codec", "int8", "--incidents-dir", d["i"],
             "--profiles-dir", d["p"], "--journal-dir", d["j"],
             *surfaces], [{}, {}], OBS_SERVE_STEPS, probe=probe)
        k1 = Q.wire_quantize_multi.launches
        state["observe_k1_launches"] = k1
        pushes = sum(r.pushes_accepted + r.pushes_rejected
                     for r in run["results"])
        pages = run["probe"]["pages"]
        cluster = json.loads(pages["/cluster"][1])
        memory = cluster.get("memory") or {}
        device = memory.get("device") or {}
        snaps = [line for line in run["stdout"].splitlines()
                 if '"kind": "snapshot"' in line]
        if snaps:
            # Phase 27 (b) holds the journal's percentiles to the last
            # snapshot the registry printed.
            state["observe_last_snapshot"] = json.loads(
                snaps[-1].split("METRICS_JSON:", 1)[1])
        journal = [r["type"] for r in read_journal(d["j"])]
        records = sorted(f for f in os.listdir(d["p"])
                         if f.startswith("PROFILE_"))
        record = {}
        if records:
            with open(os.path.join(d["p"], records[0])) as f:
                record = json.load(f)
        prof = record.get("profile", {})
        qp = prof.get("op_classes", {}).get("quantize-pack", {})
        out["surfaces"] = {
            "img_per_s": run["img_per_s"], "pushes": pushes,
            "k1_launches": k1,
            "status": {p: v[0] for p, v in pages.items()},
            "metrics_lines": len(pages["/metrics"][1].splitlines()),
            "healthz": json.loads(pages["/healthz"][1]),
            "cluster_workers": len(cluster.get("workers", [])),
            "memory": memory, "snapshot_lines": len(snaps),
            "journal_types": {t: journal.count(t) for t in set(journal)},
            "incidents": os.listdir(d["i"]) if os.path.isdir(d["i"])
            else [],
            "profile_records": records,
            "trigger": {"rule": record.get("rule"),
                        "window_s": record.get("window_s"),
                        "capture_s": run["probe"]["capture_s"],
                        "k1_launched_in_window":
                            run["probe"]["k1_in_window"],
                        "basis": prof.get("basis"),
                        "op_classes": prof.get("op_classes"),
                        "parse_errors": record.get("parse_errors"),
                        "traces_pruned": record.get("traces_pruned")}}
        if k1 != pushes or pushes != 2 * OBS_SERVE_STEPS:
            failures.append(f"K1 {k1} launches for {pushes} pushes")
        if any(v[0] != 200 for v in pages.values()) \
                or "# TYPE" not in pages["/metrics"][1]:
            failures.append(f"scrapes: {out['surfaces']['status']}")
        if not device.get("bytes_in_use", 0) > 0 \
                or device.get("device_kind") != kind:
            failures.append(f"memory block: {memory}")
        if not snaps or "snapshot" not in journal:
            failures.append(f"{len(snaps)} snapshot lines, journal "
                            f"{set(journal)}")
        if len(records) != 1 or record.get("rule") != "slo_burn" \
                or prof.get("basis") != "device_lanes" \
                or not 1 <= qp.get("events", 0) \
                <= run["probe"]["k1_in_window"]:
            failures.append(f"profile trigger: {out['surfaces']['trigger']}"
                            f", records {records}")

        # The phase 18 NaN drill under the same CLI: the critical edge
        # freezes an incident bundle. The worker's non-finite report
        # stands until its next push boundary, so the monitor evaluates
        # every 0.05 s (phase 18 evaluated at each push).
        drill = _serve_session(
            ["--push-codec", "fp16", "--remediate", "--health-interval",
             "0.05", "--incidents-dir", d["i2"], "--journal-dir", d["j2"],
             "--trace"], [{}, {"nan_inject_step": 2}], OBS_SERVE_STEPS)
        bundles = sorted(os.listdir(d["i2"])) \
            if os.path.isdir(d["i2"]) else []
        manifests = []
        for b in bundles:
            with open(os.path.join(d["i2"], b, "manifest.json")) as f:
                manifests.append(json.load(f))
        out["incidents"] = {
            "bundles": bundles,
            "files": [m["files"] for m in manifests],
            "rules": [m["trigger"].get("rule") for m in manifests],
            "records": [m["records"] for m in manifests],
            "quarantined_pushes": [r.pushes_quarantined
                                   for r in drill["results"]]}
        if not manifests or not any(
                {"journal_window.jsonl", "snapshots.json"}
                <= set(m["files"])
                and any(f.startswith("traces/flight-server-")
                        for f in m["files"])
                and m["records"] > 0 for m in manifests):
            failures.append(f"incident bundles: {out['incidents']}")

        # img/s with the surfaces off and on, in turns. The health
        # monitor runs in both (serve's default); an off turn also drops
        # the memory sampler, which is on by default with the monitor.
        turns = []
        for i, on in enumerate(OBS_TURNS):
            argv = ["--push-codec", "int8"]
            if on:
                argv += ["--incidents-dir", f"{d['i']}-t{i}",
                         "--profiles-dir", f"{d['p']}-t{i}",
                         "--journal-dir", f"{d['j']}-t{i}", "--trace",
                         *surfaces]
            else:
                argv += ["--no-memory-telemetry"]
            r = _serve_session(argv, [{}, {}], OBS_TURN_STEPS)
            turns.append({"telemetry": on, "img_per_s": r["img_per_s"],
                          "wall_s": r["wall_s"]})
            disable_tracing()
        out["turns"] = turns
        out["overhead"] = _turns_verdict(turns)
    finally:
        disable_tracing()
        # Phase 27 (b) reads the journal and the drill's bundle, and
        # removes them.
        state["observe_dirs"] = {**d, "root": root}
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


def _turns_verdict(turns: list) -> dict:
    """The surfaces' cost from the off/on turns: the mean on img/s against
    the mean off, and the off turns' spread (max - min over their mean).
    The +-10 % prediction reads ``held`` or ``missed`` only where the off
    turns agree within that bound; otherwise ``unresolved``."""
    off = [t["img_per_s"] for t in turns if not t["telemetry"]]
    on = [t["img_per_s"] for t in turns if t["telemetry"]]
    mean_off, mean_on = sum(off) / len(off), sum(on) / len(on)
    spread = (max(off) - min(off)) / mean_off
    diff = mean_on / mean_off - 1.0
    if spread > OBS_OVERHEAD_BOUND:
        verdict = "unresolved"
    else:
        verdict = "held" if abs(diff) <= OBS_OVERHEAD_BOUND else "missed"
    return {"mean_off_img_per_s": mean_off, "mean_on_img_per_s": mean_on,
            "on_vs_off": diff, "off_spread": spread,
            "bound": OBS_OVERHEAD_BOUND, "verdict": verdict}


def phase_observability(state: dict) -> None:
    """Phase 20: the perf observatory and the process surfaces."""
    _observe_profile(state)
    _observe_serve(state)


# -- phase 21: sync data parallelism over several processes ------------------

MH_SLOTS, MH_STEPS = 4, 8     # 4 global slots of BATCH, 8 steps
MH_RING_SEED = 0x5EED
MH_RANK_TIMEOUT_S = 300       # (b), (c): each rank process, start to exit


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _mh_ring_rows(device):
    """Seeded rows ``[MH_SLOTS, 11,220,132]`` (ResNet-18's size) for the
    ring alone, the same on every process."""
    import torch

    g = torch.Generator(device=device).manual_seed(7)
    return 1e-3 * torch.randn((MH_SLOTS, 11_220_132), generator=g,
                              device=device)


def _digests(rows) -> list:
    import hashlib

    return [hashlib.sha256(r.cpu().numpy().tobytes()).hexdigest()
            for r in rows]


def _mh_batches(steps: int) -> list:
    """``steps`` global batches of MH_SLOTS x BATCH synthetic CIFAR-100
    images (seed 0)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import make_batches, synthetic_cifar100

    ds = synthetic_cifar100(n_train=MH_SLOTS * BATCH * steps, n_test=8)
    return list(make_batches(ds.x_train, ds.y_train, MH_SLOTS * BATCH,
                             seed=0))


def _mh_steps(mesh, batches: list, compression: str):
    """Full ResNet-18 (100 classes, bf16, seed 0) trained over ``mesh``
    with augmentation, one step a global batch: the final state and the
    last step's metrics."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        import get_model
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import (DATA_AXIS, make_sync_dp_step, replicate_to_mesh,
                shard_batch, shard_batch_global)
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .optimizers import server_sgd
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .train_state import create_train_state

    model = get_model("resnet18", num_classes=100, dtype="bfloat16",
                      device=mesh.device, seed=0, axis_name=DATA_AXIS)
    st = replicate_to_mesh(mesh, create_train_state(model, server_sgd(0.1)))
    step = make_sync_dp_step(mesh, model, compression=compression)
    shard = shard_batch_global if mesh.group is not None else shard_batch
    for xb, yb in batches:
        st, m = step(st, *shard(mesh, (xb, yb)), 1)
    torch.cuda.synchronize()
    return st, m


def _multihost_one_rank(state: dict) -> None:
    """Phase 21 (a): one rank over NCCL on the card, 4 slots, against the
    one-process step, int8 and bf16, with deterministic cuDNN."""
    import torch
    import torch.distributed as dist

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_global_mesh, make_mesh
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import multihost as mh

    batches = _mh_batches(MH_STEPS)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mh.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
    out, counts = {}, None
    try:
        group = mh.world_group()
        for comp in ("int8", "bf16"):
            single, _ = _mh_steps(make_mesh(MH_SLOTS, "cuda"), batches, comp)
            if comp == "int8":
                _reset_block_counts()
            t0 = time.perf_counter()
            multi, last = _mh_steps(make_global_mesh(
                MH_SLOTS, "cuda", group=group), batches, comp)
            seconds = time.perf_counter() - t0
            if comp == "int8":
                counts = _block_counts()
            differ = [k for k in single.params
                      if not torch.equal(single.params[k], multi.params[k])]
            differ += [k for k in single.batch_stats
                       if not torch.equal(single.batch_stats[k],
                                          multi.batch_stats[k])]
            # Over one rank the all-reduce moves nothing: 0 bytes (bf16,
            # from the recorder); int8 counts the ring's on-card hops.
            out[comp] = {"steps": multi.step, "seconds": seconds,
                         "tensors_differing": differ,
                         "wire_bytes_per_slot": last["wire_bytes_per_slot"]}
            del single, multi
    finally:
        dist.destroy_process_group()
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    state["multihost_counts"] = dict(counts)
    emit({"phase": "multihost", "form": "a_one_rank_nccl",
          "backend": group.backend, "slots": MH_SLOTS,
          "batch_per_slot": BATCH, "runs": out, "launches": counts,
          "card": state["card"]})
    want = {"block_quantize": 0,
            "block_quantize_stochastic": MH_SLOTS * MH_STEPS,
            "block_dequantize": (2 * MH_SLOTS - 1) * MH_STEPS}
    if counts != want:
        raise AssertionError(f"(a) launched {counts}; expected {want}")
    bad = {c: r["tensors_differing"] for c, r in out.items()
           if r["tensors_differing"] or r["steps"] != MH_STEPS}
    if out["bf16"]["wire_bytes_per_slot"] != 0:
        bad["bf16_wire_bytes_one_rank"] = out["bf16"]["wire_bytes_per_slot"]
    if bad:
        raise AssertionError(f"(a) one NCCL rank differs from the "
                             f"one-process step: {bad}")


def multihost_rank(argv: list) -> int:
    """One rank process of phase 21 (b)/(c): ``rank backend ring_port
    out_dir cli_args...``. First, over the 2 ranks, the ring alone on
    :func:`_mh_ring_rows` (this rank's half), one int8 step of
    :func:`_mh_steps` (rank 0 saves its params to ``out_dir``) and one
    bf16 step (its ``wire_bytes_per_slot``, the rank's all-reduce bytes
    from the recorder); then ``cli train --multihost`` with
    ``cli_args``. Writes its exit code, the ring rows' digests, the bf16
    step's wire bytes and K2-K4's launches in the CLI run to
    ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_global_mesh
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import multihost as mh
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .sync_dp import _int8_ring_allreduce_mean

    rank, backend, ring_port = int(argv[0]), argv[1], argv[2]
    out = Path(argv[3])
    dev = mh.initialize(f"127.0.0.1:{ring_port}", 2, rank, backend=backend,
                        device="cuda")
    group = mh.world_group()
    half = MH_SLOTS // 2
    rows = _mh_ring_rows(dev)[half * rank:half * (rank + 1)]
    ring = _int8_ring_allreduce_mean(rows, MH_RING_SEED, group=group)
    torch.cuda.synchronize()
    digests = _digests(ring)
    del rows, ring
    st, _ = _mh_steps(make_global_mesh(MH_SLOTS, dev, group=group),
                      _mh_batches(1), "int8")
    if rank == 0:
        torch.save({k: v.cpu() for k, v in st.params.items()},
                   out / "step_rank0.pt")
    del st
    _, bf16 = _mh_steps(make_global_mesh(MH_SLOTS, dev, group=group),
                        _mh_batches(1), "bf16")
    dist.destroy_process_group()
    _reset_block_counts()
    rc = cli.main(argv[4:])
    torch.cuda.synchronize()
    (out / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "rc": rc, "device": str(dev), "ring_digests": digests,
        "bf16_wire_bytes_per_slot": bf16["wire_bytes_per_slot"],
        "launches": _block_counts()}))
    return rc


def _multihost_processes(state: dict, backend: str, form: str,
                         meanwhile=None) -> None:
    """Phase 21 (b)/(c): 2 rank processes (:func:`multihost_rank`), each
    ``cli train --mode sync --multihost`` over 2 of 4 slots, against the
    one-process 4-slot run of the same command. ``meanwhile()`` runs in
    this process while the ranks start."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_mesh
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .sync_dp import _int8_ring_allreduce_mean, ring_payload_bytes

    torch.cuda.empty_cache()
    repo = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mh_"))
    steps_per_epoch = MH_STEPS // 2
    common = ["train", "--mode", "sync", "--workers", str(MH_SLOTS),
              "--batch-size", str(BATCH), "--compression", "int8",
              "--epochs", "2", "--synthetic", "--num-train",
              str(MH_SLOTS * BATCH * steps_per_epoch), "--num-test", "128",
              "--emit-metrics"]
    ring_port, cli_port = _free_port(), _free_port()
    launcher = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.multihost_rank(sys.argv[1:]))")
    logs = [tempfile.TemporaryFile("w+") for _ in range(4)]
    procs, late = [], None
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", launcher, str(rank), backend,
                 str(ring_port), str(tmp), *common,
                 "--multihost", "--coordinator", f"127.0.0.1:{cli_port}",
                 "--num-processes", "2", "--process-id", str(rank),
                 "--dist-backend", backend, "--checkpoint-dir",
                 str(tmp / "multi")],
                cwd=repo, env=env, stdout=logs[2 * rank],
                stderr=logs[2 * rank + 1], text=True))
        if meanwhile is not None:
            meanwhile()
        deadline = time.perf_counter() + MH_RANK_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                late = f"a rank process still alive after " \
                       f"{MH_RANK_TIMEOUT_S} s"
                break
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    rcs = [p.returncode for p in procs]
    if late is not None or rcs != [0, 0]:
        raise AssertionError(f"{late or f'rank exit codes {rcs}'}. Output "
                             f"tails: {[t[-2000:] for t in texts]}")
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(2)]
    rows = _metrics_rows(texts[0])
    server, workers = rows[0], rows[1:]
    staged = ["staged through the host" in texts[2 * r + 1]
              for r in range(2)]

    # The ring alone: one process's 4-row ring on the card, and on a CPU
    # copy (the plain versions), against the ranks' rows.
    rows4 = _mh_ring_rows("cuda")
    one_ring = _digests(_int8_ring_allreduce_mean(rows4, MH_RING_SEED))
    plain_ring = _digests(_int8_ring_allreduce_mean(rows4.cpu(),
                                                    MH_RING_SEED))
    del rows4
    rank_ring = ranks[0]["ring_digests"] + ranks[1]["ring_digests"]

    def max_diff(a, b):
        return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in b)

    # One int8 step, one process over the 4 slots, against the ranks';
    # beside it one process over 2 slots of 256, the same function in
    # another slot layout.
    batch1 = _mh_batches(1)
    step_one = _mh_steps(make_mesh(MH_SLOTS, "cuda"), batch1,
                         "int8")[0].params
    step_two = _mh_steps(make_mesh(2, "cuda"), batch1, "int8")[0].params
    step_multi = torch.load(tmp / "step_rank0.pt", weights_only=True)
    step_worst = [k for k in step_one
                  if not torch.allclose(step_multi[k].cuda(), step_one[k],
                                        rtol=0.05, atol=1e-3)]
    step_diff, step_layout = max_diff(step_multi, step_one), \
        max_diff(step_two, step_one)
    del step_one, step_two, step_multi

    # The one-process runs of the same command: int8 over the 4 slots
    # (the reference), int8 over 2 slots of 256 (another layout) and
    # uncompressed over 4 (int8's own effect); the params after 8 steps.
    runs = {"one_int8": ["--compression", "int8"],
            "two_int8": ["--compression", "int8", "--workers", "2",
                         "--batch-size", str(2 * BATCH)],
            "one_none": ["--compression", "none"]}
    one_rows, rc_one = None, []
    for name, extra in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_one.append(cli.main([*common, *extra, "--checkpoint-dir",
                                    str(tmp / name)]))
        one_rows = one_rows or _metrics_rows(buf.getvalue())

    def params(name):
        (f,) = sorted((tmp / name).iterdir())[-1:]
        return torch.load(f, weights_only=True)["params"]

    multi, one, two = params("multi"), params("one_int8"), \
        params("two_int8")
    run_diff = max_diff(multi, one)
    layout_spread = max_diff(two, one)
    int8_effect = max_diff(params("one_none"), one)
    noise = max(layout_spread, int8_effect)

    def outside(a):
        return [k for k in one
                if not torch.allclose(a[k], one[k], rtol=0.05, atol=1e-3)]

    worst, layout_worst = outside(multi), outside(two)
    size = sum(v.numel() for v in one.values())
    wire_want = 2 * (MH_SLOTS - 1) * ring_payload_bytes(-(-size // MH_SLOTS))
    # bf16 over 2 ranks: the all-reduce of the card's bf16 mean, 2 (R-1)/R
    # x 2 bytes a value (the ring model of utils/collective_bytes.py).
    bf16_wire = [r["bf16_wire_bytes_per_slot"] for r in ranks]
    bf16_want = 2 * size

    def img_s(rs):
        t = rs[1]["epoch_times_seconds"][-1]
        return steps_per_epoch * MH_SLOTS * BATCH / t, 1e3 * t \
            / steps_per_epoch

    (mh_img_s, mh_step_ms), (one_img_s, one_step_ms) = img_s(rows), \
        img_s(one_rows)
    per_rank = [r["launches"] for r in ranks]
    state["multihost_counts"] = {
        k: v + per_rank[0][k] + per_rank[1][k]
        for k, v in state["multihost_counts"].items()}
    emit({"phase": "multihost", "form": form, "backend": backend,
          "processes": 2, "slots_per_rank": MH_SLOTS // 2,
          "batch_per_slot": BATCH, "steps": server["global_steps_completed"],
          "devices": [r["device"] for r in ranks],
          "hops_staged_through_host": staged,
          "ranks_params_identical": server.get("ranks_params_identical"),
          "ring_replicas_identical": server.get("ring_replicas_identical"),
          "ring_alone_equals_one_process": rank_ring == one_ring,
          "ring_alone_card_equals_plain": one_ring == plain_ring,
          "img_per_s_summed_epoch2": mh_img_s, "step_ms_epoch2": mh_step_ms,
          "one_process_img_per_s_epoch2": one_img_s,
          "one_process_step_ms_epoch2": one_step_ms,
          "phase7_img_per_s": state.get("sync_img_per_s"),
          "epoch_times_seconds": rows[1]["epoch_times_seconds"],
          "launches_per_rank": per_rank,
          "wire_bytes_per_slot_per_step": server.get(
              "wire_bytes_per_slot_step"), "wire_bytes_model": wire_want,
          "bf16_wire_bytes_per_slot_per_step": bf16_wire,
          "bf16_wire_bytes_model": bf16_want,
          "step1_params_max_abs_diff_vs_one_process": step_diff,
          "step1_one_process_2_vs_4_slots_max_abs_diff": step_layout,
          "step1_params_outside_int8_tolerance": step_worst,
          "params_max_abs_diff_vs_one_process": run_diff,
          "one_process_2_vs_4_slots_max_abs_diff": layout_spread,
          "one_process_int8_vs_none_max_abs_diff": int8_effect,
          "params_outside_int8_tolerance_after_8_steps": len(worst),
          "one_process_2_slots_outside_int8_tolerance_after_8_steps":
              len(layout_worst), "tensors": len(one),
          "one_process_rc": rc_one, "wall_seconds": wall,
          "card": state["card"]})
    want = {"block_quantize": 0,
            "block_quantize_stochastic": MH_SLOTS * MH_STEPS,
            "block_dequantize": (2 * MH_SLOTS - 1) * MH_STEPS}
    problems = []
    if server.get("global_steps_completed") != MH_STEPS:
        problems.append(f"steps {server.get('global_steps_completed')}")
    if any(r != want for r in per_rank):
        problems.append(f"launches {per_rank}, expected {want} a rank")
    if backend == "gloo" and not all(staged):
        problems.append("a gloo rank on the card did not say its "
                        "collectives were staged through the host")
    if server.get("ranks_params_identical") is not True \
            or server.get("ring_replicas_identical") is not True:
        problems.append("replicas differ")
    if rank_ring != one_ring or one_ring != plain_ring:
        problems.append("the ring over ranks differs from one process's "
                        "or from the plain versions")
    if server.get("wire_bytes_per_slot_step") != wire_want:
        problems.append(f"wire bytes {server.get('wire_bytes_per_slot_step')}"
                        f" != {wire_want}")
    if bf16_wire != [bf16_want, bf16_want]:
        problems.append(f"bf16 wire bytes {bf16_wire} != {bf16_want}")
    if rc_one != [0, 0, 0] or step_worst:
        problems.append(f"one-process rcs {rc_one}; one step's params "
                        f"outside rtol 0.05 / atol 1e-3: {step_worst}")
    # After 8 bf16 steps two runs of the same function drift apart by
    # ~1e-2 (one process over 2 slots, or int8 against none): the ranks
    # must stay within twice that drift of one process.
    if not run_diff <= 2 * noise:
        problems.append(f"after {MH_STEPS} steps the ranks' params are "
                        f"{run_diff} from one process's, over twice the "
                        f"drift of one process's own variants ({noise})")
    if problems:
        raise AssertionError(f"({form}) " + "; ".join(problems))


def phase_multihost(state: dict) -> None:
    """Phase 21: sync data parallelism over several processes. (a) runs
    while (b)'s rank processes start (they import torch first)."""
    import torch

    errors: list = []

    def one_rank() -> None:
        try:
            _multihost_one_rank(state)
        except Exception as e:  # noqa: BLE001 — re-raised after (b)
            traceback.print_exc()
            errors.append(e)

    _multihost_processes(state, "gloo", "b_two_ranks_one_card_gloo",
                         meanwhile=one_rank)
    if errors:
        raise errors[0]
    if torch.cuda.device_count() >= 2:
        _multihost_processes(state, "nccl", "c_two_ranks_two_cards_nccl")
    else:
        emit({"phase": "multihost", "form": "c_two_ranks_two_cards_nccl",
              "run": False, "reason": "not run for want of a second card",
              "device_count": torch.cuda.device_count()})


SP_MH_TIMEOUT_S = 420        # (b), (c): each rank process, start to exit
SP_MH_TIMED_STEPS = 1        # (b), (c): steps timed after the 1-step epoch
# The params against one process's, as phase 21's one int8 step: dQ's
# fp32 partial sums arrive in an order that varies, so two runs of one
# process differ ((a): 1.95e-4 after 2 steps on the card), and the ranks
# of (b) and (c) pool and sum gradients in another order besides.
SP_MH_RTOL, SP_MH_ATOL = 0.05, 1e-3


def _sp_ring_inputs(device) -> list:
    """Seeded q, k, v and a cotangent ``[8, 4096, 12, 64]`` bf16 (layer
    0's ring at the SP path's shapes), the same on every process."""
    import torch

    g = torch.Generator(device=device).manual_seed(11)
    return [torch.randn((SP_BATCH, 4096, 12, 64), generator=g,
                        device=device).to(torch.bfloat16) for _ in range(4)]


def _sp_ring_run(mesh, inputs, tokens=slice(None), use_kernel=True) -> list:
    """Output, dq, dk and dv of the flash ring over ``mesh`` on ``tokens``
    of ``inputs``."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .ring_attention import make_ring_flash_attention

    q, k, v, cot = (x[:, tokens] for x in inputs)
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = make_ring_flash_attention(mesh, use_kernel=use_kernel)(q, k, v)
    (out.float() * cot.float()).sum().backward()
    torch.cuda.synchronize()
    return [out.detach(), q.grad, k.grad, v.grad]


def _sp_bytes_model(model, tokens: int, slots: int, ranks: int,
                    batch: int = SP_BATCH) -> dict:
    """The collectives one step of the flash ring's SP over ``ranks``
    ranks must count (the ring model of ``utils/collective_bytes.py``),
    from the shapes: a hop carries one slot's K and V blocks (in the
    compute dtype) forward, and in the backward K, V and their fp32
    gradient accumulators, which take one hop more; the pooled mean
    ``[batch, width]`` fp32 and every gradient but the head's are each
    all-reduced once."""
    import torch

    n, heads = slots, model.blocks[0].attn.num_heads
    block = batch * heads * (tokens // n) * (model.hidden_dim // heads)
    kv = torch.empty((), dtype=model.compute_dtype).element_size()
    per_layer = 2 * (n - 1) * kv * block * 2 + 2 * n * 4 * block
    hops = per_layer * model.depth if ranks > 1 else 0
    frac = 2 * (ranks - 1) / ranks
    body = sum(p.numel() for name, p in model.named_parameters()
               if not name.startswith("head."))
    reduce = int(frac * 4 * batch * model.hidden_dim) + int(frac * 4 * body)
    out = {"total": hops + reduce, "by_op": {}, "count": {}}
    if ranks > 1:
        out["by_op"]["collective-permute"] = hops
        out["count"]["collective-permute"] = (2 * n - 1) * model.depth
    out["by_op"]["all-reduce"] = reduce
    out["count"]["all-reduce"] = 2
    return out


def _sp_one_rank(state: dict) -> None:
    """Phase 22 (a): one NCCL rank over the SP path's 2 slots against one
    process's phase 11 trainer from the same weights."""
    import torch
    import torch.distributed as dist

    from distributed_parameter_server_for_ml_training_tpu_torch.data.cifar \
        import standardize, to_float
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import multihost as mh

    def run(group=None):
        trainer = sp_trainer(SP_STEPS, n_test=SP_BATCH, group=group)
        x = standardize(to_float(torch.as_tensor(
            trainer.dataset.x_train[:SP_BATCH], device="cuda")))
        with torch.no_grad():
            logits = trainer.model(x).float().cpu()
        if group is not None:
            _reset_flash_counts()
        trainer.train()
        torch.cuda.synchronize()
        counts = _flash_counts() if group is not None else None
        params = {k: v.detach().clone() for k, v in
                  trainer.state.params.items()}
        return trainer, logits, params, counts

    torch.cuda.empty_cache()
    # The one-process trainer twice: dQ's atomically added partial sums
    # make two runs of it differ; their distance is the bound below.
    one, logits_one, p_one, _ = run()
    mesh_one = one.mesh
    del one
    _, _, p_again, _ = run()
    torch.cuda.empty_cache()
    inputs = _sp_ring_inputs("cuda")
    ring_one = _sp_ring_run(mesh_one, inputs)
    ring_again = _sp_ring_run(mesh_one, inputs)
    mh.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
    try:
        group = mh.world_group()
        rk, logits_rk, p_rk, counts = run(group)
        bytes_step, bytes_want = rk.collective_bytes_step, _sp_bytes_model(
            rk.model, rk.tokens, SP_SLOTS, 1)
        ring_rk = _sp_ring_run(rk.mesh, inputs)
        del rk
    finally:
        dist.destroy_process_group()

    def dist_max(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in b)

    spread, diff = dist_max(p_again, p_one), dist_max(p_rk, p_one)
    outside = [k for k in p_one if not torch.allclose(
        p_rk[k], p_one[k], rtol=SP_MH_RTOL, atol=SP_MH_ATOL)]
    ring_equal = {name: bool(torch.equal(a, b)) for name, a, b in
                  zip(("out", "dq", "dk", "dv"), ring_rk, ring_one)}
    dq_spread = float((ring_again[1].float() - ring_one[1].float())
                      .abs().max())
    dq_diff = float((ring_rk[1].float() - ring_one[1].float()).abs().max())
    del inputs, ring_one, ring_again, ring_rk, p_one, p_again, p_rk
    torch.cuda.empty_cache()
    want = {"flash_fwd_wgmma": 24 * (SP_STEPS + 1), "flash_fwd": 0,
            "flash_bwd": 24 * SP_STEPS, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    state["sp_mh_counts"] = dict(counts)
    emit({"phase": "sp_multihost", "form": "a_one_rank_nccl",
          "backend": group.backend, "slots": SP_SLOTS, "steps": SP_STEPS,
          "launches": counts, "logits_bit_equal":
              bool(torch.equal(logits_rk, logits_one)),
          "params_max_abs_diff_vs_one_process": diff,
          "one_process_run_to_run_max_abs_diff": spread,
          "params_outside_tolerance": outside,
          "ring_layer0_bit_equal": ring_equal,
          "ring_dq_max_abs_diff_vs_one_process": dq_diff,
          "ring_dq_one_process_run_to_run_max_abs_diff": dq_spread,
          "collective_bytes_step": bytes_step, "bytes_model": bytes_want,
          "card": state["card"]})
    problems = []
    if counts != want:
        problems.append(f"launched {counts}; expected {want}")
    if not torch.equal(logits_rk, logits_one):
        problems.append("the forward's logits differ from one process's")
    if not (ring_equal["out"] and ring_equal["dk"] and ring_equal["dv"]):
        problems.append(f"layer 0's ring differs: {ring_equal}")
    if bytes_step != bytes_want:
        problems.append(f"bytes {bytes_step} != {bytes_want}")
    # Bit-equal where the kernels are; dQ's order-dependent sums move the
    # params as a second run of one process moves them.
    if outside:
        problems.append(f"params outside rtol {SP_MH_RTOL} / atol "
                        f"{SP_MH_ATOL} of one process's: {outside}")
    if problems:
        raise AssertionError("(a) " + "; ".join(problems))


def sp_rank(argv: list) -> int:
    """One rank process of phase 22 (b)/(c): ``rank backend port
    out_dir``. Over the 2 ranks, one slot each: the flash ring alone on
    the rank's tokens of :func:`_sp_ring_inputs` (saved to ``out_dir``);
    then ``SPTrainer(group=...)`` for one epoch of one step and an eval
    batch (rank 0 saves its params), the ranks' params compared bit for
    bit, and :data:`SP_MH_TIMED_STEPS` steps timed. Writes the flash
    launches of the trainer's runs, the step's collective bytes and the
    times to ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import multihost as mh

    rank, backend, port = int(argv[0]), argv[1], argv[2]
    out = Path(argv[3])
    dev = mh.initialize(f"127.0.0.1:{port}", 2, rank, backend=backend,
                        device="cuda")
    try:
        group = mh.world_group()
        trainer = sp_trainer(1, n_test=SP_BATCH, group=group)
        per = trainer.tokens // 2
        ring = _sp_ring_run(trainer.mesh, _sp_ring_inputs(dev),
                            slice(rank * per, (rank + 1) * per))
        torch.save([t.cpu() for t in ring], out / f"ring{rank}.pt")
        del ring
        torch.cuda.synchronize()
        _reset_flash_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        if rank == 0:
            torch.save({k: v.cpu() for k, v in
                        trainer.state.params.items()}, out / "step0.pt")
        identical = mh.ranks_identical(list(trainer.state.params.values()),
                                       group)
        xb, yb = trainer.dataset.x_train, trainer.dataset.y_train
        gen = torch.Generator(device=dev).manual_seed(3)
        times = []
        for _ in range(SP_MH_TIMED_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer._train_batch(xb, yb, gen)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t1))
        counts = _flash_counts()
        (out / f"rank{rank}.json").write_text(json.dumps({
            "rank": rank, "device": str(dev), "launches": counts,
            "collective_bytes_step": trainer.collective_bytes_step,
            "bytes_model": _sp_bytes_model(trainer.model, trainer.tokens,
                                           SP_SLOTS, 2),
            "ranks_params_identical": identical, "epoch_seconds": epoch_s,
            "step_ms": times, "peak_memory_gib":
                torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "train_loss": trainer.train_loss_per_epoch,
            "test_accuracies": trainer.test_accuracies}))
    finally:
        dist.destroy_process_group()
    return 0


def _sp_processes(state: dict, backend: str, form: str) -> None:
    """Phase 22 (b)/(c): 2 rank processes (:func:`sp_rank`), one slot
    each, against one process over the 2 slots."""
    import os
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    repo = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sp_"))
    launcher = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.sp_rank(sys.argv[1:]))")
    port = _free_port()
    logs = [tempfile.TemporaryFile("w+") for _ in range(4)]
    procs, late = [], None
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", launcher, str(rank), backend,
                 str(port), str(tmp)], cwd=repo, env=env,
                stdout=logs[2 * rank], stderr=logs[2 * rank + 1], text=True))
        # The one-process trainer the ranks are held to, built (its set
        # drawn on the host, its model initialized) while they start.
        one = sp_trainer(1, n_test=SP_BATCH)
        deadline = time.perf_counter() + SP_MH_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                late = f"a rank process still alive after " \
                       f"{SP_MH_TIMEOUT_S} s"
                break
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    try:
        rcs = [p.returncode for p in procs]
        if late is not None or rcs != [0, 0]:
            raise AssertionError(f"{late or f'rank exit codes {rcs}'}. "
                                 f"Output tails: "
                                 f"{[t[-2000:] for t in texts]}")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(2)]
        staged = ["staged through the host" in texts[2 * r + 1]
                  for r in range(2)]

        # The ring alone: one process over the 2 slots on the same inputs,
        # with the kernels (twice: dQ's run-to-run distance) and with
        # plain hops.
        inputs = _sp_ring_inputs("cuda")
        ring_one = _sp_ring_run(one.mesh, inputs)
        dq_spread = float((_sp_ring_run(one.mesh, inputs)[1].float()
                           - ring_one[1].float()).abs().max())
        ring_plain = _sp_ring_run(one.mesh, inputs, use_kernel=False)
        del inputs
        per = one.tokens // 2
        ring_equal, ring_dq, plain_err, plain_ok = [], [], {}, True
        for r in range(2):
            got = torch.load(tmp / f"ring{r}.pt", weights_only=True)
            part = slice(r * per, (r + 1) * per)
            ring_equal.append({
                name: bool(torch.equal(a.cuda(), b[:, part])) for name, a, b
                in zip(("out", "dk", "dv"), (got[0], got[2], got[3]),
                       (ring_one[0], ring_one[2], ring_one[3]))})
            ring_dq.append(float((got[1].cuda().float()
                                  - ring_one[1][:, part].float())
                                 .abs().max()))
            for name, a, b in zip(("out", "dq", "dk", "dv"), got,
                                  ring_plain):
                a, b = a.cuda().float(), b[:, part].float()
                plain_err[f"{name}{r}"] = float((a - b).abs().max())
                plain_ok &= bool(torch.allclose(a, b, atol=RING_ATOL,
                                                rtol=RING_RTOL))
            del got
        del ring_one, ring_plain
        torch.cuda.empty_cache()

        # One step from the same weights and batch, one process over the 2
        # slots; then its steps timed as the ranks' are.
        t1 = time.perf_counter()
        one.train()
        torch.cuda.synchronize()
        one_epoch_s = time.perf_counter() - t1
        multi = torch.load(tmp / "step0.pt", weights_only=True)
        step_diff = max(float((multi[k].cuda() - v).abs().max())
                        for k, v in one.state.params.items())
        step_outside = [k for k, v in one.state.params.items()
                        if not torch.allclose(multi[k].cuda(), v,
                                              rtol=SP_MH_RTOL,
                                              atol=SP_MH_ATOL)]
        del multi
        xb, yb = one.dataset.x_train, one.dataset.y_train
        gen = torch.Generator(device="cuda").manual_seed(3)
        one_times = []
        for _ in range(SP_MH_TIMED_STEPS):
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            one._train_batch(xb, yb, gen)
            torch.cuda.synchronize()
            one_times.append(1e3 * (time.perf_counter() - t2))
        del one
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    step_ms = float(np.median([t for r in ranks for t in r["step_ms"]]))
    one_ms = float(np.median(one_times))
    per_rank = [r["launches"] for r in ranks]
    steps = 1 + SP_MH_TIMED_STEPS
    want = {"flash_fwd_wgmma": 24 * (steps + 1), "flash_fwd": 0,
            "flash_bwd": 24 * steps, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    state["sp_mh_counts"] = {
        k: v + per_rank[0][k] + per_rank[1][k]
        for k, v in state["sp_mh_counts"].items()}
    emit({"phase": "sp_multihost", "form": form, "backend": backend,
          "processes": 2, "slots_per_rank": SP_SLOTS // 2,
          "tokens_per_rank": per, "batch_size": SP_BATCH,
          "devices": [r["device"] for r in ranks],
          "hops_staged_through_host": staged,
          "ranks_params_identical": [r["ranks_params_identical"]
                                     for r in ranks],
          "ring_layer0_bit_equal_to_one_process": ring_equal,
          "ring_dq_max_abs_diff_vs_one_process": ring_dq,
          "ring_dq_one_process_run_to_run_max_abs_diff": dq_spread,
          "ring_vs_plain_max_abs_err": plain_err,
          "step1_params_max_abs_diff_vs_one_process": step_diff,
          "step1_params_outside_tolerance": step_outside,
          "collective_bytes_step": [r["collective_bytes_step"]
                                    for r in ranks],
          "bytes_model": ranks[0]["bytes_model"],
          "launches_per_rank": per_rank,
          "step_ms_runs": [r["step_ms"] for r in ranks],
          "step_ms_median": step_ms, "img_per_s": 1e3 * SP_BATCH / step_ms,
          "one_process_step_ms_runs": one_times,
          "one_process_step_ms_median": one_ms,
          "one_process_img_per_s": 1e3 * SP_BATCH / one_ms,
          "epoch_seconds": [r["epoch_seconds"] for r in ranks],
          "one_process_epoch_seconds": one_epoch_s,
          "peak_memory_gib": [r["peak_memory_gib"] for r in ranks],
          "train_loss": [r["train_loss"] for r in ranks],
          "wall_seconds": wall, "card": state["card"]})
    problems = []
    if any(r != want for r in per_rank):
        problems.append(f"launches {per_rank}, expected {want} a rank")
    if backend == "gloo" and not all(staged):
        problems.append("a gloo rank on the card did not say its "
                        "collectives were staged through the host")
    if not all(r["ranks_params_identical"] for r in ranks):
        problems.append("the ranks' params differ")
    if not all(all(e.values()) for e in ring_equal):
        problems.append(f"the ring over the ranks differs from one "
                        f"process's: {ring_equal}")
    if not plain_ok:
        problems.append(f"the ring over the ranks is outside atol "
                        f"{RING_ATOL} / rtol {RING_RTOL} of plain hops: "
                        f"{plain_err}")
    if step_outside:
        problems.append(f"one step's params outside rtol {SP_MH_RTOL} / "
                        f"atol {SP_MH_ATOL}: {step_outside}")
    if any(r["collective_bytes_step"] != r["bytes_model"] for r in ranks):
        problems.append("the step's collective bytes differ from the "
                        "shapes' count")
    if problems:
        raise AssertionError(f"({form}) " + "; ".join(problems))


def phase_sp_multihost(state: dict) -> None:
    """Phase 22: sequence parallelism over several processes."""
    import torch

    t0 = time.perf_counter()
    _sp_one_rank(state)
    _sp_processes(state, "gloo", "b_two_ranks_one_card_gloo")
    if torch.cuda.device_count() >= 2:
        _sp_processes(state, "nccl", "c_two_ranks_two_cards_nccl")
    else:
        emit({"phase": "sp_multihost", "form": "c_two_ranks_two_cards_nccl",
              "run": False, "reason": "not run for want of a second card",
              "device_count": torch.cuda.device_count()})
    emit({"phase": "sp_multihost", "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# Phases 23 and 24: Switch-MoE and pipeline parallelism on the card
# ---------------------------------------------------------------------------

MOE_E, MOE_D, MOE_H = 4, 768, 3072   # ViT-B/16's width, 4 experts
MOE_BATCH, MOE_TOKENS = 32, 196      # 224 px, gap pool: 14 x 14 patches
MOE_TRAIN_STEPS = 4                  # (b): one epoch of 4 batches of 32
MOE_TIMED_STEPS = 3                  # (b): steps timed after the epoch
F64_TOL = dict(rtol=1e-9, atol=1e-9)  # card vs CPU, both float64
FP32_REL_TOL = 1e-4                  # max |a - b| / max |b|, fp32
PP_STAGES, PP_M, PP_BATCH = 4, 8, 32  # 4 x 3 ViT-B/16 blocks, M = 8
PP_TOKENS = 197                      # 224 px with the CLS token
PP_TIMED_STEPS = 2                   # (b): host-bound, ~0.6-1.2 s a step


def _counts_all() -> dict:
    """Every kernel wrapper's launch count (K1, K2-K4, flash)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    return {"wire_quantize_multi": Q.wire_quantize_multi.launches,
            **_block_counts(), **_flash_counts()}


def _reset_counts_all() -> None:
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    Q.wire_quantize_multi.launches = 0
    _reset_block_counts()
    _reset_flash_counts()


def _rel_err(a, b) -> float:
    """max |a - b| over max |b| (fp32 comparisons), in float64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _moe_layer_run(params: dict, tokens, cot, capacity: int) -> dict:
    """One MoE layer's forward and gradients of sum(out * cot) + aux."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_mesh, moe

    dev = tokens.device
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    x = tokens.detach().clone().requires_grad_()
    fn = moe.make_moe_ffn(make_mesh(MOE_E, dev, axis_names=("expert",)),
                          capacity)
    out, stats = fn(p, x)
    ((out * cot).sum() + stats["aux_loss"]).backward()
    shards = x.detach().view(MOE_E, -1, MOE_D)
    _, idx, _ = moe._route(shards, p["router"].detach())
    _, pos, _ = moe._positions(idx, MOE_E, capacity)
    return {"out": out.detach(), "idx": idx, "pos": pos,
            "drop_frac": stats["drop_frac"].detach(),
            "load": stats["load"].detach(),
            "grads": {**{k: v.grad for k, v in p.items()}, "tokens": x.grad}}


def _moe_layer(state: dict) -> dict:
    """(a): one MoE layer at ViT-B/16 width, card against CPU in float64,
    then fp32 against the dense reference at a capacity with no drops,
    and the layer's fp32 forward + backward time."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_mesh, moe

    n = MOE_BATCH * MOE_TOKENS
    cap = max(8, int(2.0 * (n // MOE_E) / MOE_E))          # 784
    gen = torch.Generator().manual_seed(23)
    params = moe.init_moe_params(gen, MOE_D, MOE_H, MOE_E)
    params["b1"].normal_(0.0, 0.02, generator=gen)
    params["b2"].normal_(0.0, 0.02, generator=gen)
    tokens = torch.randn(n, MOE_D, generator=gen)
    cot = torch.randn(n, MOE_D, generator=gen)
    p64 = {k: v.double() for k, v in params.items()}
    t0 = time.perf_counter()
    cpu = _moe_layer_run(p64, tokens.double(), cot.double(), cap)
    cpu_s = time.perf_counter() - t0
    card = _moe_layer_run({k: v.cuda() for k, v in p64.items()},
                          tokens.double().cuda(), cot.double().cuda(), cap)
    torch.cuda.synchronize()
    res = {"tokens": n, "experts": MOE_E, "d": MOE_D, "hidden": MOE_H,
           "capacity": cap, "cpu_float64_s": cpu_s,
           "idx_equal": bool(torch.equal(card["idx"].cpu(), cpu["idx"])),
           "pos_equal": bool(torch.equal(card["pos"].cpu(), cpu["pos"])),
           "drop_frac": float(card["drop_frac"]),
           "drop_frac_equal": bool(float(card["drop_frac"])
                                   == float(cpu["drop_frac"])),
           "load_equal": bool(torch.equal(card["load"].cpu(), cpu["load"])),
           "tolerance_float64": F64_TOL}
    diffs = {"out": float((card["out"].cpu() - cpu["out"]).abs().max())}
    ok = torch.allclose(card["out"].cpu(), cpu["out"], **F64_TOL)
    for k, g in card["grads"].items():
        diffs[f"d_{k}"] = float((g.cpu() - cpu["grads"][k]).abs().max())
        ok = ok and torch.allclose(g.cpu(), cpu["grads"][k], **F64_TOL)
    res["max_abs_diff_float64"] = diffs
    res["float64_within_tolerance"] = bool(ok)
    del cpu, card
    # fp32 on the card at a capacity that drops nothing (a shard's whole
    # n / E tokens) against the dense reference.
    pc = {k: v.cuda() for k, v in params.items()}
    xc = tokens.cuda()
    mesh = make_mesh(MOE_E, "cuda", axis_names=("expert",))
    with torch.no_grad():
        out, st = moe.make_moe_ffn(mesh, n // MOE_E)(pc, xc)
        ref = moe.dense_reference(pc, xc)
    res["generous_capacity"] = n // MOE_E
    res["generous_drop_frac"] = float(st["drop_frac"])
    res["dense_reference_rel_err"] = _rel_err(out, ref)
    res["fp32_rel_tol"] = FP32_REL_TOL
    del out, ref
    # The layer's fp32 forward + backward at the trainer's capacity.
    layer = moe.make_moe_ffn(mesh, cap)
    pg = {k: v.detach().clone().requires_grad_() for k, v in pc.items()}
    xg = xc.clone().requires_grad_()
    cg = cot.cuda()

    def fwd_bwd():
        o, s = layer(pg, xg)
        torch.autograd.grad((o * cg).sum() + s["aux_loss"],
                            [*pg.values(), xg])

    ms = cuda_time_ms(fwd_bwd, 10)
    rows = MOE_E * MOE_E * cap
    flop = 3 * 2 * 2 * rows * MOE_D * MOE_H       # fwd + bwd, 2 GEMMs
    res.update({"fp32_fwd_bwd_ms": ms, "expert_gemm_flop": flop,
                "expert_gemm_tflop_s": flop / ms / 1e9,
                "expert_gemm_bound_ms": flop / 67e12 * 1e3})
    problems = []
    for k in ("idx_equal", "pos_equal", "drop_frac_equal", "load_equal",
              "float64_within_tolerance"):
        if not res[k]:
            problems.append(f"(a) {k} is False: {diffs}")
    if res["generous_drop_frac"] != 0.0 \
            or res["dense_reference_rel_err"] > FP32_REL_TOL:
        problems.append(f"(a) against the dense reference: drop "
                        f"{res['generous_drop_frac']}, rel err "
                        f"{res['dense_reference_rel_err']}")
    res["problems"] = problems
    return res


def _profile_one(fn, steps: int = 3) -> dict:
    """``steps`` calls of ``fn`` under torch.profiler, after it ran; per
    call."""
    prof = _profile_steps(fn, steps)
    return {"steps": steps, "wall_ms_per_step": prof["wall_s"] * 1e3 / steps,
            "device_busy_ms_per_step": prof["device_busy_s"] * 1e3 / steps,
            "device_idle_share": prof["device_idle_share"],
            "top_device_ms": prof["top_device_ms"][:8]}


def _timed_trainer(trainer, ds, steps: int, profiled: int = 3) -> dict:
    """A trainer's epoch (counts reset just before, read just after), its
    eval, then ``steps`` steps timed one by one with CUDA events on the
    first batch, and ``profiled`` steps under torch.profiler."""
    import torch

    torch.cuda.synchronize()
    _reset_counts_all()
    t0 = time.perf_counter()
    metrics = trainer.train()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _counts_all()
    b = trainer.config.batch_size
    xb, yb = ds.x_train[:b], ds.y_train[:b]
    gen = torch.Generator(device="cuda").manual_seed(5)
    times = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        trainer._train_batch(xb, yb, gen)
        e.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(e))
    med = float(np.median(times))
    prof = _profile_one(lambda: trainer._train_batch(xb, yb, gen), profiled)
    return {"metrics": metrics, "run_seconds": run_s, "launches": counts,
            "epoch_train_seconds": trainer.train_seconds,
            "train_loss_per_epoch": trainer.train_loss_per_epoch,
            "step_ms_runs": times, "step_ms_median": med,
            "img_per_s": b / med * 1e3, "profiled_steps": prof}


def phase_moe(state: dict) -> None:
    """Phase 23: Switch-MoE expert parallelism on the card (module
    notes)."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_imagenet
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import ModelParallelConfig, MoETrainer

    t0 = time.perf_counter()
    out = {"phase": "moe", "card": state["card"]}
    problems = []
    out["a_layer"] = layer = _moe_layer(state)
    problems += layer.pop("problems")
    torch.cuda.empty_cache()
    ds = synthetic_imagenet(n_train=MOE_BATCH * MOE_TRAIN_STEPS,
                            n_test=MOE_BATCH, num_classes=1000,
                            image_size=224, seed=23)
    torch.cuda.reset_peak_memory_stats()
    trainer = MoETrainer(ds, ModelParallelConfig(
        model="vit_b16", num_workers=MOE_E, batch_size=MOE_BATCH,
        num_epochs=1, num_classes=1000, dtype="bfloat16", device="cuda"))
    res = _timed_trainer(trainer, ds, MOE_TIMED_STEPS)
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["capacity"] = trainer.capacity
    res["tokens"] = trainer.tokens
    last = {k: float(v) for k, v in trainer._moe_step_metrics[-1].items()}
    res["moe_metrics_last_step"] = last
    out["b_trainer"] = res
    m = res["metrics"]
    if trainer.capacity != max(8, int(2.0 * MOE_BATCH * MOE_TOKENS
                                      / MOE_E / MOE_E)) \
            or trainer.tokens != MOE_TOKENS:
        problems.append(f"(b) capacity {trainer.capacity}, tokens "
                        f"{trainer.tokens}")
    if any(res["launches"].values()):
        problems.append(f"(b) kernels launched {res['launches']}: 196 "
                        f"tokens take the dense core and no codec")
    if not all(math.isfinite(v) for v in last.values()) \
            or not 0.0 <= last["moe_drop_frac"] <= 1.0:
        problems.append(f"(b) MoE metrics {last}")
    if not all(math.isfinite(v) for v in res["train_loss_per_epoch"]) \
            or trainer.global_steps != MOE_TRAIN_STEPS:
        problems.append(f"(b) losses {res['train_loss_per_epoch']}, steps "
                        f"{trainer.global_steps}")
    for k in ("moe_aux_loss", "moe_load_imbalance", "moe_drop_frac"):
        if k not in m:
            problems.append(f"(b) the run's metrics lack {k}")
    del trainer
    torch.cuda.empty_cache()
    out["problems"] = problems
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if problems:
        raise RuntimeError(f"moe: {problems}")


def _pp_stage_parts(dtype):
    """Four ViT-B/16 ``EncoderStage``s of 3 blocks, stacked, and the
    stage function over one stage's views."""
    import torch
    from torch.func import functional_call

    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        .vit import EncoderStage
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .pipeline import stack_stage_params

    gen = torch.Generator().manual_seed(24)
    stages = [EncoderStage(12 // PP_STAGES, 768, 12, dtype=dtype,
                           generator=gen) for _ in range(PP_STAGES)]
    stacked = stack_stage_params([dict(s.named_parameters())
                                  for s in stages])
    stacked = {k: v.detach().cuda() for k, v in stacked.items()}
    template = stages[0].cuda()

    def stage_fn(p, x):
        return functional_call(template, p, (x,))

    return template, stacked, stage_fn


def _pp_schedules(state: dict) -> dict:
    """(a): GPipe and 1F1B at full width against each other and against
    the four stages in sequence on the whole batch (fp32)."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_mesh
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .pipeline import make_pipeline_train_step

    _, stacked, stage_fn = _pp_stage_parts(torch.float32)
    gen = torch.Generator().manual_seed(240)
    x = torch.randn(PP_BATCH, PP_TOKENS, 768, generator=gen).cuda()
    y = torch.randn(PP_BATCH, PP_TOKENS, 768, generator=gen).cuda()

    def loss_fn(pred, target):
        return torch.mean((pred.float() - target.float()) ** 2)

    mesh = make_mesh(PP_STAGES, "cuda", axis_names=("stage",))
    got = {}
    for sched in ("gpipe", "1f1b"):
        step = make_pipeline_train_step(mesh, stage_fn, loss_fn, PP_M,
                                        schedule=sched)
        step(stacked, x, y)                                # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_time_ms(lambda: step(stacked, x, y), 3)
        loss, grads = step(stacked, x, y)
        torch.cuda.synchronize()
        got[sched] = {"loss": loss, "grads": grads, "ms": ms,
                      "peak_gib_above_inputs":
                          (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
    # The stages in sequence on the whole batch, autograd end to end.
    leaves = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    h = x
    for s in range(PP_STAGES):
        h = stage_fn({k: v[s] for k, v in leaves.items()}, h)
    seq_loss = loss_fn(h, y)
    seq_grads = dict(zip(leaves, torch.autograd.grad(seq_loss,
                                                     list(leaves.values()))))
    res = {"stages": PP_STAGES, "blocks_per_stage": 12 // PP_STAGES,
           "microbatches": PP_M, "microbatch_shape":
               [PP_BATCH // PP_M, PP_TOKENS, 768], "dtype": "float32",
           "fp32_rel_tol": FP32_REL_TOL,
           "sequential_loss": float(seq_loss.detach())}
    problems = []
    for sched, g in got.items():
        loss_err = abs(float(g["loss"]) - float(seq_loss)) \
            / abs(float(seq_loss))
        grad_err = max(_rel_err(g["grads"][k], seq_grads[k])
                       for k in seq_grads)
        other = got["1f1b" if sched == "gpipe" else "gpipe"]["grads"]
        cross = max(_rel_err(g["grads"][k], other[k]) for k in seq_grads)
        res[sched] = {"loss": float(g["loss"]), "loss_rel_err": loss_err,
                      "grad_rel_err_vs_sequential": grad_err,
                      "grad_rel_err_vs_other_schedule": cross,
                      "step_ms": g["ms"],
                      "peak_gib_above_inputs": g["peak_gib_above_inputs"]}
        if max(loss_err, grad_err, cross) > FP32_REL_TOL:
            problems.append(f"(a) {sched}: loss {loss_err}, grads "
                            f"{grad_err}, against the other {cross}")
    res["problems"] = problems
    return res


def phase_pp(state: dict) -> None:
    """Phase 24: GPipe/1F1B pipeline parallelism on the card (module
    notes)."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_imagenet
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import ModelParallelConfig, PipelineTrainer

    t0 = time.perf_counter()
    out = {"phase": "pp", "card": state["card"]}
    problems = []
    out["a_schedules"] = sched = _pp_schedules(state)
    problems += sched.pop("problems")
    torch.cuda.empty_cache()
    ds = synthetic_imagenet(n_train=PP_BATCH * 2, n_test=PP_BATCH,
                            num_classes=1000, image_size=224, seed=24)
    torch.cuda.reset_peak_memory_stats()
    trainer = PipelineTrainer(ds, ModelParallelConfig(
        model="vit_b16", num_workers=PP_STAGES, pp_microbatches=PP_M,
        batch_size=PP_BATCH, num_epochs=1, num_classes=1000,
        dtype="bfloat16", device="cuda"))
    res = _timed_trainer(trainer, ds, PP_TIMED_STEPS, profiled=1)
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["b_trainer"] = res
    if any(res["launches"].values()):
        problems.append(f"(b) kernels launched {res['launches']}: 197 "
                        f"tokens take the dense core and no codec")
    if not all(math.isfinite(v) for v in res["train_loss_per_epoch"]):
        problems.append(f"(b) losses {res['train_loss_per_epoch']}")
    del trainer
    torch.cuda.empty_cache()
    out["problems"] = problems
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if problems:
        raise RuntimeError(f"pp: {problems}")


TP_D, TP_HEADS, TP_MLP = 768, 12, 3072   # ViT-B/16's block
TP_BLOCK_BATCH, TP_TOKENS = 8, 197       # (a): 224 px with the CLS token
TP_DEGREES = (2, 4, 8)                   # (a): 8 splits inside a head
# (b): (data, model) in turns, the yardstick first and last.
TP_MESHES = ((1, 1), (2, 2), (1, 4), (1, 1))
TP_BATCH, TP_TRAIN_STEPS, TP_TIMED_STEPS = 32, 2, 3
TP_PP_TIMED_STEPS = 2                    # (c): the host-bound pipeline
BF16_REL_TOL = 2e-2                      # max |a - b| / max |b|, bf16 out
F64_REL_TOL = 1e-12                      # the same, both float64


def _tp_block_run(block, x, cot) -> list:
    """One block's output and the gradients of sum(out * cot) in x and
    every parameter (the block's order)."""
    import torch

    xx = x.detach().clone().requires_grad_()
    y = block(xx)
    grads = torch.autograd.grad((y.float() * cot.float()).sum(),
                                [xx, *block.parameters()])
    return [y.detach(), *grads]


def _tp_blocks(dtype, tp: int, device, seed: int = 25):
    """A ViT-B/16 ``EncoderBlock`` and its TP form at ``tp`` with the same
    weights (biases and LayerNorm affines drawn too), in ``dtype``."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.models \
        .vit import EncoderBlock, init_weights

    gen = torch.Generator().manual_seed(seed)
    plain = EncoderBlock(TP_D, TP_HEADS, TP_MLP // TP_D, dtype=dtype)
    init_weights(plain, gen)
    with torch.no_grad():
        for name, p in plain.named_parameters():
            if p.dim() == 1:
                p.normal_(1.0 if name.endswith("ln1.weight")
                          or name.endswith("ln2.weight") else 0.0, 0.05,
                          generator=gen)
    split = EncoderBlock(TP_D, TP_HEADS, TP_MLP // TP_D, dtype=dtype,
                         tp_degree=tp)
    split.load_state_dict(plain.state_dict())
    wide = torch.promote_types(dtype, torch.float32)
    return plain.to(device, wide), split.to(device, wide)


def _tp_slot_views(block, tp: int) -> list:
    """Problems with slot j's views of the block's parameters: each the
    rule table's shard shape, each a view of the parameter itself."""
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import tensor
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import flax_names, to_flax_layout

    problems = []
    names, _ = flax_names(block)
    for tname, fname in names.items():
        p = block.get_parameter(tname)
        leaf = to_flax_layout(p.detach(), fname)
        views = tensor.slot_views(leaf, fname, tp)
        spec = tensor.tp_spec_for_path(fname)
        want = list(leaf.shape)
        if "model" in spec:
            want[spec.index("model")] //= tp
        if list(views.shape) != [tp, *want] \
                or views.untyped_storage().data_ptr() \
                != p.untyped_storage().data_ptr():
            problems.append(f"(a) tp {tp} {fname}: views "
                            f"{list(views.shape)}, want [{tp}, {want}]")
    return problems


def _tp_block(state: dict) -> dict:
    """(a): one ViT-B/16 block, forward and backward, at tp 2, 4 and 8:
    float64 TP against unsplit on the card and card against CPU, fp32
    and bf16 TP against unsplit, slot views, bf16 fwd+bwd times."""
    import torch

    gen = torch.Generator().manual_seed(250)
    x = torch.randn(TP_BLOCK_BATCH, TP_TOKENS, TP_D, generator=gen)
    cot = torch.randn(TP_BLOCK_BATCH, TP_TOKENS, TP_D, generator=gen)
    res = {"batch": TP_BLOCK_BATCH, "tokens": TP_TOKENS, "d": TP_D,
           "heads": TP_HEADS, "mlp": TP_MLP, "float64_rel_tol": F64_REL_TOL,
           "fp32_rel_tol": FP32_REL_TOL, "bf16_rel_tol": BF16_REL_TOL,
           "measure": "max |a - b| / max |b| over the output and every "
                      "gradient (x and the parameters)"}
    problems = []
    for tp in TP_DEGREES:
        row = {}
        plain, split = _tp_blocks(torch.float64, tp, "cuda")
        problems += _tp_slot_views(split, tp)
        xc, cc = x.double().cuda(), cot.double().cuda()
        want = _tp_block_run(plain, xc, cc)
        got = _tp_block_run(split, xc, cc)
        row["float64_tp_vs_unsplit"] = max(_rel_err(g, w)
                                           for g, w in zip(got, want))
        _, split_cpu = _tp_blocks(torch.float64, tp, "cpu")
        t0 = time.perf_counter()
        cpu = _tp_block_run(split_cpu, x.double(), cot.double())
        row["cpu_float64_s"] = time.perf_counter() - t0
        row["float64_card_vs_cpu"] = max(_rel_err(g, c)
                                         for g, c in zip(got, cpu))
        del plain, split, want, got, cpu
        for name, dtype, tol in (("fp32", torch.float32, FP32_REL_TOL),
                                 ("bf16", torch.bfloat16, BF16_REL_TOL)):
            plain, split = _tp_blocks(dtype, tp, "cuda")
            xc, cc = x.to("cuda", dtype), cot.to("cuda", dtype)
            want = _tp_block_run(plain, xc, cc)
            got = _tp_block_run(split, xc, cc)
            row[f"{name}_tp_vs_unsplit"] = err = max(
                _rel_err(g, w) for g, w in zip(got, want))
            if err > tol:
                problems.append(f"(a) tp {tp} {name}: {err} > {tol}")
            if name == "bf16":
                row["bf16_fwd_bwd_ms"] = cuda_time_ms(
                    lambda: _tp_block_run(split, xc, cc), 10)
                if tp == TP_DEGREES[0]:
                    res["bf16_unsplit_fwd_bwd_ms"] = cuda_time_ms(
                        lambda: _tp_block_run(plain, xc, cc), 10)
            del plain, split, want, got
        for k in ("float64_tp_vs_unsplit", "float64_card_vs_cpu"):
            if not row[k] <= F64_REL_TOL:
                problems.append(f"(a) tp {tp} {k}: {row[k]}")
        res[f"tp{tp}"] = row
        torch.cuda.empty_cache()
    res["problems"] = problems
    return res


def _tp_glue_ms(tp: int, rows: int) -> float:
    """CUDA-event ms of one ViT-B/16 block's TP glue in bf16 at ``rows``
    tokens: forward, the qkv concatenation and the two slot sums (each
    with its bias and cast); backward, the concatenation's split and the
    two sums over the slots of the column products' input gradients."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import tensor

    bf = dict(device="cuda", dtype=torch.bfloat16)
    y_col = torch.randn(tp, rows, 3 * TP_D // tp, **bf)
    parts = [torch.randn(tp, rows, TP_D, device="cuda") for _ in range(2)]
    g_in = [torch.randn(tp, rows, TP_D, **bf) for _ in range(2)]
    g_qkv = torch.randn(rows, 3 * TP_D, **bf)
    bias = torch.randn(TP_D, **bf)

    def glue():
        tensor.gather_columns(y_col)
        for part in parts:
            (part.sum(0) + bias.float()).to(torch.bfloat16)
        g_qkv.view(rows, tp, -1).transpose(0, 1).contiguous()
        for g in g_in:
            g.sum(0)

    return cuda_time_ms(glue, 20)


def _tp_trainers(state: dict) -> dict:
    """(b): ``TPTrainer`` ViT-B/16 bf16 batch 32 at the three meshes."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_imagenet
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import ModelParallelConfig, TPTrainer

    ds = synthetic_imagenet(n_train=TP_BATCH * TP_TRAIN_STEPS,
                            n_test=TP_BATCH, num_classes=1000,
                            image_size=224, seed=25)
    out, problems = {}, []
    for turn, (dp, tp) in enumerate(TP_MESHES):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = TPTrainer(ds, ModelParallelConfig(
            model="vit_b16", num_workers=dp, tp_degree=tp,
            batch_size=TP_BATCH, num_epochs=1, num_classes=1000,
            dtype="bfloat16", device="cuda"))
        res = _timed_trainer(trainer, ds, TP_TIMED_STEPS)
        res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        res["mesh"] = trainer.mesh.shape
        res["label"] = trainer._label()
        busy = res["profiled_steps"]["device_busy_ms_per_step"]
        if tp > 1:
            glue = _tp_glue_ms(tp, TP_BATCH * TP_TOKENS) * 12
            res["glue_ms_per_step"] = glue
            res["glue_share_of_device_time"] = glue / busy if busy else None
        out[f"turn{turn}_dp{dp}_tp{tp}"] = res
        if any(res["launches"].values()):
            problems.append(f"(b) {dp}x{tp}: kernels launched "
                            f"{res['launches']}: 197 tokens take the dense "
                            f"core and no codec")
        if res["mesh"] != {"data": dp, "model": tp} \
                or res["metrics"]["tp_degree"] != tp \
                or not all(math.isfinite(v)
                           for v in res["train_loss_per_epoch"]):
            problems.append(f"(b) {dp}x{tp}: mesh {res['mesh']}, metrics "
                            f"{res['metrics']}")
        del trainer
    base = np.mean([res["step_ms_median"] for res in out.values()
                    if res["mesh"]["model"] == 1])
    for res in out.values():
        res["step_ms_vs_tp1"] = res["step_ms_median"] / base
    out["problems"] = problems
    return out


def _tp_moe(state: dict) -> dict:
    """(c) dp x ep: data 2 x 4 experts at ViT-B/16 width against the dense
    reference at a capacity that drops nothing, then ``MoETrainer``."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_imagenet
    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import make_mesh, moe
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import ModelParallelConfig, MoETrainer

    dp, n = 2, TP_BATCH * MOE_TOKENS
    gen = torch.Generator().manual_seed(251)
    params = {k: v.cuda() for k, v in moe.init_moe_params(
        gen, MOE_D, MOE_H, MOE_E).items()}
    tokens = torch.randn(n, MOE_D, generator=gen).cuda()
    mesh = make_mesh(dp, "cuda", axis_names=("data", "expert"),
                     num_slots=dp * MOE_E)
    generous = n // (dp * MOE_E)
    with torch.no_grad():
        out, st = moe.make_moe_ffn(mesh, generous, data_axis="data")(
            params, tokens)
        ref = moe.dense_reference(params, tokens)
    res = {"mesh": mesh.shape, "tokens": n, "generous_capacity": generous,
           "drop_frac": float(st["drop_frac"]),
           "dense_reference_rel_err": _rel_err(out, ref),
           "load_sum": float(st["load"].sum()),
           "importance_sum": float(st["importance"].sum())}
    problems = []
    if res["drop_frac"] != 0.0 \
            or res["dense_reference_rel_err"] > FP32_REL_TOL \
            or abs(res["load_sum"] - 1.0) > 1e-6 \
            or abs(res["importance_sum"] - 1.0) > 1e-5:
        problems.append(f"(c) dp x ep layer: {res}")
    del out, ref, params, tokens
    torch.cuda.empty_cache()
    ds = synthetic_imagenet(n_train=TP_BATCH * TP_TRAIN_STEPS,
                            n_test=TP_BATCH, num_classes=1000,
                            image_size=224, seed=251)
    torch.cuda.reset_peak_memory_stats()
    trainer = MoETrainer(ds, ModelParallelConfig(
        model="vit_b16", num_workers=MOE_E, dp_degree=dp,
        batch_size=TP_BATCH, num_epochs=1, num_classes=1000,
        dtype="bfloat16", device="cuda"))
    tr = _timed_trainer(trainer, ds, TP_TIMED_STEPS)
    tr["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    tr["mesh"] = trainer.mesh.shape
    tr["capacity"] = trainer.capacity
    tr["moe_metrics_last_step"] = {
        k: float(v) for k, v in trainer._moe_step_metrics[-1].items()}
    res["trainer"] = tr
    want_cap = max(8, int(2.0 * n / (dp * MOE_E) / MOE_E))
    if tr["mesh"] != {"data": dp, "expert": MOE_E} \
            or tr["capacity"] != want_cap \
            or any(tr["launches"].values()) \
            or not all(math.isfinite(v) for v in tr["train_loss_per_epoch"]):
        problems.append(f"(c) MoETrainer dp x ep: mesh {tr['mesh']}, "
                        f"capacity {tr['capacity']} (want {want_cap}), "
                        f"launches {tr['launches']}, losses "
                        f"{tr['train_loss_per_epoch']}")
    del trainer
    torch.cuda.empty_cache()
    res["problems"] = problems
    return res


def _pp_grads(trainer, x, y) -> tuple:
    """The pipelined model's loss on (x, y) and its parameter gradients,
    by name (one fp32 step's, before the apply)."""
    import torch
    import torch.nn.functional as F

    params = dict(trainer.model.named_parameters())
    loss = F.cross_entropy(trainer.model(x), y)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _tp_pp(state: dict) -> dict:
    """(c) dp x tp x pp: 2 x 2 x 4 stages x 8 microbatches, one fp32
    step's loss and gradients against plain pp on the card, then the bf16
    trainer timed."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_imagenet
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import ModelParallelConfig, PipelineTrainer

    ds = synthetic_imagenet(n_train=TP_BATCH * TP_TRAIN_STEPS,
                            n_test=TP_BATCH, num_classes=1000,
                            image_size=224, seed=252)

    def cfg(dp, tp, dtype):
        return ModelParallelConfig(
            model="vit_b16", num_workers=PP_STAGES, pp_microbatches=PP_M,
            dp_degree=dp, pp_tp_degree=tp, batch_size=TP_BATCH,
            num_epochs=1, num_classes=1000, dtype=dtype, device="cuda")

    gen = torch.Generator().manual_seed(252)
    x = torch.randn(TP_BATCH, 224, 224, 3, generator=gen).cuda()
    y = torch.randint(0, 1000, (TP_BATCH,), generator=gen).cuda()
    got, t0 = {}, time.perf_counter()
    for key, (dp, tp) in (("plain", (1, 1)), ("composed", (2, 2))):
        trainer = PipelineTrainer(ds, cfg(dp, tp, "float32"))
        got[key] = _pp_grads(trainer, x, y) + (trainer.mesh.shape,)
        del trainer
        torch.cuda.empty_cache()
    (l0, g0, m0), (l1, g1, m1) = got["plain"], got["composed"]
    res = {"mesh_plain": m0, "mesh_composed": m1,
           "loss_plain": float(l0), "loss_composed": float(l1),
           "loss_rel_err": abs(float(l1) - float(l0)) / abs(float(l0)),
           "grad_rel_err": max(_rel_err(g1[k], g0[k]) for k in g0),
           "fp32_rel_tol": FP32_REL_TOL,
           "fp32_check_seconds": time.perf_counter() - t0}
    problems = []
    if m1 != {"data": 2, "model": 2, "stage": PP_STAGES} \
            or max(res["loss_rel_err"], res["grad_rel_err"]) \
            > FP32_REL_TOL:
        problems.append(f"(c) dp x tp x pp fp32 step: {res}")
    del got, g0, g1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = PipelineTrainer(ds, cfg(2, 2, "bfloat16"))
    tr = _timed_trainer(trainer, ds, TP_PP_TIMED_STEPS, profiled=1)
    tr["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    tr["label"] = trainer._label()
    res["trainer"] = tr
    if any(tr["launches"].values()) \
            or not all(math.isfinite(v) for v in tr["train_loss_per_epoch"]):
        problems.append(f"(c) PipelineTrainer 2x2x4: launches "
                        f"{tr['launches']}, losses "
                        f"{tr['train_loss_per_epoch']}")
    del trainer
    torch.cuda.empty_cache()
    res["problems"] = problems
    return res


def phase_tp(state: dict) -> None:
    """Phase 25: tensor parallelism and the multi-axis mesh on the card
    (module notes)."""
    import torch

    t0 = time.perf_counter()
    out = {"phase": "tp", "card": state["card"]}
    problems = []
    for key, part in (("a_block", _tp_block), ("b_trainers", _tp_trainers),
                      ("c_dp_ep", _tp_moe), ("c_dp_tp_pp", _tp_pp)):
        t1 = time.perf_counter()
        out[key] = res = part(state)
        res["seconds"] = time.perf_counter() - t1
        problems += res.pop("problems")
        torch.cuda.empty_cache()
    out["problems"] = problems
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if problems:
        raise RuntimeError(f"tp: {problems}")


# Phase 26: the sharded parameter-server tier and the C++ arena.
SHARDS = 2
SHARD_PUSHES = 4          # real gradient sets: 4 batches of 128 images


def _shard_gradients(n: int, seed: int):
    """``n`` real ResNet-18 gradient sets on the card (one bf16 grad step
    each over its own batch of 128, from the same params), the initial
    params and the model's flat names."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .steps import make_grad_step
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import params_to_jax

    ds, model, _, init = main_path(-(-n // N_WORKERS), 10, seed)
    grad_step = make_grad_step(model, augment=False)
    params = {k: torch.from_numpy(v).cuda() for k, v in init.items()}
    _, stats = params_to_jax(model)
    stats = {k: torch.from_numpy(v).cuda() for k, v in stats.items()}
    grads = [grad_step(params, stats, ds.x_train[i:i + BATCH],
                       ds.y_train[i:i + BATCH])[0]
             for i in range(0, n * BATCH, BATCH)]
    return [{k: v.float() for k, v in g.items()} for g in grads], init


def _shard_topology(init: dict, make_store, make_service=None):
    """``SHARDS`` shard primaries, each serving its ``partition_keys``
    share of ``init`` from ``make_store(params, shard_index=,
    shard_count=)`` through ``make_service(store)`` (a plain
    ``ParameterService`` by default), and one unsharded primary over all
    of it, every one on 127.0.0.1:0 in this process. Returns (shard
    stores, their services, their servers, their addresses, the
    unsharded store, its server, its address)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import ParameterService, serve
    from distributed_parameter_server_for_ml_training_tpu_torch.ps \
        .sharding import ShardInfo, partition_keys

    parts = partition_keys(init, SHARDS)
    stores, svcs, servers, addrs = [], [], [], []
    for i in range(SHARDS):
        store = make_store({k: init[k] for k in parts[i]}, shard_index=i,
                           shard_count=SHARDS)
        svc = (make_service or ParameterService)(store)
        server, port = serve(store, port=0, service=svc, host="127.0.0.1")
        stores.append(store)
        svcs.append(svc)
        servers.append(server)
        addrs.append(f"127.0.0.1:{port}")
    for i, svc in enumerate(svcs):
        # As ``cli serve`` builds it: the map publishes the service's
        # in-flight migration.
        svc.sharding = ShardInfo(i, SHARDS, addrs)
        svc.sharding.migration_provider = svc.migration_view
    one = make_store(init)
    one_server, one_port = serve(one, port=0, host="127.0.0.1")
    return (stores, svcs, servers, addrs, one, one_server,
            f"127.0.0.1:{one_port}")


#: The scripted sequences of (a), from two workers: (op, worker, index of
#: the gradient set). A push carries the step its worker last fetched, as
#: PSWorker's do; in async, worker 0's third push is 2 steps stale.
SHARD_SCRIPTS = {
    "async": [("fetch", 0, None), ("fetch", 1, None), ("push", 1, 0),
              ("fetch", 1, None), ("push", 1, 1), ("fetch", 1, None),
              ("push", 0, 2), ("push", 1, 3), ("fetch", 0, None)],
    "sync": [("fetch", 0, None), ("fetch", 1, None), ("push", 0, 0),
             ("push", 1, 1), ("fetch", 0, None)],
}


def _union_diff(stores, one) -> list:
    """Tensors where the union of the shards' params differs bit-wise
    from the unsharded store's (a name missing or extra counts)."""
    union = {}
    for s in stores:
        union.update(s.snapshot()[0])
    ref, _ = one.snapshot()
    if sorted(union) != sorted(ref):
        return sorted(set(union) ^ set(ref))
    return [k for k in ref if union[k].tobytes() != ref[k].tobytes()]


def _sharded_script(init, grads, mode: str, codec: str, failures: list):
    """One scripted sequence through a ``ShardedRemoteStore`` over two
    shard primaries and through a ``RemoteStore`` over one unsharded
    primary. codec ``none``: device stores on the card, fp32 pushes;
    ``int8``: host stores taking the int8 wire codec (the device store
    takes no wire codec), each worker's pushes encoded once by its own
    ``DeviceCodec`` (K1) and sent to both. After every push the union of
    the shards must be bit-equal to the unsharded store."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import RemoteStore
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .sharded import ShardedRemoteStore
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        DeviceParameterStore, ParameterStore, StoreConfig)

    def make_store(params, **kw):
        cfg = StoreConfig(mode=mode, total_workers=N_WORKERS,
                          staleness_bound=5,
                          push_codec="int8" if codec == "int8" else None,
                          **kw)
        if codec == "int8":
            return ParameterStore(params, cfg)
        return DeviceParameterStore(params, cfg, device="cuda")

    stores, _, servers, addrs, one, one_server, one_addr = _shard_topology(
        init, make_store)
    codecs = [DeviceCodec() for _ in range(N_WORKERS)]
    fan = [ShardedRemoteStore(addrs) for _ in range(N_WORKERS)]
    ref = [RemoteStore(one_addr) for _ in range(N_WORKERS)]
    shard_ms = [{} for _ in range(SHARDS)]
    one_ms: dict = {}
    for f in fan:
        for i, s in enumerate(f._stores):
            _rpc_timer(s, shard_ms[i])
    for r in ref:
        _rpc_timer(r, one_ms)
    outcomes, diffs = [], []
    try:
        ids = [(f.register_worker(f"w{w}")[0], r.register_worker(
            f"w{w}")[0]) for w, (f, r) in enumerate(zip(fan, ref))]
        steps = [0] * N_WORKERS
        for op, w, gi in SHARD_SCRIPTS[mode]:
            if op == "fetch":
                p1, s1 = fan[w].fetch(ids[w][0])
                p2, s2 = ref[w].fetch(ids[w][1])
                steps[w] = s2
                outcomes.append(("fetch", s1, s2))
                if sorted(p1) != sorted(p2) or any(
                        p1[k].tobytes() != p2[k].tobytes() for k in p2):
                    failures.append(f"{mode}/{codec}: fetched params "
                                    f"differ at step {s2}")
                continue
            if codec == "int8":
                payload = codecs[w].encode_now(grads[gi])
            else:
                payload = {k: v.cpu().numpy() for k, v in grads[gi].items()}
            outcomes.append(("push", fan[w].push(ids[w][0], payload,
                                                 steps[w]),
                             ref[w].push(ids[w][1], payload, steps[w])))
            diffs.append(_union_diff(stores, one))
        for w in range(N_WORKERS):
            fan[w].job_finished(ids[w][0])
            ref[w].job_finished(ids[w][1])
    finally:
        for c in fan + ref:
            c.close()
        for s in servers + [one_server]:
            s.stop(grace=None).wait(10)
    want_step = 4 if mode == "async" else 1
    steps_now = [s.global_step for s in stores] + [one.global_step]
    if any(o[1] != o[2] or o[1] is False for o in outcomes):
        failures.append(f"{mode}/{codec}: outcomes differ: {outcomes}")
    if any(diffs) or steps_now != [want_step] * (SHARDS + 1):
        failures.append(f"{mode}/{codec}: union differs {diffs}, steps "
                        f"{steps_now}")
    med = lambda d: {k: float(np.median(v))  # noqa: E731
                     for k, v in sorted(d.items())}
    return {"outcomes": outcomes,
            "union_bit_equal_after_each_push": [not d for d in diffs],
            "steps": steps_now,
            "shard_rpc_ms_median": [med(d) for d in shard_ms],
            "unsharded_rpc_ms_median": med(one_ms),
            "store_backend": stores[0].store_backend}


def _sharded_in_process(state: dict, failures: list) -> dict:
    """(a) Sharded against unsharded in one process, on real gradients."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps \
        .sharding import partition_keys

    grads, init = _shard_gradients(SHARD_PUSHES, 26)
    torch.cuda.synchronize()
    parts = partition_keys(init, SHARDS)
    owned = [{"shard": i, "tensors": len(p),
              "bytes": int(sum(init[k].nbytes for k in p))}
             for i, p in enumerate(parts)]
    out = {"owned": owned, "tensors": len(init),
           "bytes": int(sum(v.nbytes for v in init.values()))}
    Q.wire_quantize_multi.launches = 0
    int8_pushes = 0
    for codec in ("none", "int8"):
        for mode in ("async", "sync"):
            r = _sharded_script(init, grads, mode, codec, failures)
            out[f"{mode}_{codec}"] = r
            if codec == "int8":
                int8_pushes += sum(o[0] == "push" for o in r["outcomes"])
    launches = Q.wire_quantize_multi.launches
    want = -(-len(init) // Q.WIRE_MAX_ENTRIES) * int8_pushes
    state["sharded_k1_launches"] = {"wire_quantize_multi": launches}
    out["k1_launches"] = launches
    out["k1_launches_expected"] = want
    if launches != want:
        failures.append(f"K1 launched {launches} times for {int8_pushes} "
                        f"int8 pushes; expected {want}")
    return out


def _read_lines(pipe, out: list) -> None:
    """Append ``(perf_counter, line)`` for every line of ``pipe``, then
    ``(perf_counter, None)`` at its end (the process closed it: exited)."""
    for line in iter(pipe.readline, ""):
        out.append((time.perf_counter(), line))
    out.append((time.perf_counter(), None))


def _lines_text(lines: list) -> str:
    return "".join(line for _, line in lines if line is not None)


def _cli_topology(servers: list, workers: list, profiles=None,
                  probe=None, env_extra=None) -> dict:
    """``cli serve`` processes (``servers``: argv tails, each with its
    ``--port``) and, once every server printed its 'up' line, ``cli
    worker`` processes (argv tails), on the card; everything killed at its
    timeout. (Started together, a worker whose server comes up more than
    15 s after its first try fails its registration: ``RemoteStore``
    retries 5 times, backoff from 1 s.) With ``profiles``, worker i runs
    under ``--profile-dir <profiles>/w<i>``. ``probe()`` runs on a thread
    of its own from the 'up' lines on, while the workers train; its
    result (or what it raised) is returned. Every line a server writes to
    stderr and a worker to stdout is read as it comes, with its time.
    Returns exit codes, each process's METRICS_JSON rows and output
    tails, the wall seconds and the wall's split: spawn to 'up', each
    worker's spawn to its epoch's start, its epoch, its epoch's end to
    its exit, and the last worker's exit to each server's. ``env_extra``
    is added to every process's environment."""
    import os
    import re
    import tempfile
    import threading

    cli = [sys.executable, "-m",
           "distributed_parameter_server_for_ml_training_tpu_torch.cli"]
    repo = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(repo), **(env_extra or {})}
    logs = [tempfile.TemporaryFile("w+")
            for _ in range(len(servers) + len(workers))]
    srv_lines = [[] for _ in servers]
    wrk_lines = [[] for _ in workers]
    procs, srv, wrk, readers, late = [], [], [], [], None
    t_spawn, t_up, t_wspawn = [], [], []
    probed, prober = {}, None

    def start(argv, stdout, stderr, lines) -> subprocess.Popen:
        p = subprocess.Popen(argv, cwd=repo, env=env, stdout=stdout,
                             stderr=stderr, text=True)
        procs.append(p)
        readers.append(threading.Thread(
            target=_read_lines, args=(p.stderr if stderr is subprocess.PIPE
                                      else p.stdout, lines), daemon=True))
        readers[-1].start()
        return p

    def run_probe():
        try:
            probed["result"] = probe()
        except Exception as e:  # noqa: BLE001 — returned to the caller
            probed["error"] = e
            probed["traceback"] = traceback.format_exc()

    t0 = time.perf_counter()
    try:
        for i, argv in enumerate(servers):
            t_spawn.append(time.perf_counter())
            srv.append(start(cli + ["serve", *argv, "--emit-metrics"],
                             logs[i], subprocess.PIPE, srv_lines[i]))
        for i, lines in enumerate(srv_lines):
            up = None
            while up is None:
                for t, line in list(lines):
                    if line is None:
                        up = False
                        break
                    if re.search(r"parameter server up on :(\d+)", line):
                        up = t
                        break
                if up is None:
                    if time.perf_counter() - t0 > GRPC_WORKER_TIMEOUT_S:
                        up = False
                    time.sleep(0.01)
            t_up.append(up or None)
            if not up:
                late = f"a cli serve never came up: " \
                       f"{_lines_text(lines)[-1500:]}"
        if late is None and probe is not None:
            prober = threading.Thread(target=run_probe, daemon=True)
            prober.start()
        if late is None:
            for i, argv in enumerate(workers):
                extra = ["--profile-dir", os.path.join(profiles, f"w{i}")] \
                    if profiles else []
                t_wspawn.append(time.perf_counter())
                wrk.append(start(
                    cli + ["worker", *argv, "--emit-metrics", *extra],
                    subprocess.PIPE, logs[len(servers) + i], wrk_lines[i]))
            deadline = time.perf_counter() + GRPC_WORKER_TIMEOUT_S
            for w in wrk:
                try:
                    w.wait(timeout=max(1.0, deadline - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    late = f"a cli worker still alive after " \
                           f"{GRPC_WORKER_TIMEOUT_S} s"
                    break
        if late is None:
            for p in srv:
                try:
                    p.wait(timeout=GRPC_SERVER_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    late = f"cli serve still alive " \
                           f"{GRPC_SERVER_TIMEOUT_S} s after its workers"
                    break
        wall = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if prober is not None:
            prober.join(GRPC_SERVER_TIMEOUT_S)
        for r in readers:
            r.join(10)
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    n = len(servers)
    wtexts = [_lines_text(lines) for lines in wrk_lines]
    worker_rows = [_metrics_rows(t) for t in wtexts]
    split = None
    if late is None and all(worker_rows) and all(t_up):
        exits = [lines[-1][0] for lines in wrk_lines]
        done = [next(t for t, line in lines
                     if line is not None and "EPOCH_DONE" in line)
                for lines in wrk_lines]
        epoch = [rows[-1]["epoch_times_seconds"][0] for rows in worker_rows]
        split = {
            "spawn_to_up_s": [u - s for u, s in zip(t_up, t_spawn)],
            "up_to_worker_spawn_s": t_wspawn[0] - max(t_up),
            # The epoch's start is its end less the epoch's seconds and
            # its eval (EPOCH_DONE comes after the eval).
            "worker_spawn_to_epoch_start_s": [
                d - e - s for d, e, s in zip(done, epoch, t_wspawn)],
            "epoch_s": epoch,
            "epoch_end_to_exit_s": [x - d for x, d in zip(exits, done)],
            "last_worker_exit_to_server_exit_s": [
                lines[-1][0] - max(exits) for lines in srv_lines]}
    if prober is not None and prober.is_alive():
        probed["error"] = AssertionError(
            f"the probe still ran {GRPC_SERVER_TIMEOUT_S} s after the "
            f"topology ended")
    out = {"rcs": {"servers": [p.returncode for p in srv],
                   "workers": [p.returncode for p in wrk]},
           "server_rows": [_exit_rows(_metrics_rows(t)) for t in texts[:n]],
           "server_err": [_lines_text(lines) for lines in srv_lines],
           "server_out": texts[:n],
           "worker_rows": worker_rows,
           "worker_err": [texts[n + i][-2000:] for i in range(len(wrk))],
           "wall_seconds": wall, "wall_split": split, "late": late,
           "probe": probed}
    return out


def _exit_rows(rows: list) -> list:
    """A process's METRICS_JSON exit rows: without the ``kind`` records
    (snapshots, cluster records) that ``--telemetry`` adds."""
    return [r for r in rows if "kind" not in r]


def _worker_img_s(rows: list) -> list:
    return [r[-1]["local_steps_completed"] * BATCH
            / r[-1]["total_training_time_seconds"]
            for r in rows if r and r[-1]["total_training_time_seconds"]]


def _sharded_processes(state: dict, failures: list) -> dict:
    """(b) Two ``cli serve --shard-count 2`` primaries and two ``cli
    worker --shards`` processes on the card, each worker under
    ``--profile-dir`` (its K1 events and device busy time). Primary 1
    runs the replica autoscaler (``SERVE_AUTOSCALE``) and phase 28 (a)'s
    probe runs beside phase 27 (a)'s."""
    import os
    import shutil
    import tempfile

    from distributed_parameter_server_for_ml_training_tpu_torch.analysis \
        import attribute_profile, load_chrome_trace, top_device_ops
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        .profiler import find_profile_dumps

    ports = [_free_port() for _ in range(SHARDS)]
    metrics_ports = [_free_port() for _ in range(SHARDS)]
    peers = ",".join(f"127.0.0.1:{p}" for p in ports)
    # Phase 27 (a) observes the primaries: their telemetry and metrics
    # ports, with the fetch objective a healthy run keeps.
    servers = [["--mode", "async", "--workers", "2", "--push-codec", "int8",
                "--shard-count", str(SHARDS), "--shard-index", str(i),
                "--shard-peers", peers, "--port", str(ports[i]),
                "--telemetry", "--metrics-port", str(metrics_ports[i]),
                "--slo-fetch-p99-ms", str(FLEET_SLO_P99_MS)]
               + (SERVE_AUTOSCALE if i == 1 else [])
               for i in range(SHARDS)]
    workers = [["--shards", peers, "--worker-name", f"shard-w{i}",
                "--synthetic", "--num-train", "2048", "--num-test", "256",
                "--epochs", "1"]
               for i in range(N_WORKERS)]
    profiles = tempfile.mkdtemp(prefix="sharded-profiles-")
    fleet: dict = {}
    tier: dict = {}
    state["fleet_peers"] = peers.split(",")

    def probe():
        checked = threading.Event()
        serve = threading.Thread(target=serve_tier_probe, args=(
            peers.split(","), metrics_ports, checked, tier), daemon=True)
        serve.start()
        try:
            return _fleet_probe(metrics_ports, peers.split(","),
                                os.path.join(profiles, "fleet-journal"),
                                fleet, checked) or fleet
        finally:
            serve.join(GRPC_SERVER_TIMEOUT_S)

    def serve_tier_probe(*args):
        try:
            _serve_tier_probe(*args)
        except Exception as e:  # noqa: BLE001 — read by phase 28
            tier["error"] = repr(e)
            tier["traceback"] = traceback.format_exc()

    try:
        run = _cli_topology(
            servers, workers, profiles, probe=probe,
            env_extra={"DPS_REPLICA_POLL": str(SERVE_EARLY_POLL_S)})
        state["fleet_probe"] = run["probe"]
        state["serve_tier_probe"] = tier
        state["serve_tier_topology"] = {"p1_out": "\n".join(
            ln for ln in run["server_out"][1].splitlines()
            if ln.startswith("REPLICA_POOL_"))}
        captures = []
        for i, rows in enumerate(run["worker_rows"]):
            logdir = os.path.join(profiles, f"w{i}")
            try:
                prof = attribute_profile(logdir)["profile"]
                k1 = sum(op["events"] for path in find_profile_dumps(logdir)
                         for op in top_device_ops(load_chrome_trace(path),
                                                  10 ** 6)
                         if "wire_quantize_multi_kernel" in op["name"])
            except Exception as e:  # noqa: BLE001 — reported below
                prof, k1 = {"error": repr(e)}, None
            train_s = rows[-1]["total_training_time_seconds"] if rows \
                else None
            busy = prof.get("total_attributed_s")
            captures.append({
                "worker": i, "k1_kernel_events": k1,
                "pushes": rows[-1]["rpc_counts"].get("PushGradrients")
                if rows else None,
                "device_busy_s": busy, "train_s": train_s,
                "idle_share": 1 - busy / train_s if busy and train_s
                else None, "basis": prof.get("basis")})
    finally:
        shutil.rmtree(profiles, ignore_errors=True)
    img_s = _worker_img_s(run["worker_rows"])
    shard_rows = [r[-1] if r else {} for r in run["server_rows"]]
    out = {"rcs": run["rcs"], "wall_seconds": run["wall_seconds"],
           "wall_split": run["wall_split"],
           "workers_img_per_s": img_s, "img_per_s_summed": sum(img_s),
           "shard_global_steps": [r.get("global_steps_completed")
                                  for r in shard_rows],
           "shard_lines": [next((ln for ln in e.splitlines()
                                 if "owning" in ln), None)
                           for e in run["server_err"]],
           "worker_captures": captures,
           "worker_metrics": [r[-1] if r else None
                              for r in run["worker_rows"]],
           "phase14b_unsharded_profiled": state.get("grpc_b_profiled")}
    steps = [r[-1]["local_steps_completed"] if r else 0
             for r in run["worker_rows"]]
    if run["late"] or run["rcs"] != {"servers": [0] * SHARDS,
                                     "workers": [0] * N_WORKERS}:
        failures.append(f"(b) {run['late']} rcs {run['rcs']}: "
                        f"{run['worker_err']} {run['server_err']}")
    elif out["shard_global_steps"] != [sum(steps)] * SHARDS:
        failures.append(f"(b) shard steps {out['shard_global_steps']}, "
                        f"worker steps {steps}")
    for c, s in zip(captures, steps):
        # One K1 launch a push: each worker quantizes its whole push once,
        # then the fan-out splits it; a push goes to both shards.
        if c["k1_kernel_events"] != s or c["pushes"] != SHARDS * s:
            failures.append(f"(b) worker capture {c}, {s} steps")
    return out


def _file_digests(paths) -> dict:
    import hashlib
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in paths}


def _arena_build() -> dict:
    """(c) The C++ arena built from the checkout's source (before any
    process of (c) loads it), with the tracked ``native/`` files' digests
    taken first."""
    from distributed_parameter_server_for_ml_training_tpu_torch.native \
        import bindings as B

    repo = Path(__file__).resolve().parent
    tracked = [repo / "native" / n
               for n in ("ps_core.cpp", "Makefile", "libps_core.so")]
    before = _file_digests(tracked)
    t0 = time.perf_counter()
    B.load_library()
    return {"library": str(B.LIBRARY.relative_to(repo)),
            "build_seconds": time.perf_counter() - t0,
            "compiler": B._compiler(), "tracked": tracked,
            "before": before}


def _arena_cli(failures: list) -> dict:
    """(c) One ``cli serve --store-backend native`` with one ``cli
    worker`` on the card, 4 steps."""
    port = _free_port()
    run = _cli_topology(
        [["--store-backend", "native", "--mode", "async", "--workers", "1",
          "--push-codec", "int8", "--port", str(port)]],
        [["--server", f"127.0.0.1:{port}", "--worker-name", "arena-w0",
          "--synthetic", "--num-train", "512", "--num-test", "256",
          "--epochs", "1"]])
    srow = run["server_rows"][0][-1] if run["server_rows"][0] else {}
    out = {"rcs": run["rcs"], "wall_seconds": run["wall_seconds"],
           "server": srow, "workers_img_per_s":
           _worker_img_s(run["worker_rows"])}
    if run["late"] or run["rcs"] != {"servers": [0], "workers": [0]} \
            or srow.get("store_backend") != "native" \
            or srow.get("global_steps_completed") != 4:
        failures.append(f"(c) cli: {run['late']} {out} "
                        f"{run['worker_err']} {run['server_err']}")
    return out


def _arena(state: dict, grads: list, init: dict, failures: list,
           built: dict) -> dict:
    """(c) The C++ arena on the GPU host, built from the checkout's
    source (``built``): scripted sequences against the NumPy store."""
    from distributed_parameter_server_for_ml_training_tpu_torch.native \
        import NativeParameterStore, bindings as B
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .compression import fp16_compress, int8_wire_compress
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig, staleness_weight)

    out = {k: built[k] for k in ("library", "build_seconds", "compiler")}
    host = [{k: v.cpu().numpy() for k, v in g.items()} for g in grads]
    # (worker, gradient set, fetched step) of each push; async bound 1:
    # the third push is 1 step stale (down-weighted), the fourth 2
    # (refused).
    pushes = {"async": [(0, 0, 0), (1, 1, 1), (0, 2, 1), (1, 3, 1)],
              "sync": [(0, 0, 0), (1, 1, 0), (0, 2, 1), (1, 3, 1)]}
    seqs = {}
    for mode, codec in (("async", "fp16"), ("async", "int8"),
                        ("sync", "fp16"), ("sync", "int8")):
        cfg = dict(mode=mode, total_workers=2, push_codec=codec,
                   staleness_bound=1)
        arena = NativeParameterStore(init, StoreConfig(**cfg))
        # The arena decodes each push as it arrives; so does the NumPy
        # store without its compressed-domain rounds.
        numpy_store = ParameterStore(init, StoreConfig(
            **cfg, compressed_domain=False))
        # The arena's own int8 apply in NumPy: p - (lr·w·scale)·q, in
        # the order ps_core.cpp computes it (the NumPy store dequantizes
        # first: q·scale, then lr·w times that).
        replica = {k: v.copy() for k, v in init.items()}
        rets = []
        for w, gi, fetched in pushes[mode]:
            payload = (fp16_compress(host[gi]) if codec == "fp16"
                       else int8_wire_compress(host[gi]))
            staleness = arena.global_step - fetched
            r = (arena.push(w, payload, fetched),
                 numpy_store.push(w, payload, fetched))
            rets.append(r)
            if mode == "async" and codec == "int8" and r[0]:
                lrw = np.float32(float(np.float32(0.1))
                                 * staleness_weight(staleness))
                for k in replica:
                    scale = np.float32(lrw * np.float32(
                        payload[k + "::int8scale"].reshape(-1)[0]))
                    replica[k] = replica[k] - scale * payload[k].astype(
                        np.float32)
        a, step = arena.snapshot()
        b, nstep = numpy_store.snapshot()
        exact = all(a[k].tobytes() == b[k].tobytes() for k in a)
        row = {"returns": rets, "steps": [step, nstep],
               "bit_equal_to_numpy_store": exact,
               "mismatched_vs_numpy_store": int(sum(
                   (a[k] != b[k]).sum() for k in a)),
               "max_abs_diff_vs_numpy_store": max(
                   float(np.abs(a[k] - b[k]).max()) for k in a)}
        if mode == "async" and codec == "int8":
            # Bit-equal to the arena's own order; within the JAX suite's
            # arena-vs-NumPy tolerance of the NumPy store's order.
            row["bit_equal_to_arena_order_replica"] = all(
                a[k].tobytes() == replica[k].tobytes() for k in a)
            row["numpy_store_within_rtol_1e-6_atol_1e-7"] = all(
                np.allclose(a[k], b[k], rtol=1e-6, atol=1e-7) for k in a)
            ok = row["bit_equal_to_arena_order_replica"] \
                and row["numpy_store_within_rtol_1e-6_atol_1e-7"]
        else:
            ok = exact
        want = [(True, True), (True, True), (True, True), (False, False)] \
            if mode == "async" else [(True, True)] * 4
        if not ok or rets != want or step != nstep:
            failures.append(f"(c) {mode}/{codec}: {row}")
        seqs[f"{mode}_{codec}"] = row
    out["sequences"] = seqs
    return out


def _arena_tracked(built: dict, failures: list) -> dict:
    """(c) After the arena's build and its processes: the tracked
    ``native/`` files unchanged, the library under ``build/``."""
    import os

    from distributed_parameter_server_for_ml_training_tpu_torch.native \
        import bindings as B

    repo = Path(__file__).resolve().parent
    tracked, before = built["tracked"], built["before"]
    out = {}
    after = _file_digests(tracked)
    out["tracked_native_unchanged"] = after == before
    git = subprocess.run(["git", "status", "--porcelain", "native/"],
                         cwd=repo, capture_output=True, text=True)
    out["git_status_native"] = git.stdout if git.returncode == 0 \
        else f"no git checkout (rc {git.returncode})"
    if after != before or (git.returncode == 0 and git.stdout):
        failures.append(f"(c) native/ changed: {before} -> {after}, "
                        f"{git.stdout!r}")
    if not B.LIBRARY.is_file() or os.path.commonpath(
            [str(B.LIBRARY), str(repo / "build")]) != str(repo / "build"):
        failures.append(f"(c) library at {B.LIBRARY}")
    return out


def phase_sharded(state: dict) -> None:
    """Phase 26: the sharded parameter-server tier and the C++ arena.
    (c)'s ``cli`` topology runs on a thread from the start, beside (a)
    and (c)'s in-process sequences (its processes spend most of their
    time importing torch), and ends before (b) starts."""
    failures: list = []
    t0 = time.perf_counter()
    built = _arena_build()
    c_cli: dict = {}
    c_failures: list = []

    def arena_cli() -> None:
        t = time.perf_counter()
        try:
            c_cli.update(_arena_cli(c_failures))
        except Exception as e:  # noqa: BLE001 — reported, fails it
            traceback.print_exc()
            c_failures.append(f"(c) cli raised {e!r}")
        c_cli["seconds"] = time.perf_counter() - t

    c_thread = threading.Thread(target=arena_cli, daemon=True)
    c_thread.start()
    a = _sharded_in_process(state, failures)
    ta = time.perf_counter() - t0
    emit({"phase": "sharded", "form": "a_in_process", **a,
          "seconds": ta, "card": state["card"]})
    t2 = time.perf_counter()
    grads, init = _shard_gradients(SHARD_PUSHES, 27)
    c = _arena(state, grads, init, failures, built)
    c_thread.join(GRPC_WORKER_TIMEOUT_S + GRPC_SERVER_TIMEOUT_S + 60)
    if c_thread.is_alive():
        c_failures.append("(c) cli did not end")
    failures.extend(c_failures)
    c["cli"] = c_cli
    c.update(_arena_tracked(built, failures))
    emit({"phase": "sharded", "form": "c_arena", **c,
          "seconds": time.perf_counter() - t2, "card": state["card"]})
    t1 = time.perf_counter()
    b = _sharded_processes(state, failures)
    emit({"phase": "sharded", "form": "b_processes", **b,
          "seconds": time.perf_counter() - t1, "card": state["card"]})
    emit({"phase": "sharded", "form": "summary",
          "seconds": time.perf_counter() - t0, "failures": failures,
          "card": state["card"]})
    if failures:
        raise AssertionError(f"phase 26: {failures}")


# -- phase 27: the fleet observatory, incident forensics, the experiments -----

FLEET_TICK_S = 0.1         # (a): seconds between the collector's ticks
FLEET_SLO_P99_MS = 60000   # (a), (b): the fetch objective a healthy run keeps
FLEET_STEPS = 16           # (a): each primary's step at the topology's end
FLEET_EXPERIMENT_TRAIN = 512   # (c): 2 steps a worker at batch 128


def _prom_count(text: str, name: str, method: str) -> int:
    """``<name>_count{method="<method>"}`` off a ``/metrics`` text."""
    import re
    m = re.search(rf'^{name}_count{{[^}}]*method="{method}"[^}}]*}} (\S+)$',
                  text, re.M)
    if m is None:
        raise AssertionError(f"no {name}_count for {method} in /metrics")
    return int(float(m.group(1)))


def _raise_in(thread, exc) -> None:
    """Deliver ``exc`` to ``thread`` at its next bytecode, as Ctrl-C
    reaches a process's main loop (``cli observe`` runs until then)."""
    import ctypes
    ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread.ident), ctypes.py_object(exc))


def _fleet_probe(metrics_ports: list, peers: list, journal_dir: str,
                 out: dict, checked=None) -> None:
    """(a): while phase 26 (b)'s primaries serve, a ``FleetCollector`` with
    ``start_fleet_server`` ticks over their metrics ports, and ``cli
    observe`` runs on a thread of this process; ``status --via-fleet``,
    ``top --url --json`` and ``goodput`` are asked once both primaries
    are training, and the merged fetch histogram is held to the
    primaries' own ``/metrics`` counts at one scrape. The collector ticks
    until both primaries report step ``FLEET_STEPS``; then ``observe`` is
    stopped and ``top --replay`` reads its journal. Fills ``out``. The
    event ``checked`` (phase 28 (a) waits on it before it loads the
    primaries) is set once the merged count and the verbs were read, or
    when the probe ends."""
    import urllib.request

    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import (FleetCollector, MetricsRegistry, default_objectives,
                start_fleet_server)

    targets = [f"127.0.0.1:{p}" for p in metrics_ports]
    fetch = "dps_rpc_server_latency_seconds"
    collector = FleetCollector(
        targets, interval_s=FLEET_TICK_S, timeout_s=5.0,
        registry=MetricsRegistry(),
        objectives=default_objectives(fetch_p99_ms=FLEET_SLO_P99_MS))
    server, port = start_fleet_server(collector, port=0, addr="127.0.0.1")
    observe_port = _free_port()
    observed = {}

    def observe():
        try:
            observed["rc"] = cli.main([
                "observe", "--targets", ",".join(targets), "--port",
                str(observe_port), "--interval", str(FLEET_TICK_S),
                "--timeout", "5", "--slo-fetch-p99-ms",
                str(FLEET_SLO_P99_MS), "--journal-dir", journal_dir])
        except BaseException as e:  # noqa: BLE001 — reported below
            observed["error"] = repr(e)

    def cli_out(argv):
        with _thread_stdout() as buf:
            rc = cli.main(argv)
        return rc, buf.getvalue()

    def metrics_counts():
        total = 0
        for p in metrics_ports:
            with urllib.request.urlopen(f"http://127.0.0.1:{p}/metrics",
                                        timeout=5) as r:
                total += _prom_count(r.read().decode(), fetch,
                                     "FetchParameters")
        return total

    watcher = threading.Thread(target=observe, daemon=True)
    watcher.start()
    steps_seen, ticks, verbs = [], 0, None
    t0 = time.perf_counter()
    try:
        while True:
            res = collector.tick()
            ticks += 1
            view = collector.view()
            rows = view["tiers"]["primaries"]
            if res["failed"]:
                raise AssertionError(
                    f"a scrape failed before both primaries reached step "
                    f"{FLEET_STEPS} (steps seen {steps_seen[-3:]}): "
                    f"{view['targets']}")
            steps = sorted((r.get("shard_id"), r.get("global_step"))
                           for r in rows)
            steps_seen.append([s for _, s in steps])
            if verbs is None and len(rows) == 2 \
                    and all((r.get("global_step") or 0) >= 1 for r in rows):
                # Both primaries train: the discovery, the merged count
                # at one scrape (the primaries' own counts read just
                # before and just after the tick, and equal), the SLO
                # evaluator's reading, and the verbs.
                out["discovery"] = {
                    "primaries": [{k: r.get(k) for k in (
                        "target", "ok", "shard_id", "map_version",
                        "global_step")} for r in rows],
                    "primary_addresses":
                        view["tiers"].get("primary_addresses")}
                for attempt in range(50):
                    before = metrics_counts()
                    collector.tick()
                    ticks += 1
                    after = metrics_counts()
                    if before == after:
                        break
                else:
                    raise AssertionError("no scrape between two fetches in "
                                         "50 tries")
                view = collector.view()
                merged = view["rollups"]["histograms"][
                    f"{fetch}{{method=FetchParameters}}"]
                slo = view["slo"]
                out["merged_fetch"] = {
                    "count": merged["count"], "primaries_sum": before,
                    "targets": merged["targets"], "tries": attempt + 1,
                    "p50_ms": merged["p50_ms"], "p99_ms": merged["p99_ms"]}
                out["slo"] = {
                    "objectives": [{k: o.get(k) for k in (
                        "name", "total", "p99_ms", "threshold_ms")}
                        for o in slo["objectives"]],
                    "breaches": slo["breaches"], "scope": slo["scope"]}
                fleet_url = f"127.0.0.1:{observe_port}"
                status = cli_out(["status", "--via-fleet", fleet_url])
                top = cli_out(["top", "--url", fleet_url, "--json"])
                goodput = [cli_out(["goodput", "--url", t, "--json"])
                           for t in targets]
                frame = json.loads(top[1]) if top[0] == 0 else {}
                verbs = {
                    "status_rc": status[0],
                    "status_header": status[1].splitlines()[:1],
                    "top_rc": top[0],
                    "top_targets_ok": sum(t.get("ok", False)
                                          for t in frame.get("targets", [])),
                    "top_primaries": sorted(
                        r.get("shard_id") for r in
                        (frame.get("tiers") or {}).get("primaries", [])),
                    "goodput_rcs": [g[0] for g in goodput],
                    "goodput_json_lines": [
                        g[1].startswith("GOODPUT_JSON: ") for g in goodput]}
                out["verbs"] = verbs
                if checked is not None:
                    checked.set()
            if all(s == FLEET_STEPS for s in steps_seen[-1]) \
                    and len(steps_seen[-1]) == 2:
                break
            time.sleep(FLEET_TICK_S)
    finally:
        if checked is not None:
            checked.set()
        out["ticks"] = ticks
        out["probe_seconds"] = time.perf_counter() - t0
        out["steps_last"] = steps_seen[-3:]
        if watcher.is_alive():
            _raise_in(watcher, KeyboardInterrupt)
        watcher.join(10)
        server.shutdown()
        server.server_close()
    out["observe"] = dict(observed, alive=watcher.is_alive())
    rc, text = cli_out(["top", "--replay", journal_dir, "--json"])
    replay = json.loads(text) if rc == 0 else {}
    out["replay"] = {"rc": rc, "ticks": replay.get("ticks"),
                     "primaries": sorted(
                         r.get("shard_id") for r in
                         (replay.get("tiers") or {}).get("primaries", []))}


def _fleet_checks(state: dict) -> dict:
    """(a): the probe's readings, held to what they must be."""
    got = state.get("fleet_probe")
    if got is None:
        raise AssertionError("phase 26 (b) ran no fleet probe")
    if "error" in got:
        raise AssertionError(f"the fleet probe raised: {got['traceback']}")
    out = dict(got["result"])
    problems = []
    prim = out.get("discovery", {}).get("primaries", [])
    if sorted(r["shard_id"] for r in prim) != [0, 1] \
            or not all(r["ok"] for r in prim) \
            or out["discovery"]["primary_addresses"] \
            != sorted(state["fleet_peers"]):
        problems.append(f"discovery: {out.get('discovery')}")
    if out["steps_last"][-1:] != [[FLEET_STEPS, FLEET_STEPS]]:
        problems.append(f"primaries' last steps {out['steps_last']}")
    mf = out.get("merged_fetch", {})
    if not mf or mf["count"] != mf["primaries_sum"] or mf["targets"] != 2 \
            or mf["count"] <= 0:
        problems.append(f"merged fetch histogram: {mf}")
    objs = {o["name"]: o for o in out.get("slo", {}).get("objectives", [])}
    if out.get("slo", {}).get("scope") != "fleet" \
            or objs.get("fetch_latency", {}).get("total") != mf.get("count"):
        problems.append(f"fleet SLO: {out.get('slo')}")
    v = out.get("verbs") or {}
    if v.get("status_rc") != 0 or v.get("top_rc") != 0 \
            or v.get("top_targets_ok") != 2 \
            or v.get("top_primaries") != [0, 1] \
            or v.get("goodput_rcs") != [0, 0] \
            or not all(v.get("goodput_json_lines", [False])):
        problems.append(f"verbs: {v}")
    ob = out["observe"]
    if ob.get("alive") or "error" in ob or ob.get("rc") != 0 \
            or out["replay"]["rc"] != 0 or out["replay"]["primaries"] \
            != [0, 1] or not out["replay"]["ticks"]:
        problems.append(f"observe {ob}, replay {out['replay']}")
    out["problems"] = problems
    return out


def _forensics(state: dict) -> dict:
    """(b): ``incident list``, then ``show`` and ``report`` of every
    bundle the NaN drill of phase 20 (b) froze, and ``query
    --percentiles --slo --goodput`` over the journal of its first serve
    session, whose percentiles must equal those of the last snapshot
    that session's registry printed."""
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import histogram_quantile

    dirs = state.get("observe_dirs")
    if dirs is None:
        raise AssertionError("phase 20 (b) left no journal or bundle")
    problems = []
    listed = _cli_json(["incident", "list", "--dir", dirs["i2"], "--json"])
    rows = listed["out"] or []
    bad = [r for r in rows if "error" in r]
    out = {"list_rc": listed["rc"]}
    if listed["rc"] != 0 or len(rows) < 1 or bad:
        raise AssertionError(f"incident list: {listed}")
    out["bundles"] = {}
    for bundle in rows:
        # Each bundle shown, and its breach re-derived from the journal:
        # the timeline's alert phase holds its trigger's rule, in order.
        shown = _cli_json(["incident", "show", bundle["id"], "--dir",
                           dirs["i2"], "--json"])
        report = _cli_json(["incident", "report", bundle["id"], "--dir",
                            dirs["i2"], "--json"])
        rule = bundle["trigger"]["rule"]
        tl = (report["out"] or {}).get("timeline", {})
        fired = [e["summary"] for e in tl.get("events", [])
                 if e.get("phase") == "alert" and e.get("rule") == rule]
        row = out["bundles"][bundle["id"]] = {
            "show_rc": shown["rc"], "report_rc": report["rc"],
            "rule": rule, "breach_rederived": fired,
            "timeline_phases": {k: v["count"] for k, v in
                                tl.get("phases", {}).items()},
            "ordered": tl.get("ordered"),
            "report_stats": (report["out"] or {}).get("stats")}
        if shown["rc"] != 0 \
                or (shown["out"] or {}).get("id") != bundle["id"]:
            problems.append(f"incident show {bundle['id']}: {shown}")
        if report["rc"] != 0 or not fired or not tl.get("ordered"):
            problems.append(f"incident report {bundle['id']}: {row}")
    if not any(r.startswith("nonfinite") for r in
               (b["rule"] for b in out["bundles"].values())):
        problems.append(f"no bundle of the NaN drill: {list(out['bundles'])}")
    query = _cli_json_line(["query", "--journal", dirs["j"],
                            "--percentiles", "--slo", "--goodput",
                            "--slo-fetch-p99-ms", str(FLEET_SLO_P99_MS),
                            "--json"], "QUERY_JSON: ")
    q = query["out"] or {}
    last = state["observe_last_snapshot"]["histograms"]
    pcts, mismatched = q.get("percentiles", {}), []
    for key in ("dps_rpc_server_latency_seconds{method=FetchParameters}",
                "dps_rpc_server_latency_seconds{method=PushGradrients}"):
        h = last[key]
        want = {name: round(histogram_quantile(h["le"], h["counts"], pct),
                            6)
                for pct, name in ((50, "p50"), (95, "p95"), (99, "p99"))}
        got = {k: pcts.get(key, {}).get(k) for k in want}
        if got != want or pcts.get(key, {}).get("count") != h["count"]:
            mismatched.append({key: [got, want]})
    gp = q.get("goodput", {})
    out["query"] = {"rc": query["rc"], "percentiles": {
        k: v for k, v in pcts.items() if "rpc_server_latency" in k},
        "slo_samples": q.get("slo", {}).get("samples"),
        "any_critical_breach": q.get("slo", {}).get("any_critical_breach"),
        "goodput": {k: gp.get(k) for k in ("wall_s", "goodput_fraction",
                                           "processes", "reconciled")},
        "mismatched": mismatched}
    if query["rc"] != 0 or mismatched or not q.get("slo", {}).get("samples") \
            or not gp.get("wall_s"):
        problems.append(f"query: {out['query']}")
    out["problems"] = problems
    return out


def _cli_json_line(argv: list, prefix: str) -> dict:
    """``cli.main(argv)`` with stdout kept: rc and the JSON of its
    ``prefix`` line."""
    import io

    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    line = next((ln for ln in buf.getvalue().splitlines()
                 if ln.startswith(prefix)), None)
    return {"rc": rc, "out": json.loads(line[len(prefix):])
            if line is not None else None}


def _experiments(state: dict) -> dict:
    """(c): ``cli experiments`` in this process on the card: full-width
    ResNet-18, sync and async cells of 2 workers, one epoch of
    ``FLEET_EXPERIMENT_TRAIN`` synthetic images, no plots."""
    import os
    import shutil
    import tempfile

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.analysis \
        import RECORD_KEYS

    root = tempfile.mkdtemp(prefix="experiments-")
    problems, cells = [], {}
    try:
        rc = cli.main(["experiments", "--modes", "sync,async",
                       "--worker-counts", "2", "--epochs", "1",
                       "--synthetic", "--num-train",
                       str(FLEET_EXPERIMENT_TRAIN), "--num-test", "256",
                       "--no-plots", "--out-dir", root])
        names = sorted(os.listdir(root))
        for name in names:
            with open(os.path.join(root, name)) as f:
                rec = json.load(f)
            sm = rec["server_metrics"]
            steps = [r["local_steps_completed"]
                     for r in rec["raw_worker_metrics"]]
            rounds = steps[0] if sm["mode"] == "sync" else sum(steps)
            cells[name] = {
                "keys": list(rec), "device": rec["device"],
                "server_steps": sm["global_steps_completed"],
                "gradients_processed": sm["gradients_processed"],
                "worker_steps": steps,
                "accuracy": rec["worker_metrics_aggregated"].get(
                    "average_final_accuracy"),
                "total_training_time_seconds":
                    rec["worker_metrics_aggregated"].get(
                        "total_training_time_seconds")}
            if list(rec) != list(RECORD_KEYS) \
                    or torch.cuda.get_device_name(0) not in rec["device"] \
                    or sm["gradients_processed"] != sum(steps) \
                    or sm["global_steps_completed"] != rounds \
                    or len(set(steps)) != 1 or not steps[0]:
                problems.append(f"{name}: {cells[name]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if rc != 0 or names != ["async_2workers.json", "sync_2workers.json"]:
        problems.append(f"cli experiments rc {rc}, files {names}")
    return {"rc": rc, "cells": cells, "problems": problems}


def phase_fleet(state: dict) -> None:
    """Phase 27: the fleet observatory over phase 26 (b)'s primaries,
    the forensics verbs over phase 20 (b)'s journal and bundle, and the
    experiment matrix."""
    import shutil

    failures: list = []
    t0 = time.perf_counter()
    try:
        for key, fn in (("a_fleet", _fleet_checks), ("b_forensics",
                                                     _forensics),
                        ("c_experiments", _experiments)):
            t = time.perf_counter()
            try:
                res = fn(state)
                failures.extend(f"({key[0]}) {p}" for p in res["problems"])
            except Exception as e:  # noqa: BLE001 — reported, fails it
                traceback.print_exc()
                res = {"error": repr(e)}
                failures.append(f"({key[0]}) raised {e!r}")
            emit({"phase": "fleet", "form": key, **res,
                  "seconds": time.perf_counter() - t, "card": state["card"]})
    finally:
        root = (state.pop("observe_dirs", None) or {}).get("root")
        if root:
            shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "fleet", "form": "summary",
          "seconds": time.perf_counter() - t0, "failures": failures,
          "card": state["card"]})
    if failures:
        raise AssertionError(f"phase 27: {failures}")


# -- phase 28: the serve tier -------------------------------------------------

class _ThreadStdout:
    """``sys.stdout`` that sends each thread's writes to the buffer that
    thread registered (``_thread_stdout``), and every other thread's to
    the stream it replaced: phase 27 (a)'s and phase 28 (a)'s probes each
    keep their own ``cli.main`` output, at the same time."""

    def __init__(self, stream):
        self.stream, self.buffers = stream, {}

    def _target(self):
        return self.buffers.get(threading.get_ident(), self.stream)

    def write(self, text):
        return self._target().write(text)

    def flush(self):
        return self._target().flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)


_ROUTER_LOCK = threading.Lock()


@contextlib.contextmanager
def _thread_stdout():
    """Capture this thread's ``sys.stdout`` writes into a StringIO."""
    import io

    with _ROUTER_LOCK:
        if not isinstance(sys.stdout, _ThreadStdout):
            sys.stdout = _ThreadStdout(sys.stdout)
        router = sys.stdout
    buf = io.StringIO()
    router.buffers[threading.get_ident()] = buf
    try:
        yield buf
    finally:
        del router.buffers[threading.get_ident()]


#: (a): primary 1's autoscaler: a floor of 1, a ceiling of 2, a QPS high
#: mark that its pool's, workers' and watcher's own fetches (~10 a
#: second) stay under and a loadgen run of delta polls crosses, ticked
#: every 0.5 s.
SERVE_QPS_HIGH = 20.0
#: (a): how often the watcher polls primary 1 (its autoscaler counts them)
SERVE_P1_POLL_S = 0.5
SERVE_AUTOSCALE = ["--autoscale", "--autoscale-min", "1", "--autoscale-max",
                   "2", "--autoscale-qps-high", str(SERVE_QPS_HIGH),
                   "--autoscale-qps-low", "1", "--autoscale-cooldown", "1",
                   "--health-interval", "0.5"]
#: (a): the poll interval of primary 1's pool (``DPS_REPLICA_POLL``),
#: whose replicas poll from the topology's start: 2 polls a second leave
#: 27 (a)'s read of the primaries' fetch counts between two equal reads.
SERVE_EARLY_POLL_S = 0.5
#: (a): R1's poll interval: R1 takes a new canary candidate at most once
#: a second, which leaves one ``cli infer`` round (~0.7 s of 12 full
#: payloads) the time to reach a decision on one candidate.
SERVE_R1_POLL_S = 1.0
SERVE_LOADGEN_S = 0.5      # (a): seconds of each ``cli loadgen`` run
SERVE_INFER_BATCH = 12     # (a): requests of each ``cli infer`` round
SERVE_INFER_ROUNDS = 40    # (a): rounds at most before a canary decision
SERVE_STALE_S = 1.0        # (a): R3's ``--staleness-bound``
SERVE_PUSHES = 8           # (b): pushes of the one worker
SERVE_SERVER_FAULTS = "seed=7;push.drop_reply@n=2,5"
SERVE_CLIENT_FAULTS = "fetch.unavailable@n=3"


class _Wire:
    """Raw FetchParameters / PushGradrients stubs, a channel an
    address, as ``cli loadgen`` and ``cli infer`` call them."""

    def __init__(self):
        self._stubs, self._channels = {}, []

    def call(self, addr: str, rpc: str, meta: dict, timeout: float = 10.0):
        import grpc

        from distributed_parameter_server_for_ml_training_tpu_torch.comms \
            .service import GRPC_OPTIONS, SERVICE_NAME, pack_msg, unpack_msg
        key = (addr, rpc)
        if key not in self._stubs:
            ch = grpc.insecure_channel(addr, options=GRPC_OPTIONS)
            self._channels.append(ch)
            self._stubs[key] = ch.unary_unary(
                f"/{SERVICE_NAME}/{rpc}", request_serializer=lambda b: b,
                response_deserializer=lambda b: b)
        meta_out, payload = unpack_msg(self._stubs[key](
            pack_msg(meta), timeout=timeout))
        return meta_out, bytes(payload)

    def close(self):
        for ch in self._channels:
            ch.close()


def _cli_line(argv: list, prefix: str) -> tuple:
    """``cli.main(argv)`` in this process: (rc, the JSON of its
    ``prefix`` line or None); the output is this thread's alone."""
    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    with _thread_stdout() as buf:
        rc = cli.main(argv)
    line = next((ln for ln in buf.getvalue().splitlines()
                 if ln.startswith(prefix)), None)
    return rc, None if line is None else json.loads(line[len(prefix):])


def _serve_tier_final(addr: str, metrics_port: int, replicas: list,
                      out: dict) -> None:
    """(a): at a primary's final step, its payload, its ``/cluster``
    view, and each of its replicas (``replicas`` first, then the rows of
    the view) fetched until it serves that step, its payload bytes held
    to the primary's."""
    wire = _Wire()
    try:
        _serve_tier_compare(wire, addr, metrics_port, replicas, out)
    finally:
        wire.close()
    out["done"] = True


def _serve_tier_compare(wire, addr: str, metrics_port: int,
                        replicas: list, out: dict) -> None:
    import grpc

    _, want = wire.call(addr, "FetchParameters", {})
    code, body = _get_json(metrics_port, "/cluster")
    view = json.loads(body)
    out["view"] = {"status": code, "sharding": view.get("sharding"),
                   "autoscale": view.get("autoscale")}
    targets = list(replicas)
    targets += [r["address"] for r in
                (view.get("sharding") or {}).get("replicas", [])
                if r["address"] not in targets]
    out["bytes"], out["replicas"] = len(want), {}
    for target in targets:
        out["replicas"][target] = row = {"equal": False, "step": None}
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            try:
                m, got = wire.call(target, "FetchParameters", {},
                                   timeout=5.0)
            except grpc.RpcError as e:
                row["error"] = e.code().name
                time.sleep(0.02)
                continue
            row["step"] = m["global_step"]
            if row["step"] == FLEET_STEPS:
                row["equal"] = got == want
                row.pop("error", None)
                break
            time.sleep(0.02)


def _serve_tier_stale(addr: str, since: float, out: dict) -> None:
    """(a): fetch ``addr`` every 50 ms until it refuses as stale; the
    seconds from ``since`` (its primary seen gone)."""
    import grpc

    wire = _Wire()
    try:
        deadline = time.perf_counter() + 10.0
        while time.perf_counter() < deadline:
            try:
                wire.call(addr, "FetchParameters", {"have_step": -1},
                          timeout=5.0)
            except grpc.RpcError as e:
                if "stale" in (e.details() or ""):
                    out["stale"] = {
                        "code": e.code().name, "detail": e.details(),
                        "seconds_after_primary": time.perf_counter()
                        - since}
                    return
            time.sleep(0.05)
    finally:
        wire.close()


def _serve_tier_watch(peers: list, metrics_ports: list, replicas: list,
                      stale_addr: str, stop, out: dict) -> None:
    """(a)'s watcher: polls the primaries' steps (``out["steps"]``),
    primary 0 every 50 ms, primary 1 every ``SERVE_P1_POLL_S`` (its
    autoscaler counts the polls); at primary 0's final step
    (``FLEET_STEPS``) a thread of its own runs ``_serve_tier_final`` over
    ``replicas``; once a primary stops answering it stamps the time, and
    once primary 0 has, a thread fetches ``stale_addr``
    (``--staleness-bound`` ``SERVE_STALE_S``) until it is refused."""
    import grpc

    wire = _Wire()
    have, down = out["steps"], [None] * len(peers)
    threads, polled = [], [0.0] * len(peers)
    try:
        while not stop.is_set() and None in down:
            for i, addr in enumerate(peers):
                if down[i] is not None or (
                        i and time.perf_counter() - polled[i]
                        < SERVE_P1_POLL_S):
                    continue
                polled[i] = time.perf_counter()
                try:
                    meta, _ = wire.call(addr, "FetchParameters",
                                        {} if have[i] is None
                                        else {"have_step": have[i]},
                                        timeout=5.0)
                except grpc.RpcError:
                    if have[i] is not None:
                        down[i] = time.perf_counter()
                        print(f"[serve-tier watch] P{i} down at "
                              f"{down[i] - out['t0']:.1f}s",
                              file=sys.stderr, flush=True)
                        if i == 0:
                            threads.append(threading.Thread(
                                target=_serve_tier_stale, daemon=True,
                                args=(stale_addr, down[0], out)))
                            threads[-1].start()
                    continue
                have[i] = meta["global_step"]
                if i == 0 and have[i] == FLEET_STEPS \
                        and i not in out["final"]:
                    print(f"[serve-tier watch] P{i} at its final step at "
                          f"{time.perf_counter() - out['t0']:.1f}s",
                          file=sys.stderr, flush=True)
                    out["final"][i] = {"step": have[i]}
                    threads.append(threading.Thread(
                        target=_serve_tier_final, daemon=True, args=(
                            addr, metrics_ports[i], replicas,
                            out["final"][i])))
                    threads[-1].start()
            time.sleep(0.05)
        for t in threads:
            t.join(30)
        out["down_s"] = [None if d is None else d - out["t0"] for d in down]
    finally:
        wire.close()


def _serve_tier_probe(peers: list, metrics_ports: list, checked,
                      out: dict) -> None:
    """(a): runs on a thread from phase 26 (b)'s 'up' lines on. Starts
    R1 (``cli replica --primary P0 --canary``, polling once a second), R3
    (``--primary P0 --staleness-bound 1``) and, once R1 is up, R2
    (``--parent R1``). A thread waits for phase 27 (a) to have read the
    primaries' counts (``checked``), holds a registration on each
    primary, starts the watcher, runs ``cli loadgen`` full against P0
    and, at P1's final step, delta against P1 (its autoscaler's load),
    then holds the pool's replicas to P1's final payload. Meanwhile, once
    R1 serves a trained step, ``cli infer`` rounds of quality 0.9, each
    started as R1 takes a new candidate, until R1 promotes one; ``cli
    loadgen`` full and delta
    against R1 and R2 (neither touches a primary); a push to R1; once the
    primaries reached their final step, rounds of quality 0.1 until R1
    rolls that step back, and one round after; then the held
    registrations are released and the primaries exit. Every process it
    started is stopped. Fills ``out``."""
    import os
    import re

    import grpc

    cli_argv = [sys.executable, "-m",
                "distributed_parameter_server_for_ml_training_tpu_torch.cli"]
    repo = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    procs, lines = {}, {}
    t0 = out["t0"] = time.perf_counter()
    ports = {name: _free_port() for name in ("r1", "r2", "r3", "m1")}
    addr = {name: f"127.0.0.1:{ports[name]}" for name in ("r1", "r2", "r3")}
    stop = threading.Event()
    watch: dict = {"t0": t0, "steps": [None] * len(peers), "final": {}}
    out["watch"] = watch
    watcher = None
    wire = _Wire()
    r1_step = [None]
    out["stages"] = []

    def stage(name: str) -> None:
        out["stages"].append((name, round(time.perf_counter() - t0, 3)))
        print(f"[serve-tier probe] {name} at "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr,
              flush=True)

    def spawn(name: str, argv: list) -> None:
        p = subprocess.Popen(cli_argv + ["replica", *argv], cwd=repo,
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs[name], lines[name] = p, []
        threading.Thread(target=_read_lines, args=(p.stdout, lines[name]),
                         daemon=True).start()

    def up(name: str) -> float:
        deadline = time.perf_counter() + GRPC_SERVER_TIMEOUT_S
        while time.perf_counter() < deadline:
            for t, line in list(lines[name]):
                if line is None:
                    raise AssertionError(f"{name} exited: "
                                         f"{_lines_text(lines[name])}")
                if re.search(r"replica up on :\d+", line):
                    return t - t0
            time.sleep(0.01)
        raise AssertionError(f"{name} never came up")

    def r1_changed(timeout: float) -> bool:
        """Poll R1 at its step until it serves another one."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            try:
                meta, _ = wire.call(addr["r1"], "FetchParameters",
                                    {} if r1_step[0] is None
                                    else {"have_step": r1_step[0]})
            except grpc.RpcError:
                time.sleep(0.05)
                continue
            if not meta.get("not_modified"):
                changed = r1_step[0] is not None
                r1_step[0] = meta["global_step"]
                if changed:
                    return True
            time.sleep(0.01)
        return False

    def canary_counts() -> dict:
        snap = json.loads(_get_json(ports["m1"], "/metrics.json")[1])
        return {"promotions": snap["counters"].get(
                    "dps_canary_promotions_total", 0),
                "rollbacks": snap["counters"].get(
                    "dps_canary_rollbacks_total", 0),
                "stable_step": snap["gauges"].get("dps_canary_stable_step")}

    def infer_rounds(quality: float, outcome: str, aligned: bool) -> dict:
        rounds, served = 0, []
        counts = canary_counts()
        while counts[outcome] < 1 and rounds < SERVE_INFER_ROUNDS:
            if aligned:
                r1_changed(3.0)
            rc, got = _cli_line(["infer", "--target", addr["r1"],
                                 "--count", str(SERVE_INFER_BATCH),
                                 "--quality", str(quality), "--json"],
                                "INFER_JSON ")
            rounds += 1
            stage(f"infer {quality} round {rounds}")
            if rc != 0 or got is None:
                raise AssertionError(f"cli infer rc {rc}")
            served.append(sorted({(r["arm"], r["serving_step"])
                                  for r in got["served"]}))
            counts = canary_counts()
        return {"rounds": rounds, "served": served, **counts,
                "p0_step": watch["steps"][0], "r1_step": r1_step[0]}

    def loadgen(name: str, target: str, mode: str, seconds: float,
                concurrency: int) -> dict:
        wall = time.time()
        rc, res = _cli_line(["loadgen", "--targets", target, "--duration",
                             str(seconds), "--concurrency",
                             str(concurrency), "--fetch-mode", mode],
                            "LOADGEN_JSON ")
        res = res or {}
        lat = res.get("latency_ms", {})
        stage(f"loadgen {name} {mode}")
        return {"target": name, "mode": mode, "rc": rc, "wall": wall,
                "p0_step_at_start": watch["steps"][0],
                "r1_step_at_start": r1_step[0],
                **{k: res.get(k) for k in ("qps", "mb_per_s", "fetches_ok",
                                           "fetches_err", "not_modified")},
                "p50_ms": lat.get("p50"), "p99_ms": lat.get("p99")}

    def primaries() -> None:
        """Once 27 (a) read the primaries' counts: a registration held on
        each primary once both workers report there (it keeps the
        primaries serving after the workers' JobFinished, until this
        probe's own), the watcher, ``cli loadgen`` full against P0; at
        primary 1's final step ``cli loadgen`` delta against it, and once
        its pool grew to two synced replicas, their bytes."""
        try:
            hold_and_load()
        except Exception as e:  # noqa: BLE001 — read by the checks
            out["primaries_error"] = repr(e)
            out["primaries_traceback"] = traceback.format_exc()

    def hold_and_load() -> None:
        checked.wait(GRPC_WORKER_TIMEOUT_S)
        stage("checked")
        deadline = time.perf_counter() + GRPC_SERVER_TIMEOUT_S
        for i, peer in enumerate(peers):
            while time.perf_counter() < deadline and len(json.loads(
                    _get_json(metrics_ports[i], "/cluster")[1]).get(
                        "workers") or []) < N_WORKERS:
                time.sleep(0.05)
            meta, _ = wire_hold.call(peer, "RegisterWorker",
                                     {"worker_name": "serve-tier-hold"})
            held[peer] = meta["worker_id"]
        stage("held")
        watcher.start()
        out["loadgen"].append(loadgen("P0", peers[0], "full",
                                      SERVE_LOADGEN_S, 2))
        # Primary 1, held at its final step: loadgen's delta polls are its
        # autoscaler's load; then its replicas (the pool's two) are held
        # to its final payload.
        while watch["steps"][1] != FLEET_STEPS \
                and time.perf_counter() < deadline + GRPC_WORKER_TIMEOUT_S:
            time.sleep(0.05)
        out["loadgen"].append(loadgen("P1", peers[1], "delta", 1.0, 4))

        def pool_ready() -> bool:
            view = json.loads(_get_json(metrics_ports[1], "/cluster")[1])
            rows = (view.get("sharding") or {}).get("replicas", [])
            return (view.get("autoscale") or {}).get("live") == 2 \
                and len(rows) == 2 \
                and all(r.get("step") == FLEET_STEPS for r in rows)

        until = time.perf_counter() + GRPC_SERVER_TIMEOUT_S
        while not pool_ready() and time.perf_counter() < until:
            time.sleep(0.1)
        stage("pool ready")
        _serve_tier_final(peers[1], metrics_ports[1], [],
                          watch["final"].setdefault(1, {"step": FLEET_STEPS}))

    def release() -> None:
        """JobFinished for each held registration: the primaries exit."""
        for peer in list(held):
            try:
                wire_hold.call(peer, "JobFinished",
                               {"worker_id": held.pop(peer)})
            except grpc.RpcError:
                pass

    wire_hold, held = _Wire(), {}
    loads = None
    try:
        spawn("r1", ["--primary", peers[0], "--port", str(ports["r1"]),
                     "--advertise", addr["r1"], "--canary",
                     "--canary-min-samples", "5", "--canary-fraction", "0.5",
                     "--poll-interval", str(SERVE_R1_POLL_S),
                     "--metrics-port", str(ports["m1"]),
                     "--metrics-advertise", ""])
        # R3 never re-parents: a stale drill on its own primary (by
        # default it would follow a still-fresh sibling once P0 is gone).
        spawn("r3", ["--primary", peers[0], "--port", str(ports["r3"]),
                     "--advertise", addr["r3"], "--staleness-bound",
                     str(SERVE_STALE_S), "--poll-interval",
                     str(SERVE_STALE_S / 2), "--reparent-after", "1000000"])
        out["r1_up_s"] = up("r1")
        stage("r1 up")
        spawn("r2", ["--primary", peers[0], "--parent", addr["r1"],
                     "--port", str(ports["r2"]), "--advertise", addr["r2"],
                     "--poll-interval", "0.05"])
        out["r2_up_s"], out["r3_up_s"] = up("r2"), up("r3")
        stage("r2, r3 up")
        out["loadgen"] = []
        watcher = threading.Thread(target=_serve_tier_watch, args=(
            peers, metrics_ports, [addr["r3"], addr["r1"], addr["r2"]],
            addr["r3"], stop, watch), daemon=True)
        loads = threading.Thread(target=primaries, daemon=True)
        loads.start()
        deadline = time.perf_counter() + GRPC_WORKER_TIMEOUT_S
        while (r1_step[0] or 0) < 1 and time.perf_counter() < deadline:
            r1_changed(1.0)
            time.sleep(0.1)
        out["trained_s"] = time.perf_counter() - t0
        stage("r1 trained")
        out["promote"] = infer_rounds(0.9, "promotions", aligned=True)
        # The replicas' loads touch no primary.
        out["loadgen"] += [loadgen(n, addr[r], m, SERVE_LOADGEN_S, 2)
                           for n, r in (("R1", "r1"), ("R2", "r2"))
                           for m in ("full", "delta")]
        meta, _ = wire.call(addr["r1"], "PushGradrients", {"worker_id": 0})
        out["redirect"] = {k: meta.get(k) for k in (
            "redirect", "replica", "accepted", "received")}
        deadline = time.perf_counter() + GRPC_WORKER_TIMEOUT_S

        def waiting(i: int) -> bool:
            return not watch["final"].get(i, {}).get("done") \
                and "down_s" not in watch \
                and (loads.is_alive() or watcher.is_alive()) \
                and time.perf_counter() < deadline

        while waiting(0):
            time.sleep(0.02)
        stage("final step")
        out["rollback"] = infer_rounds(0.1, "rollbacks", aligned=False)
        rc, after = _cli_line(["infer", "--target", addr["r1"], "--count",
                               str(SERVE_INFER_BATCH), "--json"],
                              "INFER_JSON ")
        out["after_rollback"] = sorted({(r["arm"], r["serving_step"])
                                        for r in after["served"]})
        stage("rolled back")
        loads.join(GRPC_SERVER_TIMEOUT_S)
        while waiting(1):
            time.sleep(0.02)
        release()
        stage("released")
        watcher.join(GRPC_SERVER_TIMEOUT_S)
        stage("watcher done")
    finally:
        checked.set()
        if loads is not None:
            loads.join(GRPC_SERVER_TIMEOUT_S)
        release()
        wire_hold.close()
        if watcher is not None and watcher.is_alive():
            watcher.join(20)
        stop.set()
        wire.close()
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        out["addresses"] = {**addr, "P0": peers[0], "P1": peers[1]}
        out["replica_rcs"] = {n: p.returncode for n, p in procs.items()}
        out["replica_tail"] = {n: _lines_text(ls)[-600:]
                               for n, ls in lines.items()}
        out["probe_seconds"] = time.perf_counter() - t0


def _serve_tier_checks(state: dict) -> dict:
    """(a): the probe's readings, held to what they must be."""
    import grpc

    got = state.get("serve_tier_probe")
    if got is None:
        raise AssertionError("phase 26 (b) ran no serve-tier probe")
    out = {k: v for k, v in got.items() if k != "t0"}
    problems = []
    if "error" in got or "probe_seconds" not in got \
            or "primaries_error" in got:
        problems.append(f"the probe raised or did not end: "
                        f"{got.get('traceback')}, "
                        f"{got.get('primaries_traceback')}, stages "
                        f"{got.get('stages')}")
        out["problems"] = problems
        return out
    addr = got["addresses"]
    final = got["watch"].get("final", {})
    for i, name in ((0, "P0"), (1, "P1")):
        f = final.get(i) or {}
        if f.get("step") != FLEET_STEPS or not f.get("replicas") \
                or not all(r["equal"] for r in f["replicas"].values()):
            problems.append(f"{name}'s replicas at its final step: {f}")
    pool = list((final.get(1) or {}).get("replicas", {}))
    rows = {r["address"]: r for r in (((final.get(0) or {}).get(
        "view") or {}).get("sharding") or {}).get("replicas", [])}
    tree = {n: (rows.get(addr[n], {}).get("parent"),
                rows.get(addr[n], {}).get("tier")) for n in ("r1", "r2")}
    out["p0_tree"] = tree
    if tree != {"r1": (addr["P0"], 1), "r2": (addr["r1"], 2)}:
        problems.append(f"P0's shard view: {rows}")
    if got["redirect"] != {"redirect": addr["P0"], "replica": True,
                           "accepted": False, "received": False}:
        problems.append(f"push to R1: {got['redirect']}")
    for run in got["loadgen"]:
        if run["rc"] != 0 or run["fetches_err"] != 0 \
                or not run["fetches_ok"]:
            problems.append(f"loadgen {run}")
    pro, rb = got["promote"], got["rollback"]
    if pro["promotions"] < 1 or rb["rollbacks"] < 1 \
            or rb["stable_step"] == FLEET_STEPS \
            or any(arm == "canary" and step != FLEET_STEPS
                   for arms in rb["served"] for arm, step in arms) \
            or any(arm == "canary" for arm, _ in got["after_rollback"]):
        problems.append(f"canary: promote {pro}, rollback {rb}, after "
                        f"{got['after_rollback']}")
    auto = ((final.get(1) or {}).get("view") or {}).get("autoscale") or {}
    loaded = next(r["wall"] for r in got["loadgen"] if r["target"] == "P1")
    grows = [(e["live"], e["qps"], round(e["ts"] - loaded, 3))
             for e in auto.get("events", [])
             if e["action"] == "replica_grow" and e["outcome"] == "ok"]
    out["autoscale_grows"] = grows
    if len(grows) != 2 or grows[0][0] != 1 or grows[1][0] != 2 \
            or grows[1][1] <= SERVE_QPS_HIGH or grows[1][2] < 0 \
            or len(pool) != 2:
        problems.append(f"autoscale: {auto}, pool {pool}")
    out["pool_gone"] = {}
    wire = _Wire()
    try:
        for a in pool:
            try:
                wire.call(a, "FetchParameters", {"have_step": -1},
                          timeout=2.0)
                out["pool_gone"][a] = False
            except grpc.RpcError as e:
                out["pool_gone"][a] = e.code().name == "UNAVAILABLE"
    finally:
        wire.close()
    run = state.get("serve_tier_topology") or {}
    pool_lines = [ln for ln in (run.get("p1_out") or "").splitlines()
                  if ln.startswith("REPLICA_POOL_")]
    out["pool_lines"] = pool_lines
    if not all(out["pool_gone"].values()) or sum(
            ln.startswith("REPLICA_POOL_GROW") for ln in pool_lines) != 2:
        problems.append(f"the pool's children: {out['pool_gone']}, "
                        f"{pool_lines}")
    stale = got["watch"].get("stale")
    if stale is None or stale["code"] != "UNAVAILABLE" \
            or f"use primary {addr['P0']}" not in stale["detail"] \
            or stale["seconds_after_primary"] > 2.5 * SERVE_STALE_S:
        problems.append(f"R3's staleness: {stale}")
    out["problems"] = problems
    return out


def _serve_tier_faults(state: dict) -> dict:
    """(b): one ResNet-18 worker on the card pushing int8 through K1 to a
    port service that drops push replies (``SERVE_SERVER_FAULTS``)
    through a ``RemoteStore`` whose fetches fail
    (``SERVE_CLIENT_FAULTS``). Each push's payload and fetched step are
    recorded; the service must apply each push token once, its params
    must be bit-equal to a fresh NumPy store replaying the recorded
    payloads once each, and each injector's counters must equal its
    ``schedule_preview`` over the calls it saw."""
    from distributed_parameter_server_for_ml_training_tpu_torch.comms import (
        ParameterService, RemoteStore, serve)
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, PSWorker, StoreConfig, WorkerConfig)

    ds, model, store, init = main_path(SERVE_PUSHES, 10, 28)
    svc = ParameterService(store, faults=SERVE_SERVER_FAULTS)
    replies = []
    body = svc.push_gradrients

    def push(request, ctx):
        reply = body(request, ctx)
        replies.append(unpack_msg(reply)[0])
        return reply

    svc.push_gradrients = push
    server, port = serve(store, port=0, service=svc, host="127.0.0.1")
    remote = RemoteStore(f"127.0.0.1:{port}", rpc_backoff=0.05,
                         faults=SERVE_CLIENT_FAULTS)
    injected = {("server", "push", "drop_reply"): svc.faults,
                ("client", "fetch", "unavailable"): remote.faults}
    before = {k: inj._tm[k[1:]].value for k, inj in injected.items()}

    class Recording:
        def __init__(self, inner):
            self._inner, self.pushes = inner, []

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def push(self, wid, grads, step):
            self.pushes.append(({k: np.array(v) for k, v in grads.items()},
                                step))
            return self._inner.push(wid, grads, step)

    rec = Recording(remote)
    Q.wire_quantize_multi.launches = 0
    try:
        w = PSWorker(rec, model, ds, WorkerConfig(
            batch_size=BATCH, num_epochs=1, device="cuda",
            eval_each_epoch=False))
        w.run()
    finally:
        remote.close()
        server.stop(grace=None).wait(10)
    launches = Q.wire_quantize_multi.launches
    state["serve_tier_k1_launches"] = launches
    if w.result.error is not None:
        raise w.result.error
    replay = ParameterStore(init, StoreConfig(
        mode="async", total_workers=N_WORKERS, push_codec="int8",
        staleness_bound=5))
    wid, _ = replay.register_worker("replay")
    for payload, step in rec.pushes:
        replay.push(wid, payload, step)
    params, step = store.snapshot()
    ref, ref_step = replay.snapshot()
    diff = [k for k in ref if ref[k].tobytes() != params[k].tobytes()]
    rpc = {("server", "push", "drop_reply"): "PushGradrients",
           ("client", "fetch", "unavailable"): "FetchParameters"}
    counters = {}
    for key, inj in injected.items():
        calls = inj._op_calls.get(rpc[key], 0)
        counters["/".join(key)] = {
            "calls": calls,
            "injected": inj._tm[key[1:]].value - before[key],
            "preview": sum(x is not None for x in inj.schedule_preview(
                rpc[key], calls))}
    out = {"pushes": len(rec.pushes), "step": step, "replay_step": ref_step,
           "gradients_processed": store.stats.gradients_processed,
           "duplicates": sum(bool(r.get("duplicate")) for r in replies),
           "journal": svc.journal_snapshot(), "k1_launches": launches,
           "params_differ": diff, "injections": counters,
           "rpc_counts": remote.rpc_counts}
    problems = []
    n = len(rec.pushes)
    if n != SERVE_PUSHES or step != n or ref_step != n \
            or out["gradients_processed"] != n:
        problems.append(f"pushes {n}, steps {step}/{ref_step}, applied "
                        f"{out['gradients_processed']}")
    drops = counters["server/push/drop_reply"]["injected"]
    if out["duplicates"] != drops or drops != 2 or diff:
        problems.append(f"duplicates {out['duplicates']} for {drops} "
                        f"dropped replies; params differ {diff[:4]}")
    if any(c["injected"] != c["preview"] or not c["injected"]
           for c in counters.values()):
        problems.append(f"injections {counters}")
    want = -(-len(init) // Q.WIRE_MAX_ENTRIES) * n
    if launches != want:
        problems.append(f"K1 launched {launches} times for {n} pushes")
    out["problems"] = problems
    return out


def phase_serve_tier(state: dict) -> None:
    """Phase 28: the serve tier over phase 26 (b)'s primaries, then the
    seeded faults in this process on the card."""
    failures: list = []
    t0 = time.perf_counter()
    for key, fn in (("a_replicas", _serve_tier_checks),
                    ("b_faults", _serve_tier_faults)):
        t = time.perf_counter()
        try:
            res = fn(state)
            failures.extend(f"({key[0]}) {p}" for p in res["problems"])
        except Exception as e:  # noqa: BLE001 — reported, fails it
            traceback.print_exc()
            res = {"error": repr(e)}
            failures.append(f"({key[0]}) raised {e!r}")
        emit({"phase": "serve_tier", "form": key, **res,
              "seconds": time.perf_counter() - t, "card": state["card"]})
    emit({"phase": "serve_tier", "form": "summary",
          "seconds": time.perf_counter() - t0, "failures": failures,
          "card": state["card"]})
    if failures:
        raise AssertionError(f"phase 28: {failures}")


# -- phase 29: live resharding and the worker supervisor ----------------------

RESHARD_SHARE = 0.25      # (a): least share of the donor's bytes to move
RESHARD_TENSORS = 8       # (a): and the least number of its tensors
RESHARD_LEASE_TTL = 1.5   # (b): the lease drill's TTL, seconds
SUPERVISE_TIMEOUT = 150   # (c): seconds before the supervisor is killed
#: (b): (crash point, donor, recipient) of each cycle: the moved range
#: goes back and forth between the two primaries.
RESHARD_CYCLES = [("export", 1, 0), ("import", 0, 1), ("apply_first", 1, 0),
                  ("apply_all", 0, 1)]


def _reshard_range(init: dict, donor_keys) -> tuple[int, int]:
    """Shard 0's slots ``[lo, 32)``, the boundary facing shard 1, with
    ``lo`` the largest that moves at least ``RESHARD_SHARE`` of shard 0's
    bytes and ``RESHARD_TENSORS`` of its tensors."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ps \
        .sharding import key_slot

    total = sum(init[k].nbytes for k in donor_keys)
    for lo in range(31, -1, -1):
        moved = [k for k in donor_keys if lo <= key_slot(k) < 32]
        if sum(init[k].nbytes for k in moved) >= RESHARD_SHARE * total \
                and len(moved) >= RESHARD_TENSORS:
            return lo, 32
    raise AssertionError("no range of shard 0 holds the share")


class _ReshardTier:
    """Phase 26 (a)'s ``_shard_topology`` over ``init`` from
    ``make_store``, each primary's Reshard handler recording ``(op, ms)``
    server side; one ``ShardedRemoteStore`` and one ``RemoteStore`` over
    the one-store control, both registered."""

    def __init__(self, init: dict, make_store):
        from distributed_parameter_server_for_ml_training_tpu_torch.comms \
            import ParameterService, RemoteStore
        from distributed_parameter_server_for_ml_training_tpu_torch.comms \
            .sharded import ShardedRemoteStore
        from distributed_parameter_server_for_ml_training_tpu_torch.ps \
            .sharding import partition_keys

        def service(store):
            svc = ParameterService(store)
            svc.reshard = self._timed(svc.reshard)
            return svc

        self.op_ms: list = []
        self.parts = partition_keys(init, SHARDS)
        (self.stores, self.svcs, self.servers, self.addrs, self.one,
         self.one_server, one_addr) = _shard_topology(init, make_store,
                                                      service)
        self.fan = ShardedRemoteStore(self.addrs)
        self.ref = RemoteStore(one_addr)
        self.wid = self.fan.register_worker("reshard")[0]
        self.ref_wid = self.ref.register_worker("reshard")[0]

    def _timed(self, fn):
        from distributed_parameter_server_for_ml_training_tpu_torch.comms \
            .service import unpack_msg

        def timed(request, ctx):
            t0 = time.perf_counter()
            try:
                return fn(request, ctx)
            finally:
                self.op_ms.append((unpack_msg(request)[0].get("op"),
                                   (time.perf_counter() - t0) * 1e3))
        return timed

    @property
    def primaries(self) -> str:
        return ",".join(self.addrs)

    def push(self, payload: dict) -> list:
        """Fetch, then push ``payload`` through the tier and into the
        control. Returns [tier accepted, control accepted, tensors where
        the union of the primaries differs bit-wise from the control]."""
        _, step = self.fan.fetch(self.wid)
        _, ref_step = self.ref.fetch(self.ref_wid)
        ok = self.fan.push(self.wid, payload, step)
        ref_ok = self.ref.push(self.ref_wid, payload, ref_step)
        return [ok, ref_ok, _union_diff(self.stores, self.one)]

    def owners(self, keys) -> list:
        """Per key, the primaries holding it."""
        return [[i for i, s in enumerate(self.stores)
                 if k in s.param_names()] for k in keys]

    def versions(self) -> list:
        return [svc.sharding.version for svc in self.svcs]

    def close(self) -> None:
        self.fan.close()
        self.ref.close()
        for s in self.servers + [self.one_server]:
            s.stop(grace=None).wait(10)


def _reshard_live(backend: str, grads: list, init: dict, failures: list):
    """(a) on one backend: 2 pushes, ``cli.main(["reshard", ...])`` in
    this process moving shard 0's range facing shard 1, 2 more pushes;
    the union of the primaries bit-equal to the one-store control after
    every push. Returns (the tier, still serving, and the record)."""
    import contextlib
    import io

    from distributed_parameter_server_for_ml_training_tpu_torch import cli
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import RemoteStore
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig, make_store)
    from distributed_parameter_server_for_ml_training_tpu_torch.ps \
        .sharding import key_slot

    def build(params, **kw):
        cfg = StoreConfig(mode="async", total_workers=1, staleness_bound=5,
                          push_codec="int8" if backend == "python"
                          else None, **kw)
        if backend == "python":
            return ParameterStore(params, cfg)
        return make_store("device", params, cfg, device="cuda")

    tier = _ReshardTier(init, build)
    codec = DeviceCodec()
    lo, hi = _reshard_range(init, tier.parts[0])
    moved = sorted(k for k in tier.parts[0] if lo <= key_slot(k) < hi)
    donor_bytes = int(sum(init[k].nbytes for k in tier.parts[0]))
    out = {"backend": tier.stores[0].store_backend, "slots": [lo, hi],
           "moved_tensors": len(moved),
           "moved_bytes": int(sum(init[k].nbytes for k in moved)),
           "donor_bytes": donor_bytes, "pushes": []}

    def payload(i):
        g = grads[i % len(grads)]
        if backend == "python":
            return codec.encode_now(g)
        return {k: v.cpu().numpy() for k, v in g.items()}

    versions = tier.versions()
    kept = None
    for i in range(4):
        if i == 2:
            kept = tier.fan._stores[0]._last_push
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["reshard", "--primaries", tier.primaries,
                               "--donor", "0", "--recipient", "1",
                               "--slots", f"{lo}:{hi}", "--migration-id",
                               f"mig-a-{backend}", "--json"])
            out["coordinator_s"] = time.perf_counter() - t0
            line = next((ln for ln in buf.getvalue().splitlines()
                         if ln.startswith("RESHARD_JSON ")), None)
            out["result"] = json.loads(line.split(" ", 1)[1]) \
                if line else None
            out["rc"] = rc
        out["pushes"].append(tier.push(payload(i)))
    res = out.get("result") or {}
    out["op_ms"] = [[op, ms] for op, ms in tier.op_ms]
    out["versions"] = [versions, tier.versions()]
    owners = tier.owners(moved)
    # The last pre-move push, re-sent with its token to the new owner:
    # its journal came with the export, so it answers duplicate.
    to_new = RemoteStore(tier.addrs[1])
    to_new._last_push = kept
    step = tier.stores[1].global_step
    out["repush_accepted"] = to_new.repush_last(tier.fan._wids[1])
    out["repush_applied"] = tier.stores[1].global_step != step
    to_new.close()
    problems = []
    if out["rc"] != 0 or not res:
        problems.append(f"coordinator rc {out['rc']}, result {res}")
    elif not (res["exported"] == res["adopted"] == res["dropped"]
              == len(moved)):
        problems.append(f"exported/adopted/dropped {res} for "
                        f"{len(moved)} tensors")
    if out["moved_bytes"] < RESHARD_SHARE * donor_bytes:
        problems.append(f"moved {out['moved_bytes']} of {donor_bytes} B")
    if any(o != [1] for o in owners):
        problems.append(f"moved tensors' owners {owners}")
    if out["versions"][1] != [v + 1 for v in versions]:
        problems.append(f"map versions {out['versions']}")
    if any(p[:2] != [True, True] or p[2] for p in out["pushes"]):
        problems.append(f"pushes {out['pushes']}")
    if out["repush_accepted"] is not True or out["repush_applied"]:
        problems.append(f"re-sent push accepted "
                        f"{out['repush_accepted']}, applied "
                        f"{out['repush_applied']}")
    failures.extend(f"(a) {backend}: {p}" for p in problems)
    out["problems"] = problems
    out["moved"] = moved
    return tier, out


def _coordinator(tier: _ReshardTier, donor: int, recipient: int,
                 lo: int, hi: int, *extra) -> dict:
    """One ``cli reshard`` process against ``tier``: its rc, its result
    line's JSON and its wall seconds."""
    import os

    repo = Path(__file__).resolve().parent
    argv = [sys.executable, "-m",
            "distributed_parameter_server_for_ml_training_tpu_torch.cli",
            "reshard", "--primaries", tier.primaries, "--donor",
            str(donor), "--recipient", str(recipient), "--slots",
            f"{lo}:{hi}", "--json", *extra]
    t0 = time.perf_counter()
    p = subprocess.run(argv, cwd=repo, capture_output=True, text=True,
                       timeout=60,
                       env={**os.environ, "PYTHONPATH": str(repo)})
    result = None
    for ln in p.stdout.splitlines():
        if ln.startswith("RESHARD_"):
            head, _, body = ln.partition(" ")
            result = {"line": head}
            if body.startswith("{"):
                result.update(json.loads(body))
            else:
                result["point"] = body
    return {"argv": list(extra), "rc": p.returncode, "result": result,
            "seconds": time.perf_counter() - t0,
            "stderr": p.stderr[-800:] if p.returncode not in (0, 21)
            else ""}


def _reshard_matrix(tier: _ReshardTier, grads: list, lo: int, hi: int,
                    moved: list, failures: list) -> dict:
    """(b) against (a)'s NumPy primaries: each crash point then
    ``--resume``, the lease drill and both aborts, one int8 push after
    each, with the union check against the control."""
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec
    from distributed_parameter_server_for_ml_training_tpu_torch.telemetry \
        import get_registry

    codec = DeviceCodec()
    pushes = [0]
    runs, problems = [], []

    def push() -> list:
        r = tier.push(codec.encode_now(grads[pushes[0] % len(grads)]))
        pushes[0] += 1
        if r[:2] != [True, True] or r[2]:
            problems.append(f"push {pushes[0]}: {r}")
        return r

    def run(case, donor, recipient, *extra, rc=0):
        r = _coordinator(tier, donor, recipient, lo, hi, *extra)
        r["case"] = case
        runs.append(r)
        if r["rc"] != rc:
            problems.append(f"{case} {extra}: rc {r['rc']} (want {rc}) "
                            f"{r['stderr']}")
        return r.get("result") or {}

    def owned_by(shard) -> bool:
        return all(o == [shard] for o in tier.owners(moved))

    for point, d, r in RESHARD_CYCLES:
        crash = run(point, d, r, "--migration-id", f"mig-{point}",
                    "--crash-after", point, rc=21)
        if crash.get("point") != point:
            problems.append(f"{point}: crash line {crash}")
        res = run(point, d, r, "--resume")
        want = "export" if point in ("export", "import") else "apply_ranges"
        if (res.get("outcome"), res.get("from_phase")) != (
                "rolled_forward", want):
            problems.append(f"{point}: resume {res}")
        push()
        if not owned_by(r):
            problems.append(f"{point}: owners {tier.owners(moved)}")
    # The lease: crash pre-publish, let the lease lapse, do not resume.
    versions = tier.versions()
    expired = get_registry().counter("dps_reshard_lease_expired_total")
    before = expired.value
    run("lease", 1, 0, "--migration-id", "mig-lease", "--lease-ttl",
        str(RESHARD_LEASE_TTL), "--crash-after", "import", rc=21)
    time.sleep(RESHARD_LEASE_TTL + 0.2)
    donor_view = tier.svcs[1].migration_view()
    lease = {"donor_view": donor_view,
             "donor_frozen": len(tier.svcs[1]._draining),
             "expired_total": expired.value,
             "expired_delta": expired.value - before}
    step = tier.stores[1].global_step
    lease["push"] = push()
    lease["donor_applied"] = tier.stores[1].global_step == step + 1
    res = run("lease", 1, 0, "--resume")
    lease["resume"] = res
    lease["versions"] = [versions, tier.versions()]
    if donor_view is not None or lease["donor_frozen"] \
            or lease["expired_delta"] != 1 or lease["expired_total"] != 1:
        problems.append(f"lease: {lease}")
    if not lease["donor_applied"] or res.get("outcome") != "rolled_back" \
            or res.get("dropped") != len(moved) or not owned_by(1) \
            or lease["versions"][1] != versions:
        problems.append(f"lease: {lease}, owners {tier.owners(moved)}")
    # Abort before anything publishes, then after the donor published.
    run("abort_ok", 1, 0, "--migration-id", "mig-abort-a",
        "--crash-after", "export", rc=21)
    res = run("abort_ok", 1, 0, "--abort")
    if res.get("line") != "RESHARD_ABORT_JSON" or tier.svcs[1]._draining \
            or tier.versions() != versions or not owned_by(1):
        problems.append(f"abort after export: {res}")
    push()
    run("abort_refused", 1, 0, "--migration-id", "mig-abort-b",
        "--crash-after", "apply_first", rc=21)
    run("abort_refused", 1, 0, "--abort", rc=4)
    res = run("abort_refused", 1, 0, "--resume")
    if res.get("from_phase") != "apply_ranges" or not owned_by(0):
        problems.append(f"abort after publish: resume {res}")
    push()
    failures.extend(f"(b) {p}" for p in problems)
    return {"coordinators": [{k: r[k] for k in ("case", "argv", "rc",
                                                "seconds", "result")}
                             for r in runs],
            "coordinator_s": [r["seconds"] for r in runs],
            "int8_pushes": pushes[0], "lease": lease,
            "versions_final": tier.versions(), "problems": problems}


def _smi_pids() -> set:
    p = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=10)
    return {int(x) for x in p.stdout.split() if x.strip().isdigit()}


def _maps_cuda(pid: int) -> bool | None:
    """Whether process ``pid`` has the CUDA driver library mapped (None
    once it is gone)."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda" in f.read()
    except OSError:
        return None


def _supervise_drill(init: dict, failures: list) -> dict:
    """(c) ``cli supervise`` with 2 ``cli worker`` children on the card
    against an async int8 elastic service of this process; slot 0's first
    child is killed at its 2nd push and respawned."""
    import os
    import re
    import signal

    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import ParameterService, serve
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        .service import unpack_msg
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig)

    store = ParameterStore(dict(init), StoreConfig(
        mode="async", total_workers=2, push_codec="int8", staleness_bound=5,
        elastic=True, worker_timeout=3.0))
    svc = ParameterService(store)
    pushes: list = []
    registered: list = []
    push_inner, register_inner = svc.push_gradrients, svc.register_worker

    def push_recorded(request, ctx):
        reply = push_inner(request, ctx)
        meta, rmeta = unpack_msg(request)[0], unpack_msg(reply)[0]
        pushes.append((time.perf_counter(), meta.get("worker_id"),
                       str(meta.get("push_token")),
                       bool(rmeta.get("accepted")),
                       bool(rmeta.get("duplicate"))))
        return reply

    def register_recorded(request, ctx):
        reply = register_inner(request, ctx)
        registered.append((time.perf_counter(),
                           unpack_msg(request)[0].get("worker_name"),
                           unpack_msg(reply)[0].get("worker_id")))
        return reply

    svc.push_gradrients = push_recorded
    svc.register_worker = register_recorded
    server, port = serve(store, port=0, service=svc, host="127.0.0.1")
    repo = Path(__file__).resolve().parent
    argv = [sys.executable, "-m",
            "distributed_parameter_server_for_ml_training_tpu_torch.cli",
            "supervise", "--workers", "2", "--respawn-backoff", "0.5",
            "--slot-faults", "0:seed=7;push.kill@n=2", "--",
            "--server", f"127.0.0.1:{port}", "--synthetic", "--num-train",
            "1024", "--num-test", "256", "--epochs", "1", "--heartbeat",
            "0.5"]
    lines: list = []
    seen_smi: list = []
    maps: dict = {}
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=repo, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            env={**os.environ, "PYTHONPATH": str(repo)})
    reader = threading.Thread(target=_read_lines, args=(proc.stdout, lines),
                              daemon=True)
    reader.start()
    timed_out = False
    try:
        while proc.poll() is None:
            if time.perf_counter() - t0 > SUPERVISE_TIMEOUT:
                timed_out = True
                break
            children = [int(m) for _, ln in list(lines) if ln
                        for m in re.findall(r"SUPERVISOR_SPAWN .* pid=(\d+)",
                                            ln)]
            try:
                seen_smi.append(_smi_pids())
            except (OSError, subprocess.SubprocessError):
                pass
            for pid in [proc.pid] + children:
                if _maps_cuda(pid):
                    maps[pid] = True
                else:
                    maps.setdefault(pid, False)
            time.sleep(0.5)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        rc = proc.wait(30)
        reader.join(10)
        server.stop(grace=None).wait(10)
    seconds = time.perf_counter() - t0
    text = _lines_text(lines)
    spawns = [(int(s), int(a), int(p)) for s, a, p in re.findall(
        r"SUPERVISOR_SPAWN slot=(\d+) attempt=(\d+) pid=(\d+)", text)]
    child_pids = {p for _, _, p in spawns}
    died_at = next((t for t, ln in lines
                    if ln and ln.startswith("SUPERVISOR_CHILD_DIED slot=0")),
                   None)
    # The replacement: slot 0's second registration; its first push.
    slot0 = [(t, w) for t, name, w in registered if name == "sup-w0"]
    first_push = next((t for t, w, _, _, _ in pushes
                       if len(slot0) > 1 and w == slot0[1][1]
                       and t > slot0[1][0]), None)
    respawn_s = first_push - died_at \
        if first_push is not None and died_at is not None else None
    applied: dict = {}
    for _, _, token, accepted, duplicate in pushes:
        if accepted and not duplicate:
            applied[token] = applied.get(token, 0) + 1
    smi_all = set().union(*seen_smi) if seen_smi else set()
    smi_visible = os.getpid() in smi_all
    out = {"rc": rc, "timed_out": timed_out, "seconds": seconds,
           "spawns": spawns, "registrations": [[n, w] for _, n, w
                                               in registered],
           "pushes": len(pushes),
           "pushes_applied": sum(applied.values()),
           "store_step": store.global_step,
           "respawn_to_first_push_s": respawn_s,
           "smi_lists_this_process": smi_visible,
           "smi_children": sorted(child_pids & smi_all),
           "smi_supervisor": proc.pid in smi_all,
           "cuda_mapped": {str(k): v for k, v in maps.items()},
           "log_tail": text[-1500:] if rc != 0 or timed_out else ""}
    problems = []
    if rc != 0 or timed_out:
        problems.append(f"supervisor rc {rc}, timed out {timed_out}")
    if not re.search(r"SUPERVISOR_CHILD_DIED slot=0 .*\n(.*\n)*"
                     r"SUPERVISOR_RESPAWN slot=0 attempt=2", text):
        problems.append("no death and respawn of slot 0")
    if not all(f"SUPERVISOR_DONE slot={s} rc=0" in text for s in (0, 1)):
        problems.append("a slot did not finish")
    if any(n > 1 for n in applied.values()):
        problems.append(f"tokens applied twice: "
                        f"{[t for t, n in applied.items() if n > 1]}")
    if respawn_s is None:
        problems.append("no push of the replacement seen")
    if maps.get(proc.pid) or out["smi_supervisor"]:
        problems.append("the supervisor holds a CUDA context")
    live = {p for s, a, p in spawns if (s, a) != (0, 1)}
    if not all(maps.get(p) for p in live):
        problems.append(f"children without the CUDA library: {maps}")
    if smi_visible and not live <= smi_all:
        problems.append(f"children missing from nvidia-smi: "
                        f"{sorted(live - smi_all)}")
    failures.extend(f"(c) {p}" for p in problems)
    out["problems"] = problems
    return out


def phase_reshard_supervise(state: dict) -> None:
    """Phase 29: live resharding on the card and through coordinator
    processes, then ``cli supervise`` with its children on the card. (c)
    runs on a thread from the start, beside (a) and (b): its children
    spend most of their time importing torch."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    failures: list = []
    t0 = time.perf_counter()
    grads, init = _shard_gradients(SHARD_PUSHES, 29)
    torch.cuda.synchronize()
    c_out: dict = {}
    c_failures: list = []

    def drill() -> None:
        t = time.perf_counter()
        try:
            c_out.update(_supervise_drill(init, c_failures))
        except Exception as e:  # noqa: BLE001 — reported, fails it
            traceback.print_exc()
            c_out["error"] = repr(e)
            c_failures.append(f"(c) raised {e!r}")
        c_out["seconds"] = time.perf_counter() - t

    c_thread = threading.Thread(target=drill, daemon=True)
    c_thread.start()
    Q.wire_quantize_multi.launches = 0
    t = time.perf_counter()
    tier = None
    moved, slots, a_rec = [], None, {}
    for backend in ("device", "python"):
        tb = time.perf_counter()
        try:
            t_, rec = _reshard_live(backend, grads, init, failures)
        except Exception as e:  # noqa: BLE001 — reported, fails it
            traceback.print_exc()
            failures.append(f"(a) {backend} raised {e!r}")
            continue
        rec["seconds"] = time.perf_counter() - tb
        a_rec[backend] = rec
        if backend == "python":
            tier, moved, slots = t_, rec.pop("moved"), rec["slots"]
        else:
            rec.pop("moved")
            t_.close()
    emit({"phase": "reshard_supervise", "form": "a_live_move", **a_rec,
          "seconds": time.perf_counter() - t, "card": state["card"]})
    t = time.perf_counter()
    b = {}
    if tier is not None:
        try:
            b = _reshard_matrix(tier, grads, *slots, moved, failures)
        except Exception as e:  # noqa: BLE001 — reported, fails it
            traceback.print_exc()
            failures.append(f"(b) raised {e!r}")
        finally:
            tier.close()
    launches = Q.wire_quantize_multi.launches
    int8_pushes = 4 + b.get("int8_pushes", 0)
    want = -(-len(init) // Q.WIRE_MAX_ENTRIES) * int8_pushes
    state["reshard_k1_launches"] = launches
    if launches != want:
        failures.append(f"K1 launched {launches} times for {int8_pushes} "
                        f"int8 pushes; expected {want}")
    emit({"phase": "reshard_supervise", "form": "b_crash_matrix", **b,
          "k1_launches": launches, "k1_launches_expected": want,
          "seconds": time.perf_counter() - t, "card": state["card"]})
    c_thread.join(SUPERVISE_TIMEOUT + 60)
    if c_thread.is_alive():
        c_failures.append("(c) did not end")
    failures.extend(c_failures)
    emit({"phase": "reshard_supervise", "form": "c_supervise", **c_out,
          "card": state["card"]})
    emit({"phase": "reshard_supervise", "form": "summary",
          "seconds": time.perf_counter() - t0, "failures": failures,
          "card": state["card"]})
    if failures:
        raise AssertionError(f"phase 29: {failures}")

#: Phase 30 (b)'s ``cli serve --jobs`` spec: a sync job of one worker and
#: an async job of weight 3 with its own staleness bound.
TENANCY_JOBS = ("joba:mode=sync,total_workers=1;"
                "jobb:weight=3,mode=async,staleness_bound=4")
#: (a)'s jobs beside ``default``: two async jobs, weights 1 and 3.
TENANCY_INPROC_JOBS = "joba:mode=async;jobb:mode=async,weight=3"
TENANCY_PUSHES = 2         # (a): int8 pushes a job, real gradients
TENANCY_TRAIN = 512        # (b): images a worker, 4 steps of 128
TENANCY_LOADGEN_S = 1.0    # (b): seconds of ``cli loadgen --job joba,jobb``
TENANCY_TIMEOUT_S = 240    # (b): each process, start to exit


def _tenancy_in_process(state: dict, failures: list) -> dict:
    """(a) A port ``ParameterService`` with a ``JobManager`` of two jobs
    beside ``default`` on 127.0.0.1, and a ``RemoteStore(job=...)`` a job
    on this process's card, both with the same push nonce (so both jobs
    receive the same push tokens): each push is a real ResNet-18
    gradient set of batch 128 encoded by the job's ``DeviceCodec`` (K1).
    Each job's store must stay bit-equal to a solo store fed the same
    frames, each fetch must be the job's own params, and ``default`` must
    stay untouched."""
    import dataclasses as dc

    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import ParameterService, RemoteStore, serve
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q
    from distributed_parameter_server_for_ml_training_tpu_torch.ops \
        .device_codec import DeviceCodec
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig)
    from distributed_parameter_server_for_ml_training_tpu_torch.ps \
        .tenancy import JobManager, parse_jobs_spec

    names = ("joba", "jobb")
    grads, init = _shard_gradients(len(names) * TENANCY_PUSHES, 30)
    torch.cuda.synchronize()
    primary = ParameterStore({k: v.copy() for k, v in init.items()},
                             StoreConfig(mode="async", total_workers=2,
                                         push_codec="int8"))
    jobs = JobManager(primary, parse_jobs_spec(TENANCY_INPROC_JOBS))
    svc = ParameterService(primary, jobs=jobs)
    server, port = serve(primary, port=0, service=svc, host="127.0.0.1")
    addr = f"127.0.0.1:{port}"
    solo = {j: ParameterStore({k: v.copy() for k, v in init.items()},
                              dc.replace(jobs.store_for(j).config))
            for j in names}
    remotes = {j: RemoteStore(addr, job=j) for j in names}
    codecs = {j: DeviceCodec() for j in names}
    times = {j: {} for j in names}
    nonce = remotes["joba"]._push_nonce
    outcomes, tokens = [], {j: [] for j in names}
    Q.wire_quantize_multi.launches = 0
    try:
        ids = {}
        for j in names:
            remotes[j]._push_nonce = nonce
            _rpc_timer(remotes[j], times[j])
            ids[j] = remotes[j].register_worker(f"tenant-{j}")[0]
            solo[j].register_worker("solo")
        for i in range(TENANCY_PUSHES):
            for n, j in enumerate(names):
                params, step = remotes[j].fetch(ids[j])
                own, own_step = jobs.store_for(j).snapshot()
                if own_step != step or sorted(params) != sorted(own) \
                        or any(params[k].tobytes() != own[k].tobytes()
                               for k in own):
                    failures.append(f"(a) {j}'s fetch at step {step} is "
                                    f"not its store's")
                payload = codecs[j].encode_now(
                    grads[len(names) * i + n])
                outcomes.append((j, remotes[j].push(ids[j], payload, step),
                                 solo[j].push(0, payload, step)))
                tokens[j].append(remotes[j]._last_push[0])
        launches = Q.wire_quantize_multi.launches
        journals = {j: svc.journal_snapshot(job=j) for j in names}
    finally:
        for r in remotes.values():
            r.close()
        server.stop(grace=None).wait(10)
    pushes = len(names) * TENANCY_PUSHES
    want = -(-len(init) // Q.WIRE_MAX_ENTRIES) * pushes
    state["tenancy_k1_launches"] = launches
    diffs = {}
    for j in names:
        (gp, gs), (sp, ss) = jobs.store_for(j).snapshot(), solo[j].snapshot()
        diffs[j] = [k for k in sp if gp[k].tobytes() != sp[k].tobytes()] \
            + ([f"step {gs} != {ss}"] if gs != ss else [])
    dp, ds = primary.snapshot()
    default_diff = [k for k in init if dp[k].tobytes() != init[k].tobytes()]
    if not all(a and b for _, a, b in outcomes):
        failures.append(f"(a) pushes refused: {outcomes}")
    if any(diffs.values()):
        failures.append(f"(a) job stores differ from their solo stores: "
                        f"{diffs}")
    if default_diff or ds != 0:
        failures.append(f"(a) default moved: step {ds}, {default_diff}")
    if launches != want:
        failures.append(f"(a) K1 launched {launches} times for {pushes} "
                        f"pushes; expected {want}")
    if tokens["joba"] != tokens["jobb"] or any(
            {e["nonce"] for e in journals[j]} != {f"{j}::{nonce}"}
            for j in names):
        failures.append(f"(a) tokens {tokens}, journals {journals}")
    med = lambda d: {k: float(np.median(v))  # noqa: E731
                     for k, v in sorted(d.items())}
    return {"addr": addr, "pushes": pushes, "k1_launches": launches,
            "k1_launches_expected": want, "same_tokens": tokens,
            "steps": {j: jobs.store_for(j).global_step for j in names},
            "solo_bit_equal": {j: not d for j, d in diffs.items()},
            "default_untouched": not default_diff and ds == 0,
            "rpc_ms_median_by_job": {j: med(times[j]) for j in names},
            "view": {j: {k: v for k, v in row.items() if k != "slots"}
                     for j, row in jobs.view().items()}}


def _tenancy_processes(state: dict, failures: list) -> dict:
    """(b) ``cli serve --jobs TENANCY_JOBS --push-codec int8
    --checkpoint-dir D`` and two ``cli worker --job`` processes on the
    card started together; meanwhile ``cli loadgen --job joba,jobb`` and
    a ``SubmitJob``/drain of a third job over the admin plane. Then
    SIGTERM and ``serve ... --restore``: each job's step and params
    restored from ``D/job-<name>/``, a cross-job restore refused, and no
    job's push token in another job's lineage."""
    import os
    import re
    import shutil
    import signal
    import tempfile

    from distributed_parameter_server_for_ml_training_tpu_torch \
        .checkpoint import load_store_record, restore_server_state
    from distributed_parameter_server_for_ml_training_tpu_torch.comms \
        import RemoteStore
    from distributed_parameter_server_for_ml_training_tpu_torch.ps import (
        ParameterStore, StoreConfig)

    names = ("joba", "jobb")
    cli = [sys.executable, "-m",
           "distributed_parameter_server_for_ml_training_tpu_torch.cli"]
    repo = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    d = tempfile.mkdtemp(prefix="tenancy-ckpt-")
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    serve_argv = cli + ["serve", "--jobs", TENANCY_JOBS, "--mode", "async",
                        "--workers", "1", "--push-codec", "int8",
                        "--checkpoint-dir", d, "--checkpoint-interval",
                        "3600", "--port", str(port)]
    procs, readers = [], []

    def start(argv, lines, stream="stderr"):
        log = tempfile.TemporaryFile("w+")
        p = subprocess.Popen(
            argv, cwd=repo, env=env, text=True,
            stdout=subprocess.PIPE if stream == "stdout" else log,
            stderr=subprocess.PIPE if stream == "stderr" else log)
        procs.append((p, log))
        readers.append(threading.Thread(target=_read_lines, args=(
            getattr(p, stream), lines), daemon=True))
        readers[-1].start()
        return p

    def wait_up(lines, t_spawn) -> float:
        while time.perf_counter() - t_spawn < TENANCY_TIMEOUT_S:
            for t, line in list(lines):
                if line is None:
                    raise AssertionError(f"cli serve exited: "
                                         f"{_lines_text(lines)[-1500:]}")
                if "parameter server up on" in line:
                    return t
            time.sleep(0.01)
        raise AssertionError("cli serve did not come up")

    out: dict = {"jobs": TENANCY_JOBS}
    try:
        srv_lines: list = []
        t0 = time.perf_counter()
        server = start(serve_argv, srv_lines)
        # The workers start with the server: both spend their first
        # seconds importing torch, and a worker's registration retries for
        # 15 s past its first try (RemoteStore's 5 tries, backoff from
        # 1 s), which comes after its own import.
        wrk_lines = [[] for _ in names]
        workers = [start(cli + [
            "worker", "--server", addr, "--job", j, "--worker-name",
            f"tenant-{j}", "--synthetic", "--num-train", str(TENANCY_TRAIN),
            "--num-test", "128", "--epochs", "1", "--emit-metrics"],
            wrk_lines[i], stream="stdout") for i, j in enumerate(names)]
        out["serve_up_s"] = wait_up(srv_lines, t0) - t0
        rc, lg = _cli_line(["loadgen", "--targets", addr, "--job",
                            ",".join(names), "--duration",
                            str(TENANCY_LOADGEN_S), "--concurrency", "2",
                            "--fetch-mode", "delta"], "LOADGEN_JSON ")
        out["loadgen"] = {"rc": rc, "qps": lg and lg["qps"],
                          "errors": lg and lg["fetches_err"],
                          "jobs": lg and lg.get("jobs")}
        if rc != 0 or not lg or lg["fetches_err"] or \
                sorted(lg.get("jobs") or {}) != sorted(names):
            failures.append(f"(b) loadgen {out['loadgen']}")
        admin = RemoteStore(addr)
        try:
            sub = admin.submit_job("jobc:mode=async")
            drained = admin.drain_job("jobc")
        finally:
            admin.close()
        out["admin"] = {"submit": sub, "drain": drained}
        if sub.get("submitted") != "jobc" or sub.get("index") != 3 \
                or drained != {"drained": True,
                               "jobs": ["default", *names]}:
            failures.append(f"(b) admin plane {out['admin']}")
        for w in workers:
            w.wait(timeout=TENANCY_TIMEOUT_S)
        rows = [_metrics_rows(_lines_text(lines)) for lines in wrk_lines]
        out["worker_rcs"] = [w.returncode for w in workers]
        out["img_per_s"] = dict(zip(names, _worker_img_s(rows)))
        steps = {j: r[-1]["local_steps_completed"] if r else None
                 for j, r in zip(names, rows)}
        out["worker_steps"] = steps
        if out["worker_rcs"] != [0, 0]:
            failures.append(f"(b) worker rcs {out['worker_rcs']}: "
                            + " | ".join(_lines_text(lines)[-800:]
                                         for lines in wrk_lines))
        server.send_signal(signal.SIGTERM)
        server.wait(timeout=60)
        out["serve_rc"] = server.returncode
        lineages = {}
        for j in ("default", *names):
            jdir = d if j == "default" else os.path.join(d, f"job-{j}")
            params, meta = load_store_record(jdir)
            lineages[j] = (params, meta)
        out["lineage_steps"] = {j: m["global_step"]
                                for j, (_, m) in lineages.items()}
        cross = {j: sum(1 for e in m["push_journal"]
                        if (e["nonce"].split("::")[0] if "::" in e["nonce"]
                            else "default") != j)
                 for j, (_, m) in lineages.items()}
        out["cross_job_tokens"] = cross
        out["journal_sizes"] = {j: len(m["push_journal"])
                                for j, (_, m) in lineages.items()}
        if out["serve_rc"] != 143 or any(cross.values()) \
                or out["lineage_steps"] != {"default": 0, **steps} \
                or any(out["journal_sizes"][j] != 1 for j in names):
            failures.append(f"(b) lineages: rc {out['serve_rc']}, steps "
                            f"{out['lineage_steps']} (workers {steps}), "
                            f"cross-job tokens {cross}, journals "
                            f"{out['journal_sizes']}")
        # A lineage restores only into its own job.
        params_a = lineages["joba"][0]
        try:
            restore_server_state(ParameterStore(params_a, StoreConfig(
                mode="async", total_workers=1, push_codec="int8",
                job_id="jobb")), None, os.path.join(d, "job-joba"))
            out["cross_job_restore"] = "accepted"
        except ValueError as e:
            out["cross_job_restore"] = str(e)
        if "cross-job" not in out["cross_job_restore"]:
            failures.append(f"(b) cross-job restore "
                            f"{out['cross_job_restore']}")
        # The restart: each job from its own lineage.
        again: list = []
        t1 = time.perf_counter()
        restarted = start(serve_argv + ["--restore"], again)
        out["restore_up_s"] = wait_up(again, t1) - t1
        text = _lines_text(again)
        out["restored"] = {m.group(1): int(m.group(2)) for m in re.finditer(
            r"restored job '(\w+)' at step (\d+)", text)}
        served = {}
        for j in names:
            r = RemoteStore(addr, job=j)
            try:
                wid, _ = r.register_worker(f"check-{j}")
                params, step = r.fetch(wid)
            finally:
                r.close()
            ref = lineages[j][0]
            served[j] = {"step": step, "bit_equal": sorted(params)
                         == sorted(ref) and all(
                             params[k].tobytes() == ref[k].tobytes()
                             for k in ref)}
        out["served_after_restore"] = served
        restarted.send_signal(signal.SIGTERM)
        restarted.wait(timeout=60)
        if out["restored"] != steps or any(
                served[j] != {"step": steps[j], "bit_equal": True}
                for j in names):
            failures.append(f"(b) restore: {out['restored']}, served "
                            f"{served}, want {steps}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
        for r in readers:
            r.join(10)
        shutil.rmtree(d, ignore_errors=True)
    return out


def phase_tenancy(state: dict) -> None:
    """Phase 30: multi-job tenancy. (b)'s processes run on a thread from
    the start, beside (a): their workers spend seconds importing torch."""
    failures: list = []
    t0 = time.perf_counter()
    b_out: dict = {}
    b_failures: list = []

    def processes() -> None:
        t = time.perf_counter()
        try:
            b_out.update(_tenancy_processes(state, b_failures))
        except Exception as e:  # noqa: BLE001 — reported, fails it
            traceback.print_exc()
            b_failures.append(f"(b) raised {e!r}")
        b_out["seconds"] = time.perf_counter() - t

    b_thread = threading.Thread(target=processes, daemon=True)
    b_thread.start()
    t = time.perf_counter()
    a_out: dict = {}
    try:
        a_out = _tenancy_in_process(state, failures)
    except Exception as e:  # noqa: BLE001 — reported, fails it
        traceback.print_exc()
        failures.append(f"(a) raised {e!r}")
    a_out["seconds"] = time.perf_counter() - t
    emit({"phase": "tenancy", "form": "a_in_process", **a_out,
          "card": state["card"]})
    b_thread.join(TENANCY_TIMEOUT_S * 3)
    if b_thread.is_alive():
        b_failures.append("(b) did not end")
    failures.extend(b_failures)
    emit({"phase": "tenancy", "form": "b_processes", **b_out,
          "card": state["card"]})
    emit({"phase": "tenancy", "form": "summary",
          "seconds": time.perf_counter() - t0, "failures": failures,
          "card": state["card"]})
    if failures:
        raise AssertionError(f"phase 30: {failures}")


# ---------------------------------------------------------------------------
# Phase 31: MoE experts and pipeline stages spread over ranks
# ---------------------------------------------------------------------------

MPM_BATCH, MPM_E, MPM_STAGES, MPM_M = 32, 4, 4, 8  # ViT-B/16, 224 px
MPM_TIMED_STEPS = 1           # (b), (c): bf16 steps timed after the epoch
MPM_TIMEOUT_S = 240           # (b), (c): each rank process, start to exit


def _mpm_dataset():
    from distributed_parameter_server_for_ml_training_tpu_torch.data \
        import synthetic_imagenet

    return synthetic_imagenet(n_train=MPM_BATCH, n_test=MPM_BATCH,
                              num_classes=1000, image_size=224, seed=31)


def _mpm_trainer(ds, kind: str, dtype: str, group=None):
    """An MoE (4 experts) or pipeline (4 stages x 8 microbatches) trainer
    of ViT-B/16 at 224 px on ``ds`` (:func:`_mpm_dataset`), batch 32, one
    epoch of one step, no augmentation, from seed 0 (every rank and one
    process draw the same weights)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.train \
        .model_parallel import (ModelParallelConfig, MoETrainer,
                                PipelineTrainer)

    cfg = ModelParallelConfig(
        model="vit_b16", num_workers=MPM_E if kind == "moe" else MPM_STAGES,
        pp_microbatches=MPM_M, batch_size=MPM_BATCH, num_epochs=1,
        num_classes=1000, dtype=dtype, augment=False, device="cuda")
    cls = MoETrainer if kind == "moe" else PipelineTrainer
    return cls(ds, cfg, group=group)


def _mpm_1f1b(trainer):
    """One 1F1B step (``make_pipeline_train_step``) over the trainer's
    stages (this rank's, over ranks) on seeded fp32 activations ``[32,
    197, 768]`` and targets: the loss and the stacked gradients."""
    import torch
    from torch.func import functional_call

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        .pipeline import make_pipeline_train_step

    template = trainer.model.stages
    stacked = {k: v.detach() for k, v in template.named_parameters()}
    gen = torch.Generator().manual_seed(310)
    x = torch.randn(MPM_BATCH, PP_TOKENS, 768, generator=gen).cuda()
    y = torch.randn(MPM_BATCH, PP_TOKENS, 768, generator=gen).cuda()
    step = make_pipeline_train_step(
        trainer.mesh, lambda p, h: functional_call(template, p, (h,)),
        lambda pred, target: torch.mean((pred - target) ** 2), MPM_M,
        schedule="1f1b")
    loss, grads = step(stacked, x, y)
    return loss, grads


def _mpm_shared(trainer) -> list:
    """The leaves every rank holds whole: all but the experts' rows
    (MoE), the prologue and epilogue (pipeline)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import rank_stacked

    return [v for k, v in trainer.state.params.items()
            if not rank_stacked(k)]


def _mpm_bytes_model(trainer, kind: str, rank: int, ranks: int) -> dict:
    """The step's collective bytes from the shapes
    (``utils/collective_bytes.py``)."""
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        import collective_bytes as cb
    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import rank_stacked

    model = trainer.model
    if kind == "moe":
        replicated = sum(p.numel() for n, p in model.named_parameters()
                         if not rank_stacked(n))
        return cb.moe_step_bytes(ranks, MPM_E, trainer.capacity, 768,
                                 model.depth, replicated)
    width = 2 if trainer.config.dtype == "bfloat16" else 4
    return cb.pipeline_step_bytes(
        ranks, rank, MPM_M, MPM_BATCH // MPM_M * PP_TOKENS * 768 * width,
        MPM_BATCH * 768 * width,
        sum(p.numel() for p in model.prologue.parameters()))


def _mpm_params(trainer) -> dict:
    return {k: v.detach().clone() for k, v in trainer.state.params.items()}


def _mpm_max_rel(got: dict, want: dict) -> float:
    """The largest max |a - b| / max |b| over the leaves, in float64 on
    the card."""
    import torch

    out = 0.0
    for k, b in want.items():
        a, b = got[k].to(b.device, torch.float64), b.double()
        out = max(out, float((a - b).abs().max()
                             / b.abs().max().clamp_min(1e-30)))
    return out


def _mpm_save(obj, path: Path) -> None:
    """``torch.save`` under a temporary name, then renamed: the phase's
    process reads the file as soon as it is there."""
    import torch

    part = path.with_suffix(".part")
    torch.save(obj, part)
    os.replace(part, path)


def _mpm_one_rank(state: dict) -> dict:
    """(a): one fp32 step of each trainer on one process, then through a
    one-rank NCCL group, cuDNN deterministic; the one-process params are
    kept for (b). The pipeline's 1F1B step on its fresh weights too."""
    import torch
    import torch.distributed as dist

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import multihost as mh

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out, refs, problems = {}, {}, []
    ds = _mpm_dataset()
    try:
        for kind in ("moe", "pp"):
            one = _mpm_trainer(ds, kind, "float32")
            if kind == "pp":
                refs["1f1b"] = _mpm_1f1b(one)
            one.train()
            refs[kind] = _mpm_params(one)
            del one
        torch.cuda.empty_cache()
        mh.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda")
        try:
            group = mh.world_group()
            for kind in ("moe", "pp"):
                rk = _mpm_trainer(ds, kind, "float32", group)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rk.train()
                torch.cuda.synchronize()
                got = _mpm_params(rk)
                equal = all(torch.equal(got[k], v)
                            for k, v in refs[kind].items())
                rel = _mpm_max_rel(got, refs[kind])
                bytes_step = rk.collective_bytes_step
                want = _mpm_bytes_model(rk, kind, 0, 1)
                out[kind] = {"params_bit_equal_to_one_process": equal,
                             "params_max_rel_err": rel,
                             "epoch_seconds": time.perf_counter() - t0,
                             "collective_bytes_step": bytes_step,
                             "bytes_model": want}
                if not equal:
                    problems.append(
                        f"(a) {kind}: one NCCL rank's step is not bit-equal "
                        f"to one process's (max rel err {rel}): over one "
                        f"rank every collective is a copy and every "
                        f"product the one process's")
                if bytes_step != want:
                    problems.append(f"(a) {kind} bytes {bytes_step} != "
                                    f"{want}")
                del rk
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = det
    out["backend"] = "nccl"
    out["problems"] = problems
    state["mpm_refs"] = refs
    return out


def mp_rank(argv: list) -> int:
    """One rank process of phase 31 (b)/(c): ``rank backend port
    out_dir``. Over 2 ranks: the fp32 MoE trainer's step (its params
    saved), the fp32 pipeline's 1F1B step on its fresh weights and its
    trainer step (both saved), the ranks' shared leaves compared bit for
    bit; then each trainer in bf16: its epoch (kernel counts reset just
    before), :data:`MPM_TIMED_STEPS` steps timed, one profiled step, the
    step's collective bytes. Writes ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from distributed_parameter_server_for_ml_training_tpu_torch.parallel \
        import multihost as mh

    rank, backend, port = int(argv[0]), argv[1], argv[2]
    out = Path(argv[3])
    # The script's numerics (main): no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    start = time.perf_counter()
    dev = mh.initialize(f"127.0.0.1:{port}", 2, rank, backend=backend,
                        device="cuda")
    ds = _mpm_dataset()
    # Seconds from the call to the end of each part.
    res: dict = {"rank": rank, "device": str(dev),
                 "seconds": {"joined": time.perf_counter() - start}}
    group = mh.world_group()
    # The bf16 trainers are drawn on a thread while the fp32 ones train:
    # their draws are CPU work that releases the interpreter lock, and a
    # trainer's construction issues no collective.
    later = ThreadPoolExecutor(1)
    bf16 = {kind: later.submit(_mpm_trainer, ds, kind, "bfloat16", group)
            for kind in ("moe", "pp")}
    try:
        for kind in ("moe", "pp"):
            tr = _mpm_trainer(ds, kind, "float32", group)
            if kind == "pp":
                loss, grads = _mpm_1f1b(tr)
                _mpm_save({"loss": loss.cpu(),
                           "grads": {k: v.cpu() for k, v in grads.items()}},
                          out / f"f1b{rank}.pt")
            tr.train()
            _mpm_save({k: v.cpu() for k, v in _mpm_params(tr).items()},
                      out / f"{kind}{rank}.pt")
            res[f"{kind}_fp32_shared_identical"] = mh.ranks_identical(
                _mpm_shared(tr), group)
            res["seconds"][f"{kind}_fp32"] = time.perf_counter() - start
            del tr
            torch.cuda.empty_cache()
        for kind in ("moe", "pp"):
            tr = bf16.pop(kind).result()
            torch.cuda.synchronize()
            _reset_counts_all()
            t0 = time.perf_counter()
            tr.train()
            torch.cuda.synchronize()
            epoch_s = time.perf_counter() - t0
            counts = _counts_all()
            xb, yb = tr.dataset.x_train, tr.dataset.y_train
            gen = torch.Generator(device=dev).manual_seed(3)
            times = []
            for _ in range(MPM_TIMED_STEPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tr._train_batch(xb, yb, gen)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t1))
            prof = _profile_one(lambda: tr._train_batch(xb, yb, gen), 1)
            res[kind] = {
                "epoch_seconds": epoch_s, "launches": counts,
                "step_ms": times, "profiled_step": prof,
                "collective_bytes_step": tr.collective_bytes_step,
                "bytes_model": _mpm_bytes_model(tr, kind, rank, 2),
                "shared_identical": mh.ranks_identical(
                    _mpm_shared(tr), group),
                "train_loss": tr.train_loss_per_epoch,
                "test_accuracies": tr.test_accuracies,
                "peak_memory_gib":
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30}
            if kind == "moe":
                res[kind]["capacity"] = tr.capacity
                res[kind]["moe_metrics_last_step"] = {
                    k: float(v) for k, v in tr._moe_step_metrics[-1].items()}
            res["seconds"][f"{kind}_bf16"] = time.perf_counter() - start
            del tr
            torch.cuda.empty_cache()
        (out / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        for f in bf16.values():
            f.cancel()
        later.shutdown(wait=True)
        dist.destroy_process_group()
    return 0


def _mpm_fp32_checks(state: dict, tmp: Path) -> dict:
    """The ranks' fp32 trainer steps and 1F1B step (files in ``tmp``)
    against (a)'s one-process ones: relative error and bit equality."""
    import torch

    from distributed_parameter_server_for_ml_training_tpu_torch.utils \
        .pytree import join_rank_rows

    refs, out = state["mpm_refs"], {}
    for kind in ("moe", "pp"):
        got = join_rank_rows([torch.load(tmp / f"{kind}{r}.pt",
                                         weights_only=True)
                              for r in range(2)])
        got = {k: v.cuda() for k, v in got.items()}
        out[kind] = {
            "params_max_rel_err_vs_one_process": _mpm_max_rel(got,
                                                              refs[kind]),
            "params_bit_equal_to_one_process": all(
                torch.equal(got[k], v) for k, v in refs[kind].items())}
    f1b = [torch.load(tmp / f"f1b{r}.pt", weights_only=True)
           for r in range(2)]
    loss_ref, grads_ref = refs["1f1b"]
    grads = {k: torch.cat([f["grads"][k] for f in f1b]).cuda()
             for k in grads_ref}
    out["1f1b"] = {
        "loss_rel_err": [abs(float(f["loss"]) - float(loss_ref))
                         / abs(float(loss_ref)) for f in f1b],
        "grads_max_rel_err_vs_one_process": _mpm_max_rel(grads, grads_ref),
        "grads_bit_equal_to_one_process": all(
            torch.equal(grads[k], v) for k, v in grads_ref.items())}
    return out


def _mpm_processes(state: dict, backend: str, form: str,
                   while_starting=None) -> dict:
    """Phase 31 (b)/(c): 2 rank processes (:func:`mp_rank`) against the
    one-process fp32 steps of (a). ``while_starting(state)`` runs in this
    process while the ranks start (phase 31 runs (a) there)."""
    import os
    import shutil
    import tempfile

    import torch

    torch.cuda.empty_cache()
    repo = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mpm_"))
    launcher = ("import sys, chip_smoke; "
                "sys.exit(chip_smoke.mp_rank(sys.argv[1:]))")
    port = _free_port()
    logs = [tempfile.TemporaryFile("w+") for _ in range(4)]
    procs, late, during, fp32, ran = [], None, None, None, False
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", launcher, str(rank), backend,
                 str(port), str(tmp)], cwd=repo, env=env,
                stdout=logs[2 * rank], stderr=logs[2 * rank + 1], text=True))
        if while_starting is not None:
            during = while_starting(state)
        deadline = t0 + MPM_TIMEOUT_S
        # The fp32 steps' files come first: held to one process's while
        # the ranks go on with bf16.
        names = [f"{kind}{r}.pt" for kind in ("moe", "f1b", "pp")
                 for r in range(2)]
        while not all((tmp / n).exists() for n in names) \
                and time.perf_counter() < deadline \
                and any(p.poll() is None for p in procs):
            time.sleep(0.2)
        fp32 = _mpm_fp32_checks(state, tmp) \
            if all((tmp / n).exists() for n in names) else None
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                late = f"a rank process still alive after {MPM_TIMEOUT_S} s"
                break
        wall = time.perf_counter() - t0
        ran = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        if not ran:                 # the block below removes it otherwise
            shutil.rmtree(tmp, ignore_errors=True)
    try:
        rcs = [p.returncode for p in procs]
        if late is not None or rcs != [0, 0]:
            raise AssertionError(f"{late or f'rank exit codes {rcs}'}. "
                                 f"Output tails: "
                                 f"{[t[-2000:] for t in texts]}")
        if fp32 is None:
            raise AssertionError(f"the ranks wrote no fp32 step. Output "
                                 f"tails: {[t[-2000:] for t in texts]}")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(2)]
        staged = ["staged through the host" in texts[2 * r + 1]
                  for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    res = {"form": form, "backend": backend, "processes": 2,
           "devices": [r["device"] for r in ranks],
           "rank_seconds": [r["seconds"] for r in ranks],
           "collectives_staged_through_host": staged,
           "fp32_step": fp32, "fp32_rel_tol": FP32_REL_TOL,
           "wall_seconds": wall}
    problems = []
    for kind in ("moe", "pp"):
        per = [r[kind] for r in ranks]
        med = float(np.median([t for p in per for t in p["step_ms"]]))
        res[f"{kind}_bf16"] = {
            "step_ms_runs": [p["step_ms"] for p in per],
            "step_ms_median": med,
            "img_per_s_summed": 1e3 * MPM_BATCH / med,
            "device_idle_share": [p["profiled_step"]["device_idle_share"]
                                  for p in per],
            "device_busy_ms_per_step": [
                p["profiled_step"]["device_busy_ms_per_step"] for p in per],
            "top_device_ms": per[0]["profiled_step"]["top_device_ms"][:6],
            "collective_bytes_step": [p["collective_bytes_step"]
                                      for p in per],
            "bytes_model": [p["bytes_model"] for p in per],
            "launches": [p["launches"] for p in per],
            "shared_identical": [p["shared_identical"] for p in per],
            "epoch_seconds": [p["epoch_seconds"] for p in per],
            "train_loss": [p["train_loss"] for p in per],
            "peak_memory_gib": [p["peak_memory_gib"] for p in per]}
        if kind == "moe":
            res["moe_bf16"]["capacity"] = per[0]["capacity"]
            res["moe_bf16"]["moe_metrics_last_step"] = [
                p["moe_metrics_last_step"] for p in per]
            if per[0]["moe_metrics_last_step"] \
                    != per[1]["moe_metrics_last_step"]:
                problems.append("the ranks' MoE metrics differ")
        if any(any(p["launches"].values()) for p in per):
            problems.append(f"{kind}: kernels launched "
                            f"{[p['launches'] for p in per]}: 196 / 197 "
                            f"tokens take the dense core and no codec")
        if not all(p["shared_identical"] for p in per) \
                or not all(r[f"{kind}_fp32_shared_identical"]
                           for r in ranks):
            problems.append(f"{kind}: the ranks' shared leaves differ")
        if any(p["collective_bytes_step"] != p["bytes_model"] for p in per):
            problems.append(f"{kind}: the step's collective bytes differ "
                            f"from the shapes' count")
        if not all(math.isfinite(v) for p in per for v in p["train_loss"]):
            problems.append(f"{kind}: losses {[p['train_loss'] for p in per]}")
        if per[0]["train_loss"] != per[1]["train_loss"]:
            problems.append(f"{kind}: the ranks' losses differ")
        rel = fp32[kind]["params_max_rel_err_vs_one_process"]
        if rel > FP32_REL_TOL:
            problems.append(f"{kind}: one fp32 step's params {rel} from one "
                            f"process's (tolerance {FP32_REL_TOL})")
    f1b_rel = max(fp32["1f1b"]["loss_rel_err"]
                  + [fp32["1f1b"]["grads_max_rel_err_vs_one_process"]])
    if f1b_rel > FP32_REL_TOL:
        problems.append(f"1f1b: {fp32['1f1b']} beyond {FP32_REL_TOL}")
    if backend == "gloo" and not all(staged):
        problems.append("a gloo rank on the card did not say its "
                        "collectives were staged through the host")
    res["problems"] = problems
    if during is not None:
        res["during"] = during
    return res


def phase_model_parallel_multihost(state: dict) -> None:
    """Phase 31: MoE experts and pipeline stages over several processes:
    (b)'s two gloo ranks start first and (a) runs here while they do."""
    import torch

    t0 = time.perf_counter()
    out = {"phase": "model_parallel_multihost", "card": state.get("card")}
    b = _mpm_processes(state, "gloo", "b_two_ranks_one_card_gloo",
                       while_starting=_mpm_one_rank)
    a = b.pop("during")
    out["a_one_rank_nccl"], out["b_two_ranks_one_card_gloo"] = a, b
    problems = a.pop("problems") + b.pop("problems")
    if torch.cuda.device_count() >= 2:
        c = _mpm_processes(state, "nccl", "c_two_ranks_two_cards_nccl")
        problems += c.pop("problems")
        out["c_two_ranks_two_cards_nccl"] = c
    else:
        out["c_two_ranks_two_cards_nccl"] = {
            "run": False, "reason": "not run for want of a second card",
            "device_count": torch.cuda.device_count()}
    state.pop("mpm_refs", None)
    torch.cuda.empty_cache()
    out["problems"] = problems
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    if problems:
        raise RuntimeError(f"model_parallel_multihost: {problems}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    # Stated numerics: no TF32 anywhere (the main path computes in bf16).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import distributed_parameter_server_for_ml_training_tpu_torch  # noqa: F401

    mark = os.environ[RUN_MARK] = f"{os.getpid()}-{time.time_ns()}"
    state: dict = {}
    failed = []
    t_main = time.perf_counter()
    for phase in (phase_build, phase_kernel, phase_kernel_int8, phase_codec,
                  phase_main_path, phase_profile, phase_sync_path,
                  phase_sync_profile, phase_baseline, phase_kernel_flash,
                  phase_sp_path, phase_sp_profile, phase_cli,
                  phase_grpc_path, phase_grpc_modes, phase_device_store,
                  phase_checkpoints, phase_health, phase_models,
                  phase_observability, phase_multihost, phase_sp_multihost,
                  phase_moe, phase_pp, phase_tp, phase_sharded,
                  phase_fleet, phase_serve_tier, phase_reshard_supervise,
                  phase_tenancy, phase_model_parallel_multihost):
        t0 = time.perf_counter()
        try:
            phase(state)
        except Exception:  # noqa: BLE001 — reported, and fails the run
            traceback.print_exc()
            failed.append(phase.__name__)
        print(f"[{phase.__name__}] {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
    strays = stop_strays(mark)
    if strays:
        print(f"chip_smoke: processes outlived their phase, killed: "
              f"{strays}", file=sys.stderr, flush=True)
        failed.append("stray_processes")
    print(f"[total] {time.perf_counter() - t_main:.1f}s", file=sys.stderr,
          flush=True)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        flash_attention as FA
    from distributed_parameter_server_for_ml_training_tpu_torch.ops import \
        quantize as Q

    # K1 with its launches from the async path's run, the gRPC path's
    # (phase 14 (a); the worker processes of (b) and of phase 26 (b) are
    # other processes, read off their captures), the gRPC modes' (phase 15
    # (a)), the health path's (phase 18 (a)), the models' (phase 19 (c),
    # (d), (e)), the serve surfaces' (phase 20 (b)), the sharded tier's
    # (phase 26 (a)), the serve tier's (phase 28 (b)), the live
    # resharding's (phase 29 (a), (b)) and tenancy's (phase 30 (a)); a
    # push's times.
    kernels = []
    for name, k in state["k1"].items():
        kernels.append({
            "name": name, "route": "cuda", "source": Q.KERNEL_SOURCE,
            "replaces": Q.REPLACES[name],
            "launches": state["k1_launches"][name]
            + state["grpc_k1_launches"][name]
            + state["modes_k1_launches"][name]
            + state["health_k1_launches"][name]
            + state["models_k1_launches"]
            + state["observe_k1_launches"]
            + state["sharded_k1_launches"][name]
            + state["serve_tier_k1_launches"]
            + state["reshard_k1_launches"]
            + state["tenancy_k1_launches"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None})
    # K2-K4 launches from the sync path's runs (phase 7, phase 19 (b),
    # (d), and phase 21's multi-rank runs: (a)'s NCCL rank and each rank
    # process of (b) and (c)): the ring rounds stochastically, so K2
    # (nearest rounding) reads 0 there. No single PyTorch call computes a
    # block quantize, so K2's and K3's library_ms is null; K4's is one
    # torch.mul of the blocks by their scales (phase 3).
    launches = {k: v + state["models_block_counts"][k]
                + state["multihost_counts"][k]
                for k, v in state["sync_counts"].items()}
    for name, k in state["block"].items():
        kernels.append({
            "name": name, "route": "cuda", "source": Q.BLOCK_KERNEL_SOURCE,
            "replaces": Q.BLOCK_REPLACES[name], "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"]})
    # The wgmma forward (the K5 entry on bf16) and the fused backward (the
    # K6/K7 entry) with their launches from the SP path's run and phase
    # 22's runs over ranks ((a)'s NCCL rank, each rank process of (b) and
    # (c)), then the first versions of K5, K6 and K7, which run on fp32
    # inputs and so on no step of that bf16 path; times at its hop shape.
    # The library's backward computes dQ, dK and dV in one call: its time
    # stands beside every backward entry.
    for name, k in state["flash"].items():
        kernels.append({
            "name": name, "route": "cuda", "source": FA.KERNEL_SOURCE,
            "replaces": FA.REPLACES[name],
            "launches": state["sp_counts"][name]
            + state["sp_mh_counts"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
