"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises and the script
exits non-zero:

1. device: the card's name and power limit;
2. build: every ``rovit_kan_tpu_torch/csrc/*.cu`` compiled from a clean
   build directory, one ``nvcc`` per source, all started together; the
   fp32 block stages' and the KAN kernels' instances on the main path
   must not spill (``ptxas``; #11's may keep the 4 bytes it spilled
   before, ``KAN_SPILL_BYTES``);
3. kernels: each ported kernel against its plain PyTorch version on the
   card at the main path's shapes, with the stated tolerance, and timed
   (CUDA events, warm-up, median) beside its bound, the plain version and
   one PyTorch library call computing the same function: the block forward
   (#1) and backward (#2) at (64, 197, 192), 3 heads, and the augment (#7)
   at (64, 224, 224, 3), each in bf16 and fp32 (#7 also at (32, 384, 384, 3)
   in bf16, timed, and at (3, 33, 35, 3) in both, held; #1, #2 and #7 also
   the same bits on a repeated call; #7 also by profiler device time per
   launch name; #1, #2, #7 and ``TransformerEncoderLayer``'s forward
   also by CUDA-graph replay, the device time; #1's three stages and each of
   #2's stages by torch.profiler beside each stage's bound, #2 in either
   type failing if a first-design stage it replaced runs; #1 + #2 under
   autograd and ``TransformerEncoderLayer``'s forward + backward, and the
   layer's backward alone (forward + backward less forward), also by
   profiler device time); the KAN head's forward
   (#10) and backward (#11) at (64, [192, 64, 16, 1]) and one KAN layer's
   (#8, #9: ``kan_module.cu``'s kernels without the head) at
   (64, 192 -> 64), fp32, each output within 1e-4 of its largest
   magnitude, the same bits on a repeated call and with the basis's
   reciprocal divisions off, the kernels of a call (#10, #11 and #8 one
   launch; #9 four clusters of 16 rows, then the slots' ordered add as a
   second launch), their ``ms`` and
   their plain versions' ``plain_ms`` the device time per call from
   torch.profiler, the kernels' ``kernel_graph_ms`` by CUDA-graph replay
   (CUDA events around back-to-back calls time the host work there, kept
   as ``call_ms`` and ``plain_call_ms``), #9 also at 16, 32 and 64 rows a
   group by graph replay; then, on a line of its own
   ("kan_layer_widths"), #8/#9 checked and timed the same way at the
   trajectory's other layers, 64 -> 16 and 16 -> 1; then, on a line of its
   own ("preset_kernels"), bf16 #1 and #3 at (64, 197, 384), 6 heads, and
   (64, 197, 768), 12 heads, the presets' widths, and at d = 256, 320, 448
   and 512 (4, 5, 7 and 8 heads of 64), widths the JAX rule sends to its
   kernel that no preset has, and #2 and #4 at d = 256, 384, 512 and 768,
   against their plain versions at the flagship shapes' tolerances and
   timed beside their bounds, the plain versions and
   ``TransformerEncoderLayer`` (``check_preset_blocks``);
4. serve: the full-width DeiT-Tiny RoViT-KAN (seeded random weights) built
   with ``build_model`` and served through ``InferenceEngine`` and
   ``MicroBatcher``; the launch counters are set to 0 just before and read
   just after, and the served outputs are held against the same model run
   with the plain block;
5. train: the same model built for training, ten flat-AdamW steps at batch
   64 through ``make_train_step`` (stage 4, mixing on) between a counter
   reset and a read, which must show 12 launches of #1 and of #2 and one of
   #7 per step; finite losses; a falling loss on one repeated batch; one
   step held against the same step through the plain versions and the fp32
   model (``hold_train_step``: #2 per parameter, each image's loss, the
   stage-3 gradient by parameter group); training images/s and one
   profiled step;
6. kan: the flagship with ``tpu.use_pallas_kan=True``: four served batches
   (12 x #1 and 1 x #10 each; every output but the severity the same bits
   as with the plain KAN head, the severity within 1e-5), the KAN
   trajectory and its gradient to the features (3 x #8, 3 x #9, held
   against the plain layers), five train steps at stage 4 (12 x #1,
   12 x #2, 1 x #7, 1 x #10, 1 x #11 each; finite losses), the same three
   steps of that step object timed with the KAN kernels on and off in
   turns, one step held against the plain KAN head (``hold_kan_step``),
   and the device operations per served batch and per train step with the
   flag on and off, from profiles;
7. long: the flagship at 384 px (577 tokens), batch 32, its weights the
   seed-0 224-px model's carried over by ``transfer_resolution``: the
   attention-only kernels #5/#6 at (32, 3, 577, 64) and (64, 3, 197, 64)
   (bf16: the mma.sync kernels of ``attention_mma.cuh``; fp32: the 3xTF32
   mma.sync kernels of ``attention_tf32.cuh``) and #1/#2 at
   (32, 577, 192), bf16 and fp32, against their plain versions (same bits
   on repeat for #1, #5 and #6) and timed beside their bounds, the plain
   versions and SDPA or ``TransformerEncoderLayer`` (#1, #2, #5, #6 and the
   library forwards also by CUDA-graph replay, #1's stages by
   torch.profiler; SDPA's forward + backward, its backward alone and the
   port's #5 + #6 under autograd by profiler device time, with SDPA's
   kernel names); served through ``InferenceEngine``
   with "auto" (12 x #1 per batch, no #5) and with
   ``use_pallas_block=False`` (12 x #5 per batch, no #1), each held
   against its plain versions and the fp32 model as in "serve"; three
   train steps with ``use_pallas_block=False, use_pallas_attention=True``
   (12 x #5, 12 x #6, 1 x #7 each), two with "auto" (12 x #1, 12 x #2,
   1 x #7 each), finite losses; one step held per
   parameter against the same step with #6's plain version; the fp32 arm
   (``flags.mixed_precision=False``, the attention kernels, block off):
   one served batch (12 x #5) and one train step (12 x #5, 12 x #6; no
   #7, which the trainer takes only under mixed precision) held against
   ``plain_attention`` (outputs and loss 1e-4 relative, the flat gradient
   1e-3 in L2);
8. fit: the saved-residual pair. #3 and #4 at (64, 197, 192) and
   (32, 577, 192), bf16 and fp32, against their plain versions (#3's output
   the bits of #1's, the same bits on a repeated #3 and #4 call), timed
   beside their bounds, the plain versions and ``TransformerEncoderLayer``
   (#3, #4 and the layer's forward also by CUDA-graph replay; #4's stages
   beside their bounds, and #3 + #4, #1 + #2, the layer's forward +
   backward and its backward alone, by profiler device time); one flagship
   train step with ``ROVIT_BLOCK_RESIDUAL_BWD=1`` held against the same step
   through #1/#2 and through #4's plain version (``hold_residual_step``);
   then ``Trainer.fit`` at the flagship's full width over a device-resident
   synthetic set (``make_leaf_image``, 4 classes x 100 images, 80/20 split:
   5 train steps and 2 validation batches, the second padded, per epoch)
   for 4 epochs across curriculum stages 1-4 and the backbone's unfreeze
   with the opt-in (12 x #3 and 12 x #4 and no #1/#2 per train step, 12 x
   #1 per validation batch, finite losses, the epoch CSV and the best
   checkpoint written), ``resume`` and one more epoch, ``load_engine`` on
   the best checkpoint serving two batches (its outputs the bits of the
   trainer's best weights through the same kernels); the same fit with the
   opt-in off and on in turns for the epoch img/s of both arms;
9. eval: the train -> evaluate -> serve loop through the CLIs, on a
   synthetic JPEG tree at 224 px (``generate_synthetic_dataset``: 4 x 48
   augmented images, split 80/20 into 2 train steps and 1 validation batch
   an epoch, and 4 x 25 test images, 2 batches, the second 36 of 64 valid).
   ``cli.train`` for 2 epochs at batch 64 (12 x #1, 12 x #2 and 1 x #7 per
   step; 12 x #1 per validation and test batch and per bs=1 FPS forward;
   finite losses; the CSV, ``best_model`` and ``test_metrics.json``);
   ``cli.evaluate --calibrate --store_temperature`` on ``best_model`` (T
   stored and served by ``load_engine``, or a degenerate fit refused with
   the sidecar unchanged), then with ``--device_metrics on``: the counts
   equal to the host path's, accuracy equal in fp32, macro F1 within 1e-6,
   the other metrics within 1e-5; one ``Evaluator`` pass through #1 held against the
   plain block and the fp32 model as "serve" holds served outputs
   (``hold_served``); the test pass's seconds, evaluation img/s and the
   bs=1 FPS, which must be finite and positive. The phase's directory
   (and its ``best_model``) serves phases 10-15, its JPEG tree phases
   17-18;
10. presets: the small and base presets on the fused block. bf16
   ``get_config("small")`` (d = 384) and ``get_config("base")`` (d = 768),
   each saved as a checkpoint and served one 224-px batch of 64 through
   ``load_engine`` between a counter reset and a read (12 #1 launches and
   nothing else), the outputs held by ``hold_served`` against the same
   engine on the plain block and the fp32 model; one small train step (12
   #1, 12 #2, one #7) and one base step (no #1 or #2: the JAX rule trains
   d > 512 on the plain block; one #7), finite losses, and one small step
   held against its plain versions and the fp32 model by
   ``hold_train_step``, as "train" holds the flagship's; a forced
   ``use_pallas_block=True`` base step at d = 768 on the wide backward (12
   #1, 12 #2, one #7), its loss finite; the flagship still takes 12 #1
   launches a batch;
11. export: ``cli.export_model --verify`` on ``best_model``; then three
   artifacts, each saved, loaded afresh by ``load_exported`` and held
   against its ``InferenceEngine`` bit for bit on a full batch and on a
   partial batch padded by the caller: the 224-px flagship at batch 64 from
   ``best_model`` with its stored temperature (12 ``vit_block_fwd`` op
   nodes, 12 #1 launches a call), the 384-px model with
   ``use_pallas_block=False`` at batch 32 (12 ``attention_fwd`` nodes and #5
   launches), and the flagship with ``use_pallas_kan=True`` (1
   ``kan_module_fwd`` node and #10 launch, and 12 #1); each artifact's
   device operations per batch (torch.profiler) no more than the eager
   ``build_serving_forward``'s, its graph's node census, and one call's
   time against the eager forward's by CUDA events in turns and by
   CUDA-graph replay (the artifact only: the eager forward copies its
   normalization constants from the host, which a capture refuses); the
   host time per wrapper call through each custom op and through the ctypes
   launch alone (the parent's path), in turns; served 224-px img/s at batch
   64 and bs=1 FPS through the op and with the block forward on the ctypes
   launch alone, in turns;
12. serve_cli: ``python -m rovit_kan_tpu_torch.cli.serve`` in a subprocess
   on ``best_model``: 16 concurrent single-image and 2 batch-64 clients
   (each batch the engine's bits, each single image within 1e-5 as in
   "serve"), ``/healthz`` and ``/metrics`` (parsed, the same stats), served
   img/s and p50/p95 latency over HTTP from 4 clients of 6 batches each,
   and a SIGTERM while 8 batches are in flight: every one answered with the
   engine's bits, exit 0 within 30 s; the process's launch counters, read
   after the drain, 12 #1 for each batch it ran;
13. bench: ``cli.bench`` once, its JSON line printed, every rate finite and
   positive, every MFU in (0, 1], #1, #2 and #7 launched;
14. explain: the flagship in bf16 built for inference, seed-0 weights with
   its LayerNorms drawn (``draw_layer_norms``), 64 random uint8 images at
   224 px through ``eval_batch``. Attention rollout launches no kernel;
   the fp32 model's maps on the card within 1e-4 of the same function on
   the CPU (16 images). A Grad-CAM++ call launches #1 11 times and nothing
   else (no #2), leaves every ``.grad`` None and the model in eval mode;
   its tap, tap gradient and maps held against the same call through the
   plain versions and the fp32 model's: within twice the plain call's
   distance from fp32 (the tap and gradient at least ``bf16_tol``; the
   maps by mean absolute distance, ``hold_gradcam``). At 384 px (batch 32, the
   224-px weights by ``transfer_resolution``) a call launches #1 11 times
   and #5 and #6 once, held the same way. Maps a second of each method
   (host wall time closed by a synchronize), Grad-CAM++'s device
   operations and busy share; then ``cli.visualize`` on 8 images of phase
   9's test set with its ``best_model``: its launches (11 + 12 #1, and 12
   more where matplotlib draws the KAN figures) and its 21 figures, or
   one warning and none;
15. ablation: ``cli.run_ablation --synthetic --device-cache`` at the
   flagship's width and 224 px over 4 x 48 images (134 train, 28
   validation, 30 test), 2 epochs at batch 64: every variant trains,
   evaluates and calibrates with 12 #1 per forward, 12 #2 and one #7 per
   step; six CSV rows and the four components' importance; the same
   command again skips all six and launches nothing;
16. baselines: ``cli.run_baselines --synthetic`` over the six baselines
   (deit_tiny, efficientnet_b0, mobilenetv3_large, resnet50, vgg16,
   swin_tiny) at 224 px, batch 32, one epoch over 4 x 32 augmented images
   (102 train: 3 steps; 26 validation) and 4 x 16 original test images:
   every model trains, evaluates, calibrates and times its bs=1 FPS, with
   six ``*_metrics.json`` whose metrics are finite, each ``params`` the JAX
   module's count at 224 px, ``fps`` finite and positive with no
   ``fps_error``, and six CSV rows sorted by accuracy. The baselines train
   and evaluate in fp32 on the plain block and the plain augment, so the
   only launches are #1's in deit_tiny's FPS column, where the bf16 twin on
   the fused block runs 12 a forward (1,320 over its 110 forwards); none
   elsewhere in the phase. Through that twin, held against the same twin
   on the plain block and the fp32 model (``hold_served``'s rule): one
   batch of 64 on fresh weights with drawn LayerNorms, and one batch of 1
   (the FPS column's shape) on the model the sweep trained. Per model: the
   sweep's train seconds and its first epoch's img/s (cuDNN's algorithm
   search included), the img/s of 5 train steps timed after 2 warm-up
   steps, bs=1 FPS, and one profiled train step's device operations and
   busy share.

17. pretrained: weight import. A reference-format ``best_model.pth`` and a
   timm backbone state_dict at the flagship's shapes (seeded numpy) through
   ``cli.convert_checkpoint`` (its line and counts, no launch; the
   reference ``.npz`` read back through the port's key map is the reference
   state_dict bit for bit); ``cli.train --pretrained_npz`` from the timm
   ``.npz`` for one epoch on phase 9's JPEG tree at batch 64 (12 x #1,
   12 x #2 and 1 x #7 a step; 12 x #1 a validation, test and bs=1 FPS
   forward), whose weights before the first step are
   ``merge_pretrained(init, npz)`` bit for bit (every backbone leaf the
   npz's, the heads at the seed's init); ``load_engine`` on its
   ``best_model`` serving one batch (12 x #1);
18. moe: the flagship with ``moe_experts=8`` (blocks 1, 3, ..., 11 sparse,
   18,142,234 parameters). One MoE layer at (64, 197, 192) on the card and
   the CPU, fp32 and bf16: the same chosen token sets, outputs within the
   stated tolerance (``moe_layer_checks``); ``cli.train --moe_experts 8``
   for one epoch (6 x #1 a forward: the dense blocks; 6 x #2 and 1 x #7 a
   step), ``cli.evaluate --calibrate`` (6 x #1 a forward) and
   ``load_engine`` serving three batches (6 x #1 each), one batch held
   against the plain block and the fp32 model (``hold_served``) with the
   token-expert selections each path parts on counted; three steps with
   ``tpu.remat_backbone`` on and off, the same losses and gradients bit for
   bit (6 blocks recomputed a step), their ms and peak memory; one step
   with ``use_pallas_attention=True`` (6 x #5 and #6 in the MoE blocks,
   6 x #1 and #2 in the dense ones, 1 x #7) held against #6's plain version
   by ``hold_attention_step``'s rule, and read against plain attention;
   the MoE model's ``torch.export`` artifact (``export_case``: 6
   ``vit_block_fwd`` nodes and launches a call, the MoE blocks plain, the
   engine's bits on a full and a padded batch); the MoE and dense
   flagships' train step ms at batch 64, served img/s and bs=1 FPS in
   turns.
19. native: the host resize engine (``native/preprocess.cpp``) built with
   g++ on the card's host (seconds), its uint8 bits against
   ``data/resize.py`` on 384 -> 224, 100 -> 224, 333 x 500 and 1 x 57
   images at 1, 2 and 8 threads; ``cli.bench_host_pipeline`` over a
   2,000-image JPEG tree at 384 px, written and built on one thread per
   CPU (as ``DeviceLoader`` fills its cache): the cache build's wall time
   and img/s through the engine and through the numpy copy, in turns,
   twice, the resize's share of each build's thread time, the micro
   resize's thread sweep and the host's CPU counts;
20. dp: data parallelism on the one card, two ranks (``chip_smoke.py
   --dp-worker``, started by ``cli.spawn_workers``; gloo named
   explicitly: NCCL refuses two ranks on one device; every exit code
   checked). Three flagship bf16 steps at batch 64 global (CutMix/MixUp,
   dropout, the EMA on), at stage 3 and at stage 4, on the ranks against
   the same steps in one process, beside the fp32 model's steps
   (``hold_dp``): the first step's loss within 1e-4 (relative), its
   all-reduced gradient per leaf within 1e-3 of its largest magnitude at
   stage 3 (the leaves whose
   gradient the bf16 trunk sums in bf16 within two bf16 ulps) and within
   5e-2 of its L2 norm at stage 4; each later step's loss and whole
   gradient (L2), and at stage 3 each leaf's gradient, within twice the
   bf16 step's own distance from the fp32 step's; the
   ranks' parameters equal bit for bit after the steps; every step's gaps
   on a "dp_readings" line; 12 #1, 12 #2, 1 #7 and no other launch a step
   on each rank; each rank's step ms and img/s. Then a two-epoch
   ``Trainer.fit`` over the sharded ``DeviceLoader`` (4 x 40 leaf images:
   2 train steps and 1 validation batch an epoch), its launches on each
   rank, the ranks' weights equal, the temperature fitted on the
   validation cache (rank 0's T on both ranks), ``load_engine`` on its
   ``best_model`` serving that T (12 #1 a batch, the same outputs on both
   ranks). Last, ``cli.train`` through ``python -m torch.distributed.run
   --nproc_per_node=1 ... --multihost`` (a world of 1, no process group)
   beside the single-card ``cli.train --devices 1``, one epoch each on a
   224-px JPEG tree: the same epoch CSV, bit for bit.
21. fsdp: the same two ranks (one start of theirs serves phases 20-22)
   take phase 20's steps (the EMA on in both) under ``parallel.fsdp.FSDP``
   (the bf16 flagship, 56 of its 173 leaves sharded), held by
   ``hold_dp``'s rules against the one-process steps and against the
   "dp" ranks' steps of the same call (gaps on an "fsdp_readings" line);
   12 #1, 12 #2, 1 #7 and no other launch a step on each rank, as under
   data parallelism; each rank's parameter, moment and EMA bytes equal to
   ``sharded_size`` and below the replicated figure, one unit gathered at
   a time; each rank's peak memory under data parallelism and FSDP and
   its step ms. The stage-4 steps again with
   ``ROVIT_BLOCK_RESIDUAL_BWD=1``: 12 #3, 12 #4, 1 #7 a step, the first
   loss the same bits. Then a two-epoch ``Trainer.fit(fsdp=True)`` over
   the sharded cache (its launches, the ranks' histories equal) whose
   ``best_model`` holds the ranks' gathered best weights bit for bit,
   loads into a one-process ``Trainer`` (``resume``) with the same bits
   and is served by ``load_engine`` (12 #1). Last, one bf16 step of the
   base preset (d = 768, 86 M parameters, the plain block) at batch 8
   under data parallelism and under FSDP: each rank's state bytes (FSDP's
   must be fewer), peak memory and step ms.
22. baselines_dp: the ranks' first ResNet-50 step of
   ``BaselineExperiment`` at 224 px, batch 32 with 5 padded rows, from the
   seed's weights, against the one-process step: loss and accuracy 1e-4,
   the all-reduced gradient within twice the one-process step's own
   distance from itself with the batch's rows reversed: in L2, and each
   leaf (in units of its largest magnitude, floor 1% of the whole
   gradient's) within twice the largest such leaf gap; the running
   statistics 1e-4 (floor 1%);
   then ``cli.run_baselines`` (``--multihost`` on the ranks' mesh) over
   resnet50 and deit_tiny for one epoch beside the one-process sweep
   (``--devices 1``) on the same tree: the ranks' weights and statistics
   equal bit for bit, the running statistics within 5e-2 of the
   one-process sweep's (floor 1%), the parameters within 4 x lr a step
   (Adam's steps on BatchNorm's rounding-noise gradients), the CSV's
   columns, and 12 #1 launches a deit_tiny FPS forward on rank 0 alone.

23. tp: the same two ranks on a data 1 x model 2 mesh
   (``parallel.make_2d_mesh``): phase 20's steps (the seed-0 bf16 flagship,
   batch 64, CutMix/MixUp, dropout, the EMA, stages 3 and 4) under tensor
   parallelism (``parallel.tensor.TensorParallel``: the Megatron rules, 72
   of 173 leaves sharded) and under TP + SP (198 tokens, one filler),
   held by ``hold_dp``'s rules against the one-process bf16 and fp32
   steps, for another route (``route=True``: the first loss within 1e-4,
   every step's gradient within twice the bf16 step's own distance from
   fp32); gaps on a "tp_readings" line; 12 #5, 12 #6, 1 #7 and no other
   launch a step on each rank (the sharded block runs its heads' attention
   core through #5/#6, never #1/#2); every rank's replicated leaves equal
   bit for bit; each rank's parameter, moment and EMA bytes equal to
   ``sharded_size``, 12,176,488 B of parameters; peak memory and step ms
   beside the "dp" ranks'. Then a two-epoch ``Trainer.fit`` under TP + SP
   over the sharded cache (12 #5 a validation batch) whose ``best_model``
   holds the ranks' gathered best weights bit for bit, loads into a
   one-process ``Trainer`` with the same bits and is served by
   ``load_engine`` (12 #1). Last, one bf16 step of the base preset (d =
   768, 12 heads, the plain block and attention core) at batch 8 under TP
   and TP + SP: 175,988,584 B of parameters a rank, peak memory, step ms.
   The explainability taps under TP and TP + SP (``tp_taps``): the fp32
   flagship's attention maps (12, 8, 3, 197, 197), norm1 tap and its
   gradient on each rank against one process (``TAPS_TOL``), and the
   ``ViTAttentionRollout`` and ``GradCAMPlusPlus`` maps equal to their
   functions of the rank's own taps (their gaps to one process reported).

24. ep: the same two ranks on a data 1 x expert 2 mesh
   (``parallel.make_moe_mesh``): phase 20's steps on the MoE flagship
   (``moe_experts=8``, blocks 1, 3, ..., 11 sparse) under expert
   parallelism (``parallel.tensor.ExpertParallel``: each rank 4 experts of
   every MoE block, the gate and the dense leaves whole), held by
   ``hold_dp``'s rules for another route against the one-process MoE
   steps in bf16 and fp32 of the same call (the first loss, and every
   step's whole gradient in L2 within twice the bf16 step's distance from
   fp32, the first within ``EP_FIRST_GRAD`` of its norm; gaps on an
   "ep_readings" line); 6 #1, 6 #2 (the dense blocks), 1
   #7 and no other launch a step on each rank; the replicated leaves equal
   bit for bit; each rank's parameter, moment and EMA bytes equal to
   ``sharded_size`` under ``moe_param_specs``; peak memory and step ms
   beside the "dp" ranks'. Then a two-epoch ``Trainer.fit`` on the mesh
   whose ``best_model`` holds the ranks' gathered best weights bit for
   bit, loads into a one-process ``Trainer`` with the same bits and is
   served by ``load_engine`` (6 #1).
25. pp: the same two ranks on a data 1 x pipe 2 mesh
   (``parallel.pipeline.make_pipeline_mesh``): phase 20's steps on the
   flagship at full depth under the GPipe pipeline
   (``parallel.pipeline.Pipeline``: 6 blocks a stage, 4 microbatches of
   16 rows), held by ``hold_dp``'s data rules (per leaf at the first step)
   against the one-process #1/#2 steps (gaps on a "pp_readings" line); 24 #1, 24 #2 (6 blocks x 4
   microbatches) and 1 #7 a step on each rank; a stage's bytes, peak
   memory and step ms beside the "dp" ranks'; the fit, its checkpoint
   resumed and served (12 #1) as the "ep" fit's.
26. serve_mesh: the same two ranks on their data mesh serve the "dp" fit's
   ``best_model`` through ``load_engine(mesh=)`` (the flagship, batch 64,
   bf16, 32 rows a rank): rank 0 serves 20 requests of 1 to 130 images
   through ``predict`` and a ``MicroBatcher`` with a client thread each,
   rank 1 follows (``InferenceEngine.follow``) until rank 0 closes the
   engine; every output held by ``hold_served``'s rule against the
   one-process engine on the same checkpoint and requests (the fp32
   model's engine as the exact reference), whether the bits are equal; 12
   #1 a batch on each rank and no other launch; served img/s and p50/p95
   beside the one-process engine's.
27. pp_tp: four more ranks on the card (``--pp-tp-worker``, gloo; started
   with phase 20 and running beside phases 20-26, whose lines therefore
   say that their times were read under that load: ``timed_beside``) on a
   data 1 x pipe 2 x model 2 mesh (``make_pipeline_mesh(1, 2, model=2)``):
   phase 25's steps with each stage's six blocks Megatron-sharded over the
   model axis, held by ``hold_dp``'s rules for another route against the
   one-process bf16 steps on #1/#2 and on the TP route and the fp32 steps
   (``tp_ranks_hold``; gaps on a "pp_tp_readings" line); 24 #5, 24 #6, 1
   #7 and no other launch a rank step; each rank's blocks, parameter,
   moment and EMA bytes equal to ``sharded_size`` (6,824,296 B of
   parameters); peak memory and step ms beside the "pp" and "tp" ranks';
   the fit, its checkpoint resumed in one process with the ranks' bits and
   served (12 #1).

``chip_smoke.py --nccl`` (a host with two cards or more) builds the kernels
and runs phases 20-26 alone over NCCL, rank r on cuda:r, on "dp_nccl",
"fsdp_nccl", "baselines_dp_nccl", "tp_nccl", "ep_nccl", "pp_nccl" and
"serve_mesh_nccl" lines: the same steps, checks and fit, then
``cli.train --devices 2``
beside ``cli.train --devices 1`` (both ranks on NCCL, one epoch CSV, its
checkpoint served by ``load_engine``) in place of the world-1 run. With
four cards visible it also runs FSDP+TP on data 2 x model 2
(``--tp4-worker``, an "fsdp_tp_nccl" line): the flagship's steps held as
phase 23's, 24 #5 (a unit's forward runs again in its backward), 12 #6
and 1 #7 a step, and 6,139,112 B of parameters a rank; and, in the same
four ranks, the "ep" and "pp" steps on data 2 x expert 2 and data 2 x
pipe 2, held as phases 24 and 25 hold theirs ("ep_nccl4" and "pp_nccl4"
lines), the "pp_tp" steps on data 1 x pipe 2 x model 2 held as phase 27
holds them ("pp_tp_nccl4"), and the "dp" fit served over data 4, 16 rows
a rank, as phase 26 serves it ("serve_mesh_nccl4").

The kernels line gives each kernel's launches on the export, serve CLI,
bench, explain, explain_384, visualize, ablation, baselines, pretrained,
moe and (each rank's) dp, fsdp, baselines_dp, tp, sp, ep, pp,
serve_mesh and pp_tp paths in its ``launches_by_path`` (sp: phase 23's TP +
SP steps and fit; ep, pp and pp_tp: phases 24, 25 and 27's steps and fit;
serve_mesh: phase 26's batches; presets_serve_* and presets_train_*: phase
10's counted batch and step of each preset), and #1-#4 their
"preset_kernels" readings under ``presets``. The line before the last is
``nvidia-smi``'s name and power limit; the last is ``{"ok": true,
"device": {...}}``. Imports torch and the port only.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import functools
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet; dense, no sparsity).
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

BATCH, TOKENS, DIM, HEADS, HIDDEN = 64, 197, 192, 3, 768
FP32_TOL = 1e-4     # fp32 sums in another order; K <= 768


#: The run's start on the host clock; each phase line carries its offset.
T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bf16_tol(ref: torch.Tensor) -> float:
    """Two bf16 ulps at the largest magnitude of ``ref``: the plain version
    rounds at the same points, so the two differ only where an fp32 sum in
    another order lands on the other side of a rounding boundary."""
    top = float(ref.float().abs().max())
    return 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7)


def time_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def block_inputs(dtype, seed: int, batch: int = BATCH, tokens: int = TOKENS,
                 dim: int = DIM, hidden: int = HIDDEN):
    from rovit_kan_tpu_torch.ops.block_kernel import prepare_block_params
    rng = np.random.RandomState(seed)

    def t(*shape, scale=0.05, center=0.0):
        return torch.tensor(center + rng.normal(0, scale, shape),
                            dtype=torch.float32)

    raw = {"ln1_scale": t(dim, scale=0.02, center=1.0),
           "ln1_bias": t(dim, scale=0.02),
           "wqkv": t(3 * dim, dim), "bqkv": t(3 * dim, scale=0.02),
           "wproj": t(dim, dim), "bproj": t(dim, scale=0.02),
           "ln2_scale": t(dim, scale=0.02, center=1.0),
           "ln2_bias": t(dim, scale=0.02),
           "w1": t(hidden, dim), "b1": t(hidden, scale=0.02),
           "w2": t(dim, hidden), "b2": t(dim, scale=0.02)}
    x = t(batch, tokens, dim, scale=1.0).to("cuda", dtype)
    params = prepare_block_params({k: v.cuda() for k, v in raw.items()},
                                  dtype)
    return x, params


def library_layer(params, dtype, heads: int = HEADS):
    """``nn.TransformerEncoderLayer`` computing the same pre-LN block with the
    same weights: the library yardstick, never called by the port."""
    hidden, dim = params["w1"].shape
    layer = torch.nn.TransformerEncoderLayer(
        dim, heads, hidden, dropout=0.0, activation="gelu",
        batch_first=True, norm_first=True, layer_norm_eps=1e-6).eval()
    with torch.no_grad():
        layer.self_attn.in_proj_weight.copy_(params["wqkv"].float())
        layer.self_attn.in_proj_bias.copy_(params["bqkv"])
        layer.self_attn.out_proj.weight.copy_(params["wproj"].float())
        layer.self_attn.out_proj.bias.copy_(params["bproj"])
        layer.norm1.weight.copy_(params["ln1_scale"])
        layer.norm1.bias.copy_(params["ln1_bias"])
        layer.norm2.weight.copy_(params["ln2_scale"])
        layer.norm2.bias.copy_(params["ln2_bias"])
        layer.linear1.weight.copy_(params["w1"].float())
        layer.linear1.bias.copy_(params["b1"])
        layer.linear2.weight.copy_(params["w2"].float())
        layer.linear2.bias.copy_(params["b2"])
    return layer.to("cuda", dtype)


def op_seconds(flops, dtype, fma: bool = False) -> float:
    """Least seconds for ``flops`` of products in the route of ``dtype``:
    bf16 at the bf16 tensor peak; fp32 as 3xTF32, three TF32 products each
    at the TF32 peak, or on the FMA units (``fma``) at 67 TFLOP/s."""
    if dtype == torch.bfloat16:
        return flops / PEAK_BF16_FLOPS
    return flops / PEAK_FP32_FLOPS if fma else 3 * flops / PEAK_TF32_FLOPS


def block_bound_ms(x, params, dtype, fma: bool = False) -> float:
    """#1's least time: the larger of its FLOP over the route's rate
    (``op_seconds``) and its bytes over the HBM rate."""
    B, N, D = x.shape
    hd = D // HEADS
    flops = 2 * B * N * D * (4 * D + 2 * HIDDEN) + 4 * B * HEADS * N * N * hd
    nbytes = 2 * x.numel() * x.element_size() + sum(
        p.numel() * p.element_size() for p in params.values())
    return 1e3 * max(op_seconds(flops, dtype, fma),
                     nbytes / PEAK_BYTES_PER_S)


# The kernels of #1's three launches in a profile, by stage and route.
BLOCK_STAGES = {
    torch.bfloat16: {"ln_qkv": "ln_qkv_mma_kernel",
                     "attention": "attn_fwd_mma_kernel",
                     "proj_mlp": "proj_mlp_mma_kernel"},
    torch.float32: {"ln_qkv": "ln_qkv_tf32_kernel<",
                    "attention": "attn_fwd_tf32_kernel<",
                    "proj_mlp": "proj_mlp_tf32_kernel<"}}
# The first design's fp32 forward stages, which the 3xTF32 stages replaced:
# no profile of #1, #2 or #3 may show one.
REPLACED_FWD_STAGES = ("namespace)::ln_qkv_kernel<",
                       "namespace)::attn_fwd_kernel<",
                       "namespace)::proj_mlp_kernel<")


# The fp32 block stages' instances at the flagship's widths (D = 192, head
# width 64), which must not spill (the build line's ``ptxas`` table).
MAIN_PATH_TF32 = ("ln_qkv_tf32_kernel<192,", "proj_mlp_tf32_kernel<192,",
                  "attn_fwd_tf32_kernel<64,true>")
# The kan_module.cu instances of the flagship head and its trajectory (7
# bases: 8 feature slots; with the head and without it). None may spill
# more than listed here: #11's keeps the 4 bytes it spilled before #8/#9
# moved into its source (each variant that removed them ran #11 slower on
# an H100; PERF.md §6).
MAIN_PATH_KAN = ("kan_module_fwd_kernel<8,", "kan_module_bwd_kernel<8,")
KAN_SPILL_BYTES = {"kan_module_bwd_kernel<8,true>": 4}


def no_replaced_fwd(ops: dict, what: str) -> None:
    """Raises if a profile (``device_ops``) ran a replaced forward stage."""
    old = [k for k in ops if any(o in k for o in REPLACED_FWD_STAGES)]
    if old:
        raise RuntimeError(f"{what} ran replaced forward stages: {old}")


def stage_bounds_ms(x, dtype) -> dict:
    """Each of #1's stages' least time: the larger of its FLOP over the
    route's rate (``op_seconds``: fp32 as 3xTF32) and its bytes (inputs
    read once, outputs written once; qkv and the attention output pass
    through device memory between the stages) over the HBM rate."""
    B, N, D = x.shape
    M, size = B * N, x.element_size()
    work = {"ln_qkv": (2 * M * D * 3 * D, (M * 4 * D + 3 * D * D) * size),
            "attention": (4 * B * N * N * D, M * 4 * D * size),
            "proj_mlp": (2 * M * D * (D + 2 * HIDDEN),
                         (3 * M * D + D * (D + 2 * HIDDEN)) * size)}
    return {k: 1e3 * max(op_seconds(f, dtype), b / PEAK_BYTES_PER_S)
            for k, (f, b) in work.items()}


def check_block(dtype, seed: int, batch: int = BATCH, tokens: int = TOKENS):
    """#1 against ``block_reference`` (and the same bits on a repeated
    call), timed by CUDA events around back-to-back calls and by CUDA-graph
    replay (device time) beside its bound, the plain version and
    ``TransformerEncoderLayer``'s forward; its three stages' device time
    from torch.profiler."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    x, params = block_inputs(dtype, seed, batch, tokens)
    with torch.inference_mode():
        got = bk.fused_vit_block(x, params, HEADS)
        ref = bk.block_reference(x, params, HEADS)
        again = bk.fused_vit_block(x, params, HEADS)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"block kernel ({dtype}) gave non-finite "
                               f"values")
        if not torch.equal(again, got):
            raise RuntimeError(f"block kernel ({dtype}) gave other bits on "
                               f"a repeated call")
        err = float((got.float() - ref.float()).abs().max())
        tol = bf16_tol(ref) if dtype == torch.bfloat16 else FP32_TOL
        if not err <= tol:
            raise RuntimeError(f"block kernel ({dtype}) max |err| {err} > "
                               f"tolerance {tol}")
        layer = library_layer(params, dtype)
        lib_err = float((layer(x).float() - ref.float()).abs().max())
        ms = time_ms(lambda: bk.fused_vit_block(x, params, HEADS))
        plain_ms = time_ms(lambda: bk.block_reference(x, params, HEADS))
        library_ms = time_ms(lambda: layer(x))
        graph = graph_ms(lambda: bk.fused_vit_block(x, params, HEADS))
        library_graph = graph_ms(lambda: layer(x))
        ops = device_ops(lambda: bk.fused_vit_block(x, params, HEADS))
        no_replaced_fwd(ops, f"block kernel ({dtype})")
        stages = by_label(ops, BLOCK_STAGES[dtype])
    return {"replaces": "rovit_kan_tpu/ops/block_kernel.py::"
                        "_vit_block_kernel",
            "dtype": str(dtype).replace("torch.", ""),
            "shape": list(x.shape), "heads": HEADS,
            "launches_per_batch": "12 (one per block; counted in 'serve')",
            "max_abs_err": err, "tolerance": tol,
            "identical_bits_on_repeat": True, "kernel_ms": ms,
            "kernel_graph_ms": graph, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_graph_ms": library_graph,
            "graph_ms_source": "CUDA events around replays of a CUDA graph "
                               "of 20 calls (device time)",
            "stages_device_ms": stages,
            "stages_bound_ms": stage_bounds_ms(x, dtype),
            "library_max_abs_err": lib_err,
            "bound_ms": block_bound_ms(x, params, dtype),
            "bound_by": "operations",
            **({"fma_bound_ms": block_bound_ms(x, params, dtype, fma=True)}
               if dtype == torch.float32 else {})}


# The kernels of #2's and #4's stages in a profile, by stage and route
# (#2 also runs #1's ln_qkv and attention stages to recompute qkv and the
# attention output). Each route's must run, and the first design's stages,
# which both routes replaced, must not (``REPLACED_BWD_STAGES``).
BWD_STAGES = {
    torch.bfloat16: {"mlp_bwd": "mlp_bwd_mma_kernel<",
                     "attention_q": "attn_bwd_q_mma_kernel<",
                     "attention_kv": "attn_bwd_kv_mma_kernel<",
                     "qkv_bwd": "qkv_bwd_mma_kernel<",
                     "wgrad": "wgrad_mma_kernel",
                     "reduce": "namespace)::reduce_kernel<"},
    torch.float32: {"mlp_bwd": "mlp_bwd_fma_kernel<",
                    "attention_q": "attn_bwd_q_fma_kernel<",
                    "attention_kv": "attn_bwd_kv_fma_kernel<",
                    "qkv_bwd": "qkv_bwd_fma_kernel<",
                    "wgrad": "wgrad_fma_kernel<",
                    "reduce": "namespace)::reduce_kernel<"}}
REPLACED_BWD_STAGES = ("namespace)::mlp_bwd_kernel<",
                       "namespace)::qkv_bwd_kernel<",
                       "namespace)::wgrad_kernel<")


def bwd_stages(fn, dtype, recompute: bool, calls: int = 10) -> dict:
    """Device time per call of each stage of one backward call ``fn`` (#2
    when ``recompute``, else #4), and of all its device operations, from
    one profile; it raises if a replaced stage ran."""
    ops = device_ops(fn, calls)
    kernels = dict(BWD_STAGES[dtype])
    if recompute:
        kernels.update({k: BLOCK_STAGES[dtype][k]
                        for k in ("ln_qkv", "attention")})
    old = [k for k in ops if any(o in k for o in REPLACED_BWD_STAGES)]
    if old:
        raise RuntimeError(f"{dtype} backward ran replaced stages: {old}")
    no_replaced_fwd(ops, f"{dtype} backward")
    out = by_label(ops, kernels)
    out["all"] = sum(ops.values())
    return out


def bwd_stage_bounds_ms(x, dtype, recompute: bool) -> dict:
    """Each of #2's (``recompute``) or #4's stages' least time: the larger
    of its needed FLOP over the peak and its bytes (inputs read once,
    outputs written once, in the compute type; partials and grads fp32)
    over the HBM rate. mlp_bwd: proj again, fc1 again (#2 only), dh, dz and
    dattn; the attention query side S, dP and dQ, the key side S, dP, dK
    and dV; the reduce reads every partial once."""
    B, N, D = x.shape
    M, H, hd, size = B * N, HIDDEN, D // HEADS, x.element_size()
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    attn = 2 * B * HEADS * N * N * hd             # one N x N x hd product
    rows = M * D * size
    weights = (4 * D * D + 2 * H * D) * size
    tiles = -(-M // 64)
    work = {
        "mlp_bwd": (2 * M * D * (2 * D + (3 if recompute else 2) * H),
                    5 * rows + 4 * M * D + 2 * M * H * size
                    + (0 if recompute else M * H * size) + weights
                    + 4 * tiles * (4 * D + H)),
        "attention_q": (3 * attn, 5 * rows + 4 * 3 * B * HEADS * N),
        "attention_kv": (4 * attn, 6 * rows + 4 * 3 * B * HEADS * N),
        "qkv_bwd": (2 * M * 3 * D * D,
                    5 * rows + 4 * M * D + 3 * D * D * size
                    + (0 if recompute else rows) + 4 * tiles * 2 * D),
        "wgrad": (2 * M * (4 * D * D + 2 * H * D),
                  (6 * M * D + 2 * M * H) * size + 4 * (4 * D * D + 2 * H * D)),
        "reduce": (0, 4 * 2 * (4 * D * D + 2 * H * D + 6 * D + H))}
    out = {k: 1e3 * max(f / peak, b / PEAK_BYTES_PER_S)
           for k, (f, b) in work.items()}
    if recompute:
        first = stage_bounds_ms(x, dtype)
        out.update({k: first[k] for k in ("ln_qkv", "attention")})
    return out


def split_device_ms(fwd, fwd_bwd, calls: int = 10,
                    graph: bool = False) -> dict:
    """A backward alone by device time: ``fwd_bwd`` (forward + backward)
    less ``fwd`` (the same training forward, autograd recording), so each
    backward kernel has a library factor of its own; by profiler device time
    (``device_ms``), or by CUDA-graph replay (``graph_ms``) when ``graph``."""
    timer = graph_ms if graph else device_ms
    both = timer(fwd_bwd, calls=calls)
    forward = timer(fwd, calls=calls)
    return {"fwd_bwd": both, "fwd": forward, "bwd": both - forward}


def layer_bwd_device_ms(layer, xg, gx, calls: int = 10) -> dict:
    """``TransformerEncoderLayer``'s backward alone (``split_device_ms``)."""
    def fwd():
        layer(xg)

    def fwd_bwd():
        layer(xg).backward(gx)

    return split_device_ms(fwd, fwd_bwd, calls)


def bwd_tol(ref: torch.Tensor, dtype) -> float:
    """Backward tolerance, relative to the largest magnitude of each output:
    fp32 1e-4 (sums in another order, up to B*N rows); bf16 1e-2 (a rounding
    boundary that an fp32 sum in another order crosses moves one rounded
    intermediate by one bf16 ulp, 2^-8 of it, before the sums over rows)."""
    top = max(float(ref.float().abs().max()), 1e-6)
    return (1e-4 if dtype == torch.float32 else 1e-2) * top


def check_block_bwd(dtype, seed: int, batch: int = BATCH,
                    tokens: int = TOKENS):
    """Kernel #2 against ``block_backward_reference``: dx and all 12 grads,
    each against its own tolerance, and the same bits on a repeated call;
    timed by CUDA events, by CUDA-graph replay and by stage
    (``bwd_stages``) beside the plain version; #1 + #2 under autograd and
    ``TransformerEncoderLayer``'s forward + backward by events and by
    profiler device time."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    x, params = block_inputs(dtype, seed, batch, tokens)
    g = torch.tensor(np.random.RandomState(seed + 10).normal(
        0, 1, x.shape), dtype=torch.float32, device="cuda")
    with torch.no_grad():
        dx, grads = bk._launch_bwd(x, g, params, HEADS)
        want_dx, want = bk.block_backward_reference(x, g, params, HEADS)
        again_dx, again = bk._launch_bwd(x, g, params, HEADS)
        torch.cuda.synchronize()
    if not (torch.equal(again_dx, dx) and all(
            torch.equal(again[k], grads[k]) for k in bk.PKEYS)):
        raise RuntimeError(f"backward kernel ({dtype}) gave other bits on a "
                           f"repeated call")
    errs, failed = {}, []
    for name, got, ref in [("dx", dx, want_dx)] + [
            (k, grads[k], want[k]) for k in bk.PKEYS]:
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"backward kernel ({dtype}) {name}: "
                               f"non-finite values")
        err = float((got.float() - ref.float()).abs().max())
        tol = bwd_tol(ref, dtype)
        errs[name] = {"max_abs_err": err, "tolerance": tol,
                      "rel_err": err / max(float(ref.float().abs().max()),
                                           1e-6)}
        if not err <= tol:
            failed.append(name)
    if failed:
        raise RuntimeError(f"backward kernel ({dtype}) out of tolerance: "
                           f"{ {k: errs[k] for k in failed} }")

    with torch.no_grad():
        ms = time_ms(lambda: bk._launch_bwd(x, g, params, HEADS), reps=9)
        graph = graph_ms(lambda: bk._launch_bwd(x, g, params, HEADS),
                         calls=5)
        stages = bwd_stages(lambda: bk._launch_bwd(x, g, params, HEADS),
                            dtype, recompute=True)
        plain_ms = time_ms(lambda: bk.block_backward_reference(
            x, g, params, HEADS), reps=5, inner=3)
    # Forward plus backward: the port's #1 + #2 through autograd, and the
    # same pre-LN block as nn.TransformerEncoderLayer (the library yardstick).
    raw = {k: v.float().detach().clone().requires_grad_()
           for k, v in params.items()}
    xg = x.detach().clone().requires_grad_()
    gx = g.to(dtype)

    def port_fwd_bwd():
        bk.fused_vit_block(xg, raw, HEADS, kernel_params=params).backward(gx)

    layer = library_layer(params, dtype).train()

    def library_fwd_bwd():
        layer(xg).backward(gx)

    port_ms = time_ms(port_fwd_bwd, reps=9)
    library_ms = time_ms(library_fwd_bwd, reps=9)
    port_device = device_ms(port_fwd_bwd, calls=10)
    library_split = layer_bwd_device_ms(layer, xg, gx)
    library_device = library_split["fwd_bwd"]
    # The needed work: the forward recomputed without fc2 (no gradient
    # reads the block's output), then two products per forward product.
    B, N, D = x.shape
    flops = 3 * (2 * B * N * D * (4 * D + 2 * HIDDEN)
                 + 4 * B * HEADS * N * N * (D // HEADS)) \
        - 2 * B * N * D * HIDDEN
    nbytes = (2 * x.numel() * x.element_size() + g.numel() * 4
              + sum(p.numel() * p.element_size() for p in params.values())
              + sum(p.numel() * 4 for p in params.values()))
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    return {"replaces": "rovit_kan_tpu/ops/block_kernel.py::"
                        "_vit_block_bwd_kernel",
            "dtype": str(dtype).replace("torch.", ""),
            "shape": list(x.shape), "heads": HEADS,
            "launches_per_step": "12 (one per block; counted in 'train')",
            "identical_bits_on_repeat": True,
            "outputs": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "max_rel_err": max(e["rel_err"] for e in errs.values()),
            "kernel_ms": ms, "kernel_graph_ms": graph, "plain_ms": plain_ms,
            "stages_device_ms": stages,
            "stages_bound_ms": bwd_stage_bounds_ms(x, dtype, True),
            "port_fwd_bwd_ms": port_ms, "library_ms": library_ms,
            "port_fwd_bwd_device_ms": port_device,
            "library_device_ms": library_device,
            "library_bwd_device_ms": library_split["bwd"],
            "library_fwd_train_device_ms": library_split["fwd"],
            "library": "nn.TransformerEncoderLayer forward + backward",
            "device_ms_source": "torch.profiler: every device operation of "
                                "10 calls, per call",
            "bound_ms": 1e3 * max(flops / peak, nbytes / PEAK_BYTES_PER_S),
            "bound_by": "operations"}


# The blocks the bf16 wide stages are held at (d, heads, whether #2 and #4
# run too): the small and base presets', and widths no preset has that the
# JAX rule sends to its kernel (256 and 512 also in training).
PRESET_BLOCKS = {"small": (384, 6, True), "base": (768, 12, True),
                 "d256": (256, 4, True), "d320": (320, 5, False),
                 "d448": (448, 7, False), "d512": (512, 8, True)}


def top_ops(ops: dict, n: int = 8) -> dict:
    """The ``n`` device operations of ``device_ops`` that took most time,
    with the total."""
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
    return {"all": sum(ops.values()), **{k[:110]: v for k, v in top}}


def check_preset_blocks(preset: str, seed: int) -> dict:
    """#1 and #3 (and, where ``PRESET_BLOCKS`` asks, #2 and #4) at
    (64, 197, d) of a preset or width, bf16, against their plain versions
    with the flagship shapes' tolerances (``bf16_tol``, ``bwd_tol``): #1
    and #2 the same bits on a repeated call, #3's output #1's bits, #4 from
    #3's residuals the same bits on repeat. Each timed by CUDA events beside its
    bound, its plain version and ``TransformerEncoderLayer`` (the forward
    for #1 and #3, the forward + backward for #2 and #4), with the device
    operations of one call by profiler device time."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    D, heads, backward = PRESET_BLOCKS[preset]
    dtype, H = torch.bfloat16, 4 * D
    x, params = block_inputs(dtype, seed, dim=D, hidden=H)
    g = torch.tensor(np.random.RandomState(seed + 10).normal(
        0, 1, x.shape), dtype=torch.float32, device="cuda")
    B, N, _ = x.shape
    M, hd = B * N, D // heads
    what = f"preset {preset} block {list(x.shape)}"
    fwd_flops = 2 * M * D * (4 * D + 2 * H) + 4 * B * heads * N * N * hd
    wbytes = sum(p.numel() * p.element_size() for p in params.values())
    wcount = sum(p.numel() for p in params.values())
    io = 2 * x.numel() * x.element_size()
    res_bytes = M * (4 * D + H) * x.element_size()

    def bound(flops, nbytes):
        t = {"operations": flops / PEAK_BF16_FLOPS,
             "bytes": nbytes / PEAK_BYTES_PER_S}
        by = max(t, key=t.get)
        return {"bound_ms": 1e3 * t[by], "bound_by": by, "flops": flops,
                "bytes": nbytes}

    def held(pairs, tol_of):
        errs, failed = {}, []
        for name, a, b in pairs:
            if not torch.isfinite(a.float()).all():
                raise RuntimeError(f"{what} {name}: non-finite values")
            err = float((a.float() - b.float()).abs().max())
            errs[name] = {"max_abs_err": err, "tolerance": tol_of(b)}
            if not err <= errs[name]["tolerance"]:
                failed.append(name)
        if failed:
            raise RuntimeError(f"{what} out of tolerance: "
                               f"{ {k: errs[k] for k in failed} }")
        return errs

    with torch.inference_mode():
        out1 = bk.fused_vit_block(x, params, heads)
        again1 = bk.fused_vit_block(x, params, heads)
        ref1 = bk.block_reference(x, params, heads)
        res = bk._launch_res(x, params, heads)
        res_again = bk._launch_res(x, params, heads)
        ref3 = bk.block_residual_reference(x, params, heads)
        torch.cuda.synchronize()
    if not torch.equal(again1, out1):
        raise RuntimeError(f"{what}: a repeated #1 call gave other bits")
    if not torch.equal(res[0], out1):
        raise RuntimeError(f"{what}: #3's output is not #1's bits")
    if not all(torch.equal(a, b) for a, b in zip(res_again, res)):
        raise RuntimeError(f"{what}: a repeated #3 call gave other bits")
    errs1 = held([("out", out1, ref1)], bf16_tol)
    errs3 = held(list(zip(("out", "qkv", "attn", "a1"), res, ref3)),
                 bf16_tol)
    layer = library_layer(params, dtype, heads)
    with torch.inference_mode():
        ms1 = time_ms(lambda: bk.fused_vit_block(x, params, heads))
        plain1 = time_ms(lambda: bk.block_reference(x, params, heads),
                         reps=5, inner=3)
        ms3 = time_ms(lambda: bk._launch_res(x, params, heads))
        plain3 = time_ms(lambda: bk.block_residual_reference(
            x, params, heads), reps=5, inner=3)
        lib_fwd = time_ms(lambda: layer(x))
        ops1 = top_ops(device_ops(lambda: bk.fused_vit_block(x, params,
                                                             heads)))
    common = {"preset": preset, "dtype": "bfloat16", "shape": list(x.shape),
              "heads": heads, "identical_bits_on_repeat": True}
    out = {"vit_block_fwd": {
        **common, "outputs": errs1, "max_abs_err": errs1["out"]["max_abs_err"],
        "kernel_ms": ms1, "plain_ms": plain1, "library_ms": lib_fwd,
        "library": "nn.TransformerEncoderLayer forward",
        "device_ms_by_kernel": ops1, **bound(fwd_flops, io + wbytes)},
        "vit_block_res_fwd": {
        **common, "outputs": errs3, "out_bits_equal_to_vit_block_fwd": True,
        "max_abs_err": max(e["max_abs_err"] for e in errs3.values()),
        "kernel_ms": ms3, "plain_ms": plain3, "library_ms": lib_fwd,
        "library": "nn.TransformerEncoderLayer forward (timed once for #1 "
                   "and #3)",
        **bound(fwd_flops, io + res_bytes + wbytes)}}
    if not backward:
        return out

    with torch.no_grad():
        dx, grads = bk._launch_bwd(x, g, params, heads)
        dx_again, grads_again = bk._launch_bwd(x, g, params, heads)
        ref_dx, ref_g = bk.block_backward_reference(x, g, params, heads)
        saved = res[1:]
        dx4, grads4 = bk._launch_bwd_res(x, g, *saved, params, heads)
        dx4_again, grads4_again = bk._launch_bwd_res(x, g, *saved, params,
                                                     heads)
        ref_dx4, ref_g4 = bk.block_backward_residual_reference(
            x, g, *saved, params, heads)
        torch.cuda.synchronize()
    for name, a, b, c, d in (("#2", dx, dx_again, grads, grads_again),
                             ("#4", dx4, dx4_again, grads4, grads4_again)):
        if not (torch.equal(a, b) and all(torch.equal(c[k], d[k])
                                          for k in bk.PKEYS)):
            raise RuntimeError(f"{what}: a repeated {name} call gave other "
                               f"bits")
    tol = functools.partial(bwd_tol, dtype=dtype)
    errs2 = held([("dx", dx, ref_dx)] + [(k, grads[k], ref_g[k])
                                          for k in bk.PKEYS], tol)
    errs4 = held([("dx", dx4, ref_dx4)] + [(k, grads4[k], ref_g4[k])
                                            for k in bk.PKEYS], tol)
    with torch.no_grad():
        ms2 = time_ms(lambda: bk._launch_bwd(x, g, params, heads), reps=9)
        plain2 = time_ms(lambda: bk.block_backward_reference(
            x, g, params, heads), reps=5, inner=3)
        ms4 = time_ms(lambda: bk._launch_bwd_res(x, g, *saved, params,
                                                 heads), reps=9)
        plain4 = time_ms(lambda: bk.block_backward_residual_reference(
            x, g, *saved, params, heads), reps=5, inner=3)
        ops2 = top_ops(device_ops(lambda: bk._launch_bwd(x, g, params,
                                                         heads), calls=10))
    xg = x.detach().clone().requires_grad_()
    gx = g.to(dtype)
    layer.train()
    lib_fwd_bwd = time_ms(lambda: layer(xg).backward(gx), reps=9)
    grad_bytes = 4 * wcount + 4 * x.numel() + io + wbytes
    flops2 = 3 * fwd_flops - 2 * M * D * H
    flops4 = 2 * fwd_flops + 2 * M * D * D + 2 * B * heads * N * N * hd
    worst = {n: max(e["max_abs_err"] / max(e["tolerance"], 1e-30)
                    for e in errs.values()) for n, errs in (("#2", errs2),
                                                            ("#4", errs4))}
    out["vit_block_bwd"] = {
        **common, "outputs": errs2,
        "max_abs_err": max(e["max_abs_err"] for e in errs2.values()),
        "worst_err_over_tolerance": worst["#2"],
        "kernel_ms": ms2, "plain_ms": plain2, "library_ms": lib_fwd_bwd,
        "library": "nn.TransformerEncoderLayer forward + backward",
        "device_ms_by_kernel": ops2, **bound(flops2, grad_bytes)}
    out["vit_block_bwd_res"] = {
        **common, "outputs": errs4,
        "max_abs_err": max(e["max_abs_err"] for e in errs4.values()),
        "worst_err_over_tolerance": worst["#4"],
        "kernel_ms": ms4, "plain_ms": plain4, "library_ms": lib_fwd_bwd,
        "library": "nn.TransformerEncoderLayer forward + backward (timed "
                   "once for #2 and #4)",
        **bound(flops4, grad_bytes + res_bytes)}
    return out


def augment_tol(compute) -> float:
    """Both sides round at the same points; the pivot sums H*W*3 terms in
    another order, and a rounding boundary it crosses moves each of the
    three rounded blends by at most one ulp of [0, 1] (2^-8 in bf16), scaled
    by 1/std (<= 1/0.224) in the normalization. fp32: sum order only."""
    return 3 * 2.0 ** -8 / 0.224 if compute == torch.bfloat16 else 1e-5


#: #7's timed shapes: the 224-px train step's batch in bf16 and fp32
#: compute and the 384-px ("long") step's in bf16, fp32 out; and one odd
#: shape (W * 3 % 16 != 0, so no bulk copies) held but not timed.
AUGMENT_SHAPES = (((BATCH, 224, 224), torch.bfloat16),
                  ((BATCH, 224, 224), torch.float32),
                  ((32, 384, 384), torch.bfloat16))
AUGMENT_ODD = (3, 33, 35)


def check_augment(compute, seed: int, shape=(BATCH, 224, 224),
                  timed: bool = True):
    """Kernel #7 against ``augment_reference`` within ``augment_tol``, the
    same bits on a repeated call, and timed three ways: by CUDA events
    around back-to-back wrapper calls (``kernel_ms``, as #1-#6), by
    CUDA-graph replay (``kernel_graph_ms``, the device time) and by
    torch.profiler device time per launch name (``device_ms_by_kernel``).
    Bytes: each input read once, each output written once."""
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    B, H, W = shape
    rng = np.random.RandomState(seed)
    imgs = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3))
                            .astype(np.uint8)).cuda()
    factors = ak.draw_factors(torch.Generator("cuda").manual_seed(seed), B)
    got = ak.fused_augment_batch(imgs, factors, compute)
    again = ak.fused_augment_batch(imgs, factors, compute)
    want = ak.augment_reference(imgs, factors, compute)
    torch.cuda.synchronize()
    what = f"augment kernel ({compute}, {tuple(shape)})"
    if not torch.isfinite(got).all():
        raise RuntimeError(f"{what} non-finite values")
    if not torch.equal(got, again):
        raise RuntimeError(f"{what}: a repeated call gave other bits")
    err = float((got - want).abs().max())
    tol = augment_tol(compute)
    if not err <= tol:
        raise RuntimeError(f"{what} max |err| {err} > tolerance {tol}")
    out = {"compute_dtype": str(compute).replace("torch.", ""),
           "out_dtype": "float32", "shape": [B, H, W, 3],
           "max_abs_err": err, "tolerance": tol,
           "identical_bits_on_repeat": True}
    if not timed:
        return out
    fn = functools.partial(ak.fused_augment_batch, imgs, factors, compute)
    ops = device_ops(fn)
    nbytes = imgs.numel() * (1 + got.element_size()) + factors.numel() * 4
    return {"replaces": "rovit_kan_tpu/ops/augment_kernel.py::"
                        "_augment_kernel", **out,
            "launches_per_step": "1 (counted in 'train')",
            "kernel_ms": time_ms(fn), "kernel_graph_ms": graph_ms(fn),
            "device_ms_by_kernel": {k[:90]: v for k, v in ops.items()},
            "device_ms": sum(ops.values()),
            "plain_ms": time_ms(lambda: ak.augment_reference(
                imgs, factors, compute), reps=9, inner=3),
            "library_ms": None,
            "library": "none: no single PyTorch call computes the flips, "
                       "jitter and normalization, and the card has no "
                       "torchvision",
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
            "bound_by": "bytes"}


def augment_checks(seed: int = 4) -> dict:
    """#7 at ``AUGMENT_SHAPES`` (timed) and ``AUGMENT_ODD`` in bf16 and
    fp32 compute (held only)."""
    timed = [check_augment(c, seed + i, shape)
             for i, (shape, c) in enumerate(AUGMENT_SHAPES)]
    odd = [check_augment(c, seed + 7 + i, AUGMENT_ODD, timed=False)
           for i, c in enumerate((torch.bfloat16, torch.float32))]
    return {"bf16": timed[0], "fp32": timed[1], "n384": timed[2],
            "odd": odd}


KAN_DIMS = (192, 64, 16, 1)
KAN_BASES = 7
KAN_LIBRARY = ("none: no PyTorch call computes a KAN layer (a B-spline "
               "basis of tanh x contracted with per-edge coefficients)")


def kan_inputs(seed: int, dims=KAN_DIMS):
    """Seeded fp32 inputs on the card: features ``(64, dims[0])``, the
    head's parameters in the port's layouts (spline N(0, 0.1^2), linear
    N(0, 1/in), bias N(0, 0.1^2)) and an upstream gradient."""
    rng = np.random.RandomState(seed)

    def t(v):
        return torch.tensor(v, dtype=torch.float32, device="cuda")

    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        params += [t(rng.normal(0, 0.1, (a, b, KAN_BASES))),
                   t(rng.normal(0, a ** -0.5, (b, a))),
                   t(rng.normal(0, 0.1, (b,)))]
    return (t(rng.normal(0, 1.5, (BATCH, dims[0]))), params,
            t(rng.normal(0, 1, (BATCH, dims[-1]))))


def kan_flops(dims, module: bool) -> tuple:
    """FLOP of the KAN head (``module``) or one layer at batch 64, unpadded:
    each layer is ``KAN_BASES + 1`` products of ``(64, in) x (in, out)``.
    Each backward does two products per forward product (the weight
    gradients and dx); the head's (#11) also recomputes the forward, one
    layer's (#9) only the bases."""
    fwd = sum(2 * (KAN_BASES + 1) * BATCH * a * b
              for a, b in zip(dims[:-1], dims[1:]))
    return fwd, (3 if module else 2) * fwd


def hold_kan(what: str, pairs):
    """Each output within 1e-4 of its largest magnitude (fp32 sums in
    another order); raises on a miss."""
    errs, failed = {}, []
    for name, got, ref in pairs:
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{what} {name}: non-finite values")
        err = float((got - ref).abs().max())
        tol = 1e-4 * max(float(ref.abs().max()), 1e-6)
        errs[name] = {"max_abs_err": err, "tolerance": tol}
        if not err <= tol:
            failed.append(name)
    if failed:
        raise RuntimeError(f"{what} out of tolerance: "
                           f"{ {k: errs[k] for k in failed} }")
    return errs


def same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def kan_result(replaces, shape, errs, ms, plain_ms, flops, nbytes,
               launches):
    bound = {"operations": flops / PEAK_FP32_FLOPS,
             "bytes": nbytes / PEAK_BYTES_PER_S}
    by = max(bound, key=bound.get)
    return {"replaces": "rovit_kan_tpu/ops/kan_kernel.py::" + replaces,
            "dtype": "float32", "shape": shape,
            "launches_per_use": launches, "outputs": errs,
            "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
            "identical_bits_on_repeat": True, "kernel_ms": ms,
            "kernel_ms_source": "torch.profiler device time per call",
            "plain_ms": plain_ms,
            "plain_ms_source": "torch.profiler device time per call, all "
                               "device operations",
            "library_ms": None,
            "library": KAN_LIBRARY, "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * bound[by], "bound_by": by}


def device_ms(fn, kernels=None, calls: int = 50) -> float:
    """Device time per call of ``fn``, from torch.profiler over ``calls``
    calls after a warm-up: the time of the named kernels, or of every device
    operation when ``kernels`` is None. A wrapper call's host time exceeds
    these kernels' device time, so CUDA events around back-to-back calls
    would time the host. Raises if a named kernel, or any device operation,
    is missing from the profile."""
    names = {"all": ""} if kernels is None else {k: k for k in kernels}
    return sum(device_ms_by(fn, names, calls).values())


def profile_device(fn, calls: int = 20, takes: int = 5) -> dict:
    """Launches and device time (ms) per device operation name over
    ``calls`` calls of ``fn``, from torch.profiler after a warm-up call. The
    profiler first traces one warm-up round of ``calls`` calls that it
    discards (its schedule's warm-up step), since the first operations of a
    trace can be lost. A profile in which an operation's launches are not a
    multiple of ``calls`` lost some of them, and would time the calls it
    kept as if they were all; it is taken again, up to ``takes`` times, and
    the function raises if none is whole."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for _ in range(takes):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        ops = {e.key: (e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")}   # the step span
        if ops and all(n % calls == 0 for n, _ in ops.values()):
            return ops
    raise RuntimeError(f"no whole profile in {takes} takes of {calls} calls:"
                       f" launches {({k[:80]: n for k, (n, _) in ops.items()})}")


def device_ops(fn, calls: int = 20) -> dict:
    """Device time per call of ``fn`` by device operation name (ms), from a
    whole profile of ``calls`` calls (``profile_device``)."""
    return {k: ms / calls for k, (_, ms) in profile_device(fn, calls).items()}


def by_label(ops: dict, kernels: dict) -> dict:
    """Sums of ``device_ops`` by label, each label the operations whose name
    holds its substring ("" holds every one). Raises if a label has no
    device time."""
    out = {}
    for label, sub in kernels.items():
        ms = sum(v for k, v in ops.items() if sub in k)
        if not ms > 0:
            raise RuntimeError(f"no device time recorded for {sub}")
        out[label] = ms
    return out


def device_ms_by(fn, kernels: dict, calls: int = 20) -> dict:
    """Device time per call of ``fn`` by label (``by_label``), from one
    torch.profiler run over ``calls`` calls after a warm-up."""
    return by_label(device_ops(fn, calls), kernels)


def graph_ms(fn, calls: int = 20) -> float:
    """Device time per call of ``fn``: CUDA events around replays of one
    CUDA graph that captured ``calls`` calls, so the host enqueues one graph
    launch per replay and a call whose host work exceeds its device time is
    still timed by the device. Three warm-up calls off the capture, as
    PyTorch asks before a capture of autograd's backward."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps=10, inner=3) / calls


def kernel_label(mangled: str) -> str:
    """A mangled kernel name as its identifier and integer and bool
    template arguments, ``attn_fwd_tf32_kernel<64,true>``."""
    m = re.match(r"_ZN", mangled)
    if not m:
        return mangled[:60]
    pos, name = m.end(), mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        n = re.match(r"\d+", mangled[pos:]).group()
        pos += len(n)
        name, pos = mangled[pos:pos + int(n)], pos + int(n)
    args = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in re.findall(r"L([ib])(\d+)E",
                                   mangled[pos:].split("EEv")[0])]
    return name + (f"<{','.join(args)}>" if args else "")


def ptxas_table(log: str) -> list:
    """[kernel, registers, spill stores in bytes, stack frame in bytes] for
    each entry function of an ``nvcc -Xptxas -v`` log."""
    out, fn, spill, stack = [], None, 0, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn, spill, stack = m.group(1), 0, 0
        m = re.search(r"(\d+) bytes stack frame", ln)
        if m:
            stack = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out.append([kernel_label(fn), int(m.group(1)), spill, stack])
            fn = None
    return out


def kan_calls(dims, seed: int):
    """The smoke's seeded inputs at ``dims`` and the calls of the kernels and
    their plain versions on them: #10/#11 for the head, #8/#9 for one
    layer (``len(dims) == 2``). Each call returns a list of outputs; the
    kernels' take ``recip``, the basis's reciprocal divisions on or off."""
    from rovit_kan_tpu_torch.ops import kan_kernel as kk
    from rovit_kan_tpu_torch.ops.spline import make_knots
    knots = make_knots()
    x, params, g = kan_inputs(seed, dims)
    if len(dims) > 2:
        def fwd(recip=True):
            return [kk._launch_module(x, params, knots, 3, recip)]

        def bwd(recip=True):
            return flat_bwd(kk._launch_module_bwd(x, g, params, knots, 3,
                                                  recip))

        def plain_fwd():
            return [kk.kan_module_reference(x, params, knots)]

        def plain_bwd():
            return flat_bwd(kk.kan_module_backward_reference(x, g, params,
                                                             knots))
    else:
        def fwd(recip=True):
            return [kk._launch_layer(x, *params, knots, 3, recip)]

        def bwd(recip=True):
            return list(kk._launch_layer_bwd(x, g, *params[:2], knots, 3,
                                             recip))

        def plain_fwd():
            return [kk.kan_layer_reference(x, *params, knots)]

        def plain_bwd():
            return list(kk.kan_layer_backward_reference(
                x, g, *params[:2], knots))
    return (x, params, g), (fwd, bwd, plain_fwd, plain_bwd)


def kan_module_outputs(seed: int = 6) -> list:
    """#10's output and #11's gradients at the smoke's inputs, for holding
    two checkouts' kernels against each other bit for bit (this file copied
    into the other checkout and called there)."""
    _, (fwd, bwd, _, _) = kan_calls(KAN_DIMS, seed)
    with torch.no_grad():
        out = [t.cpu() for t in fwd() + bwd()]
    torch.cuda.synchronize()
    return out


def kernels_per_call(fn, want: dict) -> dict:
    """The device operations of one call of ``fn`` (whole profiles): raises
    unless they are ``want``'s kernels (name: launches), each named op
    holding one of its names."""
    with torch.no_grad():
        ops = profile_device(fn, calls=10)
    per_call = {k[:80]: n / 10 for k, (n, _) in ops.items()}
    got = {name: sum(n for k, n in per_call.items() if name in k)
           for name in want}
    if got != want or sum(per_call.values()) != sum(want.values()):
        raise RuntimeError(f"launches per call {per_call}, want {want}")
    return per_call


def kan_bwd_kernels(dims, batch: int = BATCH) -> dict:
    """The kernels of one #11 call (#9 for one layer) under its plan: a
    launch a wave of at most ``slots`` clusters, then, past one row group,
    the slots' ordered add."""
    from rovit_kan_tpu_torch.ops import kan_kernel as kk
    plan = kk.module_plan(batch, tuple(dims), KAN_BASES, True, len(dims) > 2)
    want = {"kan_module_bwd_kernel": -(-plan.groups // plan.slots)}
    if plan.groups > 1:
        want["kan_grad_reduce_kernel"] = 1
    return want


def check_kan_case(dims, names, seed: int, floor: float) -> dict:
    """#10/#11 (the head) or #8/#9 (one layer) at (64, ``dims``): each
    output against its plain version, the same bits on a repeated call and
    with the basis's reciprocal divisions off, the kernels of a call
    (``kan_bwd_kernels``), and timed by torch.profiler device time (every
    device operation of a call: its kernels) and by CUDA-graph replay
    beside the launch floor ``floor``. Bytes: each input read once, each
    output written once."""
    (x, params, g), (fwd, bwd, plain_fwd, plain_bwd) = kan_calls(dims, seed)
    module = len(dims) > 2
    fwd_name, bwd_name = names
    grad_names = ["dx"] + [f"d{k}{layer}" for layer in range(len(dims) - 1)
                           for k in ("spline", "weight", "bias")]
    with torch.no_grad():
        got_f, got_b = fwd(), bwd()
        want_f, want_b = plain_fwd(), plain_bwd()
        torch.cuda.synchronize()
        errs_f = hold_kan(fwd_name, [("y", got_f[0], want_f[0])])
        errs_b = hold_kan(bwd_name, list(zip(grad_names, got_b, want_b)))
        if not (same_bits(fwd(), got_f) and same_bits(bwd(), got_b)):
            raise RuntimeError(f"{fwd_name}/{bwd_name}: a repeated call "
                               f"gave other bits")
        if not (same_bits(fwd(False), got_f)
                and same_bits(bwd(False), got_b)):
            raise RuntimeError(f"{fwd_name}/{bwd_name}: the reciprocal "
                               f"basis gave other bits than __fdiv_rn")
        call_f, call_b = time_ms(fwd), time_ms(bwd)
        ms_f, ms_b = device_ms(fwd), device_ms(bwd)
        graph_f, graph_b = graph_ms(fwd), graph_ms(bwd)
        # The plain versions on the kernels' clock: the device time of
        # all their operations; CUDA events keep their call time.
        plain_f = device_ms(plain_fwd, calls=10)
        plain_b = device_ms(plain_bwd, calls=10)
        plain_call_f = time_ms(plain_fwd, reps=9, inner=3)
        plain_call_b = time_ms(plain_bwd, reps=9, inner=3)
    per_call_f = kernels_per_call(fwd, {"kan_module_fwd_kernel": 1})
    per_call_b = kernels_per_call(bwd, kan_bwd_kernels(dims))
    flops_f, flops_b = kan_flops(dims, module)
    wbytes = 4 * sum(p.numel() for p in params)
    # y has the shape of g.
    xbytes, gbytes = 4 * x.numel(), 4 * g.numel()
    shape = [BATCH, list(dims)]
    out = {fwd_name: kan_result(
        "_kan_module_kernel" if module else "_kan_kernel", shape, errs_f,
        ms_f, plain_f, flops_f, xbytes + wbytes + gbytes,
        "1 per served batch and per train step (counted in 'kan')"
        if module else "1 per layer of a trajectory (counted in 'kan')"),
        bwd_name: kan_result(
        "_kan_module_bwd_kernel" if module else "_kan_layer_bwd_kernel",
        shape, errs_b, ms_b, plain_b, flops_b,
        2 * xbytes + gbytes + 2 * wbytes,
        "1 per train step, one launch (counted in 'kan')" if module
        else "1 per layer of a trajectory's gradient, a cluster launch and "
             "the slots' ordered add (counted in 'kan')")}
    for name, call, plain_call, graph, per_call in (
            (fwd_name, call_f, plain_call_f, graph_f, per_call_f),
            (bwd_name, call_b, plain_call_b, graph_b, per_call_b)):
        out[name].update(call_ms=call, plain_call_ms=plain_call,
                         kernel_graph_ms=graph, launch_floor_ms=floor,
                         launches_per_call=per_call,
                         reciprocal_basis_same_bits=True)
    return out


def kan_layer_bwd_rows(seed: int) -> dict:
    """#9 at (64, 192 -> 64) with 16, 32 and 64 rows a group
    (``LAYER_BWD_ROWS``: 4, 2 and 1 clusters; past one, the slots' ordered
    add as a second launch), each held against its plain version and timed
    by CUDA-graph replay, ms."""
    from rovit_kan_tpu_torch.ops import kan_kernel as kk
    _, (_, bwd, _, plain_bwd) = kan_calls(KAN_DIMS[:2], seed)
    rows, out = kk.LAYER_BWD_ROWS, {}
    try:
        for r in (16, 32, 64):
            kk.LAYER_BWD_ROWS = r
            kk.module_plan.cache_clear()
            kk._module_args.cache_clear()
            with torch.no_grad():
                hold_kan(f"kan_layer_bwd at {r} rows", list(zip(
                    ("dx", "dspline", "dweight", "dbias"), bwd(),
                    plain_bwd())))
                out[str(r)] = graph_ms(bwd)
    finally:
        kk.LAYER_BWD_ROWS = rows
        kk.module_plan.cache_clear()
        kk._module_args.cache_clear()
    return out


def check_kan(seed: int):
    """#10/#11 at (64, [192, 64, 16, 1]) and #8/#9 at (64, 192 -> 64)
    (``check_kan_case``), #9's rows a group (``kan_layer_bwd_rows``), and
    the trajectory's other layers, 64 -> 16 and 16 -> 1, under
    "kan_layer_widths"."""
    tiny = torch.zeros(1, device="cuda")
    floor = graph_ms(lambda: tiny.fill_(1.0))
    out = {**check_kan_case(KAN_DIMS, ("kan_module_fwd", "kan_module_bwd"),
                            seed, floor),
           **check_kan_case(KAN_DIMS[:2], ("kan_layer_fwd", "kan_layer_bwd"),
                            seed, floor)}
    out["kan_layer_bwd"]["rows_graph_ms"] = kan_layer_bwd_rows(seed)
    out["kan_layer_widths"] = {
        f"{a}->{b}": check_kan_case((a, b), ("kan_layer_fwd",
                                             "kan_layer_bwd"), seed, floor)
        for a, b in zip(KAN_DIMS[1:-1], KAN_DIMS[2:])}
    return out


def flat_bwd(result):
    """#11's (dx, grads) as one list."""
    dx, grads = result
    return [dx, *grads]


def features(model, images_u8: np.ndarray) -> np.ndarray:
    """The backbone's fp32 CLS features for a uint8 batch."""
    from rovit_kan_tpu_torch.ops.preprocess import eval_batch
    with torch.inference_mode():
        x = eval_batch(torch.from_numpy(images_u8).cuda())
        return model.backbone(x).float().cpu().numpy()


def profile_serving(engine, images_u8: np.ndarray, smi: str):
    """torch.profiler over one pipelined request of several batches: device
    time by kernel and the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile
    engine.predict(images_u8[:engine.batch_size])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.predict(images_u8)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    return {"phase": "profile", "images": int(images_u8.shape[0]),
            "batches": -(-images_u8.shape[0] // engine.batch_size),
            "wall_ms": wall_ms, "device_kernel_ms": total,
            "device_busy_share": total / wall_ms,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top], "card": smi}


SERVED_KEYS = ("features", "cls_probs", "ordinal_probs", "ordinal_severity",
               "uncertainty_std", "kan_severity")


def hold_served(served, plain, exact, keys=SERVED_KEYS):
    """Served outputs ``keys`` (and the argmax ``cls_pred``) of a kernel path
    against the same model through the
    plain versions (``plain``) and the fp32 model (``exact``). The kernel
    and the plain path round at the same points; where an fp32 sum in
    another order crosses a bf16 rounding boundary, the one-ulp difference
    spreads through the 12 blocks like any other bf16 rounding error. So
    the kernel path must be as accurate as the plain bf16 path: by the
    triangle inequality both its distance from the plain model and its
    distance from fp32 then stay within twice the plain model's own distance
    from fp32 (floor 1e-3 for outputs bf16 barely moves). Returns the
    readings and the names of the outputs that failed."""
    checks, failed = {}, []
    for k in keys:
        ref_err = float(np.abs(plain[k] - exact[k]).max())
        checks[k] = {"vs_plain_block": float(np.abs(served[k]
                                                    - plain[k]).max()),
                     "vs_fp32": float(np.abs(served[k] - exact[k]).max()),
                     "plain_block_vs_fp32": ref_err,
                     "tolerance": 2 * max(ref_err, 1e-3)}
        c = checks[k]
        if not max(c["vs_plain_block"], c["vs_fp32"]) <= c["tolerance"]:
            failed.append(k)
    # An argmax may flip only where the top two probabilities are closer
    # than the probabilities moved.
    flips = np.nonzero(served["cls_pred"] != plain["cls_pred"])[0]
    top2 = np.sort(plain["cls_probs"], axis=-1)[:, -2:]
    gaps = top2[flips, 1] - top2[flips, 0]
    checks["cls_pred"] = {
        "flips_vs_plain_block": int(flips.size),
        "flips_vs_fp32": int(np.sum(served["cls_pred"]
                                    != exact["cls_pred"])),
        "max_flip_gap": float(gaps.max()) if flips.size else 0.0}
    if np.any(gaps > 2 * checks["cls_probs"]["vs_plain_block"]):
        failed.append("cls_pred")
    return checks, failed


def serve(smi: str):
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.serving import InferenceEngine, MicroBatcher

    cfg = Config()
    model = build_model(cfg, inference=True, device="cuda", seed=0)
    blocks = model.backbone.model.blocks
    if not all(b.use_fused_block for b in blocks):
        raise RuntimeError("the 'auto' policy did not pick the block kernel")
    engine = InferenceEngine(model, batch_size=BATCH, device="cuda")
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0

    rng = np.random.RandomState(0)
    size = cfg.data.image_size
    full = [rng.randint(0, 256, (BATCH, size, size, 3)).astype(np.uint8)
            for _ in range(8)]
    partial = rng.randint(0, 256, (17, size, size, 3)).astype(np.uint8)
    singles = rng.randint(0, 256, (32, size, size, 3)).astype(np.uint8)

    # The main path, between the counter reset and the read.
    bk.LAUNCHES = 0
    outs = [engine.predict(imgs) for imgs in full]
    out_partial = engine.predict(partial)
    batcher = MicroBatcher(engine)
    got = [None] * len(singles)

    def client(i):
        got[i] = batcher.predict(singles[i:i + 1])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(singles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("MicroBatcher clients did not finish")
    batcher.close()
    direct = engine.predict(singles)
    stats = engine.stats()
    launches = bk.LAUNCHES
    batches = stats["requests"]
    depth = len(blocks)
    if launches != depth * batches:
        raise RuntimeError(f"block kernel launched {launches} times for "
                           f"{batches} batches; want {depth} per batch")

    # Shapes, finiteness, probabilities.
    for out, n in [(o, BATCH) for o in outs] + [(out_partial, 17),
                                                 (direct, 32)]:
        for k, v in out.items():
            if v.shape[0] != n or not np.isfinite(v).all():
                raise RuntimeError(f"{k}: shape {v.shape} or non-finite")
        for k in ("cls_probs", "ordinal_probs"):
            if not np.allclose(out[k].sum(-1), 1.0, atol=1e-5):
                raise RuntimeError(f"{k} rows do not sum to 1")
    # MicroBatcher slices against direct predictions: each image is computed
    # independently of its batch neighbours in padded batches of one shape,
    # so they agree to fp32 noise.
    mb_err = max(float(np.abs(got[i][k][0].astype(np.float64)
                              - direct[k][i]).max())
                 for i in range(len(singles)) for k in direct)
    if not mb_err <= 1e-5:
        raise RuntimeError(f"MicroBatcher slices differ from direct "
                           f"predictions by {mb_err}")

    # References on the first request: the same bf16 model with the plain
    # block, and the fp32 model (the port's unfused fp32 path, held against
    # the JAX model at 2e-5 on the CPU) with the same seeded weights.
    for b in blocks:
        b.block_fn = bk.plain_vit_block
    plain = engine.predict(full[0])
    plain["features"] = features(model, full[0])
    for b in blocks:
        b.block_fn = bk.fused_vit_block
    served = dict(outs[0], features=features(model, full[0]))
    model32 = build_model(cfg, dtype=torch.float32, inference=True,
                          device="cuda", seed=0)
    exact = InferenceEngine(model32, batch_size=BATCH,
                            device="cuda").predict(full[0])
    exact["features"] = features(model32, full[0])
    checks, failed = hold_served(served, plain, exact)
    if failed:
        emit({"phase": "serve", "outputs": checks})
        raise RuntimeError(f"served outputs out of tolerance: {failed}")

    emit(profile_serving(engine, np.concatenate(full[:5]), smi))
    return {"phase": "serve", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16", "batch_size": BATCH,
            "batches": batches, "block_launches": launches,
            "launches_per_batch": launches / batches,
            "microbatcher_batches": batcher.batches_run,
            "warmup_s": warmup_s, "images_per_sec": stats["images_per_sec"],
            "p50_latency_ms": stats["p50_latency_ms"],
            "p95_latency_ms": stats["p95_latency_ms"],
            "microbatcher_max_abs_err": mb_err, "outputs": checks,
            "card": smi}


def train_batch(cfg, seed: int, batch: int = BATCH):
    rng = np.random.RandomState(seed)
    size = cfg.data.image_size
    labels = torch.from_numpy(rng.randint(0, 4, batch)).long().cuda()
    return {"images": torch.from_numpy(rng.randint(
                0, 256, (batch, size, size, 3)).astype(np.uint8)).cuda(),
            "labels": labels, "severity": labels.float()}


@functools.lru_cache(maxsize=None)
def _plain_backward_block():
    from rovit_kan_tpu_torch.ops import block_kernel as bk

    class PlainBackward(bk.FusedViTBlock):
        @staticmethod
        def backward(ctx, g):
            ctx.plain = True
            return bk.FusedViTBlock.backward(ctx, g)

    return PlainBackward


def _kernel_fwd_plain_bwd(x, params, heads=HEADS, kernel_params=None):
    """A block ``block_fn``: #1 in the forward, #2's plain version in the
    backward, so a step through it differs from the kernel step only in the
    backward."""
    from rovit_kan_tpu_torch.ops.block_kernel import PKEYS
    return _plain_backward_block().apply(x, heads, kernel_params, False,
                                         *(params[k] for k in PKEYS))


def one_step(cfg, kind: str, batch, draws, stage: int):
    """One step at ``stage`` from the seed-0 weights with fixed draws:
    ``kernels`` (bf16, #1, #2 and #7), ``kernel_fwd`` (as ``kernels``, but
    the block backward is #2's plain version), ``plain`` (bf16 through the
    kernels' plain versions), ``fp32`` (the fp32 model, unfused, fp32
    augment chain) or ``fp32_rounded`` (as ``fp32``, its input images
    rounded to bf16). Returns the loss, each image's loss alone and the
    gradient of every parameter."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.ops.mixing import cutmix_or_mixup
    from rovit_kan_tpu_torch.ops.preprocess import augment_batch
    from rovit_kan_tpu_torch.training.losses import joint_loss
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    fp32 = kind.startswith("fp32")
    if fp32:
        # An fp32 model under the mixed-precision config: the trainer's
        # "auto" would take the augment kernel (bf16), as the JAX step does,
        # so the fp32 kinds ask for the fp32 chain.
        cfg = copy.deepcopy(cfg)
        cfg.train.fused_augment = False
    model = build_model(cfg, dtype=torch.float32 if fp32 else torch.bfloat16,
                        device="cuda", seed=0)
    blocks = model.backbone.model.blocks
    for b in blocks:
        b.block_fn = {"plain": bk.plain_vit_block,
                      "kernel_fwd": _kernel_fwd_plain_bwd}.get(kind,
                                                               b.block_fn)
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(1))
    if kind == "plain":
        step.augment = ak.augment_reference
    if kind == "fp32_rounded":
        step.augment = lambda images, factors: augment_batch(
            images, factors).to(torch.bfloat16).float()
    if fp32 == (step.fused_augment and all(b.use_fused_block
                                           for b in blocks)):
        raise RuntimeError(f"{kind} step: unexpected kernel policy")
    outputs = {}
    model.register_forward_hook(lambda mod, args, out: outputs.update(out))
    m = step(batch, stage, 1.0, 1, draws=dict(
        draws, dropout=torch.Generator("cuda").manual_seed(2)))
    # Each image's loss alone: the step's joint loss over one valid row.
    labels = batch["labels"]
    _, la, lb, lam = cutmix_or_mixup(torch.zeros(batch["images"].shape,
                                                 device="cuda"),
                                     labels, draws["mix"])
    lc, eye = cfg.loss, torch.eye(BATCH, device="cuda")
    per_image = np.array([float(joint_loss(
        {k: v.detach() for k, v in outputs.items()}, labels,
        batch["severity"], stage, lambda_ord=lc.lambda_ord, mu_unc=lc.mu_unc,
        nu_kan=lc.nu_kan, focal_gamma=lc.focal_gamma,
        head_mask=model.head_mask,
        mixup={"labels_a": la, "labels_b": lb, "lam": lam},
        valid=eye[i])["total_loss"]) for i in range(BATCH)])
    return {"loss": float(m["total_loss"]), "per_image": per_image,
            "outputs": {k: outputs[k].detach().float()
                        for k in ("features", "kan_severity")},
            "grads": {k: p.grad.detach().clone()
                      for k, p in zip(opt.names, opt.params)}}


GROUPS = ("backbone.", "classification_head.", "ordinal_head.",
          "uncertainty_head.", "kan_module.")


def grad_gaps(a, b, leaves=None):
    """The L2 distance ``|a - b|`` and the norm ``|b|`` of the gradient of
    each parameter group (and of all of them), from two ``one_step``
    results."""
    def cat(r, keys):
        return torch.cat([r["grads"][k].reshape(-1) for k in keys])

    out = {}
    for group in GROUPS + ("all",):
        keys = [k for k in (leaves or a["grads"])
                if group == "all" or k.startswith(group)]
        if not keys:
            continue
        ga, gb = cat(a, keys), cat(b, keys)
        out[group.rstrip(".")] = {"dist": float((ga - gb).norm()),
                                  "norm": float(gb.norm())}
    return out


def hold_train_step(cfg, batch, draws):
    """One step held against its plain versions; raises on a miss.

    1. Backward (#2), stage 4: the kernel step against the same step with
       #2's plain version. The forwards are the same launches, so the loss
       and the heads' grads agree exactly, and each parameter's gradient
       may differ only by #2's own rounding, summed over 12 blocks: it must
       lie within 5e-2 of its L2 norm (the card test's limit).
    2. Loss, stage 4: each image's loss in the kernel step within twice the
       plain bf16 step's largest distance from fp32 (the serve phase's
       triangle rule, floor 1e-3). Per image, because the batch mean
       cancels: the two means may land far closer than any image's loss.
    3. Gradient, stage 3: per parameter group and in all, the kernel step's
       distances from the plain step and from fp32 within twice the plain
       step's distance from fp32 (floor 1e-3 of the fp32 norm). Stage 3,
       because stage 4's KAN loss makes the gradient ill-conditioned at
       these weights: rounding the fp32 step's input images to bf16 alone
       moves it by the ``conditioning`` readings, so there no bf16 step can
       be told apart from a wrong one (readings in ``stage4_readings``).
    """
    runs = {(kind, stage): one_step(cfg, kind, batch, draws, stage)
            for stage, kinds in ((4, ("kernels", "kernel_fwd", "plain",
                                      "fp32", "fp32_rounded")),
                                 (3, ("kernels", "plain", "fp32",
                                      "fp32_rounded")))
            for kind in kinds}
    failed = []

    k4, kf4 = runs["kernels", 4], runs["kernel_fwd", 4]
    leaf = {}
    for name, g in k4["grads"].items():
        ref = kf4["grads"][name]
        leaf[name] = float((g - ref).norm()) / max(float(ref.norm()), 1e-30)
    worst = max(leaf, key=leaf.get)
    backward = {"tolerance": 5e-2, "worst_leaf": worst,
                "worst_rel": leaf[worst],
                "median_leaf_rel": float(np.median(list(leaf.values()))),
                "all_rel": grad_gaps(k4, kf4)["all"],
                "loss_diff": k4["loss"] - kf4["loss"]}
    if not leaf[worst] <= 5e-2:
        failed.append("backward")

    p4, f4 = runs["plain", 4], runs["fp32", 4]
    ref = max(float(np.abs(p4["per_image"] - f4["per_image"]).max()), 1e-3)
    loss = {"kernels": k4["loss"], "plain": p4["loss"], "fp32": f4["loss"],
            "per_image_vs_plain": float(np.abs(k4["per_image"]
                                               - p4["per_image"]).max()),
            "per_image_vs_fp32": float(np.abs(k4["per_image"]
                                              - f4["per_image"]).max()),
            "per_image_plain_vs_fp32": ref, "tolerance": 2 * ref}
    if not max(loss["per_image_vs_plain"],
               loss["per_image_vs_fp32"]) <= loss["tolerance"]:
        failed.append("loss")

    k3, p3, f3 = runs["kernels", 3], runs["plain", 3], runs["fp32", 3]
    live = [k for k, g in f3["grads"].items() if float(g.norm()) > 0]
    vs_p, vs_f, p_f = (grad_gaps(a, b, live)
                       for a, b in ((k3, p3), (k3, f3), (p3, f3)))
    grad = {}
    for group, pf in p_f.items():
        if pf["norm"] == 0:
            continue
        tol = 2 * max(pf["dist"], 1e-3 * pf["norm"])
        grad[group] = {"vs_plain": vs_p[group]["dist"] / pf["norm"],
                       "vs_fp32": vs_f[group]["dist"] / pf["norm"],
                       "plain_vs_fp32": pf["dist"] / pf["norm"],
                       "tolerance": tol / pf["norm"]}
        if not max(vs_p[group]["dist"], vs_f[group]["dist"]) <= tol:
            failed.append(f"stage-3 grad {group}")

    def rel(gaps):
        return {g: v["dist"] / v["norm"] for g, v in gaps.items()
                if v["norm"] > 0}

    def moved(a, b):
        return {f"{k}_max_abs": float((a["outputs"][k]
                                       - b["outputs"][k]).abs().max())
                for k in a["outputs"]}

    held = {"backward_stage4": backward, "loss_stage4": loss,
            "grad_stage3": grad,
            "stage4_readings": {
                "kernels_vs_plain": rel(grad_gaps(k4, p4)),
                "plain_vs_fp32": rel(grad_gaps(p4, f4)),
                "kernels_vs_fp32": rel(grad_gaps(k4, f4))},
            "conditioning": {
                **moved(runs["fp32_rounded", 4], f4),
                "stage4": rel(grad_gaps(runs["fp32_rounded", 4], f4)),
                "stage3": rel(grad_gaps(runs["fp32_rounded", 3], f3,
                                        live))}}
    if failed:
        emit({"phase": "train", "held": held})
        raise RuntimeError(f"train step out of tolerance: {failed}")
    return held


def profile_step(fn):
    """torch.profiler over one train step, ``fn()``: device time by kernel
    and the device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]
    return {"wall_ms": wall_ms, "device_kernel_ms": total,
            "device_busy_share": total / wall_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def train(smi: str):
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    from rovit_kan_tpu_torch.training.optimizer import (
        build_optimizer,
        set_hyperparams,
    )
    from rovit_kan_tpu_torch.training.trainer import make_train_step

    cfg = Config()
    model = build_model(cfg, device="cuda", seed=0)
    blocks = model.backbone.model.blocks
    if not model.training or not all(b.use_fused_block for b in blocks):
        raise RuntimeError("the 'auto' policy did not pick the block kernel "
                           "for training")
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(0))
    if not step.fused_augment:
        raise RuntimeError("the 'auto' policy did not pick the augment kernel")
    batches = [train_batch(cfg, 100 + i) for i in range(10)]
    torch.cuda.synchronize()

    # The main path, between the counter reset and the read.
    bk.LAUNCHES = bk.BWD_LAUNCHES = ak.LAUNCHES = 0
    metrics = []
    for i, batch in enumerate(batches):
        if i == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        metrics.append(step(batch, 4, 1.0, 1))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"vit_block_fwd": bk.LAUNCHES, "vit_block_bwd":
                bk.BWD_LAUNCHES, "augment": ak.LAUNCHES}
    steps = len(batches)
    want = {"vit_block_fwd": 12 * steps, "vit_block_bwd": 12 * steps,
            "augment": steps}
    if launches != want:
        raise RuntimeError(f"train launches {launches}, want {want}")
    losses = [float(m["total_loss"]) for m in metrics]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite train losses {losses}")

    prof = profile_step(lambda: step(batches[0], 4, 1.0, 1))

    # One repeated batch, mixing off, at lr 1e-3: the loss must fall.
    set_hyperparams(opt, 1e-3, 0.1)
    repeat = [float(step(batches[0], 4, 1.0, 0)["total_loss"])
              for _ in range(8)]
    if not repeat[-1] < repeat[0]:
        raise RuntimeError(f"loss did not fall on a repeated batch: "
                           f"{repeat}")

    # One step with the kernels, with their plain versions and with the
    # fp32 model, on the same weights and draws (see hold_train_step).
    held = hold_train_step(cfg, batches[0], {
        "factors": ak.draw_factors(torch.Generator("cuda").manual_seed(3),
                                   BATCH),
        "mix": draw_mix(torch.Generator().manual_seed(4), BATCH,
                        cfg.data.image_size, cfg.data.image_size)})

    emit({"phase": "train_profile", "batch_size": BATCH, **prof,
          "card": smi})
    return {"phase": "train", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16, stage 4, CutMix/MixUp, flat AdamW",
            "batch_size": BATCH, "steps": steps, "launches": launches,
            "launches_per_step": {k: v / steps for k, v in launches.items()},
            "losses": losses, "repeated_batch_losses": repeat,
            "images_per_sec": BATCH * (steps - 2) / elapsed,
            "step_ms": 1e3 * elapsed / (steps - 2), "held": held,
            "card": smi}


def count_device_ops(fn) -> int:
    """Device operations (kernels, copies) that one call of ``fn`` enqueues,
    from torch.profiler, after a warm-up call (``profile_device``)."""
    return sum(n for n, _ in profile_device(fn, calls=1).values())


def set_kan_fused(kan, fused: bool) -> None:
    """The KAN head through the kernels (``fused``) or plain PyTorch: the
    module (#10/#11) and each layer called alone (#8/#9)."""
    kan.use_fused = fused
    for layer in kan.kan_layers:
        layer.use_fused = fused


def kan_step(cfg, fused: bool, batch, draws):
    """One stage-4 step from the seed-0 weights with fixed draws and dropout
    masks, the KAN head through the kernels (``fused``) or plain PyTorch.
    Returns the loss, the features' gradient and every parameter's."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    model = build_model(cfg, device="cuda", seed=0)
    set_kan_fused(model.kan_module, fused)
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(1))
    feats = {}

    def keep_features(mod, args, out):
        out["features"].retain_grad()
        feats["t"] = out["features"]

    model.register_forward_hook(keep_features)
    m = step(batch, 4, 1.0, 1, draws=dict(
        draws, dropout=torch.Generator("cuda").manual_seed(2)))
    return {"loss": float(m["total_loss"]),
            "features": feats["t"].grad.detach().clone(),
            "grads": {k: p.grad.detach().clone()
                      for k, p in zip(opt.names, opt.params)}}


def hold_kan_step(cfg, batch, draws):
    """One stage-4 step through #10/#11 against the same step with the plain
    KAN head (same weights, draws and dropout masks; the trunk's launches
    are the same, so the features agree to the bit): the loss within 1e-5
    relative; each KAN parameter's gradient and the features' gradient
    within 1e-4 of its L2 norm (fp32 sums in another order); every other
    parameter's within 5e-2, the limit hold_train_step sets for #2, since
    the KAN head's fp32 differences enter the bf16 block backward."""
    k, p = (kan_step(cfg, fused, batch, draws) for fused in (True, False))

    def rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    loss_rel = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    leaves = {name: rel(g, p["grads"][name]) for name, g in k["grads"].items()}
    kan = {n: v for n, v in leaves.items() if n.startswith("kan_module.")}
    rest = {n: v for n, v in leaves.items() if n not in kan}
    worst = max(rest, key=rest.get)
    held = {"loss_kernels": k["loss"], "loss_plain": p["loss"],
            "loss_rel": loss_rel, "loss_tolerance": 1e-5,
            "features_grad_rel": rel(k["features"], p["features"]),
            "kan_grad_rel": kan, "kan_tolerance": 1e-4,
            "other_worst_leaf": worst, "other_worst_rel": rest[worst],
            "other_median_rel": float(np.median(list(rest.values()))),
            "other_tolerance": 5e-2}
    failed = [n for n, ok in (
        ("loss", loss_rel <= 1e-5),
        ("features", held["features_grad_rel"] <= 1e-4),
        ("kan", max(kan.values()) <= 1e-4),
        ("other", rest[worst] <= 5e-2)) if not ok]
    if failed:
        emit({"phase": "kan", "held_step": held})
        raise RuntimeError(f"KAN train step out of tolerance: {failed}")
    return held


def kan_phase(smi: str):
    """The flagship with ``tpu.use_pallas_kan=True``: served, its KAN
    trajectory and the trajectory's gradient, and trained; each between a
    counter reset and a read."""
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.ops import kan_kernel as kk
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    from rovit_kan_tpu_torch.serving import InferenceEngine
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step

    def reset():
        bk.LAUNCHES = bk.BWD_LAUNCHES = ak.LAUNCHES = 0
        kk.LAUNCHES = kk.BWD_LAUNCHES = 0
        kk.LAYER_LAUNCHES = kk.LAYER_BWD_LAUNCHES = 0

    def read():
        return {"vit_block_fwd": bk.LAUNCHES, "vit_block_bwd": bk.BWD_LAUNCHES,
                "augment": ak.LAUNCHES, "kan_module_fwd": kk.LAUNCHES,
                "kan_module_bwd": kk.BWD_LAUNCHES,
                "kan_layer_fwd": kk.LAYER_LAUNCHES,
                "kan_layer_bwd": kk.LAYER_BWD_LAUNCHES}

    def zeros(**want):
        return {k: want.get(k, 0) for k in read()}

    cfg = Config()
    cfg.tpu.use_pallas_kan = True
    size = cfg.data.image_size
    model = build_model(cfg, inference=True, device="cuda", seed=0)
    kan = model.kan_module
    if not kan.use_fused:
        raise RuntimeError("use_pallas_kan did not reach the KAN module")
    engine = InferenceEngine(model, batch_size=BATCH, device="cuda")
    engine.warmup()
    rng = np.random.RandomState(7)
    batches = [rng.randint(0, 256, (BATCH, size, size, 3)).astype(np.uint8)
               for _ in range(4)]

    # Serving: the main path between a reset and a read.
    reset()
    served = [engine.predict(b) for b in batches]
    serve_launches = read()
    n = len(batches)
    if serve_launches != zeros(vit_block_fwd=12 * n, kan_module_fwd=n):
        raise RuntimeError(f"served launches {serve_launches}")
    # The same model with the plain KAN head: every other output the same
    # bits, the severity within 1e-5.
    set_kan_fused(kan, False)
    plain = [engine.predict(b) for b in batches]
    serve_ops_off = count_device_ops(lambda: engine.predict(batches[0]))
    set_kan_fused(kan, True)
    serve_ops_on = count_device_ops(lambda: engine.predict(batches[0]))
    sev_err = max(float(np.abs(a["kan_severity"] - b["kan_severity"]).max())
                  for a, b in zip(served, plain))
    differ = sorted({k for a, b in zip(served, plain) for k in a
                     if k != "kan_severity" and not np.array_equal(a[k],
                                                                   b[k])})
    if differ or not sev_err <= 1e-5:
        raise RuntimeError(f"served with #10: outputs {differ} differ, "
                           f"severity by {sev_err}")

    # The trajectory (#8 per layer) and its gradient to the features (#9
    # per layer), against the plain layers.
    feats = torch.from_numpy(features(model, batches[0])).cuda()

    def trajectory(fused):
        set_kan_fused(kan, fused)
        x = feats.clone().requires_grad_()
        acts = kan.activation_trajectory(x)
        acts[-1].sum().backward()
        return [a.detach() for a in acts] + [x.grad]

    reset()
    traj = trajectory(True)
    torch.cuda.synchronize()
    traj_launches = read()
    if traj_launches != zeros(kan_layer_fwd=3, kan_layer_bwd=3):
        raise RuntimeError(f"trajectory launches {traj_launches}")
    traj_errs = hold_kan("trajectory", list(zip(
        ["features", "layer1", "layer2", "score", "d_features"], traj,
        trajectory(False))))
    set_kan_fused(kan, True)
    score_err = float(np.abs(traj[3][:, 0].cpu().numpy()
                             - served[0]["kan_severity"]).max())
    if not score_err <= 1e-5:
        raise RuntimeError(f"trajectory score differs from the served "
                           f"severity by {score_err}")

    # Training: five stage-4 steps between a reset and a read.
    train_model = build_model(cfg, device="cuda", seed=0)
    opt = build_optimizer(train_model, cfg)
    step = make_train_step(train_model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(0))
    tb = [train_batch(cfg, 200 + i) for i in range(5)]
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    losses = [float(step(b, 4, 1.0, 1)["total_loss"]) for b in tb]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    train_launches = read()
    s = len(tb)
    want = zeros(vit_block_fwd=12 * s, vit_block_bwd=12 * s, augment=s,
                 kan_module_fwd=s, kan_module_bwd=s)
    if train_launches != want:
        raise RuntimeError(f"train launches {train_launches}, want {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite train losses {losses}")
    # Flag on against off, like for like: the same steps of this step
    # object, on and off in turns (the host's speed drifts within a call).
    step_ms = {"kan_kernels": [], "plain_kan": []}
    for fused in (True, False, True, False):
        set_kan_fused(train_model.kan_module, fused)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in tb[2:]:
            step(b, 4, 1.0, 1)
        torch.cuda.synchronize()
        step_ms["kan_kernels" if fused else "plain_kan"].append(
            1e3 * (time.perf_counter() - t1) / len(tb[2:]))
    set_kan_fused(train_model.kan_module, True)
    prof_on = profile_step(lambda: step(tb[0], 4, 1.0, 1))
    set_kan_fused(train_model.kan_module, False)
    prof_off = profile_step(lambda: step(tb[0], 4, 1.0, 1))
    set_kan_fused(train_model.kan_module, True)

    held = hold_kan_step(cfg, tb[0], {
        "factors": ak.draw_factors(torch.Generator("cuda").manual_seed(3),
                                   BATCH),
        "mix": draw_mix(torch.Generator().manual_seed(4), BATCH, size,
                        size)})
    return {"phase": "kan", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16, KAN [192,64,16,1] through #10/#11",
            "batch_size": BATCH, "served_batches": n,
            "serve_launches": serve_launches,
            "serve_severity_vs_plain_head": sev_err,
            "device_ops_per_served_batch": {"kan_kernels": serve_ops_on,
                                            "plain_kan": serve_ops_off},
            "trajectory_launches": traj_launches,
            "trajectory": traj_errs,
            "trajectory_score_vs_served": score_err,
            "train_steps": s, "train_launches": train_launches,
            "train_losses": losses,
            "train_step_ms": 1e3 * elapsed / s,
            "step_ms_same_steps": step_ms,
            "device_ops_per_train_step": {
                "kan_kernels": prof_on["kernel_launches"],
                "plain_kan": prof_off["kernel_launches"]},
            "train_profile": {"kan_kernels": prof_on, "plain_kan": prof_off},
            "held_step": held, "card": smi}


LONG_BATCH, LONG_SIZE = 32, 384
LONG_TOKENS = (LONG_SIZE // 16) ** 2 + 1            # 577
SDPA = "F.scaled_dot_product_attention(q, k, v, scale=1.0)"


def attention_bounds(shape, dtype) -> dict:
    """Least times of #5 and #6 on the card: FLOP of their products (#5 two
    N x N x hd products, #6 five: S again, dV, dP, dQ, dK) over the rate of
    the route's arithmetic, and bytes (q, k, v in and an fp32 out; q, k, v
    and the fp32 g in and dq, dk, dv out in the input type) over the HBM
    rate. bf16 runs at the bf16 tensor peak. The fp32 route takes each
    product as three TF32 products (3xTF32), so its bound is three times
    the FLOP at the TF32 peak; the fp32 FMA bound (the FLOP at 67 TFLOP/s)
    is printed beside it as ``fma_bound_ms``."""
    B, h, N, hd = shape
    size = 2 if dtype == torch.bfloat16 else 4
    numel = B * h * N * hd
    out = {}
    for name, products, nbytes in (
            ("fwd", 2, numel * (3 * size + 4)),
            ("bwd", 5, numel * (6 * size + 4))):
        flops = 2 * products * B * h * N * N * hd
        seconds = (flops / PEAK_BF16_FLOPS if dtype == torch.bfloat16
                   else 3 * flops / PEAK_TF32_FLOPS)
        bound = {"operations": seconds, "bytes": nbytes / PEAK_BYTES_PER_S}
        by = max(bound, key=bound.get)
        out[name] = {"bound_ms": 1e3 * bound[by], "bound_by": by,
                     "flops": flops, "bytes": nbytes}
        if dtype == torch.float32:
            out[name]["fma_bound_ms"] = 1e3 * max(
                flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)
    return out


# The route of #5/#6 by dtype (csrc/attention.cu): design and device code.
ATTN_DESIGN = {torch.bfloat16: ("mma.sync two-pass, registers",
                                "attention_mma.cuh"),
               torch.float32: ("3xTF32 mma.sync two-pass, registers",
                               "attention_tf32.cuh")}


def top_kernels(ops: dict, n: int = 4) -> list:
    """The ``n`` device operations of a profile (``device_ops``) with the
    most time, as [name, ms per call]."""
    return [[k[:160], v] for k, v in
            sorted(ops.items(), key=lambda kv: -kv[1])[:n]]


def check_attention(shape, dtype, seed: int):
    """#5 and #6 against ``attention_reference`` and
    ``attention_backward_reference`` on seeded inputs (q pre-scaled), the
    same bits on a repeated call, and timed (CUDA events) beside their
    bounds, the plain versions and SDPA (forward, and forward + backward,
    the library yardstick; never on the port's path), and the kernels' and
    SDPA's forward device time from CUDA-graph replays; SDPA's forward +
    backward, its training forward and its backward alone (the difference)
    by CUDA-graph replay too, the port's #5 + #6 under autograd the same
    way, and the names and profiler device times of SDPA's device kernels
    (``profile_device``'s whole profiles). Tolerances: the
    forward's fp32 output within 1e-4 in fp32 and two bf16 ulps at its
    largest magnitude in bf16 (both round P at the same point; they differ
    where an fp32 sum in another order crosses a rounding boundary); the
    backward's outputs as #2's (``bwd_tol``)."""
    import torch.nn.functional as F
    from rovit_kan_tpu_torch.ops import attention as at
    rng = np.random.RandomState(seed)
    hd = shape[-1]

    def t(scale=1.0, dt=dtype):
        return torch.tensor(rng.normal(0, scale, shape), dtype=torch.float32,
                            device="cuda").to(dt)

    q, k, v = t(hd ** -0.5), t(), t()
    g = t(dt=torch.float32)
    with torch.no_grad():
        out = at._launch(q, k, v)
        grads = at._launch_bwd(q, k, v, g)
        ref = at.attention_reference(q, k, v)
        want = at.attention_backward_reference(q, k, v, g)
        torch.cuda.synchronize()
        same = (torch.equal(at._launch(q, k, v), out)
                and all(torch.equal(a, b) for a, b in
                        zip(at._launch_bwd(q, k, v, g), grads)))
    what = f"attention {list(shape)} {dtype}"
    if not same:
        raise RuntimeError(f"{what}: a repeated call gave other bits")
    errs, failed = {}, []
    for name, got, w in [("out", out, ref)] + list(zip(("dq", "dk", "dv"),
                                                       grads, want)):
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{what} {name}: non-finite values")
        if got.dtype != (torch.float32 if name == "out" else dtype):
            raise RuntimeError(f"{what} {name}: dtype {got.dtype}")
        err = float((got.float() - w.float()).abs().max())
        tol = (bwd_tol(w, dtype) if name != "out" else
               FP32_TOL if dtype == torch.float32 else bf16_tol(w))
        errs[name] = {"max_abs_err": err, "tolerance": tol}
        if not err <= tol:
            failed.append(name)
    if failed:
        raise RuntimeError(f"{what} out of tolerance: "
                           f"{ {k: errs[k] for k in failed} }")

    with torch.no_grad():
        ms_f = time_ms(lambda: at._launch(q, k, v))
        ms_b = time_ms(lambda: at._launch_bwd(q, k, v, g))
        plain_f = time_ms(lambda: at.attention_reference(q, k, v), reps=9,
                          inner=3)
        plain_b = time_ms(lambda: at.attention_backward_reference(
            q, k, v, g), reps=9, inner=3)
        sdpa_f = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0))
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    gx = g.to(dtype)

    def sdpa_fwd():
        for x in leaves:
            x.grad = None
        return F.scaled_dot_product_attention(*leaves, scale=1.0)

    def sdpa_fwd_bwd():
        sdpa_fwd().backward(gx)

    def port_fwd():
        for x in leaves:
            x.grad = None
        return at.fused_attention(*leaves)

    def port_fwd_bwd():
        port_fwd().backward(g)

    sdpa_fb = time_ms(sdpa_fwd_bwd, reps=9)
    port_fb = time_ms(port_fwd_bwd, reps=9)
    sdpa_device = split_device_ms(sdpa_fwd, sdpa_fwd_bwd, graph=True)
    port_device = split_device_ms(port_fwd, port_fwd_bwd, graph=True)
    sdpa_ops = device_ops(sdpa_fwd_bwd, calls=5)
    with torch.no_grad():
        sdpa_fwd_ops = device_ops(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0), calls=5)
    # Device time beside the event times (once a call's host work exceeds
    # its kernel's device time, events time the host): replays of a CUDA
    # graph of the wrapper calls (the backward's includes the wrapper's cast
    # of g).
    with torch.no_grad():
        graph_f = graph_ms(lambda: at._launch(q, k, v))
        graph_b = graph_ms(lambda: at._launch_bwd(q, k, v, g))
        sdpa_graph_f = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=1.0))
    bounds = attention_bounds(shape, dtype)
    common = {"dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
              "design": ATTN_DESIGN[dtype][0],
              "device_source": "rovit_kan_tpu_torch/csrc/"
                               + ATTN_DESIGN[dtype][1],
              "identical_bits_on_repeat": True,
              "kernel_ms_source": "CUDA events around 10 back-to-back calls",
              "kernel_graph_ms_source": "CUDA events around replays of a "
                                        "CUDA graph of 20 calls, per call"}
    fwd = {"replaces": "rovit_kan_tpu/ops/attention.py::_attention_kernel",
           **common, "outputs": {"out": errs["out"]},
           "max_abs_err": errs["out"]["max_abs_err"], "kernel_ms": ms_f,
           "kernel_graph_ms": graph_f, "plain_ms": plain_f,
           "library_ms": sdpa_f, "library_graph_ms": sdpa_graph_f,
           "library": SDPA, "library_kernels": top_kernels(sdpa_fwd_ops),
           **bounds["fwd"]}
    bwd = {"replaces": "rovit_kan_tpu/ops/attention.py::"
                       "_attention_bwd_kernel",
           **common, "outputs": {k: errs[k] for k in ("dq", "dk", "dv")},
           "max_abs_err": max(errs[k]["max_abs_err"]
                              for k in ("dq", "dk", "dv")),
           "kernel_ms": ms_b, "kernel_graph_ms": graph_b, "plain_ms": plain_b,
           "library_ms": sdpa_fb, "library": SDPA + " forward + backward",
           "library_device_ms_source": "CUDA events around replays of a "
                                       "CUDA graph of 10 calls, per call; "
                                       "bwd = fwd_bwd - fwd",
           "library_device_ms": sdpa_device["fwd_bwd"],
           "library_fwd_device_ms": sdpa_device["fwd"],
           "library_bwd_device_ms": sdpa_device["bwd"],
           "library_kernels": top_kernels(sdpa_ops),
           "port_fwd_bwd_ms": port_fb,
           "port_fwd_bwd_device_ms": port_device["fwd_bwd"],
           "port_bwd_device_ms": port_device["bwd"], **bounds["bwd"]}
    return fwd, bwd


def long_model(cfg, inference: bool, dtype=None):
    """The flagship built at ``cfg.data.image_size`` (in ``dtype``, by
    default the config's) with the seed-0 224-px weights carried over by
    ``transfer_resolution`` (the resolution-transfer recipe: the position
    embedding resampled, every other weight as it is)."""
    import copy

    from rovit_kan_tpu_torch.models.convert import transfer_resolution
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    base = copy.deepcopy(cfg)
    base.data.image_size = 224
    src = build_model(base, dtype=torch.float32, inference=True,
                      device="cpu", seed=0)
    model = build_model(cfg, dtype=dtype, inference=inference, device="cuda",
                        seed=1)
    model.load_state_dict(transfer_resolution(
        src.state_dict(), cfg.data.image_size, cfg.model.patch_size))
    return model


def long_config(mixed_precision: bool = True, **tpu):
    from rovit_kan_tpu_torch.config import Config
    cfg = Config()
    cfg.data.image_size = LONG_SIZE
    cfg.flags.mixed_precision = mixed_precision
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    return cfg


def long_counters():
    from rovit_kan_tpu_torch.ops import attention as at
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk

    def reset():
        bk.LAUNCHES = bk.BWD_LAUNCHES = ak.LAUNCHES = 0
        at.LAUNCHES = at.BWD_LAUNCHES = 0

    def read():
        return {"vit_block_fwd": bk.LAUNCHES, "vit_block_bwd": bk.BWD_LAUNCHES,
                "augment": ak.LAUNCHES, "attention_fwd": at.LAUNCHES,
                "attention_bwd": at.BWD_LAUNCHES}

    return reset, read


def long_serve(smi: str, label: str, **tpu):
    """The 384-px flagship served through ``InferenceEngine`` (3 batches of
    32) between a counter reset and a read, held against the same model
    through the plain versions and the fp32 model (``hold_served``)."""
    from rovit_kan_tpu_torch.ops import attention as at
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.serving import InferenceEngine
    reset, read = long_counters()
    cfg = long_config(**tpu)
    model = long_model(cfg, inference=True)
    blocks = model.backbone.model.blocks
    engine = InferenceEngine(model, batch_size=LONG_BATCH, device="cuda")
    engine.warmup()
    rng = np.random.RandomState(11)
    batches = [rng.randint(0, 256, (LONG_BATCH, LONG_SIZE, LONG_SIZE, 3))
               .astype(np.uint8) for _ in range(3)]
    torch.cuda.synchronize()
    reset()
    outs = [engine.predict(b) for b in batches]
    launches = read()
    for out in outs:
        for k, v in out.items():
            if v.shape[0] != LONG_BATCH or not np.isfinite(v).all():
                raise RuntimeError(f"{label} {k}: shape {v.shape} or "
                                   f"non-finite")
    served = dict(outs[0], features=features(model, batches[0]))
    for b in blocks:
        b.block_fn, b.attn.attn_fn = bk.plain_vit_block, at.plain_attention
    plain = engine.predict(batches[0])
    plain["features"] = features(model, batches[0])
    for b in blocks:
        b.block_fn, b.attn.attn_fn = bk.fused_vit_block, at.fused_attention
    # The fp32 model: the unfused fp32 path under "auto" on these weights.
    model32 = long_model(cfg, inference=True, dtype=torch.float32)
    exact = InferenceEngine(model32, batch_size=LONG_BATCH,
                            device="cuda").predict(batches[0])
    exact["features"] = features(model32, batches[0])
    checks, failed = hold_served(served, plain, exact)
    if failed:
        emit({"phase": "long", "serve": label, "outputs": checks})
        raise RuntimeError(f"{label}: served outputs out of tolerance: "
                           f"{failed}")
    prof = profile_serving(engine, np.concatenate(batches), smi)
    return {"tpu": tpu, "batches": len(batches), "launches": launches,
            "block_path": all(b.use_fused_block for b in blocks),
            "attention_path": all(b.attn.use_fused and not b.use_fused_block
                                  for b in blocks),
            "outputs": checks, "images_per_sec":
                engine.stats()["images_per_sec"], "profile": prof}


@functools.lru_cache(maxsize=None)
def _plain_backward_attention():
    from rovit_kan_tpu_torch.ops import attention as at

    class PlainBackward(at.FusedAttention):
        @staticmethod
        def backward(ctx, g):
            ctx.plain = True
            return at.FusedAttention.backward(ctx, g)

    return PlainBackward


def _kernel_fwd_plain_bwd_attention(q, k, v):
    """An ``attn_fn``: #5 in the forward, #6's plain version in the
    backward."""
    return _plain_backward_attention().apply(q, k, v, False)


def long_step(cfg, batch, draws, attn_fn=None):
    """One stage-4 step of the 384-px flagship from the transferred weights
    with fixed draws; ``attn_fn`` replaces every block's attention core.
    Returns the loss and every parameter's gradient."""
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    model = long_model(cfg, inference=False)
    if attn_fn is not None:
        for b in model.backbone.model.blocks:
            b.attn.attn_fn = attn_fn
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(1))
    m = step(batch, 4, 1.0, 1, draws=dict(
        draws, dropout=torch.Generator("cuda").manual_seed(2)))
    return {"loss": float(m["total_loss"]),
            "grads": {k: p.grad.detach().clone()
                      for k, p in zip(opt.names, opt.params)}}


def long_train(smi: str, label: str, steps: int, want_per_step: dict,
               **tpu):
    """``steps`` stage-4 steps (mixing on) of the 384-px flagship between a
    counter reset and a read, which must show ``want_per_step`` per step;
    finite losses; one profiled step."""
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    reset, read = long_counters()
    cfg = long_config(**tpu)
    model = long_model(cfg, inference=False)
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(0))
    batches = [train_batch(cfg, 300 + i, LONG_BATCH) for i in range(steps)]
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    losses = [float(step(b, 4, 1.0, 1)["total_loss"]) for b in batches]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read()
    want = {k: want_per_step.get(k, 0) * steps for k in launches}
    if launches != want:
        raise RuntimeError(f"{label} train launches {launches}, want {want}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{label}: non-finite train losses {losses}")
    return {"tpu": tpu, "steps": steps, "launches": launches,
            "losses": losses, "step_ms": 1e3 * elapsed / steps,
            "profile": profile_step(lambda: step(batches[0], 4, 1.0, 1)),
            "card": smi}


def hold_attention_step(cfg, batch, draws):
    """One stage-4 step through #5 and #6 against the same step with #6's
    plain version (same weights, draws and dropout masks; the forwards are
    the same launches, so the losses agree to the bit): each parameter's
    gradient within 5e-2 of its L2 norm, hold_train_step's limit for #2."""
    k = long_step(cfg, batch, draws)
    p = long_step(cfg, batch, draws, _kernel_fwd_plain_bwd_attention)
    leaf = {n: float((g - p["grads"][n]).norm())
            / max(float(p["grads"][n].norm()), 1e-30)
            for n, g in k["grads"].items()}
    worst = max(leaf, key=leaf.get)
    held = {"loss_kernels": k["loss"], "loss_plain_bwd": p["loss"],
            "tolerance": 5e-2, "worst_leaf": worst,
            "worst_rel": leaf[worst],
            "median_leaf_rel": float(np.median(list(leaf.values())))}
    if k["loss"] != p["loss"] or not leaf[worst] <= 5e-2:
        emit({"phase": "long", "held_step": held})
        raise RuntimeError("attention train step out of tolerance")
    return held


def rel_err(got, want) -> float:
    """Largest absolute difference over the largest magnitude of ``want``."""
    got, want = (torch.as_tensor(x).double() for x in (got, want))
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def long_fp32_arm(smi: str):
    """The attention-only path in fp32 (``flags.mixed_precision=False``,
    ``use_pallas_attention=True``, block off) at 384 px, batch 32, weights
    through ``transfer_resolution``: one served batch (12 x #5) and one
    stage-4 train step (12 x #5, 12 x #6; the augment is plain PyTorch, as
    the trainer takes #7 only under mixed precision), each between a counter
    reset and a read, held against the same batch and step through
    ``plain_attention``: every served output and the loss within 1e-4 of
    its largest magnitude, the flat gradient within 1e-3 in L2 (3xTF32
    products, about 2^-21 relative each, against fp32's)."""
    from rovit_kan_tpu_torch.ops import attention as at
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    from rovit_kan_tpu_torch.serving import InferenceEngine
    reset, read = long_counters()
    cfg = long_config(mixed_precision=False, use_pallas_block=False,
                      use_pallas_attention=True)
    model = long_model(cfg, inference=True)
    blocks = model.backbone.model.blocks
    if not all(b.attn.use_fused and not b.use_fused_block
               and b.attn.dtype == torch.float32 for b in blocks):
        raise RuntimeError("fp32 arm: the blocks are not on the fp32 "
                           "attention-only path")
    engine = InferenceEngine(model, batch_size=LONG_BATCH, device="cuda")
    engine.warmup()
    images = np.random.RandomState(12).randint(
        0, 256, (LONG_BATCH, LONG_SIZE, LONG_SIZE, 3)).astype(np.uint8)
    torch.cuda.synchronize()
    reset()
    served = engine.predict(images)
    torch.cuda.synchronize()
    serve_launches = read()
    for b in blocks:
        b.attn.attn_fn = at.plain_attention
    plain = engine.predict(images)
    outputs = {k: rel_err(v, plain[k]) for k, v in served.items()}

    batch = train_batch(cfg, 410, LONG_BATCH)
    draws = {"factors": ak.draw_factors(
                 torch.Generator("cuda").manual_seed(7), LONG_BATCH),
             "mix": draw_mix(torch.Generator().manual_seed(8), LONG_BATCH,
                             LONG_SIZE, LONG_SIZE)}
    torch.cuda.synchronize()
    reset()
    k = long_step(cfg, batch, draws)
    torch.cuda.synchronize()
    step_launches = read()
    p = long_step(cfg, batch, draws, at.plain_attention)
    flat_k, flat_p = (torch.cat([g.flatten() for g in r["grads"].values()])
                      for r in (k, p))
    held = {"served_rel_err": outputs, "loss_kernels": k["loss"],
            "loss_plain": p["loss"],
            "loss_rel_err": abs(k["loss"] - p["loss"]) / abs(p["loss"]),
            "grad_rel_l2": float((flat_k - flat_p).norm())
            / float(flat_p.norm()),
            "tolerances": {"served": 1e-4, "loss": 1e-4, "grad_l2": 1e-3}}
    want_serve = {"attention_fwd": 12}
    want_step = {"attention_fwd": 12, "attention_bwd": 12}
    launches = {"serve": serve_launches, "train": step_launches}
    for got, want in ((serve_launches, want_serve),
                      (step_launches, want_step)):
        if got != {n: want.get(n, 0) for n in got}:
            raise RuntimeError(f"fp32 arm launches {launches}")
    if not (all(e <= 1e-4 for e in outputs.values())
            and np.isfinite(k["loss"]) and held["loss_rel_err"] <= 1e-4
            and held["grad_rel_l2"] <= 1e-3):
        emit({"phase": "long", "fp32_attention_arm": held})
        raise RuntimeError("fp32 attention arm out of tolerance")
    return {"tpu": {"use_pallas_block": False,
                    "use_pallas_attention": True},
            "mixed_precision": False, "launches": launches, "held": held,
            "card": smi}


def long_phase(smi: str):
    """The 384-px (577-token) flagship, batch 32, with the seed-0 224-px
    weights carried over: #5/#6 and #1/#2 at the long path's shapes against
    their plain versions, served and trained through the block kernels
    ("auto") and through the attention-only kernels."""
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    attention = {}
    for seed, (shape, dtype) in enumerate(
            (((LONG_BATCH, HEADS, LONG_TOKENS, DIM // HEADS), torch.bfloat16),
             ((LONG_BATCH, HEADS, LONG_TOKENS, DIM // HEADS), torch.float32),
             ((BATCH, HEADS, TOKENS, DIM // HEADS), torch.bfloat16),
             ((BATCH, HEADS, TOKENS, DIM // HEADS), torch.float32))):
        attention[shape[2], dtype] = check_attention(shape, dtype, 20 + seed)
    blocks577 = {dtype: (check_block(dtype, 30 + i, LONG_BATCH, LONG_TOKENS),
                         check_block_bwd(dtype, 32 + i, LONG_BATCH,
                                         LONG_TOKENS))
                 for i, dtype in enumerate((torch.bfloat16, torch.float32))}

    serve_auto = long_serve(smi, "serve auto")
    serve_attn = long_serve(smi, "serve attention", use_pallas_block=False)
    for got, want in ((serve_auto, {"vit_block_fwd": 12}),
                      (serve_attn, {"attention_fwd": 12})):
        per_batch = {k: v / got["batches"] for k, v in got["launches"].items()}
        if per_batch != {k: want.get(k, 0) for k in per_batch}:
            raise RuntimeError(f"long serve launches {got['launches']} for "
                               f"{got['batches']} batches, want {want} each")

    train_attn = long_train(smi, "attention", 3, {
        "attention_fwd": 12, "attention_bwd": 12, "augment": 1},
        use_pallas_block=False, use_pallas_attention=True)
    train_auto = long_train(smi, "auto", 2, {
        "vit_block_fwd": 12, "vit_block_bwd": 12, "augment": 1})
    cfg = long_config(use_pallas_block=False, use_pallas_attention=True)
    held = hold_attention_step(cfg, train_batch(cfg, 400, LONG_BATCH), {
        "factors": ak.draw_factors(torch.Generator("cuda").manual_seed(5),
                                   LONG_BATCH),
        "mix": draw_mix(torch.Generator().manual_seed(6), LONG_BATCH,
                        LONG_SIZE, LONG_SIZE)})
    fp32_arm = long_fp32_arm(smi)
    return {"phase": "long", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 384px (577 tokens) bf16, seed-0 224-px weights through "
            "transfer_resolution", "batch_size": LONG_BATCH,
            "attention_kernels": {f"{n}_{str(d).replace('torch.', '')}": r
                                  for (n, d), r in attention.items()},
            "block_kernels_577": {str(d).replace("torch.", ""): r
                                  for d, r in blocks577.items()},
            "serve_auto": serve_auto, "serve_attention": serve_attn,
            "train_attention": train_attn, "train_auto": train_auto,
            "held_attention_step": held, "fp32_attention_arm": fp32_arm,
            "card": smi}, attention, blocks577


RES_ENV = "ROVIT_BLOCK_RESIDUAL_BWD"


@contextlib.contextmanager
def residual_opt_in(on: bool):
    """``ROVIT_BLOCK_RESIDUAL_BWD`` set to 1 (or 0) inside the block."""
    old = os.environ.get(RES_ENV)
    os.environ[RES_ENV] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(RES_ENV, None)
        else:
            os.environ[RES_ENV] = old


def res_bounds(x, params, dtype) -> dict:
    """Least times of #3 and #4. #3: #1's FLOP; its bytes x, out, the
    returned qkv, attention output and a1 (8D per row in the compute type)
    and the weights. #4: two products per forward product, the proj
    recompute and one S rebuild; its bytes x, the fp32 g, dx, the three
    residuals, the weights and the fp32 grads."""
    B, N, D = x.shape
    M, hd = B * N, D // HEADS
    size = x.element_size()
    fwd = 2 * M * D * (4 * D + 2 * HIDDEN) + 4 * B * HEADS * N * N * hd
    bwd = 2 * fwd + 2 * M * D * D + 2 * B * HEADS * N * N * hd
    wbytes = sum(p.numel() * p.element_size() for p in params.values())
    wcount = sum(p.numel() for p in params.values())
    res = M * (4 * D + HIDDEN) * size
    out = {}
    for name, flops, nbytes in (
            ("fwd", fwd, 2 * x.numel() * size + res + wbytes),
            ("bwd", bwd, 2 * x.numel() * size + 4 * x.numel() + res + wbytes
             + 4 * wcount)):
        # fp32 #3 runs 3xTF32 (the FMA bound beside it); fp32 #4 runs FMA.
        fma = name == "bwd"
        bound = {"operations": op_seconds(flops, dtype, fma),
                 "bytes": nbytes / PEAK_BYTES_PER_S}
        by = max(bound, key=bound.get)
        out[name] = {"bound_ms": 1e3 * bound[by], "bound_by": by,
                     "flops": flops, "bytes": nbytes}
        if dtype == torch.float32 and not fma:
            out[name]["fma_bound_ms"] = 1e3 * max(
                op_seconds(flops, dtype, True), nbytes / PEAK_BYTES_PER_S)
    return out


def check_block_res(dtype, seed: int, batch: int = BATCH,
                    tokens: int = TOKENS):
    """#3 against ``block_residual_reference`` (its output also against
    #1's, bit for bit; qkv, attn and a1 within the forward's tolerance) and
    #4 against ``block_backward_residual_reference`` on #3's residuals (each
    output within ``bwd_tol``; the same bits on a repeated call); timed
    beside their bounds, the plain versions and ``TransformerEncoderLayer``
    (forward, and forward + backward, also by profiler device time); #4 also
    by CUDA-graph replay and by stage (``bwd_stages``); one block's forward +
    backward through the port with the opt-in on (#3 + #4) and off (#1 +
    #2), in turns, by events and by profiler device time."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    x, params = block_inputs(dtype, seed, batch, tokens)
    g = torch.tensor(np.random.RandomState(seed + 10).normal(
        0, 1, x.shape), dtype=torch.float32, device="cuda")
    what = f"residual pair {list(x.shape)} {dtype}"
    with torch.no_grad():
        got = bk._launch_res(x, params, HEADS)
        out1 = bk._launch(x, params, HEADS)
        want = bk.block_residual_reference(x, params, HEADS)
        got_again = bk._launch_res(x, params, HEADS)
        res = got[1:]
        dx, grads = bk._launch_bwd_res(x, g, *res, params, HEADS)
        want_dx, want_g = bk.block_backward_residual_reference(
            x, g, *res, params, HEADS)
        again = bk._launch_bwd_res(x, g, *res, params, HEADS)
        torch.cuda.synchronize()
    if not torch.equal(got[0], out1):
        raise RuntimeError(f"{what}: #3's output is not #1's bits")
    if not all(torch.equal(a, b) for a, b in zip(got_again, got)):
        raise RuntimeError(f"{what}: a repeated #3 call gave other bits")
    if not (torch.equal(again[0], dx) and all(
            torch.equal(again[1][k], grads[k]) for k in bk.PKEYS)):
        raise RuntimeError(f"{what}: a repeated #4 call gave other bits")
    errs, failed = {}, []
    pairs = ([(n, a, b, "fwd") for n, a, b in
              zip(("out", "qkv", "attn", "a1"), got, want)]
             + [("dx", dx, want_dx, "bwd")]
             + [(k, grads[k], want_g[k], "bwd") for k in bk.PKEYS])
    for name, a, b, side in pairs:
        if not torch.isfinite(a.float()).all():
            raise RuntimeError(f"{what} {name}: non-finite values")
        err = float((a.float() - b.float()).abs().max())
        tol = (bwd_tol(b, dtype) if side == "bwd" else
               bf16_tol(b) if dtype == torch.bfloat16 else FP32_TOL)
        errs[name] = {"max_abs_err": err, "tolerance": tol}
        if not err <= tol:
            failed.append(name)
    if failed:
        raise RuntimeError(f"{what} out of tolerance: "
                           f"{ {k: errs[k] for k in failed} }")

    with torch.no_grad():
        ms3 = time_ms(lambda: bk._launch_res(x, params, HEADS))
        ms4 = time_ms(lambda: bk._launch_bwd_res(x, g, *res, params, HEADS),
                      reps=9)
        graph4 = graph_ms(lambda: bk._launch_bwd_res(x, g, *res, params,
                                                     HEADS), calls=5)
        stages4 = bwd_stages(lambda: bk._launch_bwd_res(x, g, *res, params,
                                                        HEADS),
                             dtype, recompute=False)
        plain3 = time_ms(lambda: bk.block_residual_reference(
            x, params, HEADS), reps=9, inner=3)
        plain4 = time_ms(lambda: bk.block_backward_residual_reference(
            x, g, *res, params, HEADS), reps=5, inner=3)
        graph3 = graph_ms(lambda: bk._launch_res(x, params, HEADS))
        no_replaced_fwd(device_ops(lambda: bk._launch_res(x, params, HEADS)),
                        what)
        layer = library_layer(params, dtype)
        lib3 = time_ms(lambda: layer(x))
        lib3_graph = graph_ms(lambda: layer(x))
    raw = {k: v.float().detach().clone().requires_grad_()
           for k, v in params.items()}
    xg = x.detach().clone().requires_grad_()
    gx = g.to(dtype)

    def port_fwd_bwd():
        bk.fused_vit_block(xg, raw, HEADS, kernel_params=params).backward(gx)

    layer.train()

    def library_fwd_bwd():
        layer(xg).backward(gx)

    lib4 = time_ms(library_fwd_bwd, reps=9)
    lib4_split = layer_bwd_device_ms(layer, xg, gx)
    lib4_device = lib4_split["fwd_bwd"]
    pair_ms = {"residual": [], "recompute": []}
    pair_device = {"residual": [], "recompute": []}
    for on in (True, False, True, False):
        with residual_opt_in(on):
            arm = "residual" if on else "recompute"
            pair_ms[arm].append(time_ms(port_fwd_bwd, reps=9))
            pair_device[arm].append(device_ms(port_fwd_bwd, calls=10))
    bounds = res_bounds(x, params, dtype)
    common = {"dtype": str(dtype).replace("torch.", ""),
              "shape": list(x.shape), "heads": HEADS,
              "launches_per_step": "12 with the opt-in (counted in 'fit')"}
    fwd = {"replaces": "rovit_kan_tpu/ops/block_kernel.py::"
                       "_vit_block_res_kernel", **common,
           "outputs": {k: errs[k] for k in ("out", "qkv", "attn", "a1")},
           "out_bits_equal_to_vit_block_fwd": True,
           "identical_bits_on_repeat": True,
           "max_abs_err": max(errs[k]["max_abs_err"]
                              for k in ("out", "qkv", "attn", "a1")),
           "kernel_ms": ms3, "kernel_graph_ms": graph3, "plain_ms": plain3,
           "library_ms": lib3, "library_graph_ms": lib3_graph,
           "library": "nn.TransformerEncoderLayer forward",
           **bounds["fwd"]}
    bwd = {"replaces": "rovit_kan_tpu/ops/block_kernel.py::"
                       "_vit_block_bwd_res_kernel", **common,
           "outputs": {k: errs[k] for k in ("dx",) + bk.PKEYS},
           "identical_bits_on_repeat": True,
           "max_abs_err": max(errs[k]["max_abs_err"]
                              for k in ("dx",) + bk.PKEYS),
           "kernel_ms": ms4, "kernel_graph_ms": graph4,
           "stages_device_ms": stages4,
           "stages_bound_ms": bwd_stage_bounds_ms(x, dtype, False),
           "plain_ms": plain4,
           "library_ms": lib4, "library_device_ms": lib4_device,
           "library_bwd_device_ms": lib4_split["bwd"],
           "library_fwd_train_device_ms": lib4_split["fwd"],
           "library": "nn.TransformerEncoderLayer forward + backward",
           "port_fwd_bwd_ms": pair_ms, "port_fwd_bwd_device_ms": pair_device,
           **bounds["bwd"]}
    return fwd, bwd


def hold_residual_step(cfg, batch, draws):
    """One stage-4 flagship step with the opt-in (#3, #4, #7) against the
    same step through #1/#2 and against the same step with #4's plain
    version (same weights, draws and dropout masks). #3's output has #1's
    bits, so the three losses must be the same bits; each parameter's
    gradient within 5e-2 of its L2 norm of the other step's (the limit
    ``hold_train_step`` sets for a bf16 block backward; against #2, a1 is
    rounded to bf16 before GELU and GELU')."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    with residual_opt_in(True):
        bk.RES_LAUNCHES = bk.BWD_RES_LAUNCHES = 0
        k = one_step(cfg, "kernels", batch, draws, 4)
        launches = (bk.RES_LAUNCHES, bk.BWD_RES_LAUNCHES)
        p = one_step(cfg, "kernel_fwd", batch, draws, 4)
    with residual_opt_in(False):
        r = one_step(cfg, "kernels", batch, draws, 4)
    if launches != (12, 12):
        raise RuntimeError(f"residual step launched {launches} of #3/#4")
    held = {"loss_residual": k["loss"], "loss_recompute": r["loss"],
            "loss_plain_bwd": p["loss"], "tolerance": 5e-2}
    failed = []
    for name, ref in (("vs_recompute", r), ("vs_plain_bwd", p)):
        leaf = {n: float((g - ref["grads"][n]).norm())
                / max(float(ref["grads"][n].norm()), 1e-30)
                for n, g in k["grads"].items()}
        worst = max(leaf, key=leaf.get)
        held[name] = {"worst_leaf": worst, "worst_rel": leaf[worst],
                      "median_leaf_rel": float(np.median(list(
                          leaf.values()))),
                      "all": grad_gaps(k, ref)["all"]}
        if not leaf[worst] <= 5e-2:
            failed.append(name)
    if not k["loss"] == r["loss"] == p["loss"]:
        failed.append("loss bits")
    if failed:
        emit({"phase": "fit", "held_step": held})
        raise RuntimeError(f"residual train step out of tolerance: {failed}")
    return held


FIT_PER_CLASS = 100


class LeafSet:
    """An in-memory synthetic rose-leaf set: ``per_class`` images of each of
    the four classes from ``make_leaf_image`` (numpy only), severity the
    class index, as the JAX package's severity map gives it."""

    def __init__(self, per_class: int, size: int, seed: int):
        from rovit_kan_tpu_torch.data.synthetic import make_leaf_image
        rng = np.random.RandomState(seed)
        self.labels = np.repeat(np.arange(4), per_class)
        self.images = np.stack([make_leaf_image(int(c), rng, size)
                                for c in self.labels])

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.images[i], int(self.labels[i]), float(self.labels[i])


def fit_counters():
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk

    def reset():
        bk.LAUNCHES = bk.BWD_LAUNCHES = ak.LAUNCHES = 0
        bk.RES_LAUNCHES = bk.BWD_RES_LAUNCHES = 0

    def read():
        return {"vit_block_fwd": bk.LAUNCHES, "vit_block_bwd": bk.BWD_LAUNCHES,
                "vit_block_res_fwd": bk.RES_LAUNCHES,
                "vit_block_bwd_res": bk.BWD_RES_LAUNCHES,
                "augment": ak.LAUNCHES}

    return reset, read


def fit_config(root):
    """The flagship ``Config()`` (224 px, d=192, 12 blocks, bf16, batch 64)
    for four epochs across curriculum stages 1-4, the backbone frozen in
    epoch 1."""
    from rovit_kan_tpu_torch.config import Config
    cfg = Config()
    cfg.train.batch_size = BATCH
    cfg.train.epochs = 4
    cfg.train.stage_1_epochs, cfg.train.stage_2_epochs = 1, 2
    cfg.train.stage_3_epochs = 3
    cfg.flags.freeze_backbone_epochs = 1
    cfg.paths.checkpoints_dir = root / "ckpt"
    return cfg


def run_fit(cfg, loaders, residual: bool, logger=None, resume=False):
    """``Trainer.fit`` between a counter reset and a read, with the opt-in
    on or off; ``resume`` continues from best_model for one more epoch.
    Returns the trainer, fit's result and the launches, with the launches
    each train step and validation batch should have made."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.trainer import Trainer
    reset, read = fit_counters()
    train, val = loaders
    tr = Trainer(build_model(cfg, device="cuda", seed=1), train, val, cfg,
                 logger=logger, seed=0)
    if not all(b.use_fused_block for b in tr.model.backbone.model.blocks):
        raise RuntimeError("the 'auto' policy did not pick the block kernel")
    args = {}
    if resume:
        state, nxt = tr.resume()
        cfg.train.epochs = nxt
        if logger is not None:
            logger.truncate_from(nxt)
        args = {"state": state, "start_epoch": nxt}
    else:
        train.set_epoch(0)
    torch.cuda.synchronize()
    with residual_opt_in(residual):
        reset()
        res = tr.fit(**args)
        torch.cuda.synchronize()
        launches = read()
    epochs = len(res["history"]["train"])
    steps, vals = epochs * len(train), epochs * len(val)
    want = {"vit_block_fwd": 12 * vals, "vit_block_bwd": 0,
            "vit_block_res_fwd": 0, "vit_block_bwd_res": 0,
            "augment": steps}
    if residual:
        want.update(vit_block_res_fwd=12 * steps, vit_block_bwd_res=12 * steps)
    else:
        want.update(vit_block_fwd=12 * (steps + vals),
                    vit_block_bwd=12 * steps)
    if launches != want:
        raise RuntimeError(f"fit (opt-in {residual}) launches {launches}, "
                           f"want {want}")
    for part in ("train", "val"):
        for m in res["history"][part]:
            if not np.isfinite(m["total_loss"]):
                raise RuntimeError(f"fit: non-finite {part} loss {m}")
    return tr, res, launches


def fit_phase(smi: str):
    """The saved-residual pair's kernels, a train step held through it, and
    ``Trainer.fit`` with its data, checkpoints and logger (module
    docstring, phase 8)."""
    from pathlib import Path

    from rovit_kan_tpu_torch.data.dataset import Subset
    from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    from rovit_kan_tpu_torch.results.logger import CSV_COLUMNS, \
        ExperimentLogger
    from rovit_kan_tpu_torch.serving import InferenceEngine, load_engine
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from rovit_kan_tpu_torch.utils.checkpoint import is_finalized

    kernels = {}
    for seed, (batch, tokens, dtype) in enumerate(
            ((BATCH, TOKENS, torch.bfloat16), (BATCH, TOKENS, torch.float32),
             (LONG_BATCH, LONG_TOKENS, torch.bfloat16),
             (LONG_BATCH, LONG_TOKENS, torch.float32))):
        kernels[tokens, dtype] = check_block_res(dtype, 40 + seed, batch,
                                                 tokens)

    cfg = fit_config(Path("."))
    held = hold_residual_step(cfg, train_batch(cfg, 500), {
        "factors": ak.draw_factors(torch.Generator("cuda").manual_seed(7),
                                   BATCH),
        "mix": draw_mix(torch.Generator().manual_seed(8), BATCH,
                        cfg.data.image_size, cfg.data.image_size)})

    t0 = time.perf_counter()
    ds = LeafSet(FIT_PER_CLASS, cfg.data.image_size, seed=0)
    order = np.random.RandomState(42).permutation(len(ds))
    n_train = int(round(len(ds) * cfg.data.train_val_split))
    loaders = (DeviceLoader(Subset(ds, order[:n_train]), BATCH, shuffle=True,
                            drop_last=True, seed=42, device="cuda"),
               DeviceLoader(Subset(ds, order[n_train:]), BATCH,
                            device="cuda"))
    data_s = time.perf_counter() - t0
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    try:
        # The main path: fit with the opt-in, resume, serve.
        cfg = fit_config(root / "residual")
        logger = ExperimentLogger(root / "residual" / "logs", "fit")
        tr, res, launches = run_fit(cfg, loaders, True, logger)
        with open(logger.csv_path) as f:
            header, *rows = [ln.strip().split(",") for ln in f]
        best = cfg.paths.checkpoints_dir / "best_model"
        if header != CSV_COLUMNS or len(rows) != 4 or not is_finalized(best):
            raise RuntimeError(f"fit wrote {len(rows)} CSV rows under "
                               f"{header}; best_model finalized: "
                               f"{is_finalized(best)}")
        tr2, res2, resume_launches = run_fit(cfg, loaders, True, logger,
                                             resume=True)
        reset, read = fit_counters()
        engine = load_engine(best, batch_size=BATCH, device="cuda")
        images = ds.images[order[n_train:]]
        reset()
        served = [engine.predict(images[i * BATCH:(i + 1) * BATCH])
                  for i in range(2)]
        serve_launches = read()
        if serve_launches["vit_block_fwd"] != 24 or sum(
                serve_launches.values()) != 24:
            raise RuntimeError(f"load_engine served with {serve_launches}")
        ref_model = build_model(cfg, inference=True, device="cuda", seed=2)
        ref_model.load_state_dict(Trainer.eval_params(res2["best_state"]))
        ref = InferenceEngine(ref_model, batch_size=BATCH, device="cuda")
        expect = [ref.predict(images[i * BATCH:(i + 1) * BATCH])
                  for i in range(2)]
        differ = sorted({k for a, b in zip(served, expect) for k in a
                         if not np.array_equal(a[k], b[k])})
        if differ:
            raise RuntimeError(f"load_engine outputs {differ} differ from "
                               f"the trainer's best weights")

        # The epoch img/s of both arms, in turns.
        arms = {"residual": [], "recompute": []}
        for i, on in enumerate((False, True, False, True)):
            arm_cfg = fit_config(root / f"arm{i}")
            _, arm, arm_launches = run_fit(arm_cfg, loaders, on)
            arms["residual" if on else "recompute"].append(
                {"epoch_images_per_sec": [m["images_per_sec"] for m in
                                          arm["history"]["train"]],
                 "launches": arm_launches})
        # One profiled step of the fit's train step on each arm.
        batch = loaders[0].gather(torch.arange(BATCH, device="cuda"))
        step_profiles = {}
        for on in (True, False):
            with residual_opt_in(on):
                step_profiles["residual" if on else "recompute"] = \
                    profile_step(lambda: tr.train_step(batch, 4, 1.0, 1))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def hist(r):
        return [{"stage": t["stage"], "lr": t["lr"],
                 "train_loss": t["total_loss"], "val_loss": v["total_loss"],
                 "val_accuracy": v["accuracy"],
                 "images_per_sec": t["images_per_sec"]}
                for t, v in zip(r["history"]["train"], r["history"]["val"])]

    return {"phase": "fit", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16, batch 64, Trainer.fit over a "
            "device-resident synthetic set", "images": len(ds),
            "train_images": n_train, "val_images": len(ds) - n_train,
            "data_seconds": data_s,
            "steps_per_epoch": len(loaders[0]),
            "val_batches_per_epoch": len(loaders[1]),
            "residual_kernels": {
                f"{n}_{str(d).replace('torch.', '')}": r
                for (n, d), r in kernels.items()},
            "held_step": held, "fit_launches": launches,
            "fit_history": hist(res), "best_val_loss": res["best_val_loss"],
            "resume_launches": resume_launches,
            "resume_history": hist(res2),
            "serve_launches": serve_launches,
            "served_equals_best_weights": True,
            "arms_in_turns": arms, "step_profiles": step_profiles,
            "card": smi}, kernels


EVAL_AUG_PER_CLASS = 48     # 192 images: 154 train (2 steps), 38 validation
EVAL_TEST_PER_CLASS = 25    # 100 test images: 2 batches, the second 36 valid
FPS_FORWARDS = 110          # fps_benchmark: 10 warm-up + 100 timed


def run_cli(fn, argv, counters=None):
    """``fn(argv)`` between a launch-counter reset and a read (the block
    and augment counters, or ``counters()``'s), its printing kept off the
    smoke's output; returns its result, the launches, the seconds and what
    it printed."""
    reset, read = (counters or fit_counters)()
    out = io.StringIO()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn([str(a) for a in argv])
    torch.cuda.synchronize()
    return result, read(), time.perf_counter() - t0, out.getvalue()


def check_launches(what: str, got: dict, fwd: int, bwd: int = 0,
                   augment: int = 0) -> None:
    want = {"vit_block_fwd": fwd, "vit_block_bwd": bwd,
            "vit_block_res_fwd": 0, "vit_block_bwd_res": 0,
            "augment": augment}
    if got != want:
        raise RuntimeError(f"{what} launches {got}, want {want}")


def check_fps(what: str, metrics: dict) -> float:
    fps = metrics.get("fps")
    if "fps_error" in metrics or not (fps is not None and np.isfinite(fps)
                                      and fps > 0):
        raise RuntimeError(f"{what}: fps {fps}, {metrics.get('fps_error')}")
    return fps


def eval_phase(smi: str, root):
    """The train CLI -> evaluate CLI -> ``load_engine`` loop on the flagship
    (module docstring, phase 9), in the directory ``root``, whose
    ``train/checkpoints/best_model`` the later phases export and serve."""
    from rovit_kan_tpu_torch.cli import evaluate as cli_evaluate
    from rovit_kan_tpu_torch.cli import train as cli_train
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.data.dataset import Loader, RoseLeafDataset
    from rovit_kan_tpu_torch.data.synthetic import generate_synthetic_dataset
    from rovit_kan_tpu_torch.evaluation.evaluator import (
        Evaluator,
        load_model_for_evaluation,
    )
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.utils.checkpoint import is_finalized, load_meta

    cfg = Config()
    size = cfg.data.image_size
    t0 = time.perf_counter()
    data = root / "data"
    generate_synthetic_dataset(data / "Augmented Image",
                               n_per_class=EVAL_AUG_PER_CLASS, size=size,
                               seed=42)
    generate_synthetic_dataset(data / "Original Image",
                               n_per_class=EVAL_TEST_PER_CLASS, size=size,
                               seed=43)
    data_s = time.perf_counter() - t0

    # The train CLI: 2 epochs of 2 steps and 1 validation batch, then
    # the Evaluator's 2 test batches and its bs=1 FPS forwards.
    out = root / "train"
    metrics, train_launches, train_s, _ = run_cli(cli_train.main, [
        "--data_root", data, "--output_dir", out, "--epochs", 2,
        "--batch_size", BATCH, "--devices", 1])
    with open(out / "logs" / "train_epochs.csv") as f:
        header, *rows = [ln.strip().split(",") for ln in f]
    best = out / "checkpoints" / "best_model"
    if not (rows and is_finalized(best)
            and (out / "results" / "test_metrics.json").exists()):
        raise RuntimeError(f"train CLI wrote {len(rows)} CSV rows; "
                           f"best_model finalized: {is_finalized(best)}")
    losses = [float(r[header.index(c)]) for r in rows for c in header
              if c.endswith("_loss")]
    if not np.all(np.isfinite(losses)):
        raise RuntimeError(f"train CLI: non-finite losses {losses}")
    steps, vals, tests = 2 * len(rows), len(rows), 2
    check_launches("train CLI", train_launches,
                   12 * (steps + vals + tests + FPS_FORWARDS),
                   12 * steps, steps)
    train_fps = check_fps("train CLI", metrics)

    # The evaluate CLI, host metrics, with the temperature stored.
    sidecar = best.parent / "best_model.meta.json"
    before = sidecar.read_bytes()
    host_out = root / "eval_host"
    ev, host_launches, host_s, printed = run_cli(cli_evaluate.main, [
        "--checkpoint", best, "--data_root", data, "--output_dir",
        host_out, "--batch_size", BATCH, "--calibrate",
        "--store_temperature", "--device_metrics", "off"])
    check_launches("evaluate CLI (host metrics)", host_launches,
                   12 * (1 + tests + FPS_FORWARDS))
    host = json.loads((host_out / "test_metrics.json").read_text())
    eval_fps = check_fps("evaluate CLI", host)
    t, degenerate = ev.temperature, ev.temperature_degenerate
    engine = load_engine(best, batch_size=BATCH, device="cuda")
    if degenerate:
        case = "degenerate fit refused, sidecar unchanged"
        ok = (sidecar.read_bytes() == before
              and "Refusing --store_temperature" in printed
              and engine.stats()["temperature"] == 1.0)
    else:
        case = "stored, and load_engine serves with it"
        ok = (load_meta(best).get("temperature") == t
              and host["temperature"] == t
              and engine.stats()["temperature"] == t)
    if not ok:
        raise RuntimeError(f"temperature {t} (degenerate {degenerate}): "
                           f"sidecar {load_meta(best).get('temperature')},"
                           f" engine {engine.stats()['temperature']}")
    reset, read = fit_counters()
    with contextlib.redirect_stdout(io.StringIO()):
        test_ds = RoseLeafDataset(data / "Original Image",
                                  cfg.data.class_names,
                                  cfg.data.severity_map, image_size=size)
    images = np.stack([test_ds[i][0] for i in range(BATCH)])
    reset()
    served = engine.predict(images)
    serve_launches = read()
    check_launches("load_engine", serve_launches, 12)
    if not (np.isfinite(served["cls_probs"]).all() and np.allclose(
            served["cls_probs"].sum(-1), 1.0, atol=1e-5)):
        raise RuntimeError("load_engine served non-finite probabilities")

    # The evaluate CLI, device metrics, at the same temperature.
    dev_out = root / "eval_device"
    ev2, dev_launches, dev_s, _ = run_cli(cli_evaluate.main, [
        "--checkpoint", best, "--data_root", data, "--output_dir",
        dev_out, "--batch_size", BATCH, "--calibrate",
        "--device_metrics", "on"])
    check_launches("evaluate CLI (device metrics)", dev_launches,
                   12 * (1 + tests))
    dev = json.loads((dev_out / "test_metrics_device.json").read_text())
    gaps = {k: abs(dev[k] - host[k]) for k in
            ("accuracy", "macro_f1", "mae", "spearman_rho",
             "brier_score", "ece")}
    # The device path computes in fp32 (as the JAX one does), the host
    # in fp64: the counts agree exactly, accuracy to the fp32 rounding
    # of the same quotient, macro F1 to its fp32 arithmetic.
    if (ev2.temperature != t
            or dev["confusion_matrix"] != host["confusion_matrix"]
            or np.float32(dev["accuracy"]) != np.float32(host["accuracy"])
            or gaps["macro_f1"] > 1e-6 or max(gaps.values()) > 1e-5):
        raise RuntimeError(f"device metrics differ from the host path: "
                           f"{gaps}, T {ev2.temperature} vs {t}")

    # One Evaluator on the same weights through #1, the plain block and
    # the fp32 model; its collected outputs held as served ones.
    loader = Loader(test_ds, BATCH)
    model, state = load_model_for_evaluation(best, device="cuda")
    kernel_ev = Evaluator(model, state, loader, cfg)
    kernel_ev._collect()                  # decodes and caches the set
    pass_s = []
    reset()
    for _ in range(3):
        t0 = time.perf_counter()
        d = kernel_ev._collect()
        pass_s.append(time.perf_counter() - t0)
    collect_launches = read()
    check_launches("Evaluator", collect_launches, 3 * 12 * tests)
    # Where the time of a test pass and of a bs=1 FPS forward goes:
    # device operations and device time per call against the wall time.
    one = torch.zeros((1, size, size, 3), dtype=torch.uint8,
                      device=kernel_ev.device)
    kernel_fps = kernel_ev._fps()
    profiles = {}
    for name, fn, calls, wall_s in (
            ("test_pass", kernel_ev._collect, 3,
             statistics.median(pass_s)),
            ("fps_forward", lambda: kernel_ev._forward(one), 20,
             1.0 / kernel_fps)):
        ops = profile_device(fn, calls)
        device_ms = sum(ms for _, ms in ops.values()) / calls
        profiles[name] = {
            "device_ops": sum(n for n, _ in ops.values()) / calls,
            "device_ms": device_ms, "wall_ms": 1e3 * wall_s,
            "device_busy_share": device_ms / (1e3 * wall_s),
            "top": top_kernels({k: ms / calls
                                for k, (_, ms) in ops.items()})}
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.tpu.use_pallas_block = False
    refs = {}
    for name, ref_cfg, dtype in (("plain", plain_cfg, None),
                                 ("exact", cfg, torch.float32)):
        ref_model = build_model(ref_cfg, dtype=dtype, inference=True,
                                device="cuda")
        reset()
        refs[name] = Evaluator(ref_model, state, loader, cfg)._collect()
        check_launches(f"Evaluator ({name})", read(), 0)

    def as_served(arr):
        return {"cls_probs": arr["probs"],
                "cls_pred": arr["probs"].argmax(1),
                "kan_severity": arr["severity_pred"],
                "uncertainty_std": arr["uncertainty"]}

    checks, failed = hold_served(
        as_served(d), as_served(refs["plain"]), as_served(refs["exact"]),
        keys=("cls_probs", "uncertainty_std", "kan_severity"))
    if failed:
        emit({"phase": "eval", "outputs": checks})
        raise RuntimeError(f"evaluated outputs out of tolerance: "
                           f"{failed}")

    n_test = int(d["labels"].size)
    return {"phase": "eval", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16, batch 64: cli.train -> cli.evaluate -> "
            "load_engine over a synthetic JPEG tree",
            "images": {"augmented": 4 * EVAL_AUG_PER_CLASS,
                       "test": n_test},
            "data_seconds": data_s,
            "train_cli": {"seconds": train_s, "epochs": len(rows),
                          "launches": train_launches, "fps_bs1": train_fps,
                          "test_accuracy": metrics["accuracy"],
                          "losses_finite": True},
            "evaluate_cli_host": {"seconds": host_s,
                                  "launches": host_launches,
                                  "fps_bs1": eval_fps,
                                  "ece": host["ece"],
                                  "ece_precalibration":
                                      host.get("ece_precalibration")},
            "evaluate_cli_device": {"seconds": dev_s,
                                    "launches": dev_launches,
                                    "gaps_vs_host": gaps},
            "temperature": t, "temperature_degenerate": degenerate,
            "temperature_case": case,
            "serve_launches": serve_launches,
            "evaluator_launches": collect_launches,
            "test_pass_seconds": pass_s,
            "eval_images_per_sec": n_test / statistics.median(pass_s),
            "fps_bs1": eval_fps, "fps_bs1_evaluator": kernel_fps,
            "profiles": profiles,
            "held_vs_plain_block": checks, "card": smi}


def all_counters():
    """Reset and read every kernel's launch counter, under the kernels
    line's names."""
    from rovit_kan_tpu_torch.ops import attention as at
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.ops import kan_kernel as kk
    names = {"vit_block_fwd": (bk, "LAUNCHES"),
             "vit_block_bwd": (bk, "BWD_LAUNCHES"),
             "vit_block_res_fwd": (bk, "RES_LAUNCHES"),
             "vit_block_bwd_res": (bk, "BWD_RES_LAUNCHES"),
             "augment": (ak, "LAUNCHES"),
             "kan_layer_fwd": (kk, "LAYER_LAUNCHES"),
             "kan_layer_bwd": (kk, "LAYER_BWD_LAUNCHES"),
             "kan_module_fwd": (kk, "LAUNCHES"),
             "kan_module_bwd": (kk, "BWD_LAUNCHES"),
             "attention_fwd": (at, "LAUNCHES"),
             "attention_bwd": (at, "BWD_LAUNCHES")}

    def reset():
        for mod, attr in names.values():
            setattr(mod, attr, 0)

    def read():
        return {k: getattr(mod, attr) for k, (mod, attr) in names.items()}

    return reset, read


def only(launches: dict, **want) -> None:
    """Raise unless ``launches`` holds ``want`` and zeros elsewhere."""
    full = {k: want.get(k, 0) for k in launches}
    if launches != full:
        raise RuntimeError(f"launches {launches}, want {full}")


def uint8_batch(seed: int, n: int, size: int = 224) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        0, 256, (n, size, size, 3)).astype(np.uint8)


def serve_preset(preset: str, root, images, reset, read) -> dict:
    """A preset saved as a checkpoint and served one batch through
    ``load_engine`` between a counter reset and a read (12 #1 launches),
    its outputs held by ``hold_served`` against the same engine on the plain
    block and the fp32 model."""
    from rovit_kan_tpu_torch.config import get_config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.serving import InferenceEngine, load_engine
    from rovit_kan_tpu_torch.utils.checkpoint import save_checkpoint
    cfg = get_config(preset)
    ck = root / preset / "best_model"
    save_checkpoint(ck, build_model(cfg, device="cuda", seed=0).state_dict(),
                    config=cfg)
    engine = load_engine(ck, batch_size=BATCH, device="cuda")
    blocks = engine.model.backbone.model.blocks
    if not all(b.use_fused_block for b in blocks):
        raise RuntimeError(f"'auto' did not send the {preset} preset to the "
                           f"fused block")
    engine.predict(images)                     # first call: the build
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    served = engine.predict(images)
    torch.cuda.synchronize()
    batch_ms = 1e3 * (time.perf_counter() - t0)
    launches = read()
    only(launches, vit_block_fwd=len(blocks))
    served["features"] = features(engine.model, images)
    for b in blocks:
        b.block_fn = bk.plain_vit_block
    plain = engine.predict(images)
    plain["features"] = features(engine.model, images)
    for b in blocks:
        b.block_fn = bk.fused_vit_block
    model32 = build_model(cfg, dtype=torch.float32, inference=True,
                          device="cuda", seed=0)
    exact = InferenceEngine(model32, batch_size=BATCH,
                            device="cuda").predict(images)
    exact["features"] = features(model32, images)
    checks, failed = hold_served(served, plain, exact)
    if failed:
        emit({"phase": "presets", "preset": preset, "outputs": checks})
        raise RuntimeError(f"{preset} preset's served outputs out of "
                           f"tolerance: {failed}")
    return {"launches": launches, "batch_ms": batch_ms, "outputs": checks}


def presets_phase(smi: str, root):
    """The presets on the fused block (module docstring, phase 10)."""
    from rovit_kan_tpu_torch.config import Config, get_config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    from rovit_kan_tpu_torch.serving import InferenceEngine
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step

    reset, read = all_counters()
    images = uint8_batch(20, BATCH)
    served = {p: serve_preset(p, root, images, reset, read)
              for p in ("small", "base")}

    # "auto" trains small on #1/#2 and base on the plain block, as the JAX
    # rule does; a forced fused block trains base on #1/#2 too (the wide
    # backward takes 768).
    trained = {}
    for label, preset, fused in (("small", "small", True),
                                 ("base", "base", False),
                                 ("base_forced", "base", True)):
        cfg = get_config(preset)
        if label == "base_forced":
            cfg.tpu.use_pallas_block = True
        model = build_model(cfg, device="cuda", seed=0)
        blocks = model.backbone.model.blocks
        if not all(b.use_fused_block == fused for b in blocks):
            raise RuntimeError(f"{label} trains on the wrong block")
        step = make_train_step(model, build_optimizer(model, cfg), cfg,
                               generator=torch.Generator("cuda").manual_seed(0))
        batch = train_batch(cfg, 21)
        torch.cuda.synchronize()
        reset()
        loss = float(step(batch, 4, 1.0, 1)["total_loss"])
        launches = read()
        n = len(blocks) if fused else 0
        only(launches, vit_block_fwd=n, vit_block_bwd=n,
             augment=1 if step.fused_augment else 0)
        if not np.isfinite(loss):
            raise RuntimeError(f"{label} train loss {loss}")
        trained[label] = {"launches": launches, "loss": loss}
        del model, step
    # The small step held against its plain versions and the fp32 model,
    # as the "train" phase holds the flagship's.
    small = get_config("small")
    trained["small"]["held"] = hold_train_step(
        small, train_batch(small, 22), {
            "factors": ak.draw_factors(
                torch.Generator("cuda").manual_seed(3), BATCH),
            "mix": draw_mix(torch.Generator().manual_seed(4), BATCH,
                            small.data.image_size, small.data.image_size)})

    flagship = InferenceEngine(build_model(Config(), inference=True,
                                           device="cuda", seed=0),
                               batch_size=BATCH, device="cuda")
    reset()
    flagship.predict(images)
    flagship_launches = read()
    only(flagship_launches, vit_block_fwd=12)
    return {"phase": "presets",
            "model": "get_config('small') d=384 heads=6 and "
                     "get_config('base') d=768 heads=12, depth 12, 224px "
                     "bf16, batch 64",
            "serve": served, "train": trained,
            "flagship_launches_per_batch": flagship_launches["vit_block_fwd"],
            "card": smi}


def op_nodes(program, name: str) -> int:
    """Nodes of an exported graph that call the custom op ``name``."""
    target = f"rovit_kan_torch.{name}.default"
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function" and str(n.target) == target)


def same_outputs(got: dict, want: dict, rows: int) -> list:
    """The outputs whose first ``rows`` rows are not the same bits."""
    return [k for k, v in want.items()
            if not np.array_equal(got[k].cpu().numpy()[:rows], v[:rows])]


def export_case(label, model, engine, images, counters, want_launch,
                nodes, root, temperature):
    """Export ``model`` at the engine's batch, save, load it afresh and hold
    the artifact against ``engine``: the same bits on a full and a padded
    partial batch, ``want_launch`` (name, count) per call by the counters
    and in the graph, device operations per batch against the eager serving
    forward, and the times of one call both ways."""
    from rovit_kan_tpu_torch.export import load_exported, save_exported
    from rovit_kan_tpu_torch.serving import build_serving_forward

    reset, read = counters
    path = root / f"{label}.pt2"
    t0 = time.perf_counter()
    size_bytes = save_exported(path, model, engine.batch_size,
                               temperature=temperature)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    artifact = load_exported(path)
    load_s = time.perf_counter() - t0
    program = artifact.program
    graph_nodes = {n: op_nodes(program, n) for n in nodes}
    calls = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    census = {"call_nodes": len(calls),
              "assert_tensor_metadata": calls.count(
                  "aten._assert_tensor_metadata.default"),
              "to_dtype": calls.count("aten.to.dtype")}
    name, per_call = want_launch
    if graph_nodes != nodes:
        raise RuntimeError(f"{label}: op nodes {graph_nodes}, want {nodes}")
    n_part = engine.batch_size * 3 // 5
    padded = np.zeros_like(images)
    padded[:n_part] = images[:n_part]
    reset()
    got = artifact(images)
    got_part = artifact(padded)
    torch.cuda.synchronize()
    launches = read()
    only(launches, **{name: 2 * per_call,
                      **({"vit_block_fwd": 24} if name == "kan_module_fwd"
                         else {})})
    want = engine.predict(images)
    want_part = engine.predict(images[:n_part])
    differ = (same_outputs(got, want, len(images))
              + [k + "(partial)" for k in
                 same_outputs(got_part, want_part, n_part)])
    if differ:
        raise RuntimeError(f"{label}: artifact outputs differ from the "
                           f"engine's bits: {differ}")
    x = torch.from_numpy(images).cuda()
    eager = build_serving_forward(engine.model, temperature)
    module = program.module()

    def run_artifact():
        with torch.inference_mode():
            module(x)

    def run_eager():
        with torch.inference_mode():
            eager(x)

    ops = {"artifact": sum(n for n, _ in profile_device(run_artifact,
                                                          calls=3).values()),
           "eager": sum(n for n, _ in profile_device(run_eager,
                                                     calls=3).values())}
    ops = {k: v / 3 for k, v in ops.items()}
    if ops["artifact"] > ops["eager"]:
        raise RuntimeError(f"{label}: the artifact enqueues {ops} device "
                           f"operations per batch")
    # Events around back-to-back calls, in turns; CUDA-graph replay for the
    # artifact only: the eager forward copies its normalization constants
    # from the host on every call, which a capture refuses.
    times = {"artifact_events_ms": [], "eager_events_ms": []}
    for turn in ("artifact", "eager", "eager", "artifact"):
        fn = run_artifact if turn == "artifact" else run_eager
        times[f"{turn}_events_ms"].append(time_ms(fn, reps=5, inner=5))
    times["artifact_graph_ms"] = graph_ms(run_artifact, calls=5)
    return {"case": label, "bytes": size_bytes, "export_s": export_s,
            "load_s": load_s, "op_nodes": graph_nodes,
            "graph_census": census,
            "launches_per_call": per_call, "launches": launches,
            "same_bits_as_engine": True, "partial_rows": n_part,
            "device_ops_per_batch": ops, "times_in_turns": times}


def dispatch_cost(reps: int = 7, calls: int = 100) -> dict:
    """Host microseconds per wrapper call through the custom op and through
    the ctypes launch alone (the parent's path), in turns, at the main
    path's shapes: #1 (64, 197, 192) bf16, #5 (32, 3, 577, 64) bf16, #10
    (64, [192, 64, 16, 1]) fp32. Each reading is the wall time of ``calls``
    back-to-back calls over ``calls``, after a synchronize, before the
    device's queue fills; the median of ``reps``."""
    from rovit_kan_tpu_torch.ops import attention as at
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.ops import kan_kernel as kk

    x, params = block_inputs(torch.bfloat16, seed=30)
    plist = [params[k] for k in bk.PKEYS]
    q, k, v = (torch.randn((32, 3, LONG_TOKENS, 64), device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    from rovit_kan_tpu_torch.ops.spline import make_knots
    kx, kparams, _ = kan_inputs(seed=31)
    knots = make_knots()
    klist = [float(t) for t in knots]
    cases = {
        "vit_block_fwd": (lambda: bk._VIT_BLOCK_FWD(x, plist, HEADS),
                          lambda: bk._launch(x, params, HEADS)),
        "attention_fwd": (lambda: at._ATTENTION_FWD(q, k, v),
                          lambda: at._launch(q, k, v)),
        "kan_module_fwd": (lambda: kk._KAN_MODULE_FWD(kx, list(kparams),
                                                      klist, 3),
                           lambda: kk._launch_module(kx, kparams, knots, 3))}

    def host_us(fn):
        with torch.inference_mode():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            dt = time.perf_counter() - t0
            torch.cuda.synchronize()
        return dt / calls * 1e6

    out = {}
    for name, (op, ctypes_only) in cases.items():
        got = {"op": [], "ctypes": []}
        for _ in range(reps):
            got["op"].append(host_us(op))
            got["ctypes"].append(host_us(ctypes_only))
        out[name] = {"op_us": statistics.median(got["op"]),
                     "ctypes_only_us": statistics.median(got["ctypes"]),
                     "op_us_all": got["op"], "ctypes_only_us_all":
                     got["ctypes"]}
        out[name]["dispatch_us"] = (out[name]["op_us"]
                                    - out[name]["ctypes_only_us"])
    return out


@contextlib.contextmanager
def ctypes_only_block():
    """The block forward without the op: the wrapper's parent path, a ctypes
    launch straight from ``_forward``."""
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    op = bk._VIT_BLOCK_FWD
    bk._VIT_BLOCK_FWD = lambda x, plist, heads: bk._launch(
        x, dict(zip(bk.PKEYS, plist)), heads)
    try:
        yield
    finally:
        bk._VIT_BLOCK_FWD = op


def served_rates(model=None, n_batches: int = 20) -> dict:
    """Served 224-px img/s at batch 64 (``InferenceEngine`` over
    ``n_batches`` batches; its busy-span rate) and bs=1 FPS
    (``fps_benchmark`` of the serving forward on one image) of the seed-0
    flagship. Uses only what the port had before its custom ops, so a copy
    of this script can time an earlier checkout the same way."""
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.evaluation.metrics import fps_benchmark
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import InferenceEngine, \
        build_serving_forward

    if model is None:
        model = build_model(Config(), inference=True, device="cuda", seed=0)
    engine = InferenceEngine(model, batch_size=BATCH, device="cuda")
    engine.warmup()
    for i in range(n_batches):
        engine.predict(uint8_batch(40 + i, BATCH))
    one = torch.from_numpy(uint8_batch(60, 1)).cuda()
    return {"served_images_per_sec": engine.stats()["images_per_sec"],
            "fps_bs1": fps_benchmark(build_serving_forward(model), one)}


def serving_speed(rounds: int = 2) -> dict:
    """``served_rates`` through the op and with the block forward on the
    ctypes launch alone, in turns (op, ctypes, ctypes, op)."""
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model

    model = build_model(Config(), inference=True, device="cuda", seed=0)
    out = {"op": [], "ctypes_only": []}
    for turn in ["op", "ctypes_only", "ctypes_only", "op"] * (rounds // 2):
        with (ctypes_only_block() if turn == "ctypes_only"
              else contextlib.nullcontext()):
            out[turn].append(served_rates(model))
    return out


def export_phase(smi: str, root, best):
    """Export, load and hold three artifacts; dispatch cost and served
    speed through the op and without it (module docstring, phase 11)."""
    from rovit_kan_tpu_torch.cli import export_model as cli_export
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.evaluation.evaluator import \
        load_model_for_evaluation
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import InferenceEngine, load_engine
    from rovit_kan_tpu_torch.utils.checkpoint import load_meta

    counters = all_counters()
    reset, read = counters
    out_dir = root / "export"
    # The export CLI on best_model, with its --verify.
    n_bytes, cli_launches, cli_s, printed = run_cli(cli_export.main, [
        best, out_dir / "cli.pt2", "--batch-size", BATCH, "--verify"])
    if "Verified" not in printed:
        raise RuntimeError(f"export CLI did not verify: {printed}")
    t = float(load_meta(best).get("temperature", 1.0))
    model, _ = load_model_for_evaluation(best, device="cuda")
    engine = load_engine(best, batch_size=BATCH, device="cuda")
    if engine.temperature != t:
        raise RuntimeError(f"engine T {engine.temperature}, sidecar {t}")
    cases = [export_case("flagship_224", model, engine, uint8_batch(50, BATCH),
                         counters, ("vit_block_fwd", 12),
                         {"vit_block_fwd": 12, "attention_fwd": 0,
                          "kan_module_fwd": 0}, out_dir, t)]
    cfg = long_config(use_pallas_block=False)
    m384 = build_model(cfg, inference=True, device="cuda", seed=0)
    cases.append(export_case(
        "attention_384", m384,
        InferenceEngine(m384, batch_size=LONG_BATCH, device="cuda"),
        uint8_batch(51, LONG_BATCH, LONG_SIZE), counters,
        ("attention_fwd", 12),
        {"vit_block_fwd": 0, "attention_fwd": 12, "kan_module_fwd": 0},
        out_dir, 1.0))
    kcfg = Config()
    kcfg.tpu.use_pallas_kan = True
    mkan = build_model(kcfg, inference=True, device="cuda", seed=0)
    cases.append(export_case(
        "kan_224", mkan, InferenceEngine(mkan, batch_size=BATCH,
                                         device="cuda"),
        uint8_batch(52, BATCH), counters, ("kan_module_fwd", 1),
        {"vit_block_fwd": 12, "attention_fwd": 0, "kan_module_fwd": 1},
        out_dir, 1.0))
    launches = {k: sum(c["launches"][k] for c in cases)
                for k in cases[0]["launches"]}
    dispatch = dispatch_cost()
    speed = serving_speed()
    return {"phase": "export", "temperature": t,
            "export_cli": {"bytes": n_bytes, "seconds": cli_s,
                           "launches": cli_launches, "verified": True},
            "cases": cases, "launches": launches,
            "dispatch_host_us_per_call": dispatch,
            "serving_op_vs_ctypes_only": speed, "card": smi}


def post(base: str, images: np.ndarray, timeout: float = 120):
    import urllib.request
    buf = io.BytesIO()
    np.save(buf, images)
    t0 = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(
            f"{base}/predict", buf.getvalue()), timeout=timeout) as r:
        body = json.loads(r.read())
    return body, time.perf_counter() - t0


def as_arrays(body: dict, want: dict) -> dict:
    return {k: np.asarray(body[k], dtype=want[k].dtype) for k in want}


# ``python -m rovit_kan_tpu_torch.cli.serve ARGS`` (runpy does what -m
# does), then the process's launch counters, read after the drain.
SERVE_CODE = (
    "import json, runpy, sys\n"
    "runpy.run_module('rovit_kan_tpu_torch.cli.serve', run_name='__main__',"
    " alter_sys=True)\n"
    "import chip_smoke\n"
    "print('LAUNCHES ' + json.dumps(chip_smoke.all_counters()[1]()), "
    "flush=True)\n")


def serve_cli_phase(smi: str, best):
    """``cli.serve`` in a subprocess on best_model (module docstring, phase
    12)."""
    import signal
    import urllib.request

    from rovit_kan_tpu_torch.serving import load_engine

    engine = load_engine(best, batch_size=BATCH, device="cuda")
    proc = subprocess.Popen(
        [sys.executable, "-c", SERVE_CODE, "--checkpoint", str(best),
         "--host", "127.0.0.1", "--port", "0", "--batch_size", str(BATCH)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        t0 = time.perf_counter()
        for line in proc.stdout:
            lines.append(line.rstrip())
            if line.startswith("Serving on http://"):
                break
        else:
            raise RuntimeError(f"cli.serve did not start: {lines}")
        start_s = time.perf_counter() - t0
        base = line.split()[2]
        singles = uint8_batch(70, 16)
        pairs = [uint8_batch(71, BATCH), uint8_batch(72, BATCH)]
        results = {}

        def client(key, images):
            results[key] = post(base, images)

        threads = ([threading.Thread(target=client, args=(("one", i),
                                                          singles[i:i + 1]))
                    for i in range(16)]
                   + [threading.Thread(target=client, args=(("batch", i),
                                                            pairs[i]))
                      for i in range(2)])
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        if len(results) != 18:
            raise RuntimeError(f"{18 - len(results)} clients got no answer")
        # A batch of 64 is served alone, at its engine's rows: the same
        # bits. A single image lands at another row of a coalesced batch
        # than in the engine's own padded batch; it agrees to fp32 noise
        # (the "serve" phase's MicroBatcher bound, 1e-5).
        direct = engine.predict(singles)
        single_err = 0.0
        for i in range(16):
            got = as_arrays(results["one", i][0], direct)
            single_err = max(single_err, max(
                float(np.abs(got[k][0].astype(np.float64) - direct[k][i])
                      .max()) for k in direct))
        if not single_err <= 1e-5:
            raise RuntimeError(f"served singles differ by {single_err}")
        for i in range(2):
            want = engine.predict(pairs[i])
            got = as_arrays(results["batch", i][0], want)
            if not all(np.array_equal(got[k], want[k]) for k in want):
                raise RuntimeError("a served batch of 64 is not the "
                                   "engine's bits")
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health["requests_coalesced"] < 16:
            raise RuntimeError(f"healthz {health}")
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            text = r.read().decode()
        metrics = {}
        for ln in text.splitlines():
            if ln.startswith("# TYPE "):
                _, _, name, kind = ln.split()
                if kind not in ("counter", "gauge"):
                    raise RuntimeError(f"metric type {ln}")
            else:
                name, value = ln.split()
                metrics[name] = float(value)
        if metrics["rovit_serving_requests_coalesced"] != \
                health["requests_coalesced"] or len(metrics) != len(health):
            raise RuntimeError(f"metrics {metrics} against {health}")

        # Served throughput over HTTP: 4 clients, 6 batches of 64 each.
        lat = []
        lock = threading.Lock()

        def load(seed):
            for j in range(6):
                _, s = post(base, pairs[(seed + j) % 2])
                with lock:
                    lat.append(s)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=load, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t0
        if len(lat) != 24:
            raise RuntimeError(f"{24 - len(lat)} load requests unanswered")

        # The drain: 8 batches of 64 posted at once, SIGTERM 0.15 s later,
        # when every connection has been accepted and some answers are
        # still being computed; each must be answered, and the server must
        # exit 0 within 30 s.
        drained, failed = {}, {}

        def late(i):
            try:
                body, _ = post(base, pairs[i % 2])
                drained[i] = (body, time.perf_counter())
            except OSError as e:         # URLError and connection errors
                failed[i] = repr(e)

        late_threads = [threading.Thread(target=late, args=(i,))
                        for i in range(8)]
        for th in late_threads:
            th.start()
        time.sleep(0.15)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=30)
        exit_s = time.perf_counter() - t_term
        for th in late_threads:
            th.join(timeout=60)
        lines += rest.splitlines()
        if proc.returncode != 0:
            raise RuntimeError(f"cli.serve exited {proc.returncode}: "
                               f"{lines[-20:]}")
        if failed or len(drained) != 8:
            raise RuntimeError(f"in-flight requests lost: {failed}")
        after_term = sum(1 for _, t in drained.values() if t > t_term)
        for i, (body, _) in drained.items():
            want = engine.predict(pairs[i % 2])
            got = as_arrays(body, want)
            if not all(np.array_equal(got[k], want[k]) for k in want):
                raise RuntimeError("a drained answer is not the engine's")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    counted = [ln for ln in lines if ln.startswith("LAUNCHES ")]
    launches = json.loads(counted[-1].split(" ", 1)[1])
    # The warm-up, the batches before /healthz, then one batch for each
    # load and drain request (a batch of 64 runs alone); 12 x #1 each.
    batches = 1 + health["batches_run"] + 24 + 8
    only(launches, vit_block_fwd=12 * batches)
    lat_ms = 1e3 * np.asarray(lat)
    return {"phase": "serve_cli", "start_s": start_s, "healthz": health,
            "metrics": len(metrics), "single_image_max_abs_err": single_err,
            "http_images_per_sec": 24 * BATCH / wall,
            "http_p50_latency_ms": float(np.percentile(lat_ms, 50)),
            "http_p95_latency_ms": float(np.percentile(lat_ms, 95)),
            "drain": {"answered": len(drained),
                      "answered_after_sigterm": after_term,
                      "exit_code": proc.returncode,
                      "exit_s_after_sigterm": exit_s},
            "launches": launches, "card": smi}


def bench_phase(smi: str):
    """``cli.bench`` once, in this process, between a counter reset and a
    read (module docstring, phase 13)."""
    from rovit_kan_tpu_torch.cli import bench as cli_bench
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = cli_bench.main([])
    torch.cuda.synchronize()
    launches = read()
    line = out.getvalue().strip().splitlines()[-1]
    if json.loads(line) != json.loads(json.dumps(res)):
        raise RuntimeError("cli.bench's line is not its result")
    rates = [res[k] for k in res if k.endswith("_ips_bs64")
             or k.endswith("_ips_bs256")] + [res["fps_bs1"]]
    mfus = [v for k, v in res.items() if k.startswith("implied_mfu")]
    if not (all(np.isfinite(r) and r > 0 for r in rates)
            and all(0 < m <= 1 for m in mfus) and not res["timing_suspect"]
            and res["fused_block"] == {"inference": True, "train": True}):
        raise RuntimeError(f"cli.bench line out of range: {line}")
    for k in ("vit_block_fwd", "vit_block_bwd", "augment"):
        if not launches[k] > 0:
            raise RuntimeError(f"cli.bench launched no {k}: {launches}")
    return {"phase": "bench", "line": res, "launches": launches,
            "card": smi}


ROLLOUT_CPU_IMAGES = 16
ROLLOUT_TOL = 1e-4        # fp32, sums in another order; maps in [0, 1]
VIZ_SAMPLES = 8
ABLATION_PER_CLASS = 48   # 192 images: 134 train (2 steps), 28 val, 30 test
ABLATION_EPOCHS = 2


def draw_layer_norms(model, seed: int) -> None:
    """Seeded LayerNorm scales ``1 + N(0, 0.1^2)`` and biases
    ``N(0, 0.1^2)``. At init every LayerNorm has unit scale and zero bias,
    so the Grad-CAM++ tap's channels sum to zero and its maps are rounding
    noise, which no tolerance can hold; a trained model's LayerNorms are not
    the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.LayerNorm):
                mod.weight.copy_(1 + 0.1 * torch.randn(mod.weight.shape,
                                                       generator=g))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape,
                                                 generator=g))


def gradcam_call(model, x, targets):
    """One Grad-CAM++ call through the port: the tap, its gradient, the
    targets and the maps, on the device."""
    from rovit_kan_tpu_torch.explainability.gradcam import (
        _cam_from_grads,
        gradcam_taps,
    )
    acts, grads, idx = gradcam_taps(model, x, targets)
    return acts, grads, idx, _cam_from_grads(acts, grads, model.image_size)


@contextlib.contextmanager
def plain_kernels(model):
    """The model's blocks through ``plain_vit_block`` and its attention
    cores through ``plain_attention`` (the plain versions on the card), put
    back after."""
    from rovit_kan_tpu_torch.ops.attention import plain_attention
    from rovit_kan_tpu_torch.ops.block_kernel import plain_vit_block
    blocks = model.backbone.model.blocks
    kept = [(b.block_fn, b.attn.attn_fn) for b in blocks]
    for b in blocks:
        b.block_fn, b.attn.attn_fn = plain_vit_block, plain_attention
    try:
        yield
    finally:
        for b, (block_fn, attn_fn) in zip(blocks, kept):
            b.block_fn, b.attn.attn_fn = block_fn, attn_fn


def hold_gradcam(label, model, exact, x, targets, want: dict) -> dict:
    """One Grad-CAM++ call between a counter reset and a read, which must
    show ``want`` and nothing else, and leave every ``.grad`` None and the
    model in eval mode. Its tap, gradient and maps are held against the
    same call through the plain versions and through the fp32 model
    (``exact``) by ``hold_served``'s rule: both distances within twice the
    plain call's distance from fp32, at least ``bf16_tol`` for the tap and
    gradient and 1e-3 for the maps, whose distances are mean absolute
    ones."""
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    acts, grads, idx, cams = gradcam_call(model, x, targets)
    torch.cuda.synchronize()
    launches = read()
    only(launches, **want)
    if any(p.grad is not None for p in model.parameters()) \
            or model.training:
        raise RuntimeError(f"{label}: Grad-CAM++ wrote a .grad or left "
                           f"the model in training mode")
    with plain_kernels(model):
        reset()
        p_acts, p_grads, _, p_cams = gradcam_call(model, x, targets)
        torch.cuda.synchronize()
        only(read())
    e_acts, e_grads, _, e_cams = gradcam_call(exact, x, targets)
    # The tap is the 11th block's output through norm1: where an fp32 sum
    # in #1 lands on the other side of a bf16 rounding boundary than in the
    # plain version, the ulp spreads through the blocks like any other bf16
    # rounding, so the two paths part by as much as bf16 and fp32 do. Both
    # are held as ``hold_served`` holds outputs, with ``bf16_tol`` (two bf16
    # ulps at the largest magnitude) as the floor.
    holds = {}
    for name, got, ref, ex in (("tap", acts, p_acts, e_acts),
                               ("tap_grad", grads, p_grads, e_grads)):
        ref_err = float((ref - ex).abs().max())
        holds[name] = {"vs_plain": float((got - ref).abs().max()),
                       "vs_fp32": float((got - ex).abs().max()),
                       "plain_vs_fp32": ref_err,
                       "bf16_tol": bf16_tol(ref),
                       "tolerance": 2 * max(ref_err, bf16_tol(ref)),
                       "max_abs": float(ref.abs().max())}
    # A min-max normalized map moves by up to 1 where its top patch
    # changes, which bf16 rounding alone can do: the maps are held by their
    # mean absolute distance, and the largest is reported.
    ref_err = float((p_cams - e_cams).abs().mean())
    holds["maps"] = {"mean_vs_plain": float((cams - p_cams).abs().mean()),
                     "mean_vs_fp32": float((cams - e_cams).abs().mean()),
                     "plain_mean_vs_fp32": ref_err,
                     "tolerance": 2 * max(ref_err, 1e-3),
                     "max_vs_plain": float((cams - p_cams).abs().max()),
                     "plain_max_vs_fp32": float((p_cams - e_cams).abs().max())}
    failed = [k for k in ("tap", "tap_grad")
              if not max(holds[k]["vs_plain"], holds[k]["vs_fp32"])
              <= holds[k]["tolerance"]]
    m = holds["maps"]
    if not max(m["mean_vs_plain"], m["mean_vs_fp32"]) <= m["tolerance"]:
        failed.append("maps")
    if not (torch.isfinite(cams).all() and cams.min() >= 0
            and cams.max() <= 1 + 1e-6):
        failed.append("maps_range")
    if failed:
        emit({"phase": "explain", "case": label, "holds": holds})
        raise RuntimeError(f"{label}: Grad-CAM++ out of tolerance: {failed}")
    return {"launches": launches, "holds": holds,
            "targets": idx.tolist()[:8]}


def maps_per_second(fn, n: int, calls: int = 5) -> float:
    """Maps a second of ``fn`` (``n`` maps a call), host wall time over
    ``calls`` calls after a warm-up, closed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return n * calls / (time.perf_counter() - t0)


def explain_phase(smi: str, root, best):
    """Attention rollout, Grad-CAM++ at 224 and 384 px, and
    ``cli.visualize`` on the card (module docstring, phase 14)."""
    from rovit_kan_tpu_torch.cli import visualize as cli_visualize
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.explainability import ViTAttentionRollout
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.ops.preprocess import eval_batch

    reset, read = all_counters()
    cfg = Config()
    model = build_model(cfg, inference=True, device="cuda", seed=0)
    draw_layer_norms(model, seed=30)
    if not all(b.use_fused_block for b in model.backbone.model.blocks):
        raise RuntimeError("'auto' did not take the fused block at 224 px")
    exact = build_model(cfg, dtype=torch.float32, inference=True,
                        device="cuda", seed=0)
    exact.load_state_dict(model.state_dict())
    x = eval_batch(torch.from_numpy(
        uint8_batch(31, BATCH, cfg.data.image_size)).cuda())
    targets = torch.arange(BATCH, device=x.device) % cfg.model.num_classes

    # Rollout: every block on the plain path, no kernel. The fp32 model's
    # maps on the card against the same function on the CPU.
    roller = ViTAttentionRollout(model)
    torch.cuda.synchronize()
    reset()
    maps = roller.maps(x)
    torch.cuda.synchronize()
    rollout_launches = read()
    only(rollout_launches)
    if not (torch.isfinite(maps).all() and maps.min() >= 0
            and maps.max() <= 1 + 1e-6):
        raise RuntimeError("rollout maps out of [0, 1]")
    cpu = build_model(cfg, dtype=torch.float32, inference=True, device="cpu",
                      seed=0)
    cpu.load_state_dict(model.state_dict())
    n_cpu = ROLLOUT_CPU_IMAGES
    card32 = ViTAttentionRollout(exact).maps(x[:n_cpu]).cpu()
    host32 = ViTAttentionRollout(cpu, device="cpu").maps(x[:n_cpu].cpu())
    rollout_gap = float((card32 - host32).abs().max())
    if not rollout_gap <= ROLLOUT_TOL:
        raise RuntimeError(f"fp32 rollout on the card {rollout_gap} from "
                           f"the CPU's (tolerance {ROLLOUT_TOL})")

    # Grad-CAM++ at 224 px: #1 on the 11 blocks before the tap, as
    # inference calls; the last block plain.
    cam224 = hold_gradcam("224", model, exact, x, targets,
                          {"vit_block_fwd": cfg.model.depth - 1})
    rates = {"rollout_maps_per_sec": maps_per_second(
                 lambda: roller.maps(x), BATCH),
             "gradcam_maps_per_sec": maps_per_second(
                 lambda: gradcam_call(model, x, targets), BATCH)}
    wall_ms = 1e3 * BATCH / rates["gradcam_maps_per_sec"]
    ops = profile_device(lambda: gradcam_call(model, x, targets), calls=3)
    device_ms = sum(ms for _, ms in ops.values()) / 3
    gradcam_profile = {
        "device_ops": sum(n for n, _ in ops.values()) / 3,
        "device_ms": device_ms, "wall_ms": wall_ms,
        "device_busy_share": device_ms / wall_ms,
        "top": top_kernels({k: ms / 3 for k, (_, ms) in ops.items()})}
    del exact, cpu

    # Grad-CAM++ at 384 px: "auto" takes #1 for the blocks before the tap
    # and #5/#6 for the last block's attention.
    cfg384 = long_config()
    model384 = long_model(cfg384, inference=True)
    draw_layer_norms(model384, seed=32)
    last = model384.backbone.model.blocks[-1]
    if not (last.use_fused_block and last.attn.use_fused):
        raise RuntimeError("'auto' at 384 px did not take #1 and #5")
    exact384 = long_model(cfg384, inference=True, dtype=torch.float32)
    exact384.load_state_dict(model384.state_dict())
    x384 = eval_batch(torch.from_numpy(
        uint8_batch(33, LONG_BATCH, LONG_SIZE)).cuda())
    t384 = torch.arange(LONG_BATCH, device=x.device) % cfg.model.num_classes
    cam384 = hold_gradcam("384", model384, exact384, x384, t384,
                          {"vit_block_fwd": cfg.model.depth - 1,
                           "attention_fwd": 1, "attention_bwd": 1})
    rates["gradcam_384_maps_per_sec"] = maps_per_second(
        lambda: gradcam_call(model384, x384, t384), LONG_BATCH)
    del model384, exact384

    # cli.visualize on the eval phase's best_model.
    out = root / "viz"
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        with contextlib.redirect_stdout(io.StringIO()):
            attn_maps, cams = cli_visualize.main([str(a) for a in (
                "--checkpoint", best, "--data_root", root / "data",
                "--output_dir", out, "--num_samples", VIZ_SAMPLES)])
    torch.cuda.synchronize()
    viz_s = time.perf_counter() - t0
    viz_launches = read()
    figures = sorted(p.name for p in out.glob("*.png"))
    no_mpl = [str(w.message) for w in warned
              if "matplotlib is not installed" in str(w.message)]
    # 11 #1 for Grad-CAM++, 12 for the predictions, 12 more for the KAN
    # figures' forward, which runs only where matplotlib draws.
    want = (cfg.model.depth - 1) + cfg.model.depth * (1 if no_mpl else 2)
    only(viz_launches, vit_block_fwd=want)
    expected = 2 * VIZ_SAMPLES + 1 + 4
    size = cfg.data.image_size
    if not (attn_maps.shape == cams.shape == (VIZ_SAMPLES, size, size)
            and np.isfinite(cams).all()
            and (len(figures) == expected if not no_mpl
                 else not figures and len(no_mpl) == 1)):
        raise RuntimeError(f"cli.visualize wrote {figures}, warned {no_mpl}")
    return {"phase": "explain", "model": "DeiT-Tiny RoViT-KAN d=192 "
            "depth=12 heads=3 bf16, seed-0 weights, LayerNorms drawn "
            "(seed 30; 32 at 384 px); batch 64 at 224 px, 32 at 384 px",
            "rollout": {"launches": rollout_launches,
                        "fp32_card_vs_cpu": rollout_gap,
                        "tolerance": ROLLOUT_TOL, "cpu_images": n_cpu},
            "gradcam_224": cam224, "gradcam_384": cam384,
            "rates": rates, "gradcam_profile": gradcam_profile,
            "visualize": {"seconds": viz_s, "launches": viz_launches,
                          "figures": len(figures), "warned": no_mpl},
            "launches": {k: rollout_launches[k] + cam224["launches"][k]
                         for k in rollout_launches},
            "launches_384": cam384["launches"],
            "card": smi}


def ablation_phase(smi: str, root):
    """``cli.run_ablation --synthetic --device-cache`` at the flagship's
    full width, then the same command again (module docstring, phase 15)."""
    from rovit_kan_tpu_torch.cli import run_ablation as cli_ablation
    from rovit_kan_tpu_torch.experiments.ablation import (
        CANONICAL_VARIANTS,
        AblationExperiment,
    )

    reset, read = all_counters()
    out = root / "ablation"
    argv = ["--data-root", root / "ablation_data", "--output-dir", out,
            "--synthetic", "--n-per-class", ABLATION_PER_CLASS,
            "--epochs", ABLATION_EPOCHS, "--batch-size", BATCH,
            "--device-cache", "--devices", 1]
    n_train, n_val, n_test = (len(s) for s in cli_ablation.split_indices(
        4 * ABLATION_PER_CLASS, 42))
    steps = ABLATION_EPOCHS * (n_train // BATCH)
    val_batches = -(-n_val // BATCH)
    # Train steps; a validation pass an epoch; the test pass; the bs=1 FPS
    # forwards; the calibration's validation pass.
    forwards = (steps + ABLATION_EPOCHS * val_batches + -(-n_test // BATCH)
                + FPS_FORWARDS + val_batches)
    per_variant = {}
    real = AblationExperiment.run_single_experiment

    def counted(self, variant, epochs=None):
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        result = real(self, variant, epochs)
        torch.cuda.synchronize()
        per_variant[variant.name] = {"launches": read(),
                                     "seconds": time.perf_counter() - t0}
        return result

    runs = []
    AblationExperiment.run_single_experiment = counted
    try:
        for _ in range(2):
            per_variant = {}
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                exp = cli_ablation.main([str(a) for a in argv])
            runs.append((exp, per_variant, time.perf_counter() - t0,
                         printed.getvalue()))
    finally:
        AblationExperiment.run_single_experiment = real
    (exp, first, first_s, _), (again, second, second_s, printed) = runs
    names = [v.name for v in CANONICAL_VARIANTS]
    for name in names:
        only(first[name]["launches"], vit_block_fwd=12 * forwards,
             vit_block_bwd=12 * steps, augment=steps)
        only(second[name]["launches"])
        m = exp.results[name]
        if not (np.isfinite(m["accuracy"]) and m["temperature"] > 0
                and np.isfinite(m["ece_calibrated"])):
            raise RuntimeError(f"{name}: metrics {m}")
    rows = (out / "ablation_results.csv").read_text().splitlines()
    importance = json.loads((out / "component_importance.json").read_text())
    if not (len(rows) == 7 and [r.split(",")[0] for r in rows[1:]] == names
            and set(importance) == {"ordinal_head", "uncertainty_head",
                                    "kan_module", "curriculum"}
            and printed.count("skipping retrain") == 6
            and all(again.results[n]["accuracy"] == exp.results[n]["accuracy"]
                    for n in names)):
        raise RuntimeError(f"ablation outputs: {len(rows)} CSV rows, "
                           f"importance {importance}")
    launches = {k: sum(first[n]["launches"][k] for n in names)
                for k in first[names[0]]["launches"]}
    return {"phase": "ablation", "model": "DeiT-Tiny RoViT-KAN d=192 "
            "depth=12 heads=3 224px bf16, the six variants, batch 64, "
            f"{ABLATION_EPOCHS} epochs over a synthetic tree of "
            f"{4 * ABLATION_PER_CLASS} images on the card",
            "split": [n_train, n_val, n_test], "steps_per_variant": steps,
            "forwards_per_variant": forwards,
            "seconds": first_s, "seconds_per_variant":
                {n: first[n]["seconds"] for n in names},
            "skip_run_seconds": second_s,
            "accuracy": {n: exp.results[n]["accuracy"] for n in names},
            "temperature": {n: exp.results[n]["temperature"] for n in names},
            "component_importance": importance, "launches": launches,
            "card": smi}


BASELINE_MODELS = ("deit_tiny", "efficientnet_b0", "mobilenetv3_large",
                   "resnet50", "vgg16", "swin_tiny")
BASELINE_PER_CLASS = 32   # 128 augmented: 102 train (3 steps), 26 val
BASELINE_BATCH = 32
BASELINE_SIZE = 224
BASELINE_TIMED_STEPS = 5  # warm train steps timed a model
# The JAX modules' parameter counts at 224 px, 4 classes (jax.eval_shape;
# the JAX package's outputs/baselines/*_metrics.json).
BASELINE_PARAMS = {"deit_tiny": 5_525_188, "resnet50": 23_516_228,
                   "efficientnet_b0": 4_012_672,
                   "mobilenetv3_large": 4_205_322,
                   "vgg16": 134_276_932, "swin_tiny": 27_522_430}
BASELINE_METRICS = ("accuracy", "macro_f1", "weighted_f1", "brier_score",
                    "ece", "ece_calibrated", "brier_calibrated",
                    "temperature", "params", "fps", "train_time_s")


def hold_baseline_twin(exp, trained) -> dict:
    """deit_tiny's FPS twin (bf16, #1) against the same twin on the plain
    block and the fp32 model, by ``hold_served``'s rule, at 224 px: one
    batch of 64 on fresh weights whose LayerNorms are drawn, so the blocks
    are not the identity-normalized ones of init, and one batch of 1, the
    FPS column's shape, on ``trained``, the model the sweep trained."""
    fresh = exp.build_model("deit_tiny").eval()
    draw_layer_norms(fresh, seed=16)
    return {"batch_64_fresh": hold_deit_twin(fresh, BATCH, seed=16),
            "batch_1_trained": hold_deit_twin(trained.eval(), 1, seed=18)}


def hold_deit_twin(model, n: int, seed: int) -> dict:
    """``n`` images of a seed through ``model``'s bf16 fused-block twin,
    held against that twin on the plain block and against ``model``."""
    from rovit_kan_tpu_torch.ops.block_kernel import plain_vit_block
    from rovit_kan_tpu_torch.ops.preprocess import eval_batch
    twin = model.twin(torch.bfloat16, use_fused_block=True)
    x = eval_batch(torch.from_numpy(uint8_batch(seed, n, BASELINE_SIZE))
                   .cuda())
    reset, read = all_counters()

    def outputs(m):
        with torch.inference_mode():
            out = m(x)
        probs = torch.softmax(out["cls_logits"].float(), -1)
        return {"features": out["features"].float().cpu().numpy(),
                "cls_probs": probs.cpu().numpy(),
                "cls_pred": probs.argmax(-1).cpu().numpy()}

    torch.cuda.synchronize()
    reset()
    served = outputs(twin)
    torch.cuda.synchronize()
    only(read(), vit_block_fwd=12)
    blocks = twin.backbone.vit.blocks
    for b in blocks:
        b.block_fn = plain_vit_block
    plain = outputs(twin)
    exact = outputs(model)
    only(read(), vit_block_fwd=12)
    checks, failed = hold_served(served, plain, exact,
                                 keys=("features", "cls_probs"))
    if failed:
        raise RuntimeError(f"deit_tiny FPS twin out of tolerance at batch "
                           f"{n}: {failed}, {checks}")
    return checks


def baselines_phase(smi: str, root):
    """``cli.run_baselines --synthetic`` over the six baselines at 224 px,
    the DeiT FPS twin held, one profiled train step a model (module
    docstring, phase 16)."""
    from rovit_kan_tpu_torch.cli import run_baselines as cli_baselines
    from rovit_kan_tpu_torch.experiments.baselines import BaselineExperiment

    reset, read = all_counters()
    out = root / "baselines"
    argv = ["--data-root", root / "baselines_data", "--output-dir", out,
            "--synthetic", "--models", *BASELINE_MODELS,
            "--image-size", BASELINE_SIZE, "--batch-size", BASELINE_BATCH,
            "--epochs", 1, "--n-per-class", BASELINE_PER_CLASS]
    per_model, trained = {}, {}
    real = BaselineExperiment.run_single
    real_fps = BaselineExperiment._fps_step

    def counted(self, name):
        torch.cuda.synchronize()
        before, t0 = read(), time.perf_counter()
        result = real(self, name)
        torch.cuda.synchronize()
        after = read()
        per_model[name] = {"launches": {k: after[k] - before[k]
                                        for k in after},
                           "seconds": time.perf_counter() - t0,
                           "train_images": BASELINE_BATCH * len(
                               self.train_loader)}
        return result

    def kept(self, name, model):
        trained[name] = model                 # the trained model it times
        return real_fps(self, name, model)

    BaselineExperiment.run_single = counted
    BaselineExperiment._fps_step = kept
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            exp = cli_baselines.main([str(a) for a in argv])
    finally:
        BaselineExperiment.run_single = real
        BaselineExperiment._fps_step = real_fps
    torch.cuda.synchronize()
    seconds, launches = time.perf_counter() - t0, read()
    log = printed.getvalue()
    missing = [n for n in BASELINE_MODELS
               if not (out / f"{n}_metrics.json").exists()
               or n not in per_model]
    if missing:
        raise RuntimeError(f"baselines missing {missing}: {log[-3000:]}")
    readings = {}
    for name in BASELINE_MODELS:
        m = json.loads((out / f"{name}_metrics.json").read_text())
        fps = check_fps(name, m)
        bad = [k for k in BASELINE_METRICS
               if not (m.get(k) is not None and np.isfinite(m[k]))]
        if bad or m["params"] != BASELINE_PARAMS[name]:
            raise RuntimeError(f"{name}: metrics {m}")
        want = ({"vit_block_fwd": 12 * FPS_FORWARDS}
                if name == "deit_tiny" else {})
        only(per_model[name]["launches"], **want)
        train_s = m["train_time_s"]
        readings[name] = {
            "train_seconds": train_s,
            "first_epoch_images_per_sec":
                per_model[name]["train_images"] / train_s,
            "fps_bs1": fps, "seconds": per_model[name]["seconds"],
            "accuracy": m["accuracy"], "temperature": m["temperature"],
            "params": m["params"]}
    only(launches, vit_block_fwd=12 * FPS_FORWARDS)
    rows = (out / "baseline_comparison.csv").read_text().splitlines()
    accs = [float(r.split(",")[1]) for r in rows[1:]]
    if not (len(rows) == 7 and accs == sorted(accs, reverse=True)
            and {r.split(",")[0] for r in rows[1:]} == set(BASELINE_MODELS)):
        raise RuntimeError(f"baseline CSV: {rows}")

    # Warm train steps timed, then one profiled, a model, on a batch of the
    # phase's shape.
    cfg = exp.config
    probe = BaselineExperiment(cfg, None, None, None, out, device="cuda")
    rng = np.random.RandomState(17)
    batch = {"images": torch.from_numpy(uint8_batch(17, BASELINE_BATCH,
                                                    BASELINE_SIZE)).cuda(),
             "labels": torch.from_numpy(rng.randint(0, 4, BASELINE_BATCH))
             .cuda(),
             "valid": torch.ones(BASELINE_BATCH).cuda()}
    for name in BASELINE_MODELS:
        step, _, _ = probe._make_steps(probe.build_model(name))
        reset()
        for _ in range(2):                    # first calls pick algorithms
            step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BASELINE_TIMED_STEPS):
            step(batch)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / BASELINE_TIMED_STEPS
        readings[name]["train_step_ms"] = step_s * 1e3
        readings[name]["train_images_per_sec"] = BASELINE_BATCH / step_s
        readings[name]["train_step_profile"] = profile_step(
            lambda: step(batch))
        only(read())
    held = hold_baseline_twin(probe, trained["deit_tiny"])
    return {"phase": "baselines", "models": list(BASELINE_MODELS),
            "config": f"{BASELINE_SIZE}px, batch {BASELINE_BATCH}, 1 epoch, "
                      f"fp32; "
                      f"synthetic trees of 4 x {BASELINE_PER_CLASS} "
                      f"augmented and 4 x {BASELINE_PER_CLASS // 2} test "
                      f"images",
            "seconds": seconds, "launches": launches,
            "launches_by_model": {n: per_model[n]["launches"]
                                  for n in BASELINE_MODELS},
            "readings": readings, "deit_twin_held": held,
            "csv_rows": len(rows) - 1, "card": smi}


PRETRAINED_SEED = 19
MOE_EXPERTS = 8
MOE_PARAMS, DENSE_PARAMS = 18_142_234, 5_706_394
BACKBONE_PARAMS = 5_524_416
REMAT_STEPS = 3
TIMED_STEPS = 5           # warm train steps timed a model and turn


def reference_state_dict(cfg, seed: int) -> dict:
    """A reference-format ``model_state_dict`` at ``cfg``'s shapes (the
    port's state_dict in the reference layout, the patch embedding a
    ``(D, 3, p, p)`` convolution) with seeded numpy values: LayerNorm
    scales about 1, every other leaf N(0, 0.02^2)."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.utils.checkpoint import _to_reference
    shapes = _to_reference(build_model(cfg, inference=True, device="cpu")
                           .state_dict())
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in shapes.items():
        value = rng.normal(0, 0.02, tuple(v.shape)).astype(np.float32)
        if "norm" in k and k.endswith(".weight"):
            value += 1.0
        out[k] = value
    return out


def add_launches(*dicts) -> dict:
    return {k: sum(d[k] for d in dicts) for k in dicts[0]}


def recording_init_state(seen: list):
    """A context in which ``Trainer.init_state`` also keeps, in ``seen``,
    a CPU copy of the weights each fresh run starts from."""
    from rovit_kan_tpu_torch.training import trainer as trainer_mod
    init_state = trainer_mod.Trainer.init_state

    def recording(self, params=None):
        state = init_state(self, params)
        seen.append({k: v.detach().cpu().clone()
                     for k, v in state.params.items()})
        return state

    @contextlib.contextmanager
    def ctx():
        trainer_mod.Trainer.init_state = recording
        try:
            yield
        finally:
            trainer_mod.Trainer.init_state = init_state
    return ctx()


def pretrained_phase(smi: str, root):
    """Weight import on the card (module docstring, phase 17)."""
    from rovit_kan_tpu_torch.cli import convert_checkpoint as cli_convert
    from rovit_kan_tpu_torch.cli import train as cli_train
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.models import convert as tc
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.utils.checkpoint import _from_reference

    cfg, work = Config(), root / "pretrained"
    work.mkdir()
    ref = reference_state_dict(cfg, PRETRAINED_SEED)
    torch.save({"model_state_dict": {k: torch.from_numpy(v)
                                     for k, v in ref.items()},
                "epoch": 30}, work / "best_model.pth")
    prefix = "backbone.model."
    timm = {k[len(prefix):]: torch.from_numpy(v) for k, v in
            reference_state_dict(cfg, PRETRAINED_SEED + 1).items()
            if k.startswith(prefix)}
    rng = np.random.RandomState(PRETRAINED_SEED + 2)
    timm["head.weight"] = torch.from_numpy(
        rng.normal(0, 0.02, (1000, DIM)).astype(np.float32))
    timm["head.bias"] = torch.zeros(1000)
    torch.save(timm, work / "deit_tiny.pth")

    converted = {}
    for name, kind, n in (("best_model", "reference RoViTKAN", DENSE_PARAMS),
                          ("deit_tiny", "timm ViT backbone",
                           BACKBONE_PARAMS)):
        _, launches, secs, printed = run_cli(
            cli_convert.main, ["--input", work / f"{name}.pth", "--output",
                               work / f"{name}.npz"], all_counters)
        only(launches)
        want = f"Converted {kind}: {n:,} params -> {work / name}.npz"
        if printed.strip() != want:
            raise RuntimeError(f"convert_checkpoint printed {printed!r}, "
                               f"want {want!r}")
        converted[name] = {"seconds": secs, "printed": printed.strip()}
    # The reference file's weights, through the .npz and the port's key
    # map, are the reference state_dict bit for bit.
    flagship = build_model(cfg, inference=True, device="cpu")
    got = tc.jax_state_dict(flagship, tc.load_npz(work / "best_model.npz"))
    want = _from_reference({k: torch.from_numpy(v) for k, v in ref.items()})
    if got.keys() != want.keys() or not all(torch.equal(got[k], want[k])
                                            for k in want):
        raise RuntimeError("the converted reference .npz is not the "
                           "reference state_dict")

    # cli.train from the timm backbone: one epoch (2 steps, 1 validation
    # batch, 2 test batches and the bs=1 FPS forwards).
    argv = ["--data_root", root / "data", "--output_dir", work / "train",
            "--epochs", 1, "--batch_size", BATCH, "--pretrained_npz",
            work / "deit_tiny.npz", "--devices", 1]
    seen = []
    with recording_init_state(seen):
        metrics, train_launches, train_s, printed = run_cli(
            cli_train.main, argv, all_counters)
    steps, vals, tests = 2, 1, 2
    only(train_launches, vit_block_fwd=12 * (steps + vals + tests
                                             + FPS_FORWARDS),
         vit_block_bwd=12 * steps, augment=steps)
    if len(seen) != 1 or "Loading pretrained weights" not in printed:
        raise RuntimeError(f"cli.train made {len(seen)} fresh starts")
    args = cli_train.parse_args([str(a) for a in argv])
    init_model = build_model(cli_train.build_config(args), device="cpu",
                             seed=args.seed)
    init = tc.to_jax_params(init_model)
    merged = tc.jax_state_dict(init_model, tc.merge_pretrained(
        init, tc.load_npz(work / "deit_tiny.npz"), verbose=False))
    differ = [k for k, v in merged.items() if not torch.equal(seen[0][k], v)]
    if differ or seen[0].keys() != merged.keys():
        raise RuntimeError(f"cli.train did not start from the merged "
                           f"weights: {differ[:5]}")
    backbone = _from_reference({prefix + k: v for k, v in timm.items()
                                if not k.startswith("head.")})
    from_npz = [k for k in merged if k in backbone
                and torch.equal(merged[k], backbone[k])]
    if len(from_npz) != sum(k.startswith(prefix) for k in merged):
        raise RuntimeError("a backbone leaf kept its init")

    best = work / "train" / "checkpoints" / "best_model"
    engine = load_engine(best, batch_size=BATCH, device="cuda")
    reset, read = all_counters()
    images = uint8_batch(70, BATCH, cfg.data.image_size)
    torch.cuda.synchronize()
    reset()
    served = engine.predict(images)
    serve_launches = read()
    only(serve_launches, vit_block_fwd=12)
    if not (np.isfinite(served["cls_probs"]).all() and np.allclose(
            served["cls_probs"].sum(-1), 1.0, atol=1e-5)):
        raise RuntimeError("pretrained model served non-finite outputs")
    return {"phase": "pretrained", "model": "DeiT-Tiny RoViT-KAN d=192 "
            "depth=12 heads=3 224px bf16, batch 64: a reference-format "
            "best_model.pth and a timm backbone state_dict (seeded numpy at "
            "the flagship's shapes) through cli.convert_checkpoint, "
            "cli.train --pretrained_npz (timm) for 1 epoch, load_engine",
            "converted": converted,
            "start_weights": {"merged_bit_for_bit": True,
                              "leaves_from_npz": len(from_npz),
                              "leaves_kept_at_init":
                                  len(merged) - len(from_npz)},
            "train_cli": {"seconds": train_s, "launches": train_launches,
                          "test_accuracy": metrics["accuracy"],
                          "fps_bs1": check_fps("pretrained train CLI",
                                               metrics)},
            "serve_launches": serve_launches,
            "launches": add_launches(train_launches, serve_launches),
            "card": smi}


def moe_layer_checks(seed: int = 21) -> dict:
    """One flagship MoE layer (D 192, H 768, E 8, capacity 50 of 197) on
    the same fp32 input (64, 197, 192) and weights on the card and on the
    CPU, in fp32 and in bf16: the chosen token sets exactly equal (routing
    runs in fp32 in both), the outputs within 1e-4 of their largest
    magnitude in fp32 (sums of up to 768 terms in another order) and within
    two bf16 ulps of it in bf16 (``bf16_tol``: both round the FFN's operands
    at the same points and sum in fp32)."""
    from rovit_kan_tpu_torch.models.moe import MoEMlp, expert_capacity, route
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.normal(0, 1, (BATCH, TOKENS, DIM))
                         .astype(np.float32))
    weights = {"w1": rng.normal(0, DIM ** -0.5, (MOE_EXPERTS, DIM, HIDDEN)),
               "b1": rng.normal(0, 0.02, (MOE_EXPERTS, HIDDEN)),
               "w2": rng.normal(0, HIDDEN ** -0.5, (MOE_EXPERTS, HIDDEN, DIM)),
               "b2": rng.normal(0, 0.02, (MOE_EXPERTS, DIM)),
               "gate.weight": rng.normal(0, DIM ** -0.5, (MOE_EXPERTS, DIM))}
    C = expert_capacity(TOKENS, MOE_EXPERTS, 2.0)
    out = {"capacity": C}
    for dtype in (torch.float32, torch.bfloat16):
        runs = {}
        for dev in ("cpu", "cuda"):
            layer = MoEMlp(DIM, HIDDEN, MOE_EXPERTS, 2.0, dtype)
            layer.load_state_dict({k: torch.from_numpy(v.astype(np.float32))
                                   for k, v in weights.items()})
            layer.to(dev)
            with torch.no_grad():
                xd = x.to(dev)
                idx = route(xd, layer.gate.weight, C)[0]
                runs[dev] = (idx.sort(-1).values.cpu(),
                             layer(xd).float().cpu())
                torch.cuda.synchronize()
        (ci, co), (gi, go) = runs["cpu"], runs["cuda"]
        tol = (FP32_TOL * float(co.abs().max()) if dtype == torch.float32
               else bf16_tol(co))
        err = float((go - co).abs().max())
        name = str(dtype).replace("torch.", "")
        out[name] = {"sets_equal": bool(torch.equal(ci, gi)),
                     "max_abs_err": err, "tolerance": tol,
                     "max_abs_out": float(co.abs().max())}
        if not torch.equal(ci, gi) or not err <= tol:
            raise RuntimeError(f"MoE layer ({name}) on the card: {out[name]}")
    return out


def record_routing(model):
    """Forward hooks on each MoE layer of ``model`` that keep, in the
    returned dict, its chosen token indices (sorted per expert) of the last
    call; and the hooks' handles."""
    from rovit_kan_tpu_torch.models.moe import MoEMlp, expert_capacity, route
    chosen, handles = {}, []

    def hook(name):
        def fn(mod, args, out):
            x = args[0]
            C = expert_capacity(x.shape[1], mod.num_experts,
                                mod.capacity_factor)
            chosen[name] = route(x, mod.gate.weight, C)[0].sort(-1) \
                .values.cpu()
        return fn

    for name, mod in model.named_modules():
        if isinstance(mod, MoEMlp):
            handles.append(mod.register_forward_hook(hook(name)))
    return chosen, handles


def selection_flips(a: dict, b: dict, tokens: int) -> dict:
    """Per MoE layer, the token-expert selections in ``a`` that ``b`` does
    not make (each is one token that one expert took in one run and not in
    the other)."""
    out = {}
    for name, ia in a.items():
        ma = torch.zeros(*ia.shape[:2], tokens, dtype=torch.bool)
        mb = torch.zeros_like(ma)
        ma.scatter_(-1, ia, True)
        mb.scatter_(-1, b[name], True)
        out[name] = int((ma & ~mb).sum())
    return out


def moe_steps(cfg, batches, remat: bool):
    """``len(batches)`` stage-4 steps of the MoE flagship from the seed-0
    weights (mixing on, the step's own seeded generators) with
    ``tpu.remat_backbone=remat``: the losses, each step's gradients, the
    step ms, the peak device memory and the blocks remat recomputed."""
    from rovit_kan_tpu_torch.models import vit
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    cfg = copy.deepcopy(cfg)
    cfg.tpu.remat_backbone = remat
    model = build_model(cfg, device="cuda", seed=0)
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(0))
    calls = []
    checkpoint = vit.checkpoint

    def counting(*args, **kw):
        calls.append(1)
        return checkpoint(*args, **kw)

    vit.checkpoint = counting
    losses, grads = [], []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for b in batches:
            losses.append(float(step(b, 4, 1.0, 1)["total_loss"]))
            grads.append({k: p.grad.detach().clone()
                          for k, p in zip(opt.names, opt.params)})
        torch.cuda.synchronize()
    finally:
        vit.checkpoint = checkpoint
    return {"losses": losses, "grads": grads,
            "step_ms": 1e3 * (time.perf_counter() - t0) / len(batches),
            "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20,
            "remat_calls": len(calls)}


def moe_attention_step(cfg, batch, draws, attn_fn=None, stage: int = 4):
    """One step at ``stage`` of the MoE flagship with
    ``use_pallas_attention`` forced, from the seed-0 weights with fixed
    draws, between a counter reset and a read; ``attn_fn`` replaces the MoE
    blocks' attention core. Returns the loss, the gradients and the
    launches."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    model = build_model(cfg, device="cuda", seed=0)
    blocks = model.backbone.model.blocks
    if [b.use_fused_block for b in blocks] != [i % 2 == 0
                                               for i in range(12)] \
            or not all(b.attn.use_fused for b in blocks):
        raise RuntimeError("forced attention: unexpected block policy")
    if attn_fn is not None:
        for b in blocks:
            b.attn.attn_fn = attn_fn
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(1))
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    m = step(batch, stage, 1.0, 1, draws=dict(
        draws, dropout=torch.Generator("cuda").manual_seed(2)))
    torch.cuda.synchronize()
    return {"loss": float(m["total_loss"]), "launches": read(),
            "grads": {k: p.grad.detach().clone()
                      for k, p in zip(opt.names, opt.params)}}


def leaf_gaps(a: dict, b: dict) -> dict:
    """Each parameter's gradient distance ``|a - b|`` over ``|b|``."""
    return {n: float((g - b[n]).norm()) / max(float(b[n].norm()), 1e-30)
            for n, g in a.items()}


def timed_steps(model, cfg, batches, profile: bool = False):
    """ms per train step of ``model`` over ``batches`` after one warm-up
    step (stage 4, mixing on), and with ``profile`` one more step's
    ``profile_step`` (else None)."""
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    opt = build_optimizer(model, cfg)
    step = make_train_step(model, opt, cfg,
                           generator=torch.Generator("cuda").manual_seed(0))
    step(batches[0], 4, 1.0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        step(b, 4, 1.0, 1)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    return ms, (profile_step(lambda: step(batches[0], 4, 1.0, 1))
                if profile else None)


def moe_phase(smi: str, root):
    """The expert-choice MoE flagship on the card (module docstring, phase
    18)."""
    from rovit_kan_tpu_torch.cli import evaluate as cli_evaluate
    from rovit_kan_tpu_torch.cli import train as cli_train
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.evaluation.evaluator import \
        load_model_for_evaluation
    from rovit_kan_tpu_torch.models.rovit_kan import (
        build_model,
        count_parameters,
    )
    from rovit_kan_tpu_torch.ops import attention as at
    from rovit_kan_tpu_torch.ops import augment_kernel as ak
    from rovit_kan_tpu_torch.ops import block_kernel as bk
    from rovit_kan_tpu_torch.ops.mixing import draw_mix
    from rovit_kan_tpu_torch.serving import InferenceEngine, load_engine

    cfg, work = Config(), root / "moe"
    cfg.model.moe_experts = MOE_EXPERTS
    work.mkdir()
    layer = moe_layer_checks()

    # Train, evaluate and serve through the CLIs and load_engine: 6 #1 a
    # forward (the dense blocks 0, 2, ..., 10), 6 #2 and one #7 a step.
    steps, vals, tests = 2, 1, 2
    metrics, train_launches, train_s, _ = run_cli(cli_train.main, [
        "--data_root", root / "data", "--output_dir", work / "train",
        "--epochs", 1, "--batch_size", BATCH, "--moe_experts", MOE_EXPERTS,
        "--devices", 1], all_counters)
    only(train_launches, vit_block_fwd=6 * (steps + vals + tests
                                            + FPS_FORWARDS),
         vit_block_bwd=6 * steps, augment=steps)
    best = work / "train" / "checkpoints" / "best_model"
    ev, eval_launches, eval_s, _ = run_cli(cli_evaluate.main, [
        "--checkpoint", best, "--data_root", root / "data", "--output_dir",
        work / "eval", "--batch_size", BATCH, "--calibrate",
        "--device_metrics", "off"], all_counters)
    only(eval_launches, vit_block_fwd=6 * (1 + tests + FPS_FORWARDS))
    engine = load_engine(best, batch_size=BATCH, device="cuda")
    model = engine.model
    if count_parameters(model)["total"] != MOE_PARAMS:
        raise RuntimeError(f"MoE flagship has {count_parameters(model)}")
    engine.warmup()
    size = cfg.data.image_size
    batches = [uint8_batch(80 + i, BATCH, size) for i in range(3)]
    reset, read = all_counters()
    chosen, handles = record_routing(model)
    torch.cuda.synchronize()
    reset()
    outs = [engine.predict(b) for b in batches]
    serve_launches = read()
    only(serve_launches, vit_block_fwd=6 * len(batches))
    for out in outs:
        if not all(np.isfinite(v).all() for v in out.values()):
            raise RuntimeError("MoE model served non-finite outputs")

    # The served batch against the same weights through the plain block
    # and in fp32; how many token-expert selections the paths part on.
    served = engine.predict(batches[0])
    routes = {"kernels": dict(chosen)}
    served["features"] = features(model, batches[0])
    for b in model.backbone.model.blocks:
        b.block_fn = bk.plain_vit_block
    plain = engine.predict(batches[0])
    routes["plain"] = dict(chosen)
    plain["features"] = features(model, batches[0])
    for b in model.backbone.model.blocks:
        b.block_fn = bk.fused_vit_block
    for h in handles:
        h.remove()
    model32, _ = load_model_for_evaluation(best, device="cuda",
                                           dtype=torch.float32)
    chosen32, handles = record_routing(model32)
    exact = InferenceEngine(model32, batch_size=BATCH,
                            device="cuda").predict(batches[0])
    routes["fp32"] = dict(chosen32)
    exact["features"] = features(model32, batches[0])
    for h in handles:
        h.remove()
    checks, failed = hold_served(served, plain, exact)
    total = (len(routes["kernels"]) * BATCH * MOE_EXPERTS
             * layer["capacity"])
    flips = {"kernels_vs_plain": selection_flips(
                 routes["kernels"], routes["plain"], TOKENS),
             "kernels_vs_fp32": selection_flips(
                 routes["kernels"], routes["fp32"], TOKENS),
             "plain_vs_fp32": selection_flips(
                 routes["plain"], routes["fp32"], TOKENS),
             "selections_per_path": total}
    if failed:
        emit({"phase": "moe", "outputs": checks, "selection_flips": flips})
        raise RuntimeError(f"MoE served outputs out of tolerance: {failed}")

    # The MoE model's torch.export artifact: 6 #1 nodes and launches a call
    # (the dense blocks), the MoE blocks plain; the engine's bits.
    exported = export_case(
        "moe", model, engine, batches[0], (reset, read),
        ("vit_block_fwd", 6),
        {"vit_block_fwd": 6, "attention_fwd": 0, "kan_module_fwd": 0}, work,
        engine.temperature)

    # Remat on and off: the same losses and gradients, bit for bit.
    train_cfg = copy.deepcopy(cfg)
    step_batches = [train_batch(train_cfg, 400 + i)
                    for i in range(REMAT_STEPS)]
    remat = {on: moe_steps(train_cfg, step_batches, on)
             for on in (False, True)}
    same = remat[False]["losses"] == remat[True]["losses"] and all(
        torch.equal(g, b[k]) for a, b in zip(remat[False]["grads"],
                                             remat[True]["grads"])
        for k, g in a.items())
    remat_out = {k: {"losses": r["losses"], "step_ms": r["step_ms"],
                     "peak_mib": r["peak_mib"],
                     "blocks_recomputed": r["remat_calls"]}
                 for k, r in (("off", remat[False]), ("on", remat[True]))}
    if not same or remat[True]["remat_calls"] != 6 * REMAT_STEPS \
            or remat[False]["remat_calls"]:
        again = moe_steps(train_cfg, step_batches, False)
        remat_out["off_again_same"] = again["losses"] == \
            remat[False]["losses"]
        emit({"phase": "moe", "remat": remat_out})
        raise RuntimeError("remat on and off differ")
    del remat

    # One step with the attention kernels forced: #5/#6 in the 6 MoE
    # blocks, #1/#2 in the dense ones; against #6's plain version (the
    # same forward launches, so the same loss bits, and each parameter's
    # gradient within 5e-2 of its L2 norm, hold_attention_step's rule), and
    # readings against plain attention forward and backward, at stage 4 and
    # at stage 3 (without the KAN loss, which makes the stage-4 gradient
    # ill-conditioned at these weights; hold_train_step).
    attn_cfg = copy.deepcopy(cfg)
    attn_cfg.tpu.use_pallas_attention = True
    draws = {"factors": ak.draw_factors(
                 torch.Generator("cuda").manual_seed(3), BATCH),
             "mix": draw_mix(torch.Generator().manual_seed(4), BATCH, size,
                             size)}
    k = moe_attention_step(attn_cfg, step_batches[0], draws)
    only(k["launches"], vit_block_fwd=6, vit_block_bwd=6, attention_fwd=6,
         attention_bwd=6, augment=1)
    kp = moe_attention_step(attn_cfg, step_batches[0], draws,
                            _kernel_fwd_plain_bwd_attention)
    only(kp["launches"], vit_block_fwd=6, vit_block_bwd=6, attention_fwd=6,
         augment=1)
    leaf = leaf_gaps(k["grads"], kp["grads"])
    worst = max(leaf, key=leaf.get)
    attention = {"launches": k["launches"], "loss": k["loss"],
                 "loss_plain_bwd": kp["loss"], "tolerance": 5e-2,
                 "worst_leaf": worst, "worst_rel": leaf[worst],
                 "median_leaf_rel": float(np.median(list(leaf.values()))),
                 "plain_attention": {}}
    for stage in (4, 3):
        ks = k if stage == 4 else moe_attention_step(
            attn_cfg, step_batches[0], draws, stage=stage)
        pa = moe_attention_step(attn_cfg, step_batches[0], draws,
                                at.plain_attention, stage)
        only(pa["launches"], vit_block_fwd=6, vit_block_bwd=6, augment=1)
        plain_leaf = leaf_gaps(ks["grads"], pa["grads"])
        attention["plain_attention"][f"stage{stage}"] = {
            "loss_kernels": ks["loss"], "loss_plain": pa["loss"],
            "median_leaf_rel": float(np.median(list(plain_leaf.values()))),
            "max_leaf_rel": max(plain_leaf.values())}
    if k["loss"] != kp["loss"] or not leaf[worst] <= 5e-2:
        emit({"phase": "moe", "attention_step": attention})
        raise RuntimeError("MoE attention step out of tolerance")
    attention_launches = k["launches"]
    del k, kp, ks, pa

    # Against the dense flagship, in turns (dense, moe, moe, dense): train
    # step ms at batch 64, served img/s and bs=1 FPS; one profiled step of
    # each.
    dense_cfg = Config()
    timed = [train_batch(dense_cfg, 500 + i) for i in range(TIMED_STEPS)]
    speed, profiles = {"dense": [], "moe": []}, {}
    for name in ("dense", "moe", "moe", "dense"):
        c = cfg if name == "moe" else dense_cfg
        m = build_model(c, device="cuda", seed=0)
        step_ms, prof = timed_steps(m, c, timed, name not in profiles)
        if prof is not None:
            profiles[name] = prof
        rates = served_rates(build_model(c, inference=True, device="cuda",
                                         seed=0))
        speed[name].append({"step_ms": step_ms,
                            "train_images_per_sec": 1e3 * BATCH / step_ms,
                            **rates})
    return {"phase": "moe", "model": "DeiT-Tiny RoViT-KAN d=192 depth=12 "
            "heads=3 224px bf16, moe_experts=8 every 2nd block (1, 3, ..., "
            "11), capacity factor 2 (50 of 197 tokens an expert), batch 64",
            "parameters": {"moe": MOE_PARAMS, "dense": DENSE_PARAMS},
            "layer": layer,
            "train_cli": {"seconds": train_s, "launches": train_launches,
                          "test_accuracy": metrics["accuracy"],
                          "fps_bs1": check_fps("MoE train CLI", metrics)},
            "evaluate_cli": {"seconds": eval_s, "launches": eval_launches,
                             "temperature": ev.temperature},
            "serve_launches": serve_launches,
            "held_vs_plain_block": checks, "selection_flips": flips,
            "export": exported,
            "remat": remat_out, "attention_step": attention,
            "speed_in_turns": speed, "train_step_profiles": profiles,
            "launches": add_launches(train_launches, eval_launches,
                                     serve_launches, exported["launches"],
                                     attention_launches),
            "card": smi}



NATIVE_SHAPES = (((384, 384), 224), ((100, 100), 224), ((333, 500), 224),
                 ((1, 57), 224))
HOST_PIPELINE_IMAGES = 2000   # halved from 4,000: the smoke's time limit


def native_phase(smi: str, root):
    """The C++ resize engine built with g++ on the card's host, its bits
    against ``data/resize.py``, and ``cli.bench_host_pipeline`` at 2,000
    images, the engine and the numpy copy in turns, twice (module
    docstring, phase 19)."""
    from rovit_kan_tpu_torch import native
    from rovit_kan_tpu_torch.cli import bench_host_pipeline
    from rovit_kan_tpu_torch.data.resize import resize_image

    native.library_path().unlink(missing_ok=True)
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(19)
    checked = 0
    for hw, size in NATIVE_SHAPES:
        images = [rng.randint(0, 256, (*hw, 3)).astype(np.uint8)
                  for _ in range(4)]
        for threads in (1, 2, 8):
            got = native.resize_batch(images, size, n_threads=threads)
            for g, im in zip(got, images):
                if not np.array_equal(g, resize_image(im, size)):
                    raise RuntimeError(f"native resize {hw} -> {size} at "
                                       f"{threads} threads differs from "
                                       f"data/resize.py")
                checked += 1
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rec = bench_host_pipeline.main([
            "--scales", str(HOST_PIPELINE_IMAGES), "--rounds", "2",
            "--workers", str(os.cpu_count() or 1),
            "--out", str(root / "host_pipeline.json")])
    bench_s = time.perf_counter() - t0
    build = rec[f"cache_build_{HOST_PIPELINE_IMAGES}"]
    for rnd in build["rounds"]:
        for arm in ("engine", "numpy"):
            if rnd[arm]["n_images"] != HOST_PIPELINE_IMAGES:
                raise RuntimeError(f"host pipeline {arm}: {rnd[arm]}")
    return {"phase": "native", "library": lib.name, "build_seconds": build_s,
            "images_held": checked, "bench_seconds": bench_s,
            "host_cpus": rec["host_cpus"],
            "affinity_cpus": rec["affinity_cpus"],
            "micro_resize": rec["micro_resize"],
            "tree_write_s": build["tree_write_s"],
            "cache_build": build["rounds"], "card": smi}



DP_RANKS = 2
DP_STEPS = 3
DP_STAGES = (3, 4)
DP_PER_CLASS = 40         # 160 images: 128 train (2 steps), 32 validation
DP_TIMEOUT = 600


def dp_config(root):
    """The flagship ``Config()`` at batch 64 for the two-epoch fit: stage
    1 then 2, the backbone frozen in epoch 1."""
    from rovit_kan_tpu_torch.config import Config
    cfg = Config()
    cfg.train.batch_size = BATCH
    cfg.train.epochs = 2
    cfg.train.stage_1_epochs, cfg.train.stage_2_epochs = 1, 2
    cfg.flags.freeze_backbone_epochs = 1
    cfg.paths.checkpoints_dir = Path(root) / "fit" / "checkpoints"
    return cfg


def memory_base(dev) -> int:
    """The bytes allocated on ``dev`` now, its peak counter reset, so that
    ``max_memory_allocated(dev)`` less this is what follows takes."""
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def state_bytes(net, opt, ema) -> dict:
    """A rank's training state: parameters, AdamW moments, EMA."""
    def size(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)
    return {"params": size(net.state_dict().values()),
            "mu": size([opt.mu]), "nu": size([opt.nu]),
            "ema": size(ema.values()) if ema else 0}


def dp_steps(mesh, stage: int, fp32: bool = False, fsdp: bool = False,
             route: bool = False, moe: bool = False):
    """``DP_STEPS`` flagship steps at ``stage`` with mixing on, bf16 (or
    the fp32 model with ``fp32``), from the seed-0 weights on the global
    batches ``train_batch(cfg, 300 + i)``: each step's loss, accuracy and
    (all-reduced) flat gradient, the flat parameters after the last, the
    launches, the steps' wall ms and the card's peak memory above what was
    allocated before, the EMA on. With ``fsdp`` the steps run under
    ``parallel.fsdp.FSDP``: the gradients and parameters are gathered
    whole in the one-process layout on rank 0 (None on the other ranks),
    and each rank's state bytes sit beside ``sharded_size`` and the
    replicated figure. ``route``: the tensor-parallel block's route in one
    process, the blocks unfused and their attention core through #5/#6.
    ``moe``: the MoE flagship (``MOE_EXPERTS`` experts in every second
    block), the one-process step the "ep" ranks are held against."""
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.parallel.fsdp import (
        FSDP,
        fsdp_param_specs,
        sharded_size,
    )
    from rovit_kan_tpu_torch.parallel.mesh import replicate
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    cfg = Config()
    cfg.flags.mixed_precision = not fp32
    cfg.train.ema_decay = 0.999      # the EMA's bytes in both memories
    if moe:
        cfg.model.moe_experts = MOE_EXPERTS
    if route:
        cfg.tpu.use_pallas_block, cfg.tpu.use_pallas_attention = False, True
    dev = "cuda" if mesh is None else mesh.device
    base = memory_base(dev)
    model = build_model(cfg, device=dev, seed=0)
    replicate(model, mesh)           # rank 0's weights, as Trainer does
    out = {"loss": [], "accuracy": [], "grads": [], "ms": []}
    if fsdp:
        specs = fsdp_param_specs(model, mesh)
        out["sharded_size"] = sharded_size(model, specs, mesh)
        out["replicated_bytes"] = sharded_size(model, {}, mesh)
        out["sharded_leaves"] = sum(d is not None for d in specs.values())
        net = FSDP(model, mesh, specs)
    else:
        net = model
    opt = build_optimizer(net, cfg)
    step = make_train_step(net, opt, cfg,
                           generator=torch.Generator(dev).manual_seed(0),
                           mesh=mesh)

    def whole(flat):
        return (net.gather_flat(flat) if fsdp
                else flat.detach().cpu().clone())

    batches = [{k: v.to(dev) for k, v in train_batch(cfg, 300 + i).items()}
               for i in range(DP_STEPS)]
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    for b in batches:
        t0 = time.perf_counter()
        m = step(b, stage, 1.0, 1)
        out["loss"].append(float(m["total_loss"]))
        torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["accuracy"].append(float(m["accuracy"]))
        out["grads"].append(whole(opt.grad))
    out["launches"] = read()
    out["params"] = whole(opt.flat)
    if fsdp:
        out["names"] = net.full_order()
        out["sizes"] = [int(np.prod(net.shapes[k])) for k in out["names"]]
        out["state_bytes"] = state_bytes(net, opt, step.ema)
        out["peak_live_units"] = net.peak_live
    else:
        out["names"], out["sizes"] = list(opt.names), list(opt._sizes)
    out["peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    return out


def dp_fit(mesh, root):
    """A two-epoch ``Trainer.fit`` of the flagship over the sharded cache,
    the temperature fitted on its validation cache (rank 0's T on every
    rank), then ``load_engine`` on its ``best_model`` serving one batch."""
    from rovit_kan_tpu_torch.data.dataset import Subset
    from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
    from rovit_kan_tpu_torch.evaluation.evaluator import Evaluator
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from rovit_kan_tpu_torch.utils.checkpoint import update_meta
    cfg = dp_config(root)
    leaves = LeafSet(DP_PER_CLASS, 224, seed=20)
    order = np.random.RandomState(20).permutation(len(leaves))
    train = DeviceLoader(Subset(leaves, order[:128]), BATCH, shuffle=True,
                         drop_last=True, seed=0, mesh=mesh, shard_data=True)
    val = DeviceLoader(Subset(leaves, order[128:]), BATCH, mesh=mesh,
                       shard_data=True)
    tr = Trainer(build_model(cfg, device=mesh.device, seed=1), train, val,
                 cfg, seed=0, mesh=mesh)
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    res = tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read()
    params = tr.optimizer.flat.detach().cpu().clone()
    epochs = len(res["history"]["train"])
    steps, vals = epochs * len(train), epochs * len(val)
    only(launches, vit_block_fwd=12 * (steps + vals),
         vit_block_bwd=12 * steps, augment=steps)
    best = cfg.paths.checkpoints_dir / "best_model"
    evaluator = Evaluator(tr.model, tr.eval_params(res["best_state"]), val,
                          cfg, output_dir=Path(root) / "fit" / "results")
    reset()
    temperature = evaluator.fit_temperature(val)
    only(read(), vit_block_fwd=12 * len(val))
    update_meta(best, temperature=temperature)
    engine = load_engine(best, device=mesh.device)
    if engine.temperature != temperature:
        raise RuntimeError(f"dp load_engine serves T {engine.temperature}, "
                           f"the fit gave {temperature}")
    reset()
    served = engine.predict(uint8_batch(21, BATCH))
    only(read(), vit_block_fwd=12)
    probs = served["cls_probs"]
    if not np.isfinite(probs).all() or probs.shape != (BATCH, 4):
        raise RuntimeError(f"dp load_engine: {probs}")
    return {"history": {p: [{k: m[k] for k in ("total_loss", "accuracy")}
                            for m in res["history"][p]]
                        for p in ("train", "val")},
            "fit_seconds": fit_s, "launches": launches,
            "steps": steps, "val_batches": vals,
            "shard_rows": int(train.rows_per_shard),
            "temperature": temperature, "params": params, "served": probs}


def fsdp_fit(mesh, root):
    """``dp_fit``'s two-epoch fit under FSDP (``Trainer(fsdp=True)``): its
    launches, its history, the best state's parameters whole on rank 0
    (None on the others) and its ``best_model``."""
    from rovit_kan_tpu_torch.data.dataset import Subset
    from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.trainer import Trainer
    cfg = dp_config(Path(root) / "fsdp")
    leaves = LeafSet(DP_PER_CLASS, 224, seed=20)
    order = np.random.RandomState(20).permutation(len(leaves))
    train = DeviceLoader(Subset(leaves, order[:128]), BATCH, shuffle=True,
                         drop_last=True, seed=0, mesh=mesh, shard_data=True)
    val = DeviceLoader(Subset(leaves, order[128:]), BATCH, mesh=mesh,
                       shard_data=True)
    tr = Trainer(build_model(cfg, device=mesh.device, seed=1), train, val,
                 cfg, seed=0, mesh=mesh, fsdp=True)
    if tr.fsdp is None:
        raise RuntimeError("fsdp fit: the trainer did not shard")
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    res = tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read()
    epochs = len(res["history"]["train"])
    steps, vals = epochs * len(train), epochs * len(val)
    only(launches, vit_block_fwd=12 * (steps + vals),
         vit_block_bwd=12 * steps, augment=steps)
    best = tr.fsdp.gather_full(tr.eval_params(res["best_state"]))
    return {"history": {p: [{k: m[k] for k in ("total_loss", "accuracy")}
                            for m in res["history"][p]]
                        for p in ("train", "val")},
            "fit_seconds": fit_s, "launches": launches, "steps": steps,
            "val_batches": vals, "best_params": best,
            "best_model": str(cfg.paths.checkpoints_dir / "best_model")}


FSDP_BASE_BATCH = 8       # the base preset's one step under DP and FSDP


def base_memory(mesh, fsdp: bool) -> dict:
    """One bf16 stage-4 step of the base preset (d = 768, 12 blocks, the
    plain block: the JAX rule trains d > 512 plain) at global batch
    ``FSDP_BASE_BATCH``, under data parallelism or FSDP: the step's ms,
    each rank's state bytes and the card's peak memory above what was
    allocated before."""
    from rovit_kan_tpu_torch.config import get_config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.parallel.fsdp import FSDP
    from rovit_kan_tpu_torch.parallel.mesh import replicate
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    cfg = get_config("base")
    dev = mesh.device
    base = memory_base(dev)
    model = build_model(cfg, device=dev, seed=0)
    if any(b.use_fused_block for b in model.backbone.model.blocks):
        raise RuntimeError("base preset: the fused block at d = 768")
    replicate(model, mesh)
    n_params = sum(p.numel() for p in model.parameters())
    net = FSDP(model, mesh) if fsdp else model
    opt = build_optimizer(net, cfg)
    step = make_train_step(net, opt, cfg,
                           generator=torch.Generator(dev).manual_seed(0),
                           mesh=mesh)
    batch = {k: v.to(dev) for k, v in
             train_batch(cfg, 400, FSDP_BASE_BATCH).items()}
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    loss = float(step(batch, 4, 1.0, 1)["total_loss"])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    only(read(), augment=1)
    if not np.isfinite(loss):
        raise RuntimeError(f"base preset step: loss {loss}")
    return {"params": n_params, "loss": loss, "step_ms": ms,
            "state_bytes": state_bytes(net, opt, step.ema),
            "peak_mib": (torch.cuda.max_memory_allocated(dev) - base)
            / 2**20}


TP_PARAM_BYTES = {"tiny": 12_176_488, "base": 175_988_584}
FSDP_TP_PARAM_BYTES = 6_139_112


def tp_steps(mesh, stage: int, sp: bool, fsdp: bool = False) -> dict:
    """``dp_steps``'s steps (the same seed-0 flagship, global batches and
    EMA) under tensor parallelism over the mesh's model axis
    (``parallel.tensor.TensorParallel``), with ``sp`` sequence parallelism
    too, with ``fsdp`` FSDP+TP: the losses, the gradients and parameters
    gathered whole in the one-process layout on rank 0 (None on the
    others), the launches, step ms and peak memory, each rank's replicated
    leaves and state bytes beside ``sharded_size``."""
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.parallel.fsdp import (
        FSDP,
        fsdp_param_specs,
        sharded_size,
    )
    from rovit_kan_tpu_torch.parallel.mesh import replicate
    from rovit_kan_tpu_torch.parallel.tensor import (
        TensorParallel,
        seq_sharding,
    )
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    cfg = Config()
    cfg.train.ema_decay = 0.999
    dev = mesh.device
    base = memory_base(dev)
    model = build_model(cfg, device=dev, seed=0,
                        act_sharding=seq_sharding(mesh) if sp else None)
    replicate(model, mesh)           # rank 0's weights, as Trainer does
    tp = TensorParallel(model, mesh)
    data_specs = fsdp_param_specs(tp, mesh, tp=True) if fsdp else {}
    net = FSDP(model, mesh, data_specs, tp=tp) if fsdp else tp
    opt = build_optimizer(net, cfg)
    step = make_train_step(net, opt, cfg,
                           generator=torch.Generator(dev).manual_seed(0),
                           mesh=mesh)
    batches = [{k: v.to(dev) for k, v in train_batch(cfg, 300 + i).items()}
               for i in range(DP_STEPS)]
    out = {"loss": [], "accuracy": [], "grads": [], "ms": []}
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    for b in batches:
        t0 = time.perf_counter()
        m = step(b, stage, 1.0, 1)
        out["loss"].append(float(m["total_loss"]))
        torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["accuracy"].append(float(m["accuracy"]))
        out["grads"].append(net.gather_flat(opt.grad))
    out["launches"] = read()
    out["params"] = net.gather_flat(opt.flat)
    whole = set(tp.model_sharded) | set(getattr(net, "shards", ()))
    out["replicated"] = {k: v.detach().cpu().clone()
                         for k, v in net.state_dict().items()
                         if k not in whole}
    out["state_bytes"] = state_bytes(net, opt, step.ema)
    out["sharded_size"] = sharded_size(tp, data_specs, mesh, tp.specs)
    out["replicated_bytes"] = sharded_size(tp, {}, mesh)
    out["names"] = net.full_order()
    out["sizes"] = [int(np.prod(tp.full_shapes[k])) for k in out["names"]]
    out["peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    return out


def tp_fit(mesh, root):
    """``dp_fit``'s two-epoch fit under TP + SP (the model built with
    ``act_sharding``, the ``Trainer`` on the 2-D mesh): its launches and
    history, the best state's parameters whole on rank 0 (None on the
    others) and its ``best_model``."""
    from rovit_kan_tpu_torch.data.dataset import Subset
    from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.parallel.tensor import seq_sharding
    from rovit_kan_tpu_torch.training.trainer import Trainer
    cfg = dp_config(Path(root) / "tp")
    leaves = LeafSet(DP_PER_CLASS, 224, seed=20)
    order = np.random.RandomState(20).permutation(len(leaves))
    train = DeviceLoader(Subset(leaves, order[:128]), BATCH, shuffle=True,
                         drop_last=True, seed=0, mesh=mesh, shard_data=True)
    val = DeviceLoader(Subset(leaves, order[128:]), BATCH, mesh=mesh,
                       shard_data=True)
    tr = Trainer(build_model(cfg, device=mesh.device, seed=1,
                             act_sharding=seq_sharding(mesh)),
                 train, val, cfg, seed=0, mesh=mesh)
    if tr.tp is None or not tr.tp.axis.seq:
        raise RuntimeError("tp fit: the trainer did not shard")
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    res = tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read()
    epochs = len(res["history"]["train"])
    steps, vals = epochs * len(train), epochs * len(val)
    only(launches, attention_fwd=12 * (steps + vals),
         attention_bwd=12 * steps, augment=steps)
    best = tr.sharded.gather_full(tr.eval_params(res["best_state"]))
    return {"history": {p: [{k: m[k] for k in ("total_loss", "accuracy")}
                            for m in res["history"][p]]
                        for p in ("train", "val")},
            "fit_seconds": fit_s, "launches": launches, "steps": steps,
            "val_batches": vals, "best_params": best,
            "best_model": str(cfg.paths.checkpoints_dir / "best_model")}


def tp_base(mesh, sp: bool) -> dict:
    """``base_memory``'s one bf16 step of the base preset (d = 768, 12
    heads, so the model axis divides them; the plain block and the plain
    attention core) under TP, or TP + SP: the step's ms, each rank's state
    bytes and the card's peak memory above what was allocated before."""
    from rovit_kan_tpu_torch.config import get_config
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.parallel.fsdp import sharded_size
    from rovit_kan_tpu_torch.parallel.mesh import replicate
    from rovit_kan_tpu_torch.parallel.tensor import (
        TensorParallel,
        seq_sharding,
    )
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    cfg = get_config("base")
    dev = mesh.device
    base = memory_base(dev)
    model = build_model(cfg, device=dev, seed=0,
                        act_sharding=seq_sharding(mesh) if sp else None)
    replicate(model, mesh)
    tp = TensorParallel(model, mesh)
    opt = build_optimizer(tp, cfg)
    step = make_train_step(tp, opt, cfg,
                           generator=torch.Generator(dev).manual_seed(0),
                           mesh=mesh)
    batch = {k: v.to(dev) for k, v in
             train_batch(cfg, 400, FSDP_BASE_BATCH).items()}
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    loss = float(step(batch, 4, 1.0, 1)["total_loss"])
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    only(read(), augment=1)
    if not np.isfinite(loss):
        raise RuntimeError(f"base preset tp step: loss {loss}")
    return {"loss": loss, "step_ms": ms,
            "state_bytes": state_bytes(tp, opt, step.ema),
            "sharded_size": sharded_size(tp, {}, mesh, tp.specs),
            "peak_mib": (torch.cuda.max_memory_allocated(dev) - base)
            / 2**20}


#: The taps' images under TP and TP + SP, and their holds against one
#: process (``tests/test_torch_explainability.py``'s: maps and tap 2e-5,
#: the tap's gradient 1e-4 of its largest). The rollout and Grad-CAM++
#: maps are held as ``tests/test_torch_tensor.py`` holds them: each equal
#: to its function of the rank's own (held) taps.
TAPS_BATCH = 8
TAPS_TOL = {"attention": 2e-5, "tap": 2e-5, "grad": 1e-4}


def tp_taps(mesh, sp: bool) -> dict:
    """The explainability taps of the fp32 flagship (seed 0, every weight
    moved by N(0, 0.05) from seed 7, so Grad-CAM++ is not the rounding
    noise of LayerNorm's identity init) on ``TAPS_BATCH`` images: first in
    one process on the model whole, then under ``TensorParallel`` over the
    mesh's model axis (``sp``: with sequence parallelism, 197 tokens padded
    to 198), through ``ViTAttentionRollout`` and ``GradCAMPlusPlus`` and
    ``gradcam_taps``. Each tap's largest gap to one process beside
    ``TAPS_TOL``; each map equal to ``attention_rollout`` or
    ``_cam_from_grads`` of the TP model's own taps, and its gaps to one
    process's map (largest, mean, and the pixels more than 1e-3 apart)
    reported: a min-max normalized Grad-CAM++ map can move far on a
    rounding-sized change of its taps."""
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.explainability.attention_maps import (
        ViTAttentionRollout,
        attention_rollout,
    )
    from rovit_kan_tpu_torch.explainability.gradcam import (
        GradCAMPlusPlus,
        _cam_from_grads,
        gradcam_taps,
    )
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.parallel.tensor import (
        TensorParallel,
        seq_sharding,
    )
    cfg = Config()
    cfg.flags.mixed_precision = False
    dev = mesh.device
    model = build_model(cfg, inference=True, device=dev, seed=0)
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.05, tuple(p.shape))
                                    .astype(np.float32)).to(dev))
    size = cfg.data.image_size
    x = torch.from_numpy(np.random.RandomState(8).normal(
        0, 1, (TAPS_BATCH, size, size, 3)).astype(np.float32)).to(dev)
    classes = torch.full((TAPS_BATCH,), -1, device=dev)

    def taps(net):
        with torch.no_grad():
            attention = net(x, return_attention=True)["attention"]
        tap, grad, idx = gradcam_taps(net, x, classes)
        return {"attention": attention, "tap": tap, "grad": grad,
                "idx": idx,
                "rollout": ViTAttentionRollout(net, device=dev).maps(x),
                "gradcam": GradCAMPlusPlus(net, device=dev).maps(x)}

    one = taps(model)
    t0 = time.perf_counter()
    got = taps(TensorParallel(model, mesh,
                              seq=seq_sharding(mesh) if sp else None))
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    if not torch.equal(got["idx"], one["idx"]):
        raise RuntimeError(f"tp taps ({'sp' if sp else 'tp'}): the "
                           f"predicted classes differ")
    gaps, failed = {}, []
    for k in (*TAPS_TOL, "rollout", "gradcam"):
        a, b = got[k].float(), one[k].float()
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"tp taps: {k} {tuple(a.shape)} against "
                               f"{tuple(b.shape)}, or non-finite")
        gap = (a - b).abs()
        gaps[k] = {"max_abs_err": float(gap.max())}
        if k in TAPS_TOL:
            scale = float(b.abs().max()) if k == "grad" else 1.0
            gaps[k]["tolerance"] = TAPS_TOL[k] * scale
            if not gaps[k]["max_abs_err"] <= gaps[k]["tolerance"]:
                failed.append(k)
        else:
            gaps[k].update(mean_abs_err=float(gap.mean()),
                           pixels_apart=int((gap > 1e-3).sum()),
                           pixels=gap.numel())
    own = {"rollout": attention_rollout(got["attention"], image_size=size),
           "gradcam": _cam_from_grads(got["tap"], got["grad"], size)}
    for k, want in own.items():
        gaps[k]["equal_to_own_taps"] = torch.equal(got[k], want)
        if not gaps[k]["equal_to_own_taps"]:
            failed.append(k)
    if failed:
        raise RuntimeError(f"tp taps ({'sp' if sp else 'tp'}): {failed} "
                           f"out of their holds: {gaps}")
    return {"gaps": gaps, "attention_shape": list(got["attention"].shape),
            "seconds": seconds}


def tp_worker(mesh, root) -> dict:
    """The "tp" phase on one rank of a data 1 x model 2 mesh."""
    t0 = time.perf_counter()
    out = {"steps": {mode: {s: tp_steps(mesh, s, mode == "sp")
                            for s in DP_STAGES} for mode in ("tp", "sp")},
           "fit": tp_fit(mesh, root),
           "base": {mode: tp_base(mesh, mode == "sp")
                    for mode in ("tp", "sp")},
           "taps": {mode: tp_taps(mesh, mode == "sp")
                    for mode in ("tp", "sp")},
           "mesh": repr(mesh)}
    out["seconds"] = time.perf_counter() - t0
    return out


PP_MICRO = 4              # the pipeline's microbatches of a local batch


def axis_config(axis: str, cfg=None):
    """``cfg`` (default: the flagship ``Config()``) for ``axis``: the MoE
    flagship under expert parallelism, ``PP_MICRO`` microbatches for the
    pipeline."""
    from rovit_kan_tpu_torch.config import Config
    cfg = cfg or Config()
    if axis == "expert":
        cfg.model.moe_experts = MOE_EXPERTS
    else:
        cfg.tpu.pipeline_microbatches = PP_MICRO
    return cfg


def axis_steps(mesh, stage: int, axis: str) -> dict:
    """``dp_steps``'s steps (the seed-0 bf16 flagship, or its MoE twin
    under expert parallelism, the global batches and the EMA) on a data x
    ``axis`` mesh under ``parallel.tensor.ExpertParallel`` or
    ``parallel.pipeline.Pipeline``: the losses, the gradients and
    parameters gathered whole in the one-process layout on rank 0 (None on
    the others), the launches, step ms and peak memory, each rank's
    replicated leaves and state bytes beside ``sharded_size``, and what the
    rank holds (its experts of block 1, or its stage's blocks)."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.parallel.fsdp import sharded_size
    from rovit_kan_tpu_torch.parallel.mesh import replicate
    from rovit_kan_tpu_torch.parallel.pipeline import Pipeline
    from rovit_kan_tpu_torch.parallel.tensor import ExpertParallel
    from rovit_kan_tpu_torch.training.optimizer import build_optimizer
    from rovit_kan_tpu_torch.training.trainer import make_train_step
    cfg = axis_config(axis)
    cfg.train.ema_decay = 0.999
    dev = mesh.device
    base = memory_base(dev)
    model = build_model(cfg, device=dev, seed=0)
    replicate(model, mesh)           # rank 0's weights, as Trainer does
    net = (ExpertParallel(model, mesh) if axis == "expert"
           else Pipeline(model, mesh, PP_MICRO))
    opt = build_optimizer(net, cfg)
    step = make_train_step(net, opt, cfg,
                           generator=torch.Generator(dev).manual_seed(0),
                           mesh=mesh)
    batches = [{k: v.to(dev) for k, v in train_batch(cfg, 300 + i).items()}
               for i in range(DP_STEPS)]
    out = {"loss": [], "accuracy": [], "grads": [], "ms": []}
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    for b in batches:
        t0 = time.perf_counter()
        m = step(b, stage, 1.0, 1)
        out["loss"].append(float(m["total_loss"]))
        torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["accuracy"].append(float(m["accuracy"]))
        out["grads"].append(net.gather_flat(opt.grad))
    out["launches"] = read()
    out["params"] = net.gather_flat(opt.flat)
    out["replicated"] = {k: v.detach().cpu().clone()
                         for k, v in net.state_dict().items()
                         if k not in net.model_sharded}
    out["state_bytes"] = state_bytes(net, opt, step.ema)
    out["sharded_size"] = sharded_size(net, {}, mesh, net.specs)
    out["replicated_bytes"] = sharded_size(net, {}, mesh)
    out["holds"] = (int(net.state_dict()[
        "backbone.model.blocks.1.moe.w1"].shape[0]) if axis == "expert"
        else [net.axis.lo, net.axis.hi])
    out["names"] = net.full_order()
    out["sizes"] = [int(np.prod(net.full_shapes[k])) for k in out["names"]]
    out["peak_mib"] = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
    return out


def axis_fit(mesh, root, axis: str) -> dict:
    """``dp_fit``'s two-epoch fit on a data x ``axis`` mesh (the ``Trainer``
    wraps the model): its launches and history, the best state's
    parameters whole on rank 0 (None on the others) and its
    ``best_model``."""
    from rovit_kan_tpu_torch.data.dataset import Subset
    from rovit_kan_tpu_torch.data.device_cache import DeviceLoader
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.training.trainer import Trainer
    cfg = axis_config(axis, dp_config(Path(root) / axis))
    leaves = LeafSet(DP_PER_CLASS, 224, seed=20)
    order = np.random.RandomState(20).permutation(len(leaves))
    train = DeviceLoader(Subset(leaves, order[:128]), BATCH, shuffle=True,
                         drop_last=True, seed=0, mesh=mesh, shard_data=True)
    val = DeviceLoader(Subset(leaves, order[128:]), BATCH, mesh=mesh,
                       shard_data=True)
    tr = Trainer(build_model(cfg, device=mesh.device, seed=1), train, val,
                 cfg, seed=0, mesh=mesh)
    if tr.sharded is None or tr.pipelined != (axis == "pipe"):
        raise RuntimeError(f"{axis} fit: the trainer did not shard")
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    res = tr.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read()
    epochs = len(res["history"]["train"])
    steps, vals = epochs * len(train), epochs * len(val)
    per = 6 if axis == "expert" else 6 * PP_MICRO
    # The 3-D mesh's stages run the sharded block: its heads' core on #5/#6.
    fwd, bwd = (("attention_fwd", "attention_bwd") if mesh.model_size > 1
                else ("vit_block_fwd", "vit_block_bwd"))
    only(launches, **{fwd: per * (steps + vals), bwd: per * steps},
         augment=steps)
    best = tr.sharded.gather_full(tr.eval_params(res["best_state"]))
    return {"history": {p: [{k: m[k] for k in ("total_loss", "accuracy")}
                            for m in res["history"][p]]
                        for p in ("train", "val")},
            "fit_seconds": fit_s, "launches": launches, "steps": steps,
            "val_batches": vals, "best_params": best,
            "n_micro": tr.n_micro,
            "best_model": str(cfg.paths.checkpoints_dir / "best_model")}


def axis_worker(mesh, root, axis: str, fit: bool = True) -> dict:
    """The "ep" or "pp" phase on one rank of a data x ``axis`` mesh."""
    t0 = time.perf_counter()
    out = {"steps": {s: axis_steps(mesh, s, axis) for s in DP_STAGES},
           "mesh": repr(mesh)}
    if fit:
        out["fit"] = axis_fit(mesh, root, axis)
    out["seconds"] = time.perf_counter() - t0
    return out


#: "serve_mesh"'s 20 requests of mixed sizes: ten through ``predict``
#: (full, partial and oversize batches of 64), ten through ``MicroBatcher``
#: from a client thread each.
SERVE_MESH_PREDICT = (64, 1, 17, 64, 130, 5, 33, 64, 2, 100)
SERVE_MESH_BATCHED = (1, 3, 8, 16, 7, 40, 2, 64, 9, 12)


def dp_best(root: Path) -> Path:
    """The "dp" fit's ``best_model`` under the "dp" phase's root."""
    return Path(root) / "fit" / "checkpoints" / "best_model"


def serve_mesh_run(engine) -> dict:
    """The "serve_mesh" requests on ``engine`` (rank 0 of a mesh engine,
    or one process), counters reset first: the outputs in request order,
    the launches, the engine's stats and the wall seconds."""
    from rovit_kan_tpu_torch.serving import MicroBatcher
    direct = [uint8_batch(70 + i, n) for i, n in enumerate(SERVE_MESH_PREDICT)]
    batched = [uint8_batch(90 + i, n)
               for i, n in enumerate(SERVE_MESH_BATCHED)]
    reset, read = all_counters()
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    outs = [engine.predict(x) for x in direct]
    batcher = MicroBatcher(engine, window_ms=2.0)
    got = [None] * len(batched)

    def client(i):
        got[i] = batcher.predict(batched[i])

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(batched))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("serve_mesh: MicroBatcher clients did not finish")
    batcher.close()
    torch.cuda.synchronize()
    return {"outputs": outs + got, "launches": read(),
            "stats": engine.stats(), "seconds": time.perf_counter() - t0,
            "microbatcher_batches": batcher.batches_run}


def serve_mesh_worker(mesh, best: Path) -> dict:
    """One rank of "serve_mesh": ``load_engine(mesh=)`` on ``best``; rank 0
    serves the requests (``serve_mesh_run``) and closes the engine, every
    other rank follows; each rank's launches."""
    from rovit_kan_tpu_torch.serving import load_engine
    engine = load_engine(best, batch_size=BATCH, mesh=mesh)
    engine.warmup()
    if engine.leader:
        out = serve_mesh_run(engine)
        engine.close()
    else:
        reset, read = all_counters()
        torch.cuda.synchronize()
        reset()
        engine.follow()
        torch.cuda.synchronize()
        out = {"launches": read()}
    return {**out, "mesh": repr(mesh), "temperature": engine.temperature}


def pp_tp_worker(root: str, backend: str) -> int:
    """One rank of "pp_tp" (``--pp-tp-worker``): the "pp" phase's steps and
    fit on a data 1 x pipe 2 x model 2 mesh, four ranks on cuda:0 through
    gloo."""
    from rovit_kan_tpu_torch.parallel.mesh import make_pipeline_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_pipeline_mesh(1, 2, model=2, backend=backend,
                              device="cuda:0" if backend == "gloo" else None)
    out = {"pp_tp": axis_worker(mesh, Path(root), "pipe")}
    torch.save(out, Path(root) / f"rank{mesh.global_rank}.pt")
    return 0


BASELINE_DP_MODELS = ("resnet50", "deit_tiny")


def baselines_first_step(mesh, reverse: bool = False) -> dict:
    """One ResNet-50 train step of ``BaselineExperiment`` at 224 px, batch
    ``BASELINE_BATCH`` with its last 5 rows padded, from the seed's weights
    on ``mesh`` (None: one process): the loss and accuracy, the gradient
    (all-reduced) and the running statistics after it, on the host. With
    ``reverse`` the batch's rows (and their draws) come in reverse order:
    the same step in another summation order."""
    from rovit_kan_tpu_torch.config import get_config
    from rovit_kan_tpu_torch.experiments.baselines import BaselineExperiment
    from rovit_kan_tpu_torch.ops.augment_kernel import draw_factors
    cfg = get_config()
    cfg.data.image_size = BASELINE_SIZE
    exp = BaselineExperiment(cfg, None, None, None, "unused",
                             device="cuda", run_fps=False, mesh=mesh)
    model = exp.build_model("resnet50")
    step, _, _ = exp._make_steps(model)
    dev = exp.device
    rng = np.random.RandomState(23)
    valid = np.ones(BASELINE_BATCH, np.float32)
    valid[-5:] = 0.0
    batch = {"images": torch.from_numpy(uint8_batch(23, BASELINE_BATCH,
                                                    BASELINE_SIZE)).to(dev),
             "labels": torch.from_numpy(rng.randint(0, 4, BASELINE_BATCH))
             .to(dev), "valid": torch.from_numpy(valid).to(dev)}
    factors = draw_factors(torch.Generator(dev).manual_seed(5),
                           BASELINE_BATCH)
    if reverse:
        batch = {k: v.flip(0) for k, v in batch.items()}
        factors = factors.flip(0)
    m = step(batch, draws={"factors": factors, "dropout": None})
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: p.grad.detach().cpu().clone()
                      for k, p in model.named_parameters()},
            "stats": {k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


def baselines_sweep(root: Path, name: str, extra: list, mesh=None) -> dict:
    """``cli.run_baselines`` over ``BASELINE_DP_MODELS`` for one epoch on
    the tree under ``root`` into ``root / name`` (``extra`` appended to its
    argv; with ``mesh``, the worker's mesh stands for the one the CLI's
    ``--multihost`` makes): each model's state after training, its
    launches, train steps and metrics, the sweep's seconds."""
    from rovit_kan_tpu_torch.cli import run_baselines as cli_baselines
    from rovit_kan_tpu_torch.experiments.baselines import BaselineExperiment
    from rovit_kan_tpu_torch.parallel import mesh as pmesh
    reset, read = all_counters()
    models, launches, steps = {}, {}, {}
    real_build = BaselineExperiment.build_model
    real_single = BaselineExperiment.run_single
    real_mesh = pmesh.make_mesh

    def build(self, n):
        models[n] = real_build(self, n)
        steps[n] = len(self.train_loader) * self.epochs
        return models[n]

    def single(self, n):
        torch.cuda.synchronize()
        before = read()
        result = real_single(self, n)
        torch.cuda.synchronize()
        after = read()
        launches[n] = {k: after[k] - before[k] for k in after}
        return result

    argv = ["--data-root", root / "baselines_dp_data", "--output-dir",
            root / name, "--models", *BASELINE_DP_MODELS, "--image-size",
            BASELINE_SIZE, "--batch-size", BASELINE_BATCH, "--epochs", 1,
            "--n-per-class", BASELINE_PER_CLASS, *extra]
    BaselineExperiment.build_model = build
    BaselineExperiment.run_single = single
    if mesh is not None:
        pmesh.make_mesh = lambda *a, **k: mesh
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    try:
        exp = cli_baselines.main([str(a) for a in argv])
    finally:
        BaselineExperiment.build_model = real_build
        BaselineExperiment.run_single = real_single
        pmesh.make_mesh = real_mesh
    torch.cuda.synchronize()
    missing = [n for n in BASELINE_DP_MODELS if n not in exp.results]
    if missing:
        raise RuntimeError(f"baselines sweep {name}: {missing} failed")
    return {"state": {n: {k: v.detach().cpu().clone()
                          for k, v in m.state_dict().items()}
                      for n, m in models.items()},
            "launches": launches, "steps": steps,
            "seconds": time.perf_counter() - t0,
            "lr": exp.config.train.learning_rate,
            "results": {n: {k: exp.results[n].get(k)
                            for k in BASELINE_METRICS + ("fps",)}
                        for n in BASELINE_DP_MODELS}}


def dp_worker(root: str, backend: str) -> int:
    """One rank of the "dp" phase (started by ``dp_phase`` with torchrun's
    variables). ``gloo``: every rank on cuda:0, the backend named, since
    NCCL refuses two ranks on one card; ``nccl``: rank r on cuda:r, the
    mesh's default."""
    from rovit_kan_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = (make_mesh(-1, backend="gloo", device="cuda:0")
            if backend == "gloo" else make_mesh(-1))
    if mesh.backend != backend:
        raise RuntimeError(f"dp rank {mesh.rank}: {mesh}, want {backend}")
    out = {"steps": {s: dp_steps(mesh, s) for s in DP_STAGES},
           "fit": dp_fit(mesh, Path(root)), "mesh": repr(mesh)}
    out["serve_mesh"] = serve_mesh_worker(mesh, dp_best(root))
    out["fsdp"] = {"steps": {s: dp_steps(mesh, s, fsdp=True)
                             for s in DP_STAGES},
                   "fit": fsdp_fit(mesh, Path(root)),
                   "base": {mode: base_memory(mesh, mode == "fsdp")
                            for mode in ("dp", "fsdp")}}
    with residual_opt_in(True):
        out["fsdp"]["residual"] = dp_steps(mesh, DP_STAGES[-1], fsdp=True)
    out["baselines"] = {
        "first_step": baselines_first_step(mesh),
        "sweep": baselines_sweep(Path(root), "baselines_dp",
                                 ["--multihost"], mesh)}
    from rovit_kan_tpu_torch.parallel.mesh import make_2d_mesh
    tp_mesh = (make_2d_mesh(1, DP_RANKS, backend="gloo", device="cuda:0")
               if backend == "gloo" else make_2d_mesh(1, DP_RANKS))
    out["tp"] = tp_worker(tp_mesh, Path(root))
    from rovit_kan_tpu_torch.parallel.mesh import (
        make_moe_mesh,
        make_pipeline_mesh,
    )
    for name, make, axis in (("ep", make_moe_mesh, "expert"),
                             ("pp", make_pipeline_mesh, "pipe")):
        axis_mesh = (make(1, DP_RANKS, backend="gloo", device="cuda:0")
                     if backend == "gloo" else make(1, DP_RANKS))
        out[name] = axis_worker(axis_mesh, Path(root), axis)
    torch.save(out, Path(root) / f"rank{mesh.rank}.pt")
    return 0


def tp4_worker(root: str, backend: str) -> int:
    """One rank of the four-card runs (``--nccl`` with four cards
    visible), rank r on cuda:r: FSDP+TP on data 2 x model 2, the "ep" and
    "pp" steps on data 2 x expert 2 and data 2 x pipe 2, the "pp_tp" steps
    on data 1 x pipe 2 x model 2, and "serve_mesh" over data 4."""
    from rovit_kan_tpu_torch.parallel.mesh import (
        make_2d_mesh,
        make_mesh,
        make_moe_mesh,
        make_pipeline_mesh,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_2d_mesh(2, 2, backend=backend)
    out = {"mesh": repr(mesh),
           "steps": {s: tp_steps(mesh, s, sp=False, fsdp=True)
                     for s in DP_STAGES}}
    for name, make, axis in (("ep", make_moe_mesh, "expert"),
                             ("pp", make_pipeline_mesh, "pipe")):
        out[name] = axis_worker(make(2, 2, backend=backend), Path(root),
                                axis, fit=False)
    out["pp_tp"] = axis_worker(make_pipeline_mesh(1, 2, model=2,
                                                  backend=backend),
                               Path(root), "pipe", fit=False)
    # The "dp" phase's fit, served over data 4 (``main_nccl``'s layout).
    out["serve_mesh"] = serve_mesh_worker(
        make_mesh(-1, backend=backend), dp_best(Path(root).parent / "dp"))
    torch.save(out, Path(root) / f"rank{mesh.global_rank}.pt")
    return 0


def run_ranks(root: Path, n: int, backend: str,
              worker: str = "--dp-worker") -> list:
    """``chip_smoke.py --dp-worker root backend`` (or ``worker``) as ``n``
    ranks through ``cli.spawn_workers``: every exit code is checked and a
    failed or hung rank stops the others and fails the phase. Returns each
    rank's saved results."""
    from rovit_kan_tpu_torch.cli import spawn_workers
    try:
        spawn_workers([sys.executable, os.path.abspath(__file__),
                       worker, root, backend], n, log_dir=root,
                      timeout=DP_TIMEOUT)
    except SystemExit as e:
        tails = {r: (root / f"rank{r}.log").read_text()[-3000:]
                 for r in range(n)}
        raise RuntimeError(f"dp ranks: {e}: {tails}") from None
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def dp_gaps(single, exact, ranks) -> dict:
    """Each rank's steps against the one-process bf16 steps (``single``),
    beside the one-process fp32 steps' gaps from them (``exact``), per
    step: the largest relative loss gap over the ranks and the fp32 one's;
    the all-reduced gradient's gaps: the five worst leaves in units of the
    leaf's largest magnitude, the ``DP_BF16_GRAD_LEAVES`` in units of two
    bf16 ulps of it (``bf16_tol``), the median leaf, the largest gap in
    units of a leaf's L2 norm, the five worst leaves in units of their
    limit after the first step (``hold_dp``), and the whole gradient's gap
    and the fp32 one's in units of its L2 norm."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    out = {"loss_rel": [max(rel(got["loss"][i], single["loss"][i])
                            for got in ranks) for i in range(DP_STEPS)],
           "fp32_loss_rel": [rel(exact["loss"][i], single["loss"][i])
                             for i in range(DP_STEPS)], "grad": [],
           "grad_norm_rel": [max(float((got["grads"][i]
                                        - single["grads"][i]).norm())
                                 / float(single["grads"][i].norm())
                                 for got in ranks)
                             for i in range(DP_STEPS)],
           "fp32_grad_norm_rel": [float((exact["grads"][i]
                                         - single["grads"][i]).norm())
                                  / float(single["grads"][i].norm())
                                  for i in range(DP_STEPS)]}
    for i in range(DP_STEPS):
        of_max, of_ulps, of_norm, of_limit = {}, {}, 0.0, {}
        wants = torch.split(single["grads"][i], single["sizes"])
        fp32s = torch.split(exact["grads"][i], single["sizes"])
        for got in ranks:
            for name, g, want, f in zip(
                    single["names"], torch.split(got["grads"][i],
                                                 single["sizes"]),
                    wants, fp32s):
                d = float((g - want).abs().max())
                of_norm = max(of_norm, float((g - want).norm())
                              / max(float(want.norm()), 1e-30))
                bf16_leaf = name.startswith(DP_BF16_GRAD_LEAVES)
                if bf16_leaf:
                    of_ulps[name] = max(of_ulps.get(name, 0.0),
                                        d / bf16_tol(want))
                else:
                    of_max[name] = max(of_max.get(name, 0.0), d / max(
                        float(want.abs().max()), 1e-30))
                floor = (bf16_tol(want) if bf16_leaf
                         else 1e-3 * float(want.abs().max()))
                limit = 2 * max(float((f - want).abs().max()), floor)
                of_limit[name] = max(of_limit.get(name, 0.0),
                                     d / max(limit, 1e-30))
        out["grad"].append({
            "worst_of_max": dict(sorted(of_max.items(),
                                        key=lambda kv: -kv[1])[:5]),
            "bf16_leaves_of_two_ulps": of_ulps,
            "median_of_max": float(np.median(list(of_max.values()))),
            "max_of_norm": of_norm,
            "worst_of_limit": dict(sorted(of_limit.items(),
                                          key=lambda kv: -kv[1])[:5])})
    return out


#: Leaves whose gradient the bf16 trunk forms in bf16 (the patch
#: embedding's matmul, the token and position embeddings' sums over the
#: batch): each rank rounds its half-batch sum to bf16 before the
#: all-reduce, where one process rounds the whole batch's sum once.
DP_BF16_GRAD_LEAVES = ("backbone.model.patch_embed.",
                       "backbone.model.pos_embed", "backbone.model.cls_token")


def hold_dp(gaps, ranks, what: str = "dp", route: bool = False,
            first_grad: float | None = None) -> None:
    """Raise unless the ranks' steps agree with the one-process steps.

    The first step (the same weights on both sides): at stages 3 and 4 the
    loss on every rank within 1e-4 (relative) of the one-process step's;
    at stage 3 each leaf's all-reduced gradient within 1e-3 of its largest
    magnitude, the ``DP_BF16_GRAD_LEAVES`` within two bf16 ulps of it
    (``bf16_tol``); at stage 4, whose gradient is ill-conditioned at the
    seed-0 weights (the "train" phase holds its gradient at stage 3 for
    that reason), each leaf within 5e-2 of its L2 norm, the "train" phase's
    rule for a rounding change in the bf16 backward.

    After the first update the two sides' weights part by Adam's +-lr
    steps on rounding-level gradient differences, as the bf16 and fp32
    models' weights part by larger ones. So each later step is held by
    ``hold_served``'s rule against the fp32 model's steps in the same
    call: the ranks' loss within twice the bf16 step's own distance from
    fp32 (floor 1e-4, relative); at stage 3 each leaf's gradient within
    twice the bf16 gradient's largest distance from fp32 on that leaf
    (floor 1e-3 of its largest magnitude, two bf16 ulps on the
    ``DP_BF16_GRAD_LEAVES``); at both stages the whole gradient within
    twice the bf16 gradient's distance from fp32, in L2. Stage 4 is held
    in L2 only: there one update from either rounding change leaves the
    next gradient about as far from the one-process one as its own size
    (the fp32 model's too), so a leaf's largest gap is noise.

    The ranks' parameters must be equal bit for bit after every stage's
    steps (``ranks``; None under FSDP, where each rank holds its shards).
    ``what`` names the run in the errors. ``route``: the ranks take another
    route than the one-process step (tensor parallelism: plain GEMMs and
    #5/#6 for #1/#2), so another bf16 rounding from the first step on:
    every step's whole gradient is then held within twice the bf16 step's
    own distance from fp32 (L2), and the first step's loss within twice
    the fp32 loss's distance (floor 1e-4). The later losses are read, not
    held: after one update on gradients that part as bf16's part from
    fp32's, a loss moves as much as bf16's does, and a 2x bound on one
    sample of that is a coin (``tp_ranks_hold``). ``first_grad``, with
    ``route``: the first step's whole gradient also within this fraction of
    its L2 norm at every stage, where twice bf16's distance from fp32 is
    too wide to tell a wrong gradient (a zeroed or doubled one parts by 1,
    one in a random direction by about 1.4) from a right one."""
    for stage, g in gaps.items():
        if route:
            if first_grad is not None and g["grad_norm_rel"][0] > first_grad:
                raise RuntimeError(
                    f"{what} stage {stage} first gradient: whole "
                    f"{g['grad_norm_rel'][0]:.2e}, limit {first_grad}")
            for i in range(DP_STEPS):
                limit = 2 * max(g["fp32_loss_rel"][i], 1e-4)
                if i == 0 and g["loss_rel"][i] > limit:
                    raise RuntimeError(
                        f"{what} stage {stage} step {i + 1}: loss "
                        f"{g['loss_rel'][i]:.2e} off, limit {limit:.2e}")
                if g["grad_norm_rel"][i] > 2 * g["fp32_grad_norm_rel"][i]:
                    raise RuntimeError(
                        f"{what} stage {stage} step {i + 1} gradient: "
                        f"whole {g['grad_norm_rel'][i]:.2e} (fp32 "
                        f"{g['fp32_grad_norm_rel'][i]:.2e})")
            continue
        if g["loss_rel"][0] > 1e-4:
            raise RuntimeError(f"{what} stage {stage}: first loss "
                               f"{g['loss_rel'][0]:.2e} off the "
                               f"one-process step's")
        for i in range(1, DP_STEPS):
            limit = 2 * max(g["fp32_loss_rel"][i], 1e-4)
            if g["loss_rel"][i] > limit:
                raise RuntimeError(f"{what} stage {stage} step {i + 1}: loss "
                                   f"{g['loss_rel'][i]:.2e} off, limit "
                                   f"{limit:.2e}")
            leaves = max(g["grad"][i]["worst_of_limit"].values())
            if (stage == 3 and leaves > 1.0) or (
                    g["grad_norm_rel"][i] > 2 * g["fp32_grad_norm_rel"][i]):
                raise RuntimeError(f"{what} stage {stage} step {i + 1} "
                                   f"gradient: {g['grad'][i]}, whole "
                                   f"{g['grad_norm_rel'][i]:.2e} (fp32 "
                                   f"{g['fp32_grad_norm_rel'][i]:.2e})")
        if ranks is not None and not torch.equal(
                ranks[0]["steps"][stage]["params"],
                ranks[1]["steps"][stage]["params"]):
            raise RuntimeError(f"{what} stage {stage}: the ranks' parameters "
                               f"differ")
    if route:
        return
    first3, first4 = gaps[3]["grad"][0], gaps[4]["grad"][0]
    if max(first3["worst_of_max"].values()) > 1e-3 or max(
            first3["bf16_leaves_of_two_ulps"].values()) > 1.0:
        raise RuntimeError(f"{what} stage 3 gradient: {first3}")
    if first4["max_of_norm"] > 5e-2:
        raise RuntimeError(f"{what} stage 4 gradient: {first4}")


DP_CLI_PER_CLASS = 24     # 96 images: 77 train (1 step), 19 validation


def cli_train_argv(data: Path, out: Path) -> list:
    return ["--data_root", str(data), "--output_dir", str(out), "--epochs",
            "1", "--batch_size", str(BATCH), "--seed", "0"]


def cli_train_data(root: Path) -> Path:
    """A 224-px JPEG tree for ``cli.train``: 4 x 24 training images, 4 x 8
    test images."""
    from rovit_kan_tpu_torch.config import Config
    from rovit_kan_tpu_torch.data.synthetic import generate_synthetic_dataset
    names = Config().data.class_names
    data = root / "data"
    generate_synthetic_dataset(data / "Augmented Image", DP_CLI_PER_CLASS,
                               size=224, class_names=names, seed=0)
    generate_synthetic_dataset(data / "Original Image", 8, size=224,
                               class_names=names, seed=1)
    return data


def run_cli_train(root: Path, runs: dict) -> dict:
    """Each of ``runs`` (name -> the command before ``cli_train_argv``) in
    its own process, side by side, on ``cli_train_data``; fails unless
    every one exits 0. Returns each run's output."""
    data = cli_train_data(root)
    repo = str(Path(os.path.abspath(__file__)).parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = {}
    for name, cmd in runs.items():
        procs[name] = subprocess.Popen(
            cmd + cli_train_argv(data, root / name), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=repo, env=env)
    logs = {}
    try:
        for name, p in procs.items():
            logs[name] = p.communicate(timeout=DP_TIMEOUT)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"{name} exited with {p.returncode}: "
                               f"{logs[name][-3000:]}")
    return logs


TRAIN_CLI = [sys.executable, "-m", "rovit_kan_tpu_torch.cli.train"]


def world_one_run(root: Path) -> dict:
    """``cli.train`` through ``torch.distributed.run --nproc_per_node=1 ...
    --multihost`` (a world of 1: no process group) and as the single-card
    run, side by side in two processes; their epoch CSVs must agree bit for
    bit."""
    t0 = time.perf_counter()
    runs = {"torchrun_world1": [sys.executable, "-m",
                                "torch.distributed.run", "--nproc_per_node=1",
                                "-m", "rovit_kan_tpu_torch.cli.train",
                                "--multihost", "--devices", "1"],
            "single_card": TRAIN_CLI + ["--devices", "1"]}
    logs = run_cli_train(root, runs)
    if "Multi-host: rank 0 of 1" not in logs["torchrun_world1"]:
        raise RuntimeError("the torchrun run did not take --multihost")
    csvs = {name: (root / name / "logs" / "train_epochs.csv").read_text()
            for name in runs}
    if csvs["torchrun_world1"] != csvs["single_card"]:
        raise RuntimeError(f"world-1 CSV differs: {csvs}")
    return {"seconds": time.perf_counter() - t0,
            "epoch_csv": csvs["single_card"].splitlines()[1:]}


def nccl_cli_run(root: Path) -> dict:
    """``cli.train --devices 2`` (NCCL, rank r on cuda:r) beside the
    single-card ``cli.train --devices 1``: both ranks on NCCL, one writer of
    the epoch CSV and the checkpoint, ``load_engine`` serving from it, and
    the epoch losses of the two runs side by side (read, not held: the
    validation batch of 19 rows pads differently)."""
    from rovit_kan_tpu_torch.serving import load_engine
    t0 = time.perf_counter()
    logs = run_cli_train(root, {"devices2": TRAIN_CLI + ["--devices", "2"],
                                "devices1": TRAIN_CLI + ["--devices", "1"]})
    for r in range(2):
        if f"rank {r} of 2 on cuda:{r} (nccl)" not in logs["devices2"]:
            raise RuntimeError(f"cli.train --devices 2: no NCCL rank {r}: "
                               f"{logs['devices2'][-3000:]}")
    csvs = {name: (root / name / "logs" / "train_epochs.csv").read_text()
            .splitlines() for name in ("devices2", "devices1")}
    if len(csvs["devices2"]) != 2:
        raise RuntimeError(f"cli.train --devices 2 CSV: {csvs['devices2']}")
    engine = load_engine(root / "devices2" / "checkpoints" / "best_model",
                         device="cuda")
    probs = engine.predict(uint8_batch(22, BATCH))["cls_probs"]
    if not np.isfinite(probs).all():
        raise RuntimeError(f"cli.train --devices 2 checkpoint serves {probs}")
    return {"seconds": time.perf_counter() - t0,
            "epoch_csv": {k: v[1:] for k, v in csvs.items()}}


def of_max(got: dict, want: dict, floor: float = 0.0) -> dict:
    """Each tensor's largest gap from ``want``'s in units of its largest
    magnitude there, or of ``floor`` of the largest magnitude over all of
    ``want`` where that is more (rounding-noise leaves: see
    ``tests/test_torch_baselines_dp.py::GRAD_FLOOR``)."""
    whole = max(float(v.abs().max()) for v in want.values() if v.numel())
    return {k: float((got[k].float() - v.float()).abs().max()) / max(
        float(v.abs().max()), floor * whole, 1e-30)
        for k, v in want.items() if v.numel()}


def worst(ratios: dict, n: int = 3) -> dict:
    return dict(sorted(ratios.items(), key=lambda kv: -kv[1])[:n])


def fsdp_line(smi, root, backend, single, exact, ranks) -> dict:
    """The "fsdp" phase from the ranks' FSDP runs (module docstring, phase
    21): the steps held as ``hold_dp`` holds the "dp" steps, against the
    one-process steps and against the "dp" ranks' of the same call; the
    launches, state bytes and gathered-unit count of each rank; the fit's
    checkpoint loaded by a one-process ``Trainer`` and served; the base
    preset's memory under both."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
    fs = [r["fsdp"] for r in ranks]
    mine = {s: [fs[0]["steps"][s]] for s in DP_STAGES}
    gaps = {s: dp_gaps(single[s], exact[s], mine[s]) for s in DP_STAGES}
    vs_dp = {s: dp_gaps(ranks[0]["steps"][s], exact[s], mine[s])
             for s in DP_STAGES}
    emit({"phase": "fsdp_readings", "backend": backend, "gaps": gaps,
          "gaps_vs_dp": vs_dp, "card": smi})
    hold_dp(gaps, None, "fsdp")
    hold_dp(vs_dp, None, "fsdp against dp")
    for f in fs:
        for s in DP_STAGES:
            st = f["steps"][s]
            only(st["launches"], vit_block_fwd=12 * DP_STEPS,
                 vit_block_bwd=12 * DP_STEPS, augment=DP_STEPS)
            want = st["sharded_size"]
            if st["state_bytes"] != dict.fromkeys(("params", "mu", "nu",
                                                   "ema"), want) \
                    or st["peak_live_units"] != 1 or want >= \
                    st["replicated_bytes"]:
                raise RuntimeError(f"fsdp state: {st['state_bytes']}, "
                                   f"sharded_size {want}, "
                                   f"{st['peak_live_units']} units")
    for f in fs:
        # The saved-residual pair (#3, #4) in #1's and #2's place; #3's
        # output has #1's bits, so the first loss is the same.
        res = f["residual"]
        only(res["launches"], vit_block_res_fwd=12 * DP_STEPS,
             vit_block_bwd_res=12 * DP_STEPS, augment=DP_STEPS)
        if res["loss"][0] != f["steps"][DP_STAGES[-1]]["loss"][0] or \
                not np.isfinite(res["loss"]).all():
            raise RuntimeError(f"fsdp residual steps: {res['loss']}")
    fits = [f["fit"] for f in fs]
    if fits[0]["history"] != fits[1]["history"]:
        raise RuntimeError(f"fsdp fit: the ranks' histories differ: "
                           f"{[f['history'] for f in fits]}")
    for part in ("train", "val"):
        for m in fits[0]["history"][part]:
            if not np.isfinite(m["total_loss"]):
                raise RuntimeError(f"fsdp fit: non-finite {part} {m}")
    best = Path(fits[0]["best_model"])
    ck = load_checkpoint(best)
    cfg = dp_config(root / "fsdp")
    tr = Trainer(build_model(cfg, device="cuda", seed=1), None, None, cfg,
                 seed=0)
    tr.resume("best_model")
    loaded = tr.model.state_dict()
    for k, v in fits[0]["best_params"].items():
        if not (torch.equal(ck["params"][k], v)
                and torch.equal(loaded[k].cpu(), v)):
            raise RuntimeError(f"fsdp checkpoint: {k} is not the ranks' "
                               f"gathered best weights")
    reset, read = all_counters()
    engine = load_engine(best, device="cuda")
    torch.cuda.synchronize()
    reset()
    probs = engine.predict(uint8_batch(24, BATCH))["cls_probs"]
    only(read(), vit_block_fwd=12)
    if not np.isfinite(probs).all() or probs.shape != (BATCH, 4):
        raise RuntimeError(f"fsdp checkpoint serves {probs}")
    base = {r: f["base"] for r, f in enumerate(fs)}
    for b in base.values():
        dp_b, fsdp_b = (sum(b[m]["state_bytes"].values())
                        for m in ("dp", "fsdp"))
        if fsdp_b >= dp_b:
            raise RuntimeError(f"fsdp base preset: {b}")
    last = DP_STAGES[-1]
    st = {r: f["steps"][last] for r, f in enumerate(fs)}
    launches = {f"rank{r}": {k: f["fit"]["launches"][k]
                             + f["residual"]["launches"][k] + sum(
        f["steps"][s]["launches"][k] for s in DP_STAGES)
        for k in f["fit"]["launches"]} for r, f in enumerate(fs)}
    return {"phase": "fsdp" if backend == "gloo" else "fsdp_nccl",
            "ranks": DP_RANKS, "batch_size": BATCH, "steps": DP_STEPS,
            "sharded_leaves": st[0]["sharded_leaves"],
            "state_bytes": {f"rank{r}": x["state_bytes"]
                            for r, x in st.items()},
            "sharded_size": st[0]["sharded_size"],
            "replicated_bytes": st[0]["replicated_bytes"],
            "peak_mib": {f"rank{r}": {"dp": ranks[r]["steps"][last][
                "peak_mib"], "fsdp": x["peak_mib"]} for r, x in st.items()},
            "single_peak_mib": single[last]["peak_mib"],
            "rank_step_ms": {f"rank{r}": {"dp": ranks[r]["steps"][last][
                "ms"], "fsdp": x["ms"]} for r, x in st.items()},
            "losses": {"single": single[last]["loss"],
                       "dp_rank0": ranks[0]["steps"][last]["loss"],
                       "fsdp_rank0": st[0]["loss"]},
            "fit": {k: fits[0][k] for k in ("history", "fit_seconds",
                                            "steps", "val_batches")},
            "base_preset": {f"rank{r}": b for r, b in base.items()},
            "base_batch": FSDP_BASE_BATCH, "launches": launches,
            "card": smi}


def tp_ranks_hold(what, one, ranks, per_step: dict, want_bytes: int,
                  line: str = "tp_readings",
                  first_routed: float | None = 1e-4) -> dict:
    """Hold the ranks' TP steps (``ranks``: each rank's ``tp_steps``
    results by stage) against the one-process steps ``one`` (``single``:
    bf16 through #1/#2, ``routed``: bf16 on the TP block's route, unfused
    with #5/#6, ``exact``: fp32), against each by ``hold_dp``'s rules for
    another route, and the first stage-3 loss within ``first_routed``
    (relative; None: not held) of the routed step's; the launches a step
    (``per_step``); every rank's
    replicated leaves equal bit for bit; each rank's parameter, moment and
    EMA bytes equal to ``sharded_size``, which must be ``want_bytes``.
    The gaps go on a ``line`` line; returns them.

    Why not ``hold_dp``'s own rules, which hold the "dp" ranks: a DP rank
    computes each of its rows with the one-process step's bits, so only
    the sums over the batch part them. A TP rank sums its partials in
    another order, and where one bf16 rounding flips, every rounding after
    it decorrelates: on the card the first stage-3 gradient sits 0.030 (L2)
    from the routed step's, half the bf16 step's 0.059 from fp32's, and
    stage 4's loss moves by as much as bf16's does (PERF.md §6)."""
    mine = {s: [ranks[0][s]] for s in DP_STAGES}
    gaps = {ref: {s: dp_gaps(one[ref][s], one["exact"][s], mine[s])
                  for s in DP_STAGES} for ref in ("routed", "single")}
    emit({"phase": line, "what": what, "gaps": gaps})
    first = gaps["routed"][DP_STAGES[0]]["loss_rel"][0]
    if first_routed is not None and first > first_routed:
        raise RuntimeError(f"{what}: first stage-{DP_STAGES[0]} loss "
                           f"{first:.2e} off the routed step's")
    for ref in ("routed", "single"):
        hold_dp(gaps[ref], None, f"{what} against {ref}", route=True)
    for r in ranks:
        for s in DP_STAGES:
            st = r[s]
            only(st["launches"], **{k: n * DP_STEPS
                                    for k, n in per_step.items()})
            if st["state_bytes"] != dict.fromkeys(
                    ("params", "mu", "nu", "ema"), st["sharded_size"]) \
                    or st["sharded_size"] != want_bytes:
                raise RuntimeError(f"{what} state: {st['state_bytes']}, "
                                   f"sharded_size {st['sharded_size']}, "
                                   f"want {want_bytes}")
            for k, v in ranks[0][s]["replicated"].items():
                if not torch.equal(st["replicated"][k], v):
                    raise RuntimeError(f"{what} stage {s}: the ranks' "
                                       f"replicated {k} differ")
    return gaps


def tp_line(smi, root, backend, one, ranks) -> dict:
    """The "tp" phase from the ranks' TP and TP + SP runs (module
    docstring, phase 23): the steps held against the one-process steps
    (``tp_ranks_hold``), the fit's checkpoint loaded by a one-process
    ``Trainer`` and served, the base preset's bytes; each rank's peak
    memory and step ms beside its "dp" figures."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
    tps = [r["tp"] for r in ranks]
    per_step = {"attention_fwd": 12, "attention_bwd": 12, "augment": 1}
    single = one["single"]
    for mode in ("tp", "sp"):
        tp_ranks_hold(f"tp {mode}", one, [t["steps"][mode] for t in tps],
                      per_step, TP_PARAM_BYTES["tiny"])
    fits = [t["fit"] for t in tps]
    if fits[0]["history"] != fits[1]["history"]:
        raise RuntimeError(f"tp fit: the ranks' histories differ: "
                           f"{[f['history'] for f in fits]}")
    for part in ("train", "val"):
        for m in fits[0]["history"][part]:
            if not np.isfinite(m["total_loss"]):
                raise RuntimeError(f"tp fit: non-finite {part} {m}")
    best = Path(fits[0]["best_model"])
    ck = load_checkpoint(best)
    cfg = dp_config(root / "tp")
    tr = Trainer(build_model(cfg, device="cuda", seed=1), None, None, cfg,
                 seed=0)
    tr.resume("best_model")
    loaded = tr.model.state_dict()
    for k, v in fits[0]["best_params"].items():
        if not (torch.equal(ck["params"][k], v)
                and torch.equal(loaded[k].cpu(), v)):
            raise RuntimeError(f"tp checkpoint: {k} is not the ranks' "
                               f"gathered best weights")
    reset, read = all_counters()
    engine = load_engine(best, device="cuda")
    torch.cuda.synchronize()
    reset()
    probs = engine.predict(uint8_batch(25, BATCH))["cls_probs"]
    only(read(), vit_block_fwd=12)
    if not np.isfinite(probs).all() or probs.shape != (BATCH, 4):
        raise RuntimeError(f"tp checkpoint serves {probs}")
    for t in tps:
        for mode, b in t["base"].items():
            if b["state_bytes"]["params"] != b["sharded_size"] \
                    or b["sharded_size"] != TP_PARAM_BYTES["base"]:
                raise RuntimeError(f"tp base preset {mode}: {b}")
    taps = {f"{mode}_rank{r}": t["taps"][mode]
            for mode in ("tp", "sp") for r, t in enumerate(tps)}
    for where, t in taps.items():        # tp_taps held the rest
        if t["attention_shape"] != [12, TAPS_BATCH, 3, TOKENS, TOKENS]:
            raise RuntimeError(f"tp taps {where}: attention maps "
                               f"{t['attention_shape']}")
    last = DP_STAGES[-1]
    launches = {f"{mode}_rank{r}": {
        k: sum(t["steps"][mode][s]["launches"][k] for s in DP_STAGES)
        + (t["fit"]["launches"][k] if mode == "sp" else 0)
        for k in t["fit"]["launches"]}
        for mode in ("tp", "sp") for r, t in enumerate(tps)}
    return {"phase": "tp" if backend == "gloo" else "tp_nccl",
            "ranks": DP_RANKS, "mesh": tps[0]["mesh"],
            "batch_size": BATCH, "steps": DP_STEPS,
            "tokens": {"tp": TOKENS, "sp": -(-TOKENS // DP_RANKS)
                       * DP_RANKS},
            "state_bytes": {f"{mode}_rank{r}": t["steps"][mode][last][
                "state_bytes"] for mode in ("tp", "sp")
                for r, t in enumerate(tps)},
            "sharded_size": tps[0]["steps"]["tp"][last]["sharded_size"],
            "replicated_bytes": tps[0]["steps"]["tp"][last][
                "replicated_bytes"],
            "peak_mib": {f"rank{r}": {
                "dp": ranks[r]["steps"][last]["peak_mib"],
                **{mode: t["steps"][mode][last]["peak_mib"]
                   for mode in ("tp", "sp")}} for r, t in enumerate(tps)},
            "single_peak_mib": single[last]["peak_mib"],
            "routed_peak_mib": one["routed"][last]["peak_mib"],
            "routed_step_ms": one["routed"][last]["ms"],
            "rank_step_ms": {f"rank{r}": {
                "dp": ranks[r]["steps"][last]["ms"],
                **{mode: t["steps"][mode][last]["ms"]
                   for mode in ("tp", "sp")}} for r, t in enumerate(tps)},
            "single_step_ms": single[last]["ms"],
            "losses": {"single": single[last]["loss"],
                       **{f"{mode}_rank0": tps[0]["steps"][mode][last][
                           "loss"] for mode in ("tp", "sp")}},
            "fit": {k: fits[0][k] for k in ("history", "fit_seconds",
                                            "steps", "val_batches")},
            "base_preset": {f"rank{r}": t["base"]
                            for r, t in enumerate(tps)},
            "base_batch": FSDP_BASE_BATCH,
            "taps": {"model": "the fp32 flagship, seed-0 weights moved by "
                              "N(0, 0.05), 224 px", "batch": TAPS_BATCH,
                     "held_against": "one process, the model whole",
                     **taps},
            "seconds": [t["seconds"] for t in tps],
            "launches": launches, "card": smi}


#: The EP ranks' first gradient, whole, within this fraction of its L2 norm
#: of the one-process step's: twice the largest reading (0.114, stage 4, on
#: an H100 80GB HBM3 at 700 W), and below the 1 that a zeroed or doubled
#: gradient parts by.
EP_FIRST_GRAD = 0.25


def axis_ranks_hold(what, single, exact, ranks, per_step: dict,
                    axis: str) -> dict:
    """Hold the ranks' EP or PP steps (``ranks``: each rank's
    ``axis_steps`` results by stage) against the one-process bf16 steps
    ``single``, beside the fp32 steps ``exact``. The stages (``axis``
    "pipe") run the one-process blocks on microbatches and sum #2's weight
    gradients over them in another order, a change at fp32's rounding (the
    first gradient 1.5e-6 of its L2 norm on the card): ``hold_dp``'s data
    rules, per leaf at the first step. The expert ranks run each expert's
    GEMMs on their own slots and sum the combine's fp32 partials, a change
    the stage-4 gradient amplifies to 0.114 of its norm: ``hold_dp``'s
    rules for another route (the first loss and every step's whole
    gradient in L2), with the first gradient within ``EP_FIRST_GRAD``.
    Then the launches a step (``per_step``); every rank's replicated leaves
    equal bit for bit; each rank's parameter, moment and EMA bytes equal to
    ``sharded_size``. Returns the gaps."""
    gaps = {s: dp_gaps(single[s], exact[s], [ranks[0][s]])
            for s in DP_STAGES}
    emit({"phase": f"{what}_readings", "gaps": gaps})
    if axis == "pipe":
        hold_dp(gaps, None, what)
    else:
        hold_dp(gaps, None, what, route=True, first_grad=EP_FIRST_GRAD)
    for r in ranks:
        for s in DP_STAGES:
            st = r[s]
            only(st["launches"], **{k: n * DP_STEPS
                                    for k, n in per_step.items()})
            if st["state_bytes"] != dict.fromkeys(
                    ("params", "mu", "nu", "ema"), st["sharded_size"]) \
                    or st["sharded_size"] >= st["replicated_bytes"]:
                raise RuntimeError(f"{what} state: {st['state_bytes']}, "
                                   f"sharded_size {st['sharded_size']}")
            for k, v in ranks[0][s]["replicated"].items():
                if not torch.equal(st["replicated"][k], v):
                    raise RuntimeError(f"{what} stage {s}: the ranks' "
                                       f"replicated {k} differ")
    return gaps


def axis_fit_hold(name: str, axis: str, root: Path, fits: list) -> None:
    """Raise unless the ranks' ``axis_fit`` runs (under ``root``) agree:
    their histories equal and finite, the ``best_model`` holding rank 0's
    gathered best weights bit for bit in the one-process layout, loaded by
    a one-process ``Trainer`` (``resume``) with the same bits and served by
    ``load_engine`` (12 #1 a batch, 6 on the MoE flagship)."""
    from rovit_kan_tpu_torch.models.rovit_kan import build_model
    from rovit_kan_tpu_torch.serving import load_engine
    from rovit_kan_tpu_torch.training.trainer import Trainer
    from rovit_kan_tpu_torch.utils.checkpoint import load_checkpoint
    if any(f["history"] != fits[0]["history"] for f in fits[1:]):
        raise RuntimeError(f"{name} fit: the ranks' histories differ: "
                           f"{[f['history'] for f in fits]}")
    for part in ("train", "val"):
        for m in fits[0]["history"][part]:
            if not np.isfinite(m["total_loss"]):
                raise RuntimeError(f"{name} fit: non-finite {part} {m}")
    best = Path(fits[0]["best_model"])
    ck = load_checkpoint(best)
    cfg = axis_config(axis, dp_config(root / axis))
    tr = Trainer(build_model(cfg, device="cuda", seed=1), None, None, cfg,
                 seed=0)
    tr.resume("best_model")
    loaded = tr.model.state_dict()
    if list(ck["params"]) != list(loaded):
        raise RuntimeError(f"{name} checkpoint: not the one-process "
                           f"layout")
    for k, v in fits[0]["best_params"].items():
        if not (torch.equal(ck["params"][k], v)
                and torch.equal(loaded[k].cpu(), v)):
            raise RuntimeError(f"{name} checkpoint: {k} is not the ranks' "
                               f"gathered best weights")
    reset, read = all_counters()
    engine = load_engine(best, device="cuda")
    torch.cuda.synchronize()
    reset()
    probs = engine.predict(uint8_batch(26, BATCH))["cls_probs"]
    only(read(), vit_block_fwd=6 if axis == "expert" else 12)
    if not np.isfinite(probs).all() or probs.shape != (BATCH, 4):
        raise RuntimeError(f"{name} checkpoint serves {probs}")


def axis_line(smi, root, backend, single, exact, ranks, axis: str) -> dict:
    """The "ep" or "pp" phase from the ranks' runs (module docstring,
    phases 24 and 25): the steps held against the one-process steps
    (``axis_ranks_hold``), each rank's experts or blocks, the fit's
    checkpoint loaded by a one-process ``Trainer`` with the ranks' bits
    and served; each rank's peak memory and step ms beside its "dp"
    figures."""
    name = "ep" if axis == "expert" else "pp"
    runs = [r[name] for r in ranks]
    per = 6 if axis == "expert" else 6 * PP_MICRO
    gaps = axis_ranks_hold(name, single, exact,
                           [x["steps"] for x in runs],
                           {"vit_block_fwd": per, "vit_block_bwd": per,
                            "augment": 1}, axis)
    last = DP_STAGES[-1]
    holds = [x["steps"][last]["holds"] for x in runs]
    want = ([MOE_EXPERTS // DP_RANKS] * DP_RANKS if axis == "expert"
            else [[r * 6, r * 6 + 6] for r in range(DP_RANKS)])
    if holds != want:
        raise RuntimeError(f"{name}: the ranks hold {holds}, want {want}")
    fits = [x["fit"] for x in runs]
    axis_fit_hold(name, axis, root, fits)
    launches = {f"rank{r}": {
        k: sum(x["steps"][s]["launches"][k] for s in DP_STAGES)
        + x["fit"]["launches"][k] for k in x["fit"]["launches"]}
        for r, x in enumerate(runs)}
    return {"phase": name if backend == "gloo" else f"{name}_nccl",
            "ranks": DP_RANKS, "mesh": runs[0]["mesh"],
            "batch_size": BATCH, "steps": DP_STEPS, "holds": holds,
            **({"microbatches": PP_MICRO, "fit_microbatches":
                fits[0]["n_micro"]} if axis == "pipe" else
               {"experts": MOE_EXPERTS}),
            "first_loss_rel": {s: g["loss_rel"][0] for s, g in gaps.items()},
            "grad_norm_rel": {s: g["grad_norm_rel"] for s, g in gaps.items()},
            "fp32_grad_norm_rel": {s: g["fp32_grad_norm_rel"]
                                   for s, g in gaps.items()},
            "state_bytes": {f"rank{r}": x["steps"][last]["state_bytes"]
                            for r, x in enumerate(runs)},
            "sharded_size": runs[0]["steps"][last]["sharded_size"],
            "replicated_bytes": runs[0]["steps"][last]["replicated_bytes"],
            "peak_mib": {f"rank{r}": {
                "dp": ranks[r]["steps"][last]["peak_mib"],
                name: x["steps"][last]["peak_mib"]}
                for r, x in enumerate(runs)},
            "single_peak_mib": single[last]["peak_mib"],
            "rank_step_ms": {f"rank{r}": {
                "dp": ranks[r]["steps"][last]["ms"],
                name: x["steps"][last]["ms"]} for r, x in enumerate(runs)},
            "single_step_ms": single[last]["ms"],
            "losses": {"single": single[last]["loss"],
                       "rank0": runs[0]["steps"][last]["loss"]},
            "fit": {k: fits[0][k] for k in ("history", "fit_seconds",
                                            "steps", "val_batches")},
            "seconds": [x["seconds"] for x in runs],
            "launches": launches, "card": smi}


#: Parameter bytes a rank on data x pipe 2 x model 2: the "pp" stage's
#: 12,148,840 less half of each of its six blocks' 443,712 Megatron-sharded
#: bytes (the JAX ``sharded_size`` under ``pipeline_param_specs(tp=True)``,
#: tests/test_torch_pipeline_tp.py).
PP_TP_PARAM_BYTES = 6_824_296
PP_TP_RANKS = 4


def served_cat(outputs: list) -> dict:
    """A list of served dicts as one dict, each output's rows in order."""
    return {k: np.concatenate([o[k] for o in outputs]) for k in outputs[0]}


def serve_mesh_line(smi, root, phase: str, ranks) -> dict:
    """The "serve_mesh" phase (module docstring, phase 26) from the ranks'
    ``serve_mesh_worker`` runs (``ranks[r]["serve_mesh"]``) over the "dp"
    fit's checkpoint under ``root``, on a line named ``phase``: rank 0's
    outputs held
    against the one-process engine on the same checkpoint and requests by
    ``hold_served``'s rule (the one-process bf16 engine as the plain
    reference, the fp32 model's engine as the exact one), whether the bits
    are equal, 12 #1 a batch on every rank and no other launch, and the
    served img/s and latencies beside the one-process engine's."""
    from rovit_kan_tpu_torch.evaluation.evaluator import \
        load_model_for_evaluation
    from rovit_kan_tpu_torch.serving import InferenceEngine, load_engine
    runs = [r["serve_mesh"] for r in ranks]
    lead = runs[0]
    best = dp_best(root)
    engine = load_engine(best, batch_size=BATCH, device="cuda")
    engine.warmup()
    one = serve_mesh_run(engine)
    model32, _ = load_model_for_evaluation(best, device="cuda",
                                           dtype=torch.float32)
    exact = serve_mesh_run(InferenceEngine(
        model32, batch_size=BATCH, temperature=engine.temperature,
        device="cuda"))
    got, want, ref = (served_cat(x["outputs"]) for x in (lead, one, exact))
    sizes = SERVE_MESH_PREDICT + SERVE_MESH_BATCHED
    if [o["cls_probs"].shape[0] for o in lead["outputs"]] != list(sizes):
        raise RuntimeError(f"{phase}: served row counts differ from the "
                           f"requests'")
    checks, failed = hold_served(got, want, ref, keys=SERVED_KEYS[1:])
    if failed or lead["temperature"] != engine.temperature:
        raise RuntimeError(f"{phase}: {failed} out of tolerance ({checks}), "
                           f"T {lead['temperature']} vs {engine.temperature}")
    batches = lead["stats"]["requests"]
    for r, x in enumerate(runs):
        only(x["launches"], vit_block_fwd=12 * batches)
    only(one["launches"], vit_block_fwd=12 * one["stats"]["requests"])
    only(exact["launches"])
    if lead["stats"]["images_served"] != sum(sizes):
        raise RuntimeError(f"{phase}: stats count {lead['stats']} images, "
                           f"the requests {sum(sizes)}")
    rates = ("images_per_sec", "p50_latency_ms", "p95_latency_ms")
    return {"phase": phase, "ranks": len(runs), "mesh": lead["mesh"],
            "batch_size": BATCH,
            "requests": list(sizes), "batches": batches,
            "single_batches": one["stats"]["requests"],
            "rows_per_rank": BATCH // len(runs),
            "same_bits": all(np.array_equal(got[k], want[k]) for k in want),
            "outputs": checks,
            "mesh_served": {k: lead["stats"][k] for k in rates},
            "single_served": {k: one["stats"][k] for k in rates},
            "seconds": {"mesh": lead["seconds"], "single": one["seconds"]},
            "temperature": lead["temperature"],
            "launches": {f"rank{r}": x["launches"]
                         for r, x in enumerate(runs)}, "card": smi}


def pp_tp_line(smi, root, backend, one, runs, dp_ranks=None) -> dict:
    """The "pp_tp" phase (module docstring, phase 27) from the four ranks'
    ``axis_worker`` runs on data 1 x pipe 2 x model 2 (``runs``): the steps
    held by ``hold_dp``'s rules for another route against the one-process
    bf16 steps on #1/#2 and on the TP route and the fp32 steps
    (``tp_ranks_hold``, gaps on a "pp_tp_readings" line), 24 #5, 24 #6 and
    1 #7 a step, each rank's
    blocks and ``PP_TP_PARAM_BYTES``; the fit checked as the "pp" fit
    (``axis_fit_hold``); each rank's peak memory and step ms beside the "pp"
    and "tp" ranks' (``dp_ranks``, the two "dp" ranks)."""
    per = 6 * PP_MICRO
    # Not the "tp" phase's first loss within 1e-4 of the routed step's: a
    # stage's GEMMs run on microbatches of 16 rows, where cuBLAS may take
    # other kernels than at 64 and round otherwise (3.5e-4 on the card,
    # fp32's own 2.7e-4; the same bits in the CPU rehearsal).
    gaps = tp_ranks_hold("pp_tp", one, [x["steps"] for x in runs],
                         {"attention_fwd": per, "attention_bwd": per,
                          "augment": 1}, PP_TP_PARAM_BYTES,
                         line="pp_tp_readings", first_routed=None)
    last = DP_STAGES[-1]
    holds = [x["steps"][last]["holds"] for x in runs]
    want = [[r // 2 * 6, r // 2 * 6 + 6] for r in range(PP_TP_RANKS)]
    if holds != want:
        raise RuntimeError(f"pp_tp: the ranks hold {holds}, want {want}")
    fits = [x.get("fit") for x in runs]
    if fits[0] is not None:
        axis_fit_hold("pp_tp", "pipe", root, fits)
    others = {}
    for r, x in enumerate(dp_ranks or []):
        others[f"rank{r}"] = {
            "pp": {k: x["pp"]["steps"][last][k] for k in ("peak_mib", "ms")},
            "tp": {k: x["tp"]["steps"]["tp"][last][k]
                   for k in ("peak_mib", "ms")}}
    launches = {f"rank{r}": {
        k: sum(x["steps"][s]["launches"][k] for s in DP_STAGES)
        + (x["fit"]["launches"][k] if fits[0] is not None else 0)
        for k in x["steps"][last]["launches"]} for r, x in enumerate(runs)}
    return {"phase": "pp_tp" if backend == "gloo" else "pp_tp_nccl4",
            "ranks": len(runs), "mesh": runs[0]["mesh"],
            "batch_size": BATCH, "steps": DP_STEPS, "holds": holds,
            "microbatches": PP_MICRO,
            "first_loss_rel": {ref: {s: g["loss_rel"][0]
                                     for s, g in gaps[ref].items()}
                               for ref in gaps},
            "grad_norm_rel": {ref: {s: g["grad_norm_rel"]
                                    for s, g in gaps[ref].items()}
                              for ref in gaps},
            "state_bytes": {f"rank{r}": x["steps"][last]["state_bytes"]
                            for r, x in enumerate(runs)},
            "sharded_size": runs[0]["steps"][last]["sharded_size"],
            "peak_mib": {f"rank{r}": x["steps"][last]["peak_mib"]
                         for r, x in enumerate(runs)},
            "rank_step_ms": {f"rank{r}": x["steps"][last]["ms"]
                             for r, x in enumerate(runs)},
            "pp_and_tp_ranks": others,
            "single_step_ms": one["single"][last]["ms"],
            "routed_step_ms": one["routed"][last]["ms"],
            **({"fit": {k: fits[0][k] for k in (
                "history", "fit_seconds", "steps", "val_batches",
                "n_micro")}} if fits[0] is not None else {}),
            "seconds": [x["seconds"] for x in runs],
            "launches": launches, "card": smi}


def four_card_phases(smi: str, root: Path, one) -> list:
    """The four-card lines (``--nccl`` with four visible): FSDP+TP on data
    2 x model 2, the flagship's steps held as the "tp" phase's (24 #5 a
    step: a unit's forward runs again in its backward; 12 #6, 1 #7), each
    rank's 6,139,112 B of parameters; then the "ep" and "pp" steps on data
    2 x expert 2 and data 2 x pipe 2, held as phases 24 and 25 hold theirs
    (``axis_ranks_hold``); the "pp_tp" steps on data 1 x pipe 2 x model 2
    held as phase 27's; the "dp" fit served over data 4 as phase 26
    serves it."""
    root.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ranks = run_ranks(root, 4, "nccl", worker="--tp4-worker")
    lines = [fsdp_tp_line(smi, one, ranks, t0)]
    for name, axis, (single, exact) in (
            ("ep", "expert", (one["moe_single"], one["moe_exact"])),
            ("pp", "pipe", (one["single"], one["exact"]))):
        per = 6 if axis == "expert" else 6 * PP_MICRO
        runs = [r[name]["steps"] for r in ranks]
        gaps = axis_ranks_hold(f"{name}4", single, exact, runs,
                               {"vit_block_fwd": per, "vit_block_bwd": per,
                                "augment": 1}, axis)
        last = DP_STAGES[-1]
        lines.append({
            "phase": f"{name}_nccl4", "ranks": 4,
            "mesh": ranks[0][name]["mesh"],
            "first_loss_rel": {s: g["loss_rel"][0] for s, g in gaps.items()},
            "grad_norm_rel": {s: g["grad_norm_rel"]
                              for s, g in gaps.items()},
            "holds": [x[last]["holds"] for x in runs],
            "state_bytes": {f"rank{r}": x[last]["state_bytes"]
                            for r, x in enumerate(runs)},
            "peak_mib": {f"rank{r}": x[last]["peak_mib"]
                         for r, x in enumerate(runs)},
            "rank_step_ms": {f"rank{r}": x[last]["ms"]
                             for r, x in enumerate(runs)},
            "seconds": [r[name]["seconds"] for r in ranks], "card": smi})
    lines.append(pp_tp_line(smi, root, "nccl", one,
                            [r["pp_tp"] for r in ranks]))
    lines.append(serve_mesh_line(smi, root.parent / "dp", "serve_mesh_nccl4",
                                 ranks))
    return lines


def fsdp_tp_line(smi: str, one, ranks, t0: float) -> dict:
    """The "fsdp_tp_nccl" line from the four ranks' FSDP+TP steps."""
    gaps = tp_ranks_hold("fsdp_tp", one, [r["steps"] for r in ranks],
                         {"attention_fwd": 24, "attention_bwd": 12,
                          "augment": 1}, FSDP_TP_PARAM_BYTES)
    last = DP_STAGES[-1]
    return {"phase": "fsdp_tp_nccl", "ranks": 4, "mesh": ranks[0]["mesh"],
            "gaps": gaps, "sharded_size": ranks[0]["steps"][last][
                "sharded_size"],
            "state_bytes": {f"rank{r}": x["steps"][last]["state_bytes"]
                            for r, x in enumerate(ranks)},
            "peak_mib": {f"rank{r}": x["steps"][last]["peak_mib"]
                         for r, x in enumerate(ranks)},
            "rank_step_ms": {f"rank{r}": x["steps"][last]["ms"]
                             for r, x in enumerate(ranks)},
            "launches": {f"rank{r}": {k: sum(
                x["steps"][s]["launches"][k] for s in DP_STAGES)
                for k in x["steps"][last]["launches"]}
                for r, x in enumerate(ranks)},
            "seconds": time.perf_counter() - t0, "card": smi}


def baselines_dp_line(smi, root, backend, one, ranks) -> dict:
    """The "baselines_dp" phase (module docstring, phase 22): the ranks'
    first ResNet-50 step and ``cli.run_baselines`` sweep against the
    one-process ones of the same call."""
    b = [r["baselines"] for r in ranks]
    sweeps = [x["sweep"] for x in b]
    for n in BASELINE_DP_MODELS:
        for k, v in sweeps[0]["state"][n].items():
            if not torch.equal(v, sweeps[1]["state"][n][k]):
                raise RuntimeError(f"baselines dp: the ranks' {n} {k} "
                                   f"differ")
    first, want = b[0]["first_step"], one["first_step"]
    rev = one["first_step_reversed"]
    stats_floor = 1e-2
    # The yardstick: the one-process step's own distance from itself with
    # the rows reversed. BatchNorm's backward cancels, so another summation
    # order moves a deep leaf by up to ~1e-2 of its largest magnitude, and
    # which leaf moves most is itself noise: each leaf is held against the
    # largest such move over the leaves, the whole gradient in L2.
    own = of_max(rev["grads"], want["grads"], 1e-2)
    ranks_gap = of_max(first["grads"], want["grads"], 1e-2)
    noise = max(max(own.values()), 1e-4)
    def flat(grads):
        return torch.cat([grads[k].reshape(-1) for k in want["grads"]])

    ref = flat(want["grads"])
    whole = {name: float((flat(g) - ref).norm() / ref.norm())
             for name, g in (("ranks", first["grads"]),
                             ("reversed", rev["grads"]))}
    first_gaps = {
        "metrics": {k: abs(first["metrics"][k] - want["metrics"][k])
                    for k in want["metrics"]},
        "grads_of_max": worst(ranks_gap), "reversed_of_max": worst(own),
        "grad_l2_rel": whole,
        "stats": worst(of_max(first["stats"], want["stats"], stats_floor))}
    if max(first_gaps["metrics"].values()) > 1e-4 or max(
            ranks_gap.values()) > 2 * noise or whole["ranks"] > 2 * max(
            whole["reversed"], 1e-6) or max(
            first_gaps["stats"].values()) > 1e-4:
        raise RuntimeError(f"baselines dp first step: {first_gaps}")
    one_sweep = one["sweep"]
    sweep_gaps = {}
    for n in BASELINE_DP_MODELS:
        got, ref = sweeps[0]["state"][n], one_sweep["state"][n]
        steps = one_sweep["steps"][n]
        if sweeps[0]["steps"][n] != steps:
            raise RuntimeError(f"baselines dp {n}: {sweeps[0]['steps'][n]} "
                               f"steps, one process {steps}")
        stats = {k: v for k, v in ref.items()
                 if k.endswith(("running_mean", "running_var"))}
        params = {k: v for k, v in ref.items() if k not in stats
                  and not k.endswith("num_batches_tracked")}
        # Adam moves an element by about lr a step whatever its gradient,
        # so two runs whose gradients differ by rounding part by up to a
        # few lr a step on the elements BatchNorm makes rounding noise, and
        # their batch moments with them: the sweep is held loosely, the
        # first step holds the arithmetic.
        lr_units = max(float((got[k] - v).abs().max()) for k, v in
                       params.items()) / (one_sweep["lr"] * steps)
        sweep_gaps[n] = {"params_lr_steps": lr_units}
        if stats:
            sweep_gaps[n]["stats"] = worst(of_max(
                {k: got[k] for k in stats}, stats, stats_floor))
        if lr_units > 4.0 or (stats and max(
                sweep_gaps[n]["stats"].values()) > 5e-2):
            raise RuntimeError(f"baselines dp {n}: {sweep_gaps[n]}")
    fps_launch = {"vit_block_fwd": 12 * FPS_FORWARDS}
    for r, sw in enumerate(sweeps + [one_sweep]):
        for n in BASELINE_DP_MODELS:
            only(sw["launches"][n], **(fps_launch if n == "deit_tiny"
                                       and r != 1 else {}))
    csvs = {k: (root / k / "baseline_comparison.csv").read_text()
            .splitlines() for k in ("baselines_dp", "baselines_one")}
    if csvs["baselines_dp"][0] != csvs["baselines_one"][0] or sorted(
            r.split(",")[0] for r in csvs["baselines_dp"][1:]) != sorted(
            BASELINE_DP_MODELS):
        raise RuntimeError(f"baselines dp CSV: {csvs}")
    return {"phase": "baselines_dp" if backend == "gloo"
            else "baselines_dp_nccl",
            "ranks": DP_RANKS, "models": list(BASELINE_DP_MODELS),
            "first_step_gaps": first_gaps, "sweep_gaps": sweep_gaps,
            "sweep_seconds": {"rank0": sweeps[0]["seconds"],
                              "rank1": sweeps[1]["seconds"],
                              "one_process": one_sweep["seconds"]},
            "results": {"ranks": sweeps[0]["results"],
                        "one_process": one_sweep["results"]},
            "launches": {f"rank{r}": {k: sum(sw["launches"][n][k]
                                             for n in BASELINE_DP_MODELS)
                                      for k in sw["launches"]["deit_tiny"]}
                         for r, sw in enumerate(sweeps)},
            "csv_header": csvs["baselines_dp"][0], "card": smi}


#: What the lines of phases 20-26 say of their times under gloo.
PP_TP_BESIDE = ("pp_tp's four ranks ran on the same card and host "
                "meanwhile: every time of this line (step ms, img/s, "
                "seconds) was read under their load")


def dp_phase(smi: str, root: Path, backend: str = "gloo"):
    """Data parallelism (module docstring, phase 20): two ranks on cuda:0
    through gloo, or with ``nccl`` on cuda:0 and cuda:1 (``--nccl``); the
    same ranks run the "fsdp", "baselines_dp", "tp", "ep", "pp" and
    "serve_mesh" phases (21-26); under gloo four more ranks on cuda:0 run
    "pp_tp" (27), started first and alongside the rest, since they need
    nothing of it (their step ms are read on a card and host shared with
    the two ranks and this process). Returns the phases' lines and the
    one-process steps the ranks were held against (bf16 on #1/#2, bf16 on
    the TP route, fp32; the MoE flagship's bf16 and fp32)."""
    root.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    pp_tp = None
    if backend == "gloo":
        pp_root = root / "pp_tp"
        pp_root.mkdir(parents=True, exist_ok=True)
        # A worker thread: the interpreter waits for it at exit, so its
        # ranks end (or time out) before this process does.
        pp_tp = concurrent.futures.ThreadPoolExecutor(1).submit(
            run_ranks, pp_root, PP_TP_RANKS, backend, "--pp-tp-worker")
    single = {s: dp_steps(None, s) for s in DP_STAGES}
    exact = {s: dp_steps(None, s, fp32=True) for s in DP_STAGES}
    # The baselines' one-process runs first: the sweep writes the tree the
    # ranks read.
    one_baselines = {
        "first_step": baselines_first_step(None),
        "first_step_reversed": baselines_first_step(None, reverse=True),
        "sweep": baselines_sweep(root, "baselines_one",
                                 ["--synthetic", "--devices", "1"])}
    ranks = run_ranks(root, DP_RANKS, backend)
    fsdped = fsdp_line(smi, root, backend, single, exact, ranks)
    one = {"single": single, "exact": exact,
           "routed": {s: dp_steps(None, s, route=True) for s in DP_STAGES}}
    tped = tp_line(smi, root, backend, one, ranks)
    one["moe_single"] = {s: dp_steps(None, s, moe=True) for s in DP_STAGES}
    one["moe_exact"] = {s: dp_steps(None, s, fp32=True, moe=True)
                        for s in DP_STAGES}
    eped = axis_line(smi, root, backend, one["moe_single"],
                     one["moe_exact"], ranks, "expert")
    pped = axis_line(smi, root, backend, single, exact, ranks, "pipe")
    smed = serve_mesh_line(smi, root, "serve_mesh" if backend == "gloo"
                           else "serve_mesh_nccl", ranks)
    baselined = baselines_dp_line(smi, root, backend, one_baselines, ranks)
    gaps = {s: dp_gaps(single[s], exact[s], [r["steps"][s] for r in ranks])
            for s in DP_STAGES}
    emit({"phase": "dp_readings", "backend": backend, "gaps": gaps,
          "card": smi})
    hold_dp(gaps, ranks)
    for r, rank in enumerate(ranks):
        for s in DP_STAGES:
            only(rank["steps"][s]["launches"], vit_block_fwd=12 * DP_STEPS,
                 vit_block_bwd=12 * DP_STEPS, augment=DP_STEPS)
    steps = [r["steps"][DP_STAGES[-1]] for r in ranks]
    single = single[DP_STAGES[-1]]
    fits = [r["fit"] for r in ranks]
    if not torch.equal(fits[0]["params"], fits[1]["params"]) or not \
            np.array_equal(fits[0]["served"], fits[1]["served"]) or \
            fits[0]["temperature"] != fits[1]["temperature"]:
        raise RuntimeError("dp fit: the ranks' weights, temperatures or "
                           "served outputs differ")
    for f in fits:
        for part in ("train", "val"):
            for m in f["history"][part]:
                if not np.isfinite(m["total_loss"]):
                    raise RuntimeError(f"dp fit: non-finite {part} {m}")
    cli = (world_one_run(root / "world1") if backend == "gloo"
           else nccl_cli_run(root / "cli"))
    launches = {f"rank{r}": {k: fits[r]["launches"][k] + sum(
        ranks[r]["steps"][s]["launches"][k] for s in DP_STAGES)
        for k in fits[r]["launches"]} for r in range(DP_RANKS)}
    dped = {"phase": "dp" if backend == "gloo" else "dp_nccl",
            "ranks": DP_RANKS, "meshes": [r["mesh"] for r in ranks],
            "batch_size": BATCH, "steps": DP_STEPS,
            "single_step_ms": single["ms"],
            "rank_step_ms": {f"rank{r}": s["ms"] for r, s in
                             enumerate(steps)},
            # The global batch a second, as each rank sees it (the first
            # step, with its set-up, left out).
            "rank_images_per_sec": {
                f"rank{r}": BATCH * 1e3 * (DP_STEPS - 1) / sum(s["ms"][1:])
                for r, s in enumerate(steps)},
            "single_images_per_sec": BATCH * 1e3 * (DP_STEPS - 1)
            / sum(single["ms"][1:]),
            "losses": {"single": single["loss"],
                       **{f"rank{r}": s["loss"] for r, s in enumerate(steps)}},
            "fit": {k: fits[0][k] for k in ("history", "fit_seconds",
                                            "steps", "val_batches",
                                            "shard_rows", "launches",
                                            "temperature")},
            "launches": launches, "cli": cli,
            "seconds": time.perf_counter() - t0, "card": smi}
    lines = [dped, fsdped, baselined, tped, eped, pped, smed]
    if pp_tp is not None:
        for line in lines:
            line["timed_beside"] = PP_TP_BESIDE
        # Four ranks on the one card: the 3-D mesh (the four-card NCCL run
        # takes it with --nccl).
        runs = [r["pp_tp"] for r in pp_tp.result()]
        lines.append(pp_tp_line(smi, pp_root, backend, one, runs, ranks))
    return lines, one


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rovit_kan_tpu_torch.ops import _build
    from rovit_kan_tpu_torch.ops import block_kernel as bk

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch_name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    ptxas = {src: ptxas_table(log) for src, log in logs.items()}
    emit({"phase": "build", "sources": sorted(logs),
          "seconds": time.perf_counter() - t0, "ptxas": ptxas})
    spilled = [row for src in ("vit_block_fwd", "vit_block_bwd_f32")
               for row in ptxas[src]
               if row[0].startswith(MAIN_PATH_TF32) and row[2]]
    kan_rows = [row for row in ptxas["kan_module"]
                if row[0].startswith(MAIN_PATH_KAN)]
    if len(kan_rows) != 4:
        raise RuntimeError(f"want 4 main-path KAN instances, ptxas lists "
                           f"{kan_rows}")
    spilled += [row for row in kan_rows
                if row[2] > KAN_SPILL_BYTES.get(row[0], 0)]
    if spilled:
        raise RuntimeError(f"main-path instances spill: {spilled}")

    bf16 = check_block(torch.bfloat16, seed=0)
    fp32 = check_block(torch.float32, seed=1)
    bwd16 = check_block_bwd(torch.bfloat16, seed=2)
    bwd32 = check_block_bwd(torch.float32, seed=3)
    aug = augment_checks()
    aug16, aug32 = aug["bf16"], aug["fp32"]
    kan = check_kan(seed=6)
    kan_widths = kan.pop("kan_layer_widths")
    emit({"phase": "kernels", "vit_block_fwd": [bf16, fp32],
          "vit_block_bwd": [bwd16, bwd32],
          "augment": [aug16, aug32, aug["n384"], *aug["odd"]], **kan,
          "card": smi})
    emit({"phase": "kan_layer_widths", "layers": kan_widths, "card": smi})
    preset_kernels = {p: check_preset_blocks(p, seed=30 + i)
                      for i, p in enumerate(PRESET_BLOCKS)}
    emit({"phase": "preset_kernels", **preset_kernels, "card": smi})

    result = serve(smi)
    emit(result)
    trained = train(smi)
    emit(trained)
    kanned = kan_phase(smi)
    emit(kanned)
    longed, attn, blocks577 = long_phase(smi)
    emit(longed)
    fitted, res_kernels = fit_phase(smi)
    emit(fitted)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_eval_"))
    try:
        evaled = eval_phase(smi, root)
        emit(evaled)
        best = root / "train" / "checkpoints" / "best_model"
        presets = presets_phase(smi, root)
        emit(presets)
        exported = export_phase(smi, root, best)
        emit(exported)
        served = serve_cli_phase(smi, best)
        emit(served)
        explained = explain_phase(smi, root, best)
        emit(explained)
        ablated = ablation_phase(smi, root)
        emit(ablated)
        baselined = baselines_phase(smi, root)
        emit({"phase": "baselines_readings",
              "per_model": {n: {k: r[k] for k in (
                  "train_seconds", "first_epoch_images_per_sec",
                  "train_images_per_sec", "fps_bs1")} | {
                  "device_ops": r["train_step_profile"]["kernel_launches"],
                  "device_busy_share":
                      r["train_step_profile"]["device_busy_share"]}
                  for n, r in baselined["readings"].items()},
              "card": smi})
        emit(baselined)
        pretrained = pretrained_phase(smi, root)
        emit(pretrained)
        moed = moe_phase(smi, root)
        emit(moed)
        emit(native_phase(smi, root))
        lines, _ = dp_phase(smi, root / "dp")
        for line in lines:
            emit(line)
        dped, fsdped, bdped, tped, eped, pped, smed, ptd = lines
    finally:
        shutil.rmtree(root, ignore_errors=True)
    benched = bench_phase(smi)
    emit(benched)

    keys = ("max_abs_err", "kernel_ms", "plain_ms", "bound_ms", "library_ms")

    def entry(name, source, replaces, launches, lo, hi, more=(), **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": lo["max_abs_err"], "ms": lo["kernel_ms"],
                "plain_ms": lo["plain_ms"], "bound_ms": lo["bound_ms"],
                "bound_by": lo["bound_by"], "library_ms": lo["library_ms"],
                **{k: lo[k] for k in more}, **extra,
                "fp32": {k: hi[k] for k in keys + more}}

    # Beside the common keys: #1's and #3's graph-replay device times and
    # #1's stages; #2's and #4's graph times, their stages beside the
    # stages' bounds, and the layer's forward + backward and its backward
    # alone by profiler device time.
    more1 = ("kernel_graph_ms", "library_graph_ms", "stages_device_ms",
             "stages_bound_ms")
    more2 = ("kernel_graph_ms", "stages_device_ms", "stages_bound_ms",
             "library_device_ms", "library_bwd_device_ms",
             "port_fwd_bwd_device_ms")
    more3 = ("kernel_graph_ms", "library_graph_ms")
    more4 = ("kernel_graph_ms", "stages_device_ms", "stages_bound_ms",
             "library_device_ms", "library_bwd_device_ms")
    # #7's graph-replay and per-launch profiler device times.
    more7 = ("kernel_graph_ms", "device_ms_by_kernel")

    csrc = "rovit_kan_tpu_torch/csrc/"

    def kan_entry(name, line, r, phase):
        by_path = {"serve": phase["serve_launches"][name],
                   "trajectory": phase["trajectory_launches"][name],
                   "train": phase["train_launches"][name]}
        return {"name": name, "route": "cuda",
                "source": csrc + "kan_module.cu",
                "replaces": f"rovit_kan_tpu/ops/kan_kernel.py:{line}",
                "launches": sum(by_path.values()),
                "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "kernel_graph_ms": r["kernel_graph_ms"],
                "launch_floor_ms": r["launch_floor_ms"],
                "call_ms": r["call_ms"], "plain_call_ms": r["plain_call_ms"],
                "launches_by_path": by_path}

    def n577(i, more):
        return {str(d).replace("torch.", ""):
                {k: r[i][k] for k in keys + more}
                for d, r in blocks577.items()}

    def long_launches(name):
        by_path = {path: longed[path]["launches"][name] for path in (
            "serve_auto", "serve_attention", "train_attention",
            "train_auto")}
        fp32 = longed["fp32_attention_arm"]["launches"]
        by_path.update({"serve_attention_fp32": fp32["serve"][name],
                        "train_attention_fp32": fp32["train"][name]})
        return by_path

    # Beside the common keys: the graph-replay device times, the route, and
    # SDPA's kernels; for #6 also SDPA's forward + backward, its training
    # forward and its backward alone, and the port's #5 + #6 under
    # autograd, by CUDA-graph replay.
    attn_more = (("kernel_graph_ms", "library_graph_ms", "design",
                  "device_source", "library_kernels"),
                 ("kernel_graph_ms", "design", "device_source",
                  "library_device_ms", "library_fwd_device_ms",
                  "library_bwd_device_ms", "library_kernels",
                  "port_fwd_bwd_ms", "port_fwd_bwd_device_ms",
                  "port_bwd_device_ms"))

    def attn_entry(name, line, i):
        by_path = long_launches(name)
        lo = attn[LONG_TOKENS, torch.bfloat16][i]
        hi = attn[LONG_TOKENS, torch.float32][i]
        more = attn_more[i]
        out = entry(name, csrc + "attention.cu",
                    f"rovit_kan_tpu/ops/attention.py:{line}",
                    sum(by_path.values()), lo, hi, more,
                    launches_by_path=by_path, library=lo["library"],
                    n197={str(d).replace("torch.", ""):
                          {k: attn[TOKENS, d][i][k] for k in keys + more}
                          for d in (torch.bfloat16, torch.float32)})
        out["fp32"]["fma_bound_ms"] = hi["fma_bound_ms"]
        out["n197"]["float32"]["fma_bound_ms"] = \
            attn[TOKENS, torch.float32][i]["fma_bound_ms"]
        return out

    def res_entry(name, source, line, i):
        by_path = {"fit": fitted["fit_launches"][name],
                   "resume": fitted["resume_launches"][name]}
        lo = res_kernels[TOKENS, torch.bfloat16][i]
        more = more3 if i == 0 else more4
        return entry(name, csrc + source,
                     f"rovit_kan_tpu/ops/block_kernel.py:{line}",
                     sum(by_path.values()), lo,
                     res_kernels[TOKENS, torch.float32][i], more,
                     launches_by_path=by_path,
                     n577={str(d).replace("torch.", ""):
                           {k: res_kernels[LONG_TOKENS, d][i][k]
                            for k in keys + more}
                           for d in (torch.bfloat16, torch.float32)},
                     **({k: lo[k] for k in ("port_fwd_bwd_ms",
                                              "port_fwd_bwd_device_ms")}
                        if i else {}))

    fwd1 = entry("vit_block_fwd", csrc + "vit_block_fwd.cu",
                 "rovit_kan_tpu/ops/block_kernel.py:92",
                 result["block_launches"], bf16, fp32, more1,
                 train_launches=trained["launches"]["vit_block_fwd"],
                 long_launches=long_launches("vit_block_fwd"),
                 eval_launches={
                     path: evaled[path]["launches"]["vit_block_fwd"]
                     for path in ("train_cli", "evaluate_cli_host",
                                  "evaluate_cli_device")} | {
                     "load_engine": evaled["serve_launches"]["vit_block_fwd"],
                     "evaluator": evaled["evaluator_launches"][
                         "vit_block_fwd"]},
                 n577=n577(0, more1))
    fwd3 = res_entry("vit_block_res_fwd", "vit_block_fwd.cu", 227, 0)
    # The fp32 #1 and #3 run 3xTF32: their FMA bound beside the bound.
    fwd1["fp32"]["fma_bound_ms"] = fp32["fma_bound_ms"]
    fwd1["n577"]["float32"]["fma_bound_ms"] = \
        blocks577[torch.float32][0]["fma_bound_ms"]
    fwd3["fp32"]["fma_bound_ms"] = \
        res_kernels[TOKENS, torch.float32][0]["fma_bound_ms"]
    fwd3["n577"]["float32"]["fma_bound_ms"] = \
        res_kernels[LONG_TOKENS, torch.float32][0]["fma_bound_ms"]
    kernels = [
        fwd1,
        entry("vit_block_bwd", csrc + "vit_block_bwd.cu",
              "rovit_kan_tpu/ops/block_kernel.py:399",
              trained["launches"]["vit_block_bwd"], bwd16, bwd32, more2,
              port_fwd_bwd_ms=bwd16["port_fwd_bwd_ms"],
              long_launches=long_launches("vit_block_bwd"),
              n577=n577(1, more2)),
        entry("augment", csrc + "augment.cu",
              "rovit_kan_tpu/ops/augment_kernel.py:73",
              trained["launches"]["augment"], aug16, aug32, more7,
              n384={k: aug["n384"][k] for k in keys + more7},
              odd=aug["odd"])] + [
        kan_entry(name, line, kan[name], kanned)
        for name, line in (("kan_layer_fwd", 48), ("kan_layer_bwd", 129),
                           ("kan_module_fwd", 252),
                           ("kan_module_bwd", 367))] + [
        attn_entry("attention_fwd", 36, 0),
        attn_entry("attention_bwd", 120, 1)] + [
        fwd3,
        res_entry("vit_block_bwd_res", "vit_block_bwd.cu", 549, 1)]
    # The export, serve CLI and bench paths: the three artifacts' calls, the
    # serve CLI's process (its warm-up and every batch it served), cli.bench;
    # the explain paths: a rollout and a Grad-CAM++ call at 224 px, one
    # Grad-CAM++ call at 384 px, cli.visualize; the first ablation run; the
    # baseline sweep; the pretrained run and its served batch; the MoE
    # train, evaluate and serve calls and its forced-attention step.
    new_paths = {"export": exported["launches"],
                 "serve_cli": served["launches"],
                 "bench": benched["launches"],
                 "explain": explained["launches"],
                 "explain_384": explained["launches_384"],
                 "visualize": explained["visualize"]["launches"],
                 "ablation": ablated["launches"],
                 "baselines": baselined["launches"],
                 "pretrained": pretrained["launches"],
                 "moe": moed["launches"],
                 **{f"{name}_{r}": counts
                    for name, line in (("dp", dped), ("fsdp", fsdped),
                                       ("baselines_dp", bdped),
                                       ("ep", eped), ("pp", pped),
                                       ("serve_mesh", smed),
                                       ("pp_tp", ptd))
                    for r, counts in line["launches"].items()},
                 **tped["launches"],
                 **{f"presets_{kind}_{p}": r["launches"]
                    for kind in ("serve", "train")
                    for p, r in presets[kind].items()}}
    # #1-#4 at the small and base presets' widths (phase "preset_kernels").
    for e in kernels:
        by_preset = {p: {k: r[e["name"]][k] for k in keys + (
                         "bound_by", "shape", "heads")}
                     for p, r in preset_kernels.items() if e["name"] in r}
        if by_preset:
            e["presets"] = by_preset
    for e in kernels:
        e.setdefault("launches_by_path", {}).update(
            {path: counts[e["name"]] for path, counts in new_paths.items()})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def main_nccl() -> int:
    """``chip_smoke.py --nccl``: the "dp" phase over NCCL, rank r on
    cuda:r, on a host with two cards or more (module docstring)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --nccl: needs two visible cards", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rovit_kan_tpu_torch.ops import _build
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "torch_name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    _build.build(_build.all_sources())
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_nccl_"))
    try:
        lines, one = dp_phase(smi, root / "dp", backend="nccl")
        for line in lines:
            emit(line)
        if torch.cuda.device_count() >= 4:
            for line in four_card_phases(smi, root / "four", one):
                emit(line)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--tp4-worker"]:
        sys.exit(tp4_worker(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--pp-tp-worker"]:
        sys.exit(pp_tp_worker(sys.argv[2], sys.argv[3]))
    sys.exit(main_nccl() if sys.argv[1:] == ["--nccl"] else main())
