#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``cl_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile every kernel of ``cl_tpu_torch/csrc`` from the checkout;
3. kernels against their plain PyTorch versions on the card, at the
   shapes the training paths give them and at small ragged ones (~10%
   ignore pixels, one masked class where there are more than two), with
   the tolerance printed; the packed body's five forward and eight
   backward kernels at every shape of its 512² path and at 24² × 16
   channels, in f32 and bf16 (the conv's forward relaunched bit-equal;
   its bf16 forward and dx, the ring body, also at ragged shapes past
   every tile and picker branch of ``conv3x3.conv_ring_tile``: H not a
   multiple of 16, Cout past a channel tile of 64 and of 128, widths that
   take plain-load staging, 512 channels whose weights travel with each
   stage, odd widths; each ring launch's resident blocks an SM held
   against the picker's, its registers, spills and shared memory printed;
   the pool's backward plain and with the skip tee, the conv's dx with a prologue whose relu(b) > 0, nonzero
   stats cotangents); the packed head+CE with the BN·ReLU prologue (#7/#8)
   and its KD form (#11/#12) at the headline shape (2,097,152 pixels, 32
   channels, 19 classes, bf16) and at small f32 and ragged ones, each
   backward launched twice and held bit-equal; the KD head on NHWC
   features (#9/#10) at the full width, at 524,288 pixels x 64 channels
   -> 21 classes in f32 (base 64 with the fused head) and at a small
   ragged f32 case, and the KD on logits (#13/#14) at 2,097,152 x 19
   bf16, 524,288 x 21 f32 (baseline_2's model with LwF) and small ragged
   f32 and bf16 cases, each backward launched twice and held bit-equal,
   and each with an all-false old_valid (task 0's teacher): the KD and
   its gradient exactly 0; EWC's penalty (#17, also
   relaunched bit-equal and over two rows of a separate-mode state), its
   gradient (#18, a cotangent other than 1) and the Fisher accumulation
   (#19) at the flat param count of UNet-32 with 19 and with 21 classes
   and at a ragged 1,003; the replay gather (#20) on uint8 image and mask
   rows at 576² with k = 1, 4 and 8 and on a ragged 37·37·3-byte row,
   byte-equal; the augment kernels (#15 the image's resize, flip and
   normalization, #16 the mask's) at 576 → 512 with 8 and 9 images, 320 →
   256 and 160 → 128 with 8, and 50 → 32 with 3, flips mixed, in f32 and
   bf16: the mask bit-equal, the image within 1e-5 (f32) or one bf16 ulp;
   the gen-3 plain conv (#30) at baseline_2's 256² × 64 → 64, 128 → 64 and
   64 → 128 and at 64² × 256 → 256, its dW (#31) at 256² × 64 → 64 and 128 →
   64, in f32 and bf16, and the two-pass backward's dW (#33) at 64² × 256 →
   256 in f32 and bf16 with the prologue on and off, batch 8, and all three
   at a ragged 20² × 24 → 40 with 3 images, each launched twice and held
   bit-equal; #31 in bf16 at every ring tile that 5v-b's and 5n-b's convs
   take, with its splits and partials' bytes at the widest of them; #31,
   #33 and #41 (the bf16 ring and f32 register-blocked bodies) at
   ``DW_ODD``'s narrow, odd-width and ragged shapes, and each of their
   instances' resident blocks against its split picker; the int8 saved
   activations' kernels at every int8 shape of
   the headline step (512², 256², 128², batch 8, P = 4) and at ragged 24²
   ones, f32 and bf16, xq mode on and off, prologue on and off: the
   quantize (32q) on #32's own output exactly equal to the plain
   quantizer, the dx (#38) and dW (#39) from int8 within the dtype
   kernels' tolerances, each launched twice and held bit-equal, also
   without the stats cotangents (e = dy) at each of their instances and
   at 5q-c's convs; the
   one-pass conv backward (#37, ``CL_TPU_FUSE_BWD``) at every backward
   shape of the headline step (the stem without dx) and at ragged ones,
   f32 and bf16, prologue on and off, relaunched bit-equal, against its
   plain version and against #34/#35 and #36 launched on the same
   operands (every output bit-equal in bf16, where #37 launches them; dx
   and dW bit-equal in f32, da's and db's gap printed); the ring bodies of
   bf16 #36 and #29: each instance's resident blocks an SM as their split
   pickers assume, with its registers, spilled bytes and shared memory
   printed, and both at ragged shapes past every tile and at widths that
   take their plain-load staging; the up-conv's bf16 forward (#27) and dx
   (#28) wgmma kernels at ragged shapes past every tile and picker branch
   (the dx's DY by TMA boxes of one row and of whole rows, and by cp.async
   where no box serves), and the packed head's bf16 forward (#7) and
   backward (#8) at every instance and ragged P, each launched twice and
   held bit-equal, each launch's resident blocks an SM held against its
   picker's with its registers, spills and shared memory printed; the
   pipelined dx (34p/35p, ``CL_TPU_DX_PIPE``: the ring's dx in bf16) at
   #34/#35's shapes and at the ring's ragged ones, bit-equal to them; the
   packed head without a prologue (#5/#6)
   at 2,097,152 x 32 -> 19 bf16 and small f32 / ragged cases; the gen-2
   conv (#40) at baseline_2's 256² × 64 → 64, 128 → 64 and 128² × 64 →
   128, at 16² × 1024 → 1024 and the 512² standard body's 32 → 32 (p = 4),
   and as a dx at 16² × 1024 → 512, its dW (#41) at 256² × 64 → 64, 16² ×
   1024 → 1024 and 512² × 32 → 32, batch 8, and all three at the odd-row
   6 × 16 × 16 → 32 and the p = 16 32² × 8 → 16 with 3 images, f32 and
   bf16, each launched twice and held bit-equal; #30 and #40 in bf16 at one
   conv of each plain instance (COT, CK, resident weights) that the 5v-b,
   5n-b and 5g-c paths pick past those lists (the streamed weights of 32²
   × 512 → 512 among them), at a 3 → 32 conv (plain loads) and at 64 → 40
   (ragged channel tiles), each launched twice, with every plain
   instance's blocks an SM on the card held against its picker's;
4. the baseline_1 preset as it ships, through ``train()``: 16 steps and
   one eval (the fused head+CE kernels), then the same shape with
   ``train.fused_head_ce=false`` (the CE kernels) through
   ``make_train_step``, then one step on the card against one on the CPU
   from the same weights and batch;
5. full width: 512², batch 8, 19 classes, bf16, the standard body —
   images/s and peak memory, with the fused head and without;
5p. full width through the packed body (levels 0–2 in the five packed
   forward kernels), from phase 5's trained weights: ``evaluate_task``
   with its launch counts, mIoU and a timed eval step (images/s, peak
   memory) against the standard body on the same weights; then the
   packed body on the card against the port's packed body on the CPU
   (plain versions) at 128², base 32, depth 4, f32, in eval mode and in
   one train-mode forward without grad (logits and running statistics);
5t. full width training through the packed body from a prebuilt batch:
   ``train.packed_head_ce=false`` (the fused head+CE on the NHWC
   features) for 3 + 10 steps, then ``train.fused_head_ce=false`` for 2 +
   3, with launch counts = steps × the per-step counts of all thirteen
   packed kernels, a finite and falling loss, images/s and peak memory
   beside phase 5's standard body, then five pairs of 10 packed and 10
   standard steps in turns and each step's host issue time;
   ``train()`` on the same config for 2
   steps and its evals, launch counts checked; then one packed SGD step
   on the card against one on the CPU (plain versions) at 128², base 32,
   depth 4, f32, loss and every param within 1e-4, each param's and
   running statistic's update within 1e-2 of its norm plus one f32 ulp
   per element;
5h. the headline step: the same config as it ships (``train.packed_head_ce``
   on: the packed BN·ReLU + head + CE), 3 + 10 steps with launch counts =
   steps × the per-step counts (one #7 and one #8, one bn_relu forward and
   backward fewer than 5t's), a falling loss, images/s and peak memory,
   five pairs of 10 steps in turns against ``train.packed_head_ce=false``,
   and one SGD step on the card against the CPU at 128² f32;
5l. LwF on it (``method.methods=lwf``, the teacher a snapshot of the
   seeded init, the step on task 1): 3 + 10 steps with launch counts (the
   KD head #11/#12 in place of #7/#8, and the teacher's eval-mode packed
   forward), images/s and peak memory; one LwF step on the card against
   the CPU at 128² f32 with a teacher unlike the student (KD term, loss
   and params); a 2-task ``train()`` at 512² whose mIoU matrix and
   forgetting report must be finite;
5k. LwF off the packed head. 5k-a: phase 5l's config with
   ``train.packed_head_ce=false``, the KD head on NHWC features (#9/#10),
   and 5k-b: with ``train.fused_head_ce=false``, the CE (#3/#4) and KD
   (#13/#14) kernels on bf16 logits: 3 + 10 steps each with launch counts
   (phase 5t's packed body, the teacher's eval-mode packed forward, the
   route's loss kernels once a step and no other), a falling loss,
   images/s and peak memory beside phase 5l's; one LwF step of each route
   on the card against the CPU at 128² f32 (KD term, loss, params, each
   update); 5k-c: baseline_2's model with LwF as users set it
   (``preset=baseline_2 method.methods=lwf train.num_tasks=2``: UNet-64,
   256², 21 classes, f32, the device cache; CE #3/#4 and KD #13/#14)
   through ``train()``, every step under sync debug mode "error", the
   launches as counted; 5k-d: baseline_1 with LwF (128² is below
   ``model.packed_min_size``: the KD head on NHWC features) through
   ``train()`` on the card and on the CPU from the same weights and
   stream: with SGD, every final per-task mIoU of the card within 0.5
   points of the CPU's; with the preset's Adam, the kernels' within 0.5
   points of the plain PyTorch loss's on the card (Adam's card-against-CPU
   gap, the same with or without the kernels, printed beside them);
5m. the methods step, baseline_5 on one card (EWC online with λ = 3e4,
   LwF on the packed KD head, the device-resident replay buffer; batch
   8 + 1): task 0's after-task hooks on the seeded init (the Fisher pass
   of 8 batches, #19 launched once per batch; the LwF snapshot; the
   buffer's fill), then 3 + 10 steps of task 1 with launch counts (phase
   5l's, plus one #17, one #18 and two #20 per step), a falling loss,
   images/s and peak memory beside phase 5l's, five pairs of 10 methods
   and 10 LwF steps in turns with each step's host issue time, and one
   step (as one of 5h and of 5l) under ``torch.cuda.set_sync_debug_mode
   ("error")``, which fails at any host wait in the step; one step with all three
   methods on the card against the CPU at 128² f32 (a perturbed anchor, a
   positive random Fisher, a teacher unlike the student, a filled buffer:
   penalty, KD term, loss, params and each update); a 3-task ``train()``
   of the baseline_5 cut and a 2-task ``train()`` of baseline_3 as it
   ships (EWC alone, f32, 21 classes), 16 train and 8 val images per
   task: finite mIoU matrix and forgetting, the methods kernels launched
   as counted (both on the device-resident dataset, as the presets ship);
5r. the run's life cycle at full width: 5r-a, does the headline step
   (phase 5h's config) repeat bit for bit? Two deep copies of the model
   and Adam's state after one step, 3 steps each on the same batch, each
   leaf's max |diff| (where they differ, the leaves after one step and
   the same steps under ``torch.backends.cudnn.deterministic``), and five
   pairs of 10 steps with ``cudnn.deterministic`` on and off in turns;
   5r-b, the baseline_5 cut of phase 5m, 3 tasks of 16 + 8 images on the
   device cache: two uninterrupted ``train()`` runs, a run killed by
   ``train.fail_after_task=0`` and its ``train.resume=true``, each with
   its own checkpoint directory; the last task's ``state.pt`` leaf by leaf
   (params, BN buffers, Adam's moments and step, EWC's anchor and Fisher,
   the teacher) and the mIoU matrix: bit-equal where 5r-a found the step
   bit-repeatable, else within twice the two uninterrupted runs' largest
   gap; the methods kernels counted as in 5m; 5r-c, the CLI's ``eval``
   and ``predict`` from that checkpoint: ``eval``'s mIoU equals the last
   row of the uninterrupted run's matrix (to 5r-a's standard), the
   confusion matrix of ``predict``'s masks equals ``evaluate``'s entry for
   entry, the packed forward kernels launched once per forward each;
   5r-d, baseline_3 with ``method.ewc_fisher_kind=true`` (16 + 8 images a
   task) through ``train()``, every plan-driven step (the Fisher's too)
   under sync debug mode "error", #19 once per Fisher batch, a finite
   Fisher; the draw at 8 x 512² x 21 f32: no masked class, 255 kept, one
   seed equal twice, χ² of 2¹⁶ draws at four pixels, p > 1e-3;
5m. baseline_5 as it ships through ``train()`` (``train.remat=true``,
   64 + 8 images a step, 5 tasks of 256 + 64 images, 2 epochs, the device
   cache and the device replay buffer; ``train.data_parallel=true`` on one
   card runs one process): images/s per card, the mIoU matrix and
   forgetting, the methods kernels launched as counted; then one methods
   step at 64 + 8 images with remat on and off, the peak of each (remat's
   must be lower);
5x. per-level rematerialization on the headline step (phase 5h's
   config): ``train.remat=true`` against ``false``, 3 Adam steps each from
   the seeded init: the losses and all 292 leaves (params, BN statistics,
   Adam's moments and step) bit-equal, the peak over the steps lower, the
   launches those of 5h plus one more #32 a packed conv and #25 a decoder
   level a step (the recompute); in f32 with SGD the leaves within twice
   the largest gap among three ``remat=false`` runs (f32 does not repeat,
   5r-a);
5w. data parallelism on the one card (``cl_tpu_torch.dp_cards``): two
   ranks, separate processes on ``cuda:0`` over gloo, one SGD step of the
   headline config (global batch 8, bf16 and f32) and of the baseline_5
   cut (16 + 2, task 0's hooks first) against the one-process step on the
   same global batch: the loss, CE, KD and penalty within rtol 1e-5, the
   two ranks' leaves bit-equal, each rank's launches (hooks and step) equal
   to one process's, each update within 1e-2 of its norm plus one ulp, or
   (bf16) twice the gap of the one-process step with the batch's halves
   swapped where that is larger, f32 within 1e-2; then one NCCL group of
   one rank takes the headline step;
5n. GroupNorm (``model.norm=group``): 5n-a the headline widths (512²,
   batch 8, 19 classes, bf16) on the GroupNorm standard body (the packed
   body declines it), 3 + 10 steps with the fused head (#1/#2) once a
   step, images/s and peak beside phase 5's BatchNorm standard body; 5n-b
   ``model.conv_impl=auto`` and ``=v3`` (#30/#31 at the GroupNorm levels,
   counted), five pairs each against ``xla``; 5n-c one SGD step of
   baseline_1 (128², f32) with GroupNorm, and with ``conv_impl=v3``, on the
   card against the CPU (loss and params within 1e-4, each update within
   1e-2 of its norm plus one ulp of the float64 step); 5n-d two gloo ranks
   on ``cuda:0`` against one process (5w's harness);
5s. spatial parallelism (``train.spatial_parallel``) at the headline
   widths (phase 5n's GroupNorm config): 5s-a two gloo ranks on ``cuda:0``,
   256 rows of every image each, one SGD step against the one-rank
   spatial step (5w's gate: loss rtol 1e-5, replicas bit-equal, each update
   within 1e-2 of its norm plus one ulp or twice the gap of the one-rank
   step with the batch's halves swapped; each rank's peak and images/s of
   3 steps beside the one rank's), no kernel launched (``cl_tpu`` runs
   none under spatial), the ranks' stitched logits against the one-rank
   forward (f32 within 2e-4; bf16 no further from the one-rank f32 logits
   than twice the one-rank bf16's own distance); 5s-b ``preset=baseline_1
   model.norm=group model.depth=2 data.num_classes=5 train.num_tasks=2
   method.methods=ewc,lwf,replay``, 32 + 8 images a task, through
   ``train()`` over the two ranks against one process, every final
   per-task mIoU within 5e-3; 5s-c one
   card with ``train.spatial_parallel=true`` trains unsharded, its
   launches those of ``spatial_parallel=false``;
5e. grow-the-head (``model.padded_head=false``): 5e-a phase 5m's
   baseline_5 cut through ``train()`` over 3 tasks of 16 + 8 images, the
   head 7 wide and grown to 13 and 19, every launch of the run equal to the
   padded run's, and the headline step with task 0's narrow head (10 of 19
   classes): the packed head #7/#8 on the zero-padded head, 5h's launches
   a step; 5e-b ``preset=baseline_5 model.padded_head=false`` as it
   ships (widths 5 → 19), images/s beside the padded head's; 5e-c one SGD
   step of task 1 after growth with EWC, LwF and replay on the card
   against the CPU (128² f32, the packed body); 5e-d 5r-b's fail and
   resume under grow (bit-equal where 5r-a found the step repeatable),
   then the CLI's ``eval`` and ``predict`` from its checkpoint at the
   stored width;
5y. the profiler's trace (``train.profile_dir``): baseline_1 through
   ``train()`` with 2 epochs: one Chrome / Perfetto trace file with CUDA
   kernel events, the port's head kernel among them, the ``profile``
   event logged, the traced epoch left out of the rate;
5d. the data path (the native rasterizer, the device-resident dataset,
   plan-driven epochs): baseline_2 and baseline_3 as they ship and
   baseline_4 as it ships with ``train.pallas_augment=true`` through
   ``train()``, every plan-driven step under sync debug mode "error": a
   finite mIoU matrix and forgetting, ``hbm_live_set`` at every task
   boundary with the caches freed, every image from the native
   rasterizer, the steps and the launches as the config implies (#15/#16
   once per train, eval and Fisher step); baseline_3's images/s on the
   host pipeline (``data.device_cache=false data.dataset=synthetic``)
   beside it; three steps of baseline_3 with ``train.pallas_augment`` on
   and off from the same weights and plan (x within 1e-5, y bit-equal,
   losses within 1e-5); the plan-driven Fisher pass at 128² f32 on the
   card against the float64 Fisher of the same batches, and through the
   augment kernels against without them, each leaf within 2e-4 of its
   norm (the CPU's f32 Fisher printed beside them);
5v. the gen-3 conv on the standard body: 5v-a ``preset=baseline_2
   model.conv_impl=auto`` as it ships through ``train()`` (the device
   cache, 128 + 32 images, 2 epochs; every plan-driven step under sync
   debug mode "error"), with #30 launched 3 times a forward and 3 times
   (dx) a backward and #31 3 times a backward (enc0.conv1 per conv, dec0
   packed), images/s and peak memory beside phase 5d's baseline_2 with
   ``conv_impl=xla``, a finite mIoU; 5v-b ``conv_impl=v3`` in bf16 (every
   conv the gate admits, at every level), 3 + 10 steps with launch
   counts, five pairs in turns against ``xla``; 5v-c ``model.packed_min_size=0``
   (the packed body at 256², base 64, f32), 3 + 10 steps: level 2's two
   prologue convs take the two-pass backward, #30 (dt) and #33 twice a
   step in place of two fused dx and dW launches; 5v-d baseline_1 with
   ``conv_impl=v3`` (128² f32, both routes), one SGD step on the card
   against the CPU (loss and params within 1e-4) and, each update, against
   the same step in float64 (within 1e-2 of its norm plus one ulp: the
   CPU's own f32 step is further than that from float64 in the deep
   BatchNorm biases; it and the card against the CPU are printed); 5v-e ``preset=baseline_2 model.conv_impl=v3`` in f32 is
   refused (``cl_tpu`` finds no f32 tile for enc3.conv1 and asserts);
5q. int8 saved activations (``model.conv_act_store=int8``): 5q-a the
   headline step with int8, 3 + 10 steps with launch counts (every packed
   conv qualifies at 512²: 15 #32 and 15 quantize launches, 14 #38 and 15
   #39 a step, no dtype dx or dW), a falling loss, images/s and peak
   memory beside phase 5h's, ``profile_step``'s kernel ms by family for
   both, five pairs int8 / dtype in turns; 5q-b ``preset=baseline_1
   model.packed_min_size=0 model.conv_act_store=int8`` (128² f32: level 0
   int8, levels 1–2 dtype), one SGD step on the card against the CPU; 5q-c
   the same with EWC through ``train()`` on 2 tasks (the Fisher pass's
   eval-mode backward takes the int8 route): a finite mIoU matrix and
   forgetting, the int8 launches per backward; 5q-d ``preset=baseline_2
   model.packed_min_size=0 model.conv_act_store=int8`` (f32), 3 + 10
   steps: level 2's prologue convs dequantize into the two-pass backward
   (#30 as dt, #33), the rest run #38/#39;
5f. the packed conv's backward under the two switches of ``cl_tpu``
   (``packed_gate.FUSE_BWD`` / ``DX_PIPE``, set per run as the
   environment would): 5f-a the headline step under ``CL_TPU_FUSE_BWD``
   (#37 15 times a step, #34-#36 never), ``CL_TPU_DX_PIPE`` (34p/35p 14
   times a step in place of #34/#35) and both, 3 + 10 steps each with
   launch counts, a falling loss, images/s and peak memory,
   ``profile_step`` of each, five pairs in turns against the default;
   5f-b one ``FUSE_BWD`` step on the card against the CPU at 128² f32;
   5f-c ``preset=baseline_2 model.packed_min_size=0`` under ``FUSE_BWD``
   through ``train()``: level 2's prologue convs, two-pass by default,
   take #37 with the rest; 5f-d the packed head without its prologue
   (#5/#6) where a user reaches it, ``head_cross_entropy_packed`` on
   ``bn_relu`` of the headline body's raw output, 3 steps with launch
   counts, its loss beside ``head_cross_entropy_packed_bn``'s;
5g. the gen-2 conv on the standard body (``model.conv_impl=pallas|hybrid``)
   and the matmul up-conv: 5g-a ``preset=baseline_2 model.conv_impl=pallas``
   as it ships through ``train()`` (every plan-driven step under sync
   debug mode "error"), #40 17 times a forward and 17 times (dx) a
   backward, #41 17 times a backward, images/s and peak memory beside
   phase 5d's ``xla``, a finite mIoU; 5g-b ``conv_impl=hybrid``, 3 + 10
   steps with 17 #41 and no #40 a step, then five turns of pallas, hybrid
   and xla on one batch; 5g-c the 512² bf16 standard body under pallas
   (the tensor-core instances at p = 4), 3 + 10 steps with launch counts,
   a falling loss, five pairs against ``xla``; 5g-d one SGD step of
   ``preset=baseline_1 model.conv_impl=pallas`` on the card against the
   CPU (loss and params within 1e-4, each update against float64 within
   1e-2 of its norm plus one ulp); 5g-e ``model.upconv_impl=matmul`` alone
   on baseline_2, one step: no #40/#41 launch, its loss beside ``xla``'s;
5b. ``cl_tpu``'s route-only tuning variables, set per run (``tuned``):
   5b-a the headline step at ``CL_TPU_CONV_BUDGET=23068672``, where level 3
   (64², 256 channels) runs packed: every kernel at its level-3 shapes
   against its plain version in f32 and bf16 (the two-pass #30 and #33 of
   its prologue convs in bf16, and #35 at 256 channels), 3 + 10 steps with
   each kernel's launches a step against the default's, five pairs
   against the default; 5b-b ``preset=baseline_1 model.packed_min_size=0``
   at ``CL_TPU_CONV_BUDGET=8388608`` (2 packed levels), one SGD step on the
   card against the CPU; 5b-c ``CL_TPU_BWDF_BUDGET=14680064`` under
   ``CL_TPU_FUSE_BWD=1``: level 2's four convs from #37 to the fused dx and
   dW, 3 + 10 steps each with launch counts;
5u. ``CL_TPU_E_BF16=1`` (``tuned(E_BF16=True)``), the bf16 elementwise
   chains of the packed convs (phase 3u first holds each kernel that takes
   them, #32, #34/#35, 34p/35p, #36, #37, #33 and #39, at every shape of
   its path and a ragged one against its plain variant: random operands
   at the default's tolerance, relaunched bit-equal; exact probes bit for
   bit (the centre-tap identity weight, or one nonzero pixel of x or dy)
   and, where they reach a chain, unlike the flag-off launch; the f32
   instances unchanged): 5u-a the headline step under the flag, 3 + 10
   steps with 5h's launches under the variants' keys, five pairs against
   the default with the card's name and power limit; 5u-b one step each
   with ``model.conv_act_store=int8``, ``CL_TPU_FUSE_BWD``,
   ``CL_TPU_DX_PIPE`` and the 22 MiB budget (#33), the variants launched;
   5u-c ``preset=baseline_1 model.packed_min_size=0
   train.compute_dtype=bfloat16``, one SGD step on the card against the
   CPU with and without the flag: the flag's worst update gap within
   twice the default's;
6. kernel times against the plain version, one PyTorch library call for
   the same function, and the least time the card could take; the level-3
   kernels of 5b-a at their shapes; each variant of 5u beside its default
   at every shape of its path; #31 in both dtypes at ``V3_SHAPES``; 34p/35p
   in bf16 and in f32 at the headline step's dx shapes; phase 3's plain
   path convs (#30, #40) behind a card sleep beside ``F.conv2d``.

Each path resets the kernels' launch counts just before it runs and reads
them just after; a kernel of the path that was not launched fails the
run. The JSON line of kernel results, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}`` close the output. Without a CUDA device
the script prints no result and exits non-zero. It imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"float32": 67e12,      # f32 outside the tensor cores
            "bfloat16": 989e12}    # bf16 dense, tensor cores


def need(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3, queued: bool = True) -> float:
    """``cl_tpu_torch.kernel_ab.time_ms``: the median of ``reps`` launches
    from CUDA events, queued back to back unless ``queued`` is false."""
    from cl_tpu_torch.kernel_ab import time_ms as timed

    return timed(fn, reps, warmup, queued)


# ---------------------------------------------------------------------------
# Phase 3 / 6: kernels against their plain versions
# ---------------------------------------------------------------------------


def make_case(kind, P, width, C, dtype_name, seed):
    """Seeded operands on the card (``kernel_bench.operands``: ~10% ignore
    pixels, the last class masked where C > 2). ``width`` is Cin for the
    head kernel."""
    import torch

    from cl_tpu_torch.kernel_bench import operands

    ops, scale = operands(kind, P, width, C, getattr(torch, dtype_name), seed)
    case = {"kind": kind, "P": P, "C": C, "dtype": dtype_name,
            "labels": ops[-2], "valid": ops[-1], "scale": scale}
    if kind == "head_ce":
        case.update(x=ops[0], w=ops[1], b=ops[2], Cin=width)
    else:
        case["z"] = ops[0]
    return case


def case_name(case, which):
    if case["kind"] == "head_ce":
        shape = f"P={case['P']},Cin={case['Cin']},C={case['C']}"
    else:
        shape = f"P={case['P']},C={case['C']}"
    return f"{case['kind']}_{which}[{shape},{case['dtype']}]"


def bf16_ulp(t):
    import torch

    mag = t.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def compare(case):
    """Kernel vs plain for fwd and bwd; returns {which: max_abs_err}."""
    import torch

    from cl_tpu_torch.kernels import ce_loss, head_ce

    lbl, valid, scale = case["labels"], case["valid"], case["scale"]
    bf16 = case["dtype"] == "bfloat16"
    if case["kind"] == "head_ce":
        args = (case["x"], case["w"], case["b"], lbl, valid)
        k_loss = head_ce.launch_fwd(*args)
        p_loss = head_ce.head_ce_total_plain(*args)
        k_grads = head_ce.launch_bwd(*args, scale)
        p_grads = head_ce.head_ce_grads_plain(*args, scale)
        grad_names = ("dx", "dW", "db")
    else:
        args = (case["z"], lbl, valid)
        k_loss = ce_loss.launch_fwd(*args)
        p_loss = ce_loss.ce_total_plain(*args)
        k_grads = (ce_loss.launch_bwd(*args, scale),)
        p_grads = (ce_loss.ce_grad_plain(*args, scale),)
        grad_names = ("dz",)
    torch.cuda.synchronize()
    name_f, name_b = case_name(case, "fwd"), case_name(case, "bwd")

    # The loss: f32 sums over P pixels in another order than torch's.
    loss_rtol = 1e-5 if not bf16 else 1e-4
    err = abs(k_loss.item() - p_loss.item())
    rel = err / max(abs(p_loss.item()), 1e-30)
    print(f"  {name_f}: loss kernel {k_loss.item():.9g} plain "
          f"{p_loss.item():.9g} rel err {rel:.3g} (tol {loss_rtol:g})")
    need(np.isfinite(k_loss.item()) and rel <= loss_rtol, f"{name_f} loss")
    errs = {"fwd": err, "bwd": 0.0}

    for gname, k, p in zip(grad_names, k_grads, p_grads):
        need(k.shape == p.shape and k.dtype == p.dtype,
             f"{name_b} {gname} shape/dtype {tuple(k.shape)} {k.dtype}")
        kf, pf = k.float(), p.float()
        diff = (kf - pf).abs()
        need(bool(torch.isfinite(kf).all()), f"{name_b} {gname} not finite")
        if gname == "dz" and bf16:
            # f32 math in another order: may land on the other side of
            # one bf16 rounding
            tol = bf16_ulp(torch.maximum(kf.abs(), pf.abs()))
            tol_txt = "1 bf16 ulp"
        elif gname == "dx" and bf16:
            # dx = round(g)·W: each g_c may round to the other bf16
            # neighbour (|g_c| <= scale·(p_c + onehot_c), so the sum moves
            # by at most 2^-8·scale·2·max_c|W_ck|), then dx rounds once more
            wmax = case["w"].to(case["x"].dtype).float().abs().max(0).values
            tol = (bf16_ulp(torch.maximum(kf.abs(), pf.abs()))
                   + 2.0 ** -7 * scale * wmax[None, :])
            tol_txt = "1 bf16 ulp + one bf16 rounding of each g·W term"
        elif bf16:
            # f32 sums over 2 M pixels in another order
            tol = 1e-3 * pf.abs().max()
            tol_txt = "1e-3 of max|plain|"
        else:
            tol = 1e-4 * pf.abs() + 1e-5 * pf.abs().max()
            tol_txt = "1e-4 rel + 1e-5 of max|plain|"
        ok = bool((diff <= tol).all())
        print(f"  {name_b}: {gname} max abs err {diff.max().item():.3g} "
              f"(max|plain| {pf.abs().max().item():.3g}; tol {tol_txt}) "
              f"{'ok' if ok else 'FAIL'}")
        need(ok, f"{name_b} {gname}")
        errs["bwd"] = max(errs["bwd"], diff.max().item())
    return errs


def bytes_ops(case, which):
    """Bytes the function must move (each input read once, each output
    written once) and its operations."""
    P, C = case["P"], case["C"]
    es = 2 if case["dtype"] == "bfloat16" else 4
    if case["kind"] == "head_ce":
        cin = case["Cin"]
        inputs = P * cin * es + P * 4 + C * cin * 4 + 2 * C * 4
        if which == "fwd":
            return inputs + 4, 2 * P * C * cin + 6 * P * C
        return inputs + P * cin * es + C * (cin + 1) * 4, \
            6 * P * C * cin + 8 * P * C
    inputs = P * C * es + P * 4 + C * 4
    if which == "fwd":
        return inputs + 4, 6 * P * C
    return inputs + P * C * es, 8 * P * C


def kernel_times(case):
    """{which: (ms, plain_ms, library_ms)} at the case's shapes."""
    import torch
    import torch.nn.functional as F

    from cl_tpu_torch.kernels import ce_loss, head_ce

    lbl, valid, scale = case["labels"], case["valid"], case["scale"]
    lbl64 = lbl.long()
    out = {}
    if case["kind"] == "head_ce":
        x, w, b = case["x"], case["w"], case["b"]
        args = (x, w, b, lbl, valid)
        wx, bx = w.to(x.dtype), b.to(x.dtype)
        lib_fwd = lambda: F.cross_entropy(F.linear(x, wx, bx), lbl64,  # noqa: E731
                                          ignore_index=255)
        xr, wr, br = (t.detach().clone().requires_grad_(True) for t in (x, wx, bx))
        lib_loss = F.cross_entropy(F.linear(xr, wr, br), lbl64, ignore_index=255)
        lib_bwd = lambda: torch.autograd.grad(lib_loss, (xr, wr, br),  # noqa: E731
                                              retain_graph=True)
        out["fwd"] = (time_ms(lambda: head_ce.launch_fwd(*args)),
                      time_ms(lambda: head_ce.head_ce_total_plain(*args)),
                      time_ms(lib_fwd))
        out["bwd"] = (time_ms(lambda: head_ce.launch_bwd(*args, scale)),
                      time_ms(lambda: head_ce.head_ce_grads_plain(*args, scale)),
                      time_ms(lib_bwd))
    else:
        z = case["z"]
        args = (z, lbl, valid)
        zr = z.detach().clone().requires_grad_(True)
        lib_loss = F.cross_entropy(zr, lbl64, ignore_index=255)
        out["fwd"] = (time_ms(lambda: ce_loss.launch_fwd(*args)),
                      time_ms(lambda: ce_loss.ce_total_plain(*args)),
                      time_ms(lambda: F.cross_entropy(z, lbl64, ignore_index=255)))
        out["bwd"] = (time_ms(lambda: ce_loss.launch_bwd(*args, scale)),
                      time_ms(lambda: ce_loss.ce_grad_plain(*args, scale)),
                      time_ms(lambda: torch.autograd.grad(lib_loss, zr,
                                                          retain_graph=True)))
    return out


# ---------------------------------------------------------------------------
# Phase 3 / 6: the packed head+CE with the BN·ReLU prologue, alone and with KD
# ---------------------------------------------------------------------------

BN_KERNELS = {  # launch-count key: (source, TPU kernel's pallas_call)
    # the bf16 forward and backward (the kernels line's) run the mma body
    "head_ce_bn_fwd": ("cl_tpu_torch/csrc/head_ce_bn_mma.cuh", "cl_tpu/pallas/head_ce.py:571"),
    "head_ce_bn_bwd": ("cl_tpu_torch/csrc/head_ce_bn_mma.cuh", "cl_tpu/pallas/head_ce.py:601"),
    "head_ce_kd_bn_fwd": ("cl_tpu_torch/csrc/head_ce_kd_bn.cu", "cl_tpu/pallas/head_ce.py:997"),
    "head_ce_kd_bn_bwd": ("cl_tpu_torch/csrc/head_ce_kd_bn.cu",
                          "cl_tpu/pallas/head_ce.py:1036"),
}
# the KD head on NHWC features (#9/#10): the same template without the
# BN·ReLU prologue, on bn_case's operands (y as the features x)
KD_HEAD_KERNELS = {
    "head_ce_kd_fwd": ("cl_tpu_torch/csrc/head_ce_kd.cu", "cl_tpu/pallas/head_ce.py:784"),
    "head_ce_kd_bwd": ("cl_tpu_torch/csrc/head_ce_kd.cu", "cl_tpu/pallas/head_ce.py:815"),
}
LWF_T = 2.0  # method.lwf_temperature's default


def bn_case(P, cin, C, dtype_name, seed):
    """Seeded operands on the card for the packed head kernels: raw y with
    its BN vectors (some shifts negative), the head, ~10% ignore pixels and
    the last class masked (C > 2); a teacher with its own y, vectors and
    head, and old_valid the first half of the classes (at least two); the
    cotangents
    gce = 1/n and gkd = α·weight/n with α = weight = 1."""
    import torch

    from cl_tpu_torch.kernel_bench import operands

    (y, w, b, labels, valid), gce = operands("head_ce", P, cin, C, getattr(torch, dtype_name),
                                             seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device="cuda")

    old_valid = torch.zeros(C, device="cuda")
    old_valid[:max(2, C // 2)] = 1.0  # two or more: over one class the KD is 0
    return {"P": P, "Cin": cin, "C": C, "dtype": dtype_name, "y": y, "w": w, "b": b,
            "labels": labels, "valid": valid, "s": randn(cin).abs() + 0.5,
            "sh": randn(cin) * 0.5, "yt": randn(P, cin).to(y.dtype),
            "ts": randn(cin).abs() + 0.5, "tsh": randn(cin) * 0.5, "tw": randn(C, cin) * 0.2,
            "tb": randn(C) * 0.1, "old_valid": old_valid, "gce": gce.reshape(()),
            "gkd": gce.reshape(()).clone()}


def bn_fns(kernel, case):
    """(kernel launch, plain version) of one packed head kernel as
    closures over the case's operands."""
    from cl_tpu_torch.kernels import head_ce

    c = case
    st = (c["y"], c["s"], c["sh"], c["w"], c["b"])
    te = (c["yt"], c["ts"], c["tsh"], c["tw"], c["tb"])
    lv = (c["labels"], c["valid"])
    kd = (*st, *te, *lv, c["old_valid"])
    nhwc = (c["y"], c["w"], c["b"], c["yt"], c["tw"], c["tb"], *lv, c["old_valid"])
    pk = (c["y"], c["w"], c["b"], *lv)
    return {
        "head_ce_pk_fwd": (lambda: head_ce.launch_pk_fwd(*pk),
                           lambda: head_ce.head_ce_total_plain(*pk)),
        "head_ce_pk_bwd": (lambda: head_ce.launch_pk_bwd(*pk, c["gce"]),
                           lambda: head_ce.head_ce_grads_plain(*pk, c["gce"])),
        "head_ce_kd_fwd": (lambda: head_ce.launch_kd_fwd(*nhwc, LWF_T),
                           lambda: head_ce.head_ce_kd_total_plain(*nhwc, LWF_T)),
        "head_ce_kd_bwd": (
            lambda: head_ce.launch_kd_bwd(*nhwc, c["gce"], c["gkd"], LWF_T),
            lambda: head_ce.head_ce_kd_grads_plain(*nhwc, c["gce"], c["gkd"], LWF_T)),
        "head_ce_bn_fwd": (lambda: head_ce.launch_bn_fwd(*st, *lv),
                           lambda: head_ce.head_ce_bn_total_plain(*st, *lv)),
        "head_ce_bn_bwd": (lambda: head_ce.launch_bn_bwd(*st, *lv, c["gce"]),
                           lambda: head_ce.head_ce_bn_grads_plain(*st, *lv, c["gce"])),
        "head_ce_kd_bn_fwd": (lambda: head_ce.launch_kd_bn_fwd(*kd, LWF_T),
                              lambda: head_ce.head_ce_kd_bn_total_plain(*kd, LWF_T)),
        "head_ce_kd_bn_bwd": (
            lambda: head_ce.launch_kd_bn_bwd(*kd, c["gce"], c["gkd"], LWF_T),
            lambda: head_ce.head_ce_kd_bn_grads_plain(*kd, c["gce"], c["gkd"], LWF_T)),
    }[kernel]


def bn_name(kernel, case):
    return f"{kernel}[P={case['P']},Cin={case['Cin']},C={case['C']},{case['dtype']}]"


def compare_bn(kernel, case):
    """Kernel vs plain on the card; returns the max abs error of the main
    output (the loss, or dx). Tolerances: the loss sums 1e-5 relative in
    f32, 1e-4 in bf16 (f32 sums over P pixels in another order, expf);
    dx in bf16 two ulps plus one bf16 rounding of each g·W term times
    |scale| (g = gce·(p − onehot) + gkd·T·(p_new − p_old) may round to the
    other neighbour before dz = round(g)·W), in f32 1e-5 relative plus
    1e-5 of Σ_c |g|·|W|·|scale|; the sums over pixels (dscale, dshift, dW,
    db) as head_ce's backward: 1e-3 of max|plain| in bf16, 1e-4 relative
    plus 1e-5 of max|plain| in f32. A backward launched twice repeats
    every bit, and so does a forward. The KD head on NHWC features
    (``head_ce_kd_*``) has no prologue: |scale| is 1 and its backward
    gives dx, dW and db."""
    import torch

    launch, plain = bn_fns(kernel, case)
    k_out, p_out, again = launch(), plain(), launch()
    torch.cuda.synchronize()
    if not isinstance(k_out, tuple):
        k_out, p_out, again = (k_out,), (p_out,), (again,)
    name = bn_name(kernel, case)
    need(all(torch.equal(u, v) for u, v in zip(k_out, again)),
         f"{name}: a second launch repeats every bit")
    bf16 = case["dtype"] == "bfloat16"
    msg, ok, main_err = f"  {name}:", True, None
    if kernel.endswith("fwd"):
        for which, k, p in zip(("ce", "kd"), k_out, p_out):
            rel = abs(k.item() - p.item()) / max(abs(p.item()), 1e-30)
            tol = 1e-4 if bf16 else 1e-5
            good = np.isfinite(k.item()) and rel <= tol
            ok = ok and good
            msg += (f" {which} kernel {k.item():.9g} plain {p.item():.9g} rel err {rel:.3g} "
                    f"(tol {tol:g}){'' if good else ' FAIL'};")
            main_err = abs(k.item() - p.item()) if main_err is None else main_err
    else:
        gbound = case["gce"].item() + (LWF_T * case["gkd"].item() if "kd" in kernel else 0.0)
        w_abs = case["w"].to(case["y"].dtype).float().abs().sum(0)  # Σ_c |W_ck|
        bn = "_bn_" in kernel
        s_abs = case["s"].abs() if bn else 1.0
        names = ("dx", "dscale", "dshift", "dW", "db") if bn else ("dx", "dW", "db")
        need(len(k_out) == len(names), f"{name}: {len(names)} outputs")
        for i, (gname, k, p) in enumerate(zip(names, k_out, p_out)):
            need(k.shape == p.shape and k.dtype == p.dtype,
                 f"{name} {gname} shape/dtype {tuple(k.shape)} {k.dtype}")
            kf, pf = k.float(), p.float()
            need(bool(torch.isfinite(kf).all()), f"{name} {gname} not finite")
            diff = (kf - pf).abs()
            if i == 0 and bf16:
                tol = (2 * bf16_ulp(torch.maximum(kf.abs(), pf.abs()))
                       + 2.0 ** -7 * gbound * w_abs * s_abs)
                txt = "2 bf16 ulp + one rounding of each g·W term, times |s|"
            elif i == 0:
                tol = 1e-5 * pf.abs() + 1e-5 * gbound * w_abs * s_abs
                txt = "1e-5 rel + 1e-5 Σ|g·W·s|"
            elif bf16:
                tol, txt = 1e-3 * pf.abs().max(), "1e-3 of max|plain|"
            else:
                tol = 1e-4 * pf.abs() + 1e-5 * pf.abs().max()
                txt = "1e-4 rel + 1e-5 of max|plain|"
            good = bool((diff <= tol).all())
            ok = ok and good
            msg += f" {gname} {diff.max().item():.3g} ({txt}){'' if good else ' FAIL'};"
            main_err = diff.max().item() if main_err is None else main_err
    print(msg + (" ok" if ok else " FAIL"))
    need(ok, name)
    return main_err


def bn_bytes_ops(kernel, case):
    """Bytes the function must move (each input read once, each output
    written once) and its operations: 2·C·Cin per pixel and logit pass,
    3·Cin for the BN·ReLU prologue, ~6·C for the softmax and CE (the KD
    ~12·C more), the backward's two more products and its ~6·Cin
    epilogue. The KD head on NHWC features has no prologue and no
    epilogue: no s, sh, dscale or dshift, and 3·Cin fewer operations."""
    P, cin, C = case["P"], case["Cin"], case["C"]
    es = 2 if case["dtype"] == "bfloat16" else 4
    kd = "kd" in kernel
    nv = 2 * cin if "_bn_" in kernel else 0                # the BN vectors
    one = P * cin * es + (C * cin + C + nv) * 4            # y, W, b (, s, sh)
    inputs = (2 if kd else 1) * one + P * 4 + (2 if kd else 1) * C * 4  # labels, masks
    passes = 2 if kd else 1
    ops = passes * (2 * P * C * cin + (3 * P * cin if nv else 0)) + (18 if kd else 6) * P * C
    if kernel.endswith("fwd"):
        return inputs + (8 if kd else 4), ops
    return (inputs + P * cin * es + (C * (cin + 1) + nv) * 4,
            ops + 4 * P * C * cin + (6 * P * cin if nv else 0) + 2 * P * C)


def bn_times(kernel, case):
    """(ms, plain_ms, library_ms, ms synchronised per launch). The library
    call for #7/#8 is ``F.linear`` + ``F.cross_entropy`` on the
    materialized z (the head and CE only, not the BN·ReLU), for the packed
    KD forms (#11/#12) the same (the head and CE only, not the BN·ReLU,
    the teacher's head or the KD), for the KD head on NHWC features
    (#9/#10) the same on x."""
    import torch
    import torch.nn.functional as F

    from cl_tpu_torch.kernels.packed_eltwise import bn_relu_plain

    launch, plain = bn_fns(kernel, case)
    z = bn_relu_plain(case["y"], case["s"], case["sh"]) if "_bn_" in kernel else case["y"]
    wx, bx = case["w"].to(z.dtype), case["b"].to(z.dtype)
    lbl64 = case["labels"].long()
    if kernel.endswith("fwd"):
        lib = lambda: F.cross_entropy(F.linear(z, wx, bx), lbl64,  # noqa: E731
                                      ignore_index=255)
    else:
        zr, wr, br = (t.detach().clone().requires_grad_(True) for t in (z, wx, bx))
        loss = F.cross_entropy(F.linear(zr, wr, br), lbl64, ignore_index=255)
        lib = lambda: torch.autograd.grad(loss, (zr, wr, br), retain_graph=True)  # noqa: E731
    return time_ms(launch), time_ms(plain), time_ms(lib), time_ms(launch, queued=False)


def zero_teacher_kd(kind, case):
    """Task 0's teacher (``old_valid`` all false) on the card: the KD term
    exactly 0, and its gradient exactly 0 (the head's backward with gce = 0;
    the logits' backward). ``kind``: "head" (#9/#10) or "logits"
    (#13/#14)."""
    import torch

    from cl_tpu_torch.kernels import head_ce, kd_loss

    c = case
    zero = torch.zeros_like(c["old_valid"])
    if kind == "head":
        args = (c["y"], c["w"], c["b"], c["yt"], c["tw"], c["tb"], c["labels"], c["valid"], zero)
        kd = head_ce.launch_kd_fwd(*args, LWF_T)[1]
        grads = head_ce.launch_kd_bwd(*args, torch.zeros_like(c["gce"]), c["gkd"], LWF_T)
    else:
        args = (c["new"], c["old"], zero, c["labels"])
        kd = kd_loss.launch_fwd(*args, LWF_T)
        grads = (kd_loss.launch_bwd(*args, c["g"] / LWF_T, LWF_T),)
    torch.cuda.synchronize()
    name = (bn_name("head_ce_kd", c) if kind == "head" else kd_name("kd", c))
    ok = kd.item() == 0.0 and not any(bool(g.any()) for g in grads)
    print(f"  {name}, old_valid all false: KD {kd.item()!r}, its gradient all zero "
          f"{not any(bool(g.any()) for g in grads)} {'ok' if ok else 'FAIL'}")
    need(ok, f"{name}: task 0's teacher gives KD 0 and gradient 0")


# ---------------------------------------------------------------------------
# Phase 3 / 6: the KD on materialized logits (#13/#14)
# ---------------------------------------------------------------------------

KD_KERNELS = {  # launch-count key: (source, TPU kernel's pallas_call)
    "kd_fwd": ("cl_tpu_torch/csrc/kd_loss.cu", "cl_tpu/pallas/kd_loss.py:154"),
    "kd_bwd": ("cl_tpu_torch/csrc/kd_loss.cu", "cl_tpu/pallas/kd_loss.py:183"),
}


def kd_case(P, C, dtype_name, seed):
    """Seeded student and teacher logits [P, C] on the card
    (``kernel_bench.kd_operands``: ~10% ignore pixels, the first half of
    the classes old, at least two), and the total's cotangent g = T²/n as
    ``kd_loss`` gives it."""
    import torch

    from cl_tpu_torch.kernel_bench import kd_operands

    (new, old, old_valid, labels), scale = kd_operands("kd", P, 0, C,
                                                       getattr(torch, dtype_name), seed)
    return {"P": P, "C": C, "dtype": dtype_name, "new": new, "old": old,
            "old_valid": old_valid, "labels": labels, "g": scale * LWF_T ** 2}


def kd_name(kernel, case):
    return f"{kernel}[P={case['P']},C={case['C']},{case['dtype']}]"


def kd_fns(kernel, case):
    from cl_tpu_torch.kernels import kd_loss

    c = case
    args = (c["new"], c["old"], c["old_valid"], c["labels"])
    scale = c["g"] / LWF_T
    return {"kd_fwd": (lambda: kd_loss.launch_fwd(*args, LWF_T),
                       lambda: kd_loss.kd_total_plain(*args, LWF_T)),
            "kd_bwd": (lambda: kd_loss.launch_bwd(*args, scale, LWF_T),
                       lambda: kd_loss.kd_grad_plain(*args, scale, LWF_T))}[kernel]


def compare_kd(kernel, case):
    """Kernel vs plain on the card; returns the max abs error. Tolerances:
    the KL total 1e-5 relative in f32, 1e-4 in bf16 (f32 sums over P pixels
    in another order); dnew = s·pix·(p_new − p_old), s = g/T, in f32
    within 1e-5 relative plus 1e-6·|s| (p from expf and a log-sum in
    another order: a few f32 ulps of 1 on each p), in bf16 one bf16 ulp
    plus 1e-6·|s| (the f32 value may round to the other neighbour). A
    backward launched twice repeats every bit."""
    import torch

    launch, plain = kd_fns(kernel, case)
    k, p = launch(), plain()
    again = launch()
    torch.cuda.synchronize()
    name = kd_name(kernel, case)
    need(torch.equal(k, again), f"{name}: a second launch repeats every bit")
    bf16 = case["dtype"] == "bfloat16"
    if kernel == "kd_fwd":
        rel = abs(k.item() - p.item()) / max(abs(p.item()), 1e-30)
        tol = 1e-4 if bf16 else 1e-5
        ok = np.isfinite(k.item()) and p.item() > 0 and rel <= tol
        print(f"  {name}: KL total kernel {k.item():.9g} plain {p.item():.9g} rel err "
              f"{rel:.3g} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        need(ok, name)
        return abs(k.item() - p.item())
    need(k.shape == p.shape and k.dtype == p.dtype, f"{name} shape/dtype")
    kf, pf = k.float(), p.float()
    need(bool(torch.isfinite(kf).all()), f"{name} not finite")
    diff = (kf - pf).abs()
    s = abs(case["g"].item()) / LWF_T
    if bf16:
        tol, txt = bf16_ulp(torch.maximum(kf.abs(), pf.abs())) + 1e-6 * s, "1 bf16 ulp + 1e-6·|s|"
    else:
        tol, txt = 1e-5 * pf.abs() + 1e-6 * s, "1e-5 rel + 1e-6·|s|"
    ok = bool((diff <= tol).all())
    print(f"  {name}: dnew max abs err {diff.max().item():.3g} (max|plain| "
          f"{pf.abs().max().item():.3g}; tol {txt}) {'ok' if ok else 'FAIL'}")
    need(ok, name)
    return diff.max().item()


def kd_bytes_ops(kernel, case):
    """Bytes the function must move (both logit tensors, the labels and
    old_valid read once; the total, or dnew, written once) and its
    operations: ~16 per logit pair forward (scale, mask, two max, two
    exp-sums, the KL terms), ~12 backward."""
    P, C = case["P"], case["C"]
    es = 2 if case["dtype"] == "bfloat16" else 4
    inputs = 2 * P * C * es + P * 4 + C * 4
    if kernel == "kd_fwd":
        return inputs + 4, 16 * P * C
    return inputs + 4 + P * C * es, 12 * P * C


def kd_times(kernel, case):
    """(ms, plain_ms, library_ms or None, ms synchronised per launch). The
    library call for #13 is ``F.kl_div`` of the two log-softmaxes at T on
    the masked f32 logits (the KL alone: no ignore mask, no T²/n); none
    for #14."""
    import torch
    import torch.nn.functional as F

    from cl_tpu_torch.losses import NEG_INF

    launch, plain = kd_fns(kernel, case)
    lib = None
    if kernel == "kd_fwd":
        ov = case["old_valid"] > 0
        nm = torch.where(ov, case["new"].float(), NEG_INF)
        om = torch.where(ov, case["old"].float(), NEG_INF)
        lib = lambda: F.kl_div(F.log_softmax(nm / LWF_T, 1),  # noqa: E731
                               F.log_softmax(om / LWF_T, 1), log_target=True,
                               reduction="sum")
    return (time_ms(launch), time_ms(plain), None if lib is None else time_ms(lib),
            time_ms(launch, queued=False))


# ---------------------------------------------------------------------------
# Phase 3 / 6: the packed body's forward kernels
# ---------------------------------------------------------------------------

FORWARD_KERNELS = ("conv3x3_bn_fwd", "bn_relu_fwd", "add_stats_fwd", "maxpool_fwd", "upconv_fwd")
PACKED_KERNELS = {  # launch-count key: (source, TPU kernel's pallas_call)
    # the bf16 forward and dx (the kernels line's) run the ring body
    "conv3x3_bn_fwd": ("cl_tpu_torch/csrc/conv3x3_ring.cu", "cl_tpu/pallas/conv3x3_v3.py:833"),
    "bn_relu_fwd": ("cl_tpu_torch/csrc/packed_eltwise.cu", "cl_tpu/pallas/packed_eltwise.py:93"),
    "add_stats_fwd": ("cl_tpu_torch/csrc/packed_eltwise.cu",
                      "cl_tpu/pallas/packed_eltwise.py:202"),
    "maxpool_fwd": ("cl_tpu_torch/csrc/pool.cu", "cl_tpu/pallas/pool_pack.py:238"),
    "upconv_fwd": ("cl_tpu_torch/csrc/upconv.cu", "cl_tpu/pallas/upconv_pack.py:150"),
}
# Every shape of one packed forward at 512², batch 8 (prefix 3), with its
# launches per forward: conv (H, Cin, Cout, prologue); the others (H, C);
# the up-conv (H_in, Cin, Cout).
PACKED_PATH = {
    "conv3x3_bn_fwd": [((512, 3, 32, False), 1), ((512, 32, 32, True), 2),
                       ((512, 32, 32, False), 2), ((256, 32, 64, False), 1),
                       ((256, 64, 64, True), 2), ((256, 64, 64, False), 2),
                       ((128, 64, 128, False), 1), ((128, 128, 128, True), 2),
                       ((128, 128, 128, False), 2)],
    "bn_relu_fwd": [((512, 32), 2), ((256, 64), 2), ((128, 128), 2)],
    "add_stats_fwd": [((512, 32), 1), ((256, 64), 1), ((128, 128), 1)],
    "maxpool_fwd": [((512, 32), 1), ((256, 64), 1), ((128, 128), 1)],
    "upconv_fwd": [((64, 256, 128), 1), ((128, 128, 64), 1), ((256, 64, 32), 1)],
}
ODD = {"conv3x3_bn_fwd": [(24, 16, 16, False), (24, 16, 16, True), (24, 3, 16, False)],
       "bn_relu_fwd": [(24, 16)], "add_stats_fwd": [(24, 16)],
       "maxpool_fwd": [(24, 16)], "upconv_fwd": [(24, 16, 16)]}


def packed_operands(kernel, shape, dtype_name, batch=8, seed=0):
    """Seeded operands on the card for one kernel call."""
    import torch

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh, scale=1.0):
        return torch.randn(*sh, generator=g, device="cuda") * scale

    if kernel == "conv3x3_bn_fwd":
        H, cin, cout, prologue = shape
        return (randn(batch, H, H, cin).to(dt), randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5),
                randn(cin).abs() + 0.5, randn(cin) * 0.5 + 0.25, prologue)
    if kernel == "upconv_fwd":
        H, cin, cout = shape
        return (randn(batch, H, H, cin).to(dt), randn(cin, cout, 2, 2, scale=cin ** -0.5),
                randn(cout))
    H, C = shape
    x = randn(batch, H, H, C).to(dt)
    if kernel == "bn_relu_fwd":
        return x, randn(C).abs() + 0.5, randn(C)
    if kernel == "add_stats_fwd":
        return x, randn(batch, H, H, C).to(dt)
    return (x,)


def packed_fns(kernel):
    """(kernel launch, plain version, library call or None) of one kernel."""
    import torch.nn.functional as F

    from cl_tpu_torch.kernels import conv3x3, packed_eltwise, pool_pack, upconv_pack

    if kernel == "conv3x3_bn_fwd":
        def lib(x, w, a, b, prologue):  # cuDNN, the conv alone
            return F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), padding=1)
        return conv3x3.launch_conv_bn, conv3x3.conv_bn_plain, lib
    if kernel == "bn_relu_fwd":
        return packed_eltwise.launch_bn_relu, packed_eltwise.bn_relu_plain, None
    if kernel == "add_stats_fwd":
        return packed_eltwise.launch_add_stats, packed_eltwise.add_stats_plain, None
    if kernel == "maxpool_fwd":
        def lib(x):
            return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
        return pool_pack.launch_maxpool2x2, pool_pack.maxpool2x2_plain, lib

    def lib(x, w, b):
        return F.conv_transpose2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype),
                                  stride=2)
    return upconv_pack.launch_upconv2x2, upconv_pack.upconv2x2_plain, lib


def packed_name(kernel, shape, dtype_name):
    return f"{kernel}[{','.join(str(v) for v in shape)},{dtype_name}]"


def compare_packed(kernel, shape, dtype_name, batch=8, ew=False):
    """Kernel vs plain on the card; returns the max abs error of the main
    output. Tolerances: exact where both round one exact f32 value (the
    eltwise passes, the pool); for the conv and up-conv 1e-5 + 1e-5·|plain|
    in f32 (f32 sums in another order) and one bf16 ulp + 1e-5 in bf16;
    the conv's and add's sums against a sum of the kernel's own output at
    1e-5 of Σ|term|. ``ew``: the conv's variant under CL_TPU_E_BF16 (both
    with ``e_bf16``)."""
    import torch

    launch, plain, _ = packed_fns(kernel)
    kw = {"e_bf16": True} if ew else {}
    ops = packed_operands(kernel, shape, dtype_name, batch)
    k_out, p_out = launch(*ops, **kw), plain(*ops, **kw)
    again = launch(*ops, **kw) if kernel in ("conv3x3_bn_fwd", "upconv_fwd") else None
    torch.cuda.synchronize()
    if not isinstance(k_out, tuple):
        k_out, p_out = (k_out,), (p_out,)
        again = None if again is None else (again,)
    name = packed_name(kernel, shape, dtype_name) + ("[ebf16]" if ew else "")
    # the conv's sums are fixed-order partials, the up-conv's schedule a
    # function of the shapes: a second launch repeats every bit
    need(again is None or all(torch.equal(u, v) for u, v in zip(k_out, again)),
         f"{name}: a second launch repeats every bit")
    y, yp = k_out[0], p_out[0]
    need(y.shape == yp.shape and y.dtype == yp.dtype, f"{name} shape/dtype")
    yf, pf = y.float(), yp.float()
    need(bool(torch.isfinite(yf).all()), f"{name} not finite")
    diff = (yf - pf).abs()
    if kernel in ("bn_relu_fwd", "add_stats_fwd", "maxpool_fwd"):
        tol, tol_txt = torch.zeros_like(pf), "exact"
    elif dtype_name == "bfloat16":
        tol, tol_txt = bf16_ulp(torch.maximum(yf.abs(), pf.abs())) + 1e-5, "1 bf16 ulp + 1e-5"
    else:
        tol, tol_txt = 1e-5 + 1e-5 * pf.abs(), "1e-5 + 1e-5 rel"
    ok = bool((diff <= tol).all())
    msg = f"  {name}: max abs err {diff.max().item():.3g} (tol {tol_txt})"
    if len(k_out) == 3:  # the stats epilogue: Σ and Σ² of the stored output
        rows = yf.reshape(-1, yf.shape[-1])
        for i, terms in ((1, rows), (2, rows * rows)):
            want = terms.sum(0)
            serr = (k_out[i] - want).abs()
            sok = bool((serr <= 1e-5 * terms.abs().sum(0) + 1e-6).all())
            ok = ok and sok
            msg += f"; sum{i} err {serr.max().item():.3g} vs plain {(k_out[i] - p_out[i]).abs().max().item():.3g}"
    print(msg + (" relaunch bit-equal ok" if ok and again is not None else
                 " ok" if ok else " FAIL"))
    need(ok, name)
    return diff.max().item()


def packed_bytes_ops(kernel, shape, dtype_name, batch=8):
    es = 2 if dtype_name == "bfloat16" else 4
    if kernel == "conv3x3_bn_fwd":
        H, cin, cout, prologue = shape
        px = batch * H * H
        nbytes = px * (cin + cout) * es + 9 * cin * cout * es + 8 * cout \
            + (8 * cin if prologue else 0)
        return nbytes, 18 * px * cin * cout + (3 * px * cin if prologue else 0) + 3 * px * cout
    if kernel == "upconv_fwd":
        H, cin, cout = shape
        px = batch * H * H
        return px * (cin + 4 * cout) * es + 4 * cin * cout * es + 4 * cout, \
            8 * px * cin * cout
    H, C = shape
    n = batch * H * H * C
    return {"bn_relu_fwd": (2 * n * es + 8 * C, 3 * n),
            "add_stats_fwd": (3 * n * es + 8 * C, 4 * n),
            "maxpool_fwd": (n * es + n // 4 * es, 3 * n // 4)}[kernel]


def packed_times(kernel, shape, dtype_name="bfloat16"):
    """(ms, plain_ms, library_ms or None, ms synchronised per launch) at
    one shape."""
    launch, plain, lib = packed_fns(kernel)
    ops = packed_operands(kernel, shape, dtype_name)
    return (time_ms(lambda: launch(*ops)), time_ms(lambda: plain(*ops)),
            None if lib is None else time_ms(lambda: lib(*ops)),
            time_ms(lambda: launch(*ops), queued=False))


# ---------------------------------------------------------------------------
# Phase 3 / 6: the packed body's backward kernels
# ---------------------------------------------------------------------------

PACKED_KERNELS.update({  # the backward kernels
    "maxpool_bwd": ("cl_tpu_torch/csrc/pool.cu", "cl_tpu/pallas/pool_pack.py:279"),
    "bn_relu_bwd": ("cl_tpu_torch/csrc/packed_eltwise.cu",
                    "cl_tpu/pallas/packed_eltwise.py:113"),
    "dy_eff": ("cl_tpu_torch/csrc/packed_eltwise.cu", "cl_tpu/pallas/packed_eltwise.py:226"),
    "upconv_dx": ("cl_tpu_torch/csrc/upconv.cu", "cl_tpu/pallas/upconv_pack.py:183"),
    "upconv_dw": ("cl_tpu_torch/csrc/upconv.cu", "cl_tpu/pallas/upconv_pack.py:201"),
    "conv3x3_bn_dx": ("cl_tpu_torch/csrc/conv3x3_ring.cu", "cl_tpu/pallas/conv3x3_v3.py:1233"),
    "conv3x3_bn_dx_bn": ("cl_tpu_torch/csrc/conv3x3_ring.cu",
                         "cl_tpu/pallas/conv3x3_v3.py:1259"),
    "conv3x3_bn_dw": ("cl_tpu_torch/csrc/conv3x3_bn_bwd.cu",
                      "cl_tpu/pallas/conv3x3_v3.py:1332"),
})
# Every shape of one packed backward at 512², batch 8 (prefix 3), with its
# launches per step: conv (H, Cin, Cout, prologue) of the FORWARD conv;
# the pool (H, C, tee), the eltwise passes (H, C); the up-conv (H_in, Cin,
# Cout). The stem's dx is the image's: never launched.
PACKED_PATH.update({
    "conv3x3_bn_dw": PACKED_PATH["conv3x3_bn_fwd"],
    "conv3x3_bn_dx_bn": [((512, 32, 32, True), 2), ((256, 64, 64, True), 2),
                         ((128, 128, 128, True), 2)],
    "conv3x3_bn_dx": [((512, 32, 32, False), 2), ((256, 32, 64, False), 1),
                      ((256, 64, 64, False), 2), ((128, 64, 128, False), 1),
                      ((128, 128, 128, False), 2)],
    "bn_relu_bwd": [((512, 32), 2), ((256, 64), 2), ((128, 128), 2)],
    "dy_eff": [((512, 32), 1), ((256, 64), 1), ((128, 128), 1)],
    "maxpool_bwd": [((512, 32, True), 1), ((256, 64, True), 1), ((128, 128, True), 1)],
    "upconv_dx": PACKED_PATH["upconv_fwd"],
    "upconv_dw": PACKED_PATH["upconv_fwd"],
})
PER_STEP = {k: sum(n for _, n in shapes) for k, shapes in PACKED_PATH.items()}
PER_FORWARD = {k: PER_STEP[k] for k in FORWARD_KERNELS}
# conv3x3_bn_dw's and upconv_dw's extra ragged shapes take every bf16 ring
# instance past its tiles (kernels/conv3x3.py::dw_ring_tile,
# upconv_pack.py::dw_ring_tile) and the plain-load staging of a width that
# is not a multiple of 8 (the conv's Cout 12) or 4 (the up-conv's Cout 6)
RING_ODD = {"conv3x3_bn_dw": [(20, 40, 72, True), (20, 64, 24, True), (20, 8, 40, True),
                              (24, 16, 12, True)],
            "upconv_dw": [(20, 72, 20), (20, 40, 48), (20, 24, 6), (20, 12, 16)]}
# The bf16 forward's and dx's ring body (kernels/conv3x3.py::conv_ring_tile,
# conv_ring_blocks) past every tile and picker branch, as (H, Cin, Cout) of
# the forward conv: H not a multiple of the 16 x 16 tile; Cout past a
# channel tile of 64 (72) and of 128 (130, the forward's COT 128); a Cin
# that takes plain-load staging (12, and the dx's 130 and 5 of dy); Cin 8
# in a 16-channel TMA box; odd widths (5: no bf16 pairs); 512 channels on
# the read side, whose weights do not stay resident (they travel with each
# stage); each forward with its prologue on, and each dx with and without.
# bf16 only: f32 runs the FMA body, held at ODD's shapes
RING_CONV_ODD = [(20, 40, 72), (19, 24, 130), (20, 12, 40), (12, 512, 40), (12, 40, 512),
                 (17, 8, 24), (20, 16, 5), (20, 5, 16)]
RING_ODD.update({
    "conv3x3_bn_fwd": [(H, ci, co, True) for H, ci, co in RING_CONV_ODD],
    "conv3x3_bn_dx": [(H, ci, co, False) for H, ci, co in RING_CONV_ODD],
    "conv3x3_bn_dx_bn": [(H, ci, co, True) for H, ci, co in RING_CONV_ODD]})
ODD.update({"conv3x3_bn_dw": ODD["conv3x3_bn_fwd"] + RING_ODD["conv3x3_bn_dw"],
           "conv3x3_bn_dx_bn": [(24, 16, 16, True)],
           "conv3x3_bn_dx": [(24, 16, 16, False), (24, 16, 3, False)],
           "bn_relu_bwd": [(24, 16)], "dy_eff": [(24, 16)],
           "maxpool_bwd": [(24, 16, False), (24, 16, True)],
           "upconv_dx": ODD["upconv_fwd"],
           "upconv_dw": ODD["upconv_fwd"] + RING_ODD["upconv_dw"]})


# The bf16 up-conv forward's wgmma kernel (#27; kernels/upconv_pack.py::
# fwd_tile, fwd_blocks) at ragged shapes, batch 3, as (H_in, Cin, Cout): M
# = 3·H² not a multiple of the 128-pixel tile; Cin 40 (one k-chunk cut by
# the edge) and 72 (two); 4·Cout 32, 96 and 160 (a column tile of 64 or 128
# cut by the edge; 160 over two tiles of 128, the second partial).
UPCONV_FWD_ODD = [(20, 40, 8), (19, 72, 24), (13, 40, 40), (20, 72, 40)]
# The bf16 up-conv dx's wgmma kernel (#28; kernels/upconv_pack.py::dx_tile,
# dx_blocks) at ragged shapes, batch 3, as (H_in, Cin, Cout): the forward's
# (M not a multiple of the 128-pixel tile; Cin 40 and 72, a column tile of
# 64 or 128 cut by the edge; 4·Cout 32, 96 and 160, a k-chunk of 64 cut by
# the edge), whose W (20, 19, 13) and 2·Cout take the cp.async path; then
# two the TMA box serves: W 8, a box of 16 whole rows whose last tile runs
# past the image (M = 192), Cin 72; and 2·Cout 192, a k-chunk at a phase
# row's offset 64, W 16 (a box of eight rows), Cin 24; then two whose Kg
# slice does not fit whole and is streamed a chunk a stage: 4·Cout 1536 by
# TMA (W 8), 1600 by cp.async (W 5, 2·Cout 800).
UPCONV_DX_ODD = UPCONV_FWD_ODD + [(8, 72, 32), (16, 24, 96), (8, 16, 384), (5, 24, 400)]
# The bf16 packed head's backward (#8; kernels/head_ce.py::bn_bwd_tile,
# bn_bwd_blocks) and forward (#7; bn_fwd_tile, bn_fwd_blocks) at ragged
# shapes (P, Cin, C): P not a multiple of the 128- or 256-pixel tile, below
# one wave and past it; Cin 8, 24, 40, 64 and C 2, 8, 19, 32, every
# instance (CIN16 16, 32, 48, 64 x CMAX 16, 32) with the headline's.
BN_BWD_ODD = [(1000, 8, 2), (300017, 24, 8), (270001, 40, 19), (131075, 64, 32),
              (65537, 8, 32), (99999, 64, 8), (4099, 40, 2)]


def _head_mma_info(kernel):
    """Each bf16 #8 (``kernel`` head_ce_bn_bwd) or #7 (head_ce_bn_fwd)
    instance of phase 3 (the headline's and ``BN_BWD_ODD``'s) on this card:
    its resident blocks an SM and shared memory held against what
    ``head_ce.bn_bwd_blocks`` / ``bn_fwd_blocks`` assume, with its
    registers and local (spilled) bytes a thread printed. Returns
    {instance: (blocks, regs, local, smem)}."""
    import ctypes

    from cl_tpu_torch.kernels import build, head_ce

    lib = build.library()
    fwd = kernel == "head_ce_bn_fwd"
    entry = lib.cltorch_head_ce_bn_fwd_mma_info if fwd else lib.cltorch_head_ce_bn_mma_info
    resources = head_ce.bn_fwd_resources if fwd else head_ce.bn_bwd_resources
    out = {}
    for cin, C in sorted({(cin, C) for _, cin, C in BN_BWD_ODD} | {(32, 19)}):
        tile = head_ce.bn_bwd_tile(cin, C)
        if tile in out:
            continue
        info = (ctypes.c_int * 4)()
        build.check(entry(cin, C, ctypes.addressof(info)), f"{kernel} {tile} info")
        blocks, regs, local, smem = info
        threads, smem_py, blocks_py = resources(*tile)
        ok = blocks == blocks_py and smem == smem_py
        print(f"  {kernel}_mma<{tile[0]}, {tile[1]}>: {threads} threads, {regs} registers, "
              f"{local} local bytes a thread, {smem} B shared; {blocks} blocks an SM (the picker "
              f"assumes {blocks_py}){'' if ok else ' FAIL'}")
        need(ok, f"{kernel} {tile}: resident blocks as the picker assumes")
        out[tile] = (blocks, regs, local, smem)
    return out


def head_bwd_info():
    """The bf16 #8's instances, as ``_head_mma_info``."""
    return _head_mma_info("head_ce_bn_bwd")


def head_fwd_info():
    """The bf16 #7's instances, as ``_head_mma_info``."""
    return _head_mma_info("head_ce_bn_fwd")


def _upconv_wg_info(kernel, launches, tile, resources, entry):
    """Each bf16 wgmma launch of the up-conv (``kernel`` upconv_fwd or
    upconv_dx) at ``launches`` [(Cin, Cout), ...]: its instance's resident
    blocks an SM at the launch's shared memory held against what the
    picker assumes, with its registers and local (spilled) bytes a thread
    printed. Returns {(BN, stages, width): (blocks, regs, local, smem)},
    width the Cin (forward) or Cout (dx) the shared memory depends on."""
    import ctypes

    from cl_tpu_torch.kernels import build

    name = {"upconv_fwd": "upconv_fwd_wg", "upconv_dx": "upconv_dx_wg"}[kernel]
    out = {}
    for cin, cout in launches:
        bn, stages = tile(cin, cout)
        width = cin if kernel == "upconv_fwd" else cout
        if (bn, stages, width) in out:
            continue
        threads, smem_py, blocks_py = resources(bn, width, stages)
        info = (ctypes.c_int * 4)()
        build.check(entry(bn, smem_py, ctypes.addressof(info)), f"{kernel} {bn} info")
        blocks, regs, local, smem = info
        ok = blocks == blocks_py
        print(f"  {name}<{bn}> ({'Cin' if kernel == 'upconv_fwd' else 'Cout'} {width}, "
              f"{stages} stages): {threads} threads, {regs} registers, {local} local bytes a "
              f"thread, {smem} B shared; {blocks} blocks an SM (the picker assumes "
              f"{blocks_py}){'' if ok else ' FAIL'}")
        need(ok, f"{kernel} {bn}: resident blocks as the picker assumes")
        out[(bn, stages, width)] = (blocks, regs, local, smem)
    return out


def upconv_fwd_info():
    """Each bf16 #27 launch of phase 3 (the 512² path's, ``ODD``'s and
    ``UPCONV_FWD_ODD``'s shapes), as ``_upconv_wg_info``."""
    from cl_tpu_torch.kernels import build, upconv_pack

    shapes = [s for s, _ in PACKED_PATH["upconv_fwd"]] + ODD["upconv_fwd"] + UPCONV_FWD_ODD
    return _upconv_wg_info("upconv_fwd", [(ci, co) for _, ci, co in shapes],
                           upconv_pack.fwd_tile, upconv_pack.fwd_resources,
                           build.library().cltorch_upconv_fwd_info)


def upconv_dx_info():
    """Each bf16 #28 launch of phase 3 (the 512² path's, ``ODD``'s and
    ``UPCONV_DX_ODD``'s shapes), as ``_upconv_wg_info``."""
    from cl_tpu_torch.kernels import build, upconv_pack

    shapes = [s for s, _ in PACKED_PATH["upconv_dx"]] + ODD["upconv_dx"] + UPCONV_DX_ODD
    return _upconv_wg_info("upconv_dx", [(ci, co) for _, ci, co in shapes],
                           upconv_pack.dx_tile, upconv_pack.dx_resources,
                           build.library().cltorch_upconv_dx_info)


def ring_info():
    """Each bf16 ring instance (#36's, #29's) on this card: its resident
    blocks an SM held against what its split picker assumes, with its
    registers, local (spilled) bytes a thread and dynamic shared memory
    printed (``cudaFuncGetAttributes``; ``nvcc -Xptxas -v`` in phase 2 says
    the same at build time). Returns {instance: (blocks, regs, local,
    smem)}."""
    import ctypes

    from cl_tpu_torch.kernels import build, conv3x3, upconv_pack

    lib = build.library()
    out = {}
    for what, tiles, entry, resources in (
            ("conv3x3_dw_ring", DW_RING_TILES, lib.cltorch_conv3x3_dw_ring_info,
             conv3x3.dw_ring_resources),
            ("upconv_dw_ring", [(bm, bn) for bm in (64, 128) for bn in (128, 256)],
             lib.cltorch_upconv_dw_ring_info, upconv_pack.dw_ring_resources)):
        for tile in tiles:
            info = (ctypes.c_int * 4)()
            build.check(entry(*tile, ctypes.addressof(info)), f"{what}{tile} info")
            blocks, regs, local, smem = info
            threads, smem_py, blocks_py = resources(*tile)
            ok = blocks == blocks_py and smem == smem_py
            print(f"  {what}<{tile[0]}, {tile[1]}>: {threads} threads, {regs} registers, "
                  f"{local} local bytes a thread, {smem} B shared; {blocks} blocks an SM "
                  f"(the picker assumes {blocks_py}){'' if ok else ' FAIL'}")
            need(ok, f"{what}{tile}: resident blocks as the split picker assumes")
            out[f"{what}{tile}"] = (blocks, regs, local, smem)
    return out


def conv_ring_launches():
    """Every bf16 ring launch of phase 3 (the forward's and the dx's at the
    512² path's shapes and the ragged ones): {(dx, epilogue with the
    prologue, stats, cot, ck, resident, xbuf, kernel Cin): (threads, smem,
    blocks an SM)} as
    ``conv3x3.conv_ring_resources`` sizes them."""
    from cl_tpu_torch.kernels import conv3x3

    out = {}
    for kernel in ("conv3x3_bn_fwd", "conv3x3_bn_dx", "conv3x3_bn_dx_bn"):
        dx = kernel != "conv3x3_bn_fwd"
        for shape in [s for s, _ in PACKED_PATH[kernel]] + RING_ODD[kernel]:
            _, cin, cout, prologue = shape
            kin, kout = (cout, cin) if dx else (cin, cout)
            for stats in ((True, False) if dx else (False,)):
                cot, ck, resident = conv3x3.conv_ring_tile(kin, kout, dx, stats)
                xbuf = conv3x3.conv_ring_xbuf(kin, kout, dx, stats, prologue)
                out[(dx, dx and prologue, stats, cot, ck, resident, xbuf, kin)] = \
                    conv3x3.conv_ring_resources(
                    cot, ck, dx, stats, resident, kin, xbuf)
    return out


def conv_ring_info():
    """Each bf16 ring launch of the forward and dx (#32, #34/#35) on this
    card: the instance's resident blocks an SM at the launch's shared
    memory held against what ``conv3x3.conv_ring_blocks`` assumes, with its
    registers and local (spilled) bytes a thread printed. Returns {launch:
    (blocks, regs, local, smem)}."""
    import ctypes

    from cl_tpu_torch.kernels import build

    lib = build.library()
    out = {}
    for key, (threads, smem_py, blocks_py) in sorted(conv_ring_launches().items()):
        dx, epi, stats, cot, ck, resident, xbuf, kin = key
        info = (ctypes.c_int * 4)()
        build.check(lib.cltorch_conv3x3_ring_info(int(dx), cot, ck, int(epi), smem_py,
                                                  ctypes.addressof(info)),
                    f"conv ring {key} info")
        blocks, regs, local, smem = info
        ok = blocks == blocks_py and smem == smem_py
        print(f"  conv3x3_bn_ring<{'kDx' if dx else 'kFwd'}, {cot}, {ck}, {str(epi).lower()}> "
              f"(Cin {kin}, "
              f"{'stats, ' if stats else ''}{'x tile, ' if xbuf else ''}"
              f"{'resident' if resident else 'streamed'} weights): "
              f"{threads} threads, {regs} registers, {local} local bytes a thread, {smem} B "
              f"shared; {blocks} blocks an SM (the picker assumes {blocks_py})"
              f"{'' if ok else ' FAIL'}")
        need(ok, f"conv ring {key}: resident blocks as the picker assumes")
        out[key] = (blocks, regs, local, smem)
    return out


def bwd_operands(kernel, shape, dtype_name, batch=8, seed=0, stats=True):
    """Seeded operands on the card for one backward call: the forward's
    operands (a prologue with relu(b) > 0), a forward output and the
    cotangents, with nonzero stats cotangents unless ``stats`` is off."""
    import torch

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh, scale=1.0):
        return torch.randn(*sh, generator=g, device="cuda") * scale

    if kernel.startswith("conv"):
        H, cin, cout, prologue = shape
        x = randn(batch, H, H, cin).to(dt)
        w = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
        a, b = (randn(cin).abs() + 0.5, randn(cin) * 0.5 + 0.25) if prologue else (None, None)
        y, dy = randn(batch, H, H, cout).to(dt), randn(batch, H, H, cout).to(dt)
        ds1, ds2 = (randn(cout) * 0.1, randn(cout) * 0.05) if stats else (None, None)
        return x, w, a, b, y, dy, ds1, ds2, prologue
    if kernel.startswith("upconv"):
        H, cin, cout = shape
        x, dy = randn(batch, H, H, cin).to(dt), randn(batch, 2 * H, 2 * H, cout).to(dt)
        return (dy, randn(cin, cout, 2, 2, scale=cin ** -0.5)) if kernel == "upconv_dx" \
            else (x, dy)
    if kernel == "maxpool_bwd":
        H, C, tee = shape
        x = randn(batch, H, H, C).to(dt)
        x[:, 1::2, ::3] = x[:, 0::2, ::3]  # ties between the window's rows
        x[:, ::4, 1::2] = x[:, ::4, 0::2]  # and between its columns
        dy = randn(batch, H // 2, H // 2, C).to(dt)
        return x, dy, randn(batch, H, H, C).to(dt) if tee else None
    H, C = shape
    z, dz = randn(batch, H, H, C).to(dt), randn(batch, H, H, C).to(dt)
    if kernel == "bn_relu_bwd":
        return z, dz, randn(C).abs() + 0.5, randn(C)
    return dz, z, randn(C) * 0.1, randn(C) * 0.05


def bwd_fns(kernel):
    """(kernel launch, plain version, library call or None) of one backward
    kernel, each taking ``bwd_operands``; the conv's return (dx, da, db) or
    dW, the up-conv's dx or (dW, db)."""
    import torch

    from cl_tpu_torch.kernels import conv3x3, packed_eltwise, pool_pack, upconv_pack

    conv_bwd = torch.ops.aten.convolution_backward
    if kernel in ("conv3x3_bn_dx", "conv3x3_bn_dx_bn"):
        def lib(x, w, a, b, y, dy, ds1, ds2, prologue):  # cuDNN, dx of the conv alone
            return conv_bwd(dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.to(x.dtype), None,
                            [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, False, False])
        return conv3x3.launch_conv_dx, conv3x3.conv_dx_plain, \
            (lib if kernel == "conv3x3_bn_dx" else None)
    if kernel == "conv3x3_bn_dw":
        def lib(x, w, a, b, y, dy, ds1, ds2, prologue):  # cuDNN, dW of the conv alone
            return conv_bwd(dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.to(x.dtype), None,
                            [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False])
        return conv3x3.launch_conv_dw, conv3x3.conv_dw_plain, lib
    if kernel == "upconv_dx":
        def lib(dy, w):  # cuDNN, the transposed conv's input gradient
            B, H2, _, _ = dy.shape
            x = torch.empty(B, w.shape[0], H2 // 2, H2 // 2, dtype=dy.dtype, device=dy.device)
            return conv_bwd(dy.permute(0, 3, 1, 2), x, w.to(dy.dtype), None, [2, 2], [0, 0],
                            [1, 1], True, [0, 0], 1, [True, False, False])
        return upconv_pack.launch_upconv2x2_dx, upconv_pack.upconv2x2_dx_plain, lib
    if kernel == "upconv_dw":
        def lib(x, dy):  # cuDNN, the transposed conv's weight and bias gradients
            w = torch.empty(x.shape[-1], dy.shape[-1], 2, 2, dtype=x.dtype, device=x.device)
            return conv_bwd(dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, [dy.shape[-1]],
                            [2, 2], [0, 0], [1, 1], True, [0, 0], 1, [False, True, True])
        return upconv_pack.launch_upconv2x2_dw, upconv_pack.upconv2x2_dw_plain, lib
    if kernel == "maxpool_bwd":
        def lib(x, dy, ds):  # the pool's backward from its indices
            xn = x.permute(0, 3, 1, 2)
            _, idx = torch.ops.aten.max_pool2d_with_indices(xn, [2, 2], [2, 2])
            return lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                dy.permute(0, 3, 1, 2), xn, [2, 2], [2, 2], [0, 0], [1, 1], False, idx)
        return pool_pack.launch_maxpool2x2_bwd, pool_pack.maxpool2x2_bwd_plain, lib
    if kernel == "bn_relu_bwd":
        return packed_eltwise.launch_bn_relu_bwd, packed_eltwise.bn_relu_bwd_plain, None
    return packed_eltwise.launch_dy_eff, packed_eltwise.dy_eff_plain, None


def _abs_terms(kernel, ops):
    """Per-output Σ|term| of the f32 sums a backward's outputs are made of
    (for the tolerance of a sum taken in another order): a tuple with None
    for an output that is not such a sum, or None."""
    import torch

    from cl_tpu_torch.kernels import conv3x3, upconv_pack

    if kernel == "conv3x3_bn_dx_bn":  # da = Σ [u>0]·dt·x, db = Σ [u>0]·dt
        x, w, a, b, y, dy, ds1, ds2, _ = ops
        dt = conv3x3.conv_dx_plain(x, w, None, None, y, dy, ds1, ds2, False)[0].float().abs()
        xf = x.float()
        du = torch.where(xf * a + b > 0, dt, 0.0).reshape(-1, x.shape[-1])
        return None, (du * xf.abs().reshape(du.shape)).sum(0), du.sum(0)
    if kernel == "conv3x3_bn_dw":
        x, w, a, b, y, dy, ds1, ds2, prologue = ops
        e = conv3x3.dy_eff(dy, y, ds1, ds2)
        t = conv3x3.prologue_t(x, a, b, prologue)
        return conv3x3.conv_dw_plain(t.abs(), w, None, None, y, e.abs(), None, None, False)
    if kernel == "upconv_dw":
        x, dy = ops
        return upconv_pack.upconv2x2_dw_plain(x.abs(), dy.abs())
    return None


def compare_bwd(kernel, shape, dtype_name, batch=8, stats=True, ew=False):
    """Backward kernel vs its plain version on the card; returns the max abs
    error of its main output. Tolerances: exact for the pool and the two
    eltwise passes (the same f32 operations, one rounding); dx one bf16 ulp
    + 1e-5·max(1, a) in bf16, 1e-5 + 1e-5·|plain| in f32 (f32 sums in
    another order, then one rounding; the prologue's epilogue scales by a);
    dW and db 2 bf16 ulps + 1e-5·Σ|term| in bf16, 1e-5·Σ|term| + 1e-6 in f32
    (a sum over every pixel in another order); the per-channel sums of the
    eltwise and the conv's da, db 1e-5 of Σ|term|. A second launch must
    give the same bits. ``ew``: the conv's variant under CL_TPU_E_BF16."""
    import torch

    launch, plain, _ = bwd_fns(kernel)
    kw = {"e_bf16": True} if ew else {}
    ops = bwd_operands(kernel, shape, dtype_name, batch, stats=stats)
    k_out, p_out, again = launch(*ops, **kw), plain(*ops, **kw), launch(*ops, **kw)
    torch.cuda.synchronize()
    if not isinstance(k_out, tuple):
        k_out, p_out, again = (k_out,), (p_out,), (again,)
    # no float atomics: a second launch repeats every bit
    need(all(u is None or torch.equal(u, v) for u, v in zip(k_out, again)),
         f"{kernel}{shape} {dtype_name}: a second launch repeats every bit")
    name = packed_name(kernel, shape, dtype_name) + ("" if stats else "[no stats]") + \
        ("[ebf16]" if ew else "")
    bf16 = dtype_name == "bfloat16"
    terms = _abs_terms(kernel, ops)
    if terms is not None and not isinstance(terms, tuple):
        terms = (terms,)
    dw_kernel = kernel in ("conv3x3_bn_dw", "upconv_dw")
    ok, msg, main_err = True, f"  {name}:", None
    for i, (k, p) in enumerate(zip(k_out, p_out)):
        if k is None and p is None:
            continue
        need(k.shape == p.shape and k.dtype == p.dtype, f"{name} output {i} shape/dtype")
        kf, pf = k.float(), p.float()
        need(bool(torch.isfinite(kf).all()), f"{name} output {i} not finite")
        diff = (kf - pf).abs()
        if kernel in ("maxpool_bwd", "dy_eff") or (kernel == "bn_relu_bwd" and i == 0):
            tol, txt = torch.zeros_like(pf), "exact"
        elif kernel == "bn_relu_bwd":  # Σ du·y, Σ du
            y, dz = ops[0].float(), ops[1].float().abs()
            src = (dz * y.abs() if i == 1 else dz).reshape(-1, pf.shape[0]).sum(0)
            tol, txt = 1e-5 * src + 1e-6, "1e-5 Σ|term|"
        elif i == 0 and not dw_kernel:  # dx
            a = ops[2] if kernel == "conv3x3_bn_dx_bn" else None
            amax = 1.0 if a is None else max(1.0, a.abs().max().item())
            if bf16:
                tol = bf16_ulp(torch.maximum(kf.abs(), pf.abs())) + 1e-5 * amax
                txt = "1 bf16 ulp + 1e-5 max(1, a)"
            else:
                tol, txt = 1e-5 * amax + 1e-5 * pf.abs(), "1e-5 max(1, a) + 1e-5 rel"
        elif i == 0 and bf16:  # dW, rounded to bf16
            tol = 1e-5 * terms[i] + 2 * bf16_ulp(torch.maximum(kf.abs(), pf.abs()))
            txt = "2 bf16 ulp + 1e-5 Σ|term|"
        else:  # f32 sums over the pixels: dW in f32, db, da
            tol, txt = 1e-5 * terms[i] + 1e-6, "1e-5 Σ|term| + 1e-6"
        good = bool((diff <= tol).all())
        ok = ok and good
        main_err = diff.max().item() if main_err is None else main_err
        msg += f" out{i} max abs err {diff.max().item():.3g} ({txt}){'' if good else ' FAIL'};"
    print(msg + (" ok" if ok else " FAIL"))
    need(ok, name)
    return main_err


# The f32 dx (#34's and #35's FMA body) at the ragged 512-channel shape of
# RING_CONV_ODD: 9 x 512 = 4,608 products a sum. Added in one serial order
# they missed compare_bwd's f32 dx tolerance (1e-5 + 1e-5·|plain|), 4.4
# u·Σ|term| from float64 against cuDNN's 1.0; the body's blocked sum
# (csrc/conv3x3_bn.cuh::kDxBlock) holds it. Phase 3 holds it at that
# tolerance and the kernel and its plain version against float64
# (``f32_dx_float64``).
F32_DX_WIDE = (12, 40, 512)


def f32_dx_float64(kernel, shape, batch=3):
    """The f32 dx (``conv3x3_bn_dx``, or ``conv3x3_bn_dx_bn`` with the
    prologue) and its plain version against float64 on the same operands:
    each one's max abs error, and its largest ratio to u·Σ|term| (u =
    2^-24; Σ|term| the magnitudes of the products behind each output). Both
    must lie within the bound of an f32 sum of n terms in any order, n·u·Σ|term|
    (n: the products a sum, plus the roundings of e, of the sum and of the
    epilogue). Returns {"kernel": (err, ratio), "plain": (err, ratio)}."""
    import torch
    import torch.nn.functional as F

    launch, plain, _ = bwd_fns(kernel)
    ops = bwd_operands(kernel, shape, "float32", batch)
    x, w, a, b, y, dy, ds1, ds2, prologue = ops
    got = {"kernel": launch(*ops)[0], "plain": plain(*ops)[0]}
    e = dy.double() + ds1.double() + 2.0 * y.double() * ds2.double()

    def conv_t(t, wt):  # dx of the conv alone, NHWC in and out
        return F.conv_transpose2d(t.permute(0, 3, 1, 2), wt, padding=1).permute(0, 2, 3, 1)

    ref, terms = conv_t(e, w.double()), conv_t(e.abs(), w.double().abs())
    if prologue:  # du = [u > 0]·dt with u = x·a + b in f32, as both compute it
        mask = (x.float() * a + b > 0).double()
        ref, terms = ref * mask * a.double(), terms * mask * a.double().abs()
    u, n = 2.0 ** -24, 9 * shape[2] + 4
    out, ok = {}, True
    msg = f"  {packed_name(kernel, shape, 'float32')} vs float64 (n·u·Σ|term|, n = {n}):"
    for name, t in got.items():
        err = (t.double() - ref).abs()
        good = bool((err <= n * u * terms).all())
        ratio = (err / (u * terms)).nan_to_num(0.0).max().item()
        ok = ok and good
        out[name] = (err.max().item(), ratio)
        msg += (f" {name} max abs err {err.max().item():.3g}, at most {ratio:.1f} u·Σ|term|"
                f"{'' if good else ' FAIL'};")
    print(msg + (" ok" if ok else " FAIL"))
    need(ok, f"{kernel}{shape} float32 vs float64")
    return out


def bwd_bytes_ops(kernel, shape, dtype_name, batch=8):
    """Bytes the function must move (each input read once, each output
    written once) and its operations, at the path's operands (stats
    cotangents present)."""
    es = 2 if dtype_name == "bfloat16" else 4
    if kernel.startswith("conv"):
        H, cin, cout, prologue = shape
        px = batch * H * H
        vec = 8 * cout + (8 * cin if prologue else 0)  # ds1, ds2; a, b
        if kernel == "conv3x3_bn_dw":
            return (px * (cin + 2 * cout) * es + 9 * cin * cout * 4 + vec,
                    18 * px * cin * cout + 4 * px * cout + (3 * px * cin if prologue else 0))
        nbytes = px * (2 * cout + cin) * es + 9 * cin * cout * es + vec
        ops = 18 * px * cin * cout + 4 * px * cout
        if kernel == "conv3x3_bn_dx_bn":
            return nbytes + px * cin * es + 8 * cin, ops + 7 * px * cin
        return nbytes, ops
    if kernel.startswith("upconv"):
        H, cin, cout = shape
        px = batch * H * H
        if kernel == "upconv_dx":
            return px * (4 * cout + cin) * es + 4 * cin * cout * es, 8 * px * cin * cout
        return px * (cin + 4 * cout) * es + 4 * (4 * cin * cout + cout), \
            8 * px * cin * cout + 4 * px * cout
    if kernel == "maxpool_bwd":
        H, C, tee = shape
        n = batch * H * H * C
        return (n * (3 if tee else 2) + n // 4) * es, n * (3 if tee else 2)
    H, C = shape
    n = batch * H * H * C
    return 3 * n * es + 8 * C, 5 * n


def bwd_times(kernel, shape, dtype_name="bfloat16"):
    """(ms, plain_ms, library_ms or None, ms synchronised per launch) at
    one shape."""
    launch, plain, lib = bwd_fns(kernel)
    ops = bwd_operands(kernel, shape, dtype_name)
    lib_fn = None
    if lib is not None:
        lib_fn = lib(*ops) if kernel == "maxpool_bwd" else (lambda: lib(*ops))
    return (time_ms(lambda: launch(*ops)), time_ms(lambda: plain(*ops)),
            None if lib_fn is None else time_ms(lib_fn),
            time_ms(lambda: launch(*ops), queued=False))


def json_entry(name, source, replaces, launches, err, times, bytes_ops, peak="bfloat16"):
    """One line of the ``kernels`` JSON from a kernel's measurements: the
    bound is the larger of the bytes over the memory rate and the
    operations over the ``peak`` rate."""
    ms, plain_ms, lib_ms = times[:3]
    nbytes, ops = bytes_ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[peak] * 1e3
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms}
    need(launches > 0, f"{name} launched on its path")
    return entry


def kernel_entry(kernel, shape, source, replaces, launches, err, times, bytes_ops):
    """A packed kernel's line (bf16 operations)."""
    return json_entry(packed_name(kernel, shape, "bfloat16"), source, replaces, launches, err,
                      times, bytes_ops)


# ---------------------------------------------------------------------------
# Phase 3 / 6: the methods kernels (EWC's penalty, its gradient, the Fisher
# accumulation; the replay gather)
# ---------------------------------------------------------------------------


METHODS_KERNELS = {  # launch-count key: (source, TPU kernel's pallas_call)
    "ewc_penalty": ("cl_tpu_torch/csrc/ewc.cu", "cl_tpu/pallas/ewc_fused.py:72"),
    "ewc_grad": ("cl_tpu_torch/csrc/ewc.cu", "cl_tpu/pallas/ewc_fused.py:95"),
    "ewc_sq_acc": ("cl_tpu_torch/csrc/ewc.cu", "cl_tpu/pallas/ewc_fused.py:163"),
    "replay_gather": ("cl_tpu_torch/csrc/replay_gather.cu",
                      "cl_tpu/pallas/replay_gather.py:76"),
}
S_REPLAY = 576  # the 512² presets' source size: the replay buffer's rows


def n_params(num_classes):
    """Params of UNet-32, depth 4, with a head of ``num_classes``: the
    length of the flat vectors the EWC kernels take."""
    from cl_tpu_torch.models.unet import UNet

    return sum(p.numel() for p in UNet(num_classes, 32, 4).parameters())


def ewc_operands(n, seed, T=None):
    """Seeded f32 vectors on the card: θ, an anchor near it, a positive
    Fisher (rows of [T, n] when T is given), a cotangent g ≠ 1 and a
    gradient."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (n,) if T is None else (T, n)
    theta = torch.randn(n, device="cuda", generator=gen) * 0.05
    anchor = theta + torch.randn(shape, device="cuda", generator=gen) * 0.01
    fisher = torch.rand(shape, device="cuda", generator=gen) + 0.5
    g = torch.tensor(0.37 * 3e4, device="cuda")
    grad = torch.randn(n, device="cuda", generator=gen) * 1e-2
    return theta, anchor, fisher, g, grad


def ulp_err(got, want):
    """max |got − want| in f32 ulps of want (0 = bit-equal)."""
    import torch

    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 23)
    return ((got - want).abs() / ulp).max().item()


def compare_ewc(n, seed):
    """#17 (relaunched bit-equal, and in separate mode over T = 2 rows),
    #18 with a cotangent ≠ 1 and #19 against their plain versions at n.
    Returns {kernel: max abs err}."""
    import torch

    from cl_tpu_torch.kernels import ewc_fused as ef

    theta, anchor, fisher, g, grad = ewc_operands(n, seed)
    got = ef.launch_penalty(theta, anchor, fisher)
    again = ef.launch_penalty(theta, anchor, fisher)
    want = ef.penalty_plain(theta, anchor, fisher)
    exact = ef.penalty_plain(theta.double(), anchor.double(), fisher.double()).item()
    rel = abs(got.item() - want.item()) / want.item()
    print(f"  ewc_penalty n={n}: {got.item():.8g} (plain {want.item():.8g}, float64 {exact:.8g}); "
          f"relative err {rel:.3g} (tol 1e-5), relaunch bit-equal {torch.equal(got, again)}")
    need(rel <= 1e-5 and torch.equal(got, again), f"ewc_penalty n={n}")
    _, anchor2, fisher2, _, _ = ewc_operands(n, seed + 1, T=2)
    got2 = sum(ef.launch_penalty(theta, anchor2[t], fisher2[t]) for t in range(2))
    want2 = sum(ef.penalty_plain(theta, anchor2[t], fisher2[t]) for t in range(2))
    rel2 = abs(got2.item() - want2.item()) / want2.item()
    print(f"  ewc_penalty separate T=2 n={n} (row 1 {'un' if (n * 4) % 16 else ''}aligned): "
          f"relative err {rel2:.3g} (tol 1e-5)")
    need(rel2 <= 1e-5, f"ewc_penalty separate n={n}")
    d_got = ef.launch_grad(theta, anchor, fisher, g)
    d_again = ef.launch_grad(theta, anchor, fisher, g)
    d_want = ef.grad_plain(theta, anchor, fisher, g)
    acc = torch.rand(n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed))
    acc_want = ef.sq_acc_plain(acc.clone(), grad)
    acc_again = ef.launch_sq_acc(acc.clone(), grad)
    acc_got = ef.launch_sq_acc(acc, grad)
    errs = {"ewc_penalty": abs(got.item() - want.item()),
            "ewc_grad": (d_got - d_want).abs().max().item(),
            "ewc_sq_acc": (acc_got - acc_want).abs().max().item()}
    u_grad, u_acc = ulp_err(d_got, d_want), ulp_err(acc_got, acc_want)
    print(f"  ewc_grad n={n}, g={g.item():.6g}: max abs err {errs['ewc_grad']:.3g}, {u_grad:.3g} "
          f"ulp (tol 1 ulp), relaunch bit-equal {torch.equal(d_got, d_again)}; ewc_sq_acc: max "
          f"abs err {errs['ewc_sq_acc']:.3g}, {u_acc:.3g} ulp (tol 1 ulp), relaunch bit-equal "
          f"{torch.equal(acc_got, acc_again)}")
    need(u_grad <= 1 and u_acc <= 1 and torch.equal(d_got, d_again)
         and torch.equal(acc_got, acc_again), f"ewc_grad / sq_acc n={n}")
    return errs


def replay_buffer(rows, shape, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, (rows, *shape), dtype=torch.uint8, device="cuda",
                         generator=gen)


def compare_gather(shape, k, seed):
    """#20 on a capacity-64 buffer of uint8 rows of ``shape``, k rows
    (indices with repeats), byte-equal to ``index_select``."""
    import torch

    from cl_tpu_torch.kernels import replay_gather as rg

    buf = replay_buffer(64, shape, seed)
    idx = torch.from_numpy(np.random.RandomState(seed).randint(0, 64, size=k).astype(np.int32))
    idx = idx.cuda()
    got, want = rg.launch_gather(buf, idx), rg.gather_plain(buf, idx)
    err = (got.int() - want.int()).abs().max().item()
    print(f"  replay_gather {shape} k={k}: byte-equal {torch.equal(got, want)}")
    need(torch.equal(got, want), f"replay_gather {shape} k={k}")
    return err


def methods_bytes_ops(kernel, n=None, shape=None, k=1):
    """(bytes each input read once and each output written once, operations)."""
    if kernel == "ewc_penalty":
        return 3 * n * 4 + 4, 4 * n
    if kernel == "ewc_grad":
        return 4 * n * 4 + 4, 3 * n
    if kernel == "ewc_sq_acc":
        return 3 * n * 4, 2 * n
    return 2 * k * int(np.prod(shape)) + 4 * k, 0


def methods_times(kernel, n=None, shape=None, k=1, seed=0):
    """(ms, plain_ms, library_ms or None, ms synchronised per launch)."""
    import torch

    from cl_tpu_torch.kernels import ewc_fused as ef
    from cl_tpu_torch.kernels import replay_gather as rg

    if kernel == "replay_gather":
        buf = replay_buffer(64, shape, seed)
        idx = torch.arange(k, dtype=torch.int32, device="cuda") * 7 % 64
        launch, plain = (lambda: rg.launch_gather(buf, idx)), (lambda: rg.gather_plain(buf, idx))
        lib = lambda: torch.index_select(buf, 0, idx)  # noqa: E731
    else:
        theta, anchor, fisher, g, grad = ewc_operands(n, seed)
        acc = torch.rand(n, device="cuda")
        fns = {"ewc_penalty": (lambda: ef.launch_penalty(theta, anchor, fisher),
                               lambda: ef.penalty_plain(theta, anchor, fisher), None),
               "ewc_grad": (lambda: ef.launch_grad(theta, anchor, fisher, g),
                            lambda: ef.grad_plain(theta, anchor, fisher, g), None),
               "ewc_sq_acc": (lambda: ef.launch_sq_acc(acc, grad),
                              lambda: ef.sq_acc_plain(acc, grad),
                              lambda: acc.addcmul_(grad, grad))}
        launch, plain, lib = fns[kernel]
    return (time_ms(launch), time_ms(plain), None if lib is None else time_ms(lib),
            time_ms(launch, queued=False))


def methods_entry(kernel, name, launches, err, times, bytes_ops):
    """A methods kernel's line (f32 or bytes: the f32 peak outside the
    tensor cores for the operations)."""
    return json_entry(name, *METHODS_KERNELS[kernel], launches, err, times, bytes_ops,
                      peak="float32")


# ---------------------------------------------------------------------------
# Phase 3 / 6: the augment kernels (#15 the image, #16 the mask)
# ---------------------------------------------------------------------------


AUG_KERNELS = {  # launch-count key: (source, TPU kernel's pallas_call)
    "augment_image": ("cl_tpu_torch/csrc/augment.cu", "cl_tpu/pallas/augment.py:94"),
    "augment_mask": ("cl_tpu_torch/csrc/augment.cu", "cl_tpu/pallas/augment.py:110"),
}
# (source, output, batch): the 512² presets (8 fresh images, + 1 replay row
# in baseline_4 and the baseline_5 cut), baseline_2, baseline_1, and an odd
# shape; each in f32 and bf16
AUG_SHAPES = [(576, 512, 8), (576, 512, 9), (320, 256, 8), (160, 128, 8), (50, 32, 3)]
AUG_MAIN = (576, 512, 9, "float32")  # baseline_4's train step with pallas_augment
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def aug_operands(src, B, seed):
    """A uint8 batch on the card: images, masks (classes 0–20, some 255)
    and flips with both values."""
    import torch

    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (B, src, src, 3)).astype(np.uint8)
    mask = rng.randint(0, 21, (B, src, src)).astype(np.uint8)
    mask[:, : src // 8] = 255
    flip = rng.rand(B) < 0.5
    flip[0], flip[-1] = True, False
    return tuple(torch.from_numpy(a).cuda() for a in (img, mask, flip))


def compare_augment(src, dst, B, dtype_name, seed=0):
    """#15 and #16 against their plain versions on the card: the mask
    bit-equal, the image within 1e-5 (f32) or one bf16 ulp (bf16) — the
    plain version's cuBLAS products may add the two nonzero terms of a
    row in another order than the kernel's FMA, a few f32 ulps of a value
    ≤ 255 before the normalization. Returns {kernel: max abs err}."""
    import torch

    from cl_tpu_torch.kernels import augment as ak

    img, mask, flip = aug_operands(src, B, seed)
    dtype = getattr(torch, dtype_name)
    kw = dict(out_size=dst, mean=MEAN, std=STD, compute_dtype=dtype)
    x = ak.launch_image(img, flip, **kw)
    xp = ak.image_plain(img, flip, **kw)
    y, yp = ak.launch_mask(mask, flip, out_size=dst), ak.mask_plain(mask, flip, out_size=dst)
    torch.cuda.synchronize()
    err = (x.float() - xp.float()).abs()
    if dtype_name == "float32":
        ok, tol_txt = bool((err <= 1e-5).all()), "tol 1e-5"
    else:
        ok, tol_txt = bool((err <= bf16_ulp(xp.float())).all()), "tol one bf16 ulp"
    print(f"  augment {src}->{dst} B={B} {dtype_name} (flips {flip.int().tolist()}): image max abs "
          f"err {err.max().item():.3g} ({tol_txt}); mask bit-equal {torch.equal(y, yp)}")
    need(ok and x.shape == (B, dst, dst, 3) and x.dtype == dtype,
         f"augment_image {src}->{dst} B={B} {dtype_name}")
    need(torch.equal(y, yp) and y.dtype == torch.int32, f"augment_mask {src}->{dst} B={B}")
    return {"augment_image": err.max().item(), "augment_mask": 0.0}


def aug_bytes_ops(kernel, src, dst, B, dtype_name):
    """(bytes each input read once and each output written once, operations):
    the image's two two-tap passes (3 operations an element each) and the
    normalization (2); the mask moves bytes only."""
    if kernel == "augment_mask":
        return B * src * src + B + B * dst * dst * 4, 0
    item = 4 if dtype_name == "float32" else 2
    ops = B * 3 * (3 * dst * src + 5 * dst * dst)
    return B * src * src * 3 + B + B * dst * dst * 3 * item, ops


def aug_times(kernel, src, dst, B, dtype_name, seed=0):
    """(ms, plain_ms, library_ms, ms synchronised per launch). The library
    call: ``F.interpolate`` bilinear (half-pixel, no antialias: the same
    coefficients, the edge clamp the same single tap) on the planar f32
    batch, the resize alone; ``nearest-exact`` for the mask (plain
    ``nearest`` takes another index rule)."""
    import torch
    import torch.nn.functional as F

    from cl_tpu_torch.kernels import augment as ak

    img, mask, flip = aug_operands(src, B, seed)
    if kernel == "augment_image":
        kw = dict(out_size=dst, mean=MEAN, std=STD, compute_dtype=getattr(torch, dtype_name))
        planar = img.permute(0, 3, 1, 2).float().contiguous()
        launch, plain = (lambda: ak.launch_image(img, flip, **kw)), \
            (lambda: ak.image_plain(img, flip, **kw))
        lib = lambda: F.interpolate(planar, size=(dst, dst), mode="bilinear",  # noqa: E731
                                    align_corners=False, antialias=False)
    else:
        planar = mask[:, None]
        launch, plain = (lambda: ak.launch_mask(mask, flip, out_size=dst)), \
            (lambda: ak.mask_plain(mask, flip, out_size=dst))
        lib = lambda: F.interpolate(planar, size=(dst, dst), mode="nearest-exact")  # noqa: E731
    return time_ms(launch), time_ms(plain), time_ms(lib), time_ms(launch, queued=False)


def aug_entry(kernel, launches, err, times, shape):
    """An augment kernel's line (f32 outside the tensor cores for the
    operations)."""
    src, dst, B, dtype_name = shape
    what = f"{B}x{src}x{src}x3 uint8 -> {dst}² {dtype_name}" if kernel == "augment_image" \
        else f"{B}x{src}x{src} uint8 -> {dst}² int32"
    return json_entry(f"{kernel} [{what}]", *AUG_KERNELS[kernel], launches, err, times,
                      aug_bytes_ops(kernel, src, dst, B, dtype_name), peak="float32")


# ---------------------------------------------------------------------------
# Phase 3 / 6: the gen-3 plain conv (#30), its dW (#31) and the two-pass
# backward's dW (#33)
# ---------------------------------------------------------------------------

V3_KERNELS = {  # kernel: (source, TPU kernel's pallas_call, launch-count keys)
    "conv3x3_fwd": ("cl_tpu_torch/csrc/conv3x3_bn.cu", "cl_tpu/pallas/conv3x3_v3.py:522",
                    ("conv3x3_fwd", "conv3x3_dx", "conv3x3_dt")),
    "conv3x3_dw": ("cl_tpu_torch/csrc/conv3x3_v3_dw.cu", "cl_tpu/pallas/conv3x3_v3.py:564",
                   ("conv3x3_dw",)),
    "conv3x3_dw_bn": ("cl_tpu_torch/csrc/conv3x3_dw_bn.cu", "cl_tpu/pallas/conv3x3_v3.py:870",
                      ("conv3x3_dw_bn",)),
}
# (H, Cin, Cout[, prologue]) at batch 8: baseline_2's 256² level under
# conv_impl=auto (enc0.conv1 and dec0.conv1 64 -> 64, dec0.conv0 128 -> 64
# and its dx 64 -> 128), and level 2 of baseline_2 with
# model.packed_min_size=0 (the two-pass convs, 256 -> 256 at 64²); the
# first shape of each is its phase 6 line
V3_SHAPES = {"conv3x3_fwd": [(256, 64, 64), (256, 128, 64), (256, 64, 128), (64, 256, 256)],
             "conv3x3_dw": [(256, 64, 64), (256, 128, 64)],
             "conv3x3_dw_bn": [(64, 256, 256, True), (64, 256, 256, False)]}
V3_ODD = {"conv3x3_fwd": [(20, 24, 40)], "conv3x3_dw": [(20, 24, 40)],
          "conv3x3_dw_bn": [(20, 24, 40, True), (20, 24, 40, False)]}
# 5v-b: baseline_2 with every conv the gate admits on the gen-3 conv, bf16
V3B_ARGS = ["preset=baseline_2", "model.conv_impl=v3", "train.compute_dtype=bfloat16"]


def v3_path_shapes():
    """(H, Cin, Cout) of each conv that 5v-b and 5n-b (``GN_FULL`` under
    ``conv_impl=auto|v3``, where admitted) route to the gen-3 conv, whose
    dW is #31 in bf16."""
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.models import packed_gate as pg

    cfgs = [parse_overrides(V3B_ARGS)] + [
        parse_overrides(GN_FULL + [f"model.conv_impl={impl}"]) for impl in ("auto", "v3")
        if not pg.standard_body_refusal(512, 32, 4, impl, "group", 2)]
    shapes = set()
    for cfg in cfgs:
        m = cfg.model
        for _, h, ci, f in pg.standard_body_levels(cfg.data.image_size, m.base_channels,
                                                   m.depth):
            for j, route in enumerate(pg.double_conv_route(h, h, ci, f, m.conv_impl, m.norm)):
                if route != "xla":
                    shapes.add((h, ci if j == 0 else f, f))
    return sorted(shapes)


def v3_dw_path_tiles():
    """Phase 3: #31 in bf16 at one shape of each ring tile that
    ``v3_path_shapes`` takes and ``V3_SHAPES`` does not (batch 8, launched
    twice), and at the widest of them, with its tile, splits and partials'
    bytes printed; returns the tiles."""
    from cl_tpu_torch.kernels import SM_COUNT, conv3x3

    shapes = v3_path_shapes()
    seen = {conv3x3.dw_ring_tile(*s[1:]) for s in V3_SHAPES["conv3x3_dw"]}
    tiles = {}
    for shape in shapes:
        tiles.setdefault(conv3x3.dw_ring_tile(*shape[1:]), shape)
    for tile, shape in tiles.items():
        if tile not in seen:
            compare_v3("conv3x3_dw", shape, "bfloat16")
    H, cin, cout = widest = max(shapes, key=lambda s: (s[1] * s[2], s[0]))
    ci_t, co_t, splits = conv3x3.dw_tile_splits(cin, cout, 8, H, H, True)
    ctiles = -(-cin // ci_t) * -(-cout // co_t)
    wave = SM_COUNT * conv3x3.dw_ring_resources(ci_t, co_t)[2]
    print(f"  #31 at 5v-b's and 5n-b's {len(shapes)} conv shapes: ring tiles "
          f"{sorted(tiles)}; the widest {widest}: tile ({ci_t}, {co_t}), {splits} splits, "
          f"{ctiles * splits} blocks (a wave {wave}), partials {splits * cout * cin * 9 * 4} B")
    need(splits >= 1 and ctiles * splits <= max(ctiles, wave),
         "#31's widest split count: one wave of resident blocks")
    compare_v3("conv3x3_dw", widest, "bfloat16")
    return sorted(tiles)


# Phase 5's config (the 512² bf16 standard body); 5g-c runs it under
# model.conv_impl=pallas
FULL_ARGS = ["preset=baseline_1", "data.image_size=512", "data.source_size=576",
             "data.num_classes=19", "train.compute_dtype=bfloat16", "model.packed_unet=false",
             "data.dataset=synthetic", "train.data_parallel=false"]
# the plain conv's staging past the paths: the plain loads of a narrow Cin
# (3 -> 32 at 64², a stem's), ragged channel tiles, Cout not a multiple of
# 64 (64 -> 40: at 16² a COT 32 tile, at 64² a COT 64 one), and 5g-c's
# bottleneck 512 -> 512 at 32² (its weights travel with each stage)
PLAIN_EXTRA = [(64, 3, 32), (16, 64, 40), (64, 64, 40), (32, 512, 512)]


def plain_path_convs():
    """{(kernel, (H, Cin, Cout)), ...}: every plain conv the bf16 paths
    launch, as a forward and as its dx (the conv Cout -> Cin): #30 on the
    convs 5v-b and 5n-b route to the gen-3 conv (``v3_path_shapes``), #40 on
    those 5g-c routes to the gen-2 conv (``g2_supported`` at phase 5's
    standard-body levels)."""
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.models import packed_gate as pg

    convs = {("conv3x3_fwd", s) for h, ci, f in v3_path_shapes() for s in ((h, ci, f), (h, f, ci))}
    m = parse_overrides(FULL_ARGS + ["model.conv_impl=pallas"]).model
    for _, h, ci, f in pg.standard_body_levels(512, m.base_channels, m.depth):
        for c in (ci, f):
            if pg.g2_supported(h, h, c, f):
                convs |= {("conv3x3_g2_fwd", (h, c, f)), ("conv3x3_g2_fwd", (h, f, c))}
    return convs


def plain_instance(shape, batch=8):
    """(COT, CK, resident) of the bf16 plain ring at a conv (H, Cin, Cout)."""
    from cl_tpu_torch.kernels import conv3x3

    H, cin, cout = shape
    return conv3x3.conv_plain_tile(cin, cout, batch * (-(-H // 16)) ** 2)


def plain_path_tiles():
    """Phase 3: #30 and #40 (each its own kernels) in bf16 at one conv of
    each plain ring instance (COT, CK, resident) that ``plain_path_convs``
    picks and ``V3_SHAPES`` / ``G2_SHAPES`` do not, and at ``PLAIN_EXTRA``
    (batch 8, launched twice, against the plain version); every instance's
    resources held against the picker's (``plain_info``). Returns [(kernel,
    shape), ...] of the convs checked here."""
    listed = {plain_instance(s) for s in V3_SHAPES["conv3x3_fwd"]}
    listed |= {plain_instance((H, ci, co)) for k in ("conv3x3_g2_fwd", "conv3x3_g2_dx")
               for H, _, ci, co in G2_SHAPES[k]}
    picked = {}
    for _, shape in sorted(plain_path_convs()):
        picked.setdefault(plain_instance(shape), shape)
    rows = [(k, s) for s in [s for inst, s in sorted(picked.items()) if inst not in listed]
            + PLAIN_EXTRA for k in ("conv3x3_fwd", "conv3x3_g2_fwd")]
    for kernel, shape in rows:
        print(f"  plain ring instance {plain_instance(shape)} at {kernel} {shape}:")
        if kernel == "conv3x3_fwd":
            compare_v3(kernel, shape, "bfloat16")
        else:
            compare_g2(kernel, (shape[0], shape[0], *shape[1:]), "bfloat16")
    print(f"  the paths' plain ring instances: {sorted(picked)} (listed shapes: {sorted(listed)})")
    plain_info(sorted({(*plain_instance(s), s[1]) for s in [*picked.values(), *PLAIN_EXTRA]}))
    return rows


def plain_info(instances):
    """Each plain instance's resident blocks an SM on this card (at least)
    and its dynamic shared bytes (the CUDA source's own formula) against its
    picker's (``conv_plain_resources`` at the instance's Cin in bf16,
    ``plain_fma_resources`` in f32), with its registers and local (spilled)
    bytes a thread printed (``cudaFuncGetAttributes``); ``instances`` are
    bf16 (COT, CK, resident, Cin)."""
    import ctypes

    from cl_tpu_torch.kernels import build, conv3x3

    lib = build.library()
    cases = [(1, cot, ck, res, cin, conv3x3.conv_plain_resources(cot, ck, res, cin),
              f"resident {res}, Cin {cin}") for cot, ck, res, cin in instances]
    cases += [(0, cot, 0, 0, 0, conv3x3.plain_fma_resources(cot), "f32") for cot in (32, 64)]
    for bf16, cot, ck, res, cin, (threads, smem, blocks_py), what in cases:
        info = (ctypes.c_int * 4)()
        build.check(lib.cltorch_conv3x3_plain_info(bf16, cot, ck, int(res), cin,
                                                    ctypes.addressof(info)),
                    f"conv3x3 plain info {cot, ck}")
        blocks, regs, local, smem_c = info
        # registers may leave room for more blocks than __launch_bounds__ asks
        ok = blocks >= blocks_py and smem_c == smem
        print(f"  plain {'ring' if bf16 else 'fma'}<{cot}{f', {ck}' if bf16 else ''}> ({what}): "
              f"{threads} threads, {regs} registers, {local} local bytes a thread, {smem} B "
              f"shared; {blocks} blocks an SM (the picker assumes {blocks_py})"
              f"{'' if ok else ' FAIL'}")
        need(ok, f"plain instance {cot, ck} ({what}): resident blocks as the picker assumes")


def plain_tile_times(rows):
    """Phase 6: each of ``plain_path_tiles``' convs in bf16 behind a card
    sleep, beside ``F.conv2d``'s on the same operands (batch 8)."""
    from cl_tpu_torch.kernel_ab import time_ms_slept

    for kernel, shape in rows:
        if kernel == "conv3x3_fwd":
            launch, _, lib = v3_fns(kernel)
            ops, name = v3_operands(kernel, shape, "bfloat16"), v3_name(kernel, shape, "bfloat16")
        else:
            g2_shape = (shape[0], shape[0], *shape[1:])
            launch, _, lib = g2_fns(kernel)
            ops = g2_operands(kernel, g2_shape, "bfloat16")
            name = g2_name(kernel, g2_shape, "bfloat16")
        bo = v3_bytes_ops("conv3x3_fwd", shape, "bfloat16")
        bound = max(bo[0] / HBM_BYTES_PER_S, bo[1] / PEAK_OPS["bfloat16"]) * 1e3
        print(f"  {name} (plain ring {plain_instance(shape)}): card sleep "
              f"{time_ms_slept(lambda: launch(*ops)):.4f} ms, F.conv2d "
              f"{time_ms_slept(lambda: lib(*ops)):.4f}, bound {bound:.4f}")


def v3_operands(kernel, shape, dtype_name, batch=8, seed=0):
    """Seeded operands on the card: (x, w) for #30, (x, dy) for #31,
    (x, a, b, e, prologue) for #33 (a prologue with relu(b) > 0 on part of
    the channels)."""
    import torch

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh, scale=1.0):
        return torch.randn(*sh, generator=g, device="cuda") * scale

    H, cin, cout = shape[:3]
    x = randn(batch, H, H, cin).to(dt)
    if kernel == "conv3x3_fwd":
        return x, randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    dy = randn(batch, H, H, cout).to(dt)
    if kernel == "conv3x3_dw":
        return x, dy
    return x, randn(cin).abs() + 0.5, randn(cin) * 0.5, dy, shape[3]


def v3_fns(kernel):
    """(kernel launch, plain version, library call) of one v3 kernel, each
    taking ``v3_operands``; the library calls are cuDNN's: ``F.conv2d`` for
    #30, ``convolution_backward``'s dW (of x, without the prologue) for
    #31 and #33."""
    import torch
    import torch.nn.functional as F

    from cl_tpu_torch.kernels import conv3x3

    if kernel == "conv3x3_fwd":
        def lib(x, w):
            return F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), padding=1)
        return conv3x3.launch_conv3x3, conv3x3.conv3x3_plain, lib

    def lib(x, *rest):
        dy = rest[0] if kernel == "conv3x3_dw" else rest[2]
        w = torch.empty(dy.shape[-1], x.shape[-1], 3, 3, dtype=x.dtype, device=x.device)
        return torch.ops.aten.convolution_backward(
            dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1, [False, True, False])
    if kernel == "conv3x3_dw":
        return conv3x3.launch_conv3x3_dw, conv3x3.conv3x3_dw_plain, lib
    return conv3x3.launch_conv3x3_dw_bn, conv3x3.conv3x3_dw_bn_plain, lib


def v3_name(kernel, shape, dtype_name, batch=8):
    return f"{kernel}[{batch}x{'x'.join(str(v) for v in shape)},{dtype_name}]"


def compare_v3(kernel, shape, dtype_name, batch=8, ew=False):
    """A v3 kernel against its plain version on the card, launched twice
    (the second launch must repeat every bit); returns the max abs error.
    Tolerances: y 1e-5 of Σ|term| in f32 (an f32 sum in another order),
    plus one bf16 ulp in bf16 (then rounded once); dW (f32, not rounded)
    1e-5 of Σ|term| + 1e-6. ``ew``: #33 under CL_TPU_E_BF16."""
    import torch

    from cl_tpu_torch.kernels import conv3x3

    launch, plain, _ = v3_fns(kernel)
    kw = {"e_bf16": True} if ew else {}
    ops = v3_operands(kernel, shape, dtype_name, batch)
    k_out, again, p_out = launch(*ops, **kw), launch(*ops, **kw), plain(*ops, **kw)
    torch.cuda.synchronize()
    name = v3_name(kernel, shape, dtype_name, batch) + ("[ebf16]" if ew else "")
    need(torch.equal(k_out, again), f"{name}: a second launch repeats every bit")
    need(k_out.shape == p_out.shape and k_out.dtype == p_out.dtype, f"{name} shape/dtype")
    kf, pf = k_out.float(), p_out.float()
    need(bool(torch.isfinite(kf).all()), f"{name} not finite")
    if kernel == "conv3x3_fwd":
        x, w = ops
        terms = conv3x3.conv3x3_plain(x.float().abs(), w.abs())
    elif kernel == "conv3x3_dw":
        x, dy = ops
        terms = conv3x3.conv3x3_dw_plain(x.float().abs(), dy.float().abs())
    else:
        x, a, b, e, prologue = ops
        t = conv3x3.prologue_t(x, a, b, prologue)
        terms = conv3x3.conv3x3_dw_plain(t.float().abs(), e.float().abs())
    tol = 1e-5 * terms.float() + 1e-6
    txt = "1e-5 Σ|term|"
    if kernel == "conv3x3_fwd" and dtype_name == "bfloat16":
        tol = tol + bf16_ulp(torch.maximum(kf.abs(), pf.abs()))
        txt += " + 1 bf16 ulp"
    diff = (kf - pf).abs()
    ok = bool((diff <= tol).all())
    print(f"  {name}: max abs err {diff.max().item():.3g} (max|plain| "
          f"{pf.abs().max().item():.3g}; tol {txt}); relaunch bit-equal {'ok' if ok else 'FAIL'}")
    need(ok, name)
    return diff.max().item()


def v3_bytes_ops(kernel, shape, dtype_name, batch=8):
    """Bytes each input read once and each output written once, and the
    operations: 2·9·Cin·Cout a pixel for the conv and each dW, plus the
    prologue's three a channel."""
    es = 2 if dtype_name == "bfloat16" else 4
    H, cin, cout = shape[:3]
    px = batch * H * H
    if kernel == "conv3x3_fwd":
        return px * (cin + cout) * es + 9 * cin * cout * es, 18 * px * cin * cout
    prologue = kernel == "conv3x3_dw_bn" and shape[3]
    return (px * (cin + cout) * es + 9 * cin * cout * 4 + (8 * cin if prologue else 0),
            18 * px * cin * cout + (3 * px * cin if prologue else 0))


def v3_times(kernel, shape, dtype_name):
    """(ms, plain_ms, library_ms, ms synchronised per launch) at one shape."""
    launch, plain, lib = v3_fns(kernel)
    ops = v3_operands(kernel, shape, dtype_name)
    return (time_ms(lambda: launch(*ops)), time_ms(lambda: plain(*ops)),
            time_ms(lambda: lib(*ops)), time_ms(lambda: launch(*ops), queued=False))


# ---------------------------------------------------------------------------
# Phase 3 / 6: the gen-2 conv of model.conv_impl=pallas|hybrid: #40 as a
# forward and as a dx, its dW #41
# ---------------------------------------------------------------------------

G2_KERNELS = {  # kernel: (source, TPU kernel's pallas_call, launch-count keys)
    "conv3x3_g2_fwd": ("cl_tpu_torch/csrc/conv3x3_g2.cu", "cl_tpu/pallas/conv3x3.py:279",
                       ("conv3x3_g2_fwd", "conv3x3_g2_dx")),
    "conv3x3_g2_dw": ("cl_tpu_torch/csrc/conv3x3_g2.cu", "cl_tpu/pallas/conv3x3.py:309",
                      ("conv3x3_g2_dw",)),
}
# (H, W, Cin, Cout) at batch 8, as the kernel sees them: baseline_2's 256²
# level under conv_impl=pallas (enc0.conv1 and dec0.conv1 64 -> 64,
# dec0.conv0 128 -> 64), its 128² entry 64 -> 128, the bottleneck's
# 1024 -> 1024 at 16² and the 512² standard body's 32 -> 32 (p = 4); the
# dx (#40 on dy with the flipped, channel-swapped weight) of the
# bottleneck's first conv, 1024 channels of dy -> 512 of dx. The first
# shape of each is its phase 6 line
G2_SHAPES = {"conv3x3_g2_fwd": [(256, 256, 64, 64), (256, 256, 128, 64), (128, 128, 64, 128),
                                (16, 16, 1024, 1024), (512, 512, 32, 32)],
             "conv3x3_g2_dx": [(16, 16, 1024, 512)],
             "conv3x3_g2_dw": [(256, 256, 64, 64), (16, 16, 1024, 1024), (512, 512, 32, 32)]}
# the shapes gen-3 never takes: odd rows (one whole-image tile) and p = 16,
# with 3 images
G2_ODD = [(6, 16, 16, 32), (32, 32, 8, 16)]
# #33 (H, Cin, Cout, prologue), #31 (H, Cin, Cout) and #41 (H, W, Cin,
# Cout) past their path tiles, with 3 images: a narrow x (Cin < 8: the bf16
# ring's raw window rows; the f32 body's plain loads), widths that are not a multiple of 8 (the
# ring's plain loads) or 4 (the f32 body's), ragged channel tiles of the
# ring's 64 x 64 and 64 x 32 and the f32 body's 32 x 64 and 32 x 32 tiles
DW_ODD = {"conv3x3_dw_bn": [(19, 3, 40, True), (20, 40, 72, True), (12, 6, 18, False),
                            (20, 72, 24, True)],
          "conv3x3_dw": [(19, 3, 40), (20, 40, 72), (12, 6, 18), (20, 72, 24)],
          "conv3x3_g2_dw": [(19, 21, 3, 40), (20, 20, 40, 72), (12, 13, 6, 18),
                            (20, 20, 72, 24)]}
# the dW ring's instances (CI_T, CO_T) (#36's, and #31's, #33's and #41's in
# bf16), the register-blocked body's (#31's, #33's and #41's in f32)
DW_RING_TILES = [(ci, co) for ci in (16, 32, 64) for co in (32, 64)]
DW_FMA_TILES = [(32, 32), (32, 64)]


def g2_operands(kernel, shape, dtype_name, batch=8, seed=0):
    """Seeded operands on the card: (x, w) for #40's forward, (dy, w) for
    its dx (w the forward conv's [C_dy, C_dx, 3, 3]), (x, dy) for #41."""
    import torch

    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh, scale=1.0):
        return torch.randn(*sh, generator=g, device="cuda") * scale

    H, W, cin, cout = shape
    x = randn(batch, H, W, cin).to(dt)
    if kernel == "conv3x3_g2_fwd":
        return x, randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    if kernel == "conv3x3_g2_dx":
        return x, randn(cin, cout, 3, 3, scale=(9 * cin) ** -0.5)
    return x, randn(batch, H, W, cout).to(dt)


def g2_fns(kernel):
    """(kernel launch, plain version, cuDNN call) of one gen-2 kernel, each
    taking ``g2_operands``: ``F.conv2d`` for #40 (of dy with the flipped,
    channel-swapped weight for the dx), ``torch.nn.grad.conv2d_weight`` (its
    ``convolution_backward``) for #41."""
    import torch
    import torch.nn.functional as F

    from cl_tpu_torch.kernels import conv3x3_g2
    from cl_tpu_torch.kernels.conv3x3 import _flip_t

    if kernel == "conv3x3_g2_dw":
        def lib(x, dy):
            return torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2),
                                               (dy.shape[-1], x.shape[-1], 3, 3),
                                               dy.permute(0, 3, 1, 2), padding=1)
        return conv3x3_g2.launch_conv3x3_g2_dw, conv3x3_g2.conv3x3_g2_dw_plain, lib
    if kernel == "conv3x3_g2_dx":
        def launch(dy, w):
            return conv3x3_g2.launch_conv3x3_g2(dy, _flip_t(w))

        def plain(dy, w):
            return conv3x3_g2.conv3x3_g2_plain(dy, _flip_t(w))

        def lib(dy, w):
            return F.conv2d(dy.permute(0, 3, 1, 2), _flip_t(w).to(dy.dtype), padding=1)
        return launch, plain, lib

    def lib(x, w):
        return F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), padding=1)
    return conv3x3_g2.launch_conv3x3_g2, conv3x3_g2.conv3x3_g2_plain, lib


def g2_name(kernel, shape, dtype_name, batch=8):
    return f"{kernel}[{batch}x{'x'.join(str(v) for v in shape)},{dtype_name}]"


def compare_g2(kernel, shape, dtype_name, batch=8):
    """A gen-2 kernel against its plain version on the card, launched twice
    (the second launch must repeat every bit); returns the max abs error.
    Tolerances, #30/#31's: y and dx 1e-5 of Σ|term| in f32, plus one bf16
    ulp in bf16 (then rounded once); dW (f32, not rounded) 1e-5 of Σ|term|
    + 1e-6."""
    import torch

    launch, plain, _ = g2_fns(kernel)
    ops = g2_operands(kernel, shape, dtype_name, batch)
    k_out, again, p_out = launch(*ops), launch(*ops), plain(*ops)
    torch.cuda.synchronize()
    name = g2_name(kernel, shape, dtype_name, batch)
    need(torch.equal(k_out, again), f"{name}: a second launch repeats every bit")
    need(k_out.shape == p_out.shape and k_out.dtype == p_out.dtype, f"{name} shape/dtype")
    kf, pf = k_out.float(), p_out.float()
    need(bool(torch.isfinite(kf).all()), f"{name} not finite")
    terms = plain(*(t.float().abs() for t in ops)).float()
    tol = 1e-5 * terms + 1e-6
    txt = "1e-5 Σ|term|"
    if kernel != "conv3x3_g2_dw" and dtype_name == "bfloat16":
        tol = tol + bf16_ulp(torch.maximum(kf.abs(), pf.abs()))
        txt += " + 1 bf16 ulp"
    diff = (kf - pf).abs()
    ok = bool((diff <= tol).all())
    print(f"  {name}: max abs err {diff.max().item():.3g} (max|plain| "
          f"{pf.abs().max().item():.3g}; tol {txt}); relaunch bit-equal {'ok' if ok else 'FAIL'}")
    need(ok, name)
    return diff.max().item()


def g2_bytes_ops(kernel, shape, dtype_name, batch=8):
    """Bytes each input read once and each output written once (the dW's
    output f32), and the operations: 2·9·Cin·Cout a pixel."""
    es = 2 if dtype_name == "bfloat16" else 4
    H, W, cin, cout = shape
    px = batch * H * W
    if kernel == "conv3x3_g2_dw":
        return px * (cin + cout) * es + 9 * cin * cout * 4, 18 * px * cin * cout
    return px * (cin + cout) * es + 9 * cin * cout * es, 18 * px * cin * cout


def g2_times(kernel, shape, dtype_name):
    """(ms, plain_ms, library_ms, ms synchronised per launch) at one shape."""
    launch, plain, lib = g2_fns(kernel)
    ops = g2_operands(kernel, shape, dtype_name)
    return (time_ms(lambda: launch(*ops)), time_ms(lambda: plain(*ops)),
            time_ms(lambda: lib(*ops)), time_ms(lambda: launch(*ops), queued=False))


def dw_tiled_info():
    """#31's, #33's and #41's instances on this card (the ring body's in
    bf16, the register-blocked body's in f32): each one's resident blocks an SM held
    against what its split picker assumes, with its registers, local
    (spilled) bytes a thread and dynamic shared memory printed
    (``cudaFuncGetAttributes``). Returns {instance: (blocks, regs, local,
    smem)}."""
    import ctypes

    from cl_tpu_torch.kernels import build, conv3x3

    lib = build.library()
    out = {}
    for what, entry in (("conv3x3_v3_dw", lib.cltorch_conv3x3_v3_dw_info),
                        ("conv3x3_v3_dw_bn", lib.cltorch_conv3x3_dw_bn_info),
                        ("conv3x3_g2_dw", lib.cltorch_conv3x3_g2_dw_info)):
        for body, bf16, tiles, resources in (
                ("ring", 1, DW_RING_TILES, conv3x3.dw_ring_resources),
                ("reg", 0, DW_FMA_TILES, conv3x3.dw_fma_resources)):
            for tile in tiles:
                info = (ctypes.c_int * 4)()
                build.check(entry(*tile, bf16, ctypes.addressof(info)),
                            f"{what}_{body}{tile} info")
                blocks, regs, local, smem = info
                threads, smem_py, blocks_py = resources(*tile)[:3]
                ok = blocks == blocks_py and smem == smem_py
                print(f"  {what}_{body}<{tile[0]}, {tile[1]}>: {threads} threads, {regs} "
                      f"registers, {local} local bytes a thread, {smem} B shared; {blocks} "
                      f"blocks an SM (the picker assumes {blocks_py}){'' if ok else ' FAIL'}")
                need(ok, f"{what}_{body}{tile}: resident blocks as the split picker assumes")
                out[f"{what}_{body}{tile}"] = (blocks, regs, local, smem)
    return out


def g2_counts_ok(counts, label, fwd, dx, dw):
    """The gen-2 kernels' launches of a run: #40 ``fwd`` times as a
    forward and ``dx`` times as a dx, #41 ``dw`` times."""
    want = {"conv3x3_g2_fwd": fwd, "conv3x3_g2_dx": dx, "conv3x3_g2_dw": dw}
    got = {k: counts[k] for k in want}
    print(f"    gen-2 launches {got} (want {want})")
    need(got == want, f"gen-2 conv launches ({label})")


def g2_convs(cfg) -> int:
    """How many of the standard body's convs the gen-2 gate admits: #40
    forwards, dx and #41 a step under ``conv_impl=pallas``, #41 a step
    under ``=hybrid``."""
    from cl_tpu_torch.models import packed_gate as pg

    m = cfg.model
    return sum(pg.g2_supported(h, h, c, f)
               for _, h, ci, f in pg.standard_body_levels(cfg.data.image_size, m.base_channels,
                                                          m.depth)
               for c in (ci, f))


# ---------------------------------------------------------------------------
# Phase 3 / 6: the int8 saved activations (model.conv_act_store=int8): the
# quantize after #32 (32q), the dx (#38) and dW (#39) from int8
# ---------------------------------------------------------------------------

Q_KERNELS = {  # launch-count key: (source, TPU kernel)
    "conv3x3_bn_quant": ("cl_tpu_torch/csrc/conv3x3_bn.cu", "cl_tpu/pallas/conv3x3_v3.py:757"),
    "conv3x3_bn_dx_q": ("cl_tpu_torch/csrc/conv3x3_dx_q.cu", "cl_tpu/pallas/conv3x3_v3.py:1657"),
    "conv3x3_bn_dw_q": ("cl_tpu_torch/csrc/conv3x3_dw_q.cu", "cl_tpu/pallas/conv3x3_v3.py:1779"),
}
Q_P = 4  # the headline body's pack factor: the scales' column grouping
# Every int8 launch of one headline train step at 512², batch 8, every
# packed conv on the int8 route: (H, Cin, Cout, prologue, xq) of the
# forward conv, with its launches a step. The quantize runs after every
# forward; conv1 of an encoder level saves conv0's pair (xq), the decoder's
# conv1 its add_stats input; the stem's dx is never launched.
Q_PATH = {
    "conv3x3_bn_quant": [((512, 3, 32, False, False), 1), ((512, 32, 32, True, True), 1),
                         ((512, 32, 32, True, False), 1), ((512, 32, 32, False, False), 2),
                         ((256, 32, 64, False, False), 1), ((256, 64, 64, True, True), 1),
                         ((256, 64, 64, True, False), 1), ((256, 64, 64, False, False), 2),
                         ((128, 64, 128, False, False), 1), ((128, 128, 128, True, True), 1),
                         ((128, 128, 128, True, False), 1), ((128, 128, 128, False, False), 2)],
}
Q_PATH["conv3x3_bn_dw_q"] = Q_PATH["conv3x3_bn_quant"]
Q_PATH["conv3x3_bn_dx_q"] = Q_PATH["conv3x3_bn_quant"][1:]
Q_PER_STEP = {k: sum(n for _, n in shapes) for k, shapes in Q_PATH.items()}
Q_ODD = [(24, 16, 16, False, False), (24, 16, 16, True, True), (24, 16, 16, True, False),
         (24, 3, 16, False, False), (24, 16, 3, True, True)]
# The int8 convs of 5q-d (baseline_2's packed body, 256², base 64, f32) at
# its pack factor, past Q_PATH's widths: #39's f32 tile (32, 64) with two
# channel tiles of 64 and the scales grouped mod 2, in and out of the xq
# mode, and #38 with them (batch 3).
Q_P_D = 2
Q_D_SHAPES = [(128, 64, 128, True, True), (128, 128, 128, True, False)]
# The int8 convs of 5q-b/c (baseline_1 at 128², base 32, batch 8, level 0
# int8 at pack 4): 5q-c's Fisher pass runs their backward in eval mode,
# with no stats cotangents (e = dy).
Q_C_SHAPES = [(128, 3, 32, False, False), (128, 32, 32, True, True),
              (128, 32, 32, True, False), (128, 32, 32, False, False)]


def q_operands(shape, dtype_name, batch=8, seed=0, pack=Q_P, stats=True):
    """Seeded operands on the card for the int8 backward: (x or the pair
    (xq, scale), w, a, b, q, scale, dy, ds1, ds2, prologue, p), the pairs
    from the plain quantizer on seeded x and y (a prologue with relu(b) > 0
    on part of the channels, nonzero stats cotangents, or none without
    ``stats``: ds1 = ds2 = None, as an eval-mode backward has them), the
    scales grouping the columns mod ``pack``."""
    import torch

    from cl_tpu_torch.kernels import conv3x3

    H, cin, cout, prologue, xq = shape
    dt = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh, scale=1.0):
        return torch.randn(*sh, generator=g, device="cuda") * scale

    x = randn(batch, H, H, cin).to(dt)
    w = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    a, b = (randn(cin).abs() + 0.5, randn(cin) * 0.5 + 0.25) if prologue else (None, None)
    q, scale = conv3x3.quant_rows_plain(randn(batch, H, H, cout).to(dt), pack)
    dy = randn(batch, H, H, cout).to(dt)
    ds1, ds2 = (randn(cout) * 0.1, randn(cout) * 0.05) if stats else (None, None)
    x_res = conv3x3.quant_rows_plain(x, pack) if xq else x
    return x_res, w, a, b, q, scale, dy, ds1, ds2, prologue, pack


def q_name(kernel, shape, dtype_name, batch=8):
    H, cin, cout, prologue, xq = shape
    mode = ("prologue" if prologue else "slim") + (",xq" if xq else "")
    return f"{kernel}[{batch}x{H}x{H},{cin}->{cout},{mode},{dtype_name}]"


def compare_quant(shape, dtype_name, batch=8):
    """32q on the output of #32 (the kernel's own y) against the plain
    quantizer: q and the scale exact (an exact max, then one rounding per
    operation); a second launch repeats every bit. Returns 0.0."""
    import torch

    from cl_tpu_torch.kernels import conv3x3

    H, cin, cout, prologue, _ = shape
    ops = packed_operands("conv3x3_bn_fwd", (H, cin, cout, prologue), dtype_name, batch)
    y = conv3x3.launch_conv_bn(*ops)[0]
    (q, sc), again, (qp, scp) = (conv3x3.launch_quant_rows(y, Q_P),
                                 conv3x3.launch_quant_rows(y, Q_P),
                                 conv3x3.quant_rows_plain(y, Q_P))
    torch.cuda.synchronize()
    name = q_name("conv3x3_bn_quant", shape, dtype_name, batch)
    ok = (torch.equal(q, qp) and torch.equal(sc, scp) and torch.equal(q, again[0])
          and torch.equal(sc, again[1]))
    err = (q.int() - qp.int()).abs().max().item()
    print(f"  {name}: max |q - plain| {err}, scale exact {torch.equal(sc, scp)} (tol exact); "
          f"relaunch bit-equal {'ok' if ok else 'FAIL'}")
    need(ok, name)
    return 0.0


def q_fns(kernel):
    """(kernel launch, plain version, library call or None) of #38 / #39,
    each taking ``q_operands``; cuDNN's ``convolution_backward`` of the
    conv alone (dx for #38, dW for #39) as the library call."""
    import torch

    from cl_tpu_torch.kernels import conv3x3

    conv_bwd = torch.ops.aten.convolution_backward
    mask = [True, False, False] if kernel == "conv3x3_bn_dx_q" else [False, True, False]

    def lib(x_res, w, a, b, q, scale, dy, *_):
        x = torch.empty(dy.shape[:3] + (w.shape[1],), dtype=dy.dtype, device=dy.device) \
            if isinstance(x_res, tuple) else x_res
        return conv_bwd(dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.to(dy.dtype), None,
                        [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)
    if kernel == "conv3x3_bn_dx_q":
        return conv3x3.launch_conv_dx_q, conv3x3.conv_dx_q_plain, lib
    return conv3x3.launch_conv_dw_q, conv3x3.conv_dw_q_plain, lib


def compare_q_bwd(kernel, shape, dtype_name, batch=8, ew=False, pack=Q_P, stats=True):
    """#38 or #39 against its plain version on the card, launched twice
    (the second launch repeats every bit); returns the max abs error of
    dx or dW. Tolerances as ``compare_bwd``'s for the dtype kernels: e is
    the same f32 operations in both (deq(y) in f32, unrounded), so dx is
    one bf16 ulp + 1e-5·max(1, a) in bf16 and 1e-5·max(1, a) + 1e-5 rel in
    f32; dW 2 bf16 ulps + 1e-5·Σ|term| in bf16, 1e-5·Σ|term| + 1e-6 in f32;
    da, db 1e-5·Σ|term| + 1e-6. ``ew``: #39 under CL_TPU_E_BF16; ``pack``:
    the scales' column grouping; ``stats``: False for no stats cotangents
    (e = dy)."""
    import torch

    from cl_tpu_torch.kernels import conv3x3

    launch, plain, _ = q_fns(kernel)
    kw = {"e_bf16": True} if ew else {}
    ops = q_operands(shape, dtype_name, batch, pack=pack, stats=stats)
    k_out, again, p_out = launch(*ops, **kw), launch(*ops, **kw), plain(*ops, **kw)
    torch.cuda.synchronize()
    if not isinstance(k_out, tuple):
        k_out, again, p_out = (k_out,), (again,), (p_out,)
    name = q_name(kernel, shape, dtype_name, batch) + ("[ebf16]" if ew else "") + \
        ("" if pack == Q_P else f"[p={pack}]") + ("" if stats else "[no stats]")
    need(all(u is None or torch.equal(u, v) for u, v in zip(k_out, again)),
         f"{name}: a second launch repeats every bit")
    x_res, w, a, b, q, scale, dy, ds1, ds2, prologue, p = ops
    bf16 = dtype_name == "bfloat16"
    # Σ|term| from the plain versions on |operands|
    ea = conv3x3.dy_eff(dy, conv3x3.deq_rows(q, scale, p), ds1, ds2).float().abs()
    x_used = conv3x3._x_f32(x_res, p).float()
    ok, msg, main_err = True, f"  {name}:", None
    for i, (k, pv) in enumerate(zip(k_out, p_out)):
        if k is None and pv is None:
            continue
        need(k.shape == pv.shape and k.dtype == pv.dtype, f"{name} output {i} shape/dtype")
        kf, pf = k.float(), pv.float()
        need(bool(torch.isfinite(kf).all()), f"{name} output {i} not finite")
        diff = (kf - pf).abs()
        if kernel == "conv3x3_bn_dx_q" and i == 0:
            amax = max(1.0, a.abs().max().item()) if prologue else 1.0
            if bf16:
                tol = bf16_ulp(torch.maximum(kf.abs(), pf.abs())) + 1e-5 * amax
                txt = "1 bf16 ulp + 1e-5 max(1, a)"
            else:
                tol, txt = 1e-5 * amax + 1e-5 * pf.abs(), "1e-5 max(1, a) + 1e-5 rel"
        elif kernel == "conv3x3_bn_dx_q":  # da, db
            dt = torch.nn.functional.conv_transpose2d(
                ea.permute(0, 3, 1, 2), w.abs(), padding=1).permute(0, 2, 3, 1)
            du = torch.where(x_used * a + b > 0, dt, 0.0).reshape(-1, w.shape[1])
            terms = (du * x_used.abs().reshape(du.shape)).sum(0) if i == 1 else du.sum(0)
            tol, txt = 1e-5 * terms + 1e-6, "1e-5 Σ|term| + 1e-6"
        else:
            t = conv3x3.prologue_t(x_used, a, b, prologue).to(dy.dtype).float().abs()
            terms = conv3x3.conv3x3_dw_plain(t, ea)
            tol = 1e-5 * terms + (2 * bf16_ulp(torch.maximum(kf.abs(), pf.abs())) if bf16
                                  else 1e-6)
            txt = "2 bf16 ulp + 1e-5 Σ|term|" if bf16 else "1e-5 Σ|term| + 1e-6"
        good = bool((diff <= tol).all())
        ok = ok and good
        main_err = diff.max().item() if main_err is None else main_err
        msg += f" out{i} max abs err {diff.max().item():.3g} ({txt}){'' if good else ' FAIL'};"
    print(msg + (" relaunch bit-equal ok" if ok else " FAIL"))
    need(ok, name)
    return main_err


def q_nostats_cases():
    """(kernel, shape, dtype_name, batch) of phase 3's int8 launches without
    the stats cotangents: #38's bf16 ring and #39's bf16 ring and f32
    register-blocked instances at the first ``Q_PATH`` shape of each
    schedule the pickers give without them (prologue and xq mode on and off
    apart), then both kernels at every 5q-c shape in f32 and bf16."""
    from cl_tpu_torch.kernels import conv3x3

    seen, cases = set(), []

    def add(key, case):
        if key not in seen:
            seen.add(key)
            cases.append(case)
    for shape, _ in Q_PATH["conv3x3_bn_dw_q"]:
        H, cin, cout, prologue, xq = shape
        if cin != 3:  # the stem's dx is never launched
            add(("dx", prologue, xq,
                 conv3x3.dx_q_schedule(cout, cin, 8, H, H, False, prologue, xq, Q_P)[:4]),
                ("conv3x3_bn_dx_q", shape, "bfloat16", 8))
        for dtype_name in ("bfloat16", "float32"):
            add(("dw", dtype_name, prologue, xq,
                 conv3x3.dw_q_tile_splits(cin, cout, 8, H, H, dtype_name == "bfloat16", xq,
                                          Q_P)[:2]),
                ("conv3x3_bn_dw_q", shape, dtype_name, 8))
    for shape in Q_C_SHAPES:
        for kernel in ("conv3x3_bn_dx_q", "conv3x3_bn_dw_q"):
            if kernel == "conv3x3_bn_dw_q" or shape[1] != 3:
                for dtype_name in ("float32", "bfloat16"):
                    add((kernel, shape, dtype_name), (kernel, shape, dtype_name, 8))
    return cases


def q_info():
    """#38's bf16 ring instances and #39's ring (bf16) and register-blocked
    (f32) instances at every int8 launch of phase 3 (``Q_PATH``, ``Q_ODD``,
    ``Q_D_SHAPES``, ``Q_C_SHAPES``, with and without the stats cotangents
    for #38): each one's resident blocks an SM and dynamic shared bytes,
    as the CUDA source computes them for the launch's schedule, held
    against what its picker assumes (``conv3x3.dx_q_schedule``,
    ``dw_q_tile_splits`` and their resource mirrors), with its registers
    and local (spilled) bytes a thread printed. Returns {launch: (blocks,
    regs, local, smem)}."""
    import ctypes

    from cl_tpu_torch.kernels import build, conv3x3

    lib = build.library()
    launches = {}
    for (H, cin, cout, prologue, xq), B, pack in (
            [(s, 8, Q_P) for s, _ in Q_PATH["conv3x3_bn_dw_q"]] + [(s, 3, Q_P) for s in Q_ODD]
            + [(s, 3, Q_P_D) for s in Q_D_SHAPES] + [(s, 8, Q_P) for s in Q_C_SHAPES]):
        if cin != 3:  # the stem's dx is never launched
            q = conv3x3.dx_q_mode(xq, prologue)
            for stats in (True, False):
                cot, ck, resident, xbuf, _ = conv3x3.dx_q_schedule(cout, cin, B, H, H, stats,
                                                                   prologue, xq, pack)
                res = conv3x3.conv_ring_resources(cot, ck, True, stats, bool(resident), cout,
                                                  bool(xbuf), q, pack)
                launches[("dx_q", cot, ck, bool(prologue), q, stats, resident, xbuf, cout,
                          pack)] = res
        for bf16 in (1, 0):
            ci_t, co_t, _ = conv3x3.dw_q_tile_splits(cin, cout, B, H, H, bool(bf16), xq, pack)
            resources = conv3x3.dw_ring_resources if bf16 else conv3x3.dw_fma_resources
            launches[("dw_q", bf16, ci_t, co_t, bool(xq), pack)] = \
                resources(ci_t, co_t, True, xq, pack)[:3]
    out = {}
    for key, (threads, smem_py, blocks_py) in sorted(launches.items()):
        info = (ctypes.c_int * 4)()
        if key[0] == "dx_q":
            _, cot, ck, epi, q, stats, resident, xbuf, cin, pack = key
            what = f"conv3x3_q_dx_ring<{'kDxQX' if q == conv3x3.Q_X else 'kDxQ'}, {cot}, {ck}, " \
                   f"{str(epi).lower()}> ({'' if stats else 'no '}stats, Cin {cin}, " \
                   f"pack {pack}{', resident' if resident else ''}{', x tile' if xbuf else ''})"
            err = lib.cltorch_conv3x3_dx_q_info(cot, ck, int(epi), int(q == conv3x3.Q_X),
                                               int(stats), resident, xbuf, cin, pack,
                                               ctypes.addressof(info))
        else:
            _, bf16, ci_t, co_t, xq, pack = key
            what = f"conv3x3_q_dw_{'ring' if bf16 else 'reg'}<{ci_t}, {co_t}> (" \
                   f"{'xq, ' if xq else ''}pack {pack})"
            err = lib.cltorch_conv3x3_dw_q_info(ci_t, co_t, bf16, int(xq), pack,
                                               ctypes.addressof(info))
        build.check(err, f"{what} info")
        blocks, regs, local, smem = info
        ok = blocks == blocks_py and smem == smem_py
        print(f"  {what}: {threads} threads, {regs} registers, {local} local bytes a thread, "
              f"{smem} B shared; {blocks} blocks an SM (the picker assumes {blocks_py})"
              f"{'' if ok else ' FAIL'}")
        need(ok, f"{what}: resident blocks as the picker assumes")
        out[key] = (blocks, regs, local, smem)
    return out


def q_bytes_ops(kernel, shape, dtype_name, batch=8):
    """Bytes each input read once and each output written once, and the
    operations, at the path's operands: the int8 tensors one byte an
    element, their scales 4 bytes per (row, column mod p, channel)."""
    es = 2 if dtype_name == "bfloat16" else 4
    H, cin, cout, prologue, xq = shape
    px, rows = batch * H * H, batch * H * Q_P
    if kernel == "conv3x3_bn_quant":  # y read; q and the scales written
        return px * cout * es + px * cout + rows * cout * 4, 5 * px * cout
    x_bytes = px * cin + rows * cin * 4 if xq else px * cin * es
    common = px * cout * es + px * cout + rows * cout * 4 + x_bytes + 8 * cout \
        + (8 * cin if prologue else 0)  # dy, q, scales, x; ds1, ds2; a, b
    ops = 18 * px * cin * cout + 5 * px * cout  # the conv; e with deq(y)
    if kernel == "conv3x3_bn_dx_q":
        return (common + 9 * cin * cout * es + px * cin * es + (8 * cin if prologue else 0),
                ops + (8 * px * cin if prologue else 0))
    return common + 9 * cin * cout * 4, ops + (4 * px * cin if prologue or xq else 0)


def q_times(kernel, shape, dtype_name="bfloat16"):
    """(ms, plain_ms, library_ms or None, ms synchronised per launch, the
    kernel's and the dtype route's kernel's (``kernel_ab.yardstick``: the
    ring dx for #38, #36's ring for #39; None for 32q) ms behind a card
    sleep) at one shape."""
    from cl_tpu_torch.kernel_ab import time_ms_slept, yardstick
    from cl_tpu_torch.kernels import conv3x3

    if kernel == "conv3x3_bn_quant":
        H, cin, cout, prologue, _ = shape
        ops = packed_operands("conv3x3_bn_fwd", (H, cin, cout, prologue), dtype_name)
        y = conv3x3.launch_conv_bn(*ops)[0]
        launch = lambda: conv3x3.launch_quant_rows(y, Q_P)  # noqa: E731
        return (time_ms(launch), time_ms(lambda: conv3x3.quant_rows_plain(y, Q_P)), None,
                time_ms(launch, queued=False), time_ms_slept(launch), None)
    launch, plain, lib = q_fns(kernel)
    ops = q_operands(shape, dtype_name)
    return (time_ms(lambda: launch(*ops)), time_ms(lambda: plain(*ops)),
            time_ms(lambda: lib(*ops)), time_ms(lambda: launch(*ops), queued=False),
            time_ms_slept(lambda: launch(*ops)),
            time_ms_slept(yardstick(kernel, dtype_name)(*ops)))


# ---------------------------------------------------------------------------
# Phase 3 / 6: the one-pass conv backward (#37, CL_TPU_FUSE_BWD), the
# pipelined dx (34p / 35p, CL_TPU_DX_PIPE) and the packed head without a
# prologue (#5 / #6)
# ---------------------------------------------------------------------------

SWITCH_KERNELS = {  # launch-count key: (source, TPU kernel)
    # #37's source holds its f32 kernel and names the two kernels its bf16
    # launch runs (the ring dx and #36's ring)
    "conv3x3_bn_bwd_fused": ("cl_tpu_torch/csrc/conv3x3_bn_bwd_fused.cu",
                             "cl_tpu/pallas/conv3x3_v3.py:1480"),
    # the pipelined kernels run at #34/#35's pallas_call (:1233, :1259); in
    # bf16 (the kernels line's instance) as the ring's dx
    "conv3x3_bn_dx_pipe": ("cl_tpu_torch/csrc/conv3x3_ring.cu", "cl_tpu/pallas/conv3x3_v3.py:1187"),
    "conv3x3_bn_dx_bn_pipe": ("cl_tpu_torch/csrc/conv3x3_ring.cu",
                              "cl_tpu/pallas/conv3x3_v3.py:1179"),
}
# #37 at every conv of the headline step (the stem without dx), the
# pipelined dx at #34/#35's shapes; with their launches a step
SWITCH_PATH = {"conv3x3_bn_bwd_fused": PACKED_PATH["conv3x3_bn_dw"],
               "conv3x3_bn_dx_pipe": PACKED_PATH["conv3x3_bn_dx"],
               "conv3x3_bn_dx_bn_pipe": PACKED_PATH["conv3x3_bn_dx_bn"]}
SWITCH_ODD = {"conv3x3_bn_bwd_fused": [(24, 16, 16, False), (24, 16, 16, True),
                                       (24, 3, 16, False), (24, 16, 3, False),
                                       (20, 24, 40, True)],
              "conv3x3_bn_dx_pipe": [(24, 16, 16, False), (24, 16, 3, False)],
              "conv3x3_bn_dx_bn_pipe": [(24, 16, 16, True), (20, 24, 40, True)]}
PK_KERNELS = {  # the packed head+CE without a prologue, on bn_case's y as x
    "head_ce_pk_fwd": ("cl_tpu_torch/csrc/head_ce_pk.cu", "cl_tpu/pallas/head_ce.py:405"),
    "head_ce_pk_bwd": ("cl_tpu_torch/csrc/head_ce_pk.cu", "cl_tpu/pallas/head_ce.py:431"),
}


def compare_fused(shape, dtype_name, batch=8, ew=False):
    """#37 against its plain version on the card, launched twice (the
    second launch repeats every bit), and against #34/#35 (dx, da, db) and
    #36 (dW) launched on the same operands. Tolerances against the plain
    version are ``compare_bwd``'s for #34-#36; against the kernels it
    stands beside, every output bit-equal in bf16 (the wrapper launches
    the ring dx and #36's ring), dx and dW bit-equal in f32 (#36's FMA body
    is #37's), da and db in f32 held at 1e-5 of Σ|term| with the gap
    printed (its 8 x 16 tiles sum them in another order than #35's 16 x 16
    ones). The stem (Cin 3) runs without dx.
    ``ew``: every launch and the plain version under CL_TPU_E_BF16.
    Returns the max abs error of dW against the plain version."""
    import torch

    from cl_tpu_torch.kernels import conv3x3

    H, cin, cout, prologue = shape
    ops = bwd_operands("conv3x3_bn_dw", shape, dtype_name, batch)
    need_dx = cin != 3
    k = conv3x3.launch_conv_bwd_fused(*ops, e_bf16=ew, need_dx=need_dx)
    again = conv3x3.launch_conv_bwd_fused(*ops, e_bf16=ew, need_dx=need_dx)
    p = conv3x3.conv_bwd_fused_plain(*ops, e_bf16=ew, need_dx=need_dx)
    beside = (*(conv3x3.launch_conv_dx(*ops, e_bf16=ew) if need_dx else (None,) * 3),
              conv3x3.launch_conv_dw(*ops, e_bf16=ew))
    torch.cuda.synchronize()
    name = packed_name("conv3x3_bn_bwd_fused", shape, dtype_name) + ("" if need_dx else
                                                                     "[no dx]") + \
        ("[ebf16]" if ew else "")
    need(all((u is None and v is None) or torch.equal(u, v) for u, v in zip(k, again)),
         f"{name}: a second launch repeats every bit")
    bf16 = dtype_name == "bfloat16"
    ab_terms = _abs_terms("conv3x3_bn_dx_bn", ops) if prologue else None
    dw_terms = _abs_terms("conv3x3_bn_dw", ops)
    ok, msg, dw_err = True, f"  {name}:", None
    for label, i in (("dx", 0), ("da", 1), ("db", 2), ("dW", 3)):
        kv, pv, ref = k[i], p[i], beside[i]
        if kv is None:
            continue
        if label in ("da", "db") and not prologue:
            good = not bool(kv.any()) and not bool(pv.any())
            ok = ok and good
            msg += f" {label} zero{'' if good else ' FAIL'};"
            continue
        need(kv.shape == pv.shape and kv.dtype == pv.dtype, f"{name} {label} shape/dtype")
        kf, pf = kv.float(), pv.float()
        need(bool(torch.isfinite(kf).all()), f"{name} {label} not finite")
        diff = (kf - pf).abs()
        if label == "dx":
            amax = max(1.0, ops[2].abs().max().item()) if prologue else 1.0
            if bf16:
                tol = bf16_ulp(torch.maximum(kf.abs(), pf.abs())) + 1e-5 * amax
                txt = "1 bf16 ulp + 1e-5 max(1, a)"
            else:
                tol, txt = 1e-5 * amax + 1e-5 * pf.abs(), "1e-5 max(1, a) + 1e-5 rel"
        elif label == "dW":
            tol = 1e-5 * dw_terms + (2 * bf16_ulp(torch.maximum(kf.abs(), pf.abs())) if bf16
                                     else 1e-6)
            txt = "2 bf16 ulp + 1e-5 Σ|term|" if bf16 else "1e-5 Σ|term| + 1e-6"
            dw_err = diff.max().item()
        else:
            tol, txt = 1e-5 * ab_terms[i] + 1e-6, "1e-5 Σ|term| + 1e-6"
        good = bool((diff <= tol).all())
        same = torch.equal(kv, ref)
        gap = (kf - ref.float()).abs()
        if bf16 or label in ("dx", "dW"):
            good_ref = same
        else:
            good_ref = bool((gap <= tol).all())
        ok = ok and good and good_ref
        msg += (f" {label} max abs err {diff.max().item():.3g} ({txt}), vs "
                f"{'#36' if label == 'dW' else '#34/#35'} "
                f"{'bit-equal' if same else f'gap {gap.max().item():.3g}'}"
                f"{'' if good and good_ref else ' FAIL'};")
    print(msg + (" relaunch bit-equal ok" if ok else " FAIL"))
    need(ok, name)
    return dw_err


def compare_pipe(kernel, shape, dtype_name, batch=8, stats=True, ew=False):
    """34p / 35p against #34 / #35 on the same operands: every output bit
    for bit, and a relaunch too; returns the max abs error of dx against
    the plain version (#34/#35's own, held in ``compare_bwd``). ``ew``:
    each under CL_TPU_E_BF16."""
    import torch

    from cl_tpu_torch.kernels import conv3x3

    ops = bwd_operands("conv3x3_bn_dx", shape, dtype_name, batch, stats=stats)
    k = conv3x3.launch_conv_dx(*ops, pipe=True, e_bf16=ew)
    again = conv3x3.launch_conv_dx(*ops, pipe=True, e_bf16=ew)
    ref = conv3x3.launch_conv_dx(*ops, e_bf16=ew)
    p = conv3x3.conv_dx_plain(*ops, e_bf16=ew)
    torch.cuda.synchronize()
    name = packed_name(kernel, shape, dtype_name) + ("" if stats else "[no stats]") + \
        ("[ebf16]" if ew else "")
    same = all((u is None and v is None) or torch.equal(u, v) for u, v in zip(k, ref))
    rel = all((u is None and v is None) or torch.equal(u, v) for u, v in zip(k, again))
    err = (k[0].float() - p[0].float()).abs().max().item()
    print(f"  {name}: bit-equal to {'#35' if shape[3] else '#34'} {same}, relaunch bit-equal "
          f"{rel}; dx max abs err vs the plain version {err:.3g} "
          f"{'ok' if same and rel else 'FAIL'}")
    need(same and rel, f"{name} bit-equal to the unpipelined dx")
    return err


def switch_fns(kernel):
    """(kernel launch, plain version, library call or None) of #37 / 34p /
    35p, each taking ``bwd_operands``; cuDNN's ``convolution_backward`` of
    the conv alone as the library call: dx and dW in one call for #37, dx
    for 34p; none for 35p (dx with the prologue's epilogue)."""
    import torch

    from cl_tpu_torch.kernels import conv3x3

    conv_bwd = torch.ops.aten.convolution_backward
    mask = [True, True, False] if kernel == "conv3x3_bn_bwd_fused" else [True, False, False]

    def lib(x, w, a, b, y, dy, *_):
        return conv_bwd(dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w.to(x.dtype), None,
                        [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)
    if kernel == "conv3x3_bn_bwd_fused":
        return conv3x3.launch_conv_bwd_fused, conv3x3.conv_bwd_fused_plain, lib
    launch = lambda *ops: conv3x3.launch_conv_dx(*ops, pipe=True)  # noqa: E731
    return launch, conv3x3.conv_dx_plain, lib if kernel == "conv3x3_bn_dx_pipe" else None


def switch_bytes_ops(kernel, shape, dtype_name, batch=8):
    """Bytes each input read once and each output written once, and the
    operations: #37 reads x, dy, y, the weight and the vectors and writes
    dx and dW (f32), da and db; its products are the dx's and the dW's
    (the stem's dx not formed); the pipelined dx is #34/#35's function."""
    if kernel != "conv3x3_bn_bwd_fused":
        return bwd_bytes_ops("conv3x3_bn_dx_bn" if shape[3] else "conv3x3_bn_dx", shape,
                             dtype_name, batch)
    es = 2 if dtype_name == "bfloat16" else 4
    H, cin, cout, prologue = shape
    px, dx = batch * H * H, cin != 3
    nbytes = (px * (cin + 2 * cout) * es + 9 * cin * cout * (es + 4) + 8 * cout
              + (8 * cin if prologue else 0) + (px * cin * es if dx else 0)
              + (8 * cin if dx and prologue else 0))
    ops = (18 * px * cin * cout * (2 if dx else 1) + 4 * px * cout
           + (3 * px * cin if prologue else 0) + (7 * px * cin if dx and prologue else 0))
    return nbytes, ops


def switch_times(kernel, shape, dtype_name="bfloat16"):
    """(ms, plain_ms, library_ms or None, ms synchronised per launch) at
    one shape."""
    launch, plain, lib = switch_fns(kernel)
    ops = bwd_operands("conv3x3_bn_dw", shape, dtype_name)
    kw = {"need_dx": shape[1] != 3} if kernel == "conv3x3_bn_bwd_fused" else {}
    return (time_ms(lambda: launch(*ops, **kw)), time_ms(lambda: plain(*ops, **kw)),
            None if lib is None else time_ms(lambda: lib(*ops)),
            time_ms(lambda: launch(*ops, **kw), queued=False))


@contextlib.contextmanager
def tuned(**attrs):
    """``packed_gate``'s module attributes set as ``cl_tpu``'s environment
    variables would set them at import (``FUSE_BWD`` / ``DX_PIPE`` for
    ``CL_TPU_FUSE_BWD`` / ``CL_TPU_DX_PIPE``, ``CONV_VMEM_BUDGET``,
    ``FUSED_VMEM_BUDGET``, ``CONV_ROW_TARGET``, ``E_BF16`` for the tuning
    variables; the gates and the convs read them at each forward), and
    restored after."""
    from cl_tpu_torch.models import packed_gate

    saved = {k: getattr(packed_gate, k) for k in attrs}
    for k, v in attrs.items():
        setattr(packed_gate, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(packed_gate, k, v)


def switched(fuse, pipe):
    """``tuned`` with ``FUSE_BWD`` and ``DX_PIPE``."""
    return tuned(FUSE_BWD=fuse, DX_PIPE=pipe)


def with_tuning(step, **attrs):
    """``step``, each call under ``tuned(**attrs)``."""
    def run(*args):
        with tuned(**attrs):
            return step(*args)
    return run


def with_switches(step, fuse, pipe):
    """``step``, each call under ``switched(fuse, pipe)``."""
    return with_tuning(step, FUSE_BWD=fuse, DX_PIPE=pipe)


def packed_head_steps(cfg, device, n_steps=3):
    """The packed head without its prologue (#5/#6) where a user reaches
    it: the public ``head_ce.head_cross_entropy_packed`` on
    ``packed_eltwise.bn_relu`` of the packed body's raw output (the
    composition ``head_cross_entropy_packed_bn`` stands for), ``n_steps``
    optimizer steps of ``cfg``'s model on one prebuilt batch. Returns the
    launch counts of the steps, their losses, and, on the last model's
    features, that composition's loss beside ``head_cross_entropy_packed_bn``'s
    (#7)."""
    import torch

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.augment import augment
    from cl_tpu_torch.kernels import head_ce, packed_eltwise
    from cl_tpu_torch.models import packed_gate

    model, opt, _, batch, valid = build_step(cfg, device)
    d = cfg.data
    x, y = augment(batch.image, batch.mask, batch.flip, out_size=d.image_size, mean=d.mean,
                   std=d.std, compute_dtype=tl._dtype(cfg))
    p = packed_gate.pick_pack(cfg.model.base_channels, cfg.model.base_channels)
    hk, hb = model.head.weight, model.head.bias

    def composed(raw, s, sh):
        return head_ce.head_cross_entropy_packed(packed_eltwise.bn_relu(raw, s, sh), hk, hb, y,
                                                 valid, p=p, ignore_index=d.ignore_index)[0]
    torch.cuda.synchronize()
    reset_counts()
    losses = []
    for _ in range(n_steps):
        loss = composed(*model.train()(x, return_features=True, packed_features=True))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    counts = read_counts()
    with torch.no_grad():
        feats = model.train()(x, return_features=True, packed_features=True)
        pair = (composed(*feats).item(), head_ce.head_cross_entropy_packed_bn(
            *feats, hk, hb, y, valid, ignore_index=d.ignore_index)[0].item())
    del model, opt
    return counts, [v.item() for v in losses], pair


def saved_set_mib(cfg, device):
    """MiB that autograd keeps for the backward of one train-mode forward
    of ``cfg``'s model to its packed raw features (the headline step's
    body), by dtype of the saved tensors, each storage counted once; on
    the card also the peak allocated MiB at the end of that forward and
    over a backward from it (``"peak_fwd"``, ``"peak_bwd"``)."""
    import torch

    from cl_tpu_torch import train as tl

    model = tl.init_state(cfg, tl.build_model(cfg), device)
    S, Bt = cfg.data.image_size, cfg.data.batch_size
    storages, out = set(), {}

    def pack(t):
        key = t.untyped_storage()._cdata  # one StorageImpl per storage
        if key not in storages:
            storages.add(key)
            name = str(t.dtype).removeprefix("torch.")
            out[name] = out.get(name, 0.0) + t.untyped_storage().nbytes() / 2 ** 20
        return t

    x = torch.randn(Bt, S, S, 3, device=device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = model.train()(x, return_features=True, packed_features=True)[0]
    if cuda:
        torch.cuda.synchronize()
        out["peak_fwd"] = torch.cuda.max_memory_allocated() / 2 ** 20
        y.float().square().mean().backward()
        torch.cuda.synchronize()
        out["peak_bwd"] = torch.cuda.max_memory_allocated() / 2 ** 20
    del y, model
    return {k: round(v, 1) for k, v in sorted(out.items())}


# ---------------------------------------------------------------------------
# Phases 4 / 5: training paths
# ---------------------------------------------------------------------------


def reset_counts():
    from cl_tpu_torch.kernels import reset_launches

    reset_launches()


def read_counts() -> dict:
    from cl_tpu_torch.kernels import read_launches

    return read_launches()


def build_step(cfg, device, seed_batch=0, keep=None):
    """(model, optimizer, make_train_step's step, a prebuilt batch, the
    valid-class mask) of ``cfg`` on ``device``, from the seeded init
    (``profile_step.build``). Under a method, task 0's after-task hooks run
    first (EWC's Fisher pass, the LwF snapshot, the replay buffer's fill)
    and the step trains task 1, gathering its replay rows at each call
    from the device-resident buffer. ``keep``, a dict, receives the launch
    counts of the set-up (``"build_counts"``)."""
    import torch

    from cl_tpu_torch.profile_step import build

    torch.cuda.synchronize()
    reset_counts()
    built = build(cfg, device, seed_batch)
    torch.cuda.synchronize()
    if keep is not None:
        keep["build_counts"] = read_counts()
    return built


def host_issue_ms(step, batch, valid, reps=5):
    """Median host time to issue one step while the card is still busy
    with ~0.1 s of queued sleep, so the host never waits for it: the
    step's issue cost alone (a sync inside the step would show as ~100
    ms). Valid only for a step of fewer launches than the card's queue
    of pending launches holds (~1,000): the LwF and methods steps launch
    more, their host blocks until the sleep ends, and this reads ~100 ms
    without any sync (``run_steps(no_sync=True)`` checks for syncs)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        step(batch, valid)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def alternating_pairs(cfgs, device, n_pairs=5, n_warm=3, n_timed=10, switches=None):
    """images/s of each config in ``cfgs`` ({name: cfg}, both built and
    warmed first), timed in turns, the order flipped every pair, and each
    step's host issue time: ({name: [images/s of each pair]}, {name:
    issue ms}). ``switches`` ({name: (FUSE_BWD, DX_PIPE)}, or {name: a
    dict of ``tuned``'s attributes}) runs each config's steps, and builds
    it, under its setting."""
    import torch

    def setting(name):
        sw = (switches or {}).get(name, {})
        return sw if isinstance(sw, dict) else dict(FUSE_BWD=sw[0], DX_PIPE=sw[1])

    built = {}
    for name, cfg in cfgs.items():
        with tuned(**setting(name)):
            b = build_step(cfg, device)
        built[name] = (*b[:2], with_tuning(b[2], **setting(name)), *b[3:])
    for _, _, step, batch, valid in built.values():
        for _ in range(n_warm):
            step(batch, valid)
    ips = {name: [] for name in cfgs}
    names = list(cfgs)
    for i in range(n_pairs):
        for name in (names if i % 2 == 0 else names[::-1]):
            _, _, step, batch, valid = built[name]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_timed):
                aux = step(batch, valid)
            torch.cuda.synchronize()
            ips[name].append(cfgs[name].data.batch_size * n_timed / (time.perf_counter() - t0))
            need(np.isfinite(aux["loss"].item()), f"finite loss ({name})")
    return ips, {name: host_issue_ms(*built[name][2:]) for name in names}


def run_steps(cfg, n_warm, n_timed, device, seed_batch=0, keep=None, no_sync=False):
    """make_train_step on one prebuilt batch; returns (counts, img/s,
    peak MiB, last loss, first loss). Counts cover exactly these steps.
    ``keep``, a dict, receives the set-up's launch counts and the trained
    weights as a flax variable tree. ``no_sync``: one more step under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
    operation that makes the host wait for the card (a blocking copy, an
    ``.item()``)."""
    import torch

    model, opt, step, batch, valid = build_step(cfg, device, seed_batch, keep)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    first = step(batch, valid)["loss"]
    for _ in range(n_warm - 1):
        aux = step(batch, valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        aux = step(batch, valid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    loss = aux["loss"].item()
    need(np.isfinite(loss), f"finite loss ({loss})")
    if no_sync:
        torch.cuda.set_sync_debug_mode("error")
        try:
            step(batch, valid)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    ips = cfg.data.batch_size * n_timed / dt
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if keep is not None:
        from cl_tpu_torch.interop import export_jax_variables

        keep["variables"] = export_jax_variables(model)
    del model, opt, step
    return counts, ips, peak, loss, first.item()


def perturbed(variables, seed):
    """A copy of a flax variable tree with every leaf moved by seeded noise
    and BatchNorm statistics of its own: a teacher unlike the student."""
    rng = np.random.RandomState(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        if name == "var":
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        if name == "mean":
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        return (a + rng.randn(*a.shape) * 0.2 * (np.abs(a).mean() or 0.1)).astype(np.float32)

    return walk(variables)


def agree_with_cpu(args, label, packed_levels=0, f64=False, held=True):
    """One SGD step on the card (kernels) against one on the CPU (plain
    versions) from the same weights and batch: loss and params in f32.
    With ``f64`` each leaf's update is held against the same step in
    float64 on the CPU (the standard body with ``model.conv_impl=xla`` and
    the plain PyTorch loss: the same function) instead of against the
    CPU's f32 step: at baseline_1's standard body the deep BatchNorm
    biases' f32 updates on the CPU lie 1.5–5.5 times the tolerance from
    float64 (by thread count), so the CPU is the worse reference of the
    two; the CPU's and the card-against-CPU distances are printed.
    Under LwF, with a teacher unlike the student (``perturbed``), weight 1
    and the first half of the classes (at least two) old; its KD term
    checked too. Under EWC, with an anchor unlike the params (``perturbed``),
    a positive random Fisher and weight 1; its penalty checked. Under
    replay, the batch widened by rows gathered from a device-resident
    buffer filled with four of task 0's images (the same seeded draws on
    both devices). Under ``model.padded_head=false`` the model starts at
    task 0's head width and the state grows to task 1's
    (``train.expand_state``: the new rows from the same seeded CPU
    generator on both devices) before the step, which trains task 1's
    classes. Returns the gaps (|loss|, max |param|, the worst update's
    share of its tolerance); ``held`` False prints them without holding
    them (a bf16 step, held against another config's gaps)."""
    import torch

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.checkpoint import TrainState
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.data import pipeline
    from cl_tpu_torch.interop import (export_jax_variables, flat_from_params_tree,
                                      load_jax_variables)
    from cl_tpu_torch.kernels.replay_gather import DeviceReplayBuffer
    from cl_tpu_torch.methods import ewc as ewc_lib
    from cl_tpu_torch.methods import lwf as lwf_lib

    cfg = parse_overrides(args + ["train.optimizer=sgd", "train.lr=0.05",
                                  "train.data_parallel=false"])
    m = cfg.method
    hb = next(iter(pipeline.train_batches(cfg, 0, 0)))
    valid = torch.ones(cfg.data.num_classes, dtype=torch.bool)
    old_valid = torch.arange(cfg.data.num_classes) < max(2, cfg.data.num_classes // 2)
    size = cfg.data.image_size
    out = {}
    variables = before = None
    for dev in (torch.device("cpu"), torch.device("cuda")):
        model = tl.init_state(cfg, tl.build_model(cfg), dev)
        need(model.packed_levels(size, size) == packed_levels,
             f"{label}: {packed_levels} packed levels")
        if variables is None:
            variables = export_jax_variables(model)
        load_jax_variables(model, variables)
        lwf = ewc = None
        if "lwf" in m.methods:
            lwf = lwf_lib.make_lwf_state(model)
            load_jax_variables(lwf.teacher, perturbed(variables, 7))
            lwf.old_valid.copy_(old_valid)
            lwf.weight = 1.0
        if "ewc" in m.methods:
            ewc = ewc_lib.make_ewc_state(model, mode="online")
            ewc.anchor.copy_(flat_from_params_tree(model, perturbed(variables, 8)["params"]))
            n = ewc.fisher.shape[0]
            ewc.fisher.copy_(torch.from_numpy(
                (np.random.RandomState(9).rand(n) + 0.5).astype(np.float32) * 1e-3))
            ewc.weight.fill_(1.0)
        opt = tl.build_optimizer(cfg, model)
        if not cfg.model.padded_head:
            opt = tl.expand_state(cfg, TrainState(model, opt, ewc, lwf),
                                  tl.task_head_width(cfg, 1), 1).optimizer
        if before is None:
            before = {k: v.detach().double().cpu() for k, v in model.state_dict().items()}
        batch = pipeline.put_batch(hb, dev)
        if "replay" in m.methods:
            buf = DeviceReplayBuffer(m.replay_capacity, cfg.data.source_size, seed=99,
                                     device=dev)
            buf.add_examples(pipeline.make_datasets(cfg, 0)[0], 4, task_id=0)
            batch = tl._device_replay_mix(buf, batch, m.replay_batch,
                                          flip_prob=cfg.data.flip_prob)
        step = tl.make_train_step(cfg, model, opt, dev, lwf=lwf, ewc=ewc)
        aux = step(batch, valid.to(dev))
        out[dev.type] = (aux["loss"].item(), {
            k: v.detach().double().cpu() for k, v in model.state_dict().items()})
        for term in ("kd", "ewc_penalty"):
            if term in aux:
                out[f"{dev.type}_{term}"] = aux[term].item()
    if "cpu_kd" in out:
        kc, kg = out["cpu_kd"], out["cuda_kd"]
        print(f"  {label}: KD term cuda {kg:.7f} cpu {kc:.7f} (tol 1e-4)")
        need(kc > 0 and abs(kg - kc) <= 1e-4, f"card vs CPU KD term ({label})")
    if "cpu_ewc_penalty" in out:
        pc, pg = out["cpu_ewc_penalty"], out["cuda_ewc_penalty"]
        print(f"  {label}: EWC penalty cuda {pg:.8g} cpu {pc:.8g} (tol 1e-5 relative)")
        need(pc > 0 and abs(pg - pc) <= 1e-5 * pc, f"card vs CPU EWC penalty ({label})")
    (lc, pc), (lg, pg) = out["cpu"], out["cuda"]
    perr = max((pg[k] - pc[k]).abs().max().item() for k in pc)
    ref, ref_name = pc, "the CPU"
    if f64:
        cfg64 = parse_overrides(args + ["train.optimizer=sgd", "train.lr=0.05",
                                        "train.data_parallel=false", "model.conv_impl=xla",
                                        "train.use_pallas=false"])
        cpu = torch.device("cpu")
        model = tl.init_state(cfg64, tl.build_model(cfg64), cpu)
        load_jax_variables(model, variables)
        model.double()
        model.dtype = torch.float64
        step = tl.make_train_step(cfg64, model, tl.build_optimizer(cfg64, model), cpu)
        step(pipeline.put_batch(hb, cpu), valid)
        ref, ref_name = {k: v.detach().double() for k, v in model.state_dict().items()}, "float64"

    # each entry's update, (after - before), within 1e-2 of its norm plus
    # one f32 ulp of the entry per element (a BN scale near 1.0 deep in
    # the net moves by less than an ulp): a wrong backward in one kernel
    # may hide under 1e-4 on the params themselves
    def update_err(k, got, want):
        ulp = torch.exp2(torch.floor(torch.log2(want[k].abs().clamp_min(2.0 ** -126))) - 23)
        tol = 1e-2 * (want[k] - before[k]).norm() + ulp.norm()
        return ((got[k] - want[k]).norm() / tol).item()

    worst = max(ref, key=lambda k: update_err(k, pg, ref))
    print(f"  {label}: loss cuda {lg:.7f} cpu {lc:.7f}; max |param diff| {perr:.3g} "
          f"(tol 1e-4); worst update diff from {ref_name} {update_err(worst, pg, ref):.3g} of "
          f"its tolerance (1e-2 of its norm + one ulp per element), {worst}")
    if f64:
        for name, (got, want) in (("CPU vs float64", (pc, ref)), ("card vs CPU", (pg, pc))):
            k = max(ref, key=lambda k: update_err(k, got, want))
            print(f"    worst update diff, {name}: {update_err(k, got, want):.3g} of the same "
                  f"tolerance, {k} (printed, not held)")
    gaps = (abs(lg - lc), perr, update_err(worst, pg, ref))
    if held:
        need(gaps[0] <= 1e-4 and gaps[1] <= 1e-4 and gaps[2] <= 1,
             f"card vs CPU step ({label})")
    return gaps


def methods_train(label, args, device=None, keep=None):
    """``train()`` of a methods config: a finite mIoU matrix and forgetting,
    and the methods kernels launched as counted: the penalty and its
    gradient at every step (weight 0 on task 0, as in ``cl_tpu``), the
    Fisher accumulation once per Fisher batch after every task but the
    last, the gather twice per step from task 1 on (task 0 widens its
    batch with its own rows). ``keep``, a dict, receives the run's launch
    counts (``"counts"``)."""
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides

    cfg = parse_overrides(args)
    T = cfg.train.num_tasks
    per_task = cfg.data.train_images_per_task // cfg.data.batch_size * cfg.train.epochs_per_task
    nf = min(cfg.data.train_images_per_task // cfg.data.batch_size,
             cfg.method.ewc_fisher_batches)
    want = {"ewc_penalty": T * per_task, "ewc_grad": T * per_task, "ewc_sq_acc": (T - 1) * nf,
            "replay_gather": 2 * (T - 1) * per_task if "replay" in cfg.method.methods else 0}
    reset_counts()
    report = tl.train(cfg, device=device)
    counts = read_counts()
    mat = np.asarray(report["miou_matrix"], float)
    print(f"  train(), {label}: {T} tasks, {T * per_task} steps: mIoU matrix {mat.tolist()}, "
          f"forgetting {report['forgetting_per_task']}; methods launches "
          f"{ {k: counts[k] for k in want} }")
    need(np.isfinite(mat[np.tril_indices(T)]).all()
         and np.isfinite(report["forgetting_per_task"]).all(),
         f"finite mIoU and forgetting ({label})")
    for k, n in want.items():
        need(counts[k] == n, f"{k} launches == {n} in the train() of {label}")
    if keep is not None:
        keep["counts"] = counts
    return report


def lwf_card_vs_cpu(args):
    """``train()`` of an LwF config on the card and on the port's CPU path
    (plain versions) from the same weights and data stream, with the
    config's Adam and with SGD, and on the card with the plain PyTorch loss
    (``train.use_pallas=false``) beside the kernels. With Adam, f32
    rounding of the model's convolutions (cuDNN against oneDNN) moves the
    gradients of a few params near 0 to the other sign, and Adam's first
    steps move each such param by ±lr whatever its gradient's size (the
    trap the step parity tests avoid with SGD): the card lands as far from
    the CPU with the plain loss as with the kernels. So the gates, each at
    the repo's 0.5 points (0.005): with SGD, the card's final per-task mIoU
    against the CPU's; with Adam, the kernels' against the plain loss's on
    the card. Adam's card-against-CPU gaps are printed beside them. On the
    card the KD head on NHWC features runs once a step."""
    import torch

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.interop import export_jax_variables

    cfg = parse_overrides(args)
    need(tl.fused_head_on(cfg) and not tl.packed_head_on(cfg),
         "the LwF config takes the KD head on NHWC features")
    T = cfg.train.num_tasks
    steps = T * cfg.data.train_images_per_task // cfg.data.batch_size * cfg.train.epochs_per_task
    variables = export_jax_variables(tl.init_state(cfg, tl.build_model(cfg),
                                                   torch.device("cpu")))
    runs, counts = {}, None
    for opt in (cfg.train.optimizer, "sgd"):
        extra = [] if opt == cfg.train.optimizer else ["train.optimizer=sgd", "train.lr=0.05"]
        for pallas in ("true", "false"):
            c = parse_overrides(args + extra + [f"train.use_pallas={pallas}"])
            for dev in ("cuda", "cpu"):
                if pallas == "false" and dev == "cpu" and opt == "sgd":
                    continue
                reset_counts()
                r = tl.train(c, init_variables=variables, device=dev)
                if (opt, pallas, dev) == (cfg.train.optimizer, "true", "cuda"):
                    counts = read_counts()
                runs[(opt, pallas, dev)] = np.asarray(r["final_per_task_miou"], float)

    def gap(a, b):
        return float(np.abs(runs[a] - runs[b]).max())

    adam = cfg.train.optimizer
    gates = {"sgd, card vs CPU (kernels)": gap(("sgd", "true", "cuda"), ("sgd", "true", "cpu")),
             f"{adam}, card kernels vs card plain loss":
                 gap((adam, "true", "cuda"), (adam, "false", "cuda"))}
    shown = {f"{adam}, card vs CPU (kernels)": gap((adam, "true", "cuda"), (adam, "true", "cpu")),
             f"{adam}, card vs CPU (plain loss)": gap((adam, "false", "cuda"),
                                                       (adam, "false", "cpu"))}
    print(f"  5k-d {' '.join(args)}: final per-task mIoU "
          f"{ {'/'.join(k): v.tolist() for k, v in runs.items()} }")
    print(f"  5k-d max |final mIoU diff|, gates (tol 0.005 = 0.5 points): "
          f"{ {k: round(v, 5) for k, v in gates.items()} }; beside them "
          f"{ {k: round(v, 5) for k, v in shown.items()} }; KD head launches "
          f"{counts['head_ce_kd_fwd']}/{counts['head_ce_kd_bwd']} for {steps} steps")
    need(all(np.isfinite(v).all() for v in runs.values()), "finite mIoU (5k-d)")
    for k, v in gates.items():
        need(v <= 0.005, f"train() mIoU within 0.5 points: {k} (LwF, 5k-d)")
    need(counts["head_ce_kd_fwd"] == counts["head_ce_kd_bwd"] == steps
         and counts["head_ce_fwd"] == 0, "KD head launches == steps (5k-d)")


# ---------------------------------------------------------------------------
# Phase 5d: the data path (native rasterizer, device-resident dataset,
# plan-driven epochs) through train()
# ---------------------------------------------------------------------------


class NoSyncSteps:
    """Inside ``with NoSyncSteps() as ns:`` every plan-driven step (the train,
    eval and Fisher steps that ``train.make_cached_*_step`` build) runs
    under ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
    operation that makes the host wait for the card (the check of phases
    5h, 5l and 5m, on every step of a ``train()``); ``ns.steps`` counts
    the steps of each kind."""

    KINDS = ("train", "eval", "fisher")

    def __enter__(self):
        from cl_tpu_torch import train as tl

        self.tl, self.steps = tl, {k: 0 for k in self.KINDS}
        self.saved = {k: getattr(tl, f"make_cached_{k}_step") for k in self.KINDS}
        for kind, make in self.saved.items():
            setattr(tl, f"make_cached_{kind}_step", self._wrap(kind, make))
        return self

    def _wrap(self, kind, make):
        import torch

        def factory(*args, **kw):
            cstep = make(*args, **kw)

            def checked(*a, **k):
                self.steps[kind] += 1
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return cstep(*a, **k)
                finally:
                    torch.cuda.set_sync_debug_mode(0)

            return checked

        return factory

    def __exit__(self, *exc):
        for kind, make in self.saved.items():
            setattr(self.tl, f"make_cached_{kind}_step", make)


class Events:
    """Inside ``with Events() as ev:`` ``ev.events`` collects every event
    that ``train()`` logs."""

    def __enter__(self):
        from cl_tpu_torch.logging_utils import EventLogger

        self.cls, self.orig, self.events = EventLogger, EventLogger.log, []
        orig, events = self.orig, self.events

        def log(logger, **event):
            events.append(dict(event))
            return orig(logger, **event)

        EventLogger.log = log
        return self

    def __exit__(self, *exc):
        self.cls.log = self.orig


def data_path_train(label, args):
    """``train()`` of ``args`` on the plan-driven path, every step checked
    for host waits: a finite mIoU matrix and forgetting; an
    ``hbm_live_set`` event at every task boundary with the train cache
    freed and no val cache left; every image from the native rasterizer;
    the steps of each kind and the loss, method and augment kernels'
    launches as the config implies. Returns (report, launch counts, wall
    seconds)."""
    import torch

    from cl_tpu_torch import native
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.data import synthetic_native

    cfg = parse_overrides(args)
    d, m, T, E = cfg.data, cfg.method, cfg.train.num_tasks, cfg.train.epochs_per_task
    per_epoch = d.train_images_per_task // d.batch_size
    steps = {"train": T * E * per_epoch,
             "eval": sum(t + 1 for t in range(T)) * -(-d.val_images_per_task // d.batch_size),
             "fisher": (T - 1) * min(per_epoch, m.ewc_fisher_batches)
             if "ewc" in m.methods else 0}
    n = steps["train"]
    lwf_on = "lwf" in m.methods
    loss_key = (("head_ce_kd_bn" if lwf_on else "head_ce_bn") if tl.packed_head_on(cfg)
                else ("head_ce_kd" if lwf_on else "head_ce") if tl.fused_head_on(cfg) else "ce")
    # LwF on materialized logits adds the KD kernels to the CE kernels
    logits_kd = n if lwf_on and loss_key == "ce" else 0
    aug = sum(steps.values()) if tl.augment_kernels_on(cfg) else 0
    want = {f"{loss_key}_fwd": n, f"{loss_key}_bwd": n, "kd_fwd": logits_kd,
            "kd_bwd": logits_kd, "augment_image": aug, "augment_mask": aug,
            "ewc_penalty": n if "ewc" in m.methods else 0,
            "ewc_grad": n if "ewc" in m.methods else 0, "ewc_sq_acc": steps["fisher"],
            # the buffer's rows from task 1 on, images and masks; task 0
            # duplicates rows of its fresh batch
            "replay_gather": 2 * (T - 1) * E * per_epoch if "replay" in m.methods else 0}
    for k in synthetic_native.PRODUCED:
        synthetic_native.PRODUCED[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with NoSyncSteps() as ns, Events() as ev:
        report = tl.train(cfg)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    mat = np.asarray(report["miou_matrix"], float)
    live = [e for e in ev.events if e["event"] == "hbm_live_set"]
    produced = dict(synthetic_native.PRODUCED)
    print(f"  train(), {label}: {T} tasks, {n} steps, {wall:.1f} s: mIoU matrix {mat.tolist()}, "
          f"forgetting {report['forgetting_per_task']}; images/s "
          f"{report.get('images_per_sec_per_chip')}, eval images/s "
          f"{report.get('eval_images_per_sec_per_chip')}, eval overhead "
          f"{report.get('eval_overhead_seconds')}")
    print(f"    steps {ns.steps} (each under sync debug mode 'error'); images rasterized "
          f"{produced}; launches { {k: counts[k] for k in want} }")
    for e in live:
        print(f"    hbm_live_set after task {e['task']}: "
              f"{ {k: v for k, v in e.items() if k not in ('event', 'task', 't')} }")
    need(np.isfinite(mat[np.tril_indices(T)]).all()
         and np.isfinite(report["forgetting_per_task"]).all(),
         f"finite mIoU and forgetting ({label})")
    need([e["task"] for e in live] == list(range(T)), f"hbm_live_set at every boundary ({label})")
    need(all(e["train_cache_mb"] == 0 and e["val_caches_mb"] == 0 and e["val_caches_n"] == 0
             and e["params_mb"] > 0 for e in live), f"caches freed at the boundaries ({label})")
    need(native.backend() == "native" and produced["pyref"] == 0
         and produced["native"] >= T * d.train_images_per_task,
         f"the native rasterizer made the data ({label})")
    need(ns.steps == steps, f"plan-driven steps {ns.steps} == {steps} ({label})")
    for k, v in want.items():
        need(counts[k] == v, f"{k} launches {counts[k]} == {v} in the train() of {label}")
    return report, counts, wall, peak, steps


def v3_convs(cfg) -> int:
    """How many of the standard body's convs take the gen-3 conv (either
    route) under ``cfg``: #30 launches per forward, and #30 (dx) and #31
    per backward."""
    from cl_tpu_torch.models import packed_gate as pg

    m = cfg.model
    return sum(route != "xla"
               for _, h, ci, f in pg.standard_body_levels(cfg.data.image_size, m.base_channels,
                                                          m.depth)
               for route in pg.double_conv_route(h, h, ci, f, m.conv_impl, m.norm))


def v3_counts_ok(counts, label, fwd, bwd, dt=0, dw_bn=0):
    """The gen-3 kernels' launches of a run: ``fwd`` forwards of #30,
    ``bwd`` dx (#30) and dW (#31) each, ``dt`` and ``dw_bn`` of the
    two-pass backward."""
    want = {"conv3x3_fwd": fwd, "conv3x3_dx": bwd, "conv3x3_dw": bwd, "conv3x3_dt": dt,
            "conv3x3_dw_bn": dw_bn}
    got = {k: counts[k] for k in want}
    print(f"    v3 launches {got} (want {want})")
    need(got == want, f"gen-3 conv launches ({label})")


def augment_routes_agree(cuda, args=("preset=baseline_3",)):
    """Three steps of ``args`` (baseline_3 as it ships) from the seeded
    weights and the same plan, with ``train.pallas_augment`` on and off:
    each batch's x within 1e-5 and y bit-equal, each step's loss within
    1e-5."""
    import torch

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.augment import augment
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.data import cached_exec, pipeline, tasks
    from cl_tpu_torch.data.device_cache import DeviceDatasetCache
    from cl_tpu_torch.methods import ewc as ewc_lib

    cfgs = {on: parse_overrides([*args, f"train.pallas_augment={on}"])
            for on in ("true", "false")}
    cfg = cfgs["false"]
    d = cfg.data
    cache = DeviceDatasetCache(pipeline.make_datasets(cfg, 0)[0], cuda)
    plan = cached_exec.build_plan(cache.n, batch_size=d.batch_size, epoch=0,
                                  seed=d.shuffle_seed, shuffle=True, flip_prob=d.flip_prob,
                                  device=cuda)
    valid = torch.from_numpy(tasks.valid_class_mask(
        d.num_classes, tasks.seen_classes(cfg.classes_per_task, 0))).to(cuda)
    x_err, y_same = 0.0, True
    for s in range(3):
        b = cached_exec.gather_batch(cache.images, cache.masks, plan, s)
        kw = dict(out_size=d.image_size, mean=d.mean, std=d.std)
        x1, y1 = augment(*b, use_kernels=True, **kw)
        x0, y0 = augment(*b, **kw)
        x_err = max(x_err, (x1 - x0).abs().max().item())
        y_same = y_same and torch.equal(y1, y0)
    losses = {}
    for on, c in cfgs.items():
        model = tl.init_state(c, tl.build_model(c), cuda)  # seeded: the same weights
        ewc = ewc_lib.make_ewc_state(model, mode=c.method.ewc_mode, max_tasks=1)
        step = tl.make_train_step(c, model, tl.build_optimizer(c, model), cuda, ewc=ewc)
        losses[on] = [step(cached_exec.gather_batch(cache.images, cache.masks, plan, s),
                           valid)["loss"].item() for s in range(3)]
    l_err = max(abs(a - b) for a, b in zip(losses["true"], losses["false"]))
    print(f"  {' '.join(args)}, 3 steps with pallas_augment on / off: x max abs err {x_err:.3g} "
          f"(tol 1e-5), y bit-equal {y_same}; losses {losses['true']} / {losses['false']}, "
          f"max diff {l_err:.3g} (tol 1e-5)")
    need(x_err <= 1e-5 and y_same and l_err <= 1e-5, "pallas_augment on / off agree")


def random_stats(model, seed):
    """Seeded running statistics, as a trained model has (the Fisher runs
    in eval mode; ``tests/test_torch_ewc.py`` does the same)."""
    import torch

    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32) + 0.5))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1))


def fisher_card_vs_cpu(cuda):
    """``run_fisher_pass`` over the train cache (the plan-driven path) at
    128², base 32, depth 4 (3 packed levels), f32, EWC, from the seeded
    weights with seeded running statistics, on the card and on the CPU,
    held against the float64 Fisher of the same batches (the standard body
    in float64 on the CPU): the card's within 2e-4 of each leaf's norm (the
    Fisher's conditioning, ``tests/test_torch_ewc.py``); through the augment
    kernels against without them, the same bound, #15/#16 launched once per
    Fisher batch. The card against the CPU is printed, not held to 2e-4:
    at this depth the CPU's own f32 Fisher is that far from float64 (its
    convolutions with oneDNN and without, both printed), further than the
    card's, so the CPU is the worse reference of the two."""
    import torch

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.augment import augment
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.data import cached_exec, pipeline, tasks
    from cl_tpu_torch.data.device_cache import DeviceDatasetCache
    from cl_tpu_torch.interop import export_jax_variables, load_jax_variables
    from cl_tpu_torch.methods import ewc as ewc_lib
    from cl_tpu_torch.models.unet import UNet

    args = ["preset=baseline_1", "model.packed_min_size=0", "data.num_classes=3",
            "train.num_tasks=2", "method.methods=ewc", "data.dataset=synthetic_native",
            "data.device_cache=true", "data.train_images_per_task=16"]
    cpu = torch.device("cpu")
    out, variables = {}, None
    for name, dev, aug, onednn in (("cpu", cpu, "false", False), ("cpu_onednn", cpu, "false", True),
                                   ("card", cuda, "false", True), ("card_aug", cuda, "true", True)):
        cfg = parse_overrides(args + [f"train.pallas_augment={aug}"])
        model = tl.init_state(cfg, tl.build_model(cfg), dev)
        need(model.packed_levels(128, 128) == 3, "3 packed levels at 128², base 32, depth 4")
        random_stats(model, 3)
        if variables is None:
            variables = export_jax_variables(model)
        seen = tasks.valid_class_mask(cfg.data.num_classes,
                                      tasks.seen_classes(cfg.classes_per_task, 0))
        cache = DeviceDatasetCache(pipeline.make_datasets(cfg, 0)[0], dev)
        torch.cuda.synchronize()
        reset_counts()
        with torch.backends.mkldnn.flags(enabled=onednn):
            fisher = tl.run_fisher_pass(cfg, tl.make_fisher_step(cfg, model, dev), model, 0,
                                        seen, dev, cache=cache)
        out[name] = fisher.cpu().double()
        counts = read_counts()
        sizes = [p.numel() for p in model.parameters()]
    # float64: the same batches through the standard body on the CPU
    nf = min(cfg.data.train_images_per_task // cfg.data.batch_size,
             cfg.method.ewc_fisher_batches)
    m64 = UNet(cfg.data.num_classes, 32, 4, dtype=torch.float64)
    load_jax_variables(m64, variables)
    m64 = m64.double()
    cache = DeviceDatasetCache(pipeline.make_datasets(cfg, 0)[0], cpu)
    plan = cached_exec.build_plan(cache.n, batch_size=cfg.data.batch_size, epoch=10_000,
                                  seed=cfg.data.shuffle_seed, shuffle=True,
                                  flip_prob=cfg.data.flip_prob, device=cpu)
    f64 = 0
    for s in range(nf):
        x, y = augment(*cached_exec.gather_batch(cache.images, cache.masks, plan, s),
                       out_size=cfg.data.image_size, mean=cfg.data.mean, std=cfg.data.std)
        f64 = f64 + ewc_lib.fisher_batch_grads(m64, x.double(), y, torch.from_numpy(seen)) ** 2
    out["f64"] = f64 / nf

    def worst(a, b):
        errs = []
        for u, v in zip(out[a].split(sizes), out[b].split(sizes)):
            norm = v.norm().item()
            errs.append((u - v).norm().item() / norm if norm > 0 else
                        float((u - v).abs().max().item() > 0) * 1e9)
        return max(errs)

    w = {k: worst(*k.split(" vs ")) for k in ("card vs cpu", "card vs f64", "cpu vs f64",
                                             "cpu_onednn vs f64", "card vs cpu_onednn",
                                             "card_aug vs card")}
    print(f"  Fisher pass over the train cache, 128² f32, {nf} batches, worst leaf of its norm: "
          + ", ".join(f"{k} {v:.3g}" for k, v in w.items())
          + f" (tol 2e-4 for card vs f64 and card_aug vs card); launches with the "
          f"augment kernels {counts['augment_image']} / {counts['augment_mask']} / ewc_sq_acc "
          f"{counts['ewc_sq_acc']}")
    need(out["f64"].norm() > 0 and all(w[k] <= 2e-4 for k in ("card vs f64", "card_aug vs card")),
         "the card's Fisher")
    need(counts["augment_image"] == counts["augment_mask"] == counts["ewc_sq_acc"] == nf,
         "the Fisher pass's augment launches")


def eval_pass(cfg, model, device):
    """``evaluate_task`` of task 0 through ``make_eval_step``; returns the
    result, the launch counts of exactly this pass and its forwards."""
    import torch

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.data import tasks

    step = tl.make_eval_step(cfg, model, device)
    seen = tasks.valid_class_mask(cfg.data.num_classes,
                                  tasks.seen_classes(cfg.classes_per_task, 0))
    torch.cuda.synchronize()
    reset_counts()
    res = tl.evaluate_task(cfg, step, 0, seen, device)
    torch.cuda.synchronize()
    forwards = -(-cfg.data.val_images_per_task // cfg.data.batch_size)
    return res, read_counts(), forwards


def timed_eval(cfg, model, device, n_warm=2, n_timed=10):
    """Eval steps on one prebuilt batch: (images/s, peak MiB)."""
    import torch

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.data import pipeline

    step = tl.make_eval_step(cfg, model, device)
    batch = pipeline.put_batch(next(iter(pipeline.val_batches(cfg, 0))), device)
    valid = torch.ones(cfg.data.num_classes, dtype=torch.bool, device=device)
    conf = torch.zeros(cfg.data.num_classes, cfg.data.num_classes, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n_warm):
        conf = step(conf, batch, valid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        conf = step(conf, batch, valid)
    torch.cuda.synchronize()
    ips = cfg.data.batch_size * n_timed / (time.perf_counter() - t0)
    return ips, torch.cuda.max_memory_allocated() / 2 ** 20


def packed_agrees_with_cpu():
    """The packed body on the card (kernels) against the port's packed body
    on the CPU (plain versions), 128², base 32, depth 4 (prefix 3), f32, from
    the same weights with random running statistics: eval logits within 1e-4, then
    one train-mode forward without grad, logits within 1e-4 and running
    statistics within 1e-5."""
    import torch

    from cl_tpu_torch.interop import export_jax_variables, load_jax_variables
    from cl_tpu_torch.models.unet import UNet, init_weights

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 128, 128, 3).astype(np.float32))
    seeded = UNet(3, 32, 4)
    init_weights(seeded, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, t in seeded.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32) + 0.5))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1))
    variables = export_jax_variables(seeded)
    out = {}
    for dev in ("cpu", "cuda"):
        model = UNet(3, 32, 4, packed=True).to(device=dev, memory_format=torch.channels_last)
        load_jax_variables(model, variables)
        need(model.packed_levels(128, 128) == 3, "prefix 3 at 128², base 32, depth 4")
        with torch.no_grad():
            ev = model.eval()(x.to(dev)).cpu()
            tr = model.train()(x.to(dev)).cpu()
        stats = {k: v.cpu() for k, v in model.state_dict().items() if "running" in k}
        out[dev] = (ev, tr, stats)
    (ec, tc, sc), (eg, tg, sg) = out["cpu"], out["cuda"]
    e_err = (eg - ec).abs().max().item()
    t_err = (tg - tc).abs().max().item()
    s_ok = all(torch.allclose(sg[k], sc[k], rtol=1e-5, atol=1e-5) for k in sc)
    s_err = max((sg[k] - sc[k]).abs().max().item() for k in sc)
    print(f"  card vs CPU, 128² f32 packed: eval logits max abs err {e_err:.3g}, "
          f"train-mode logits {t_err:.3g} (tol 1e-4); running stats {s_err:.3g} "
          f"(tol 1e-5 abs + rel)")
    need(e_err <= 1e-4 and t_err <= 1e-4 and s_ok, "packed body, card vs CPU")


# ---------------------------------------------------------------------------
# Phase 5r: step determinism, resume, eval / predict, the sampled Fisher
# ---------------------------------------------------------------------------


def methods_want(cfg, start=0, stop=None) -> dict:
    """The methods kernels' launches of tasks [start, stop) of a ``train()``
    of ``cfg``: the penalty and its gradient at every step (weight 0 on task
    0, as in ``cl_tpu``), the Fisher accumulation once per Fisher batch
    after every task but the last, the gather twice per step from task 1
    on (task 0 widens its batch with its own rows)."""
    T = cfg.train.num_tasks
    stop = T if stop is None else stop
    per_task = cfg.data.train_images_per_task // cfg.data.batch_size * cfg.train.epochs_per_task
    nf = min(cfg.data.train_images_per_task // cfg.data.batch_size,
             cfg.method.ewc_fisher_batches)
    tasks = range(start, stop)
    return {"ewc_penalty": len(tasks) * per_task, "ewc_grad": len(tasks) * per_task,
            "ewc_sq_acc": sum(t < T - 1 for t in tasks) * nf,
            "replay_gather": 2 * sum(t >= 1 for t in tasks) * per_task
            if "replay" in cfg.method.methods else 0}


def state_leaves(model, opt) -> dict:
    """Every param and BatchNorm buffer of ``model`` and every tensor of
    ``opt``'s state (Adam's moments and step), cloned, by name."""
    out = {f"model{'/' + k}": v.detach().clone() for k, v in model.state_dict().items()}
    names = {id(p): n for n, p in model.named_parameters()}
    for p, st in opt.state.items():
        for k, v in st.items():
            out[f"adam/{names[id(p)]}/{k}"] = v.detach().clone()
    return out


def leaf_gaps(a: dict, b: dict) -> dict:
    """max |a − b| of each tensor leaf (float64), by name; a Python value
    (a checkpoint's ``n_tasks``, the optimizer's settings) 0 where equal,
    inf where not."""
    import torch

    need(a.keys() == b.keys(), "the same leaves on both sides")
    out = {}
    for k, x in a.items():
        if isinstance(x, torch.Tensor):
            d = x.double() - b[k].double().to(x.device)
            out[k] = float(d.abs().max()) if d.numel() else 0.0
        else:
            out[k] = 0.0 if x == b[k] else float("inf")
    return out


def step_repeats(cfg, device, n_steps=3):
    """5r-a: does a step repeat bit for bit? One step from the seeded init
    (Adam's state exists), then two deep copies of the model and of Adam's
    state, ``n_steps`` steps on the same batch from each: each leaf's max
    |diff|. Where they differ, the leaves after one step name the layers,
    and the same steps under ``torch.backends.cudnn.deterministic`` say
    whether cuDNN's algorithms are the cause. Returns (bit-equal, gaps)."""
    import copy

    import torch

    from cl_tpu_torch import train as tl

    model, opt, step, batch, valid = build_step(cfg, device)
    step(batch, valid)

    def copies():
        out = []
        for _ in range(2):
            m = copy.deepcopy(model)
            o = tl.build_optimizer(cfg, m)
            o.load_state_dict(copy.deepcopy(opt.state_dict()))
            out.append((m, o, tl.make_train_step(cfg, m, o, device)))
        return out

    def run(n, deterministic=False):
        torch.backends.cudnn.deterministic = deterministic
        try:
            leaves = []
            for m, o, s in copies():
                for _ in range(n):
                    s(batch, valid)
                torch.cuda.synchronize()
                leaves.append(state_leaves(m, o))
                del m, o, s
            return leaf_gaps(*leaves)
        finally:
            torch.backends.cudnn.deterministic = False

    gaps = run(n_steps)
    differ = {k: v for k, v in gaps.items() if v != 0}
    print(f"  {n_steps} steps from two copies, {len(gaps)} leaves (params, BN statistics, Adam's "
          f"moments and step): {len(differ)} differ; max |diff| by leaf: "
          + json.dumps({k: v for k, v in gaps.items()}))
    if differ:
        first = {k: v for k, v in run(1).items() if v != 0}
        by_level = {}
        for k in first:  # "model/enc3.conv0.weight", "adam/enc3.conv0.weight/exp_avg"
            level = k.split("/")[1].split(".")[0]
            by_level[level] = by_level.get(level, 0) + 1
        print(f"  after one step, {len(first)} leaves differ, by level: {by_level}; "
              f"{sorted(k for k in first if k.startswith('model/'))}")
        det = {k: v for k, v in run(n_steps, deterministic=True).items() if v != 0}
        print(f"  under torch.backends.cudnn.deterministic=True: {len(det)} leaves differ")
    # the cost of cuDNN's deterministic algorithms: five pairs of 10 steps
    # in turns, the order flipped every pair
    ips = {False: [], True: []}
    try:
        for i in range(5):
            for det in ((False, True) if i % 2 == 0 else (True, False)):
                torch.backends.cudnn.deterministic = det
                step(batch, valid)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    step(batch, valid)
                torch.cuda.synchronize()
                ips[det].append(cfg.data.batch_size * 10 / (time.perf_counter() - t0))
    finally:
        torch.backends.cudnn.deterministic = False
    ratios = [a / b for a, b in zip(ips[True], ips[False])]
    print(f"  images/s, five pairs of 10 steps: default {[round(v, 2) for v in ips[False]]}, "
          f"cudnn.deterministic {[round(v, 2) for v in ips[True]]}; deterministic / default "
          f"{[round(r, 4) for r in ratios]}, median {float(np.median(ratios)):.4f}")
    del model, opt, step
    return not differ, gaps


def checkpoint_leaves(path) -> dict:
    """Every tensor of a ``state.pt`` by its path in the tree (and the
    Python values beside them)."""
    import torch

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{prefix}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, f"{prefix}[{i}]")
        else:
            yield prefix, tree

    return dict(walk(torch.load(path, map_location="cpu", weights_only=True), ""))


def cli_run(args, what):
    """``python3 -m cl_tpu_torch.cli`` with ``args`` in a process of its own
    (a crash loses the process; its resume starts a new one): (exit code,
    the last lines of its output)."""
    out = subprocess.run([sys.executable, "-m", "cl_tpu_torch.cli", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    tail = "\n".join((out.stdout + out.stderr).strip().splitlines()[-3:])
    print(f"    {what}: exit {out.returncode}")
    return out.returncode, tail


def resume_at_full_width(args, bitwise, root, cli=True, twice=True):
    """5r-b: two uninterrupted ``train()`` runs (a, b), a run killed after
    task 0 and its resume in this process (r), and the same through the
    CLI, each in a new process (c), each pair with its own
    ``train.checkpoint_dir`` under ``root``. The last task's ``state.pt``
    compared leaf by leaf (params, BN buffers, Adam's moments and step,
    EWC's anchor, Fisher and weight, the teacher) and the mIoU matrix:
    bit-equal where 5r-a found the step bit-repeatable (``bitwise``), else
    no leaf further from run a than twice the largest gap between a and b.
    ``cli`` False leaves out the CLI's pair; ``twice`` False, where the
    step is bit-repeatable, leaves out run b (no tolerance to measure).
    Returns (the resumed run's config, run a's report, the gate's mIoU
    tolerance)."""
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides

    def with_dir(k, *extra):
        return args + [f"train.checkpoint_dir={os.path.join(root, k)}", *extra]

    cfg_a = parse_overrides(with_dir("a"))
    T = cfg_a.train.num_tasks
    mats, counts = {}, {}
    twice = twice or not bitwise
    for k in ("a", "b") if twice else ("a",):
        t0 = time.perf_counter()
        reset_counts()
        mats[k] = np.asarray(tl.train(parse_overrides(with_dir(k)))["miou_matrix"], float)
        counts[k] = read_counts()
        print(f"  uninterrupted run {k}: {time.perf_counter() - t0:.1f} s, mIoU matrix "
              f"{mats[k].tolist()}")
    reset_counts()
    try:
        tl.train(parse_overrides(with_dir("r", "train.fail_after_task=0")))
        need(False, "train.fail_after_task=0 raises")
    except RuntimeError as e:
        need("fault injection" in str(e), f"the fault injection raised ({e})")
    counts["fail"] = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    report_r = tl.train(parse_overrides(with_dir("r", "train.resume=true")))
    mats["r"] = np.asarray(report_r["miou_matrix"], float)
    counts["r"] = read_counts()
    print(f"  killed after task 0, resumed in this process: {time.perf_counter() - t0:.1f} s, "
          f"mIoU matrix {mats['r'].tolist()}")
    for k, (start, stop) in (("a", (0, T)), ("b", (0, T)), ("fail", (0, 1)), ("r", (1, T))):
        if k not in counts:
            continue
        want = methods_want(cfg_a, start, stop)
        print(f"    methods launches, run {k} (tasks {start}..{stop - 1}): "
              f"{ {n: counts[k][n] for n in want} }")
        for n, v in want.items():
            need(counts[k][n] == v, f"{n} launches {counts[k][n]} == {v} (5r-b run {k})")
    if cli:
        t0 = time.perf_counter()
        rc, tail = cli_run(with_dir("c", "train.fail_after_task=0"),
                           "the CLI killed after task 0, a process of its own")
        need(rc != 0 and "fault injection" in tail, f"the CLI's run died of the fault ({tail})")
        rc, tail = cli_run(with_dir("c", "train.resume=true"), "the CLI resumed, a new process")
        need(rc == 0, f"the CLI's resume ({tail})")
        with open(os.path.join(root, "c", f"task_{T - 1}", "meta.json")) as f:
            mats["c"] = np.asarray(json.load(f)["miou_matrix"], float)
        print(f"  the CLI's pair: {time.perf_counter() - t0:.1f} s, mIoU matrix "
              f"{mats['c'].tolist()}")
    last = f"task_{T - 1}/state.pt"
    leaves = {k: checkpoint_leaves(os.path.join(root, k, last)) for k in mats}
    gaps = {k: leaf_gaps(leaves[k], leaves["a"]) for k in mats if k != "a"}
    low = np.tril_indices(T)
    mgaps = {k: float(np.abs(mats[k] - mats["a"])[low].max()) for k in gaps}
    kinds = sorted({k.split("/")[1] for k in leaves["a"]})
    print(f"  the last state.pt, {len(leaves['a'])} leaves ({', '.join(kinds)}), against run a: "
          + "; ".join(f"{name} {sum(v != 0 for v in gaps[k].values())} leaves differ, largest "
                      f"max |diff| {max(gaps[k].values()):.3e}, mIoU gap {mgaps[k]:.3e}"
                      for k, name in (("b", "run b"), ("r", "resumed here"),
                                      ("c", "the CLI's resume")) if k in gaps))
    need({"model", "optimizer", "ewc", "lwf"} <= set(kinds), "every part of the state compared")
    tol = 0.0 if bitwise else 2 * mgaps["b"]
    for k in ("r", "c") if cli else ("r",):
        if bitwise:
            need(all(v == 0 for v in gaps[k].values()) and mgaps[k] == 0,
                 f"run {k} equals the uninterrupted run bit for bit (5r-a: bit-repeatable)")
        else:
            bound = 2 * max(gaps["b"].values())
            worst = max(gaps[k], key=gaps[k].get)
            need(gaps[k][worst] <= bound,
                 f"run {k}'s leaf {worst} within twice the uninterrupted runs' largest gap "
                 f"({gaps[k][worst]:.3e} <= {bound:.3e})")
            need(mgaps[k] <= tol, f"run {k}'s mIoU within twice a and b's gap ({mgaps[k]})")
    return parse_overrides(with_dir("r")), {"miou_matrix": mats["a"]}, tol


def eval_predict_from_checkpoint(cfg, report, tol):
    """5r-c: the CLI's ``eval`` and ``predict`` modes from 5r-b's resumed
    checkpoint on the card. ``eval``'s per-task mIoU equals the last row of
    the uninterrupted run's matrix (within ``tol``: 0 where a step repeats
    bit for bit); the confusion matrix of ``predict``'s masks against the
    val masks equals ``evaluate``'s, entry for entry; the packed forward
    kernels launched once per forward each."""
    import torch

    from cl_tpu_torch import cli, predict
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.data import pipeline
    from cl_tpu_torch.kernels import augment as aug_kernels

    T, C = cfg.train.num_tasks, cfg.data.num_classes
    forwards = -(-cfg.data.val_images_per_task // cfg.data.batch_size)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out_e = cli.run_eval(cfg)
    torch.cuda.synchronize()
    counts_e, wall_e = read_counts(), time.perf_counter() - t0
    row = np.asarray(report["miou_matrix"], float)[T - 1]
    gap = float(np.abs(np.asarray(out_e["per_task_miou"]) - row).max())
    print(f"  eval: {out_e} in {wall_e:.1f} s; the uninterrupted run's last row {row.tolist()}, "
          f"gap {gap:.3e}")
    need(out_e["task"] == T - 1 and gap <= tol, f"eval equals the run's last mIoU row ({gap})")
    reset_counts()
    t0 = time.perf_counter()
    out_p = cli.run_predict(cfg)
    torch.cuda.synchronize()
    counts_p, wall_p = read_counts(), time.perf_counter() - t0
    need(os.path.basename(out_p["out"]) == f"task{T - 1}_val_masks.npy", "predict's file name")
    masks = np.load(out_p["out"])
    _, val_ds = pipeline.make_datasets(cfg, T - 1)
    src = torch.from_numpy(np.stack([val_ds[i][1] for i in range(len(val_ds))]).astype(np.uint8))
    y = aug_kernels.mask_plain(src, torch.zeros(len(val_ds), dtype=torch.bool),
                               out_size=cfg.data.image_size).numpy()
    keep = y != cfg.data.ignore_index
    conf = np.bincount(y[keep].astype(np.int64) * C + masks[keep], minlength=C * C).reshape(C, C)
    model, _ = predict.restore_for_inference(cfg)
    want = tl.evaluate(cfg, model, T - 1, seen_task=T - 1)["confusion"]
    print(f"  predict: {out_p['n_images']} masks {masks.shape} {masks.dtype}, classes "
          f"{out_p['classes_present']}, {wall_p:.1f} s; confusion of the masks against the val "
          f"masks == evaluate's: {np.array_equal(conf, want)} ({int(conf.sum())} pixels)")
    need(masks.shape == (len(val_ds), cfg.data.image_size, cfg.data.image_size)
         and masks.dtype == np.uint8, "predict's masks")
    need(np.array_equal(conf, want), "predict's confusion matrix equals evaluate's")
    for label, counts, n in (("eval", counts_e, T * forwards), ("predict", counts_p, forwards)):
        print(f"    {label} launches: { {k: counts[k] for k in PER_FORWARD} } for {n} forwards")
        for k in PER_STEP:
            want_n = n * PER_FORWARD.get(k, 0)  # no backward kernel in an eval
            need(counts[k] == want_n, f"{k} launches {counts[k]} == {want_n} ({label})")
    return counts_e, counts_p


def sampled_draw_checks(device, seen_classes=11, C=21):
    """5r-d: the sampled Fisher's draw at the full-width logits shape (8 x
    512² x 21, f32): no masked class drawn, ignore pixels keep 255, one
    seed draws the same labels twice, and 2¹⁶ draws at four fixed pixels
    fit their softmax (χ², p > 1e-3 each). Returns the draw's ms."""
    import torch
    from scipy.stats import chisquare

    from cl_tpu_torch.methods import ewc

    g = torch.Generator(device=device).manual_seed(0)
    logits = torch.randn((8, 512, 512, C), generator=g, device=device) * 2
    y = torch.randint(0, seen_classes, (8, 512, 512), generator=g, device=device,
                      dtype=torch.int32)
    y[torch.rand((8, 512, 512), generator=g, device=device) < 0.1] = 255
    valid = torch.zeros(C, dtype=torch.bool, device=device)
    valid[:seen_classes] = True

    def draw(seed, lg=logits, yy=y):
        return ewc.sample_fisher_labels(lg, yy, valid,
                                        torch.Generator(device=device).manual_seed(seed))

    a, b = draw(5), draw(5)
    ms = time_ms(lambda: draw(5), reps=10, queued=False)
    ign = y == 255
    drawn_masked = int((a[~ign] >= seen_classes).sum())
    print(f"  draw at {tuple(logits.shape)} f32: {ms:.3f} ms; masked classes drawn "
          f"{drawn_masked}; ignore pixels kept {bool((a[ign] == 255).all())} "
          f"({int(ign.sum())}); same seed equal {bool(torch.equal(a, b))}; another seed differs "
          f"at {float((a != draw(6)).float().mean()):.4f} of pixels")
    need(drawn_masked == 0, "no masked class drawn")
    need(bool((a[ign] == 255).all()), "ignore pixels keep 255")
    need(bool(torch.equal(a, b)), "two draws from one seed are equal")
    n = 1 << 16
    pix = logits[0, 0, :4]
    got = draw(1, pix[None, None].expand(n, 1, 4, C).contiguous(),
               torch.zeros((n, 1, 4), dtype=torch.int32, device=device))
    p = torch.softmax(torch.where(valid, pix.double(), float("-inf")), dim=-1).cpu().numpy()
    v = valid.cpu().numpy()
    pvals = []
    for j in range(4):
        counts = np.bincount(got[:, 0, j].cpu().numpy(), minlength=C)
        need(counts[~v].sum() == 0, "no masked class in the χ² draws")
        pvals.append(float(chisquare(counts[v], n * p[j][v]).pvalue))
    print(f"  χ² of 2^16 draws at four pixels against their softmax: p {pvals}")
    need(min(pvals) > 1e-3, f"the draws fit their softmax (p {pvals})")
    return ms


def phase_5r(cfg_h, b5_args, small):
    """Phase 5r: 5r-a on the headline step ``cfg_h``; 5r-b and 5r-c on the
    baseline_5 cut ``b5_args``, 5r-d on baseline_3, both with ``small``'s
    images a task (phase 5m's ``train()`` runs')."""
    import shutil
    import tempfile

    import torch

    cuda = torch.device("cuda")
    print("[5r] the run's life cycle at full width: step determinism, resume, eval and "
          "predict from a checkpoint, the sampled Fisher")
    t_r = time.perf_counter()
    print("  5r-a: does the headline step (phase 5h's config) repeat bit for bit?")
    bitwise, _ = step_repeats(cfg_h, cuda)
    print(f"  5r-a: the headline step {'repeats' if bitwise else 'does NOT repeat'} bit for bit "
          f"on this card")
    # the same step in f32 (baseline_3's and baseline_4's dtype): the deep
    # region's cuDNN convs take other algorithms in f32
    cfg_f = dataclasses.replace(cfg_h, train=dataclasses.replace(cfg_h.train,
                                                                 compute_dtype="float32"))
    print("  5r-a, the same step in f32:")
    f32_bitwise, _ = step_repeats(cfg_f, cuda)
    print(f"  5r-a: in f32 the step {'repeats' if f32_bitwise else 'does NOT repeat'} bit for bit")
    root_r = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        print("  5r-b: fail after task 0 and resume, the baseline_5 cut, 3 tasks, 16 + 8 images "
              "a task, the device cache")
        cfg_r, report_ra, tol_r = resume_at_full_width(
            b5_args + small + ["train.num_tasks=3", "train.epochs_per_task=1"], bitwise, root_r)
        print("  5r-c: the CLI's eval and predict from 5r-b's checkpoint")
        eval_predict_from_checkpoint(cfg_r, report_ra, tol_r)
        print("  5r-d: the sampled Fisher (method.ewc_fisher_kind=true) on baseline_3")
        data_path_train("5r-d baseline_3 with the sampled Fisher, 16 + 8 images a task",
                        ["preset=baseline_3", "method.ewc_fisher_kind=true"] + small
                        + [f"train.checkpoint_dir={os.path.join(root_r, 'fisher')}"])
        fisher = checkpoint_leaves(os.path.join(root_r, "fisher", "task_0", "state.pt"))[
            "/ewc/fisher"]
        print(f"    the sampled Fisher after task 0: {fisher.numel()} entries, finite "
              f"{bool(torch.isfinite(fisher).all())}, max {float(fisher.max()):.4e}, mean "
              f"{float(fisher.mean()):.4e}")
        need(bool(torch.isfinite(fisher).all()) and bool((fisher >= 0).all())
             and bool((fisher > 0).any()), "a finite, non-negative, nonzero sampled Fisher")
        sampled_draw_checks(cuda)
    finally:
        shutil.rmtree(root_r, ignore_errors=True)
    print(f"  phase 5r: {time.perf_counter() - t_r:.1f} s")
    return bitwise


def remat_run(cfg, device, n_steps=3):
    """``n_steps`` of ``cfg``'s step on one prebuilt batch from the seeded
    init: (losses, launch counts, peak MiB over the steps, every state
    leaf)."""
    import torch

    model, opt, step, batch, valid = build_step(cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses = [step(batch, valid)["loss"] for _ in range(n_steps)]
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    leaves = state_leaves(model, opt)
    del model, opt, step
    return [v.item() for v in losses], counts, peak, leaves


def phase_5x(cfg_h, headline_step):
    """Phase 5x: per-level rematerialization (``train.remat``) on the
    headline step: bit-equal to ``remat=false`` in bf16 after 3 steps with
    a lower peak and the recomputed forwards counted; in f32 (SGD) within
    twice the largest gap among three ``remat=false`` runs (f32 does not
    repeat, 5r-a)."""
    import torch

    cuda = torch.device("cuda")
    print("[5x] per-level rematerialization (train.remat) on the headline step")
    t_x = time.perf_counter()
    on = dataclasses.replace(cfg_h, train=dataclasses.replace(cfg_h.train, remat=True))
    loss0, counts0, peak0, leaves0 = remat_run(cfg_h, cuda)
    loss1, counts1, peak1, leaves1 = remat_run(on, cuda)
    gaps = leaf_gaps(leaves0, leaves1)
    differ = [k for k, v in gaps.items() if v != 0]
    print(f"  bf16, 3 steps: losses remat=false {loss0}, remat=true {loss1}; {len(gaps)} leaves "
          f"(params, BN statistics, Adam's moments and step), {len(differ)} differ {differ[:8]}")
    print(f"  peak MiB over the steps: remat=false {peak0:.0f}, remat=true {peak1:.0f} "
          f"({peak1 / peak0:.4f})")
    need(loss0 == loss1 and not differ, "remat=true is bit-equal to remat=false (bf16)")
    need(peak1 < peak0, "remat lowers the peak")
    # per step: the headline step's launches, and the rematerialized levels'
    # forward kernels once more (#32 in every packed conv, #25 in each
    # decoder level's split conv); the pool, bn_relu, up-conv and head run
    # outside the levels
    want = dict(headline_step)
    for k in ("conv3x3_bn_fwd", "add_stats_fwd"):
        want[k] += PER_FORWARD[k]
    print(f"  launches under remat: {counts1}")
    for k, n in want.items():
        need(counts0[k] == 3 * headline_step[k], f"{k} launches == 3 x {headline_step[k]}")
        need(counts1[k] == 3 * n, f"{k} launches == 3 x {n} under remat")
    # f32 with SGD: the card's f32 step does not repeat (5r-a), and Adam's
    # first steps turn a gradient's noise into a step of ±lr, so the gaps
    # are read on SGD's updates, which follow the gradients' own noise
    cfg_f = dataclasses.replace(cfg_h, train=dataclasses.replace(
        cfg_h.train, compute_dtype="float32", optimizer="sgd", lr=0.05))
    on_f = dataclasses.replace(cfg_f, train=dataclasses.replace(cfg_f.train, remat=True))
    off = [remat_run(cfg_f, cuda) for _ in range(3)]
    _, _, fpeak_c, fc = remat_run(on_f, cuda)
    ref = max(max(leaf_gaps(off[i][3], off[j][3]).values())
              for i, j in ((0, 1), (0, 2), (1, 2)))
    got = max(max(leaf_gaps(o[3], fc).values()) for o in off)
    print(f"  f32 with SGD, 3 steps: largest leaf gap among three remat=false runs {ref:.3e}, "
          f"remat=true against them {got:.3e}; peak MiB {off[0][2]:.0f} / {fpeak_c:.0f}")
    need(got <= 2 * ref, "f32 remat within twice the gap among remat=false runs")
    print(f"  phase 5x: {time.perf_counter() - t_x:.1f} s")


def phase_5w():
    """Phase 5w: data parallelism on the one card (``cl_tpu_torch.dp_cards``).
    Two ranks, separate processes on ``cuda:0`` in a gloo group (NCCL
    refuses two ranks on one card), take one SGD step of the headline
    config on a global batch of 8 (bf16, and f32), and of the baseline_5 cut
    on 16 + 2, each against the one-process step on the same global batch
    (``dp_cards.check``: the loss within rtol 1e-5, replicas bit-equal, a
    rank's launches equal one process's, each update within 1e-2 of its
    norm plus one ulp or twice the gap of the same step with the batch's
    halves swapped, where larger); then one NCCL group of one rank takes the
    headline step, so NCCL's set-up and collectives run on the card."""
    import tempfile

    from cl_tpu_torch import dp_cards, sharding

    print("[5w] data parallelism on the one card: two ranks over gloo, one NCCL rank")
    t_w = time.perf_counter()
    head = dp_cards.HEADLINE + dp_cards.SGD
    store = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    for i, (label, args) in enumerate((
            ("headline, global batch 8", head),
            ("headline in f32, global batch 8", head + ["train.compute_dtype=float32"]),
            ("baseline_5 cut, global batch 16 + 2",
             dp_cards.B5_CUT + dp_cards.SGD + ["method.replay_batch=2"]))):
        res = dp_cards.check(label, args, world=2, backend="gloo",
                             init_method=f"file://{store}/store{i}", devices=["cuda:0"] * 2)
        if "f32" in label:
            need(res["worst"] <= 1e-2, "f32 DP updates within 1e-2 of their norms")
    dp_cards.check("headline, global batch 8", head, world=1, backend="nccl",
                   init_method=f"tcp://localhost:{sharding.free_port()}", devices=["cuda:0"])
    print(f"  phase 5w: {time.perf_counter() - t_w:.1f} s")


def baseline_5_as_it_ships():
    """``preset=baseline_5`` with nothing changed through ``train()`` on the
    one card (remat on, 64 + 8 images a step, 5 tasks of 256 + 64 images,
    2 epochs, the device cache and the device replay buffer), then its
    methods step with remat on and off: the peak of one step from the
    built state, and images/s of 3 more."""
    import torch

    from cl_tpu_torch.config import parse_overrides

    cuda = torch.device("cuda")
    t_b = time.perf_counter()
    report = methods_train("baseline_5 as it ships", ["preset=baseline_5"])
    print(f"  baseline_5 as it ships: {report.get('images_per_sec_per_chip')} images/s per "
          f"card, eval {report.get('eval_images_per_sec_per_chip')} images/s, mean "
          f"forgetting {report.get('mean_forgetting')}, final per-task mIoU "
          f"{report.get('final_per_task_miou')}; {time.perf_counter() - t_b:.1f} s")
    peaks, ips = {}, {}
    for remat in (True, False):
        cfg = parse_overrides(["preset=baseline_5", f"train.remat={str(remat).lower()}"])
        model, opt, step, batch, valid = build_step(cfg, cuda)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = step(batch, valid)["loss"].item()
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 20
        need(np.isfinite(loss), f"finite loss (baseline_5, remat={remat})")
        t0 = time.perf_counter()
        for _ in range(3):
            step(batch, valid)
        torch.cuda.synchronize()
        ips[remat] = 3 * (cfg.data.batch_size + cfg.method.replay_batch) / (
            time.perf_counter() - t0)
        del model, opt, step, batch
        torch.cuda.empty_cache()
    print(f"  the methods step at 64 + 8 images: peak of one step {peaks[True]:.0f} MiB with "
          f"remat, {peaks[False]:.0f} MiB without ({peaks[True] / peaks[False]:.4f}); "
          f"images/s of 3 steps {ips[True]:.2f} with, {ips[False]:.2f} without "
          f"({ips[True] / ips[False]:.4f})")
    need(peaks[True] < peaks[False], "remat lowers baseline_5's peak")
    return report, peaks


# ---------------------------------------------------------------------------
# Phases 5n, 5e, 5y: GroupNorm, grow-the-head, the profiler's trace
# ---------------------------------------------------------------------------

GN_FULL = ["preset=baseline_1", "data.image_size=512", "data.source_size=576",
           "data.num_classes=19", "train.compute_dtype=bfloat16", "model.norm=group",
           "data.dataset=synthetic", "train.data_parallel=false"]


def phase_5n(ips_f, peak_f):
    """Phase 5n: GroupNorm (``model.norm=group``) at full width. 5n-a the
    headline widths on the GroupNorm standard body (the packed body
    declines a GroupNorm model), 3 + 10 steps: #1/#2 once a step, no packed
    kernel, a falling loss, images/s and peak beside phase 5's BatchNorm
    standard body (``ips_f``, ``peak_f``); 5n-b ``model.conv_impl=auto``
    and ``=v3`` where ``standard_body_refusal`` admits them, 3 + 10 steps
    with #30/#31 counted at the GroupNorm levels, five pairs each against
    ``xla``; 5n-c one SGD step of baseline_1 (128², f32) with GroupNorm on
    the card against the CPU, and with ``model.conv_impl=v3`` (loss and
    params within 1e-4, each update within 1e-2 of its norm plus one ulp of
    the float64 step); 5n-d two gloo ranks on ``cuda:0`` against one
    process (``dp_cards.check``: replicas bit-equal, each update within
    twice the reorder gap). Returns images/s of 5n-a."""
    import tempfile

    import torch

    from cl_tpu_torch import dp_cards
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides
    from cl_tpu_torch.models import packed_gate as pg

    cuda = torch.device("cuda")
    print("[5n] GroupNorm (model.norm=group) at full width: 512², batch 8, 19 classes, bf16")
    t_n = time.perf_counter()
    cfg = parse_overrides(GN_FULL)
    need(tl.build_model(cfg).packed_levels(512, 512) == 0,
         "a GroupNorm model declines the packed body")
    counts, ips, peak, loss, first = run_steps(cfg, 3, 10, cuda, no_sync=True)
    print(f"  5n-a GroupNorm standard body, 13 steps: {ips:.2f} img/s, peak {peak:.0f} MiB, loss "
          f"{first:.4f} -> {loss:.4f}; launches { {k: v for k, v in counts.items() if v} }")
    print(f"    beside phase 5's BatchNorm standard body: {ips_f:.2f} img/s, peak {peak_f:.0f} "
          f"MiB ({ips / ips_f:.4f} of its images/s)")
    need(loss < first, "the GroupNorm training loss falls")
    need(counts["head_ce_fwd"] == 13 and counts["head_ce_bwd"] == 13,
         "head_ce launches == steps (GroupNorm)")
    need(all(counts[k] == 0 for k in PER_STEP) and counts["conv3x3_fwd"] == 0,
         "no packed or gen-3 kernel on the GroupNorm xla route")
    for impl in ("auto", "v3"):
        why = pg.standard_body_refusal(512, 32, 4, impl, "group", 2)
        if why:
            print(f"  5n-b conv_impl={impl}: refused at 512² bf16 ({why})")
            continue
        cfg_i = parse_overrides(GN_FULL + [f"model.conv_impl={impl}"])
        n = v3_convs(cfg_i)
        counts_i, ips_i, peak_i, loss_i, first_i = run_steps(cfg_i, 3, 10, cuda, no_sync=True)
        print(f"  5n-b GroupNorm conv_impl={impl}, 13 steps ({n} convs on the gen-3 conv, none "
              f"on the packed level): {ips_i:.2f} img/s, peak {peak_i:.0f} MiB, loss "
              f"{first_i:.4f} -> {loss_i:.4f}")
        need(n > 0 and loss_i < first_i, f"conv_impl={impl} routes convs and trains")
        v3_counts_ok(counts_i, f"5n-b {impl}", 13 * n, 13 * n)
        pairs, issue = alternating_pairs({impl: cfg_i, "xla": cfg}, cuda)
        ratios = [p / q for p, q in zip(pairs[impl], pairs["xla"])]
        print(f"    alternating pairs, 10 steps each, images/s: {impl} "
              f"{[round(v, 2) for v in pairs[impl]]}, xla {[round(v, 2) for v in pairs['xla']]}; "
              f"{impl} / xla {[round(r, 4) for r in ratios]}, median "
              f"{float(np.median(ratios)):.4f}; host issue {impl} {issue[impl]:.3f} ms, xla "
              f"{issue['xla']:.3f} ms")
    for extra in ([], ["model.conv_impl=v3"]):
        reset_counts()
        agree_with_cpu(["preset=baseline_1", "model.norm=group"] + extra,
                       "5n-c GroupNorm baseline_1 128² f32 " + (" ".join(extra) or "xla"),
                       f64=True)
        if extra:
            n_c = v3_convs(parse_overrides(["preset=baseline_1", "model.norm=group"] + extra))
            v3_counts_ok(read_counts(), "5n-c", n_c, n_c)
    store = tempfile.mkdtemp(prefix="chip_smoke_dp_gn_")
    dp_cards.check("5n-d GroupNorm headline widths, global batch 8",
                   dp_cards.HEADLINE + dp_cards.SGD + ["model.norm=group"], world=2,
                   backend="gloo", init_method=f"file://{store}/store", devices=["cuda:0"] * 2)
    print(f"  phase 5n: {time.perf_counter() - t_n:.1f} s")
    return ips


def _events(log, kind):
    with open(log) as f:
        return [e for e in map(json.loads, f) if e.get("event") == kind]


def phase_5e(b5_train, small, padded_counts, report_b5, bitwise, cfg_h, headline_step):
    """Phase 5e: grow-the-head (``model.padded_head=false``). 5e-a phase
    5m's baseline_5 cut, 3 tasks of 16 + 8 images, through ``train()``: the
    head 7 wide, then grown to 13 and 19 (``make_task_splits(19, 3)``: the
    cut's 3 tasks split the 18 classes in three), the methods kernels as
    counted and every launch of the run equal to the
    padded run's (``padded_counts``), the KD head (#11/#12) among them;
    then the headline step (``cfg_h``) with task 0's narrow head (10 of
    19 classes, 2 tasks): 3 + 10 steps with the packed head (#7/#8) on the
    zero-padded head, the launches 5h's (``headline_step``) a step; 5e-b
    ``preset=baseline_5 model.padded_head=false`` as it ships (widths 5,
    9, 13, 16, 19), images/s beside 5m's padded run
    (``report_b5``); 5e-c one SGD step of task 1 after growth with all three
    methods on the card against the CPU (baseline_1 at 128², the packed
    body, f32); 5e-d 5r-b's fail-and-resume under grow (bit-equal where
    5r-a found the step bit-repeatable, ``bitwise``), then the CLI's
    ``eval`` and ``predict`` from its checkpoint at the stored width."""
    import shutil
    import tempfile

    import torch

    from cl_tpu_torch import predict
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides

    cuda = torch.device("cuda")
    print("[5e] grow-the-head (model.padded_head=false)")
    t_e = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_grow_")
    try:
        log = os.path.join(root, "cut.jsonl")
        args_a = b5_train + small + ["train.num_tasks=3", "train.epochs_per_task=1",
                                     "model.padded_head=false", f"train.log_path={log}"]
        cfg_a = parse_overrides(args_a)
        widths = [tl.task_head_width(cfg_a, t) for t in range(3)]
        need(widths == [7, 13, 19], f"the cut's widths {widths}")
        keep = {}
        methods_train("5e-a the baseline_5 cut under grow, 3 tasks", args_a, keep=keep)
        grown = [(e["task"], e["width"]) for e in _events(log, "head_expanded")]
        counts = keep["counts"]
        differ = {k: (counts[k], padded_counts[k]) for k in counts
                  if counts[k] != padded_counts[k]}
        print(f"    head {widths[0]} wide, then head_expanded {grown}; launches equal to the "
              f"padded run's: {not differ} {differ}; packed head #7/#8 {counts['head_ce_bn_fwd']}/"
              f"{counts['head_ce_bn_bwd']}, KD head #11/#12 {counts['head_ce_kd_bn_fwd']}/"
              f"{counts['head_ce_kd_bn_bwd']}")
        need(grown == [(1, 13), (2, 19)], "the head grows to 13, then 19")
        need(not differ, "the grow run launches every kernel as the padded run does")
        need(counts["head_ce_kd_bn_fwd"] > 0 and counts["head_ce_kd_bn_bwd"] > 0,
             "the packed KD head launched under grow")
        cfg_n = dataclasses.replace(
            cfg_h, model=dataclasses.replace(cfg_h.model, padded_head=False),
            train=dataclasses.replace(cfg_h.train, num_tasks=2))
        counts_n, ips_n, peak_n, loss_n, first_n = run_steps(cfg_n, 3, 10, cuda)
        print(f"  5e-a the headline step with task 0's head ({tl.task_head_width(cfg_n, 0)} of "
              f"19 classes), 13 steps: {ips_n:.2f} img/s, peak {peak_n:.0f} MiB, loss "
              f"{first_n:.4f} -> {loss_n:.4f}; packed head #7/#8 {counts_n['head_ce_bn_fwd']}/"
              f"{counts_n['head_ce_bn_bwd']}")
        need(loss_n < first_n, "the narrow head's loss falls")
        for k, n in headline_step.items():
            need(counts_n[k] == 13 * n, f"{k} launches == steps x {n} (the narrow head)")
        log_b = os.path.join(root, "b5.jsonl")
        report = methods_train("5e-b baseline_5 model.padded_head=false as it ships",
                               ["preset=baseline_5", "model.padded_head=false",
                                f"train.log_path={log_b}"])
        grown_b = [(e["task"], e["width"]) for e in _events(log_b, "head_expanded")]
        print(f"    head_expanded {grown_b}; images/s per card "
              f"{report.get('images_per_sec_per_chip')} beside the padded head's {report_b5.get('images_per_sec_per_chip')} (5m, as it "
              f"ships); final per-task mIoU {report['final_per_task_miou']}")
        need(grown_b == [(1, 9), (2, 13), (3, 16), (4, 19)], "baseline_5's widths 5 → 19")
        agree_with_cpu(["preset=baseline_1", "model.packed_min_size=0", "data.num_classes=5",
                        "train.num_tasks=2", "method.methods=ewc,lwf,replay",
                        "method.replay_device_resident=true", "method.replay_batch=1",
                        "model.padded_head=false"],
                       "5e-c task 1's methods step after growth (3 -> 5), 128² f32",
                       packed_levels=3)
        print("  5e-d: fail after task 0 and resume under grow, the baseline_5 cut, 3 tasks")
        cfg_r, report_ra, tol = resume_at_full_width(
            b5_train + small + ["train.num_tasks=3", "train.epochs_per_task=1",
                                "model.padded_head=false"],
            bitwise, os.path.join(root, "resume"), cli=False, twice=False)
        model, last = predict.restore_for_inference(cfg_r)
        print(f"    the checkpoint of task {last} restores a head "
              f"{model.head.weight.shape[0]} wide")
        need(model.head.weight.shape[0] == tl.task_head_width(cfg_r, last),
             "the stored width restores")
        del model
        eval_predict_from_checkpoint(cfg_r, report_ra, tol)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 5e: {time.perf_counter() - t_e:.1f} s")
    return report


def phase_5y():
    """Phase 5y: the profiler's trace (``train.profile_dir``): baseline_1
    through ``train()`` with 2 epochs; epoch 1 traced into one Chrome /
    Perfetto file holding CUDA kernel events, the fused head's (#1) among
    them, the ``profile`` event logged, and no steady epoch left for the
    rate (epoch 0 carries the first use, epoch 1 the tracer)."""
    import shutil
    import tempfile

    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides

    print("[5y] the profiler's trace (train.profile_dir), baseline_1 through train()")
    t_y = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        out, log = os.path.join(root, "trace"), os.path.join(root, "run.jsonl")
        cfg = parse_overrides(["preset=baseline_1", "train.epochs_per_task=2",
                               f"train.profile_dir={out}", f"train.log_path={log}"])
        steps = cfg.data.train_images_per_task // cfg.data.batch_size * 2
        reset_counts()
        report = tl.train(cfg)
        counts = read_counts()
        files = sorted(os.listdir(out))
        need(files == ["trace_task0_epoch1.json"], f"one trace file ({files})")
        with open(os.path.join(out, files[0])) as f:
            trace = json.load(f)["traceEvents"]
        kernels = [e for e in trace if e.get("cat") == "kernel"]
        ours = sorted({e["name"] for e in kernels if "head_ce" in e["name"]})
        profiled = _events(log, "profile")
        print(f"  {files[0]}: {os.path.getsize(os.path.join(out, files[0]))} bytes, "
              f"{len(trace)} events, {len(kernels)} CUDA kernel events, the port's head kernels "
              f"{[n[:60] for n in ours]}; profile events {profiled}; the report's images/s "
              f"{report.get('images_per_sec_per_chip')}; head_ce launches "
              f"{counts['head_ce_fwd']} for {steps} steps")
        need(len(kernels) > 0 and ours, "the trace holds CUDA kernels, the port's among them")
        need([e["dir"] for e in profiled] == [out], "the profile event is logged")
        need("images_per_sec_per_chip" not in report, "the profiled epoch is left out of the rate")
        need(counts["head_ce_fwd"] == steps, "the fused head once a step")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 5y: {time.perf_counter() - t_y:.1f} s")


# ---------------------------------------------------------------------------
# Phases 5s, 5b: spatial parallelism; cl_tpu's route-only tuning variables
# ---------------------------------------------------------------------------


def phase_5s():
    """Phase 5s: spatial parallelism (``train.spatial_parallel``) at the
    headline widths (phase 5n's GroupNorm config). 5s-a: two gloo ranks on
    ``cuda:0`` (256 rows each) take one SGD step against the one-rank
    spatial step (``dp_cards.check``, 5w's gate; each rank's peak and
    images/s beside the one rank's), and their stitched logits against the
    one-rank forward (``dp_cards.compare_logits``); no kernel launches
    under spatial (``cl_tpu`` runs none). 5s-b: ``preset=baseline_1
    model.norm=group model.depth=2 data.num_classes=5 train.num_tasks=2
    method.methods=ewc,lwf,replay`` with 32 + 8 images a task through
    ``train()`` over the two ranks
    against one process, every final per-task mIoU within 5e-3
    (``tests/dp/test_spatial.py``'s). 5s-c: one card with
    ``train.spatial_parallel=true`` trains unsharded, its launches those of
    ``spatial_parallel=false``."""
    import gc
    import tempfile

    import torch

    from cl_tpu_torch import dp_cards, sharding
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import parse_overrides

    print("[5s] spatial parallelism (train.spatial_parallel) at the headline widths: two gloo "
          "ranks on cuda:0, 256 rows each")
    t_s = time.perf_counter()
    # the two ranks share this card: release what the earlier phases cached
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  free on the card before the ranks start: "
          f"{torch.cuda.mem_get_info()[0] / 2 ** 30:.1f} GiB")
    store = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    head = dp_cards.HEADLINE + dp_cards.SGD + dp_cards.SPATIAL
    two = dict(world=2, backend="gloo", devices=["cuda:0"] * 2)
    reset_counts()
    res = dp_cards.check("5s-a headline GroupNorm step, 256 rows a rank", head, timed=3,
                         init_method=f"file://{store}/a", **two)
    need(not any(read_counts().values()), "no kernel launched under spatial parallelism")
    args_b = ["preset=baseline_1", "model.norm=group", "model.depth=2", "data.num_classes=5",
              "train.num_tasks=2", "method.methods=ewc,lwf,replay", "train.spatial_parallel=true",
              "data.train_images_per_task=32", "data.val_images_per_task=8"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = sharding.spawn(dp_cards.train_with_peak, (args_b,), init_method=f"file://{store}/b",
                           timeout=900, **two)
    t_ranks = time.perf_counter() - t0
    cuda0 = torch.device("cuda", 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = tl.train(parse_overrides(args_b), device=cuda0)
    gap = np.abs(np.subtract(ranks[0]["final_per_task_miou"], one["final_per_task_miou"]))
    print(f"  5s-b baseline_1 GroupNorm depth 2, ewc,lwf,replay, 2 tasks of 32 + 8 images "
          f"through train(): two "
          f"ranks {ranks[0]['final_per_task_miou']} ({ranks[0]['images_per_sec_per_chip']} "
          f"img/s, peaks {[round(r['peak_mib']) for r in ranks]} MiB, {t_ranks:.1f} s), one "
          f"process (unsharded) {one['final_per_task_miou']} "
          f"({one.get('images_per_sec_per_chip')} img/s); max gap {gap.max():.3e} (tol 5e-3)")
    need(ranks[0]["spatial_parallel"] == 2 and "spatial_parallel" not in one,
         "5s-b: two ranks sharded, one process not")
    need(bool((gap <= 5e-3).all()), "spatial train() within 5e-3 mIoU of one process")
    small = ["preset=baseline_1", "model.norm=group", "data.train_images_per_task=16",
             "data.val_images_per_task=8"]
    counts = {}
    for sp in (True, False):
        reset_counts()
        tl.train(parse_overrides(small + [f"train.spatial_parallel={str(sp).lower()}"]),
                 device=cuda0)
        counts[sp] = read_counts()
    print(f"  5s-c one card, train.spatial_parallel=true (unsharded): launches "
          f"{ {k: v for k, v in counts[True].items() if v} }")
    need(counts[True] == counts[False] and any(counts[True].values()),
         "one card with spatial_parallel=true launches what spatial_parallel=false does")
    print(f"  phase 5s: {time.perf_counter() - t_s:.1f} s")
    return res


CONV_BUDGET_22 = 23068672  # CL_TPU_CONV_BUDGET: the budget cl_tpu's comment compiles at
CONV_BUDGET_8 = 8388608
BWDF_BUDGET_14 = 14680064  # CL_TPU_BWDF_BUDGET: one of the budgets cl_tpu's comment swept
# Level 3 of the headline's packed body at a 22 MiB budget (64², 256
# channels, P = 4; the bottleneck's up-conv 32² x 512 -> 256 into it), with
# each kernel's launches per step, as PACKED_PATH lists levels 0-2. Its two
# prologue convs take the two-pass backward (#30 as dt, #33) in place of
# the fused dx #35 and dW #36.
LEVEL3_PATH = {
    "conv3x3_bn_fwd": [((64, 128, 256, False), 1), ((64, 256, 256, True), 2),
                       ((64, 256, 256, False), 2)],
    "conv3x3_bn_dx": [((64, 128, 256, False), 1), ((64, 256, 256, False), 2)],
    "conv3x3_bn_dw": [((64, 128, 256, False), 1), ((64, 256, 256, False), 2)],
    "bn_relu_fwd": [((64, 256), 2)], "bn_relu_bwd": [((64, 256), 2)],
    "add_stats_fwd": [((64, 256), 1)], "dy_eff": [((64, 256), 1)],
    "maxpool_fwd": [((64, 256), 1)], "maxpool_bwd": [((64, 256, True), 1)],
    "upconv_fwd": [((32, 512, 256), 1)], "upconv_dx": [((32, 512, 256), 1)],
    "upconv_dw": [((32, 512, 256), 1)],
}
LEVEL3_TWO_PASS = {"conv3x3_fwd": ((64, 256, 256), "conv3x3_dt", 2),
                   "conv3x3_dw_bn": ((64, 256, 256, True), "conv3x3_dw_bn", 2)}


def phase_5b(cfg_h, headline_step):
    """Phase 5b: ``cl_tpu``'s route-only tuning variables, set per run as the
    environment would set them at import (``tuned``). 5b-a: the headline
    step at ``CL_TPU_CONV_BUDGET=23068672``, where level 3 runs packed:
    every kernel at its level-3 shapes against its plain version (phase 3's
    checks, f32 and bf16; #35 at 256 channels too, which the fused branch
    takes at larger budgets), 3 + 10 steps with each kernel's launches
    against the default's, five pairs against the default. 5b-b:
    ``preset=baseline_1 model.packed_min_size=0`` at
    ``CL_TPU_CONV_BUDGET=8388608`` (2 packed levels), one SGD step on the
    card against the CPU. 5b-c: ``CL_TPU_BWDF_BUDGET=14680064`` under
    ``CL_TPU_FUSE_BWD=1``: level 2's four convs move from #37 to the fused
    dx and dW. Returns (5b-a's counts, images/s, peak)."""
    import torch

    from cl_tpu_torch import train as tl

    cuda = torch.device("cuda")
    print("[5b] cl_tpu's route-only tuning variables: CL_TPU_CONV_BUDGET, CL_TPU_BWDF_BUDGET")
    t_b = time.perf_counter()
    l3_errs = {}
    with tuned(CONV_VMEM_BUDGET=CONV_BUDGET_22):
        need(tl.build_model(cfg_h).packed_levels(512, 512) == 4,
             "level 3 of the headline runs packed at 22 MiB")
        for kernel, shapes in LEVEL3_PATH.items():
            check = compare_packed if kernel in FORWARD_KERNELS else compare_bwd
            for shape, _ in shapes:
                for dtype_name in ("float32", "bfloat16"):
                    err = check(kernel, shape, dtype_name)
                    if dtype_name == "bfloat16":
                        l3_errs[(kernel, shape)] = err
        compare_bwd("conv3x3_bn_dx_bn", (64, 256, 256, True), "bfloat16")
        for kernel, (shape, _, _) in LEVEL3_TWO_PASS.items():
            compare_v3(kernel, shape, "bfloat16")
        counts, ips, peak, loss, first = run_steps(cfg_h, 3, 10, cuda, no_sync=True)
    want = dict(headline_step, conv3x3_dt=0, conv3x3_dw_bn=0)
    for kernel, shapes in LEVEL3_PATH.items():
        want[kernel] += sum(n for _, n in shapes)
    for _, key, n in LEVEL3_TWO_PASS.values():
        want[key] += n
    print(f"  5b-a headline step at CL_TPU_CONV_BUDGET={CONV_BUDGET_22} (level 3 packed), 13 "
          f"steps: {ips:.2f} img/s, peak {peak:.0f} MiB, loss {first:.4f} -> {loss:.4f}")
    print("    launches per step, 22 MiB / default: " + ", ".join(
        f"{k} {counts[k] / 13:g} / {headline_step.get(k, 0)}" for k in want))
    need(loss < first, "headline training loss falls at 22 MiB")
    for k, n in want.items():
        need(counts[k] == 13 * n, f"{k} launches == steps x {n} (5b-a)")
    pairs, issue = alternating_pairs({"22 MiB": cfg_h, "default": cfg_h}, cuda,
                                     switches={"22 MiB": {"CONV_VMEM_BUDGET": CONV_BUDGET_22}})
    ratios = [p / q for p, q in zip(pairs["22 MiB"], pairs["default"])]
    print(f"    alternating pairs, 10 steps each, images/s: 22 MiB "
          f"{[round(v, 2) for v in pairs['22 MiB']]}, default "
          f"{[round(v, 2) for v in pairs['default']]}; ratio {[round(r, 4) for r in ratios]}, "
          f"median {float(np.median(ratios)):.4f}; host issue 22 MiB {issue['22 MiB']:.3f} ms, "
          f"default {issue['default']:.3f} ms")
    with tuned(CONV_VMEM_BUDGET=CONV_BUDGET_8):
        reset_counts()
        agree_with_cpu(["preset=baseline_1", "model.packed_min_size=0"],
                       f"5b-b baseline_1 128² f32 at CL_TPU_CONV_BUDGET={CONV_BUDGET_8}",
                       packed_levels=2)
        print(f"    launches of the card's step: "
              f"{ {k: v for k, v in read_counts().items() if v} }")
    moved = dict(conv3x3_bn_bwd_fused=11, conv3x3_bn_dx=2, conv3x3_bn_dx_bn=2, conv3x3_bn_dw=4)
    for label, attrs, per_step in (
            ("64 MiB", {}, dict(conv3x3_bn_bwd_fused=15, conv3x3_bn_dx=0, conv3x3_bn_dx_bn=0,
                                conv3x3_bn_dw=0)),
            (f"CL_TPU_BWDF_BUDGET={BWDF_BUDGET_14}", {"FUSED_VMEM_BUDGET": BWDF_BUDGET_14},
             moved)):
        with tuned(FUSE_BWD=True, **attrs):
            counts_c, ips_c, peak_c, loss_c, first_c = run_steps(cfg_h, 3, 10, cuda)
        print(f"  5b-c headline step under CL_TPU_FUSE_BWD=1, {label}, 13 steps: {ips_c:.2f} "
              f"img/s, peak {peak_c:.0f} MiB, loss {first_c:.4f} -> {loss_c:.4f}; backward "
              f"launches per step { {k: counts_c[k] / 13 for k in per_step} }")
        for k, n in per_step.items():
            need(counts_c[k] == 13 * n, f"{k} launches == steps x {n} (5b-c, {label})")
    print(f"  phase 5b: {time.perf_counter() - t_b:.1f} s")
    return counts, ips, peak, l3_errs


# ---------------------------------------------------------------------------
# Phase 3 / 5u / 6: CL_TPU_E_BF16, the bf16 elementwise chains
# ---------------------------------------------------------------------------

EBF16 = "_ebf16"  # the variant's launch-count key: the default's + EBF16
EBF16_KERNELS = {  # the default's launch-count key: (source, TPU kernel's pallas_call)
    "conv3x3_bn_fwd": PACKED_KERNELS["conv3x3_bn_fwd"],
    "conv3x3_bn_dx": PACKED_KERNELS["conv3x3_bn_dx"],
    "conv3x3_bn_dx_bn": PACKED_KERNELS["conv3x3_bn_dx_bn"],
    "conv3x3_bn_dw": PACKED_KERNELS["conv3x3_bn_dw"],
    "conv3x3_bn_dx_pipe": SWITCH_KERNELS["conv3x3_bn_dx_pipe"],
    "conv3x3_bn_dx_bn_pipe": SWITCH_KERNELS["conv3x3_bn_dx_bn_pipe"],
    "conv3x3_bn_bwd_fused": SWITCH_KERNELS["conv3x3_bn_bwd_fused"],
    "conv3x3_dw_bn": V3_KERNELS["conv3x3_dw_bn"][:2],
    "conv3x3_bn_dw_q": Q_KERNELS["conv3x3_bn_dw_q"],
}
# Each variant's shapes on its path at 512² with their launches a step (the
# headline step; 34p/35p and #37 under the switches; #33 at the 22 MiB
# budget of 5b-a, level 3's two-pass convs; #39 in the int8 step, where
# its xq-mode shapes keep the default's f32 t), then one ragged shape
EBF16_PATH = {
    "conv3x3_bn_fwd": PACKED_PATH["conv3x3_bn_fwd"],
    "conv3x3_bn_dx": PACKED_PATH["conv3x3_bn_dx"],
    "conv3x3_bn_dx_bn": PACKED_PATH["conv3x3_bn_dx_bn"],
    "conv3x3_bn_dw": PACKED_PATH["conv3x3_bn_dw"],
    "conv3x3_bn_dx_pipe": SWITCH_PATH["conv3x3_bn_dx_pipe"],
    "conv3x3_bn_dx_bn_pipe": SWITCH_PATH["conv3x3_bn_dx_bn_pipe"],
    "conv3x3_bn_bwd_fused": SWITCH_PATH["conv3x3_bn_bwd_fused"],
    "conv3x3_dw_bn": [LEVEL3_TWO_PASS["conv3x3_dw_bn"][::2]],
    "conv3x3_bn_dw_q": Q_PATH["conv3x3_bn_dw_q"],
}
EBF16_ODD = {"conv3x3_bn_fwd": (20, 40, 72, True), "conv3x3_bn_dx": (20, 40, 72, False),
             "conv3x3_bn_dx_bn": (20, 40, 72, True), "conv3x3_bn_dw": (20, 40, 72, True),
             "conv3x3_bn_dx_pipe": (20, 24, 40, False),
             "conv3x3_bn_dx_bn_pipe": (20, 24, 40, True),
             "conv3x3_bn_bwd_fused": (20, 24, 40, True), "conv3x3_dw_bn": (20, 24, 40, True),
             "conv3x3_bn_dw_q": (24, 16, 16, True, False)}
# the shape of each variant's kernels-line entry (the first level's, with
# the chain on)
EBF16_ENTRY = {"conv3x3_bn_fwd": (512, 32, 32, True), "conv3x3_bn_dx": (512, 32, 32, False),
               "conv3x3_bn_dx_bn": (512, 32, 32, True), "conv3x3_bn_dw": (512, 32, 32, True),
               "conv3x3_bn_dx_pipe": (512, 32, 32, False),
               "conv3x3_bn_dx_bn_pipe": (512, 32, 32, True),
               "conv3x3_bn_bwd_fused": (512, 32, 32, True),
               "conv3x3_dw_bn": (64, 256, 256, True),
               "conv3x3_bn_dw_q": (512, 32, 32, True, False)}
# the exact probes of each: "identity" (the centre-tap identity weight: y
# = t, the dx conv returns e), "t_pixel" (x zero but at one pixel, b < 0:
# every dW entry one product), "e_pixel" (dy zero but at one pixel, ds1 =
# ds2 = 0)
EBF16_PROBES = {"conv3x3_bn_fwd": ("identity",), "conv3x3_bn_dx": ("identity",),
                "conv3x3_bn_dx_bn": ("identity",), "conv3x3_bn_dx_pipe": ("identity",),
                "conv3x3_bn_dx_bn_pipe": ("identity",), "conv3x3_bn_dw": ("t_pixel", "e_pixel"),
                "conv3x3_bn_bwd_fused": ("identity", "t_pixel", "e_pixel"),
                "conv3x3_dw_bn": ("t_pixel", "e_pixel"),
                "conv3x3_bn_dw_q": ("t_pixel", "e_pixel")}


def ebf16_fns(base):
    """(operands(shape, batch, seed), launch(ops, ew), plain(ops, ew),
    library(ops) or None, bytes_ops(shape)) of the kernel under
    launch-count key ``base``, ``ew`` its CL_TPU_E_BF16 switch; the
    operands, library calls and bounds are the default's (phase 3 / 6)."""
    from cl_tpu_torch.kernels import conv3x3

    bf = "bfloat16"
    if base == "conv3x3_bn_fwd":
        return (lambda sh, n, sd: packed_operands(base, sh, bf, n, sd),
                lambda o, ew: conv3x3.launch_conv_bn(*o, e_bf16=ew),
                lambda o, ew: conv3x3.conv_bn_plain(*o, e_bf16=ew), packed_fns(base)[2],
                lambda sh: packed_bytes_ops(base, sh, bf))
    if base in ("conv3x3_bn_dx", "conv3x3_bn_dx_bn", "conv3x3_bn_dw"):
        launch, plain, lib = bwd_fns(base)
        return (lambda sh, n, sd: bwd_operands(base, sh, bf, n, sd),
                lambda o, ew: launch(*o, e_bf16=ew), lambda o, ew: plain(*o, e_bf16=ew), lib,
                lambda sh: bwd_bytes_ops(base, sh, bf))
    if base in ("conv3x3_bn_dx_pipe", "conv3x3_bn_dx_bn_pipe", "conv3x3_bn_bwd_fused"):
        lib = switch_fns(base)[2]
        if base == "conv3x3_bn_bwd_fused":
            launch = lambda o, ew: conv3x3.launch_conv_bwd_fused(  # noqa: E731
                *o, e_bf16=ew, need_dx=o[0].shape[-1] != 3)
            plain = lambda o, ew: conv3x3.conv_bwd_fused_plain(  # noqa: E731
                *o, e_bf16=ew, need_dx=o[0].shape[-1] != 3)
        else:
            launch = lambda o, ew: conv3x3.launch_conv_dx(*o, pipe=True, e_bf16=ew)  # noqa: E731
            plain = lambda o, ew: conv3x3.conv_dx_plain(*o, e_bf16=ew)  # noqa: E731
        return (lambda sh, n, sd: bwd_operands("conv3x3_bn_dw", sh, bf, n, sd), launch, plain,
                lib, lambda sh: switch_bytes_ops(base, sh, bf))
    if base == "conv3x3_dw_bn":
        launch, plain, lib = v3_fns(base)
        return (lambda sh, n, sd: v3_operands(base, sh, bf, n, sd),
                lambda o, ew: launch(*o, e_bf16=ew), lambda o, ew: plain(*o, e_bf16=ew), lib,
                lambda sh: v3_bytes_ops(base, sh, bf))
    launch, plain, lib = q_fns(base)
    return (lambda sh, n, sd: q_operands(sh, bf, n, sd), lambda o, ew: launch(*o, e_bf16=ew),
            lambda o, ew: plain(*o, e_bf16=ew), lib, lambda sh: q_bytes_ops(base, sh, bf))


def ebf16_compare(base, shape):
    """Phase 3's comparison of the kernel's variant against its plain
    variant on random operands, at the default instance's tolerance
    (relaunched bit-equal); returns the max abs error."""
    bf = "bfloat16"
    if base == "conv3x3_bn_fwd":
        return compare_packed(base, shape, bf, ew=True)
    if base in ("conv3x3_bn_dx", "conv3x3_bn_dx_bn", "conv3x3_bn_dw"):
        return compare_bwd(base, shape, bf, ew=True)
    if base in ("conv3x3_bn_dx_pipe", "conv3x3_bn_dx_bn_pipe"):
        return compare_pipe(base, shape, bf, ew=True)
    if base == "conv3x3_bn_bwd_fused":
        return compare_fused(shape, bf, ew=True)
    if base == "conv3x3_dw_bn":
        return compare_v3(base, shape, bf, ew=True)
    return compare_q_bwd(base, shape, bf, ew=True)


def _identity_weight(w):
    """The centre-tap identity in ``w``'s shape [Cout, Cin, 3, 3] (its
    first min(Cin, Cout) channels): the conv returns t, the dx conv e."""
    import torch

    out = torch.zeros_like(w)
    n = torch.arange(min(w.shape[:2]), device=w.device)
    out[n, n, 1, 1] = 1.0
    return out


def ebf16_exact_ops(base, shape, probe, seed=5):
    """Seeded operands (batch 1) of one exact probe of the kernel under
    ``base``: the identity weight, and for "t_pixel" x zero but at one
    pixel with b < 0, for "e_pixel" dy (or #33's e) zero but at one pixel
    with ds1 = ds2 = 0."""
    import torch

    from cl_tpu_torch.kernels import conv3x3

    ops = list(ebf16_fns(base)[0](shape, 1, seed))
    H = shape[0]
    pix = (0, H // 2, H // 2 + 1)

    def one_pixel(t, low=0.0):
        out = torch.zeros_like(t)
        out[pix] = (low + t[pix].float().abs()).to(t.dtype)
        return out

    if base == "conv3x3_dw_bn":  # (x, a, b, e, prologue)
        if probe == "t_pixel":
            ops[0], ops[2] = one_pixel(ops[0], 2.0), -(ops[2].abs() + 0.1)
        else:
            ops[3] = one_pixel(ops[3])
        return tuple(ops)
    if base == "conv3x3_bn_dw_q":  # (x or (xq, xs), w, a, b, q, scale, dy, ds1, ds2, prologue, p)
        if probe == "t_pixel":
            x = packed_operands("conv3x3_bn_fwd", shape[:4], "bfloat16", 1, seed)[0]
            x = one_pixel(x, 2.0)
            ops[0] = conv3x3.quant_rows_plain(x, Q_P) if shape[4] else x
            if ops[3] is not None:
                ops[3] = -(ops[3].abs() + 0.1)
        else:
            ops[6], ops[7], ops[8] = one_pixel(ops[6]), ops[7] * 0, ops[8] * 0
        return tuple(ops)
    ops[1] = _identity_weight(ops[1])
    if base == "conv3x3_bn_fwd" or probe == "identity":
        return tuple(ops)
    if probe == "t_pixel":  # (x, w, a, b, y, dy, ds1, ds2, prologue)
        ops[0] = one_pixel(ops[0], 2.0)
        if ops[3] is not None:
            ops[3] = -(ops[3].abs() + 0.1)
    else:
        ops[5], ops[6], ops[7] = one_pixel(ops[5]), ops[6] * 0, ops[7] * 0
    return tuple(ops)


def _exact_outputs(base, out, probe):
    """The outputs an exact probe holds bit for bit: y, dx, or dW (#37:
    dx, and dW in the one-pixel probes)."""
    if base == "conv3x3_bn_fwd" or "dx" in base:
        return [out[0]]
    if base == "conv3x3_bn_bwd_fused":
        return [v for v in (out[0], out[3] if probe != "identity" else None) if v is not None]
    return [out]


def compare_ebf16_exact(base, shape, probe):
    """One exact probe of a variant: the kernel under the flag bit for bit
    its plain variant (run with cuDNN off: an f32 GEMM of one product and
    zeros is that product) and itself relaunched; and unlike the flag-off
    launch where the probe's operands reach a bf16 chain (else bit-equal
    to it: #39's xq mode, a forward without the prologue)."""
    import torch

    _, launch, plain, _, _ = ebf16_fns(base)
    ops = ebf16_exact_ops(base, shape, probe)
    on, again, off = (launch(ops, ew) for ew in (True, True, False))
    with torch.backends.cudnn.flags(enabled=False):
        want = plain(ops, True)
    torch.cuda.synchronize()
    k_on, k_again, k_off, p_on = (_exact_outputs(base, v, probe) for v in (on, again, off, want))
    prologue = ops[4] if base == "conv3x3_dw_bn" else ops[-2] if base == "conv3x3_bn_dw_q" \
        else ops[-1]
    if base == "conv3x3_bn_fwd" or base == "conv3x3_dw_bn":
        reaches = prologue
    elif base == "conv3x3_bn_dw_q":
        reaches = prologue and not shape[4]
    else:  # the e chain (stats present) or, in e_pixel, the prologue's
        reaches = probe != "e_pixel" or prologue
    same = all(torch.equal(u, v) for u, v in zip(k_on, p_on))
    rel = all(torch.equal(u, v) for u, v in zip(k_on, k_again))
    moved = sum(int((u != v).sum().item()) for u, v in zip(k_on, k_off))
    name = f"{packed_name(base, shape, 'bfloat16')}[ebf16 {probe}]"
    ok = same and rel and (moved > 0) == bool(reaches)
    print(f"  {name}: bit-equal to the plain variant {same}, relaunch {rel}; {moved} values "
          f"moved by the flag ({'a chain reached' if reaches else 'no chain reached'}) "
          f"{'ok' if ok else 'FAIL'}")
    need(ok, name)


def ebf16_f32_unchanged(base, shape):
    """The f32 instance of the kernel under ``base`` keeps every bit with
    ``e_bf16`` on."""
    import torch

    operands, launch, _, _, _ = ebf16_fns(base)
    if base == "conv3x3_bn_dw_q":
        ops = q_operands(shape, "float32", 3)
    elif base == "conv3x3_dw_bn":
        ops = v3_operands(base, shape, "float32", 3)
    elif base == "conv3x3_bn_fwd":
        ops = packed_operands(base, shape, "float32", 3)
    else:
        ops = bwd_operands("conv3x3_bn_dw", shape, "float32", 3)
    on, off = launch(ops, True), launch(ops, False)
    torch.cuda.synchronize()
    on, off = (v if isinstance(v, tuple) else (v,) for v in (on, off))
    same = all((u is None and v is None) or torch.equal(u, v) for u, v in zip(on, off))
    print(f"  {packed_name(base, shape, 'float32')}: f32 unchanged under the flag "
          f"{'ok' if same else 'FAIL'}")
    need(same, f"{base}{shape} float32 under CL_TPU_E_BF16")


def phase_3u():
    """Phase 3's checks of CL_TPU_E_BF16's variants: each kernel that
    takes the bf16 chains, at every shape of its path (``EBF16_PATH``) and
    a ragged one, on random operands against its plain variant at the
    default's tolerance and relaunched bit-equal, then its exact probes;
    its f32 instance unchanged. Returns {(base, shape): max abs err}."""
    print("[3u] CL_TPU_E_BF16: the bf16 chains' kernels against their plain variants")
    t_u = time.perf_counter()
    errs = {}
    for base, shapes in EBF16_PATH.items():
        for shape in [s for s, _ in shapes] + [EBF16_ODD[base]]:
            errs[(base, shape)] = ebf16_compare(base, shape)
            for probe in EBF16_PROBES[base]:
                if base == "conv3x3_bn_bwd_fused" and probe == "identity" and shape[1] == 3:
                    continue  # the stem: no dx
                compare_ebf16_exact(base, shape, probe)
        ebf16_f32_unchanged(base, EBF16_ODD[base])
    print(f"  phase 3u: {time.perf_counter() - t_u:.1f} s")
    return errs


def ebf16_want(per_step, steps=1):
    """The launch counts of ``steps`` steps of a config whose default
    counts a step are ``per_step``, under the flag: each kernel of
    ``EBF16_KERNELS`` under its variant's key, but #39's xq-mode launches
    (t from deq(xq), f32), which keep the default's."""
    want = {k: n * steps for k, n in per_step.items()}
    for base in EBF16_KERNELS:
        n = want.get(base, 0)
        keep = steps * sum(c for sh, c in Q_PATH[base] if sh[4]) \
            if base == "conv3x3_bn_dw_q" and n else 0
        want[base], want[base + EBF16] = keep, n - keep
    return want


def phase_5u(cfg_h, cfg_q, headline_step, ips_h, peak_h, per_steps):
    """Phase 5u: CL_TPU_E_BF16 (``tuned(E_BF16=True)``, as the variable
    sets it at import). 5u-a: the headline step at full width under the
    flag, 3 + 10 steps, its launches those of 5h under the variants' keys,
    five pairs against the default. 5u-b: one step each under the flag
    with model.conv_act_store=int8 (``cfg_q``, 5q-a's), CL_TPU_FUSE_BWD,
    CL_TPU_DX_PIPE and the 22 MiB budget of 5b-a (``per_steps``: their
    default counts a step), the variants launched. 5u-c: baseline_1 model.packed_min_size=0
    train.compute_dtype=bfloat16, one SGD step on the card against the
    CPU with and without the flag: the flag's worst update gap within
    twice the default's. Returns (5u-a's counts, images/s, peak, the
    5u-b counts by label)."""
    import torch

    from cl_tpu_torch.models import packed_gate

    cuda = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"[5u] CL_TPU_E_BF16: the headline step with the bf16 elementwise chains ({smi})")
    t_u = time.perf_counter()
    with tuned(E_BF16=True):
        counts, ips, peak, loss, first = run_steps(cfg_h, 3, 10, cuda, no_sync=True)
    want = ebf16_want(headline_step, 13)
    print(f"  5u-a headline step under the flag, 13 steps: {ips:.2f} img/s, peak {peak:.0f} MiB, "
          f"loss {first:.4f} -> {loss:.4f} ({smi}); default (5h) {ips_h:.2f} img/s, peak "
          f"{peak_h:.0f} MiB")
    print("    conv launches per step, flag: " + ", ".join(
        f"{k} {counts[k] / 13:g}" for k in want if k.startswith("conv") and want[k]))
    need(loss < first, "headline training loss falls under the flag")
    for k, n in want.items():
        need(counts[k] == n, f"{k} launches == {n} (5u-a)")
    pairs, issue = alternating_pairs({"E_BF16": cfg_h, "default": cfg_h}, cuda,
                                     switches={"E_BF16": {"E_BF16": True}})
    ratios = [p / q for p, q in zip(pairs["E_BF16"], pairs["default"])]
    print(f"    alternating pairs, 10 steps each, images/s ({smi}): E_BF16 "
          f"{[round(v, 2) for v in pairs['E_BF16']]}, default "
          f"{[round(v, 2) for v in pairs['default']]}; ratio {[round(r, 4) for r in ratios]}, "
          f"median {float(np.median(ratios)):.4f}; host issue E_BF16 {issue['E_BF16']:.3f} ms, "
          f"default {issue['default']:.3f} ms")
    one = {}
    for label, cfg, attrs in (("int8", cfg_q, {}), ("FUSE_BWD", cfg_h, {"FUSE_BWD": True}),
                              ("DX_PIPE", cfg_h, {"DX_PIPE": True}),
                              ("22 MiB", cfg_h, {"CONV_VMEM_BUDGET": CONV_BUDGET_22})):
        with tuned(E_BF16=True, **attrs):
            model, opt, step, batch, valid = build_step(cfg, cuda)
            reset_counts()
            aux = step(batch, valid)
            torch.cuda.synchronize()
            got = read_counts()
        del model, opt, step
        want = ebf16_want(per_steps[label])
        moved = {k: got[k] for k in want if k.endswith(EBF16) and want[k]}
        print(f"  5u-b one step under the flag and {label}: loss {aux['loss'].item():.4f}; "
              f"variant launches {moved}")
        need(np.isfinite(aux["loss"].item()), f"finite loss (5u-b, {label})")
        for k, n in want.items():
            need(got[k] == n, f"{k} launches == {n} (5u-b, {label})")
        one[label] = got
    args_c = ["preset=baseline_1", "model.packed_min_size=0", "train.compute_dtype=bfloat16"]
    levels = packed_gate.packed_prefix(128, 32, 4, 2)
    gaps = {}
    for label, flag in (("default", False), ("E_BF16", True)):
        with tuned(E_BF16=flag):
            gaps[label] = agree_with_cpu(args_c, f"5u-c bf16 step 128² base 32 depth 4, {label}",
                                         packed_levels=levels, held=False)
    print(f"  5u-c card vs CPU, (|loss|, max |param|, worst update share): default "
          f"{gaps['default']}, E_BF16 {gaps['E_BF16']} (held: the worst update within "
          f"twice the default's)")
    need(gaps["E_BF16"][2] <= 2 * gaps["default"][2],
         "the flag's card-vs-CPU update gap within twice the default's (5u-c)")
    print(f"  phase 5u: {time.perf_counter() - t_u:.1f} s")
    return counts, ips, peak, one


def ebf16_phase6(counts_u, one, errs):
    """Phase 6's lines of the variants: each at every shape of its path
    beside its default at the same shapes (launches queued back to back,
    then synchronised per launch), the per-step sums, and one kernels-line
    entry a variant (``EBF16_ENTRY``: its plain variant's and the library
    call's times, the default's bound, launches from 5u)."""
    launches = {base + EBF16: counts_u[base + EBF16] for base in
                ("conv3x3_bn_fwd", "conv3x3_bn_dx", "conv3x3_bn_dx_bn", "conv3x3_bn_dw")}
    for label, bases in (("int8", ("conv3x3_bn_dw_q",)), ("FUSE_BWD", ("conv3x3_bn_bwd_fused",)),
                         ("DX_PIPE", ("conv3x3_bn_dx_pipe", "conv3x3_bn_dx_bn_pipe")),
                         ("22 MiB", ("conv3x3_dw_bn",))):
        for base in bases:
            launches[base + EBF16] = one[label][base + EBF16]
    entries = []
    for base, shapes in EBF16_PATH.items():
        operands, launch, plain, lib, bytes_ops = ebf16_fns(base)
        sums = [0.0, 0.0]
        for shape, n_step in shapes:
            ops = operands(shape, 8, 0)
            t_on, t_off = (time_ms(lambda ew=ew: launch(ops, ew)) for ew in (True, False))
            s_on, s_off = (time_ms(lambda ew=ew: launch(ops, ew), queued=False)
                           for ew in (True, False))
            sums[0] += n_step * t_on
            sums[1] += n_step * t_off
            print(f"  {packed_name(base, shape, 'bfloat16')}[ebf16] x{n_step}/step: {t_on:.4f} ms "
                  f"(default {t_off:.4f}, ratio {t_on / t_off:.4f}; synchronised per launch "
                  f"{s_on:.4f} / {s_off:.4f})")
            if shape == EBF16_ENTRY[base]:
                times = (t_on, time_ms(lambda: plain(ops, True)),
                         None if lib is None else time_ms(lambda: lib(*ops)))
                entry = json_entry(f"{packed_name(base, shape, 'bfloat16')}[ebf16]",
                                   EBF16_KERNELS[base][0], EBF16_KERNELS[base][1],
                                   launches[base + EBF16], errs[(base, shape)], times,
                                   bytes_ops(shape))
                entries.append(entry)
        print(f"  per step, {base} under the flag: {sums[0]:.4f} ms beside the default's "
              f"{sums[1]:.4f} (ratio {sums[0] / sums[1]:.4f}); launches "
              f"{launches[base + EBF16]} in phase 5u")
    need(len(entries) == len(EBF16_KERNELS), "a kernels-line entry for every variant")
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # f32 means f32 for the plain versions' cuDNN convs too
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from cl_tpu_torch import train as tl
    from cl_tpu_torch.config import get_preset, parse_overrides
    from cl_tpu_torch.kernels import build

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {smi} | torch {torch.__version__} | CUDA {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    print(f"[2] build: {time.perf_counter() - t0:.1f} s -> {lib_path}")

    print("[3] kernels against their plain versions on the card")
    cases = [make_case("head_ce", 131072, 32, 2, "float32", 1),
             make_case("head_ce", 2097152, 32, 19, "bfloat16", 2),
             make_case("ce", 131072, 0, 2, "float32", 3),
             make_case("ce", 2097152, 0, 19, "bfloat16", 4)]
    errs = [compare(c) for c in cases]
    # ragged tails (P not a multiple of a tile) and the C <= 8 variants
    for extra in (make_case("head_ce", 1000, 8, 3, "float32", 5),
                  make_case("head_ce", 1000, 16, 5, "bfloat16", 6),
                  make_case("ce", 1000, 0, 3, "float32", 7),
                  make_case("ce", 1000, 0, 5, "bfloat16", 8)):
        compare(extra)
    packed_errs = {}  # (kernel, shape) -> bf16 max abs err at full width
    for kernel, shapes in PACKED_PATH.items():
        check = compare_packed if kernel in FORWARD_KERNELS else compare_bwd
        for shape, _ in shapes:
            for dtype_name in ("float32", "bfloat16"):
                err = check(kernel, shape, dtype_name)
                if dtype_name == "bfloat16":
                    packed_errs[(kernel, shape)] = err
        for shape in ODD[kernel]:
            for dtype_name in ("float32", "bfloat16"):
                check(kernel, shape, dtype_name, batch=3)
    # the bf16 forward's and dx's ring past every tile and picker branch
    for kernel in ("conv3x3_bn_fwd", "conv3x3_bn_dx", "conv3x3_bn_dx_bn"):
        check = compare_packed if kernel in FORWARD_KERNELS else compare_bwd
        for shape in RING_ODD[kernel]:
            check(kernel, shape, "bfloat16", batch=3)
    # the f32 dx at 512 channels, and both against float64
    compare_bwd("conv3x3_bn_dx", (*F32_DX_WIDE, False), "float32", batch=3)
    compare_bwd("conv3x3_bn_dx_bn", (*F32_DX_WIDE, True), "float32", batch=3)
    for kernel, prologue in (("conv3x3_bn_dx", False), ("conv3x3_bn_dx_bn", True)):
        f32_dx_float64(kernel, (*F32_DX_WIDE, prologue))
    # the split convs' dx: no stats cotangents (their sums are unused); the
    # ring body's dW without them (e = dy: eval-mode backward, the Fisher)
    compare_bwd("conv3x3_bn_dx", (512, 32, 32, False), "bfloat16", stats=False)
    compare_bwd("conv3x3_bn_dw", (256, 64, 64, True), "bfloat16", stats=False)
    ring_info()
    conv_ring_info()
    # the up-conv forward's wgmma kernel (#27) past every tile and picker
    # branch, each launched twice; its instances' resources
    for shape in UPCONV_FWD_ODD:
        for dtype_name in ("float32", "bfloat16"):
            compare_packed("upconv_fwd", shape, dtype_name, batch=3)
    upconv_fwd_info()
    # the up-conv dx's wgmma kernel (#28) past every tile, picker branch and
    # staging path, each launched twice; its instances' resources
    for shape in UPCONV_DX_ODD:
        compare_bwd("upconv_dx", shape, "bfloat16", batch=3)
    upconv_dx_info()
    # the packed head: at the headline shape, and small f32 / ragged / C <= 8
    bn_full = bn_case(2097152, 32, 19, "bfloat16", 2)
    bn_errs = {k: compare_bn(k, bn_full) for k in BN_KERNELS}
    for args in ((4096, 32, 19, "float32", 7), (1000, 32, 5, "float32", 5),
                 (1000, 16, 3, "bfloat16", 6)):
        case = bn_case(*args)
        for k in BN_KERNELS:
            compare_bn(k, case)
    # the bf16 #7 and #8 on the tensor cores at every instance and ragged
    # P, each launched twice; their instances' resources
    for seed, args in enumerate(BN_BWD_ODD, 20):
        case = bn_case(*args, "bfloat16", seed)
        for kernel in ("head_ce_bn_fwd", "head_ce_bn_bwd"):
            compare_bn(kernel, case)
    head_fwd_info()
    head_bwd_info()
    # LwF off the packed head: the KD head on NHWC features (#9/#10) at the
    # full width, at base 64 with the fused head (Cin 64, baseline_2's 21
    # classes, f32) and at a small ragged f32 case; the KD on logits
    # (#13/#14) at the full width, at baseline_2's LwF shape (524,288 x 21
    # f32) and small ragged f32 and bf16 ones; each also with task 0's
    # teacher (old_valid all false)
    kdh_full = bn_case(2097152, 32, 19, "bfloat16", 12)
    kdh_errs = {k: compare_bn(k, kdh_full) for k in KD_HEAD_KERNELS}
    zero_teacher_kd("head", kdh_full)
    for args in ((524288, 64, 21, "float32", 13), (1000, 32, 5, "float32", 14)):
        case = bn_case(*args)
        for k in KD_HEAD_KERNELS:
            compare_bn(k, case)
        zero_teacher_kd("head", case)
    kdl_full = kd_case(2097152, 19, "bfloat16", 15)
    kdl_errs = {k: compare_kd(k, kdl_full) for k in KD_KERNELS}
    zero_teacher_kd("logits", kdl_full)
    for args in ((524288, 21, "float32", 16), (1000, 5, "float32", 17),
                 (1000, 5, "bfloat16", 18)):
        case = kd_case(*args)
        for k in KD_KERNELS:
            compare_kd(k, case)
        zero_teacher_kd("logits", case)

    # the methods kernels: the flat params of both methods paths (19 and 21
    # classes) and a ragged n; the replay gather on the 576² rows
    n5, n3 = n_params(19), n_params(21)
    ewc_errs = compare_ewc(n5, 1)
    for n in (n3, 1003):
        compare_ewc(n, 2)
    gather_errs = {}
    for shape in ((S_REPLAY, S_REPLAY, 3), (S_REPLAY, S_REPLAY)):
        for k in (1, 4, 8):
            err = compare_gather(shape, k, k)
            gather_errs.setdefault(shape, err)
    compare_gather((37, 37, 3), 4, 5)
    # the augment kernels at the presets' shapes, flips mixed, f32 and bf16
    aug_errs = {}
    for src, dst, B in AUG_SHAPES:
        for dtype_name in ("float32", "bfloat16"):
            errs_ = compare_augment(src, dst, B, dtype_name, seed=src + B)
            if (src, dst, B, dtype_name) == AUG_MAIN:
                aug_errs = errs_
    # the gen-3 conv (#30), its dW (#31) and the two-pass dW (#33) at this
    # slice's full-width shapes (#33's bf16 is level 3's at 22 MiB) and at a
    # ragged one, each launched twice
    v3_errs = {}
    for kernel, shapes in V3_SHAPES.items():
        for shape in shapes:
            for dtype_name in ("float32", "bfloat16"):
                err = compare_v3(kernel, shape, dtype_name)
                v3_errs.setdefault((kernel, shape), err)
        for shape in V3_ODD[kernel]:
            for dtype_name in ("float32", "bfloat16"):
                compare_v3(kernel, shape, dtype_name, batch=3)
    v3_dw_path_tiles()
    # the gen-2 conv (#40 as a forward and as a dx, its dW #41) at
    # baseline_2's shapes under conv_impl=pallas, at 1024 channels, at the
    # 512² standard body's p = 4 and at the odd-row and p = 16 shapes gen-3
    # never takes, f32 and bf16, each launched twice
    g2_errs = {}
    for kernel, shapes in G2_SHAPES.items():
        for shape in shapes:
            for dtype_name in ("float32", "bfloat16"):
                g2_errs[(kernel, shape, dtype_name)] = compare_g2(kernel, shape, dtype_name)
        for shape in G2_ODD:
            for dtype_name in ("float32", "bfloat16"):
                compare_g2(kernel, shape, dtype_name, batch=3)
    # the plain conv's (#30's, #40's) bf16 instances the paths pick past the
    # lists, its plain-load staging and a ragged channel tile
    t0 = time.perf_counter()
    plain_rows = plain_path_tiles()
    print(f"  plain path tiles: {time.perf_counter() - t0:.1f} s")
    # #33, #31 and #41 past their path tiles and staging paths, f32 and
    # bf16, each launched twice; every instance's resources against its
    # picker
    for kernel, shapes in DW_ODD.items():
        check = compare_v3 if kernel in V3_KERNELS else compare_g2
        for shape in shapes:
            for dtype_name in ("float32", "bfloat16"):
                check(kernel, shape, dtype_name, batch=3)
    dw_tiled_info()
    # the int8 saved activations: 32q, #38 and #39 at every int8 shape of
    # the headline step and at ragged ones, xq mode on and off, prologue on
    # and off, each launched twice
    t0 = time.perf_counter()
    q_errs = {}
    for kernel, shapes in Q_PATH.items():
        check = compare_quant if kernel == "conv3x3_bn_quant" else \
            (lambda *a, k=kernel, **kw: compare_q_bwd(k, *a, **kw))
        for shape, _ in shapes:
            for dtype_name in ("float32", "bfloat16"):
                err = check(shape, dtype_name)
                if dtype_name == "bfloat16":
                    q_errs.setdefault((kernel, shape), err)
        for shape in Q_ODD:
            if kernel == "conv3x3_bn_dx_q" and shape[1] == 3:
                continue  # the stem's dx: never launched
            for dtype_name in ("float32", "bfloat16"):
                check(shape, dtype_name, batch=3)
    # #38 and #39 at 5q-d's widths and pack; without the stats cotangents
    # (e = dy: no y window) at each instance of the headline step and at
    # 5q-c's Fisher pass; every int8 instance's resources
    for kernel in ("conv3x3_bn_dx_q", "conv3x3_bn_dw_q"):
        for shape in Q_D_SHAPES:
            for dtype_name in ("float32", "bfloat16"):
                compare_q_bwd(kernel, shape, dtype_name, batch=3, pack=Q_P_D)
    for kernel, shape, dtype_name, batch in q_nostats_cases():
        compare_q_bwd(kernel, shape, dtype_name, batch=batch, stats=False)
    q_info()
    print(f"  int8 backward checks: {time.perf_counter() - t0:.1f} s")

    # CL_TPU_FUSE_BWD / CL_TPU_DX_PIPE: #37 and 34p/35p at every backward
    # shape of the headline step and at ragged ones, f32 and bf16, each
    # launched twice and held beside #34-#36; the packed head without a
    # prologue (#5/#6) at the headline shape and small f32 / ragged ones
    switch_errs = {}
    for kernel, shapes in SWITCH_PATH.items():
        check = compare_fused if kernel == "conv3x3_bn_bwd_fused" else \
            (lambda *a, k=kernel, **kw: compare_pipe(k, *a, **kw))
        for shape, _ in shapes:
            for dtype_name in ("float32", "bfloat16"):
                err = check(shape, dtype_name)
                if dtype_name == "bfloat16":
                    switch_errs[(kernel, shape)] = err
        for shape in SWITCH_ODD[kernel]:
            for dtype_name in ("float32", "bfloat16"):
                check(shape, dtype_name, batch=3)
    compare_pipe("conv3x3_bn_dx_pipe", (512, 32, 32, False), "bfloat16", stats=False)
    # and the ring's dx at its ragged shapes: 34p/35p bit for bit
    for kernel in ("conv3x3_bn_dx", "conv3x3_bn_dx_bn"):
        for shape in RING_ODD[kernel]:
            compare_pipe(kernel + "_pipe", shape, "bfloat16", batch=3)
    pk_errs = {k: compare_bn(k, bn_full) for k in PK_KERNELS}
    for args in ((4096, 32, 19, "float32", 7), (1000, 32, 5, "float32", 5),
                 (1000, 16, 3, "bfloat16", 6)):
        case = bn_case(*args)
        for k in PK_KERNELS:
            compare_bn(k, case)
    ebf16_errs = phase_3u()

    print("[4] baseline_1 as it ships, through train()")
    cfg1 = get_preset("baseline_1")
    steps1 = (cfg1.data.train_images_per_task // cfg1.data.batch_size
              * cfg1.train.epochs_per_task)
    reset_counts()
    report = tl.train(cfg1)
    counts_b1 = read_counts()
    print(f"  report: {json.dumps({k: v for k, v in report.items() if k != 'miou_matrix'})}")
    print(f"  launches: {counts_b1} (steps {steps1})")
    need(all(np.isfinite(report["final_per_task_miou"])), "finite baseline_1 mIoU")
    need(counts_b1["head_ce_fwd"] == steps1 and counts_b1["head_ce_bwd"] == steps1,
         "head_ce launches == steps in baseline_1")
    need(counts_b1["ce_fwd"] == 0 and counts_b1["ce_bwd"] == 0,
         "no ce launches with the fused head")
    b1_ips = report.get("images_per_sec_per_chip")

    cfg1u = parse_overrides(["preset=baseline_1", "train.fused_head_ce=false"])
    counts_b1u, b1u_ips, _, _, _ = run_steps(cfg1u, 2, 6, torch.device("cuda"))
    print(f"  baseline_1 fused_head_ce=false, 8 steps: launches {counts_b1u}; "
          f"{b1u_ips:.1f} img/s")
    need(counts_b1u["ce_fwd"] == 8 and counts_b1u["ce_bwd"] == 8
         and counts_b1u["head_ce_fwd"] == 0, "ce launches == steps (baseline_1)")
    for fused in ("auto", "false"):
        agree_with_cpu(["preset=smoke", "data.num_classes=3", "model.depth=3",
                        f"train.fused_head_ce={fused}"], f"fused_head_ce={fused}")

    print("[5] full width: 512², batch 8, 19 classes, bf16, standard body")
    full = list(FULL_ARGS)
    trained = {}
    counts_f, ips_f, peak_f, loss_f, _ = run_steps(
        parse_overrides(full), 3, 10, torch.device("cuda"), keep=trained)
    print(f"  fused head: {ips_f:.2f} img/s, peak {peak_f:.0f} MiB, loss {loss_f:.4f}, "
          f"launches {counts_f}")
    need(counts_f["head_ce_fwd"] == 13 and counts_f["head_ce_bwd"] == 13,
         "head_ce launches == steps (full width)")
    counts_u, ips_u, peak_u, loss_u, _ = run_steps(
        parse_overrides(full + ["train.fused_head_ce=false"]), 2, 5,
        torch.device("cuda"))
    print(f"  fused_head_ce=false: {ips_u:.2f} img/s, peak {peak_u:.0f} MiB, "
          f"loss {loss_u:.4f}, launches {counts_u}")
    need(counts_u["ce_fwd"] == 7 and counts_u["ce_bwd"] == 7,
         "ce launches == steps (full width)")

    print("[5p] full width through the packed body (eval), phase 5's weights")
    from cl_tpu_torch.interop import load_jax_variables

    cuda = torch.device("cuda")
    bodies = {}
    for body, packed in (("packed", "true"), ("standard", "false")):
        cfg_e = parse_overrides([f if f != "model.packed_unet=false" else
                                 f"model.packed_unet={packed}" for f in full])
        model = tl.init_state(cfg_e, tl.build_model(cfg_e), cuda)
        load_jax_variables(model, trained["variables"])
        need(model.packed_levels(512, 512) == (3 if packed == "true" else 0),
             f"{body} body engages as configured")
        res, counts, forwards = eval_pass(cfg_e, model, cuda)
        ips, peak = timed_eval(cfg_e, model, cuda)
        bodies[body] = (res["miou"], ips, peak, counts, forwards)
        print(f"  {body} body: evaluate_task mIoU {res['miou']:.5f} ({forwards} "
              f"forwards); eval step {ips:.2f} img/s, peak {peak:.0f} MiB")
        need(np.isfinite(res["miou"]), f"finite {body} mIoU")
        del model
    counts_p, forwards_p = bodies["packed"][3], bodies["packed"][4]
    print(f"  packed launches: { {k: counts_p[k] for k in PER_FORWARD} } "
          f"for {forwards_p} forwards")
    for k, n in PER_STEP.items():
        n = PER_FORWARD.get(k, 0)  # an eval launches no backward kernel
        need(counts_p[k] == forwards_p * n, f"{k} launches == forwards x {n}")
        need(bodies["standard"][3][k] == 0, f"no {k} launch in the standard body")
    packed_agrees_with_cpu()

    print("[5t] full width through the packed body (training), from a prebuilt batch")
    packed_full = [f if f != "model.packed_unet=false" else "model.packed_unet=true"
                   for f in full]
    train_runs = {}
    for head, n_warm, n_timed in (("train.packed_head_ce=false", 3, 10),
                                  ("train.fused_head_ce=false", 2, 3)):
        counts, ips, peak, loss, first = run_steps(
            parse_overrides(packed_full + [head]), n_warm, n_timed, cuda)
        steps = n_warm + n_timed
        train_runs[head] = (counts, ips, peak)
        print(f"  {head}, {steps} steps: {ips:.2f} img/s, peak {peak:.0f} MiB, loss "
              f"{first:.4f} -> {loss:.4f}; packed launches "
              f"{ {k: counts[k] for k in PER_STEP} }")
        need(loss < first, f"packed training loss falls ({head})")
        for k, n in PER_STEP.items():
            need(counts[k] == steps * n, f"{k} launches == steps x {n} ({head})")
        fused = head == "train.packed_head_ce=false"
        need(counts["head_ce_fwd"] == counts["head_ce_bwd"] == (steps if fused else 0)
             and counts["ce_fwd"] == counts["ce_bwd"] == (0 if fused else steps),
             f"loss kernels of the packed step ({head})")
    counts_t, ips_t, peak_t = train_runs["train.packed_head_ce=false"]
    ips_tu, peak_tu = train_runs["train.fused_head_ce=false"][1:]
    print(f"  train images/s, 512² bf16 batch 8: packed {ips_t:.2f} (peak {peak_t:.0f} MiB), "
          f"standard {ips_f:.2f} (peak {peak_f:.0f} MiB) with the fused head; packed "
          f"{ips_tu:.2f} (peak {peak_tu:.0f} MiB), standard {ips_u:.2f} (peak {peak_u:.0f} MiB) "
          f"with fused_head_ce=false")
    # packed and standard steps in turns, to read their difference
    # against the spread between pairs
    pairs, issue = alternating_pairs({"packed": parse_overrides(packed_full + [
        "train.packed_head_ce=false"]), "standard": parse_overrides(full)}, cuda)
    ratios = [p / q for p, q in zip(pairs["packed"], pairs["standard"])]
    print(f"  alternating pairs, 10 steps each, images/s: packed "
          f"{[round(v, 2) for v in pairs['packed']]}, standard "
          f"{[round(v, 2) for v in pairs['standard']]}; packed / standard "
          f"{[round(r, 4) for r in ratios]}, median {float(np.median(ratios)):.4f}")
    print(f"  host issue per step (card kept busy): packed {issue['packed']:.3f} ms, "
          f"standard {issue['standard']:.3f} ms")
    # the same path through train(): 2 steps, then its evals
    cfg_tr = parse_overrides(packed_full + ["train.packed_head_ce=false",
                                            "data.train_images_per_task=16",
                                            "train.epochs_per_task=1"])
    steps = cfg_tr.data.train_images_per_task // cfg_tr.data.batch_size
    forwards = (int(cfg_tr.train.eval_every_epoch) + 1) * -(-cfg_tr.data.val_images_per_task
                                                           // cfg_tr.data.batch_size)
    reset_counts()
    report = tl.train(cfg_tr)
    counts = read_counts()
    print(f"  train(), packed, {steps} steps and {forwards} eval forwards: mIoU "
          f"{report['final_per_task_miou']}")
    need(np.isfinite(report["final_per_task_miou"]).all(), "finite packed train() mIoU")
    for k, n in PER_STEP.items():
        want = steps * n + forwards * PER_FORWARD.get(k, 0)
        need(counts[k] == want, f"{k} launches == {want} in the packed train()")
    agree_with_cpu(["preset=baseline_1", "model.packed_min_size=0", "train.packed_head_ce=false"],
                   "packed step 128² base 32 depth 4 f32", packed_levels=3)

    print("[5h] the headline step: full width, the packed BN·ReLU + head + CE (#7/#8)")
    # per step: the packed body without its last bn_relu (forward and
    # backward), the packed head once
    headline_step = dict(PER_STEP, bn_relu_fwd=PER_STEP["bn_relu_fwd"] - 1,
                         bn_relu_bwd=PER_STEP["bn_relu_bwd"] - 1,
                         head_ce_bn_fwd=1, head_ce_bn_bwd=1)
    no_other_loss = ("head_ce_fwd", "head_ce_bwd", "ce_fwd", "ce_bwd", "head_ce_kd_bn_fwd",
                     "head_ce_kd_bn_bwd")
    cfg_h = parse_overrides(packed_full)
    counts_h, ips_h, peak_h, loss_h, first_h = run_steps(cfg_h, 3, 10, cuda, no_sync=True)
    print(f"  13 steps: {ips_h:.2f} img/s, peak {peak_h:.0f} MiB, loss {first_h:.4f} -> "
          f"{loss_h:.4f}; launches {counts_h}")
    need(loss_h < first_h, "headline training loss falls")
    for k, n in headline_step.items():
        need(counts_h[k] == 13 * n, f"{k} launches == steps x {n} (headline)")
    need(all(counts_h[k] == 0 for k in no_other_loss), "no other loss kernel (headline)")
    print(f"  beside phase 5t's packed_head_ce=false: {ips_t:.2f} img/s, peak {peak_t:.0f} MiB")
    pairs_h, issue_h = alternating_pairs({"headline": cfg_h, "packed_head_ce=false":
                                          parse_overrides(packed_full + [
                                              "train.packed_head_ce=false"])}, cuda)
    ratios_h = [p / q for p, q in zip(pairs_h["headline"], pairs_h["packed_head_ce=false"])]
    print(f"  alternating pairs, 10 steps each, images/s: headline "
          f"{[round(v, 2) for v in pairs_h['headline']]}, packed_head_ce=false "
          f"{[round(v, 2) for v in pairs_h['packed_head_ce=false']]}; ratio "
          f"{[round(r, 4) for r in ratios_h]}, median {float(np.median(ratios_h)):.4f}")
    print(f"  host issue per step (card kept busy): headline {issue_h['headline']:.3f} ms, "
          f"packed_head_ce=false {issue_h['packed_head_ce=false']:.3f} ms")
    agree_with_cpu(["preset=baseline_1", "model.packed_min_size=0"],
                   "headline step 128² base 32 depth 4 f32", packed_levels=3)

    print("[5l] LwF on the headline step: the teacher's packed forward, the KD head (#11/#12)")
    # per step: the headline step's kernels with the KD head in place of
    # the packed head, and the teacher's eval-mode packed forward
    lwf_step = dict(headline_step, head_ce_bn_fwd=0, head_ce_bn_bwd=0,
                    head_ce_kd_bn_fwd=1, head_ce_kd_bn_bwd=1)
    for k, n in PER_FORWARD.items():
        lwf_step[k] += n - (k == "bn_relu_fwd")
    lwf_full = packed_full + ["method.methods=lwf", "train.num_tasks=2"]
    counts_l, ips_l, peak_l, loss_l, first_l = run_steps(parse_overrides(lwf_full), 3, 10, cuda,
                                                         no_sync=True)
    print(f"  13 steps with a teacher: {ips_l:.2f} img/s, peak {peak_l:.0f} MiB, loss "
          f"{first_l:.4f} -> {loss_l:.4f}; launches {counts_l}")
    print(f"  beside the headline step: {ips_h:.2f} img/s, peak {peak_h:.0f} MiB")
    for k, n in lwf_step.items():
        need(counts_l[k] == 13 * n, f"{k} launches == steps x {n} (LwF)")
    need(all(counts_l[k] == 0 for k in ("head_ce_fwd", "head_ce_bwd", "ce_fwd", "ce_bwd")),
         "no other loss kernel (LwF)")
    agree_with_cpu(["preset=baseline_1", "model.packed_min_size=0", "data.num_classes=3",
                    "train.num_tasks=2", "method.methods=lwf"],
                   "LwF step 128² base 32 depth 4 f32", packed_levels=3)
    cfg_lt = parse_overrides(lwf_full + ["data.train_images_per_task=16",
                                         "train.epochs_per_task=1"])
    steps_lt = cfg_lt.train.num_tasks * cfg_lt.data.train_images_per_task // cfg_lt.data.batch_size
    reset_counts()
    report_l = tl.train(cfg_lt)
    counts_lt = read_counts()
    mat = np.asarray(report_l["miou_matrix"], float)
    print(f"  train(), LwF, 2 tasks, {steps_lt} steps: mIoU matrix {mat.tolist()}, forgetting "
          f"{report_l['forgetting_per_task']}")
    need(np.isfinite(mat[np.tril_indices(2)]).all()
         and np.isfinite(report_l["forgetting_per_task"]).all(), "finite LwF mIoU and forgetting")
    need(counts_lt["head_ce_kd_bn_fwd"] == counts_lt["head_ce_kd_bn_bwd"] == steps_lt
         and counts_lt["head_ce_bn_fwd"] == 0, "KD head launches == steps in the LwF train()")

    print("[5k] LwF off the packed head: the KD head on NHWC features (#9/#10), the KD on "
          "logits (#13/#14)")
    loss_kernels = ("head_ce_fwd", "head_ce_bwd", "head_ce_kd_fwd", "head_ce_kd_bwd",
                    "head_ce_bn_fwd", "head_ce_bn_bwd", "head_ce_kd_bn_fwd", "head_ce_kd_bn_bwd",
                    "ce_fwd", "ce_bwd", "kd_fwd", "kd_bwd")
    # per step: the student's packed body with its last bn_relu (phase 5t's
    # counts), the teacher's eval-mode packed forward, and the route's loss
    # kernels once each
    lwf_routes = {}
    for label, head, loss in (("5k-a the KD head on NHWC features", "train.packed_head_ce=false",
                               ("head_ce_kd_fwd", "head_ce_kd_bwd")),
                              ("5k-b the KD on logits", "train.fused_head_ce=false",
                               ("ce_fwd", "ce_bwd", "kd_fwd", "kd_bwd"))):
        per_step = dict(PER_STEP, **{k: 1 for k in loss})
        for k, n in PER_FORWARD.items():
            per_step[k] += n
        counts, ips, peak, loss_v, first = run_steps(parse_overrides(lwf_full + [head]), 3, 10,
                                                     cuda, no_sync=True)
        lwf_routes[head] = (counts, ips, peak)
        print(f"  {label} ({head}), 13 steps with a teacher: {ips:.2f} img/s, peak "
              f"{peak:.0f} MiB, loss {first:.4f} -> {loss_v:.4f}; launches {counts}")
        need(loss_v < first, f"LwF training loss falls ({head})")
        for k, n in per_step.items():
            need(counts[k] == 13 * n, f"{k} launches == steps x {n} ({head})")
        need(all(counts[k] == 0 for k in loss_kernels if k not in loss),
             f"no other loss kernel ({head})")
    counts_ka, ips_ka, peak_ka = lwf_routes["train.packed_head_ce=false"]
    counts_kb, ips_kb, peak_kb = lwf_routes["train.fused_head_ce=false"]
    print(f"  beside phase 5l's LwF step on the packed KD head: {ips_l:.2f} img/s, peak "
          f"{peak_l:.0f} MiB")
    for head in ("train.packed_head_ce=false", "train.fused_head_ce=false"):
        agree_with_cpu(["preset=baseline_1", "model.packed_min_size=0", "data.num_classes=3",
                        "train.num_tasks=2", "method.methods=lwf", head],
                       f"LwF step {head} 128² base 32 depth 4 f32", packed_levels=3)
    # 5k-c: baseline_2's model with LwF as users set it (UNet-64, 256², 21
    # classes, f32, the device cache; fused_head_ce=auto resolves off: CE
    # #3/#4 and KD #13/#14), cut only to the 2 tasks LwF needs
    report_kc = data_path_train("5k-c baseline_2 with LwF, 2 tasks",
                                ["preset=baseline_2", "method.methods=lwf",
                                 "train.num_tasks=2"])[0]
    # 5k-d: baseline_1 with LwF (128² < packed_min_size: the KD head on NHWC
    # features), train() on the card against train() on the CPU
    lwf_card_vs_cpu(["preset=baseline_1", "data.num_classes=5", "train.num_tasks=2",
                     "method.methods=lwf", "data.train_images_per_task=16",
                     "data.val_images_per_task=8"])

    print("[5m] the methods step: baseline_5 on one card (EWC, LwF on the packed KD head, "
          "device-resident replay)")
    b5 = ["preset=baseline_5", "data.batch_size=8", "method.replay_batch=1", "train.remat=false",
          "train.data_parallel=false", "data.dataset=synthetic", "data.device_cache=false"]
    cfg5 = parse_overrides(b5)
    keep5 = {}
    counts_m, ips_m, peak_m, loss_m, first_m = run_steps(cfg5, 3, 10, cuda, keep=keep5,
                                                         no_sync=True)
    build5 = keep5["build_counts"]
    nf = min(cfg5.data.train_images_per_task // cfg5.data.batch_size,
             cfg5.method.ewc_fisher_batches)
    print(f"  task 0's hooks: Fisher pass of {nf} batches (ewc_sq_acc launches "
          f"{build5['ewc_sq_acc']}), the LwF snapshot, the buffer's fill")
    need(build5["ewc_sq_acc"] == nf and build5["ewc_penalty"] == 0,
         f"the Fisher pass launches ewc_sq_acc {nf} times")
    # per step: the LwF step's kernels, one penalty and its gradient, the
    # gather of the replay rows' images and masks
    methods_step = dict(lwf_step, ewc_penalty=1, ewc_grad=1, ewc_sq_acc=0, replay_gather=2)
    print(f"  13 steps of task 1, 8 + 1 images each: {ips_m:.2f} img/s (fresh images), peak "
          f"{peak_m:.0f} MiB, loss {first_m:.4f} -> {loss_m:.4f}; launches {counts_m}")
    print(f"  beside phase 5l's LwF step: {ips_l:.2f} img/s, peak {peak_l:.0f} MiB")
    need(loss_m < first_m, "the methods step's loss falls")
    for k, n in methods_step.items():
        need(counts_m[k] == 13 * n, f"{k} launches == steps x {n} (methods step)")
    need(all(counts_m[k] == 0 for k in ("head_ce_fwd", "head_ce_bwd", "ce_fwd", "ce_bwd",
                                        "head_ce_bn_fwd", "head_ce_bn_bwd")),
         "no other loss kernel (methods step)")
    # the methods step and the LwF step in turns, to read their difference
    # against the spread between pairs (images/s of the 8 fresh images)
    pairs_m, issue_m = alternating_pairs({"methods": cfg5, "LwF": parse_overrides(lwf_full)},
                                         cuda)
    ratios_m = [p / q for p, q in zip(pairs_m["methods"], pairs_m["LwF"])]
    print(f"  alternating pairs, 10 steps each, images/s: methods "
          f"{[round(v, 2) for v in pairs_m['methods']]}, LwF "
          f"{[round(v, 2) for v in pairs_m['LwF']]}; ratio {[round(r, 4) for r in ratios_m]}, "
          f"median {float(np.median(ratios_m)):.4f}")
    print(f"  host issue per step (card kept busy): methods {issue_m['methods']:.3f} ms, "
          f"LwF {issue_m['LwF']:.3f} ms (over ~1,000 launches a step each: the launch "
          f"queue fills while the card sleeps, so ~100 ms is the sleep, not the host)")
    print("  one step of each of 5h, 5l and 5m under sync debug mode 'error': no sync")
    agree_with_cpu(["preset=baseline_1", "model.packed_min_size=0", "data.num_classes=3",
                    "train.num_tasks=2", "method.methods=ewc,lwf,replay",
                    "method.replay_device_resident=true", "method.replay_batch=1"],
                   "methods step 128² base 32 depth 4 f32", packed_levels=3)
    # train() on the data path as the presets ship it (the native rasterizer,
    # the device-resident dataset); the timed steps above keep their
    # prebuilt host batch
    small = ["data.train_images_per_task=16", "data.val_images_per_task=8"]
    b5_train = [a for a in b5 if a not in ("data.dataset=synthetic", "data.device_cache=false")]
    keep_cut = {}
    methods_train("baseline_5 cut, 3 tasks", b5_train + small + ["train.num_tasks=3",
                                                                 "train.epochs_per_task=1"],
                  keep=keep_cut)
    methods_train("baseline_3, 16 + 8 images a task", ["preset=baseline_3"] + small)

    bitwise = phase_5r(cfg_h, b5_train, small)
    # baseline_5 as it ships: remat on, 64 + 8 images a step, the whole run
    print("[5m] baseline_5 as it ships through train() (train.remat=true, 64 + 8 images a "
          "step; train.data_parallel=true on one card: one process)")
    report_b5, peaks_b5 = baseline_5_as_it_ships()
    phase_5x(cfg_h, headline_step)
    phase_5w()
    ips_n = phase_5n(ips_f, peak_f)
    phase_5s()
    report_e = phase_5e(b5_train, small, keep_cut["counts"], report_b5, bitwise, cfg_h,
                        headline_step)
    phase_5y()

    print("[5d] the data path: baselines 2, 3 and 4 as they ship through train() (the "
          "native rasterizer, the device-resident dataset, plan-driven epochs)")
    runs_d = {}
    for label, args in (("baseline_2 as it ships", ["preset=baseline_2"]),
                        ("baseline_3 as it ships", ["preset=baseline_3"]),
                        ("baseline_4 as it ships, train.pallas_augment=true",
                         ["preset=baseline_4", "train.pallas_augment=true"])):
        runs_d[label.split()[0]] = data_path_train(label, args)
    counts_b4 = runs_d["baseline_4"][1]
    # the host pipeline beside the plan: numpy rasterization in a prefetch
    # thread, one pinned copy a step
    t0 = time.perf_counter()
    report_h = tl.train(parse_overrides(["preset=baseline_3", "data.device_cache=false",
                                         "data.dataset=synthetic"]))
    wall_h = time.perf_counter() - t0
    need(np.isfinite(report_h["final_per_task_miou"]).all(), "finite mIoU (host pipeline)")
    ips_c = runs_d["baseline_3"][0].get("images_per_sec_per_chip")
    ips_hp = report_h.get("images_per_sec_per_chip")
    print(f"  baseline_3 train() images/s: as it ships (device cache, native) {ips_c} in "
          f"{runs_d['baseline_3'][2]:.1f} s; host pipeline (data.device_cache=false "
          f"data.dataset=synthetic) {ips_hp} in {wall_h:.1f} s; mIoU {report_h['miou_matrix']}")
    augment_routes_agree(cuda)
    fisher_card_vs_cpu(cuda)

    print("[5v] the gen-3 conv on the standard body (model.conv_impl=auto|v3: #30, #31) and "
          "the packed conv's two-pass backward (#33)")
    # 5v-a: baseline_2 with conv_impl=auto as it ships through train(): the
    # 256² level's three convs (enc0.conv1 per conv, dec0 packed)
    args_a = ["preset=baseline_2", "model.conv_impl=auto"]
    n_a = v3_convs(parse_overrides(args_a))
    need(n_a == 3, f"conv_impl=auto routes 3 convs of baseline_2, not {n_a}")
    report_va, counts_va, wall_va, peak_va, steps_va = data_path_train(
        "5v-a baseline_2 model.conv_impl=auto as it ships", args_a)
    v3_counts_ok(counts_va, "5v-a", n_a * (steps_va["train"] + steps_va["eval"]),
                 n_a * steps_va["train"])
    report_b2, _, wall_b2, peak_b2, _ = runs_d["baseline_2"]
    print(f"  baseline_2 train() images/s: conv_impl=auto "
          f"{report_va.get('images_per_sec_per_chip')} (peak {peak_va:.0f} MiB, {wall_va:.1f} "
          f"s), xla {report_b2.get('images_per_sec_per_chip')} (peak {peak_b2:.0f} MiB, "
          f"{wall_b2:.1f} s, phase 5d); mIoU auto {report_va['final_per_task_miou']}, xla "
          f"{report_b2['final_per_task_miou']}")
    # 5v-b: conv_impl=v3 in bf16: every conv the gate admits, at every level
    host = ["data.dataset=synthetic", "data.device_cache=false"]
    args_b = V3B_ARGS + host
    cfg_b = parse_overrides(args_b)
    n_b = v3_convs(cfg_b)
    counts_vb, ips_vb, peak_vb, loss_vb, first_vb = run_steps(cfg_b, 3, 10, cuda, no_sync=True)
    print(f"  5v-b baseline_2 conv_impl=v3 bf16, 13 steps ({n_b} v3 convs): {ips_vb:.2f} img/s, "
          f"peak {peak_vb:.0f} MiB, loss {first_vb:.4f} -> {loss_vb:.4f}")
    v3_counts_ok(counts_vb, "5v-b", 13 * n_b, 13 * n_b)
    cfg_bx = parse_overrides([a if a != "model.conv_impl=v3" else "model.conv_impl=xla"
                              for a in args_b])
    pairs_v, issue_v = alternating_pairs({"v3": cfg_b, "xla": cfg_bx}, cuda)
    ratios_v = [p / q for p, q in zip(pairs_v["v3"], pairs_v["xla"])]
    print(f"  alternating pairs, 10 steps each, images/s: v3 "
          f"{[round(v, 2) for v in pairs_v['v3']]}, xla {[round(v, 2) for v in pairs_v['xla']]}; "
          f"v3 / xla {[round(r, 4) for r in ratios_v]}, median {float(np.median(ratios_v)):.4f}; "
          f"host issue v3 {issue_v['v3']:.3f} ms, xla {issue_v['xla']:.3f} ms")
    # 5v-c: the packed body at 256², base 64, f32 (model.packed_min_size=0):
    # level 2's two 256 -> 256 convs with the prologue take the two-pass
    # backward, #30 for dt and #33 for dW in place of the fused dx and dW
    cfg_c = parse_overrides(["preset=baseline_2", "model.packed_min_size=0"] + host)
    counts_vc, ips_vc, peak_vc, loss_vc, first_vc = run_steps(cfg_c, 3, 10, cuda, no_sync=True)
    two_pass_step = dict(PER_STEP, conv3x3_bn_dx_bn=PER_STEP["conv3x3_bn_dx_bn"] - 2,
                         conv3x3_bn_dw=PER_STEP["conv3x3_bn_dw"] - 2, ce_fwd=1, ce_bwd=1)
    print(f"  5v-c baseline_2 model.packed_min_size=0 (f32), 13 steps: {ips_vc:.2f} img/s, "
          f"peak {peak_vc:.0f} MiB, loss {first_vc:.4f} -> {loss_vc:.4f}; packed launches "
          f"{ {k: counts_vc[k] for k in two_pass_step} }")
    for k, n in two_pass_step.items():
        need(counts_vc[k] == 13 * n, f"{k} launches == steps x {n} (5v-c)")
    v3_counts_ok(counts_vc, "5v-c", 0, 0, dt=26, dw_bn=26)
    # 5v-d: baseline_1 with conv_impl=v3 (128² f32: every conv but the stem,
    # both routes), one SGD step on the card against the CPU
    reset_counts()
    agree_with_cpu(["preset=baseline_1", "model.conv_impl=v3"],
                   "baseline_1 model.conv_impl=v3 128² f32", f64=True)
    n_d = v3_convs(parse_overrides(["preset=baseline_1", "model.conv_impl=v3"]))
    v3_counts_ok(read_counts(), "5v-d", n_d, n_d)
    # 5v-e: the config cl_tpu fails is refused before training
    try:
        tl.check_supported(parse_overrides(["preset=baseline_2", "model.conv_impl=v3"]), cuda)
    except NotImplementedError as exc:
        print(f"  5v-e preset=baseline_2 model.conv_impl=v3 (f32) refused: {exc}")
    else:
        need(False, "preset=baseline_2 model.conv_impl=v3 (f32) is refused")

    print("[5q] int8 saved activations of the packed convs (model.conv_act_store=int8: 32q, "
          "#38, #39)")
    from cl_tpu_torch.profile_step import profile as profile_step

    # 5q-a: the headline step with int8: every packed conv at 512² qualifies
    cfg_q = parse_overrides(packed_full + ["model.conv_act_store=int8"])
    q_step = dict(headline_step, conv3x3_bn_dx=0, conv3x3_bn_dx_bn=0, conv3x3_bn_dw=0,
                  **Q_PER_STEP)
    counts_q, ips_q, peak_q, loss_q, first_q = run_steps(cfg_q, 3, 10, cuda, no_sync=True)
    print(f"  5q-a headline int8, 13 steps: {ips_q:.2f} img/s, peak {peak_q:.0f} MiB, loss "
          f"{first_q:.4f} -> {loss_q:.4f}; beside the headline (dtype, phase 5h) {ips_h:.2f} "
          f"img/s, peak {peak_h:.0f} MiB")
    print(f"    launches per step: { {k: counts_q[k] / 13 for k in q_step} }")
    need(loss_q < first_q, "int8 headline training loss falls")
    for k, n in q_step.items():
        need(counts_q[k] == 13 * n, f"{k} launches == steps x {n} (5q-a)")
    saved_q = {name: saved_set_mib(c, cuda) for name, c in (("int8", cfg_q), ("dtype", cfg_h))}
    print(f"    saved for the backward of one forward to the raw features, MiB by dtype, and "
          f"the peak MiB at its end and over a backward from it: {saved_q}")
    prof_q = {name: profile_step(c, steps=5)
              for name, c in (("int8", cfg_q), ("dtype", cfg_h))}
    for name, res in prof_q.items():
        fams = {k: round(v, 3) for k, v in res["families_ms_per_step"].items()}
        print(f"    profile {name}: {res['ms_per_step']:.3f} ms/step unprofiled "
              f"({res['images_per_s']:.2f} img/s), {res['device_ms_per_step']:.3f} ms of "
              f"kernels ({res['kernels_per_step']:.0f} launches), idle {res['idle_share']:.3f}; "
              f"{fams}")
    pairs_q, issue_q = alternating_pairs({"int8": cfg_q, "dtype": cfg_h}, cuda)
    ratios_q = [u / v for u, v in zip(pairs_q["int8"], pairs_q["dtype"])]
    print(f"  alternating pairs, 10 steps each, images/s: int8 "
          f"{[round(v, 2) for v in pairs_q['int8']]}, dtype "
          f"{[round(v, 2) for v in pairs_q['dtype']]}; int8 / dtype "
          f"{[round(r, 4) for r in ratios_q]}, median {float(np.median(ratios_q)):.4f}; host "
          f"issue int8 {issue_q['int8']:.3f} ms, dtype {issue_q['dtype']:.3f} ms")
    # 5q-b: one SGD step card vs CPU at 128² f32: level 0 int8 (wg 32),
    # levels 1-2 in the compute dtype
    reset_counts()
    args_qb = ["preset=baseline_1", "model.packed_min_size=0", "model.conv_act_store=int8"]
    agree_with_cpu(args_qb, "int8 step 128² base 32 depth 4 f32", packed_levels=3)
    counts_qb = read_counts()
    want_qb = {"conv3x3_bn_quant": 5, "conv3x3_bn_dx_q": 4, "conv3x3_bn_dw_q": 5}
    print(f"    int8 launches on the card: { {k: counts_qb[k] for k in want_qb} }")
    need(all(counts_qb[k] == n for k, n in want_qb.items()), "int8 launches (5q-b)")
    # 5q-c: train() with EWC: the Fisher pass's eval-mode backward takes the
    # int8 route too
    args_qc = args_qb + ["data.num_classes=3", "train.num_tasks=2", "method.methods=ewc"]
    cfg_qc = parse_overrides(args_qc)
    reset_counts()
    report_qc = tl.train(cfg_qc)
    counts_qc = read_counts()
    T = cfg_qc.train.num_tasks
    per_task = (cfg_qc.data.train_images_per_task // cfg_qc.data.batch_size
                * cfg_qc.train.epochs_per_task)
    n_fisher = min(cfg_qc.data.train_images_per_task // cfg_qc.data.batch_size,
                   cfg_qc.method.ewc_fisher_batches)
    backwards = T * per_task + (T - 1) * n_fisher
    mat_qc = np.asarray(report_qc["miou_matrix"], float)
    print(f"  5q-c {' '.join(args_qc)}: mIoU matrix {mat_qc.tolist()}, forgetting "
          f"{report_qc['forgetting_per_task']}; {backwards} backwards ({T * per_task} steps, "
          f"{(T - 1) * n_fisher} Fisher batches): int8 launches "
          f"{ {k: counts_qc[k] for k in want_qb} }, #19 {counts_qc['ewc_sq_acc']}")
    need(np.isfinite(mat_qc[np.tril_indices(T)]).all()
         and np.isfinite(report_qc["forgetting_per_task"]).all(), "finite mIoU (5q-c)")
    need(all(counts_qc[k] == n * backwards for k, n in want_qb.items())
         and counts_qc["ewc_sq_acc"] == (T - 1) * n_fisher, "int8 launches (5q-c)")
    # 5q-d: the fallback: baseline_2's packed body (256², base 64, f32),
    # every conv int8 (P = 2: wg 128, 64, 32); level 2's prologue convs find
    # no fused tile and dequantize into the two-pass backward (#30, #33)
    cfg_qd = parse_overrides(["preset=baseline_2", "model.packed_min_size=0",
                              "model.conv_act_store=int8"] + host)
    counts_qd, ips_qd, peak_qd, loss_qd, first_qd = run_steps(cfg_qd, 3, 10, cuda,
                                                              no_sync=True)
    want_qd = {"conv3x3_bn_fwd": 15, "conv3x3_bn_quant": 15, "conv3x3_bn_dx_q": 12,
               "conv3x3_bn_dw_q": 13, "conv3x3_dt": 2, "conv3x3_dw_bn": 2,
               "conv3x3_bn_dx": 0, "conv3x3_bn_dx_bn": 0, "conv3x3_bn_dw": 0}
    print(f"  5q-d baseline_2 packed_min_size=0 int8 (f32), 13 steps: {ips_qd:.2f} img/s "
          f"(dtype, 5v-c: {ips_vc:.2f}), peak {peak_qd:.0f} MiB (dtype {peak_vc:.0f}), loss "
          f"{first_qd:.4f} -> {loss_qd:.4f}; launches per step "
          f"{ {k: counts_qd[k] / 13 for k in want_qd} } (#30 as dt, #33: the fallback)")
    for k, n in want_qd.items():
        need(counts_qd[k] == 13 * n, f"{k} launches == steps x {n} (5q-d)")

    print("[5f] the packed conv's backward under CL_TPU_FUSE_BWD (#37) and CL_TPU_DX_PIPE "
          "(34p/35p); the packed head without its prologue (#5/#6)")
    settings = {"default": (False, False), "FUSE_BWD": (True, False), "DX_PIPE": (False, True),
                "both": (True, True)}
    # per step: the headline step's kernels, the backward's routed by the
    # switches (every conv one-pass under FUSE_BWD, the 14 dx pipelined
    # under DX_PIPE alone)
    no_bwd = dict(conv3x3_bn_dx=0, conv3x3_bn_dx_bn=0, conv3x3_bn_dw=0, conv3x3_bn_bwd_fused=0,
                  conv3x3_bn_dx_pipe=0, conv3x3_bn_dx_bn_pipe=0)
    fused_step = dict(headline_step, **dict(no_bwd, conv3x3_bn_bwd_fused=15))
    pipe_step = dict(headline_step, **dict(
        no_bwd, conv3x3_bn_dw=headline_step["conv3x3_bn_dw"],
        conv3x3_bn_dx_pipe=headline_step["conv3x3_bn_dx"],
        conv3x3_bn_dx_bn_pipe=headline_step["conv3x3_bn_dx_bn"]))
    runs_f = {}
    # the default again here, so that the peaks compare in one allocator state
    for name, want in (("default", dict(headline_step, **{k: headline_step.get(k, 0)
                                                          for k in no_bwd})),
                       ("FUSE_BWD", fused_step), ("DX_PIPE", pipe_step), ("both", fused_step)):
        with switched(*settings[name]):
            counts, ips, peak, loss, first = run_steps(cfg_h, 3, 10, cuda, no_sync=True)
        runs_f[name] = (counts, ips, peak)
        print(f"  5f-a headline step under {name}, 13 steps: {ips:.2f} img/s, peak {peak:.0f} MiB, "
              f"loss {first:.4f} -> {loss:.4f}; backward launches per step "
              f"{ {k: counts[k] / 13 for k in no_bwd} }")
        need(loss < first, f"headline training loss falls ({name})")
        for k, n in want.items():
            need(counts[k] == 13 * n, f"{k} launches == steps x {n} (5f-a, {name})")
    print(f"    beside the headline step (default, phase 5h): {ips_h:.2f} img/s, peak "
          f"{peak_h:.0f} MiB")
    prof_f = {}
    for name in ("default", "FUSE_BWD", "DX_PIPE"):
        with switched(*settings[name]):
            prof_f[name] = profile_step(cfg_h, steps=5)
        res = prof_f[name]
        fams = {k: round(v, 3) for k, v in res["families_ms_per_step"].items()}
        print(f"    profile {name}: {res['ms_per_step']:.3f} ms/step unprofiled "
              f"({res['images_per_s']:.2f} img/s), {res['device_ms_per_step']:.3f} ms of "
              f"kernels ({res['kernels_per_step']:.0f} launches), idle {res['idle_share']:.3f}; "
              f"{fams}")
    dev_ms = {name: res["device_ms_per_step"] for name, res in prof_f.items()}
    print(f"    DX_PIPE's kernel ms a step / the default's: "
          f"{dev_ms['DX_PIPE'] / dev_ms['default']:.4f}")
    pairs_f, issue_f = alternating_pairs({name: cfg_h for name in settings}, cuda,
                                         switches=settings)
    ratios_f = {name: [u / v for u, v in zip(pairs_f[name], pairs_f["default"])]
                for name in settings if name != "default"}
    print(f"  alternating pairs, 10 steps each, images/s: "
          + "; ".join(f"{name} {[round(v, 2) for v in pairs_f[name]]}" for name in settings))
    for name, r in ratios_f.items():
        print(f"    {name} / default {[round(v, 4) for v in r]}, median "
              f"{float(np.median(r)):.4f}; host issue {issue_f[name]:.3f} ms (default "
              f"{issue_f['default']:.3f} ms)")
    # 5f-b: one SGD step under FUSE_BWD on the card against the CPU at 128²
    # f32 (3 packed levels, every conv one-pass: #37's f32 instance)
    reset_counts()
    with switched(True, False):
        agree_with_cpu(["preset=baseline_1", "model.packed_min_size=0"],
                       "FUSE_BWD step 128² base 32 depth 4 f32", packed_levels=3)
    counts_fb = read_counts()
    print(f"    launches on the card: { {k: counts_fb[k] for k in no_bwd} }")
    need(counts_fb["conv3x3_bn_bwd_fused"] == 15
         and all(counts_fb[k] == 0 for k in no_bwd if k != "conv3x3_bn_bwd_fused"),
         "15 one-pass launches, no other conv backward (5f-b)")
    # 5f-c: baseline_2's packed body through train() under FUSE_BWD: level
    # 2's prologue convs, two-pass by default (5v-c), take #37 with the rest
    with switched(True, False):
        report_fc, counts_fc, wall_fc, peak_fc, steps_fc = data_path_train(
            "5f-c preset=baseline_2 model.packed_min_size=0 under FUSE_BWD",
            ["preset=baseline_2", "model.packed_min_size=0"])
    print(f"    backward launches {({k: counts_fc[k] for k in no_bwd})}, two-pass "
          f"{ {k: counts_fc[k] for k in ('conv3x3_dt', 'conv3x3_dw_bn')} } over "
          f"{steps_fc['train']} steps; peak {peak_fc:.0f} MiB")
    need(counts_fc["conv3x3_bn_bwd_fused"] == 15 * steps_fc["train"]
         and counts_fc["conv3x3_dt"] == counts_fc["conv3x3_dw_bn"] == 0
         and all(counts_fc[k] == 0 for k in no_bwd if k != "conv3x3_bn_bwd_fused"),
         "every packed conv one-pass in baseline_2's train() (5f-c)")
    # 5f-d: the packed head without its prologue (#5/#6), as a user reaches
    # it: head_cross_entropy_packed on bn_relu of the headline body's raw
    # output, 3 optimizer steps; its loss beside head_cross_entropy_packed_bn's
    counts_pk, losses_pk, (loss_c, loss_bn) = packed_head_steps(cfg_h, cuda)
    print(f"  5f-d head_cross_entropy_packed(bn_relu(raw)), 3 steps: losses "
          f"{[round(v, 5) for v in losses_pk]}; launches "
          f"{ {k: counts_pk[k] for k in ('head_ce_pk_fwd', 'head_ce_pk_bwd', 'bn_relu_fwd', 'bn_relu_bwd', 'head_ce_bn_fwd')} }; "
          f"on the last features {loss_c!r} against head_cross_entropy_packed_bn's {loss_bn!r}")
    need(counts_pk["head_ce_pk_fwd"] == counts_pk["head_ce_pk_bwd"] == 3
         and counts_pk["head_ce_bn_fwd"] == 0, "#5/#6 launched once a step (5f-d)")
    need(all(np.isfinite(losses_pk)) and abs(loss_c - loss_bn) <= 1e-5 * abs(loss_bn),
         "the composition's loss equals the packed head's within 1e-5 (5f-d)")

    print("[5g] the gen-2 conv on the standard body (model.conv_impl=pallas|hybrid: #40, #41) "
          "and the matmul up-conv (model.upconv_impl=matmul)")
    # 5g-a: baseline_2 with conv_impl=pallas as it ships through train():
    # 17 of the 18 convs (not the stem) forward, dx and dW through gen-2
    args_ga = ["preset=baseline_2", "model.conv_impl=pallas"]
    n_g = g2_convs(parse_overrides(args_ga))
    need(n_g == 17, f"conv_impl=pallas routes 17 convs of baseline_2, not {n_g}")
    report_ga, counts_ga, wall_ga, peak_ga, steps_ga = data_path_train(
        "5g-a baseline_2 model.conv_impl=pallas as it ships", args_ga)
    g2_counts_ok(counts_ga, "5g-a", n_g * (steps_ga["train"] + steps_ga["eval"]),
                 n_g * steps_ga["train"], n_g * steps_ga["train"])
    print(f"  baseline_2 train() images/s: conv_impl=pallas "
          f"{report_ga.get('images_per_sec_per_chip')} (peak {peak_ga:.0f} MiB, {wall_ga:.1f} "
          f"s), xla {report_b2.get('images_per_sec_per_chip')} (peak {peak_b2:.0f} MiB, "
          f"{wall_b2:.1f} s, phase 5d); mIoU pallas {report_ga['final_per_task_miou']}, xla "
          f"{report_b2['final_per_task_miou']}")
    # 5g-b: conv_impl=hybrid (cuDNN forward and dx, #41 for the 17 dW the
    # gate admits, cuDNN's for the stem), 3 + 10 steps on one batch; then
    # five pairs of pallas, hybrid and xla in turns
    cfg_gb = parse_overrides(["preset=baseline_2", "model.conv_impl=hybrid"] + host)
    counts_gb, ips_gb, peak_gb, loss_gb, first_gb = run_steps(cfg_gb, 3, 10, cuda, no_sync=True)
    print(f"  5g-b baseline_2 conv_impl=hybrid f32, 13 steps: {ips_gb:.2f} img/s, peak "
          f"{peak_gb:.0f} MiB, loss {first_gb:.4f} -> {loss_gb:.4f}")
    g2_counts_ok(counts_gb, "5g-b", 0, 0, 13 * n_g)
    cfgs_g = {impl: parse_overrides(["preset=baseline_2", f"model.conv_impl={impl}"] + host)
              for impl in ("pallas", "hybrid", "xla")}
    pairs_g, issue_g = alternating_pairs(cfgs_g, cuda)
    print("  alternating turns, 10 steps each, images/s: " + "; ".join(
        f"{k} {[round(v, 2) for v in pairs_g[k]]} (median {float(np.median(pairs_g[k])):.2f}, "
        f"host issue {issue_g[k]:.3f} ms)" for k in cfgs_g))
    for k in ("pallas", "hybrid"):
        r = [p / q for p, q in zip(pairs_g[k], pairs_g["xla"])]
        print(f"    {k} / xla {[round(v, 4) for v in r]}, median {float(np.median(r)):.4f}")
    # 5g-c: the 512² bf16 standard body (phase 5's config) under pallas: the
    # bf16 tensor-core instances at p = 4
    cfg_gc = parse_overrides(full + ["model.conv_impl=pallas"])
    n_gc = g2_convs(cfg_gc)
    counts_gc, ips_gc, peak_gc, loss_gc, first_gc = run_steps(cfg_gc, 3, 10, cuda, no_sync=True)
    print(f"  5g-c 512² bf16 standard body, conv_impl=pallas, 13 steps ({n_gc} gen-2 convs): "
          f"{ips_gc:.2f} img/s, peak {peak_gc:.0f} MiB, loss {first_gc:.4f} -> {loss_gc:.4f}")
    g2_counts_ok(counts_gc, "5g-c", 13 * n_gc, 13 * n_gc, 13 * n_gc)
    need(loss_gc < first_gc, "the loss falls (5g-c)")
    pairs_gc, issue_gc = alternating_pairs({"pallas": cfg_gc, "xla": parse_overrides(full)}, cuda)
    ratios_gc = [p / q for p, q in zip(pairs_gc["pallas"], pairs_gc["xla"])]
    print(f"  alternating pairs, 10 steps each, images/s: pallas "
          f"{[round(v, 2) for v in pairs_gc['pallas']]}, xla "
          f"{[round(v, 2) for v in pairs_gc['xla']]}; pallas / xla "
          f"{[round(r, 4) for r in ratios_gc]}, median {float(np.median(ratios_gc)):.4f}; host "
          f"issue pallas {issue_gc['pallas']:.3f} ms, xla {issue_gc['xla']:.3f} ms")
    # 5g-d: baseline_1 with conv_impl=pallas (128² f32: every conv but the
    # stem, the up-convs as UpConv2x2), one SGD step on the card against
    # the CPU, each update against float64
    reset_counts()
    agree_with_cpu(["preset=baseline_1", "model.conv_impl=pallas"],
                   "baseline_1 model.conv_impl=pallas 128² f32", f64=True)
    n_gd = g2_convs(parse_overrides(["preset=baseline_1", "model.conv_impl=pallas"]))
    g2_counts_ok(read_counts(), "5g-d", n_gd, n_gd, n_gd)
    # 5g-e: model.upconv_impl=matmul alone on baseline_2, one step from the
    # same seeded init and batch as xla's: no gen-2 launch, the same loss
    losses_ge = {}
    for impl in ("matmul", "xla"):
        cfg_ge = parse_overrides(["preset=baseline_2", f"model.upconv_impl={impl}"] + host)
        model, opt, step, batch, valid = build_step(cfg_ge, cuda)
        need(model.upconv_matmul == (impl == "matmul"), f"the up-conv route ({impl}, 5g-e)")
        reset_counts()
        losses_ge[impl] = step(batch, valid)["loss"].item()
        g2_counts_ok(read_counts(), f"5g-e upconv_impl={impl}", 0, 0, 0)
        del model, opt, step
    print(f"  5g-e baseline_2 one step, loss: upconv_impl=matmul {losses_ge['matmul']!r}, xla "
          f"{losses_ge['xla']!r}")
    need(abs(losses_ge["matmul"] - losses_ge["xla"]) <= 1e-5 * abs(losses_ge["xla"]),
         "the matmul up-conv's loss equals the transposed conv's within 1e-5 (5g-e)")

    counts_b, ips_b, peak_b, l3_errs = phase_5b(cfg_h, headline_step)
    counts_e, ips_e, peak_e, one_e = phase_5u(
        cfg_h, cfg_q, headline_step, ips_h, peak_h,
        {"int8": q_step, "FUSE_BWD": fused_step, "DX_PIPE": pipe_step,
         "22 MiB": {k: v // 13 for k, v in counts_b.items()}})

    print("[6] kernel times (median of 20, CUDA events)")
    launches = {  # the path each case's shape comes from
        0: counts_b1, 1: counts_f, 2: counts_b1u, 3: counts_u}
    replaces = {"head_ce_fwd": "cl_tpu/pallas/head_ce.py:165",
                "head_ce_bwd": "cl_tpu/pallas/head_ce.py:190",
                "ce_fwd": "cl_tpu/pallas/ce_loss.py:118",
                "ce_bwd": "cl_tpu/pallas/ce_loss.py:140"}
    kernels = []
    for i, case in enumerate(cases):
        times = kernel_times(case)
        for which in ("fwd", "bwd"):
            ms, plain_ms, lib_ms = times[which]
            key = f"{case['kind']}_{which}"
            entry = json_entry(
                case_name(case, which),
                f"cl_tpu_torch/csrc/{'head_ce' if case['kind'] == 'head_ce' else 'ce_loss'}.cu",
                replaces[key], launches[i][key], errs[i][which], times[which],
                bytes_ops(case, which), peak=case["dtype"])
            kernels.append(entry)
            print(f"  {entry['name']}: {ms:.4f} ms (plain {plain_ms:.4f}, library "
                  f"{lib_ms:.4f}, bound {entry['bound_ms']:.4f} by "
                  f"{entry['bound_by']}); launches {entry['launches']}")
    per_step_ms = {}
    for kernel, shapes in PACKED_PATH.items():
        fwd = kernel in FORWARD_KERNELS
        # launches: the forward kernels' of the packed eval pass (phase
        # 5p), the backward kernels' of the packed train run (phase 5t)
        launches = counts_p[kernel] if fwd else counts_t[kernel]
        for shape, n_step in shapes:
            times = (packed_times if fwd else bwd_times)(kernel, shape)
            entry = kernel_entry(
                kernel, shape, *PACKED_KERNELS[kernel], launches, packed_errs[(kernel, shape)],
                times, (packed_bytes_ops if fwd else bwd_bytes_ops)(kernel, shape, "bfloat16"))
            kernels.append(entry)
            acc = per_step_ms.setdefault(kernel, [0.0] * 5)
            for i, v in enumerate((entry["ms"], entry["plain_ms"], entry["bound_ms"],
                                   entry["library_ms"] or 0.0, times[3])):
                acc[i] += n_step * v
            lib_txt = "—" if entry["library_ms"] is None else f"{entry['library_ms']:.4f}"
            print(f"  {entry['name']} x{n_step}/step: {entry['ms']:.4f} ms (synchronised per "
                  f"launch {times[3]:.4f}; plain {entry['plain_ms']:.4f}, library {lib_txt}, "
                  f"bound {entry['bound_ms']:.4f} by {entry['bound_by']})")
    for kernel, (ms, plain_ms, bound_ms, lib_ms, synced_ms) in per_step_ms.items():
        print(f"  per packed train step, {kernel}: {ms:.4f} ms (synchronised per launch "
              f"{synced_ms:.4f}), plain {plain_ms:.4f}, bound {bound_ms:.4f}, library "
              f"{lib_ms:.4f} (where one exists); launches {counts_t[kernel]} in phase 5t"
              + (f", {counts_p[kernel]} in phase 5p" if kernel in FORWARD_KERNELS else ""))
    # level 3 of the headline at a 22 MiB budget (phase 5b-a): each kernel
    # at its level-3 shapes, launches there beside the default's
    for kernel, shapes in LEVEL3_PATH.items():
        fwd = kernel in FORWARD_KERNELS
        for shape, n_step in shapes:
            times = (packed_times if fwd else bwd_times)(kernel, shape)
            bo = (packed_bytes_ops if fwd else bwd_bytes_ops)(kernel, shape, "bfloat16")
            bound = max(bo[0] / HBM_BYTES_PER_S, bo[1] / PEAK_OPS["bfloat16"]) * 1e3
            lib_txt = "—" if times[2] is None else f"{times[2]:.4f}"
            print(f"  level 3 at 22 MiB, {packed_name(kernel, shape, 'bfloat16')} x{n_step}/step: "
                  f"{times[0]:.4f} ms (synchronised per launch {times[3]:.4f}; plain "
                  f"{times[1]:.4f}, library {lib_txt}, bound {bound:.4f}); err "
                  f"{l3_errs[(kernel, shape)]:.3g}; launches {counts_b[kernel]} in phase 5b-a's "
                  f"13 steps, {13 * headline_step[kernel]} at the default (5h)")
    for kernel, (shape, key, n_step) in LEVEL3_TWO_PASS.items():
        times = v3_times(kernel, shape, "bfloat16")
        bo = v3_bytes_ops(kernel, shape, "bfloat16")
        bound = max(bo[0] / HBM_BYTES_PER_S, bo[1] / PEAK_OPS["bfloat16"]) * 1e3
        print(f"  level 3 at 22 MiB, two-pass {v3_name(kernel, shape, 'bfloat16')} "
              f"x{n_step}/step: {times[0]:.4f} ms (synchronised per launch {times[3]:.4f}; "
              f"plain {times[1]:.4f}, library {times[2]:.4f}, bound {bound:.4f}); launches "
              f"{counts_b[key]} ({key}) in phase 5b-a, 0 at the default")
    for kernel, (source, replaces) in BN_KERNELS.items():
        times = bn_times(kernel, bn_full)
        launches = (counts_l if "kd" in kernel else counts_h)[kernel]
        entry = kernel_entry(kernel, (2097152, 32, 19), source, replaces, launches,
                             bn_errs[kernel], times, bn_bytes_ops(kernel, bn_full))
        kernels.append(entry)
        print(f"  {entry['name']}: {entry['ms']:.4f} ms (synchronised per launch "
              f"{times[3]:.4f}; plain {entry['plain_ms']:.4f}, library "
              f"{entry['library_ms']:.4f} (head and CE only), bound {entry['bound_ms']:.4f} by "
              f"{entry['bound_by']}); launches {launches} in phase "
              f"{'5l' if 'kd' in kernel else '5h'}")
    for kernel, (source, replaces) in KD_HEAD_KERNELS.items():
        times = bn_times(kernel, kdh_full)
        entry = kernel_entry(kernel, (2097152, 32, 19), source, replaces, counts_ka[kernel],
                             kdh_errs[kernel], times, bn_bytes_ops(kernel, kdh_full))
        kernels.append(entry)
        print(f"  {entry['name']}: {entry['ms']:.4f} ms (synchronised per launch "
              f"{times[3]:.4f}; plain {entry['plain_ms']:.4f}, library "
              f"{entry['library_ms']:.4f} (head and CE only), bound {entry['bound_ms']:.4f} by "
              f"{entry['bound_by']}); launches {entry['launches']} in phase 5k-a")
    for kernel, (source, replaces) in KD_KERNELS.items():
        times = kd_times(kernel, kdl_full)
        entry = json_entry(kd_name(kernel, kdl_full), source, replaces, counts_kb[kernel],
                           kdl_errs[kernel], times, kd_bytes_ops(kernel, kdl_full))
        kernels.append(entry)
        lib_txt = "—" if entry["library_ms"] is None else \
            f"{entry['library_ms']:.4f} (F.kl_div of the log-softmaxes)"
        print(f"  {entry['name']}: {entry['ms']:.4f} ms (synchronised per launch "
              f"{times[3]:.4f}; plain {entry['plain_ms']:.4f}, library {lib_txt}, bound "
              f"{entry['bound_ms']:.4f} by {entry['bound_by']}); launches {entry['launches']} "
              f"in phase 5k-b")
    for kernel in ("ewc_penalty", "ewc_grad", "ewc_sq_acc"):
        times = methods_times(kernel, n=n5)
        # the Fisher pass's launches (phase 5m's set-up), the others' of its steps
        launches = (build5 if kernel == "ewc_sq_acc" else counts_m)[kernel]
        entry = methods_entry(kernel, f"{kernel} [n={n5} f32]", launches, ewc_errs[kernel],
                              times, methods_bytes_ops(kernel, n=n5))
        kernels.append(entry)
        lib_txt = "—" if entry["library_ms"] is None else f"{entry['library_ms']:.4f}"
        print(f"  {entry['name']}: {entry['ms']:.4f} ms (synchronised per launch "
              f"{times[3]:.4f}; plain {entry['plain_ms']:.4f}, library {lib_txt}, bound "
              f"{entry['bound_ms']:.4f} by {entry['bound_by']}); launches {launches} in phase 5m")
    for shape in ((S_REPLAY, S_REPLAY, 3), (S_REPLAY, S_REPLAY)):
        times = methods_times("replay_gather", shape=shape, k=1)
        # one launch for the images, one for the masks, at each step
        launches = counts_m["replay_gather"] // 2
        entry = methods_entry("replay_gather", f"replay_gather [1 of 64 x {'x'.join(map(str, shape))} "
                              f"uint8]", launches, gather_errs[shape], times,
                              methods_bytes_ops("replay_gather", shape=shape, k=1))
        kernels.append(entry)
        print(f"  {entry['name']}: {entry['ms']:.4f} ms (synchronised per launch "
              f"{times[3]:.4f}; plain {entry['plain_ms']:.4f}, library "
              f"{entry['library_ms']:.4f}, bound {entry['bound_ms']:.4f} by "
              f"{entry['bound_by']}); launches {launches} in phase 5m")
    for kernel in AUG_KERNELS:
        times = aug_times(kernel, *AUG_MAIN)
        entry = aug_entry(kernel, counts_b4[kernel], aug_errs[kernel], times, AUG_MAIN)
        kernels.append(entry)
        print(f"  {entry['name']}: {entry['ms']:.4f} ms (synchronised per launch "
              f"{times[3]:.4f}; plain {entry['plain_ms']:.4f}, library "
              f"{entry['library_ms']:.4f} (the resize alone), bound {entry['bound_ms']:.4f} by "
              f"{entry['bound_by']}); launches {entry['launches']} in phase 5d's baseline_4")
    for shape in ((576, 512, 8, "bfloat16"), (320, 256, 8, "float32"),
                  (160, 128, 8, "float32")):
        t_img, t_msk = (aug_times(k, *shape) for k in AUG_KERNELS)
        bounds = [max(b / HBM_BYTES_PER_S, o / PEAK_OPS["float32"]) * 1e3
                  for b, o in (aug_bytes_ops(k, *shape) for k in AUG_KERNELS)]
        print(f"  augment at {shape}: image {t_img[0]:.4f} ms (plain {t_img[1]:.4f}, library "
              f"{t_img[2]:.4f}, bound {bounds[0]:.4f}), mask {t_msk[0]:.4f} ms (plain "
              f"{t_msk[1]:.4f}, library {t_msk[2]:.4f}, bound {bounds[1]:.4f})")
    # the gen-3 kernels: #30 and #31 at baseline_2's 256² x 64 -> 64 f32
    # (launches of 5v-a's train()), #33 at the two-pass shape (5v-c's)
    v3_launches = {"conv3x3_fwd": sum(counts_va[k] for k in V3_KERNELS["conv3x3_fwd"][2]),
                   "conv3x3_dw": counts_va["conv3x3_dw"],
                   "conv3x3_dw_bn": counts_vc["conv3x3_dw_bn"]}
    for kernel, (source, replaces, _) in V3_KERNELS.items():
        for i, shape in enumerate(V3_SHAPES[kernel]):
            for dtype_name in ("float32", "bfloat16"):
                if kernel == "conv3x3_dw_bn" and dtype_name == "bfloat16":
                    continue
                times = v3_times(kernel, shape, dtype_name)
                bo = v3_bytes_ops(kernel, shape, dtype_name)
                bound = max(bo[0] / HBM_BYTES_PER_S, bo[1] / PEAK_OPS[dtype_name]) * 1e3
                line = (f"  {v3_name(kernel, shape, dtype_name)}: {times[0]:.4f} ms "
                        f"(synchronised per launch {times[3]:.4f}; plain {times[1]:.4f}, "
                        f"library {times[2]:.4f}, bound {bound:.4f})")
                if i == 0 and dtype_name == "float32":
                    entry = json_entry(v3_name(kernel, shape, dtype_name), source, replaces,
                                       v3_launches[kernel], v3_errs[(kernel, shape)], times,
                                       bo, peak="float32")
                    kernels.append(entry)
                    line += f"; launches {entry['launches']} in phase " + \
                        ("5v-c" if kernel == "conv3x3_dw_bn" else "5v-a")
                print(line)
    # the gen-2 kernels: #40 and #41 at baseline_2's 256² x 64 -> 64 f32
    # (launches of 5g-a's train()), every shape printed
    g2_launches = {"conv3x3_g2_fwd": counts_ga["conv3x3_g2_fwd"] + counts_ga["conv3x3_g2_dx"],
                   "conv3x3_g2_dw": counts_ga["conv3x3_g2_dw"]}
    for kernel, shapes in G2_SHAPES.items():
        for i, shape in enumerate(shapes):
            for dtype_name in ("float32", "bfloat16"):
                times = g2_times(kernel, shape, dtype_name)
                bo = g2_bytes_ops(kernel, shape, dtype_name)
                bound = max(bo[0] / HBM_BYTES_PER_S, bo[1] / PEAK_OPS[dtype_name]) * 1e3
                line = (f"  {g2_name(kernel, shape, dtype_name)}: {times[0]:.4f} ms "
                        f"(synchronised per launch {times[3]:.4f}; plain {times[1]:.4f}, "
                        f"cuDNN {times[2]:.4f}, bound {bound:.4f})")
                if i == 0 and dtype_name == "float32" and kernel in G2_KERNELS:
                    g2_src, g2_rep, _ = G2_KERNELS[kernel]
                    entry = json_entry(g2_name(kernel, shape, dtype_name), g2_src, g2_rep,
                                       g2_launches[kernel], g2_errs[(kernel, shape, dtype_name)],
                                       times, bo, peak="float32")
                    kernels.append(entry)
                    line += f"; launches {entry['launches']} in phase 5g-a"
                print(line)
    # the plain conv's path instances past the lists (phase 3), card sleep
    t0 = time.perf_counter()
    plain_tile_times(plain_rows)
    print(f"  plain path tiles' times: {time.perf_counter() - t0:.1f} s")
    # the int8 kernels at the headline's first int8 shape of each, bf16,
    # launches of 5q-a's 13 steps; every shape printed
    t0 = time.perf_counter()
    q_step_ms = {}
    for kernel, (source, replaces) in Q_KERNELS.items():
        for shape, n_step in Q_PATH[kernel]:
            times = q_times(kernel, shape)
            bo = q_bytes_ops(kernel, shape, "bfloat16")
            bound = max(bo[0] / HBM_BYTES_PER_S, bo[1] / PEAK_OPS["bfloat16"]) * 1e3
            lib_txt = "—" if times[2] is None else f"{times[2]:.4f}"
            yard_txt = "" if times[5] is None else \
                f", the dtype route's kernel (card sleep) {times[5]:.4f}"
            line = (f"  {q_name(kernel, shape, 'bfloat16')} x{n_step}/step: {times[0]:.4f} ms "
                    f"(synchronised per launch {times[3]:.4f}, card sleep {times[4]:.4f}; plain "
                    f"{times[1]:.4f}, library {lib_txt}, bound {bound:.4f}{yard_txt})")
            if shape == (512, 32, 32, True, True):
                entry = json_entry(q_name(kernel, shape, "bfloat16"), source, replaces,
                                   counts_q[kernel], q_errs[(kernel, shape)], times, bo)
                kernels.append(entry)
                line += f"; launches {entry['launches']} in phase 5q-a"
            acc = q_step_ms.setdefault(kernel, [0.0] * 7)
            for j, v in enumerate((times[0], times[1], bound, times[2] or 0.0, times[3],
                                   times[4], times[5] or 0.0)):
                acc[j] += n_step * v
            print(line)
    for kernel, (ms, plain_ms, bound_ms, lib_ms, synced_ms, slept_ms, yard_ms) in \
            q_step_ms.items():
        print(f"  per int8 train step (5q-a's shapes), {kernel}: {ms:.4f} ms (synchronised per "
              f"launch {synced_ms:.4f}, card sleep {slept_ms:.4f}), plain {plain_ms:.4f}, bound "
              f"{bound_ms:.4f}, library {lib_ms:.4f} and the dtype route's kernel {yard_ms:.4f} "
              f"(card sleep, where one exists); launches {counts_q[kernel]} in phase 5q-a")
    print(f"  the dtype kernels the int8 ones replace, per step: dx "
          f"{per_step_ms['conv3x3_bn_dx'][0] + per_step_ms['conv3x3_bn_dx_bn'][0]:.4f} ms, dW "
          f"{per_step_ms['conv3x3_bn_dw'][0]:.4f} ms")
    print(f"  int8 kernels' times: {time.perf_counter() - t0:.1f} s")
    # the switches' kernels: #37 (launches of 5f-a under FUSE_BWD) and
    # 34p/35p (under DX_PIPE) at every shape of the headline step, bf16,
    # with per-step sums beside the kernels they stand in for; #5/#6 at the
    # headline shape (launches of 5f-d)
    switch_step_ms = {}
    for kernel, (source, replaces) in SWITCH_KERNELS.items():
        launches = runs_f["FUSE_BWD" if kernel == "conv3x3_bn_bwd_fused" else "DX_PIPE"][0][kernel]
        for shape, n_step in SWITCH_PATH[kernel]:
            times = switch_times(kernel, shape)
            bo = switch_bytes_ops(kernel, shape, "bfloat16")
            bound = max(bo[0] / HBM_BYTES_PER_S, bo[1] / PEAK_OPS["bfloat16"]) * 1e3
            lib_txt = "—" if times[2] is None else f"{times[2]:.4f}"
            line = (f"  {packed_name(kernel, shape, 'bfloat16')} x{n_step}/step: {times[0]:.4f} ms "
                    f"(synchronised per launch {times[3]:.4f}; plain {times[1]:.4f}, library "
                    f"{lib_txt}, bound {bound:.4f})")
            if shape in ((512, 32, 32, True), (512, 32, 32, False)) and \
                    (kernel != "conv3x3_bn_bwd_fused" or shape[3]):
                entry = kernel_entry(kernel, shape, source, replaces, launches,
                                     switch_errs[(kernel, shape)], times, bo)
                kernels.append(entry)
                line += f"; launches {entry['launches']} in phase 5f-a"
            acc = switch_step_ms.setdefault(kernel, [0.0] * 5)
            for j, v in enumerate((times[0], times[1], bound, times[2] or 0.0, times[3])):
                acc[j] += n_step * v
            print(line)
    for kernel, (ms, plain_ms, bound_ms, lib_ms, synced_ms) in switch_step_ms.items():
        print(f"  per headline step, {kernel}: {ms:.4f} ms (synchronised per launch "
              f"{synced_ms:.4f}), plain {plain_ms:.4f}, bound {bound_ms:.4f}, library "
              f"{lib_ms:.4f} (where one exists)")
    print(f"  the kernels they stand in for, per step: dx #34 "
          f"{per_step_ms['conv3x3_bn_dx'][0]:.4f} ms, #35 "
          f"{per_step_ms['conv3x3_bn_dx_bn'][0]:.4f} ms, dW #36 "
          f"{per_step_ms['conv3x3_bn_dw'][0]:.4f} ms")
    # 34p/35p in f32 (#34/#35's f32 instances, which ran faster than a
    # pipelined FMA kernel at every one of these shapes) at the headline
    # step's dx shapes
    for kernel in ("conv3x3_bn_dx_pipe", "conv3x3_bn_dx_bn_pipe"):
        sums = [0.0] * 4
        for shape, n_step in SWITCH_PATH[kernel]:
            t = switch_times(kernel, shape, "float32")
            bo = switch_bytes_ops(kernel, shape, "float32")
            bound = max(bo[0] / HBM_BYTES_PER_S, bo[1] / PEAK_OPS["float32"]) * 1e3
            sums = [acc + n_step * v for acc, v in zip(sums, (t[0], t[3], bound, t[2] or 0.0))]
            lib_txt = "—" if t[2] is None else f"{t[2]:.4f}"
            print(f"  {packed_name(kernel, shape, 'float32')} x{n_step}/step: {t[0]:.4f} ms "
                  f"(synchronised per launch {t[3]:.4f}; plain {t[1]:.4f}, library {lib_txt}, "
                  f"bound {bound:.4f})")
        print(f"  per headline step in f32, {kernel}: {sums[0]:.4f} ms (synchronised "
              f"{sums[1]:.4f}), bound {sums[2]:.4f}, library {sums[3]:.4f} (where one exists)")
    kernels.extend(ebf16_phase6(counts_e, one_e, ebf16_errs))
    for kernel, (source, replaces) in PK_KERNELS.items():
        times = bn_times(kernel, bn_full)
        entry = kernel_entry(kernel, (2097152, 32, 19), source, replaces, counts_pk[kernel],
                             pk_errs[kernel], times, bn_bytes_ops(kernel, bn_full))
        kernels.append(entry)
        print(f"  {entry['name']}: {entry['ms']:.4f} ms (synchronised per launch "
              f"{times[3]:.4f}; plain {entry['plain_ms']:.4f}, library "
              f"{entry['library_ms']:.4f} (head and CE only), bound {entry['bound_ms']:.4f} by "
              f"{entry['bound_by']}); launches {entry['launches']} in phase 5f-d")
    sums = [sum(v[i] for v in per_step_ms.values()) for i in (0, 4)]
    print(f"  per packed train step, all packed kernels: {sums[0]:.4f} ms (synchronised per "
          f"launch {sums[1]:.4f})")
    print(f"  eval images/s, 512² bf16 batch 8: packed {bodies['packed'][1]:.2f} "
          f"(peak {bodies['packed'][2]:.0f} MiB), standard {bodies['standard'][1]:.2f} "
          f"(peak {bodies['standard'][2]:.0f} MiB)")
    print(f"  images/s: baseline_1 train() {b1_ips}, baseline_1 unfused "
          f"{b1u_ips:.2f}, 512² bf16 fused {ips_f:.2f}, unfused {ips_u:.2f}; packed "
          f"train {ips_t:.2f}, unfused {ips_tu:.2f}; headline {ips_h:.2f} (peak "
          f"{peak_h:.0f} MiB), LwF {ips_l:.2f} (peak {peak_l:.0f} MiB), LwF off the packed head "
          f"(5k) {ips_ka:.2f} / {ips_kb:.2f} (peak {peak_ka:.0f} / {peak_kb:.0f} MiB), "
          f"baseline_2 with LwF train() {report_kc.get('images_per_sec_per_chip')}, "
          f"baseline_5 methods step "
          f"{ips_m:.2f} (peak {peak_m:.0f} MiB)")
    print("  train() images/s as the presets ship (phase 5d): " + ", ".join(
        f"{name} {r[0].get('images_per_sec_per_chip')}" for name, r in runs_d.items())
        + f"; baseline_3 on the host pipeline {ips_hp}; baseline_2 with conv_impl=auto "
        f"{report_va.get('images_per_sec_per_chip')} (5v-a)")
    print(f"  5v step images/s: baseline_2 conv_impl=v3 bf16 {ips_vb:.2f} (peak {peak_vb:.0f} "
          f"MiB), packed_min_size=0 f32 {ips_vc:.2f} (peak {peak_vc:.0f} MiB)")
    print(f"  5q step images/s: headline int8 {ips_q:.2f} (peak {peak_q:.0f} MiB) beside dtype "
          f"{ips_h:.2f} (peak {peak_h:.0f} MiB); pairs int8 / dtype median "
          f"{float(np.median(ratios_q)):.4f}; baseline_2 packed int8 f32 {ips_qd:.2f} (peak "
          f"{peak_qd:.0f} MiB)")
    print(f"  5f step images/s: headline {runs_f['default'][1]:.2f} (peak "
          f"{runs_f['default'][2]:.0f} MiB), under FUSE_BWD {runs_f['FUSE_BWD'][1]:.2f} (peak "
          f"{runs_f['FUSE_BWD'][2]:.0f} MiB), DX_PIPE {runs_f['DX_PIPE'][1]:.2f} (peak "
          f"{runs_f['DX_PIPE'][2]:.0f} MiB), both {runs_f['both'][1]:.2f}; pairs against the "
          f"default, medians " + ", ".join(f"{n} {float(np.median(r)):.4f}"
                                          for n, r in ratios_f.items())
          + f"; baseline_2 packed under FUSE_BWD train() {report_fc.get('images_per_sec_per_chip')}")
    print(f"  5g images/s: baseline_2 train() conv_impl=pallas "
          f"{report_ga.get('images_per_sec_per_chip')} (peak {peak_ga:.0f} MiB); one batch, "
          f"medians of five turns: " + ", ".join(
              f"{k} {float(np.median(v)):.2f}" for k, v in pairs_g.items())
          + f"; 512² bf16 standard body pallas {ips_gc:.2f} (peak {peak_gc:.0f} MiB) beside "
          f"xla {ips_f:.2f} (phase 5, peak {peak_f:.0f} MiB)")
    print(f"  5b: the headline step at CL_TPU_CONV_BUDGET={CONV_BUDGET_22} (level 3 packed) "
          f"{ips_b:.2f} img/s (peak {peak_b:.0f} MiB) beside the default's {ips_h:.2f} (peak "
          f"{peak_h:.0f} MiB, 5h)")
    print(f"  5u: the headline step under CL_TPU_E_BF16 {ips_e:.2f} img/s (peak {peak_e:.0f} "
          f"MiB) beside the default's {ips_h:.2f} (5h)")
    print(f"  variants: GroupNorm standard body 512² bf16 {ips_n:.2f} img/s (5n-a) beside "
          f"BatchNorm's {ips_f:.2f} (phase 5); baseline_5 with model.padded_head=false "
          f"train() {report_e.get('images_per_sec_per_chip')} beside the padded head's "
          f"{report_b5.get('images_per_sec_per_chip')} (5m)")
    print(f"  total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
