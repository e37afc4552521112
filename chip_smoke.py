#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (ubdvss_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the
repository around this file; exits non-zero, printing no result, without
them.  Phases, each of which raises on failure:

  1. the card's name and power limit (nvidia-smi), then the build of every
     kernel from ubdvss_tpu_torch/csrc/ (one nvcc per source, seven, in
     parallel);
  2. each kernel against its plain PyTorch version on the card, at its
     path's shapes, on real logits plus adversarial maps (snake,
     checkerboard, tall bars, single pixels, staircase, noise, empty): CCL
     labels identical; slots and the fused compat geometry with their
     per-component stats over the head's 17-channel NHWC view: slot
     outputs and areas identical, det_sums / areas and cls_sums / areas
     within 2e-6, two launches bit for bit equal, the fused geometry's
     eight outputs bit for bit equal to slots after CCL; rect rows
     (compacted at M = 1, 8, 64 and H-1, and uncompacted, also one image
     at a time as detect calls it) within 1e-4 (or
     the same rectangle on an exact caliper tie) with any_edge identical, the context module within
     max(1e-5, 1e-6 max|logit|) of its plain version with TF32 off at the main
     path's (64, 24, 128, 128), the QVGA stream's (64, 24, 60, 80) and
     the large scans' (8, 24, 512, 512) features, one launch a layer;
     then the large maps: the device-memory CCL on the 2048² scans' 512²
     maps (with the adversarial maps at 512²) and the 4096² scan's 1024²
     map, labels identical; the tiled slots kernel on both at K=64, slot
     outputs and areas identical, means within 2e-6 of the plain one-hot
     sums taken in f64, two launches bit for bit; the compacted rect at
     H=512 and 1024 (M=64) and the uncompacted one at the three detect
     sizes' heatmaps; then the tall pages' kernels: the uncompacted rect
     on synthetic extremes (K=16, B=1 and 3) with a rotated bar over every
     row (a long staircase), or a convex blob over every row whose every
     row is a hull point, at H=1088, at its one-block cap
     (rect_kernel.MAX_EXACT_HEIGHT, 1994, which the library's
     rect_exact_max_height() must equal) and, in its tall instance (a
     cluster of eight blocks a component), at 2048 and 4096, and at 8192
     (B=1), rows within 1e-4 of the plain version; the large fused
     compat geometry (geometry_compat_large) on the 2048² scans' 512² maps,
     the 4096² scan's 1024² map (f32 and bf16) and the adversarial maps at
     512² (4- and 8-connected), K=64, all eight outputs bit for bit equal
     to the device-memory CCL then the tiled slots kernel;
  3. the paths, each driven with every launch counter set to 0 just before
     and read just after:
     a. the main path: assets/pretrained_synthetic.npz through
        params_from_flat, NetConfig() with max_components=16, B=64
        synthetic 512x512 uint8 scenes from seed 7,
        detect_program_batch(device="cuda"); each of its kernels must have
        launched, the context module once a layer; detections checked
        against the same call through the plain versions on the host CPU;
     b. the QVGA camera stream: 256 synthetic 240x320 uint8 frames (seed 7)
        through StreamingDetector(batch_size=64), the asset's own NetConfig
        with max_components=16 (max_hull_points=64 >= the 60-row heatmap,
        so the rects take the uncompacted kernel); context (once a layer
        a batch), CCL, slots and the uncompacted rect kernel must have
        launched and the compacted one not; all 256 frames' detections
        checked against the plain route on the host CPU by
        compare_detections (which leaves out a
        frame holding a detection logit within 1e-4 of the threshold);
     c. the compat route: the main path with UBDVSS_PALLAS_COMPAT=1 (set
        for the call, then restored); the fused geometry kernel must have
        launched and CCL and slots not; detections identical to the
        default route's on the card;
     d. single-image detection: BarcodeDetector(device="cuda").detect and
        detect_program on 4 of the main path's 512x512 scenes, the XLA
        route's exact rects; context, CCL, slots and the uncompacted rect
        kernel must have launched and the compacted one not; detections
        equal to the same calls through the plain versions on the host CPU;
     e. large scans: the asset's own NetConfig (K=64, M=64, f32), B=8
        synthetic 2048x2048 uint8 scans (seed 11, as
        tests/test_inference.py:117), detect_program_batch(n_strips=1),
        the whole-image trunk (phase 10 drives the packed route): context,
        the device-memory CCL, the tiled slots kernel and the compacted
        rect kernel must have launched, and the one-block CCL, the cluster
        slots kernel, the fused geometry and the uncompacted rect not;
        the first 2 scans' detections equal to the plain route on the
        host CPU;
     f. one 4096x4096 scan (a 1024² heatmap, the compacted rect at
        H=1024), n_strips=1, the same kernels, equal to the plain route on
        the host CPU;
     g. BarcodeDetector.detect and detect_program with the asset's
        NetConfig on a 640x480, a 1024x768 and a 1024x1024 image
        (120x160, 192x256 and 256x256 heatmaps): context, a CCL, a slots
        kernel and the uncompacted rect on each call, the device-memory
        CCL and the tiled slots kernel exactly where the map exceeds one
        block's shared memory (256x256); equal to the plain route on the
        host CPU;
     g'. tall pages past the fused route's heatmap limit: a synthetic A4
        page at 600 dpi (7016x4960 uint8, a 1754x1240 heatmap) and an
        8192x1024 page (a 2048-row heatmap) with the asset's config and
        max_image_side raised to keep their resolution, through
        detect_program_batch and BarcodeDetector.detect: context, the
        device-memory CCL, the tiled slots kernel and the uncompacted rect
        launched, the compacted rect not; detections equal to
        detect_program on the host CPU (boxes within 2e-3 px: an f32 ulp
        is 4.9e-4 px past 4096 px);
     h. the bf16 main path (the JAX bench's default mode): the main path
        with NetConfig(dtype="bfloat16") and the weights cast to bf16 (as
        bench.py:290-291): the bf16 stem and dense-equivalent context convs
        (cuDNN), then the bf16 CCL and slots kernels on the bf16 logits and
        the compacted rect; the context kernel must not launch; detections
        equal to the bf16 route on the host CPU by compare_bf16_detections
        (a pixel may change sides of the threshold only within the logit
        tolerance of it), no copy of the whole logits before the slots
        kernel (operator shapes), and the scenes whose count and classes
        equal the f32 path's reported;
     i. the bf16 compat route: the fused geometry's bf16 kernel launched,
        detections identical to the bf16 default route, its eight outputs
        bit for bit equal to the bf16 slots after the bf16 CCL;
     j. bf16 large scans: the scans of e in bf16 (n_strips=1, and so j'
        and the large scans' timings): the bf16 device-memory
        CCL and tiled slots kernels launched; the first 2 scans equal to
        the bf16 route on the host CPU;
     j'. the compat route on the large scans: the scans of e and the scan
        of f with UBDVSS_PALLAS_COMPAT=1, in f32 and bf16: the large fused
        compat geometry launched once a call, the device-memory CCL and
        the tiled slots kernel not; detections identical to the default
        route's on the card;
     k. BarcodeDetector.detect in bf16 (BarcodeFCN's bf16 logits are f32,
        so the f32 CCL, slots and uncompacted rect run) at 512x512 and
        640x480, and the QVGA stream in bf16 (the bf16 CCL and slots), each
        against the host CPU;
     l. the int8 mode (the JAX package's production serving route):
        quantize_trunk on the card over 32 synthetic 512x512 scenes (seed
        99), bench.py's calibration, against the same call on the host CPU
        (scales within 1e-5 relative, at most 0.1% of the int8 weights and
        1e-3 of a bias apart; reported), its bias correction in one
        qconv_layer_f32 launch a layer and one for the head (the f32
        pre-activation and the exact accumulator on the tensor cores) and
        one requantize launch a layer (each checked against its plain
        version); then the int8 trunk's kernels
        against their plain versions on the card and on the host CPU, bit
        for bit: qstem (layers 0 and 1 from the image), qconv (a context
        layer) and qconv_head (the last context layer with the head), each
        launch of the main path's, the QVGA stream's, one image's and the
        2048² scans' chains, qstem on f32 raw and f32 normalized images and
        on an odd 75x101 image (19x26 out, then qconv and qconv_head
        there), random activations at dilation 16, saturating ±127 (|acc| =
        3,483,864, read back from the int8 outputs), with the head too,
        zeros, and 32 channels at saturation (|acc| = 4,645,152, past the
        epilogue's conversion-free window) through qconv, qconv_head and
        qstem's layer 1;
     m. the int8 main path: the main path with qparams: the trunk in eight
        launches (qstem once, qconv once a context layer but the last,
        qconv_head once), K1, K2, K3; the context kernel never; logits equal
        to the checked chain's and to the same call on the host CPU with
        the card's qparams bit for bit, detections identical; the scenes
        whose count and classes equal the f32 path's reported;
     n. int8 large scans (the scans of e; the int8 route reads no
        n_strips, as in the JAX package, so these take the packed int8
        route): the eight trunk launches, qconv_head's packed store, the
        device-memory CCL, the tiled slots kernel reading the phase-major
        logits and K3; the first 2 scans equal to the host CPU (the packed
        formulation there), logits bit for bit;
     o. int8 BarcodeDetector.detect and detect_program_int8 at 512x512
        (K=16) and 640x480 (the asset's config): the trunk's kernels, K1,
        K2, K3x; and the int8 QVGA stream (eight trunk launches a batch):
        each equal to the host CPU;
     p. the CLI's calibration (calibrate_qparams, detect --int8) on 4 scenes
        on the card (qconv_layer_f32 and requantize launched, the trunk's
        kernels not) against
        the host CPU, as in l;
  4. timing with CUDA events (median of 10 samples of 10 back-to-back calls,
     after warm-up): img/s of the main path, frames/s of the stream (the
     whole process() of 256 frames, median of 3), each kernel's ms beside
     its plain version's, the library call's (where one PyTorch call
     computes the same function; for slots, the torch one-hot stats it
     replaces) and its bound, the fused geometry beside CCL + slots on the
     same maps, each kernel's device time (torch.profiler); the latency of
     one detect call; then a torch.profiler breakdown of the main path's
     device time by kernel, which must hold no stats row (cuBLAS gemv or
     gemm, one-hot compare, sigmoid, softmax), and the device's busy share
     of the path's time; the same for the large scans (scans/s, device
     ms a batch, the profile), the 4096² scan and one detect call at each
     of the three sizes.  The bf16 variants of CCL, slots and the fused
     geometry get their own rows (bounds at 2 B a logit), and the bf16
     paths their timings and profiles; so do the int8 paths (whose
     profiles must hold no cuDNN convolution row), and the int8 trunk's
     eight launches at the main path's shapes, one row a launch and one a
     kernel, beside their bounds (bytes at 3.35 TB/s against int8
     operations at 1,979 TOPS), their plain versions, one f32 F.conv2d a
     layer on the int8 values (TF32 off), the library yardstick, and, time
     only, a channels-last bf16 F.conv2d a layer of the same shapes; and
     the bias correction's launches over the calibration images: the
     qconv_layer row its 10 qconv_layer_f32 launches alone, beside their
     plain versions, their bytes' bound and one f32 F.conv2d a layer; the
     qrequant row its 9 requantize launches alone; and the whole walk's 19
     (each one's device ms, the bound of the bytes the walk moves beside
     the dp4a walk's it replaced) as a logged entry of its own;
     the uncompacted rect on the A4 page's and
     the 8192x1024 page's extremes (rect_exact_h1754, rect_exact_h2048)
     and the large fused compat geometry on the scans' maps, f32 and bf16,
     each with its row; each launch of the tiled kernels (the device-memory
     CCL's three, the tiled slots' three, the large fused geometry's one)
     at the scans' maps, f32 and bf16: device ms, grid and block, and the
     profiler's estimate of resident warps an SM, printed a line a launch
     and kept in the row's ``phases``; the uncompacted rect on the kernel checks'
     synthetic extremes at each tall height (staircase and convex blob,
     B=1 and 3, and 8192 rows); one A4-page
     detect call and one compat batch of the 2048² scans: wall time,
     device time and busy share;
  5. evaluation, the JAX package's int8 accuracy protocol
     (tests/test_quant.py:256-296) on the card: the asset's config (K=64,
     M=64), 48 synthetic 256x256 scenes (seed 0), DataConfig(batch_size=8,
     max_polys=32), quantize_trunk on the card over the first 32 images of
     Batches(train=False) (10 qconv_layer_f32 and 9 requantize launches);
     run_evaluation in f32
     (K4 once a layer a batch, K1, K2, K3x) and in int8 (qstem, qconv and
     qconv_head once, six times and once a batch, K1, K2, K3x), neither
     launching K3, the compat geometry or a tiled kernel; int8 F1 >= 0.96
     (the JAX package's bar); each report equal to the same call on the
     host CPU (tp, fp, fn, n_pred, n_gt, per-class counts and F1; int8 on
     the card's qparams); native mode on 256x256 and 192x256 sources at
     batch 4 (padded remainders), f32 and int8, equal to the host CPU's;
     then images/s of run_evaluation with the prefetch thread and without
     it (wall clock, median of 3), the matcher's time, the device's busy
     share (torch.profiler, the union of the streams' device intervals) and
     the feed's time alone (Batches on the card, median of 3);
  6. training, with the asset's architecture (24 channels, dilations
     1,1,2,4,8,16,1, 17 outputs): the gradients of fused_model_apply (K4
     forward, autograd of its plain version backward) against BarcodeFCN's
     on the asset's weights, B=8 128², TF32 off, within 1e-3 + 1e-4 of
     each (K4 launched once a layer, in the forward only; the max error
     goes into the context_layer entry as grad_max_abs_err); one
     train_step on the card against the host CPU from the asset's weights
     on one augmented B=8 512² batch built on the host, f32 and bf16, at
     tests/test_torch_cuda_train.py's tolerances (in bf16 up to 1% of the
     parameters may land 2 lr apart: Adam's first step is about
     lr * sign(grad), and a gradient inside bf16's rounding noise may take
     the other sign on the card; the count is printed) (no kernel of ours launches:
     the step takes the module, as JAX's train_apply does); the JAX
     package's overfit gate (tests/test_integration.py:20-37: 16 scenes
     of 128², seed 1, 1-2 objects, lr 2e-3, 150 epochs at batch 8, no
     augmentation) with run_evaluation on the card giving object F1 1.0
     and class accuracy 1.0 (K4, K1, K2, K3x launches printed); resume:
     a Trainer's checkpoint restored into a fresh Trainer, one more step
     from each bit for bit equal (cudnn.deterministic); the train CLI in
     its own process for one epoch, then the evaluate CLI on its log
     directory and the detect CLI on its exported weights (a .npy scene);
     then bench.py's train protocol (B=128 512², seed 7, DataConfig(seed=0)
     with augmentation, lr 1e-3, the batch on the card): ms a step and
     images/s of train_step in f32 and bf16 (CUDA events, median of 5
     samples of 2 steps), the device ms a step, busy share and top device
     rows (torch.profiler over 3 steps), the loss forward's launches and
     device ms, and the host-fed epoch over 384 scenes through
     Batches(train=True) then train_step, with the prefetch thread and
     without it (median of 3 epochs);
  7. device-fed training, at the same B=128 512² (seed 7, the asset's
     config for the checks, NetConfig() and bf16 for the timing): the
     scene synthesis on the card against the host CPU on the same draws
     (made on the host), with the augmentation's affine composed in and
     without: vertex counts and classes identical, polygons within 1e-4,
     pixels within 1e-3 but texel flips (at most 1 in 10^4 window
     pixels), the segmaps identical wherever the grid polygons agree; the
     windowed rasterizer bit for bit the dense one on the card; the JAX
     package's transfer gate (tests/test_synthgen.py:236-267: the dense
     asset on 16 port-generated 256² scenes, object F1 >= 0.95, class
     accuracy >= 0.75, K1, K2 and K3x counted); Trainer.fit over
     DeviceSyntheticBatches with 1 and 4 steps a dispatch, and over
     DeviceCachedBatches of the host-fed epoch's 384 scenes, against the
     unfused loop (the cache's over Batches), 2 epochs, cudnn
     deterministic, within 2e-6; then the device-fed epoch's images/s (384
     scenes, median of 5) in f32 and bf16 and the cached epoch's beside
     the bare step and the host-fed epoch of phase 6, each with its busy
     share, the peak memory, the synthesis alone (ms, device ms and top
     rows a batch), and the synchronizing calls of one 16-step chunk
     (torch.cuda.set_sync_debug_mode("warn")); then the train CLI with
     synthetic-device train and val data at 2 steps a dispatch and with
     --cache-device, each in its own process, run together.
  8. the mesh and tiled scans (parallel/mesh.py, parallel/tiling.py), over
     entries that repeat the one card (make_mesh(n, devices=[cuda:0] * n):
     the sharding, halo and seam code that n cards would run):
     detect_program_batch(mesh=) on the main path's B=64 512² batch over 4
     entries in f32, bf16 and int8, bit for bit the four per-shard calls,
     each kernel's launches 4x a shard's, logits within 1e-5 of the
     full-batch call and its detections equal (compare_detections); once
     over setup_devices("auto"), bit for bit the single call; the QVGA
     stream over 4 entries equal to the stream at the shards' batch size;
     run_evaluation over 4 entries on 44 256² scenes at batch 8 (a padded
     remainder) equal to the run without a mesh; tiled_detect on a 2048²
     scan over 4 entries (T = 512, the 140-pixel halo in one hop) and 16
     (T = 128, two hops) against detect_program on the whole scan: logits
     within 1e-4, valid identical, boxes within 1e-3 as corner sets,
     converged; the distributed CCL on the adversarial maps and a snake
     crossing every seam, on 2, 4 and 8 entries, 4- and 8-connected,
     labels identical to connected_components (the cap of the seam loop
     is reached only by the adversarial snake on 8 entries, as in the JAX
     formulation); connected_components equal to K1's labels compacted on
     the main path's maps; times (CUDA events): the DP batch against the
     single call, tiled_detect split into trunk, seam rounds and tail
     beside detect_program on the whole scan, and K1 against
     label_propagation and connected_components on the main path's maps.
  9. training over a mesh (train.Trainer(mesh=)), NetConfig() at B=128
     512² (seed 7, DataConfig(seed=0) with augmentation, lr 1e-3), f32 and
     bf16, over 4 entries that repeat the card, on each pipeline — host-fed
     Batches, DeviceSyntheticBatches and DeviceCachedBatches (the corpus
     sharded over the entries, 4 steps a dispatch) — of 4 steps (512
     scenes): the first sharded step against the unsharded one on the
     pipeline's first batch (cudnn deterministic): the device-fed shards
     the whole batch's rows bit for bit, the reduced gradient within 1e-5
     of each leaf's max|g| (bf16 2e-2), the losses within 1e-5 relative
     (bf16 1e-3, the bf16 train step's bound against the host CPU),
     grad_norm 1e-5 (bf16 2e-2), the pixel metrics 1e-6 (bf16 2e-3);
     then the sharded fit against the unsharded
     fit: every parameter within 2 lr a step and, in f32, the median
     within 1e-5 (Adam turns a near-zero gradient's sum-order difference
     into a step-sized one), the last losses within 1e-3 relative; ms a
     step of each (CUDA events over an epoch, median of 3), the
     reduction's ms, and the share of a B=32 shard's synthesis (device ms)
     taken by the draws of the 96 rows it does not render; run_evaluation
     over the 4 entries with the f32 host-fed fit's parameters (the
     asset's config, 48 256² scenes, batch 8): K4, K1, K2 and K3x
     launched as often as by the unsharded run at the shards' batch of 2,
     the report equal to the unsharded one's at batch 8; and
     setup_devices(distributed=True) at world size 1 on NCCL
     (tcp://localhost, a free port): one Trainer step whose reduction
     calls all_reduce twice (the gradient, the metric sums), bit for bit
     the unsharded step, then the process group destroyed.

  10. the large-scan packed route (after the timing of phase 4, before
     phase 5), the asset's config: K4's packed store at the 2048² scans'
     (8, 24, 512, 512) features == _s2d of its unpacked launch bit for
     bit, within max(1e-5, 1e-6 max|logit|) of its plain version and
     within 1e-4 of the JAX package's packed
     formulation on cuDNN (s2d_context_head, TF32 off), the card's packed
     trunk within 1e-4 of that formulation's; qconv_head's packed store on
     the scans' int8 chain == _s2d of its unpacked launch and its plain
     version bit for bit, the card's packed int8 trunk == the packed
     formulation (packed int8 kernels, f64 convs) bit for bit on one scan;
     the tiled K2 and the large K12c on phase-major 512² logits (f32 as
     K4's packed planes, bf16 as the bf16 route's _s2d copy), K=64: slots,
     extremes and areas bit for bit the same kernel on the unpacked
     logits, the stats within 2e-6, and equal to the plain version; then
     detect_program_batch's auto route with its launches counted: B=8
     2048² scans in f32 (K4 seven times, once with the packed store, the
     tiled K2 reading phase-major), bf16 (the dense route, one _s2d copy,
     recorded) and int8 (qconv_head's packed store), one 4096² scan (the
     tiled packed trunk, 4x4 tiles in one batch, K4 seven times), the
     compat route (the large K12c reading phase-major, f32 and bf16) and
     B=4 1024² scans at K=16 (the cluster K2 and K12c reading
     phase-major): logits equal to n_strips=1's (the direct int8 trunk's
     for int8) bit for bit, within 1e-4 at 4096², detections identical
     (scores within 1e-6, boxes within 1e-4); then the wall and device ms
     of each auto route against its whole-image route, in turns (auto,
     whole, whole, auto), the JAX package's packed formulation's on cuDNN,
     and a kernel row for each mode beside the same kernel's unpacked
     launch.
  11. every width the JAX package serves (after phase 10): the wide
     configuration (48 channels, 40 symbologies: 41 logits; the asset's
     weights carried into its first 24 channels, the rest drawn from SEED
     at a small scale), the narrow one (10 channels, 17 logits;
     init_params at SEED, the head scaled up), few (the asset cut to its
     detection row and its QRCode, DataMatrix, EAN13 and Code128 rows: 5
     logits) and mid (the asset's 17 rows and 8 drawn from SEED at a
     small scale: 25 logits), K=16, M=64: K4's instance
     (the "wide" tile of 128 pixels by 48 channels at 48, the "narrow"
     register kernel compiled for 10 channels at 10) on 8
     images' features within max(1e-5, 1e-6 max|logit|) of its plain
     version, its packed store
     == _s2d of the unpacked one; B=64 512² detect_program_batch in f32
     (K4, K1, K2, K3), bf16 (cuDNN, the bf16 K2), int8 after quantize_trunk
     on 8 of the batch's images (qstem, qconv x6 and qconv_head at the
     padded width; the calibration's qconv_layer_f32 and requantize), the
     compat route (K12c) and BarcodeDetector.detect on 2 images (K3x), each
     launch counted, the first 8 images (2 for detect) against the host
     CPU: f32 logits within 1e-4 (1e-5 of max|logit| where that is more:
     the narrow head's logits), bf16 within the bf16 tolerance, int8 bit
     for bit, detections equal (an image with a detection logit within
     twice the logits' error of the threshold left out); the stats at the configuration's logit
     channels (the instance of the bound that holds them: 5, 25 or 41
     logits) against their plain version, K12c
     equal to K2 bit for bit; the int8 kinds layer by layer on 2 images bit
     for bit; then, but for narrow, 2 2048² scans on the packed route: K4's
     packed store at the configuration's logits, the tiled K2 and the large K12c reading
     the phase-major logits, qconv_head's packed store, logits == n_strips=1's
     bit for bit, scan 0 == the host CPU's; and a kernel row for each
     instance the asset's widths never reach (ms, device ms, plain,
     library, bound, and the kernel instance: K4 wide and narrow, the
     wide int8 kinds, and the stats at 41, 5 and 25 logits, the cluster
     K2 in f32 and bf16, K12c, the tiled K2 and the large K12c
     phase-major; the rows of K4 and of the stats also the device ms of CUDA
     events around calls queued behind a sleep, ``queued_ms``, where the
     profiler has dropped launches; the log line adds, in
     brackets, the earlier design's device ms that scripts/
     torch_kernel_ab.py --only widths read), beside one timed batch a
     path.

Output: human-readable lines, then the nvidia-smi line, then one JSON line
{"kernels": [...]}, then the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from itertools import permutations
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
B, IMG, K, M = 64, 512, 16, 64
SEED = 7
QVGA, N_FRAMES = (240, 320), 256
SCAN, B_SCAN, SCAN_SEED = 2048, 8, 11  # large scans (tests/test_inference.py:117)
BIG_SCAN = 4096
DETECT_HW = ((480, 640), (768, 1024), (1024, 1024))
LOGIT_ULPS = 4  # bf16 logits of one route on the card against the host CPU
SCORE_TOL_BF16, CLS_TOL_BF16 = 1e-3, 1e-2  # tests/test_torch_bf16.py's
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM f32 on the CUDA cores (no tensor cores)
INT8_OPS = 1979e12  # H100 SXM int8 tensor cores, dense
N_CALIB, CALIB_SEED = 32, 99  # the int8 calibration pool (bench.py:296-301)
A4_PAGE = (7016, 4960)  # an A4 page at 600 dpi: a 1754x1240 heatmap
TALL_PAGE = (8192, 1024)  # a 2048-row heatmap, past the one-block K3x's cap
ITERS, REPS, WARMUP = 10, 10, 2
# the JAX package's int8 accuracy protocol (tests/test_quant.py:256-296):
# 48 synthetic 256² scenes (seed 0), batch 8, calibration on the first 32
# images of the eval pipeline, int8 F1 >= 0.96; JAX documents F1 0.9661
EVAL_N, EVAL_HW, EVAL_BATCH, EVAL_CALIB = 48, (256, 256), 8, 32
EVAL_F1_MIN, EVAL_F1_JAX = 0.96, 0.9661
# training: the gradient and step checks at B=8 (128² and 512²), the JAX
# package's overfit gate (tests/test_integration.py:20-37: 16 scenes, 150
# epochs at batch 8), and bench.py's train protocol at B=128 512²
TRAIN_B, TRAIN_SMALL, OVERFIT_EPOCHS = 8, 128, 150
TRAIN_BENCH_B, TRAIN_EPOCH_N = 128, 384
MESH_ENTRIES, MESH_STEPS = 4, 4  # training over a mesh: entries, steps a pipeline


T0 = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def phase(name: str) -> None:
    """One line at the start of each phase, with the seconds since start."""
    log(f"== {name} ({time.perf_counter() - T0:.1f} s)")


def time_ms(fn, iters=ITERS, reps=REPS, warmup=WARMUP) -> float:
    """Time of one call of fn: the median over ``iters`` samples, each a
    CUDA-event interval around ``reps`` back-to-back calls divided by reps
    (so the device queue stays fed and a small kernel's time is not its
    wrapper's host time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def queued_ms(fn, iters: int = 5, reps: int = 4) -> float:
    """Device ms of one call of fn: CUDA events around ``reps`` calls queued
    behind a kernel that sleeps ~0.1 s, so the host's enqueueing never
    leaves the card idle between them; the median of ``iters`` samples."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        torch.cuda._sleep(200_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, n: int = 20, tries: int = 3) -> float:
    """Mean device time of one call of fn: the sum of its kernels' CUPTI
    durations (torch.profiler), without the host's launch time.  A profile
    that recorded no kernel at all (seen once in a while) is taken again,
    up to ``tries`` times, rather than read as 0; after that the time comes
    from ``queued_ms``, which the log line says."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
        if total > 0:
            return total / n / 1e3
    log(f"device_ms: {tries} profiles recorded no kernel; CUDA events around queued calls instead")
    return queued_ms(fn)


def phase_split(fn, n: int = 20) -> dict:
    """Each kernel one call of fn launches: its mean device ms and launches
    a call (CUPTI durations), and the grid, block, registers, shared memory
    and kineto's estimate of resident warps an SM of its last launch, from
    torch.profiler's chrome trace."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=REPO / "build") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    split: dict[str, dict] = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e["name"].replace("(anonymous namespace)::", "").split("<")[0].split("(")[0]
        name = name.split("::")[-1].replace("void ", "").strip()
        a = e.get("args", {})
        s = split.setdefault(name, {"ms": 0.0, "launches": 0.0})
        s["ms"] += e["dur"] / 1e3 / n
        s["launches"] += 1 / n
        occ = a.get("est. achieved occupancy %")
        s.update(grid=a.get("grid"), block=a.get("block"), registers=a.get("registers per thread"),
                 smem=a.get("shared memory"),
                 resident_warps_per_sm=None if occ is None else occ * 64 / 100)
    return split


def slot_plan_of(lg, K, phases=None) -> dict:
    """The plan the cluster K2 and K12c launch with on these logits
    (ops/cuda/postproc_kernel.py slot_plan): blocks an image, virtual warps
    a block and an image."""
    from ubdvss_tpu_torch.ops.cuda import postproc_kernel as pk

    _, H, W, C = pk.unpacked_shape(lg, phases)
    p = pk.launch_plan(lg, H, W, K, C)
    return {"blocks": p.blocks, "sets": p.sets, "virtual_warps": p.virtual_warps}


def logit_bar(ref) -> float:
    """The bar of f32 logits against their reference: max(1e-5, 1e-6 of
    the reference's max|logit|), the f32 route's against the JAX package."""
    return max(1e-5, 1e-6 * float(ref.abs().max()))


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k4_byte_floor(shape, O: int, L: int, w_bytes: int = 0) -> float:
    """ms: the bytes K4's one-launch-a-layer design must move on (B, C, H,
    W) features, over the card's memory rate: each of the L layers reads
    the C input channels of a pixel and writes C (the last one O) f32
    channels, and the weights are read once."""
    B_, C, H, W = shape
    px = B_ * H * W
    return (px * 4 * (L * C + (L - 1) * C + O) + w_bytes) / HBM_BYTES_PER_S * 1e3


def library_chain(x, w, dil):
    """K4's function as PyTorch calls (its ``library_ms``): the depthwise and
    1x1 F.conv2d a layer, then the head; the caller turns TF32 off."""
    import torch
    import torch.nn.functional as F_

    C = x.shape[1]
    for li, d in enumerate(dil):
        x = F_.conv2d(x, w[0][li, :, :, 0, 0].T.reshape(C, 1, 3, 3), None, 1, d, d, C)
        x = torch.relu(F_.conv2d(x, w[1][li][:, :, None, None], w[2][li][:, 0, 0]))
    return F_.conv2d(x, w[3][:, :, None, None], w[4][:, 0, 0])


def k4_plans(shape, O: int, dil) -> list | None:
    """K4's exact-instance plan of each layer on (B, C, H, W) features with
    an O-output head, as [P pixels a thread, rows of threads an image,
    threads a block, blocks]; None where another instance runs."""
    from dataclasses import astuple

    from ubdvss_tpu_torch.ops.cuda import context_kernel as ck

    _, C, H, W = shape
    if ck.kernel_instance(C, O) != "exact":
        return None
    return [list(astuple(ck.exact_plan(H, W, d))) for d in dil]


def stats_bound(lg, geo, K, esz, k12=False) -> tuple[float, str]:
    """The bound of the stats kernels on (B, H, W, C) logits of ``esz``
    bytes a logit and their outputs ``geo``: the detection logit and (K2)
    the label read, the slot written, the class logits of the pixels in a
    slot read, the extremes and sums written; operations the sigmoid and
    softmax of those pixels.  ``k12``: K12c, which reads no labels and runs
    the CCL."""
    B_, H, W, O = lg.shape
    px = B_ * H * W
    in_slot = int((geo["slots"] < K).sum())
    ext = B_ * K * (2 * H + 1) * 4 + B_ * 4
    stat = in_slot * (O - 1) * esz + B_ * K * (O + 1) * 4
    if k12:
        return bound(px * (esz + 4) + ext + stat, px * 13 + in_slot * O * 8)
    return bound(px * (esz + 8) + ext + stat, px * 4 + in_slot * O * 8)


def adversarial_maps(n=128):
    """(8, n, n) detection-logit maps that stress CCL, slots and rects."""
    rng = np.random.default_rng(SEED)
    maps = np.full((8, n, n), -6.0, np.float32)
    for c in range(0, n, 4):  # snake: columns joined alternately top/bottom
        maps[0, :, c] = 6
        maps[0, 0 if (c // 4) % 2 else n - 1, c : c + 5] = 6
    maps[1] = np.where(np.indices((n, n)).sum(0) % 2 == 0, 6.0, -6.0)  # checkerboard
    for i, x0 in enumerate(range(4, n - 8, 12)):  # tall bars: > M collinear rows
        maps[2, 2 + i % 5 : n - 2 - i % 7, x0 : x0 + 1 + i % 5] = 6
    ys, xs = rng.integers(0, n, (2, 300))  # single pixels
    maps[3, ys, xs] = 6
    for i in range(n):  # diagonal staircases
        maps[4, i, i] = 6
        maps[4, i, (3 * i) % n] = 6
    maps[5] = rng.normal(0, 1, (n, n))  # noise: many components, > K
    maps[6, 10:110, 20:100] = 6  # blob with holes and a notch
    maps[6, 40:60, 40:60] = -6
    maps[6, 70:80, 20:50] = -6
    return maps  # maps[7] stays empty


def exact_directions(minx, maxx) -> np.ndarray:
    """(B, K, H) extremes -> per component, the directions the uncompacted
    rect kernel projects: the edges between consecutive hull points of
    each chain, less an edge equal to the one before it on its chain."""
    from ubdvss_tpu_torch.ops.cuda.rect_kernel import _convexify

    H = minx.shape[-1]
    rowv = (maxx >= 0).reshape(-1, H)
    out = np.zeros(rowv.shape[0], np.int64)
    for v, sign in ((minx, 1), (maxx, -1)):
        v = v.reshape(-1, H).long()
        alive = _convexify(v, rowv, sign).cpu().numpy()
        xs = v.cpu().numpy()
        for c in range(len(out)):
            ys = np.flatnonzero(alive[c])
            if len(ys) >= 2:
                e = np.stack([np.diff(xs[c, ys]), np.diff(ys)], 1)
                out[c] += 1 + int((e[1:] != e[:-1]).any(1).sum())
    return out


def synthetic_extremes(B, K, H, seed):
    """(B, K, H) int32 extremes without a CCL: slot 0 a bar 5 px wide at a
    golden-ratio slope over every row (a digital line whose chains are long
    staircases, more rounds than the kernels' lockstep runs), then upright
    bars, slanted bars, rotated rectangles, rows of noise, a single row, a
    single point and empty slots (tests/test_torch_cuda_kernels.py's)."""
    import torch

    rng = np.random.default_rng(seed)
    y = np.arange(H)
    mn = np.full((B, K, H), 1 << 30, np.int64)
    mx = np.full((B, K, H), -1, np.int64)
    for b in range(B):
        s = 0.6180339887 * (1 if b % 2 == 0 else -1) / (1 + b)
        left = np.floor(10 + (H * abs(s) if s < 0 else 0) + s * y).astype(np.int64)
        mn[b, 0], mx[b, 0] = left, left + 5
        for k in range(1, K):
            kind = (k + b) % 7
            y0 = int(rng.integers(0, max(1, H // 4)))
            y1 = H - int(rng.integers(0, max(1, H // 4)))
            rows = (y >= y0) & (y < y1)
            if kind == 0:  # upright bar
                x0 = int(rng.integers(0, 200))
                mn[b, k, rows], mx[b, k, rows] = x0, x0 + int(rng.integers(0, 9))
            elif kind == 1:  # slanted bar
                sl = rng.uniform(-2.5, 2.5)
                xs = np.floor(300 + sl * (y - y0)).astype(np.int64)
                mn[b, k, rows], mx[b, k, rows] = xs[rows], xs[rows] + int(rng.integers(1, 6))
            elif kind == 2:  # rotated rectangle
                a = rng.uniform(0, np.pi)
                hw, hh = rng.uniform(3, 60), rng.uniform(3, H / 3)
                cy, xs = (y0 + y1) / 2, np.arange(0, 800)
                for yy in range(y0, y1):
                    u = (xs - 400.0) * np.cos(a) + (yy - cy) * np.sin(a)
                    v = -(xs - 400.0) * np.sin(a) + (yy - cy) * np.cos(a)
                    inside = xs[(np.abs(u) <= hw) & (np.abs(v) <= hh)]
                    if inside.size:
                        mn[b, k, yy], mx[b, k, yy] = inside.min(), inside.max()
            elif kind == 3:  # noise rows
                keep = rows & (rng.random(H) < 0.7)
                lo = rng.integers(0, 300, H)
                mn[b, k, keep], mx[b, k, keep] = lo[keep], lo[keep] + rng.integers(0, 40, H)[keep]
            elif kind == 4:  # one row
                mn[b, k, y0], mx[b, k, y0] = 5, 5 + int(rng.integers(0, 30))
            elif kind == 5:  # one point
                mn[b, k, y1 - 1] = mx[b, k, y1 - 1] = 7
    return torch.from_numpy(mn.astype(np.int32)), torch.from_numpy(mx.astype(np.int32))


def round_extremes(B, K, H, seed):
    """``synthetic_extremes`` with slot 0 a convex blob over every row whose
    every row is a hull point on both chains: integer steps nondecreasing
    from -40 to 40 (the most distinct directions a chain of integer points
    over H rows can take at this width)."""
    import torch

    mn, mx = (t.numpy().copy() for t in synthetic_extremes(B, K, H, seed))
    rng = np.random.default_rng(seed)
    for b in range(B):
        c = np.cumsum(np.sort(rng.integers(-40, 41, H)))
        c -= c.min()
        mn[b, 0], mx[b, 0] = 100 + c, 150 + 2 * int(c.max()) - c
    return torch.from_numpy(mn), torch.from_numpy(mx)


_PERMS = np.array(list(permutations(range(4))))


def with_compat(run):
    """run() with UBDVSS_PALLAS_COMPAT=1 set for the call, then restored."""
    old = os.environ.get("UBDVSS_PALLAS_COMPAT")
    os.environ["UBDVSS_PALLAS_COMPAT"] = "1"
    try:
        return run()
    finally:
        if old is None:
            del os.environ["UBDVSS_PALLAS_COMPAT"]
        else:
            os.environ["UBDVSS_PALLAS_COMPAT"] = old


def same_corner_sets(a, b, atol):
    """(..., 4, 2) boxes -> (...) bool: b's corners are a's in some order."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.linalg.norm(a[..., :, None, :] - b[..., None, :, :], axis=-1)
    return d[..., np.arange(4), _PERMS].max(-1).min(-1) <= atol


def check_rect_rows(out, ref, atol=1e-4) -> tuple[float, int]:
    """Rows within atol with any_edge identical; a component whose rows
    differ must be the same rectangle reported from its other side (an
    exact tie of folded caliper angles, decided by rsqrt's last bit)."""
    from ubdvss_tpu_torch.ops.cuda.rect_kernel import rects_from_selection
    import torch

    if not np.array_equal(out[:, 6], ref[:, 6]):
        raise AssertionError("rect: any_edge differs from the plain version")
    close = np.all(np.abs(out - ref) <= atol, axis=1)
    flips = ~close
    if flips.any():
        ro = rects_from_selection(torch.from_numpy(out))
        rr = rects_from_selection(torch.from_numpy(ref))
        if not same_corner_sets(ro["points"], rr["points"], atol)[flips].all():
            raise AssertionError("rect: rows differ and the rectangles differ")
        ao = ro["size"].prod(-1).numpy()[flips]
        ar = rr["size"].prod(-1).numpy()[flips]
        if not np.allclose(ao, ar, atol=atol, rtol=1e-6):
            raise AssertionError("rect: tie flip with a different area")
    err = float(np.abs(out - ref)[np.broadcast_to(close[:, None], out.shape)].max())
    return err, int(flips.sum())


def exact_stats(logits, slots, K) -> dict:
    """The plain version's det_sums and cls_sums summed in f64: at a few
    hundred thousand pixels a component the f32 one-hot products drift from
    the exact sum by more than the kernels' own rounding."""
    import torch

    B, H, W, C = logits.shape
    idx = slots.reshape(B, H * W).long()
    det = torch.sigmoid(logits[..., 0].double()).reshape(B, H * W)
    if logits.dtype == torch.bfloat16:  # the f32 softmax rounded to bf16, as summed
        cls = torch.softmax(logits[..., 1:].float(), -1).bfloat16().double()
    else:
        cls = torch.softmax(logits[..., 1:].double(), -1)
    cls = cls.reshape(B, H * W, C - 1)
    d = torch.zeros((B, K + 1), dtype=torch.float64, device=logits.device).scatter_add_(1, idx, det)
    c = torch.zeros((B, K + 1, C - 1), dtype=torch.float64, device=logits.device).scatter_add_(
        1, idx[..., None].expand(-1, -1, C - 1), cls)
    return {"det_sums": d[:, :K], "cls_sums": c[:, :K]}


def bf16_cls_slack(logits, slots, K):
    """(B, K, C-1): per slot and class, the most the sum of the bf16-rounded
    class probabilities can move when the kernel's f32 softmax differs from
    torch's by a few ulps (expf against torch's exp): the bf16 step at each
    probability of the slot within 8 f32 ulps of a bf16 rounding boundary."""
    import torch

    B, H, W, C = logits.shape
    sm = torch.softmax(logits[..., 1:].float(), -1)
    step = (sm * (1 + 8 * 2.0**-24)).bfloat16().float() - (sm * (1 - 8 * 2.0**-24)).bfloat16().float()
    idx = slots.reshape(B, H * W).long()
    return torch.zeros((B, K + 1, C - 1), device=logits.device).scatter_add_(
        1, idx[..., None].expand(-1, -1, C - 1), step.reshape(B, H * W, C - 1))[:, :K]


def check_stats(out, ref, name, atol=2e-6, exact=None, logits=None) -> float:
    """Slot outputs and areas identical; det_sums / areas and cls_sums /
    areas within atol (f32 sums in another order) of the plain version's,
    or of ``exact`` (``exact_stats``) where given.  On bf16 ``logits`` the
    cls means may also move by ``bf16_cls_slack`` over the area (a
    probability at a bf16 rounding boundary that expf rounds the other
    way).  Returns the max error of the means."""
    for key in ("rootvals", "slots", "minx", "maxx", "num_components_total", "areas"):
        if not out[key].equal(ref[key]):
            raise AssertionError(f"{name}: {key} differs from the plain version")
    want = ref if exact is None else exact
    area = ref["areas"].clamp(min=1).to(want["det_sums"].dtype)
    err_det = (out["det_sums"] / area - want["det_sums"] / area).abs()
    err_cls = (out["cls_sums"] / area[..., None] - want["cls_sums"] / area[..., None]).abs()
    import torch

    slack = 0.0
    if logits is not None and logits.dtype == torch.bfloat16:
        slack = bf16_cls_slack(logits, ref["slots"], out["areas"].shape[1]).to(area.dtype)
        slack = slack / area[..., None]
    if not (float(err_det.max()) <= atol and bool((err_cls <= atol + slack).all())):
        raise AssertionError(f"{name}: stats means max|err| {float(err_det.max())}, "
                             f"{float((err_cls - slack).max())} past the bf16 slack > {atol}")
    return max(float(err_det.max()), float(err_cls.max()))


def compare_detections(out, ref, det_logits, box_atol, score_atol, margin=1e-4):
    """Detections of the kernel path == the plain path, image by image.

    Images holding a det logit within ``margin`` of the threshold are left
    out (one pixel may flip on rounding alone; 0 where the logits are equal
    bit for bit); so are class ids whose top two mean probabilities are
    within 1e-5.  Returns the counts left out."""
    near = (np.abs(det_logits) < margin).reshape(len(det_logits), -1).any(1)
    keep = ~near
    for key in ("valid", "areas", "num_detections", "num_components_total"):
        if not np.array_equal(out[key][keep], ref[key][keep]):
            raise AssertionError(f"main path: {key} differs from the plain route")
    v = out["valid"][keep]
    srt = np.sort(ref["class_probs"][keep], -1)
    sure = v & (srt[..., -1] - srt[..., -2] > 1e-5)
    if not np.array_equal(out["classes"][keep][sure], ref["classes"][keep][sure]):
        raise AssertionError("main path: classes differ from the plain route")
    if not np.allclose(out["scores"][keep][v], ref["scores"][keep][v], atol=score_atol):
        raise AssertionError("main path: scores differ from the plain route")
    ok = same_corner_sets(out["boxes"][keep][v], ref["boxes"][keep][v], box_atol)
    if not ok.all():
        raise AssertionError("main path: boxes differ from the plain route")
    return int(near.sum()), int((v & ~sure).sum())


def compare_bf16_detections(out, ref, det_out, det_ref, logit_tol, name,
                            score_tol=SCORE_TOL_BF16, cls_tol=CLS_TOL_BF16,
                            min_kept=1) -> dict:
    """Detections of a bf16 route against another computation of the same
    route (the card against the host CPU), whose logits may differ by a
    bf16 rounding: a pixel may change sides of the threshold only where its
    detection logit lies within ``logit_tol`` of it (checked), and an image
    where one did is left out; in every other image valid, areas, counts
    identical, classes where the top two mean probabilities are further
    apart than ``cls_tol``, scores and class probabilities within their
    tolerances, boxes within 1.5 px as corner sets (the JAX package's bound
    between its routes, tests/test_quant.py:160-166).  Fails when fewer
    than ``min_kept`` images are compared.  Returns what was measured."""
    flipped = (det_out > 0) != (det_ref > 0)  # threshold 0.5: logit 0
    if not (np.abs(det_ref[flipped]) <= logit_tol).all():
        raise AssertionError(f"{name}: a mask differs away from the threshold")
    keep = ~flipped.reshape(len(det_out), -1).any(1)
    if keep.sum() < min_kept:
        raise AssertionError(f"{name}: {int(keep.sum())} images compared, fewer than {min_kept}")
    for key in ("valid", "areas", "num_detections", "num_components_total"):
        if not np.array_equal(out[key][keep], ref[key][keep]):
            raise AssertionError(f"{name}: {key} differs")
    v = ref["valid"][keep]
    srt = np.sort(ref["class_probs"][keep], -1)
    sure = v & (srt[..., -1] - srt[..., -2] > cls_tol)
    if not np.array_equal(out["classes"][keep][sure], ref["classes"][keep][sure]):
        raise AssertionError(f"{name}: classes differ")
    d_score = float(np.abs(out["scores"][keep][v] - ref["scores"][keep][v]).max(initial=0))
    d_cls = float(np.abs(out["class_probs"][keep][v] - ref["class_probs"][keep][v]).max(initial=0))
    if not (d_score <= score_tol and d_cls <= cls_tol):
        raise AssertionError(f"{name}: scores {d_score} or class probabilities {d_cls} differ")
    if not same_corner_sets(out["boxes"][keep][v], ref["boxes"][keep][v], 1.5).all():
        raise AssertionError(f"{name}: boxes differ by more than 1.5 px")
    return {"left_out": int((~keep).sum()), "compared_detections": int(v.sum()),
            "score": d_score, "class_probs": d_cls,
            "box": float(np.abs(out["boxes"][keep][v] - ref["boxes"][keep][v]).max(initial=0))}


def logit_copies(run, numel: int) -> list:
    """The copy and cast operators of one run of ``run`` (torch.profiler,
    operator shapes) whose input has ``numel`` elements: on the bf16 path
    with the logits' numel, any f32 copy of the whole logits."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    ops = ("aten::to", "aten::_to_copy", "aten::copy_", "aten::contiguous", "aten::clone")
    return [(e.name, e.input_shapes) for e in prof.events() if e.name in ops
            and any(sh and math.prod(sh) == numel for sh in e.input_shapes)]


def is_stats_kernel(name: str) -> bool:
    """A device kernel of the torch one-hot stats: cuBLAS gemv or gemm (not
    the stem's implicit-GEMM convolution, nor a bf16 GEMM, which is the bf16
    head's 1x1 conv as cuDNN may run it: the plain stats multiply in f32),
    the one-hot compare, sigmoid or softmax."""
    n = name.lower()
    gemm = "gemm" in n and not any(t in n for t in ("implicit", "conv", "bf16"))
    return gemm or any(t in n for t in ("gemv", "compareeq", "sigmoid", "softmax"))


def is_library_conv(name: str) -> bool:
    """A device kernel of cuDNN's convolutions (or its layout conversion)."""
    n = name.lower()
    return any(t in n for t in ("cudnn", "xmma", "implicit", "convolve", "fprop", "nchwtonhwc",
                                "winograd", "fft"))


def qparams_diff(a: dict, b: dict) -> dict:
    """How far two int8 qparams are apart: int8 weights differing, the
    largest relative difference of a scale (s_in, ws), the largest bias
    difference."""
    la, lb = a["layers"] + [a["head"]], b["layers"] + [b["head"]]

    def rel(x, y):
        x, y = x.cpu(), y.cpu()
        return float(((x - y).abs() / y.abs()).max())

    return {
        "int8_weights": sum(int(x["q"].numel()) for x in la),
        "int8_weights_differing": sum(int((x["q"].cpu() != y["q"].cpu()).sum()) for x, y in zip(la, lb)),
        "max_rel_scale_diff": max([rel(x, y) for x, y in zip(a["s_in"], b["s_in"])]
                                  + [rel(x["ws"], y["ws"]) for x, y in zip(la, lb)]),
        "max_abs_bias_diff": max(float((x["b"].cpu() - y["b"].cpu()).abs().max()) for x, y in zip(la, lb)),
    }


def check_qparams(diff: dict, name: str) -> None:
    """The card's calibration against the host CPU's: the f32 convs sum in
    another order, so the scales may differ within 1e-5 relative (the CPU
    tests' bound against JAX), a weight at a rounding boundary may flip
    (at most 0.1% of them) and a corrected bias move with it (1e-3)."""
    if not (diff["max_rel_scale_diff"] <= 1e-5 and diff["max_abs_bias_diff"] <= 1e-3
            and diff["int8_weights_differing"] <= 1e-3 * diff["int8_weights"]):
        raise AssertionError(f"{name}: card and host CPU calibrations too far apart: {diff}")


def profile_path(run, ms_per_batch: float, iters: int = 3, no_convs: bool = False) -> dict:
    """Device time of the main path by kernel (torch.profiler, CUPTI).

    Only kernel rows are summed (operator rows repeat their kernels' time);
    one stream runs them, so the sum is the device's busy time.  With
    ``no_convs`` a cuDNN convolution row fails it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / iters / 1e3)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    stats_rows = [k for k, _ in rows if is_stats_kernel(k)]
    if stats_rows:
        raise AssertionError(f"the path ran torch stats kernels on the card: {stats_rows}")
    conv_rows = [k for k, _ in rows if is_library_conv(k)]
    if no_convs and conv_rows:
        raise AssertionError(f"the path ran cuDNN convolutions: {conv_rows}")
    by_name: dict[str, float] = {}  # kernels whose names share 100 chars are summed
    for k, ms in rows:
        by_name[k[:100]] = by_name.get(k[:100], 0.0) + ms
    return {
        "profile_ms_per_batch": dict(sorted(by_name.items(), key=lambda r: -r[1])[:24]),
        "device_busy_ms": busy,
        "busy_share": busy / ms_per_batch,
    }


def device_busy(run) -> dict:
    """One call of ``run`` under torch.profiler: its wall ms, the device's
    busy ms (the union of its kernels' and copies' intervals: the prefetch
    and readback streams overlap the compute stream), the busy share and
    the device ms by kernel (summed over streams)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev_events):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    by_name: dict[str, float] = {}
    for e in dev_events:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3
    kernels_run = [e for e in dev_events if not e.name.startswith(("Memcpy", "Memset"))]
    return {"wall_ms": wall, "device_busy_ms": busy / 1e3, "busy_share": busy / 1e3 / wall,
            "kernel_launches": len(kernels_run),
            "device_ms_by_kernel": dict(sorted(by_name.items(), key=lambda r: -r[1])[:16])}


def mesh_training(dev, smi: str, counted, eval_not: list) -> dict:
    """Phase 9, training over a mesh (the module docstring); returns its
    report.  ``counted(run, must_launch, must_not)`` runs ``run`` with the
    launch counters set to 0 and returns (its result, the counts)."""
    import dataclasses
    import socket

    import torch
    import torch.distributed as dist

    from ubdvss_tpu_torch import NetConfig, load_net_config, synthgen
    from ubdvss_tpu_torch.data import Batches, DataConfig, DeviceCachedBatches
    from ubdvss_tpu_torch.evaluate import run_evaluation
    from ubdvss_tpu_torch.ops.augment import affine_draws, photometric_draws
    from ubdvss_tpu_torch.parallel import entry_rows, make_mesh, reduce_to_first, shard_batch_to_mesh
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
    from ubdvss_tpu_torch.train import Trainer, create_train_state, setup_devices, train_step

    lr, Bt = 1e-3, TRAIN_BENCH_B
    mesh = make_mesh(MESH_ENTRIES, devices=[dev] * MESH_ENTRIES)
    dc = DataConfig(batch_size=Bt, train_hw=(IMG, IMG), seed=0)
    reader = SyntheticMarkupReader(n_samples=MESH_STEPS * Bt, image_hw=(IMG, IMG), seed=SEED)
    reader.samples()  # render once: the reader keeps the scenes
    cfg32 = NetConfig()
    sc = synthgen.SynthConfig(hw=(IMG, IMG), max_polys=dc.max_polys, max_verts=dc.max_verts,
                              class_names=tuple(cfg32.class_names))
    report: dict = {"card": smi, "mesh": str(mesh), "batch": Bt, "image": IMG, "steps": MESH_STEPS}
    syn = synthgen.DeviceSyntheticBatches(cfg32, dc, n_samples=MESH_STEPS * Bt, seed=SEED, device=dev)
    host = Batches(reader, cfg32, dc, train=True, device=dev)
    cached_1 = DeviceCachedBatches(reader, cfg32, dc, device=dev)
    cached_4 = DeviceCachedBatches(reader, cfg32, dc, mesh=mesh)
    if [sh[0].shape[0] for sh in cached_4._shards] != [MESH_STEPS * Bt // MESH_ENTRIES] * MESH_ENTRIES:
        raise AssertionError("mesh training: the cached corpus is not sharded a quarter an entry")
    pipelines = {"host_fed": (host, host), "synthesized": (syn, syn), "cached": (cached_1, cached_4)}

    def first_batches(name):
        """The pipeline's first batch, whole and as the mesh's shards."""
        if name == "host_fed":
            whole = next(iter(host.epoch(0)))
            return whole, shard_batch_to_mesh(whole, mesh)
        if name == "synthesized":
            shards = [synthgen.synth_batch_step(synthgen.step_generator(SEED, 0, 0, d), sc, cfg32, dc, True,
                                                rows=entry_rows(Bt, mesh, i))
                      for i, d in enumerate(mesh.axis_devices("data"))]
            return syn.batch_at(0, 0), shards
        return (cached_1.batch_at(cached_1.order(0), 0, 0),
                cached_4.shards_at(cached_4.host_order(0), 0, 0, mesh))

    def params_diff(a, b) -> torch.Tensor:
        return torch.cat([(a.params[k] - v).detach().abs().ravel() for k, v in b.params.items()])

    def epoch_ms(tr, batches, epoch) -> float:
        """ms a step over one epoch as ``Trainer.fit`` runs it (CUDA events)."""
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for run, _ in tr._epoch_steps(batches, epoch):
            tr.state, _ = run(tr.state)
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / MESH_STEPS

    prev_det = torch.backends.cudnn.deterministic
    trained = None
    report["pipelines"] = {}
    for dtype in ("float32", "bfloat16"):
        cfg = cfg32.replace(dtype=dtype)
        f32 = dtype == "float32"
        for name, (b1, b4) in pipelines.items():
            row: dict = {}
            torch.backends.cudnn.deterministic = True
            try:
                whole, shards = first_batches(name)
                if name != "host_fed":
                    m = Bt // MESH_ENTRIES
                    if not all(torch.equal(s[k], whole[k][i * m:(i + 1) * m])
                               for i, s in enumerate(shards) for k in whole):
                        raise AssertionError(f"mesh training {name}: a shard differs from the whole batch's rows")
                one, m1 = train_step(create_train_state(cfg, lr=lr, device=dev), whole, cfg)
                four, m4 = train_step(create_train_state(cfg, lr=lr, device=dev), shards, cfg, mesh=mesh)
                g_rel = max(float((four.params[k].grad - p.grad).abs().max() / p.grad.abs().max().clamp(min=1e-30))
                            for k, p in one.params.items())
                if not g_rel <= (1e-5 if f32 else 2e-2):
                    raise AssertionError(f"mesh training {name} {dtype}: reduced gradient {g_rel} of max|g| apart")
                errs = {}
                for k, v in m1.items():
                    a_, b_ = float(m4[k]), float(v)
                    errs[k] = abs(a_ - b_)
                    if k.startswith("pixel_"):
                        tol = 1e-6 if f32 else 2e-3
                    else:
                        tol = ((1e-5 if f32 else 2e-2) if k == "grad_norm" else (1e-5 if f32 else 1e-3)) * abs(b_)
                        tol += 1e-7
                    if not errs[k] <= tol:
                        raise AssertionError(f"mesh training {name} {dtype}: first step {k} {a_} sharded, {b_} not")
                row["first_step"] = {"grad_rel_err": g_rel, **errs}
                t1 = Trainer(cfg, dc, lr=lr, device=dev, steps_per_dispatch=4)
                t4 = Trainer(cfg, dc, lr=lr, mesh=mesh, steps_per_dispatch=4)
                t1.fit(b1, 1)
                t4.fit(b4, 1)
            finally:
                torch.backends.cudnn.deterministic = prev_det
            d = params_diff(t4.state, t1.state)
            l4, l1 = t4._last_train_metrics["loss"], t1._last_train_metrics["loss"]
            row["fit"] = {"steps": t4.state.step, "params_max_abs_err": float(d.max()),
                          "params_median_abs_err": float(d.median()), "loss": l4, "loss_unsharded": l1}
            if not (t4.state.step == t1.state.step == MESH_STEPS and float(d.max()) <= 2 * lr * MESH_STEPS
                    and (not f32 or float(d.median()) <= 1e-5) and abs(l4 - l1) <= 1e-3 * abs(l1)):
                raise AssertionError(f"mesh training {name} {dtype}: the sharded fit differs: {row['fit']}")
            if f32 and name == "host_fed":
                trained = {k: v.detach().clone() for k, v in t4.state.params.items()}
            ms4 = [epoch_ms(t4, b4, e) for e in (1, 2, 3)]
            ms1 = [epoch_ms(t1, b1, e) for e in (1, 2, 3)]
            row["ms_per_step"] = statistics.median(ms4)
            row["ms_per_step_unsharded"] = statistics.median(ms1)
            row["ratio"] = row["ms_per_step"] / row["ms_per_step_unsharded"]
            report["pipelines"][f"{name}_{dtype}"] = row
            log(f"mesh training {name} {dtype}: first step gradient {g_rel:.3g} of max|g|, loss "
                f"{errs['loss']:.3g}, grad_norm {errs['grad_norm']:.3g}; fit of {MESH_STEPS} steps: parameters "
                f"max {row['fit']['params_max_abs_err']:.3g}, median {row['fit']['params_median_abs_err']:.3g}, "
                f"last loss {l4:.6f} against {l1:.6f}; {row['ms_per_step']:.2f} ms a step over "
                f"{MESH_ENTRIES} entries against {row['ms_per_step_unsharded']:.2f} ({row['ratio']:.2f}x)")
            del t1, t4

    # the reduction: four flat gradients and four metric-sum vectors
    n_params = sum(v.numel() for v in trained.values())
    g4 = [torch.randn(n_params, device=dev) for _ in range(MESH_ENTRIES)]
    s4 = [torch.randn(11, device=dev, dtype=torch.float64) for _ in range(MESH_ENTRIES)]
    report["reduction_ms"] = time_ms(lambda: (reduce_to_first(g4, mesh), reduce_to_first(s4, mesh)))
    report["gradient_floats"] = n_params

    # the draws of the rows a shard does not render, against its synthesis
    acfg = dc.augment

    def draws(n):
        g = synthgen.step_generator(SEED, 0, 0, dev)
        synthgen.scene_draws(g, sc, n)
        affine_draws(g, acfg, n)
        photometric_draws(g, acfg, (n, IMG, IMG))

    shard_rows = slice(0, Bt // MESH_ENTRIES)
    d_full, d_shard = device_ms(lambda: draws(Bt), n=5), device_ms(lambda: draws(Bt // MESH_ENTRIES), n=5)
    s_shard = device_ms(lambda: synthgen.synth_batch_step(synthgen.step_generator(SEED, 0, 0, dev), sc, cfg32, dc,
                                                           True, rows=shard_rows), n=5)
    s_whole = device_ms(lambda: synthgen.synth_batch_step(synthgen.step_generator(SEED, 0, 0, dev), sc, cfg32, dc,
                                                           True), n=5)
    report["draws"] = {"whole_batch_draws_device_ms": d_full, "shard_draws_device_ms": d_shard,
                       "shard_synthesis_device_ms": s_shard, "whole_synthesis_device_ms": s_whole,
                       "redundant_share_of_shard_synthesis": (d_full - d_shard) / s_shard}
    log(f"mesh training: reduction of {MESH_ENTRIES} x {n_params} floats + metric sums {report['reduction_ms']:.4f} "
        f"ms; a B={Bt // MESH_ENTRIES} shard's synthesis {s_shard:.3f} ms device (the whole batch's {s_whole:.3f}), "
        f"of which the draws of the other {Bt - Bt // MESH_ENTRIES} rows {d_full - d_shard:.3f} "
        f"({100 * (d_full - d_shard) / s_shard:.1f}%)")

    # the trained model through the serving kernels, over the mesh
    cfg_ev = load_net_config(REPO / "assets" / "pretrained_synthetic.npz")
    if (cfg_ev.channels, tuple(cfg_ev.dilations)) != (cfg32.channels, tuple(cfg32.dilations)):
        raise AssertionError("mesh training: the asset's config is not NetConfig()'s architecture")
    rd_ev = SyntheticMarkupReader(n_samples=EVAL_N, image_hw=EVAL_HW, seed=0)
    dc_ev = DataConfig(batch_size=EVAL_BATCH, train_hw=EVAL_HW, max_polys=32)
    must = ["context_layer", "ccl", "slots", "rect_exact"]
    ev_m, n_m = counted(lambda: run_evaluation(trained, rd_ev, cfg_ev, dc_ev, mesh=mesh), must, eval_not)
    _, n_s = counted(lambda: run_evaluation(trained, rd_ev, cfg_ev, dataclasses.replace(
        dc_ev, batch_size=EVAL_BATCH // MESH_ENTRIES), device=dev), must, eval_not)
    ev_1 = run_evaluation(trained, rd_ev, cfg_ev, dc_ev, device=dev)
    if n_m != n_s or ev_m != ev_1:
        raise AssertionError(f"mesh training: evaluation over the mesh {n_m} / {ev_m} against {n_s} / {ev_1}")
    report["evaluation"] = {"images": EVAL_N, "batch": EVAL_BATCH, "f1": ev_m.f1,
                            "launches": {k: n_m[k] for k in must}}
    log(f"mesh training: run_evaluation over {MESH_ENTRIES} entries with the trained parameters, {EVAL_N} "
        f"{EVAL_HW[0]}² scenes at batch {EVAL_BATCH}: F1 {ev_m.f1:.4f} == without the mesh; launches "
        f"{report['evaluation']['launches']} == the unsharded run's at batch {EVAL_BATCH // MESH_ENTRIES}")

    # one process group of one rank on NCCL: a step through all_reduce
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        port = s_.getsockname()[1]
    calls = []
    all_reduce = dist.all_reduce

    def counting(t, *a, **kw):
        calls.append(tuple(t.shape))
        return all_reduce(t, *a, **kw)

    dist.all_reduce = counting
    torch.backends.cudnn.deterministic = True
    try:
        mesh_n = setup_devices("1", distributed=True, coordinator=f"localhost:{port}", num_processes=1,
                               process_id=0)
        backend = dist.get_backend()
        batch = next(iter(host.epoch(0)))
        tr_n = Trainer(cfg32, dc, lr=lr, mesh=mesh_n)
        tr_p = Trainer(cfg32, dc, lr=lr, device=dev)
        tr_n.state, m_n = tr_n.step_fn(tr_n.state, tr_n.place_batch(batch))
        tr_p.state, m_p = tr_p.step_fn(tr_p.state, batch)
        torch.cuda.synchronize()
        same = all(torch.equal(tr_n.state.params[k], v) for k, v in tr_p.state.params.items())
        if not (backend == "nccl" and len(calls) == 2 and same and float(m_n["loss"]) == float(m_p["loss"])):
            raise AssertionError(f"mesh training NCCL: backend {backend}, all_reduce calls {calls}, "
                                 f"bit for bit {same}, loss {float(m_n['loss'])} against {float(m_p['loss'])}")
        report["nccl_world_1"] = {"mesh": str(mesh_n), "all_reduce_calls": len(calls), "bit_for_bit": same}
    finally:
        dist.all_reduce = all_reduce
        torch.backends.cudnn.deterministic = prev_det
        if dist.is_initialized():
            dist.destroy_process_group()
    log(f"mesh training: setup_devices(distributed=True) on NCCL at world size 1, "
        f"{report['nccl_world_1']['mesh']}: one step, all_reduce {len(calls)} times {calls}, bit for bit the "
        "unsharded step; the process group destroyed")
    return report


def same_detections(a: dict, b: dict, name: str, score_atol=1e-6, box_atol=1e-4) -> dict:
    """Two routes' detections on the card: valid, areas, classes and counts
    identical, scores within score_atol, boxes (and centres) within
    box_atol.  Returns the largest score and box differences."""
    import torch

    for key in ("valid", "areas", "classes", "num_detections", "num_components_total"):
        if not torch.equal(a[key], b[key]):
            raise AssertionError(f"{name}: {key} differs")
    v = b["valid"]
    err = {"scores": float((a["scores"] - b["scores"])[v].abs().max()) if v.any() else 0.0,
           "boxes": float((a["boxes"] - b["boxes"])[v].abs().max()) if v.any() else 0.0}
    if not (err["scores"] <= score_atol and err["boxes"] <= box_atol):
        raise AssertionError(f"{name}: scores or boxes differ by {err}")
    return err


def packed_route(dev, counted, kernels: list, params_d, params16_d, q_d, cfg_l, cfg_l16,
                 scans, big, lg_l, lg_l16) -> dict:
    """Phase 10, the large-scan packed route: each of its kernel
    modes against its plain version on the card, the route driven through
    detect_program_batch with its launches counted and held against the
    whole-image route (n_strips=1), and its times.  Appends the modes'
    rows to ``kernels``; returns the report."""
    import torch

    from ubdvss_tpu_torch import detect_program_batch
    from ubdvss_tpu_torch.models.model import exact_f32
    from ubdvss_tpu_torch.ops import quant
    from ubdvss_tpu_torch.ops.cuda import ccl_kernel
    from ubdvss_tpu_torch.ops.cuda import context_kernel as ck
    from ubdvss_tpu_torch.ops.cuda import postproc_kernel as pk
    from ubdvss_tpu_torch.ops.cuda import qconv_kernel as kq
    from ubdvss_tpu_torch.ops.postproc import postprocess_batch_fused
    from ubdvss_tpu_torch.ops.strips import packed_trunk_tile_grid
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    report: dict = {}
    K_l, M_l = cfg_l.max_components, cfg_l.max_hull_points
    dil_l = tuple(cfg_l.dilations)
    O = cfg_l.n_output_channels
    PP = (2, 2)
    hw2, hw4 = (SCAN, SCAN), (BIG_SCAN, BIG_SCAN)
    bf16 = ["ccl_bf16", "slots_bf16", "geometry_compat_bf16", "ccl_tiled_bf16", "slots_tiled_bf16"]
    int8 = ["qstem", "qconv", "qconv_head", "qconv_layer", "qrequant"]
    scans_d = torch.from_numpy(scans).to(dev)
    with torch.inference_mode(), exact_f32():
        # a. K4's packed store at the 2048² scans' features: _s2d of its
        # unpacked launch bit for bit; the plain version (the reference
        # context module, then _s2d) within logit_bar; the faithful packed
        # formulation (s2d_context_head on cuDNN, TF32 off) within 1e-4
        xl = ck.stem_apply(params_d, scans_d.float()[..., None], cfg_l, raw_gray=True)
        xl = xl.permute(0, 3, 1, 2).contiguous()  # (8, 24, 512, 512)
        w_l = ck._pack_weights(params_d, dil_l)
        unp = ck.fused_context_head(xl, *w_l, dil_l)
        pkd = ck.fused_context_head(xl, *w_l, dil_l, packed=True)
        if not torch.equal(pkd, ck._s2d_planes(unp)):
            raise AssertionError("context_layer packed store: not _s2d of the unpacked launch")
        ref_k4 = ck._s2d_planes(ck.context_head_reference(xl, *w_l, dil_l))
        err_k4, bar_k4 = float((pkd - ref_k4).abs().max()), logit_bar(ref_k4)
        del ref_k4
        feat_p = ck._s2d(xl.permute(0, 2, 3, 1))  # the packed formulation's input

        def faithful_ctx():
            return ck.s2d_context_head(feat_p, *w_l, dil_l, unpack=False, packed_in=True)

        err_faithful = float((faithful_ctx() - pkd.permute(0, 2, 3, 1)).abs().max())
        if not (err_k4 <= bar_k4 and err_faithful <= 1e-4):
            raise AssertionError(f"context_layer packed store: {err_k4} > {bar_k4} or "
                                 f"{err_faithful} > 1e-4")
        x4 = scans_d[..., None]
        trunk = ck.packed_fused_trunk(params_d, x4, cfg_l, raw_gray=True)
        err_trunk = float((trunk - ck.packed_trunk_reference(params_d, x4, cfg_l, raw_gray=True))
                          .abs().max())
        if not err_trunk <= 1e-4:
            raise AssertionError(f"packed trunk: {err_trunk} off the packed formulation")
        log(f"check context_layer packed store: {tuple(pkd.shape)} == _s2d of the unpacked "
            f"launch bit for bit, max|err| {err_k4:.3g} to the plain version, {err_faithful:.3g} "
            f"to the packed formulation (cuDNN); the packed trunk within {err_trunk:.3g} of the "
            "packed formulation's")

        # qconv_head's packed store on the 2048² scans' int8 chain: _s2d of
        # its unpacked launch and the plain version, bit for bit; the card's
        # packed int8 trunk == the packed formulation (packed int8 kernels,
        # f64 convs) bit for bit on one scan
        L8, s8, n8 = q_d["layers"], q_d["s_in"], len(dil_l)
        qx = kq.qstem(scans_d, L8[0], s8[1], L8[1], s8[2], raw_gray=True)
        for li, d in enumerate(dil_l[:-1]):
            qx = kq.qconv(qx, L8[2 + li], s8[3 + li], d)
        head_args = (qx, L8[1 + n8], s8[2 + n8], dil_l[-1], q_d["head"])
        u8 = kq.qconv_head(*head_args)
        p8 = kq.qconv_head(*head_args, packed=True)
        plain8 = kq.qconv_head_reference(qx[:1], *head_args[1:], packed=True)
        if not (torch.equal(p8, ck._s2d(u8)) and torch.equal(p8[:1], plain8)):
            raise AssertionError("qconv_head packed store: differs from _s2d of its unpacked launch "
                                 "or from its plain version")
        t8 = quant.int8_packed_trunk_apply(q_d, scans_d[:1], cfg_l, raw_gray=True)
        if not torch.equal(t8, quant.int8_packed_trunk_reference(q_d, scans_d[:1], cfg_l,
                                                                 raw_gray=True)):
            raise AssertionError("packed int8 trunk: differs from the packed formulation")
        log(f"check qconv_head packed store: {tuple(p8.shape)} == _s2d of the unpacked launch and "
            "the plain version bit for bit; the packed int8 trunk == the packed formulation "
            "(packed int8 kernels, f64 convs) bit for bit")

        # K2 tiled and the large K12c on phase-major 512² logits (f32: the
        # NHWC view of K4's packed planes; bf16: the dense route's _s2d
        # copy), K=64: the same kernel on the unpacked logits bit for bit on
        # slots, extremes and areas, the stats within 2e-6 (and the count of
        # stats that differ at all); the plain version on the packed logits
        errs_pk = {}
        packed_maps = {"f32": (lg_l, ck._s2d_planes(lg_l.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)),
                       "bf16": (lg_l16, ck._s2d(lg_l16))}
        for name, (lg_, pk_lg) in packed_maps.items():
            lab = ccl_kernel.ccl_labels_tiled(lg_[..., 0].contiguous())
            ref = pk.component_slots_tiled(lg_, lab, K_l)
            out = pk.component_slots_tiled(pk_lg, lab, K_l, packed_phases=PP)
            e1 = check_stats(out, ref, f"slots_tiled packed {name}")
            plain = pk.component_slots_reference(pk_lg, lab, K_l, packed_phases=PP)
            check_stats(out, plain, f"slots_tiled packed {name} (plain)", logits=lg_,
                        exact=exact_stats(lg_, plain["slots"], K_l))
            ref_g = pk.geometry_compat(lg_, K_l)
            out_g = pk.geometry_compat(pk_lg, K_l, packed_phases=PP)
            e2 = check_stats(out_g, ref_g, f"geometry_compat_large packed {name}")
            pair = {k: v for k, v in out.items()}
            for key in out_g:
                if not torch.equal(out_g[key], pair[key]):
                    raise AssertionError(f"geometry_compat_large packed {name}: {key} differs from "
                                         "ccl_tiled then slots_tiled on the packed logits")
            same_bits = sum(not torch.equal(out[k], ref[k]) for k in ("det_sums", "cls_sums"))
            errs_pk[name] = (e1, e2)
            log(f"check slots_tiled and geometry_compat_large on phase-major {tuple(pk_lg.shape)} "
                f"{name} logits, K={K_l}: slots, extremes and areas == the unpacked launch bit for "
                f"bit, stats means max|err| {e1:.3g} / {e2:.3g} ({same_bits} of 2 stats tensors not "
                "bit for bit); the large K12c == the pair bit for bit; == the plain version")

    # b. the route, its launches counted: 2048² B=8 in f32, bf16 and int8,
    # one 4096² scan, the compat route, and the cluster K2 and K12c at a
    # 256² map (1024² scans at K=16)
    def run(p_, c_, images, hw, **kw):
        return lambda: detect_program_batch(p_, images, c_, hw, device=dev, **kw)

    whole = ["context_layer", "ccl_tiled", "slots_tiled", "rect_compact"]
    not_f32 = ["ccl", "slots", "geometry_compat", "rect_exact", *bf16, *int8]
    must_f32 = [*whole, "context_layer_packed", "slots_tiled_packed"]
    runs: dict = {}
    with torch.inference_mode():
        (res_a, lg_a), n_a = counted(run(params_d, cfg_l, scans, hw2), must_f32, not_f32)
        (res_w, lg_w), _ = counted(run(params_d, cfg_l, scans, hw2, n_strips=1), whole, not_f32)
        if (n_a["context_layer"], n_a["context_layer_packed"], n_a["slots_tiled_packed"]) != (
                len(dil_l), 1, 1):
            raise AssertionError(f"packed route f32: launches {n_a}")
        if not torch.equal(lg_a, lg_w):
            raise AssertionError("packed route f32: logits differ from n_strips=1's")
        runs["2048² f32"] = dict(launches=n_a, **same_detections(res_a, res_w, "packed route f32"))
        runs["2048² f32"]["detections"] = int(res_a["num_detections"].sum())

        must16 = ["ccl_tiled_bf16", "slots_tiled_bf16", "slots_tiled_packed", "rect_compact"]
        not16 = ["context_layer", "ccl", "slots", "ccl_tiled", "slots_tiled", "ccl_bf16",
                 "slots_bf16", "geometry_compat", "geometry_compat_bf16", "rect_exact", *int8]
        (res16, lg16), n16 = counted(run(params16_d, cfg_l16, scans, hw2), must16, not16)
        (res16w, lg16w), _ = counted(run(params16_d, cfg_l16, scans, hw2, n_strips=1),
                                     ["ccl_tiled_bf16", "slots_tiled_bf16", "rect_compact"], not16)
        if not torch.equal(lg16, lg16w):
            raise AssertionError("packed route bf16: logits after _d2s differ from n_strips=1's")
        runs["2048² bf16"] = dict(launches=n16, **same_detections(res16, res16w,
                                                                   "packed route bf16"))
        numel = B_SCAN * (SCAN // 4) ** 2 * O
        runs["2048² bf16"]["logit_copies"] = [
            name for name, _ in logit_copies(run(params16_d, cfg_l16, scans_d, hw2,
                                                 detections_only=True), numel)]

        must8 = ["qstem", "qconv", "qconv_head", "qconv_head_packed", "ccl_tiled", "slots_tiled",
                 "slots_tiled_packed", "rect_compact"]
        (res8, lg8), n8_ = counted(run(params_d, cfg_l, scans, hw2, qparams=q_d), must8,
                                   ["context_layer", "ccl", "slots", "geometry_compat",
                                    "rect_exact", "qconv_layer", "qrequant", *bf16])
        direct8 = quant.int8_trunk_apply(q_d, scans_d, cfg_l, raw_gray=True)
        if not torch.equal(lg8, direct8):
            raise AssertionError("packed route int8: logits differ from the direct trunk's")
        runs["2048² int8"] = dict(launches=n8_, **same_detections(
            res8, postprocess_batch_fused(direct8, cfg_l), "packed route int8"))

        big_d = torch.from_numpy(big).to(dev)
        (res_b, lg_b), n_b = counted(run(params_d, cfg_l, big_d, hw4), must_f32, not_f32)
        (res_bw, lg_bw), _ = counted(run(params_d, cfg_l, big_d, hw4, n_strips=1), whole, not_f32)
        if n_b["context_layer"] != len(dil_l):
            raise AssertionError(f"packed route 4096²: {n_b['context_layer']} K4 launches")
        err_b = float((lg_b - lg_bw).abs().max())
        if not err_b <= 1e-4:
            raise AssertionError(f"packed route 4096²: logits {err_b} off n_strips=1's")
        lg_bw_h = lg_bw.cpu().numpy()
        skipped = compare_detections({k: v.cpu().numpy() for k, v in res_b.items()},
                                     {k: v.cpu().numpy() for k, v in res_bw.items()},
                                     lg_bw_h[..., 0], box_atol=1e-4, score_atol=1e-6)
        if skipped[0]:
            raise AssertionError("packed route 4096²: the scan holds a logit at the threshold")
        runs["4096² f32"] = dict(launches=n_b, logits_max_abs_err=err_b,
                                 tiles=list(packed_trunk_tile_grid(*hw4, cfg_l)[1]),
                                 detections=int(res_b["num_detections"].sum()))

        # the compat route on the packed logits: the large K12c reading them
        must_c = ["context_layer", "context_layer_packed", "geometry_compat_large",
                  "geometry_compat_large_packed", "rect_compact"]
        res_c, n_c = counted(lambda: with_compat(run(params_d, cfg_l, scans, hw2))[0], must_c,
                             [*not_f32, "ccl_tiled", "slots_tiled"])
        for k in res_c:
            if not torch.equal(res_c[k], res_a[k]):
                raise AssertionError(f"packed compat route: {k} differs from the default route")
        res_c16, n_c16 = counted(lambda: with_compat(run(params16_d, cfg_l16, scans, hw2))[0],
                                 ["geometry_compat_large_bf16", "geometry_compat_large_packed",
                                  "rect_compact"],
                                 [*not16, "ccl_tiled_bf16", "slots_tiled_bf16"])
        for k in res_c16:
            if not torch.equal(res_c16[k], res16[k]):
                raise AssertionError(f"packed compat route bf16: {k} differs from the default route")
        runs["2048² compat"] = dict(f32=n_c, bf16=n_c16)

        # the cluster K2 and K12c on packed logits: 1024² scans at K=16 (256²
        # maps, where K12c's cluster kernel fits)
        cfg_16 = cfg_l.replace(max_components=16)
        s1k = np.stack([SyntheticMarkupReader(n_samples=4, image_hw=(1024, 1024), seed=SCAN_SEED)
                        .sample_at(i).image for i in range(4)])
        must_k = ["context_layer", "context_layer_packed", "ccl_tiled", "slots", "slots_packed",
                  "rect_compact"]
        (res_k, lg_k), n_k = counted(run(params_d, cfg_16, s1k, (1024, 1024)), must_k,
                                     ["ccl", "slots_tiled", "geometry_compat", "rect_exact",
                                      *bf16, *int8])
        (res_kw, lg_kw), _ = counted(run(params_d, cfg_16, s1k, (1024, 1024), n_strips=1),
                                     ["context_layer", "ccl_tiled", "slots", "rect_compact"],
                                     ["ccl", "slots_tiled", "geometry_compat", "rect_exact"])
        if not torch.equal(lg_k, lg_kw):
            raise AssertionError("packed route 1024²: logits differ from n_strips=1's")
        same_detections(res_k, res_kw, "packed route 1024² K=16")
        res_kc, n_kc = counted(lambda: with_compat(run(params_d, cfg_16, s1k, (1024, 1024)))[0],
                               ["context_layer", "context_layer_packed", "geometry_compat",
                                "geometry_compat_packed", "rect_compact"],
                               ["ccl", "slots", "ccl_tiled", "slots_tiled", "rect_exact"])
        for k in res_kc:
            if not torch.equal(res_kc[k], res_k[k]):
                raise AssertionError(f"packed compat route 1024²: {k} differs from the default")
        runs["1024² K=16"] = dict(default=n_k, compat=n_kc)
        for name, r in runs.items():
            log(f"packed route {name}: {json.dumps(r)}")
        report["runs"] = runs

    # c. times: detect_program_batch auto against n_strips=1 (for int8 the
    # direct trunk, which n_strips does not select), in turns
    def direct8_run():
        return postprocess_batch_fused(quant.int8_trunk_apply(q_d, scans_d, cfg_l, raw_gray=True),
                                       cfg_l)

    pairs = {
        "2048² B=8 f32": (run(params_d, cfg_l, scans_d, hw2, detections_only=True),
                          run(params_d, cfg_l, scans_d, hw2, detections_only=True, n_strips=1)),
        "2048² B=8 bf16": (run(params16_d, cfg_l16, scans_d, hw2, detections_only=True),
                           run(params16_d, cfg_l16, scans_d, hw2, detections_only=True,
                               n_strips=1)),
        "2048² B=8 int8": (run(params_d, cfg_l, scans_d, hw2, qparams=q_d, detections_only=True),
                           direct8_run),
        "4096² B=1 f32": (run(params_d, cfg_l, big_d, hw4, detections_only=True),
                          run(params_d, cfg_l, big_d, hw4, detections_only=True, n_strips=1)),
    }
    times = {}
    with torch.inference_mode():
        for name, (auto, whole_) in pairs.items():
            t = {"auto_ms": [], "whole_ms": [], "auto_device_ms": [], "whole_device_ms": []}
            for which, fn in (("auto", auto), ("whole", whole_), ("whole", whole_),
                              ("auto", auto)):
                t[f"{which}_ms"].append(time_ms(fn, iters=5, reps=2))
                t[f"{which}_device_ms"].append(device_ms(fn, n=3))
            times[name] = t
            log(f"time packed route {name}: auto {t['auto_ms']} ms (device {t['auto_device_ms']}), "
                f"whole-image {t['whole_ms']} ms (device {t['whole_device_ms']})")
        faithful = {"context_ms": time_ms(faithful_ctx, iters=5, reps=2),
                    "context_device_ms": device_ms(faithful_ctx, n=3),
                    "trunk_ms": time_ms(lambda: ck.packed_trunk_reference(
                        params_d, x4, cfg_l, raw_gray=True), iters=5, reps=2),
                    "card_trunk_ms": time_ms(lambda: ck.packed_fused_trunk(
                        params_d, x4, cfg_l, raw_gray=True), iters=5, reps=2)}
        log(f"time the packed formulation on cuDNN at 2048² B=8 (TF32 off): {json.dumps(faithful)}")
        report.update(times=times, faithful_packed_formulation=faithful)

        # d. the modes' rows: each at its path's shapes, beside the same
        # kernel's unpacked launch
        px = B_SCAN * (SCAN // 4) ** 2
        C = xl.shape[1]
        w_bytes = sum(t.numel() for t in w_l) * 4

        def k4(packed):
            return lambda: ck.fused_context_head(xl, *w_l, dil_l, packed=packed)

        rows = [dict(
            name="context_layer_packed", route="cuda", source="ubdvss_tpu_torch/csrc/context_kernel.cu",
            replaces="ubdvss_tpu/ops/pallas/context_kernel.py:388 (s2d_context_head unpack=False)",
            launches=n_a["context_layer_packed"], max_abs_err=err_k4,
            ms=time_ms(k4(True)), device_ms=device_ms(k4(True)),
            unpacked_ms=time_ms(k4(False)), unpacked_device_ms=device_ms(k4(False)),
            plain_ms=time_ms(lambda: ck._s2d_planes(ck.context_head_reference(xl, *w_l, dil_l)),
                             iters=3, reps=1),
            library_ms=faithful["context_ms"],
            bound=bound((px * C + px * O) * 4 + w_bytes,
                        px * (len(dil_l) * (9 * C * 2 + C * C * 2 + 2 * C) + O * C * 2)),
            queued_ms=queued_ms(k4(True), iters=3, reps=2),
            instance=ck.kernel_instance(C, O), plans=k4_plans(xl.shape, O, dil_l),
            byte_floor_ms=k4_byte_floor(xl.shape, O, len(dil_l), w_bytes),
            cudnn_chain_ms=time_ms(lambda: library_chain(xl, w_l, dil_l), iters=3, reps=2),
        )]
        k4r = rows[0]
        log(f"time context_layer_packed (the scans, {tuple(xl.shape)}): {k4r['instance']} "
            f"instance, [P, rows, threads, blocks] by layer {k4r['plans']}; device "
            f"{k4r['device_ms']:.4f} ms, queued {k4r['queued_ms']:.4f}, operation bound "
            f"{k4r['bound'][0]:.4f}, one-launch-a-layer byte floor {k4r['byte_floor_ms']:.4f}, "
            f"cuDNN's chain {k4r['cudnn_chain_ms']:.4f} (the packed formulation "
            f"{k4r['library_ms']:.4f})")
        F_ = torch.nn.functional
        xq = qx.permute(0, 3, 1, 2).float().contiguous()
        wq3 = L8[1 + n8]["q"].permute(3, 2, 0, 1).float().contiguous()
        last_q = kq.qconv(qx, L8[1 + n8], s8[2 + n8], dil_l[-1]).permute(0, 3, 1, 2).float()
        wq1 = q_d["head"]["q"].permute(3, 2, 0, 1).float().contiguous()

        def q8(packed):
            return lambda: kq.qconv_head(*head_args, packed=packed)

        cq = qx.shape[-1]
        ops8 = 2 * px * (cq * cq * 9 + cq * O)
        rows.append(dict(
            name="qconv_head_packed", route="cuda", source="ubdvss_tpu_torch/csrc/qconv_kernel.cu",
            replaces="ubdvss_tpu/ops/quant.py:332 (int8_packed_trunk_apply's head)",
            launches=n8_["qconv_head_packed"], max_abs_err=0.0,
            ms=time_ms(q8(True)), device_ms=device_ms(q8(True)),
            unpacked_ms=time_ms(q8(False)), unpacked_device_ms=device_ms(q8(False)),
            plain_ms=time_ms(lambda: kq.qconv_head_reference(*head_args, packed=True),
                             iters=1, reps=1, warmup=0),
            # one f32 F.conv2d a layer on the int8 values (TF32 off), as the
            # qconv_head row: the 3x3 layer and the 1x1 head
            library_ms=time_ms(lambda: F_.conv2d(xq, wq3, None, 1, dil_l[-1], dil_l[-1]),
                               iters=5, reps=2)
            + time_ms(lambda: F_.conv2d(last_q, wq1), iters=5, reps=2),
            bound=bound(qx.numel() + p8.numel() * 4 + head_args[1]["q"].numel()
                        + q_d["head"]["q"].numel(), ops8, INT8_OPS),
        ))
        for name, (lg_, pk_lg) in packed_maps.items():
            sfx, esz = ("", 4) if name == "f32" else ("_bf16", 2)
            lab = ccl_kernel.ccl_labels_tiled(lg_[..., 0].contiguous())
            geo = pk.component_slots_tiled(pk_lg, lab, K_l, packed_phases=PP)
            in_slot = int((geo["slots"] < K_l).sum())
            H_ = lg_.shape[1]
            ext = B_SCAN * K_l * (2 * H_ + 1) * 4 + B_SCAN * 4
            stat_b = in_slot * (O - 1) * esz + B_SCAN * K_l * (O + 1) * 4
            launches_k2 = (n_a if name == "f32" else n16)["slots_tiled_packed"]
            launches_k12 = (n_c if name == "f32" else n_c16)["geometry_compat_large_packed"]

            def k2(lg_x, pp):
                return lambda: pk.component_slots_tiled(lg_x, lab, K_l, packed_phases=pp)

            def k12(lg_x, pp):
                return lambda: pk.geometry_compat(lg_x, K_l, packed_phases=pp)

            rows += [dict(
                name="slots_tiled_packed" + sfx, route="cuda",
                source="ubdvss_tpu_torch/csrc/postproc_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:381 (packed_phases)",
                launches=launches_k2, max_abs_err=errs_pk[name][0],
                ms=time_ms(k2(pk_lg, PP)), device_ms=device_ms(k2(pk_lg, PP)),
                unpacked_ms=time_ms(k2(lg_, None)), unpacked_device_ms=device_ms(k2(lg_, None)),
                plain_ms=time_ms(lambda: pk.component_slots_reference(pk_lg, lab, K_l,
                                                                      packed_phases=PP),
                                 iters=3, reps=1),
                library_ms=time_ms(lambda: pk._stats_reference(pk_lg, geo["slots"], K_l, PP),
                                   iters=3, reps=1),
                bound=bound(px * (esz + 8) + ext + stat_b, px * 4 + in_slot * O * 8),
            ), dict(
                name="geometry_compat_large_packed" + sfx, route="cuda",
                source="ubdvss_tpu_torch/csrc/geometry_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:50 (packed_phases)",
                launches=launches_k12, max_abs_err=errs_pk[name][1],
                ms=time_ms(k12(pk_lg, PP)), device_ms=device_ms(k12(pk_lg, PP)),
                unpacked_ms=time_ms(k12(lg_, None)), unpacked_device_ms=device_ms(k12(lg_, None)),
                plain_ms=time_ms(lambda: pk.geometry_compat_reference(pk_lg, K_l,
                                                                      packed_phases=PP),
                                 iters=3, reps=1),
                library_ms=None,
                bound=bound(px * (esz + 4) + ext + stat_b, px * 13 + in_slot * O * 8),
            )]
        # the cluster K2 and K12c at the 1024² scans' 256² maps, K=16
        lg_k16 = ck.packed_fused_trunk(params_d, torch.from_numpy(s1k).to(dev)[..., None], cfg_16,
                                       raw_gray=True)  # (4, 128, 128, 68)
        lg_ku = ck._d2s(lg_k16, O)
        lab_k = ccl_kernel.ccl_labels_tiled(lg_ku[..., 0].contiguous())
        geo_k = pk.component_slots(lg_k16, lab_k, 16, packed_phases=PP)
        e_k2 = check_stats(geo_k, pk.component_slots(lg_ku, lab_k, 16), "slots packed")
        geo_kc = pk.geometry_compat(lg_k16, 16, packed_phases=PP)
        e_k12 = check_stats(geo_kc, pk.geometry_compat(lg_ku, 16), "geometry_compat packed")
        for key in geo_k:
            if not torch.equal(geo_k[key], geo_kc[key]):
                raise AssertionError(f"geometry_compat packed: {key} differs from ccl then slots")
        Bk, Hk = lg_ku.shape[:2]
        pxk = Bk * Hk * lg_ku.shape[2]
        in_k = int((geo_k["slots"] < 16).sum())
        ext_k = Bk * 16 * (2 * Hk + 1) * 4 + Bk * 4
        stat_k = in_k * (O - 1) * 4 + Bk * 16 * (O + 1) * 4
        rows += [dict(
            name="slots_packed", route="cuda", source="ubdvss_tpu_torch/csrc/postproc_kernel.cu",
            replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:381 (packed_phases)",
            launches=n_k["slots_packed"], max_abs_err=e_k2,
            ms=time_ms(lambda: pk.component_slots(lg_k16, lab_k, 16, packed_phases=PP)),
            device_ms=device_ms(lambda: pk.component_slots(lg_k16, lab_k, 16, packed_phases=PP)),
            unpacked_ms=time_ms(lambda: pk.component_slots(lg_ku, lab_k, 16)),
            unpacked_device_ms=device_ms(lambda: pk.component_slots(lg_ku, lab_k, 16)),
            plain_ms=time_ms(lambda: pk.component_slots_reference(lg_k16, lab_k, 16,
                                                                  packed_phases=PP),
                             iters=3, reps=1),
            library_ms=time_ms(lambda: pk._stats_reference(lg_k16, geo_k["slots"], 16, PP),
                               iters=3, reps=1),
            bound=bound(pxk * 12 + ext_k + stat_k, pxk * 4 + in_k * O * 8),
            plan=slot_plan_of(lg_k16, 16, PP),
        ), dict(
            name="geometry_compat_packed", route="cuda",
            source="ubdvss_tpu_torch/csrc/geometry_kernel.cu",
            replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:50 (packed_phases)",
            launches=n_kc["geometry_compat_packed"], max_abs_err=e_k12,
            ms=time_ms(lambda: pk.geometry_compat(lg_k16, 16, packed_phases=PP)),
            device_ms=device_ms(lambda: pk.geometry_compat(lg_k16, 16, packed_phases=PP)),
            unpacked_ms=time_ms(lambda: pk.geometry_compat(lg_ku, 16)),
            unpacked_device_ms=device_ms(lambda: pk.geometry_compat(lg_ku, 16)),
            plain_ms=time_ms(lambda: pk.geometry_compat_reference(lg_k16, 16, packed_phases=PP),
                             iters=3, reps=1),
            library_ms=None,
            bound=bound(pxk * 8 + ext_k + stat_k, pxk * 13 + in_k * O * 8),
            plan=slot_plan_of(lg_k16, 16, PP),
        )]
    for r in rows:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        log(f"time {r['name']}: {r['ms']:.4f} ms/call, device {r['device_ms']:.4f} (unpacked "
            f"{r['unpacked_ms']:.4f}, device {r['unpacked_device_ms']:.4f}; plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound {r['bound_ms']:.4f} by "
            f"{r['bound_by']})")
        if "plan" in r:
            log(f"time {r['name']}: slot plan {r['plan']}")
    kernels += rows
    return report


# the widths the JAX package serves past the asset's (phase 11): wide, 48
# channels and 40 symbologies (41 logits); narrow, 10 channels (no compiled
# context width, no multiple of 4) and the asset's 17 logits; the label sets
# off 16 symbologies at the asset's 24 channels: few, the asset's detection
# row and its rows of four symbologies (5 logits), and mid, its 16 and eight
# more (25 logits)
WIDE_C, WIDE_O, NARROW_C = 48, 41, 10
FEW_CLASSES = ("QRCode", "DataMatrix", "EAN13", "Code128")
MID_EXTRA = ("GS1DataBar", "GS1DataBarExpanded", "GS1DataBarLimited", "GS1Composite", "DotCode",
             "AustraliaPost", "KIXCode", "IdentCode")
# each configuration's stats rows: the cluster K2 (f32, bf16), K12c, the
# tiled K2 and the large K12c, phase-major
STATS_ROWS = {
    "wide": ("slots_chunked", "slots_chunked_bf16", "geometry_compat_chunked",
             "slots_tiled_chunked_packed", "geometry_compat_large_chunked_packed"),
    **{name: (f"slots_at{O}", f"slots_at{O}_bf16", f"geometry_compat_at{O}",
              f"slots_tiled_packed_at{O}", f"geometry_compat_large_packed_at{O}")
       for name, O in (("few", 5), ("mid", 25))},
}
N_WIDTH_HOST = 8  # images of a B=64 batch held against the host CPU
N_WIDTH_SCANS = 2  # 2048² scans of the wide configuration
# the int8 any-width rows' kernel instances (csrc/qconv_kernel.cu: stride,
# WIDE accumulator reading, f32 epilogue; qstem_kernel.cu)
INT8_ANY_INSTANCES = {
    "qstem_any": "qstem_any_kernel<WIDE>, eight n8 tiles a pass, a run staged, two blocks an SM",
    "qlayer0_any": "qlayer0_any_kernel, runs staged, four blocks an SM",
    "qconv_any": "qconv_any_kernel<1, WIDE, false>, staged stores",
    "qconv_head_any": "qconv_any_kernel<1, WIDE, false> + head_run_any",
    "qconv_layer_any": "qconv_any_kernel<1, WIDE, true>",
    "qrequant_any": "qrequant_any_kernel",
    "qconv_head_packed_any": "qconv_any_kernel<1, WIDE, false> + head_run_any, phase-major",
}
# device ms of the kernels' earlier designs at these rows' shapes, printed in
# brackets beside this run's: the per-pixel column K4 and the four-tile,
# one-block-an-SM int8 conv with its stores from registers; K4's guarded
# instance at the next compiled width and the stats' pass a 32-class chunk;
# the stem's four-tile passes with layer 1 stored from registers, and layer
# 0 alone with 4-byte stores from registers, as scripts/torch_kernel_ab.py
# --only widths read them (the parent's two turns, CUDA events around calls
# queued behind a sleep) on an NVIDIA H100 80GB HBM3 at 700 W
PARENT_DESIGN_DEVICE_MS = {
    "context_layer_wide": (18.6810, "(64, 48, 128²), head 41"),
    "context_layer_wide_packed": (9.6049, "(2, 48, 512²), packed"),
    "qconv_any": (1.6093, "the six at 48 channels"),
    "qconv_head_any": (0.4379, "48 channels, 41 logits"),
    "qconv_layer_any": (0.7151, "48 channels"),
    "qstem_any": (0.4596, "B=64 512² uint8, 48 channels"),
    "qlayer0_any": (2.5187, "B=64 512² normalized, 48 channels, y and the accumulator"),
    "context_layer_any": (0.9354, "(64, 10, 128²), head 17"),
    "slots_chunked": (0.5760, "B=64 128², K=16, 41 logits"),
    "slots_chunked_bf16": (0.4431, "B=64 128², K=16, 41 bf16 logits"),
    "geometry_compat_chunked": (0.5892, "B=64 128², K=16, 41 logits"),
    "slots_tiled_chunked_packed": (0.4344, "2×512², K=16, 41 phase-major logits"),
    "geometry_compat_large_chunked_packed": (0.4727, "2×512², K=16, 41 phase-major logits"),
    # the spilling 33-channel instance at 5 and 25 logits, on the wide
    # configuration's logits cut to those counts
    "slots_at5": (0.1245, "B=64 128², K=16, 5 logits, the 33-channel instance"),
    "slots_at5_bf16": (0.1247, "B=64 128², K=16, 5 bf16 logits, the 33-channel instance"),
    "geometry_compat_at5": (0.1460, "B=64 128², K=16, 5 logits, the 33-channel instance"),
    "slots_tiled_packed_at5": (0.0631, "2×512², K=16, 5 phase-major logits, the 33-channel instance"),
    "geometry_compat_large_packed_at5": (0.0868, "2×512², K=16, 5 phase-major logits, the 33-channel "
                                                 "instance"),
    "slots_at25": (0.2022, "B=64 128², K=16, 25 logits, the 33-channel instance"),
    "slots_at25_bf16": (0.1910, "B=64 128², K=16, 25 bf16 logits, the 33-channel instance"),
    "geometry_compat_at25": (0.2198, "B=64 128², K=16, 25 logits, the 33-channel instance"),
    "slots_tiled_packed_at25": (0.1053, "2×512², K=16, 25 phase-major logits, the 33-channel instance"),
    "geometry_compat_large_packed_at25": (0.1349, "2×512², K=16, 25 phase-major logits, the 33-channel "
                                                  "instance"),
}


def carry_flat(flat: dict, channels: int, n_out: int, seed: int, scale: float = 0.02) -> dict:
    """The flat weights of a checkpoint carried into a config of
    ``channels`` and ``n_out`` head outputs: every array's overlap with the
    new shape kept, the rest drawn from ``seed`` at ``scale``."""
    C = flat["downscale_0/bias"].shape[0]
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(flat):
        a = flat[k]
        shape = list(a.shape)
        for i in range(a.ndim):
            if a.shape[i] == C and (a.ndim == 1 or i >= 2):
                shape[i] = channels
        if k.startswith("head/"):
            shape[-1] = n_out
        new = rng.normal(0, scale, shape).astype(np.float32)
        ov = tuple(slice(0, min(x, y)) for x, y in zip(a.shape, shape))
        new[ov] = a[ov]
        out[k] = new
    return out


def width_configs(asset) -> dict:
    """name -> (NetConfig, flat weights) of the wide configuration (the
    asset's 24 channels carried into the first 24 of 48, the 24 new ones
    and the 24 new class rows drawn from SEED at a small scale), the
    narrow one (init_params at SEED, the head scaled by 1000 and the
    detection bias set to -0.5 so that the detection logits leave the
    threshold), few (the asset with its detection row and the head rows
    of FEW_CLASSES) and mid (the asset's 17 rows and the 8 of MID_EXTRA
    drawn from SEED at a small scale), all at the main path's K and M."""
    from ubdvss_tpu_torch import NetConfig, load_params_npz
    from ubdvss_tpu_torch.models.model import init_params
    from ubdvss_tpu_torch.utils.checkpoint import flat_from_params

    base = NetConfig(max_components=K, max_hull_points=M)
    wide = base.replace(channels=WIDE_C, class_names=tuple(f"sym{i}" for i in range(WIDE_O - 1)))
    narrow = base.replace(channels=NARROW_C)
    p = init_params(narrow, SEED)
    p["head.weight"] = p["head.weight"] * 1000.0
    p["head.bias"][0] = -0.5
    flat = load_params_npz(asset)
    rows = [0] + [1 + base.class_names.index(n) for n in FEW_CLASSES]
    few = {**flat, "head/kernel": flat["head/kernel"][..., rows], "head/bias": flat["head/bias"][rows]}
    mid = base.replace(class_names=base.class_names + MID_EXTRA)
    return {"wide": (wide, carry_flat(flat, WIDE_C, WIDE_O, SEED)),
            "narrow": (narrow, flat_from_params(p)),
            "few": (base.replace(class_names=FEW_CLASSES), few),
            "mid": (mid, carry_flat(flat, base.channels, mid.n_output_channels, SEED))}


def every_width(dev, counted, kernels: list, imgs, scans) -> dict:
    """Phase 11, every width the JAX package serves: the wide, narrow, few
    and mid configurations (width_configs) through the paths, each instance
    the asset's widths never reach checked against its plain version, and
    a kernel row for each.  Appends the rows to ``kernels``; returns the
    report."""
    import torch

    from ubdvss_tpu_torch import BarcodeDetector, detect_program_batch, params_from_flat
    from ubdvss_tpu_torch.models.model import exact_f32
    from ubdvss_tpu_torch.ops.cuda import ccl_kernel
    from ubdvss_tpu_torch.ops.cuda import context_kernel as ck
    from ubdvss_tpu_torch.ops.cuda import postproc_kernel as pk
    from ubdvss_tpu_torch.ops.cuda import qconv_kernel as kq
    from ubdvss_tpu_torch.ops.quant import qparams_to, quantize_trunk

    F_ = torch.nn.functional
    tiled, tiled16 = ["ccl_tiled", "slots_tiled"], ["ccl_tiled_bf16", "slots_tiled_bf16"]
    bf16 = ["ccl_bf16", "slots_bf16", "geometry_compat_bf16", *tiled16]
    trunk8 = ["qstem", "qconv", "qconv_head"]
    nh_ = N_WIDTH_HOST
    imgs_d = torch.from_numpy(imgs).to(dev)
    calib_d = (imgs_d[:8].float() / 127.5 - 1.0)[..., None]
    torch.set_num_threads(os.cpu_count() or 1)
    report, rows = {}, []

    def host(res):
        return {k: v.cpu().numpy() for k, v in res.items()}

    def k4_bound(xc, w, dil, O):
        B_, C, H, W = xc.shape
        px = B_ * H * W
        return bound((px * C + px * O) * 4 + sum(t.numel() for t in w) * 4,
                     px * (len(dil) * (9 * C * 2 + C * C * 2 + 2 * C) + O * C * 2))

    for name, (cfg, flat) in width_configs(REPO / "assets" / "pretrained_synthetic.npz").items():
        params = params_from_flat(flat)
        params_d = {k: v.to(dev) for k, v in params.items()}
        dil = tuple(cfg.dilations)
        C, O = cfg.channels, cfg.n_output_channels
        r = report[name] = {"channels": C, "outputs": O, "k4_instance": ck.kernel_instance(C, O)}
        # a. K4's instance on the stem's features of 8 of the batch's images
        with torch.inference_mode(), exact_f32():
            xc = ck.stem_apply(params_d, imgs_d.float()[..., None], cfg,
                               raw_gray=True).permute(0, 3, 1, 2).contiguous()
            w = ck._pack_weights(params_d, dil)
            x8 = xc[:8]
            out = ck.fused_context_head(x8, *w, dil)
            ref_k4 = ck.context_head_reference(x8, *w, dil)
            err_k4 = float((out - ref_k4).abs().max())
            # 1e-5, or 1e-6 of max|logit| where the logits are large (the
            # narrow configuration's head is scaled by 1000)
            tol = logit_bar(ref_k4)
            if not err_k4 <= tol:
                raise AssertionError(f"{name}: context kernel max|err| {err_k4} > {tol}")
            if not torch.equal(ck.fused_context_head(x8, *w, dil, packed=True), ck._s2d_planes(out)):
                raise AssertionError(f"{name}: K4's packed store differs from its unpacked launch")
        r["k4_max_abs_err"] = err_k4
        log(f"check {name} context_layer ({r['k4_instance']} instance): (B,C,H,W)={tuple(x8.shape)}"
            f" O={O} max|err| {err_k4:.3g} <= {tol:.3g}, packed store == _s2d of the unpacked one")

        # b. the f32 main path, the first images held against the host CPU
        main = ["context_layer", "ccl", "slots", "rect_compact"]
        (res_d, lg_d), n_f = counted(
            lambda: detect_program_batch(params_d, imgs, cfg, (IMG, IMG), device="cuda"),
            main, ["geometry_compat", "rect_exact", *tiled, *bf16])
        res, lg = host(res_d), lg_d.cpu().numpy()
        if not (np.isfinite(lg).all() and lg.shape == (B, IMG // 4, IMG // 4, O)):
            raise AssertionError(f"{name} main path: logits not finite or of the wrong shape")
        if int(res["num_detections"].sum()) == 0:
            raise AssertionError(f"{name} main path: no valid detection")
        ref, ref_lg = detect_program_batch(params, imgs[:nh_], cfg, (IMG, IMG), fused=True, device="cpu")
        err_lg = float(np.abs(lg[:nh_] - ref_lg.numpy()).max())
        if not err_lg <= tol:
            raise AssertionError(f"{name} main path: logits differ from the plain route by {err_lg}")
        # an image with a det logit within twice the logits' error of the
        # threshold is left out: only there may a pixel change sides
        skip = compare_detections({k: v[:nh_] for k, v in res.items()}, host(ref), lg[:nh_, ..., 0],
                                  box_atol=4e-4, score_atol=1e-5, margin=max(1e-4, 2 * err_lg))
        r["f32"] = dict(launches={k: n_f[k] for k in main}, detections=int(res["num_detections"].sum()),
                        host_images=nh_, logits_max_abs_err=err_lg, left_out=list(skip))
        log(f"{name} main path: B={B} {IMG}x{IMG} f32 C={C} O={O}, launches {r['f32']['launches']}; "
            f"{r['f32']['detections']} detections; the first {nh_} images == the host CPU's plain "
            f"route: logits max|err| {err_lg:.3g}, {skip[0]} images and {skip[1]} near-tie class ids "
            "left out")
        # the stats instance (O channels) on the first 8 images' logits, K12c
        # equal to it bit for bit
        lg8 = lg_d[:8]
        lab8 = ccl_kernel.ccl_labels_reference(lg8[..., 0].contiguous())
        geo_k = pk.component_slots(lg8, lab8, K)
        err_slots = check_stats(geo_k, pk.component_slots_reference(lg8, lab8, K), f"{name} slots")
        fused = pk.geometry_compat(lg8, K)
        if not all(torch.equal(fused[k], geo_k[k]) for k in geo_k):
            raise AssertionError(f"{name}: geometry_compat differs from slots after CCL")
        r["slots_max_abs_err"] = err_slots
        log(f"check {name} slots at {O} channels (the {pk.stats_channel_bound(O)}-channel instance, "
            f"{pk.class_chunks(O)} class pass(es)): slot "
            f"outputs and areas identical, means max|err| {err_slots:.3g} <= 2e-6; "
            "geometry_compat == slots after CCL bit for bit")

        # c. the compat route: K12c at O channels, detections identical
        res_c, n_c = counted(
            lambda: with_compat(lambda: detect_program_batch(
                params_d, imgs, cfg, (IMG, IMG), detections_only=True, device="cuda")[0]),
            ["context_layer", "geometry_compat", "rect_compact"],
            ["ccl", "slots", "rect_exact", *tiled, *bf16])
        same_detections(res_c, res_d, f"{name} compat route")
        r["compat_launches"] = {k: n_c[k] for k in ("context_layer", "geometry_compat", "rect_compact")}

        # d. bf16: the dense route on cuDNN, the bf16 stats at O channels
        params16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
        params16_d = {k: v.to(dev) for k, v in params16.items()}
        cfg16 = cfg.replace(dtype="bfloat16")
        (res16_d, lg16_d), n16 = counted(
            lambda: detect_program_batch(params16_d, imgs, cfg16, (IMG, IMG), device="cuda"),
            ["ccl_bf16", "slots_bf16", "rect_compact"],
            ["context_layer", "ccl", "slots", "geometry_compat", "geometry_compat_bf16",
             "rect_exact", *tiled, *tiled16])
        res16, lg16 = host(res16_d), lg16_d.cpu().numpy()
        if int(res16["num_detections"].sum()) == 0:
            raise AssertionError(f"{name} bf16 main path: no valid detection")
        ref16, ref_lg16 = detect_program_batch(params16, imgs[:nh_], cfg16, (IMG, IMG), fused=True,
                                               device="cpu")
        ref_lg16 = ref_lg16.numpy()
        tol16 = LOGIT_ULPS * 2.0**-8 * float(np.abs(ref_lg16).max())
        if not float(np.abs(lg16[:nh_] - ref_lg16).max()) <= tol16:
            raise AssertionError(f"{name} bf16: logits past {LOGIT_ULPS} bf16 ulps of the host CPU's")
        cmp16 = compare_bf16_detections({k: v[:nh_] for k, v in res16.items()}, host(ref16),
                                        lg16[:nh_, ..., 0], ref_lg16[..., 0], tol16, f"{name} bf16")
        lgb = ck.fused_model_apply(params16_d, imgs_d[:8].to(torch.bfloat16)[..., None], cfg16,
                                   raw_gray=True, act_out=True)
        lab16 = ccl_kernel.ccl_labels_reference(lgb[..., 0].contiguous())
        geo16 = pk.component_slots(lgb, lab16, K)
        err_slots16 = check_stats(geo16, pk.component_slots_reference(lgb, lab16, K),
                                  f"{name} slots bf16", logits=lgb)
        r["bf16"] = dict(launches={k: n16[k] for k in ("ccl_bf16", "slots_bf16", "rect_compact")},
                         detections=int(res16["num_detections"].sum()), host=cmp16,
                         slots_max_abs_err=err_slots16)
        log(f"{name} bf16 main path: launches {r['bf16']['launches']}, == the bf16 route on the "
            f"host CPU for the first {nh_} images: {cmp16}; bf16 slots at {O} channels within the "
            f"bf16 bounds ({err_slots16:.3g})")

        # e. int8: calibration on the card, the trunk's instances against
        # their plain versions on two images, the main path against the host
        q_d, n_cal = counted(lambda: quantize_trunk(params_d, cfg, calib_d),
                             ["qconv_layer", "qrequant"], [*trunk8, "context_layer"])
        shapes = [tuple(L["q"].shape) for L in q_d["layers"]] + [tuple(q_d["head"]["q"].shape)]
        want = [(3, 3, 1, C), (3, 3, C, C)] + [(3, 3, C, C)] * len(dil) + [(1, 1, C, O)]
        if shapes != want:
            raise AssertionError(f"{name}: qparams {shapes}, expected the JAX package's {want}")
        q_h = qparams_to(q_d, "cpu")
        L8, s8 = q_d["layers"], q_d["s_in"]
        x2 = imgs_d[:2]
        qx = kq.qstem(x2, L8[0], s8[1], L8[1], s8[2], raw_gray=True)
        if not torch.equal(qx.cpu(), kq.qstem_reference(x2.cpu(), q_h["layers"][0], q_h["s_in"][1],
                                                        q_h["layers"][1], q_h["s_in"][2], True)):
            raise AssertionError(f"{name}: qstem differs from its plain version")
        for li, d in enumerate(dil[:-1]):
            nxt = kq.qconv(qx, L8[2 + li], s8[3 + li], d)
            if not torch.equal(nxt.cpu(), kq.qconv_reference(qx.cpu(), q_h["layers"][2 + li],
                                                             q_h["s_in"][3 + li], 1, d)):
                raise AssertionError(f"{name}: qconv layer {li} differs from its plain version")
            qx = nxt
        nd = len(dil)
        head_args = (qx, L8[1 + nd], s8[2 + nd], dil[-1], q_d["head"])
        for packed in (False, True):
            if not torch.equal(kq.qconv_head(*head_args, packed=packed).cpu(),
                               kq.qconv_head_reference(*(_cpu(a) for a in head_args), packed=packed)):
                raise AssertionError(f"{name}: qconv_head (packed={packed}) differs from its plain version")
        y_k, acc_k = kq.qconv_layer_f32(qx, L8[1 + nd], 1, dil[-1])
        y_p, acc_p = kq.qconv_layer_f32(qx.cpu(), q_h["layers"][1 + nd], 1, dil[-1])
        if not (torch.equal(y_k.cpu(), y_p) and torch.equal(acc_k.cpu(), acc_p)):
            raise AssertionError(f"{name}: qconv_layer_f32 differs from its plain version")
        if n_cal["qlayer0"] != 1:
            raise AssertionError(f"{name}: {n_cal['qlayer0']} layer-0 launches in quantize_trunk")
        # layer 0 on the batch that quantize_trunk gave it (the main path's tile plan)
        y0_k, acc0_k = kq.qconv_layer_f32(calib_d, L8[0], 2, 1)
        y0_p, acc0_p = kq.qconv_layer_f32(calib_d.cpu(), q_h["layers"][0], 2, 1)
        if not (torch.equal(y0_k.cpu(), y0_p) and torch.equal(acc0_k.cpu(), acc0_p)):
            raise AssertionError(f"{name}: qconv_layer_f32 on layer 0 differs from its plain version")
        del y0_k, acc0_k, y0_p, acc0_p
        rq = kq.requantize(acc_k, L8[1 + nd]["ws"], L8[1 + nd]["b"], s8[2 + nd])
        if not torch.equal(rq.cpu(), kq.requantize_reference(acc_p, q_h["layers"][1 + nd]["ws"],
                                                             q_h["layers"][1 + nd]["b"], q_h["s_in"][2 + nd])):
            raise AssertionError(f"{name}: requantize differs from its plain version")
        (res8_d, lg8_d), n8 = counted(
            lambda: detect_program_batch(params_d, imgs, cfg, (IMG, IMG), qparams=q_d, device="cuda"),
            [*trunk8, "ccl", "slots", "rect_compact"],
            ["context_layer", "geometry_compat", "rect_exact", "qconv_layer", "qrequant", *tiled, *bf16])
        if [n8[k] for k in trunk8] != [1, len(dil) - 1, 1]:
            raise AssertionError(f"{name} int8: trunk launches {[n8[k] for k in trunk8]}")
        res8, lg8_ = host(res8_d), lg8_d.cpu().numpy()
        if int(res8["num_detections"].sum()) == 0:
            raise AssertionError(f"{name} int8 main path: no valid detection")
        ref8, ref_lg8 = detect_program_batch(params, imgs[:nh_], cfg, (IMG, IMG), qparams=q_h,
                                             fused=True, device="cpu")
        if not np.array_equal(lg8_[:nh_], ref_lg8.numpy()):
            raise AssertionError(f"{name} int8: logits differ from the host CPU's")
        skip8 = compare_detections({k: v[:nh_] for k, v in res8.items()}, host(ref8),
                                   lg8_[:nh_, ..., 0], box_atol=4e-4, score_atol=1e-5, margin=0.0)
        r["int8"] = dict(calibration_launches={k: n_cal[k] for k in ("qconv_layer", "qrequant")},
                         launches={k: n8[k] for k in trunk8}, detections=int(res8["num_detections"].sum()),
                         near_tie_classes=skip8[1], padded_width=-(-C // 4) * 4)
        log(f"{name} int8: calibration launches {r['int8']['calibration_launches']}, qparams in the "
            f"JAX package's shapes; qstem, qconv, qconv_head (and packed), qconv_layer_f32 (layer "
            f"0 and a context layer) and requantize == their plain versions bit for bit; main path launches "
            f"{r['int8']['launches']} at width {r['int8']['padded_width']}, the first {nh_} images' "
            "logits == the host CPU's bit for bit, detections identical")

        # f. BarcodeDetector.detect: K3x, against the host CPU
        det_d = BarcodeDetector(cfg, params, device="cuda")
        det_h = BarcodeDetector(cfg, params, device="cpu")
        n_dets = 0
        for i in range(2):
            dets, n_det = counted(lambda: det_d.detect(imgs[i]),
                                  ["context_layer", "ccl", "slots", "rect_exact"],
                                  ["rect_compact", "geometry_compat", *tiled, *bf16])
            ref_d = det_h.detect(imgs[i])
            if len(dets) != len(ref_d):
                raise AssertionError(f"{name} detect: {len(dets)} detections, the host CPU {len(ref_d)}")
            for o, rr in zip(dets, ref_d):
                if (o.class_id, o.area) != (rr.class_id, rr.area) or abs(o.score - rr.score) > 1e-5:
                    raise AssertionError(f"{name} detect: a detection differs from the host CPU's")
                if not same_corner_sets(o.box, rr.box, 4e-4):
                    raise AssertionError(f"{name} detect: a box differs from the host CPU's")
            n_dets += len(dets)
        r["detect"] = dict(detections=n_dets, launches_of_one_call=n_det["rect_exact"])
        log(f"{name} BarcodeDetector.detect: 2 images, {n_dets} detections == the host CPU's")

        # g. the kernel rows of the instances the asset's widths never reach:
        # K4 off its compiled widths (wide, narrow), the stats at O logits
        # (wide, few, mid)
        if name in ("wide", "narrow"):
            tag = "wide" if name == "wide" else "any"
            k4 = lambda: ck.fused_context_head(xc, *w, dil)  # noqa: E731
            with exact_f32():
                err_lib = float((library_chain(x8, w, dil) - ck.context_head_reference(x8, *w, dil))
                                .abs().max())
                if not err_lib <= tol:
                    raise AssertionError(f"{name}: the library context differs by {err_lib}")
                rows.append(dict(
                    name=f"context_layer_{tag}", route="cuda", source="ubdvss_tpu_torch/csrc/context_kernel.cu",
                    replaces="ubdvss_tpu/ops/pallas/context_kernel.py:39",
                    launches=n_f["context_layer"], max_abs_err=err_k4, channels=C, outputs=O,
                    instance=r["k4_instance"],
                    ms=time_ms(k4, iters=5, reps=2), device_ms=device_ms(k4, n=5), queued_ms=queued_ms(k4),
                    plain_ms=time_ms(lambda: ck.context_head_reference(xc, *w, dil), iters=2, reps=1, warmup=1),
                    library_ms=time_ms(lambda: library_chain(xc, w, dil), iters=5, reps=2),
                    bound=k4_bound(xc, w, dil, O)))
        if name == "narrow":
            r["times"] = {"f32_ms": time_ms(lambda: detect_program_batch(
                params_d, imgs_d, cfg, (IMG, IMG), detections_only=True), iters=3, reps=2),
                "int8_ms": time_ms(lambda: detect_program_batch(
                    params_d, imgs_d, cfg, (IMG, IMG), qparams=q_d, detections_only=True), iters=3, reps=2)}
            continue
        lab_w = ccl_kernel.ccl_labels_from_logits(lg_d[..., 0].contiguous())
        geo_w = pk.component_slots(lg_d, lab_w, K)
        lg16_w = ck.fused_model_apply(params16_d, imgs_d.to(torch.bfloat16)[..., None], cfg16,
                                      raw_gray=True, act_out=True)
        lab_w16 = ccl_kernel.ccl_labels_from_logits(lg16_w[..., 0].contiguous())
        geo_w16 = pk.component_slots(lg16_w, lab_w16, K)
        stats_inst = (f"the {pk.stats_channel_bound(O)}-channel instance, {pk.class_chunks(O)} pixel "
                      f"pass(es) at {O} logits, {pk.stats_warps(IMG // 4, IMG // 4, K, O)} virtual "
                      "warps a block")
        n_slots, n_slots16, n_compat, n_tiled, n_large = STATS_ROWS[name]
        for rname, lgx, labx, geox, err_, esz, n_ in (
                (n_slots, lg_d, lab_w, geo_w, err_slots, 4, n_f["slots"]),
                (n_slots16, lg16_w, lab_w16, geo_w16, err_slots16, 2, n16["slots_bf16"])):
            rows.append(dict(
                name=rname, route="cuda", source="ubdvss_tpu_torch/csrc/postproc_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:130", launches=n_,
                max_abs_err=err_, channels=O, instance=stats_inst,
                ms=time_ms(lambda: pk.component_slots(lgx, labx, K), iters=5, reps=4),
                device_ms=device_ms(lambda: pk.component_slots(lgx, labx, K), n=5),
                queued_ms=queued_ms(lambda: pk.component_slots(lgx, labx, K)),
                plain_ms=time_ms(lambda: pk.component_slots_reference(lgx, labx, K), iters=2, reps=1),
                library_ms=time_ms(lambda: pk._stats_reference(lgx, geox["slots"], K), iters=3, reps=2),
                bound=stats_bound(lgx, geox, K, esz)))
        rows.append(dict(
            name=n_compat, route="cuda", source="ubdvss_tpu_torch/csrc/geometry_kernel.cu",
            replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:50", launches=n_c["geometry_compat"],
            max_abs_err=err_slots, channels=O, instance=stats_inst,
            ms=time_ms(lambda: pk.geometry_compat(lg_d, K), iters=5, reps=4),
            device_ms=device_ms(lambda: pk.geometry_compat(lg_d, K), n=5),
            queued_ms=queued_ms(lambda: pk.geometry_compat(lg_d, K)),
            plain_ms=time_ms(lambda: pk.geometry_compat_reference(lg_d, K), iters=2, reps=1),
            library_ms=None, bound=stats_bound(lg_d, geo_w, K, 4, k12=True)))
        if name == "wide":
            # the int8 trunk's any-width instances at the main path's shapes: one
            # row a kind, its launches' times summed; the library yardstick one
            # f32 F.conv2d a layer on the int8 values (TF32 off)
            ins, qx = [], kq.qstem(imgs_d, L8[0], s8[1], L8[1], s8[2], raw_gray=True)
            for li, d in enumerate(dil[:-1]):
                ins.append((qx, L8[2 + li], s8[3 + li], d))
                qx = kq.qconv(*ins[-1])
            head_full = (qx, L8[1 + nd], s8[2 + nd], dil[-1], q_d["head"])
            px = B * (IMG // 4) ** 2
            Ci = -(-C // 4) * 4

            def conv_lib(x, q, st, d):
                xf = (x[:, None] if x.ndim == 3 else x.permute(0, 3, 1, 2)).float().contiguous()
                wf = q.permute(3, 2, 0, 1).float().contiguous()
                pad = d if q.shape[0] == 3 else 0
                return lambda: F_.conv2d(xf, wf, None, st, pad, d)

            kinds8 = {
                "qstem_any": ("qstem_kernel.cu", "ubdvss_tpu/ops/quant.py:315", n8["qstem"],
                              [lambda: kq.qstem(imgs_d, L8[0], s8[1], L8[1], s8[2], raw_gray=True)],
                              [lambda: kq.qstem_reference(imgs_d, L8[0], s8[1], L8[1], s8[2], True)],
                              [conv_lib(imgs_d.float(), L8[0]["q"], 2, 1),
                               conv_lib(torch.zeros(B, IMG // 2, IMG // 2, C, device=dev), L8[1]["q"], 2, 1)],
                              B * IMG * IMG + px * Ci, 2 * (B * (IMG // 2) ** 2 * C * 9 + px * C * C * 9)),
                "qconv_any": ("qconv_kernel.cu", "ubdvss_tpu/ops/quant.py:276", n8["qconv"],
                              [lambda a=a: kq.qconv(*a) for a in ins],
                              [lambda a=a: kq.qconv_reference(a[0], a[1], a[2], 1, a[3]) for a in ins],
                              [conv_lib(a[0], a[1]["q"], 1, a[3]) for a in ins],
                              len(ins) * 2 * px * Ci, len(ins) * 2 * px * C * C * 9),
                "qconv_head_any": ("qconv_kernel.cu", "ubdvss_tpu/ops/quant.py:276", n8["qconv_head"],
                                   [lambda: kq.qconv_head(*head_full)],
                                   [lambda: kq.qconv_head_reference(*head_full)],
                                   [conv_lib(qx, L8[1 + nd]["q"], 1, dil[-1]),
                                    conv_lib(qx, q_d["head"]["q"], 1, 1)],
                                   px * Ci + px * O * 4, 2 * px * (C * C * 9 + C * O)),
            }
            for rname, (src, repl, n_, calls, plains, libs, nbytes, ops) in kinds8.items():
                run = lambda calls=calls: [c() for c in calls]  # noqa: E731
                err = bit_equal(run(), [c() for c in plains], f"{name} {rname}")
                with exact_f32():
                    lib_ms = time_ms(lambda libs=libs: [c() for c in libs], iters=3, reps=2)
                rows.append(dict(
                    name=rname, route="cuda", source=f"ubdvss_tpu_torch/csrc/{src}", replaces=repl,
                    launches=n_, max_abs_err=err, channels=C, outputs=O, instance=INT8_ANY_INSTANCES[rname],
                    ms=time_ms(run, iters=5, reps=2), device_ms=device_ms(run, n=5),
                    plain_ms=time_ms(lambda plains=plains: [c() for c in plains], iters=1, reps=1, warmup=0),
                    library_ms=lib_ms, bound=bound(nbytes, ops, INT8_OPS)))
            # the calibration's any-width kinds, one call each at the main path's
            # shapes: layer 0 on the batch's images normalized (y and the
            # accumulator), a context layer's f32 epilogue, then its
            # requantization
            xa, La, sa, da = ins[1]
            y_a, acc_a = kq.qconv_layer_f32(xa, La, 1, da)
            norm_d = imgs_d.float() / 127.5 - 1.0
            px0 = B * (IMG // 2) ** 2
            calib_kinds = {
                "qlayer0_any": ("qstem_kernel.cu", "ubdvss_tpu/ops/quant.py:165", n_cal["qlayer0"],
                                lambda: kq.qconv_layer_f32(norm_d, L8[0], 2, 1),
                                lambda: (kq.qconv_reference(norm_d, L8[0], None, 2, 1),
                                         kq.qconv_acc_reference(norm_d, L8[0], 2, 1)),
                                norm_d.numel() * 4 + px0 * C * 8, 2 * px0 * C * 9,
                                conv_lib(norm_d, L8[0]["q"], 2, 1)),
                "qconv_layer_any": ("qconv_kernel.cu", "ubdvss_tpu/ops/quant.py:276",
                                    n_cal["qconv_layer"] - n_cal["qlayer0"],
                                    lambda: kq.qconv_layer_f32(xa, La, 1, da),
                                    lambda: (kq.qconv_reference(xa, La, None, 1, da),
                                             kq.qconv_acc_reference(xa, La, 1, da)),
                                    xa.numel() + px * C * 8, 2 * px * C * C * 9, conv_lib(xa, La["q"], 1, da)),
                "qrequant_any": ("qconv_kernel.cu", "ubdvss_tpu/ops/quant.py:192", n_cal["qrequant"],
                                 lambda: kq.requantize(acc_a, La["ws"], La["b"], sa),
                                 lambda: kq.requantize_reference(acc_a, La["ws"], La["b"], sa),
                                 px * C * 5, 0, None),
            }
            for rname, (src, repl, n_, call, plain, nbytes, ops, lib) in calib_kinds.items():
                err = bit_equal(call(), plain(), f"{name} {rname}")
                if lib is not None:
                    with exact_f32():
                        lib_ms = time_ms(lib, iters=3, reps=2)
                rows.append(dict(
                    name=rname, route="cuda", source=f"ubdvss_tpu_torch/csrc/{src}", replaces=repl,
                    launches=n_, max_abs_err=err, channels=C, instance=INT8_ANY_INSTANCES[rname],
                    ms=time_ms(call, iters=5, reps=2), device_ms=device_ms(call, n=5),
                    plain_ms=time_ms(plain, iters=1, reps=1, warmup=0),
                    library_ms=lib_ms if lib is not None else None,
                    bound=bound(nbytes, ops, INT8_OPS)))
        r["times"] = {"f32_ms": time_ms(lambda: detect_program_batch(
            params_d, imgs_d, cfg, (IMG, IMG), detections_only=True), iters=3, reps=2),
            "bf16_ms": time_ms(lambda: detect_program_batch(
                params16_d, imgs_d, cfg16, (IMG, IMG), detections_only=True), iters=3, reps=2),
            "int8_ms": time_ms(lambda: detect_program_batch(
                params_d, imgs_d, cfg, (IMG, IMG), qparams=q_d, detections_only=True), iters=3, reps=2)}

        # h. the configuration's 2048² scans on the packed route: K4's
        # packed store at O channels, the tiled K2 and the large K12c
        # reading the phase-major logits, qconv_head's packed store
        sc = scans[:N_WIDTH_SCANS]
        sc_d = torch.from_numpy(sc).to(dev)
        (res_p, lg_p), n_p = counted(
            lambda: detect_program_batch(params_d, sc, cfg, (SCAN, SCAN), device="cuda"),
            ["context_layer", "context_layer_packed", "ccl_tiled", "slots_tiled", "slots_tiled_packed",
             "rect_compact"], ["ccl", "slots", "geometry_compat", "rect_exact", *bf16])
        (res_w, lg_w), _ = counted(
            lambda: detect_program_batch(params_d, sc, cfg, (SCAN, SCAN), n_strips=1, device="cuda"),
            ["context_layer", "ccl_tiled", "slots_tiled", "rect_compact"], ["context_layer_packed"])
        if not torch.equal(lg_p, lg_w):
            raise AssertionError(f"{name} 2048²: the packed route's logits differ from n_strips=1's")
        same_detections(res_p, res_w, f"{name} 2048² packed route")
        ref_p, ref_lgp = detect_program_batch(params, sc[:1], cfg, (SCAN, SCAN), device="cpu")
        err_p = float((lg_p[:1].cpu() - ref_lgp).abs().max())
        if not err_p <= 1e-4:
            raise AssertionError(f"{name} 2048²: logits differ from the host CPU's by {err_p}")
        compare_detections({k: v[:1] for k, v in host(res_p).items()}, host(ref_p),
                           lg_p[:1, ..., 0].cpu().numpy(), box_atol=1e-3, score_atol=1e-5,
                           margin=max(1e-4, 2 * err_p))
        res_pc, n_pc = counted(
            lambda: with_compat(lambda: detect_program_batch(
                params_d, sc, cfg, (SCAN, SCAN), detections_only=True, device="cuda")[0]),
            ["context_layer_packed", "geometry_compat_large", "geometry_compat_large_packed"],
            ["ccl_tiled", "slots_tiled", "ccl", "slots"])
        same_detections(res_pc, res_p, f"{name} 2048² compat route")
        (res_p8, lg_p8), n_p8 = counted(
            lambda: detect_program_batch(params_d, sc, cfg, (SCAN, SCAN), qparams=q_d, device="cuda"),
            [*trunk8, "qconv_head_packed", "ccl_tiled", "slots_tiled", "slots_tiled_packed"],
            ["context_layer", "ccl", "slots"])
        ref_p8, ref_lgp8 = detect_program_batch(params, sc[:1], cfg, (SCAN, SCAN), qparams=q_h,
                                                device="cpu")
        if not torch.equal(lg_p8[:1].cpu(), ref_lgp8):
            raise AssertionError(f"{name} 2048² int8: logits differ from the host CPU's")
        compare_detections({k: v[:1] for k, v in host(res_p8).items()}, host(ref_p8),
                           lg_p8[:1, ..., 0].cpu().numpy(), box_atol=1e-3, score_atol=1e-5, margin=0.0)
        r["scan_2048"] = dict(
            scans=len(sc), f32_launches={k: n_p[k] for k in ("context_layer_packed", "slots_tiled_packed")},
            compat_launches=n_pc["geometry_compat_large_packed"], int8_launches=n_p8["qconv_head_packed"],
            detections=int(res_p["num_detections"].sum()), host_logits_max_abs_err=err_p)
        log(f"{name} 2048²: {len(sc)} scans on the packed route, launches {r['scan_2048']}; logits == "
            "n_strips=1's bit for bit, detections identical; the compat route's large K12c reading "
            "phase-major logits identical; int8 with qconv_head's packed store; scan 0 == the host "
            "CPU's (f32 logits within 1e-4, int8 bit for bit)")
        # their rows: the tiled K2 and the large K12c at O phase-major
        # channels; wide: K4's packed store, qconv_head's packed store
        with torch.inference_mode(), exact_f32():
            xs = ck.stem_apply(params_d, sc_d.float()[..., None], cfg,
                               raw_gray=True).permute(0, 3, 1, 2).contiguous()
            k4p = lambda: ck.fused_context_head(xs, *w, dil, packed=True)  # noqa: E731
            pl_ = k4p()
            ref_k4p = ck._s2d_planes(ck.context_head_reference(xs, *w, dil))
            err_k4p, bar_k4p = float((pl_ - ref_k4p).abs().max()), logit_bar(ref_k4p)
            del ref_k4p
            if not err_k4p <= bar_k4p:
                raise AssertionError(f"{name}: K4's packed store at 2048² off its plain version by "
                                     f"{err_k4p} > {bar_k4p}")
        if name == "wide":
            with exact_f32():
                rows.append(dict(
                    name="context_layer_wide_packed", route="cuda", source="ubdvss_tpu_torch/csrc/context_kernel.cu",
                    replaces="ubdvss_tpu/ops/pallas/context_kernel.py:388 (s2d_context_head unpack=False)",
                    launches=n_p["context_layer_packed"], max_abs_err=err_k4p, channels=C, outputs=O,
                    instance=r["k4_instance"],
                    ms=time_ms(k4p, iters=3, reps=2), device_ms=device_ms(k4p, n=3),
                    plain_ms=time_ms(lambda: ck._s2d_planes(ck.context_head_reference(xs, *w, dil)),
                                     iters=1, reps=1, warmup=0),
                    library_ms=time_ms(lambda: library_chain(xs, w, dil), iters=3, reps=2),
                    bound=k4_bound(xs, w, dil, O)))
        pk_lg = pl_.permute(0, 2, 3, 1)  # the packed planes' phase-major NHWC view
        lg_u = ck._d2s(pk_lg, O)
        lab_p = ccl_kernel.ccl_labels_tiled(lg_u[..., 0].contiguous())
        geo_p = pk.component_slots_tiled(pk_lg, lab_p, K, packed_phases=(2, 2))
        err_tp = check_stats(geo_p, pk.component_slots_reference(pk_lg, lab_p, K, packed_phases=(2, 2)),
                             f"{name} slots_tiled packed", exact=exact_stats(lg_u, geo_p["slots"], K))
        large = pk.geometry_compat(pk_lg, K, packed_phases=(2, 2))
        if not all(torch.equal(large[k], geo_p[k]) for k in geo_p):
            raise AssertionError(f"{name}: the large K12c differs from the tiled pair on phase-major logits")
        for rname, call, plain, lib, n_, k12 in (
                (n_tiled,
                 lambda: pk.component_slots_tiled(pk_lg, lab_p, K, packed_phases=(2, 2)),
                 lambda: pk.component_slots_reference(pk_lg, lab_p, K, packed_phases=(2, 2)),
                 lambda: pk._stats_reference(pk_lg, geo_p["slots"], K, (2, 2)),
                 n_p["slots_tiled_packed"], False),
                (n_large,
                 lambda: pk.geometry_compat(pk_lg, K, packed_phases=(2, 2)),
                 lambda: pk.geometry_compat_reference(pk_lg, K, packed_phases=(2, 2)),
                 None, n_pc["geometry_compat_large_packed"], True)):
            rows.append(dict(
                name=rname, route="cuda",
                source="ubdvss_tpu_torch/csrc/" + ("geometry_kernel.cu" if k12 else "postproc_kernel.cu"),
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:" + ("50" if k12 else "381")
                + " (packed_phases)", launches=n_, max_abs_err=err_tp, channels=O,
                instance=f"the {pk.stats_channel_bound(O)}-channel instance, {pk.class_chunks(O)} "
                         f"pixel pass(es) at {O} logits (tiled sums)",
                ms=time_ms(call, iters=3, reps=2), device_ms=device_ms(call, n=3), queued_ms=queued_ms(call),
                plain_ms=time_ms(plain, iters=1, reps=1, warmup=0),
                library_ms=None if lib is None else time_ms(lib, iters=1, reps=1),
                bound=stats_bound(lg_u, geo_p, K, 4, k12=k12)))
        r["times"]["scan_2048_ms"] = time_ms(lambda: detect_program_batch(
            params_d, sc_d, cfg, (SCAN, SCAN), detections_only=True), iters=3, reps=1)
        if name != "wide":
            continue
        qs = kq.qstem(sc_d, L8[0], s8[1], L8[1], s8[2], raw_gray=True)
        for li, d in enumerate(dil[:-1]):
            qs = kq.qconv(qs, L8[2 + li], s8[3 + li], d)
        head_s = (qs, L8[1 + nd], s8[2 + nd], dil[-1], q_d["head"])
        hp = lambda: kq.qconv_head(*head_s, packed=True)  # noqa: E731
        if not torch.equal(hp(), ck._s2d(kq.qconv_head(*head_s))):
            raise AssertionError("wide: qconv_head's packed store differs from its unpacked launch")
        pxs = N_WIDTH_SCANS * (SCAN // 4) ** 2
        with exact_f32():
            lib_ms = time_ms(lambda: [conv_lib(qs, L8[1 + nd]["q"], 1, dil[-1])(),
                                      conv_lib(qs, q_d["head"]["q"], 1, 1)()], iters=3, reps=1)
        rows.append(dict(
            name="qconv_head_packed_any", route="cuda", source="ubdvss_tpu_torch/csrc/qconv_kernel.cu",
            replaces="ubdvss_tpu/ops/quant.py:332 (int8_packed_trunk_apply's head)",
            launches=n_p8["qconv_head_packed"], max_abs_err=0.0, channels=C, outputs=O,
            instance=INT8_ANY_INSTANCES["qconv_head_packed_any"],
            ms=time_ms(hp, iters=3, reps=2), device_ms=device_ms(hp, n=3),
            plain_ms=time_ms(lambda: kq.qconv_head_reference(*head_s, packed=True), iters=1, reps=1, warmup=0),
            library_ms=lib_ms, bound=bound(pxs * Ci + pxs * O * 4, 2 * pxs * (C * C * 9 + C * O), INT8_OPS)))
    for row in rows:
        row["bound_ms"], row["bound_by"] = row.pop("bound")
        inst = f" ({row['instance']})" if "instance" in row else ""
        before = PARENT_DESIGN_DEVICE_MS.get(row["name"])
        before = "" if before is None else f" [the earlier design {before[0]:.4f}, {before[1]}]"
        queued = f", queued {row['queued_ms']:.4f}" if "queued_ms" in row else ""
        log(f"time {row['name']}{inst}: {row['ms']:.4f} ms/call, device {row['device_ms']:.4f}"
            f"{queued}{before} (plain {row['plain_ms']:.4f}, library {row['library_ms']}, bound "
            f"{row['bound_ms']:.4f} by {row['bound_by']}), {row['launches']} launches on its path")
    kernels += rows
    return report


def bit_equal(got, want, name: str) -> float:
    """The largest |difference| between the outputs ``got`` and ``want``
    (a tensor, or a tuple or list of them), measured; raises unless every
    pair is equal bit for bit."""
    import torch

    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    err = 0.0
    for g, w in zip(got, want, strict=True):
        err = max(err, float((g.double() - w.double()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: differs from its plain version by {err}")
    return err


def _cpu(a):
    """A tensor, or a dict of them, on the host."""
    if isinstance(a, dict):
        return {k: v.cpu() for k, v in a.items()}
    return a.cpu() if hasattr(a, "cpu") else a


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    if not (REPO / "ubdvss_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the ubdvss_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from ubdvss_tpu_torch import (
        BarcodeDetector,
        NetConfig,
        StreamingDetector,
        detect_program,
        detect_program_batch,
        detect_program_int8,
        load_net_config,
        load_params_npz,
        params_from_flat,
    )
    from ubdvss_tpu_torch.detect import calibrate_qparams
    from ubdvss_tpu_torch.models.model import exact_f32
    from ubdvss_tpu_torch.ops.cuda import _build
    from ubdvss_tpu_torch.ops.cuda import (
        ccl_kernel,
        context_kernel,
        postproc_kernel,
        qconv_kernel,
        rect_kernel,
    )
    from ubdvss_tpu_torch.ops.quant import _conv_specs, int8_trunk_apply, qparams_to, quantize_trunk
    from ubdvss_tpu_torch.ops.cuda.context_kernel import _pack_weights, fused_model_apply, stem_apply
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the f32 route needs them off")

    # --- 1. build every kernel, one nvcc per source, in parallel ---
    t0 = time.perf_counter()
    sources = ["context_kernel", "ccl_kernel", "postproc_kernel", "geometry_kernel", "rect_kernel",
               "qconv_kernel", "qstem_kernel"]
    _build.build(sources)
    log(f"build: {time.perf_counter() - t0:.1f} s ({len(sources)} sources, "
        f"nvcc {' '.join(_build.NVCC_FLAGS)})")

    asset = REPO / "assets" / "pretrained_synthetic.npz"
    cfg = NetConfig(max_components=K, max_hull_points=M)
    cfg_q = load_net_config(asset).replace(max_components=K)
    if not cfg_q.max_hull_points >= QVGA[0] // cfg_q.scale:
        raise AssertionError("the QVGA stream must take the uncompacted rect kernel")
    params = params_from_flat(load_params_npz(asset))
    params_d = {k: v.to(dev) for k, v in params.items()}
    reader = SyntheticMarkupReader(n_samples=B, image_hw=(IMG, IMG), seed=SEED)
    imgs = np.stack([reader.sample_at(i).image for i in range(B)])
    imgs_d = torch.from_numpy(imgs).to(dev)
    reader_q = SyntheticMarkupReader(n_samples=N_FRAMES, image_hw=QVGA, seed=SEED)
    frames = np.stack([reader_q.sample_at(i).image for i in range(N_FRAMES)])
    dil = tuple(cfg.dilations)
    # the large scans and the photos take the asset's own config: K=64, M=64
    cfg_l = load_net_config(asset)
    K_l, M_l = cfg_l.max_components, cfg_l.max_hull_points
    dil_l = tuple(cfg_l.dilations)
    reader_l = SyntheticMarkupReader(n_samples=B_SCAN, image_hw=(SCAN, SCAN), seed=SCAN_SEED)
    scans = np.stack([reader_l.sample_at(i).image for i in range(B_SCAN)])
    big = SyntheticMarkupReader(
        n_samples=1, image_hw=(BIG_SCAN, BIG_SCAN), seed=SCAN_SEED).sample_at(0).image[None]
    photos = [SyntheticMarkupReader(n_samples=1, image_hw=hw, seed=SEED).sample_at(0).image
              for hw in DETECT_HW]

    # --- 2. each kernel against its plain version on the card ---
    phase("kernel checks")
    with torch.inference_mode(), exact_f32():
        feat = stem_apply(params_d, imgs_d.float()[..., None], cfg, raw_gray=True)
        xc = feat.permute(0, 3, 1, 2).contiguous()  # (B, 24, 128, 128)
        w = _pack_weights(params_d, dil)
        ctx_k = context_kernel.fused_context_head(xc, *w, dil)
        ctx_p = context_kernel.context_head_reference(xc, *w, dil)
        torch.cuda.synchronize()
        err_ctx, bar = float((ctx_k - ctx_p).abs().max()), logit_bar(ctx_p)
        if not err_ctx <= bar:
            raise AssertionError(f"context kernel: max |err| {err_ctx} > {bar}")
        log(f"check context_layer: (B,C,H,W)={tuple(xc.shape)} max|err| {err_ctx:.3g} <= {bar:.3g}")
        # the QVGA stream's shape, from the stem's features of its frames
        frames_d = torch.from_numpy(frames[:B]).to(dev)
        xq = stem_apply(params_d, frames_d.float()[..., None], cfg_q, raw_gray=True)
        xq = xq.permute(0, 3, 1, 2).contiguous()  # (B, 24, 60, 80)
        dil_q = tuple(cfg_q.dilations)
        w_q = _pack_weights(params_d, dil_q)
        context_kernel.fused_context_head.launches = 0
        ctx_kq = context_kernel.fused_context_head(xq, *w_q, dil_q)
        if context_kernel.fused_context_head.launches != len(dil_q):
            raise AssertionError("context kernel: not one launch a layer")
        ref_q = context_kernel.context_head_reference(xq, *w_q, dil_q)
        err_ctx_q, bar = float((ctx_kq - ref_q).abs().max()), logit_bar(ref_q)
        if not err_ctx_q <= bar:
            raise AssertionError(f"context kernel at the QVGA shape: max |err| {err_ctx_q} > {bar}")
        err_ctx = max(err_ctx, err_ctx_q)
        log(f"check context_layer: (B,C,H,W)={tuple(xq.shape)} max|err| {err_ctx_q:.3g} <= {bar:.3g}")

        # the head's (B, 17, H, W) planes, then the adversarial maps with the
        # first 8 images' class planes; K2 and K12c read the NHWC view
        adv = torch.from_numpy(adversarial_maps()).to(dev)
        planes = torch.cat([ctx_k, torch.cat([adv[:, None], ctx_k[:8, 1:]], 1)])
        lg_all = planes.permute(0, 2, 3, 1)
        maps = planes[:, 0].contiguous()
        for conn in (8, 4):
            lab_k = ccl_kernel.ccl_labels_from_logits(maps, connectivity=conn)
            lab_p = ccl_kernel.ccl_labels_reference(maps, connectivity=conn)
            if not torch.equal(lab_k, lab_p):
                bad = (lab_k != lab_p).flatten(1).any(1).nonzero().flatten().tolist()
                raise AssertionError(f"ccl ({conn}-conn): labels differ in maps {bad}")
        log(f"check ccl: {tuple(maps.shape)} 8- and 4-connected labels identical")
        lab = ccl_kernel.ccl_labels_reference(maps)
        geo_k = postproc_kernel.component_slots(lg_all, lab, K)
        geo_p = postproc_kernel.component_slots_reference(lg_all, lab, K)
        err_slots = check_stats(geo_k, geo_p, "slots")
        again = postproc_kernel.component_slots(lg_all, lab, K)
        if not all(torch.equal(geo_k[k], again[k]) for k in geo_k):
            raise AssertionError("slots: two launches differ")
        totals = geo_p["num_components_total"]
        log(f"check slots: {tuple(lg_all.shape)} K={K} ({int((totals < K).sum())} maps with "
            f"padding slots, {int((totals > K).sum())} with more than K components), slot "
            f"outputs and areas identical, means max|err| {err_slots:.3g} <= 2e-6, two "
            "launches bit for bit equal")
        err_geo = 0.0
        for conn in (8, 4):
            fused_k = postproc_kernel.geometry_compat(lg_all, K, connectivity=conn)
            fused_p = postproc_kernel.geometry_compat_reference(lg_all, K, connectivity=conn)
            pair_k = postproc_kernel.component_slots(
                lg_all, ccl_kernel.ccl_labels_from_logits(maps, connectivity=conn), K)
            err_geo = max(err_geo, check_stats(fused_k, fused_p, f"geometry_compat ({conn}-conn)"))
            for key in fused_p:
                if not torch.equal(fused_k[key], pair_k[key]):
                    raise AssertionError(f"geometry_compat ({conn}-conn): {key} differs "
                                         "from slots after CCL")
        log(f"check geometry_compat: {tuple(lg_all.shape)} K={K}, 8- and 4-connected, slot "
            f"outputs and areas identical to the plain version, means max|err| {err_geo:.3g}"
            " <= 2e-6; all eight outputs bit for bit equal to slots after CCL")
        err_rect = 0.0
        Hm = geo_p["minx"].shape[2]
        for m in (M, 1, 8, Hm - 1):
            sel_k = rect_kernel.min_area_rect_compact(geo_p["minx"], geo_p["maxx"], m)
            sel_p = rect_kernel.min_area_rect_select_reference(geo_p["minx"], geo_p["maxx"], m)
            e, flips = check_rect_rows(sel_k.cpu().numpy(), sel_p.cpu().numpy())
            err_rect = max(err_rect, e)
            log(f"check rect_compact: (B,K,H)={tuple(geo_p['minx'].shape)} M={m}, rows max|err| "
                f"{e:.3g} <= 1e-4, any_edge identical, {flips} exact-tie flips (same rectangle)")

        # the uncompacted kernel on the QVGA stream's own extremes (B=64
        # frames, K=16, H=60) and on the adversarial maps at n=60 and 128
        logits_q = fused_model_apply(params_d, frames_d.float()[..., None], cfg_q, raw_gray=True)
        det_q = logits_q[..., 0].contiguous()
        geo_q = postproc_kernel.component_slots_from_logits(det_q, K)
        minx_q, maxx_q = geo_q["minx"], geo_q["maxx"]
        extremes = {"QVGA": (minx_q, maxx_q)}
        for b in range(4):  # one image at a time, as detect calls it
            extremes[f"main-path image {b}"] = (geo_p["minx"][b:b + 1].contiguous(),
                                                geo_p["maxx"][b:b + 1].contiguous())
        for n in (60, 128):
            g = postproc_kernel.geometry_compat_reference(
                torch.from_numpy(adversarial_maps(n)).to(dev), K)
            extremes[f"adversarial n={n}"] = g["minx"], g["maxx"]
        err_exact = 0.0
        for name, (mn, mx) in extremes.items():
            sel_k = rect_kernel.min_area_rect_exact(mn, mx)
            sel_p = rect_kernel.min_area_rect_select_reference(mn, mx, None)
            e, f = check_rect_rows(sel_k.cpu().numpy(), sel_p.cpu().numpy())
            err_exact = max(err_exact, e)
            log(f"check rect_exact {name}: (B,K,H)={tuple(mn.shape)}, rows max|err| "
                f"{e:.3g} <= 1e-4, any_edge identical, {f} exact-tie flips (same rectangle)")

        # the large maps: the 2048² scans' 512² maps and the 4096² scan's
        # 1024² map, from the stem and the context kernel on the card
        phase("large-map kernel checks")
        scans_d = torch.from_numpy(scans).to(dev)
        xl = stem_apply(params_d, scans_d.float()[..., None], cfg_l, raw_gray=True)
        xl = xl.permute(0, 3, 1, 2).contiguous()  # (8, 24, 512, 512)
        w_l = _pack_weights(params_d, dil_l)
        ctx_l = context_kernel.fused_context_head(xl, *w_l, dil_l)
        ref_l = context_kernel.context_head_reference(xl, *w_l, dil_l)
        err_ctx_l, bar = float((ctx_l - ref_l).abs().max()), logit_bar(ref_l)
        del ref_l
        if not err_ctx_l <= bar:
            raise AssertionError(f"context kernel at the large scans' shape: {err_ctx_l} > {bar}")
        err_ctx = max(err_ctx, err_ctx_l)
        log(f"check context_layer: (B,C,H,W)={tuple(xl.shape)} max|err| {err_ctx_l:.3g} <= {bar:.3g}")
        lg_l = ctx_l.permute(0, 2, 3, 1)  # the head's NHWC view
        det_l = ctx_l[:, 0].contiguous()
        lg_big = fused_model_apply(params_d, torch.from_numpy(big).to(dev).float()[..., None],
                                   cfg_l, raw_gray=True)  # (1, 1024, 1024, 17)
        large_maps = {"512²": (torch.cat([det_l, torch.from_numpy(adversarial_maps(512)).to(dev)]),
                               lg_l),
                      "1024²": (lg_big[..., 0].contiguous(), lg_big)}
        err_slots_l, err_rect_l = 0.0, 0.0
        for name, (maps_l, lg_) in large_maps.items():
            for conn in (4, 8):
                lab_k = ccl_kernel.ccl_labels_tiled(maps_l, connectivity=conn)
                lab_p = ccl_kernel.ccl_labels_reference(maps_l, connectivity=conn)
                if not torch.equal(lab_k, lab_p):
                    bad = (lab_k != lab_p).flatten(1).any(1).nonzero().flatten().tolist()
                    raise AssertionError(f"ccl_tiled {name} ({conn}-conn): labels differ in {bad}")
            log(f"check ccl_tiled: {tuple(maps_l.shape)} 8- and 4-connected labels identical")
            lab = lab_p[: lg_.shape[0]]  # 8-connected; the adversarial maps hold no class planes
            geo_k = postproc_kernel.component_slots_tiled(lg_, lab, K_l)
            geo_p = postproc_kernel.component_slots_reference(lg_, lab, K_l)
            e = check_stats(geo_k, geo_p, f"slots_tiled {name}",
                            exact=exact_stats(lg_, geo_p["slots"], K_l))
            err_slots_l = max(err_slots_l, e)
            again = postproc_kernel.component_slots_tiled(lg_, lab, K_l)
            if not all(torch.equal(geo_k[k], again[k]) for k in geo_k):
                raise AssertionError(f"slots_tiled {name}: two launches differ")
            log(f"check slots_tiled: {tuple(lg_.shape)} K={K_l}, slot outputs and areas identical"
                f", means max|err| {e:.3g} <= 2e-6 of the f64 sums, two launches bit for bit equal")
            sel_k = rect_kernel.min_area_rect_compact(geo_p["minx"], geo_p["maxx"], M_l)
            sel_p = rect_kernel.min_area_rect_select_reference(geo_p["minx"], geo_p["maxx"], M_l)
            e, flips = check_rect_rows(sel_k.cpu().numpy(), sel_p.cpu().numpy())
            err_rect = max(err_rect, e)
            log(f"check rect_compact: (B,K,H)={tuple(geo_p['minx'].shape)} M={M_l}, rows max|err| "
                f"{e:.3g} <= 1e-4, any_edge identical, {flips} exact-tie flips (same rectangle)")
        # the uncompacted rect on the detect calls' extremes (K=64)
        for hw, img in zip(DETECT_HW, photos):
            lg_1 = fused_model_apply(params_d, torch.from_numpy(img).to(dev).float()[None, ..., None],
                                     cfg_l, raw_gray=True)
            g = postproc_kernel.component_slots_from_logits(lg_1[..., 0].contiguous(), K_l)
            sel_k = rect_kernel.min_area_rect_exact(g["minx"], g["maxx"])
            sel_p = rect_kernel.min_area_rect_select_reference(g["minx"], g["maxx"], None)
            e, f = check_rect_rows(sel_k.cpu().numpy(), sel_p.cpu().numpy())
            err_exact = max(err_exact, e)
            log(f"check rect_exact detect {hw[1]}x{hw[0]}: (B,K,H)={tuple(g['minx'].shape)}, rows "
                f"max|err| {e:.3g} <= 1e-4, any_edge identical, {f} exact-tie flips")

        # the bf16 variants of K1, K2 and K12c on the bf16 trunk's logits
        # (channels-last bf16 from cuDNN) at the main path's and the large
        # scans' shapes, the weights cast to bf16 as bench.py:290-291 does
        phase("bf16 kernel checks")
        params16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
        params16_d = {k: v.to(dev) for k, v in params16.items()}
        cfg16 = cfg.replace(dtype="bfloat16")
        cfg_l16 = cfg_l.replace(dtype="bfloat16")
        lg16 = fused_model_apply(params16_d, imgs_d.to(torch.bfloat16)[..., None], cfg16,
                                 raw_gray=True, act_out=True)  # (B, 128, 128, 17) bf16
        if lg16.dtype != torch.bfloat16:
            raise AssertionError(f"bf16 trunk: logits {lg16.dtype}, expected bf16")
        adv16 = torch.cat([adv.to(torch.bfloat16)[..., None], lg16[:8, ..., 1:]], -1)
        lg16_all = torch.cat([lg16, adv16])
        maps16 = lg16_all[..., 0].contiguous()
        for conn in (8, 4):
            lab_k = ccl_kernel.ccl_labels_from_logits(maps16, connectivity=conn)
            if not torch.equal(lab_k, ccl_kernel.ccl_labels_reference(maps16, connectivity=conn)):
                raise AssertionError(f"ccl bf16 ({conn}-conn): labels differ from the plain version")
        log(f"check ccl bf16: {tuple(maps16.shape)} 8- and 4-connected labels identical")
        lab16 = ccl_kernel.ccl_labels_reference(maps16)
        geo16_k = postproc_kernel.component_slots(lg16_all, lab16, K)
        geo16_p = postproc_kernel.component_slots_reference(lg16_all, lab16, K)
        err_slots16 = check_stats(geo16_k, geo16_p, "slots bf16", logits=lg16_all)
        again = postproc_kernel.component_slots(lg16_all, lab16, K)
        if not all(torch.equal(geo16_k[k], again[k]) for k in geo16_k):
            raise AssertionError("slots bf16: two launches differ")
        log(f"check slots bf16: {tuple(lg16_all.shape)} strides {lg16_all.stride()} K={K}, slot "
            f"outputs and areas identical, means max|err| {err_slots16:.3g} (<= 2e-6 plus a "
            "bf16 step a probability at a rounding boundary), two launches bit for bit equal")
        err_geo16 = 0.0
        for conn in (8, 4):
            fused_k = postproc_kernel.geometry_compat(lg16_all, K, connectivity=conn)
            fused_p = postproc_kernel.geometry_compat_reference(lg16_all, K, connectivity=conn)
            pair_k = postproc_kernel.component_slots(
                lg16_all, ccl_kernel.ccl_labels_from_logits(maps16, connectivity=conn), K)
            err_geo16 = max(err_geo16, check_stats(fused_k, fused_p, f"geometry_compat bf16 "
                                                   f"({conn}-conn)", logits=lg16_all))
            for key in fused_p:
                if not torch.equal(fused_k[key], pair_k[key]):
                    raise AssertionError(f"geometry_compat bf16 ({conn}-conn): {key} differs "
                                         "from slots after CCL")
        log(f"check geometry_compat bf16: 8- and 4-connected, slot outputs and areas identical "
            f"to the plain version, means max|err| {err_geo16:.3g}; all eight outputs bit for "
            "bit equal to the bf16 slots after the bf16 CCL")
        lg_l16 = fused_model_apply(params16_d, scans_d.to(torch.bfloat16)[..., None], cfg_l16,
                                   raw_gray=True, act_out=True)  # (8, 512, 512, 17) bf16
        det_l16 = lg_l16[..., 0].contiguous()
        maps_l16 = torch.cat([det_l16, torch.from_numpy(adversarial_maps(512)).to(dev)
                              .to(torch.bfloat16)])
        for conn in (4, 8):
            lab_k = ccl_kernel.ccl_labels_tiled(maps_l16, connectivity=conn)
            lab_p = ccl_kernel.ccl_labels_reference(maps_l16, connectivity=conn)
            if not torch.equal(lab_k, lab_p):
                raise AssertionError(f"ccl_tiled bf16 ({conn}-conn): labels differ")
        log(f"check ccl_tiled bf16: {tuple(maps_l16.shape)} 8- and 4-connected labels identical")
        lab_l16 = lab_p[: lg_l16.shape[0]]
        geo_k = postproc_kernel.component_slots_tiled(lg_l16, lab_l16, K_l)
        geo_p = postproc_kernel.component_slots_reference(lg_l16, lab_l16, K_l)
        err_slots_l16 = check_stats(geo_k, geo_p, "slots_tiled bf16", logits=lg_l16,
                                    exact=exact_stats(lg_l16, geo_p["slots"], K_l))
        again = postproc_kernel.component_slots_tiled(lg_l16, lab_l16, K_l)
        if not all(torch.equal(geo_k[k], again[k]) for k in geo_k):
            raise AssertionError("slots_tiled bf16: two launches differ")
        log(f"check slots_tiled bf16: {tuple(lg_l16.shape)} K={K_l}, slot outputs and areas "
            f"identical, means max|err| {err_slots_l16:.3g} of the f64 sums (bf16 slack as "
            "above), two launches bit for bit equal")

        # K3x at the heights of tall pages, one block's shared memory up to
        # its cap, the tall instance past it; K12c past the cluster kernel's
        # shared memory against the tiled pair it must equal bit for bit
        phase("tall-rect and large-compat kernel checks")
        cap = rect_kernel.MAX_EXACT_HEIGHT
        if _build.load("rect_kernel", rect_kernel._FUNCS).rect_exact_max_height() != cap:
            raise AssertionError("rect: the C side's height cap differs from the wrapper's")
        tall_cases = [(make, H, b) for make in (synthetic_extremes, round_extremes)
                      for H in (1088, cap, 2048, 4096) for b in (1, 3)]
        tall_cases += [(make, 8192, 1) for make in (synthetic_extremes, round_extremes)]
        for make, H, b in tall_cases:
            mn, mx = (t.to(dev) for t in make(b, 16, H, H + b))
            sel_k = rect_kernel.min_area_rect_exact(mn, mx)
            sel_p = rect_kernel.min_area_rect_select_reference(mn, mx, None)
            e, f = check_rect_rows(sel_k.cpu().numpy(), sel_p.cpu().numpy())
            err_exact = max(err_exact, e)
            what = ("a staircase" if make is synthetic_extremes
                    else "a convex blob whose every row is a hull point")
            log(f"check rect_exact H={H}{' (tall instance, a cluster a component)' if H > cap else ''}"
                f": (B,K,H)={tuple(mn.shape)} with {what} over every row, rows max|err| {e:.3g} "
                f"<= 1e-4, any_edge identical, {f} exact-tie flips")
        lg_big16 = fused_model_apply(params16_d, torch.from_numpy(big).to(dev).to(torch.bfloat16)
                                     [..., None], cfg_l16, raw_gray=True, act_out=True)
        adv_l = torch.from_numpy(adversarial_maps(512)).to(dev)
        large_logits = {"512² scans": lg_l, "1024² scan": lg_big,
                        "512² adversarial": torch.cat([adv_l[..., None], lg_l[..., 1:]], -1),
                        "512² scans bf16": lg_l16, "1024² scan bf16": lg_big16}
        for name, lg_ in large_logits.items():
            B_, H_, W_, C_ = lg_.shape
            if postproc_kernel.geometry_compat_fits(H_, W_, K_l, C_):
                raise AssertionError(f"geometry_compat_large {name}: the cluster K12c fits")
            for conn in ((4, 8) if "adversarial" in name else (8,)):
                fused_k = postproc_kernel.geometry_compat(lg_, K_l, connectivity=conn)
                lab_k = ccl_kernel.ccl_labels_tiled(lg_[..., 0].contiguous(), connectivity=conn)
                pair_k = postproc_kernel.component_slots_tiled(lg_, lab_k, K_l)
                for key in pair_k:
                    if not torch.equal(fused_k[key], pair_k[key]):
                        raise AssertionError(f"geometry_compat_large {name} ({conn}-conn): {key} "
                                             "differs from ccl_tiled then slots_tiled")
            log(f"check geometry_compat_large {name}: {tuple(lg_.shape)} {lg_.dtype} K={K_l}, "
                "all eight outputs bit for bit equal to ccl_tiled then slots_tiled")

    # --- 3a. the main path, counting launches ---
    phase("main path")
    # each kernel's wrapper and the count it keeps: the bf16 variants of
    # K1, K2 and K12c count their launches in ``launches_bf16``
    wrappers = {
        "context_layer": (context_kernel.fused_context_head, "launches"),
        "ccl": (ccl_kernel.ccl_labels_from_logits, "launches"),
        "slots": (postproc_kernel.component_slots, "launches"),
        "geometry_compat": (postproc_kernel.geometry_compat, "launches"),
        "geometry_compat_large": (postproc_kernel.geometry_compat_large, "launches"),
        "rect_compact": (rect_kernel.min_area_rect_compact, "launches"),
        "rect_exact": (rect_kernel.min_area_rect_exact, "launches"),
        "ccl_tiled": (ccl_kernel.ccl_labels_tiled, "launches"),
        "slots_tiled": (postproc_kernel.component_slots_tiled, "launches"),
        "ccl_bf16": (ccl_kernel.ccl_labels_from_logits, "launches_bf16"),
        "slots_bf16": (postproc_kernel.component_slots, "launches_bf16"),
        "geometry_compat_bf16": (postproc_kernel.geometry_compat, "launches_bf16"),
        "geometry_compat_large_bf16": (postproc_kernel.geometry_compat_large, "launches_bf16"),
        "ccl_tiled_bf16": (ccl_kernel.ccl_labels_tiled, "launches_bf16"),
        "slots_tiled_bf16": (postproc_kernel.component_slots_tiled, "launches_bf16"),
        "qstem": (qconv_kernel.qstem, "launches"),
        "qconv": (qconv_kernel.qconv, "launches"),
        "qconv_head": (qconv_kernel.qconv_head, "launches"),
        "qconv_layer": (qconv_kernel.qconv_layer_f32, "launches"),
        "qlayer0": (qconv_kernel.qconv_layer_f32, "launches_layer0"),  # also in qconv_layer
        "qrequant": (qconv_kernel.requantize, "launches"),
        # the packed route's modes, each also counted above
        "context_layer_packed": (context_kernel.fused_context_head, "launches_packed"),
        "qconv_head_packed": (qconv_kernel.qconv_head, "launches_packed"),
        "slots_packed": (postproc_kernel.component_slots, "launches_packed"),
        "slots_tiled_packed": (postproc_kernel.component_slots_tiled, "launches_packed"),
        "geometry_compat_packed": (postproc_kernel.geometry_compat, "launches_packed"),
        "geometry_compat_large_packed": (postproc_kernel.geometry_compat_large, "launches_packed"),
    }
    tiled = ["ccl_tiled", "slots_tiled"]  # not on the 128² and smaller maps
    bf16 = ["ccl_bf16", "slots_bf16", "geometry_compat_bf16", "ccl_tiled_bf16",
            "slots_tiled_bf16"]  # not on the f32 paths
    # the large K12c launches only on the compat route past 200² maps, and
    # the packed modes only on the large-scan route: a path that does not
    # name them must not launch them
    large_compat = ["geometry_compat_large", "geometry_compat_large_bf16"]
    packed_modes = [k for k in wrappers if k.endswith("_packed")]

    # the calibration's bias correction: one convolution a layer and the head
    # (qconv_layer_f32: the f32 pre-activation and the accumulator), one
    # requantization a layer (requantize)
    calib8 = ["qconv_layer", "qrequant"]

    def calib_launches(n, c, name):
        layers = len(_conv_specs(c))
        if (n["qconv_layer"], n["qrequant"]) != (layers + 1, layers):
            raise AssertionError(f"{name}: {n['qconv_layer']} qconv_layer_f32 and {n['qrequant']} "
                                 f"requantize launches, expected {layers + 1} and {layers}")

    def counted(run, must_launch, must_not):
        must_not = [*must_not, *(k for k in large_compat + packed_modes if k not in must_launch)]
        for f, attr in wrappers.values():
            setattr(f, attr, 0)
        out = run()
        torch.cuda.synchronize()
        n = {name: getattr(f, attr) for name, (f, attr) in wrappers.items()}
        if not all(n[k] > 0 for k in must_launch) or any(n[k] for k in must_not):
            raise AssertionError(f"launches {n}: expected {must_launch} > 0, {must_not} == 0")
        return out, n

    main_kernels = ["context_layer", "ccl", "slots", "rect_compact"]
    (res_d, logits_d), n_main = counted(
        lambda: detect_program_batch(params_d, imgs, cfg, (IMG, IMG), device="cuda"),
        main_kernels, ["geometry_compat", "rect_exact", *tiled, *bf16])
    launches = {k: n_main[k] for k in main_kernels}
    if n_main["context_layer"] != len(dil):
        raise AssertionError(f"main path: {n_main['context_layer']} context launches, "
                             f"expected one for each of {len(dil)} layers")
    log(f"main path: B={B} {IMG}x{IMG} uint8 f32 K={K} M={M}, launches {launches}")
    res = {k: v.cpu().numpy() for k, v in res_d.items()}
    logits = logits_d.cpu().numpy()
    if not (np.isfinite(logits).all() and logits.shape == (B, IMG // 4, IMG // 4, 17)):
        raise AssertionError("main path: logits not finite or of the wrong shape")
    n_det = int(res["num_detections"].sum())
    if n_det == 0:
        raise AssertionError("main path: no valid detection")
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    ref, ref_logits = detect_program_batch(params, imgs, cfg, (IMG, IMG), fused=True, device="cpu")
    t_cpu = time.perf_counter() - t0
    ref = {k: v.numpy() for k, v in ref.items()}
    err_logits = float(np.abs(logits - ref_logits.numpy()).max())
    if not err_logits <= 1e-4:
        raise AssertionError(f"main path: logits differ from the plain route by {err_logits}")
    skipped_imgs, skipped_cls = compare_detections(
        res, ref, logits[..., 0], box_atol=4e-4, score_atol=1e-5
    )
    log(f"main path: {n_det} detections in {B} images, "
        f"{int(res['num_components_total'].sum())} components; == plain route on the host "
        f"CPU ({t_cpu:.1f} s): logits max|err| {err_logits:.3g}, {skipped_imgs} images and "
        f"{skipped_cls} near-tie class ids left out")

    # --- 3b. the QVGA camera stream through StreamingDetector ---
    phase("stream")
    stream = StreamingDetector(cfg_q, params, QVGA, batch_size=B, device="cuda")
    got, n_stream = counted(
        lambda: list(stream.process(iter(frames))),
        ["context_layer", "ccl", "slots", "rect_exact"],
        ["rect_compact", "geometry_compat", *tiled, *bf16])
    launches["rect_exact"] = n_stream["rect_exact"]
    if n_stream["context_layer"] != N_FRAMES // B * len(cfg_q.dilations):
        raise AssertionError(f"stream: {n_stream['context_layer']} context launches, expected "
                             f"one for each of {len(cfg_q.dilations)} layers of {N_FRAMES // B} batches")
    if [i for i, _ in got] != list(range(N_FRAMES)):
        raise AssertionError("stream: frame indices not 0..N-1 in order")
    res_s = {k: np.stack([d[k] for _, d in got]) for k in got[0][1]}
    t0 = time.perf_counter()
    ref_s, lg_s = {}, []
    for b0 in range(0, N_FRAMES, B):
        r, lg = detect_program_batch(params, frames[b0:b0 + B], cfg_q, QVGA, fused=True, device="cpu")
        for k, v in r.items():
            ref_s.setdefault(k, []).append(v.numpy())
        lg_s.append(lg[..., 0].numpy())
    t_cpu_s = time.perf_counter() - t0
    ref_s = {k: np.concatenate(v) for k, v in ref_s.items()}
    n_det_s = int(res_s["num_detections"].sum())
    if n_det_s == 0:
        raise AssertionError("stream: no valid detection")
    skipped_s = compare_detections(
        res_s, ref_s, np.concatenate(lg_s), box_atol=4e-4, score_atol=1e-5)
    log(f"stream: {N_FRAMES} frames {QVGA[0]}x{QVGA[1]} uint8, batch {B}, K={K} "
        f"M={cfg_q.max_hull_points}, launches {n_stream}; {n_det_s} detections; all "
        f"{N_FRAMES} frames compared, == plain route on the host CPU ({t_cpu_s:.1f} s), "
        f"{skipped_s[0]} frames (a det logit within 1e-4 of the threshold) and "
        f"{skipped_s[1]} near-tie class ids left out")

    # --- 3c. the compat route: the main path with UBDVSS_PALLAS_COMPAT=1 ---
    phase("compat route")
    def compat_path():
        return with_compat(lambda: detect_program_batch(
            params_d, imgs, cfg, (IMG, IMG), detections_only=True, device="cuda")[0])

    res_c, n_compat = counted(
        compat_path, ["context_layer", "geometry_compat", "rect_compact"],
        ["ccl", "slots", *tiled, *bf16])
    launches["geometry_compat"] = n_compat["geometry_compat"]
    for k, v in res_c.items():
        if not torch.equal(v, res_d[k]):
            raise AssertionError(f"compat route: {k} differs from the default route")
    log(f"compat route: launches {n_compat}; detections identical to the default route")

    # --- 3d. single-image detection: detect and detect_program, the XLA
    # route's exact rects ---
    phase("detect")
    n_scenes = 4
    det_d = BarcodeDetector(cfg, params, device="cuda")
    det_h = BarcodeDetector(cfg, params, device="cpu")
    launches["rect_exact_detect"] = 0
    n_dets = 0
    for i in range(n_scenes):
        (res_1, lg_1), n_detect = counted(
            lambda: detect_program(params_d, imgs[i], cfg, (IMG, IMG), device="cuda"),
            ["context_layer", "ccl", "slots", "rect_exact"],
            ["rect_compact", "geometry_compat", *tiled, *bf16])
        dets, n_detect2 = counted(lambda: det_d.detect(imgs[i]),
                                  ["context_layer", "ccl", "slots", "rect_exact"],
                                  ["rect_compact", "geometry_compat", *tiled, *bf16])
        launches["rect_exact_detect"] += n_detect["rect_exact"] + n_detect2["rect_exact"]
        ref_1, ref_lg_1 = detect_program(params, imgs[i], cfg, (IMG, IMG), device="cpu")
        lg_1 = lg_1.cpu().numpy()
        err_1 = float(np.abs(lg_1 - ref_lg_1.numpy()).max())
        if not err_1 <= 1e-4:
            raise AssertionError(f"detect_program: logits differ from the plain route by {err_1}")
        compare_detections({k: v.cpu().numpy()[None] for k, v in res_1.items()},
                           {k: v.numpy()[None] for k, v in ref_1.items()}, lg_1[None, ..., 0],
                           box_atol=4e-4, score_atol=1e-5)
        if np.abs(lg_1[..., 0]).min() >= 1e-4:
            ref_dets = det_h.detect(imgs[i])
            if len(dets) != len(ref_dets) or len(dets) != int(res_1["num_detections"]):
                raise AssertionError("detect: detections differ from the plain route")
            for o, r in zip(dets, ref_dets):
                if (o.class_id, o.area) != (r.class_id, r.area) or abs(o.score - r.score) > 1e-5:
                    raise AssertionError("detect: a detection differs from the plain route")
                if not same_corner_sets(o.box, r.box, 4e-4):
                    raise AssertionError("detect: a box differs from the plain route")
        n_dets += len(dets)
    if n_dets == 0:
        raise AssertionError("detect: no detection in the scenes")
    log(f"detect: {n_scenes} {IMG}x{IMG} scenes through detect_program and "
        f"BarcodeDetector.detect on the card, launches of one call {n_detect}; {n_dets} "
        "detections, == the plain route on the host CPU")

    # --- 3e. large scans: B=8 2048² scans, the asset's config ---
    phase("large scans")
    large_kernels = ["context_layer", "ccl_tiled", "slots_tiled", "rect_compact"]
    not_large = ["ccl", "slots", "geometry_compat", "rect_exact", *bf16]
    (res_l, logits_l), n_large = counted(
        lambda: detect_program_batch(params_d, scans, cfg_l, (SCAN, SCAN), n_strips=1,
                                     device="cuda"),
        large_kernels, not_large)
    if n_large["context_layer"] != len(dil_l):
        raise AssertionError(f"large scans: {n_large['context_layer']} context launches")
    launches.update({k: n_large[k] for k in tiled})
    res_l = {k: v.cpu().numpy() for k, v in res_l.items()}
    logits_l = logits_l.cpu().numpy()
    if not (np.isfinite(logits_l).all() and logits_l.shape == (B_SCAN, SCAN // 4, SCAN // 4, 17)):
        raise AssertionError("large scans: logits not finite or of the wrong shape")
    n_cmp = 2
    t0 = time.perf_counter()
    ref_l, ref_lg_l = detect_program_batch(params, scans[:n_cmp], cfg_l, (SCAN, SCAN), fused=True,
                                           n_strips=1, device="cpu")
    t_cpu_l = time.perf_counter() - t0
    err_lg_l = float(np.abs(logits_l[:n_cmp] - ref_lg_l.numpy()).max())
    if not err_lg_l <= 1e-4:
        raise AssertionError(f"large scans: logits differ from the plain route by {err_lg_l}")
    skipped_l = compare_detections({k: v[:n_cmp] for k, v in res_l.items()},
                                   {k: v.numpy() for k, v in ref_l.items()},
                                   logits_l[:n_cmp, ..., 0], box_atol=4e-4, score_atol=1e-5)
    n_det_l = int(res_l["num_detections"].sum())
    n_det_cmp = int(res_l["num_detections"][:n_cmp].sum())
    if skipped_l[0] or n_det_cmp == 0:
        raise AssertionError(f"large scans: {skipped_l[0]} of the {n_cmp} compared scans left "
                             f"out, {n_det_cmp} detections compared with the plain route")
    log(f"large scans: B={B_SCAN} {SCAN}x{SCAN} uint8 f32 K={K_l} M={M_l}, launches {n_large}; "
        f"{n_det_l} detections; all {n_cmp} compared scans ({n_det_cmp} detections) == plain "
        f"route on the host CPU ({t_cpu_l:.1f} s): logits max|err| {err_lg_l:.3g}, "
        f"{skipped_l[1]} near-tie class ids left out")

    # --- 3f. one 4096² scan: a 1024² heatmap ---
    phase("4096² scan")
    (res_b, logits_b), n_big = counted(
        lambda: detect_program_batch(params_d, big, cfg_l, (BIG_SCAN, BIG_SCAN), n_strips=1,
                                     device="cuda"),
        large_kernels, not_large)
    res_b = {k: v.cpu().numpy() for k, v in res_b.items()}
    logits_b = logits_b.cpu().numpy()
    t0 = time.perf_counter()
    ref_b, ref_lg_b = detect_program_batch(params, big, cfg_l, (BIG_SCAN, BIG_SCAN), fused=True,
                                           n_strips=1, device="cpu")
    t_cpu_b = time.perf_counter() - t0
    err_lg_b = float(np.abs(logits_b - ref_lg_b.numpy()).max())
    if not (np.isfinite(logits_b).all() and err_lg_b <= 1e-4):
        raise AssertionError(f"4096² scan: logits not finite or off the plain route by {err_lg_b}")
    skipped_b = compare_detections(res_b, {k: v.numpy() for k, v in ref_b.items()},
                                   logits_b[..., 0], box_atol=4e-4, score_atol=1e-5)
    if skipped_b[0] or int(res_b["num_detections"].sum()) == 0:
        raise AssertionError("4096² scan: no detection compared with the plain route")
    log(f"4096² scan: {BIG_SCAN}x{BIG_SCAN} uint8, launches {n_big}; "
        f"{int(res_b['num_detections'].sum())} detections == plain route on the host CPU "
        f"({t_cpu_b:.1f} s): logits max|err| {err_lg_b:.3g}")

    # --- 3g. detect at 640x480, 1024x768 and 1024x1024, the asset's config ---
    phase("detect at three sizes")
    det_l_d = BarcodeDetector(cfg_l, params, device="cuda")
    det_l_h = BarcodeDetector(cfg_l, params, device="cpu")
    detect_launches = {}
    for hw, img in zip(DETECT_HW, photos):
        gh, gw = cfg_l.grid_size(*hw)
        big_map = (gh // 4) * (gw // 4) * 4 > ccl_kernel.MAX_SHARED_BYTES
        must = ["context_layer", "rect_exact", *(tiled if big_map else ["ccl", "slots"])]
        must_not = ["rect_compact", "geometry_compat", *bf16,
                    *(["ccl", "slots"] if big_map else tiled)]
        (res_1, lg_1), n_1 = counted(
            lambda: detect_program(params_d, img, cfg_l, (gh, gw), device="cuda"), must, must_not)
        dets, n_2 = counted(lambda: det_l_d.detect(img), must, must_not)
        detect_launches[f"{hw[1]}x{hw[0]}"] = n_2
        ref_1, ref_lg_1 = detect_program(params, img, cfg_l, (gh, gw), device="cpu")
        lg_1 = lg_1.cpu().numpy()
        err_1 = float(np.abs(lg_1 - ref_lg_1.numpy()).max())
        if not err_1 <= 1e-4:
            raise AssertionError(f"detect {hw}: logits differ from the plain route by {err_1}")
        skipped_1 = compare_detections({k: v.cpu().numpy()[None] for k, v in res_1.items()},
                                       {k: v.numpy()[None] for k, v in ref_1.items()},
                                       lg_1[None, ..., 0], box_atol=4e-4, score_atol=1e-5)
        ref_dets = det_l_h.detect(img)
        if skipped_1[0] or not dets or len(dets) != len(ref_dets):
            raise AssertionError(f"detect {hw}: detections not compared or differ in number")
        for o, r in zip(dets, ref_dets):
            if (o.class_id, o.area) != (r.class_id, r.area) or abs(o.score - r.score) > 1e-5:
                raise AssertionError(f"detect {hw}: a detection differs from the plain route")
            if not same_corner_sets(o.box, r.box, 4e-4):
                raise AssertionError(f"detect {hw}: a box differs from the plain route")
        log(f"detect {hw[1]}x{hw[0]}: {gh // 4}x{gw // 4} heatmap, launches of one call {n_2}; "
            f"{len(dets)} detections == the plain route on the host CPU")

    # --- 3g'. tall pages past _fused_heatmap_limit: an A4 page at 600 dpi
    # (a 1754-row heatmap) and an 8192x1024 page (2048 rows, past the
    # one-block K3x's cap), the asset's config with max_image_side raised
    # so that detect keeps the page's resolution, as a document-scan
    # deployment does; the XLA route, so K3x and not K3 ---
    cfg_page = cfg_l.replace(max_image_side=max(A4_PAGE + TALL_PAGE))
    pages = {}
    for hw, seed in ((A4_PAGE, SEED), (TALL_PAGE, SEED + 1)):
        phase(f"{hw[0]}x{hw[1]} page")
        page = SyntheticMarkupReader(n_samples=1, image_hw=hw, seed=seed,
                                     n_objects=(3, 6)).sample_at(0).image
        det_p = BarcodeDetector(cfg_page, params, device="cuda")
        must = ["context_layer", "ccl_tiled", "slots_tiled", "rect_exact"]
        must_not = ["rect_compact", "ccl", "slots", "geometry_compat", *bf16]
        (res_p, lg_p), n_p = counted(
            lambda: detect_program_batch(params_d, page[None], cfg_page, hw, device="cuda"),
            must, must_not)
        dets_p, n_p2 = counted(lambda: det_p.detect(page), must, must_not)
        Hh = hw[0] // cfg_page.scale
        if lg_p.shape[1] != Hh or Hh <= 1024:
            raise AssertionError(f"page {hw}: a {lg_p.shape[1]}-row heatmap, expected {Hh} > 1024")
        t0 = time.perf_counter()
        ref_p, ref_lg_p = detect_program(params, page, cfg_page, hw, device="cpu")
        t_cpu_p = time.perf_counter() - t0
        lg_p_h = lg_p.cpu().numpy()
        err_p = float(np.abs(lg_p_h[0] - ref_lg_p.numpy()).max())
        if not err_p <= 1e-4:
            raise AssertionError(f"page {hw}: logits differ from the plain route by {err_p}")
        ref_p = {k: v.numpy() for k, v in ref_p.items()}
        # boxes within 2e-3 px: one f32 ulp is 4.9e-4 px past 4096 px
        skipped_p = compare_detections({k: v.cpu().numpy() for k, v in res_p.items()},
                                       {k: v[None] for k, v in ref_p.items()}, lg_p_h[..., 0],
                                       box_atol=2e-3, score_atol=1e-5)
        valid_p = np.flatnonzero(ref_p["valid"])
        if skipped_p[0] or not dets_p or len(dets_p) != len(valid_p):
            raise AssertionError(f"page {hw}: detections not compared or differ in number")
        for o, i in zip(dets_p, valid_p):
            if ((o.class_id, o.area) != (int(ref_p["classes"][i]), int(ref_p["areas"][i]))
                    or abs(o.score - float(ref_p["scores"][i])) > 1e-5
                    or not same_corner_sets(o.box, ref_p["boxes"][i], 2e-3)):
                raise AssertionError(f"page {hw}: a detect detection differs from the plain route")
        with torch.inference_mode():
            g_p = postproc_kernel.component_stats_from_logits(lg_p, K_l)
        pages[f"h{Hh}"] = dict(page=page, det=det_p, minx=g_p["minx"], maxx=g_p["maxx"],
                               launches=n_p["rect_exact"] + n_p2["rect_exact"], cpu_s=t_cpu_p)
        log(f"page {hw[0]}x{hw[1]}: {Hh}x{hw[1] // cfg_page.scale} heatmap, K={K_l} M={M_l}, "
            f"detect_program_batch launches {n_p}, detect {n_p2}; {len(dets_p)} detections == "
            f"the plain route on the host CPU ({t_cpu_p:.1f} s): logits max|err| {err_p:.3g}")

    # --- 3h. the bf16 main path (the JAX bench's default mode) ---
    phase("bf16 main path")
    main16 = ["ccl_bf16", "slots_bf16", "rect_compact"]
    not16 = ["context_layer", "ccl", "slots", "geometry_compat", "geometry_compat_bf16",
             "rect_exact", *tiled, "ccl_tiled_bf16", "slots_tiled_bf16"]
    (res16_d, logits16_d), n_main16 = counted(
        lambda: detect_program_batch(params16_d, imgs, cfg16, (IMG, IMG), device="cuda"),
        main16, not16)
    launches.update({k: n_main16[k] for k in ("ccl_bf16", "slots_bf16")})
    res16 = {k: v.cpu().numpy() for k, v in res16_d.items()}
    logits16 = logits16_d.cpu().numpy()
    if not (logits16_d.dtype == torch.float32 and np.isfinite(logits16).all()
            and logits16.shape == (B, IMG // 4, IMG // 4, 17)):
        raise AssertionError("bf16 main path: logits not f32, not finite or of the wrong shape")
    if int(res16["num_detections"].sum()) == 0:
        raise AssertionError("bf16 main path: no valid detection")
    t0 = time.perf_counter()
    ref16, ref_lg16 = detect_program_batch(params16, imgs, cfg16, (IMG, IMG), fused=True, device="cpu")
    t_cpu16 = time.perf_counter() - t0
    ref_lg16 = ref_lg16.numpy()
    ulps16 = float(np.abs(logits16 - ref_lg16).max() / (np.abs(ref_lg16).max() * 2.0**-8))
    if not ulps16 <= LOGIT_ULPS:
        raise AssertionError(f"bf16 main path: logits {ulps16} bf16 ulps off the host CPU's")
    tol16 = LOGIT_ULPS * 2.0**-8 * float(np.abs(ref_lg16).max())
    cmp16 = compare_bf16_detections(res16, {k: v.numpy() for k, v in ref16.items()},
                                    logits16[..., 0], ref_lg16[..., 0], tol16, "bf16 main path")
    # the JAX perf mode's contract (tests/test_context_kernel.py:76-97): the
    # same count and classes as f32, scene by scene; reported, not gated
    same_count = res16["num_detections"] == res["num_detections"]
    same_cls = np.array([np.array_equal(res16["classes"][b][res16["valid"][b]],
                                        res["classes"][b][res["valid"][b]]) for b in range(B)])
    agree16 = int((same_count & same_cls).sum())
    log(f"bf16 main path: B={B} {IMG}x{IMG} uint8 bf16 K={K} M={M}, launches {n_main16}; "
        f"{int(res16['num_detections'].sum())} detections; == the bf16 route on the host CPU "
        f"({t_cpu16:.1f} s): logits max|err| {ulps16:.3g} bf16 ulps of max|logit|, {cmp16}; "
        f"{agree16} of {B} scenes with the f32 path's count and classes")
    copies = logit_copies(
        lambda: detect_program_batch(params16_d, imgs_d, cfg16, (IMG, IMG),
                                     detections_only=True, device="cuda"),
        B * (IMG // 4) ** 2 * 17)
    if copies:
        raise AssertionError(f"bf16 main path: copies of the whole logits {copies}")

    # --- 3i. the bf16 compat route ---
    phase("bf16 compat route")

    def compat16():
        return with_compat(lambda: detect_program_batch(
            params16_d, imgs, cfg16, (IMG, IMG), detections_only=True, device="cuda")[0])

    res16_c, n_compat16 = counted(
        compat16, ["geometry_compat_bf16", "rect_compact"],
        ["context_layer", "ccl", "slots", "ccl_bf16", "slots_bf16", "geometry_compat", *tiled,
         "ccl_tiled_bf16", "slots_tiled_bf16"])
    launches["geometry_compat_bf16"] = n_compat16["geometry_compat_bf16"]
    for k, v in res16_c.items():
        if not torch.equal(v, res16_d[k]):
            raise AssertionError(f"bf16 compat route: {k} differs from the bf16 default route")
    with torch.inference_mode():
        lg16_main = fused_model_apply(params16_d, imgs_d.to(torch.bfloat16)[..., None], cfg16,
                                      raw_gray=True, act_out=True)
        fused16 = postproc_kernel.geometry_compat(lg16_main, K)
        pair16 = postproc_kernel.component_slots(
            lg16_main, ccl_kernel.ccl_labels_from_logits(lg16_main[..., 0].contiguous()), K)
    for key in fused16:
        if not torch.equal(fused16[key], pair16[key]):
            raise AssertionError(f"bf16 compat route: K12c's {key} differs from the bf16 K2's")
    log(f"bf16 compat route: launches {n_compat16}; detections identical to the bf16 default "
        "route; K12c's eight outputs bit for bit equal to the bf16 K2's after K1")

    # --- 3j. bf16 large scans: B=8 2048² scans, the asset's config ---
    phase("bf16 large scans")
    (res_l16, logits_l16), n_large16 = counted(
        lambda: detect_program_batch(params16_d, scans, cfg_l16, (SCAN, SCAN), n_strips=1,
                                     device="cuda"),
        ["ccl_tiled_bf16", "slots_tiled_bf16", "rect_compact"],
        ["context_layer", "ccl", "slots", "ccl_bf16", "slots_bf16", "geometry_compat",
         "geometry_compat_bf16", "rect_exact", *tiled])
    launches.update({k: n_large16[k] for k in ("ccl_tiled_bf16", "slots_tiled_bf16")})
    res_l16 = {k: v.cpu().numpy() for k, v in res_l16.items()}
    logits_l16 = logits_l16.cpu().numpy()
    if not (np.isfinite(logits_l16).all() and logits_l16.shape == (B_SCAN, SCAN // 4, SCAN // 4, 17)):
        raise AssertionError("bf16 large scans: logits not finite or of the wrong shape")
    t0 = time.perf_counter()
    ref_l16, ref_lg_l16 = detect_program_batch(params16, scans[:n_cmp], cfg_l16, (SCAN, SCAN),
                                               fused=True, n_strips=1, device="cpu")
    t_cpu_l16 = time.perf_counter() - t0
    ref_lg_l16 = ref_lg_l16.numpy()
    ulps_l16 = float(np.abs(logits_l16[:n_cmp] - ref_lg_l16).max()
                     / (np.abs(ref_lg_l16).max() * 2.0**-8))
    if not ulps_l16 <= LOGIT_ULPS:
        raise AssertionError(f"bf16 large scans: logits {ulps_l16} bf16 ulps off the host CPU's")
    cmp_l16 = compare_bf16_detections(
        {k: v[:n_cmp] for k, v in res_l16.items()}, {k: v.numpy() for k, v in ref_l16.items()},
        logits_l16[:n_cmp, ..., 0], ref_lg_l16[..., 0],
        LOGIT_ULPS * 2.0**-8 * float(np.abs(ref_lg_l16).max()), "bf16 large scans")
    log(f"bf16 large scans: B={B_SCAN} {SCAN}x{SCAN} uint8 bf16 K={K_l} M={M_l}, launches "
        f"{n_large16}; {int(res_l16['num_detections'].sum())} detections; the first {n_cmp} == "
        f"the bf16 route on the host CPU ({t_cpu_l16:.1f} s): logits max|err| {ulps_l16:.3g} "
        f"ulps, {cmp_l16}")

    # --- 3j'. the compat route on the large scans: K12c past one block's
    # shared memory (geometry_compat_large), once a call, in f32 and bf16;
    # detections identical to the default route's on the card ---
    phase("compat route on the large scans")
    big_d = torch.from_numpy(big).to(dev)

    def scan_run(p_, c_, images, hw):
        return lambda: detect_program_batch(p_, images, c_, hw, detections_only=True,
                                            n_strips=1, device="cuda")[0]

    compat_runs = {
        "2048² scans f32": (scan_run(params_d, cfg_l, scans, (SCAN, SCAN)), res_l, False),
        "4096² scan f32": (scan_run(params_d, cfg_l, big_d, (BIG_SCAN, BIG_SCAN)), res_b, False),
        "2048² scans bf16": (scan_run(params16_d, cfg_l16, scans, (SCAN, SCAN)), res_l16, True),
        "4096² scan bf16": (scan_run(params16_d, cfg_l16, big_d, (BIG_SCAN, BIG_SCAN)), None, True),
    }
    n_compat_l = {}
    for name, (run, ref_c, is16) in compat_runs.items():
        if ref_c is None:  # the default route on the card
            ref_c = {k: v.cpu().numpy() for k, v in run().items()}
        k12 = "geometry_compat_large_bf16" if is16 else "geometry_compat_large"
        res_cl, n_cl = counted(
            lambda: with_compat(run), [k12, "rect_compact", *([] if is16 else ["context_layer"])],
            ["ccl", "slots", "geometry_compat", "geometry_compat_bf16", "rect_exact", *tiled,
             "ccl_bf16", "slots_bf16", "ccl_tiled_bf16", "slots_tiled_bf16"])
        if n_cl[k12] != 1:
            raise AssertionError(f"compat {name}: {n_cl[k12]} launches of {k12}, expected 1")
        for k, v in res_cl.items():
            if not np.array_equal(v.cpu().numpy(), ref_c[k]):
                raise AssertionError(f"compat {name}: {k} differs from the default route")
        n_compat_l[name] = n_cl[k12]
        launches[k12] = launches.get(k12, 0) + n_cl[k12]
        log(f"compat route {name}: launches {n_cl}; detections identical to the default route")

    # --- 3k. bf16 detect (512² and 640x480) and the QVGA stream ---
    phase("bf16 detect and stream")
    det16_d = BarcodeDetector(cfg16, params16, device="cuda")
    det16_h = BarcodeDetector(cfg16, params16, device="cpu")
    det16_ld = BarcodeDetector(cfg_l16, params16, device="cuda")
    det16_lh = BarcodeDetector(cfg_l16, params16, device="cpu")
    detect16 = {}
    for name, c16, dd, dh, img in (("512x512", cfg16, det16_d, det16_h, imgs[0]),
                                   ("640x480", cfg_l16, det16_ld, det16_lh, photos[0])):
        # detect_program runs BarcodeFCN in bf16, whose logits are f32 (as
        # the JAX package's get_model(cfg).apply), then the f32 K1, K2, K3x
        out_hw = c16.grid_size(*img.shape[:2])
        must16 = ["ccl", "slots", "rect_exact"]
        not_detect16 = ["context_layer", "rect_compact", "geometry_compat", *tiled, *bf16]
        (res_1, lg_1), _ = counted(
            lambda: detect_program(params16_d, img, c16, out_hw, device="cuda"), must16,
            not_detect16)
        dets, n_16 = counted(lambda: dd.detect(img), must16, not_detect16)
        ref_1, ref_lg_1 = detect_program(params16, img, c16, out_hw, device="cpu")
        lg_1, ref_lg_1 = lg_1.cpu().numpy(), ref_lg_1.numpy()
        ulps_1 = float(np.abs(lg_1 - ref_lg_1).max() / (np.abs(ref_lg_1).max() * 2.0**-8))
        if not ulps_1 <= LOGIT_ULPS:
            raise AssertionError(f"bf16 detect {name}: logits {ulps_1} ulps off the host CPU's")
        cmp_1 = compare_bf16_detections(
            {k: v.cpu().numpy()[None] for k, v in res_1.items()},
            {k: v.numpy()[None] for k, v in ref_1.items()}, lg_1[None, ..., 0],
            ref_lg_1[None, ..., 0], LOGIT_ULPS * 2.0**-8 * float(np.abs(ref_lg_1).max()),
            f"bf16 detect {name}", min_kept=0)
        detect16[name] = {"launches": n_16, "detections": len(dets), "logit_ulps": ulps_1,
                          **cmp_1}
        if cmp_1["left_out"]:
            continue  # a pixel at the threshold changed sides: compared above
        ref_dets = dh.detect(img)
        hm_d, hm_h = dd.heatmap(img), dh.heatmap(img)
        detect16[name]["heatmap_max_abs_diff"] = float(np.abs(hm_d - hm_h).max())
        if not dets or len(dets) != len(ref_dets):
            raise AssertionError(f"bf16 detect {name}: {len(dets)} detections, "
                                 f"{len(ref_dets)} on the host CPU")
        for o, r in zip(dets, ref_dets):
            if (o.class_id, o.area) != (r.class_id, r.area) or abs(o.score - r.score) > SCORE_TOL_BF16:
                raise AssertionError(f"bf16 detect {name}: a detection differs from the host CPU's")
            if not same_corner_sets(o.box, r.box, 1.5):
                raise AssertionError(f"bf16 detect {name}: a box differs by more than 1.5 px")
    log(f"bf16 detect: {detect16}; == the host CPU's detections")
    cfg_q16 = cfg_q.replace(dtype="bfloat16")
    stream16 = StreamingDetector(cfg_q16, params16, QVGA, batch_size=B, device="cuda")
    got16, n_stream16 = counted(
        lambda: list(stream16.process(iter(frames))), ["ccl_bf16", "slots_bf16", "rect_exact"],
        ["context_layer", "ccl", "slots", "rect_compact", "geometry_compat",
         "geometry_compat_bf16", *tiled, "ccl_tiled_bf16", "slots_tiled_bf16"])
    res_s16 = {k: np.stack([d[k] for _, d in got16]) for k in got16[0][1]}
    ref_s16, lg_s16, lg_s16_d = {}, [], []
    for b0 in range(0, N_FRAMES, B):
        r, lg = detect_program_batch(params16, frames[b0:b0 + B], cfg_q16, QVGA, fused=True, device="cpu")
        for k, v in r.items():
            ref_s16.setdefault(k, []).append(v.numpy())
        lg_s16.append(lg[..., 0].numpy())
        lg_s16_d.append(detect_program_batch(params16_d, frames[b0:b0 + B], cfg_q16, QVGA,
                                             device="cuda")[1][..., 0].cpu().numpy())
    ref_s16 = {k: np.concatenate(v) for k, v in ref_s16.items()}
    lg_s16, lg_s16_d = np.concatenate(lg_s16), np.concatenate(lg_s16_d)
    cmp_s16 = compare_bf16_detections(res_s16, ref_s16, lg_s16_d, lg_s16,
                                      LOGIT_ULPS * 2.0**-8 * float(np.abs(lg_s16).max()),
                                      "bf16 stream")
    log(f"bf16 stream: {N_FRAMES} frames {QVGA[0]}x{QVGA[1]} uint8, batch {B}, launches "
        f"{n_stream16}; {int(res_s16['num_detections'].sum())} detections; == the bf16 route "
        f"on the host CPU: {cmp_s16}")

    # --- 3l. the int8 mode: calibration on the card, qconv against its plain version ---
    phase("int8 calibration and kernel checks")
    creader = SyntheticMarkupReader(n_samples=N_CALIB, image_hw=(IMG, IMG), seed=CALIB_SEED)
    calib = (np.stack([creader.sample_at(i).image for i in range(N_CALIB)]).astype(np.float32)
             / 127.5 - 1.0)[..., None]  # bench.py's calibration images
    calib_d = torch.from_numpy(calib).to(dev)
    t0 = time.perf_counter()
    q_d, n_calib = counted(lambda: quantize_trunk(params_d, cfg, calib_d), calib8,
                           ["qstem", "qconv", "qconv_head"])
    t_calib = time.perf_counter() - t0
    calib_launches(n_calib, cfg, "calibration")
    launches.update({k: n_calib[k] for k in calib8})
    t0 = time.perf_counter()
    q_hc = quantize_trunk(params, cfg, torch.from_numpy(calib))
    t_calib_cpu = time.perf_counter() - t0
    calib_diff = qparams_diff(q_d, q_hc)
    check_qparams(calib_diff, "quantize_trunk")
    q_h = qparams_to(q_d, "cpu")  # the card's qparams: every equality check below uses them
    log(f"int8 calibration: quantize_trunk on {N_CALIB} {IMG}x{IMG} scenes (seed {CALIB_SEED}) on "
        f"the card {t_calib:.3f} s ({n_calib['qconv_layer']} qconv_layer_f32 and "
        f"{n_calib['qrequant']} requantize launches), on the host CPU "
        f"{t_calib_cpu:.1f} s; card against host CPU: {calib_diff}")

    err_q = 0.0
    kq = qconv_kernel

    def check_q(name, fn, plain, args, n_host=None):
        """A kernel of the int8 trunk (qstem, qconv, qconv_head) == its plain
        version on the card and on the host CPU (the first ``n_host``
        images), bit for bit; returns the kernel's output."""
        nonlocal err_q
        out = fn(*args)
        ref = plain(*args)
        n = args[0].shape[0] if n_host is None else n_host
        host = [a[:n].cpu() if i == 0 else {k: v.cpu() for k, v in a.items()} if isinstance(a, dict)
                else a.cpu() if torch.is_tensor(a) else a for i, a in enumerate(args)]
        cpu = plain(*host)
        if not (torch.equal(out, ref) and torch.equal(out[:n].cpu(), cpu)):
            bad = int((out != ref).sum()) + int((out[:n].cpu() != cpu).sum())
            raise AssertionError(f"{fn.__name__} {name}: {bad} outputs differ from the plain version")
        err_q = max(err_q, float((out.float() - ref.float()).abs().max()))
        log(f"check {fn.__name__} {name}: {tuple(args[0].shape)} {args[0].dtype} -> "
            f"{tuple(out.shape)} {out.dtype}: == plain version on the card and on the host CPU "
            f"({n} images), bit for bit")
        return out

    def stem(name, x, q, raw, n_host=None):
        L, s = q["layers"], q["s_in"]
        return check_q(name, kq.qstem, kq.qstem_reference, (x, L[0], s[1], L[1], s[2], raw), n_host)

    def qconv_plain(x, layer, s_out, dil):
        return kq.qconv_reference(x, layer, s_out, 1, dil)

    def context(name, x, q, li, d, n_host=None):
        return check_q(name, kq.qconv, qconv_plain,
                       (x, q["layers"][2 + li], q["s_in"][3 + li], d), n_host)

    def fused(name, x, q, li, d, n_host=None):
        return check_q(name, kq.qconv_head, kq.qconv_head_reference,
                       (x, q["layers"][2 + li], q["s_in"][3 + li], d, q["head"]), n_host)

    def check_chain(name, x, q, c, raw, n_host=None):
        """The int8 trunk's eight launches on x — qstem (layers 0 and 1),
        qconv for each context layer but the last, qconv_head for the last
        with the head — each against its plain version; returns (each
        launch's input, the logits)."""
        ins = [x]
        x = stem(f"{name} layers 0-1", x, q, raw, n_host)
        for li, d in enumerate(c.dilations[:-1]):
            ins.append(x)
            x = context(f"{name} context {li} (d={d})", x, q, li, d, n_host)
        ins.append(x)
        n = len(c.dilations)
        return ins, fused(f"{name} context {n - 1} + head", x, q, n - 1, c.dilations[-1], n_host)

    def check_layer_f32(name, x, L, st, d, n_host=2):
        """qconv_layer_f32 (one launch: the f32 pre-activation and the exact
        accumulator) == qconv_reference's pre-activation and
        qconv_acc_reference's accumulator on the card and on the host CPU
        (the first ``n_host`` images), bit for bit."""
        nonlocal err_q
        y, acc = kq.qconv_layer_f32(x, L, st, d)
        ry, racc = kq.qconv_reference(x, L, None, st, d), kq.qconv_acc_reference(x, L, st, d)
        hx, hL = x[:n_host].cpu(), {k: v.cpu() for k, v in L.items()}
        hy, hacc = kq.qconv_reference(hx, hL, None, st, d), kq.qconv_acc_reference(hx, hL, st, d)
        if not (torch.equal(y, ry) and torch.equal(acc, racc) and torch.equal(y[:n_host].cpu(), hy)
                and torch.equal(acc[:n_host].cpu(), hacc)):
            raise AssertionError(f"qconv_layer_f32 {name}: {int((y != ry).sum())} pre-activations "
                                 f"and {int((acc != racc).sum())} accumulators differ from the plain "
                                 "version")
        err_q = max(err_q, float((y - ry).abs().max()))
        log(f"check qconv_layer_f32 {name}: {tuple(x.shape)} {x.dtype} -> {tuple(y.shape)} "
            f"pre-activation and accumulator == plain version on the card and on the host CPU "
            f"({n_host} images), bit for bit")
        return y, acc

    def bias_walk(x, q, c):
        """The bias correction's launches on the calibration images x with the
        corrected qparams q (ops/quant.bias_correct_qparams): each layer's
        qconv_layer_f32 (its f32 pre-activation and accumulator, one launch),
        then requantize (the next layer's int8 input); then the head's
        qconv_layer_f32 without an accumulator.  Each is checked against its
        plain version; returns the calls as (name, function, arguments)."""
        calls = []
        for i, (st, d) in enumerate(_conv_specs(c)):
            L, s_o = q["layers"][i], q["s_in"][i + 1]
            calls.append((f"layer {i}", kq.qconv_layer_f32, (x, L, st, d)))
            _, acc = check_layer_f32(f"bias correction layer {i}", x, L, st, d)
            calls.append((f"requantize {i}", kq.requantize, (acc, L["ws"], L["b"], s_o)))
            x = check_q(f"bias correction layer {i}", kq.requantize, kq.requantize_reference,
                        calls[-1][2], n_host=2)
        calls.append(("head", kq.qconv_layer_f32, (x, q["head"], 1, 1, False)))
        check_layer_f32("bias correction head", x, q["head"], 1, 1)
        return calls

    def saturating(cin, cout, ks=3):
        """Every weight +-127 by output channel and ws of that sign mapping
        the full accumulator ks^2 Cin 127^2 to 40: on inputs of 127 every
        interior output is 40, the accumulators of both signs at their
        extremes."""
        sign = torch.tensor([1.0 if c % 2 == 0 else -1.0 for c in range(cout)], device=dev)
        return dict(q=(127 * sign).to(torch.int8).expand(ks, ks, cin, cout).contiguous(),
                    ws=(torch.tensor(40.0 / (ks * ks * cin * 127**2), device=dev) * sign).float(),
                    b=torch.zeros(cout, device=dev))

    with torch.inference_mode():
        calls_bias = bias_walk(calib_d, q_d, cfg)
        ins8, lg8_chain = check_chain("main path", imgs_d, q_d, cfg, raw=True, n_host=8)
        x_main = imgs_d.float()
        stem("f32 raw", x_main, q_d, True, n_host=8)
        stem("f32 normalized", (x_main / 127.5 - 1.0)[..., None], q_d, False, n_host=8)
        check_chain("QVGA stream", frames_d, q_d, cfg_q, raw=True, n_host=8)
        check_chain("B=1", imgs_d[:1].contiguous(), q_d, cfg, raw=True)
        check_chain("2048² scans", scans_d, q_d, cfg_l, raw=True, n_host=1)
        rng = np.random.default_rng(SEED)
        odd = torch.from_numpy(rng.uniform(0, 255, (3, 75, 101)).astype(np.float32)).to(dev)
        odd = stem("odd 75x101 (38x51, then 19x26)", odd, q_d, True)
        context("odd 19x26 d=16", odd, q_d, 5, 16)
        fused("odd 19x26", odd, q_d, 6, 1)
        rand = torch.from_numpy(rng.integers(-127, 128, (8, IMG // 4, IMG // 4, 24)).astype(np.int8)).to(dev)
        context("random d=16", rand, q_d, 5, 16)
        fused("random d=16", rand, q_d, 5, 16)
        # saturation: every weight +-127 on +-127 inputs, |acc| = 9 * 24 * 127^2 inside;
        # ws = 40 / 3,483,864 and s_out = 1 put +3,483,864 at the int8 40
        sat = torch.full((2, 40, 40, 24), 127, dtype=torch.int8, device=dev)
        sat[1] = -127
        acc_max = 9 * 24 * 127**2
        for sign in (1, -1):
            sat_layer = dict(q=torch.full_like(q_d["layers"][2]["q"], 127 * sign),
                             ws=torch.full((24,), 40.0 / acc_max, device=dev),
                             b=torch.zeros(24, device=dev))
            o = check_q(f"saturated {'+' if sign > 0 else '-'}127 weights", kq.qconv,
                        qconv_plain, (sat, sat_layer, torch.ones(24, device=dev), 1))
            inner = o[:, 1:-1, 1:-1].cpu()
            if not (bool((inner[(1 - sign) // 2] == 40).all()) and bool((inner[(1 + sign) // 2] == 0).all())):
                raise AssertionError("qconv saturated: the accumulators are not ±3,483,864")
        signs = dict(q_d["layers"][2], q=torch.where(torch.rand(q_d["layers"][2]["q"].shape, device=dev)
                                                     < 0.5, -127, 127).to(torch.int8))
        check_q("saturated ±127 requant", kq.qconv, qconv_plain, (sat, signs, q_d["s_in"][3], 1))
        check_q("saturated ±127 + head", kq.qconv_head, kq.qconv_head_reference,
                (sat, dict(signs, q=torch.full_like(signs["q"], 127)), q_d["s_in"][3], 1, q_d["head"]))
        context("zeros", torch.zeros_like(sat), q_d, 1, 2)
        # 32 channels at saturation: |acc| = 9 * 32 * 127^2 = 4,645,152, past the
        # epilogue's conversion-free window (the plan's acc_wide); interior outputs 40
        sat32 = torch.full((2, 40, 40, 32), 127, dtype=torch.int8, device=dev)
        sat32[1] = -127
        ones32 = torch.ones(32, device=dev)
        head32 = dict(q=torch.from_numpy(rng.integers(-127, 128, (1, 1, 32, 17)).astype(np.int8)).to(dev),
                      ws=torch.full((17,), 1e-3, device=dev), b=torch.zeros(17, device=dev))
        img255 = torch.full((2, 100, 76), 255, dtype=torch.uint8, device=dev)  # quantizes to 127
        l0_127 = dict(q=torch.full((3, 3, 1, 32), 127, dtype=torch.int8, device=dev),
                      ws=torch.full((32,), 1 / 127, device=dev), b=torch.zeros(32, device=dev))
        for o in (check_q("saturated 32 channels", kq.qconv, qconv_plain,
                          (sat32, saturating(32, 32), ones32, 1)),
                  check_q("saturated 32 channels layer 1", kq.qstem, kq.qstem_reference,
                          (img255, l0_127, ones32, saturating(32, 32), ones32, True))):
            if not bool((o[0, 1:-1, 1:-1] == 40).all()):
                raise AssertionError("saturated 32 channels: the accumulators are not ±4,645,152")
        check_q("saturated 32 channels + head", kq.qconv_head, kq.qconv_head_reference,
                (sat32, saturating(32, 32), ones32, 1, head32))

    # --- 3m. the int8 main path: bench.py's int8 protocol ---
    phase("int8 main path")
    trunk8 = ["qstem", "qconv", "qconv_head"]
    main8 = [*trunk8, "ccl", "slots", "rect_compact"]
    not8 = ["context_layer", "geometry_compat", "rect_exact", *calib8, *tiled, *bf16]
    (res8_d, logits8_d), n_main8 = counted(
        lambda: detect_program_batch(params_d, imgs, cfg, (IMG, IMG), qparams=q_d, device="cuda"),
        main8, not8)

    def trunk_launches(n, batches, name):
        """qstem once, qconv once a context layer but the last, qconv_head
        once: 1 + len(dilations) launches a batch."""
        want = [batches, batches * (len(dil) - 1), batches]
        if [n[k] for k in trunk8] != want:
            raise AssertionError(f"{name}: trunk launches {[n[k] for k in trunk8]}, expected {want}")

    trunk_launches(n_main8, 1, "int8 main path")
    launches.update({k: n_main8[k] for k in trunk8})
    res8 = {k: v.cpu().numpy() for k, v in res8_d.items()}
    logits8 = logits8_d.cpu().numpy()
    if not (np.isfinite(logits8).all() and logits8.shape == (B, IMG // 4, IMG // 4, 17)):
        raise AssertionError("int8 main path: logits not finite or of the wrong shape")
    if not np.array_equal(logits8, lg8_chain.cpu().numpy()):
        raise AssertionError("int8 main path: logits differ from the checked layer chain's")
    if int(res8["num_detections"].sum()) == 0:
        raise AssertionError("int8 main path: no valid detection")
    t0 = time.perf_counter()
    ref8, ref_lg8 = detect_program_batch(params, imgs, cfg, (IMG, IMG), qparams=q_h, fused=True, device="cpu")
    t_cpu8 = time.perf_counter() - t0
    ref_lg8 = ref_lg8.numpy()
    if not np.array_equal(logits8, ref_lg8):
        raise AssertionError(f"int8 main path: {int((logits8 != ref_lg8).sum())} logits differ from "
                             "the host CPU's")
    skipped8 = compare_detections(res8, {k: v.numpy() for k, v in ref8.items()}, logits8[..., 0],
                                  box_atol=4e-4, score_atol=1e-5, margin=0.0)
    same_count8 = res8["num_detections"] == res["num_detections"]
    same_cls8 = np.array([np.array_equal(res8["classes"][b][res8["valid"][b]],
                                         res["classes"][b][res["valid"][b]]) for b in range(B)])
    agree8 = int((same_count8 & same_cls8).sum())
    log(f"int8 main path: B={B} {IMG}x{IMG} uint8 K={K} M={M}, launches {n_main8}; "
        f"{int(res8['num_detections'].sum())} detections; == the host CPU ({t_cpu8:.1f} s) with "
        f"the same qparams: logits bit for bit, detections identical ({skipped8[1]} near-tie class "
        f"ids left out); {agree8} of {B} scenes with the f32 path's count and classes")

    # --- 3n. int8 large scans: B=8 2048² scans, the asset's config ---
    phase("int8 large scans")
    (res8_l, lg8_l), n_large8 = counted(
        lambda: detect_program_batch(params_d, scans, cfg_l, (SCAN, SCAN), qparams=q_d, device="cuda"),
        [*trunk8, "qconv_head_packed", "ccl_tiled", "slots_tiled", "slots_tiled_packed",
         "rect_compact"],
        ["context_layer", "ccl", "slots", "geometry_compat", "rect_exact", *calib8, *bf16])
    trunk_launches(n_large8, 1, "int8 large scans")
    res8_l = {k: v.cpu().numpy() for k, v in res8_l.items()}
    lg8_l = lg8_l.cpu().numpy()
    if not (np.isfinite(lg8_l).all() and lg8_l.shape == (B_SCAN, SCAN // 4, SCAN // 4, 17)):
        raise AssertionError("int8 large scans: logits not finite or of the wrong shape")
    t0 = time.perf_counter()
    ref8_l, ref_lg8_l = detect_program_batch(params, scans[:n_cmp], cfg_l, (SCAN, SCAN), qparams=q_h,
                                             fused=True, device="cpu")
    t_cpu8_l = time.perf_counter() - t0
    if not np.array_equal(lg8_l[:n_cmp], ref_lg8_l.numpy()):
        raise AssertionError("int8 large scans: logits differ from the host CPU's")
    skipped8_l = compare_detections({k: v[:n_cmp] for k, v in res8_l.items()},
                                    {k: v.numpy() for k, v in ref8_l.items()}, lg8_l[:n_cmp, ..., 0],
                                    box_atol=4e-4, score_atol=1e-5, margin=0.0)
    if int(res8_l["num_detections"][:n_cmp].sum()) == 0:
        raise AssertionError("int8 large scans: no detection compared with the host CPU")
    log(f"int8 large scans: B={B_SCAN} {SCAN}x{SCAN} uint8 K={K_l} M={M_l}, launches {n_large8}; "
        f"{int(res8_l['num_detections'].sum())} detections; the first {n_cmp} == the host CPU "
        f"({t_cpu8_l:.1f} s): logits bit for bit, detections identical ({skipped8_l[1]} near-tie "
        "class ids left out)")

    # --- 3o. int8 BarcodeDetector.detect (detect_program_int8) and the QVGA stream ---
    phase("int8 detect and stream")
    det8_d = BarcodeDetector(cfg, params, qparams=q_d, device="cuda")
    det8_ld = BarcodeDetector(cfg_l, params, qparams=q_d, device="cuda")
    detect8 = {}
    for name, c8, dd, img in (("512x512", cfg, det8_d, imgs[0]), ("640x480", cfg_l, det8_ld, photos[0])):
        out_hw = c8.grid_size(*img.shape[:2])
        must = [*trunk8, "ccl", "slots", "rect_exact"]
        must_not = ["context_layer", "rect_compact", "geometry_compat", *calib8, *tiled, *bf16]
        (res_1, lg_1), _ = counted(
            lambda: detect_program_int8(q_d, img, c8, out_hw, device="cuda"), must, must_not)
        dets, n_8 = counted(lambda: dd.detect(img), must, must_not)
        trunk_launches(n_8, 1, f"int8 detect {name}")
        ref_1, ref_lg_1 = detect_program_int8(q_h, img, c8, out_hw, device="cpu")
        if not torch.equal(lg_1.cpu(), ref_lg_1):
            raise AssertionError(f"int8 detect {name}: logits differ from the host CPU's")
        compare_detections({k: v.cpu().numpy()[None] for k, v in res_1.items()},
                           {k: v.numpy()[None] for k, v in ref_1.items()},
                           ref_lg_1.numpy()[None, ..., 0], box_atol=4e-4, score_atol=1e-5, margin=0.0)
        ref_dets = BarcodeDetector(c8, params, qparams=q_h, device="cpu").detect(img)
        if not dets or len(dets) != len(ref_dets):
            raise AssertionError(f"int8 detect {name}: {len(dets)} detections, {len(ref_dets)} on the "
                                 "host CPU")
        for o, r in zip(dets, ref_dets):
            if (o.class_id, o.area) != (r.class_id, r.area) or abs(o.score - r.score) > 1e-5:
                raise AssertionError(f"int8 detect {name}: a detection differs from the host CPU's")
            if not same_corner_sets(o.box, r.box, 4e-4):
                raise AssertionError(f"int8 detect {name}: a box differs from the host CPU's")
        detect8[name] = {"launches": n_8, "detections": len(dets)}
    log(f"int8 detect: {detect8}; logits bit for bit and detections == the host CPU's")
    stream8 = StreamingDetector(cfg_q, params, QVGA, batch_size=B, qparams=q_d, device="cuda")
    got8, n_stream8 = counted(
        lambda: list(stream8.process(iter(frames))), [*trunk8, "ccl", "slots", "rect_exact"],
        ["context_layer", "rect_compact", "geometry_compat", *calib8, *tiled, *bf16])
    trunk_launches(n_stream8, N_FRAMES // B, "int8 stream")
    res_s8 = {k: np.stack([d[k] for _, d in got8]) for k in got8[0][1]}
    ref_s8, lg_s8 = {}, []
    for b0 in range(0, N_FRAMES, B):
        r, lg = detect_program_batch(params, frames[b0:b0 + B], cfg_q, QVGA, qparams=q_h, fused=True, device="cpu")
        for k, v in r.items():
            ref_s8.setdefault(k, []).append(v.numpy())
        lg_s8.append(lg[..., 0].numpy())
    ref_s8 = {k: np.concatenate(v) for k, v in ref_s8.items()}
    if int(res_s8["num_detections"].sum()) == 0:
        raise AssertionError("int8 stream: no valid detection")
    skipped_s8 = compare_detections(res_s8, ref_s8, np.concatenate(lg_s8), box_atol=4e-4,
                                    score_atol=1e-5)
    log(f"int8 stream: {N_FRAMES} frames {QVGA[0]}x{QVGA[1]} uint8, batch {B}, launches "
        f"{n_stream8}; {int(res_s8['num_detections'].sum())} detections == the host CPU, "
        f"{skipped_s8[0]} frames (a det logit within 1e-4 of the threshold) and {skipped_s8[1]} "
        "near-tie class ids left out")

    # --- 3p. the CLI's calibration (detect --int8) on the card and on the host CPU ---
    phase("int8 CLI calibration")
    cli_imgs = [imgs[i] for i in range(4)]
    qc_d, _ = counted(lambda: calibrate_qparams(params, cfg, cli_imgs, "cuda"), calib8, trunk8)
    cli_diff = qparams_diff(qc_d, calibrate_qparams(params, cfg, cli_imgs, "cpu"))
    check_qparams(cli_diff, "calibrate_qparams")
    log(f"int8 CLI calibration: calibrate_qparams on 4 {IMG}x{IMG} scenes, card against host CPU: "
        f"{cli_diff}")

    # --- 4. timing ---
    phase("timing")
    with torch.inference_mode(), exact_f32():
        def run_path(images=imgs_d):
            return detect_program_batch(
                params_d, images, cfg, (IMG, IMG), detections_only=True, device="cuda")

        ms_path = time_ms(run_path)
        ms_path_host = time_ms(lambda: run_path(imgs))
        prof = profile_path(run_path, ms_path)
        Bm, C, H, W = xc.shape
        O = w[3].shape[0]
        lg_main = ctx_k.permute(0, 2, 3, 1)  # the head's NHWC view
        det = ctx_k[:, 0].contiguous()
        lab_main = ccl_kernel.ccl_labels_from_logits(det)
        geo = postproc_kernel.component_slots(lg_main, lab_main, K)
        minx, maxx = geo["minx"], geo["maxx"]
        # class logits of the pixels in a slot: the rest need none
        in_slot = int((geo["slots"] < K).sum())
        stats_bytes = in_slot * (O - 1) * 4 + Bm * K * (O + 1) * 4
        stats_ops = in_slot * O * 8  # sigmoid, max, exp, divide and the sums

        def library_context():
            return library_chain(xc, w, dil)

        err_lib = float((library_context() - ctx_p).abs().max())
        if not err_lib <= 1e-4:
            raise AssertionError(f"library context differs from the plain version: {err_lib}")
        px = Bm * H * W
        # rect work this data needs: per component, valid edge directions x
        # packed points x 10 flops (4 mul, 2 add, 4 min/max)
        Nc = minx.shape[0] * K
        rowv = (maxx >= 0).reshape(Nc, H)
        n_pts = torch.zeros(Nc, dtype=torch.int64, device=dev)
        n_dirs = torch.zeros_like(n_pts)
        for v_, s_ in ((minx, 1), (maxx, -1)):
            alive = rect_kernel._convexify(v_.reshape(Nc, H).long(), rowv, s_)
            n = alive.sum(1).clamp(max=M)
            n_pts += n
            n_dirs += (n - 1).clamp(min=0)
        rect_flops = float((n_dirs * n_pts).sum()) * 10
        # uncompacted rect work: the directions it projects x 2 points per
        # valid row x 10
        Bq, _, Hq = minx_q.shape
        Nq = Bq * K
        rows_q = (maxx_q >= 0).reshape(Nq, Hq).sum(1).cpu().numpy()
        exact_flops = float((exact_directions(minx_q, maxx_q) * 2 * rows_q).sum()) * 10
        ms_pair = time_ms(lambda: postproc_kernel.component_slots(
            lg_main, ccl_kernel.ccl_labels_from_logits(det), K))
        dev_pair = device_ms(lambda: postproc_kernel.component_slots(
            lg_main, ccl_kernel.ccl_labels_from_logits(det), K))
        minx_1, maxx_1 = minx[:1].contiguous(), maxx[:1].contiguous()  # a detect call's
        kernels = [
            dict(
                name="context_layer", route="cuda",
                source="ubdvss_tpu_torch/csrc/context_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/context_kernel.py:39",
                launches=launches["context_layer"], max_abs_err=err_ctx,
                ms=time_ms(lambda: context_kernel.fused_context_head(xc, *w, dil)),
                device_ms=device_ms(lambda: context_kernel.fused_context_head(xc, *w, dil)),
                queued_ms=queued_ms(lambda: context_kernel.fused_context_head(xc, *w, dil)),
                plain_ms=time_ms(lambda: context_kernel.context_head_reference(xc, *w, dil)),
                library_ms=time_ms(library_context),
                bound=bound(
                    (px * C + px * O) * 4 + sum(t.numel() for t in w) * 4,
                    px * (len(dil) * (9 * C * 2 + C * C * 2 + 2 * C) + O * C * 2),
                ),
                instance=context_kernel.kernel_instance(C, O),
                plans=k4_plans(xc.shape, O, dil),
                byte_floor_ms=k4_byte_floor(xc.shape, O, len(dil), sum(t.numel() for t in w) * 4),
            ),
            dict(
                name="ccl", route="cuda", source="ubdvss_tpu_torch/csrc/ccl_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/ccl_kernel.py:116",
                launches=launches["ccl"], max_abs_err=0.0,
                ms=time_ms(lambda: ccl_kernel.ccl_labels_from_logits(det)),
                device_ms=device_ms(lambda: ccl_kernel.ccl_labels_from_logits(det)),
                plain_ms=time_ms(lambda: ccl_kernel.ccl_labels_reference(det)),
                library_ms=None,
                bound=bound(px * 8, px * 9),  # logits in, labels out; one 3x3 pass
            ),
            dict(
                name="slots", route="cuda", source="ubdvss_tpu_torch/csrc/postproc_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:130",
                launches=launches["slots"], max_abs_err=err_slots,
                ms=time_ms(lambda: postproc_kernel.component_slots(lg_main, lab_main, K)),
                device_ms=device_ms(lambda: postproc_kernel.component_slots(lg_main, lab_main, K)),
                plain_ms=time_ms(
                    lambda: postproc_kernel.component_slots_reference(lg_main, lab_main, K)),
                # the torch one-hot, sum and bmm stats that the kernel replaces
                library_ms=time_ms(
                    lambda: postproc_kernel._stats_reference(lg_main, geo["slots"], K)),
                bound=bound(px * 12 + Bm * K * (2 * H + 1) * 4 + Bm * 4 + stats_bytes,
                            px * 4 + stats_ops),
                plan=slot_plan_of(lg_main, K),
            ),
            dict(
                name="rect_compact", route="cuda", source="ubdvss_tpu_torch/csrc/rect_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/rect_kernel.py:294",
                launches=launches["rect_compact"], max_abs_err=err_rect,
                ms=time_ms(lambda: rect_kernel.min_area_rect_select(minx, maxx, M)),
                device_ms=device_ms(lambda: rect_kernel.min_area_rect_select(minx, maxx, M)),
                plain_ms=time_ms(lambda: rect_kernel.min_area_rect_select_reference(minx, maxx, M)),
                library_ms=None,
                bound=bound(Nc * H * 8 + Bm * 9 * K * 4, rect_flops),
            ),
            dict(
                name="rect_exact", route="cuda", source="ubdvss_tpu_torch/csrc/rect_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/rect_kernel.py:136",
                launches=launches["rect_exact_detect"], max_abs_err=err_exact,
                ms=time_ms(lambda: rect_kernel.min_area_rect_exact(minx_q, maxx_q)),
                device_ms=device_ms(lambda: rect_kernel.min_area_rect_exact(minx_q, maxx_q)),
                detect_ms=time_ms(lambda: rect_kernel.min_area_rect_exact(minx_1, maxx_1)),
                detect_device_ms=device_ms(
                    lambda: rect_kernel.min_area_rect_exact(minx_1, maxx_1)),
                plain_ms=time_ms(
                    lambda: rect_kernel.min_area_rect_select_reference(minx_q, maxx_q, None)),
                library_ms=None,
                bound=bound(Nq * Hq * 8 + Bq * 9 * K * 4, exact_flops),
            ),
            dict(
                name="geometry_compat", route="cuda",
                source="ubdvss_tpu_torch/csrc/geometry_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:50",
                launches=launches["geometry_compat"], max_abs_err=err_geo,
                ms=time_ms(lambda: postproc_kernel.geometry_compat(lg_main, K)),
                device_ms=device_ms(lambda: postproc_kernel.geometry_compat(lg_main, K)),
                plain_ms=time_ms(lambda: postproc_kernel.geometry_compat_reference(lg_main, K)),
                library_ms=None,
                bound=bound(px * 8 + Bm * K * (2 * H + 1) * 4 + Bm * 4 + stats_bytes,
                            px * 13 + stats_ops),
                plan=slot_plan_of(lg_main, K),
            ),
        ]
        # K2 on one detect call's heatmap, the 1024x768 photo's 192x256 map
        # at the asset's config (K=64), B=1: the widest cluster; it and K12c
        # bit for bit, there and on one image of the main path's 128² maps
        hw_d = DETECT_HW[1]
        _, lg_d1 = detect_program(params_d, photos[1], cfg_l, cfg_l.grid_size(*hw_d), device="cuda")
        lg_d1 = lg_d1[None]
        K_d = cfg_l.max_components
        lab_d1 = ccl_kernel.ccl_labels_from_logits(lg_d1[..., 0].contiguous())
        geo_d1 = postproc_kernel.component_slots(lg_d1, lab_d1, K_d)
        err_d1 = check_stats(geo_d1, postproc_kernel.component_slots_reference(lg_d1, lab_d1, K_d),
                             "slots on a detect heatmap", exact=exact_stats(lg_d1, geo_d1["slots"], K_d))
        for lg_1, k_1 in ((lg_d1, K_d), (lg_main[:1], K)):
            pair_1 = postproc_kernel.component_slots(
                lg_1, ccl_kernel.ccl_labels_from_logits(lg_1[..., 0].contiguous()), k_1)
            fused_1 = postproc_kernel.geometry_compat(lg_1, k_1)
            if not all(torch.equal(fused_1[k], pair_1[k]) for k in pair_1):
                raise AssertionError(f"B=1 {tuple(lg_1.shape)}: geometry_compat differs from "
                                     "ccl then slots")
        _, Hd, Wd, _ = lg_d1.shape
        in_d1 = int((geo_d1["slots"] < K_d).sum())
        kernels.append(dict(
            name="slots_detect", route="cuda", source="ubdvss_tpu_torch/csrc/postproc_kernel.cu",
            replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:130 (one detect call)",
            launches=detect_launches[f"{hw_d[1]}x{hw_d[0]}"]["slots"], max_abs_err=err_d1,
            ms=time_ms(lambda: postproc_kernel.component_slots(lg_d1, lab_d1, K_d)),
            device_ms=device_ms(lambda: postproc_kernel.component_slots(lg_d1, lab_d1, K_d)),
            queued_ms=queued_ms(lambda: postproc_kernel.component_slots(lg_d1, lab_d1, K_d)),
            plain_ms=time_ms(lambda: postproc_kernel.component_slots_reference(lg_d1, lab_d1, K_d),
                             iters=3, reps=1),
            library_ms=time_ms(lambda: postproc_kernel._stats_reference(lg_d1, geo_d1["slots"], K_d)),
            bound=bound(Hd * Wd * 12 + K_d * (2 * Hd + 1) * 4 + 4 + in_d1 * (O - 1) * 4
                        + K_d * (O + 1) * 4, Hd * Wd * 4 + in_d1 * O * 8),
            plan=slot_plan_of(lg_d1, K_d), shape=[1, Hd, Wd, O], K=K_d,
        ))
        # the large scans' kernels at their path's shapes: B=8 512² maps, K=64
        Bl, Hl, Wl = det_l.shape
        px_l = Bl * Hl * Wl
        lab_l = ccl_kernel.ccl_labels_tiled(det_l)
        geo_l = postproc_kernel.component_slots_tiled(lg_l, lab_l, K_l)
        in_slot_l = int((geo_l["slots"] < K_l).sum())
        kernels += [
            dict(
                name="ccl_tiled", route="cuda", source="ubdvss_tpu_torch/csrc/ccl_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/ccl_kernel.py:116",
                launches=launches["ccl_tiled"], max_abs_err=0.0,
                ms=time_ms(lambda: ccl_kernel.ccl_labels_tiled(det_l)),
                device_ms=device_ms(lambda: ccl_kernel.ccl_labels_tiled(det_l)),
                phases=phase_split(lambda: ccl_kernel.ccl_labels_tiled(det_l)),
                plain_ms=time_ms(lambda: ccl_kernel.ccl_labels_reference(det_l), iters=3, reps=1),
                library_ms=None,
                bound=bound(px_l * 8, px_l * 9),  # logits in, labels out; one 3x3 pass
            ),
            dict(
                name="slots_tiled", route="cuda",
                source="ubdvss_tpu_torch/csrc/postproc_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:130",
                launches=launches["slots_tiled"], max_abs_err=err_slots_l,
                ms=time_ms(lambda: postproc_kernel.component_slots_tiled(lg_l, lab_l, K_l)),
                device_ms=device_ms(
                    lambda: postproc_kernel.component_slots_tiled(lg_l, lab_l, K_l)),
                phases=phase_split(
                    lambda: postproc_kernel.component_slots_tiled(lg_l, lab_l, K_l)),
                plain_ms=time_ms(
                    lambda: postproc_kernel.component_slots_reference(lg_l, lab_l, K_l),
                    iters=3, reps=1),
                library_ms=time_ms(
                    lambda: postproc_kernel._stats_reference(lg_l, geo_l["slots"], K_l),
                    iters=3, reps=1),
                bound=bound(px_l * 12 + Bl * K_l * (2 * Hl + 1) * 4 + Bl * 4
                            + in_slot_l * (O - 1) * 4 + Bl * K_l * (O + 1) * 4,
                            px_l * 4 + in_slot_l * O * 8),
            ),
        ]
        # the large scans' K3 (M=64, H=512) beside the main path's row
        large_rect = {
            "rect_compact_large_ms": time_ms(
                lambda: rect_kernel.min_area_rect_compact(geo_l["minx"], geo_l["maxx"], M_l)),
            "rect_compact_large_device_ms": device_ms(
                lambda: rect_kernel.min_area_rect_compact(geo_l["minx"], geo_l["maxx"], M_l)),
            "context_layer_large_device_ms": device_ms(
                lambda: context_kernel.fused_context_head(xl, *w_l, dil_l), n=5),
        }
    # the bf16 variants at their paths' shapes, on the bf16 trunk's logits:
    # the main path's B=64 128² maps (K=16), the large scans' B=8 512² maps
    # (K=64); a logit is 2 B
    with torch.inference_mode():
        det16 = lg16_main[..., 0].contiguous()
        lab16m = ccl_kernel.ccl_labels_from_logits(det16)
        geo16 = postproc_kernel.component_slots(lg16_main, lab16m, K)
        in_slot16 = int((geo16["slots"] < K).sum())
        stats16_bytes = in_slot16 * (O - 1) * 2 + Bm * K * (O + 1) * 4
        lab_l16m = ccl_kernel.ccl_labels_tiled(det_l16)
        geo_l16 = postproc_kernel.component_slots_tiled(lg_l16, lab_l16m, K_l)
        in_slot_l16 = int((geo_l16["slots"] < K_l).sum())
        kernels += [
            dict(
                name="ccl_bf16", route="cuda", source="ubdvss_tpu_torch/csrc/ccl_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/ccl_kernel.py:116",
                launches=launches["ccl_bf16"], max_abs_err=0.0,
                ms=time_ms(lambda: ccl_kernel.ccl_labels_from_logits(det16)),
                device_ms=device_ms(lambda: ccl_kernel.ccl_labels_from_logits(det16)),
                plain_ms=time_ms(lambda: ccl_kernel.ccl_labels_reference(det16)),
                library_ms=None,
                bound=bound(px * 6, px * 9),  # bf16 logits in, labels out
            ),
            dict(
                name="ccl_tiled_bf16", route="cuda", source="ubdvss_tpu_torch/csrc/ccl_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/ccl_kernel.py:116",
                launches=launches["ccl_tiled_bf16"], max_abs_err=0.0,
                ms=time_ms(lambda: ccl_kernel.ccl_labels_tiled(det_l16)),
                device_ms=device_ms(lambda: ccl_kernel.ccl_labels_tiled(det_l16)),
                phases=phase_split(lambda: ccl_kernel.ccl_labels_tiled(det_l16)),
                plain_ms=time_ms(lambda: ccl_kernel.ccl_labels_reference(det_l16), iters=3, reps=1),
                library_ms=None,
                bound=bound(px_l * 6, px_l * 9),
            ),
            dict(
                name="slots_bf16", route="cuda", source="ubdvss_tpu_torch/csrc/postproc_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:130",
                launches=launches["slots_bf16"], max_abs_err=err_slots16,
                ms=time_ms(lambda: postproc_kernel.component_slots(lg16_main, lab16m, K)),
                device_ms=device_ms(lambda: postproc_kernel.component_slots(lg16_main, lab16m, K)),
                plain_ms=time_ms(
                    lambda: postproc_kernel.component_slots_reference(lg16_main, lab16m, K)),
                # the torch one-hot stats on the bf16 logits
                library_ms=time_ms(
                    lambda: postproc_kernel._stats_reference(lg16_main, geo16["slots"], K)),
                bound=bound(px * 10 + Bm * K * (2 * H + 1) * 4 + Bm * 4 + stats16_bytes,
                            px * 4 + in_slot16 * O * 8),
                plan=slot_plan_of(lg16_main, K),
            ),
            dict(
                name="slots_tiled_bf16", route="cuda",
                source="ubdvss_tpu_torch/csrc/postproc_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:130",
                launches=launches["slots_tiled_bf16"], max_abs_err=err_slots_l16,
                ms=time_ms(lambda: postproc_kernel.component_slots_tiled(lg_l16, lab_l16m, K_l)),
                device_ms=device_ms(
                    lambda: postproc_kernel.component_slots_tiled(lg_l16, lab_l16m, K_l)),
                phases=phase_split(
                    lambda: postproc_kernel.component_slots_tiled(lg_l16, lab_l16m, K_l)),
                plain_ms=time_ms(
                    lambda: postproc_kernel.component_slots_reference(lg_l16, lab_l16m, K_l),
                    iters=3, reps=1),
                library_ms=time_ms(
                    lambda: postproc_kernel._stats_reference(lg_l16, geo_l16["slots"], K_l),
                    iters=3, reps=1),
                bound=bound(px_l * 10 + Bl * K_l * (2 * Hl + 1) * 4 + Bl * 4
                            + in_slot_l16 * (O - 1) * 2 + Bl * K_l * (O + 1) * 4,
                            px_l * 4 + in_slot_l16 * O * 8),
            ),
            dict(
                name="geometry_compat_bf16", route="cuda",
                source="ubdvss_tpu_torch/csrc/geometry_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:50",
                launches=launches["geometry_compat_bf16"], max_abs_err=err_geo16,
                ms=time_ms(lambda: postproc_kernel.geometry_compat(lg16_main, K)),
                device_ms=device_ms(lambda: postproc_kernel.geometry_compat(lg16_main, K)),
                plain_ms=time_ms(lambda: postproc_kernel.geometry_compat_reference(lg16_main, K)),
                library_ms=None,
                bound=bound(px * 6 + Bm * K * (2 * H + 1) * 4 + Bm * 4 + stats16_bytes,
                            px * 13 + in_slot16 * O * 8),
                plan=slot_plan_of(lg16_main, K),
            ),
        ]
    # the tall pages' K3x (B=1, K=64: H=1754 in one block, H=2048 the tall
    # instance) and the large K12c on the scans' B=8 512² maps, K=64
    with torch.inference_mode():
        for tag, pg in pages.items():
            mn_t, mx_t = pg["minx"], pg["maxx"]
            Bt, Kt, Ht = mn_t.shape
            rows_t = (mx_t >= 0).reshape(Bt * Kt, Ht).sum(1).cpu().numpy()
            flops_t = float((exact_directions(mn_t, mx_t) * 2 * rows_t).sum()) * 10
            bytes_t = Bt * Kt * Ht * 8 + Bt * 9 * Kt * 4
            kernels.append(dict(
                name=f"rect_exact_{tag}", route="cuda", source="ubdvss_tpu_torch/csrc/rect_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/rect_kernel.py:136",
                launches=pg["launches"], max_abs_err=err_exact,
                ms=time_ms(lambda: rect_kernel.min_area_rect_exact(mn_t, mx_t)),
                device_ms=device_ms(lambda: rect_kernel.min_area_rect_exact(mn_t, mx_t)),
                plain_ms=time_ms(lambda: rect_kernel.min_area_rect_select_reference(mn_t, mx_t, None),
                                 iters=3, reps=1),
                library_ms=None,
                bound=bound(bytes_t, flops_t),
                bound_bytes_ms=bound(bytes_t, 0)[0], bound_ops_ms=bound(0, flops_t)[0],
            ))
        for tag, lg_, err_ in (("", lg_l, err_slots_l), ("_bf16", lg_l16, err_slots_l16)):
            lab_ = ccl_kernel.ccl_labels_tiled(lg_[..., 0].contiguous())
            in_slot_ = int((postproc_kernel.component_slots_tiled(lg_, lab_, K_l)["slots"] < K_l).sum())
            esz = lg_.element_size()
            kernels.append(dict(
                name=f"geometry_compat_large{tag}", route="cuda",
                source="ubdvss_tpu_torch/csrc/geometry_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:50",
                launches=launches.get(f"geometry_compat_large{tag}", 0), max_abs_err=err_,
                ms=time_ms(lambda: postproc_kernel.geometry_compat(lg_, K_l)),
                device_ms=device_ms(lambda: postproc_kernel.geometry_compat(lg_, K_l)),
                phases=phase_split(lambda: postproc_kernel.geometry_compat(lg_, K_l)),
                plain_ms=time_ms(lambda: postproc_kernel.geometry_compat_reference(lg_, K_l),
                                 iters=3, reps=1),
                library_ms=None,
                bound=bound(px_l * (esz + 4) + Bl * K_l * (2 * Hl + 1) * 4 + Bl * 4
                            + in_slot_ * (O - 1) * esz + Bl * K_l * (O + 1) * 4,
                            px_l * 13 + in_slot_ * O * 8),
            ))
        # each launch of the tiled kernels at the scans' maps: device ms, grid
        for row in kernels:
            for phase_name, ph in row.get("phases", {}).items():
                warps = ph["resident_warps_per_sm"]
                log(f"tiled phase {row['name']}: {phase_name} {ph['ms']:.4f} ms device, grid "
                    f"{ph['grid']} x block {ph['block']}, resident warps/SM "
                    f"{'n/a' if warps is None else f'{warps:.1f}'}")
        # K3x on the kernel checks' synthetic extremes (K=16, a staircase over
        # every row) at each tall height, one block to the cap, then the tall
        # instance
        tall_rect = {}
        for make, H, b in tall_cases:
            mn_s, mx_s = (t.to(dev) for t in make(b, 16, H, H + b))
            what = "staircase" if make is synthetic_extremes else "round"
            tall_rect[f"{what} B={b} H={H}"] = {
                "ms": time_ms(lambda: rect_kernel.min_area_rect_exact(mn_s, mx_s)),
                "device_ms": device_ms(lambda: rect_kernel.min_area_rect_exact(mn_s, mx_s)),
            }
        # one A4-page detect call and one compat batch of the 2048² scans:
        # wall time, device time and busy share
        a4 = pages[f"h{A4_PAGE[0] // cfg_page.scale}"]
        run_a4 = lambda: a4["det"].detect(a4["page"])  # noqa: E731
        ms_a4 = time_ms(run_a4, iters=3, reps=1, warmup=1)
        prof_a4 = profile_path(run_a4, ms_a4, iters=2)
        run_cl = lambda: with_compat(compat_runs["2048² scans f32"][0])  # noqa: E731
        ms_cl = time_ms(run_cl, iters=5, reps=3)
        prof_cl = profile_path(run_cl, ms_cl)
    log(json.dumps({"rect_exact on synthetic extremes, K=16, a staircase or a convex blob over "
                    "every row": tall_rect}))
    log(json.dumps({
        "path": "BarcodeDetector.detect, one A4 page at 600 dpi (7016x4960 uint8 host image)",
        "K": K_l, "M": M_l, "ms_per_page": ms_a4, "device_busy_ms": prof_a4["device_busy_ms"],
        "busy_share": prof_a4["busy_share"], "plain_cpu_s": a4["cpu_s"],
        "profile_ms": prof_a4["profile_ms_per_batch"],
    }))
    log(json.dumps({
        "path": "detect_program_batch f32 with UBDVSS_PALLAS_COMPAT=1, B=8 2048x2048 scans",
        "ms_per_batch": ms_cl, "device_busy_ms": prof_cl["device_busy_ms"],
        "busy_share": prof_cl["busy_share"], "profile_ms": prof_cl["profile_ms_per_batch"],
    }))
    for kd in kernels:
        kd["bound_ms"], kd["bound_by"] = kd.pop("bound")
        log(f"time {kd['name']}: {kd['ms']:.4f} ms/call, device {kd['device_ms']:.4f} (plain "
            f"{kd['plain_ms']:.4f}, library {kd['library_ms']}, bound {kd['bound_ms']:.4f} by "
            f"{kd['bound_by']})")
        if "plan" in kd:
            log(f"time {kd['name']}: slot plan {kd['plan']}"
                + (f", queued device {kd['queued_ms']:.4f} ms" if "queued_ms" in kd else ""))
        if kd["name"] == "context_layer":
            log(f"time context_layer (main path, {tuple(xc.shape)}): {kd['instance']} instance, "
                f"[P, rows, threads, blocks] by layer {kd['plans']}; device {kd['device_ms']:.4f} "
                f"ms, queued {kd['queued_ms']:.4f}, operation bound {kd['bound_ms']:.4f}, "
                f"one-launch-a-layer byte floor {kd['byte_floor_ms']:.4f}, cuDNN's chain "
                f"{kd['library_ms']:.4f}")
    with torch.inference_mode():
        ms_detect = time_ms(lambda: det_d.detect(imgs[0]), iters=10, reps=3)
        dev_detect = device_ms(lambda: det_d.detect(imgs[0]), n=10)
    log(json.dumps({
        "path": "BarcodeDetector.detect, one 512x512 uint8 host image", "K": K,
        "ms_per_image": ms_detect, "device_ms_per_image": dev_detect,
        "rect_exact_launches_per_call": n_detect2["rect_exact"],
    }))
    def run_stream():
        return list(stream.process(iter(frames)))

    ms_stream = time_ms(run_stream, iters=3, reps=1, warmup=1)
    log(json.dumps({
        "path": "StreamingDetector QVGA, uint8 host frames", "frames": N_FRAMES,
        "frame_hw": list(QVGA), "batch": B, "K": K, "M": cfg_q.max_hull_points,
        "ms_per_stream": ms_stream, "frames_per_s": N_FRAMES / ms_stream * 1e3,
        "plain_cpu_s": t_cpu_s,
    }))
    log(json.dumps({"stream_profile (per 256 frames)": profile_path(run_stream, ms_stream, 2)}))
    by_name = {kd["name"]: kd for kd in kernels}
    log(json.dumps({
        "fused_geometry_vs_pair": "B=64 128x128 main-path maps, K=16",
        "geometry_compat_ms": by_name["geometry_compat"]["ms"], "ccl_plus_slots_ms": ms_pair,
        "geometry_compat_device_ms": by_name["geometry_compat"]["device_ms"],
        "ccl_plus_slots_device_ms": dev_pair,
    }))
    log(json.dumps({
        "path": "detect_program_batch fused f32, uint8 images on the card",
        "batch": B, "image": IMG, "K": K, "M": M, "ms_per_batch": ms_path,
        "img_per_s": B / ms_path * 1e3,
        "ms_per_batch_host_images": ms_path_host,
        "img_per_s_host_images": B / ms_path_host * 1e3, "plain_cpu_s": t_cpu,
    }))
    log(json.dumps(prof))

    # the large scans, the 4096² scan and the detect calls at three sizes
    phase("timing of the large scans and the detect sizes")
    with torch.inference_mode():
        scans_d = torch.from_numpy(scans).to(dev)
        big_d = torch.from_numpy(big).to(dev)

        def run_large(images=scans_d):
            return detect_program_batch(params_d, images, cfg_l, (SCAN, SCAN),
                                        detections_only=True, n_strips=1, device="cuda")

        ms_large = time_ms(run_large, iters=5, reps=3)
        ms_large_host = time_ms(lambda: run_large(scans), iters=5, reps=3)
        prof_large = profile_path(run_large, ms_large)
        def run_big():
            return detect_program_batch(params_d, big_d, cfg_l, (BIG_SCAN, BIG_SCAN),
                                        detections_only=True, n_strips=1, device="cuda")

        ms_big = time_ms(run_big, iters=5, reps=2)
        dev_big = device_ms(run_big, n=5)
        detect_ms = {}
        for hw, img in zip(DETECT_HW, photos):
            detect_ms[f"{hw[1]}x{hw[0]}"] = {
                "ms_per_image": time_ms(lambda: det_l_d.detect(img), iters=5, reps=3),
                "device_ms_per_image": device_ms(lambda: det_l_d.detect(img), n=5),
                "launches": detect_launches[f"{hw[1]}x{hw[0]}"],
            }
    log(json.dumps({
        "path": "detect_program_batch fused f32, 2048x2048 uint8 scans on the card",
        "batch": B_SCAN, "image": SCAN, "K": K_l, "M": M_l, "ms_per_batch": ms_large,
        "scans_per_s": B_SCAN / ms_large * 1e3, "ms_per_batch_host_images": ms_large_host,
        "scans_per_s_host_images": B_SCAN / ms_large_host * 1e3,
        "plain_cpu_s_first_2": t_cpu_l, "launches": n_large, **large_rect,
    }))
    log(json.dumps({"large_scan_profile": prof_large}))
    log(json.dumps({
        "path": "detect_program_batch fused f32, one 4096x4096 uint8 scan on the card",
        "ms_per_scan": ms_big, "device_ms_per_scan": dev_big, "launches": n_big,
        "plain_cpu_s": t_cpu_b,
    }))
    log(json.dumps({"path": "BarcodeDetector.detect, one host image, the asset's config",
                    "K": K_l, "sizes": detect_ms}))

    # the bf16 paths: the main path, the large scans, the stream, a detect call
    phase("bf16 timing")
    with torch.inference_mode():
        def run16(images=imgs_d):
            return detect_program_batch(params16_d, images, cfg16, (IMG, IMG),
                                        detections_only=True, device="cuda")

        def run_l16(images=scans_d):
            return detect_program_batch(params16_d, images, cfg_l16, (SCAN, SCAN),
                                        detections_only=True, n_strips=1, device="cuda")

        def run_stream16():
            return list(stream16.process(iter(frames)))

        ms16 = time_ms(run16)
        ms16_host = time_ms(lambda: run16(imgs))
        prof16 = profile_path(run16, ms16)
        ms_l16 = time_ms(run_l16, iters=5, reps=3)
        prof_l16 = profile_path(run_l16, ms_l16)
        ms_stream16 = time_ms(run_stream16, iters=3, reps=1, warmup=1)
        prof_s16 = profile_path(run_stream16, ms_stream16, 2)
        ms_detect16 = time_ms(lambda: det16_d.detect(imgs[0]), iters=10, reps=3)
        dev_detect16 = device_ms(lambda: det16_d.detect(imgs[0]), n=10)
    log(json.dumps({
        "path": "detect_program_batch fused bf16, uint8 images on the card",
        "batch": B, "image": IMG, "K": K, "M": M, "ms_per_batch": ms16,
        "img_per_s": B / ms16 * 1e3, "ms_per_batch_host_images": ms16_host,
        "img_per_s_host_images": B / ms16_host * 1e3, "plain_cpu_s": t_cpu16,
        "scenes_agreeing_with_f32": agree16, "launches": n_main16,
    }))
    log(json.dumps({"bf16_profile": prof16}))
    log(json.dumps({
        "path": "detect_program_batch fused bf16, 2048x2048 uint8 scans on the card",
        "batch": B_SCAN, "image": SCAN, "K": K_l, "M": M_l, "ms_per_batch": ms_l16,
        "scans_per_s": B_SCAN / ms_l16 * 1e3, "launches": n_large16,
    }))
    log(json.dumps({"bf16_large_scan_profile": prof_l16}))
    log(json.dumps({
        "path": "StreamingDetector QVGA bf16, uint8 host frames", "frames": N_FRAMES,
        "ms_per_stream": ms_stream16, "frames_per_s": N_FRAMES / ms_stream16 * 1e3,
        "device_busy_ms": prof_s16["device_busy_ms"], "busy_share": prof_s16["busy_share"],
    }))
    log(json.dumps({"path": "BarcodeDetector.detect bf16, one 512x512 uint8 host image",
                    "ms_per_image": ms_detect16, "device_ms_per_image": dev_detect16}))

    # the int8 paths, and qconv layer by layer at the main path's shapes
    phase("int8 timing")
    with torch.inference_mode():
        def run8(images=imgs_d):
            return detect_program_batch(params_d, images, cfg, (IMG, IMG), qparams=q_d,
                                        detections_only=True, device="cuda")

        def run8_l(images=scans_d):
            return detect_program_batch(params_d, images, cfg_l, (SCAN, SCAN), qparams=q_d,
                                        detections_only=True, device="cuda")

        def run_stream8():
            return list(stream8.process(iter(frames)))

        ms8 = time_ms(run8)
        ms8_host = time_ms(lambda: run8(imgs))
        prof8 = profile_path(run8, ms8, no_convs=True)
        ms8_l = time_ms(run8_l, iters=5, reps=3)
        prof8_l = profile_path(run8_l, ms8_l, no_convs=True)
        ms_stream8 = time_ms(run_stream8, iters=3, reps=1, warmup=1)
        prof_s8 = profile_path(run_stream8, ms_stream8, 2, no_convs=True)
        ms_detect8 = time_ms(lambda: det8_d.detect(imgs[0]), iters=10, reps=3)
        dev_detect8 = device_ms(lambda: det8_d.detect(imgs[0]), n=10)

        # the trunk's eight launches at the main path's shapes (the inputs of
        # the checked chain): each kernel, its plain version (f64 convs,
        # cuDNN off), one f32 F.conv2d a layer on the int8 values as floats
        # (TF32 off; the library yardstick: no PyTorch call computes the int8
        # conv itself) and, time only, a channels-last bf16 F.conv2d a layer
        # of the same shapes (a tensor-core yardstick of another function)
        F_ = torch.nn.functional
        L8, s8 = q_d["layers"], q_d["s_in"]
        n8 = len(dil)

        def lib_convs(convs, dtype):
            """One F.conv2d a layer, NCHW f32 or channels-last bf16."""
            prepared = []
            for x, q, st, d in convs:
                xf = (x[:, None] if x.ndim == 3 else x.permute(0, 3, 1, 2)).to(dtype)
                wf = q.permute(3, 2, 0, 1).to(dtype)
                if dtype == torch.bfloat16:
                    xf, wf = (t.contiguous(memory_format=torch.channels_last) for t in (xf, wf))
                else:
                    xf, wf = xf.contiguous(), wf.contiguous()
                prepared.append((xf, wf, st, d if q.shape[0] == 3 else 0, d))
            return lambda: [F_.conv2d(xf, wf, None, st, pad, d) for xf, wf, st, pad, d in prepared]

        launches8 = []  # (kind, label, kernel call, plain call, the layer convs, input, output)
        x0 = ins8[0]
        l0_out = kq.qconv_reference(x0, L8[0], s8[1], 2, 1, raw_gray=True)
        launches8.append(("qstem", "layers 0-1", lambda: kq.qstem(x0, L8[0], s8[1], L8[1], s8[2], True),
                          lambda: kq.qstem_reference(x0, L8[0], s8[1], L8[1], s8[2], True),
                          [(x0.float(), L8[0]["q"], 2, 1), (l0_out, L8[1]["q"], 2, 1)]))
        for li, d in enumerate(dil[:-1]):
            xi, Li, si = ins8[1 + li], L8[2 + li], s8[3 + li]
            launches8.append(("qconv", f"context {li} (d={d})",
                              lambda xi=xi, Li=Li, si=si, d=d: kq.qconv(xi, Li, si, d),
                              lambda xi=xi, Li=Li, si=si, d=d: kq.qconv_reference(xi, Li, si, 1, d),
                              [(xi, Li["q"], 1, d)]))
        xl, Ll, sl, dl = ins8[n8], L8[1 + n8], s8[2 + n8], dil[-1]
        last_out = kq.qconv_reference(xl, Ll, sl, 1, dl)
        launches8.append(("qconv_head", f"context {n8 - 1} (d={dl}) + head",
                          lambda: kq.qconv_head(xl, Ll, sl, dl, q_d["head"]),
                          lambda: kq.qconv_head_reference(xl, Ll, sl, dl, q_d["head"]),
                          [(xl, Ll["q"], 1, dl), (last_out, q_d["head"]["q"], 1, 1)]))
        rows8 = []
        for kind8, label, kern, plain, convs in launches8:
            out = kern()
            x = convs[0][0] if kind8 != "qstem" else x0
            weights = sum(c[1].numel() for c in convs)
            nbytes = x.numel() * x.element_size() + out.numel() * out.element_size() + weights
            ops = 0
            for xc, qc, st, _ in convs:
                ks, _, cin, cout = qc.shape
                h, w = (xc.shape[1], xc.shape[2])
                ops += 2 * xc.shape[0] * -(-h // st) * -(-w // st) * cout * cin * ks * ks
            with exact_f32():
                lib_ms = time_ms(lib_convs(convs, torch.float32), iters=5, reps=5)
            row = dict(kernel=kind8, launch=label, input=list(x.shape),
                       input_dtype=str(x.dtype).split(".")[-1], output=list(out.shape),
                       ms=time_ms(kern), device_ms=device_ms(kern), bound=bound(nbytes, ops, INT8_OPS),
                       plain_ms=time_ms(plain, iters=3, reps=1, warmup=1), library_ms=lib_ms,
                       bf16_conv_ms=time_ms(lib_convs(convs, torch.bfloat16), iters=5, reps=5))
            row["bound_ms"], row["bound_by"] = row.pop("bound")
            rows8.append(row)
        kinds8 = {}
        for kind8 in trunk8:
            rs = [r for r in rows8 if r["kernel"] == kind8]
            kinds8[kind8] = {key: sum(r[key] for r in rs) for key in (
                "ms", "device_ms", "bound_ms", "plain_ms", "library_ms", "bf16_conv_ms")}
            kinds8[kind8].update(launches=launches[kind8], bound_by="bytes" if all(
                r["bound_by"] == "bytes" for r in rs) else "operations")
            src = "qstem_kernel.cu" if kind8 == "qstem" else "qconv_kernel.cu"
            kernels.append(dict(
                name=kind8, route="cuda", source=f"ubdvss_tpu_torch/csrc/{src}",
                replaces="ubdvss_tpu/ops/quant.py:315" if kind8 == "qstem" else "ubdvss_tpu/ops/quant.py:276",
                launches=launches[kind8], max_abs_err=err_q,
                **{k: kinds8[kind8][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            ))
        trunk8_fn = lambda: int8_trunk_apply(q_d, imgs_d, cfg, raw_gray=True)  # noqa: E731
        trunk8_ms, trunk8_dev = time_ms(trunk8_fn), device_ms(trunk8_fn)

        # the bias correction's launches over the calibration images: one
        # qconv_layer_f32 a layer and the head, one requantize a layer.  The
        # qconv_layer and qrequant rows each time, bound and compare their
        # own launches alone; the walk's entry (logged, not a kernel row)
        # takes all of them
        plain_of = {kq.qconv_layer_f32: lambda x, L, st, d, with_acc=True: (
                        kq.qconv_reference(x, L, None, st, d),
                        kq.qconv_acc_reference(x, L, st, d) if with_acc else None),
                    kq.requantize: kq.requantize_reference}
        conv_calls = [c for c in calls_bias if c[1] is kq.qconv_layer_f32]
        req_calls = [c for c in calls_bias if c[1] is kq.requantize]

        def run(calls, plain=False):
            return lambda: [(plain_of[fn] if plain else fn)(*a) for _, fn, a in calls]

        conv_bytes = req_bytes = ops_b = nbytes_old = 0
        for _, fn, a in calls_bias:
            if fn is kq.requantize:
                req_bytes += a[0].numel() * 5  # the f32 accumulators in, int8 out
                continue
            xc, Lc, st, d = a[:4]
            with_acc = len(a) < 5 or a[4]
            ks, _, cin, cout = Lc["q"].shape
            ho, wo = -(-xc.shape[1] // st), -(-xc.shape[2] // st)
            n_out = xc.shape[0] * ho * wo * cout
            n_in = xc.numel() * xc.element_size() + Lc["q"].numel()
            conv_bytes += n_in + n_out * (8 if with_acc else 4)
            # the dp4a walk it replaced: the layer twice (f32 out, then int8
            # out), the head once
            nbytes_old += n_in + 4 * n_out + (n_in + n_out if with_acc else 0)
            ops_b += 2 * n_out * cin * ks * ks

        def timed(calls, nbytes, ops):
            r = dict(ms=time_ms(run(calls), iters=5, reps=3), device_ms=device_ms(run(calls), n=5),
                     plain_ms=time_ms(run(calls, plain=True), iters=3, reps=1, warmup=1))
            r["bound_ms"], r["bound_by"] = bound(nbytes, ops, INT8_OPS)
            return r

        conv_row, req_row = timed(conv_calls, conv_bytes, ops_b), timed(req_calls, req_bytes, 0)
        with exact_f32():
            conv_row["library_ms"] = time_ms(lib_convs([(a[0], a[1]["q"], a[2], a[3])
                                                        for _, _, a in conv_calls], torch.float32),
                                             iters=3, reps=3)
        bias_row = dict(launches=len(calls_bias), **timed(calls_bias, conv_bytes + req_bytes, ops_b),
                        bound_ms_dp4a_walk=bound(nbytes_old, ops_b, INT8_OPS)[0],
                        per_launch_device_ms={name: device_ms(lambda fn=fn, a=a: fn(*a), n=5)
                                              for name, fn, a in calls_bias})
        kernels.append(dict(
            name="qconv_layer", route="cuda",
            source="ubdvss_tpu_torch/csrc/qconv_kernel.cu + ubdvss_tpu_torch/csrc/qstem_kernel.cu",
            replaces="ubdvss_tpu/ops/quant.py:276", max_abs_err=err_q,
            launches=launches["qconv_layer"], **conv_row,
        ))
        # no PyTorch call computes the requantization in one launch
        kernels.append(dict(
            name="qrequant", route="cuda", source="ubdvss_tpu_torch/csrc/qconv_kernel.cu",
            replaces="ubdvss_tpu/ops/quant.py:192", max_abs_err=0.0,
            launches=launches["qrequant"], library_ms=None, **req_row,
        ))
    log(json.dumps({f"bias correction walk (qconv_layer_f32 and requantize, {N_CALIB} {IMG}x{IMG} "
                    "calibration images, all its launches)": bias_row}))
    log(json.dumps({"int8 trunk launches (main path; plain, library f32 and bf16 per launch)": rows8}))
    log(json.dumps({"int8 trunk by kernel (main path)": kinds8, "trunk_ms": trunk8_ms,
                    "trunk_device_ms": trunk8_dev}))
    log(json.dumps({
        "path": "detect_program_batch int8, uint8 images on the card",
        "batch": B, "image": IMG, "K": K, "M": M, "ms_per_batch": ms8, "img_per_s": B / ms8 * 1e3,
        "ms_per_batch_host_images": ms8_host, "img_per_s_host_images": B / ms8_host * 1e3,
        "plain_cpu_s": t_cpu8, "launches": n_main8, "scenes_agreeing_with_f32": agree8,
        "calibration": calib_diff, "calibration_s": t_calib,
    }))
    log(json.dumps({"int8_profile": prof8}))
    log(json.dumps({
        "path": "detect_program_batch int8, 2048x2048 uint8 scans on the card",
        "batch": B_SCAN, "image": SCAN, "K": K_l, "M": M_l, "ms_per_batch": ms8_l,
        "scans_per_s": B_SCAN / ms8_l * 1e3, "launches": n_large8,
    }))
    log(json.dumps({"int8_large_scan_profile": prof8_l}))
    log(json.dumps({
        "path": "StreamingDetector QVGA int8, uint8 host frames", "frames": N_FRAMES,
        "ms_per_stream": ms_stream8, "frames_per_s": N_FRAMES / ms_stream8 * 1e3,
        "device_busy_ms": prof_s8["device_busy_ms"], "busy_share": prof_s8["busy_share"],
    }))
    log(json.dumps({"path": "BarcodeDetector.detect int8, one 512x512 uint8 host image",
                    "ms_per_image": ms_detect8, "device_ms_per_image": dev_detect8}))

    # --- 10. the large-scan packed route (run before the evaluation, where
    # every path it compares with is set up) ---
    phase("packed route")
    log(json.dumps({"packed_route": packed_route(dev, counted, kernels, params_d, params16_d, q_d,
                                                 cfg_l, cfg_l16, scans, big, lg_l, lg_l16)}))

    # --- 11. every width the JAX package serves: the wide, narrow, few and
    # mid configurations through the paths ---
    phase("every width")
    log(json.dumps({"every_width": every_width(dev, counted, kernels, imgs, scans)}))

    # --- 5. evaluation: the JAX package's int8 accuracy protocol on the card ---
    phase("evaluation")
    import dataclasses

    from ubdvss_tpu_torch import evaluate as ev_mod
    from ubdvss_tpu_torch.data import Batches, DataConfig

    cfg_e = load_net_config(asset)  # K=64, M=64: the 64x64 heatmaps take K3x
    ev_reader = SyntheticMarkupReader(n_samples=EVAL_N, image_hw=EVAL_HW)
    ev_reader.samples()  # render the scenes once; the reader keeps them
    ev_dc = DataConfig(batch_size=EVAL_BATCH, train_hw=EVAL_HW, max_polys=32)
    cal = []
    for batch in Batches(ev_reader, cfg_e, dataclasses.replace(
            ev_dc, shuffle=False, augment=None, drop_remainder=False), train=False,
            device="cuda").epoch(0):
        cal.append(batch["images"])
        if sum(c.shape[0] for c in cal) >= EVAL_CALIB:
            break
    cal_e = torch.cat(cal)[:EVAL_CALIB]
    q_e, n_qe = counted(lambda: quantize_trunk(params_d, cfg_e, cal_e), calib8, trunk8)
    calib_launches(n_qe, cfg_e, "evaluation calibration")
    ev_kernels = ["ccl", "slots", "rect_exact"]
    ev_not = ["geometry_compat", "rect_compact", *tiled, *bf16]
    n_ev_batches = -(-EVAL_N // EVAL_BATCH)

    def evaluate(dev_, qp=None, reader=ev_reader, dc=ev_dc, native=False):
        return ev_mod.run_evaluation(params_d if dev_ == "cuda" else params, reader, cfg_e, dc,
                                     native=native, qparams=qp, device=dev_)

    r32, n_e32 = counted(lambda: evaluate("cuda"), ["context_layer", *ev_kernels],
                         [*ev_not, *trunk8, *calib8])
    r8, n_e8 = counted(lambda: evaluate("cuda", q_e), [*trunk8, *ev_kernels],
                       [*ev_not, "context_layer", *calib8])
    want_launches = {"context_layer": (n_e32, len(cfg_e.dilations) * n_ev_batches),
                     "qstem": (n_e8, n_ev_batches), "qconv_head": (n_e8, n_ev_batches),
                     "qconv": (n_e8, (len(cfg_e.dilations) - 1) * n_ev_batches)}
    for name, (n, want) in want_launches.items():
        if n[name] != want:
            raise AssertionError(f"evaluation: {n[name]} {name} launches, expected {want}")
    if not r8.f1 >= EVAL_F1_MIN:
        raise AssertionError(f"evaluation: int8 F1 {r8.f1} < {EVAL_F1_MIN} (the JAX package's bar)")

    def counts(r):
        return dict(tp=r.tp, fp=r.fp, fn=r.fn, n_pred=r.n_pred, n_gt=r.n_gt, f1=r.f1,
                    per_class={n: (c["tp"], c["fp"], c["fn"]) for n, c in (r.per_class or {}).items()})

    def same_report(card, host, name):
        if counts(card) != counts(host):
            raise AssertionError(f"evaluation {name}: the card's report {counts(card)} differs from "
                                 f"the host CPU's {counts(host)}")

    q_eh = qparams_to(q_e, "cpu")
    t0 = time.perf_counter()
    r32_h = evaluate("cpu")
    t_ev_cpu = time.perf_counter() - t0
    same_report(r32, r32_h, "f32")
    same_report(r8, evaluate("cpu", q_eh), "int8")

    class _TwoSizes:  # native mode: two grids, each bucket with a padded remainder
        parts = [SyntheticMarkupReader(n_samples=5, image_hw=EVAL_HW, seed=2),
                 SyntheticMarkupReader(n_samples=3, image_hw=(192, 256), seed=3)]

        def samples(self):
            return [smp for r in self.parts for smp in r.samples()]

    dc_n = dataclasses.replace(ev_dc, batch_size=4)
    native_reports = {}
    for mode, qp, qph in (("f32", None, None), ("int8", q_e, q_eh)):
        trunk, idle = (trunk8, ["context_layer"]) if qp is not None else (["context_layer"], trunk8)
        rn, n_n = counted(lambda: evaluate("cuda", qp, _TwoSizes(), dc_n, native=True),
                          [*trunk, *ev_kernels], [*ev_not, *idle, *calib8])
        same_report(rn, evaluate("cpu", qph, _TwoSizes(), dc_n, native=True), f"native {mode}")
        native_reports[mode] = {**counts(rn), "launches": {k: n_n[k] for k in [*trunk, *ev_kernels]}}
    log(f"evaluation: {EVAL_N} synthetic {EVAL_HW[0]}x{EVAL_HW[1]} scenes, batch {EVAL_BATCH}, "
        f"int8 calibrated on the card over the first {EVAL_CALIB}: F1 f32 {r32.f1:.4f}, int8 "
        f"{r8.f1:.4f} >= {EVAL_F1_MIN} (JAX documents {EVAL_F1_JAX}); reports == the host CPU's "
        f"({t_ev_cpu:.1f} s for f32); native mode on 256x256 and 192x256 sources == the host CPU")

    # throughput and the device's busy share of run_evaluation (wall clock,
    # scenes already rendered), with the prefetch thread and without it; the
    # host matcher (evaluate_detections, after the last batch) timed alone
    matcher_ms = []
    evaluate_detections = ev_mod.evaluate_detections

    def timed_matcher(*a, **kw):
        t0 = time.perf_counter()
        out = evaluate_detections(*a, **kw)
        matcher_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    ev_timing = {}
    ev_mod.evaluate_detections = timed_matcher
    try:
        for mode, qp in (("f32", None), ("int8", q_e)):
            row = {}
            for depth in (2, 0):
                walls = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    ev_mod.run_evaluation(params_d, ev_reader, cfg_e, ev_dc, qparams=qp,
                                          prefetch_depth=depth, device="cuda")
                    walls.append((time.perf_counter() - t0) * 1e3)
                row[f"prefetch_{depth}"] = dict(walls_ms=walls, img_per_s=EVAL_N / statistics.median(
                    walls) * 1e3)
            ev_timing[mode] = dict(**row, matcher_ms=statistics.median(matcher_ms),
                                   **device_busy(lambda: evaluate("cuda", qp)))
            matcher_ms.clear()
    finally:
        ev_mod.evaluate_detections = evaluate_detections
    feed_walls = []  # the eval feed alone: Batches(train=False) on the card, synchronous
    for _ in range(3):
        t0 = time.perf_counter()
        for _batch in Batches(ev_reader, cfg_e, dataclasses.replace(
                ev_dc, shuffle=False, augment=None, drop_remainder=False), train=False,
                device="cuda").epoch(0):
            pass
        torch.cuda.synchronize()
        feed_walls.append((time.perf_counter() - t0) * 1e3)
    ev_timing["feed_ms"] = statistics.median(feed_walls)
    log(json.dumps({"evaluation": {
        "scenes": EVAL_N, "hw": list(EVAL_HW), "batch": EVAL_BATCH, "K": cfg_e.max_components,
        "M": cfg_e.max_hull_points, "jax_documented_f1": EVAL_F1_JAX,
        "f32": {**counts(r32), "precision": r32.precision, "recall": r32.recall,
                "class_accuracy": r32.class_accuracy},
        "int8": {**counts(r8), "precision": r8.precision, "recall": r8.recall,
                 "class_accuracy": r8.class_accuracy},
        "launches_f32": {k: n_e32[k] for k in ["context_layer", *ev_kernels]},
        "launches_int8": {k: n_e8[k] for k in [*trunk8, *ev_kernels]},
        "calibration_launches": {k: n_qe[k] for k in calib8}, "host_cpu_f32_s": t_ev_cpu,
        "native": native_reports, "timing": ev_timing}}))

    # --- 6. training: the gradient through K4, a train step against the host
    # CPU, the JAX package's overfit gate, resume, the CLIs, throughput ---
    phase("training")
    import shutil
    import tempfile

    from ubdvss_tpu_torch import detect as detect_mod
    from ubdvss_tpu_torch.losses import total_loss
    from ubdvss_tpu_torch.models.model import compute_precision, get_model, train_apply
    from ubdvss_tpu_torch.train import Trainer, create_train_state, train_step
    from ubdvss_tpu_torch.utils.prefetch import prefetched

    cfg_t = load_net_config(asset)  # 24 channels, dilations 1,1,2,4,8,16,1, 17 outputs
    all_kernels = list(wrappers)
    rd8 = SyntheticMarkupReader(n_samples=TRAIN_B, image_hw=(TRAIN_SMALL, TRAIN_SMALL), seed=SEED)
    dc8 = DataConfig(batch_size=TRAIN_B, train_hw=(TRAIN_SMALL, TRAIN_SMALL), seed=0)
    b8 = next(iter(Batches(rd8, cfg_t, dc8, train=True, device="cpu").epoch(0)))

    # F4: the gradient of fused_model_apply (K4 forward, the plain backward)
    # against BarcodeFCN's, TF32 off for the forward and the backward
    x8 = b8["images"].to(dev)
    r8 = torch.randn((TRAIN_B, TRAIN_SMALL // 4, TRAIN_SMALL // 4, cfg_t.n_output_channels),
                     generator=torch.Generator().manual_seed(1)).to(dev)
    leaves = {k: v.clone().requires_grad_() for k, v in params_d.items()}
    fcn = get_model(cfg_t).to(dev)
    fcn.load_state_dict(params)

    def grad_through_k4():
        with compute_precision(cfg_t):
            (fused_model_apply(leaves, x8, cfg_t) * r8).sum().backward()

    _, n_f4 = counted(grad_through_k4, ["context_layer"], [k for k in all_kernels if k != "context_layer"])
    if n_f4["context_layer"] != len(cfg_t.dilations):
        raise AssertionError(f"training F4: {n_f4['context_layer']} K4 launches, the backward launched K4")
    with compute_precision(cfg_t):
        (fcn(x8) * r8).sum().backward()
    grad_err, grad_bad = 0.0, []
    for name, p_ in fcn.named_parameters():
        diff = (leaves[name].grad - p_.grad).abs()
        grad_err = max(grad_err, float(diff.max()))
        if not bool((diff <= 1e-3 + 1e-4 * p_.grad.abs()).all()):
            grad_bad.append(name)
    if grad_bad:
        raise AssertionError(f"training F4: gradients through K4 differ from BarcodeFCN's: {grad_bad}")
    next(k for k in kernels if k["name"] == "context_layer")["grad_max_abs_err"] = grad_err
    log(f"check F4: grad of fused_model_apply (K4 forward, {n_f4['context_layer']} launches) == "
        f"BarcodeFCN's, B={TRAIN_B} {TRAIN_SMALL}², max|err| {grad_err:.3g} (atol 1e-3, rtol 1e-4)")

    # one train step on the card against the host CPU, from the asset's
    # weights, on one augmented batch built on the host (B=8 512²)
    rd_s = SyntheticMarkupReader(n_samples=TRAIN_B, image_hw=(IMG, IMG), seed=SEED)
    b_s = next(iter(Batches(rd_s, cfg_t, DataConfig(batch_size=TRAIN_B, train_hw=(IMG, IMG), seed=0),
                            train=True, device="cpu").epoch(0)))
    step_errs = {}
    # bf16 losses: each logit is a bf16 value that cuDNN's run-dependent
    # summation order can move by an ulp, so a quarter of one (1e-3)
    for dtype, p_tol, rel, g_rel, px_tol in (("float32", 2e-7, 1e-6, 1e-6, 0.0),
                                              ("bfloat16", 1e-5, 1e-3, 2e-2, 2e-3)):
        cfg_s = cfg_t.replace(dtype=dtype)
        (s_card, m_card), _ = counted(
            lambda: train_step(create_train_state(cfg_s, device=dev, params=params),
                               {k: v.to(dev) for k, v in b_s.items()}, cfg_s), [], all_kernels)
        t0 = time.perf_counter()
        s_host, m_host = train_step(create_train_state(cfg_s, device="cpu", params=params), b_s, cfg_s)
        t_host = time.perf_counter() - t0
        p_diff = torch.cat([(s_card.params[k].detach().cpu() - v.detach()).abs().ravel()
                            for k, v in s_host.params.items()])
        p_err = float(p_diff.max())
        # Adam's first step moves a parameter by about lr * sign(grad): in
        # bf16 a gradient inside the bf16 rounding noise may take the other
        # sign on the card, and its parameter lands 2 lr away
        n_flip = int((p_diff > p_tol).sum())
        errs = {"params": p_err, "params_beyond_tol": n_flip, "params_total": p_diff.numel(),
                "host_cpu_s": t_host}
        for k, v in m_host.items():
            a_, b_ = float(m_card[k]), float(v)
            tol = px_tol if k.startswith("pixel_") else (g_rel if k == "grad_norm" else rel) * abs(b_) + 1e-7
            errs[k] = abs(a_ - b_)
            if not abs(a_ - b_) <= tol:
                raise AssertionError(f"train step {dtype}: {k} {a_} on the card, {b_} on the host CPU")
        flips_ok = dtype == "bfloat16" and n_flip <= 0.01 * p_diff.numel() and p_err <= 2e-3 + 1e-6
        if not (p_err <= p_tol or flips_ok):
            raise AssertionError(f"train step {dtype}: parameters after Adam {p_err} apart, {n_flip} of "
                                 f"{p_diff.numel()} beyond {p_tol}")
        step_errs[dtype] = errs
    log(f"train step on the card == the host CPU, B={TRAIN_B} {IMG}² augmented: "
        + "; ".join(f"{d} params {e['params']:.3g} ({e['params_beyond_tol']} of {e['params_total']} beyond "
                    f"the tolerance), loss {e['loss']:.3g}, grad_norm {e['grad_norm']:.3g}"
                    for d, e in step_errs.items()))

    # the JAX package's overfit gate (tests/test_integration.py:20-37) on the card
    cfg_o = NetConfig(max_components=16, min_component_area=4)
    rd_o = SyntheticMarkupReader(n_samples=16, image_hw=(128, 128), seed=1, n_objects=(1, 2))
    dc_o = DataConfig(batch_size=8, train_hw=(128, 128), augment=None, seed=0)
    tr_o = Trainer(cfg_o, dc_o, lr=2e-3, logdir=None, device="cuda")
    bo = Batches(rd_o, cfg_o, dc_o, train=True, device="cuda")
    t0 = time.perf_counter()
    for epoch in range(OVERFIT_EPOCHS):
        for batch in bo.epoch(epoch):
            tr_o.state, m_o = train_step(tr_o.state, batch, cfg_o)
    torch.cuda.synchronize()
    t_overfit = time.perf_counter() - t0
    # the JAX test also reads the last batch's pixel F1 (> 0.95 there); the
    # gate is the object-level one below, and the pixel F1 is reported
    ov_kernels = ["context_layer", "ccl", "slots", "rect_exact"]
    res_o, n_o = counted(
        lambda: ev_mod.run_evaluation({k: v.detach() for k, v in tr_o.state.params.items()}, rd_o, cfg_o,
                                      dc_o, device="cuda"),
        ov_kernels, [k for k in all_kernels if k not in ov_kernels])
    if not (res_o.f1 == 1.0 and res_o.class_accuracy == 1.0):
        raise AssertionError(f"overfit gate: object F1 {res_o.f1}, class accuracy {res_o.class_accuracy}")
    log(f"overfit gate: {OVERFIT_EPOCHS} epochs x 2 steps in {t_overfit:.1f} s, the last batch's pixel F1 "
        f"{float(m_o['pixel_f1']):.4f} (the JAX test reads > 0.95); run_evaluation on the card: object F1 {res_o.f1}, class accuracy "
        f"{res_o.class_accuracy}; launches {{{', '.join(f'{k}: {n_o[k]}' for k in ov_kernels)}}}")

    # resume: save, restore into a fresh Trainer, one more step from each
    (REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=REPO / "build"))
    try:
        prev_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            b_r = Batches(rd8, cfg_t, dc8, train=True, device="cuda")
            tr_a = Trainer(cfg_t, dc8, logdir=str(work / "resume"), device="cuda")
            tr_a.fit(b_r, 2)
            tr_b = Trainer(cfg_t, dc8, logdir=str(work / "resume"), device="cuda")
            if tr_b.maybe_resume() != tr_a.state.step:
                raise AssertionError("resume: the restored step differs")
            nb = next(iter(b_r.epoch(7)))
            sa, ma = train_step(tr_a.state, nb, cfg_t)
            sb, mb = train_step(tr_b.state, nb, cfg_t)
        finally:
            torch.backends.cudnn.deterministic = prev_det
        if not (all(torch.equal(sa.params[k], sb.params[k]) for k in sa.params)
                and float(ma["loss"]) == float(mb["loss"])):
            raise AssertionError("resume: one more step from the restored Trainer is not bit for bit equal")
        log(f"resume: step {sa.step} from the saved and the restored Trainer bit for bit equal "
            "(cudnn.deterministic)")

        # the CLIs from one log directory: train (its own process), evaluate, detect
        logdir = work / "cli"
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "ubdvss_tpu_torch.train", "--train-data", "synthetic", "--epochs", "1",
             "--batch-size", "8", "--synthetic-samples", "16", "--logdir", str(logdir),
             "--export-npz", str(logdir / "w.npz")],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        t_cli = time.perf_counter() - t0
        if cli.returncode != 0:
            raise AssertionError(f"train CLI failed ({cli.returncode}):\n{cli.stdout[-2000:]}{cli.stderr[-4000:]}")
        ev_cli, n_ev_cli = counted(lambda: ev_mod.main(
            ["--data", "synthetic", "--checkpoint", str(logdir), "--synthetic-samples", "16"]),
            ["context_layer", "ccl", "slots", "rect_exact"], ["rect_compact", *tiled, *bf16])
        np.save(work / "scene.npy", rd_s.sample_at(0).image)
        rep, n_det_cli = counted(lambda: detect_mod.main(
            ["--images", str(work / "scene.npy"), "--checkpoint", str(logdir / "w.npz")]),
            ["context_layer", "ccl", "slots", "rect_exact"], ["rect_compact", *tiled, *bf16])
        if not (0.0 <= ev_cli.f1 <= 1.0 and len(rep) == 1):
            raise AssertionError("the evaluate and detect CLIs on the trained log directory")
        log(f"CLIs: train 1 epoch (16 scenes, B=8) in its own process {t_cli:.1f} s; evaluate "
            f"--checkpoint <logdir> F1 {ev_cli.f1:.4f}; detect --checkpoint <logdir>/w.npz "
            f"{len(next(iter(rep.values())))} detections")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # throughput at bench.py:309-340's protocol: B=128 512², synthetic seed 7,
    # DataConfig(seed=0) with augmentation, lr 1e-3, the batch on the card
    rd_t = SyntheticMarkupReader(n_samples=TRAIN_BENCH_B, image_hw=(IMG, IMG), seed=SEED)
    dc_t = DataConfig(batch_size=TRAIN_BENCH_B, train_hw=(IMG, IMG), seed=0)
    b_t = next(iter(Batches(rd_t, cfg_t, dc_t, train=True, device="cuda").epoch(0)))
    train_timing = {}
    for dtype in ("float32", "bfloat16"):
        cfg_b = NetConfig(dtype=dtype)
        st = create_train_state(cfg_b, lr=1e-3, device="cuda")

        def one_step(st=st, cfg_b=cfg_b):
            train_step(st, b_t, cfg_b)

        ms_step = time_ms(one_step, iters=5, reps=2)
        busy = device_busy(lambda: [one_step() for _ in range(3)])
        with torch.no_grad(), compute_precision(cfg_b):
            lg = train_apply(st.params, b_t["images"], cfg_b)
        loss_prof = device_busy(lambda: total_loss(lg, b_t["segmap"], cfg_b))
        train_timing[dtype] = {
            "ms_per_step": ms_step, "img_per_s": TRAIN_BENCH_B / ms_step * 1e3,
            "device_ms_per_step": busy["device_busy_ms"] / 3, "busy_share": busy["busy_share"],
            "top_device_rows_ms_3_steps": busy["device_ms_by_kernel"],
            "loss_forward_device_ms": loss_prof["device_busy_ms"],
            "loss_forward_kernels": loss_prof["kernel_launches"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        }
    # the host-fed epoch (Trainer.fit's feed): Batches(train=True) then the step,
    # with the prefetch thread (depth 2, a stream of its own) and without it
    rd_e = SyntheticMarkupReader(n_samples=TRAIN_EPOCH_N, image_hw=(IMG, IMG), seed=SEED)
    rd_e.samples()  # render once: the reader keeps the scenes
    b_e = Batches(rd_e, cfg_t, dc_t, train=True, device="cuda")
    st_e = create_train_state(NetConfig(), lr=1e-3, device="cuda")
    for depth in (2, 0):
        walls = []
        for epoch in range(3):
            t0 = time.perf_counter()
            for batch in prefetched(b_e.epoch(epoch), depth=depth, device=dev):
                train_step(st_e, batch, NetConfig())
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        train_timing[f"epoch_prefetch_{depth}"] = {
            "walls_ms": walls, "img_per_s": TRAIN_EPOCH_N / statistics.median(walls) * 1e3}
    log(json.dumps({"training": {
        "card": smi, "f4_grad_max_abs_err": grad_err, "step_card_vs_host": step_errs,
        "overfit": {"epochs": OVERFIT_EPOCHS, "seconds": t_overfit, "pixel_f1": float(m_o["pixel_f1"]),
                    "object_f1": res_o.f1, "class_accuracy": res_o.class_accuracy,
                    "launches": {k: n_o[k] for k in ov_kernels}},
        "cli": {"train_s": t_cli, "evaluate_f1": ev_cli.f1,
                "evaluate_launches": {k: n_ev_cli[k] for k in ov_kernels},
                "detect_launches": {k: n_det_cli[k] for k in ov_kernels}},
        "bench": {"batch": TRAIN_BENCH_B, "image": IMG, "epoch_scenes": TRAIN_EPOCH_N, **train_timing}}}))

    # --- 7. device-fed training: scenes synthesized on the card, the corpus
    # held there, several steps a dispatch ---
    phase("device-fed training")
    import warnings

    from ubdvss_tpu_torch import synthgen
    from ubdvss_tpu_torch.data import DeviceCachedBatches, finalize_batch
    from ubdvss_tpu_torch.ops.augment import affine_draws, affine_from_draws
    from ubdvss_tpu_torch.ops.rasterize import polygons_to_grid, rasterize_polygons, rasterize_polygons_windowed
    from ubdvss_tpu_torch.utils.checkpoint import CheckpointManager

    sc_t = synthgen.SynthConfig(hw=(IMG, IMG), max_polys=dc_t.max_polys, max_verts=dc_t.max_verts,
                                class_names=tuple(cfg_t.class_names))
    wn_t = synthgen.synth_raster_window(sc_t, cfg_t)
    dc_w = DataConfig(batch_size=TRAIN_BENCH_B, train_hw=(IMG, IMG), seed=0, raster_window=wn_t)
    window_px = min(IMG, 128) ** 2

    # the render on the card against the host CPU on the same draws, made on
    # the host: the training path's (the augmentation's affine composed in)
    # and the plain one
    g_h = torch.Generator().manual_seed(SEED)
    draws_h = synthgen.scene_draws(g_h, sc_t, TRAIN_BENCH_B)
    aff_h = affine_from_draws(affine_draws(g_h, dc_t.augment, TRAIN_BENCH_B), dc_t.augment, sc_t.hw)
    draws_c = {k: v.to(dev) for k, v in draws_h.items()}
    render_cmp = {}
    for name_r, aff in (("affine", aff_h), ("plain", None)):
        t0 = time.perf_counter()
        host_r = synthgen.render_scenes(draws_h, sc_t, affine=aff, fill=dc_t.augment.fill_value)
        t_host_r = time.perf_counter() - t0
        card_r = synthgen.render_scenes(draws_c, sc_t, affine=None if aff is None else aff.to(dev),
                                        fill=dc_t.augment.fill_value)
        card_h = [t_.cpu() for t_ in card_r]
        if not (torch.equal(card_h[2], host_r[2]) and torch.equal(card_h[3], host_r[3])):
            raise AssertionError(f"render {name_r}: vertex counts or classes differ between the card and the host CPU")
        poly_err = float((card_h[1] - host_r[1]).abs().max())
        pix = (card_h[0] - host_r[0]).abs()
        flips = int((pix > 1e-3).sum())
        n_win = int((host_r[2] > 0).sum()) * window_px
        if not (poly_err <= 1e-4 and flips <= 1e-4 * n_win):
            raise AssertionError(f"render {name_r}: polygons {poly_err} apart, {flips} texel flips of {n_win}")
        seg_h = finalize_batch(*host_r, cfg_t, dc_w)["segmap"]
        seg_c = finalize_batch(*card_r, cfg_t, dc_w)["segmap"].cpu()
        same_grid = (polygons_to_grid(card_h[1], cfg_t.scale)
                     == polygons_to_grid(host_r[1], cfg_t.scale)).flatten(1).all(1)
        if not torch.equal(seg_c[same_grid], seg_h[same_grid]):
            raise AssertionError(f"render {name_r}: segmaps differ where the grid polygons agree")
        # the windowed rasterizer against the dense one on the card's polygons
        gp = polygons_to_grid(card_r[1], cfg_t.scale)
        ho = IMG // cfg_t.scale
        win = rasterize_polygons_windowed(gp, card_r[2], card_r[3], (ho, ho), wn_t)
        if not torch.equal(win, rasterize_polygons(gp, card_r[2], card_r[3], (ho, ho))):
            raise AssertionError(f"render {name_r}: the windowed rasterizer differs from the dense one on the card")
        render_cmp[name_r] = {
            "poly_max_abs_err": poly_err, "pixel_max_abs_err_outside_flips": float(pix[pix <= 1e-3].max()),
            "texel_flips": flips, "window_pixels": n_win, "objects": int((host_r[2] > 0).sum()),
            "segmap_images_compared": int(same_grid.sum()), "host_cpu_render_s": t_host_r,
            "windowed_raster_window": wn_t}
    log(f"render on the card == the host CPU, B={TRAIN_BENCH_B} {IMG}², same draws: "
        + "; ".join(f"{k} polygons {v['poly_max_abs_err']:.3g}, pixels {v['pixel_max_abs_err_outside_flips']:.3g}, "
                    f"{v['texel_flips']} texel flips of {v['window_pixels']}, segmaps of "
                    f"{v['segmap_images_compared']} images identical" for k, v in render_cmp.items())
        + f"; windowed rasterizer (window {wn_t}) == dense on the card, bit for bit")

    # the JAX package's transfer gate (tests/test_synthgen.py:236-267) on the card
    cfg_dn = NetConfig(max_components=8, separable_context=False)
    params_dn = {k: v.to(dev) for k, v in params_from_flat(
        load_params_npz(REPO / "assets" / "pretrained_dense_synthetic.npz")).items()}
    sc_g = synthgen.SynthConfig(hw=(256, 256), n_objects=(1, 3), max_polys=4)
    scenes_g = synthgen.render_scenes(
        synthgen.scene_draws(synthgen.step_generator(SEED, 0, 0, dev), sc_g, 16), sc_g)
    gate_kernels = ["ccl", "slots", "rect_exact"]
    (res_g, _), n_g = counted(
        lambda: detect_program_batch(params_dn, scenes_g[0], cfg_dn, (256, 256), fused=False, device="cuda"),
        gate_kernels, [k for k in all_kernels if k not in gate_kernels])
    per_image_g: list = []
    ev_mod._collect_batch(per_image_g, {k: v.cpu().numpy() for k, v in res_g.items()},
                          *(t_.cpu().numpy() for t_ in scenes_g[1:]))
    gate = ev_mod.evaluate_detections(per_image_g, class_names=cfg_dn.class_names)
    if not (gate.f1 >= 0.95 and gate.class_accuracy >= 0.75):
        raise AssertionError(f"transfer gate: F1 {gate.f1}, class accuracy {gate.class_accuracy}")
    log(f"transfer gate on the card: the dense asset on 16 port-generated 256² scenes, object F1 "
        f"{gate.f1:.4f} >= 0.95, class accuracy {gate.class_accuracy:.4f} >= 0.75; launches "
        f"{{{', '.join(f'{k}: {n_g[k]}' for k in gate_kernels)}}}")

    # fused == unfused on the card, and the cache == Batches on the same reader
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    fused_cmp = {}
    try:
        syn_t = synthgen.DeviceSyntheticBatches(cfg_t, dc_t, n_samples=TRAIN_EPOCH_N, seed=SEED, device=dev)
        cached_t = DeviceCachedBatches(rd_e, cfg_t, dc_t, device=dev)
        for name_f, batches_f, manual_src in (("synthesis", syn_t, syn_t), ("cache", cached_t, b_e)):
            st_m = create_train_state(cfg_t, lr=1e-3, seed=0, device=dev)
            for epoch in range(2):
                for batch in manual_src.epoch(epoch):
                    st_m, _ = train_step(st_m, batch, cfg_t)
            for spd in (1, 4):
                tr_f = Trainer(cfg_t, dc_t, steps_per_dispatch=spd, device=dev)
                tr_f.fit(batches_f, 2)
                err_f = max(float((tr_f.state.params[k] - v).detach().abs().max()) for k, v in st_m.params.items())
                if not (tr_f.state.step == st_m.step and err_f <= 2e-6):
                    raise AssertionError(f"fused {name_f}, {spd} steps a dispatch: {tr_f.state.step} steps, "
                                         f"parameters {err_f} from the unfused loop's")
                fused_cmp[f"{name_f}_spd{spd}_max_abs_err"] = err_f
    finally:
        torch.backends.cudnn.deterministic = prev_det
    log(f"fused == unfused on the card, B={TRAIN_BENCH_B} {IMG}², 2 epochs of {TRAIN_EPOCH_N} scenes "
        f"(cudnn.deterministic, atol 2e-6; the cache against Batches on the same reader): {fused_cmp}")

    # timing: the device-fed epoch (f32, bf16) and the cached one, beside the
    # bare step and the host-fed epoch of this run; the synthesis alone; the
    # busy share; the peak memory; the synchronizing calls in a 16-step chunk
    def fed_epoch(tr_, batches_, epoch):
        """One epoch as ``Trainer.fit`` runs it, without logging."""
        for run_, _ in tr_._epoch_steps(batches_, epoch):
            tr_.state, _ = run_(tr_.state)

    def fed_epoch_walls(tr_, batches_, n=5):
        walls_ = []
        for rep in range(n + 1):  # the first is a warm-up
            t0_ = time.perf_counter()
            fed_epoch(tr_, batches_, rep)
            torch.cuda.synchronize()
            walls_.append((time.perf_counter() - t0_) * 1e3)
        return walls_[1:]

    fed_timing = {}
    for dtype in ("float32", "bfloat16"):
        cfg_b = NetConfig(dtype=dtype)
        syn_b = synthgen.DeviceSyntheticBatches(cfg_b, dc_t, n_samples=TRAIN_EPOCH_N, seed=SEED, device=dev)
        tr_b = Trainer(cfg_b, dc_t, device=dev)
        torch.cuda.reset_peak_memory_stats()
        walls = fed_epoch_walls(tr_b, syn_b)
        busy_e = device_busy(lambda: fed_epoch(tr_b, syn_b, 0))
        fed_timing[f"synthetic_device_{dtype}"] = {
            "walls_ms": walls, "img_per_s": TRAIN_EPOCH_N / statistics.median(walls) * 1e3,
            "vs_step": (TRAIN_EPOCH_N / statistics.median(walls) * 1e3) / train_timing[dtype]["img_per_s"],
            "busy_share": busy_e["busy_share"], "device_busy_ms": busy_e["device_busy_ms"],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    tr_c = Trainer(NetConfig(), dc_t, device=dev)
    walls = fed_epoch_walls(tr_c, cached_t)
    busy_c = device_busy(lambda: fed_epoch(tr_c, cached_t, 0))
    fed_timing["cache_device_float32"] = {
        "walls_ms": walls, "img_per_s": TRAIN_EPOCH_N / statistics.median(walls) * 1e3,
        "vs_step": (TRAIN_EPOCH_N / statistics.median(walls) * 1e3) / train_timing["float32"]["img_per_s"],
        "busy_share": busy_c["busy_share"]}

    def one_synth():
        return synthgen.synth_batch_step(synthgen.step_generator(SEED, 0, 0, dev), sc_t, NetConfig(), dc_t, True)

    busy_s = device_busy(lambda: [one_synth() for _ in range(3)])
    fed_timing["synthesis_alone"] = {
        "ms_per_batch": time_ms(one_synth, iters=5, reps=2), "device_ms_per_batch": device_ms(one_synth, n=5),
        "top_device_rows_ms_3_batches": busy_s["device_ms_by_kernel"],
        "kernel_launches_per_batch": busy_s["kernel_launches"] / 3}
    # the synchronizing calls inside one 16-step chunk (after a warm-up chunk)
    syn16 = synthgen.DeviceSyntheticBatches(NetConfig(), dc_t, n_samples=16 * TRAIN_BENCH_B, seed=SEED, device=dev)
    tr16 = Trainer(NetConfig(), dc_t, steps_per_dispatch=16, device=dev)
    run16, k16 = next(tr16._epoch_steps(syn16, 0))
    if k16 != 16:
        raise AssertionError(f"a chunk of {k16} steps, expected 16")
    tr16.state, _ = run16(tr16.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr16.state, _ = run16(tr16.state)
    t_enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t_chunk = (time.perf_counter() - t0) * 1e3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr16.state, _ = run16(tr16.state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the mode's own notice is a warning too; a synchronizing call reads
    # "called a synchronizing CUDA operation"
    syncs = [f"{Path(w.filename).name}:{w.lineno}" for w in caught if "called a synchronizing" in str(w.message)]
    fed_timing["chunk_16"] = {"synchronizing_calls": len(syncs), "where": sorted(set(syncs)),
                              "host_ms_to_enqueue": t_enqueue, "wall_ms": t_chunk}
    fed_timing["beside"] = {
        "step_img_per_s": {d: train_timing[d]["img_per_s"] for d in ("float32", "bfloat16")},
        "host_fed_epoch_img_per_s": {k: train_timing[k]["img_per_s"]
                                     for k in ("epoch_prefetch_2", "epoch_prefetch_0")}}
    log(f"device-fed epoch, {TRAIN_EPOCH_N} scenes B={TRAIN_BENCH_B} {IMG}²: synthesis f32 "
        f"{fed_timing['synthetic_device_float32']['img_per_s']:.1f} img/s, bf16 "
        f"{fed_timing['synthetic_device_bfloat16']['img_per_s']:.1f}, cache f32 "
        f"{fed_timing['cache_device_float32']['img_per_s']:.1f}; step f32 "
        f"{train_timing['float32']['img_per_s']:.1f}, host-fed epoch "
        f"{train_timing['epoch_prefetch_2']['img_per_s']:.1f}; synthesis alone "
        f"{fed_timing['synthesis_alone']['device_ms_per_batch']:.3f} ms device a batch; "
        f"{len(syncs)} synchronizing calls in a 16-step chunk {sorted(set(syncs))}")

    # the two device-fed CLI forms, each in its own process, run together
    work2 = Path(tempfile.mkdtemp(dir=REPO / "build"))
    common = ["--epochs", "1", "--batch-size", "8", "--synthetic-samples", "16"]
    cli_cmds = {
        "synthetic_device": ["--train-data", "synthetic-device", "--val-data", "synthetic-device",
                             *common, "--steps-per-dispatch", "2"],
        "cache_device": ["--train-data", "synthetic", "--cache-device", *common],
    }
    procs = {}
    try:
        t0 = time.perf_counter()
        for name_c, args_c in cli_cmds.items():
            procs[name_c] = subprocess.Popen(
                [sys.executable, "-m", "ubdvss_tpu_torch.train", *args_c, "--logdir", str(work2 / name_c)],
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        cli_fed = {}
        for name_c, proc in procs.items():
            out_c, err_c = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"train CLI {name_c} failed ({proc.returncode}):\n{out_c[-2000:]}{err_c[-4000:]}")
            last = CheckpointManager(work2 / name_c / "checkpoints").latest_step()
            if last != 2:
                raise AssertionError(f"train CLI {name_c}: last checkpoint at step {last}, expected 2")
            cli_fed[name_c] = {"seconds": time.perf_counter() - t0, "last_step": last,
                               "val_logged": '"val"' in (work2 / name_c / "metrics.jsonl").read_text()}
        if not cli_fed["synthetic_device"]["val_logged"]:
            raise AssertionError("train CLI synthetic_device: no validation metrics logged")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work2, ignore_errors=True)
    log(f"device-fed CLIs, each in its own process: {cli_fed}")
    log(json.dumps({"device_fed_training": {
        "card": smi, "render_card_vs_host": render_cmp,
        "transfer_gate": {"f1": gate.f1, "class_accuracy": gate.class_accuracy,
                          "launches": {k: n_g[k] for k in gate_kernels}},
        "fused_vs_unfused": fused_cmp, "cli": cli_fed,
        "bench": {"batch": TRAIN_BENCH_B, "image": IMG, "epoch_scenes": TRAIN_EPOCH_N, **fed_timing}}}))
    # --- 8. the mesh: data-parallel serving, stream and evaluation over four
    # entries of the card, the row-tiled 2048² scan, the distributed CCL ---
    phase("mesh and tiled scans")
    from ubdvss_tpu_torch.evaluate import run_evaluation
    from ubdvss_tpu_torch.ops.ccl import compact_labels, connected_components, label_propagation
    from ubdvss_tpu_torch.ops.postproc import eq_from_raw_labels, finish_from_eq, roots_from_raw_labels
    from ubdvss_tpu_torch.parallel import make_mesh
    from ubdvss_tpu_torch.parallel import tiling
    from ubdvss_tpu_torch.train import setup_devices

    mesh4 = make_mesh(4, devices=[dev] * 4)
    mesh_report: dict = {"card": smi, "mesh": str(mesh4)}

    def same_results(a, b) -> bool:
        return all(torch.equal(a[k], b[k]) for k in a)

    # a. detect_program_batch(mesh=) on the main path's batch: bit for bit the
    # four per-shard calls, 4x a shard's launches, within the full call
    dp_modes = {
        "float32": (params_d, cfg, None, main_kernels, ["geometry_compat", "rect_exact", *tiled, *bf16]),
        "bfloat16": (params16_d, cfg16, None, main16, not16),
        "int8": (params_d, cfg, q_d, main8, not8),
    }
    full_calls = {"float32": (res_d, logits_d), "bfloat16": (res16_d, logits16_d), "int8": (res8_d, logits8_d)}
    mesh_report["dp"] = {}
    for mode, (p_m, c_m, q_m, must_m, not_m) in dp_modes.items():
        (res_m, lg_m), n_m = counted(
            lambda: detect_program_batch(p_m, imgs, c_m, (IMG, IMG), qparams=q_m, mesh=mesh4), must_m, not_m)
        shards_m, n_sh = [], []
        for i in range(4):
            out_i, n_i = counted(lambda i=i: detect_program_batch(
                p_m, imgs[i * B // 4:(i + 1) * B // 4], c_m, (IMG, IMG), qparams=q_m, device="cuda"), must_m, not_m)
            shards_m.append(out_i)
            n_sh.append(n_i)
        if any(n != n_sh[0] for n in n_sh) or any(n_m[k] != 4 * n_sh[0][k] for k in n_m):
            raise AssertionError(f"mesh {mode}: launches {n_m}, a shard's {n_sh[0]}: not 4x")
        if not (same_results(res_m, {k: torch.cat([s[0][k] for s in shards_m]) for k in res_m})
                and torch.equal(lg_m, torch.cat([s[1] for s in shards_m]))):
            raise AssertionError(f"mesh {mode}: results differ from the four per-shard calls")
        res_f, lg_f = full_calls[mode]
        err_full = float((lg_m - lg_f).abs().max())
        if not err_full <= 1e-5:
            raise AssertionError(f"mesh {mode}: logits {err_full} from the full-batch call's")
        left_out = compare_detections({k: v.cpu().numpy() for k, v in res_m.items()},
                                      {k: v.cpu().numpy() for k, v in res_f.items()},
                                      lg_f[..., 0].cpu().numpy(), box_atol=1e-5, score_atol=1e-5)
        mesh_report["dp"][mode] = {"launches": {k: n_m[k] for k in must_m},
                                   "launches_one_shard": {k: n_sh[0][k] for k in must_m},
                                   "logits_vs_full_max_abs_err": err_full,
                                   "full_call_images_and_class_ids_left_out": left_out}
        log(f"mesh {mode}: B={B} {IMG}² over {mesh4.size} entries of {dev}: == the four per-shard calls bit "
            f"for bit, launches {mesh_report['dp'][mode]['launches']} = 4x a shard's; against the full-batch "
            f"call logits max|err| {err_full:.3g} <= 1e-5, detections equal ({left_out[0]} images, "
            f"{left_out[1]} near-tie class ids left out)")
    mesh_auto = setup_devices("auto")
    res_auto, lg_auto = detect_program_batch(params_d, imgs, cfg, (IMG, IMG), mesh=mesh_auto)
    if not (mesh_auto.size == torch.cuda.device_count() and same_results(res_auto, res_d)
            and torch.equal(lg_auto, logits_d)):
        raise AssertionError("setup_devices('auto'): results differ from the single call")
    log(f"setup_devices('auto'): {mesh_auto}; == the single call bit for bit")

    # b. the QVGA stream over the mesh == the stream at the shards' batch
    # size; run_evaluation over the mesh with a remainder batch == without
    shard_b = B // mesh4.size
    (got_m, n_sm) = counted(
        lambda: list(StreamingDetector(cfg_q, params, QVGA, batch_size=B, mesh=mesh4).process(iter(frames))),
        ["context_layer", "ccl", "slots", "rect_exact"], ["rect_compact", "geometry_compat", *tiled, *bf16])
    got_1 = list(StreamingDetector(cfg_q, params, QVGA, batch_size=shard_b, device="cuda").process(iter(frames)))
    if [i for i, _ in got_m] != list(range(N_FRAMES)) or not all(
            all(np.array_equal(x[k], y[k]) for k in x) for (_, x), (_, y) in zip(got_m, got_1)):
        raise AssertionError("mesh stream: detections differ from the stream at the shards' batch size")
    n_ev = EVAL_N - EVAL_BATCH // 2  # a remainder batch of half a batch
    reader_m = SyntheticMarkupReader(n_samples=n_ev, image_hw=EVAL_HW, seed=0)
    dc_m = DataConfig(batch_size=EVAL_BATCH, train_hw=EVAL_HW, max_polys=32)
    cfg_ev = load_net_config(asset)
    ev_1 = run_evaluation(params_d, reader_m, cfg_ev, dc_m)
    ev_m, n_em = counted(lambda: run_evaluation(params_d, reader_m, cfg_ev, dc_m, mesh=mesh4),
                         ["context_layer", "ccl", "slots", "rect_exact"], ["rect_compact", *tiled, *bf16])
    if ev_m != ev_1:
        raise AssertionError(f"mesh evaluation: {ev_m} differs from {ev_1}")
    mesh_report["stream"] = {"frames": N_FRAMES, "launches": n_sm}
    mesh_report["evaluation"] = {"images": n_ev, "batch": EVAL_BATCH, "f1": ev_m.f1, "launches": n_em}
    log(f"mesh stream: {N_FRAMES} QVGA frames, batch {B} over {mesh4.size} entries == batch {shard_b} "
        f"without a mesh; mesh evaluation: {n_ev} {EVAL_HW[0]}² scenes at batch {EVAL_BATCH} (a remainder "
        f"of {n_ev % EVAL_BATCH}) F1 {ev_m.f1:.4f} == without a mesh")

    # c. the row-tiled 2048² scan (BASELINE config 4) on 4 entries (T = 512
    # rows, the 140-pixel halo in one hop) and 16 (T = 128 < halo: two hops)
    scan0 = scans[0]
    ref_t, ref_lt = detect_program(params_d, scan0, cfg, (SCAN, SCAN), device="cuda")
    mesh_report["tiled"] = {}
    for n_t in (4, 16):
        mesh_t = make_mesh(n_t, axis="spatial", devices=[dev] * n_t)
        out_t = tiling.tiled_detect(params_d, scan0, cfg, mesh_t)
        err_t = float((out_t["logits"] - ref_lt).abs().max())
        boxes_ok = same_corner_sets(out_t["boxes"].cpu().numpy(), ref_t["boxes"].cpu().numpy(), 1e-3)
        v_t = ref_t["valid"].cpu().numpy()
        if not (bool(out_t["ccl_converged"]) and err_t <= 1e-4 and torch.equal(out_t["valid"], ref_t["valid"])
                and boxes_ok[v_t].all()):
            raise AssertionError(f"tiled_detect on {n_t} entries: converged {bool(out_t['ccl_converged'])}, "
                                 f"logits max|err| {err_t}, valid or boxes differ from detect_program")
        if int(ref_t["num_detections"]) == 0:
            raise AssertionError("tiled 2048² scan: no detection to compare")
        T_t, halo_t, hops_t = tiling._halo_plan(SCAN, n_t, cfg, None)
        mesh_report["tiled"][n_t] = {"rows_a_tile": T_t, "halo": halo_t, "hops": hops_t,
                                     "logits_max_abs_err": err_t, "detections": int(ref_t["num_detections"])}
        log(f"tiled_detect {SCAN}² on {n_t} entries (T={T_t}, halo {halo_t}, {hops_t} hop(s)): converged, "
            f"logits max|err| {err_t:.3g} <= 1e-4, valid identical, {int(ref_t['num_detections'])} boxes "
            "within 1e-3 of detect_program's")

    def tiled_split(n_t):
        """tiled_detect's three stages on n_t entries, CUDA events between
        them: the halo + trunk, the seam rounds (and their count), the tail."""
        mesh_t = make_mesh(n_t, axis="spatial", devices=[dev] * n_t)
        devs_t = mesh_t.axis_devices("spatial")
        Ho, Wo = SCAN // cfg.scale, SCAN // cfg.scale
        To, sentinel = Ho // n_t, Ho * Wo
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with torch.inference_mode():
            ev[0].record()
            tl = tiling._tile_logits(params_d, torch.from_numpy(scan0), cfg, devs_t, None)
            ev[1].record()
            masks = [torch.sigmoid(lg[..., 0]) > cfg.detection_threshold for lg in tl]
            labs, conv, rounds = tiling._seam_merge_ccl(
                tiling._tile_labels(masks, To, Wo, sentinel), masks, n_t, sentinel, 8, To, Wo)
            ev[2].record()
            lab_full = torch.cat(labs)
            rv, ok = roots_from_raw_labels(lab_full, cfg.max_components)
            idx = torch.arange(Ho * Wo, dtype=torch.int32, device=dev).reshape(Ho, Wo)
            total = ((lab_full == idx) & (lab_full < sentinel)).sum().to(torch.int32)
            finish_from_eq(torch.cat(tl), eq_from_raw_labels(lab_full, rv, ok), cfg, total)
            ev[3].record()
        ev[3].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)], rounds, conv

    for n_t in (4, 16):
        tiled_split(n_t)  # warm-up
        splits = [tiled_split(n_t) for _ in range(3)]
        ms_t = time_ms(lambda n_t=n_t: tiling.tiled_detect(
            params_d, scan0, cfg, make_mesh(n_t, axis="spatial", devices=[dev] * n_t)), iters=3, reps=1, warmup=1)
        med = [statistics.median(s[0][i] for s in splits) for i in range(3)]
        mesh_report["tiled"][n_t].update(ms=ms_t, trunk_ms=med[0], seam_ms=med[1], tail_ms=med[2],
                                         seam_rounds=splits[0][1])
        log(f"tiled_detect {SCAN}² on {n_t} entries: {ms_t:.2f} ms (trunk {med[0]:.2f}, {splits[0][1]} seam "
            f"rounds {med[1]:.2f}, tail {med[2]:.2f})")
    ms_whole = time_ms(lambda: detect_program(params_d, scan0, cfg, (SCAN, SCAN), device="cuda"),
                       iters=3, reps=1, warmup=1)
    mesh_report["tiled"]["detect_program_whole_ms"] = ms_whole

    # d. the distributed CCL == connected_components on the adversarial maps
    # and a snake crossing every seam, on 2, 4 and 8 entries; and
    # connected_components == K1's raw labels compacted, on the card
    adv_m = torch.from_numpy(adversarial_maps()).to(dev) > 0
    seam_snake = torch.zeros((128, 128), dtype=torch.bool, device=dev)
    for c in range(0, 128, 16):  # 8 columns: within the seam loop's cap on 8 entries
        seam_snake[:, c] = True
        seam_snake[0 if (c // 16) % 2 else 127, c:c + 17] = True
    ccl_maps = list(adv_m) + [seam_snake]
    capped = []
    for conn in (8, 4):
        for j, m_j in enumerate(ccl_maps):
            lab_j, _ = connected_components(m_j, conn)
            for n_c in (2, 4, 8):
                got_j, conv_j = tiling.distributed_connected_components(
                    m_j, make_mesh(n_c, axis="spatial", devices=[dev] * n_c), connectivity=conn)
                if not torch.equal(got_j, lab_j):
                    raise AssertionError(f"distributed CCL map {j} on {n_c} entries ({conn}-conn): labels differ")
                if not bool(conv_j):
                    capped.append((j, n_c, conn))
    # the adversarial snake (32 columns) on 8 entries needs more seam rounds
    # than the JAX formulation's cap, whose flag then reads False with the
    # labels complete (tests/test_torch_parallel.py holds this against JAX)
    if any((j, n_c) != (0, 8) for j, n_c, _ in capped):
        raise AssertionError(f"distributed CCL: unconverged {capped}")
    det_main = logits_d[..., 0].contiguous()
    mask_main = det_main > ccl_kernel.threshold_logit(cfg.detection_threshold)
    for conn in (8, 4):
        raw_k = ccl_kernel.ccl_labels_from_logits(det_main, connectivity=conn)
        for b in range(B):
            lab_b, n_b = connected_components(mask_main[b], conn)
            want_b, n_want = compact_labels(raw_k[b], raw_k[b] < raw_k[b].numel(), raw_k[b].numel())
            if not (torch.equal(lab_b, want_b) and int(n_b) == int(n_want)):
                raise AssertionError(f"connected_components map {b} ({conn}-conn): differs from K1's labels")
    t_k1 = time_ms(lambda: ccl_kernel.ccl_labels_from_logits(det_main))
    t_lp = time_ms(lambda: label_propagation(mask_main), iters=3, reps=1)
    t_cc = time_ms(lambda: [connected_components(mask_main[b]) for b in range(B)], iters=3, reps=1)
    mesh_report["ccl"] = {"maps": len(ccl_maps), "entries": [2, 4, 8], "unconverged_at_the_cap": capped,
                          "k1_ms": t_k1, "label_propagation_batch_ms": t_lp, "connected_components_64_ms": t_cc}
    log(f"distributed CCL: {len(ccl_maps)} maps x 2, 4, 8 entries x 4/8-conn == connected_components "
        f"(the seam loop's cap reached, flag False, on {capped}); connected_components == K1's labels "
        f"compacted on the main path's {B} maps; K1 {t_k1:.4f} ms, label_propagation on the batch "
        f"{t_lp:.2f} ms, connected_components one map at a time {t_cc:.2f} ms")

    # e. times: the 4-entry DP batch against the single call (images on the card)
    ms_single = time_ms(lambda: detect_program_batch(params_d, imgs_d, cfg, (IMG, IMG), detections_only=True))
    ms_dp = time_ms(lambda: detect_program_batch(params_d, imgs_d, cfg, (IMG, IMG), detections_only=True,
                                                 mesh=mesh4))
    mesh_report["dp"]["float32"].update(ms=ms_dp, single_call_ms=ms_single)
    log(f"mesh f32 B={B} {IMG}²: {ms_dp:.3f} ms over {mesh4.size} entries of one card against "
        f"{ms_single:.3f} ms for one call")
    log(json.dumps({"mesh_and_tiled_scans": mesh_report}))

    # --- 9. training over a mesh: the three pipelines over four entries of
    # the card, the evaluation of what they trained, NCCL at world size 1 ---
    phase("mesh training")
    log(json.dumps({"mesh_training": mesh_training(dev, smi, counted, ["rect_compact", *tiled, *bf16])}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
